"""Latent selection tool (counterpart of maua_tpu/pipeline/select_latents.py).

Two forms of the reference's click-to-sort gallery, without a display:

  batch:  render numbered contact sheets and split the latents by index lists
          (interactive prompt or --pick) into named sets, saved as .npy plus
          a contact sheet each;
  serve:  `--serve` starts a localhost web gallery: left-click = intro,
          right-click = drop, "new batch" draws more, "save" writes the sets.

    python -m maua_tpu_torch.pipeline.select_latents --ckpt g.pt --n 24 --out sel [--device cpu]
    python -m maua_tpu_torch.pipeline.select_latents --ckpt g.pt --pick intro=0,3,7 --pick drop=1,2
    python -m maua_tpu_torch.pipeline.select_latents --ckpt g.pt --serve --port 8765

The sampler maps fresh z [n, D] from `draws` (default `Draws(seed)`) on each
call and truncates toward a mean latent of 2^14 z from `mean_draws` (default
`Draws(seed + 1)`); the synthesis runs in batches, the last one padded by
repeating its last latent.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..draws import Draws
from ..io.torch_ckpt import load_generator

__all__ = ["LatentPicker", "generate_and_select", "main", "make_checkpoint_sampler", "make_picker_server",
           "render_contact_sheet", "serve_picker"]


def render_contact_sheet(images: np.ndarray, path: str, n_cols: int = 8, label: bool = True) -> None:
    """[-1, 1] NCHW -> numbered contact sheet."""
    from PIL import Image, ImageDraw

    imgs = ((np.clip(images, -1, 1) + 1) * 127.5).astype(np.uint8).transpose(0, 2, 3, 1)
    n, h, w, _ = imgs.shape
    n_rows = -(-n // n_cols)
    sheet = np.zeros((n_rows * h, n_cols * w, 3), np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, n_cols)
        sheet[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    im = Image.fromarray(sheet)
    if label:
        draw = ImageDraw.Draw(im)
        for i in range(n):
            r, c = divmod(i, n_cols)
            draw.text((c * w + 4, r * h + 2), str(i), fill=(255, 64, 64))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    im.save(path)


def make_checkpoint_sampler(ckpt: str, truncation: float = 0.75, seed: int = 0, batch: int = 8,
                            device: DeviceLike = None, draws=None, mean_draws=None):
    """Returns `sample(n) -> (wplus [n, L, D], images [-1, 1] NCHW)`, numpy,
    backed by a checkpoint generator on `device` (default `cuda`);
    successive calls draw fresh latents."""
    device = resolve_device(device)
    gen = load_generator(ckpt, device=device)
    draws = Draws(seed, device) if draws is None else draws
    mean_draws = Draws(seed + 1, device) if mean_draws is None else mean_draws
    with torch.inference_mode():
        mean_w = gen.get_latent(mean_draws.normal(2**14, gen.style_dim).to(device)).mean(dim=0, keepdim=True)

    def sample(n: int):
        with torch.inference_mode():
            wplus = gen.map_latents(draws.normal(n, gen.style_dim).to(device))
            imgs = []
            for i in range(0, n, batch):
                chunk = wplus[i : i + batch]
                pad = batch - chunk.shape[0]
                if pad:
                    chunk = torch.cat([chunk, chunk[-1:].repeat(pad, 1, 1)])
                out, _ = gen(chunk, input_is_latent=True, truncation=truncation, truncation_latent=mean_w,
                             randomize_noise=False)
                imgs.append(out[: batch - pad].cpu().numpy())
        return wplus.cpu().numpy(), np.concatenate(imgs)[:n]

    return sample


def generate_and_select(
    ckpt: str,
    n: int = 24,
    out_dir: str = "workspace/selection",
    picks: dict[str, list[int]] | None = None,
    truncation: float = 0.75,
    seed: int = 0,
    batch: int = 8,
    interactive: bool = False,
    device: DeviceLike = None,
    draws=None,
    mean_draws=None,
) -> dict[str, str]:
    """Generate n mapped latents and their images; save the sheet and the
    latents; split them into the picked sets."""
    wplus, images = make_checkpoint_sampler(ckpt, truncation, seed, batch, device, draws, mean_draws)(n)

    os.makedirs(out_dir, exist_ok=True)
    sheet_path = os.path.join(out_dir, "sheet.jpg")
    render_contact_sheet(images, sheet_path)
    np.save(os.path.join(out_dir, "all_latents.npy"), wplus)
    print(f"contact sheet: {sheet_path}")

    if interactive and picks is None:
        picks = {}
        print("enter comma-separated indices per set (empty to finish), e.g. 'intro=0,3,7'")
        while True:
            line = input("> ").strip()
            if not line:
                break
            name, _, idx = line.partition("=")
            picks[name.strip()] = [int(i) for i in idx.split(",") if i.strip()]

    outputs = {"all": os.path.join(out_dir, "all_latents.npy")}
    for name, indices in (picks or {}).items():
        p = os.path.join(out_dir, f"{name}_latents.npy")
        np.save(p, wplus[np.asarray(indices)])
        render_contact_sheet(images[np.asarray(indices)], os.path.join(out_dir, f"{name}_sheet.jpg"))
        outputs[name] = p
        print(f"saved {len(indices)} latents -> {p}")
    return outputs


_PICKER_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>latent picker</title><style>
body{background:#111;color:#ddd;font-family:sans-serif;margin:1em}
#grid{display:flex;flex-wrap:wrap;gap:8px}
.cell{position:relative;cursor:pointer;border:4px solid transparent}
.cell.intro{border-color:#4c4}.cell.drop{border-color:#c44}
.cell img{display:block;max-width:256px}
.tag{position:absolute;top:2px;left:4px;font-weight:bold;text-shadow:0 0 3px #000}
button{margin-right:8px;padding:6px 14px}</style></head><body>
<p>left-click = intro &middot; right-click = drop &middot; click again to clear</p>
<div><button onclick="newBatch()">new batch</button>
<button onclick="save()">save sets</button><span id="st"></span></div>
<div id="grid"></div><script>
let items=[];
async function refresh(){
  const s=await (await fetch('state')).json();
  items=s.items;
  const g=document.getElementById('grid');g.innerHTML='';
  for(const it of items){
    const d=document.createElement('div');
    d.className='cell'+(it.set?' '+it.set:'');
    d.innerHTML=`<span class="tag">${it.index}${it.set?' '+it.set:''}</span>`+
      `<img src="img/${it.index}.jpg">`;
    d.onclick=()=>select(it.index, it.set==='intro'?null:'intro');
    d.oncontextmenu=(e)=>{e.preventDefault();select(it.index, it.set==='drop'?null:'drop');};
    g.appendChild(d);
  }
  document.getElementById('st').textContent=
    ` intro: ${s.counts.intro||0}  drop: ${s.counts.drop||0}`;
}
async function select(i,set){
  await fetch('select',{method:'POST',body:JSON.stringify({index:i,set:set})});
  refresh();
}
async function newBatch(){await fetch('batch',{method:'POST'});refresh();}
async function save(){
  const r=await (await fetch('save',{method:'POST'})).json();
  alert('saved: '+JSON.stringify(r));
}
refresh();</script></body></html>"""


class LatentPicker:
    """Server-side state of the web picker: every latent and image sampled
    since it started, plus each index's set assignment. Thread-safe (the
    HTTP server is threading)."""

    def __init__(self, sample_fn, out_dir: str, n_per_batch: int = 8):
        self.sample = sample_fn
        self.out_dir = out_dir
        self.n_per_batch = n_per_batch
        self.lock = threading.Lock()
        self.wplus: np.ndarray | None = None  # [N, L, D], grows per batch
        self.images: np.ndarray | None = None  # [N, C, H, W] in [-1,1]
        self.sets: dict[int, str] = {}

    def new_batch(self) -> list[int]:
        w, img = self.sample(self.n_per_batch)
        with self.lock:
            if self.wplus is None:
                self.wplus, self.images = w, img
            else:
                self.wplus = np.concatenate([self.wplus, w])
                self.images = np.concatenate([self.images, img])
            n = self.wplus.shape[0]
            return list(range(n - self.n_per_batch, n))

    def state(self) -> dict:
        with self.lock:
            n = 0 if self.wplus is None else self.wplus.shape[0]
            items = [
                {"index": i, "set": self.sets.get(i)} for i in range(n)
            ]
            counts: dict[str, int] = {}
            for s in self.sets.values():
                counts[s] = counts.get(s, 0) + 1
            return {"items": items, "counts": counts}

    def select(self, index: int, set_name: str | None) -> None:
        with self.lock:
            n = 0 if self.wplus is None else self.wplus.shape[0]
            if not (0 <= index < n):
                raise IndexError(index)
            if set_name is None:
                self.sets.pop(index, None)
            else:
                self.sets[index] = str(set_name)

    def image_jpeg(self, index: int) -> bytes:
        from PIL import Image

        with self.lock:
            img = self.images[index]
        arr = ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8).transpose(1, 2, 0)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=92)
        return buf.getvalue()

    def save(self) -> dict[str, str]:
        with self.lock:
            os.makedirs(self.out_dir, exist_ok=True)
            outputs: dict[str, str] = {}
            names = sorted(set(self.sets.values()))
            for name in names:
                idx = np.asarray(sorted(i for i, s in self.sets.items() if s == name))
                p = os.path.join(self.out_dir, f"{name}_latents.npy")
                np.save(p, self.wplus[idx])
                render_contact_sheet(
                    self.images[idx], os.path.join(self.out_dir, f"{name}_sheet.jpg")
                )
                outputs[name] = p
            if self.wplus is not None:
                p = os.path.join(self.out_dir, "all_latents.npy")
                np.save(p, self.wplus)
                outputs["all"] = p
            return outputs


def make_picker_server(picker: LatentPicker, port: int = 0) -> ThreadingHTTPServer:
    """Bind the picker to a localhost HTTP server (port 0 = ephemeral).
    Caller runs `serve_forever()` (or a thread) and `shutdown()`."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            try:
                if self.path in ("/", "/index.html"):
                    self._send(200, _PICKER_HTML.encode(), "text/html")
                elif self.path == "/state":
                    self._json(picker.state())
                elif self.path.startswith("/img/"):
                    idx = int(self.path[len("/img/"):].split(".")[0])
                    self._send(200, picker.image_jpeg(idx), "image/jpeg")
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001 — surface as HTTP error
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            try:
                ln = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(ln) or b"{}") if ln else {}
                if self.path == "/batch":
                    self._json({"indices": picker.new_batch()})
                elif self.path == "/select":
                    picker.select(int(payload["index"]), payload.get("set"))
                    self._json({"ok": True})
                elif self.path == "/save":
                    self._json(picker.save())
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, 500)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_picker(ckpt: str, out_dir: str, n_per_batch: int = 8, truncation: float = 0.75, seed: int = 0,
                 port: int = 8765, device: DeviceLike = None) -> None:
    sampler = make_checkpoint_sampler(ckpt, truncation, seed, batch=n_per_batch, device=device)
    picker = LatentPicker(sampler, out_dir, n_per_batch)
    picker.new_batch()  # the first gallery is ready before the browser connects
    srv = make_picker_server(picker, port)
    print(f"latent picker at http://127.0.0.1:{srv.server_address[1]}/ "
          f"(left-click intro, right-click drop; ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="generate + select latents")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--out", type=str, default="workspace/selection")
    p.add_argument("--truncation", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pick", action="append", default=[], help="name=i,j,k (repeatable)")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--serve", action="store_true", help="web gallery: left-click intro / right-click drop / save")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--batch", type=int, default=8, help="images per gallery batch (serve mode)")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.serve:
        serve_picker(args.ckpt, args.out, args.batch, args.truncation, args.seed, args.port, args.device)
        return 0
    picks = {}
    for spec in args.pick:
        name, _, idx = spec.partition("=")
        picks[name] = [int(i) for i in idx.split(",") if i.strip()]
    generate_and_select(args.ckpt, args.n, args.out, picks or None, args.truncation, args.seed,
                        interactive=args.interactive, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
