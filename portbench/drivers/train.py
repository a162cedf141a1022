"""Training cells: the body of the train CLI's loop (`train/cli.py::_train`:
`next(loader)` -> `draw_step` -> the step of `make_train_step`), driven
step by step.

Set-up resolves the TrainConfig through the CLI's own parser and automatic
rules (`--print_config`) and requires what the configuration states; makes
`records` seeded images on the device and writes them as raw record shards
under TMPDIR; builds the state with `init_train_state` and loads the
benchmark's weights into G, D and the EMA copy (the lookahead cache restarts
from them, as the CLI's `--checkpoint` does); then runs steps 0-4 through the
loop body (R1 + path, three plain, path only), which warms up every shape.
Steps 0-2 are the compared steps: their batches, draws and reported losses,
each optimizer's first gradient (read back from Adam's state after its first
step) and the weights after step 2 are kept.

The window continues from step 5 and times whole cycles of 16 steps (the
least common multiple of the R1 and path intervals) until `--seconds` have
passed. Any 16 consecutive steps hold one R1 + path step, three path-only
steps and twelve plain ones, so every run times the same mix of steps;
`train_img_s` is the images of those steps over the window's time. In the
traced run CUDA events at the steps' ends time each step on the device's
clock, with no synchronize that the untraced run lacks.

Once the window has closed and the program is freed, the reference follows
steps 0-2 from the same weights, batches and draws.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import bytes as work_bytes
from .. import flops, weights
from ..common import Cell, Spans
from ..reference import stylegan2 as ref
from ..reference import train as ref_train

WARM = 5  # steps 0-4: R1 + path, plain, plain, plain, path
HYPER = ("lr", "r1", "path_regularize", "d_reg_every", "g_reg_every", "mixing_prob", "ada_target", "ada_length",
         "la_steps", "la_alpha", "augment_p", "path_batch_shrink")
@dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    cfg: Any  # the resolved TrainConfig
    gw: dict
    dw: dict
    data: np.ndarray  # [N, H, W, 3] uint8, the records
    data_dir: str
    program: Optional[dict]  # state, step_fn, loader, draw_gen
    recorded: dict = field(default_factory=dict)
    steps: list = field(default_factory=list)  # the window's step numbers
    spans: Spans = field(default_factory=Spans)
    setup_peak: int = 0
    window_peak: int = 0


def _seeds(seed: int) -> dict[str, int]:
    base = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    return dict(zip(("g", "d", "data", "program"), (int(x) % (2**31) for x in base)))


def argv(cell: Cell, device: str, path: str, seed: int) -> list[str]:
    cfg, tr = cell.config, cell.traffic
    return ["--path", path, "--size", str(cfg["size"]), "--batch_size", str(tr["batch"]),
            "--channel_multiplier", str(cfg["channel_multiplier"]), "--channel_max", str(cfg["channel_max"]),
            "--device", device, "--seed", str(seed), "--num_workers", str(tr["num_workers"]), *tr["extra_args"]]


def resolve(cell: Cell, device: str, path: str, seed: int):
    """The TrainConfig that the train CLI resolves, checked against the
    configuration and the traffic's expectations."""
    from maua_tpu_torch.train import TrainConfig
    from maua_tpu_torch.train.cli import build_parser, train_loop

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_loop(build_parser().parse_args(argv(cell, device, path, seed) + ["--print_config"]))
    cfg = TrainConfig(**json.loads(buf.getvalue().strip().splitlines()[-1]))
    conf = cell.config
    want = {k: conf["train"][k] for k in HYPER}
    want["r1"] = conf["train"]["r1"] * conf["size"] ** 2
    want.update(size=conf["size"], latent_dim=conf["style_dim"], channel_multiplier=conf["channel_multiplier"],
                channel_max=conf["channel_max"], constant_input=True, bf16=conf["precision"] != "exact",
                batch_size=cell.traffic["batch"], num_accumulate=1)
    if device != "cpu":
        want.update(cell.traffic["expect"])
    got = {k: getattr(cfg, k) for k in want}
    bad = {k: (got[k], v) for k, v in want.items() if not (got[k] == v or (isinstance(v, float) and math.isclose(got[k], v)))}
    if bad:
        raise ValueError(f"the train CLI resolves a configuration other than the cell's: {bad}")
    return cfg


def make_images(n: int, size: int, seed: int, device) -> np.ndarray:
    """n [size, size, 3] uint8 images: smooth seeded colour fields plus grain."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = np.empty((n, size, size, 3), np.uint8)
    for at in range(0, n, 16):
        k = min(16, n - at)
        low = torch.randn((k, 3, 8, 8), generator=gen, device=device)
        img = F.interpolate(low, size=(size, size), mode="bicubic", align_corners=False) * 0.6
        img = img + 0.08 * torch.randn((k, 3, size, size), generator=gen, device=device)
        img = ((img.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8)
        out[at: at + k] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out


def write_records(images: np.ndarray, folder: str) -> None:
    from maua_tpu_torch.data.records import RecordShardWriter

    size = images.shape[1]
    writer = RecordShardWriter(os.path.join(folder, f"portbench-{size}-00000.mrec"), fmt="raw", side=size)
    for img in images:
        writer.append(img)
    writer.close()


def plain(x):
    """A draw of the program as nested dicts of cloned tensors."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if hasattr(x, "_asdict"):
        return {k: plain(v) for k, v in x._asdict().items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: plain(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def _first_grad_hook(store: dict, name: str, module: torch.nn.Module):
    names = {id(p): k for k, p in module.named_parameters()}

    def hook(opt, args, kwargs):
        if name in store:
            return
        b1 = opt.param_groups[0]["betas"][0]
        store[name] = {names[id(p)]: opt.state[p]["exp_avg"].detach().clone() / (1.0 - b1)
                       for group in opt.param_groups for p in group["params"] if id(p) in names}

    return hook


def setup(cell: Cell, seed: int, device: str = "cuda") -> State:
    from maua_tpu_torch.data import DataLoader, MultiResolutionRecordDataset
    from maua_tpu_torch.train import draw_step, init_train_state, make_train_step
    from maua_tpu_torch.train.lookahead import lookahead_minimax_init

    conf, tr = cell.config, cell.traffic
    dev = torch.device(device)
    s = _seeds(seed)
    data_dir = tempfile.mkdtemp(prefix="portbench-records-")
    cfg = resolve(cell, device, data_dir, s["program"])
    gw = weights.generator_weights(conf, s["g"], dev)
    dw = weights.discriminator_weights(conf, s["d"], dev)
    data = make_images(tr["records"], conf["size"], s["data"], dev)
    write_records(data, data_dir)

    ts = init_train_state(cfg, s["program"], dev)
    weights.load(ts.g, gw)
    weights.load(ts.d, dw)
    weights.load(ts.g_ema, gw)
    if ts.lookahead is not None:
        ts.lookahead = lookahead_minimax_init(ts.g.parameters(), ts.d.parameters())
    loader = DataLoader(MultiResolutionRecordDataset(data_dir, resolution=conf["size"], uint8_hwc=True),
                        batch_size=cfg.batch_size, num_accumulate=cfg.num_accumulate,
                        num_workers=tr["num_workers"], seed=s["program"], device=dev)
    program = {"state": ts, "step_fn": make_train_step(cfg), "loader": loader,
               "draw_gen": torch.Generator(device=dev).manual_seed(s["program"] + 2), "draw_step": draw_step}
    state = State(cell, seed, dev, cfg, gw, dw, data, data_dir, program)

    firsts: dict = {}
    hooks = [ts.d_optim.register_step_post_hook(_first_grad_hook(firsts, "d", ts.d)),
             ts.g_optim.register_step_post_hook(_first_grad_hook(firsts, "g", ts.g))]
    reals, draws, losses = [], [], []
    for step in range(WARM):
        real, drawn, metrics = _step(state)
        if step < tr["compared_steps"]:
            reals.append(real.detach().cpu())
            draws.append(plain({"d": drawn.d, "g": drawn.g, "path": drawn.path}))
            losses.append({k: float(metrics[k]) for k in
                           ("Discriminator", "Generator", "R1 Penalty", "Path Length Regularization")})
        if step == tr["compared_steps"] - 1:
            for h in hooks:
                h.remove()
            state.recorded = {"reals": reals, "draws": draws, "losses": losses, "first_grads": firsts,
                              **{name: {k: v.detach().clone() for k, v in getattr(ts, name).named_parameters()}
                                 for name in ("g", "d", "g_ema")}}
    _sync(dev)
    return state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step(state: State):
    p = state.program
    real = next(p["loader"])
    drawn = p["draw_step"](state.cfg, p["state"].step, p["draw_gen"], state.device)
    return real, drawn, p["step_fn"](p["state"], real, drawn)


def kind(cfg, step: int) -> str:
    reg = step % cfg.d_reg_every == 0 or step % cfg.g_reg_every == 0
    return "reg" if reg else "plain"


def _event(dev: torch.device, timed: bool) -> Optional[torch.cuda.Event]:
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=timed)
    ev.record()
    return ev


def window(state: State, seconds: float, traced: bool = False) -> dict:
    """Whole cycles of steps from step 5 until `seconds` have passed."""
    p, dev, spans, cfg = state.program, state.device, state.spans, state.cfg
    cycle = math.lcm(cfg.d_reg_every, cfg.g_reg_every)
    cuda = dev.type == "cuda"
    if cuda:
        state.setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kinds, ends = [], []
    with spans("window"):
        t0 = time.perf_counter()
        prev = start = _event(dev, traced)
        while True:
            step = p["state"].step
            kinds.append(kind(cfg, step))
            with spans("data"):
                real = next(p["loader"])
            with spans("draws"):
                drawn = p["draw_step"](cfg, step, p["draw_gen"], dev)
            with spans(f"step.{kinds[-1]}"):
                p["step_fn"](p["state"], real, drawn)
            state.steps.append(step)
            ev = _event(dev, traced)
            if ev is not None:  # keep one step in flight: wait for the one before, then read the clock
                ends.append(ev)
                prev.synchronize()
                prev = ev
            if len(state.steps) % cycle == 0 and time.perf_counter() - t0 >= seconds:
                break
        if prev is not None:
            prev.synchronize()
        window_s = time.perf_counter() - t0
    if cuda:
        state.window_peak = torch.cuda.max_memory_allocated(dev)
    if traced and cuda:  # each step's span on the device's clock, from the end of the one before
        for k, a, b in zip(kinds, [start] + ends, ends):
            spans.seconds.setdefault(f"device.step.{k}", []).append(a.elapsed_time(b) / 1000.0)
    return {"window_s": window_s, "train_img_s": len(state.steps) * cfg.batch_size / window_s}


def work(state: State) -> dict:
    cfg, conf = state.cfg, state.cell.config
    kw = dict(d_reg_every=cfg.d_reg_every, g_reg_every=cfg.g_reg_every, path_batch_shrink=cfg.path_batch_shrink)
    fwd = grad = fl = 0
    for step in state.steps:
        fl += flops.train_step_flops(conf, cfg.batch_size, step, **kw)
        f, g = work_bytes.train_step_bytes(conf, cfg.batch_size, step, **kw)
        fwd, grad = fwd + f, grad + g
    return {"flops": fl, "fused_bias_act_bytes": fwd, "fused_bias_act_grad_bytes": grad,
            "peak_mem_bytes": state.window_peak}


def counts(state: State, bad_rows: int) -> tuple[int, int]:
    """(steps in the window, rows of the compared steps that are no record of the data set)."""
    return len(state.steps), bad_rows


def release(state: State) -> None:
    if state.program is not None:
        state.program["loader"].close()
    state.program = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(state.data_dir, ignore_errors=True)


def _digest(img: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(img).tobytes(), digest_size=16).digest()


def matched_reals(state: State) -> tuple[list[torch.Tensor], int]:
    """The benchmark's own images for the rows the loader handed to steps
    0-2 (each row has to be a record or its mirror, and the rows all
    differ), and how many rows failed that."""
    index = {}
    for i, img in enumerate(state.data):
        index[_digest(img)] = (i, False)
        index.setdefault(_digest(img[:, ::-1]), (i, True))
    out, bad, seen = [], 0, set()
    for batch in state.recorded["reals"]:
        rows = []
        for row in batch.reshape(-1, *batch.shape[-3:]).numpy():
            hit = index.get(_digest(row))
            if hit is None or hit[0] in seen:
                bad += 1
                rows.append(np.zeros_like(row))
                continue
            seen.add(hit[0])
            img = state.data[hit[0]]
            rows.append(img[:, ::-1] if hit[1] else img)
        out.append(ref_train.as_reals(torch.from_numpy(np.stack(rows)).to(state.device)))
    return out, bad


def ref_config(state: State) -> dict:
    conf = state.cell.config
    rc = dict(conf["train"], size=conf["size"])
    rc["r1"] = conf["train"]["r1"] * conf["size"] ** 2
    return rc


def reference(state: State, reals: list, tf32: bool = False, fault: Optional[str] = None,
              dtype: torch.dtype = torch.float32) -> dict:
    """The reference's steps 0-2; `dtype` float64 makes a witness of higher
    precision (ADA's variates stay fp32: they only decide the identity)."""
    draws = _to(state.recorded["draws"], state.device, dtype, skip="aug")
    gw, dw = (_to(w, state.device, dtype) for w in (state.gw, state.dw))
    with ref.precision(tf32):
        return ref_train.train(gw, dw, ref_config(state), [r.to(dtype) for r in reals], draws, fault)


def _to(x, dev, dtype=None, skip: Optional[str] = None):
    """Tensors of x on dev, floating ones in dtype (the key `skip` of a dict kept as it is)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype) if dtype is not None and x.is_floating_point() else x.to(dev)
    if isinstance(x, dict):
        return {k: (v if k == skip else _to(v, dev, dtype, skip)) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, dev, dtype, skip) for v in x]
    return x


def _leaf_gaps(a: dict, b: dict, keep: Optional[set] = None) -> list[float]:
    """Per leaf |norm(a) - norm(b)| / max(norm(b), median leaf norm of b)."""
    keys = [k for k in b if keep is None or k in keep]
    na = {k: float(a[k].double().norm()) for k in keys}
    nb = {k: float(b[k].double().norm()) for k in keys}
    med = float(np.median(list(nb.values())))
    return [abs(na[k] - nb[k]) / max(nb[k], med, 1e-30) for k in keys]


def compare(prog: dict, refr: dict, g0: dict, d0: dict) -> dict[str, float]:
    """The numbers that can be compared between a run of the compared steps
    and the reference's: the worst and the median leaf of each gap, and the
    losses of every step and of the first. The three the cells compare
    (see PERF.md for the readings behind the choice):
    * first_loss_gap: step 0's D and G losses (D on the initial weights; G
      after D's two Adam steps), relative; first_loss_gap.d: D's alone;
    * first_grad_gap.d: the worst leaf of D's first gradient (step 0's D
      phase, before any update);
    * change_gap: the worst leaf of the weights' change over the compared
      steps (G, D and the EMA)."""
    out = {"loss_gap": 0.0}
    for step, (pl, rl) in enumerate(zip(prog["losses"], refr["losses"])):
        for k, rv in rl.items():
            gap = abs(pl[k] - rv) / max(abs(rv), 1e-12)
            out["loss_gap"] = max(out["loss_gap"], gap)
            if step == 0:
                out[f"loss_gap.step0.{k.split()[0].lower()}"] = gap
    out["loss_gap.step0"] = max(v for k, v in out.items() if k.startswith("loss_gap.step0."))
    out["first_loss_gap"] = max(out["loss_gap.step0.discriminator"], out["loss_gap.step0.generator"])
    out["first_loss_gap.d"] = out["loss_gap.step0.discriminator"]
    firsts = prog["first_grads"]
    grads = [_leaf_gaps(firsts[n], refr["first_grads"][n]) if n in firsts else [math.inf] for n in ("d", "g")]
    out["grad_gap"] = max(max(g) for g in grads)
    out["grad_gap.median"] = max(float(np.median(g)) for g in grads)
    out["first_grad_gap.d"] = max(grads[0])
    moved = {}
    for n in ("d", "g"):  # leaves whose gradient is nought to rounding move by round-off alone under Adam
        norms = {k: float(v.double().norm()) for k, v in refr["first_grads"][n].items()}
        med = float(np.median(list(norms.values())))
        moved[n] = {k for k, v in norms.items() if v >= 1e-3 * med}
    changes = []
    for n, start, rule in (("g", g0, "g"), ("d", d0, "d"), ("g_ema", g0, "g")):
        dp = {k: prog[n][k] - start[k] for k in refr[n]}
        dr = {k: refr[n][k] - start[k] for k in refr[n]}
        changes.append(_leaf_gaps(dp, dr, moved[rule]))
    out["change_gap"] = max(max(c) for c in changes)
    out["change_gap.median"] = max(float(np.median(c)) for c in changes)
    return out


def program_readings(state: State) -> dict:
    r = state.recorded
    return {"losses": r["losses"], "first_grads": r["first_grads"], "g": r["g"], "d": r["d"], "g_ema": r["g_ema"]}


def judge(state: State) -> tuple[dict[str, float], int]:
    """The numbers compared, and how many rows of the compared steps are no record of the data set."""
    reals, bad = matched_reals(state)
    return compare(program_readings(state), reference(state, reals), state.gw, state.dw), bad


def look(state: State) -> dict:
    """The judge's numbers, and what lies behind D's first gradient: its
    median leaf's gap, its three worst leaves ([name, gap, program norm,
    reference norm, elements]), the median leaf norm, and how many of its
    elements the two sides give opposite signs (Adam's first update with
    beta1 = 0 is lr x sign(g), so each such element moves 2 lr apart)."""
    reals, bad = matched_reals(state)
    prog, refr = program_readings(state), reference(state, reals)
    out = compare(prog, refr, state.gw, state.dw)
    a, b = prog["first_grads"]["d"], refr["first_grads"]["d"]
    gaps = dict(zip(list(b), _leaf_gaps(a, b)))
    norms = {k: float(v.double().norm()) for k, v in b.items()}
    out["first_grad_gap.d.median"] = float(np.median(list(gaps.values())))
    out["look.d_worst"] = [[k, gaps[k], float(a[k].double().norm()), norms[k], b[k].numel()]
                           for k in sorted(gaps, key=gaps.get, reverse=True)[:3]]
    out["look.d_median_norm"] = float(np.median(list(norms.values())))
    out["look.d_sign_flips"] = sum(int(((a[k] > 0) != (b[k] > 0)).sum()) for k in b)
    out["missing"] = bad
    return out


def witness(state: State) -> dict:
    """The program's and the fp32 reference's gaps, each against a float64
    reference of the same steps (which of the two lies nearer the exact result)."""
    reals, _ = matched_reals(state)
    exact = reference(state, reals, dtype=torch.float64)
    ref32 = reference(state, reals)
    prog = program_readings(state)
    return {"program": compare(prog, exact, state.gw, state.dw), "reference": compare(ref32, exact, state.gw, state.dw)}


def control(state: State, fault: Optional[str] = None) -> dict[str, float]:
    """The reference put in the program's place: in TF32 (the control), or
    in fp32 with a planted fault; judged by the fp32 reference."""
    reals, _ = matched_reals(state)
    base = reference(state, reals)
    other = reference(state, reals, tf32=fault is None, fault=fault)
    return compare(other, base, state.gw, state.dw)
