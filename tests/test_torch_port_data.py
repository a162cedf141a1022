"""maua_tpu_torch's data pipeline and checkpoints, on the CPU (the train CLI
is in test_torch_port_train_cli.py, on this file's shards).

Against the JAX package: MREC shards (raw and JPEG) written by one package
are read by the other and are byte-identical when both write the same
records; the synthetic dataset is the same from the same seed; the datasets
decode the same images; one-worker loaders give the same batches and flips.
`prepare_data` writes shards byte-equal to the JAX package's from a folder
of PNGs. Within the port: a checkpoint round trip whose `g_ema` renders
through `load_generator` (and one of the ADA and contrastive state, and a
checkpoint written before ADA was ported) and resuming from a rosinality
{g, d, g_ema} `.pt`.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from maua_tpu.data import DataLoader as JaxDataLoader
from maua_tpu.data import MultiResolutionRecordDataset as JaxDataset
from maua_tpu.data import RecordShardReader as JaxReader
from maua_tpu.data import RecordShardWriter as JaxWriter
from maua_tpu.data.synthetic import write_synth_shards as jax_write_synth_shards
from maua_tpu_torch.data import DataLoader, MultiResolutionRecordDataset, RecordShardReader, RecordShardWriter
from maua_tpu_torch.data.synthetic import write_synth_shards
from maua_tpu_torch.io import load_generator
from maua_tpu_torch.train import (
    init_train_state,
    latest_checkpoint,
    load_torch_training_checkpoint,
    make_train_config,
    restore_checkpoint,
    save_checkpoint,
)

SIDE = 8


def _records(n=5, seed=0):
    return [np.random.RandomState(seed + i).randint(0, 256, (SIDE, SIDE, 3)).astype(np.uint8) for i in range(n)]


def _jpegs(imgs):
    import cv2

    return [cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes() for img in imgs]


@pytest.mark.parametrize("fmt", ["raw", "jpeg"])
def test_mrec_shards_cross_read_and_byte_equal(tmp_path, fmt):
    imgs = _records()
    blobs = imgs if fmt == "raw" else _jpegs(imgs)
    side = SIDE if fmt == "raw" else 0
    paths = {}
    for name, writer in (("port", RecordShardWriter), ("jax", JaxWriter)):
        paths[name] = str(tmp_path / f"{name}-{SIDE}-00000.mrec")
        with writer(paths[name], fmt=fmt, side=side) as w:
            for b in blobs:
                w.append(b)
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)
    for reader, path in ((RecordShardReader, paths["jax"]), (JaxReader, paths["port"])):
        r = reader(path)
        assert len(r) == len(blobs)
        for i, b in enumerate(blobs):
            want = b.tobytes() if fmt == "raw" else b
            assert r.get(i) == want
            if fmt == "raw":
                np.testing.assert_array_equal(r.get_raw_hwc(i), b)


def test_synthetic_shards_equal_jax(tmp_path):
    assert write_synth_shards(str(tmp_path / "port"), 16, 6, seed=3, shard_size=4) == 6
    jax_write_synth_shards(str(tmp_path / "jax"), 16, 6, seed=3, shard_size=4)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["data-16-00000.mrec", "data-16-00001.mrec"] == sorted(os.listdir(tmp_path / "jax"))
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / n, tmp_path / "jax" / n, shallow=False)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    write_synth_shards(str(root), 16, 12, seed=0, shard_size=8)
    return str(root)


def test_datasets_decode_the_same_images(shards, tmp_path):
    """uint8 HWC exactly; fp32 CHW in [-1, 1] to 1e-6 (the JAX package
    converts with its native helper). JPEG shards decode alike too."""
    for u8 in (True, False):
        a, b = MultiResolutionRecordDataset(shards, 16, uint8_hwc=u8), JaxDataset(shards, 16, uint8_hwc=u8)
        assert len(a) == len(b) == 12
        for i in (0, 5, 11):
            np.testing.assert_allclose(a[i], b[i], rtol=0, atol=1e-6)
    jpeg = tmp_path / "jpeg"
    write_synth_shards(str(jpeg), 16, 3, fmt="jpeg", seed=1)
    a, b = MultiResolutionRecordDataset(str(jpeg), 16, uint8_hwc=True), JaxDataset(str(jpeg), 16, uint8_hwc=True)
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("uint8_hwc", [True, False])
def test_loader_batches_match_jax(shards, uint8_hwc):
    """One worker and one seed: the same order, flips and layout as the JAX
    loader, [A, B, H, W, 3] uint8 or [A, B, 3, H, W] fp32, on the CPU."""
    kw = dict(batch_size=4, num_accumulate=2, num_workers=1, seed=7)
    ours = DataLoader(MultiResolutionRecordDataset(shards, 16, uint8_hwc=uint8_hwc), device="cpu", **kw)
    theirs = JaxDataLoader(JaxDataset(shards, 16, uint8_hwc=uint8_hwc), **kw)
    try:
        for _ in range(3):
            a, b = next(ours), np.asarray(next(theirs))
            assert a.shape == ((2, 4, 16, 16, 3) if uint8_hwc else (2, 4, 3, 16, 16))
            assert a.dtype == (torch.uint8 if uint8_hwc else torch.float32)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    finally:
        ours.close()
        theirs.close()


def test_loader_raises_what_a_worker_could_not_read(shards):
    """A record the dataset cannot read fails the batch that needed it,
    instead of vanishing in a worker thread."""

    class Broken(MultiResolutionRecordDataset):
        def __getitem__(self, index):
            raise OSError("unreadable shard")

    loader = DataLoader(Broken(shards, 16, uint8_hwc=True), batch_size=2, num_workers=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="could not read") as info:
            next(loader)
        assert isinstance(info.value.__cause__, OSError)
    finally:
        loader.close()


CFG = dict(size=16, batch_size=4, channel_max=32, latent_dim=32, augment=False, lookahead=True, la_steps=3)


def _trained_state(steps=2):
    from maua_tpu_torch.train import draw_step, make_train_step

    cfg = make_train_config(**CFG)
    st = init_train_state(cfg, seed=1, device="cpu")
    step, gen = make_train_step(cfg), torch.Generator().manual_seed(0)
    real = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 4, 3, 16, 16)).astype(np.float32))
    for _ in range(steps):
        step(st, real, draw_step(cfg, st.step, gen, "cpu"))
    return cfg, st


def test_checkpoint_round_trip_and_g_ema_renders(tmp_path):
    """save -> restore gives back every tensor of the state (weights, Adam
    moments, lookahead cache, path mean, step); `keep` retention; the saved
    g_ema loads in load_generator and renders the image of the state's g_ema
    (max abs 1e-6)."""
    cfg, st = _trained_state()
    for step in (1, 2, 3):
        path = save_checkpoint(str(tmp_path), st, step=step, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000002.pt", "step_0000003.pt"]
    assert latest_checkpoint(str(tmp_path)) == path
    fresh = restore_checkpoint(path, init_train_state(cfg, seed=9, device="cpu"))
    assert fresh.step == st.step == 2
    for a, b in ((fresh.g, st.g), (fresh.d, st.d), (fresh.g_ema, st.g_ema)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    for a, b in ((fresh.g_optim, st.g_optim), (fresh.d_optim, st.d_optim)):
        for sa, sb in zip(a.state.values(), b.state.values()):
            torch.testing.assert_close(sa["exp_avg_sq"], sb["exp_avg_sq"], rtol=0, atol=0)
    for x, y in zip(fresh.lookahead.slow_d, st.lookahead.slow_d):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert fresh.lookahead.step == st.lookahead.step
    torch.testing.assert_close(fresh.mean_path_length, st.mean_path_length, rtol=0, atol=0)

    gen = load_generator(path, device="cpu")
    z = torch.from_numpy(np.random.RandomState(2).randn(2, 32).astype(np.float32))
    with torch.no_grad():
        want, _ = st.g_ema(z, randomize_noise=False)
        got, _ = gen(z, randomize_noise=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_checkpoint_round_trip_of_ada_and_contrastive_state(tmp_path):
    """ADA's p and counts, the head, D's Adam state over (D, head), the key
    encoder and the queue come back exactly; a checkpoint written before ADA
    was ported (p a float, no counts) restores with zero counts."""
    from maua_tpu_torch.train import draw_step, make_train_step

    kw = dict(CFG, augment=True, augment_p=0.3, contrastive_weight=0.1, contrastive_momentum=0.9, contrastive_queue=16)
    cfg = make_train_config(**kw)
    st = init_train_state(cfg, seed=1, device="cpu")
    real = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 4, 3, 16, 16)).astype(np.float32))
    make_train_step(cfg)(st, real, draw_step(cfg, 0, torch.Generator().manual_seed(0), "cpu"))
    st.ada_signs, st.ada_n = torch.tensor(3.0), torch.tensor(12.0)
    path = save_checkpoint(str(tmp_path), st)
    fresh = restore_checkpoint(path, init_train_state(cfg, seed=9, device="cpu"))
    for name in ("ada_p", "ada_signs", "ada_n"):
        torch.testing.assert_close(getattr(fresh, name), getattr(st, name), rtol=0, atol=0)
    for a, b in zip(fresh.cl_head.parameters(), st.cl_head.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(fresh.cl_state.key_d.parameters(), st.cl_state.key_d.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in ("queue", "queue_ptr", "queue_filled"):
        torch.testing.assert_close(getattr(fresh.cl_state, name), getattr(st.cl_state, name), rtol=0, atol=0)
    assert int(fresh.cl_state.queue_filled) == 8
    assert len(fresh.d_optim.state) == len(st.d_optim.state) == len(st.d_params())

    old = torch.load(path, weights_only=False)
    plain_cfg = make_train_config(**CFG)
    plain = init_train_state(plain_cfg, seed=1, device="cpu")
    old.update(d=plain.d.state_dict(), g=plain.g.state_dict(), g_ema=plain.g_ema.state_dict(),
               d_optim=plain.d_optim.state_dict(), ada_p=0.25)
    for key in ("ada_signs", "ada_n", "cl_head", "cl_state"):
        del old[key]
    torch.save(old, tmp_path / "old.pt")
    back = restore_checkpoint(str(tmp_path / "old.pt"), init_train_state(plain_cfg, seed=2, device="cpu"))
    assert back.ada_p.dtype == torch.float32 and back.ada_p.ndim == 0 and float(back.ada_p) == 0.25
    assert float(back.ada_signs) == float(back.ada_n) == 0.0


def test_prepare_data_shards_equal_jax(tmp_path):
    """A folder of PNGs (and a subfolder, and a file that is no image):
    prepare_data writes JPEG and raw shards at two sides byte-equal to the
    JAX package's, in two chunks; the port's through two worker processes
    (spawned), the JAX package's in this process (its pool forks, which a
    process running JAX's threads must not do)."""
    import cv2

    from maua_tpu.data.prepare import prepare_data as jax_prepare_data
    from maua_tpu_torch.data import prepare_data

    src = tmp_path / "images"
    (src / "sub").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(5):
        h, w = (20, 28) if i % 2 else (30, 18)
        cv2.imwrite(str(src / ("sub" if i == 4 else "") / f"img{i}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    (src / "notes.txt").write_text("not an image")
    for fmt in ("jpeg", "raw"):
        out = {}
        for name, fn, workers in (("port", prepare_data, 2), ("jax", jax_prepare_data, 1)):
            out[name] = tmp_path / f"{name}_{fmt}"
            assert fn(str(src), str(out[name]), sizes=(8, 16), n_workers=workers, shard_size=3, fmt=fmt) == 5
        names = sorted(os.listdir(out["port"]))
        assert names == sorted(os.listdir(out["jax"])) and len(names) == 4
        for n in names:
            assert filecmp.cmp(out["port"] / n, out["jax"] / n, shallow=False), n
    ds = MultiResolutionRecordDataset(str(tmp_path / "port_raw"), 16, uint8_hwc=True)
    assert len(ds) == 5 and ds[0].shape == (16, 16, 3)


def test_load_rosinality_training_checkpoint(tmp_path):
    """A {g, d, g_ema} .pt without FIR kernel buffers: weights loaded, the step
    from the file name, the lookahead cache restarted from the loaded
    weights; transfer_mapping_only takes only the mapping network."""
    _, src = _trained_state()
    strip = lambda sd: {k: v for k, v in sd.items() if not k.endswith(".kernel")}
    path = str(tmp_path / "050000.pt")
    torch.save({"g": strip(src.g.state_dict()), "d": strip(src.d.state_dict()), "g_ema": strip(src.g_ema.state_dict())}, path)
    cfg = make_train_config(**CFG)
    st = load_torch_training_checkpoint(path, init_train_state(cfg, seed=5, device="cpu"))
    assert st.step == 50000
    for a, b in ((st.g, src.g), (st.d, src.d), (st.g_ema, src.g_ema)):
        for x, y in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(st.lookahead.slow_g, src.g.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    mapped = load_torch_training_checkpoint(path, init_train_state(cfg, seed=5, device="cpu"), transfer_mapping_only=True)
    other = init_train_state(cfg, seed=5, device="cpu")
    assert mapped.step == 0
    torch.testing.assert_close(mapped.g.style[1].weight, src.g.style[1].weight, rtol=0, atol=0)
    torch.testing.assert_close(mapped.g_ema.style[8].bias, src.g_ema.style[8].bias, rtol=0, atol=0)
    torch.testing.assert_close(mapped.g.convs[0].conv.weight, other.g.convs[0].conv.weight, rtol=0, atol=0)
    torch.testing.assert_close(mapped.d.final_conv[0].weight, other.d.final_conv[0].weight, rtol=0, atol=0)


