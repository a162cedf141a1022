"""maua_tpu_torch.audio against maua_tpu.audio on the CPU: each DSP primitive
and pipeline on <= 2 s of synthesized audio at 22050 Hz, the same numpy input
through both. Tolerances: stft / istft / resample_signal 1e-4 of the max
magnitude; filters and envelopes 1e-4 abs (relative to the envelope's peak
where it is larger than 1); gaussian_filter 1e-5; padding exact."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import maua_tpu.audio as jar
import maua_tpu_torch.audio as tar

SR = 22050

# modules by name: each package exports functions named like some of its modules
jchroma, jdsp, jfeatures, jhpss, jonsets, jseg = (
    importlib.import_module(f"maua_tpu.audio.{m}") for m in ("chroma", "dsp", "features", "hpss", "onsets", "segmentation"))
tchroma, tdsp, tfeatures, thpss, tonsets, tseg = (
    importlib.import_module(f"maua_tpu_torch.audio.{m}") for m in ("chroma", "dsp", "features", "hpss", "onsets", "segmentation"))


def click_track(dur=2.0, bpm=120.0, f0=440.0, seed=0):
    """A two-note tone, a decaying 55 Hz kick and a 1.5 kHz click on
    alternate beats, and a little noise: known onsets and chroma, with peaks
    and medians well apart. The kick keeps the low band's percussive part
    from falling silent, where madmom's modified KL term would divide
    rounding noise by rounding noise."""
    n = int(SR * dur)
    t = np.arange(n) / SR
    y = 0.1 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(2 * np.pi * 1.5 * f0 * t)
    period = int(SR * 60.0 / bpm)
    kick = 0.6 * np.sin(2 * np.pi * 55.0 * np.arange(4000) / SR) * np.exp(-np.arange(4000) / 800.0)
    for k, start in enumerate(range(period // 4, n - 4000, period)):
        if k % 2 == 0:
            y[start : start + 4000] += kick
        else:
            y[start : start + 200] += np.hanning(200) * np.sin(2 * np.pi * 1500 * np.arange(200) / SR)
    y += 0.003 * np.random.default_rng(seed).standard_normal(n)
    return y.astype(np.float32)


@pytest.fixture(autouse=True)
def cpu_and_smf():
    """The port on the CPU; both packages' SMF restored after each test."""
    tar.set_device("cpu")
    smf_j, smf_t = jar.get_SMF(), tar.get_SMF()
    yield
    jar.set_SMF(smf_j)
    tar.set_SMF(smf_t)
    tar.set_device(None)


@pytest.fixture(scope="module")
def y():
    return click_track()


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol, rel_to_max=False):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel_to_max else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= atol * scale, f"max abs {err} > {atol} x {scale}"


# ---------------------------------------------------------------- padding, framing
@pytest.mark.parametrize("mode", ["reflect", "symmetric", "edge", "wrap", "constant"])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_pad_axis_matches_jnp_pad(mode, n):
    x = np.arange(n * 3, dtype=np.float32).reshape(3, n) + 1.0
    for before, after in [(0, 1), (n, n - 1 if n > 1 else 0), (3 * n, 2 * n), (2 * n + 1, 3 * n)]:
        got = tdsp.pad_axis(t(x), 1, before, after, mode).numpy()
        want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (before, after)), mode=mode))
        np.testing.assert_array_equal(got, want)


def test_frame_signal_short_signal_matches_jax():
    """A signal shorter than n_fft / 2 + 1: the reflect pad is larger than it."""
    x = np.random.default_rng(1).standard_normal(700).astype(np.float32)
    got = tdsp.frame_signal(t(x), 2048, 512)
    want = jdsp.frame_signal(jnp.asarray(x), 2048, 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("periodic", [True, False])
def test_hann_window_matches_jax(periodic):
    close(tdsp.hann_window(1024, periodic), jdsp.hann_window(1024, periodic), 1e-7)


# ---------------------------------------------------------------- stft / istft / resample
@pytest.mark.parametrize("n_fft,hop,circular", [(512, 128, False), (2048, 512, False), (2048, 441, True)])
def test_stft_matches_jax(y, n_fft, hop, circular):
    got = tdsp.stft(t(y), n_fft, hop, circular_shift=circular)
    want = np.asarray(jdsp.stft(jnp.asarray(y), n_fft=n_fft, hop_length=hop, circular_shift=circular))
    close(got.real, want.real, 1e-4 * np.abs(want).max())
    close(got.imag, want.imag, 1e-4 * np.abs(want).max())


def test_istft_matches_jax(y):
    S = np.asarray(jdsp.stft(jnp.asarray(y), n_fft=1024, hop_length=256))
    got = tdsp.istft(t(S), 1024, 256, length=len(y))
    want = jdsp.istft(jnp.asarray(S), n_fft=1024, hop_length=256, length=len(y))
    close(got, want, 1e-4 * np.abs(want).max())
    close(got, y, 1e-4)  # the round trip


@pytest.mark.parametrize("n_out", [333, 500, 1500, 1501, 1000])
@pytest.mark.parametrize("ndim", [1, 2])
def test_resample_signal_matches_jax(n_out, ndim):
    rng = np.random.default_rng(n_out)
    x = np.cumsum(rng.standard_normal((1000, 3)), axis=0).astype(np.float32)
    x = x[:, 0] if ndim == 1 else x
    want = np.asarray(jdsp.resample_signal(jnp.asarray(x), n_out))
    close(tdsp.resample_signal(t(x), n_out), want, 1e-4 * np.abs(want).max())


def test_melspectrogram_and_db_match_jax(y):
    got = tdsp.melspectrogram(t(y), SR, n_mels=64, fmin=20.0, fmax=8000.0)
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(y), SR, n_mels=64, fmin=20.0, fmax=8000.0))
    close(got, want, 1e-4 * want.max())
    close(tdsp.power_to_db(got), jdsp.power_to_db(jnp.asarray(want)), 1e-3)
    close(tdsp.amplitude_to_db(got, ref=2.0), jdsp.amplitude_to_db(jnp.asarray(want), ref=2.0), 1e-3)


# ---------------------------------------------------------------- postprocess
@pytest.mark.parametrize(
    "shape,sigma,causal,smf",
    [((200,), 5.0, None, 1.0), ((30,), 12.0, None, 1.0), ((60, 3), 4.0, 0.2, 1.0), ((40, 2, 3, 5), 2.0, 0.0, 0.5),
     ((25,), 30.0, 0.05, 2.0), ((10, 4), 0.1, None, 1.0)],
    ids=["radius<=T", "radius>T", "causal", "4d-causal-smf", "radius>T-causal", "radius0"],
)
def test_gaussian_filter_matches_jax(shape, sigma, causal, smf):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jar.set_SMF(smf)
    tar.set_SMF(smf)
    close(tar.gaussian_filter(t(x), sigma, causal=causal), jar.gaussian_filter(jnp.asarray(x), sigma, causal=causal), 1e-5)


@pytest.mark.parametrize("p", [0, 37.5, 50, 90, 100])
def test_percentile_and_clip_match_jax(p):
    rng = np.random.default_rng(3)
    sig = np.abs(rng.standard_normal(101)).astype(np.float32)
    sig[[10, 50, 80]] = [3.0, 9.0, 6.0]
    close(tar.percentile(t(sig), p), jar.percentile(jnp.asarray(sig), p), 0)
    close(tar.percentile_clip(t(sig), p), jar.percentile_clip(jnp.asarray(sig), p), 1e-6)
    flat = np.linspace(0, 1, 20, dtype=np.float32)  # no local peak: the whole signal's percentile
    close(tar.percentile_clip(t(flat), p), jar.percentile_clip(jnp.asarray(flat), p), 1e-6)


@pytest.mark.parametrize("invert", [False, True])
def test_normalize_compress_expand_match_jax(invert):
    sig = np.linspace(-3, 7, 101).astype(np.float32)
    close(tar.normalize(t(sig)), jar.normalize(jnp.asarray(sig)), 1e-6)
    n = np.asarray(jar.normalize(jnp.asarray(sig)))
    close(tar.compress(t(n), 0.5, 0.3, invert), jar.compress(jnp.asarray(n), 0.5, 0.3, invert), 1e-6)
    close(tar.expand(t(n), 0.8, 10, invert), jar.expand(jnp.asarray(n), 0.8, 10, invert), 1e-6)


def test_numpy_inputs_go_to_the_default_device():
    x = np.arange(10, dtype=np.float64)
    out = tar.normalize(x)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    tar.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tar.normalize(x)


# ---------------------------------------------------------------- hpss, onsets
@pytest.mark.parametrize("which,margin", [("hpss", 1.0), ("harmonic", 16.0), ("percussive", 8.0)])
def test_hpss_matches_jax(y, which, margin):
    if which == "hpss":
        got = thpss.hpss(t(y), margin=margin)
        want = jhpss.hpss(jnp.asarray(y), margin=margin)
        for g, w in zip(got, want):
            close(g, w, 1e-4)
    else:
        close(getattr(thpss, which)(t(y), margin=margin), getattr(jhpss, which)(jnp.asarray(y), margin=margin), 1e-4)


def test_median_filter_matches_jax():
    x = np.random.default_rng(5).standard_normal((40, 50)).astype(np.float32)
    for size, axis in [(31, 1), (31, 0), (4, 1)]:
        got = thpss._median_filter_axis(t(x), size, axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(jhpss._median_filter_axis(jnp.asarray(x), size, axis)), atol=1e-7)


def test_onset_functions_match_jax(y):
    want = np.asarray(jonsets.onset_strength(jnp.asarray(y), sr=SR))
    close(tonsets.onset_strength(t(y), sr=SR), want, 1e-4, rel_to_max=True)
    want = np.asarray(jonsets.madmom_onset_ensemble(jnp.asarray(y), sr=SR))
    close(tonsets.madmom_onset_ensemble(t(y), sr=SR), want, 1e-4, rel_to_max=True)


@pytest.mark.parametrize("fmin,fmax", [(20.0, 8000.0), (20.0, 150.0), (500.0, 8000.0)])
def test_madmom_ensemble_bands_match_jax(y, fmin, fmax):
    want = np.asarray(jonsets.madmom_onset_ensemble(jnp.asarray(y), sr=SR, fmin=fmin, fmax=fmax))
    close(tonsets.madmom_onset_ensemble(t(y), sr=SR, fmin=fmin, fmax=fmax), want, 1e-4, rel_to_max=True)


@pytest.mark.parametrize("kw", [dict(fmax=150, smooth=5, clip=97, power=2), dict(fmin=500, smooth=5, clip=99, power=2),
                                dict(type="rosa", smooth=2)], ids=["lo", "hi", "rosa"])
def test_onsets_match_jax(y, kw):
    close(tar.onsets(t(y), SR, 48, **kw), jar.onsets(jnp.asarray(y), SR, 48, **kw), 1e-4)


# ---------------------------------------------------------------- chroma
@pytest.mark.parametrize("fn", ["pseudo_cqt", "chroma_cqt", "chroma_stft", "chroma_cens", "chroma_clp"])
def test_chroma_variants_match_jax(y, fn):
    want = np.asarray(getattr(jchroma, fn)(jnp.asarray(y), sr=SR))
    close(getattr(tchroma, fn)(t(y), sr=SR), want, 1e-4, rel_to_max=True)


def test_fold_chroma_and_nn_filter_match_jax():
    C = np.abs(np.random.default_rng(7).standard_normal((36, 40))).astype(np.float32)
    close(tchroma._fold_chroma(t(C), 36, 12), jchroma._fold_chroma(jnp.asarray(C), 36, 12), 1e-6)
    C12 = C[:12]
    for k in (None, 4, 5):  # k even: the median of an even count
        close(tchroma.nn_filter_cosine(t(C12), k), jchroma.nn_filter_cosine(C12, k), 1e-6)


@pytest.mark.parametrize("type_", ["cens", "cqt", "stft", "clp"])
def test_raw_chroma_matches_jax(y, type_):
    """Each chromagram, then the nearest-neighbour filter on JAX's chromagram,
    then the two together. The stft chromagram of this steady tone has
    columns whose cosine similarities tie to 1e-7, where topk and
    argpartition pick other neighbours (a discrete step), so it is held
    without the filter; the filter is held on random columns in
    test_fold_chroma_and_nn_filter_match_jax."""
    raw = np.asarray(jchroma.raw_chroma(jnp.asarray(y), SR, type=type_, nearest_neighbor=False))
    close(tchroma.raw_chroma(t(y), SR, type=type_, nearest_neighbor=False), raw, 1e-4)
    if type_ != "stft":
        close(tchroma.nn_filter_cosine(t(raw)), jchroma.nn_filter_cosine(raw), 1e-6)
        close(tchroma.raw_chroma(t(y), SR, type=type_), jchroma.raw_chroma(jnp.asarray(y), SR, type=type_), 1e-4)


def chord_track(dur=2.0, seed=0):
    """Ten pitch classes at amplitudes from 0.1 down to 0.01: every kept
    class has energy, so the row normalization of chroma(notes < 12) does
    not divide by a near-zero sum."""
    tt = np.arange(int(SR * dur)) / SR
    y = sum(a * np.sin(2 * np.pi * 261.63 * 2 ** (k / 12) * tt) for k, a in zip(range(10), np.geomspace(0.1, 0.01, 10)))
    return (y + 0.003 * np.random.default_rng(seed).standard_normal(len(tt))).astype(np.float32)


@pytest.mark.parametrize("notes,track", [(12, "click"), (7, "chord"), (12, "chord")])
def test_chroma_matches_jax(y, notes, track):
    x = y if track == "click" else chord_track()
    close(tar.chroma(t(x), SR, 40, notes=notes), jar.chroma(jnp.asarray(x), SR, 40, notes=notes), 1e-4)


def test_chroma_deep_warns():
    with pytest.warns(UserWarning, match="deep"):
        tchroma.raw_chroma(t(click_track(0.5)), SR, type="deep")


# ---------------------------------------------------------------- features
def test_bandpass_and_rms_match_jax(y):
    np.testing.assert_allclose(tfeatures.bandpass(t(y), SR, 20, 8000), jfeatures.bandpass(y, SR, 20, 8000), atol=1e-6)
    close(tfeatures.frame_rms(t(y)), jfeatures.frame_rms(jnp.asarray(y)), 1e-5)
    close(tar.rms(t(y), SR, 48, smooth=10, clip=60, power=1), jar.rms(jnp.asarray(y), SR, 48, smooth=10, clip=60, power=1), 1e-4)
    close(tar.drop_strength(t(y), SR, 48), jar.drop_strength(jnp.asarray(y), SR, 48), 1e-4)


def test_mfcc_matches_jax(y):
    want = np.asarray(jfeatures.mfcc(jnp.asarray(y), sr=SR))
    close(tfeatures.mfcc(t(y), sr=SR), want, 1e-4, rel_to_max=True)


# ---------------------------------------------------------------- io, segmentation, util
def test_load_audio_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "track.wav"
    y = click_track(1.0)
    scipy.io.wavfile.write(str(path), 44100, np.repeat((y * 32767).astype(np.int16)[:, None], 2, axis=1))
    for kw in (dict(), dict(offset=0.25, duration=0.5)):
        a, sr, d = tar.load_audio(str(path), cache_dir="t_cache", **kw)
        b, sr_j, d_j = jar.load_audio(str(path), cache_dir="j_cache", **kw)
        assert (sr, d) == (sr_j, d_j) and isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    assert sorted(p.name for p in (tmp_path / "t_cache").iterdir()) == sorted(p.name for p in (tmp_path / "j_cache").iterdir())
    cached = tar.load_audio(str(path), cache_dir="t_cache")[0]
    np.testing.assert_array_equal(cached, tar.load_audio(str(path), cache=False)[0])


def test_beat_track_matches_jax():
    y = click_track(6.0)
    env = np.asarray(jonsets.onset_strength(jnp.asarray(y), sr=SR))
    assert tseg.beat_track(onset_env=t(env), sr=SR)[1].tolist() == jseg.beat_track(onset_env=env, sr=SR)[1].tolist()
    tempo, beats = tseg.beat_track(t(y), sr=SR)
    tempo_j, beats_j = jseg.beat_track(y, sr=SR)
    assert tempo == pytest.approx(tempo_j)
    assert beats.tolist() == beats_j.tolist()


def test_kmeans_separates_clusters():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(c, 0.1, (20, 2)) for c in (0.0, 5.0, 10.0)])
    labels = tseg._kmeans(X, 3)
    assert all(len(set(labels[i * 20 : (i + 1) * 20])) == 1 for i in range(3))
    assert len(set(labels)) == 3


@pytest.mark.slow
def test_laplacian_segmentation_matches_jax_structure():
    """Two sections (a different tone, and clicks at another tempo): both
    packages split the track; k-means seeds differ, so the labels are held
    only to their structure."""
    a, b = click_track(8.0, bpm=120, f0=440.0), click_track(8.0, bpm=150, f0=311.0, seed=1)
    y = np.concatenate([a, b])
    times, labels = tar.laplacian_segmentation(t(y), SR, k=2)
    times_j, labels_j = jar.laplacian_segmentation(y, SR, k=2)
    assert times[0] == 0.0 and times == sorted(times) and len(times) == len(labels)
    assert set(labels) <= {0, 1} and len(times_j) == len(labels_j)


def test_info_and_plots(tmp_path):
    x = t(np.linspace(0, 1, 11, dtype=np.float32))
    assert tar.info(x, "x") == jar.info(np.asarray(x), "x")
    pytest.importorskip("matplotlib")
    y = click_track(0.5)
    assert tar.plot_signals([x], labels=["x"], out_file=str(tmp_path / "s.png"))
    assert tar.plot_audio(t(y), SR, out_file=str(tmp_path / "a.png"))
    assert tar.plot_chroma_comparison(t(y), SR, out_file=str(tmp_path / "c.png"))
    assert tar.plot_spectra([tdsp.melspectrogram(t(y))], out_file=str(tmp_path / "m.png"))
