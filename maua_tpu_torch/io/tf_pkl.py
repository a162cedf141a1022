"""TF StyleGAN2 `.pkl` -> the port's Generator (counterpart of
maua_tpu/io/tf_pkl.py), with neither TensorFlow nor dnnlib.

A custom Unpickler stands in for `dnnlib.tflib.network.Network` and keeps its
pickled variable list (name -> ndarray). The names map onto the rosinality
state dict of `models.stylegan2.Generator`:

  G_mapping/Dense{i}          [in, out] -> style.{i+1}.weight [out, in]
  G_synthesis/{res}/Conv*     HWIO -> [1, O, I, k, k]; Conv0_up's taps flipped
  mod_weight, mod_bias        -> modulation.weight [in, style], bias + 1
  noise_strength, bias        -> noise.weight [1], activate.bias
  G_synthesis/noise{i}        -> noises.noise_{i}

Unpickling runs code named by the file: load only pickles you trust.
"""

from __future__ import annotations

import math
import pickle
from typing import Any

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["generator_state_dict_from_tf", "load_tf_generator", "load_tf_pickle_networks"]


class _NetworkStub:
    """Keeps the pickled state of dnnlib.tflib.network.Network."""

    def __setstate__(self, state: dict):
        self.name = state.get("name")
        self.static_kwargs = dict(state.get("static_kwargs", {}))
        self.variables = {name: np.asarray(val) for name, val in state.get("variables", [])}
        self.components = dict(state.get("components", {}))


class _StubUnpickler(pickle.Unpickler):
    _PASSTHROUGH = {"EasyDict": dict}

    def find_class(self, module: str, name: str):
        if module.startswith("dnnlib") or module.startswith("torch_utils"):
            if name == "Network":
                return _NetworkStub
            if name in self._PASSTHROUGH:
                return self._PASSTHROUGH[name]

            class _Any(dict):
                def __setstate__(self, state):
                    if isinstance(state, dict):
                        self.update(state)

            return _Any
        return super().find_class(module, name)


def load_tf_pickle_networks(path: str) -> dict[str, _NetworkStub]:
    """Load a TF StyleGAN / StyleGAN2 pickle; returns whichever of
    {'G', 'D', 'Gs'} it holds, each with its components' variables merged in
    under `<component>/<name>`."""
    with open(path, "rb") as f:
        obj = _StubUnpickler(f).load()
    nets: dict[str, _NetworkStub] = {}
    if isinstance(obj, (tuple, list)):
        for name, net in zip(["G", "D", "Gs"], obj):
            if isinstance(net, _NetworkStub):
                nets[name] = net
    elif isinstance(obj, _NetworkStub):
        nets["Gs"] = obj
    elif isinstance(obj, dict):
        nets = {k: v for k, v in obj.items() if isinstance(v, _NetworkStub)}
    if not nets:
        raise ValueError(f"{path}: no dnnlib Network objects found")
    for net in nets.values():
        for comp_name, comp in net.components.items():
            if isinstance(comp, _NetworkStub):
                for vname, val in comp.variables.items():
                    net.variables.setdefault(f"{comp_name}/{vname}", val)
    return nets


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def generator_state_dict_from_tf(net: _NetworkStub) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
    """A Gs network -> (Generator config, rosinality state dict without the
    FIR kernel buffers)."""
    v = net.variables
    res = int(net.static_kwargs.get("resolution", 0))
    if not res:
        res = max(int(k.split("/")[1].split("x")[0]) for k in v if k.startswith("G_synthesis/") and "x" in k.split("/")[1])
    log_size = int(math.log2(res))
    sd: dict[str, torch.Tensor] = {}

    def put_modconv(prefix, src, flip=False):
        w = v[f"{src}/weight"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if flip:
            w = w[:, :, ::-1, ::-1]
        sd[f"{prefix}.weight"] = _t(w)[None]
        sd[f"{prefix}.modulation.weight"] = _t(v[f"{src}/mod_weight"]).t().contiguous()
        sd[f"{prefix}.modulation.bias"] = _t(v[f"{src}/mod_bias"] + 1.0)

    def put_styled(prefix, src, flip=False):
        put_modconv(f"{prefix}.conv", src, flip)
        sd[f"{prefix}.noise.weight"] = _t(np.atleast_1d(v[f"{src}/noise_strength"]))
        sd[f"{prefix}.activate.bias"] = _t(v[f"{src}/bias"])

    def put_torgb(prefix, src):
        put_modconv(f"{prefix}.conv", src)
        sd[f"{prefix}.bias"] = _t(v[f"{src}/bias"].reshape(1, 3, 1, 1))

    n_mlp = sum(1 for k in v if k.startswith("G_mapping/Dense") and k.endswith("/weight"))
    for i in range(n_mlp):
        sd[f"style.{i + 1}.weight"] = _t(v[f"G_mapping/Dense{i}/weight"]).t().contiguous()
        sd[f"style.{i + 1}.bias"] = _t(v[f"G_mapping/Dense{i}/bias"])
    sd["input.input"] = _t(v["G_synthesis/4x4/Const/const"])
    put_styled("conv1", "G_synthesis/4x4/Conv")
    put_torgb("to_rgb1", "G_synthesis/4x4/ToRGB")
    for i in range(log_size - 2):
        reso = 4 * 2 ** (i + 1)
        put_styled(f"convs.{2 * i}", f"G_synthesis/{reso}x{reso}/Conv0_up", flip=True)
        put_styled(f"convs.{2 * i + 1}", f"G_synthesis/{reso}x{reso}/Conv1")
        put_torgb(f"to_rgbs.{i}", f"G_synthesis/{reso}x{reso}/ToRGB")
    for i in range((log_size - 2) * 2 + 1):
        if f"G_synthesis/noise{i}" in v:
            sd[f"noises.noise_{i}"] = _t(v[f"G_synthesis/noise{i}"])

    widths = [int(v[f"G_synthesis/{4 * 2 ** (i + 1)}x{4 * 2 ** (i + 1)}/Conv1/weight"].shape[3]) for i in range(log_size - 2)]
    base64 = {64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}
    const_ch = int(v["G_synthesis/4x4/Const/const"].shape[1])
    config = dict(
        size=res,
        style_dim=int(v["G_mapping/Dense0/weight"].shape[0]),
        n_mlp=n_mlp,
        channel_multiplier=max(1, widths[-1] // base64[res]) if res >= 64 else 2,
        constant_input=True,
        channel_max=min(512, max(widths + [const_ch])),
    )
    return config, sd


def load_tf_generator(path: str, key: str = "Gs", device: DeviceLike = None, **overrides):
    """TF .pkl -> the port's Generator on `device` (default `cuda`;
    RuntimeError without a card), in eval mode with no gradient on its
    weights. FIR kernels and noise buffers the pickle lacks are the
    Generator's own (zeros for noise)."""
    from ..models import Generator

    device = resolve_device(device)
    nets = load_tf_pickle_networks(path)
    net = nets.get(key) or next(iter(nets.values()))
    config, sd = generator_state_dict_from_tf(net)
    config.update(overrides)
    gen = Generator(**config)
    for name, buf in gen.state_dict().items():
        if name not in sd and (name.endswith(".kernel") or name.startswith("noises.")):
            sd[name] = buf
    gen.load_state_dict(sd, strict=True)
    return gen.requires_grad_(False).to(device).eval()
