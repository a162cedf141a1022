"""Build the CUDA sources of `maua_tpu_torch/csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into
`maua_tpu_torch/_build/<name>-<hash>.so` at first use; the hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one is
not. All sources are compiled in parallel, one nvcc process each. Nothing but
the repo's sources and the CUDA toolkit is needed: no PyTorch headers, no
`torch.utils.cpp_extension`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# library name -> {C entry point: (argtypes, restype)}
_SIGNATURES = {
    "fused_bias_act": {
        "fused_bias_act": (
            [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, bias (or NULL), out
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # rows, cols, channels
                ctypes.c_int, ctypes.c_int,  # bias_on_rows, dtype
                ctypes.c_float, ctypes.c_float,  # slope, scale
                ctypes.c_void_p,  # cudaStream_t
            ],
            ctypes.c_int,
        ),
        "fused_bias_act_grad": (
            [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dy, y, dx
                ctypes.c_int64,  # n, the element count
                ctypes.c_int,  # dtype
                ctypes.c_float, ctypes.c_float,  # slope, scale
                ctypes.c_void_p,  # cudaStream_t
            ],
            ctypes.c_int,
        ),
    },
    "upfirdn2d": {
        "upfirdn2d": (
            [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, taps, out
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # n, c, stride of n, stride of c
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, out_h, out_w
                ctypes.c_int, ctypes.c_int,  # up, down
                ctypes.c_int, ctypes.c_int,  # pad_x0, pad_y0
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # kh, kw, flip
                ctypes.c_int,  # dtype
                ctypes.c_void_p,  # cudaStream_t
            ],
            ctypes.c_int,
        ),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda; None if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    return None


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build() -> dict[str, Path]:
    """Compile every stale `csrc/*.cu`; return {name: path of its .so}.

    Raises RuntimeError when nvcc cannot be found or a source fails to compile.
    The ptxas report (registers, spills) of each build is kept beside the
    library as `<name>-<hash>.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    stale = [src for src in sources if not targets[src.stem].exists()]
    if stale:
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
                "the CUDA kernels of maua_tpu_torch/csrc need the CUDA toolkit to build"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in stale:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
                continue
            targets[src.stem].with_suffix(".log").write_text(log)
            os.replace(tmp, targets[src.stem])  # atomic: concurrent builds agree
        if failures:
            raise RuntimeError("nvcc failed to build\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library `csrc/<name>.cu`, built if needed, with the C
    signatures of its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _loaded[name] = lib
    return lib
