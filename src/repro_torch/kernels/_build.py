"""Build and load the hand-written CUDA kernels (``csrc/stockham.cu``).

The source compiles with ``nvcc`` into a shared library with a plain C
interface under the repository's ``build/`` directory, at first use, and is
loaded with ``ctypes``. The library name carries a hash of the source and
the flags, so an edited source builds anew and a stale library is never
loaded. Nothing here runs at import time: this module must import on hosts
without a GPU or ``nvcc``.

Every kernel wrapper adds one to its entry in ``LAUNCHES`` each time it
launches its kernel, and nowhere else, so a run can show that the serve
path really went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "stockham.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: -fmad=false: no multiply-add contraction, so every kernel performs the
#: same fp32 roundings, in the same order, as its plain PyTorch version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches per wrapper (see the module docstring).
LAUNCHES: dict[str, int] = {
    "fft_planes": 0,
    "rfft_planes": 0,
    "polymul_complex_planes": 0,
    "polymul_real_planes": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of csrc/stockham.cu: pointers, ints, then the stream.
_SIGNATURES = {
    # xr, xi, yr, yi, wr, wi, scratch, batch, log2n, radix, inverse, block
    "stockham_fft": [_P] * 7 + [_I] * 5 + [_P],
    # x, yr, yi, wr, wi, scratch, batch, log2n, radix, block
    "stockham_rfft": [_P] * 6 + [_I] * 4 + [_P],
    # ar, ai, br, bi, cr, ci, wr, wi, scratch, batch, log2n, radix, block
    "stockham_polymul_complex": [_P] * 9 + [_I] * 4 + [_P],
    # a, b, c, wr, wi, wir, wii, scratch, batch, log2n, radix, block
    "stockham_polymul_real": [_P] * 8 + [_I] * 4 + [_P],
}

#: Kernel ids of ``stockham_occupancy``, by wrapper.
_KERNEL_IDS = {name: i for i, name in enumerate(LAUNCHES)}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}-{digest}.so"


def build() -> Path:
    """Compile the source unless its library is already built.

    Writes to a temporary name and renames, so a concurrent or interrupted
    build never leaves a half-written library under the final name."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name} "
                           f"(rc={res.returncode}):\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.stockham_occupancy.argtypes = ([_I] * 4
                                               + [ctypes.POINTER(_I)] * 4)
            lib.stockham_occupancy.restype = ctypes.c_int
            lib.stockham_error_string.argtypes = [ctypes.c_int]
            lib.stockham_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call C launcher ``name`` on PyTorch's current stream, raise if the
    launch was refused, and count it under ``counter``."""
    import torch
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({lib.stockham_error_string(err).decode()})")
    LAUNCHES[counter] += 1


def occupancy(counter: str, log2n: int, block: int, staged: bool
              ) -> dict[str, int]:
    """How the wrapper ``counter`` launches its kernel for ``block`` rows per
    CTA, and what the card makes of it: threads per CTA, dynamic shared
    memory in bytes, registers per thread, and the CTAs one SM holds."""
    lib = load()
    out = [_I() for _ in range(4)]
    err = lib.stockham_occupancy(_KERNEL_IDS[counter], log2n, block,
                                 int(staged), *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"stockham_occupancy({counter}): CUDA error {err} "
                           f"({lib.stockham_error_string(err).decode()})")
    keys = ("threads", "smem_bytes", "regs", "ctas_per_sm")
    return {k: v.value for k, v in zip(keys, out)}
