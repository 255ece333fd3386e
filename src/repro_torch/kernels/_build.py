"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library of its own with a
plain C interface under the repository's ``build/`` directory, at first use,
and is loaded with ``ctypes``; the sources compile in parallel, one ``nvcc``
each. A library's name carries a hash of its source and the flags, so an
edited source builds anew and a stale library is never loaded. Nothing here
runs at import time: this module must import on hosts without a GPU or
``nvcc``.

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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: -fmad=false: no multiply-add contraction, so every float kernel performs
#: the same fp32 roundings, in the same order, as its plain PyTorch version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_F = ctypes.c_float

#: Per library (the stem of its source): the C launchers with their
#: signatures (pointers, ints, then the stream) and the wrapper each one
#: serves, in the order of the source's ``<stem>_occupancy`` kernel ids.
LIBRARIES = {
    "stockham": {
        # xr, xi, yr, yi, wr, wi, scratch, batch, log2n, radix, inverse,
        # block
        "stockham_fft": ("fft_planes", [_P] * 7 + [_I] * 5 + [_P]),
        # x, yr, yi, wr, wi, scratch, batch, log2n, radix, block
        "stockham_rfft": ("rfft_planes", [_P] * 6 + [_I] * 4 + [_P]),
        # ar, ai, br, bi, cr, ci, wr, wi, scratch, batch, log2n, radix,
        # block
        "stockham_polymul_complex": ("polymul_complex_planes",
                                     [_P] * 9 + [_I] * 4 + [_P]),
        # a, b, c, wr, wi, wir, wii, scratch, batch, log2n, radix, block
        "stockham_polymul_real": ("polymul_real_planes",
                                  [_P] * 8 + [_I] * 4 + [_P]),
        # xr, xi, y, wr, wi, scratch, batch, log2n, radix, block
        "stockham_irfft": ("irfft_planes", [_P] * 6 + [_I] * 4 + [_P]),
    },
    "ntt": {
        # x, y, w, scratch, batch, log2n, q, qinv, scale, inverse, block
        "ntt_batched": ("ntt_batched",
                        [_P] * 4 + [_I] * 2 + [_U] * 3 + [_I] * 2 + [_P]),
        # a, b, c, wf, wi, twist, untwist, scratch, batch, log2n, q, qinv,
        # r2, negacyclic, block
        "ntt_polymul": ("ntt_polymul",
                        [_P] * 8 + [_I] * 2 + [_U] * 3 + [_I] * 2 + [_P]),
        # a, b, c, scal, wf, wi, twist, untwist, scratch, limbs, batch,
        # log2n, negacyclic, block
        "ntt_rns_polymul": ("rns_ntt_polymul", [_P] * 9 + [_I] * 5 + [_P]),
    },
    "attention": {
        # q, k, v, o, batch, seq, heads, kv_heads, head_dim, the (batch,
        # seq, head) element strides of q, k, v and o, window, causal,
        # scale, bf16
        "flash_attention": ("flash_attention",
                            [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 2
                            + [_F, _I, _P]),
    },
}

#: Kernel launches per wrapper (see the module docstring).
LAUNCHES: dict[str, int] = {wrapper: 0 for lib in LIBRARIES.values()
                            for wrapper, _ in lib.values()}

#: wrapper -> (library, kernel id of ``<library>_occupancy``)
_KERNEL_IDS = {wrapper: (stem, i) for stem, lib in LIBRARIES.items()
               for i, (wrapper, _) in enumerate(lib.values())}
#: C launcher -> library
_LAUNCHER_LIB = {name: stem for stem, lib in LIBRARIES.items()
                 for name in lib}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def library_path(stem: str) -> Path:
    source = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is not built yet, one ``nvcc``
    per source, all started together.

    Each writes to a temporary name and renames, so a concurrent or
    interrupted build never leaves a half-written library under the final
    name."""
    outs = {stem: library_path(stem) for stem in LIBRARIES}
    todo = {stem: out for stem, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for stem, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {stem}.cu "
                              f"(rc={proc.returncode}):\n{stdout}\n{stderr}")
            else:
                os.replace(tmp, todo[stem])
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load(stem: str = "stockham") -> ctypes.CDLL:
    """The loaded kernel library ``stem``; every library is built at first
    use."""
    with _lock:
        if not _libs:
            for name, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn_name, (_, argtypes) in LIBRARIES[name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                occ = getattr(lib, f"{name}_occupancy")
                occ.argtypes = [_I] * 4 + [ctypes.POINTER(_I)] * 4
                occ.restype = ctypes.c_int
                err = getattr(lib, f"{name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _libs[name] = lib
        return _libs[stem]


def _error(stem: str, err: int) -> str:
    return getattr(load(stem), f"{stem}_error_string")(err).decode()


def launch(name: str, counter: str, *args) -> None:
    """Call C launcher ``name`` on PyTorch's current stream, raise if the
    launch was refused, and count it under ``counter``."""
    import torch
    stem = _LAUNCHER_LIB[name]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(stem), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({_error(stem, err)})")
    LAUNCHES[counter] += 1


def occupancy(counter: str, a: int, b: int, c: int) -> dict[str, int]:
    """How the wrapper ``counter`` launches its kernel, and what the card
    makes of it: threads per CTA, dynamic shared memory in bytes, registers
    per thread, and the CTAs one SM holds. ``a, b, c`` select the launch:
    (log2 n, rows per CTA, staged) for the transform kernels, (head_dim,
    bf16, 0) for attention."""
    stem, kernel = _KERNEL_IDS[counter]
    out = [_I() for _ in range(4)]
    err = getattr(load(stem), f"{stem}_occupancy")(
        kernel, a, b, int(c), *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"{stem}_occupancy({counter}): CUDA error {err} "
                           f"({_error(stem, err)})")
    keys = ("threads", "smem_bytes", "regs", "ctas_per_sm")
    return {k: v.value for k, v in zip(keys, out)}
