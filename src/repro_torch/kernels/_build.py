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
path really went through the kernels. Where a wrapper has several
schedules, the call is also counted under (wrapper, schedule) in
``SCHEDULES``, so a run can show which one it took. The launch is a span
of its own, ``repro_torch.launch/<launcher>``, counted at the same place.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch import spans

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
        # xr, xi, yr, yi, wr, wi, scratch, tw2, batch, log2n, radix,
        # inverse, block, then the two-pass split: log2 n1, log2 c1, log2
        # c2 (log2 n1 = 0: one CTA per block of rows; else scratch holds
        # the intermediate and tw2 the pass-2 twiddles)
        "stockham_fft": ("fft_planes", [_P] * 8 + [_I] * 8 + [_P]),
        # x, yr, yi, wr, wi, scratch, tw2, batch, log2n, radix, block,
        # log2 n1, log2 c1, log2 c2
        "stockham_rfft": ("rfft_planes", [_P] * 7 + [_I] * 7 + [_P]),
        # ar, ai, br, bi, cr, ci, wr, wi, scratch, tw2f, tw2i, batch,
        # log2n, radix, block, then the split-pass schedule: log2 n1, log2
        # c1, log2 cm, log2 ci (log2 n1 = 0: one CTA per block of rows;
        # else scratch holds the intermediates, tw2f and tw2i the forward
        # and inverse pass-2 twiddles)
        "stockham_polymul_complex": ("polymul_complex_planes",
                                     [_P] * 11 + [_I] * 8 + [_P]),
        # a, b, c, wr, wi, wir, wii, scratch, tw2f, tw2i, twi (M's inverse
        # twiddles), batch, log2n, radix, block, log2 n1, log2 c1, log2 cm,
        # log2 ci
        "stockham_polymul_real": ("polymul_real_planes",
                                  [_P] * 11 + [_I] * 8 + [_P]),
        # xr, xi, y, wr, wi, scratch, tw2, batch, log2n, radix, block,
        # log2 n1, log2 c1, log2 c2 (log2 n1 = 0: one CTA per block of
        # rows; else scratch holds the intermediate and tw2 the inverse
        # pass-2 twiddles)
        "stockham_irfft": ("irfft_planes", [_P] * 7 + [_I] * 7 + [_P]),
    },
    "ntt": {
        # x, y, w, scratch, tw2, batch, log2n, q, qinv, scale, inverse,
        # block, then the two-pass schedule: log2 n1, log2 c1, log2 c2
        # (log2 n1 = 0: one CTA per block of rows; else scratch holds the
        # intermediate and tw2 the pass-2 twiddles)
        "ntt_batched": ("ntt_batched",
                        [_P] * 5 + [_I] * 2 + [_U] * 3 + [_I] * 5 + [_P]),
        # a, b, c, wf, wi, twist, untwist, scratch, tw2f, tw2i, batch,
        # log2n, q, qinv, r2, negacyclic, block, then the split-pass
        # schedule: log2 n1, log2 c1, log2 cm, log2 ci (log2 n1 = 0: one
        # CTA per block of rows; else scratch holds the intermediates, tw2f
        # and tw2i the forward and inverse pass-2 twiddles)
        "ntt_polymul": ("ntt_polymul",
                        [_P] * 10 + [_I] * 2 + [_U] * 3 + [_I] * 6 + [_P]),
        # a, b, c, scal, wf, wi, twist, untwist, scratch, tw2f, tw2i,
        # limbs, batch, log2n, negacyclic, block, steps, then the
        # split-pass schedule: log2 n1, log2 c1, log2 cm, log2 ci (log2 n1
        # > 0: the split-pass launches, tw2f and tw2i the limbs' pass-2
        # tables; else steps = 1: the register-step kernel; else one CTA
        # per block of rows and limb)
        "ntt_rns_polymul": ("rns_ntt_polymul",
                            [_P] * 11 + [_I] * 10 + [_P]),
    },
    "attention": {
        # q, k, v, o, batch, seq, heads, kv_heads, head_dim, the (batch,
        # seq, head) element strides of q, k, v and o, window, causal,
        # scale, bf16
        "flash_attention": ("flash_attention",
                            [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 2
                            + [_F, _I, _P]),
        # the same arguments; bf16 must be 1 and head_dim 32, 64, 128 or 320
        "flash_attention_wgmma": ("flash_attention_wgmma",
                                  [_P] * 4 + [_I] * 5 + [_L] * 12
                                  + [_I] * 2 + [_F, _I, _P]),
        # the same arguments; bf16 must be 0 and head_dim 32, 64, 128 or
        # 320
        "flash_attention_tf32": ("flash_attention_tf32",
                                 [_P] * 4 + [_I] * 5 + [_L] * 12
                                 + [_I] * 2 + [_F, _I, _P]),
    },
}

#: Kernel launches per wrapper (see the module docstring).
LAUNCHES: dict[str, int] = {wrapper: 0 for lib in LIBRARIES.values()
                            for wrapper, _ in lib.values()}
#: Calls per (wrapper, schedule) of the wrappers that name their schedule.
SCHEDULES: collections.Counter[tuple[str, str]] = collections.Counter()

#: wrapper -> (library, kernel id of ``<library>_occupancy``)
_KERNEL_IDS = {wrapper: (stem, i) for stem, lib in LIBRARIES.items()
               for i, (wrapper, _) in enumerate(lib.values())}
#: C launcher -> library
_LAUNCHER_LIB = {name: stem for stem, lib in LIBRARIES.items()
                 for name in lib}
#: C launcher -> its span (``repro_torch/spans.py``)
_LAUNCH_SPANS = {name: f"repro_torch.launch/{name}" for name in _LAUNCHER_LIB}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SCHEDULES.clear()


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


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel would drop a gradient: a launch reads the
    tensors' memory, so autograd cannot see through it. Inside an
    ``autograd.Function``'s forward grad mode is off, so the kernels'
    differentiable routes (``kernels/ops.py::fft_causal_conv``,
    ``models/layers/attention.py::blockwise_attention``) pass."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and a kernel launch has no "
            f"backward; call it under torch.no_grad() or through a "
            f"differentiable route (kernels.ops.fft_causal_conv, "
            f"models.layers.attention.blockwise_attention)")


def launch(name: str, counter: str, *args, schedule: str | None = None
           ) -> None:
    """Call C launcher ``name`` on PyTorch's current stream, raise if the
    launch was refused, and count it under ``counter`` (and under
    (``counter``, ``schedule``) where the wrapper names one), all inside
    the span ``repro_torch.launch/<name>``."""
    import torch
    with spans.span(_LAUNCH_SPANS[name]):
        stem = _LAUNCHER_LIB[name]
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(load(stem), name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error "
                               f"{err} ({_error(stem, err)})")
        LAUNCHES[counter] += 1
        if schedule is not None:
            SCHEDULES[counter, schedule] += 1


def occupancy(counter: str, a: int, b: int, c: int) -> dict[str, int]:
    """How the wrapper ``counter`` launches its kernel, and what the card
    makes of it: threads per CTA, dynamic shared memory in bytes, registers
    per thread, and the CTAs one SM holds. ``a, b, c`` select the launch:
    (log2 n, rows per CTA, staged) for the transform kernels, where c = 2
    or 3 selects the two-pass schedule's pass 1 or pass 2 kernel of
    ``fft_planes``, ``rfft_planes``, ``irfft_planes`` and ``ntt_batched``,
    and c = 2, 3 or 4 the split-pass schedule's F1, M or I2 of the
    products (``rns_ntt_polymul`` too), with a = log2 of its sub-problem
    length and b = the sub-problems per CTA (for the rfft's pass 2 and the
    products' M, the low ones: the CTA holds their mirrors, b's, or both
    rows' too); c = 5 the register-step kernel of ``rns_ntt_polymul`` (a
    = log2 n, b unused); (head_dim, bf16, 0) for the three attention
    kernels."""
    stem, kernel = _KERNEL_IDS[counter]
    out = [_I() for _ in range(4)]
    err = getattr(load(stem), f"{stem}_occupancy")(
        kernel, a, b, int(c), *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"{stem}_occupancy({counter}): CUDA error {err} "
                           f"({_error(stem, err)})")
    keys = ("threads", "smem_bytes", "regs", "ctas_per_sm")
    return {k: v.value for k, v in zip(keys, out)}
