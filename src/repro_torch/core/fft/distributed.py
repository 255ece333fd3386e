"""Distributed four-step (Bailey) FFT over a mesh axis (port of
``repro.core.fft.distributed``).

FourierPIM §7 leaves "multi-crossbar FFT" as future work: a transform whose
sequence exceeds one array. This module is that extension over the port's
mesh (``dist/sharding.py``): the sequence dimension is sharded across the
``model`` axis, one block a shard, and the transform is computed as

  n = n1 * n2,  x viewed as M[j1, j2] (row-major, j = j1*n2 + j2)
  1. all-to-all transpose so each shard owns all j1 for a j2 slice
  2. local FFT_{n1} along j1                        -> Y[k1, j2]
  3. twiddle multiply by omega_n^{j2 k1}            (local)
  4. all-to-all transpose so each shard owns all j2 for a k1 slice
  5. local FFT_{n2} along j2                        -> Z[k1, k2]
  X[k1 + k2*n1] = Z[k1, k2]

with n1 = D. With ``ordered=False`` the result stays in Z-order
(k1-sharded): for convolution the pointwise product is order-agnostic as
long as both operands share the order, and the inverse transform undoes
it, saving one all-to-all per transform in each direction (the paper's
cancellation of the FFT/IFFT input permutations across DFT.IDFT, §5,
lifted to the collective level).

Every function here that ends in ``_distributed`` is a per-shard body: it
takes the list of a value's blocks, one a shard in shard order, and the
shards' axis indices (what the reference's body reads from
``jax.lax.axis_index``), and returns the list of the result's blocks. The
``make_sharded_*`` builders wrap them with ``dist.sharding.shard_map``:
(B, n) tensors in and out. Each local transform is one call of
``kernels.ops.fft`` (so of ``fft_planes``, the fft kernel on the card) on
that shard's rows, at the plan's radix; the rows of step 2 come from a
transpose, so ``ops.fft`` copies them into a contiguous block first.

Step-3 twiddles are built from integer exponents reduced mod n (exact at
any n) with the angles evaluated in float64 host-side and rounded ONCE to
complex64, as the reference's are (its tests pin the fp32 regression this
avoids).

Real-Hermitian tier (the serving tier for real coefficients): the packed
transform Z = FFT(a + i b) runs four-step in Z-order and the Eq.-(10)
Hermitian split happens PER SHARD, before any ordering collective. The
conjugate bin n-k of a Z-order bin k = idx + D*k2 lives at k1' = (D - idx)
mod D, a single known peer, so one ppermute to the mirror shard routes
every conjugate partner, and only the packed half-spectrum crosses in the
ordering all-to-all. ``four_step_collective_stats`` is the byte-ledger
closed form; the real tier's total traffic is 3.5/6 ~ 0.58x the complex
path's.

All collectives go through ``dist.collectives``, so the moved bytes land
in its ledger in the reference's unit.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.dist import batching, collectives, sharding
from repro_torch.kernels import ops as kops

Blocks = Sequence[torch.Tensor]


def _local_fft(x: torch.Tensor, *, inverse: bool, radix: int
               ) -> torch.Tensor:
    return kops.fft(x, inverse=inverse, radix=radix)


def check_four_step_shape(n: int, n_devices: int, *,
                          real: bool = False) -> None:
    """Validate that the four-step decomposition is well formed for (n, D).

    The transposes split the local j2/k2 axis into D tiles and the step-3
    twiddle block is (D, n2/D) wide, so D^2 must divide n (2*D^2 for the
    real tier, whose ordering all-to-all moves n/(2D)-wide half-spectrum
    tiles). Rejecting a non-dividing shape here keeps the failure loud and
    attributable.
    """
    D = n_devices
    if D < 1:
        raise ValueError(f"n_devices={D} must be >= 1")
    need = 2 * D * D if real else D * D
    if n % need or n < need:
        tier = "real four-step" if real else "four-step"
        raise ValueError(
            f"{tier} FFT needs {'2*' if real else ''}D^2 | n so every "
            f"all-to-all tile and twiddle slice is whole: got n={n}, "
            f"D={D} (n % {need} = {n % need})")


@functools.lru_cache(maxsize=64)
def _twiddle_tables(n: int, n1: int, width: int, inverse: bool
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side step-3 twiddle tables, exact-integer exponents, fp64 angles.

    ``local[k1, j2] = w_n^{+-k1*j2}`` for the local j2 slice (j2 < width)
    and ``offset[m] = w_n^{+-m*width}`` for m = k1*idx < n1^2: the global
    j2 offset of shard idx enters as ``local * offset[k1*idx]``, so every
    factor is exp of an exponent reduced mod n in int64 (never a float
    product) evaluated in float64 and rounded once to complex64.
    """
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    j2 = np.arange(width, dtype=np.int64)[None, :]
    local = np.exp(sign * 2j * np.pi * ((k1 * j2) % n) / n)
    m = np.arange(n1 * n1, dtype=np.int64)
    offset = np.exp(sign * 2j * np.pi * ((m * width) % n) / n)
    return local.astype(np.complex64), offset.astype(np.complex64)


@functools.lru_cache(maxsize=128)
def _twiddle(n: int, n1: int, width: int, idx: int, inverse: bool,
             device: torch.device) -> torch.Tensor:
    """w_n^{+-k1*j2} for shard ``idx``'s global j2 slice; shape
    (n1, width), complex64 on ``device``: the two tables' complex64
    product, as the reference forms it."""
    local, offset = _twiddle_tables(n, n1, width, inverse)
    phase = torch.from_numpy(offset[np.arange(n1) * idx])
    return (torch.from_numpy(local) * phase[:, None]).to(device)


def fft_distributed(xs: Blocks, *, n_devices: int, idx: Sequence[int],
                    inverse: bool = False, ordered: bool = True,
                    radix: int = 2, _in_zorder: bool = False
                    ) -> list[torch.Tensor]:
    """FFT of (..., n) with the last axis sharded: ``xs`` holds each shard's
    (..., n / D) block. n1 = D, so each shard holds exactly one j1 row and
    each all-to-all moves one tile per peer."""
    D = n_devices
    *lead, n_loc = xs[0].shape
    n = n_loc * D
    check_four_step_shape(n, D)
    n1, n2 = D, n_loc
    la = len(lead)
    xs = [x.to(torch.complex64) for x in xs]

    def twiddled(ys, inv):
        return [y * _twiddle(n, n1, n2 // D, i, inv, y.device)
                for y, i in zip(ys, idx)]

    def along_j1(ys, inv):
        return [_local_fft(y.swapaxes(-1, -2), inverse=inv,
                           radix=radix).swapaxes(-1, -2) for y in ys]

    if not inverse:
        # Each shard holds one j1 row of M: (..., 1, n2).
        m = [x.reshape(*lead, 1, n2) for x in xs]
        # Step 1: transpose -> each shard owns all j1 for a j2 slice.
        m = collectives.all_to_all(m, split_axis=la + 1, concat_axis=la)
        # (..., n1, n2/D): FFT over j1, then the step-3 twiddle of the
        # shard's global j2 slice.
        y = twiddled(along_j1(m, False), inverse)
        # Step 4: transpose -> each shard owns all j2 for a k1 row.
        y = collectives.all_to_all(y, split_axis=la, concat_axis=la + 1)
        z = [_local_fft(t.reshape(*lead, n2), inverse=False, radix=radix)
             for t in y]
        if not ordered:
            return z                    # Z-order: k1-sharded, k2 local
        # Z[k1, k2] -> natural order X[k1 + k2 n1], outer digit k2
        # sharded: transpose once more.
        z = collectives.all_to_all([t.reshape(*lead, 1, n2) for t in z],
                                   split_axis=la + 1, concat_axis=la)
        return [t.swapaxes(-1, -2).reshape(*lead, n_loc) for t in z]
    # Inverse of the above; input in Z-order if _in_zorder else natural.
    if not _in_zorder:
        # natural X sharded by outer k2 chunk: (..., n2/D, n1) view
        z = [x.reshape(*lead, n2 // D, n1).swapaxes(-1, -2) for x in xs]
        z = collectives.all_to_all(z, split_axis=la, concat_axis=la + 1)
        z = [t.reshape(*lead, n2) for t in z]      # one k1 row, all k2
    else:
        z = xs
    # Undo step 5: inverse local FFT over k2.
    y = [_local_fft(t, inverse=True, radix=radix).reshape(*lead, 1, n2)
         for t in z]
    # Undo step 4, the twiddle (conjugate), and step 2 (over k1).
    y = collectives.all_to_all(y, split_axis=la + 1, concat_axis=la)
    m = along_j1(twiddled(y, True), True)
    # Undo step 1's transpose.
    m = collectives.all_to_all(m, split_axis=la, concat_axis=la + 1)
    return [t.reshape(*lead, n_loc) for t in m]


# ---------------------------------------------------------------------------
# Real-Hermitian tier: per-shard split, half-width collectives.
# ---------------------------------------------------------------------------

def _mirror_perm(n_devices: int) -> tuple[tuple[int, int], ...]:
    """The conjugate-bin route: Z-order bin k = idx + D*k2 has its mirror
    n-k at k1' = (D - idx) mod D, so every shard's partner block lives on
    one peer (shards 0 and D/2 are their own mirror)."""
    return tuple((i, (n_devices - i) % n_devices) for i in range(n_devices))


def _split_even_odd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return x[..., 0::2, :], x[..., 1::2, :]


def _interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    *lead, half, w = a.shape
    return torch.stack([a, b], dim=-2).reshape(*lead, 2 * half, w)


def _require_row_pairs(b: int, what: str) -> None:
    if b % 2:
        raise ValueError(
            f"{what} pairs rows two-for-one (z = row[2j] + i row[2j+1]); "
            f"the local batch must be even, got {b}")


def _pack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def _zhalf_to_natural(ps: Blocks, D: int) -> list[torch.Tensor]:
    """Z-half layout (shard idx owns packed bins idx + D*k2) -> natural
    contiguous chunks, via one half-width all-to-all + local transpose."""
    *lead, w = ps[0].shape
    la = len(lead)
    ps = collectives.all_to_all([p.reshape(*lead, 1, w) for p in ps],
                                split_axis=la + 1, concat_axis=la)
    return [p.swapaxes(-1, -2).reshape(*lead, w) for p in ps]


def _natural_to_zhalf(ps: Blocks, D: int) -> list[torch.Tensor]:
    *lead, w = ps[0].shape
    la = len(lead)
    ps = [p.reshape(*lead, w // D, D).swapaxes(-1, -2) for p in ps]
    ps = collectives.all_to_all(ps, split_axis=la, concat_axis=la + 1)
    return [p.reshape(*lead, w) for p in ps]


def rfft_distributed(xs: Blocks, *, n_devices: int, idx: Sequence[int],
                     ordered: bool = True, radix: int = 2
                     ) -> list[torch.Tensor]:
    """Packed half-spectrum FFT of real rows, sequence-sharded.

    Each block of ``xs`` is a shard's real (..., B, n/D) rows with B even:
    rows pair two-for-one (Z = FFT(row[2j] + i row[2j+1])) through the
    Z-order four-step transform, then the Hermitian split (Eq. (10)) runs
    per shard (the conjugate bin comes from the mirror peer via one
    HALF-width ppermute) and each shard's result is the packed-Nyquist
    half-spectrum (kernels/fft.py layout: bin 0 carries DC.re +
    i*Nyquist.re), (..., B, n/(2D)) complex64.

    ``ordered=True`` finishes with the ordering all-to-all at HALF the
    complex width (shard d owns packed bins [d*n/(2D), (d+1)*n/(2D)));
    ``ordered=False`` leaves the Z-half layout (bin k on shard k mod D).
    """
    D = n_devices
    *lead, B, n_loc = xs[0].shape
    # real=ordered: the half-width ordering all-to-all (2*D^2 | n) only
    # runs for ordered output; the Z-half layout needs just D^2 | n.
    check_four_step_shape(n_loc * D, D, real=ordered)
    _require_row_pairs(B, "rfft_distributed")
    nh = n_loc // 2
    z = [_pack(*_split_even_odd(x)) for x in xs]
    zz = fft_distributed(z, n_devices=D, idx=idx, ordered=False,
                         radix=radix)                 # Z-order (.., B/2, n/D)
    zd = [t[..., :nh] for t in zz]
    zu = [t[..., nh:] for t in zz]
    # Mirror route: Z_{n-k} for my kept (lower-half) bins lives in the
    # UPPER half of the mirror peer's block: half the block crosses.
    mu = collectives.ppermute(zu, _mirror_perm(D))
    out = []
    for i, d, u, m in zip(idx, zd, zu, mu):
        flip = torch.flip(m, dims=[-1])
        # Shard 0 wraps: its bin 0 is self-conjugate and its other mirrors
        # sit one slot off the pure reversal (k2' = n2 - k2).
        zm = torch.cat([d[..., :1], flip[..., :-1]], dim=-1) if i == 0 \
            else flip
        a = 0.5 * (d + torch.conj(zm))
        b = -0.5j * (d - torch.conj(zm))
        if i == 0:
            # Packed-Nyquist bin 0: X[0] and X[n/2] are both real and both
            # live here (k2 = 0 and k2 = n2/2 of the idx = 0 block).
            a0 = _pack(d[..., :1].real, u[..., :1].real)
            b0 = _pack(d[..., :1].imag, u[..., :1].imag)
            a = torch.cat([a0, a[..., 1:]], dim=-1)
            b = torch.cat([b0, b[..., 1:]], dim=-1)
        out.append(_interleave_rows(a, b))            # (..., B, n/(2D))
    return _zhalf_to_natural(out, D) if ordered else out


def irfft_distributed(ps: Blocks, *, n_devices: int, idx: Sequence[int],
                      ordered: bool = True, radix: int = 2
                      ) -> list[torch.Tensor]:
    """Inverse of ``rfft_distributed``: packed half-spectra (..., B, n/(2D))
    -> real rows (..., B, n/D), a block a shard.

    The full Z-order spectrum is re-mirrored per shard before the inverse
    four-step: the upper-half bins are conj(V_{n-k}) with V = A - iB, so
    ONE half-width ppermute of V routes every mirror and two spectra ride
    one inverse complex transform (Z = A + iB). ``ordered`` describes the
    INPUT layout (natural vs Z-half), matching the forward's output.
    """
    D = n_devices
    *lead, B, w = ps[0].shape
    n_loc = 2 * w
    check_four_step_shape(n_loc * D, D, real=ordered)
    _require_row_pairs(B, "irfft_distributed")
    ps = [p.to(torch.complex64) for p in ps]
    if ordered:
        ps = _natural_to_zhalf(ps, D)
    zds, vs, nyqs = [], [], []
    for i, p in zip(idx, ps):
        pa, pb = _split_even_odd(p)
        if i == 0:
            # Unpack shard 0's packed-Nyquist bin 0: A[0] = re, A[n/2] = im.
            nyqs.append(_pack(pa[..., :1].imag, pb[..., :1].imag))
            zero = torch.zeros_like(pa[..., :1].real)
            pa = torch.cat([_pack(pa[..., :1].real, zero), pa[..., 1:]],
                           dim=-1)
            pb = torch.cat([_pack(pb[..., :1].real, zero), pb[..., 1:]],
                           dim=-1)
        else:
            nyqs.append(None)
        zds.append(pa + 1j * pb)    # Z = A + iB at the kept (lower) bins
        vs.append(pa - 1j * pb)     # mirror carrier: Z_upper = conj(V_{n-k})
    vm = collectives.ppermute(vs, _mirror_perm(D))
    z = []
    for zd, m, nyq in zip(zds, vm, nyqs):
        flip = torch.conj(torch.flip(m, dims=[-1]))
        zu = flip if nyq is None else torch.cat([nyq, flip[..., :-1]],
                                                dim=-1)
        z.append(torch.cat([zd, zu], dim=-1))         # Z-order full block
    out = fft_distributed(z, n_devices=D, idx=idx, inverse=True,
                          _in_zorder=True, radix=radix)
    return [_interleave_rows(t.real, t.imag).to(torch.float32) for t in out]


def polymul_real_distributed(as_: Blocks, bs: Blocks, *, n_devices: int,
                             idx: Sequence[int], radix: int = 2
                             ) -> list[torch.Tensor]:
    """Circular product of REAL coefficient rows, sequence-sharded, with
    the paired inverse kept at the collective level.

    Per product, z = a + i b rides ONE Z-order forward transform; the
    product spectrum P = A*B = (Z^2 - conj(Z^2_{n-k})) / 4i needs only the
    mirror of Z^2, and for a PAIR of products the two mirrors travel as one
    block (W = Z0^2 - i Z1^2, so Q = P0 + i P1 = (S - conj(W_{n-k})) / 4i
    with S = Z0^2 + i Z1^2): one ppermute per pair. The shared inverse
    consumes Q in Z-order and lands both real results in natural order:
    1.5 transform-equivalents + half a permute per product, 3.5/6 ~ 0.58x
    the complex path's collective bytes (four_step_collective_stats).
    """
    D = n_devices
    if as_[0].shape != bs[0].shape:
        raise ValueError(f"operand shapes differ: {tuple(as_[0].shape)} vs "
                         f"{tuple(bs[0].shape)}")
    *lead, B, n_loc = as_[0].shape
    check_four_step_shape(n_loc * D, D)
    _require_row_pairs(B, "polymul_real_distributed")
    z = [_pack(a, b) for a, b in zip(as_, bs)]
    zz = fft_distributed(z, n_devices=D, idx=idx, ordered=False,
                         radix=radix)
    ss, ws = [], []
    for t in zz:
        e, o = _split_even_odd(t * t)
        ss.append(e + 1j * o)
        ws.append(e - 1j * o)
    wm = collectives.ppermute(ws, _mirror_perm(D))
    q = []
    for i, s, m in zip(idx, ss, wm):
        flip = torch.flip(m, dims=[-1])
        # Full-block mirror: shard 0's reversal wraps (bin 0 is its own
        # mirror), everyone else's is the pure flip of the peer block.
        wr = torch.cat([flip[..., -1:], flip[..., :-1]], dim=-1) if i == 0 \
            else flip
        q.append(-0.25j * (s - torch.conj(wr)))
    c = fft_distributed(q, n_devices=D, idx=idx, inverse=True,
                        _in_zorder=True, radix=radix)
    return [_interleave_rows(t.real, t.imag).to(torch.float32) for t in c]


# ---------------------------------------------------------------------------
# Builders over a mesh
# ---------------------------------------------------------------------------

def _checked_shard_map(fn: Callable, mesh: sharding.Mesh, *,
                       axis_name: str, n_from: Callable, real: bool = False,
                       pad_pairs: bool = False) -> Callable:
    """``shard_map`` ``fn`` over ``axis_name`` and wrap it with the global
    shape guard: the one place the call-time ``check_four_step_shape``
    lives for every make_sharded_* builder. ``n_from`` maps the first
    argument to the GLOBAL transform length.

    ``pad_pairs=True`` (the row-pairing real tiers) accepts ODD batches:
    the tail row gets a zeros partner appended before the split and the
    extra row is sliced off the result. The Eq.-(10) split/pair algebra is
    linear, so pairing a real row with zeros recovers that row's spectrum /
    product exactly: the pad changes no served value.
    """
    D = mesh.shape[axis_name]
    mapped = sharding.shard_map(fn, mesh, axis_name=axis_name)

    def wrapped(*args: torch.Tensor) -> torch.Tensor:
        check_four_step_shape(n_from(args[0]), D, real=real)
        if pad_pairs and args[0].ndim >= 2 and args[0].shape[-2] % 2:
            b = args[0].shape[-2]
            args = tuple(torch.nn.functional.pad(a, (0, 0, 0, 1))
                         for a in args)
            return mapped(*args)[..., :b, :]
        return mapped(*args)
    return wrapped


def make_sharded_fft(mesh: sharding.Mesh, *, axis_name: str = "model",
                     inverse: bool = False, ordered: bool = True,
                     radix: int = 2) -> Callable:
    """A distributed FFT over ``mesh``: (B, n) -> (B, n), the transform
    dimension sharded over ``axis_name`` (the batch is not sharded).
    Raises ValueError at call time when D^2 does not divide the global n
    (see ``check_four_step_shape``)."""
    fn = functools.partial(fft_distributed, n_devices=mesh.shape[axis_name],
                           inverse=inverse, ordered=ordered, radix=radix)
    return _checked_shard_map(fn, mesh, axis_name=axis_name,
                              n_from=lambda x: x.shape[-1])


def make_sharded_polymul(mesh: sharding.Mesh, *, axis_name: str = "model",
                         radix: int = 2) -> Callable:
    """Distributed circular product: both transforms stay in Z-order, the
    pointwise product is local, and the final inverse restores natural
    order. Saves 2 all-to-alls per call vs. composing ordered transforms."""
    D = mesh.shape[axis_name]

    def local_fn(as_, bs, *, idx):
        fa = fft_distributed(as_, n_devices=D, idx=idx, ordered=False,
                             radix=radix)
        fb = fft_distributed(bs, n_devices=D, idx=idx, ordered=False,
                             radix=radix)
        return fft_distributed([a * b for a, b in zip(fa, fb)],
                               n_devices=D, idx=idx, inverse=True,
                               _in_zorder=True, radix=radix)

    return _checked_shard_map(local_fn, mesh, axis_name=axis_name,
                              n_from=lambda a: a.shape[-1])


def make_sharded_rfft(mesh: sharding.Mesh, *, axis_name: str = "model",
                      ordered: bool = True, radix: int = 2) -> Callable:
    """Distributed rfft: real (B, n) -> packed complex (B, n/2). Rows pair
    two-for-one; an ODD batch is padded with a zeros partner internally
    and sliced off the result (``pad_pairs``), so any B >= 1 serves."""
    fn = functools.partial(rfft_distributed,
                           n_devices=mesh.shape[axis_name], ordered=ordered,
                           radix=radix)
    return _checked_shard_map(fn, mesh, axis_name=axis_name,
                              n_from=lambda x: x.shape[-1], real=ordered,
                              pad_pairs=True)


def make_sharded_irfft(mesh: sharding.Mesh, *, axis_name: str = "model",
                       ordered: bool = True, radix: int = 2) -> Callable:
    """Inverse: packed complex (B, n/2) -> real (B, n); odd batches pad a
    zeros half-spectrum internally (see ``pad_pairs``)."""
    fn = functools.partial(irfft_distributed,
                           n_devices=mesh.shape[axis_name], ordered=ordered,
                           radix=radix)
    return _checked_shard_map(fn, mesh, axis_name=axis_name,
                              n_from=lambda p: 2 * p.shape[-1], real=ordered,
                              pad_pairs=True)


def make_sharded_polymul_real(mesh: sharding.Mesh, *,
                              axis_name: str = "model",
                              radix: int = 2) -> Callable:
    """Distributed real circular product with the collective-level paired
    inverse (see ``polymul_real_distributed``). ODD batches are accepted:
    the tail product pairs with a zeros product internally and the pad row
    is sliced off the result (``pad_pairs``)."""
    fn = functools.partial(polymul_real_distributed,
                           n_devices=mesh.shape[axis_name], radix=radix)
    return _checked_shard_map(fn, mesh, axis_name=axis_name,
                              n_from=lambda a: a.shape[-1], pad_pairs=True)


# ---------------------------------------------------------------------------
# Collective-traffic closed forms (ledger units)
# ---------------------------------------------------------------------------

def four_step_collective_stats(n: int, batch: int, n_devices: int, *,
                               op: str = "fft", ordered: bool = True,
                               itemsize: int = 8) -> dict:
    """Closed-form collective traffic of one call, in the byte ledger's
    unit (local-block bytes per collective, complex64 items). Pinned
    against the live ``dist.collectives`` ledger in the port's tests and
    on the card by ``chip_smoke.py``.

    ``batch`` counts REAL rows for rfft/irfft (pairs ride one transform)
    and products for polymul ops. The real tier's total is 3.5 block-units
    against the complex path's 6 per product (0.583x).
    """
    blk = batch * (n // n_devices) * itemsize          # one full-width call
    if op in ("fft", "ifft"):
        a2a, a2a_bytes, pp, pp_bytes = (3 if ordered else 2), 0, 0, 0
        a2a_bytes = a2a * blk
    elif op == "polymul":
        a2a, a2a_bytes, pp, pp_bytes = 6, 6 * blk, 0, 0
    elif op in ("rfft", "irfft"):
        if batch % 2:
            raise ValueError(f"{op} batch must be even, got {batch}")
        half = blk // 2                                # the packed pair block
        # forward/inverse four-step on B/2 packed rows: 2 calls of `half`;
        # the (un)ordering all-to-all moves B packed half-spectra = `half`.
        a2a = 3 if ordered else 2
        a2a_bytes = a2a * half
        pp, pp_bytes = 1, half // 2                    # half-width mirror
    elif op == "polymul_real":
        if batch % 2:
            raise ValueError(f"polymul_real batch must be even, got {batch}")
        # 2 forward calls at full batch + 2 inverse calls at half batch.
        a2a, a2a_bytes = 4, 2 * blk + 2 * (blk // 2)
        pp, pp_bytes = 1, blk // 2                     # one W block per pair
    else:
        raise ValueError(f"unknown op {op!r}")
    return {"a2a_count": a2a, "a2a_bytes": a2a_bytes,
            "ppermute_count": pp, "ppermute_bytes": pp_bytes,
            "total_bytes": a2a_bytes + pp_bytes}


def batch_plan(mesh, batch: int, *,
               batch_axes: Sequence[str] = ("pod", "data"),
               transforms_per_device: int = 1) -> batching.CrossbarBatchPlan:
    """Map B transforms onto the mesh's batch axes (paper-§6 batching lifted
    to the pod level): per-device share, wave count, and the utilization the
    tail wave / mesh padding costs. ``transforms_per_device`` is how many
    transforms one device runs concurrently. ``mesh`` needs only a
    ``shape`` mapping."""
    return batching.plan_crossbar_batch(
        batch, num_arrays=transforms_per_device, mesh=mesh,
        axes=tuple(batch_axes))
