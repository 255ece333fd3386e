"""Distributed four-step NTT over a mesh axis, exact (port of
``repro.core.ntt.distributed``).

The modular counterpart of ``core.fft.distributed``: the transform length is
sharded n = n1·n2 over a mesh axis (default ``data``: the exact tier's
sequence dimension rides the data axis, leaving ``model`` for the float
stack), with n1 = D shards:

  x viewed as M[j1, j2] (row-major, j = j1·n2 + j2), k = k1 + k2·n1
  1. all-to-all transpose: each shard owns all j1 for a j2 slice
  2. local NTT_{n1} along j1 (root w^{n2}: ``NTTParams.subparams(n1)``;
     q ≡ 1 mod 2n covers every sub-length)
  3. twiddle multiply by w^{j2·k1} (local, Montgomery form)
  4. all-to-all transpose: each shard owns all j2 for a k1 row
  5. local NTT_{n2} along j2 (``subparams(n2)``)
  X[k1 + k2·n1] = Z[k1, k2]; one more transpose restores natural order.

``ordered=False`` leaves the result in Z-order (shard idx holds X[idx::n1]):
for polymul the pointwise product is order-agnostic and the inverse
transform consumes Z-order directly, saving 2 all-to-alls per transform,
the same cancellation as the float path.

Each local transform is one call of ``kernels.ntt.ntt_batched`` (the NTT
kernel on the card) on the shard's rows; the rows of step 2 come from a
transpose and are copied contiguous first. The step-3 twiddle, the twist,
the pointwise product and the untwist are ``kernels.ntt.mont_mul`` on int64
tensors, as the reference runs them in jnp outside its kernel. Every value
is a canonical residue in [0, q), so distributed == local is exact ``==``.

``ntt_batched``'s inverse scales by its length's inverse, where the
reference's inverse stages are unscaled: the two inverse passes scale by
n2^-1 and n1^-1. The inverse step-3 twiddle table carries a factor n
(``_inverse_step3``), so the inverse transform's output is the reference's
unscaled one, and ``scale``, the untwist and the cyclic scale stay the
reference's tables (``_edge_table``).

Every all-to-all goes through ``dist.collectives.all_to_all``, so the
traffic lands in the byte ledger; ``four_step_collective_stats`` is the
closed form.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.ntt.ref import NTTParams
from repro_torch.dist import collectives, sharding
from repro_torch.kernels import ntt as kntt

__all__ = [
    "four_step_collective_stats", "make_sharded_ntt",
    "make_sharded_ntt_polymul", "ntt_distributed",
]

Blocks = Sequence[torch.Tensor]


def _mont_u32(params: NTTParams, values: np.ndarray) -> np.ndarray:
    return params.to_montgomery(values).astype(np.uint32)


def _local_ntt(x: torch.Tensor, sub: NTTParams, *,
               inverse: bool) -> torch.Tensor:
    """Last-axis transform of (..., m) residues with the sub-length roots:
    one ``ntt_batched`` call (scaled by m^-1 on the inverse)."""
    shp = x.shape
    y = kntt.ntt_batched(x.reshape(-1, shp[-1]), sub, inverse=inverse)
    return y.reshape(shp)


def _local_ntt_axis2(x: torch.Tensor, sub: NTTParams, *,
                     inverse: bool) -> torch.Tensor:
    """Same, along axis -2 (the j1/k1 axis of the (n1, n2/D) block)."""
    return _local_ntt(x.swapaxes(-1, -2), sub,
                      inverse=inverse).swapaxes(-1, -2)


@functools.lru_cache(maxsize=32)
def _step3_twiddle(params: NTTParams, n1: int, inverse: bool) -> np.ndarray:
    """Full (n1, n2) Montgomery table of w^{±j2·k1}; each shard slices its
    j2 columns."""
    n, n2 = params.n, params.n // n1
    pw = params.powers(params.w_inv if inverse else params.w)
    idx = np.outer(np.arange(n1), np.arange(n2)) % n
    return _mont_u32(params, pw[idx])


@functools.lru_cache(maxsize=32)
def _inverse_step3(params: NTTParams, n1: int) -> np.ndarray:
    """The inverse step-3 table times n, in Montgomery form: the factor
    the two scaled inverse sub-transforms (n2^-1, then n1^-1) take out."""
    n, n2 = params.n, params.n // n1
    pw = params.powers(params.w_inv)
    idx = np.outer(np.arange(n1), np.arange(n2)) % n
    return _mont_u32(params, pw[idx] * np.uint64(n) % np.uint64(params.q))


@functools.lru_cache(maxsize=32)
def _edge_table(params: NTTParams, kind: str) -> np.ndarray:
    """(1, n) Montgomery tables sliced by shard for twist/untwist/scale:
    ``twist``  -- psi^j (negacyclic input twist),
    ``untwist`` -- psi^{-j} · n^{-1} (negacyclic output untwist + scale),
    ``scale``  -- n^{-1} broadcast (cyclic inverse scale).
    untwist/scale values come from ``kernels.ntt.untwist_table``, the one
    definition the local kernel and RNS limb tables also use."""
    if kind == "twist":
        vals = params.powers(params.psi)
    elif kind in ("untwist", "scale"):
        vals = kntt.untwist_table(params, negacyclic=(kind == "untwist"))
    else:
        raise ValueError(kind)
    return _mont_u32(params, vals)[None, :]


@functools.lru_cache(maxsize=64)
def _device_table(table: str, params: NTTParams, arg, device: torch.device
                  ) -> torch.Tensor:
    """A host table as an int64 tensor on ``device``."""
    host = {"step3": lambda: _step3_twiddle(params, arg, False),
            "istep3": lambda: _inverse_step3(params, arg),
            "edge": lambda: _edge_table(params, arg)}[table]()
    return torch.from_numpy(host.astype(np.int64)).to(device)


def _mont(x: torch.Tensor, m: torch.Tensor | int, params: NTTParams
          ) -> torch.Tensor:
    """x · m · 2^-32 mod q on int32 residues (int64 inside), int32 out."""
    return kntt.mont_mul(x.to(torch.int64), m, params.q,
                         params.qinv).to(torch.int32)


def _residues(x: torch.Tensor, q: int) -> torch.Tensor:
    """Integer coefficients -> int32 residues in [0, q), the reference's
    contract (uint32 words reduce mod q, negatives wrap)."""
    return kntt._load(kntt._as_residues(x, q), q).to(torch.int32)


def ntt_distributed(xs: Blocks, params: NTTParams, *, n_devices: int,
                    idx: Sequence[int], inverse: bool = False,
                    ordered: bool = True, scale: bool = True,
                    _in_zorder: bool = False) -> list[torch.Tensor]:
    """Exact NTT of (..., n) residues with the last axis sharded: ``xs``
    holds each shard's (..., n/D) int32 residue block. ``scale=False`` on
    the inverse skips the n^{-1} multiply so a caller can fold it into its
    own output pass."""
    D = n_devices
    *lead, n_loc = xs[0].shape
    n = n_loc * D
    if n != params.n:
        raise ValueError(f"n={n} != params.n={params.n}")
    n1, n2 = D, n_loc
    w = n2 // D
    p1 = params.subparams(n1)
    p2 = params.subparams(n2)
    la = len(lead)

    def twiddled(ys, table):
        return [_mont(y, _device_table(table, params, n1, y.device)
                      [:, i * w:(i + 1) * w], params)
                for y, i in zip(ys, idx)]

    if not inverse:
        # Shard idx holds row j1 = idx of M: (..., 1, n2).
        m = [x.reshape(*lead, 1, n2) for x in xs]
        # Step 1: transpose -> all j1 for a j2 slice: (..., n1, n2/D).
        m = collectives.all_to_all(m, split_axis=la + 1, concat_axis=la)
        y = twiddled([_local_ntt_axis2(t, p1, inverse=False) for t in m],
                     "step3")
        # Step 4: transpose -> all j2 for k1 row idx: (..., 1, n2).
        y = collectives.all_to_all(y, split_axis=la, concat_axis=la + 1)
        z = [_local_ntt(t.reshape(*lead, n2), p2, inverse=False)
             for t in y]
        if not ordered:
            return z                     # Z-order: shard idx = X[idx::n1]
        # Natural order: shard d gets X[d*n_loc:(d+1)*n_loc].
        z = collectives.all_to_all([t.reshape(*lead, 1, n2) for t in z],
                                   split_axis=la + 1, concat_axis=la)
        return [t.swapaxes(-1, -2).reshape(*lead, n_loc) for t in z]

    # Inverse: the same pipeline with inverse roots.
    if not _in_zorder:
        # Natural chunk -> Z-order row: (..., n2/D, n1) view, transpose away.
        z = [x.reshape(*lead, n2 // D, n1).swapaxes(-1, -2) for x in xs]
        z = collectives.all_to_all(z, split_axis=la, concat_axis=la + 1)
        z = [t.reshape(*lead, n2) for t in z]       # Z[k1=idx, all k2]
    else:
        z = xs
    y = [_local_ntt(t, p2, inverse=True).reshape(*lead, 1, n2) for t in z]
    y = collectives.all_to_all(y, split_axis=la + 1, concat_axis=la)
    m = [_local_ntt_axis2(t, p1, inverse=True)
         for t in twiddled(y, "istep3")]
    m = collectives.all_to_all(m, split_axis=la, concat_axis=la + 1)
    out = [t.reshape(*lead, n_loc) for t in m]   # x[j1=idx, all j2]
    if scale:
        n_inv_mont = params.n_inv * (1 << 32) % params.q
        out = [_mont(t, n_inv_mont, params) for t in out]
    return out


def _edge_slices(params: NTTParams, kind: str, xs: Blocks,
                 idx: Sequence[int]) -> list[torch.Tensor]:
    n_loc = xs[0].shape[-1]
    return [_device_table("edge", params, kind, x.device)
            [0, i * n_loc:(i + 1) * n_loc] for x, i in zip(xs, idx)]


def make_sharded_ntt(mesh: sharding.Mesh, params: NTTParams, *,
                     axis_name: str = "data", inverse: bool = False,
                     ordered: bool = True) -> Callable:
    """Distributed NTT over ``mesh``: (B, n) residues -> (B, n) int32
    residues, the sequence axis sharded over ``axis_name``. The returned
    callable re-asserts that placement through ``dist.sharding.constrain``
    (a no-op outside a mesh context) before splitting."""
    mapped = sharding.shard_map(
        functools.partial(ntt_distributed, params=params,
                          n_devices=mesh.shape[axis_name], inverse=inverse,
                          ordered=ordered), mesh, axis_name=axis_name)

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        x = sharding.constrain(x, *((None,) * (x.ndim - 1)), axis_name)
        return mapped(_residues(x, params.q))
    return wrapped


def make_sharded_ntt_polymul(mesh: sharding.Mesh, params: NTTParams, *,
                             negacyclic: bool = True,
                             axis_name: str = "data") -> Callable:
    """Distributed exact product mod (x^n ± 1, q): both forward transforms
    stay in Z-order, the pointwise modmul is local, the inverse consumes
    Z-order, and the psi^{-j}·n^{-1} untwist rides the output multiply:
    6 all-to-alls instead of 9 (same cancellation as the float path)."""
    D = mesh.shape[axis_name]

    def local_fn(as_, bs, *, idx):
        if negacyclic:
            tw = _edge_slices(params, "twist", as_, idx)
            as_ = [_mont(a, t, params) for a, t in zip(as_, tw)]
            bs = [_mont(b, t, params) for b, t in zip(bs, tw)]
        fa = ntt_distributed(as_, params, n_devices=D, idx=idx,
                             ordered=False)
        fb = ntt_distributed(bs, params, n_devices=D, idx=idx,
                             ordered=False)
        prod = [_mont(_mont(a, params.r2, params), b, params)
                for a, b in zip(fa, fb)]
        c = ntt_distributed(prod, params, n_devices=D, idx=idx,
                            inverse=True, _in_zorder=True, scale=False)
        un = _edge_slices(params, "untwist" if negacyclic else "scale", c,
                          idx)
        return [_mont(t, u, params) for t, u in zip(c, un)]

    mapped = sharding.shard_map(local_fn, mesh, axis_name=axis_name)

    def wrapped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a = sharding.constrain(a, *((None,) * (a.ndim - 1)), axis_name)
        b = sharding.constrain(b, *((None,) * (b.ndim - 1)), axis_name)
        return mapped(_residues(a, params.q), _residues(b, params.q))
    return wrapped


def four_step_collective_stats(n: int, batch: int, n_devices: int, *,
                               op: str = "ntt", ordered: bool = True,
                               itemsize: int = 4) -> dict:
    """Closed-form all-to-all traffic of one call, in the byte ledger's
    unit (input-block bytes per shard per collective)."""
    counts = {
        ("ntt", True): 3, ("ntt", False): 2,
        ("intt", True): 3, ("intt", False): 2,
        ("polymul", True): 6, ("polymul", False): 6,
    }
    count = counts[(op, ordered)]
    per_call = batch * (n // n_devices) * itemsize
    return {"count": count, "bytes": count * per_call,
            "bytes_per_call": per_call}
