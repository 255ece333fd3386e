"""Batched Stockham NTT and fused modular polynomial products (port of
``repro.kernels.ntt``).

The exact (mod-q) counterpart of ``kernels/fft.py`` and ``kernels/polymul.py``:
the same Stockham schedule with the complex butterfly replaced by a modular
one. Each public function is a wrapper: for tensors on the card it launches
its hand-written CUDA kernel (``csrc/ntt.cu``), for tensors on the CPU it
runs the plain PyTorch version beside it, which performs the same sweeps,
twist, pointwise product and untwist in ``int64``. Any other device raises.

Arithmetic, shared by kernels and plain versions:

* q is an odd prime < 2^31 (``core.ntt.ref`` selects it), so residues fit
  one 32-bit word and a + b < 2^32.
* Twiddles are stored in Montgomery form (w^k * 2^32 mod q), so each
  butterfly multiply is one Montgomery REDC: mont(v, w_mont) = v * w mod q.
  The data itself stays in the normal domain.
* Every result is a canonical residue in [0, q), so kernel, plain version
  and reference agree bit for bit (``==``).

Storage: residues are ``torch.int32`` tensors on both devices (values < q <
2^31, so the bits are those of uint32); the kernels read them as
``uint32_t``. Inputs may also be ``torch.uint32`` words of any value: the
load reduces them mod q, as the reference's ``_as_residues`` does.

On the ``meta`` device (the dry-run's) a wrapper runs its plain
version's ops, which compute nothing and give the result's shape and
type; nothing is launched.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.ntt.ref import NTTParams
from repro_torch.kernels import _build
from repro_torch.kernels.fft import (MAX_BLOCK, REGISTER_STEPS_FROM,
                                     SMEM_BLOCK_BUDGET, SMEM_MAX_BYTES,
                                     TWO_PASS_FROM, TwoPass, _fit_block,
                                     _log2, fit_smem, pass2_twiddle_index,
                                     pass_slots, ptr, two_pass_launch,
                                     two_pass_split)

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


# ---------------------------------------------------------------------------
# Montgomery arithmetic on int64 tensors (the plain versions)
# ---------------------------------------------------------------------------

def mont_mul(a, b, q, qinv):
    """Montgomery product a * b * 2^-32 mod q of residues a, b < q < 2^31
    held in int64; ``qinv`` = -q^-1 mod 2^32. With b in Montgomery form this
    is a * b mod q.

    Written so no int64 intermediate overflows: a * b < 2^62, but
    a * b + m * q would reach 2^62 + 2^63. So, as the kernel does, the
    result is hi(a b) + hi(m q) + (lo(a b) != 0), each term in range, and
    m = lo(a b) * qinv mod 2^32 is formed from 16-bit halves of lo(a b).
    """
    ab = a * b
    lo = ab & _MASK32
    m = (((((lo >> 16) * qinv) & _MASK16) << 16)
         + (lo & _MASK16) * qinv) & _MASK32
    t = (ab >> 32) + ((m * q) >> 32) + (lo != 0)
    return torch.where(t >= q, t - q, t)


def _add_mod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub_mod(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def _load(x: torch.Tensor, q) -> torch.Tensor:
    """What a kernel's load does: read the words as uint32, reduce mod q."""
    return (x.view(torch.int32).to(torch.int64) & _MASK32) % q


def _ntt_radix2_stage(y, w, L: int, r: int, n: int, q, qinv):
    """One Stockham sweep (P, B, L, r) -> (P, B, 2L, r/2) over F_q, P the
    limbs; w is the (P, n) master table, q and qinv are (P, 1, 1, 1)."""
    half = r // 2
    e = y[..., :half]
    o = y[..., half:]
    stride = n // (2 * L)
    tw = w[:, 0:L * stride:stride][:, None, :, None]     # (P, 1, L, 1)
    t = mont_mul(o, tw, q, qinv)
    return torch.cat([_add_mod(e, t, q), _sub_mod(e, t, q)], dim=2)


def ntt_stages(x: torch.Tensor, w: torch.Tensor, q, qinv) -> torch.Tensor:
    """All radix-2 Stockham sweeps of (P, B, n) int64 residues with the
    (P, n) Montgomery table ``w`` (powers of the n-th root, or of its
    inverse); q and qinv are (P, 1, 1). Natural order in and out: Stockham
    autosorts, so there is no bit-reversal anywhere."""
    p, b, n = x.shape
    y = x.reshape(p, b, 1, n)
    q4, qinv4 = q[..., None], qinv[..., None]
    L, r = 1, n
    while r > 1:
        y = _ntt_radix2_stage(y, w, L, r, n, q4, qinv4)
        L, r = 2 * L, r // 2
    return y.reshape(p, b, n)


def step_sweeps(x: torch.Tensor, w: torch.Tensor, q, qinv) -> torch.Tensor:
    """``ntt_stages`` in the register-step order of ``csrc/ntt.cu``
    (``ntt_sub_steps`` on whole rows): steps of T = min(4, sweeps left) at
    state A(L, r), each on groups of 2^T elements -- group (l, c), c < r /
    2^T, holds (l, c + i r / 2^T) -- whose T sweeps are the group's own
    butterflies (``group_sweeps``: before sweep t, element b + 2^t i holds
    block l + b L of A(2^t L, r / 2^t)), the group ending as blocks l + j L
    of column c of A(2^T L, r / 2^T). The same residues as ``ntt_stages``
    (``==``)."""
    p, b, n = x.shape
    qv, qiv = q.view(p, 1, 1, 1, 1, 1), qinv.view(p, 1, 1, 1, 1, 1)
    L, r = 1, n
    while r > 1:
        lr = r.bit_length() - 1
        T = min(4, lr)
        E, cols = 1 << T, r >> T
        g = x.reshape(p, b, L, E, cols)             # [l, i, c]
        for t in range(T):
            v = g.reshape(p, b, L, 2, E >> (t + 1), 1 << t, cols)
            e, o = v[:, :, :, 0], v[:, :, :, 1]     # [l, i, b, c] each
            blocks = (torch.arange(L, device=x.device)[:, None]
                      + L * torch.arange(1 << t, device=x.device)[None, :])
            tw = w[:, blocks << (lr - t - 1)][:, None, :, None, :, None]
            m = mont_mul(o, tw, qv, qiv)
            g = torch.stack([_add_mod(e, m, qv), _sub_mod(e, m, qv)],
                            dim=-3).reshape(p, b, L, E, cols)
        x = g.transpose(2, 3).reshape(p, b, n)       # [j, l, c]
        L, r = L * E, cols
    return x


def _polymul_stages(a, b, wf, wi, twist, untwist, q, qinv, r2,
                    negacyclic: bool, stages=ntt_stages) -> torch.Tensor:
    """The fused product on (P, B, n) words, tables (P, n), constants
    (P, 1, 1), all int64: load, psi twist, two NTTs, the r2-hop pointwise
    product, the inverse NTT, and the untwist by psi^-j * n^-1 (n^-1 alone
    for the cyclic product), each transform by ``stages``. Returns int32
    residues."""
    a, b = _load(a, q), _load(b, q)
    if negacyclic:
        a = mont_mul(a, twist[:, None], q, qinv)
        b = mont_mul(b, twist[:, None], q, qinv)
    fa = stages(a, wf, q, qinv)
    fb = stages(b, wf, q, qinv)
    # one operand enters the Montgomery domain first (the r2 hop)
    p = mont_mul(mont_mul(fa, r2, q, qinv), fb, q, qinv)
    c = stages(p, wi, q, qinv)
    return mont_mul(c, untwist[:, None], q, qinv).to(torch.int32)


# ---------------------------------------------------------------------------
# Tables, cached per (params, device)
# ---------------------------------------------------------------------------

def untwist_table(params: NTTParams, negacyclic: bool) -> np.ndarray:
    """Output-pass multipliers in the normal domain (uint64): psi^-j * n^-1
    for the negacyclic untwist and scale, or n^-1 everywhere for the cyclic
    product. The single definition the single-limb and RNS tables read."""
    if negacyclic:
        return (params.powers(params.psi_inv) * np.uint64(params.n_inv)
                % np.uint64(params.q))
    return np.full(params.n, params.n_inv, np.uint64)


def _montgomery(params: NTTParams, values: np.ndarray) -> np.ndarray:
    return params.to_montgomery(values).astype(np.int32)   # < q < 2^31


@functools.lru_cache(maxsize=64)
def master_table(params: NTTParams, base: int, device: torch.device
                 ) -> torch.Tensor:
    """(n,) int32 Montgomery-form powers of ``base`` mod q on ``device``."""
    return torch.from_numpy(_montgomery(params, params.powers(base))
                            ).to(device)


@functools.lru_cache(maxsize=64)
def polymul_tables(params: NTTParams, negacyclic: bool,
                   device: torch.device) -> tuple[torch.Tensor, ...]:
    """(wf, wi, twist, untwist) of the fused product, (n,) int32 each, in
    Montgomery form. The cyclic product's twist (powers of 1) is unused."""
    return (master_table(params, params.w, device),
            master_table(params, params.w_inv, device),
            master_table(params, params.psi if negacyclic else 1, device),
            torch.from_numpy(_montgomery(
                params, untwist_table(params, negacyclic))).to(device))


@functools.lru_cache(maxsize=32)
def rns_tables(rns, negacyclic: bool, device: torch.device
               ) -> tuple[torch.Tensor, ...]:
    """Per-limb tables of the RNS kernel on ``device``: scalars (k, 4) =
    [q, qinv, r2, 0] as uint32 bits in int32, and wf, wi, twist, untwist as
    (k, n) int32 in Montgomery form."""
    scal = np.array([(p.q, p.qinv, p.r2, 0) for p in rns.limbs],
                    np.uint32).view(np.int32)
    cpu = torch.device("cpu")
    per_limb = [polymul_tables(p, negacyclic, cpu) for p in rns.limbs]
    stacks = [torch.stack([t[i] for t in per_limb]) for i in range(4)]
    return tuple(t.to(device) for t in [torch.from_numpy(scal), *stacks])


def _constants(device: torch.device, *values) -> list[torch.Tensor]:
    """Scalars as (1, 1, 1) int64 tensors on ``device``."""
    return [torch.tensor(v, dtype=torch.int64, device=device).view(1, 1, 1)
            for v in values]


# ---------------------------------------------------------------------------
# Shared-memory planning: a CTA keeps its uint32 rows in two ping-pong
# buffers, so a transformed row costs 8n bytes and a product row (both
# operands) 16n.
# ---------------------------------------------------------------------------

def ntt_smem_bytes(n: int, block: int, *, product: bool = True) -> int:
    """Shared memory of a CTA holding ``block`` rows of n residues."""
    return block * n * 4 * 2 * (2 if product else 1)


def plan_ntt_block(n: int, *, product: bool = True) -> int:
    """Largest power-of-two batch block whose working set fits the block
    budget (at least one row): the Hopper counterpart of the reference's
    VMEM block."""
    blk = SMEM_BLOCK_BUDGET // ntt_smem_bytes(n, 1, product=product)
    blk = max(1, min(MAX_BLOCK, blk))
    return 1 << (blk.bit_length() - 1)


def ntt_cta_rows(n: int, batch: int, block: int, *, product: bool = True
                 ) -> tuple[int, bool]:
    """(rows per CTA, staged) for a launch: ``block`` is a cap, fitted to
    the batch, then halved while the rows exceed shared memory; staged
    when even one row does not fit."""
    if block < 1:
        raise ValueError(f"block={block}: need a block >= 1")
    return fit_smem(lambda blk: ntt_smem_bytes(n, blk, product=product),
                    _fit_block(block, batch), 1)


def ntt_resident(n: int, *, product: bool = True) -> bool:
    """Whether one row stays in shared memory for every sweep."""
    return ntt_smem_bytes(n, 1, product=product) <= SMEM_MAX_BYTES


def rns_steps_smem_bytes(n: int) -> int:
    """Shared memory of the RNS product's register-step CTA: two buffers
    of both operands' rows of n words, one pad word in 16."""
    return 4 * (n + n // 16) * 4


def _scratch(n: int, batch: int, rows: int, staged: bool, limbs: int,
             device: torch.device, *, product: bool) -> torch.Tensor | None:
    """Device-memory ping-pong buffers of a staged launch, one slice per
    CTA; None when the rows stay in shared memory."""
    if not staged:
        return None
    ctas = limbs * -(-batch // rows)
    words = ctas * ntt_smem_bytes(n, rows, product=product) // 4
    return torch.empty(words, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# The product's split-pass schedule (csrc/ntt.cu, the split-pass section)
#
# The radix-2 Stockham state splits at any L = n1 (n = n1 n2) without
# changing one residue, as ``kernels.fft``'s two-pass schedule splits the
# float sweeps. Launch F1 runs pass 1 of both forward NTTs (sub-problem q0 =
# x[q0 + k n2], after the load's reduction and psi twist). Launch M runs
# their pass 2 on sub-problem l0 of a and of b, forms the r2-hop product of
# the bins l0 + k n1 it then holds, and runs pass 1 of the inverse under the
# mirrored split (n2, n1) on the same sub-problem: its q0' = l0 reads
# exactly P[l0 + k n1]. Launch I2 is the inverse's pass 2 with the untwist
# on its store. Radix 2 puts every split on the sweep sequence, so there is
# always three launches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NTTTwoPass:
    """The product's split-pass launches: n = n1 n2; F1 holds ``c1``
    sub-problems of n1 points of each operand a CTA (2 c1 in all), M ``cm``
    sub-problems of n2 points of each operand (2 cm), the inverse's pass 2
    ``ci`` sub-problems of n1 points."""
    n1: int
    n2: int
    c1: int
    cm: int
    ci: int

    @property
    def launches(self) -> int:
        return 3


@functools.lru_cache(maxsize=256)
def ntt_two_pass_plan(n: int) -> NTTTwoPass | None:
    """The split-pass launches ``ntt_polymul`` makes for n-point rows, or
    None where one CTA takes whole rows: below
    ``TWO_PASS_FROM["ntt_polymul"]``, and past 2^25 points, where no split
    fits (a single CTA then stages through device memory). The split is
    the float products' radix-2 rule (n1 as close to sqrt(n) as n1 <= 8192
    and n2 <= 4096 allow)."""
    if n < TWO_PASS_FROM["ntt_polymul"]:
        return None
    split = two_pass_split(n, 2, product=True)
    return None if split is None else ntt_two_pass_launch(*split)


def ntt_two_pass_launch(n1: int, n2: int) -> NTTTwoPass:
    """Sub-problems per CTA of each launch for the split (n1, n2), at most
    the launch's sub-problems per row: F1 as many as
    ``TWO_PASS_CTA_POINTS`` allows for the points it holds (both
    operands'); I2 as many for its one operand; M as many of each operand
    as I2 takes, since its inverse pass runs on a's slots alone and so
    keeps every thread busy only then (twice the points a CTA of the
    other launches holds, still within 66 KB of shared memory)."""
    return NTTTwoPass(n1, n2, pass_slots(n1, n2, 2), pass_slots(n2, n1),
                      pass_slots(n1, n2))


@dataclasses.dataclass(frozen=True)
class RNSRegisterSteps:
    """The RNS product's register-step schedule: one launch, one CTA per
    (row, limb) holding both operands' whole rows, its three transforms in
    steps of up to four radix-2 sweeps on the residues a thread holds."""
    n: int

    @property
    def launches(self) -> int:
        return 1


@functools.lru_cache(maxsize=256)
def rns_schedule(n: int) -> NTTTwoPass | RNSRegisterSteps | None:
    """The schedule ``rns_ntt_polymul`` takes for n-point rows: from
    ``TWO_PASS_FROM["rns_ntt_polymul"]`` points on the single-limb
    product's split-pass launches (``ntt_two_pass_plan``'s split) with the
    limb as grid row y; below that, from
    ``REGISTER_STEPS_FROM["rns_ntt_polymul"]`` on and while both rows fit
    one CTA, the register-step kernel; else (None) the single-CTA kernel,
    one CTA per row block and limb, staged past 8192 points (past 2^25,
    where no split fits)."""
    if n >= TWO_PASS_FROM["rns_ntt_polymul"]:
        split = two_pass_split(n, 2, product=True)
        if split is not None:
            return ntt_two_pass_launch(*split)
    if (n >= REGISTER_STEPS_FROM["rns_ntt_polymul"]
            and rns_steps_smem_bytes(n) <= SMEM_MAX_BYTES):
        return RNSRegisterSteps(n)
    return None


@functools.lru_cache(maxsize=256)
def ntt_batched_two_pass_plan(n: int) -> TwoPass | None:
    """The two-pass launches ``ntt_batched`` makes for n-point rows, or
    None where one CTA takes whole rows: below
    ``TWO_PASS_FROM["ntt_batched"]``, and past 2^26 points, where no split
    fits. The split is the float fft's radix-2 rule (n1, n2 <= 8192, n1 as
    close to sqrt(n) as allowed), its sub-problems per CTA the fft's."""
    if n < TWO_PASS_FROM["ntt_batched"]:
        return None
    split = two_pass_split(n, 2)
    return None if split is None else two_pass_launch(*split)


def schedule_name(schedule) -> str:
    """The name an NTT wrapper's call is counted under in
    ``_build.SCHEDULES``."""
    if schedule is None:
        return "single-CTA"
    if isinstance(schedule, RNSRegisterSteps):
        return "register-step"
    return "split-pass" if isinstance(schedule, NTTTwoPass) else "two-pass"


@functools.lru_cache(maxsize=64)
def pass2_table(params: NTTParams, base: int, n1: int,
                device: torch.device) -> torch.Tensor:
    """The pass-2 twiddles of the split (n1, n / n1) from the master table
    of ``base`` (the root or its inverse), gathered in the order the
    kernels read them (``kernels.fft.pass2_twiddle_index``, radix 2),
    int32 Montgomery form on ``device``."""
    idx = torch.from_numpy(pass2_twiddle_index(params.n, n1, 2))
    return master_table(params, base, torch.device("cpu"))[idx].to(device)


def pass2_tables(params: NTTParams, negacyclic: bool, n1: int,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The product's pass-2 twiddles of the split (n1, n2): the forward
    transforms' from the forward table (split n1 x n2) and the inverse's
    from the inverse table (split n2 x n1). Both products read the same
    (the twist is not in them)."""
    return (pass2_table(params, params.w, n1, device),
            pass2_table(params, params.w_inv, params.n // n1, device))


@functools.lru_cache(maxsize=32)
def rns_pass2_tables(rns, n1: int, device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each limb's pass-2 tables for the split (n1, n / n1) (forward and
    inverse, as ``pass2_tables``), stacked as (k, n) int32 on ``device``:
    row ``limb`` holds the limb's table, zero-padded to n words, where the
    split-pass kernels read it."""
    cpu = torch.device("cpu")
    stacks = (torch.stack([pass2_table(p, p.w, n1, cpu)
                           for p in rns.limbs]),
              torch.stack([pass2_table(p, p.w_inv, rns.n // n1, cpu)
                           for p in rns.limbs]))
    return tuple(torch.nn.functional.pad(t, (0, rns.n - t.shape[1])
                                         ).to(device) for t in stacks)


def _sub_sweeps(y, w, q, qinv, *, n: int, n1: int | None = None):
    """Every radix-2 sweep of m-point sub-problems, states (..., 1, m) ->
    (..., m, 1), with the (n,) int64 table ``w`` of the whole n-point
    transform. Pass 1 (``n1`` None): the local block index is the global
    one. Pass 2: the state is (B, n1, 1, m), sub-problem l0 its index on
    axis 1, global block l0 + n1 l and global L = n1 L; its twiddle is
    w[(l0 + n1 l) r / 2] at local (L, r)."""
    m = y.shape[-1]
    L, r = 1, m
    while r > 1:
        half = r // 2
        e, o = y[..., :half], y[..., half:]
        if n1 is None:
            stride = n // (2 * L)
            tw = w[0:L * stride:stride][:, None]                # (L, 1)
        else:
            blocks = (torch.arange(n1, device=y.device)[:, None]
                      + n1 * torch.arange(L, device=y.device)[None, :])
            tw = w[blocks * half][..., None]                    # (n1, L, 1)
        t = mont_mul(o, tw, q, qinv)
        y = torch.cat([_add_mod(e, t, q), _sub_mod(e, t, q)], dim=-2)
        L, r = 2 * L, half
    return y


def _two_pass_sweeps(x, w, q, qinv, *, n: int, n1: int):
    """Both passes of an n-point transform of (B, n) int64 residues at the
    split (n1, n2): pass 1 on (B n2, n1) sub-rows gathered at stride n2,
    scattered to A[l n2 + q0]; pass 2 on (B n1, n2) contiguous sub-rows of
    A with twiddles from the global block index. Returns (B, n1, n2),
    whose [l0, k] is bin l0 + k n1."""
    bsz, n2 = x.shape[0], n // n1
    sub = x.reshape(bsz, n1, n2).transpose(1, 2).reshape(bsz * n2, 1, n1)
    inter = _sub_sweeps(sub, w, q, qinv, n=n).reshape(bsz, n2, n1)
    return _sub_sweeps(inter.transpose(1, 2).reshape(bsz, n1, 1, n2), w, q,
                       qinv, n=n, n1=n1).reshape(bsz, n1, n2)


def ntt_polymul_two_pass(a: torch.Tensor, b: torch.Tensor,
                         params: NTTParams, *, negacyclic: bool = True,
                         plan: NTTTwoPass) -> torch.Tensor:
    """Plain mirror of the split-pass kernels in int64, in their dataflow:
    F1 loads, reduces and twists each operand and runs (B n2, n1) sub-rows
    gathered at stride n2, scattered to A[l n2 + q0]; M runs (B n1, n2)
    contiguous sub-rows of A with twiddles from the global block index,
    forms the r2-hop product of the bins l0 + k n1 they hold, and runs the
    inverse's pass 1 on those very sub-rows, scattered to A'[l n1 + l0];
    I2 runs (B n2, n1) contiguous sub-rows of A' (global block l0' + n2 l)
    and stores c[l0' + k n2] with the untwist. Exact: it equals
    ``ntt_polymul_plain`` (``==``) for any split."""
    n, n1, n2 = params.n, plan.n1, plan.n2
    bsz = a.shape[0]
    wf, wi, twist, untwist = (t.to(torch.int64) for t in polymul_tables(
        params, negacyclic, a.device))
    q, qinv, r2 = params.q, params.qinv, params.r2

    def forward(x):
        x = _load(x, q)
        if negacyclic:
            x = mont_mul(x, twist, q, qinv)
        return _two_pass_sweeps(x, wf, q, qinv, n=n, n1=n1)

    p = mont_mul(mont_mul(forward(a), r2, q, qinv), forward(b), q, qinv)
    inter = _sub_sweeps(p.reshape(bsz * n1, 1, n2), wi, q, qinv, n=n)
    inter = inter.reshape(bsz, n1, n2).transpose(1, 2)     # [l, l0]
    out = _sub_sweeps(inter.reshape(bsz, n2, 1, n1), wi, q, qinv, n=n,
                      n1=n2).reshape(bsz, n2, n1)  # [l0', k]: c[l0' + k n2]
    c = out.transpose(1, 2).reshape(bsz, n)
    return mont_mul(c, untwist, q, qinv).to(torch.int32)


def rns_ntt_polymul_two_pass(ar: torch.Tensor, br: torch.Tensor, rns, *,
                             negacyclic: bool = True,
                             plan: NTTTwoPass) -> torch.Tensor:
    """Plain mirror of the RNS product's split-pass launches: F1, M and I2
    of ``ntt_polymul_two_pass`` on each limb's (B, n) rows (the kernels'
    grid row y), with that limb's modulus and tables. Exact: it equals
    ``rns_ntt_polymul_plain`` (``==``) for any split."""
    return torch.stack([ntt_polymul_two_pass(ar[i], br[i], limb,
                                             negacyclic=negacyclic,
                                             plan=plan)
                        for i, limb in enumerate(rns.limbs)])


def ntt_batched_two_pass(x: torch.Tensor, params: NTTParams, *,
                         inverse: bool = False, plan: TwoPass
                         ) -> torch.Tensor:
    """Plain mirror of ``ntt_batched``'s two launches in int64, in their
    dataflow: pass 1 loads and reduces, runs (B n2, n1) sub-rows gathered
    at stride n2 and scatters them to A[l n2 + q0]; pass 2 runs (B n1, n2)
    contiguous sub-rows of A with twiddles from the global block index and
    stores bin l0 + k n1, times n^-1 for the inverse. Exact: it equals
    ``ntt_batched_plain`` (``==``) for any split."""
    q, qinv = params.q, params.qinv
    w = master_table(params, params.w_inv if inverse else params.w,
                     x.device).to(torch.int64)
    out = _two_pass_sweeps(_load(x, q), w, q, qinv, n=params.n, n1=plan.n1)
    y = out.transpose(1, 2).reshape(x.shape[0], params.n)   # bin l0 + k n1
    if inverse:
        y = mont_mul(y, _scale_mont(params), q, qinv)
    return y.to(torch.int32)


# ---------------------------------------------------------------------------
# Input checks
# ---------------------------------------------------------------------------

def _as_residues(x: torch.Tensor, q: int) -> torch.Tensor:
    """Integer coefficients -> the words the kernels read, with the
    reference's contract: floats raise, negatives wrap Python-style
    ((-1) % q == q - 1). ``torch.uint32`` passes as it is (the load reduces
    it); other integer types reduce here into int32 residues. Either way
    the words come back contiguous, as the kernels read them: ``to`` keeps
    a transposed view's strides, so a (rows, m) view of a transpose (a
    reshape that merges a size-1 batch) would reach the kernel column by
    column without the final copy."""
    if x.dtype.is_floating_point or x.dtype.is_complex or \
            x.dtype == torch.bool:
        raise TypeError(f"NTT needs integer residues, got {x.dtype}")
    if x.dtype == torch.uint32:
        return x.contiguous()
    return torch.remainder(x.to(torch.int64), q).to(torch.int32).contiguous()


def _check_rows(name: str, shape: tuple[int, ...], *xs: torch.Tensor
                ) -> None:
    ref = xs[0]
    for x in xs:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != ref.device:
            raise ValueError(f"{name}: tensors on {x.device} and "
                             f"{ref.device}")
    if ref.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {ref.device}")


def residues_to_numpy(x: torch.Tensor) -> np.ndarray:
    """Kernel residues (int32, values < q < 2^31) -> numpy uint32, the
    reference's result dtype."""
    return x.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def _scale_mont(params: NTTParams) -> int:
    """n^-1 in Montgomery form: one REDC by it scales by n^-1."""
    return params.n_inv * (1 << 32) % params.q


def ntt_batched_plain(x: torch.Tensor, params: NTTParams, *,
                      inverse: bool = False) -> torch.Tensor:
    """Plain version of ``ntt_batched``."""
    q, qinv = _constants(x.device, params.q, params.qinv)
    w = master_table(params, params.w_inv if inverse else params.w,
                     x.device).to(torch.int64)[None]
    y = ntt_stages(_load(x[None], q), w, q, qinv)
    if inverse:
        y = mont_mul(y, _scale_mont(params), q, qinv)
    return y[0].to(torch.int32)


def ntt_batched(x: torch.Tensor, params: NTTParams, *,
                inverse: bool = False, block_b: int | None = None
                ) -> torch.Tensor:
    """Batched cyclic NTT (or inverse NTT, scaled by n^-1) of integer
    coefficients (B, n) mod ``params.q``; int32 residues out.

    On the card: kernel ``ntt_kernel`` -- from
    ``TWO_PASS_FROM["ntt_batched"]`` points on its two-pass schedule
    (``ntt_batched_two_pass_plan``: two launches whose CTAs hold whole
    sub-problems of a split n = n1 x n2), below that ``block_b`` rows per
    CTA at most (default ``plan_ntt_block(n, product=False)``), fitted to
    the batch. On the CPU the plain version of the same schedule.
    Replaces ``repro/kernels/ntt.py::ntt_batched``.
    """
    with spans.span("repro_torch.glue/ntt_batched"):
        n = params.n
        _check_rows("ntt_batched", (x.shape[0], n), x)
        x = _as_residues(x, params.q)
        two_pass = ntt_batched_two_pass_plan(n)
        if x.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return ntt_batched_two_pass(x, params, inverse=inverse,
                                            plan=two_pass)
            return ntt_batched_plain(x, params, inverse=inverse)
        return _launch_ntt_batched(
            x, params, inverse, block_b or plan_ntt_block(n, product=False),
            two_pass)


def _launch_ntt_batched(x, params: NTTParams, inverse: bool, block: int,
                        two_pass: TwoPass | None):
    """Launch ``ntt_batched`` on card residues under the given schedule:
    ``two_pass``, or one CTA per ``block`` rows at most."""
    n = params.n
    b = x.shape[0]
    y = torch.empty((b, n), dtype=torch.int32, device=x.device)
    if b == 0:
        return y
    base = params.w_inv if inverse else params.w
    with torch.cuda.device(x.device):
        w = master_table(params, base, x.device)
        if two_pass is None:
            rows, staged = ntt_cta_rows(n, b, block, product=False)
            scratch = _scratch(n, b, rows, staged, 1, x.device,
                               product=False)
            tw2, split = None, (0, 0, 0)
        else:
            rows = 1
            scratch = torch.empty(b * n, dtype=torch.int32, device=x.device)
            tw2 = pass2_table(params, base, two_pass.n1, x.device)
            split = tuple(_log2(v) for v in (two_pass.n1, two_pass.c1,
                                             two_pass.c2))
        _build.launch("ntt_batched", "ntt_batched", ptr(x), ptr(y), ptr(w),
                      ptr(scratch), ptr(tw2), b, _log2(n), params.q,
                      params.qinv, _scale_mont(params), int(inverse), rows,
                      *split, schedule=schedule_name(two_pass))
    return y


def ntt_polymul_plain(a: torch.Tensor, b: torch.Tensor, params: NTTParams,
                      *, negacyclic: bool = True) -> torch.Tensor:
    """Plain version of ``ntt_polymul``."""
    tables = [t.to(torch.int64)[None]
              for t in polymul_tables(params, negacyclic, a.device)]
    consts = _constants(a.device, params.q, params.qinv, params.r2)
    return _polymul_stages(a[None], b[None], *tables, *consts,
                           negacyclic)[0]


def ntt_polymul(a: torch.Tensor, b: torch.Tensor, params: NTTParams, *,
                negacyclic: bool = True, block_b: int | None = None
                ) -> torch.Tensor:
    """Exact product mod (x^n + 1, q), or x^n - 1 with ``negacyclic=False``,
    of integer coefficient batches (B, n); int32 residues out.

    On the card: kernel ``ntt_polymul_kernel`` -- from
    ``TWO_PASS_FROM["ntt_polymul"]`` points on its split-pass schedule
    (``ntt_two_pass_plan``: three launches whose CTAs hold whole
    sub-problems of a split n = n1 x n2), below that twist, two NTTs,
    pointwise product, inverse NTT and untwist in one residency, ``block_b``
    products per CTA at most (default ``plan_ntt_block(n)``). On the CPU
    the plain version of the same schedule. Replaces
    ``repro/kernels/ntt.py::ntt_polymul``.
    """
    with spans.span("repro_torch.glue/ntt_polymul"):
        n = params.n
        _check_rows("ntt_polymul", (a.shape[0], n), a, b)
        a = _as_residues(a, params.q)
        b = _as_residues(b, params.q)
        two_pass = ntt_two_pass_plan(n)
        if a.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return ntt_polymul_two_pass(a, b, params,
                                            negacyclic=negacyclic,
                                            plan=two_pass)
            return ntt_polymul_plain(a, b, params, negacyclic=negacyclic)
        return _launch_ntt_polymul(a, b, params, negacyclic,
                                   block_b or plan_ntt_block(n), two_pass)


def _launch_ntt_polymul(a, b, params: NTTParams, negacyclic: bool,
                        block: int, two_pass: NTTTwoPass | None):
    """Launch ``ntt_polymul`` on card residues under the given schedule:
    ``two_pass``, or one CTA per ``block`` products at most."""
    n = params.n
    bsz = a.shape[0]
    c = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    if bsz == 0:
        return c
    with torch.cuda.device(a.device):
        wf, wi, twist, untwist = polymul_tables(params, negacyclic, a.device)
        if two_pass is None:
            rows, staged = ntt_cta_rows(n, bsz, block)
            scratch = _scratch(n, bsz, rows, staged, 1, a.device,
                               product=True)
            tw2f = tw2i = None
            split = (0, 0, 0, 0)
        else:
            # F1's spectra of a and of b, then the inverse's pass-1 result
            rows = 1
            scratch = torch.empty(3 * bsz * n, dtype=torch.int32,
                                  device=a.device)
            tw2f, tw2i = pass2_tables(params, negacyclic, two_pass.n1,
                                      a.device)
            split = tuple(_log2(v) for v in (two_pass.n1, two_pass.c1,
                                             two_pass.cm, two_pass.ci))
        _build.launch("ntt_polymul", "ntt_polymul", ptr(a), ptr(b), ptr(c),
                      ptr(wf), ptr(wi), ptr(twist), ptr(untwist),
                      ptr(scratch), ptr(tw2f), ptr(tw2i), bsz, _log2(n),
                      params.q, params.qinv, params.r2, int(negacyclic),
                      rows, *split, schedule=schedule_name(two_pass))
    return c


def _check_rns(ar: torch.Tensor, br: torch.Tensor, rns) -> tuple[int, int]:
    if ar.ndim != 3:
        raise ValueError(f"rns_ntt_polymul: expected (k, B, n) residue "
                         f"stacks, got shape {tuple(ar.shape)}")
    _check_rows("rns_ntt_polymul", (rns.k, ar.shape[1], rns.n), ar, br)
    for x in (ar, br):
        if x.dtype != torch.uint32:
            raise TypeError(f"rns_ntt_polymul wants uint32 residue stacks "
                            f"(rns.to_rns), got {x.dtype}")
    return ar.shape[1], rns.n


def rns_ntt_polymul_plain(ar: torch.Tensor, br: torch.Tensor, rns, *,
                          negacyclic: bool = True,
                          stages=ntt_stages) -> torch.Tensor:
    """Plain version of ``rns_ntt_polymul``: all limbs at once, each limb's
    constants read from the same (k, 4) table as the kernel's; the sweeps
    one by one (``ntt_stages``, the single-CTA kernel's order) or as
    ``stages`` runs them."""
    scal, *tables = rns_tables(rns, negacyclic, ar.device)
    scal = scal.to(torch.int64) & _MASK32
    q, qinv, r2 = (scal[:, i].view(-1, 1, 1) for i in range(3))
    tables = [t.to(torch.int64) for t in tables]
    return _polymul_stages(ar, br, *tables, q, qinv, r2, negacyclic, stages)


def rns_ntt_polymul_steps(ar: torch.Tensor, br: torch.Tensor, rns, *,
                          negacyclic: bool = True) -> torch.Tensor:
    """Plain mirror of the register-step kernel: ``rns_ntt_polymul_plain``
    with every transform in the kernel's step order (``step_sweeps``).
    Exact: it equals the plain version (``==``)."""
    return rns_ntt_polymul_plain(ar, br, rns, negacyclic=negacyclic,
                                 stages=step_sweeps)


def rns_ntt_polymul(ar: torch.Tensor, br: torch.Tensor, rns, *,
                    negacyclic: bool = True, block_b: int | None = None
                    ) -> torch.Tensor:
    """Limb-batched exact product: uint32 residue stacks (k, B, n) ->
    int32 (k, B, n), every limb and batch block in one launch.

    ``rns`` is a ``core.ntt.rns.RNSParams``. Inputs are the per-limb
    residues ``rns.to_rns`` produces; the CRT (``rns.crt_to_modulus``)
    is the caller's. On the card: kernel 8 under ``rns_schedule(n)``, one
    grid row per limb -- the split-pass launches, the register-step kernel
    (one CTA per row and limb), or the single-CTA kernel
    ``rns_ntt_polymul_kernel`` with ``block_b`` products per CTA at most
    (default ``plan_ntt_block(n)``). On the CPU the plain version of the
    same schedule. Replaces ``repro/kernels/ntt.py::rns_ntt_polymul``.
    """
    with spans.span("repro_torch.glue/rns_ntt_polymul"):
        bsz, n = _check_rns(ar, br, rns)
        ar, br = ar.contiguous(), br.contiguous()
        schedule = rns_schedule(n)
        if ar.device.type in ("cpu", "meta"):
            if isinstance(schedule, NTTTwoPass):
                return rns_ntt_polymul_two_pass(ar, br, rns,
                                                negacyclic=negacyclic,
                                                plan=schedule)
            if isinstance(schedule, RNSRegisterSteps):
                return rns_ntt_polymul_steps(ar, br, rns,
                                             negacyclic=negacyclic)
            return rns_ntt_polymul_plain(ar, br, rns, negacyclic=negacyclic)
        return _launch_rns_ntt_polymul(ar, br, rns, negacyclic,
                                       block_b or plan_ntt_block(n), schedule)


def _launch_rns_ntt_polymul(ar, br, rns, negacyclic: bool, block: int,
                            schedule: NTTTwoPass | RNSRegisterSteps | None):
    """Launch ``rns_ntt_polymul`` on card residue stacks under the given
    schedule (``rns_schedule``'s kinds; None: one CTA per ``block``
    products and limb at most)."""
    n, bsz = rns.n, ar.shape[1]
    c = torch.empty((rns.k, bsz, n), dtype=torch.int32, device=ar.device)
    if bsz == 0:
        return c
    with torch.cuda.device(ar.device):
        scal, wf, wi, twist, untwist = rns_tables(rns, negacyclic,
                                                  ar.device)
        rows, steps, split = 1, 0, (0, 0, 0, 0)
        scratch = tw2f = tw2i = None
        if isinstance(schedule, NTTTwoPass):
            # F1's spectra of a and of b, then the inverse's pass-1 result
            scratch = torch.empty(3 * rns.k * bsz * n, dtype=torch.int32,
                                  device=ar.device)
            tw2f, tw2i = rns_pass2_tables(rns, schedule.n1, ar.device)
            split = tuple(_log2(v) for v in (schedule.n1, schedule.c1,
                                             schedule.cm, schedule.ci))
        elif isinstance(schedule, RNSRegisterSteps):
            steps = 1
        else:
            rows, staged = ntt_cta_rows(n, bsz, block)
            scratch = _scratch(n, bsz, rows, staged, rns.k, ar.device,
                               product=True)
        _build.launch("ntt_rns_polymul", "rns_ntt_polymul", ptr(ar),
                      ptr(br), ptr(c), ptr(scal), ptr(wf), ptr(wi),
                      ptr(twist), ptr(untwist), ptr(scratch), ptr(tw2f),
                      ptr(tw2i), rns.k, bsz, _log2(n), int(negacyclic),
                      rows, steps, *split,
                      schedule=schedule_name(schedule))
    return c
