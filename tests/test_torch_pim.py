"""The port's PIM model (``repro_torch.core.pim``, ``repro_torch.dist.
batching``) against the reference's (``repro.core.pim``,
``repro.dist.batching``), and the H100 beside the paper's GPUs
(``repro_torch.core.pim.hopper``).

Every public function of the reference's ``core.pim`` is called on both
sides with the same arguments, each side with its own specs, device
models and NTT parameters, at every point of a grid: n = 64 .. 65536,
FP32 / FP16 (and INT32 / INT16 for the modular forms), partitions 1 / 2 /
4 of FourierPIM-8 (and FourierPIM-40 for the capacities). Where the
reference refuses a point, the port must refuse it with the same
exception type and message.

Tolerances: cycle, gate and byte counts, the closed forms' rates, times
and energies, NTT and RNS values and the batching plans ``==`` (the copies
run the same arithmetic in the same order); simulator float values within
the reference tests' own tolerances (``tests/test_pim.py``): rtol 1e-10,
atol 1e-9 for the FFT, rtol 1e-9, atol 1e-8 for the real transforms and
the products. Inputs come from numpy seeds.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import pim as jpim
from repro.core.ntt import ref as jref
from repro.core.ntt import rns as jrns
from repro.dist import batching as jbatch
from repro_torch.core import pim as tpim
from repro_torch.core.ntt import ref as tref
from repro_torch.core.ntt import rns as trns
from repro_torch.core.pim import gpu_model as tgpu
from repro_torch.core.pim import hopper
from repro_torch.dist import batching as tbatch

REF = types.SimpleNamespace(pim=jpim, ref=jref, rns=jrns, batching=jbatch)
PORT = types.SimpleNamespace(pim=tpim, ref=tref, rns=trns, batching=tbatch)

NS = [1 << k for k in range(6, 17)]
FLOATS = ("FP32", "FP16")
INTS = ("INT32", "INT16")
PARTS = (1, 2, 4)
SHARDS = (1, 2, 3, 4, 8)
FFT_TOL = dict(rtol=1e-10, atol=1e-9)
REAL_TOL = dict(rtol=1e-9, atol=1e-8)


class _Mesh:
    """A mesh as ``dist.batching`` sees one: its axis sizes by name."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = (None, _Mesh(data=4), _Mesh(pod=2, data=2), _Mesh(model=8))


def _cfg(s, p: int, base: str = "FOURIERPIM_8"):
    return s.pim.with_partitions(getattr(s.pim, base), p)


def _plain(v):
    """A value with the side's own types taken out: dataclasses and plans
    as dicts of their fields, tuples as lists; arrays stay arrays."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _outcome(call, side):
    """("ok", value) or ("raises", exception type name, message)."""
    try:
        return ("ok", _plain(call(side)))
    except Exception as e:  # the refusal itself is compared
        return ("raises", type(e).__name__, str(e))


def _assert_same(got, want, tol, where):
    """``got == want`` down the structure; float and complex arrays within
    ``tol`` (None: equal)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, where
        assert got.dtype == want.dtype, where
        if tol is not None and want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, err_msg=where, **tol)
        else:
            assert np.array_equal(got, want), where
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, tol, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _check(calls, tol=None):
    """Each call on both sides: the same outcome; returns how many points
    the reference accepted."""
    accepted = 0
    for i, call in enumerate(calls):
        got, want = _outcome(call, PORT), _outcome(call, REF)
        _assert_same(got, want, tol, f"point {i}")
        accepted += want[0] == "ok"
    return accepted


# ---------------------------------------------------------------------------
# Closed forms: cycles, bytes, rates, times and plans ==
# ---------------------------------------------------------------------------

def _fn(name):
    """The function ``name`` of the side's package (``mod.fn`` for a
    submodule's)."""
    def get(s):
        obj = s.pim
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    return get


def _per_float(name, **kw):
    f = _fn(name)
    return [lambda s, n=n, spec=spec, p=p: f(s)(n, _cfg(s, p),
                                              getattr(s.pim, spec), **kw)
            for n in NS for spec in FLOATS for p in PARTS]


def _per_int(name, **kw):
    f = _fn(name)
    return [lambda s, n=n, spec=spec, p=p: f(s)(n, _cfg(s, p),
                                              getattr(s.pim, spec), **kw)
            for n in NS for spec in INTS for p in PARTS]


def _per_shards(name, specs):
    f = _fn(name)
    return [lambda s, n=n, d=d, spec=spec, p=p: f(s)(
        n, d, _cfg(s, p), getattr(s.pim, spec))
        for n in NS for d in SHARDS for spec in specs for p in PARTS]


_WIDTHS = ("fixed_add_cycles", "fixed_mul_cycles", "copy_cycles",
           "swap_cycles", "_barrel_shift_cycles")
_FLOAT_OPS = ("float_add_cycles", "float_mul_cycles", "complex_add_cycles",
              "complex_mul_cycles", "butterfly_cycles", "complex_word_bits",
              "storage_word_bits")
_INT_OPS = ("mod_add_cycles", "mod_mul_cycles", "ntt_butterfly_cycles",
            "storage_word_bits")
_OP_NAMES = ("fadd", "fmul", "cadd", "cmul", "modadd", "modmul",
             "butterfly", "copy", "swap")
_MODELS = ("FP16", "FP32", "INT16", "INT32", "FOURIERPIM_8",
           "FOURIERPIM_40", "RTX3070", "A100", "FULL_COMPLEX_BITS",
           "HALF_COMPLEX_BITS")
_GPU_FNS = ("fft_time_s", "fft_throughput_per_s", "fft_energy_j_per_op",
            "_pointwise_time_s")
_GPU_PRODUCT_FNS = ("polymul_time_s", "polymul_throughput_per_s",
                    "polymul_energy_j_per_op")

CLOSED_FORMS = {
    "aritpim bit widths": [
        lambda s, b=b, f=f: getattr(s.pim.aritpim, f)(b)
        for b in range(1, 65) for f in _WIDTHS],
    "aritpim float and int ops": [
        lambda s, spec=spec, f=f: getattr(s.pim.aritpim, f)(
            getattr(s.pim, spec))
        for spec in FLOATS for f in _FLOAT_OPS] + [
        lambda s, spec=spec, f=f: getattr(s.pim.aritpim, f)(
            getattr(s.pim, spec))
        for spec in INTS for f in _INT_OPS] + [
        lambda s, spec=spec, op=op: s.pim.op_cycles(op, getattr(s.pim, spec))
        for spec in FLOATS + INTS for op in _OP_NAMES],
    "specs and device models": [
        lambda s, m=m: getattr(s.pim, m) for m in _MODELS] + [
        lambda s, p=p, base=base: _cfg(s, p, base)
        for p in (1, 2, 3, 4) for base in ("FOURIERPIM_8", "FOURIERPIM_40")],
    "PIMConfig capacities": [
        lambda s, n=n, w=w, p=p, base=base, m=m: (
            getattr(_cfg(s, p, base), m)(n, w))
        for n in NS for w in (16, 32, 64) for p in PARTS
        for base in ("FOURIERPIM_8", "FOURIERPIM_40")
        for m in ("crossbars_per_fft", "valid_config", "batch_capacity")] + [
        lambda s, p=p: _cfg(s, p).num_crossbars for p in PARTS],
    "GPUConfig.fft_passes": [
        lambda s, n=n, g=g, wb=wb: getattr(s.pim, g).fft_passes(n, wb)
        for n in NS for g in ("RTX3070", "A100") for wb in (4, 8)],
    "fft_latency_cycles": [
        c for inverse in (False, True) for perm in (False, True)
        for c in _per_float("fft_latency_cycles", inverse=inverse,
                            charge_perm=perm)],
    "fft_throughput_per_s": _per_float("fft_throughput_per_s"),
    "rfft_latency_cycles": [
        c for perm in (False, True)
        for c in _per_float("rfft_latency_cycles", charge_perm=perm)],
    "rfft_throughput_per_s": _per_float("rfft_throughput_per_s"),
    "realpack_unpack_cycles": [
        lambda s, spec=spec, p=p: s.pim.realpack_unpack_cycles(
            _cfg(s, p), getattr(s.pim, spec))
        for spec in FLOATS for p in PARTS],
    "fft_distributed_latency_cycles": _per_shards(
        "fft_distributed_latency_cycles", FLOATS),
    "rfft_distributed_latency_cycles": _per_shards(
        "rfft_distributed_latency_cycles", FLOATS),
    "ntt_distributed_latency_cycles": _per_shards(
        "ntt_distributed_latency_cycles", INTS),
    "distributed bytes": [
        lambda s, n=n, spec=spec, o=o: s.pim.fft_distributed_a2a_bytes(
            n, getattr(s.pim, spec), ordered=o)
        for n in NS for spec in FLOATS for o in (False, True)] + [
        lambda s, n=n, spec=spec, f=f: getattr(s.pim, f)(
            n, getattr(s.pim, spec))
        for n in NS for spec in FLOATS
        for f in ("rfft_distributed_a2a_bytes",
                  "rfft_distributed_permute_bytes")] + [
        lambda s, n=n, d=d, spec=spec: s.pim.ntt_distributed_a2a_bytes(
            n, d, getattr(s.pim, spec))
        for n in NS for d in SHARDS for spec in INTS],
    "batched_fft_stats": [
        lambda s, n=n, spec=spec, p=p, b=b, m=m: s.pim.fft_pim.
        batched_fft_stats(n, b, _cfg(s, p), getattr(s.pim, spec), mesh=m)
        for n in NS for spec in FLOATS for p in PARTS
        for b in (None, 1, 1000) for m in MESHES],
    "polymul_latency_cycles": [
        c for real in (False, True)
        for c in _per_float("polymul_latency_cycles", real=real)],
    "polymul_real_pair_latency_cycles": _per_float(
        "polymul_real_pair_latency_cycles"),
    "polymul_real_batch_latency_cycles": [
        lambda s, n=n, b=b, spec=spec, p=p: (
            s.pim.polymul_real_batch_latency_cycles(
                n, b, _cfg(s, p), getattr(s.pim, spec)))
        for n in NS for b in (1, 2, 3, 5, 64) for spec in FLOATS
        for p in PARTS] + [
        lambda s, real=real: s.pim.polymul_pim.polymul_area_words(real)
        for real in (False, True)],
    "polymul_throughput_per_s": [
        c for real in (False, True)
        for c in _per_float("polymul_throughput_per_s", real=real)],
    "ntt_latency_cycles": [
        c for inverse in (False, True) for perm in (False, True)
        for c in _per_int("ntt_latency_cycles", inverse=inverse,
                          charge_perm=perm)],
    "ntt_polymul_latency_cycles": [
        c for nega in (False, True)
        for c in _per_int("ntt_polymul_latency_cycles", negacyclic=nega)],
    "ntt_throughput_per_s": _per_int("ntt_throughput_per_s"),
    "batched_ntt_stats": [
        lambda s, n=n, spec=spec, p=p, b=b, m=m: s.pim.batched_ntt_stats(
            n, b, _cfg(s, p), getattr(s.pim, spec), mesh=m)
        for n in NS for spec in INTS for p in PARTS
        for b in (None, 1, 1000) for m in MESHES],
    "rns_polymul closed forms": [
        lambda s, n=n, k=k, p=p, nega=nega: s.pim.rns_polymul_latency_cycles(
            n, k, _cfg(s, p), s.pim.INT32, negacyclic=nega)
        for n in NS for k in (1, 3, 9) for p in PARTS
        for nega in (False, True)] + [
        lambda s, n=n, k=k, m=m: s.pim.rns_polymul_wave_stats(
            n, k, s.pim.FOURIERPIM_8, s.pim.INT32, mesh=m)
        for n in NS for k in (1, 3, 9, 5000) for m in MESHES],
    "energies": [
        lambda s, n=n, spec=spec, p=p: s.pim.fft_energy_j_per_op(
            n, _cfg(s, p), getattr(s.pim, spec))
        for n in NS for spec in FLOATS for p in PARTS] + [
        lambda s, n=n, real=real: s.pim.polymul_energy_j_per_op(
            n, s.pim.FOURIERPIM_8, s.pim.FP32, real=real)
        for n in NS for real in (False, True)] + [
        lambda s, n=n: s.pim.ntt_energy_j_per_op(n, s.pim.FOURIERPIM_8,
                                                 s.pim.INT32)
        for n in NS],
    "gpu_model": [
        lambda s, n=n, g=g, wb=wb, f=f: getattr(s.pim.gpu_model, f)(
            n, getattr(s.pim, g), wb)
        for n in NS for g in ("RTX3070", "A100") for wb in (4, 8)
        for f in _GPU_FNS] + [
        lambda s, n=n, g=g, wb=wb, f=f, real=real: getattr(
            s.pim.gpu_model, f)(n, getattr(s.pim, g), wb, real=real)
        for n in NS for g in ("RTX3070", "A100") for wb in (4, 8)
        for f in _GPU_PRODUCT_FNS for real in (False, True)],
    "dist.batching": [
        lambda s, b=b, a=a: s.batching.schedule_waves(b, a)
        for b in (-1, 0, 1, 5, 64, 1000) for a in (0, 1, 3, 64)] + [
        lambda s, b=b, m=m: s.batching.shard_batch(b, m)
        for b in (0, 1, 5, 64, 1000) for m in MESHES[1:]] + [
        lambda s, b=b, a=a, m=m: s.batching.plan_crossbar_batch(
            b, num_arrays=a, mesh=m)
        for b in (0, 1, 5, 64, 1000) for a in (1, 3, 64) for m in MESHES] + [
        lambda s, b=b, a=a, w=w, f=f: getattr(
            s.batching.plan_crossbar_batch(b, num_arrays=a), f)(w)
        for b in (0, 5, 1000) for a in (3, 64) for w in (1e-6, 0.25)
        for f in ("latency", "throughput")],
}


def test_package_exports_equal_reference():
    """``repro_torch.core.pim`` exports what ``repro.core.pim`` does, each
    name bound."""
    assert tpim.__all__ == jpim.__all__
    assert all(hasattr(tpim, name) for name in tpim.__all__)


@pytest.mark.parametrize("name", sorted(CLOSED_FORMS))
def test_closed_forms_equal_reference(name):
    """Cycle, gate and byte counts, rates, times, energies and plans ``==``
    the reference's at every grid point, refusals included."""
    assert _check(CLOSED_FORMS[name]) > 0


# ---------------------------------------------------------------------------
# Simulators: counters and logs ==, values within the reference's tolerance
# ---------------------------------------------------------------------------

def _cplx(n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return r.standard_normal(n) + 1j * r.standard_normal(n)


def _real(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape)


def _residues(s, n: int, seed: int, bits: int = 30):
    params = s.ref.NTTParams.make(n, bits=bits)
    return np.random.default_rng(seed).integers(0, params.q, n), params


SIMULATORS = {
    "pim_fft, r_fft, fft_2r, fft_2rbeta": ([
        lambda s, n=n, spec=spec, p=p, f=f, inv=inv: getattr(s.pim, f)(
            _cplx(n, n), _cfg(s, p), getattr(s.pim, spec), inverse=inv)
        for n in NS for spec in FLOATS for p in PARTS
        for f in ("pim_fft", "r_fft", "fft_2r", "fft_2rbeta")
        for inv in (False, True)], FFT_TOL),
    "pim_rfft": ([
        lambda s, n=n, spec=spec, p=p: s.pim.pim_rfft(
            _real(n, n), _real(n, n + 1), _cfg(s, p), getattr(s.pim, spec))
        for n in NS for spec in FLOATS for p in PARTS], REAL_TOL),
    "pim_rfft_distributed": ([
        lambda s, n=n, d=d, spec=spec: s.pim.pim_rfft_distributed(
            _real(n, n), _real(n, n + 1), d, s.pim.FOURIERPIM_8,
            getattr(s.pim, spec))
        for n in NS for d in SHARDS for spec in FLOATS], REAL_TOL),
    "pim_polymul": ([
        lambda s, n=n, spec=spec, p=p: s.pim.pim_polymul(
            _cplx(n, n), _cplx(n, n + 1), _cfg(s, p), getattr(s.pim, spec))
        for n in NS for spec in FLOATS for p in PARTS], REAL_TOL),
    "pim_polymul_real": ([
        lambda s, n=n, b=b, p=p: s.pim.pim_polymul_real(
            _real((b, n), n), _real((b, n), n + 1), _cfg(s, p), s.pim.FP32)
        for n in NS for b in (1, 2, 5) for p in PARTS], REAL_TOL),
    "pim_ntt, r_ntt, ntt_2r, ntt_2rbeta": ([
        lambda s, n=n, p=p, f=f, inv=inv: getattr(s.pim, f)(
            *_residues(s, n, n), _cfg(s, p), s.pim.INT32, inverse=inv)
        for n in NS for p in PARTS
        for f in ("pim_ntt", "r_ntt", "ntt_2r", "ntt_2rbeta")
        for inv in (False, True)], None),
    "pim_ntt_polymul": ([
        lambda s, n=n, p=p, nega=nega: s.pim.pim_ntt_polymul(
            _residues(s, n, n)[0], *_residues(s, n, n + 1), _cfg(s, p),
            s.pim.INT32, negacyclic=nega)
        for n in NS for p in PARTS for nega in (False, True)], None),
    "pim_ntt_distributed": ([
        lambda s, n=n, d=d: s.pim.pim_ntt_distributed(
            *_residues(s, n, n), d, s.pim.FOURIERPIM_8, s.pim.INT32)
        for n in NS for d in SHARDS], None),
    "pim_rns_polymul": ([
        lambda s, n=n, bits=bits: s.pim.pim_rns_polymul(
            s.rns.random_poly(np.random.default_rng(n), n,
                              s.rns.RNSParams.make(
                                  n, modulus_bits=bits).modulus),
            s.rns.random_poly(np.random.default_rng(n + 1), n,
                              s.rns.RNSParams.make(
                                  n, modulus_bits=bits).modulus),
            s.rns.RNSParams.make(n, modulus_bits=bits), s.pim.FOURIERPIM_8,
            s.pim.INT32)
        for n in NS[:9] for bits in (60, 109)], None),
}


@pytest.mark.parametrize("name", sorted(SIMULATORS))
def test_simulators_equal_reference(name):
    """The crossbar simulator's counters, charge logs, byte fields and NTT
    values ``==`` the reference's; float values within its tolerance."""
    calls, tol = SIMULATORS[name]
    assert _check(calls, tol) > 0


def test_crossbar_sim_primitives_equal_reference():
    """``CrossbarSim``'s own charges and vectored butterflies, float and
    modular, on the same rows."""
    def drive(s):
        sim = s.pim.CrossbarSim(s.pim.FOURIERPIM_8, s.pim.FP32)
        sim.load(_cplx(1024, 3))
        sim.charge_column_op("butterfly", 512, serial=3)
        sim.charge_row_ops(64)
        sim.charge_twiddle_writes(100)
        u, v = sim.butterfly_rows(_cplx(64, 4), _cplx(64, 5), _cplx(64, 6),
                                  64, serial_units=2)
        mod = s.pim.CrossbarSim(s.pim.FOURIERPIM_8, s.pim.INT32)
        q = 998244353
        r = np.random.default_rng(7)
        a, b, w = (r.integers(0, q, 64).astype(np.uint64) for _ in range(3))
        um, vm = mod.butterfly_rows_mod(a, b, w, q, 64)
        return (u, v, um, vm, sim.ctr, sim.log, mod.ctr, mod.log,
                sim.ctr.energy_j(s.pim.FOURIERPIM_8),
                sim.ctr.latency_s(s.pim.FOURIERPIM_8))
    assert _check([drive], FFT_TOL) == 1


# ---------------------------------------------------------------------------
# Faults: the seeded population, quarantine, and injection into the sims
# ---------------------------------------------------------------------------

_FAULT_KW = ({"stuck_per_array": 3}, {"bitflip_per_gate": 1e-9},
             {"dead_arrays": (1,)}, {"stuck_per_array": 2, "spares": 1},
             {"n_arrays": 0}, {"stuck_per_array": -1},
             {"bitflip_per_gate": 2.0}, {"spares": -1},
             {"dead_arrays": (16,)})


def _fault_model(s, kw):
    return s.pim.FaultModel(seed=11, **kw)


def _quarantine_walk(s, kw):
    fm = _fault_model(s, kw)
    out = []
    for a in (0, 1, 0, 2, 3, 4, 5):
        try:
            out.append(("spare", fm.quarantine(a)))
        except s.pim.SparesExhausted as e:
            out.append(("exhausted", str(e)))
    return (out, fm.quarantined, repr(fm),
            [fm.for_array(a) for a in range(20)],
            [fm.rng_for(a, salt).integers(0, 1 << 30, 4)
             for a in range(4) for salt in (0, 1)])


@pytest.mark.parametrize("kw", _FAULT_KW, ids=str)
def test_fault_model_equals_reference(kw):
    """The seeded population, per-array resolution, quarantine onto spares
    until ``SparesExhausted``, and the transient streams ``==``; bad
    arguments refused alike. Then the same population injected into the
    FFT, real-product and NTT-product simulators on arrays 0 .. 3: the
    same (corrupted) values and counters."""
    calls = [lambda s: _quarantine_walk(s, kw)]
    for a in range(4):
        calls += [
            lambda s, a=a: s.pim.pim_fft(
                _cplx(2048, a), s.pim.FOURIERPIM_8, s.pim.FP32,
                faults=_fault_model(s, kw), array_id=a),
            lambda s, a=a: s.pim.pim_polymul_real(
                _real((2, 1024), a), _real((2, 1024), a + 9),
                s.pim.FOURIERPIM_8, s.pim.FP32,
                faults=_fault_model(s, kw), array_id=a),
            lambda s, a=a: s.pim.pim_ntt_polymul(
                _residues(s, 1024, a)[0], *_residues(s, 1024, a + 9),
                s.pim.FOURIERPIM_8, s.pim.INT32,
                faults=_fault_model(s, kw), array_id=a)]
    _check(calls, REAL_TOL)


# ---------------------------------------------------------------------------
# The NTT parameters the distributed simulator derives, and the H100
# ---------------------------------------------------------------------------

def test_ntt_subparams_equal_reference():
    """``NTTParams.subparams`` (the four-step's per-shard roots) field for
    field, and its refusals."""
    assert _check([
        lambda s, n=n, m=m: s.ref.NTTParams.make(n).subparams(m)
        for n in NS for m in (1, 2, 3, 8, 64, 1024, n)]) > 0


def test_h100_is_the_data_sheets_card_in_the_papers_gpu_model():
    """The H100 lives outside the pinned copy of ``device_model``; its
    shared memory gives one cuFFT pass up to n = 16384 fp32 complex and two
    from 32768, and the paper's model prices 64 transforms at the
    closed form's bytes over 0.90 of 3.35 TB/s."""
    assert not hasattr(tpim.device_model, "H100")
    h = hopper.H100
    assert (h.mem_bw_bytes, h.board_power_w, h.smem_bytes,
            h.bw_efficiency, h.memory_bytes) == \
        (3.35e12, 700.0, 228 * 1024, 0.90, 80 << 30)
    word = tpim.FULL_COMPLEX_BITS // 8
    assert [h.fft_passes(n, word) for n in NS] == \
        [1] * 9 + [2, 2]
    for n, passes in ((4096, 1), (65536, 2)):
        want = 64 * passes * 2 * n * word / (3.35e12 * 0.90)
        assert 64 * tgpu.fft_time_s(n, h, word) == pytest.approx(
            want, rel=1e-12)
    # FourierPIM-8 against the modelled H100 at n = 4096, fp32: the
    # paper's closed forms on both sides
    ratio = (tpim.fft_throughput_per_s(4096, tpim.FOURIERPIM_8, tpim.FP32)
             / tgpu.fft_throughput_per_s(4096, h, word))
    assert 0.3 < ratio < 0.4
