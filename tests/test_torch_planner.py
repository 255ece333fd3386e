"""The port's planner (``repro_torch.core.fft.planner``) against the
reference planner's legacy mode (``repro.core.fft.planner``).

The plan's ``tier``, ``radix``, ``real`` and ``exact`` fields must equal
the reference's, field by field. ``block_b`` is re-derived for Hopper
shared memory and so differs from the reference's VMEM block on purpose;
the tests pin the port's own rule instead. Plans are exact values, so
every comparison is ``==``.
"""
import pytest

from repro.core import fft as jcore
from repro_torch.core import fft as tcore
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tntt
from repro_torch.kernels import polymul as tpoly

NS = [2, 4, 8, 64, 1024, 4096, 8192, 65536, 262144]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("product", [False, True])
def test_plan_fields_match_reference(n, real, product):
    """The reference planner has no product flag: its plan for a product
    is the transform plan, so both port plans are held against it."""
    got = tcore.plan(n, 64, real=real, product=product)
    want = jcore.plan(n, 64, real=real)
    assert (got.tier, got.radix, got.real) == \
        (want.tier, want.radix, want.real)
    assert got.product == product


@pytest.mark.parametrize("n", NS)
def test_plan_block_and_residency_are_the_hopper_rule(n):
    assert tcore.plan(n, 8).block_b == tfft.plan_batch_block(n)
    assert tcore.plan(n, 8, real=True).block_b == \
        tfft.plan_batch_block(n, real=True)
    assert tcore.plan(n, 8, product=True).block_b == \
        tpoly.default_complex_block(n)
    assert tcore.plan(n, 8, real=True, product=True).block_b == \
        tpoly.default_real_block(n)
    # the transforms run two passes from TWO_PASS_FROM (8192) on; a row
    # stays resident below that (it would fit one CTA up to 8192)
    assert tcore.plan(n, 8).resident == (n < tfft.TWO_PASS_FROM["fft"])
    assert tcore.plan(n, 8, real=True).resident == \
        (n < tfft.TWO_PASS_FROM["rfft"])
    # the products run their split-pass schedule from their own
    # TWO_PASS_FROM on (the real product from 4096); a pair of spectra fits
    # one CTA up to 4096
    assert tcore.plan(n, 8, product=True).resident == \
        (n < tfft.TWO_PASS_FROM["polymul_complex"])
    assert tcore.plan(n, 8, real=True, product=True).resident == \
        (n < tfft.TWO_PASS_FROM["polymul_real"])


def test_plan_describes_what_executes():
    """The description names the schedule that runs: resident rows, the
    FFT's and real FFT's two passes, the products' split-pass schedule
    (three launches where the mirrored split is on the sweep sequence, four
    at odd log2 n, radix 4), or a single CTA per row staged through device
    memory (past every split)."""
    assert "shared-memory resident" in tcore.plan(4096, 8).describe()
    assert "two-pass 256 x 256 (2 launches" in tcore.plan(65536, 8).describe()
    assert "two-pass 256 x 256" in \
        tcore.plan(65536, 8, real=True).describe()
    assert "two-pass 64 x 256" in tcore.plan(16384, 8).describe()
    for real in (False, True):
        assert "two-pass 256 x 256 (3 launches" in \
            tcore.plan(65536, 8, real=real, product=True).describe()
        assert "two-pass 512 x 256 (4 launches" in \
            tcore.plan(1 << 17, 8, real=real, product=True).describe()
    assert "single-CTA staged through device memory" in \
        tcore.plan(1 << 26, 8).describe()     # no radix-4 split fits
    assert "single-CTA staged through device memory" in \
        tcore.plan(1 << 26, 8, product=True).describe()
    assert "radix-4" in tcore.plan(4096, 8).describe()
    assert "paired inverse" in \
        tcore.plan(64, 8, real=True, product=True).describe()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("product", [False, True])
def test_plan_two_pass_is_the_kernels_schedule(n, real, product):
    """The plan records the split the wrappers launch
    (``kernels.fft.two_pass_plan``; for the products
    ``kernels.polymul.product_two_pass_plan``) and its launches per call."""
    p = tcore.plan(n, 64, real=real, product=product)
    radix = 4 if n >= 4 else 2
    launch = (tpoly.product_two_pass_plan(n, radix, real=real) if product
              else tfft.two_pass_plan(n, radix, real=real))
    if launch is None:
        assert p.two_pass is None and p.launches == 1
    else:
        assert p.two_pass == (launch.n1, launch.n2)
        assert p.launches == launch.launches == (
            2 if not product else 3 if launch.fused else 4)
        assert not p.resident


@pytest.mark.parametrize("bad", [48, 0, -8, 1536])
def test_plan_rejects_non_power_of_two_like_reference(bad):
    for planner in (tcore.plan, jcore.plan):
        with pytest.raises(ValueError):
            planner(bad, batch=8)


def test_plan_rejects_negative_batch_and_exact_real():
    for planner in (tcore.plan, jcore.plan):
        with pytest.raises(ValueError):
            planner(1024, batch=-1)
        with pytest.raises(ValueError, match="mutually exclusive"):
            planner(1024, batch=8, exact=True, real=True)


@pytest.mark.parametrize("n", NS + [524288])
def test_exact_plan_is_the_fused_ntt_product(n):
    """The exact tier is planned, as in the reference: local, radix 2,
    exact. Its block is the NTT product's Hopper rule (two uint32 operands
    in two ping-pong buffers, 16n bytes a row, against the block budget);
    below ``TWO_PASS_FROM["ntt_polymul"]`` a row stays resident (it would
    up to n = 8192), from it on the product takes its split-pass schedule:
    three launches, whatever the split, since radix 2 puts the mirrored
    split on the sweep sequence too."""
    got = tcore.plan(n, 64, exact=True)
    want = jcore.plan(n, 64, exact=True)
    assert (got.tier, got.radix, got.exact, got.real) == \
        (want.tier, want.radix, want.exact, want.real) == \
        ("local", 2, True, False)
    assert got.product
    rows = min(1024, max(1, 48 * 1024 // (16 * n)))
    assert got.block_b == tntt.plan_ntt_block(n) == \
        1 << (rows.bit_length() - 1)
    assert tntt.ntt_resident(n) == (n <= 8192)
    assert "NTT (exact mod-q)" in got.describe()
    launch = tntt.ntt_two_pass_plan(n)
    if n < tfft.TWO_PASS_FROM["ntt_polymul"]:
        assert launch is None and got.two_pass is None
        assert got.resident and got.launches == 1
        assert "shared-memory resident" in got.describe()
    else:
        assert got.two_pass == (launch.n1, launch.n2)
        assert got.launches == launch.launches == 3
        assert not got.resident
        assert (f"two-pass {launch.n1} x {launch.n2} (3 launches"
                in got.describe())
    with pytest.raises(ValueError, match="multi-device slice"):
        tcore.plan(n, 64, exact=True, model_shards=8)


@pytest.mark.parametrize("n", [4096, 65536])
def test_rns_plan_keeps_one_cta_per_row_block(n):
    """The multi-limb route's plan records ``rns_schedule``: at the serve
    cell's 4096 the register-step kernel, one CTA per row and limb (block
    1, one launch, resident); at 65536 the single-limb product's
    split-pass launches with the limb as grid row y (three launches).
    Below ``REGISTER_STEPS_FROM`` it keeps one CTA per row block, with the
    single-limb product's block."""
    got = tcore.plan(n, 64, exact=True, rns=True)
    sched = tntt.rns_schedule(n)
    assert got.launches == sched.launches
    if n < tfft.TWO_PASS_FROM["rns_ntt_polymul"]:
        assert sched == tntt.RNSRegisterSteps(n)
        assert got.register_steps and got.resident and got.block_b == 1
        assert got.two_pass is None and got.launches == 1
        assert "register steps" in got.describe()
    else:
        assert got.two_pass == (sched.n1, sched.n2) == \
            tcore.plan(n, 64, exact=True).two_pass
        assert got.launches == 3 and not got.resident
        assert not got.register_steps
    small = tfft.REGISTER_STEPS_FROM["rns_ntt_polymul"] // 2
    below = tcore.plan(small, 64, exact=True, rns=True)
    assert tntt.rns_schedule(small) is None
    assert below.two_pass is None and below.launches == 1
    assert below.block_b == tcore.plan(small, 64, exact=True).block_b
    assert below.resident == tntt.ntt_resident(small)
    assert not below.register_steps
    with pytest.raises(ValueError, match="exact=True"):
        tcore.plan(n, 64, rns=True)


@pytest.mark.parametrize("kw,slice_name", [
    ({"model_shards": 4}, "multi-device slice"),
    ({"workload": "fft", "verified": True}, "fault-tolerance slice"),
])
def test_unported_tiers_name_their_slice(kw, slice_name):
    """The reference plans these; the port raises and names the slice that
    will port them."""
    jcore.plan(1024, 8, **kw)
    with pytest.raises(ValueError, match="not yet ported") as exc:
        tcore.plan(1024, 8, **kw)
    assert slice_name in str(exc.value)


@pytest.mark.parametrize("workload", ["fft", "rfft", "polymul",
                                      "polymul-real", "polymul-mod"])
def test_auto_mode_plans_every_workload(workload):
    """``workload=`` plans, as the reference's auto mode does: the plan of
    the cost model's choice, with its breakdown on ``FFTPlan.cost``."""
    want = jcore.plan(1024, 8, workload=workload)
    got = tcore.plan(1024, 8, workload=workload)
    assert (got.tier, got.real, got.exact) == \
        (want.tier, want.real, want.exact)
    assert got.cost["workload"] == workload and got.cost["best"] is not None
