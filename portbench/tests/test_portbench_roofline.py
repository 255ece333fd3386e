"""Bytes and operations a product equal their formulas."""
from __future__ import annotations

import pytest

from portbench.lib.spec import BENCH_DIR, load_json, load_module

RNS = load_module(BENCH_DIR / "roofline" / "rns_negacyclic.py")
REAL = load_module(BENCH_DIR / "roofline" / "real_circular.py")


def test_rlwe_counts():
    cfg = load_json(BENCH_DIR / "configs" / "rlwe-n4096-q109.json")
    assert RNS.bytes_per_product(cfg) == 2 * 9 * 4096 * 4 + 9 * 4096 * 4
    assert RNS.bytes_per_product(cfg) == 442_368
    assert RNS.ops_per_product(cfg) == 9 * (3 * 2048 * 12 + 4 * 4096)
    assert RNS.ops_per_product(cfg) == 811_008


def test_polyreal_counts():
    cfg = load_json(BENCH_DIR / "configs" / "polyreal-n16384-fp32.json")
    assert REAL.bytes_per_product(cfg) == 3 * 16384 * 4 == 196_608
    assert REAL.ops_per_product(cfg) == 1.5 * 5 * 16384 * 14 + 10 * 16384
    assert REAL.ops_per_product(cfg) == 1_884_160


@pytest.mark.parametrize("n,k", [(1024, 3), (65536, 60)])
def test_counts_scale_with_the_shapes(n, k):
    assert RNS.bytes_per_product({"n": n, "limbs": k}) == 12 * k * n
    assert REAL.bytes_per_product({"n": n}) == 12 * n


def test_peaks_name_the_card():
    peaks = load_json(BENCH_DIR / "roofline" / "peaks.json")["devices"]
    assert peaks["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12
