"""Device anchors stage (align/anchors_device.py) vs the native C++
sweep (native/lagan_anchors.cpp): byte-for-byte differential on random
hit sets (with coordinate/score ties) and on real chaos outputs."""
import os

import numpy as np
import pytest

from sibelia_tpu.align.anchors_device import anchors_text_device
from sibelia_tpu.native import lagan_anchors, lagan_chaos, load_lagan

pytestmark = pytest.mark.skipif(load_lagan() is None,
                                reason="native lagan engine unavailable")


def _hit_line(a_s, a_e, b_s, b_e, score):
    return "seq1 %d %d; seq2 %d %d; score = %.1f (+)\n" % (
        a_s, a_e, b_s, b_e, score)


def _random_hits(rng, n, tie_heavy=False):
    lines = []
    for _ in range(n):
        a_s = int(rng.integers(0, 500))
        b_s = int(rng.integers(0, 500))
        ln = int(rng.integers(1, 40))
        if tie_heavy:
            # coarse grids force equal coordinates and equal scores
            a_s = (a_s // 25) * 25
            b_s = (b_s // 25) * 25
            ln = 20
            score = float(rng.integers(1, 4)) * 10.0
        else:
            score = float(rng.integers(-5, 80))
        lines.append(_hit_line(a_s, a_s + ln, b_s, b_s + ln, score))
    return "".join(lines)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_random_differential(seed, tie_heavy):
    rng = np.random.default_rng(seed)
    text = _random_hits(rng, int(rng.integers(1, 60)), tie_heavy)
    for gfc in (False, True):
        want = lagan_anchors(text, gfc=gfc)
        got = anchors_text_device(text, gfc=gfc)
        assert got == want, (seed, tie_heavy, gfc)


def test_gfc_chunk_expansion():
    """-gfc chunk lines attach to the preceding hit (reversed) and the
    chain walk expands them (anchors.c:254-266, 167-191)."""
    text = (_hit_line(10, 49, 12, 51, 90.0)
            + "10 12 20 55\n"
            + "31 33 19 35\n"
            + _hit_line(60, 79, 70, 89, 50.0))
    want = lagan_anchors(text, gfc=True)
    got = anchors_text_device(text, gfc=True)
    assert got == want
    assert "55" in got  # chunk scores survive into the output


def test_real_chaos_output():
    """End-to-end: chaos hits from divergent sequences through both
    anchors backends, byte-equal."""
    rng = np.random.default_rng(123)
    base = rng.choice(list(b"ACGT"), size=4000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, len(mut), size=120)
    mut[pos] = rng.choice(list(b"ACGT"), size=120)
    t1 = len(base) + 1
    t2 = len(mut) + 1
    hits = lagan_chaos(bytes(base), "seq1", bytes(mut), "seq2",
                       f"-s1 1 {t1} -s2 1 {t2}\n", 12, 0, 6, 0,
                       gfc=True, ext=True)
    assert hits
    for gfc in (False, True):
        want = lagan_anchors(hits, gfc=gfc)
        got = anchors_text_device(hits, gfc=gfc)
        assert got == want


def test_stats_count_device_and_fallback(monkeypatch):
    """Every device sweep and every refused input (b_e < b_s, which the
    caller hands to the native stage) is counted, so a host fallback in
    the anchors stage is visible."""
    from sibelia_tpu.align import anchors_device as AD
    from sibelia_tpu.align.lagan_exact import _anchors_stage

    good = _hit_line(10, 40, 12, 42, 30.0)
    bad = _hit_line(10, 40, 50, 20, 30.0)
    s0 = AD.get_stats()
    assert anchors_text_device(good) is not None
    monkeypatch.setenv("SIBELIA_TPU_ANCHORS_DEVICE", "1")
    assert _anchors_stage(bad, True) == lagan_anchors(bad, gfc=True)
    s1 = AD.get_stats()
    assert s1["device_jobs"] - s0["device_jobs"] == 1
    assert s1["host_fallback"] - s0["host_fallback"] == 1
