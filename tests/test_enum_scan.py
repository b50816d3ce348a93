"""Differential test: the fused enumeration's post-sort group scan
(index/enum_device.py::_segment_scan, the XLA cumsum/cummax pipeline)
vs a numpy oracle that applies the reference's bifurcation rule
(vertexenumeration.cpp:67-70,227-245) group by group."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from sibelia_tpu.index.enum_device import _segment_scan


def _oracle(k1, k2, aux, order, nv):
    """Per-group rule over the valid prefix [0, nv): returns (ids at
    selected rows, poskey, n_groups, n_sel)."""
    n = len(k1)
    poskey = np.full(n, n, np.int64)
    ids = np.full(n, -1, np.int64)
    next_id = 0
    i = 0
    while i < nv:
        j = i + 1
        while j < nv and k1[j] == k1[i] and k2[j] == k2[i]:
            j += 1
        prev = {int(a) >> 3 for a in aux[i:j]}
        nxt = {int(a) & 7 for a in aux[i:j]}
        bif = len(prev) > 1 or 0 in prev or len(nxt) > 1 or 0 in nxt
        terminal = 0 in prev or 0 in nxt
        if bif and (j - i > 1 or terminal):
            poskey[i:j] = order[i:j]
            ids[i:j] = next_id
            next_id += 1
        i = j
    sel = poskey < n
    return ids[sel], poskey, next_id, int(sel.sum())


def _segments(rng, n, max_len):
    k1 = np.zeros(n, np.uint32)
    k2 = np.zeros(n, np.uint32)
    i = v = 0
    while i < n:
        length = int(rng.integers(1, max_len + 1))
        k1[i:i + length] = v // 5
        k2[i:i + length] = v
        i += length
        v += 1
    return k1, k2


@pytest.mark.parametrize("seed,max_len,n", [(0, 8, 2048), (1, 1, 2048),
                                            (2, 300, 3072)])
def test_segment_scan_matches_oracle(seed, max_len, n):
    rng = np.random.default_rng(seed)
    k1, k2 = _segments(rng, n, max_len)
    prev = rng.integers(0, 5, size=n)
    nxt = rng.integers(0, 5, size=n)
    # runs of identical neighbors so uniform (non-bifurcating) groups occur
    same = rng.random(n) < 0.7
    prev = np.where(same, 2, prev)
    nxt = np.where(same, 3, nxt)
    aux = ((prev << 3) | nxt).astype(np.uint32)
    order = rng.permutation(n).astype(np.int32)
    nv = int(n - int(rng.integers(0, n // 3)))

    ids, poskey, ng, ns = _segment_scan(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(aux),
        jnp.asarray(order), jnp.int32(nv))
    r_ids, r_poskey, r_ng, r_ns = _oracle(k1, k2, aux, order, nv)
    assert int(ng) == r_ng
    assert int(ns) == r_ns
    assert np.array_equal(np.asarray(poskey), r_poskey)
    assert np.array_equal(np.asarray(ids)[r_poskey < n], r_ids)
    assert r_ns > 0
