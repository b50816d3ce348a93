import numpy as np
import pytest

from sibelia_tpu.kernels.gotoh import batch_align
from sibelia_tpu.variants.aligner import _gotoh


def _rand_pair(rng, max_len=120):
    n = int(rng.integers(1, max_len))
    a = bytes(rng.choice([65, 67, 71, 84], size=n).astype(np.uint8))
    if rng.random() < 0.5:
        # related pair
        b = bytearray(a)
        for _ in range(max(1, n // 10)):
            i = int(rng.integers(0, len(b)))
            op = rng.integers(0, 3)
            if op == 0:
                b[i] = int(rng.choice([65, 67, 71, 84]))
            elif op == 1 and len(b) > 2:
                del b[i]
            else:
                b.insert(i, int(rng.choice([65, 67, 71, 84])))
        b = bytes(b)
    else:
        m = int(rng.integers(1, max_len))
        b = bytes(rng.choice([65, 67, 71, 84], size=m).astype(np.uint8))
    return a, b


def test_batch_align_matches_host_gotoh():
    rng = np.random.default_rng(0)
    pairs = [_rand_pair(rng) for _ in range(40)]
    got = batch_align(pairs, T=128)
    for (a, b), (ra, rb) in zip(pairs, got):
        ea, eb = _gotoh(a, b)
        assert (ra, rb) == (ea, eb), (a, b)


def test_batch_align_empty_sides():
    got = batch_align([(b"ACGT", b"ACGT"), (b"A", b"TTTT")], T=16)
    assert got[0] == ("ACGT", "ACGT")


def test_gap_batcher_flush_matches_host():
    """The device gap batcher (variants/aligner.py::_DeviceGapBatcher)
    closes deferred gaps through the vmapped batch; every slot must hold
    the host Gotoh alignment."""
    from sibelia_tpu.variants.aligner import _DeviceGapBatcher
    rng = np.random.default_rng(5)
    pairs = [_rand_pair(rng) for _ in range(12)]
    batcher = _DeviceGapBatcher()
    slots = [batcher.defer(a, b) for a, b in pairs]
    batcher.flush()
    assert batcher.pairs == [] and batcher.slots == []
    for (a, b), slot in zip(pairs, slots):
        assert tuple(slot) == _gotoh(a, b)
