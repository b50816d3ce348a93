"""Device-side bulge detection (SIBELIA_TPU_WAVE_DEVICE).

The sparse sweep's frozen-state detection pass (the reference's
second-hottest loop, bulgeremoval.cpp:158-218) runs as a device kernel
over the engine's exported instance table; any superset of "AnyBulges
reports a group" keeps the sweep byte-exact, so full-pipeline parity
with the host path is the correctness gate.
"""
import os

import numpy as np
import pytest

import sibelia_tpu.native as native
from sibelia_tpu.native import load


def _genomes(n_mut=90, size=9000, n_strains=2):
    rng = np.random.default_rng(77)
    base = rng.choice(list(b"ACGT"), size=size).astype(np.uint8)
    out = [bytes(base)]
    for s in range(n_strains - 1):
        mut = base.copy()
        pos = rng.integers(100, len(mut) - 100, size=n_mut)
        mut[pos] = rng.choice(list(b"ACGT"), size=n_mut)
        mut = np.concatenate(
            [mut[:4000 + 700 * s],
             rng.choice(list(b"ACGT"), size=9).astype(np.uint8),
             mut[4000 + 700 * s:]])
        out.append(bytes(mut))
    return out


def _run_stage(genomes, wave_device, monkeypatch, candidates="none"):
    from sibelia_tpu.graph.indexed import randomize_and_enumerate
    from sibelia_tpu.graph.sequence import MutableSequence
    from sibelia_tpu.native import simplify_native

    monkeypatch.setenv("SIBELIA_TPU_WAVE_DEVICE", wave_device)
    seq = MutableSequence(list(genomes))
    enum = randomize_and_enumerate(seq, 11, min_branch=80)
    cand = enum.candidates if candidates == "enum" else None
    n = simplify_native(seq, enum, 11, 80, 4, candidates=cand)
    return n, [c.tobytes() for c in seq.chars], \
        [np.asarray(op).tobytes() for op in seq.origpos]


@pytest.mark.parametrize("candidates", ["none", "enum"])
def test_wave_device_pipeline_parity(monkeypatch, candidates):
    """Byte parity of the full stage with the device detection on vs
    off — with candidates=None the INITIAL prefilter also routes to the
    device, so the kernel is exercised for both hook sites."""
    if load() is None:
        pytest.skip("native engine unavailable")
    genomes = _genomes()
    host = _run_stage(genomes, "0", monkeypatch, candidates)
    fired = [0]
    real = native._device_reprefilter

    def counting(*a, **kw):
        fired[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(native, "_device_reprefilter", counting)
    dev = _run_stage(genomes, "1", monkeypatch, candidates)
    assert dev == host
    if candidates == "none":
        assert fired[0] > 0  # the initial prefilter must have routed


def test_reprefilter_error_surfaces_from_sweep(monkeypatch):
    """An exception in the device re-prefilter cannot cross the native
    sweep's C frame; the wrapper must re-raise it after the sweep instead
    of finishing silently on the host prefilter."""
    if load() is None:
        pytest.skip("native engine unavailable")
    calls = [0]

    def broken(*a, **kw):
        calls[0] += 1
        raise RuntimeError("device prefilter failed")

    monkeypatch.setattr(native, "_device_reprefilter", broken)
    with pytest.raises(RuntimeError, match="device prefilter failed"):
        _run_stage(_genomes(), "1", monkeypatch)
    assert calls[0] == 1  # later callbacks stop asking the device


def test_reprefilter_error_fails_cli(monkeypatch, tmp_path, capsys):
    if load() is None:
        pytest.skip("native engine unavailable")
    from sibelia_tpu.cli.sibelia import run

    fa = tmp_path / "g.fasta"
    fa.write_text("".join(">c%d\n%s\n" % (i, g.decode())
                          for i, g in enumerate(_genomes())))

    def broken(*a, **kw):
        raise RuntimeError("device prefilter failed")

    monkeypatch.setattr(native, "_device_reprefilter", broken)
    monkeypatch.setenv("SIBELIA_TPU_WAVE_DEVICE", "1")
    rc = run(["-s", "fine", "-m", "500", "-o", str(tmp_path / "out"),
              str(fa)])
    assert rc != 0
    assert "device prefilter failed" in capsys.readouterr().err


def test_device_reprefilter_superset_of_truth(monkeypatch):
    """The device bitmap on a mid-simplification state must cover every
    id the serial AnyBulges reports (direct superset check against the
    ground truth on the FROZEN state after one iteration)."""
    if load() is None:
        pytest.skip("native engine unavailable")
    from tests.test_enumeration import _true_bulge_ids

    genomes = _genomes(n_mut=300, size=16000, n_strains=4)
    # freeze after one iteration by running max_iterations=1 with a
    # SHORT walk (d=25); truth is then re-derived at d=80, where the
    # longer walks still find bulges on the frozen state
    from sibelia_tpu.graph.indexed import randomize_and_enumerate
    from sibelia_tpu.graph.sequence import MutableSequence
    from sibelia_tpu.native import simplify_native
    monkeypatch.setenv("SIBELIA_TPU_WAVE_DEVICE", "0")
    seq = MutableSequence(list(genomes))
    enum = randomize_and_enumerate(seq, 11, min_branch=25)
    simplify_native(seq, enum, 11, 25, 1)
    frozen = [c.tobytes() for c in seq.chars]
    # ground truth on the frozen state (fresh enumeration = fresh ids)
    truth = _true_bulge_ids(frozen, 11, 80)
    # device bitmap over the same frozen state via a fresh engine
    lib = load()
    native._configure_reprefilter_api(lib)
    seq2 = MutableSequence([np.frombuffer(c, np.uint8).copy()
                            for c in frozen])
    from sibelia_tpu.index.enumeration import enumerate_bifurcations
    enum2 = enumerate_bifurcations([bytes(c) for c in frozen], 11)
    import ctypes
    n_chr = seq2.n_chr
    chr_lens = (ctypes.c_int64 * n_chr)(
        *[seq2.chr_len(c) for c in range(n_chr)])
    bufs = [np.ascontiguousarray(seq2.chars[c]) for c in range(n_chr)]
    ops = [np.ascontiguousarray(seq2.origpos[c], dtype=np.int32)
           for c in range(n_chr)]
    cptr = (ctypes.c_void_p * n_chr)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
    optr = (ctypes.c_void_p * n_chr)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in ops])
    sep = (ctypes.c_int64 * n_chr)(*seq2.sep_origpos)
    handle = lib.engine_create(n_chr, chr_lens, cptr, optr, sep)
    try:
        lens = np.asarray([seq2.chr_len(c) for c in range(n_chr)],
                          dtype=np.int64)
        packed = []
        for strand in (0, 1):
            # int32 coords / uint32 ids on the wire (engine_set_bifs ABI)
            chrs = enum2.chr[strand].astype(np.int32)
            poss = enum2.pos[strand].astype(np.int64)
            bids = enum2.bif_id[strand].astype(np.uint32)
            coords = poss if strand == 0 else (lens[chrs] - 1 - poss)
            packed.append((np.ascontiguousarray(chrs),
                           np.ascontiguousarray(coords.astype(np.int32)),
                           np.ascontiguousarray(bids)))
        (c0, p0, b0), (c1, p1, b1) = packed
        lib.engine_set_bifs(handle, enum2.count,
                            len(c0), c0.ctypes.data, p0.ctypes.data,
                            b0.ctypes.data, len(c1), c1.ctypes.data,
                            p1.ctypes.data, b1.ctypes.data)
        bm = native._device_reprefilter(lib, handle, n_chr, 11, 80,
                                        enum2.count)
    finally:
        lib.engine_destroy(handle)
    assert bm is not None
    flagged = set(np.flatnonzero(bm).tolist())
    missing = truth - flagged
    assert not missing, sorted(missing)[:5]
    assert truth  # fixture must contain bulges on the frozen state
