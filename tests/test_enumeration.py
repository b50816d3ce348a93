import numpy as np
import pytest

from sibelia_tpu.index.enumeration import (
    enumerate_bifurcations,
    enumerate_bifurcations_oracle,
)
from sibelia_tpu.index.ranking import encode, kmer_ranks


def _random_genomes(rng, n_chr, lo, hi):
    return [
        bytes(rng.choice([65, 67, 71, 84], size=rng.integers(lo, hi)).astype(np.uint8))
        for _ in range(n_chr)
    ]


def test_kmer_ranks_matches_brute_force():
    # contract: ranks are exact (grouping + lex order) for *valid* k-mers
    # (windows not crossing a separator); invalid windows get sentinel
    # ranks that never equal a valid k-mer's rank
    rng = np.random.default_rng(0)
    s = bytes(rng.choice([35, 65, 67, 71, 84], size=200, p=[0.05, 0.25, 0.25, 0.25, 0.2]).astype(np.uint8))
    for k in (1, 2, 3, 5, 8, 13, 31, 40):
        codes = encode(s)
        rank, order = kmer_ranks(codes, k)
        n = len(s)
        kmers = [s[i:i + k] for i in range(n)]
        valid = [i for i in range(n - k + 1) if 35 not in kmers[i]]
        vset = set(valid)
        for i in valid:
            for j in range(n):
                if j == i:
                    continue
                same = bool(rank[i] == rank[j])
                if j in vset:
                    assert same == (kmers[i] == kmers[j]), (k, i, j)
                else:
                    assert not same, (k, i, j)
        by_rank = sorted(valid, key=lambda i: (rank[i], i))
        by_lex = sorted(valid, key=lambda i: (kmers[i], i))
        assert by_rank == by_lex


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [2, 3, 5, 11])
def test_enumeration_matches_oracle(seed, k):
    rng = np.random.default_rng(seed)
    chrs = _random_genomes(rng, rng.integers(1, 4), 20, 120)
    got = enumerate_bifurcations(chrs, k)
    want = enumerate_bifurcations_oracle(chrs, k)
    assert got.count == want.count
    for strand in (0, 1):
        np.testing.assert_array_equal(got.chr[strand], want.chr[strand])
        np.testing.assert_array_equal(got.pos[strand], want.pos[strand])
        np.testing.assert_array_equal(got.bif_id[strand], want.bif_id[strand])


def test_enumeration_k_larger_than_sequence():
    got = enumerate_bifurcations([b"ACGTACGT"], 50)
    assert got.count == 0


def test_enumeration_repeated_sequence():
    # two identical chromosomes: every k-mer is shared
    got = enumerate_bifurcations([b"ACGTTGCAACGT", b"ACGTTGCAACGT"], 4)
    want = enumerate_bifurcations_oracle([b"ACGTTGCAACGT", b"ACGTTGCAACGT"], 4)
    assert got.count == want.count
    for strand in (0, 1):
        np.testing.assert_array_equal(got.bif_id[strand], want.bif_id[strand])


def test_native_enumeration_matches_python_path():
    """The native C++ enumeration (ranking + group scan) must agree with
    the pure-Python path on supergenomes above the native threshold."""
    import random
    import numpy as np
    import sibelia_tpu.native as nat
    from sibelia_tpu.index import enumeration as E
    from sibelia_tpu.index import ranking as R

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    rng = random.Random(99)
    base = "".join(rng.choice("ACGT") for _ in range(50000))
    mut = list(base)
    for _ in range(400):
        mut[rng.randrange(len(mut))] = rng.choice("ACGT")
    chroms = [base.encode(), "".join(mut).encode()]
    for k in (24, 30, 64, 150):
        codes, bs = E.build_supergenome(chroms)
        res = nat.enumerate_native(codes, bs, len(chroms), k)
        assert res is not None
        count, strands = res
        saved = nat.enumerate_native
        nat.enumerate_native = lambda *a, **kw: None
        try:
            orig_ranks = R.kmer_ranks
            R.kmer_ranks = R.kmer_ranks_numpy
            try:
                py = E.enumerate_bifurcations(chroms, k)
            finally:
                R.kmer_ranks = orig_ranks
        finally:
            nat.enumerate_native = saved
        assert count == py.count
        for s in (0, 1):
            assert np.array_equal(strands[s][0], py.chr[s])
            assert np.array_equal(strands[s][1], py.pos[s])
            assert np.array_equal(strands[s][2], py.bif_id[s])


def _valid_mask(codes, k):
    import numpy as np
    n = len(codes)
    next_sep = np.full(n, n + 100)
    last = n + 100
    for i in range(n - 1, -1, -1):
        if codes[i] == 0:
            last = i
        next_sep[i] = last
    return (np.arange(n) + k) <= np.minimum(next_sep, n)


def _canon_partition(labels):
    """Relabel group labels by order of first occurrence, so two labelings
    compare equal iff they induce the same partition in the same order."""
    import numpy as np
    _, first_idx, inv = np.unique(labels, return_index=True,
                                  return_inverse=True)
    remap = np.empty(first_idx.size, dtype=np.int64)
    remap[np.argsort(first_idx)] = np.arange(first_idx.size)
    return remap[inv]


def _assert_valid_parity(codes, k, r1, o1, r2, o2):
    """Backend contract (see native/ranking.cpp): identical GROUPING of
    valid windows (equal rank <=> identical k-window) and identical
    valid-filtered sorted order.  Rank VALUES are not cross-backend
    stable: groups that mix valid and invalid members place the invalid
    members differently (numpy doubling splits by rank chains, the native
    LCP refinement parks them at the base rank), shifting valid classes'
    bucket-start values.  The enumeration filters invalid members from
    every group, so they carry no semantics."""
    import numpy as np
    valid = _valid_mask(codes, k)
    vi = np.flatnonzero(valid)
    assert np.array_equal(_canon_partition(r1[vi]),
                          _canon_partition(r2[vi])), k
    assert [i for i in o1 if valid[i]] == [i for i in o2 if valid[i]], k


def test_native_ranks_mixed_valid_invalid_group():
    """The mixed-group counterexample: a valid all-T 32-window collides
    with the sentinel key of invalid (separator-crossing) positions, so
    one initial group mixes valid and invalid members.  Grouping and
    filtered order must still agree between backends (rank values need
    not)."""
    import numpy as np
    import sibelia_tpu.native as nat
    from sibelia_tpu.index.ranking import kmer_ranks_numpy

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(11)
    # poly-T run abutting a separator (invalid tail windows) + the same
    # >=32-T run mid-sequence elsewhere (valid all-T windows)
    a = rng.integers(1, 5, size=4000).astype(np.uint8)
    a[1000:1040] = 4  # valid poly-T run
    b = rng.integers(1, 5, size=3000).astype(np.uint8)
    b[-40:] = 4       # poly-T run into the separator
    sep = np.zeros(1, dtype=np.uint8)
    codes = np.concatenate([sep, a, sep, b, sep])
    for k in (33, 40, 64):
        r1, o1 = kmer_ranks_numpy(codes, k)
        r2, o2 = nat.kmer_ranks_native(codes, k)
        _assert_valid_parity(codes, k, r1, o1, r2, o2)


def test_native_kmer_ranks_matches_numpy():
    import numpy as np
    import sibelia_tpu.native as nat
    from sibelia_tpu.index.ranking import kmer_ranks_numpy

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(5)
    codes = rng.integers(1, 5, size=300000).astype(np.uint8)
    codes[rng.integers(0, len(codes), size=10)] = 0
    for k in (8, 25, 32, 33, 100, 2000):
        r1, o1 = kmer_ranks_numpy(codes, k)
        r2, o2 = nat.kmer_ranks_native(codes, k)
        _assert_valid_parity(codes, k, r1, o1, r2, o2)


def test_native_kmer_ranks_collapsed_twins():
    """Twin-heavy input (two near-identical strains) drives the native
    LCP refinement's horizon batches; three-strain shared substitutions
    drive the recursive same-branch resolver."""
    import numpy as np
    import sibelia_tpu.native as nat
    from sibelia_tpu.index.ranking import kmer_ranks_numpy

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(7)
    base = rng.integers(1, 5, size=120000).astype(np.uint8)
    twin = base.copy()
    twin[rng.integers(0, len(twin), size=40)] = rng.integers(1, 5, size=40)
    third = base.copy()
    # same substitution as twin at one site (same-branch recursion), then
    # divergence further right
    third[500] = twin[500] = (base[500] % 4) + 1
    third[900] = (base[900] % 4) + 1
    sep = np.zeros(1, dtype=np.uint8)
    codes = np.concatenate([sep, base, sep, twin, sep, third, sep])
    for k in (33, 64, 100, 500, 2000):
        r1, o1 = kmer_ranks_numpy(codes, k)
        r2, o2 = nat.kmer_ranks_native(codes, k)
        _assert_valid_parity(codes, k, r1, o1, r2, o2)


def test_device_fused_path_matches_host(monkeypatch):
    """The single-sort device enumeration path (kmer_sorted_groups_jax)
    must agree with the host path on repetitive multi-chromosome input."""
    import numpy as np
    from sibelia_tpu.index import enumeration as E

    rng = np.random.default_rng(11)
    base = rng.choice(list(b"ACGT"), size=3000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, len(mut), size=25)
    mut[pos] = rng.choice(list(b"ACGT"), size=25)
    chroms = [bytes(base), bytes(mut), bytes(base[200:2200])]
    for k in (5, 11, 30, 32):
        host = E.enumerate_bifurcations(chroms, k)
        monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
        dev = E.enumerate_bifurcations(chroms, k)
        monkeypatch.delenv("SIBELIA_TPU_DEVICE")
        assert dev.count == host.count
        for s in (0, 1):
            assert np.array_equal(dev.chr[s], host.chr[s])
            assert np.array_equal(dev.pos[s], host.pos[s])
            assert np.array_equal(dev.bif_id[s], host.bif_id[s])


def _true_bulge_ids(chroms, k, min_branch):
    """Ground truth: ids where the serial AnyBulges finds >=1 group
    (graph/simplify semantics) at stage start."""
    import numpy as np
    from sibelia_tpu.graph import simplify as S
    from sibelia_tpu.graph.indexed import store_from_enum
    from sibelia_tpu.graph.sequence import MutableSequence
    from sibelia_tpu.index.enumeration import enumerate_bifurcations

    seq = MutableSequence(list(chroms),
                          [np.arange(len(c), dtype=np.int64) for c in chroms])
    enum = enumerate_bifurcations(list(chroms), k)
    store = store_from_enum(seq, enum)
    truth = set()
    for bif_id in range(store.max_id + 1):
        start_nodes = store.list_positions(bif_id)
        if len(start_nodes) < 2:
            continue
        end_char = []
        for idx in start_nodes:
            strand = int(store.node_strand[idx])
            c = int(store.node_chr[idx])
            pos = int(store.node_pos[idx])
            if S._proper_kmer(seq, strand, c, pos, k + 1):
                end_char.append(S._end_char(seq, strand, c, pos, k))
            else:
                end_char.append(S.EMPTY)
        if S._any_bulges(store, start_nodes, end_char, min_branch):
            truth.add(bif_id)
    return truth


def test_device_candidates_superset(monkeypatch):
    """The device bulge-candidate bitmap must cover every id where the
    serial AnyBulges reports a group (the sparse sweep driver skips
    non-candidates, so a miss would change output)."""
    import numpy as np
    from sibelia_tpu.index import enumeration as E

    rng = np.random.default_rng(23)
    base = rng.choice(list(b"ACGT"), size=4000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(100, len(mut) - 100, size=40)
    mut[pos] = rng.choice(list(b"ACGT"), size=40)
    # an indel bulge too
    mut = np.concatenate([mut[:1500], rng.choice(list(b"ACGT"), size=7).astype(np.uint8), mut[1500:]])
    chroms = [bytes(base), bytes(mut)]
    for k, d in ((7, 40), (15, 150), (25, 400)):
        truth = _true_bulge_ids(chroms, k, d)
        monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
        dev = E.enumerate_bifurcations(chroms, k, min_branch=d)
        monkeypatch.delenv("SIBELIA_TPU_DEVICE")
        assert dev.candidates is not None
        flagged = set(np.flatnonzero(dev.candidates).tolist())
        missing = truth - flagged
        assert not missing, (k, d, sorted(missing)[:5])
        assert truth, (k, d)  # the fixture must actually contain bulges


def test_pipeline_parity_with_device_candidates(monkeypatch):
    """Full simplification parity: the sparse engine driven by the
    device candidate bitmap must produce exactly the host result."""
    import numpy as np
    from sibelia_tpu.blocks.finder import BlockFinder
    from sibelia_tpu.io.fasta import FASTARecord

    rng = np.random.default_rng(31)
    base = rng.choice(list(b"ACGT"), size=6000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(100, len(mut) - 100, size=60)
    mut[pos] = rng.choice(list(b"ACGT"), size=60)
    recs = [FASTARecord(bytes(base).decode(), "a", 1),
            FASTARecord(bytes(mut).decode(), "b", 2)]

    def run_stages():
        bf = BlockFinder(list(recs))
        for (k, d) in ((10, 60), (20, 200)):
            bf.perform_graph_simplifications(k, d, 4)
        return bf.raw_seq, bf.original_pos

    host_seq, host_op = run_stages()
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
    dev_seq, dev_op = run_stages()
    monkeypatch.delenv("SIBELIA_TPU_DEVICE")
    for a, b in zip(host_seq, dev_seq):
        assert np.array_equal(a, b)
    for a, b in zip(host_op, dev_op):
        assert np.array_equal(a, b)


def test_native_kmer_ranks_blockmix_adversarial():
    """Shapes that stress the block-mix backend specifically: periodic
    sequences (giant buckets whose classes share deep prefixes, driving
    the class-rep lex comparator), exact tandem repeats (classes that
    survive at k >> 32), homopolymer runs, and buckets mixing valid and
    invalid windows near separators."""
    import numpy as np
    import sibelia_tpu.native as nat
    from sibelia_tpu.index.ranking import kmer_ranks_numpy

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(23)
    sep = np.zeros(1, dtype=np.uint8)

    period7 = np.tile(rng.integers(1, 5, size=7).astype(np.uint8), 800)
    unit = rng.integers(1, 5, size=97).astype(np.uint8)
    tandem = np.tile(unit, 60)
    homop = np.full(1500, 4, dtype=np.uint8)
    noise = rng.integers(1, 5, size=2000).astype(np.uint8)
    near = np.concatenate([unit, unit, unit[:50],
                           rng.integers(1, 5, size=5).astype(np.uint8),
                           unit[55:], unit])
    codes = np.concatenate([sep, period7, sep, tandem, sep, homop, sep,
                            noise, sep, near, sep])
    for k in (33, 48, 97, 194, 500, 1500):
        r1, o1 = kmer_ranks_numpy(codes, k)
        r2, o2 = nat.kmer_ranks_native(codes, k)
        _assert_valid_parity(codes, k, r1, o1, r2, o2)


def test_native_kmer_ranks_blockmix_vs_lcp_backend():
    """The two k>32 backends (block-mix default, LCP via
    SIBELIA_TPU_BLOCKMIX=0) must satisfy the same contract on the same
    inputs — checked via subprocesses because the backend flag is read
    once per process."""
    import subprocess
    import sys

    import numpy as np
    import sibelia_tpu.native as nat

    if nat.load_ranking() is None:
        import pytest
        pytest.skip("native engine unavailable")
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = r"""
import hashlib, sys
import numpy as np
sys.path.insert(0, %r)
import sibelia_tpu.native as nat
rng = np.random.default_rng(31)
base = rng.integers(1, 5, size=60000).astype(np.uint8)
twin = base.copy()
twin[rng.integers(0, len(twin), size=25)] = rng.integers(1, 5, size=25)
sep = np.zeros(1, dtype=np.uint8)
codes = np.concatenate([sep, base, sep, twin, sep])
h = hashlib.sha256()
for k in (33, 100, 999):
    r, o = nat.kmer_ranks_native(codes, k)
    # hash the contract surface: valid-position order + grouping
    n = len(codes)
    idx = np.arange(n)
    sep_idx = np.where(codes == 0, idx, n)
    next_sep = np.minimum.accumulate(sep_idx[::-1])[::-1]
    valid = (idx + k) <= next_sep
    ov = o[valid[o]]
    h.update(ov.astype(np.int64).tobytes())
    gstart = np.flatnonzero(np.concatenate(
        [[True], r[ov[1:]] != r[ov[:-1]]]))
    h.update(gstart.astype(np.int64).tobytes())
print(h.hexdigest())
""" % (repo,)
    import os
    outs = []
    for flag in ("1", "0"):
        env = dict(os.environ)
        env["SIBELIA_TPU_BLOCKMIX"] = flag
        env["JAX_PLATFORMS"] = "cpu"
        rr = subprocess.run([sys.executable, "-c", script], env=env,
                            capture_output=True, text=True, timeout=300)
        assert rr.returncode == 0, rr.stderr[-1500:]
        outs.append(rr.stdout.strip())
    assert outs[0] == outs[1], outs


def test_device_k32_homopolymer_matches_host(monkeypatch):
    """Regression: at k == 32 a genuine all-T (or, via rc, all-A)
    window has the same sort keys as the invalid-window sentinel; the
    device path must force a segment boundary at the valid-row count so
    the all-T group's verdict is not computed at an invalid row.  Both
    the XLA and Pallas (interpret) formulations are checked."""
    import numpy as np
    from sibelia_tpu.index import enumeration as E

    rng = np.random.default_rng(7)
    ctx = rng.choice(list(b"ACGT"), size=600).astype(np.uint8)
    # Two length-32 poly-T runs with IDENTICAL immediate flanks (G..C):
    # the T32 group then has uniform prev/next sets, is genuinely NOT a
    # bifurcation, and the buggy merged-sentinel verdict (invalid rows
    # carry separator-looking aux) would count it anyway.  A G..C-flanked
    # A32 run exercises the same case via the rc strand, and a 40-T run
    # covers the interior-window (genuinely-bifurcating) case.
    t32 = np.frombuffer(b"G" + b"T" * 32 + b"C", dtype=np.uint8)
    # every T32 window in the genome must share the G..C context (the
    # rc of t32 contributes A32 windows, a different group), so no other
    # poly-T/A run may appear anywhere
    ctx = ctx[~np.isin(ctx, np.frombuffer(b"TA", np.uint8))][:300]
    a = np.concatenate([ctx[:100], t32, ctx[100:200]])
    b = np.concatenate([ctx[50:150], t32, ctx[200:300]])
    chroms = [bytes(a), bytes(b)]
    for k in (30, 31, 32):
        host = E.enumerate_bifurcations(chroms, k)
        monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
        dev = E.enumerate_bifurcations(chroms, k)
        monkeypatch.delenv("SIBELIA_TPU_DEVICE")
        assert dev.count == host.count, k
        for s in (0, 1):
            assert np.array_equal(dev.chr[s], host.chr[s]), k
            assert np.array_equal(dev.pos[s], host.pos[s]), k
            assert np.array_equal(dev.bif_id[s], host.bif_id[s]), k
