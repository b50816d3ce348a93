"""Topology invariance of the production sharded enumeration: any mesh
size must reproduce the host path's BifEnumeration exactly."""
import numpy as np
import pytest

from sibelia_tpu.index.enumeration import enumerate_bifurcations
from sibelia_tpu.parallel.sharded import make_mesh
from sibelia_tpu.parallel.sharded_enum import enumerate_bifurcations_sharded


def _genome(seed, n=5000, muts=50, chroms=3):
    rng = np.random.default_rng(seed)
    base = rng.choice(list(b"ACGT"), size=n).astype(np.uint8)
    out = [bytes(base)]
    for _ in range(chroms - 1):
        mut = base.copy()
        pos = rng.integers(0, n, size=muts)
        mut[pos] = rng.choice(list(b"ACGT"), size=muts)
        out.append(bytes(mut))
    return out


def _assert_equal(a, b, ctx):
    assert a.count == b.count, ctx
    for s in (0, 1):
        assert np.array_equal(a.chr[s], b.chr[s]), ctx
        assert np.array_equal(a.pos[s], b.pos[s]), ctx
        assert np.array_equal(a.bif_id[s], b.bif_id[s]), ctx


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_sharded_matches_host(n_devices):
    chroms = _genome(7)
    mesh = make_mesh(n_devices)
    for k in (7, 30, 32, 33, 100):
        host = enumerate_bifurcations(chroms, k)
        shard = enumerate_bifurcations_sharded(chroms, k, mesh)
        _assert_equal(host, shard, (n_devices, k))


def test_sharded_all_t_runs():
    """Poly-T tracts collide with the in-band sentinel space; validity
    must travel out-of-band so all-T vertices still enumerate."""
    rng = np.random.default_rng(3)
    base = rng.choice(list(b"ACGT"), size=2000).astype(np.uint8)
    base[500:700] = ord("T")
    mut = base.copy()
    mut[100] = ord("A") if mut[100] != ord("A") else ord("C")
    mut[600] = ord("G")
    chroms = [bytes(base), bytes(mut)]
    mesh = make_mesh(8)
    for k in (16, 32, 40):
        host = enumerate_bifurcations(chroms, k)
        shard = enumerate_bifurcations_sharded(chroms, k, mesh)
        _assert_equal(host, shard, k)


def test_sharded_multi_chromosome_separators():
    """Many short chromosomes: separator-adjacent validity and terminal
    flags must agree across shard boundaries."""
    rng = np.random.default_rng(11)
    chroms = [bytes(rng.choice(list(b"ACGT"), size=ln).astype(np.uint8))
              for ln in (40, 300, 33, 220, 150)]
    chroms.append(chroms[1])  # exact duplicate chromosome
    mesh = make_mesh(8)
    for k in (5, 12, 31, 35):
        host = enumerate_bifurcations(chroms, k)
        shard = enumerate_bifurcations_sharded(chroms, k, mesh)
        _assert_equal(host, shard, k)


def test_sharded_pipeline_e2e_byte_identical(tmp_path, monkeypatch):
    """Full CLI run on an 8-virtual-device mesh vs single host: every
    output file byte-identical (SURVEY §2e: the sharded build is the
    production index path, not a demo)."""
    import filecmp

    from sibelia_tpu.cli.sibelia import run

    rng = np.random.default_rng(42)
    base = rng.choice(list(b"ACGT"), size=20000).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, len(mut), size=120)
    mut[pos] = rng.choice(list(b"ACGT"), size=120)
    # a structural event so blocks are non-trivial
    mut = np.concatenate([mut[:6000], mut[9000:12000][::-1], mut[6000:9000],
                          mut[12000:]])
    fasta = tmp_path / "in.fasta"
    with open(fasta, "w") as f:
        for name, arr in (("chrA", base), ("chrB", mut)):
            f.write(f">{name}\n")
            s = bytes(arr).decode()
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")
    stagefile = tmp_path / "stages.txt"
    stagefile.write_text("2\n30 150\n100 1000\n")

    out_host = tmp_path / "host"
    out_mesh = tmp_path / "mesh"
    monkeypatch.delenv("SIBELIA_TPU_SHARDED", raising=False)
    assert run(["-k", str(stagefile), "-m", "500", "--lastk", "100",
                "-o", str(out_host), str(fasta)]) == 0
    monkeypatch.setenv("SIBELIA_TPU_SHARDED", "8")
    assert run(["-k", str(stagefile), "-m", "500", "--lastk", "100",
                "-o", str(out_mesh), str(fasta)]) == 0
    monkeypatch.delenv("SIBELIA_TPU_SHARDED")

    for name in ("blocks_coords.txt", "coverage_report.txt",
                 "genomes_permutations.txt"):
        assert filecmp.cmp(out_host / name, out_mesh / name, shallow=False), name


def test_forced_device_k_over_32_uses_single_device_pipeline(monkeypatch):
    """k > 32 with device dispatch forced routes through the
    single-device doubling pipeline and matches the host path."""
    chroms = _genome(19, n=20000, muts=40, chroms=2)
    for k in (40, 100):
        host = enumerate_bifurcations(chroms, k)
        monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")
        dev = enumerate_bifurcations(chroms, k)
        monkeypatch.delenv("SIBELIA_TPU_DEVICE")
        _assert_equal(host, dev, k)


def test_sharded_enum_int32_boundary_gate():
    """A legal-size input (under the reference's 1 GB cap) whose
    supergenome exceeds int32 position space must be rejected by the
    sharded pipeline BEFORE any buffer is built, and the production
    router must fall back to the host path with a warning."""
    import warnings

    import pytest as _pytest

    class FakeChrom:
        def __len__(self):
            return 1 << 30  # 2 chromosomes -> supergenome > 2^31

    fake = [FakeChrom(), FakeChrom()]
    mesh = make_mesh(1)
    with _pytest.raises(ValueError, match="int32 position space"):
        enumerate_bifurcations_sharded(fake, 30, mesh)
