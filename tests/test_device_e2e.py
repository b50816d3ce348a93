"""Force-device end-to-end regression gates (VERDICT r3 weak #4/#5).

The production CPU path routes to the native host kernels; these tests
force SIBELIA_TPU_DEVICE=1 (on the CPU backend) through the FULL CLI so
the device routing — fused device enumeration, device candidate
prefilter, sharded fallbacks — is exercised end-to-end on every suite
run and cannot bit-rot unnoticed.  Plus: the device alignment batch
engine must actually take pairs on the device path (the silent
host-fallback accounting must show a nonzero device share).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fixture(tmp_path):
    rng = np.random.default_rng(99)
    base = rng.choice(list(b"ACGT"), size=20000).astype(np.uint8)
    seqs = [base]
    for i in range(2):
        mut = base.copy()
        pos = rng.integers(100, len(mut) - 100, size=60)
        mut[pos] = rng.choice(list(b"ACGT"), size=60)
        mut = np.concatenate(
            [mut[:7000 + 900 * i],
             rng.choice(list(b"ACGT"), size=11).astype(np.uint8),
             mut[7000 + 900 * i:]])
        seqs.append(mut)
    fa = tmp_path / "in.fasta"
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">chr%d\n%s\n" % (i, bytes(s).decode()))
    stagefile = tmp_path / "stages.txt"
    stagefile.write_text("2\n10 60\n20 200\n")
    return fa, stagefile


def _run_cli(fa, stagefile, outdir, extra_env):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env)
    r = subprocess.run(
        [sys.executable, "-m", "sibelia_tpu.cli.sibelia", "-k",
         str(stagefile), "-m", "100", "--lastk", "15", "-q",
         "-o", str(outdir), str(fa)],
        env=env, capture_output=True, text=True, timeout=420,
        cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-3000:]


def test_forced_device_e2e_matches_host(tmp_path):
    """Full CLI with SIBELIA_TPU_DEVICE=1 must produce byte-identical
    outputs to the host path."""
    fa, stagefile = _write_fixture(tmp_path)
    host_dir = tmp_path / "host"
    dev_dir = tmp_path / "dev"
    _run_cli(fa, stagefile, host_dir, {"SIBELIA_TPU_DEVICE": "0"})
    _run_cli(fa, stagefile, dev_dir, {"SIBELIA_TPU_DEVICE": "1"})
    names = sorted(os.listdir(host_dir))
    assert names == sorted(os.listdir(dev_dir))
    for name in names:
        a, b = host_dir / name, dev_dir / name
        if a.is_dir():
            for sub in sorted(os.listdir(a)):
                assert (a / sub).read_bytes() == (b / sub).read_bytes(), \
                    f"{name}/{sub}"
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_alignment_device_share_nonzero():
    """A representative unique-pair batch must dispatch at least one
    band DP on the device path (get_stats()['device_jobs'] > 0), with
    byte parity vs the host engine."""
    from sibelia_tpu.native import lagan_order, load_lagan
    if load_lagan() is None:
        pytest.skip("native LAGAN engine unavailable")
    from sibelia_tpu.align import lagan_exact
    from sibelia_tpu.kernels import order_device

    rng = np.random.default_rng(17)
    before = order_device.get_stats()
    jobs, host_rows = [], []
    for i in range(3):
        a = rng.choice(list(b"ACGT"), size=1200 + 80 * i).astype(np.uint8)
        b = a.copy()
        p = rng.integers(0, len(b), size=10)
        b[p] = rng.choice(list(b"ACGT"), size=10)
        sa, sb = bytes(a), bytes(b)
        anch = lagan_exact.rechaos(sa, "r", sb, "q", gfc=True)
        jobs.append((sa, "r", sb, "q", anch))
        host_rows.append(lagan_order(sa, "r", sb, "q", anch))
    rows = order_device.order_mfa_device_batch(jobs)
    after = order_device.get_stats()
    for got, want in zip(rows, host_rows):
        assert got == want
    assert after["device_jobs"] > before["device_jobs"], (before, after)
