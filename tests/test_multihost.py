"""Multi-host (multi-process) runtime tests — SURVEY §4's prescription:
N processes x C virtual CPU devices form an N*C-device mesh without a
pod.  Each child process runs jax.distributed.initialize against a
local coordinator; the sharded enumeration must produce byte-identical
results across process boundaries (topology invariance), and a
('host','chip') shard_map collective must execute globally.
"""
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import hashlib, os, sys
sys.path.insert(0, %(root)r)
import numpy as np
from sibelia_tpu.parallel.runtime import init_distributed, host_chip_mesh, seq_mesh
assert init_distributed()
import jax
import jax.numpy as jnp
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

# (a) ('host','chip') mesh collective: psum over both axes
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map
mesh = host_chip_mesh()
assert mesh.devices.shape == (2, 4)
def body(x):
    return jax.lax.psum(jax.lax.psum(x, 'chip'), 'host')
f = jax.jit(shard_map(body, mesh=mesh,
                      in_specs=P('host', 'chip'), out_specs=P()))
x = jax.make_array_from_callback(
    (2, 4), NamedSharding(mesh, P('host', 'chip')),
    lambda idx: np.arange(8, dtype=np.float32).reshape(2, 4)[idx])
assert float(np.asarray(f(x))) == 28.0

# (b) sharded enumeration over the global 8-device mesh
from tests.test_native_engine import _rand_genomes
from sibelia_tpu.parallel.sharded_enum import enumerate_bifurcations_sharded
genomes = _rand_genomes(42, 3, 5000)
for k in (9, 40):
    enum = enumerate_bifurcations_sharded(genomes, k, seq_mesh())
    h = hashlib.sha256()
    h.update(np.int64(enum.count).tobytes())
    for s in (0, 1):
        h.update(np.ascontiguousarray(enum.chr[s]).tobytes())
        h.update(np.ascontiguousarray(enum.pos[s]).tobytes())
        h.update(np.ascontiguousarray(enum.bif_id[s]).tobytes())
    print("K%%d %%s" %% (k, h.hexdigest()), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_full_cli(tmp_path):
    """The COMPLETE CLI under 2 processes x 4 virtual devices: sharded
    enumeration across the process boundary, replicated simplification
    and block generation, process 0 writes — outputs byte-identical to
    the single-process run (VERDICT r4 #6)."""
    rng = np.random.default_rng(3)
    fasta = tmp_path / "g.fasta"
    with open(fasta, "w") as f:
        base = rng.choice(list("ACGT"), size=60000)
        for i in range(3):
            mut = base.copy()
            pos = rng.integers(0, len(mut), size=250)
            mut[pos] = rng.choice(list("ACGT"), size=250)
            f.write(">chr%d\n%s\n" % (i, "".join(mut)))

    def base_env():
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        return env

    # single-process baseline (same virtual topology on one process)
    out_single = tmp_path / "out_single"
    r = subprocess.run(
        [sys.executable, "-m", "sibelia_tpu.cli.sibelia", "-s", "fine",
         "-m", "500", "-o", str(out_single), str(fasta)],
        env=base_env(), capture_output=True, text=True, timeout=600,
        cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr[-3000:]

    port = _free_port()
    out_multi = tmp_path / "out_multi"
    procs = []
    for pid in range(2):
        env = base_env()
        env["SIBELIA_TPU_COORD"] = f"127.0.0.1:{port}"
        env["SIBELIA_TPU_NPROCS"] = "2"
        env["SIBELIA_TPU_PROC_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sibelia_tpu.cli.sibelia", "-s",
             "fine", "-m", "500", "-o", str(out_multi), str(fasta)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO_ROOT))
    for p in procs:
        try:
            _, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    for fn in ("blocks_coords.txt", "coverage_report.txt",
               "genomes_permutations.txt"):
        with open(out_single / fn, "rb") as a, \
                open(out_multi / fn, "rb") as b:
            assert a.read() == b.read(), fn


def test_two_process_cpu_mesh(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["SIBELIA_TPU_COORD"] = f"127.0.0.1:{port}"
        env["SIBELIA_TPU_NPROCS"] = "2"
        env["SIBELIA_TPU_PROC_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD % {"root": REPO_ROOT}],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO_ROOT))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        # keep only our hash lines (Gloo logs its rank handshakes on
        # stdout)
        outs.append([ln for ln in out.strip().splitlines()
                     if ln.startswith("K")])
    assert len(outs[0]) == 2, outs[0]

    # both processes computed identical enumeration hashes
    assert outs[0] == outs[1], (outs[0], outs[1])

    # ... and they match the single-process host enumeration exactly
    from tests.test_native_engine import _rand_genomes
    from sibelia_tpu.index.enumeration import enumerate_bifurcations
    genomes = _rand_genomes(42, 3, 5000)
    for line in outs[0]:
        k = int(line.split()[0][1:])
        enum = enumerate_bifurcations(genomes, k)
        h = hashlib.sha256()
        h.update(np.int64(enum.count).tobytes())
        for s in (0, 1):
            h.update(np.ascontiguousarray(enum.chr[s]).tobytes())
            h.update(np.ascontiguousarray(enum.pos[s]).tobytes())
            h.update(np.ascontiguousarray(enum.bif_id[s]).tobytes())
        assert line.split()[1] == h.hexdigest(), line
