#!/usr/bin/env python
"""Benchmark: device enumeration throughput + measured baselines.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

Primary metric: k-mers/second through the FULL fused device enumeration
(packed-key sort + bifurcation group scan + instance selection — the
step that replaces the reference's divsufsort+LCP scan; see
sibelia_tpu/index/enumeration.py::_enum_device_k32).  Iterations chain
data-dependently with a forced scalar sync per step, so nothing can be
elided or overlapped.

vs_baseline is MEASURED, not estimated: the native host enumeration
kernel (sibelia_tpu/native/ranking.cpp — our C++ radix/prefix-doubling
engine, itself faster than the reference's divsufsort path) timed on the
same input on this machine.

extra carries: the host-baseline rate, the raw sort rates, a
virtual-mesh scaling table for the sharded production enumeration
(parallel/sharded_enum.py) at 1/2/4/8 devices (subprocess on the CPU
backend — shape of scaling, not device rates), the H. pylori end-to-end
wall-clock for our CLI vs the rebuilt reference binary when
`.ref_build/Sibelia` exists, and the 16-strain host e2e with output
identity against the original Sibelia binary's recorded hash.
"""
import json
import os
import subprocess
import sys
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _DIR)

import numpy as np


def _device_enum_rate():
    import jax
    import jax.numpy as jnp

    from sibelia_tpu.index.enumeration import _enum_device_impl

    k = 30
    n = 1 << 22
    reps = 8
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(1, 5, size=n, dtype=np.uint8))

    # `reps` full enumerations chained DATA-DEPENDENTLY inside one jit
    # (each iteration's result perturbs the next iteration's input, and
    # the final scalar is a function of every iteration), so XLA can
    # neither elide nor overlap them; one host sync per call.  Sustained
    # throughput = reps * n / wall.
    @jax.jit
    def step(codes):
        s_acc = jnp.int32(0)
        for _ in range(reps):
            pos, ids, n_sel, n_groups = _enum_device_impl(codes, k)
            s = n_sel + n_groups + pos[0] + jnp.int32(ids[0])
            s_acc = s_acc + s
            codes = jnp.where(
                codes == 0, codes,
                ((codes + (s & 1)) % 4 + 1).astype(jnp.uint8))
        return codes, s_acc

    _, s = step(codes)  # compile + warmup
    acc = int(s)        # forced device sync
    best = None
    for _ in range(4):
        t0 = time.time()
        _, s = step(codes)
        acc += int(s)       # sync: the scalar only exists when every
        dt = time.time() - t0  # chained enumeration has run
        best = dt if best is None else min(best, dt)
    return reps * n / best, acc


def _host_enum_rate():
    """Measured CPU baseline: the native host enumeration on the same
    input size (falls back to numpy ranking when g++ is unavailable)."""
    from sibelia_tpu.index.enumeration import build_supergenome
    import sibelia_tpu.native as nat

    rng = np.random.default_rng(0)
    half = (1 << 21) - 2
    chrom = bytes(rng.choice(list(b"ACGT"), size=half).astype(np.uint8))
    codes, bs = build_supergenome([chrom])
    n = codes.shape[0]
    best = None
    for _ in range(3):
        t0 = time.time()
        res = nat.enumerate_native(codes, bs, 1, 30)
        dt = time.time() - t0
        if res is None:
            return None
        best = dt if best is None else min(best, dt)
    return n / best


def _scaling_table():
    """Sharded-enumeration throughput at 1/2/4/8 virtual devices
    (subprocess: the CPU backend must own the process)."""
    script = r"""
import json, os, sys, time
import numpy as np
sys.path.insert(0, %r)
import jax
jax.config.update("jax_platforms", "cpu")
from sibelia_tpu.parallel.sharded import make_mesh
from sibelia_tpu.parallel.sharded_enum import enumerate_bifurcations_sharded
rng = np.random.default_rng(0)
base = rng.choice(list(b"ACGT"), size=1 << 20).astype(np.uint8)
mut = base.copy()
pos = rng.integers(0, len(mut), size=2000)
mut[pos] = rng.choice(list(b"ACGT"), size=2000)
chroms = [bytes(base), bytes(mut)]
n_kmers = 2 * sum(len(c) for c in chroms)
out = {}
for nd in (1, 2, 4, 8):
    mesh = make_mesh(nd)
    enumerate_bifurcations_sharded(chroms, 30, mesh)  # compile
    best = None
    for _ in range(2):
        t0 = time.time()
        enumerate_bifurcations_sharded(chroms, 30, mesh)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    out[str(nd)] = round(n_kmers / best / 1e6, 1)
print(json.dumps(out))
""" % (_DIR,)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags
                            + " --xla_force_host_platform_device_count=8"
                            ).strip()
    try:
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=900)
        return json.loads(r.stdout.strip().splitlines()[-1])
    except Exception:
        return None


def _e2e_hpylori():
    """Wall-clock ours vs the rebuilt reference binary (when present),
    with output identity computed in the same record (`-r` on both sides
    so N-randomization states match; identical flags to the golden
    parity gate, tests/test_golden_parity.py)."""
    fasta = ("/root/reference/examples/Sibelia/Helicobacter_pylori/"
             "Helicobacter_pylori.fasta")
    ref_bin = os.path.join(_DIR, ".ref_build", "Sibelia")
    if not (os.path.exists(fasta) and os.path.exists(ref_bin)):
        return None
    out = {}
    # The e2e rows time the host path: the subprocess is pinned to the
    # CPU backend (a device e2e row comes with the chip benchmark).
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SIBELIA_TPU_TIMINGS"] = "/tmp/bench_hp_timings.json"
    try:
        args = [sys.executable, "-m", "sibelia_tpu.cli.sibelia",
                "-s", "loose", "-m", "5000", "-r", "-o", "/tmp/bench_hp",
                fasta]
        subprocess.run(args, cwd=_DIR, env=env, capture_output=True,
                       timeout=600, check=True)  # warm caches / .so build
        best = None
        for _ in range(2):
            t0 = time.time()
            subprocess.run(args, cwd=_DIR, env=env, capture_output=True,
                           timeout=600, check=True)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        out["ours_s"] = round(best, 1)
        t0 = time.time()
        subprocess.run([ref_bin, "-s", "loose", "-m", "5000", "-r", "-o",
                        "/tmp/bench_hp_ref", fasta], capture_output=True,
                       timeout=600, check=True)
        out["reference_s"] = round(time.time() - t0, 1)
        out["speedup"] = round(out["reference_s"] / out["ours_s"], 2)
        with open("/tmp/bench_hp/blocks_coords.txt", "rb") as a, \
                open("/tmp/bench_hp_ref/blocks_coords.txt", "rb") as b:
            out["blocks_identical"] = a.read() == b.read()
        try:
            with open("/tmp/bench_hp_timings.json") as f:
                out["phase_split_s"] = json.load(f)
        except Exception:
            pass
    except Exception:
        return out or None
    return out


def _sort_floor_rate():
    """On-chip rate of the dominant primitive alone (the 2-key u32 sort
    with the aux/iota payload, exactly the shapes the fused enumeration
    sorts) — the attainable ceiling for any formulation built on XLA's
    sort.  Chained data-dependently like the main metric."""
    import jax
    import jax.numpy as jnp

    n = 1 << 22
    reps = 8
    rng = np.random.default_rng(1)
    k1 = jnp.asarray(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                     .astype(np.uint32))
    k2 = jnp.asarray(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                     .astype(np.uint32))

    @jax.jit
    def step(k1, k2):
        acc = jnp.uint32(0)
        iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
        aux = k1 ^ k2
        for _ in range(reps):
            s1, s2, sa, si = jax.lax.sort((k1, k2, aux, iota), num_keys=2,
                                          is_stable=False)
            acc = acc + s1[0] + s2[-1] + sa[0] + jnp.uint32(si[-1])
            k1 = s2 ^ acc
            k2 = s1
        return k1, acc

    @jax.jit
    def step1(k1):
        acc = jnp.uint32(0)
        iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
        for _ in range(reps):
            s1, si = jax.lax.sort((k1, iota), num_keys=1, is_stable=False)
            acc = acc + s1[0] + jnp.uint32(si[-1])
            k1 = s1 ^ acc
        return k1, acc

    def timeit(fn, *args):
        _, a = fn(*args)
        int(a)
        best = None
        for _ in range(3):
            t0 = time.time()
            _, a = fn(*args)
            int(a)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        return reps * n / best

    return timeit(step, k1, k2), timeit(step1, k1)


def _wave_device_rate():
    """Chained-dispatch chip rate of the device bulge-candidate kernel
    (walks/s over the instance table; SIBELIA_TPU_WAVE_DEVICE path)."""
    import jax
    import jax.numpy as jnp

    from sibelia_tpu.index.enumeration import (_candidate_scan,
                                               build_supergenome)
    from sibelia_tpu.index.enumeration import enumerate_bifurcations

    rng = np.random.default_rng(2)
    base = rng.choice(list(b"ACGT"), size=1 << 21).astype(np.uint8)
    mut = base.copy()
    pos = rng.integers(0, len(mut), size=20000)
    mut[pos] = rng.choice(list(b"ACGT"), size=20000)
    chroms = [bytes(base), bytes(mut)]
    os.environ["SIBELIA_TPU_DEVICE"] = "1"
    try:
        enum = enumerate_bifurcations(chroms, 30)
    finally:
        os.environ.pop("SIBELIA_TPU_DEVICE", None)
    codes, bs = build_supergenome(chroms)
    sg_all = []
    id_all = []
    for s in (0, 1):
        half = 0 if s == 0 else len(chroms)
        sg_all.append(bs[half + enum.chr[s]] + enum.pos[s])
        id_all.append(enum.bif_id[s])
    sg = np.concatenate(sg_all)
    ids = np.concatenate(id_all)
    order = np.argsort(sg, kind="stable")
    m = len(sg)
    bucket = 1 << (m - 1).bit_length()
    pos_p = np.full(bucket, len(codes), dtype=np.int32)
    ids_p = np.full(bucket, bucket, dtype=np.int32)
    pos_p[:m] = sg[order]
    ids_p[:m] = ids[order]
    pad = -(-len(codes) // 1024) * 1024
    codes_p = np.zeros(pad, dtype=np.uint8)
    codes_p[:len(codes)] = codes
    codes_d = jnp.asarray(codes_p)
    pos_d = jnp.asarray(pos_p)
    ids_d = jnp.asarray(ids_p)
    reps = 8

    @jax.jit
    def step(codes_d, pos_d, ids_d):
        acc = jnp.int32(0)
        for _ in range(reps):
            cand = _candidate_scan(codes_d, pos_d, ids_d, 30, 150,
                                   jnp.int32(m))
            c0 = jnp.sum(cand.astype(jnp.int32))
            acc = acc + c0
            # genuine data dependence: the next round's positions shift
            # by the (unknown to XLA) parity of this round's count
            pos_d = pos_d + (c0 & 1)
        return acc

    a = step(codes_d, pos_d, ids_d)
    int(a)
    best = None
    for _ in range(3):
        t0 = time.time()
        a = step(codes_d, pos_d, ids_d)
        int(a)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return reps * m / best


def _e2e_16strain():
    """16-strain 32 MB e2e (host path): a warm-up run (builds .so's,
    warms page cache), then two timed runs taking the best, with the
    per-phase wall-clock split attached and output identity against the
    original Sibelia binary's recorded blocks_coords.txt sha256."""
    import hashlib
    from chip_smoke import S16_REFERENCE_SHA256
    fasta = "/tmp/s16.fasta"
    if not os.path.exists(fasta):
        try:
            subprocess.run([sys.executable,
                            os.path.join(_DIR, "scripts", "gen_strains.py"),
                            fasta, "16"], timeout=1800, check=True,
                           capture_output=True)
        except Exception:
            return None
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SIBELIA_TPU_TIMINGS"] = "/tmp/bench_s16_timings.json"
    out = {}
    try:
        args = [sys.executable, "-m", "sibelia_tpu.cli.sibelia",
                "-s", "loose", "-o", "/tmp/bench_s16", fasta]
        subprocess.run(args, cwd=_DIR, env=env, capture_output=True,
                       timeout=1800, check=True)  # warm-up
        best = None
        for _ in range(2):
            t0 = time.time()
            subprocess.run(args, cwd=_DIR, env=env, capture_output=True,
                           timeout=1800, check=True)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        out["ours_s"] = round(best, 1)
        try:
            with open("/tmp/bench_s16_timings.json") as f:
                out["phase_split_s"] = json.load(f)
        except Exception:
            pass
        with open("/tmp/bench_s16/blocks_coords.txt", "rb") as f:
            out["blocks_identical"] = (hashlib.sha256(f.read()).hexdigest()
                                       == S16_REFERENCE_SHA256)
    except Exception:
        return None
    return out


def main():
    from sibelia_tpu.core.platform import enable_compile_cache
    enable_compile_cache()
    dev_rate, acc = _device_enum_rate()
    host_rate = _host_enum_rate()
    extra = {}
    if host_rate:
        extra["host_baseline_Mkmers_s"] = round(host_rate / 1e6, 1)
    try:
        sort_rate, pack_rate = _sort_floor_rate()
        extra["sort_only_Mrows_s"] = round(sort_rate / 1e6, 1)
        extra["pack_sort_Mrows_s"] = round(pack_rate / 1e6, 1)
    except Exception:
        pass
    try:
        wd = _wave_device_rate()
        extra["wave_device_candidate_Mwalks_s"] = round(wd / 1e6, 2)
    except Exception:
        pass
    fast = os.environ.get("SIBELIA_BENCH_FAST") == "1"
    scaling = None if fast else _scaling_table()
    if scaling:
        extra["sharded_virtual_cpu_mesh_Mkmers_s"] = scaling
    e2e = None if fast else _e2e_hpylori()
    if e2e:
        extra["e2e_hpylori"] = e2e
    s16 = None if fast else _e2e_16strain()
    if s16:
        extra["e2e_16strain"] = s16
    vs = round(dev_rate / host_rate, 1) if host_rate else None
    print(json.dumps({
        "metric": "fused_enumeration_throughput",
        "value": round(dev_rate / 1e6, 1),
        "unit": "Mkmers/s",
        "vs_baseline": vs,
        "extra": extra,
    }))
    return 0 if acc is not None else 1


if __name__ == "__main__":
    sys.exit(main())
