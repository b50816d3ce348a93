#!/usr/bin/env python3
"""Smoke test: Sibelia and C-Sibelia end to end on an NVIDIA GPU.

Run from the repository root on a machine with a card:

    python chip_smoke.py             # one card, every phase below
    python chip_smoke.py --chips 4   # four cards: the mesh path only

Phases (any failure exits non-zero; no exception becomes a success):

1. Device check: JAX's first device must be a GPU.
2. Native engines: the three C++ libraries build and load, so every host
   reference below is the native engine, not the pure-Python fallback.
3. Kernel checks at the widths of the 16-strain set, each against its
   host reference: the fused enumeration (k = 30 and 32), the k > 32
   enumeration on a 1-device mesh (k = 100), the bulge-candidate
   prefilter, the device k-mer ranks, the LAGAN order band DP batch and
   the LAGAN anchors sweep.  Every device computation is integer
   arithmetic except the anchors sweep (float32 add and max, no
   multiply-add, no matrix product), so every comparison is identity
   with zero tolerance.
4. Sibelia end to end, in process, on 16 generated ~2 Mbp strains:
   blocks_coords.txt must hash to the original Sibelia binary's output
   on this input, and the device round-trip counters must be non-zero.
5. C-Sibelia end to end, in process, on a generated 2.8 Mbp pair: the
   VCF must equal, byte for byte, a host run of the same command in a
   CPU-pinned subprocess (SIBELIA_TPU_DEVICE=0).

With --chips 4 only phases 1, 2, 4 and 5 run, with SIBELIA_TPU_SHARDED=4:
the sharded enumeration, the sharded sweep prefilter and the C-Sibelia
order batch over a 4-card mesh, held to the same hash and host VCF.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

# sha256 of blocks_coords.txt written by the original Sibelia binary for
# `Sibelia -s loose s16.fasta`, s16.fasta = `scripts/gen_strains.py
# s16.fasta 16` (docs/PARITY.md)
S16_REFERENCE_SHA256 = (
    "24f36d9cb745e474fe40df515269c37b018b81ddb49c8e5583ab658980882ed0")
PAIR_SIZE = 2_800_000  # S. aureus, C-Sibelia's bundled example
# block-pair lengths of the order/anchors checks (C-Sibelia blocks)
ORDER_PAIR_SIZES = (10_000, 30_000, 60_000)

COMPILES = {"requests": 0, "cache_hits": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def _count_compiles():
    import jax

    def on_duration(event, duration, **kw):
        # every compile request, whether XLA compiled or the persistent
        # cache supplied the program
        if event == "/jax/core/compile/backend_compile_duration":
            COMPILES["requests"] += 1

    def on_event(event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            COMPILES["cache_hits"] += 1

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    jax.monitoring.register_event_listener(on_event)


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"memory_analysis: args {m.argument_size_in_bytes} B, "
            f"outputs {m.output_size_in_bytes} B, "
            f"temp {m.temp_size_in_bytes} B")


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device(chips: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (first device: "
                 f"{devs[0].platform}); nothing was checked")
    if len(devs) < chips:
        sys.exit(f"chip_smoke: {chips} GPUs requested, {len(devs)} found")
    from sibelia_tpu.core.platform import device_dispatch, enable_compile_cache
    cache = enable_compile_cache()
    _count_compiles()
    if not device_dispatch():
        sys.exit("chip_smoke: device_dispatch() is off on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", "; ")
    log(f"[device] {smi} | device_kind {devs[0].device_kind} | "
        f"{len(devs)} device(s) | jax {jax.__version__} | "
        f"compile cache {cache}")
    return devs


def phase_native():
    from sibelia_tpu import native

    t0 = time.time()
    for name, loader in (("libsibelia_engine", native.load),
                         ("libsibelia_ranking", native.load_ranking),
                         ("liblagan_engine", native.load_lagan)):
        if loader() is None:
            sys.exit(f"chip_smoke: {name} failed to build or load "
                     f"(g++ on {native._DIR})")
    log(f"[native] 3 engines built and loaded in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _start_gen(name: str, *args) -> tuple[str, subprocess.Popen | None]:
    """Start scripts/gen_strains.py unless its output exists (it is
    deterministic; written under a temporary name, then renamed)."""
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, name)
    if os.path.exists(path):
        return path, None
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "gen_strains.py"),
         path + ".part", *map(str, args)], stdout=subprocess.DEVNULL)
    return path, proc


def _finish_gen(path: str, proc) -> str:
    if proc is not None:
        if proc.wait() != 0:
            sys.exit(f"chip_smoke: generating {path} failed")
        os.replace(path + ".part", path)
    return path


def _split_pair(pair: str) -> tuple[str, str]:
    from sibelia_tpu.io.fasta import read_fasta
    recs = read_fasta(pair)
    paths = []
    for rec, name in zip(recs, ("reference.fasta", "assembly.fasta")):
        p = os.path.join(WORK, name)
        with open(p, "w") as f:
            f.write(f">{rec.description}\n")
            for j in range(0, len(rec.sequence), 80):
                f.write(rec.sequence[j:j + 80] + "\n")
        paths.append(p)
    return paths[0], paths[1]


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------

def _same(label: str, ok: bool, seconds: float, mem: str) -> None:
    if not ok:
        sys.exit(f"chip_smoke: {label}: device result differs from the "
                 f"host reference")
    log(f"[kernel] {label}: {seconds:.2f} s | {mem} | identical: true "
        f"(byte identity, tolerance 0)")


def _same_enum(a, b) -> bool:
    import numpy as np
    return a.count == b.count and all(
        np.array_equal(x[s], y[s])
        for x, y in ((a.chr, b.chr), (a.pos, b.pos), (a.bif_id, b.bif_id))
        for s in (0, 1))


def _host_enum(codes, block_starts, n_chr, k):
    from sibelia_tpu.index.enumeration import BifEnumeration
    from sibelia_tpu.native import enumerate_native
    count, st = enumerate_native(codes, block_starts, n_chr, k)
    return BifEnumeration(count, (st[0][0], st[1][0]), (st[0][1], st[1][1]),
                          (st[0][2], st[1][2]))


def check_fused_enum(chroms, codes, block_starts, k: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from sibelia_tpu.index import enumeration as E
    from sibelia_tpu.index.enum_device import _enum_device_k32
    from sibelia_tpu.index.ranking import pad_rows

    n = codes.shape[0]
    pad_to = pad_rows(n)
    codes_d = jnp.asarray(np.concatenate(
        [codes, np.zeros(pad_to - n, np.uint8)]))
    t0 = time.time()
    compiled = _enum_device_k32.lower(codes_d, k).compile()
    t_compile = time.time() - t0
    t0 = time.time()
    out = jax.block_until_ready(_enum_device_k32(codes_d, k))
    t_run = time.time() - t0
    del out
    dev = E.enumerate_bifurcations(chroms, k)
    host = _host_enum(codes, block_starts, len(chroms), k)
    _same(f"fused enumeration k={k} n={pad_to} (compile {t_compile:.1f} s)",
          _same_enum(dev, host), t_run, _mem(compiled))
    return codes_d, dev.count


def check_sharded_enum(chroms, codes, block_starts, k: int):
    import jax
    import numpy as np
    from sibelia_tpu.index import enumeration as E
    from sibelia_tpu.parallel import sharded_enum as SE

    t0 = time.time()
    dev = E.enumerate_bifurcations(chroms, k)  # 1-device mesh for k > 32
    t_first = time.time() - t0
    # the step the wrapper compiled (same sizing as the wrapper's first try)
    mesh = SE.production_mesh(1)
    L = SE.shard_len(codes.shape[0], 1, k)
    run = SE._compiled_step(k, L, 1, "seq", L, L, L, id(mesh))
    codes_dev = jax.device_put(
        np.concatenate([codes, np.zeros(L - codes.shape[0], np.uint8)])
        .reshape(1, L), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("seq", None)))
    mem = _mem(run.lower(codes_dev).compile())
    t0 = time.time()
    jax.block_until_ready(run(codes_dev))
    t_run = time.time() - t0
    host = _host_enum(codes, block_starts, len(chroms), k)
    _same(f"1-device sharded enumeration k={k} n={L} (first call incl. "
          f"compile {t_first:.1f} s)", _same_enum(dev, host), t_run, mem)


def check_candidates(codes_d, chroms, k: int, min_branch: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from sibelia_tpu.index.enum_device import _candidate_scan, _enum_device_k32

    pos_d, id_d, n_sel_d, _ = _enum_device_k32(codes_d, k)
    ns = int(n_sel_d)
    bucket = min(1 << max(10, (ns - 1).bit_length()), int(pos_d.shape[0]))
    args = (codes_d, pos_d[:bucket], id_d[:bucket], k, min_branch, n_sel_d)
    t0 = time.time()
    compiled = _candidate_scan.lower(*args).compile()
    t_compile = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(_candidate_scan(*args))
    t_run = time.time() - t0
    # same jitted function on the CPU backend, on a real slice of the
    # position-sorted instance table (ids renumbered densely)
    S = min(1 << 20, ns)
    pos = np.asarray(pos_d[:S])
    _, ids = np.unique(np.asarray(id_d[:S]), return_inverse=True)
    ids = ids.astype(np.int32)
    codes_h = np.asarray(codes_d)
    cpu = jax.devices("cpu")[0]
    on_gpu = np.asarray(_candidate_scan(codes_d, jnp.asarray(pos),
                                        jnp.asarray(ids), k, min_branch,
                                        jnp.int32(S)))
    on_cpu = np.asarray(_candidate_scan(
        jax.device_put(codes_h, cpu), jax.device_put(pos, cpu),
        jax.device_put(ids, cpu), k, min_branch,
        jax.device_put(np.int32(S), cpu)))
    _same(f"candidate prefilter B={bucket} n_sel={ns} d={min_branch} "
          f"(compile {t_compile:.1f} s; GPU vs CPU backend on {S} rows)",
          np.array_equal(on_gpu, on_cpu) and on_gpu.any(), t_run,
          _mem(compiled))


def check_ranks(codes, k: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from sibelia_tpu.index.ranking import (_kmer_ranks_jax, kmer_ranks_numpy,
                                           pad_rows)
    from sibelia_tpu.index.ranking_device import _packed_keys, _rank_sort_u32

    n = codes.shape[0]
    pad_to = pad_rows(n)
    keys = _packed_keys(jnp.asarray(np.concatenate(
        [codes, np.zeros(pad_to - n, np.uint8)])), k)[:2]
    mem = _mem(_rank_sort_u32.lower(keys, pad_to).compile())
    del keys
    t0 = time.time()
    rank_d, order_d = _kmer_ranks_jax(codes, k)
    t_run = time.time() - t0
    rank_h, order_h = kmer_ranks_numpy(codes, k)
    idx = np.arange(n, dtype=np.int64)
    sep = np.where(codes == 0, idx, n)
    valid = idx + k <= np.minimum.accumulate(sep[::-1])[::-1]

    def contract(rank, order):  # valid-window order and grouping
        ov = order[valid[order]]
        r = rank[ov]
        return ov, r[1:] != r[:-1]

    (od, gd), (oh, gh) = contract(rank_d, order_d), contract(rank_h, order_h)
    _same(f"device k-mer ranks k={k} n={pad_to}",
          np.array_equal(od, oh) and np.array_equal(gd, gh), t_run, mem)


def _pairs(sizes, seed=11):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for size in sizes:
        a = rng.choice(list(b"ACGT"), size=size).astype(np.uint8)
        b = a.copy()
        snp = rng.integers(0, size, size=size * 6 // 1000)
        b[snp] = rng.choice(list(b"ACGT"), size=snp.size)
        for _ in range(size // 2000):  # small indels
            p = int(rng.integers(100, b.size - 100))
            ln = int(rng.integers(1, 30))
            b = (np.delete(b, np.s_[p:p + ln]) if rng.random() < 0.5 else
                 np.insert(b, p, rng.choice(list(b"ACGT"), size=ln)))
        out.append((bytes(a), bytes(b.astype(np.uint8))))
    return out


def check_order(pairs):
    import jax
    import numpy as np
    from sibelia_tpu.align import lagan_exact
    from sibelia_tpu.kernels import order_device as OD
    from sibelia_tpu.native import lagan_order, load_lagan

    jobs = [(a, "r", b, "q", lagan_exact.rechaos(a, "r", b, "q"))
            for a, b in pairs]
    # the largest padded batch shape the batch groups into
    lib = load_lagan()
    shapes = []
    for a, _, b, _, anch in jobs:
        job = OD._prepare_job(lib, a, b, anch, 8192)
        if job is not None:
            shapes.append((job.wmax, job.nd_pad,
                           OD._bucket(job.s1c.shape[0], 4096),
                           OD._bucket(job.s2c.shape[0], 4096)))
            lib.le_order_release(job.handle)
    wmax, nd_pad, l1, l2 = max(shapes)
    sd = jax.ShapeDtypeStruct
    mem = "largest group, 1 pair: " + _mem(OD._scan_fn_batched(wmax, nd_pad).lower(
        sd((1, l1), np.int32), sd((1, l2), np.int32),
        sd((1, nd_pad, 9), np.int32), *[sd((1, wmax), np.int32)] * 3)
        .compile())
    before = OD.get_stats()["device_jobs"]
    t0 = time.time()
    dev = OD.order_mfa_device_batch(jobs)
    t_run = time.time() - t0
    host = [lagan_order(a, n1, b, n2, anch) for a, n1, b, n2, anch in jobs]
    ran = OD.get_stats()["device_jobs"] - before
    _same(f"LAGAN order band DP batch, {len(jobs)} pairs of "
          f"{[len(a) for a, _ in pairs]} bp ({ran} on device; largest "
          f"scan {nd_pad} diagonals x {wmax} lanes)",
          dev == host and ran == len(jobs), t_run, mem)


def check_anchors(pairs, dev0):
    from sibelia_tpu.align import anchors_device as AD
    from sibelia_tpu.native import lagan_anchors, lagan_chaos

    t_run = 0.0
    same = True
    n_hits = []
    for a, b in pairs:
        hits = lagan_chaos(a, "r", b, "q", f"-s1 1 {len(a)} -s2 1 {len(b)}\n",
                           12, 0, 25, 0, gfc=True, ext=True)
        n_hits.append(hits.count("score"))
        t0 = time.time()
        dev = AD.anchors_text_device(hits, gfc=True)
        t_run += time.time() - t0
        same = same and dev == lagan_anchors(hits, gfc=True)
    peak = (dev0.memory_stats() or {}).get("peak_bytes_in_use")
    _same(f"LAGAN anchors sweep, {n_hits} hits ({AD.get_stats()})",
          same, t_run, f"process device peak so far {peak} B")


def phase_kernels(s16: str, dev0):
    from sibelia_tpu.index.enumeration import build_supergenome
    from sibelia_tpu.io.fasta import read_fasta

    t_phase = time.time()
    chroms = [r.sequence.encode() for r in read_fasta(s16)]
    codes, block_starts = build_supergenome(chroms)
    log(f"[kernel] 16-strain supergenome: {codes.shape[0]} rows")
    codes_d = None
    for k in (30, 32):
        codes_d, _ = check_fused_enum(chroms, codes, block_starts, k)
    check_candidates(codes_d, chroms, 30, 150)
    del codes_d
    check_sharded_enum(chroms, codes, block_starts, 100)
    check_ranks(codes, 30)
    del codes, block_starts, chroms
    pairs = _pairs(ORDER_PAIR_SIZES)
    check_order(pairs)
    check_anchors(pairs, dev0)
    log(f"[kernel] phase: {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 4-5: the two programs end to end
# ---------------------------------------------------------------------------

def phase_sibelia(s16: str):
    from sibelia_tpu.cli import sibelia
    from sibelia_tpu.core import timings
    from sibelia_tpu.core.platform import SYNC_COUNTS
    from sibelia_tpu.native import REPREFILTER_STATS

    out = os.path.join(WORK, "sibelia_out")
    timings.reset()
    SYNC_COUNTS.clear()
    c0 = dict(COMPILES)
    t0 = time.time()
    rc = sibelia.run(["-s", "loose", "-o", out, s16])
    wall = time.time() - t0
    if rc != 0:
        sys.exit(f"chip_smoke: Sibelia exited {rc}")
    sha = _sha256(os.path.join(out, "blocks_coords.txt"))
    log(f"[sibelia] 16 strains, -s loose: wall {wall:.1f} s | phases "
        f"{json.dumps(timings.snapshot(), sort_keys=True)}")
    log(f"[sibelia] syncs {json.dumps(SYNC_COUNTS, sort_keys=True)} | "
        f"re-prefilter {REPREFILTER_STATS} | compile requests "
        f"{COMPILES['requests'] - c0['requests']}, of them persistent-cache "
        f"hits {COMPILES['cache_hits'] - c0['cache_hits']}")
    if sum(SYNC_COUNTS.values()) == 0:
        sys.exit("chip_smoke: Sibelia made no device round trip")
    if sha != S16_REFERENCE_SHA256:
        sys.exit(f"chip_smoke: blocks_coords.txt sha256 {sha} != original "
                 f"Sibelia {S16_REFERENCE_SHA256}")
    log(f"[sibelia] blocks_coords.txt sha256 {sha} == original Sibelia "
        f"binary's: true")


def phase_csibelia(pair: str):
    from sibelia_tpu.align import anchors_device as AD
    from sibelia_tpu.cli import csibelia
    from sibelia_tpu.kernels import order_device as OD

    ref, asm = _split_pair(pair)
    dev_out = os.path.join(WORK, "csibelia_dev")
    host_out = os.path.join(WORK, "csibelia_host")
    env = dict(os.environ, JAX_PLATFORMS="cpu", SIBELIA_TPU_DEVICE="0",
               CUDA_VISIBLE_DEVICES="")
    env.pop("SIBELIA_TPU_SHARDED", None)
    # the host reference never touches a card, so it runs beside the
    # device run (the phase's wall time includes that overlap)
    host = subprocess.Popen(
        [sys.executable, "-m", "sibelia_tpu.cli.csibelia", ref, asm, "-o",
         host_out], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        o0, a0 = OD.get_stats(), AD.get_stats()
        t0 = time.time()
        rc = csibelia.run([ref, asm, "-o", dev_out])
        wall = time.time() - t0
        if rc != 0:
            sys.exit(f"chip_smoke: C-Sibelia exited {rc}")
        t1 = time.time()
        _, err = host.communicate()
        if host.returncode != 0:
            sys.exit(f"chip_smoke: host C-Sibelia failed:\n{err[-3000:]}")
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()
    o1, a1 = OD.get_stats(), AD.get_stats()
    order_jobs = o1["device_jobs"] - o0["device_jobs"]
    anchor_jobs = a1["device_jobs"] - a0["device_jobs"]
    log(f"[csibelia] {PAIR_SIZE} bp pair, default flags: device wall "
        f"{wall:.1f} s (host reference finished {time.time() - t1:.1f} s "
        f"later) | order device_jobs {order_jobs}, host_fallback "
        f"{o1['host_fallback'] - o0['host_fallback']} | anchors "
        f"device_jobs {anchor_jobs}, host_fallback "
        f"{a1['host_fallback'] - a0['host_fallback']}")
    with open(os.path.join(dev_out, "variant.vcf"), "rb") as a, \
            open(os.path.join(host_out, "variant.vcf"), "rb") as b:
        vd, vh = a.read(), b.read()
    if vd != vh:
        sys.exit("chip_smoke: C-Sibelia VCF differs from the host run")
    if order_jobs <= 0 or anchor_jobs <= 0:
        sys.exit("chip_smoke: C-Sibelia ran no order/anchors job on the "
                 "device")
    lines = vd.count(b"\n")
    log(f"[csibelia] variant.vcf ({lines} lines, sha256 "
        f"{hashlib.sha256(vd).hexdigest()}) identical to the host run: true")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    os.environ["SIBELIA_TPU_COUNT_SYNCS"] = "1"
    if args.chips > 1:
        os.environ["SIBELIA_TPU_SHARDED"] = str(args.chips)

    t_all = time.time()
    devs = phase_device(args.chips)
    s16, gen16 = _start_gen("s16.fasta", 16)
    pair, genpair = _start_gen("pair.fasta", 2, PAIR_SIZE)
    try:
        phase_native()
        s16 = _finish_gen(s16, gen16)
        if args.chips == 1:
            phase_kernels(s16, devs[0])
        phase_sibelia(s16)
        phase_csibelia(_finish_gen(pair, genpair))
    finally:
        for p in (gen16, genpair):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    log(f"[done] all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
