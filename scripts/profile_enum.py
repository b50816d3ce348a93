#!/usr/bin/env python3
"""Profile the fused device enumeration (index/enum_device.py) on the GPU
and split its device time into sort kernels and everything else (the
key packing and the post-sort scan fusions of _segment_scan).

Usage: profile_enum.py GENOMES.fasta OUTDIR [k]

Runs _enum_device_k32 once to compile, then three times under
jax.profiler.trace(OUTDIR), and prints per-kernel device time from the
trace (kernels grouped by their XLA op name).
"""
import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def main():
    fasta, outdir = sys.argv[1], sys.argv[2]
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 30
    import jax
    import jax.numpy as jnp
    from sibelia_tpu.core.platform import enable_compile_cache
    from sibelia_tpu.index.enum_device import _enum_device_k32
    from sibelia_tpu.index.enumeration import build_supergenome
    from sibelia_tpu.index.ranking import pad_rows
    from sibelia_tpu.io.fasta import read_fasta

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("profile_enum: needs a GPU")
    chroms = [r.sequence.encode() for r in read_fasta(fasta)]
    codes, _ = build_supergenome(chroms)
    n = codes.shape[0]
    pad_to = pad_rows(n)
    codes_d = jnp.asarray(np.concatenate(
        [codes, np.zeros(pad_to - n, np.uint8)]))
    jax.block_until_ready(_enum_device_k32(codes_d, k))
    reps = 3
    t0 = time.time()
    with jax.profiler.trace(outdir):
        for _ in range(reps):
            jax.block_until_ready(_enum_device_k32(codes_d, k))
    wall = (time.time() - t0) / reps
    print(f"{dev.device_kind}: k={k} n={pad_to}, {wall * 1e3:.1f} ms per "
          f"call (host clock, traced)")

    path = sorted(glob.glob(os.path.join(outdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    per_op = collections.Counter()
    calls = collections.Counter()
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        print(f"{plane.name}: lines {[ln.name for ln in lines]}")
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for line in ops:
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns
                calls[ev.name] += 1
    total = sum(per_op.values())
    if not total:
        sys.exit("profile_enum: no device op events in the trace")
    sort_ns = sum(v for name, v in per_op.items() if "sort" in name)
    print(f"device op time per call: {total / reps / 1e6:.2f} ms; "
          f"sort {100 * sort_ns / total:.1f}%, other "
          f"{100 * (total - sort_ns) / total:.1f}%")
    for name, ns in per_op.most_common(25):
        print(f"  {ns / reps / 1e6:9.3f} ms  {calls[name] // reps:4d}x  "
              f"{name}")


if __name__ == "__main__":
    main()
