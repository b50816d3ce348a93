#!/usr/bin/env python
"""Run the Sibelia CLI on an example with per-phase timing.
Usage: run_example.py <outdir> <args...>   (env SIB_PLATFORM=cpu pins the CPU; any other value keeps JAX's default device)
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
if os.environ.get("SIB_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import sibelia_tpu.graph.simplify as S
import sibelia_tpu.graph.indexed as I

_t = [time.time()]
_orig_build = I.build_index
def timed_build(seq, k, rand=None):
    t0 = time.time()
    store = _orig_build(seq, k, rand)
    n = sum(len(c) for c in seq.chars)
    if n > 100000:
        print(f"[t] build_index k={k} n={n} bifs={store.max_id} {time.time()-t0:.1f}s", flush=True)
    return store
I.build_index = timed_build
import sibelia_tpu.blocks.finder as F
import sibelia_tpu.blocks.synteny as Y
F.build_index = timed_build
Y.build_index = timed_build

_orig_simp = S.simplify_graph
def timed_simp(seq, store, k, d, mi, progress=None):
    t0 = time.time()
    r = _orig_simp(seq, store, k, d, mi, progress)
    print(f"[t] simplify k={k} d={d} bulges={r} {time.time()-t0:.1f}s", flush=True)
    return r
S.simplify_graph = timed_simp
F.simplify_graph = timed_simp

from sibelia_tpu.cli.sibelia import run
t0 = time.time()
rc = run(sys.argv[1:])
print("rc", rc, "total", f"{time.time()-t0:.1f}s", flush=True)
