"""Sibelia-compatible command line driver.

Full flag surface of the reference CLI (reference: src/sibelia.cpp:43-368):
-s/-k presets or stage file, -m min block size, -i max iterations, --lastk,
-a shared only, -q sequences, -g graph, -v hierarchy, --gff, --allstages,
--nopostprocess, --correctboundaries, --noblocks, -o outdir, -t tempdir,
-r inram.  Like the reference, -t names where external-memory state
lives: when the estimated in-RAM peak exceeds available memory (or
SIBELIA_TPU_EXTMEM=1 forces it), the native ranking arenas back onto
unlinked temp files under a spill dir created in -t; -r forces the
all-in-RAM path (reference: src/sibelia.cpp:158-162,239).
"""
from __future__ import annotations

import argparse
import os
import sys

from .. import VERSION
from ..core.progress import make_progress_bar
from ..core.config import MAX_INPUT_SIZE, PRESETS, read_stage_file
from ..blocks.finder import BlockFinder
from ..blocks.postprocess import glue_stripes
from ..io import writers
from ..io.fasta import read_fasta


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="Sibelia",
        description="Program for finding synteny blocks in closely related genomes")
    p.add_argument("--version", action="version", version=VERSION)
    p.add_argument("-i", "--maxiterations", type=int, default=4)
    p.add_argument("--correctboundaries", action="store_true")
    p.add_argument("--nopostprocess", action="store_true")
    p.add_argument("--gff", action="store_true")
    p.add_argument("--allstages", action="store_true")
    p.add_argument("--lastk", type=int, default=None)
    p.add_argument("-t", "--tempdir", default=".")
    group = p.add_mutually_exclusive_group()
    group.add_argument("-k", "--stagefile", default=None)
    group.add_argument("-s", "--parameters", choices=sorted(PRESETS), default=None)
    p.add_argument("-v", "--visualize", action="store_true")
    p.add_argument("-g", "--graphfile", action="store_true")
    p.add_argument("-q", "--sequencesfile", action="store_true")
    p.add_argument("-m", "--minblocksize", type=int, default=5000)
    p.add_argument("-a", "--sharedonly", action="store_true")
    p.add_argument("-r", "--inram", action="store_true")
    p.add_argument("--noblocks", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="directory for per-stage checkpoints; resumes from "
                        "the newest one (sibelia_tpu extension)")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("filenames", nargs="+")
    return p


def run(argv: list[str]) -> int:
    args = build_arg_parser().parse_args(argv)
    prof_ctx = None
    _spill_dir_created = None
    # Multi-host runtime (SURVEY §2e): when SIBELIA_TPU_COORD/NPROCS/
    # PROC_ID are set, N processes form one SPMD program — the sharded
    # enumeration spans the global ('host','chip') device mesh, the
    # remainder runs replicated (all stages are deterministic), and only
    # process 0 writes outputs (tests/test_multihost.py drives this).
    _multiproc = False
    _is_writer = True
    if os.environ.get("SIBELIA_TPU_COORD"):
        from ..parallel.runtime import init_distributed
        _multiproc = init_distributed()
        if _multiproc:
            import jax
            _is_writer = jax.process_index() == 0
            os.environ.setdefault("SIBELIA_TPU_SHARDED",
                                  str(jax.device_count()))
    from ..core.platform import enable_compile_cache
    enable_compile_cache()
    try:
        if args.stagefile is not None:
            stage = read_stage_file(args.stagefile)
        else:
            stage = PRESETS[args.parameters or "loose"]

        if args.correctboundaries and len(args.filenames) != 2:
            raise RuntimeError("In correction mode only two FASTA files are acceptable")

        chr_list = []
        reference_chr_id = set()
        for i, fn in enumerate(args.filenames):
            if not os.path.exists(fn):
                raise RuntimeError(f"Cannot open file {fn}")
            read_fasta(fn, chr_list)
            if i == 0:
                reference_chr_id = {r.id for r in chr_list}

        total = sum(len(r.sequence) for r in chr_list)
        if total > MAX_INPUT_SIZE:
            raise RuntimeError("Input is larger than 1 GB, can't proceed")

        # External-memory mode (reference parity: the reference streams
        # its suffix array through TempFile in `-t tempdir` by default,
        # with `-r` opting into RAM, vertexenumeration.cpp:99-157).
        # Here the in-RAM path is the fast default; the native arenas
        # spill to unlinked temp files under `-t` when the estimated
        # in-RAM peak would not fit the host (or SIBELIA_TPU_EXTMEM=1
        # forces it), keeping peak RSS bounded.  `-r` forces in-RAM.
        if (not args.inram and "SIBELIA_TPU_SPILL_DIR" not in os.environ
                and os.environ.get("SIBELIA_TPU_EXTMEM") != "0"):
            # In-RAM peak model from the actual stage plan: the ranking
            # arenas dominate, and the k>32 stages add the blockmix
            # signature lanes plus the 32-level and final-level rank
            # caches (~50 B/input byte beyond the k<=32 arena set;
            # measured ~120 B/input byte total on multi-stage presets).
            last_k = args.lastk if args.lastk is not None else \
                min(stage[-1][0] if stage else (1 << 31), args.minblocksize)
            any_big_k = any(k > 32 for k, _ in stage) or last_k > 32
            est = total * (120 if any_big_k else 70)
            avail = None
            # SIBELIA_TPU_MEMAVAIL_MB simulates a small host (test hook;
            # also lets operators pin the budget below MemAvailable)
            ov = os.environ.get("SIBELIA_TPU_MEMAVAIL_MB")
            if ov and ov.isdigit():
                avail = int(ov) << 20
            else:
                try:
                    with open("/proc/meminfo") as f:
                        for line in f:
                            if line.startswith("MemAvailable"):
                                avail = int(line.split()[1]) * 1024
                                break
                except OSError:
                    pass
            force = os.environ.get("SIBELIA_TPU_EXTMEM") == "1"
            if force or (avail is not None and est > avail * 3 // 4):
                import tempfile as _tempfile
                _spill_dir_created = _tempfile.mkdtemp(
                    prefix="sibelia_spill_", dir=args.tempdir)
                os.environ["SIBELIA_TPU_SPILL_DIR"] = _spill_dir_created
                print("Using external-memory mode (temp dir: %s)"
                      % _spill_dir_created, file=sys.stderr)

        # In-RAM runs retain freed malloc memory (glibc: route big blocks
        # through the brk heap and never trim it): on this class of VM
        # kernel, pages returned to the OS are reclaimed host-side and
        # refault at ~20 us/page, so the alloc/free churn of the engine
        # phase and the numpy staging buffers would otherwise re-pay
        # multi-second fault storms every stage.  Spill mode skips this —
        # there, bounded RSS is the whole point.
        # The -g flows rebuild the index at a k they just enumerated on an
        # unchanged sequence: enable the native final-level rank cache for
        # them (everywhere else its store is pure cost — see ranking.cpp)
        if args.graphfile:
            os.environ.setdefault("SIBELIA_TPU_FCACHE", "1")

        if "SIBELIA_TPU_SPILL_DIR" not in os.environ:
            try:
                import ctypes as _ctypes
                _libc = _ctypes.CDLL(None)
                _libc.mallopt(-4, 0)            # M_MMAP_MAX = 0
                _libc.mallopt(-1, 0x7FFFFFFF)   # M_TRIM_THRESHOLD = inf
            except Exception:
                pass
            # Reserve the native arena slab NOW, while RSS is small: on
            # this class of VM kernel page acquisition is ~1 s/GB early
            # vs ~5 s/GB once the process holds >~2 GB (ranking.cpp
            # Slab).  Sized for the full in-RAM arena set (~78 B per
            # supergenome position); only worth it when the run would
            # otherwise cross into the slow-fault regime.
            est_n = 2 * (total + len(chr_list) + 1) + 128
            slab_bytes = est_n * 95 + (64 << 20)
            if slab_bytes >= (1 << 30):
                from ..core import timings as _timings
                from ..native import slab_reserve

                # Top up the hugetlb pool (best-effort, needs root):
                # pool pages survive process exit inside the guest, so
                # repeat runs acquire the slab at ~0.2 s/GB instead of
                # paying host-side page acquisition every time.
                try:
                    need = -(-slab_bytes // (2 << 20))
                    free_hp = total_hp = 0
                    with open("/proc/meminfo") as f:
                        for line in f:
                            if line.startswith("HugePages_Free"):
                                free_hp = int(line.split()[1])
                            elif line.startswith("HugePages_Total"):
                                total_hp = int(line.split()[1])
                    if free_hp < need:
                        with open("/proc/sys/vm/nr_hugepages", "w") as f:
                            f.write(str(total_hp + (need - free_hp)))
                except OSError:
                    pass
                with _timings.phase("slab_reserve"):
                    slab_reserve(slab_bytes)

        history: list[list] = [[] for _ in range(len(stage) + 1)]
        finder = BlockFinder(chr_list)
        os.makedirs(args.outdir, exist_ok=True)

        # --checkpoint DIR: persist (raw_seq, original_pos, rand state)
        # after each stage and resume from the newest checkpoint (new aux
        # capability; the reference's inter-stage state is exactly this,
        # blockfinder.cpp:85-95)
        start_stage = 0
        ckpt_dir = getattr(args, "checkpoint", None)
        if ckpt_dir:
            from ..blocks.finder import load_checkpoint, save_checkpoint
            os.makedirs(ckpt_dir, exist_ok=True)
            done = sorted(f for f in os.listdir(ckpt_dir)
                          if f.startswith("stage_") and f.endswith(".ckpt"))
            if done:
                stage_idx, history = load_checkpoint(
                    finder, os.path.join(ckpt_dir, done[-1]))
                start_stage = stage_idx + 1
                print(f"Resuming after stage {stage_idx + 1}",
                      file=sys.stderr)

        trace = os.environ.get("SIBELIA_TPU_TRACE") == "1"
        # SIBELIA_TPU_PROFILE_DIR=<dir>: capture a jax.profiler trace of
        # the whole run (viewable in TensorBoard / Perfetto) — the
        # observability hook the reference lacks entirely (SURVEY §5)
        prof_dir = os.environ.get("SIBELIA_TPU_PROFILE_DIR")
        if prof_dir:
            import jax
            prof_ctx = jax.profiler.trace(prof_dir)
            prof_ctx.__enter__()
        import time as _time
        trim_k = 1 << 31
        for i, (k, d) in enumerate(stage):
            trim_k = min(trim_k, k)
            if i < start_stage:
                continue
            t_stage = _time.time()
            if args.visualize or args.allstages:
                if not args.noblocks:
                    history[i] = finder.generate_synteny_blocks(
                        k, trim_k, k, args.sharedonly)
                    if not args.nopostprocess:
                        history[i] = glue_stripes(history[i], chr_list)
                if args.graphfile and _is_writer:
                    with open(os.path.join(args.outdir, f"de_bruijn_graph{i}.dot"), "w") as g:
                        finder.serialize_condensed_graph(
                            k, g, progress=make_progress_bar())
            print(f"Simplification stage {i + 1} of {len(stage)}")
            print("Enumerating vertices of the graph, then performing bulge removal...")
            n_before = sum(len(s) for s in finder.raw_seq)
            from ..core import timings as _tm
            _tm.add("kmers_indexed", 2 * n_before)
            finder.perform_graph_simplifications(
                k, d, args.maxiterations, progress=make_progress_bar())
            if trace:
                dt = _time.time() - t_stage
                n_now = sum(len(s) for s in finder.raw_seq)
                # both strands are indexed, so the stage processes 2x the
                # working-sequence k-mers (the BASELINE throughput metric)
                rate = 2 * n_before / max(dt, 1e-9) / 1e6
                print(f"[trace] stage {i + 1}: k={k} d={d} "
                      f"{dt:.2f}s seq={n_now} {rate:.1f} Mkmers/s",
                      file=sys.stderr)
            if ckpt_dir and _is_writer:
                save_checkpoint(finder,
                                os.path.join(ckpt_dir, f"stage_{i:03d}.ckpt"),
                                i, history)

        print("Finding synteny blocks and generating the output...")
        trim_k = min(trim_k, args.minblocksize)
        if args.lastk is not None:
            last_k = args.lastk
        else:
            last_k = min(stage[-1][0] if stage else (1 << 31), args.minblocksize)

        old_format = not args.gff
        coords_writer = (writers.list_blocks_indices if old_format
                         else writers.list_blocks_indices_gff)
        ext = ".txt" if old_format else ".gff"
        out = args.outdir

        if not args.noblocks:
            history[-1] = finder.generate_synteny_blocks(
                last_k, trim_k, args.minblocksize, args.sharedonly,
                progress=make_progress_bar())
            if not args.nopostprocess:
                history[-1] = glue_stripes(history[-1], chr_list)
            if args.correctboundaries:
                from ..blocks.boundaries import improve_block_boundaries
                improve_block_boundaries(history[-1], reference_chr_id,
                                         args.minblocksize)

            from ..core import timings as _timings
            with _timings.phase("writers"):
              if _is_writer:
                  if args.allstages:
                      for i, blocks in enumerate(history):
                          coords_writer(blocks, chr_list,
                                        os.path.join(out, f"blocks_coords{i}{ext}"))
                  else:
                      coords_writer(history[-1], chr_list,
                                    os.path.join(out, f"blocks_coords{ext}"))

                  writers.list_chromosomes_as_permutations(
                      history[-1], chr_list, os.path.join(out, "genomes_permutations.txt"))
                  writers.generate_report(
                      history[-1], chr_list, os.path.join(out, "coverage_report.txt"))
                  if args.sequencesfile:
                      writers.list_blocks_sequences(
                          history[-1], chr_list, os.path.join(out, "blocks_sequences.fasta"))
                  writers.generate_d3_output(
                      history[-1], chr_list, os.path.join(out, "d3_blocks_diagram.html"))
                  circos_dir = os.path.join(out, "circos")
                  circos_file = os.path.join(circos_dir, "circos.conf")
                  if not args.visualize:
                      writers.generate_circos_output(history[-1], chr_list, circos_file, circos_dir)
                  else:
                      writers.generate_hierarchy_circos_output(history, chr_list, circos_file, circos_dir)

        if args.graphfile and _is_writer:
            suffix = f"{len(stage)}" if args.allstages else ""
            with open(os.path.join(out, f"de_bruijn_graph{suffix}.dot"), "w") as g:
                finder.serialize_condensed_graph(last_k, g)
        if _multiproc:
            # every process ran the same collectives; hold them all
            # until the writer finishes so coordinator teardown cannot
            # race an in-flight write
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("sibelia_tpu_end")
        return 0
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if prof_ctx is not None:
            prof_ctx.__exit__(None, None, None)
        # SIBELIA_TPU_TIMINGS=<path>: dump the per-phase wall-clock split
        # (enumeration / simplification / block_generation / writers)
        tpath = os.environ.get("SIBELIA_TPU_TIMINGS")
        if tpath:
            from ..core import timings as _timings
            from ..core.platform import SYNC_COUNTS
            for _tag, _n in SYNC_COUNTS.items():
                _timings.add("syncs_" + _tag, _n)
            try:
                _timings.dump(tpath)
            except OSError:
                pass
        # spill files are unlinked at creation; only the dir remains
        if _spill_dir_created:
            try:
                os.rmdir(_spill_dir_created)
            except OSError:
                pass


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
