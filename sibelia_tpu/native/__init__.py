"""Native (C++) simplification engine loader.

Builds sibelia_tpu/native/engine.cpp into a shared library on first use
(g++ -O2 -shared) and exposes it through ctypes. Falls back to the Python
engine transparently if a toolchain is unavailable
(SIBELIA_TPU_NATIVE=0 disables it explicitly).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cpp")
_SO = os.path.join(_DIR, "build", "libsibelia_engine.so")

_lib = None
_tried = False

# native progress hook (PutProgressChr twin; engine.cpp ProgressFn)
PROGRESS_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_longlong, ctypes.c_int)


def load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("SIBELIA_TPU_NATIVE", "1") == "0":
        return None
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-o", _SO, _SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.engine_create.restype = ctypes.c_void_p
    lib.engine_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.engine_set_bifs.restype = None
    lib.engine_set_bifs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.engine_simplify.restype = ctypes.c_int64
    lib.engine_simplify.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int64]
    lib.engine_simplify_sparse.restype = ctypes.c_int64
    lib.engine_simplify_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.engine_set_progress.restype = None
    lib.engine_set_progress.argtypes = [ctypes.c_void_p, PROGRESS_CFUNC]
    lib.engine_chr_len.restype = ctypes.c_int64
    lib.engine_chr_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.engine_get_chr.restype = None
    lib.engine_get_chr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.engine_destroy.restype = None
    lib.engine_destroy.argtypes = [ctypes.c_void_p]
    lib.radix_argsort_u64.restype = None
    lib.radix_argsort_u64.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]
    _lib = lib
    return _lib


def radix_argsort(keys: np.ndarray) -> np.ndarray | None:
    """Stable argsort of a uint64 key array via the native radix sort;
    None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype=np.int64)
    lib.radix_argsort_u64(keys.ctypes.data, len(keys), out.ctypes.data)
    return out


def simplify_native(seq, enum, k: int, min_branch: int,
                    max_iterations: int,
                    candidates: np.ndarray | None = None,
                    release_enum: bool = False,
                    progress=None) -> int | None:
    """Run the full simplification stage natively. `seq` is a
    MutableSequence (mutated in place on success); `enum` a BifEnumeration.
    Returns the bulge count, or None if the native engine is unavailable.

    Runs the sparse sweep driver (identical output to the dense loop;
    engine.cpp:engine_simplify_sparse): iteration 1 visits `candidates`
    (uint8[count] bitmap, e.g. computed on device during enumeration) or
    the parallel host prefilter, later iterations only the ids flagged by
    collapse side-effect tracking. SIBELIA_TPU_DENSE_SIMPLIFY=1 forces
    the dense reference loop for A/B checks."""
    lib = load()
    if lib is None:
        return None
    n_chr = seq.n_chr
    chr_lens = (ctypes.c_int64 * n_chr)(*[seq.chr_len(c) for c in range(n_chr)])
    char_bufs = [np.ascontiguousarray(seq.chars[c]) for c in range(n_chr)]
    op_bufs = [np.ascontiguousarray(seq.origpos[c], dtype=np.int32)
               for c in range(n_chr)]
    char_ptrs = (ctypes.c_void_p * n_chr)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in char_bufs])
    op_ptrs = (ctypes.c_void_p * n_chr)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in op_bufs])
    sep = (ctypes.c_int64 * n_chr)(*seq.sep_origpos)
    from ..core import timings
    with timings.phase("engine_ingest"):
        handle = lib.engine_create(n_chr, chr_lens, char_ptrs, op_ptrs, sep)
    try:
        lens = np.asarray([seq.chr_len(c) for c in range(n_chr)], dtype=np.int64)
        packed = []
        for strand in (0, 1):
            # int32 coords / uint32 ids on the wire (bounded by the 1 GB
            # cap); the staging copies are ~2 GB smaller at that scale
            chrs = np.ascontiguousarray(enum.chr[strand], dtype=np.int32)
            if strand == 0:
                coords = np.ascontiguousarray(enum.pos[strand],
                                              dtype=np.int32)
            else:
                # lens is int64, so the mixed expression promotes; one
                # narrowing copy at the end (values < 2^31 by the cap)
                coords = (lens[chrs] - 1 -
                          enum.pos[strand]).astype(np.int32)
            bids = np.ascontiguousarray(enum.bif_id[strand],
                                        dtype=np.uint32)
            packed.append((chrs, coords, bids))
        if release_enum:
            # drop the source instance arrays BEFORE the engine ingest so
            # they never coexist with the packed copies + engine tables
            # (at the 1 GB scale each set is ~1.3 GB)
            enum.chr = enum.pos = enum.bif_id = (None, None)
        (c0, p0, b0), (c1, p1, b1) = packed
        _t_ing = timings.phase("engine_ingest")
        _t_ing.__enter__()
        lib.engine_set_bifs(
            handle, enum.count,
            len(c0), c0.ctypes.data, p0.ctypes.data, b0.ctypes.data,
            len(c1), c1.ctypes.data, p1.ctypes.data, b1.ctypes.data)
        _t_ing.__exit__(None, None, None)
        cand = None
        if candidates is not None:
            cand = np.ascontiguousarray(candidates, dtype=np.uint8)
            if cand.size != enum.count:
                raise ValueError("candidate bitmap size != vertex count")
        # the engine holds its own copies from here on; release the
        # Python-side sequence buffers so big inputs are not held twice
        # (seq.chars/origpos are replaced from engine_get_chr below)
        del packed, c0, p0, b0, c1, p1, b1
        for c in range(n_chr):
            seq.chars[c] = None
            seq.origpos[c] = None
        del char_bufs, op_bufs
        cb_keepalive = None
        if progress is not None:
            cb_keepalive = PROGRESS_CFUNC(
                lambda p, st: progress(int(p), int(st)))
            lib.engine_set_progress(handle, cb_keepalive)
        # device-side bulge detection: SIBELIA_TPU_WAVE_DEVICE=1 forces,
        # =0 disables; default follows device_dispatch()
        wd_env = os.environ.get("SIBELIA_TPU_WAVE_DEVICE")
        if wd_env is None:
            from ..core.platform import device_dispatch
            use_wd = device_dispatch()
        else:
            use_wd = wd_env == "1"
        rp_keepalive = None
        rp_error: list[BaseException] = []
        if use_wd:
            _configure_reprefilter_api(lib)

            def _rp(cand_ptr, n_ids):
                # an exception cannot cross the C frame: stop answering
                # (0 = "no bitmap") and re-raise once the sweep returns
                if rp_error:
                    return 0
                try:
                    bm = _device_reprefilter(lib, handle, n_chr, k,
                                             min_branch, int(n_ids))
                except BaseException as e:  # re-raised below
                    rp_error.append(e)
                    return 0
                if bm is None:
                    REPREFILTER_STATS["host_fallback"] += 1
                    return 0
                REPREFILTER_STATS["device"] += 1
                ctypes.memmove(cand_ptr, bm.ctypes.data, int(n_ids))
                return 1

            rp_keepalive = REPREFILTER_CFUNC(_rp)
            lib.engine_set_reprefilter(handle, rp_keepalive)
        with timings.phase("engine_sweep"):
            if os.environ.get("SIBELIA_TPU_DENSE_SIMPLIFY") == "1":
                ret = lib.engine_simplify(handle, k, min_branch,
                                          max_iterations)
            else:
                cand_ptr = None
                if cand is not None:
                    cand_ptr = cand.ctypes.data
                ret = lib.engine_simplify_sparse(
                    handle, k, min_branch, max_iterations, cand_ptr,
                    0 if candidates is None else enum.count)
        if rp_error:
            raise rp_error[0]
        with timings.phase("engine_writeback"):
            for c in range(n_chr):
                ln = lib.engine_chr_len(handle, c)
                chars = np.empty(ln, dtype=np.uint8)
                op = np.empty(ln, dtype=np.int32)
                lib.engine_get_chr(handle, c, chars.ctypes.data,
                                   op.ctypes.data)
                seq.chars[c] = chars
                seq.origpos[c] = op
        return int(ret)
    finally:
        lib.engine_destroy(handle)


# ---------------------------------------------------------------------------
# LAGAN-semantics engine (chaos / anchors / order stage primitives)
# ---------------------------------------------------------------------------

_LAGAN_SRCS = [os.path.join(_DIR, f) for f in
               ("lagan_api.cpp", "lagan_chaos.cpp", "lagan_anchors.cpp",
                "lagan_order.cpp", "lagan_multial.cpp")]
_LAGAN_HDRS = [os.path.join(_DIR, f) for f in
               ("lagan_common.h", "lagan_stages.h")]
_LAGAN_SO = os.path.join(_DIR, "build", "liblagan_engine.so")

_lagan_lib = None
_lagan_tried = False


def load_lagan() -> ctypes.CDLL | None:
    """Build (if stale) and load the native LAGAN-stage library."""
    global _lagan_lib, _lagan_tried
    if _lagan_lib is not None or _lagan_tried:
        return _lagan_lib
    _lagan_tried = True
    if os.environ.get("SIBELIA_TPU_NATIVE", "1") == "0":
        return None
    try:
        newest_src = max(os.path.getmtime(p)
                         for p in _LAGAN_SRCS + _LAGAN_HDRS)
        if (not os.path.exists(_LAGAN_SO)
                or os.path.getmtime(_LAGAN_SO) < newest_src):
            os.makedirs(os.path.dirname(_LAGAN_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-o", _LAGAN_SO] + _LAGAN_SRCS,
                check=True, capture_output=True)
        lib = ctypes.CDLL(_LAGAN_SO)
    except (OSError, ValueError, subprocess.CalledProcessError):
        return None
    lib.le_chaos.restype = ctypes.c_void_p
    lib.le_chaos.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.le_chaos_trans.restype = ctypes.c_void_p
    lib.le_chaos_trans.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.le_anchors.restype = ctypes.c_void_p
    lib.le_anchors.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.le_order.restype = ctypes.c_void_p
    lib.le_order.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.le_free.restype = None
    lib.le_free.argtypes = [ctypes.c_void_p]
    lib.le_order_prepare.restype = ctypes.c_void_p
    lib.le_order_prepare.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p]
    lib.le_order_dims.restype = None
    lib.le_order_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.le_order_band.restype = None
    lib.le_order_band.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.le_order_seq.restype = None
    lib.le_order_seq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.le_order_finish.restype = ctypes.c_void_p
    lib.le_order_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_longlong]
    lib.le_order_release.restype = None
    lib.le_order_release.argtypes = [ctypes.c_void_p]
    _lagan_lib = lib
    return _lagan_lib


def _take_string(lib, ptr) -> str:
    try:
        return ctypes.string_at(ptr).decode("latin-1")
    finally:
        lib.le_free(ptr)


def lagan_chaos(seq1: bytes, name1: str, seq2: bytes, name2: str,
                pairs_text: str, wl: int, nd: int, co: int, rsc: int,
                gfc: bool = True, ext: bool = True) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_chaos(seq1, len(seq1), name1.encode("latin-1"),
                       seq2, len(seq2), name2.encode("latin-1"),
                       pairs_text.encode("latin-1"),
                       wl, nd, co, rsc, int(gfc), int(ext))
    return _take_string(lib, ptr)


def lagan_chaos_translated(seq1: bytes, name1: str, seq2: bytes,
                           name2: str, both: bool = False, wl: int = 4,
                           nd: int = 1, co: int = 25, rsc: int = 0,
                           gfc: bool = False, ext: bool = False
                           ) -> str | None:
    """6-frame translated chaos (the reference's `chaos -t` / -b; defaults
    mirror fchaos.c:38-62 after the -t overrides, fchaos.c:652-660)."""
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_chaos_trans(seq1, len(seq1), name1.encode("latin-1"),
                             seq2, len(seq2), name2.encode("latin-1"),
                             int(both), wl, nd, co, rsc, int(gfc), int(ext))
    return _take_string(lib, ptr)


def lagan_anchors(hits_text: str, gfc: bool = True) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_anchors(hits_text.encode("latin-1"), int(gfc))
    return _take_string(lib, ptr)


def lagan_order(seq1: bytes, name1: str, seq2: bytes, name2: str,
                anchors_text: str) -> str | None:
    lib = load_lagan()
    if lib is None:
        return None
    ptr = lib.le_order(seq1, len(seq1), name1.encode("latin-1"),
                       seq2, len(seq2), name2.encode("latin-1"),
                       anchors_text.encode("latin-1"))
    return _take_string(lib, ptr)


# ---------------------------------------------------------------------------
# Native k-mer ranking kernel
# ---------------------------------------------------------------------------

_RANK_SRC = os.path.join(_DIR, "ranking.cpp")
_RANK_SO = os.path.join(_DIR, "build", "libsibelia_ranking.so")

_rank_lib = None
_rank_tried = False


def load_ranking() -> ctypes.CDLL | None:
    global _rank_lib, _rank_tried
    if _rank_lib is not None or _rank_tried:
        return _rank_lib
    _rank_tried = True
    if os.environ.get("SIBELIA_TPU_NATIVE", "1") == "0":
        return None
    try:
        if (not os.path.exists(_RANK_SO)
                or os.path.getmtime(_RANK_SO) < os.path.getmtime(_RANK_SRC)):
            os.makedirs(os.path.dirname(_RANK_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 "-o", _RANK_SO, _RANK_SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_RANK_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.kmer_ranks_native.restype = None
    lib.kmer_ranks_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    _rank_lib = lib
    return _rank_lib


def slab_reserve(n_bytes: int) -> None:
    """Reserve the native arena slab while process RSS is still small
    (page acquisition is ~5x cheaper then on this class of VM kernel —
    see ranking.cpp::rank_slab_reserve).  Safe no-op without the native
    library, in spill mode, or on repeat calls."""
    lib = load_ranking()
    if lib is None:
        return
    try:
        lib.rank_slab_reserve.restype = None
        lib.rank_slab_reserve.argtypes = [ctypes.c_int64]
        lib.rank_slab_reserve(ctypes.c_int64(n_bytes))
    except AttributeError:
        pass


def kmer_ranks_native(codes: np.ndarray, k: int):
    """Native (rank, order) twin of index.ranking.kmer_ranks_numpy;
    None if the native library is unavailable.

    Contract: identical GROUPING of valid windows (equal rank <=>
    identical k-window) and identical valid-filtered sorted order.  Rank
    VALUES and the placement of invalid (separator-crossing) positions
    may differ from the numpy twin in groups that mix valid and invalid
    members (the k>32 LCP refinement leaves invalid members at the
    group's base rank; see native/ranking.cpp)."""
    lib = load_ranking()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    rank = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.kmer_ranks_native(codes.ctypes.data, n, int(k),
                          rank.ctypes.data, order.ctypes.data)
    return rank, order


def _rank_lib_enum():
    lib = load_ranking()
    if lib is None:
        return None
    if not hasattr(lib, "_enum_configured"):
        lib.enum_run.restype = ctypes.c_void_p
        lib.enum_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.enum_count.restype = ctypes.c_int64
        lib.enum_count.argtypes = [ctypes.c_void_p]
        lib.enum_strand_size.restype = ctypes.c_int64
        lib.enum_strand_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.enum_fetch.restype = None
        lib.enum_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
        lib.enum_destroy.restype = None
        lib.enum_destroy.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "enum_fetch32"):
            lib.enum_fetch32.restype = None
            lib.enum_fetch32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib._enum_configured = True
    return lib


def enumerate_native(codes: np.ndarray, block_starts: np.ndarray,
                     n_chr: int, k: int):
    """Native twin of index.enumeration.enumerate_bifurcations' scan over a
    prebuilt supergenome; returns (count, [(chr, pos, id)] * 2) or None."""
    lib = _rank_lib_enum()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    block_starts = np.ascontiguousarray(block_starts, dtype=np.int64)
    h = lib.enum_run(codes.ctypes.data, len(codes), block_starts.ctypes.data,
                     len(block_starts), int(n_chr), int(k))
    try:
        count = lib.enum_count(h)
        fetch32 = getattr(lib, "enum_fetch32", None)
        strands = []
        for s in (0, 1):
            m = lib.enum_strand_size(h, s)
            if fetch32 is not None:
                # int32/uint32 on the wire (lossless under the 1 GB cap):
                # consumers skip a whole astype pass over the tables
                chrs = np.empty(m, dtype=np.int32)
                poss = np.empty(m, dtype=np.int32)
                ids = np.empty(m, dtype=np.uint32)
                fetch32(h, s, chrs.ctypes.data, poss.ctypes.data,
                        ids.ctypes.data)
            else:
                chrs = np.empty(m, dtype=np.int64)
                poss = np.empty(m, dtype=np.int64)
                ids = np.empty(m, dtype=np.uint32)
                lib.enum_fetch(h, s, chrs.ctypes.data, poss.ctypes.data,
                               ids.ctypes.data)
            strands.append((chrs, poss, ids))
        return int(count), strands
    finally:
        lib.enum_destroy(h)


def _lagan_ml(lib):
    if not hasattr(lib, "_ml_configured"):
        lib.ml_create.restype = ctypes.c_void_p
        lib.ml_create.argtypes = [ctypes.c_int]
        lib.ml_set_seq.restype = None
        lib.ml_set_seq.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_long,
                                   ctypes.c_char_p]
        lib.ml_add_anchor.restype = None
        lib.ml_add_anchor.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float]
        lib.ml_run.restype = ctypes.c_void_p
        lib.ml_run.argtypes = [ctypes.c_void_p]
        lib.ml_destroy.restype = None
        lib.ml_destroy.argtypes = [ctypes.c_void_p]
        lib.pl_set_profile.restype = None
        lib.pl_set_profile.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int]
        lib.pl_run.restype = ctypes.c_void_p
        lib.pl_run.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_void_p]
        lib._ml_configured = True
    return lib


def mlagan_native(seqs, names, pair_anchor_lines) -> str | None:
    """Run the native mlagan port. pair_anchor_lines[(i, j)] is the anchor
    text lines for pair (i, j) in file order (descending seq1 end)."""
    lib = load_lagan()
    if lib is None:
        return None
    _lagan_ml(lib)
    h = lib.ml_create(len(seqs))
    try:
        for i, (s, nm) in enumerate(zip(seqs, names)):
            lib.ml_set_seq(h, i, s, len(s), nm.encode("latin-1"))
        for (i, j), lines in pair_anchor_lines.items():
            for (s1s, s1e, s2s, s2e, score) in lines:
                lib.ml_add_anchor(h, i, j, s1s, s1e, s2s, s2e, score)
        ptr = lib.ml_run(h)
        return _take_string(lib, ptr)
    finally:
        lib.ml_destroy(h)


def prolagan_native(seqs, names, profiles, pair_anchor_lines, tree) -> str | None:
    """Run the native prolagan port (reference src/lagan/src/prolagan.c).

    profiles: two lists of (file_index, gapped_row) in profile row order.
    pair_anchor_lines[(i, j)]: cross-profile anchor lines, file order.
    tree: the required phylogenetic tree string (prolagan.c:699-705 exits
    without one).
    """
    lib = load_lagan()
    if lib is None:
        return None
    _lagan_ml(lib)
    h = lib.ml_create(len(seqs))
    try:
        for i, (s, nm) in enumerate(zip(seqs, names)):
            lib.ml_set_seq(h, i, s, len(s), nm.encode("latin-1"))
        pro_of = np.full(len(seqs), -1, dtype=np.int32)
        for which, rows in enumerate(profiles):
            members = np.array([m for m, _ in rows], dtype=np.int32)
            pro_of[members] = which
            joined = "\n".join(r for _, r in rows).encode("latin-1")
            lib.pl_set_profile(h, which, joined, members.ctypes.data,
                               len(rows))
        if (pro_of < 0).any():
            raise ValueError("sequence not found in either profile")
        for (i, j), lines in pair_anchor_lines.items():
            for (s1s, s1e, s2s, s2e, score) in lines:
                lib.ml_add_anchor(h, i, j, s1s, s1e, s2s, s2e, score)
        ptr = lib.pl_run(h, tree.encode("latin-1"), pro_of.ctypes.data)
        return _take_string(lib, ptr)
    finally:
        lib.ml_destroy(h)


# ---------------------------------------------------------------------------
# Device-side bulge detection (the sparse sweep's re-prefilter)
# ---------------------------------------------------------------------------

# re-prefilter answers: device = bitmaps computed on the device,
# host_fallback = calls the int32 size gate sent back to the host
# prefilter (the only documented fallback; any other failure raises)
REPREFILTER_STATS = {"device": 0, "host_fallback": 0}


def _configure_reprefilter_api(lib):
    if getattr(lib, "_reprefilter_configured", False):
        return
    lib.engine_set_reprefilter.restype = None
    lib.engine_set_reprefilter.argtypes = [ctypes.c_void_p,
                                           REPREFILTER_CFUNC]
    lib.engine_live_node_count.restype = ctypes.c_int64
    lib.engine_live_node_count.argtypes = [ctypes.c_void_p]
    lib.engine_export_nodes.restype = None
    lib.engine_export_nodes.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.engine_export_chars.restype = None
    lib.engine_export_chars.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
    lib._reprefilter_configured = True


REPREFILTER_CFUNC = ctypes.CFUNCTYPE(ctypes.c_longlong,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_longlong)


def _device_reprefilter(lib, handle, n_chr, k, min_branch, n_ids):
    """Frozen-state bulge-candidate detection on the device: export the
    engine's live instance table + current sequence, rebuild the
    supergenome frame, and run the banded self-join candidate kernel
    (index/enumeration.py::_candidate_scan).  Returns a uint8[n_ids]
    bitmap that is a SUPERSET of "AnyBulges reports a group" on the
    frozen state (same guarantee as the host prefilter, which also only
    removes ids the serial reference loop would leave untouched), or
    None when the supergenome exceeds the kernel's int32 position space
    (host fallback).

    This is the framework's second-hottest loop (the bif-id x
    branch-walk bulge scan, reference: src/bulgeremoval.cpp:158-218)
    expressed as device segment ops over the position-sorted instance
    table: walk membership is a banded self-join (positions ascend, so
    a walk is a contiguous run of rows), and the two-distinct-end-chars
    rule is a segmented compare over (owner, member) tuples."""
    import jax.numpy as jnp

    from ..core.platform import note_sync
    from ..index.enumeration import _candidate_scan, build_supergenome
    from ..index.ranking import pad_rows

    chroms = []
    for c in range(n_chr):
        ln = lib.engine_chr_len(handle, c)
        buf = np.empty(ln, dtype=np.uint8)
        lib.engine_export_chars(handle, c, buf.ctypes.data)
        chroms.append(buf)
    lens = np.asarray([len(c) for c in chroms], dtype=np.int64)
    m = int(lib.engine_live_node_count(handle))
    strand = np.empty(m, dtype=np.int8)
    chrs = np.empty(m, dtype=np.int32)
    pos = np.empty(m, dtype=np.int64)
    bif = np.empty(m, dtype=np.uint32)
    lib.engine_export_nodes(handle, strand.ctypes.data, chrs.ctypes.data,
                            pos.ctypes.data, bif.ctypes.data)

    codes, block_starts = build_supergenome(chroms)
    n = codes.shape[0]
    pad_to = pad_rows(n)
    if pad_to >= (1 << 31):
        return None  # int32 kernel position space exceeded
    # positive-frame node -> supergenome coordinate (strand 1 lives in
    # the rc half at the mirrored local offset)
    block = np.where(strand == 0, chrs, n_chr + chrs)
    local = np.where(strand == 0, pos, lens[chrs] - 1 - pos)
    sg = block_starts[block] + local
    order = np.argsort(sg, kind="stable")
    sg = sg[order].astype(np.int32)
    ids = bif[order].astype(np.int32)

    if pad_to != n:
        codes = np.concatenate([codes,
                                np.zeros(pad_to - n, dtype=codes.dtype)])
    bucket = 1 << max(10, (max(m, n_ids) - 1).bit_length())
    pos_p = np.full(bucket, pad_to, dtype=np.int32)
    ids_p = np.full(bucket, bucket, dtype=np.int32)
    pos_p[:m] = sg
    ids_p[:m] = ids
    note_sync("reprefilter_upload", 3)
    # SIBELIA_TPU_SHARDED=N spreads the prefilter across the mesh (same
    # superset guarantee, topology-invariant; parallel/sharded_sweep.py)
    n_shard = os.environ.get("SIBELIA_TPU_SHARDED")
    cand_d = None
    if n_shard and n_shard.isdigit() and int(n_shard) > 1:
        import jax as _jx
        if len(_jx.devices()) >= int(n_shard):
            from ..parallel.sharded import make_mesh
            from ..parallel.sharded_sweep import sharded_candidate_scan
            cand_d = sharded_candidate_scan(
                codes, pos_p, ids_p, int(k), int(min_branch), m,
                make_mesh(int(n_shard)))
    if cand_d is None:
        cand_d = _candidate_scan(jnp.asarray(codes), jnp.asarray(pos_p),
                                 jnp.asarray(ids_p), int(k),
                                 int(min_branch), jnp.int32(m))
    note_sync("reprefilter_fetch")
    return np.asarray(cand_d[:n_ids]).astype(np.uint8)
