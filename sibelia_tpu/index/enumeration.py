"""Bifurcation enumeration: from chromosome strings to per-strand sorted
bifurcation instance lists.

Reproduces the semantics of the reference's suffix-array scan
(reference: src/vertexenumeration.cpp:160-364) without a suffix array:

  * supergenome = '#' + chr_0 + '#' + ... + '#' + rc(chr_0) + '#' + ...
  * group positions by identical k-mer (device rank kernel)
  * a group is a bifurcation vertex iff its predecessor-char set or
    successor-char set has >1 symbol or touches '#'
    (reference: vertexenumeration.cpp:67-70)
  * positions whose k-mer crosses a chromosome end are not candidates
    (reference: vertexenumeration.cpp:341)
  * a group is counted iff it has >=2 candidates, or any candidate is
    terminal (adjacent to '#') (reference: vertexenumeration.cpp:348)
  * ids are assigned densely in suffix-array order == lexicographic k-mer
    order, which is exactly the rank order from the device kernel

The reference's Flank() pass (vertexenumeration.cpp:72-88) is a no-op here:
enumeration always runs after ambiguous bases have been randomized to ACGT
(reference: src/indexedsequence.cpp:33-37), making IsDefiniteBase true
everywhere.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from .ranking import (CODE_OF, SEP_CODE, _pack_plan, encode, kmer_ranks,
                      pad_rows)

NO_BIFURCATION = (1 << 32) - 1  # reference: BifurcationId(-1), uint32


@dataclass
class BifEnumeration:
    count: int
    # per strand: arrays sorted by (chr, pos); pos is strand-local
    # (for the negative strand: offset within the reverse complement)
    chr: tuple[np.ndarray, np.ndarray]
    pos: tuple[np.ndarray, np.ndarray]
    bif_id: tuple[np.ndarray, np.ndarray]
    # optional uint8[count] bitmap: 1 = the id may have a bulge at stage
    # start (device prefilter, superset of the serial AnyBulges outcome);
    # None when not computed (host paths use the native prefilter)
    candidates: np.ndarray | None = None


_RC = bytes.maketrans(b"ACGT", b"TGCA")

_ENC_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _code in CODE_OF.items():
    _ENC_LUT[ord(_ch)] = _code
    # lowercase maps like uppercase so both strand encodings derive from
    # the same LUT composition: the RC strand complements lowercase acgt
    # to uppercase bases via _COMP_LUT, and without these entries the
    # forward strand would treat 'a' as a separator while the RC strand
    # sees a real T code — a latent strand-symmetry break (production
    # callers always pass sanitized uppercase, so this is hardening)
    _ENC_LUT[ord(_ch.lower())] = _code
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGCatgc", b"TACGtacg"):
    _COMP_LUT[_a] = _b


def revcomp_bytes(s: bytes) -> bytes:
    return s.translate(_RC)[::-1]


def build_supergenome(chromosomes: list[bytes | np.ndarray]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Return (codes, block_starts). Layout mirrors the reference
    (vertexenumeration.cpp:166-183): leading '#', each chromosome followed
    by '#', then each reverse complement followed by '#'. block_starts[b]
    is the supergenome offset of block b (positive blocks then negative).
    Accepts bytes or uint8 arrays; codes are written straight into one
    output buffer (no intermediate join/copy of the genome)."""
    arrs = [np.frombuffer(c, dtype=np.uint8)
            if isinstance(c, (bytes, bytearray))
            else np.asarray(c, dtype=np.uint8) for c in chromosomes]
    total = 1 + 2 * sum(len(a) + 1 for a in arrs)
    codes = np.zeros(total, dtype=np.uint8)  # untouched slots = separators
    starts = []
    off = 1
    for a in arrs:
        starts.append(off)
        codes[off:off + len(a)] = _ENC_LUT[a]
        off += len(a) + 1
    for a in arrs:
        starts.append(off)
        codes[off:off + len(a)] = _ENC_LUT[_COMP_LUT[a]][::-1]
        off += len(a) + 1
    return codes, np.asarray(starts, dtype=np.int64)


# ---------------------------------------------------------------------------
# Device enumeration — lazy delegators (the real formulation lives in
# enum_device.py so the host CLI path never imports jax; see ranking.py)
# ---------------------------------------------------------------------------


def _enum_device_impl(codes, k: int):
    from .enum_device import _enum_device_impl as f
    return f(codes, k)


def _enum_device_k32(codes, k: int):
    from .enum_device import _enum_device_k32 as f
    return f(codes, k)


def _candidate_scan(codes, pos, ids, k, min_branch, n_sel):
    from .enum_device import _candidate_scan as f
    return f(codes, pos, ids, k, min_branch, n_sel)


def _empty_enumeration() -> BifEnumeration:
    e = np.zeros(0, dtype=np.int64)
    ei = np.zeros(0, dtype=np.uint32)
    return BifEnumeration(0, (e, e.copy()), (e.copy(), e.copy()), (ei, ei.copy()))


def _map_selected(sel: np.ndarray, sel_ids: np.ndarray, count: int,
                  block_starts: np.ndarray, n_chr: int) -> BifEnumeration:
    """Map selected supergenome positions + dense ids to the per-strand
    (chr, pos, id) instance lists sorted by (chr, pos)."""
    sel_block = np.searchsorted(block_starts, sel, side="right") - 1
    sel_block = np.clip(sel_block, 0, 2 * n_chr - 1)
    sel_chr = np.where(sel_block < n_chr, sel_block, sel_block - n_chr)
    sel_local = sel - block_starts[sel_block]
    sel_neg = sel_block >= n_chr

    out_chr, out_pos, out_id = [], [], []
    for strand_neg in (False, True):
        m = sel_neg == strand_neg
        c, p, i = sel_chr[m], sel_local[m], sel_ids[m]
        srt = np.lexsort((p, c))
        out_chr.append(c[srt])
        out_pos.append(p[srt])
        out_id.append(i[srt])
    return BifEnumeration(count, tuple(out_chr), tuple(out_pos), tuple(out_id))


def enumerate_bifurcations(chromosomes: list[bytes | np.ndarray], k: int,
                           min_branch: int | None = None) -> BifEnumeration:
    """Enumerate bifurcations; with `min_branch` given, the device path
    additionally computes the bulge-candidate bitmap for the coming
    simplification sweep (BifEnumeration.candidates)."""
    if not chromosomes:
        return _empty_enumeration()

    # multi-chip production path: SIBELIA_TPU_SHARDED=N routes the whole
    # enumeration through the mesh pipeline (parallel/sharded_enum.py);
    # output is byte-identical for any mesh size (topology invariance,
    # tests/test_sharded_enum.py)
    n_shard = os.environ.get("SIBELIA_TPU_SHARDED")
    if n_shard and n_shard.isdigit() and int(n_shard) > 1:
        import jax as _j
        if len(_j.devices()) >= int(n_shard):
            sg_total = 1 + 2 * sum(len(c) + 1 for c in chromosomes)
            if sg_total >= (1 << 31):
                import warnings
                warnings.warn(
                    "supergenome exceeds the sharded pipeline's int32 "
                    "position space; falling back to the host "
                    "enumeration", RuntimeWarning)
            else:
                from ..parallel.sharded_enum import (
                    enumerate_bifurcations_sharded, production_mesh)
                return enumerate_bifurcations_sharded(
                    chromosomes, k, production_mesh(int(n_shard)))

    codes, block_starts = build_supergenome(chromosomes)
    n = codes.shape[0]
    n_chr = len(chromosomes)
    chr_len = np.asarray([len(c) for c in chromosomes], dtype=np.int64)

    # host fast path: the whole ranking + group scan in one native call
    # (identical outputs; see native/ranking.cpp)
    from ..core.platform import device_dispatch
    _use_dev = device_dispatch()
    if _use_dev and n >= (1 << 30):
        # the fused device scans keep (ordinal << 1) and the reverse
        # cummax keys in int32; beyond 2^30 rows they would overflow
        # silently, so fail over to the host enumeration loudly
        # (mirrors the sharded path's 2^31 gate above)
        import warnings
        warnings.warn(
            "supergenome exceeds the single-device enumeration's int32 "
            "scan space; falling back to the host enumeration",
            RuntimeWarning)
        _use_dev = False
    if not _use_dev and n >= (1 << 16):
        from ..core import timings
        from ..native import enumerate_native
        with timings.phase("enum_native"):
            res = enumerate_native(codes, block_starts, n_chr, k)
        if res is not None:
            count, strands = res
            return BifEnumeration(
                count,
                (strands[0][0], strands[1][0]),
                (strands[0][1], strands[1][1]),
                (strands[0][2], strands[1][2]))

    # device path for k > 32: the doubling pipeline of the sharded
    # enumeration on a single-device mesh IS the fully on-device k > 32
    # enumeration (all collectives become local; byte-identical by the
    # topology-invariance tests)
    if _use_dev and k > 32 and n >= (1 << 14):
        from ..parallel.sharded_enum import (enumerate_bifurcations_sharded,
                                             production_mesh)
        return enumerate_bifurcations_sharded(chromosomes, k,
                                              production_mesh(1))

    # Candidate validity == the k-window crosses no separator; derived
    # from the next-separator index in one reverse cummin pass (cheaper
    # than per-position block lookups over the whole supergenome).
    idx = np.arange(n, dtype=np.int64)
    sep_idx = np.where(codes == SEP_CODE, idx, n)
    next_sep = np.minimum.accumulate(sep_idx[::-1])[::-1]
    valid = (codes != SEP_CODE) & (idx + k <= next_sep)

    # Keep only candidate positions; groups are all-candidate or all-dropped
    # (a '#'-free k-mer fits inside its chromosome; see module docstring).
    if _use_dev and k <= 32:
        # device fast path: the whole enumeration (sort + group scan +
        # selection) runs in one fused dispatch; only the selected
        # instances are transferred back
        import jax.numpy as jnp
        pad_to = pad_rows(n)
        codes_p = codes if pad_to == n else np.concatenate(
            [codes, np.zeros(pad_to - n, dtype=codes.dtype)])
        from ..core.platform import note_sync
        codes_d = jnp.asarray(codes_p)
        note_sync("enum_upload")
        pos_d, id_d, n_sel_d, n_groups_d = _enum_device_k32(codes_d, k)
        ns = int(n_sel_d)
        count = int(n_groups_d)
        note_sync("enum_scalar", 2)
        if ns == 0:
            return _empty_enumeration()
        cand = None
        if min_branch is not None and min_branch > 1:
            bucket = 1 << max(10, (ns - 1).bit_length())
            bucket = min(bucket, int(pos_d.shape[0]))
            cand_d = _candidate_scan(codes_d, pos_d[:bucket], id_d[:bucket],
                                     k, int(min_branch), n_sel_d)
            cand = np.asarray(cand_d[:count]).astype(np.uint8)
            note_sync("candidate_fetch")
        sel = np.asarray(pos_d[:ns]).astype(np.int64)
        sel_ids = np.asarray(id_d[:ns]).astype(np.uint32)
        note_sync("enum_fetch", 2)
        res = _map_selected(sel, sel_ids, count, block_starts, n_chr)
        res.candidates = cand
        return res
    else:
        rank, order = kmer_ranks(codes, k)
        keep = order[valid[order]]
        if keep.size == 0:
            return _empty_enumeration()
        kr = rank[keep]
        group_start_mask = np.empty(keep.size, dtype=bool)
        group_start_mask[0] = True
        group_start_mask[1:] = kr[1:] != kr[:-1]
        prev_codes = codes[keep - 1]
        next_code = codes[np.minimum(keep + k, n - 1)]

    starts_idx = np.flatnonzero(group_start_mask)
    group_sizes = np.diff(np.append(starts_idx, keep.size))

    prev_bits = (1 << prev_codes.astype(np.int64))
    next_bits = (1 << next_code.astype(np.int64))
    prev_or = np.bitwise_or.reduceat(prev_bits, starts_idx)
    next_or = np.bitwise_or.reduceat(next_bits, starts_idx)

    def is_bif(bits):
        pop = np.zeros_like(bits)
        for b in range(5):
            pop += (bits >> b) & 1
        return (pop > 1) | ((bits & 1) != 0)

    bif_group = is_bif(prev_or) | is_bif(next_or)

    terminal = (prev_codes == SEP_CODE) | (next_code == SEP_CODE)
    any_terminal = np.bitwise_or.reduceat(terminal.astype(np.int64), starts_idx) != 0
    counted = bif_group & ((group_sizes > 1) | any_terminal)

    ids_per_group = np.cumsum(counted.astype(np.int64)) - 1
    count = int(counted.sum())

    group_of_keep = np.cumsum(group_start_mask.astype(np.int64)) - 1
    pos_counted = counted[group_of_keep]
    sel = keep[pos_counted]
    sel_ids = ids_per_group[group_of_keep[pos_counted]].astype(np.uint32)
    return _map_selected(sel, sel_ids, count, block_starts, n_chr)


def enumerate_bifurcations_oracle(chromosomes: list[bytes], k: int) -> BifEnumeration:
    """Slow, literal re-derivation used as a test oracle: builds the
    supergenome, sorts suffixes with Python, and applies the same scan as
    the reference (vertexenumeration.cpp:263-364). O(n^2 log n); tests only.
    """
    parts = ["#"]
    cum = []
    data = [c.decode() for c in chromosomes]
    off = 1
    for ch in data:
        cum.append(off)
        parts.append(ch + "#")
        off += len(ch) + 1
    for ch in data:
        cum.append(off)
        parts.append(revcomp_bytes(ch.encode()).decode() + "#")
        off += len(ch) + 1
    sg = "".join(parts)
    n = len(sg)
    order = sorted(range(n), key=lambda i: sg[i:])
    count = 0
    out = {0: [], 1: []}
    start = 0

    def lcp(a, b):
        m = 0
        while a + m < n and b + m < n and sg[a + m] == sg[b + m]:
            m += 1
        return m

    while start < n:
        if sg[order[start]] == "#":
            start += 1
            continue
        end = start
        prev_set, next_set = set(), set()
        while True:
            i = order[end]
            if i > 0:
                prev_set.add(sg[i - 1])
            if i + k < n:
                next_set.add(sg[i + k])
            end += 1
            if end >= n or lcp(order[end], order[end - 1]) < k:
                break
        def bif(s):
            return len(s) > 1 or "#" in s
        if bif(prev_set) or bif(next_set):
            cand = []
            terminal = False
            for j in range(start, end):
                suffix = order[j]
                b = 0
                while b + 1 < len(cum) and cum[b + 1] <= suffix:
                    b += 1
                strand = 0 if b < len(data) else 1
                chrom = b if b < len(data) else b - len(data)
                pos = suffix - cum[b]
                if pos + k <= len(data[chrom]):
                    if sg[suffix - 1] == "#" or (suffix + k < n and sg[suffix + k] == "#"):
                        terminal = True
                    cand.append((strand, chrom, pos))
            if len(cand) > 1 or terminal:
                for strand, chrom, pos in cand:
                    out[strand].append((chrom, pos, count))
                count += 1
        start = end

    res_chr, res_pos, res_id = [], [], []
    for strand in (0, 1):
        lst = sorted(out[strand])
        res_chr.append(np.asarray([x[0] for x in lst], dtype=np.int64))
        res_pos.append(np.asarray([x[1] for x in lst], dtype=np.int64))
        res_id.append(np.asarray([x[2] for x in lst], dtype=np.uint32))
    return BifEnumeration(count, tuple(res_chr), tuple(res_pos), tuple(res_id))
