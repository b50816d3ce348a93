"""Fully on-device bifurcation enumeration (the device hot path).

Split from enumeration.py so the host CLI path never imports jax; the
algebra and provenance comments are unchanged.
"""
from __future__ import annotations

import functools

import jax as _jax

from .ranking import SEP_CODE, _pack_plan
from .ranking_device import _packed_keys

# ---------------------------------------------------------------------------
# Fully on-device enumeration (the device hot path)
#
# One stable device sort of the packed key pair delivers positions in
# k-mer order; the whole group scan — prev/next char sets, the
# bifurcation rule of vertexenumeration.cpp:67-70/227-245, terminal
# flags, dense id assignment, and instance selection — then runs as
# cumsum-based segmented reductions on device, and a final single-key
# sort packs the selected instances (ascending supergenome position)
# into a prefix so the host transfers exactly n_sel elements, nothing
# else.  No host round-trip happens between the sort and the selection.
# ---------------------------------------------------------------------------


def _enum_device_impl(codes, k: int):
    """Fused device enumeration for k <= 32 (traceable body).

    One sort delivers every VALID position grouped by k-mer in
    lexicographic order as a contiguous prefix.  For k <= 31 the key is
    a (key1, low-bits-of-key2) u32 pair with a spare low bit that keeps
    the invalid-window sentinel distinct from a genuine all-T window, so
    only TWO sort keys are compared; the neighbor chars ride as inert
    payload (k == 32 needs the third key for the sentinel/all-T tie).

    The bifurcation + counting rule (vertexenumeration.cpp:67-70,
    227-245) is evaluated with THREE segmented scans and no gathers:

      A[i] — some adjacent in-segment pair differs in (prev, next)
             <=> the group has >1 distinct prev or >1 distinct next;
      B[i] — this member touches a separator (prev==0 or next==0);
      counted = segOR(B) | (segOR(A) & members>1)

    which is algebraically the reference rule ((#prev>1 | prev has '#'
    | #next>1 | next has '#') AND (members>1 | any terminal member)):
    segment ORs are cummax over (ordinal<<1 | flag), `members>1` at a
    segment's last row is just "that row is not a segment start", and a
    reverse cummax broadcasts the last-row verdict over the segment.  A
    final single-key sort packs the selected instances ascending by
    position so the host transfers exactly n_sel elements.
    """
    import jax
    import jax.numpy as jnp

    n = codes.shape[0]
    key1, key2, next_sep = _packed_keys(codes, k)
    b, m = _pack_plan(k)
    iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    valid = (iota + k) <= next_sep
    prev_all = jnp.concatenate([codes[:1], codes[:-1]]).astype(jnp.uint32)
    next_all = jnp.concatenate(
        [codes[k:], jnp.zeros((k,), codes.dtype)]).astype(jnp.uint32)
    aux = (prev_all << 3) | next_all  # 6 bits; only valid rows matter

    if m <= 31:
        low_bits = 2 * (m - b)
        sk2v = (key2 & jnp.uint32((1 << low_bits) - 1)) << 1
        sk2v = jnp.where(valid, sk2v, jnp.uint32(0xFFFFFFFF))
        sk1, sk2, saux, order = jax.lax.sort((key1, sk2v, aux, iota),
                                             num_keys=2, is_stable=False)
    else:
        aux3 = ((~valid).astype(jnp.uint32) << 6) | aux
        sk1, sk2, saux, order = jax.lax.sort((key1, key2, aux3, iota),
                                             num_keys=3, is_stable=False)
        saux = saux & 63
    nv = jnp.sum(valid.astype(jnp.int32))
    ids, poskey, n_groups, n_sel = _segment_scan(sk1, sk2, saux, order, nv)
    # pack selected instances ascending by supergenome position
    pos_sorted, id_sorted = jax.lax.sort((poskey, ids), num_keys=1,
                                         is_stable=False)
    return pos_sorted, id_sorted, n_sel, n_groups


def _segment_scan(sk1, sk2, saux, order, nv):
    """The post-sort group scan of the fused enumeration (traceable).

    sk1/sk2: sorted key pair (valid rows are the prefix [0, nv));
    saux: sorted (prev << 3 | next) neighbor codes; order: sorted
    supergenome positions.  Returns (ids, poskey, n_groups, n_sel):
    the dense id of each row's counted group (in sorted order), the
    position of each selected row (n for unselected rows), the counted
    group count and the selected row count."""
    import jax
    import jax.numpy as jnp

    n = sk1.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    isval = iota < nv  # valid rows are exactly the sorted prefix
    start = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])])
    # Force a segment boundary at the first invalid row: at k == 32 the
    # 3-key path's (sk1, sk2) are 0xFFFFFFFF for BOTH a genuine all-T
    # window and the invalid-window sentinel, so without this the all-T
    # group would merge with the sentinel cluster and its verdict would
    # be computed at an invalid row (at k <= 31 the spare key bit keeps
    # them distinct and this is a no-op).
    start = start | (iota == nv)

    prev_aux = jnp.concatenate([saux[:1], saux[:-1]])
    A = ((~start) & (prev_aux != saux)).astype(jnp.int32)
    B = (((saux >> 3) == 0) | ((saux & 7) == 0)).astype(jnp.int32)

    ordinal = jnp.cumsum(start.astype(jnp.int32))
    seg_or_a = jax.lax.cummax((ordinal << 1) | A) & 1
    seg_or_b = jax.lax.cummax((ordinal << 1) | B) & 1
    is_end = jnp.concatenate([start[1:], jnp.ones((1,), jnp.bool_)])
    counted_end = jnp.where(
        is_end,
        seg_or_b | (seg_or_a & (~start).astype(jnp.int32)),
        0)
    # broadcast each segment's last-row verdict back over its rows: in
    # flipped order the end row comes first, so a cummax keyed by the
    # (flipped-monotone) ordinal holds it across the segment
    max_ord = ordinal[n - 1]
    fkey = ((max_ord - jnp.flip(ordinal)) << 1) | jnp.flip(counted_end)
    counted = (jnp.flip(jax.lax.cummax(fkey)) & 1).astype(jnp.bool_)

    # dense ids over counted groups, in sorted (== lexicographic) order;
    # the sentinel cluster's start row sits at index nv, so the isval
    # mask keeps it out of the numbering
    id_cums = jnp.cumsum((start & counted & isval).astype(jnp.int32))
    ids = id_cums - 1
    n_groups = id_cums[-1]

    sel = counted & isval
    n_sel = jnp.sum(sel.astype(jnp.int32))
    poskey = jnp.where(sel, order, jnp.int32(n))
    return ids, poskey, n_groups, n_sel


# banded self-join width for the device bulge-candidate prefilter: pairs
# beyond this many instances apart fall back to a conservative
# "candidate" flag (superset-safe), bounding the tuple tensor statically
_CAND_BAND = 48


@functools.partial(_jax.jit, static_argnums=(3, 4))
def _candidate_scan(codes, pos, ids, k: int, min_branch: int, n_sel):
    """Device bulge-candidate prefilter over the packed instance table.

    A vertex can only have a bulge when two of its instances, with
    different end chars, reach a common bifurcation within min_branch
    steps (reference: src/bulgeremoval.cpp:158-218).  In supergenome
    coordinates every walk runs forward (rc-half instances ARE the
    negative strand), so walk membership is a banded self-join over the
    position-sorted instance table: member q belongs to owner p's walk
    iff 1 <= q - p < min_branch and q precedes p's block end.  Tuples
    (owner_id, member_id, owner_end_char) for all bands 1.._CAND_BAND are
    sorted by (owner_id, member_id); a group holding two distinct end
    chars marks owner_id as a candidate.  Owners whose band overflows
    _CAND_BAND are flagged conservatively.  The result is a SUPERSET of
    "AnyBulges reports a group" (walk truncation at the start id and the
    claim order only remove pairs), which is all the sparse sweep driver
    needs (engine.cpp:engine_simplify_sparse).

    pos/ids: int32[B] packed instance positions (supergenome frame,
    ascending) and dense ids; rows >= n_sel are padding.  Returns
    bool[B]: candidate flag per id (indexed by id, not row).
    """
    import jax
    import jax.numpy as jnp

    n = codes.shape[0]
    B = pos.shape[0]
    idxp = jnp.arange(n, dtype=jnp.int32)
    sep_idx = jnp.where(codes == SEP_CODE, idxp, jnp.int32(n))
    next_sep = jnp.flip(jax.lax.cummin(jnp.flip(sep_idx)))

    rows = jnp.arange(B, dtype=jnp.int32)
    row_ok = rows < n_sel
    p = jnp.where(row_ok, pos, jnp.int32(n))
    ns = jnp.where(row_ok, jnp.take(next_sep, jnp.minimum(p, n - 1)), 0)
    # end char exists iff the (k+1)-window stays inside the block
    # (reference ProperKMer, src/dnasequence.h:154-165)
    ec = jnp.where(row_ok & (p + k < ns),
                   jnp.take(codes, jnp.minimum(p + k, n - 1)).astype(jnp.int32),
                   jnp.int32(-1))
    v = jnp.where(row_ok, ids, jnp.int32(B))

    SENT = jnp.int32(2**31 - 1)
    owner_k, member_k, ec_k = [], [], []
    overflow = jnp.zeros((B,), jnp.bool_)
    for o in range(1, _CAND_BAND + 1):
        mp = jnp.concatenate([p[o:], jnp.full((o,), n, jnp.int32)])
        mv = jnp.concatenate([v[o:], jnp.full((o,), B, jnp.int32)])
        m_ok = jnp.concatenate([row_ok[o:], jnp.zeros((o,), jnp.bool_)])
        gap = mp - p
        ok = (row_ok & m_ok & (ec >= 0) & (gap >= 1)
              & (gap < min_branch) & (mp < ns))
        if o == _CAND_BAND:
            # positions ascend, so an in-window member at the band edge
            # is the only way unseen pairs can exist beyond it
            overflow = ok
        owner_k.append(jnp.where(ok, v, SENT))
        member_k.append(jnp.where(ok, mv, SENT))
        ec_k.append(jnp.where(ok, ec, jnp.int32(-1)))

    ko = jnp.concatenate(owner_k)
    km = jnp.concatenate(member_k)
    ke = jnp.concatenate(ec_k)
    sko, skm, ske = jax.lax.sort((ko, km, ke), num_keys=2, is_stable=False)
    same = (sko[1:] == sko[:-1]) & (skm[1:] == skm[:-1]) & (sko[1:] != SENT)
    hit = same & (ske[1:] != ske[:-1])
    cand = jnp.zeros((B + 1,), jnp.bool_)
    cand = cand.at[jnp.where(hit, sko[1:], jnp.int32(B))].max(hit)
    cand = cand.at[jnp.where(overflow, v, jnp.int32(B))].max(overflow)
    return cand[:B]


@functools.partial(_jax.jit, static_argnums=(1,))
def _enum_device_k32(codes, k: int):
    """Fused device enumeration for k <= 32: one jit dispatch."""
    return _enum_device_impl(codes, k)


