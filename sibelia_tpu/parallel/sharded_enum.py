"""Production multi-chip bifurcation enumeration.

The distributed form of index/enumeration.py: the supergenome is cut
into per-device position shards, k-mer keys are extracted locally
(halo exchange via ppermute), and grouping runs as a
distributed sample sort — local sort, splitter selection from gathered
order statistics, all_to_all exchange into contiguous key ranges, local
segmented ranking, all_gather'd prefix offsets.  k > 32 refines by
prefix doubling: each round all_gathers the rank vector, forms
(rank[i], rank[i+shift]) pair keys, and re-ranks with the same exchange.
The final scan routes (rank, prev_char, next_char, terminal) tuples to
rank-range owners — a key group has a single rank value, so groups are
atomic per owner — where the bifurcation rule of the reference
(src/vertexenumeration.cpp:67-70,227-245) and dense id assignment run as
segmented reductions; only the selected instances return to the host.

Topology invariance: splitters only decide WHERE work happens; ranks,
group statistics, and dense ids are exact functions of the supergenome,
so any mesh size (including 1) produces byte-identical output —
asserted by tests/test_sharded_enum.py against the host path.

Routing capacities are data-dependent (sample sort bounds them only
probabilistically); every exchange reports overflow and the host wrapper
retries with doubled capacity (a fresh jit) up to the worst case, so
overflow is handled, not just detected.

Collective traffic per enumeration of N supergenome rows over D devices
(true on any interconnect; timings from a virtual CPU mesh say nothing
about it, since that mesh serializes collectives on the host's cores):

  * halo ppermute: (k-1) bytes per device pair boundary — negligible.
  * splitter all_gather: 64*D order statistics — negligible.
  * key all_to_all (k <= 32: once; k > 32: once per doubling round):
    ~16 B/row leaves and ~16 B/row arrives per device, uniformly
    spread, i.e. (N/D)*16 B per device per round.
  * final scan routing all_to_all: ~12 B/selected-row (selected rows
    are the bifurcation instances, typically ~5-10% of N).
  * k > 32 doubling all_gather of the rank vector: 4*N bytes INTO each
    device per round — the one unpartitioned term and therefore the
    multi-chip scalability limiter for large k (ceil(log2(k/32))
    rounds).
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.enumeration import (BifEnumeration, _empty_enumeration,
                                 _map_selected, build_supergenome)
from ..core.platform import note_sync
from ..index.ranking import SEP_CODE, _pack_plan

_SENT32 = jnp.uint32(0xFFFFFFFF)
_SAMPLES = 64  # per-device order-statistic samples for splitter selection


def _doubling_shifts(k: int) -> tuple[int, ...]:
    """Prefix-doubling shift schedule covering exactly k chars from the
    initial min(k,32)-char keys (overlapping last step, the standard
    exact-length trick also used by index/ranking.py)."""
    shifts = []
    cover = min(k, 32)
    while cover < k:
        s = min(cover, k - cover)
        shifts.append(s)
        cover += s
    return tuple(shifts)


def _owner_of(a, b, spl_a, spl_b):
    """Contiguous range owner per (a, b) key — the count of splitters
    strictly below the key. A function of the key alone, so equal keys
    share an owner and key groups never straddle devices."""
    less = (spl_a[:, None] < a[None, :]) | (
        (spl_a[:, None] == a[None, :]) & (spl_b[:, None] < b[None, :]))
    return jnp.sum(less.astype(jnp.int32), axis=0)


def _exchange(cells, axis, n_dev, cap):
    """all_to_all a [n_dev * cap] send buffer laid out as per-owner cells;
    returns the flattened receive buffer [n_dev * cap]."""
    return jax.lax.all_to_all(
        cells.reshape(n_dev, cap)[None], axis,
        split_axis=1, concat_axis=0, tiled=False).reshape(-1)


def _slot_in_run(owner, real):
    """Slot index of each element within its owner's contiguous run;
    elements arrive sorted by owner (monotone in the sort key)."""
    n = owner.shape[0]
    within = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.where(
        jnp.concatenate([jnp.ones((1,), jnp.bool_), owner[1:] != owner[:-1]]),
        within, 0)
    return within - jax.lax.cummax(run_start)


def _rank_round(a, b, vflag, gpos, did, axis, n_dev, L, cap, cap_back):
    """One distributed ranking round: dense global ranks of (a, b) pair
    keys over elements with vflag set, delivered back in position order.
    Elements without vflag are dropped from the exchange and take rank
    n_dev * L.  Validity travels OUT-OF-BAND (the flag, and gpos >= 0 on
    the receive side), so a genuine all-ones key — e.g. a valid all-T
    window — is never mistaken for padding.
    Returns (rank_pos [L] int32, overflow flag)."""
    N = n_dev * L
    # local sort by (invalid, key) so valid elements lead their key ties
    # and owners form contiguous runs
    inval = (~vflag).astype(jnp.uint32)
    si, sa, sb, sg = jax.lax.sort((inval, a, b, gpos), num_keys=3,
                                  is_stable=False)
    real = si == 0

    # splitters: gathered order statistics of the local sorted keys
    samp = (jnp.arange(_SAMPLES, dtype=jnp.int32) * L) // _SAMPLES
    ga = jax.lax.all_gather(sa[samp], axis, tiled=True)
    gb = jax.lax.all_gather(sb[samp], axis, tiled=True)
    gsa, gsb = jax.lax.sort((ga, gb), num_keys=2, is_stable=False)
    tot = n_dev * _SAMPLES
    spl_idx = (jnp.arange(1, n_dev, dtype=jnp.int32) * tot) // n_dev
    spl_a, spl_b = gsa[spl_idx], gsb[spl_idx]

    owner = jnp.where(real, _owner_of(sa, sb, spl_a, spl_b),
                      jnp.int32(n_dev))
    slot = _slot_in_run(owner, real)
    dest = jnp.where(real, owner * cap + slot, jnp.int32(n_dev * cap))
    overflow = jnp.max(jnp.where(real, slot, 0)) >= cap

    send_a = jnp.full((n_dev * cap,), _SENT32).at[dest].set(sa, mode="drop")
    send_b = jnp.full((n_dev * cap,), _SENT32).at[dest].set(sb, mode="drop")
    send_g = jnp.full((n_dev * cap,), jnp.int32(-1)).at[dest].set(
        sg, mode="drop")
    ra = _exchange(send_a, axis, n_dev, cap)
    rb = _exchange(send_b, axis, n_dev, cap)
    rg = _exchange(send_g, axis, n_dev, cap)

    # local rank of the owned key range; padding rows (gpos < 0) sort
    # after real rows of the same key and never open a group
    rpad = (rg < 0).astype(jnp.uint32)
    oa, ob, opad, og = jax.lax.sort((ra, rb, rpad, rg), num_keys=3,
                                    is_stable=False)
    oreal = opad == 0
    newgrp = jnp.concatenate([
        oreal[:1].astype(jnp.int32),
        (((oa[1:] != oa[:-1]) | (ob[1:] != ob[:-1]))
         & oreal[1:]).astype(jnp.int32)])
    local_rank = jnp.cumsum(newgrp) - 1
    n_groups = jnp.sum(newgrp)
    counts = jax.lax.all_gather(n_groups, axis, tiled=False)
    base = jnp.sum(jnp.where(jnp.arange(n_dev) < did, counts, 0))
    grank = jnp.where(oreal, local_rank + base, jnp.int32(N)).astype(jnp.int32)

    # route (gpos, rank) back to position owners (gpos // L — exact)
    sown, srank, sgp = jax.lax.sort(
        (jnp.where(oreal, og // L, jnp.int32(n_dev)), grank, og),
        num_keys=1, is_stable=True)
    breal = sown < n_dev
    bslot = _slot_in_run(sown, breal)
    bdest = jnp.where(breal, sown * cap_back + bslot,
                      jnp.int32(n_dev * cap_back))
    overflow = overflow | (jnp.max(jnp.where(breal, bslot, 0)) >= cap_back)
    back_r = jnp.full((n_dev * cap_back,), jnp.int32(N)).at[bdest].set(
        srank, mode="drop")
    back_g = jnp.full((n_dev * cap_back,), jnp.int32(-1)).at[bdest].set(
        sgp, mode="drop")
    rr = _exchange(back_r, axis, n_dev, cap_back)
    rgp = _exchange(back_g, axis, n_dev, cap_back)
    local = jnp.where(rgp >= 0, rgp - did * L, jnp.int32(n_dev * cap_back))
    rank_pos = jnp.full((L,), jnp.int32(N)).at[local].set(rr, mode="drop")
    return rank_pos, overflow


def _build_step(k: int, L: int, n_dev: int, axis: str, cap: int,
                cap_back: int, cap_scan: int):
    """Construct the shard_map body for one (k, shapes) configuration."""
    shifts = _doubling_shifts(k)
    b, m = _pack_plan(k)
    off = m - b
    HK = k + 8
    N = n_dev * L
    rank_chunk = -(-N // n_dev)

    def step(codes_blk, dev_blk):
        codes = codes_blk[0]
        did = dev_blk[0]
        # ---- phase A: halo exchange, keys, validity, neighbor chars
        fwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        nxt = jax.lax.ppermute(codes[:HK], axis, fwd)
        prv = jax.lax.ppermute(codes[-1:], axis, bwd)
        ext = jnp.concatenate([codes, nxt])
        idxe = jnp.arange(L + HK, dtype=jnp.int32)
        sep_idx = jnp.where(ext == SEP_CODE, idxe, jnp.int32(L + HK))
        next_sep = jnp.flip(jax.lax.cummin(jnp.flip(sep_idx)))
        pos_l = jnp.arange(L, dtype=jnp.int32)
        notsep = codes != SEP_CODE

        def valid_at(c):
            return ((pos_l + c) <= next_sep[:L]) & notsep

        valid = valid_at(k)
        # wrap-around halos at the mesh edges carry no information the
        # supergenome layout does not already guarantee: the text begins
        # and ends with separators
        prev_c = jnp.concatenate([prv, codes[:-1]])
        nxt_c = ext[k:k + L]
        p = (ext.astype(jnp.uint32) - 1) & 3
        width = 1
        while width < b:
            p = (p << jnp.uint32(2 * width)) | jnp.concatenate(
                [p[width:], jnp.zeros((width,), jnp.uint32)])
            width *= 2
        gpos = did * L + pos_l

        # ---- ranking rounds: rank every position whose CURRENT cover
        # window is separator-free (classic prefix doubling ranks by
        # cover-length prefixes; a full-k-valid position's sub-windows
        # are always cover-valid, so the final ranks are well-defined)
        rank_pos, of = _rank_round(p[:L], p[off:off + L], valid_at(m),
                                   gpos, did, axis, n_dev, L, cap, cap_back)
        # the doubling rounds share shapes, so they run as one loop: the
        # round (three large sorts) compiles once for any k
        shift_of = jnp.asarray(shifts, jnp.int32)
        cover_of = jnp.asarray(np.cumsum(shifts, dtype=np.int64) + m,
                               jnp.int32)

        def doubling_round(i, carry):
            rank_pos, of = carry
            allr = jax.lax.all_gather(rank_pos, axis, tiled=True)
            shifted = jax.lax.dynamic_slice(
                jnp.concatenate([allr, jnp.full((HK,), jnp.int32(N))]),
                (did * L + shift_of[i],), (L,))
            rank_pos, ofr = _rank_round(
                rank_pos.astype(jnp.uint32), shifted.astype(jnp.uint32),
                valid_at(cover_of[i]), gpos, did, axis, n_dev, L, cap,
                cap_back)
            return rank_pos, of | ofr

        if shifts:
            rank_pos, of = jax.lax.fori_loop(0, len(shifts), doubling_round,
                                             (rank_pos, of))

        # ---- scan phase: route valid tuples to rank-range owners
        owner = jnp.where(valid, rank_pos // rank_chunk, jnp.int32(n_dev))
        sown, srank, sprev, snext, sgp = jax.lax.sort(
            (owner, rank_pos, prev_c.astype(jnp.int32),
             nxt_c.astype(jnp.int32), gpos), num_keys=2, is_stable=False)
        sreal = sown < n_dev
        slot = _slot_in_run(sown, sreal)
        dest = jnp.where(sreal, sown * cap_scan + slot,
                         jnp.int32(n_dev * cap_scan))
        of = of | (jnp.max(jnp.where(sreal, slot, 0)) >= cap_scan)

        def send(vals, fill):
            buf = jnp.full((n_dev * cap_scan,), fill).at[dest].set(
                vals, mode="drop")
            return _exchange(buf, axis, n_dev, cap_scan)

        rrank = send(srank, jnp.int32(N))
        rprev = send(sprev, jnp.int32(-1))
        rnext = send(snext, jnp.int32(-1))
        rgp = send(sgp, jnp.int32(-1))
        orank, oprev, onext, ogp = jax.lax.sort(
            (rrank, rprev, rnext, rgp), num_keys=1, is_stable=False)
        oreal = orank < N
        M = orank.shape[0]
        iota = jax.lax.broadcasted_iota(jnp.int32, (M,), 0)
        start = jnp.concatenate([
            oreal[:1], (orank[1:] != orank[:-1]) & oreal[1:]])
        sidx = jax.lax.cummax(jnp.where(start, iota, 0))
        nxt_after = jnp.concatenate(
            [jnp.where(start, iota, jnp.int32(M))[1:],
             jnp.full((1,), M, jnp.int32)])
        eidx = jnp.flip(jax.lax.cummin(jnp.flip(nxt_after))) - 1

        def seg_tot(ind):
            cs = jnp.cumsum(ind.astype(jnp.int32))
            lo = jnp.where(sidx > 0, jnp.take(cs, jnp.maximum(sidx - 1, 0)), 0)
            return jnp.take(cs, eidx) - lo

        prev_distinct = jnp.zeros((M,), jnp.int32)
        next_distinct = jnp.zeros((M,), jnp.int32)
        prev_sep = jnp.zeros((M,), jnp.bool_)
        next_sep_f = jnp.zeros((M,), jnp.bool_)
        for c in range(5):
            pb = seg_tot(oreal & (oprev == c)) > 0
            nb = seg_tot(oreal & (onext == c)) > 0
            prev_distinct += pb.astype(jnp.int32)
            next_distinct += nb.astype(jnp.int32)
            if c == SEP_CODE:
                prev_sep = pb
                next_sep_f = nb
        bif = ((prev_distinct > 1) | prev_sep
               | (next_distinct > 1) | next_sep_f)
        n_members = seg_tot(oreal)
        terminal = seg_tot(oreal & ((oprev == SEP_CODE)
                                    | (onext == SEP_CODE))) > 0
        counted = bif & ((n_members > 1) | terminal)

        local_groups = jnp.sum((start & counted).astype(jnp.int32))
        counts = jax.lax.all_gather(local_groups, axis, tiled=False)
        base = jnp.sum(jnp.where(jnp.arange(n_dev) < did, counts, 0))
        ids = base + jnp.cumsum((start & counted).astype(jnp.int32)) - 1
        total = jax.lax.psum(local_groups, axis)

        sel = oreal & counted
        out_pos = jnp.where(sel, ogp, jnp.int32(-1))
        out_id = jnp.where(sel, ids, jnp.int32(-1))
        of_any = jax.lax.pmax(of.astype(jnp.int32), axis)
        return (out_pos[None], out_id[None], total, of_any)

    return step


@functools.lru_cache(maxsize=32)
def _compiled_step(k: int, L: int, n_dev: int, axis: str, cap: int,
                   cap_back: int, cap_scan: int, mesh_key):
    mesh = _MESHES[mesh_key]
    step = _build_step(k, L, n_dev, axis, cap, cap_back, cap_scan)
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(), P()))

    @jax.jit
    def run(codes_sharded):
        dev_ids = jnp.arange(n_dev, dtype=jnp.int32)
        return sharded(codes_sharded, dev_ids)

    return run


_MESHES: dict[int, Mesh] = {}


@functools.lru_cache(maxsize=8)
def production_mesh(n_devices: int) -> Mesh:
    """The cached pipeline mesh for SIBELIA_TPU_SHARDED=N runs (a fresh
    Mesh per call would defeat the compiled-step cache)."""
    devs = jax.devices()[:n_devices]
    return Mesh(np.asarray(devs), ("seq",))


def shard_len(n0: int, n_dev: int, k: int) -> int:
    """Rows per device for an n0-row supergenome: a power of two, so
    stages whose sequence shrinks reuse one compiled step per k
    (1024-row granularity where a power of two would leave the int32
    position space)."""
    L = max(-(-n0 // n_dev), 2048)
    L2 = 1 << (L - 1).bit_length()
    L = L2 if n_dev * L2 < (1 << 31) else -(-L // 1024) * 1024
    while L < k + 16:
        L *= 2
    return L


def enumerate_bifurcations_sharded(chromosomes: list[bytes], k: int,
                                   mesh: Mesh) -> BifEnumeration:
    """Sharded twin of index.enumeration.enumerate_bifurcations: same
    BifEnumeration, byte-identical for any mesh size."""
    if not chromosomes:
        return _empty_enumeration()
    # int32 position space: checked from lengths alone, before any
    # buffer is built (the reference's 1 GB input cap would pass this,
    # but the supergenome is ~2x the input + separators, so a legal
    # input can exceed it; callers fall back to the host path)
    total = 1 + 2 * sum(len(c) + 1 for c in chromosomes)
    if total >= (1 << 31):
        raise ValueError("sharded enumeration: supergenome exceeds int32 "
                         "position space")
    codes, block_starts = build_supergenome(chromosomes)
    n0 = int(codes.shape[0])
    n_chr = len(chromosomes)
    n_dev = int(mesh.devices.size)
    axis = mesh.axis_names[0]
    L = shard_len(n0, n_dev, k)
    N = n_dev * L
    padded = np.zeros(N, dtype=np.uint8)
    padded[:n0] = codes
    sharding = NamedSharding(mesh, P(axis, None))
    padded2d = padded.reshape(n_dev, L)
    if jax.process_count() > 1:
        # multi-host SPMD: every process reads the (small) input and
        # contributes its addressable shards of the global array
        note_sync("enum_upload")
        codes_dev = jax.make_array_from_callback(
            padded2d.shape, sharding, lambda idx: padded2d[idx])
    else:
        codes_dev = jax.device_put(padded2d, sharding)

    mesh_key = id(mesh)
    _MESHES[mesh_key] = mesh
    cap = -(-2 * L // n_dev) + 256
    cap_back = cap
    cap_scan = cap
    while True:
        run = _compiled_step(k, L, n_dev, axis, min(cap, L),
                             min(cap_back, L), min(cap_scan, L), mesh_key)
        out_pos, out_id, total, of = run(codes_dev)
        note_sync("enum_scalar")
        if int(of) == 0:
            break
        if cap >= L:
            raise RuntimeError("sharded enumeration exchange overflow at "
                               "worst-case capacity")
        cap *= 2
        cap_back *= 2
        cap_scan *= 2

    note_sync("enum_scalar")
    count = int(total)
    if count == 0:
        return _empty_enumeration()
    if jax.process_count() > 1:
        # gather the selected instances to every host so the result is
        # identical on all processes (multi-controller SPMD contract)
        from jax.experimental import multihost_utils
        pos_h = np.asarray(
            multihost_utils.process_allgather(out_pos, tiled=True)
        ).reshape(-1)
        id_h = np.asarray(
            multihost_utils.process_allgather(out_id, tiled=True)
        ).reshape(-1)
    else:
        pos_h = np.asarray(out_pos).reshape(-1)
        id_h = np.asarray(out_id).reshape(-1)
        note_sync("enum_fetch", 2)
    m = pos_h >= 0
    sel = pos_h[m].astype(np.int64)
    sel_ids = id_h[m].astype(np.uint32)
    order = np.argsort(sel, kind="stable")
    return _map_selected(sel[order], sel_ids[order], count,
                         block_starts, n_chr)
