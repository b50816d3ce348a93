"""Multi-chip sharded k-mer index building blocks.

The reference is single-threaded; scale there means external-memory suffix
arrays (reference: src/vertexenumeration.cpp:99-157). Here the scale
axes are a device mesh:

  * 'seq'  — sequence sharding: the supergenome is cut into fixed-size
    windows with a (k-1)-element halo so no k-mer is lost at shard
    boundaries; halos move between devices via ppermute, (k-1) bytes per
    shard boundary (the synteny analogue of ring/sequence parallelism).
  * hash-range exchange — each k-mer key is assigned a bucket by hash
    range; per-shard bucket histograms/payloads are exchanged with
    all_to_all so each device owns a key range (the analogue of tensor
    parallelism for the index table; ~16 B per row leaves and arrives
    per device for the (key1, key2, pos) payload), and
    coverage/occupancy statistics reduce with psum.

This module provides the jittable sharded pipeline step used by the
multi-chip dry run and the scaling bench.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _rolling_keys(shard: jax.Array, halo: jax.Array, k: int) -> jax.Array:
    """Polynomial rolling hash (base 57, mod 2^32 via uint32 wraparound) of
    every k-mer starting in this shard; the halo supplies the k-1 chars
    that spill into the next shard. Mirrors the reference's legacy rolling
    hash (reference: src/hashing.h:54,100) which returns as the device-side
    keying function."""
    ext = jnp.concatenate([shard, halo], axis=0)
    n = shard.shape[0]
    base = jnp.uint32(57)

    def body(carry, i):
        return carry, ext[i]

    # horner evaluation per position via cumulative powers: hash(i) =
    # sum_{j<k} ext[i+j] * 57^(k-1-j). Compute with a scan over j.
    powers = jnp.power(base, jnp.arange(k - 1, -1, -1, dtype=jnp.uint32))
    acc = jnp.zeros((n,), dtype=jnp.uint32)
    for j in range(k):
        acc = acc + ext[j:j + n].astype(jnp.uint32) * powers[j]
    return acc


def sharded_kmer_histogram(k: int, n_buckets_per_dev: int, mesh: Mesh):
    """Build a jitted sharded step: codes [n_dev, shard_len] ->
    (per-device key-range histogram [n_dev, n_buckets_per_dev],
     total distinct-ish count scalar).

    Pipeline inside shard_map:
      1. ppermute halo exchange (next shard's first k-1 chars)
      2. local rolling-hash keys
      3. per-shard histogram over all devices' bucket ranges
      4. all_to_all: each device receives its own bucket range from all
         shards and sums them (index-table ownership by hash range)
      5. psum for global k-mer count (coverage-style reduction)
    """
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]

    def step(codes):
        # 1. halo: receive first (k-1) elements of the *next* shard
        first = jax.lax.dynamic_slice(codes[0], (0,), (k - 1,))
        halo = jax.lax.ppermute(
            first, axis,
            [(i, (i - 1) % n_dev) for i in range(n_dev)])
        # 2. local keys
        keys = _rolling_keys(codes[0], halo, k)
        # 3. histogram over n_dev * n_buckets_per_dev global buckets
        total_buckets = n_dev * n_buckets_per_dev
        bucket = (keys % jnp.uint32(total_buckets)).astype(jnp.int32)
        hist = jnp.zeros((total_buckets,), jnp.int32).at[bucket].add(1)
        # 4. all_to_all: split by owner device, exchange
        hist2 = hist.reshape(n_dev, n_buckets_per_dev)
        mine = jax.lax.all_to_all(hist2[None], axis, split_axis=1,
                                  concat_axis=0, tiled=False)
        # mine: [n_dev, 1, n_buckets_per_dev] — rows from every shard
        owned = jnp.sum(mine, axis=(0,))
        # 5. global count of k-mers via psum
        total = jax.lax.psum(jnp.sum(hist), axis)
        return owned, total

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=(P(axis, None), P()),
        check_vma=False)

    @jax.jit
    def run(codes_sharded):
        return sharded(codes_sharded)

    return run


def dryrun(n_devices: int, k: int = 8, shard_len: int = 256,
           n_buckets_per_dev: int = 16):
    """One full sharded step on tiny shapes; used by the driver's
    multi-chip compile check.  Exercises both the histogram exchange and
    the full hash-range global-rank pipeline."""
    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 5, size=(n_devices, 1, shard_len)).astype(np.int32)
    codes = codes.reshape(n_devices, shard_len)
    sharding = NamedSharding(mesh, P("seq", None))
    codes = jax.device_put(codes, sharding)
    fn = sharded_kmer_histogram(k, n_buckets_per_dev, mesh)
    owned, total = fn(codes)
    owned.block_until_ready()
    assert int(total) == n_devices * shard_len
    if n_devices & (n_devices - 1) == 0:
        u8 = np.asarray(codes, dtype=np.uint8).reshape(-1)
        u8[0] = 0
        u8[-1] = 0
        c2 = jax.device_put(u8.reshape(n_devices, shard_len), sharding)
        rfn = sharded_kmer_ranks(k, shard_len, mesh, capacity=shard_len)
        keys, pos, rank, overflow, tot = rfn(c2)
        rank.block_until_ready()
        assert int(overflow) == 0
    return owned, total


# ---------------------------------------------------------------------------
# Sharded k-mer ranking (the distributed form of index/ranking.py)
# ---------------------------------------------------------------------------


def sharded_kmer_ranks(k: int, shard_len: int, mesh: Mesh,
                       capacity: int | None = None):
    """Build a jitted sharded step computing global dense k-mer ranks.

    codes [n_dev, shard_len] (values 0..4, 0 = separator) ->
      (keys_owned [n_dev, capacity, 2]  — (key1, key2) sorted per owner,
       pos_owned  [n_dev, capacity]     — global positions (-1 = padding),
       rank_owned [n_dev, capacity]     — GLOBAL dense rank per entry,
       overflow   []                    — nonzero if capacity was exceeded)

    The global lexicographic order is preserved by routing on the TOP bits
    of key1: device d owns the contiguous key range with high bits == d,
    so (device, local sorted position) is globally ordered and global
    ranks are local group indices plus an all_gather'd prefix offset.
    k <= 32 (one packed-key round; the staged doubling generalization
    follows the same exchange pattern).  Supports power-of-two meshes.
    """
    assert k <= 32
    n_dev = int(mesh.devices.size)
    axis = mesh.axis_names[0]
    assert n_dev & (n_dev - 1) == 0, "power-of-two mesh"
    dev_bits = n_dev.bit_length() - 1
    if capacity is None:
        capacity = shard_len  # safe worst case; pass smaller with checking

    from ..index.ranking import _pack_plan

    b, m = _pack_plan(k)
    off = m - b

    def step(codes, dev_id):
        codes = codes[0]
        did = dev_id[0]
        n = codes.shape[0]
        # halo: first (m + 40) chars of the next shard so every window
        # starting here can be packed and validity-checked
        halo_len = 40
        first = jax.lax.dynamic_slice(codes, (0,), (halo_len,))
        halo = jax.lax.ppermute(
            first, axis, [(i, (i - 1) % n_dev) for i in range(n_dev)])
        ext = jnp.concatenate([codes, halo])
        idx = jnp.arange(n + halo_len, dtype=jnp.int32)
        sep_idx = jnp.where(ext == 0, idx, jnp.int32(n + halo_len))
        next_sep = jnp.flip(jax.lax.cummin(jnp.flip(sep_idx)))
        p = (ext.astype(jnp.uint32) - 1) & 3
        width = 1
        while width < b:
            p = (p << jnp.uint32(2 * width)) | jnp.concatenate(
                [p[width:], jnp.zeros((width,), jnp.uint32)])
            width *= 2
        key1 = p[:n]
        key2 = jax.lax.dynamic_slice(p, (off,), (n,))
        valid = (jnp.arange(n, dtype=jnp.int32) + m) <= next_sep[:n]
        key1 = jnp.where(valid, key1, jnp.uint32(0xFFFFFFFF))
        key2 = jnp.where(valid, key2, jnp.uint32(0xFFFFFFFF))
        gpos = did * n + jnp.arange(n, dtype=jnp.int32)

        # owner by top bits of key1 (contiguous key ranges per device)
        owner = (key1 >> jnp.uint32(32 - dev_bits)).astype(jnp.int32) \
            if dev_bits else jnp.zeros((n,), jnp.int32)
        # stable local sort by owner; then slot positions into fixed-size
        # per-owner blocks (capacity each), padding with sentinels
        so, sk1, sk2, sp = jax.lax.sort(
            (owner, key1, key2, gpos), num_keys=1, is_stable=True)
        within = jnp.arange(n, dtype=jnp.int32)
        # start offset of each owner's run in the owner-sorted order
        # (empty owners keep the sentinel n, but are never indexed)
        owner_start = jnp.full((n_dev,), n, dtype=jnp.int32).at[so].min(within)
        slot_in_owner = within - owner_start[so]
        send_k1 = jnp.full((n_dev * capacity,), jnp.uint32(0xFFFFFFFF))
        send_k2 = jnp.full((n_dev * capacity,), jnp.uint32(0xFFFFFFFF))
        send_p = jnp.full((n_dev * capacity,), jnp.int32(-1))
        dest = so * capacity + jnp.minimum(slot_in_owner, capacity - 1)
        send_k1 = send_k1.at[dest].set(sk1, mode="drop")
        send_k2 = send_k2.at[dest].set(sk2, mode="drop")
        send_p = send_p.at[dest].set(sp, mode="drop")
        overflow = jnp.max(slot_in_owner) >= capacity

        # all_to_all: block i goes to device i
        rk1 = jax.lax.all_to_all(
            send_k1.reshape(n_dev, capacity)[None], axis,
            split_axis=1, concat_axis=0, tiled=False).reshape(-1)
        rk2 = jax.lax.all_to_all(
            send_k2.reshape(n_dev, capacity)[None], axis,
            split_axis=1, concat_axis=0, tiled=False).reshape(-1)
        rp = jax.lax.all_to_all(
            send_p.reshape(n_dev, capacity)[None], axis,
            split_axis=1, concat_axis=0, tiled=False).reshape(-1)

        # local sort of owned range; sentinels (padding) sort last
        ok1, ok2, op = jax.lax.sort((rk1, rk2, rp), num_keys=2,
                                    is_stable=True)
        real = op >= 0
        grp_new = jnp.concatenate([
            real[:1].astype(jnp.int32),
            ((ok1[1:] != ok1[:-1]) | (ok2[1:] != ok2[:-1])).astype(jnp.int32)
            * real[1:].astype(jnp.int32)])
        local_rank = jnp.cumsum(grp_new) - 1
        n_groups = jnp.where(real, grp_new, 0).sum()
        # rank offset = groups on lower-id devices (all_gather + prefix)
        counts = jax.lax.all_gather(n_groups, axis)
        base = jnp.sum(jnp.where(jnp.arange(n_dev) < did, counts, 0))
        rank = jnp.where(real, local_rank + base, -1)
        total = jax.lax.psum(n_groups, axis)
        keys_owned = jnp.stack([ok1, ok2], axis=-1)
        return (keys_owned[None], op[None], rank[None],
                jax.lax.pmax(overflow.astype(jnp.int32), axis), total)

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                   P(), P()),
        check_vma=False)

    @jax.jit
    def run(codes_sharded):
        dev_ids = jnp.arange(n_dev, dtype=jnp.int32)
        return sharded(codes_sharded, dev_ids)

    return run
