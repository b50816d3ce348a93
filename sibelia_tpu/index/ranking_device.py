"""Device-side (JAX) k-mer ranking formulation.

Split from ranking.py so the host CLI path never imports jax (a ~2 s
interpreter-startup cost the reference binary does not pay); see the
module docstring there for the algorithm.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ranking import SEP_CODE, _SENT32, _pack_plan, pad_rows

# ---------------------------------------------------------------------------
# JAX path
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1,))
def _packed_keys(codes: jax.Array, k: int):
    """(key1, key2, kvalid): overlapped packed keys covering min(k,32)
    chars and the min(k,32)-validity mask."""
    n = codes.shape[0]
    b, m = _pack_plan(k)
    pad = 40
    c = jnp.concatenate([codes.astype(jnp.uint32),
                         jnp.zeros((pad,), jnp.uint32)])
    idx = jnp.arange(n + pad, dtype=jnp.int32)
    sep_idx = jnp.where(c == SEP_CODE, idx, jnp.int32(n + pad))
    next_sep = jnp.flip(jax.lax.cummin(jnp.flip(sep_idx)))
    p = (c - 1) & 3
    width = 1
    while width < b:
        p = (p << (2 * width)) | jnp.concatenate(
            [p[width:], jnp.zeros((width,), jnp.uint32)])
        width *= 2
    key1 = p[:n]
    off = m - b
    key2 = jax.lax.dynamic_slice(p, (off,), (n,))
    valid = (jnp.arange(n, dtype=jnp.int32) + m) <= next_sep[:n]
    key1 = jnp.where(valid, key1, _SENT32)
    key2 = jnp.where(valid, key2, _SENT32)
    return key1, key2, next_sep[:n]


def _inverse_permute(sidx, values):
    """values placed at positions sidx — via a sort keyed by sidx (unique),
    instead of the equivalent scatter."""
    _, out = jax.lax.sort((sidx, values), num_keys=1, is_stable=False)
    return out


@functools.partial(jax.jit, static_argnums=(1,))
def _rank_sort_u32(keys, n: int):
    key1, key2 = keys
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    sk1, sk2, sidx = jax.lax.sort((key1, key2, idx), num_keys=2,
                                  is_stable=True)
    flag = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        ((sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])).astype(jnp.int32)])
    nr = jnp.cumsum(flag)
    rank = _inverse_permute(sidx, nr)
    return rank, sidx, nr[-1]


@functools.partial(jax.jit, static_argnums=(1,))
def _rank_round(r_ext: jax.Array, n: int, off):
    k1 = r_ext[:n]
    k2 = jax.lax.dynamic_slice(r_ext, (off,), (n,))
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    sk1, sk2, sidx = jax.lax.sort((k1, k2, idx), num_keys=2, is_stable=True)
    flag = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        ((sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])).astype(jnp.int32)])
    nr = jnp.cumsum(flag)
    max_rank = nr[-1]
    r_new = _inverse_permute(sidx, nr)
    r_ext_new = jax.lax.dynamic_update_slice(r_ext, r_new, (0,))
    return r_ext_new, sidx, max_rank


@functools.partial(jax.jit, static_argnums=(1,))
def kmer_sorted_groups_jax(codes: jax.Array, k: int):
    """Fused single-sort enumeration step for k <= 32 (the device hot op).

    ONE stable sort of the overlapped packed key pair with the position
    iota as the only payload yields everything the bifurcation scan needs
    in sorted order:

      order  — positions sorted by k-mer (the argsort itself),
      gid    — dense group id per sorted slot (cumsum of key-change flags),
      prev/next neighbor codes — post-sort gathers (two jnp.take passes
               instead of carrying payload lanes through every stage of
               the sorting network).

    Replaces the earlier two-sort formulation: per-position ranks (the
    second sort, an inverse permutation) are never needed — the group scan
    is driven entirely by sorted-order group boundaries, mirroring the
    native host kernel's gflag scan (native/ranking.cpp).
    """
    n = codes.shape[0]
    key1, key2, _ = _packed_keys(codes, k)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    # appending idx as a third key (unique) == stable sort, letting XLA
    # skip its internal tie-break iota
    sk1, sk2, order = jax.lax.sort((key1, key2, idx), num_keys=3,
                                   is_stable=False)
    newgrp = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        ((sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])).astype(jnp.int32)])
    gid = jnp.cumsum(newgrp)
    prev_code = jnp.take(codes, jnp.maximum(order - 1, 0))
    next_code = jnp.take(codes, jnp.minimum(order + k, n - 1))
    return order, gid, prev_code, next_code


def _kmer_ranks_jax(codes: np.ndarray, k: int):
    true_n = int(codes.shape[0])
    pad_to = pad_rows(true_n)
    if pad_to != true_n:
        codes = np.concatenate(
            [codes, np.zeros(pad_to - true_n, dtype=codes.dtype)])  # '#' pad
    n = int(codes.shape[0])
    key1, key2, _ = _packed_keys(jnp.asarray(codes), k)
    rank, order, max_rank = _rank_sort_u32((key1, key2), n)
    if k <= 32:
        rank_h, order_h = np.asarray(rank), np.asarray(order)
    else:
        length = 32
        pad = k + 1
        sentinel = jnp.asarray(-(np.arange(pad, dtype=np.int32) + 2))
        r_ext = jnp.concatenate([rank, sentinel])
        while length < k:
            off = min(length, k - length)
            r_ext, order, max_rank = _rank_round(r_ext, n, jnp.int32(off))
            length += off
            if length >= k:
                break
            if int(max_rank) == n - 1:
                break
        rank_h, order_h = np.asarray(r_ext[:n]), np.asarray(order)
    if pad_to != true_n:
        rank_h = rank_h[:true_n]
        order_h = order_h[order_h < true_n]
    return rank_h, order_h


