"""Mesh-sharded bulge-candidate detection (the simplification sweep's
device prefilter across chips).

The single-device kernel (index/enum_device.py::_candidate_scan) sorts
all (owner_vertex, member_vertex, owner_end_char) walk tuples globally
and flags vertices whose identical (owner, member) pairs carry two
distinct end chars.  A vertex's instances are scattered over the whole
position-sorted table, so a row-sharded version cannot see cross-shard
same-pair combinations locally; instead of a distributed tuple sort,
the mesh formulation factors the rule per VERTEX and combines with
psum/pmax-reduced tables:

    cand[v] = pair_exists[v]  AND  (>= 2 end-char bits set for v)

where pair_exists[v] = some instance of v (with a proper end char)
reaches another instance within min_branch (any shard), and the
end-char bits OR-accumulate over v's pair-owning instances on every
shard (5 per-code bit planes, pmax across the mesh == OR).  This is a
SUPERSET of the single-device rule (a same-pair two-char hit implies
both factors), which is exactly what the sparse sweep driver requires
for byte-exactness — any superset of "AnyBulges reports a group"
leaves the sweep's output unchanged (native/engine.cpp sparse-driver
invariant; the single-device kernel is already conservative the same
way at its band-overflow edge).

Sharding: instance rows are range-partitioned across the mesh axis;
each shard receives the next shard's first _CAND_BAND rows as a halo
(one cyclic ppermute, masked on the last shard), computes its banded
join locally, scatters contributions into (B+1)-sized vertex tables,
and the reductions produce identical replicated results on every
device — topology-invariant (tests/test_sharded_sweep.py).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..index.enum_device import _CAND_BAND
from ..index.ranking import SEP_CODE

_COMPILED: dict = {}
_MESHES: dict = {}


def _build(k: int, min_branch: int, B: int, n: int, mesh_key: int):
    mesh = _MESHES[mesh_key]
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)

    def body(codes, next_sep, n_sel, pos_l, ids_l, rows_l):
        L = pos_l.shape[0]
        me = jax.lax.axis_index(axis)
        row_ok = rows_l < n_sel[0]
        p = jnp.where(row_ok, pos_l, jnp.int32(n))
        ns = jnp.where(row_ok, jnp.take(next_sep, jnp.minimum(p, n - 1)),
                       0)
        ec = jnp.where(
            row_ok & (p + k < ns),
            jnp.take(codes, jnp.minimum(p + k, n - 1)).astype(jnp.int32),
            jnp.int32(-1))
        v = jnp.where(row_ok, ids_l, jnp.int32(B))
        # halo: the next shard's first _CAND_BAND rows (cyclic ppermute;
        # the last shard's wrapped halo is masked invalid)
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        h_p = jax.lax.ppermute(p[:_CAND_BAND], axis, perm)
        h_ok = jax.lax.ppermute(row_ok[:_CAND_BAND], axis, perm)
        last = me == n_dev - 1
        h_p = jnp.where(last, jnp.int32(n), h_p)
        h_ok = jnp.where(last, False, h_ok)
        p_ext = jnp.concatenate([p, h_p])
        ok_ext = jnp.concatenate([row_ok, h_ok])

        pair_seen = jnp.zeros((L,), jnp.bool_)
        overflow = jnp.zeros((L,), jnp.bool_)
        for o in range(1, _CAND_BAND + 1):
            mp = jax.lax.dynamic_slice(p_ext, (o,), (L,))
            m_ok = jax.lax.dynamic_slice(ok_ext, (o,), (L,))
            gap = mp - p
            ok = (row_ok & m_ok & (ec >= 0) & (gap >= 1)
                  & (gap < min_branch) & (mp < ns))
            pair_seen = pair_seen | ok
            if o == _CAND_BAND:
                # ascending positions: an in-window member at the band
                # edge is the only way unseen pairs exist beyond it
                overflow = ok
        slot = jnp.where(pair_seen, v, jnp.int32(B))
        pair_t = jnp.zeros((B + 1,), jnp.int32).at[slot].max(
            pair_seen.astype(jnp.int32))
        # 5 end-char bit planes; pmax across the mesh == OR
        planes = []
        for code in range(5):
            has = pair_seen & (ec == code)
            planes.append(jnp.zeros((B + 1,), jnp.int32).at[
                jnp.where(has, v, jnp.int32(B))].max(
                has.astype(jnp.int32)))
        plane_t = jnp.stack(planes)
        ov_t = jnp.zeros((B + 1,), jnp.int32).at[
            jnp.where(overflow, v, jnp.int32(B))].max(
            overflow.astype(jnp.int32))
        pair_t = jax.lax.pmax(pair_t, axis)
        plane_t = jax.lax.pmax(plane_t, axis)
        ov_t = jax.lax.pmax(ov_t, axis)
        nbits = jnp.sum(plane_t, axis=0)
        cand = ((pair_t != 0) & (nbits >= 2)) | (ov_t != 0)
        return cand[:B]

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(P(), P(), P(), P(axis), P(axis), P(axis)),
                      out_specs=P())
    return jax.jit(f)


def sharded_candidate_scan(codes, pos, ids, k: int, min_branch: int,
                           n_sel, mesh: Mesh):
    """bool[B] candidate-per-vertex bitmap over the mesh; a SUPERSET of
    the single-device _candidate_scan (see module docstring), identical
    for every mesh size.  B must divide evenly by the mesh size (pad
    rows carry pos >= n_sel)."""
    B = int(pos.shape[0])
    n = int(codes.shape[0])
    n_dev = int(mesh.devices.size)
    if B % n_dev != 0:
        raise ValueError("instance rows must pad to a multiple of the "
                         "mesh size")
    key = (int(k), int(min_branch), B, n, id(mesh))
    _MESHES[id(mesh)] = mesh
    if key not in _COMPILED:
        _COMPILED[key] = _build(int(k), int(min_branch), B, n, id(mesh))
    rows = jnp.arange(B, dtype=jnp.int32)
    n_sel_arr = jnp.asarray([n_sel], dtype=jnp.int32)
    return _COMPILED[key](jnp.asarray(codes), jnp.asarray(next_sep_of(codes)),
                          n_sel_arr, jnp.asarray(pos), jnp.asarray(ids),
                          rows)


def next_sep_of(codes):
    n = codes.shape[0]
    idxp = jnp.arange(n, dtype=jnp.int32)
    sep_idx = jnp.where(jnp.asarray(codes) == SEP_CODE, idxp, jnp.int32(n))
    return jnp.flip(jax.lax.cummin(jnp.flip(sep_idx)))
