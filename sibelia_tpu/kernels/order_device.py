"""Device band DP for the LAGAN ``order`` stage.

The anchored global aligner is a 3-state (M/N/O) integer DP over an
irregular anti-diagonal band (squares between anchors, width-15 barrels
along them — reference: src/lagan/src/order.c:271-382,609-705 with the
limited-memory diagonal matrix of diagmatrix.c).  Every cell of one
anti-diagonal depends only on the two previous diagonals, so the DP is a
wavefront: here it runs as a ``lax.scan`` over diagonals with the band
rows padded to the maximum width, carrying the two previous diagonals
and emitting the 4-bit pointer rows the traceback consumes.

Split of labor (native/lagan_order.cpp exposes both halves): band
construction (shapes, necks) and the pointer-walk traceback stay in the
native engine — exact reuse of the host path — while the O(band area)
recurrence, which is all the FLOPs, runs on the accelerator.  Byte
parity with the host engine (and hence with the reference ``order``
binary) is asserted by tests/test_order_device.py.

Semantics replicated exactly:
  * substitution scores and the ``.`` contig-break char exemptions
    (lagan_common.h: nucmatrix values; order.c gap -400/-25);
  * the host DP's tie preferences and pointer nibble layout
    (order.c:609-705);
  * neck renormalization including its use of the already-updated M in
    the N/O clamps when the normalizer is non-positive
    (diagmatrix.c:268-293).  The serial code also renormalizes diagonal
    i-2, whose ring slot is overwritten before any read — dead work the
    kernel skips.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

GAP_START = -400  # order.c kGapstart
GAP_CONT = -25    # order.c kGapcont
DUMMY = np.int32(-(2 << 30) + (1 << 28))  # INT_MIN + (1 << 28)
_ROWS_BUDGET_BYTES = 256 << 20  # pointer-row buffer cap per pair

# char codes: 0 other/NUL, 1..4 ACGT, 5 '.', 6 N, 7 '-'
_CODE = np.zeros(256, np.int32)
for _ch, _cd in ((65, 1), (67, 2), (71, 3), (84, 4), (46, 5), (78, 6),
                 (45, 7)):
    _CODE[_ch] = _cd
_CB_CODE = 5  # iscb(c) <=> c == '.'

_SM = np.zeros((8, 8), np.int32)
_SYM = [1, 2, 3, 4, 5, 6]  # A C G T . N
_VAL = [
    [91, -114, -31, -123, 0, -43],
    [-114, 100, -125, -31, 0, -43],
    [-31, -125, 100, -114, 0, -43],
    [-123, -31, -114, 91, 0, -43],
    [0, 0, 0, 0, 0, 0],
    [-43, -43, -43, -43, 0, -43],
]
for _i, _a in enumerate(_SYM):
    for _j, _b in enumerate(_SYM):
        _SM[_a, _b] = _VAL[_i][_j]


# device-coverage accounting (a host fallback must be visible):
# device_jobs = band DPs dispatched to the accelerator,
# host_fallback = pairs the traceback-budget/band gate sent to the host
# engine.  Read via get_stats(); the variant caller logs it under
# SIBELIA_TPU_TRACE=1.
STATS = {"device_jobs": 0, "host_fallback": 0}


def get_stats() -> dict:
    return dict(STATS)


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def _make_run(wmax: int):
    import jax
    import jax.numpy as jnp

    sm_flat = jnp.asarray(_SM.reshape(-1))
    dummy = jnp.int32(DUMMY)

    def run(s1c, s2c, params, init_m, init_n, init_o):
        n1 = s1c.shape[0]
        n2 = s2c.shape[0]
        j = jnp.arange(wmax, dtype=jnp.int32)

        def neighbor(arr, off, sp):
            idx = j + off
            ok = (idx >= 0) & (idx < sp)
            return jnp.where(ok, jnp.take(arr, jnp.clip(idx, 0, wmax - 1)),
                             dummy)

        def body(carry, row):
            p1m, p1n, p1o, p2m, p2n, p2o = carry
            (size, o_dd, o_up, o_lf, x0, y0, isneck, sp1, sp2) = (
                row[0], row[1], row[2], row[3], row[4], row[5], row[6],
                row[7], row[8])
            inband = j < size
            dm = neighbor(p2m, o_dd, sp2)
            dn_ = neighbor(p2n, o_dd, sp2)
            do_ = neighbor(p2o, o_dd, sp2)
            un = neighbor(p1n, o_up, sp1)
            lo = neighbor(p1o, o_lf, sp1)
            c1 = jnp.take(s1c, jnp.clip(x0 - 1 + j, 0, n1 - 1))
            c2 = jnp.take(s2c, jnp.clip(y0 - 1 - j, 0, n2 - 1))
            cb1 = c1 == _CB_CODE
            cb2 = c2 == _CB_CODE
            g_cont1 = jnp.where(cb1, 0, GAP_CONT)
            g_cont2 = jnp.where(cb2, 0, GAP_CONT)
            s1v = dm
            s2v = dn_ + g_cont2
            s3v = do_ + g_cont1
            best = jnp.where(s1v >= s2v,
                             jnp.where(s1v >= s3v, s1v, s3v),
                             jnp.where(s2v >= s3v, s2v, s3v))
            cm = jnp.take(sm_flat, c1 * 8 + c2) + best
            t1 = cm + jnp.where(cb2, 0, GAP_START)
            t2 = un + g_cont2
            takes_n = t1 >= t2
            cn = jnp.where(takes_n, t1, t2)
            ptr = jnp.where(takes_n, 0, 4).astype(jnp.int32)
            u1 = cm + jnp.where(cb1, 0, GAP_START)
            u2 = lo + g_cont1
            takes_o = u1 >= u2
            co = jnp.where(takes_o, u1, u2)
            ptr = ptr | jnp.where(takes_o, 0, 8)
            ptr = ptr | jnp.where(
                cm >= cn,
                jnp.where(cm < co, 2, 0),
                jnp.where(cn >= co, 1, 2))
            cm = jnp.where(inband, cm, dummy)
            cn = jnp.where(inband, cn, dummy)
            co = jnp.where(inband, co, dummy)

            def renorm(args):
                m, n_, o, pm, pn, po = args
                norm = jnp.max(jnp.where(inband, m, dummy))

                def apply(M, N, O, mask):
                    t = M - norm
                    M2 = jnp.where(norm > 0, jnp.minimum(M, t),
                                   jnp.maximum(M, t))
                    tn = N - norm
                    N2 = jnp.where(norm > 0, jnp.minimum(N, tn),
                                   jnp.maximum(M2, tn))
                    to = O - norm
                    O2 = jnp.where(norm > 0, jnp.minimum(O, to),
                                   jnp.maximum(M2, to))
                    return (jnp.where(mask, M2, M), jnp.where(mask, N2, N),
                            jnp.where(mask, O2, O))

                m, n_, o = apply(m, n_, o, inband)
                pmask = j < sp1
                pm, pn, po = apply(pm, pn, po, pmask)
                return m, n_, o, pm, pn, po

            cm, cn, co, p1m, p1n, p1o = jax.lax.cond(
                isneck == 1, renorm, lambda a: a,
                (cm, cn, co, p1m, p1n, p1o))
            new_carry = (cm, cn, co, p1m, p1n, p1o)
            return new_carry, ptr.astype(jnp.uint8)

        carry0 = (init_m, init_n, init_o,
                  jnp.full((wmax,), dummy), jnp.full((wmax,), dummy),
                  jnp.full((wmax,), dummy))
        _, rows = jax.lax.scan(body, carry0, params)
        return rows

    return run


@functools.lru_cache(maxsize=16)
def _scan_fn(wmax: int, nd_pad: int):
    import jax
    return jax.jit(_make_run(wmax))


@functools.lru_cache(maxsize=16)
def _scan_fn_batched(wmax: int, nd_pad: int):
    """Batched variant: vmap over pairs sharing padded shapes.  The band
    is narrow (width-15 barrels), so a lone wavefront underfills the
    vector unit; batching pairs multiplies the per-step work by the
    batch size at the same step count — the alignment batch engine of
    SURVEY §2e."""
    import jax
    return jax.jit(jax.vmap(_make_run(wmax)))


class _Job:
    __slots__ = ("handle", "nd", "wmax", "nd_pad", "params", "init",
                 "s1c", "s2c")


def _prepare_job(lib, seq1: bytes, seq2: bytes, anchors_text: str,
                 max_band_width: int) -> _Job | None:
    h = lib.le_order_prepare(seq1, len(seq1), seq2, len(seq2),
                             anchors_text.encode("latin-1"))
    dims = (ctypes.c_longlong * 4)()
    lib.le_order_dims(h, dims)
    d1, d2, nd, maxw = (int(dims[0]), int(dims[1]), int(dims[2]),
                        int(dims[3]))
    # gate on the pointer-row buffer (nd_pad x wmax uint8), not just the
    # band width: wide inter-anchor squares stay on device as long as
    # the traceback buffer fits the budget
    wmax_p = 1 << max(4, int(maxw - 1).bit_length())
    ndp = _bucket(nd - 1, 4096) if nd > 1 else 0
    if (maxw > max_band_width or nd < 2
            or wmax_p * ndp > _ROWS_BUDGET_BYTES):
        lib.le_order_release(h)
        STATS["host_fallback"] += 1
        return None
    STATS["device_jobs"] += 1
    starts = np.empty(nd, np.int32)
    ends = np.empty(nd, np.int32)
    isneck = np.empty(nd, np.int32)
    lib.le_order_band(h, starts.ctypes.data, ends.ctypes.data,
                      isneck.ctypes.data)
    n1, n2 = d1 - 1, d2 - 1
    s1buf = np.empty(n1 + 17, np.uint8)
    s2buf = np.empty(n2 + 17, np.uint8)
    lib.le_order_seq(h, 1, s1buf.ctypes.data)
    lib.le_order_seq(h, 2, s2buf.ctypes.data)

    size = ends - starts + 1
    diag = np.arange(1, nd + 1)
    below = diag < d2
    x0 = np.where(below, starts + 1, diag - d2 + starts + 1)
    y0 = np.where(below, diag - starts, d2 - starts)

    # constant per-diagonal offsets of the three neighbors' lane indices
    # (elem spaces differ below/at-or-above the d2 corner)
    def starts_at(dg):
        return np.where((dg >= 1) & (dg <= nd),
                        starts[np.clip(dg, 1, nd) - 1], 0)

    def size_at(dg):
        return np.where((dg >= 1) & (dg <= nd),
                        size[np.clip(dg, 1, nd) - 1], 0)

    dg2, dg1 = diag - 2, diag - 1
    e_dd = np.where(dg2 < d2, x0 - 2, d2 - y0 + 1)
    e_up = np.where(dg1 < d2, x0 - 2, d2 - y0)
    e_lf = np.where(dg1 < d2, x0 - 1, d2 - y0 + 1)

    job = _Job()
    job.handle = h
    job.nd = nd
    job.wmax = 1 << max(4, int(maxw - 1).bit_length())
    job.nd_pad = _bucket(nd - 1, 4096)  # the scan runs diagonals 2..nd
    params = np.zeros((job.nd_pad, 9), np.int32)
    cols = np.stack([size, e_dd - starts_at(dg2), e_up - starts_at(dg1),
                     e_lf - starts_at(dg1), x0, y0, isneck,
                     size_at(dg1), size_at(dg2)], axis=1)
    params[:nd - 1] = cols[1:]
    job.params = params

    # diagonal-1 init: cell 0 = (0, GAP_START, GAP_START), the rest of
    # the band zeros (the host ring is calloc'd), pad dummy
    lane = np.arange(job.wmax)
    init_m = np.where(lane < size[0], 0, DUMMY).astype(np.int32)
    init_n = init_m.copy()
    init_o = init_m.copy()
    init_n[0] = GAP_START
    init_o[0] = GAP_START
    job.init = (init_m, init_n, init_o)
    job.s1c = _CODE[s1buf]
    job.s2c = _CODE[s2buf]
    return job


def _finish(lib, job: _Job, rows: np.ndarray, name1: str,
            name2: str) -> str:
    from ..native import _take_string
    ptrs = np.zeros((job.nd, job.wmax), np.uint8)
    ptrs[1:] = rows[:job.nd - 1]
    out = lib.le_order_finish(job.handle, name1.encode("latin-1"),
                              name2.encode("latin-1"),
                              np.ascontiguousarray(ptrs).ctypes.data,
                              job.wmax)
    return _take_string(lib, out)


def order_mfa_device(seq1: bytes, name1: str, seq2: bytes, name2: str,
                     anchors_text: str,
                     max_band_width: int = 8192) -> str | None:
    """Device twin of native lagan_order: same -mfa text, or None when
    the native library is unavailable or the band is too wide for the
    padded layout (caller falls back to the host DP)."""
    from ..native import load_lagan
    lib = load_lagan()
    if lib is None or not hasattr(lib, "le_order_prepare"):
        return None
    import jax.numpy as jnp
    job = _prepare_job(lib, seq1, seq2, anchors_text, max_band_width)
    if job is None:
        return None
    try:
        run = _scan_fn(job.wmax, job.nd_pad)
        rows = run(jnp.asarray(job.s1c), jnp.asarray(job.s2c),
                   jnp.asarray(job.params), *map(jnp.asarray, job.init))
        return _finish(lib, job, np.asarray(rows), name1, name2)
    finally:
        lib.le_order_release(job.handle)


def order_mfa_device_batch(jobs: list[tuple[bytes, str, bytes, str, str]],
                           max_band_width: int = 8192,
                           mesh=None) -> list[str | None]:
    """Batched device order: jobs = [(seq1, name1, seq2, name2,
    anchors_text)].  Pairs are grouped by padded (band width, diagonal
    count, sequence length) shape and each group runs as ONE vmapped
    device dispatch; a None result marks a pair that needs the host
    fallback.

    With `mesh` (a jax.sharding.Mesh), each group's batch axis is
    sharded over the mesh's devices — block pairs are independent, so
    this is pure data parallelism over chips (SURVEY §2e "alignment
    batch engine"; the reference's analogue is the per-pair process
    pool, C-Sibelia.py:349).  Results are byte-identical to the
    unsharded dispatch for any mesh size.  When `mesh` is None and
    SIBELIA_TPU_SHARDED=N requests N>1 shards with enough devices, a
    mesh is built automatically."""
    import os as _os
    if mesh is None:
        n_shard = _os.environ.get("SIBELIA_TPU_SHARDED")
        if n_shard and n_shard.isdigit() and int(n_shard) > 1:
            import jax as _jax
            if len(_jax.devices()) >= int(n_shard):
                from ..parallel.sharded import make_mesh
                mesh = make_mesh(int(n_shard), axis="pairs")
    from ..native import load_lagan
    lib = load_lagan()
    if lib is None or not hasattr(lib, "le_order_prepare"):
        return [None] * len(jobs)
    import jax.numpy as jnp

    prepared: list[_Job | None] = []
    groups: dict[tuple[int, int, int, int], list[int]] = {}
    for i, (s1, _n1, s2, _n2, anch) in enumerate(jobs):
        job = _prepare_job(lib, s1, s2, anch, max_band_width)
        prepared.append(job)
        if job is None:
            continue
        l1 = _bucket(job.s1c.shape[0], 4096)
        l2 = _bucket(job.s2c.shape[0], 4096)
        groups.setdefault((job.wmax, job.nd_pad, l1, l2), []).append(i)

    results: list[str | None] = [None] * len(jobs)
    try:
        for (wmax, nd_pad, l1, l2), idxs in groups.items():
            def padto(a, n):
                out = np.zeros(n, a.dtype)
                out[:a.shape[0]] = a
                return out

            js = [prepared[i] for i in idxs]
            nb = len(js)
            if mesh is not None:
                # pad the batch to a multiple of the mesh size (replicas
                # of job 0; their rows are computed and dropped)
                nd = mesh.devices.size
                while len(js) % nd != 0:
                    js.append(js[0])
            s1b = np.stack([padto(j.s1c, l1) for j in js])
            s2b = np.stack([padto(j.s2c, l2) for j in js])
            pb = np.stack([j.params for j in js])
            im = np.stack([j.init[0] for j in js])
            in_ = np.stack([j.init[1] for j in js])
            io = np.stack([j.init[2] for j in js])
            run = _scan_fn_batched(wmax, nd_pad)
            args = [jnp.asarray(a) for a in (s1b, s2b, pb, im, in_, io)]
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                axis = mesh.axis_names[0]
                shardings = [
                    NamedSharding(mesh,
                                  PartitionSpec(axis,
                                                *([None] * (a.ndim - 1))))
                    for a in args]
                import jax as _jax
                args = [_jax.device_put(a, s) for a, s in zip(args,
                                                              shardings)]
            rows = np.asarray(run(*args))[:nb]
            for bi, i in enumerate(idxs):
                results[i] = _finish(lib, prepared[i], rows[bi],
                                     jobs[i][1], jobs[i][3])
    finally:
        for j in prepared:
            if j is not None:
                lib.le_order_release(j.handle)
    return results
