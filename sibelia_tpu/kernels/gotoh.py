"""Batched affine-gap global alignment (Gotoh) on device.

The device path for the alignment engine's gap subproblems (the role
LAGAN's `order` DP plays in the reference, src/lagan/order.c, and the
compute core of C-Sibelia's block alignment). Independent subproblems
batch along the leading axis; the DP is row-wise with the in-row gap
recurrence rewritten as an exclusive running maximum:

    Iy[i,j] = GE*j + GO + max_{j'<j} (M[i,j'] - GE*j')

so every row is pure vector work and rows are a lax.fori_loop.
Outputs are per-cell direction bits; the (cheap, O(n+m)) traceback runs
on host and reproduces the host Gotoh's alignments exactly
(tests/test_gotoh_kernel.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..variants.aligner import GAP_EXTEND, GAP_OPEN, _SM

NEG = -(1 << 28)


def _sub_matrix() -> np.ndarray:
    return _SM.astype(np.int32)


@functools.partial(jax.jit, static_argnums=(2,))
def batched_gotoh_dirs(a_codes: jax.Array, b_codes: jax.Array, T: int):
    """a_codes, b_codes: [B, T] uint8 (byte values, zero-padded).
    Returns (m_choice [B,T,T] int8, ix_open [B,T,T] bool, iy_open [B,T,T]
    bool, finals [B,3] int32): direction bits for cells (i-1, j-1) of the
    (T+1)^2 DP, and the final M/Ix/Iy scores at the full-matrix corner.
    Padding is harmless: the host traceback starts at the true (n, m)."""
    sub = jnp.asarray(_sub_matrix())

    def one(a, b):
        # row 0 borders
        j = jnp.arange(T + 1, dtype=jnp.int32)
        M0 = jnp.where(j == 0, 0, NEG).astype(jnp.int32)
        Ix0 = jnp.full((T + 1,), NEG, jnp.int32)
        Iy0 = jnp.where(j == 0, NEG, GAP_OPEN + GAP_EXTEND * j).astype(jnp.int32)

        sub_rows = sub[a.astype(jnp.int32)][:, b.astype(jnp.int32)]  # [T, T]

        def row(i, carry):
            Mp, Ixp, Iyp = carry["M"], carry["Ix"], carry["Iy"]
            srow = sub_rows[i - 1]  # scores vs b[j-1], shape [T]
            best_prev = jnp.maximum(jnp.maximum(Mp, Ixp), Iyp)
            # M[i, j] for j>=1 uses diag (i-1, j-1)
            M = jnp.concatenate([
                jnp.full((1,), NEG, jnp.int32),
                best_prev[:-1] + srow])
            m_choice = jnp.where(
                Mp[:-1] >= jnp.maximum(Ixp[:-1], Iyp[:-1]), 0,
                jnp.where(Ixp[:-1] >= Iyp[:-1], 1, 2)).astype(jnp.int8)
            Ix_open_score = Mp + GAP_OPEN + GAP_EXTEND
            Ix_ext_score = Ixp + GAP_EXTEND
            Ix = jnp.maximum(Ix_open_score, Ix_ext_score)
            ix_open = Ix_open_score >= Ix_ext_score  # [T+1], cells j=0..T
            # Iy via exclusive cummax of (M[i, j'] - GE*j')
            ge_j = GAP_EXTEND * jnp.arange(T + 1, dtype=jnp.int32)
            f = M - ge_j
            cm = jax.lax.cummax(f)
            excl = jnp.concatenate([jnp.full((1,), NEG, jnp.int32), cm[:-1]])
            Iy = ge_j + GAP_OPEN + excl
            Iy = jnp.where(jnp.arange(T + 1) == 0, NEG, Iy).astype(jnp.int32)
            # open-tie preference: M[i, j-1] + GO + GE >= Iy[i, j-1] + GE
            iy_open = jnp.concatenate([
                jnp.zeros((1,), jnp.bool_),
                (M[:-1] + GAP_OPEN + GAP_EXTEND) >= (Iy[:-1] + GAP_EXTEND)])
            cell_state = jnp.where(
                M >= jnp.maximum(Ix, Iy), 0,
                jnp.where(Ix >= Iy, 1, 2)).astype(jnp.int8)
            carry["M"], carry["Ix"], carry["Iy"] = M, Ix, Iy
            carry["m_choice"] = carry["m_choice"].at[i - 1].set(m_choice)
            carry["ix_open"] = carry["ix_open"].at[i - 1].set(ix_open[1:])
            carry["iy_open"] = carry["iy_open"].at[i - 1].set(iy_open[1:])
            carry["cell_state"] = carry["cell_state"].at[i - 1].set(cell_state[1:])
            return carry

        carry = {
            "M": M0, "Ix": Ix0, "Iy": Iy0,
            "m_choice": jnp.zeros((T, T), jnp.int8),
            "ix_open": jnp.zeros((T, T), jnp.bool_),
            "iy_open": jnp.zeros((T, T), jnp.bool_),
            "cell_state": jnp.zeros((T, T), jnp.int8),
        }
        carry = jax.lax.fori_loop(1, T + 1, row, carry)
        return (carry["m_choice"], carry["ix_open"], carry["iy_open"],
                carry["cell_state"])

    return jax.vmap(one)(a_codes, b_codes)


def traceback_from_dirs(a: bytes, b: bytes, m_choice, ix_open, iy_open,
                        cell_state) -> tuple[str, str]:
    """Replay the host Gotoh traceback from direction bits; the start
    state is the stored argmax at the true corner (n, m)."""
    n, m = len(a), len(b)
    out_a: list[str] = []
    out_b: list[str] = []
    i, j = n, m
    if n == 0 or m == 0:
        return ("-" * m if n == 0 else a.decode(),
                b.decode() if n == 0 else "-" * m)
    state = int(cell_state[n - 1][m - 1])
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            out_a.append(chr(a[i - 1]))
            out_b.append(chr(b[j - 1]))
            nxt = int(m_choice[i - 1][j - 1])
            i -= 1
            j -= 1
            state = nxt
        elif state == 1 and i > 0:
            out_a.append(chr(a[i - 1]))
            out_b.append("-")
            if bool(ix_open[i - 1][j - 1]) if j > 0 else True:
                state = 0
            i -= 1
        elif state == 2 and j > 0:
            out_a.append("-")
            out_b.append(chr(b[j - 1]))
            if bool(iy_open[i - 1][j - 1]) if i > 0 else True:
                state = 0
            j -= 1
        else:
            if i > 0:
                out_a.append(chr(a[i - 1]))
                out_b.append("-")
                i -= 1
            else:
                out_a.append("-")
                out_b.append(chr(b[j - 1]))
                j -= 1
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def batch_align(pairs: list[tuple[bytes, bytes]], T: int = 128):
    """Align a batch of same-budget subproblems on device; each (a, b)
    must satisfy len(a) <= T and len(b) <= T. Returns aligned row pairs
    identical to the host Gotoh's output."""
    B = len(pairs)
    if B == 0:
        return []
    a_arr = np.zeros((B, T), dtype=np.uint8)
    b_arr = np.zeros((B, T), dtype=np.uint8)
    for x, (a, b) in enumerate(pairs):
        a_arr[x, :len(a)] = np.frombuffer(a, dtype=np.uint8)
        b_arr[x, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    m_choice, ix_open, iy_open, cell_state = batched_gotoh_dirs(
        jnp.asarray(a_arr), jnp.asarray(b_arr), T)
    m_choice = np.asarray(m_choice)
    ix_open = np.asarray(ix_open)
    iy_open = np.asarray(iy_open)
    cell_state = np.asarray(cell_state)
    out = []
    for x, (a, b) in enumerate(pairs):
        out.append(traceback_from_dirs(a, b, m_choice[x], ix_open[x],
                                       iy_open[x], cell_state[x]))
    return out
