"""Device (JAX) backend for the LAGAN `anchors` stage.

The reference's chain selector (src/lagan/src/anchors.c) is a sweep over
hit start/end events with a Pareto-pruned skiplist; with the pipeline's
gap parameters (gapopen = gapcont = 0 — rechaos.pl passes none) the
recurrence degenerates to a weighted longest-increasing-subsequence:

    sofar(H) = score(H) + max(0, max{ sofar(P) :
                   P's end event precedes H's start event,
                   P.a_e < H.a_s, sofar(P) > 0 })

which is exactly representable as one `lax.scan` over the event list
with masked segmented maxima — no list structure needed, because the
skiplist's insert-refusal and pruning only ever drop entries dominated
at insertion time, and sofar values are frozen before their end event
(starts sort before ends at equal coordinates), so domination is
permanent and the running maximum is unchanged.

Tie-breaks replicate the list semantics exactly:
  * query pick = max (sofar, a_e, end-event recency) lexicographically
    (find_lt returns the LAST list entry below the key; equal-sofar
    larger-a_e entries coexist, equal-(sofar, a_e) keeps the later);
  * final chain start = max sofar, then SMALLEST a_e (the list is
    walked ascending with a strict '>'), then latest end event.

Parsing (rolltonum + the two sscanf's + -gfc chunk attachment,
anchors.c:193-266) is ported host-side below; output formatting matches
doOutput (anchors.c:167-191) byte-for-byte.  Inputs with b_e < b_s
would break the frozen-sofar argument (the reference would insert a
hit before computing its score); the pipeline's chaos stage never
emits them, and this backend refuses such input (caller falls back to
the native stage).

Differential-tested byte-for-byte against native/lagan_anchors.cpp on
random and real chaos outputs (tests/test_anchors_device.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_WS = " \t\n\v\f\r"

# device coverage: device_jobs = sweeps run on the device, host_fallback
# = inputs refused by the b_e < b_s precondition (the caller then runs
# the native stage).  Read via get_stats().
STATS = {"device_jobs": 0, "host_fallback": 0}


def get_stats() -> dict:
    return dict(STATS)


def _rolltonum(s: str) -> int:
    """anchors.c:193-226: offset of the first of the last two
    whitespace-preceded digit runs before a ';', else len(s)."""
    got1 = got2 = -1
    in_num = False
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == ";" and got1 >= 0 and got2 >= 0:
            return got1
        if c.isdigit():
            if not in_num and (i == 0 or s[i - 1] in _WS):
                if got1 >= 0:
                    got2 = i
                else:
                    got1 = i
                in_num = True
        elif in_num and c in _WS:
            if got2 >= 0:
                got1, got2 = got2, -1
            in_num = False
        else:
            in_num = False
            got1 = got2 = -1
        i += 1
    return n


class _Scan:
    """Minimal sscanf-style scanner (only what the two formats need)."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in _WS:
            self.i += 1

    def int_(self):
        self.ws()
        j = self.i
        if j < len(self.s) and self.s[j] in "+-":
            j += 1
        k = j
        while k < len(self.s) and self.s[k].isdigit():
            k += 1
        if k == j:
            return None
        v = int(self.s[self.i:k])
        self.i = k
        return v

    def lit(self, ch: str) -> bool:
        if self.i < len(self.s) and self.s[self.i] == ch:
            self.i += 1
            return True
        return False

    def lits(self, word: str) -> bool:
        for ch in word:
            if not self.lit(ch):
                return False
        return True

    def float_(self):
        self.ws()
        j = self.i
        n = len(self.s)
        k = j
        if k < n and self.s[k] in "+-":
            k += 1
        d0 = k
        while k < n and self.s[k].isdigit():
            k += 1
        if k < n and self.s[k] == ".":
            k += 1
            while k < n and self.s[k].isdigit():
                k += 1
        if k == d0 or (k == d0 + 1 and self.s[d0] == "."):
            if not (k > d0 and any(c.isdigit() for c in self.s[d0:k])):
                return None
        if k < n and self.s[k] in "eE":
            m = k + 1
            if m < n and self.s[m] in "+-":
                m += 1
            e0 = m
            while m < n and self.s[m].isdigit():
                m += 1
            if m > e0:
                k = m
        if k == j:
            return None
        try:
            v = float(self.s[j:k])
        except ValueError:
            return None
        self.i = k
        return v


def _parse_hit(line: str):
    off = _rolltonum(line)
    sc = _Scan(line[off:])
    a_s = sc.int_()
    a_e = sc.int_()
    if a_s is None or a_e is None:
        return None
    sc.ws()
    if not sc.lit(";"):
        return None
    h = sc.i
    off2 = _rolltonum(line[off + h:])
    sc2 = _Scan(line[off + h + off2:])
    b_s = sc2.int_()
    b_e = sc2.int_()
    if b_s is None or b_e is None:
        return None
    sc2.ws()
    if not sc2.lit(";"):
        return None
    sc2.ws()
    if not sc2.lits("score"):
        return None
    sc2.ws()
    if not sc2.lit("="):
        return None
    score = sc2.float_()
    if score is None:
        return None
    return a_s, a_e, b_s, b_e, np.float32(score)


def _parse_chunk(line: str):
    sc = _Scan(line)
    vals = [sc.int_() for _ in range(4)]
    if any(v is None for v in vals):
        return None
    sc.ws()
    if sc.i != len(line):
        return None
    return tuple(vals)


def _sweep_device(a_s, a_e, score, ev_hit, ev_isstart):
    """The event sweep as one jitted lax.scan (see _sweep).  Hits are
    padded to a power of two so inputs of similar size share a compiled
    program: padded hits get one start event each after the real events
    and never an end event, so they only write their own (never alive)
    rows.  Returns (sofar, bk, best, best_value) for the real hits."""
    n = a_s.shape[0]
    n_pad = 1 << max(4, (n - 1).bit_length())
    extra = n_pad - n

    def pad(x, fill=0):
        return np.concatenate([x, np.full(extra, fill, x.dtype)])

    ev_hit = np.concatenate([ev_hit, np.arange(n, n_pad, dtype=np.int32)])
    ev_isstart = np.concatenate([ev_isstart, np.ones(extra, np.int32)])
    sofar, bk, best, m1 = _sweep(pad(a_s), pad(a_e), pad(score),
                                 pad(ev_hit, n), pad(ev_isstart, 1))
    return (np.asarray(sofar)[:n], np.asarray(bk)[:n], int(best), float(m1))


@jax.jit
def _sweep(a_s, a_e, score, ev_hit, ev_isstart):
    """The skiplist sweep over the event list.

    The skiplist is modeled by an `alive` vector.  Its invariant (sofar
    non-decreasing along ascending a_e) makes both operations masked
    maxima:
      * find_lt(key)  == the alive entry with the largest a_e < key
        (ties on a_e -> the larger sofar; equal (a_e, sofar) pairs
        cannot both be alive);
      * inserting E refuses when that entry's sofar strictly exceeds
        E's (anchors.c wh_rulez), else erases every alive entry at
        a_e >= E.a_e with sofar <= E.sofar (the prune-next loop);
      * the final pick walks ascending with a strict '>', i.e. the
        smallest a_e among alive max-sofar entries.
    """
    n = a_s.shape[0]
    NEG = jnp.float32(-3.4e38)
    IMIN = jnp.int32(-2**31 + 1)
    idx = jnp.arange(n, dtype=jnp.int32)

    def find_lt(alive, sofar, key):
        mask = alive & (a_e < key)
        any_m = jnp.any(mask)
        m_a = jnp.max(jnp.where(mask, a_e, IMIN))
        mask_a = mask & (a_e == m_a)
        hs = jnp.max(jnp.where(mask_a, sofar, NEG))
        p = jnp.argmax(mask_a & (sofar == hs))
        return any_m, hs, p

    def step(carry, ev):
        sofar, bk, alive = carry
        h, isstart = ev

        def do_start(_):
            any_m, hs, p = find_lt(alive, sofar, a_s[h])
            chain = any_m & (hs > 0)
            new_sofar = sofar.at[h].set(
                score[h] + jnp.where(chain, hs, jnp.float32(0)))
            new_bk = bk.at[h].set(jnp.where(chain, p, jnp.int32(-1)))
            return new_sofar, new_bk, alive

        def do_end(_):
            any_m, hs, _ = find_lt(alive, sofar, a_e[h])
            refuse = any_m & (hs > sofar[h])
            kill = (alive & (a_e >= a_e[h]) & (sofar <= sofar[h])
                    & (idx != h) & ~refuse)
            new_alive = jnp.where(kill, False, alive).at[h].set(~refuse)
            return sofar, bk, new_alive

        return jax.lax.cond(isstart == 1, do_start, do_end, None), None

    init = (jnp.zeros((n,), jnp.float32),
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), jnp.bool_))
    (sofar, bk, alive), _ = jax.lax.scan(step, init, (ev_hit, ev_isstart))
    # final pick: max sofar among ALIVE entries, smallest a_e on ties
    m1 = jnp.max(jnp.where(alive, sofar, NEG))
    mask2 = alive & (sofar == m1)
    m2 = jnp.min(jnp.where(mask2, a_e, jnp.int32(2**31 - 1)))
    best = jnp.argmax(mask2 & (a_e == m2))
    return sofar, bk, best, m1


def anchors_text_device(hits_text: str, gfc: bool = True) -> str | None:
    """Device-backed twin of native lagan_anchors (anchors.c semantics);
    None when the input violates the frozen-sofar precondition (caller
    falls back to the native stage)."""
    hits = []       # (a_s, a_e, b_s, b_e, score) in file order
    chunks = []     # per hit, reversed file order
    pending = -1
    for line in hits_text.split("\n"):
        if gfc and pending >= 0:
            c = _parse_chunk(line)
            if c is not None:
                chunks[pending].insert(0, c)
                continue
        t = _parse_hit(line)
        if t is not None:
            hits.append(t)
            chunks.append([])
            pending = len(hits) - 1 if gfc else -1
    if not hits:
        return ""
    n = len(hits)
    # list order = reverse file order (parseCHAOS prepends)
    order = list(range(n - 1, -1, -1))
    a_s = np.asarray([hits[i][0] for i in order], dtype=np.int32)
    a_e = np.asarray([hits[i][1] for i in order], dtype=np.int32)
    b_s = np.asarray([hits[i][2] for i in order], dtype=np.int32)
    b_e = np.asarray([hits[i][3] for i in order], dtype=np.int32)
    score = np.asarray([hits[i][4] for i in order], dtype=np.float32)
    if np.any(b_e < b_s):
        STATS["host_fallback"] += 1
        return None  # precondition (see module docstring)
    STATS["device_jobs"] += 1

    # event array in list order (start, end interleaved per hit),
    # stable-sorted by (number, starts-first), then runs of equal end
    # events reversed (glibc msort under the reference's inconsistent
    # comparator, anchors.c:45-58)
    ev_num = np.empty(2 * n, dtype=np.int64)
    ev_st = np.empty(2 * n, dtype=np.int32)
    ev_h = np.empty(2 * n, dtype=np.int32)
    ev_num[0::2] = b_s
    ev_num[1::2] = b_e
    ev_st[0::2] = 1
    ev_st[1::2] = 0
    ev_h[0::2] = np.arange(n)
    ev_h[1::2] = np.arange(n)
    key = ev_num * 2 + (1 - ev_st)  # starts first at equal number
    perm = np.argsort(key, kind="stable")
    ev_num, ev_st, ev_h = ev_num[perm], ev_st[perm], ev_h[perm]
    # reverse runs of equal (number, end)
    i = 0
    while i < 2 * n:
        j = i + 1
        while (j < 2 * n and ev_num[j] == ev_num[i]
               and ev_st[j] == ev_st[i]):
            j += 1
        if ev_st[i] == 0 and j - i > 1:
            ev_h[i:j] = ev_h[i:j][::-1]
        i = j

    sofar, bk, best, best_val = _sweep_device(a_s, a_e, score, ev_h, ev_st)

    # doOutput (anchors.c:167-191): walk the chain, expanding chunks.
    # The reference's final pick starts from best = -1 with a strict
    # '>', so a run whose every chain scores <= -1 emits nothing.
    out = []
    t = best if best_val > -1 else -1
    while t >= 0:
        fi = order[t]  # file-order index for chunk lookup
        ch = chunks[fi]
        if not gfc or not ch:
            out.append("(%d %d)=(%d %d) %f\n"
                       % (a_s[t], a_e[t], b_s[t], b_e[t], float(score[t])))
        else:
            for (y, x, length, sc) in ch:
                out.append("(%d %d)=(%d %d) %d\n"
                           % (y, y + length - 1, x, x + length - 1, sc))
        t = int(bk[t])
    return "".join(out)
