"""Exact LAGAN pipeline driver (lagan.pl / rechaos.pl semantics).

Drives the native chaos / anchors / order stage primitives
(sibelia_tpu/native/lagan_*.cpp) through the recursive anchoring scheme of
the reference Perl drivers (reference: src/lagan/lagan.pl:132-178 and
src/lagan/rechaos.pl), producing byte-identical -mfa output to
``lagan.pl seq1 seq2 -mfa`` for the inputs C-Sibelia generates.

Replicated driver behaviors:

* the recursion schedule ``(12,0,25,0)x,(13,1,30,0)x,(4,0,4,3000)xt,
  (8,1,30,0)x,(7,1,30,0)x`` with translated levels skipped
  (rechaos.pl:14, :160);
* sentinel boundary anchors (scores 1.1 / 1.2) appended while more levels
  remain (rechaos.pl:190-198);
* accumulated-anchor carry-over between levels minus the first/last
  (sentinel) entries (rechaos.pl:247-252);
* gap-region extraction with minbox 10 / minside 5 and the strict
  begin < end check (rechaos.pl:16-17, :304-312);
* GNU ``sort -n -k2,2`` / ``sort -nr -k2,2`` emulation: numeric value of
  the second whitespace-delimited field with a bytewise whole-line
  last-resort comparison (C collation), reversal applying to both.
"""
from __future__ import annotations

import re

from ..native import lagan_anchors, lagan_chaos, lagan_order, load_lagan


def _anchors_stage(hits_text: str, gfc: bool) -> str:
    """anchors stage dispatch: the device weighted-LIS kernel
    (align/anchors_device.py, byte-equal by differential test) when
    device_dispatch() is on or SIBELIA_TPU_ANCHORS_DEVICE=1; the native
    C++ sweep otherwise, and for inputs the device sweep refuses
    (counted in anchors_device.STATS)."""
    import os
    env = os.environ.get("SIBELIA_TPU_ANCHORS_DEVICE")
    use_dev = env == "1"
    if env is None:
        from ..core.platform import device_dispatch
        use_dev = device_dispatch()
    if use_dev:
        from .anchors_device import anchors_text_device
        out = anchors_text_device(hits_text, gfc=gfc)
        if out is not None:
            return out
    return lagan_anchors(hits_text, gfc=gfc)

# rechaos.pl:14 minus the translated level (skipped when -translate is off)
RECURSION_LEVELS = [(12, 0, 25, 0), (13, 1, 30, 0), (8, 1, 30, 0),
                    (7, 1, 30, 0)]
MINBOX = 10   # rechaos.pl:16
MINSIDE = 5   # rechaos.pl:17
SENTINEL_LEFT = 1.1   # rechaos.pl:30
SENTINEL_RIGHT = 1.2  # rechaos.pl:31

_ANCHOR_RE = re.compile(r"\((\d+) (\d+)\)=\((\d+) (\d+)\) (.*)")


def available() -> bool:
    return load_lagan() is not None


def _field2_numeric(line: str) -> int:
    """Numeric value GNU sort assigns to key -k2,2 of an anchor line."""
    fields = line.split()
    if len(fields) < 2:
        return 0
    text = fields[1]
    m = re.match(r"[+-]?\d*", text)
    tok = m.group(0) if m else ""
    if tok in ("", "+", "-"):
        return 0
    return int(tok)


def _gnu_sort_n_k2(lines: list[str], reverse: bool = False) -> list[str]:
    """GNU ``sort -n -k2,2`` (``-nr`` when reverse): numeric key with the
    whole-line bytewise last-resort; -r reverses both comparisons."""
    keyed = sorted(lines, key=lambda l: (_field2_numeric(l),
                                         l.encode("latin-1")))
    if reverse:
        keyed.reverse()
    return keyed


def rechaos(seq1: bytes, name1: str, seq2: bytes, name2: str,
            gfc: bool = True,
            levels: list[tuple[int, int, int, int]] | None = None) -> str:
    """Returns the final anchor text (rechaos.pl stdout: anchors sorted by
    seq1 end, descending).  lagan.pl passes -gfc (gap-free chunk anchors);
    mlagan calls rechaos without it (whole-hit anchors, mlagan.c:231-240).
    `levels` overrides the recursion schedule (the `-recurse
    "(wl,nd,co,rsc)x,..."` flag — e.g. cmerge2.pl's single
    (12,0,40,0) level for contig-overlap detection)."""
    recursion_levels = RECURSION_LEVELS if levels is None else levels
    seq1len = len(seq1)
    seq2len = len(seq2)
    b1, e1 = [1], [seq1len]
    b2, e2 = [1], [seq2len]
    clipleft1 = clipleft2 = 0
    clipright1 = seq1len + 1
    clipright2 = seq2len + 1
    app_str = ""
    sorted_lines: list[str] = []

    for level, (wl, nd, co, rsc) in enumerate(recursion_levels):
        stillmore = level + 1 < len(recursion_levels)
        pairs_text = "".join(
            f"-s1 {b1[j]} {e1[j]} -s2 {b2[j]} {e2[j]}\n"
            for j in range(len(b1)))
        hits = lagan_chaos(seq1, name1, seq2, name2, pairs_text,
                           wl, nd, co, rsc, gfc=gfc, ext=True)
        if stillmore:
            t1 = seq1len + 1
            t2 = seq2len + 1
            app_str += (f"seq1 0 {clipleft1}; seq2 0 {clipleft2}; "
                        f"score={SENTINEL_LEFT} (+)\n")
            app_str += (f"seq1 {clipright1} {t1}; seq2 {clipright2} {t2}; "
                        f"score={SENTINEL_RIGHT} (+)\n")
        anchtemp = hits + app_str
        anch = _anchors_stage(anchtemp, gfc)
        sorted_lines = _gnu_sort_n_k2(
            [l for l in anch.split("\n") if l != ""])
        if not stillmore:
            break

        parsed = []
        for line in sorted_lines:
            m = _ANCHOR_RE.match(line)
            parsed.append(m.groups() if m else None)
        app_str = ""
        nb1: list[int] = []
        nb2: list[int] = []
        ne1: list[int] = []
        ne2: list[int] = []
        for m_i in range(len(sorted_lines)):
            if 1 <= m_i < len(sorted_lines) - 1 and parsed[m_i]:
                g = parsed[m_i]
                app_str += (f"seq1 {g[0]} {g[1]}; seq2 {g[2]} {g[3]}; "
                            f"score={g[4]} (+)\n")
            if m_i == 0:
                continue
            gp = parsed[m_i - 1]
            gc = parsed[m_i]
            if gp is None or gc is None:
                continue
            gap1begin = int(gp[1]) + 1
            gap2begin = int(gp[3]) + 1
            gap1end = int(gc[0]) - 1
            gap2end = int(gc[2]) - 1
            boxarea = (gap1end - gap1begin + 1) * (gap2end - gap2begin + 1)
            if (boxarea >= MINBOX and (gap1end - gap1begin + 1) > MINSIDE
                    and (gap2end - gap2begin + 1) > MINSIDE):
                if gap1begin < gap1end and gap2begin < gap2end:
                    nb1.append(gap1begin)
                    nb2.append(gap2begin)
                    ne1.append(gap1end)
                    ne2.append(gap2end)
        b1, b2, e1, e2 = nb1, nb2, ne1, ne2

    return "".join(
        l + "\n" for l in _gnu_sort_n_k2(sorted_lines, reverse=True))


def lagan_pl_mfa(seq1: bytes, name1: str, seq2: bytes, name2: str) -> str:
    """Full ``lagan.pl seq1 seq2 -mfa`` replacement; returns the mfa text.

    The order-stage band DP routes to the device when device_dispatch()
    is on (kernels/order_device.py — byte-identical pointer matrix,
    native band construction and traceback); SIBELIA_TPU_DEVICE_ORDER=1/0
    forces it on or off."""
    import os
    anchors = rechaos(seq1, name1, seq2, name2)
    env = os.environ.get("SIBELIA_TPU_DEVICE_ORDER")
    use_dev = env != "0" if env is not None else None
    if use_dev is None:
        from ..core.platform import device_dispatch
        use_dev = device_dispatch()
    if use_dev:
        from ..kernels.order_device import order_mfa_device
        dev = order_mfa_device(seq1, name1, seq2, name2, anchors)
        if dev is not None:
            return dev
    return lagan_order(seq1, name1, seq2, name2, anchors)


def _mfa_rows(mfa: str) -> tuple[str, str]:
    rows: list[str] = []
    cur: list[str] = []
    for line in mfa.split("\n"):
        if line.startswith(">"):
            if cur:
                rows.append("".join(cur))
                cur = []
        elif line:
            cur.append(line)
    if cur:
        rows.append("".join(cur))
    return rows[0], rows[1]


def align_pair_exact(a: bytes, b: bytes,
                     name_a: str = "seq_a",
                     name_b: str = "seq_b") -> tuple[str, str]:
    """Aligned rows for a unique block pair, byte-identical to the rows the
    reference C-Sibelia obtains from ``lagan.pl -mfa``."""
    if isinstance(a, str):
        a = a.encode()
    if isinstance(b, str):
        b = b.encode()
    return _mfa_rows(lagan_pl_mfa(a, name_a, b, name_b))


def align_pairs_exact_batch(
        pairs: list[tuple[bytes, bytes, str, str]],
        processes: int = 1,
) -> list[tuple[str, str] | None]:
    """Batched unique-pair alignment: anchors per pair on the host
    (fanned over a thread pool when processes > 1 — the native chaos
    engine releases the GIL), then every band DP in grouped vmapped
    device dispatches (kernels/order_device.py).  Entries come back None
    when a pair needs the host fallback (band too wide); rows are
    byte-identical to align_pair_exact either way."""
    from ..kernels.order_device import order_mfa_device_batch

    def one(p):
        a, b, name_a, name_b = p
        if isinstance(a, str):
            a = a.encode()
        if isinstance(b, str):
            b = b.encode()
        return (a, name_a, b, name_b, rechaos(a, name_a, b, name_b))

    if processes > 1 and len(pairs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=processes) as pool:
            jobs = list(pool.map(one, pairs))
    else:
        jobs = [one(p) for p in pairs]
    res = order_mfa_device_batch(jobs)
    return [None if mfa is None else _mfa_rows(mfa) for mfa in res]
