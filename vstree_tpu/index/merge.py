"""Multi-index merge (reference kurtz-basic/mergeesa.c:124-288
``stepdeleteandinsertothersuffixes`` + trie, tested by
bin/Checkmergeesa.sh): k separately built indexes merge into the index
of their concatenation WITHOUT re-sorting.

Array reformulation: the merged rank of a suffix is its local
rank plus, for every other index, the count of that index's suffixes
ordering below it — a batched binary search per index pair (the
reference's k-way trie walk becomes k*(k-1) vectorized searchsorted
passes).  Comparison semantics of the concatenated text (SURVEY
Appendix A.1): regular chars by code, any special/past-the-end beats
regular, special vs special by GLOBAL position — since every special
of an earlier part precedes every special of a later part, a tie
resolves to the earlier part.

This is the reference's inter-host seam for text sharding (SURVEY §2.7.3):
per-host partial indexes merge into the global order with
communication proportional to the cross-rank counts.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD


def _cross_rel(ta: np.ndarray, pa: np.ndarray, tb: np.ndarray,
               pb: np.ndarray, a_first: bool) -> np.ndarray:
    """sign(suffix_a - suffix_b) under concatenated-text semantics,
    vectorized over pairs; ``a_first`` = text a precedes text b in the
    concatenation (ties on simultaneous special/exhaustion resolve to
    the earlier part)."""
    m = pa.size
    na, nb = ta.size, tb.size
    out = np.zeros(m, np.int8)
    undec = np.arange(m)
    off = 0
    w = 32
    while undec.size:
        ia = pa[undec][:, None] + off + np.arange(w)[None, :]
        ib = pb[undec][:, None] + off + np.arange(w)[None, :]
        ca = ta[np.minimum(ia, na - 1)].astype(np.int32)
        cb = tb[np.minimum(ib, nb - 1)].astype(np.int32)
        sa = (ia >= na) | (ca >= WILDCARD)
        sb = (ib >= nb) | (cb >= WILDCARD)
        # decision per column: both special -> tie by part order;
        # one special -> special greater; else by code
        dec = sa | sb | (ca != cb)
        val = np.where(
            sa & sb, -1 if a_first else 1,
            np.where(sa, 1, np.where(sb, -1, np.sign(ca - cb))),
        ).astype(np.int8)
        first = np.argmax(dec, axis=1)
        any_dec = dec.any(axis=1)
        res = np.take_along_axis(val, first[:, None], axis=1)[:, 0]
        out[undec[any_dec]] = res[any_dec]
        undec = undec[~any_dec]
        off += w
        if w < 1024:
            w *= 2
    return out


def _cross_counts(ta, suf_a, tb, suf_b, a_first: bool) -> np.ndarray:
    """For every suffix of a (by rank), the number of b-suffixes that
    order before it: batched binary search over b's rank order."""
    ma = suf_a.size
    mb = suf_b.size
    lo = np.zeros(ma, np.int64)
    hi = np.full(ma, mb, np.int64)
    pa = suf_a.astype(np.int64)
    while True:
        open_ = lo < hi
        if not open_.any():
            break
        mid = (lo + hi) // 2
        sel = np.flatnonzero(open_)
        rel = _cross_rel(ta, pa[sel], tb,
                         suf_b[mid[sel]].astype(np.int64), a_first)
        # b-suffix < a-suffix  <=>  rel > 0
        lt = rel > 0
        lo[sel[lt]] = mid[sel[lt]] + 1
        hi[sel[~lt]] = mid[sel[~lt]]
    return lo


def merge_indexes(parts: list) -> tuple[np.ndarray, np.ndarray]:
    """Merge k ESAs (each over one part text, in concatenation order)
    into (global_suftab, global_text) of the SEPARATOR-joined
    concatenation.  Rank arithmetic only — no re-sort."""
    k = len(parts)
    offsets = []
    texts = []
    off = 0
    for i, esa in enumerate(parts):
        offsets.append(off)
        texts.append(esa.multiseq.sequence)
        off += esa.multiseq.totallength + 1   # + separator
    total = off - 1
    gtext = np.full(total, 255, np.uint8)
    for i, t in enumerate(texts):
        gtext[offsets[i]:offsets[i] + t.size] = t

    # regular suffixes: global rank = local regular rank + cross
    # counts; special-starting suffixes (wildcards, the joining
    # separators, the sentinel) form the tail block ordered by GLOBAL
    # position (the monolithic index's special rule)
    granks = []
    regs = []
    special_pos = []
    for i, esa in enumerate(parts):
        suf_i = esa.suftab[:-1].astype(np.int64)  # minus the sentinel
        is_reg = texts[i][suf_i] < WILDCARD
        nreg_i = int(is_reg.sum())
        # the local order puts all special-starting suffixes last
        suf_reg = suf_i[:nreg_i]
        regs.append(suf_reg)
        special_pos.append(suf_i[nreg_i:] + offsets[i])
        rank = np.arange(nreg_i, dtype=np.int64)
        for j, other in enumerate(parts):
            if i == j:
                continue
            suf_j = other.suftab[:-1]
            rank = rank + _cross_counts(
                texts[i], suf_reg, texts[j], suf_j, a_first=(i < j))
        granks.append(rank)

    nreg = sum(r.size for r in regs)
    seppos = np.array(
        [offsets[i] + parts[i].multiseq.totallength
         for i in range(k - 1)] + [total], np.int64)
    tail = np.sort(np.concatenate(special_pos + [seppos]))
    suftab = np.empty(nreg + tail.size, np.int64)
    for i in range(k):
        suftab[granks[i]] = regs[i] + offsets[i]
    suftab[nreg:] = tail
    return suftab, gtext
