"""Approximate complete matching: Hamming (-h k) and edit (-e k).

Reference algorithms (all emit start positions in suffix-rank order):
- Hamming: esahamming linear suftab scan with mismatch stack
  (src/Vmengine/esahamming.c:86-163),
- edit: esaapm suftab scan with Myers bit-vector column stack
  (src/Vmengine/esaapm.c:296-383); large k / long patterns:
  splitesaapm pattern partitioning (src/Vmengine/splitesaapm.c:465);
  per emitted start, (length, distance) from the longest-match scan
  (src/Vmengine/longestmatch.c, approxcompl.c:13-65).

Batched design — the partition filter IS the batch-friendly
formulation, so it is used for every k (result set identical to the
scanning algorithms), batched over ALL query patterns at once:

1. split every pattern into k+1 pieces; any occurrence with <= k
   errors contains one piece exactly (pigeonhole),
2. locate all pieces of all patterns with ONE batched packed-key
   interval lookup (engine/complete.py),
3. expand piece hits to (query, start) candidates (edit: +-k shifts),
   dedupe,
4. verify all candidates in parallel: vectorized mismatch count
   (Hamming) or multiword Myers bit-vector DP over gathered text
   windows (edit) — one uint32 lane per candidate,
5. emit survivors in (query, suffix-rank-of-start) order to mirror
   the reference's per-query rank-order scan.

Semantics preserved exactly (verified against the reference binary):
byte-equality compare (a wildcard in the pattern matches the same
wildcard byte in the text), a SEPARATOR stops the scan — no window
crossing one counts (esaapm.c:266-269), maxlength = plen + k.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import SEPARATOR, WILDCARD
from ..core.route import note
from ..index.esa import ESA
from .complete import exact_interval_lookup
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable


def _all_piece_candidates(
    esa: ESA, patterns: list[np.ndarray], k: int, shifted: bool
) -> tuple[np.ndarray, np.ndarray]:
    """(qidx, start) candidates for every pattern, deduped.

    Pattern partitioning (splitesaapm.c:388-464): k+1 pieces per
    pattern, one batched exact lookup for all pieces of all patterns.
    Patterns containing special chars fall back to all-starts
    (the reference's byte-equality scan can match them; the index
    piece search cannot).
    """
    n = esa.totallength
    qidx_l: list[np.ndarray] = []
    piece_rows = []   # (qi, off, len)
    brute_q = []
    for qi, pat in enumerate(patterns):
        plen = pat.size
        if (pat >= 250).any() and plen <= 64:
            # short special-containing patterns: the esaapm scan is
            # byte-permissive, emulate with all-starts verification;
            # long ones go through splitesaapm's exact piece search
            # where special pieces simply never match
            # (splitesaapm.c:388-464)
            brute_q.append(qi)
            continue
        parts = k + 1
        base = plen // parts
        rem = plen % parts
        off = 0
        for i in range(parts):
            ln = base + (1 if i < rem else 0)
            if ln > 0:
                piece_rows.append((qi, off, ln))
            off += ln
    cands = []
    if piece_rows:
        maxlen = max(ln for _, _, ln in piece_rows)
        P = len(piece_rows)
        pats = np.full((P, maxlen), -1, np.int32)
        plens = np.zeros(P, np.int32)
        for i, (qi, off, ln) in enumerate(piece_rows):
            pats[i, :ln] = patterns[qi][off : off + ln].astype(np.int32)
            plens[i] = ln
        lo, hi = exact_interval_lookup(esa, pats, plens)
        counts = np.maximum(hi - lo, 0)
        total = int(counts.sum())
        if total:
            pidx = np.repeat(np.arange(P), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            ranks = (np.arange(total) - starts[pidx]) + lo[pidx]
            occ = esa.suftab[ranks].astype(np.int64)
            offs = np.array([o for _, o, _ in piece_rows], np.int64)
            qis = np.array([q for q, _, _ in piece_rows], np.int64)
            pos = occ - offs[pidx]
            qi_arr = qis[pidx]
            if shifted:
                sh = np.arange(-k, k + 1, dtype=np.int64)
                pos = (pos[:, None] + sh[None, :]).ravel()
                qi_arr = np.repeat(qi_arr, sh.size)
            keep = (pos >= 0) & (pos < n)
            cands.append((qi_arr[keep], pos[keep]))
    for qi in brute_q:
        allpos = np.arange(max(n, 0), dtype=np.int64)
        cands.append((np.full(allpos.size, qi, np.int64), allpos))
    if not cands:
        z = np.zeros(0, np.int64)
        return z, z
    qi_all = np.concatenate([c[0] for c in cands])
    pos_all = np.concatenate([c[1] for c in cands])
    key = qi_all * (n + 1) + pos_all
    uniq = np.unique(key)
    return uniq // (n + 1), uniq % (n + 1)


# ---------------------------------------------------------------------------
# Hamming verification (esahamming.c semantics)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("maxplen", "n"))
def _verify_hamming(text, cand, qidx, patmat, plens, maxplen: int, n: int):
    idx = cand[:, None] + jnp.arange(maxplen, dtype=jnp.int32)[None, :]
    inb = idx < n
    ch = jnp.where(inb, text[jnp.minimum(idx, n - 1)].astype(jnp.int32),
                   SEPARATOR)
    pat = patmat[qidx]                   # [P, maxplen]
    pl = plens[qidx]
    active = (jnp.arange(maxplen, dtype=jnp.int32)[None, :]
              < pl[:, None])
    sep = active & (ch == SEPARATOR)
    ok = ~jnp.any(sep, axis=1)
    mm = jnp.sum((active & (ch != pat)).astype(jnp.int32), axis=1)
    return ok, mm


# ---------------------------------------------------------------------------
# edit verification: batched multiword Myers (Myers 1999 / Hyyro)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("w", "maxlen", "n"))
def _verify_edit(text, cand, qidx, eqs, plens, w: int, maxlen: int,
                 n: int):
    """Per candidate: (minscore over lengths, bestlen, bestscore).

    eqs: uint32[Q, w, 256] per-query pattern masks.  Tracks the
    reference longest-match rule (update when score <= stored, stop
    updates at the first SEPARATOR — longestmatch.c:6-11,40-45) and
    the existence score min over all lengths (esaapm success test).
    """
    P = cand.shape[0]
    idx = cand[:, None] + jnp.arange(maxlen, dtype=jnp.int32)[None, :]
    inb = idx < n
    window = jnp.where(
        inb, text[jnp.minimum(idx, n - 1)].astype(jnp.int32), SEPARATOR
    )
    pl = plens[qidx]                       # [P]
    top_word = (pl - 1) // 32              # [P]
    top_shift = ((pl - 1) % 32).astype(jnp.uint32)

    def step(l, st):
        Pv, Mv, score, minsc, bestlen, bestsc, sepseen = st
        ch = window[:, l]
        is_sep = ch == SEPARATOR
        Eq = [eqs[qidx, j, ch] for j in range(w)]
        carry = jnp.zeros((P,), jnp.uint32)
        Xh = []
        for j in range(w):
            t = Eq[j] & Pv[j]
            s1 = t + Pv[j]
            c1 = (s1 < t).astype(jnp.uint32)
            s2 = s1 + carry
            c2 = (s2 < s1).astype(jnp.uint32)
            carry = c1 | c2
            Xh.append((s2 ^ Pv[j]) | Eq[j])
        Xv = [Eq[j] | Mv[j] for j in range(w)]
        Ph = [Mv[j] | ~(Xh[j] | Pv[j]) for j in range(w)]
        Mh = [Pv[j] & Xh[j] for j in range(w)]
        # top-row bit of the per-candidate top word
        ph_top = Ph[0]
        mh_top = Mh[0]
        for j in range(1, w):
            sel = top_word == j
            ph_top = jnp.where(sel, Ph[j], ph_top)
            mh_top = jnp.where(sel, Mh[j], mh_top)
        score = score + ((ph_top >> top_shift) & 1).astype(jnp.int32)
        score = score - ((mh_top >> top_shift) & 1).astype(jnp.int32)
        Ph_s = []
        Mh_s = []
        ph_c = jnp.ones((P,), jnp.uint32)
        mh_c = jnp.zeros((P,), jnp.uint32)
        for j in range(w):
            Ph_s.append((Ph[j] << 1) | ph_c)
            Mh_s.append((Mh[j] << 1) | mh_c)
            ph_c = Ph[j] >> 31
            mh_c = Mh[j] >> 31
        nPv = tuple(Mh_s[j] | ~(Xv[j] | Ph_s[j]) for j in range(w))
        nMv = tuple(Ph_s[j] & Xv[j] for j in range(w))
        # the reference scan STOPS at a SEPARATOR (esaapm.c:266-269):
        # windows crossing one never count, for existence or length
        sepseen = sepseen | is_sep
        minsc = jnp.where(sepseen, minsc, jnp.minimum(minsc, score))
        upd = (~sepseen) & (bestsc >= score)
        bestlen = jnp.where(upd, l + 1, bestlen)
        bestsc = jnp.where(upd, score, bestsc)
        return nPv, nMv, score, minsc, bestlen, bestsc, sepseen

    ones = jnp.full((P,), 0xFFFFFFFF, jnp.uint32)
    st = (
        tuple(ones for _ in range(w)),
        tuple(jnp.zeros((P,), jnp.uint32) for _ in range(w)),
        pl.astype(jnp.int32),
        pl.astype(jnp.int32),
        jnp.zeros((P,), jnp.int32),
        pl.astype(jnp.int32),
        jnp.zeros((P,), bool),
    )
    st = lax.fori_loop(0, maxlen, step, st)
    _, _, _, minsc, bestlen, bestsc, _ = st
    return minsc, bestlen, bestsc


# ---------------------------------------------------------------------------
# splitesaapm replication for long edit patterns (splitesaapm.c)
# ---------------------------------------------------------------------------


def _getoptsplit(numofchars: int, textlen: int, plen: int, k: int,
                 doedist: bool = True,
                 spliterrorbound: int = 10) -> int:
    """getoptsplit (splitesaapm.c:316-352): the cost-model split size
    deciding between the direct esaapm/esahamming rank scan
    (splitsize == 1) and the piece-search region pipeline."""
    import math

    if k * spliterrorbound >= plen:
        optsplit = k
    else:
        ratio = math.log(textlen) / math.log(max(numofchars, 2))
        optsplit = int(((plen + k) if doedist else plen) / ratio)
        if optsplit > k + 1:
            optsplit = k + 1
    while plen > 32 * optsplit:
        optsplit += 1
    return optsplit


def _eqs_matrix(patterns: list[np.ndarray], maxlen: int) -> np.ndarray:
    """GETEQS-rule masks (pattern WILDCARD bits dropped,
    kurtz-basic/getEqs.gen)."""
    w = (maxlen + 31) // 32
    eqs = np.zeros((len(patterns), w, 256), np.uint32)
    for qi, p in enumerate(patterns):
        for i, c in enumerate(p):
            if int(c) >= WILDCARD:
                continue
            eqs[qi, i // 32, int(c)] |= np.uint32(1 << (i % 32))
    return eqs


def _esaapm_starts(esa: ESA, patterns: list[np.ndarray], k: int):
    """Start positions with Eq-adjusted min edit distance <= k
    (exact esaapm semantics, for patterns <= 32 chars): pigeonhole
    candidates + batched Myers verification.  Returns (qidx, pos)."""
    n = esa.totallength
    plens = np.array([p.size for p in patterns], np.int32)
    if k == 0:
        qidx_l, pos_l = [], []
        valid = [qi for qi, p in enumerate(patterns)
                 if not (p >= 250).any()]
        if valid:
            maxlen = int(max(plens[qi] for qi in valid))
            pats = np.full((len(valid), maxlen), -1, np.int32)
            pl = np.zeros(len(valid), np.int32)
            for i, qi in enumerate(valid):
                pats[i, : plens[qi]] = patterns[qi].astype(np.int32)
                pl[i] = plens[qi]
            lo, hi = exact_interval_lookup(esa, pats, pl)
            for i, qi in enumerate(valid):
                if hi[i] > lo[i]:
                    occ = esa.suftab[lo[i] : hi[i]].astype(np.int64)
                    qidx_l.append(np.full(occ.size, qi, np.int64))
                    pos_l.append(occ)
        if not qidx_l:
            z = np.zeros(0, np.int64)
            return z, z
        return np.concatenate(qidx_l), np.concatenate(pos_l)
    qidx, pos = _all_piece_candidates(esa, patterns, k, shifted=True)
    ok = pos <= n - (plens[qidx].astype(np.int64) - k)
    qidx, pos = qidx[ok], pos[ok]
    if pos.size == 0:
        return qidx, pos
    maxlen = int(plens.max())
    w = (maxlen + 31) // 32
    eqs = _eqs_matrix(patterns, maxlen)
    minsc, _, _ = _verify_edit(
        esa.device("text"), jnp.asarray(pos, dtype=jnp.int32),
        jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(eqs),
        jnp.asarray(plens), w, maxlen + k, n)
    okv = np.asarray(minsc) <= k
    return qidx[okv], pos[okv]


def _hamming_starts(esa: ESA, patterns: list[np.ndarray], k: int):
    """Start positions with <= k mismatches over the whole pattern
    (exact esahamming result set).  Pigeonhole candidates + batched
    verification.  Returns (qidx, pos, mm), unordered."""
    n = esa.totallength
    plens = np.array([p.size for p in patterns], np.int32)
    qidx, pos = _all_piece_candidates(esa, patterns, k, shifted=False)
    ok_pre = pos + plens[qidx] <= n
    qidx, pos = qidx[ok_pre], pos[ok_pre]
    z = np.zeros(0, np.int64)
    if pos.size == 0:
        return z, z, z
    maxplen = int(plens.max())
    patmat = np.full((len(patterns), maxplen), -2, np.int32)
    for i, p in enumerate(patterns):
        patmat[i, : p.size] = p.astype(np.int32)
    okh, mm = _verify_hamming(
        esa.device("text"), jnp.asarray(pos, dtype=jnp.int32),
        jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(patmat),
        jnp.asarray(plens), maxplen, n,
    )
    mm = np.asarray(mm)
    okv = np.asarray(okh) & (mm <= k)
    return qidx[okv], pos[okv], mm[okv].astype(np.int64)


# Cells of one region-verification scan: lanes x (scan steps + the
# pattern column each lane carries).
_REGION_CELLS = 1 << 24


def _verify_regions(text: np.ndarray, patterns: list[np.ndarray],
                    plens: np.ndarray, merged: dict, k: int):
    """Reversed Ukkonen-cutoff verification of merged regions
    (splitesaapm.c:43-122 ``verifyedistlongmatch``): one lane per
    (query, region) scans its own window from the region's right end
    down to its left end, each from a fresh column.  Lanes are grouped
    by region length rounded up to a power of two, so one long merged
    region (a tandem repeat) pads no other lane to its length, and each
    group runs in chunks of at most ``_REGION_CELLS`` cells, a
    power-of-two lane count each (few distinct programs).  Windows and
    spare lanes are padded with SEPARATOR, which emits nothing.
    Returns (qidx, pos): per query, regions ascending, starts inside a
    region descending (the reference scan direction)."""
    from .online import _ukkonen_cutoff_scan

    lanes = [(qi, a, b) for qi in range(len(patterns))
             for a, b in merged.get(qi, ())]
    lane_q, lane_a, lane_b = (np.array(v, np.int64) for v in zip(*lanes))
    M = int(plens.max())
    patrev = np.full((len(patterns), M + 2), -7, np.int32)
    for qi, p in enumerate(patterns):
        patrev[qi, 1 : p.size + 1] = p[::-1]
    span = lane_b - lane_a + 1
    cls = np.ceil(np.log2(span)).astype(np.int64)
    cls += (1 << cls) < span
    hit_lane: list[np.ndarray] = []
    hit_pos: list[np.ndarray] = []
    for c in np.unique(cls):
        steps = 1 << int(c)
        group = np.flatnonzero(cls == c)
        per = max(1, _REGION_CELLS // (steps + M + 2))
        per = 1 << (per.bit_length() - 1)
        for g in np.split(group, np.arange(per, group.size, per)):
            R = 1 << (g.size - 1).bit_length()
            pos = lane_b[g][None, :] - np.arange(steps)[:, None]
            window = np.full((steps, R), SEPARATOR, np.uint8)
            window[:, :g.size] = np.where(
                pos >= lane_a[g][None, :], text[np.maximum(pos, 0)],
                SEPARATOR)
            q = np.zeros(R, np.int64)
            q[:g.size] = lane_q[g]
            emits = np.asarray(_ukkonen_cutoff_scan(
                jnp.asarray(window), jnp.asarray(patrev[q]),
                jnp.asarray(plens[q]), M, k))[:, :g.size]
            r, s = np.nonzero(emits.T)
            hit_lane.append(g[r])
            hit_pos.append(lane_b[g][r] - s)
    lane = np.concatenate(hit_lane)
    pos = np.concatenate(hit_pos)
    # lane order (query, region ascending), positions descending
    order = np.lexsort((-pos, lane))
    return lane_q[lane[order]], pos[order]


def _region_detect(
    esa: ESA, patterns: list[np.ndarray], k: int, doedist: bool
) -> tuple[np.ndarray, np.ndarray]:
    """splitesaapm replay (splitesaapm.c:380-560, splitsize > 1):
    cost-model piece split, approximate piece search, region collect
    + merge (kurtz/regionsmerger.c), and per-region verification.

    Emission order matches the reference exactly: per query, regions
    ascending by start (the red-black in-order walk,
    redblacktreewalkwithstop), and inside a region start positions
    DESCENDING (the verify functions scan each region from its end,
    splitesaapm.c:42-240).  Returns (qidx, pos)."""
    n = esa.totallength
    B = len(patterns)
    plens = np.array([p.size for p in patterns], np.int32)
    numofchars = esa.alpha.mapsize - 1

    # 1. piece search -> candidate regions per query
    piece_pats: list[np.ndarray] = []
    piece_meta: list[tuple[int, int, int]] = []   # (qi, poffset, thr)
    for qi, p in enumerate(patterns):
        plen = int(plens[qi])
        splitsize = _getoptsplit(numofchars, n, plen, k, doedist)
        splitlen = plen // splitsize
        splitthr = k // splitsize
        poffset = 0
        while poffset < plen - splitlen + 1:
            piece_pats.append(p[poffset : poffset + splitlen])
            piece_meta.append((qi, poffset, splitthr))
            poffset += splitlen
    by_thr: dict[int, list[int]] = {}
    for i, (_, _, t) in enumerate(piece_meta):
        by_thr.setdefault(t, []).append(i)
    regions: dict[int, list[tuple[int, int]]] = {qi: [] for qi in
                                                 range(B)}
    for t, idxs in by_thr.items():
        sub = [piece_pats[i] for i in idxs]
        if doedist:
            pq, pp = _esaapm_starts(esa, sub, t)
        else:
            pq, pp, _ = _hamming_starts(esa, sub, t)
        for j in range(pq.size):
            i = idxs[int(pq[j])]
            qi, poffset, _ = piece_meta[i]
            h = int(pp[j])
            plen = int(plens[qi])
            # storeapmposition (splitesaapm.c:270-296): edit regions
            # widen by the threshold, hamming regions do not
            # (realsplitesaapm, splitesaapm.c:384-392)
            if doedist:
                u0 = max(0, h - (k + poffset))
                u1 = min(n - 1, h + plen + k - poffset - 1)
            else:
                u0 = max(0, h - poffset)
                u1 = min(n - 1, h + plen - poffset - 1)
            regions[qi].append((u0, u1))

    # 2. merge overlapping/adjacent regions (regionsmerger.c; the
    # checker asserts prev.end + 1 < next.start for merged output)
    merged: dict[int, list[tuple[int, int]]] = {}
    any_region = False
    for qi, rs in regions.items():
        if not rs:
            continue
        rs.sort()
        out = [list(rs[0])]
        for u0, u1 in rs[1:]:
            if u0 <= out[-1][1] + 1:
                out[-1][1] = max(out[-1][1], u1)
            else:
                out.append([u0, u1])
        merged[qi] = [(a, b) for a, b in out]
        any_region = True
    z = np.zeros(0, np.int64)
    if not any_region:
        return z, z

    qidx_parts: list[np.ndarray] = []
    pos_parts: list[np.ndarray] = []
    if doedist:
        # 3a. per-region reversed cutoff verification
        q, p = _verify_regions(esa.multiseq.sequence, patterns, plens,
                               merged, k)
        qidx_parts.append(q)
        pos_parts.append(p)
    else:
        # 3b. hamming region verification: all window starts inside
        # each region, verified in one batch, emitted descending
        cand_q: list[np.ndarray] = []
        cand_p: list[np.ndarray] = []
        for qi in range(B):
            plen = int(plens[qi])
            for a, b in merged.get(qi, ()):
                hi = b - plen + 1
                if hi < a:
                    continue
                ps = np.arange(hi, a - 1, -1, dtype=np.int64)
                cand_p.append(ps)
                cand_q.append(np.full(ps.size, qi, np.int64))
        if not cand_q:
            return z, z
        qidx = np.concatenate(cand_q)
        pos = np.concatenate(cand_p)
        maxplen = int(plens.max())
        patmat = np.full((B, maxplen), -2, np.int32)
        for i, p in enumerate(patterns):
            patmat[i, : p.size] = p.astype(np.int32)
        okh, mm = _verify_hamming(
            esa.device("text"), jnp.asarray(pos, dtype=jnp.int32),
            jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(patmat),
            jnp.asarray(plens), maxplen, n,
        )
        okv = np.asarray(okh) & (np.asarray(mm) <= k)
        return qidx[okv], pos[okv]
    if not qidx_parts:
        return z, z
    return np.concatenate(qidx_parts), np.concatenate(pos_parts)


# ---------------------------------------------------------------------------
# top level (hammingprocessstartpos / edistprocessstartpos,
# approxcompl.c:13-80)
# ---------------------------------------------------------------------------


def approx_complete_matches(
    esa: ESA,
    query: "list[np.ndarray]",
    k: int,
    edit: bool,
    query_seqnums: np.ndarray | None = None,
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
) -> MatchTable:
    """-complete -h/-e k over a batch of query patterns; emission in
    (query, rank-of-start) order."""
    B = len(query)
    n = esa.totallength
    if B == 0 or n == 0:
        return MatchTable()
    note("approximate matching", "device")
    if query_seqnums is None:
        query_seqnums = np.arange(B, dtype=np.int64)
    if query_starts is None:
        query_starts = np.zeros(B, np.int64)

    plens_np = np.array([p.size for p in query], np.int32)
    if edit and (plens_np <= k).any():
        raise ValueError("edit threshold must be < pattern length")
    maxplen = int(plens_np.max())

    d_text = esa.device("text")
    d_pl = jnp.asarray(plens_np)

    # routing per query (findapproxcompletematchesindex ->
    # splitesaapm, splitesaapm.c:500-560): splitsize == 1 runs the
    # direct esaapm/esahamming rank-order scan, splitsize > 1 the
    # piece-search region pipeline whose emission order is
    # region-major (see _region_detect)
    numofchars = esa.alpha.mapsize - 1
    rank_q: list[int] = []
    region_q: list[int] = []
    for qi in range(B):
        # threshold 0 falls back to the exact interval emission
        # (findapproxcompletematchesindex, approxcompl.c:165-175)
        ssz = 1 if k == 0 else _getoptsplit(
            numofchars, n, int(plens_np[qi]), k, doedist=edit)
        (rank_q if ssz == 1 else region_q).append(qi)

    qp: list[np.ndarray] = []
    pp: list[np.ndarray] = []
    if rank_q:
        sub = [query[qi] for qi in rank_q]
        if edit:
            sq, sp = _esaapm_starts(esa, sub, k)
        else:
            sq, sp, _ = _hamming_starts(esa, sub, k)
        # rank-order emission (esaapm.c:296-383 / esahamming.c:86-163)
        if sp.size:
            order = np.lexsort((esa.stitab[sp], sq))
            sq, sp = sq[order], sp[order]
        qp.append(np.asarray(rank_q, np.int64)[sq])
        pp.append(sp.astype(np.int64))
    if region_q:
        sub = [query[qi] for qi in region_q]
        lq, lp = _region_detect(esa, sub, k, doedist=edit)
        qp.append(np.asarray(region_q, np.int64)[lq])
        pp.append(lp.astype(np.int64))
    qidx = np.concatenate(qp) if qp else np.zeros(0, np.int64)
    pos = np.concatenate(pp) if pp else np.zeros(0, np.int64)
    if pos.size == 0:
        return MatchTable()
    # stable per-query interleave of the two groups' emissions
    order = np.argsort(qidx, kind="stable")
    qidx, pos = qidx[order], pos[order]

    if edit:
        # measurement (edistprocessstartpos -> longestmatch.c) with
        # the GETEQS rule: pattern WILDCARDs never match
        w = (maxplen + 31) // 32
        eqs = _eqs_matrix(query, maxplen)
        _, bestlen, bestsc = _verify_edit(
            d_text, jnp.asarray(pos, dtype=jnp.int32),
            jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(eqs),
            d_pl, w, maxplen + k, n,
        )
        lens = np.asarray(bestlen).astype(np.int64)
        dist = np.asarray(bestsc).astype(np.int64)
    else:
        patmat = np.full((B, maxplen), -2, np.int32)
        for i, p in enumerate(query):
            patmat[i, : p.size] = p.astype(np.int32)
        _, mm = _verify_hamming(
            d_text, jnp.asarray(pos, dtype=jnp.int32),
            jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(patmat),
            d_pl, maxplen, n,
        )
        lens = plens_np[qidx].astype(np.int64)
        dist = -np.asarray(mm).astype(np.int64)

    tot = pos.size
    ms = esa.multiseq
    seq1, rel1 = ms.pos_to_pair(pos)
    return MatchTable(
        length1=lens,
        position1=pos,
        length2=plens_np[qidx].astype(np.int64),
        position2=query_starts[qidx].astype(np.int64),
        distance=dist,
        flag=np.full(tot, FLAGQUERY | FLAGCOMPLETEMATCH | flags_extra,
                     np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=query_seqnums[qidx].astype(np.int64),
        relpos2=np.zeros(tot, np.int64),
        evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64),
    )
