"""Online (index-free) complete matching: vmatch -online -complete.

Reference algorithms, all O(n) scans over the raw text:
- exact: Boyer-Moore-Horspool with ISSPECIAL-aware compare
  (src/Vmengine/exactcompl.c:277-325, src/kurtz/bmhfun.c),
- Hamming: right-to-left sliding window mismatch count with byte
  equality and SEPARATOR window skipping
  (src/Vmengine/hamcompl.c:8-55),
- edit: right-to-left Ukkonen cutoff column DP emitting one match per
  start position via the longest-match rescan
  (src/Vmengine/edistcompl.c:82-172, approxcompl.c:13-65).

Batched design: no per-window char loops.
- exact/Hamming: ONE batched accumulation over pattern offsets —
  a [B, n] mismatch-count matrix built in maxplen fused
  shift-compare-add steps on the VPU.
- edit: ONE semi-global multiword Myers bit-vector ``lax.scan`` over
  the REVERSED text with all B reversed patterns advancing in
  parallel (free text start <=> per-end-position score in the
  reversed domain = per-START-position minimal distance in the
  original, exactly the reference's right-to-left column DP);
  SEPARATOR resets the column in-scan.  Surviving starts are then
  verified/measured with the same batched longest-match kernel as the
  index path (engine/approx.py ``_verify_edit``).

Match records and emission order mirror the reference: exact emits in
ascending text position (BMH scans left to right), Hamming and edit
in descending position (their scans run right to left).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import SEPARATOR, WILDCARD
from ..index.esa import ESA
from .approx import _verify_edit
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable


@functools.partial(jax.jit, static_argnames=("maxplen", "n", "special_mm"))
def _window_mismatches(text, patmat, plens, maxplen: int, n: int,
                       special_mm: bool):
    """[B, n] mismatch counts of every pattern against every window
    start, plus [B, n] separator-in-window flags.

    special_mm=True applies the exact-match rule (ISSPECIAL text chars
    never match, exactcompl.c:308); False is raw byte equality
    (hamcompl.c:32).
    """
    B = patmat.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)

    def step(o, st):
        mm, sep = st
        idx = pos + o
        inb = idx < n
        ch = jnp.where(inb, text[jnp.minimum(idx, n - 1)].astype(jnp.int32),
                       SEPARATOR)
        active = o < plens[:, None]                      # [B, n]
        pc = patmat[:, o][:, None]                       # [B, 1]
        neq = ch[None, :] != pc
        if special_mm:
            neq = neq | (ch[None, :] >= WILDCARD)
        mm = mm + jnp.where(active & neq, 1, 0)
        sep = sep | (active & (ch[None, :] == SEPARATOR))
        return mm, sep

    mm0 = jnp.zeros((B, n), jnp.int32)
    sep0 = jnp.zeros((B, n), bool)
    return lax.fori_loop(0, maxplen, step, (mm0, sep0))


@functools.partial(jax.jit, static_argnames=("w", "n"))
def _semiglobal_myers(text_rev, eqs_rev, plens, top_word, top_shift,
                      w: int, n: int):
    """[n, B] per-start-position scores via the reference's online
    Myers scan (edistmyersbitvectorAPM4/8, edistcompl.c:261-385):
    reversed pattern masks over the right-to-left text scan, free text
    start (Ph << 1 without carry), SEPARATOR column reset.  Exact —
    used for patterns <= 64 chars."""
    B = plens.shape[0]
    ones = jnp.full((B,), 0xFFFFFFFF, jnp.uint32)
    zeros = jnp.zeros((B,), jnp.uint32)
    plen_i = plens.astype(jnp.int32)

    def step(st, ch):
        Pv, Mv, score = st
        is_sep = ch == SEPARATOR
        Eq = [eqs_rev[:, j, ch] for j in range(w)]
        carry = jnp.zeros((B,), jnp.uint32)
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
        ph_top = Ph[0]
        mh_top = Mh[0]
        for j in range(1, w):
            sel = top_word == j
            ph_top = jnp.where(sel, Ph[j], ph_top)
            mh_top = jnp.where(sel, Mh[j], mh_top)
        nsc = (score + ((ph_top >> top_shift) & 1).astype(jnp.int32)
               - ((mh_top >> top_shift) & 1).astype(jnp.int32))
        ph_c = zeros            # free text start: no carry-in
        mh_c = zeros
        nPv = []
        nMv = []
        for j in range(w):
            Ph_s = (Ph[j] << 1) | ph_c
            Mh_s = (Mh[j] << 1) | mh_c
            ph_c = Ph[j] >> 31
            mh_c = Mh[j] >> 31
            nPv.append(Mh_s | ~(Xv[j] | Ph_s))
            nMv.append(Ph_s & Xv[j])
        nPv = tuple(jnp.where(is_sep, ones, v) for v in nPv)
        nMv = tuple(jnp.where(is_sep, zeros, v) for v in nMv)
        nsc = jnp.where(is_sep, plen_i, nsc)
        out = jnp.where(is_sep, jnp.iinfo(jnp.int32).max, nsc)
        return (nPv, nMv, nsc), out

    st0 = (tuple(ones for _ in range(w)),
           tuple(zeros for _ in range(w)),
           plen_i)
    _, scores = lax.scan(step, st0, text_rev.astype(jnp.int32))
    return scores                                       # [n, B]


@functools.partial(jax.jit, static_argnames=("M", "k"))
def _ukkonen_cutoff_scan(text_rev, patrev, plens, M: int, k: int,
                         resets=None, inregion=None):
    """Faithful batched replay of the reference's right-to-left
    Ukkonen-cutoff detection scan (edistcompl.c:82-172 online;
    splitesaapm.c:43-122 ``verifyedistlongmatch`` region verify), ONE
    ``lax.scan`` over the text with all B patterns advancing in
    lockstep.

    The reference maintains a column dcol[0..end) of cells <=
    threshold and EXTENDS the column by writing the literal value
    ``threshold`` into the next cell (edistcompl.c:144-149) — an
    upper-bound shortcut that makes the scan slightly approximate
    (it can both miss true starts and emit starts whose true distance
    exceeds k; the shipped binary does exactly this, so we replicate
    it for output parity).  The sequential in-column min-chain
    new[i] = min(old[i]+1, old[i-1]+delta, new[i-1]+1) is vectorized
    with the prefix-min identity new[i] = min_{j<=i}(t[j]-j)+i.

    ``text_rev`` is one reversed text shared by every lane ([n]) or one
    per lane ([n, B]).  ``resets``/``inregion`` ([n, B] bool,
    reversed-text order) re-initialize the column at marked steps and
    mask emissions outside marked steps.  None = one global scan (the
    -online behavior).

    Returns [n_rev_steps, B] bool emission flags (True where the full
    column is <= threshold at this start position).
    """
    B = plens.shape[0]
    idx = jnp.arange(M + 2, dtype=jnp.int32)[None, :]
    plen_col = plens.astype(jnp.int32)[:, None]
    BIG = jnp.int32(1 << 20)
    n_steps = text_rev.shape[0]
    if resets is None:
        resets = jnp.zeros((n_steps, B), bool)
    if inregion is None:
        inregion = jnp.ones((n_steps, B), bool)

    def step(st, x):
        ch, rst, inr = x
        dcol, end = st                       # [B, M+2], [B]
        dcol = jnp.where(rst[:, None], jnp.minimum(idx, BIG), dcol)
        end = jnp.where(rst, jnp.int32(k + 1), end)
        ch = jnp.reshape(ch, (-1,))          # [1] shared or [B]
        is_sep = ch == SEPARATOR
        delta = (patrev != ch[:, None]).astype(jnp.int32)
        old = dcol
        diag = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), old[:, :-1]], axis=1)
        t = jnp.minimum(old + 1, diag + delta)
        t = t.at[:, 0].set(0)
        new = lax.cummin(t - idx, axis=1) + idx
        upd = (idx >= 1) & (idx <= end[:, None] - 1)
        dcol2 = jnp.where(upd, new, old)
        # extension (edistcompl.c:144-149): pattern char for cell
        # ``end`` matches, or the last cell is strictly < threshold
        endm1 = jnp.take_along_axis(
            dcol2, (end - 1)[:, None], axis=1)[:, 0]
        ext_ch = jnp.take_along_axis(
            patrev, jnp.minimum(end, M + 1)[:, None], axis=1)[:, 0]
        can_ext = (end <= plen_col[:, 0]) & (
            (ext_ch == ch) | (k > endm1))
        dcol3 = jnp.where(
            can_ext[:, None] & (idx == end[:, None]), k, dcol2)
        # trim (edistcompl.c:151-155): last cell <= threshold
        ok = (dcol3 <= k) & (idx <= end[:, None] - 1)
        last = jnp.max(jnp.where(ok, idx, -1), axis=1)
        nend = jnp.where(can_ext, end + 1, last + 1)
        full = nend == plen_col[:, 0] + 1
        # SEPARATOR: reset column (edistcompl.c:105-113)
        nend = jnp.where(is_sep, jnp.int32(k + 1), nend)
        dcol3 = jnp.where(is_sep[:, None], jnp.minimum(idx, BIG), dcol3)
        emit = full & ~is_sep & inr
        return (dcol3, nend), emit

    dcol0 = jnp.broadcast_to(jnp.minimum(idx, BIG), (B, M + 2)
                             ).astype(jnp.int32)
    end0 = jnp.full((B,), k + 1, jnp.int32)
    _, emits = lax.scan(step, (dcol0, end0),
                        (text_rev.astype(jnp.int32), resets, inregion))
    return emits                                        # [n, B]


def online_complete_matches(
    esa: ESA,
    query: "list[np.ndarray]",
    k: int,
    kind: str,                       # "exact" | "hamming" | "edit"
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
) -> MatchTable:
    """-online -complete [-h k | -e k] over a batch of patterns."""
    B = len(query)
    n = esa.totallength
    if B == 0 or n == 0:
        return MatchTable()
    if query_starts is None:
        query_starts = np.zeros(B, np.int64)
    plens_np = np.array([p.size for p in query], np.int32)
    maxplen = int(plens_np.max())
    d_text = esa.device("text")

    # chunk the query batch so the dense [Bc, n] device matrices stay
    # bounded (~64 MB int32) instead of the former [B, n] blow-up
    Bc = max(1, (1 << 24) // max(n, 1))

    if kind in ("exact", "hamming"):
        patmat = np.full((B, maxplen), -2, np.int32)
        for i, p in enumerate(query):
            patmat[i, : p.size] = p.astype(np.int32)
        q_parts, p_parts, d_parts = [], [], []
        for g0 in range(0, B, Bc):
            gsl = slice(g0, min(g0 + Bc, B))
            mm, sep = _window_mismatches(
                d_text, jnp.asarray(patmat[gsl]),
                jnp.asarray(plens_np[gsl]),
                maxplen, n, kind == "exact")
            mm = np.asarray(mm)
            sep = np.asarray(sep)
            fits = (np.arange(n)[None, :]
                    <= (n - plens_np[gsl, None]).astype(np.int64))
            hit = fits & (mm <= (0 if kind == "exact" else k))
            if kind == "hamming":
                hit &= ~sep
            gq, gp = np.nonzero(hit)
            q_parts.append((gq + g0).astype(np.int64))
            p_parts.append(gp.astype(np.int64))
            d_parts.append(
                np.zeros(gp.size, np.int64) if kind == "exact"
                else -mm[gq, gp].astype(np.int64))
        qidx = np.concatenate(q_parts) if q_parts else \
            np.zeros(0, np.int64)
        pos = np.concatenate(p_parts) if p_parts else \
            np.zeros(0, np.int64)
        dist = np.concatenate(d_parts) if d_parts else \
            np.zeros(0, np.int64)
        lens = plens_np[qidx].astype(np.int64)
        if kind == "exact":
            order = np.lexsort((pos, qidx))      # ascending (BMH)
        else:
            order = np.lexsort((-pos, qidx))     # right-to-left scan
    else:
        d_textrev = jnp.asarray(esa.multiseq.sequence[::-1].copy())
        # dispatch by pattern-length class (ISLARGEPATTERN8,
        # dpbitvec48.h): <= 64 exact bit-vector scan, > 64 the
        # approximate Ukkonen cutoff (edistcompl.c:458-514)
        short_idx = np.flatnonzero(plens_np <= 64)
        long_idx = np.flatnonzero(plens_np > 64)
        hit_q: list[np.ndarray] = []
        hit_p: list[np.ndarray] = []
        for g0 in range(0, short_idx.size, Bc):
            grp = short_idx[g0:g0 + Bc]
            sm = int(plens_np[grp].max())
            sw = (sm + 31) // 32
            eqs_rev = np.zeros((grp.size, sw, 256), np.uint32)
            for bi, qi in enumerate(grp):
                rev = query[qi][::-1]
                for i, c in enumerate(rev):
                    if int(c) >= WILDCARD:     # GETEQSREV skip rule
                        continue
                    eqs_rev[bi, i // 32, int(c)] |= np.uint32(
                        1 << (i % 32))
            spl = plens_np[grp]
            scores = np.asarray(_semiglobal_myers(
                d_textrev, jnp.asarray(eqs_rev), jnp.asarray(spl),
                jnp.asarray((spl - 1) // 32),
                jnp.asarray(((spl - 1) % 32).astype(np.uint32)),
                sw, n))
            jrev, bi = np.nonzero(scores <= k)
            hit_q.append(grp[bi].astype(np.int64))
            hit_p.append((n - 1 - jrev).astype(np.int64))
        for g0 in range(0, long_idx.size, Bc):
            grp = long_idx[g0:g0 + Bc]
            M = int(plens_np[grp].max())
            patrev = np.full((grp.size, M + 2), -7, np.int32)
            for bi, qi in enumerate(grp):
                pl = plens_np[qi]
                patrev[bi, 1 : pl + 1] = query[qi][::-1].astype(
                    np.int32)
            emits = np.asarray(_ukkonen_cutoff_scan(
                d_textrev, jnp.asarray(patrev),
                jnp.asarray(plens_np[grp]), M, k))
            jrev, bi = np.nonzero(emits)
            hit_q.append(grp[bi].astype(np.int64))
            hit_p.append((n - 1 - jrev).astype(np.int64))
        qidx = (np.concatenate(hit_q) if hit_q
                else np.zeros(0, np.int64))
        pos = (np.concatenate(hit_p) if hit_p
               else np.zeros(0, np.int64))
        if pos.size == 0:
            return MatchTable()
        # measure each start with the shared longest-match kernel
        # (edistprocessstartpos, approxcompl.c:13-65); a pattern
        # WILDCARD never matches anything (GETEQS skip rule,
        # kurtz-basic/getEqs.gen; longestmatch.c:50 for long patterns)
        w = (maxplen + 31) // 32
        eqs_f = np.zeros((B, w, 256), np.uint32)
        for qi, p in enumerate(query):
            for i, c in enumerate(p):
                if int(c) >= WILDCARD:
                    continue
                eqs_f[qi, i // 32, int(c)] |= np.uint32(1 << (i % 32))
        _, bestlen, bestsc = _verify_edit(
            d_text, jnp.asarray(pos, dtype=jnp.int32),
            jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(eqs_f),
            jnp.asarray(plens_np), w, maxplen + k, n)
        # the reference emits every detected start, even when the
        # measured distance exceeds k (no DEBUG assert in release)
        lens = np.asarray(bestlen).astype(np.int64)
        dist = np.asarray(bestsc).astype(np.int64)
        order = np.lexsort((-pos, qidx))         # right-to-left scan

    qidx, pos, lens, dist = (qidx[order], pos[order], lens[order],
                             dist[order])
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
        seqnum2=qidx.copy(),
        relpos2=np.zeros(tot, np.int64),
        evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64),
    )
