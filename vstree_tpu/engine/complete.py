"""Complete-match search: the whole query sequence must match.

Exact variant of the reference's ``-complete`` task
(reference src/Vmengine/exactcompl.c:64-230 ``findsufboundaries`` /
``computeofflineexactmatches``; dispatch fcomplete.c:263).

Batched design: instead of the reference's per-pattern pointer
descent, ALL query patterns are located simultaneously by a batched
binary search over the suffix array — each step gathers one text
window per query and refines a (lo, hi) bracket; ~log2(n) synchronized
steps for the whole batch, entirely on device (SURVEY.md §7:
"batched binary search of all query k-mer codes into bck, then batched
interval refinement").  The bucket table provides the starting
brackets, exactly like the reference's ``vnode.left/right`` from
``bcktab`` (exactcompl.c:183-192; only the fully-regular [left, mid)
part can contain a whole-pattern match).

Patterns shorter than the index prefixlength are a hard error, as in
the reference (exactcompl.c:179-184); patterns containing wildcards
never match (wildcards are position-unique in the sort).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import WILDCARD
from ..core.route import note
from ..index.esa import ESA
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable

# Numeric compare key for special suffix chars and the past-end
# sentinel: above every regular char, ordered by text position
# (chardef position rule / Appendix A.1 of SURVEY.md).
_SPECIAL = 1 << 20


@functools.partial(
    jax.jit, static_argnames=("maxplen", "n", "nsteps", "start_depth")
)
def _interval_search(
    text: jax.Array,       # uint8[n]
    suftab: jax.Array,     # int64/int32[n+1]
    patterns: jax.Array,   # int32[B, maxplen], -1-padded
    plens: jax.Array,      # int32[B]
    lo0: jax.Array,        # int32[B] start bracket (from bck)
    hi0: jax.Array,        # int32[B] end bracket, exclusive
    maxplen: int,
    n: int,
    nsteps: int | None = None,
    start_depth: int = 0,
):
    """For each pattern, the rank interval [lo, hi) of suffixes whose
    prefix equals the pattern.  Batched binary search.

    ``start_depth``: chars known equal for every suffix inside the
    initial brackets (bucket prefix depth) — skipped in comparisons.
    """

    offs = jnp.arange(start_depth, maxplen, dtype=jnp.int32)

    def cmp_le(mid, pat, plen, strict):
        """True iff suffix[suftab[mid]] <= pattern...
        Specifically returns whether we should move the bracket:
        computes lexicographic relation of suffix-prefix vs pattern."""
        s = suftab[mid].astype(jnp.int32)
        idx = s[:, None] + offs[None, :]
        inb = idx < n
        ch = text[jnp.minimum(idx, n - 1)].astype(jnp.int32)
        # past-end == the sentinel: greater than every regular symbol
        # and ordered by position, like other specials (matches the
        # suffix-sort order; reference: sentinel > all, Appendix A.1)
        skey = jnp.where(inb & (ch < WILDCARD), ch, _SPECIAL + idx)
        pkey = pat[:, start_depth:]  # -1 padding: "pattern ended"
        active = offs[None, :] < plen[:, None]
        diff = jnp.where(active, skey - pkey, 0)
        # first nonzero diff within the pattern
        nz = diff != 0
        first = jnp.argmax(nz, axis=1)
        anynz = jnp.any(nz, axis=1)
        d = jnp.take_along_axis(diff, first[:, None], axis=1)[:, 0]
        rel = jnp.where(anynz, jnp.sign(d), 0)  # -1: suffix < pat
        return rel

    if nsteps is None:
        nsteps = max(1, int(np.ceil(np.log2(max(n + 1, 2)))) + 1)

    def body(_, state):
        lo, hi = state
        open_ = lo < hi
        # lower bound: first rank with suffix-prefix >= pattern
        mid = (lo + hi) // 2
        rel = cmp_le(mid, patterns, plens, False)
        lo = jnp.where(open_ & (rel < 0), mid + 1, lo)
        hi = jnp.where(open_ & (rel >= 0), mid, hi)
        return lo, hi

    lo, _ = lax.fori_loop(0, nsteps, body, (lo0, hi0))

    def body2(_, state):
        lo2, hi2 = state
        open_ = lo2 < hi2
        # upper bound: first rank with suffix-prefix > pattern
        mid = (lo2 + hi2) // 2
        rel = cmp_le(mid, patterns, plens, True)
        lo2 = jnp.where(open_ & (rel <= 0), mid + 1, lo2)
        hi2 = jnp.where(open_ & (rel > 0), mid, hi2)
        return lo2, hi2

    lo2, _ = lax.fori_loop(0, nsteps, body2, (lo0, hi0))
    return lo, lo2


@functools.partial(
    jax.jit,
    static_argnames=("ppl", "levels", "bits", "numofchars", "nsteps",
                     "maxplen"),
)
def _device_exact_lookup(
    keys: jax.Array,       # int32[levels, R] packed rank keys
    bck: jax.Array,        # uint32[2 * numofchars**ppl]
    patterns: jax.Array,   # int32[B, maxplen], -1 padded
    plens: jax.Array,      # int32[B]
    ppl: int,
    levels: int,
    bits: int,
    numofchars: int,
    nsteps: int,
    maxplen: int,
):
    """Whole exact-lookup pipeline on device: bucket code, bracket,
    query-key packing, and the packed-key binary searches — a single
    dispatch with no host-side per-batch work.  ``patterns`` may be a
    narrow integer dtype (int8/int16) to minimise host->device
    transfer; -1 padding, -2 never-matches."""
    patterns = patterns.astype(jnp.int32)
    B = patterns.shape[0]
    # bucket code over the first ppl chars (σ^ppl <= 2^24 by
    # construction, so int32 is sufficient)
    code = jnp.zeros(B, jnp.int32)
    okc = jnp.ones(B, bool)
    for j in range(ppl):
        c = patterns[:, j]
        okc = okc & (c >= 0) & (c < numofchars)
        code = code * numofchars + jnp.maximum(c, 0)
    code = jnp.where(okc, code, 0)
    lo0 = jnp.where(okc, bck[2 * code].astype(jnp.int32), 0)
    hi0 = jnp.where(okc, bck[2 * code + 1].astype(jnp.int32), 0)

    # pack query keys
    cpk = 30 // bits
    maxcode = (1 << bits) - 1
    W = levels * cpk
    offs = ppl + jnp.arange(W, dtype=jnp.int32)
    ch = patterns[:, jnp.minimum(offs, maxplen - 1)]
    active = offs[None, :] < plens[:, None]
    regular = (ch >= 0) & (ch < WILDCARD)
    ok = ~jnp.any(active & ~regular, axis=1)
    lo0 = jnp.where(ok, lo0, 0)
    hi0 = jnp.where(ok, hi0, 0)
    cl = jnp.where(active, ch + 1, 0)
    chi = jnp.where(active, ch + 1, maxcode)
    qlow = []
    qhigh = []
    for lv in range(levels):
        kl = jnp.zeros(B, jnp.int32)
        kh = jnp.zeros(B, jnp.int32)
        for j in range(cpk):
            kl = (kl << bits) | cl[:, lv * cpk + j]
            kh = (kh << bits) | chi[:, lv * cpk + j]
        qlow.append(kl)
        qhigh.append(kh)
    qlow = jnp.stack(qlow, axis=1)
    qhigh = jnp.stack(qhigh, axis=1)

    def ge(mid, Q, strict):
        gt = jnp.zeros(B, bool)
        eq = jnp.ones(B, bool)
        for lv in range(levels):
            k = keys[lv, mid]
            q = Q[:, lv]
            gt = gt | (eq & (k > q))
            eq = eq & (k == q)
        return gt if strict else (gt | eq)

    def lower(_, st):
        lo, hi = st
        open_ = lo < hi
        mid = (lo + hi) // 2
        g = ge(mid, qlow, False)
        lo = jnp.where(open_ & ~g, mid + 1, lo)
        hi = jnp.where(open_ & g, mid, hi)
        return lo, hi

    def upper(_, st):
        lo, hi = st
        open_ = lo < hi
        mid = (lo + hi) // 2
        g = ge(mid, qhigh, True)
        lo = jnp.where(open_ & ~g, mid + 1, lo)
        hi = jnp.where(open_ & g, mid, hi)
        return lo, hi

    lo, _ = lax.fori_loop(0, nsteps, lower, (lo0, hi0))
    ub, _ = lax.fori_loop(0, nsteps, upper, (lo0, hi0))
    return lo, ub


def pattern_codes(
    patterns: np.ndarray, plens: np.ndarray, numofchars: int, pl: int
) -> np.ndarray:
    """Prefix code of each pattern's first ``pl`` chars (qgram2code);
    -1 if the prefix contains a wildcard/padding."""
    B = patterns.shape[0]
    code = np.zeros(B, np.int64)
    ok = plens >= pl
    for j in range(pl):
        c = patterns[:, j]
        ok &= (c >= 0) & (c < numofchars)
        code = code * numofchars + np.maximum(c, 0)
    return np.where(ok, code, -1)


MAX_KEY_LEVELS = 6

# marker for wildcard pattern chars in the narrow int8 upload format
# (any value >= sigma flags the position; patterns with wildcards never
# match, exactcompl.c semantics)
_WILDMARK = 120


@functools.partial(jax.jit, static_argnames=("ppl", "cpw", "sigma", "W"))
def _device_rank_lookup(flat8, bck, t1, t2, ppl: int, cpw: int,
                        sigma: int, W: int):
    """Whole exact-match interval lookup on device — one upload, one
    dispatch, no host work per batch: bucket code of the first ``ppl``
    chars, LOW (pad digit 0) / HIGH (pad digit sigma) base-(sigma+1)
    two-word keys of the chars after it, the bucket bracket gather, and
    one contiguous window of ``W >= width`` ranks per query, compared
    and counted in one fused pass.  ``flat8`` is laid out char-major
    (ppl + 2*cpw + 1 rows of B, the last row the pattern lengths) so
    each per-char extraction is a contiguous row."""
    cov = ppl + 2 * cpw
    p = flat8.reshape(cov + 1, -1).astype(jnp.int32)
    B = p.shape[1]
    plen = p[cov]
    base = sigma + 1
    numofcodes = sigma ** ppl

    code = jnp.zeros(B, jnp.int32)
    valid = jnp.ones(B, bool)
    for j in range(ppl):
        c = p[j]
        valid &= (c >= 0) & (c < sigma)
        code = code * sigma + jnp.maximum(c, 0)

    q1l = jnp.zeros(B, jnp.int32)
    q2l = jnp.zeros(B, jnp.int32)
    q1h = jnp.zeros(B, jnp.int32)
    q2h = jnp.zeros(B, jnp.int32)
    for j in range(2 * cpw):
        c = p[ppl + j]
        act = (ppl + j) < plen
        valid &= ~(act & ((c < 0) | (c >= sigma)))
        cc = jnp.clip(c, 0, sigma - 1)
        dl = jnp.where(act, cc, 0)
        dh = jnp.where(act, cc, sigma)
        if j < cpw:
            q1l = q1l * base + dl
            q1h = q1h * base + dh
        else:
            q2l = q2l * base + dl
            q2h = q2h * base + dh

    # invalid queries (wildcards / padding rows) hit the zero-width
    # sentinel bucket appended at code == numofcodes
    code = jnp.where(valid, code, numofcodes)
    left = bck[0, code]
    width = bck[1, code]
    k = jnp.arange(W, dtype=jnp.int32)[None, :]
    j = jnp.minimum(left[:, None] + k, t1.size - 1)
    w1 = t1[j]
    w2 = t2[j]
    inwin = k < width[:, None]
    wless = ((w1 < q1l[:, None])
             | ((w1 == q1l[:, None]) & (w2 < q2l[:, None])))
    wleq = ((w1 < q1h[:, None])
            | ((w1 == q1h[:, None]) & (w2 <= q2h[:, None])))
    lo = left + jnp.sum(inwin & wless, axis=1, dtype=jnp.int32)
    hi = left + jnp.sum(inwin & wleq, axis=1, dtype=jnp.int32)
    return lo, hi


# Byte budget of the deep bucket table (left and width per code):
# deeper buckets shrink every query's window.
_BCK_TABLE_BUDGET = 64 << 20

# Widest bucket the window count accepts; an index with a wider
# bucket (low-complexity repeats) takes the binary-search path.
_MAX_WINDOW = 1024

_BATCH_QUANTUM = 1024


class RankLookupPlan:
    """Precomputed static parameters + device tables for the fast
    exact-lookup path on one ESA.  Build once, run many batches."""

    def __init__(self, esa: ESA, min_plen: int, max_plen: int):
        import math

        self.esa = esa
        sigma = esa.alpha.num_regular
        self.sigma = sigma
        self.cpw = esa.chars_per_word()
        n = esa.totallength
        deep = int(math.log(_BCK_TABLE_BUDGET / 8) / math.log(sigma))
        self.ppl = max(1, min(deep, int(min_plen)))
        self.coverage = self.ppl + 2 * self.cpw
        self.ok = (
            max_plen <= self.coverage
            and sigma < _WILDMARK
            and n >= 1
        )
        if not self.ok:
            return
        maxw = esa.aux_bck_maxwidth(self.ppl)
        if maxw > _MAX_WINDOW:
            self.ok = False
            return
        # power-of-two window: indexes of similar size share a program
        self.W = 1 << max(0, (max(maxw, 1) - 1).bit_length())
        self.bck = self._bucket_table()
        self.t1, self.t2 = esa.rank_words(self.ppl)

    def _bucket_table(self):
        """int32[2, numofcodes + 1]: bucket left borders (row 0) and
        widths (row 1); a zero-width sentinel entry at code ==
        numofcodes catches invalid queries.  Cached on the ESA."""
        key = ("rank_bck", self.ppl)
        cache = self.esa._device_cache
        if key not in cache:
            raw = self.esa.aux_bck(self.ppl)
            left = raw[0::2].astype(np.int32)
            width = (raw[1::2].astype(np.int64) - left).astype(np.int32)
            cache[key] = jnp.asarray(np.stack([
                np.append(left, 0), np.append(width, 0)]))
        return cache[key]

    def pack(self, patterns: np.ndarray, plens: np.ndarray):
        """Host-side narrow packing into ONE flat int8 upload buffer,
        char-major: (coverage+1, Bp) — rows 0..coverage-1 hold pattern
        char j for every query (-1 pad, wildcards -> _WILDMARK), the
        last row the pattern lengths."""
        B, maxplen = patterns.shape
        if plens.max(initial=0) > 127:
            raise ValueError("fast path requires plen <= 127")
        # batch padded to a multiple of _BATCH_QUANTUM (fewer compiled
        # variants); padding rows have length 0 and hit the sentinel
        Bp = -(-B // _BATCH_QUANTUM) * _BATCH_QUANTUM
        out = np.full((self.coverage + 1, Bp), -1, np.int8)
        w = min(maxplen, self.coverage)
        src = patterns[:, :w]
        narrow = np.where(
            (src >= 0) & (src < self.sigma), src, -1
        ).astype(np.int8)
        narrow = np.where(src >= self.sigma, np.int8(_WILDMARK), narrow)
        out[:w, :B] = narrow.T
        out[self.coverage] = 0
        out[self.coverage, :B] = plens.astype(np.int8)
        return out.reshape(-1)

    def run(self, flat8):
        """Dispatch the device lookup; returns device (lo, hi)."""
        return _device_rank_lookup(
            jnp.asarray(flat8), self.bck, self.t1, self.t2,
            self.ppl, self.cpw, self.sigma, self.W)


def exact_interval_lookup(
    esa: ESA, patterns: np.ndarray, plens: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Rank interval [lo, hi) of every whole pattern.

    Fast path: deep bucket bracket + base-(σ+1) two-word keys + one
    fused window count (:func:`_device_rank_lookup`) — O(1) probes per
    query.
    Falls back to the packed-key batched binary search for patterns
    longer than the two-word coverage, then to direct text comparison.
    """
    import math

    B, maxplen = patterns.shape
    if B > 0 and esa.totallength > 0 and plens.max(initial=0) <= 127:
        plan = RankLookupPlan(esa, int(plens.min()), maxplen)
        if plan.ok:
            note("exact lookup", "device")
            lo, hi = plan.run(plan.pack(patterns, plens))
            return np.asarray(lo)[:B], np.asarray(hi)[:B]
    note("exact lookup", "binary search")
    n = esa.totallength
    pl = esa.prefixlength
    numofchars = esa.alpha.num_regular

    # deepest affordable bucket depth: buckets of ~1 suffix kill almost
    # the whole binary search (and comparisons skip the bucket prefix)
    budget = 1 << 24
    deep = int(math.log(budget) / math.log(numofchars))
    ppl = max(1, min(deep, int(plens.min())))

    # bucket brackets are narrow: ~log2(max bucket width) probe steps
    # suffice (vs log2(n) from scratch)
    bck = esa.aux_bck(ppl)
    maxbucket = esa.aux_bck_maxwidth(ppl)
    nsteps = max(2, int(np.ceil(np.log2(max(maxbucket, 2)))) + 1)
    nsteps = min(nsteps,
                 max(1, int(np.ceil(np.log2(max(n + 1, 2)))) + 1))

    bits = esa.key_bits()
    cpk = 30 // bits
    levels = max(1, int(np.ceil((maxplen - ppl) / cpk)))
    if levels <= MAX_KEY_LEVELS:
        # pad the pattern matrix to the key coverage so distinct
        # maxplen values share one compiled kernel per level count;
        # ship the narrowest dtype that holds the codes (transfer is
        # the per-batch cost on remote devices)
        narrow = (np.int8 if numofchars < 126 else
                  np.int16 if numofchars < 32766 else np.int32)
        padto = ppl + levels * cpk
        if maxplen < padto:
            pad = np.full((B, padto - maxplen), -1, narrow)
            patterns = np.concatenate(
                [patterns.astype(narrow), pad], axis=1)
            maxplen = padto
        patterns = patterns.astype(narrow)

        def run_group(pat_rows, plen_rows, steps):
            return _device_exact_lookup(
                esa.rank_keys(ppl, levels),
                esa.aux_bck_device(ppl),
                jnp.asarray(pat_rows),
                jnp.asarray(plen_rows),
                ppl, levels, bits, numofchars, steps, maxplen,
            )

        if B >= 4096 and nsteps > 6:
            # one cheap host pass over the batch tightens the step
            # count to the widest bucket actually queried (usually
            # far below the global maximum)
            codes = pattern_codes(patterns.astype(np.int32), plens,
                                  numofchars, ppl)
            vc = np.maximum(codes, 0)
            wid = np.where(
                codes >= 0,
                bck[2 * vc + 1].astype(np.int64)
                - bck[2 * vc].astype(np.int64),
                0,
            )
            maxw = int(wid.max()) if wid.size else 2
            bsteps = max(2, int(np.ceil(np.log2(max(maxw, 2)))) + 1)
            # quantize to limit compile variants
            bsteps = min(nsteps, bsteps + (-bsteps) % 3)
            nsteps = bsteps

        lo, hi = run_group(patterns, plens, nsteps)
    else:
        codes = pattern_codes(patterns, plens, numofchars, ppl)
        lo0 = np.zeros(B, np.int32)
        hi0 = np.zeros(B, np.int32)
        valid = codes >= 0
        vcodes = np.maximum(codes, 0)
        lo0[valid] = bck[2 * vcodes[valid]].astype(np.int32)
        hi0[valid] = bck[2 * vcodes[valid] + 1].astype(np.int32)
        lo, hi = _interval_search(
            esa.device("text"),
            esa.device("suftab"),
            jnp.asarray(patterns),
            jnp.asarray(plens),
            jnp.asarray(lo0),
            jnp.asarray(hi0),
            maxplen,
            n,
            nsteps,
            ppl,
        )
    return np.asarray(lo), np.asarray(hi)


def exact_complete_matches(
    esa: ESA,
    query: "np.ndarray | list[np.ndarray]",
    query_seqnums: np.ndarray | None = None,
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
    mesh=None,
) -> MatchTable:
    """All exact whole-pattern occurrences for a batch of patterns.

    ``query``: list of encoded patterns (uint8 arrays).  Returns
    matches ordered (query, rank) to mirror the reference's emission
    order (exactcompl.c:156-164 inside the per-query loop).
    """
    pats = query if isinstance(query, list) else [query]
    B = len(pats)
    if B == 0:
        return MatchTable()
    pl = esa.prefixlength
    plens = np.array([p.size for p in pats], np.int32)
    if (plens < pl).any():
        bad = int(plens.min())
        raise ValueError(
            f"patternlength={bad} must be >= {pl}=prefixlen"
        )
    maxplen = int(plens.max())
    patterns = np.full((B, maxplen), -1, np.int32)
    for i, p in enumerate(pats):
        # wildcards can never match: keep their code (>= WILDCARD) so
        # comparisons always differ
        patterns[i, : p.size] = p.astype(np.int32)

    if mesh is not None:
        from ..parallel.shardesa import exact_interval_lookup_sharded

        lo, hi = exact_interval_lookup_sharded(esa, patterns, plens, mesh)
    else:
        lo, hi = exact_interval_lookup(esa, patterns, plens)
    counts = np.maximum(hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        return MatchTable()

    # expand intervals -> (query i, rank r) pairs, rank ascending
    qidx = np.repeat(np.arange(B), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = (np.arange(total) - starts[qidx]) + lo[qidx]
    positions = esa.suftab[ranks].astype(np.int64)

    ms = esa.multiseq
    seq1, rel1 = ms.pos_to_pair(positions)
    lens = plens[qidx].astype(np.int64)
    if query_seqnums is None:
        query_seqnums = np.arange(B, dtype=np.int64)
    if query_starts is None:
        query_starts = np.zeros(B, np.int64)
    return MatchTable(
        length1=lens,
        position1=positions,
        length2=lens,
        position2=query_starts[qidx].astype(np.int64),
        distance=np.zeros(total, np.int64),
        flag=np.full(total, FLAGQUERY | FLAGCOMPLETEMATCH | flags_extra,
                     np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=query_seqnums[qidx].astype(np.int64),
        relpos2=np.zeros(total, np.int64),
        evalue=np.zeros(total, np.float64),
        idnumber=np.zeros(total, np.int64),
        transnum=np.full(total, -1, np.int64),
    )
