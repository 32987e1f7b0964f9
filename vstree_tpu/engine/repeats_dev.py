"""Device path for maximal-repeat enumeration.

The host path in :mod:`vstree_tpu.engine.repeats` already reformulated
the reference's bottom-up traversal (src/Vmengine/vmatfind.c:240-541)
into flat array ops: lcp>=L run detection, triangular pair expansion,
RMQ depths, left-diversity on bwt, and the computed reference emission
key restored by one lexsort.  This module runs those same flat
programs on the device:

- run detection + compaction: two small dispatches over the lcp array,
- per chunk of expanded pairs (bounded T): ONE dispatch computing
  decode, diversity, RMQ depth, the event-time descent and the
  emission-key lexsort; the downloads are packed (rank_i, rank_j)
  words (5 bytes/pair when ranks fit 20 bits) plus int16 depths when
  maxbranchdepth allows, so fewer bytes cross to the host,
- chunks are dispatched ahead of their downloads, so device compute
  overlaps the transfer and the host-side record assembly.

Run ids are assigned by scatter+cummax (2 passes) instead of a batched
binary search (16 gathers); event times by the aligned-window
sparse-table descent (one gather per level) instead of a bracketed
binary search (two RMQ gathers per step).

The emission order semantics are documented at
engine/repeats.py:229-249 (matching vmatfind.c cartproduct1/2 +
vdfstrav.c pop cascades); this module reproduces them key for key and
is differentially tested against the numpy path
(tests/test_device_engines.py test_repeats_device_matches_host).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..index.esa import ESA

INT32_INF = np.int32(2**31 - 1)
_PAIR_CHUNK = 1 << 22


def _nice(x: int) -> int:
    if x <= 8:
        return max(1, x)
    e = max(0, x.bit_length() - 4)
    return ((x + (1 << e) - 1) >> e) << e


# ---------------------------------------------------------------------------
# RMQ sparse table on device
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n1", "levels"))
def _rmq_build(lcp, n1: int, levels: int):
    BIG = jnp.int32(2**30)
    tabs = [lcp]
    for k in range(1, levels):
        prev = tabs[-1]
        half = 1 << (k - 1)
        shifted = jnp.concatenate(
            [prev[half:], jnp.full(min(half, n1), BIG, jnp.int32)])
        tabs.append(jnp.minimum(prev, shifted))
    return jnp.stack(tabs)


def _rmq_query(table, log2tab, lo, hi, n1):
    """min lcp[lo..hi] inclusive (lo <= hi assumed valid)."""
    width = hi - lo + 1
    k = log2tab[jnp.clip(width, 1, n1)]
    a = table[k, jnp.clip(lo, 0, n1 - 1)]
    b = table[k, jnp.clip(hi - (1 << k) + 1, 0, n1 - 1)]
    return jnp.minimum(a, b)


# ---------------------------------------------------------------------------
# run detection
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n1", "L"))
def _runs_count(lcp, n1: int, L: int):
    ge = lcp >= L
    prev = jnp.concatenate([jnp.zeros(1, bool), ge[:-1]])
    return jnp.sum((ge & ~prev).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("n1", "L", "MR"))
def _runs_compact(lcp, n1: int, L: int, MR: int):
    """(left, right) rank intervals of maximal lcp>=L runs, compacted
    to the front of MR-sized arrays (padded with n1)."""
    ge = lcp >= L
    prev = jnp.concatenate([jnp.zeros(1, bool), ge[:-1]])
    nxt = jnp.concatenate([ge[1:], jnp.zeros(1, bool)])
    sflag = ge & ~prev
    eflag = ge & ~nxt
    pos = jnp.arange(n1, dtype=jnp.int32)
    sdst = jnp.where(sflag, jnp.cumsum(sflag.astype(jnp.int32)) - 1, MR)
    edst = jnp.where(eflag, jnp.cumsum(eflag.astype(jnp.int32)) - 1, MR)
    left = jnp.full(MR, n1, jnp.int32).at[sdst].set(pos - 1, mode="drop")
    right = jnp.full(MR, n1, jnp.int32).at[edst].set(pos, mode="drop")
    return left, right


# ---------------------------------------------------------------------------
# pair chunk: expand + diverse + depth + event time + emission sort
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("T", "R", "n1", "sigma"))
def _pairs_phase1(bwt, left, right, cum0,
                  T: int, R: int, n1: int, sigma: int):
    """Phase 1 of a pair chunk: triangular decode + left-diversity
    filter + compaction of the surviving (ri, rj) to the front.

    Only the diverse minority ever reaches phase 2, so the RMQ
    depths, event times and the emission sort run at the tight
    surviving width instead of the full expansion."""
    kk_run = jnp.where(left < n1, right - left + 1, 0)
    # run id per pair: scatter run starts at their first pair index,
    # then a running max (cum0 is ascending)
    rid = jnp.arange(R, dtype=jnp.int32)
    dst = jnp.where(cum0 < T, cum0, T)
    seed = jnp.zeros(T, jnp.int32).at[dst].max(rid, mode="drop")
    iv = lax.cummax(seed)
    tidx = jnp.arange(T, dtype=jnp.int32)
    pidx = tidx - cum0[iv]
    kk = kk_run[iv]
    valid = (left[iv] < n1) & (pidx >= 0) \
        & (pidx < (kk * (kk - 1)) // 2)
    # triangular decode: float32 estimate + exact int correction.
    # Safe ranges are guaranteed by the driver's per-run pair cap
    # (npairs/run <= _PAIR_CHUNK => kk <= 2897, pidc <= 2^22): all
    # int math fits int32 and the float32 estimate is off by <= 2,
    # within the 3-step correction.
    pidc = jnp.where(valid, pidx, 0)
    twok = (2 * kk - 1).astype(jnp.float32)
    s = jnp.floor(
        (twok - jnp.sqrt(jnp.maximum(
            twok * twok - 8.0 * pidc.astype(jnp.float32), 0.0)))
        / 2.0).astype(jnp.int32)
    s = jnp.clip(s, 0, jnp.maximum(kk - 2, 0))

    def before(x):
        return x * (2 * kk - x - 1) // 2

    for _ in range(3):
        s = jnp.where(before(s) > pidc, s - 1, s)
        s = jnp.where(before(s + 1) <= pidc, s + 1, s)
    s = jnp.clip(s, 0, jnp.maximum(kk - 2, 0))
    t_off = pidc - before(s) + s + 1
    ri = jnp.where(valid, left[iv] + s, 0)
    rj = jnp.where(valid, jnp.minimum(left[iv] + t_off, n1 - 1), 0)

    # left diversity (vmatfind.c ISLEFTDIVERSE): regular bwt chars by
    # value, specials/suffix-0 are position-unique
    bi = bwt[ri].astype(jnp.int32)
    bj = bwt[rj].astype(jnp.int32)
    keyi = jnp.where(bi < sigma, bi, 256 + ri)
    keyj = jnp.where(bj < sigma, bj, 256 + rj)
    diverse = valid & (keyi != keyj)
    cnt = jnp.sum(diverse.astype(jnp.int32))
    cdst = jnp.cumsum(diverse.astype(jnp.int32)) - 1
    cdst = jnp.where(diverse, cdst, T)
    ri_c = jnp.zeros(T, jnp.int32).at[cdst].set(ri, mode="drop")
    rj_c = jnp.zeros(T, jnp.int32).at[cdst].set(rj, mode="drop")
    return ri_c, rj_c, cnt


@functools.partial(
    jax.jit,
    static_argnames=("C", "n1", "steps", "sigma", "want_order",
                     "pack20", "d16"))
def _pairs_phase2(rmq, log2tab, bwt, ri, rj, cnt,
                  C: int, n1: int, steps: int, sigma: int,
                  want_order: bool, pack20: bool, d16: bool):
    """Phase 2 over the compacted diverse pairs: RMQ depth, event
    time by bounded aligned-window descent, emission-key lexsort,
    packed output."""
    live = jnp.arange(C, dtype=jnp.int32) < cnt
    d = _rmq_query(rmq, log2tab, ri + 1, rj, n1)
    d = jnp.where(live, d, 0)

    def pack(ra, rb):
        if pack20:
            w1 = ra | ((rb & 0xFFF) << 20)
            w2 = (lax.shift_right_logical(rb, 12)).astype(jnp.int8)
            return w1, w2
        return ra, rb

    def dpack(dv):
        return dv.astype(jnp.int16) if d16 else dv

    if not want_order:
        w1, w2 = pack(ri, rj)
        return w1, w2, dpack(d)

    # event time: first r >= rj with lcp[r+1] <= d — aligned-window
    # sparse-table descent, ONE gather per level; ``steps`` is bounded
    # by log2(max run width) since events never leave the pair's own
    # lcp>=L run (lcp[run_end+1] < L <= d)
    t_ev = rj
    for e in range(steps - 1, -1, -1):
        probe = rmq[e, jnp.clip(t_ev + 1, 0, n1 - 1)]
        t_ev = jnp.where((probe > d) & (t_ev + (1 << e) < n1),
                         t_ev + (1 << e), t_ev)

    bi = bwt[ri].astype(jnp.int32)
    bj = bwt[rj].astype(jnp.int32)
    keyi = jnp.where(bi < sigma, bi, 256 + ri)
    keyj = jnp.where(bj < sigma, bj, 256 + rj)
    # emission key (engine/repeats.py:229-249): class = bwt char for
    # regular left context, sigma for the unique list; son-unique
    # pairs swap (vmatfind.c:282-290)
    clsi = jnp.minimum(keyi, sigma)
    clsj = jnp.minimum(keyj, sigma)
    F = clsi
    Sc = clsj
    swap = (F < sigma) & (Sc == sigma)
    X = jnp.where(swap, rj, ri)
    Y = jnp.where(swap, ri, rj)
    A = jnp.where(F == sigma, X, Sc)
    Bk = jnp.where(F == sigma, Sc, X)
    t_key = jnp.where(live, t_ev, INT32_INF)
    negd = jnp.int32(2**30) - d
    order = jnp.lexsort((Y, Bk, A, F, negd, t_key))
    w1, w2 = pack(ri[order], rj[order])
    return w1, w2, dpack(d[order])


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("C", "n1", "steps", "sigma"))
def _emission_order(rmq, bwt, ri, rj, d, C: int, n1: int,
                    steps: int, sigma: int):
    """Reference emission-order permutation of C (ri, rj, d) pairs
    (the _pairs_phase2 key logic, applied post-hoc to a small
    survivor subset instead of the full enumeration)."""
    t_ev = rj
    for e in range(steps - 1, -1, -1):
        probe = rmq[e, jnp.clip(t_ev + 1, 0, n1 - 1)]
        t_ev = jnp.where((probe > d) & (t_ev + (1 << e) < n1),
                         t_ev + (1 << e), t_ev)
    bi = bwt[ri].astype(jnp.int32)
    bj = bwt[rj].astype(jnp.int32)
    keyi = jnp.where(bi < sigma, bi, 256 + ri)
    keyj = jnp.where(bj < sigma, bj, 256 + rj)
    clsi = jnp.minimum(keyi, sigma)
    clsj = jnp.minimum(keyj, sigma)
    F = clsi
    Sc = clsj
    swap = (F < sigma) & (Sc == sigma)
    X = jnp.where(swap, rj, ri)
    Y = jnp.where(swap, ri, rj)
    A = jnp.where(F == sigma, X, Sc)
    Bk = jnp.where(F == sigma, Sc, X)
    negd = jnp.int32(2**30) - d
    return jnp.lexsort((Y, Bk, A, F, negd, t_ev))


def maximal_pairs_device_seeds(esa: ESA, searchlength: int):
    """Unordered fused-seed variant: (pos_min, pos_max, depth, ri, rj)
    DEVICE arrays without the full-width emission sort — the caller
    restores reference order on its (small) survivor subset via
    :func:`_emission_order`.  Distinct pairs always have distinct
    emission keys, and event times are globally comparable, so
    sorting any subset post-hoc reproduces the enumeration order.
    Returns None on the pathological-run guard."""
    got = maximal_pairs_device(esa, searchlength, ref_order=False,
                               device_out=True)
    if got is None:
        return None
    d_parts, i_parts, j_parts = got
    if not i_parts:
        return (jnp.zeros(0, jnp.int32),) * 5, 0
    ri = jnp.concatenate(i_parts)
    rj = jnp.concatenate(j_parts)
    dd = jnp.concatenate(d_parts)
    suftab = esa.device("suftab")
    p1 = suftab[ri]
    p2 = suftab[rj]
    return ((jnp.minimum(p1, p2), jnp.maximum(p1, p2), dd, ri, rj),
            int(ri.shape[0]))


def maximal_pairs_device_positions(esa: ESA, searchlength: int):
    """Fused-seed variant: all maximal pairs in reference emission
    order as DEVICE arrays (pos_min, pos_max, depth) — int32, tight
    width — plus the host count.  Nothing but two chunk-count scalars
    crosses the link, so a downstream device consumer (the greedy
    extension prefilter) avoids the multi-MB pair download entirely.
    Returns None when the pathological-run guard fires (host path
    applies)."""
    import jax.numpy as jnp

    got = maximal_pairs_device(esa, searchlength, ref_order=True,
                               device_out=True)
    if got is None:
        return None
    d_parts, i_parts, j_parts = got
    if not i_parts:
        return (jnp.zeros(0, jnp.int32),) * 3, 0
    ri = jnp.concatenate(i_parts)
    rj = jnp.concatenate(j_parts)
    dd = jnp.concatenate(d_parts)
    suftab = esa.device("suftab")
    p1 = suftab[ri]
    p2 = suftab[rj]
    return ((jnp.minimum(p1, p2), jnp.maximum(p1, p2), dd),
            int(ri.shape[0]))


def maximal_pairs_device(esa: ESA, searchlength: int,
                         ref_order: bool = True,
                         device_out: bool = False):
    """(d, rank_i, rank_j) of all maximal pairs, reference emission
    order (or unordered when ref_order=False), computed on device.
    Returns host int64 arrays; with ``device_out`` returns the
    per-chunk DEVICE column lists unpacked (or None on the
    pathological-run host-fallback guard)."""
    L = max(searchlength, 1)
    lcp_h = esa.lcptab
    n1 = int(lcp_h.size)
    lcp = jnp.asarray(lcp_h.astype(np.int32))
    R_cnt = int(_runs_count(lcp, n1, L))
    z = np.zeros(0, np.int64)
    empty = ([], [], []) if device_out else (z, z, z)
    if R_cnt == 0:
        return empty
    MR = _nice(R_cnt)
    left_d, right_d = _runs_compact(lcp, n1, L, MR)
    left = np.asarray(left_d)[:R_cnt].astype(np.int64)
    right = np.asarray(right_d)[:R_cnt].astype(np.int64)
    m = right - left + 1
    npairs = (m * (m - 1)) // 2
    total = int(npairs.sum())
    if total == 0:
        return empty

    if int(npairs.max()) > _PAIR_CHUNK:
        # a single run expanding past the chunk budget would overflow
        # the int32 decode ranges (and the chunk buffers) — such
        # pathological runs (> ~2900 equal suffixes at depth >= L)
        # take the exact host path instead
        if device_out:
            return None
        from .repeats import maximal_pairs_ref_order_vec

        return maximal_pairs_ref_order_vec(esa, searchlength)

    levels = max(1, int(math.floor(math.log2(max(n1, 2)))) + 1)
    rmq = _rmq_build(lcp, n1, levels)
    log2tab = jnp.asarray(
        np.floor(np.log2(np.maximum(np.arange(n1 + 2), 1))), jnp.int32)
    bwt = jnp.asarray(esa.bwttab)
    sigma = esa.alpha.num_regular
    maxw = int(m.max())
    steps = min(levels,
                max(1, int(np.ceil(np.log2(max(maxw + 1, 2)))) + 1))
    pack20 = n1 <= (1 << 20) and not device_out
    d16 = ((esa.maxbranchdepth or (1 << 30)) < (1 << 15)
           if esa.maxbranchdepth is not None else False) \
        and not device_out

    # chunk on run boundaries, bounded expanded pair count
    cum = np.cumsum(npairs)
    bounds = [0]
    last = 0
    for i in range(left.size):
        if cum[i] - last > _PAIR_CHUNK and i > bounds[-1]:
            bounds.append(i)
            last = cum[i - 1]
    bounds.append(left.size)

    # phase 1 for every chunk up front (async), then ONE batched sync
    # of the surviving counts, then phase 2 at tight widths
    p1 = []  # phase-1 chunk outputs
    for ci in range(len(bounds) - 1):
        a, b = bounds[ci], bounds[ci + 1]
        if a >= b:
            continue
        lch = left[a:b]
        rch = right[a:b]
        nch = npairs[a:b]
        cum0 = np.concatenate([[0], np.cumsum(nch)[:-1]])
        Tc = int(nch.sum())
        if Tc == 0:
            continue
        T = _nice(Tc)
        R = _nice(lch.size)
        lpad = np.full(R, n1, np.int32)
        lpad[:lch.size] = lch
        rpad = np.full(R, n1, np.int32)
        rpad[:rch.size] = rch
        cpad = np.full(R, INT32_INF, np.int32)
        cpad[:cum0.size] = cum0
        ri_c, rj_c, cnt = _pairs_phase1(
            bwt, jnp.asarray(lpad), jnp.asarray(rpad),
            jnp.asarray(cpad), T, R, n1, sigma)
        p1.append((ri_c, rj_c, cnt))
    if not p1:
        return empty
    cnts = np.asarray(jnp.stack([c for _, _, c in p1]))

    pend = []
    for (ri_c, rj_c, cnt), cnt_i in zip(p1, cnts):
        cnt_i = int(cnt_i)
        if cnt_i == 0:
            continue
        C = _nice(cnt_i)
        out = _pairs_phase2(
            rmq, log2tab, bwt, ri_c[:C], rj_c[:C], cnt,
            C, n1, steps, sigma, ref_order, pack20, d16)
        pend.append((out, cnt_i))

    if device_out:
        d_parts = [dcol[:cnt] for (w1, w2, dcol), cnt in pend]
        i_parts = [w1[:cnt] for (w1, w2, dcol), cnt in pend]
        j_parts = [w2[:cnt] for (w1, w2, dcol), cnt in pend]
        return d_parts, i_parts, j_parts

    out_d, out_i, out_j = [], [], []
    for (w1, w2, dcol), cnt in pend:
        w1h = np.asarray(w1[:cnt])
        w2h = np.asarray(w2[:cnt])
        dh = np.asarray(dcol[:cnt])
        if pack20:
            u1 = w1h.view(np.uint32)
            ri = (u1 & 0xFFFFF).astype(np.int64)
            rj = ((u1 >> 20).astype(np.int64)
                  | ((w2h.astype(np.int64) & 0xFF) << 12))
        else:
            ri = w1h.astype(np.int64)
            rj = w2h.astype(np.int64)
        out_d.append(dh.astype(np.int64))
        out_i.append(ri)
        out_j.append(rj)
    if not out_i:
        return z, z, z
    return (np.concatenate(out_d), np.concatenate(out_i),
            np.concatenate(out_j))
