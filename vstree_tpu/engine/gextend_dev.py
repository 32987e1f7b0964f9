"""Device path for the greedy edit-extension fronts.

Port of engine/gextend.py:edit_fronts (itself the batched
reformulation of the reference's per-seed greedy Ukkonen fronts,
src/kurtz/front.gen + frontSEP.c + extendED.c:78-200):

- the [S, maxdist+1, 2*maxdist+1] front tensor advances
  level-synchronously as jit programs,
- the diagonal slides run through the compacted packed-word LCE ladder
  of index/sort.py (two-text variant; backward slides use the reversed
  texts' tables), so deep exact runs cost their own tail instead of
  quadratic window scans,
- the extendED.c:141-200 viability prefilter (max left + max right
  extension >= remaining length) is evaluated on device so only the
  few-percent surviving seeds' fronts are ever downloaded.

The (dist, l, r, diag, diag) combination stays on the host path in
gextend.py — after the prefilter it touches thousands, not hundreds of
thousands, of seeds.  Semantics are mirrored statement-for-statement
from the host edit_fronts (r-masking, separator bounds, the
same-pointer self-overlap shortcut, foundseed early stop); the
CPU-backend tests assert bit-equal results.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import SEPARATOR, WILDCARD
from ..index.sort import _lce_tables, device_lce_pairs, lce_pack_params

NEG32 = jnp.int32(-(1 << 30))


@functools.partial(jax.jit, static_argnames=("n",))
def _prevsep_table(seq, n: int):
    pos = jnp.arange(n, dtype=jnp.int32)
    return lax.cummax(jnp.where(seq == SEPARATOR, pos, -1))


@functools.partial(jax.jit, static_argnames=("n",))
def _nextsep_table(seq, n: int):
    pos = jnp.arange(n, dtype=jnp.int32)
    v = jnp.where(seq == SEPARATOR, pos, 2 * n)
    return lax.cummin(v[::-1])[::-1]


def _dev_tables(sq):
    """Separator-distance and packed-word tables for both texts and
    their reversals, cached on the Seqs object."""
    cache = getattr(sq, "_dev_tabs", None)
    if cache is None:
        n1, n2 = sq.n1, sq.n2
        regmax = int(sq.s1[sq.s1 < WILDCARD].max(initial=1))
        if sq.s2 is not sq.s1:
            regmax = max(regmax,
                         int(sq.s2[sq.s2 < WILDCARD].max(initial=1)))
        sigma = regmax + 1
        bits, D = lce_pack_params(sigma)
        p1 = _prevsep_table(sq.d_s1, n1)
        x1 = _nextsep_table(sq.d_s1, n1)
        Pf1 = _lce_tables(sq.d_s1, n1, bits, D)
        Pb1 = _lce_tables(sq.d_r1, n1, bits, D)
        if sq.s2 is sq.s1:
            p2, x2, Pf2, Pb2 = p1, x1, Pf1, Pb1
        else:
            p2 = _prevsep_table(sq.d_s2, n2)
            x2 = _nextsep_table(sq.d_s2, n2)
            Pf2 = _lce_tables(sq.d_s2, n2, bits, D)
            Pb2 = _lce_tables(sq.d_r2, n2, bits, D)
        cache = dict(sigma=sigma, p1=p1, x1=x1, p2=p2, x2=x2,
                     Pf1=Pf1, Pb1=Pb1, Pf2=Pf2, Pb2=Pb2)
        sq._dev_tabs = cache
    return cache


def _sep_left(prevsep, start, n):
    p = jnp.clip(start - 1, -1, n - 1)
    ps = jnp.where(p >= 0, prevsep[jnp.maximum(p, 0)], -1)
    return jnp.where(p < 0, 0, p - ps)


def _sep_right(nextsep, start, n):
    s = jnp.clip(start, 0, n - 1)
    ns = jnp.where(start < n, nextsep[s], start)
    return jnp.maximum(jnp.minimum(ns, n) - start, 0)


@functools.partial(
    jax.jit, static_argnames=("S", "maxdist", "forward", "selfsame",
                              "n1", "n2", "p"))
def _level_pre(prev, base1, base2, ulen, vlen, finished,
               S: int, maxdist: int, forward: bool, selfsame: bool,
               n1: int, n2: int, p: int):
    """Phase A of front level p: candidate values + slide probes."""
    D = 2 * maxdist + 1
    ks = jnp.arange(-maxdist, maxdist + 1, dtype=jnp.int32)[None, :]
    same = prev + 1
    below = jnp.concatenate(
        [jnp.full((S, 1), NEG32, jnp.int32), prev[:, :-1]], axis=1)
    above = jnp.concatenate(
        [prev[:, 1:] + 1, jnp.full((S, 1), NEG32, jnp.int32)], axis=1)
    t = jnp.maximum(same, jnp.maximum(below, above))
    r = p - jnp.minimum(ulen, vlen)
    valid_k = jnp.abs(ks) <= p
    rpos = r[:, None] > 0
    valid_k = valid_k & (~rpos | (ks <= -r[:, None])
                         | (ks >= r[:, None]))
    valid_k = valid_k & (ks >= -ulen[:, None]) & (ks <= vlen[:, None])
    t = jnp.where(valid_k, t, NEG32)
    bad = (t < 0) | (t + ks < 0)
    t = jnp.where(bad, NEG32, t)

    tv = t.reshape(S * D)
    kk = jnp.broadcast_to(ks, (S, D)).reshape(S * D)
    act = tv > NEG32
    tvc = jnp.where(act, tv, 0)
    if forward:
        a = jnp.repeat(base1, D) + tvc
        b = jnp.repeat(base2, D) + tvc + kk
        ar = a
        br = b
    else:
        a = jnp.repeat(base1, D) - tvc
        b = jnp.repeat(base2, D) - (tvc + kk)
        # backward lce == forward lce on the reversed texts
        ar = (n1 - 1) - a
        br = (n2 - 1) - b
    if selfsame:
        same_ptr = act & (a == b)
    else:
        same_ptr = jnp.zeros(S * D, bool)
    # out-of-range probes (base beyond either text) never match
    inb = (ar >= 0) & (ar <= n1) & (br >= 0) & (br <= n2)
    probe = act & ~same_ptr & inb
    return tv, kk, act, same_ptr, jnp.clip(ar, 0, n1), \
        jnp.clip(br, 0, n2), probe


@functools.partial(
    jax.jit, static_argnames=("S", "maxdist", "forward", "use_reach"))
def _level_post(tv, kk, act, same_ptr, run, fronts, h, finished,
                foundseed, ulen, vlen, bound_u, bound_v, reach,
                S: int, maxdist: int, forward: bool, use_reach: bool,
                p):
    """Phase B: apply slide results, bounds, foundseed and the
    finished/h bookkeeping for level p (traced)."""
    D = 2 * maxdist + 1
    ulen_l = jnp.repeat(ulen, D)
    vlen_l = jnp.repeat(vlen, D)
    tvc = jnp.where(act, tv, 0)
    tv2 = jnp.where(same_ptr, ulen_l - 1, tvc + run)
    if (not forward) and use_reach:
        fs = act & (~same_ptr) & (run >= reach)
    else:
        fs = jnp.zeros(tv.shape[0], bool)
    bu_l = jnp.repeat(bound_u, D)
    bv_l = jnp.repeat(bound_v, D)
    init_u = jnp.where(bu_l <= maxdist, bu_l, ulen_l)
    init_v = jnp.where(bv_l <= maxdist, bv_l, vlen_l)
    bu = jnp.where(same_ptr, init_u, bu_l)
    bv = jnp.where(same_ptr, init_v, bv_l)
    over = (tv2 > bu) | (tv2 + kk > bv)
    newval = jnp.where(fs | over, NEG32, tv2)
    t = jnp.where(act, newval, tv).reshape(S, D)
    foundseed = foundseed | jnp.any(fs.reshape(S, D), axis=1)

    t = jnp.where(finished[:, None], jnp.full((S, D), NEG32,
                                              jnp.int32), t)
    fronts = lax.dynamic_update_slice(fronts, t[:, None, :],
                                      (0, p, 0))
    defined = jnp.any(t > NEG32, axis=1)
    stop_seed = (~finished) & defined & foundseed
    h = jnp.where(stop_seed, p, h)
    finished = finished | stop_seed
    stop_undef = (~finished) & ~defined
    h = jnp.where(stop_undef, jnp.asarray(p, jnp.int32) - 1, h)
    finished = finished | stop_undef
    return fronts, h, finished, foundseed


@functools.partial(
    jax.jit,
    static_argnames=("S", "maxdist", "forward", "use_reach",
                     "selfsame", "n1", "n2", "bits", "Dw", "M2"))
def _fronts_dir_fused(Pa, Pb, bound_u, bound_v, base1, base2,
                      ulen, vlen, reach,
                      S: int, maxdist: int, forward: bool,
                      use_reach: bool, selfsame: bool,
                      n1: int, n2: int, bits: int, Dw: int, M2: int):
    """The WHOLE level loop of one direction as one dispatch: per
    level, candidate values + fused no-sync LCE slides + front/h
    bookkeeping.  Returns (fronts, h, summed overflow)."""
    from ..index.sort import device_lce_pairs_nosync

    D = 2 * maxdist + 1
    M = S * D
    fronts = jnp.full((S, maxdist + 1, D), NEG32, jnp.int32)
    fronts = fronts.at[:, 0, maxdist].set(0)
    h = jnp.full(S, maxdist, jnp.int32)
    empty = (ulen == 0) & (vlen == 0)
    h = jnp.where(empty, 0, h)
    finished = empty
    foundseed = jnp.zeros(S, bool)
    oflow = jnp.int32(0)
    for p in range(1, maxdist + 1):
        prev = fronts[:, p - 1, :]
        tv, kk, act, same_ptr, ar, br, probe = _level_pre(
            prev, base1, base2, ulen, vlen, finished,
            S, maxdist, forward, selfsame, n1, n2, p)
        run, of = device_lce_pairs_nosync(
            Pa, Pb, ar.astype(jnp.int32), br.astype(jnp.int32),
            jnp.zeros(M, jnp.int32), probe, M, M2, n1, n2,
            bits, Dw)
        # slides on non-probe lanes must read 0 (host parity)
        run = jnp.where(probe, run, 0)
        oflow = oflow + of
        fronts, h, finished, foundseed = _level_post(
            tv, kk, act, same_ptr, run, fronts, h, finished,
            foundseed, ulen, vlen, bound_u, bound_v,
            reach, S, maxdist, forward, use_reach, p)
    return fronts, h, oflow


def _fronts_direction(sq, tabs, base1, base2, ulen, vlen,
                      maxdist: int, forward: bool, reach: int,
                      nosync: bool = True):
    """Host driver for one direction: level loop with the compacted
    two-text LCE ladder doing the slides.

    ``nosync`` runs the whole direction as ONE fused dispatch
    (:func:`_fronts_dir_fused`, slides via index/sort.py
    device_lce_pairs_nosync) and returns the summed overflow flag as
    a third result; the caller re-runs with nosync=False when it is
    nonzero (rare: more than M2 lanes slid past 26 chars)."""
    S = int(base1.shape[0])
    D = 2 * maxdist + 1
    n1, n2 = sq.n1, sq.n2
    sigma = tabs["sigma"]
    bits, Dw = lce_pack_params(sigma)
    Pa = tabs["Pf1"] if forward else tabs["Pb1"]
    Pb = tabs["Pf2"] if forward else tabs["Pb2"]
    bound_u = jnp.minimum(
        ulen,
        _sep_right(tabs["x1"], base1, n1) if forward
        else _sep_left(tabs["p1"], base1 + 1, n1))
    bound_v = jnp.minimum(
        vlen,
        _sep_right(tabs["x2"], base2, n2) if forward
        else _sep_left(tabs["p2"], base2 + 1, n2))
    selfsame = sq.s2 is sq.s1
    M = S * D
    if nosync:
        return _fronts_dir_fused(
            Pa, Pb, bound_u, bound_v, base1, base2, ulen, vlen,
            jnp.int32(max(reach, 0)), S, maxdist, forward, reach > 0,
            selfsame, n1, n2, bits, Dw, max(1024, M // 32))
    fronts = jnp.full((S, maxdist + 1, D), NEG32, jnp.int32)
    fronts = fronts.at[:, 0, maxdist].set(0)
    h = jnp.full(S, maxdist, jnp.int32)
    empty = (ulen == 0) & (vlen == 0)
    h = jnp.where(empty, 0, h)
    finished = empty
    foundseed = jnp.zeros(S, bool)
    oflow = jnp.int32(0)
    for p in range(1, maxdist + 1):
        prev = fronts[:, p - 1, :]
        tv, kk, act, same_ptr, ar, br, probe = _level_pre(
            prev, base1, base2, ulen, vlen, finished,
            S, maxdist, forward, selfsame, n1, n2, p)
        run = device_lce_pairs(
            None, n1, sigma, ar, br, M,
            tables=Pa, tables_b=Pb, nb=n2, active0=probe)
        fronts, h, finished, foundseed = _level_post(
            tv, kk, act, same_ptr, run, fronts, h, finished,
            foundseed, ulen, vlen, bound_u, bound_v,
            jnp.int32(max(reach, 0)), S, maxdist, forward,
            reach > 0, p)
    return fronts, h, oflow


@functools.partial(jax.jit, static_argnames=("S", "maxdist"))
def _maxext_device(fr, h, S: int, maxdist: int):
    """extendED.c:141-200 prefilter value: max seq2-side extension
    over all usable front entries."""
    ks = jnp.arange(-maxdist, maxdist + 1, dtype=jnp.int32)
    m = jnp.zeros(S, jnp.int32)
    for p in range(maxdist + 1):
        vals = fr[:, p, :]
        ok = (vals > NEG32) & (p <= h[:, None])
        v = jnp.where(ok, vals + ks[None, :], 0)
        m = jnp.maximum(m, jnp.max(v, axis=1))
    return m


def edit_fronts_viable(sq, pos1, pos2, slen, maxdist: int,
                       leastlength: int, seedlength: int):
    """Both directions' fronts + the viability prefilter on device.

    Returns (vidx, lf, hl, rf, hr) with the front tensors already
    compacted to the viable seeds (host int64 arrays, shaped like the
    host edit_fronts outputs restricted to vidx)."""
    S = int(pos1.shape[0])
    n1, n2 = sq.n1, sq.n2
    tabs = _dev_tables(sq)
    if isinstance(pos1, np.ndarray):
        p1d = jnp.asarray(pos1.astype(np.int32))
        p2d = jnp.asarray(pos2.astype(np.int32))
        sld = jnp.asarray(slen.astype(np.int32))
    else:  # already device-resident (fused seed path)
        p1d = pos1.astype(jnp.int32)
        p2d = pos2.astype(jnp.int32)
        sld = slen.astype(jnp.int32)
    for nosync in (True, False):
        lf, hl, of1 = _fronts_direction(
            sq, tabs, p1d - 1, p2d - 1, p1d, p2d, maxdist,
            forward=False, reach=seedlength, nosync=nosync)
        rf, hr, of2 = _fronts_direction(
            sq, tabs, p1d + sld, p2d + sld,
            n1 - (p1d + sld), n2 - (p2d + sld), maxdist,
            forward=True, reach=0, nosync=nosync)
        remain = jnp.maximum(leastlength - sld, 0)
        viable = (_maxext_device(lf, hl, S, maxdist)
                  + _maxext_device(rf, hr, S, maxdist)) >= remain
        # one sync: viability mask + slide-overflow flag together
        # (int8: the mask costs S bytes of device-to-host copy)
        chk = np.asarray(jnp.concatenate(
            [viable.astype(jnp.int8),
             jnp.clip(of1 + of2, 0, 1).astype(jnp.int8)[None]]))
        vmask = chk[:S] != 0
        if chk[S] == 0:
            break
        # rare: some slides overran the fused budget — redo synced
    vidx = np.flatnonzero(vmask)
    z = np.zeros(0, np.int64)
    if vidx.size == 0:
        return vidx, None, z, None, z
    sel = jnp.asarray(vidx.astype(np.int32))
    lf_h = np.asarray(lf[sel]).astype(np.int64)
    rf_h = np.asarray(rf[sel]).astype(np.int64)
    hl_h = np.asarray(hl[sel]).astype(np.int64)
    hr_h = np.asarray(hr[sel]).astype(np.int64)
    # host NEG sentinel differs (engine/gextend.NEG); remap
    from .gextend import NEG as NEGH

    lf_h[lf_h <= int(NEG32)] = NEGH
    rf_h[rf_h <= int(NEG32)] = NEGH
    return vidx, lf_h, hl_h, rf_h, hr_h
