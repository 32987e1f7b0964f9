"""Matching statistics of a query text against an indexed database.

MS(p) = length of the longest prefix of query[p..] that occurs
anywhere in the database — exactly the per-position maximal match
length the reference computes with its per-suffix ESA descents and
amortized witness chains (src/kurtz/matchsub.c:353-539 speedup 2,
src/Vmengine/fquery.c PROCESSSUFFIX).  The reference's sequential
amortization (MS(p+1) >= MS(p) - 1 plus the sti1 isomorphism shortcut)
is inherently serial; the batched formulation instead computes ALL
matching statistics at once from a generalized (merged) suffix
ordering:

1. sort the suffixes of db ++ SEPARATOR ++ query on device (the
   seeded compacted doubling of index/sort.py), collecting the rank
   snapshots;
2. adjacent-pair LCPs of the merged order by snapshot descent —
   O(log n) gathers per pair, independent of depth (self-similar
   corpora make adjacent lcps huge, so the windowed ladder is the
   wrong tool here);
3. MS(p) = max over the two db-suffix neighbors of query-suffix p in
   the merged order of their range-min lcp — two segmented min scans
   (forward and backward), no per-character work;
4. the witness is the db SA rank of the chosen neighbor: db suffixes
   keep their relative ESA order inside the merged order (separator
   and sentinel specials compare by position on both sides), so a
   running count of db-tagged ranks IS the db rank.

Everything through step 4 is device arrays; one download of (ms, wit)
per query text.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import SEPARATOR
from ..index.esa import ESA
from ..index.sort import (
    _lce_tables,
    device_suffix_sort,
    lce_pack_params,
    lce_with_snapshots,
)

INT32_INF = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("n_m", "n_db", "nq"))
def _ms_scans(sa, mlcp, n_m: int, n_db: int, nq: int):
    """Forward/backward segmented min scans over the merged order.

    Element r carries lcp(sa[r-1], sa[r]); db-tagged ranks reset the
    running min.  After the scans, each query-tagged rank knows the
    lce to its nearest db suffix on either side plus that suffix's db
    SA rank.  Returns (ms[nq], wit[nq]) scattered to query positions.
    """
    is_db = sa < n_db
    db_rank = jnp.cumsum(is_db.astype(jnp.int32)) - 1  # rank of last db <= r

    def seg_combine(x, y):
        fx, vx, wx = x
        fy, vy, wy = y
        f = fx | fy
        v = jnp.where(fy, vy, jnp.minimum(vx, vy))
        w = jnp.where(fy, wy, wx)
        return f, v, w

    INF = jnp.int32(2**30)
    # forward: prev db neighbor
    v_el = jnp.where(is_db, INF, mlcp)
    w_el = jnp.where(is_db, db_rank, 0)
    ff, vf, wf = lax.associative_scan(
        seg_combine, (is_db, v_el, w_el))
    # vf at rank r (query-tagged): min mlcp(p+1..r) with p = prev db
    # backward: next db neighbor — reverse, scan, reverse.  The
    # backward range-min to the next db suffix q>r is min mlcp(r+1..q):
    # element in reversed orientation carries mlcp[r+1]
    mlcp_next = jnp.concatenate([mlcp[1:], jnp.full(1, 0, jnp.int32)])
    vb_el = jnp.where(is_db, INF, mlcp_next)[::-1]
    fb_el = is_db[::-1]
    wb_el = jnp.where(is_db, db_rank, 0)[::-1]
    fb, vb, wb = lax.associative_scan(
        seg_combine, (fb_el, vb_el, wb_el))
    fb = fb[::-1]
    vb = vb[::-1]
    wb = wb[::-1]

    ms_f = jnp.where(ff & ~is_db, vf, -1)
    ms_b = jnp.where(fb & ~is_db, vb, -1)
    use_f = ms_f >= ms_b            # prefer the lower neighbor on ties
    ms = jnp.maximum(jnp.maximum(ms_f, ms_b), 0)
    wit = jnp.where(use_f, wf, wb)

    qtag = sa > n_db
    qpos = jnp.where(qtag, sa - (n_db + 1), nq)
    msq = jnp.zeros(nq, jnp.int32).at[qpos].set(
        jnp.where(qtag, ms, 0), mode="drop")
    witq = jnp.zeros(nq, jnp.int32).at[qpos].set(
        jnp.where(qtag, wit, 0), mode="drop")
    return msq, witq


def matching_statistics(esa: ESA, qtext: np.ndarray):
    """(ms[nq], witness_db_rank[nq]) for every query position.

    witness is a db SA rank whose suffix realizes ms (ties prefer the
    lexicographically smaller neighbor, mirroring the host path's
    cand0-first choice).  Cached per (esa, query text id) is the
    caller's business; this function does one merged device sort.
    """
    n_db = esa.totallength
    nq = int(qtext.size)
    if nq == 0 or n_db == 0:
        z = np.zeros(nq, np.int64)
        return z, z
    if nq == n_db and esa.stitab is not None \
            and (qtext is esa.text
                 or np.array_equal(qtext, esa.text)):
        # identical-text fast path (db vs itself): every query suffix
        # occurs at its own db position, so MS(p) is exactly the
        # distance to the next special/end and the witness is the
        # position's own rank — no merged sort needed.  The witness
        # only has to REALIZE ms (the canonical interval is
        # member-invariant), which its own rank does.
        spec = np.flatnonzero(qtext >= 254).astype(np.int64)
        nxt = np.full(nq, n_db, np.int64)
        if spec.size:
            idx = np.searchsorted(spec, np.arange(nq))
            nxt = np.where(idx < spec.size,
                           spec[np.minimum(idx, spec.size - 1)], n_db)
        ms = nxt - np.arange(nq)
        wit = esa.stitab[:n_db].astype(np.int64)
        return ms, wit
    sigma = esa.alpha.num_regular
    mtext = np.empty(n_db + 1 + nq, np.uint8)
    mtext[:n_db] = esa.text
    mtext[n_db] = SEPARATOR
    mtext[n_db + 1:] = qtext
    n_m = int(mtext.size)
    mdev = jnp.asarray(mtext)
    sa, snaps = device_suffix_sort(mdev, n_m, sigma,
                                   collect_snapshots=True)
    bits, D = lce_pack_params(sigma)
    P = _lce_tables(mdev, n_m, bits, D)
    mlcp_rest = lce_with_snapshots(snaps, P, sa[:-1], sa[1:], n_m,
                                   sigma)
    mlcp = jnp.concatenate([jnp.zeros(1, jnp.int32), mlcp_rest])
    msq, witq = _ms_scans(sa, mlcp, n_m, n_db, nq)
    return (np.asarray(msq).astype(np.int64),
            np.asarray(witq).astype(np.int64))
