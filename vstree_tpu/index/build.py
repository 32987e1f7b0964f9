"""Enhanced-suffix-array construction on the device.

The reference builds its ESA with a three-stage comparison sort
(counting sort on prefixes + multikey quicksort + prefix-doubling for
deep buckets; src/Mkvtree/ppsort.c, bese.c, remainsort.c).  That design
is pointer-chasing and branch-heavy — the opposite of what XLA wants.

The hot sort/LCP core lives in :mod:`vstree_tpu.index.sort` (seeded
compacted prefix doubling + the packed-word LCP ladder; see its module
docstring for the design and the exact sort-order contract mirroring
remainsort.c:73-127/bese.c:26-52).  This module holds the build
orchestration (the mkvtreeprocess analog, mkvprocess.c:875-1089): the
derived tables (bwt, bck, sti1, skp), the ESA assembly, and the
device-memory-bounded out-of-core shard build on top of the mergeesa-analog
merge.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.alphabet import Alphabet
from ..core.chardef import UNDEFBWTCHAR, WILDCARD
from ..core.multiseq import Multiseq
from ..core.route import note
from .esa import ESA

SIZEOFBCKENTRY = 16  # two Uint words per bucket; Uint = unsigned long,
# 8 bytes in the 64-bit reference build (virtualdef.h:104, types.h:48)


def recommended_prefixlength(numofchars: int, totallength: int) -> int:
    """vm_recommendedprefixlength (reference kurtz/detpfxlen.c:53-62)."""
    value = totallength / SIZEOFBCKENTRY
    if value <= numofchars:
        return 1
    return max(1, int(math.floor(math.log(value) / math.log(numofchars))))


def maximal_prefixlength(numofchars: int, totallength: int) -> int:
    """vm_whatisthemaximalprefixlength with prefixlenbits=0
    (detpfxlen.c:64-89): bcktab may use up to 4n bytes."""
    value = totallength / (SIZEOFBCKENTRY / 4)
    if value <= numofchars:
        return 1
    return max(1, int(math.floor(math.log(value) / math.log(numofchars))))


# ---------------------------------------------------------------------------
# suffix sorting: seeded + compacted prefix doubling (index/sort.py)
# ---------------------------------------------------------------------------


def suffix_sort(
    text_np: np.ndarray, mesh=None, sigma: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Sort all suffixes of the encoded text.

    Returns ``(suftab, stitab)`` as int32 arrays of length n+1:
    ``suftab[r]`` = start position of the rank-r suffix (with
    ``suftab[n] = n``, the sentinel) and ``stitab`` its inverse.

    Single-device path: packed-key seeded, compacted prefix doubling
    (:mod:`vstree_tpu.index.sort`).  With ``mesh`` (a
    jax.sharding.Mesh over >1 device) every O(n) array is laid out
    over the mesh and the doubling sort runs as an XLA distributed
    sort (parallel/shardesa.py).
    """
    if mesh is not None and np.prod(list(mesh.shape.values())) > 1:
        from ..parallel.shardesa import suffix_sort_sharded

        return suffix_sort_sharded(text_np, mesh)
    from .sort import suffix_sort_host

    return suffix_sort_host(text_np, sigma=sigma)


def build_suf_lcp(text_np: np.ndarray, sigma: int | None = None):
    """Suffix sort + adjacent-pair LCP, all on device; returns
    (suftab[n+1], lcptab[n+1]) with the usual sentinel conventions."""
    from .sort import suf_lcp_host

    return suf_lcp_host(text_np, sigma=sigma)


# ---------------------------------------------------------------------------
# LCP: batched chunked comparison
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("w", "n"))
def _lcp_round(text, a, b, lcp, active, w: int, n: int):
    """Advance lcp for all active pairs by comparing the next ``w``
    characters.  Character match rule: bytes equal and regular
    (specials never match across positions, chardef semantics)."""
    offs = jnp.arange(w, dtype=jnp.int32)[None, :]
    ia = a[:, None] + lcp[:, None] + offs
    ib = b[:, None] + lcp[:, None] + offs
    va = ia < n
    vb = ib < n
    ca = text[jnp.minimum(ia, n - 1)]
    cb = text[jnp.minimum(ib, n - 1)]
    match = va & vb & (ca == cb) & (ca < WILDCARD)
    # leading run of matches within the window
    run = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)
    full = run == w
    lcp = jnp.where(active, lcp + run, lcp)
    active = active & full
    return lcp, active


def lcp_from_pairs(
    text_np: np.ndarray, a_np: np.ndarray, b_np: np.ndarray, mesh=None
) -> np.ndarray:
    """Longest common prefix of suffix pairs (a[i], b[i]), vectorized.

    Used both for the lcp table (adjacent rank pairs) and by engines
    needing ad-hoc lcp values.  Single-device path: the packed-word
    ladder (index/sort.py).  With ``mesh`` the pair arrays are sharded
    over the devices (embarrassingly pair-parallel windowed compare).
    """
    n = int(text_np.size)
    m = int(a_np.size)
    if m == 0:
        return np.zeros(0, np.int32)
    if mesh is None:
        from .sort import lce_pairs_host

        return lce_pairs_host(text_np, a_np, b_np)
    mpad = m
    if mesh is not None:
        ndev = int(np.prod(list(mesh.shape.values())))
        mpad = ((m + ndev - 1) // ndev) * ndev
        if mpad != m:
            # pad pairs with (0, n): the out-of-range side makes the
            # pair mismatch immediately (lcp 0, inactive after round 1)
            a_np = np.concatenate([a_np, np.zeros(mpad - m, a_np.dtype)])
            b_np = np.concatenate(
                [b_np, np.full(mpad - m, n, b_np.dtype)])
    text = jnp.asarray(text_np)
    a = jnp.asarray(a_np, dtype=jnp.int32)
    b = jnp.asarray(b_np, dtype=jnp.int32)
    lcp = jnp.zeros(mpad, jnp.int32)
    active = jnp.ones(mpad, bool)
    if mesh is not None:
        import jax

        from ..parallel.shardesa import flat_spec

        spec = flat_spec(mesh)
        a = jax.device_put(a, spec)
        b = jax.device_put(b, spec)
        lcp = jax.device_put(lcp, spec)
        active = jax.device_put(active, spec)
    w = 32
    # device rounds while a meaningful fraction of pairs is active
    for _ in range(8):
        lcp, active = _lcp_round(text, a, b, lcp, active, w, n)
        n_active = int(jnp.sum(active))
        if n_active == 0:
            return np.asarray(lcp)[:m]
        if n_active < max(1024, m // 256):
            break
        if w < 256:
            w *= 2
    # finish the deep stragglers with compacted device rounds: gather
    # the still-active pairs into a small array and keep widening the
    # comparison window (formerly a per-pair host char loop —
    # pathological on long-repeat texts)
    lcp_h = np.array(lcp)  # writable copy
    act_idx = np.flatnonzero(np.asarray(active))
    while act_idx.size:
        sub_lcp = jnp.asarray(lcp_h[act_idx])
        sub_a = jnp.asarray(a_np[act_idx], dtype=jnp.int32)
        sub_b = jnp.asarray(b_np[act_idx], dtype=jnp.int32)
        sub_active = jnp.ones(act_idx.size, bool)
        w2 = min(4096, max(w, 256))
        sub_lcp, sub_active = _lcp_round(
            text, sub_a, sub_b, sub_lcp, sub_active, w2, n)
        lcp_h[act_idx] = np.asarray(sub_lcp)
        act_idx = act_idx[np.asarray(sub_active)]
        w = w2 * 2
    return lcp_h[:m]


def lcp_table(
    text_np: np.ndarray, suftab: np.ndarray, mesh=None
) -> np.ndarray:
    """lcp[r] = lcp(suffix at rank r-1, suffix at rank r); lcp[0] = 0.

    int32[n+1]; the on-disk 1-byte + exceptions encoding is applied at
    serialization time (io.py), mirroring bese.c:533 outlcpsubtab.
    """
    n = int(text_np.size)
    lcp = np.zeros(n + 1, np.int32)
    if n >= 1:
        lcp[1:] = lcp_from_pairs(text_np, suftab[:-1], suftab[1:],
                                 mesh=mesh)
    return lcp


# ---------------------------------------------------------------------------
# derived tables
# ---------------------------------------------------------------------------


def bwt_table(text_np: np.ndarray, suftab: np.ndarray) -> np.ndarray:
    """Burrows-Wheeler transform (reference encodeburrowswheeler,
    kurtz/bwtcode.c:293-311)."""
    if text_np.size == 0:
        return np.full(suftab.size, UNDEFBWTCHAR, np.uint8)
    prev = suftab.astype(np.int64) - 1
    bwt = np.where(
        suftab > 0, text_np[np.maximum(prev, 0)], np.uint8(UNDEFBWTCHAR)
    ).astype(np.uint8)
    return bwt


def bucket_codes(
    text_np: np.ndarray, numofchars: int, prefixlength: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-suffix bucket code and regular-prefix depth.

    Mirrors the reference's rolling-code semantics (ppsort.c:83-314):
    the code of suffix ``i`` uses digits ``text[i+j]`` for regular
    chars; from the first special char (or the sentinel at position
    ``n``) onward every remaining digit is ``numofchars-1``, so a
    special-containing suffix lands in the *maximal* code sharing its
    regular prefix.  Returns int64 codes for suffixes 0..n (inclusive
    sentinel) and the depth of the first special (== prefixlength for
    fully regular windows).
    """
    n = int(text_np.size)
    pl = prefixlength
    if n == 0:
        return (
            np.full(1, numofchars ** pl - 1, np.int64),
            np.zeros(1, np.int64),
        )
    t = text_np.astype(np.int64)
    code = np.zeros(n + 1, np.int64)
    valid_depth = np.full(n + 1, pl, np.int64)
    pos = np.arange(n + 1)
    seen_special = np.zeros(n + 1, bool)
    for j in range(pl):
        idx = pos + j
        inb = idx < n
        cj = np.where(inb, t[np.minimum(idx, n - 1)], numofchars - 1)
        sp = ~inb | (cj >= WILDCARD)
        newly = sp & ~seen_special
        valid_depth = np.where(newly, j, valid_depth)
        seen_special |= sp
        cj = np.where(seen_special, numofchars - 1, cj)
        code = code * numofchars + cj
    return code, valid_depth


def bck_table(
    text_np: np.ndarray, numofchars: int, prefixlength: int
) -> np.ndarray:
    """Bucket table: for each prefix code c, ``bck[2c] = left`` and
    ``bck[2c+1] = mid``: ranks [left, mid) hold the suffixes whose full
    pl-prefix is regular and spells c; [mid, right=left of c+1) hold
    the special-containing suffixes assigned to c (reference makebcktab
    mkvprocess.c:251-312 with counts from ppsort.c).  Covers all n+1
    suffixes including the sentinel (last bucket).
    """
    numofcodes = numofchars ** prefixlength
    code, valid_depth = bucket_codes(text_np, numofchars, prefixlength)
    hist_all = np.bincount(code, minlength=numofcodes)
    hist_full = np.bincount(
        code[valid_depth == prefixlength], minlength=numofcodes
    )
    left = np.concatenate([[0], np.cumsum(hist_all)[:-1]])
    bck = np.empty(2 * numofcodes, np.uint32)
    bck[0::2] = left
    bck[1::2] = left + hist_full
    return bck


# ---------------------------------------------------------------------------
# skip table
# ---------------------------------------------------------------------------


_SKP_BLOCK = 64


def skip_table(lcptab: np.ndarray) -> np.ndarray:
    """skp[i] = (smallest j > i with lcp[j] < lcp[i]) - 1, i.e. the
    last rank of the run with lcp >= lcp[i]; totallength if none —
    reference kurtz/mkskip.c:62-83 semantics, used by the
    esahamming/esaapm scan to jump doomed subtrees.

    Next-smaller-value in O(n) memory (the former [log n, n] sparse
    table could not fit large indexes): a shifted-window near scan
    (pure vector shifts, no gathers) resolves everything within two
    blocks; escapees descend a sparse table over BLOCK minima (n/64
    entries) and finish with one in-block scan.
    """
    n1 = int(lcptab.size)  # n+1 entries; totallength = n1 - 1
    if n1 <= 1:
        return np.full(n1, n1 - 1, np.int64)
    B = _SKP_BLOCK
    nb = (n1 + B - 1) // B
    blevels = max(1, int(np.floor(np.log2(max(nb, 2)))) + 1)
    lcp_dev = jnp.asarray(lcptab.astype(np.int32))
    ans, esc = _skp_phase12(lcp_dev, n1, nb, blevels)
    ans_h = np.asarray(ans).astype(np.int64)
    esc_h = np.asarray(esc)
    ei = np.flatnonzero(esc_h)
    if ei.size:
        fine = _skp_inblock(
            lcp_dev, jnp.asarray(ans_h[ei].astype(np.int32)),
            jnp.asarray(lcptab[ei].astype(np.int32)), n1)
        ans_h[ei] = np.asarray(fine)
    # skp = ans - 1; none -> totallength (n1 - 1)
    return np.minimum(ans_h, n1) - 1


@functools.partial(jax.jit, static_argnames=("n1", "nb", "blevels"))
def _skp_phase12(lcp, n1: int, nb: int, blevels: int):
    """Phases 1+2: near answers (exact positions) and, for escapees,
    the START of the first far block whose minimum dips below lcp[i]
    (escape mask returned separately; phase 3 resolves in-block)."""
    B = _SKP_BLOCK
    BIG = jnp.int32(2**30)
    idx = jnp.arange(n1, dtype=jnp.int32)
    INF = jnp.int32(n1)

    # phase 1: shifted-window scan to the end of the NEXT block (the
    # acceptance bound keeps phases gap- and overlap-free); shifts are
    # pure vector ops, no gathers
    limit = (idx // B + 2) * B - 1
    ans = jnp.full(n1, INF, jnp.int32)
    for k in range(1, 2 * B + 1):
        sh = jnp.concatenate(
            [lcp[k:], jnp.full(min(k, n1), BIG, jnp.int32)])
        hit = (sh < lcp) & (idx + k <= limit)
        ans = jnp.where((ans == INF) & hit, idx + k, ans)

    # phase 2: first BLOCK b >= block(i)+2 with min < lcp[i] —
    # aligned-window descent on a sparse table over block minima
    # (n/64 entries per level: O(n) total memory)
    pad = nb * B - n1
    lcp_pad = (jnp.concatenate([lcp, jnp.full(pad, BIG, jnp.int32)])
               if pad else lcp)
    bmin = jnp.min(lcp_pad.reshape(nb, B), axis=1)
    btabs = [bmin]
    for e in range(1, blevels):
        prev = btabs[-1]
        half = 1 << (e - 1)
        shifted = jnp.concatenate(
            [prev[half:], jnp.full(min(half, nb), BIG, jnp.int32)])
        btabs.append(jnp.minimum(prev, shifted))
    btab = jnp.stack(btabs)

    v = lcp
    t = idx // B + 1
    for e in range(blevels - 1, -1, -1):
        mn = btab[e, jnp.clip(t + 1, 0, nb - 1)]
        ok = (t + (1 << e) <= nb) & (mn >= v)
        t = jnp.where(ok, t + (1 << e), t)
    bstar = t + 1  # first block >= block(i)+2 with bmin < v (>= nb: none)
    found_blk = (bstar < nb) & (btab[0, jnp.clip(bstar, 0, nb - 1)] < v)
    esc = (ans == INF) & found_blk
    ans = jnp.where(esc, jnp.clip(bstar, 0, nb - 1) * B, ans)
    return ans, esc


@jax.jit
def _skp_inblock(lcp, base, v, n1: int = None):
    """Phase 3: exact first j in [base, base+B) with lcp[j] < v."""
    B = _SKP_BLOCK
    n1 = lcp.shape[0]
    off = jnp.full(base.shape[0], B, jnp.int32)
    for k in range(B - 1, -1, -1):
        cand = base + k
        val = lcp[jnp.minimum(cand, n1 - 1)]
        ok = (cand < n1) & (val < v)
        off = jnp.where(ok, k, off)
    return base + off


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def _lcp_pairs_host_chunked(text: np.ndarray, a: np.ndarray,
                            b: np.ndarray, chunk: int = 1 << 20
                            ) -> np.ndarray:
    """Host windowed lcp of suffix pairs with O(chunk) memory — the
    out-of-core build's lcp pass (no device tables, no [n]-sized
    intermediates beyond the text itself)."""
    n = int(text.size)
    out = np.empty(a.size, np.int64)
    for lo in range(0, a.size, chunk):
        aa = a[lo:lo + chunk].astype(np.int64)
        bb = b[lo:lo + chunk].astype(np.int64)
        lce = np.zeros(aa.size, np.int64)
        act = np.arange(aa.size)
        w = 32
        off = 0
        while act.size:
            offs = np.arange(w)
            ia = aa[act][:, None] + off + offs[None, :]
            ib = bb[act][:, None] + off + offs[None, :]
            va = ia < n
            vb = ib < n
            ca = text[np.minimum(ia, n - 1)]
            cb = text[np.minimum(ib, n - 1)]
            nomatch = ~(va & vb & (ca == cb) & (ca < WILDCARD))
            full = ~nomatch.any(axis=1)
            lce[act] += np.where(full, w, np.argmax(nomatch, axis=1))
            act = act[full]
            off += w
            if w < 2048:
                w *= 4
        out[lo:lo + chunk] = lce
    return out


def build_suf_out_of_core(
    multiseq: Multiseq,
    alpha: Alphabet,
    max_shard_bp: int,
    want_lcp: bool = True,
):
    """Suffix (and lcp) table of a multi-sequence database built with
    DEVICE memory bounded by ``max_shard_bp`` symbols per shard.

    The database is partitioned at sequence boundaries, each shard is
    sorted on device independently, and the shard orders merge by rank
    arithmetic (index/merge.py — the reference's mergeesa seam,
    kurtz-basic/mergeesa.c:124).  The merged order is EXACTLY the
    monolithic index's (sequences are SEPARATOR-joined either way), so
    an index far larger than device memory builds on one device; the lcp pass runs
    as a host chunked window compare with O(chunk) memory.

    Returns (suftab[n+1], lcptab[n+1] or None).
    """
    from .merge import merge_indexes

    nseq = multiseq.numofsequences
    if nseq <= 1:
        # single sequence: no boundary to split at
        if want_lcp:
            return build_suf_lcp(multiseq.sequence,
                                 sigma=alpha.num_regular)
        return (suffix_sort(multiseq.sequence,
                            sigma=alpha.num_regular)[0], None)

    groups: list[list[int]] = [[]]
    acc = 0
    for s in range(nseq):
        a, b = multiseq.seq_bounds(s)
        ln = b - a
        if groups[-1] and acc + ln + 1 > max_shard_bp:
            groups.append([])
            acc = 0
        groups[-1].append(s)
        acc += ln + 1

    # hold the full text 2-bit packed while the shards build (the
    # Encodedsequence storage concern, core/encseq.py) — shard byte
    # views materialize one at a time
    from ..core.encseq import Encodedsequence

    enc = Encodedsequence(multiseq.sequence)
    parts = []
    for g in groups:
        lo = multiseq.seq_bounds(g[0])[0]
        hi = multiseq.seq_bounds(g[-1])[1]
        sub = Multiseq(sequence=enc.decode(lo, hi),
                       markpos=np.zeros(0, np.int64))
        sub.totallength = int(hi - lo)
        parts.append(build_esa(sub, alpha, demand=("suf",)))
    suf, gtext = merge_indexes(parts)
    if not np.array_equal(gtext, multiseq.sequence):
        raise AssertionError(
            "out-of-core shard join does not reproduce the input "
            "concatenation")
    n = int(gtext.size)
    suftab = suf.astype(np.int64)   # merge includes the sentinel rank
    assert suftab.size == n + 1 and suftab[-1] == n
    lcptab = None
    if want_lcp:
        note("lcp", "host")
        lcptab = np.zeros(n + 1, np.int64)
        lcptab[1:n] = _lcp_pairs_host_chunked(
            gtext, suftab[:n - 1], suftab[1:n])
    return suftab, lcptab


def build_esa(
    multiseq: Multiseq,
    alpha: Alphabet,
    prefixlength: int | None = None,
    demand: tuple[str, ...] = ("suf", "lcp", "bwt", "bck", "sti"),
    indexname: str = "",
    mesh=None,
) -> ESA:
    """Build the enhanced suffix array for a Multiseq.

    Equivalent of reference ``mkvtreeprocess`` (mkvprocess.c:875-1089)
    minus file output (see io.write_index for that).  ``mesh`` shards
    the sort and lcp passes over a device mesh (parallel/shardesa.py).
    """
    text = multiseq.sequence
    n = int(text.size)
    numofchars = alpha.num_regular
    if prefixlength is None:
        prefixlength = recommended_prefixlength(numofchars, max(n, 1))

    lcptab = None
    note("suffix sort", "device")
    if mesh is not None and np.prod(list(mesh.shape.values())) > 1:
        suftab, stitab = suffix_sort(text, mesh=mesh)
    elif "lcp" in demand or "skp" in demand:
        # fused device program: sort + lcp share the doubling state
        suftab, lcptab = build_suf_lcp(text, sigma=numofchars)
        stitab = np.empty(n + 1, np.int32)
        stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    else:
        suftab, stitab = suffix_sort(text, sigma=numofchars)
    esa = ESA(
        multiseq=multiseq,
        alpha=alpha,
        suftab=suftab,
        stitab=stitab if "sti" in demand else None,
        prefixlength=prefixlength,
        longest=int(stitab[0]) if n > 0 else 0,
        indexname=indexname,
    )
    if "lcp" in demand:
        esa.lcptab = (lcptab if lcptab is not None
                      else lcp_table(text, suftab, mesh=mesh))
        esa.maxbranchdepth = int(esa.lcptab.max()) if n > 0 else 0
        esa.largelcpvalues = int((esa.lcptab >= 255).sum())
    if "bwt" in demand:
        esa.bwttab = bwt_table(text, suftab)
    if "bck" in demand and prefixlength > 0:
        esa.bcktab = bck_table(text, numofchars, prefixlength)
    if "skp" in demand:
        if esa.lcptab is None:
            esa.lcptab = (lcptab if lcptab is not None
                          else lcp_table(text, suftab, mesh=mesh))
        esa.skptab = skip_table(esa.lcptab)
    from ..core.debug import check_suftab, debug_level

    lvl = debug_level()
    if lvl >= 1:
        # DEBUGLEVEL-style embedded verifiers (bese.c:355-533)
        check_suftab(text, suftab, esa.lcptab, lvl)
    return esa
