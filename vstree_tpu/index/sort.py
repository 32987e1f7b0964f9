"""Device suffix sorting and LCP (the hot core of the index build).

The reference builds its suffix array with a counting sort on depth-pl
prefixes (src/Mkvtree/ppsort.c:83) followed by per-bucket multikey
quicksort (bese.c:855) and prefix-doubling for deep buckets
(remainsort.c:39).  Round 3 of this framework ran generic prefix
doubling from depth 1 as whole-array ``lax.sort`` rounds; device
timing showed the LCP windowed-gather pass dominating (multi-GB [n, w]
intermediates) and every doubling round paying full-n cost.  This
module is the redesign:

1. **Seeded doubling** — the XLA analog of the reference's phase-1
   counting sort: initial ranks come from ONE ``lax.sort`` over packed
   multi-character keys (D characters per int32 digit-packed key;
   D = 10 for DNA).  The special-character rule (a special beats every
   regular char; two specials compare by text position — reference
   remainsort.c:73-127) is preserved exactly with a secondary
   first-special-position key.

2. **Compacted doubling rounds** (Larsson-Sadakane discipline mapped to
   static XLA shapes): only members of non-singleton rank groups are
   re-sorted.  Group ranks are group-start slots, so sorted actives
   scatter back into the ascending active-slot list and every round is
   O(active), not O(n).  The active set is re-compacted between rounds
   at power-of-two padded sizes (compile-cache friendly).

3. **LCP by packed-word ladder** — lcp of each adjacent suffix pair
   advances D characters per round via ONE int32 gather per side
   (15 chars/gather for DNA); the exact sub-word remainder falls out of
   XOR + first-differing-digit bit math; special positions terminate
   matches through a precomputed first-special-offset table.  Pairs
   that finish drop out by the same compaction discipline, so deep-lcp
   stragglers cost only their own tail.

No float math in any ordering decision; ranks are int32, which holds
to n < 2^31 - 64.
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.chardef import WILDCARD

INT32_INF = np.int32(2**31 - 1)
MAX_N = 2**31 - 64


def _bits_for(values: int) -> int:
    """Bits needed to hold digit values 0..values-1."""
    return max(1, int(math.ceil(math.log2(max(values, 2)))))


def sort_pack_params(sigma: int) -> tuple[int, int]:
    """(bits, D) for the ORDERING key: digits 0..sigma-1 regular plus
    the special marker sigma; D digits packed into 30 bits."""
    bits = _bits_for(sigma + 1)
    return bits, max(1, 30 // bits)


def lce_pack_params(sigma: int) -> tuple[int, int]:
    """(bits, D) for the EQUALITY key used by the LCP ladder.  One
    int32 word carries D regular digits PLUS the first-special offset
    (0..D) in the high bits — a single gather per side per round.
    DNA: 13 chars/word."""
    bits = _bits_for(sigma)
    D = max(1, 30 // bits)
    while D > 1 and D * bits + D.bit_length() > 31:
        D -= 1
    return bits, D


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _nice_size(x: int) -> int:
    """Smallest m * 2^e >= x with m in [8, 16) — 1/8-octave padding:
    <= 12.5% waste, bounded compiled-shape variety."""
    if x <= 8:
        return max(1, x)
    e = max(0, x.bit_length() - 4)
    return ((x + (1 << e) - 1) >> e) << e


# ---------------------------------------------------------------------------
# initial phase: packed-key sort -> group-start ranks
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("n", "sigma", "bits", "D"))
def _initial_phase(text, n: int, sigma: int, bits: int, D: int):
    """One sort resolving suffix order to depth D.

    Returns (sa, rank, rank_by_slot, active_slot):
      sa[r]            position of the rank-r suffix (r in [0, n))
      rank[p]          group-start slot of suffix p (order-preserving,
                       NON-dense: the Larsson-Sadakane representative)
      rank_by_slot[r]  rank[sa[r]]
      active_slot[r]   True iff slot r's group has >= 2 members
    """
    pos = jnp.arange(n, dtype=jnp.int32)
    special = text >= WILDCARD
    dg = text.astype(jnp.int32)
    padded = jnp.concatenate([dg, jnp.zeros(D, jnp.int32)])
    # first special position in the window [i, i+D), counting the
    # sentinel at position n; INT32_INF when none
    sp = jnp.where(special, pos, INT32_INF)
    padded_sp = jnp.concatenate(
        [sp, jnp.full(1, n, jnp.int32),
         jnp.full(max(D - 1, 1), INT32_INF, jnp.int32)])
    fs = jnp.full(n, INT32_INF, jnp.int32)
    for j in range(D):
        fs = jnp.minimum(fs, lax.dynamic_slice(padded_sp, (j,), (n,)))
    off = fs - pos  # offset of the first special (>= D if none near)
    # digit semantics (reference remainsort.c:73-127): regular chars
    # by value; the first special is the marker digit ``sigma`` (beats
    # every regular); everything after it is constant 0 so that equal
    # prefixes tie on key1 and break on the special's POSITION (key2)
    key1 = jnp.zeros(n, jnp.int32)
    for j in range(D):
        cj = lax.dynamic_slice(padded, (j,), (n,))
        digit = jnp.where(off > j, cj,
                          jnp.where(off == j, jnp.int32(sigma), 0))
        key1 = (key1 << bits) | digit
    key2 = jnp.where(fs < INT32_INF, fs + 1, 0)

    k1s, k2s, sa = lax.sort((key1, key2, pos), num_keys=2,
                            is_stable=False)
    ng = jnp.concatenate([
        jnp.ones(1, bool),
        (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1]),
    ])
    slots = jnp.arange(n, dtype=jnp.int32)
    rank_by_slot = lax.cummax(jnp.where(ng, slots, 0))
    rank = jnp.zeros(n, jnp.int32).at[sa].set(rank_by_slot)
    ng_next = jnp.concatenate([ng[1:], jnp.ones(1, bool)])
    active_slot = ~(ng & ng_next)
    return sa, rank, rank_by_slot, active_slot


# ---------------------------------------------------------------------------
# doubling rounds (ghost discipline: singletons may stay in the list —
# their unique group-start rank sorts them back to their own slot, so
# compaction is OPTIONAL and only runs when the live count halves)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("M", "n"),
                   donate_argnums=(0,))
def _doubling_round(rank, slots, p, r1, k, M: int, n: int):
    """One doubling round at certified depth ``k`` over M list entries
    (live group members + ghosts + pads).

    slots is the ascending slot list of the entries; sorting by
    (group-start rank, rank at +k) aligns sorted element j with
    slots[j] — ghosts (singletons) have a unique r1 and land back on
    their own slot.  Only ``rank`` is updated globally; sa is
    reconstructed once at the end from the final bijective rank.
    """
    pk = p + k
    in_range = (pk < n) & (pk >= p)      # >= p guards int32 wrap
    r2 = jnp.where(in_range,
                   rank[jnp.minimum(jnp.maximum(pk, 0), n - 1)],
                   jnp.int32(n))
    r2 = jnp.where(p < n, r2, INT32_INF)  # pads last
    r1s, r2s, ps = lax.sort((r1, r2, p), num_keys=2, is_stable=False)
    ng = jnp.concatenate([
        jnp.ones(1, bool),
        (r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1]),
    ])
    new_r1 = lax.cummax(jnp.where(ng, slots, 0))
    ng_next = jnp.concatenate([ng[1:], jnp.ones(1, bool)])
    new_live = ~(ng & ng_next) & (ps < n)
    rank = rank.at[ps].set(new_r1, mode="drop")
    return (rank, ps, new_r1, new_live,
            jnp.sum(new_live.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("M", "M2", "n"))
def _compact_live(slots, p, r1, live, M: int, M2: int, n: int):
    """Drop ghosts/pads: scatter live entries to the front (stable —
    cumsum positions preserve ascending slot order), pad to M2."""
    dst = jnp.cumsum(live.astype(jnp.int32)) - 1
    dst = jnp.where(live, dst, M2)
    slots2 = jnp.full(M2, n, jnp.int32).at[dst].set(slots, mode="drop")
    p2 = jnp.full(M2, n, jnp.int32).at[dst].set(p, mode="drop")
    r12 = jnp.full(M2, INT32_INF, jnp.int32).at[dst].set(
        r1, mode="drop")
    return slots2, p2, r12


@functools.partial(jax.jit, static_argnames=("n",))
def _sa_from_rank(rank, n: int):
    """Final suffix array from the (bijective) rank map."""
    return jnp.zeros(n, jnp.int32).at[rank].set(
        jnp.arange(n, dtype=jnp.int32))


# Share of the device memory limit the LCE snapshots may pin.
SNAPSHOT_SHARE = 0.25
# Snapshot budget on a backend that reports no memory limit (the CPU).
HOST_SNAPSHOT_BUDGET = 2 << 30


def snapshot_budget() -> int:
    """Bytes the suffix-sort snapshots may pin: SNAPSHOT_SHARE of the
    default device's ``bytes_limit``, or HOST_SNAPSHOT_BUDGET where the
    backend reports no memory statistics."""
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"] * SNAPSHOT_SHARE)
    return HOST_SNAPSHOT_BUDGET


def device_suffix_sort(text_dev, n: int, sigma: int,
                       collect_snapshots: bool = False):
    """Suffix sort of the whole encoded text; returns sa (device int32
    [n], sa[r] = start of rank-r suffix, sentinel excluded).

    Host-driven round loop: one scalar sync per doubling round (the
    live count steers compaction); every O(n)-sized op stays on
    device.

    With ``collect_snapshots`` also returns the list of
    (certified_depth, rank_array) snapshots taken after every round —
    rank_k[a] == rank_k[b]  iff  lce(a, b) >= k, the EXACT certificate
    that powers depth-independent O(log n) LCE descents
    (:func:`lce_via_snapshots`)."""
    bits, D = sort_pack_params(sigma)
    sa0, rank, rank_by_slot, active = _initial_phase(
        text_dev, n, sigma, bits, D)
    snaps = []
    # snapshot count is bounded by device memory: each snapshot pins a
    # full [n] int32 array, so repetitive corpora (max-lcp ~ n) would
    # otherwise pin ~log2(n/D) of them (>12 GB at 200 Mbp).  The
    # budget keeps the SMALL-k certificates (binary representability
    # of the descent needs every level below the largest kept); LCEs
    # deeper than the kept ladder are finished exactly by the windowed
    # ladder (lce_with_snapshots' completion pass).
    snap_cap = max(4, snapshot_budget() // (4 * max(n, 1)))
    if collect_snapshots:
        snaps.append((D, rank + 0))
    cnt = int(jnp.sum(active.astype(jnp.int32)))
    if cnt == 0:
        return (sa0, snaps) if collect_snapshots else sa0
    # start at full width with identity slots (no compaction cost);
    # ghosts ride along until the live count halves
    M = n
    slots = jnp.arange(n, dtype=jnp.int32)
    p = sa0
    r1 = rank_by_slot
    k = D
    while True:
        rank, p, r1, live, cnt_dev = _doubling_round(
            rank, slots, p, r1, jnp.int32(k), M, n)
        cnt = int(cnt_dev)
        k *= 2
        if collect_snapshots and cnt > 0 and len(snaps) < snap_cap:
            snaps.append((k, rank + 0))
        if cnt == 0:
            sa = _sa_from_rank(rank, n)
            return (sa, snaps) if collect_snapshots else sa
        if k > 4 * n:  # pragma: no cover - invariant safety net
            raise AssertionError("suffix sort failed to converge")
        M2 = _nice_size(cnt)
        if M2 <= M // 2:
            slots, p, r1 = _compact_live(slots, p, r1, live, M, M2, n)
            M = M2


# ---------------------------------------------------------------------------
# depth-independent LCE by snapshot descent
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n", "bits", "D", "ks"))
def _lce_descent(ranks, P, a, b, n: int, bits: int, D: int,
                 ks: tuple):
    """lce(a, b) via the doubling certificates: descend the snapshot
    levels (rank_k[x] == rank_k[y] iff lce(x, y) >= k), each level
    accepted at most once, then resolve the sub-D remainder from one
    packed-word compare.  O(#levels) gathers per pair, independent of
    the lcp depth — the right tool for highly repetitive corpora where
    the windowed ladder would walk arbitrarily far."""
    l = jnp.zeros(a.shape[0], jnp.int32)
    for j in range(len(ks) - 1, -1, -1):
        r = ranks[j]
        ia = a + l
        ib = b + l
        ok = (ia < n) & (ib < n)
        eq = ok & (r[jnp.minimum(ia, n - 1)]
                   == r[jnp.minimum(ib, n - 1)])
        l = jnp.where(eq, l + ks[j], l)
    # remainder < ks[0] (the smallest certificate depth) via packed
    # words — the word covers D chars, which may be less than ks[0]-1
    # for some alphabets, hence the (static) multi-step loop
    kmask = (1 << (D * bits)) - 1
    nsteps = max(1, -(-(ks[0] - 1) // D))
    done = jnp.zeros(a.shape[0], bool)
    for _ in range(nsteps):
        ia = a + l
        ib = b + l
        pa = P[jnp.minimum(ia, n - 1)]
        pb = P[jnp.minimum(ib, n - 1)]
        offa = jnp.where(ia < n,
                         lax.shift_right_logical(pa, D * bits), 0)
        offb = jnp.where(ib < n,
                         lax.shift_right_logical(pb, D * bits), 0)
        x = (pa ^ pb) & kmask
        msb = lax.population_count(_smear(x)) - 1
        fd = jnp.where(x == 0, jnp.int32(D), D - 1 - msb // bits)
        rem = jnp.minimum(fd, jnp.minimum(offa, offb))
        l = l + jnp.where(done, 0, rem)
        done = done | (rem < D)
    return l


def lce_with_snapshots(snaps, P, a_dev, b_dev, n: int, sigma: int):
    """Vectorized lce over suffix pairs using sort snapshots.

    The descent resolves any lce representable by the kept
    certificate ladder; pairs still word-equal at the descended depth
    (possible when the snapshot list was capped) are finished
    EXACTLY by the windowed ladder, each paying only its own tail."""
    bits, D = lce_pack_params(sigma)
    ks = tuple(k for k, _ in snaps)
    ranks = [r for _, r in snaps]
    a = a_dev.astype(jnp.int32)
    b = b_dev.astype(jnp.int32)
    l = _lce_descent(ranks, P, a, b, n, bits, D, ks)
    # completion pass: a lane is unresolved while it can still advance
    # (its next char matches and is regular); the windowed ladder
    # finishes those exactly
    kmask = (1 << (D * bits)) - 1
    ia = a + l
    ib = b + l
    pa = P[jnp.minimum(ia, n - 1)]
    pb = P[jnp.minimum(ib, n - 1)]
    offa = jnp.where(ia < n, lax.shift_right_logical(pa, D * bits), 0)
    offb = jnp.where(ib < n, lax.shift_right_logical(pb, D * bits), 0)
    x = (pa ^ pb) & kmask
    msb = lax.population_count(_smear(x)) - 1
    fd = jnp.where(x == 0, jnp.int32(D), D - 1 - msb // bits)
    unresolved = jnp.minimum(fd, jnp.minimum(offa, offb)) > 0
    return device_lce_pairs(None, n, sigma, a, b, int(a.shape[0]),
                            tables=P, init_l=l, active0=unresolved)


# ---------------------------------------------------------------------------
# LCP ladder
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n", "bits", "D"))
def _lce_tables(text, n: int, bits: int, D: int):
    """P[i] = K | (off << D*bits): the D regular digits of window
    [i, i+D) (special positions contribute 0 — masked by ``off``) plus
    off = min(D, offset of first special in the window, counting the
    sentinel at n) in the high bits."""
    pos = jnp.arange(n, dtype=jnp.int32)
    special = text >= WILDCARD
    dg = jnp.where(special, 0, text.astype(jnp.int32))
    padded = jnp.concatenate([dg, jnp.zeros(D, jnp.int32)])
    K = jnp.zeros(n, jnp.int32)
    for j in range(D):
        K = (K << bits) | lax.dynamic_slice(padded, (j,), (n,))
    sp = jnp.where(special, pos, INT32_INF)
    padded_sp = jnp.concatenate(
        [sp, jnp.full(1, n, jnp.int32),
         jnp.full(max(D - 1, 1), INT32_INF, jnp.int32)])
    fs = jnp.full(n, INT32_INF, jnp.int32)
    for j in range(D):
        fs = jnp.minimum(fs, lax.dynamic_slice(padded_sp, (j,), (n,)))
    off = jnp.minimum(jnp.maximum(fs - pos, 0), D)
    return K | (off << (D * bits))


def _smear(x):
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    return x | (x >> 16)


@functools.partial(jax.jit,
                   static_argnames=("M", "na", "nb", "bits", "D", "W"))
def _lce_round(Pa, Pb, a, b, l, idx, M: int, na: int, nb: int,
               bits: int, D: int, W: int = 1):
    """Advance lcp of M (padded) pairs by up to W*D chars.  ONE int32
    gather per side per word (digits + special offset share the word);
    the W word windows are compared at fixed offsets, a word's
    contribution only counting while every earlier word fully matched.
    A stopped pair's l is a fixed point (its window starts at the
    mismatch/special), so results are harvested lazily at compaction.
    """
    kmask = (1 << (D * bits)) - 1
    adv = jnp.zeros(M, jnp.int32)
    done = jnp.zeros(M, bool)
    for w in range(W):
        ia0 = a + l + w * D
        ib0 = b + l + w * D
        pa = Pa[jnp.minimum(ia0, na - 1)]
        pb = Pb[jnp.minimum(ib0, nb - 1)]
        # a position at/after n is the sentinel (empty suffix): off 0
        offa = jnp.where(ia0 < na,
                         lax.shift_right_logical(pa, D * bits), 0)
        offb = jnp.where(ib0 < nb,
                         lax.shift_right_logical(pb, D * bits), 0)
        x = (pa ^ pb) & kmask
        msb = lax.population_count(_smear(x)) - 1
        fd = jnp.where(x == 0, jnp.int32(D), D - 1 - msb // bits)
        rem = jnp.minimum(fd, jnp.minimum(offa, offb))
        adv = adv + jnp.where(done, 0, rem)
        done = done | (rem < D)
    l = l + adv
    active = ~done & (idx >= 0)
    return l, active, jnp.sum(active.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("M", "M2"),
                   donate_argnums=(5,))
def _lce_compact(a, b, l, idx, active, res, M: int, M2: int):
    """Keep active lanes (compacted to the front, padded to M2) and
    harvest finished lanes' results into ``res``."""
    dropped = ~active & (idx >= 0)
    res = res.at[jnp.where(dropped, idx, res.shape[0])].set(
        l, mode="drop")
    dst = jnp.cumsum(active.astype(jnp.int32)) - 1
    dst = jnp.where(active, dst, M2)
    return (jnp.zeros(M2, jnp.int32).at[dst].set(a, mode="drop"),
            jnp.zeros(M2, jnp.int32).at[dst].set(b, mode="drop"),
            jnp.zeros(M2, jnp.int32).at[dst].set(l, mode="drop"),
            jnp.full(M2, -1, jnp.int32).at[dst].set(idx, mode="drop"),
            res)


@functools.partial(jax.jit, donate_argnums=(2,))
def _lce_harvest(l, idx, res):
    return res.at[jnp.where(idx >= 0, idx, res.shape[0])].set(
        l, mode="drop")


def device_lce_pairs(text_dev, n: int, sigma: int, a_dev, b_dev,
                     npairs: int, tables=None, tables_b=None,
                     nb: int | None = None, init_l=None,
                     active0=None):
    """lce(suffix a[i] of text A, suffix b[i] of text B) for npairs
    pairs, on device.

    ``tables`` may carry a precomputed packed-word table from
    :func:`_lce_tables` to share across calls; ``tables_b``/``nb``
    select a second text for cross-text extension (defaults: same
    text).  ``init_l`` seeds the extension lengths and ``active0``
    masks lanes that should not advance at all.  Returns a device
    int32 array of length npairs.
    """
    bits, D = lce_pack_params(sigma)
    if tables is None:
        tables = _lce_tables(text_dev, n, bits, D)
    P = tables
    Pb = tables_b if tables_b is not None else P
    nb = n if nb is None else nb
    if npairs == 0:
        return jnp.zeros(0, jnp.int32)
    M = npairs
    a = a_dev.astype(jnp.int32)
    b = b_dev.astype(jnp.int32)
    idx = jnp.arange(npairs, dtype=jnp.int32)
    if active0 is not None:
        idx = jnp.where(active0, idx, -1)
    l = (jnp.zeros(M, jnp.int32) if init_l is None
         else init_l.astype(jnp.int32))
    res = l + 0
    prev_cnt = None
    slow_decay = False
    while True:
        # widen the word window once the live set is small (deep
        # stragglers advance up to 16*D chars per dispatch) — or when
        # the live count decays slowly (self-similar corpora), where
        # two words per round beat two rounds
        if M > (1 << 22):
            W = 2 if slow_decay else 1
        elif M > (1 << 19):
            W = 4
        else:
            W = 16
        l, active, cnt_dev = _lce_round(
            P, Pb, a, b, l, idx, M, n, nb, bits, D, W)
        cnt = int(cnt_dev)
        slow_decay = prev_cnt is not None and cnt * 5 > prev_cnt * 4
        prev_cnt = cnt
        if cnt == 0:
            return _lce_harvest(l, idx, res)
        M2 = _nice_size(cnt)
        if M2 <= M - M // 4:
            a, b, l, idx, res = _lce_compact(
                a, b, l, idx, active, res, M, M2)
            M = M2
        # else: keep shape; finished lanes' l is a fixed point and is
        # harvested at the next compaction (or at the end)


@functools.partial(
    jax.jit,
    static_argnames=("M", "M2", "na", "nb", "bits", "D", "maxT"))
def device_lce_pairs_nosync(Pa, Pb, a, b, init_l, active0,
                            M: int, M2: int, na: int, nb: int,
                            bits: int, D: int, maxT: int = 512):
    """Sync-free twin of :func:`device_lce_pairs` for latency-bound
    callers (one dispatch, no host round trips): two inline word
    windows resolve the short majority, survivors are compacted
    in-program to M2 slots and finished by a bounded multi-word
    while_loop.  Returns (l, overflow) — overflow > 0 means more than
    M2 lanes survived the inline phase (their results are stale) and
    the caller must redo via the host-looped path."""
    kmask = (1 << (D * bits)) - 1
    sh = D * bits

    def word(ia0, ib0):
        pa = Pa[jnp.minimum(ia0, na - 1)]
        pb = Pb[jnp.minimum(ib0, nb - 1)]
        offa = jnp.where(ia0 < na, lax.shift_right_logical(pa, sh), 0)
        offb = jnp.where(ib0 < nb, lax.shift_right_logical(pb, sh), 0)
        x = (pa ^ pb) & kmask
        msb = lax.population_count(_smear(x)) - 1
        fd = jnp.where(x == 0, jnp.int32(D), D - 1 - msb // bits)
        return jnp.minimum(fd, jnp.minimum(offa, offb))

    l = init_l.astype(jnp.int32)
    live = active0
    for _ in range(2):
        rem = word(a + l, b + l)
        l = l + jnp.where(live, rem, 0)
        live = live & (rem >= D)

    n_live = jnp.sum(live.astype(jnp.int32))
    dst = jnp.cumsum(live.astype(jnp.int32)) - 1
    dst = jnp.where(live & (dst < M2), dst, M2)
    ah = jnp.zeros(M2, jnp.int32).at[dst].set(a, mode="drop")
    bh = jnp.zeros(M2, jnp.int32).at[dst].set(b, mode="drop")
    lh = jnp.zeros(M2, jnp.int32).at[dst].set(l, mode="drop")
    ph = jnp.full(M2, M, jnp.int32).at[dst].set(
        jnp.arange(M, dtype=jnp.int32), mode="drop")
    liveh = jnp.zeros(M2, bool).at[dst].set(live, mode="drop")

    def cond(st):
        i, lv, _ = st
        return (i < maxT) & jnp.any(lv)

    def body(st):
        i, lv, lc = st
        adv = jnp.zeros(M2, jnp.int32)
        done = ~lv
        for _ in range(4):
            rem = word(ah + lc + adv, bh + lc + adv)
            adv = adv + jnp.where(done, 0, rem)
            done = done | (rem < D)
        return i + 1, lv & ~done, lc + jnp.where(lv, adv, 0)

    _, _, lh = lax.while_loop(cond, body,
                              (jnp.int32(0), liveh, lh))
    l = l.at[jnp.where(ph < M, ph, M)].set(lh, mode="drop")
    overflow = n_live - jnp.sum((dst < M2).astype(jnp.int32))
    return l, overflow


def device_suf_lcp(text_dev, n: int, sigma: int):
    """Suffix sort + adjacent-pair LCP, all on device.

    Returns (sa [n], lcp [n] with lcp[0] = 0) as device int32 arrays
    (sentinel rank n excluded; callers append suftab[n] = n).
    """
    sa = device_suffix_sort(text_dev, n, sigma)
    bits, D = lce_pack_params(sigma)
    tables = _lce_tables(text_dev, n, bits, D)
    lcp_rest = device_lce_pairs(
        text_dev, n, sigma, sa[:-1], sa[1:], n - 1, tables=tables)
    lcp = jnp.concatenate([jnp.zeros(1, jnp.int32), lcp_rest])
    return sa, lcp


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------


def _text_sigma(text_np: np.ndarray, sigma: int | None) -> int:
    if sigma is not None:
        return int(sigma)
    regular = text_np[text_np < WILDCARD]
    return int(regular.max()) + 1 if regular.size else 1


def suffix_sort_host(text_np: np.ndarray, sigma: int | None = None):
    """(suftab[n+1], stitab[n+1]) as host int32 arrays (sentinel
    included, reference suftab conventions)."""
    n = int(text_np.size)
    if n > MAX_N:
        raise ValueError(
            f"input of {n} symbols exceeds the int32 rank limit "
            f"({MAX_N}); shard the text (parallel/shardesa) or split "
            "the input")
    if n == 0:
        return np.array([0], np.int32), np.array([0], np.int32)
    sa = device_suffix_sort(jnp.asarray(text_np), n,
                            _text_sigma(text_np, sigma))
    suftab = np.empty(n + 1, np.int32)
    suftab[:n] = np.asarray(sa)
    suftab[n] = n
    stitab = np.empty(n + 1, np.int32)
    stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    return suftab, stitab


def suf_lcp_host(text_np: np.ndarray, sigma: int | None = None):
    """(suftab[n+1], lcptab[n+1]) as host int32 arrays."""
    n = int(text_np.size)
    if n == 0:
        return np.array([0], np.int32), np.zeros(1, np.int32)
    sa, lcp = device_suf_lcp(jnp.asarray(text_np), n,
                             _text_sigma(text_np, sigma))
    suftab = np.empty(n + 1, np.int32)
    suftab[:n] = np.asarray(sa)
    suftab[n] = n
    lcptab = np.zeros(n + 1, np.int32)
    lcptab[1:n] = np.asarray(lcp)[1:]
    lcptab[n] = 0
    return suftab, lcptab


def lce_pairs_host(text_np: np.ndarray, a_np, b_np,
                   sigma: int | None = None) -> np.ndarray:
    """Vectorized lce over arbitrary suffix pairs (host in/out)."""
    n = int(text_np.size)
    m = int(np.asarray(a_np).size)
    if m == 0 or n == 0:
        return np.zeros(m, np.int32)
    out = device_lce_pairs(
        jnp.asarray(text_np), n, _text_sigma(text_np, sigma),
        jnp.asarray(np.asarray(a_np, np.int32)),
        jnp.asarray(np.asarray(b_np, np.int32)), m)
    return np.asarray(out)
