"""Sharded ESA construction and sharded match engines.

This is the framework's real multi-chip layer (SURVEY.md §2.7/§7): the
reference's only distribution seams are the superbucket partitioning
of the suffix-rank range (reference include/vdfstrav.c:419-499,
``-numproc``) and per-query independence (fquery.c:470-477).  Here:

- **Sharded index build**: the prefix-doubling sort
  (index/build.py:_suffix_sort_device) runs with every O(n) array laid
  out over the device mesh; ``lax.sort`` becomes an XLA distributed
  sort, the re-ranking scans become sharded scans, and XLA inserts the
  collectives.  The LCP pass is embarrassingly pair-parallel and is
  sharded the same way.
- **Sharded supermax** (reference fsuper.c:61-165): reformulated as a
  pure scan/gather program over the lcp/bwt arrays — run detection by
  cummax forward/backward fills, left-context distinctness by per-char
  previous-occurrence scans — so it shards over ranks with no host
  loop and no traversal.
- **Sharded complete-match lookup**: rank-range (superbucket) sharded
  binary search; the global interval of a pattern is contiguous in
  rank space, so a psum/pmin pair restores the exact monolithic
  ``[lo, hi)`` and the match records are bit-identical.

Shard-vs-monolith equality (the mirror of the reference's
bin/Checkmergeesa.sh test) is enforced by tests/test_parallel.py and
the driver dryrun.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.chardef import WILDCARD
from ..core.route import note
from .mesh import _local_interval, make_mesh


def flat_spec(mesh: Mesh) -> NamedSharding:
    """1-D layout over every device of the (dp, sp) mesh."""
    return NamedSharding(mesh, P(("dp", "sp")))


# ---------------------------------------------------------------------------
# sharded suffix sort (index build)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _sharded_sort_fn(n: int, mesh: Mesh):
    spec = flat_spec(mesh)

    @jax.jit
    def fn(text):
        pos = jnp.arange(n, dtype=jnp.int32)
        pos = lax.with_sharding_constraint(pos, spec)
        key = jnp.where(text >= WILDCARD, 256 + pos, text.astype(jnp.int32))
        sk, si = lax.sort((key, pos), num_keys=1, is_stable=True)
        newgrp = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), (sk[1:] != sk[:-1]).astype(jnp.int32)]
        )
        dense = jnp.cumsum(newgrp)
        rank0 = jnp.zeros(n, jnp.int32).at[si].set(dense)
        rank0 = lax.with_sharding_constraint(rank0, spec)

        def cond(st):
            _, _, maxrank, k = st
            return (maxrank < n - 1) & (k < 2 * n)

        def body(st):
            rank, si, _, k = st
            pos = jnp.arange(n, dtype=jnp.int32)
            r2 = jnp.where(pos + k < n, jnp.roll(rank, -k), jnp.int32(n))
            r1s, r2s, si = lax.sort((rank, r2, pos), num_keys=2,
                                    is_stable=True)
            newgrp = jnp.concatenate([
                jnp.zeros(1, jnp.int32),
                ((r1s[1:] != r1s[:-1])
                 | (r2s[1:] != r2s[:-1])).astype(jnp.int32),
            ])
            dense = jnp.cumsum(newgrp)
            new_rank = jnp.zeros(n, jnp.int32).at[si].set(dense)
            new_rank = lax.with_sharding_constraint(new_rank, spec)
            si = lax.with_sharding_constraint(si, spec)
            return new_rank, si, dense[-1], k * 2

        _, si, _, _ = lax.while_loop(cond, body,
                                     (rank0, si, dense[-1], jnp.int32(1)))
        return si

    return fn


def suffix_sort_sharded(
    text_np: np.ndarray, mesh: Mesh
) -> tuple[np.ndarray, np.ndarray]:
    """suffix_sort with all O(n) arrays sharded over the mesh.

    Same contract and identical output as index.build.suffix_sort.
    """
    n = int(text_np.size)
    if n == 0:
        return np.array([0], np.int32), np.array([0], np.int32)
    ndev = int(np.prod(list(mesh.shape.values())))
    npad = ((n + ndev - 1) // ndev) * ndev
    if npad != n:
        # pad with SEPARATOR chars: specials order by *position*, so
        # every pad suffix sorts after every real suffix and the first
        # n sorted entries are exactly the real suffix order
        text_np = np.concatenate(
            [text_np, np.full(npad - n, 255, np.uint8)]
        )
    text = jax.device_put(jnp.asarray(text_np), flat_spec(mesh))
    si = _sharded_sort_fn(npad, mesh)(text)
    suftab = np.empty(n + 1, np.int32)
    suftab[:n] = np.asarray(si)[:n]
    suftab[n] = n
    stitab = np.empty(n + 1, np.int32)
    stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    return suftab, stitab


# ---------------------------------------------------------------------------
# sharded supermax (scan/gather formulation of fsuper.c)
# ---------------------------------------------------------------------------


def _flat_mesh(mesh: Mesh) -> Mesh:
    """1-axis view ("x") over all devices of a mesh."""
    return Mesh(np.asarray(mesh.devices).reshape(-1), ("x",))


@functools.lru_cache(maxsize=32)
def _supermax_flags_sharded_fn(n1p: int, L: int, sigma: int, fmesh: Mesh):
    """shard_map build of _supermax_flags: every global scan becomes a
    local scan + an S-scalar all_gather prefix combine; every shift
    becomes a 1-element ppermute halo.  This is the distributed-scan
    formulation of the reference's superbucket DFS split
    (vdfstrav.c:419-499): per-shard O(n/S) work, O(S) communication.
    """
    S = fmesh.shape["x"]
    Lloc = n1p // S
    fwd = [(i, i + 1) for i in range(S - 1)]
    bwd = [(i + 1, i) for i in range(S - 1)]
    if 2 * n1p >= 2 ** 31:
        raise ValueError(
            "sharded supermax: index range exceeds the int32 bit-pack "
            "(n must be < 2^30 per invocation)"
        )

    def cumsum_g(x):
        loc = jnp.cumsum(x)
        tots = lax.all_gather(loc[-1], "x")
        me = lax.axis_index("x")
        prefix = jnp.sum(jnp.where(jnp.arange(S) < me, tots, 0))
        return loc + prefix

    def cummax_g(x):
        loc = lax.cummax(x)
        tots = lax.all_gather(loc[-1], "x")
        me = lax.axis_index("x")
        lowest = jnp.iinfo(x.dtype).min
        prefix = jnp.max(jnp.where(jnp.arange(S) < me, tots, lowest))
        return jnp.maximum(loc, prefix.astype(x.dtype))

    def rcummax_g(x):
        loc = lax.cummax(x[::-1])[::-1]
        tots = lax.all_gather(loc[0], "x")
        me = lax.axis_index("x")
        lowest = jnp.iinfo(x.dtype).min
        suffix = jnp.max(jnp.where(jnp.arange(S) > me, tots, lowest))
        return jnp.maximum(loc, suffix.astype(x.dtype))

    def shift_right(x, fill):
        """y[i] = x[i-1] globally; y[0] = fill."""
        prev = lax.ppermute(x[-1:], "x", fwd)
        me = lax.axis_index("x")
        first = jnp.where(me == 0, jnp.asarray(fill, x.dtype), prev[0])
        return jnp.concatenate([first[None], x[:-1]])

    def shift_left(x, fill):
        """y[i] = x[i+1] globally; y[n-1] = fill."""
        nxt = lax.ppermute(x[:1], "x", bwd)
        me = lax.axis_index("x")
        last = jnp.where(me == S - 1, jnp.asarray(fill, x.dtype), nxt[0])
        return jnp.concatenate([x[1:], last[None]])

    def fill_bit_fwd(mark, bit):
        """Forward fill of a boolean from marked positions (requires a
        mark at global position 0, which run-start structure gives)."""
        i = lax.axis_index("x") * Lloc + jnp.arange(Lloc, dtype=jnp.int32)
        key = jnp.where(mark, i * 2 + bit.astype(jnp.int32),
                        jnp.int32(-1))
        f = cummax_g(key)
        return (f % 2) == 1

    def seg_cumsum_g(x, reset):
        """Inclusive segmented cumsum: restart the sum AT each reset
        position (that position contributes its own x)."""

        def comb(a, b):
            s1, r1 = a
            s2, r2 = b
            return jnp.where(r2, s2, s1 + s2), r1 | r2

        s_loc, r_loc = lax.associative_scan(comb, (x, reset))
        tots = lax.all_gather(s_loc[-1], "x")
        anyr = lax.all_gather(r_loc[-1], "x")
        me = lax.axis_index("x")
        carry = jnp.zeros((), x.dtype)
        for s in range(S):  # S static, left fold of shard carries
            use = s < me
            ncarry = jnp.where(anyr[s], tots[s], carry + tots[s])
            carry = jnp.where(use, ncarry, carry)
        return jnp.where(r_loc, s_loc, s_loc + carry)

    @jax.jit
    @functools.partial(
        shard_map, mesh=fmesh,
        in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x"), P("x")),
    )
    def flags(lcp, bwt):
        me = lax.axis_index("x")
        i = (me * Lloc + jnp.arange(Lloc, dtype=jnp.int32))
        lcp = lcp.astype(jnp.int32)
        prev = shift_right(lcp, jnp.int32(0))
        nxt = shift_left(lcp, jnp.int32(-1))
        rs = (i == 0) | (lcp != prev)
        re_ = (i == n1p - 1) | (nxt != lcp)
        start_rising = rs & (i > 0) & (lcp > prev)
        end_falling = re_ & (nxt < lcp)
        # forward fill of start_rising from run starts
        sr_run = fill_bit_fwd(rs, start_rising)
        # backward fill of end_falling from run ends: pack reversed idx
        rkey = jnp.where(
            re_,
            (jnp.int32(n1p - 1) - i) * 2 + end_falling.astype(jnp.int32),
            jnp.int32(-1),
        )
        rf = rcummax_g(rkey)
        ef_run = (rf % 2) == 1
        cand = sr_run & ef_run & (lcp >= L)
        cand_start = cand & rs
        cand_end = cand & re_
        # interval over ranks: [s-1 .. e] for candidate run [s .. e]
        open_ = shift_left(cand_start, False)
        close = cand_end
        copen = cumsum_g(open_.astype(jnp.int32))
        cclose = cumsum_g(close.astype(jnp.int32))
        cclose_excl = shift_right(cclose, jnp.int32(0))
        member = (copen - cclose_excl) >= 1
        istart = cummax_g(jnp.where(open_, i, jnp.int32(-1)))
        # distinctness: repeated regular bwt char within one interval
        bad = jnp.zeros(Lloc, dtype=bool)
        bwt_i = bwt.astype(jnp.int32)
        for c in range(sigma):
            occ = member & (bwt_i == c)
            inc = cummax_g(jnp.where(occ, i, jnp.int32(-1)))
            prev_occ = shift_right(inc, jnp.int32(-1))
            bad = bad | (occ & (prev_occ >= istart))
        # per-interval badness: segmented cumsum restarting at opens
        segbad = seg_cumsum_g(bad.astype(jnp.int32), open_)
        ok = segbad == 0
        return close, istart, ok

    return flags


@functools.partial(jax.jit, static_argnames=("L", "sigma", "n1"))
def _supermax_flags(lcp, bwt, L: int, sigma: int, n1: int):
    """Per-rank flags of supermaximal intervals.

    Returns (close, istart, ok): rank ``e`` carries ``close`` when a
    candidate interval [istart[e] .. e] of depth lcp[e] ends there and
    ``ok`` when its regular left-context characters are pairwise
    distinct (fsuper.c:75-124 semantics).  Pure elementwise +
    cumsum/cummax program — shards over ranks with XLA-inserted
    collectives for the scans.
    """
    i = jnp.arange(n1, dtype=jnp.int32)
    prev = jnp.concatenate([lcp[:1], lcp[:-1]])     # lcp[i-1]
    nxt = jnp.concatenate([lcp[1:], lcp[-1:]])      # lcp[i+1]
    rs = (i == 0) | (lcp != prev)                   # run start (lcp idx)
    re_ = (i == n1 - 1) | (nxt != lcp)              # run end (lcp idx)
    start_rising = rs & (i > 0) & (lcp > prev)
    end_falling = re_ & ((i == n1 - 1) | (nxt < lcp))
    run_start_idx = lax.cummax(jnp.where(rs, i, -1))
    rev_key = jnp.where(re_, n1 - 1 - i, -1)
    run_end_idx = n1 - 1 - lax.cummax(rev_key[::-1])[::-1]
    cand = (start_rising[run_start_idx] & end_falling[run_end_idx]
            & (lcp >= L))
    cand_start = cand & rs
    cand_end = cand & re_
    # interval over ranks: [s-1 .. e] for candidate run [s..e]
    open_ = jnp.concatenate([cand_start[1:],
                             jnp.zeros(1, dtype=bool)])
    close = cand_end
    copen = jnp.cumsum(open_.astype(jnp.int32))
    cclose = jnp.cumsum(close.astype(jnp.int32))
    cclose_excl = jnp.concatenate([jnp.zeros(1, jnp.int32), cclose[:-1]])
    member = (copen - cclose_excl) >= 1
    istart = lax.cummax(jnp.where(open_, i, -1))
    # distinctness: a repeated regular bwt char within one interval
    bad = jnp.zeros(n1, dtype=bool)
    bwt_i = bwt.astype(jnp.int32)
    for c in range(sigma):
        occ = member & (bwt_i == c)
        occ_idx = jnp.where(occ, i, -1)
        prev_occ = jnp.concatenate(
            [jnp.full(1, -1, jnp.int32), lax.cummax(occ_idx)[:-1]]
        )
        bad = bad | (occ & (prev_occ >= istart))
    badcum = jnp.cumsum(bad.astype(jnp.int32))
    base = jnp.where(istart > 0, badcum[jnp.maximum(istart - 1, 0)], 0)
    ok = (badcum - base) == 0
    return close, istart, ok


def supermax_intervals_sharded(
    esa, searchlength: int, mesh: Mesh | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, depth) of supermaximal intervals — identical output
    to engine.supermax.supermax_intervals, computed by the sharded scan
    program (device does the O(n) work; the host only compacts)."""
    lcp_np = esa.lcptab.astype(np.int32)
    bwt_np = esa.bwttab
    n1 = int(lcp_np.size)
    if mesh is not None:
        fmesh = _flat_mesh(mesh)
        ndev = fmesh.shape["x"]
        n1p = ((n1 + ndev - 1) // ndev) * ndev
        if n1p != n1:
            # pad lcp with -1: matches the monolith's virtual
            # next_val = -1 after the last run (no spurious intervals,
            # last real run still ends falling)
            lcp_np = np.concatenate(
                [lcp_np, np.full(n1p - n1, -1, np.int32)]
            )
            bwt_np = np.concatenate(
                [bwt_np, np.full(n1p - n1, 255, np.uint8)]
            )
        spec = NamedSharding(fmesh, P("x"))
        lcp = jax.device_put(jnp.asarray(lcp_np), spec)
        bwt = jax.device_put(jnp.asarray(bwt_np), spec)
        fn = _supermax_flags_sharded_fn(
            n1p, max(searchlength, 1), esa.alpha.num_regular, fmesh
        )
        close, istart, ok = fn(lcp, bwt)
    else:
        lcp = jnp.asarray(lcp_np)
        bwt = jnp.asarray(bwt_np)
        close, istart, ok = _supermax_flags(
            lcp, bwt, max(searchlength, 1), esa.alpha.num_regular, n1
        )
    close = np.asarray(close)[:n1]
    e = np.flatnonzero(close)
    left = np.asarray(istart)[e].astype(np.int64)
    right = e.astype(np.int64)
    depth = esa.lcptab[e].astype(np.int64)
    keep = np.asarray(ok)[e]
    return left[keep], right[keep], depth[keep]


# ---------------------------------------------------------------------------
# sharded complete-match interval lookup + records
# ---------------------------------------------------------------------------


def exact_interval_lookup_sharded(
    esa, patterns: np.ndarray, plens: np.ndarray, mesh: Mesh
) -> tuple[np.ndarray, np.ndarray]:
    """Rank interval [lo, hi) of whole patterns via superbucket-sharded
    binary search.  Bit-identical to engine.complete's monolithic
    exact_interval_lookup (the occurrence set of a pattern is one
    contiguous rank interval, so psum of local counts + pmin of local
    first ranks restores it exactly)."""
    note("exact lookup", "device")
    B, maxplen = patterns.shape
    n = int(esa.totallength)
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    R = ((n + 1 + sp - 1) // sp) * sp
    suf_pad = np.full(R, n, np.int32)
    suf_pad[: n + 1] = esa.suftab
    Bp = ((B + dp - 1) // dp) * dp
    pat_pad = np.full((Bp, maxplen), -1, np.int32)
    pat_pad[:B] = patterns
    plen_pad = np.zeros(Bp, np.int32)
    plen_pad[:B] = plens

    counts, first = _sharded_lookup_fn(mesh, n, R, maxplen)(
        jnp.asarray(esa.multiseq.sequence),
        jnp.asarray(suf_pad),
        jnp.asarray(pat_pad),
        jnp.asarray(plen_pad),
    )
    counts = np.asarray(counts)[:B].astype(np.int64)
    first = np.asarray(first)[:B].astype(np.int64)
    lo = np.where(counts > 0, first, 0)
    hi = lo + np.where(counts > 0, counts, 0)
    # clamp to the real rank range (padded sentinel ranks never match
    # a regular pattern: their key is position-ordered special)
    return lo.astype(np.int64), np.minimum(hi, n + 1).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _sharded_lookup_fn(mesh: Mesh, n: int, R: int, maxplen: int):
    sp = mesh.shape["sp"]
    nloc = R // sp

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("sp"), P("dp", None), P("dp")),
        out_specs=(P("dp"), P("dp")),
    )
    def step(text, suf_shard, pats, pl):
        lo, hi = _local_interval(text, suf_shard, pats, pl, n, maxplen,
                                 nloc)
        cnt = jnp.maximum(hi - lo, 0)
        base = lax.axis_index("sp") * nloc
        first = jnp.where(cnt > 0, base + lo, R)
        total = lax.psum(cnt, "sp")
        first = lax.pmin(first, "sp")
        return total, first

    return step


def sharded_exact_match_records(
    mesh: Mesh,
    text: jax.Array,          # uint8[n] replicated
    suftab: jax.Array,        # int32[R] sharded over sp (R divisible)
    patterns: jax.Array,      # int32[B, maxplen], -1 padded, dp-sharded
    plens: jax.Array,         # int32[B] dp-sharded
    cap: int,
):
    """Full match records on device: per-shard interval expansion into a
    ``cap``-bounded buffer of (global rank, text position), all-gathered
    over the rank shards.  Returns

    - counts  int32[B]           total occurrences per pattern
    - ranks   int32[S, B, cap]   global ranks, shard-major (= ascending
                                 global rank order, the reference
                                 emission order, exactcompl.c:156-164)
    - pos     int32[S, B, cap]   text positions (suftab[rank])
    - shard_counts int32[S, B]   per-shard counts (overflow detection:
                                 shard_counts > cap ⇒ re-fetch on host)
    """
    n = int(text.size)
    R = int(suftab.size)
    maxplen = int(patterns.shape[1])
    sp = mesh.shape["sp"]
    nloc = R // sp

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("sp"), P("dp", None), P("dp")),
        out_specs=(P("dp"), P(None, "dp", None), P(None, "dp", None),
                   P(None, "dp")),
        check_vma=False,
    )
    def step(text, suf_shard, pats, pl):
        lo, hi = _local_interval(text, suf_shard, pats, pl, n, maxplen,
                                 nloc)
        cnt = jnp.maximum(hi - lo, 0)
        base = lax.axis_index("sp") * nloc
        k = jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = k < cnt[:, None]
        local_rank = jnp.minimum(lo[:, None] + k, nloc - 1)
        ranks = jnp.where(valid, base + lo[:, None] + k, jnp.int32(-1))
        pos = jnp.where(valid, suf_shard[local_rank], jnp.int32(-1))
        total = lax.psum(cnt, "sp")
        ranks_all = lax.all_gather(ranks, "sp")      # [S, Bloc, cap]
        pos_all = lax.all_gather(pos, "sp")
        cnt_all = lax.all_gather(cnt, "sp")          # [S, Bloc]
        return total, ranks_all, pos_all, cnt_all

    return step(text, suftab, patterns, plens)


# ---------------------------------------------------------------------------
# -numproc plumbing
# ---------------------------------------------------------------------------


def numproc_mesh(numproc: int) -> Mesh:
    """Mesh over the first ``numproc`` devices (reference -numproc,
    parsevm.c:877 / vdfstrav.c:419-499: distribute the rank range to
    p processors)."""
    devs = jax.devices()
    if numproc > len(devs):
        raise SystemExit(
            f"vmatch: -numproc {numproc} exceeds the {len(devs)} "
            "available devices"
        )
    return make_mesh(devs[:numproc])
