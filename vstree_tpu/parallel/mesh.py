"""Multi-chip sharding of the ESA and its query algorithms.

Reference seams (SURVEY.md §2.7): the C code's only parallel hooks are
(1) ``DISTRIBUTEDDFS`` superbucket partitioning of the suffix-rank
range (reference include/vdfstrav.c:419-499, ``-numproc``) and (2) the
per-query independence of the matching loops (fquery.c:470-477).

Design: a 2-D ``jax.sharding.Mesh`` shaped by the algorithm (every
device reaches every other at the same rate, so no topology enters)
with axes

- ``sp`` (sequence/rank parallel): ``suftab`` is sharded into
  contiguous rank ranges — exactly the superbucket split, but by equal
  rank counts instead of bck codes.  Every shard answers "which of my
  ranks match?" locally; results merge with ``psum`` / ``pmin``
  collectives.
- ``dp`` (data parallel): the query batch is sharded; no communication
  along this axis at all.

The text itself is replicated (it is 1 byte/symbol, 8-64x smaller than
the tables; shards need random access to arbitrary windows).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.chardef import WILDCARD

_SPECIAL = 1 << 20


def make_mesh(devices=None, dp: int | None = None) -> Mesh:
    """(dp, sp) mesh over the given devices (default: all)."""
    devs = np.array(devices if devices is not None else jax.devices())
    n = devs.size
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    sp = n // dp
    return Mesh(devs[: dp * sp].reshape(dp, sp), ("dp", "sp"))


def _suffix_cmp(text, n, spos, pat, plen, maxplen):
    """Vectorized lexicographic relation sign(suffix_prefix - pattern)
    over the first ``plen`` pattern chars (same key scheme as
    engine/complete.py: past-end < regular < special-by-position)."""
    offs = jnp.arange(maxplen, dtype=jnp.int32)
    idx = spos[:, None] + offs[None, :]
    inb = idx < n
    ch = text[jnp.minimum(idx, n - 1)].astype(jnp.int32)
    # past-end == the sentinel: greater than every regular symbol and
    # ordered by position, exactly like other specials (suffix-sort
    # order: _doubling_round uses rank2 = n for out-of-range)
    skey = jnp.where(inb & (ch < WILDCARD), ch, _SPECIAL + idx)
    active = offs[None, :] < plen[:, None]
    diff = jnp.where(active, skey - pat, 0)
    nz = diff != 0
    first = jnp.argmax(nz, axis=1)
    anynz = jnp.any(nz, axis=1)
    d = jnp.take_along_axis(diff, first[:, None], axis=1)[:, 0]
    return jnp.where(anynz, jnp.sign(d), 0)


def _local_interval(text, suf_shard, patterns, plens, n, maxplen, nloc):
    """[lo, hi) bracket of pattern occurrences within one rank shard."""
    nsteps = max(1, int(np.ceil(np.log2(max(nloc, 2)))) + 1)
    # derive brackets from shard-varying inputs so the fori_loop carry
    # has consistent manual-axes metadata under shard_map
    zero = plens * 0 + (suf_shard[0] * 0).astype(jnp.int32)
    lo0 = zero
    hi0 = zero + nloc

    def lower(_, st):
        lo, hi = st
        open_ = lo < hi
        mid = (lo + hi) // 2
        rel = _suffix_cmp(text, n, suf_shard[mid].astype(jnp.int32),
                          patterns, plens, maxplen)
        lo = jnp.where(open_ & (rel < 0), mid + 1, lo)
        hi = jnp.where(open_ & (rel >= 0), mid, hi)
        return lo, hi

    def upper(_, st):
        lo, hi = st
        open_ = lo < hi
        mid = (lo + hi) // 2
        rel = _suffix_cmp(text, n, suf_shard[mid].astype(jnp.int32),
                          patterns, plens, maxplen)
        lo = jnp.where(open_ & (rel <= 0), mid + 1, lo)
        hi = jnp.where(open_ & (rel > 0), mid, hi)
        return lo, hi

    lo, _ = lax.fori_loop(0, nsteps, lower, (lo0, hi0))
    hi, _ = lax.fori_loop(0, nsteps, upper, (lo0, hi0))
    return lo, hi


def sharded_exact_match(
    mesh: Mesh,
    text: jax.Array,          # uint8[n] replicated
    suftab: jax.Array,        # int32[R] sharded over sp (R divisible)
    patterns: jax.Array,      # int32[B, maxplen], -1 padded, sharded dp
    plens: jax.Array,         # int32[B] sharded dp
):
    """Occurrence count and first global rank of each whole pattern.

    Device layout: suftab rank-sharded over ``sp`` (superbucket split),
    patterns sharded over ``dp``.  Per-shard local binary search, then
    a single psum/pmin pair over ``sp`` merges the rank ranges.
    Returns (counts int32[B], first_rank int32[B]; first_rank = R when
    the pattern does not occur).
    """
    n = int(text.size)
    R = int(suftab.size)
    maxplen = int(patterns.shape[1])
    nshards = mesh.shape["sp"]
    nloc = R // nshards

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

    return step(text, suftab, patterns, plens)


def doubling_round_sharded(mesh: Mesh, rank: jax.Array, k: int):
    """One prefix-doubling round of the suffix sort with the rank array
    laid out over the full mesh (build-time model parallelism: the
    global ``lax.sort`` becomes an XLA distributed sort).  Semantics
    identical to index.build._doubling_round.
    """
    n = int(rank.size)
    sharding = NamedSharding(mesh, P(("dp", "sp")))
    rank = jax.device_put(rank, sharding)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(rank):
        pos = jnp.arange(n, dtype=jnp.int32)
        r2 = jnp.where(pos + k < n, jnp.roll(rank, -k), jnp.int32(n))
        r1s, r2s, si = lax.sort((rank, r2, pos), num_keys=2,
                                is_stable=True)
        newgrp = jnp.concatenate([
            jnp.zeros(1, jnp.int32),
            ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])).astype(
                jnp.int32),
        ])
        dense = jnp.cumsum(newgrp)
        new_rank = jnp.zeros(n, jnp.int32).at[si].set(dense)
        return lax.with_sharding_constraint(new_rank, sharding), si

    return step(rank)


def full_step(mesh: Mesh, text, suftab, rank, patterns, plens, k: int):
    """The framework's "training step" analog: one sharded index-build
    round plus one sharded query-match round, jitted end to end."""
    new_rank, _ = doubling_round_sharded(mesh, rank, k)
    counts, first = sharded_exact_match(mesh, text, suftab, patterns,
                                        plens)
    return new_rank, counts, first
