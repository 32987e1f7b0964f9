"""Compile-cache prewarming: ``python -m vstree_tpu.prewarm [--bp N]``.

XLA compiles every (program, shape-class) pair it meets, and a fresh
machine pays that once before the first large index materializes
(compare the reference's one-time ``mkvtree`` build before ``vmatch``
can mmap, readvirt.c:776).  This module makes that cost an explicit
install step instead of a first-run surprise: it routes a synthetic
corpus of the requested size class through the suffix-sort/LCP core
and the main match engines with the persistent compilation cache
enabled, so every later process of this checkout starts warm.

The cache is keyed by shape class (index/sort.py pads round programs
to 1/8-octave sizes), so prewarm at the corpus size you will build;
several ``--bp`` values may be warmed in sequence.  The cache lives
where ``core/envconf.py`` ``configure_compile_cache`` puts it, the same
place the CLIs read.
"""

from __future__ import annotations

import argparse
import time


def prewarm(bp: int = 16_000_000, verbose: bool = True) -> None:
    from .core.envconf import configure_compile_cache

    cache_dir = configure_compile_cache()
    import jax

    import numpy as np

    import jax.numpy as jnp

    from .core.alphabet import dna_alphabet
    from .core.multiseq import Multiseq
    from .index.build import build_esa
    from .index.sort import device_suf_lcp

    def log(msg):
        if verbose:
            print(f"# prewarm: {msg}", flush=True)

    rng = np.random.default_rng(11)
    # repeat-rich synthetic DNA: tiled + mutated, so the doubling
    # loop visits the same deep-round shape classes as real genomes
    tile = rng.integers(0, 4, size=max(bp // 16, 4096)).astype(
        np.uint8)
    parts = []
    total = 0
    while total < bp:
        t = tile.copy()
        pos = rng.integers(0, t.size, size=max(t.size // 100, 1))
        t[pos] = rng.integers(0, 4, pos.size).astype(np.uint8)
        parts.append(t)
        total += t.size
    text = np.concatenate(parts)[:bp]
    n = int(text.size)
    log(f"corpus {n/1e6:.1f} Mbp, cache dir {cache_dir}")

    t0 = time.perf_counter()
    sa, lcp = device_suf_lcp(jnp.asarray(text), n, 4)
    jax.block_until_ready((sa, lcp))
    log(f"suffix sort + lcp compiled+ran in "
        f"{time.perf_counter() - t0:.1f} s")

    # engines at the same size class: build the full ESA and touch
    # the device query/repeat paths once
    ms = Multiseq(sequence=text, markpos=np.zeros(0, np.uint32))
    ms.numofsequences = 1
    ms.totallength = n
    t0 = time.perf_counter()
    esa = build_esa(ms, dna_alphabet(),
                    demand=("suf", "lcp", "bwt", "bck", "sti"))
    from .engine.query import find_query_matches
    from .engine.repeats import find_maximal_pairs_ref
    from .engine.supermax import find_supermax

    find_maximal_pairs_ref(esa, max(esa.prefixlength + 1, 12))
    find_supermax(esa, 20)
    find_query_matches(esa, ms, max(esa.prefixlength, 20), "mem")
    log(f"engines compiled+ran in {time.perf_counter() - t0:.1f} s")
    log("done — subsequent runs at this size class start warm")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vstree_tpu.prewarm",
        description="Populate the persistent XLA compile cache for a "
                    "corpus size class.")
    ap.add_argument("--bp", type=int, default=16_000_000,
                    help="corpus size to warm (symbols; default 16M)")
    args = ap.parse_args(argv)
    prewarm(args.bp)


if __name__ == "__main__":
    main()
