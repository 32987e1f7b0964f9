"""Esastream analog: block-streamed index consumption equals the
in-RAM engines at every block size (the reference's
ESASTREAMACCESS/vmatfind-strm capability, esastream.h:34-45)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, repeat_rich_text, write_fasta

ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


@pytest.fixture(scope="module")
def idx(tmp_path_factory):
    """Index of a seeded 100 kbp repeat-rich corpus in 4 sequences."""
    tmp = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(100)
    text = repeat_rich_text(rng, 100_000, families=12, n_wild=20)
    fa = write_fasta(tmp / "c.fna", np.array_split(text, 4))
    subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkvtree", "-db", fa,
         "-dna", "-pl", "-allout", "-indexname", str(tmp / "idx")],
        check=True, capture_output=True, env=ENV, cwd=str(tmp))
    return str(tmp / "idx")


@pytest.mark.parametrize("bs", [977, 8192, 1 << 20])
def test_stream_l_runs(idx, bs):
    from vstree_tpu.engine.repeats import _l_runs
    from vstree_tpu.index.io import read_index
    from vstree_tpu.index.stream import ESAStream, stream_l_runs

    esa = read_index(idx, demand=("suf", "lcp", "bwt"))
    for L in (8, 20):
        want = list(zip(*_l_runs(esa.lcptab, L))) or []
        with ESAStream(idx, blocksize=bs) as st:
            got = list(stream_l_runs(st, L))
        assert got == [(int(a), int(b)) for a, b in want], (bs, L)


@pytest.mark.parametrize("bs", [977, 8192, 1 << 20])
def test_stream_supermax(idx, bs):
    from vstree_tpu.engine.supermax import supermax_intervals
    from vstree_tpu.index.io import read_index
    from vstree_tpu.index.stream import (
        ESAStream,
        stream_supermax_intervals,
    )

    esa = read_index(idx, demand=("suf", "lcp", "bwt"))
    for L in (12, 20, 30):
        wl, wr, wd = supermax_intervals(esa, L)
        want = list(zip(wl.tolist(), wr.tolist(), wd.tolist()))
        with ESAStream(idx, blocksize=bs) as st:
            got = list(stream_supermax_intervals(st, L, 4))
        assert got == want, (bs, L, got[:3], want[:3])


def test_stream_memory_is_bounded(idx):
    # the reader never materializes more than a block per table
    from vstree_tpu.index.stream import ESAStream

    with ESAStream(idx, blocksize=1024) as st:
        for rank0, suf, lcp, bwt in st.blocks():
            for arr in (suf, lcp, bwt):
                assert arr is None or arr.size <= 1024


def test_out_of_core_build_matches_monolithic(tmp_path):
    """Device-memory-bounded shard build + mergeesa-analog merge ==
    monolithic index (the 'index larger than device memory' capability
    at reduced scale), on three seeded sequences in three files."""
    from vstree_tpu.core.alphabet import dna_alphabet
    from vstree_tpu.core.multiseq import read_multiseq
    from vstree_tpu.index.build import build_esa, build_suf_out_of_core

    alpha = dna_alphabet()
    rng = np.random.default_rng(7)
    files = [write_fasta(tmp_path / f"f{i}.fna",
                         [repeat_rich_text(rng, m, n_wild=3)])
             for i, m in enumerate((190_000, 66_000, 73_000))]
    ms = read_multiseq(files, alpha)
    mono = build_esa(ms, alpha, demand=("suf", "lcp"))
    suf, lcp = build_suf_out_of_core(ms, alpha, max_shard_bp=80_000)
    np.testing.assert_array_equal(mono.suftab, suf)
    np.testing.assert_array_equal(mono.lcptab, lcp)


def test_encodedsequence_roundtrip(rng=None):
    import numpy as np

    from vstree_tpu.core.encseq import Encodedsequence

    r = np.random.default_rng(5)
    for n in (0, 1, 5, 63, 64, 1000):
        t = r.integers(0, 4, n).astype(np.uint8)
        if n > 10:
            t[r.choice(n, max(1, n // 37), replace=False)] = \
                r.choice([254, 255], max(1, n // 37))
        enc = Encodedsequence(t)
        assert np.array_equal(enc.decode(), t)
        if n >= 10:
            assert enc.nbytes < t.nbytes  # ~4x packing
            for (a, b) in ((0, 5), (3, 9), (1, n), (n - 7, n)):
                assert np.array_equal(enc.decode(a, b), t[a:b]), (a, b)
    # non-2-bit alphabet falls back to direct storage
    prot = r.integers(0, 20, 100).astype(np.uint8)
    enc = Encodedsequence(prot)
    assert np.array_equal(enc.decode(), prot)
