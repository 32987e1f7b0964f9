"""Device-path engines vs host oracles on the CPU backend.

The device routes (engine/repeats_dev.py, engine/mstats.py, the blocked
skip table) are plain JAX programs, so the CPU backend exercises the
identical code the GPU runs (minus the compiler target).  Routes are
pinned with core/route.py ``pinned``."""

import numpy as np
import pytest

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.core.route import pinned
from vstree_tpu.engine.mstats import matching_statistics
from vstree_tpu.engine.repeats import maximal_pairs_ref_order_vec
from vstree_tpu.engine.repeats_dev import maximal_pairs_device
from vstree_tpu.index.build import build_esa, skip_table


def _ms_of(text):
    m = Multiseq.__new__(Multiseq)
    m.sequence = text
    m.markpos = np.zeros(0, np.int64)
    m.totallength = int(text.size)
    m.numofsequences = 1
    m.descriptions = [b"t"]
    return m


@pytest.mark.parametrize("L", [3, 5, 8])
def test_repeats_device_matches_host(rng, L):
    text = random_dna_text(rng, 4000, n_wild=8, n_sep=3)
    esa = build_esa(_ms_of(text), dna_alphabet(),
                    demand=("suf", "lcp", "bwt", "bck", "sti"))
    d0, i0, j0 = maximal_pairs_ref_order_vec(esa, L)
    d1, i1, j1 = maximal_pairs_device(esa, L, ref_order=True)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(j0, j1)


def test_matching_statistics_vs_brute(rng):
    for trial in range(4):
        n = int(rng.integers(60, 200))
        nq = int(rng.integers(20, 90))
        text = random_dna_text(rng, n, n_wild=2, n_sep=1)
        qtext = random_dna_text(rng, nq, n_wild=1, n_sep=1)
        esa = build_esa(_ms_of(text), dna_alphabet(),
                        demand=("suf", "lcp", "bwt", "bck", "sti"))
        ms, wit = matching_statistics(esa, qtext)
        n, nq = text.size, qtext.size
        for p in range(nq):
            best = 0
            for s in range(n):
                l = 0
                while (p + l < nq and s + l < n
                       and text[s + l] == qtext[p + l]
                       and text[s + l] < 250):
                    l += 1
                best = max(best, l)
            assert ms[p] == best, (trial, p)
            if best > 0:
                # the witness realizes ms
                w = int(esa.suftab[wit[p]])
                got = 0
                while (p + got < nq and w + got < n
                       and text[w + got] == qtext[p + got]
                       and text[w + got] < 250):
                    got += 1
                assert got >= best, (trial, p)


def test_findmaxpref_device_vs_host(rng):
    """engine/querydev.py fused binary-search replay vs the host
    oracle (engine/query.py _findmaxpref_batch, itself parity-tested
    against the reference binary)."""
    from vstree_tpu.engine.query import _findmaxpref_batch
    from vstree_tpu.engine.querydev import findmaxpref_device
    from vstree_tpu.index.build import bucket_codes

    for trial in range(4):
        n = int(rng.integers(400, 1200))
        text = random_dna_text(rng, n, n_wild=4, n_sep=2)
        esa = build_esa(_ms_of(text), dna_alphabet(),
                        demand=("suf", "lcp", "bwt", "bck", "sti"))
        pl = esa.prefixlength
        # query = mutated copy => realistic long shared prefixes
        qtext = text.copy()
        mut = rng.integers(0, n, size=max(4, n // 30))
        qtext[mut] = rng.integers(0, 4, mut.size).astype(np.uint8)
        nq = int(qtext.size)
        qcodes, qvalid = bucket_codes(qtext, 4, pl)
        qpos = np.flatnonzero(qvalid == pl).astype(np.int64)
        codes = qcodes[qpos]
        bck = esa.bcktab
        bl = bck[2 * codes].astype(np.int64)
        br = bck[2 * codes + 1].astype(np.int64)
        keep = br > bl
        qpos = qpos[keep]
        bl, br = bl[keep], br[keep]
        qlen = np.int64(nq) - qpos
        off0 = np.full(qpos.size, pl, np.int64)
        h0, h1 = _findmaxpref_batch(
            text, n, esa.suftab.astype(np.int64), bl, br - 1, off0,
            qtext, qpos, qlen)
        d0, d1 = findmaxpref_device(
            esa, qtext, bl, br - 1, off0, qpos, qlen)
        np.testing.assert_array_equal(h0, d0, err_msg=str(trial))
        np.testing.assert_array_equal(h1, d1, err_msg=str(trial))
        # full-range lanes (qspeedup-5 shape: whole SA, offset 0)
        sub = qpos[:: max(1, qpos.size // 50)]
        m = sub.size
        rl = np.zeros(m, np.int64)
        rr = np.full(m, int(esa.suftab.size) - 2, np.int64)
        z = np.zeros(m, np.int64)
        h0, h1 = _findmaxpref_batch(
            text, n, esa.suftab.astype(np.int64), rl, rr, z, qtext,
            sub, np.int64(nq) - sub)
        d0, d1 = findmaxpref_device(
            esa, qtext, rl, rr, z, sub, np.int64(nq) - sub)
        np.testing.assert_array_equal(h0, d0, err_msg=str(trial))
        np.testing.assert_array_equal(h1, d1, err_msg=str(trial))


def test_query_self_async_pipeline_vs_host(rng):
    """find_query_mems_self_device (the chained-async db-vs-itself
    pipeline) vs the host state machine on identical workloads."""
    from vstree_tpu.engine.query import find_query_matches

    for trial in range(3):
        n = int(rng.integers(2000, 6000))
        text = random_dna_text(rng, n, n_wild=6, n_sep=3)
        ms = _ms_of(text)
        # rebuild a real Multiseq with markpos for pos_to_pair
        from vstree_tpu.core.chardef import SEPARATOR

        ms.markpos = np.flatnonzero(text == SEPARATOR).astype(np.int64)
        ms.numofsequences = ms.markpos.size + 1
        ms.descriptions = [b"s%d" % i for i in range(ms.numofsequences)]
        esa = build_esa(ms, dna_alphabet(),
                        demand=("suf", "lcp", "bwt", "bck", "sti"))
        L = int(rng.integers(max(esa.prefixlength, 5), 12))
        with pinned(True):
            dev = find_query_matches(esa, ms, L, "mem")
        with pinned(False):
            host = find_query_matches(esa, ms, L, "mem")
        assert len(dev.position1) == len(host.position1), trial
        for f in ("position1", "length1", "position2", "seqnum1",
                  "relpos1", "seqnum2", "relpos2"):
            np.testing.assert_array_equal(
                getattr(dev, f), getattr(host, f),
                err_msg=f"{trial}:{f}")


def test_edit_extension_device_vs_host(rng):
    """Device fronts + viability prefilter (gextend_dev
    edit_fronts_viable, including the fused no-sync slides) vs the
    host edit_fronts path: full extension output equality."""
    from vstree_tpu.engine.gextend import Seqs, edit_extend_seeds
    from vstree_tpu.engine.repeats import find_maximal_pairs_ref
    from vstree_tpu.stats.evalues import Evalues

    for trial in range(3):
        n = int(rng.integers(3000, 8000))
        text = random_dna_text(rng, n, n_wild=5, n_sep=2)
        # duplicated block => long seeds and deep slides
        blk = text[100:100 + n // 4].copy()
        text[n // 2:n // 2 + blk.size] = blk
        esa = build_esa(_ms_of(text), dna_alphabet(),
                        demand=("suf", "lcp", "bwt", "bck", "sti"))
        seeds = find_maximal_pairs_ref(esa, 10)
        if len(seeds) == 0:
            continue
        ev = Evalues(0.25)

        def run(device):
            with pinned(device):
                sq = Seqs(text, text)
                return edit_extend_seeds(sq, ev, seeds, 2, 30, 10,
                                         querycompare=False,
                                         selfmode=True)

        dev = run(True)
        host = run(False)
        assert len(dev.position1) == len(host.position1), trial
        for f in ("position1", "length1", "position2", "length2",
                  "distance"):
            np.testing.assert_array_equal(
                getattr(dev, f), getattr(host, f),
                err_msg=f"{trial}:{f}")


def test_skip_table_adversarial():
    cases = [
        np.concatenate([[0], np.full(5000, 7, np.int32), [0]]),
        np.concatenate([[0], np.arange(1, 3000, dtype=np.int32), [0]]),
        np.zeros(777, np.int32),
    ]
    st = np.tile(np.array([3, 3, 3, 3, 2, 5, 5, 5, 1], np.int32), 400)
    st[0] = 0
    st[-1] = 0
    cases.append(st)
    for lcp in cases:
        lcp = lcp.astype(np.int32)
        n = lcp.size
        got = skip_table(lcp)
        want = np.empty(n, np.int64)
        for i in range(n):
            j = i + 1
            while j < n and lcp[j] >= lcp[i]:
                j += 1
            want[i] = j - 1 if j < n else n - 1
        np.testing.assert_array_equal(got, want)


def test_edit_extend_self_device_vs_host(rng):
    """Fused seeds->extension (edit_extend_self_device: unordered
    device pair enumeration + survivor-only emission sort) vs the
    two-step host path: full output equality including order."""
    from vstree_tpu.engine.gextend import (
        Seqs,
        edit_extend_seeds,
        edit_extend_self_device,
    )
    from vstree_tpu.engine.repeats import find_maximal_pairs_ref
    from vstree_tpu.stats.evalues import Evalues

    for trial in range(3):
        n = int(rng.integers(3000, 8000))
        text = random_dna_text(rng, n, n_wild=5, n_sep=2)
        blk = text[100:100 + n // 4].copy()
        text[n // 2:n // 2 + blk.size] = blk
        esa = build_esa(_ms_of(text), dna_alphabet(),
                        demand=("suf", "lcp", "bwt", "bck", "sti"))
        ev = Evalues(0.25)
        sq = Seqs(text, text)
        with pinned(True):
            dev = edit_extend_self_device(esa, sq, ev, 2, 30, 10)
        with pinned(False):
            seeds = find_maximal_pairs_ref(esa, 10)
            host = edit_extend_seeds(Seqs(text, text), ev, seeds, 2, 30,
                                     10, querycompare=False,
                                     selfmode=True)
        if dev is None:
            continue
        assert len(dev.position1) == len(host.position1), trial
        for f in ("position1", "length1", "position2", "length2",
                  "distance"):
            np.testing.assert_array_equal(
                getattr(dev, f), getattr(host, f),
                err_msg=f"{trial}:{f}")
