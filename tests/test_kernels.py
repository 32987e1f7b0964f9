"""Device programs against plain references: the Myers verifier
against the textbook edit-distance table, the exact interval lookup
and its word tables against brute-force text scans, the windowed
region verification against the whole-text cutoff scan.  ``-m gpu``
runs chip_smoke.py at a small size on a card."""

import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import REPO, random_dna_text, repeat_rich_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.chardef import SEPARATOR, WILDCARD
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine.approx import _eqs_matrix, _verify_edit
from vstree_tpu.index.build import build_esa


def _dp_oracle(text, pat, s, L):
    """(minsc, bestlen, bestsc) by the textbook edit-distance table of
    the pattern against every window prefix text[s:s+j], j <= L: the
    score stops counting at the first SEPARATOR, bestlen is the longest
    prefix whose score is <= every earlier one, a pattern WILDCARD never
    matches."""
    n, m = text.size, pat.size
    col = np.arange(m + 1)
    minsc = bestsc = m
    bestlen = 0
    sep = False
    for j in range(L):
        c = int(text[s + j]) if s + j < n else SEPARATOR
        sep = sep or c == SEPARATOR
        new = np.empty_like(col)
        new[0] = j + 1
        for i in range(1, m + 1):
            hit = pat[i - 1] < WILDCARD and pat[i - 1] == c
            new[i] = min(col[i] + 1, new[i - 1] + 1,
                         col[i - 1] + (0 if hit else 1))
        col = new
        if not sep:
            minsc = min(minsc, col[m])
            if bestsc >= col[m]:
                bestsc, bestlen = col[m], j + 1
    return minsc, bestlen, bestsc


def _check_verifier(text, pats, cand, qidx, L):
    n = text.size
    plens = np.array([p.size for p in pats], np.int32)
    eqs = _eqs_matrix(pats, int(plens.max()))
    got = _verify_edit(
        jnp.asarray(text), jnp.asarray(cand, dtype=jnp.int32),
        jnp.asarray(qidx, dtype=jnp.int32), jnp.asarray(eqs),
        jnp.asarray(plens), eqs.shape[1], L, n)
    got = np.stack([np.asarray(x) for x in got], axis=1)
    want = [_dp_oracle(text, pats[q], s, L) for s, q in zip(cand, qidx)]
    np.testing.assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("plen", list(range(1, 33)) + [33, 47, 64])
def test_myers_verify_pattern_lengths(plen):
    """Every single-word pattern length and a few two-word ones,
    candidates at random offsets (some within plen of the text end) of
    a text with wildcards and separators."""
    rng = np.random.default_rng(plen)
    n = 600
    text = random_dna_text(rng, n, n_wild=3, n_sep=6)
    pats = [rng.integers(0, 4, plen).astype(np.uint8) for _ in range(3)]
    pats[2][plen // 2] = 254      # a pattern wildcard never matches
    # plant copies so low scores occur
    for p in pats:
        at = int(rng.integers(0, n - plen))
        text[at:at + plen] = p
    cand = rng.integers(0, n, 300)
    qidx = rng.integers(0, len(pats), 300)
    _check_verifier(text, pats, cand, qidx, plen + 2)


@pytest.mark.parametrize("sep_at", [0, 1, 15, 31, 32, 33])
def test_myers_verify_separator_positions(sep_at):
    """A SEPARATOR at a fixed column of every window cuts both the
    minimum score and the longest match (esaapm.c:266-269)."""
    rng = np.random.default_rng(100 + sep_at)
    pat = rng.integers(0, 4, 32).astype(np.uint8)
    reps = 40
    text = np.concatenate([np.concatenate([pat, rng.integers(0, 4, 8)])
                           for _ in range(reps)]).astype(np.uint8)
    starts = np.arange(reps) * 40
    text[np.minimum(starts + sep_at, text.size - 1)] = SEPARATOR
    _check_verifier(text, [pat], starts, np.zeros(reps, np.int64), 34)


def _esa_of(text):
    ms = Multiseq(sequence=text, markpos=np.flatnonzero(
        text == SEPARATOR).astype(np.int64))
    ms.totallength = int(text.size)
    return build_esa(ms, dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"))


@pytest.mark.parametrize("minlen,maxlen", [(12, 36), (4, 12)])
def test_exact_interval_lookup_vs_brute_force(minlen, maxlen):
    """Fast-path lookup (deep bucket + window count) against a
    brute-force scan: sampled, mutated and wildcard-carrying patterns,
    a batch that is not a multiple of the padding quantum.  Short
    patterns give shallow buckets whose window is wider than the key
    coverage."""
    from vstree_tpu.engine.complete import RankLookupPlan, \
        exact_interval_lookup

    rng = np.random.default_rng(11)
    n = 30_000
    text = repeat_rich_text(rng, n, n_wild=12)
    text[rng.choice(n, 5, replace=False)] = SEPARATOR
    esa = _esa_of(text)
    B = 1500
    plens = rng.integers(minlen, maxlen + 1, B).astype(np.int32)
    pats = np.full((B, maxlen), -1, np.int32)
    for i in range(B):
        s = int(rng.integers(0, n - maxlen))
        pats[i, :plens[i]] = text[s:s + plens[i]]
        if i % 5 == 0:              # mostly absent
            pats[i, plens[i] - 1] = (pats[i, plens[i] - 1] + 1) % 4
        if i % 97 == 0:             # wildcard: never matches
            pats[i, 3] = 254
    plan = RankLookupPlan(esa, int(plens.min()), maxlen)
    assert plan.ok and B % 1024
    assert (plan.W > plan.coverage) == (minlen < 12)
    lo, hi = exact_interval_lookup(esa, pats, plens)
    windows = {m: np.lib.stride_tricks.sliding_window_view(text, m)
               for m in np.unique(plens)}
    for i in range(B):
        m = int(plens[i])
        p = pats[i, :m]
        if (p >= 4).any():
            assert hi[i] == lo[i], i
            continue
        occ = np.flatnonzero((windows[m] == p).all(axis=1))
        assert hi[i] - lo[i] == occ.size, i
        np.testing.assert_array_equal(
            np.sort(esa.suftab[lo[i]:hi[i]]), occ, err_msg=str(i))


@pytest.mark.parametrize("depth", [0, 5, 11])
def test_rank_words_vs_host_packing(depth):
    """Device word tables == a direct host packing of each suffix's
    chars (saturating to sigma from the first special or the end)."""
    rng = np.random.default_rng(depth)
    text = random_dna_text(rng, 5000, n_wild=20, n_sep=7)
    esa = _esa_of(text)
    n, sigma, cpw = text.size, 4, esa.chars_per_word()
    idx = esa.suftab.astype(np.int64)[:, None] + depth + np.arange(2 * cpw)
    ch = np.where(idx < n, text[np.minimum(idx, n - 1)], 255).astype(
        np.int64)
    dig = np.where(np.maximum.accumulate(ch >= sigma, axis=1), sigma, ch)
    want = [np.zeros(idx.shape[0], np.int64) for _ in range(2)]
    for j in range(2 * cpw):
        want[j // cpw] = want[j // cpw] * (sigma + 1) + dig[:, j]
    got = esa.rank_words(depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_region_verification_vs_whole_text_scan():
    """Per-region windowed cutoff scans == the whole-text scan with
    region resets and masks (the splitesaapm replay)."""
    from vstree_tpu.engine.approx import _verify_regions

    rng = np.random.default_rng(5)
    n = 3000
    text = random_dna_text(rng, n, n_sep=4)
    pats = [rng.integers(0, 4, int(rng.integers(8, 20))).astype(np.uint8)
            for _ in range(5)]
    for p in pats:
        for _ in range(3):
            at = int(rng.integers(0, n - p.size))
            text[at:at + p.size] = p
    plens = np.array([p.size for p in pats], np.int32)
    k = 2
    merged = {}
    for qi in range(len(pats)):
        cuts = np.sort(rng.choice(n, 8, replace=False))
        merged[qi] = [(int(a), int(min(n - 1, a + rng.integers(10, 60))))
                      for a in cuts[::2]]
        merged[qi] = [r for j, r in enumerate(merged[qi])
                      if j == 0 or r[0] > merged[qi][j - 1][1] + 1]
    q, pos = _verify_regions(text, pats, plens, merged, k)
    want_q, want_p = _whole_text_regions(text, pats, plens, merged, k)
    assert len(want_q) > 0
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(pos, want_p)


def _whole_text_regions(text, pats, plens, merged, k):
    """(qidx, pos) of the region verification by one whole-text cutoff
    scan per query with region resets and masks."""
    from vstree_tpu.engine.online import _ukkonen_cutoff_scan

    n = text.size
    M = int(plens.max())
    resets = np.zeros((n, len(pats)), bool)
    inreg = np.zeros((n, len(pats)), bool)
    patrev = np.full((len(pats), M + 2), -7, np.int32)
    for qi, p in enumerate(pats):
        patrev[qi, 1:p.size + 1] = p[::-1]
        for a, b in merged[qi]:
            resets[n - 1 - b, qi] = True
            inreg[n - 1 - b:n - a, qi] = True
    emits = np.asarray(_ukkonen_cutoff_scan(
        jnp.asarray(text[::-1].copy()), jnp.asarray(patrev),
        jnp.asarray(plens), M, k, resets=jnp.asarray(resets),
        inregion=jnp.asarray(inreg)))
    want_q, want_p = [], []
    for qi in range(len(pats)):
        for a, b in merged[qi]:
            rows = np.flatnonzero(emits[n - 1 - b:n - a, qi])
            want_q += [qi] * rows.size
            want_p += list(b - rows)
    return want_q, want_p


@pytest.mark.parametrize("cells", [1 << 24, 1 << 10])
def test_region_verification_long_region_among_short(monkeypatch, cells):
    """One long merged region (a planted tandem repeat) among many short
    ones: the short lanes are not padded to its length, no scan exceeds
    the cell budget, and the result equals the whole-text scan."""
    from vstree_tpu.engine import approx, online

    rng = np.random.default_rng(8)
    n = 4000
    text = random_dna_text(rng, n, n_sep=3)
    unit = rng.integers(0, 4, 7).astype(np.uint8)
    text[1000:2500] = np.tile(unit, 215)[:1500]
    pats = [np.tile(unit, 3)[:18].copy()]
    pats += [rng.integers(0, 4, 16).astype(np.uint8) for _ in range(3)]
    plens = np.array([p.size for p in pats], np.int32)
    k = 1
    merged = {0: [(990, 2510), (3100, 3130)]}
    for qi in range(1, len(pats)):
        cuts = np.sort(rng.choice(np.arange(2600, n - 40, 45), 8,
                                  replace=False))
        merged[qi] = [(int(a), int(a) + 33) for a in cuts]
        for a in cuts[:3]:              # plant copies inside regions
            text[a + 5:a + 5 + plens[qi]] = pats[qi]
    shapes = []
    scan = online._ukkonen_cutoff_scan

    def spy(window, *a, **kw):
        shapes.append(window.shape)
        return scan(window, *a, **kw)

    monkeypatch.setattr(online, "_ukkonen_cutoff_scan", spy)
    monkeypatch.setattr(approx, "_REGION_CELLS", cells)
    q, pos = approx._verify_regions(text, pats, plens, merged, k)
    M = int(plens.max())
    assert all(s * r <= max(cells, s + M + 2) for s, r in shapes), shapes
    lanes = sum(len(v) for v in merged.values())
    assert sum(s * r for s, r in shapes) < lanes * 1521 // 4
    want_q, want_p = _whole_text_regions(text, pats, plens, merged, k)
    assert (np.asarray(want_q) == 0).sum() > 100
    assert (np.asarray(want_q) > 0).sum() > 0
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(pos, want_p)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    """chip_smoke.py at 2 Mbp on a card: every phase on the device
    route, checked against its reference."""
    r = subprocess.run([sys.executable, "chip_smoke.py", "--bp",
                        "2000000"], capture_output=True, text=True,
                       env=gpu_env, cwd=REPO, timeout=1200)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert '"ok": true' in r.stdout.splitlines()[-1]
