"""Multi-index merge (mergeesa analog): merging k separately built
part indexes must reproduce the monolithic index of their
SEPARATOR-joined concatenation (reference bin/Checkmergeesa.sh splits
a database, merges, and compares against the direct build)."""

import numpy as np
import pytest

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq, read_multiseq
from vstree_tpu.index.build import build_esa, suffix_sort
from vstree_tpu.index.merge import merge_indexes


def _part(text: np.ndarray):
    ms = Multiseq(sequence=text, markpos=np.zeros(0, np.int64))
    ms.totallength = int(text.size)
    return build_esa(ms, dna_alphabet(), demand=("suf",))


def _oracle(texts):
    cat = []
    for i, t in enumerate(texts):
        cat.append(t)
        if i < len(texts) - 1:
            cat.append(np.full(1, 255, np.uint8))
    gtext = np.concatenate(cat)
    suf, _ = suffix_sort(gtext)
    return np.asarray(suf, np.int64), gtext


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_monolithic(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 5))
    texts = []
    for _ in range(k):
        n = int(rng.integers(40, 3000))
        t = rng.integers(0, 4, n).astype(np.uint8)
        # sprinkle wildcards so the global special-position
        # interleaving (wildcards vs joining separators) is exercised
        t[rng.choice(n, max(1, n // 150), replace=False)] = 254
        texts.append(t)
    suf_o, gtext_o = _oracle(texts)
    suf_m, gtext_m = merge_indexes([_part(t) for t in texts])
    assert np.array_equal(gtext_o, gtext_m)
    assert np.array_equal(suf_o, suf_m)


def test_merge_real_data_split():
    """Three-way split of a seeded repeat-rich 30 kbp text."""
    from conftest import repeat_rich_text

    t = repeat_rich_text(np.random.default_rng(8), 30000, families=8,
                         n_wild=4)
    cuts = [0, 9000, 17000, 30000]
    texts = [t[cuts[i]:cuts[i + 1]] for i in range(3)]
    suf_o, _ = _oracle(texts)
    suf_m, _ = merge_indexes([_part(x) for x in texts])
    assert np.array_equal(suf_o, suf_m)
