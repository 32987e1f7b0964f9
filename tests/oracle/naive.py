"""Brute-force host oracles implementing the reference semantics
directly from their specification (SURVEY.md Appendix A).  These are
deliberately simple O(n^2)-ish implementations used only to verify the
device implementations on small inputs — the differential-testing strategy
of the reference (Checkall.sh / Cmponl.sh / bmhcheck) re-hosted.
"""

from __future__ import annotations

import functools

import numpy as np

WILDCARD = 254
SEPARATOR = 255


def suffix_key(text: np.ndarray, i: int):
    """Infinite-string key for suffix i under the reference comparison
    rules: regular chars by code; special char at position p has value
    256+p (greater than any regular, ordered by position); the sentinel
    is a special at position n."""
    n = text.size
    out = []
    for p in range(i, n):
        c = int(text[p])
        out.append(256 + p if c >= WILDCARD else c)
        if c >= WILDCARD:
            break  # position-unique, nothing after can matter
    else:
        out.append(256 + n)  # sentinel
    return tuple(out)


def naive_suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array over ranks 0..n (includes sentinel suffix n)."""
    n = text.size
    keys = [suffix_key(text, i) for i in range(n)] + [(256 + n,)]
    order = sorted(range(n + 1), key=lambda i: keys[i])
    return np.array(order, dtype=np.int32)


def naive_lcp(text: np.ndarray, i: int, j: int) -> int:
    n = text.size
    d = 0
    while i + d < n and j + d < n:
        a, b = int(text[i + d]), int(text[j + d])
        if a != b or a >= WILDCARD:
            break
        d += 1
    return d


def naive_lcp_table(text: np.ndarray, suftab: np.ndarray) -> np.ndarray:
    n = text.size
    lcp = np.zeros(n + 1, np.int32)
    for r in range(1, n + 1):
        lcp[r] = naive_lcp(text, int(suftab[r - 1]), int(suftab[r]))
    return lcp


def naive_exact_occurrences(text: np.ndarray, pattern: np.ndarray) -> list[int]:
    """All start positions where pattern occurs exactly (regular chars
    only; specials never match)."""
    n, m = text.size, pattern.size
    out = []
    for p in range(n - m + 1):
        seg = text[p : p + m]
        if np.array_equal(seg, pattern) and not (seg >= WILDCARD).any():
            out.append(p)
    return out


def naive_hamming_occurrences(
    text: np.ndarray, pattern: np.ndarray, k: int
) -> list[tuple[int, int]]:
    """(pos, distance) for occurrences with <= k mismatches; specials
    always mismatch."""
    n, m = text.size, pattern.size
    out = []
    for p in range(n - m + 1):
        seg = text[p : p + m]
        if (seg == SEPARATOR).any():
            continue
        mism = int(((seg != pattern) | (seg >= WILDCARD)).sum())
        if mism <= k:
            out.append((p, mism))
    return out


@functools.lru_cache(maxsize=None)
def _edist_cached(t: bytes, p: bytes) -> int:
    return edit_distance(np.frombuffer(t, np.uint8), np.frombuffer(p, np.uint8))


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Unit-cost edit distance; special chars never match."""
    la, lb = a.size, b.size
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            eq = a[i - 1] == b[j - 1] and a[i - 1] < WILDCARD
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (0 if eq else 1)
            )
        prev = cur
    return int(prev[lb])


def naive_edit_occurrences(
    text: np.ndarray, pattern: np.ndarray, k: int
) -> set[tuple[int, int, int]]:
    """Approximate complete matches under edit distance: set of
    (start, length, dist) with dist <= k, where text[start:start+length]
    has edit distance dist from the pattern.  Enumerates all substrings
    with length within [m-k, m+k]."""
    n, m = text.size, pattern.size
    out = set()
    for start in range(n):
        for length in range(max(0, m - k), min(n - start, m + k) + 1):
            seg = text[start : start + length]
            if (seg >= WILDCARD).any():
                continue
            d = edit_distance(seg, pattern)
            if d <= k:
                out.add((start, length, d))
    return out


def naive_supermax_repeats(text: np.ndarray, minlen: int) -> set[tuple[int, ...]]:
    """Supermaximal repeats as (length, pos...) tuples: maximal repeats
    not contained in any other maximal repeat.  Brute force: for every
    repeated substring w (by length desc), check that w occurs >= 2
    times and is not a substring of an already-collected supermax."""
    n = text.size
    found: list[tuple[int, tuple[int, ...]]] = []
    # collect all repeated substrings w with occurrence lists
    seen: dict[bytes, list[int]] = {}
    for i in range(n):
        for l in range(minlen, n - i + 1):
            seg = text[i : i + l]
            if (seg >= WILDCARD).any():
                break
            seen.setdefault(seg.tobytes(), []).append(i)
    results = set()
    repeated = {w: ps for w, ps in seen.items() if len(ps) >= 2}
    for w, ps in repeated.items():
        lw = len(w)
        # supermaximal: no longer repeated substring contains w
        contained = False
        for w2, ps2 in repeated.items():
            if len(w2) > lw and w in w2:
                contained = True
                break
        if not contained:
            results.add((lw, tuple(sorted(ps))))
    return results
