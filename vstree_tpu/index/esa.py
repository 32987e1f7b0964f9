"""Enhanced suffix array (ESA) container.

Array analog of the reference ``Virtualtree`` struct
(reference: src/include/virtualdef.h:186-219).  Differences by design:

- tables are flat arrays (int32 ranks, uint8 text) in device memory rather
  than memory-mapped byte files; the 1-byte lcp + exception-pair
  encoding of the reference (virtualdef.h:121-136) exists only in the
  on-disk serialization (:mod:`vstree_tpu.index.io`), in memory lcp is
  plain int32,
- the suffix array covers ranks ``0..n`` where rank ``n`` holds the
  sentinel suffix at position ``n`` (the sentinel orders *after* every
  other suffix, matching the reference's "$ is greater than every
  symbol" convention, remainsort.c:73-127),
- ``bwttab[r] = text[suftab[r]-1]`` with ``UNDEFBWTCHAR`` at the rank
  of suffix 0 (reference kurtz/bwtcode.c:293-311).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from ..core.alphabet import Alphabet
from ..core.multiseq import Multiseq

# Table bits, mirroring the demand bitmask of virtualdef.h:24-98.
TISTAB = 1 << 0
SUFTAB = 1 << 1
LCPTAB = 1 << 2
BWTTAB = 1 << 3
BCKTAB = 1 << 4
STITAB = 1 << 5
OISTAB = 1 << 6
STI1TAB = 1 << 7
SKPTAB = 1 << 8
DESTAB = 1 << 9
SSPTAB = 1 << 10
LLVTAB = 1 << 11


@dataclass
class ESA:
    """Enhanced suffix array over an encoded Multiseq.

    All big tables are NumPy arrays host-side; device placement happens
    in the engine layer (arrays are moved to the device once per session and
    reused across queries).
    """

    multiseq: Multiseq
    alpha: Alphabet
    suftab: np.ndarray          # int32[n+1], suffix start positions by rank
    lcptab: np.ndarray | None = None   # int32[n+1], lcp with previous rank
    bwttab: np.ndarray | None = None   # uint8[n+1]
    bcktab: np.ndarray | None = None   # uint32[2*numofcodes] (left, mid)
    stitab: np.ndarray | None = None   # int32[n+1], inverse of suftab
    skptab: np.ndarray | None = None   # int32[n+1]
    prefixlength: int = 0
    longest: int = 0            # rank of suffix 0
    maxbranchdepth: int = 0
    largelcpvalues: int = 0     # count of lcp values >= 255 (for .prj)
    indexname: str = ""
    _device_cache: dict[str, Any] = field(default_factory=dict, repr=False)
    _aux_bck: dict[int, np.ndarray] = field(default_factory=dict, repr=False)
    _rank_keys: dict[tuple, Any] = field(default_factory=dict, repr=False)

    @property
    def totallength(self) -> int:
        return self.multiseq.totallength

    @property
    def numofcodes(self) -> int:
        return (self.alpha.num_regular ** self.prefixlength
                if self.prefixlength > 0 else 0)

    @property
    def text(self) -> np.ndarray:
        return self.multiseq.sequence

    def device(self, name: str):
        """Return table ``name`` as a device array, cached."""
        import jax.numpy as jnp

        if name not in self._device_cache:
            host = {
                "text": self.text,
                "suftab": self.suftab,
                "lcptab": self.lcptab,
                "bwttab": self.bwttab,
                "stitab": self.stitab,
                "skptab": self.skptab,
            }[name]
            if host is None:
                raise ValueError(f"table {name} not built")
            self._device_cache[name] = jnp.asarray(host)
        return self._device_cache[name]

    def key_bits(self) -> int:
        """Bits per char in packed rank keys: regular codes 1..σ,
        saturation code (1<<bits)-1 strictly above them."""
        import math

        return max(3, math.ceil(math.log2(self.alpha.num_regular + 2)))

    def rank_keys(self, depth: int, levels: int):
        """Packed comparison keys per suffix rank (device array,
        cached): ``keys[lv][r]`` packs chars
        ``text[suftab[r]+depth+lv*cpk : +cpk]`` at ``key_bits`` bits
        each (regular char c -> c+1; specials and past-the-end
        saturate to the max code from their first occurrence onward,
        which keeps keys monotone over ranks).  One int32 gather then
        replaces a cpk-char window gather in batched searches."""
        import jax.numpy as jnp

        key = (depth, levels)
        if key not in self._rank_keys:
            bits = self.key_bits()
            cpk = 30 // bits
            W = levels * cpk
            n = self.totallength
            text = self.text
            starts = self.suftab.astype(np.int64)
            R = starts.size
            out = np.zeros((levels, R), np.int32)
            maxcode = (1 << bits) - 1
            chunk = 1 << 21
            for c0 in range(0, R, chunk):
                st = starts[c0 : c0 + chunk, None]
                idx = st + depth + np.arange(W)[None, :]
                inb = idx < n
                ch = text[np.minimum(idx, max(n - 1, 0))].astype(np.int32)
                special = (~inb) | (ch >= 250)  # WILDCARD
                sat = np.maximum.accumulate(special, axis=1)
                code = np.where(sat, maxcode, ch + 1)
                for lv in range(levels):
                    k = np.zeros(st.size, np.int64)
                    for j in range(cpk):
                        k = (k << bits) | code[:, lv * cpk + j]
                    out[lv, c0 : c0 + chunk] = k.astype(np.int32)
            self._rank_keys[key] = jnp.asarray(out)
        return self._rank_keys[key]

    def chars_per_word(self) -> int:
        """Chars per base-(sigma+1) packed key word: the largest e with
        (sigma+1)**e < 2**31 (13 for DNA, 7 for protein)."""
        base = self.alpha.num_regular + 1
        e = 1
        while base ** (e + 1) < (1 << 31):
            e += 1
        return e

    def rank_words(self, depth: int):
        """Packed comparison-word tables for the exact rank lookup
        (engine/complete.py ``_device_rank_lookup``): two flat device
        int32 arrays where index r holds the base-(σ+1) Horner packing
        of chars ``text[suftab[r]+depth+j]`` for j in [0, cpw) (word 1)
        and [cpw, 2*cpw) (word 2).  Digits: regular char c -> c; from
        the first special char or past-the-end onwards every digit
        saturates to σ (keeps words monotone over ranks — specials
        order by position, which within equal words is the rank order
        itself).  Built on the device; cached."""
        key = ("words", depth)
        if key not in self._rank_keys:
            self._rank_keys[key] = _rank_words(
                self.device("text"), self.device("suftab"), depth,
                self.alpha.num_regular, self.chars_per_word())
        return self._rank_keys[key]

    def aux_bck(self, depth: int) -> np.ndarray:
        """Bucket table at an arbitrary prefix depth (auxiliary, never
        serialized).  Deeper-than-prefixlength buckets shrink the
        batched binary searches to O(1) probes: device memory traded
        for fewer dependent gathers."""
        if depth not in self._aux_bck:
            from .build import bck_table

            self._aux_bck[depth] = bck_table(
                self.text, self.alpha.num_regular, depth
            )
        return self._aux_bck[depth]

    def aux_bck_maxwidth(self, depth: int) -> int:
        """Maximal bucket width of the depth-d bucket table (bounds
        the binary-search step count); cached."""
        k = ("maxw", depth)
        if k not in self._aux_bck:
            bck = self.aux_bck(depth)
            left = bck[0::2].astype(np.int64)
            mid = bck[1::2].astype(np.int64)
            self._aux_bck[k] = int(np.max(mid - left)) if left.size else 0
        return self._aux_bck[k]

    def aux_bck_device(self, depth: int):
        import jax.numpy as jnp

        k = ("aux_bck", depth)
        if k not in self._device_cache:
            self._device_cache[k] = jnp.asarray(self.aux_bck(depth))
        return self._device_cache[k]


@functools.partial(jax.jit, static_argnames=("depth", "sigma", "cpw"))
def _rank_words(text, suftab, depth: int, sigma: int, cpw: int):
    """Device body of :meth:`ESA.rank_words`."""
    n = text.shape[0]
    base = sigma + 1
    sat = jnp.zeros(suftab.shape, bool)
    words = []
    for half in range(2):
        w = jnp.zeros(suftab.shape, jnp.int32)
        for j in range(half * cpw, (half + 1) * cpw):
            idx = suftab + (depth + j)
            ch = text[jnp.minimum(idx, n - 1)].astype(jnp.int32)
            sat = sat | (idx >= n) | (ch >= sigma)
            w = w * base + jnp.where(sat, sigma, ch)
        words.append(w)
    return words[0], words[1]
