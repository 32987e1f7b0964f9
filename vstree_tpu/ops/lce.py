"""Batched longest-common-extension between two encoded texts.

Vectorized replacement for the reference's char-by-char COMPARE loops
(reference kurtz/maxpref.c:47-64): W-wide windowed comparisons on
device with geometric window growth, then a host finish for the few
deep stragglers.  Match rule everywhere: bytes equal AND regular —
special characters (wildcards, separators, past-the-end) never match
anything, including themselves (chardef semantics; maxpref.c
CHECKRETURN)."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core.chardef import WILDCARD


@functools.partial(jax.jit, static_argnames=("w", "na", "nb"))
def _lce_round(ta, tb, a, b, lce, active, w: int, na: int, nb: int):
    offs = jnp.arange(w, dtype=jnp.int32)
    ia = a[:, None] + lce[:, None] + offs
    ib = b[:, None] + lce[:, None] + offs
    va = ia < na
    vb = ib < nb
    ca = ta[jnp.minimum(ia, na - 1)]
    cb = tb[jnp.minimum(ib, nb - 1)]
    match = va & vb & (ca == cb) & (ca < WILDCARD)
    run = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)
    full = run == w
    lce = jnp.where(active, lce + run, lce)
    active = active & full
    return lce, active


def lce_two_texts(
    ta_np: np.ndarray,
    a_np: np.ndarray,
    tb_np: np.ndarray,
    b_np: np.ndarray,
    ta_dev=None,
    tb_dev=None,
) -> np.ndarray:
    """lce[i] = longest common extension of ta[a[i]..] vs tb[b[i]..].

    Host-windowed numpy compares: the texts stay host-resident.
    ``ta_dev``/``tb_dev`` are accepted for API compatibility.
    """
    na, nb = int(ta_np.size), int(tb_np.size)
    m = int(a_np.size)
    if m == 0:
        return np.zeros(0, np.int32)
    a = np.asarray(a_np, dtype=np.int64)
    b = np.asarray(b_np, dtype=np.int64)
    lce = np.zeros(m, np.int64)
    act = np.arange(m)
    w = 8          # most extensions stop within a few chars
    off = 0
    while act.size:
        offs = np.arange(w)
        ia = a[act][:, None] + off + offs[None, :]
        ib = b[act][:, None] + off + offs[None, :]
        va = ia < na
        vb = ib < nb
        ca = ta_np[np.minimum(ia, na - 1)]
        cb = tb_np[np.minimum(ib, nb - 1)]
        nomatch = ~(va & vb & (ca == cb) & (ca < WILDCARD))
        # leading run of matches = first mismatch index (w if none);
        # bool argmax beats the former int cumprod by ~10x
        full = ~nomatch.any(axis=1)
        run = np.where(full, w, np.argmax(nomatch, axis=1))
        lce[act] += run
        act = act[full]
        off += w
        if w < 1024:
            w *= 4
    return lce.astype(np.int32)


def lce_two_texts_device(
    ta_np: np.ndarray,
    a_np: np.ndarray,
    tb_np: np.ndarray,
    b_np: np.ndarray,
    ta_dev=None,
    tb_dev=None,
) -> np.ndarray:
    """Device variant of lce_two_texts (windowed gathers in device
    memory) — for device-resident texts at scales where host RAM is
    not an option.
    """
    na, nb = int(ta_np.size), int(tb_np.size)
    m = int(a_np.size)
    if m == 0:
        return np.zeros(0, np.int32)
    ta = ta_dev if ta_dev is not None else jnp.asarray(ta_np)
    tb = tb_dev if tb_dev is not None else jnp.asarray(tb_np)
    a = jnp.asarray(a_np, dtype=jnp.int32)
    b = jnp.asarray(b_np, dtype=jnp.int32)
    lce = jnp.zeros(m, jnp.int32)
    active = jnp.ones(m, bool)
    w = 32
    for _ in range(8):
        lce, active = _lce_round(ta, tb, a, b, lce, active, w, na, nb)
        n_active = int(jnp.sum(active))
        if n_active == 0:
            return np.asarray(lce)
        if n_active < max(1024, m // 256):
            break
        if w < 256:
            w *= 2
    lce_h = np.array(lce)
    act = np.asarray(active)
    for idx in np.flatnonzero(act):
        pa = int(a_np[idx]) + int(lce_h[idx])
        pb = int(b_np[idx]) + int(lce_h[idx])
        d = int(lce_h[idx])
        while (pa < na and pb < nb and ta_np[pa] == tb_np[pb]
               and ta_np[pa] < WILDCARD):
            pa += 1
            pb += 1
            d += 1
        lce_h[idx] = d
    return lce_h
