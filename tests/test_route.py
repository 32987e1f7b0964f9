"""Device policy (core/route.py), compile-cache placement
(core/envconf.py), the suffix-sort snapshot budget and the capped
LCE ladder (index/sort.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import REPO
from vstree_tpu.core import route


def test_cpu_backend_takes_host_route():
    assert jax.default_backend() == "cpu"
    assert route.use_device("maximal repeats") is False


@pytest.mark.parametrize("device", [True, False])
def test_pinned_route_nests_and_restores(device):
    with route.pinned(device):
        assert route.use_device("t") is device
        with route.pinned(not device):
            assert route.use_device("t") is (not device)
        assert route.use_device("t") is device
    assert route.use_device("t") is False


def test_route_decisions_are_logged():
    route.use_device("before")              # outside: not recorded
    with route.recorded() as taken:
        with route.pinned(True):
            route.use_device("supermax")
        route.use_device("query matches")
        route.note("exact lookup", "binary search")
        with route.recorded() as inner:
            route.use_device("inner")
    route.use_device("after")
    assert taken == [("supermax", "device"), ("query matches", "host"),
                     ("exact lookup", "binary search")]
    assert inner == [("inner", "host")]


def test_exact_lookup_records_its_path():
    """The window count records the device route; a pattern longer
    than the key coverage takes the binary search and records it."""
    from conftest import random_dna_text
    from vstree_tpu.core.alphabet import dna_alphabet
    from vstree_tpu.core.multiseq import Multiseq
    from vstree_tpu.engine.complete import exact_interval_lookup
    from vstree_tpu.index.build import build_esa

    text = random_dna_text(np.random.default_rng(3), 5000)
    ms = Multiseq(sequence=text, markpos=np.zeros(0, np.int64))
    ms.totallength = text.size
    esa = build_esa(ms, dna_alphabet(), demand=("suf", "bck", "sti"))
    for m, path in ((20, "device"), (100, "binary search")):
        pats = np.stack([text[i:i + m] for i in (0, 700, 2100)]).astype(
            np.int32)
        with route.recorded() as taken:
            lo, hi = exact_interval_lookup(esa, pats,
                                           np.full(3, m, np.int32))
        assert taken == [("exact lookup", path)], m
        assert ((hi - lo) >= 1).all()


def test_engines_follow_the_pinned_route(rng):
    """find_supermax: host scan and device scan program agree, and each
    records its route."""
    from conftest import repeat_rich_text
    from vstree_tpu.core.alphabet import dna_alphabet
    from vstree_tpu.core.multiseq import Multiseq
    from vstree_tpu.engine.supermax import find_supermax
    from vstree_tpu.index.build import build_esa

    text = repeat_rich_text(rng, 20_000, n_wild=5)
    ms = Multiseq(sequence=text, markpos=np.zeros(0, np.int64))
    ms.totallength = text.size
    esa = build_esa(ms, dna_alphabet(), demand=("suf", "lcp", "bwt"))
    with route.recorded() as taken:
        with route.pinned(True):
            dev = find_supermax(esa, 12)
        with route.pinned(False):
            host = find_supermax(esa, 12)
    assert taken == [("supermax", "device"), ("supermax", "host")]
    assert len(dev) == len(host) > 0
    for f in ("position1", "position2", "length1"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(host, f))


def _cache_dir_of(env):
    code = ("from vstree_tpu.core.envconf import configure_compile_cache;"
            "import jax; d = configure_compile_cache();"
            "assert d == jax.config.jax_compilation_cache_dir; print(d)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd="/", timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip()


def test_compile_cache_env_var_used_as_given(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    assert _cache_dir_of(env) == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_compile_cache_default_is_fixed_inside_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    first = _cache_dir_of(env)
    assert first == os.path.join(REPO, ".jax_cache", "cpu")
    assert _cache_dir_of(env) == first


def test_snapshot_budget_without_memory_stats():
    from vstree_tpu.index.sort import HOST_SNAPSHOT_BUDGET, snapshot_budget

    assert jax.devices()[0].memory_stats() is None
    assert snapshot_budget() == HOST_SNAPSHOT_BUDGET


def test_capped_snapshot_ladder_gives_exact_lce():
    """A ladder capped at ks = [10, 20, 40, 80] must still return the
    exact LCEs 164-175: lanes that can advance past the ladder's reach
    are finished by the windowed ladder."""
    from vstree_tpu.index.sort import (
        _lce_tables,
        device_suffix_sort,
        lce_pack_params,
        lce_with_snapshots,
    )

    rng = np.random.default_rng(9)
    n = 4000
    text = rng.integers(0, 4, n).astype(np.uint8)
    p, q = 500, 2500
    text[q:q + 200] = text[p:p + 200]
    text[q + 175] = (text[p + 175] + 1) % 4
    _, snaps = device_suffix_sort(jnp.asarray(text), n, 4,
                                  collect_snapshots=True)
    capped = [s for s in snaps if s[0] <= 80]
    assert [k for k, _ in capped] == [10, 20, 40, 80]
    bits, D = lce_pack_params(4)
    P = _lce_tables(jnp.asarray(text), n, bits, D)
    a = np.arange(p, p + 12, dtype=np.int32)
    b = a + (q - p)
    got = np.asarray(lce_with_snapshots(capped, P, jnp.asarray(a),
                                        jnp.asarray(b), n, 4))
    want = [175 - i for i in range(12)]
    np.testing.assert_array_equal(got, want)
