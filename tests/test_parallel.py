"""Shard-vs-monolith equality tests (mirror of the reference's
bin/Checkmergeesa.sh differential pattern) for the multi-chip layer
(vstree_tpu/parallel/shardesa.py): sharded suffix sort, sharded LCP,
sharded supermax scan, superbucket-sharded complete-match lookup, and
byte-identical `-numproc` CLI output at 1 Mbp."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import REPO, random_dna_text, repeat_rich_text, write_fasta
from vstree_tpu.index.build import build_esa, lcp_table, suffix_sort
from vstree_tpu.parallel.mesh import make_mesh, sharded_exact_match
from vstree_tpu.parallel.shardesa import (
    exact_interval_lookup_sharded,
    sharded_exact_match_records,
    suffix_sort_sharded,
    supermax_intervals_sharded,
)

REF_VMATCH = os.path.join(REPO, ".ref-build/src/Vmatch/vmatch.x")


def _mk_esa(text):
    from vstree_tpu.core.alphabet import dna_alphabet
    from vstree_tpu.core.multiseq import Multiseq

    ms = Multiseq(sequence=text, markpos=np.zeros(0, np.int64))
    ms.totallength = int(text.size)
    return build_esa(ms, dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"))


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_exact_match_counts(rng, ndev):
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    n = 64 * ndev
    text = random_dna_text(rng, n, n_wild=2)
    suftab, _ = suffix_sort(text)
    mesh = make_mesh(jax.devices()[:ndev])
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    R = ((n + 1 + sp - 1) // sp) * sp
    suf_pad = np.full(R, n, np.int32)
    suf_pad[: n + 1] = suftab

    maxplen = 10
    B = 8 * dp
    plens = rng.integers(4, maxplen + 1, size=B).astype(np.int32)
    patterns = np.full((B, maxplen), -1, np.int32)
    for i in range(B):
        s = int(rng.integers(0, n - maxplen))
        patterns[i, : plens[i]] = text[s : s + plens[i]].astype(np.int32)

    counts, first = sharded_exact_match(
        mesh, jnp.asarray(text), jnp.asarray(suf_pad),
        jnp.asarray(patterns), jnp.asarray(plens),
    )
    counts = np.asarray(counts)
    first = np.asarray(first)

    # oracle: naive scan over all positions
    for i in range(B):
        p = patterns[i, : plens[i]]
        occ = [
            s for s in range(n - plens[i] + 1)
            if (text[s : s + plens[i]].astype(np.int32) == p).all()
            and (text[s : s + plens[i]] < 250).all()
        ]
        assert counts[i] == len(occ), (i, p)
        if occ:
            # first = min global rank among occurrences
            st = suf_pad[: n + 1]
            ranks = sorted(
                r for r in range(n + 1) if st[r] in occ
            )
            assert first[i] == ranks[0]


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_suffix_sort_and_lcp(rng, ndev):
    """Sharded doubling sort + sharded LCP == monolith, non-divisible
    sizes, wildcards/separators included."""
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    n = 50_001  # deliberately not divisible by ndev
    text = random_dna_text(rng, n, n_wild=17, n_sep=5)
    mesh = make_mesh(jax.devices()[:ndev])
    suf0, sti0 = suffix_sort(text)
    suf1, sti1 = suffix_sort_sharded(text, mesh)
    assert np.array_equal(suf0, suf1)
    assert np.array_equal(sti0, sti1)
    lcp0 = lcp_table(text, suf0)
    lcp1 = lcp_table(text, suf1, mesh=mesh)
    assert np.array_equal(lcp0, lcp1)


@pytest.fixture(scope="module")
def at1mb_esa():
    """ESA of a seeded 1 Mbp repeat-rich corpus."""
    text = repeat_rich_text(np.random.default_rng(1), 1_000_000,
                            families=40, n_wild=50)
    return _mk_esa(text)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_supermax_at1mb(at1mb_esa, ndev):
    """Sharded supermax scan == monolith on the 1 Mbp corpus."""
    from vstree_tpu.engine.supermax import supermax_intervals

    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    mesh = make_mesh(jax.devices()[:ndev])
    for L in (15, 25):
        a = supermax_intervals(at1mb_esa, L)
        b = supermax_intervals_sharded(at1mb_esa, L, mesh)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_interval_lookup_at1mb(rng, at1mb_esa, ndev):
    """Superbucket-sharded lookup == monolith on 1 Mbp."""
    from vstree_tpu.engine.complete import exact_interval_lookup

    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    esa = at1mb_esa
    n = esa.totallength
    text = esa.multiseq.sequence
    B, maxplen = 64, 24
    plens = rng.integers(8, maxplen + 1, size=B).astype(np.int32)
    patterns = np.full((B, maxplen), -1, np.int32)
    for i in range(B):
        s = int(rng.integers(0, n - maxplen))
        patterns[i, : plens[i]] = text[s : s + plens[i]]
    lo0, hi0 = exact_interval_lookup(esa, patterns.copy(), plens.copy())
    mesh = make_mesh(jax.devices()[:ndev])
    lo1, hi1 = exact_interval_lookup_sharded(esa, patterns, plens, mesh)
    assert np.array_equal(np.asarray(lo0, np.int64), lo1)
    assert np.array_equal(np.asarray(hi0, np.int64), hi1)


def test_sharded_records_rank_order(rng):
    """Device-side record expansion: ranks in global (reference
    emission) order, positions = suftab[rank]."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    n = 4096
    text = random_dna_text(rng, n, n_wild=4)
    esa = _mk_esa(text)
    mesh = make_mesh(jax.devices()[:4])
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    R = ((n + 1 + sp - 1) // sp) * sp
    suf_pad = np.full(R, n, np.int32)
    suf_pad[: n + 1] = esa.suftab
    B, maxplen, cap = 8 * dp, 10, 64
    plens = rng.integers(5, maxplen + 1, size=B).astype(np.int32)
    patterns = np.full((B, maxplen), -1, np.int32)
    for i in range(B):
        s = int(rng.integers(0, n - maxplen))
        patterns[i, : plens[i]] = text[s : s + plens[i]]
    counts, ranks, pos, shard_counts = sharded_exact_match_records(
        mesh, jnp.asarray(text), jnp.asarray(suf_pad),
        jnp.asarray(patterns), jnp.asarray(plens), cap,
    )
    counts = np.asarray(counts)
    ranks = np.asarray(ranks)
    pos = np.asarray(pos)
    shard_counts = np.asarray(shard_counts)
    from vstree_tpu.engine.complete import exact_interval_lookup

    lo, hi = exact_interval_lookup(esa, patterns.copy(), plens.copy())
    assert (counts == (hi - lo)).all()
    for b in range(B):
        assert (shard_counts[:, b] <= cap).all()
        got = [int(r) for s in range(ranks.shape[0])
               for r in ranks[s, b] if r >= 0]
        assert got == list(range(int(lo[b]), int(hi[b])))
        gpos = [int(p) for s in range(pos.shape[0])
                for p in pos[s, b] if p >= 0]
        assert gpos == [int(esa.suftab[r]) for r in got]


needs_ref = pytest.mark.skipif(
    not os.path.exists(REF_VMATCH), reason="reference binaries not built"
)


@pytest.fixture(scope="module")
def at1mb_cli(tmp_path_factory):
    """Our index over a seeded 1 Mbp corpus on disk + a query file,
    built once."""
    tmp = tmp_path_factory.mktemp("numproc")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    src = write_fasta(tmp / "at1MB.fna", [repeat_rich_text(
        np.random.default_rng(1), 1_000_000, families=40)])
    subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkvtree", "-db", src,
         "-dna", "-pl", "-allout", "-indexname", str(tmp / "at1MB")],
        check=True, capture_output=True, env=env, cwd=str(tmp),
    )
    # queries sampled from the corpus
    import random

    random.seed(11)
    with open(src) as fh:
        seq = "".join(l.strip() for l in fh if not l.startswith(">"))
    with open(tmp / "q.fna", "w") as fh:
        for i in range(40):
            s = random.randrange(0, len(seq) - 30)
            fh.write(f">q{i}\n{seq[s:s + random.randrange(20, 31)]}\n")
    return tmp


def _run_cli(args, cwd, ndev=8):
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
        XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
    )
    r = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.vmatch"] + args,
        capture_output=True, text=True, env=env, cwd=cwd,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


def _strip_header(s):
    return "\n".join(l for l in s.splitlines() if not l.startswith("#"))


@needs_ref
def test_numproc_supermax_at1mb_byte_identical(at1mb_cli):
    tmp = at1mb_cli
    base = _run_cli(["-supermax", "-l", "25", "at1MB"], str(tmp))
    for ndev in (2, 4, 8):
        out = _run_cli(
            ["-supermax", "-l", "25", "-numproc", str(ndev), "at1MB"],
            str(tmp),
        )
        assert _strip_header(out) == _strip_header(base), ndev
    ref = subprocess.run(
        [REF_VMATCH, "-supermax", "-l", "25", str(tmp / "at1MB")],
        capture_output=True, text=True,
    ).stdout
    assert _strip_header(base) == _strip_header(ref)


@needs_ref
def test_numproc_complete_at1mb_byte_identical(at1mb_cli):
    tmp = at1mb_cli
    args = ["-complete", "-q", "q.fna", "at1MB"]
    base = _run_cli(args, str(tmp))
    for ndev in (2, 8):
        out = _run_cli(
            ["-complete", "-q", "q.fna", "-numproc", str(ndev),
             "at1MB"], str(tmp),
        )
        assert _strip_header(out) == _strip_header(base), ndev
    ref = subprocess.run(
        [REF_VMATCH, "-complete", "-q", str(tmp / "q.fna"),
         str(tmp / "at1MB")],
        capture_output=True, text=True,
    ).stdout
    assert _strip_header(base) == _strip_header(ref)


def test_numproc_mkvtree_index_byte_identical(tmp_path):
    """Sharded build (-numproc) writes byte-identical index files."""
    if len(jax.devices()) < 2:
        pytest.skip("not enough devices")
    src = write_fasta(tmp_path / "c.fna", np.array_split(repeat_rich_text(
        np.random.default_rng(2), 100_000, n_wild=10), 3))
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    for name, extra in (("mono", []), ("shard", ["-numproc", "2"])):
        r = subprocess.run(
            [sys.executable, "-m", "vstree_tpu.cli.mkvtree", "-db", src,
             "-dna", "-pl", "-allout",
             "-indexname", str(tmp_path / name)] + extra,
            capture_output=True, env=env, cwd=str(tmp_path), text=True,
        )
        assert r.returncode == 0, r.stderr
    for suffix in ("suf", "lcp", "llv", "bwt", "bck", "tis", "sti1"):
        a = (tmp_path / f"mono.{suffix}").read_bytes()
        b = (tmp_path / f"shard.{suffix}").read_bytes()
        assert a == b, suffix


def test_multichip_dryrun_at_scale():
    """Shard-vs-monolith equality with a sort size well past the
    trivial regime: 256 kbp over a virtual 8-device CPU mesh (4x the
    default dryrun size)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = ("import __graft_entry__ as g; "
            "g.dryrun_multichip(8, perdev=32768); print('DRYRUN-OK')")
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, env=env,
                       timeout=900, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "DRYRUN-OK" in r.stdout
