"""Differential tests for -pp chain thread (the reference's shipped
diagonal-dump behavior, chainvm.c:365-399), -qspeedup levels 0/2/5 and
the explicit rejections for 1/3/4, and mkrcidx -cpl."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, repeat_rich_text, write_fasta

REF_SRC = os.path.join(REPO, ".ref-build/src")
MKVTREE = os.path.join(REF_SRC, "Mkvtree/mkvtree.x")
VMATCH = os.path.join(REF_SRC, "Vmatch/vmatch.x")
CHAIN2DIM = os.path.join(REF_SRC, "Vmatch/chain2dim.x")
MKRCIDX = os.path.join(REF_SRC, "Mkvtree/mkrcidx.x")

needs_ref = pytest.mark.skipif(
    not os.path.exists(VMATCH), reason="reference binaries not built"
)

ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
DEMO_PLUGIN = os.path.join(REPO, "vstree_tpu/plugins/vmotif-demo.py")


def run_ours(args, cwd):
    r = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.vmatch"] + args,
        capture_output=True, text=True, env=ENV, cwd=cwd)
    return r


def body(s):
    return [l for l in s.splitlines() if not l.startswith("# args")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Index of a seeded 100 kbp corpus (and the reference binary's
    index of it, when the binaries are built)."""
    tmp = tmp_path_factory.mktemp("thread")
    src = write_fasta(tmp / "c.fna", np.array_split(repeat_rich_text(
        np.random.default_rng(4), 100_000, families=12), 2))
    if os.path.exists(MKVTREE):
        subprocess.run([MKVTREE, "-db", src, "-dna", "-pl", "-allout",
                        "-indexname", str(tmp / "ref")],
                       check=True, capture_output=True)
    subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkvtree", "-db", src,
         "-dna", "-pl", "-allout", "-indexname", str(tmp / "ours")],
        check=True, capture_output=True, env=ENV, cwd=str(tmp))
    with open(src) as fh:
        (tmp / "q.fna").write_text(fh.read(20000))
    return tmp


@needs_ref
@pytest.mark.parametrize("mode", [["local"], ["global"]])
def test_chain_thread_dump(setup, mode):
    args = ["-l", "20", "-pp", "chain"] + mode + ["thread"]
    ref = subprocess.run(
        [VMATCH] + args + [str(setup / "ref")],
        capture_output=True, text=True, cwd=str(setup)).stdout
    r = run_ours(args + [str(setup / "ours")], str(setup))
    assert r.returncode == 0, r.stderr
    assert body(ref) == body(r.stdout)
    assert any(l.startswith("diag ") for l in body(ref))


@needs_ref
def test_chain2dim_thread_dump(setup):
    mfile = str(setup / "m.match")
    with open(mfile, "w") as fh:
        subprocess.run([VMATCH, "-l", "20", str(setup / "ref")],
                       stdout=fh, check=True, cwd=str(setup))
    ref = subprocess.run(
        [CHAIN2DIM, "-local", "-thread", mfile],
        capture_output=True, text=True, cwd=str(setup)).stdout
    r = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.chain2dim", "-local",
         "-thread", mfile],
        capture_output=True, text=True, env=ENV, cwd=str(setup))
    assert r.returncode == 0, r.stderr
    assert body(ref) == body(r.stdout)


@needs_ref
@pytest.mark.parametrize("level", ["0", "2", "5"])
def test_qspeedup_levels_byte_identical(setup, level):
    args = ["-l", "20", "-qspeedup", level, "-q", "q.fna"]
    ref = subprocess.run(
        [VMATCH] + args + [str(setup / "ref")],
        capture_output=True, text=True, cwd=str(setup)).stdout
    r = run_ours(args + [str(setup / "ours")], str(setup))
    assert r.returncode == 0, r.stderr
    assert body(ref) == body(r.stdout)


def test_qspeedup_rejections(setup):
    r = run_ours(["-l", "20", "-qspeedup", "1", "-q", "q.fna",
                  str(setup / "ours")], str(setup))
    assert r.returncode != 0
    assert "Algorithm 1 is no longer available" in r.stderr
    r = run_ours(["-l", "20", "-qspeedup", "3", "-q", "q.fna",
                  str(setup / "ours")], str(setup))
    assert r.returncode != 0
    assert "not supported" in r.stderr
    r = run_ours(["-l", "20", "-qspeedup", "4", "-q", "q.fna",
                  str(setup / "ours")], str(setup))
    assert r.returncode != 0
    assert "mklsf" in r.stderr


def test_gated_options_rejected(setup):
    for opt in ("-dbms", "-regexp", "-agrep"):
        r = run_ours([opt, "x", str(setup / "ours")], str(setup))
        assert r.returncode != 0
        assert "not supported" in r.stderr, (opt, r.stderr)


@needs_ref
def test_mkrcidx_cpl(setup, tmp_path):
    src = str(setup / "c.fna")
    subprocess.run([MKRCIDX, "-db", src, "-cpl", "-indexname",
                    str(tmp_path / "ref")],
                   check=True, capture_output=True, cwd=str(tmp_path))
    subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkrcidx", "-db", src,
         "-cpl", "-indexname", str(tmp_path / "ours")],
        check=True, capture_output=True, env=ENV, cwd=str(tmp_path))
    for tab in ("suf", "tis", "lcp"):
        a = (tmp_path / f"ref.rcm.{tab}").read_bytes()
        b = (tmp_path / f"ours.rcm.{tab}").read_bytes()
        assert a == b, tab


def test_vplugin_vmotif_demo(setup):
    """The vplugin protocol analog: the demo motif plugin takes over
    -complete and emits through the standard funnel."""
    # -selfun with an unloadable path must fail cleanly even when a
    # vplugin takes over the search
    r_bad = run_ours(
        ["-complete", DEMO_PLUGIN,
         "-selfun", "/dev/null", str(setup / "ours")], str(setup))
    assert r_bad.returncode != 0
    r = run_ours(
        ["-complete", DEMO_PLUGIN,
         str(setup / "ours")], str(setup))
    assert r.returncode == 0, r.stderr
    rows = [l for l in r.stdout.splitlines() if not l.startswith("#")]
    assert len(rows) > 0
    # every row is a well-formed 6-length exact match row
    for l in rows[:5]:
        parts = l.split()
        assert parts[0] == "6" and parts[3] == "D", l


def test_vplugin_missing_hook_rejected(setup, tmp_path):
    p = tmp_path / "vmotif-broken.py"
    p.write_text("def vplugininit(data):\n    pass\n")
    r = run_ours(["-complete", str(p), str(setup / "ours")],
                 str(setup))
    assert r.returncode != 0
    assert "mandatory hook" in r.stderr


def test_complete_bad_argument_rejected(setup):
    r = run_ours(["-complete", "bogusword", "-q", "q.fna",
                  str(setup / "ours")], str(setup))
    assert r.returncode != 0
    assert "remred" in r.stderr
