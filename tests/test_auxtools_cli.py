"""Differential tests for the aux index tools: vstree2tex, vendian,
mkvcmp, mkrcidx, mkdna6idx (reference Mkvtree/ tool family)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO

REF_MK = os.path.join(REPO, ".ref-build/src/Mkvtree")
TINY = ">t\nacgtacgtnacctgacacgtacgt\n>u\nggacgtacca\n"

needs_ref = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_MK, "mkvtree.x")),
    reason="reference binaries not built",
)


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aux")
    fa = tmp / "tiny.fna"
    fa.write_text(TINY)
    mkvtree_x = os.path.join(REF_MK, "mkvtree.x")
    # without the reference binary, "ref" is a second build of ours
    ref = ([mkvtree_x] if os.path.exists(mkvtree_x)
           else [sys.executable, "-m", "vstree_tpu.cli.mkvtree"])
    for cmd, name in ((ref, "ref"),
                      ([sys.executable, "-m", "vstree_tpu.cli.mkvtree"],
                       "ours")):
        subprocess.run(
            cmd + ["-db", str(fa), "-dna", "-pl", "1", "-allout",
                   "-indexname", str(tmp / name)],
            check=True, capture_output=True, env=_env(), cwd=str(tmp))
    return tmp


@needs_ref
@pytest.mark.parametrize("opts", [
    ["-tis", "-suf", "-lcp", "-s"],
    ["-bck"],
    ["-ois", "-tis", "-suf", "-bckhz", "-s"],
    ["-suf", "-skp"],
    ["-suf", "-sti1"],
])
def test_vstree2tex_parity(tiny, opts):
    ref = subprocess.run(
        [os.path.join(REF_MK, "vstree2tex.x")] + opts
        + [str(tiny / "ref")], capture_output=True, text=True)
    ours = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.vstree2tex"] + opts
        + [str(tiny / "ours")],
        capture_output=True, text=True, env=_env())
    assert ours.returncode == 0, ours.stderr
    assert ref.stdout == ours.stdout


@needs_ref
@pytest.mark.parametrize("nbytes", ["2", "4"])
def test_vendian_parity(tiny, nbytes):
    ref = subprocess.run(
        [os.path.join(REF_MK, "vendian.x"), nbytes,
         str(tiny / "ref.suf")], capture_output=True)
    ours = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.vendian", nbytes,
         str(tiny / "ref.suf")], capture_output=True, env=_env())
    assert ref.stdout == ours.stdout


def test_mkvcmp(tiny):
    ok = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkvcmp",
         str(tiny / "ref"), str(tiny / "ours")],
        capture_output=True, text=True, env=_env())
    assert ok.returncode == 0, ok.stderr
    assert "okay" in ok.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkvcmp",
         str(tiny / "ref"), str(tiny / "nonexistent")],
        capture_output=True, text=True, env=_env())
    assert bad.returncode != 0


@needs_ref
def test_mkrcidx_byte_parity(tiny):
    fa = str(tiny / "tiny.fna")
    subprocess.run(
        [os.path.join(REF_MK, "mkrcidx.x"), "-db", fa,
         "-indexname", str(tiny / "refrc")],
        check=True, capture_output=True)
    r = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkrcidx", "-db", fa,
         "-indexname", str(tiny / "ourrc")],
        capture_output=True, text=True, env=_env(), cwd=str(tiny))
    assert r.returncode == 0, r.stderr
    for suf in ("tis", "suf", "lcp", "llv", "bwt", "ssp", "des",
                "sds", "al1", "prj"):
        a = (tiny / f"refrc.rcm.{suf}").read_bytes()
        b = (tiny / f"ourrc.rcm.{suf}").read_bytes()
        assert a == b, suf


@needs_ref
def test_mkdna6idx_byte_parity(tiny):
    fa = str(tiny / "tiny.fna")
    subprocess.run(
        [os.path.join(REF_MK, "mkdna6idx.x"), "-db", fa,
         "-indexname", str(tiny / "ref6")],
        check=True, capture_output=True)
    r = subprocess.run(
        [sys.executable, "-m", "vstree_tpu.cli.mkdna6idx", "-db", fa,
         "-indexname", str(tiny / "our6")],
        capture_output=True, text=True, env=_env(), cwd=str(tiny))
    assert r.returncode == 0, r.stderr
    for suf in ("tis", "ois", "des", "sds", "ssp", "al1", "prj"):
        assert (tiny / f"ref6.{suf}").read_bytes() == \
            (tiny / f"our6.{suf}").read_bytes(), suf
    for suf in ("tis", "ois", "suf", "lcp", "llv", "bwt", "ssp",
                "des", "sds", "al1", "prj"):
        assert (tiny / f"ref6.6fr.{suf}").read_bytes() == \
            (tiny / f"our6.6fr.{suf}").read_bytes(), suf
