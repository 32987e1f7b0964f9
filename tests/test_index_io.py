"""Index serialization tests: roundtrip + byte-parity with reference
mkvtree output (differential oracle, SURVEY.md §4)."""

import os
import subprocess

import numpy as np
import pytest

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import read_multiseq
from vstree_tpu.index.build import build_esa
from vstree_tpu.index.io import read_index, write_index

REF_SRC = "/root/repo/.ref-build/src"
MKVTREE = os.path.join(REF_SRC, "Mkvtree/mkvtree.x")
VMATCH = os.path.join(REF_SRC, "Vmatch/vmatch.x")
TESTDATA = "/root/reference/src/testdata"

needs_ref = pytest.mark.skipif(
    not os.path.exists(MKVTREE), reason="reference binaries not built"
)

ALL_DEMAND = ("suf", "lcp", "bwt", "bck", "sti", "skp")


def build_ours(tmp_path, fasta, name):
    alpha = dna_alphabet()
    ms = read_multiseq([fasta], alpha, store_original=True)
    esa = build_esa(ms, alpha, demand=ALL_DEMAND)
    write_index(esa, str(tmp_path / name))
    return esa


def test_roundtrip(tmp_path):
    """Seeded sequences dense in wildcards (n) through write/read."""
    from conftest import repeat_rich_text, write_fasta

    rng = np.random.default_rng(3)
    fasta = write_fasta(tmp_path / "w.fna", [
        repeat_rich_text(rng, m, families=2, n_wild=m // 20)
        for m in (3000, 1200, 4500)])
    esa = build_ours(tmp_path, fasta, "w")
    esa2 = read_index(str(tmp_path / "w"))
    assert np.array_equal(esa2.suftab, esa.suftab)
    assert np.array_equal(esa2.lcptab, esa.lcptab)
    assert np.array_equal(esa2.bwttab, esa.bwttab)
    assert np.array_equal(esa2.bcktab, esa.bcktab)
    assert np.array_equal(esa2.skptab, esa.skptab)
    assert esa2.prefixlength == esa.prefixlength
    assert esa2.longest == esa.longest
    assert esa2.multiseq.descriptions == esa.multiseq.descriptions


@needs_ref
@pytest.mark.parametrize(
    "fasta", ["Grumbach/Wildcards.fna", "at100K1", "Grumbach/vaccg.fna"]
)
def test_byte_parity_with_reference(tmp_path, fasta):
    src = os.path.join(TESTDATA, fasta)
    build_ours(tmp_path, src, "ours")
    subprocess.run(
        [MKVTREE, "-db", src, "-dna", "-pl", "-allout", "-indexname",
         str(tmp_path / "ref")],
        check=True, capture_output=True,
    )
    for ext in ("tis", "ois", "suf", "lcp", "llv", "bwt", "bck", "sti1",
                "skp", "ssp", "des", "sds", "al1"):
        ref = tmp_path / f"ref.{ext}"
        ours = tmp_path / f"ours.{ext}"
        assert ref.exists() == ours.exists(), ext
        if ref.exists():
            assert ref.read_bytes() == ours.read_bytes(), ext


@needs_ref
def test_reference_vmatch_accepts_our_index(tmp_path):
    src = os.path.join(TESTDATA, "at100K1")
    build_ours(tmp_path, src, "ours")
    subprocess.run(
        [MKVTREE, "-db", src, "-dna", "-pl", "-allout", "-indexname",
         str(tmp_path / "ref")],
        check=True, capture_output=True,
    )
    out_ours = subprocess.run(
        [VMATCH, "-l", "40", str(tmp_path / "ours")],
        check=True, capture_output=True, text=True,
    ).stdout
    out_ref = subprocess.run(
        [VMATCH, "-l", "40", str(tmp_path / "ref")],
        check=True, capture_output=True, text=True,
    ).stdout
    # first line embeds the index path; compare the matches only
    strip = lambda s: [l for l in s.splitlines() if not l.startswith("#")]
    assert strip(out_ours) == strip(out_ref)
    assert len(strip(out_ref)) > 0
