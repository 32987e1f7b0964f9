"""Rehearsal of chip_smoke.py on the CPU: every phase at 200 kbp with
the device route pinned, the -numproc 4 checks on the virtual mesh, and
the refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO

import chip_smoke as cs
from vstree_tpu.core.route import pinned


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """200 kbp corpus with its index built by the mkvtree phase."""
    work = tmp_path_factory.mktemp("smoke")
    c = cs.make_corpus(str(work), 200_000, 1, exact_reads=2000,
                       edit_reads=300)
    with pinned(True):
        c["mkvtree"] = cs.phase_mkvtree(c)
    return c


def test_phase_mkvtree(corpus):
    assert corpus["mkvtree"]["route"] == "device"


@pytest.mark.parametrize("name, fn", cs.PHASES[1:],
                         ids=[n for n, _ in cs.PHASES[1:]])
def test_phase(corpus, name, fn):
    with pinned(True):
        rep = fn(corpus)
    assert rep["route"] == "device", name
    assert rep["matches"] > 0, name


def test_edit_distances_vs_plain_table():
    """The vectorized distance table of the -e 1 check against a
    one-pair-at-a-time table, on segments of the read's length +-2
    that hold specials too."""
    rng = np.random.default_rng(9)
    R, m, L = 200, 12, 14
    reads = rng.integers(0, 4, (R, m))
    segs = np.where(rng.random((R, L)) < 0.05, 254,
                    rng.integers(0, 4, (R, L)))
    segs[::3, :m] = reads[::3]          # near matches
    segs[::3, rng.integers(0, m)] = 1
    seglen = rng.integers(m - 2, L + 1, R)
    got = cs._edit_distances(reads, segs, seglen)
    for r in range(R):
        a, b = reads[r], segs[r, :seglen[r]]
        col = list(range(b.size + 1))
        for i in range(1, m + 1):
            new = [i]
            for j in range(1, b.size + 1):
                same = a[i - 1] == b[j - 1] and b[j - 1] < 4
                new.append(min(col[j] + 1, new[j - 1] + 1,
                               col[j - 1] + (0 if same else 1)))
            col = new
        assert got[r] == col[-1], r


def test_host_route_fails_a_phase(corpus, capsys):
    with pinned(False):
        ok = cs.run_phases([cs.PHASES[3]], corpus)
    assert not ok
    assert '"ok": false' in capsys.readouterr().out


def test_main_refuses_without_gpu(capsys):
    assert cs.main(["--bp", "1000"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding only the script it exits non-zero and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_phases_on_virtual_mesh(tmp_path):
    """The --four checks (-numproc 4 build, supermax, complete and the
    dryrun) on four of the virtual CPU devices."""
    c = cs.make_corpus(str(tmp_path), 100_000, 2, exact_reads=500,
                       edit_reads=10)
    with pinned(True):
        assert cs.run_phases(cs.FOUR_PHASES, c)
