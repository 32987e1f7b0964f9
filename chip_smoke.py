#!/usr/bin/env python
"""Smoke run of the mkvtree -> vmatch main path on one GPU.

    python chip_smoke.py [--bp N] [--seed S]     # one card
    python chip_smoke.py --four [--bp N]         # -numproc 4 checks

One process holds the card and calls the command-line tools' own
``run`` functions (``vstree_tpu.cli.mkvtree.run``,
``vstree_tpu.cli.vmatch.run``), the code ``python -m vstree_tpu.cli.*``
runs.  The corpus is generated from ``--seed``: ``--bp`` symbols
(default 64 Mbp, about human chromosome 20) of random DNA in 8 FASTA
sequences with planted repeat families (300-5,000 bp, 2-20 copies, 2%
substitutions per copy), a mutated copy of it (1% substitutions, 0.1%
indels of 1-3 bp) as a second genome, 100k exact reads of 24-36 bp and
10k 32-bp reads with one edit.

Phases, each one CLI call checked against the repo's plain reference:

- ``mkvtree -db g.fna -dna -pl -allout``: suffix order and lcp values
  against direct text comparison;
- ``vmatch -complete -q``: every reported occurrence against a NumPy
  binary search over the suffix array with direct text comparison;
- ``vmatch -complete -e 1 -q``: every reported match against the
  textbook edit distance of read and text segment, each read made by a
  substitution or insertion reported where it was sampled, and the
  whole result of a sample of reads against a brute-force text search;
- ``vmatch -l 100``, ``-supermax -l 100``, ``-l 100 -q g.fna``,
  ``-l 100 -q g2.fna``, ``-l 100 -e 3``: output byte-identical to the
  same call on the host route (core/route.py), i.e. the host NumPy
  engines.

Every device program on this path is compiled by XLA for the card; the
repo has no hand-written kernel.

Each phase prints one JSON line with its wall time, route and match
count; a phase fails unless every task in it recorded the device route
(core/route.py ``recorded``): no host engine, and no slower fallback
such as the exact lookup's binary search.  ``--four`` runs only
the ``-numproc 4`` commands (index build, supermax, exact complete)
against their one-device outputs, and the shard-vs-monolith checks of
``__graft_entry__.dryrun_multichip``, and prints each card's peak
memory.  The last stdout line is the device summary; the script exits
non-zero, printing no summary, when JAX finds no GPU or any phase
failed.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

_ACGT = np.frombuffer(b"acgt", np.uint8)

EXACT_READS = 100_000
EDIT_READS = 10_000
MINLEN, MAXLEN = 24, 36
SEARCHLENGTH = 100


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def make_genome(bp: int, rng: np.random.Generator) -> np.ndarray:
    """Random DNA codes (0..3) with planted repeat families."""
    g = rng.integers(0, 4, bp, dtype=np.uint8)
    maxlen = min(5000, max(300, bp // 200))
    for _ in range(max(4, bp // 500_000)):
        cons = rng.integers(0, 4, int(rng.integers(300, maxlen + 1)),
                            dtype=np.uint8)
        for _ in range(int(rng.integers(2, 21))):
            copy = cons.copy()
            mut = rng.random(copy.size) < 0.02
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()),
                                                  dtype=np.uint8)) % 4
            at = int(rng.integers(0, bp - copy.size))
            g[at:at + copy.size] = copy
    return g


def mutate(g: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """1% substitutions and 0.1% indels of 1-3 bp."""
    g = g.copy()
    mut = rng.random(g.size) < 0.01
    g[mut] = (g[mut] + rng.integers(1, 4, int(mut.sum()),
                                    dtype=np.uint8)) % 4
    sites = np.sort(rng.choice(g.size, size=max(1, g.size // 1000),
                               replace=False))
    parts, prev = [], 0
    for s in sites:
        parts.append(g[prev:s])
        k = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            parts.append(rng.integers(0, 4, k, dtype=np.uint8))
            prev = s
        else:
            prev = min(g.size, s + k)
    parts.append(g[prev:])
    return np.concatenate(parts)


def write_fasta(path: str, name: str, seqs) -> None:
    with open(path, "wb") as fh:
        for i, s in enumerate(seqs):
            fh.write(b">%s%d\n" % (name.encode(), i))
            fh.write(_ACGT[s].tobytes())
            fh.write(b"\n")


def sample_reads(seqs, count: int, lengths, rng):
    """``count`` reads of the given lengths sampled from ``seqs``;
    returns (reads, sequence number, offset in that sequence)."""
    sizes = np.array([s.size for s in seqs])
    which = rng.choice(len(seqs), size=count, p=sizes / sizes.sum())
    reads, offs = [], []
    for i, m in zip(which, lengths):
        off = int(rng.integers(0, sizes[i] - m))
        reads.append(seqs[i][off:off + m])
        offs.append(off)
    return reads, which, np.array(offs, np.int64)


SUBSTITUTION, INSERTION, DELETION = range(3)


def one_edit(read: np.ndarray, rng) -> tuple[np.ndarray, int]:
    """The read with one substitution, insertion or deletion (the read
    keeps its length), and which of the three."""
    p = int(rng.integers(1, read.size - 1))
    kind = int(rng.integers(0, 3))
    if kind == SUBSTITUTION:
        r = read.copy()
        r[p] = (r[p] + rng.integers(1, 4)) % 4
    elif kind == INSERTION:
        r = np.concatenate([read[:p], [rng.integers(0, 4)], read[p:-1]])
    else:
        r = np.concatenate([read[:p], read[p + 1:], [rng.integers(0, 4)]])
    return r.astype(np.uint8), kind


def make_corpus(workdir: str, bp: int, seed: int,
                exact_reads: int = EXACT_READS,
                edit_reads: int = EDIT_READS) -> dict:
    """Write g.fna, g2.fna, reads.fna and reads_e1.fna to ``workdir``."""
    rng = np.random.default_rng(seed)
    g = make_genome(bp, rng)
    seqs = np.array_split(g, 8)
    g2 = mutate(g, rng)
    p = {k: os.path.join(workdir, k + ".fna")
         for k in ("g", "g2", "reads", "reads_e1")}
    write_fasta(p["g"], "chr", seqs)
    write_fasta(p["g2"], "mut", np.array_split(g2, 8))
    lens = rng.integers(MINLEN, MAXLEN + 1, exact_reads)
    reads, _, _ = sample_reads(seqs, exact_reads, lens, rng)
    write_fasta(p["reads"], "r", reads)
    e1, e1_seq, e1_off = sample_reads(seqs, edit_reads,
                                      np.full(edit_reads, 32), rng)
    e1, kinds = zip(*[one_edit(r, rng) for r in e1])
    write_fasta(p["reads_e1"], "e", e1)
    p["index"] = os.path.join(workdir, "g")
    p["reads_list"] = reads
    p["e1"] = {"reads": list(e1), "kind": np.array(kinds),
               "seq": e1_seq, "off": e1_off}
    return p


# ---------------------------------------------------------------------------
# phase plumbing
# ---------------------------------------------------------------------------


def traced(fn):
    """Run ``fn()``; returns (result, seconds, route).  Route is
    "device" when every task of the call recorded the device route
    (core/route.py), else "<task> <route>" of the first that did not
    (the host engine, or a slower path such as the exact lookup's
    binary search), and "none" when no task recorded a route."""
    from vstree_tpu.core.route import recorded

    with recorded() as taken:
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
    other = [f"{t} {r}" for t, r in taken if r != "device"]
    route = other[0] if other else "device" if taken else "none"
    return res, dt, route


def vmatch(argv) -> str:
    """Output of one ``vmatch`` call, as the CLI would print it."""
    from vstree_tpu.cli import vmatch as cli

    buf = io.StringIO()
    rc = cli.run(list(argv), out=buf)
    if rc:
        raise RuntimeError(f"vmatch {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def mkvtree(argv) -> None:
    from vstree_tpu.cli import mkvtree as cli

    rc = cli.run(list(argv))
    if rc:
        raise RuntimeError(f"mkvtree {' '.join(argv)} exited {rc}")


def rows(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln and not ln.startswith("#")]


# ---------------------------------------------------------------------------
# phases: each returns a dict for its report line and raises on a fault
# ---------------------------------------------------------------------------


def phase_mkvtree(c: dict) -> dict:
    _, dt, route = traced(lambda: mkvtree(
        ["-db", c["g"], "-dna", "-pl", "-allout",
         "-indexname", c["index"]]))
    from vstree_tpu.index.io import read_index

    esa = read_index(c["index"], demand=("suf", "lcp"))
    text = esa.multiseq.sequence
    n = text.size
    t64 = text.astype(np.int64)
    suf = esa.suftab.astype(np.int64)
    lcp = esa.lcptab.astype(np.int64)
    seen = np.zeros(n + 1, bool)
    seen[suf] = True
    assert seen.all(), "suftab is not a permutation"
    # the char after each common prefix orders the neighbours (specials
    # and the end order by position, after every regular char)
    a, b, L = suf[:-1], suf[1:], lcp[1:]
    ca = np.where(a + L < n, t64[np.minimum(a + L, n - 1)], 256)
    cb = np.where(b + L < n, t64[np.minimum(b + L, n - 1)], 256)
    ca = np.where(ca >= 4, 256 + a + L, ca)
    cb = np.where(cb >= 4, 256 + b + L, cb)
    assert (ca < cb).all(), "suffix order or lcp wrong"
    rng = np.random.default_rng(5)
    for k in rng.integers(1, n - 1, 2000):
        x, y, m = int(suf[k - 1]), int(suf[k]), int(lcp[k])
        assert np.array_equal(text[x:x + m], text[y:y + m]), k
        assert (text[x:x + m] < 4).all(), k
    return {"seconds": dt, "route": route, "matches": 0}


def _ref_exact_intervals(text, suftab, reads):
    """[lo, hi) of each read by a NumPy binary search over the suffix
    array, comparing text windows directly (specials and the end sort
    above every regular char)."""
    n = text.size
    m = max(r.size for r in reads)
    B = len(reads)
    pat = np.full((B, m), -1, np.int64)
    plen = np.array([r.size for r in reads])
    for i, r in enumerate(reads):
        pat[i, :r.size] = r
    offs = np.arange(m)
    active = offs[None, :] < plen[:, None]
    padded = np.concatenate([text.astype(np.int64),
                             np.full(m, 255, np.int64)])

    def cmp(rank):
        s = suftab[rank].astype(np.int64)
        ch = padded[s[:, None] + offs[None, :]]
        ch = np.where(ch >= 4, 255, ch)
        d = np.where(active, ch - pat, 0)
        nz = d != 0
        first = np.argmax(nz, axis=1)
        return np.where(nz.any(axis=1),
                        np.sign(d[np.arange(B), first]), 0)

    def bound(strict):
        lo = np.zeros(B, np.int64)
        hi = np.full(B, n + 1, np.int64)
        while (lo < hi).any():
            mid = (lo + hi) // 2
            rel = cmp(np.minimum(mid, n))
            go = (rel <= 0) if strict else (rel < 0)
            op = lo < hi
            lo = np.where(op & go, mid + 1, lo)
            hi = np.where(op & ~go, mid, hi)
        return lo

    return bound(False), bound(True)


def phase_complete_exact(c: dict) -> dict:
    out, dt, route = traced(lambda: vmatch(
        ["-complete", "-q", c["reads"], c["index"]]))
    from vstree_tpu.index.io import read_index

    esa = read_index(c["index"], demand=("suf",))
    ms = esa.multiseq
    t0 = time.perf_counter()
    lo, hi = _ref_exact_intervals(ms.sequence, esa.suftab,
                                  c["reads_list"])
    ref_s = time.perf_counter() - t0
    r = rows(out)
    got = np.array([ln.split() for ln in r]).reshape(len(r), -1)
    seq1 = got[:, 1].astype(np.int64)
    rel1 = got[:, 2].astype(np.int64)
    qid = got[:, 5].astype(np.int64)
    starts = np.concatenate([[0], ms.markpos.astype(np.int64) + 1])
    pos = starts[seq1] + rel1
    want_q = np.repeat(np.arange(lo.size), hi - lo)
    want_pos = np.concatenate([esa.suftab[a:b] for a, b in zip(lo, hi)])
    got_key = np.sort(qid * (ms.totallength + 1) + pos)
    want_key = np.sort(want_q * (ms.totallength + 1) + want_pos)
    assert np.array_equal(got_key, want_key), "complete: occurrences"
    # every read was sampled from the genome
    assert (hi > lo).all(), "complete: a sampled read was not found"
    return {"seconds": dt, "route": route, "matches": len(r),
            "reference_seconds": ref_s}


def _byte_identical(argv) -> dict:
    """The call's output on the default route against the same call on
    the host route."""
    from vstree_tpu.core.route import pinned

    out, dt, route = traced(lambda: vmatch(argv))
    t0 = time.perf_counter()
    with pinned(False):
        ref = vmatch(argv)
    ref_s = time.perf_counter() - t0
    if out != ref:
        a, b = rows(out), rows(ref)
        raise AssertionError(
            f"vmatch {' '.join(argv)}: {len(a)} rows on the device "
            f"route, {len(b)} on the host route; first difference "
            f"{next((x, y) for x, y in zip(a + [''], b + ['']) if x != y)}")
    return {"seconds": dt, "route": route, "matches": len(rows(out)),
            "reference_seconds": ref_s}


def _edit_distances(reads: np.ndarray, segs: np.ndarray,
                    seglen: np.ndarray) -> np.ndarray:
    """Levenshtein distance of each read (rows of ``reads``) to the
    first ``seglen`` symbols of its row of ``segs``, by the textbook
    table, one row per pair; symbols >= 4 (specials) match nothing."""
    m = reads.shape[1]
    R, L = segs.shape
    col = np.tile(np.arange(L + 1), (R, 1))            # row 0 of table
    for i in range(1, m + 1):
        new = np.empty_like(col)
        new[:, 0] = i
        hit = (reads[:, i - 1, None] == segs) & (segs < 4)
        sub = col[:, :-1] + ~hit
        for j in range(1, L + 1):
            new[:, j] = np.minimum(np.minimum(col[:, j], new[:, j - 1]) + 1,
                                   sub[:, j - 1])
        col = new
    return col[np.arange(R), seglen]


def _occurrences(tb: bytes, s: bytes) -> list[int]:
    """Every start of ``s`` in ``tb``, overlaps included."""
    out, i = [], tb.find(s)
    while i >= 0:
        out.append(i)
        i = tb.find(s, i + 1)
    return out


def _e1_starts(text: np.ndarray, tb: bytes, read: np.ndarray) -> set:
    """Every start p whose segment text[p:p+L], L in m-1..m+1, is at
    edit distance <= 1 from the read and holds no special (the corpus
    has no wildcards, so every special is a separator, where the scan
    stops).  One edit leaves one half of the read intact, at the
    segment's start or end, so the candidates are the exact
    occurrences of either half, found by a plain text search."""
    n, m = text.size, read.size
    h = m // 2
    cand = set(_occurrences(tb, read[:h].tobytes()))
    for o in _occurrences(tb, read[h:].tobytes()):
        cand.update(o - (L - (m - h)) for L in (m - 1, m, m + 1))
    cand = np.array(sorted(p for p in cand if p >= 0), np.int64)
    if cand.size == 0:
        return set()
    pad = np.concatenate([text, np.full(m + 1, 255, np.uint8)])
    segs = pad[cand[:, None] + np.arange(m + 1)].astype(np.int64)
    good = set()
    for L in (m - 1, m, m + 1):
        fits = (cand + L <= n) & (segs[:, :L] < 4).all(axis=1)
        d = _edit_distances(np.tile(read.astype(np.int64), (cand.size, 1)),
                            segs, np.full(cand.size, L))
        good.update(cand[fits & (d <= 1)].tolist())
    return good


E1_SAMPLE = 32


def phase_complete_e1(c: dict) -> dict:
    """Every reported match is checked against the textbook edit
    distance of the read and the reported text segment; every read
    made by one substitution or insertion must be reported at the
    position it was sampled from (its distance there is 1; a deletion
    with the random symbol appended can cost 2); and for a sample of
    ``E1_SAMPLE`` reads the reported starts must be exactly those of a
    brute-force search of the whole text (:func:`_e1_starts`)."""
    out, dt, route = traced(lambda: vmatch(
        ["-complete", "-e", "1", "-q", c["reads_e1"], c["index"]]))
    from vstree_tpu.index.io import read_index

    ms = read_index(c["index"], demand=()).multiseq
    t0 = time.perf_counter()
    r = rows(out)
    got = np.array([ln.split()[:8] for ln in r]).reshape(len(r), 8)
    seglen = got[:, 0].astype(np.int64)
    seq1 = got[:, 1].astype(np.int64)
    rel1 = got[:, 2].astype(np.int64)
    qid = got[:, 5].astype(np.int64)
    dist = got[:, 7].astype(np.int64)
    starts = np.concatenate([[0], ms.markpos.astype(np.int64) + 1])
    pos = starts[seq1] + rel1
    e1 = c["e1"]
    reads = np.stack(e1["reads"]).astype(np.int64)[qid]
    L = int(seglen.max(initial=1))
    text = np.concatenate([ms.sequence, np.full(L, 255, np.uint8)])
    segs = text[pos[:, None] + np.arange(L)].astype(np.int64)
    want = _edit_distances(reads, segs, seglen)
    assert (dist <= 1).all(), "complete -e 1: distance above 1"
    bad = np.flatnonzero(want != dist)
    assert bad.size == 0, \
        f"complete -e 1: {r[bad[0]]!r} has edit distance {want[bad[0]]}"
    src = starts[e1["seq"]] + e1["off"]
    must = np.flatnonzero(e1["kind"] != DELETION)
    found = set(zip(qid.tolist(), pos.tolist()))
    lost = [int(q) for q in must if (int(q), int(src[q])) not in found]
    assert not lost, f"complete -e 1: read {lost[0]} not reported at " \
        f"its source"
    tb = ms.sequence.tobytes()
    for q in np.linspace(0, len(e1["reads"]) - 1, E1_SAMPLE).astype(int):
        want_s = _e1_starts(ms.sequence, tb, e1["reads"][q])
        got_s = set(pos[qid == q].tolist())
        assert got_s == want_s, (
            f"complete -e 1: read {q}: reported {sorted(got_s)[:5]}, "
            f"brute force {sorted(want_s)[:5]}")
    return {"seconds": dt, "route": route, "matches": len(r),
            "reference_seconds": time.perf_counter() - t0}


def phase_repeats(c):
    return _byte_identical(["-l", str(SEARCHLENGTH), c["index"]])


def phase_supermax(c):
    return _byte_identical(["-supermax", "-l", str(SEARCHLENGTH),
                            c["index"]])


def phase_self_mems(c):
    return _byte_identical(["-l", str(SEARCHLENGTH), "-q", c["g"],
                            c["index"]])


def phase_genome_mems(c):
    return _byte_identical(["-l", str(SEARCHLENGTH), "-q", c["g2"],
                            c["index"]])


def phase_extension(c):
    return _byte_identical(["-l", str(SEARCHLENGTH), "-e", "3",
                            c["index"]])


PHASES = [
    ("mkvtree -allout", phase_mkvtree),
    ("vmatch -complete", phase_complete_exact),
    ("vmatch -complete -e 1", phase_complete_e1),
    ("vmatch -l 100", phase_repeats),
    ("vmatch -supermax -l 100", phase_supermax),
    ("vmatch -l 100 -q g.fna", phase_self_mems),
    ("vmatch -l 100 -q g2.fna", phase_genome_mems),
    ("vmatch -l 100 -e 3", phase_extension),
]


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _peaks():
    import jax

    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
            for d in jax.devices()]


NUMPROC = 4


def _numproc_index(c: dict) -> str:
    return c["index"] + f"_np{NUMPROC}"


def phase_numproc_build(c: dict) -> dict:
    """mkvtree -numproc 4: index files byte-identical to one device's.
    Runs first, so the peaks after the sharded build are its own; the
    one-device build then raises device 0's peak to its own."""
    idxn = _numproc_index(c)
    _, dt, route = traced(lambda: mkvtree(
        ["-db", c["g"], "-dna", "-pl", "-allout", "-numproc",
         str(NUMPROC), "-indexname", idxn]))
    peaks = _peaks()
    mkvtree(["-db", c["g"], "-dna", "-pl", "-allout",
             "-indexname", c["index"]])
    one_device_peak = _peaks()[0]
    d = os.path.dirname(idxn)
    stem = os.path.basename(idxn) + "."
    exts = [f[len(stem):] for f in sorted(os.listdir(d))
            if f.startswith(stem)]
    assert exts, "no index files written"
    for ext in exts:
        with open(idxn + "." + ext, "rb") as fa, \
                open(c["index"] + "." + ext, "rb") as fb:
            assert fa.read() == fb.read(), f"index .{ext} differs"
    return {"seconds": dt, "route": route, "matches": 0,
            "peak_bytes_per_device": peaks,
            "one_device_peak_bytes": one_device_peak}


def _numproc_same_output(args):
    def phase(c: dict) -> dict:
        out, dt, route = traced(lambda: vmatch(
            args(c) + ["-numproc", str(NUMPROC), _numproc_index(c)]))
        peaks = _peaks()
        ref = vmatch(args(c) + [c["index"]])
        assert rows(out) == rows(ref), f"-numproc {NUMPROC} output"
        return {"seconds": dt, "route": route, "matches": len(rows(out)),
                "peak_bytes_per_device": peaks}
    return phase


def phase_dryrun(c: dict) -> dict:
    import __graft_entry__ as g

    _, dt, route = traced(lambda: g.dryrun_multichip(NUMPROC))
    return {"seconds": dt, "route": route, "matches": 0,
            "peak_bytes_per_device": _peaks()}


# -numproc commands against their one-device outputs, in this order
# (the first builds both indexes); peak memory per card after each
FOUR_PHASES = [
    (f"mkvtree -numproc {NUMPROC}", phase_numproc_build),
    (f"vmatch -supermax -numproc {NUMPROC}", _numproc_same_output(
        lambda c: ["-supermax", "-l", str(SEARCHLENGTH)])),
    (f"vmatch -complete -numproc {NUMPROC}", _numproc_same_output(
        lambda c: ["-complete", "-q", c["reads"]])),
    (f"dryrun_multichip({NUMPROC})", phase_dryrun),
]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_phases(phases, corpus) -> bool:
    """Run each phase, print its report line; True when all passed.
    A phase that raises or took another route than the device's fails
    (the traceback goes to stderr) and the rest still run."""
    ok = True
    for name, fn in phases:
        try:
            rep = fn(corpus)
            if rep["route"] != "device":
                raise AssertionError(f"{name}: route {rep['route']}")
            rep = {"phase": name, "ok": True, **rep}
        except Exception:  # a phase fault is reported, never swallowed
            traceback.print_exc()
            rep = {"phase": name, "ok": False}
            ok = False
        print(json.dumps(rep), flush=True)
    return ok


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bp", type=int, default=64_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the -numproc 4 checks on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 2
    need = NUMPROC if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devs)} found",
              file=sys.stderr)
        return 2
    import vstree_tpu  # noqa: F401  (fail now, not per phase)

    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        corpus = make_corpus(work, args.bp, args.seed)
        print(json.dumps({"corpus_bp": args.bp, "seed": args.seed,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
        if args.four:
            ok = run_phases(FOUR_PHASES, corpus)
        else:
            ok = run_phases(PHASES, corpus)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
