"""Test configuration: force an 8-device virtual CPU mesh so sharding
tests run without accelerator hardware.  Must run before jax is
imported."""

import os
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def dna_alpha():
    from vstree_tpu.core.alphabet import dna_alphabet

    return dna_alphabet()


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a subprocess that runs on the GPU; skips the
    test when JAX finds none.  (This process is pinned to the CPU.)"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=env, timeout=300)
    if r.stdout.strip() != "gpu":
        pytest.skip("no GPU")
    return env


def random_dna_text(rng, n, n_wild=0, n_sep=0):
    """Random encoded DNA text with optional wildcards/separators."""
    t = rng.integers(0, 4, size=n).astype(np.uint8)
    if n_wild:
        t[rng.choice(n, size=min(n_wild, n), replace=False)] = 254
    if n_sep:
        t[rng.choice(n, size=min(n_sep, n), replace=False)] = 255
    return t


def repeat_rich_text(rng, n, families=6, n_wild=0):
    """Random DNA with planted repeat families (mutated copies), so
    lcp runs, supermaximal intervals and long matches exist."""
    t = rng.integers(0, 4, size=n).astype(np.uint8)
    for _ in range(families):
        cons = rng.integers(0, 4, int(rng.integers(40, 400)),
                            dtype=np.uint8)
        for _ in range(int(rng.integers(2, 8))):
            c = cons.copy()
            mut = rng.random(c.size) < 0.03
            c[mut] = rng.integers(0, 4, int(mut.sum()))
            at = int(rng.integers(0, n - c.size))
            t[at:at + c.size] = c
    if n_wild:
        t[rng.choice(n, size=min(n_wild, n), replace=False)] = 254
    return t


def write_fasta(path, seqs):
    """Encoded DNA sequences (codes 0..3, 254 = n) to a FASTA file."""
    table = np.frombuffer(b"acgt", np.uint8)
    with open(path, "wb") as fh:
        for i, s in enumerate(seqs):
            enc = np.where(s < 4, table[np.minimum(s, 3)], ord("n"))
            fh.write(b">s%d\n" % i + enc.astype(np.uint8).tobytes()
                     + b"\n")
    return str(path)
