"""Committed values of the JAX package for the port's CPU tests.

Where a test holds the port to a JAX call whose cold compile takes minutes
on the CPU, it reads the JAX package's values from tests/golden/<module>.npz
instead of compiling that call on every run.  Each such test module
defines `jax_golden()`, the JAX calls that make its values, beside the
tests that read them; `python tools/torch_golden_from_jax.py --tests`
reruns them and rewrites the files.
"""

from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "golden"


def load(module):
    """{name: array} of tests/golden/<module>.npz."""
    with np.load(GOLDEN / f"{module}.npz") as f:
        return {key: f[key] for key in f.files}


def save(module, arrays):
    GOLDEN.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN / f"{module}.npz", **arrays)
