"""Inputs shared by the probes' tests on the CPU (plain against JAX) and on
the card (kernel against plain).  Imports neither JAX nor torch."""

import numpy as np


def above_inf(rows: int, seed: int) -> np.ndarray:
    """(rows, 128) float32 keys above 1e30 (x in [1e31, 1e38)): row 0 holds
    only such keys, row 1 one key in [1, 2) among them, and the other rows
    mix them with keys in [1, 2) in shares from 10% to 99%, so that a row
    runs out of keys below 1e30 and its later rounds take nothing."""
    rng = np.random.default_rng(seed)
    big = 10.0 ** rng.uniform(31, 38, (rows, 128))
    small = rng.random((rows, 128)) + 1.0
    share = np.linspace(0.1, 0.99, rows)[:, None]
    x = np.where(rng.random((rows, 128)) < share, big, small)
    x[0] = big[0]
    x[1] = big[1]
    x[1, 77] = 1.5
    return x.astype(np.float32)
