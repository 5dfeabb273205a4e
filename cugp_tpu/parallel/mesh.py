"""Device-mesh construction — component C9 (SURVEY.md section 2).

The reference is single-GPU; all multi-chip capability is new surface
(BASELINE.json:5, "single-GPU execution -> GSPMD-sharded multi-host").
Axes:
  'dp' — data parallel: independent HMC chains / optimizer restarts
  'r', 'c' — 2D tensor-parallel grid for K/L (covariance, Cholesky)
The N (training-point) axis is the sequence-parallel axis: rows of X/y are
sharded over 'r' (SURVEY.md section 2.1). Collectives (panel broadcasts
along 'r'/'c', chain statistics psum along 'dp') go to NCCL; the cards
of a GPU host are joined all to all by NVLink, so the grid is a plain
most-square factorization with no torus layout to follow.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _grid_factor(n):
    """Most-square (r, c) factorization of n (prefers r >= c)."""
    best = (n, 1)
    for c in range(1, int(math.isqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


def make_mesh(n_devices=None, dp=1, devices=None):
    """Build a ('dp', 'r', 'c') mesh over the first n_devices devices.

    dp: size of the data-parallel (chains) axis; the remaining n/dp devices
    form the most-square (r, c) grid for the 2D K/L sharding.
    """
    if devices is None:
        devices = jax.devices()
    n = n_devices or len(devices)
    if n % dp != 0:
        raise ValueError(f"dp={dp} must divide n_devices={n}")
    r, c = _grid_factor(n // dp)
    arr = np.asarray(devices[:n]).reshape(dp, r, c)
    return Mesh(arr, axis_names=("dp", "r", "c"))


def grid_shape(mesh):
    return mesh.shape["r"], mesh.shape["c"]


# Canonical PartitionSpecs for the GP workload (C10; SURVEY.md section 2.1).
SPECS = {
    "X_rows": P("r", None),      # SP/CP: training points are the sequence
    "y_rows": P("r",),
    "K_2d": P("r", "c"),         # TP: dense K/L on the 2D grid
    "chains": P("dp",),          # DP: chain axis
    "replicated": P(),
}


def sharding(mesh, name):
    return NamedSharding(mesh, SPECS[name])


def wsc(x, mesh, spec):
    """with_sharding_constraint under a named mesh (shared helper)."""
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
