"""Shared blocking policy for the dense linear-algebra tier.

cholesky.py's recursion calls trsm.py's recursion on matching sub-blocks,
so their split geometry MUST agree — both import it from here (a mismatch
would silently produce differently-shaped GEMMs on the hot path).
"""

from __future__ import annotations

from jax import lax

# Size at or below which recursions stop and call the base-case kernel.
BASE = 1024
# Recursion split sizes are rounded to multiples of this (GEMM-friendly).
ALIGN = 256

HI = lax.Precision.HIGHEST


def split_point(n):
    """Largest multiple of ALIGN close to n/2 (static python int)."""
    half = n // 2
    m = (half // ALIGN) * ALIGN
    return max(m, ALIGN)


def round_up(a, m):
    return -(-a // m) * m
