"""Blocked triangular solves (TRSM) — component C4 (SURVEY.md section 2).

The reference uses cuBLAS-style trsm for the posterior solves
(BASELINE.json:5, "triangular solves for the posterior mean/variance",
"batched triangular solves"). Design: recursive blocked TRSM — the
triangular factor is split in half, the diagonal sub-solves recurse, and
the coupling term is one large static-shape GEMM. The base case is XLA's
``triangular_solve`` (cuBLAS trsm on the GPU). All GEMMs run with
precision=HIGHEST (see cholesky.py).

Solve variants (L lower triangular):
  solve_lx(L, B)  : L X = B       (forward substitution; alpha-solve step 1)
  solve_ltx(L, B) : L^T X = B     (back substitution;    alpha-solve step 2)
  solve_xlt(L, B) : X L^T = B     (right-side solve; Cholesky panel update)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from cugp_tpu.ops.blocking import BASE as _BASE, HI as _HI
from cugp_tpu.ops.blocking import split_point as _split_point


def _base_solve(l, b, *, left, transpose):
    return lax.linalg.triangular_solve(
        l, b, left_side=left, lower=True, transpose_a=transpose
    )


def solve_lx(l, b, precision=None):
    """Solve L X = B for X (L lower triangular, B is (n, k) or (n,))."""
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = _solve_lx(l, b, precision or _HI)
    return x[..., 0] if vec else x


def _solve_lx(l, b, precision=_HI):
    n = l.shape[-1]
    if n <= _BASE:
        return _base_solve(l, b, left=True, transpose=False)
    m = _split_point(n)
    l11, l21, l22 = l[..., :m, :m], l[..., m:, :m], l[..., m:, m:]
    x1 = _solve_lx(l11, b[..., :m, :], precision)
    b2 = b[..., m:, :] - jnp.matmul(l21, x1, precision=precision)
    x2 = _solve_lx(l22, b2, precision)
    return jnp.concatenate([x1, x2], axis=-2)


def solve_ltx(l, b, precision=None):
    """Solve L^T X = B for X."""
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = _solve_ltx(l, b, precision or _HI)
    return x[..., 0] if vec else x


def _solve_ltx(l, b, precision=_HI):
    n = l.shape[-1]
    if n <= _BASE:
        return _base_solve(l, b, left=True, transpose=True)
    m = _split_point(n)
    l11, l21, l22 = l[..., :m, :m], l[..., m:, :m], l[..., m:, m:]
    x2 = _solve_ltx(l22, b[..., m:, :], precision)
    b1 = b[..., :m, :] - jnp.matmul(l21.mT, x2, precision=precision)
    x1 = _solve_ltx(l11, b1, precision)
    return jnp.concatenate([x1, x2], axis=-2)


def solve_xlt(l, b, precision=None):
    """Solve X L^T = B for X (right-side solve; B is (k, n))."""
    n = l.shape[-1]
    precision = _HI if precision is None else precision
    if n <= _BASE:
        return _base_solve(l, b, left=False, transpose=True)
    m = _split_point(n)
    l11, l21, l22 = l[..., :m, :m], l[..., m:, :m], l[..., m:, m:]
    x1 = solve_xlt(l11, b[..., :, :m], precision)
    b2 = b[..., :, m:] - jnp.matmul(x1, l21.mT, precision=precision)
    x2 = solve_xlt(l22, b2, precision)
    return jnp.concatenate([x1, x2], axis=-1)


def cho_solve(l, b, precision=None):
    """Solve (L L^T) x = b given the Cholesky factor L."""
    return solve_ltx(l, solve_lx(l, b, precision), precision)
