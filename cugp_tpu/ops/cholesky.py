"""Cholesky factorization — component C2 (SURVEY.md section 2).

The reference uses a custom "cuSOLVER-style" CUDA Cholesky (BASELINE.json:5).
``method="xla"`` is ``jax.lax.linalg.cholesky`` (cuSOLVER potrf on the GPU).
``method="blocked"`` is a *recursive blocked right-looking* factorization:

    A = [[A11, .  ],          L11 = chol(A11)
         [A21, A22]]   ==>    L21 = A21 L11^{-T}          (blocked TRSM, GEMMs)
                              L22 = chol(A22 - L21 L21^T) (SYRK update, GEMM)

The recursion is unrolled at trace time (N is static under jit), so every
GEMM/TRSM in the program has a static shape and goes to cuBLAS; the base
case is ``lax.linalg.cholesky`` on a block of at most ``BASE`` rows. All
matmuls on the critical path run with ``precision=HIGHEST`` — IEEE fp32,
no TF32 — because Cholesky of badly conditioned covariances is destroyed
by reduced-precision products.

The custom VJP implements the standard Cholesky reverse-mode rule
(differentiating the factorization, not the recursion), so gradients cost two
triangular solves + one GEMM instead of unrolled-recursion AD.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cugp_tpu.ops import trsm as trsm_ops

from cugp_tpu.ops.blocking import BASE as _BASE, HI as _HI
from cugp_tpu.ops.blocking import split_point as _split_point


def _base_potrf(a):
    # rebuild the (possibly garbage) upper triangle from the lower one —
    # callers may hand us SYRK-lower results (see _syrk_lower)
    lower = jnp.tril(a)
    a = lower + jnp.triu(lower.mT, 1)
    return lax.linalg.cholesky(a)


# Below this size a trailing update is one full gemm; above, the SYRK
# recursion skips the upper-triangular quadrant (saves ~1/3 of GEMM FLOPs
# at the top levels, where almost all the time is).
_SYRK_FULL = 4096

# "mixed" policy: quadrants containing the diagonal keep full-fp32
# (HIGHEST) updates at or below this size; strictly-off-diagonal update
# GEMMs run at HIGH (a reduced-precision product with the same fp32
# accumulator; on the GPU XLA runs HIGH as TF32). Error analysis: the
# Cholesky recursion is only sensitive where pivots are FORMED (the
# diagonal path); off-diagonal trailing blocks enter later pivots
# through a second GEMM that re-rounds anyway. Round-3 VERDICT weak #1 /
# next #6 experiment.
_MIXED_DIAG = 4096
_HIGH = jax.lax.Precision.HIGH


def _syrk_lower(a, p, precision, offdiag_precision=None):
    """a - p p^T computed only on (block) lower triangle; upper is garbage.

    The classic SYRK saving expressed recursively with static shapes: the
    strictly-upper quadrant of each level is returned untouched (callers —
    the Cholesky recursion and the base potrf — only read the lower
    triangle, see _base_potrf's symmetrization).

    offdiag_precision: optional lower precision for the strictly-off-
    diagonal quadrants (the "mixed" policy); diagonal-containing
    quadrants recurse at `precision` until <= _MIXED_DIAG.
    """
    n = a.shape[-1]
    off = offdiag_precision
    if n <= (_SYRK_FULL if off is None else _MIXED_DIAG):
        return a - jnp.matmul(p, p.mT, precision=precision)
    m = _split_point(n)
    a11 = _syrk_lower(a[..., :m, :m], p[..., :m, :], precision, off)
    a21 = a[..., m:, :m] - jnp.matmul(p[..., m:, :], p[..., :m, :].mT,
                                      precision=precision if off is None
                                      else off)
    a22 = _syrk_lower(a[..., m:, m:], p[..., m:, :], precision, off)
    top = jnp.concatenate([a11, a[..., :m, m:]], axis=-1)
    bot = jnp.concatenate([a21, a22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _chol_recursive(a, precision, offdiag_precision=None):
    n = a.shape[-1]
    if n <= _BASE:
        return _base_potrf(a)
    m = _split_point(n)
    a11 = a[..., :m, :m]
    a21 = a[..., m:, :m]
    a22 = a[..., m:, m:]
    l11 = _chol_recursive(a11, precision, offdiag_precision)
    # L21 = A21 L11^{-T}  (solve X L11^T = A21)
    l21 = trsm_ops.solve_xlt(l11, a21, precision=precision)
    s = _syrk_lower(a22, l21, precision, offdiag_precision)
    l22 = _chol_recursive(s, precision, offdiag_precision)
    zeros = jnp.zeros(a.shape[:-2] + (m, n - m), dtype=a.dtype)
    top = jnp.concatenate([l11, zeros], axis=-1)
    bot = jnp.concatenate([l21, l22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def _cholesky_impl(a, precision):
    if precision == "mixed":
        return _chol_recursive(a, _HI, offdiag_precision=_HIGH)
    if precision == "mixed_fast":
        # diagonal path at HIGH, strictly-off-diagonal trailing updates
        # at DEFAULT — the aggressive end of the precision frontier; gate
        # on the reconstruction residual before trusting it
        return _chol_recursive(a, _HIGH,
                               offdiag_precision=jax.lax.Precision.DEFAULT)
    return _chol_recursive(a, precision)


def _cholesky_fwd(a, precision):
    l = _cholesky_impl(a, precision)
    return l, l


def _cholesky_bwd(precision, l, l_bar):
    """Standard Cholesky reverse rule (Murray 2016, eq. 8-10).

    A_bar = 1/2 L^{-T} (P + P^T) L^{-1},  P = Phi(L^T L_bar),
    with Phi taking the lower triangle and halving the diagonal.
    """
    n = l.shape[-1]
    p = jnp.matmul(l.mT, l_bar, precision=_HI)
    # batched-safe diagonal embedding (diagflat would flatten batch dims)
    diag_p = jnp.diagonal(p, axis1=-2, axis2=-1)
    p = jnp.tril(p) - 0.5 * diag_p[..., None, :] * jnp.eye(n, dtype=p.dtype)
    # S = L^{-T} (P + P^T) L^{-1}: two full n x n triangular solves on the
    # gradient path, both through the blocked recursion (GEMM-rich); the
    # right-side solve X L = tmp is expressed as (L^T X^T = tmp^T)^T.
    sym = p + p.mT
    tmp = trsm_ops.solve_ltx(l, sym, precision=_HI)
    s = trsm_ops.solve_ltx(l, tmp.mT, precision=_HI).mT
    # s is symmetric by construction; 0.25*(s+s^T) = 0.5*s (Murray eq. 8)
    # with the average keeping it exactly symmetric in floating point
    a_bar = 0.25 * (s + s.mT)
    return (a_bar,)


_cholesky_impl.defvjp(_cholesky_fwd, _cholesky_bwd)


def auto_method(n):
    """What cholesky(method="auto") runs for an n x n matrix: "xla" at
    every size. On an H100 (700 W) at IEEE fp32, cuSOLVER's potrf beat the
    blocked recursion at n=8192 (8.8 vs 13.0 ms) and n=32768 (0.276 vs
    0.313 s), so "blocked" is an explicit option only (PERF.md)."""
    return "xla"


def cholesky(a, method="auto", precision=None):
    """Lower-triangular Cholesky factor of a symmetric PD matrix.

    method: 'auto' (see auto_method), 'xla' (lax.linalg.cholesky),
            'blocked' (recursion + SYRK-lower, lax base case; its
            precision policies are what the option is for).
    precision: matmul precision of the blocked path's trailing updates
    (default HIGHEST = IEEE fp32; HIGH runs them in TF32 on the GPU —
    validate against the oracle first).
    "mixed": HIGHEST on the diagonal path (panels, TRSM, diagonal-
    containing SYRK quadrants <= 4k) + HIGH on strictly-off-diagonal
    trailing updates — most of the N^3/3 FLOPs at the faster rate while
    pivots are still formed in full fp32 (gate on the reconstruction
    residual; see benchmarks/bench_chol_precision.py).
    """
    precision = _HI if precision is None else precision
    if method == "auto":
        method = auto_method(a.shape[-1])
    if method == "xla":
        return lax.linalg.cholesky(a)
    if method == "blocked":
        return _cholesky_impl(a, precision)
    raise ValueError(f"unknown cholesky method: {method}")
