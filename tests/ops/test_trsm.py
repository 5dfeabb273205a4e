"""C4 triangular solves vs scipy (SURVEY.md section 4, unit tier)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import linalg as sla

from cugp_tpu.ops import trsm as trsm_ops


def _lower(n, rng):
    l = np.tril(rng.standard_normal((n, n)) * 0.1)
    np.fill_diagonal(l, np.abs(np.diag(l)) + 1.0)
    return l


@pytest.mark.parametrize("n,k", [(64, 8), (300, 33), (1536, 64)])
def test_solve_lx(n, k, rng):
    l = _lower(n, rng)
    b = rng.standard_normal((n, k))
    x_ref = sla.solve_triangular(l, b, lower=True)
    x = trsm_ops.solve_lx(jnp.asarray(l, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("n", [300, 1536])
def test_solve_ltx(n, rng):
    l = _lower(n, rng)
    b = rng.standard_normal((n, 5))
    x_ref = sla.solve_triangular(l, b, lower=True, trans="T")
    x = trsm_ops.solve_ltx(jnp.asarray(l, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("n", [256, 1536])
def test_solve_xlt(n, rng):
    l = _lower(n, rng)
    b = rng.standard_normal((7, n))
    x_ref = sla.solve_triangular(l, b.T, lower=True).T  # X L^T = B
    x = trsm_ops.solve_xlt(jnp.asarray(l, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)


def test_solve_vector_rhs(rng):
    l = _lower(128, rng)
    b = rng.standard_normal(128)
    x_ref = sla.solve_triangular(l, b, lower=True)
    x = trsm_ops.solve_lx(jnp.asarray(l, jnp.float32), jnp.asarray(b, jnp.float32))
    assert x.shape == (128,)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)


def test_cho_solve(rng):
    n = 200
    a = np.eye(n) + 0.1 * np.ones((n, n))
    l = np.linalg.cholesky(a)
    b = rng.standard_normal(n)
    x_ref = np.linalg.solve(a, b)
    x = trsm_ops.cho_solve(jnp.asarray(l, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("solve", ["lx", "ltx", "xlt"])
@pytest.mark.parametrize("n", [300, 520])
def test_recursive_solves_two_levels(solve, n, rng, monkeypatch):
    """The recursion (split, GEMM coupling, base triangular_solve) at two
    levels and a split that is not a power of two, via a small base."""
    from cugp_tpu.ops import blocking

    monkeypatch.setattr(trsm_ops, "_BASE", 128)
    monkeypatch.setattr(blocking, "ALIGN", 64)
    l = _lower(n, rng)
    k = 9
    if solve == "lx":
        b = rng.standard_normal((n, k))
        x_ref = sla.solve_triangular(l, b, lower=True)
        x = trsm_ops.solve_lx(jnp.asarray(l, jnp.float32),
                              jnp.asarray(b, jnp.float32))
    elif solve == "ltx":
        b = rng.standard_normal((n, k))
        x_ref = sla.solve_triangular(l, b, lower=True, trans="T")
        x = trsm_ops.solve_ltx(jnp.asarray(l, jnp.float32),
                               jnp.asarray(b, jnp.float32))
    else:
        b = rng.standard_normal((k, n))
        x_ref = sla.solve_triangular(l, b.T, lower=True).T  # X L^T = B
        x = trsm_ops.solve_xlt(jnp.asarray(l, jnp.float32),
                               jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-2, atol=1e-3)
