"""C2 Cholesky: cuSOLVER (xla) and recursive blocked vs scipy (SURVEY.md sec 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import linalg as sla

from cugp_tpu.ops import cholesky as chol_ops


def _spd(n, rng, cond=1e3):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return (q * eigs) @ q.T


@pytest.mark.parametrize("n", [64, 256, 300])
def test_xla_cholesky_matches_scipy(n, rng):
    a = _spd(n, rng)
    l_ref = sla.cholesky(a, lower=True)
    l = chol_ops.cholesky(jnp.asarray(a, jnp.float32), method="xla")
    np.testing.assert_allclose(np.asarray(l), l_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.deep
@pytest.mark.parametrize("n", [1536, 2304])
def test_blocked_recursion_matches_scipy(n, rng):
    """Exercises the recursion (n > base=1024) with XLA base case."""
    a = _spd(n, rng, cond=1e4)
    l_ref = sla.cholesky(a, lower=True)
    l = chol_ops.cholesky(jnp.asarray(a, jnp.float32), method="blocked")
    np.testing.assert_allclose(np.asarray(l), l_ref, rtol=5e-2, atol=5e-4)
    # reconstruction accuracy is the meaningful fp32 metric
    rec = np.asarray(l) @ np.asarray(l).T
    np.testing.assert_allclose(rec, a, rtol=1e-3, atol=1e-4)


def test_custom_vjp_matches_xla_grad(rng):
    """d/dA of f(chol(A)) via custom VJP vs jnp.linalg.cholesky AD."""
    n = 96
    a = _spd(n, rng)
    a32 = jnp.asarray(a, jnp.float32)

    def f_ours(a):
        l = chol_ops.cholesky((a + a.T) / 2, method="blocked")
        return jnp.sum(jnp.log(jnp.diagonal(l))) + jnp.sum(l**2) * 1e-3

    def f_ref(a):
        l = jnp.linalg.cholesky((a + a.T) / 2)
        return jnp.sum(jnp.log(jnp.diagonal(l))) + jnp.sum(l**2) * 1e-3

    g_ours = jax.grad(f_ours)(a32)
    g_ref = jax.grad(f_ref)(a32)
    np.testing.assert_allclose(np.asarray(g_ours), np.asarray(g_ref),
                               rtol=1e-3, atol=1e-5)


def test_batched_cholesky_gradient(rng):
    """Custom VJP must handle leading batch dims (regression: diagflat)."""
    n = 16
    batch = np.stack([_spd(n, rng), _spd(n, rng)])
    a = jnp.asarray(batch, jnp.float32)

    def f(a):
        l = chol_ops.cholesky(a, method="blocked")
        return jnp.sum(jnp.log(jnp.abs(jnp.diagonal(l, axis1=-2, axis2=-1))))

    g = jax.grad(f)(a)
    assert g.shape == (2, n, n)
    g_ref = jax.grad(lambda a: jnp.sum(jnp.log(jnp.diagonal(
        jnp.linalg.cholesky(a), axis1=-2, axis2=-1))))(a)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-3,
                               atol=1e-5)


def test_blocked_recursion_small_base_matches_scipy(rng, monkeypatch):
    """Quick-tier recursion coverage: shrink the base-case size so the
    full recursive split/TRSM/SYRK structure (two levels) is exercised
    at n=640 in ~a second; the production-BASE variants (1536/2304) are
    the deep-tier versions of this same check."""
    from cugp_tpu.ops import cholesky as chol_ops

    monkeypatch.setattr(chol_ops, "_BASE", 256)
    monkeypatch.setattr(chol_ops, "_SYRK_FULL", 256)
    n = 640
    a = rng.standard_normal((n, n))
    a = (a @ a.T + n * np.eye(n)).astype(np.float32)
    l = chol_ops.cholesky(jnp.asarray(a), method="blocked")
    import scipy.linalg as sla

    l_ref = sla.cholesky(np.asarray(a, np.float64), lower=True)
    np.testing.assert_allclose(np.asarray(l), l_ref, rtol=2e-4, atol=2e-3)
