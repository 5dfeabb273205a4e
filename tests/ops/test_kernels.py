"""C1 covariance builder vs float64 oracle (SURVEY.md section 4, unit tier)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cugp_tpu.ops import kernels as kops
from cugp_tpu.oracle import exact_gp_np as oracle

KINDS = ["rbf", "matern12", "matern32", "matern52"]


def _params32(p):
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_cross_covariance_matches_oracle(kind, rng, default_params):
    X1 = rng.uniform(-2, 2, size=(65, 3))
    X2 = rng.uniform(-2, 2, size=(33, 3))
    p = dict(default_params, log_lengthscale=np.log([0.8, 1.1, 0.6]))
    K_ref = oracle.kernel_matrix(p, X1, X2, kind)
    K = kops.cross_covariance(_params32(p), jnp.asarray(X1, jnp.float32),
                              jnp.asarray(X2, jnp.float32), kind)
    np.testing.assert_allclose(np.asarray(K), K_ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_train_covariance_diag(kind, rng, default_params):
    X = rng.uniform(-2, 2, size=(50, 2))
    p = dict(default_params, log_lengthscale=np.log([0.8, 1.1]))
    K_ref = oracle.train_covariance(p, X, kind, jitter=1e-6)
    K = kops.train_covariance(_params32(p), jnp.asarray(X, jnp.float32), kind,
                              jitter=1e-6)
    np.testing.assert_allclose(np.asarray(K), K_ref, rtol=2e-5, atol=2e-6)
    # symmetric, PD diag
    np.testing.assert_allclose(np.asarray(K), np.asarray(K).T, atol=1e-6)


def test_kernel_value_at_zero_distance(default_params):
    for kind in KINDS:
        v = kops.kernel_fn(jnp.asarray(0.0), kind)
        np.testing.assert_allclose(float(v), 1.0, atol=1e-5)


def test_init_params_shapes():
    p = kops.init_params(d=3, lengthscale=0.5)
    assert p["log_lengthscale"].shape == (3,)
    assert p["log_signal_var"].shape == ()
    np.testing.assert_allclose(np.exp(p["log_lengthscale"]), 0.5, rtol=1e-6)


def test_rq_kernel_matches_oracle(rng, default_params):
    X1 = rng.uniform(-2, 2, size=(50, 2))
    X2 = rng.uniform(-2, 2, size=(30, 2))
    p = dict(default_params, log_lengthscale=np.log([0.8, 1.1]),
             log_alpha=np.array(np.log(2.0)))
    K_ref = oracle.kernel_matrix(p, X1, X2, "rq")
    K = kops.cross_covariance(_params32(p), jnp.asarray(X1, jnp.float32),
                              jnp.asarray(X2, jnp.float32), "rq")
    np.testing.assert_allclose(np.asarray(K), K_ref, rtol=2e-5, atol=2e-6)
    # rq -> rbf as alpha -> inf
    p_big = dict(p, log_alpha=np.array(np.log(1e6)))
    K_rq = kops.cross_covariance(_params32(p_big), jnp.asarray(X1, jnp.float32),
                                 jnp.asarray(X2, jnp.float32), "rq")
    K_rbf = kops.cross_covariance(_params32(p), jnp.asarray(X1, jnp.float32),
                                  jnp.asarray(X2, jnp.float32), "rbf")
    np.testing.assert_allclose(np.asarray(K_rq), np.asarray(K_rbf), atol=1e-4)


def test_rq_end_to_end_fit(rng):
    """RQ hyperparameters (incl. alpha) learn via AD out of the box."""
    from cugp_tpu.api import GP
    from cugp_tpu.data import synthetic

    X, y, _ = synthetic.sinusoid_1d(n=150, noise_std=0.2, seed=9)
    gp = GP(kind="rq", method="xla")
    init = kops.init_params(d=1, alpha=1.0)
    info = gp.fit(X, y, steps=80, learning_rate=0.1, init=init)
    assert np.isfinite(float(info["lml"]))
    assert "log_alpha" in gp.params
