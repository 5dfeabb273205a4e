"""Config-1 end-to-end: JAX pipeline vs float64 oracle (SURVEY.md section 4).

Accuracy bar: posterior moments within 1e-3 of the float64 oracle
(BASELINE.json:5; oracle substitution documented in SURVEY.md section 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cugp_tpu.models import exact_gp
from cugp_tpu.oracle import exact_gp_np as oracle
from cugp_tpu.data import synthetic


def _p32(p):
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_lml_matches_oracle(kind, small_dataset, default_params):
    X, y, _ = small_dataset
    lml_ref = oracle.log_marginal_likelihood(default_params, X, y, kind)
    lml = exact_gp.log_marginal_likelihood(
        _p32(default_params), jnp.asarray(X, jnp.float32),
        jnp.asarray(y, jnp.float32), kind=kind, method="xla",
    )
    # fp32 through an N=256 Cholesky: per-datapoint tolerance
    assert abs(float(lml) - lml_ref) / len(y) < 1e-3


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_posterior_matches_oracle(kind, small_dataset, default_params):
    X, y, _ = small_dataset
    Xs = np.linspace(-3, 3, 101)[:, None]
    mu_ref, var_ref = oracle.posterior(default_params, X, y, Xs, kind)
    mu, var = exact_gp.posterior(
        _p32(default_params), jnp.asarray(X, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(Xs, jnp.float32),
        kind=kind, method="xla",
    )
    np.testing.assert_allclose(np.asarray(mu), mu_ref, atol=1e-3)
    np.testing.assert_allclose(np.asarray(var), var_ref, atol=1e-3)


def test_posterior_full_cov_consistent(small_dataset, default_params):
    X, y, _ = small_dataset
    Xs = np.linspace(-2, 2, 32)[:, None]
    mu_d, var_d = exact_gp.posterior(
        _p32(default_params), jnp.asarray(X, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(Xs, jnp.float32), method="xla",
    )
    mu_f, cov = exact_gp.posterior_full_cov(
        _p32(default_params), jnp.asarray(X, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(Xs, jnp.float32), method="xla",
    )
    np.testing.assert_allclose(np.asarray(mu_d), np.asarray(mu_f), atol=1e-5)
    np.testing.assert_allclose(np.asarray(var_d), np.diag(np.asarray(cov)),
                               atol=1e-3)


def test_grad_matches_analytic_oracle(small_dataset, default_params):
    """jax.grad through the pipeline vs the float64 analytic gradient."""
    X, y, _ = small_dataset
    g_ref = oracle.lml_gradients(default_params, X, y, "rbf")
    _, g = exact_gp.lml_value_and_grad(
        _p32(default_params), jnp.asarray(X, jnp.float32),
        jnp.asarray(y, jnp.float32), kind="rbf", method="xla",
    )
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g[k]), g_ref[k], rtol=2e-2,
                                   atol=2e-2)


def test_analytic_grad_jax_matches_ad(small_dataset, default_params):
    """In-repo analytic gradient (C5 cross-check) vs jax.grad."""
    X, y, _ = small_dataset
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    p = _p32(default_params)
    _, g_ad = exact_gp.lml_value_and_grad(p, Xj, yj, kind="rbf", method="xla")
    g_an = exact_gp.lml_gradients_analytic(p, Xj, yj, kind="rbf", method="xla")
    for k in g_ad:
        np.testing.assert_allclose(np.asarray(g_an[k]), np.asarray(g_ad[k]),
                                   rtol=2e-2, atol=2e-2)


def test_padding_invariance(default_params):
    """n_true padding contract: padded LML and posterior EXACTLY match the
    unpadded results (the padded rows become an identity block)."""
    X, y, _ = synthetic.sinusoid_1d(n=100, seed=3)
    Xp, yp = synthetic.pad_dataset(X, y, 128)
    p = _p32(default_params)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    Xpj = jnp.asarray(Xp, jnp.float32)
    ypj = jnp.asarray(yp, jnp.float32)

    lml = float(exact_gp.log_marginal_likelihood(p, Xj, yj, method="xla"))
    lml_pad = float(exact_gp.log_marginal_likelihood(
        p, Xpj, ypj, method="xla", n_true=100))
    assert abs(lml_pad - lml) < 1e-3, (lml_pad, lml)

    Xs = jnp.asarray(np.linspace(-3, 3, 33)[:, None], jnp.float32)
    mu, var = exact_gp.posterior(p, Xj, yj, Xs, method="xla")
    mu_p, var_p = exact_gp.posterior(p, Xpj, ypj, Xs, method="xla",
                                     n_true=100)
    np.testing.assert_allclose(np.asarray(mu_p), np.asarray(mu), atol=1e-4)
    np.testing.assert_allclose(np.asarray(var_p), np.asarray(var), atol=1e-4)


@pytest.mark.deep
def test_hyperparameter_recovery():
    """MAP fit on data from known theta recovers it (config-2 style, small)."""
    from cugp_tpu.api import GP

    X, y, true_params = synthetic.gp_draw(n=300, d=2, lengthscale=0.7,
                                          signal_var=1.5, noise_var=0.05,
                                          seed=7)
    gp = GP(kind="rbf", method="xla")
    info = gp.fit(X, y, steps=150, learning_rate=0.1)
    assert np.isfinite(float(info["lml"]))
    ell = np.exp(np.asarray(gp.params["log_lengthscale"]))
    np.testing.assert_allclose(ell, 0.7, rtol=0.5)
    sn2 = float(np.exp(gp.params["log_noise_var"]))
    np.testing.assert_allclose(sn2, 0.05, rtol=1.0)
    # fit must improve on the init LML
    assert info["loss"][-1] < info["loss"][0]


def test_safe_cholesky_recovers_from_nonpd():
    """Jitter-escalation ladder rescues a barely-PD fp32 covariance."""
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as kops

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(-1, 1, (300, 2)), jnp.float32)
    # enormous lengthscale + negligible noise: fp32-singular K
    p = {"log_lengthscale": jnp.asarray([5.0, 5.0], jnp.float32),
         "log_signal_var": jnp.asarray(0.0, jnp.float32),
         "log_noise_var": jnp.asarray(-25.0, jnp.float32)}
    K = kops.train_covariance(p, X, jitter=0.0)
    L_plain = jax.lax.linalg.cholesky(K)
    assert not bool(jnp.all(jnp.isfinite(L_plain))), "expected plain chol to fail"
    L_safe = exact_gp.safe_cholesky(K, jnp.exp(p["log_signal_var"]),
                                    method="xla")
    assert bool(jnp.all(jnp.isfinite(jnp.diagonal(L_safe))))
    # LML through the safe path is finite at these pathological params
    y = jnp.asarray(rng.standard_normal(300), jnp.float32)
    val = exact_gp.log_marginal_likelihood(p, X, y, jitter=0.0, method="xla")
    assert np.isfinite(float(val))
