"""Periodic (exp-sine-squared) and linear (dot-product) kernel families.

Round-2 surface beyond the reference's RBF/Matern inventory
(BASELINE.json:5); validated against the float64 oracle across every tier:
XLA builder, analytic gradients vs jax.grad vs oracle, posterior
(exercising the non-stationary kernel_diag path), and the iterative
matrix-free tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cugp_tpu.models import exact_gp
from cugp_tpu.ops import kernels as kops
from cugp_tpu.oracle import exact_gp_np as oracle

NEW_KINDS = ["periodic", "linear"]


def _params(kind, d=3):
    p = kops.default_init(kind, d=d, lengthscale=0.9, signal_var=1.4,
                          noise_var=0.2)
    if kind == "periodic":
        p["log_period"] = jnp.log(jnp.asarray([1.7, 0.9, 2.3][:d]))
    if kind == "linear":
        p["log_bias_var"] = jnp.asarray(np.log(0.3), jnp.float32)
    return p


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_cross_covariance_matches_oracle(kind, rng):
    X1 = rng.uniform(-2, 2, size=(65, 3)).astype(np.float32)
    X2 = rng.uniform(-2, 2, size=(33, 3)).astype(np.float32)
    p = _params(kind)
    K_ref = oracle.kernel_matrix(p, X1, X2, kind)
    K = kops.cross_covariance(p, jnp.asarray(X1), jnp.asarray(X2), kind)
    np.testing.assert_allclose(np.asarray(K), K_ref, rtol=2e-5, atol=3e-6)


def test_periodic_is_periodic(rng):
    """k(x, x + period) == k(x, x) exactly — the defining property."""
    p = _params("periodic", d=1)
    p["log_period"] = jnp.log(jnp.asarray([1.5]))
    X = rng.uniform(-2, 2, size=(20, 1)).astype(np.float32)
    K0 = kops.cross_covariance(p, jnp.asarray(X), jnp.asarray(X), "periodic")
    K1 = kops.cross_covariance(p, jnp.asarray(X),
                               jnp.asarray(X) + 1.5, "periodic")
    np.testing.assert_allclose(np.asarray(K0), np.asarray(K1), atol=2e-5)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_gradients_analytic_vs_ad_vs_oracle(kind, rng):
    X = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    y = rng.normal(size=(40,)).astype(np.float32)
    p = _params(kind)
    g_or = oracle.lml_gradients(p, X, y, kind)
    g_an = exact_gp.lml_gradients_analytic(p, jnp.asarray(X), jnp.asarray(y),
                                           kind=kind, method="xla")
    _, g_ad = exact_gp.lml_value_and_grad(p, jnp.asarray(X), jnp.asarray(y),
                                          kind=kind, method="xla")
    for k in g_or:
        np.testing.assert_allclose(np.asarray(g_an[k]), np.asarray(g_or[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(np.asarray(g_ad[k]), np.asarray(g_or[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_posterior_matches_oracle(kind, rng):
    """Exercises kernel_diag — the linear prior diag is NOT sf2."""
    X = rng.uniform(-2, 2, size=(60, 2)).astype(np.float32)
    y = rng.normal(size=(60,)).astype(np.float32)
    Xs = rng.uniform(-2, 2, size=(25, 2)).astype(np.float32)
    p = _params(kind, d=2)
    mu_ref, var_ref = oracle.posterior(p, X, y, Xs, kind)
    mu, var = exact_gp.posterior(p, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(Xs), kind=kind, method="xla")
    np.testing.assert_allclose(np.asarray(mu), mu_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(var), var_ref, rtol=1e-3, atol=1e-4)


def test_kernel_diag_linear(rng):
    X = rng.uniform(-2, 2, size=(30, 2)).astype(np.float32)
    p = _params("linear", d=2)
    dg = kops.kernel_diag(p, jnp.asarray(X), "linear")
    K = kops.cross_covariance(p, jnp.asarray(X), jnp.asarray(X), "linear")
    np.testing.assert_allclose(np.asarray(dg), np.diag(np.asarray(K)),
                               rtol=1e-5, atol=1e-6)


def test_linear_gp_recovers_linear_function(rng):
    """A linear-kernel GP posterior mean IS Bayesian linear regression."""
    n = 80
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    w_true = np.array([1.5, -0.7])
    y = (X @ w_true + 0.3 + 0.01 * rng.normal(size=n)).astype(np.float32)
    Xs = rng.uniform(-2, 2, size=(20, 2)).astype(np.float32)
    p = kops.default_init("linear", d=2, noise_var=1e-4, bias_var=4.0)
    mu, var = exact_gp.posterior(p, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(Xs), kind="linear",
                                 method="xla")
    np.testing.assert_allclose(np.asarray(mu), Xs @ w_true + 0.3, atol=0.05)


def test_periodic_fit_end_to_end():
    """MAP fit on periodic data learns hyperparameters including period."""
    from cugp_tpu.api import GP

    local = np.random.default_rng(7)  # fit quality is init/noise-sensitive
    n = 120
    X = np.linspace(-3, 3, n)[:, None].astype(np.float32)
    y = (np.sin(2 * np.pi * X[:, 0] / 1.3)
         + 0.05 * local.normal(size=n)).astype(np.float32)
    gp = GP(kind="periodic", method="xla")
    info = gp.fit(X, y, steps=150, learning_rate=0.08)
    assert np.isfinite(float(info["lml"]))
    assert "log_period" in gp.params
    # predictions track the function (the fitted period may be a harmonic)
    mu, _ = gp.predict(X)
    assert float(np.mean((np.asarray(mu) - y) ** 2)) < 0.05


def test_linear_fit_and_roundtrip(tmp_path, rng):
    """GP(kind='linear') fit + save/load roundtrip (log_bias_var key)."""
    from cugp_tpu.api import GP

    n = 60
    X = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    y = (2.0 * X[:, 0] + 0.1 * rng.normal(size=n)).astype(np.float32)
    gp = GP(kind="linear", method="xla")
    info = gp.fit(X, y, steps=60, learning_rate=0.1)
    assert np.isfinite(float(info["lml"]))
    assert "log_bias_var" in gp.params
    gp.save(str(tmp_path / "ckpt"))
    gp2 = GP.load(str(tmp_path / "ckpt"))
    assert gp2.kind == "linear"
    np.testing.assert_allclose(np.asarray(gp2.params["log_bias_var"]),
                               np.asarray(gp.params["log_bias_var"]))


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_iterative_matvec_and_grads(kind):
    from cugp_tpu.inference import iterative

    # LOCAL rng, not the session-shared fixture: the MC-noise tolerance
    # below is calibrated for a fixed dataset, and the shared fixture's
    # stream position depends on which tests ran first (order-dependent
    # flake observed for kind='periodic' in full-suite runs)
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, size=(50, 2)).astype(np.float32)
    y = rng.normal(size=(50,)).astype(np.float32)
    p = _params(kind, d=2)
    K = oracle.train_covariance(p, X, kind, jitter=1e-6)
    v = rng.normal(size=(50,)).astype(np.float32)
    mv = iterative.make_matvec(p, jnp.asarray(X), kind=kind, jitter=1e-6,
                               block=32, method="xla")
    np.testing.assert_allclose(np.asarray(mv(jnp.asarray(v))), K @ v,
                               rtol=1e-4, atol=1e-4)
    # matrix-free gradients vs dense analytic. The Hutchinson trace term
    # has O(1/sqrt(probes)) MC noise that grows with cond(K), so use a
    # well-conditioned setup (moderate noise/lengthscale) + many probes;
    # the tile derivatives themselves are checked exactly below.
    p_g = kops.default_init(kind, d=2, lengthscale=1.3, signal_var=1.0,
                            noise_var=0.5)
    if kind == "periodic":
        p_g["log_period"] = jnp.log(jnp.asarray([1.7, 0.9]))
    _, g = iterative.lml_value_and_grad_iterative(
        p_g, jnp.asarray(X), jnp.asarray(y), key=jax.random.key(3),
        kind=kind, block=32, num_probes=256, tol=1e-7, max_iters=300)
    g_ref = oracle.lml_gradients(p_g, X, y, kind)
    for k in g_ref:
        ref = np.asarray(g_ref[k])
        # MC noise scales with ||dK||_F, i.e. with the gradient's own
        # magnitude (the periodic dK/dlog_period tiles are large and
        # oscillatory) — tolerance follows the leaf scale. AD==analytic
        # equality (fp-level) is pinned separately in
        # tests/inference/test_iterative.py.
        np.testing.assert_allclose(
            np.asarray(g[k]), ref, rtol=0.25,
            atol=0.25 * max(1.0, np.abs(ref).max()), err_msg=k)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_dk_tiles_match_finite_differences(kind, rng):
    """Exact (non-stochastic) check of the iterative tier's dK tiles."""
    from cugp_tpu.inference import iterative

    X = rng.uniform(-2, 2, size=(30, 2)).astype(np.float32)
    p = _params(kind, d=2)
    ell = jnp.exp(p["log_lengthscale"])
    sf2 = jnp.exp(p["log_signal_var"])
    per = jnp.exp(p["log_period"]) if kind == "periodic" else None
    extra = (jnp.exp(p["log_bias_var"])
             if kind == "linear" and "log_bias_var" in p else None)
    wrts = {"periodic": [("log_period", 0), ("log_period", 1),
                         ("log_lengthscale", 0), ("log_signal_var", 0)],
            "linear": [("log_lengthscale", 0), ("log_lengthscale", 1),
                       ("log_signal_var", 0), ("log_bias_var", 0)]}[kind]
    eps = 1e-4
    for wrt, k_dim in wrts:
        dk = iterative._dk_tile(jnp.asarray(X), jnp.asarray(X), ell, sf2,
                                kind, wrt, k_dim, extra, per)
        p1, p0 = dict(p), dict(p)
        if np.ndim(p[wrt]) == 0:
            p1[wrt] = p[wrt] + eps
            p0[wrt] = p[wrt] - eps
        else:
            p1[wrt] = jnp.asarray(p[wrt]).at[k_dim].add(eps)
            p0[wrt] = jnp.asarray(p[wrt]).at[k_dim].add(-eps)
        fd = (oracle.kernel_matrix(p1, X, X, kind)
              - oracle.kernel_matrix(p0, X, X, kind)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(dk), fd, rtol=2e-2, atol=2e-2,
                                   err_msg=f"{wrt}[{k_dim}]")


def test_pivoted_precond_linear(rng):
    """Pivoted-Cholesky preconditioner on the (low-rank) linear kernel:
    CG converges in ~rank+1 iterations once preconditioned."""
    from cugp_tpu.inference import iterative

    X = rng.uniform(-2, 2, size=(120, 2)).astype(np.float32)
    y = rng.normal(size=(120,)).astype(np.float32)
    p = _params("linear", d=2)
    mv = iterative.make_matvec(p, jnp.asarray(X), kind="linear",
                               jitter=1e-6, block=64, method="xla")
    pre = iterative.make_pivoted_precond(p, jnp.asarray(X), rank=4,
                                         kind="linear", jitter=1e-6)
    x, iters = iterative.cg_solve(mv, jnp.asarray(y), tol=1e-6,
                                  max_iters=100, precond_apply=pre)
    K = oracle.train_covariance(p, X, "linear", jitter=1e-6)
    np.testing.assert_allclose(K @ np.asarray(x), y, rtol=1e-3, atol=1e-3)
    assert int(iters) <= 10


def test_default_init_families():
    assert "log_alpha" in kops.default_init("rq")
    assert "log_period" in kops.default_init("periodic", d=2)
    assert "log_bias_var" in kops.default_init("linear")
    assert "log_alpha" not in kops.default_init("rbf")


def test_sgpr_linear_bound_tight(rng):
    """SGPR with Z=X equals the exact LML for the linear kernel too
    (exercises the kernel_diag trace-correction path)."""
    from cugp_tpu.models import sgpr

    X = rng.uniform(-2, 2, size=(40, 2)).astype(np.float32)
    y = rng.normal(size=(40,)).astype(np.float32)
    p = _params("linear", d=2)
    e = sgpr.elbo(p, jnp.asarray(X), jnp.asarray(X), jnp.asarray(y),
                  kind="linear", jitter=1e-6)
    lml = oracle.log_marginal_likelihood(p, X, y, "linear", jitter=1e-6)
    np.testing.assert_allclose(float(e), lml, rtol=2e-3, atol=0.15)
