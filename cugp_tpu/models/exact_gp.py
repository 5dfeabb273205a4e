"""Exact GP regression model — components C5/C6 (SURVEY.md section 2).

Pure functions composing the ops tier (C1 covariance, C2 Cholesky, C4 TRSM)
into the log-marginal likelihood, its gradients (via jax.grad through the
custom-VJP Cholesky), and the posterior predictive. This is the JAX
analog of the reference's hand-derived CUDA LML/gradient kernels
(BASELINE.json:5, "log-marginal-likelihood gradients for hyperparameter
learning", "triangular solves for the posterior mean/variance").

Everything here is jit-compatible and differentiable; the whole fit loop runs
as ONE XLA program (see inference/map_opt.py) with no host round-trips,
replacing the reference's host-side optimizer loop.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from cugp_tpu.ops import cholesky as chol_ops
from cugp_tpu.ops import kernels as kernel_ops
from cugp_tpu.ops import trsm as trsm_ops

LOG2PI = math.log(2.0 * math.pi)


def safe_cholesky(K, sf2, method="auto", max_attempts=2, jitter0=1e-6):
    """Cholesky with an escalating-jitter retry ladder (jit-compatible).

    fp32 factorization of a barely-PD covariance can produce NaNs
    (SURVEY.md section 7, hard part 1). Each failed attempt multiplies the
    added diagonal jitter by 100x. Bounded unrolled attempts keep shapes
    static; the extra cost when the first attempt succeeds is one
    is-finite reduction per level (lax.cond skips the recomputation).
    """
    n = K.shape[-1]
    eye = jnp.eye(n, dtype=K.dtype)

    def attempt(i):
        extra = jnp.where(i == 0, 0.0, jitter0 * (100.0**i)) * sf2
        return chol_ops.cholesky(K + extra * eye, method=method)

    L = attempt(0)
    for i in range(1, max_attempts):
        ok = jnp.isfinite(jnp.sum(jnp.diagonal(L, axis1=-2, axis2=-1)))
        L = jax.lax.cond(ok, lambda L: L, lambda L: attempt(i), L)
    return L


def _factorize(params, X, y, kind, jitter, method, safe=True, n_true=None):
    """K -> L, alpha = K^{-1} y."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    n_true=n_true)
    if safe:
        sf2 = kernel_ops.signal_scale(params)
        L = safe_cholesky(K, sf2, method=method, jitter0=max(jitter, 1e-6))
    else:
        L = chol_ops.cholesky(K, method=method)
    alpha = trsm_ops.cho_solve(L, y)
    return L, alpha


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "safe",
                                   "n_true"))
def log_marginal_likelihood(params, X, y, kind="rbf", jitter=1e-6, method="auto",
                            safe=True, n_true=None):
    """LML = -1/2 y^T alpha - sum_i log L_ii - N/2 log 2pi.

    Padded inputs: zero-pad X rows and y, pass the true count as n_true —
    the covariance builder writes an identity block beyond it, padded
    log-diagonal terms are log 1 = 0, padded alpha entries are 0, and the
    -N/2 log 2pi constant uses n_true; the result is exactly the unpadded
    LML (tested in tests/integration).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method, safe, n_true)
    n = n_true if n_true is not None else y.shape[-1]
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    quad = jnp.sum(y * alpha, axis=-1)
    return -0.5 * quad - logdet_half - 0.5 * n * LOG2PI


lml_value_and_grad = jax.jit(
    jax.value_and_grad(log_marginal_likelihood),
    static_argnames=("kind", "jitter", "method", "safe", "n_true"),
)


@partial(jax.jit, static_argnames=("kind", "jitter", "method",
                                   "include_noise", "n_true"))
def posterior(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
              include_noise=False, n_true=None):
    """Posterior mean and diagonal variance at test points Xs.

    mu* = K*^T alpha;  v = L^{-1} K*;  var* = k** - sum(v*v, axis=0).
    n_true: true training-row count when X/y are zero-padded (cross
    covariance rows beyond it are masked so padded rows don't contribute).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method, True, n_true)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind,
                                     n_true=n_true)
    mu = jnp.einsum("nm,n->m", Ks, alpha,
                    precision=jax.lax.Precision.HIGHEST)
    V = trsm_ops.solve_lx(L, Ks)
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var = kss - jnp.sum(V * V, axis=0)
    if include_noise:
        var = var + jnp.exp(params["log_noise_var"])
    return mu, jnp.maximum(var, 0.0)


@partial(jax.jit, static_argnames=("kind", "jitter", "method"))
def posterior_full_cov(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto"):
    """Posterior mean and FULL covariance at test points Xs."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)
    Kss = kernel_ops.cross_covariance(params, Xs, Xs, kind=kind)
    mu = jnp.einsum("nm,n->m", Ks, alpha,
                    precision=jax.lax.Precision.HIGHEST)
    V = trsm_ops.solve_lx(L, Ks)
    cov = Kss - jnp.matmul(V.T, V, precision=jax.lax.Precision.HIGHEST)
    return mu, cov


# ---- Multi-output (shared kernel) regression ----
# p independent outputs sharing X and hyperparameters: ONE covariance and
# ONE Cholesky serve all outputs — the solves batch over the RHS axis
# (the reference is strictly single-output).


@partial(jax.jit, static_argnames=("kind", "jitter", "method"))
def log_marginal_likelihood_multi(params, X, Y, kind="rbf", jitter=1e-6,
                                  method="auto"):
    """Sum of per-output LMLs for Y (n, p) under one shared kernel."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    sf2 = kernel_ops.signal_scale(params)
    L = safe_cholesky(K, sf2, method=method, jitter0=max(jitter, 1e-6))
    alpha = trsm_ops.cho_solve(L, Y)  # (n, p)
    n, p = Y.shape
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L)))
    quad = jnp.sum(Y * alpha, axis=0)  # (p,)
    return jnp.sum(-0.5 * quad - logdet_half - 0.5 * n * LOG2PI)


@partial(jax.jit, static_argnames=("kind", "jitter", "method",
                                   "include_noise"))
def posterior_multi(params, X, Y, Xs, kind="rbf", jitter=1e-6,
                    method="auto", include_noise=False):
    """Posterior means (ns, p) and shared diagonal variance (ns,)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    sf2 = kernel_ops.signal_scale(params)
    L = safe_cholesky(K, sf2, method=method, jitter0=max(jitter, 1e-6))
    alpha = trsm_ops.cho_solve(L, Y)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)
    mu = jnp.matmul(Ks.mT, alpha, precision=jax.lax.Precision.HIGHEST)
    V = trsm_ops.solve_lx(L, Ks)
    var = kernel_ops.kernel_diag(params, Xs, kind) - jnp.sum(V * V, axis=0)
    if include_noise:
        var = var + jnp.exp(params["log_noise_var"])
    return mu, jnp.maximum(var, 0.0)


# ---- Explicit basis functions (semiparametric GP, GPML section 2.7) ----
# g(x) = f(x) + h(x)^T beta with f ~ GP and beta marginalized under the
# vague-prior limit (O'Hagan): closed-form corrections to the posterior
# and the marginal likelihood. Bases: "constant" (h = [1]) and "linear"
# (h = [1, x]). The reference has no mean-function support (zero-mean
# only); this is beyond-parity surface on the same ops tier.


def basis_matrix(X, basis):
    """H with rows h_j evaluated at the inputs: (m_b, n)."""
    n = X.shape[0]
    ones = jnp.ones((1, n), X.dtype)
    if basis == "constant":
        return ones
    if basis == "linear":
        return jnp.concatenate([ones, X.T], axis=0)
    raise ValueError(f"unknown basis: {basis}")


def _basis_terms(L, y, H, method):
    """A = H K^-1 H^T, c = H K^-1 y, and K^-1 H^T (shared solves)."""
    KinvHt = trsm_ops.cho_solve(L, H.T)  # (n, m_b)
    A = jnp.matmul(H, KinvHt, precision=jax.lax.Precision.HIGHEST)
    m_b = A.shape[0]
    A = A + 1e-8 * jnp.eye(m_b, dtype=A.dtype) * jnp.trace(A) / m_b
    c = jnp.matmul(KinvHt.mT, y[:, None],
                   precision=jax.lax.Precision.HIGHEST)[:, 0]
    return A, c, KinvHt


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "basis"))
def log_marginal_likelihood_basis(params, X, y, kind="rbf", jitter=1e-6,
                                  method="auto", basis="linear"):
    """LML with marginalized basis coefficients (GPML eq. 2.45, vague
    limit): lml_0 + 1/2 c^T A^-1 c - 1/2 log|A| + (m_b/2) log 2pi."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = y.shape[-1]
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L)))
    lml0 = (-0.5 * jnp.sum(y * alpha) - logdet_half - 0.5 * n * LOG2PI)
    H = basis_matrix(X, basis)
    A, c, _ = _basis_terms(L, y, H, method)
    La = chol_ops.cholesky(A, method="xla")
    w = trsm_ops.solve_lx(La, c)
    m_b = H.shape[0]
    return (lml0 + 0.5 * jnp.sum(w * w)
            - jnp.sum(jnp.log(jnp.diagonal(La))) + 0.5 * m_b * LOG2PI)


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "basis",
                                   "include_noise"))
def posterior_basis(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
                    basis="linear", include_noise=False):
    """Posterior mean/variance with the marginalized basis (GPML 2.7):

    mean += R^T beta_hat,  var += diag(R^T A^-1 R),
    R = H(Xs) - H K^-1 K*,  beta_hat = A^-1 c.
    Returns (mu, var, beta_hat).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)
    mu0 = jnp.einsum("nm,n->m", Ks, alpha,
                     precision=jax.lax.Precision.HIGHEST)
    V = trsm_ops.solve_lx(L, Ks)
    var0 = kernel_ops.kernel_diag(params, Xs, kind) - jnp.sum(V * V, axis=0)

    H = basis_matrix(X, basis)
    Hs = basis_matrix(Xs, basis)
    A, c, KinvHt = _basis_terms(L, y, H, method)
    La = chol_ops.cholesky(A, method="xla")
    beta = trsm_ops.cho_solve(La, c)
    R = Hs - jnp.matmul(KinvHt.mT, Ks,
                        precision=jax.lax.Precision.HIGHEST)  # (m_b, ns)
    mu = mu0 + jnp.einsum("bm,b->m", R, beta,
                          precision=jax.lax.Precision.HIGHEST)
    W = trsm_ops.solve_lx(La, R)
    var = var0 + jnp.sum(W * W, axis=0)
    if include_noise:
        var = var + jnp.exp(params["log_noise_var"])
    return mu, jnp.maximum(var, 0.0), beta


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "basis"))
def posterior_basis_full_cov(params, X, y, Xs, kind="rbf", jitter=1e-6,
                             method="auto", basis="linear"):
    """Posterior mean and FULL covariance with the marginalized basis
    (GPML eq. 2.42): cov = cov_0 + R^T A^-1 R with
    R = H(Xs) - H K^-1 K*. Returns (mu, cov, beta_hat)."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)
    Kss = kernel_ops.cross_covariance(params, Xs, Xs, kind=kind)
    mu0 = jnp.einsum("nm,n->m", Ks, alpha,
                     precision=jax.lax.Precision.HIGHEST)
    V = trsm_ops.solve_lx(L, Ks)
    cov0 = Kss - jnp.matmul(V.T, V, precision=jax.lax.Precision.HIGHEST)

    H = basis_matrix(X, basis)
    Hs = basis_matrix(Xs, basis)
    A, c, KinvHt = _basis_terms(L, y, H, method)
    La = chol_ops.cholesky(A, method="xla")
    beta = trsm_ops.cho_solve(La, c)
    R = Hs - jnp.matmul(KinvHt.mT, Ks,
                        precision=jax.lax.Precision.HIGHEST)  # (m_b, ns)
    mu = mu0 + jnp.einsum("bm,b->m", R, beta,
                          precision=jax.lax.Precision.HIGHEST)
    W = trsm_ops.solve_lx(La, R)
    cov = cov0 + jnp.matmul(W.T, W, precision=jax.lax.Precision.HIGHEST)
    return mu, cov, beta


@partial(jax.jit, static_argnames=("kind", "jitter", "method"))
def loo_cv(params, X, y, kind="rbf", jitter=1e-6, method="auto"):
    """Leave-one-out cross-validation from ONE factorization (GPML
    section 5.4.2, eqs 5.10-5.12) — no refits.

    With alpha = K^{-1} y and c = diag(K^{-1}):
        mu_i     = y_i - alpha_i / c_i     (LOO predictive mean at x_i)
        sigma2_i = 1 / c_i                 (LOO predictive variance)
        logp_i   = -1/2 log sigma2_i - (y_i - mu_i)^2 / (2 sigma2_i)
                   - 1/2 log 2pi
    K includes the noise term, so (mu_i, sigma2_i) predict the NOISY
    observation y_i. diag(K^{-1}) comes from one triangular solve:
    K^{-1} = L^{-T} L^{-1}, so c_i = ||(L^{-1})[:, i]||^2.

    Returns (mu, var, logp), each (n,). sum(logp) is the LOO
    pseudo-likelihood (the objective of map_opt.fit(objective="loo")).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = y.shape[-1]
    Linv = trsm_ops.solve_lx(L, jnp.eye(n, dtype=L.dtype))
    c = jnp.maximum(jnp.sum(Linv * Linv, axis=0), 1e-30)
    var = 1.0 / c
    mu = y - alpha / c
    logp = -0.5 * jnp.log(var) - 0.5 * c * (y - mu) ** 2 - 0.5 * LOG2PI
    return mu, var, logp


@partial(jax.jit, static_argnames=("kind", "jitter", "method"))
def loo_pseudo_likelihood(params, X, y, kind="rbf", jitter=1e-6,
                          method="auto"):
    """Sum of LOO predictive log-densities (GPML eq 5.11) — a scalar,
    differentiable objective for hyperparameter selection that is more
    robust to prior misspecification than the LML (GPML section 5.4.2)."""
    _, _, logp = loo_cv(params, X, y, kind=kind, jitter=jitter,
                        method=method)
    return jnp.sum(logp)


@partial(jax.jit, static_argnames=("kind", "jitter", "method"))
def lml_gradients_analytic(params, X, y, kind="rbf", jitter=1e-6, method="auto"):
    """Analytic LML gradients: 1/2 tr((alpha alpha^T - K^{-1}) dK/dtheta).

    Kept as a cross-check against jax.grad (the reference computes gradients
    this way in CUDA). Cost: one Cholesky + explicit K^{-1} (two TRSMs).
    """
    kernel_ops.require_base_kind(kind, "lml_gradients_analytic")
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = X.shape[0]
    eye = jnp.eye(n, dtype=L.dtype)
    Kinv = trsm_ops.cho_solve(L, eye)
    W = jnp.outer(alpha, alpha) - Kinv

    ell = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(params["log_signal_var"])
    sn2 = jnp.exp(params["log_noise_var"])

    if kind == "linear":
        # K = sf2 (X/ell)(X'/ell)^T + b: dK/dlog sf2 = K - b (+ jitter diag),
        # dK/dlog ell_k = -2 sf2 outer(x_k, x_k)/ell_k^2, dK/dlog b = b J.
        Xs = X / ell
        cross = jnp.matmul(Xs, Xs.T, precision=jax.lax.Precision.HIGHEST)
        out = {
            "log_signal_var": 0.5 * (sf2 * jnp.sum(W * cross)
                                     + jitter * sf2 * jnp.trace(W)),
            "log_noise_var": 0.5 * sn2 * jnp.trace(W),
            "log_lengthscale": jax.vmap(
                lambda xk: -sf2 * jnp.dot(xk, jnp.matmul(
                    W, xk, precision=jax.lax.Precision.HIGHEST)),
                in_axes=1)(Xs),
        }
        if "log_bias_var" in params:
            b = jnp.exp(params["log_bias_var"])
            out["log_bias_var"] = 0.5 * b * jnp.sum(W)
        return out

    if kind == "periodic":
        # K = sf2 exp(-2 sum_d sin^2(u_d)/ell_d^2), u_d = pi delta_d / p_d:
        # dK/dlog ell_d = K * 4 sin^2(u_d)/ell_d^2;
        # dK/dlog p_d = K * 2 u_d sin(2 u_d) / ell_d^2.
        p = jnp.exp(params["log_period"])
        u = (math.pi * (X[:, None, :] - X[None, :, :]) / p)  # (n, n, d)
        s2u = jnp.sin(u) ** 2
        Kf = sf2 * jnp.exp(-2.0 * jnp.sum(s2u / ell**2, axis=-1))
        g_lsf = 0.5 * (jnp.sum(W * Kf) + jitter * sf2 * jnp.trace(W))
        g_lsn = 0.5 * sn2 * jnp.trace(W)
        WK = W * Kf
        g_ell = jax.vmap(
            lambda sk, ellk: 0.5 * jnp.sum(WK * (4.0 * sk / ellk**2)),
            in_axes=(2, 0))(s2u, ell)
        g_per = jax.vmap(
            lambda uk, ellk: 0.5 * jnp.sum(
                WK * (2.0 * uk * jnp.sin(2.0 * uk) / ellk**2)),
            in_axes=(2, 0))(u, ell)
        return {
            "log_lengthscale": g_ell,
            "log_signal_var": g_lsf,
            "log_noise_var": g_lsn,
            "log_period": g_per,
        }

    alpha = (jnp.exp(params["log_alpha"])
             if kind == "rq" and "log_alpha" in params else None)
    d2 = kernel_ops.scaled_sqdist(X, X, ell)
    Kf = sf2 * kernel_ops.kernel_fn(d2, kind, alpha)

    g_lsf = 0.5 * (jnp.sum(W * Kf) + jitter * sf2 * jnp.trace(W))
    g_lsn = 0.5 * sn2 * jnp.trace(W)

    r = jnp.sqrt(jnp.maximum(d2, 1e-30))
    g_lal = None
    if kind == "rbf":
        dk_dd2 = -0.5 * Kf
    elif kind == "rq":
        a = jnp.asarray(1.0 if alpha is None else alpha)
        logb = jnp.log1p(d2 / (2.0 * a))
        # k = sf2 (1 + d2/2a)^{-a}: dk/dd2 = -1/2 sf2 (1+d2/2a)^{-a-1};
        # dk/dlog a = k * a * (-log(1+d2/2a) + d2/(2a + d2))
        dk_dd2 = -0.5 * sf2 * jnp.exp(-(a + 1.0) * logb)
        dK_dla = Kf * a * (-logb + d2 / (2.0 * a + d2))
        g_lal = 0.5 * jnp.sum(W * dK_dla)
    elif kind == "matern12":
        dk_dd2 = sf2 * jnp.exp(-r) * (-0.5 / r)
    elif kind == "matern32":
        dk_dd2 = sf2 * (-1.5) * jnp.exp(-math.sqrt(3.0) * r)
    elif kind == "matern52":
        s5 = math.sqrt(5.0)
        dk_dd2 = sf2 * (-(5.0 / 6.0)) * (1.0 + s5 * r) * jnp.exp(-s5 * r)
    else:
        raise ValueError(kind)

    offdiag = 1.0 - jnp.eye(n, dtype=L.dtype)

    def per_dim(xk, ellk):
        diff2 = (xk[:, None] - xk[None, :]) ** 2 / ellk**2
        dK = dk_dd2 * (-2.0 * diff2) * offdiag
        return 0.5 * jnp.sum(W * dK)

    g_ell = jax.vmap(per_dim, in_axes=(1, 0))(X, ell)
    out = {
        "log_lengthscale": g_ell,
        "log_signal_var": g_lsf,
        "log_noise_var": g_lsn,
    }
    if g_lal is not None:
        out["log_alpha"] = g_lal
    return out
