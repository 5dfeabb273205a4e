"""Binary GP classification via Expectation Propagation (GPML ch. 3.6)
— the companion approximation to the Laplace model in ``gpc.py``; EP's
probit moments make it the more accurate of the two classical schemes
for classification posteriors (GPML sec. 3.7.2).

Model: y in {-1, +1}, PROBIT likelihood p(y|f) = Phi(y f), GP prior
f ~ N(0, K). Each likelihood term is approximated by a scaled Gaussian
site t~_i(f_i) = Z~_i N(f_i | nu~_i/tau~_i, 1/tau~_i) (natural
parameters tau~ >= 0, nu~). Structure: PARALLEL EP — every
sweep recomputes the joint posterior once (one Cholesky of
B = I + S~^1/2 K S~^1/2) and then moment-matches ALL sites
simultaneously (vectorized cavity + probit-moment algebra,
no sequential rank-1 updates), with damping on the natural parameters
for convergence. Fixed sweep count inside a lax.scan keeps the graph
static and lets hyperparameter gradients flow by AD, exactly like the
Newton scan in the Laplace models.

The EP marginal likelihood is computed from first principles (not the
book's rearrangement), which makes the derivation auditable:

  Z_EP = int N(f|0,K) prod_i Z~_i N(f_i|mu~_i, 1/tau~_i) df
       = [prod_i Z~_i] * N(mu~ | 0, K + S~^-1)
  log Z~_i = log Phi(z_i) - log N(mu_-i - mu~_i | 0, s2_-i + 1/tau~_i)

(each site's scale preserves the tilted distribution's mass against the
cavity). Verified against brute-force quasi-Monte-Carlo integration of
the exact log Z in tests/test_gpc_ep.py.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from cugp_tpu.ops import cholesky as chol_ops
from cugp_tpu.ops import kernels as kernel_ops
from cugp_tpu.ops import trsm as trsm_ops

_HI = jax.lax.Precision.HIGHEST
_TAU_FLOOR = 1e-6
LOG2PI = math.log(2.0 * math.pi)


def _posterior_from_sites(K, tau, nu):
    """mu, sigma2 (marginals), L = chol(B), sr = sqrt(tau).

    Sigma = (K^-1 + S~)^-1 = K - K S^1/2 B^-1 S^1/2 K with
    B = I + S^1/2 K S^1/2; mu = Sigma nu~.
    """
    n = K.shape[0]
    sr = jnp.sqrt(tau)
    B = jnp.eye(n, dtype=K.dtype) + sr[:, None] * K * sr[None, :]
    L = chol_ops.cholesky(B, method="xla")
    V = trsm_ops.solve_lx(L, sr[:, None] * K)           # (n, n)
    Sigma = K - jnp.matmul(V.mT, V, precision=_HI)
    mu = jnp.matmul(Sigma, nu[:, None], precision=_HI)[:, 0]
    return mu, jnp.diagonal(Sigma), L, sr


def _probit_moments(y, mu_c, s2_c):
    """Tilted-distribution moments against the probit likelihood
    (GPML eqs. 3.58): returns (logZhat, mu_hat, s2_hat)."""
    denom = jnp.sqrt(1.0 + s2_c)
    z = y * mu_c / denom
    logZ = norm.logcdf(z)
    ratio = jnp.exp(norm.logpdf(z) - logZ)              # phi(z)/Phi(z)
    mu_hat = mu_c + y * s2_c * ratio / denom
    s2_hat = s2_c - s2_c ** 2 * ratio / (1.0 + s2_c) * (z + ratio)
    return logZ, mu_hat, jnp.maximum(s2_hat, 1e-10)


def _ep_sweeps(K, y, num_sweeps=30, damping=0.7):
    """Parallel-EP fixed-point iteration. Returns (tau, nu, mu, s2)."""

    def sweep(carry, _):
        tau, nu = carry
        mu, s2, _L, _sr = _posterior_from_sites(K, tau, nu)
        # cavity (natural params); guard against negative cavity precision
        tau_c = jnp.maximum(1.0 / s2 - tau, _TAU_FLOOR)
        nu_c = mu / s2 - nu
        mu_c = nu_c / tau_c
        s2_c = 1.0 / tau_c
        _logZ, mu_hat, s2_hat = _probit_moments(y, mu_c, s2_c)
        tau_new = jnp.maximum(1.0 / s2_hat - tau_c, _TAU_FLOOR)
        nu_new = mu_hat / s2_hat - nu_c
        tau = (1.0 - damping) * tau + damping * tau_new
        nu = (1.0 - damping) * nu + damping * nu_new
        return (tau, nu), None

    n = y.shape[0]
    tau0 = jnp.full((n,), _TAU_FLOOR, K.dtype)
    nu0 = jnp.zeros((n,), K.dtype)
    (tau, nu), _ = jax.lax.scan(sweep, (tau0, nu0), None,
                                length=num_sweeps)
    mu, s2, _L, _sr = _posterior_from_sites(K, tau, nu)
    return tau, nu, mu, s2


@partial(jax.jit, static_argnames=("kind", "jitter", "method",
                                   "num_sweeps", "damping"))
def ep_lml(params, X, y, kind="rbf", jitter=1e-6, method="auto",
           num_sweeps=30, damping=0.7):
    """EP approximate log marginal likelihood (module-docstring formula,
    QMC-verified in tests)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    tau, nu, mu, s2 = _ep_sweeps(K, y, num_sweeps, damping)
    n = y.shape[0]
    # cavities at the fixed point
    tau_c = jnp.maximum(1.0 / s2 - tau, _TAU_FLOOR)
    nu_c = mu / s2 - nu
    mu_c = nu_c / tau_c
    s2_c = 1.0 / tau_c
    logZhat, _mh, _sh = _probit_moments(y, mu_c, s2_c)
    mu_t = nu / tau
    # site normalizers: log Zhat_i - log N(mu_c - mu_t | 0, s2_c + 1/tau)
    v = s2_c + 1.0 / tau
    log_sites = jnp.sum(
        logZhat + 0.5 * (jnp.log(v) + LOG2PI)
        + 0.5 * (mu_c - mu_t) ** 2 / v)
    # log N(mu_t | 0, K + S^-1) via B = I + S^1/2 K S^1/2:
    #   log|K + S^-1| = log|B| - sum log tau
    _mu, _s2, L, sr = _posterior_from_sites(K, tau, nu)
    w = trsm_ops.solve_lx(L, sr * mu_t)
    quad = jnp.sum(w * w)   # mu_t^T S^1/2 B^-1 S^1/2 mu_t
    logdet = (2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
              - jnp.sum(jnp.log(tau)))
    log_gauss = -0.5 * (n * LOG2PI + logdet + quad)
    return log_sites + log_gauss


@partial(jax.jit, static_argnames=("kind", "jitter", "method",
                                   "num_sweeps", "damping"))
def predict_proba(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  num_sweeps=30, damping=0.7):
    """Predictive p(y=+1 | x*) (GPML eqs. 3.60-3.61 — the probit
    integral is EXACT for EP, unlike the Laplace/MacKay approximation).
    Returns (prob, f_mean, f_var)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    tau, nu, _mu, _s2 = _ep_sweeps(K, y, num_sweeps, damping)
    _m, _v, L, sr = _posterior_from_sites(K, tau, nu)

    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)  # (n, m)
    # mu* = k*^T (K + S^-1)^-1 mu_t = k*^T S^1/2 B^-1 S^1/2 mu_t
    mu_t = nu / tau
    w = trsm_ops.solve_ltx(L, trsm_ops.solve_lx(L, sr * mu_t))
    mu_s = jnp.einsum("nm,n->m", Ks, sr * w, precision=_HI)
    V = trsm_ops.solve_lx(L, sr[:, None] * Ks)
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var_s = jnp.maximum(kss - jnp.sum(V * V, axis=0), 1e-10)
    prob = norm.cdf(mu_s / jnp.sqrt(1.0 + var_s))
    return prob, mu_s, var_s


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=100, learning_rate=0.05, num_sweeps=30, damping=0.7,
        num_newton=None):
    """MAP hyperparameter learning by maximizing the EP marginal (same
    jitted lax.scan Adam loop as the Laplace models; num_newton accepted
    and ignored for facade signature compatibility)."""
    import optax

    from cugp_tpu.inference import map_opt

    tx = optax.apply_if_finite(optax.adam(learning_rate), 100)

    @jax.jit
    def run(params, X, y):
        state = tx.init(params)

        def step(carry, _):
            p, s = carry
            val, g = jax.value_and_grad(
                lambda p: -ep_lml(p, X, y, kind=kind, jitter=jitter,
                                  method=method, num_sweeps=num_sweeps,
                                  damping=damping))(p)
            updates, s = tx.update(g, s, p)
            p = map_opt._clamp(optax.apply_updates(p, updates))
            return (p, s), val

        (params, _), losses = jax.lax.scan(step, (params, state), None,
                                           length=steps)
        return params, losses

    params, losses = run(init_params, X, y)
    return params, {"loss": losses, "lml": -losses[-1]}
