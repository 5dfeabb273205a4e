"""Sparse GP regression (Titsias collapsed bound) — beyond-reference surface.

SGPR with m inducing points: O(n m^2) instead of O(n^3), the standard
scalable exact-flavoured GP. Collapsed evidence lower bound (Titsias 2009):

  ELBO = log N(y | 0, Q_nn + sigma^2 I) - 1/(2 sigma^2) tr(K_nn - Q_nn)

computed through m x m factorizations only:
  L   = chol(K_mm + jitter I)
  A   = L^{-1} K_mn / sigma          (m x n)
  B   = I + A A^T,  L_B = chol(B)
  c   = L_B^{-1} A y / sigma
  ELBO = -n/2 log(2 pi sigma^2) - sum log diag(L_B)
         - ||y||^2/(2 sigma^2) + ||c||^2 / 2
         - (tr(K_nn) - tr(A A^T)) / (2 sigma^2)

With Z = X (m = n) the bound equals the exact LML (up to jitter), which is
the correctness oracle used in tests. All dense ops ride the same
covariance/Cholesky tier as the exact model.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import optax

from cugp_tpu.ops import kernels as kernel_ops

LOG2PI = math.log(2.0 * math.pi)
_HI = jax.lax.Precision.HIGHEST


def _common(params, Z, X, y, kind, jitter):
    m = Z.shape[0]
    sn2 = jnp.exp(params["log_noise_var"])
    sf2 = kernel_ops.signal_scale(params)
    Kmm = kernel_ops.cross_covariance_xla(params, Z, Z, kind)
    # K_mm is noise-free and can be fp32-singular (e.g. Z dense in X);
    # escalating-jitter ladder keeps the factorization finite
    from cugp_tpu.models import exact_gp as _exact

    Kmm = Kmm + (jitter * sf2 + 1e-6) * jnp.eye(m, dtype=Kmm.dtype)
    Kmn = kernel_ops.cross_covariance_xla(params, Z, X, kind)
    L = _exact.safe_cholesky(Kmm, sf2, method="xla", max_attempts=3,
                             jitter0=1e-5)
    A = jax.lax.linalg.triangular_solve(L, Kmn, left_side=True, lower=True)
    A = A / jnp.sqrt(sn2)
    B = jnp.eye(m, dtype=A.dtype) + jnp.matmul(A, A.mT, precision=_HI)
    LB = jnp.linalg.cholesky(B)
    Ay = A @ y
    c = jax.lax.linalg.triangular_solve(LB, Ay[:, None], left_side=True,
                                        lower=True)[:, 0]
    c = c / jnp.sqrt(sn2)
    return L, A, LB, c, sn2, sf2


@partial(jax.jit, static_argnames=("kind", "jitter"))
def elbo(params, Z, X, y, kind="rbf", jitter=1e-6):
    """Collapsed SGPR evidence lower bound."""
    n = X.shape[0]
    L, A, LB, c, sn2, sf2 = _common(params, Z, X, y, kind, jitter)
    out = -0.5 * n * (LOG2PI + jnp.log(sn2))
    out = out - jnp.sum(jnp.log(jnp.diagonal(LB)))      # -1/2 log|B|
    out = out - 0.5 * jnp.sum(y * y) / sn2 + 0.5 * jnp.sum(c * c)
    # trace correction -1/(2 sn2) (tr K_nn - tr Q_nn), with
    # tr(Q_nn)/sn2 = tr(A A^T); kernel_diag handles non-stationary kinds
    tr_knn = jnp.sum(kernel_ops.kernel_diag(params, X, kind))
    out = out - 0.5 * tr_knn / sn2 + 0.5 * jnp.sum(A * A)
    return out


@partial(jax.jit, static_argnames=("kind", "jitter", "include_noise"))
def posterior(params, Z, X, y, Xs, kind="rbf", jitter=1e-6,
              include_noise=False):
    """SGPR predictive mean/variance at Xs.

    mu* = K*m L^{-T} L_B^{-T} c
    var* = k** - ||L^{-1} K_m*||^2 + ||L_B^{-1} L^{-1} K_m*||^2 (+ sn2)
    """
    L, A, LB, c, sn2, sf2 = _common(params, Z, X, y, kind, jitter)
    Kms = kernel_ops.cross_covariance_xla(params, Z, Xs, kind)  # (m, s)
    tmp1 = jax.lax.linalg.triangular_solve(L, Kms, left_side=True, lower=True)
    tmp2 = jax.lax.linalg.triangular_solve(LB, tmp1, left_side=True,
                                           lower=True)
    mu = tmp2.mT @ c
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var = (kss - jnp.sum(tmp1 * tmp1, axis=0)
           + jnp.sum(tmp2 * tmp2, axis=0))
    if include_noise:
        var = var + sn2
    return mu, jnp.maximum(var, 0.0)


def init_inducing(X, m, seed=0):
    """Inducing locations: random training subset (k-means-free default)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = rng.choice(X.shape[0], size=min(m, X.shape[0]), replace=False)
    return jnp.asarray(X)[jnp.asarray(np.sort(idx))]


@partial(jax.jit, static_argnames=("kind", "jitter", "steps", "learning_rate",
                                   "optimize_inducing"))
def _fit_scan(params, Z, X, y, kind, jitter, steps, learning_rate,
              optimize_inducing):
    from cugp_tpu.inference import map_opt

    def loss_fn(trainables):
        p = trainables["params"]
        z = trainables["Z"] if optimize_inducing else Z
        return -elbo(p, z, X, y, kind=kind, jitter=jitter)

    trainables = {"params": params}
    if optimize_inducing:
        trainables["Z"] = Z
    tx = optax.apply_if_finite(optax.adam(learning_rate), 1000)
    opt_state = tx.init(trainables)

    def step(carry, _):
        tr, s = carry
        loss, grads = jax.value_and_grad(loss_fn)(tr)
        updates, s = tx.update(grads, s, tr)
        tr = optax.apply_updates(tr, updates)
        tr["params"] = map_opt._clamp(tr["params"])
        return (tr, s), loss

    (trainables, _), losses = jax.lax.scan(step, (trainables, opt_state),
                                           None, length=steps)
    z_out = trainables["Z"] if optimize_inducing else Z
    return trainables["params"], z_out, losses


def fit(init_params, X, y, *, num_inducing=512, Z=None, kind="rbf",
        jitter=1e-6, steps=500, learning_rate=0.05, optimize_inducing=True,
        seed=0):
    """Maximize the collapsed ELBO over hyperparameters (+ inducing locs)."""
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    if Z is None:
        Z = init_inducing(X, num_inducing, seed=seed)
    params, Z, losses = _fit_scan(init_params, Z, X, y, kind, jitter, steps,
                                  learning_rate, optimize_inducing)
    return params, Z, {"loss": losses, "elbo": -losses[-1]}
