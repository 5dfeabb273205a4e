"""Float64 NumPy/SciPy exact-GP oracle.

This is the correctness oracle and speedup denominator for the JAX engine,
standing in for the reference's serial CPU baseline (see SURVEY.md section 0:
the reference mount was empty, so the float64 closed-form posterior computed
here IS the operative accuracy reference — exact GP regression has a unique
closed-form posterior, so any correct implementation must agree with it).

API mirrors `cugp_tpu.models.exact_gp` exactly, but in float64 on CPU.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg as sla

LOG2PI = float(np.log(2.0 * np.pi))

SUPPORTED_KERNELS = ("rbf", "matern12", "matern32", "matern52", "rq",
                     "periodic", "linear")


def _as_params(params):
    """Normalize a (possibly nested composite) params dict to float64."""
    if isinstance(params, dict):
        return {k: _as_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_as_params(v) for v in params]
    return np.asarray(params, dtype=np.float64)


def _parse_kind(kind):
    """Sum-of-products kind parse — mirrors ops.kernels.parse_kind but
    dependency-free (the oracle must not import the JAX tier)."""
    return tuple(tuple(f.strip() for f in t.split("*"))
                 for t in kind.split("+"))


def signal_scale(params):
    if "terms" in params:
        return float(sum(np.exp(np.asarray(t["log_signal_var"]))
                         for t in params["terms"]))
    return float(np.exp(np.asarray(params["log_signal_var"])))


def scaled_sqdist(X1, X2, lengthscale):
    """Pairwise squared distances of rows after per-dimension scaling."""
    X1 = np.asarray(X1, dtype=np.float64) / lengthscale
    X2 = np.asarray(X2, dtype=np.float64) / lengthscale
    n1 = np.sum(X1 * X1, axis=-1)[:, None]
    n2 = np.sum(X2 * X2, axis=-1)[None, :]
    d2 = n1 + n2 - 2.0 * (X1 @ X2.T)
    return np.maximum(d2, 0.0)


def kernel_fn(d2, kind, alpha=None):
    """Kernel value as a function of the scaled squared distance."""
    if kind == "rbf":
        return np.exp(-0.5 * d2)
    if kind == "rq":
        a = 1.0 if alpha is None else float(alpha)
        return (1.0 + d2 / (2.0 * a)) ** (-a)
    r = np.sqrt(np.maximum(d2, 0.0))
    if kind == "matern12":
        return np.exp(-r)
    if kind == "matern32":
        s = np.sqrt(3.0) * r
        return (1.0 + s) * np.exp(-s)
    if kind == "matern52":
        s = np.sqrt(5.0) * r
        return (1.0 + s + s * s / 3.0) * np.exp(-s)
    raise ValueError(f"unknown kernel kind: {kind}")


def kernel_matrix(params, X1, X2, kind="rbf"):
    """Cross-covariance K(X1, X2) WITHOUT noise."""
    p = _as_params(params)
    if ("+" in kind) or ("*" in kind):
        # composite: sum over terms of amplitude * product of unit factors
        K = None
        for tp, bases in zip(p["terms"], _parse_kind(kind)):
            Kt = None
            for fp, base in zip(tp["factors"], bases):
                f = dict(fp)
                f["log_signal_var"] = np.float64(0.0)
                Kf = kernel_matrix(f, X1, X2, base)
                Kt = Kf if Kt is None else Kt * Kf
            Kt = np.exp(tp["log_signal_var"]) * Kt
            K = Kt if K is None else K + Kt
        return K
    ell = np.exp(p["log_lengthscale"])
    sf2 = np.exp(p["log_signal_var"])
    if kind == "periodic":
        # Direct exp-sine-squared form (GPML eq. 4.31, per-dim ARD):
        # independent of the JAX tier's cos/sin-embedding identity.
        per = np.exp(p["log_period"])
        X1 = np.asarray(X1, np.float64)
        X2 = np.asarray(X2, np.float64)
        s2 = np.sin(np.pi * (X1[:, None, :] - X2[None, :, :]) / per) ** 2
        return sf2 * np.exp(-2.0 * np.sum(s2 / ell**2, axis=-1))
    if kind == "linear":
        X1 = np.asarray(X1, np.float64) / ell
        X2 = np.asarray(X2, np.float64) / ell
        bias = np.exp(p["log_bias_var"]) if "log_bias_var" in p else 0.0
        return sf2 * (X1 @ X2.T) + bias
    d2 = scaled_sqdist(X1, X2, ell)
    alpha = (np.exp(p["log_alpha"]) if kind == "rq" and "log_alpha" in p
             else None)
    return sf2 * kernel_fn(d2, kind, alpha)


def kernel_diag(params, X, kind="rbf"):
    """Prior variance diag k(x, x) (no noise); see kernels.kernel_diag."""
    p = _as_params(params)
    if ("+" in kind) or ("*" in kind):
        D = None
        for tp, bases in zip(p["terms"], _parse_kind(kind)):
            Dt = None
            for fp, base in zip(tp["factors"], bases):
                f = dict(fp)
                f["log_signal_var"] = np.float64(0.0)
                Df = kernel_diag(f, X, base)
                Dt = Df if Dt is None else Dt * Df
            Dt = np.exp(tp["log_signal_var"]) * Dt
            D = Dt if D is None else D + Dt
        return D
    sf2 = np.exp(p["log_signal_var"])
    n = np.asarray(X).shape[0]
    if kind == "linear":
        ell = np.exp(p["log_lengthscale"])
        Xs = np.asarray(X, np.float64) / ell
        bias = np.exp(p["log_bias_var"]) if "log_bias_var" in p else 0.0
        return sf2 * np.sum(Xs * Xs, axis=-1) + bias
    return sf2 * np.ones(n)


def train_covariance(params, X, kind="rbf", jitter=1e-6):
    """K(X, X) + (noise_var + jitter*signal_var) * I."""
    p = _as_params(params)
    K = kernel_matrix(p, X, X, kind)
    sn2 = np.exp(p["log_noise_var"])
    sf2 = signal_scale(p)
    n = K.shape[0]
    return K + (sn2 + jitter * sf2) * np.eye(n)


def _chol_factor(params, X, y, kind, jitter):
    K = train_covariance(params, X, kind, jitter)
    L = sla.cholesky(K, lower=True)
    y = np.asarray(y, dtype=np.float64)
    alpha = sla.solve_triangular(
        L, sla.solve_triangular(L, y, lower=True), lower=True, trans="T"
    )
    return L, alpha


def log_marginal_likelihood(params, X, y, kind="rbf", jitter=1e-6):
    """LML = -1/2 y^T alpha - sum(log diag L) - N/2 log 2pi."""
    L, alpha = _chol_factor(params, X, y, kind, jitter)
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    return float(
        -0.5 * float(y @ alpha) - float(np.sum(np.log(np.diag(L)))) - 0.5 * n * LOG2PI
    )


def loo_cv(params, X, y, kind="rbf", jitter=1e-6):
    """Leave-one-out predictive mean/var/log-density (GPML eqs 5.10-5.12),
    float64 closed form from one factorization: with alpha = K^{-1} y and
    c = diag(K^{-1}), mu_i = y_i - alpha_i / c_i, sigma2_i = 1 / c_i.
    Equals refitting on the n-1 remaining points for every i (the brute
    force is asserted in tests/test_loo.py). Returns (mu, var, logp)."""
    L, alpha = _chol_factor(_as_params(params), X, y, kind, jitter)
    n = L.shape[0]
    Linv = sla.solve_triangular(L, np.eye(n), lower=True)
    c = np.sum(Linv * Linv, axis=0)
    var = 1.0 / c
    y = np.asarray(y, dtype=np.float64)
    mu = y - alpha / c
    logp = -0.5 * np.log(var) - 0.5 * c * (y - mu) ** 2 - 0.5 * LOG2PI
    return mu, var, logp


def posterior(params, X, y, Xs, kind="rbf", jitter=1e-6, include_noise=False):
    """Posterior mean and (diagonal) variance at test points Xs."""
    p = _as_params(params)
    L, alpha = _chol_factor(p, X, y, kind, jitter)
    Ks = kernel_matrix(p, X, Xs, kind)  # (N, M)
    mu = Ks.T @ alpha
    V = sla.solve_triangular(L, Ks, lower=True)  # (N, M)
    var = kernel_diag(p, Xs, kind) - np.sum(V * V, axis=0)
    if include_noise:
        var = var + np.exp(p["log_noise_var"])
    return mu, np.maximum(var, 0.0)


def _basis_matrix(X, basis):
    n = X.shape[0]
    ones = np.ones((1, n))
    if basis == "constant":
        return ones
    if basis == "linear":
        return np.concatenate([ones, np.asarray(X, np.float64).T], axis=0)
    raise ValueError(basis)


def log_marginal_likelihood_basis(params, X, y, kind="rbf", jitter=1e-6,
                                  basis="linear"):
    """Vague-limit marginalized-basis LML (GPML eq. 2.45) in float64."""
    p = _as_params(params)
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    L, alpha = _chol_factor(p, X, y, kind, jitter)
    n = y.shape[0]
    lml0 = (-0.5 * float(y @ alpha) - float(np.sum(np.log(np.diag(L))))
            - 0.5 * n * LOG2PI)
    H = _basis_matrix(X, basis)
    KinvHt = sla.cho_solve((L, True), H.T)
    A = H @ KinvHt
    m_b = A.shape[0]
    A = A + 1e-8 * np.eye(m_b) * np.trace(A) / m_b
    c = KinvHt.T @ y
    La = sla.cholesky(A, lower=True)
    w = sla.solve_triangular(La, c, lower=True)
    return (lml0 + 0.5 * float(w @ w)
            - float(np.sum(np.log(np.diag(La)))) + 0.5 * m_b * LOG2PI)


def posterior_basis(params, X, y, Xs, kind="rbf", jitter=1e-6,
                    basis="linear"):
    p = _as_params(params)
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    Xs = np.asarray(Xs, np.float64)
    L, alpha = _chol_factor(p, X, y, kind, jitter)
    Ks = kernel_matrix(p, X, Xs, kind)
    mu0 = Ks.T @ alpha
    V = sla.solve_triangular(L, Ks, lower=True)
    var0 = kernel_diag(p, Xs, kind) - np.sum(V * V, axis=0)
    H = _basis_matrix(X, basis)
    Hs = _basis_matrix(Xs, basis)
    KinvHt = sla.cho_solve((L, True), H.T)
    A = H @ KinvHt
    m_b = A.shape[0]
    A = A + 1e-8 * np.eye(m_b) * np.trace(A) / m_b
    c = KinvHt.T @ y
    La = sla.cholesky(A, lower=True)
    beta = sla.cho_solve((La, True), c)
    R = Hs - KinvHt.T @ Ks
    mu = mu0 + R.T @ beta
    W = sla.solve_triangular(La, R, lower=True)
    var = var0 + np.sum(W * W, axis=0)
    return mu, np.maximum(var, 0.0), beta


def posterior_basis_full_cov(params, X, y, Xs, kind="rbf", jitter=1e-6,
                             basis="linear"):
    """Full posterior covariance with marginalized basis (GPML eq. 2.42)."""
    p = _as_params(params)
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    Xs = np.asarray(Xs, np.float64)
    L, alpha = _chol_factor(p, X, y, kind, jitter)
    Ks = kernel_matrix(p, X, Xs, kind)
    Kss = kernel_matrix(p, Xs, Xs, kind)
    mu0 = Ks.T @ alpha
    V = sla.solve_triangular(L, Ks, lower=True)
    cov0 = Kss - V.T @ V
    H = _basis_matrix(X, basis)
    Hs = _basis_matrix(Xs, basis)
    KinvHt = sla.cho_solve((L, True), H.T)
    A = H @ KinvHt
    m_b = A.shape[0]
    A = A + 1e-8 * np.eye(m_b) * np.trace(A) / m_b
    c = KinvHt.T @ y
    La = sla.cholesky(A, lower=True)
    beta = sla.cho_solve((La, True), c)
    R = Hs - KinvHt.T @ Ks
    mu = mu0 + R.T @ beta
    W = sla.solve_triangular(La, R, lower=True)
    return mu, cov0 + W.T @ W, beta


def lml_gradients(params, X, y, kind="rbf", jitter=1e-6):
    """Analytic LML gradients w.r.t. log-hyperparameters.

    dLML/dtheta = 1/2 tr((alpha alpha^T - K^{-1}) dK/dtheta).
    Cross-check for jax.grad through the JAX pipeline.
    """
    p = _as_params(params)
    ell = np.exp(p["log_lengthscale"])
    sf2 = np.exp(p["log_signal_var"])
    sn2 = np.exp(p["log_noise_var"])
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]

    L, alpha = _chol_factor(p, X, y, kind, jitter)
    Kinv = sla.cho_solve((L, True), np.eye(n))
    W = np.outer(alpha, alpha) - Kinv  # (alpha alpha^T - K^{-1})

    if kind == "linear":
        Xs = X / ell
        cross = Xs @ Xs.T
        g_ell = np.array([-sf2 * float(Xs[:, k] @ (W @ Xs[:, k]))
                          for k in range(ell.shape[0])])
        out = {
            "log_lengthscale": g_ell,
            "log_signal_var": np.asarray(
                0.5 * (sf2 * np.sum(W * cross)
                       + jitter * sf2 * np.trace(W))),
            "log_noise_var": np.asarray(0.5 * sn2 * np.trace(W)),
        }
        if "log_bias_var" in p:
            b = np.exp(p["log_bias_var"])
            out["log_bias_var"] = np.asarray(0.5 * b * np.sum(W))
        return out

    if kind == "periodic":
        per = np.exp(p["log_period"])
        u = np.pi * (X[:, None, :] - X[None, :, :]) / per  # (n, n, d)
        s2u = np.sin(u) ** 2
        Kf = sf2 * np.exp(-2.0 * np.sum(s2u / ell**2, axis=-1))
        WK = W * Kf
        g_ell = np.array([0.5 * np.sum(WK * 4.0 * s2u[..., k] / ell[k] ** 2)
                          for k in range(ell.shape[0])])
        g_per = np.array([
            0.5 * np.sum(WK * 2.0 * u[..., k] * np.sin(2.0 * u[..., k])
                         / ell[k] ** 2)
            for k in range(ell.shape[0])])
        return {
            "log_lengthscale": g_ell,
            "log_signal_var": np.asarray(
                0.5 * (np.sum(W * Kf) + jitter * sf2 * np.trace(W))),
            "log_noise_var": np.asarray(0.5 * sn2 * np.trace(W)),
            "log_period": g_per,
        }

    alpha = (np.exp(p["log_alpha"]) if kind == "rq" and "log_alpha" in p
             else None)
    d2 = scaled_sqdist(X, X, ell)
    Kf = sf2 * kernel_fn(d2, kind, alpha)  # noise-free covariance

    # d K / d log_signal_var = Kf  (+ jitter term on diag)
    dK_dlsf = Kf + jitter * sf2 * np.eye(n)
    g_lsf = 0.5 * np.sum(W * dK_dlsf)

    # d K / d log_noise_var = sn2 * I
    g_lsn = 0.5 * sn2 * np.trace(W)

    # d K / d log_ell_k: dK/d d2 * d d2/d log_ell_k, with
    # d d2 / d log_ell_k = -2 * (x_k - x'_k)^2 / ell_k^2
    r = np.sqrt(np.maximum(d2, 1e-300))
    g_lal = None
    if kind == "rbf":
        dk_dd2 = -0.5 * Kf
    elif kind == "rq":
        a = 1.0 if alpha is None else float(alpha)
        logb = np.log1p(d2 / (2.0 * a))
        dk_dd2 = -0.5 * sf2 * np.exp(-(a + 1.0) * logb)
        dK_dla = Kf * a * (-logb + d2 / (2.0 * a + d2))
        g_lal = 0.5 * np.sum(W * dK_dla)
    elif kind == "matern12":
        dk_dd2 = sf2 * np.exp(-r) * (-0.5 / r)
    elif kind == "matern32":
        s3 = np.sqrt(3.0)
        dk_dd2 = sf2 * (-1.5) * np.exp(-s3 * r)
    elif kind == "matern52":
        s5 = np.sqrt(5.0)
        dk_dd2 = sf2 * (-(5.0 / 6.0)) * (1.0 + s5 * r) * np.exp(-s5 * r)
    else:
        raise ValueError(kind)

    g_ell = np.zeros_like(ell)
    for k in range(ell.shape[0]):
        diff2 = (X[:, k][:, None] - X[:, k][None, :]) ** 2 / ell[k] ** 2
        dK = dk_dd2 * (-2.0 * diff2)
        np.fill_diagonal(dK, 0.0)  # r=0 diagonal: derivative is 0
        g_ell[k] = 0.5 * np.sum(W * dK)

    out = {
        "log_lengthscale": g_ell,
        "log_signal_var": np.asarray(g_lsf),
        "log_noise_var": np.asarray(g_lsn),
    }
    if g_lal is not None:
        out["log_alpha"] = np.asarray(g_lal)
    return out
