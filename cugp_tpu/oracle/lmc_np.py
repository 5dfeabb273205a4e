"""float64 brute-force oracle for the LMC multi-output GP (models/lmc.py).

Builds the dense pn x pn joint covariance kron(B, Kf + jitter*sf2*I) +
sn2*I explicitly (the thing the JAX model NEVER forms — it uses the
eigendecomposition rotation) and computes LML / posterior by direct
Cholesky. Output-major vec ordering: block j of vec(Y) is output j's
column, matching the rotated per-output algebra.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg as sla

from cugp_tpu.oracle import exact_gp_np as gp_np

LOG2PI = math.log(2.0 * math.pi)


def _as64(params):
    return {k: np.asarray(v, np.float64) for k, v in params.items()}


def coregionalization(params):
    p = _as64(params)
    A = p["lmc_A"]
    d = np.log1p(np.exp(p["lmc_raw_d"])) + 1e-6  # softplus
    return A @ A.T + np.diag(d)


def _joint_cov(params, X, kind, jitter):
    p = _as64(params)
    B = coregionalization(p)
    Kf = gp_np.kernel_matrix(p, X, X, kind)
    sf2 = gp_np.signal_scale(p)
    sn2 = np.exp(p["log_noise_var"])
    n = Kf.shape[0]
    Kmod = Kf + jitter * sf2 * np.eye(n)
    return np.kron(B, Kmod) + sn2 * np.eye(B.shape[0] * n)


def log_marginal_likelihood(params, X, Y, kind="rbf", jitter=1e-6):
    Y = np.asarray(Y, np.float64)
    n, p_out = Y.shape
    Kbig = _joint_cov(params, X, kind, jitter)
    L = sla.cholesky(Kbig, lower=True)
    yv = Y.T.reshape(-1)  # output-major
    alpha = sla.solve_triangular(
        L, sla.solve_triangular(L, yv, lower=True), lower=True, trans="T")
    return float(-0.5 * yv @ alpha - np.sum(np.log(np.diag(L)))
                 - 0.5 * n * p_out * LOG2PI)


def posterior(params, X, Y, Xs, kind="rbf", jitter=1e-6,
              include_noise=False):
    """Returns (mean (m, p), per-point output covariance (m, p, p))."""
    p64 = _as64(params)
    Y = np.asarray(Y, np.float64)
    n, p_out = Y.shape
    m = np.asarray(Xs).shape[0]
    B = coregionalization(p64)
    Kbig = _joint_cov(params, X, kind, jitter)
    L = sla.cholesky(Kbig, lower=True)
    yv = Y.T.reshape(-1)
    alpha = sla.solve_triangular(
        L, sla.solve_triangular(L, yv, lower=True), lower=True, trans="T")
    Ks = gp_np.kernel_matrix(p64, X, Xs, kind)      # (n, m)
    Kss = gp_np.kernel_matrix(p64, Xs, Xs, kind)    # (m, m)
    Ks_big = np.kron(B, Ks)                          # (pn, pm)
    mean = (Ks_big.T @ alpha).reshape(p_out, m).T    # (m, p)
    V = sla.solve_triangular(L, Ks_big, lower=True)  # (pn, pm)
    cov_big = np.kron(B, Kss) - V.T @ V              # (pm, pm)
    cov = np.empty((m, p_out, p_out))
    for s in range(m):
        idx = np.arange(p_out) * m + s
        cov[s] = cov_big[np.ix_(idx, idx)]
    if include_noise:
        sn2 = np.exp(p64["log_noise_var"])
        cov += sn2 * np.eye(p_out)[None]
    return mean, cov


# ---- rank-Q LMC with distinct latent kernels (models/lmc.py lmcq_*) ----

def _latent_unit64(fp):
    out = {k: np.asarray(v, np.float64) for k, v in fp.items()}
    out["log_signal_var"] = np.asarray(0.0)
    return out


def _joint_cov_q(params, X1, X2, kinds):
    A = np.asarray(params["lmc_a"], np.float64)   # (Q, p)
    S = None
    for q, (fp, kind) in enumerate(zip(params["latents"], kinds)):
        Kq = gp_np.kernel_matrix(_latent_unit64(fp), X1, X2, kind)
        Bq = np.outer(A[q], A[q])
        term = np.kron(Bq, Kq)
        S = term if S is None else S + term
    return S


def log_marginal_likelihood_q(params, X, Y, kinds, jitter=1e-6):
    Y = np.asarray(Y, np.float64)
    n, p_out = Y.shape
    S = _joint_cov_q(params, X, X, kinds)
    sn2 = float(np.exp(np.asarray(params["log_noise_var"], np.float64)))
    scale = float(np.max(np.sum(np.asarray(params["lmc_a"],
                                           np.float64) ** 2, axis=0)))
    S = S + (sn2 + jitter * scale) * np.eye(p_out * n)
    L = sla.cholesky(S, lower=True)
    yv = Y.T.reshape(-1)
    alpha = sla.solve_triangular(
        L, sla.solve_triangular(L, yv, lower=True), lower=True, trans="T")
    return float(-0.5 * yv @ alpha - np.sum(np.log(np.diag(L)))
                 - 0.5 * n * p_out * LOG2PI)


def posterior_q(params, X, Y, Xs, kinds, jitter=1e-6, include_noise=False):
    """Returns (mean (m, p), per-output variance (m, p))."""
    Y = np.asarray(Y, np.float64)
    n, p_out = Y.shape
    m = np.asarray(Xs).shape[0]
    S = _joint_cov_q(params, X, X, kinds)
    sn2 = float(np.exp(np.asarray(params["log_noise_var"], np.float64)))
    scale = float(np.max(np.sum(np.asarray(params["lmc_a"],
                                           np.float64) ** 2, axis=0)))
    S = S + (sn2 + jitter * scale) * np.eye(p_out * n)
    L = sla.cholesky(S, lower=True)
    yv = Y.T.reshape(-1)
    alpha = sla.solve_triangular(
        L, sla.solve_triangular(L, yv, lower=True), lower=True, trans="T")
    Kcross = _joint_cov_q(params, X, Xs, kinds)     # (pn, pm)
    mean = (Kcross.T @ alpha).reshape(p_out, m).T
    A = np.asarray(params["lmc_a"], np.float64)
    prior = None
    for q, (fp, kind) in enumerate(zip(params["latents"], kinds)):
        dq = gp_np.kernel_diag(_latent_unit64(fp), np.asarray(Xs), kind)
        dq = np.broadcast_to(np.asarray(dq, np.float64), (m,))
        term = np.outer(dq, A[q] ** 2)              # (m, p)
        prior = term if prior is None else prior + term
    V = sla.solve_triangular(L, Kcross, lower=True)
    var = prior - np.sum(V * V, axis=0).reshape(p_out, m).T
    if include_noise:
        var = var + sn2
    return mean, np.maximum(var, 0.0)
