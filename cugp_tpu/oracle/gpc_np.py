"""Float64 NumPy oracle for Laplace-approximation GP classification.

Mirrors cugp_tpu.models.gpc (GPML Algorithms 3.1/3.2) in double precision
on CPU — the accuracy reference for the JAX path, same role as
exact_gp_np for regression (SURVEY.md section 0).
"""

from __future__ import annotations

import numpy as np
from scipy import linalg as sla

from cugp_tpu.oracle import exact_gp_np
from cugp_tpu.oracle.exact_gp_np import kernel_matrix, train_covariance


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _mode(K, y, num_newton=50, tol=1e-12):
    n = y.shape[0]
    f = np.zeros(n)
    a = np.zeros(n)
    t = 0.5 * (y + 1.0)
    for _ in range(num_newton):
        pi = _sigmoid(f)
        grad = t - pi
        w = np.maximum(pi * (1.0 - pi), 1e-10)
        sw = np.sqrt(w)
        B = np.eye(n) + (sw[:, None] * K) * sw[None, :]
        L = sla.cholesky(B, lower=True)
        b = w * f + grad
        kb = K @ b
        inner = sla.solve_triangular(L, sw * kb, lower=True)
        a_new = b - sw * sla.solve_triangular(L.T, inner, lower=False)
        f_new = K @ a_new
        if np.max(np.abs(f_new - f)) < tol:
            f, a = f_new, a_new
            break
        f, a = f_new, a_new
    return f, a


def laplace_lml(params, X, y, kind="rbf", jitter=1e-6, num_newton=50):
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    f, a = _mode(K, y, num_newton)
    t = 0.5 * (y + 1.0)
    pi = _sigmoid(f)
    loglik = np.sum(np.where(t > 0.5, np.log(np.maximum(pi, 1e-300)),
                             np.log(np.maximum(1.0 - pi, 1e-300))))
    w = np.maximum(pi * (1.0 - pi), 1e-10)
    sw = np.sqrt(w)
    n = y.shape[0]
    B = np.eye(n) + (sw[:, None] * K) * sw[None, :]
    L = sla.cholesky(B, lower=True)
    return (-0.5 * np.dot(a, f) + loglik - np.sum(np.log(np.diag(L))))


def predict_proba(params, X, y, Xs, kind="rbf", jitter=1e-6, num_newton=50):
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    f, a = _mode(K, y, num_newton)
    t = 0.5 * (y + 1.0)
    pi = _sigmoid(f)
    grad = t - pi
    w = np.maximum(pi * (1.0 - pi), 1e-10)
    sw = np.sqrt(w)
    n = y.shape[0]
    B = np.eye(n) + (sw[:, None] * K) * sw[None, :]
    L = sla.cholesky(B, lower=True)
    Ks = kernel_matrix(params, X, Xs, kind)
    mu = Ks.T @ grad
    v = sla.solve_triangular(L, sw[:, None] * Ks, lower=True)
    var = np.maximum(exact_gp_np.kernel_diag(params, Xs, kind)
                     - np.sum(v * v, axis=0), 1e-10)
    kappa = 1.0 / np.sqrt(1.0 + (np.pi / 8.0) * var)
    return _sigmoid(kappa * mu), mu, var
