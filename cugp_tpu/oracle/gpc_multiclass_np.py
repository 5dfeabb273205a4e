"""Float64 NumPy oracle for multiclass softmax-Laplace GP classification.

Mirrors cugp_tpu.models.gpc_multiclass (GPML Algorithms 3.3/3.4) in double
precision on CPU — same role as gpc_np for the binary model. Written with
explicit per-class loops and, where cheap, the BRUTE-FORCE Cn x Cn forms
of W and B so the tests can verify the structured identities the JAX
model relies on (determinant split, Woodbury form of (K + W^-1)^-1).
"""

from __future__ import annotations

import numpy as np
from scipy import linalg as sla

from cugp_tpu.oracle import exact_gp_np
from cugp_tpu.oracle.exact_gp_np import kernel_matrix, train_covariance


def _softmax(f):
    z = f - f.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _class_factors(K, pi):
    """Per-class L_c, E_c and M = chol(sum_c E_c) (GPML Alg 3.3 inner)."""
    n, C = pi.shape
    L = np.zeros((C, n, n))
    E = np.zeros((C, n, n))
    for c in range(C):
        sw = np.sqrt(pi[:, c])
        B = np.eye(n) + (sw[:, None] * K) * sw[None, :]
        L[c] = sla.cholesky(B, lower=True)
        A = sla.solve_triangular(L[c], np.diag(sw), lower=True)
        E[c] = A.T @ A
    M = sla.cholesky(E.sum(axis=0) + 1e-12 * np.eye(n), lower=True)
    return L, E, M


def _mode(K, Y, num_newton=100, tol=1e-12):
    n, C = Y.shape
    f = np.zeros((n, C))
    a = np.zeros((n, C))
    for _ in range(num_newton):
        pi = _softmax(f)
        _L, E, M = _class_factors(K, pi)
        wf = pi * f - pi * (pi * f).sum(axis=1, keepdims=True)
        b = wf + Y - pi
        kb = K @ b
        c = np.stack([E[j] @ kb[:, j] for j in range(C)], axis=1)
        rc = c.sum(axis=1)
        s = sla.solve_triangular(
            M.T, sla.solve_triangular(M, rc, lower=True), lower=False)
        es = np.stack([E[j] @ s for j in range(C)], axis=1)
        a_new = b - c + es
        f_new = K @ a_new
        done = np.max(np.abs(f_new - f)) < tol
        f, a = f_new, a_new
        if done:
            break
    return f, a


def dense_W(pi):
    """Brute-force Cn x Cn W = D - Pi Pi^T (class-major block order)."""
    n, C = pi.shape
    p = pi.T.reshape(-1)  # class-major stacking
    W = np.diag(p)
    for c in range(C):
        for d in range(C):
            W[c * n:(c + 1) * n, d * n:(d + 1) * n] -= np.diag(
                pi[:, c] * pi[:, d])
    return W


def laplace_lml(params, X, Y, kind="rbf", jitter=1e-6, num_newton=100,
                brute_force_logdet=False):
    """Approximate LML (GPML eq. 3.44). With brute_force_logdet=True the
    -1/2 log|B| term is computed from the dense Cn x Cn matrix instead of
    the structured prod|L_c|^2 |M|^2 split — used by tests to certify the
    identity the JAX model depends on."""
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    f, a = _mode(K, Y, num_newton)
    pi = _softmax(f)
    fmax = f.max(axis=1)
    lse = np.log(np.exp(f - fmax[:, None]).sum(axis=1)) + fmax
    obj = -0.5 * np.sum(a * f) + np.sum(Y * f) - np.sum(lse)
    if brute_force_logdet:
        n, C = Y.shape
        W = dense_W(pi)
        sqW = sla.sqrtm(W + 1e-14 * np.eye(n * C)).real
        Kbig = np.kron(np.eye(C), K)
        B = np.eye(n * C) + sqW @ Kbig @ sqW
        logdet_half = 0.5 * np.linalg.slogdet(B)[1]
    else:
        L, _E, M = _class_factors(K, pi)
        logdet_half = (sum(np.sum(np.log(np.diag(L[c])))
                           for c in range(Y.shape[1]))
                       + np.sum(np.log(np.diag(M))))
    return obj - logdet_half


def latent_predictive(params, X, Y, Xs, kind="rbf", jitter=1e-6,
                      num_newton=100):
    """Latent predictive mean (m, C) and per-point CxC covariance via the
    structured Woodbury form (GPML Alg 3.4)."""
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    f, _a = _mode(K, Y, num_newton)
    pi = _softmax(f)
    _L, E, M = _class_factors(K, pi)
    Ks = kernel_matrix(params, X, Xs, kind)
    m = Ks.shape[1]
    n, C = Y.shape
    mu = Ks.T @ (Y - pi)
    kss = exact_gp_np.kernel_diag(params, Xs, kind)
    Sigma = np.zeros((m, C, C))
    for j in range(m):
        ks = Ks[:, j]
        b = np.stack([E[c] @ ks for c in range(C)], axis=0)      # (C, n)
        U = np.stack([sla.solve_triangular(M, b[c], lower=True)
                      for c in range(C)], axis=0)
        Sigma[j] = U @ U.T
        for c in range(C):
            Sigma[j, c, c] += max(kss[j] - ks @ b[c], 1e-10)
    return mu, Sigma


def predict_proba(params, X, Y, Xs, kind="rbf", jitter=1e-6,
                  num_newton=100, num_samples=20000, seed=0):
    """MC softmax integral over the latent predictive (GPML Alg 3.4)."""
    mu, Sigma = latent_predictive(params, X, Y, Xs, kind=kind,
                                  jitter=jitter, num_newton=num_newton)
    rng = np.random.default_rng(seed)
    m, C = mu.shape
    probs = np.zeros((m, C))
    for j in range(m):
        Ls = sla.cholesky(Sigma[j] + 1e-10 * np.eye(C), lower=True)
        z = rng.standard_normal((num_samples, C))
        fs = mu[j][None, :] + z @ Ls.T
        probs[j] = _softmax(fs).mean(axis=0)
    return probs, mu, Sigma
