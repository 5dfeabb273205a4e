"""Multiclass GP classification via the softmax Laplace approximation
(GPML Algorithms 3.3 / 3.4) — beyond-parity model family; the reference
covers regression only (BASELINE.json:5), and round-2 VERDICT item #6
asked for the multiclass extension of the binary model in ``gpc.py``.

Model: C classes, one latent function per class, shared GP prior
f_c ~ N(0, K) (one kernel, one covariance build — per-class kernels are a
trivial vmap extension and are documented, not implemented, to keep the
hyperparameter surface honest). Likelihood is the softmax
p(y=c | f_i) = exp(f_ic) / sum_c' exp(f_ic').

Structure: the per-class Cholesky factorizations
L_c = chol(I + D_c^{1/2} K D_c^{1/2}) and the per-class E_c matrices are
batched over the class axis with ``vmap`` (one batched
program, not a Python loop over classes), and the Newton iteration is a
fixed-length ``lax.scan`` so hyperparameter gradients flow by AD through
the unrolled scan exactly as in the binary model.

Determinant identity used for the approximate LML (verified numerically
against a brute-force log|I + W^{1/2} K W^{1/2}| in
``tests/test_gpc_multiclass.py``): with W = D - Pi Pi^T (GPML sec. 3.5),

  |I_{Cn} + W^{1/2} K W^{1/2}| = prod_c |L_c|^2 * |sum_c E_c|

so  -1/2 log|B| = - sum_c sum_i log (L_c)_ii - sum_i log M_ii,
with M = chol(sum_c E_c) and E_c = D_c^{1/2} B_c^{-1} D_c^{1/2}.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cugp_tpu.ops import cholesky as chol_ops
from cugp_tpu.ops import kernels as kernel_ops
from cugp_tpu.ops import trsm as trsm_ops

_HI = jax.lax.Precision.HIGHEST
_M_JITTER = 1e-8  # sum_c E_c is SPD but can be tiny when pi saturates


def one_hot(y, num_classes):
    return jax.nn.one_hot(jnp.asarray(y, jnp.int32), num_classes,
                          dtype=jnp.float32)


def _class_factors(K, pi):
    """Batched per-class factorizations at the current softmax probs.

    Returns (L, E, M) where L[c] = chol(I + sw_c K sw_c), E[c] is GPML's
    E_c, and M = chol(sum_c E_c + jitter I). All class-batched via vmap.
    """
    n = K.shape[0]
    sw = jnp.sqrt(pi).T  # (C, n)
    eye = jnp.eye(n, dtype=K.dtype)
    B = eye[None] + sw[:, :, None] * K[None] * sw[:, None, :]
    L = jax.vmap(lambda b: chol_ops.cholesky(b, method="xla"))(B)
    # E_c = (L_c^{-1} diag(sw_c))^T (L_c^{-1} diag(sw_c))
    A = jax.vmap(trsm_ops.solve_lx)(L, sw[:, :, None] * eye[None])
    E = jnp.einsum("cij,cik->cjk", A, A, precision=_HI)
    M = chol_ops.cholesky(jnp.sum(E, axis=0) + _M_JITTER * eye,
                          method="xla")
    return L, E, M


def _laplace_mode(K, Y, num_newton=20):
    """Newton iterations for the softmax-Laplace mode (GPML Alg 3.3).

    Y is one-hot (n, C). Returns (f, a, obj) with f, a of shape (n, C);
    a = K^{-1} f blockwise at the mode; obj = -1/2 sum(a*f) + log p(y|f).
    Fixed iteration count keeps the graph static (same policy as the
    binary model in gpc.py).
    """
    n, C = Y.shape

    def step(carry, _):
        f, _a = carry
        pi = jax.nn.softmax(f, axis=1)
        _L, E, M = _class_factors(K, pi)
        # b = W f + (y - pi);  (W f)_i = diag(pi_i) f_i - pi_i (pi_i.f_i)
        wf = pi * f - pi * jnp.sum(pi * f, axis=1, keepdims=True)
        b = wf + Y - pi
        kb = jnp.matmul(K, b, precision=_HI)                 # (n, C)
        c = jnp.einsum("cij,jc->ic", E, kb, precision=_HI)   # E K b
        rc = jnp.sum(c, axis=1)                              # R^T c
        s = trsm_ops.solve_ltx(M, trsm_ops.solve_lx(M, rc))
        es = jnp.einsum("cij,j->ic", E, s, precision=_HI)    # E R s
        a = b - c + es
        f = jnp.matmul(K, a, precision=_HI)
        return (f, a), None

    f0 = jnp.zeros_like(Y)
    (f, a), _ = jax.lax.scan(step, (f0, jnp.zeros_like(Y)), None,
                             length=num_newton)
    obj = (-0.5 * jnp.sum(a * f) + jnp.sum(Y * f)
           - jnp.sum(jax.nn.logsumexp(f, axis=1)))
    return f, a, obj


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "num_newton"))
def laplace_lml(params, X, Y, kind="rbf", jitter=1e-6, method="auto",
                num_newton=20):
    """Approximate multiclass log marginal likelihood (GPML eq. 3.44).

    log q(y|X,theta) = -1/2 a^T f + y^T f - sum_i logsumexp(f_i)
                       - sum_c sum_i log (L_c)_ii - sum_i log M_ii
    (determinant split proved in the module docstring, brute-force
    verified in tests). AD through the Newton scan gives gradients.
    """
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    f, a, obj = _laplace_mode(K, Y, num_newton)
    pi = jax.nn.softmax(f, axis=1)
    L, _E, M = _class_factors(K, pi)
    logdet_half = (jnp.sum(jnp.log(jnp.diagonal(L, axis1=1, axis2=2)))
                   + jnp.sum(jnp.log(jnp.diagonal(M))))
    return obj - logdet_half


@partial(jax.jit, static_argnames=("kind", "jitter", "method", "num_newton",
                                   "num_samples"))
def predict_proba(params, X, Y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  num_newton=20, num_samples=512, key=None):
    """Predictive class probabilities at Xs (GPML Alg 3.4).

    Latent predictive: mu*_c = k*^T (y_c - pi_c), and the CxC covariance
    per test point Sigma*_{cc'} = delta_{cc'}(k** - k*^T E_c k*)
    + u_c^T u_{c'} with u_c = M^{-1} E_c k*  (from (K + W^{-1})^{-1}
    = E - E R (sum_c E_c)^{-1} R^T E; brute-force verified in tests).
    The softmax integral is estimated by Monte Carlo over
    N(mu*, Sigma*) exactly as GPML Alg 3.4 does (fixed key => jittable,
    reproducible). Returns (probs (m,C), mu (m,C), Sigma (m,C,C)).
    """
    if key is None:
        key = jax.random.key(0)
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter)
    f, _a, _obj = _laplace_mode(K, Y, num_newton)
    pi = jax.nn.softmax(f, axis=1)
    _L, E, M = _class_factors(K, pi)

    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind)  # (n, m)
    mu = jnp.matmul(Ks.T, Y - pi, precision=_HI)                 # (m, C)
    b = jnp.einsum("cij,jm->cim", E, Ks, precision=_HI)          # E_c k*
    q = jnp.einsum("im,cim->cm", Ks, b, precision=_HI)           # k* E k*
    U = jax.vmap(trsm_ops.solve_lx, in_axes=(None, 0))(M, b)     # (C,n,m)
    cross = jnp.einsum("cim,dim->mcd", U, U, precision=_HI)
    kss = kernel_ops.kernel_diag(params, Xs, kind)               # (m,)
    C = Y.shape[1]
    diag = jnp.maximum(kss[None, :] - q, 1e-10)                  # (C, m)
    Sigma = cross + jax.vmap(jnp.diag)(diag.T)                   # (m, C, C)

    # MC softmax integral: f* = mu + chol(Sigma + eps I) z
    eyeC = jnp.eye(C, dtype=Sigma.dtype)
    Ls = jnp.linalg.cholesky(Sigma + 1e-6 * eyeC[None])
    z = jax.random.normal(key, (num_samples, C), dtype=Sigma.dtype)
    fs = mu[:, None, :] + jnp.einsum("mcd,sd->msc", Ls, z)       # (m,S,C)
    probs = jnp.mean(jax.nn.softmax(fs, axis=-1), axis=1)
    return probs, mu, Sigma


def fit(init_params, X, Y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=100, learning_rate=0.05, num_newton=20):
    """MAP hyperparameter learning by maximizing the Laplace marginal
    (same jitted lax.scan Adam loop as the binary model)."""
    import optax

    from cugp_tpu.inference import map_opt

    tx = optax.apply_if_finite(optax.adam(learning_rate), 100)

    @jax.jit
    def run(params, X, Y):
        state = tx.init(params)

        def step(carry, _):
            p, s = carry
            val, g = jax.value_and_grad(
                lambda p: -laplace_lml(p, X, Y, kind=kind, jitter=jitter,
                                       method=method,
                                       num_newton=num_newton))(p)
            updates, s = tx.update(g, s, p)
            p = map_opt._clamp(optax.apply_updates(p, updates))
            return (p, s), val

        (params, _), losses = jax.lax.scan(step, (params, state), None,
                                           length=steps)
        return params, losses

    params, losses = run(init_params, X, Y)
    return params, {"loss": losses, "lml": -losses[-1]}
