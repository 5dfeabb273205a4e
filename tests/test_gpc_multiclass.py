"""Multiclass softmax-Laplace GPC vs the float64 oracle (GPML Alg 3.3/3.4).

Round-3 VERDICT item #6. Includes brute-force certification of the two
structured identities the JAX model relies on:
  (a) |I + W^1/2 K W^1/2| = prod_c |L_c|^2 * |sum_c E_c|
  (b) (K + W^-1)^-1 = W^1/2 B^-1 W^1/2 = E - E R (sum E_c)^-1 R^T E
"""

import numpy as np
import pytest
import scipy.linalg as sla

import jax
import jax.numpy as jnp

from cugp_tpu.data import synthetic
from cugp_tpu.models import gpc_multiclass as mgpc
from cugp_tpu.oracle import gpc_multiclass_np as oracle_np


def _problem(n=48, num_classes=3, seed=0):
    X, y = synthetic.gaussian_blobs(n=n, num_classes=num_classes, seed=seed)
    params = {
        "log_lengthscale": np.log(0.9) * np.ones(X.shape[1]),
        "log_signal_var": np.array(np.log(1.5)),
        "log_noise_var": np.array(np.log(1e-2)),
    }
    Y = np.eye(num_classes)[y]
    return params, X.astype(np.float64), y, Y


def test_logdet_identity_brute_force():
    """Structured logdet split == dense Cn x Cn slogdet (float64)."""
    params, X, _y, Y = _problem(n=36)
    lml_struct = oracle_np.laplace_lml(params, X, Y)
    lml_brute = oracle_np.laplace_lml(params, X, Y, brute_force_logdet=True)
    assert abs(lml_struct - lml_brute) < 1e-6 * max(1.0, abs(lml_brute))


def test_predictive_covariance_identity_brute_force():
    """Structured Sigma* == brute-force W^1/2 B^-1 W^1/2 form (float64)."""
    params, X, _y, Y = _problem(n=30)
    n, C = Y.shape
    Xs = X[:5] + 0.13
    mu, Sigma = oracle_np.latent_predictive(params, X, Y, Xs)

    K = oracle_np.train_covariance(params, X, kind="rbf")
    f, _a = oracle_np._mode(K, Y)
    pi = oracle_np._softmax(f)
    W = oracle_np.dense_W(pi)
    sqW = sla.sqrtm(W + 1e-14 * np.eye(n * C)).real
    Kbig = np.kron(np.eye(C), K)
    B = np.eye(n * C) + sqW @ Kbig @ sqW
    P = sqW @ np.linalg.solve(B, sqW)
    Ks = oracle_np.kernel_matrix(params, X, Xs, "rbf")
    kss = oracle_np.exact_gp_np.kernel_diag(params, Xs, "rbf")
    for j in range(Xs.shape[0]):
        Q = np.kron(np.eye(C), Ks[:, j][:, None])   # (Cn, C)
        Sig_bf = np.diag(np.full(C, kss[j])) - Q.T @ P @ Q
        assert np.max(np.abs(Sigma[j] - Sig_bf)) < 1e-6


def test_lml_matches_oracle():
    params, X, _y, Y = _problem(n=48)
    lml64 = oracle_np.laplace_lml(params, X, Y)
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    lml32 = mgpc.laplace_lml(pj, jnp.asarray(X, jnp.float32),
                             jnp.asarray(Y, jnp.float32), num_newton=30)
    assert abs(float(lml32) - lml64) < 1e-3 * max(1.0, abs(lml64))


def test_latent_predictive_matches_oracle():
    params, X, _y, Y = _problem(n=48)
    Xs = X[:8] + 0.2
    mu64, Sig64 = oracle_np.latent_predictive(params, X, Y, Xs)
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    _p, mu32, Sig32 = mgpc.predict_proba(
        pj, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
        jnp.asarray(Xs, jnp.float32), num_newton=30, num_samples=8)
    assert np.max(np.abs(np.asarray(mu32) - mu64)) < 1e-3
    assert np.max(np.abs(np.asarray(Sig32) - Sig64)) < 1e-3


def test_probabilities_match_oracle_mc():
    params, X, _y, Y = _problem(n=48)
    Xs = X[:6]
    p64, _mu, _S = oracle_np.predict_proba(params, X, Y, Xs,
                                           num_samples=40000)
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    p32, _m, _s = mgpc.predict_proba(
        pj, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
        jnp.asarray(Xs, jnp.float32), num_newton=30, num_samples=8192,
        key=jax.random.key(3))
    p32 = np.asarray(p32)
    np.testing.assert_allclose(p32.sum(axis=1), 1.0, atol=1e-5)
    assert np.max(np.abs(p32 - p64)) < 0.03  # MC noise bound


@pytest.mark.deep
def test_fit_improves_lml_and_classifies():
    params, X, y, Y = _problem(n=60)
    Xj = jnp.asarray(X, jnp.float32)
    Yj = jnp.asarray(Y, jnp.float32)
    init = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    fitted, info = mgpc.fit(init, Xj, Yj, steps=30, learning_rate=0.1,
                            num_newton=15)
    losses = np.asarray(info["loss"])
    assert np.isfinite(losses).all()
    assert losses[-1] <= losses[0]
    probs, _m, _s = mgpc.predict_proba(fitted, Xj, Yj, Xj, num_newton=15,
                                       num_samples=256)
    acc = float(np.mean(np.argmax(np.asarray(probs), axis=1) == y))
    assert acc >= 0.93


def test_grad_flows():
    params, X, _y, Y = _problem(n=24)
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    g = jax.grad(lambda p: mgpc.laplace_lml(
        p, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
        num_newton=10))(pj)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


@pytest.mark.deep
def test_api_multiclass_classifier():
    from cugp_tpu import api

    X, y = synthetic.gaussian_blobs(n=60, num_classes=3, seed=1)
    labels = np.array(["a", "b", "c"])[y]  # non-integer labels
    clf = api.GPClassifier()
    clf.fit(X, labels, steps=20, learning_rate=0.1, num_newton=12)
    pred = clf.predict(X)
    assert set(np.unique(np.asarray(pred))) <= {"a", "b", "c"}
    acc = float(np.mean(np.asarray(pred) == labels))
    assert acc >= 0.9
    proba = np.asarray(clf.predict_proba(X[:5]))
    assert proba.shape == (5, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-4)
