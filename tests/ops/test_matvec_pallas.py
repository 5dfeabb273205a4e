"""Fused Pallas/Triton covariance-tile matvec (interpret mode on the CPU)
against the dense XLA reference, plus the wrapper's shapes, padding, RHS
blocking, choice of kernel and gradient rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cugp_tpu.inference import iterative
from cugp_tpu.ops import cholesky as chol_ops
from cugp_tpu.ops import kernels as kops
from cugp_tpu.ops import matvec_pallas

KINDS = ["rbf", "matern12", "matern32", "matern52", "rq", "periodic",
         "linear"]


def _case(kind, n, d, r, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.uniform(-2, 2, (n, d)), jnp.float32)
    p = kops.default_init(kind, d=d, lengthscale=0.9, signal_var=1.3,
                          noise_var=0.1)
    shape = (n,) if r is None else (n, r)
    v = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    K = kops.train_covariance_xla(p, X, kind=kind, jitter=1e-6)
    return p, X, v, K


def _assert_close(out, ref, tol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
    assert err < tol, err


@pytest.mark.parametrize("r", [None, 17], ids=["vector", "17cols"])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_dense_reference(kind, r):
    p, X, v, K = _case(kind, 256, 3, r)
    out = matvec_pallas.train_cov_matvec(p, X, v, kind=kind, jitter=1e-6,
                                         interpret=True)
    _assert_close(out, K @ v)


@pytest.mark.parametrize("n", [300, 1000])
def test_rows_not_a_multiple_of_the_block(n):
    p, X, v, K = _case("rbf", n, 2, 5)
    out = matvec_pallas.train_cov_matvec(p, X, v, interpret=True)
    _assert_close(out, K @ v)


@pytest.mark.parametrize("d", [1, 32])
def test_feature_dims_at_the_edges(d):
    # lengthscale grows with d so the entries stay O(1) at d=32
    p, X, v, _ = _case("rbf", 200, d, 3)
    p["log_lengthscale"] = jnp.full((d,), np.log(0.9 * np.sqrt(d)),
                                    jnp.float32)
    K = kops.train_covariance_xla(p, X, jitter=1e-6)
    out = matvec_pallas.train_cov_matvec(p, X, v, interpret=True)
    _assert_close(out, K @ v)


def test_rejects_d_above_max():
    p, X, v, _ = _case("rbf", 64, matvec_pallas.MAX_D + 1, 1)
    with pytest.raises(ValueError, match="d<=32"):
        matvec_pallas.train_cov_matvec(p, X, v, interpret=True)


def test_rejects_composite_kind():
    p = kops.default_init("rbf+linear", d=2)
    X = jnp.zeros((64, 2), jnp.float32)
    with pytest.raises(NotImplementedError, match="base kernel"):
        matvec_pallas.train_cov_matvec(p, X, X[:, 0], kind="rbf+linear",
                                       interpret=True)


@pytest.mark.parametrize("r", [32, 40, 70])
def test_wide_rhs_is_cut_into_blocks(r):
    p, X, v, K = _case("matern32", 200, 3, r)
    out = matvec_pallas.train_cov_matvec(p, X, v, kind="matern32",
                                         interpret=True)
    _assert_close(out, K @ v)


def test_prepare_pads_to_powers_of_two():
    p = kops.init_params(d=9)
    X = jnp.ones((300, 9), jnp.float32)
    kind, xa, xbt, scal = matvec_pallas.prepare(p, X, "rbf", 128)
    # rbf carries two augmented columns: 9 + 2 = 11 -> 16 lanes
    assert (kind, xa.shape, xbt.shape, scal.shape) == (
        "rbf", (384, 16), (16, 384), (2,))
    np.testing.assert_array_equal(np.asarray(xa[300:]), 0.0)
    kind, xa, _, _ = matvec_pallas.prepare(kops.default_init("periodic", 9),
                                           X, "periodic", 128)
    assert kind == "rbf" and xa.shape == (384, 32)  # 18 + 2 -> 32


def test_matches_under_vmap():
    """Batched (vmapped) kernel == per-example loop: chains vmap over
    hyperparameters in the iterative samplers, and the batch becomes a
    grid axis the kernel's program_id must not see."""
    rng = np.random.default_rng(3)
    n, d, B = 300, 2, 3
    X = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
    ps = [kops.init_params(d=d, lengthscale=0.5 + 0.3 * b,
                           signal_var=1.0 + b, noise_var=0.05 * (b + 1))
          for b in range(B)]
    stack = jax.tree.map(lambda *a: jnp.stack(a), *ps)
    f = lambda p: matvec_pallas.train_cov_matvec(p, X, v, interpret=True)
    np.testing.assert_allclose(np.asarray(jax.vmap(f)(stack)),
                               np.asarray(jnp.stack([f(p) for p in ps])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_gradient_through_make_matvec(kind):
    """The fused matvec's custom VJP (backward through the XLA tiles)
    equals AD through the XLA matvec, for params and for v."""
    p, X, v, _ = _case(kind, 200, 2, 4)
    w = jnp.asarray(np.random.default_rng(5).standard_normal((200, 4)),
                    jnp.float32)

    def loss(method):
        def f(p, v):
            mv = iterative.make_matvec(p, X, kind=kind, block=64,
                                       method=method, interpret=True)
            return jnp.sum(w * mv(v))
        return f

    gp_, gv = jax.grad(loss("pallas"), argnums=(0, 1))(p, v)
    rp_, rv = jax.grad(loss("xla"), argnums=(0, 1))(p, v)
    for k in rp_:
        np.testing.assert_allclose(np.asarray(gp_[k]), np.asarray(rp_[k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(rv), rtol=1e-4,
                               atol=1e-4)


def test_explicit_kernel_on_cpu_raises():
    p, X, v, _ = _case("rbf", 64, 2, None)
    with pytest.raises(ValueError, match="GPU only"):
        matvec_pallas.train_cov_matvec(p, X, v)
    with pytest.raises(ValueError, match="GPU only"):
        iterative.make_matvec(p, X, method="pallas")(v)


def test_unknown_matvec_method_raises():
    p, X, v, _ = _case("rbf", 64, 2, None)
    with pytest.raises(ValueError, match="unknown matvec method"):
        iterative.make_matvec(p, X, method="triton")


@pytest.mark.parametrize("backend,kind,d,want", [
    ("gpu", "rbf", 8, "pallas"),
    ("gpu", "matern32", 32, "pallas"),
    ("gpu", "rbf", 33, "xla"),
    ("gpu", "periodic", 17, "xla"),      # the embedding doubles d: 34
    ("gpu", "rbf+linear", 2, "xla"),     # composites take the XLA tiles
    ("cpu", "rbf", 8, "xla"),
])
def test_auto_matvec_choice(backend, kind, d, want, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    X = jnp.zeros((16, d), jnp.float32)
    assert iterative.matvec_method(X, kind) == want


def test_auto_matvec_runs_the_kernel_on_gpu(monkeypatch):
    """method="auto" under a GPU backend routes to the fused kernel (the
    stubbed kernel call is reached)."""
    p, X, v, _ = _case("rbf", 64, 2, None)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    mv = iterative.make_matvec(p, X)
    monkeypatch.setattr(matvec_pallas, "_matvec_call",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("kernel called")))
    with pytest.raises(RuntimeError, match="kernel called"):
        mv(v)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_auto_cholesky_choice(backend, monkeypatch):
    """cuSOLVER (method="xla") won at every measured size on the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for n in (512, 8192, 32768):
        assert chol_ops.auto_method(n) == "xla"
