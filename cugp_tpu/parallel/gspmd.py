"""GSPMD-sharded training/sampling steps — components C9/C10.

Compiler-driven sharding tier: the covariance/Cholesky pipeline runs under
jit with explicit sharding constraints so XLA partitions the O(N^2) work and
inserts the collectives (BASELINE.json:10, "single-host sharded covariance +
Cholesky across 4 chips"). The manually-scheduled block-cyclic factorization
lives in ``block_cyclic.py``; this module is the GSPMD alternative and the
glue for end-to-end sharded training steps.

Sharding layout (see mesh.py):
  X: rows over ('dp','r')  — the N axis is the sequence/SP axis
  K: P(('dp','r'), 'c')    — 2D tensor-parallel tiles
  HMC chains: leading axis over 'dp'.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from cugp_tpu.models import exact_gp
from cugp_tpu.ops import kernels as kernel_ops
from cugp_tpu.inference import map_opt


from cugp_tpu.parallel.mesh import wsc as _wsc


def lml_sharded(params, X, y, mesh, kind="rbf", jitter=1e-6):
    """LML with GSPMD sharding constraints on the O(N^2) intermediates."""
    X = _wsc(X, mesh, P(("dp", "r"), None))
    y = _wsc(y, mesh, P(("dp", "r")))
    K = kernel_ops.train_covariance_xla(params, X, kind=kind, jitter=jitter)
    K = _wsc(K, mesh, P(("dp", "r"), "c"))
    L = jax.lax.linalg.cholesky(K)
    L = _wsc(L, mesh, P(("dp", "r"), "c"))
    z = jax.lax.linalg.triangular_solve(L, y[:, None], left_side=True,
                                        lower=True)
    alpha = jax.lax.linalg.triangular_solve(L, z, left_side=True, lower=True,
                                            transpose_a=True)[:, 0]
    n = y.shape[0]
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L)))
    return (-0.5 * jnp.sum(y * alpha) - logdet_half
            - 0.5 * n * exact_gp.LOG2PI)


def make_map_train_step(mesh, kind="rbf", jitter=1e-6, learning_rate=0.05,
                        lml_backend="chunked", chunk=8192):
    """One GSPMD-sharded Adam step on the LML. Returns (step_fn, tx).

    lml_backend:
      'chunked' (default) — distributed_chol.distributed_lml: the chunked
        right-looking sweep whose TRSM/SYRK trailing updates GSPMD genuinely
        partitions over ('r','c'). This is the honest sharded factorization.
      'gspmd' — lml_sharded above: sharding constraints around
        lax.linalg.cholesky. XLA cannot partition the Cholesky op itself, so
        only the O(N^2) covariance is sharded (the factorization gathers);
        kept for comparison and small N.
    """
    tx = optax.apply_if_finite(optax.adam(learning_rate), 1000)
    if lml_backend == "chunked":
        from cugp_tpu.parallel import distributed_chol

        def lml(p, X, y):
            return distributed_chol.distributed_lml(
                p, X, y, mesh, kind=kind, jitter=jitter, chunk=chunk)
    elif lml_backend == "gspmd":
        def lml(p, X, y):
            return lml_sharded(p, X, y, mesh, kind=kind, jitter=jitter)
    else:
        raise ValueError(f"unknown lml_backend: {lml_backend}")

    @jax.jit
    def step(params, opt_state, X, y):
        loss, grads = jax.value_and_grad(lambda p: -lml(p, X, y))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = map_opt._clamp(optax.apply_updates(params, updates))
        return params, opt_state, loss

    return step, tx
