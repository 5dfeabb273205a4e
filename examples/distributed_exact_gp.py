"""Config-4/5 example: the distributed exact-GP pipeline on a device mesh.

Runs on 8 virtual CPU devices by default (no GPUs needed); on a multi-GPU
host, drop --fake and the same code spans the cards (and hosts, with
cugp_tpu.runtime.initialize).

Pipeline (SURVEY.md section 2.1):
  ring covariance build     — X row-sharded over ALL chips, ppermute ring
  all_to_all relayout       — row-sharded -> 2D ('r','c') (Ulysses analog)
  distributed Cholesky      — chunked GSPMD sweep over the 2D grid
  block-cyclic Cholesky     — explicit shard_map lookahead factorization
  distributed LML           — the config-4 objective

python examples/distributed_exact_gp.py [--fake=8] [--n=1024]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
fake = int(args.get("--fake", 8))
if fake:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={fake}")
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cugp_tpu.data import synthetic
from cugp_tpu.models import exact_gp
from cugp_tpu.ops import kernels as kops
from cugp_tpu.parallel import (block_cyclic, distributed_chol, mesh as
                               mesh_lib, relayout, ring)


def main():
    n = int(args.get("--n", 1024))
    mesh = mesh_lib.make_mesh(dp=1)
    R, C = mesh.shape["r"], mesh.shape["c"]
    print(f"mesh: {dict(mesh.shape)} over {len(jax.devices())} devices")

    X_np, y_np, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    params = kops.init_params(d=1, lengthscale=0.8, noise_var=0.05)

    # SP layout: rows of X over ALL chips (the covariance-build layout)
    X = jax.device_put(jnp.asarray(X_np, jnp.float32),
                       NamedSharding(mesh, P(("r", "c"), None)))
    y = jax.device_put(jnp.asarray(y_np, jnp.float32),
                       NamedSharding(mesh, P(("r", "c"))))

    # 1. ring-ppermute covariance: no chip ever holds all of X
    K_rows = ring.ring_train_covariance(params, X, mesh, kind="rbf",
                                        jitter=1e-6, axis=("r", "c"))
    # 2. one all_to_all into the 2D factorization layout
    K2d = relayout.row_to_2d(K_rows, mesh)
    print("K resharded:", K_rows.sharding.spec, "->", K2d.sharding.spec)

    # 3a. chunked GSPMD distributed Cholesky (performance path)
    L = jax.jit(lambda K: distributed_chol.distributed_cholesky(
        K, mesh, chunk=max(n // 4, 128)))(K2d)
    # 3b. explicit block-cyclic lookahead factorization (scheduled path)
    L_bc = block_cyclic.block_cyclic_cholesky(K2d, mesh, block=64,
                                              pipelined=True)
    diff = float(jnp.max(jnp.abs(L - L_bc)))
    print(f"GSPMD sweep vs block-cyclic factor: max|diff| = {diff:.2e}")

    # 4. the config-4 objective, distributed end to end
    lml = jax.jit(lambda p, X, y: distributed_chol.distributed_lml(
        p, X, y, mesh, chunk=max(n // 4, 128)))(params, X, y)
    ref = exact_gp.log_marginal_likelihood(
        params, jnp.asarray(X_np, jnp.float32),
        jnp.asarray(y_np, jnp.float32), method="xla")
    print(f"distributed LML = {float(lml):.4f}  (single-device "
          f"{float(ref):.4f}, diff {abs(float(lml) - float(ref)):.2e})")


if __name__ == "__main__":
    main()
