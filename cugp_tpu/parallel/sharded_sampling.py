"""Mesh-sharded NUTS/HMC: chains over the 'dp' mesh axis — C8 x C9/C10.

BASELINE.json:5: "hyperparameter HMC chains are vmapped per chip and
sharded across a multi-host slice with step-size adaptation and
acceptance statistics reduced via psum collectives". Realization: shard_map
over 'dp'; each chip runs the vmapped sampler on its local chains with
``psum_axis='dp'`` so dual-averaging and mass-matrix moments are reduced
across chips every warmup step — all chips adapt identically (the returned
step size is bitwise-identical on every shard, asserted in tests).

X/y are replicated inside the body (each chip pays the full LML per
leapfrog step for its own chains — DP over chains, the honest layout for
exact GPs, SURVEY.md section 2.1). For large N combine with the sharded
LML (distributed_chol.distributed_lml) instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cugp_tpu.inference import hmc as hmc_lib
from cugp_tpu.inference import nuts as nuts_lib
from cugp_tpu.inference import sampling as sampling_lib


def sample_hyperparams_sharded(init_params, X, y, mesh, *, kind="rbf",
                               jitter=1e-6, method="xla", num_samples=256,
                               num_chains=None, num_warmup=256,
                               sampler="nuts", key=None, max_tree_depth=8,
                               eps0=0.1, target_accept=0.8):
    """NUTS/HMC with chains sharded over mesh axis 'dp'.

    num_chains: total chains (divisible by dp size); default 8 per chip.
    Returns the same dict as sampling.sample_hyperparams with samples of
    shape (num_samples, num_chains, ...) reassembled across chips.
    """
    dp = mesh.shape["dp"]
    if num_chains is None:
        num_chains = 8 * dp
    if num_chains % dp:
        raise ValueError(f"num_chains={num_chains} not divisible by dp={dp}")
    if key is None:
        key = jax.random.key(0)

    key_init, key_run = jax.random.split(key)
    logprob_and_grad, unravel, q0 = sampling_lib.make_flat_logprob(
        init_params, X, y, kind=kind, jitter=jitter, method=method)
    qs0 = sampling_lib.init_chains(q0, key_init, num_chains)

    run = nuts_lib.run_nuts if sampler == "nuts" else hmc_lib.run_hmc
    extra = ({"max_depth": max_tree_depth} if sampler == "nuts"
             else {"n_leapfrog": 32})

    def body(qs_local, key_arr):
        # distinct streams per chip, shared adaptation via psum
        k = jax.random.fold_in(
            jax.random.wrap_key_data(key_arr), jax.lax.axis_index("dp"))
        out = run(qs_local, k, logprob_and_grad, num_warmup=num_warmup,
                  num_samples=num_samples, eps0=eps0,
                  target_accept=target_accept, psum_axis="dp", **extra)
        # (samples, local stats); eps/inv_mass are identical across chips
        # thanks to the psum-reduced adaptation
        return (out["samples_flat"], out["accept_rate"][None], out["eps"][None],
                out["inv_mass"][None])

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("dp"), P()),
        out_specs=(P(None, "dp"), P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )
    samples_flat, accept, eps, inv_mass = fn(
        qs0, jax.random.key_data(key_run))
    samples = jax.vmap(jax.vmap(unravel))(samples_flat)
    return {
        "samples": samples,
        "samples_flat": samples_flat,
        "accept_rate": jnp.mean(accept),
        "eps_per_chip": eps,
        "inv_mass_per_chip": inv_mass,
    }


def sample_hyperparams_large_n(init_params, X, y, mesh, *, kind="rbf",
                               jitter=1e-6, chunk=8192, num_samples=256,
                               num_chains=4, num_warmup=256, sampler="nuts",
                               key=None, max_tree_depth=8, eps0=0.1,
                               target_accept=0.8):
    """Config-5 shape (BASELINE.json:11): hyperparameter MCMC where every
    likelihood evaluation is ITSELF sharded over the ('r','c') grid.

    X rows live sharded across the mesh (SP); each leapfrog step runs the
    distributed covariance + chunked distributed Cholesky (TP); the few
    chains are vmapped on top (GSPMD batches the sharded program). For
    chain-parallel small-N sampling use sample_hyperparams_sharded instead.
    """
    from cugp_tpu.parallel import distributed_chol

    if key is None:
        key = jax.random.key(0)

    def lml_fn(params):
        return distributed_chol.distributed_lml(
            params, X, y, mesh, kind=kind, jitter=jitter, chunk=chunk)

    logprob_and_grad, unravel, q0 = sampling_lib.make_flat_logprob(
        init_params, X, y, kind=kind, jitter=jitter, lml_fn=lml_fn)
    key_init, key_run = jax.random.split(key)
    qs0 = sampling_lib.init_chains(q0, key_init, num_chains)

    run = nuts_lib.run_nuts if sampler == "nuts" else hmc_lib.run_hmc
    extra = ({"max_depth": max_tree_depth} if sampler == "nuts"
             else {"n_leapfrog": 32})
    out = run(qs0, key_run, logprob_and_grad, num_warmup=num_warmup,
              num_samples=num_samples, eps0=eps0,
              target_accept=target_accept, **extra)
    flat = out.pop("samples_flat")
    out["samples"] = jax.vmap(jax.vmap(unravel))(flat)
    out["samples_flat"] = flat
    return out
