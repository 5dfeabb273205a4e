"""Benchmark harness (C14): HMC/NUTS posterior samples/s (BASELINE.json:2).

Usage: python benchmarks/bench_hmc.py [--n=2048] [--chains=256] [--samples=64]
Config-3 shape: 256 chains on one chip (BASELINE.json:9).

Chain batching: by default all chains run in one program. --batch=B runs
batches of B chains through the SAME compiled sampler program
sequentially (fresh RNG key per batch), bounding per-program memory.

--share_adapt=1 (default): warmup adaptation runs ONCE — the first
batch's pooled (eps, inv_mass) is reused by every later batch, which
skips warmup entirely (hmc.sample_segment with the carried tuning).
That matches the spec'd 256-pooled-adaptation statistics up to which
chains contributed the moments (chains are iid, so 32 chains' pooled
moments estimate the same quantities), and makes later batches pure
sampling. --share_adapt=0 is the round-3 behavior (independent warmup
per batch). The reported posterior_samples_per_s is total draws /
total wall; the first batch's wall includes compilation + warmup,
steady-state per-batch time is reported separately.

--engine=iterative: every density evaluation is matrix-free CG+SLQ
(sampling.make_iterative_logprob) — the hyperparameter-HMC-at-scale
config (round-3 VERDICT next #2); --probes/--precond_rank apply.
"""

import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import time

import jax
import jax.numpy as jnp


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    n = int(args.get("--n", 512))
    chains = int(args.get("--chains", 256))
    samples = int(args.get("--samples", 64))
    warmup = int(args.get("--warmup", 64))
    sampler = args.get("--sampler", "hmc")
    # --chain_block=B: the spec'd single-program layout — ALL chains in one
    # jitted sampler, executed as lax.map over B-wide vmapped blocks with
    # adaptation pooled across every chain (hmc.blocked_chains). Without
    # it, --batch chains per program (default: all of them).
    chain_block = int(args.get("--chain_block", 0))
    batch = (chains if chain_block else
             int(args.get("--batch", chains)))

    share_adapt = args.get("--share_adapt", "1") != "0"
    engine = args.get("--engine", "dense")
    probes = int(args.get("--probes", 16))
    precond_rank = int(args.get("--precond_rank", 0))
    n_leapfrog = int(args.get("--leapfrog", 32))

    from cugp_tpu.data import synthetic
    from cugp_tpu.inference import hmc as hmc_lib
    from cugp_tpu.inference import nuts as nuts_lib
    from cugp_tpu.inference import sampling
    from cugp_tpu.ops import kernels as kops

    X, y, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    init = kops.init_params(d=1, lengthscale=0.8, noise_var=0.05)

    if engine == "iterative":
        precond = None
        if precond_rank:
            from cugp_tpu.inference import iterative

            precond = iterative.precond_factors(init, Xj, precond_rank,
                                                kind="rbf")
        logprob_and_grad, _unravel, q0 = sampling.make_iterative_logprob(
            init, Xj, yj, kind="rbf", num_probes=probes, precond=precond)
    else:
        logprob_and_grad, _unravel, q0 = sampling.make_flat_logprob(
            init, Xj, yj, kind="rbf", method="auto")

    def cg_diag(state):
        """Per-transition CG cost evidence for the iterative engine
        (round-4 VERDICT missing #2): iteration count of one solve at
        the init params vs at a post-run chain position, both under the
        init-time preconditioner — the spread IS the staleness cost."""
        if engine != "iterative":
            return {}
        q_end = jax.tree.map(lambda a: a[0], state.q)
        return {
            "cg_iters_at_init": sampling.cg_diagnostic(
                init, precond, Xj, yj, kind="rbf"),
            "cg_iters_at_chain_end": sampling.cg_diagnostic(
                _unravel(q_end), precond, Xj, yj, kind="rbf"),
        }

    if sampler == "nuts":
        kernel = nuts_lib.make_nuts_kernel(logprob_and_grad, max_depth=6,
                                           chain_block=chain_block)
    else:
        kernel = hmc_lib.make_hmc_kernel(logprob_and_grad, n_leapfrog,
                                         chain_block=chain_block)

    seg_jit = jax.jit(hmc_lib.sample_segment,
                      static_argnames=("kernel", "num_draws"))
    warm_jit = jax.jit(hmc_lib.warmup_adapt,
                       static_argnames=("kernel", "num_warmup",
                                        "target_accept"))

    def init_state(key, n_chains):
        qs0 = sampling.init_chains(q0, key, n_chains)
        logp0, grad0 = hmc_lib.blocked_chains(
            lambda q, _k: logprob_and_grad(q), chain_block)(
                qs0, jax.random.split(jax.random.key(0), n_chains))
        return hmc_lib.HMCState(qs0, logp0, grad0)

    seg_draws = int(args.get("--seg_draws", 0))
    retune = int(args.get("--retune", 16))  # eps-only steps per carried
    # batch (0 disables; round-4 VERDICT weak #7: carried eps alone
    # generalized at 0.686 accept vs the 0.8 target)
    retune_jit = jax.jit(hmc_lib.retune_eps,
                         static_argnames=("kernel", "num_steps",
                                          "target_accept"))
    n_batches = -(-chains // batch)
    batch_times, accepts = [], []
    eps = inv_mass = None
    t0 = time.perf_counter()
    for b in range(n_batches):
        tb = time.perf_counter()
        kb = jax.random.fold_in(jax.random.key(1000), b)
        k_init, k1, k2, k3, k_draw = jax.random.split(kb, 5)
        state = init_state(k_init, batch)
        if eps is None or not share_adapt:
            state, eps, inv_mass = warm_jit(state, (k1, k2, k3), kernel,
                                            warmup, 0.1, 0.8)
        elif retune:
            # carried mass matrix, re-centered step size (hmc.retune_eps)
            state, eps = retune_jit(state, k1, kernel, eps, inv_mass,
                                    num_steps=retune)
        # --seg_draws=K > 0: split each batch's draws into ceil(S/K)
        # sample_segment programs (segments compose exactly — fixed
        # eps/inv_mass, fresh fold_in key per segment). This bounds
        # CUMULATIVE per-program work, same pattern as the checkpointed
        # sampler.
        if seg_draws and seg_draws < samples:
            done = 0
            acc_sum = 0.0
            while done < samples:
                take = min(seg_draws, samples - done)
                state, qs, aprobs, _aux = seg_jit(
                    state, jax.random.fold_in(k_draw, done), kernel, eps,
                    inv_mass, take)
                acc_sum += float(jnp.sum(aprobs))
                done += take
            accepts.append(acc_sum / (samples * batch))
        else:
            state, qs, aprobs, _aux = seg_jit(state, k_draw, kernel, eps,
                                              inv_mass, samples)
            accepts.append(float(jnp.mean(aprobs)))  # forces completion
        batch_times.append(time.perf_counter() - tb)
    dt = time.perf_counter() - t0

    total_draws = samples * batch * n_batches
    steady = sorted(batch_times)[len(batch_times) // 2] if n_batches > 1 \
        else batch_times[0]
    print(json.dumps({
        "sampler": sampler, "n": n, "chains": batch * n_batches,
        "chain_batch": batch, "n_batches": n_batches,
        "chain_block": chain_block,
        "single_program": bool(chain_block or n_batches == 1),
        "share_adapt": bool(share_adapt), "retune": retune,
        "seg_draws": seg_draws, "engine": engine,
        **({"probes": probes, "precond_rank": precond_rank}
           if engine == "iterative" else {}),
        "samples_per_chain": samples,
        "wall_s": round(dt, 2),
        "posterior_samples_per_s": round(total_draws / dt, 1),
        "steady_state_samples_per_s": round(samples * batch / steady, 1),
        "first_batch_s": round(batch_times[0], 2),
        "steady_batch_s": round(steady, 2),
        "accept_rate": round(sum(accepts) / len(accepts), 3),
        **cg_diag(state),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
