"""Benchmark harness (C14): matrix-free rank-Q LMC past the dense
pn ceiling (round-4 VERDICT next #8).

The dense rank-Q LMC (`models/lmc.py:_lmcq_chol`) materializes the full
(pn, pn) joint covariance — at p=2, n=32768 that is 17 GB fp32, past the
single-chip dense ceiling. This harness drives the matrix-free tier
(`posterior_lmcq_iterative` / `log_marginal_likelihood_lmcq_iterative`:
CG + SLQ on the sum-of-Kronecker operator, Sigma never formed) at that
scale on one chip, after a small-n agreement gate against the dense
path.

Usage:
  python benchmarks/bench_lmcq.py [--n=32768] [--d=2] [--p=2] [--m=512]
      [--block=4096] [--tol=1e-5] [--segment_iters=0] [--check_n=1024]
      [--platform=cpu]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import jax
import jax.numpy as jnp
import numpy as np


def make_data(n, d, p, seed=0):
    """Smooth correlated p-output targets (not drawn from the model —
    this is a wall-clock/agreement harness, not a recovery test)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n, d)).astype(np.float32)
    r = np.linalg.norm(X, axis=1)
    base = np.sin(1.7 * r) + 0.3 * np.cos(3.1 * X[:, 0])
    cols = [base + 0.2 * np.sin(2.3 * X[:, min(a, d - 1)] + a)
            for a in range(p)]
    Y = np.stack(cols, axis=1) + 0.1 * rng.standard_normal((n, p))
    return jnp.asarray(X), jnp.asarray(Y.astype(np.float32))


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    on_gpu = jax.default_backend() == "gpu"
    n = int(args.get("--n", 32768 if on_gpu else 4096))
    d = int(args.get("--d", 2))
    p = int(args.get("--p", 2))
    m = int(args.get("--m", 512))
    block = int(args.get("--block", 4096))
    tol = float(args.get("--tol", 1e-5))
    segment_iters = int(args.get("--segment_iters", 0))
    check_n = int(args.get("--check_n", 1024))

    from cugp_tpu.models import lmc

    kinds = ("rbf", "matern32")
    out = {"n": n, "d": d, "p": p, "q": len(kinds), "m": m,
           "block": block, "tol": tol, "segment_iters": segment_iters,
           "backend": jax.default_backend(),
           "joint_dim": p * n,
           "dense_sigma_gb": round(4.0 * (p * n) ** 2 / 2 ** 30, 1)}

    params = lmc.init_lmcq_params(d=d, p=p, kinds=kinds, lengthscale=1.2,
                                  noise_var=0.05, seed=0)

    # --- gate: matrix-free == dense at small n (same params) ---
    Xc, Yc = make_data(check_n, d, p, seed=1)
    Xsc = Xc[:128] + 0.05
    mu_d, var_d = lmc.posterior_lmcq(params, Xc, Yc, Xsc, kinds)
    mu_i, var_i = lmc.posterior_lmcq_iterative(
        params, Xc, Yc, Xsc, kinds, block=block, tol=1e-7,
        segment_iters=segment_iters)
    out["check_n"] = check_n
    out["check_mean_maxdiff"] = round(
        float(jnp.max(jnp.abs(mu_d - mu_i))), 8)
    out["check_var_maxdiff"] = round(
        float(jnp.max(jnp.abs(var_d - var_i))), 8)
    gate_ok = out["check_mean_maxdiff"] < 1e-3
    out["check_ok"] = bool(gate_ok)
    print("# gate: " + json.dumps(out), file=sys.stderr, flush=True)

    # --- the capture: p outputs at n, Sigma (pn x pn) never formed ---
    X, Y = make_data(n, d, p, seed=0)
    Xs = X[:m] + 0.05

    t0 = time.perf_counter()
    lml = lmc.log_marginal_likelihood_lmcq_iterative(
        params, X, Y, kinds, key=jax.random.key(0), block=block,
        tol=tol, max_iters=600, num_probes=8, num_steps=32)
    lml = float(jax.block_until_ready(lml))
    t_lml = time.perf_counter() - t0
    out.update(lml_per_pt=round(lml / (n * p), 4),
               lml_wall_s=round(t_lml, 2))
    print("# lml: " + json.dumps(out), file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    mu, var = lmc.posterior_lmcq_iterative(
        params, X, Y, Xs, kinds, block=block, tol=tol, max_iters=600,
        col_batch=128, segment_iters=segment_iters, verbose=True)
    jax.block_until_ready((mu, var))
    t_post = time.perf_counter() - t0
    out.update(posterior_wall_s=round(t_post, 2),
               mu_abs_mean=round(float(jnp.mean(jnp.abs(mu))), 4),
               var_min=round(float(jnp.min(var)), 6),
               var_max=round(float(jnp.max(var)), 6))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
