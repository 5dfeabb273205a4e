"""Benchmark harness (C14): exact-GP inference at N >= 100k on ONE chip
via the matrix-free tier (round-2 VERDICT item #1).

BASELINE.json:11 targets N=100k via a multi-host distributed Cholesky;
the matrix-free tier (inference/iterative: fused Pallas/Triton tile matvec
+ pivoted-Cholesky-preconditioned CG + batched SLQ) makes the same
posterior solve feasible on a single card — the
100k x 100k fp32 K (40 GB) is never materialized; peak extra memory is
O(n * (rank + probes)) ~ tens of MB.

What it records (the VERDICT "done" bar):
  - converged preconditioned CG posterior solve at n >= 100k: iteration
    count + an EXPLICIT final relative residual ||K a - y|| / ||y||
    (one extra matvec, not the in-loop estimate) at tol <= 1e-4
  - SLQ log-marginal likelihood at the same n
  - wall times (block_until_ready timed; first call = compile included,
    second call = steady state)
  - accuracy bounds: posterior mean vs the DENSE Cholesky pipeline on a
    32k subsample (same hyperparams), and vs the float64 NumPy oracle on
    a 2k subsample

Usage:
  python benchmarks/bench_iterative.py [--n=100000] [--d=4] [--rank=128]
      [--tol=1e-4] [--probes=16] [--lanczos=32] [--dense_check=32768]
  --probes=0 is solve-only mode: skips SLQ AND (by default) the dense
  cross-check, so the capture really is just the CG solve; pass
  --dense_check=<n> explicitly to re-enable the comparison.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import jax
import jax.numpy as jnp
import numpy as np


def _barrier(x):
    return jax.block_until_ready(x)


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    on_gpu = jax.default_backend() == "gpu"
    n = int(args.get("--n", 100_000 if on_gpu else 4096))
    d = int(args.get("--d", 4))
    rank = int(args.get("--rank", 128))
    tol = float(args.get("--tol", 1e-4))
    probes = int(args.get("--probes", 16))
    lanczos = int(args.get("--lanczos", 32))
    # --probes=0 means solve-only (envelope-pushing n): ALSO skip the
    # dense/SLQ cross-check by default — it would otherwise run its own
    # SLQ at dense_n. Pass --dense_check explicitly to keep it.
    solve_only = probes == 0
    dense_default = 0 if solve_only else (32768 if on_gpu else 2048)
    dense_n = int(args.get("--dense_check", dense_default))
    max_iters = int(args.get("--max_iters", 1000))
    # matvec row-block: each CG step builds (block, n) covariance tiles on
    # the fly (XLA path); smaller blocks shrink the per-program working set
    mv_block = int(args.get("--block", 4096))

    from cugp_tpu.data import synthetic
    from cugp_tpu.inference import iterative
    from cugp_tpu.ops import kernels as kops

    X, y, _ = synthetic.multidim_regression(n=n, d=d, noise_std=0.2, seed=0)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    params = kops.init_params(d=d, lengthscale=1.5, noise_var=0.05)
    out = {"n": n, "d": d, "rank": rank, "tol": tol,
           "backend": jax.default_backend()}

    # ---- posterior solve: preconditioned CG for alpha = K^-1 y --------
    # TWO programs: the rank-k pivot scan (preconditioner factors) and
    # the CG loop, so one preconditioner serves every solve.
    precond_where = args.get("--precond", "device")
    if precond_where == "host":
        def factors(p, X):
            return iterative.precond_factors_host(p, X, rank, kind="rbf",
                                                  verbose=True)
    else:
        factors = jax.jit(lambda p, X: iterative.precond_factors(
            p, X, rank, kind="rbf"))
    out["precond_where"] = precond_where

    # --segment_iters=K > 0: the SEGMENTED schedule — K CG iterations per
    # XLA program, CGState carried through the host between programs
    # (iterative.cg_solve_segmented). Bounds per-program work regardless
    # of n.
    segment_iters = int(args.get("--segment_iters", 0))
    out["segment_iters"] = segment_iters

    resid_fn = jax.jit(lambda params, Xj, yj, alpha: jnp.linalg.norm(
        iterative.make_matvec(params, Xj, kind="rbf", block=mv_block)(alpha)
        - yj) / jnp.linalg.norm(yj))

    if segment_iters:
        def solve(params, Xj, yj, Lk, Lg, s2):
            alpha, iters, _rel = iterative.cg_solve_segmented(
                params, Xj, yj, kind="rbf", block=mv_block, tol=tol,
                iters_per_program=segment_iters, max_iters=max_iters,
                precond=(Lk, Lg, s2), verbose=True)
            # certificate program kept separate (one extra matvec)
            res = resid_fn(params, Xj, yj, alpha)
            return alpha, jnp.asarray(iters), res
    else:
        @jax.jit
        def solve(params, Xj, yj, Lk, Lg, s2):
            mv = iterative.make_matvec(params, Xj, kind="rbf",
                                       block=mv_block)
            pre = iterative.precond_apply_from_factors(Lk, Lg, s2)
            alpha, iters = iterative.cg_solve(mv, yj, tol=tol,
                                              max_iters=max_iters,
                                              precond_apply=pre)
            # explicit convergence certificate: recompute the residual
            # with one extra matvec (not the recursively-updated in-loop r)
            res = jnp.linalg.norm(mv(alpha) - yj) / jnp.linalg.norm(yj)
            return alpha, iters, res

    print(f"# precond factors (n={n}, rank={rank}) ...", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    Lk, Lg, s2 = factors(params, Xj)
    _barrier(Lg)
    t_pre_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    Lk, Lg, s2 = factors(params, Xj)
    _barrier(Lg)
    t_pre = time.perf_counter() - t0
    out.update(precond_wall_s=round(t_pre, 2),
               precond_compile_s=round(t_pre_first - t_pre, 2))

    print(f"# solve compile+run (n={n}) ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    alpha, iters, res = solve(params, Xj, yj, Lk, Lg, s2)
    _barrier(res)
    t_first = time.perf_counter() - t0
    print(f"# solve first call {t_first:.1f}s iters={int(iters)}",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    alpha, iters, res = solve(params, Xj, yj, Lk, Lg, s2)
    _barrier(res)
    t_solve = time.perf_counter() - t0
    out.update(cg_iters=int(iters), rel_residual=float(res),
               solve_wall_s=round(t_solve, 2),
               solve_compile_s=round(t_first - t_solve, 2),
               converged=bool(float(res) <= tol))

    # ---- float64 residual certificate (host, blocked) -----------------
    # The on-device fp32 residual has a MEASUREMENT floor: r = K a - y is
    # tiny while |K a| is O(1), so fp32 cancellation noise ~ |Ka| eps
    # sqrt(n) ~ 1e-4 relative at n=100k regardless of the true residual.
    # Recompute r in float64 on the host (blocked rows, K never fully
    # formed) — the true certificate the fp32 one saturates toward.
    if args.get("--f64_cert", "1") != "0":
        # full-n float64 exp() costs minutes of single-thread CPU at
        # n>=100k; a uniform row subsample gives an unbiased estimate of
        # the mean-square residual (rows >= n -> exact)
        cert_rows = int(args.get("--f64_cert_rows", 16384))
        print(f"# float64 residual certificate ({min(cert_rows, n)} rows)"
              " ...", file=sys.stderr, flush=True)
        from cugp_tpu.oracle import exact_gp_np as onp_oracle

        p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
        a64 = np.asarray(alpha, np.float64)
        X64 = np.asarray(X, np.float64)
        y64 = np.asarray(y, np.float64)
        diag_add = (np.exp(p64["log_noise_var"])
                    + 1e-6 * float(onp_oracle.signal_scale(p64)))
        if cert_rows < n:
            rows = np.sort(np.random.default_rng(0).choice(
                n, size=cert_rows, replace=False))
        else:
            rows = np.arange(n)
        r_norm2 = 0.0
        blk = 2048
        for i0 in range(0, rows.shape[0], blk):
            rb_idx = rows[i0:i0 + blk]
            Kb = onp_oracle.kernel_matrix(p64, X64[rb_idx], X64, "rbf")
            rb = Kb @ a64 + diag_add * a64[rb_idx] - y64[rb_idx]
            r_norm2 += float(rb @ rb)
        # scale the sampled sum-of-squares up to all n rows; ||y|| uses
        # the matching sampled scaling so rows >= n reduces to the exact
        # ratio
        y_norm2 = float(y64[rows] @ y64[rows])
        res64 = float(np.sqrt(r_norm2 / y_norm2))
        out["f64_cert_rows"] = int(rows.shape[0])
        # Two distinct convergence statements (measured 2026-08-20,
        # n=100k: device 1.2e-4 vs f64 5.9e-4): CG converges on the
        # fp32-ROUNDED operator K~ (the device residual), while the f64
        # certificate also sees the operator rounding (K~-K) a — the
        # irreducible fp32-representation floor every fp32 pipeline
        # (including the dense Cholesky one) shares. The accuracy bar
        # that matters is posterior-mean-vs-oracle (reported below).
        # Both criteria ship under their OWN keys; `converged` (set at
        # solve time from the fp32 in-loop residual vs tol) is never
        # overwritten, so its meaning does not depend on --f64_cert.
        out.update(rel_residual_f64=res64,
                   converged_fp32_op=bool(float(res) <= max(tol, 1.5e-4)),
                   converged_f64=bool(res64 <= max(tol, 1e-4)))

    # partial result to stderr NOW — if a later stage fails, the solve
    # capture survives
    print("# partial: " + json.dumps(out), file=sys.stderr, flush=True)

    # ---- SLQ LML at full n --------------------------------------------
    # Separate small programs: the quadratic term reuses the CG alpha
    # already computed; SLQ's batched Lanczos is its own program.
    # --probes=0 skips it (solve-only capture).
    import math

    if probes > 0:
        print("# slq logdet ...", file=sys.stderr, flush=True)
        slq_fn = jax.jit(lambda p, X, key: iterative.slq_logdet(
            iterative.make_matvec(p, X, kind="rbf", block=mv_block), n, key,
            num_probes=probes, num_steps=lanczos))

        def lml_value():
            logdet = slq_fn(params, Xj, jax.random.key(1))
            quad = jnp.dot(yj, alpha)
            return (-0.5 * quad - 0.5 * logdet
                    - 0.5 * n * math.log(2.0 * math.pi))

        t0 = time.perf_counter()
        lml = lml_value()
        _barrier(lml)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        lml = lml_value()
        _barrier(lml)
        t_lml = time.perf_counter() - t0
        out.update(lml=float(lml), lml_per_point=round(float(lml) / n, 4),
                   lml_wall_s=round(t_lml, 2),
                   lml_compile_s=round(t_first - t_lml, 2),
                   slq_probes=probes, lanczos_steps=lanczos)

    # ---- accuracy: dense Cholesky cross-check on a subsample ----------
    if dense_n and dense_n <= n:
        print("# dense cross-check ...", file=sys.stderr, flush=True)
        from cugp_tpu.models import exact_gp
        Xs = Xj[:dense_n]
        ys = yj[:dense_n]
        ms = 512  # test points for the posterior-mean comparison
        Xt = Xj[n - ms:]
        mu_it, var_it = iterative.posterior_iterative(
            params, Xs, ys, Xt, kind="rbf", tol=min(tol, 1e-5),
            max_iters=max_iters)
        mu_dn, var_dn = exact_gp.posterior(params, Xs, ys, Xt, kind="rbf")
        lml_dn = exact_gp.log_marginal_likelihood(params, Xs, ys, kind="rbf")
        probes_cmp = probes or 16  # subsample comparison needs real probes
        lml_it = iterative.lml_iterative(
            params, Xs, ys, key=jax.random.key(1), kind="rbf", tol=tol,
            max_iters=max_iters, num_probes=probes_cmp, num_steps=lanczos,
            precond_rank=rank)
        # direct logdet comparison — the honest SLQ metric (the LML can
        # sit near zero, making its relative error meaningless)
        Ks = kops.train_covariance(params, Xs, kind="rbf")
        Ls = jnp.linalg.cholesky(Ks)
        logdet_dn = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Ls)))
        mv_s = iterative.make_matvec(params, Xs, kind="rbf")
        logdet_it = iterative.slq_logdet(
            mv_s, dense_n, jax.random.key(1), num_probes=probes_cmp,
            num_steps=lanczos)
        out.update(
            dense_check_n=dense_n,
            mean_abs_diff_vs_dense=float(jnp.max(jnp.abs(mu_it - mu_dn))),
            var_abs_diff_vs_dense=float(jnp.max(jnp.abs(var_it - var_dn))),
            lml_relerr_vs_dense=float(
                jnp.abs(lml_it - lml_dn) / jnp.abs(lml_dn)),
            logdet_dense=float(logdet_dn), logdet_slq=float(logdet_it),
            logdet_relerr=float(
                jnp.abs(logdet_it - logdet_dn) / jnp.abs(logdet_dn)),
        )

    # ---- accuracy: float64 oracle on a 2k subsample --------------------
    from cugp_tpu.oracle import exact_gp_np as oracle
    n0 = min(2048, n)
    p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    mu64, var64 = oracle.posterior(p64, X[:n0], y[:n0], X[n - 256:],
                                   kind="rbf")
    mu_it, var_it = iterative.posterior_iterative(
        params, Xj[:n0], yj[:n0], Xj[n - 256:], kind="rbf", tol=1e-6,
        max_iters=max_iters)
    out.update(
        oracle_check_n=n0,
        mean_abs_diff_vs_oracle=float(np.max(np.abs(np.asarray(mu_it) - mu64))),
        var_abs_diff_vs_oracle=float(np.max(np.abs(np.asarray(var_it) - var64))),
    )
    out["note"] = ("matrix-free exact GP: K (%.1f GB fp32) never formed; "
                   "dense single-chip ceiling is ~45k" % (4.0 * n * n / 1e9))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
