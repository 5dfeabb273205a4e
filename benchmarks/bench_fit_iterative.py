"""Benchmark harness (C14): hyperparameter LEARNING at n >= 100k on ONE
chip via the matrix-free training loop (round-3 VERDICT next #1 — the
reference's training loop, BASELINE.json:5, at BASELINE.json:11's scale).

Data: y is drawn from a KNOWN RBF GP via random Fourier features
(Rahimi-Recht; D features approximate the kernel to O(1/sqrt(D)) — exact
enough to test hyperparameter recovery) plus Gaussian noise. The fit
starts from a deliberately wrong init; the capture records:
  - steady steps/s of map_opt.fit_iterative (split-program schedule,
    refreshed pivoted-Cholesky preconditioner)
  - recovered log-hyperparameters vs the generating truth
  - dense-subsample LML at init vs fitted params (oracle-checked
    improvement on a 16k subsample)

Usage:
  python benchmarks/bench_fit_iterative.py [--n=100000] [--d=4]
      [--steps=12] [--lr=0.1] [--rank=128] [--refresh=6] [--probes=8]
      [--tol=1e-4] [--max_iters=300] [--block=4096] [--platform=cpu]
      [--segment_iters=0] [--probe_mode=fresh] [--warm_start=1]

Round-5 knobs: --refresh=0 selects the ADAPTIVE preconditioner refresh
(rebuild when CG iterations exceed 1.5x the best since the last build);
--segment_iters=K bounds every CG program to K iterations (the 262k
schedule IN the training loop); --probe_mode=frozen freezes the
Hutchinson probes so --warm_start carries the full [y|z] solution
across steps (round-4 VERDICT next #1/#5).
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import jax
import jax.numpy as jnp
import numpy as np


def rff_gp_draw(n, d, ell, sf2, noise_std, seed=0, features=4096):
    """y ~ GP(0, sf2 * rbf(ell)) + N(0, noise_std^2), approximated with
    random Fourier features (cost O(n * features), exact as features ->
    inf). Returns (X, y) float32."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n, d))
    W = rng.standard_normal((d, features)) / ell   # spectral draw for rbf
    b = rng.uniform(0, 2 * np.pi, size=features)
    phi = np.sqrt(2.0 * sf2 / features) * np.cos(X @ W + b)
    w = rng.standard_normal(features)
    f = phi @ w
    y = f + noise_std * rng.standard_normal(n)
    return X.astype(np.float32), y.astype(np.float32)


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    on_gpu = jax.default_backend() == "gpu"
    n = int(args.get("--n", 100_000 if on_gpu else 4096))
    d = int(args.get("--d", 4))
    steps = int(args.get("--steps", 12))
    lr = float(args.get("--lr", 0.1))
    rank = int(args.get("--rank", 128))
    refresh = int(args.get("--refresh", 6))
    probes = int(args.get("--probes", 8))
    tol = float(args.get("--tol", 1e-4))
    max_iters = int(args.get("--max_iters", 300))
    block = int(args.get("--block", 4096))
    segment_iters = int(args.get("--segment_iters", 0))
    probe_mode = args.get("--probe_mode", "fresh")
    warm_start = bool(int(args.get("--warm_start", 1)))
    checkpoint_dir = args.get("--checkpoint_dir")  # resume across bench
    # invocations (fit_iterative's own checkpoint/resume, C16): a second
    # run with a larger --steps continues the SAME trajectory instead of
    # restarting — how envelope-scale captures survive session limits

    from cugp_tpu.inference import map_opt
    from cugp_tpu.ops import kernels as kops

    # generating truth (log space): ell=1.5, sf2=1.0, sn2=0.04
    true_ell, true_sf2, true_sn2 = 1.5, 1.0, 0.04
    X, y = rff_gp_draw(n, d, ell=true_ell, sf2=true_sf2,
                       noise_std=math.sqrt(true_sn2), seed=0)
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y)

    # deliberately wrong init
    init = kops.init_params(d=d, lengthscale=0.6, signal_var=0.3,
                            noise_var=0.3)
    if "--init_from" in args:
        # continuation runs: start from a previous capture's "recovered"
        # dict (JSON file) — extends the trajectory when one session's
        # step budget isn't enough at envelope-scale n (Adam moments
        # reset; errors still reported vs the same generating truth)
        with open(args["--init_from"]) as f:
            prev = json.load(f)
        rec = prev.get("recovered", prev)
        init = {k: jnp.asarray(np.asarray(v, np.float32))
                for k, v in rec.items()}
    out = {"n": n, "d": d, "steps": steps, "rank": rank,
           "refresh": refresh, "probes": probes, "tol": tol,
           "block": block, "segment_iters": segment_iters,
           "probe_mode": probe_mode, "warm_start": warm_start,
           "backend": jax.default_backend(),
           "truth": {"log_lengthscale": round(math.log(true_ell), 4),
                     "log_signal_var": round(math.log(true_sf2), 4),
                     "log_noise_var": round(math.log(true_sn2), 4)}}

    step_walls = []
    last = [time.perf_counter()]

    def cb(step, params, value, grads):
        now = time.perf_counter()
        step_walls.append(now - last[0])
        last[0] = now
        print(f"# step {step}: quad-obj={value:.1f} "
              f"wall={step_walls[-1]:.1f}s "
              f"ell={np.exp(np.asarray(params['log_lengthscale'])).round(3).tolist()} "
              f"sn2={float(np.exp(params['log_noise_var'])):.4f}",
              file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    params, info = map_opt.fit_iterative(
        init, Xj, yj, kind="rbf", steps=steps, learning_rate=lr,
        block=block, tol=tol, max_iters=max_iters, num_probes=probes,
        precond_rank=rank, precond_refresh=(refresh or "auto"),
        segment_iters=segment_iters, probe_mode=probe_mode,
        warm_start=warm_start, checkpoint_dir=checkpoint_dir,
        checkpoint_every=1,
        key=jax.random.key(0), callback=cb, verbose=True)
    wall = time.perf_counter() - t0

    # steady steps/s: median of post-compile steps that did NOT rebuild
    # the preconditioner (those pay the pivot loop)
    refresh_mod = refresh if refresh else steps + 1  # adaptive: keep all
    non_refresh = [w for i, w in enumerate(step_walls)
                   if i % refresh_mod != 0 and i > 0]
    steady = (sorted(non_refresh)[len(non_refresh) // 2] if non_refresh
              else step_walls[-1])
    out.update(
        wall_s=round(wall, 1),
        steady_step_s=round(steady, 2),
        steady_steps_per_s=round(1.0 / steady, 4),
        first_step_s=round(step_walls[0], 1),
        cg_iters=np.asarray(info["cg_iters"]).tolist(),
        precond_rebuilds=int(info["precond_rebuilds"]),
        recovered={k: np.asarray(v).round(4).tolist()
                   for k, v in params.items()},
        abs_err_log_ell=round(float(np.max(np.abs(
            np.asarray(params["log_lengthscale"]) - math.log(true_ell)))), 4),
        abs_err_log_sn2=round(float(abs(
            float(params["log_noise_var"]) - math.log(true_sn2))), 4),
    )
    print("# partial: " + json.dumps(out), file=sys.stderr, flush=True)

    # oracle check on a dense subsample: fitted params must beat the init
    # by a margin, and be within noise of the truth's LML
    from cugp_tpu.models import exact_gp

    ns = min(16384, n)
    Xs, ys = Xj[:ns], yj[:ns]
    lml = jax.jit(lambda p: exact_gp.log_marginal_likelihood(
        p, Xs, ys, kind="rbf"))
    true_p = kops.init_params(d=d, lengthscale=true_ell,
                              signal_var=true_sf2, noise_var=true_sn2)
    l_init, l_fit, l_true = (float(lml(p)) for p in (init, params, true_p))
    out.update(subsample_n=ns,
               lml_init_per_pt=round(l_init / ns, 4),
               lml_fit_per_pt=round(l_fit / ns, 4),
               lml_truth_per_pt=round(l_true / ns, 4),
               fit_minus_truth_per_pt=round((l_fit - l_true) / ns, 5),
               recovered_ok=bool(l_fit > l_init and
                                 (l_true - l_fit) / ns < 0.05))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
