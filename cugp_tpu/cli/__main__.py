"""CLI driver — the reference's ``main()`` equivalent (SURVEY.md section 1.2).

Usage:
  python -m cugp_tpu.cli fit     [--data.n=8000 --model.kind=rbf ...]
      [--fit.engine=iterative]   matrix-free training (n beyond the
                                 dense ceiling; K never formed)
      [--fit.restarts=4]         vmapped multi-start sweep, best wins
  python -m cugp_tpu.cli predict [--data.n=1000 ...]
  python -m cugp_tpu.cli sample  [--sample.num_chains=256 ...]
      [--sample.engine=iterative] matrix-free LML per transition
  python -m cugp_tpu.cli classify [--data.n=400 ...]   (Laplace GPC)
  python -m cugp_tpu.cli vi      [...]
  python -m cugp_tpu.cli sgpr    [--data.n=20000 ...]
  python -m cugp_tpu.cli svgp    [--svgp.likelihood=bernoulli --svgp.batch=256 ...]
  python -m cugp_tpu.cli info
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from cugp_tpu.utils import config as config_lib


def _load_data(cfg):
    from cugp_tpu.data import synthetic

    d = cfg.data
    if d.dataset == "sinusoid":
        X, y, _ = synthetic.sinusoid_1d(n=d.n, noise_std=d.noise_std, seed=d.seed)
    elif d.dataset == "multidim":
        X, y, _ = synthetic.multidim_regression(n=d.n, d=d.d,
                                                noise_std=d.noise_std,
                                                seed=d.seed)
    elif d.dataset == "gp_draw":
        X, y, _ = synthetic.gp_draw(n=d.n, d=d.d, seed=d.seed,
                                    kind=cfg.model.kind)
    elif d.dataset == "npz":
        blob = np.load(d.path)
        X, y = blob["X"], blob["y"]
    else:
        raise ValueError(f"unknown dataset: {d.dataset}")
    return X, y


def _make_gp(cfg):
    from cugp_tpu.api import GP

    return GP(kind=cfg.model.kind, jitter=cfg.model.jitter,
              method=cfg.model.method, basis=cfg.model.basis or None,
              normalize_y=cfg.model.normalize_y)


def cmd_fit(cfg):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg)
    init = None
    if cfg.checkpoint_dir:
        try:
            prev = type(gp).load(cfg.checkpoint_dir)
            init = prev.params
        except FileNotFoundError:
            pass
    t0 = time.perf_counter()
    if cfg.fit.engine == "iterative":
        # the iterative engine is always Adam / LML / single-start —
        # silently ignoring a requested lbfgs/loo/restarts would hand the
        # user a different run than asked for (round-4 ADVICE #3)
        ignored = []
        if cfg.fit.optimizer != "adam":
            ignored.append(f"--fit.optimizer={cfg.fit.optimizer}")
        if cfg.fit.objective != "lml":
            ignored.append(f"--fit.objective={cfg.fit.objective}")
        if cfg.fit.restarts != 1:
            ignored.append(f"--fit.restarts={cfg.fit.restarts}")
        if ignored:
            raise ValueError(
                "fit.engine=iterative supports only Adam/LML/single-start; "
                "incompatible flags: " + ", ".join(ignored))
        # matrix-free training loop (map_opt.fit_iterative): the path for
        # n beyond the dense Cholesky ceiling (round-3 VERDICT next #1).
        # Mid-run optimizer state checkpoints at the SIBLING dir
        # <dir>_fit_state (utils.checkpoint.save atomically replaces a
        # whole directory, so nesting under <dir> would be wiped by the
        # end-of-run facade snapshot), letting a killed multi-hour
        # large-n fit resume mid-trajectory — incl. under
        # utils.supervise.
        fit_ckpt = (cfg.checkpoint_dir.rstrip("/") + "_fit_state"
                    if cfg.checkpoint_dir else None)
        info = gp.fit_iterative(
            X, y, steps=cfg.fit.steps,
            learning_rate=cfg.fit.learning_rate, init=init,
            precond_rank=cfg.fit.precond_rank,
            precond_refresh=(cfg.fit.precond_refresh or "auto"),
            num_probes=cfg.fit.num_probes, tol=cfg.fit.cg_tol,
            max_iters=cfg.fit.cg_max_iters, block=cfg.fit.block,
            segment_iters=("auto" if cfg.fit.segment_iters < 0
                           else cfg.fit.segment_iters),
            probe_mode=cfg.fit.probe_mode,
            final_lml=True,  # info["lml"] must be a real CG+SLQ LML,
                             # comparable with the dense engine's field
            checkpoint_dir=fit_ckpt)
    elif cfg.fit.engine == "dense":
        info = gp.fit(X, y, steps=cfg.fit.steps, optimizer=cfg.fit.optimizer,
                      learning_rate=cfg.fit.learning_rate, init=init,
                      objective=cfg.fit.objective,
                      restarts=cfg.fit.restarts)
    else:
        raise ValueError(
            f"unknown fit.engine {cfg.fit.engine!r}: dense | iterative")
    dt = time.perf_counter() - t0
    if cfg.checkpoint_dir:
        gp.save(cfg.checkpoint_dir)
    if cfg.metrics_file:
        from cugp_tpu.utils.metrics import MetricsLogger

        with MetricsLogger(cfg.metrics_file) as m:
            m.log_series("neg_lml", info["loss"])
            m.log(event="fit_done", seconds=dt, lml=float(info["lml"]))
    out = {
        "lml": float(info["lml"]),
        "seconds": round(dt, 3),
        "resumed": init is not None,
        "params": _params_json(gp.params),
    }
    if "quad_obj" in info:  # iterative engine: the per-step objective is
        out["quad_obj"] = float(info["quad_obj"])  # quad-form only
    if "cg_iters" in info and len(info["cg_iters"]):
        out["cg_iters_last"] = int(info["cg_iters"][-1])
        out["precond_rebuilds"] = int(info["precond_rebuilds"])
    print(json.dumps(out, indent=2))
    return gp


def _params_json(p):
    """JSON view of a params pytree (handles composite terms/factors)."""
    if isinstance(p, dict):
        return {k: _params_json(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_params_json(v) for v in p]
    return np.asarray(p).tolist()


def cmd_predict(cfg):
    gp = cmd_fit(cfg)
    X = np.asarray(gp.X)
    lo, hi = X.min(axis=0), X.max(axis=0)
    Xs = np.linspace(lo, hi, 256).reshape(256, -1)
    mu, var = gp.predict(Xs)
    print(json.dumps({
        "mu_head": np.asarray(mu)[:8].tolist(),
        "var_head": np.asarray(var)[:8].tolist(),
    }, indent=2))


def cmd_sample(cfg):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg)
    gp.condition(X, y)
    t0 = time.perf_counter()
    import jax

    if cfg.checkpoint_dir:
        # chain-state checkpoint/resume: a killed run re-invoked with the
        # same --checkpoint_dir continues from the last saved segment.
        # Composes with --sample.engine=iterative (round-4 VERDICT
        # missing #2): matrix-free LML per transition UNDER the segmented
        # scheduler — the crash-robust large-n sampling configuration.
        from cugp_tpu.inference import sampling

        res = sampling.sample_hyperparams_checkpointed(
            gp.params, gp.X, gp.y, checkpoint_dir=cfg.checkpoint_dir,
            checkpoint_every=cfg.sample.checkpoint_every, kind=cfg.model.kind,
            jitter=cfg.model.jitter, method=cfg.model.method,
            num_samples=cfg.sample.num_samples,
            num_chains=cfg.sample.num_chains,
            num_warmup=cfg.sample.num_warmup, sampler=cfg.sample.sampler,
            max_tree_depth=cfg.sample.max_tree_depth,
            chain_block=cfg.sample.chain_block,
            engine=cfg.sample.engine,
            num_probes=cfg.sample.num_probes,
            precond_rank=cfg.sample.precond_rank,
            key=jax.random.key(cfg.sample.seed),
        )
    elif cfg.sample.engine == "iterative":
        # matrix-free LML per transition: hyperparameter posteriors at n
        # beyond the dense ceiling (sampling.sample_hyperparams_iterative)
        from cugp_tpu.inference import sampling

        res = sampling.sample_hyperparams_iterative(
            gp.params, gp.X, gp.y, kind=cfg.model.kind,
            jitter=cfg.model.jitter,
            num_samples=cfg.sample.num_samples,
            num_chains=cfg.sample.num_chains,
            num_warmup=cfg.sample.num_warmup, sampler=cfg.sample.sampler,
            max_tree_depth=cfg.sample.max_tree_depth,
            chain_block=cfg.sample.chain_block,
            num_probes=cfg.sample.num_probes,
            precond_rank=cfg.sample.precond_rank,
            key=jax.random.key(cfg.sample.seed),
        )
    elif cfg.sample.engine == "dense":
        res = gp.sample_hyperparams(
            num_samples=cfg.sample.num_samples,
            num_chains=cfg.sample.num_chains,
            num_warmup=cfg.sample.num_warmup, sampler=cfg.sample.sampler,
            max_tree_depth=cfg.sample.max_tree_depth,
            chain_block=cfg.sample.chain_block,
            key=jax.random.key(cfg.sample.seed),
        )
    else:
        raise ValueError(
            f"unknown sample.engine {cfg.sample.engine!r}: dense | iterative")
    dt = time.perf_counter() - t0
    from cugp_tpu.inference import sampling as sampling_lib

    stats = {}
    for k, v in res["samples"].items():
        arr = np.asarray(v)
        flat2 = arr.reshape(arr.shape[0], arr.shape[1], -1)
        rhat = [float(sampling_lib.potential_scale_reduction(flat2[:, :, j]))
                for j in range(flat2.shape[2])]
        ess = [float(sampling_lib.effective_sample_size(flat2[:, :, j]))
               for j in range(flat2.shape[2])]
        stats[k] = {
            "mean": arr.mean(axis=(0, 1)).tolist(),
            "std": arr.std(axis=(0, 1)).tolist(),
            "r_hat": rhat if len(rhat) > 1 else rhat[0],
            "ess": ess if len(ess) > 1 else ess[0],
        }
    out = {
        "seconds": round(dt, 3),
        "accept_rate": float(np.asarray(res["accept_rate"]).mean()),
        "posterior": stats,
    }
    if "resumed" in res:
        out["resumed"] = bool(res["resumed"])
        out["draws_done"] = int(res["draws_done"])
    print(json.dumps(out, indent=2))


def cmd_vi(cfg):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg)
    gp.condition(X, y)
    res = gp.fit_vi(steps=cfg.fit.steps, learning_rate=cfg.fit.learning_rate)
    print(json.dumps({
        "elbo": float(np.asarray(res["elbo"])[-1]),
        "mean": {k: np.asarray(v).tolist() for k, v in res["mean"].items()},
    }, indent=2))


def cmd_sgpr(cfg):
    """Sparse (inducing point) fit + predictive check."""
    X, y = _load_data(cfg)
    gp = _make_gp(cfg)
    t0 = time.perf_counter()
    info = gp.fit_sparse(X, y, num_inducing=min(cfg.data.n // 4, 512),
                         steps=cfg.fit.steps,
                         learning_rate=cfg.fit.learning_rate)
    dt = time.perf_counter() - t0
    mu, var = gp.predict_sparse(X[:64])
    print(json.dumps({
        "elbo": float(info["elbo"]),
        "seconds": round(dt, 3),
        "num_inducing": int(gp.Z.shape[0]),
        "train_rmse_head": float(np.sqrt(np.mean(
            (np.asarray(mu) - y[:64]) ** 2))),
    }, indent=2))


def cmd_svgp(cfg):
    """Stochastic variational GP: minibatch SGD on the SVGP bound.

    --svgp.likelihood=gaussian trains on the configured regression
    dataset; =bernoulli trains a classifier on two-moons."""
    from cugp_tpu.api import SVGP

    from cugp_tpu.data import synthetic

    if cfg.svgp.likelihood == "bernoulli":
        X, y = synthetic.two_moons(n=cfg.data.n, noise_std=cfg.data.noise_std,
                                   seed=cfg.data.seed)
    elif cfg.svgp.likelihood == "poisson":
        X, y, _ = synthetic.poisson_counts(n=cfg.data.n, seed=cfg.data.seed)
    elif cfg.svgp.likelihood == "student_t":
        X, y, _ = synthetic.sinusoid_outliers(
            n=cfg.data.n, noise_std=cfg.data.noise_std, seed=cfg.data.seed)
    else:
        X, y = _load_data(cfg)
    model = SVGP(kind=cfg.model.kind, jitter=cfg.model.jitter,
                 likelihood=cfg.svgp.likelihood)
    t0 = time.perf_counter()
    # cap against the LOADED size — for dataset=npz it can differ from
    # cfg.data.n (init_inducing re-clamps too, but the cap should agree)
    info = model.fit(X, y, num_inducing=min(cfg.svgp.num_inducing,
                                            int(np.asarray(X).shape[0]) // 2),
                     steps=cfg.fit.steps, batch=cfg.svgp.batch,
                     learning_rate=cfg.fit.learning_rate,
                     optimize_inducing=cfg.svgp.optimize_inducing)
    dt = time.perf_counter() - t0
    out = {
        "seconds": round(dt, 3),
        "num_inducing": int(model.Z.shape[0]),
        "elbo_batch_final": float(np.asarray(info["elbo_batch_final"])),
    }
    if cfg.svgp.likelihood == "bernoulli":
        p = np.asarray(model.predict_proba(X))
        out["train_accuracy"] = float(np.mean((p > 0.5) == (y > 0)))
    else:
        mu, _ = model.predict(X[:256])
        out["train_rmse_head"] = float(np.sqrt(np.mean(
            (np.asarray(mu) - y[:256]) ** 2)))
    print(json.dumps(out, indent=2))


def cmd_classify(cfg):
    """GP classification (Laplace): two-moons (binary) by default, or the
    multiclass Gaussian-blobs dataset via --data.num_classes>=3 (softmax
    Laplace, models/gpc_multiclass)."""
    from cugp_tpu.api import GPClassifier
    from cugp_tpu.data import synthetic

    num_classes = getattr(cfg.data, "num_classes", 2)
    if num_classes > 2:
        X, y = synthetic.gaussian_blobs(n=cfg.data.n,
                                        num_classes=num_classes,
                                        seed=cfg.data.seed)
    else:
        X, y = synthetic.two_moons(n=cfg.data.n,
                                   noise_std=cfg.data.noise_std,
                                   seed=cfg.data.seed)
    clf = GPClassifier(kind=cfg.model.kind, jitter=cfg.model.jitter,
                       method=cfg.model.method,
                       inference=cfg.model.inference)
    t0 = time.perf_counter()
    info = clf.fit(X, y, steps=cfg.fit.steps,
                   learning_rate=cfg.fit.learning_rate)
    pred = np.asarray(clf.predict(X))
    acc = float(np.mean(pred == np.asarray(y)))
    print(json.dumps({
        "seconds": round(time.perf_counter() - t0, 3),
        "num_classes": int(num_classes),
        "laplace_lml": float(np.asarray(info["lml"])),
        "train_accuracy": acc,
        "params": {k: np.asarray(v).tolist() for k, v in clf.params.items()},
    }, indent=2))


def cmd_info(cfg):
    import jax

    print(json.dumps({
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "config": json.loads(config_lib.to_json(cfg)),
    }, indent=2))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, argv = argv[0], argv[1:]
    # --platform=cpu|cuda must be handled before jax initializes a backend
    profile_dir = None
    for arg in list(argv):
        if arg.startswith("--platform="):
            import jax

            jax.config.update("jax_platforms", arg.split("=", 1)[1])
            argv.remove(arg)
        elif arg.startswith("--profile="):
            profile_dir = arg.split("=", 1)[1]
            argv.remove(arg)
    try:
        cfg, rest = config_lib.parse_overrides(argv)
    except (KeyError, ValueError) as e:
        print(f"bad flag: {e}\n{__doc__}", file=sys.stderr)
        return 2
    if rest:
        print(f"unrecognized args: {rest}", file=sys.stderr)
        return 2
    fn = {
        "fit": cmd_fit, "predict": cmd_predict, "sample": cmd_sample,
        "classify": cmd_classify,
        "vi": cmd_vi, "sgpr": cmd_sgpr, "svgp": cmd_svgp, "info": cmd_info,
    }.get(cmd)
    if fn is None:
        print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
        return 2
    if profile_dir:
        from cugp_tpu.utils import profiling

        with profiling.xprof_trace(profile_dir):
            fn(cfg)
        print(f"xprof trace written to {profile_dir}", file=sys.stderr)
    else:
        fn(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
