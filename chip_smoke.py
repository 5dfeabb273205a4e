"""On-card smoke test of the exact-GP engine's main path.

    python chip_smoke.py            # phases P0-P4 on one GPU
    python chip_smoke.py --cards=4  # the distributed phase on four GPUs only

Each phase drives the public API at a real size, prints one JSON line with
its numbers and exits non-zero when a gate fails. The last line of a
passing run is {"ok": true, "device": {"platform", "kind", "count"}}.
Without a GPU, or without the cugp_tpu package beside this file, the
script exits non-zero and prints no result.

  P0  device: the card as nvidia-smi reports it, JAX version, XLA_FLAGS,
      compile cache.
  P1  dense exact GP at N=32768, d=8: GP.fit (5 Adam steps) + predict at
      1024 points; LML finite and improving, Cholesky reconstruction
      residual < 2e-4 on the first 4096 rows, variances >= 0.
  P2  accuracy at N=8192, d=4: LML, posterior mean and variance within
      1e-3 of the float64 oracle.
  P3  matrix-free tier at n=131072, d=8: GP.fit_iterative (3 steps) +
      predict_iterative; the fused Pallas/Triton matvec against the XLA
      matvec at r=1 and r=17 (relative error <= 1e-4) and both timings.
  P4  hyperparameter HMC, 256 chains at n=512, one program.
  --cards=4: ring covariance -> row_to_2d -> distributed Cholesky,
      distributed_lml, block-cyclic Cholesky and dp-sharded per-chain
      LMLs at N=32768, each against the single-card dense LML (<= 1e-4).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def col_relerr(a, b):
    """Largest column-wise ||a - b|| / ||b||."""
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    return float(np.max(np.linalg.norm(a - b, axis=0)
                        / np.linalg.norm(b, axis=0)))


def timed(fn, *args, reps=5):
    """Median seconds of fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def phase_device(cards):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX reports platform {devs[0].platform!r}")
    check(len(devs) >= cards, f"{cards} GPUs asked for, {len(devs)} found")
    return {"jax": jax.__version__, "devices": len(devs),
            "kind": devs[0].device_kind,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": jax.config.jax_compilation_cache_dir}


def phase_dense(n=32768, d=8, steps=5, m=1024, nb=4096):
    import jax
    import jax.numpy as jnp

    from cugp_tpu import GP
    from cugp_tpu.data import synthetic
    from cugp_tpu.ops import cholesky as chol_ops
    from cugp_tpu.ops import kernels as kops

    X, y, _ = synthetic.multidim_regression(n=n, d=d, seed=0)
    Xs = np.random.default_rng(1).uniform(-2, 2, (m, d))
    t0 = time.perf_counter()
    GP(kind="rbf").fit(X, y, steps=steps)  # compiles
    t_first = time.perf_counter() - t0
    gp = GP(kind="rbf")
    t0 = time.perf_counter()
    info = gp.fit(X, y, steps=steps)
    loss = np.asarray(info["loss"])
    t_fit = time.perf_counter() - t0
    check(np.all(np.isfinite(loss)), f"fit loss not finite: {loss}")
    check(loss[-1] < loss[0], f"negative LML did not go down: {loss}")
    t_pred = timed(gp.predict, Xs, reps=3)
    mu, var = (np.asarray(a) for a in gp.predict(Xs))
    check(mu.shape == (m,) and np.all(np.isfinite(mu)), "mean not finite")
    check(np.all(np.isfinite(var)) and np.all(var >= 0), "variance < 0")

    @jax.jit
    def residual(params, X):
        K = kops.train_covariance(params, X, "rbf", 1e-6)
        L = chol_ops.cholesky(K)
        r = jnp.matmul(L[:nb], L[:nb].mT,
                       precision=jax.lax.Precision.HIGHEST) - K[:nb, :nb]
        return jnp.max(jnp.abs(r)) / jnp.max(jnp.abs(K[:nb, :nb]))

    relres = float(residual(gp.params, gp.X))
    check(relres < 2e-4, f"Cholesky residual {relres} >= 2e-4")
    return {"n": n, "d": d, "loss": loss.tolist(),
            "s_per_fit_step": t_fit / steps, "s_first_fit": t_first,
            "s_predict": t_pred, "m": m, "chol_method":
            chol_ops.auto_method(n), "chol_recon_relerr": relres,
            "peak_bytes": peak_bytes()}


def phase_oracle(n=8192, d=4, m=512, tol=1e-3):
    import jax

    from cugp_tpu import GP
    from cugp_tpu.data import synthetic
    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.oracle import exact_gp_np as oracle

    X, y, _ = synthetic.multidim_regression(n=n, d=d, seed=1)
    Xs = np.random.default_rng(2).uniform(-2, 2, (m, d))
    params = kops.init_params(d=d, lengthscale=1.0, signal_var=1.0,
                              noise_var=0.04)
    gp = GP(kind="rbf").condition(X, y, params)
    lml = float(gp.log_marginal_likelihood())
    mu, var = (np.asarray(a, np.float64) for a in gp.predict(Xs))
    p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    lml_ref = oracle.log_marginal_likelihood(p64, X, y, "rbf")
    mu_ref, var_ref = oracle.posterior(p64, X, y, Xs, "rbf")
    out = {"n": n, "d": d, "lml": lml, "lml_oracle": float(lml_ref),
           "lml_relerr": rel(lml, lml_ref),
           "mean_maxabs": float(np.max(np.abs(mu - mu_ref))),
           "var_maxabs": float(np.max(np.abs(var - var_ref))),
           "matmul_precision": str(jax.config.jax_default_matmul_precision)}
    check(out["lml_relerr"] <= tol, f"LML off the oracle: {out}")
    check(out["mean_maxabs"] <= tol, f"mean off the oracle: {out}")
    check(out["var_maxabs"] <= tol, f"variance off the oracle: {out}")
    return out


def phase_iterative(n=131072, d=8, steps=3, m=64, tol=1e-4):
    import jax
    import jax.numpy as jnp

    from cugp_tpu import GP
    from cugp_tpu.data import synthetic
    from cugp_tpu.inference import iterative

    X, y, _ = synthetic.multidim_regression(n=n, d=d, seed=2)
    Xs = np.random.default_rng(3).uniform(-2, 2, (m, d))
    gp = GP(kind="rbf")
    t0 = time.perf_counter()
    info = gp.fit_iterative(X, y, steps=steps)
    t_fit = time.perf_counter() - t0
    loss = np.asarray(info["loss"])
    check(np.all(np.isfinite(loss)), f"fit_iterative loss: {loss}")
    t0 = time.perf_counter()
    mu, var = (np.asarray(a) for a in gp.predict_iterative(Xs))
    t_pred = time.perf_counter() - t0
    check(np.all(np.isfinite(mu)), "iterative mean not finite")
    check(np.all(np.isfinite(var)) and np.all(var >= 0),
          "iterative variance < 0")
    out = {"n": n, "d": d, "loss": loss.tolist(),
           "cg_iters": np.asarray(info["cg_iters"]).tolist(),
           "s_fit_with_compile": t_fit, "s_predict_with_compile": t_pred,
           "matvec_method_auto": iterative.matvec_method(gp.X, "rbf")}
    for r in (1, 17):
        v = jax.random.normal(jax.random.key(r), (n, r), jnp.float32)
        fk = jax.jit(iterative.make_matvec(gp.params, gp.X, method="pallas"))
        fx = jax.jit(iterative.make_matvec(gp.params, gp.X, method="xla"))
        err = col_relerr(fk(v), fx(v))
        out[f"r{r}"] = {"relerr": err, "ms_pallas": 1e3 * timed(fk, v),
                        "ms_xla": 1e3 * timed(fx, v)}
        check(err <= tol, f"fused matvec off the XLA matvec at r={r}: {err}")
    out["peak_bytes"] = peak_bytes()
    return out


def phase_sampler(n=512, chains=256, warmup=8, samples=8):
    import jax

    from cugp_tpu import GP
    from cugp_tpu.data import synthetic

    X, y, _ = synthetic.sinusoid_1d(n=n, seed=0)
    gp = GP(kind="rbf").condition(X, y)
    t0 = time.perf_counter()
    res = gp.sample_hyperparams(num_chains=chains, sampler="hmc",
                                num_warmup=warmup, num_samples=samples,
                                key=jax.random.key(0))
    draws = [np.asarray(a) for a in jax.tree.leaves(res["samples"])]
    t = time.perf_counter() - t0
    acc = float(res["accept_rate"])
    check(all(np.all(np.isfinite(a)) for a in draws), "non-finite draws")
    check(0.0 < acc <= 1.0, f"acceptance {acc} outside (0, 1]")
    return {"n": n, "chains": chains, "warmup": warmup, "samples": samples,
            "draw_shape": list(draws[0].shape), "accept_rate": acc,
            "s_with_compile": t}


def _dense_lml(params, X, y):
    """Single-card reference: the dense LML with X, y on device 0."""
    import jax

    from cugp_tpu.models import exact_gp

    params, X, y = jax.device_put((params, X, y), jax.devices()[0])
    return float(exact_gp.log_marginal_likelihood(params, X, y,
                                                  method="xla"))


def phase_distributed(n=32768, d=8, cards=4, chunk=8192, block=512,
                      tol=1e-4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cugp_tpu.data import synthetic
    from cugp_tpu.models import exact_gp
    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.ops import trsm as trsm_ops
    from cugp_tpu.parallel import (block_cyclic, distributed_chol,
                                   mesh as mesh_lib, relayout, ring)

    X_np, y_np, _ = synthetic.multidim_regression(n=n, d=d, seed=3)
    X = jnp.asarray(X_np, jnp.float32)
    y = jnp.asarray(y_np, jnp.float32)
    params = kops.init_params(d=d, lengthscale=1.5, signal_var=1.0,
                              noise_var=0.04)
    ref = _dense_lml(params, X, y)
    mesh = mesh_lib.make_mesh(cards, dp=1)

    def lml_from_L(L):
        alpha = trsm_ops.solve_ltx(L, trsm_ops.solve_lx(L, y))
        return (-0.5 * jnp.dot(y, alpha)
                - jnp.sum(jnp.log(jnp.diagonal(L)))
                - 0.5 * n * exact_gp.LOG2PI)

    X_rc = jax.device_put(X, NamedSharding(mesh, P(("r", "c"), None)))
    K_rows = ring.ring_train_covariance(params, X_rc, mesh, kind="rbf",
                                        jitter=1e-6, axis=("r", "c"))
    K = relayout.row_to_2d(K_rows, mesh)
    L = jax.jit(lambda K: distributed_chol.distributed_cholesky(
        K, mesh, chunk=chunk))(K)
    lml_ring = float(jax.jit(lml_from_L)(L))
    lml_dist = float(jax.jit(lambda p, X, y: distributed_chol.distributed_lml(
        p, X, y, mesh, chunk=chunk))(params, X, y))
    L_bc = block_cyclic.block_cyclic_cholesky(K, mesh, block=block)
    lml_bc = float(jax.jit(lml_from_L)(L_bc))

    # dp layout: chains sharded over every card, the dataset replicated
    mesh_dp = mesh_lib.make_mesh(cards, dp=cards)
    keys = jax.random.split(jax.random.key(0), cards)
    chain_params = jax.vmap(lambda k: jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(k, a.shape, a.dtype),
        params))(keys)
    chain_params = jax.device_put(chain_params,
                                  NamedSharding(mesh_dp, P("dp")))
    rep = NamedSharding(mesh_dp, P())
    chain_lmls = jax.jit(
        lambda cp, X, y: jax.vmap(lambda p: exact_gp.log_marginal_likelihood(
            p, X, y, method="xla"))(cp),
        out_shardings=NamedSharding(mesh_dp, P("dp")),
    )(chain_params, jax.device_put(X, rep), jax.device_put(y, rep))
    chain_refs = [
        _dense_lml(jax.tree.map(lambda a, i=i: a[i], chain_params), X, y)
        for i in range(cards)]

    def devset(a):
        return sorted(dev.id for dev in a.sharding.device_set)

    out = {"n": n, "d": d, "cards": cards, "lml_single_card": ref,
           "relerr_ring_distributed_chol": rel(lml_ring, ref),
           "relerr_distributed_lml": rel(lml_dist, ref),
           "relerr_block_cyclic": rel(lml_bc, ref),
           "relerr_chain_lmls": max(rel(a, b) for a, b in zip(
               np.asarray(chain_lmls), chain_refs)),
           "device_sets": {"K_rows": devset(K_rows), "K_2d": devset(K),
                           "L": devset(L), "L_block_cyclic": devset(L_bc),
                           "chain_lmls": devset(chain_lmls)}}
    for name, ids in out["device_sets"].items():
        check(len(ids) == cards, f"{name} lives on devices {ids} only")
    for key in ("relerr_ring_distributed_chol", "relerr_distributed_lml",
                "relerr_block_cyclic", "relerr_chain_lmls"):
        check(out[key] <= tol, f"{key} = {out[key]} > {tol}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed phase on 4 GPUs")
    args = ap.parse_args(argv)
    try:
        import jax

        sys.path.insert(0, HERE)
        try:
            import cugp_tpu  # noqa: F401
        except ImportError as e:
            raise SmokeFailure(f"cugp_tpu not found beside {__file__}: {e}")
        emit("P0_device", **phase_device(args.cards))
        if args.cards == 4:
            phases = [("P5_distributed", phase_distributed)]
        else:
            phases = [("P1_dense", phase_dense), ("P2_oracle", phase_oracle),
                      ("P3_iterative", phase_iterative),
                      ("P4_sampler", phase_sampler)]
        for name, fn in phases:
            t0 = time.perf_counter()
            res = fn()
            emit(name, seconds=time.perf_counter() - t0, **res)
        dev = jax.devices()[0]
        print(card_lines(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}}), flush=True)
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
