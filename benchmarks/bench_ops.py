"""Kernels against what XLA makes of the plain version, on one GPU.

Usage: python benchmarks/bench_ops.py [--only=matvec,chol,fit] [--n=131072]
       [--chol_n=8192,32768] [--d=8] [--out=chiprun_out/bench_ops.jsonl]

One JSON line per measurement:
- matvec: the fused Pallas/Triton covariance-tile matvec against the
  blocked XLA matvec (make_matvec method="pallas" vs "xla") at r=1 and
  r=17, ms per call and the relative error between the two.
- chol: cholesky(method="xla") (cuSOLVER) against method="blocked"
  (recursion + SYRK-lower) at each --chol_n, IEEE fp32 (HIGHEST), with
  the reconstruction residual; plus, from a profiler trace of the blocked
  path at the largest n, the share of device time in cuSOLVER potrf and
  cuBLAS trsm kernels (the base cases a hand-written kernel would replace).
- fit: one fit_iterative step end to end with the fused matvec and with
  the XLA matvec, in turns (xla, pallas, pallas, xla).
Fails without a GPU; prints the card's name and power limit first.
"""

import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = None


def emit(**rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        OUT.write(line + "\n")
        OUT.flush()


def timed(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def col_relerr(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    return float(np.max(np.linalg.norm(a - b, axis=0)
                        / np.linalg.norm(b, axis=0)))


def bench_matvec(n, d):
    from cugp_tpu.inference import iterative
    from cugp_tpu.ops import kernels as kops

    X = jax.random.uniform(jax.random.key(0), (n, d), jnp.float32, -2, 2)
    params = kops.init_params(d=d, lengthscale=2.0, noise_var=1e-2)
    for r in (1, 17):
        v = jax.random.normal(jax.random.key(r), (n, r), jnp.float32)
        fk = jax.jit(iterative.make_matvec(params, X, method="pallas"))
        fx = jax.jit(iterative.make_matvec(params, X, method="xla"))
        emit(op="matvec", n=n, d=d, r=r, ms_pallas=1e3 * timed(fk, v),
             ms_xla=1e3 * timed(fx, v), relerr=col_relerr(fk(v), fx(v)))


def _trace_shares(fn, *args):
    """Share of device kernel time in potrf / trsm kernels for one call."""
    with tempfile.TemporaryDirectory() as logdir:
        jax.profiler.start_trace(logdir)
        jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                         recursive=True)[0]
        prof = jax.profiler.ProfileData.from_file(path)
    total, by, names = 0, {"potrf": 0, "trsm": 0}, {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                total += ev.duration_ns
                names[ev.name] = names.get(ev.name, 0) + ev.duration_ns
                for key in by:
                    if re.search(key, ev.name, re.I):
                        by[key] += ev.duration_ns
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    rec = {"device_kernel_ms": total / 1e6,
           **{f"{k}_share": v / max(total, 1) for k, v in by.items()},
           "top_kernels": [[k[:90], v / max(total, 1)] for k, v in top]}
    if not total:  # unexpected trace layout: name what is there
        rec["lines"] = sorted({f"{p.name}|{ln.name}" for p in prof.planes
                               for ln in p.lines})[:40]
    return rec


def bench_chol(sizes, d):
    from cugp_tpu.ops import cholesky as chol_ops
    from cugp_tpu.ops import kernels as kops

    hi = jax.lax.Precision.HIGHEST
    for n in sizes:
        X = jax.random.uniform(jax.random.key(1), (n, d), jnp.float32, -2, 2)
        params = kops.init_params(d=d, lengthscale=2.0, noise_var=1e-2)
        K = jax.jit(kops.train_covariance_xla)(params, X)
        nb = min(n, 4096)
        for method in ("xla", "blocked"):
            f = jax.jit(lambda K, m=method: jnp.diagonal(
                chol_ops.cholesky(K, method=m)))
            g = jax.jit(lambda K, m=method: (lambda L: jnp.max(jnp.abs(
                jnp.matmul(L[:nb], L[:nb].mT, precision=hi) - K[:nb, :nb]))
                / jnp.max(jnp.abs(K[:nb, :nb])))(
                    chol_ops.cholesky(K, method=m)))
            t = timed(f, K, reps=3)
            emit(op="cholesky", n=n, method=method, s=t,
                 tflops=n ** 3 / 3 / t / 1e12, recon_relerr=float(g(K)))
        if n == max(sizes):
            f = jax.jit(lambda K: jnp.diagonal(
                chol_ops.cholesky(K, method="blocked")))
            emit(op="cholesky_blocked_trace", n=n, **_trace_shares(f, K))
        del K


def bench_fit(n, d, steps=1):
    from cugp_tpu.data import synthetic
    from cugp_tpu.inference import iterative, map_opt
    from cugp_tpu.ops import kernels as kops

    X_np, y_np, _ = synthetic.multidim_regression(n=n, d=d, seed=2)
    X = jnp.asarray(X_np, jnp.float32)
    y = jnp.asarray(y_np, jnp.float32)
    init = kops.default_init("rbf", d=d)
    auto = iterative.matvec_method
    for arm in ("xla", "pallas", "pallas", "xla"):
        iterative.matvec_method = lambda X, kind, arm=arm: arm
        jax.clear_caches()
        map_opt.fit_iterative(init, X, y, steps=1)  # compile
        t0 = time.perf_counter()
        _, info = map_opt.fit_iterative(init, X, y, steps=steps)
        t = time.perf_counter() - t0
        emit(op="fit_iterative_step", n=n, d=d, matvec=arm,
             s_per_step=t / steps,
             cg_iters=np.asarray(info["cg_iters"]).tolist())
    iterative.matvec_method = auto


def main(argv=None):
    global OUT
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_ops: needs a GPU, JAX reports {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = args.get("--out")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        OUT = open(out, "w")
    emit(card=card, kind=dev.device_kind, jax=jax.__version__)
    only = args.get("--only", "matvec,chol,fit").split(",")
    n = int(args.get("--n", 131072))
    d = int(args.get("--d", 8))
    if "matvec" in only:
        bench_matvec(n, d)
    if "chol" in only:
        sizes = [int(s) for s in args.get("--chol_n", "8192,32768").split(",")]
        bench_chol(sizes, d)
    if "fit" in only:
        bench_fit(n, d)


if __name__ == "__main__":
    main()
