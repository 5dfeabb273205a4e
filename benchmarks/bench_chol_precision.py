"""Cholesky precision-policy shoot-out (round-3 VERDICT next #6 / weak #1).

Times the blocked recursive Cholesky at N (default 32k) on a REALISTIC
GP covariance (RBF + noise) under the matmul precision policies (on the
GPU, XLA runs HIGHEST as IEEE fp32 and HIGH / DEFAULT as TF32):

  highest       — IEEE fp32 everywhere
  mixed         — fp32 diagonal path + HIGH off-diagonal updates
  high          — HIGH everywhere
  mixed_fast    — HIGH diagonal path + DEFAULT off-diagonal updates

Accuracy gates per policy: sampled-block reconstruction residual
||(L L^T - K)[rows]||_F / ||K[rows]||_F, max diag error, and the LML
computed from L vs the highest-precision LML.

MEMORY DISCIPLINE (the first version died RESOURCE_EXHAUSTED holding
K + L across programs at N=32k): every program builds K itself and
returns only scalars/small rows; nothing N x N survives a program.

Usage: python benchmarks/bench_chol_precision.py [--n=32768] [--iters=3]
       [--platform=cpu]   (N defaults to 32768 on a GPU, 2048 on the CPU)
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


def _barrier(x):
    return np.asarray(jax.tree_util.tree_leaves(x)[0]).ravel()[0]


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    on_gpu = jax.default_backend() == "gpu"
    n = int(args.get("--n", 32768 if on_gpu else 2048))
    iters = int(args.get("--iters", 3))
    rows = int(args.get("--rows", 512))

    from cugp_tpu.data import synthetic
    from cugp_tpu.ops import cholesky as chol_ops
    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.ops import trsm as trsm_ops

    X, y, _ = synthetic.multidim_regression(n=n, d=4, noise_std=0.2, seed=0)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    params = kops.init_params(d=4, lengthscale=1.5, noise_var=0.05)
    _HI = jax.lax.Precision.HIGHEST

    def chol_of(p, X, prec):
        # the policies act on the blocked recursion's trailing updates
        K = kops.train_covariance(p, X, kind="rbf")
        return chol_ops.cholesky(K, method="blocked", precision=prec)

    def timed_program(prec):
        # only diag(L) leaves the program (forces the full factorization)
        return jax.jit(lambda p, X: jnp.diagonal(chol_of(p, X, prec)))

    def gate_program(prec):
        # residual on the LAST `rows` block rows — the final rows depend
        # on every panel/update of the factorization, so they see the
        # policy's full accumulated error (the first rows only test the
        # base potrf); scalars out
        def fn(p, X, y):
            L = chol_of(p, X, prec)
            Krows = kops.train_covariance(p, X, kind="rbf")[-rows:]
            R = jnp.matmul(L[-rows:], L.mT, precision=_HI) - Krows
            rel = jnp.linalg.norm(R) / jnp.linalg.norm(Krows)
            dmax = jnp.max(jnp.abs(jnp.diagonal(R, offset=n - rows)))
            alpha = trsm_ops.cho_solve(L, y[:, None])[:, 0]
            lml = (-0.5 * jnp.dot(y, alpha)
                   - jnp.sum(jnp.log(jnp.diagonal(L)))
                   - 0.5 * n * jnp.log(2.0 * jnp.pi))
            return rel, dmax, lml
        return jax.jit(fn)

    flops = n**3 / 3.0 + 2.0 * n * n * 4
    out = {"n": n, "backend": jax.default_backend(), "rows": rows,
           "flop_model": "n^3/3 + 2n^2 d", "policies": {}}
    lml_ref = None
    policies = [("highest", _HI), ("mixed", "mixed"),
                ("high", jax.lax.Precision.HIGH),
                ("mixed_fast", "mixed_fast")]
    for name, prec in policies:
        fn = timed_program(prec)
        dl = fn(params, Xj)
        _barrier(dl)  # compile
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dl = fn(params, Xj)
            _barrier(dl[-1])
            times.append(time.perf_counter() - t0)
        t = min(times)
        rel, dmax, lml = gate_program(prec)(params, Xj, yj)
        rel, dmax, lml = float(rel), float(dmax), float(lml)
        if lml_ref is None:
            lml_ref = lml
        out["policies"][name] = {
            "wall_s": round(t, 4),
            "tflops": round(flops / t / 1e12, 2),
            "recon_rel_fro": rel,
            "recon_diag_max": dmax,
            "lml_abs_err_vs_highest": round(abs(lml - lml_ref), 4),
            "lml_err_per_point": round(abs(lml - lml_ref) / n, 8),
        }
        print(f"# {name}: {t:.3f}s {flops/t/1e12:.1f} TF/s "
              f"rel={rel:.2e} dmax={dmax:.2e} "
              f"lml_err={abs(lml - lml_ref):.4f}",
              file=sys.stderr, flush=True)
        print("# partial: " + json.dumps(out), file=sys.stderr, flush=True)
    hi = out["policies"]["high"]["tflops"]
    mf = out["policies"]["mixed_fast"]["tflops"]
    out["mixed_fast_speedup_vs_high"] = round(mf / hi, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
