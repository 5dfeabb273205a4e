"""Driver benchmark: ONE JSON line with the north-star metric.

Metric (BASELINE.json:2): Cholesky+covariance GFLOP/s/chip at N=32k.
FLOP model (BASELINE.md): Cholesky N^3/3, covariance build 2 N^2 d.

Configuration: the XLA covariance builder + cholesky(method="auto") at
IEEE fp32 (Precision.HIGHEST) — gated by an in-bench accuracy check
(block reconstruction residual must stay below 2e-4 relative, far
inside the 1e-3 posterior-accuracy bar of BASELINE.json:5). N=32768 on
an accelerator; the CPU runs N=2048 (BENCH_N overrides either).

vs_baseline: achieved / (0.70 * measured same-precision GEMM roofline on
this chip). The reference published no numbers (BASELINE.md), so the
operative baseline is the ">=70% of roofline FLOPs" target from
BASELINE.json:5 — vs_baseline = 1.0 means exactly on target, >1 beats it.

MEMORY DISCIPLINE (the round-1 run died RESOURCE_EXHAUSTED holding the
accuracy-gate L alive while timing a second 4 GB factorization): no N x N
array is ever held on device across program invocations here. The gate is
a scalar-output program; the timed factorization is a fused cov->chol
program whose only output is diag(L) (which still forces the entire
factorization — the last diagonal element depends on every panel); the
GEMM roofline is measured before any N=32k work. Peak device footprint is
the inside of ONE program (~3x N^2 fp32 = 12 GB at N=32k), never a sum
across programs.
"""

import json
import sys


def main():
    import os

    import jax
    import jax.numpy as jnp

    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.ops import cholesky as chol_ops
    from cugp_tpu.utils import profiling

    on_cpu = jax.default_backend() == "cpu"
    n = int(os.environ.get("BENCH_N", 2048 if on_cpu else 32768))
    d = 8
    HI = jax.lax.Precision.HIGHEST
    prec = HI
    method = chol_ops.auto_method(n)

    key = jax.random.key(0)
    X = jax.random.uniform(key, (n, d), jnp.float32, -2.0, 2.0)
    params = kops.init_params(d=d, lengthscale=2.0, noise_var=1e-2)

    # ---- GEMM roofline FIRST (512 MB footprint), before any N^2 work.
    # Measured with the on-device loop timer (no per-call dispatch).
    m = min(n, 8192)
    a = jax.jit(lambda k: jax.random.normal(k, (m, m), jnp.float32))(key)
    gemm_gflops = {}
    for p in {prec, HI}:
        def gemm_step(ab, p=p):
            x, y_ = ab
            c = jnp.matmul(x, y_, precision=p)
            return (x, c * jax.lax.rsqrt(jnp.mean(c * c) + 1e-9))

        t_gemm = profiling.timed_loop(gemm_step, (a, a), iters=6)
        gemm_gflops[p] = 2 * m**3 / t_gemm / 1e9
    del a

    def build_k(p_, X_):
        return kops.train_covariance(p_, X_, kind="rbf", jitter=1e-6)

    # ---- accuracy gate: scalar-output program — K and L live only inside
    # one XLA program; nothing N-sized survives it on device.
    nb = min(n, 4096)

    def gate_fn(p_, X_, cp):
        K = build_k(p_, X_)
        L = chol_ops.cholesky(K, method=method, precision=cp)
        r = jnp.matmul(L[:nb], L[:nb].mT, precision=HI) - K[:nb, :nb]
        return jnp.max(jnp.abs(r)) / jnp.max(jnp.abs(K[:nb, :nb]))

    chosen = None
    for attempt_prec in (prec, HI):
        gate = jax.jit(lambda p_, X_, cp=attempt_prec: gate_fn(p_, X_, cp))
        relerr = float(gate(params, X))
        if relerr < 2e-4:
            chosen = attempt_prec
            break
    assert chosen is not None, (
        f"cholesky accuracy gate failed at all precisions: relerr={relerr}")
    prec = chosen

    # ---- timings. t_cov alone (K is a transient output, freed per call);
    # then the fused cov->chol program returning only diag(L).
    iters = int(os.environ.get("BENCH_ITERS", 5))
    cov = jax.jit(lambda p_, X_: build_k(p_, X_))
    t_cov = profiling.timed(cov, params, X, iters=iters)

    both = jax.jit(lambda p_, X_: jnp.diagonal(chol_ops.cholesky(
        build_k(p_, X_), method=method, precision=prec)))
    t_both = profiling.timed(both, params, X, iters=iters)
    t_chol = max(t_both - t_cov, 1e-9)

    # Direct chol-only cross-check on the subtraction above: K held on
    # device (4 GB at N=32k), the timed program consumes it and returns
    # only diag(L). Peak = K + one factorization (~12 GB) — still inside
    # the single-program discipline.
    K_dev = cov(params, X)
    chol_only = jax.jit(lambda K_: jnp.diagonal(chol_ops.cholesky(
        K_, method=method, precision=prec)))
    t_chol_direct = profiling.timed(chol_only, K_dev, iters=iters)
    del K_dev

    flops = n**3 / 3 + 2 * n**2 * d
    gflops = flops / t_both / 1e9
    target = 0.70 * gemm_gflops[prec]
    print(json.dumps({
        "metric": f"cov+chol GFLOP/s/chip @ N={n}",
        "value": round(gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / target, 4),
        "detail": {
            "t_cov_s": round(t_cov, 4),
            "t_chol_s": round(t_chol, 4),
            "t_chol_direct_s": round(t_chol_direct, 4),
            "chol_tflops": round(n**3 / 3 / t_chol / 1e12, 2),
            "chol_tflops_direct": round(n**3 / 3 / t_chol_direct / 1e12, 2),
            "gemm_roofline_gflops": round(gemm_gflops[prec], 2),
            "gemm_roofline_fp32_gflops": round(gemm_gflops[HI], 2),
            "timing_iters": iters,
            "chol_recon_relerr": relerr,
            "precision": str(prec),
            "chol_method": method,
            "n": n,
            "backend": jax.default_backend(),
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
