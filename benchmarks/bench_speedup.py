"""Benchmark harness (C14): the JAX pipeline vs the serial C++ baseline.

The reference's README-style table — speedup of the accelerated pipeline
over the single-thread CPU implementation on the same problem (the serial
C++ oracle in native/gp_serial.cpp is our C12 stand-in for the reference's
serial tier).

Usage: python benchmarks/bench_speedup.py [--n=4096] [--d=4]
"""

import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import time

import numpy as np


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    n = int(args.get("--n", 4096))
    d = int(args.get("--d", 4))

    import jax
    import jax.numpy as jnp

    from cugp_tpu.data import synthetic
    from cugp_tpu.models import exact_gp
    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.oracle import native
    from cugp_tpu.utils import profiling

    X, y, _ = synthetic.multidim_regression(n=n, d=d, seed=0)
    params64 = {
        "log_lengthscale": np.full(d, np.log(1.5)),
        "log_signal_var": np.log(1.0),
        "log_noise_var": np.log(0.01),
    }

    # serial C++ LML (one full pipeline pass)
    t0 = time.perf_counter()
    lml_cc = native.log_marginal_likelihood(params64, X, y, kind="rbf",
                                            jitter=1e-6)
    t_serial = time.perf_counter() - t0

    # threaded C++ LML (OpenMP, native/gp_parallel.cpp)
    t_par, lml_par, n_threads = None, None, 0
    if native.parallel_available():
        n_threads = native.num_threads()
        t0 = time.perf_counter()
        lml_par = native.log_marginal_likelihood_parallel(
            params64, X, y, kind="rbf", jitter=1e-6)
        t_par = time.perf_counter() - t0

    # device LML (same pipeline, jitted)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    p32 = {k: jnp.asarray(v, jnp.float32) for k, v in params64.items()}
    fn = jax.jit(lambda p: exact_gp.log_marginal_likelihood(
        p, Xj, yj, kind="rbf", jitter=1e-6, method="auto"))
    t_dev = profiling.timed(fn, p32, iters=3)
    lml_dev = float(fn(p32))

    out = {
        "n": n, "d": d,
        "backend": jax.default_backend(),
        "serial_cpp_s": round(t_serial, 3),
        "device_s": round(t_dev, 4),
        "speedup": round(t_serial / t_dev, 1),
        "lml_serial": round(float(lml_cc), 3),
        "lml_device": round(lml_dev, 3),
        "lml_agreement_per_point": abs(float(lml_cc) - lml_dev) / n,
    }
    if t_par is not None:
        out.update({
            "parallel_cpp_s": round(t_par, 3),
            "omp_threads": n_threads,
            "speedup_vs_parallel_cpp": round(t_par / t_dev, 1),
            "lml_parallel_cpp": round(float(lml_par), 3),
        })
    print(json.dumps(out))


if __name__ == "__main__":
    main()
