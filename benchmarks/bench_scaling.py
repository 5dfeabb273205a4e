"""Benchmark harness (C14): posterior samples/s scaling over the chain-DP
axis (the BASELINE.json:2 "posterior samples/s scaling 1->N hosts" metric).

On several hosts, run one process per host (runtime.initialize) and the dp
axis spans hosts; without them the scaling shape is validated on faked
CPU devices (--fake=8) — the collective structure is identical, only the
per-device speed differs.

Usage: python benchmarks/bench_scaling.py [--fake=8] [--dp=1,2,4] [--n=512]
"""

import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import time


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:])
                if a.startswith("--"))
    fake = int(args.get("--fake", 0))
    if fake:
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={fake}")
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from cugp_tpu.data import synthetic
    from cugp_tpu.ops import kernels as kops
    from cugp_tpu.parallel import mesh as mesh_lib, sharded_sampling

    n = int(args.get("--n", 512))
    samples = int(args.get("--samples", 32))
    warmup = int(args.get("--warmup", 32))
    chains_per_dev = int(args.get("--chains-per-dev", 4))
    dps = [int(x) for x in args.get("--dp", "1,2,4").split(",")]

    X, y, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    init = kops.init_params(d=1, lengthscale=0.8, noise_var=0.05)

    rows = []
    for dp in dps:
        if dp > jax.device_count():
            continue
        mesh = mesh_lib.make_mesh(dp, dp=dp)
        t0 = time.perf_counter()
        out = sharded_sampling.sample_hyperparams_sharded(
            init, Xj, yj, mesh, sampler="hmc", num_chains=chains_per_dev * dp,
            num_samples=samples, num_warmup=warmup, key=jax.random.key(0))
        _ = float(out["accept_rate"])
        dt = time.perf_counter() - t0
        rows.append({
            "dp": dp,
            "chains": chains_per_dev * dp,
            "wall_s": round(dt, 2),
            "samples_per_s": round(samples * chains_per_dev * dp / dt, 1),
        })
    print(json.dumps({"scaling": rows, "backend": jax.default_backend()},
                     indent=2))


if __name__ == "__main__":
    main()
