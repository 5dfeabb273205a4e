"""Matrix-free exact GP at scales where K cannot exist (round-4 surface).

Demonstrates the three large-n entry points on a size that runs anywhere
(bump --n on a GPU, where the fused Pallas/Triton matvec carries the
CG iterations; chip_smoke.py runs n=131072 on one card):

  1. GP.fit_iterative        — hyperparameter LEARNING, K never formed
  2. GP.predict_iterative    — preconditioned-CG posterior
  3. sample_hyperparams_iterative — HMC over the matrix-free LML

Usage: python examples/large_scale_iterative.py [--n=8192] [--platform=cpu]
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import jax
import numpy as np


def main():
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if "--platform" in args:
        jax.config.update("jax_platforms", args["--platform"])
    n = int(args.get("--n", 4096))

    from cugp_tpu.api import GP
    from cugp_tpu.data import synthetic
    from cugp_tpu.inference import sampling

    X, y, _ = synthetic.multidim_regression(n=n, d=3, noise_std=0.2, seed=0)

    gp = GP(kind="rbf")
    info = gp.fit_iterative(X, y, steps=25, learning_rate=0.1,
                            precond_rank=64, precond_refresh=5,
                            num_probes=8, tol=1e-4, block=2048)
    print(f"[fit]  final quad-objective {-float(info['loss'][-1]):.1f}, "
          f"lengthscale {np.exp(np.asarray(gp.params['log_lengthscale'])).round(3)}")

    mu, var = gp.predict_iterative(X[:256], tol=1e-5)
    print(f"[post] mean range [{float(mu.min()):.2f}, {float(mu.max()):.2f}],"
          f" var median {float(np.median(np.asarray(var))):.4f}")

    out = sampling.sample_hyperparams_iterative(
        gp.params, gp.X, gp.y, num_samples=32, num_chains=2, num_warmup=32,
        sampler="hmc", n_leapfrog=8, num_probes=8, precond_rank=32,
        block=2048, key=jax.random.key(0))
    ls = np.asarray(out["samples"]["log_lengthscale"]).reshape(-1)
    print(f"[hmc]  accept {float(out['accept_rate']):.2f}, "
          f"log-lengthscale posterior mean {ls.mean():.3f} +- {ls.std():.3f}")


if __name__ == "__main__":
    main()
