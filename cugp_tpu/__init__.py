"""cugp_tpu — an exact Gaussian-process inference engine in JAX.

Built from scratch against the capability surface of the reference CUDA GP
engine (see SURVEY.md / BASELINE.json): dense RBF/Matern covariance
construction, blocked and cuSOLVER Cholesky, batched triangular solves,
LML gradients, a matrix-free CG/SLQ tier with a fused Pallas/Triton
covariance-tile matvec, MAP / HMC / NUTS / VI over kernel
hyperparameters, and GSPMD/shard_map distribution (2D block-cyclic
Cholesky over the device mesh).
"""

import os as _os

import jax as _jax

from cugp_tpu import runtime as _runtime

# GP covariances are numerically fragile: on the GPU, XLA's default
# precision lets float32 matmuls run in TF32 (a 10-bit mantissa), which
# perturbs K at the 1e-3 level and makes Cholesky fail (NaN) as soon as the
# noise is small. "highest" keeps every library matmul in IEEE fp32. Hot-path
# ops pass precision= explicitly; this default covers remaining library dots.
# Host applications embedding cugp_tpu that do NOT want their process-global
# matmul precision changed can opt out with CUGP_TPU_NO_GLOBAL_PRECISION=1
# (library accuracy then rests on the explicit per-op precision arguments).
if not _os.environ.get("CUGP_TPU_NO_GLOBAL_PRECISION"):
    _jax.config.update("jax_default_matmul_precision", "highest")

_runtime.configure_compile_cache()

from cugp_tpu.api import (GP, GPClassifier, SVGP, MultiOutputGP,  # noqa: E402
                          MultiOutputGPQ)
from cugp_tpu.ops.kernels import init_params, SUPPORTED_KERNELS  # noqa: E402

__version__ = "0.2.0"

__all__ = ["GP", "GPClassifier", "SVGP", "MultiOutputGP",
           "MultiOutputGPQ", "init_params",
           "SUPPORTED_KERNELS", "__version__"]
