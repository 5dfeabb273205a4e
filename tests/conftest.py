"""Test fixtures (SURVEY.md section 4).

Tests run on the CPU backend with 8 faked devices so the distributed tier
(shard_map / block-cyclic Cholesky / collectives) is exercised without a
multi-GPU host. Env vars must be set before jax initializes its backends,
hence the module-level settings here. JAX_PLATFORMS picks the backend
(default: cpu); tests marked `gpu` run only where the first device is a
GPU — on the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# the suite's wall is mostly compiles and they repeat identically across
# runs: cache even short ones (the cache directory is cugp_tpu.runtime's)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU as the first JAX device (skips here)")
    config.addinivalue_line("markers", "dist: multi-device tests (faked CPU devices)")
    config.addinivalue_line("markers", "slow: long-running tests")
    config.addinivalue_line(
        "markers", "deep: heavy tests excluded from the quick smoke tier")
    config.addinivalue_line(
        "markers", "quick: auto-applied to every test NOT marked deep/slow "
        "— `pytest -m quick` is the <5-minute smoke tier; "
        "`pytest -m 'deep or slow'` (or tests/run_ci.sh) runs the rest")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "dist" in item.keywords and jax.device_count() < 8:
            item.add_marker(pytest.mark.skip(reason="needs 8 (faked) devices"))
        # two-tier scheme (round-3 VERDICT next #9): `slow` implies deep;
        # everything not deep gets `quick` so `-m quick` needs no
        # per-test bookkeeping
        if "slow" in item.keywords and "deep" not in item.keywords:
            item.add_marker(pytest.mark.deep)
        if "deep" not in item.keywords and "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip `gpu`-marked tests unless the first JAX device is a GPU
    (decided here, at run time, never at import or collection)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; the first JAX device is {platform!r}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_dataset():
    from cugp_tpu.data import synthetic

    X, y, f = synthetic.sinusoid_1d(n=256, noise_std=0.1, seed=1)
    return X, y, f


@pytest.fixture(scope="session")
def oracle():
    from cugp_tpu.oracle import exact_gp_np

    return exact_gp_np


@pytest.fixture(scope="session")
def default_params():
    return {
        "log_lengthscale": np.array([np.log(0.8)]),
        "log_signal_var": np.array(np.log(1.2)),
        "log_noise_var": np.array(np.log(0.05)),
    }
