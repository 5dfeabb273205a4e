"""Process-level runtime set-up (SURVEY.md section 3.5).

- ``configure_compile_cache``: JAX's persistent compilation cache, set
  once when the package is imported.
- ``initialize``: multi-process bring-up (`jax.distributed.initialize`).
  The reference is single-process; this is new surface for the
  multi-process configs (BASELINE.json:11). Compute collectives (panel
  broadcasts, chain psums) go to NCCL over NVLink between the cards of a
  host; the coordinator only bootstraps the processes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path, because the path is part of what the
# cache is found by (.gitignore lists it)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache(environ=None):
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself,
    so nothing is set here); otherwise <checkout>/.jax_cache. Returns the
    directory in use."""
    environ = os.environ if environ is None else environ
    if environ.get(CACHE_ENV):
        return environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


@dataclasses.dataclass
class RuntimeInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int
    backend: str


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Bring up jax.distributed for a multi-process job; no-op otherwise.

    The coordinator (``host:port``), the process count and this process's
    id come from the arguments, or from COORDINATOR_ADDRESS in the
    environment (then JAX reads the rest itself); the CPU multi-process
    test harness (tests/multihost/run_multihost.py) passes them
    explicitly.
    """
    if coordinator_address is not None or "COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    return RuntimeInfo(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=jax.local_device_count(),
        global_devices=jax.device_count(),
        backend=jax.default_backend(),
    )
