"""Multi-host smoke test: N CPU processes over localhost (SURVEY.md section 4).

Launches itself `--procs` times with distinct process ids against a local
coordinator, builds a global mesh, and runs one psum + one sharded LML to
exercise the jax.distributed bootstrap without GPU hardware.

Usage: python tests/multihost/run_multihost.py            # launcher
       (workers are spawned internally with _WORKER=1)
"""

import os
import subprocess
import sys


def worker():
    sys.path.insert(0, os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..")))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cugp_tpu import runtime

    info = runtime.initialize(
        coordinator_address=os.environ["COORD"],
        num_processes=int(os.environ["NPROCS"]),
        process_id=int(os.environ["PID_IDX"]),
    )
    assert info.process_count == int(os.environ["NPROCS"]), info

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cugp_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(dp=1)
    n = 128

    import numpy as np
    from cugp_tpu.data import synthetic
    from cugp_tpu.parallel import gspmd
    from cugp_tpu.ops import kernels as kops

    X_np, y_np, _ = synthetic.sinusoid_1d(n=n, seed=0)
    X = jax.make_array_from_callback(
        (n, 1), NamedSharding(mesh, P(("dp", "r"), None)),
        lambda idx: np.asarray(X_np, np.float32)[idx])
    y = jax.make_array_from_callback(
        (n,), NamedSharding(mesh, P(("dp", "r"))),
        lambda idx: np.asarray(y_np, np.float32)[idx])
    params = kops.init_params(d=1)
    val = jax.jit(
        lambda p, X, y: gspmd.lml_sharded(p, X, y, mesh))(params, X, y)
    v = float(val)
    assert v == v, "nan lml"

    # the genuinely-sharded factorization (chunked sweep) across processes
    from cugp_tpu.parallel import distributed_chol

    v2 = float(jax.jit(lambda p, X, y: distributed_chol.distributed_lml(
        p, X, y, mesh, chunk=64))(params, X, y))
    assert abs(v2 - v) / n < 1e-3, (v, v2)

    # ring covariance over the combined ('r','c') ring -> explicit
    # all_to_all relayout -> 2D layout, across process boundaries
    from cugp_tpu.parallel import ring, relayout

    X_rc = jax.make_array_from_callback(
        (n, 1), NamedSharding(mesh, P(("r", "c"), None)),
        lambda idx: np.asarray(X_np, np.float32)[idx])
    K_rows = ring.ring_train_covariance(params, X_rc, mesh, kind="rbf",
                                        jitter=1e-6, axis=("r", "c"))
    K2d = relayout.row_to_2d(K_rows, mesh)
    kdiag = float(jnp.min(jnp.diagonal(K2d)))
    assert kdiag > 0.0, kdiag

    # checkpoint cycle across the process boundary: process 0 writes
    # (utils/checkpoint.save is a no-op on other ranks), everyone
    # barriers, every rank restores collective-free and must see the
    # same values (VERDICT round-2 item #8)
    from jax.experimental import multihost_utils

    from cugp_tpu.utils import checkpoint as ckpt

    ck_dir = os.path.join(os.environ["CKPT_DIR"], "mh_ck")
    saved = {k: np.asarray(v_) for k, v_ in params.items()}
    saved["lml"] = np.float32(v2)
    ckpt.save(ck_dir, saved, step=7)
    multihost_utils.sync_global_devices("ckpt_written")
    restored, meta = ckpt.restore(ck_dir, saved)
    assert meta["step"] == 7, meta
    for k in saved:
        np.testing.assert_array_equal(np.asarray(restored[k]), saved[k])

    if info.process_index == 0:
        print(f"MULTIHOST_OK procs={info.process_count} "
              f"devices={info.global_devices} lml={v:.3f} "
              f"dist_lml={v2:.3f} relayout_ok=True ckpt_ok=True")


def launcher(procs=2):
    import tempfile

    port = 8476 + procs  # distinct port per config so 2- and 4-proc runs
    # can follow each other without TIME_WAIT collisions
    env_base = dict(os.environ)
    env_base.pop("JAX_PLATFORMS", None)
    ck_root = tempfile.mkdtemp(prefix="mh_ckpt_")
    procs_list = []
    for i in range(procs):
        env = dict(env_base)
        env.update({
            "_WORKER": "1",
            "COORD": f"127.0.0.1:{port}",
            "NPROCS": str(procs),
            "PID_IDX": str(i),
            "CKPT_DIR": ck_root,
            # 4 virtual CPU devices per process -> a real 2D ('r','c')
            # grid spanning processes, so the relayout all_to_all and the
            # block-cyclic collectives genuinely cross the process boundary
            "XLA_FLAGS": (env_base.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"
                          ).strip(),
        })
        procs_list.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.join(os.path.dirname(__file__), "..", ".."),
        ))
    ok = True
    for i, p in enumerate(procs_list):
        out, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            ok = False
            print(f"--- worker {i} failed (rc={p.returncode}) ---")
            print(out[-3000:])
        elif "MULTIHOST_OK" in out:
            print(out.strip().splitlines()[-1])
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if os.environ.get("_WORKER"):
        worker()
    else:
        launcher(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
