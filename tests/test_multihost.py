"""Multi-process (multi-"host") tests: 2 processes x 4 virtual devices
on CPU, cross-process collectives included (SURVEY §2 distributed
backend; BASELINE multi-host requirement). The worker renders over a
global 8-device mesh spanning both processes; the stitched result must
match a single-process 8-device render, and both processes must agree
on the all-reduced loss/gradients."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render_and_fit(tmp_path):
    port = _free_port()
    nprocs, per_proc = 2, 4
    env_base = {
        **os.environ,
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={per_proc}",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    procs = []
    for pid in range(nprocs):
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, f"127.0.0.1:{port}",
                 str(nprocs), str(pid), str(tmp_path)],
                env=env_base,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    a = np.load(tmp_path / "worker_0.npz")
    b = np.load(tmp_path / "worker_1.npz")

    # Replicated results must be identical across processes.
    assert float(a["loss"]) == float(b["loss"])
    np.testing.assert_array_equal(a["grad_fingerprint"], b["grad_fingerprint"])
    assert float(a["loss"]) > 0.0
    assert a["grad_fingerprint"].sum() > 0.0

    # Stitch the min_t shards from both processes -> full frame.
    rows = {}
    for f in (a, b):
        for k in f.files:
            if k.startswith("minrow_"):
                rows[int(k.split("_")[1])] = f[k]
    stitched = np.concatenate([rows[k] for k in sorted(rows)], axis=0)

    # Single-process golden on 8 virtual devices (this test process).
    import jax

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_mesh, render_gbuffer_sharded

    n_dev = nprocs * per_proc
    assert len(jax.devices()) == n_dev
    mesh = make_mesh(shape=(n_dev, 1))
    cfg = RenderConfig(
        width=128, height=16 * n_dev, max_depth=2, tile_h=16, tile_w=64,
        max_frontier=128,
    )
    gb = render_gbuffer_sharded(default_scene(), cfg, mesh)
    np.testing.assert_allclose(
        stitched, np.asarray(gb.min_t), rtol=1e-6, atol=1e-6
    )
