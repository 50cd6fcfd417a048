"""Multi-process worker: sharded render + fit step over a global mesh.

Launched N times (one per "host") by tests/test_multihost.py or by a
real pod launcher. Each process contributes its local (virtual CPU or
real GPU) devices to the global mesh, renders its address-space slice
of the frame, runs one sharded fit step, and writes its locally-owned
shards plus the (replicated) loss/grad fingerprint to an npz for the
launcher to stitch and compare against the single-process render.

Usage:
  python tools/multihost_worker.py <coordinator> <nprocs> <pid> <outdir>
"""
from __future__ import annotations

import sys


def main():
    coordinator, nprocs, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sphereflake.parallel.distributed import (
        global_mesh,
        initialize_distributed,
    )

    initialize_distributed(coordinator, nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()

    import dataclasses

    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import fit_step_sharded, render_gbuffer_sharded

    n_dev = len(jax.devices())
    mesh = global_mesh(shape=(n_dev, 1))  # row-bands: host-contiguous
    cfg = RenderConfig(
        width=128, height=16 * n_dev, max_depth=2, tile_h=16, tile_w=64,
        max_frontier=128,
    )
    scene = default_scene()

    gb = render_gbuffer_sharded(scene, cfg, mesh)

    cam = dataclasses.replace(scene.camera, yaw=scene.camera.yaw + 0.01)
    target = render_gbuffer_sharded(
        dataclasses.replace(scene, camera=cam), cfg, mesh
    )
    loss, grads = fit_step_sharded(
        scene, target.position, target.normal, cfg, mesh
    )

    # Collect this process's addressable shards of the sharded min_t.
    shards = {}
    for s in gb.min_t.addressable_shards:
        y0 = s.index[0].start or 0
        shards[f"minrow_{y0}"] = np.asarray(s.data)
    grad_leaves = jax.tree_util.tree_leaves(grads)
    fingerprint = np.array(
        [float(jax.numpy.sum(jax.numpy.abs(g))) for g in grad_leaves]
    )
    np.savez(
        f"{outdir}/worker_{pid}.npz",
        loss=np.float32(float(loss)),
        grad_fingerprint=fingerprint,
        **shards,
    )
    print(f"worker {pid}/{nprocs}: ok, loss={float(loss):.6f}", flush=True)


if __name__ == "__main__":
    main()
