"""BASELINE config-4 evidence: gradient-descent fitting of fractal +
camera parameters against a 4K depth-8 target, on the GPU.

Renders a 3840x2160 depth-8 target G-buffer at the reference pose,
perturbs yaw and the child radius ratio, and runs a few Adam steps of
`fit.fit` (forward = the binned trace kernel; backward = the
straight-through path-code recompute custom JVP). Prints the loss
trajectory — it must decrease.

Usage: python tools/fit4k_probe.py [steps]
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp

from sphereflake.backend import setup_compile_cache
from sphereflake.config import RenderConfig, default_scene
from sphereflake.fit import fit
from sphereflake.render import render_gbuffer


def main(steps=4):
    setup_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", file=sys.stderr)
    cfg = RenderConfig(width=3840, height=2160, max_depth=8, tile_h=32,
                       tile_w=32, algorithm="binned")
    scene = default_scene()
    t0 = time.perf_counter()
    gb = render_gbuffer(scene, cfg)
    tgt_pos = gb.position
    tgt_nrm = gb.normal
    print(
        f"target: 4K depth-8 rendered in {time.perf_counter() - t0:.1f}s "
        f"(incl. compile), overflow={int(gb.metrics.overflow)}, "
        f"depth_reached={int(gb.metrics.max_depth_reached)}",
        flush=True,
    )
    assert int(gb.metrics.overflow) == 0

    start = dataclasses.replace(
        scene,
        camera=dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 0.004
        ),
        fractal=dataclasses.replace(
            scene.fractal,
            radius_ratio=scene.fractal.radius_ratio + jnp.float32(0.004),
        ),
    )
    t0 = time.perf_counter()
    res = fit(start, tgt_pos, tgt_nrm, cfg, steps=steps,
              learning_rate=2e-3, log_every=1)
    dt = time.perf_counter() - t0
    print(
        f"fit: {steps} steps in {dt:.1f}s (incl. backward compile); "
        f"losses {['%.6f' % l for l in res.losses]}",
        flush=True,
    )
    ok = min(res.losses) < res.losses[0]
    print("config-4 fit DESCENDS" if ok else "FAIL: no descent", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(int(a[0]) if a else 4))
