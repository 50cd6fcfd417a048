"""Scaling-efficiency harness (BASELINE: >=90% linear multi-host).

Measures sharded-render throughput vs device count on the local GPUs
(one process drives them all). `--cpu` runs the same sweep on N
virtual host devices instead: a rehearsal of the mesh logic, whose
times say nothing about a GPU.

Efficiency = throughput(N) / (N * throughput(1)). Rays are independent
in the forward pass, so the ideal is flat per-device throughput; the
harness reports where reality falls off.

Usage: python tools/scaling.py [--devices 1 2 4 8] [--frames 8]
       [--width 1024 --height 512 --depth 4] [--cpu]
"""
from __future__ import annotations

import argparse
import time


def measure(n_dev, args):
    import dataclasses

    import jax
    import numpy as np

    from sphereflake.config import RenderConfig, default_scene
    from sphereflake.parallel import make_mesh, render_gbuffer_sharded

    devices = jax.devices()[:n_dev]
    mesh = make_mesh(devices, shape=(n_dev, 1))
    # Per-device work is held constant (weak scaling, like the
    # reference's per-thread pixel stream): height grows with N.
    cfg = RenderConfig(
        width=args.width,
        height=args.height * n_dev,
        max_depth=args.depth,
        tile_h=args.tile_h,
        tile_w=args.tile_w,
        max_frontier=args.max_frontier,
        algorithm=args.algorithm,
    )
    scene = default_scene()

    def frame(i):
        cam = dataclasses.replace(
            scene.camera, yaw=scene.camera.yaw + 1e-6 * i
        )
        gb = render_gbuffer_sharded(
            dataclasses.replace(scene, camera=cam), cfg, mesh
        )
        return gb.min_t[0, 0]

    jax.block_until_ready(frame(0))  # compile
    ts = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        jax.block_until_ready(frame(1 + i))
        ts.append(time.perf_counter() - t0)
    return cfg.width * cfg.height / float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=128,
                    help="PER-DEVICE height (weak scaling)")
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tile-h", dest="tile_h", type=int, default=32)
    ap.add_argument("--tile-w", dest="tile_w", type=int, default=32)
    ap.add_argument("--max-frontier", dest="max_frontier", type=int,
                    default=512)
    ap.add_argument("--algorithm", default="binned")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on virtual CPU devices (no timings "
                    "of any GPU)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from sphereflake.backend import kernel_route

        if kernel_route() != "triton":
            raise SystemExit("scaling.py measures GPUs; pass --cpu to "
                             "rehearse on virtual CPU devices")

    n_avail = len(jax.devices())
    counts = args.devices or [
        n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail
    ]
    base = None
    print(f"platform={jax.default_backend()} devices={n_avail}")
    for n in counts:
        rps = measure(n, args)
        per_dev = rps / n
        if base is None:
            base = per_dev
        eff = per_dev / base
        print(
            f"N={n:3d}: {rps / 1e6:9.2f}M rays/s total, "
            f"{per_dev / 1e6:8.2f}M/dev, efficiency {eff * 100:6.1f}%",
            flush=True,
        )


if __name__ == "__main__":
    main()
