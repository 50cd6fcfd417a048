"""Demonstrate large-frame operation up to 16384x16384 on one GPU
(VERDICT r2 item 5; the reference documents 16384^2 support,
`/root/reference/README.md:51`).

4096^2 and 8192^2 run the standard banded `render_gbuffer` (full
G-buffer in HBM). 16384^2 (268M rays; full position+normal planes
alone would be 6.4 GB) runs a lean band loop over the same
`binned_gbuffer` production kernel, keeping min_t + hit + a 8x-
downsampled normal preview. Writes the preview PNG to build/.

Usage: python tools/bigframe.py [sizes...]   (default 4096 8192 16384)
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp
import numpy as np

from sphereflake.backend import setup_compile_cache
from sphereflake.config import RenderConfig, default_scene
from sphereflake.ops.binned import binned_gbuffer
from sphereflake.render import render_gbuffer
from sphereflake.utils.image import write_png

scene0 = default_scene()
DS = 8  # preview downsample
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")  # gitignored


def lean_16k(cfg):
    """[H,W] min_t + hit + [H/DS, W/DS, 3] normal preview, banded."""
    band_rows = cfg.effective_band_rows
    n_bands = cfg.tiles_y // band_rows
    band_px = band_rows * cfg.tile_h
    bcfg = dataclasses.replace(
        cfg, height=band_px, band_tile_rows=None, width=cfg.padded_width
    )
    Tb = bcfg.tiles_y * bcfg.tiles_x

    @jax.jit
    def run(scene):
        def band(b):
            y0 = (b * band_px).astype(jnp.float32)
            (min_t, _px, _py, _pz, nx, ny, nz, hitf, _lo, _hi, nodes, povf
             ) = binned_gbuffer(
                (bcfg, cfg.width, cfg.height),
                scene, (jnp.float32(0.0), y0),
            )
            hit = hitf != 0.0

            # untile band-local, then downsample the normal preview
            def untile(f):
                x = f.reshape(bcfg.tiles_y, bcfg.tiles_x, cfg.tile_h,
                              cfg.tile_w)
                return jnp.moveaxis(x, 2, 1).reshape(band_px,
                                                     cfg.padded_width)
            nrm = [untile(c)[::DS, ::DS] for c in (nx, ny, nz)]
            mt = untile(min_t)
            ht = untile(hit.astype(jnp.uint8))
            return mt, ht, jnp.stack(nrm, axis=-1), nodes, povf

        mt, ht, prev, nodes, povf = jax.lax.map(band, jnp.arange(n_bands))
        return (
            mt.reshape(-1, cfg.padded_width)[: cfg.height, : cfg.width],
            ht.reshape(-1, cfg.padded_width)[: cfg.height, : cfg.width],
            prev.reshape(-1, cfg.padded_width // DS, 3),
            jnp.sum(nodes), jnp.sum(povf),
        )

    return run


def main(sizes, depth=6):
    setup_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} depth={depth}",
          file=sys.stderr)
    for size in sizes:
        cfg = RenderConfig(width=size, height=size, max_depth=depth,
                           tile_h=32, tile_w=32, algorithm="binned")
        bands = (cfg.tiles_y // cfg.effective_band_rows
                 if cfg.effective_band_rows else 1)
        if size >= 16384:
            run = lean_16k(cfg)
            t0 = time.perf_counter()
            mt, ht, prev, nodes, povf = run(scene0)
            hits = int(np.asarray(ht, dtype=np.int64).sum())
            dt = time.perf_counter() - t0
            img = (np.asarray(prev) * 0.5 + 0.5) * np.asarray(
                ht, dtype=np.float32)[::DS, ::DS][..., None]
            os.makedirs(OUT_DIR, exist_ok=True)
            write_png(os.path.join(OUT_DIR, f"bigframe_{size}.png"),
                      (img * 255).clip(0, 255).astype(np.uint8))
            closest = float(np.asarray(mt).min())
            ovf = int(povf)
        else:
            t0 = time.perf_counter()
            gb = render_gbuffer(scene0, cfg)
            hits = int(np.asarray(gb.hit, dtype=np.int64).sum())
            dt = time.perf_counter() - t0
            closest = float(gb.metrics.closest_distance)
            ovf = int(gb.metrics.overflow)
        rays = size * size
        print(
            f"{size}x{size}: {dt:.2f}s wall (incl. compile+fetch), "
            f"{bands} bands, hits {hits} ({hits / rays * 100:.1f}%), "
            f"closest {closest:.3f}, overflow {ovf} -> "
            f"{rays / dt / 1e6:.0f}M rays/s lower bound",
            flush=True,
        )


if __name__ == "__main__":
    args = sys.argv[1:]
    depth = 6
    if args and args[0].startswith("d"):
        depth = int(args[0][1:])
        args = args[1:]
    sizes = [int(a) for a in args] or [4096, 8192, 16384]
    main(sizes, depth)
