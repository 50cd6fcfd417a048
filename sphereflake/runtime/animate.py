"""Camera-path animation — the headless analogue of the reference's
interactive navigation.

The reference's main loop translates the camera with WASDQE at a speed
proportional to the closest-sphere distance (`main.cpp:206-257`, speed
law at `main.cpp:213`) and yaw/pitches with the mouse — the classic
"fractal zoom" interaction: the closer you get, the slower you move,
and the LOD cut keeps revealing deeper levels. Headless rendering keeps
the same capabilities as frame-sequence drivers:

- **approach**: fly the camera along its forward axis, each frame
  advancing `speed_factor * closest_sphere_distance` (the reference's
  exact speed law, fed by the same metric, `Sphereflake.h:55-58`) —
  a Zeno dive that exercises the adaptive depth.
- **orbit**: a turntable around the fractal at constant radius, always
  looking at the origin.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import jax.numpy as jnp
import numpy as np

from sphereflake.config import RenderConfig, SceneParams


def _look_at_origin(position):
    """Yaw/pitch that aim the camera's -Z forward axis at the origin.

    The camera rotation is R = Rz(roll) @ Ry(pitch) @ Rx(yaw)
    (`transforms.look_rotation`; the reference's "yaw" rotates about x,
    `camera.h:65-68`), so the forward axis is R @ (0,0,-1) =
    (-cos(yaw) sin(pitch), sin(yaw), -cos(yaw) cos(pitch)). Solving
    for forward f = -position/|position|:
    yaw = asin(fy), pitch = atan2(-fx, -fz)."""
    f = -position / jnp.linalg.norm(position)
    yaw = jnp.arcsin(jnp.clip(f[1], -1.0, 1.0))
    pitch = jnp.arctan2(-f[0], -f[2])
    return yaw, pitch


def camera_forward(cam):
    """The camera's forward axis (the -Z column of its rotation)."""
    from sphereflake.ops.transforms import look_rotation

    rot = look_rotation(cam.yaw, cam.pitch, cam.roll)
    return rot @ jnp.asarray([0.0, 0.0, -1.0], jnp.float32)


def _orbit_scene(scene, cam0, radius, i, n_frames):
    angle = 2.0 * np.pi * i / max(n_frames, 1)
    base = cam0.position
    c, s = np.cos(angle), np.sin(angle)
    pos = jnp.asarray(
        [
            c * base[0] + s * base[2],
            base[1],
            -s * base[0] + c * base[2],
        ],
        jnp.float32,
    )
    pos = pos * (radius / jnp.linalg.norm(pos))
    yaw, pitch = _look_at_origin(pos)
    cam = dataclasses.replace(cam0, position=pos, yaw=yaw, pitch=pitch)
    return dataclasses.replace(scene, camera=cam)


def animate_frames_dp(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    devices,
) -> Iterator[tuple[np.ndarray, SceneParams]]:
    """Orbit animation with FRAME data parallelism: each device
    renders a DIFFERENT full frame per dispatch
    (`parallel.render_frames_dp`) — the efficient fleet shape for
    small frames, where screen-tile sharding is fixed-cost-limited.
    Overflowing batches retry on a grown config
    (capacity ladder), like the sequential path."""
    import jax

    from sphereflake.parallel import make_frame_mesh, render_frames_dp
    from sphereflake.render import grow_capacity

    mesh = make_frame_mesh(devices)
    n_dev = len(devices)
    cam0 = scene.camera
    radius = float(jnp.linalg.norm(cam0.position))
    for b0 in range(0, n_frames, n_dev):
        idx = [min(b0 + k, n_frames - 1) for k in range(n_dev)]
        scenes = [
            _orbit_scene(scene, cam0, radius, i, n_frames) for i in idx
        ]
        batched = jax.tree.map(lambda *xs: jnp.stack(xs), *scenes)
        while True:
            images, ovf = render_frames_dp(batched, cfg, mesh)
            if not int(np.asarray(ovf).sum()):
                break
            cfg = grow_capacity(cfg)
        images = np.asarray(images)
        for k in range(n_dev):
            if b0 + k >= n_frames:
                break
            yield images[k], scenes[k]


def frameless_animate(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    steps_per_frame: int = 8,
    tiles_per_step: int = 256,
    mode: str = "orbit",
    speed_factor: float = 0.05,
    seed: int = 0,
    composite: bool = True,
) -> Iterator[tuple[np.ndarray, SceneParams, dict]]:
    """Fly the camera WHILE framelessly accumulating into ONE buffer —
    the reference's defining interaction: `SetView` lands mid-flight
    and the workers simply start overwriting stale texels with the new
    view (`main.cpp:304`, `Sphereflake.cpp:76-84`); the display thread
    composites whatever mixture is in the buffer every vsync.

    Per camera step the pair table is re-prepared (the analogue of
    SetView: the workers' shared view vectors change, nothing else),
    the SAME `TileProgressiveState` keeps accumulating — tiles not yet
    refreshed under the new camera still show the previous view — and
    a snapshot of the in-flight buffer is yielded after
    `steps_per_frame` steps. Yields (image, scene-at-frame, stats)
    where stats carries samples_traced / closest / refreshed-tile
    fraction for the frame."""
    import dataclasses as _dc

    import jax

    from sphereflake.runtime.progressive import (
        progressive_prepare,
        progressive_tiles_init,
        progressive_tiles_step,
        tile_progressive_composite,
        tile_progressive_gbuffer,
    )

    from sphereflake.runtime.progressive import (
        grow_frameless_capacity,
    )

    assert cfg.algorithm == "binned", "frameless animate rides the binned path"
    state = progressive_tiles_init(cfg, seed=seed)
    cam0 = scene.camera
    radius = float(jnp.linalg.norm(cam0.position))
    # Approach speed law: last KNOWN closest distance. A frame whose
    # refreshed tiles all miss leaves the per-frame metric at _BIG;
    # stepping by speed_factor*_BIG would fling the camera to ~1.5e37
    # (f32 overflow territory), so such frames coast on the previous
    # value — the reference's counter likewise just retains sparse
    # worker samples between resets (`Sphereflake.cpp:197-200`).
    last_closest = None
    for i in range(n_frames):
        if mode == "orbit":
            scene = _orbit_scene(scene, cam0, radius, i, n_frames)
        elif mode != "approach":
            raise ValueError(f"unknown animation mode {mode!r}")

        # SetView: re-bin for the new camera; accumulation state is
        # NOT reset (stale-tile overwrite is the point). Banding can't
        # rescue an over-cap frameless table, so the ladder errors
        # cleanly at the ceiling (grow_frameless_capacity).
        while True:
            prepared = progressive_prepare(scene, cfg)
            if not int(prepared[3]):
                break
            cfg = grow_frameless_capacity(cfg)
        # Track the frame's own closest distance for the approach
        # speed law (the reference resets this metric per report).
        state = _dc.replace(
            state, closest_distance=jnp.float32(np.float32(3.0e38))
        )
        for _ in range(steps_per_frame):
            state = progressive_tiles_step(
                state, scene, cfg, tiles_per_step=tiles_per_step,
                prepared=prepared,
            )
        if composite:
            image = np.asarray(
                tile_progressive_composite(state, scene, cfg)
            )
        else:
            from sphereflake.utils.image import shade_normals

            _p, nrm, _mt, hit = tile_progressive_gbuffer(state, cfg)
            image = shade_normals(np.asarray(nrm), np.asarray(hit))
        closest = float(state.closest_distance)
        stats = {
            "samples_traced": int(state.samples_traced),
            "closest": closest,
            "covered": float(np.asarray(state.covered).mean()),
            "refresh_fraction": min(
                1.0,
                steps_per_frame * tiles_per_step
                / (cfg.tiles_y * cfg.tiles_x),
            ),
        }
        yield image, scene, stats

        if mode == "approach":
            if closest < 1.0e37:
                last_closest = closest
            if last_closest is not None:
                step = speed_factor * last_closest
                fwd = camera_forward(scene.camera)
                cam = dataclasses.replace(
                    scene.camera,
                    position=scene.camera.position + step * fwd,
                )
                scene = dataclasses.replace(scene, camera=cam)
            # else: nothing hit yet — hold position until a sample
            # lands (an all-sky start pose).
        jax.block_until_ready(state.rows)


def animate(
    scene: SceneParams,
    cfg: RenderConfig,
    n_frames: int,
    mode: str = "orbit",
    speed_factor: float = 0.05,
    composite: bool = True,
    mesh=None,
) -> Iterator[tuple[np.ndarray, SceneParams]]:
    """Yield (image [H, W, 3] float, scene-at-frame) per frame.
    `mesh` shards every frame over a device mesh (the CLI passes its
    auto-built one)."""
    if mesh is not None:
        from sphereflake.parallel import (
            render_frame_sharded,
            render_gbuffer_sharded,
        )

        def render_frame(s, c):
            return render_frame_sharded(s, c, mesh)

        def render_gbuffer(s, c):
            return render_gbuffer_sharded(s, c, mesh)
    else:
        from sphereflake.render import render_frame, render_gbuffer

    cam0 = scene.camera
    radius = float(jnp.linalg.norm(cam0.position))
    for i in range(n_frames):
        if mode == "orbit":
            # Rotate the start position about the world Y axis.
            scene = _orbit_scene(scene, cam0, radius, i, n_frames)
        elif mode != "approach":
            raise ValueError(f"unknown animation mode {mode!r}")

        while True:
            if composite:
                image, gb = render_frame(scene, cfg)
            else:
                gb = render_gbuffer(scene, cfg)
                from sphereflake.utils.image import shade_normals

                image = shade_normals(
                    np.asarray(gb.normal), np.asarray(gb.hit)
                )
            if not int(gb.metrics.overflow):
                break
            # Deep poses outgrow the capacity defaults (the reference's
            # recursion has no caps); grow and re-render this frame,
            # keeping the bigger config for the rest of the path.
            from sphereflake.render import grow_capacity

            cfg = grow_capacity(cfg)
        yield np.asarray(image), scene

        if mode == "approach":
            # The reference's speed law: step ∝ closest sphere distance
            # (`main.cpp:213`), so the dive decelerates forever while
            # the LOD cut exposes ever-deeper levels.
            step = speed_factor * float(gb.metrics.closest_distance)
            fwd = camera_forward(scene.camera)
            cam = dataclasses.replace(
                scene.camera, position=scene.camera.position + step * fwd
            )
            scene = dataclasses.replace(scene, camera=cam)
