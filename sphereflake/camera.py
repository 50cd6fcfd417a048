"""Differentiable camera → frustum-corner ray parameterization.

The reference's tracer is parameterized not by a view matrix but by the
three frustum-corner points topLeft/topRight/bottomLeft
(`camera.h:37-53`), and generates rays by bilinear interpolation of those
corners (`Sphereflake.cpp:162-167`). We keep the exact same
parameterization so camera-pose gradients flow through the identical
surface.

Quirk preserved: the corner scaling is `tan(fov/2) / vec3(-aspect,1,0).length()`
where GLM's member `.length()` is the *component count* (3), so
d = tan(fov_rad/2) / 3 (`camera.h:111-114`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sphereflake.config import CameraParams
from sphereflake.ops.transforms import look_rotation, normalize


def camera_scaling(fov_deg):
    """`camera.h:111-114` (including the .length()==3 quirk)."""
    return jnp.tan(jnp.deg2rad(fov_deg) * 0.5) / 3.0


def corner_rays(cam: CameraParams, aspect: float):
    """Return (origin, top_left, top_right, bottom_left), each [3].

    `camera.h:37-53`: corner = position + R @ (±aspect·d, ±d, -1).
    """
    rot = look_rotation(cam.yaw, cam.pitch, cam.roll)
    d = camera_scaling(cam.fov)
    a = jnp.asarray(aspect, dtype=jnp.float32)
    # HIGHEST: a GPU would otherwise run these f32 products in TF32
    # (~3 decimal digits), and the corner rays feed every ray direction.
    mv = partial(jnp.matmul, rot, precision=jax.lax.Precision.HIGHEST)
    one = jnp.ones_like(d)
    top_left = cam.position + mv(jnp.stack([-a * d, d, -one]))
    top_right = cam.position + mv(jnp.stack([a * d, d, -one]))
    bottom_left = cam.position + mv(jnp.stack([-a * d, -d, -one]))
    return cam.position, top_left, top_right, bottom_left


def ray_directions(cam: CameraParams, xs, ys, width: int, height: int):
    """Normalized world-space ray directions for pixel coords (xs, ys).

    Matches `Sphereflake.cpp:149-167`: uv = (x/W, y/H);
    target = TL + (TR-TL)·uvx + (BL-TL)·uvy; dir = normalize(target - origin).
    xs/ys broadcast; returns [..., 3] float32.
    """
    origin, tl, tr, bl = corner_rays(cam, width / height)
    uvx = (jnp.asarray(xs, jnp.float32) / width)[..., None]
    uvy = (jnp.asarray(ys, jnp.float32) / height)[..., None]
    target = tl + (tr - tl) * uvx + (bl - tl) * uvy
    return normalize(target - origin)


def tile_frustum_planes(
    cam: CameraParams,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    x_off: float = 0.0,
    y_off: float = 0.0,
    block_h: int | None = None,
    block_w: int | None = None,
):
    """[T, 4, 3] inward unit normals of each screen tile's bounding
    frustum (row-major over (tile_y, tile_x), matching `render._tile`).

    A tile's rays are bilinear interpolations of the frustum corners
    (`Sphereflake.cpp:162-167`), i.e. convex combinations of the tile's
    4 corner directions — so the 4 planes through the origin and
    adjacent corner pairs bound the whole bundle exactly. Corners are
    taken half a pixel outside the outermost ray coordinates, which
    keeps the frustum conservative for any in-tile sample jitter.

    width/height are the FULL image dims (ray math must be global);
    block_h/block_w (default: full image) describe the sub-image this
    call tiles, offset by (x_off, y_off) pixels — the sharded path
    renders per-device blocks of a larger frame.
    """
    bh = height if block_h is None else block_h
    bw = width if block_w is None else block_w
    ty, tx = bh // tile_h, bw // tile_w
    y0 = jnp.arange(ty, dtype=jnp.float32) * tile_h - 0.5 + y_off
    x0 = jnp.arange(tx, dtype=jnp.float32) * tile_w - 0.5 + x_off
    y1, x1 = y0 + tile_h, x0 + tile_w

    origin, tl, tr, bl = corner_rays(cam, width / height)
    ex, ey = tr - tl, bl - tl

    def corner_dir(gx, gy):
        # Unnormalized is fine: plane normals get normalized below.
        return (
            tl
            - origin
            + ex * (gx / width)[..., None]
            + ey * (gy / height)[..., None]
        )

    gy0, gx0 = jnp.meshgrid(y0, x0, indexing="ij")
    gy1, gx1 = jnp.meshgrid(y1, x1, indexing="ij")
    corners = jnp.stack(
        [
            corner_dir(gx0, gy0).reshape(-1, 3),
            corner_dir(gx1, gy0).reshape(-1, 3),
            corner_dir(gx1, gy1).reshape(-1, 3),
            corner_dir(gx0, gy1).reshape(-1, 3),
        ],
        axis=1,
    )  # [T, 4, 3]
    axis = jnp.sum(corners, axis=1)
    n = jnp.cross(corners, jnp.roll(corners, -1, axis=1))
    n = n / jnp.maximum(
        jnp.linalg.norm(n, axis=-1, keepdims=True), jnp.float32(1e-20)
    )
    s = jnp.sign(jnp.sum(n * axis[:, None, :], axis=-1, keepdims=True))
    return n * jnp.where(s == 0, 1.0, s)


def bundle_frustum_planes(dirs):
    """[4, 3] conservative frustum planes for an arbitrary unit-ray
    bundle `dirs` [R, 3]: a 4-plane pyramid circumscribing the bundle's
    bounding cone. Falls back to all-pass planes (zeros) for bundles
    wider than a hemisphere-ish cone, where no pyramid exists."""
    axis = jnp.sum(dirs, axis=0)
    axis = axis / jnp.sqrt(jnp.maximum(jnp.sum(axis * axis), 1e-20))
    cos_t = jnp.min(jnp.matmul(dirs, axis, precision=jax.lax.Precision.HIGHEST))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    # Orthobasis around the axis.
    alt = jnp.where(jnp.abs(axis[0]) < 0.9, jnp.array([1.0, 0.0, 0.0]),
                    jnp.array([0.0, 1.0, 0.0]))
    u = jnp.cross(axis, alt)
    u = u / jnp.sqrt(jnp.maximum(jnp.sum(u * u), 1e-20))
    v = jnp.cross(axis, u)
    # Plane normal tangent to the cone opposite lateral direction e:
    # n = sin(t)*axis - cos(t)*e; dot(n, x) >= 0 for all cone dirs.
    planes = jnp.stack(
        [sin_t * axis - cos_t * e for e in (u, -u, v, -v)], axis=0
    )
    return jnp.where(cos_t > 0.05, planes, jnp.zeros_like(planes))


def pixel_grid(width: int, height: int):
    """Integer pixel-coordinate grids xs, ys of shape [height, width].

    The reference traces rays *at* integer pixel coordinates (uv = x/W,
    not (x+0.5)/W) — see `Sphereflake.cpp:117-127` — so we do too.
    """
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    return xs, ys
