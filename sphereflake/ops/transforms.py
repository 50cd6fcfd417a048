"""Small differentiable 3D math helpers (jnp).

Replacement for the reference's `Util.h:7-18` (spherical →
Cartesian, Euler XYZ rotation matrix) and the 4x4 matrix vocabulary of
`SIMD_AVX.h:29-81`. Convention: column-vector matrices, ``p' = M @ p``,
composition ``A @ B`` applies B first — identical semantics to the
reference's GLM usage (`worldTransform = parentTransform * transform`,
`Sphereflake.h:169`).

All functions broadcast over leading batch dimensions so they can be
vmapped/jitted freely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def spherical_to_world(longitude, latitude):
    """`Util.h:7-11`: (cos(lat)·sin(lon), sin(lat)·sin(lon), cos(lon)).

    Args are radians; broadcasts; returns [..., 3].
    """
    sin_lon = jnp.sin(longitude)
    return jnp.stack(
        [jnp.cos(latitude) * sin_lon, jnp.sin(latitude) * sin_lon, jnp.cos(longitude)],
        axis=-1,
    )


def rotation_x(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([o, z, z], -1),
            jnp.stack([z, c, -s], -1),
            jnp.stack([z, s, c], -1),
        ],
        axis=-2,
    )


def rotation_y(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, z, s], -1),
            jnp.stack([z, o, z], -1),
            jnp.stack([-s, z, c], -1),
        ],
        axis=-2,
    )


def rotation_z(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], -1),
            jnp.stack([s, c, z], -1),
            jnp.stack([z, z, o], -1),
        ],
        axis=-2,
    )


def euler_xyz_rotation(rot_deg):
    """`Util.h:13-18`: R = Rx(x) @ Ry(y) @ Rz(z), angles in degrees.

    rot_deg: [..., 3] -> [..., 3, 3].
    """
    r = jnp.deg2rad(rot_deg)
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return mm(mm(rotation_x(r[..., 0]), rotation_y(r[..., 1])), rotation_z(r[..., 2]))


def compose_rt(rotation, translation):
    """Pack a [..., 3, 3] rotation and [..., 3] translation into [..., 3, 4].

    We never need the homogeneous bottom row: the fractal transform chain is
    rigid (rotation + translation), so 3x4 affine frames suffice — 25% less
    stack/HBM than the reference's 4x4 `SIMD::Matrix4`.
    """
    return jnp.concatenate([rotation, translation[..., :, None]], axis=-1)


def rt_multiply(a, b):
    """Compose 3x4 affine frames: result = a ∘ b (apply b first).

    Equivalent to the reference's 4x4 multiply (`SIMD_AVX.h:59-81`) on
    rigid transforms: R = Ra@Rb, t = Ra@tb + ta. Broadcasts.
    """
    import jax

    ra, ta = a[..., :3], a[..., 3]
    rb, tb = b[..., :3], b[..., 3]
    # HIGHEST: frame chains compose down to level-8 spheres of radius
    # ~1e-4; a bf16 matmul pass would swamp them.
    hi = jax.lax.Precision.HIGHEST
    r = jnp.matmul(ra, rb, precision=hi)
    t = jnp.einsum("...ij,...j->...i", ra, tb, precision=hi) + ta
    return jnp.concatenate([r, t[..., :, None]], axis=-1)


def rt_translation(a):
    """Extract the translation column (the sphere origin the reference reads
    via `parentTransform.Extract(3)`, `Sphereflake.h:116`)."""
    return a[..., 3]


def normalize(v, axis=-1, eps=0.0):
    """Exact-math normalize.

    The reference normalizes with `rsqrt` + one Newton step
    (`SIMD_AVX.h:170-180`) under fast-math; we use exact math and treat
    the difference as test tolerance (SURVEY §7 "numerics parity").
    """
    n2 = jnp.sum(v * v, axis=axis, keepdims=True)
    return v / jnp.sqrt(n2 + eps)


def look_rotation(yaw, pitch, roll):
    """Reference camera orientation (`camera.h:65-68`):
    quat(vec3(yaw, pitch, roll)).

    GLM's Euler-angle quaternion constructor composes as
    Rz(z) @ Ry(y) @ Rx(x) on column vectors (extrinsic X-Y-Z), with the
    vector read as (x, y, z) = (yaw, pitch, roll) — the reference's
    "yaw" is a rotation about x. Verified numerically against GLM's
    half-angle product formula.
    """
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return mm(mm(rotation_z(roll), rotation_y(pitch)), rotation_x(yaw))
