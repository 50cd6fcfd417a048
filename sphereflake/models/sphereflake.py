"""The sphereflake fractal model: differentiable child frames + root frame.

Geometry semantics match `Sphereflake.cpp:216-249` / `Sphereflake.h:86-226`:

- 9 child template frames, each a rotation plus a *unit* displacement
  stored in the translation column; at traversal time the displacement is
  scaled by (1 + radius_ratio) · parent_sphere_radius (the tangent
  distance; reference: (4/3)·r at `Sphereflake.h:162-168`).
- child frame in world = parent_frame ∘ scaled_template
  (`Sphereflake.h:165-169`).
- the root frame is translate(-camera_position) @ Rx(90°)
  (`Sphereflake.cpp:83`), i.e. sphere centers live in camera-relative
  world space and the ray origin is implicitly 0 — exactly the space the
  reference's G-buffer positions are written in.
- every sphere at tree level L has the same radius:
  root_radius · radius_ratio^L. The reference expresses this by passing
  parentRadius/3 down the recursion (`Sphereflake.h:97`); hoisting it to a
  per-level scalar is what lets this build batch whole levels.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphereflake.config import FractalParams
from sphereflake.ops.transforms import (
    compose_rt,
    euler_xyz_rotation,
    rotation_x,
    spherical_to_world,
)


def child_templates(params: FractalParams):
    """[9, 3, 4] affine child template frames (unit displacement).

    Equatorial ring + polar cap per `Sphereflake.cpp:218-248`; the
    displacement direction comes from spherical coordinates and is
    normalized (it is already unit length for the reference's angles, but
    normalizing keeps gradients well-behaved for fitted parameters).
    """
    rot = euler_xyz_rotation(params.child_rotations_deg)  # [9,3,3]
    longlat = jnp.deg2rad(params.child_longlat_deg)
    disp = spherical_to_world(longlat[:, 0], longlat[:, 1])  # [9,3]
    disp = disp / jnp.linalg.norm(disp, axis=-1, keepdims=True)
    return compose_rt(rot, disp)


def root_frame(camera_position):
    """[3, 4] root frame: translate(-cam_pos) @ Rx(90°) (`Sphereflake.cpp:83`)."""
    rot = rotation_x(jnp.deg2rad(jnp.float32(90.0)))
    return compose_rt(rot, -jnp.asarray(camera_position, jnp.float32))


def level_radius(params: FractalParams, level):
    """Sphere radius at tree level `level` (root sphere = level 0)."""
    return params.root_radius * params.radius_ratio ** jnp.asarray(
        level, jnp.float32
    )
