"""Cross-checks between the JAX geometry stack and the independent NumPy
golden implementation, plus hand-computed anchors from the reference's
published constants (`Sphereflake.cpp:216-249`, `camera.h:111-114`)."""

import math

import numpy as np
import jax.numpy as jnp

from sphereflake.config import CameraParams, FractalParams
from sphereflake.camera import camera_scaling, corner_rays, ray_directions
from sphereflake.models.sphereflake import child_templates, level_radius, root_frame
from sphereflake.models import golden
from sphereflake.ops.transforms import (
    euler_xyz_rotation,
    rt_multiply,
    rt_translation,
    spherical_to_world,
)


def test_child_templates_match_golden():
    tmpl = np.asarray(child_templates(FractalParams.reference_default()))
    rots, disps = golden.reference_child_templates()
    np.testing.assert_allclose(tmpl[:, :, :3], rots, atol=1e-6)
    np.testing.assert_allclose(tmpl[:, :, 3], disps, atol=1e-6)


def test_child_displacements_are_unit_and_expected():
    # Equatorial child 0: lon=90°, lat=0° -> (1, 0, 0); polar child 8:
    # lon=30°, lat=270° -> (0, -1/2, √3/2) per Util.h:7-11.
    tmpl = np.asarray(child_templates(FractalParams.reference_default()))
    disps = tmpl[:, :, 3]
    np.testing.assert_allclose(np.linalg.norm(disps, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(disps[0], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(disps[8], [0.0, -0.5, math.sqrt(3) / 2], atol=1e-6)


def test_rotation_composition_order():
    # Rx(90)@Ry(90)@Rz(0) applied to +z: Ry(90) maps z->x ... wait, check
    # against the independent golden implementation instead of hand math.
    r = np.asarray(euler_xyz_rotation(jnp.asarray([37.0, -14.0, 101.0])))
    g = golden.rotation_xyz_deg((37.0, -14.0, 101.0))
    np.testing.assert_allclose(r, g, atol=1e-6)
    # and it is a proper rotation
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    assert abs(np.linalg.det(r) - 1.0) < 1e-6


def test_spherical_to_world_matches_reference_formula():
    lon, lat = 0.7, -1.2
    v = np.asarray(spherical_to_world(jnp.float32(lon), jnp.float32(lat)))
    expected = [
        math.cos(lat) * math.sin(lon),
        math.sin(lat) * math.sin(lon),
        math.cos(lon),
    ]
    np.testing.assert_allclose(v, expected, atol=1e-6)


def test_camera_scaling_quirk():
    # d = tan(fov/2)/3 regardless of aspect (camera.h:111-114: GLM
    # vec3.length() is the component count, 3).
    assert abs(float(camera_scaling(jnp.float32(60.0))) - math.tan(math.pi / 6) / 3) < 1e-6


def test_corner_rays_match_golden_camera():
    cam = CameraParams.reference_default()
    W, H = 64, 48
    dirs = np.asarray(ray_directions(cam, *_grid(W, H), W, H))
    gold = golden.camera_rays(
        np.asarray(cam.position), float(cam.yaw), float(cam.pitch), float(cam.roll),
        float(cam.fov), W, H,
    )
    np.testing.assert_allclose(dirs, gold, atol=1e-5)


def _grid(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return xs.astype(np.float32), ys.astype(np.float32)


def test_root_frame():
    rf = np.asarray(root_frame(jnp.asarray([1.0, 2.0, 3.0])))
    np.testing.assert_allclose(rf[:, 3], [-1.0, -2.0, -3.0], atol=1e-6)
    # Rx(90°): y -> z, z -> -y
    np.testing.assert_allclose(rf[:, :3] @ [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], atol=1e-6)


def test_rt_multiply_matches_4x4():
    rng = np.random.default_rng(0)
    a_r = golden.rotation_xyz_deg(rng.uniform(-180, 180, 3))
    b_r = golden.rotation_xyz_deg(rng.uniform(-180, 180, 3))
    a_t, b_t = rng.normal(size=3), rng.normal(size=3)
    a = np.concatenate([a_r, a_t[:, None]], axis=1)
    b = np.concatenate([b_r, b_t[:, None]], axis=1)
    out = np.asarray(rt_multiply(jnp.asarray(a), jnp.asarray(b)))
    a4 = np.eye(4); a4[:3, :4] = a
    b4 = np.eye(4); b4[:3, :4] = b
    np.testing.assert_allclose(out, (a4 @ b4)[:3, :4], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(rt_translation(jnp.asarray(a))), a_t, atol=1e-6
    )


def test_level_radius():
    p = FractalParams.reference_default()
    np.testing.assert_allclose(float(level_radius(p, 0)), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(level_radius(p, 3)), 1.0 / 27.0, atol=1e-6)


def test_corner_rays_orientation():
    # At zero angles the camera looks down -z; top-left corner has -x, +y.
    cam = CameraParams(
        position=jnp.zeros(3), yaw=jnp.float32(0), pitch=jnp.float32(0),
        roll=jnp.float32(0), fov=jnp.float32(60.0),
    )
    origin, tl, tr, bl = (np.asarray(v) for v in corner_rays(cam, 1.5))
    assert tl[0] < 0 and tl[1] > 0 and tl[2] == -1.0
    assert tr[0] > 0 and bl[1] < 0
    np.testing.assert_allclose(origin, 0.0)
