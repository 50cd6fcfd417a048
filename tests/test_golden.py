"""Sanity anchors for the NumPy golden tracer itself (SURVEY §4: unit
tests for ray-sphere intersection vs closed-form scalar math)."""

import math

import numpy as np

from sphereflake.models import golden


def test_single_ray_hits_root_sphere_closed_form():
    # Camera on +x axis at distance 5, looking straight at the root sphere
    # (radius 1 at the world origin). Expected hit distance = 4.
    cam = (5.0, 0.0, 0.0)
    dirs = np.array([[-1.0, 0.0, 0.0]])
    res = golden.golden_trace(dirs, cam, max_depth=0)
    assert abs(res.min_t[0] - 4.0) < 1e-9
    np.testing.assert_allclose(res.position[0], [-4.0, 0.0, 0.0], atol=1e-9)
    # Normal points back toward the camera: (pos - center)/r with
    # center = -cam = (-5,0,0): pos-center = (1,0,0).
    np.testing.assert_allclose(res.normal[0], [1.0, 0.0, 0.0], atol=1e-9)


def test_offset_ray_closed_form():
    # Ray parallel to -x with impact parameter b: t = 5 - sqrt(1 - b^2).
    b = 0.6
    cam = (5.0, 0.0, 0.0)
    dirs = np.array([[-1.0, 0.0, 0.0]])
    res = golden.golden_trace(dirs - 0, (5.0, b, 0.0), max_depth=0)
    expected = 5.0 - math.sqrt(1.0 - b * b)
    assert abs(res.min_t[0] - expected) < 1e-9


def test_miss_gives_sky_sentinel():
    res = golden.golden_trace(np.array([[1.0, 0.0, 0.0]]), (5.0, 0.0, 0.0), max_depth=0)
    assert np.isinf(res.min_t[0])
    np.testing.assert_allclose(res.position[0], 0.0)
    np.testing.assert_allclose(res.normal[0], 0.0)


def test_behind_center_culled():
    # Sphere center behind the ray (tca < 0) is culled even from inside
    # the bounding sphere — the documented reference artifact
    # (SIMD_AVX.h:246-250, README.md:70-78).
    res = golden.golden_trace(np.array([[1.0, 0.0, 0.0]]), (0.5, 0.0, 0.0), max_depth=0)
    assert np.isinf(res.min_t[0])


def test_inside_sphere_negative_t():
    # Camera inside the root sphere with the center ahead: t = tca - thc < 0
    # is accepted (reference keeps min(t0, t1) without clamping,
    # SIMD_AVX.h:260-267).
    res = golden.golden_trace(np.array([[-1.0, 0.0, 0.0]]), (0.5, 0.0, 0.0), max_depth=0)
    assert res.min_t[0] < 0.0
    assert abs(res.min_t[0] - (-0.5)) < 1e-9


def test_depth1_first_child_tangent():
    # Child 0 sits at displacement (4/3)·1 along +x of the root frame with
    # radius 1/3 — external tangency means a ray down the x axis from far
    # +x hits the child first at t = D - 4/3 - 1/3.
    cam = (10.0, 0.0, 0.0)
    # Root frame rotates by Rx(90°) but child 0's displacement (1,0,0) is
    # invariant under Rx.
    dirs = np.array([[-1.0, 0.0, 0.0]])
    res = golden.golden_trace(dirs, cam, max_depth=1)
    expected = 10.0 - (4.0 / 3.0 + 1.0 / 3.0)
    assert abs(res.min_t[0] - expected) < 1e-9


def test_default_pose_renders_fractal():
    res = golden.golden_render_gbuffer(64, 64, max_depth=2)
    hit = np.isfinite(res.min_t)
    # The reference's default pose frames the fractal; a healthy fraction
    # of the image must hit.
    assert hit.mean() > 0.2
    # Normals are unit where hit, zero where sky.
    norms = np.linalg.norm(res.normal[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-9)
    assert res.max_depth_reached == 2
    # Positions are camera-relative: nearest hit distance matches min_t.
    np.testing.assert_allclose(
        np.linalg.norm(res.position[hit], axis=-1),
        np.abs(res.min_t[hit]),
        atol=1e-9,
    )


def test_deeper_levels_add_geometry():
    r1 = golden.golden_render_gbuffer(48, 48, max_depth=0)
    r2 = golden.golden_render_gbuffer(48, 48, max_depth=2)
    assert np.isfinite(r2.min_t).sum() > np.isfinite(r1.min_t).sum()
    # Existing hits only ever get closer when children are added.
    both = np.isfinite(r1.min_t)
    assert (r2.min_t[both] <= r1.min_t[both] + 1e-12).all()
