"""Post-processing ops vs direct NumPy transcriptions of the GLSL
(SURVEY §4 golden strategy), plus texture-sampler unit tests."""

import numpy as np
import jax.numpy as jnp

from sphereflake.config import RenderConfig, SSAOParams, default_scene
from sphereflake.models import golden_post
from sphereflake.ops import post
from sphereflake.ops.noise import MT19937, ssao_noise_texture
from sphereflake.ops.texture import (
    sample_bilinear_clamp,
    sample_bilinear_repeat,
    sample_nearest_clamp,
)
from sphereflake.render import render_frame, render_gbuffer


def _rand_gbuffer(h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(h, w, 3)).astype(np.float32) * 2.0
    pos[..., 2] -= 4.0  # plausible view-space z
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    # sprinkle sky pixels (zero sentinel)
    sky = rng.random((h, w)) < 0.15
    pos[sky] = 0.0
    nrm[sky] = 0.0
    return pos, nrm


def test_mt19937_known_values():
    eng = MT19937(5489)
    assert list(eng.draw(5)) == [
        3499211612, 581869302, 3890346734, 3586334585, 545404204,
    ]
    # across the twist boundary (>624 draws) chunked vs single
    a = MT19937(123).draw(1300)
    b = np.array([MT19937(123).draw(1)[0] for _ in range(0)])  # noqa: F841
    eng2 = MT19937(123)
    c = np.concatenate([eng2.draw(700), eng2.draw(600)])
    np.testing.assert_array_equal(a, c)


def test_noise_texture_properties():
    tex = ssao_noise_texture(64)
    assert tex.shape == (64, 64, 4)
    np.testing.assert_allclose(np.linalg.norm(tex, axis=-1), 1.0, atol=1e-6)
    # deterministic
    np.testing.assert_array_equal(tex, ssao_noise_texture(64))


def test_samplers_match_golden():
    rng = np.random.default_rng(1)
    img = rng.random((7, 5, 3)).astype(np.float32)
    us = rng.random(64) * 1.6 - 0.3  # include out-of-range coords
    vs = rng.random(64) * 1.6 - 0.3
    for jfn, repeat, nearest in [
        (sample_nearest_clamp, False, True),
        (sample_bilinear_clamp, False, False),
        (sample_bilinear_repeat, True, False),
    ]:
        got = np.asarray(jfn(jnp.asarray(img), jnp.asarray(us), jnp.asarray(vs)))
        for i, (u, v) in enumerate(zip(us, vs)):
            if nearest:
                want = golden_post._tex_nearest_clamp(img, u, v)
            else:
                want = golden_post._tex_bilinear(img, u, v, repeat)
            np.testing.assert_allclose(got[i], want, atol=1e-5)


def test_ssao_matches_glsl_transcription():
    pos, nrm = _rand_gbuffer()
    h, w = pos.shape[:2]
    noise = ssao_noise_texture(16)
    p = SSAOParams.reference_default()
    radius = 3.7
    ours = np.asarray(
        post.ssao_pass(
            jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(noise), p,
            jnp.float32(radius), h, w,
        )
    )
    gold = golden_post.ssao_golden(
        pos, nrm, noise, float(p.intensity), float(p.scale), float(p.bias),
        radius, h, w,
    )
    np.testing.assert_allclose(ours, gold, atol=2e-4)


def test_blur_matches_glsl_transcription():
    pos, nrm = _rand_gbuffer(seed=3)
    h, w = pos.shape[:2]
    rng = np.random.default_rng(4)
    src = rng.random((h, w)).astype(np.float32)
    # Use a PASSABLE gate (threshold below 1) so both branches execute.
    p = SSAOParams.reference_default()
    import dataclasses
    p_open = dataclasses.replace(
        p, normal_threshold=jnp.float32(-2.0), depth_threshold=jnp.float32(0.05)
    )
    for params in (p, p_open):
        for direction in ((1.0, 0.0), (0.0, 1.0)):
            ours = np.asarray(
                post.blur_pass(
                    jnp.asarray(src), jnp.asarray(pos), jnp.asarray(nrm),
                    params, direction, h, w,
                )
            )
            gold = golden_post.blur_golden(
                src, pos, nrm, float(params.normal_threshold),
                float(params.depth_threshold), direction, h, w,
            )
            np.testing.assert_allclose(ours, gold, atol=2e-5)


def test_reference_blur_gate_is_identity():
    # With the shipped normalThreshold=2.47 no tap can pass the gate
    # (unit-normal dot <= 1), so the blur folds to ~source
    # (post_ssao_blur.glsl:30,46-65 — weights sum to 0.9998).
    pos, nrm = _rand_gbuffer(seed=5)
    h, w = pos.shape[:2]
    src = np.random.default_rng(6).random((h, w)).astype(np.float32)
    out = np.asarray(
        post.blur_pass(
            jnp.asarray(src), jnp.asarray(pos), jnp.asarray(nrm),
            SSAOParams.reference_default(), (1.0, 0.0), h, w,
        )
    )
    np.testing.assert_allclose(out, src * sum(post._BLUR_WEIGHT[i] for i in (0, 1, 1, 2, 2)), atol=1e-5)


def test_composite_matches_glsl_transcription():
    pos, _ = _rand_gbuffer(seed=7)
    h, w = pos.shape[:2]
    ao = np.random.default_rng(8).random((h, w)).astype(np.float32)
    cam = np.array([0.3, -0.2, 1.4], np.float32)
    ours = np.asarray(
        post.composite_pass(jnp.asarray(pos), jnp.asarray(ao), jnp.asarray(cam), h, w)
    )
    gold = golden_post.composite_golden(pos, ao, cam, h, w)
    np.testing.assert_allclose(ours, gold, atol=1e-5)
    # sky is black
    sky = np.linalg.norm(pos, axis=-1) == 0
    assert (ours[sky] == 0).all()


def test_full_pipeline_end_to_end():
    cfg = RenderConfig(width=256, height=128, max_depth=2)
    scene = default_scene()
    image, gb = render_frame(scene, cfg)
    img = np.asarray(image)
    assert img.shape == (128, 256, 3)
    assert np.isfinite(img).all()
    hit = np.asarray(gb.hit)
    # sky black, hits mostly lit
    assert np.abs(img[~hit]).max() == 0.0
    assert img[hit].mean() > 0.05
    # downscaled SSAO config also runs
    cfg2 = RenderConfig(width=256, height=128, max_depth=2, ssao_downscale=2)
    image2, _ = render_frame(scene, cfg2)
    assert np.isfinite(np.asarray(image2)).all()
