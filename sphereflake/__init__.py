"""sphereflake — a differentiable sphereflake renderer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
AlexanderDzhoganov/sphereflake-raytracer (C++/AVX/OpenGL):

- the reference's SIMD ray packets (SIMD_AVX.h) become 1024-ray screen tiles,
- its recursive fractal traversal (Sphereflake.h:86-226) becomes a levelwise
  walk of the whole frame, binned to screen tiles and traced by one GPU
  kernel (Pallas through Triton),
- its worker-thread screen sharding (Sphereflake.cpp:67-74) becomes a
  2D device mesh with shard_map over screen tiles,
- its GLSL SSAO/blur/composite passes become fused, differentiable jnp ops,
- its frameless Sobol accumulation becomes progressive sample-batch steps.

Everything is a pure function of parameters: `params -> image`, jittable,
differentiable w.r.t. camera pose, fractal parameters and SSAO constants,
and shardable over a device mesh.
"""

__version__ = "0.1.0"

from sphereflake.config import (  # noqa: F401
    CameraParams,
    FractalParams,
    RenderConfig,
    SSAOParams,
    SceneParams,
    default_scene,
)
