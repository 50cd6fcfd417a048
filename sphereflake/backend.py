"""The one place that decides how this process runs the trace kernel,
and where its compiled programs are cached.

`kernel_route` is asked by the algorithm choice (`default_algorithm`)
and by the trace kernel's wrapper (`ops.binned.trace_pairs`); no other
module branches on the platform.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# Fixed, so that the cache key (which includes the path) stays stable
# across runs; listed in .gitignore.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def kernel_route(platform: str | None = None) -> str:
    """How the Pallas trace kernel runs on `platform` (default: JAX's
    default backend): ``"triton"`` — compiled through Triton — on an
    NVIDIA GPU, ``"interpret"`` on the CPU, which exists for the tests.
    Any other platform is an error: the kernel has no route there."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"no trace-kernel route for platform {platform!r}: the kernel "
        "runs compiled on an NVIDIA GPU or interpreted on the CPU"
    )


def default_algorithm(platform: str | None = None) -> str:
    """The algorithm ``--algorithm auto`` resolves to: the binned path
    where its kernel runs compiled, the plain-XLA ``fast`` path on the
    CPU (where the kernel would only be interpreted)."""
    return "binned" if kernel_route(platform) == "triton" else "fast"


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its
    directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it and nothing else is set here; otherwise the cache lives in
    `CACHE_DIR` inside the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(CACHE_DIR)
