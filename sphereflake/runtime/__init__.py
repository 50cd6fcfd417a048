from sphereflake.runtime.progressive import (  # noqa: F401
    ProgressiveState,
    TileProgressiveState,
    progressive_init,
    progressive_prepare,
    progressive_prepare_trimmed,
    progressive_step,
    progressive_tiles_init,
    progressive_tiles_step,
    tile_progressive_composite,
    tile_progressive_gbuffer,
)
