"""Tiled rendering — the mode the reference declares but never implements.

`RenderOptions` in the reference carries `Renderer_Tiled` and numTilesX/Y
(`/root/reference/Caitlyn/Scene.h:42,52-53,65-66`) but `Render()` only
implements the progressive path (`Scene.h:1158-1231`, SURVEY.md §2 row
"Tile parallel").  Here tiles are first-class: the image is cut into a
tile grid, each tile rendered as its own (smaller) ray batch — bounding
device memory for resolutions whose full ray state wouldn't fit, and
giving the scheduler natural work units for multi-chip distribution
(parallel/render.py shards the pixel axis instead when the whole frame
fits).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caitlyn.core.camera import generate_rays_for_ids
from caitlyn.core.types import Camera, RenderOptions
from caitlyn.render import sampling
from caitlyn.render.integrator import trace_paths
from caitlyn.render.progressive import tonemap
from caitlyn.scene import DeviceScene
from functools import partial


class Tile(NamedTuple):
    x0: int
    y0: int
    w: int
    h: int


def tile_grid(width: int, height: int, tiles_x: int, tiles_y: int) -> Iterator[Tile]:
    """Uniform tile grid (last row/column absorb the remainder)."""
    bw = width // tiles_x
    bh = height // tiles_y
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            w = bw if tx < tiles_x - 1 else width - bw * (tiles_x - 1)
            h = bh if ty < tiles_y - 1 else height - bh * (tiles_y - 1)
            yield Tile(tx * bw, ty * bh, w, h)


@partial(
    jax.jit,
    static_argnames=("width", "height", "tile_w", "tile_h", "options"),
)
def render_tile(
    ds: DeviceScene,
    camera: Camera,
    key,
    tile_x0,
    tile_y0,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    options: RenderOptions,
):
    """One sample of one tile: (tile_h*tile_w, 3) radiance.

    Uniform numbers are keyed by *global* pixel id, so a tiled render of a
    frame equals the untiled render of the same sample exactly."""
    yy, xx = jnp.meshgrid(
        jnp.arange(tile_h, dtype=jnp.int32),
        jnp.arange(tile_w, dtype=jnp.int32),
        indexing="ij",
    )
    pixel_ids = (tile_y0 + yy.reshape(-1)) * width + (tile_x0 + xx.reshape(-1))
    uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
    o, d = generate_rays_for_ids(camera, width, height, pixel_ids, uniforms)
    return trace_paths(ds, o, d, uniforms, options)


def render_image_tiled(
    ds: DeviceScene,
    camera: Camera,
    options: RenderOptions,
    spp: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """Render the full frame tile by tile; returns the resolved (H, W, 3)
    display image.  Tiles come from options.num_tiles_x/y."""
    width, height = options.width, options.height
    accum = np.zeros((height, width, 3), np.float32)
    base_key = jax.random.PRNGKey(seed)
    tiles = list(tile_grid(width, height, options.num_tiles_x, options.num_tiles_y))
    for s in range(spp):
        key = sampling.sample_key(base_key, s)
        for t in tiles:
            radiance = render_tile(
                ds, camera, key, t.x0, t.y0, width, height, t.w, t.h, options
            )
            accum[t.y0 : t.y0 + t.h, t.x0 : t.x0 + t.w] += np.asarray(
                radiance
            ).reshape(t.h, t.w, 3)
    hdr = accum / spp * options.hdr_multiplier
    img = np.asarray(tonemap(jnp.asarray(hdr), options.tonemap_limit))
    return img[::-1]
