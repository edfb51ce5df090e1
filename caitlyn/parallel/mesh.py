"""Device mesh construction for sharded rendering.

The reference is single-GPU (SURVEY.md §2 parallelism table) — its only
parallel axis is the rasterizer's per-fragment SIMT.  Here two mesh axes:

  dp ("data parallel")   : the pixel/ray batch axis, sharded across chips
  sp ("sample parallel") : independent sample streams of the *same* pixels,
                           psum-combined — the renderer's honest analog of
                           DP+SP in a trainer (SURVEY.md §5 long-context note)

Scene arrays are replicated (small next to ray state); gradients are
psum-reduced over both axes.  A mesh is a plain reshape of the device list:
the cards of a host are joined all to all, so no axis order is faster.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into (dp, sp): sample-parallel gets a factor of 2
    when available, the rest shards pixels.  Each device then covers twice
    the pixels of a dp-only split per step, which halves the cost spread
    between image blocks, for one (pixels/dp, 3) psum per step."""
    if n % 2 == 0 and n > 1:
        return n // 2, 2
    return n, 1


def make_mesh(
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("dp", "sp"),
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = factor_mesh(n)
    assert shape[0] * shape[1] == n, (shape, n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)
