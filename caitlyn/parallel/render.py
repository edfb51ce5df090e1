"""Sharded rendering and inverse-rendering steps (`shard_map` over a Mesh).

Layouts (see parallel/mesh.py):
  * pixel axis sharded over 'dp' — each device traces its own pixel block;
  * sample streams over 'sp' — same pixels, independent RNG streams,
    combined with a `psum` over 'sp';
  * scene arrays replicated per device (BASELINE.json: "scene replicated
    per host");
  * gradients in the training step are `psum`-reduced over the whole mesh,
    overlapped with backward compute by XLA's latency-hiding scheduler.

Determinism: a pixel's uniforms depend only on (base_key, sample_idx,
global pixel id) — 1-chip and N-chip renders are bitwise comparable
(tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from caitlyn.core.camera import generate_rays_for_ids
from caitlyn.core.types import Camera, RenderOptions
from caitlyn.render import sampling
from caitlyn.render.integrator import trace_paths
from caitlyn.render.progressive import RenderState
from caitlyn.scene import DeviceScene


def padded_pixels(width: int, height: int, dp: int) -> int:
    n = width * height
    return ((n + dp - 1) // dp) * dp


def init_sharded_state(mesh: Mesh, width: int, height: int, seed: int = 0) -> RenderState:
    """Accumulation sharded over 'dp' (padded), counters/key replicated."""
    dp = mesh.shape["dp"]
    n_pad = padded_pixels(width, height, dp)
    accum = jnp.zeros((n_pad, 3), jnp.float32)
    accum = jax.device_put(accum, NamedSharding(mesh, P("dp", None)))
    return RenderState(
        accum=accum,
        frame_count=jnp.int32(0),
        base_key=jax.random.PRNGKey(seed),
    )


def _local_sample(ds, camera, key, pixel_ids, width, height, options):
    """Trace one sample for a local pixel block (runs inside shard_map)."""
    uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
    o, d = generate_rays_for_ids(camera, width, height, pixel_ids, uniforms)
    return trace_paths(ds, o, d, uniforms, options)


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "options"),
    donate_argnums=(2,),
)
def sharded_render_step(
    ds: DeviceScene,
    camera: Camera,
    state: RenderState,
    mesh: Mesh,
    width: int,
    height: int,
    options: RenderOptions,
) -> RenderState:
    """One progressive step on the mesh: every device traces its pixel
    block; the 'sp' axis contributes extra sample streams per step.

    Adds sp_size samples per pixel per call."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n_pad = state.accum.shape[0]
    block = n_pad // dp

    def body(accum_local):
        dp_idx = lax.axis_index("dp")
        sp_idx = lax.axis_index("sp")
        pixel_ids = dp_idx * block + jnp.arange(block, dtype=jnp.int32)
        sample_idx = state.frame_count * sp + sp_idx
        key = sampling.sample_key(state.base_key, sample_idx)
        radiance = _local_sample(ds, camera, key, pixel_ids, width, height, options)
        # combine the sp sample streams; result replicated over 'sp'
        radiance = lax.psum(radiance, "sp")
        return accum_local + radiance

    accum = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp", None),),
        out_specs=P("dp", None),
        check_vma=False,
    )(state.accum)
    return RenderState(
        accum=accum,
        frame_count=state.frame_count + 1,
        base_key=state.base_key,
    )


def resolve_accum(accum, frame_count, sp: int, width: int, height: int, options: RenderOptions):
    """Shared resolve for sharded accumulations: 1/(frames·sp) + tonemap +
    row flip.  Used by gather_image (single-process) and
    distributed.assemble_image (multi-host) — one resolve to maintain."""
    from caitlyn.render.progressive import tonemap

    n = width * height
    frames = jnp.maximum(jnp.float32(frame_count) * sp, 1.0)
    hdr = accum[:n] / frames * options.hdr_multiplier
    img = tonemap(hdr, options.tonemap_limit)
    return jnp.asarray(img).reshape(height, width, 3)[::-1]


def gather_image(state: RenderState, width: int, height: int, options: RenderOptions, sp: int):
    """Resolve the sharded accumulation to a host image (multi-host callers
    wrap this in `multihost_utils.process_allgather`)."""
    return resolve_accum(
        state.accum, state.frame_count, sp, width, height, options
    )


# ---------------------------------------------------------------------------
# Inverse-rendering training step (the framework's "training step" analog):
# differentiable render vs a target image, grads psum'd over the mesh.
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "options", "lr"),
)
def sharded_train_step(
    params,  # pytree: dict(albedo=(M,4), cam_position=(3,))
    ds: DeviceScene,
    camera: Camera,
    target,  # (n_pad, 3) sharded over 'dp'
    key,
    sample_idx,
    mesh: Mesh,
    width: int,
    height: int,
    options: RenderOptions,
    lr: float = 1e-2,
):
    """One SGD step of inverse rendering over the mesh.

    The loss is the global mean-squared error between a 1-spp render under
    `params` and the target; each device differentiates its local loss and
    `psum`s gradients over ('dp','sp') — the renderer's gradient
    all-reduce (BASELINE.json north star).  `params` takes any subset of
    grad.inverse.apply_params' keys (albedo, disney, emission, vertices,
    cam_position, cam_fov) — BASELINE config #5 optimizes Disney BSDF +
    camera parameters.  Returns (params', loss)."""
    from caitlyn.grad.inverse import apply_params

    dp = mesh.shape["dp"]
    n_pad = target.shape[0]
    block = n_pad // dp

    def body(target_local):
        dp_idx = lax.axis_index("dp")
        sp_idx = lax.axis_index("sp")
        pixel_ids = dp_idx * block + jnp.arange(block, dtype=jnp.int32)
        k = sampling.sample_key(jax.random.fold_in(key, sp_idx), sample_idx)

        def local_loss(p):
            ds2, cam2 = apply_params(ds, camera, p)
            radiance = _local_sample(ds2, cam2, k, pixel_ids, width, height, options)
            return jnp.sum((radiance - target_local) ** 2)

        loss, grads = jax.value_and_grad(local_loss)(params)
        loss = lax.psum(loss, ("dp", "sp"))
        grads = jax.tree_util.tree_map(lambda g: lax.psum(g, ("dp", "sp")), grads)
        denom = n_pad * mesh.shape["sp"]
        # RMS-normalized step per leaf: heterogeneous parameter groups
        # (BSDF roughness in [0,1] next to camera position in scene
        # units) get comparable step sizes — lr is "param units moved
        # per step", robust where a single raw-gradient scale stalls.
        new_params = jax.tree_util.tree_map(
            lambda p, g: p
            - lr * g / (jnp.sqrt(jnp.mean(g * g)) + 1e-12),
            params,
            grads,
        )
        return new_params, loss / denom

    new_params, loss = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp", None),),
        out_specs=(P(), P()),
        check_vma=False,
    )(target)
    return new_params, loss


# ---------------------------------------------------------------------------
# Tile-parallel rendering: the tile GRID sharded across chips.
#
# The reference's Renderer_Tiled mode is dead surface (enum + tile-count
# options exist, `Scene.h:42,52-53,65-66`; `Render()` implements only the
# progressive path).  Here tiles are real AND distributed: the image is cut
# into (tiles_x × tiles_y) square tiles, each device owns a contiguous run
# of tiles (spatially compact pixel sets — better ray coherence per chip
# than row-block sharding), and the accumulation lives tile-major on the
# mesh.  Determinism: pixels keep their GLOBAL ids for RNG keying, so a
# tiled+sharded render is BITWISE equal to the untiled single-device one
# (asserted in tests/test_distributed.py).
# ---------------------------------------------------------------------------


def tile_pixel_order(width: int, height: int, tiles_x: int, tiles_y: int, dp: int):
    """Host precompute: pixel ids in tile-major order, padded to dp.

    Returns (order, n_pad): order[slot] = global pixel id rendered at that
    accumulation slot (-1 padding at the tail renders a dummy pixel 0 that
    the gather discards)."""
    import numpy as np

    tw = -(-width // tiles_x)
    th = -(-height // tiles_y)
    ids = []
    for tyi in range(tiles_y):
        for txi in range(tiles_x):
            ys = np.arange(tyi * th, min((tyi + 1) * th, height))
            xs = np.arange(txi * tw, min((txi + 1) * tw, width))
            ids.append((ys[:, None] * width + xs[None, :]).ravel())
    order = np.concatenate(ids).astype(np.int32)
    n_pad = ((order.size + dp - 1) // dp) * dp
    order = np.concatenate(
        [order, np.full(n_pad - order.size, -1, np.int32)]
    )
    return order, n_pad


def init_tiled_state(mesh: Mesh, order) -> Tuple[jax.Array, jax.Array]:
    dp = mesh.shape["dp"]
    sh = NamedSharding(mesh, P("dp", None))
    accum = jax.device_put(
        jnp.zeros((order.shape[0], 3), jnp.float32), sh
    )
    order_dev = jax.device_put(
        jnp.asarray(order)[:, None], sh
    )
    return accum, order_dev


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "options"),
    donate_argnums=(2,),
)
def sharded_render_step_tiled(
    ds: DeviceScene,
    camera: Camera,
    accum,  # (n_pad, 3) tile-major, sharded over dp
    order,  # (n_pad, 1) i32 global pixel id per slot, sharded over dp
    frame_count,
    base_key,
    mesh: Mesh,
    width: int,
    height: int,
    options: RenderOptions,
):
    """One sample of every tile, tiles sharded over 'dp', sample streams
    over 'sp' (psum) — the distributed tile renderer."""
    sp = mesh.shape["sp"]

    def body(accum_local, order_local):
        sp_idx = lax.axis_index("sp")
        pixel_ids = jnp.maximum(order_local[:, 0], 0)  # pad slots render px 0
        sample_idx = frame_count * sp + sp_idx
        key = sampling.sample_key(base_key, sample_idx)
        radiance = _local_sample(ds, camera, key, pixel_ids, width, height, options)
        radiance = lax.psum(radiance, "sp")
        return accum_local + radiance

    accum = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
        check_vma=False,
    )(accum, order)
    return accum


def gather_image_tiled(accum, order, frame_count, sp: int, width: int, height: int, options: RenderOptions):
    """Scatter the tile-major accumulation back to pixel order, resolve."""
    n = width * height
    pix = jnp.zeros((n, 3), jnp.float32)
    slots = jnp.asarray(order).reshape(-1)
    keep = slots >= 0
    pix = pix.at[jnp.where(keep, slots, n - 1)].add(
        jnp.where(keep[:, None], accum, 0.0)
    )
    return resolve_accum(pix, frame_count, sp, width, height, options)
