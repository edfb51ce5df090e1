"""Progressive rendering loop: accumulation state + resolve.

The reference's progressive scheme is three GL passes per frame —
path-trace (adds to previous accumulation), accumulate copy, and a
1/N + tonemap resolve (`/root/reference/Caitlyn/Scene.h:1158-1231`),
with the accumulation cleared when the camera moves (`Scene.h:1160-1177`).

Here the whole frame is ONE jitted step: `state' = step(state)` where the
state is an explicit pytree (accumulation buffer + sample counter + RNG
key).  Functional state makes the reference's texture-feedback hazard
(`Scene.h:1188-1230`, see SURVEY.md §5 race notes) structurally impossible,
and doubles as the checkpoint format for preemption-safe resume.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from caitlyn.core import math as cm
from caitlyn.core.types import Camera, RenderOptions
from caitlyn.render import sampling
from caitlyn.render.integrator import render_sample
from caitlyn.scene import DeviceScene


class RenderState(NamedTuple):
    """Progressive accumulation state — the checkpointable render pytree.

    accum:       (H*W, 3) f32 — sum of per-sample radiance
    frame_count: ()  i32 — samples accumulated so far
    base_key:    threefry key for the whole render (per-sample keys are
                 folded from it; restarting from a checkpoint continues the
                 exact same sample sequence)
    """

    accum: jax.Array
    frame_count: jax.Array
    base_key: jax.Array


def init_state(width: int, height: int, seed: int = 0) -> RenderState:
    return RenderState(
        accum=jnp.zeros((width * height, 3), jnp.float32),
        frame_count=jnp.int32(0),
        base_key=jax.random.PRNGKey(seed),
    )


def reset(state: RenderState) -> RenderState:
    """Camera moved → clear accumulation (Scene.h:1160-1177)."""
    return state._replace(
        accum=jnp.zeros_like(state.accum), frame_count=jnp.int32(0)
    )


@partial(jax.jit, static_argnames=("width", "height", "options"), donate_argnums=(2,))
def render_step(
    ds: DeviceScene,
    camera: Camera,
    state: RenderState,
    width: int,
    height: int,
    options: RenderOptions,
) -> RenderState:
    """Add one sample per pixel to the accumulation (the per-frame hot path;
    the accumulation buffer is donated so XLA updates it in place)."""
    key = sampling.sample_key(state.base_key, state.frame_count)
    # Per-pixel-id keyed uniforms: identical to the sharded path, so a
    # 1-chip progressive render is bitwise comparable to an N-chip one.
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
    radiance = render_sample(ds, camera, uniforms, width, height, options)
    return RenderState(
        accum=state.accum + radiance,
        frame_count=state.frame_count + 1,
        base_key=state.base_key,
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "options", "spp"),
    donate_argnums=(2,),
)
def render_steps(
    ds: DeviceScene,
    camera: Camera,
    state: RenderState,
    width: int,
    height: int,
    options: RenderOptions,
    spp: int,
) -> RenderState:
    """Accumulate `spp` samples in ONE device launch (`lax.scan` over the
    sample axis).  Bitwise-identical to `spp` successive `render_step`
    calls — the per-sample key still comes from `frame_count` — but the
    host dispatches once per chunk instead of once per sample.  The
    reference has no analog (GL draws are host-paced per frame,
    `Scene.h:1158-1231`)."""
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)

    def body(st, _):
        key = sampling.sample_key(st.base_key, st.frame_count)
        uniforms = sampling.pixel_uniforms(key, pixel_ids, options.max_depth)
        radiance = render_sample(ds, camera, uniforms, width, height, options)
        return (
            RenderState(
                accum=st.accum + radiance,
                frame_count=st.frame_count + 1,
                base_key=st.base_key,
            ),
            None,
        )

    state, _ = jax.lax.scan(body, state, None, length=spp)
    return state


def tonemap(rgb, limit: float = 2.0):
    """Reference resolve (`/root/reference/Shader/output.fs:9-20`):
    luminance-limited Reinhard (lum = .3r+.6g+.1b) then gamma 1/2.2."""
    lum = 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]
    c = rgb / (1.0 + lum / limit)[..., None]
    return jnp.clip(c, 0.0, 1.0) ** (1.0 / 2.2)


@partial(jax.jit, static_argnames=("width", "height", "options"))
def resolve(
    state: RenderState, width: int, height: int, options: RenderOptions
):
    """Resolve accumulation → display image (H, W, 3) in [0,1].

    Row 0 = top of image (the GL-convention bottom-up buffer is flipped).
    AOV modes resolve linearly (no tonemap/gamma — they are data views,
    like the reference's debug integrator, `path_trace.fs:822-840`);
    "depth" is normalized by the maximum finite depth in frame."""
    inv = 1.0 / jnp.maximum(state.frame_count.astype(jnp.float32), 1.0)
    hdr = state.accum * inv * options.hdr_multiplier
    if options.aov == "depth":
        img = jnp.clip(hdr / jnp.maximum(hdr.max(), 1e-8), 0.0, 1.0)
    elif options.aov != "beauty":
        img = jnp.clip(hdr, 0.0, 1.0)
    else:
        img = tonemap(hdr, options.tonemap_limit)
    return img.reshape(height, width, 3)[::-1]


def render_image(
    ds: DeviceScene,
    camera: Camera,
    options: RenderOptions,
    spp: int = 16,
    seed: int = 0,
    spp_per_launch: int = 8,
):
    """Convenience loop: accumulate `spp` samples and resolve.  Samples
    are batched `spp_per_launch` per device launch (render_steps); the
    remainder runs through single-sample steps so any spp is exact."""
    state = init_state(options.width, options.height, seed)
    w, h = options.width, options.height
    chunk = max(1, min(spp_per_launch, spp))
    for _ in range(spp // chunk):
        state = render_steps(ds, camera, state, w, h, options, chunk)
    for _ in range(spp % chunk):
        state = render_step(ds, camera, state, w, h, options)
    return resolve(state, options.width, options.height, options), state
