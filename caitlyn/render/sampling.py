"""Deterministic, shard-invariant random number generation.

The reference uses a fragment-local fract-sin hash seeded per frame
(`/root/reference/Shader/path_trace.fs:38-42`) plus a CPU-side PCG for the
per-frame seed vector (the reference's `Caitlyn/Rnd.h:21-40`).  Here it is
the counter-based threefry generator: a key derived from
(frame/sample index, pixel id) gives every pixel-sample an independent
stream that is bitwise identical no matter how the pixel axis is sharded
across chips.

Uniform layout per pixel-sample (consumed identically by the CPU oracle in
`cpu_reference/integrator.py` and the device integrator in
`render/integrator.py`):

    [0:2]  tent-filter AA jitter pair
    [2:4]  thin-lens aperture pair
    then per bounce b: [4+7b : 11+7b] =
        light_pick, light_u1, light_u2, bsdf_u1, bsdf_u2, bsdf_lobe, rr
    (bsdf_lobe selects the Disney sampling lobe / the dielectric
     reflect-vs-refract branch; rr is the Russian-roulette survival draw,
     consumed only when RenderOptions.rr_start enables RR)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def uniforms_per_sample(max_depth: int) -> int:
    return 4 + 7 * max_depth


def draw_uniforms(key: jax.Array, num_pixels: int, max_depth: int) -> jax.Array:
    """Draw the full uniform block for one sample of every pixel.

    key: a threefry key already folded with the sample index
         (e.g. `jax.random.fold_in(base_key, sample_idx)`).
    Returns (num_pixels, 4 + 7*max_depth) float32 in [0, 1).
    """
    return jax.random.uniform(
        key, (num_pixels, uniforms_per_sample(max_depth)), jnp.float32
    )


def pixel_uniforms(key: jax.Array, pixel_ids, max_depth: int) -> jax.Array:
    """Per-pixel-keyed uniforms: stream i depends only on (key, pixel_id).

    This is the shard-invariant path: a pixel's random numbers are identical
    whether the pixel axis lives on 1 chip or is sharded over 64, because
    the key is folded with the *global* pixel id, not the lane position.
    Costs one threefry fold per pixel — counter-based RNG is exactly what
    makes this affordable (SURVEY.md §7 RNG design).

    pixel_ids: (N,) i32. Returns (N, 4 + 7*max_depth) f32 in [0, 1).
    """
    n_u = uniforms_per_sample(max_depth)

    def one(pid):
        return jax.random.uniform(jax.random.fold_in(key, pid), (n_u,), jnp.float32)

    return jax.vmap(one)(pixel_ids)


def sample_key(base_key: jax.Array, sample_idx) -> jax.Array:
    """Per-sample key: fold the progressive sample counter into the base key.

    Because pixels index into the drawn array by their *global* pixel id,
    renders are deterministic across 1-chip and N-chip shardings (tested in
    tests/test_parallel.py)."""
    return jax.random.fold_in(base_key, sample_idx)
