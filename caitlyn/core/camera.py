"""Camera ray generation (device side, differentiable).

Capability-matched to the reference's fragment-shader ray-gen
(`/root/reference/Shader/path_trace.fs:1026-1047`): tent-filter AA jitter,
vertical fov, aspect-corrected NDC. Additionally implements real thin-lens
depth of field (the reference declares `focalDist`/`aperture`,
`Camera.h:16-17`, but never uses them).
"""

from __future__ import annotations

import jax.numpy as jnp

from caitlyn.core import math as cm
from caitlyn.core.types import Camera


def generate_rays(camera: Camera, width: int, height: int, uniforms):
    """Generate one primary ray per pixel (all H*W pixels in row-major
    order).  See `generate_rays_for_ids` for the sharded-block variant."""
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    return generate_rays_for_ids(camera, width, height, pixel_ids, uniforms)


def generate_rays_for_ids(camera: Camera, width: int, height: int, pixel_ids, uniforms):
    """Generate one primary ray per given global pixel id.

    pixel_ids: (N,) i32 — global id = y*width + x; ids may exceed the image
    (padding lanes) and simply produce throwaway rays.
    uniforms: (N, >=4) in [0,1): tent-jitter pair + lens pair.
    Returns (origins, directions), each (N, 3) f32.

    Pixel (0,0) is the bottom-left of the image (GL convention, matching the
    reference's gl_FragCoord-based `tex` interpolation); callers that want
    top-left row-0 images flip at resolve time.
    """
    xx = (pixel_ids % width).astype(jnp.float32)
    yy = (pixel_ids // width).astype(jnp.float32)
    # Fragment center in [0,1]² (tex coordinate of the fullscreen quad).
    u = (xx + 0.5) / width
    v = (yy + 0.5) / height

    r1 = 2.0 * uniforms[:, 0]
    r2 = 2.0 * uniforms[:, 1]
    jx, jy = cm.tent_jitter(r1, r2)
    # jitter is in units of half-pixels of the [-1,1] NDC (path_trace.fs:1037)
    jx = jx / (width * 0.5)
    jy = jy / (height * 0.5)

    dx = (2.0 * u - 1.0) + jx
    dy = (2.0 * v - 1.0) + jy

    tan_fov = jnp.tan(camera.fov * 0.5)
    aspect = width / height
    dx = dx * aspect * tan_fov
    dy = dy * tan_fov

    directions = cm.normalize(
        dx[:, None] * camera.right[None, :]
        + dy[:, None] * camera.up[None, :]
        + camera.forward[None, :]
    )
    origins = jnp.broadcast_to(camera.position[None, :], directions.shape)

    # Thin-lens DoF: jitter origin on the aperture disk, refocus through the
    # focal plane. aperture == 0 reduces exactly to the pinhole above.
    lens_r = jnp.sqrt(uniforms[:, 2]) * (camera.aperture * 0.5)
    lens_phi = 2.0 * jnp.pi * uniforms[:, 3]
    lens_x = lens_r * jnp.cos(lens_phi)
    lens_y = lens_r * jnp.sin(lens_phi)
    focus_t = camera.focal_dist / jnp.maximum(
        cm.dot(directions, camera.forward[None, :]), 1e-6
    )
    focus_point = origins + directions * focus_t[:, None]
    lens_offset = (
        lens_x[:, None] * camera.right[None, :]
        + lens_y[:, None] * camera.up[None, :]
    )
    use_dof = camera.aperture > 0.0
    origins = jnp.where(use_dof, origins + lens_offset, origins)
    directions = jnp.where(
        use_dof, cm.normalize(focus_point - origins), directions
    )
    return origins, directions
