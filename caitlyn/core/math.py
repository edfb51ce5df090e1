"""Shared geometric math for the device (jnp) compute path.

Vectorized over leading batch axes; every function is jit/vmap/grad-safe.
Citations point at the GLSL the math is capability-matched to; the
implementations are written fresh for batched execution.
"""

from __future__ import annotations

import jax.numpy as jnp

INF = 1e9
EPS = 1e-4
RAY_OFFSET = 2e-4  # hit-point offset along the normal (path_trace.fs:930)


def dot(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def normalize(v, eps=1e-20):
    return v * jnp.reciprocal(jnp.sqrt(jnp.maximum(dot(v, v, True), eps)))


def norm(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def cross(a, b):
    return jnp.cross(a, b)


def onb(n):
    """Build an orthonormal basis (u, v) around unit normal n.

    Branchless form of the reference's singularity-guarded Frisvad basis
    (`path_trace.fs:44-60`): the n.z < -1+eps pole is handled with a where.
    n: (..., 3) → (u, v) each (..., 3).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    # Regular branch (safe denominator when nz > -1).
    a = 1.0 / jnp.maximum(1.0 + nz, 1e-7)
    b = -nx * ny * a
    u_reg = jnp.stack([1.0 - nx * nx * a, b, -nx], axis=-1)
    v_reg = jnp.stack([b, 1.0 - ny * ny * a, -ny], axis=-1)
    # Pole branch (n ≈ (0,0,-1)).
    pole = (nz < -0.9999999)[..., None]
    u_pole = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0], n.dtype), u_reg.shape)
    v_pole = jnp.broadcast_to(jnp.array([-1.0, 0.0, 0.0], n.dtype), v_reg.shape)
    return jnp.where(pole, u_pole, u_reg), jnp.where(pole, v_pole, v_reg)


def power_heuristic(a, b):
    """MIS power heuristic, β=2 (`path_trace.fs:214-218`)."""
    t = a * a
    return t / jnp.maximum(b * b + t, 1e-20)


def cosine_hemisphere_dir(u1, u2):
    """Cosine-weighted hemisphere sample in local (u, v, n) coordinates
    (`path_trace.fs:257-270`)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    return jnp.stack(
        [r * jnp.cos(phi), r * jnp.sin(phi), jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))],
        axis=-1,
    )


def local_to_world(local_dir, n):
    """Rotate a local-frame direction into the world frame around n."""
    u, v = onb(n)
    return (
        u * local_dir[..., 0:1] + v * local_dir[..., 1:2] + n * local_dir[..., 2:3]
    )


def tent_jitter(r1, r2):
    """Tent-filter antialiasing jitter in [-1, 1] pixels
    (`path_trace.fs:1030-1036`): r in [0,2), jitter = sqrt shaping."""
    jx = jnp.where(r1 < 1.0, jnp.sqrt(r1) - 1.0, 1.0 - jnp.sqrt(jnp.maximum(2.0 - r1, 0.0)))
    jy = jnp.where(r2 < 1.0, jnp.sqrt(r2) - 1.0, 1.0 - jnp.sqrt(jnp.maximum(2.0 - r2, 0.0)))
    return jx, jy


def reflect(d, n):
    """Mirror reflection of incident direction d about normal n."""
    return d - 2.0 * dot(d, n, True) * n


def refract(d, n, eta):
    """Snell refraction; returns (refracted_dir, total_internal_reflection).

    d: unit incident (pointing into surface), n: unit normal (against d),
    eta: n_i / n_t ratio.
    """
    cos_i = -dot(d, n, True)
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return jnp.where(tir, reflect(d, n), refr), tir[..., 0]


def fresnel_schlick(cos_theta, f0):
    """Schlick Fresnel approximation."""
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m ** 5)


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel. cos_i >= 0, eta = n_i/n_t."""
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    r_par = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-12)
    r_perp = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(sin2_t >= 1.0, jnp.ones_like(f), f)


def luminance(rgb):
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def interpolate(a, b, c, u, v):
    """Barycentric interpolation a*(1-u-v) + b*u + c*v
    (`path_trace.fs:312-320`)."""
    w = 1.0 - u - v
    return a * w[..., None] + b * u[..., None] + c * v[..., None]
