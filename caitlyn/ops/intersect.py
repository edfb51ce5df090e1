"""Ray-primitive intersection ops (device, jnp — vectorized over rays).

Möller–Trumbore with the reference's acceptance rule
(`/root/reference/Shader/path_trace.fs:322-412`): accept iff
u >= 0, v >= 0, t >= 0, 1-u-v >= 0 and t < t_best.  All functions are
batched over rays and (where applicable) over a triangle axis, so the
arithmetic runs as dense vectorized ops rather than the reference's
per-fragment scalar loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from caitlyn.core import math as cm

INF = cm.INF


def moller_trumbore(o, d, v0, e1, e2, t_best):
    """Batched single-triangle test.

    o, d:        (..., 3) ray origin/direction
    v0, e1, e2:  (..., 3) triangle vertex + edge vectors (v1-v0, v2-v0)
    t_best:      (...,)   current closest t
    Returns (hit, t, u, v): hit mask plus the candidate uvt.
    """
    pv = jnp.cross(d, e2)
    det = cm.dot(e1, pv)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    tv = o - v0
    qv = jnp.cross(tv, e1)
    u = cm.dot(tv, pv) * inv_det
    v = cm.dot(d, qv) * inv_det
    t = cm.dot(e2, qv) * inv_det
    w = 1.0 - u - v
    hit = (u >= 0) & (v >= 0) & (w >= 0) & (t >= 0) & (t < t_best)
    return hit, t, u, v


def intersect_leaf_triangles(o, d, tri_idx, valid, verts, tri_v, best):
    """Test a small fixed block of triangles per ray against current best.

    o, d:     (N, 3)
    tri_idx:  (N, K) triangle ids (gathered from a leaf's contiguous range)
    valid:    (N, K) mask (idx within leaf range and lane active)
    verts:    (V, 3), tri_v: (T, 4)
    best:     dict(t=(N,), tri=(N,), u=(N,), v=(N,)) — updated functionally.
    """
    idx = jnp.clip(tri_idx, 0, tri_v.shape[0] - 1)
    vid = tri_v[idx]  # (N, K, 4)
    v0 = verts[vid[..., 0]]
    e1 = verts[vid[..., 1]] - v0
    e2 = verts[vid[..., 2]] - v0
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    hit, t, u, v = moller_trumbore(o_b, d_b, v0, e1, e2, best["t"][:, None])
    hit = hit & valid
    # Reduce over the K candidates: pick the minimum accepted t.
    t_cand = jnp.where(hit, t, INF)
    k_best = jnp.argmin(t_cand, axis=1)
    n_idx = jnp.arange(o.shape[0])
    t_new = t_cand[n_idx, k_best]
    improved = t_new < best["t"]
    return {
        "t": jnp.where(improved, t_new, best["t"]),
        "tri": jnp.where(improved, tri_idx[n_idx, k_best], best["tri"]),
        "u": jnp.where(improved, u[n_idx, k_best], best["u"]),
        "v": jnp.where(improved, v[n_idx, k_best], best["v"]),
    }


def intersect_brute(o, d, verts, tri_v, t_max=INF):
    """Closest-hit by brute force over all triangles (`--accel brute` and
    the traversal oracle in tests).

    o, d: (N, 3); verts: (V, 3); tri_v: (T, 4).
    Returns (t, tri, u, v) with tri = -1 on miss.
    """
    v0 = verts[tri_v[:, 0]]
    e1 = verts[tri_v[:, 1]] - v0
    e2 = verts[tri_v[:, 2]] - v0
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    hit, t, u, v = moller_trumbore(
        o_b, d_b, v0[None], e1[None], e2[None], jnp.full_like(o[:, :1], t_max)
    )
    t_cand = jnp.where(hit, t, INF)
    tri = jnp.argmin(t_cand, axis=1)
    n_idx = jnp.arange(o.shape[0])
    t_best = t_cand[n_idx, tri]
    miss = t_best >= INF
    return (
        t_best,
        jnp.where(miss, -1, tri).astype(jnp.int32),
        u[n_idx, tri],
        v[n_idx, tri],
    )


def occluded_brute(o, d, t_max, verts, tri_v):
    """Any-hit by brute force. o, d: (N, 3); t_max: (N,)."""
    v0 = verts[tri_v[:, 0]]
    e1 = verts[tri_v[:, 1]] - v0
    e2 = verts[tri_v[:, 2]] - v0
    hit, _, _, _ = moller_trumbore(
        o[:, None, :], d[:, None, :], v0[None], e1[None], e2[None], t_max[:, None]
    )
    return hit.any(axis=1)


def refine_hit_tri(o, d, v0, e1, e2):
    """Differentiable Möller–Trumbore (t, u, v) given per-ray triangle data
    (v0, e1, e2 already gathered — e.g. from the fused shading table)."""
    pv = jnp.cross(d, e2)
    det = cm.dot(e1, pv)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    tv = o - v0
    qv = jnp.cross(tv, e1)
    u = cm.dot(tv, pv) * inv_det
    v = cm.dot(d, qv) * inv_det
    t = cm.dot(e2, qv) * inv_det
    return t, u, v


def refine_hit(o, d, tri, verts, tri_v):
    """Differentiably recompute (t, u, v) for a known hit triangle.

    Traversal returns hit ids through non-differentiable control flow
    (`lax.while_loop` has no reverse rule); the standard detached-traversal
    estimator recomputes the intersection from the gathered triangle so
    gradients flow to vertices and ray origins/directions (SURVEY.md §7).
    tri: (N,) i32 (>= 0 where valid; clamped gather elsewhere).
    """
    idx = jnp.maximum(tri, 0)
    vid = tri_v[idx]
    v0 = verts[vid[:, 0]]
    e1 = verts[vid[:, 1]] - v0
    e2 = verts[vid[:, 2]] - v0
    pv = jnp.cross(d, e2)
    det = cm.dot(e1, pv)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    tv = o - v0
    qv = jnp.cross(tv, e1)
    u = cm.dot(tv, pv) * inv_det
    v = cm.dot(d, qv) * inv_det
    t = cm.dot(e2, qv) * inv_det
    return t, u, v


def slab_test(o, d_inv, bmin, bmax):
    """Slab AABB test (`path_trace.fs:84-109`): returns (t_near, t_far).

    Hit iff t_far >= max(t_near, 0) — callers apply their own comparison
    (the reference uses th > 0 && th >= tl && tl < t_best,
    `path_trace.fs:562-563`).
    o, d_inv: (..., 3); bmin/bmax: (..., 3).
    """
    t0 = (bmin - o) * d_inv
    t1 = (bmax - o) * d_inv
    tsmall = jnp.minimum(t0, t1)
    tbig = jnp.maximum(t0, t1)
    t_near = jnp.max(tsmall, axis=-1)
    t_far = jnp.min(tbig, axis=-1)
    return t_near, t_far
