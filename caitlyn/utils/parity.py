"""Parity checks between ray-query implementations, shared by the tests
(on the CPU: the XLA traversal against the dense sweep) and by
`chip_smoke.py` (on the card: the CUDA kernel against both).

Tolerances.  All render-path arithmetic is elementwise fp32 — there is no
matrix product, so TF32 never enters — and two implementations differ only
by multiply-add contraction and evaluation order:

* closest hit: the same triangle on every ray, except where the two
  triangles' distances differ by less than TIE_RTOL relative (a tie either
  side may break either way); such ties may be at most MAX_TIE_SHARE of the
  rays; t agrees to T_RTOL relative;
* any hit: exactly equal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TIE_RTOL = 1e-6
MAX_TIE_SHARE = 1e-4
T_RTOL = 1e-5


def triangle_t(o, d, tri, verts, tri_v) -> np.ndarray:
    """Ray distance to the plane hit of triangle `tri` (float64, host),
    NaN where tri < 0."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    tri = np.asarray(tri)
    tv = np.asarray(tri_v)[np.maximum(tri, 0), :3]
    v = np.asarray(verts, np.float64)
    v0, v1, v2 = v[tv[:, 0]], v[tv[:, 1]], v[tv[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    pv = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, pv)
    qv = np.cross(o - v0, e1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.einsum("ij,ij->i", e2, qv) / det
    return np.where(tri >= 0, t, np.nan)


def compare_closest(ref, got, o, d, verts, tri_v) -> Dict[str, float]:
    """Compare two closest-hit results (t, tri, ...) on the same rays.

    Returns counts: rays, hits (reference), tri_mismatch, ties (mismatches
    whose two triangles lie within TIE_RTOL), non_tie (every other
    mismatch, hit/miss disagreements included) and t_max_rel (largest
    relative t difference on rays where both agree on the triangle or
    tie)."""
    t_r, tri_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_g, tri_g = np.asarray(got[0]), np.asarray(got[1])
    mism = tri_r != tri_g
    both_hit = (tri_r >= 0) & (tri_g >= 0)
    idx = np.nonzero(mism & both_hit)[0]
    ta = triangle_t(np.asarray(o)[idx], np.asarray(d)[idx], tri_r[idx], verts, tri_v)
    tb = triangle_t(np.asarray(o)[idx], np.asarray(d)[idx], tri_g[idx], verts, tri_v)
    tie_rows = np.abs(ta - tb) <= TIE_RTOL * np.maximum(np.abs(ta), np.abs(tb))
    ties = int(tie_rows.sum())
    agree = both_hit & ~mism
    agree[idx[tie_rows]] = True
    rel = np.abs(t_g[agree] - t_r[agree]) / np.maximum(np.abs(t_r[agree]), 1e-30)
    return {
        "rays": int(tri_r.size),
        "hits": int((tri_r >= 0).sum()),
        "tri_mismatch": int(mism.sum()),
        "ties": ties,
        "non_tie": int(mism.sum()) - ties,
        "t_max_rel": float(rel.max()) if rel.size else 0.0,
    }


def closest_ok(report: Dict[str, float]) -> bool:
    return (
        report["non_tie"] == 0
        and report["ties"] <= MAX_TIE_SHARE * report["rays"]
        and report["t_max_rel"] <= T_RTOL
    )


def compare_anyhit(ref, got) -> Dict[str, int]:
    ref = np.asarray(ref, bool)
    got = np.asarray(got, bool)
    return {
        "rays": int(ref.size),
        "occluded": int(ref.sum()),
        "mismatch": int((ref != got).sum()),
    }


def anyhit_ok(report: Dict[str, int]) -> bool:
    return report["mismatch"] == 0


def parity_rays(verts, tri_v, camera, width: int, height: int, closest, seed: int = 0):
    """A width×height frame's primary rays plus one bounce ray per pixel,
    as host float32 (o, d) of 2·width·height rays.

    The bounce rays are what the integrator traces next: each starts at
    its primary hit (found by `closest(o, d) -> (t, tri, ...)` on the scene
    `verts`, `tri_v`), offset along the face normal toward the incoming
    side by the integrator's RAY_OFFSET, in a uniformly random direction of
    that hemisphere.  A primary miss gets a random direction from its own
    origin."""
    import jax.numpy as jnp

    from caitlyn.core.math import RAY_OFFSET
    from caitlyn.cpu_reference import integrator as oracle

    n = width * height
    rng = np.random.default_rng(seed)
    uni = rng.random((n, oracle.uniforms_per_sample(1)), np.float32)
    o_p, d_p = oracle.generate_rays(camera, width, height, uni)
    o_p = np.asarray(o_p, np.float32)
    d_p = np.asarray(d_p, np.float32)
    t, tri = (np.asarray(x) for x in closest(jnp.asarray(o_p), jnp.asarray(d_p))[:2])
    hit = tri >= 0
    v = np.asarray(verts, np.float32)
    tv = np.asarray(tri_v)[np.maximum(tri, 0), :3]
    nrm = np.cross(v[tv[:, 1]] - v[tv[:, 0]], v[tv[:, 2]] - v[tv[:, 0]])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    nrm = np.where((np.einsum("ij,ij->i", nrm, d_p) > 0)[:, None], -nrm, nrm)
    d_b = rng.standard_normal((n, 3)).astype(np.float32)
    d_b /= np.linalg.norm(d_b, axis=1, keepdims=True)
    flip = hit & (np.einsum("ij,ij->i", d_b, nrm) < 0)
    d_b[flip] = -d_b[flip]
    o_b = np.where(hit[:, None], o_p + d_p * np.where(hit, t, 0)[:, None]
                   + nrm * RAY_OFFSET, o_p).astype(np.float32)
    return np.concatenate([o_p, o_b]), np.concatenate([d_p, d_b])
