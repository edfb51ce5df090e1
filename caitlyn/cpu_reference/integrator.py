"""CPU reference path tracer (pure NumPy, brute-force intersection).

This is the test oracle for the whole framework: an independent, obviously
correct implementation of the integrator math that the device (JAX)
renderer must match allclose when fed the *same* uniform random numbers.

The integrator is capability-matched to the reference GLSL megakernel
(`/root/reference/Shader/path_trace.fs:857-1024`): N-bounce unidirectional
path tracing, Lambert BSDF with cosine sampling, next-event estimation with
uniform area-light sampling, MIS power heuristic on both strategies, and
perfect-specular mirror/glass lobes.  Documented deviations (all corrections,
see io/obj.py docstring too):

* NEE uses the physically correct estimator  T * Le * (albedo/pi) * cos_i *
  w_mis / pdf_light  — the reference omits the cos_i/pi factor
  (`path_trace.fs:988-998`).  Set `exact_reference_nee=True` to reproduce
  the reference estimator exactly.
* Light-selection pdf is 1/num_lights to match the uniform light pick
  (`path_trace.fs:940`); the reference inconsistently mixes the uniform pick
  with an area-weighted pdf (`path_trace.fs:986`).
* The shading normal is flipped toward the incoming ray and used for both
  hemisphere sampling and the NEE cosine (the reference keeps an unflipped
  `original_n` for the NEE cosine, `path_trace.fs:874-877,952`).

Random-number layout per pixel-sample (shared with the device integrator,
see `render/sampling.py`): [jitter_x, jitter_y, lens_u, lens_v] then per
bounce [light_pick, light_u1, light_u2, bsdf_u1, bsdf_u2].
"""

from __future__ import annotations

import numpy as np

from caitlyn.core.types import (
    Camera,
    MaterialType,
    SceneArrays,
    SPECULAR_TYPES,
)
from caitlyn.cpu_reference import bsdf as disney

INF = 1e9
EPS = 1e-4
RAY_OFFSET = 2e-4
_SPECULAR_IDS = np.array([int(t) for t in SPECULAR_TYPES], np.int32)


def uniforms_per_sample(max_depth: int) -> int:
    return 4 + 7 * max_depth


def _normalize(v, axis=-1):
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-20)


def generate_rays(camera: Camera, width: int, height: int, uniforms: np.ndarray):
    """NumPy twin of `core/camera.py:generate_rays` (pinhole + tent jitter)."""
    yy, xx = np.meshgrid(
        np.arange(height, dtype=np.float32),
        np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    u = (xx.reshape(-1) + 0.5) / width
    v = (yy.reshape(-1) + 0.5) / height
    r1 = 2.0 * uniforms[:, 0]
    r2 = 2.0 * uniforms[:, 1]
    jx = np.where(r1 < 1.0, np.sqrt(r1) - 1.0, 1.0 - np.sqrt(np.maximum(2.0 - r1, 0.0)))
    jy = np.where(r2 < 1.0, np.sqrt(r2) - 1.0, 1.0 - np.sqrt(np.maximum(2.0 - r2, 0.0)))
    dx = (2.0 * u - 1.0) + jx / (width * 0.5)
    dy = (2.0 * v - 1.0) + jy / (height * 0.5)
    tan_fov = np.tan(float(camera.fov) * 0.5)
    dx = dx * (width / height) * tan_fov
    dy = dy * tan_fov
    d = _normalize(
        dx[:, None] * np.asarray(camera.right)[None]
        + dy[:, None] * np.asarray(camera.up)[None]
        + np.asarray(camera.forward)[None]
    )
    o = np.broadcast_to(np.asarray(camera.position)[None], d.shape).copy()
    return o.astype(np.float32), d.astype(np.float32)


def intersect_brute(scene: SceneArrays, o: np.ndarray, d: np.ndarray, t_max=INF):
    """Brute-force Möller–Trumbore over all triangles for a ray batch.

    Returns (t, tri, u, v): closest hit per ray, tri = -1 on miss.
    Same acceptance rule as the reference (`path_trace.fs:322-374`):
    u >= 0, v >= 0, t >= 0, 1-u-v >= 0, t < t_max.
    """
    v0 = scene.vertices[scene.tri_v[:, 0]]  # (T,3)
    e1 = scene.vertices[scene.tri_v[:, 1]] - v0
    e2 = scene.vertices[scene.tri_v[:, 2]] - v0

    # (N, T, 3) broadcasting
    pv = np.cross(d[:, None, :], e2[None, :, :])
    det = np.einsum("tj,ntj->nt", e1, pv)
    inv_det = 1.0 / np.where(np.abs(det) < 1e-20, 1e-20, det)
    tv = o[:, None, :] - v0[None, :, :]
    qv = np.cross(tv, e1[None, :, :])
    u = np.einsum("ntj,ntj->nt", tv, pv) * inv_det
    v = np.einsum("nj,ntj->nt", d, qv) * inv_det
    t = np.einsum("tj,ntj->nt", e2, qv) * inv_det
    w = 1.0 - u - v
    valid = (u >= 0) & (v >= 0) & (w >= 0) & (t >= 0) & (t < t_max)
    t_masked = np.where(valid, t, INF)
    tri = np.argmin(t_masked, axis=1).astype(np.int32)
    n_rays = o.shape[0]
    tbest = t_masked[np.arange(n_rays), tri]
    miss = tbest >= INF
    tri = np.where(miss, -1, tri)
    return (
        tbest.astype(np.float32),
        tri,
        u[np.arange(n_rays), np.where(tri < 0, 0, tri)].astype(np.float32),
        v[np.arange(n_rays), np.where(tri < 0, 0, tri)].astype(np.float32),
    )


def occluded_brute(scene: SceneArrays, o: np.ndarray, d: np.ndarray, t_max: np.ndarray):
    """Any-hit query: does any triangle block [0, t_max)?"""
    v0 = scene.vertices[scene.tri_v[:, 0]]
    e1 = scene.vertices[scene.tri_v[:, 1]] - v0
    e2 = scene.vertices[scene.tri_v[:, 2]] - v0
    pv = np.cross(d[:, None, :], e2[None, :, :])
    det = np.einsum("tj,ntj->nt", e1, pv)
    inv_det = 1.0 / np.where(np.abs(det) < 1e-20, 1e-20, det)
    tv = o[:, None, :] - v0[None, :, :]
    qv = np.cross(tv, e1[None, :, :])
    u = np.einsum("ntj,ntj->nt", tv, pv) * inv_det
    v = np.einsum("nj,ntj->nt", d, qv) * inv_det
    t = np.einsum("tj,ntj->nt", e2, qv) * inv_det
    w = 1.0 - u - v
    hit = (u >= 0) & (v >= 0) & (w >= 0) & (t >= 0) & (t < t_max[:, None])
    return hit.any(axis=1)


def _shading_normal(scene: SceneArrays, tri, u, v):
    """Interpolated vertex normal when available, else geometric normal
    (`path_trace.fs:440-454`)."""
    tri_safe = np.where(tri < 0, 0, tri)
    vid = scene.tri_v[tri_safe]
    p0 = scene.vertices[vid[:, 0]]
    p1 = scene.vertices[vid[:, 1]]
    p2 = scene.vertices[vid[:, 2]]
    geo_n = _normalize(np.cross(p1 - p0, p2 - p0))
    nid = scene.tri_vn[tri_safe]
    if scene.normals.shape[0] > 0:
        nid_safe = np.clip(nid[:, :3], 0, max(scene.normals.shape[0] - 1, 0))
        n0 = scene.normals[nid_safe[:, 0]]
        n1 = scene.normals[nid_safe[:, 1]]
        n2 = scene.normals[nid_safe[:, 2]]
        w = (1.0 - u - v)[:, None]
        interp_n = _normalize(n0 * w + n1 * u[:, None] + n2 * v[:, None])
        use_interp = (nid[:, 3] == 1)[:, None]
        return np.where(use_interp, interp_n, geo_n).astype(np.float32)
    return geo_n.astype(np.float32)


def _onb(n):
    """Frisvad/Duff orthonormal basis (singularity-guarded like
    `path_trace.fs:44-60`)."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    a = 1.0 / np.maximum(1.0 + nz, 1e-7)
    b = -nx * ny * a
    u = np.stack([1.0 - nx * nx * a, b, -nx], axis=-1)
    v = np.stack([b, 1.0 - ny * ny * a, -ny], axis=-1)
    pole = (nz < -0.9999999)[:, None]
    u = np.where(pole, np.array([0.0, -1.0, 0.0], np.float32), u)
    v = np.where(pole, np.array([-1.0, 0.0, 0.0], np.float32), v)
    return u.astype(np.float32), v.astype(np.float32)


def _power_heuristic(a, b):
    # Clamp before squaring: dead lanes carry pdf ~ dist^2/eps which would
    # overflow float32 when squared (result on those lanes is discarded).
    a = np.clip(a, 0.0, 1e12)
    b = np.clip(b, 0.0, 1e12)
    t = a * a
    return t / np.maximum(b * b + t, 1e-20)


def render(
    scene: SceneArrays,
    camera: Camera,
    width: int,
    height: int,
    uniforms: np.ndarray,
    max_depth: int = 3,
    exact_reference_nee: bool = False,
):
    """Trace one sample per pixel; returns (H, W, 3) float32 radiance.

    `uniforms`: (H*W, 4 + 7*max_depth) in [0, 1).
    """
    n = width * height
    assert uniforms.shape == (n, uniforms_per_sample(max_depth)), uniforms.shape

    o, d = generate_rays(camera, width, height, uniforms)
    L = np.zeros((n, 3), np.float32)
    T = np.ones((n, 3), np.float32)
    prev_pdf = np.ones(n, np.float32)
    is_specular = np.ones(n, bool)
    alive = np.ones(n, bool)

    mats = scene.materials
    lights = scene.lights
    num_lights = lights.count

    for bounce in range(max_depth):
        if not alive.any():
            break
        base = 4 + 7 * bounce  # slot 6 = RR draw (unused: the oracle never RRs)
        u_lp = uniforms[:, base + 0]
        u_l1 = uniforms[:, base + 1]
        u_l2 = uniforms[:, base + 2]
        u_b1 = uniforms[:, base + 3]
        u_b2 = uniforms[:, base + 4]
        u_lobe = uniforms[:, base + 5]

        t, tri, bu, bv = intersect_brute(scene, o, d)
        hit = alive & (tri >= 0)
        alive = alive & hit  # miss → path dead (env map = black, like cornell)

        tri_safe = np.where(tri < 0, 0, tri)
        mtl = scene.tri_v[tri_safe, 3]
        n_shade = _shading_normal(scene, tri_safe, bu, bv)
        cos_incident = np.sum(d * n_shade, axis=-1)
        n_flip = np.where((cos_incident > 0)[:, None], -n_shade, n_shade)

        albedo = mats.albedo[mtl, :3]
        mat_type = mats.albedo[mtl, 3].astype(np.int32)
        emission = mats.emission[mtl, :3]
        emissive = mats.emission[mtl, 3] != -1

        # --- emissive hit: add Le (MIS-weighted unless via specular) and die
        hit_light = hit & emissive
        if hit_light.any() and num_lights > 0:
            li = scene.tri_vt[tri_safe, 3]
            li_safe = np.clip(li, 0, num_lights - 1)
            area = lights.area_pdf[li_safe, 0]
            cos_light = -np.sum(d * n_flip, axis=-1)  # d·n < 0 on front hit
            dist2 = t * t
            pdf_select = 1.0 / num_lights
            pdf_light = dist2 / np.maximum(area * np.maximum(cos_light, 1e-8), 1e-20) * pdf_select
            w_mis = np.where(is_specular, 1.0, _power_heuristic(prev_pdf, pdf_light))
            L += np.where(hit_light[:, None], T * emission * w_mis[:, None], 0.0)
            alive = alive & ~hit_light

        hit_point = o + d * t[:, None] + n_flip * RAY_OFFSET

        is_spec_mat = np.isin(mat_type, _SPECULAR_IDS)
        from caitlyn.core.types import LAMBERT_TYPES
        is_lambert = np.isin(mat_type, np.array([int(t) for t in LAMBERT_TYPES]))
        is_disney = ~is_spec_mat & ~is_lambert
        dis_p = disney.params_from_materials(mats, mtl, albedo)
        view = -d

        # --- NEE for diffuse lanes
        if num_lights > 0:
            li = np.minimum((u_lp * num_lights).astype(np.int32), num_lights - 1)
            s = np.sqrt(u_l1)
            b0 = 1.0 - s
            b1 = u_l2 * s
            lpos = lights.p[li] + b0[:, None] * lights.u[li] + b1[:, None] * lights.v[li]
            ldir = lpos - hit_point
            dist = np.linalg.norm(ldir, axis=-1)
            ldir = ldir / np.maximum(dist[:, None], 1e-20)
            cos_mtl = np.sum(ldir * n_flip, axis=-1)
            cos_light = np.sum(ldir * lights.n[li], axis=-1)
            cand = alive & ~is_spec_mat & (cos_mtl > 0) & (cos_light < 0)
            if cand.any():
                shadowed = occluded_brute(
                    scene,
                    hit_point,
                    ldir,
                    np.where(cand, dist - EPS, 0.0),
                )
                visible = cand & ~shadowed
                area = lights.area_pdf[li, 0]
                pdf_select = 1.0 / num_lights
                pdf_light = (
                    dist * dist
                    / np.maximum(area * np.maximum(-cos_light, 1e-8), 1e-20)
                    * pdf_select
                )
                le = lights.e[li]
                f_dis, pdf_dis = disney.eval_pdf(dis_p, n_flip, view, ldir)
                cos_pos = np.maximum(cos_mtl, 0.0)
                if exact_reference_nee:
                    f_lam = albedo
                else:
                    f_lam = albedo * (cos_pos / np.pi)[:, None]
                pdf_lam = cos_pos / np.pi
                f_nee = np.where(is_disney[:, None], f_dis, f_lam)
                bsdf_pdf = np.where(is_disney, pdf_dis, pdf_lam)
                w_mis = _power_heuristic(pdf_light, bsdf_pdf)
                contrib = T * le * f_nee * (w_mis / np.maximum(pdf_light, 1e-20))[:, None]
                L += np.where(visible[:, None], contrib, 0.0)

        # --- sample continuation direction
        # Diffuse: cosine hemisphere. Specular: mirror / glass lobes.
        ub, vb = _onb(n_flip)
        r = np.sqrt(u_b1)
        phi = 2.0 * np.pi * u_b2
        local = np.stack(
            [r * np.cos(phi), r * np.sin(phi), np.sqrt(np.maximum(1.0 - u_b1, 0.0))],
            axis=-1,
        )
        diff_dir = (
            ub * local[:, 0:1] + vb * local[:, 1:2] + n_flip * local[:, 2:3]
        )
        diff_pdf = np.maximum(local[:, 2], 1e-8) / np.pi

        dis_dir, dis_f, dis_pdf = disney.sample(dis_p, n_flip, view, u_lobe, u_b1, u_b2)
        dis_ok = dis_pdf > 1e-9
        dis_T = T * np.where(
            dis_ok[:, None], dis_f / np.maximum(dis_pdf, 1e-9)[:, None], 0.0
        )

        refl_dir = d - 2.0 * np.sum(d * n_flip, axis=-1, keepdims=True) * n_flip

        new_d = np.where(is_disney[:, None], dis_dir, diff_dir)
        new_T = np.where(is_disney[:, None], dis_T, T * albedo)
        new_pdf = np.where(is_disney, np.maximum(dis_pdf, 1e-9), diff_pdf)
        alive = alive & np.where(is_disney, dis_ok, True)
        new_spec_flag = np.zeros(n, bool)

        mirror = is_spec_mat & (mat_type == int(MaterialType.MIRROR))
        # Mirror: perfect reflection, tinted by albedo.
        new_d = np.where(mirror[:, None], refl_dir, new_d)
        new_T = np.where(mirror[:, None], T * albedo, new_T)
        new_pdf = np.where(mirror, 1.0, new_pdf)
        new_spec_flag = new_spec_flag | mirror

        glass_ids = (
            int(MaterialType.GLASS),
            int(MaterialType.GLASS_COLOR),
            int(MaterialType.GLASS_NO_REFRACT),
            int(MaterialType.ROUGH_DIELECTRIC),
            int(MaterialType.THIN_DIELECTRIC),
            int(MaterialType.THIN_SHEET),
        )
        glass = is_spec_mat & np.isin(mat_type, np.array(glass_ids))
        if glass.any():
            ior = mats.specular[mtl, 3]
            entering = cos_incident <= 0
            eta = np.where(entering, 1.0 / np.maximum(ior, 1e-6), ior)
            ci = np.abs(np.sum(d * n_flip, axis=-1))
            sin2_t = eta * eta * np.maximum(1.0 - ci * ci, 0.0)
            cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
            r_par = (ci - eta * cos_t) / np.maximum(ci + eta * cos_t, 1e-12)
            r_perp = (eta * ci - cos_t) / np.maximum(eta * ci + cos_t, 1e-12)
            fres = np.where(sin2_t >= 1.0, 1.0, 0.5 * (r_par**2 + r_perp**2))
            refr_dir = _normalize(
                eta[:, None] * d + (eta * ci - cos_t)[:, None] * n_flip
            )
            choose_refl = (u_lobe < fres) | (sin2_t >= 1.0)
            gdir = np.where(choose_refl[:, None], refl_dir, refr_dir)
            new_d = np.where(glass[:, None], gdir, new_d)
            new_T = np.where(glass[:, None], T * albedo, new_T)
            new_pdf = np.where(glass, 1.0, new_pdf)
            new_spec_flag = new_spec_flag | glass
            # refracted rays must offset to the far side of the surface
            offs = np.where(
                (glass & ~choose_refl)[:, None], -2.0 * RAY_OFFSET * n_flip, 0.0
            )
            hit_point = hit_point + offs

        o = hit_point
        d = _normalize(new_d).astype(np.float32)
        T = np.where(alive[:, None], new_T, T).astype(np.float32)
        prev_pdf = new_pdf.astype(np.float32)
        is_specular = new_spec_flag

    return L.reshape(height, width, 3)
