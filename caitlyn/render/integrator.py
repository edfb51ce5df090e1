"""Device wavefront path-tracing integrator (jit, differentiable).

A wavefront re-design of the reference's per-fragment megakernel
(`/root/reference/Shader/path_trace.fs:857-1024`): instead of one divergent
program per pixel, the whole ray batch advances bounce-by-bounce as dense
SoA arrays — raygen → traverse → shade/NEE → scatter — with masked lanes
for dead paths.  Shading is jnp on (N, …) arrays; the ray queries go
through ops/traversal.py, which picks the CUDA BVH kernel on a GPU and
the XLA references elsewhere.

Integrator math matches `cpu_reference/integrator.py` (the oracle) exactly
— same uniform-number layout, same estimator — which is what the parity
tests assert.  Differentiability: hit indices come out of traversal as
integers (no gradient), and all shading quantities (normals, uvt, BSDF
eval) are recomputed differentiably from the gathered geometry, so
d(image)/d(vertices, materials, camera, lights) flows through shading —
the standard detached-traversal estimator (SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from caitlyn.core import math as cm
from caitlyn.core.camera import generate_rays
from caitlyn.core.types import Camera, MaterialType, RenderOptions
from caitlyn.ops import bsdf
from caitlyn.ops import intersect as isect
from caitlyn.ops import texture as tex
from caitlyn.ops import traversal
from caitlyn.scene import DeviceScene

INF = cm.INF
EPS = cm.EPS
RAY_OFFSET = cm.RAY_OFFSET

from caitlyn.core.types import LAMBERT_TYPES, SPECULAR_TYPES

_GLASS_IDS = (
    int(MaterialType.GLASS),
    int(MaterialType.GLASS_COLOR),
    int(MaterialType.GLASS_NO_REFRACT),
    int(MaterialType.ROUGH_DIELECTRIC),
    int(MaterialType.THIN_DIELECTRIC),
    int(MaterialType.THIN_SHEET),
)
_SPECULAR_IDS = tuple(int(t) for t in SPECULAR_TYPES)
_LAMBERT_IDS = tuple(int(t) for t in LAMBERT_TYPES)


class Hit(NamedTuple):
    t: jax.Array
    tri: jax.Array
    u: jax.Array
    v: jax.Array


def _closest_hit(ds: DeviceScene, o, d, active, options: RenderOptions):
    """Closest hit with detached traversal + differentiable refinement:
    the hit *id* comes from non-differentiable traversal, then (t, u, v)
    are recomputed with `refine_hit` so the shading path carries gradients
    w.r.t. geometry and rays."""
    raw = _closest_hit_raw(ds, o, d, active, options)
    sc = ds.scene
    t, u, v = isect.refine_hit(o, d, raw.tri, sc.vertices, sc.tri_v)
    keep = raw.tri >= 0
    return Hit(
        t=jnp.where(keep, t, raw.t),
        tri=raw.tri,
        u=jnp.where(keep, u, raw.u),
        v=jnp.where(keep, v, raw.v),
    )


def _closest_hit_raw(ds: DeviceScene, o, d, active, options: RenderOptions):
    """Detached closest-hit query (ops/traversal.py picks the kernel)."""
    ds, o, d = jax.lax.stop_gradient((ds, o, d))
    return Hit(*jax.lax.stop_gradient(traversal.closest(ds, o, d, active, options)))


def _occluded(ds: DeviceScene, o, d, t_max, active, options: RenderOptions):
    """Any-hit visibility — boolean, fully detached (no visibility
    gradients in v1; documented estimator limitation, SURVEY.md §7)."""
    ds, o, d, t_max = jax.lax.stop_gradient((ds, o, d, t_max))
    return traversal.anyhit(ds, o, d, t_max, active, options)


def _shading_normal(ds: DeviceScene, tri_safe, u, v):
    """Interpolated vertex normal when flagged, else geometric face normal
    (`path_trace.fs:440-454`)."""
    sc = ds.scene
    vid = sc.tri_v[tri_safe]
    p0 = sc.vertices[vid[:, 0]]
    p1 = sc.vertices[vid[:, 1]]
    p2 = sc.vertices[vid[:, 2]]
    geo_n = cm.normalize(jnp.cross(p1 - p0, p2 - p0))
    if sc.normals.shape[0] == 0:
        return geo_n
    nid = sc.tri_vn[tri_safe]
    nid3 = jnp.clip(nid[:, :3], 0, sc.normals.shape[0] - 1)
    n0 = sc.normals[nid3[:, 0]]
    n1 = sc.normals[nid3[:, 1]]
    n2 = sc.normals[nid3[:, 2]]
    interp = cm.normalize(cm.interpolate(n0, n1, n2, u, v))
    return jnp.where((nid[:, 3] == 1)[:, None], interp, geo_n)


def _albedo(ds: DeviceScene, mtl, tri_safe, u, v):
    """Material albedo, textured when the material carries an atlas layer
    (`path_trace.fs:471-486`)."""
    sc = ds.scene
    base = sc.materials.albedo[mtl, :3]
    if sc.textures is None or sc.texcoords.shape[0] == 0:
        return base
    layer_f = sc.materials.tex_ind[mtl, 0]
    tid = sc.tri_vt[tri_safe]
    tid3 = jnp.clip(tid[:, :3], 0, sc.texcoords.shape[0] - 1)
    t0 = sc.texcoords[tid3[:, 0]]
    t1 = sc.texcoords[tid3[:, 1]]
    t2 = sc.texcoords[tid3[:, 2]]
    uv = t0 * (1.0 - u - v)[:, None] + t1 * u[:, None] + t2 * v[:, None]
    sampled = tex.sample_bilinear(sc.textures, layer_f.astype(jnp.int32), uv)
    return jnp.where((layer_f >= 0)[:, None], sampled, base)


def _power_heuristic(a, b):
    a = jnp.clip(a, 0.0, 1e12)
    b = jnp.clip(b, 0.0, 1e12)
    t = a * a
    return t / jnp.maximum(b * b + t, 1e-20)


# ---------------------------------------------------------------------------
# Fused shading table: ALL per-triangle data the shader needs — geometry,
# normals, texcoords, light id, and the joined material row — concatenated
# into ONE (T, 50) f32 table so each bounce fetches everything with a single
# row gather instead of a chain of dependent per-field gathers.  Fully
# differentiable w.r.t. vertices/materials.
#
# Column map:
#   0:3 p0 | 3:6 e1 | 6:9 e2 | 9:12 n0 | 12:15 n1 | 15:18 n2 | 18 n-interp
#   19:21 t0 | 21:23 t1 | 23:25 t2 | 25 light idx
#   26:30 albedo(rgb+type) | 30:34 emission(rgb+flag) | 34:38 specular(rgb+ior)
#   38:42 disney | 42:46 disney2 | 46:50 tex_ind
# ---------------------------------------------------------------------------


def _build_shade_table(sc):
    t = sc.tri_v.shape[0]
    tv = sc.tri_v
    p0 = sc.vertices[tv[:, 0]]
    e1 = sc.vertices[tv[:, 1]] - p0
    e2 = sc.vertices[tv[:, 2]] - p0
    if sc.normals.shape[0] > 0:
        nid = jnp.clip(sc.tri_vn[:, :3], 0, sc.normals.shape[0] - 1)
        n0 = sc.normals[nid[:, 0]]
        n1 = sc.normals[nid[:, 1]]
        n2 = sc.normals[nid[:, 2]]
        nflag = (sc.tri_vn[:, 3] == 1).astype(jnp.float32)[:, None]
    else:
        n0 = n1 = n2 = jnp.zeros((t, 3), jnp.float32)
        nflag = jnp.zeros((t, 1), jnp.float32)
    if sc.texcoords.shape[0] > 0:
        tid = jnp.clip(sc.tri_vt[:, :3], 0, sc.texcoords.shape[0] - 1)
        t0 = sc.texcoords[tid[:, 0]]
        t1 = sc.texcoords[tid[:, 1]]
        t2 = sc.texcoords[tid[:, 2]]
    else:
        t0 = t1 = t2 = jnp.zeros((t, 2), jnp.float32)
    light_idx = sc.tri_vt[:, 3].astype(jnp.float32)[:, None]
    m = sc.materials
    mat_tab = jnp.concatenate(
        [m.albedo, m.emission, m.specular, m.disney, m.disney2, m.tex_ind], axis=1
    )
    mrows = mat_tab[tv[:, 3]]  # (T, 24): tiny output, native gather is fine
    return jnp.concatenate(
        [p0, e1, e2, n0, n1, n2, nflag, t0, t1, t2, light_idx, mrows], axis=1
    )


def _build_light_table(lights):
    """(L, 17) f32: p | u | v | n | e | area | selection pdf."""
    return jnp.concatenate(
        [lights.p, lights.u, lights.v, lights.n, lights.e, lights.area_pdf], axis=1
    )


def _shading_normal_from_rows(rows, e1, e2, u, v):
    geo_n = cm.normalize(jnp.cross(e1, e2))
    interp = cm.normalize(
        cm.interpolate(rows[:, 9:12], rows[:, 12:15], rows[:, 15:18], u, v)
    )
    return jnp.where((rows[:, 18] > 0.5)[:, None], interp, geo_n)


def _albedo_from_rows(sc, rows, u, v):
    base = rows[:, 26:29]
    if sc.textures is None or sc.texcoords.shape[0] == 0:
        return base
    layer_f = rows[:, 46]
    uv = cm.interpolate(rows[:, 19:21], rows[:, 21:23], rows[:, 23:25], u, v)
    sampled = tex.sample_bilinear(
        sc.textures, jnp.round(layer_f).astype(jnp.int32), uv
    )
    return jnp.where((layer_f >= 0)[:, None], sampled, base)


def trace_aov(ds: DeviceScene, o, d, options: RenderOptions):
    """First-hit AOV pass — the debug integrator family
    (`/root/reference/Shader/path_trace.fs:822-840` renders first-hit
    albedo; "normal" and "depth" are the natural companions).  One
    closest-hit query, no sampling: a single-sample AOV frame is exact."""
    n = o.shape[0]
    active = jnp.ones(n, bool)
    hit = _closest_hit(ds, o, d, active, options)
    got = hit.tri >= 0
    tri_safe = jnp.maximum(hit.tri, 0)
    if options.aov == "depth":
        t = jnp.where(got, hit.t, 0.0)
        return jnp.broadcast_to(t[:, None], (n, 3))
    n_shade = _shading_normal(ds, tri_safe, hit.u, hit.v)
    if options.aov == "normal":
        img = 0.5 * (n_shade + 1.0)
        return jnp.where(got[:, None], img, 0.0)
    sc = ds.scene
    mtl = sc.tri_v[tri_safe, 3]
    albedo = _albedo(ds, mtl, tri_safe, hit.u, hit.v)
    # Emissive surfaces show their emission, like the reference's debug
    # view showing lights as-is.
    emission = sc.materials.emission[mtl, :3]
    emissive = sc.materials.emission[mtl, 3] != -1
    img = jnp.where(emissive[:, None], emission, albedo)
    return jnp.where(got[:, None], img, 0.0)


def trace_paths(
    ds: DeviceScene,
    o,
    d,
    uniforms,
    options: RenderOptions,
    with_stats: bool = False,
):
    """Trace one path per input ray; returns radiance (N, 3), or
    (radiance, stats) when with_stats — stats counts the actual closest-hit
    and any-hit ray queries issued (for honest rays/sec metrics and the
    bounce-occupancy log, SURVEY.md §5 observability).

    uniforms: (N, 4 + 7*max_depth) — layout in render/sampling.py; the
    first 4 (raygen) entries are unused here.
    """
    n = o.shape[0]
    n_closest = jnp.int32(0)
    n_anyhit = jnp.int32(0)
    sc = ds.scene
    mats = sc.materials
    num_lights = sc.lights.p.shape[0]

    # Static shading specialization: only trace the lobes the scene uses
    # (options.families from scene.scene_families; default = everything).
    has_disney = "disney" in options.families
    has_mirror = "mirror" in options.families
    has_glass = "glass" in options.families
    has_spec = has_mirror or has_glass

    L = jnp.zeros((n, 3), jnp.float32)
    T = jnp.ones((n, 3), jnp.float32)
    prev_pdf = jnp.ones(n, jnp.float32)
    is_specular = jnp.ones(n, bool)
    alive = jnp.ones(n, bool)

    # Fetch ALL shading data per bounce with one row gather from the fused
    # (T, 50) table.  Large scenes precompute it at upload (ds.shade_tab); the in-trace
    # rebuild keeps gradients w.r.t. vertices/materials for callers that
    # bypass apply_params.
    fused = sc.tri_v.shape[0] > 0
    if fused:
        shade_tab = (
            ds.shade_tab if ds.shade_tab is not None else _build_shade_table(sc)
        )
    light_tab = _build_light_table(sc.lights) if num_lights > 0 else None

    alive_per_bounce = []

    for bounce in range(options.max_depth):
        base = 4 + 7 * bounce
        u_lp = uniforms[:, base + 0]
        u_l1 = uniforms[:, base + 1]
        u_l2 = uniforms[:, base + 2]
        u_b1 = uniforms[:, base + 3]
        u_b2 = uniforms[:, base + 4]
        u_lobe = uniforms[:, base + 5]

        # --- Russian roulette (bounces >= rr_start): survive with
        # probability p = max throughput component, compensate T by 1/p.
        # The reference never needed RR (3 hard-coded bounces,
        # `path_trace.fs:867`); a 6-bounce wavefront does — without it
        # every lane rides to max_depth while carrying ~zero throughput.
        # Unbiased: E[T'] = p·(T/p) = T.  Detached decision (standard
        # estimator choice, grad/inverse.py docstring).
        if 0 <= options.rr_start <= bounce:
            u_rr = uniforms[:, base + 6]
            p_surv = jnp.clip(jnp.max(T, axis=1), 0.05, 1.0)
            p_surv = jax.lax.stop_gradient(p_surv)
            alive = alive & (u_rr < p_surv)
            T = T / p_surv[:, None]

        alive_per_bounce.append(jnp.sum(alive.astype(jnp.int32)))
        n_closest = n_closest + jnp.sum(alive.astype(jnp.int32))
        if fused:
            raw = _closest_hit_raw(ds, o, d, alive, options)
            tri_safe = jnp.maximum(raw.tri, 0)
            rows = shade_tab[tri_safe]
            # Differentiable refinement from the table's (p0, e1, e2).
            t_r, u_r, v_r = isect.refine_hit_tri(
                o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
            )
            keep = raw.tri >= 0
            hit = Hit(
                t=jnp.where(keep, t_r, raw.t),
                tri=raw.tri,
                u=jnp.where(keep, u_r, raw.u),
                v=jnp.where(keep, v_r, raw.v),
            )
        else:
            hit = _closest_hit(ds, o, d, alive, options)
            tri_safe = jnp.maximum(hit.tri, 0)
        got = alive & (hit.tri >= 0)
        if options.use_env_map and sc.env_map is not None:
            # Miss → environment radiance (the wiring behind the
            # reference's dead `useEnvMap` option, `Scene.h:57-58`).
            # The env is a BSDF-sampled-only light: no NEE toward it, so
            # its MIS weight is 1 (documented estimator choice).
            env = tex.sample_env(sc.env_map, d)
            L = L + jnp.where((alive & ~got)[:, None], T * env, 0.0)
        alive = got

        if fused:
            n_shade = _shading_normal_from_rows(
                rows, rows[:, 3:6], rows[:, 6:9], hit.u, hit.v
            )
            albedo = _albedo_from_rows(sc, rows, hit.u, hit.v)
            mat_type = jnp.round(rows[:, 29]).astype(jnp.int32)
            emission = rows[:, 30:33]
            emissive = rows[:, 33] != -1
            li_hit = jnp.round(rows[:, 25]).astype(jnp.int32)
            ior_row = rows[:, 37]
        else:
            mtl = sc.tri_v[tri_safe, 3]
            n_shade = _shading_normal(ds, tri_safe, hit.u, hit.v)
            albedo = _albedo(ds, mtl, tri_safe, hit.u, hit.v)
            mat_type = mats.albedo[mtl, 3].astype(jnp.int32)
            emission = mats.emission[mtl, :3]
            emissive = mats.emission[mtl, 3] != -1
            li_hit = sc.tri_vt[tri_safe, 3]
            ior_row = mats.specular[mtl, 3]
        cos_incident = cm.dot(d, n_shade)
        n_flip = jnp.where((cos_incident > 0)[:, None], -n_shade, n_shade)

        # --- emissive hit (path_trace.fs:894-928)
        hit_light = got & emissive
        if num_lights > 0:
            li = jnp.clip(li_hit, 0, num_lights - 1)
            area = light_tab[li, 15]
            cos_light = -cm.dot(d, n_flip)
            pdf_select = 1.0 / num_lights
            pdf_light = (
                hit.t * hit.t
                / jnp.maximum(area * jnp.maximum(cos_light, 1e-8), 1e-20)
                * pdf_select
            )
            w_mis = jnp.where(is_specular, 1.0, _power_heuristic(prev_pdf, pdf_light))
            L = L + jnp.where(hit_light[:, None], T * emission * w_mis[:, None], 0.0)
            alive = alive & ~hit_light

        hit_point = o + d * hit.t[:, None] + n_flip * RAY_OFFSET

        type_is = lambda ids: jnp.isin(mat_type, jnp.asarray(ids, jnp.int32))
        false_ = jnp.zeros(n, bool)
        is_spec_mat = type_is(_SPECULAR_IDS) if has_spec else false_
        # Everything that is neither Lambert-diffuse nor a delta lobe goes
        # through the Disney BRDF with per-material parameters (the rough /
        # plastic / conductor / coat families map onto Disney parameters at
        # parse time — io/obj.py `_apply_type_defaults`).
        if has_disney:
            is_lambert = type_is(_LAMBERT_IDS)
            is_disney = ~is_spec_mat & ~is_lambert
            if fused:
                dis_p = bsdf.DisneyParams(
                    base_color=albedo,
                    roughness=jnp.clip(rows[:, 38], 0.02, 1.0),
                    metallic=rows[:, 39],
                    spec_tint=rows[:, 40],
                    sheen=rows[:, 41],
                    clearcoat=rows[:, 42],
                    clearcoat_gloss=rows[:, 43],
                    subsurface=rows[:, 44],
                    ior=jnp.maximum(ior_row, 1.01),
                )
            else:
                dis_p = bsdf.params_from_materials(mats, mtl, albedo)
        else:
            is_disney = false_
            dis_p = None
        view = -d  # toward viewer

        # --- NEE with MIS (path_trace.fs:938-1002)
        if num_lights > 0:
            li = jnp.minimum((u_lp * num_lights).astype(jnp.int32), num_lights - 1)
            s = jnp.sqrt(u_l1)
            b0 = 1.0 - s
            b1 = u_l2 * s
            lrows = light_tab[li]
            lpos = lrows[:, 0:3] + b0[:, None] * lrows[:, 3:6] + b1[:, None] * lrows[:, 6:9]
            ldir = lpos - hit_point
            dist = cm.norm(ldir)
            ldir = ldir / jnp.maximum(dist[:, None], 1e-20)
            cos_mtl = cm.dot(ldir, n_flip)
            cos_light = cm.dot(ldir, lrows[:, 9:12])
            cand = alive & ~is_spec_mat & (cos_mtl > 0) & (cos_light < 0)
            n_anyhit = n_anyhit + jnp.sum(cand.astype(jnp.int32))
            shadowed = _occluded(
                ds, hit_point, ldir, jnp.where(cand, dist - EPS, 0.0), cand,
                options,
            )
            visible = cand & ~shadowed
            area = lrows[:, 15]
            pdf_select = 1.0 / num_lights
            pdf_light = (
                dist * dist
                / jnp.maximum(area * jnp.maximum(-cos_light, 1e-8), 1e-20)
                * pdf_select
            )
            le = lrows[:, 12:15]
            # BSDF value toward the light (cos-premultiplied) + its pdf,
            # per material family.
            cos_pos = jnp.maximum(cos_mtl, 0.0)
            if options.exact_reference_nee:
                f_lam = albedo  # reference estimator (path_trace.fs:988-998)
            else:
                f_lam = albedo * (cos_pos / jnp.pi)[:, None]
            pdf_lam = cos_pos / jnp.pi
            if has_disney:
                f_dis, pdf_dis = bsdf.eval_pdf(dis_p, n_flip, view, ldir)
                f_nee = jnp.where(is_disney[:, None], f_dis, f_lam)
                bsdf_pdf = jnp.where(is_disney, pdf_dis, pdf_lam)
            else:
                f_nee = f_lam
                bsdf_pdf = pdf_lam
            w_mis = _power_heuristic(pdf_light, bsdf_pdf)
            contrib = T * le * f_nee * (
                w_mis / jnp.maximum(pdf_light, 1e-20)
            )[:, None]
            L = L + jnp.where(visible[:, None], contrib, 0.0)

        # --- continuation: lambert cosine / Disney sample / mirror / glass
        local = cm.cosine_hemisphere_dir(u_b1, u_b2)
        diff_dir = cm.local_to_world(local, n_flip)
        diff_pdf = jnp.maximum(local[:, 2], 1e-8) / jnp.pi

        if has_disney:
            dis_dir, dis_f, dis_pdf = bsdf.sample(dis_p, n_flip, view, u_lobe, u_b1, u_b2)
            dis_ok = dis_pdf > 1e-9
            dis_T = T * jnp.where(
                dis_ok[:, None], dis_f / jnp.maximum(dis_pdf, 1e-9)[:, None], 0.0
            )
            new_d = jnp.where(is_disney[:, None], dis_dir, diff_dir)
            new_T = jnp.where(is_disney[:, None], dis_T, T * albedo)
            new_pdf = jnp.where(is_disney, jnp.maximum(dis_pdf, 1e-9), diff_pdf)
            alive = alive & jnp.where(is_disney, dis_ok, True)
        else:
            new_d = diff_dir
            new_T = T * albedo
            new_pdf = diff_pdf
        new_spec = jnp.zeros(n, bool)

        if has_mirror:
            refl_dir = cm.reflect(d, n_flip)
            mirror = mat_type == int(MaterialType.MIRROR)
            new_d = jnp.where(mirror[:, None], refl_dir, new_d)
            new_pdf = jnp.where(mirror, 1.0, new_pdf)
            new_spec = new_spec | mirror

        if has_glass:
            refl_dir = cm.reflect(d, n_flip)
            glass = type_is(_GLASS_IDS)
            ior = ior_row
            entering = cos_incident <= 0
            eta = jnp.where(entering, 1.0 / jnp.maximum(ior, 1e-6), ior)
            ci = jnp.abs(cm.dot(d, n_flip))
            sin2_t = eta * eta * jnp.maximum(1.0 - ci * ci, 0.0)
            # Floor strictly above 0: sqrt'(0) = inf, and at the total-
            # internal-reflection boundary the `where(sin2_t >= 1, ...)`
            # masks only the VALUE — the backward still multiplies
            # 0 * inf = NaN into any upstream gradient (d carries grads
            # once BSDF parameters are optimized).
            cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
            r_par = (ci - eta * cos_t) / jnp.maximum(ci + eta * cos_t, 1e-12)
            r_perp = (eta * ci - cos_t) / jnp.maximum(eta * ci + cos_t, 1e-12)
            fres = jnp.where(sin2_t >= 1.0, 1.0, 0.5 * (r_par**2 + r_perp**2))
            refr_dir = cm.normalize(
                eta[:, None] * d + (eta * ci - cos_t)[:, None] * n_flip
            )
            choose_refl = (u_lobe < fres) | (sin2_t >= 1.0)
            gdir = jnp.where(choose_refl[:, None], refl_dir, refr_dir)
            new_d = jnp.where(glass[:, None], gdir, new_d)
            new_pdf = jnp.where(glass, 1.0, new_pdf)
            new_spec = new_spec | glass
            hit_point = hit_point + jnp.where(
                (glass & ~choose_refl)[:, None], -2.0 * RAY_OFFSET * n_flip, 0.0
            )

        o = hit_point
        d = cm.normalize(new_d)
        T = jnp.where(alive[:, None], new_T, T)
        prev_pdf = new_pdf
        is_specular = new_spec

    if with_stats:
        return L, {
            "rays_closest": n_closest,
            "rays_anyhit": n_anyhit,
            "alive_per_bounce": jnp.stack(alive_per_bounce),
        }
    return L


@partial(jax.jit, static_argnames=("width", "height", "options"))
def render_sample(
    ds: DeviceScene,
    camera: Camera,
    uniforms,
    width: int,
    height: int,
    options: RenderOptions,
):
    """One full sample of every pixel: raygen + path trace.  Returns
    (H*W, 3) radiance — the jitted hot path of the progressive loop."""
    o, d = generate_rays(camera, width, height, uniforms)
    if options.aov != "beauty":
        return trace_aov(ds, o, d, options)
    return trace_paths(ds, o, d, uniforms, options)
