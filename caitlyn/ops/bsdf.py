"""Disney-family BSDF: eval / sample / pdf (device, jnp, differentiable).

The reference README declares "Disney BSDF" (`/root/reference/README.md:23`)
and reserves 18 material types (`Scene.h:111-133`), but the snapshot's
shaders implement Lambert only (SURVEY.md snapshot caveat #1) — so this
module is built to the *capability spec*: the Burley 2012 Disney BRDF
(principled diffuse + retro, sheen, GGX specular with metallic workflow,
GTR1 clearcoat) with a proper sample/eval/pdf triple so MIS stays correct.

Conventions: n is the (flipped-toward-viewer) shading normal, v points
*away* from the surface toward the viewer (v = -ray.d), l points away
toward the light.  All functions are batched over rays.

Parameter block per ray (gathered from Materials rows):
  base_color (N,3); roughness, metallic, spec_tint, sheen  (disney row)
  clearcoat, clearcoat_gloss, subsurface, anisotropic      (disney2 row)
  ior (specular row w)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from caitlyn.core import math as cm


class DisneyParams(NamedTuple):
    base_color: jnp.ndarray  # (N, 3)
    roughness: jnp.ndarray  # (N,)
    metallic: jnp.ndarray
    spec_tint: jnp.ndarray
    sheen: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_gloss: jnp.ndarray
    subsurface: jnp.ndarray
    ior: jnp.ndarray


def params_from_materials(mats, mtl, base_color):
    """Gather per-ray Disney parameters (base_color may be texture-modulated
    upstream, so it is passed separately)."""
    d1 = mats.disney[mtl]
    d2 = mats.disney2[mtl]
    return DisneyParams(
        base_color=base_color,
        roughness=jnp.clip(d1[:, 0], 0.02, 1.0),
        metallic=d1[:, 1],
        spec_tint=d1[:, 2],
        sheen=d1[:, 3],
        clearcoat=d2[:, 0],
        clearcoat_gloss=d2[:, 1],
        subsurface=d2[:, 2],
        ior=jnp.maximum(mats.specular[mtl, 3], 1.01),
    )


def _schlick(m):
    m = jnp.clip(1.0 - m, 0.0, 1.0)
    return m**5


def _gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / jnp.maximum(jnp.pi * t * t, 1e-12)


def _gtr1(ndh, a):
    a2 = jnp.clip(a * a, 1e-4, 0.9999)
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    # log(a2) < 0 and t > 0, so the denominator is strictly negative —
    # guard toward -inf side to preserve the sign.
    return (a2 - 1.0) / jnp.minimum(jnp.pi * jnp.log(a2) * t, -1e-12)


def _smith_g_ggx(ndv, a):
    a2 = a * a
    b = ndv * ndv
    return 1.0 / jnp.maximum(ndv + jnp.sqrt(a2 + b - a2 * b), 1e-8)


def _tint(base_color):
    lum = cm.luminance(base_color)
    return jnp.where(
        (lum > 0)[:, None], base_color / jnp.maximum(lum[:, None], 1e-8), jnp.ones_like(base_color)
    )


def _spec_f0(p: DisneyParams):
    f0_scalar = ((p.ior - 1.0) / (p.ior + 1.0)) ** 2
    tint = _tint(p.base_color)
    dielectric = f0_scalar[:, None] * (
        (1.0 - p.spec_tint[:, None]) + p.spec_tint[:, None] * tint
    )
    return (
        dielectric * (1.0 - p.metallic[:, None])
        + p.base_color * p.metallic[:, None]
    )


def _lobe_weights(p: DisneyParams):
    """Sampling weights for (diffuse, specular, clearcoat) lobes."""
    w_diff = (1.0 - p.metallic) * cm.luminance(p.base_color)
    w_spec = cm.luminance(_spec_f0(p)) + 0.08
    w_cc = 0.25 * p.clearcoat
    total = jnp.maximum(w_diff + w_spec + w_cc, 1e-8)
    return w_diff / total, w_spec / total, w_cc / total


def eval_pdf(p: DisneyParams, n, v, l):
    """Evaluate the full Disney BRDF and its sampling pdf.

    Returns (f (N,3), pdf (N,)). Zero where l is under the surface."""
    ndv = jnp.maximum(cm.dot(n, v), 1e-6)
    ndl = cm.dot(n, l)
    valid = ndl > 1e-6
    ndl_c = jnp.maximum(ndl, 1e-6)
    h = cm.normalize(v + l)
    ndh = jnp.clip(cm.dot(n, h), 0.0, 1.0)
    ldh = jnp.clip(cm.dot(l, h), 0.0, 1.0)

    a = jnp.maximum(p.roughness * p.roughness, 1e-4)

    # --- diffuse (Burley retro-reflection) + subsurface approx
    fl = _schlick(ndl_c)
    fv = _schlick(ndv)
    fd90 = 0.5 + 2.0 * ldh * ldh * p.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldh * ldh * p.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / jnp.maximum(ndl_c + ndv, 1e-6) - 0.5) + 0.5)
    diff_mix = fd * (1.0 - p.subsurface) + ss * p.subsurface
    f_diffuse = p.base_color / jnp.pi * diff_mix[:, None]

    # --- sheen
    f_sheen = (
        p.sheen[:, None]
        * ((1.0 - p.spec_tint[:, None]) + p.spec_tint[:, None] * _tint(p.base_color))
        * _schlick(ldh)[:, None]
    )

    # --- GGX specular with metallic workflow
    d_spec = _gtr2(ndh, a)
    f0 = _spec_f0(p)
    f_spec_fresnel = f0 + (1.0 - f0) * _schlick(ldh)[:, None]
    g_spec = _smith_g_ggx(ndl_c, a) * _smith_g_ggx(ndv, a)
    f_specular = d_spec[:, None] * f_spec_fresnel * g_spec[:, None] * 0.25
    # (0.25 folds the 1/(4 ndl ndv) into the separable Smith terms above)

    # --- clearcoat (GTR1, fixed F0=0.04, G alpha=0.25)
    a_cc = 0.1 + (0.001 - 0.1) * p.clearcoat_gloss  # lerp(0.1, 0.001, gloss)
    d_cc = _gtr1(ndh, a_cc)
    f_cc = 0.04 + 0.96 * _schlick(ldh)
    g_cc = _smith_g_ggx(ndl_c, 0.25) * _smith_g_ggx(ndv, 0.25)
    f_clearcoat = (0.25 * p.clearcoat * d_cc * f_cc * g_cc)[:, None] * 0.25

    f = (
        (f_diffuse + f_sheen) * (1.0 - p.metallic[:, None])
        + f_specular
        + f_clearcoat
    ) * ndl_c[:, None]
    # NOTE: f returned PRE-multiplied by cos(theta_l) — the integrator uses
    # f directly in  L += T * Le * f * w / pdf_light  and  T *= f / pdf.

    # --- pdf: lobe mixture
    w_diff, w_spec, w_cc = _lobe_weights(p)
    pdf_diff = ndl_c / jnp.pi
    pdf_spec = d_spec * ndh / jnp.maximum(4.0 * ldh, 1e-8)
    pdf_cc = d_cc * ndh / jnp.maximum(4.0 * ldh, 1e-8)
    pdf = w_diff * pdf_diff + w_spec * pdf_spec + w_cc * pdf_cc

    f = jnp.where(valid[:, None], f, 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return f, pdf


def _sample_ggx_h(n, a, u1, u2):
    """Sample a GTR2 (GGX) half-vector around n (NDF sampling)."""
    phi = 2.0 * jnp.pi * u1
    ct2 = (1.0 - u2) / jnp.maximum(1.0 + (a * a - 1.0) * u2, 1e-12)
    # sqrt has an infinite derivative at 0; a ct2 of exactly 0 or 1 turns
    # an UNSELECTED jnp.where branch into 0*inf = NaN in the backward
    # (observed optimizing Disney roughness: the light material's
    # degenerate row NaN'd the whole disney gradient).  Clamp strictly
    # inside (0, 1) — the 1e-12 shift is far below sampling resolution.
    ct = jnp.sqrt(jnp.clip(ct2, 1e-12, 1.0 - 1e-12))
    st = jnp.sqrt(jnp.clip(1.0 - ct2, 1e-12, 1.0 - 1e-12))
    local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    return cm.local_to_world(local, n)


def _sample_gtr1_h(n, a, u1, u2):
    a2 = jnp.clip(a * a, 1e-4, 0.9999)
    phi = 2.0 * jnp.pi * u1
    ct2 = (1.0 - jnp.power(a2, 1.0 - u2)) / jnp.maximum(1.0 - a2, 1e-8)
    ct = jnp.sqrt(jnp.clip(ct2, 1e-12, 1.0 - 1e-12))
    st = jnp.sqrt(jnp.clip(1.0 - ct2, 1e-12, 1.0 - 1e-12))
    local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    return cm.local_to_world(local, n)


def sample(p: DisneyParams, n, v, u_lobe, u1, u2):
    """Sample an outgoing direction from the Disney BRDF.

    Returns (l, f, pdf): the sampled direction, the (cos-premultiplied)
    BRDF value and the mixture pdf — f and pdf evaluated with `eval_pdf`
    so MIS weights are consistent by construction.
    """
    w_diff, w_spec, w_cc = _lobe_weights(p)
    a = jnp.maximum(p.roughness * p.roughness, 1e-4)
    a_cc = 0.1 + (0.001 - 0.1) * p.clearcoat_gloss

    # diffuse: cosine hemisphere
    l_diff = cm.local_to_world(cm.cosine_hemisphere_dir(u1, u2), n)
    # specular: reflect v about a GGX half-vector
    h_spec = _sample_ggx_h(n, a, u1, u2)
    l_spec = cm.reflect(-v, h_spec)
    # clearcoat: GTR1 half-vector
    h_cc = _sample_gtr1_h(n, a_cc, u1, u2)
    l_cc = cm.reflect(-v, h_cc)

    pick_spec = (u_lobe >= w_diff) & (u_lobe < w_diff + w_spec)
    pick_cc = u_lobe >= (w_diff + w_spec)
    l = jnp.where(
        pick_cc[:, None], l_cc, jnp.where(pick_spec[:, None], l_spec, l_diff)
    )
    l = cm.normalize(l)
    f, pdf = eval_pdf(p, n, v, l)
    return l, f, pdf
