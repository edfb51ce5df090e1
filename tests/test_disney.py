"""Disney BSDF: sampling/eval/pdf consistency, energy, integrator parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from caitlyn.core.types import MaterialType, RenderOptions
from caitlyn.cpu_reference import bsdf as nbsdf
from caitlyn.ops import bsdf as jbsdf


def _params(n, **kw):
    d = dict(
        base_color=np.full((n, 3), 0.8, np.float32),
        roughness=np.full(n, 0.5, np.float32),
        metallic=np.zeros(n, np.float32),
        spec_tint=np.zeros(n, np.float32),
        sheen=np.zeros(n, np.float32),
        clearcoat=np.zeros(n, np.float32),
        clearcoat_gloss=np.ones(n, np.float32),
        subsurface=np.zeros(n, np.float32),
        ior=np.full(n, 1.5, np.float32),
    )
    d.update({k: np.asarray(v, np.float32) for k, v in kw.items()})
    return nbsdf.DisneyParams(**d)


def _sphere_dirs(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_pdf_integrates_to_one():
    """MC estimate of ∫ pdf dω over the sphere ≈ 1 for several param sets."""
    n = 200_000
    l = _sphere_dirs(n, 0)
    normal = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    view = np.tile(
        np.array([[0.3, 0.1, 0.95]], np.float32) / np.linalg.norm([0.3, 0.1, 0.95]),
        (n, 1),
    )
    for kw in (
        {},
        # (sharper lobes than 0.3 can't be resolved by uniform-sphere MC)
        dict(roughness=np.full(n, 0.3), metallic=np.full(n, 1.0)),
        dict(clearcoat=np.full(n, 1.0)),
        dict(roughness=np.full(n, 0.9)),
    ):
        p = _params(n, **kw)
        _, pdf = nbsdf.eval_pdf(p, normal, view, l)
        integral = pdf.mean() * 4.0 * np.pi  # uniform-sphere MC
        assert 0.93 < integral < 1.07, (kw, integral)


def test_sample_eval_consistency():
    """sample() must return exactly eval_pdf() at the sampled direction,
    and jnp/numpy twins must agree."""
    n = 4096
    rng = np.random.default_rng(1)
    normal = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    view = _sphere_dirs(n, 2)
    view[:, 2] = np.abs(view[:, 2]) + 0.1
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    u_lobe, u1, u2 = rng.random((3, n)).astype(np.float32)
    # roughness >= 0.2: near-delta GGX lobes amplify f32 direction noise
    # into unbounded relative f error — the float-precision twin comparison
    # is only meaningful away from that chaos.
    p = _params(
        n,
        roughness=0.2 + 0.8 * rng.random(n),
        metallic=rng.random(n),
        clearcoat=rng.random(n),
        sheen=rng.random(n),
    )
    l_np, f_np, pdf_np = nbsdf.sample(p, normal, view, u_lobe, u1, u2)
    f2, pdf2 = nbsdf.eval_pdf(p, normal, view, l_np)
    np.testing.assert_allclose(f_np, f2, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pdf_np, pdf2, rtol=1e-5, atol=1e-7)

    jp = jbsdf.DisneyParams(*[jnp.asarray(x) for x in p])
    l_j, f_j, pdf_j = jax.jit(jbsdf.sample)(
        jp, jnp.asarray(normal), jnp.asarray(view),
        jnp.asarray(u_lobe), jnp.asarray(u1), jnp.asarray(u2),
    )
    # A tiny fraction of lanes sits exactly on a lobe-selection boundary
    # where f32 (jax) vs f64-promoted (numpy) arithmetic flips the pick;
    # everything else must agree tightly.
    same_dir = np.isclose(np.asarray(l_j), l_np, rtol=2e-4, atol=2e-5).all(axis=-1)
    assert same_dir.mean() > 0.995, same_dir.mean()
    np.testing.assert_allclose(
        np.asarray(f_j)[same_dir], f_np[same_dir], rtol=6e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(pdf_j)[same_dir], pdf_np[same_dir], rtol=6e-3, atol=1e-4
    )


def test_energy_conservation():
    """White-furnace bound: ∫ f dω ≤ ~1 for a white, rough material
    (f is cos-premultiplied, so the plain MC mean * 4π bounds albedo)."""
    n = 200_000
    l = _sphere_dirs(n, 3)
    normal = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    view = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    p = _params(n, base_color=np.ones((n, 3), np.float32), roughness=np.full(n, 0.8))
    f, _ = nbsdf.eval_pdf(p, normal, view, l)
    integral = f.mean(axis=0) * 4.0 * np.pi
    assert (integral < 1.25).all(), integral  # modest Fresnel overshoot ok
    assert (integral > 0.5).all(), integral


@pytest.mark.slow
def test_integrator_parity_disney(cornell):
    """Config #2 material path: Disney floor, device == oracle."""
    from caitlyn.cpu_reference import integrator as oracle
    from caitlyn.io.builtin_scenes import cornell_box
    from caitlyn.core.types import make_camera
    from caitlyn.render import sampling
    from caitlyn.render.integrator import render_sample
    from caitlyn.scene import upload_scene

    scene, _ = cornell_box(floor_type=MaterialType.DISNEY)
    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, -0.2, -1.0], np.float32), 40.0)
    w = h = 32
    depth = 3
    ds = upload_scene(scene, accel="bvh2")
    options = RenderOptions(width=w, height=h, max_depth=depth)
    uniforms = np.asarray(sampling.draw_uniforms(jax.random.PRNGKey(6), w * h, depth))
    img_o = oracle.render(scene, camera, w, h, uniforms, max_depth=depth)
    img_d = np.asarray(
        render_sample(ds, camera, jnp.asarray(uniforms), w, h, options)
    ).reshape(h, w, 3)
    assert np.isfinite(img_d).all()
    diff = np.abs(img_d - img_o)
    bad = (diff > 3e-3 + 0.05 * np.abs(img_o)).any(axis=-1)
    assert bad.mean() < 0.01, bad.mean()
    np.testing.assert_allclose(img_d.mean(), img_o.mean(), rtol=1e-2)


def test_rough_conductor_renders():
    """A RoughConductor floor produces finite, plausible glossy output."""
    from caitlyn.io.builtin_scenes import cornell_box
    from caitlyn.core.types import make_camera
    from caitlyn.render import progressive
    from caitlyn.scene import upload_scene

    scene, _ = cornell_box(floor_type=MaterialType.ROUGH_CONDUCTOR)
    # rough-conductor family ⇒ metallic=1 applied at parse/build time
    m = scene.materials
    floor_rows = m.albedo[:, 3] == int(MaterialType.ROUGH_CONDUCTOR)
    if floor_rows.any():
        d = np.asarray(m.disney)
        d[floor_rows, 1] = 1.0
        scene = scene._replace(materials=m._replace(disney=d))
    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, -0.3, -1.0], np.float32), 40.0)
    ds = upload_scene(scene, accel="bvh2")
    options = RenderOptions(width=16, height=16, max_depth=3)
    img, _ = progressive.render_image(ds, camera, options._replace(width=16, height=16), spp=4)
    arr = np.asarray(img)
    assert np.isfinite(arr).all()
    assert arr.max() > 0.05
