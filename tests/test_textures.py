"""Texture pipeline: map_Kd parsing → 256² atlas → bilinear shading.

Covers the `map_Kd` → atlas path of the MTL parser (reference analog
`/root/reference/Caitlyn/Scene.h:507-740,1063-1078`), the device bilinear
sampler (`path_trace.fs:471-486` analog, ops/texture.py), and the
textured-albedo layer select in both integrator fetch paths
(`_albedo` and the fused `_albedo_from_rows`).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from caitlyn.core.types import RenderOptions, make_camera
from caitlyn.io.image import save_png
from caitlyn.io.obj import load_obj
from caitlyn.ops.texture import sample_bilinear
from caitlyn.render import sampling
from caitlyn.render.integrator import render_sample
from caitlyn.scene import scene_families, upload_scene


# ---------------------------------------------------------------------------
# sample_bilinear unit tests vs a NumPy oracle
# ---------------------------------------------------------------------------


def _oracle_bilinear(atlas, layer, uv):
    """Straightforward NumPy re-statement of GL_REPEAT bilinear."""
    k, h, w, _ = atlas.shape
    out = np.zeros((len(layer), 3), np.float32)
    for i in range(len(layer)):
        u = uv[i, 0] * w - 0.5
        v = uv[i, 1] * h - 0.5
        x0, y0 = int(np.floor(u)), int(np.floor(v))
        fx, fy = u - x0, v - y0
        x0i, y0i = x0 % w, y0 % h
        x1i, y1i = (x0 + 1) % w, (y0 + 1) % h
        a = atlas[layer[i]]
        top = a[y0i, x0i] * (1 - fx) + a[y0i, x1i] * fx
        bot = a[y1i, x0i] * (1 - fx) + a[y1i, x1i] * fx
        out[i] = top * (1 - fy) + bot * fy
    return out


def test_sample_bilinear_matches_oracle():
    rng = np.random.default_rng(0)
    atlas = rng.random((3, 8, 16, 3)).astype(np.float32)
    layer = rng.integers(0, 3, size=64).astype(np.int32)
    uv = rng.random((64, 2)).astype(np.float32) * 2.0 - 0.5  # exercise wrap
    got = np.asarray(sample_bilinear(jnp.asarray(atlas), jnp.asarray(layer), jnp.asarray(uv)))
    want = _oracle_bilinear(atlas, layer, uv)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sample_bilinear_texel_centers_exact():
    """uv at texel centers → the raw texel value (all bilinear weight on
    one texel)."""
    h = w = 4
    atlas = np.arange(h * w * 3, dtype=np.float32).reshape(1, h, w, 3)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    uv = np.stack(
        [(xs.ravel() + 0.5) / w, (ys.ravel() + 0.5) / h], axis=1
    ).astype(np.float32)
    layer = np.zeros(h * w, np.int32)
    got = np.asarray(sample_bilinear(jnp.asarray(atlas), jnp.asarray(layer), jnp.asarray(uv)))
    want = atlas[0].reshape(-1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sample_bilinear_wraps():
    """GL_REPEAT: uv and uv+1 sample identically."""
    rng = np.random.default_rng(1)
    atlas = jnp.asarray(rng.random((2, 8, 8, 3)).astype(np.float32))
    uv = jnp.asarray(rng.random((32, 2)).astype(np.float32))
    layer = jnp.asarray(rng.integers(0, 2, 32).astype(np.int32))
    a = sample_bilinear(atlas, layer, uv)
    b = sample_bilinear(atlas, layer, uv + 1.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# map_Kd → atlas → shading, end to end through load_obj + the integrator
# ---------------------------------------------------------------------------


OBJ_TEXT = """\
mtllib tex.mtl
v -1 0 0
v  1 0 0
v  1 2 0
v -1 2 0
v -1 0 -3
v  1 0 -3
v  1 2 -3
v -1 2 -3
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl textured
f 1/1 2/2 3/3 4/4
usemtl plain
f 5/1 6/2 7/3 8/4
usemtl lamp
v -0.5 1.9 1.5
v  0.5 1.9 1.5
v  0.0 1.9 2.5
f 9 10 11
"""

MTL_TEXT = """\
newmtl textured
Kd 1 1 1
map_Kd checker.png
newmtl plain
Kd 0.2 0.5 0.8
newmtl lamp
Kd 0 0 0
Ke 10 10 10
"""


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("texscene")
    # 2×2 checker, saved as an 8×8 PNG (texels constant per quadrant so
    # the 256² resize keeps colors exact away from quadrant borders)
    checker = np.zeros((8, 8, 3), np.float32)
    checker[:4, :4] = [1.0, 0.0, 0.0]
    checker[:4, 4:] = [0.0, 1.0, 0.0]
    checker[4:, :4] = [0.0, 0.0, 1.0]
    checker[4:, 4:] = [1.0, 1.0, 0.0]
    save_png(str(d / "checker.png"), checker)
    (d / "tex.mtl").write_text(MTL_TEXT)
    (d / "tex.obj").write_text(OBJ_TEXT)
    scene, translation = load_obj(str(d / "tex.obj"), tex_size=16)
    return scene, translation


def test_map_kd_parsed_into_atlas(textured_scene):
    scene, _ = textured_scene
    assert scene.textures is not None
    assert scene.textures.shape == (1, 16, 16, 3)
    tex_ind = np.asarray(scene.materials.tex_ind)
    # exactly one material carries an atlas layer; the others are -1
    assert (tex_ind[:, 0] >= 0).sum() == 1


def test_textured_first_hit_albedo_matches_checker(textured_scene):
    """AOV albedo of the textured quad shows the checker quadrant colors
    (the `_albedo` fetch path: texcoord interpolation + atlas sample)."""
    scene, translation = textured_scene
    ds = upload_scene(scene, accel="bvh2")
    pos = np.array([0.0, 1.0, 4.0], np.float32) + translation
    camera = make_camera(pos, pos + np.array([0, 0, -1], np.float32), 40.0)
    w = h = 32
    options = RenderOptions(width=w, height=h, max_depth=1, aov="albedo")
    uniforms = sampling.draw_uniforms(jax.random.PRNGKey(0), w * h, 1)
    img = np.asarray(
        render_sample(ds, camera, uniforms, w, h, options)
    ).reshape(h, w, 3)
    # PNG row 0 = texture top; vt v=1 = top.  Sample pixels safely inside
    # each visible quadrant of the quad (quad spans x∈[-1,1], y∈[0,2]).
    # Image row index grows downward AFTER the resolve flip, but
    # render_sample output is bottom-up: row≈h*3/4 looks at quad top half.
    def albedo_at(px, py):
        return img[py, px]

    # center-left vs center-right of the quad at a lower-third height
    left = albedo_at(w // 2 - 6, h // 2 - 5)
    right = albedo_at(w // 2 + 6, h // 2 - 5)
    # quadrant colors differ strongly across the checker's vertical seam
    assert not np.allclose(left, right, atol=0.2), (left, right)
    # every sampled albedo is (approximately) one of the 4 checker colors
    colors = np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32
    )
    for c in (left, right):
        d2 = np.min(((colors - c[None, :]) ** 2).sum(1))
        assert d2 < 0.05, c


def test_uniform_texture_equals_flat_kd(textured_scene):
    """Estimator parity: a CONSTANT-color map_Kd must render exactly like
    the same scene with Kd set to that color and no texture — proves the
    textured path feeds the same albedo into shading (fused
    `_albedo_from_rows` path, small scene)."""
    scene, translation = textured_scene
    gray = np.full((16, 16, 3), 0.5, np.float32)
    sc_tex = scene._replace(textures=np.stack([gray]))
    # untextured twin: same materials but albedo=0.5 and no atlas layer
    mats = scene.materials
    albedo = np.asarray(mats.albedo).copy()
    tex_ind = np.asarray(mats.tex_ind).copy()
    m_tex = int(np.argmax(tex_ind[:, 0] >= 0))
    albedo[m_tex, :3] = 0.5
    tex_ind[m_tex, 0] = -1.0
    sc_flat = scene._replace(
        textures=None,
        materials=mats._replace(albedo=albedo, tex_ind=tex_ind),
    )

    pos = np.array([0.0, 1.0, 4.0], np.float32) + translation
    camera = make_camera(pos, pos + np.array([0, 0, -1], np.float32), 40.0)
    w = h = 24
    imgs = []
    for sc in (sc_tex, sc_flat):
        ds = upload_scene(sc, accel="bvh2")
        options = RenderOptions(
            width=w, height=h, max_depth=2, families=scene_families(sc)
        )
        uniforms = sampling.draw_uniforms(jax.random.PRNGKey(1), w * h, 2)
        imgs.append(
            np.asarray(render_sample(ds, camera, uniforms, w, h, options))
        )
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)
