"""Sanity tests for the CPU reference integrator and scene loader."""

import pytest
import numpy as np

from caitlyn.cpu_reference import integrator as oracle
from caitlyn.core.types import MaterialType


def test_scene_load(cornell):
    scene, camera = cornell
    assert scene.num_triangles > 0
    # Cornell box: emissive material exists and produced lights.
    assert scene.lights.count >= 1
    assert scene.materials.count >= 4
    # Scene translated so bbox min is at the origin (Scene.h:915-925).
    np.testing.assert_allclose(scene.vertices.min(axis=0), 0.0, atol=1e-5)
    # Light pdf normalized.
    np.testing.assert_allclose(scene.lights.area_pdf[:, 1].sum(), 1.0, rtol=1e-5)
    # Every emissive triangle knows its light row.
    li = scene.tri_vt[:, 3]
    emissive_mtl = scene.materials.emission[scene.tri_v[:, 3], 3] != -1
    assert (li[emissive_mtl] >= 0).all()
    assert (li[~emissive_mtl] == -1).all()


def test_brute_force_hits_walls(cornell):
    scene, camera = cornell
    n = 16 * 16
    uniforms = np.full((n, oracle.uniforms_per_sample(1)), 0.5, np.float32)
    o, d = oracle.generate_rays(camera, 16, 16, uniforms)
    t, tri, u, v = oracle.intersect_brute(scene, o, d)
    # Looking into the box: everything hits.
    assert (tri >= 0).all()
    assert np.isfinite(t).all()
    assert (t > 0).all()
    # Barycentrics valid at the accepted hit.
    assert (u >= -1e-5).all() and (v >= -1e-5).all() and (u + v <= 1 + 1e-4).all()


@pytest.mark.slow
def test_render_direct_light(cornell):
    scene, camera = cornell
    w = h = 32
    rng = np.random.default_rng(0)
    depth = 2
    img = np.zeros((h, w, 3), np.float32)
    spp = 8
    for s in range(spp):
        uniforms = rng.random((w * h, oracle.uniforms_per_sample(depth)), np.float32)
        img += oracle.render(scene, camera, w, h, uniforms, max_depth=depth)
    img /= spp
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    # The ceiling light must be directly visible: some pixels at emission level.
    assert img.max() > 1.0
    # Indirect+direct light must make the scene mostly non-black.
    assert (img.sum(axis=-1) > 0).mean() > 0.5


@pytest.mark.slow
def test_white_furnace_energy():
    """A closed white (albedo 1) sphere-ish box with a light: radiance must
    stay finite and the physically-correct NEE must not gain energy
    unboundedly across depths (regression for the reference's missing
    cos/pi factor, which this framework corrects)."""
    from caitlyn.io.builtin_scenes import cornell_box

    scene, translation = cornell_box(albedo=(1.0, 1.0, 1.0))
    from caitlyn.core.types import make_camera

    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, 0, -1.0], np.float32), 40.0)
    rng = np.random.default_rng(1)
    w = h = 16
    vals = []
    for depth in (2, 4):
        acc = np.zeros((h, w, 3), np.float32)
        for s in range(16):
            uniforms = rng.random((w * h, oracle.uniforms_per_sample(depth)), np.float32)
            acc += oracle.render(scene, camera, w, h, uniforms, max_depth=depth)
        vals.append(acc.mean() / 16)
    # More bounces add energy, but boundedly (geometric series, not blowup).
    assert vals[1] > vals[0]
    assert vals[1] < vals[0] * 3.0


@pytest.mark.slow
def test_mirror_material():
    """A mirror floor must reflect the light (specular path carries Le)."""
    from caitlyn.io.builtin_scenes import cornell_box
    from caitlyn.core.types import make_camera

    scene, _ = cornell_box(floor_type=MaterialType.MIRROR)
    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, -0.35, -1.0], np.float32), 40.0)
    rng = np.random.default_rng(2)
    w = h = 24
    acc = np.zeros((h, w, 3), np.float32)
    for s in range(8):
        uniforms = rng.random((w * h, oracle.uniforms_per_sample(3)), np.float32)
        acc += oracle.render(scene, camera, w, h, uniforms, max_depth=3)
    acc /= 8
    assert np.isfinite(acc).all()
    # The mirrored light shows up somewhere in the lower half of the frame.
    assert acc.max() > 0.5
