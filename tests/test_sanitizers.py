"""Numerical sanitizer + scene validation (SURVEY §5 failure detection).

The reference prints-and-continues on malformed assets
(`Scene.h:510-511,746-747`) and has no numeric guards; this framework
fails fast with located errors.
"""

import numpy as np
import jax
import pytest

from caitlyn.core.types import RenderOptions, make_camera
from caitlyn.io.builtin_scenes import cornell_box
from caitlyn.render import sampling
from caitlyn.scene import upload_scene, validate_scene
from caitlyn.utils.debug import checked_render_sample


def _cam():
    pos = np.array([2.8, 2.75, 13.18], np.float32)
    return make_camera(pos, pos + np.array([0, 0, -1], np.float32), 40.0)


def test_checked_render_clean_scene_passes():
    scene, _ = cornell_box()
    ds = upload_scene(scene, accel="bvh2")
    options = RenderOptions(width=8, height=8, max_depth=2)
    uni = sampling.draw_uniforms(jax.random.PRNGKey(0), 64, 2)
    out = checked_render_sample(ds, _cam(), uni, 8, 8, options)
    assert np.isfinite(np.asarray(out)).all()


def test_checked_render_catches_nan_materials():
    """A NaN smuggled into a material must raise a located error, not a
    silently-poisoned accumulation."""
    scene, _ = cornell_box()
    ds = upload_scene(scene, accel="bvh2")
    # poison on-device state AFTER upload/validation (validate_scene would
    # have caught it host-side; this exercises the runtime guard)
    mats = ds.scene.materials
    bad = mats._replace(albedo=mats.albedo.at[0, 0].set(np.nan))
    ds = ds._replace(scene=ds.scene._replace(materials=bad))
    options = RenderOptions(width=8, height=8, max_depth=2)
    uni = sampling.draw_uniforms(jax.random.PRNGKey(0), 64, 2)
    with pytest.raises(Exception, match="non-finite radiance"):
        checked_render_sample(ds, _cam(), uni, 8, 8, options)


def test_validate_scene_rejects_bad_indices():
    scene, _ = cornell_box()
    tv = np.asarray(scene.tri_v).copy()
    tv[3, 1] = len(np.asarray(scene.vertices)) + 7  # out of range
    with pytest.raises(ValueError, match="out of range"):
        upload_scene(scene._replace(tri_v=tv), accel="bvh2")


def test_validate_scene_rejects_nan_vertices():
    scene, _ = cornell_box()
    v = np.asarray(scene.vertices).copy()
    v[5, 2] = np.nan
    with pytest.raises(ValueError, match="non-finite vertex"):
        upload_scene(scene._replace(vertices=v), accel="bvh2")


def test_validate_scene_rejects_bad_material_index():
    scene, _ = cornell_box()
    tv = np.asarray(scene.tri_v).copy()
    tv[0, 3] = 99
    with pytest.raises(ValueError, match="material indices"):
        validate_scene(scene._replace(tri_v=tv))
