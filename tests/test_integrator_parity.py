"""Device integrator ≡ CPU oracle parity (BASELINE config #1 and beyond).

The north-star correctness requirement: "renders and pixel gradients must
match a CPU reference of the shader math allclose" (BASELINE.json).  Both
integrators consume the *same* uniform numbers, so agreement is per-pixel
deterministic — no statistical tolerance needed beyond float reassociation.
"""

import numpy as np
import jax
import pytest

pytestmark = pytest.mark.slow  # oracle renders: the heavy parity tier
import jax.numpy as jnp

from caitlyn.core.types import MaterialType, RenderOptions
from caitlyn.cpu_reference import integrator as oracle
from caitlyn.render import sampling
from caitlyn.render.integrator import render_sample
from caitlyn.scene import upload_scene


def _parity(scene_np, camera, w, h, depth, accel, seed=0, atol=2e-3):
    ds = upload_scene(scene_np, accel=accel)
    options = RenderOptions(width=w, height=h, max_depth=depth, accel=accel)
    key = jax.random.PRNGKey(seed)
    uniforms = np.asarray(sampling.draw_uniforms(key, w * h, depth))

    img_oracle = oracle.render(scene_np, camera, w, h, uniforms, max_depth=depth)
    img_dev = np.asarray(
        render_sample(ds, camera, jnp.asarray(uniforms), w, h, options)
    ).reshape(h, w, 3)

    # Pixels whose paths graze triangle edges can resolve to a different
    # (tied) triangle under reordered float ops; allow a tiny fraction of
    # outliers and compare everything else elementwise.
    diff = np.abs(img_dev - img_oracle)
    bad = (diff > atol + 0.05 * np.abs(img_oracle)).any(axis=-1)
    frac_bad = bad.mean()
    assert frac_bad < 0.01, f"{accel}: {frac_bad:.2%} mismatching pixels"
    # And means agree tightly.
    np.testing.assert_allclose(img_dev.mean(), img_oracle.mean(), rtol=5e-3)


def test_config1_cornell_64_direct(cornell):
    """BASELINE config #1: cornell 64×64, 1 bounce, BVH, diffuse."""
    scene, camera = cornell
    _parity(scene, camera, 64, 64, 1, "bvh2")


def test_cornell_brute_vs_bvh_depth3(cornell):
    scene, camera = cornell
    _parity(scene, camera, 32, 32, 3, "brute", seed=1)
    _parity(scene, camera, 32, 32, 3, "bvh2", seed=1)


def test_parity_specular_scene():
    from caitlyn.core.types import make_camera
    from caitlyn.io.builtin_scenes import cornell_box

    scene, _ = cornell_box(floor_type=MaterialType.MIRROR)
    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, -0.3, -1.0], np.float32), 40.0)
    _parity(scene, camera, 32, 32, 3, "bvh2", seed=2)


def test_progressive_accumulation_matches_mean(cornell):
    """Progressive N-sample accumulation == mean of N independent samples."""
    from caitlyn.render import progressive

    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=2)
    state = progressive.init_state(w, h, seed=3)
    imgs = []
    for s in range(3):
        key = sampling.sample_key(state.base_key, jnp.int32(s))
        uniforms = sampling.pixel_uniforms(key, jnp.arange(w * h, dtype=jnp.int32), 2)
        imgs.append(np.asarray(render_sample(ds, camera, uniforms, w, h, options)))
        state = progressive.render_step(ds, camera, state, w, h, options)
    acc = np.asarray(state.accum)
    np.testing.assert_allclose(acc, np.sum(imgs, axis=0), rtol=1e-5, atol=1e-5)
    assert int(state.frame_count) == 3
    # Resolve produces a valid display image.
    img = np.asarray(progressive.resolve(state, w, h, options))
    assert img.shape == (h, w, 3)
    assert (img >= 0).all() and (img <= 1).all()
    # Reset clears.
    state2 = progressive.reset(state)
    assert int(state2.frame_count) == 0
    assert np.asarray(state2.accum).sum() == 0
