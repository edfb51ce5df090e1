"""Sharded rendering tests on the 8-device virtual CPU mesh (SURVEY §4.5-6).

* sharded render == single-device render, bitwise-comparable accumulation
  (shard-invariant RNG);
* training step runs, reduces loss, keeps params replicated.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from caitlyn.core.types import RenderOptions
from caitlyn.parallel.mesh import make_mesh
from caitlyn.parallel.render import (
    gather_image,
    init_sharded_state,
    padded_pixels,
    sharded_render_step,
    sharded_train_step,
)
from caitlyn.render import progressive
from caitlyn.scene import upload_scene

@pytest.mark.slow
def test_sharded_matches_single_device(cornell, eight_devices):
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=2)
    mesh = make_mesh(eight_devices, shape=(4, 2))

    # Sharded: 1 step with sp=2 adds sample streams 0 and 1.
    st_sh = init_sharded_state(mesh, w, h, seed=5)
    st_sh = sharded_render_step(ds, camera, st_sh, mesh, w, h, options)

    # Single device: 2 progressive steps (streams 0 then 1).
    st_1 = progressive.init_state(w, h, seed=5)
    st_1 = progressive.render_step(ds, camera, st_1, w, h, options)
    st_1 = progressive.render_step(ds, camera, st_1, w, h, options)

    n = w * h
    acc_sh = np.asarray(st_sh.accum)[:n]
    acc_1 = np.asarray(st_1.accum)
    np.testing.assert_allclose(acc_sh, acc_1, rtol=1e-5, atol=1e-6)

    img = gather_image(st_sh, w, h, options, sp=2)
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all()


def test_padding(eight_devices):
    mesh = make_mesh(eight_devices, shape=(8, 1))
    # 10x10 = 100 pixels does not divide 8 → padded to 104.
    assert padded_pixels(10, 10, 8) == 104
    st = init_sharded_state(mesh, 10, 10)
    assert st.accum.shape == (104, 3)


@pytest.mark.slow
def test_sharded_train_step_reduces_loss(cornell, eight_devices):
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 8
    options = RenderOptions(width=w, height=h, max_depth=1)
    mesh = make_mesh(eight_devices, shape=(4, 2))
    n_pad = padded_pixels(w, h, 4)

    # Target: render with the true albedo; params start perturbed.
    st = init_sharded_state(mesh, w, h, seed=7)
    st = sharded_render_step(ds, camera, st, mesh, w, h, options)
    target = st.accum / 2.0  # sp=2 streams accumulated

    true_albedo = ds.scene.materials.albedo
    params = {
        "albedo": true_albedo.at[:, :3].mul(0.5),
        "cam_position": jnp.asarray(camera.position),
    }
    key = jax.random.PRNGKey(11)
    losses = []
    for i in range(4):
        params, loss = sharded_train_step(
            params, ds, camera, target, key, jnp.int32(i), mesh, w, h, options,
            lr=2.0,
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # Params replicated (single logical value).
    assert params["albedo"].shape == true_albedo.shape


@pytest.mark.slow
def test_config5_disney_camera_recovery(cornell, eight_devices):
    """BASELINE config #5: recover Disney BSDF + camera parameters from a
    target image with multi-device sharded rays (r2 verdict #7 — no more
    albedo/camera hardcode in sharded_train_step).

    Perturbations are sized to the 12x12 probe resolution: the camera
    moves ~1 pixel footprint (0.4 scene units) and the Disney floor's
    roughness is off by 0.4 — both leave a strong signal over the 1-spp
    MC noise floor; the loss itself plateaus at that noise floor, so the
    assertions are on parameter recovery."""
    from caitlyn.core.types import MaterialType, make_camera
    from caitlyn.io.builtin_scenes import cornell_box

    scene, _ = cornell_box(floor_type=MaterialType.DISNEY, with_boxes=False)
    pos = np.array([2.78, 2.73, 7.5], np.float32)
    camera = make_camera(pos, pos + np.array([0, -0.2, -1.0], np.float32), 40.0)
    ds = upload_scene(scene, accel="bvh2")
    w = h = 12
    options = RenderOptions(width=w, height=h, max_depth=2)
    mesh = make_mesh(eight_devices, shape=(4, 2))

    # Ground-truth target from the true params (2 sharded samples).
    st = init_sharded_state(mesh, w, h, seed=11)
    st = sharded_render_step(ds, camera, st, mesh, w, h, options)
    target = st.accum / mesh.shape["sp"]

    true_disney = np.asarray(ds.scene.materials.disney)
    floor = (
        np.asarray(ds.scene.materials.albedo[:, 3])
        == int(MaterialType.DISNEY)
    )
    pert = true_disney.copy()
    pert[floor, 0] = np.clip(pert[floor, 0] + 0.4, 0.02, 0.98)
    cam_off = np.array([0.4, 0.0, 0.0], np.float32)
    params = {
        "disney": jnp.asarray(pert),
        "cam_position": jnp.asarray(camera.position + cam_off),
    }
    key = jax.random.PRNGKey(3)
    losses = []
    for i in range(20):
        params, loss = sharded_train_step(
            params, ds, camera, target, key, jnp.int32(i), mesh, w, h,
            options, lr=2e-2,
        )
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    cam_err = np.linalg.norm(np.asarray(params["cam_position"]) - pos)
    assert cam_err < 0.3, cam_err  # started at 0.4
    r_err = np.abs(
        np.asarray(params["disney"])[floor, 0] - true_disney[floor, 0]
    ).max()
    # Roughness converges more slowly than camera (its gradient rides on
    # the diffuse retro/sheen terms at this view): assert clear movement
    # toward the truth; full convergence is the CLI optimizer's job with
    # a real step budget (cli.py optimize).
    assert r_err < 0.37, r_err  # started at 0.4
