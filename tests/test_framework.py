"""Framework surface: tiled == untiled, checkpoint/resume, config, CLI."""

import pytest
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from caitlyn.core.types import RenderOptions
from caitlyn.render import progressive
from caitlyn.render.tiled import render_image_tiled, render_tile, tile_grid
from caitlyn.scene import upload_scene
from caitlyn.utils import checkpoint, config, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tile_grid_covers():
    tiles = list(tile_grid(100, 60, 3, 2))
    cover = np.zeros((60, 100), np.int32)
    for t in tiles:
        cover[t.y0 : t.y0 + t.h, t.x0 : t.x0 + t.w] += 1
    assert (cover == 1).all()


@pytest.mark.slow
def test_tiled_equals_untiled(cornell):
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 24
    options = RenderOptions(width=w, height=h, max_depth=2, num_tiles_x=3, num_tiles_y=2)
    img_tiled = render_image_tiled(ds, camera, options, spp=2, seed=9)

    options1 = options._replace(num_tiles_x=1, num_tiles_y=1)
    state = progressive.init_state(w, h, seed=9)
    for _ in range(2):
        state = progressive.render_step(ds, camera, state, w, h, options1)
    img_prog = np.asarray(progressive.resolve(state, w, h, options1))
    # Same global-pixel-keyed uniforms ⇒ identical samples.
    np.testing.assert_allclose(img_tiled, img_prog, rtol=1e-5, atol=1e-6)


def test_checkpoint_roundtrip(cornell, tmp_path):
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 8
    options = RenderOptions(width=w, height=h, max_depth=1)
    state = progressive.init_state(w, h, seed=4)
    state = progressive.render_step(ds, camera, state, w, h, options)

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_render_state(path, state)
    state2 = checkpoint.load_render_state(path)
    np.testing.assert_array_equal(np.asarray(state.accum), np.asarray(state2.accum))
    assert int(state2.frame_count) == 1

    # Resuming continues the exact sample sequence.
    a = progressive.render_step(ds, camera, state, w, h, options)
    b = progressive.render_step(ds, camera, state2, w, h, options)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))


def test_params_checkpoint(tmp_path):
    p = {"albedo": jnp.ones((4, 4)), "cam_position": jnp.zeros(3)}
    path = str(tmp_path / "params.npz")
    checkpoint.save_params(path, p, extra={"step": np.int32(7)})
    p2, extra = checkpoint.load_params(path)
    assert set(p2) == {"albedo", "cam_position"}
    np.testing.assert_array_equal(np.asarray(p2["albedo"]), np.ones((4, 4)))
    assert int(extra["step"]) == 7


def test_config_loading(tmp_path):
    cfg_path = os.path.join(REPO, "scenes", "cornell.toml")
    cfg = config.load_config(cfg_path)
    scene, translation = config.scene_from_config(cfg)
    camera = config.camera_from_config(cfg, translation)
    options = config.options_from_config(cfg, width=32)
    assert scene.num_triangles > 0
    assert options.width == 32 and options.height == 256
    assert options.accel == "auto"
    assert abs(float(camera.fov) - np.deg2rad(40)) < 1e-6


def test_metrics_records():
    from caitlyn.accel.bvh import build_bvh
    from caitlyn.io.builtin_scenes import cornell_box

    scene, _ = cornell_box()
    bvh = build_bvh(scene.vertices, scene.tri_v)
    rec = metrics.bvh_build_stats(bvh)
    assert rec["nodes"] > 0 and rec["sah_cost"] > 0
    timer = metrics.StepTimer()
    with timer.span("x"):
        pass
    timer.count("rays", 10)
    s = timer.summary()
    assert "x" in s and s["rays"] == 10


@pytest.mark.slow
def test_cli_render_smoke(tmp_path):
    out = str(tmp_path / "out.png")
    r = subprocess.run(
        [
            sys.executable, "-m", "caitlyn.cli", "render",
            os.path.join(REPO, "scenes", "cornell.toml"),
            "-o", out, "--spp", "2", "--width", "8", "--height", "8", "--depth", "1",
            "--accel", "bvh2",
        ],
        cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    from caitlyn.io.image import load_png

    img = load_png(out)
    assert img.shape == (8, 8, 3)
    assert img.max() > 0


def test_render_steps_bitwise_equals_single_steps(cornell):
    """The scan-batched progressive launch (render_steps) must be bitwise
    identical to the same number of single render_step calls — same
    frame_count-derived key schedule, just one dispatch."""
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=2)

    s1 = progressive.init_state(w, h, seed=3)
    for _ in range(3):
        s1 = progressive.render_step(ds, camera, s1, w, h, options)

    s2 = progressive.init_state(w, h, seed=3)
    s2 = progressive.render_steps(ds, camera, s2, w, h, options, 3)

    assert int(s2.frame_count) == 3
    np.testing.assert_array_equal(np.asarray(s1.accum), np.asarray(s2.accum))
