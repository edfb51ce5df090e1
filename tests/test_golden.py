"""Golden-image regression (SURVEY §4.3).

scenes/golden/cornell_700.png is the human-eyeball artifact: 700², 512
spp, 3 bounces, the reference demo conditions (`README.md:4-10`, camera
`Scene.h:468`), committed each round so drift is visible in review.

The CI check compares a fresh 64²/48-spp render (same camera, same seed,
same integrator) against the committed CPU golden — the render is
deterministic (threefry keyed by pixel id), so any change beyond float
reassociation noise is a real behavior change and must be accompanied by
a regenerated golden (python the block in scenes/golden/README applies).
"""

import os

import numpy as np
import jax

from caitlyn.core.types import RenderOptions
from caitlyn.io.builtin_scenes import builtin_camera, cornell_box
from caitlyn.render import progressive
from caitlyn.scene import scene_families, upload_scene

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scenes", "golden", "cornell_64_cpu.npz",
)


def test_cornell_matches_committed_golden():
    golden = np.load(GOLDEN)["img"]
    scene, _ = cornell_box()
    camera = builtin_camera("cornell")
    ds = upload_scene(scene, accel="bvh2")
    options = RenderOptions(
        width=64, height=64, max_depth=3, accel="bvh2",
        families=scene_families(scene),
    )
    img, _ = progressive.render_image(ds, camera, options, spp=48, seed=0)
    img = np.asarray(img)
    assert img.shape == golden.shape
    # Deterministic sampler ⇒ near-bitwise on the same platform; the
    # loose-ish ceiling absorbs cross-XLA-version reassociation only.
    err = np.abs(img - golden)
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    # sanity on content: red wall left, green wall right, lit ceiling
    assert img[32, 4, 0] > img[32, 4, 1]  # left wall red-dominant
    assert img[32, 60, 1] > img[32, 60, 0]  # right wall green-dominant
