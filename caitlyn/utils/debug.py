"""Numerical sanitizers (SURVEY §5 race-detection/sanitizer plan).

The reference's only "sanitizer" is the GL driver's grace (its
accumulation pass reads a texture it is simultaneously rendering,
`Scene.h:1188-1230`).  JAX's functional state kills that bug class
structurally; what remains worth guarding is NUMERICS: a NaN born in one
bounce silently poisons the whole progressive accumulation (and, in the
inverse renderer, Adam's moments — see the glass-branch backward fix in
render/integrator.py).

`checked_render_sample` is the fail-fast harness: it runs one sample
under `checkify` and throws a located error if any radiance value is
non-finite.  The CLI exposes it as `render --debug-checks` (validates the
first sample before committing to the full accumulation); tests use it
directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def checked_render_sample(ds, camera, uniforms, width: int, height: int, options):
    """Render one sample with a finite-radiance check; raises
    `jax.experimental.checkify.JaxRuntimeError`-style ValueError via
    `err.throw()` when any output value is NaN/inf.  Returns the radiance
    when clean."""
    from jax.experimental import checkify

    from caitlyn.render.integrator import render_sample

    # Render first, checkify only the OUTPUT predicate: checkify threads
    # its error state through every sub-jaxpr, which a foreign kernel call
    # (the CUDA traversal) cannot carry — the renderer itself stays
    # outside the transform.
    out = render_sample(ds, camera, uniforms, width, height, options)

    def g(x):
        checkify.check(
            jnp.isfinite(x).all(),
            "non-finite radiance in render_sample output "
            "(NaN/inf born in shading or traversal)",
        )
        return x

    err, _ = jax.jit(checkify.checkify(g))(out)
    err.throw()
    return out
