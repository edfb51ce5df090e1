"""Multi-host distribution: process wiring, host×chip meshes, image assembly.

The reference has no distribution layer (single GL context,
`/root/reference/Caitlyn/Scene.h:1000-1156` is its only device boundary);
this module is the SURVEY §5 "distributed communication backend" plan:
`jax.distributed.initialize` for process wiring, a 2-D (dp × sp) mesh with
the hosts along dp, and `process_allgather` for final image assembly.
Single-process runs (tests, the 8-device virtual CPU mesh, the cards of one
host) take the same code paths with process_count == 1.

Callers: `cli.py render --mesh` drives the sharded render end-to-end;
`benchmarks/run_scaling.py` + tests/test_distributed.py exercise
`scaling_report`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize multi-host JAX.  MUST run before anything queries a
    backend (`jax.devices()`, `jax.process_count()`, any jit) — backend
    queries initialize the local runtime, after which
    `jax.distributed.initialize` cannot wire the job.  This function
    therefore calls `jax.distributed.initialize` FIRST and only then
    touches process_index/process_count.

    With no arguments, initialization is attempted only in environments
    JAX can auto-detect (SLURM, Open MPI — JAX reads their own metadata;
    there are no framework-specific env vars).  Elsewhere a
    no-arg call is a single-process no-op.  Explicit arguments force
    initialization (pass them when hand-wiring a cluster).

    Idempotent: repeat calls return the wired (process_index,
    process_count) without re-initializing.
    """
    global _initialized
    import jax

    explicit = coordinator_address is not None or process_id is not None
    if not _initialized:
        if explicit:
            try:
                jax.distributed.initialize(
                    coordinator_address=coordinator_address,
                    num_processes=num_processes,
                    process_id=process_id,
                )
            except RuntimeError as e:
                # Already initialized (e.g. by the launcher) is fine; a
                # real wiring failure on an explicit request is not.
                if "already" not in str(e).lower():
                    raise
            _initialized = True
        elif _auto_detectable():
            try:
                jax.distributed.initialize()
                _initialized = True
            except RuntimeError as e:
                if "already" in str(e).lower():
                    _initialized = True
                # else: launcher env present but incomplete → single-process
            except ValueError:
                # env var present but no coordinator derivable → not a
                # multi-host launch; stay single-process.
                pass
    return jax.process_index(), jax.process_count()


def _auto_detectable() -> bool:
    """True when this process runs under a launcher whose own metadata
    `jax.distributed.initialize()` can read (no arguments needed)."""
    import os

    return any(
        k in os.environ
        for k in (
            "SLURM_JOB_ID",
            "OMPI_MCA_orte_hnp_uri",  # Open MPI
        )
    )


def make_multihost_mesh(sp: Optional[int] = None):
    """(dp × sp) mesh over ALL global devices: a plain reshape of
    `jax.devices()`, which lists devices host by host, so hosts run along
    dp and each host's sample streams (sp) sit on its own devices.

    sp defaults to 2 when the per-host device count is even (see
    parallel.mesh.factor_mesh).  The cards of one host are joined all to
    all, so the layout follows the algorithm, not a topology."""
    import jax

    from caitlyn.parallel.mesh import make_mesh

    n = len(jax.devices())
    local = jax.local_device_count()
    if sp is None:
        sp = 2 if local % 2 == 0 and local > 1 else 1
    if n % sp != 0:
        raise ValueError(f"sp={sp} does not divide {n} devices")
    return make_mesh(jax.devices(), shape=(n // sp, sp))


def assemble_image(state, mesh, width: int, height: int, options, sp: int):
    """Full image on every host: resolve the dp-sharded accumulation and
    all-gather the host-local shards (`multihost_utils.process_allgather`,
    the plan of SURVEY §5).  Single-process: plain device gather.  Both
    paths share parallel.render.resolve_accum — one resolve to maintain."""
    import jax

    from caitlyn.parallel.render import gather_image, resolve_accum

    if jax.process_count() == 1:
        return np.asarray(gather_image(state, width, height, options, sp))
    from jax.experimental import multihost_utils

    accum = multihost_utils.process_allgather(state.accum, tiled=True)
    return np.asarray(
        resolve_accum(accum, state.frame_count, sp, width, height, options)
    )


def scaling_report(ds, camera, options, width: int, height: int, spp: int = 2):
    """Rays/s per device at 1 device vs the full mesh → scaling efficiency
    (the BASELINE ≥85% target's harness).  Runs wherever it's called —
    the 8-device virtual CPU mesh in tests, the cards of a host.  Ray
    counts are the instrumented closest+any-hit queries the integrator
    actually issues (same metric as bench.py), not a w·h·depth proxy."""
    import time

    import jax

    from caitlyn.parallel.mesh import make_mesh
    from caitlyn.parallel.render import (
        init_sharded_state,
        sharded_render_step,
    )
    from caitlyn.core.camera import generate_rays
    from caitlyn.render import sampling
    from caitlyn.render.integrator import trace_paths

    @jax.jit
    def _count(uni):
        o, d = generate_rays(camera, width, height, uni)
        _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
        return stats

    stats = jax.device_get(
        _count(sampling.draw_uniforms(jax.random.PRNGKey(0), width * height,
                                      options.max_depth))
    )
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])

    def measure(devs):
        mesh = make_mesh(devs, shape=(len(devs), 1))
        st = init_sharded_state(mesh, width, height, seed=0)
        step = lambda s: sharded_render_step(
            ds, camera, s, mesh, width, height, options
        )
        st = step(st)  # compile
        st.accum.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(spp):
            st = step(st)
        st.accum.block_until_ready()
        dt = time.perf_counter() - t0
        return rays_per_sample * spp / dt / len(devs)

    devs = jax.devices()
    r1 = measure(devs[:1])
    rn = measure(devs)
    return {
        "devices": len(devs),
        "rays_per_sample": rays_per_sample,
        "rays_per_sec_per_chip_1": round(r1, 1),
        "rays_per_sec_per_chip_n": round(rn, 1),
        "scaling_efficiency": round(rn / r1, 4),
    }
