"""caitlyn — a differentiable path-tracing framework for NVIDIA GPUs.

A from-scratch JAX / XLA / CUDA re-design of the capabilities of
AlerianEmperor/CaitlynRenderer (a real-time GLSL path tracer): OBJ/MTL scene
loading, SAH/SBVH/CWBVH acceleration structures, a wavefront (megakernel-free)
path-tracing integrator with NEE + MIS, Disney-family BSDFs, progressive
accumulation, and multi-chip sharding over a `jax.sharding.Mesh` — everything
differentiable end-to-end w.r.t. camera, geometry, and material parameters.

Architecture (bottom → top), mirroring the reference's layer map
(see SURVEY.md §1) but re-designed as a wavefront renderer:

  core/    pure pytree dtypes (rays, cameras, materials, lights) + math
  io/      OBJ/MTL parsing, texture atlas, image output (host side)
  accel/   BVH builders: binned SAH, SBVH spatial splits, CWBVH compression
           (vectorized host passes emitting flat device arrays)
  ops/     device compute: traversal, intersection, BSDFs, sampling, tonemap
           (jitted XLA + a CUDA BVH traversal through jax.ffi)
  render/  the wavefront integrator, progressive/tiled render loops
  parallel/ mesh construction, shard_map renderers, multi-host assembly
  grad/    differentiable rendering: custom VJPs, inverse-rendering optimizers
  utils/   config, logging, profiling, checkpointing
"""

__version__ = "0.1.0"

from caitlyn.core.types import (  # noqa: F401
    Camera,
    Lights,
    Materials,
    RenderOptions,
    SceneArrays,
)
