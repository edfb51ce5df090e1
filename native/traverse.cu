// Closest-hit and any-hit traversal of the binary BVH on NVIDIA GPUs,
// called from JAX through the XLA FFI (ops/traverse_cuda.py).
//
// One thread per ray with a private stack, like the reference's per-pixel
// traversal (`path_trace.fs:511-819`).  The state machine, the near-child-
// first order and every acceptance test mirror ops/traverse_xla.py, which
// is the reference the kernel is checked against:
//   * inner node: slab-test both children against the current best t
//     (`tf > 0 && tf >= tn && tn < t_best`), descend into the nearer hit
//     child and push the farther one;
//   * leaf: Moller-Trumbore over the leaf's contiguous triangle range,
//     keeping the first triangle with the smallest accepted t.
// The arithmetic is written in the order XLA evaluates the reference
// (min/max propagate NaN like jnp.minimum/maximum), and the library is
// built with -fmad=false so no multiply-add is contracted: results follow
// the reference up to XLA's own rounding choices.
//
// Node record (16 f32, built by ops/traverse_cuda.pack_nodes):
//   [0:6]   left child  bmin.xyz, bmax.xyz   (inner nodes, else 0)
//   [6:12]  right child bmin.xyz, bmax.xyz
//   [12:14] node_meta bit-cast: [left_child, 0] inner / [tri_start, count] leaf
// Triangle record (12 f32, ops/traverse_cuda.pack_triangles): v0, e1, e2, pad.
//
// The stack holds at most (tree depth - 1) entries.  The caller passes
// max_stack = scene.required_stack(ds) > tree depth; a push past it traps,
// which fails the XLA computation instead of returning a wrong hit.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kInf = 1e9f;  // miss sentinel (ops/traverse_xla.INF)
constexpr int kBlock = 128;

struct Node {
  float4 a, b, c, m;
};

__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float3 sub(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float dot(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

// Slab test of one box; returns whether the ray enters it before t_limit
// and the entry distance.
__device__ __forceinline__ bool slab(float3 o, float3 inv, float3 lo,
                                     float3 hi, float t_limit, float* t_near) {
  const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  const float tn = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z));
  const float tf = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z));
  *t_near = tn;
  return (tf > 0.0f) && (tf >= tn) && (tn < t_limit);
}

// Moller-Trumbore (ops/intersect.moller_trumbore).
__device__ __forceinline__ bool triangle(const float4* __restrict__ tris,
                                         int idx, float3 o, float3 d,
                                         float t_best, float* t, float* u,
                                         float* v) {
  const float4 a = __ldg(tris + 3 * idx);
  const float4 b = __ldg(tris + 3 * idx + 1);
  const float4 c = __ldg(tris + 3 * idx + 2);
  const float3 v0 = make_float3(a.x, a.y, a.z);
  const float3 e1 = make_float3(a.w, b.x, b.y);
  const float3 e2 = make_float3(b.z, b.w, c.x);
  const float3 pv = cross(d, e2);
  const float det = dot(e1, pv);
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  const float3 tv = sub(o, v0);
  const float3 qv = cross(tv, e1);
  *u = dot(tv, pv) * inv_det;
  *v = dot(d, qv) * inv_det;
  *t = dot(e2, qv) * inv_det;
  const float w = 1.0f - *u - *v;
  return (*u >= 0.0f) && (*v >= 0.0f) && (w >= 0.0f) && (*t >= 0.0f) &&
         (*t < t_best);
}

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

// Walks the tree for one ray.  ANY: stop at the first hit below t_limit.
template <int CAP, bool ANY>
__device__ __forceinline__ bool walk(const Node* __restrict__ nodes,
                                     const float4* __restrict__ tris,
                                     int num_tris, int max_stack, float3 o,
                                     float3 d, float* t_best, int* tri,
                                     float* ub, float* vb) {
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  int stack[CAP];
  int ptr = 0;
  int node = 0;
  while (node >= 0) {
    const float4 m = __ldg(&nodes[node].m);
    const int left = __float_as_int(m.x);
    const int count = __float_as_int(m.y);
    if (count > 0) {
      for (int k = 0; k < count && left + k < num_tris; ++k) {
        float t, u, v;
        if (triangle(tris, left + k, o, d, *t_best, &t, &u, &v)) {
          if (ANY) return true;
          *t_best = t;
          *tri = left + k;
          *ub = u;
          *vb = v;
        }
      }
      node = ptr > 0 ? stack[--ptr] : -1;
      continue;
    }
    const float4 a = __ldg(&nodes[node].a);
    const float4 b = __ldg(&nodes[node].b);
    const float4 c = __ldg(&nodes[node].c);
    float near_l, near_r;
    const bool hit_l = slab(o, inv, make_float3(a.x, a.y, a.z),
                            make_float3(a.w, b.x, b.y), *t_best, &near_l);
    const bool hit_r = slab(o, inv, make_float3(b.z, b.w, c.x),
                            make_float3(c.y, c.z, c.w), *t_best, &near_r);
    if (hit_l && hit_r) {
      const bool right_first = near_l > near_r;
      if (ptr >= max_stack) __trap();
      stack[ptr++] = right_first ? left : left + 1;
      node = right_first ? left + 1 : left;
    } else if (hit_l) {
      node = left;
    } else if (hit_r) {
      node = left + 1;
    } else {
      node = ptr > 0 ? stack[--ptr] : -1;
    }
  }
  return false;
}

template <int CAP>
__global__ void __launch_bounds__(kBlock)
    closest_kernel(int n, const float* __restrict__ o,
                   const float* __restrict__ d,
                   const int32_t* __restrict__ active,
                   const Node* __restrict__ nodes,
                   const float4* __restrict__ tris, int num_tris,
                   int max_stack, float* __restrict__ t_out,
                   int32_t* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t_best = kInf, ub = 0.0f, vb = 0.0f;
  int tri = -1;
  if (active[i]) {
    walk<CAP, false>(nodes, tris, num_tris, max_stack, load3(o, i),
                     load3(d, i), &t_best, &tri, &ub, &vb);
  }
  t_out[i] = t_best;
  tri_out[i] = t_best >= kInf ? -1 : tri;
  u_out[i] = ub;
  v_out[i] = vb;
}

template <int CAP>
__global__ void __launch_bounds__(kBlock)
    anyhit_kernel(int n, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  const int32_t* __restrict__ active,
                  const Node* __restrict__ nodes,
                  const float4* __restrict__ tris, int num_tris, int max_stack,
                  int32_t* __restrict__ occluded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = false;
  if (active[i]) {
    float t_limit = t_max[i], ub, vb;
    int tri;
    occ = walk<CAP, true>(nodes, tris, num_tris, max_stack, load3(o, i),
                          load3(d, i), &t_limit, &tri, &ub, &vb);
  }
  occluded[i] = occ ? 1 : 0;
}

// Smallest compiled stack capacity that holds max_stack entries.
template <typename F>
ffi::Error with_capacity(int64_t max_stack, F launch) {
  if (max_stack < 1) {
    return ffi::Error::InvalidArgument("max_stack must be positive");
  }
  if (max_stack <= 32) {
    launch(std::integral_constant<int, 32>());
  } else if (max_stack <= 64) {
    launch(std::integral_constant<int, 64>());
  } else if (max_stack <= 128) {
    launch(std::integral_constant<int, 128>());
  } else if (max_stack <= 256) {
    launch(std::integral_constant<int, 256>());
  } else {
    return ffi::Error::InvalidArgument("max_stack above 256 is not compiled");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error check_scene(size_t n, const ffi::Buffer<ffi::F32>& o,
                       const ffi::Buffer<ffi::F32>& d,
                       const ffi::Buffer<ffi::F32>& nodes,
                       const ffi::Buffer<ffi::F32>& tris) {
  if (o.element_count() != 3 * n || d.element_count() != 3 * n) {
    return ffi::Error::InvalidArgument("o and d must be (N, 3)");
  }
  if (nodes.element_count() % 16 != 0 || nodes.element_count() == 0) {
    return ffi::Error::InvalidArgument("nodes must be (Nn, 16), Nn > 0");
  }
  if (tris.element_count() % 12 != 0) {
    return ffi::Error::InvalidArgument("tris must be (T, 12)");
  }
  if (n > (1u << 30)) return ffi::Error::InvalidArgument("too many rays");
  return ffi::Error::Success();
}

ffi::Error Closest(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                   ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::S32> active,
                   ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                   int64_t max_stack, ffi::ResultBuffer<ffi::F32> t,
                   ffi::ResultBuffer<ffi::S32> tri,
                   ffi::ResultBuffer<ffi::F32> u,
                   ffi::ResultBuffer<ffi::F32> v) {
  const size_t n = active.element_count();
  ffi::Error err = check_scene(n, o, d, nodes, tris);
  if (!err.success()) return err;
  if (n == 0) return ffi::Error::Success();
  const int blocks = static_cast<int>((n + kBlock - 1) / kBlock);
  const int num_tris = static_cast<int>(tris.element_count() / 12);
  return with_capacity(max_stack, [&](auto cap) {
    closest_kernel<decltype(cap)::value><<<blocks, kBlock, 0, stream>>>(
        static_cast<int>(n), o.typed_data(), d.typed_data(),
        active.typed_data(), reinterpret_cast<const Node*>(nodes.typed_data()),
        reinterpret_cast<const float4*>(tris.typed_data()), num_tris,
        static_cast<int>(max_stack), t->typed_data(), tri->typed_data(),
        u->typed_data(), v->typed_data());
  });
}

ffi::Error AnyHit(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                  ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_max,
                  ffi::Buffer<ffi::S32> active, ffi::Buffer<ffi::F32> nodes,
                  ffi::Buffer<ffi::F32> tris, int64_t max_stack,
                  ffi::ResultBuffer<ffi::S32> occluded) {
  const size_t n = active.element_count();
  ffi::Error err = check_scene(n, o, d, nodes, tris);
  if (!err.success()) return err;
  if (t_max.element_count() != n) {
    return ffi::Error::InvalidArgument("t_max must be (N,)");
  }
  if (n == 0) return ffi::Error::Success();
  const int blocks = static_cast<int>((n + kBlock - 1) / kBlock);
  const int num_tris = static_cast<int>(tris.element_count() / 12);
  return with_capacity(max_stack, [&](auto cap) {
    anyhit_kernel<decltype(cap)::value><<<blocks, kBlock, 0, stream>>>(
        static_cast<int>(n), o.typed_data(), d.typed_data(),
        t_max.typed_data(), active.typed_data(),
        reinterpret_cast<const Node*>(nodes.typed_data()),
        reinterpret_cast<const float4*>(tris.typed_data()), num_tris,
        static_cast<int>(max_stack), occluded->typed_data());
  });
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CaitlynBvhClosest, Closest,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // d
                                  .Arg<ffi::Buffer<ffi::S32>>()  // active
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Attr<int64_t>("max_stack")
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()   // u
                                  .Ret<ffi::Buffer<ffi::F32>>());  // v

XLA_FFI_DEFINE_HANDLER_SYMBOL(CaitlynBvhAnyHit, AnyHit,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // d
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // active
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Attr<int64_t>("max_stack")
                                  .Ret<ffi::Buffer<ffi::S32>>());  // occluded
