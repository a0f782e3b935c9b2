// Per-ray BVH traversal for NVIDIA Hopper GPUs, called from JAX through the
// XLA foreign function interface (cg_raytracer/ops/bvh_cuda.py).
//
// One thread per ray.  The explicit stack (node index + entry distance) lives
// in local memory; descent is ordered near child first, and the any-hit
// variant returns at the first blocker.  Slab padding and Moller-Trumbore
// epsilons are those of the jnp traversal (ops/bvh.py::traverse_closest and
// ops/intersect.py::moller_trumbore), so both agree up to tie-breaks on
// coincident hits.
//
// Layouts (int32 words, built by ops/bvh_cuda.py::pack_nodes/pack_triangles):
//   node  i: [lo.x lo.y lo.z a | hi.x hi.y hi.z b]  (floats as raw bits)
//            internal: a = left child, b = right child (b >= 0)
//            leaf:     a = first triangle slot, b = -count (b < 0)
//   tri   j: [v0.xyz prim | e1.xyz 0 | e2.xyz 0]     e1 = v1 - v0, e2 = v2 - v0
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> bvh_traverse.cu

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxStack = 64;
constexpr float kSlabEps = 1e-5f;
constexpr float kDetEps = 1e-9f;
constexpr float kBaryEps = 1e-6f;
constexpr int kBlock = 128;

__device__ __forceinline__ float3 as_f3(int4 w) {
  return make_float3(__int_as_float(w.x), __int_as_float(w.y),
                     __int_as_float(w.z));
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float pad_of(float t) {
  return kSlabEps * (1.0f + fabsf(t));
}

// Padded slab test (ops/bvh.py::_slab): returns hit, writes the entry distance.
__device__ __forceinline__ bool slab(float3 o, float3 inv, float3 lo, float3 hi,
                                     float* t_in) {
  const float tx0 = (lo.x - o.x) * inv.x, tx1 = (hi.x - o.x) * inv.x;
  const float ty0 = (lo.y - o.y) * inv.y, ty1 = (hi.y - o.y) * inv.y;
  const float tz0 = (lo.z - o.z) * inv.z, tz1 = (hi.z - o.z) * inv.z;
  const float tin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                          fminf(tz0, tz1));
  const float tout = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  const float pad = pad_of(tout);
  *t_in = tin;
  return (tin <= tout + pad) && (tout >= -pad);
}

// Moller-Trumbore (ops/intersect.py::moller_trumbore), double-sided.
__device__ __forceinline__ bool moller_trumbore(float3 o, float3 d, float3 v0,
                                                float3 e1, float3 e2, float* t,
                                                float* u, float* v) {
  const float3 pvec = cross3(d, e2);
  const float det = dot3(e1, pvec);
  if (!(fabsf(det) > kDetEps)) return false;
  const float inv_det = 1.0f / det;
  const float3 tvec = make_float3(o.x - v0.x, o.y - v0.y, o.z - v0.z);
  *u = dot3(tvec, pvec) * inv_det;
  const float3 qvec = cross3(tvec, e1);
  *v = dot3(d, qvec) * inv_det;
  *t = dot3(e2, qvec) * inv_det;
  return (*u >= -kBaryEps) && (*v >= -kBaryEps) &&
         (*u + *v <= 1.0f + kBaryEps) && (*t >= 0.0f);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const int4* __restrict__ nodes,
                    const int4* __restrict__ tris,
                    const float* __restrict__ origins,
                    const float* __restrict__ dirs,
                    const float* __restrict__ t_max, int64_t n,
                    float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    uint8_t* __restrict__ blocked_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 o = make_float3(origins[3 * i], origins[3 * i + 1],
                               origins[3 * i + 2]);
  const float3 d = make_float3(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]);
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);

  float t = t_max[i];
  int32_t prim = -1;
  float best_u = 0.0f, best_v = 0.0f;

  int stack[kMaxStack];
  float stack_t[kMaxStack];
  int sp = 0;
  {
    const int4 a = nodes[0], b = nodes[1];
    float tin;
    if (slab(o, inv, as_f3(a), as_f3(b), &tin)) {
      stack[0] = 0;
      stack_t[0] = tin;
      sp = 1;
    }
  }

  while (sp > 0) {
    --sp;
    const int ni = stack[sp];
    // Re-test the entry distance against the current closest hit.
    if (!(stack_t[sp] <= t + pad_of(t))) continue;
    const int4 a = nodes[2 * ni];
    const int4 b = nodes[2 * ni + 1];
    if (b.w < 0) {
      const int first = a.w;
      const int count = -b.w;
      for (int k = 0; k < count; ++k) {
        const int4* tri = tris + 3 * (first + k);
        const int4 w0 = tri[0];
        float tt, uu, vv;
        if (moller_trumbore(o, d, as_f3(w0), as_f3(tri[1]), as_f3(tri[2]),
                            &tt, &uu, &vv) &&
            tt < t) {
          if (kAnyHit) {
            blocked_out[i] = 1;
            return;
          }
          t = tt;
          prim = w0.w;
          best_u = uu;
          best_v = vv;
        }
      }
      continue;
    }
    const int li = a.w, ri = b.w;
    float tl, tr;
    const int4 la = nodes[2 * li], lb = nodes[2 * li + 1];
    const int4 ra = nodes[2 * ri], rb = nodes[2 * ri + 1];
    const float pad = pad_of(t);
    const bool hl = slab(o, inv, as_f3(la), as_f3(lb), &tl) && tl <= t + pad;
    const bool hr = slab(o, inv, as_f3(ra), as_f3(rb), &tr) && tr <= t + pad;
    const bool left_near = tl <= tr;
    const int near_i = left_near ? li : ri, far_i = left_near ? ri : li;
    const float near_t = left_near ? tl : tr, far_t = left_near ? tr : tl;
    const bool near_h = left_near ? hl : hr, far_h = left_near ? hr : hl;
    // Far first, so the near child is popped first.  The stack cannot
    // overflow: it holds at most one entry per level plus one, and the
    // builder caps the depth well below kMaxStack.
    if (far_h && sp < kMaxStack) {
      stack[sp] = far_i;
      stack_t[sp] = far_t;
      ++sp;
    }
    if (near_h && sp < kMaxStack) {
      stack[sp] = near_i;
      stack_t[sp] = near_t;
      ++sp;
    }
  }

  if (kAnyHit) {
    blocked_out[i] = 0;
  } else {
    const bool hit = prim >= 0;
    t_out[i] = hit ? t : __int_as_float(0x7f800000);  // +inf on miss
    prim_out[i] = prim;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

ffi::Error check_inputs(const ffi::Buffer<ffi::S32>& nodes,
                        const ffi::Buffer<ffi::S32>& tris,
                        const ffi::Buffer<ffi::F32>& origins,
                        const ffi::Buffer<ffi::F32>& dirs,
                        const ffi::Buffer<ffi::F32>& t_max) {
  if (nodes.element_count() % 8 != 0 || nodes.element_count() < 8) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "nodes must hold 8 int32 words per node");
  }
  if (tris.element_count() % 12 != 0) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "triangles must hold 12 int32 words per triangle");
  }
  const size_t n = t_max.element_count();
  if (origins.element_count() != 3 * n || dirs.element_count() != 3 * n) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "origins and dirs must be [N, 3] for N = len(t_max)");
  }
  return ffi::Error::Success();
}

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

unsigned int num_blocks(int64_t n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

ffi::Error ClosestImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                       ffi::Buffer<ffi::S32> tris,
                       ffi::Buffer<ffi::F32> origins,
                       ffi::Buffer<ffi::F32> dirs,
                       ffi::Buffer<ffi::F32> t_max,
                       ffi::ResultBuffer<ffi::F32> t_out,
                       ffi::ResultBuffer<ffi::S32> prim_out,
                       ffi::ResultBuffer<ffi::F32> u_out,
                       ffi::ResultBuffer<ffi::F32> v_out) {
  ffi::Error err = check_inputs(nodes, tris, origins, dirs, t_max);
  if (err.failure()) return err;
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  traverse_kernel<false><<<num_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const int4*>(nodes.typed_data()),
      reinterpret_cast<const int4*>(tris.typed_data()), origins.typed_data(),
      dirs.typed_data(), t_max.typed_data(), n, t_out->typed_data(),
      prim_out->typed_data(), u_out->typed_data(), v_out->typed_data(),
      nullptr);
  return launch_status();
}

ffi::Error OccludedImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                        ffi::Buffer<ffi::S32> tris,
                        ffi::Buffer<ffi::F32> origins,
                        ffi::Buffer<ffi::F32> dirs,
                        ffi::Buffer<ffi::F32> t_max,
                        ffi::ResultBuffer<ffi::U8> blocked_out) {
  ffi::Error err = check_inputs(nodes, tris, origins, dirs, t_max);
  if (err.failure()) return err;
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  traverse_kernel<true><<<num_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const int4*>(nodes.typed_data()),
      reinterpret_cast<const int4*>(tris.typed_data()), origins.typed_data(),
      dirs.typed_data(), t_max.typed_data(), n, nullptr, nullptr, nullptr,
      nullptr, blocked_out->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CgrtBvhClosest, ClosestImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(CgrtBvhOccluded, OccludedImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>());
