// Per-ray BVH traversal on NVIDIA GPUs, called from JAX through the XLA FFI
// (ops/bvh_cuda.py builds and binds it).
//
// One thread per ray, with its own near-first stack: the algorithm of
// ops/bvh.py bvh_intersect_triangles, which is the reference's
// BVHAggregate::Intersect / IntersectP (cpu/aggregates.cpp:529-579). The
// XLA loop steps every lane of the wave once per node visit until the
// deepest ray finishes; here each ray runs to its own end.
//
// Layouts (ops/bvh_cuda.py writes them):
//   nodes (M, 8) f32: [lo.xyz, hi.xyz, right_child | prim_offset, n_prims << 2
//                     | axis]; columns 6 and 7 hold integers as values
//   tris  (T, 12) f32 in BVH leaf order: [p0.xyz, p1.xyz, p2.xyz, orig_index,
//                     0, 0]; orig_index is a value-encoded integer
//   rays  (N, 8) f32: [o.xyz, t_max, d.xyz, 0]
// Results: hit (N, 4) f32 [t, b0, b1, b2] and prim (N,) i32 (-1 = miss).
//
// The triangle test repeats ops/intersect.py ray_triangle operation by
// operation. The library is compiled with --fmad=false: no multiply-add is
// contracted, every product rounds on its own as the source is written, and
// edges shared by two triangles stay watertight. (XLA may contract some
// products into FMAs; chip_smoke.py phase 6 states the tolerance.)

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 40;    // ops/bvh.py STACK_DEPTH
constexpr int kMaxLeafPrims = 4;   // ops/bvh.py MAX_LEAF_PRIMS
constexpr int kBlock = 128;        // threads per block

__host__ __device__ constexpr float gamma_bound(int n) {
  // (n eps) / (1 - n eps), eps = 2^-24 (utils/math.py gamma_bound)
  return (n * 5.9604645e-08f) / (1.0f - n * 5.9604645e-08f);
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float comp(const Vec3& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

__device__ __forceinline__ float safe_div1(float b) {
  return b != 0.0f ? 1.0f / b : 0.0f;
}

// ops/intersect.py ray_triangle. Returns true on a hit closer than t_max
// and writes t and the barycentrics.
__device__ __forceinline__ bool ray_triangle(
    const Vec3& o, const Vec3& d, int kx, int ky, int kz, float sx, float sy,
    float sz, float t_max, const Vec3& p0, const Vec3& p1, const Vec3& p2,
    float* t_out, float* b0, float* b1, float* b2) {
  const Vec3 a{p0.x - o.x, p0.y - o.y, p0.z - o.z};
  const Vec3 b{p1.x - o.x, p1.y - o.y, p1.z - o.z};
  const Vec3 c{p2.x - o.x, p2.y - o.y, p2.z - o.z};
  const float z0 = comp(a, kz), z1 = comp(b, kz), z2 = comp(c, kz);
  const float x0 = comp(a, kx) + sx * z0, y0 = comp(a, ky) + sy * z0;
  const float x1 = comp(b, kx) + sx * z1, y1 = comp(b, ky) + sy * z1;
  const float x2 = comp(c, kx) + sx * z2, y2 = comp(c, ky) + sy * z2;
  const float e0 = x1 * y2 - y1 * x2;
  const float e1 = x2 * y0 - y2 * x0;
  const float e2 = x0 * y1 - y0 * x1;
  const bool same_side = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                         (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  const float det = e0 + e1 + e2;
  if (!same_side || det == 0.0f) return false;
  const float z0s = z0 * sz, z1s = z1 * sz, z2s = z2 * sz;
  const float t_scaled = e0 * z0s + e1 * z1s + e2 * z2s;
  const bool t_ok = det < 0.0f
                        ? (t_scaled <= 0.0f && t_scaled > det * t_max)
                        : (t_scaled >= 0.0f && t_scaled < det * t_max);
  if (!t_ok) return false;
  const float inv_det = safe_div1(det);
  const float t = t_scaled * inv_det;
  // conservative t > 0 (reference shapes.h triangle error analysis)
  const float max_zt = fmaxf(fabsf(z0s), fmaxf(fabsf(z1s), fabsf(z2s)));
  const float max_xt = fmaxf(fabsf(x0), fmaxf(fabsf(x1), fabsf(x2)));
  const float max_yt = fmaxf(fabsf(y0), fmaxf(fabsf(y1), fabsf(y2)));
  const float g2 = gamma_bound(2), g3 = gamma_bound(3), g5 = gamma_bound(5);
  const float delta_z = g3 * max_zt;
  const float delta_x = g5 * (max_xt + max_zt);
  const float delta_y = g5 * (max_yt + max_zt);
  const float delta_e =
      2.0f * (g2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
  const float max_e = fmaxf(fabsf(e0), fmaxf(fabsf(e1), fabsf(e2)));
  const float delta_t =
      3.0f * (g3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) *
      fabsf(inv_det);
  if (!(t > delta_t)) return false;
  *t_out = t;
  *b0 = e0 * inv_det;
  *b1 = e1 * inv_det;
  *b2 = e2 * inv_det;
  return true;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris, int64_t n_tris,
                    const float4* __restrict__ rays, int64_t n_rays,
                    float4* __restrict__ hit_out,
                    int32_t* __restrict__ prim_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float4 ra = rays[2 * i], rb = rays[2 * i + 1];
  const Vec3 o{ra.x, ra.y, ra.z};
  const Vec3 d{rb.x, rb.y, rb.z};
  float t_best = ra.w;
  const Vec3 inv_d{1.0f / (d.x == 0.0f ? 1e-20f : d.x),
                   1.0f / (d.y == 0.0f ? 1e-20f : d.y),
                   1.0f / (d.z == 0.0f ? 1e-20f : d.z)};
  // shear constants of the watertight test depend on the ray alone
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const int kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  const int kx = (kz + 1) % 3, ky = (kx + 1) % 3;
  const float inv_dz = safe_div1(comp(d, kz));
  const float sx = -comp(d, kx) * inv_dz;
  const float sy = -comp(d, ky) * inv_dz;
  const float sz = inv_dz;

  int prim_best = -1;
  float b0_best = 0.0f, b1_best = 0.0f, b2_best = 0.0f;
  int stack[kStackDepth];
  int sp = 0;
  int current = 0;
  while (true) {
    const float4 na = nodes[2 * current], nb = nodes[2 * current + 1];
    // slab test (utils/vecmath.py ray_bounds_intersect_p)
    const float tx0 = (na.x - o.x) * inv_d.x, tx1 = (na.w - o.x) * inv_d.x;
    const float ty0 = (na.y - o.y) * inv_d.y, ty1 = (nb.x - o.y) * inv_d.y;
    const float tz0 = (na.z - o.z) * inv_d.z, tz1 = (nb.y - o.z) * inv_d.z;
    const float t_near =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float t_far =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) *
        1.0000004f;
    const bool box_hit = t_near <= t_far && t_far > 0.0f && t_near < t_best;
    const int roff = __float2int_rn(nb.z);
    const int meta = __float2int_rn(nb.w);
    const int n_prims = meta >> 2;
    bool descend = false;
    if (box_hit) {
      if (n_prims > 0) {
        for (int k = 0; k < kMaxLeafPrims && k < n_prims; ++k) {
          int64_t pk = static_cast<int64_t>(roff) + k;
          pk = pk < 0 ? 0 : (pk >= n_tris ? n_tris - 1 : pk);
          const float4 ta = tris[3 * pk], tb = tris[3 * pk + 1],
                       tc = tris[3 * pk + 2];
          const Vec3 p0{ta.x, ta.y, ta.z};
          const Vec3 p1{ta.w, tb.x, tb.y};
          const Vec3 p2{tb.z, tb.w, tc.x};
          float t, b0, b1, b2;
          if (ray_triangle(o, d, kx, ky, kz, sx, sy, sz, t_best, p0, p1, p2,
                           &t, &b0, &b1, &b2) &&
              t < t_best) {
            t_best = t;
            prim_best = __float2int_rn(tc.y);
            b0_best = b0;
            b1_best = b1;
            b2_best = b2;
          }
        }
      } else {
        descend = true;
      }
    }
    if (kAnyHit && prim_best >= 0) break;
    if (descend) {
      const int axis = meta & 3;
      const float inv_axis =
          axis == 0 ? inv_d.x : (axis == 1 ? inv_d.y : inv_d.z);
      const bool neg = inv_axis < 0.0f;
      const int near_child = neg ? roff : current + 1;
      const int far_child = neg ? current + 1 : roff;
      stack[sp < kStackDepth ? sp : kStackDepth - 1] = far_child;
      ++sp;
      current = near_child;
      continue;
    }
    if (sp <= 0) break;
    --sp;
    current = stack[sp < kStackDepth ? sp : kStackDepth - 1];
  }
  const bool hit = prim_best >= 0;
  hit_out[i] = make_float4(hit ? t_best : __int_as_float(0x7f800000),
                           b0_best, b1_best, b2_best);
  prim_out[i] = prim_best;
}

template <bool kAnyHit>
ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> rays,
                        ffi::ResultBuffer<ffi::F32> hit,
                        ffi::ResultBuffer<ffi::S32> prim) {
  const auto nd = nodes.dimensions(), td = tris.dimensions(),
             rd = rays.dimensions();
  if (nd.size() != 2 || nd[1] != 8 || td.size() != 2 || td[1] != 12 ||
      rd.size() != 2 || rd[1] != 8) {
    return ffi::Error::InvalidArgument(
        "bvh traversal: expected nodes (M, 8), tris (T, 12), rays (N, 8)");
  }
  const int64_t n_rays = rd[0];
  if (n_rays == 0) return ffi::Error::Success();
  const int64_t blocks = (n_rays + kBlock - 1) / kBlock;
  traverse_kernel<kAnyHit><<<blocks, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), td[0],
      reinterpret_cast<const float4*>(rays.typed_data()), n_rays,
      reinterpret_cast<float4*>(hit->typed_data()), prim->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

#define PBRT_BIND_TRAVERSE(name, any_hit)                   \
  XLA_FFI_DEFINE_HANDLER_SYMBOL(                            \
      name, TraverseImpl<any_hit>,                          \
      ffi::Ffi::Bind()                                      \
          .Ctx<ffi::PlatformStream<cudaStream_t>>()         \
          .Arg<ffi::Buffer<ffi::F32>>()                     \
          .Arg<ffi::Buffer<ffi::F32>>()                     \
          .Arg<ffi::Buffer<ffi::F32>>()                     \
          .Ret<ffi::Buffer<ffi::F32>>()                     \
          .Ret<ffi::Buffer<ffi::S32>>());

PBRT_BIND_TRAVERSE(BvhClosestHit, false)
PBRT_BIND_TRAVERSE(BvhAnyHit, true)
