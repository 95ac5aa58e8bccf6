// Rope-walk traversal over per-octant row streams, one thread per ray
// (sm_90a): closest hit and occlusion.
//
// Replaces ray_tracer_tpu/kernels/lanewalk.py::_lanewalk_kernel.  The TPU
// kernel walks 8 gangs of 128 lanes per block, each gang with a shared page
// cursor over the stream's 128-row pages, fetching each lane's row with a
// lane gather and computing both row interpretations as dense vector work.
// None of that is carried over: each thread walks its own ray from row to
// row, and evaluates only the interpretation its row has.  The arithmetic
// is lanewalk.py:219-271, expression for expression.
//
// Stream (kernels/lanewalk.py holds the builder and the plain torch twin,
// lanewalk_traverse_reference): streams (8, r_pad, 16) f32, row-major, the
// binary tree in each direction octant's preorder:
//   BOX row: 0:3 bmin | 3:6 bmax | 6 hit_row | 7 miss_row | 15 type = 0
//   TRI row: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 n | 12 next_row |
//            13 front_only | 14 global tri id | 15 type = 1
// Row ids are f32 VALUES, exact below 2^24; kDead = 2^24 ends a walk.
// Contract: origin, direction (N,3) f32, tmax0 (N,) f32 (<= -kBig/2 =
// inactive lane), octant (N,) i32 (the stream each ray walks) -> dst (N,)
// f32 (closest accepted t from tmax0, or under ANYHIT -kBig at the first
// accepted hit), prim (N,) i32 global triangle id, -1 on a miss and under
// ANYHIT.  Every link moves forward in the preorder labelling, so a walk
// takes at most n_rows steps; a ray still walking after max_steps, or
// pointed outside its stream, sets *err and stops (a malformed stream
// cannot hang the card).
//
// Exactness: built with --fmad=false and without fast math, every
// expression rounds like the torch twin's separate ops; min/max propagate
// NaN as torch.minimum/maximum do.
//
// What bounds it: dependent global loads.  Each step is one 64 B row (four
// float4 loads) whose address is the previous row's link; the arithmetic
// per step is 22 (BOX) or 40 (TRI) FP32 operations.  The main-path
// streams (8 octants x 382,389 rows, 196 MB) exceed the 50 MB L2, but the
// rays arrive sorted by the integrator's coherence bins (octant first), so
// the threads of a warp walk the same stream and mostly the same rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr float kBig = 99999999.0f;
constexpr int kDead = 1 << 24;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <bool kAnyhit>
__global__ void __launch_bounds__(kBlock)
    lanewalk_kernel(const float4* __restrict__ streams, int r_pad,
                    const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ tmax0,
                    const int* __restrict__ octant, float* __restrict__ dst_out,
                    int* __restrict__ prim_out, int n, int max_steps,
                    int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1],
              oz = origin[3 * i + 2];
  // zero-direction guard (lanewalk.py:185-187)
  float dx = direction[3 * i], dy = direction[3 * i + 1],
        dz = direction[3 * i + 2];
  dx = dx == 0.0f ? 1e-20f : dx;
  dy = dy == 0.0f ? 1e-20f : dy;
  dz = dz == 0.0f ? 1e-20f : dz;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best = tmax0[i];
  int prim = -1;
  int cur = best > -kBig * 0.5f ? 0 : kDead;
  const float4* base =
      streams + static_cast<int64_t>(octant[i]) * r_pad * 4;
  for (int step = 0; cur < kDead; ++step) {
    if (step >= max_steps || cur < 0 || cur >= r_pad) {
      atomicOr(err, 1);
      break;
    }
    const float4* r = base + static_cast<int64_t>(cur) * 4;
    const float4 a = __ldg(r);      // 0-3
    const float4 b = __ldg(r + 1);  // 4-7
    const float4 c = __ldg(r + 2);  // 8-11
    const float4 e = __ldg(r + 3);  // 12-15
    if (e.w > 0.5f) {
      // TRI row: Moller-Trumbore, v0 a.xyz, e1 (a.w, b.x, b.y),
      // e2 (b.z, b.w, c.x), n (c.y, c.z, c.w)
      const float rx = ox - a.x, ry = oy - a.y, rz = oz - a.z;
      const float qx = ry * dz - rz * dy;
      const float qy = rz * dx - rx * dz;
      const float qz = rx * dy - ry * dx;
      const float d0 = -(dx * c.y + dy * c.z + dz * c.w);
      const float dinv = 1.0f / d0;
      const float t = (rx * c.y + ry * c.z + rz * c.w) * dinv;
      const float u = (b.z * qx + b.w * qy + c.x * qz) * dinv;
      const float v = -(a.w * qx + b.x * qy + b.y * qz) * dinv;
      const float w = 1.0f - u - v;
      const bool front = d0 >= 1e-8f;
      const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
                      !(!front && e.y > 0.5f);
      if (ok && t < best) {  // strict: the first row of a tie is kept
        if (kAnyhit) {
          best = -kBig;
          break;
        }
        best = t;
        prim = static_cast<int>(e.z);
      }
      cur = static_cast<int>(e.x);
    } else {
      // BOX row: slab test against the current best
      const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
      const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
      const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
      const float t_near =
          max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                  min_nan(t1z, t2z));
      const float t_far =
          min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                  max_nan(t1z, t2z));
      const bool hit = t_far >= t_near && t_far > 0.0f &&
                       max_nan(t_near, 0.0f) < best;
      cur = static_cast<int>(hit ? b.z : b.w);
    }
  }
  dst_out[i] = best;
  prim_out[i] = prim;
}

}  // namespace

extern "C" int rt_lanewalk(const void* streams, int r_pad, const void* origin,
                           const void* direction, const void* tmax0,
                           const void* octant, void* dst, void* prim, int n,
                           int anyhit, int max_steps, void* err,
                           void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* st = static_cast<const float4*>(streams);
  const float* o = static_cast<const float*>(origin);
  const float* d = static_cast<const float*>(direction);
  const float* t0 = static_cast<const float*>(tmax0);
  const int* oc = static_cast<const int*>(octant);
  if (anyhit) {
    lanewalk_kernel<true><<<grid, block, 0, s>>>(
        st, r_pad, o, d, t0, oc, static_cast<float*>(dst),
        static_cast<int*>(prim), n, max_steps, static_cast<int*>(err));
  } else {
    lanewalk_kernel<false><<<grid, block, 0, s>>>(
        st, r_pad, o, d, t0, oc, static_cast<float*>(dst),
        static_cast<int*>(prim), n, max_steps, static_cast<int*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
