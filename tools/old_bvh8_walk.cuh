// The generic BVH8 walk of the port's first kernels, kept for the tools
// that hold the redesigned kernels against the designs they replaced; not
// part of the package's library.  walk<kMode, kRows, kStart> and
// walk_kernel served every mode of the BVH8 walk until each got a kernel
// of its own in ray_tracer_tpu_torch/csrc/bvh8_walk.cu: the walk from the
// root (group_walk_kernel), the DEEP start (deep_walk_kernel), the cluster
// enumeration (emit_walk_kernel) and last the TOP start (top_walk_kernel).
// tools/packet_walk_variants.cu launches it from the root,
// tools/top_walk_variants.cu with the TOP start; the deep and emit
// variants take kBlock for their old kernels.
//
// Its design: one thread per ray, compare-select NaN min/max (min_nan,
// max_nan of walk_common.cuh), every record of a leaf slot tested, the
// whole stack of (node << 9 | reversed << 8 | mask) words in a local
// array of kStack words with a mask-0 start word (visit the word's node
// itself), the sort axis reloaded from the node's row, and in TOP mode
// one flag load from troot per interior child of a visited node (a treelet
// root is emitted, not pushed); each thread fills its row of slots with -1
// and stores the emitted ids in place; registers left to ptxas.
//
// Include this header instead of csrc/bvh8_walk.cu: it includes that.

#pragma once

#include "../ray_tracer_tpu_torch/csrc/bvh8_walk.cu"

namespace {

constexpr int kBlock = 128;
enum WalkMode { kClosest = 0, kAnyhit = 1 };
enum WalkStart { kRoot = 0, kTop = 1 };

// The walk of one ray.  kClosest: closest accepted record (strict < so the
// earliest record wins a tie).  kAnyhit: best = -kBig at the first record
// inside best, then stop.  kTop: interior children flagged in troot are not
// entered; each one whose box the ray enters within best appends its node
// id to slots[0..top_k), past them ovf = 1.
template <int kMode, int kRows, int kStart>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const float4* __restrict__ leaf_rows,
                                     const int* __restrict__ troot,
                                     const Ray& y, float& best, int& prim,
                                     int* __restrict__ slots, int top_k,
                                     int& ovf) {
  uint32_t stack[kStack];
  int sp = 0;
  int cnt = 0;
  stack[sp++] = 0u;
  const float* nodes_f = reinterpret_cast<const float*>(nodes);

  while (sp > 0) {
    const uint32_t w = stack[sp - 1];
    const uint32_t mask = w & 0xFFu;
    const int node = static_cast<int>(w >> 9);
    int target = node;
    int leaf_slot = -1;
    if (mask == 0u) {
      --sp;
    } else {
      const int c = __ffs(mask) - 1;
      const int slot = (w & 0x100u) ? 7 - c : c;
      const uint32_t rem = mask & (mask - 1u);
      if (rem == 0u) {
        --sp;
      } else {
        stack[sp - 1] = w - mask + rem;
      }
      // the code is a VALUE: convert, never bitcast (scene/types.py)
      const float code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
      if (code >= 0.0f) {
        target = static_cast<int>(code);
      } else {
        leaf_slot = (static_cast<int>(-code) - 1) >> 4;
      }
    }

    if (leaf_slot >= 0) {
      // kRows*8 records; record k of the slot is row leaf_slot*8 + k of
      // the (L*8,16) view, which is its padded id
      const float4* r = leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8 * kRows; ++k) {
        const float tk = record_t(r + 4 * k, y);
        if (kMode == kAnyhit) {
          occluded = occluded || tk < best;
        } else if (tk < best) {  // strict: the lowest record wins a tie
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
      if (kMode == kAnyhit && occluded) {
        best = -kBig;
        return;
      }
      continue;
    }

    // 8-child slab test of `target`, against the current best
    const float4* r = nodes + target * 32;
    uint32_t m8 = 0u;
    uint32_t emit_bits = 0u;  // children emitted instead of pushed
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 a = __ldg(r + 2 * c);      // min.xyz, max.x
      const float4 b = __ldg(r + 2 * c + 1);  // max.yz, code, axis/pad
      const float t1x = a.x * y.ix - y.oix, t2x = a.w * y.ix - y.oix;
      const float t1y = a.y * y.iy - y.oiy, t2y = b.x * y.iy - y.oiy;
      const float t1z = a.z * y.iz - y.oiz, t2z = b.y * y.iz - y.oiz;
      const float tmin = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                                 min_nan(t1z, t2z));
      const float tmx = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                                max_nan(t1z, t2z));
      const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
      if (hit) m8 |= 1u << c;
      int id = -1;  // what this child emits, if it is emitted
      if (kStart == kTop && b.z > 0.0f) {
        const int child = static_cast<int>(b.z);
        if (__ldg(troot + child) == 1) id = child;  // a treelet root
      }
      if (id >= 0) {
        emit_bits |= 1u << c;
        if (hit) {  // in slot order
          if (cnt < top_k) {
            slots[cnt] = id;
          } else {
            ovf = 1;
          }
          ++cnt;
        }
      }
    }
    m8 &= ~emit_bits;
    if (m8 == 0u) continue;
    uint32_t word = m8;
    if (kMode != kAnyhit) {
      // near-first: children ascend along the node's sort axis, so a ray
      // pointing down that axis visits them from slot 7
      const int axis = static_cast<int>(__ldg(nodes_f + target * 128 + 7));
      const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
      if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
    }
    if (sp >= kStack) __trap();  // unreachable: the host caps tree depth
    stack[sp++] = (static_cast<uint32_t>(target) << 9) | word;
  }
}

struct WalkArgs {
  const float4* nodes;
  const float4* leaf_rows;
  const int* troot;
  const float* origin;
  const float* direction;
  const float* tmax0;
  float* dst;
  int* prim;
  int* slots;
  int* ovf;
  int n, top_k;
};

template <int kMode, int kRows, int kStart>
__global__ void __launch_bounds__(kBlock) walk_kernel(const WalkArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  constexpr bool kEmits = kStart == kTop;
  int* slots = nullptr;
  if (kEmits) {
    slots = a.slots + static_cast<int64_t>(i) * a.top_k;
    for (int k = 0; k < a.top_k; ++k) slots[k] = -1;
  }
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1, ovf = 0;
  walk<kMode, kRows, kStart>(a.nodes, a.leaf_rows, a.troot, y, best, prim,
                             slots, a.top_k, ovf);
  a.dst[i] = best;
  a.prim[i] = prim;
  if (kEmits) a.ovf[i] = ovf;
}

template <int kMode, int kRows, int kStart>
int launch(const WalkArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock), block(kBlock);
  walk_kernel<kMode, kRows, kStart><<<grid, block, 0, s>>>(a);
  return 0;
}

template <int kMode, int kStart>
int by_rows(int rows, const WalkArgs& a, cudaStream_t s) {
  if (rows == 1) return launch<kMode, 1, kStart>(a, s);
  if (rows == 2) return launch<kMode, 2, kStart>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
