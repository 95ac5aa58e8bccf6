// The cluster enumeration walk before its redesign, and emit_walk_kernel
// (ray_tracer_tpu_torch/csrc/bvh8_walk.cu) with each design element
// switched: built and launched by tools/emit_walk_variants.py (for
// chip_smoke.py, tools/measure_emit_walk.py and the GPU tests); not part of
// the package's library.  Every variant computes exactly what
// emit_walk_kernel computes for the same rows: the same visits and
// emissions in the same order (the callers hold them together with
// torch.equal).
//
//   old_emit_kernel  walk_kernel's emit mode (walk<kEmit, 1, kRoot>), the
//       enumeration walk until emit_walk_kernel took it over: compare-select
//       min/max, the whole stack in a local array, each leaf child marked
//       from its code and emitted, the codes of popped children reloaded,
//       each thread's row of slots filled with -1 and written in place,
//       registers left to ptxas.
//   variant_emit_kernel<kPtx, kTopReg, kPushIds, kStaged, kMinBlocks>
//       kPtx       min.NaN/max.NaN (walk_common.cuh), else compare-select.
//       kTopReg    the top stack word in a register, else all in the local
//                  array.
//       kPushIds   the entered interior children pushed by node id, from
//                  the codes loaded with the row, nearest on top, so a pop
//                  reloads nothing (a stack entry per entered child, not
//                  per level: at most kStack entries, which the cluster
//                  BVH8's depth keeps far below); else the (node, mask)
//                  words with the code reloaded on a pop.
//       kStaged    the block's rows staged in shared memory and written
//                  once, coalesced (emit_block's block size), else each
//                  thread's row in place (blocks of 128).
//       kMinBlocks blocks of 128 threads per SM that __launch_bounds__
//                  asks for (0: none, registers left to ptxas).
//   variant_emit_kernel<true, true, false, true, kEmitMinBlocks> is
//   emit_walk_kernel as it ships.

#include "old_bvh8_walk.cuh"  // and csrc/bvh8_walk.cu

namespace {

__global__ void __launch_bounds__(kBlock) old_emit_kernel(const EmitArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int* slots = a.slots + static_cast<int64_t>(i) * a.top_k;
  for (int k = 0; k < a.top_k; ++k) slots[k] = -1;
  const Ray y = load_ray(a.origin, a.direction, i);
  const float best = a.tmax0[i];
  int ovf = 0;
  const float4* nodes = a.nodes;
  const float* nodes_f = reinterpret_cast<const float*>(nodes);
  uint32_t stack[kStack];
  int sp = 0;
  int cnt = 0;
  stack[sp++] = 0u;
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
      const float code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
      if (code >= 0.0f) {
        target = static_cast<int>(code);
      } else {
        leaf_slot = (static_cast<int>(-code) - 1) >> 4;
      }
    }
    if (leaf_slot >= 0) continue;  // never: leaf children are not pushed
    const float4* r = nodes + target * 32;
    uint32_t m8 = 0u;
    uint32_t emit_bits = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 p = __ldg(r + 2 * c);
      const float4 b = __ldg(r + 2 * c + 1);
      const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
      const float t1y = p.y * y.iy - y.oiy, t2y = b.x * y.iy - y.oiy;
      const float t1z = p.z * y.iz - y.oiz, t2z = b.y * y.iz - y.oiz;
      const float tmin = max_nan(
          max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)), min_nan(t1z, t2z));
      const float tmx = min_nan(
          min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)), max_nan(t1z, t2z));
      const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
      if (hit) m8 |= 1u << c;
      if (b.z < 0.0f) {
        emit_bits |= 1u << c;
        if (hit) {
          if (cnt < a.top_k) {
            slots[cnt] = (static_cast<int>(-b.z) - 1) >> 4;
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
    const int axis = static_cast<int>(__ldg(nodes_f + target * 128 + 7));
    const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
    if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
    if (sp >= kStack) __trap();
    stack[sp++] = (static_cast<uint32_t>(target) << 9) | word;
  }
  a.ovf[i] = ovf;
}

template <bool kPtx>
__device__ __forceinline__ float vmin(float a, float b) {
  return kPtx ? min_ptx(a, b) : min_nan(a, b);
}

template <bool kPtx>
__device__ __forceinline__ float vmax(float a, float b) {
  return kPtx ? max_ptx(a, b) : max_nan(a, b);
}

template <bool kPtx, bool kTopReg, bool kPushIds>
__device__ __forceinline__ void variant_emit_walk(
    const float4* __restrict__ nodes, const Ray& y, const float best,
    int* row, const int top_k, int& ovf) {
  const float* nodes_f = reinterpret_cast<const float*>(nodes);
  uint32_t stack[kStack];
  uint32_t top = 0u;
  int held = 0;
  int node = 0;
  int cnt = 0;
  auto push = [&](uint32_t v) {
    if (held >= kStack) __trap();
    if (kTopReg) {
      if (held > 0) stack[held - 1] = top;
      top = v;
    } else {
      stack[held] = v;
    }
    ++held;
  };
  for (;;) {
    const float4* r = nodes + node * 32;
    uint32_t m8 = 0u;
    float axis_f = 0.0f;
    float codes[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 p = __ldg(r + 2 * c);
      const float4 q = __ldg(r + 2 * c + 1);
      const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
      const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
      const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
      const float tmin =
          vmax<kPtx>(vmax<kPtx>(vmin<kPtx>(t1x, t2x), vmin<kPtx>(t1y, t2y)),
                     vmin<kPtx>(t1z, t2z));
      const float tmx =
          vmin<kPtx>(vmin<kPtx>(vmax<kPtx>(t1x, t2x), vmax<kPtx>(t1y, t2y)),
                     vmax<kPtx>(t1z, t2z));
      const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
      codes[c] = q.z;
      if (q.z < 0.0f) {
        if (hit) {
          if (cnt < top_k) {
            row[cnt] = (static_cast<int>(-q.z) - 1) >> 4;
          } else {
            ovf = 1;
          }
          ++cnt;
        }
      } else if (hit) {
        m8 |= 1u << c;
      }
      if (c == 0) axis_f = q.w;
    }
    if (m8 != 0u) {
      const int axis = static_cast<int>(axis_f);
      const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
      const bool rev = dax < 0.0f;
      if (kPushIds) {
        // the visit order is slot 0..7, or 7..0 where rev; push the last
        // visited first, so that the nearest ends on top
        if (rev) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if ((m8 >> c) & 1u) push(static_cast<uint32_t>(codes[c]));
          }
        } else {
#pragma unroll
          for (int c = 7; c >= 0; --c) {
            if ((m8 >> c) & 1u) push(static_cast<uint32_t>(codes[c]));
          }
        }
      } else {
        uint32_t word = m8;
        if (rev) word = (__brev(m8) >> 24) | 0x100u;
        push(word | (static_cast<uint32_t>(node) << 9));
      }
    }
    if (held == 0) return;
    if (kPushIds) {
      node = static_cast<int>(kTopReg ? top : stack[held - 1]);
      if (--held > 0 && kTopReg) top = stack[held - 1];
      continue;
    }
    const uint32_t w = kTopReg ? top : stack[held - 1];
    const uint32_t mask = w & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (w & 0x100u) ? 7 - c : c;
    const int parent = static_cast<int>(w >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      if (kTopReg) {
        top = w - mask + rem;
      } else {
        stack[held - 1] = w - mask + rem;
      }
    } else if (--held > 0 && kTopReg) {
      top = stack[held - 1];
    }
    node = static_cast<int>(__ldg(nodes_f + parent * 128 + 8 * slot + 6));
  }
}

template <bool kPtx, bool kTopReg, bool kPushIds, bool kStaged>
__device__ __forceinline__ void variant_emit_body(const EmitArgs& a) {
  extern __shared__ int4 vstage4[];
  int* stage = reinterpret_cast<int*>(vstage4);
  const int t = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int i = static_cast<int>(first) + t;
  const int k_n = a.top_k;
  int* row;
  if (kStaged) {
    for (int j = t; j < static_cast<int>(blockDim.x) * k_n; j += blockDim.x) {
      stage[j] = -1;
    }
    __syncthreads();
    row = stage + t * k_n;
  } else {
    row = a.slots + static_cast<int64_t>(i) * k_n;
    if (i < a.n) {
      for (int k = 0; k < k_n; ++k) row[k] = -1;
    }
  }
  if (i < a.n) {
    const Ray y = load_ray(a.origin, a.direction, i);
    int ovf = 0;
    variant_emit_walk<kPtx, kTopReg, kPushIds>(a.nodes, y, a.tmax0[i], row,
                                               k_n, ovf);
    a.ovf[i] = ovf;
  }
  if (kStaged) {
    __syncthreads();
    const int rows = static_cast<int>(
        min(static_cast<int64_t>(blockDim.x), a.n - first));
    const int total = rows * k_n;
    int* out = a.slots + first * k_n;
    const int n4 = total >> 2;
    for (int j = t; j < n4; j += blockDim.x) {
      reinterpret_cast<int4*>(out)[j] = vstage4[j];
    }
    for (int j = 4 * n4 + t; j < total; j += blockDim.x) out[j] = stage[j];
  }
}

template <bool kPtx, bool kTopReg, bool kPushIds, bool kStaged,
          int kMinBlocks>
__global__ void __launch_bounds__(kEmitBlock, kMinBlocks)
    variant_emit_kernel(const EmitArgs a) {
  variant_emit_body<kPtx, kTopReg, kPushIds, kStaged>(a);
}

template <bool kPtx, bool kTopReg, bool kPushIds, bool kStaged>
__global__ void __launch_bounds__(kEmitBlock)
    free_emit_kernel(const EmitArgs a) {
  variant_emit_body<kPtx, kTopReg, kPushIds, kStaged>(a);
}

using EmitFn = void (*)(EmitArgs);

template <bool kP, bool kT, bool kI, bool kS, int kB>
EmitFn pick() {
  if constexpr (kB == 0) {
    return free_emit_kernel<kP, kT, kI, kS>;
  } else {
    return variant_emit_kernel<kP, kT, kI, kS, kB>;
  }
}

// tools/emit_walk_variants.py VARIANTS[1:], in this order; staged tells
// whether the variant stages the rows
EmitFn variant(int v, bool& staged) {
  staged = true;
  constexpr int kS = kEmitMinBlocks;
  switch (v) {
    case 1: return pick<true, true, false, true, kS>();    // shipped_copy
    case 2: return pick<false, true, false, true, kS>();   // fminf_select
    case 3: return pick<true, false, false, true, kS>();   // stack_local
    case 4: return pick<true, true, true, true, kS>();     // push_ids
    case 5: staged = false;
            return pick<true, true, false, false, kS>();   // rows_in_place
    case 6: return pick<true, true, false, true, 0>();     // regs_free
    case 7: return pick<true, true, false, true, 8>();     // regs64
    case 8: return pick<true, true, false, true, 10>();    // regs48
    case 9: return pick<true, true, false, true, 12>();    // regs40
    case 10: staged = false;
             return pick<false, false, false, false, 0>(); // none
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v (0 old, 1.. VARIANTS[1:]) with rt_bvh8_emit's
// arguments.  Returns the launch's CUDA error.
extern "C" int rt_emit_variant(int v, const void* nodes, const void* origin,
                               const void* direction, const void* tmax0,
                               void* slots, void* ovf, int n, int top_k,
                               void* stream) {
  if (top_k < 1 || reinterpret_cast<uintptr_t>(slots) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EmitArgs a{
      static_cast<const float4*>(nodes), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(tmax0),
      static_cast<int*>(slots), static_cast<int*>(ovf), n, top_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 0) {
    old_emit_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  bool staged;
  const EmitFn kernel = variant(v, staged);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int block = staged ? emit_block(top_k) : 0;
  if (block > 0) {
    kernel<<<(n + block - 1) / block, block, block * top_k * 4, s>>>(a);
  } else if (staged) {
    // past the staging budget the staged variants have no launch
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    kernel<<<(n + kEmitBlock - 1) / kEmitBlock, kEmitBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
