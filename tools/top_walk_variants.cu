// The TOP walk of two-phase treelet traversal before its redesign, and
// top_walk_kernel (ray_tracer_tpu_torch/csrc/bvh8_walk.cu) with each design
// element switched: built and launched by tools/top_walk_variants.py (for
// chip_smoke.py, tools/measure_top_walk.py and the GPU tests); not part of
// the package's library.  Every variant computes exactly what
// top_walk_kernel computes for the same rays: the same visits and emissions
// in the same order, so dst, prim, slots and ovf bit for bit (the callers
// hold them together with torch.equal).
//
//   old  walk_kernel<kClosest | kAnyhit, kRows, kTop> (tools/
//       old_bvh8_walk.cuh), the TOP walk until top_walk_kernel took it
//       over: the (W,128) node rows with one troot flag load per interior
//       child of a visited node, compare-select min/max, every record of a
//       leaf slot tested, the whole stack of 96 words in a local array with
//       a mask-0 start word, each thread's row of slots filled with -1 and
//       written in place, registers left to ptxas.
//   variant_top_kernel<kAnyhit, kPtx, kCount, kTopReg, kCompact,
//       kSmallStack, kStaged, kSmem, kMinBlocks> (one-row slots), a copy
//       of top_walk_kernel's walk (walk_from) with each element switchable:
//       kPtx         min.NaN/max.NaN (walk_common.cuh), else compare-select.
//       kCount       a leaf slot's records up to its code's count, else all 8.
//       kTopReg      the top stack word in a register, else all in the local
//                    array.
//       kCompact     the TOP table (64-float rows, a treelet root told by its
//                    code), else the (W,128) rows with a troot flag load per
//                    interior child.
//       kSmallStack  kTopStack words of stack, else kStack (96).
//       kStaged      the block's slot rows staged in shared memory and
//                    written once, coalesced (emit_block's block size), else
//                    each thread's row in place (blocks of 128).
//       kSmem        the whole TOP table copied into shared memory by each
//                    block first and read from there, else read through L1
//                    with __ldg (kCompact only).
//       kMinBlocks   blocks of 128 threads per SM that __launch_bounds__ asks
//                    for (0: none, registers left to ptxas).
//   variant_top_kernel<., true, true, true, true, true, true, false,
//   kTopMinBlocks> is top_walk_kernel<., 1, true> as it ships.

#include "old_bvh8_walk.cuh"

namespace {

struct VTopArgs {
  const float4* nodes;  // (W,128) rows (kCompact false)
  const int* troot;     // (W,) flags (kCompact false)
  const float4* top;    // (T,64) TOP table
  const float4* leaf_rows;
  const float* origin;
  const float* direction;
  const float* tmax0;
  float* dst;
  int* prim;
  int* slots;
  int* ovf;
  int n, top_k, n_top;
};

template <bool kPtx>
__device__ __forceinline__ float tmin2(float a, float b) {
  return kPtx ? min_ptx(a, b) : min_nan(a, b);
}

template <bool kPtx>
__device__ __forceinline__ float tmax2(float a, float b) {
  return kPtx ? max_ptx(a, b) : max_nan(a, b);
}

template <bool kSmem>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kSmem>
__device__ __forceinline__ float load1(const float* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// walk_from from the root of `nodes` (rows of kRowF4 float4s), one-row
// leaf slots, with the elements switched.
template <bool kAnyhit, bool kPtx, bool kCount, bool kTopReg, int kRowF4,
          int kDepth, bool kSmem, class Emit>
__device__ __forceinline__ void vtop_walk(const float4* nodes,
                                          const float4* __restrict__ leaf_rows,
                                          const Ray& y, float& best,
                                          int& prim, uint32_t* stack,
                                          Emit emit) {
  const float* nodes_f = reinterpret_cast<const float*>(nodes);
  uint32_t top = 0u;
  int held = 0;
  float code = 0.0f;
  for (;;) {
    if (code >= 0.0f) {
      const int node = static_cast<int>(code);
      const float4* r = nodes + node * kRowF4;
      uint32_t m8 = 0u;
      float axis_f = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 p = load4<kSmem>(r + 2 * c);
        const float4 q = load4<kSmem>(r + 2 * c + 1);
        const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
        const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
        const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
        const float tmin = tmax2<kPtx>(
            tmax2<kPtx>(tmin2<kPtx>(t1x, t2x), tmin2<kPtx>(t1y, t2y)),
            tmin2<kPtx>(t1z, t2z));
        const float tmx = tmin2<kPtx>(
            tmin2<kPtx>(tmax2<kPtx>(t1x, t2x), tmax2<kPtx>(t1y, t2y)),
            tmax2<kPtx>(t1z, t2z));
        const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
        if (!emit(q.z, hit) && hit) m8 |= 1u << c;
        if (c == 0) axis_f = q.w;
      }
      if (m8 != 0u) {
        uint32_t word = m8;
        if (!kAnyhit) {
          const int axis = static_cast<int>(axis_f);
          const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
          if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
        }
        word |= static_cast<uint32_t>(node) << 9;
        if (kTopReg) {
          if (held > 0) {
            if (held >= kDepth) __trap();
            stack[held - 1] = top;
          }
          top = word;
        } else {
          if (held >= kDepth) __trap();
          stack[held] = word;
        }
        ++held;
      }
    } else {
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int lim = kCount ? (payload & 15) : 8;
      const float4* r = leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= lim) break;
        const float tk = record_t(r + 4 * k, y);
        if (kAnyhit) {
          if (tk < best) {
            occluded = true;
            break;
          }
        } else if (tk < best) {
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
      if (kAnyhit && occluded) {
        best = -kBig;
        return;
      }
    }
    if (held == 0) return;
    const uint32_t w = kTopReg ? top : stack[held - 1];
    const uint32_t mask = w & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (w & 0x100u) ? 7 - c : c;
    const int node = static_cast<int>(w >> 9);
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
    code = load1<kSmem>(nodes_f + node * (4 * kRowF4) + 8 * slot + 6);
  }
}

template <bool kAnyhit, bool kPtx, bool kCount, bool kTopReg, bool kCompact,
          bool kSmallStack, bool kStaged, bool kSmem>
__device__ __forceinline__ void variant_top_body(const VTopArgs& a) {
  extern __shared__ int4 vdyn[];
  constexpr int kRowF4 = kCompact ? kTopRowF4 : 32;
  constexpr int kDepth = kSmallStack ? kTopStack : kStack;
  const int t = threadIdx.x;
  const int table4 = kSmem ? a.n_top * kTopRowF4 : 0;  // its float4s
  float4* table = reinterpret_cast<float4*>(vdyn);
  int4* stage4 = vdyn + table4;
  int* stage = reinterpret_cast<int*>(stage4);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int i = static_cast<int>(first) + t;
  const int k_n = a.top_k;
  if (kSmem) {
    for (int j = t; j < table4; j += blockDim.x) table[j] = __ldg(a.top + j);
  }
  int* row;
  if (kStaged) {
    for (int j = t; j < static_cast<int>(blockDim.x) * k_n; j += blockDim.x) {
      stage[j] = -1;
    }
    row = stage + t * k_n;
  } else {
    row = a.slots + static_cast<int64_t>(i) * k_n;
    if (i < a.n) {
      for (int k = 0; k < k_n; ++k) row[k] = -1;
    }
  }
  if (kSmem || kStaged) __syncthreads();
  if (i < a.n) {
    const Ray y = load_ray(a.origin, a.direction, i);
    float best = a.tmax0[i];
    int prim = -1, cnt = 0, ovf = 0;
    const int n_top = a.n_top;
    const float n_top_f = static_cast<float>(n_top);
    const int* troot = a.troot;
    auto emit = [&](float code, bool hit) {
      int id;
      if (kCompact) {
        if (code < n_top_f) return false;
        id = static_cast<int>(code) - n_top;
      } else {
        if (!(code > 0.0f)) return false;
        id = static_cast<int>(code);
        if (__ldg(troot + id) != 1) return false;
      }
      if (hit) {
        if (cnt < k_n) {
          row[cnt] = id;
        } else {
          ovf = 1;
        }
        ++cnt;
      }
      return true;
    };
    const float4* nodes = kSmem ? table : (kCompact ? a.top : a.nodes);
    uint32_t stack[kTopReg ? kDepth - 1 : kDepth];
    vtop_walk<kAnyhit, kPtx, kCount, kTopReg, kRowF4, kDepth, kSmem>(
        nodes, a.leaf_rows, y, best, prim, stack, emit);
    a.dst[i] = best;
    a.prim[i] = prim;
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
      reinterpret_cast<int4*>(out)[j] = stage4[j];
    }
    for (int j = 4 * n4 + t; j < total; j += blockDim.x) out[j] = stage[j];
  }
}

template <bool kA, bool kP, bool kC, bool kR, bool kT, bool kS, bool kG,
          bool kM, int kMinBlocks>
__global__ void __launch_bounds__(kGroupBlock, kMinBlocks)
    variant_top_kernel(const VTopArgs a) {
  variant_top_body<kA, kP, kC, kR, kT, kS, kG, kM>(a);
}

template <bool kA, bool kP, bool kC, bool kR, bool kT, bool kS, bool kG,
          bool kM>
__global__ void __launch_bounds__(kGroupBlock)
    free_top_kernel(const VTopArgs a) {
  variant_top_body<kA, kP, kC, kR, kT, kS, kG, kM>(a);
}

using TopFn = void (*)(VTopArgs);

template <bool kA, bool kP, bool kC, bool kR, bool kT, bool kS, bool kG,
          bool kM, int kB>
TopFn pick() {
  if constexpr (kB == 0) {
    return free_top_kernel<kA, kP, kC, kR, kT, kS, kG, kM>;
  } else {
    return variant_top_kernel<kA, kP, kC, kR, kT, kS, kG, kM, kB>;
  }
}

// tools/top_walk_variants.py VARIANTS[1:], in this order; staged tells
// whether the variant stages the slot rows, smem whether it copies the
// table into shared memory
template <bool kA>
TopFn variant(int v, bool& staged, bool& smem) {
  staged = true;
  smem = false;
  constexpr bool k1 = true, k0 = false;
  constexpr int kB = kTopMinBlocks;
  switch (v) {
    case 1: return pick<kA, k1, k1, k1, k1, k1, k1, k0, kB>();  // shipped_copy
    case 2: return pick<kA, k1, k1, k1, k0, k1, k1, k0, kB>();  // troot_gathers
    case 3: return pick<kA, k0, k1, k1, k1, k1, k1, k0, kB>();  // fminf_select
    case 4: return pick<kA, k1, k0, k1, k1, k1, k1, k0, kB>();  // every_record
    case 5: return pick<kA, k1, k1, k0, k1, k1, k1, k0, kB>();  // stack_local
    case 6: return pick<kA, k1, k1, k1, k1, k0, k1, k0, kB>();  // stack96
    case 7: staged = false;
            return pick<kA, k1, k1, k1, k1, k1, k0, k0, kB>();  // rows_in_place
    case 8: return pick<kA, k1, k1, k1, k1, k1, k1, k0, 0>();   // regs_free
    case 9: return pick<kA, k1, k1, k1, k1, k1, k1, k0, 7>();   // regs72
    case 10: return pick<kA, k1, k1, k1, k1, k1, k1, k0, 9>();  // regs56
    case 11: return pick<kA, k1, k1, k1, k1, k1, k1, k0, 10>(); // regs48
    case 12: smem = true;
             return pick<kA, k1, k1, k1, k1, k1, k1, k1, kB>(); // smem_table
    case 13: staged = false;
             return pick<kA, k0, k0, k0, k0, k0, k0, k0, 0>();  // none
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v (0 old, 1.. VARIANTS[1:]) with rt_bvh8_top's
// arguments and the (W,128) rows and troot flags the old walk and the
// troot_gathers and none variants read; only "old" takes two-row slots
// (rows 2).  Returns the launch's CUDA error.
extern "C" int rt_top_variant(int v, int anyhit, int rows, const void* nodes,
                              const void* troot, const void* top, int n_top,
                              const void* leaf_rows, const void* origin,
                              const void* direction, const void* tmax0,
                              void* dst, void* prim, void* slots, void* ovf,
                              int n, int top_k, void* stream) {
  if (top_k < 1 || n_top < 1 || (rows != 1 && rows != 2) ||
      reinterpret_cast<uintptr_t>(slots) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 0) {
    const WalkArgs a{
        static_cast<const float4*>(nodes),
        static_cast<const float4*>(leaf_rows),
        static_cast<const int*>(troot), static_cast<const float*>(origin),
        static_cast<const float*>(direction),
        static_cast<const float*>(tmax0), static_cast<float*>(dst),
        static_cast<int*>(prim), static_cast<int*>(slots),
        static_cast<int*>(ovf), n, top_k};
    const int err = anyhit ? by_rows<kAnyhit, kTop>(rows, a, s)
                           : by_rows<kClosest, kTop>(rows, a, s);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  if (rows != 1) return static_cast<int>(cudaErrorInvalidValue);
  bool staged, smem;
  const TopFn kernel =
      anyhit ? variant<true>(v, staged, smem) : variant<false>(v, staged, smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const VTopArgs a{
      static_cast<const float4*>(nodes), static_cast<const int*>(troot),
      static_cast<const float4*>(top), static_cast<const float4*>(leaf_rows),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), static_cast<int*>(slots),
      static_cast<int*>(ovf), n, top_k, n_top};
  const int block = staged ? emit_block(top_k) : kGroupBlock;
  if (block == 0) {
    // past the staging budget the staged variants have no launch
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t bytes = (smem ? static_cast<int64_t>(n_top) * 256 : 0) +
                        (staged ? static_cast<int64_t>(block) * top_k * 4 : 0);
  if (bytes > kEmitStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(n + block - 1) / block, block, static_cast<int>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
