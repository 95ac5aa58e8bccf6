// BVH8 traversal, one thread per ray (sm_90a): closest hit, occlusion,
// cluster enumeration and the two phases of treelet traversal, in four
// kernels, each designed for its mode:
//   group_walk_kernel (rt_bvh8_group): the closest-hit and occlusion walk
//     from the root over one- or two-row leaf slots; the main path and the
//     packet walk;
//   deep_walk_kernel (rt_bvh8_deep): the DEEP phase of treelet traversal,
//     the subtrees of a packet's entry list;
//   emit_walk_kernel (rt_bvh8_emit): the cluster enumeration;
//   top_walk_kernel (rt_bvh8_top): the TOP phase of treelet traversal, over
//     the scene's compact table of the top level.
// group, DEEP and TOP share one walk loop (walk_from); emit has its own.
//
// Replaces two TPU kernels that compute the same walk per ray:
//   ray_tracer_tpu/kernels/group.py::_group_kernel (closest-hit
//     `group_traverse`, order-free occlusion `group_anyhit`), and
//   ray_tracer_tpu/kernels/packet.py::_packet8_kernel in every mode: the
//     closest-hit and occlusion walks over one-row (8-record) or two-row
//     (16-record, merge_wide_leaves=True) leaf slots (`packet8_wide`,
//     `packet8_anyhit`), the `emit_leaves` enumeration over the cluster
//     BVH8 (`packet8_emit`), and the treelet TOP (`top_k` + `troot`) and
//     DEEP (`deep_e` + `entries`) modes of two-phase traversal.
// The lockstep machinery of the TPU kernels (lane-group or packet stacks,
// packet-majority child order, the pop LUT, the SMEM meta mirror, the
// stamped leaf flag) is not carried over: each thread walks its own ray with
// a private stack, so the visit and emission orders follow each ray's own
// direction.  That can change `prim` (never `dst`) on exact-t ties, and the
// ORDER of the emitted slots, never their set or count: a child box inside
// its parent's box is entered only if the parent is.  (In TOP mode the
// emitted treelet roots also depend on how far `best` has shrunk when the
// walk reaches them; every root that can hold a closer hit is emitted.)
//
// Tables (kernels/bvh8.py holds the plain torch twin, walk_reference):
//   nodes      (W,128) f32  per child c, floats 8c..8c+5 = min3|max3, float
//                           8c+6 = traversal code as an f32 VALUE (>= 0:
//                           wide node id; < 0: leaf with payload
//                           -(slot*16 + cnt) - 1, slot = payload >> 4, cnt
//                           its records, capped at 15), float 7 =
//                           child-sort axis.  Empty child slots hold NaN
//                           boxes and code 0.
//   top        (T,64) f32   the TOP table (scene/builder.py::top_table):
//                           the first 64 floats of each top-level node's
//                           row (the nodes reached from the root without
//                           entering a treelet root, the root first), the
//                           codes rewritten as VALUES: a top-level child
//                           its row in this table (< T), a treelet root
//                           T + its node id, a leaf's code unchanged.
//   leaf_rows  (L,128) f32  8 records of v0|e1|e2|n|front_only|pad per row;
//                           a slot spans kRows consecutive rows, record k of
//                           slot s has the padded id s*8 + k.  NaN records
//                           never hit.
//   entries    (G,E) i32    per-packet entry lists, -1 padded (DEEP only).
// Contract:
//   walk: origin, direction (N,3) f32, tmax0 (N,) f32 (-BIG = inactive
//     lane) -> dst (N,) f32 (closest accepted t from tmax0, or under ANYHIT
//     -BIG where a hit lies inside tmax0), prim (N,) i32 padded id of the
//     closest hit, -1 on a miss (always -1 under ANYHIT).
//   emit: nodes = the cluster BVH8 (leaf slot field = cluster id) ->
//     slots (N,K) i32, the cluster ids whose box the ray enters within
//     tmax0, -1 padded; ovf (N,) i32, 1 where more than K were entered.
//   TOP: the walk from the root, except that an interior child that is a
//     treelet root is never pushed: if the ray enters its box within the
//     current best, its node id goes to the lane's next free slot of K
//     (child-slot order c = 0..7), past them ovf = 1 -> dst, prim (the
//     closest top-level hit), slots, ovf.
//   DEEP: lane i walks the subtrees of the entries of its packet, row i / P
//     of `entries` (P = packet size; -1 = none), treelet roots included ->
//     dst, prim: the closest hit (or occlusion) in the union of those
//     subtrees within tmax0, the subtrees walked one after the other, the
//     last listed first; see deep_walk_kernel.
//
// Each ray keeps a private stack of (node << 9 | reversed << 8 | remaining
// child mask) words.  Mask bits are stored in visit order (reversed when
// the ray points down the node's sort axis), so the lowest set bit is
// always the next child.
//
// Exactness: built with --fmad=false and without fast math, every
// expression rounds like the torch twin's separate ops.  min/max propagate
// NaN (as torch.minimum does; fminf would drop a single NaN operand) and
// every accept test is a comparison that is false on NaN, so an empty
// child slot is never entered.
//
// The generic walk of the port's first kernels (walk_kernel<mode, rows,
// start>), which each of these replaced, lives in tools/old_bvh8_walk.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_common.cuh"

namespace {

// one (node, remaining-mask) word per wide level (kernels/bvh8.py G_STACK)
constexpr int kStack = 96;
constexpr float kBig = 99999999.0f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, oix, oiy, oiz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        int i) {
  Ray r;
  r.ox = origin[3 * i];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  // zero-direction guard (group.py:113-116, packet.py:352-354)
  const float dx = direction[3 * i], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  r.dx = dx == 0.0f ? 1e-20f : dx;
  r.dy = dy == 0.0f ? 1e-20f : dy;
  r.dz = dz == 0.0f ? 1e-20f : dz;
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.oix = r.ox * r.ix;
  r.oiy = r.oy * r.iy;
  r.oiz = r.oz * r.iz;
  return r;
}

// Moller-Trumbore accept distance of one 16-float record, kBig on a miss
// (the JAX kernels' _tri_t arithmetic).
__device__ __forceinline__ float record_t(const float4* __restrict__ rec,
                                          const Ray& y) {
  const float4 a = __ldg(rec);      // v0.xyz, e1.x
  const float4 b = __ldg(rec + 1);  // e1.yz, e2.xy
  const float4 e = __ldg(rec + 2);  // e2.z, n.xyz
  const float4 f = __ldg(rec + 3);  // front_only, pad
  const float rx = y.ox - a.x, ry = y.oy - a.y, rz = y.oz - a.z;
  const float qx = ry * y.dz - rz * y.dy;
  const float qy = rz * y.dx - rx * y.dz;
  const float qz = rx * y.dy - ry * y.dx;
  const float d0 = -(y.dx * e.y + y.dy * e.z + y.dz * e.w);
  const float dinv = 1.0f / d0;
  const float t = (rx * e.y + ry * e.z + rz * e.w) * dinv;
  const float u = (b.z * qx + b.w * qy + e.x * qz) * dinv;
  const float v = -(a.w * qx + b.x * qy + b.y * qz) * dinv;
  const float wb = 1.0f - u - v;
  const bool front = d0 >= 1e-8f;
  const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && wb >= 0.0f &&
                  !(!front && f.x > 0.5f);
  return ok ? t : kBig;
}

// ---------------------------------------------------------------------------
// group_walk_kernel: the walk from the root, closest hit and occlusion
// (kernels/group.py::group_traverse, and kernels/packet.py::
// packet_traverse_wide without a start table)
//
// Replaces ray_tracer_tpu/kernels/group.py::_group_kernel (closest hit, and
// occlusion with anyhit=True) and the walk from the root of
// ray_tracer_tpu/kernels/packet.py::_packet8_kernel (closest hit and
// occlusion over one-row or two-row leaf slots).  It computes exactly what
// walk_kernel<kClosest | kAnyhit, kRows, kRoot> computed for both before
// (tools/old_bvh8_walk.cuh; tools/packet_walk_variants.cu's "old"): the same
// visits in the same order, so dst and prim equal walk_reference(...,
// rows=kRows) bit for bit.
//
// What bounds it on this card: dependent-load latency and instruction
// issue within divergent warps, not bytes and not the FP32 rate.  The
// tables (~27 MiB on the main-path scene) sit in the 50 MB L2, and the FP32
// work (22 operations per child box, 40 per record) is 2-3% of the FP32
// peak in the kernel's time.  Each thread walks its own ray, so a warp runs
// as long as its longest ray and executes both the leaf and the interior
// branch whenever its lanes split.  What the design does about it (each
// element timed against its own removal by tools/measure_group_walk.py,
// whose variants of this kernel are tools/group_walk_variants.cu, and the
// two-row pin by tools/measure_packet_walk.py; NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md):
//   * min/max with NaN propagation is one instruction (PTX min.NaN.f32 /
//     max.NaN.f32, walk_common.cuh) instead of walk_kernel's compare-
//     compare-or-fminf-select, 10 per child box: 1.12-1.15x.
//   * A leaf slot's records are tested only up to the count its code
//     carries (payload & 15, written by scene/builder.py; on a two-row slot
//     15 means 15 or 16); the rest are NaN padding, which never hits, so
//     dst and prim are unchanged: 1.12-1.15x.
//   * The sort axis is child 0's float 7, already loaded with the row.
//   * The top stack word stays in a register; the words below it are a
//     local array, as in walk_kernel (384 B of stack frame, no spills).
//   * Registers pinned at 56 (9 blocks of 128 threads per SM): 48 runs as
//     fast, 40 and fewer spill, and left to itself ptxas may take 80 and
//     lose an eighth of the speed to the lower occupancy.  Two-row slots
//     keep the pin: 64 registers ran 0.99-1.02x of its time, 72 1.04-1.05x.
// Against walk_kernel's loop, one row 1.21-1.38x, two rows 1.21-1.47x
// faster (bounce and shadow sets, 2^18 and 2^22 rays).
// Tried and left out (tools/group_walk_variants.cu): the words below the
// top in shared memory, [level][thread] and sized by the tree's depth, ran
// no faster than the local array, which hits L1; descending into the
// nearest entered child with its code from registers (no reload) ran
// slower, at more registers; eight lanes per ray is faster at 2^18 rays
// but slower from 2^20 on and in the frame.  The while-while order of the
// narrow walk (tools/packet_walk_variants.cu) ran 0.97-1.04x of this loop's
// time on one-row slots and 0.91-1.00x on two-row slots.
// Built, like everything here, with --fmad=false and IEEE division.

constexpr int kGroupBlock = 128;
constexpr int kGroupMinBlocks = 9;  // blocks per SM: at most 56 registers

struct GroupArgs {
  const float4* nodes;
  const float4* leaf_rows;
  const float* origin;
  const float* direction;
  const float* tmax0;
  float* dst;
  int* prim;
  int n;
};

// The emit rule of the walks that emit nothing: every child whose box the
// ray enters is pushed (interior) or tested (leaf).
struct NoEmit {
  __device__ __forceinline__ bool operator()(float, bool) const {
    return false;
  }
};

// The walk of one ray through the subtree of wide node `code` (a node id
// as an f32 value), then through those of the nodes that next(code) sets
// as long as it returns true: closest hit (or occlusion, kAnyhit) over
// kRows-row leaf slots, folding into best and prim.  One loop walks them
// all, so a lane that finishes a subtree starts the next while the other
// lanes of its warp are still in theirs.  `nodes` holds rows of kRowF4
// float4s (32: the (W,128) tables; 16: the TOP table's 64-float rows).
// emit(q.z, hit) is called for each child of a visited node in slot order
// c = 0..7, with the child's code and whether the ray enters its box within
// best; a child for which it returns true is neither pushed nor entered
// (the TOP walk's treelet roots).  The stack holds kDepth words: kTopReg,
// the top word in a register and the kDepth - 1 words under it in `stack`;
// else all kDepth words in `stack`.  A record inside best ends an
// occlusion walk with best = -kBig.
template <bool kAnyhit, int kRows, bool kTopReg, int kRowF4 = 32,
          int kDepth = kStack, class Next, class Emit = NoEmit>
__device__ __forceinline__ void walk_from(float code,
                                          const float4* __restrict__ nodes,
                                          const float4* __restrict__ leaf_rows,
                                          const Ray& y, float& best,
                                          int& prim, uint32_t* stack,
                                          Next next, Emit emit = Emit()) {
  const float* nodes_f = reinterpret_cast<const float*>(nodes);
  uint32_t top = 0u;  // kTopReg: the top (node << 9 | reversed << 8 | mask)
  int held = 0;       // words held: top, then stack[0 .. held-2]; or all

  for (;;) {
    if (code >= 0.0f) {
      // 8-child slab test of wide node `code`, against the current best
      const int node = static_cast<int>(code);
      const float4* r = nodes + node * kRowF4;
      uint32_t m8 = 0u;
      float axis_f = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 p = __ldg(r + 2 * c);      // min.xyz, max.x
        const float4 q = __ldg(r + 2 * c + 1);  // max.yz, code, axis/pad
        const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
        const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
        const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
        const float tmin = max_ptx(
            max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)), min_ptx(t1z, t2z));
        const float tmx = min_ptx(
            min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)), max_ptx(t1z, t2z));
        const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
        if (!emit(q.z, hit) && hit) m8 |= 1u << c;
        if (c == 0) axis_f = q.w;
      }
      if (m8 != 0u) {
        uint32_t word = m8;
        if (!kAnyhit) {  // near-first, as walk_kernel
          const int axis = static_cast<int>(axis_f);
          const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
          if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
        }
        word |= static_cast<uint32_t>(node) << 9;
        if (kTopReg) {
          if (held > 0) {
            if (held >= kDepth) __trap();  // unreachable: the host caps depth
            stack[held - 1] = top;
          }
          top = word;
        } else {
          if (held >= kDepth) __trap();  // unreachable: the host caps depth
          stack[held] = word;
        }
        ++held;
      }
    } else {
      // leaf slot: record k is row leaf_slot*8 + k of the (L*8,16) view,
      // its padded id; the records past the payload's count are NaN
      // padding, which never hits.  The count is capped at 15
      // (scene/builder.py), so on a two-row slot 15 reads as 15 or 16.
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int cnt = payload & 15;
      const int lim = kRows == 2 && cnt == 15 ? 16 : cnt;
      const float4* r = leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8 * kRows; ++k) {
        if (k >= lim) break;
        const float tk = record_t(r + 4 * k, y);
        if (kAnyhit) {
          if (tk < best) {
            occluded = true;
            break;
          }
        } else if (tk < best) {  // strict: the lowest record wins a tie
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
      if (kAnyhit && occluded) {
        best = -kBig;
        return;
      }
    }
    if (held == 0) {  // this subtree is done: the next one, if any
      if (!next(code)) return;
      continue;
    }
    // pop: the next child of the top word, its code from the parent's row
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
    // the code is a VALUE: convert, never bitcast (scene/types.py)
    code = __ldg(nodes_f + node * (4 * kRowF4) + 8 * slot + 6);
  }
}

template <bool kAnyhit, int kRows>
__global__ void __launch_bounds__(kGroupBlock, kGroupMinBlocks)
    group_walk_kernel(const GroupArgs a) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t below[kStack - 1];  // the words under the top one
  walk_from<kAnyhit, kRows, true>(0.0f, a.nodes, a.leaf_rows, y, best, prim,
                                  below, [](float&) { return false; });
  a.dst[i] = best;
  a.prim[i] = prim;
}

// ---------------------------------------------------------------------------
// deep_walk_kernel: the DEEP phase of two-phase treelet traversal
// (kernels/packet.py::packet_traverse_wide with entries; ops/traverse.py::
// _deep_round launches it twice per query)
//
// Replaces ray_tracer_tpu/kernels/packet.py::_packet8_kernel with deep_e
// (the DEEP start, packet.py:516-535), closest hit and occlusion over one-
// or two-row leaf slots.  Lane i returns the closest accepted hit (or,
// under occlusion, -kBig) over the subtrees of every entry of row i / P of
// `entries`, within tmax0, walked one after the other, the last listed
// first: dst and prim bit for bit those of the walk it replaced
// (walk_kernel's former DEEP start: one untested mask-0 word per entry
// pushed in list order, then the walk), which visits the same nodes in the
// same order.
//
// What bounds it on this card: as group_walk_kernel, instruction issue and
// latency in divergent warps; the tables sit in L2.  The work itself is
// the function's: a packet's lanes are the (ray, entry) pairs of up to 16
// entries, each padded to runs of 128 lanes, and every lane walks every
// entry's subtree within its best, so it tests the leaves that the other
// entries' treelets hold in front of its hit, about 3x the leaf tests of a
// walk of its own entry alone, whatever the order of the entries.  What
// the design does (each element timed against its own removal by
// tools/measure_deep_walk.py, whose variants of this kernel are
// tools/deep_walk_variants.cu; PERF.md):
//   * group_walk_kernel's walk (walk_from): min.NaN/max.NaN, leaf records
//     only up to the leaf code's count.
//   * Entries are read from the list when the walk of the one before ends,
//     not pushed, and one loop walks every subtree: a lane that finishes
//     one takes its next entry at once (a loop per entry, which makes the
//     lanes of a warp wait at its end for the slowest, is slower).  The
//     entries keep the old order, so the lanes of a warp, which share
//     their packet's list, walk the same subtrees about the same time.
//   * The whole stack in a local array (walk_from<., ., false>): here the
//     top word in a register, as group_walk_kernel keeps it, is slower.
//   * Lanes with tmax0 <= 0 (the padding lanes, -BIG) return tmax0 and -1
//     at once: no record with t >= 0 lies below their bound.
//   * Registers pinned at 64 (8 blocks of 128 threads per SM).
// Measured and left out (tools/deep_walk_variants.cu): testing each
// entry's own box (its child box in its parent's row) against best before
// walking it, at its turn or for all entries up front, which skips
// nothing the walk would enter (a child box lies inside its parent's) but
// saves only the entry node's eight child tests, a row that the warp's
// lanes read together, and costs a box load and test per entry; and the
// entries nearest first, by that box's entry distance.

constexpr int kDeepMinBlocks = 8;  // blocks per SM: at most 64 registers
constexpr int kMaxDeepE = 31;      // entries per packet (kernels/bvh8.py)

struct DeepArgs {
  const float4* nodes;
  const float4* leaf_rows;
  const int* entries;
  const float* origin;
  const float* direction;
  const float* tmax0;
  float* dst;
  int* prim;
  int n, deep_e, packet_size;
};

template <bool kAnyhit, int kRows>
__global__ void __launch_bounds__(kGroupBlock, kDeepMinBlocks)
    deep_walk_kernel(const DeepArgs a) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  float best = a.tmax0[i];
  int prim = -1;
  if (best > 0.0f) {
    const Ray y = load_ray(a.origin, a.direction, i);
    const int* entries = a.entries + (i / a.packet_size) * a.deep_e;
    int e = a.deep_e;  // the next entry: the last listed first
    auto next = [&](float& code) {
      while (e > 0) {
        const int entry = __ldg(entries + --e);
        if (entry >= 0) {
          code = static_cast<float>(entry);
          return true;
        }
      }
      return false;
    };
    float code;
    uint32_t stack[kStack];
    if (next(code)) {
      walk_from<kAnyhit, kRows, false>(code, a.nodes, a.leaf_rows, y, best,
                                       prim, stack, next);
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}


// ---------------------------------------------------------------------------
// emit_walk_kernel: the cluster enumeration walk (kernels/packet.py::
// packet_traverse_wide with emit_leaves; the first step of the cluster
// route, ops/cluster_trace.py)
//
// Replaces ray_tracer_tpu/kernels/packet.py::_packet8_kernel with
// emit_leaves (`packet8_emit`).  Over the cluster BVH8 (leaf slot field =
// cluster id), each ray walks the interior children whose boxes it enters
// within tmax0 (best never shrinks), near-first, and appends the slot field
// of every leaf child it enters to its row of slots (N, top_k), in child-
// slot order within each visited node; past top_k of them ovf = 1.  The
// same visits and emissions, in the same order, as walk_reference(...,
// mode="emit") and as the walk it replaced (walk_kernel's emit mode, now
// tools/emit_walk_variants.cu's "old" kernel): slots and ovf equal both bit
// for bit.
//
// What bounds it on this card: by the bound's count, bytes, and most of
// them are the output, (top_k + 1) x 4 B per ray against 28 B of ray; the
// cluster BVH8 (724 nodes, 185 KB on the main-path scene) stays in L2.  In
// practice the walk's dependent node loads within divergent warps, and the
// output's scattered stores.  What the design does (each element timed
// against its own removal by tools/measure_emit_walk.py, whose variants of
// this kernel are tools/emit_walk_variants.cu, at top_k 16 on bounce and
// shadow rays of the main-path frame, 2^18 and 2^22 of them; NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md):
//   * The block's slot rows are staged in shared memory, [thread][k] as
//     the output is laid out: the -1 fill and the emitted ids go there, and
//     the block writes its contiguous (block, top_k) region once, in 16 B
//     coalesced stores, with ovf beside it; in place of top_k strided
//     -1 stores per ray and a strided store per emitted id: 1.3-2.5x.
//     Which path each top_k takes (shared memory at most kEmitStageBytes,
//     which needs no opt-in): top_k <= 96 in blocks of 128 threads, <= 192
//     of 64, <= 384 of 32; past 384 the rows go straight to global memory,
//     in blocks of 128 (-1 fill and ids by each thread in its own row).
//   * Emit never enters a leaf: a leaf child is recognised, and emitted,
//     from the code loaded with its box (q.z), so an emitted leaf costs no
//     load of its own, and only interior children are pushed.
//   * min/max with NaN propagation in one instruction (walk_common.cuh):
//     1.04-1.12x.
//   * The top stack word in a register, the words under it a local array,
//     as the group walk keeps them: within 4% of the whole stack in the
//     array, either way.
//   * Registers pinned at 56 (kEmitMinBlocks blocks of 128 threads per
//     SM); the pin does not bind: ptxas takes 36-37.
// Against the walk it replaced 1.48-2.57x.  Measured and left out
// (tools/emit_walk_variants.cu): the entered interior children pushed by
// node id (no code reload on a pop), 0.98-1.12x of this kernel's time.

constexpr int kEmitBlock = 128;
constexpr int kEmitMinBlocks = 9;  // blocks per SM: at most 56 registers
constexpr int kEmitStageBytes = 48 * 1024;

struct EmitArgs {
  const float4* nodes;
  const float* origin;
  const float* direction;
  const float* tmax0;
  int* slots;
  int* ovf;
  int n, top_k;
};

// The enumeration walk of one ray from the root: appends the slot field of
// each leaf child entered within best to row[0 .. top_k) and counts them;
// past top_k, ovf = 1.
__device__ __forceinline__ void emit_walk(const float4* __restrict__ nodes,
                                          const Ray& y, const float best,
                                          int* row, const int top_k,
                                          int& ovf) {
  const float* nodes_f = reinterpret_cast<const float*>(nodes);
  uint32_t below[kStack - 1];  // the words under the top one
  uint32_t top = 0u;  // (node << 9 | reversed << 8 | remaining mask)
  int held = 0;       // words held: top, then below[0 .. held-2]
  int node = 0;
  int cnt = 0;
  for (;;) {
    // 8-child slab test of `node`: leaf children emitted, interior pushed
    const float4* r = nodes + node * 32;
    uint32_t m8 = 0u;
    float axis_f = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 p = __ldg(r + 2 * c);      // min.xyz, max.x
      const float4 q = __ldg(r + 2 * c + 1);  // max.yz, code, axis/pad
      const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
      const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
      const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
      const float tmin = max_ptx(
          max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)), min_ptx(t1z, t2z));
      const float tmx = min_ptx(
          min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)), max_ptx(t1z, t2z));
      const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
      if (q.z < 0.0f) {  // a leaf child: its slot field, in slot order
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
      // near-first: children ascend along the node's sort axis
      uint32_t word = m8;
      const int axis = static_cast<int>(axis_f);
      const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
      if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
      if (held > 0) {
        if (held >= kStack) __trap();  // unreachable: the host caps depth
        below[held - 1] = top;
      }
      top = word | (static_cast<uint32_t>(node) << 9);
      ++held;
    }
    if (held == 0) return;
    // pop: the next child of the top word, its code from the parent's row
    const uint32_t mask = top & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (top & 0x100u) ? 7 - c : c;
    const int parent = static_cast<int>(top >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      top = top - mask + rem;
    } else if (--held > 0) {
      top = below[held - 1];
    }
    // the code is a VALUE: convert, never bitcast (scene/types.py)
    node = static_cast<int>(__ldg(nodes_f + parent * 128 + 8 * slot + 6));
  }
}

// kStaged: the block's rows in dynamic shared memory (blockDim.x * top_k
// ints), written out once; else each thread's row in place.
template <bool kStaged>
__global__ void __launch_bounds__(kEmitBlock, kEmitMinBlocks)
    emit_walk_kernel(const EmitArgs a) {
  extern __shared__ int4 stage4[];
  int* stage = reinterpret_cast<int*>(stage4);
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
    emit_walk(a.nodes, y, a.tmax0[i], row, k_n, ovf);
    a.ovf[i] = ovf;
  }
  if (kStaged) {
    __syncthreads();
    // the block's rows are one contiguous region of slots, 16 B aligned
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

// The block size that stages a block's rows of top_k slots within
// kEmitStageBytes (128, 64 or 32 threads), or 0: write them in place.
int emit_block(int top_k) {
  for (int b = kEmitBlock; b >= 32; b /= 2) {
    if (static_cast<int64_t>(b) * top_k * 4 <= kEmitStageBytes) return b;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// top_walk_kernel: the TOP phase of two-phase treelet traversal
// (kernels/packet.py::packet_traverse_wide with top_k and the scene's TOP
// table; ops/traverse.py::_two_phase_wide launches it first)
//
// Replaces ray_tracer_tpu/kernels/packet.py::_packet8_kernel with top_k +
// troot (packet.py:333-339, :841-879), closest hit and occlusion over one-
// or two-row leaf slots.  Each ray walks the top level from the root: the
// closest hit (or, under occlusion, -kBig) among the top level's leaves
// within tmax0, and the node id of every treelet root whose box it enters
// within the current best, in visit order and child-slot order c = 0..7
// within each node, to its row of slots (N, top_k), -1 padded; past top_k
// of them ovf = 1.  The same visits and emissions, in the same order, as
// walk_reference(..., troot=..., top_k=...) and as the walk it replaced
// (walk_kernel<., ., kTop>, tools/old_bvh8_walk.cuh): dst, prim, slots and
// ovf equal both bit for bit.
//
// What bounds it on this card: by the bound's count, bytes, and the output
// is most of them (the slots and ovf, (top_k + 1) x 4 B per ray, against
// 28 B of ray and 8 B of dst and prim); the top level (90 wide nodes on the
// main-path scene, 23 KB) and its leaves stay in L1 and L2.  In practice
// the walk's dependent loads within divergent warps.  What the design does
// (each element timed against its own removal by tools/measure_top_walk.py,
// whose variants of this kernel are tools/top_walk_variants.cu; PERF.md):
//   * The TOP table (scene/builder.py::top_table, built once at compile):
//     the top level's rows alone, 256 B each (no 128-float TPU padding),
//     a treelet-root child's class carried by its code (T + node id), so
//     the slab test's own load (q.z) tells it: no troot flag loads, which
//     were a second dependent load round on every visit.
//   * group_walk_kernel's walk (walk_from): min.NaN/max.NaN, the sort axis
//     from the loaded row, leaf records only up to the code's count, the
//     top stack word in a register; the emit rule takes the emitted
//     children out of the pushed set.
//   * The block's slot rows staged in shared memory and written once,
//     coalesced, with ovf beside them, as emit_walk_kernel does (the same
//     block sizes: top_k <= 96 in blocks of 128 threads, <= 192 of 64, <=
//     384 of 32; past that the rows are written in place).
//   * A stack of kTopStack words (checked against the top level's depth at
//     compile), not kStack.
//   * Registers pinned at kTopMinBlocks blocks of 128 threads per SM.
// Lanes at -BIG walk like the others: a box can hold the origin, so the
// root's test does not fail for them, and their slots must match.

constexpr int kTopStack = 32;      // kernels/bvh8.py TOP_STACK
constexpr int kTopMinBlocks = 8;   // blocks per SM: at most 64 registers
constexpr int kTopRowF4 = 16;      // float4s per row of the TOP table

struct TopArgs {
  const float4* top;
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

// kStaged: the block's rows in dynamic shared memory (blockDim.x * top_k
// ints), written out once; else each thread's row in place.
template <bool kAnyhit, int kRows, bool kStaged>
__global__ void __launch_bounds__(kGroupBlock, kTopMinBlocks)
    top_walk_kernel(const TopArgs a) {
  extern __shared__ int4 top_stage4[];
  int* stage = reinterpret_cast<int*>(top_stage4);
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
    float best = a.tmax0[i];
    int prim = -1, cnt = 0, ovf = 0;
    const int n_top = a.n_top;
    const float n_top_f = static_cast<float>(n_top);  // exact: < 2^24
    // a code of T or more is a treelet root: its node id, code - T, is
    // emitted where the ray enters its box (in slot order), never entered
    auto emit = [&](float code, bool hit) {
      if (code < n_top_f) return false;
      if (hit) {
        if (cnt < k_n) {
          row[cnt] = static_cast<int>(code) - n_top;
        } else {
          ovf = 1;
        }
        ++cnt;
      }
      return true;
    };
    uint32_t below[kTopStack - 1];  // the words under the top one
    walk_from<kAnyhit, kRows, true, kTopRowF4, kTopStack>(
        0.0f, a.top, a.leaf_rows, y, best, prim, below,
        [](float&) { return false; }, emit);
    a.dst[i] = best;
    a.prim[i] = prim;
    a.ovf[i] = ovf;
  }
  if (kStaged) {
    __syncthreads();
    // the block's rows are one contiguous region of slots, 16 B aligned
    const int rows = static_cast<int>(
        min(static_cast<int64_t>(blockDim.x), a.n - first));
    const int total = rows * k_n;
    int* out = a.slots + first * k_n;
    const int n4 = total >> 2;
    for (int j = t; j < n4; j += blockDim.x) {
      reinterpret_cast<int4*>(out)[j] = top_stage4[j];
    }
    for (int j = 4 * n4 + t; j < total; j += blockDim.x) out[j] = stage[j];
  }
}

template <bool kAnyhit, int kRows>
void launch_top(const TopArgs& a, cudaStream_t s) {
  const int block = emit_block(a.top_k);
  if (block > 0) {
    top_walk_kernel<kAnyhit, kRows, true>
        <<<(a.n + block - 1) / block, block, block * a.top_k * 4, s>>>(a);
  } else {
    top_walk_kernel<kAnyhit, kRows, false>
        <<<(a.n + kGroupBlock - 1) / kGroupBlock, kGroupBlock, 0, s>>>(a);
  }
}

}  // namespace

// One launch of the walk from the root: closest hit (anyhit 0) or
// occlusion (anyhit 1) of n rays over rows-row leaf slots (1 or 2).
// Returns the launch's CUDA error.
extern "C" int rt_bvh8_group(int anyhit, int rows, const void* nodes,
                             const void* leaf_rows, const void* origin,
                             const void* direction, const void* tmax0,
                             void* dst, void* prim, int n, void* stream) {
  const GroupArgs a{
      static_cast<const float4*>(nodes), static_cast<const float4*>(leaf_rows),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), n};
  if (rows != 1 && rows != 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kGroupBlock - 1) / kGroupBlock), block(kGroupBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    if (rows == 1) {
      group_walk_kernel<true, 1><<<grid, block, 0, s>>>(a);
    } else {
      group_walk_kernel<true, 2><<<grid, block, 0, s>>>(a);
    }
  } else if (rows == 1) {
    group_walk_kernel<false, 1><<<grid, block, 0, s>>>(a);
  } else {
    group_walk_kernel<false, 2><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of the DEEP walk: closest hit (anyhit 0) or occlusion
// (anyhit 1) of n = G * packet_size lanes over rows-row leaf slots (1 or
// 2), lane i from the entries of row i / packet_size of the (G, deep_e)
// list (deep_e at most 31).  Returns the launch's CUDA error.
extern "C" int rt_bvh8_deep(int anyhit, int rows, const void* nodes,
                            const void* leaf_rows, const void* entries,
                            const void* origin, const void* direction,
                            const void* tmax0, void* dst, void* prim, int n,
                            int deep_e, int packet_size, void* stream) {
  const DeepArgs a{
      static_cast<const float4*>(nodes), static_cast<const float4*>(leaf_rows),
      static_cast<const int*>(entries),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), n, deep_e, packet_size};
  if (deep_e < 1 || deep_e > kMaxDeepE || packet_size < 1 ||
      (rows != 1 && rows != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kGroupBlock - 1) / kGroupBlock), block(kGroupBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    if (rows == 1) {
      deep_walk_kernel<true, 1><<<grid, block, 0, s>>>(a);
    } else {
      deep_walk_kernel<true, 2><<<grid, block, 0, s>>>(a);
    }
  } else if (rows == 1) {
    deep_walk_kernel<false, 1><<<grid, block, 0, s>>>(a);
  } else {
    deep_walk_kernel<false, 2><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of the cluster enumeration walk: n rays over the cluster BVH8
// `nodes`, slots (n, top_k) i32 (16 B aligned) and ovf (n,) i32 written
// whole.  Returns the launch's CUDA error.
extern "C" int rt_bvh8_emit(const void* nodes, const void* origin,
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
  const int block = emit_block(top_k);
  if (block > 0) {
    emit_walk_kernel<true><<<(n + block - 1) / block, block,
                             block * top_k * 4, s>>>(a);
  } else {
    emit_walk_kernel<false><<<(n + kEmitBlock - 1) / kEmitBlock, kEmitBlock,
                              0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of the TOP walk: closest hit (anyhit 0) or occlusion
// (anyhit 1) of n rays over rows-row leaf slots (1 or 2) from the root of
// the TOP table `top` (n_top rows of 64 floats, scene/builder.py::
// top_table), the treelet roots entered written to slots (n, top_k) i32
// (16 B aligned) and ovf (n,) i32 whole.  Returns the launch's CUDA error.
extern "C" int rt_bvh8_top(int anyhit, int rows, const void* top, int n_top,
                           const void* leaf_rows, const void* origin,
                           const void* direction, const void* tmax0,
                           void* dst, void* prim, void* slots, void* ovf,
                           int n, int top_k, void* stream) {
  if (top_k < 1 || n_top < 1 || (rows != 1 && rows != 2) ||
      reinterpret_cast<uintptr_t>(slots) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TopArgs a{
      static_cast<const float4*>(top), static_cast<const float4*>(leaf_rows),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), static_cast<int*>(slots),
      static_cast<int*>(ovf), n, top_k, n_top};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    if (rows == 1) {
      launch_top<true, 1>(a, s);
    } else {
      launch_top<true, 2>(a, s);
    }
  } else if (rows == 1) {
    launch_top<false, 1>(a, s);
  } else {
    launch_top<false, 2>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
