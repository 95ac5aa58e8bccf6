// The wavefront round of ray_tracer_tpu_torch/integrator/wavefront.py
// (_fused_round) as three kernels:
//   shade_kernel        one thread per lane: from the lane's pending hit to
//                       its next state, written as the packed row of the
//                       state permute, with its bin key and the round's ray
//                       counts (plain version: kernels/shade.py::
//                       shade_round_reference, i.e. integrator/shading.py::
//                       shade_lanes, pack_lanes and bin_key);
//   permute_kernel      each lane's packed row gathered by the sorted order
//                       into the next wave's columns, and the runs of equal
//                       keys among the live lanes counted into the round's
//                       tally (permute_rows_reference);
//   nee_resolve_kernel  the occlusion NEE's light side and the MIS resolve
//                       into the next ``direct`` (nee_resolve_reference).
// They replace no Pallas kernel: in the JAX package the round
// (ray_tracer_tpu/integrator/wavefront.py:1003-1400, round_ inside
// lax.while_loop under jit) is fused by XLA.  Every kernel moves a few
// hundred bytes a lane and does a few hundred flops: memory bound.  The
// design moves each byte once: a lane reads its state and the 29 floats it
// needs of its 48-float shade row, and writes its 160-byte packed row and
// key once; the permute reads a row and writes the columns once; the
// counts are integer sums added with integer atomics, exact in any order.
//
// The packed row (integrator/shading.py::pack_lanes, ROW) is 40 words,
// 160 B: the 34 f32 words of the state, then its 6 i32 words as their bits
// (j, s, pix, slot, li, sb), copied and never converted.  160 B is five
// 32-byte sectors, so a row on a 16-byte boundary shares no sector with
// its neighbours and is ten 16-byte chunks.
//
// shade_kernel's design.  A lane's 160-byte row is most of its traffic.
// Written by each thread in place (the first form of this kernel,
// tools/shade_round_variants.cu::old_shade_kernel), every warp store
// touches 32 sectors a row apart and fills 8 B of each.  Here a block of
// 256 lanes writes its rows into a shared-memory tile, each value as soon
// as the lane knows it, so no row is held in registers; after one barrier
// thread 0 stores the tile with one TMA bulk copy (cp.async.bulk),
// contiguous in global memory, while the block adds its counts; a ragged
// last tile is still a multiple of 16 bytes.  The sky, the second block
// of draws with the BSDF lobes, and the camera ray run only on the lanes
// that use them (the escaped, the shaded, the regenerated), with the plain
// version's selects kept, so the values are the same; with them and the
// early writes __launch_bounds__(256, 4) holds a thread to 64 registers
// without spilling: four blocks (50%) to an SM.  The counts are warp sums
// and one atomic per counter per block.
//
// permute_kernel's design.  Its rows are gathered by a permutation, so
// each is read once, from anywhere.  Read by each thread in place (the
// first form, tools/shade_round_variants.cu::old_permute_kernel, on 136 B
// and 24 B rows 8 B aligned), every warp load touches 32 rows and a row's
// sectors are fetched once per load that touches them.  Here the TMA
// engine gathers a warp's 32 rows: each lane starts one 160-byte bulk copy
// (cp.async.bulk) of its row into the warp's part of a shared-memory tile,
// all completing on one mbarrier, so a row is read whole, five sectors,
// by one request, with no load instruction and no register waiting on it.
// Each thread then reads its row from the tile (ten 16-byte loads) and
// writes its columns as the first form did.  Warps work alone: no block
// barrier.  Measured against the same warp-wide gather done with 16-byte
// loads (32 consecutive chunks of the warp's rows a load), and with the
// nine (N,3) vectors staged through shared memory for 128-byte warp
// stores: tools/shade_round_variants.cu.  From the sorted keys a warp
// also counts the runs of equal live keys that start among its lanes
// (one coalesced 4-byte load a lane, the key before it by a shuffle, a
// warp sum) and adds them to the tally's last word with one atomic, only
// where the count is not zero: the key runs a round's traversal sees.
//
// nee_resolve_kernel's design.  A lane loads what its flags say it needs,
// in the plain version's order of selects: fresh_direct; direct_base
// where it is false; is_diff where it is true; on a diffuse lane the light
// pick, the material's emission and nee_k, and where its shadow ray was
// traced the occlusion, and where that reached the light the direction,
// distance and light normal of the pdf and cos_pdf_at_l, its weight's.
// The lanes are sorted by bin key with the dead lanes last, so whole warps
// skip whole sectors.  Every expression is as before; only the loads
// moved.
//
// Bit equality with the plain versions on the card.  Built with
// --fmad=false and without fast math, each expression below is the torch
// expression it mirrors, in its order of operations, with torch's CUDA
// semantics where they differ from plain arithmetic:
//   * a tensor divided by a Python number is a product with the number's
//     reciprocal, rounded to f32 first (ATen's div_true_kernel_cuda):
//     smoothstep's divisions, raygen's x / width, the light-pick pdf;
//   * clamp keeps a NaN (clamp_*); .max(dim) keeps a NaN (max3);
//   * sign(x) is (0 < x) - (x < 0), so sign(NaN) is 0;
//   * x ** 2 is x * x; other powers, cos and sin are powf, cosf, sinf;
//   * sqrt of an f32 through f64 (ops/intersect.py::sqrt) is sqrtf: both
//     are correctly rounded;
//   * masked arithmetic is kept as written ((j == 0) * emission,
//     atten * (shaded ? radiance : 1)), so 0 * inf stays NaN.
//
// The maps instance, shade_kernel<true>, runs where the arguments' maps
// flag is set (kernels/shade.py::maps_on: enable_textures and a scene
// with textures): it adds the albedo,
// metalness and alpha maps (shading.apply_material_maps) and, on a
// flattened scene with enable_normal_maps, the bump maps (shading.bump);
// shade_kernel<false> keeps the untextured code as it was.  The maps
// instance also counts its cutout lanes into a fifth word of the tally (a
// warp sum and one atomic a warp, add_cutouts).  Its texel
// loads are plain u8 loads, never hardware filtering, whose 8-bit
// fixed-point weights cannot equal the plain version's, and
//   * the sRGB decode is one lookup in a 256-entry table that the wrapper
//     builds on the card with the plain version's own ops
//     (shading.srgb_to_linear), so no powf has to equal ATen's;
//   * torch.round rounds half to even: rintf, not roundf;
//   * floor(f).to(int32) is (int)floorf(f); fx - x0 converts x0 to f32;
//   * the bilinear sum is four products of three factors, summed left to
//     right, as ATen evaluates the expression op by op;
//   * a tap one texel over adds 0.0f to the other coordinate, as the
//     plain version adds a zero column (-0.0 + 0.0 is 0.0).
// A sphere lane reads shade row 0, so it samples its material's maps at
// row 0's uv (0.5 where the row's flag is set), as the plain version and
// the JAX package do.

#include <cuda_runtime.h>

#include <cstdint>

// The kernels' arguments, passed by value; the wrappers in kernels/shade.py
// fill the same fields in the same order (_ShadeArgs, _NeeArgs).
struct ShadeArgs {
  // the wave (N lanes): the pending ray, its hit and the lane state
  const float* origin;     // (N,3)
  const float* direction;  // (N,3)
  const float* dst;
  const int* kind;  // 0 none, 1 sphere, 2 triangle
  const int* prim;
  const int* obj;
  const float* hit_u;
  const float* hit_v;
  const unsigned char* front;
  const float* atten;   // (N,3)
  const float* total;   // (N,3)
  const float* direct;  // (N,3)
  const float* acc;     // (N,3)
  const unsigned char* bad;
  const unsigned char* alive;
  const int* j;
  const int* s;
  const int* sb;
  const int* pix;
  const int* slot;
  // the scene
  const float* table;  // (R,48) shade rows by prim id
  const float* obj_transform;  // (O,4,4)
  const int* obj_mat;
  const float* sphere_pos;  // (S,3)
  const int* sphere_mat;
  const float* mat_albedo;    // (M,3)
  const float* mat_emission;  // (M,3)
  const float* mat_emission_strength;
  const float* mat_reflectance;
  const float* mat_ior;
  const float* light_corner;  // (L,3)
  const float* light_edge_u;
  const float* light_edge_v;
  const float* env_horizon;    // (4,)
  const float* env_zenith;     // (4,)
  const float* env_ground;     // (3,)
  const float* env_light_dir;  // (4,)
  const float* consts;         // (kConsts,) kernels/shade.py::frame_constants
  const long long* prev_rays;  // (2,) the wave's ray counts
  // outputs
  float* packed;  // (N,40): kPackedF f32 words, then kPackedI i32 as bits
  int* key;       // (N,)
  unsigned long long* tally;  // (4,) zeroed: semantic, traced, live, and
                              // the key runs permute_kernel adds; (5,)
                              // where maps is set: and the cutout lanes
  int n, n_spheres, n_lights, n_spp, bounce_limit, rr_start, width, height,
      aa_jitter, tint, mb, db, morton, flat;
  unsigned seed, frame;
  float rr_clamp;
  // the maps, read by the maps instance only (all zero where maps is 0)
  const unsigned char* tex_data;  // (K,tex_h,tex_w,3) sRGB texels
  const int* tex_size;            // (K,2): each texture's height, width
  const float* srgb;              // (256,) shading.srgb_to_linear of a byte
  const int* obj_sampler;
  const int* mat_albedo_tex;
  const int* mat_metalness_tex;
  const int* mat_alpha_tex;
  int maps;  // launch the maps instance
  int enable_normal_maps, tex_h, tex_w;
  float bump_scale;
};

struct NeeArgs {
  const int* li;
  const float* l_dir;  // (N,3)
  const float* l_dist;
  const unsigned char* nee_active;
  const unsigned char* occluded;  // null without rect lights
  const float* cos_pdf_at_l;
  const float* nee_k;  // (N,3)
  const unsigned char* is_diff;
  const unsigned char* fresh_direct;
  const float* direct_base;   // (N,3)
  const float* light_normal;  // (L,3)
  const float* light_area;
  const int* light_mat;
  const float* mat_emission;  // (M,3)
  const float* mat_emission_strength;
  float* direct;  // (N,3) out
  int n, n_lights;
};

namespace {

constexpr int kBlock = 256;
constexpr int kPackedF = 34;  // integrator/shading.py::PACKED_F
constexpr int kPackedI = 6;   // PACKED_I
constexpr int kRow = kPackedF + kPackedI;  // ROW: 40 words, 160 B
constexpr int kRowChunks = kRow / 4;       // 16-byte chunks of a row
constexpr float kInvPi = 0.3183098862f;  // sampling/bsdf.py::INV_PI

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 splat(float v) { return {v, v, v}; }

// ops/intersect.py: dot and cross written out left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

// torch.clamp: a NaN passes through (ATen clamp_*_kernel_cuda)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// Tensor.max(dim=-1) over three values: a NaN wins
__device__ __forceinline__ float max3(V3 a) {
  float m = a.x;
  m = (isnan(m) || m > a.y) ? m : a.y;
  m = (isnan(m) || m > a.z) ? m : a.z;
  return m;
}

// sampling/rng.py: pcg4d over uint32 words
__device__ __forceinline__ void pcg4d(unsigned v[4]) {
  for (int k = 0; k < 4; ++k) v[k] = v[k] * 1664525u + 1013904223u;
  v[0] += v[1] * v[3];
  v[1] += v[2] * v[0];
  v[2] += v[0] * v[1];
  v[3] += v[1] * v[2];
  for (int k = 0; k < 4; ++k) v[k] ^= v[k] >> 16;
  v[0] += v[1] * v[3];
  v[1] += v[2] * v[0];
  v[2] += v[0] * v[1];
  v[3] += v[1] * v[2];
}

// rng.uniforms(seed, pixel, frame, sample, bounce, n): n <= 8 draws
__device__ __forceinline__ void uniforms(unsigned seed, unsigned pixel,
                                         unsigned frame, unsigned sample,
                                         unsigned bounce, int n, float* out) {
  const unsigned b = seed ^ (frame * 0x9E3779B9u);
  const unsigned c = sample * 0x85EBCA6Bu + bounce;
  for (int blk = 0; 4 * blk < n; ++blk) {
    unsigned v[4] = {pixel, b, c, static_cast<unsigned>(blk)};
    pcg4d(v);
    for (int k = 0; k < 4 && 4 * blk + k < n; ++k) {
      out[4 * blk + k] = static_cast<float>(v[k]) * 2.3283064365386963e-10f;
    }
  }
}

// ops/env.py::smoothstep with the division as torch's CUDA kernel does it
__device__ __forceinline__ float smoothstep(float e0, float inv_width,
                                            float x) {
  const float t = clamp((x - e0) * inv_width, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

// ops/env.py::environment_light
__device__ __forceinline__ V3 environment_light(const float* hz,
                                                 const float* zn,
                                                 const float* gr,
                                                 const float* ld, V3 d) {
  const float neg_y = -d.y;
  const float sky_t = powf(smoothstep(0.0f, 1.0f / 0.4f, neg_y), 0.35f);
  const V3 hor = {hz[0], hz[1], hz[2]};
  const V3 zen = {zn[0], zn[1], zn[2]};
  const V3 ground = {gr[0], gr[1], gr[2]};
  const V3 sky = hor + (zen - hor) * sky_t;
  const float cos_sun =
      clamp_min(-(d.x * ld[0] + d.y * ld[1] + d.z * ld[2]), 0.0f);
  const float sun = powf(cos_sun, hz[3]) * zn[3];
  const float ground_to_sky = smoothstep(-0.01f, 1.0f / 0.01f, neg_y);
  const float sun_mask = ground_to_sky >= 1.0f ? 1.0f : 0.0f;
  const V3 col =
      (ground + (sky - ground) * ground_to_sky) + splat(sun * sun_mask);
  return ld[3] == 1.0f ? col : splat(0.0f);
}

// integrator/shading.py::primary_rays of pixel pix at sample ``sample``
// (k: kernels/shade.py::frame_constants)
__device__ __forceinline__ void raygen(const float* k, int width, int height,
                                       bool jitter, unsigned seed,
                                       unsigned frame, int pix, int sample,
                                       V3* o, V3* d) {
  float x = static_cast<float>(pix % width);
  float y = static_cast<float>(pix / width);
  if (jitter) {
    float jit[2];
    uniforms(seed ^ 0xA11A5u, static_cast<unsigned>(pix), frame,
             static_cast<unsigned>(sample), 999u, 2, jit);
    x = x + (jit[0] - 0.5f);
    y = y + (jit[1] - 0.5f);
  }
  const float u = x * (1.0f / static_cast<float>(width));
  const float v = y * (1.0f / static_cast<float>(height));
  const float px = k[14] + k[12] * u;  // -plane_w / 2 + plane_w * u
  const float py = k[15] + k[13] * v;
  const V3 point = {px, py, 0.1f};
  const V3 p = point / norm(point);
  *d = {p.x * k[0] + p.y * k[1] + p.z * k[2],
        p.x * k[3] + p.y * k[4] + p.z * k[5],
        p.x * k[6] + p.y * k[7] + p.z * k[8]};
  *o = {k[9], k[10], k[11]};
}

// integrator/shading.py::bin_key of the lane's next ray (k as in raygen)
__device__ __forceinline__ int bin_key(const float* k, int mb, int db,
                                       bool morton_bits, V3 o, V3 d,
                                       bool alive) {
  const int oct = (d.x < 0.0f ? 1 : 0) + 2 * (d.y < 0.0f ? 1 : 0) +
                  4 * (d.z < 0.0f ? 1 : 0);
  int key = oct << (3 * mb + 3 * db);
  if (db) {
    const float scale = static_cast<float>(1 << db);
    const float top = static_cast<float>((1 << db) - 1);
    const int q0 = static_cast<int>(clamp(fabsf(d.x) * scale, 0.0f, top));
    const int q1 = static_cast<int>(clamp(fabsf(d.y) * scale, 0.0f, top));
    const int q2 = static_cast<int>(clamp(fabsf(d.z) * scale, 0.0f, top));
    key = key | (((q0 << (2 * db)) | (q1 << db) | q2) << (3 * mb));
  }
  if (morton_bits) {
    const float* box = k + 16;  // minimum 3, extent 3
    const float scale = static_cast<float>(1 << mb);
    const float top = static_cast<float>((1 << mb) - 1);
    const float oc[3] = {o.x, o.y, o.z};
    int cell[3];
    for (int ax = 0; ax < 3; ++ax) {
      cell[ax] = static_cast<int>(
          clamp(((oc[ax] - box[ax]) / box[3 + ax]) * scale, 0.0f, top));
    }
    int morton = 0;
    for (int b = 0; b < mb; ++b) {
      for (int ax = 0; ax < 3; ++ax) {
        morton = morton | (((cell[ax] >> b) & 1) << (3 * b + ax));
      }
    }
    key = key | morton;
  }
  return alive ? key : (1 << 30);
}

// One block of four draws of rng.uniforms(seed, pixel, frame, sample,
// bounce, n): draws 4 blk .. 4 blk + 3
__device__ __forceinline__ void draws4(unsigned seed, unsigned pixel,
                                       unsigned frame, unsigned sample,
                                       unsigned bounce, unsigned blk,
                                       float out[4]) {
  unsigned v[4] = {pixel, seed ^ (frame * 0x9E3779B9u),
                   sample * 0x85EBCA6Bu + bounce, blk};
  pcg4d(v);
  for (int k = 0; k < 4; ++k) {
    out[k] = static_cast<float>(v[k]) * 2.3283064365386963e-10f;
  }
}

__device__ __forceinline__ void put2(float* row, int c, float x, float y) {
  *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
}
__device__ __forceinline__ void put2(int* row, int c, int x, int y) {
  *reinterpret_cast<int2*>(row + c) = make_int2(x, y);
}

// integrator/shading.py::sample_texture, channels 0 .. kCh - 1 of texture
// ``tex_id`` (clamped to 0) at (u, v) into ``out``: bilinear where
// ``sampler`` is 1, else nearest; uv wrapped, v flipped, each tap clamped
// to the texture's own size in the padded stack.
template <int kCh>
__device__ __forceinline__ void sample_texture(const ShadeArgs& a, int tex_id,
                                               float u_in, float v_in,
                                               int sampler, float* out) {
  const int tid = max(tex_id, 0);
  const float h = static_cast<float>(a.tex_size[2 * tid]);
  const float w = static_cast<float>(a.tex_size[2 * tid + 1]);
  const float u = u_in - floorf(u_in);
  const float v = v_in - floorf(v_in);
  const float fx = u * w - 0.5f;
  const float fy = (1.0f - v) * h - 0.5f;
  const int x_max = static_cast<int>(w - 1.0f);
  const int y_max = static_cast<int>(h - 1.0f);
  const unsigned char* img =
      a.tex_data + static_cast<long long>(tid) * a.tex_h * a.tex_w * 3;
  // the texel's offset in ``img`` (its first channel)
  const auto at = [&](int ix, int iy) {
    ix = min(max(ix, 0), x_max);
    iy = min(max(iy, 0), y_max);
    return (static_cast<long long>(iy) * a.tex_w + ix) * 3;
  };
  const auto lin = [&](long long t, int c) {
    return __ldg(a.srgb + __ldg(img + t + c));
  };
  if (sampler == 1) {
    const int x0 = static_cast<int>(floorf(fx));
    const int y0 = static_cast<int>(floorf(fy));
    const int x1 = static_cast<int>(static_cast<unsigned>(x0) + 1u);
    const int y1 = static_cast<int>(static_cast<unsigned>(y0) + 1u);
    const float ax = fx - static_cast<float>(x0);
    const float ay = fy - static_cast<float>(y0);
    const long long t00 = at(x0, y0), t10 = at(x1, y0);
    const long long t01 = at(x0, y1), t11 = at(x1, y1);
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      out[c] = lin(t00, c) * (1.0f - ax) * (1.0f - ay) +
               lin(t10, c) * ax * (1.0f - ay) +
               lin(t01, c) * (1.0f - ax) * ay + lin(t11, c) * ax * ay;
    }
  } else {
    const long long t = at(static_cast<int>(rintf(fx)),
                           static_cast<int>(rintf(fy)));
#pragma unroll
    for (int c = 0; c < kCh; ++c) out[c] = lin(t, c);
  }
}

// The round's counts of one thread's lanes
struct Counts {
  int alive = 0, sem = 0, act = 0;
  int cut = 0;  // the maps instance's cutout lanes
};

// Lane i from its pending hit to its next state: its packed row into
// ``f`` (34 floats) and ``fi`` (6 ints), each 8-byte aligned, its bin key
// into a.key[i], its counts into ``cnt``.  Each value is the first form's
// (and so the plain version's), each expression on the same operands.  A
// value goes into the row as soon as it is known, so that it holds no
// register: the ray, ``direct_base`` and the light sample are written
// early, and the ray and ``direct_base`` written again where the lane
// continues, regenerates or ends its path.  kLazy runs the sky, the second
// block of draws with the BSDF lobes, and the camera ray only where a
// lane's select takes them (false: on every lane, as the first form).
// kMaps adds the material maps and the bump maps (the maps instance).
template <bool kLazy, bool kMaps = false>
__device__ __forceinline__ void shade_lane(const ShadeArgs& a,
                                           const long long i, float* f,
                                           int* fi, Counts& cnt) {
  const V3 O = ld3(a.origin, i), D = ld3(a.direction, i);
  // the ray of a lane that is not alive next
  put2(f, 0, O.x, O.y);
  put2(f, 2, O.z, D.x);
  put2(f, 4, D.y, D.z);
  const float dst = a.dst[i];
  const int kind = a.kind[i], prim = a.prim[i];
  const V3 AT = ld3(a.atten, i);
  bool bad = a.bad[i] != 0;
  const bool alive = a.alive[i] != 0;
  const int j = a.j[i], s = a.s[i], sb = a.sb[i], pix = a.pix[i];
  put2(fi, 2, pix, a.slot[i]);
  const bool did_hit = kind != 0;
  const bool did = alive && did_hit;

  // ---- shading.shade_fetch, the flattened and sphere branches
  const V3 hp = O + D * dst;
  const bool is_tri = kind == 2;
  const float4* row =
      reinterpret_cast<const float4*>(a.table) + 12ll * (is_tri ? prim : 0);
  const float4 r0 = row[0], r1 = row[1], r2 = row[2];
  const float4 r4 = row[4], r5 = row[5];
  const V3 vn0 = {r0.x, r0.y, r0.z}, vn1 = {r0.w, r1.x, r1.y};
  const V3 vn2 = {r1.z, r1.w, r2.x};
  V3 albedo = {r4.x, r4.y, r4.z}, emission = {r4.w, r5.x, r5.y};
  float refl = r5.z, ior = r5.w;
  float hu, hv;
  bool front;
  if (a.flat) {
    const float4 r8 = row[8], r9 = row[9], r10 = row[10];
    const V3 tv0 = {r8.x, r8.y, r8.z}, te1 = {r8.w, r9.x, r9.y};
    const V3 te2 = {r9.z, r9.w, r10.x}, tn = {r10.y, r10.z, r10.w};
    const V3 d_eps = {D.x == 0.0f ? 1e-20f : D.x, D.y == 0.0f ? 1e-20f : D.y,
                      D.z == 0.0f ? 1e-20f : D.z};
    const V3 q3 = cross(O - tv0, d_eps);
    const float d0 = -dot(d_eps, tn);
    const float dinv = 1.0f / (d0 == 0.0f ? 1e-20f : d0);
    hu = is_tri ? dot(te2, q3) * dinv : 0.0f;
    hv = is_tri ? -dot(te1, q3) * dinv : 0.0f;
    front = is_tri ? d0 >= 1e-8f : a.front[i] != 0;
  } else {
    hu = a.hit_u[i];
    hv = a.hit_v[i];
    front = a.front[i] != 0;
  }
  const float w = 1.0f - hu - hv;
  const float fs = front ? 1.0f : -1.0f;
  V3 n_world = (vn0 * w + vn1 * hu + vn2 * hv) * fs;
  // the maps instance: the uv, and the maps and sampler of the row
  float uvx = 0.0f, uvy = 0.0f;
  int tex_id = -1, sampler = 0, metal_tex = -1, alpha_tex = -1;
  int bump_tex = -1;
  if (kMaps) {
    const float4 r3 = row[3];
    uvx = r2.y * w + r2.w * hu + r3.y * hv;
    uvy = r2.z * w + r3.x * hu + r3.z * hv;
    if (r3.w > 0.5f) {  // the row's degenerate-uv flag
      uvx = 0.5f;
      uvy = 0.5f;
    }
    if (a.flat) {
      const float4 r6 = row[6], r7 = row[7];
      tex_id = static_cast<int>(r6.x);
      sampler = static_cast<int>(r6.y);
      metal_tex = static_cast<int>(r7.y);
      alpha_tex = static_cast<int>(r7.z);
      bump_tex = static_cast<int>(r7.w);
    }
  }
  if (!a.flat) {
    // instance frame and material (a scene with no meshes: instance 0)
    const int oi = is_tri ? a.obj[i] : 0;
    const float* m = a.obj_transform + 16ll * oi;
    const V3 n_obj = n_world;
    n_world = {m[0] * n_obj.x + m[1] * n_obj.y + m[2] * n_obj.z,
               m[4] * n_obj.x + m[5] * n_obj.y + m[6] * n_obj.z,
               m[8] * n_obj.x + m[9] * n_obj.y + m[10] * n_obj.z};
    const int mat = a.obj_mat[oi];
    albedo = ld3(a.mat_albedo, mat);
    emission = ld3(a.mat_emission, mat) * a.mat_emission_strength[mat];
    refl = a.mat_reflectance[mat];
    ior = a.mat_ior[mat];
    if (kMaps) {
      tex_id = a.mat_albedo_tex[mat];
      sampler = a.obj_sampler[oi];
      metal_tex = a.mat_metalness_tex[mat];
      alpha_tex = a.mat_alpha_tex[mat];
    }
  }
  V3 normal = n_world / clamp_min(norm(n_world), 1e-20f);
  // ---- shading.bump: a flattened scene's triangle with a bump map and a
  // solvable uv frame tilts its normal along the height gradient
  if (kMaps && a.flat && a.enable_normal_maps && is_tri && bump_tex >= 0) {
    const float4 r8 = row[8], r9 = row[9], r10 = row[10];
    const V3 e1 = {r8.w, r9.x, r9.y}, e2 = {r9.z, r9.w, r10.x};
    const float4 r3 = row[3];
    const float du1 = r2.w - r2.y, dv1 = r3.x - r2.z;
    const float du2 = r3.y - r2.y, dv2 = r3.z - r2.z;
    const float det = du1 * dv2 - du2 * dv1;
    if (fabsf(det) > 1e-12f) {
      const float inv = 1.0f / det;
      V3 t_vec = (e1 * dv2 - e2 * dv1) * inv;
      const V3 b_vec = (e2 * du1 - e1 * du2) * inv;
      t_vec = t_vec - normal * dot(t_vec, normal);
      const V3 t_hat = t_vec / clamp_min(norm(t_vec), 1e-20f);
      const V3 b_ortho = b_vec - normal * dot(b_vec, normal) -
                         t_hat * dot(b_vec, t_hat);
      const V3 b_hat = b_ortho / clamp_min(norm(b_ortho), 1e-20f);
      const float step_u =
          1.0f / clamp_min(static_cast<float>(a.tex_size[2 * bump_tex + 1]),
                           2.0f);
      const float step_v =
          1.0f / clamp_min(static_cast<float>(a.tex_size[2 * bump_tex]), 2.0f);
      float h0, h_u, h_v;
      sample_texture<1>(a, bump_tex, uvx, uvy, sampler, &h0);
      sample_texture<1>(a, bump_tex, uvx + step_u, uvy + 0.0f, sampler, &h_u);
      sample_texture<1>(a, bump_tex, uvx + 0.0f, uvy + step_v, sampler, &h_v);
      const V3 pert = normal - a.bump_scale * ((h_u - h0) * t_hat +
                                               (h_v - h0) * b_hat);
      normal = pert / clamp_min(norm(pert), 1e-20f);
    }
  }
  if (a.n_spheres > 0 && kind == 1) {
    const int si = prim;
    V3 s_n = hp - ld3(a.sphere_pos, si);
    s_n = s_n / clamp_min(norm(s_n), 1e-20f);
    s_n = s_n * fs;
    const int sm = a.sphere_mat[si];
    normal = s_n;
    albedo = ld3(a.mat_albedo, sm);
    emission = ld3(a.mat_emission, sm) * a.mat_emission_strength[sm];
    refl = a.mat_reflectance[sm];
    ior = a.mat_ior[sm];
    if (kMaps) {  // the sampler stays the row's (or instance 0's)
      tex_id = a.mat_albedo_tex[sm];
      metal_tex = a.mat_metalness_tex[sm];
      alpha_tex = a.mat_alpha_tex[sm];
    }
  }

  // ---- shading.apply_material_maps: the albedo map multiplies the
  // albedo, the metalness map's red channel replaces the reflectance, an
  // alpha map's red channel below 0.5 cuts the surface out (a
  // pass-through delta bounce, emission zeroed); a map index is -1 where
  // the scene has no such map, as the plain version's meta counts say
  bool cutout = false;
  if (kMaps) {
    if (tex_id >= 0) {
      float rgb[3];
      sample_texture<3>(a, tex_id, uvx, uvy, sampler, rgb);
      albedo = albedo * V3{rgb[0], rgb[1], rgb[2]};
    }
    if (metal_tex >= 0) {
      sample_texture<1>(a, metal_tex, uvx, uvy, sampler, &refl);
    }
    if (alpha_tex >= 0) {
      float alpha;
      sample_texture<1>(a, alpha_tex, uvx, uvy, sampler, &alpha);
      cutout = alpha < 0.5f;
    }
    if (cutout) emission = splat(0.0f);
  }

  // ---- pending light resolve
  const V3 DI = ld3(a.direct, i);
  // direct_base of a path that goes on
  f[15] = DI.x;
  put2(f, 16, DI.y, DI.z);
  const bool was_delta = DI.x == -1.0f;
  const V3 final_light = sel(was_delta, emission, DI);
  const V3 contrib = final_light + (j == 0 ? 1.0f : 0.0f) * emission;
  const V3 TO = ld3(a.total, i);
  V3 total = sel(did, TO + contrib * AT, TO);
  const bool nan_or_neg = isnan(total.x) || isnan(total.y) ||
                          isnan(total.z) || total.x < 0.0f ||
                          total.y < 0.0f || total.z < 0.0f;
  bad = bad || (did && nan_or_neg);

  // ---- escape: environment light
  const bool esc = alive && !did_hit;
  if (!kLazy || esc) {
    const V3 env_l = environment_light(a.env_horizon, a.env_zenith,
                                       a.env_ground, a.env_light_dir, D);
    total = sel(esc, total + AT * env_l, total);
  }
  const bool shaded = did && !bad;

  // ---- the light sample (draws 0-3 of rng.uniforms(..., 7))
  const unsigned sample = static_cast<unsigned>(sb + s);
  float u6[4];
  draws4(a.seed, static_cast<unsigned>(pix), a.frame, sample,
         static_cast<unsigned>(j), 0u, u6);
  const bool is_spec = refl != 0.0f;
  const bool is_diel = !is_spec && ior != -1.0f;
  const bool is_diff = !is_spec && !is_diel;
  const bool is_diff_cut = is_diff && !cutout;  // the lane's next is_diff

  const V3 nee_origin = hp + normal * 0.01f;
  int li = 0;
  if (a.n_lights > 1) {
    li = static_cast<int>(u6[0] * static_cast<float>(a.n_lights));
    li = li < a.n_lights - 1 ? li : a.n_lights - 1;
  }
  const V3 point = ld3(a.light_corner, li) + ld3(a.light_edge_u, li) * u6[1] +
                   ld3(a.light_edge_v, li) * u6[2];
  const V3 vec = point - nee_origin;
  const float l_dist = norm(vec);
  const V3 l_dir = vec / clamp_min(l_dist, 1e-20f);
  const float cos_pdf_at_l = clamp_min(dot(l_dir, normal) * kInvPi, 0.0f);
  const V3 nee_k = albedo * (kInvPi * clamp_min(dot(normal, l_dir), 0.0f));
  const bool facing = dot(normal, l_dir) > 0.0f;
  put2(f, 18, nee_origin.x, nee_origin.y);
  put2(f, 20, nee_origin.z, l_dir.x);
  put2(f, 22, l_dir.y, l_dir.z);
  put2(f, 24, nee_k.x, nee_k.y);
  f[26] = nee_k.z;
  put2(f, 30, is_diff_cut ? 1.0f : 0.0f, cos_pdf_at_l);
  f[32] = l_dist;
  put2(fi, 4, li, sb);

  // ---- BSDF lobes (draws 3-6) and the bounce ray: only a shaded lane's
  // are selected
  V3 radiance = splat(1.0f), bounce_origin = splat(0.0f);
  V3 bounce_dir = splat(0.0f);
  float u_rr = 0.0f;
  if (!kLazy || shaded) {
    float u4[4];  // draws 4-7
    draws4(a.seed, static_cast<unsigned>(pix), a.frame, sample,
           static_cast<unsigned>(j), 1u, u4);
    u_rr = u4[2];
    V3 cos_dir = splat(0.0f), rad_diff = splat(0.0f);
    if (!kLazy || is_diff) {
      const float phi = u6[3] * static_cast<float>(2.0 * 3.141592653589793);
      const float sqrt_r2 = sqrtf(u4[0]);
      const float cx = cosf(phi) * sqrt_r2, cy = sinf(phi) * sqrt_r2;
      const float cz = sqrtf(1.0f - u4[0]);
      const V3 non_parallel = fabsf(normal.x) < 1.0f ? V3{1.0f, 0.0f, 0.0f}
                                                     : V3{0.0f, 0.0f, 1.0f};
      V3 t = cross(normal, non_parallel);
      t = t / clamp_min(norm(t), 1e-20f);
      const V3 b = cross(normal, t);
      cos_dir = t * cx + b * cy + normal * cz;
      const float real_cos_pdf =
          clamp_min(dot(cos_dir, normal) * kInvPi, 0.0f);
      rad_diff = albedo * kInvPi *
                 (dot(normal, cos_dir) / clamp_min(real_cos_pdf, 1e-20f));
    }
    V3 dir_spec = splat(0.0f), dir_diel = splat(0.0f);
    float sign_diel = 1.0f;
    if (!kLazy || !is_diff) {
      dir_spec = D - (2.0f * dot(D, normal)) * normal;
      if (!kLazy || is_diel) {
        const float ior_eff = front ? 1.0f / ior : ior;
        const float cosine = dot(-D, normal);
        const float sine = sqrtf(clamp_min(1.0f - cosine * cosine, 0.0f));
        float r0s = (1.0f - ior_eff) / (1.0f + ior_eff);
        r0s = r0s * r0s;
        const float xs = 1.0f - cosine;
        const float x2 = xs * xs;
        const float schlick = r0s + (1.0f - r0s) * (xs * (x2 * x2));
        const bool solution = (ior_eff * sine > 1.0f) || (schlick > u4[1]);
        const float cos_i = dot(normal, D);
        const float k = 1.0f - ior_eff * ior_eff * (1.0f - cos_i * cos_i);
        const V3 refr = ior_eff * D -
                        (ior_eff * cos_i + sqrtf(clamp_min(k, 0.0f))) * normal;
        dir_diel = sel(solution, dir_spec, sel(k < 0.0f, splat(0.0f), refr));
        const float dn = dot(normal, D);
        const float sign_dn =
            static_cast<float>((0.0f < dn ? 1 : 0) - (dn < 0.0f ? 1 : 0));
        sign_diel = solution ? 1.0f : sign_dn;
      }
    }
    bounce_dir = sel(is_spec, dir_spec, sel(is_diel, dir_diel, cos_dir));
    radiance = sel(is_diff, rad_diff, a.tint ? albedo : splat(1.0f));
    const float origin_sign = is_diel ? sign_diel : 1.0f;
    bounce_origin = hp + normal * (origin_sign * 1e-5f);
    if (cutout) {  // straight through the surface
      bounce_dir = D;
      radiance = splat(1.0f);
      bounce_origin = hp + D * 1e-4f;
    }
  }
  V3 atten = AT * sel(shaded, radiance, splat(1.0f));

  // ---- russian roulette
  float rr = clamp_max(max3(atten), a.rr_clamp);
  rr = j <= a.rr_start ? 1.0f : rr;
  const bool killed = u_rr > rr;
  atten = atten / clamp_min(rr, 1e-20f);

  const bool continuing = shaded && !killed && j < a.bounce_limit;
  const bool nee_sem = continuing && is_diff_cut;
  const bool nee_active = nee_sem && facing;

  // ---- sample completion and regeneration
  const bool path_ends = alive && !continuing;
  const V3 acc =
      ld3(a.acc, i) + sel(path_ends, sel(bad, splat(0.0f), total), splat(0.0f));
  const int s_new = s + (path_ends ? 1 : 0);
  const bool regen = path_ends && s_new < a.n_spp;
  V3 po = splat(0.0f), pd = splat(0.0f);
  if (!kLazy || regen) {
    raygen(a.consts, a.width, a.height, a.aa_jitter != 0, a.seed, a.frame,
           pix, sb + s_new, &po, &pd);
  }
  const bool alive_next = continuing || regen;
  int key = 1 << 30;  // bin_key of a lane that is not alive next
  if (alive_next) {
    const V3 new_origin = sel(continuing, bounce_origin, po);
    const V3 new_dir = sel(continuing, bounce_dir, pd);
    put2(f, 0, new_origin.x, new_origin.y);
    put2(f, 2, new_origin.z, new_dir.x);
    put2(f, 4, new_dir.y, new_dir.z);
    key = bin_key(a.consts, a.mb, a.db, a.morton != 0, new_origin, new_dir,
                  true);
  }
  const int j_new = continuing ? j + 1 : 0;
  total = sel(path_ends, splat(0.0f), total);
  atten = sel(path_ends, splat(1.0f), atten);
  bad = bad && !path_ends;
  const bool fresh_direct = shaded && !path_ends;
  if (path_ends) {  // direct_base 0
    f[15] = 0.0f;
    put2(f, 16, 0.0f, 0.0f);
  }

  // ---- the rest of the packed rows (shading.pack_lanes) and the bin key
  put2(f, 6, atten.x, atten.y);
  put2(f, 8, atten.z, total.x);
  put2(f, 10, total.y, total.z);
  put2(f, 12, acc.x, acc.y);
  f[14] = acc.z;
  f[27] = alive_next ? 1.0f : 0.0f;
  put2(f, 28, bad ? 1.0f : 0.0f, fresh_direct ? 1.0f : 0.0f);
  f[33] = nee_active ? 1.0f : 0.0f;
  put2(fi, 0, j_new, s_new);
  a.key[i] = key;

  cnt.alive += alive_next;
  cnt.sem += a.n_lights > 0 && nee_sem;
  cnt.act += a.n_lights > 0 && nee_active;
  if (kMaps) cnt.cut += shaded && cutout;
}

// The first ``words`` (a multiple of 4) 32-bit words of a shared-memory
// tile to ``dst`` (16-byte aligned) as one TMA bulk store, issued by
// thread 0 into the thread's bulk group.  The tile's writers have made
// their writes visible to the async proxy (fence.proxy.async) and passed a
// barrier.
__device__ __forceinline__ void store_tile(const void* tile, void* dst,
                                           int words) {
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            __cvta_generic_to_global(dst)),
        "r"(static_cast<unsigned>(__cvta_generic_to_shared(tile))),
        "r"(4 * words)
        : "memory");
  }
}

// Thread 0's bulk stores: committed as one group / their reads of shared
// memory waited for
__device__ __forceinline__ void commit_stores() {
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}
__device__ __forceinline__ void wait_store_reads() {
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The block's counts into the round's tally: warp sums, then one atomic
// per counter (the wave's earlier rays added once, by block 0).  Every
// thread of the block calls it.
__device__ __forceinline__ void add_counts(const ShadeArgs& a, Counts cnt) {
  __shared__ int warp_sums[kBlock / 32][3];
  const int alive = __reduce_add_sync(0xffffffffu, cnt.alive);
  const int sem = __reduce_add_sync(0xffffffffu, cnt.sem);
  const int act = __reduce_add_sync(0xffffffffu, cnt.act);
  if ((threadIdx.x & 31) == 0) {
    warp_sums[threadIdx.x / 32][0] = alive;
    warp_sums[threadIdx.x / 32][1] = sem;
    warp_sums[threadIdx.x / 32][2] = act;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b_alive = 0, b_sem = 0, b_act = 0;
    for (int w = 0; w < kBlock / 32; ++w) {
      b_alive += warp_sums[w][0];
      b_sem += warp_sums[w][1];
      b_act += warp_sums[w][2];
    }
    unsigned long long sem_rays = b_alive + b_sem, traced = b_alive + b_act;
    if (blockIdx.x == 0) {
      sem_rays += static_cast<unsigned long long>(a.prev_rays[0]);
      traced += static_cast<unsigned long long>(a.prev_rays[1]);
    }
    atomicAdd(a.tally, sem_rays);
    atomicAdd(a.tally + 1, traced);
    atomicAdd(a.tally + 2, b_alive);
  }
}

// The maps instance's cutout lanes (shaded lanes whose alpha map cut the
// surface out) into the tally's fifth word: a warp sum, then one atomic a
// warp where it is not zero.  Every thread of the block calls it.
__device__ __forceinline__ void add_cutouts(const ShadeArgs& a, Counts cnt) {
  const int cut = __reduce_add_sync(0xffffffffu, cnt.cut);
  if ((threadIdx.x & 31) == 0 && cut > 0) {
    atomicAdd(a.tally + 4, static_cast<unsigned long long>(cut));
  }
}

// One block a tile of 256 lanes: the lanes' rows into the tile, then the
// tile out by TMA while the block adds its counts.  kMaps: the maps
// instance, capped at 80 registers (3 blocks an SM) for its texel taps.
template <bool kMaps>
__global__ void __launch_bounds__(kBlock, kMaps ? 3 : 4)
    shade_kernel(const ShadeArgs a) {
  __shared__ __align__(16) float tile[kBlock * kRow];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int rows = min(kBlock, a.n - static_cast<int>(base));
  Counts cnt;
  if (static_cast<int>(threadIdx.x) < rows) {
    float* row = tile + kRow * threadIdx.x;
    shade_lane<true, kMaps>(a, base + threadIdx.x, row,
                            reinterpret_cast<int*>(row + kPackedF), cnt);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  store_tile(tile, a.packed + kRow * base, kRow * rows);
  commit_stores();
  add_counts(a, cnt);
  if constexpr (kMaps) add_cutouts(a, cnt);
  wait_store_reads();  // the tile lives until the block exits
}

// The warp's ``rows`` (<= 32) packed rows, row r = row ``src`` of lane r
// (``src`` of a lane past ``rows`` is never read), gathered by the TMA
// engine into the warp's 32-row tile ``wt``: lane r copies its row with
// one 160-byte bulk copy that completes on the warp's mbarrier ``bar``,
// lane 0 arms the barrier with the bytes to come, and every lane waits
// for them.  Every lane of the warp calls it, once per ``bar``.
__device__ __forceinline__ void tma_rows(const float* __restrict__ packed,
                                         long long src, int rows, int lane,
                                         float* wt, unsigned long long* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (lane == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(static_cast<unsigned>(rows * kRow * 4))
        : "memory");
  }
  if (lane < rows) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(static_cast<unsigned>(
            __cvta_generic_to_shared(wt + kRow * lane))),
        "l"(packed + kRow * src), "r"(kRow * 4), "r"(b)
        : "memory");
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// Row ``lane`` of the warp's tile ``wt`` (rows 40 words apart) into ``f``
__device__ __forceinline__ void tile_row(const float* wt, int lane,
                                         float f[kRow]) {
  const float4* row = reinterpret_cast<const float4*>(wt + kRow * lane);
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    const float4 v = row[k];
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// Lane i's columns: the nine (N,3) vectors, three scalar stores each;
// cos_pdf_at_l and l_dist; the flags alive, bad, fresh_direct, is_diff and
// nee_active (row value > 0.5); the six i32 words.
__device__ __forceinline__ void store_lane(const float f[kRow],
                                           float* __restrict__ vec,
                                           float* __restrict__ cols,
                                           unsigned char* __restrict__ flags,
                                           int* __restrict__ ints,
                                           long long i, int n) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float* dst = vec + (static_cast<long long>(k) * n + i) * 3;
    dst[0] = f[3 * k];
    dst[1] = f[3 * k + 1];
    dst[2] = f[3 * k + 2];
  }
  cols[i] = f[31];
  cols[n + i] = f[32];
  flags[i] = f[27] > 0.5f;
  flags[n + i] = f[28] > 0.5f;
  flags[2ll * n + i] = f[29] > 0.5f;
  flags[3ll * n + i] = f[30] > 0.5f;
  flags[4ll * n + i] = f[33] > 0.5f;
#pragma unroll
  for (int c = 0; c < kPackedI; ++c) {
    ints[c * static_cast<long long>(n) + i] = __float_as_int(f[kPackedF + c]);
  }
}

// integrator/shading.py::key_runs over the warp's lanes: the live lanes
// whose sorted key differs from the key before them, summed over the warp
// and added to ``runs`` by lane 0 (the warp's lanes all call it).
__device__ __forceinline__ void add_key_runs(const int* __restrict__ skey,
                                             unsigned long long* runs,
                                             long long base, int lane,
                                             int rows) {
  constexpr int kDead = 1 << 30;  // shading.DEAD_KEY
  const int key = lane < rows ? skey[base + lane] : kDead;
  int before = __shfl_up_sync(0xffffffffu, key, 1);
  if (lane == 0) before = base > 0 ? skey[base - 1] : ~key;
  const int starts =
      __reduce_add_sync(0xffffffffu, key != kDead && key != before ? 1 : 0);
  if (lane == 0 && starts > 0) {
    atomicAdd(runs, static_cast<unsigned long long>(starts));
  }
}

// integrator/shading.py::unpack_lanes of the rows in ``order``: nine (N,3)
// vectors, the columns cos_pdf_at_l and l_dist, the flags alive, bad,
// fresh_direct, is_diff and nee_active (row value > 0.5), six i32 columns;
// the runs of the sorted keys ``skey`` added to ``runs``.  Each warp
// takes 32 lanes in its 32-row part of the block's tile.
__global__ void __launch_bounds__(kBlock)
    permute_kernel(const float* __restrict__ packed,
                   const long long* __restrict__ order, float* __restrict__ vec,
                   float* __restrict__ cols, unsigned char* __restrict__ flags,
                   int* __restrict__ ints, const int* __restrict__ skey,
                   unsigned long long* runs, int n) {
  __shared__ __align__(16) float tile[kBlock * kRow];
  __shared__ __align__(8) unsigned long long bars[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * kBlock + (threadIdx.x & ~31);
  if (base >= n) return;  // the whole warp
  const int rows = static_cast<int>(min(32ll, n - base));
  float* wt = tile + kRow * (threadIdx.x & ~31);
  const long long i = base + lane;
  add_key_runs(skey, runs, base, lane, rows);
  tma_rows(packed, lane < rows ? order[i] : 0, rows, lane, wt,
           bars + threadIdx.x / 32);
  if (lane >= rows) return;
  float f[kRow];
  tile_row(wt, lane, f);
  store_lane(f, vec, cols, flags, ints, i, n);
}

// shading.analytic_nee and shading.resolve_direct, each value loaded only
// where a select takes it
__global__ void __launch_bounds__(kBlock) nee_resolve_kernel(const NeeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  V3 out;
  if (a.fresh_direct[i] == 0) {
    out = ld3(a.direct_base, i);
  } else if (a.is_diff[i] == 0) {
    out = splat(-1.0f);
  } else {
    V3 l_emit = splat(0.0f);
    // c is read only where the pdf is: elsewhere real_l_pdf is 0 (NaN
    // without lights), and q is 0 (NaN) whatever c holds
    float real_l_pdf = 0.0f, c = 0.0f;
    if (a.n_lights > 0) {
      const int row = a.n_lights <= 1 ? 0 : a.li[i];
      const int mat = a.light_mat[row];
      l_emit = ld3(a.mat_emission, mat) * a.mat_emission_strength[mat];
      if (a.nee_active[i] != 0 && a.occluded[i] == 0) {  // reached
        const V3 l_dir = ld3(a.l_dir, i);
        const float l_dist = a.l_dist[i];
        c = a.cos_pdf_at_l[i];
        const float cos_theta = dot(ld3(a.light_normal, row), l_dir);
        real_l_pdf = l_dist * l_dist / (cos_theta * a.light_area[row]);
      }
    }
    // real_l_pdf / n_lights, as torch's CUDA division by a Python number
    real_l_pdf = real_l_pdf * (1.0f / static_cast<float>(a.n_lights));
    float w1 = real_l_pdf * real_l_pdf / (real_l_pdf * real_l_pdf + c * c);
    w1 = isnan(w1) ? 0.0f : w1;
    const float q = real_l_pdf == 0.0f ? 0.0f : w1 / real_l_pdf;
    out = l_emit * ld3(a.nee_k, i) * q;
  }
  a.direct[3 * i] = out.x;
  a.direct[3 * i + 1] = out.y;
  a.direct[3 * i + 2] = out.z;
}

}  // namespace

// One launch of shade_kernel: the maps instance where ``maps`` is set,
// else the untextured one; returns the launch's CUDA error.
extern "C" int rt_shade_round(const ShadeArgs* a, void* stream) {
  if (a->n < 1 || a->mb < 0 || a->db < 0 || 3 * (a->mb + a->db) + 3 > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool maps = a->maps != 0;
  if (maps && (a->tex_data == nullptr || a->tex_size == nullptr ||
               a->srgb == nullptr || a->obj_sampler == nullptr ||
               a->mat_albedo_tex == nullptr ||
               a->mat_metalness_tex == nullptr ||
               a->mat_alpha_tex == nullptr || a->tex_h < 1 || a->tex_w < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a->n + kBlock - 1) / kBlock), block(kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps) {
    shade_kernel<true><<<grid, block, 0, s>>>(*a);
  } else {
    shade_kernel<false><<<grid, block, 0, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of permute_kernel over n lanes; ``packed`` 16-byte aligned.
extern "C" int rt_permute_rows(const void* packed, const void* order,
                               void* vec, void* cols, void* flags, void* ints,
                               const void* skey, void* runs, int n,
                               void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  permute_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const long long*>(order),
      static_cast<float*>(vec), static_cast<float*>(cols),
      static_cast<unsigned char*>(flags), static_cast<int*>(ints),
      static_cast<const int*>(skey), static_cast<unsigned long long*>(runs),
      n);
  return static_cast<int>(cudaGetLastError());
}

// One launch of nee_resolve_kernel.
extern "C" int rt_nee_resolve(const NeeArgs* a, void* stream) {
  const dim3 grid((a->n + kBlock - 1) / kBlock), block(kBlock);
  nee_resolve_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
