// K21: one online-softmax block update of ring attention.
//
// Replaces the Pallas kernel flash_attention._update_pallas with its body
// _block_kernel (ompi_tpu/ops/flash_attention.py:135, :38-71).  For each of
// B rows (the flattened leading dims: batch, heads, and in the port the mesh
// ranks as well) and each query i:
//
//   s_ij = (q_i . k_j) * d^-1/2 (+ bias_ij)         float32
//   m'_i = max(m_i, max_j s_ij),  c_i = exp(m_i - m'_i)
//   p_ij = exp(s_ij - m'_i)
//   num'_i = num_i * c_i + sum_j p_ij v_j,   den'_i = den_i * c_i + sum_j p_ij
//
// with the reference kernel's casts: products accumulate in float32, m and
// den are upcast, p is rounded to v's dtype before p v (:65-67), and num',
// m', den' are rounded to their dtypes once at the end (:68-71, :186-188).
// One m' for the whole block, as the reference has it: no online softmax
// inside the block, so bf16's p rounds against the same m' as there.
// Inputs are float32 or bfloat16, each with its own dtype code.  The bias is
// optional, one (sq, skv) block per `rows_per_bias` rows (the port gives
// each sp rank its own causal mask in one launch).
//
// Bound on an H100: operations.  4*B*sq*skv*d of them (two products) on
// 4*B*(sq + skv)*d elements: sq*skv/(sq + skv) operations per element, far
// above the ridge at the step's (256) and the bench's (2048) sequence blocks.
// Two bodies, one per input dtype, behind one C entry; both keep one m' for
// the whole block and the reference's unfused ends (s * scale then + bias;
// num * c + pv, den * c + sum p, each rounded on its own), take d 1..256,
// ragged sq and skv, misaligned bases and the per-rank bias, and share the
// plan of the stream: one CTA per (row, query tile: 64 queries, 128 in the
// bfloat16 body at d <= 128); Q, then K and V,
// reach shared memory by 16-byte cp.async (element loads where d is not a
// multiple of 16 bytes' elements or a base is not 16-byte aligned), rows
// padded by 16 bytes against bank conflicts, K and V in units through two
// stages, one in flight while the other is computed, one barrier a unit.
// The block's scores stay on chip where 64 x skv of them fit beside Q and
// the stages; otherwise (the bench's skv = 2048) the second pass recomputes
// each 64-key score tile from K: three products.  The C entry picks the
// form from d, skv and the dtype against the device's shared-memory cap.
// exp is expf, full precision, so a fully masked row at m = -inf gives
// exp(-inf + inf) = NaN as the reference does; keys past skv and queries
// past sq are zero-filled and never enter the max, the sums or the stores.
//
// float32: flash_block_kernel, FFMA on the CUDA cores (no TF32), the
// problem K20's float32 body solved:
//  * 256 threads a CTA, one CTA per SM (the step's 32 rows x 4 tiles are
//    one wave on 132 SMs); a K unit is 64 keys x 128 of d (a score tile's
//    depth runs over consecutive units, in ascending d), a V unit tv keys x
//    all of d (tv = 32 at d = 256);
//  * operands are read from shared memory as 16 bytes of float32: a thread
//    owns a 4 x 4 score tile (queries ty + 16i, keys tx + 16j), 8 reads per
//    64 FFMA; for p v it owns 8 queries x 8 columns (d = 256; 8 x 4 at d <=
//    128), reading p along keys and v along columns, 16 reads per 256 FFMA;
//    each score accumulates over d, and each output over keys, in
//    ascending order;
//  * kept scores: skv <= 320 at d = 256; each thread turns its own into p
//    once m' is known and the V units read p from there; recomputed, each
//    tile's p goes through a 64 x 64 float buffer;
//  * num and den are read whole, 16 bytes at a time where aligned, before
//    the outputs are stored (they may alias for all the compiler knows).
// What still bounds it (PERF.md): the FFMA issue, at about a third of the
// float32 peak; neither the shared-memory reads nor more warps a SM moved it.
//
// bfloat16: flash_block_mma_kernel, both products on the tensor cores as
// mma.sync m16n8k16 bf16 x bf16 -> float32, which is the reference's own
// arithmetic (q k^T and p.astype(v.dtype) v on the MXU with float32
// results, :53-67):
//  * at d <= 128, 4 warps a CTA, each owning two 16-query m-tiles (128
//    queries a CTA) that share every K and V fragment the warp loads, so
//    ldmatrix reads half the bytes an mma that one m-tile a warp would; two
//    CTAs a SM.  Past d = 128 the 16 x d accumulators of p v would not fit:
//    8 warps, two to each of 4 row groups of one m-tile (64 queries), each
//    taking half the keys of a score tile and half the output columns;
//  * K and V units are whole 64-key tiles of all of d, d rounded up to 16
//    (one k-step) with the tail zero-filled (two to four stages measured
//    the same, PERF.md);
//  * operands go from the stages to registers by ldmatrix: .x4 for Q (A)
//    and K (the column-major B of q k^T), .x4.trans for V (B of p v); a
//    warp's scores of a tile are made 32 keys at a time;
//  * the first pass reduces its row max over the quad of lanes that shares
//    a fragment row (__shfl_xor_sync over lanes 1 and 2), then over the two
//    warps that split a tile's keys (through shared memory);
//  * p = expf(s - m') is summed into sum p in float32, then rounded to bf16
//    and only then multiplied with V.  Recomputed at d <= 128, a tile's p
//    goes from the score fragments straight into p v's A fragments (the
//    m16n8 C layout is the m16n8k16 A layout, two bf16 a register);
//    otherwise it goes through a bf16 buffer in shared memory, which the
//    warps of a row group read by ldmatrix;
//  * kept scores (float32, 64 x skv: skv <= 320 at d = 256) are turned into
//    bf16 p by the thread that made them once m' is known;
//  * the score epilogue (scale, bias, the max, exp) is branch-free, so that
//    the exps of a thread's 32 scores overlap;
//  * num is read before its outputs are stored, by m-tile and half of the
//    columns, two elements at a time where aligned; m is read where it is
//    needed rather than held (the d <= 128 body uses all 255 registers).
// What bounds it (PERF.md): ldmatrix's shared-memory reads and the barrier
// a unit, at about a sixth of the bf16 peak at the bench's shape; wgmma
// (64-row warpgroup tiles, B read from shared memory) is the next design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace otpu {
namespace {

constexpr int kTQ = 64;        // queries per CTA
constexpr int kTK = 64;        // keys per score tile
constexpr int kDC = 128;       // d per K unit
constexpr int kThreads = 256;  // score tile 16 x 16 (tx keys, ty queries)
constexpr int kStages = 2;     // one unit in flight while one is computed
constexpr int kPPad = 16;      // floats of padding per row of the p buffer
enum { DT_F32 = 0, DT_BF16 = 1 };
// The body a launch started, for the C entry's *body.
enum { BODY_FFMA = 0, BODY_MMA_SYNC = 1 };

// The shared-memory plan of one launch, computed alike on host and device:
// Q (kTQ x qpitch) and kStages stages of `stage` elements, in the input
// dtype; then floats: the p buffer (kTQ x ppitch) and c (kTQ).
struct Plan {
  int dpad;    // d rounded up to 4
  int qpitch;  // elements per Q row
  int nd;      // K units per score tile (128-wide pieces of d)
  int nkt;     // score tiles
  int tv;      // keys per V unit: a power of two, 16..64
  int kpitch;  // elements per K unit row
  int vpitch;  // elements per V unit row
  int stage;   // elements per stage
  int ppitch;  // floats per p buffer row: all keys (scores on chip) or kTK
  size_t bytes;
};

__host__ __device__ inline Plan make_plan(int d, int skv, int esize,
                                          bool scores) {
  Plan p;
  const int pad = 16 / esize;  // 16 bytes a row, against bank conflicts
  p.dpad = (d + 3) & ~3;
  p.qpitch = p.dpad + pad;
  p.nd = (p.dpad + kDC - 1) / kDC;
  p.nkt = (skv + kTK - 1) / kTK;
  p.kpitch = (p.dpad < kDC ? p.dpad : kDC) + pad;
  p.vpitch = p.dpad + pad;
  p.stage = kTK * p.kpitch;
  p.tv = kTK;
  while (p.tv > 16 && p.tv * p.vpitch > p.stage) p.tv >>= 1;
  p.ppitch = (scores ? p.nkt * kTK : kTK) + kPPad;
  p.bytes = (size_t)esize * ((size_t)kTQ * p.qpitch + (size_t)kStages * p.stage) +
            sizeof(float) * ((size_t)kTQ * p.ppitch + kTQ);
  return p;
}

struct Args {
  const void *q, *k, *v, *m, *num, *den, *bias;
  void *m_out, *num_out, *den_out;
  int sq, skv, d;
  int64_t rows_per_bias;
  float scale;
  int dt_m, dt_num, dt_den, dt_bias;
  int vec;      // 16-byte copies: d a multiple of 16 bytes' elements, aligned q, k, v
  int vec_num;  // 4-element num / num' accesses: d % 4 == 0, aligned num, num_out
};

__device__ __forceinline__ float ld_f(const void* p, int64_t i, int dt) {
  if (dt == DT_F32) return static_cast<const float*>(p)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void st_f(void* p, int64_t i, float v, int dt) {
  if (dt == DT_F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// 4 consecutive elements as float32 (16-byte aligned float32, 8-byte
// aligned bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 4 elements of a float32 or bf16 array at element i (16- or 8-byte aligned)
__device__ __forceinline__ float4 ld4_dt(const void* p, int64_t i, int dt) {
  return dt == DT_F32 ? ld4(static_cast<const float*>(p) + i)
                      : ld4(static_cast<const __nv_bfloat16*>(p) + i);
}
__device__ __forceinline__ void st4_dt(void* p, int64_t i, float4 v, int dt) {
  if (dt == DT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  }
}

// jnp.max / jnp.maximum: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + nrows) x columns [c0, c0 + clen) of an (n x d) matrix into
// shared memory (row pitch `pitch`); rows past n and columns past d are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int nrows, int c0, int clen,
                                          int pitch, int n, int d, bool vec) {
  if (vec) {  // clen and c0 are multiples of CH: a chunk is all in or all out
    constexpr int CH = 16 / sizeof(T);
    const int cpr = clen / CH;
    for (int id = threadIdx.x; id < nrows * cpr; id += kThreads) {
      const int r = id / cpr, c = (id - r * cpr) * CH;
      const bool ok = r0 + r < n;
      cp_async16(dst + r * pitch + c,
                 ok ? src + (int64_t)(r0 + r) * d + c0 + c : src, ok);
    }
  } else {
    for (int id = threadIdx.x; id < nrows * clen; id += kThreads) {
      const int r = id / clen, c = id - r * clen;
      const bool ok = r0 + r < n && c0 + c < d;
      dst[r * pitch + c] = ok ? src[(int64_t)(r0 + r) * d + c0 + c] : zero_of<T>();
    }
  }
}

// Unit u of the stream: the first pass's K units (tile kt, d piece dc), then
// the second pass's: V units alone (scores on chip), or per score tile its
// K units and then its V units (recompute).
struct Unit {
  bool is_v;
  int kt, dc, key0;
};

template <bool SCORES>
__device__ __forceinline__ Unit unit_at(int u, const Plan& pl) {
  const int nk = pl.nkt * pl.nd;
  if (u < nk) return {false, u / pl.nd, u % pl.nd, (u / pl.nd) * kTK};
  const int w = u - nk;
  if (SCORES) return {true, 0, 0, w * pl.tv};
  const int blk = pl.nd + kTK / pl.tv, kt = w / blk, r = w - kt * blk;
  if (r < pl.nd) return {false, kt, r, kt * kTK};
  return {true, kt, 0, kt * kTK + (r - pl.nd) * pl.tv};
}

// NG: groups of 4 output columns a thread owns in p v (1: d <= 128, 2: d <=
// 256); SCORES: the block's scores stay in shared memory.  In the score
// tile thread (tx, ty) owns queries ty + 16i and keys tx + 16j; in p v and
// the output warp w owns queries 8w .. 8w + 7, lane l columns 4(l + 32g) ..
// + 3.
template <typename T, int NG, bool SCORES>
__global__ void __launch_bounds__(kThreads, 1) flash_block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan pl = make_plan(a.d, a.skv, sizeof(T), SCORES);
  T* Qs = reinterpret_cast<T*>(smem);
  T* St = Qs + kTQ * pl.qpitch;
  float* Ps = reinterpret_cast<float*>(St + kStages * pl.stage);
  float* Cs = Ps + kTQ * pl.ppitch;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, w8 = (threadIdx.x >> 5) * 8;
  const int64_t row = blockIdx.x;
  const int q0 = blockIdx.y * kTQ, sq = a.sq, skv = a.skv, d = a.d;
  const T* kg = static_cast<const T*>(a.k) + row * skv * d;
  const T* vg = static_cast<const T*>(a.v) + row * skv * d;
  const int64_t bias_base = (row / a.rows_per_bias) * (int64_t)sq * skv;
  const bool vec = a.vec != 0;
  const int nk = pl.nkt * pl.nd;
  const int total = (SCORES ? nk : 2 * nk) + (skv + pl.tv - 1) / pl.tv;

  auto issue = [&](int u) {
    if (u < total) {
      const Unit t = unit_at<SCORES>(u, pl);
      T* dst = St + (u % kStages) * pl.stage;
      if (t.is_v) {
        load_rows(dst, vg, t.key0, pl.tv, 0, pl.dpad, pl.vpitch, skv, d, vec);
      } else {
        const int d0 = t.dc * kDC;
        load_rows(dst, kg, t.key0, kTK, d0, min(kDC, pl.dpad - d0), pl.kpitch,
                  skv, d, vec);
      }
    }
    cp_async_commit();
  };
  // the query tile rides with the first unit
  load_rows(Qs, static_cast<const T*>(a.q) + row * sq * d, q0, kTQ, 0, pl.dpad,
            pl.qpitch, sq, d, vec);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float s[4][4], rmax[4], new_m[4], psum[4];
  float acc[8][4 * NG];
  bool gv[NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) rmax[i] = -INFINITY, new_m[i] = 0.f, psum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) gv[g] = (lane + 32 * g) * 4 < pl.dpad;

  // p = exp(s - m') for a key (0 past skv), rounded to v's dtype; psum takes
  // it before the rounding, as the reference sums the float32 p
  auto to_p = [&](float sv, int i, int key) {
    float p = 0.f;
    if (key < skv) {
      p = expf(sv - new_m[i]);
      psum[i] += p;
      if (sizeof(T) == 2) p = __bfloat162float(__float2bfloat16_rn(p));
    }
    return p;
  };

  for (int u = 0; u < total; ++u) {
    cp_async_wait<kStages - 2>();  // unit u has landed (for this thread) ...
    __syncthreads();               // ... for all; every thread is done with u - 1
    issue(u + kStages - 1);        // into the stage of u - 1
    const Unit t = unit_at<SCORES>(u, pl);
    const T* S = St + (u % kStages) * pl.stage;
    if (!t.is_v) {
      if (t.dc == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const T* qb = Qs + ty * pl.qpitch + t.dc * kDC;
      const T* kb = S + tx * pl.kpitch;
      const int dlen = min(kDC, pl.dpad - t.dc * kDC);
#pragma unroll 4
      for (int dd = 0; dd < dlen; dd += 4) {
        float4 qa[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = ld4(qb + 16 * i * pl.qpitch + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ld4(kb + 16 * j * pl.kpitch + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
          }
      }
      if (t.dc != pl.nd - 1) continue;
      // the tile's scores: * scale, then + bias
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = t.key0 + tx + 16 * j;
          float v = __fmul_rn(s[i][j], a.scale);
          if (a.bias != nullptr && qi < sq && kj < skv)
            v = __fadd_rn(v, ld_f(a.bias, bias_base + (int64_t)qi * skv + kj,
                                  a.dt_bias));
          s[i][j] = v;
        }
      }
      if (u < nk) {  // first pass: the row max
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (t.key0 + tx + 16 * j < skv) rmax[i] = max_nan(rmax[i], s[i][j]);
            if (SCORES)
              Ps[(ty + 16 * i) * pl.ppitch + t.key0 + tx + 16 * j] = s[i][j];
          }
        if (u != nk - 1) continue;
        // m' and c for the thread's rows (over the 16 threads of a row);
        // with the scores on chip, each thread turns its own into p
        float m_old[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
          m_old[i] = qi < sq ? ld_f(a.m, row * sq + qi, a.dt_m) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            rmax[i] = max_nan(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off, 16));
          new_m[i] = max_nan(m_old[i], rmax[i]);
          if (tx == 0) Cs[ty + 16 * i] = expf(m_old[i] - new_m[i]);
        }
        if (SCORES) {
          for (int kt = 0; kt < pl.nkt; ++kt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float* ps = Ps + (ty + 16 * i) * pl.ppitch + kt * kTK + tx + 16 * j;
                *ps = to_p(*ps, i, kt * kTK + tx + 16 * j);
              }
        }
      } else {  // second pass, recompute: this tile's p
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ps[(ty + 16 * i) * pl.ppitch + tx + 16 * j] =
                to_p(s[i][j], i, t.key0 + tx + 16 * j);
      }
    } else {  // a V unit: acc += p v over its tv keys, in ascending order
      const float* pb = Ps + w8 * pl.ppitch + (SCORES ? t.key0 : t.key0 - t.kt * kTK);
#pragma unroll 2
      for (int kk = 0; kk < pl.tv; kk += 4) {
        float4 pr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pr[i] = ld4(pb + i * pl.ppitch + kk);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            if (!gv[g]) continue;
            const float4 vv = ld4(S + (kk + kq) * pl.vpitch + (lane + 32 * g) * 4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float p = kq == 0 ? pr[i].x : kq == 1 ? pr[i].y
                            : kq == 2 ? pr[i].z : pr[i].w;
              acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // num and den are read whole before anything is stored: the outputs may
  // alias them for all the compiler knows, and a load after a store would
  // wait for it
  float4 nv[8][NG];
  float dv[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t srow = row * sq + q0 + w8 + i;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (lane + 32 * g) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + w8 + i < sq && col < d) {
        if (a.vec_num) {
          x = ld4_dt(a.num, srow * d + col, a.dt_num);
        } else {
          const int64_t e = srow * d + col;
          x.x = ld_f(a.num, e, a.dt_num);
          if (col + 1 < d) x.y = ld_f(a.num, e + 1, a.dt_num);
          if (col + 2 < d) x.z = ld_f(a.num, e + 2, a.dt_num);
          if (col + 3 < d) x.w = ld_f(a.num, e + 3, a.dt_num);
        }
      }
      nv[i][g] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    dv[i] = qi < sq ? ld_f(a.den, row * sq + qi, a.dt_den) : 0.f;
  }
  // m' and den' from the score tile's threads (tx == 0), num' from all
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], off, 16);
    const int qi = q0 + ty + 16 * i;
    if (qi < sq && tx == 0) {
      const int64_t srow = row * sq + qi;
      st_f(a.m_out, srow, new_m[i], a.dt_m);
      st_f(a.den_out, srow, __fadd_rn(__fmul_rn(dv[i], Cs[ty + 16 * i]), psum[i]),
           a.dt_den);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + w8 + i;
    if (qi >= sq) continue;
    const int64_t srow = row * sq + qi;
    const float c = Cs[w8 + i];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (lane + 32 * g) * 4;
      if (col >= d) continue;
      const float4 x = nv[i][g];
      const float4 y = make_float4(__fadd_rn(__fmul_rn(x.x, c), acc[i][4 * g]),
                                   __fadd_rn(__fmul_rn(x.y, c), acc[i][4 * g + 1]),
                                   __fadd_rn(__fmul_rn(x.z, c), acc[i][4 * g + 2]),
                                   __fadd_rn(__fmul_rn(x.w, c), acc[i][4 * g + 3]));
      const int64_t e = srow * d + col;
      if (a.vec_num) {
        st4_dt(a.num_out, e, y, a.dt_num);
      } else {
        st_f(a.num_out, e, y.x, a.dt_num);
        if (col + 1 < d) st_f(a.num_out, e + 1, y.y, a.dt_num);
        if (col + 2 < d) st_f(a.num_out, e + 2, y.z, a.dt_num);
        if (col + 3 < d) st_f(a.num_out, e + 3, y.w, a.dt_num);
      }
    }
  }
}

// ---- bfloat16: the tensor-core body ------------------------------------

namespace mma {

constexpr int kPad = 8;  // bf16 elements of padding a row: 16 bytes

// A CTA's shape by NWC, the warps of a row group: 1 (d <= 128) or 2 (the
// two warps of a row group each take half the keys of a score tile and half
// the output columns); kRowGroups row groups; m-tiles of 16 queries a warp:
// two at d <= 128, which share each K and V fragment the warp loads, one
// past it, where the 16 x d accumulators of p v take the registers.
constexpr int kRowGroups = 4;
__host__ __device__ constexpr int mtiles_of(int nwc) { return nwc == 1 ? 2 : 1; }
__host__ __device__ constexpr int rows_of(int nwc) { return 16 * mtiles_of(nwc) * kRowGroups; }
__host__ __device__ constexpr int threads_of(int nwc) { return 32 * nwc * kRowGroups; }

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The shared-memory plan of one bf16 launch, computed alike on host and
// device: Q (rows x pitch bf16) and kStages stages of 64 keys x pitch bf16,
// the p buffer (rows x ppitch bf16), then floats: the scores (rows x
// spitch) and the cross-warp row reductions (2 x rows).
struct Plan {
  int rows;    // queries a CTA
  int dpad;    // d rounded up to 16, one k-step of m16n8k16
  int pitch;   // elements per Q, K and V row
  int nkt;     // 64-key tiles
  int ppitch;  // elements per p buffer row: all keys (scores kept), one tile
               // (output columns split over two warps) or none
  int spitch;  // floats per score row (0: the scores are recomputed)
  size_t bytes;
};

__host__ __device__ inline Plan make_plan(int d, int skv, int nwc, bool scores) {
  Plan p;
  p.rows = rows_of(nwc);
  p.dpad = (d + 15) & ~15;
  p.pitch = p.dpad + kPad;
  p.nkt = (skv + kTK - 1) / kTK;
  p.ppitch = scores ? p.nkt * kTK + kPad : (nwc == 2 ? kTK + kPad : 0);
  p.spitch = scores ? p.nkt * kTK + 8 : 0;
  p.bytes = 2 * ((size_t)(p.rows + kStages * kTK) * p.pitch + (size_t)p.rows * p.ppitch) +
            sizeof(float) * ((size_t)p.rows * p.spitch + 2 * p.rows);
  return p;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each thread the transposed
// fragment (V as the column-major B of p v).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// two floats rounded to bf16, the lower column in the lower half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [r0, r0 + nrows) x columns [0, dpad) of an (n x d) matrix into
// shared memory (row pitch `pitch`); rows past n and columns past d are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int nrows, int n, int d,
                                          int dpad, int pitch, bool vec) {
  const int threads = blockDim.x;
  if (vec) {  // d a multiple of 8: a 16-byte chunk is all in or all out
    const int cpr = dpad / 8;
    for (int id = threadIdx.x; id < nrows * cpr; id += threads) {
      const int r = id / cpr, c = (id - r * cpr) * 8;
      const bool ok = r0 + r < n && c < d;
      cp_async16(dst + r * pitch + c, ok ? src + (int64_t)(r0 + r) * d + c : src, ok);
    }
  } else {
    for (int id = threadIdx.x; id < nrows * dpad; id += threads) {
      const int r = id / dpad, c = id - r * dpad;
      const bool ok = r0 + r < n && c < d;
      dst[r * pitch + c] = ok ? src[(int64_t)(r0 + r) * d + c]
                              : zero_of<__nv_bfloat16>();
    }
  }
}

// Unit u of the stream: the first pass's K tiles, then the second pass's:
// V tiles alone (scores kept), or per tile its K tile and then its V tile
// (recompute).
__device__ __forceinline__ void unit_at(int u, int nkt, bool scores,
                                        bool& is_v, int& kt) {
  if (u < nkt) {
    is_v = false, kt = u;
  } else if (scores) {
    is_v = true, kt = u - nkt;
  } else {
    is_v = ((u - nkt) & 1) != 0, kt = (u - nkt) >> 1;
  }
}

}  // namespace mma

// NWC: the warps of a row group (1 or 2, see mma::kRowGroups); SCORES: the
// block's scores stay in shared memory.  Warp w owns queries 16 MT (w % RG)
// .. + 16 MT - 1 of the CTA's, in MT m16 tiles; in the m16n8 fragments lane
// l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1 of
// each 8-column tile.
template <int NWC, bool SCORES>
__global__ void __launch_bounds__(mma::threads_of(NWC), 1)
    flash_block_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int RG = mma::kRowGroups, MT = mma::mtiles_of(NWC);
  constexpr int KW = kTK / NWC;  // keys of a score tile a warp owns
  constexpr int NT = 4;          // 8-key fragment tiles of a chunk of them
  constexpr int CH = KW / 32;    // 32-key chunks a tile
  extern __shared__ __align__(16) unsigned char smem[];
  const mma::Plan pl = mma::make_plan(a.d, a.skv, NWC, SCORES);
  const int rows = pl.rows;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* St = Qs + rows * pl.pitch;
  bf16* Ps = St + kStages * kTK * pl.pitch;
  float* Ss = reinterpret_cast<float*>(Ps + rows * pl.ppitch);
  float* Red = Ss + rows * pl.spitch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * MT * (warp % RG), wc = warp / RG, kw0 = wc * KW;
  // ldmatrix rows and columns of this lane: A operands (Q, p) and V's
  // transposed B; K's B
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = ((lane >> 3) & 1) * 8;
  const int64_t row = blockIdx.x;
  const int q0 = blockIdx.y * rows, sq = a.sq, skv = a.skv, d = a.d;
  const bf16* kg = static_cast<const bf16*>(a.k) + row * skv * d;
  const bf16* vg = static_cast<const bf16*>(a.v) + row * skv * d;
  const int64_t bias_base = (row / a.rows_per_bias) * (int64_t)sq * skv;
  const bool vec = a.vec != 0;
  const int total = (SCORES ? 2 : 3) * pl.nkt;
  // the warp's p v columns: 16-column pairs of fragment tiles [pc0, pc1)
  const int npair = pl.dpad / 16, per = (npair + NWC - 1) / NWC;
  const int pc0 = wc * per, pc1 = min(npair, pc0 + per);
  // the local row of this lane's fragment row r of m-tile i
  auto lrow = [&](int i, int r) { return row0 + 16 * i + g + 8 * r; };

  auto issue = [&](int u) {
    if (u < total) {
      bool is_v;
      int kt;
      mma::unit_at(u, pl.nkt, SCORES, is_v, kt);
      mma::load_tile(St + (u % kStages) * kTK * pl.pitch, is_v ? vg : kg, kt * kTK,
                     kTK, skv, d, pl.dpad, pl.pitch, vec);
    }
    cp_async_commit();
  };
  // the query tile rides with the first unit
  mma::load_tile(Qs, static_cast<const bf16*>(a.q) + row * sq * d, q0, rows, sq,
                 d, pl.dpad, pl.pitch, vec);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) issue(u);

  // m' of the fragment rows: their running max over the first pass, then
  // max(m, that) (m itself is read where it is needed, not held)
  float s[MT][NT][4], acc[MT][16][4], new_m[MT][2], psum[MT][2];
  unsigned pa[MT][4][4];  // p's A fragments of one tile (NWC == 1, recompute)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) new_m[i][r] = -INFINITY, psum[i][r] = 0.f;
  }
  auto m_of = [&](int i, int r) {
    const int qi = q0 + lrow(i, r);
    return qi < sq ? ld_f(a.m, row * sq + qi, a.dt_m) : 0.f;
  };

  // s = q k^T over 32 keys of the tile from kc on, in float32 on the
  // tensor cores; then * scale, then + bias, each rounded on its own
  auto scores_of = [&](const bf16* K, int key0, int kc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][nt][e] = 0.f;
    const unsigned qa0 = mma::smem_u32(Qs + (row0 + ar) * pl.pitch + ac);
    const unsigned kb0 = mma::smem_u32(K + (kc + br) * pl.pitch + bc);
#pragma unroll 2
    for (int k = 0; k < pl.dpad; k += 16) {
      unsigned qa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::ldsm_x4(qa[i], qa0 + 2 * (16 * i * pl.pitch + k));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned kb[4];
        mma::ldsm_x4(kb, kb0 + 2 * (16 * np * pl.pitch + k));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma::mma_bf16(s[i][2 * np], qa[i], kb[0], kb[1]);
          mma::mma_bf16(s[i][2 * np + 1], qa[i], kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][nt][e] = __fmul_rn(s[i][nt][e], a.scale);
    if (a.bias == nullptr) return;
    // branch-free: each element reads its bias, or element 0 where the query
    // or the key is out, and adds it where both are in
    auto add_bias = [&](const auto* bias) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + lrow(i, e >> 1);
            const int kj = key0 + kc + 8 * nt + 2 * t + (e & 1);
            const bool in = qi < sq && kj < skv;
            const float b = mma::to_float(bias[in ? bias_base + (int64_t)qi * skv + kj : 0]);
            s[i][nt][e] = in ? __fadd_rn(s[i][nt][e], b) : s[i][nt][e];
          }
    };
    if (a.dt_bias == DT_F32)
      add_bias(static_cast<const float*>(a.bias));
    else
      add_bias(static_cast<const bf16*>(a.bias));
  };
  // p = exp(s - m') for a key, 0 past skv (branch-free); psum takes it
  // before it is rounded to bf16, as the reference sums the float32 p
  auto to_p = [&](float sv, int i, int r, int kj) {
    const float e = expf(sv - new_m[i][r]);
    const float p = kj < skv ? e : 0.f;
    psum[i][r] += p;
    return p;
  };
  // acc += p v over a V tile's 64 keys, 16 at a time; FULL: all 8 column
  // pairs are the warp's (d = 128, 256), so no guard keeps ldmatrix from
  // running ahead
  auto pv_tile = [&](const bf16* V, int pcol, auto full) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned pj[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (NWC == 1 && !SCORES) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pj[i][e] = pa[i][j][e];
        } else {
          mma::ldsm_x4(pj[i], mma::smem_u32(Ps + (row0 + 16 * i + ar) * pl.ppitch +
                                             pcol + 16 * j + ac));
        }
      }
      const unsigned vb0 = mma::smem_u32(V + (16 * j + ar) * pl.pitch + ac) + 32 * pc0;
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (decltype(full)::value || pc0 + jp < pc1) {
          unsigned vb[4];
          mma::ldsm_x4_t(vb, vb0 + 32 * jp);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma::mma_bf16(acc[i][2 * jp], pj[i], vb[0], vb[1]);
            mma::mma_bf16(acc[i][2 * jp + 1], pj[i], vb[2], vb[3]);
          }
        }
      }
    }
  };

  for (int u = 0; u < total; ++u) {
    cp_async_wait<kStages - 2>();  // unit u has landed (for this thread) ...
    __syncthreads();               // ... for all; every thread is done with u - 1
    issue(u + kStages - 1);        // into the stage of u - 1
    bool is_v;
    int kt;
    mma::unit_at(u, pl.nkt, SCORES, is_v, kt);
    const bf16* S = St + (u % kStages) * kTK * pl.pitch;
    const int key0 = kt * kTK;
    if (is_v) {
      if (pc1 - pc0 == 8)
        pv_tile(S, SCORES ? key0 : 0, mma::Flag<true>());
      else
        pv_tile(S, SCORES ? key0 : 0, mma::Flag<false>());
      continue;
    }
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      const int kc = kw0 + 32 * h;
      scores_of(S, key0, kc);
      if (u >= pl.nkt) {  // second pass, recompute: this chunk's p
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int kj = key0 + kc + 8 * nt + 2 * t;
            const unsigned lo = mma::pack_bf16(to_p(s[i][nt][0], i, 0, kj),
                                               to_p(s[i][nt][1], i, 0, kj + 1));
            const unsigned hi = mma::pack_bf16(to_p(s[i][nt][2], i, 1, kj),
                                               to_p(s[i][nt][3], i, 1, kj + 1));
            if (NWC == 1) {  // the m16n8 C layout is the m16n8k16 A layout
              pa[i][2 * h + (nt >> 1)][2 * (nt & 1)] = lo;
              pa[i][2 * h + (nt >> 1)][2 * (nt & 1) + 1] = hi;
            } else {
              *reinterpret_cast<unsigned*>(Ps + lrow(i, 0) * pl.ppitch + kc + 8 * nt + 2 * t) = lo;
              *reinterpret_cast<unsigned*>(Ps + lrow(i, 1) * pl.ppitch + kc + 8 * nt + 2 * t) = hi;
            }
          }
        continue;
      }
      // first pass: the row max (and the kept scores)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mx = max_nan(new_m[i][e >> 1], s[i][nt][e]);
            new_m[i][e >> 1] = key0 + kc + 8 * nt + 2 * t + (e & 1) < skv ? mx : new_m[i][e >> 1];
          }
      if (SCORES) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(Ss + lrow(i, r) * pl.spitch + key0 + kc + 8 * nt +
                                         2 * t) = make_float2(s[i][nt][2 * r], s[i][nt][2 * r + 1]);
      }
    }
    if (u != pl.nkt - 1) continue;
    // m' over the quad that shares a row, then over the warps that split its
    // keys
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        new_m[i][r] = max_nan(new_m[i][r], __shfl_xor_sync(0xffffffffu, new_m[i][r], 1));
        new_m[i][r] = max_nan(new_m[i][r], __shfl_xor_sync(0xffffffffu, new_m[i][r], 2));
      }
    if (NWC > 1) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (t == 0) Red[wc * rows + lrow(i, r)] = new_m[i][r];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          new_m[i][r] = max_nan(Red[lrow(i, r)], Red[rows + lrow(i, r)]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) new_m[i][r] = max_nan(m_of(i, r), new_m[i][r]);
    if (SCORES) {  // every kept score to its bf16 p, by the thread that made it
      for (int kt2 = 0; kt2 < pl.nkt; ++kt2)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int kl = kt2 * kTK + kw0 + 8 * nt + 2 * t;
              const float2 sv =
                  *reinterpret_cast<const float2*>(Ss + lrow(i, r) * pl.spitch + kl);
              *reinterpret_cast<unsigned*>(Ps + lrow(i, r) * pl.ppitch + kl) =
                  mma::pack_bf16(to_p(sv.x, i, r, kl), to_p(sv.y, i, r, kl + 1));
            }
    }
  }
  cp_async_wait<0>();

  // Σp over the quad, then over the warps that split the keys
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[i][r] += __shfl_xor_sync(0xffffffffu, psum[i][r], 1);
      psum[i][r] += __shfl_xor_sync(0xffffffffu, psum[i][r], 2);
    }
  if (NWC > 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (t == 0) Red[wc * rows + lrow(i, r)] = psum[i][r];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) psum[i][r] = Red[lrow(i, r)] + Red[rows + lrow(i, r)];
  }
  // per m-tile and half of the columns, num is read whole before its
  // outputs are stored
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float c[2], dv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + lrow(i, r);
      c[r] = expf(m_of(i, r) - new_m[i][r]);
      dv[r] = qi < sq ? ld_f(a.den, row * sq + qi, a.dt_den) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + lrow(i, r);
      if (qi < sq && wc == 0 && t == 0) {
        st_f(a.m_out, row * sq + qi, new_m[i][r], a.dt_m);
        st_f(a.den_out, row * sq + qi, __fadd_rn(__fmul_rn(dv[r], c[r]), psum[i][r]),
             a.dt_den);
      }
    }
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {
      float2 nv[8][2];
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + lrow(i, r);
          const int col = 8 * (2 * pc0 + j) + 2 * t;
          float2 x = make_float2(0.f, 0.f);
          if (pc0 + j / 2 < pc1 && qi < sq && col < d) {
            const int64_t e = (row * sq + qi) * d + col;
            if (a.vec_num) {  // d % 4 == 0: the pair is in and aligned
              if (a.dt_num == DT_F32) {
                x = *reinterpret_cast<const float2*>(static_cast<const float*>(a.num) + e);
              } else {
                x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const bf16*>(a.num) + e));
              }
            } else {
              x.x = ld_f(a.num, e, a.dt_num);
              if (col + 1 < d) x.y = ld_f(a.num, e + 1, a.dt_num);
            }
          }
          nv[j - j0][r] = x;
        }
#pragma unroll
      for (int j = j0; j < j0 + 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + lrow(i, r);
          const int col = 8 * (2 * pc0 + j) + 2 * t;
          if (!(pc0 + j / 2 < pc1 && qi < sq && col < d)) continue;
          const float y0 = __fadd_rn(__fmul_rn(nv[j - j0][r].x, c[r]), acc[i][j][2 * r]);
          const float y1 = __fadd_rn(__fmul_rn(nv[j - j0][r].y, c[r]), acc[i][j][2 * r + 1]);
          const int64_t e = (row * sq + qi) * d + col;
          if (a.vec_num) {
            if (a.dt_num == DT_F32) {
              *reinterpret_cast<float2*>(static_cast<float*>(a.num_out) + e) =
                  make_float2(y0, y1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.num_out) + e) =
                  __floats2bfloat162_rn(y0, y1);
            }
          } else {
            st_f(a.num_out, e, y0, a.dt_num);
            if (col + 1 < d) st_f(a.num_out, e + 1, y1, a.dt_num);
          }
        }
    }
  }
}

constexpr int kMaxDevices = 64;

// The most dynamic shared memory a block may opt in to on this device
// (232,448 bytes on an H100), read once per device.
int smem_optin(int dev) {
  static std::atomic<int> cache[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  int v = known ? cache[dev].load(std::memory_order_acquire) : 0;
  if (v > 0) return v;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  if (known) cache[dev].store(v, std::memory_order_release);
  return v;
}

// Launch one instance, after opting it in to the device's shared-memory cap
// once per device (each instance keeps its own flag).
template <typename T, int NG, bool SCORES>
int launch(const Args& a, long long rows, int dev, int cap, cudaStream_t stream,
           int* body) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t bytes = make_plan(a.d, a.skv, sizeof(T), SCORES).bytes;
  if (bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (!known || !done[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<T, NG, SCORES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return (int)err;
    if (known) done[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((unsigned)rows, (unsigned)((a.sq + kTQ - 1) / kTQ));
  *body = BODY_FFMA;
  flash_block_kernel<T, NG, SCORES><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The scores stay on chip where their plan fits the device's cap.
template <typename T>
int launch_dtype(const Args& a, long long rows, cudaStream_t st, int* body) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int cap = smem_optin(dev);
  const bool scores = make_plan(a.d, a.skv, sizeof(T), true).bytes <= (size_t)cap;
  if (a.d <= 128)
    return scores ? launch<T, 1, true>(a, rows, dev, cap, st, body)
                  : launch<T, 1, false>(a, rows, dev, cap, st, body);
  return scores ? launch<T, 2, true>(a, rows, dev, cap, st, body)
                : launch<T, 2, false>(a, rows, dev, cap, st, body);
}

// Launch one bf16 instance, opted in to the device's cap as above.
template <int NWC, bool SCORES>
int launch_mma(const Args& a, long long rows, int dev, int cap, cudaStream_t stream,
               int* body) {
  static std::atomic<bool> done[kMaxDevices];
  const mma::Plan pl = mma::make_plan(a.d, a.skv, NWC, SCORES);
  if (pl.bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (!known || !done[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_mma_kernel<NWC, SCORES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return (int)err;
    if (known) done[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((unsigned)rows, (unsigned)((a.sq + pl.rows - 1) / pl.rows));
  *body = BODY_MMA_SYNC;
  flash_block_mma_kernel<NWC, SCORES><<<grid, mma::threads_of(NWC), pl.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// bfloat16 runs the tensor-core body: two warps a row group past d = 128,
// the scores kept where their plan fits the device's cap.
template <>
int launch_dtype<__nv_bfloat16>(const Args& a, long long rows, cudaStream_t st,
                                int* body) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int cap = smem_optin(dev);
  const int nwc = a.d > 128 ? 2 : 1;
  const bool scores = mma::make_plan(a.d, a.skv, nwc, true).bytes <= (size_t)cap;
  if (nwc == 1)
    return scores ? launch_mma<1, true>(a, rows, dev, cap, st, body)
                  : launch_mma<1, false>(a, rows, dev, cap, st, body);
  return scores ? launch_mma<2, true>(a, rows, dev, cap, st, body)
                : launch_mma<2, false>(a, rows, dev, cap, st, body);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
}  // namespace otpu

// q, k, v, num: (rows, sq|skv, d) contiguous; m, den: (rows, sq); bias: NULL
// or (rows / rows_per_bias, sq, skv).  Dtype codes 0 = float32, 1 =
// bfloat16; q, k, v share dt_in.  1 <= d <= 256, rows < 2^31, sq, skv >= 1
// (the wrapper checks).  *body is set to the body launched (BODY_*).
// Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a d above 256).
extern "C" int otpu_flash_block(const void* q, const void* k, const void* v,
                                const void* m, const void* num, const void* den,
                                const void* bias, void* m_out, void* num_out,
                                void* den_out, long long rows, int sq, int skv,
                                int d, long long rows_per_bias, int dt_in,
                                int dt_m, int dt_num, int dt_den, int dt_bias,
                                int* body, void* stream) {
  using namespace otpu;
  if (d < 1 || d > 256 || sq < 1 || skv < 1) return (int)cudaErrorInvalidValue;
  const int es = dt_in == DT_F32 ? 4 : 2;
  Args a{q, k, v, m, num, den, bias, m_out, num_out, den_out, sq, skv, d,
         rows_per_bias, (float)(1.0 / sqrt((double)d)), dt_m, dt_num, dt_den,
         dt_bias, 0, 0};
  a.vec = d % (16 / es) == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.vec_num = d % 4 == 0 && aligned16(num) && aligned16(num_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dt_in == DT_F32 ? launch_dtype<float>(a, rows, st, body)
                         : launch_dtype<__nv_bfloat16>(a, rows, st, body);
}
