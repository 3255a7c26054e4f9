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
// So the design is about feeding the FFMA pipes (float32 on the CUDA cores
// for both dtypes: no TF32, no tensor cores), the problem K20's float32 body
// solved:
//  * one CTA of 256 threads per (row, 64-query tile), one CTA per SM (the
//    step's 32 rows x 4 tiles are one wave on 132 SMs);
//  * Q, then K and V, reach shared memory by 16-byte cp.async, in their own
//    dtype (cp.async does not convert; bf16 is widened to float32 as it is
//    read), rows padded by 16 bytes against bank conflicts.  K and V stream
//    in units through two stages, one unit in flight while the other is
//    computed, one barrier a unit: a K unit is 64 keys x 128 of d (a score
//    tile's depth runs over consecutive units, in ascending d), a V unit tv
//    keys x all of d (tv = 32 at d = 256).  Where d is not a multiple of 16
//    bytes' elements or a base is not 16-byte aligned, the same units are
//    filled by element loads (the scalar path) and the rest is unchanged;
//  * operands are read from shared memory as 16 bytes of float32: a thread
//    owns a 4 x 4 score tile (queries ty + 16i, keys tx + 16j), 8 reads per
//    64 FFMA; for p v it owns 8 queries x 8 columns (d = 256; 8 x 4 at d <=
//    128), reading p along keys and v along columns, 16 reads per 256 FFMA;
//  * each score accumulates over d, and each output over keys, in ascending
//    order, with the reference kernel's unfused ends: s * scale then + bias,
//    and num * c + acc, den * c + sum p, each rounded on its own;
//  * the block's scores stay on chip when 64 x skv of them fit beside Q and
//    the stages (skv <= 320 at d = 256 in float32): the first pass stores
//    them, each thread turns its own into p once m' is known, and the V
//    units read p from there, so a call does the two products the function
//    needs.  Otherwise (the bench's skv = 2048) the second pass recomputes
//    each 64-key score tile from K, turns it into p in a 64 x 64 buffer and
//    runs the V units of those keys: three products.  The C entry picks
//    from d, skv and the dtype against the device's shared-memory cap;
//  * num and den are read whole, 16 bytes at a time where aligned, before
//    the outputs are stored (they may alias for all the compiler knows);
//  * exp is expf, full precision, so a fully masked row at m = -inf gives
//    exp(-inf + inf) = NaN as the reference does; keys past skv and queries
//    past sq are zero-filled and never enter the max, the sums or the
//    stores.
// What still bounds it (PERF.md): the FFMA issue, at about a third of the
// float32 peak; neither the shared-memory reads nor more warps a SM moved it.
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
int launch(const Args& a, long long rows, int dev, int cap, cudaStream_t stream) {
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
  flash_block_kernel<T, NG, SCORES><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The scores stay on chip where their plan fits the device's cap.
template <typename T>
int launch_dtype(const Args& a, long long rows, cudaStream_t st) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int cap = smem_optin(dev);
  const bool scores = make_plan(a.d, a.skv, sizeof(T), true).bytes <= (size_t)cap;
  if (a.d <= 128)
    return scores ? launch<T, 1, true>(a, rows, dev, cap, st)
                  : launch<T, 1, false>(a, rows, dev, cap, st);
  return scores ? launch<T, 2, true>(a, rows, dev, cap, st)
                : launch<T, 2, false>(a, rows, dev, cap, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
}  // namespace otpu

// q, k, v, num: (rows, sq|skv, d) contiguous; m, den: (rows, sq); bias: NULL
// or (rows / rows_per_bias, sq, skv).  Dtype codes 0 = float32, 1 =
// bfloat16; q, k, v share dt_in.  1 <= d <= 256, rows < 2^31, sq, skv >= 1
// (the wrapper checks).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a d above 256).
extern "C" int otpu_flash_block(const void* q, const void* k, const void* v,
                                const void* m, const void* num, const void* den,
                                const void* bias, void* m_out, void* num_out,
                                void* den_out, long long rows, int sq, int skv,
                                int d, long long rows_per_bias, int dt_in,
                                int dt_m, int dt_num, int dt_den, int dt_bias,
                                void* stream) {
  using namespace otpu;
  if (d < 1 || d > 256 || sq < 1 || skv < 1) return (int)cudaErrorInvalidValue;
  const int es = dt_in == DT_F32 ? 4 : 2;
  Args a{q, k, v, m, num, den, bias, m_out, num_out, den_out, sq, skv, d,
         rows_per_bias, (float)(1.0 / sqrt((double)d)), dt_m, dt_num, dt_den,
         dt_bias, 0, 0};
  a.vec = d % (16 / es) == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.vec_num = d % 4 == 0 && aligned16(num) && aligned16(num_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dt_in == DT_F32 ? launch_dtype<float>(a, rows, st)
                         : launch_dtype<__nv_bfloat16>(a, rows, st);
}
