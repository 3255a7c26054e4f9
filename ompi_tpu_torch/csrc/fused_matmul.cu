// K20: the collective matmul, C = sum_r A_r @ B_r, ring-folded.
//
// Replaces pallas_overlap._build_fused_matmul (ompi_tpu/ops/pallas_overlap.py:57,
// pallas_call at :146).  On the TPU each of n ranks holds A_r (M, K/n) and
// B_r (K/n, N); the rows are cut into n blocks of m_blk = ceil(M/n) (zero
// padded), and block b's running partial travels the ring: it starts on
// rank b + s and every hop folds the rank's own partial into it, in the
// operand dtype, "mine + incoming" (:111-112).  The partial of rank r for
// block b is dot(A_r[b rows], B_r) accumulated in float32 and rounded to the
// dtype before it is folded (:88-92).  s = 0 is the all-reduce form
// (align 0: block b starts on rank b and the all-gather that follows moves no
// bytes on one card), s = 1 the owner-aligned reduce-scatter (align -1:
// block b ends on rank b).  So, for every block b:
//
//   acc = P_{b+s}(b);  acc = P_{b+s+j}(b) + acc  for j = 1 .. n-1  (ranks mod n)
//
// On one card the ranks are rows of one tensor, a (n, M, K/n) and b (n, K/n,
// N): the remote copies disappear and what stays is that arithmetic.  The
// output is row-major over the padded rows g = b*m_blk + i; the all-reduce
// writes the first M of them, the reduce-scatter all n*m_blk (its padded
// tail holds the folds of zero rows, as the reference's does).
//
// Bound on an H100: operations.  2*M*K*N of them on (M*K + K*N + M*N)
// elements; at the Mixtral expert shape (M 10240, K 14336, N 4096) that is
// 1.2e12 operations: 17.9 ms at 67 TFLOP/s in float32, 1.22 ms at 989
// TFLOP/s in bfloat16, against 0.30 ms for the bytes.
//
// Every body owns output tiles of one block and walks the n ranks of a tile
// in its ring order: for each rank it computes the partial tile over K/n
// with a float32 accumulator, rounds it to the dtype and folds it into the
// running tile, so neither the n partials nor the fold touch device memory
// (float32 excepted, below).  Three bodies, chosen by dtype and shape:
//
//  * wgmma (bfloat16, K/n and N multiples of 8, 16-byte aligned bases: the
//    shapes a TMA tensor map can describe).  A persistent grid, one CTA per
//    SM, taking 128 x 256 output tiles block-major, so the CTAs running
//    together walk the same rank at about the same time and B_r (14.7 MB at
//    the Mixtral shape) and a block's rows of A_r (4.6 MB) stay in the L2.
//    One producer warp issues TMA loads (cp.async.bulk.tensor, 3-D maps over
//    (rank, row, k) and (rank, k, col), 128-byte swizzle) into a ring of 4
//    stages of 64-deep k-tiles, signalled through mbarriers; it runs ahead
//    across rank and tile boundaries, so the next rank's first tiles are in
//    flight while the consumers round and fold.  Two consumer warpgroups
//    (setmaxnreg gives them 240 registers a thread and the producer
//    warpgroup 24) each own 64 rows and run
//    wgmma.mma_async m64n256k16 with A and B read from shared memory (B
//    N-major through the operand's transpose flag), keeping one k-tile's
//    products in flight.  The out-of-bounds fill gives the zero rows past M
//    and the zero tail of K/n with no masking code.  The running tile is
//    packed bf16x2 registers (its values are all bfloat16 numbers, so this
//    is exact and halves it); the fold is elementwise in the accumulator
//    layout, under one branch for the whole tile (a branch per pair kept
//    the running tile from staying in registers).  The finished tile goes
//    out through a per-warp staging tile as 16-byte stores, masked by row:
//    a 128-row tile may pass the block's m_blk rows, and those rows,
//    computed in the wrong ring order, belong to the next block (in the
//    all-reduce form, of the same output).  128 x 256 over 128 x 128: each
//    wgmma reads twice the columns of B for the same rows of A, half as many
//    tiles pay the fold and the drain before it, and the 128 accumulator
//    and 64 running-tile registers fit the consumers' 240.
//  * mma_sync (bfloat16 on other shapes): wmma 16 x 16 x 16 (mma.sync
//    underneath), 8 warps as 4 x 2 over a 128 x 128 tile, 32-deep tiles in
//    two shared-memory stages loaded element by element; the running tile
//    is a set of accumulator fragments; one CTA per tile.
//  * ffma (float32, no TF32): a persistent grid, tiles block-major as
//    wgmma's (a float32 B_r of 29 MB and a block of A_r of 9.2 MB still fit
//    the L2 together).  256 threads over a 128 x 128 tile, each owning 8 x
//    8 outputs as two 4-wide groups of rows and of columns; 64-deep k-tiles
//    in three shared-memory stages (198 KB: one CTA per SM, which leaves
//    each thread the registers to load a k-group's operands ahead of its
//    FFMAs), filled by 16-byte cp.async copies (4-byte where K/n or N is
//    not a multiple of 8) two tiles ahead of the FFMAs, across rank
//    boundaries; one barrier per 64 k, the deeper the tile the fewer.
//    Operands are read from shared memory as float4: A row-major, 4 k of
//    a row in one read, B 4 columns in one read, 16 reads for 256 FFMA.
//    The running tile is the output tile itself: the first rank's partial
//    is stored, and every later one is added to what the thread stored
//    (each thread folds only its own elements), so only the partial's 64
//    accumulators live across the k loop.
// Rows past M (the padding) and columns past N read and write nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace otpu {
namespace fm {

enum { DT_F32 = 0, DT_BF16 = 1 };
// the body a launch took, reported to the wrapper (ops/overlap.py's _BODIES)
enum { BODY_FFMA = 0, BODY_WGMMA = 1, BODY_MMA_SYNC = 2 };

struct Shape {
  int n;          // ranks
  int m;          // rows of A_r (before padding)
  int k;          // K/n: the contraction each rank holds
  int nc;         // columns of B_r and of the output
  int m_blk;      // rows per block, ceil(m / n)
  int start;      // ring offset s: 0 all-reduce, 1 reduce-scatter
  int out_rows;   // rows written: m (all-reduce) or n * m_blk
};

// A persistent CTA's output tiles, block-major: tile t is block t / per_blk,
// and within it row tile (t % per_blk) / ctiles, column tile t % ctiles.
struct Tile {
  int blk, i0, c0;
  int64_t g0;  // padded row of tile row 0
};

__device__ __forceinline__ Tile tile_at(int t, int rtiles, int ctiles, int tm,
                                        int tn, const Shape& s) {
  const int per_blk = rtiles * ctiles, loc = t % per_blk;
  Tile r;
  r.blk = t / per_blk;
  r.i0 = (loc / ctiles) * tm;
  r.c0 = (loc % ctiles) * tn;
  r.g0 = (int64_t)r.blk * s.m_blk + r.i0;
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// cp.async global -> shared of BYTES (4 or 16), in flight until
// cp_async_wait; src_bytes 0 writes zeros (the ragged edge)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- float32: ffma -----------------------------------------------------------

namespace f32 {
constexpr int kThreads = 256;
constexpr int kTM = 128, kTN = 128, kTK = 64, kStages = 3;
constexpr int kPitchA = kTK + 4;                    // As[row][k], 272-byte rows
constexpr int kStageA = kTM * kPitchA, kStageB = kTK * kTN;  // floats
constexpr int kSmem = kStages * (kStageA + kStageB) * 4;
// the copies run two tiles ahead, into the stage of the tile before this one
static_assert(kStages >= 3, "the ffma pipeline needs three stages");
}  // namespace f32

// One 128 x 64 tile of A_r (row-major, as it lies) and one 64 x 128 tile of
// B_r into a stage: VEC as 16-byte chunks (8 of each per thread; K/n and N
// multiples of 8, so a chunk is all in or all out), else element by element.
// Rows of the next block (i >= m_blk), rows past M, k past K/n and columns
// past N are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_f32(float* As, float* Bs,
                                         const float* __restrict__ ar,
                                         const float* __restrict__ br,
                                         const Shape& s, const Tile& t, int k0) {
  using namespace f32;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kTM * kTK / 4 / kThreads; ++q) {
      const int id = tid + q * kThreads, row = id / (kTK / 4), kc = id % (kTK / 4) * 4;
      const int64_t g = t.g0 + row;
      const bool ok = t.i0 + row < s.m_blk && g < s.m && k0 + kc < s.k;
      cp_async<16>(As + row * kPitchA + kc, ok ? ar + g * s.k + k0 + kc : ar, ok);
    }
#pragma unroll
    for (int q = 0; q < kTK * kTN / 4 / kThreads; ++q) {
      const int id = tid + q * kThreads, kk = id / (kTN / 4), col = id % (kTN / 4) * 4;
      const bool ok = k0 + kk < s.k && t.c0 + col < s.nc;
      cp_async<16>(Bs + kk * kTN + col,
                   ok ? br + (int64_t)(k0 + kk) * s.nc + t.c0 + col : br, ok);
    }
  } else {
#pragma unroll 8
    for (int q = 0; q < kTM * kTK / kThreads; ++q) {
      const int id = tid + q * kThreads, row = id / kTK, kk = id % kTK;
      const int64_t g = t.g0 + row;
      const bool ok = t.i0 + row < s.m_blk && g < s.m && k0 + kk < s.k;
      cp_async<4>(As + row * kPitchA + kk, ok ? ar + g * s.k + k0 + kk : ar, ok);
    }
#pragma unroll 8
    for (int q = 0; q < kTK * kTN / kThreads; ++q) {
      const int id = tid + q * kThreads, kk = id / kTN, col = id % kTN;
      const bool ok = k0 + kk < s.k && t.c0 + col < s.nc;
      cp_async<4>(Bs + kk * kTN + col,
                  ok ? br + (int64_t)(k0 + kk) * s.nc + t.c0 + col : br, ok);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(f32::kThreads, 1)
fused_matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, Shape s, int rtiles, int ctiles) {
  using namespace f32;
  extern __shared__ __align__(16) float smem_f32[];
  float* As = smem_f32;
  float* Bs = smem_f32 + kStages * kStageA;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = (s.k + kTK - 1) / kTK, units = s.n * nk;
  const int ntiles = s.n * rtiles * ctiles;
  // the thread's rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + q and
  // 64 + tx*4 + q (i, q < 4)
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); };
  auto col_of = [&](int q) { return (q < 4 ? 0 : 64) + tx * 4 + (q & 3); };

  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const Tile t = tile_at(ti, rtiles, ctiles, kTM, kTN, s);
    // unit u = (ring step j, k-tile kt) of this tile, in stage u % kStages
    auto issue = [&](int u) {
      if (u < units) {
        const int j = u / nk, r = (t.blk + s.start + j) % s.n;
        load_f32<VEC>(As + (u % kStages) * kStageA, Bs + (u % kStages) * kStageB,
                      a + (int64_t)r * s.m * s.k, b + (int64_t)r * s.k * s.nc,
                      s, t, (u % nk) * kTK);
      }
      cp_async_commit();
    };
    issue(0);
    issue(1);
    float acc[8][8];
    for (int u = 0; u < units; ++u) {
      cp_async_wait<1>();  // unit u has landed (for this thread) ...
      __syncthreads();     // ... for all; and every thread is done with u - 1
      issue(u + 2);        // into the stage of u - 1
      const int kt = u % nk;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
      }
      const float* At = As + (u % kStages) * kStageA;
      const float* Bt = Bs + (u % kStages) * kStageB;
#pragma unroll
      for (int kg = 0; kg < kTK; kg += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(At + row_of(i) * kPitchA + kg);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const float4 b0 = *reinterpret_cast<const float4*>(Bt + (kg + kq) * kTN + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(Bt + (kg + kq) * kTN + 64 + tx * 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = kq == 0 ? av[i].x : kq == 1 ? av[i].y
                           : kq == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(ai, bv[q], acc[i][q]);
          }
        }
      }
      if (kt != nk - 1) continue;
      // the partial (float32: itself) folds into the output tile: the first
      // rank's is stored, each later one is mine + incoming
      const bool first = u < nk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = t.i0 + row_of(i);
        const int64_t g = (int64_t)t.blk * s.m_blk + row;
        if (row >= s.m_blk || g >= s.out_rows) continue;
        float* o = out + g * s.nc + t.c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = col_of(4 * h);
          if (VEC) {  // N a multiple of 8: the 4 columns are all in or all out
            if (t.c0 + c >= s.nc) continue;
            float4* p = reinterpret_cast<float4*>(o + c);
            float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
            if (!first) {
              const float4 w = *p;
              v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                              __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
            }
            *p = v;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (t.c0 + c + q >= s.nc) continue;
              const float v = acc[i][4 * h + q];
              o[c + q] = first ? v : __fadd_rn(v, o[c + q]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free for the next tile's copies
  }
}

// ---- bfloat16: mma_sync ------------------------------------------------------

namespace wm = nvcuda::wmma;
namespace ms {
constexpr int kThreads = 256;
constexpr int kTM = 128, kTN = 128, kTK = 32;
constexpr int kLdA = kTK + 8;  // bf16 row pitches: multiples of 8 for wmma
constexpr int kLdB = kTN + 8;
}  // namespace ms
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// One 128 x 32 tile of A_r and one 32 x 128 tile of B_r into shared memory,
// element by element, zeros past the edges.
__device__ __forceinline__ void load_tiles16(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                             const __nv_bfloat16* __restrict__ ar,
                                             const __nv_bfloat16* __restrict__ br,
                                             const Shape& s, int i0, int64_t g0,
                                             int c0, int k0) {
  using namespace ms;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int q = 0; q < (kTM * kTK) / (8 * kThreads); ++q) {
    const int c = threadIdx.x + q * kThreads, row = c >> 2, kc = (c & 3) << 3;
    const int64_t g = g0 + row;
    const int k = k0 + kc;
    const bool rows_ok = i0 + row < s.m_blk && g < s.m;
    __nv_bfloat16* dst = As + row * kLdA + kc;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = rows_ok && k + e < s.k ? ar[g * s.k + k + e] : zero;
  }
#pragma unroll
  for (int q = 0; q < (kTN * kTK) / (8 * kThreads); ++q) {
    const int c = threadIdx.x + q * kThreads, kk = c >> 4, col = (c & 15) << 3;
    const int k = k0 + kk, cg = c0 + col;
    __nv_bfloat16* dst = Bs + kk * kLdB + col;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = k < s.k && cg + e < s.nc ? br[(int64_t)k * s.nc + cg + e] : zero;
  }
}

__global__ void __launch_bounds__(ms::kThreads)
fused_matmul_mma_sync(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b,
                      __nv_bfloat16* __restrict__ out, Shape s) {
  using namespace ms;
  // two stages: the next k-tile's loads are issued before this one's mma
  __shared__ __align__(128) __nv_bfloat16 As[2][kTM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kTK * kLdB];
  __shared__ __align__(32) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;  // warp's sub-tile
  const int blk = blockIdx.z;
  const int i0 = blockIdx.y * kTM, c0 = blockIdx.x * kTN;
  const int64_t g0 = (int64_t)blk * s.m_blk + i0;
  const int nk = (s.k + kTK - 1) / kTK;

  FragC run[2][4];
  for (int j = 0; j < s.n; ++j) {
    const int r = (blk + s.start + j) % s.n;
    const __nv_bfloat16* ar = a + (int64_t)r * s.m * s.k;
    const __nv_bfloat16* br = b + (int64_t)r * s.k * s.nc;
    FragC acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) wm::fill_fragment(acc[i][q], 0.f);
    load_tiles16(As[0], Bs[0], ar, br, s, i0, g0, c0, 0);
    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk)
        load_tiles16(As[(t + 1) & 1], Bs[(t + 1) & 1], ar, br, s, i0, g0, c0,
                     (t + 1) * kTK);
      __syncthreads();
      const __nv_bfloat16* At = As[t & 1];
      const __nv_bfloat16* Bt = Bs[t & 1];
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        FragA fa[2];
        FragB fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wm::load_matrix_sync(fa[i], At + (wr + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wm::load_matrix_sync(fb[q], Bt + kk * kLdB + wc + 16 * q, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) wm::mma_sync(acc[i][q], fa[i], fb[q], acc[i][q]);
      }
      __syncthreads();  // the stage is free for the loads two tiles on
    }
    // the partial rounded to bf16, then mine + incoming rounded to bf16:
    // run and acc share one layout, so this is elementwise on the registers
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < acc[i][q].num_elements; ++t) {
          const float p = round_bf16(acc[i][q].x[t]);
          run[i][q].x[t] = j == 0 ? p : round_bf16(__fadd_rn(p, run[i][q].x[t]));
        }
  }
  float* stage = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wm::store_matrix_sync(stage, run[i][q], 16, wm::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t, rr = e >> 4, cc = e & 15;
        const int row = i0 + wr + 16 * i + rr, c = c0 + wc + 16 * q + cc;
        const int64_t g = (int64_t)blk * s.m_blk + row;
        if (row < s.m_blk && g < s.out_rows && c < s.nc)
          out[g * s.nc + c] = __float2bfloat16_rn(stage[e]);
      }
      __syncwarp();
    }
}

// ---- bfloat16: wgmma ---------------------------------------------------------

namespace wg {
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer warpgroup
constexpr int kTM = 64 * kConsumers, kTN = 256, kTK = 64, kStages = 4;
constexpr int kBytesA = kTM * kTK * 2;           // 16 KB: 128 rows of 128 B
constexpr int kBoxN = 64;                        // B is loaded as 64-column boxes
constexpr int kBytesBox = kTK * kBoxN * 2;       // 8 KB: 64 k-rows of 128 B
constexpr int kBytesB = kTK * kTN * 2;
constexpr int kBytesStage = kBytesA + kBytesB;
constexpr int kPitchOut = 72;                    // staging row pitch (bf16)
constexpr int kBytesOut = 16 * kPitchOut * 2;    // per warp: 16 rows x 64 cols
constexpr int kSmem = 1024 + kStages * kBytesStage + 4 * kConsumers * kBytesOut +
                      2 * kStages * 8;
}  // namespace wg

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// a (c0, c1, c2) box of the tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// D (+)= A B for one 64 x 256 x 16 step: A (K-major) and B (N-major, the
// transpose flag) from shared memory through their descriptors; D is the
// 128 float32 registers of this thread.  scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__global__ void __launch_bounds__(wg::kThreads, 1)
fused_matmul_wgmma(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   __nv_bfloat16* __restrict__ out, Shape s, int rtiles,
                   int ctiles) {
  using namespace wg;
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  // stages on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_wg);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_wg + (base - raw);
  auto stage_a = [&](int st) { return base + st * kBytesStage; };
  auto stage_b = [&](int st) { return base + st * kBytesStage + kBytesA; };
  const uint32_t staging = base + kStages * kBytesStage;
  const uint32_t full = staging + 4 * kConsumers * kBytesOut;
  const uint32_t empty = full + kStages * 8;

  const int nk = (s.k + kTK - 1) / kTK;
  const int ntiles = s.n * rtiles * ctiles;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;

  if (wgi == kConsumers) {
    // ---- the producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * kConsumers) {
      int st = 0, phase = 0;
      for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
        const Tile t = tile_at(ti, rtiles, ctiles, kTM, kTN, s);
        for (int j = 0; j < s.n; ++j) {
          const int r = (t.blk + s.start + j) % s.n;
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(empty + 8 * st, phase ^ 1);
            mbar_expect_tx(full + 8 * st, kBytesStage);
            tma_load(stage_a(st), &map_a, full + 8 * st, kt * kTK, (int)t.g0, r);
#pragma unroll
            for (int q = 0; q < kTN / kBoxN; ++q)
              tma_load(stage_b(st) + q * kBytesBox, &map_b, full + 8 * st,
                       t.c0 + q * kBoxN, kt * kTK, r);
            if (++st == kStages) {
              st = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: rows 64*wgi .. 64*wgi + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[kTN / 2];
    uint32_t run[kTN / 4];  // bf16x2: run[2J + h] is row 8h + lane/4 of the
                            // warp's 16, columns 8J + 2*(lane%4) and +1
    int st = 0, phase = 0;
    for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
      const Tile t = tile_at(ti, rtiles, ctiles, kTM, kTN, s);
      for (int j = 0; j < s.n; ++j) {
        int prev = -1;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(full + 8 * st, phase);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kTK / 16; ++kk) {
            // A: K-major, 128-byte rows, 8-row groups 1024 B apart; a 16-deep
            // step is 32 B on.  B: N-major, 64-column boxes 8 KB apart (the
            // leading offset), 8-deep groups 1024 B apart; a step is 16 rows.
            const uint64_t da = smem_desc(stage_a(st) + wgi * 64 * 128 + kk * 32, 16, 1024);
            const uint64_t db = smem_desc(stage_b(st) + kk * 16 * 128, kBytesBox, 1024);
            wgmma_n256(acc, da, db, kt > 0 || kk > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the previous k-tile's products are done: its stage is free
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (prev >= 0) mbar_arrive(empty + 8 * prev);
          prev = st;
          if (++st == kStages) {
            st = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        mbar_arrive(empty + 8 * prev);
        // the partial rounded to bf16, then mine + incoming rounded to bf16,
        // pair by pair in the accumulator layout
        // (one branch for the whole tile: a branch per pair keeps the
        // running tile from staying in registers)
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < kTN / 4; ++i) run[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
        } else {
#pragma unroll
          for (int i = 0; i < kTN / 4; ++i) {
            const float2 pf = unpack_bf16(pack_bf16(acc[2 * i], acc[2 * i + 1]));
            const float2 rf = unpack_bf16(run[i]);
            run[i] = pack_bf16(__fadd_rn(pf.x, rf.x), __fadd_rn(pf.y, rf.y));
          }
        }
      }
      // out: each warp's 16 rows, 64 columns at a time, through its staging
      // tile, as 16-byte stores masked by row and column
      uint32_t* st_w = reinterpret_cast<uint32_t*>(
          gbase + (staging - base) + (wgi * 4 + warp) * kBytesOut);
      const int rr = lane / 4, qq = lane % 4;
      const int row0 = t.i0 + wgi * 64 + warp * 16;
#pragma unroll
      for (int c = 0; c < kTN / 64; ++c) {
#pragma unroll
        for (int J = 0; J < 8; ++J) {
          st_w[rr * (kPitchOut / 2) + J * 4 + qq] = run[2 * (8 * c + J)];
          st_w[(rr + 8) * (kPitchOut / 2) + J * 4 + qq] = run[2 * (8 * c + J) + 1];
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = lane + 32 * u, row = idx / 8, ch = idx % 8;
          const int i = row0 + row, col = t.c0 + 64 * c + 8 * ch;
          const int64_t g = (int64_t)t.blk * s.m_blk + i;
          if (i < s.m_blk && g < s.out_rows && col < s.nc)
            *reinterpret_cast<uint4*>(out + g * s.nc + col) =
                *reinterpret_cast<const uint4*>(st_w + row * (kPitchOut / 2) + ch * 4);
        }
        __syncwarp();
      }
    }
  }
}

// ---- the tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (the library
// links no libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D bf16 map over (outer, mid, inner) = (rank, rows, contiguous), boxes
// of (1, box_mid, box_inner), 128-byte swizzle, zeros out of bounds
inline bool encode_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                       uint64_t mid, uint64_t outer, uint32_t box_inner,
                       uint32_t box_mid) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};
  const cuuint32_t box[3] = {box_inner, box_mid, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int persistent_grid(const void* kernel, int threads, int smem, int ntiles) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  return ntiles < cap ? ntiles : cap;
}

}  // namespace fm
}  // namespace otpu

// a (n, m, k), b (n, k, nc), out (out_rows, nc): contiguous device arrays of
// one dtype (0 = float32, 1 = bfloat16).  m_blk = ceil(m / n); start 0 (the
// all-reduce, out_rows = m) or 1 (the reduce-scatter, out_rows = n * m_blk).
// n, m_blk, nc >= 1 (the wrapper checks).  The body is chosen here, and only
// here, by shape: float32 -> ffma (16-byte copies where k and nc are
// multiples of 8 and a, b 16-byte aligned, 4-byte otherwise); bfloat16 on
// those same shapes -> wgmma (the shapes a tensor map describes); other
// bfloat16 shapes -> mma_sync.  *body is set to the body launched (BODY_*).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another dtype or start, or a tensor map the driver refuses).
extern "C" int otpu_fused_matmul(const void* a, const void* b, void* out, int n,
                                 int m, int k, int nc, int m_blk, int start,
                                 int out_rows, int dtype, int* body, void* stream) {
  using namespace otpu::fm;
  if ((start != 0 && start != 1) || n < 1 || m_blk < 1 || nc < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 8 == 0 && nc % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const Shape s{n, m, k, nc, m_blk, start, out_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const __nv_bfloat16*>(a);
  const auto* b16 = static_cast<const __nv_bfloat16*>(b);
  auto* out16 = static_cast<__nv_bfloat16*>(out);
  if (dtype == DT_F32) {
    const int rt = (m_blk + f32::kTM - 1) / f32::kTM, ct = (nc + f32::kTN - 1) / f32::kTN;
    auto* kernel = vec ? fused_matmul_f32<true> : fused_matmul_f32<false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::kSmem);
    const int grid = persistent_grid((const void*)kernel, f32::kThreads, f32::kSmem,
                                     n * rt * ct);
    kernel<<<grid, f32::kThreads, f32::kSmem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), s, rt, ct);
    *body = BODY_FFMA;
  } else if (dtype == DT_BF16 && vec) {
    CUtensorMap map_a, map_b;
    if (!encode_map(&map_a, a, k, m, n, wg::kTK, wg::kTM) ||
        !encode_map(&map_b, b, nc, k, n, wg::kBoxN, wg::kTK))
      return (int)cudaErrorInvalidValue;
    const int rt = (m_blk + wg::kTM - 1) / wg::kTM, ct = (nc + wg::kTN - 1) / wg::kTN;
    cudaFuncSetAttribute(fused_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         wg::kSmem);
    const int grid = persistent_grid((const void*)fused_matmul_wgmma, wg::kThreads,
                                     wg::kSmem, n * rt * ct);
    fused_matmul_wgmma<<<grid, wg::kThreads, wg::kSmem, st>>>(map_a, map_b, out16, s,
                                                              rt, ct);
    *body = BODY_WGMMA;
  } else if (dtype == DT_BF16) {
    const dim3 grid((unsigned)((nc + ms::kTN - 1) / ms::kTN),
                    (unsigned)((m_blk + ms::kTM - 1) / ms::kTM), (unsigned)n);
    fused_matmul_mma_sync<<<grid, ms::kThreads, 0, st>>>(a16, b16, out16, s);
    *body = BODY_MMA_SYNC;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
