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
// Design, the simple right one (wgmma, TMA and overlapping the fold with
// the next partial are later work).  One CTA of 256 threads owns a 128 x 128
// output tile of one block and walks the n ranks in that block's ring
// order; for each rank it computes the partial tile over K/n through shared
// memory tiles with a float32 accumulator, rounds it to the dtype and folds
// it into the running tile, which stays in registers for the whole walk.
//  * float32: FFMA on the CUDA cores (no TF32); each thread owns an 8 x 8
//    sub-tile, rows ty + 16 i and columns tx + 16 j, from 8-deep tiles of A
//    (stored k-major, padded so the stores hit 32 banks) and B.
//  * bfloat16: wmma 16 x 16 x 16 on the tensor cores with float32
//    accumulators (mma.sync underneath); 8 warps as 4 x 2, each 32 x 64 of
//    the tile (2 x 4 fragments), 32-deep tiles in two shared-memory stages,
//    the next one's 16-byte cp.async copies in flight during this one's
//    products (element loads where k or nc is not a multiple of 8).  The
//    running tile is a set of accumulator fragments of the same layout, so
//    the rounding and the fold are elementwise on the fragments' registers;
//    it is written out through a 16 x 16 float staging tile per warp.
// Rows past M (the padding) and columns past N read and write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace otpu {
namespace fm {

constexpr int kThreads = 256;
constexpr int kTM = 128;  // output rows per CTA (within one block)
constexpr int kTN = 128;  // output columns per CTA
enum { DT_F32 = 0, DT_BF16 = 1 };

struct Shape {
  int n;          // ranks
  int m;          // rows of A_r (before padding)
  int k;          // K/n: the contraction each rank holds
  int nc;         // columns of B_r and of the output
  int m_blk;      // rows per block, ceil(m / n)
  int start;      // ring offset s: 0 all-reduce, 1 reduce-scatter
  int out_rows;   // rows written: m (all-reduce) or n * m_blk
};

// ---- float32 ---------------------------------------------------------------

constexpr int kTK32 = 8;

__global__ void __launch_bounds__(kThreads)
fused_matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, Shape s) {
  __shared__ float As[kTK32][kTM + 4];  // k-major; +4: 32 banks on store
  __shared__ float Bs[kTK32][kTN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int blk = blockIdx.z;
  const int i0 = blockIdx.y * kTM, c0 = blockIdx.x * kTN;
  const int64_t g0 = (int64_t)blk * s.m_blk + i0;  // padded row of tile row 0

  float run[8][8];
  for (int j = 0; j < s.n; ++j) {
    const int r = (blk + s.start + j) % s.n;
    const float* ar = a + (int64_t)r * s.m * s.k;
    const float* br = b + (int64_t)r * s.k * s.nc;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    for (int k0 = 0; k0 < s.k; k0 += kTK32) {
#pragma unroll
      for (int q = 0; q < (kTM * kTK32) / kThreads; ++q) {
        const int e = tid + q * kThreads, row = e >> 3, kk = e & 7;
        const int64_t g = g0 + row;
        const int k = k0 + kk;
        As[kk][row] = (i0 + row < s.m_blk && g < s.m && k < s.k)
                          ? ar[g * s.k + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < (kTN * kTK32) / kThreads; ++q) {
        const int e = tid + q * kThreads, kk = e >> 7, col = e & 127;
        const int k = k0 + kk, c = c0 + col;
        Bs[kk][col] = (k < s.k && c < s.nc) ? br[(int64_t)k * s.nc + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK32; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = Bs[kk][tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
      }
      __syncthreads();
    }
    // the partial in the dtype (float32: itself), then mine + incoming
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        run[i][q] = j == 0 ? acc[i][q] : __fadd_rn(acc[i][q], run[i][q]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + ty + 16 * i;
    const int64_t g = (int64_t)blk * s.m_blk + row;
    if (row >= s.m_blk || g >= s.out_rows) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < s.nc) out[g * s.nc + c] = run[i][q];
    }
  }
}

// ---- bfloat16 --------------------------------------------------------------

namespace wm = nvcuda::wmma;
constexpr int kTK16 = 32;
constexpr int kLdA = kTK16 + 8;  // bf16 row pitches: multiples of 8 for wmma,
constexpr int kLdB = kTN + 8;    // and rows 16-byte aligned for cp.async
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes global -> shared, in flight until cp_async_wait; src_bytes 0
// writes zeros (the ragged edge)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 128 x 32 tile of A_r and one 32 x 128 tile of B_r into shared memory,
// as 8-element chunks (2 of each per thread).  VEC (k and nc multiples of
// 8, both bases 16-byte aligned: a chunk is all in or all out) issues each
// chunk as one cp.async; otherwise the elements are loaded one by one.
template <bool VEC>
__device__ __forceinline__ void load_tiles16(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                             const __nv_bfloat16* __restrict__ ar,
                                             const __nv_bfloat16* __restrict__ br,
                                             const Shape& s, int i0, int64_t g0,
                                             int c0, int k0) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int q = 0; q < (kTM * kTK16) / (8 * kThreads); ++q) {
    const int c = threadIdx.x + q * kThreads, row = c >> 2, kc = (c & 3) << 3;
    const int64_t g = g0 + row;
    const int k = k0 + kc;
    const bool rows_ok = i0 + row < s.m_blk && g < s.m;
    __nv_bfloat16* dst = As + row * kLdA + kc;
    if (VEC) {
      const bool ok = rows_ok && k < s.k;
      cp_async16(dst, ok ? ar + g * s.k + k : ar, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = rows_ok && k + e < s.k ? ar[g * s.k + k + e] : zero;
    }
  }
#pragma unroll
  for (int q = 0; q < (kTN * kTK16) / (8 * kThreads); ++q) {
    const int c = threadIdx.x + q * kThreads, kk = c >> 4, col = (c & 15) << 3;
    const int k = k0 + kk, cg = c0 + col;
    __nv_bfloat16* dst = Bs + kk * kLdB + col;
    if (VEC) {
      const bool ok = k < s.k && cg < s.nc;
      cp_async16(dst, ok ? br + (int64_t)k * s.nc + cg : br, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = k < s.k && cg + e < s.nc ? br[(int64_t)k * s.nc + cg + e] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_matmul_bf16(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ out, Shape s) {
  // two stages: the next k-tile's copies are in flight during this one's mma
  __shared__ __align__(128) __nv_bfloat16 As[2][kTM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kTK16 * kLdB];
  __shared__ __align__(32) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;  // warp's sub-tile
  const int blk = blockIdx.z;
  const int i0 = blockIdx.y * kTM, c0 = blockIdx.x * kTN;
  const int64_t g0 = (int64_t)blk * s.m_blk + i0;
  const int nk = (s.k + kTK16 - 1) / kTK16;

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
    load_tiles16<VEC>(As[0], Bs[0], ar, br, s, i0, g0, c0, 0);
    cp_async_commit();
    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) {
        load_tiles16<VEC>(As[(t + 1) & 1], Bs[(t + 1) & 1], ar, br, s, i0, g0,
                          c0, (t + 1) * kTK16);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* At = As[t & 1];
      const __nv_bfloat16* Bt = Bs[t & 1];
#pragma unroll
      for (int kk = 0; kk < kTK16; kk += 16) {
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
      __syncthreads();  // the stage is free for the copies two tiles on
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

}  // namespace fm
}  // namespace otpu

// a (n, m, k), b (n, k, nc), out (out_rows, nc): contiguous device arrays of
// one dtype (0 = float32, 1 = bfloat16).  m_blk = ceil(m / n); start 0 (the
// all-reduce, out_rows = m) or 1 (the reduce-scatter, out_rows = n * m_blk).
// n, m_blk, nc >= 1 (the wrapper checks).  vec 1 lets bfloat16 copy its
// tiles in 16-byte chunks: k and nc multiples of 8 and a, b 16-byte aligned
// (the wrapper checks).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another dtype, start or vec).
extern "C" int otpu_fused_matmul(const void* a, const void* b, void* out, int n,
                                 int m, int k, int nc, int m_blk, int start,
                                 int out_rows, int dtype, int vec, void* stream) {
  using namespace otpu::fm;
  if ((start != 0 && start != 1) || n < 1 || m_blk < 1 || nc < 1 ||
      (vec && (k % 8 || nc % 8)))
    return (int)cudaErrorInvalidValue;
  const Shape s{n, m, k, nc, m_blk, start, out_rows};
  const dim3 grid((unsigned)((nc + kTN - 1) / kTN), (unsigned)((m_blk + kTM - 1) / kTM),
                  (unsigned)n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const __nv_bfloat16*>(a);
  const auto* b16 = static_cast<const __nv_bfloat16*>(b);
  auto* out16 = static_cast<__nv_bfloat16*>(out);
  if (dtype == DT_F32)
    fused_matmul_f32<<<grid, kThreads, 0, st>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(b),
                                                static_cast<float*>(out), s);
  else if (dtype == DT_BF16 && vec)
    fused_matmul_bf16<true><<<grid, kThreads, 0, st>>>(a16, b16, out16, s);
  else if (dtype == DT_BF16)
    fused_matmul_bf16<false><<<grid, kThreads, 0, st>>>(a16, b16, out16, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
