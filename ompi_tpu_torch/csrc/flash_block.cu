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
// Inputs are float32 or bfloat16, each with its own dtype code, converted on
// load.  The bias is optional, one (sq, skv) block per `rows_per_bias` rows
// (the port gives each sp rank its own causal mask in one launch).
//
// Bound on an H100: operations.  4*B*sq*skv*d of them (two products) on
// 4*B*(sq + skv)*d elements: sq*skv/(sq + skv) operations per element, far
// above the ridge at the step's (256) and the bench's (2048) sequence blocks.
// Design, the simple right one (faster forms are later work):
//  * one CTA of 256 threads per (row, 64-query tile); the query tile sits in
//    shared memory as float32 for the whole call;
//  * K/V stream through shared memory in tiles of 64 keys, float32, rows
//    padded by one float so that the 16 threads reading one column hit 16
//    banks.  The whole K/V block does not fit (256 x 256 float32 is 256 KB,
//    above the 227 KB a block may have), so the update takes two passes:
//    the first finds the row max of s over all of skv, the second computes
//    p against that one m' -- the reference's arithmetic, one more q k^T;
//  * each thread owns 4 queries x 4 keys of a 64 x 64 score tile and 4
//    queries x NJ columns of the 64 x d output (NJ = ceil(d/16), a template
//    parameter so the accumulators stay in registers); row max and row sum
//    reduce over the 16 threads of a row with shuffles;
//  * float32 FMAs on the CUDA cores for both dtypes (no TF32, no tensor
//    cores: the float32 band against the plain version is a few 1e-6);
//    exp is expf, full precision, so a fully masked row at m = -inf gives
//    exp(-inf + inf) = NaN as the reference does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace otpu {

constexpr int kTQ = 64;        // queries per CTA
constexpr int kTK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: tx over keys/columns, ty over queries
enum { DT_F32 = 0, DT_BF16 = 1 };

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

// jnp.max / jnp.maximum: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// rows [0, n) of a (n x d) tile at `src` (row pitch d) into `dst` (pitch
// ld) as float32; rows past `valid` are zero
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          int64_t base, int n, int valid,
                                          int d, int ld, int dt) {
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    dst[r * ld + c] = r < valid ? ld_f(src, base + (int64_t)r * d + c, dt) : 0.f;
  }
}

// s[i][j] = Q[ty + 16 i] . K[tx + 16 j] over d, then * scale (+ bias)
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           int d, int ld, float scale,
                                           const void* bias, int64_t bias_base,
                                           int bias_dt, int q0, int k0, int sq,
                                           int skv, float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      float v = __fmul_rn(s[i][j], scale);
      if (bias != nullptr && qi < sq && kj < skv)
        v = __fadd_rn(v, ld_f(bias, bias_base + (int64_t)qi * skv + kj, bias_dt));
      s[i][j] = v;
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_block_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const void* __restrict__ m,
                   const void* __restrict__ num, const void* __restrict__ den,
                   const void* __restrict__ bias, void* m_out, void* num_out,
                   void* den_out, int sq, int skv, int d,
                   int64_t rows_per_bias, float scale, int dt_in, int dt_m,
                   int dt_num, int dt_den, int dt_bias) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;                  // kTQ x ld
  float* KVs = Qs + kTQ * ld;        // kTK x ld: the K tile, then the V tile
  float* Ps = KVs + kTK * ld;        // kTQ x (kTK + 1): p in v's dtype
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row = blockIdx.x;
  const int q0 = blockIdx.y * kTQ;
  const int64_t qbase = row * sq * d, kvbase = row * skv * d;
  const int64_t bias_base = (row / rows_per_bias) * (int64_t)sq * skv;

  load_tile(Qs, q, qbase + (int64_t)q0 * d, kTQ, sq - q0, d, ld, dt_in);

  // pass 1: the row max of s over the whole K/V block
  float rmax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4][4];
  for (int k0 = 0; k0 < skv; k0 += kTK) {
    __syncthreads();
    load_tile(KVs, k, kvbase + (int64_t)k0 * d, kTK, skv - k0, d, ld, dt_in);
    __syncthreads();
    score_tile(Qs, KVs, d, ld, scale, bias, bias_base, dt_bias, q0, k0, sq,
               skv, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < skv) rmax[i] = max_nan(rmax[i], s[i][j]);
  }
  float new_m[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rmax[i] = max_nan(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off, 16));
    const int qi = q0 + ty + 16 * i;
    const float m_old = qi < sq ? ld_f(m, row * sq + qi, dt_m) : 0.f;
    new_m[i] = max_nan(m_old, rmax[i]);
    c[i] = expf(m_old - new_m[i]);
  }

  // pass 2: p against m', its row sums, and p v
  float acc[4][NJ], psum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < skv; k0 += kTK) {
    __syncthreads();
    load_tile(KVs, k, kvbase + (int64_t)k0 * d, kTK, skv - k0, d, ld, dt_in);
    __syncthreads();
    score_tile(Qs, KVs, d, ld, scale, bias, bias_base, dt_bias, q0, k0, sq,
               skv, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = 0.f;
        if (k0 + tx + 16 * j < skv) {
          p = expf(s[i][j] - new_m[i]);
          psum[i] += p;
          if (dt_in == DT_BF16) p = __bfloat162float(__float2bfloat16_rn(p));
        }
        Ps[(ty + 16 * i) * (kTK + 1) + tx + 16 * j] = p;
      }
    __syncthreads();
    load_tile(KVs, v, kvbase + (int64_t)k0 * d, kTK, skv - k0, d, ld, dt_in);
    __syncthreads();
    for (int kk = 0; kk < kTK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kTK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < d ? KVs[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], off, 16);
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const int64_t srow = row * sq + qi;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        const int64_t e = srow * d + col;
        st_f(num_out, e,
             __fadd_rn(__fmul_rn(ld_f(num, e, dt_num), c[i]), acc[i][j]),
             dt_num);
      }
    }
    if (tx == 0) {
      st_f(m_out, srow, new_m[i], dt_m);
      st_f(den_out, srow,
           __fadd_rn(__fmul_rn(ld_f(den, srow, dt_den), c[i]), psum[i]), dt_den);
    }
  }
}

inline size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kTQ + kTK) * (d + 1) + (size_t)kTQ * (kTK + 1));
}

constexpr int kMaxDevices = 64;

// Opt the instance in to the shared memory of its largest head dim (16 NJ),
// once per device: the attribute is a cap, so every d of the instance fits.
template <int NJ>
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_block_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(16 * NJ));
  if (err == cudaSuccess && known)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, const void* m,
           const void* num, const void* den, const void* bias, void* m_out,
           void* num_out, void* den_out, long long rows, int sq, int skv, int d,
           long long rows_per_bias, float scale, int dt_in, int dt_m,
           int dt_num, int dt_den, int dt_bias, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  const cudaError_t err = opt_in_smem<NJ>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)rows, (unsigned)((sq + kTQ - 1) / kTQ));
  flash_block_kernel<NJ><<<grid, kThreads, bytes, stream>>>(
      q, k, v, m, num, den, bias, m_out, num_out, den_out, sq, skv, d,
      rows_per_bias, scale, dt_in, dt_m, dt_num, dt_den, dt_bias);
  return (int)cudaGetLastError();
}

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
  const float scale = (float)(1.0 / sqrt((double)d));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OTPU_FLASH(NJ)                                                         \
  return otpu::launch<NJ>(q, k, v, m, num, den, bias, m_out, num_out, den_out, \
                          rows, sq, skv, d, rows_per_bias, scale, dt_in, dt_m, \
                          dt_num, dt_den, dt_bias, st)
  if (d <= 32) OTPU_FLASH(2);
  if (d <= 64) OTPU_FLASH(4);
  if (d <= 128) OTPU_FLASH(8);
  if (d <= 256) OTPU_FLASH(16);
#undef OTPU_FLASH
  return (int)cudaErrorInvalidValue;
}
