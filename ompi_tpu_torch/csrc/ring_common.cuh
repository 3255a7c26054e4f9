// Shared pieces of the ring reduction kernel (ring_fused.cu): the four ring
// folds, the bf16 wire rounding, 16-byte packed loads and stores, the C ABI
// codes.
//
// Layout the kernel takes: x is (n, size), row r is virtual rank r's payload.
// The payload is cut into ring blocks of `blk` elements, and block b of the
// result is
//     fold(x[b+s-1], fold(x[b+s-2], ... fold(x[b+s+1], x[b+s])))
// (ranks mod n) -- the order of the TPU ring's reduce-scatter phase
// (ompi_tpu/ops/pallas_collectives.py:_rs_phase): the partial of block b
// starts on rank b+s and each hop folds its own row into the incoming
// partial, fold(own, incoming).  The start offset s is _rs_phase's align:
//   s = 0 -- all-reduce (align=0, K3/K4): n blocks of blk = rows*128
//            elements, the block of _jit_all_reduce, a multiple of 128;
//   s = 1 -- owner-aligned reduce-scatter (align=-1, K5/K6): x is the
//            (n, n, *S) input viewed as (n, n*blk), blk = prod(S), and
//            block b of the result is rank b's output row.
// Kernels and plain versions keep that order, so results are bit-identical
// with the reference.  A 16-byte pack never straddles two blocks: the
// wrapper takes the packed path only when blk is a multiple of the pack.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace otpu {

// op and dtype codes of the C entry points (ompi_tpu_torch/ops/ring_collectives.py)
enum { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };
enum { DT_F16 = 0, DT_F32 = 1, DT_F64 = 2 };

// fold(a, b) in the compute type.  MAX/MIN: a NaN operand wins, as in
// torch.maximum/minimum; equal operands give `a`.
template <int OP, typename C>
__device__ __forceinline__ C fold_c(C a, C b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_PROD) return a * b;
  if (OP == OP_MAX) return (a != a || a >= b) ? a : b;
  return (a != a || a <= b) ? a : b;
}

// f32 and f64 fold in their own type; f16 folds in f32 and rounds back to
// f16 at every hop, which is the correctly rounded f16 result (24 >= 2*11+2
// bits), as the reference's f16 arithmetic gives.
template <int OP> __device__ __forceinline__ float fold(float a, float b) { return fold_c<OP>(a, b); }
template <int OP> __device__ __forceinline__ double fold(double a, double b) { return fold_c<OP>(a, b); }
template <int OP> __device__ __forceinline__ __half fold(__half a, __half b) {
  return __float2half_rn(fold_c<OP>(__half2float(a), __half2float(b)));
}

// VEC contiguous elements of one thread: 16 bytes (VEC = 16/sizeof(T)) on the
// aligned path, one element otherwise.
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& r) {
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
  }
}

// The bf16 wire of K7 and K5's wire16 form: v rounded to bfloat16 (to
// nearest, ties to even) and widened back to float; every NaN becomes the
// quiet NaN 0x7FC00000.  Written on the bits, as the plain version
// (ring_collectives.bf16_round) is, so both give the same NaN.
__device__ __forceinline__ float bf16_round(float v) {
  if (v != v) return __uint_as_float(0x7FC00000u);
  unsigned u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

template <int VEC>
__device__ __forceinline__ void wire_round(Pack<float, VEC>& p) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p.v[i] = bf16_round(p.v[i]);
}

// acc = fold(own, acc), element by element
template <int OP, typename T, int VEC>
__device__ __forceinline__ void fold_into(Pack<T, VEC>& acc, const Pack<T, VEC>& own) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.v[i] = fold<OP>(own.v[i], acc.v[i]);
}

inline int sm_count() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count > 0 ? count : 1;
}

// Run L<T, OP, VEC>::run(args...) for the (dtype, op, vec) codes of the C
// entry points; vec is 1 or the 16-byte width of T.  False on an unknown code.
template <template <typename, int, int> class L, typename T, typename... A>
bool dispatch_op(int op, int vec, A... args) {
  constexpr int W = 16 / sizeof(T);
  if (vec != 1 && vec != W) return false;
  const bool wide = vec == W;
  switch (op) {
    case OP_SUM: wide ? L<T, OP_SUM, W>::run(args...) : L<T, OP_SUM, 1>::run(args...); return true;
    case OP_PROD: wide ? L<T, OP_PROD, W>::run(args...) : L<T, OP_PROD, 1>::run(args...); return true;
    case OP_MAX: wide ? L<T, OP_MAX, W>::run(args...) : L<T, OP_MAX, 1>::run(args...); return true;
    case OP_MIN: wide ? L<T, OP_MIN, W>::run(args...) : L<T, OP_MIN, 1>::run(args...); return true;
    default: return false;
  }
}

template <template <typename, int, int> class L, typename... A>
bool dispatch(int dtype, int op, int vec, A... args) {
  switch (dtype) {
    case DT_F16: return dispatch_op<L, __half>(op, vec, args...);
    case DT_F32: return dispatch_op<L, float>(op, vec, args...);
    case DT_F64: return dispatch_op<L, double>(op, vec, args...);
    default: return false;
  }
}

}  // namespace otpu
