// K10: ring all-gather, K11: the duplex ring all-gather, K12: pipelined ring
// bcast, and K13: ring right permute, of N virtual ranks held as the rows of
// one tensor.  All four move bytes and compute nothing, so all are written on
// bytes: one instantiation serves every dtype (bool and bfloat16 included).
// K10, K11 and K13 launch the one byte mover of pair_copy.cuh (with K14-K16
// of exchange.cu); K12 keeps a body of its own.
//
// K10 replaces the Pallas kernel pallas_collectives._build_all_gather
// (ompi_tpu/ops/pallas_collectives.py:177): n-1 ring steps, each forwarding
// the freshest block to the right neighbour, until every rank holds all n
// blocks.  On one card the n ranks are the rows of x (n, *S) and the
// replicated result is one new (n, *S) tensor, so the n-1 forwarding steps
// deliver each row exactly once: a copy of x.
//   Bound on an H100: device-memory bytes, 2*n*S (read x once, write the
//   result once) / 3.35 TB/s.  Design: the mover with the whole tensor as
//   one pair (any length; the aligned path when both pointers are 16-byte
//   aligned): the CTAs of a persistent grid take equal spans of it in turn
//   and move them with TMA bulk copies through shared memory.
//
// K11 replaces pallas_collectives._build_all_gather_bidi (:226): every step
// ships the freshest block both ways round the ring, rank my sending slot
// my-k right and slot my+k left, so the n-1 remote blocks arrive in
// ceil((n-1)/2) steps, each exactly once (n/2 by the right chain, the rest by
// the left).  On one card every rank's copy of row p is the one row out[p],
// so the chain that reaches it writes it once: n rows copied, each byte once,
// the same function as K10.
//   Bound on an H100: device-memory bytes, 2*n*S / 3.35 TB/s (as K10).
//   Design: the mover with pair p = row p into slot p (the aligned path when
//   the row length and both pointers are 16-byte aligned).
//
// K12 replaces pallas_collectives._build_bcast (:1294), the "clamped
// conveyor": root streams segments rightward and every hop forwards segment s
// one wave after receiving it, until every rank holds root's buffer.  On one
// card that delivers root's row x[root] into all n rows of a new (n, *S).
// root is a runtime argument, as the TPU kernel's SMEM scalar is (:1317-1324),
// so one build serves every root.
//   Bound on an H100: device-memory bytes, (n+1)*S (read root's row once,
//   write n rows) / 3.35 TB/s.  Design: each thread loads 16 bytes of
//   x[root] once and stores them into all n output rows (row_bytes a
//   multiple of 16 and both pointers aligned); byte by byte otherwise.
//
// K13 replaces pallas_collectives._build_right_permute (:141): every rank
// sends its (1, *S) payload to its right neighbour by one remote DMA, the
// pipeline-parallel activation handoff.  On one card that is out[(i+1) % n]
// = x[i] for x (n, *S): a rotated copy.
//   Bound on an H100: device-memory bytes, 2*n*S / 3.35 TB/s.  Design: the
//   mover with pair i = rank i's row and its slot rotated by one.
#include "pair_copy.cuh"

namespace otpu {

constexpr int kCopyThreads = 256;

// a few blocks per SM, fewer when `units` (one per thread) need fewer
inline unsigned copy_blocks(int64_t units) {
  int64_t blocks = (units + kCopyThreads - 1) / kCopyThreads;
  const int64_t cap = (int64_t)sm_count() * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

template <bool VEC>
__global__ void __launch_bounds__(kCopyThreads)
bcast_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
             int64_t row_bytes, int n, int root) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint8_t* src = x + (int64_t)root * row_bytes;
  if constexpr (VEC) {
    const int64_t nvec = row_bytes / 16;
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int64_t v = tid; v < nvec; v += stride) {
      const uint4 u = __ldg(sv + v);
#pragma unroll 8
      for (int r = 0; r < n; ++r) ov[(int64_t)r * nvec + v] = u;
    }
  } else {
    for (int64_t i = tid; i < row_bytes; i += stride) {
      const uint8_t b = src[i];
#pragma unroll 8
      for (int r = 0; r < n; ++r) out[(int64_t)r * row_bytes + i] = b;
    }
  }
}

}  // namespace otpu

// The mover's entries (K10, K11, K13) take `counter`: nullptr, or 16
// zeroed bytes of device memory that a launch captured into a CUDA graph
// runs its span tickets on (pair_copy.cuh, launch_mover).

// The slots of the round-robin pool this library has dealt so far, mod
// 2^31 (pair_copy.cuh, tickets_dealt): a probe for the tests.
extern "C" int otpu_ring_copy_tickets_dealt() {
  return (int)(otpu::tickets_dealt().load(std::memory_order_relaxed) & 0x7fffffffu);
}

// x, out: (n, *S) device pointers of nbytes bytes in all.  vec is 16 (both
// pointers 16-byte aligned; the wrapper checks) or 1.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// vec; cudaErrorStreamCaptureUnsupported, launching nothing, for a captured
// vec 16 launch without a counter).
extern "C" int otpu_ring_all_gather(const void* x, void* out, long long nbytes,
                                    int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         nullptr, nbytes, 0, 1, 1, 0,
                         static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_SAME>(a, vec, stream);
}

// x, out: (n, row_bytes) device pointers; 0 <= root < n.  vec is 16
// (row_bytes % 16 == 0 and both pointers 16-byte aligned; the wrapper
// checks) or 1.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another vec or a root out of range).
extern "C" int otpu_ring_bcast(const void* x, void* out, long long row_bytes,
                               int n, int root, int vec, void* stream) {
  if (root < 0 || root >= n) return (int)cudaErrorInvalidValue;
  const auto* src = static_cast<const uint8_t*>(x);
  auto* dst = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16 && row_bytes % 16 == 0) {
    otpu::bcast_kernel<true><<<otpu::copy_blocks(row_bytes / 16), otpu::kCopyThreads,
                               0, s>>>(src, dst, row_bytes, n, root);
  } else if (vec == 1) {
    otpu::bcast_kernel<false><<<otpu::copy_blocks(row_bytes), otpu::kCopyThreads,
                                0, s>>>(src, dst, row_bytes, n, root);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out: (n, row_bytes) device pointers.  vec is 16 (row_bytes % 16 == 0
// and both pointers 16-byte aligned; the wrapper checks) or 1.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// vec, or a vec 16 that the pointers or row_bytes do not allow).
extern "C" int otpu_ring_right_permute(const void* x, void* out, long long row_bytes,
                                       int n, int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         nullptr, row_bytes, 0, n, n, 0,
                         static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_ROTATE>(a, vec, stream);
}

// x, out: (n, row_bytes) device pointers.  vec is 16 (row_bytes % 16 == 0
// and both pointers 16-byte aligned; the wrapper checks) or 1.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// vec, or a vec 16 that the pointers or row_bytes do not allow).
extern "C" int otpu_ring_all_gather_bidi(const void* x, void* out, long long row_bytes,
                                         int n, int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         nullptr, row_bytes, 0, n, n, 0,
                         static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_SAME>(a, vec, stream);
}
