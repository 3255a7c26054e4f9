// K14: all-to-all, K15: ragged all-to-all (alltoallv) and K16: ragged
// all-gather (allgatherv) of N virtual ranks held as the rows of one tensor.
// All three move bytes and compute nothing, so they are written on bytes:
// one build serves every dtype (MoE's int8 dispatch rides an int32 slab).
//
// K14 replaces pallas_collectives._build_all_to_all
// (ompi_tpu/ops/pallas_collectives.py:1050): a pairwise exchange in n-1
// steps, at step k each rank DMAs its block for rank i+k straight to it.  On
// one card, for x (n, n, *S): out[j, i] = x[i, j], a transpose of the two rank
// axes.  Bound: 2*n*n*S bytes / 3.35 TB/s.
//
// K15 replaces pallas_collectives._build_all_to_all_v (:1105): the same
// exchange with a runtime (n, n) int32 counts table in SMEM, each pair moving
// ceil(c/chunk) fixed (chunk, W) DMAs.  On one card, for x (n, n, R, W):
// out[j, i, :c] = x[i, j, :c] with c = clamp(counts[i, j], 0, R); rows past c
// are not written.  Bound: 2*sum(c)*W*itemsize bytes / 3.35 TB/s.
//
// K16 replaces pallas_collectives._build_all_gather_v (:1204): the ring
// all-gather with a runtime (n,) counts table, each block forwarded as
// ceil(c/chunk) DMAs.  On one card, for x (n, R, W): out[i, :c_i] =
// x[i, :c_i], the rest not written.  Bound: 2*sum(c_i)*W*itemsize bytes.
//
// The TPU's chunking (chunk_rows) exists because Mosaic needs static DMA
// shapes; the card has no such rule, so each pair moves exactly its count's
// bytes.  Design: the byte mover of pair_copy.cuh (shared with K10, K11 and
// K13), which reads the counts from device memory at run time and cuts the
// valid bytes of all pairs into equal spans that the CTAs of a persistent
// grid take in turn, so a skewed routing (K15's MoE dispatch) loads every SM
// alike; each span moves through TMA bulk copies.  K14 and K15 run pair p =
// (i, j) = (p / n, p % n) into slot (j, i), K16 pair i into slot i.
#include "pair_copy.cuh"

// The slots of the round-robin pool this library has dealt so far, mod
// 2^31 (pair_copy.cuh, tickets_dealt): a probe for the tests.
extern "C" int otpu_exchange_tickets_dealt() {
  return (int)(otpu::tickets_dealt().load(std::memory_order_relaxed) & 0x7fffffffu);
}

// x, out: (n, n, blk_bytes) device pointers.  vec is 16 (blk_bytes % 16 == 0
// and both pointers 16-byte aligned; the wrapper checks) or 1.  counter:
// nullptr, or 16 zeroed bytes of device memory that a launch captured into
// a CUDA graph runs its span tickets on (pair_copy.cuh, launch_mover).
// Each entry returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another vec, or a vec 16 that the pointers or
// the slot pitch do not allow; cudaErrorStreamCaptureUnsupported, launching
// nothing, for a captured vec 16 launch without a counter).
extern "C" int otpu_all_to_all(const void* x, void* out, long long blk_bytes, int n,
                               int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         nullptr, blk_bytes, 0, n, n * n, 0,
                         static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_TRANSPOSE>(a, vec, stream);
}

// x, out: (n, n, R, W) device pointers with slot_bytes = R*W*itemsize and
// row_bytes = W*itemsize; counts: (n, n) int32 device array (rows rank i
// sends rank j at [i, j]).  vec (slot_bytes % 16 == 0) and counter as above.
extern "C" int otpu_all_to_all_v(const void* x, void* out, const void* counts,
                                 long long slot_bytes, long long row_bytes, int n,
                                 int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         static_cast<const int32_t*>(counts), slot_bytes, row_bytes,
                         n, n * n, 0, static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_TRANSPOSE>(a, vec, stream);
}

// x, out: (n, R, W) device pointers, slot_bytes and row_bytes as above;
// counts: (n,) int32 device array.  vec and counter as above.
extern "C" int otpu_all_gather_v(const void* x, void* out, const void* counts,
                                 long long slot_bytes, long long row_bytes, int n,
                                 int vec, void* counter, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         static_cast<const int32_t*>(counts), slot_bytes, row_bytes,
                         n, n, 0, static_cast<unsigned long long*>(counter)};
  return otpu::launch_pair_copy<otpu::SLOT_SAME>(a, vec, stream);
}
