// The byte mover of K13 (ring_copy.cu) and K14-K16 (exchange.cu): one launch
// runs a batch of copies, one per "pair" p in [0, pairs).  Pair p owns the
// slot of `pitch` bytes at x + p*pitch and delivers the first nbytes(p) bytes
// of it to the slot dst_slot(p) of out:
//   nbytes(p) = pitch                          (dense: K13, K14)
//   nbytes(p) = clamp(counts[p], 0, R)*row_bytes, R = pitch/row_bytes
//                                              (ragged: K15, K16)
// The counts are a device array read at run time, so one build serves every
// routing and a new one costs no rebuild; the kernel clamps them again, so
// no count can drive a copy past its slot.  Bytes past nbytes(p) in out's
// slot are not written (the ragged results leave them unspecified).
//
// On one card the pairs are slots of two tensors, so every remote DMA of the
// TPU kernels is one copy in device memory and each byte moves once.  Bound
// on an H100: device-memory bytes, 2*sum(nbytes) / 3.35 TB/s.  Design: the
// work is cut into items of kChunk bytes, `pairs` * ceil(pitch/kChunk) of
// them; block b takes items b, b + gridDim.x, ..., so every block gets a share
// of every pair and a skewed routing loads the SMs evenly.  An item past its
// pair's count is skipped after one read of the count.  A full item moves 16
// bytes a thread in kChunk/(16*kPairThreads) loads issued together, then as
// many stores; a short item (a count's last rows, a small pitch) copies 16
// bytes a thread then its tail byte by byte.  VEC needs x, out and pitch
// 16-byte aligned (the wrappers check); otherwise every byte is copied alone.
#pragma once

#include "ring_common.cuh"

namespace otpu {

// where pair p's slot lands in out
enum { SLOT_SAME = 0, SLOT_ROTATE = 1, SLOT_TRANSPOSE = 2 };

constexpr int kPairThreads = 256;
constexpr int64_t kChunk = 16384;
constexpr int kChunkVecs = (int)(kChunk / 16 / kPairThreads);

struct PairCopy {
  const uint8_t* x;
  uint8_t* out;
  const int32_t* counts;  // nullptr: every pair moves its whole slot
  int64_t pitch;          // bytes of one slot
  int64_t row_bytes;      // bytes one count stands for (ragged only)
  int n;                  // ranks
  int pairs;              // n (K13, K16) or n*n (K14, K15)
};

template <int SLOT>
__device__ __forceinline__ int64_t dst_slot(int64_t p, int n) {
  if (SLOT == SLOT_ROTATE) return (p + 1) % n;                 // x[i] -> out[i+1]
  if (SLOT == SLOT_TRANSPOSE) return (p % n) * n + p / n;      // x[i,j] -> out[j,i]
  return p;
}

template <int SLOT, bool VEC>
__global__ void __launch_bounds__(kPairThreads) pair_copy_kernel(PairCopy a) {
  const int64_t chunks = (a.pitch + kChunk - 1) / kChunk;
  const int64_t items = chunks * a.pairs;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const int64_t p = w / chunks;
    const int64_t lo = (w - p * chunks) * kChunk;
    int64_t nbytes = a.pitch;
    if (a.counts != nullptr) {
      const int64_t rows = a.pitch / a.row_bytes;
      const int64_t c = __ldg(a.counts + p);
      nbytes = (c <= 0 ? 0 : (c > rows ? rows : c)) * a.row_bytes;
    }
    const int64_t len = nbytes - lo < kChunk ? nbytes - lo : kChunk;
    if (len <= 0) continue;
    const uint8_t* __restrict__ src = a.x + p * a.pitch + lo;
    uint8_t* __restrict__ dst = a.out + dst_slot<SLOT>(p, a.n) * a.pitch + lo;
    int64_t head = 0;
    if constexpr (VEC) {
      const uint4* __restrict__ sv = reinterpret_cast<const uint4*>(src);
      uint4* __restrict__ dv = reinterpret_cast<uint4*>(dst);
      if (len == kChunk) {
        uint4 r[kChunkVecs];
#pragma unroll
        for (int k = 0; k < kChunkVecs; ++k) r[k] = __ldg(sv + threadIdx.x + k * kPairThreads);
#pragma unroll
        for (int k = 0; k < kChunkVecs; ++k) dv[threadIdx.x + k * kPairThreads] = r[k];
        continue;
      }
      const int64_t nvec = len / 16;
      for (int64_t v = threadIdx.x; v < nvec; v += kPairThreads) dv[v] = __ldg(sv + v);
      head = nvec * 16;
    }
    for (int64_t i = head + threadIdx.x; i < len; i += kPairThreads) dst[i] = src[i];
  }
}

// Launch the batch on `stream`: vec 16 (aligned, see above) or 1.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for another vec.
template <int SLOT>
int launch_pair_copy(const PairCopy& a, int vec, void* stream) {
  if (vec != 16 && vec != 1) return (int)cudaErrorInvalidValue;
  if (a.pitch <= 0 || a.pairs <= 0) return (int)cudaSuccess;
  if (a.counts != nullptr && a.row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const int64_t items = (a.pitch + kChunk - 1) / kChunk * a.pairs;
  const int64_t cap = (int64_t)sm_count() * (2048 / kPairThreads);
  const unsigned blocks = (unsigned)(items < cap ? items : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    pair_copy_kernel<SLOT, true><<<blocks, kPairThreads, 0, s>>>(a);
  } else {
    pair_copy_kernel<SLOT, false><<<blocks, kPairThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace otpu
