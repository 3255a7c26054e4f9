// The byte mover of K10, K11, K13 (ring_copy.cu) and K14-K16 (exchange.cu):
// one launch runs a batch of copies, one per "pair" p in [0, pairs).  Pair p
// owns the slot of `pitch` bytes at x + p*pitch and delivers the first
// nbytes(p) bytes of it to the slot dst_slot(p) of out:
//   nbytes(p) = pitch                          (dense: K10 as one pair of the
//                                               whole tensor, K11, K13, K14)
//   nbytes(p) = clamp(counts[p], 0, R)*row_bytes, R = pitch/row_bytes
//                                              (ragged: K15, K16)
// The counts are a device array read at run time, so one build serves every
// routing and a new one costs no rebuild or host read; the kernel clamps
// them again, so no count can drive a copy past its slot.  Bytes past
// nbytes(p) in out's slot are not written (the ragged results leave them
// unspecified).
//
// On one card the pairs are slots of two tensors, so every remote DMA of the
// TPU kernels is one copy in device memory and each byte moves once.  Bound
// on an H100: device-memory bytes, 2*sum(nbytes) / 3.35 TB/s.  Nothing is
// computed and no byte is read twice, so the whole task is to keep HBM busy
// in both directions from the first byte to the last.  What held the
// earlier bodies at 80% of that rate: every byte passed through registers
// with one load (a grid-stride loop) or one 16 KB item (the pair copy) in
// flight per thread before its stores, the items' last round ran three
// quarters full, and a skewed routing skipped whole items on some SMs.
//
// Design.  The valid bytes of the pairs, laid end to end, are "the stream".
// A persistent grid (kMoverCtasPerSm CTAs a SM) cuts it into equal spans of
// about kMoverSpan bytes, aligned to kSpanAlign, and the CTAs take them in
// stream order, one atomic ticket a span: whatever the routing, no item is
// skipped, no round runs part full, an SM that streams faster takes more
// spans, and at any moment the SMs work on one window of the stream.  Each
// CTA reads the counts (device memory, no host read), sums them and finds
// the pair where a span starts with a warp-wide prefix scan.
// - The aligned path (x, out and, for more than one pair, pitch 16-byte
//   aligned): a CTA is one warp.  Lane 0 walks the spans as (pair, offset,
//   length) pieces cut into chunks of at most kChunkBytes and moves each
//   chunk with one TMA bulk load (`cp.async.bulk` global -> shared,
//   completing on the slot's mbarrier with the chunk's own byte count) and
//   one bulk store (shared -> global, one bulk group), through a ring of
//   kMoverSlots slots: up to kMoverSlots - 1 loads in flight, and a slot is
//   refilled only after `wait_group.read` says the store that read it is
//   done.  No byte passes through registers, and a chunk costs the SM two
//   instructions where it cost 2 * kChunkBytes / 16.  Bulk copies move
//   16-byte multiples, so the walk takes each pair's bytes down to a
//   multiple of 16, and the lanes of CTA p % gridDim.x copy pair p's last
//   nbytes % 16.
// - The byte path (otherwise): kByteThreads threads copy spans of the same
//   length byte by byte, CTA b spans b, b + gridDim.x, ...
// The ring's shape, the span length, the tickets and the L2 policy (none)
// are the fastest of the forms that chip_mover_forms.py times side by side
// on the card (PERF.md §6): one span a CTA, spans dealt round-robin, an
// evict-first policy, other ring shapes, and a register form with 8 uint4
// loads a thread in flight all came slower.
#pragma once

#include <atomic>

#include "ring_common.cuh"

namespace otpu {

// where pair p's slot lands in out
enum { SLOT_SAME = 0, SLOT_ROTATE = 1, SLOT_TRANSPOSE = 2 };

// L2 policies of the bulk copies
enum { L2_NONE = 0, L2_EVICT_FIRST_LOADS = 1, L2_EVICT_FIRST = 2 };

constexpr int kMoverSlots = 12;         // ring of 12 x 16 KB: 192 KB of shared memory
constexpr int kChunkBytes = 16384;
constexpr int kMoverCtasPerSm = 1;
constexpr int64_t kMoverSpan = 32768;
constexpr int kMoverPolicy = L2_NONE;
constexpr int64_t kSpanAlign = 256;     // spans of the aligned path start on 256 bytes
constexpr int kByteThreads = 256;

struct PairCopy {
  const uint8_t* x;
  uint8_t* out;
  const int32_t* counts;  // nullptr: every pair moves its whole slot
  int64_t pitch;          // bytes of one slot
  int64_t row_bytes;      // bytes one count stands for (ragged only)
  int n;                  // ranks
  int pairs;              // 1 (K10), n (K11, K13, K16) or n*n (K14, K15)
  int ticket;             // the aligned path's slot of g_tickets (set at launch)
  // the aligned path's counter pair when the caller brings one (a launch
  // that a CUDA graph captures), else nullptr and slot `ticket`
  unsigned long long* counter;
};

template <int SLOT>
__device__ __forceinline__ int64_t dst_slot(int64_t p, int n) {
  if (SLOT == SLOT_ROTATE) return (p + 1) % n;                 // x[i] -> out[i+1]
  if (SLOT == SLOT_TRANSPOSE) return (p % n) * n + p / n;      // x[i,j] -> out[j,i]
  return p;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// nbytes(p), the count clamped to [0, R]
__device__ __forceinline__ int64_t pair_bytes(const PairCopy& a, int64_t p) {
  if (a.counts == nullptr) return a.pitch;
  const int64_t rows = a.pitch / a.row_bytes;
  const int64_t c = __ldg(a.counts + p);
  return (c <= 0 ? 0 : (c > rows ? rows : c)) * a.row_bytes;
}

// the bytes of pair p in the stream: on the aligned path its 16-byte part
template <bool VEC>
__device__ __forceinline__ int64_t stream_bytes(const PairCopy& a, int64_t p) {
  const int64_t b = pair_bytes(a, p);
  return VEC ? b & ~int64_t(15) : b;
}

// A span of the stream, bytes [lo, hi), starting `off` bytes into pair p
// (lo == hi: none).
struct Span {
  int64_t lo, hi, p, off;
};

constexpr unsigned kAllLanes = 0xffffffffu;

// The stream's length.  Called by all 32 lanes of a warp.
template <bool VEC>
__device__ int64_t stream_total(const PairCopy& a) {
  int64_t total = 0;
  for (int64_t p = threadIdx.x & 31; p < a.pairs; p += 32) total += stream_bytes<VEC>(a, p);
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(kAllLanes, total, d);
  return total;
}

// Span j of `count` equal spans of a stream of `total` bytes (aligned to
// kSpanAlign on the aligned path).  Called by all 32 lanes of a warp; every
// lane gets the same span.
template <bool VEC>
__device__ Span find_span(const PairCopy& a, int64_t total, int64_t j, int64_t count) {
  const int lane = threadIdx.x & 31;
  const int64_t align = VEC ? kSpanAlign : 1;
  const int64_t per = ((total + count - 1) / count + align - 1) / align * align;
  Span s;
  s.lo = lmin(total, j * per);
  s.hi = lmin(total, s.lo + per);
  s.p = a.pairs;
  s.off = 0;
  if (s.lo >= s.hi) return s;
  // the first pair whose bytes hold lo: a prefix scan, 32 pairs at a time
  int64_t base = 0;
  for (int64_t t = 0; t < a.pairs; t += 32) {
    const int64_t b = t + lane < a.pairs ? stream_bytes<VEC>(a, t + lane) : 0;
    int64_t incl = b;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t v = __shfl_up_sync(kAllLanes, incl, d);
      if (lane >= d) incl += v;
    }
    const int64_t start = base + incl - b;
    const unsigned hit = __ballot_sync(kAllLanes, b > 0 && start <= s.lo && s.lo < start + b);
    if (hit) {
      const int at = __ffs(hit) - 1;
      s.p = t + at;
      s.off = s.lo - __shfl_sync(kAllLanes, start, at);
      return s;
    }
    base += __shfl_sync(kAllLanes, incl, 31);
  }
  return s;
}

// The rounds of gridDim.x spans of about SPAN bytes that cover `total`: the
// stream is cut into rounds * gridDim.x equal spans.
template <int64_t SPAN>
__device__ __forceinline__ int64_t span_rounds(int64_t total) {
  const int64_t round = (int64_t)gridDim.x * SPAN;
  return (total + round - 1) / round;
}

// f(src, dst, len) for the span's pieces in order, each cut into chunks of
// at most `chunk` bytes.
template <int SLOT, bool VEC, class F>
__device__ __forceinline__ void walk_span(const PairCopy& a, const Span& s, int64_t chunk,
                                          F&& f) {
  int64_t left = s.hi - s.lo, off = s.off;
  for (int64_t p = s.p; left > 0 && p < a.pairs; ++p, off = 0) {
    const int64_t take = lmin(stream_bytes<VEC>(a, p) - off, left);
    const uint8_t* src = a.x + p * a.pitch + off;
    uint8_t* dst = a.out + dst_slot<SLOT>(p, a.n) * a.pitch + off;
    for (int64_t c = 0; c < take; c += chunk) f(src + c, dst + c, lmin(chunk, take - c));
    if (take > 0) left -= take;
  }
}

// The aligned path's last nbytes(p) % 16 bytes of each pair p, by the
// first 15 threads of CTA p % gridDim.x.
template <int SLOT>
__device__ __forceinline__ void copy_tails(const PairCopy& a) {
  if (a.counts == nullptr && a.pitch % 16 == 0) return;
  for (int64_t p = blockIdx.x; p < a.pairs; p += gridDim.x) {
    const int64_t nb = pair_bytes(a, p), i = (nb & ~int64_t(15)) + threadIdx.x;
    if (i < nb) a.out[dst_slot<SLOT>(p, a.n) * a.pitch + i] = a.x[p * a.pitch + i];
  }
}

// The ring of bulk-copy slots, driven by one thread.  Shared memory: SLOTS
// chunks of CHUNK bytes, then SLOTS mbarriers, destinations and lengths.
template <int SLOTS, int CHUNK, int POLICY>
struct BulkRing {
  static constexpr int kSmem = SLOTS * (CHUNK + 8 + 8 + 4);

  uint32_t ring, bars;
  uint8_t** dst;
  int* len;
  uint64_t policy = 0;
  int64_t issued = 0, stored = 0;

  __device__ explicit BulkRing(uint8_t* smem)
      : ring((uint32_t)__cvta_generic_to_shared(smem)),
        bars(ring + SLOTS * CHUNK),
        dst(reinterpret_cast<uint8_t**>(smem + SLOTS * CHUNK + SLOTS * 8)),
        len(reinterpret_cast<int*>(smem + SLOTS * CHUNK + SLOTS * 16)) {}

  // by the one thread that drives the ring, before its first push
  __device__ __forceinline__ void init() {
    for (int s = 0; s < SLOTS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (POLICY != L2_NONE)
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  }

  // bulk-load n bytes (a multiple of 16, at most CHUNK) from src into the
  // next slot; their store to d follows in order
  __device__ __forceinline__ void push(const uint8_t* src, uint8_t* d, int n) {
    if (issued - stored == SLOTS - 1) pop();
    const int s = (int)(issued % SLOTS);
    // the store that last read slot s is the older of the (at most) two
    // not yet known to be done reading
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    dst[s] = d;
    len[s] = n;
    const uint32_t bar = bars + 8 * s, to = ring + s * CHUNK;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(n)
                 : "memory");
    if (POLICY != L2_NONE) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
          " [%0], [%1], %2, [%3], %4;\n" ::"r"(to), "l"(src), "r"(n), "r"(bar), "l"(policy)
          : "memory");
    } else {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(to), "l"(src), "r"(n), "r"(bar)
          : "memory");
    }
    ++issued;
  }

  // wait for the oldest slot's load and bulk-store it
  __device__ __forceinline__ void pop() {
    const int s = (int)(stored % SLOTS);
    const uint32_t bar = bars + 8 * s, from = ring + s * CHUNK;
    const int parity = (int)((stored / SLOTS) & 1);
    // a load that never lands is a fault: trap after ~2^26 tries rather
    // than hang the card
    for (unsigned tries = 0;; ++tries) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
      if (done) break;
      if (tries == (1u << 26)) __trap();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (POLICY == L2_EVICT_FIRST) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
                   " [%0], [%1], %2, %3;\n" ::"l"(dst[s]), "r"(from), "r"(len[s]), "l"(policy)
                   : "memory");
    } else {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst[s]),
                   "r"(from), "r"(len[s])
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    ++stored;
  }

  // store what is loaded, then wait until every store has completed
  __device__ __forceinline__ void drain() {
    while (stored < issued) pop();
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
};

// Span tickets.  A launch of the aligned path takes its spans in stream
// order from a counter pair of its own (next span, CTAs done).  An eager
// launch takes slot `ticket` of g_tickets, which the host deals
// round-robin, so that launches on two streams never share one; the last
// CTA to finish sets the pair back to zero for the launch that takes the
// slot kTicketSlots later.  A launch that a CUDA graph captures keeps its
// arguments for every replay, so a slot it drew would be dealt again to
// eager launches (and to other captures) while a replay runs: such a
// launch runs on the pair the caller passes (`counter`), which belongs to
// the graph.
constexpr int kTicketSlots = 1024;
__device__ unsigned long long g_tickets[kTicketSlots][2];

// The slots this library has dealt (mod 2^32): one an eager launch of the
// aligned path, none a launch on a caller's pair or a refused one.
inline std::atomic<unsigned>& tickets_dealt() {
  static std::atomic<unsigned> dealt{0};
  return dealt;
}

inline int next_ticket() {
  return (int)(tickets_dealt().fetch_add(1, std::memory_order_relaxed) % kTicketSlots);
}

// One thread of each CTA, after the CTA's last ticket
__device__ __forceinline__ void release_tickets(unsigned long long* ticket) {
  __threadfence();
  if (atomicAdd(ticket + 1, 1ull) == gridDim.x - 1) ticket[0] = ticket[1] = 0;
}

// The aligned path: one warp a CTA, lane 0 driving the ring through the
// spans the CTA takes.
template <int SLOT, int SLOTS, int CHUNK, int POLICY, int64_t SPAN>
__global__ void __launch_bounds__(32) mover_kernel(PairCopy a) {
  extern __shared__ __align__(128) uint8_t smem[];
  unsigned long long* ticket = a.counter != nullptr ? a.counter : g_tickets[a.ticket];
  const int64_t total = stream_total<true>(a);
  const int64_t count = span_rounds<SPAN>(total) * gridDim.x;
  BulkRing<SLOTS, CHUNK, POLICY> ring(smem);
  unsigned long long mine = 0;  // lane 0's ticket
  if (threadIdx.x == 0) {
    ring.init();
    mine = atomicAdd(ticket, 1ull);
  }
  for (int64_t j; (j = (int64_t)__shfl_sync(kAllLanes, mine, 0)) < count;) {
    // the next span's ticket is in flight while this span is issued
    if (threadIdx.x == 0) mine = atomicAdd(ticket, 1ull);
    const Span s = find_span<true>(a, total, j, count);
    if (threadIdx.x == 0)
      walk_span<SLOT, true>(a, s, CHUNK, [&](const uint8_t* src, uint8_t* dst, int64_t n) {
        ring.push(src, dst, (int)n);
      });
    __syncwarp();
  }
  if (threadIdx.x == 0) {
    ring.drain();
    release_tickets(ticket);
  }
  __syncwarp();
  copy_tails<SLOT>(a);
}

// The byte path: every warp finds the same spans, the CTA copies them.
template <int SLOT>
__global__ void __launch_bounds__(kByteThreads) mover_byte_kernel(PairCopy a) {
  const int64_t total = stream_total<false>(a);
  const int64_t rounds = span_rounds<kMoverSpan>(total);
  for (int64_t k = 0; k < rounds; ++k) {
    const Span s = find_span<false>(a, total, blockIdx.x + k * gridDim.x, rounds * gridDim.x);
    walk_span<SLOT, false>(a, s, s.hi - s.lo, [&](const uint8_t* src, uint8_t* dst, int64_t n) {
      for (int64_t i = threadIdx.x; i < n; i += kByteThreads) dst[i] = src[i];
    });
  }
}

// CTAs for a stream of at most `most` bytes: one per chunk, at most
// `per_sm` a SM
inline unsigned mover_grid(int64_t most, int per_sm) {
  const int64_t cap = (int64_t)sm_count() * per_sm;
  const int64_t want = (most + kChunkBytes - 1) / kChunkBytes;
  return (unsigned)(want < 1 ? 1 : (want > cap ? cap : want));
}

// The aligned path's launch with its ring shape.  The shared-memory limit is
// raised once per device and library: `static`, so that the flag is this
// library's own (a template's local static is otherwise one object shared by
// every library that instantiates it, and a second library's kernel would
// launch without the limit raised).  Without a counter pair of the caller's
// the launch draws a slot, unless the stream is capturing: then it launches
// nothing and returns cudaErrorStreamCaptureUnsupported, and the caller
// passes a pair that the graph owns.
template <int SLOT, int SLOTS, int CHUNK, int POLICY, int64_t SPAN>
static int launch_mover(PairCopy a, unsigned grid, cudaStream_t s) {
  if (a.counter == nullptr) {
    cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
    const cudaError_t err = cudaStreamIsCapturing(s, &capture);
    if (err != cudaSuccess) return (int)err;
    if (capture != cudaStreamCaptureStatusNone) return (int)cudaErrorStreamCaptureUnsupported;
    a.ticket = next_ticket();
  }
  auto* kernel = mover_kernel<SLOT, SLOTS, CHUNK, POLICY, SPAN>;
  constexpr int smem = BulkRing<SLOTS, CHUNK, POLICY>::kSmem;
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  kernel<<<grid, 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Launch the batch on `stream`: vec 16 (x, out and, for more than one
// pair, pitch 16-byte aligned; the wrappers check) or 1.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for another
// vec or a vec 16 the pointers or pitch do not allow, and
// cudaErrorStreamCaptureUnsupported, having launched nothing, for a vec 16
// batch on a capturing stream without a.counter (see launch_mover).
template <int SLOT>
int launch_pair_copy(const PairCopy& a, int vec, void* stream) {
  if (vec != 16 && vec != 1) return (int)cudaErrorInvalidValue;
  if (a.pitch <= 0 || a.pairs <= 0) return (int)cudaSuccess;
  if (a.counts != nullptr && a.row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t most = a.pitch * a.pairs;
  if (vec == 1) {
    mover_byte_kernel<SLOT><<<mover_grid(most, 2048 / kByteThreads), kByteThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.out)) % 16 != 0 ||
      (a.pairs > 1 && a.pitch % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return launch_mover<SLOT, kMoverSlots, kChunkBytes, kMoverPolicy, kMoverSpan>(
      a, mover_grid(most, kMoverCtasPerSm), s);
}

}  // namespace otpu
