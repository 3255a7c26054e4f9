// K3: fused ring all-reduce, and K5: fused ring reduce-scatter, of N virtual
// ranks held as the rows of one tensor; K7 and K5's wire16 form: the same
// two with the bf16 wire; K8: the duplex all-reduce; the sub-ring form of
// K3 and K5 that the torus schedules run; and K4, K6 and K9, the segmented
// all-reduce, reduce-scatter and duplex all-reduce.  All of them are one
// kernel, ring_fused_kernel, in one pass with the accumulator on chip.
//
// K3 replaces the Pallas kernel pallas_collectives._build_all_reduce with its
// _rs_phase and _ag_phase (ompi_tpu/ops/pallas_collectives.py:361, :311,
// :567), the `fused` variant of all_reduce: n-1 reduce-scatter steps folding
// each incoming block into a VMEM accumulator, then n-1 all-gather steps.
// K5 replaces pallas_collectives._build_reduce_scatter (:502), the same
// reduce-scatter phase with align=-1, so that rank b ends owning block b.
// K7 replaces pallas_collectives._build_all_reduce_wire16 (:425), and K5's
// wire16 form _build_reduce_scatter(wire16=True) (:554): float32 only, the
// outgoing partial of every hop is cast to bf16 (half the link bytes on the
// TPU) and folded back at float32 -- p = fold(own, f32(bf16(p))) -- and K7
// rounds the finished block to bf16 once more, so every rank returns the
// same bits (:463-469); the reduce-scatter's owner keeps its float32 partial
// (:511-515).  The TPU kernel writes K7's result as bf16 and its wrapper
// upcasts it (:1606); here it is written as the same values in float32.
// K8 replaces pallas_collectives._build_all_reduce_bidi (:961): every ring
// block is two halves of h = hrows*128 elements, the first reduced by a
// clockwise ring and the second by a counter-clockwise one, both at once on
// the TPU's duplex links (:987-1010).  Both partials start on rank b; the
// clockwise one then meets ranks b+1, b+2, ..., the other b-1, b-2, ...
// The torus schedules (:1833-2028) run K3 and K5 as sub-rings of an (n0, n1)
// grid (sub=(n0, n1, j), :118-137): here one launch takes a whole phase,
// every sub-ring of it, through a rank pitch and a period of the block index.
//
// K4 replaces pallas_collectives._build_all_reduce_seg with its _seg_rs_phase
// and _seg_fold_row (:674, :642, :587), the `seg` variant that coll/pallas
// routes per-rank payloads above vmem_max_bytes to: there the accumulator
// lives in HBM and every ring step makes one pass over the payload through a
// 2-slot VMEM window, because VMEM bounds the on-chip accumulator.  K6
// replaces _build_reduce_scatter_seg (:744), the same phase with align=-1;
// K9 replaces _build_all_reduce_seg_bidi (:850) with its _bidi_done_and_ag
// (:804), K8's duplex halves in that regime.  On this card a thread's
// accumulator is its 16 bytes of registers at any payload size, so the
// segmented entry points launch the same one-pass body as K3, K5 and K8;
// what stays of the TPU regime is its ring blocks, rounded by the wrapper to
// whole windows (`blk`), which fix the fold order and so the values.
//
// On one card the n ranks are rows of x (n, size).  The fold order of the TPU
// ring is kept (see ring_common.cuh), so the result is bit-identical with the
// reference; K3's all-gather phase moves no bytes here -- the result is one
// (size,) tensor, written once.  K5 is the same kernel with start offset 1
// over the (n, n, *S) input viewed as (n, n*prod(S)); its (n*prod(S),) output
// is the (n, *S) result, row b for rank b.
//
// Bound on an H100: device-memory bytes.  The function reads n*size and
// writes size elements and does one fold per element read (~0.25 flop/byte,
// far below the ridge; the wire rounding adds a few integer operations per
// fold, still far below it), so its least time is (n+1)*size*sizeof(T) /
// 3.35 TB/s -- for K5 and K6, (n+1)*P with P the per-rank payload
// n*prod(S)*sizeof(T); for K8, K4 and K9 the same as K3.  On one card no
// link carries the partials, so neither the bf16 wire nor the duplex split
// saves anything: K7 and K8 move K3's bytes and are kept for their numbers.
//
// Design: one pass, tiles outside, ranks inside.  Each thread owns VEC
// contiguous elements (16 bytes) of a tile; it reads the n ranks' slices of
// them in ring order b+s, b+s+1, ..., b+s-1 (a duplex block's second half:
// b, b-1, ..., b+1), folds them in registers -- the on-chip accumulator --
// and stores the result once: the bound's bytes.  To keep enough bytes in
// flight, every thread streams its (tile, ring step) units through a private
// ring of kDepth slots in shared memory: cp.async copies run kDepth-1 units
// ahead, across tile boundaries, while the thread folds the oldest one.  A
// slot is written and read by its own thread only, so no barrier is needed.
// No input byte is read twice, so the copies carry an L2 evict-first hint;
// the result is stored plainly, as the next phase of a torus schedule (or
// the caller) reads it.  The wire and the walk are compile-time modes: the
// rounding sits between the folds in registers and costs no memory traffic.
// The grid is as many blocks as fit on the card at once, each walking tiles
// grid-stride.
#include <type_traits>

#include "ring_common.cuh"

namespace otpu {

constexpr int kFusedThreads = 256;
constexpr int kDepth = 8;  // slots per thread: 7 units in flight

// wire modes: none (K3, K5); bf16 partials (K5w); bf16 partials and result (K7)
enum { kWireOff = 0, kWireHops = 1, kWireHopsAndResult = 2 };
// ring walks: one way (K3-K7); duplex halves (K8, K9); a batch of sub-rings
// at a rank pitch (the torus schedules' K3 and K5)
enum { kRing = 0, kDuplex = 1, kSubRings = 2 };

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// global -> shared copy of one thread's VEC elements: cp.async for 4, 8 and
// 16 bytes with the evict-first hint; a 2-byte element (f16 off the aligned
// path) is copied directly.
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem, uint64_t policy) {
  constexpr int kBytes = sizeof(T) * VEC;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(gmem), "l"(policy) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n"
                 ::"r"(s), "l"(gmem), "l"(policy) : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(gmem), "l"(policy) : "memory");
  } else {
    *smem = *gmem;
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_shared(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int OP, int VEC, int WIRE, int WALK>
__global__ void __launch_bounds__(kFusedThreads)
ring_fused_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t size,
                  int64_t blk, int n, int start, int64_t period, int64_t pitch) {
  __shared__ __align__(16) T win[kDepth][kFusedThreads * VEC];
  const int lane = threadIdx.x * VEC;
  const int64_t tile = (int64_t)kFusedThreads * VEC;
  const int64_t stride = tile * gridDim.x;
  const uint64_t policy = evict_first_policy();

  // issue side: the element of the next unit, its ring step and rank, and
  // the rank's walk (+1, or n-1 on a duplex block's second half)
  int64_t ie = (int64_t)blockIdx.x * tile + lane;
  int ik = 0, ir = 0, istep = 1;
  auto first_rank = [&](int64_t e) {
    // ring block b: its partial starts on rank b + start
    const int64_t b = (WALK == kSubRings ? e % period : e) / blk;
    ir = (int)((b + start) % n);
    if constexpr (WALK == kDuplex) istep = e - b * blk >= blk / 2 ? n - 1 : 1;
  };
  if (ie < size) first_rank(ie);
  auto issue = [&](int slot) {
    if (ie < size) {
      copy_async<T, VEC>(&win[slot][lane], x + (int64_t)ir * pitch + ie, policy);
      if (++ik == n) {
        ik = 0;
        ie += stride;
        if (ie < size) first_rank(ie);
      } else {
        ir += istep;
        if (ir >= n) ir -= n;
      }
    }
    copy_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kDepth - 1; ++s) issue(s);

  // fold side: unit i sits in slot i % kDepth
  Pack<T, VEC> acc;
  int ck = 0, slot = 0;
  for (int64_t ce = (int64_t)blockIdx.x * tile + lane; ce < size;) {
    copy_wait<kDepth - 2>();  // the oldest unit in flight has landed
    const Pack<T, VEC> own = load_shared<T, VEC>(&win[slot][lane]);
    if (ck == 0) {
      acc = own;
    } else {
      if constexpr (WIRE != kWireOff) wire_round(acc);  // the hop's bf16 bytes
      fold_into<OP>(acc, own);                           // fold(own, incoming)
    }
    // the slot folded last time is free: the next unit goes there
    issue(slot == 0 ? kDepth - 1 : slot - 1);
    slot = slot + 1 == kDepth ? 0 : slot + 1;
    if (++ck == n) {
      if constexpr (WIRE == kWireHopsAndResult) wire_round(acc);
      store<T, VEC>(out + ce, acc);
      ck = 0;
      ce += stride;
    }
  }
  copy_wait<0>();
}

template <typename T, int OP, int VEC>
struct FusedLaunch {
  template <int WIRE, int WALK>
  static void go(const void* x, void* out, int64_t size, int64_t blk, int n,
                 int start, int64_t period, int64_t pitch, cudaStream_t stream) {
    auto* kernel = ring_fused_kernel<T, OP, VEC, WIRE, WALK>;
    const int64_t tile = (int64_t)kFusedThreads * VEC;
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFusedThreads, 0);
    int64_t blocks = (size + tile - 1) / tile;
    const int64_t cap = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    kernel<<<(unsigned)blocks, kFusedThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), size, blk, n, start,
        period, pitch);
  }

  static void run(const void* x, void* out, int64_t size, int64_t blk, int n,
                  int start, int wire, int walk, int64_t period, int64_t pitch,
                  cudaStream_t stream) {
    if (walk == kDuplex)
      return go<kWireOff, kDuplex>(x, out, size, blk, n, start, period, pitch, stream);
    if (walk == kSubRings)
      return go<kWireOff, kSubRings>(x, out, size, blk, n, start, period, pitch, stream);
    if constexpr (std::is_same_v<T, float>) {
      if (wire == kWireHops)
        return go<kWireHops, kRing>(x, out, size, blk, n, start, period, pitch, stream);
      if (wire == kWireHopsAndResult)
        return go<kWireHopsAndResult, kRing>(x, out, size, blk, n, start, period, pitch,
                                             stream);
    }
    go<kWireOff, kRing>(x, out, size, blk, n, start, period, pitch, stream);
  }
};

inline int fused(const void* x, void* out, long long size, long long blk,
                 int n, int dtype, int op, int vec, int start, int wire,
                 int walk, long long period, long long pitch, void* stream) {
  if (wire != kWireOff && dtype != DT_F32) return (int)cudaErrorInvalidValue;
  if (blk <= 0 || n < 1 || start < 0 || (walk == kDuplex && blk % 2) ||
      (walk == kSubRings && period <= 0))
    return (int)cudaErrorInvalidValue;
  if (!dispatch<FusedLaunch>(dtype, op, vec, x, out, (int64_t)size,
                             (int64_t)blk, n, start, wire, walk,
                             (int64_t)period, (int64_t)pitch,
                             static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace otpu

// x: (n, size) device pointer, out: (size,).  size % vec == 0 and, with
// vec > 1, blk % vec == 0 and both pointers and the row pitch are 16-byte
// aligned (the wrapper checks).  Each returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown dtype/op/vec code, a block of
// no element, or a wire16 entry called on another dtype than float32).

// K3: all-reduce, blocks of blk = rows*128 elements, start offset 0.
extern "C" int otpu_ring_fused(const void* x, void* out, long long size,
                               long long blk, int n, int dtype, int op, int vec,
                               void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 0, otpu::kWireOff,
                     otpu::kRing, size, size, stream);
}

// K5: reduce-scatter, x (n, n*blk) with blk = prod(S), start offset 1.
extern "C" int otpu_ring_rs_fused(const void* x, void* out, long long size,
                                  long long blk, int n, int dtype, int op,
                                  int vec, void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 1, otpu::kWireOff,
                     otpu::kRing, size, size, stream);
}

// K7: K3 on float32 with the bf16 wire and the result rounded once.
extern "C" int otpu_ring_wire16(const void* x, void* out, long long size,
                                long long blk, int n, int dtype, int op,
                                int vec, void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 0,
                     otpu::kWireHopsAndResult, otpu::kRing, size, size, stream);
}

// K5's wire16 form: K5 on float32 with the bf16 wire, the result unrounded.
extern "C" int otpu_ring_rs_wire16(const void* x, void* out, long long size,
                                   long long blk, int n, int dtype, int op,
                                   int vec, void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 1, otpu::kWireHops,
                     otpu::kRing, size, size, stream);
}

// K8: all-reduce over duplex blocks of blk = 2*hrows*128 elements, start
// offset 0: the first half of each block walks right, the second left.  With
// vec > 1, blk/2 % vec == 0 as well (the wrapper checks), so no pack straddles
// the two halves.
extern "C" int otpu_ring_bidi(const void* x, void* out, long long size,
                              long long blk, int n, int dtype, int op, int vec,
                              void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 0, otpu::kWireOff,
                     otpu::kDuplex, size, size, stream);
}

// K3 (start 0) or K5 (start 1) over a batch of sub-rings, one launch for a
// whole phase of a torus schedule: out[t], t < total, folds x[r*pitch + t]
// over the n ranks r of its ring, in the order of ring block
// (t % period) / blk.  With vec > 1, total, blk, period and pitch are
// multiples of vec and both pointers 16-byte aligned (the wrapper checks).
extern "C" int otpu_ring_sub(const void* x, void* out, long long total,
                             long long blk, long long period, long long pitch,
                             int n, int start, int dtype, int op, int vec,
                             void* stream) {
  return otpu::fused(x, out, total, blk, n, dtype, op, vec, start, otpu::kWireOff,
                     otpu::kSubRings, period, pitch, stream);
}

// The segmented entry points: the same body over the wrapper's
// window-rounded ring blocks (see the notes on K4, K6 and K9 above).

// K4: all-reduce, blocks of blk = rows*128 elements, start offset 0.
extern "C" int otpu_ring_seg(const void* x, void* out, long long size,
                             long long blk, int n, int dtype, int op, int vec,
                             void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 0, otpu::kWireOff,
                     otpu::kRing, size, size, stream);
}

// K6: reduce-scatter, x (n, n*blk) with blk = prod(S), start offset 1.
extern "C" int otpu_ring_rs_seg(const void* x, void* out, long long size,
                                long long blk, int n, int dtype, int op,
                                int vec, void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 1, otpu::kWireOff,
                     otpu::kRing, size, size, stream);
}

// K9: K4 over duplex blocks of blk = 2*hrows*128 elements (hrows rounded to
// whole windows by the wrapper), start offset 0: the first half of each
// block walks right, the second left.  With vec > 1, blk/2 % vec == 0 as
// well (the wrapper checks).
extern "C" int otpu_ring_seg_bidi(const void* x, void* out, long long size,
                                  long long blk, int n, int dtype, int op,
                                  int vec, void* stream) {
  return otpu::fused(x, out, size, blk, n, dtype, op, vec, 0, otpu::kWireOff,
                     otpu::kDuplex, size, size, stream);
}
