// K4: segmented ring all-reduce, K6: segmented ring reduce-scatter, and K9:
// the segmented duplex all-reduce, accumulator in device memory.
//
// K4 replaces the Pallas kernel pallas_collectives._build_all_reduce_seg with
// its _seg_rs_phase and _seg_fold_row (ompi_tpu/ops/pallas_collectives.py:674,
// :642, :587), the `seg` variant of all_reduce that coll/pallas routes per-rank
// payloads above vmem_max_bytes to: the (n, nseg, S, 128) accumulator lives in
// HBM and every ring step streams its fold through a 2-slot VMEM window.  K6
// replaces pallas_collectives._build_reduce_scatter_seg (:744), the same
// phase with align=-1 (start offset 1 here, see ring_common.cuh): step 0's
// partial is x[b+1] and the peer of step k is rank b+2+k.  The tile partition
// need not match the TPU's window-rounded blocks: no value depends on it.
// K9 replaces pallas_collectives._build_all_reduce_seg_bidi (:850) with its
// _bidi_done_and_ag (:804): the (n, 2, nseg, S, 128) payload in HBM, the
// first half of every ring block reduced by a clockwise ring and the second
// by a counter-clockwise one, both folds streamed through one shared VMEM
// window (:876-909).  Here the step's peer is chosen per element: b+s+1+k on
// a first half, b+s-1-k on a second.  Its blocks are the window-rounded
// halves of the wrapper (2*hrows*128 elements), which fix the values; the
// tiles need not follow them.
//
// The regime is kept.  The accumulator lives in device memory (the wrapper
// allocates it with torch.empty); each of the n-1 ring steps streams the
// accumulator's rows and the peer rank's rows through a double-buffered
// shared-memory window (cp.async: the next tile's loads are in flight while
// this tile folds), folds them and writes them back.  Step 0 reads the
// partial from x[b+s] itself and the last step writes `out`, so the
// accumulator is only touched for n >= 3.  Fold order and ring blocks are
// those of K3 (ring_common.cuh), so K3 and K4 give bit-identical results, as
// do K5 and K6.
//
// Bound on an H100: device-memory bytes.  The function needs
// (n+1)*size*sizeof(T) bytes, as K3 (K9 as K8); this regime moves
// 3*(n-1)*size*sizeof(T) (each step reads partial and peer and writes the
// partial), about 2.3x the bound at n=8 -- the price of bounded on-chip state, which buys nothing on
// one card.  It is kept as the TPU kernel stands, with its time recorded
// against the bound, for the crossover (vmem_max_bytes) to be decided on
// card numbers.  Each thread copies, folds and stores only its own 16 bytes
// of a tile, and walks the same tiles in every step, so no step needs a
// barrier across threads or blocks: one launch runs all n-1 steps.
#include "ring_common.cuh"

namespace otpu {

constexpr int kSegThreads = 256;

// global -> shared copy of one thread's VEC elements: cp.async for 4, 8 and
// 16 bytes; a 2-byte element (f16 off the aligned path) is copied directly.
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  constexpr int kBytes = sizeof(T) * VEC;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
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
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  return r;
}

template <typename T, int OP, int VEC, bool DUPLEX>
__global__ void __launch_bounds__(kSegThreads)
ring_seg_kernel(const T* __restrict__ x, T* acc, T* out, int64_t size,
                int64_t blk, int n, int start) {
  // [slot][0: partial, 1: peer][tile]
  __shared__ __align__(16) T win[2][2][kSegThreads * VEC];
  const int64_t tile = (int64_t)kSegThreads * VEC;
  const int64_t ntiles = (size + tile - 1) / tile;
  const int lane = threadIdx.x * VEC;

  for (int k = 0; k < n - 1; ++k) {
    // ring step k: block b's partial (x[b+start] at step 0, else acc) meets
    // the row of rank b+start+1+k, and goes to acc (or out at the last step)
    const T* part = (k == 0) ? x : acc;
    T* dst = (k == n - 2) ? out : acc;
    auto issue = [&](int64_t t, int slot) {
      const int64_t e = t * tile + lane;
      if (e < size) {
        const int b = (int)(e / blk);
        int peer = (b + start + 1 + k) % n;
        // a duplex block's second half walks left: b+start-1-k
        if constexpr (DUPLEX)
          if (e - (int64_t)b * blk >= blk / 2) peer = (b + start + n - 1 - k) % n;
        copy_async<T, VEC>(&win[slot][0][lane],
                           part + (k == 0 ? (int64_t)((b + start) % n) * size : 0) + e);
        copy_async<T, VEC>(&win[slot][1][lane], x + (int64_t)peer * size + e);
      }
    };
    int slot = 0;
    int64_t t = blockIdx.x;
    if (t < ntiles) issue(t, slot);
    copy_commit();
    for (; t < ntiles; t += gridDim.x) {
      const int64_t next = t + gridDim.x;
      if (next < ntiles) issue(next, slot ^ 1);
      copy_commit();
      copy_wait<1>();  // this thread's copies of tile t have landed
      const int64_t e = t * tile + lane;
      if (e < size) {
        Pack<T, VEC> p = load_shared<T, VEC>(&win[slot][0][lane]);
        fold_into<OP>(p, load_shared<T, VEC>(&win[slot][1][lane]));
        store<T, VEC>(dst + e, p);
      }
      slot ^= 1;
    }
    copy_wait<0>();
    // this step's accumulator stores precede the next step's copies of them
    __threadfence_block();
  }
}

template <typename T, int OP, int VEC>
struct SegLaunch {
  static void run(const void* x, void* acc, void* out, int64_t size,
                  int64_t blk, int n, int start, bool duplex, cudaStream_t stream) {
    const int64_t tile = (int64_t)kSegThreads * VEC;
    int64_t blocks = (size + tile - 1) / tile;
    const int64_t cap = (int64_t)sm_count() * 8;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    if (duplex) {
      ring_seg_kernel<T, OP, VEC, true><<<(unsigned)blocks, kSegThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(acc), static_cast<T*>(out),
          size, blk, n, start);
    } else {
      ring_seg_kernel<T, OP, VEC, false><<<(unsigned)blocks, kSegThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(acc), static_cast<T*>(out),
          size, blk, n, start);
    }
  }
};

inline int seg(const void* x, void* acc, void* out, long long size,
               long long blk, int n, int dtype, int op, int vec, int start,
               bool duplex, void* stream) {
  if (blk <= 0 || n < 1 || start < 0 || (duplex && blk % 2))
    return (int)cudaErrorInvalidValue;
  if (!dispatch<SegLaunch>(dtype, op, vec, x, acc, out, (int64_t)size,
                           (int64_t)blk, n, start, duplex,
                           static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace otpu

// x: (n, size), acc and out: (size,) device pointers.  size % vec == 0 and,
// with vec > 1, blk % vec == 0 and all pointers and the row pitch are 16-byte
// aligned (the wrapper checks).  Each returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown dtype/op/vec code or a block
// of no element).

// K4: all-reduce, blocks of blk = rows*128 elements, start offset 0.
extern "C" int otpu_ring_seg(const void* x, void* acc, void* out,
                             long long size, long long blk, int n, int dtype,
                             int op, int vec, void* stream) {
  return otpu::seg(x, acc, out, size, blk, n, dtype, op, vec, 0, false, stream);
}

// K6: reduce-scatter, x (n, n*blk) with blk = prod(S), start offset 1.
extern "C" int otpu_ring_rs_seg(const void* x, void* acc, void* out,
                                long long size, long long blk, int n,
                                int dtype, int op, int vec, void* stream) {
  return otpu::seg(x, acc, out, size, blk, n, dtype, op, vec, 1, false, stream);
}

// K9: K4 over duplex blocks of blk = 2*hrows*128 elements (hrows rounded to
// whole windows by the wrapper), start offset 0: the first half of each
// block walks right, the second left.  With vec > 1, blk/2 % vec == 0 as
// well (the wrapper checks).
extern "C" int otpu_ring_seg_bidi(const void* x, void* acc, void* out,
                                  long long size, long long blk, int n,
                                  int dtype, int op, int vec, void* stream) {
  return otpu::seg(x, acc, out, size, blk, n, dtype, op, vec, 0, true, stream);
}
