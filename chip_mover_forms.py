"""The byte mover's forms on one NVIDIA card, side by side.

    python3 chip_mover_forms.py

The mover of ``ompi_tpu_torch/csrc/pair_copy.cuh`` (K10, K11, K13-K16)
cuts the valid bytes into spans of about 32 KB that the CTAs (one a SM, one
warp each) take in stream order by atomic ticket, and moves each span with
TMA bulk copies through a ring of twelve 16 KB shared-memory slots, with no
L2 policy.  This script builds, beside the port's libraries, a library of the
other forms over the same span walk (``find_span``, ``walk_span``):

- the port's ticket kernel with other ring shapes, span lengths, two CTAs a
  SM, or an L2 evict-first policy;
- spans dealt round-robin instead (CTA b takes spans b, b + grid, ...), and
  one span a CTA (the form first designed), with and without the policy;
- a register form: 256 threads, each with 8 ``uint4`` loads in flight, the
  next chunk's loads issued before the current chunk's stores, on spans
  dealt round-robin, at two and at four CTAs a SM.

Each form is held byte for byte against the plain version, then timed as
``chip_smoke.time_ms`` times a kernel (cold L2 after a 256 MB zero fill,
median of 25) at the shapes of the kernel table: K10 (one pair of 8 x 16 MB
float32), K11 (8 pairs of 16 MB), K14 ((8, 8, 524288) float32) and K15 (the
MoE dispatch slab with its routing), beside ``x.clone()``; a few are timed
again after a read of 256 MB in place of the zero fill, which leaves no
dirty line in the L2.  K10 is timed at 8 x 64 MB too, and at 8 x 64 KB and
8 x 1 MB, where a fixed cost a call shows whole.  It also prints, for the port's built mover kernels,
the SASS opcodes that ``cuobjdump -sass`` lists and the ``-Xptxas -v``
lines.  Needs one card; with none it exits 1 and prints nothing on stdout.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

#: form -> (C code, CTAs a SM): slots x chunk of the bulk ring, how the
#: spans are taken and how long they are ("one span a CTA": spans dealt
#: round-robin, 2^40 bytes long), the L2 policy of the copies
FORMS = {"bulk 6x32KB, one span a CTA, evict_first": (0, 1),
         "bulk 6x32KB, one span a CTA, no policy": (1, 1),
         "bulk 6x32KB, 64 KB spans dealt, evict_first": (2, 1),
         "bulk 6x32KB, 64 KB spans dealt, evict_first loads": (3, 1),
         "bulk 6x32KB, 64 KB spans dealt, no policy": (4, 1),
         "bulk 6x32KB, 64 KB spans by ticket, evict_first": (5, 1),
         "bulk 6x32KB, 64 KB spans by ticket, no policy": (6, 1),
         "bulk 6x32KB, 32 KB spans by ticket, no policy": (7, 1),
         "bulk 6x32KB, 256 KB spans by ticket, no policy": (8, 1),
         "bulk 12x16KB, 16 KB spans by ticket, no policy": (9, 1),
         "bulk 8x16KB, 64 KB spans by ticket, no policy": (10, 1),
         "bulk 3x32KB 2/SM, 64 KB spans by ticket, no policy": (11, 2),
         "register 8 x uint4 2/SM, 64 KB spans dealt": (12, 2),
         "register 8 x uint4 4/SM, 64 KB spans dealt": (12, 4),
         "bulk 12x16KB, 32 KB spans by ticket, no policy (the port's)": (13, 1),
         "bulk 3x8KB, 64 KB spans by ticket, no policy": (14, 1),
         "bulk 24x8KB, 64 KB spans by ticket, no policy": (15, 1)}
#: timed again after a read flush, which leaves no dirty line in the L2
READ_FLUSHED = ("bulk 12x16KB, 32 KB spans by ticket, no policy (the port's)",
                "bulk 6x32KB, 64 KB spans dealt, no policy",
                "register 8 x uint4 4/SM, 64 KB spans dealt")

SOURCE = r'''
#include "pair_copy.cuh"

namespace otpu {

// the port's ring over spans dealt round-robin: CTA b takes b, b + grid, ...
template <int SLOT, int SLOTS, int CHUNK, int POLICY, int64_t SPAN>
__global__ void __launch_bounds__(32) dealt_kernel(PairCopy a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t total = stream_total<true>(a);
  const int64_t rounds = span_rounds<SPAN>(total);
  BulkRing<SLOTS, CHUNK, POLICY> ring(smem);
  if (threadIdx.x == 0) ring.init();
  for (int64_t k = 0; k < rounds; ++k) {
    const Span s = find_span<true>(a, total, blockIdx.x + k * gridDim.x, rounds * gridDim.x);
    if (threadIdx.x == 0)
      walk_span<SLOT, true>(a, s, CHUNK, [&](const uint8_t* src, uint8_t* dst, int64_t n) {
        ring.push(src, dst, (int)n);
      });
    __syncwarp();
  }
  if (threadIdx.x == 0) ring.drain();
  __syncwarp();
  copy_tails<SLOT>(a);
}

template <int SLOT, int SLOTS, int CHUNK, int POLICY, int64_t SPAN>
int launch_dealt(const PairCopy& a, unsigned grid, cudaStream_t s) {
  auto* kernel = dealt_kernel<SLOT, SLOTS, CHUNK, POLICY, SPAN>;
  constexpr int smem = BulkRing<SLOTS, CHUNK, POLICY>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

constexpr int kRegThreads = 256, kRegVecs = 8;   // 32 KB a chunk

template <int SLOT>
__global__ void __launch_bounds__(kRegThreads) register_kernel(PairCopy a) {
  const int64_t total = stream_total<true>(a);
  const int64_t rounds = span_rounds<65536>(total);
  uint4 cur[kRegVecs];
  uint8_t* cur_dst = nullptr;
  int64_t cur_n = 0;
  auto store = [&]() {
    uint4* dv = reinterpret_cast<uint4*>(cur_dst);
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const int64_t v = threadIdx.x + k * kRegThreads;
      if (v * 16 < cur_n) dv[v] = cur[k];
    }
  };
  for (int64_t r = 0; r < rounds; ++r) {
    const Span s = find_span<true>(a, total, blockIdx.x + r * gridDim.x, rounds * gridDim.x);
    walk_span<SLOT, true>(a, s, kRegThreads * kRegVecs * 16,
                          [&](const uint8_t* src, uint8_t* dst, int64_t n) {
      uint4 nxt[kRegVecs];
      const uint4* sv = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int k = 0; k < kRegVecs; ++k) {
        const int64_t v = threadIdx.x + k * kRegThreads;
        nxt[k] = v * 16 < n ? __ldg(sv + v) : make_uint4(0, 0, 0, 0);
      }
      if (cur_dst != nullptr) store();
#pragma unroll
      for (int k = 0; k < kRegVecs; ++k) cur[k] = nxt[k];
      cur_dst = dst;
      cur_n = n;
    });
  }
  if (cur_dst != nullptr) store();
  copy_tails<SLOT>(a);
}

template <int SLOT>
int run(const PairCopy& a, int form, int per_sm, cudaStream_t s) {
  constexpr int64_t kOne = int64_t(1) << 40;
  constexpr int kNone = L2_NONE, kFirst = L2_EVICT_FIRST, kLoads = L2_EVICT_FIRST_LOADS;
  const unsigned grid = mover_grid(a.pitch * a.pairs, per_sm);
  switch (form) {
    case 0: return launch_dealt<SLOT, 6, 32768, kFirst, kOne>(a, grid, s);
    case 1: return launch_dealt<SLOT, 6, 32768, kNone, kOne>(a, grid, s);
    case 2: return launch_dealt<SLOT, 6, 32768, kFirst, 65536>(a, grid, s);
    case 3: return launch_dealt<SLOT, 6, 32768, kLoads, 65536>(a, grid, s);
    case 4: return launch_dealt<SLOT, 6, 32768, kNone, 65536>(a, grid, s);
    case 5: return launch_mover<SLOT, 6, 32768, kFirst, 65536>(a, grid, s);
    case 6: return launch_mover<SLOT, 6, 32768, kNone, 65536>(a, grid, s);
    case 7: return launch_mover<SLOT, 6, 32768, kNone, 32768>(a, grid, s);
    case 8: return launch_mover<SLOT, 6, 32768, kNone, 262144>(a, grid, s);
    case 9: return launch_mover<SLOT, 12, 16384, kNone, 16384>(a, grid, s);
    case 10: return launch_mover<SLOT, 8, 16384, kNone, 65536>(a, grid, s);
    case 11: return launch_mover<SLOT, 3, 32768, kNone, 65536>(a, grid, s);
    case 12: register_kernel<SLOT><<<grid, kRegThreads, 0, s>>>(a); return (int)cudaGetLastError();
    case 13: return launch_mover<SLOT, 12, 16384, kNone, 32768>(a, grid, s);
    case 14: return launch_mover<SLOT, 3, 8192, kNone, 65536>(a, grid, s);
    case 15: return launch_mover<SLOT, 24, 8192, kNone, 65536>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace otpu

// slot 0: pair p into slot p (K10, K11); 2: the transpose (K14, K15)
extern "C" int forms_copy(const void* x, void* out, const void* counts, long long pitch,
                          long long row_bytes, int n, int pairs, int slot, int form,
                          int per_sm, void* stream) {
  const otpu::PairCopy a{static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
                         static_cast<const int32_t*>(counts), pitch, row_bytes, n, pairs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return slot == otpu::SLOT_TRANSPOSE ? otpu::run<otpu::SLOT_TRANSPOSE>(a, form, per_sm, s)
                                      : otpu::run<otpu::SLOT_SAME>(a, form, per_sm, s);
}
'''


def log(msg: str) -> None:
    print(msg, flush=True)


def build_forms():
    """The forms' library, built by nvcc with the port's flags into the
    port's build directory (named by a hash of its source and headers)."""
    from ompi_tpu_torch.ops import _build

    h = hashlib.sha1(SOURCE.encode() + " ".join(_build.NVCC_FLAGS).encode())
    for path in sorted(_build.CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    lib = _build.BUILD_DIR / f"libmover_forms-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / "mover_forms.cu"
        src.write_text(SOURCE)
        out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                              "-o", str(lib), str(src)], capture_output=True, text=True)
        log(json.dumps({"forms_ptxas": [line for line in out.stdout.splitlines()
                                        + out.stderr.splitlines()
                                        if "Used" in line or "spill" in line
                                        or "error" in line]}))
        if out.returncode != 0:
            raise RuntimeError(out.stderr)
    fn = ctypes.CDLL(str(lib)).forms_copy
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, LL, LL, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def read_flushed_ms(fn, reps: int = 25) -> float:
    """``chip_smoke.time_ms`` with a read of a 256 MB buffer in place of its
    zero fill before each call: the L2 then holds clean lines only, so the
    timed call pays no write-back of the flush's dirty lines."""
    import statistics

    from chip_smoke import SPIN_CYCLES, WARMUP

    flush = torch.ones(256 * (1 << 20) // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    for _ in range(WARMUP):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        torch.sum(flush, 0, out=sink)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def mover_sass() -> dict:
    """SASS opcode counts and ptxas lines of the port's mover kernels."""
    from ompi_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    report = {}
    for lib in ("ring_copy", "exchange"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        ops, name = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1) if "mover_kernel" in m.group(1) else None
                if name:
                    ops[name] = collections.Counter()
            elif name:
                m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
                if m:
                    ops[name][m.group(1)] += 1
        report[f"{lib} sass"] = {k: dict(v.most_common()) for k, v in ops.items()}
        report[f"{lib} ptxas"] = [line.strip() for line in
                                  (_build.BUILD_DIR / f"{lib}.log").read_text().splitlines()
                                  if "Used" in line or "spill" in line
                                  or "Compiling entry" in line]
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mover_forms: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import ring_collectives as rc

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True).stdout.strip())
    _build.build_all()
    forms = build_forms()
    log(json.dumps({"mover_build": mover_sass()}))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    big = cs.operands(torch.float32, (cs.N, 16 * cs.MB // 4), gen)
    a2a = cs.operands(torch.float32, (cs.N, cs.N, 524288), gen)
    moe, routed = cs.moe_slab(gen), cs.moe_counts()
    table = torch.as_tensor(routed, dtype=torch.int32, device="cuda")
    row = cs.HIDDEN * 4
    stream = torch.cuda.current_stream().cuda_stream
    # name: (x, entry arguments after x and out, plain result, valid counts,
    # the port's wrapper, bytes moved)
    nb = big.numel() * 4
    cases = {
        "K10 one pair, f32 8 x 16 MB": (big, (None, nb, 0, 1, 1, 0), big,
                                        None, lambda: rc.all_gather(big, cs.N), 2 * nb),
        "K11 8 pairs, f32 8 x 16 MB": (big, (None, nb // cs.N, 0, cs.N, cs.N, 0), big,
                                       None, lambda: rc.all_gather(big, cs.N, "bidi"),
                                       2 * nb),
        "K14 (8, 8, 524288) f32": (a2a, (None, 524288 * 4, 0, cs.N, cs.N * cs.N, 2),
                                   rc.all_to_all_plain(a2a, cs.N), None,
                                   lambda: rc.all_to_all(a2a, cs.N), 2 * a2a.numel() * 4),
        "K15 MoE slab, routing": (moe, (table.data_ptr(), cs.CAPACITY * row, row, cs.N,
                                        cs.N * cs.N, 2),
                                  rc.all_to_all_v_plain(moe, routed, cs.N), routed,
                                  lambda: rc.all_to_all_v(moe, routed, cs.N),
                                  2 * int(routed.sum()) * row),
    }
    rows = {}
    for case, (x, args, want, valid, port, nbytes) in cases.items():
        out = torch.empty_like(x)

        def call(code, per_sm, x=x, out=out, args=args):
            err = forms(x.data_ptr(), out.data_ptr(), *args, code, per_sm, stream)
            if err:
                raise RuntimeError(f"forms_copy {case} form {code}: CUDA error {err}")

        times = {"the port's wrapper": cs.time_ms(port), "x.clone()": cs.time_ms(x.clone)}
        for form, (code, per_sm) in FORMS.items():
            out.fill_(0)
            call(code, per_sm)
            torch.cuda.synchronize()
            if valid is None:
                cs.same_bytes(out, want, f"{case} {form}")
            else:
                cs.same_valid_bytes(out, want, valid, f"{case} {form}")
            times[form] = cs.time_ms(lambda c=code, p=per_sm: call(c, p))
        times["read flush"] = {"the port's wrapper": read_flushed_ms(port),
                               "x.clone()": read_flushed_ms(x.clone)}
        for form in READ_FLUSHED:
            code, per_sm = FORMS[form]
            times["read flush"][form] = read_flushed_ms(
                lambda c=code, p=per_sm: call(c, p))
        times["bound"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        rows[case] = times
        log(json.dumps({"mover_forms_ms": {case: times}}))
        del out
    # four times the bytes: whether the gap to x.clone() is a time per call
    # or a rate
    del moe, a2a
    huge = cs.operands(torch.float32, (cs.N, 64 * cs.MB // 4), gen)
    cs.same_bytes(rc.all_gather(huge, cs.N), huge, "K10 8 x 64 MB")
    rows["K10 one pair, f32 8 x 64 MB"] = {
        "the port's wrapper": cs.time_ms(lambda: rc.all_gather(huge, cs.N)),
        "x.clone()": cs.time_ms(huge.clone),
        "bound": 2 * huge.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3}
    # small copies, where a fixed cost a call shows whole: the port's form,
    # a form with 24 KB of shared memory and the register form (none)
    for per_rank in (64 * 1024, 1 << 20):
        small = cs.operands(torch.float32, (cs.N, per_rank // 4), gen)
        out = torch.empty_like(small)
        args = (None, small.numel() * 4, 0, 1, 1, 0)

        def call(code, per_sm, small=small, out=out, args=args):
            err = forms(small.data_ptr(), out.data_ptr(), *args, code, per_sm, stream)
            if err:
                raise RuntimeError(f"forms_copy small form {code}: CUDA error {err}")

        times = {"the port's wrapper": cs.time_ms(lambda: rc.all_gather(small, cs.N)),
                 "x.clone()": cs.time_ms(small.clone)}
        for form in ("bulk 3x8KB, 64 KB spans by ticket, no policy",
                     "register 8 x uint4 4/SM, 64 KB spans dealt"):
            code, per_sm = FORMS[form]
            call(code, per_sm)
            torch.cuda.synchronize()
            cs.same_bytes(out, small, f"small {per_rank} {form}")
            times[form] = cs.time_ms(lambda c=code, p=per_sm: call(c, p))
        rows[f"K10 one pair, f32 8 x {per_rank >> 10} KB"] = times
    log(json.dumps({"mover_forms_ms": rows, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
