// otpu_native — C++ twins of the hot host-path loops.
//
// Copy of ompi_tpu/native/otpu_native.cc, the JAX package's native core;
// only these comments name the port's files.
//
// The reference implements these in C for the same reason (the datatype
// pack engine `opal/datatype/opal_datatype_pack.c` and the sm fifo
// `opal/class/opal_fifo.h`): per-element gather/scatter and ring ops are
// tight loops the interpreter cannot keep up with.  The Python layers
// (ompi_tpu_torch/datatype/convertor.py, ompi_tpu_torch/mca/btl/sm.py) call these
// through ctypes when the shared library is available and fall back to
// their numpy implementations otherwise.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread otpu_native.cc
//        -o libotpu_native.so
// (driven lazily by ompi_tpu_torch/native/__init__.py, which builds into
// ompi_tpu_torch/build/; -pthread is required
// by the worker pool's std::thread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#ifdef __linux__
#include <cerrno>
#include <pthread.h>
#include <sched.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>
#endif

extern "C" {

// ---- datatype engine: whole-element gather/scatter ---------------------
//
// Stream layout: element e of the datatype contributes its segments in
// type-map order; segment j lives at base_offset + e*extent + seg_off[j]
// in memory and occupies seg_len[j] bytes of the packed stream.

int64_t otpu_pack_elems(const uint8_t *base, uint8_t *out,
                        const int64_t *seg_off, const int64_t *seg_len,
                        int64_t nseg, int64_t extent, int64_t base_offset,
                        int64_t first_elem, int64_t nelem) {
    uint8_t *dst = out;
    for (int64_t e = first_elem; e < first_elem + nelem; ++e) {
        const uint8_t *ebase = base + base_offset + e * extent;
        for (int64_t j = 0; j < nseg; ++j) {
            std::memcpy(dst, ebase + seg_off[j], (size_t)seg_len[j]);
            dst += seg_len[j];
        }
    }
    return dst - out;
}

int64_t otpu_unpack_elems(uint8_t *base, const uint8_t *in,
                          const int64_t *seg_off, const int64_t *seg_len,
                          int64_t nseg, int64_t extent, int64_t base_offset,
                          int64_t first_elem, int64_t nelem) {
    const uint8_t *src = in;
    for (int64_t e = first_elem; e < first_elem + nelem; ++e) {
        uint8_t *ebase = base + base_offset + e * extent;
        for (int64_t j = 0; j < nseg; ++j) {
            std::memcpy(ebase + seg_off[j], src, (size_t)seg_len[j]);
            src += seg_len[j];
        }
    }
    return src - in;
}

// ---- btl/sm: SPSC byte ring -------------------------------------------
//
// Layout (matches ompi_tpu_torch/mca/btl/sm.py `_Ring`):
//   [ head u64 | tail u64 | data[cap] ]
// frames are <u32 length><payload>, wrapping modulo cap.  Single producer
// advances tail, single consumer advances head (acquire/release pairs —
// the property the reference's opal_fifo gets from its atomics).

static inline uint64_t load_acq(const uint8_t *p) {
    return __atomic_load_n((const uint64_t *)p, __ATOMIC_ACQUIRE);
}
static inline void store_rel(uint8_t *p, uint64_t v) {
    __atomic_store_n((uint64_t *)p, v, __ATOMIC_RELEASE);
}

static void ring_write(uint8_t *data, uint64_t cap, uint64_t pos,
                       const uint8_t *src, uint64_t n) {
    uint64_t p = pos % cap;
    uint64_t first = n < cap - p ? n : cap - p;
    std::memcpy(data + p, src, (size_t)first);
    if (first < n)
        std::memcpy(data, src + first, (size_t)(n - first));
}

int otpu_ring_push(uint8_t *buf, uint64_t cap, const uint8_t *payload,
                   uint64_t n) {
    uint64_t head = load_acq(buf);
    uint64_t tail = load_acq(buf + 8);
    uint64_t need = 4 + n;
    if (need > cap - (tail - head))
        return 0;
    uint8_t *data = buf + 16;
    uint32_t len32 = (uint32_t)n;
    ring_write(data, cap, tail, (const uint8_t *)&len32, 4);
    ring_write(data, cap, tail + 4, payload, n);
    store_rel(buf + 8, tail + need);
    return 1;
}

// Gather-push: one frame from two source buffers (header + payload),
// written back-to-back so the caller never has to concatenate them in
// Python (the concatenation would copy the payload an extra time).
int otpu_ring_push2(uint8_t *buf, uint64_t cap,
                    const uint8_t *a, uint64_t alen,
                    const uint8_t *b, uint64_t blen) {
    uint64_t head = load_acq(buf);
    uint64_t tail = load_acq(buf + 8);
    uint64_t n = alen + blen;
    if (4 + n > cap - (tail - head))
        return 0;
    uint8_t *data = buf + 16;
    uint32_t len32 = (uint32_t)n;
    ring_write(data, cap, tail, (const uint8_t *)&len32, 4);
    ring_write(data, cap, tail + 4, a, alen);
    ring_write(data, cap, tail + 4 + alen, b, blen);
    store_rel(buf + 8, tail + 4 + n);
    return 1;
}

// Length of the next complete frame, or -1 when none is ready — lets the
// consumer allocate an exact-size owned buffer before popping (so frame
// payloads can be delivered as zero-copy views of that buffer).
int64_t otpu_ring_peek_len(const uint8_t *buf, uint64_t cap) {
    uint64_t head = load_acq(buf);
    uint64_t tail = load_acq(buf + 8);
    if (tail - head < 4)
        return -1;
    const uint8_t *data = buf + 16;
    uint32_t len32;
    uint64_t p = head % cap;
    uint8_t tmp[4];
    uint64_t first = 4 < cap - p ? 4 : cap - p;
    std::memcpy(tmp, data + p, (size_t)first);
    if (first < 4)
        std::memcpy(tmp + first, data, (size_t)(4 - first));
    std::memcpy(&len32, tmp, 4);
    uint64_t n = len32;
    if (tail - head < 4 + n)
        return -1;          // producer mid-frame
    return (int64_t)n;
}

int64_t otpu_ring_pop(uint8_t *buf, uint64_t cap, uint8_t *out,
                      uint64_t out_cap) {
    uint64_t head = load_acq(buf);
    uint64_t tail = load_acq(buf + 8);
    if (tail - head < 4)
        return -1;
    const uint8_t *data = buf + 16;
    uint32_t len32;
    {   // read the length header (may wrap)
        uint64_t p = head % cap;
        uint8_t tmp[4];
        uint64_t first = 4 < cap - p ? 4 : cap - p;
        std::memcpy(tmp, data + p, (size_t)first);
        if (first < 4)
            std::memcpy(tmp + first, data, (size_t)(4 - first));
        std::memcpy(&len32, tmp, 4);
    }
    uint64_t n = len32;
    if (tail - head < 4 + n)
        return -1;          // producer mid-frame
    if (n > out_cap)
        return -2;          // caller buffer too small
    {   // read the payload (may wrap)
        uint64_t p = (head + 4) % cap;
        uint64_t first = n < cap - p ? n : cap - p;
        std::memcpy(out, data + p, (size_t)first);
        if (first < n)
            std::memcpy(out + first, data, (size_t)(n - first));
    }
    store_rel(buf, head + 4 + n);
    return (int64_t)n;
}

// ---- osc/rdma: cross-process atomics on mapped windows ------------------
//
// The reference's osc/rdma implements locks and accumulates via remote
// atomic CAS over the BTL (`osc_rdma_accumulate.c:26-71`).  On a same-host
// mapped window the "remote" atomic is a plain shared-memory atomic; the
// lock word lives in the window segment header.  Layout of the lock word:
// bit 63 = exclusive held, bits 0..62 = shared-reader count.

static const uint64_t EXCL_BIT = 1ull << 63;

int otpu_lock_excl_try(uint8_t *word) {
    uint64_t expected = 0;
    return __atomic_compare_exchange_n(
        (uint64_t *)word, &expected, EXCL_BIT, false,
        __ATOMIC_ACQUIRE, __ATOMIC_RELAXED) ? 1 : 0;
}

void otpu_lock_excl_release(uint8_t *word) {
    __atomic_store_n((uint64_t *)word, 0, __ATOMIC_RELEASE);
}

int otpu_lock_shared_try(uint8_t *word) {
    uint64_t cur = __atomic_load_n((uint64_t *)word, __ATOMIC_RELAXED);
    while (!(cur & EXCL_BIT)) {
        if (__atomic_compare_exchange_n(
                (uint64_t *)word, &cur, cur + 1, false,
                __ATOMIC_ACQUIRE, __ATOMIC_RELAXED))
            return 1;
        // cur reloaded by the failed CAS; loop unless exclusive appeared
    }
    return 0;
}

void otpu_lock_shared_release(uint8_t *word) {
    __atomic_fetch_sub((uint64_t *)word, 1, __ATOMIC_RELEASE);
}

int64_t otpu_atomic_add_i64(uint8_t *ptr, int64_t delta) {
    return __atomic_fetch_add((int64_t *)ptr, delta, __ATOMIC_ACQ_REL);
}

// returns the OLD value; *ok set to 1 when the swap happened
int64_t otpu_atomic_cas_i64(uint8_t *ptr, int64_t expected, int64_t desired,
                            int32_t *ok) {
    int64_t exp = expected;
    int swapped = __atomic_compare_exchange_n(
        (int64_t *)ptr, &exp, desired, false,
        __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE);
    *ok = swapped ? 1 : 0;
    return exp;  // old value on failure, `expected` (== old) on success
}

uint64_t otpu_atomic_load_u64(const uint8_t *ptr) {
    return __atomic_load_n((const uint64_t *)ptr, __ATOMIC_ACQUIRE);
}

void otpu_atomic_store_u64(uint8_t *ptr, uint64_t v) {
    __atomic_store_n((uint64_t *)ptr, v, __ATOMIC_RELEASE);
}

// ---- threads: native worker pool ---------------------------------------
//
// The reference's threading substrate (`opal/mca/threads/threads.h`) gives
// the host data path real OS threads — progress, packing, and reduction
// math run concurrently with the application.  A Python framework cannot
// get that from `threading` (the GIL serialises it), so the pool lives
// here: jobs are split into per-worker chunks of pure C++ (memcpy, the
// datatype element loops above, elementwise reduction math), ctypes drops
// the GIL for the submitting call, and the workers never touch Python.
// One job -> one ticket; a ticket completes when every chunk ran.

}  // extern "C" (the pool internals below are C++; the API re-opens it)

namespace {

struct OtpuTicket {
    std::atomic<int64_t> remaining;
    std::mutex m;
    std::condition_variable cv;
    explicit OtpuTicket(int64_t n) : remaining(n) {}
};

struct OtpuChunk {
    int32_t kind;            // 0 memcpy, 1 pack, 2 unpack, 3 reduce
    OtpuTicket *ticket;
    uint8_t *dst;
    const uint8_t *src;
    int64_t n;
    int32_t op, dtype;       // reduce: op 0 sum 1 prod 2 max 3 min;
                             // dtype 0 f32 1 f64 2 i32 3 i64
    const int64_t *seg_off, *seg_len;
    int64_t nseg, extent, base_offset, first_elem, nelem;
};

template <typename T>
static void reduce_span(T *acc, const T *src, int64_t count, int32_t op) {
    // max/min match np.maximum/np.minimum exactly, including NaN
    // propagation from EITHER operand (src!=src catches a NaN src; a
    // NaN acc keeps itself because 'acc < NaN' is false) — the
    // sub-threshold numpy path and the python substrate must be
    // bit-interchangeable with this one.  For integers x!=x is
    // constant-false and folds away.
    switch (op) {
    case 0: for (int64_t i = 0; i < count; ++i) acc[i] += src[i]; break;
    case 1: for (int64_t i = 0; i < count; ++i) acc[i] *= src[i]; break;
    case 2: for (int64_t i = 0; i < count; ++i)
                acc[i] = (src[i] != src[i] || acc[i] < src[i])
                             ? src[i] : acc[i];
            break;
    default: for (int64_t i = 0; i < count; ++i)
                acc[i] = (src[i] != src[i] || src[i] < acc[i])
                             ? src[i] : acc[i];
    }
}

static void run_chunk(const OtpuChunk &c) {
    switch (c.kind) {
    case 0:
        std::memcpy(c.dst, c.src, (size_t)c.n);
        break;
    case 1:
        otpu_pack_elems(c.src, c.dst, c.seg_off, c.seg_len, c.nseg,
                        c.extent, c.base_offset, c.first_elem, c.nelem);
        break;
    case 2:
        otpu_unpack_elems(c.dst, c.src, c.seg_off, c.seg_len, c.nseg,
                          c.extent, c.base_offset, c.first_elem, c.nelem);
        break;
    default:
        switch (c.dtype) {
        case 0: reduce_span((float *)c.dst, (const float *)c.src,
                            c.n, c.op); break;
        case 1: reduce_span((double *)c.dst, (const double *)c.src,
                            c.n, c.op); break;
        case 2: reduce_span((int32_t *)c.dst, (const int32_t *)c.src,
                            c.n, c.op); break;
        default: reduce_span((int64_t *)c.dst, (const int64_t *)c.src,
                             c.n, c.op);
        }
    }
}

struct OtpuPool {
    std::vector<std::thread> workers;
    std::deque<OtpuChunk> queue;
    std::mutex m;
    std::condition_variable cv;
    bool stop = false;

    explicit OtpuPool(int32_t n) {
        for (int32_t i = 0; i < n; ++i)
            workers.emplace_back([this] { loop(); });
    }

    void loop() {
        for (;;) {
            OtpuChunk c;
            {
                std::unique_lock<std::mutex> lk(m);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (queue.empty())
                    return;            // stop && drained
                c = queue.front();
                queue.pop_front();
            }
            run_chunk(c);
            {
                // decrement under the ticket mutex: a waiter holding it
                // cannot observe remaining==0 and free the ticket while
                // this worker is still about to touch it
                std::lock_guard<std::mutex> lk(c.ticket->m);
                if (c.ticket->remaining.fetch_sub(
                        1, std::memory_order_acq_rel) == 1)
                    c.ticket->cv.notify_all();
            }
        }
    }

    OtpuTicket *submit(std::vector<OtpuChunk> &chunks) {
        OtpuTicket *t = new OtpuTicket((int64_t)chunks.size());
        {
            std::lock_guard<std::mutex> lk(m);
            for (auto &c : chunks) {
                c.ticket = t;
                queue.push_back(c);
            }
        }
        cv.notify_all();
        return t;
    }
};

}  // namespace

extern "C" {

int64_t otpu_pool_create(int32_t nthreads) {
    if (nthreads < 1)
        nthreads = 1;
    return (int64_t)(intptr_t) new OtpuPool(nthreads);
}

void otpu_pool_destroy(int64_t pool) {
    OtpuPool *p = (OtpuPool *)(intptr_t)pool;
    {
        std::lock_guard<std::mutex> lk(p->m);
        p->stop = true;
    }
    p->cv.notify_all();
    for (auto &w : p->workers)
        w.join();
    delete p;
}

int32_t otpu_pool_size(int64_t pool) {
    return (int32_t)((OtpuPool *)(intptr_t)pool)->workers.size();
}

// Split [0, n) into per-worker spans of at least `grain` units.
static std::vector<std::pair<int64_t, int64_t>> spans(
        int64_t n, int64_t nworkers, int64_t grain) {
    int64_t pieces = n / grain;
    if (pieces > nworkers) pieces = nworkers;
    if (pieces < 1) pieces = 1;
    std::vector<std::pair<int64_t, int64_t>> out;
    int64_t per = n / pieces, rem = n % pieces, at = 0;
    for (int64_t i = 0; i < pieces; ++i) {
        int64_t len = per + (i < rem ? 1 : 0);
        out.emplace_back(at, len);
        at += len;
    }
    return out;
}

int64_t otpu_pool_memcpy(int64_t pool, uint8_t *dst, const uint8_t *src,
                         int64_t n) {
    OtpuPool *p = (OtpuPool *)(intptr_t)pool;
    std::vector<OtpuChunk> cs;
    for (auto &sp : spans(n, (int64_t)p->workers.size(), 1 << 16)) {
        OtpuChunk c{};
        c.kind = 0;
        c.dst = dst + sp.first;
        c.src = src + sp.first;
        c.n = sp.second;
        cs.push_back(c);
    }
    return (int64_t)(intptr_t)p->submit(cs);
}

int64_t otpu_pool_reduce(int64_t pool, int32_t op, int32_t dtype,
                         uint8_t *acc, const uint8_t *src, int64_t count) {
    OtpuPool *p = (OtpuPool *)(intptr_t)pool;
    int64_t esz = (dtype == 0 || dtype == 2) ? 4 : 8;
    std::vector<OtpuChunk> cs;
    for (auto &sp : spans(count, (int64_t)p->workers.size(), 1 << 14)) {
        OtpuChunk c{};
        c.kind = 3;
        c.op = op;
        c.dtype = dtype;
        c.dst = acc + sp.first * esz;
        c.src = src + sp.first * esz;
        c.n = sp.second;
        cs.push_back(c);
    }
    return (int64_t)(intptr_t)p->submit(cs);
}

static int64_t pool_packish(int64_t pool, int32_t kind, uint8_t *mem,
                            uint8_t *stream, const int64_t *seg_off,
                            const int64_t *seg_len, int64_t nseg,
                            int64_t extent, int64_t base_offset,
                            int64_t first_elem, int64_t nelem) {
    OtpuPool *p = (OtpuPool *)(intptr_t)pool;
    int64_t elem_packed = 0;
    for (int64_t j = 0; j < nseg; ++j)
        elem_packed += seg_len[j];
    std::vector<OtpuChunk> cs;
    for (auto &sp : spans(nelem, (int64_t)p->workers.size(), 64)) {
        OtpuChunk c{};
        c.kind = kind;
        uint8_t *schunk = stream + sp.first * elem_packed;
        if (kind == 1) {               // pack: mem -> stream
            c.src = mem;
            c.dst = schunk;
        } else {                       // unpack: stream -> mem
            c.dst = mem;
            c.src = schunk;
        }
        c.seg_off = seg_off;
        c.seg_len = seg_len;
        c.nseg = nseg;
        c.extent = extent;
        c.base_offset = base_offset;
        c.first_elem = first_elem + sp.first;
        c.nelem = sp.second;
        cs.push_back(c);
    }
    return (int64_t)(intptr_t)p->submit(cs);
}

int64_t otpu_pool_pack(int64_t pool, uint8_t *mem, uint8_t *out,
                       const int64_t *seg_off, const int64_t *seg_len,
                       int64_t nseg, int64_t extent, int64_t base_offset,
                       int64_t first_elem, int64_t nelem) {
    return pool_packish(pool, 1, mem, out, seg_off, seg_len, nseg, extent,
                        base_offset, first_elem, nelem);
}

int64_t otpu_pool_unpack(int64_t pool, uint8_t *mem, uint8_t *in,
                         const int64_t *seg_off, const int64_t *seg_len,
                         int64_t nseg, int64_t extent, int64_t base_offset,
                         int64_t first_elem, int64_t nelem) {
    return pool_packish(pool, 2, mem, in, seg_off, seg_len, nseg, extent,
                        base_offset, first_elem, nelem);
}

int32_t otpu_pool_test(int64_t ticket) {
    OtpuTicket *t = (OtpuTicket *)(intptr_t)ticket;
    return t->remaining.load(std::memory_order_acquire) == 0 ? 1 : 0;
}

// Blocks until done, then frees the ticket (call exactly once).
void otpu_pool_wait(int64_t ticket) {
    OtpuTicket *t = (OtpuTicket *)(intptr_t)ticket;
    {
        std::unique_lock<std::mutex> lk(t->m);
        t->cv.wait(lk, [t] {
            return t->remaining.load(std::memory_order_acquire) == 0;
        });
    }
    delete t;
}

}  // extern "C"

// ---- runtime/progress: the native reactor -------------------------------
//
// An epoll loop over the btl fds that runs the tcp hot path — socket
// drain (recv into scratch), wire framing ([u32 frame_len][frame]),
// split-tail reassembly, and header-type lane routing — on a dedicated
// OS thread with no GIL anywhere near it.  Completed frames land in a
// lock-free SPSC record queue the Python side empties with ONE ctypes
// call per progress() tick (otpu_reactor_drain).  The reference analog
// is opal_progress driving libevent: the event loop lives below the
// language runtime and the upper layer only sees completed work.
//
// Record stream layout (little-endian, matches runtime/reactor.py):
//   record  := [u32 payload_len][i32 fd][u8 etype][payload]
//   etype 0 := RAW      whole frame (htype byte onward) — the Python
//                       slow lane (_parse_frame): pickle headers,
//                       crc-armed frames, quantized frames, handshakes
//   etype 1 := FAST     frame bytes after the htype byte: the 49-byte
//                       big-endian !IIIiqBqqq header + payload, ready
//                       for the preallocated struct unpack
//   etype 2 := EOF      peer closed / hard error (fd already out of
//                       the epoll set; Python closes + drops the conn)
//   etype 3 := ACCEPT   notify-mode fd readable (listener; ONESHOT —
//                       Python accepts, then otpu_reactor_rearm)
//   etype 4 := WRITABLE backpressured fd turned writable (EPOLLOUT
//                       interest auto-cleared; Python flushes and
//                       re-arms while its queue is non-empty)
//   etype 5 := DOORBELL drain-mode dgram fd rang (datagrams consumed
//                       here; the ring frames carry the data)
//   etype 6 := OVERSIZE payload = u64 frame_len: a frame too large for
//                       the record queue is parked in the stream, the
//                       fd leaves the epoll set, and Python fetches it
//                       with otpu_reactor_take_oversize (which resumes
//                       the stream)
//   etype 7 := DESYNC   payload = u64 bad frame_len: framing desync
//                       (zero-length frame) — Python fails loudly
//
// The queue is the SPSC ring above (single producer: the reactor
// thread; single consumer: whichever Python thread runs progress(),
// serialised by the drain lock on that side).  When the ring is
// momentarily full the producer NEVER blocks — it appends to a small
// mutex-guarded overflow list instead (and keeps appending there until
// the consumer empties it, which preserves global record order).
// Blocking with the stream-map mutex held would deadlock against a
// Python thread doing fd bookkeeping while it drains.

#ifdef __linux__

namespace {

enum {
    REC_RAW = 0, REC_FAST = 1, REC_EOF = 2, REC_ACCEPT = 3,
    REC_WRITABLE = 4, REC_DOORBELL = 5, REC_OVERSIZE = 6, REC_DESYNC = 7,
};

constexpr size_t REC_HDR = 9;          // u32 len + i32 fd + u8 etype
constexpr size_t RX_SCRATCH = 1 << 18; // one recv's worth, like _Conn

static inline uint32_t load_be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

struct RStream {
    int fd = -1;
    int mode = 0;          // 0 stream, 1 notify (oneshot), 2 drain-dgram
    bool dead = false;     // EOF/desync emitted; ignore further events
    bool parked = false;   // oversize frame held; fd out of the epoll set
    bool want_write = false;
    std::vector<uint8_t> pend;     // partial tail: [u32 len][bytes so far]
    std::vector<uint8_t> carry;    // unparsed input arriving while parked
    std::vector<uint8_t> oversize; // the parked frame (htype onward)
};

struct Reactor {
    int epfd = -1;
    int wakefd = -1;       // reactor-thread pokes (stop / resume)
    int notifyfd = -1;     // consumer wakeups (drain clears it)
    int waitfd = -1;       // selectable OR of {epfd, notifyfd}: the fd
                           // Python registers as the progress waiter —
                           // an idle consumer wakes on RAW socket
                           // readiness (then pumps inline) instead of
                           // waiting out a reactor-thread scheduling
                           // hop on an oversubscribed host
    uint64_t ring_cap;
    uint64_t oversize_limit;
    std::vector<uint8_t> ring;     // [head u64 | tail u64 | data] layout
    std::mutex ov_m;
    std::deque<std::vector<uint8_t>> overflow;
    std::atomic<bool> has_overflow{false};  // mirror of !overflow.empty()
    std::mutex m;                  // stream map + cross-thread fd flags
    std::unordered_map<int, RStream *> streams;
    std::vector<int> resume_fds;   // taken by the reactor thread under m
    std::atomic<bool> stop{false};
    std::thread thr;
    uint8_t scratch[RX_SCRATCH];
    // counters (written under R->m, racy reads are fine)
    uint64_t n_frames_fast = 0, n_frames_raw = 0, n_records = 0;
    uint64_t n_overflow = 0, n_wakeups = 0, n_pumps = 0;
};

static void reactor_loop(Reactor *R);

static inline uint8_t *rq_base(Reactor *R) { return R->ring.data(); }

static void notify_consumer(Reactor *R) {
    uint64_t one = 1;
    ssize_t r = ::write(R->notifyfd, &one, 8);
    (void)r;               // EAGAIN: counter already non-zero, still wakes
    R->n_wakeups++;
}

// Append one record (header + up to two payload parts) to the queue.
// Producer side is whichever thread holds R->m (the reactor thread, or
// the consumer thread inside pump()) — serialisation by R->m keeps the
// ring single-producer.  Never blocks: ring when it fits, overflow
// otherwise — and always overflow while overflow is non-empty, so the
// consumer's ring-then-overflow drain order preserves arrival order.
static void emit(Reactor *R, int fd, uint8_t etype,
                 const uint8_t *a, uint64_t alen,
                 const uint8_t *b, uint64_t blen) {
    uint8_t *buf = rq_base(R);
    uint64_t head = load_acq(buf);
    uint64_t tail = load_acq(buf + 8);
    bool was_empty;
    uint64_t plen = alen + blen;
    uint8_t hdr[REC_HDR];
    uint32_t plen32 = (uint32_t)plen;
    int32_t fd32 = (int32_t)fd;
    std::memcpy(hdr, &plen32, 4);
    std::memcpy(hdr + 4, &fd32, 4);
    hdr[8] = etype;
    {
        std::lock_guard<std::mutex> lk(R->ov_m);
        was_empty = (head == tail) && R->overflow.empty();
        if (!R->overflow.empty() ||
            REC_HDR + plen > R->ring_cap - (tail - head)) {
            std::vector<uint8_t> rec;
            rec.reserve(REC_HDR + plen);
            rec.insert(rec.end(), hdr, hdr + REC_HDR);
            if (alen) rec.insert(rec.end(), a, a + alen);
            if (blen) rec.insert(rec.end(), b, b + blen);
            R->overflow.push_back(std::move(rec));
            R->has_overflow.store(true, std::memory_order_release);
            R->n_overflow++;
        } else {
            uint8_t *data = buf + 16;
            ring_write(data, R->ring_cap, tail, hdr, REC_HDR);
            if (alen)
                ring_write(data, R->ring_cap, tail + REC_HDR, a, alen);
            if (blen)
                ring_write(data, R->ring_cap, tail + REC_HDR + alen,
                           b, blen);
            store_rel(buf + 8, tail + REC_HDR + plen);
        }
    }
    R->n_records++;
    if (was_empty)
        notify_consumer(R);
}

static void epoll_del_quiet(Reactor *R, RStream *s) {
    struct epoll_event ev {};
    ::epoll_ctl(R->epfd, EPOLL_CTL_DEL, s->fd, &ev);
}

static void stream_eof(Reactor *R, RStream *s) {
    if (s->dead)
        return;
    s->dead = true;
    if (!s->parked)
        epoll_del_quiet(R, s);
    emit(R, s->fd, REC_EOF, nullptr, 0, nullptr, 0);
}

// Route one complete frame (htype byte onward).  Returns false when the
// frame was parked (oversize) and parsing of this stream must pause.
static bool handle_frame(Reactor *R, RStream *s, const uint8_t *f,
                         uint64_t fl) {
    if (REC_HDR + fl + 64 > R->oversize_limit) {
        s->oversize.assign(f, f + fl);
        s->parked = true;
        epoll_del_quiet(R, s);
        uint64_t n = fl;
        emit(R, s->fd, REC_OVERSIZE, (const uint8_t *)&n, 8, nullptr, 0);
        return false;
    }
    // lane routing by header-type byte: ONLY the plain fast header
    // (htype == 1, no crc/quant bits) with a sane kind code takes the
    // native lane; everything else goes to Python whole so the slow
    // lane (crc verify, quant decode, pickle, handshake) sees the
    // exact bytes the pure-Python parser would have
    if (f[0] == 1 && fl >= 50 && f[25] <= 5) {
        emit(R, s->fd, REC_FAST, f + 1, fl - 1, nullptr, 0);
        R->n_frames_fast++;
    } else {
        emit(R, s->fd, REC_RAW, f, fl, nullptr, 0);
        R->n_frames_raw++;
    }
    return true;
}

// Bytes still missing before the parked partial frame completes
// (the Python twin is TcpBtl._need).
static uint64_t pend_need(const RStream *s) {
    if (s->pend.size() < 4)
        return 4 - s->pend.size();
    uint64_t fl = load_be32(s->pend.data());
    uint64_t have = s->pend.size();
    return have >= 4 + fl ? 0 : 4 + fl - have;
}

// The framing/reassembly twin of TcpBtl._on_bytes: finish the parked
// split tail first, then parse complete frames straight from the
// chunk, then park whatever partial tail remains.
static void stream_feed(Reactor *R, RStream *s, const uint8_t *p,
                        uint64_t n) {
    uint64_t pos = 0;
    while (!s->pend.empty() && !s->parked && !s->dead) {
        uint64_t need = pend_need(s);
        uint64_t take = need < n - pos ? need : n - pos;
        if (take) {
            s->pend.insert(s->pend.end(), p + pos, p + pos + take);
            pos += take;
        }
        if (pend_need(s) == 0) {
            uint64_t fl = load_be32(s->pend.data());
            if (fl == 0) {
                uint64_t bad = 0;
                emit(R, s->fd, REC_DESYNC,
                     (const uint8_t *)&bad, 8, nullptr, 0);
                s->dead = true;
                epoll_del_quiet(R, s);
                return;
            }
            bool go = handle_frame(R, s, s->pend.data() + 4, fl);
            s->pend.clear();
            if (!go)
                break;          // parked: rest of the chunk -> carry
        } else if (pos >= n) {
            return;             // chunk exhausted mid-frame
        }
    }
    while (!s->parked && !s->dead && n - pos >= 4) {
        uint64_t fl = load_be32(p + pos);
        if (fl == 0) {
            uint64_t bad = 0;
            emit(R, s->fd, REC_DESYNC,
                 (const uint8_t *)&bad, 8, nullptr, 0);
            s->dead = true;
            epoll_del_quiet(R, s);
            return;
        }
        if (n - pos < 4 + fl)
            break;
        if (!handle_frame(R, s, p + pos + 4, fl)) {
            pos += 4 + fl;
            break;              // parked mid-chunk
        }
        pos += 4 + fl;
    }
    if (pos < n && !s->dead) {
        std::vector<uint8_t> &dst = s->parked ? s->carry : s->pend;
        dst.insert(dst.end(), p + pos, p + n);
    }
}

static void stream_readable(Reactor *R, RStream *s) {
    for (;;) {
        ssize_t r = ::recv(s->fd, R->scratch, RX_SCRATCH, 0);
        if (r > 0) {
            stream_feed(R, s, R->scratch, (uint64_t)r);
            if (s->dead || s->parked)
                return;
            if ((size_t)r < RX_SCRATCH)
                return;         // drained (level-triggered: safe anyway)
        } else if (r == 0) {
            stream_eof(R, s);
            return;
        } else {
            if (errno == EINTR)
                continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK)
                return;
            stream_eof(R, s);
            return;
        }
    }
}

static void drain_dgrams(Reactor *, RStream *s) {
    uint8_t sink[512];
    for (;;) {
        ssize_t r = ::recv(s->fd, sink, sizeof(sink), 0);
        if (r < 0) {
            if (errno == EINTR)
                continue;
            return;             // EAGAIN or hard error: edge consumed
        }
        if (r == 0)
            return;
    }
}

// Resume a stream parked on an oversize frame, after Python took it:
// replay the carried bytes (may park again) and re-arm the epoll
// registration.  Reactor thread, under R->m.
static void resume_stream(Reactor *R, RStream *s) {
    if (s->dead || !s->parked)
        return;
    s->parked = false;
    if (!s->carry.empty()) {
        std::vector<uint8_t> buf;
        buf.swap(s->carry);
        stream_feed(R, s, buf.data(), buf.size());
    }
    if (s->dead || s->parked)
        return;                 // desynced or parked again
    struct epoll_event ev {};
    ev.events = EPOLLIN | (s->want_write ? (uint32_t)EPOLLOUT : 0u);
    ev.data.fd = s->fd;
    ::epoll_ctl(R->epfd, EPOLL_CTL_ADD, s->fd, &ev);
}

// Process one epoll_wait batch.  Caller holds R->m (ALL event
// processing — reactor thread and consumer-thread pump alike — is
// serialised by it, so R->scratch and the stream states stay
// single-writer).  `consume_wake` is false on the pump path: the wake
// eventfd belongs to the reactor thread (stop/resume pokes) and the
// pump must not eat it out from under a blocked epoll_wait.
static void process_events(Reactor *R, struct epoll_event *evs, int n,
                           bool consume_wake) {
    if (!R->resume_fds.empty()) {
        std::vector<int> todo;
        todo.swap(R->resume_fds);
        for (int fd : todo) {
            auto it = R->streams.find(fd);
            if (it != R->streams.end())
                resume_stream(R, it->second);
        }
    }
    for (int i = 0; i < n; ++i) {
        int fd = evs[i].data.fd;
        if (fd == R->wakefd) {
            if (consume_wake) {
                uint64_t junk;
                ssize_t r = ::read(R->wakefd, &junk, 8);
                (void)r;
            }
            continue;
        }
        auto it = R->streams.find(fd);
        if (it == R->streams.end())
            continue;
        RStream *s = it->second;
        if (s->dead)
            continue;
        uint32_t ev = evs[i].events;
        if (s->mode == 1) {
            // notify (oneshot): Python accepts, then rearms
            emit(R, fd, REC_ACCEPT, nullptr, 0, nullptr, 0);
            continue;
        }
        if (s->mode == 2) {
            drain_dgrams(R, s);
            emit(R, fd, REC_DOORBELL, nullptr, 0, nullptr, 0);
            continue;
        }
        if (ev & (EPOLLIN | EPOLLHUP | EPOLLERR))
            stream_readable(R, s);
        if ((ev & EPOLLOUT) && !s->dead && !s->parked &&
            s->want_write) {
            // one-shot writable edge: interest is cleared here,
            // Python re-arms (want_write) while its queue has bytes.
            // (want_write check: both epoll waiters can see the same
            // level-triggered edge — only the first emits.)
            s->want_write = false;
            struct epoll_event mod {};
            mod.events = EPOLLIN;
            mod.data.fd = fd;
            ::epoll_ctl(R->epfd, EPOLL_CTL_MOD, fd, &mod);
            emit(R, fd, REC_WRITABLE, nullptr, 0, nullptr, 0);
        }
    }
}

// Consumer-thread inline pump (called from otpu_reactor_drain when the
// record queue is empty, GIL already released by ctypes): poll the
// SAME epoll set with a zero timeout and process whatever is ready on
// the calling thread.  On a single-core / oversubscribed host this is
// the difference between picking a frame up on the very next progress
// tick and waiting a scheduler quantum for the reactor thread to run —
// the reactor thread still provides the overlap win when cores are
// free.  try_lock: if the reactor thread is mid-batch, records are
// already on their way and the pump has nothing useful to add.
static int pump(Reactor *R) {
    std::unique_lock<std::mutex> lk(R->m, std::try_to_lock);
    if (!lk.owns_lock())
        return 0;
    struct epoll_event evs[64];
    int n = ::epoll_wait(R->epfd, evs, 64, 0);
    if (n <= 0 && R->resume_fds.empty())
        return 0;
    process_events(R, evs, n < 0 ? 0 : n, /*consume_wake=*/false);
    R->n_pumps++;
    return n;
}

static void reactor_loop(Reactor *R) {
    // Idle scheduling policy: the background thread is an OVERLAP
    // optimisation — when cores are free it drains/parses while the
    // consumer computes, but on a saturated (single-core) host it must
    // never steal the quantum from a rank that would have pumped the
    // same event inline on its next progress tick.  Unprivileged
    // one-way switch; failure is fine (normal priority).
    struct sched_param sp {};
    ::pthread_setschedparam(::pthread_self(), SCHED_IDLE, &sp);
    struct epoll_event evs[64];
    while (!R->stop.load(std::memory_order_acquire)) {
        int n = ::epoll_wait(R->epfd, evs, 64, -1);
        if (n < 0) {
            if (errno == EINTR)
                continue;
            return;
        }
        std::lock_guard<std::mutex> lk(R->m);
        process_events(R, evs, n, /*consume_wake=*/true);
    }
}

}  // namespace

extern "C" {

int64_t otpu_reactor_create(int64_t ring_cap, int64_t oversize_limit) {
    if (ring_cap < (1 << 16))
        ring_cap = 1 << 16;
    Reactor *R = new Reactor();
    R->ring_cap = (uint64_t)ring_cap;
    R->oversize_limit = oversize_limit > 4096
        ? (uint64_t)oversize_limit : 4096;
    if (R->oversize_limit > R->ring_cap / 2)
        R->oversize_limit = R->ring_cap / 2;
    R->ring.assign(16 + (size_t)ring_cap, 0);
    R->epfd = ::epoll_create1(EPOLL_CLOEXEC);
    R->wakefd = ::eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    R->notifyfd = ::eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    R->waitfd = ::epoll_create1(EPOLL_CLOEXEC);
    if (R->epfd < 0 || R->wakefd < 0 || R->notifyfd < 0 ||
        R->waitfd < 0) {
        if (R->epfd >= 0) ::close(R->epfd);
        if (R->wakefd >= 0) ::close(R->wakefd);
        if (R->notifyfd >= 0) ::close(R->notifyfd);
        if (R->waitfd >= 0) ::close(R->waitfd);
        delete R;
        return 0;
    }
    struct epoll_event ev {};
    ev.events = EPOLLIN;
    ev.data.fd = R->wakefd;
    ::epoll_ctl(R->epfd, EPOLL_CTL_ADD, R->wakefd, &ev);
    // the consumer waiter fd: readable when the inner epoll set has
    // ready events (a nested epoll fd is itself pollable) OR when
    // completed records are queued (notifyfd)
    ev.events = EPOLLIN;
    ev.data.fd = R->epfd;
    ::epoll_ctl(R->waitfd, EPOLL_CTL_ADD, R->epfd, &ev);
    ev.events = EPOLLIN;
    ev.data.fd = R->notifyfd;
    ::epoll_ctl(R->waitfd, EPOLL_CTL_ADD, R->notifyfd, &ev);
    R->thr = std::thread([R] { reactor_loop(R); });
    return (int64_t)(intptr_t)R;
}

void otpu_reactor_destroy(int64_t h) {
    Reactor *R = (Reactor *)(intptr_t)h;
    R->stop.store(true, std::memory_order_release);
    uint64_t one = 1;
    ssize_t r = ::write(R->wakefd, &one, 8);
    (void)r;
    R->thr.join();
    for (auto &kv : R->streams)
        delete kv.second;
    ::close(R->epfd);
    ::close(R->wakefd);
    ::close(R->notifyfd);
    ::close(R->waitfd);
    delete R;
}

int otpu_reactor_notify_fd(int64_t h) {
    return ((Reactor *)(intptr_t)h)->notifyfd;
}

int otpu_reactor_wait_fd(int64_t h) {
    return ((Reactor *)(intptr_t)h)->waitfd;
}

int otpu_reactor_add(int64_t h, int fd, int mode) {
    Reactor *R = (Reactor *)(intptr_t)h;
    std::lock_guard<std::mutex> lk(R->m);
    if (R->streams.count(fd))
        return -1;
    RStream *s = new RStream();
    s->fd = fd;
    s->mode = mode;
    struct epoll_event ev {};
    ev.events = EPOLLIN | (mode == 1 ? (uint32_t)EPOLLONESHOT : 0u);
    ev.data.fd = fd;
    if (::epoll_ctl(R->epfd, EPOLL_CTL_ADD, fd, &ev) != 0) {
        delete s;
        return -1;
    }
    R->streams[fd] = s;
    return 0;
}

int otpu_reactor_del(int64_t h, int fd) {
    Reactor *R = (Reactor *)(intptr_t)h;
    std::lock_guard<std::mutex> lk(R->m);
    auto it = R->streams.find(fd);
    if (it == R->streams.end())
        return -1;
    RStream *s = it->second;
    if (!s->dead && !s->parked)
        epoll_del_quiet(R, s);
    R->streams.erase(it);
    delete s;
    return 0;
}

int otpu_reactor_rearm(int64_t h, int fd) {
    Reactor *R = (Reactor *)(intptr_t)h;
    std::lock_guard<std::mutex> lk(R->m);
    auto it = R->streams.find(fd);
    if (it == R->streams.end() || it->second->mode != 1)
        return -1;
    struct epoll_event ev {};
    ev.events = EPOLLIN | EPOLLONESHOT;
    ev.data.fd = fd;
    return ::epoll_ctl(R->epfd, EPOLL_CTL_MOD, fd, &ev);
}

int otpu_reactor_want_write(int64_t h, int fd, int on) {
    Reactor *R = (Reactor *)(intptr_t)h;
    std::lock_guard<std::mutex> lk(R->m);
    auto it = R->streams.find(fd);
    if (it == R->streams.end())
        return -1;
    RStream *s = it->second;
    s->want_write = on != 0;
    if (s->dead || s->parked)
        return 0;               // resume_stream re-applies the interest
    struct epoll_event ev {};
    ev.events = EPOLLIN | (on ? (uint32_t)EPOLLOUT : 0u);
    ev.data.fd = fd;
    return ::epoll_ctl(R->epfd, EPOLL_CTL_MOD, fd, &ev);
}

// Copy completed records into `out`; returns bytes copied (0: empty).
// Returns the NEGATED size of the next record when it does not fit an
// empty `out` — the caller grows its buffer and retries.  Single
// consumer (the Python side serialises itself).
int64_t otpu_reactor_drain(int64_t h, uint8_t *out, uint64_t cap) {
    Reactor *R = (Reactor *)(intptr_t)h;
    uint64_t junk;
    ssize_t rd = ::read(R->notifyfd, &junk, 8);
    (void)rd;
    uint8_t *buf = rq_base(R);
    const uint8_t *data = buf + 16;
    // empty queue: poll the epoll set inline before giving up —
    // completed frames land this very tick instead of after a
    // reactor-thread scheduling gap (see pump()).  Lock-free check:
    // two acquire loads + an atomic flag, nothing heavier on the
    // every-tick path.
    if (load_acq(buf) == load_acq(buf + 8) &&
        !R->has_overflow.load(std::memory_order_acquire))
        pump(R);
    uint64_t copied = 0;
    for (;;) {
        uint64_t head = load_acq(buf);
        uint64_t tail = load_acq(buf + 8);
        if (head == tail)
            break;
        uint8_t hdr[REC_HDR];
        uint64_t p = head % R->ring_cap;
        uint64_t first = REC_HDR < R->ring_cap - p
            ? REC_HDR : R->ring_cap - p;
        std::memcpy(hdr, data + p, (size_t)first);
        if (first < REC_HDR)
            std::memcpy(hdr + first, data, REC_HDR - first);
        uint32_t plen;
        std::memcpy(&plen, hdr, 4);
        uint64_t total = REC_HDR + plen;
        if (total > cap - copied) {
            if (copied == 0)
                return -(int64_t)total;
            break;
        }
        uint64_t q = head % R->ring_cap;
        uint64_t f2 = total < R->ring_cap - q ? total : R->ring_cap - q;
        std::memcpy(out + copied, data + q, (size_t)f2);
        if (f2 < total)
            std::memcpy(out + copied + f2, data, (size_t)(total - f2));
        copied += total;
        store_rel(buf, head + total);
    }
    // overflow (engaged only while the ring was full): strictly older
    // than nothing — every overflow record postdates every ring record
    {
        std::lock_guard<std::mutex> lk(R->ov_m);
        while (!R->overflow.empty()) {
            std::vector<uint8_t> &rec = R->overflow.front();
            if (rec.size() > cap - copied) {
                if (copied == 0)
                    return -(int64_t)rec.size();
                break;
            }
            std::memcpy(out + copied, rec.data(), rec.size());
            copied += rec.size();
            R->overflow.pop_front();
        }
        if (R->overflow.empty())
            R->has_overflow.store(false, std::memory_order_release);
        uint64_t head = load_acq(buf);
        uint64_t tail = load_acq(buf + 8);
        if (head != tail || !R->overflow.empty())
            notify_consumer(R);   // leftovers: keep waiters awake
    }
    return (int64_t)copied;
}

// Fetch (and clear) a stream's parked oversize frame; schedules the
// stream's resume on the reactor thread.  Returns the frame length,
// the negated length when `cap` is too small, or -1 when nothing is
// parked for `fd`.
int64_t otpu_reactor_take_oversize(int64_t h, int fd, uint8_t *out,
                                   uint64_t cap) {
    Reactor *R = (Reactor *)(intptr_t)h;
    std::lock_guard<std::mutex> lk(R->m);
    auto it = R->streams.find(fd);
    if (it == R->streams.end())
        return -1;
    RStream *s = it->second;
    if (!s->parked || s->oversize.empty())
        return -1;
    if (s->oversize.size() > cap)
        return -(int64_t)s->oversize.size();
    std::memcpy(out, s->oversize.data(), s->oversize.size());
    int64_t n = (int64_t)s->oversize.size();
    s->oversize.clear();
    s->oversize.shrink_to_fit();
    R->resume_fds.push_back(fd);
    uint64_t one = 1;
    ssize_t r = ::write(R->wakefd, &one, 8);
    (void)r;
    return n;
}

// stats: [n_fds, n_records, n_frames_fast, n_frames_raw, n_overflow,
//         n_wakeups, n_pumps] — racy reads, telemetry only.
int otpu_reactor_stats(int64_t h, int64_t *out, int n) {
    Reactor *R = (Reactor *)(intptr_t)h;
    int64_t vals[7];
    {
        std::lock_guard<std::mutex> lk(R->m);
        vals[0] = (int64_t)R->streams.size();
    }
    vals[1] = (int64_t)R->n_records;
    vals[2] = (int64_t)R->n_frames_fast;
    vals[3] = (int64_t)R->n_frames_raw;
    vals[4] = (int64_t)R->n_overflow;
    vals[5] = (int64_t)R->n_wakeups;
    vals[6] = (int64_t)R->n_pumps;
    int k = n < 7 ? n : 7;
    for (int i = 0; i < k; ++i)
        out[i] = vals[i];
    return k;
}

}  // extern "C"

#else  // !__linux__: the reactor needs epoll/eventfd; stub the API so
       // the library still builds and available() stays true for the
       // pack/ring/pool substrate — Python's reactor_supported() gates
       // on otpu_reactor_create returning a handle.

extern "C" {

int64_t otpu_reactor_create(int64_t, int64_t) { return 0; }
void otpu_reactor_destroy(int64_t) {}
int otpu_reactor_notify_fd(int64_t) { return -1; }
int otpu_reactor_wait_fd(int64_t) { return -1; }
int otpu_reactor_add(int64_t, int, int) { return -1; }
int otpu_reactor_del(int64_t, int) { return -1; }
int otpu_reactor_rearm(int64_t, int) { return -1; }
int otpu_reactor_want_write(int64_t, int, int) { return -1; }
int64_t otpu_reactor_drain(int64_t, uint8_t *, uint64_t) { return 0; }
int64_t otpu_reactor_take_oversize(int64_t, int, uint8_t *, uint64_t) {
    return -1;
}
int otpu_reactor_stats(int64_t, int64_t *, int) { return 0; }

}  // extern "C"

#endif  // __linux__
