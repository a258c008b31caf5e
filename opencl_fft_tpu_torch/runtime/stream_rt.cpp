// Native host-side streaming runtime.
//
// The reference's host runtime is C++: the Csound opcode layer shuttles
// samples between ksmps-sized audio blocks and partition-sized engine
// calls every perf cycle (csound/opcode.cpp:229-252, :313-344). This file
// is the host-side equivalent of that hot host path:
//
//   * BlockAcc  — the partition accumulator with one-partition latency
//                 (exact semantics of opcode.cpp:240-249), n_streams wide
//                 so time-varying convolution feeds both operands in one
//                 pass.
//   * RingBuf   — a lock-free single-producer/single-consumer float ring
//                 for decoupling a real-time audio thread from the device
//                 worker thread (device dispatch latency must never block
//                 the audio callback).
//
// Exposed as a C ABI for ctypes (opencl_fft_tpu_torch/runtime/__init__.py);
// the Python layer falls back to a numpy implementation only where no C++
// compiler is installed.

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer (capacity rounded up to a power of two)
// ---------------------------------------------------------------------------

struct RingBuf {
    float* data;
    size_t mask;                      // capacity - 1
    std::atomic<size_t> head;         // write index (producer)
    std::atomic<size_t> tail;         // read index (consumer)
};

void* rb_new(size_t capacity) {
    size_t cap = 1;
    while (cap < capacity) cap <<= 1;
    RingBuf* rb = new (std::nothrow) RingBuf;
    if (!rb) return nullptr;
    rb->data = static_cast<float*>(std::malloc(cap * sizeof(float)));
    if (!rb->data) { delete rb; return nullptr; }
    rb->mask = cap - 1;
    rb->head.store(0, std::memory_order_relaxed);
    rb->tail.store(0, std::memory_order_relaxed);
    return rb;
}

void rb_free(void* p) {
    RingBuf* rb = static_cast<RingBuf*>(p);
    if (rb) { std::free(rb->data); delete rb; }
}

size_t rb_capacity(void* p) { return static_cast<RingBuf*>(p)->mask + 1; }

size_t rb_available(void* p) {
    RingBuf* rb = static_cast<RingBuf*>(p);
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_acquire);
}

size_t rb_space(void* p) {
    RingBuf* rb = static_cast<RingBuf*>(p);
    return rb->mask + 1 - rb_available(p);
}

size_t rb_write(void* p, const float* src, size_t n) {
    RingBuf* rb = static_cast<RingBuf*>(p);
    size_t head = rb->head.load(std::memory_order_relaxed);
    size_t tail = rb->tail.load(std::memory_order_acquire);
    size_t space = rb->mask + 1 - (head - tail);
    if (n > space) n = space;
    for (size_t i = 0; i < n; ++i)
        rb->data[(head + i) & rb->mask] = src[i];
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

size_t rb_read(void* p, float* dst, size_t n) {
    RingBuf* rb = static_cast<RingBuf*>(p);
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    size_t head = rb->head.load(std::memory_order_acquire);
    size_t avail = head - tail;
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i)
        dst[i] = rb->data[(tail + i) & rb->mask];
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// Partition block accumulator (opcode.cpp:240-249 semantics)
// ---------------------------------------------------------------------------

struct BlockAcc {
    int parts;
    int n_streams;
    int cnt;
    int pending;      // 1 => buffer just filled; engine output due
    float* bufin;     // n_streams * parts
    float* bufout;    // parts
};

void* acc_new(int parts, int n_streams) {
    if (parts <= 0 || n_streams <= 0) return nullptr;
    BlockAcc* a = new (std::nothrow) BlockAcc;
    if (!a) return nullptr;
    a->parts = parts;
    a->n_streams = n_streams;
    a->cnt = 0;
    a->pending = 0;
    a->bufin = static_cast<float*>(
        std::calloc(static_cast<size_t>(parts) * n_streams, sizeof(float)));
    a->bufout = static_cast<float*>(std::calloc(parts, sizeof(float)));
    if (!a->bufin || !a->bufout) {
        std::free(a->bufin); std::free(a->bufout); delete a;
        return nullptr;
    }
    return a;
}

void acc_free(void* p) {
    BlockAcc* a = static_cast<BlockAcc*>(p);
    if (a) { std::free(a->bufin); std::free(a->bufout); delete a; }
}

int acc_cnt(void* p) { return static_cast<BlockAcc*>(p)->cnt; }
// The count, for a caller that fills bufin and reads bufout through views
// of its own while a callback cannot fill the partition (0 <= cnt < parts).
void acc_set_cnt(void* p, int cnt) { static_cast<BlockAcc*>(p)->cnt = cnt; }
float* acc_bufin(void* p, int stream) {
    BlockAcc* a = static_cast<BlockAcc*>(p);
    return a->bufin + static_cast<size_t>(stream) * a->parts;
}
float* acc_bufout(void* p) { return static_cast<BlockAcc*>(p)->bufout; }

// Feed up to k samples per stream starting at offset `pos`; copies the
// currently-latent output into `out` and the inputs into bufin. Returns the
// number of samples consumed; stops early (engine call due) when the
// partition buffer fills. Caller then runs the engine on bufin, stores the
// result with acc_set_bufout, and calls again with the advanced offset.
int acc_feed(void* p, const float* const* ins, float* out, int pos, int k) {
    BlockAcc* a = static_cast<BlockAcc*>(p);
    int remain = a->parts - a->cnt;
    int take = k - pos < remain ? k - pos : remain;
    std::memcpy(out + pos, a->bufout + a->cnt, take * sizeof(float));
    for (int s = 0; s < a->n_streams; ++s)
        std::memcpy(a->bufin + static_cast<size_t>(s) * a->parts + a->cnt,
                    ins[s] + pos, take * sizeof(float));
    a->cnt += take;
    if (a->cnt == a->parts) { a->cnt = 0; a->pending = 1; }
    return take;
}

// 1 when the partition buffer has just filled: the caller must run the
// engine on bufin and acc_set_bufout the result before feeding more.
int acc_full(void* p) {
    return static_cast<BlockAcc*>(p)->pending;
}

void acc_set_bufout(void* p, const float* data) {
    BlockAcc* a = static_cast<BlockAcc*>(p);
    std::memcpy(a->bufout, data, a->parts * sizeof(float));
    a->pending = 0;
}

}  // extern "C"
