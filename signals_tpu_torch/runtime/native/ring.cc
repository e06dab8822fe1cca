// Native runtime for the realtime audio path (a copy of the JAX package's
// signals_tpu/runtime/native/ring.cc, built on its own).
//
// The reference's realtime engine is PortAudio's C callback thread pulling
// the Python graph directly (reference src/signals/chain/dev.py:139-179).
// Here the GPU renders ahead and this library carries the blocks across the
// realtime boundary:
//
//   * sig_ring   — a lock-free single-producer/single-consumer ring buffer
//                  of float32 frames (the render thread produces, the audio
//                  consumer drains).  Power-of-two capacity, acquire/release
//                  atomics, no locks anywhere on the audio path.
//   * sig_consumer — a paced consumer thread that drains the ring at the
//                  sample rate on a monotonic clock (a virtual output
//                  device; or, given a file descriptor, a raw f32 or PCM16
//                  writer to a pipe/file/real device node).  Shortfalls are
//                  zero-filled and counted as underruns instead of
//                  crashing the stream (the reference kills the stream on
//                  any exception, dev.py:174-176).
//
// Built as a shared library with the host's g++ at first use; Python binds
// via ctypes (signals_tpu_torch/runtime/ring.py).

#include <atomic>
#include <cmath>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unistd.h>

namespace {

constexpr uint32_t round_up_pow2(uint32_t v) {
    v -= 1;
    v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
    return v + 1;
}

struct Ring {
    float* data = nullptr;
    uint32_t capacity = 0;      // frames, power of two
    uint32_t mask = 0;
    uint32_t channels = 0;
    std::atomic<uint64_t> head{0};   // next frame to write (producer)
    std::atomic<uint64_t> tail{0};   // next frame to read (consumer)

    uint64_t readable() const {
        return head.load(std::memory_order_acquire)
             - tail.load(std::memory_order_acquire);
    }
    uint64_t writable() const { return capacity - readable(); }
};

struct Consumer {
    Ring* ring = nullptr;
    double rate = 44100.0;
    uint32_t block_frames = 0;
    int fd = -1;
    int format = 0;             // 0 = raw float32, 1 = PCM16 (clipped)
    std::thread thread;
    std::atomic<bool> running{false};
    std::atomic<uint64_t> frames_consumed{0};
    std::atomic<uint64_t> underruns{0};
    float* scratch = nullptr;
    int16_t* scratch16 = nullptr;
};

}  // namespace

extern "C" {

Ring* sig_ring_create(uint32_t capacity_frames, uint32_t channels) {
    if (capacity_frames == 0 || channels == 0) return nullptr;
    Ring* r = new Ring();
    r->capacity = round_up_pow2(capacity_frames);
    r->mask = r->capacity - 1;
    r->channels = channels;
    r->data = new float[static_cast<size_t>(r->capacity) * channels]();
    return r;
}

void sig_ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->data;
    delete r;
}

uint32_t sig_ring_channels(const Ring* r) { return r->channels; }
uint32_t sig_ring_capacity(const Ring* r) { return r->capacity; }
uint64_t sig_ring_readable(const Ring* r) { return r->readable(); }
uint64_t sig_ring_writable(const Ring* r) { return r->writable(); }

// Producer side: copy up to `frames` frames in; returns frames accepted.
uint32_t sig_ring_write(Ring* r, const float* src, uint32_t frames) {
    const uint64_t head = r->head.load(std::memory_order_relaxed);
    const uint64_t free_frames = r->capacity
        - (head - r->tail.load(std::memory_order_acquire));
    const uint32_t n = frames < free_frames
        ? frames : static_cast<uint32_t>(free_frames);
    for (uint32_t i = 0; i < n; ++i) {
        const uint64_t frame = (head + i) & r->mask;
        std::memcpy(r->data + frame * r->channels,
                    src + static_cast<size_t>(i) * r->channels,
                    r->channels * sizeof(float));
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Consumer side: copy up to `frames` frames out; returns frames delivered.
uint32_t sig_ring_read(Ring* r, float* dst, uint32_t frames) {
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t avail = r->head.load(std::memory_order_acquire) - tail;
    const uint32_t n = frames < avail
        ? frames : static_cast<uint32_t>(avail);
    for (uint32_t i = 0; i < n; ++i) {
        const uint64_t frame = (tail + i) & r->mask;
        std::memcpy(dst + static_cast<size_t>(i) * r->channels,
                    r->data + frame * r->channels,
                    r->channels * sizeof(float));
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

static void consumer_loop(Consumer* c) {
    using clock = std::chrono::steady_clock;
    const auto start = clock::now();
    const double frames_per_ns = c->rate / 1e9;
    uint64_t emitted = 0;
    const uint32_t block = c->block_frames;
    const size_t block_bytes =
        static_cast<size_t>(block) * c->ring->channels * sizeof(float);
    while (c->running.load(std::memory_order_relaxed)) {
        // due = frames the wall clock says should have been played by now
        const auto now = clock::now();
        const double elapsed_ns =
            std::chrono::duration_cast<std::chrono::nanoseconds>(now - start)
                .count();
        const uint64_t due =
            static_cast<uint64_t>(elapsed_ns * frames_per_ns);
        if (due >= emitted + block) {
            const uint32_t got = sig_ring_read(c->ring, c->scratch, block);
            if (got < block) {
                std::memset(c->scratch + static_cast<size_t>(got)
                                * c->ring->channels,
                            0, (block - got) * c->ring->channels
                                * sizeof(float));
                c->underruns.fetch_add(1, std::memory_order_relaxed);
            }
            if (c->fd >= 0) {
                // best-effort write of the block (f32 or PCM16)
                if (c->format == 1) {
                    const size_t n_samples =
                        static_cast<size_t>(block) * c->ring->channels;
                    for (size_t s = 0; s < n_samples; ++s) {
                        float v = c->scratch[s] * 32767.0f;
                        if (v > 32767.0f) v = 32767.0f;
                        if (v < -32768.0f) v = -32768.0f;
                        c->scratch16[s] =
                            static_cast<int16_t>(lrintf(v));
                    }
                    ssize_t ignored = write(c->fd, c->scratch16,
                                            n_samples * sizeof(int16_t));
                    (void)ignored;
                } else {
                    ssize_t ignored = write(c->fd, c->scratch, block_bytes);
                    (void)ignored;
                }
            }
            emitted += block;
            c->frames_consumed.store(emitted, std::memory_order_relaxed);
        } else {
            const uint64_t wait_frames = emitted + block - due;
            const auto wait_ns = static_cast<int64_t>(
                static_cast<double>(wait_frames) / frames_per_ns);
            std::this_thread::sleep_for(
                std::chrono::nanoseconds(wait_ns / 2 + 1000));
        }
    }
}

Consumer* sig_consumer_start(Ring* ring, double rate, uint32_t block_frames,
                             int fd, int format) {
    if (!ring || rate <= 0 || block_frames == 0) return nullptr;
    Consumer* c = new Consumer();
    c->ring = ring;
    c->rate = rate;
    c->block_frames = block_frames;
    c->fd = fd;
    c->format = format;
    const size_t n = static_cast<size_t>(block_frames) * ring->channels;
    c->scratch = new float[n];
    c->scratch16 = format == 1 ? new int16_t[n] : nullptr;
    c->running.store(true);
    c->thread = std::thread(consumer_loop, c);
    return c;
}

void sig_consumer_stop(Consumer* c) {
    if (!c) return;
    c->running.store(false);
    if (c->thread.joinable()) c->thread.join();
    delete[] c->scratch;
    delete[] c->scratch16;
    delete c;
}

uint64_t sig_consumer_frames(const Consumer* c) {
    return c->frames_consumed.load(std::memory_order_relaxed);
}

uint64_t sig_consumer_underruns(const Consumer* c) {
    return c->underruns.load(std::memory_order_relaxed);
}

}  // extern "C"
