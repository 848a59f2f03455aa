// band_copy: a host buffer copied in bands on a persistent pool of threads,
// for the capture stream's copy into its pinned upload slot
// (tpu_inspect_torch/streaming.py: _copy_rows).
//
// A copy in Python worker threads starts each band only once its thread holds
// the GIL, one thread after the other; here the bands start together. The
// calling thread posts the job, wakes every worker at once and claims bands
// itself; each band is claimed by one thread and copied once. The call
// returns when every band has landed. Stores bypass the caches (SSE2
// streaming stores), so the copy reads no destination line first and the
// card's DMA reads the slot from memory, not from other cores' caches.
//
// Contract: bc_copy(dst, src, offsets, bands) copies bytes
// [offsets[i], offsets[i + 1]) of src to dst for every band i < bands; the
// buffers must not overlap. Copies from several threads take turns. The pool
// grows to bands - 1 threads and lives as long as the process; a forked
// child makes its own.
//
// Build (tpu_inspect_torch/native/__init__.py, at first use):
//   g++ -O2 -shared -fPIC -pthread band_copy.cc -o libband_copy_<hash>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>

#include <unistd.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

void copy_streaming(uint8_t* dst, const uint8_t* src, size_t n) {
#if defined(__SSE2__)
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  std::memcpy(dst, src, head);
  dst += head;
  src += head;
  n -= head;
  size_t body = n & ~size_t(63);
  for (size_t i = 0; i < body; i += 64) {
    __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 16));
    __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 32));
    __m128i d = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 48));
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i), a);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 16), b);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 32), c);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 48), d);
  }
  std::memcpy(dst + body, src + body, n - body);
  _mm_sfence();  // streaming stores are weakly ordered: land them before the band counts
#else
  std::memcpy(dst, src, n);
#endif
}

struct Job {
  uint32_t id = 0;
  uint8_t* dst = nullptr;
  const uint8_t* src = nullptr;
  const int64_t* offsets = nullptr;
  int bands = 0;
};

struct Pool {
  std::mutex mu;
  std::condition_variable wake, done;
  int workers = 0;
  Job job;                        // the posted job, read and written under mu
  std::atomic<uint64_t> next{0};  // job id << 32 | the next band to claim
  std::atomic<int> finished{0};   // the posted job's bands landed

  // Claim and copy bands of job j until none is left. A thread that wakes
  // after its job is done claims nothing: the id in `next` has moved on.
  void run(const Job& j) {
    for (;;) {
      uint64_t v = next.load();
      if (uint32_t(v >> 32) != j.id || int(v & 0xffffffffu) >= j.bands) return;
      if (!next.compare_exchange_weak(v, v + 1)) continue;
      int b = int(v & 0xffffffffu);
      copy_streaming(j.dst + j.offsets[b], j.src + j.offsets[b],
                     size_t(j.offsets[b + 1] - j.offsets[b]));
      if (finished.fetch_add(1) + 1 == j.bands) {
        std::lock_guard<std::mutex> lk(mu);
        done.notify_all();
      }
    }
  }

  void worker() {
    uint32_t seen = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      wake.wait(lk, [&] { return job.id != seen; });
      Job j = job;
      seen = j.id;
      lk.unlock();
      run(j);
      lk.lock();
    }
  }
};

std::mutex turn;  // one copy at a time
Pool* pool = nullptr;  // never freed: its threads wait on it until the process ends
pid_t pool_pid = 0;

}  // namespace

extern "C" {

int bc_copy(void* dst, const void* src, const int64_t* offsets, int bands) {
  if (bands < 1) return 1;
  std::lock_guard<std::mutex> one(turn);
  if (pool == nullptr || pool_pid != getpid()) {
    pool = new Pool;
    pool_pid = getpid();
  }
  Pool& p = *pool;
  Job j;
  {
    std::lock_guard<std::mutex> lk(p.mu);
    try {
      for (; p.workers < bands - 1; ++p.workers) std::thread([&p] { p.worker(); }).detach();
    } catch (...) {  // no thread to be had: the threads there claim every band
    }
    j.id = p.job.id + 1;
    j.dst = static_cast<uint8_t*>(dst);
    j.src = static_cast<const uint8_t*>(src);
    j.offsets = offsets;
    j.bands = bands;
    p.job = j;
    p.finished.store(0);
    p.next.store(uint64_t(j.id) << 32);
  }
  p.wake.notify_all();
  p.run(j);
  std::unique_lock<std::mutex> lk(p.mu);
  p.done.wait(lk, [&] { return p.finished.load() == j.bands; });
  return 0;
}

}  // extern "C"
