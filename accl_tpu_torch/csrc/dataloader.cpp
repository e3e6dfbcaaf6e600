// Native token-stream data loader for the port's trainer.
//
// A copy of the JAX package's loader (the port keeps its own), built by
// accl_tpu_torch/data.py with the host's g++ into csrc/build/ at first
// use.  A background prefetch thread assembles (batch, seq+1) windows
// from an mmap'd token file into a bounded ring of staging buffers, so
// the Python step loop only ever memcpy's a ready batch (and the copy
// overlaps the NEXT batch's assembly).
//
// File format ("ACCLTOK1"): 8-byte magic, u32 dtype code (2 = uint16,
// 4 = uint32), u64 token count, then the raw little-endian token ids.
//
// Sampling is STATELESS and deterministic: window starts come from
// splitmix64(seed, step, row) restricted to this shard's stripe of the
// file, so any rank can seek to any step (checkpoint resume) without
// replaying history, and dp shards read disjoint stripes.  The same
// (file, seed, step, shard, num_shards) gives the JAX loader's batch.
//
// C ABI only (ctypes): every entry returns 0 on success or a negative
// errno-style code, and the handle is opaque.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'A', 'C', 'C', 'L', 'T', 'O', 'K', '1'};

constexpr int DL_OK = 0;
constexpr int DL_ERR_OPEN = -1;
constexpr int DL_ERR_FORMAT = -2;
constexpr int DL_ERR_TOO_SMALL = -3;
constexpr int DL_ERR_ARGS = -4;
constexpr int DL_ERR_CLOSED = -5;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Batch {
  uint64_t step;
  std::vector<uint32_t> tokens;  // (batch, seq + 1), widened to u32
};

struct Loader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  const uint8_t* data = nullptr;  // token payload after the header
  uint64_t n_tokens = 0;
  uint32_t dtype = 2;  // bytes per token on disk
  uint64_t batch = 0, seq = 0;
  uint64_t shard = 0, num_shards = 1;
  uint64_t seed = 0;
  // this shard's stripe [lo, hi) of valid window STARTS
  uint64_t lo = 0, hi = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_can_produce, cv_can_consume;
  std::deque<Batch> ring;
  size_t depth = 2;
  uint64_t next_produce_step = 0;
  // bumped by seek(): a fill started before the seek must NOT land in
  // the ring afterwards (its step predates the new position)
  uint64_t generation = 0;
  std::atomic<bool> stopping{false};

  uint64_t window_start(uint64_t step, uint64_t row) const {
    uint64_t h = splitmix64(seed ^ splitmix64(step ^ splitmix64(row)));
    return lo + h % (hi - lo);
  }

  uint32_t token_at(uint64_t i) const {
    if (dtype == 2) {
      uint16_t v;
      std::memcpy(&v, data + i * 2, 2);
      return v;
    }
    uint32_t v;
    std::memcpy(&v, data + i * 4, 4);
    return v;
  }

  void fill(Batch& b, uint64_t step) const {
    const uint64_t w = seq + 1;
    b.step = step;
    b.tokens.resize(batch * w);
    for (uint64_t r = 0; r < batch; ++r) {
      uint64_t s = window_start(step, r);
      for (uint64_t j = 0; j < w; ++j)
        b.tokens[r * w + j] = token_at(s + j);
    }
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_can_produce.wait(lk, [&] {
        return stopping.load() || ring.size() < depth;
      });
      if (stopping.load()) return;
      uint64_t step = next_produce_step++;
      uint64_t gen = generation;
      lk.unlock();
      Batch b;
      fill(b, step);  // mmap reads happen OUTSIDE the lock
      lk.lock();
      if (stopping.load()) return;
      if (gen != generation) continue;  // seek() raced this fill: discard
      ring.push_back(std::move(b));
      cv_can_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Opens a token file and starts the prefetch thread.  Returns DL_OK and
// stores the handle, or a negative error.  `shard`/`num_shards` stripe
// the file across dp ranks (each rank's windows come from a disjoint
// region); `start_step` positions the stream for checkpoint resume.
int accl_dl_open(const char* path, uint64_t batch, uint64_t seq,
                 uint64_t shard, uint64_t num_shards, uint64_t seed,
                 uint64_t start_step, uint64_t prefetch_depth,
                 void** out_handle) {
  if (!path || !out_handle || batch == 0 || seq == 0 || num_shards == 0 ||
      shard >= num_shards)
    return DL_ERR_ARGS;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return DL_ERR_OPEN;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < 20) {
    ::close(fd);
    return DL_ERR_FORMAT;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return DL_ERR_OPEN;
  }
  const uint8_t* p = static_cast<const uint8_t*>(map);
  if (std::memcmp(p, kMagic, 8) != 0) {
    munmap(map, st.st_size);
    ::close(fd);
    return DL_ERR_FORMAT;
  }
  uint32_t dtype;
  uint64_t count;
  std::memcpy(&dtype, p + 8, 4);
  std::memcpy(&count, p + 12, 8);
  // divide instead of multiply: `20 + count*dtype` wraps in uint64 for a
  // corrupt/hostile header with count near 2^62, passing the bound and
  // letting token_at() read past the mmap (st_size >= 20 checked above)
  if ((dtype != 2 && dtype != 4) ||
      count > ((uint64_t)st.st_size - 20) / dtype) {
    munmap(map, st.st_size);
    ::close(fd);
    return DL_ERR_FORMAT;
  }

  auto* L = new Loader();
  L->fd = fd;
  L->map = p;
  L->map_len = st.st_size;
  L->data = p + 20;
  L->n_tokens = count;
  L->dtype = dtype;
  L->batch = batch;
  L->seq = seq;
  L->shard = shard;
  L->num_shards = num_shards;
  L->seed = seed;
  L->depth = prefetch_depth ? prefetch_depth : 2;
  L->next_produce_step = start_step;

  // valid window starts: [0, n_tokens - (seq + 1)]; stripe them by shard
  if (count < seq + 2) {
    munmap(map, st.st_size);
    ::close(fd);
    delete L;
    return DL_ERR_TOO_SMALL;
  }
  uint64_t starts = count - (seq + 1);
  uint64_t per = starts / num_shards;
  if (per == 0) {
    munmap(map, st.st_size);
    ::close(fd);
    delete L;
    return DL_ERR_TOO_SMALL;
  }
  L->lo = shard * per;
  L->hi = (shard + 1 == num_shards) ? starts + 1 : (shard + 1) * per;

  L->worker = std::thread([L] { L->run(); });
  *out_handle = L;
  return DL_OK;
}

// Copies the next prefetched (batch, seq+1) u32 window into `out`
// (caller-allocated, batch*(seq+1) uint32) and stores its step index.
int accl_dl_next(void* handle, uint32_t* out, uint64_t* out_step) {
  auto* L = static_cast<Loader*>(handle);
  if (!L || !out) return DL_ERR_ARGS;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_can_consume.wait(lk, [&] {
    return L->stopping.load() || !L->ring.empty();
  });
  if (L->stopping.load()) return DL_ERR_CLOSED;
  Batch b = std::move(L->ring.front());
  L->ring.pop_front();
  L->cv_can_produce.notify_all();
  lk.unlock();
  std::memcpy(out, b.tokens.data(), b.tokens.size() * 4);
  if (out_step) *out_step = b.step;
  return DL_OK;
}

// Repositions the stream at `step` (checkpoint resume): drops any
// prefetched batches and restarts production there.
int accl_dl_seek(void* handle, uint64_t step) {
  auto* L = static_cast<Loader*>(handle);
  if (!L) return DL_ERR_ARGS;
  std::lock_guard<std::mutex> lk(L->mu);
  L->ring.clear();
  L->next_produce_step = step;
  ++L->generation;  // any in-flight fill discards itself on completion
  L->cv_can_produce.notify_all();
  return DL_OK;
}

int accl_dl_token_count(void* handle, uint64_t* out) {
  auto* L = static_cast<Loader*>(handle);
  if (!L || !out) return DL_ERR_ARGS;
  *out = L->n_tokens;
  return DL_OK;
}

int accl_dl_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  if (!L) return DL_ERR_ARGS;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping.store(true);
    L->cv_can_produce.notify_all();
    L->cv_can_consume.notify_all();
  }
  if (L->worker.joinable()) L->worker.join();
  if (L->map) munmap(const_cast<uint8_t*>(L->map), L->map_len);
  if (L->fd >= 0) ::close(L->fd);
  delete L;
  return DL_OK;
}

}  // extern "C"
