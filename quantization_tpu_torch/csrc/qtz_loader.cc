// Native streaming corpus loader.
//
// The reference's data path loads the whole HDF5 corpus into host RAM and
// shuffles it in place (`quantization/quantization.py:798-809`), which cannot
// scale past RAM.  This loader streams raw-f16 shard files instead:
// multi-threaded reads fill a bounded shuffle pool; consumers draw uniformly
// random frames from the pool and each draw is replaced by a freshly
// streamed frame, giving a sliding-window shuffle with O(pool) memory.
// Batches are emitted as float32, ready for device upload.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this toolchain).
// Shard format: raw little-endian float16 frames, (frames, dim) row-major;
// shard membership and dim come from a JSON manifest parsed on the Python
// side (this library only sees file paths + frame counts).
//
// Multi-host: the Python wrapper passes only this host's shard subset, so
// corpus partitioning stays in one place (data/shards.py).
//
// The PyTorch port's copy of the JAX package's loader, with the same C ABI;
// ops/cuda_build.py builds it with g++ into csrc/_build/.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define QTZ_X86 1
#endif

namespace {

// Minimal IEEE binary16 -> binary32 conversion (no F16C dependency).
inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalize
      int shift = 0;
      while (!(man & 0x400u)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3ffu;
      bits = sign | ((127 - 15 - shift) << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

void convert_scalar(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = f16_to_f32(src[i]);
}

#ifdef QTZ_X86
// Hardware half->float conversion: 8 lanes per instruction.  Compiled with
// a per-function target attribute so the library still builds and runs on
// hosts without F16C (runtime-dispatched below).
__attribute__((target("f16c,avx"))) void convert_f16c(const uint16_t* src,
                                                      float* dst, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m128i h = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    _mm256_storeu_ps(dst + i, _mm256_cvtph_ps(h));
  }
  for (; i < n; ++i) dst[i] = f16_to_f32(src[i]);
}
#endif

void convert_f16_block(const uint16_t* src, float* dst, int64_t n) {
#ifdef QTZ_X86
  static const bool has_f16c = __builtin_cpu_supports("f16c");
  if (has_f16c) {
    convert_f16c(src, dst, n);
    return;
  }
#endif
  convert_scalar(src, dst, n);
}

struct Shard {
  std::string path;
  int64_t frames;
};

class Loader {
 public:
  Loader(std::vector<Shard> shards, int64_t dim, int64_t pool_frames,
         int64_t batch, uint64_t seed, int num_threads, bool repeat)
      : shards_(std::move(shards)),
        dim_(dim),
        pool_capacity_(pool_frames),
        batch_(batch),
        repeat_(repeat),
        num_threads_(num_threads),
        rng_(seed) {
    pool_.resize((size_t)pool_capacity_ * dim_);
    // num_threads_ must be fixed BEFORE spawning: reader threads use it as
    // their shard stride and can start before the readers_ vector is full.
    readers_.reserve((size_t)num_threads);
    for (int i = 0; i < num_threads; ++i) {
      readers_.emplace_back(&Loader::reader_main, this, i);
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_data_.notify_all();
    for (auto& t : readers_) t.join();
  }

  // Fill out[batch * dim] float32.  Returns frames written (0 = exhausted).
  //
  // The stream's first draw waits until the pool is full or the readers are
  // done, as the NumPy stream does (data/shards.py): drawing as soon as one
  // reader has pushed its first chunk would fill the first batches from
  // that reader's shards alone.
  //
  // The lock covers only the index draws and the f16 row moves into a
  // staging buffer; the f16->f32 conversion runs outside it as one linear
  // pass (F16C hardware conversion where available), while readers refill
  // the pool.
  int64_t next(float* out) {
    staging_.resize((size_t)batch_ * dim_);
    int64_t produced = 0;
    {
      std::unique_lock<std::mutex> lk(mu_);
      for (; produced < batch_; ++produced) {
        cv_data_.wait(lk, [&] {
          return stop_ || done_reading_ || pool_size_ == pool_capacity_ ||
                 (primed_ && pool_size_ > 0);
        });
        primed_ = true;
        if (stop_) break;
        if (pool_size_ == 0) break;  // exhausted (non-repeat end of corpus)
        // Draw a uniformly random pooled frame; backfill the hole with the
        // last frame so the pool stays dense.
        std::uniform_int_distribution<int64_t> pick(0, pool_size_ - 1);
        int64_t j = pick(rng_);
        std::memcpy(&staging_[(size_t)produced * dim_],
                    &pool_[(size_t)j * dim_], (size_t)dim_ * sizeof(uint16_t));
        --pool_size_;
        if (j != pool_size_) {
          std::memcpy(&pool_[(size_t)j * dim_],
                      &pool_[(size_t)pool_size_ * dim_],
                      (size_t)dim_ * sizeof(uint16_t));
        }
      }
      cv_space_.notify_all();
    }
    convert_f16_block(staging_.data(), out, produced * dim_);
    return produced;
  }

 private:
  void reader_main(int tid) {
    std::mt19937_64 order_rng(0x9e3779b97f4a7c15ull ^ (uint64_t)tid);
    std::vector<uint16_t> buf;
    for (uint64_t epoch = 0;; ++epoch) {
      // Per-thread round-robin shard assignment, order reshuffled per epoch.
      std::vector<size_t> order;
      for (size_t i = (size_t)tid; i < shards_.size(); i += (size_t)num_threads_)
        order.push_back(i);
      std::shuffle(order.begin(), order.end(), order_rng);
      if (order.empty()) break;
      for (size_t si : order) {
        const Shard& sh = shards_[si];
        FILE* f = std::fopen(sh.path.c_str(), "rb");
        if (!f) continue;
        const int64_t chunk_frames = 4096;
        buf.resize((size_t)chunk_frames * dim_);
        int64_t remaining = sh.frames;
        while (remaining > 0) {
          int64_t take = remaining < chunk_frames ? remaining : chunk_frames;
          size_t got = std::fread(buf.data(), sizeof(uint16_t) * dim_,
                                  (size_t)take, f);
          if (got == 0) break;
          remaining -= (int64_t)got;
          if (!push_frames(buf.data(), (int64_t)got)) {
            std::fclose(f);
            return;  // stopping
          }
        }
        std::fclose(f);
      }
      if (!repeat_) break;
    }
    std::lock_guard<std::mutex> lk(mu_);
    if (++finished_readers_ == num_threads_) done_reading_ = true;
    cv_data_.notify_all();
  }

  bool push_frames(const uint16_t* frames, int64_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t i = 0;
    while (i < n) {
      cv_space_.wait(lk, [&] { return pool_size_ < pool_capacity_ || stop_; });
      if (stop_) return false;
      // copy as many contiguous frames as fit in one lock hold
      int64_t take = std::min(n - i, pool_capacity_ - pool_size_);
      std::memcpy(&pool_[(size_t)pool_size_ * dim_],
                  frames + (size_t)i * dim_,
                  (size_t)take * dim_ * sizeof(uint16_t));
      pool_size_ += take;
      i += take;
      cv_data_.notify_all();
    }
    return true;
  }

  std::vector<Shard> shards_;
  int64_t dim_, pool_capacity_, batch_;
  bool repeat_;
  int num_threads_;
  std::mt19937_64 rng_;
  std::vector<uint16_t> pool_;
  std::vector<uint16_t> staging_;  // f16 rows drawn this batch (next() only)
  int64_t pool_size_ = 0;
  bool stop_ = false, done_reading_ = false;
  bool primed_ = false;  // the pool has been full once (or reading ended)
  int finished_readers_ = 0;
  std::mutex mu_;
  std::condition_variable cv_space_, cv_data_;
  std::vector<std::thread> readers_;
};

}  // namespace

extern "C" {

void* qtz_loader_create(const char** paths, const int64_t* frames,
                        int64_t num_shards, int64_t dim, int64_t pool_frames,
                        int64_t batch, uint64_t seed, int num_threads,
                        int repeat) {
  std::vector<Shard> shards;
  shards.reserve((size_t)num_shards);
  for (int64_t i = 0; i < num_shards; ++i)
    shards.push_back(Shard{paths[i], frames[i]});
  if (num_threads < 1) num_threads = 1;
  if ((int64_t)num_threads > num_shards && num_shards > 0)
    num_threads = (int)num_shards;
  return new Loader(std::move(shards), dim, pool_frames, batch, seed,
                    num_threads, repeat != 0);
}

int64_t qtz_loader_next(void* loader, float* out) {
  return static_cast<Loader*>(loader)->next(out);
}

void qtz_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
