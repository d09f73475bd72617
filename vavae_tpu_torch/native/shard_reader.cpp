// Threaded, mmap-backed batch assembler over safetensors latent shards.
//
// The DiT trainer's batch reader: each shard is memory-mapped once, and a
// batch is gathered by a pool of threads that copy each item's (C, H, W)
// latents (or their flipped twin) into the caller's (B, H, W, C) float32
// buffer, normalising on the way, and read its label.
//
// The arithmetic is the Python reference's (ImgLatentDataset.reference_batch
// in data/latent_dataset.py), in its order and in float32: v = x;
// v = v - mean[c]; v = v / std[c] (when normalising); v = v * multiplier.
// Built with -ffp-contract=off, so no step is fused.
//
// The shards' headers are read in Python, which hands over each tensor's
// offset in its file; this side checks them against the file's size.
//
// C interface (ctypes, vavae_tpu_torch/data/native_loader.py):
//   shard_reader_open(n, paths, rows, lat_off, flip_off, lab_off, lab_bytes,
//                     item, err, errlen)                          -> handle or NULL
//   shard_reader_batch(handle, indices, flip, B, mean, std, normalize,
//                      multiplier, C, HW, out, labels, threads, err, errlen) -> 0 or -1
//   shard_reader_close(handle)

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Shard {
  void* map = nullptr;
  size_t size = 0;
  const uint8_t* base = nullptr;
  int64_t rows = 0, lat = 0, flip = 0, lab = 0;
  int lab_bytes = 0;
};

struct Reader {
  std::vector<Shard> shards;
  std::vector<int32_t> shard_of;  // global row -> shard
  std::vector<int64_t> row_of;    // global row -> row in its shard
  int64_t item = 0;               // floats of one latent
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

void release(Reader* r) {
  for (auto& s : r->shards)
    if (s.map) munmap(s.map, s.size);
  delete r;
}

}  // namespace

extern "C" {

void* shard_reader_open(int n, const char** paths, const int64_t* rows, const int64_t* lat_off,
                        const int64_t* flip_off, const int64_t* lab_off,
                        const int32_t* lab_bytes, int64_t item, char* err, int errlen) {
  auto* r = new Reader();
  r->item = item;
  for (int i = 0; i < n; ++i) {
    const int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      set_error(err, errlen, std::string(paths[i]) + ": cannot open: " + std::strerror(errno));
      release(r);
      return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      close(fd);
      set_error(err, errlen, std::string(paths[i]) + ": cannot stat, or empty");
      release(r);
      return nullptr;
    }
    void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (map == MAP_FAILED) {
      set_error(err, errlen, std::string(paths[i]) + ": mmap failed: " + std::strerror(errno));
      release(r);
      return nullptr;
    }
    Shard s;
    s.map = map;
    s.size = static_cast<size_t>(st.st_size);
    s.base = static_cast<const uint8_t*>(map);
    s.rows = rows[i];
    s.lat = lat_off[i];
    s.flip = flip_off[i];
    s.lab = lab_off[i];
    s.lab_bytes = lab_bytes[i];
    r->shards.push_back(s);
    const auto fits = [&](int64_t off, int64_t bytes) {
      return off >= 0 && bytes >= 0 && static_cast<uint64_t>(off) + bytes <= s.size;
    };
    const int64_t lat_bytes = s.rows * item * 4;
    if (!fits(s.lat, lat_bytes) || !fits(s.flip, lat_bytes) ||
        !fits(s.lab, s.rows * s.lab_bytes) || (s.lab_bytes != 4 && s.lab_bytes != 8)) {
      set_error(err, errlen, std::string(paths[i]) + ": tensors run past the end of the file");
      release(r);
      return nullptr;
    }
    for (int64_t row = 0; row < s.rows; ++row) {
      r->shard_of.push_back(i);
      r->row_of.push_back(row);
    }
  }
  return r;
}

int64_t shard_reader_len(void* h) { return static_cast<int64_t>(static_cast<Reader*>(h)->row_of.size()); }

int shard_reader_batch(void* h, const int64_t* indices, const uint8_t* flip, int batch,
                       const float* mean, const float* std_, int normalize, float multiplier,
                       int64_t C, int64_t HW, float* out, int32_t* labels, int n_threads,
                       char* err, int errlen) {
  auto* r = static_cast<Reader*>(h);
  const int64_t n = static_cast<int64_t>(r->row_of.size());
  if (C * HW != r->item) {
    set_error(err, errlen, "latent shape does not match the shards");
    return -1;
  }
  for (int b = 0; b < batch; ++b)
    if (indices[b] < 0 || indices[b] >= n) {
      set_error(err, errlen, "index " + std::to_string(indices[b]) + " out of range [0, " +
                                 std::to_string(n) + ")");
      return -1;
    }
  int threads = n_threads > 0 ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, batch));
  auto work = [&](int t) {
    for (int b = t; b < batch; b += threads) {
      const Shard& s = r->shards[r->shard_of[indices[b]]];
      const int64_t row = r->row_of[indices[b]];
      const float* src = reinterpret_cast<const float*>(s.base + (flip[b] ? s.flip : s.lat)) +
                         row * r->item;
      float* dst = out + static_cast<int64_t>(b) * r->item;
      for (int64_t c = 0; c < C; ++c) {
        const float* sc = src + c * HW;
        const float m = normalize ? mean[c] : 0.0f, sd = normalize ? std_[c] : 1.0f;
        for (int64_t i = 0; i < HW; ++i) {
          float v;
          std::memcpy(&v, sc + i, 4);  // the map's offsets need not be 4-aligned
          if (normalize) {
            v = v - m;
            v = v / sd;
          }
          v = v * multiplier;
          dst[i * C + c] = v;
        }
      }
      const uint8_t* lp = s.base + s.lab + row * s.lab_bytes;
      if (s.lab_bytes == 8) {
        int64_t v;
        std::memcpy(&v, lp, 8);
        labels[b] = static_cast<int32_t>(v);
      } else {
        int32_t v;
        std::memcpy(&v, lp, 4);
        labels[b] = v;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  return 0;
}

void shard_reader_close(void* h) {
  if (h) release(static_cast<Reader*>(h));
}

}  // extern "C"
