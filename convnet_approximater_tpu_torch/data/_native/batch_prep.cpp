// Host batch preparation for the port's Loader (the port's copy of
// convnet_approximater_tpu/data/_native/batch_prep.cpp).
//
// A uint8 (N, H, W, C) image pool is gathered at a batch's indices,
// optionally cropped (a source rectangle, reflected at the borders) and
// flipped, and nearest-resized to (th, tw), by a few threads per call that
// Python reaches through ctypes without the GIL (data/native.py).  Four entry
// points:
//
//   cat_prep_batch, cat_prep_batch_aug     write float32, normalized per
//       channel as x * (1 / std) + (-mean / std): the JAX library's functions
//       and arithmetic, kept bit for bit (serve.py's host-normalizing loader);
//   cat_gather_batch, cat_gather_batch_aug the same gather, crop, flip and
//       resize, stopping before the normalization: they write uint8, which
//       the Loader ships and normalizes on the card.
//
// The crop and flip parameters come from the Loader's draw_aug_params; the
// results equal its numpy apply_aug.  Each entry returns 0 on success, 1 on
// bad sizes and 2 when a worker thread cannot start.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC -ffp-contract=off -o libbatch_prep.so batch_prep.cpp -lpthread
// (no -march=native: the float32 entries keep the JAX library's roundings).

#include <cstdint>
#include <cstring>
#include <exception>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

struct Job {
  const uint8_t* images;  // (N, H, W, C) source pool
  const int64_t* indices; // (n,) rows to gather
  int n, H, W, C;         // batch size and source geometry
  int th, tw;             // target geometry
  const float* mean;      // (C,) on the 0..255 scale; null for the uint8 entries
  const float* std_;      // (C,)
  const int64_t* y0;      // (n,) crop-rect origin, may be negative; null without aug
  const int64_t* x0;      // (n,)
  const int64_t* ch;      // (n,) crop-rect height
  const int64_t* cw;      // (n,) crop-rect width
  const uint8_t* flip;    // (n,) horizontal-flip flags
  void* out;              // (n, th, tw, C) float32 or uint8
};

inline int reflect_index(int64_t v, int size) {
  // numpy pad(mode='reflect') semantics: -k -> k, size-1+k -> size-1-k
  if (v < 0) v = -v;
  if (v > size - 1) v = 2 * (int64_t)(size - 1) - v;
  if (v < 0) v = 0;
  if (v > size - 1) v = size - 1;
  return (int)v;
}

// The source row and column of every target row and column of image i: the
// nearest resize of the whole image, or of its crop rectangle with the flip.
void source_maps(const Job& job, int i, std::vector<int>& rmap, std::vector<int>& cmap) {
  if (job.y0 == nullptr) {
    for (int r = 0; r < job.th; ++r) rmap[r] = (int)((int64_t)r * job.H / job.th);
    for (int c = 0; c < job.tw; ++c) cmap[c] = (int)((int64_t)c * job.W / job.tw);
    return;
  }
  const int64_t chi = job.ch[i], cwi = job.cw[i];
  for (int r = 0; r < job.th; ++r)
    rmap[r] = reflect_index(job.y0[i] + ((int64_t)r * chi) / job.th, job.H);
  const bool fl = job.flip[i] != 0;
  for (int c = 0; c < job.tw; ++c) {
    int64_t cs = fl ? (job.tw - 1 - c) : c;
    cmap[c] = reflect_index(job.x0[i] + (cs * cwi) / job.tw, job.W);
  }
}

// Runs of target columns that read consecutive source columns: (target
// column, source column, length).  The uint8 entries copy each run of a row
// with memcpy where the runs are long (no flip), else pixel by pixel.
struct Run {
  int dst, src, len;
};

void column_runs(const std::vector<int>& cmap, std::vector<Run>& runs) {
  runs.clear();
  const int n = (int)cmap.size();
  for (int c = 0; c < n;) {
    int start = c;
    while (c + 1 < n && cmap[c + 1] == cmap[c] + 1) ++c;
    runs.push_back({start, cmap[start], c - start + 1});
    ++c;
  }
}

// Images [begin, end): float32 normalized (Normalize) or uint8 as gathered.
template <bool Normalize>
void prep_range(const Job& job, int begin, int end) {
  using Out = typename std::conditional<Normalize, float, uint8_t>::type;
  const int64_t src_img = (int64_t)job.H * job.W * job.C;
  const int64_t dst_img = (int64_t)job.th * job.tw * job.C;
  std::vector<float> scale(job.C), shift(job.C);
  if constexpr (Normalize) {
    for (int c = 0; c < job.C; ++c) {
      scale[c] = 1.0f / job.std_[c];
      shift[c] = -job.mean[c] / job.std_[c];
    }
  }
  std::vector<int> rmap(job.th), cmap(job.tw);
  std::vector<Run> runs;
  const bool maps_per_image = job.y0 != nullptr;
  bool copy_runs = false, whole = false;
  auto plan = [&](int i) {
    source_maps(job, i, rmap, cmap);
    if (Normalize) return;
    column_runs(cmap, runs);
    copy_runs = 4 * runs.size() <= (size_t)job.tw;
    // every row in order over the full width: the image is one block
    whole = runs.size() == 1 && job.tw == job.W && cmap[0] == 0;
    for (int r = 1; whole && r < job.th; ++r) whole = rmap[r] == rmap[r - 1] + 1;
  };
  if (!maps_per_image) plan(0);
  for (int i = begin; i < end; ++i) {
    const uint8_t* src = job.images + job.indices[i] * src_img;
    Out* dst = static_cast<Out*>(job.out) + (int64_t)i * dst_img;
    if (maps_per_image) plan(i);
    if (whole) {
      std::memcpy(dst, src + (int64_t)rmap[0] * job.W * job.C, (size_t)dst_img);
      continue;
    }
    for (int r = 0; r < job.th; ++r) {
      const uint8_t* srow = src + (int64_t)rmap[r] * job.W * job.C;
      Out* drow = dst + (int64_t)r * job.tw * job.C;
      if (copy_runs) {
        for (const Run& run : runs)
          std::memcpy(drow + (int64_t)run.dst * job.C, srow + (int64_t)run.src * job.C,
                      (size_t)run.len * job.C);
        continue;
      }
      for (int c2 = 0; c2 < job.tw; ++c2) {
        const uint8_t* sp = srow + (int64_t)cmap[c2] * job.C;
        Out* dp = drow + (int64_t)c2 * job.C;
        for (int c = 0; c < job.C; ++c) {
          if constexpr (Normalize)
            dp[c] = sp[c] * scale[c] + shift[c];
          else
            dp[c] = sp[c];
        }
      }
    }
  }
}

// Split the batch into equal chunks over at most num_threads threads.
template <bool Normalize>
int run(const Job& job, int num_threads) {
  if (job.n <= 0 || job.H <= 0 || job.W <= 0 || job.C <= 0 || job.th <= 0 || job.tw <= 0)
    return 1;
  if (num_threads <= 1 || job.n == 1) {
    prep_range<Normalize>(job, 0, job.n);
    return 0;
  }
  int workers = num_threads < job.n ? num_threads : job.n;
  int chunk = (job.n + workers - 1) / workers;
  std::vector<std::thread> pool;
  int rc = 0;
  try {
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      int b = w * chunk, e = b + chunk < job.n ? b + chunk : job.n;
      if (b >= e) break;
      pool.emplace_back([&job, b, e] { prep_range<Normalize>(job, b, e); });
    }
  } catch (const std::exception&) {
    rc = 2;  // the threads that did start still finish before the caller's buffers go
  }
  for (auto& t : pool) t.join();
  return rc;
}

}  // namespace

extern "C" {

// Gather + (nearest) resize + normalize a batch to float32.
int cat_prep_batch(const uint8_t* images, const int64_t* indices, int n, int H, int W, int C,
                   int th, int tw, const float* mean, const float* std_, float* out,
                   int num_threads) {
  Job job{images, indices, n, H, W, C, th, tw, mean, std_,
          nullptr, nullptr, nullptr, nullptr, nullptr, out};
  return run<true>(job, num_threads);
}

// Gather + crop rect (reflect at borders) + flip + nearest resize + normalize to float32.
int cat_prep_batch_aug(const uint8_t* images, const int64_t* indices, int n, int H, int W,
                       int C, int th, int tw, const float* mean, const float* std_,
                       const int64_t* y0, const int64_t* x0, const int64_t* ch,
                       const int64_t* cw, const uint8_t* flip, float* out, int num_threads) {
  Job job{images, indices, n, H, W, C, th, tw, mean, std_, y0, x0, ch, cw, flip, out};
  return run<true>(job, num_threads);
}

// Gather + (nearest) resize a batch, uint8 out.
int cat_gather_batch(const uint8_t* images, const int64_t* indices, int n, int H, int W, int C,
                     int th, int tw, uint8_t* out, int num_threads) {
  Job job{images, indices, n, H, W, C, th, tw, nullptr, nullptr,
          nullptr, nullptr, nullptr, nullptr, nullptr, out};
  return run<false>(job, num_threads);
}

// Gather + crop rect (reflect at borders) + flip + nearest resize, uint8 out.
int cat_gather_batch_aug(const uint8_t* images, const int64_t* indices, int n, int H, int W,
                         int C, int th, int tw, const int64_t* y0, const int64_t* x0,
                         const int64_t* ch, const int64_t* cw, const uint8_t* flip,
                         uint8_t* out, int num_threads) {
  Job job{images, indices, n, H, W, C, th, tw, nullptr, nullptr, y0, x0, ch, cw, flip, out};
  return run<false>(job, num_threads);
}

}  // extern "C"
