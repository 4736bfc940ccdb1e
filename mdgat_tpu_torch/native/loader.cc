// Native threaded keypoint-batch loader.
//
// Replaces the reference's torch DataLoader(num_workers=10) fork pool
// (train.py:215-216) with an in-process pthread pool: each worker reads a
// keypoint .bin file (37-float rows: x,y,z,score,fpfh[33] —
// load_data.py:127-137), applies the score>threshold filter and the
// truncate-or-duplicate-pad policy (load_data.py:180-214), and writes
// directly into the caller's pre-allocated batch buffers — zero Python in
// the per-file path, no process forks, no pickling.
//
// A copy of the JAX package's loader (mdgat_tpu/native/loader.cc): the port
// imports nothing of that package. Exposed via a C ABI for ctypes; see
// mdgat_tpu_torch/native/loader.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kRow = 37;   // floats per keypoint row
constexpr int kDesc = 33;  // FPFH descriptor dims

// Load one file into the (kp, score, desc) slices for slot i.
// Returns number of valid keypoints written (<= max_kpts), or -1 on error.
int load_one(const char* path, int max_kpts, int ensure, float score_min,
             float* kp, float* score, float* desc) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n_rows = bytes / (kRow * sizeof(float));
  std::vector<float> raw(n_rows * kRow);
  size_t got = fread(raw.data(), sizeof(float), raw.size(), f);
  fclose(f);
  if (got != raw.size()) return -1;

  // gather pointers to kept rows
  std::vector<const float*> rows;
  rows.reserve(n_rows);
  for (long r = 0; r < n_rows; ++r) {
    const float* p = raw.data() + r * kRow;
    if (!ensure || p[3] > score_min) rows.push_back(p);
  }
  long n = static_cast<long>(rows.size());

  if (ensure) {
    // reference pad: repeatedly prepend the first (target-len) rows
    // (load_data.py:197-211). Materialize the same final ordering.
    if (n == 0) {
      // Every row failed the score filter: zero-fill with count 0 — the
      // Python path's empty-frame contract (duplicate_pad zero-fill +
      // all-false mask -> the model's no-keypoint early-out, N8). -1 is
      // reserved for genuine read failures.
    } else if (n > max_kpts) {
      rows.resize(max_kpts);
      n = max_kpts;
    } else {
      while (static_cast<long>(rows.size()) < max_kpts) {
        long take = max_kpts - static_cast<long>(rows.size());
        std::vector<const float*> head(
            rows.begin(),
            rows.begin() + (take < (long)rows.size() ? take
                                                     : (long)rows.size()));
        rows.insert(rows.begin(), head.begin(), head.end());
      }
      n = max_kpts;
    }
  } else if (n > max_kpts) {
    n = max_kpts;  // caller sized the buffer; report truncation via count
  }

  for (long r = 0; r < n; ++r) {
    const float* p = rows[r];
    kp[r * 3 + 0] = p[0];
    kp[r * 3 + 1] = p[1];
    kp[r * 3 + 2] = p[2];
    score[r] = p[3];
    memcpy(desc + r * kDesc, p + 4, kDesc * sizeof(float));
  }
  // zero-fill the padded tail (mask semantics for ensure==0)
  for (long r = n; r < max_kpts; ++r) {
    memset(kp + r * 3, 0, 3 * sizeof(float));
    score[r] = 0.f;
    memset(desc + r * kDesc, 0, kDesc * sizeof(float));
  }
  return static_cast<int>(n);
}

}  // namespace

extern "C" {

// Batched load: n_files files into [n_files, max_kpts, ...] buffers.
// counts[i] = valid keypoints for slot i; 0 = every row score-filtered
// (slot zero-filled); -1 = read failure.
// Returns 0 on success (individual errors reported via counts).
int mdgat_load_batch(const char** paths, int n_files, int max_kpts,
                     int ensure, float score_min, int n_threads,
                     float* kp_out, float* score_out, float* desc_out,
                     int* counts) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      counts[i] = load_one(paths[i], max_kpts, ensure, score_min,
                           kp_out + static_cast<long>(i) * max_kpts * 3,
                           score_out + static_cast<long>(i) * max_kpts,
                           desc_out + static_cast<long>(i) * max_kpts * kDesc);
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads < n_files ? n_threads : n_files;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
