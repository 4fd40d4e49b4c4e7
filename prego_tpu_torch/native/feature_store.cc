// Native feature store: mmap'd .npy feature files + parallel window gather
// (the port's copy of prego_tpu/native/feature_store.cc).
//
// Replaces the reference's host-side data path (torch DataLoader with 4
// worker *processes* copying python objects, step_recognition/datasets/
// dataset_builder.py:15-24) with an in-process engine:
//   * each per-video .npy (rgb/flow/target) is mmap'd once — the OS page
//     cache is the working set, nothing is eagerly loaded;
//   * training batches (B, W, D) are assembled by a pthread pool doing
//     straight memcpy from the mapped pages into a caller-provided buffer
//     (a torch tensor's storage handed over by its data pointer: pinned
//     host memory when the batch goes to the card, so its copy can run
//     asynchronously; zero Python-side copies);
//   * supports <f4 (copied) and <f8 (converted to f32) C-ordered arrays.
//
// Exposed as a plain C ABI for ctypes; built with g++ on first use by
// prego_tpu_torch/native/store.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <pthread.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  void* base = nullptr;       // mmap base
  size_t map_len = 0;         // total mapped length
  const char* data = nullptr; // start of array payload
  int64_t rows = 0;
  int64_t cols = 0;
  int itemsize = 0;           // 4 (<f4) or 8 (<f8)
};

struct Store {
  std::vector<Mapped> files;
};

// Minimal .npy header parser (format spec v1/v2): returns false on
// unsupported layouts (fortran order, non-float dtypes, ndim != 2).
bool parse_npy(const char* buf, size_t len, Mapped* out) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  unsigned major = (unsigned char)buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = (unsigned char)buf[8] | ((unsigned char)buf[9] << 8);
    header_off = 10;
  } else {
    header_len = (unsigned char)buf[8] | ((unsigned char)buf[9] << 8) |
                 ((unsigned char)buf[10] << 16) |
                 ((unsigned char)buf[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string header(buf + header_off, header_len);

  if (header.find("'fortran_order': False") == std::string::npos) return false;
  int itemsize;
  if (header.find("'<f4'") != std::string::npos) itemsize = 4;
  else if (header.find("'<f8'") != std::string::npos) itemsize = 8;
  else return false;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t open = header.find('(', sp), close = header.find(')', sp);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);
  int64_t rows = 0, cols = 1;
  int parsed = sscanf(shape.c_str(), "%ld, %ld", &rows, &cols);
  if (parsed < 1) return false;
  if (parsed == 1) cols = 1;  // 1-D arrays become (rows, 1)

  out->data = buf + header_off + header_len;
  out->rows = rows;
  out->cols = cols;
  out->itemsize = itemsize;
  return true;
}

struct GatherTask {
  const Store* store;
  const int32_t* vid_idx;   // (count,)
  const int64_t* starts;    // (count,)
  int64_t count;
  int64_t window;
  float* out;               // (count, window, D)
  int64_t out_stride;       // window * D floats per item
  // work partition
  int64_t begin, end;
};

void* gather_worker(void* arg) {
  GatherTask* t = static_cast<GatherTask*>(arg);
  for (int64_t i = t->begin; i < t->end; ++i) {
    const Mapped& m = t->store->files[t->vid_idx[i]];
    int64_t start = t->starts[i];
    int64_t n = t->window;
    float* dst = t->out + i * t->out_stride;
    // rows outside [0, rows) are zero-filled — this expresses the
    // reference's zero-row training prefix (dataset.py:53-55) without
    // materializing padded copies: callers pass virtual (negative) starts
    int64_t lead = start < 0 ? std::min(-start, n) : 0;
    int64_t src_start = start + lead;
    int64_t copy = std::min(n - lead, m.rows - src_start);
    if (copy < 0) copy = 0;
    int64_t tail = n - lead - copy;
    if (lead) memset(dst, 0, lead * m.cols * sizeof(float));
    if (copy) {
      float* cdst = dst + lead * m.cols;
      if (m.itemsize == 4) {
        memcpy(cdst, m.data + src_start * m.cols * 4,
               copy * m.cols * sizeof(float));
      } else {
        const double* src =
            reinterpret_cast<const double*>(m.data + src_start * m.cols * 8);
        for (int64_t j = 0; j < copy * m.cols; ++j) cdst[j] = (float)src[j];
      }
    }
    if (tail)
      memset(dst + (lead + copy) * m.cols, 0, tail * m.cols * sizeof(float));
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Open n .npy files; returns a store handle or nullptr. Per-file status
// written to ok[i] (1 = mapped, 0 = failed/unsupported — slot is a zero
// stub so indices stay aligned with the caller's list).
void* fs_open(const char** paths, int32_t n, int32_t* ok) {
  Store* s = new Store();
  s->files.resize(n);
  for (int i = 0; i < n; ++i) {
    ok[i] = 0;
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) continue;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 16) { close(fd); continue; }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) continue;
    Mapped m;
    if (!parse_npy(static_cast<const char*>(base), st.st_size, &m)) {
      munmap(base, st.st_size);
      continue;
    }
    m.base = base;
    m.map_len = st.st_size;
    s->files[i] = m;
    ok[i] = 1;
  }
  return s;
}

// rows/cols of file i (0 if unmapped).
void fs_dims(void* handle, int32_t i, int64_t* rows, int64_t* cols) {
  Store* s = static_cast<Store*>(handle);
  *rows = s->files[i].rows;
  *cols = s->files[i].cols;
}

// Gather `count` windows of `window` rows each into out (count, window, D)
// float32, using up to n_threads POSIX threads.
void fs_gather_windows(void* handle, const int32_t* vid_idx,
                       const int64_t* starts, int64_t count, int64_t window,
                       int64_t dim, float* out, int32_t n_threads) {
  Store* s = static_cast<Store*>(handle);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > count) n_threads = (int32_t)count;
  std::vector<GatherTask> tasks(n_threads);
  std::vector<pthread_t> threads(n_threads);
  int64_t per = (count + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    tasks[t] = GatherTask{s,     vid_idx, starts, count, window,
                          out,   window * dim,
                          t * per, std::min<int64_t>((t + 1) * per, count)};
    pthread_create(&threads[t], nullptr, gather_worker, &tasks[t]);
  }
  for (int32_t t = 0; t < n_threads; ++t) pthread_join(threads[t], nullptr);
}

// ---- asynchronous (prefetching) gather ----
//
// The synchronous gather leaves the pthread pool idle while the accelerator
// runs the step; the async variant kicks the same gather off on a detached
// runner so the NEXT batch is assembled during the CURRENT step (classic
// double buffering — the python loader owns two output buffers). The index
// arrays are copied into the ticket; the output buffer must stay alive
// until fs_gather_wait.

struct AsyncGather {
  Store* store;
  std::vector<int32_t> vid_idx;
  std::vector<int64_t> starts;
  int64_t window, dim;
  float* out;
  int32_t n_threads;
  pthread_t thread;
};

static void* async_runner(void* arg) {
  AsyncGather* a = static_cast<AsyncGather*>(arg);
  fs_gather_windows(a->store, a->vid_idx.data(), a->starts.data(),
                    (int64_t)a->vid_idx.size(), a->window, a->dim, a->out,
                    a->n_threads);
  return nullptr;
}

// Start a background gather; returns a ticket to pass to fs_gather_wait.
void* fs_gather_windows_async(void* handle, const int32_t* vid_idx,
                              const int64_t* starts, int64_t count,
                              int64_t window, int64_t dim, float* out,
                              int32_t n_threads) {
  AsyncGather* a = new AsyncGather();
  a->store = static_cast<Store*>(handle);
  a->vid_idx.assign(vid_idx, vid_idx + count);
  a->starts.assign(starts, starts + count);
  a->window = window;
  a->dim = dim;
  a->out = out;
  a->n_threads = n_threads;
  pthread_create(&a->thread, nullptr, async_runner, a);
  return a;
}

// Block until the ticket's gather has fully written its output buffer.
void fs_gather_wait(void* ticket) {
  AsyncGather* a = static_cast<AsyncGather*>(ticket);
  pthread_join(a->thread, nullptr);
  delete a;
}

// Copy whole file i into out (rows*cols f32) — full-video eval packing.
void fs_read_all(void* handle, int32_t i, float* out) {
  Store* s = static_cast<Store*>(handle);
  const Mapped& m = s->files[i];
  if (!m.data) return;
  if (m.itemsize == 4) {
    memcpy(out, m.data, m.rows * m.cols * sizeof(float));
  } else {
    const double* src = reinterpret_cast<const double*>(m.data);
    for (int64_t j = 0; j < m.rows * m.cols; ++j) out[j] = (float)src[j];
  }
}

// Copy rows [start, start+count) of file i into out (count*cols f32),
// clamped to the file; rows outside are zero-filled. Lazy chunked eval.
void fs_read_rows(void* handle, int32_t i, int64_t start, int64_t count,
                  float* out) {
  Store* s = static_cast<Store*>(handle);
  const Mapped& m = s->files[i];
  if (!m.data) {
    memset(out, 0, count * sizeof(float));
    return;
  }
  int64_t lead = start < 0 ? std::min(-start, count) : 0;
  int64_t src_start = start + lead;
  int64_t copy = std::min(count - lead, m.rows - src_start);
  if (copy < 0) copy = 0;
  int64_t tail = count - lead - copy;
  if (lead) memset(out, 0, lead * m.cols * sizeof(float));
  if (copy) {
    float* dst = out + lead * m.cols;
    if (m.itemsize == 4) {
      memcpy(dst, m.data + src_start * m.cols * 4,
             copy * m.cols * sizeof(float));
    } else {
      const double* src =
          reinterpret_cast<const double*>(m.data + src_start * m.cols * 8);
      for (int64_t j = 0; j < copy * m.cols; ++j) dst[j] = (float)src[j];
    }
  }
  if (tail) memset(out + (lead + copy) * m.cols, 0, tail * m.cols * sizeof(float));
}

void fs_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  for (auto& m : s->files)
    if (m.base) munmap(m.base, m.map_len);
  delete s;
}

}  // extern "C"
