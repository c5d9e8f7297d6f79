// Native stereo frame loader: decode + rectify + prefetch off the Python
// thread. Equivalent of the reference's C++ app-layer
// ImageInput implementations (SURVEY.md §2.1 "Dataset inputs",
// src/app/*input* [UNVERIFIED — reference mount empty, SURVEY.md §0]).
//
// Design: a small C API (ctypes-friendly) over a producer thread pool that
// decodes PNG/JPG pairs with OpenCV, optionally remaps through
// precomputed rectification maps, converts to float32 [0,255], and parks
// results in a bounded ring buffer. The Python side overlaps device
// compute with host decode by construction (SURVEY.md §3.4: "decode/
// rectify images, feed device via double-buffered device_put").
//
// Build: make -C native   (g++ + system OpenCV; see native/Makefile)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Frame {
  int64_t index;
  double timestamp;
  cv::Mat left;   // CV_32F
  cv::Mat right;  // CV_32F
  bool ok;
};

struct Loader {
  std::vector<std::string> left_paths;
  std::vector<std::string> right_paths;
  std::vector<double> timestamps;
  int width = 0, height = 0;

  // optional rectification maps (CV_32FC1 x4)
  cv::Mat map0x, map0y, map1x, map1y;
  bool rectify = false;

  // bounded reorder buffer: frames decoded by the pool, drained in order
  std::mutex mu;
  std::condition_variable cv_produced;
  std::condition_variable cv_space;
  std::deque<Frame> ready;          // sorted by index on insert
  int64_t next_to_emit = 0;
  int64_t next_to_schedule = 0;
  size_t capacity = 8;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_space.notify_all();
    cv_produced.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  Frame decode(int64_t i) {
    Frame f;
    f.index = i;
    f.timestamp = timestamps[i];
    cv::Mat l = cv::imread(left_paths[i], cv::IMREAD_GRAYSCALE);
    cv::Mat r = cv::imread(right_paths[i], cv::IMREAD_GRAYSCALE);
    f.ok = !l.empty() && !r.empty();
    if (!f.ok) return f;
    if (rectify) {
      cv::Mat lr, rr;
      cv::remap(l, lr, map0x, map0y, cv::INTER_LINEAR);
      cv::remap(r, rr, map1x, map1y, cv::INTER_LINEAR);
      l = lr;
      r = rr;
    }
    l.convertTo(f.left, CV_32F);
    r.convertTo(f.right, CV_32F);
    return f;
  }

  void worker() {
    for (;;) {
      int64_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() ||
                 (next_to_schedule < (int64_t)left_paths.size() &&
                  next_to_schedule < next_to_emit + (int64_t)capacity);
        });
        if (stop.load()) return;
        i = next_to_schedule++;
      }
      Frame f = decode(i);
      {
        std::unique_lock<std::mutex> lk(mu);
        auto pos = ready.begin();
        while (pos != ready.end() && pos->index < f.index) ++pos;
        ready.insert(pos, std::move(f));
      }
      cv_produced.notify_all();
    }
  }

  void start(int n_threads) {
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { worker(); });
  }

  // Blocking in-order pop; returns false at end of stream.
  bool next(float* left, float* right, double* ts) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= (int64_t)left_paths.size()) return false;
    cv_produced.wait(lk, [&] {
      return stop.load() ||
             (!ready.empty() && ready.front().index == next_to_emit);
    });
    if (stop.load()) return false;
    Frame f = std::move(ready.front());
    ready.pop_front();
    ++next_to_emit;
    lk.unlock();
    cv_space.notify_all();
    if (!f.ok) {  // unreadable frame: emit zeros rather than desync
      std::memset(left, 0, sizeof(float) * width * height);
      std::memset(right, 0, sizeof(float) * width * height);
    } else {
      std::memcpy(left, f.left.ptr<float>(),
                  sizeof(float) * width * height);
      std::memcpy(right, f.right.ptr<float>(),
                  sizeof(float) * width * height);
    }
    *ts = f.timestamp;
    return true;
  }
};

}  // namespace

extern "C" {

// Create a loader over explicit path lists (the Python side enumerates the
// dataset layout — EuRoC csv, KITTI dirs — and hands us flat lists; path
// parsing stays in one place, the hot decode loop is native).
void* fl_create(const char** lefts, const char** rights,
                const double* stamps, int64_t n, int width, int height,
                int n_threads, int prefetch) {
  auto* L = new Loader();
  L->left_paths.assign(lefts, lefts + n);
  L->right_paths.assign(rights, rights + n);
  L->timestamps.assign(stamps, stamps + n);
  L->width = width;
  L->height = height;
  L->capacity = prefetch > 0 ? (size_t)prefetch : 8;
  L->start(n_threads > 0 ? n_threads : 2);
  return L;
}

// Optional rectification maps (row-major float32, H*W each).
void fl_set_rectify(void* h, const float* m0x, const float* m0y,
                    const float* m1x, const float* m1y) {
  auto* L = static_cast<Loader*>(h);
  int W = L->width, H = L->height;
  L->map0x = cv::Mat(H, W, CV_32F, const_cast<float*>(m0x)).clone();
  L->map0y = cv::Mat(H, W, CV_32F, const_cast<float*>(m0y)).clone();
  L->map1x = cv::Mat(H, W, CV_32F, const_cast<float*>(m1x)).clone();
  L->map1y = cv::Mat(H, W, CV_32F, const_cast<float*>(m1y)).clone();
  L->rectify = true;
}

int fl_next(void* h, float* left, float* right, double* ts) {
  return static_cast<Loader*>(h)->next(left, right, ts) ? 1 : 0;
}

void fl_destroy(void* h) { delete static_cast<Loader*>(h); }

int fl_version() { return 1; }
}
