// Async file loader for the port's replay memory (a copy of the JAX
// package's native/async_loader.cpp, with al_wait added and al_size and
// al_take replaced by al_data and al_release, so that the caller copies
// the bytes once).
//
// A C++ thread pool reads whole files into memory while the caller works,
// behind a minimal C API for ctypes (macarons_tpu_torch/utils/native_loader.py).
// No Python GIL is held during IO: ctypes releases it around every call.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libasync_loader.so async_loader.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<uint8_t> data;
  std::atomic<int> state{0};  // 0 = pending, 1 = done, -1 = error
};

struct Loader {
  std::vector<std::thread> workers;
  std::deque<int64_t> queue;
  std::unordered_map<int64_t, Job*> jobs;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::atomic<int64_t> next_id{1};
  bool stopping = false;

  explicit Loader(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
    for (auto& kv : jobs) delete kv.second;
  }

  void finish(Job* job, int state) {
    {
      std::lock_guard<std::mutex> lock(mu);
      job->state.store(state);
    }
    done_cv.notify_all();
  }

  void run() {
    for (;;) {
      int64_t id;
      Job* job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        id = queue.front();
        queue.pop_front();
        job = jobs.at(id);
      }
      FILE* f = std::fopen(job->path.c_str(), "rb");
      if (!f) {
        finish(job, -1);
        continue;
      }
      std::fseek(f, 0, SEEK_END);
      long size = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      job->data.resize(static_cast<size_t>(size));
      size_t got = std::fread(job->data.data(), 1, job->data.size(), f);
      std::fclose(f);
      finish(job, got == job->data.size() ? 1 : -1);
    }
  }

  int64_t submit(const char* path) {
    int64_t id = next_id.fetch_add(1);
    Job* job = new Job();
    job->path = path;
    {
      std::lock_guard<std::mutex> lock(mu);
      jobs[id] = job;
      queue.push_back(id);
    }
    cv.notify_one();
    return id;
  }

  Job* find(int64_t id) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = jobs.find(id);
    return it == jobs.end() ? nullptr : it->second;
  }

  int wait(int64_t id) {
    std::unique_lock<std::mutex> lock(mu);
    auto it = jobs.find(id);
    if (it == jobs.end()) return -1;
    Job* job = it->second;
    done_cv.wait(lock, [job] { return job->state.load() != 0; });
    return job->state.load();
  }

  void erase(int64_t id) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = jobs.find(id);
    if (it != jobs.end()) {
      delete it->second;
      jobs.erase(it);
    }
  }
};

}  // namespace

extern "C" {

void* al_create(int n_threads) { return new Loader(n_threads); }

void al_destroy(void* l) { delete static_cast<Loader*>(l); }

int64_t al_submit(void* l, const char* path) {
  return static_cast<Loader*>(l)->submit(path);
}

// Blocks until the job has finished; returns 1 (done) or -1 (error, or an
// unknown job).
int al_wait(void* l, int64_t id) { return static_cast<Loader*>(l)->wait(id); }

// The loaded bytes of a finished job (call al_wait first) in *data and their
// count in *size; returns 1, or -1 for a failed or unknown job. Valid until
// al_release.
int al_data(void* l, int64_t id, const void** data, int64_t* size) {
  Job* job = static_cast<Loader*>(l)->find(id);
  if (!job || job->state.load() != 1) return -1;
  *data = job->data.data();
  *size = static_cast<int64_t>(job->data.size());
  return 1;
}

// Frees a job and its bytes.
void al_release(void* l, int64_t id) { static_cast<Loader*>(l)->erase(id); }

}  // extern "C"
