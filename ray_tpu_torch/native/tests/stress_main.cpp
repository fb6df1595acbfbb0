// Sanitizer + crash-stress harness for the native shm runtime
// (store.cpp robust-mutex arena, channel.cpp mutable-object
// channels). Reference practice: ASAN/TSAN builds in CI
// (SURVEY.md §5.2, .bazelrc asan/tsan configs) plus fault-injection
// of dying clients.
//
// Build/run via ray_tpu_torch/native/run_sanitizers.sh — once under
// -fsanitize=address and once under -fsanitize=thread. The driver
// includes the sources directly so crash tests can reach internal
// structures (Header, Locker) to die while HOLDING the robust mutex.
//
// Exit code 0 = all scenarios passed (and no sanitizer report).

#include "../store.cpp"
#include "../channel.cpp"

#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>
#include <signal.h>

#include <atomic>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,   \
                   __LINE__, #cond);                                  \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

static void make_id(uint8_t* id, int v) {
  std::memset(id, 0, kIdSize);
  std::memcpy(id, &v, sizeof(v));
}

// --- scenario 1: concurrent put/get/delete integrity ---------------------

static void store_concurrency(const char* name) {
  void* h = rts_create(name, 64ull << 20);
  CHECK(h != nullptr);
  std::atomic<int> errors{0};
  auto worker = [&](int tid) {
    void* ha = rts_attach(name);
    if (ha == nullptr) { errors++; return; }
    std::vector<uint8_t> payload(4096 + tid);
    for (size_t i = 0; i < payload.size(); ++i) {
      payload[i] = static_cast<uint8_t>((i * 31 + tid) & 0xff);
    }
    for (int round = 0; round < 200; ++round) {
      uint8_t id[kIdSize];
      make_id(id, tid * 1000 + round);
      if (rts_put(ha, id, payload.data(), payload.size()) < 0) {
        continue;  // arena transiently full is fine
      }
      uint64_t off = 0, size = 0;
      if (rts_get(ha, id, &off, &size) != 1 ||
          size != payload.size()) {
        errors++;
        continue;
      }
      const uint8_t* base = rts_data_ptr(ha);
      if (std::memcmp(base + off, payload.data(), size) != 0) {
        errors++;
      }
      rts_delete(ha, id);
    }
    rts_close_keep_map(ha);
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < 4; ++t) ts.emplace_back(worker, t);
  for (auto& t : ts) t.join();
  CHECK(errors.load() == 0);
  rts_close(h);
  std::printf("store_concurrency OK\n");
}

// --- scenario 2: child dies HOLDING the robust mutex ---------------------

static void store_mutex_crash_recovery(const char* name) {
  void* h = rts_create(name, 8 << 20);
  CHECK(h != nullptr);
  uint8_t id[kIdSize];
  make_id(id, 7);
  uint8_t data[128] = {42};
  CHECK(rts_put(h, id, data, sizeof(data)) >= 0);

  pid_t pid = fork();
  CHECK(pid >= 0);
  if (pid == 0) {
    // Child: take the header mutex and die mid-hold.
    void* ha = rts_attach(name);
    if (ha == nullptr) _exit(2);
    Store* s = static_cast<Store*>(ha);
    pthread_mutex_lock(&s->header->mutex);
    raise(SIGKILL);     // die with the lock held
    _exit(3);           // unreachable
  }
  int status = 0;
  waitpid(pid, &status, 0);
  CHECK(WIFSIGNALED(status) && WTERMSIG(status) == SIGKILL);

  // Parent must recover via EOWNERDEAD + mutex_consistent: every op
  // below would deadlock forever without robust-mutex recovery.
  uint64_t off = 0, size = 0;
  CHECK(rts_get(h, id, &off, &size) == 1);
  CHECK(size == sizeof(data));
  uint8_t id2[kIdSize];
  make_id(id2, 8);
  CHECK(rts_put(h, id2, data, sizeof(data)) >= 0);
  rts_close(h);
  std::printf("store_mutex_crash_recovery OK\n");
}

// --- scenario 3: dead reader's pins are reaped ---------------------------

static void store_dead_pin_reap(const char* name) {
  void* h = rts_create(name, 8 << 20);
  CHECK(h != nullptr);
  uint8_t id[kIdSize];
  make_id(id, 21);
  uint8_t data[256] = {7};
  CHECK(rts_put(h, id, data, sizeof(data)) >= 0);

  pid_t pid = fork();
  CHECK(pid >= 0);
  if (pid == 0) {
    void* ha = rts_attach(name);
    if (ha == nullptr) _exit(2);
    uint64_t off = 0, size = 0;
    if (rts_pin(ha, id, &off, &size) != 1) _exit(4);
    raise(SIGKILL);     // die holding the pin
    _exit(3);
  }
  int status = 0;
  waitpid(pid, &status, 0);
  CHECK(WIFSIGNALED(status));

  CHECK(rts_reap_dead_pins(h) >= 1);   // the dead child's pin
  CHECK(rts_delete(h, id) == 1);       // now deletable
  rts_close(h);
  std::printf("store_dead_pin_reap OK\n");
}

// --- scenario 4: channel writer/reader concurrency + dead reader ---------

static void channel_stress(const char* name) {
  void* w = chn_create(name, 1 << 20);
  CHECK(w != nullptr);

  pid_t pid = fork();
  CHECK(pid >= 0);
  if (pid == 0) {
    // Child reader: register, read one message, then die without
    // unregistering — the writer must not block forever on it.
    void* r = chn_attach(name);
    if (r == nullptr) _exit(2);
    int slot = chn_reader_register(r);
    if (slot < 0) _exit(4);
    uint64_t size = 0, version = 0;
    for (int spin = 0; spin < 4000; ++spin) {
      int rc = chn_read_begin(r, slot, &size, &version, 5);
      if (rc == 0) { chn_read_ack(r, slot, version); break; }
    }
    raise(SIGKILL);
    _exit(3);
  }

  // Wait for the child to register.
  for (int spin = 0; spin < 4000 && chn_reader_count(w) == 0; ++spin) {
    usleep(1000);
  }
  CHECK(chn_reader_count(w) >= 1);

  uint8_t msg[512];
  std::memset(msg, 0xAB, sizeof(msg));
  CHECK(chn_write(w, msg, sizeof(msg), 2000) == 0);

  int status = 0;
  waitpid(pid, &status, 0);

  // Dead reader: subsequent writes must succeed once liveness kicks
  // in (bounded timeout, not forever).
  for (int i = 0; i < 4; ++i) {
    CHECK(chn_write(w, msg, sizeof(msg), 5000) == 0);
  }
  chn_close(w);
  chn_detach(w);
  std::printf("channel_stress OK\n");
}

// --- scenario 5: channel threaded writer+reader (TSAN surface) -----------

static void channel_threads(const char* name) {
  void* w = chn_create(name, 1 << 20);
  CHECK(w != nullptr);
  void* r = chn_attach(name);
  CHECK(r != nullptr);
  int slot = chn_reader_register(r);
  CHECK(slot >= 0);

  std::atomic<int> got{0};
  std::thread reader([&] {
    uint64_t size = 0, version = 0;
    while (got.load() < 100) {
      int rc = chn_read_begin(r, slot, &size, &version, 10);
      if (rc == 0) {
        const uint8_t* p = chn_data_ptr(r);
        CHECK(p[0] == static_cast<uint8_t>(got.load() & 0xff));
        chn_read_ack(r, slot, version);
        got++;
      }
    }
  });
  for (int i = 0; i < 100; ++i) {
    uint8_t msg[64];
    std::memset(msg, i & 0xff, sizeof(msg));
    CHECK(chn_write(w, msg, sizeof(msg), 5000) == 0);
  }
  reader.join();
  CHECK(got.load() == 100);
  chn_reader_unregister(r, slot);
  chn_close(w);
  chn_detach(r);
  chn_detach(w);
  std::printf("channel_threads OK\n");
}

int main() {
  char suffix[64];
  std::snprintf(suffix, sizeof(suffix), "_%d", getpid());
  std::string s1 = std::string("/torch_stress_store1") + suffix;
  std::string s2 = std::string("/torch_stress_store2") + suffix;
  std::string s3 = std::string("/torch_stress_store3") + suffix;
  std::string c1 = std::string("/torch_stress_chan1") + suffix;
  std::string c2 = std::string("/torch_stress_chan2") + suffix;
  store_concurrency(s1.c_str());
  store_mutex_crash_recovery(s2.c_str());
  store_dead_pin_reap(s3.c_str());
  channel_stress(c1.c_str());
  channel_threads(c2.c_str());
  std::printf("ALL STRESS SCENARIOS OK\n");
  return 0;
}
