// raytpu_torch_channel — process-shared mutable-object channel (aDAG
// analog), the port's copy of ray_tpu/native/channel.cpp. Host C++, not
// a kernel: it carries host values between the processes of one node.
//
// Re-implements the role of the reference's experimental mutable
// plasma objects (src/ray/core_worker/experimental_mutable_object_
// manager.cc + python/ray/experimental/channel/shared_memory_channel.py):
// a fixed-capacity shared-memory slot that one writer overwrites in
// place and N readers read, with version-gated synchronization:
//
//   - the writer may publish version v+1 only after every registered
//     reader has acknowledged version v (depth-1 bounded buffer — the
//     reference's WriteAcquire blocking on reader semaphores);
//   - each reader sees every version exactly once (ReadAcquire/
//     ReadRelease), reading the payload in place (zero-copy);
//   - liveness: a dead reader's outstanding acks are credited by
//     scanning /proc (the reference releases channels when a reader
//     actor dies); a dead writer turns blocking reads into ECLOSED.
//
// Synchronization is one process-shared robust mutex + one
// process-shared condition variable per channel, embedded in the shm
// header. Plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <cstdio>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// The port's own magic ("RTTC"; the JAX package's segments carry
// "RTCH"): the two packages' libraries never attach each other's
// segments, whose layouts may drift apart.
constexpr uint32_t kChanMagic = 0x52545443;  // "RTTC"
// Bump on ANY ChanHeader/ReaderSlot layout change: attach refuses a
// mismatched segment instead of reading it through the wrong struct
// (processes in one session can otherwise load differently-built
// .so's against the same shm).
constexpr uint32_t kLayoutVersion = 2;
constexpr uint32_t kMaxReaders = 16;

// Return codes (match channel.py).
constexpr int kOk = 0;
constexpr int kClosed = -1;
constexpr int kTimeout = -2;
constexpr int kTooLarge = -3;
constexpr int kError = -4;

struct ReaderSlot {
  int32_t pid;       // 0 = empty
  uint8_t used;
  uint64_t start;    // /proc starttime of pid (guards pid reuse)
  uint64_t acked;    // last version this reader finished reading
};

struct ChanHeader {
  uint32_t magic;
  uint32_t flags;
  pthread_mutex_t mutex;
  pthread_cond_t cv;
  int32_t writer_pid;
  uint64_t writer_start;  // starttime of writer_pid
  uint32_t closed;
  uint64_t capacity;   // payload capacity in bytes
  uint64_t size;       // payload size of the current version
  uint64_t version;    // 0 = nothing written yet
  ReaderSlot readers[kMaxReaders];
};

struct Chan {
  ChanHeader* h;
  uint8_t* base;
  uint64_t map_size;
  int fd;
  bool owner;
  char name[256];
};

// Returns the process's /proc starttime (field 22), or 0 when the
// process is dead/zombie. Pairing (pid, starttime) defeats pid
// reuse: a recycled pid has a different starttime, so a dead reader
// or writer is still detected.
uint64_t chan_proc_start(int32_t pid) {
  char path[64];
  std::snprintf(path, sizeof(path), "/proc/%d/stat", pid);
  FILE* f = std::fopen(path, "r");
  if (f == nullptr) return 0;
  char buf[1024];
  size_t n = std::fread(buf, 1, sizeof(buf) - 1, f);
  std::fclose(f);
  buf[n] = '\0';
  const char* p = std::strrchr(buf, ')');
  if (p == nullptr || p[1] == '\0') return 0;
  char state = p[2] == '\0' ? p[1] : p[2];
  if (state == 'Z' || state == 'X') return 0;
  // p points at ")"; fields after it are state(3) ... starttime(22):
  // skip 20 space-separated fields after the state.
  const char* q = p + 2;
  for (int field = 3; field < 22; ++field) {
    q = std::strchr(q + 1, ' ');
    if (q == nullptr) return 0;
  }
  return std::strtoull(q + 1, nullptr, 10);
}

bool chan_proc_alive(int32_t pid, uint64_t start) {
  uint64_t now = chan_proc_start(pid);
  return now != 0 && now == start;
}

void chan_lock(ChanHeader* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->mutex);
}

// Wait up to quantum_ms on the cv; returns 0 or ETIMEDOUT. Handles a
// lock-holder death during the wait (robust mutex reacquisition).
int chan_wait(ChanHeader* h, long quantum_ms) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  ts.tv_nsec += quantum_ms * 1000000L;
  ts.tv_sec += ts.tv_nsec / 1000000000L;
  ts.tv_nsec %= 1000000000L;
  int rc = pthread_cond_timedwait(&h->cv, &h->mutex, &ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}

double mono_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// Credit acks of readers whose processes died (liveness sweep run
// inside the writer's wait loop). Returns true if anything changed.
bool reap_dead_readers(ChanHeader* h) {
  bool changed = false;
  for (uint32_t i = 0; i < kMaxReaders; ++i) {
    ReaderSlot* r = &h->readers[i];
    if (r->used && !chan_proc_alive(r->pid, r->start)) {
      r->used = 0;
      r->pid = 0;
      changed = true;
    }
  }
  return changed;
}

bool all_readers_acked(ChanHeader* h) {
  for (uint32_t i = 0; i < kMaxReaders; ++i) {
    ReaderSlot* r = &h->readers[i];
    if (r->used && r->acked < h->version) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Create (writer side). Returns handle or null.
void* chn_create(const char* name, uint64_t capacity) {
  uint64_t map_size = sizeof(ChanHeader) + capacity;
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  ChanHeader* h = static_cast<ChanHeader*>(mem);
  std::memset(h, 0, sizeof(ChanHeader));
  h->magic = kChanMagic;
  h->flags = kLayoutVersion;
  h->capacity = capacity;
  h->writer_pid = static_cast<int32_t>(getpid());
  h->writer_start = chan_proc_start(h->writer_pid);

  pthread_mutexattr_t mattr;
  pthread_mutexattr_init(&mattr);
  pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &mattr);
  pthread_mutexattr_destroy(&mattr);

  pthread_condattr_t cattr;
  pthread_condattr_init(&cattr);
  pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&cattr, CLOCK_MONOTONIC);
  pthread_cond_init(&h->cv, &cattr);
  pthread_condattr_destroy(&cattr);

  Chan* c = new Chan();
  c->h = h;
  c->base = static_cast<uint8_t*>(mem);
  c->map_size = map_size;
  c->fd = fd;
  c->owner = true;
  std::snprintf(c->name, sizeof(c->name), "%s", name);
  return c;
}

void* chn_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  ChanHeader* h = static_cast<ChanHeader*>(mem);
  if (h->magic != kChanMagic || h->flags != kLayoutVersion) {
    munmap(mem, static_cast<size_t>(st.st_size));
    close(fd);
    return nullptr;
  }
  Chan* c = new Chan();
  c->h = h;
  c->base = static_cast<uint8_t*>(mem);
  c->map_size = static_cast<uint64_t>(st.st_size);
  c->fd = fd;
  c->owner = false;
  std::snprintf(c->name, sizeof(c->name), "%s", name);
  return c;
}

// Claim a reader slot for this process. A reader registered at
// version v sees versions > v. Returns slot index, or kError if the
// reader table is full.
int chn_reader_register(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  chan_lock(h);
  int slot = -1;
  for (uint32_t i = 0; i < kMaxReaders; ++i) {
    if (!h->readers[i].used) {
      slot = static_cast<int>(i);
      break;
    }
  }
  if (slot < 0) {
    reap_dead_readers(h);
    for (uint32_t i = 0; i < kMaxReaders; ++i) {
      if (!h->readers[i].used) {
        slot = static_cast<int>(i);
        break;
      }
    }
  }
  if (slot >= 0) {
    ReaderSlot* r = &h->readers[slot];
    r->pid = static_cast<int32_t>(getpid());
    r->start = chan_proc_start(r->pid);
    r->used = 1;
    r->acked = h->version;
  }
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
  return slot < 0 ? kError : slot;
}

void chn_reader_unregister(void* handle, int slot) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  if (slot < 0 || slot >= static_cast<int>(kMaxReaders)) return;
  chan_lock(h);
  h->readers[slot].used = 0;
  h->readers[slot].pid = 0;
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
}

// Acquire the payload region for an in-place write: blocks until all
// registered readers acked the previous version. With the
// single-writer discipline the caller may then fill the payload
// WITHOUT holding the lock (readers only touch it after commit bumps
// the version). timeout_ms < 0 = wait forever.
int chn_write_begin(void* handle, uint64_t size, int64_t timeout_ms) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  if (size > h->capacity) return kTooLarge;
  double deadline =
      timeout_ms < 0 ? -1.0 : mono_now() + timeout_ms * 1e-3;
  chan_lock(h);
  while (true) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mutex);
      return kClosed;
    }
    if (all_readers_acked(h)) break;
    if (reap_dead_readers(h)) continue;
    if (deadline >= 0 && mono_now() >= deadline) {
      pthread_mutex_unlock(&h->mutex);
      return kTimeout;
    }
    chan_wait(h, 100);
  }
  pthread_mutex_unlock(&h->mutex);
  return kOk;
}

// Publish the payload written after chn_write_begin.
void chn_write_commit(void* handle, uint64_t size) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  chan_lock(h);
  h->size = size;
  h->version++;
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
}

// One-shot copying write (begin + memcpy + commit).
int chn_write(void* handle, const uint8_t* data, uint64_t size,
              int64_t timeout_ms) {
  Chan* c = static_cast<Chan*>(handle);
  int rc = chn_write_begin(handle, size, timeout_ms);
  if (rc != kOk) return rc;
  std::memcpy(c->base + sizeof(ChanHeader), data, size);
  chn_write_commit(handle, size);
  return kOk;
}

// Wait for a version newer than this reader's last ack; fills size
// and version. The payload stays valid (the writer cannot overwrite)
// until chn_read_ack. Returns kOk / kClosed / kTimeout.
int chn_read_begin(void* handle, int slot, uint64_t* size,
                   uint64_t* version, int64_t timeout_ms) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  if (slot < 0 || slot >= static_cast<int>(kMaxReaders)) return kError;
  double deadline =
      timeout_ms < 0 ? -1.0 : mono_now() + timeout_ms * 1e-3;
  chan_lock(h);
  ReaderSlot* r = &h->readers[slot];
  while (true) {
    if (!r->used || r->pid != static_cast<int32_t>(getpid())) {
      pthread_mutex_unlock(&h->mutex);
      return kError;
    }
    if (h->version > r->acked) break;
    if (h->closed ||
        !chan_proc_alive(h->writer_pid, h->writer_start)) {
      pthread_mutex_unlock(&h->mutex);
      return kClosed;
    }
    if (deadline >= 0 && mono_now() >= deadline) {
      pthread_mutex_unlock(&h->mutex);
      return kTimeout;
    }
    chan_wait(h, 100);
  }
  *size = h->size;
  *version = h->version;
  pthread_mutex_unlock(&h->mutex);
  return kOk;
}

// Acknowledge the version returned by chn_read_begin, releasing the
// payload for the next write.
void chn_read_ack(void* handle, int slot, uint64_t version) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  if (slot < 0 || slot >= static_cast<int>(kMaxReaders)) return;
  chan_lock(h);
  if (h->readers[slot].acked < version) {
    h->readers[slot].acked = version;
  }
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
}

void chn_close(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  chan_lock(h);
  h->closed = 1;
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
}

// Take over writership (the creator is the driver; the actor whose
// loop actually writes claims the channel so reader-side liveness
// tracks the real producer process).
void chn_claim_writer(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  chan_lock(h);
  h->writer_pid = static_cast<int32_t>(getpid());
  h->writer_start = chan_proc_start(h->writer_pid);
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mutex);
}

int chn_is_closed(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  return static_cast<int>(c->h->closed);
}

// Registered (live) reader count — the compile-time handshake: the
// driver polls this before the first write so no reader misses
// version 1 (the reference resolves channel refs before running the
// DAG loop for the same reason).
int chn_reader_count(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  ChanHeader* h = c->h;
  chan_lock(h);
  int n = 0;
  for (uint32_t i = 0; i < kMaxReaders; ++i) {
    if (h->readers[i].used) n++;
  }
  pthread_mutex_unlock(&h->mutex);
  return n;
}

uint64_t chn_capacity(void* handle) {
  return static_cast<Chan*>(handle)->h->capacity;
}

uint8_t* chn_data_ptr(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  return c->base + sizeof(ChanHeader);
}

// Unmap this process's view; the owner also unlinks the shm name.
void chn_detach(void* handle) {
  Chan* c = static_cast<Chan*>(handle);
  bool owner = c->owner;
  char name[256];
  std::snprintf(name, sizeof(name), "%s", c->name);
  munmap(c->base, c->map_size);
  close(c->fd);
  delete c;
  if (owner) shm_unlink(name);
}

}  // extern "C"
