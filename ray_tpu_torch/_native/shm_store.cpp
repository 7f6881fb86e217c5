// Shared-memory object store: the plasma equivalent (copy of
// ray_tpu/_native/shm_store.cpp, built into ray_tpu_torch/_build/).
//
// Analogue of the reference's plasma store
// (src/ray/object_manager/plasma/: store.h:55, object_store.h:74,
// object_lifecycle_manager.h:101, eviction_policy.h) redesigned for the TPU
// host: instead of a store *server* process with fd-passing (fling.cc) and a
// socket protocol (plasma.fbs), the store is a single mmap'd file in /dev/shm
// shared by every process on the node, with all metadata — object table,
// free-list allocator, LRU clock — living inside the mapping, guarded by one
// process-shared robust mutex. Rationale: on a TPU VM every reader stages
// into the same host RAM that feeds TPU infeed; a serverless design removes
// one IPC round-trip and one copy from the get path (readers mmap once and
// take zero-copy views), and crash-robustness comes from the robust mutex +
// pin reclamation rather than a supervising server.
//
// Layout:
//   [Header | Slot table (n_slots) | data region]
// Data region is managed by a first-fit free list with coalescing
// (the reference uses dlmalloc inside its mmap'd slabs).
//
// Concurrency: one robust PTHREAD_PROCESS_SHARED mutex in the header. All
// operations are short (no IO under lock). If a process dies holding the
// lock, the next locker gets EOWNERDEAD and recovers the state.
//
// Object lifecycle: CREATED (being written) -> SEALED (immutable, readable)
// -> freed. Readers pin objects (refcount) to keep eviction away; eviction
// is LRU over sealed, unpinned objects and only runs on allocation pressure
// (reference: eviction_policy.h LRU cache + create-request queue).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055534852ULL;  // "RTPUSHR"
constexpr uint64_t kAlign = 64;                   // TPU-friendly host staging
constexpr uint32_t kIdSize = 16;

enum SlotState : uint32_t {
  kEmpty = 0,
  kCreated = 1,
  kSealed = 2,
  kTombstone = 3,  // deleted; probe chains continue through it
};

struct Slot {
  uint8_t id[kIdSize];
  uint64_t offset;      // into data region
  uint64_t size;        // object payload size (may be 0)
  uint64_t alloc_size;  // bytes actually taken from the free list
  uint32_t state;
  uint32_t pins;
  uint64_t lru_tick;
  uint64_t owner_pid;   // creator pid: lets eviction reclaim CREATED slots
                        // whose writer died between create and seal
};

// Free-list block header, stored inside the data region.
struct FreeBlock {
  uint64_t size;      // includes this header? no: payload bytes following
  uint64_t next_off;  // offset of next free block, or ~0ULL
};

constexpr uint64_t kNilOff = ~0ULL;

struct Header {
  uint64_t magic;
  uint64_t total_size;     // whole file
  uint64_t n_slots;
  uint64_t data_off;       // start of data region
  uint64_t data_size;
  uint64_t free_head;      // offset (data-relative) of first free block
  uint64_t used_bytes;
  uint64_t lru_clock;
  uint64_t num_objects;
  pthread_mutex_t mutex;
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t mapped_size;
};

inline Header* header(Handle* h) { return reinterpret_cast<Header*>(h->base); }

inline Slot* slots(Handle* h) {
  return reinterpret_cast<Slot*>(h->base + sizeof(Header));
}

inline uint8_t* data(Handle* h) { return h->base + header(h)->data_off; }

inline uint64_t align_up(uint64_t v) {
  return (v + kAlign - 1) & ~(kAlign - 1);
}

// FNV-1a over the id for slot hashing.
inline uint64_t hash_id(const uint8_t* id) {
  uint64_t acc = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; ++i) {
    acc ^= id[i];
    acc *= 1099511628211ULL;
  }
  return acc;
}

class Locker {
 public:
  explicit Locker(Handle* h) : h_(h) {
    int rc = pthread_mutex_lock(&header(h_)->mutex);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is consistent because all
      // mutations are applied atomically enough for our purposes (worst
      // case: a leaked CREATED object, cleaned up by eviction).
      pthread_mutex_consistent(&header(h_)->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&header(h_)->mutex); }

 private:
  Handle* h_;
};

Slot* find_slot(Handle* h, const uint8_t* id) {
  Header* hd = header(h);
  Slot* table = slots(h);
  uint64_t mask = hd->n_slots - 1;
  uint64_t idx = hash_id(id) & mask;
  for (uint64_t probe = 0; probe < hd->n_slots; ++probe) {
    Slot* s = &table[(idx + probe) & mask];
    if (s->state == kEmpty) return nullptr;
    if (s->state != kTombstone && memcmp(s->id, id, kIdSize) == 0) return s;
  }
  return nullptr;
}

Slot* find_insert_slot(Handle* h, const uint8_t* id) {
  Header* hd = header(h);
  Slot* table = slots(h);
  uint64_t mask = hd->n_slots - 1;
  uint64_t idx = hash_id(id) & mask;
  Slot* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < hd->n_slots; ++probe) {
    Slot* s = &table[(idx + probe) & mask];
    if (s->state == kEmpty) return first_tomb ? first_tomb : s;
    if (s->state == kTombstone) {
      if (!first_tomb) first_tomb = s;
    } else if (memcmp(s->id, id, kIdSize) == 0) {
      return nullptr;  // already exists
    }
  }
  return first_tomb;  // table full unless a tombstone is reusable
}

// Allocate from the first-fit free list. Returns data-relative offset or
// kNilOff; *actual receives the true block size taken (>= requested after
// alignment; may absorb an unsplittable sliver), which the caller must
// record for the matching freelist_free.
uint64_t freelist_alloc(Handle* h, uint64_t size, uint64_t* actual) {
  Header* hd = header(h);
  size = align_up(size);
  uint64_t prev = kNilOff;
  uint64_t cur = hd->free_head;
  while (cur != kNilOff) {
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(data(h) + cur);
    if (blk->size >= size) {
      uint64_t remaining = blk->size - size;
      uint64_t next;
      if (remaining >= sizeof(FreeBlock) + kAlign) {
        uint64_t rest_off = cur + size;
        FreeBlock* rest = reinterpret_cast<FreeBlock*>(data(h) + rest_off);
        rest->size = remaining;
        rest->next_off = blk->next_off;
        next = rest_off;
      } else {
        size = blk->size;  // absorb the sliver
        next = blk->next_off;
      }
      if (prev == kNilOff) {
        hd->free_head = next;
      } else {
        reinterpret_cast<FreeBlock*>(data(h) + prev)->next_off = next;
      }
      hd->used_bytes += size;
      *actual = size;
      return cur;
    }
    prev = cur;
    cur = blk->next_off;
  }
  return kNilOff;
}

// Return a block to the free list, keeping it sorted by offset and
// coalescing neighbors.
void freelist_free(Handle* h, uint64_t off, uint64_t size) {
  // `size` is the alloc_size recorded at allocation time (already aligned,
  // sliver included), so used_bytes accounting is exact.
  Header* hd = header(h);
  hd->used_bytes -= size;
  uint64_t prev = kNilOff;
  uint64_t cur = hd->free_head;
  while (cur != kNilOff && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(data(h) + cur)->next_off;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(data(h) + off);
  blk->size = size;
  blk->next_off = cur;
  if (prev == kNilOff) {
    hd->free_head = off;
  } else {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(data(h) + prev);
    if (prev + pb->size == off) {  // coalesce with prev
      pb->size += size;
      pb->next_off = cur;
      blk = pb;
      off = prev;
    } else {
      pb->next_off = off;
    }
  }
  if (cur != kNilOff && off + blk->size == cur) {  // coalesce with next
    FreeBlock* nb = reinterpret_cast<FreeBlock*>(data(h) + cur);
    blk->size += nb->size;
    blk->next_off = nb->next_off;
  }
}

void release_slot(Handle* h, Slot* s) {
  freelist_free(h, s->offset, s->alloc_size);
  s->state = kTombstone;
  s->pins = 0;
  header(h)->num_objects--;
}

inline bool pid_dead(uint64_t pid) {
  return pid != 0 && kill((pid_t)pid, 0) != 0 && errno == ESRCH;
}

// Evict sealed, unpinned objects (lowest lru_tick first) until at least
// `needed` aligned bytes could plausibly be free. Returns evicted count.
// Also reclaims CREATED slots whose creator process died between
// shm_create and shm_seal (the EOWNERDEAD-leak case).
int evict_for(Handle* h, uint64_t needed) {
  Header* hd = header(h);
  Slot* table = slots(h);
  int evicted = 0;
  for (uint64_t i = 0; i < hd->n_slots; ++i) {
    Slot* s = &table[i];
    if (s->state == kCreated && pid_dead(s->owner_pid)) {
      release_slot(h, s);
      ++evicted;
    }
  }
  while (hd->used_bytes + align_up(needed) > hd->data_size) {
    Slot* victim = nullptr;
    for (uint64_t i = 0; i < hd->n_slots; ++i) {
      Slot* s = &table[i];
      if (s->state == kSealed && s->pins == 0 &&
          (!victim || s->lru_tick < victim->lru_tick)) {
        victim = s;
      }
    }
    if (!victim) break;
    release_slot(h, victim);
    ++evicted;
  }
  return evicted;
}

}  // namespace

extern "C" {

// Create (or recreate) a store file of `capacity` data bytes. Returns 0 on
// success.
int shm_store_create(const char* path, uint64_t capacity, uint64_t n_slots) {
  if (n_slots == 0) n_slots = 1 << 16;
  // round n_slots to power of two
  uint64_t p2 = 1;
  while (p2 < n_slots) p2 <<= 1;
  n_slots = p2;

  uint64_t data_off = align_up(sizeof(Header) + n_slots * sizeof(Slot));
  uint64_t total = data_off + align_up(capacity);
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return -errno;
  if (ftruncate(fd, (off_t)total) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  void* base =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    int e = errno;
    close(fd);
    return -e;
  }
  Header* hd = reinterpret_cast<Header*>(base);
  memset(hd, 0, sizeof(Header));
  hd->total_size = total;
  hd->n_slots = n_slots;
  hd->data_off = data_off;
  hd->data_size = align_up(capacity);
  hd->used_bytes = 0;
  hd->lru_clock = 1;
  hd->num_objects = 0;
  memset(static_cast<uint8_t*>(base) + sizeof(Header), 0,
         n_slots * sizeof(Slot));
  // Whole data region is one free block.
  FreeBlock* first = reinterpret_cast<FreeBlock*>(
      static_cast<uint8_t*>(base) + data_off);
  first->size = hd->data_size;
  first->next_off = kNilOff;
  hd->free_head = 0;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hd->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  hd->magic = kMagic;  // last: marks the store valid
  munmap(base, total);
  close(fd);
  return 0;
}

void* shm_store_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* hd = reinterpret_cast<Header*>(base);
  if (hd->magic != kMagic || hd->total_size != (uint64_t)st.st_size) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle{fd, static_cast<uint8_t*>(base),
                         (uint64_t)st.st_size};
  return h;
}

void shm_store_close(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  if (!h) return;
  munmap(h->base, h->mapped_size);
  close(h->fd);
  delete h;
}

uint8_t* shm_store_base(void* vh) { return static_cast<Handle*>(vh)->base; }

// Allocate an object buffer. Returns absolute offset from the mapping base
// (>0) or 0 on failure (full table / OOM after eviction / duplicate id).
uint64_t shm_create(void* vh, const uint8_t* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Header* hd = header(h);
  if (align_up(size) > hd->data_size) return 0;
  Slot* s = find_insert_slot(h, id);
  if (!s) return 0;
  uint64_t want = size ? size : kAlign;  // 0-byte objects take one unit
  uint64_t actual = 0;
  uint64_t off = freelist_alloc(h, want, &actual);
  if (off == kNilOff) {
    evict_for(h, want);
    off = freelist_alloc(h, want, &actual);
    if (off == kNilOff) return 0;
  }
  memcpy(s->id, id, kIdSize);
  s->offset = off;
  s->size = size;  // true payload size (0 allowed)
  s->alloc_size = actual;
  s->state = kCreated;
  s->pins = 1;  // creator holds a pin until seal
  s->lru_tick = hd->lru_clock++;
  s->owner_pid = (uint64_t)getpid();
  hd->num_objects++;
  return hd->data_off + off;
}

// Seal: object becomes immutable + readable. keep_pin != 0 converts the
// creator pin into a primary-copy pin (owner releases it via shm_unpin when
// the object goes out of scope), so eviction can never drop the only copy
// of a live object (reference pins primary copies the same way,
// local_object_manager.h).
int shm_seal2(void* vh, const uint8_t* id, int keep_pin) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Slot* s = find_slot(h, id);
  if (!s || s->state != kCreated) return -1;
  s->state = kSealed;
  if (!keep_pin && s->pins > 0) s->pins--;
  return 0;
}

int shm_seal(void* vh, const uint8_t* id) { return shm_seal2(vh, id, 0); }

// Look up a sealed object. On success returns absolute offset, fills *size,
// and pins the object if pin != 0. Returns 0 if absent/unsealed.
uint64_t shm_get(void* vh, const uint8_t* id, uint64_t* size, int pin) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Header* hd = header(h);
  Slot* s = find_slot(h, id);
  if (!s || s->state != kSealed) return 0;
  if (size) *size = s->size;
  if (pin) s->pins++;
  s->lru_tick = hd->lru_clock++;
  return hd->data_off + s->offset;
}

int shm_unpin(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Slot* s = find_slot(h, id);
  if (!s || s->pins == 0) return -1;
  s->pins--;
  return 0;
}

int shm_contains(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Slot* s = find_slot(h, id);
  return (s && s->state == kSealed) ? 1 : 0;
}

// Delete an object (any state) regardless of pins — callers coordinate.
int shm_delete(void* vh, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  Slot* s = find_slot(h, id);
  if (!s) return -1;
  release_slot(h, s);
  return 0;
}

uint64_t shm_used_bytes(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  return header(h)->used_bytes;
}

uint64_t shm_capacity(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  return header(h)->data_size;
}

uint64_t shm_num_objects(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  Locker lock(h);
  return header(h)->num_objects;
}

}  // extern "C"
