// Shared-memory object store: per-node arena with an allocator and object
// index living *inside* the shared mapping, so any local process can attach
// and read sealed objects zero-copy.
//
// Role-equivalent of the reference's Plasma store (ray:
// src/ray/object_manager/plasma/{store.h,object_lifecycle_manager.h,
// eviction_policy.h,dlmalloc.cc}) redesigned daemon-less: instead of a store
// server process brokering allocations over a unix socket with fd-passing,
// every client attaches the same file-backed mapping and allocation/index
// updates are serialized by robust process-shared mutexes.  This removes a
// socket round-trip from the put/get hot path entirely (the reference needs
// one per create/seal/get; here those are ~100ns lock acquisitions).
//
// Layout of the arena file (v3):
//   [ Header (incl. shard headers) | client slots | hash-table entries |
//     data region ]
// All internal references are byte offsets, never pointers, so processes can
// map at different addresses.
//
// Concurrency model (data plane v2): TWO lock tiers instead of the v2
// single mutex —
//   * the MAIN mutex guards the allocator (free list, used_bytes),
//     eviction/maintenance passes, and the client-slot registry;
//   * the index is split into kShards sub-tables, each guarded by its own
//     robust mutex, shard chosen by the low bits of the id hash — so
//     concurrent writers publishing/sealing different objects no longer
//     serialize on one lock (the multi-client put bottleneck, BENCH.md
//     term (b)).
// Lock order is MAIN < shard[i] (ascending for multi-shard maintenance);
// no path ever acquires MAIN while holding a shard lock.  The per-client
// pin/slab ledger is only ever mutated by its own (live) process — it is
// guarded by a process-LOCAL mutex on the handle; reap touches only DEAD
// clients' ledgers and runs stop-world (MAIN + every shard).
//
// Inline put fast path: rt_store_reserve_slots pre-allocates a batch of
// fixed-size blocks to a client (amortizing the allocator lock across many
// small puts and letting the client pre-fault the pages once);
// rt_store_publish_slot then inserts a SEALED index entry pointing at a
// reserved block under a single shard-lock acquisition — a small put costs
// one lock round trip instead of create+seal(+protect), and two clients
// publishing land on different shards with no contention at all.
//
// Crash tolerance without a daemon (the reference recovers reader pins via
// client-disconnect handling in the store server): every attached client
// owns a slot holding its pid, a ledger of its outstanding pins, and a
// ledger of its reserved-but-unpublished slab blocks.  rt_store_reap
// (called by the raylet periodically, and by attach when slots run out)
// detects dead pids and releases both ledgers — aborting half-created
// objects, unpinning reads, and freeing reserved slots — so a crashed
// worker can never leak refcounts or arena space permanently.  (The one
// crash window that can leak is between an allocator grant and its index/
// ledger record landing — worst case one block per crashed client,
// reclaimed when the arena is torn down.)
//
// Object *payload* writes happen outside every lock (the object is
// invisible until sealed/published).  Robust mutex semantics recover any
// lock if a client dies while holding it.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <new>

namespace {

constexpr uint64_t kMagic = 0x5254504c41534d43ULL;  // "RTPLASMC" (v3: shards)
constexpr uint64_t kAlign = 64;
constexpr uint32_t kIdLen = 16;
constexpr uint32_t kMaxClients = 128;
constexpr uint32_t kMaxPinsPerClient = 1024;
constexpr uint32_t kMaxSlabSlots = 128;  // reserved inline slots per client
constexpr uint32_t kShards = 8;          // index sub-tables (power of two)

// Object states in the index.
enum : uint32_t {
  kEmpty = 0,
  kCreated = 1,
  kSealed = 2,
  kTombstone = 3,
};

// Return codes (keep in sync with ray_tpu_torch/_native/store.py).
enum : int {
  RT_OK = 0,
  RT_EXISTS = -1,
  RT_NOT_FOUND = -2,
  RT_NO_SPACE = -3,
  RT_ERR = -4,
  RT_NOT_SEALED = -5,
  RT_PINNED = -6,
  RT_TOO_MANY_PINS = -7,
  RT_NO_CLIENT_SLOT = -8,
};

// Entry flag bits.
constexpr uint32_t kFlagProtected = 1u;  // primary copy: LRU must not evict

struct Entry {
  uint8_t id[kIdLen];
  uint64_t offset;       // data offset from arena base
  uint64_t size;         // payload size
  uint64_t last_access;  // logical clock for LRU eviction
  uint32_t state;
  uint32_t refcnt;       // pin count; pinned objects are never evicted
  uint32_t flags;        // kFlag* bits; protected entries spill before evict
  uint32_t pad;
};

struct PinRec {
  uint8_t id[kIdLen];
  uint32_t count;
  uint32_t pad;
};

struct ClientSlot {
  uint32_t pid;      // 0 = free
  uint32_t npins;    // used prefix of pins[]
  uint32_t nslabs;   // used prefix of slab_offs[]
  uint32_t pad;
  uint64_t slab_offs[kMaxSlabSlots];  // reserved, unpublished slot blocks
  PinRec pins[kMaxPinsPerClient];
};

// One index sub-table's metadata; the Entry array itself lives in the
// shared table region (shard i owns entries [i*shard_cap, (i+1)*shard_cap)).
struct Shard {
  pthread_mutex_t mutex;
  uint64_t used;        // live + tombstone entries
  uint64_t tombstones;
  uint64_t live;
};

struct Header {
  uint64_t magic;
  uint64_t total_size;
  uint64_t clients_off;
  uint64_t table_off;
  uint64_t table_cap;   // total Entry slots across shards (power of two)
  uint64_t data_off;
  uint64_t data_size;
  uint64_t used_bytes;   // allocated bytes incl. block headers (MAIN)
  uint64_t free_head;    // offset of first free block (0 = none) (MAIN)
  uint64_t access_clock; // atomic logical clock, feeds last_access
  uint64_t num_evictions;
  pthread_mutex_t mutex;  // MAIN: allocator + clients + maintenance
  Shard shards[kShards];
};

// Every data block (free or allocated) carries a boundary-tag header and
// footer so free() can coalesce with neighbours in O(1).
struct BlockHeader {
  uint64_t size;  // total block size incl. header+footer; low bit = free flag
  uint64_t next_free;
  uint64_t prev_free;
};
constexpr uint64_t kBlockHdr = sizeof(BlockHeader);
constexpr uint64_t kBlockFtr = sizeof(uint64_t);
constexpr uint64_t kMinBlock = kBlockHdr + kBlockFtr + kAlign;

inline uint64_t block_size(uint64_t tag) { return tag & ~1ULL; }
inline bool block_free(uint64_t tag) { return tag & 1ULL; }

struct Store {
  uint8_t* base;
  uint64_t map_size;
  int fd;
  int32_t client_idx;  // this handle's slot in the client registry
  // process-local guard for THIS client's pin/slab ledger: two threads of
  // one process may hit different shard locks concurrently, but they share
  // one ClientSlot (reap only touches dead clients' slots, so cross-
  // process exclusion is unnecessary for a live ledger)
  pthread_mutex_t ledger_mu;
  Header* hdr() { return reinterpret_cast<Header*>(base); }
  ClientSlot* clients() {
    return reinterpret_cast<ClientSlot*>(base + hdr()->clients_off);
  }
  Entry* table() { return reinterpret_cast<Entry*>(base + hdr()->table_off); }
  uint64_t shard_cap() { return hdr()->table_cap / kShards; }
  Entry* shard_table(uint32_t si) { return table() + si * shard_cap(); }
  BlockHeader* block(uint64_t off) {
    return reinterpret_cast<BlockHeader*>(base + off);
  }
  uint64_t* footer(uint64_t off) {
    return reinterpret_cast<uint64_t*>(base + off + block_size(block(off)->size) -
                                       kBlockFtr);
  }
};

uint64_t round_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 16-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

inline uint32_t shard_of(const uint8_t* id) {
  return (uint32_t)(hash_id(id) & (kShards - 1));
}

void lock_robust(pthread_mutex_t* m) {
  int rc = pthread_mutex_lock(m);
  if (rc == EOWNERDEAD) {
    // A client died holding the lock. Metadata mutations are small and
    // ordered; worst case is a leaked created-but-unsealed object, which
    // rt_store_reap reclaims via the dead client's ledgers.
    pthread_mutex_consistent(m);
  }
}

// MAIN lock: allocator + clients + maintenance.
class MainLock {
 public:
  explicit MainLock(Store* s) : s_(s) { lock_robust(&s_->hdr()->mutex); }
  ~MainLock() { pthread_mutex_unlock(&s_->hdr()->mutex); }

 private:
  Store* s_;
};

// One shard's index lock.  NEVER acquire MAIN while holding one of these
// (lock order is MAIN < shard).
class ShardLock {
 public:
  ShardLock(Store* s, uint32_t si) : s_(s), si_(si) {
    lock_robust(&s_->hdr()->shards[si].mutex);
  }
  ~ShardLock() { pthread_mutex_unlock(&s_->hdr()->shards[si_].mutex); }

 private:
  Store* s_;
  uint32_t si_;
};

// This client's process-local ledger lock.
class LedgerLock {
 public:
  explicit LedgerLock(Store* s) : s_(s) { pthread_mutex_lock(&s_->ledger_mu); }
  ~LedgerLock() { pthread_mutex_unlock(&s_->ledger_mu); }

 private:
  Store* s_;
};

// ---- free-list allocator (caller holds MAIN) -----------------------------

void freelist_insert(Store* s, uint64_t off) {
  Header* h = s->hdr();
  BlockHeader* b = s->block(off);
  b->size |= 1ULL;  // mark free
  *s->footer(off) = b->size;
  b->next_free = h->free_head;
  b->prev_free = 0;
  if (h->free_head) s->block(h->free_head)->prev_free = off;
  h->free_head = off;
}

void freelist_remove(Store* s, uint64_t off) {
  Header* h = s->hdr();
  BlockHeader* b = s->block(off);
  if (b->prev_free)
    s->block(b->prev_free)->next_free = b->next_free;
  else
    h->free_head = b->next_free;
  if (b->next_free) s->block(b->next_free)->prev_free = b->prev_free;
  b->size &= ~1ULL;
  *s->footer(off) = b->size;
}

// Allocate a block with at least `payload` bytes of usable space.
// Returns data offset (past the header) or 0 on failure.
uint64_t arena_alloc(Store* s, uint64_t payload) {
  Header* h = s->hdr();
  uint64_t need = round_up(payload + kBlockHdr + kBlockFtr, kAlign);
  if (need < kMinBlock) need = kMinBlock;
  uint64_t off = h->free_head;
  while (off) {
    BlockHeader* b = s->block(off);
    uint64_t bsz = block_size(b->size);
    if (bsz >= need) {
      freelist_remove(s, off);
      if (bsz - need >= kMinBlock) {
        // split: tail becomes a new free block
        uint64_t tail = off + need;
        b->size = need;
        *s->footer(off) = need;
        BlockHeader* t = s->block(tail);
        t->size = bsz - need;
        *s->footer(tail) = t->size;
        freelist_insert(s, tail);
      }
      h->used_bytes += block_size(b->size);
      return off + kBlockHdr;
    }
    off = b->next_free;
  }
  return 0;
}

void arena_free(Store* s, uint64_t data_off) {
  Header* h = s->hdr();
  uint64_t off = data_off - kBlockHdr;
  BlockHeader* b = s->block(off);
  h->used_bytes -= block_size(b->size);
  // coalesce with next block
  uint64_t next = off + block_size(b->size);
  if (next < h->data_off + h->data_size) {
    BlockHeader* nb = s->block(next);
    if (block_free(nb->size)) {
      freelist_remove(s, next);
      b->size = block_size(b->size) + block_size(nb->size);
      *s->footer(off) = b->size;
    }
  }
  // coalesce with previous block
  if (off > h->data_off) {
    uint64_t prev_tag = *reinterpret_cast<uint64_t*>(s->base + off - kBlockFtr);
    if (block_free(prev_tag)) {
      uint64_t prev = off - block_size(prev_tag);
      freelist_remove(s, prev);
      s->block(prev)->size = block_size(prev_tag) + block_size(b->size);
      *s->footer(prev) = s->block(prev)->size;
      off = prev;
      b = s->block(off);
    }
  }
  freelist_insert(s, off);
}

// ---- index (per-shard; caller holds the shard's lock) --------------------

Entry* find_entry_in(Store* s, uint32_t si, const uint8_t* id) {
  uint64_t cap = s->shard_cap();
  uint64_t mask = cap - 1;
  Entry* tab = s->shard_table(si);
  uint64_t i = (hash_id(id) >> 3) & mask;
  for (uint64_t probes = 0; probes < cap; probes++, i = (i + 1) & mask) {
    Entry* e = &tab[i];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kTombstone && memcmp(e->id, id, kIdLen) == 0) return e;
  }
  return nullptr;
}

// Rebuild one shard's sub-table without tombstones (transient heap buffer;
// caller holds the shard lock).
void purge_tombstones(Store* s, uint32_t si) {
  Shard* sh = &s->hdr()->shards[si];
  uint64_t cap = s->shard_cap();
  Entry* tab = s->shard_table(si);
  Entry* snapshot = static_cast<Entry*>(malloc(cap * sizeof(Entry)));
  if (!snapshot) return;
  memcpy(snapshot, tab, cap * sizeof(Entry));
  memset(tab, 0, cap * sizeof(Entry));
  uint64_t mask = cap - 1;
  uint64_t live = 0;
  for (uint64_t i = 0; i < cap; i++) {
    Entry* e = &snapshot[i];
    if (e->state == kCreated || e->state == kSealed) {
      uint64_t j = (hash_id(e->id) >> 3) & mask;
      while (tab[j].state != kEmpty) j = (j + 1) & mask;
      tab[j] = *e;
      live++;
    }
  }
  free(snapshot);
  sh->used = live;
  sh->tombstones = 0;
}

void make_tombstone(Store* s, uint32_t si, Entry* e) {
  Shard* sh = &s->hdr()->shards[si];
  e->state = kTombstone;
  sh->tombstones++;
  sh->live--;
}

// Find a slot for inserting `id` in its shard. Returns existing entry if the
// id is live.  Caller holds the shard lock.
Entry* find_slot_in(Store* s, uint32_t si, const uint8_t* id,
                    bool* reused_tombstone) {
  uint64_t cap = s->shard_cap();
  uint64_t mask = cap - 1;
  Entry* tab = s->shard_table(si);
  uint64_t i = (hash_id(id) >> 3) & mask;
  Entry* first_tomb = nullptr;
  *reused_tombstone = false;
  for (uint64_t probes = 0; probes < cap; probes++, i = (i + 1) & mask) {
    Entry* e = &tab[i];
    if (e->state == kEmpty) {
      if (first_tomb) {
        *reused_tombstone = true;
        return first_tomb;
      }
      return e;
    }
    if (e->state == kTombstone) {
      if (!first_tomb) first_tomb = e;
    } else if (memcmp(e->id, id, kIdLen) == 0) {
      return e;  // caller checks state
    }
  }
  if (first_tomb) *reused_tombstone = true;
  return first_tomb;
}

// Make room in shard si's sub-table (3/4 load ceiling).  Caller holds the
// shard lock.  Returns true when one more insert fits.
bool ensure_shard_room(Store* s, uint32_t si) {
  Shard* sh = &s->hdr()->shards[si];
  uint64_t cap = s->shard_cap();
  if (sh->used + 1 <= (cap * 3) / 4) return true;
  if (sh->tombstones > 0) purge_tombstones(s, si);
  return sh->used + 1 <= (cap * 3) / 4;
}

// Evict least-recently-used sealed, unpinned objects until `needed_bytes`
// could plausibly be allocated.  Caller holds MAIN; shard locks are taken
// one at a time (MAIN < shard order).  Single scan: collect candidates,
// sort by last_access, evict in order.
// (ray: eviction_policy.h LRUCache analogue, done inline.)
uint64_t evict_lru(Store* s, uint64_t needed_bytes) {
  Header* h = s->hdr();
  uint64_t byte_target = needed_bytes + (needed_bytes >> 2);
  struct Cand {
    uint64_t access;
    uint64_t idx;  // global table index
  };
  Cand* cands = static_cast<Cand*>(malloc(h->table_cap * sizeof(Cand)));
  if (!cands) return 0;
  uint64_t n = 0;
  uint64_t cap = s->shard_cap();
  for (uint32_t si = 0; si < kShards; si++) {
    ShardLock lk(s, si);
    Entry* tab = s->shard_table(si);
    for (uint64_t i = 0; i < cap; i++) {
      Entry* e = &tab[i];
      if (e->state == kSealed && e->refcnt == 0 &&
          !(e->flags & kFlagProtected)) {
        cands[n].access = e->last_access;
        cands[n].idx = si * cap + i;
        n++;
      }
    }
  }
  qsort(cands, n, sizeof(Cand), [](const void* a, const void* b) {
    uint64_t aa = static_cast<const Cand*>(a)->access;
    uint64_t bb = static_cast<const Cand*>(b)->access;
    return (aa < bb) ? -1 : (aa > bb) ? 1 : 0;
  });
  uint64_t freed = 0;
  for (uint64_t i = 0; i < n && freed < byte_target; i++) {
    uint32_t si = (uint32_t)(cands[i].idx / cap);
    ShardLock lk(s, si);
    Entry* e = &s->table()[cands[i].idx];
    // re-validate: the entry may have been pinned/protected/replaced
    // between the collect pass and now
    if (e->state != kSealed || e->refcnt != 0 ||
        (e->flags & kFlagProtected)) {
      continue;
    }
    freed += e->size;
    arena_free(s, e->offset);  // MAIN held by caller
    make_tombstone(s, si, e);
    h->num_evictions++;
  }
  free(cands);
  return freed;
}

// Evict by entry count from ONE shard whose sub-table is full of live
// objects (small-object stores would otherwise free one tiny victim and
// still report NO_SPACE).  Takes MAIN internally; caller holds NO locks.
void evict_for_shard_room(Store* s, uint32_t si) {
  MainLock main(s);
  Header* h = s->hdr();
  uint64_t cap = s->shard_cap();
  struct Cand {
    uint64_t access;
    uint64_t idx;
  };
  Cand* cands = static_cast<Cand*>(malloc(cap * sizeof(Cand)));
  if (!cands) return;
  ShardLock lk(s, si);
  Entry* tab = s->shard_table(si);
  uint64_t n = 0;
  for (uint64_t i = 0; i < cap; i++) {
    Entry* e = &tab[i];
    if (e->state == kSealed && e->refcnt == 0 &&
        !(e->flags & kFlagProtected)) {
      cands[n].access = e->last_access;
      cands[n].idx = i;
      n++;
    }
  }
  qsort(cands, n, sizeof(Cand), [](const void* a, const void* b) {
    uint64_t aa = static_cast<const Cand*>(a)->access;
    uint64_t bb = static_cast<const Cand*>(b)->access;
    return (aa < bb) ? -1 : (aa > bb) ? 1 : 0;
  });
  uint64_t target = cap / 8;
  for (uint64_t i = 0; i < n && i < target; i++) {
    Entry* e = &tab[cands[i].idx];
    arena_free(s, e->offset);
    make_tombstone(s, si, e);
    h->num_evictions++;
  }
  purge_tombstones(s, si);
  free(cands);
}

// ---- client pin ledger (caller holds the LOCAL ledger lock) --------------

int ledger_add(Store* s, const uint8_t* id) {
  ClientSlot* c = &s->clients()[s->client_idx];
  for (uint32_t i = 0; i < c->npins; i++) {
    if (memcmp(c->pins[i].id, id, kIdLen) == 0) {
      c->pins[i].count++;
      return RT_OK;
    }
  }
  if (c->npins >= kMaxPinsPerClient) return RT_TOO_MANY_PINS;
  memcpy(c->pins[c->npins].id, id, kIdLen);
  c->pins[c->npins].count = 1;
  c->npins++;
  return RT_OK;
}

void ledger_remove(Store* s, const uint8_t* id) {
  ClientSlot* c = &s->clients()[s->client_idx];
  for (uint32_t i = 0; i < c->npins; i++) {
    if (memcmp(c->pins[i].id, id, kIdLen) == 0) {
      if (--c->pins[i].count == 0) {
        c->pins[i] = c->pins[c->npins - 1];  // swap-remove
        c->npins--;
      }
      return;
    }
  }
}

// Remove one reserved slab offset from this client's ledger.  Returns true
// when the offset was present.
bool slab_ledger_remove(ClientSlot* c, uint64_t off) {
  for (uint32_t i = 0; i < c->nslabs; i++) {
    if (c->slab_offs[i] == off) {
      c->slab_offs[i] = c->slab_offs[c->nslabs - 1];
      c->nslabs--;
      return true;
    }
  }
  return false;
}

// Release every pin + reserved slot a client slot holds: unpin sealed
// reads, abort half-created objects, free unpublished slab blocks.
// Called on detach and on reaping a dead client — caller holds MAIN and
// EVERY shard lock (stop-world), so plain index access is safe.
void release_client_state(Store* s, ClientSlot* c) {
  for (uint32_t i = 0; i < c->npins; i++) {
    uint32_t si = shard_of(c->pins[i].id);
    Entry* e = find_entry_in(s, si, c->pins[i].id);
    if (!e) continue;
    if (e->state == kCreated) {
      // creator died/left before sealing: reclaim the space
      arena_free(s, e->offset);
      make_tombstone(s, si, e);
    } else {
      uint32_t n = c->pins[i].count;
      e->refcnt = (e->refcnt > n) ? e->refcnt - n : 0;
    }
  }
  c->npins = 0;
  for (uint32_t i = 0; i < c->nslabs; i++) {
    arena_free(s, c->slab_offs[i]);
  }
  c->nslabs = 0;
  c->pid = 0;
}

// Reap clients whose pid no longer exists. Caller holds MAIN + all shards.
int reap_dead_clients(Store* s) {
  int reaped = 0;
  ClientSlot* slots = s->clients();
  for (uint32_t i = 0; i < kMaxClients; i++) {
    ClientSlot* c = &slots[i];
    if (c->pid != 0 && kill((pid_t)c->pid, 0) != 0 && errno == ESRCH) {
      release_client_state(s, c);
      reaped++;
    }
  }
  return reaped;
}

// Stop-world RAII for maintenance ops touching every shard: MAIN first,
// then shards in ascending order (the one place multiple shard locks are
// held at once).
class StopWorld {
 public:
  explicit StopWorld(Store* s) : s_(s) {
    lock_robust(&s_->hdr()->mutex);
    for (uint32_t i = 0; i < kShards; i++) {
      lock_robust(&s_->hdr()->shards[i].mutex);
    }
  }
  ~StopWorld() {
    for (uint32_t i = kShards; i > 0; i--) {
      pthread_mutex_unlock(&s_->hdr()->shards[i - 1].mutex);
    }
    pthread_mutex_unlock(&s_->hdr()->mutex);
  }

 private:
  Store* s_;
};

int32_t claim_client_slot(Store* s) {
  // caller holds MAIN + all shards (reap on pass 2 needs them)
  ClientSlot* slots = s->clients();
  for (int pass = 0; pass < 2; pass++) {
    for (uint32_t i = 0; i < kMaxClients; i++) {
      if (slots[i].pid == 0) {
        slots[i].pid = (uint32_t)getpid();
        slots[i].npins = 0;
        slots[i].nslabs = 0;
        return (int32_t)i;
      }
    }
    if (pass == 0 && reap_dead_clients(s) == 0) break;
  }
  return -1;
}

void init_robust_mutex(pthread_mutex_t* m) {
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(m, &attr);
  pthread_mutexattr_destroy(&attr);
}

Store* new_store(void* base, uint64_t size, int fd) {
  Store* s = new Store{reinterpret_cast<uint8_t*>(base), size, fd, -1, {}};
  pthread_mutex_init(&s->ledger_mu, nullptr);
  return s;
}

}  // namespace

extern "C" {

// Per-client ledger capacity (shared by pins and unsealed creates) so
// Python callers can gauge headroom without duplicating the constant.
uint64_t rt_store_max_pins() { return kMaxPinsPerClient; }

// Per-client reserved-slot ledger capacity (the inline-put slab).
uint64_t rt_store_max_slab_slots() { return kMaxSlabSlots; }

// Minimum arena size such that metadata plus a useful data region fit.
uint64_t rt_store_min_size() {
  uint64_t meta = round_up(sizeof(Header), kAlign) +
                  round_up(kMaxClients * sizeof(ClientSlot), kAlign) +
                  4096 * sizeof(Entry);
  return round_up(meta, kAlign) + (16ULL << 20);  // + 16MB data floor
}

// Create a new arena file of `size` bytes at `path` and initialize it.
// Returns an opaque handle or null.
void* rt_store_create(const char* path, uint64_t size) {
  if (size < rt_store_min_size()) return nullptr;
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)size) != 0) {
    close(fd);
    unlink(path);
    return nullptr;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    unlink(path);
    return nullptr;
  }
  Store* s = new_store(base, size, fd);
  Header* h = s->hdr();
  memset(h, 0, sizeof(Header));
  // Size the index at one slot per 4KB of arena, >= 4096 slots, power of 2
  // (shard sub-tables are table_cap/kShards each, also powers of two).
  uint64_t cap = 4096;
  while (cap < size / 4096) cap <<= 1;
  h->total_size = size;
  h->clients_off = round_up(sizeof(Header), kAlign);
  h->table_off =
      round_up(h->clients_off + kMaxClients * sizeof(ClientSlot), kAlign);
  h->table_cap = cap;
  h->data_off = round_up(h->table_off + cap * sizeof(Entry), kAlign);
  if (size <= h->data_off + kMinBlock) {  // index for this size doesn't fit
    munmap(base, size);
    close(fd);
    unlink(path);
    delete s;
    return nullptr;
  }
  h->data_size = size - h->data_off;
  memset(s->clients(), 0, kMaxClients * sizeof(ClientSlot));
  memset(s->table(), 0, cap * sizeof(Entry));

  init_robust_mutex(&h->mutex);
  for (uint32_t i = 0; i < kShards; i++) {
    init_robust_mutex(&h->shards[i].mutex);
    h->shards[i].used = h->shards[i].tombstones = h->shards[i].live = 0;
  }

  // One giant free block spanning the data region.
  BlockHeader* b = s->block(h->data_off);
  b->size = h->data_size;
  *s->footer(h->data_off) = b->size;
  b->next_free = b->prev_free = 0;
  freelist_insert(s, h->data_off);

  s->client_idx = claim_client_slot(s);  // fresh arena: no lock contention
  // Publish the magic LAST so a concurrent attach never sees a half-built
  // arena (attach fails cleanly until initialization completes).
  __atomic_store_n(&h->magic, kMagic, __ATOMIC_RELEASE);
  return s;
}

// Attach to an existing arena. Returns handle or null.
void* rt_store_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new_store(base, (uint64_t)st.st_size, fd);
  if (s->hdr()->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  {
    StopWorld lock(s);
    s->client_idx = claim_client_slot(s);
  }
  if (s->client_idx < 0) {
    munmap(base, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

void rt_store_detach(void* handle) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx >= 0) {
    StopWorld lock(s);
    release_client_state(s, &s->clients()[s->client_idx]);
  }
  munmap(s->base, s->map_size);
  close(s->fd);
  pthread_mutex_destroy(&s->ledger_mu);
  delete s;
}

// Allocate space for an object. On success writes the payload offset (from
// arena base) to *out_offset; the caller memcpys payload there then seals.
// If the arena is full, evicts LRU sealed unpinned objects to make room.
int rt_store_create_object(void* handle, const uint8_t* id, uint64_t size,
                           uint64_t* out_offset) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx < 0) return RT_NO_CLIENT_SLOT;
  uint32_t si = shard_of(id);
  // Pass 1 (shard only): duplicate check + index-room check.  A duplicate
  // create racing us between this check and the insert below is caught
  // again at insert time.
  bool room;
  {
    ShardLock lk(s, si);
    if (find_entry_in(s, si, id)) return RT_EXISTS;
    room = ensure_shard_room(s, si);
  }
  if (!room) {
    // sub-table genuinely full of live objects: evict by entry count
    evict_for_shard_room(s, si);
    ShardLock lk(s, si);
    if (!ensure_shard_room(s, si)) return RT_NO_SPACE;
  }
  // Pass 2 (MAIN): allocate payload space, evicting LRU bytes on pressure.
  uint64_t off;
  {
    MainLock main(s);
    off = arena_alloc(s, size);
    if (!off) {
      evict_lru(s, size);
      off = arena_alloc(s, size);
      if (!off) return RT_NO_SPACE;
    }
  }
  // Creator pin BEFORE the insert: a crash after the entry exists must be
  // reapable through the pin ledger (reap aborts kCreated entries).
  bool pinned;
  {
    LedgerLock led(s);
    pinned = ledger_add(s, id) == RT_OK;
  }
  if (!pinned) {
    // unwind OUTSIDE the ledger scope: taking MAIN under ledger_mu
    // inverts the MAIN < shard < ledger order and closes a deadlock
    // cycle against publish_slot's shard->ledger hold (rtlint RT304)
    MainLock main(s);
    arena_free(s, off);
    return RT_TOO_MANY_PINS;
  }
  // Pass 3 (shard): insert.  A lost race (concurrent creator of the same
  // id, or the shard filling meanwhile) unwinds: drop the creator pin,
  // release the shard lock, THEN free the block (MAIN may not be taken
  // while a shard lock is held).
  int lose_rc = RT_OK;
  {
    ShardLock lk(s, si);
    bool reused_tomb = false;
    Entry* e = find_slot_in(s, si, id, &reused_tomb);
    if (e && (e->state == kCreated || e->state == kSealed)) {
      lose_rc = RT_EXISTS;
    } else if (!e) {
      lose_rc = RT_NO_SPACE;
    } else {
      Shard* sh = &s->hdr()->shards[si];
      if (e->state == kEmpty)
        sh->used++;
      else if (reused_tomb)
        sh->tombstones--;
      memcpy(e->id, id, kIdLen);
      e->offset = off;
      e->size = size;
      e->state = kCreated;
      e->refcnt = 1;  // creator holds a pin until seal/abort
      e->flags = 0;   // a reused tombstone may carry stale flag bits
      e->last_access =
          __atomic_add_fetch(&s->hdr()->access_clock, 1, __ATOMIC_RELAXED);
      sh->live++;
      *out_offset = off;
      return RT_OK;
    }
  }
  {
    LedgerLock led(s);
    ledger_remove(s, id);
  }
  MainLock main(s);
  arena_free(s, off);
  return lose_rc;
}

// Seal with an optional atomic protect: state flips to kSealed and the
// primary-copy flag lands under ONE shard-lock acquisition, so there is no
// window where a sealed primary is LRU-evictable (v2 needed separate
// protect + seal calls, two lock round trips, protect-before-seal ordered
// by the caller).
int rt_store_seal2(void* handle, const uint8_t* id, int protect) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  {
    ShardLock lk(s, si);
    Entry* e = find_entry_in(s, si, id);
    if (!e) return RT_NOT_FOUND;
    if (e->state != kCreated) return RT_ERR;
    if (protect) e->flags |= kFlagProtected;
    e->state = kSealed;
    if (e->refcnt > 0) e->refcnt--;  // drop creator pin
  }
  LedgerLock led(s);
  ledger_remove(s, id);
  return RT_OK;
}

int rt_store_seal(void* handle, const uint8_t* id) {
  return rt_store_seal2(handle, id, 0);
}

// Abort an in-progress creation (e.g. serialization failed mid-write).
int rt_store_abort(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  uint64_t off;
  {
    ShardLock lk(s, si);
    Entry* e = find_entry_in(s, si, id);
    if (!e) return RT_NOT_FOUND;
    if (e->state != kCreated) return RT_ERR;
    off = e->offset;
    make_tombstone(s, si, e);
  }
  {
    LedgerLock led(s);
    ledger_remove(s, id);
  }
  MainLock main(s);
  arena_free(s, off);
  return RT_OK;
}

// ---- inline-put slot slab -------------------------------------------------

// Reserve up to `n` fixed-size blocks for this client's inline-put slab.
// One MAIN acquisition amortizes the allocator across the whole batch; the
// client pre-faults the returned ranges once, and each small put then costs
// a single shard-lock publish.  Reserved blocks are recorded in the
// client's slab ledger so reap/detach reclaims them.  Returns the number
// actually reserved (0 under arena pressure — callers fall back to the
// create path, which can evict; reservation itself never evicts).
uint64_t rt_store_reserve_slots(void* handle, uint64_t slot_size, uint64_t n,
                                uint64_t* out_offsets) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx < 0) return 0;
  ClientSlot* c = &s->clients()[s->client_idx];
  uint64_t got = 0;
  {
    LedgerLock led(s);
    uint64_t room = kMaxSlabSlots - c->nslabs;
    if (n > room) n = room;
  }
  if (n == 0) return 0;
  {
    MainLock main(s);
    for (uint64_t i = 0; i < n; i++) {
      uint64_t off = arena_alloc(s, slot_size);
      if (!off) break;
      out_offsets[got++] = off;
    }
  }
  {
    LedgerLock led(s);
    for (uint64_t i = 0; i < got && c->nslabs < kMaxSlabSlots; i++) {
      c->slab_offs[c->nslabs++] = out_offsets[i];
    }
  }
  return got;
}

// Return unused reserved slots to the general allocator (slab shrink /
// close-time cleanup).
void rt_store_release_slots(void* handle, const uint64_t* offsets,
                            uint64_t n) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx < 0) return;
  ClientSlot* c = &s->clients()[s->client_idx];
  {
    LedgerLock led(s);
    for (uint64_t i = 0; i < n; i++) slab_ledger_remove(c, offsets[i]);
  }
  MainLock main(s);
  for (uint64_t i = 0; i < n; i++) arena_free(s, offsets[i]);
}

// Publish a payload written into a reserved slot as a SEALED object: one
// shard-lock acquisition, no allocator traffic, no creator-pin round trip.
// `size` is the actual payload length (<= the reserved slot size; the
// block's boundary tags keep the true block size for the eventual free).
// On RT_EXISTS / RT_NO_SPACE the slot stays in the client's slab ledger
// for reuse.
int rt_store_publish_slot(void* handle, const uint8_t* id, uint64_t offset,
                          uint64_t size, int protect) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx < 0) return RT_NO_CLIENT_SLOT;
  ClientSlot* c = &s->clients()[s->client_idx];
  uint32_t si = shard_of(id);
  // Consume the slab ledger entry FIRST: once the sealed entry is visible,
  // the block belongs to the index (freed via delete/evict), and a crash
  // must never leave it in BOTH ledgers (reap would free a live entry's
  // block).  A crash in the window after this and before the insert leaks
  // the block — bounded, and reclaimed at arena teardown.
  {
    LedgerLock led(s);
    if (!slab_ledger_remove(c, offset)) return RT_ERR;  // not ours
  }
  {
    ShardLock lk(s, si);
    if (!ensure_shard_room(s, si)) {
      LedgerLock led(s);
      if (c->nslabs < kMaxSlabSlots) c->slab_offs[c->nslabs++] = offset;
      return RT_NO_SPACE;
    }
    bool reused_tomb = false;
    Entry* e = find_slot_in(s, si, id, &reused_tomb);
    if (e && (e->state == kCreated || e->state == kSealed)) {
      LedgerLock led(s);
      if (c->nslabs < kMaxSlabSlots) c->slab_offs[c->nslabs++] = offset;
      return RT_EXISTS;
    }
    if (!e) {
      LedgerLock led(s);
      if (c->nslabs < kMaxSlabSlots) c->slab_offs[c->nslabs++] = offset;
      return RT_NO_SPACE;
    }
    Shard* sh = &s->hdr()->shards[si];
    if (e->state == kEmpty)
      sh->used++;
    else if (reused_tomb)
      sh->tombstones--;
    memcpy(e->id, id, kIdLen);
    e->offset = offset;
    e->size = size;
    e->state = kSealed;
    e->refcnt = 0;
    e->flags = protect ? kFlagProtected : 0;
    e->last_access =
        __atomic_add_fetch(&s->hdr()->access_clock, 1, __ATOMIC_RELAXED);
    sh->live++;
  }
  return RT_OK;
}

// Look up a sealed object; pins it (caller must rt_store_unpin).
int rt_store_get(void* handle, const uint8_t* id, uint64_t* out_offset,
                 uint64_t* out_size) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client_idx < 0) return RT_NO_CLIENT_SLOT;
  uint32_t si = shard_of(id);
  // ledger first: a crash between ledger_add and refcnt++ leaves a pin
  // record for an un-bumped refcnt, which release_client_state clamps
  ShardLock lk(s, si);
  Entry* e = find_entry_in(s, si, id);
  if (!e) return RT_NOT_FOUND;
  if (e->state != kSealed) return RT_NOT_SEALED;
  {
    LedgerLock led(s);
    int rc = ledger_add(s, id);
    if (rc != RT_OK) return rc;
  }
  e->refcnt++;
  e->last_access =
      __atomic_add_fetch(&s->hdr()->access_clock, 1, __ATOMIC_RELAXED);
  *out_offset = e->offset;
  *out_size = e->size;
  return RT_OK;
}

int rt_store_contains(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  ShardLock lk(s, si);
  Entry* e = find_entry_in(s, si, id);
  return (e && e->state == kSealed) ? 1 : 0;
}

int rt_store_unpin(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  {
    ShardLock lk(s, si);
    Entry* e = find_entry_in(s, si, id);
    if (!e) return RT_NOT_FOUND;
    if (e->refcnt > 0) e->refcnt--;
  }
  LedgerLock led(s);
  ledger_remove(s, id);
  return RT_OK;
}

// Delete a sealed object (refuses if pinned by readers).
int rt_store_delete(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  uint64_t off;
  {
    ShardLock lk(s, si);
    Entry* e = find_entry_in(s, si, id);
    if (!e || e->state == kTombstone) return RT_NOT_FOUND;
    if (e->refcnt > 0) return RT_PINNED;
    off = e->offset;
    make_tombstone(s, si, e);
  }
  MainLock main(s);
  arena_free(s, off);
  return RT_OK;
}

// Release pins of dead clients; returns number of clients reaped.
int rt_store_reap(void* handle) {
  Store* s = reinterpret_cast<Store*>(handle);
  StopWorld lock(s);
  return reap_dead_clients(s);
}

void rt_store_stats(void* handle, uint64_t* capacity, uint64_t* used,
                    uint64_t* objects, uint64_t* evictions) {
  Store* s = reinterpret_cast<Store*>(handle);
  MainLock main(s);
  Header* h = s->hdr();
  uint64_t live = 0;
  for (uint32_t i = 0; i < kShards; i++) {
    // relaxed read: live is mutated under the shard lock; stats tolerate
    // a torn-by-one snapshot (they always did — the old single lock only
    // ordered against writers, not against the world changing after)
    live += __atomic_load_n(&h->shards[i].live, __ATOMIC_RELAXED);
  }
  *capacity = h->data_size;
  *used = h->used_bytes;
  *objects = live;
  *evictions = h->num_evictions;
}

// Set / clear the protected (primary-copy) bit.  Protected entries are
// skipped by LRU eviction; the node's spill manager writes them to disk
// and clears the bit (or deletes them) when the arena fills.
int rt_store_protect(void* handle, const uint8_t* id, int on) {
  Store* s = reinterpret_cast<Store*>(handle);
  uint32_t si = shard_of(id);
  ShardLock lk(s, si);
  Entry* e = find_entry_in(s, si, id);
  if (!e || e->state == kTombstone || e->state == kEmpty) return RT_NOT_FOUND;
  if (on)
    e->flags |= kFlagProtected;
  else
    e->flags &= ~kFlagProtected;
  return RT_OK;
}

// List spill candidates: sealed, unpinned, protected entries in LRU order
// (least recently used first).  Writes up to `max_n` ids (16 bytes each)
// into out_ids and their payload sizes into out_sizes; returns the count.
uint64_t rt_store_list_spillable(void* handle, uint8_t* out_ids,
                                 uint64_t* out_sizes, uint64_t max_n) {
  Store* s = reinterpret_cast<Store*>(handle);
  Header* h = s->hdr();
  // id/size are captured here, under the shard lock — a concurrent
  // create in the same shard may rewrite the sub-table (tombstone
  // purge), so entry pointers must not be dereferenced after the lock
  // is dropped.
  struct Cand {
    uint64_t access;
    uint64_t size;
    uint8_t id[kIdLen];
  };
  Cand* cands = static_cast<Cand*>(malloc(h->table_cap * sizeof(Cand)));
  if (!cands) return 0;
  uint64_t n = 0;
  uint64_t cap = s->shard_cap();
  for (uint32_t si = 0; si < kShards; si++) {
    ShardLock lk(s, si);
    Entry* tab = s->shard_table(si);
    for (uint64_t i = 0; i < cap; i++) {
      Entry* e = &tab[i];
      if (e->state == kSealed && e->refcnt == 0 &&
          (e->flags & kFlagProtected)) {
        cands[n].access = e->last_access;
        cands[n].size = e->size;
        memcpy(cands[n].id, e->id, kIdLen);
        n++;
      }
    }
  }
  qsort(cands, n, sizeof(Cand), [](const void* a, const void* b) {
    uint64_t aa = static_cast<const Cand*>(a)->access;
    uint64_t bb = static_cast<const Cand*>(b)->access;
    return (aa < bb) ? -1 : (aa > bb) ? 1 : 0;
  });
  uint64_t count = n < max_n ? n : max_n;
  for (uint64_t i = 0; i < count; i++) {
    memcpy(out_ids + i * kIdLen, cands[i].id, kIdLen);
    out_sizes[i] = cands[i].size;
  }
  free(cands);
  return count;
}

// Base address of the mapping in this process (for zero-copy memoryviews).
void* rt_store_base(void* handle) {
  return reinterpret_cast<Store*>(handle)->base;
}

uint64_t rt_store_map_size(void* handle) {
  return reinterpret_cast<Store*>(handle)->map_size;
}

}  // extern "C"
