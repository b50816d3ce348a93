// Native graph-simplification engine.
//
// C++ twin of sibelia_tpu/graph/{sequence,bifstore,simplify}.py — the
// host-side runtime of the framework (the role the reference's C++ plays
// around its pointer machine, here over flat arrays). Semantics are
// identical to the Python engine, which is differential-tested against
// the reference binary; this engine is differential-tested against the
// Python engine (tests/test_native_engine.py).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 dependency).
//
// Reference provenance for the algorithm:
//   bulge walks / collapse protocol  src/bulgeremoval.cpp
//   splice + position interpolation  src/dnasequence.cpp:189-252
//   point store (LIFO + lazy)        src/bifurcationstorage.cpp
//   bulge-order container            boost 1.54 unordered_map (mix64)
//   stage loop                       src/blockfinder.cpp:16-51

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <thread>
#include <dlfcn.h>
#include <unordered_map>
#include <vector>

namespace {

typedef int64_t i64;
typedef uint64_t u64;

const i64 NO_BIF = (1LL << 32) - 1;
const uint8_t EMPTY_CH = ' ';

uint8_t COMP[256];
struct CompInit {
    CompInit() {
        for (int i = 0; i < 256; i++) COMP[i] = (uint8_t)i;
        const char* a = "ATGCatgc";
        const char* b = "TACGtacg";
        for (int i = 0; i < 8; i++) COMP[(uint8_t)a[i]] = (uint8_t)b[i];
    }
} comp_init;

// ---------------------------------------------------------------------------
// boost 1.54 unordered_map iteration-order emulation (mix64 policy)
// ---------------------------------------------------------------------------

inline u64 mix64(u64 key) {
    key = (~key) + (key << 21);
    key = key ^ (key >> 24);
    key = (key + (key << 3)) + (key << 8);
    key = key ^ (key >> 14);
    key = (key + (key << 2)) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

// SIBELIA_TPU_PROF=2: per-sweep phase accumulators (detection walks vs
// collapse application vs store cleanup), reported by the sweep drivers.
// ---------------------------------------------------------------------------
// Slab-backed allocation for the big engine arrays.  When the ranking
// library has reserved its hugetlb-pooled arena slab
// (ranking.cpp::rank_slab_reserve), the node/sequence arrays carve from
// it via dlsym — riding the same pool pages (cheap re-acquisition
// across runs, 2 MB TLB entries for the walk-heavy sweep).  Slab memory
// is never freed back (the arrays live for the engine's lifetime; rare
// reallocation growth leaks a bounded amount into the slab).  Without
// the ranking library, or when the slab is absent/full, this is plain
// operator new/delete.
// ---------------------------------------------------------------------------
typedef void* (*SlabAllocFn)(long long);
typedef int (*SlabContainsFn)(const void*);
inline SlabAllocFn slab_alloc_fn() {
    static SlabAllocFn f =
        (SlabAllocFn)dlsym(RTLD_DEFAULT, "rank_slab_alloc");
    return f;
}
inline SlabContainsFn slab_contains_fn() {
    static SlabContainsFn f =
        (SlabContainsFn)dlsym(RTLD_DEFAULT, "rank_slab_contains");
    return f;
}
template <typename T>
struct SlabAlloc {
    typedef T value_type;
    SlabAlloc() {}
    template <class U>
    SlabAlloc(const SlabAlloc<U>&) {}
    T* allocate(size_t n) {
        if (SlabAllocFn f = slab_alloc_fn())
            if (void* p = f((long long)(n * sizeof(T)))) return (T*)p;
        return (T*)::operator new(n * sizeof(T));
    }
    void deallocate(T* p, size_t) {
        if (SlabContainsFn f = slab_contains_fn())
            if (f(p)) return;  // slab memory leaks back to the slab
        ::operator delete(p);
    }
    bool operator==(const SlabAlloc&) const { return true; }
    bool operator!=(const SlabAlloc&) const { return false; }
};
typedef std::vector<uint8_t, SlabAlloc<uint8_t> > SVecU8;
typedef std::vector<int8_t, SlabAlloc<int8_t> > SVecI8;
typedef std::vector<int32_t, SlabAlloc<int32_t> > SVecI32;
typedef std::vector<uint32_t, SlabAlloc<uint32_t> > SVecU32;

struct SweepStats {
    double detect_ms = 0, pairs_ms = 0, collapse_ms = 0, cleanup_ms = 0;
    double erase_ms = 0, replace_ms = 0, update_ms = 0, walk_ms = 0;
    double vec_ms = 0, bits_ms = 0, map_ms = 0, interp_ms = 0;
    i64 n_ids = 0, n_collapse = 0, n_delta = 0, n_swept = 0;
    void reset() { *this = SweepStats(); }
};
thread_local SweepStats g_sweep_stats;  // per-thread (wave detection)
bool prof2() {
    static int e = [] {
        const char* v = std::getenv("SIBELIA_TPU_PROF");
        return (v && v[0] == '2') ? 1 : 0;
    }();
    return e != 0;
}
struct Acc {
    double* slot;
    std::chrono::steady_clock::time_point t0;
    explicit Acc(double* s) : slot(s) {
        if (prof2()) t0 = std::chrono::steady_clock::now();
    }
    ~Acc() {
        if (prof2())
            *slot += std::chrono::duration<double, std::milli>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
    }
};

struct BoostMapValue {
    uint8_t end_char;
    std::vector<int> branch_ids;
};

struct BoostNode {
    u64 key;
    u64 hash;
    BoostMapValue value;
    BoostNode* next;
};

struct Boost154Map {
    size_t bucket_count;
    std::vector<BoostNode**> buckets;  // pointer to the link preceding the
                                       // bucket's first node (i.e. &link->next)
    // We model links as BoostNode* slots; the "previous link" is a pointer
    // to a `next` field. prev_start is the sentinel's next field.
    BoostNode* prev_start_next;
    size_t size;
    size_t max_load;
    bool buckets_created;
    std::deque<BoostNode> storage;

    Boost154Map() : bucket_count(16), prev_start_next(nullptr), size(0),
                    max_load(0), buckets_created(false) {}

    static size_t new_bucket_count(size_t minimum) {
        if (minimum <= 4) return 4;
        size_t m = minimum - 1;
        m |= m >> 1; m |= m >> 2; m |= m >> 4; m |= m >> 8; m |= m >> 16;
        m |= m >> 32;
        return m + 1;
    }

    size_t to_bucket(u64 h) const { return (size_t)(h & (bucket_count - 1)); }

    void create_buckets(size_t n) {
        bucket_count = n;
        buckets.assign(n, nullptr);
        max_load = n;
        buckets_created = true;
    }

    void rehash_impl(size_t num_buckets) {
        create_buckets(num_buckets);
        BoostNode** prev = &prev_start_next;
        while (*prev != nullptr) {
            BoostNode* n = *prev;
            size_t bi = to_bucket(n->hash);
            if (buckets[bi] == nullptr) {
                buckets[bi] = prev;
                prev = &n->next;
            } else {
                *prev = n->next;
                n->next = *buckets[bi];
                *buckets[bi] = n;
            }
        }
    }

    void reserve_for_insert(size_t want) {
        if (!buckets_created) {
            create_buckets(std::max(bucket_count, new_bucket_count(want + 1)));
        } else if (want > max_load) {
            size_t num = new_bucket_count(std::max(want, size + (size >> 1)) + 1);
            if (num != bucket_count) rehash_impl(num);
        }
    }

    BoostMapValue* find(u64 key) {
        if (!buckets_created || size == 0) return nullptr;
        u64 h = mix64(key);
        size_t bi = to_bucket(h);
        if (buckets[bi] == nullptr) return nullptr;
        BoostNode* n = *buckets[bi];
        while (n != nullptr && to_bucket(n->hash) == bi) {
            if (n->key == key) return &n->value;
            n = n->next;
        }
        return nullptr;
    }

    void insert(u64 key, uint8_t end_char, int branch) {
        u64 h = mix64(key);
        reserve_for_insert(size + 1);
        storage.push_back(BoostNode());
        BoostNode* n = &storage.back();
        n->key = key;
        n->hash = h;
        n->value.end_char = end_char;
        n->value.branch_ids.push_back(branch);
        n->next = nullptr;
        size_t bi = to_bucket(h);
        if (buckets[bi] == nullptr) {
            if (prev_start_next != nullptr) {
                buckets[to_bucket(prev_start_next->hash)] = &n->next;
            }
            buckets[bi] = &prev_start_next;
            n->next = prev_start_next;
            prev_start_next = n;
        } else {
            n->next = *buckets[bi];
            *buckets[bi] = n;
        }
        size++;
    }
};

// ---------------------------------------------------------------------------
// mark bitmap: one bit per position, used to iterate bifurcation marks in
// O(marks + gap/64) instead of O(gap) during branch walks.  The reference
// walks its unrolled list element-by-element (bulgeremoval.cpp:158-218);
// at stage depths d up to 15000 that is the engine's dominant cost, and
// marks are sparse — the bitmap turns detection into a sparse iteration.
// ---------------------------------------------------------------------------

// position -> node-index map per (strand, chromosome), PAGED: one small
// open-addressing table per 4096-position page, slot = (rel+1)<<32 | idx
// (rel = pos within page; 0 = empty, 1 = tombstone).  Two properties the
// former chromosome-global table lacked:
//   * a length-changing splice rebuilds only the pages at/after the
//     span — a sequential scan of the (already-spliced) mark bits
//     streams (new_pos -> old_pos -> idx) through cache-resident page
//     tables, instead of a ~500k-entry global rehash per splice (which
//     dominated the stage-1 sweep);
//   * branch walks probe positions in ascending order, so consecutive
//     find()s hit the same (L1-resident) page table instead of random
//     slots of a multi-MB global one.
// Memory stays per NODE (the dense int32-per-position tables this
// design replaced were 4 B/pos/strand — 8.6 GB at the 1 GB cap).
// Occupancy iteration stays on the MarkBits bitmaps.
const int kPageShift = 12;
const i64 kPageW = (i64)1 << kPageShift;

struct PosPage {
    std::vector<u64> t;
    uint32_t used = 0;  // non-empty slots (live + tombstones)
};

struct PosMap {
    std::vector<PosPage> pages;

    static inline size_t hash_rel(i64 rel) {
        return (size_t)((u64)(rel + 1) * 2654435761u);
    }
    void reset(i64 len) {
        pages.assign((size_t)((len + kPageW - 1) >> kPageShift),
                     PosPage());
    }
    static i64 find_pages(const std::vector<PosPage>& pages, i64 pos) {
        size_t pg = (size_t)(pos >> kPageShift);
        if (pos < 0 || pg >= pages.size()) return -1;
        const std::vector<u64>& t = pages[pg].t;
        if (t.empty()) return -1;
        size_t mask = t.size() - 1;
        i64 rel = pos & (kPageW - 1);
        u64 key = (u64)(rel + 1) << 32;
        for (size_t h = hash_rel(rel) & mask;; h = (h + 1) & mask) {
            u64 v = t[h];
            if (v == 0) return -1;
            if (v != 1 && (v & 0xFFFFFFFF00000000ULL) == key)
                return (i64)(uint32_t)v;
        }
    }
    i64 find(i64 pos) const { return find_pages(pages, pos); }
    // presized, tombstone-free insert for page rebuilds
    static void raw_insert(PosPage& p, i64 rel, i64 idx) {
        size_t mask = p.t.size() - 1;
        u64 key = ((u64)(rel + 1) << 32) | (u64)(uint32_t)idx;
        size_t h = hash_rel(rel) & mask;
        while (p.t[h] != 0) h = (h + 1) & mask;
        p.t[h] = key;
    }
    void insert(i64 pos, i64 idx) {
        PosPage& p = pages[(size_t)(pos >> kPageShift)];
        // grow/clean when fewer than 1/4 of slots would stay empty
        if (p.t.empty() || (p.used + 1) * 4 > p.t.size() * 3) grow(p);
        size_t mask = p.t.size() - 1;
        i64 rel = pos & (kPageW - 1);
        u64 key = ((u64)(rel + 1) << 32) | (u64)(uint32_t)idx;
        size_t h = hash_rel(rel) & mask;
        for (;; h = (h + 1) & mask) {
            u64 v = p.t[h];
            if (v == 0) { ++p.used; break; }
            if (v == 1) break;  // reuse tombstone; used already counts it
        }
        p.t[h] = key;
    }
    void erase(i64 pos) {
        size_t pg = (size_t)(pos >> kPageShift);
        if (pos < 0 || pg >= pages.size()) return;
        std::vector<u64>& t = pages[pg].t;
        if (t.empty()) return;
        size_t mask = t.size() - 1;
        i64 rel = pos & (kPageW - 1);
        u64 key = (u64)(rel + 1) << 32;
        for (size_t h = hash_rel(rel) & mask;; h = (h + 1) & mask) {
            u64 v = t[h];
            if (v == 0) return;
            if (v != 1 && (v & 0xFFFFFFFF00000000ULL) == key) {
                t[h] = 1;  // tombstone; stays in `used` until grow()
                return;
            }
        }
    }
    static void grow(PosPage& p) {
        size_t live = 0;
        for (size_t i = 0; i < p.t.size(); i++) live += (p.t[i] > 1);
        size_t want = 8;
        while (want < (live + 1) * 2) want <<= 1;
        std::vector<u64> nt(want, 0);
        size_t mask = want - 1;
        for (size_t i = 0; i < p.t.size(); i++) {
            u64 v = p.t[i];
            if (v <= 1) continue;
            i64 rel = (i64)(v >> 32) - 1;
            size_t h = hash_rel(rel) & mask;
            while (nt[h] != 0) h = (h + 1) & mask;
            nt[h] = v;
        }
        p.t.swap(nt);
        p.used = (uint32_t)live;
    }
};

struct MarkBits {
    std::vector<u64> w;  // bit per position
    i64 n;

    void init(i64 count) {
        n = count;
        w.assign((size_t)((count + 63) >> 6), 0);
    }
    void set(i64 p) { w[(size_t)(p >> 6)] |= (u64)1 << (p & 63); }
    void clear(i64 p) { w[(size_t)(p >> 6)] &= ~((u64)1 << (p & 63)); }
    // first set bit at index >= p, or -1
    i64 next_set(i64 p) const {
        if (p >= n) return -1;
        size_t wi = (size_t)(p >> 6);
        u64 word = w[wi] & (~(u64)0 << (p & 63));
        while (word == 0) {
            if (++wi >= w.size()) return -1;
            word = w[wi];
        }
        return ((i64)wi << 6) + __builtin_ctzll(word);
    }
    // last set bit at index <= p, or -1
    i64 prev_set(i64 p) const {
        if (p < 0) return -1;
        if (p >= n) p = n - 1;
        size_t wi = (size_t)(p >> 6);
        u64 word = w[wi] & (~(u64)0 >> (63 - (p & 63)));
        while (word == 0) {
            if (wi == 0) return -1;
            word = w[--wi];
        }
        return ((i64)wi << 6) + 63 - __builtin_clzll(word);
    }
    // set bits in [p0, p1), counted word-aligned (p0 word-aligned by the
    // callers; p1 may be the array end)
    i64 count_range(i64 p0, i64 p1) const {
        if (p1 > n) p1 = n;
        if (p0 >= p1) return 0;
        size_t w0 = (size_t)(p0 >> 6);
        size_t w1 = (size_t)((p1 + 63) >> 6);
        if (w1 > w.size()) w1 = w.size();
        i64 c = 0;
        for (size_t i = w0; i < w1; i++) c += __builtin_popcountll(w[i]);
        return c;
    }
    // splice [start, stop) -> new_len positions: clear the span, then
    // shift bits at >= stop by (new_len - (stop - start)).  Word-level
    // extract + rewrite: O(suffix/64), far below the caller's O(suffix)
    // array maintenance.
    void splice(i64 start, i64 stop, i64 new_len) {
        i64 delta = new_len - (stop - start);
        i64 old_n = n;
        // extract suffix bits [stop, old_n) into a temp, LSB-aligned
        i64 suffix = old_n - stop;
        std::vector<u64> tmp((size_t)((suffix + 63) >> 6) + 1, 0);
        for (i64 i = 0; i < suffix; i += 64) {
            // read 64 bits starting at stop + i
            i64 p = stop + i;
            size_t wi = (size_t)(p >> 6);
            int off = (int)(p & 63);
            u64 v = w[wi] >> off;
            if (off && wi + 1 < w.size()) v |= w[wi + 1] << (64 - off);
            tmp[(size_t)(i >> 6)] = v;
        }
        n = old_n + delta;
        w.resize((size_t)((n + 63) >> 6), 0);
        // clear everything from start on
        {
            size_t wi = (size_t)(start >> 6);
            if (wi < w.size()) {
                w[wi] &= ~(~(u64)0 << (start & 63));
                for (size_t j = wi + 1; j < w.size(); j++) w[j] = 0;
            }
        }
        // write suffix back at start + new_len
        i64 dst = start + new_len;
        for (i64 i = 0; i < suffix; i += 64) {
            u64 v = tmp[(size_t)(i >> 6)];
            i64 rem = suffix - i;
            if (rem < 64) v &= (~(u64)0 >> (64 - rem));
            if (v == 0) continue;
            i64 p = dst + i;
            size_t wi = (size_t)(p >> 6);
            int off = (int)(p & 63);
            w[wi] |= v << off;
            if (off && wi + 1 < w.size()) w[wi + 1] |= v >> (64 - off);
        }
    }
};

// ---------------------------------------------------------------------------
// engine state
// ---------------------------------------------------------------------------

// reference: src/util.cpp:89-111 PutProgressChr 50-dot console bar;
// states mirror BlockFinder::State (start=0, run=1, end=2)
typedef void (*ProgressFn)(long long progress, int state);
const i64 PROGRESS_STRIDE = 50;

// Device bulge-candidate detection hook: the sparse sweep's
// re-prefilter (a frozen-state detection pass) can be served by an
// external engine — in production a JAX/Pallas banded self-join over
// the exported instance table (native/__init__.py::_device_reprefilter,
// kernel: index/enumeration.py::_candidate_scan).  The callback fills
// cand_out[n_ids] and returns nonzero; zero falls back to the host
// prefilter.  Any SUPERSET of "AnyBulges reports a group" keeps the
// sweep byte-exact (the sparse-driver invariant).
typedef long long (*ReprefilterFn)(uint8_t* cand_out, long long n_ids);

struct Engine {
    ProgressFn progress_fn = nullptr;
    ReprefilterFn reprefilter_fn = nullptr;
    int n_chr;
    std::vector<SVecU8> chars;
    std::vector<SVecI32> origpos;  // fits the 1 GB input cap
    std::vector<i64> sep_origpos;
    // bifurcation store: per (strand, chr) position -> node index
    // (int32: node count is bounded by instances + collapse re-adds,
    // far under 2^31; halves the delta-splice memmoves)
    std::vector<PosMap> bif_at[2];  // per (strand, chr) pos -> node idx
    std::vector<MarkBits> mark_bits[2];  // mark presence per (strand, chr)
    SVecI8 node_strand;
    SVecI32 node_chr;
    SVecI32 node_pos;   // chromosome positions fit int32 (1 GB cap)
    SVecU32 node_bif;  // ids < 2^32; NO_BIF == 0xFFFFFFFF fits
    // Dead node slots are recycled (cleanup() frees an unlinked slot,
    // add_point pops).  Without reuse the node arrays grow by ~2(k+sd)
    // entries per collapse — ~50M slots on a 32 MB 16-strain stage-1
    // sweep — an unbounded footprint and cold caches for every indexed
    // read.  Reuse is invisible to the wave cache: a cached detection
    // references a node only via start_nodes, every member of which has
    // node_bif == that detection's id, so erasing it (the only way a
    // slot reaches the free list) flags the id and invalidates the
    // cache before the slot can be recycled.
    SVecI32 free_nodes;
    i64 max_id;
    // per-(strand, bifId) point lists: intrusive singly-linked lists over
    // node indices (front-insert == the reference's slist push_front,
    // bifurcationstorage.h:113-126).  A deque per id cost ~600 B of
    // allocation each across ~1M ids per stage; the intrusive form is
    // three flat arrays.  cnt[] counts entries still linked, INCLUDING
    // lazily-dead ones until cleanup() unlinks them (the reference's
    // CountBifurcations reads the list size under the same laziness).
    std::vector<int32_t> list_head[2]; // per bifId, -1 = empty
    std::vector<int32_t> list_cnt[2];  // per bifId
    SVecI32 node_next;    // per node, -1 = end
    std::vector<std::pair<std::pair<int, i64>, i64> > to_clear;  // ((strand,bif),idx)

    // Visit scheduling (output-exact sparse iteration): the reference
    // visits every id every iteration, but RemoveBulges returns before
    // touching any state when AnyBulges finds nothing
    // (src/bulgeremoval.cpp:335-353), so skipping ids PROVEN bulge-free
    // is invisible in the output.  While a sweep runs, every store
    // mutation flags the ids whose detection outcome could have changed:
    // ids of erased/added marks directly (hooks below), plus ids of all
    // marks whose walk window overlaps a rewritten span (collapse_bulge
    // calls mark_walk_neighbors).  Flags route to the current sweep when
    // the id is still ahead of the cursor, else to the next sweep.
    bool tracking = false;
    i64 cur_id = 0;
    i64 mb_cur = 0;  // min_branch of the running sweep (walk radius)
    std::vector<uint8_t> visit_now, visit_next;
    // wave-scheduler invalidation epochs (see the scheduler header below)
    i64 apply_step = 0;
    std::vector<i64> touched_at;   // per bif id
    std::vector<i64> count_epoch;  // per bif id
    std::vector<i64> delta_epoch;  // per chromosome

    void flag_id(i64 bif) {
        if (bif == NO_BIF) return;
        if (bif > cur_id) visit_now[(size_t)bif] = 1;
        else visit_next[(size_t)bif] = 1;
        touched_at[(size_t)bif] = apply_step;
    }

    i64 get_node_at(int strand, int c, i64 pos) const {
        return bif_at[strand][c].find(pos);
    }
    i64 get_bif(int strand, int c, i64 pos) const {
        i64 idx = bif_at[strand][c].find(pos);
        return idx < 0 ? NO_BIF : (i64)node_bif[idx];
    }
    size_t count_bifurcations(i64 bif) const {
        return (size_t)(list_cnt[0][bif] + list_cnt[1][bif]);
    }
    void add_point(int strand, int c, i64 pos, i64 bif) {
        if (bif == NO_BIF) return;
        if (bif_at[strand][c].find(pos) >= 0) return;
        i64 idx;
        if (!free_nodes.empty()) {
            idx = (i64)free_nodes.back();
            free_nodes.pop_back();
            node_strand[idx] = (int8_t)strand;
            node_chr[idx] = c;
            node_pos[idx] = pos;
            node_bif[idx] = bif;
            node_next[idx] = list_head[strand][bif];
        } else {
            idx = (i64)node_strand.size();
            node_strand.push_back((int8_t)strand);
            node_chr.push_back(c);
            node_pos.push_back(pos);
            node_bif.push_back(bif);
            node_next.push_back(list_head[strand][bif]);
        }
        bif_at[strand][c].insert(pos, idx);
        mark_bits[strand][c].set(pos);
        list_head[strand][bif] = idx;
        list_cnt[strand][bif]++;
        if (tracking) {
            flag_id(bif);
            count_epoch[(size_t)bif] = apply_step;
        }
    }
    void erase_point(int strand, int c, i64 pos) {
        i64 idx = bif_at[strand][c].find(pos);
        if (idx < 0) return;
        i64 bif = node_bif[idx];
        bif_at[strand][c].erase(pos);
        mark_bits[strand][c].clear(pos);
        node_bif[idx] = NO_BIF;
        to_clear.push_back(std::make_pair(std::make_pair(strand, bif), idx));
        if (tracking) flag_id(bif);
    }
    void cleanup() {
        Acc _acc_cl(&g_sweep_stats.cleanup_ms);
        for (size_t i = 0; i < to_clear.size(); i++) {
            int strand = to_clear[i].first.first;
            i64 bif = to_clear[i].first.second;
            i64 idx = to_clear[i].second;
            int32_t* link = &list_head[strand][bif];
            while (*link >= 0 && *link != idx) link = &node_next[*link];
            if (*link == idx) {
                *link = node_next[idx];
                list_cnt[strand][bif]--;
                if (tracking) count_epoch[(size_t)bif] = apply_step;
                free_nodes.push_back((int32_t)idx);  // slot recycled
            }
        }
        to_clear.clear();
    }
    void apply_splice(int c, i64 start, i64 stop, i64 new_len) {
        // The collapse protocol has already erased every mark in the
        // span (entries AND bits), so for delta == 0 there is nothing
        // to do; for delta != 0 the bits shift (word-level) and only
        // the map pages at/after the span rebuild: a sequential scan
        // of the spliced bits streams (new_pos -> old_pos -> idx)
        // through cache-resident page tables, rebasing node_pos as it
        // goes.  Head pages are untouched; work is O(marks at/after
        // the span), not O(live nodes of the chromosome).
        i64 delta = new_len - (stop - start);
        if (delta == 0) return;
        {
            Acc _a_bits(&g_sweep_stats.bits_ms);
            for (int strand = 0; strand < 2; strand++)
                mark_bits[strand][c].splice(start, stop, new_len);
        }
        Acc _a_map(&g_sweep_stats.map_ms);
        i64 n_new = (i64)chars[c].size();  // caller spliced chars already
        size_t first_page = (size_t)(start >> kPageShift);
        size_t n_pages_new = (size_t)((n_new + kPageW - 1) >> kPageShift);
        for (int strand = 0; strand < 2; strand++) {
            PosMap& m = bif_at[strand][c];
            std::vector<PosPage> old_pages;
            old_pages.swap(m.pages);
            m.pages.resize(n_pages_new);
            size_t keep = first_page;
            if (keep > old_pages.size()) keep = old_pages.size();
            if (keep > n_pages_new) keep = n_pages_new;
            for (size_t pg = 0; pg < keep; pg++)
                m.pages[pg] = std::move(old_pages[pg]);
            const MarkBits& bits = mark_bits[strand][c];
            for (size_t pg = keep; pg < n_pages_new; pg++) {
                i64 base = (i64)pg << kPageShift;
                i64 end = base + kPageW;
                if (end > n_new) end = n_new;
                i64 cnt = bits.count_range(base, end);
                if (cnt == 0) continue;
                g_sweep_stats.n_swept += cnt;
                PosPage& np = m.pages[pg];
                size_t want = 8;
                while ((i64)want < cnt * 2) want <<= 1;
                np.t.assign(want, 0);
                np.used = (uint32_t)cnt;
                for (i64 p = bits.next_set(base); p >= 0 && p < end;
                     p = bits.next_set(p + 1)) {
                    // marks below the span keep their position; marks
                    // past it map back by -delta (the span itself has
                    // no marks: the collapse protocol erased them)
                    i64 old = p < start ? p : p - delta;
                    i64 idx = PosMap::find_pages(old_pages, old);
                    node_pos[idx] = (int32_t)p;
                    PosMap::raw_insert(np, p & (kPageW - 1), idx);
                }
            }
        }
        if (tracking) delta_epoch[(size_t)c] = apply_step;
    }
};

inline i64 advance(i64 pos, int strand, i64 n) {
    return strand == 0 ? pos + n : pos - n;
}

// Flag every id owning a mark whose detection walk can see the rewritten
// span [span_start, span_start + sd) on chromosome c (post-splice
// coordinates).  The collapse protocol touches marks at most k outside
// the span on either side; a 2k margin bounds that and the
// chromosome-shrink proper_kmer edge cases.  A positive-strand walk from
// p covers (p, p + mb); a negative-strand walk covers (p - mb, p).
void mark_walk_neighbors(Engine& e, i64 k, int c, i64 span_start, i64 sd) {
    i64 len = (i64)e.chars[c].size();
    i64 lo = span_start - 2 * k;
    i64 hi = span_start + sd + 2 * k;
    for (int strand = 0; strand < 2; strand++) {
        i64 wlo = strand == 0 ? lo - e.mb_cur : lo;
        i64 whi = strand == 0 ? hi : hi + e.mb_cur;
        if (wlo < 0) wlo = 0;
        if (whi > len - 1) whi = len - 1;
        const MarkBits& bits = e.mark_bits[strand][c];
        const PosMap& arr = e.bif_at[strand][c];
        for (i64 p = bits.next_set(wlo); p >= 0 && p <= whi;
             p = bits.next_set(p + 1)) {
            e.flag_id(e.node_bif[arr.find(p)]);
        }
    }
}

inline uint8_t char_at(const Engine& e, int strand, int c, i64 pos) {
    uint8_t b = e.chars[c][pos];
    return strand ? COMP[b] : b;
}

bool proper_kmer(const Engine& e, int strand, int c, i64 pos, i64 k) {
    if (strand == 0) return pos >= 0 && pos + k <= (i64)e.chars[c].size();
    return pos < (i64)e.chars[c].size() && pos - k >= -1;
}

// walk forward collecting bifurcation marks at steps 1..max_steps-1
struct Mark { i64 step; i64 node; };

void scan_forward(const Engine& e, int strand, int c, i64 pos, i64 max_steps,
                  std::vector<Mark>& out) {
    out.clear();
    const PosMap& arr = e.bif_at[strand][c];
    const MarkBits& bits = e.mark_bits[strand][c];
    if (strand == 0) {
        i64 hi = std::min(pos + max_steps, (i64)e.chars[c].size());
        for (i64 p = bits.next_set(pos + 1); p >= 0 && p < hi;
             p = bits.next_set(p + 1)) {
            Mark m = {p - pos, arr.find(p)};
            out.push_back(m);
        }
    } else {
        i64 lo = std::max(pos - max_steps + 1, (i64)0);
        for (i64 p = bits.prev_set(pos - 1); p >= lo;
             p = bits.prev_set(p - 1)) {
            Mark m = {pos - p, arr.find(p)};
            out.push_back(m);
        }
    }
}

void fill_visit(const Engine& e, int strand, int c, i64 pos, i64 min_branch,
                std::vector<std::pair<i64, i64> >& out) {
    out.clear();
    i64 start = e.get_bif(strand, c, pos);
    std::vector<Mark> marks;
    scan_forward(e, strand, c, pos, min_branch, marks);
    for (size_t i = 0; i < marks.size(); i++) {
        i64 b = e.node_bif[marks[i].node];
        if (b == start) break;
        out.push_back(std::make_pair(b, marks[i].step));
    }
    std::sort(out.begin(), out.end());
}

bool overlap(const Engine& e, i64 k, i64 a_idx, i64 a_dist, i64 b_idx, i64 b_dist) {
    if (e.node_chr[a_idx] != e.node_chr[b_idx]) return false;
    i64 a0, a1, b0, b1;
    if (e.node_strand[a_idx] == 0) { a0 = e.node_pos[a_idx]; a1 = a0 + a_dist + k; }
    else { a1 = e.node_pos[a_idx] + 1; a0 = a1 - a_dist - k; }
    if (e.node_strand[b_idx] == 0) { b0 = e.node_pos[b_idx]; b1 = b0 + b_dist + k; }
    else { b1 = e.node_pos[b_idx] + 1; b0 = b1 - b_dist - k; }
    return a0 < b1 && b0 < a1;
}

i64 max_bif_multiplicity(const Engine& e, i64 idx, i64 distance) {
    int strand = e.node_strand[idx];
    int c = e.node_chr[idx];
    i64 pos = e.node_pos[idx];
    std::vector<Mark> marks;
    scan_forward(e, strand, c, pos, distance, marks);
    i64 ret = 0;
    for (size_t i = 0; i < marks.size(); i++) {
        i64 cnt = (i64)e.count_bifurcations(e.node_bif[marks[i].node]);
        if (cnt > ret) ret = cnt;
    }
    return ret;
}

void collapse_bulge(Engine& e, i64 k, i64 src_idx, i64 src_dist,
                    i64 tgt_idx, i64 tgt_dist) {
    Acc _acc_col(&g_sweep_stats.collapse_ms);
    if (prof2()) {
        g_sweep_stats.n_collapse++;
        if (src_dist != tgt_dist) g_sweep_stats.n_delta++;
    }
    int s_t = e.node_strand[tgt_idx];
    int c_t = e.node_chr[tgt_idx];
    i64 p_t = e.node_pos[tgt_idx];
    int s_s = e.node_strand[src_idx];
    int c_s = e.node_chr[src_idx];
    i64 p_s = e.node_pos[src_idx];
    i64 td = tgt_dist, sd = src_dist;

    // 1. EraseBifurcations
    std::vector<std::pair<i64, i64> > look_back, look_forward;
    {
    Acc _a(&g_sweep_stats.erase_ms);
    for (i64 i = 0; i < k; i++) {
        i64 a_coord = s_t == 0 ? p_t + k - 1 - i : p_t - (k - 1 - i);
        i64 b = e.get_bif(1 - s_t, c_t, a_coord);
        if (b != NO_BIF) {
            e.erase_point(1 - s_t, c_t, a_coord);
            look_back.push_back(std::make_pair(i, b));
        }
        i64 b_coord = advance(p_t, s_t, td + i);
        b = e.get_bif(s_t, c_t, b_coord);
        if (b != NO_BIF) {
            e.erase_point(s_t, c_t, b_coord);
            look_forward.push_back(std::make_pair(i, b));
        }
    }
    for (i64 eidx = 0; eidx < k + td; eidx++) {
        if (eidx > 0) e.erase_point(s_t, c_t, advance(p_t, s_t, eidx));
        e.erase_point(1 - s_t, c_t, advance(p_t, s_t, k + td - 1 - eidx));
    }

    }
    // 2. Replace: spell source interior on source strand
    Acc _a_rep(&g_sweep_stats.replace_ms);
    std::vector<uint8_t> content((size_t)sd);
    {
        i64 q = advance(p_s, s_s, k);
        if (s_s == 0) {
            for (i64 i = 0; i < sd; i++) content[i] = e.chars[c_s][q + i];
        } else {
            for (i64 i = 0; i < sd; i++) content[i] = COMP[e.chars[c_s][q - i]];
        }
    }
    i64 span_start, span_stop;
    if (s_t == 0) { span_start = p_t + k; span_stop = p_t + k + td; }
    else {
        span_start = p_t - k - td + 1; span_stop = p_t - k + 1;
        // reverse complement for the positive frame
        std::vector<uint8_t> rc((size_t)sd);
        for (i64 i = 0; i < sd; i++) rc[i] = COMP[content[sd - 1 - i]];
        content.swap(rc);
    }
    i64 first_pos = (i64)e.origpos[c_t][span_start];
    i64 last_pos = (span_start + td == (i64)e.chars[c_t].size())
                       ? e.sep_origpos[c_t]
                       : (i64)e.origpos[c_t][span_start + td];
    {
        Acc _a_vec(&g_sweep_stats.vec_ms);
        SVecU8& ch = e.chars[c_t];
        SVecI32& op = e.origpos[c_t];
        i64 delta = sd - td;
        if (delta == 0) {
            std::memcpy(ch.data() + span_start, content.data(), (size_t)sd);
        } else if (delta < 0) {
            ch.erase(ch.begin() + span_start + sd, ch.begin() + span_stop);
            std::memcpy(ch.data() + span_start, content.data(), (size_t)sd);
            op.erase(op.begin() + span_start + sd, op.begin() + span_stop);
        } else {
            ch.insert(ch.begin() + span_stop, (size_t)delta, (uint8_t)0);
            std::memcpy(ch.data() + span_start, content.data(), (size_t)sd);
            op.insert(op.begin() + span_stop, (size_t)delta, (int32_t)0);
        }
    }
    e.apply_splice(c_t, span_start, span_stop, sd);
    {
        Acc _a_int(&g_sweep_stats.interp_ms);
        double acc = (double)first_pos;
        double ssize = (double)td / (double)sd;
        SVecI32& op = e.origpos[c_t];
        for (i64 step = 0; step < sd; step++) {
            i64 v = (i64)acc;
            op[span_start + step] = (int32_t)(v < last_pos ? v : last_pos);
            acc += ssize;
        }
    }

    // 3. UpdateBifurcations
    Acc _a_upd(&g_sweep_stats.update_ms);
    p_t = e.node_pos[tgt_idx];
    p_s = e.node_pos[src_idx];
    size_t anear = 0, bnear = 0;
    for (i64 i = 0; i < k; i++) {
        i64 a_coord = s_t == 0 ? p_t + k - 1 - i : p_t - (k - 1 - i);
        if (anear < look_back.size() && look_back[anear].first == i) {
            e.add_point(1 - s_t, c_t, a_coord, look_back[anear].second);
            anear++;
        }
        i64 b_coord = advance(p_t, s_t, sd + i);
        if (bnear < look_forward.size() && look_forward[bnear].first == i) {
            e.add_point(s_t, c_t, b_coord, look_forward[bnear].second);
            bnear++;
        }
    }
    for (i64 i = 0; i <= sd; i++) {
        i64 b = e.get_bif(s_s, c_s, advance(p_s, s_s, i));
        if (b != NO_BIF) e.add_point(s_t, c_t, advance(p_t, s_t, i), b);
        i64 off = sd + k - 1 - i;
        b = e.get_bif(1 - s_s, c_s, advance(p_s, s_s, off));
        if (b != NO_BIF) e.add_point(1 - s_t, c_t, advance(p_t, s_t, off), b);
    }

    if (e.tracking) {
        Acc _a_walk(&g_sweep_stats.walk_ms);
        i64 span_pos = s_t == 0 ? p_t + k : p_t - k - sd + 1;
        mark_walk_neighbors(e, k, c_t, span_pos, sd);
    }
}

// Parallel (read-only) candidate detection: cand[id] = 1 iff AnyBulges
// at id would report at least one bulge group right now.  Replicates the
// claim logic of AnyBulges (src/bulgeremoval.cpp:157-218) — first branch
// to reach a downstream bif claims it with its end char; any later
// branch hitting a claimed bif with a DIFFERENT end char forms a group —
// but early-exits the id at the first such hit, and needs no
// iteration-order emulation because only the boolean is wanted.  Safe to
// run threaded: the walks only read the store.
void prefilter_candidates(Engine& e, i64 k, i64 min_branch,
                          std::vector<uint8_t>& cand,
                          const std::vector<uint8_t>* mask = nullptr) {
    // mask (optional): only test the flagged ids.  Sound because every
    // caller that passes a mask INTERSECTS the result with that same
    // mask — skipping unmasked ids just leaves zeros the intersection
    // would produce anyway, at a cost proportional to the flagged
    // fraction instead of the full id space.
    cand.assign((size_t)e.max_id + 1, 0);
    unsigned hw = std::thread::hardware_concurrency();
    int T = hw > 1 ? (int)std::min(hw, 8u) : 1;
    auto work = [&](int tid) {
        std::vector<Mark> marks;
        std::vector<i64> start_nodes;
        // per-thread claim table, versioned to avoid per-id clears
        std::vector<uint8_t> claim_ec((size_t)e.max_id + 1, 0);
        std::vector<i64> claim_epoch((size_t)e.max_id + 1, -1);
        for (i64 id = tid; id <= e.max_id; id += T) {
            if (mask && !(*mask)[(size_t)id]) continue;
            if (e.list_cnt[0][id] + e.list_cnt[1][id] < 2) continue;
            start_nodes.clear();
            for (int strand = 0; strand < 2; strand++)
                for (i64 v = e.list_head[strand][id]; v >= 0;
                     v = e.node_next[v])
                    start_nodes.push_back(v);
            for (size_t i = 0; i < start_nodes.size() && !cand[(size_t)id]; i++) {
                i64 idx = start_nodes[i];
                int strand = e.node_strand[idx];
                int c = e.node_chr[idx];
                i64 pos = e.node_pos[idx];
                if (!proper_kmer(e, strand, c, pos, k + 1)) continue;
                uint8_t ec = char_at(e, strand, c, advance(pos, strand, k));
                scan_forward(e, strand, c, pos, min_branch, marks);
                for (size_t m = 0; m < marks.size(); m++) {
                    i64 b = e.node_bif[marks[m].node];
                    if (b == id) break;
                    if (claim_epoch[(size_t)b] != id) {
                        claim_epoch[(size_t)b] = id;
                        claim_ec[(size_t)b] = ec;
                    } else if (claim_ec[(size_t)b] != ec) {
                        cand[(size_t)id] = 1;
                        break;
                    }
                }
            }
        }
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 1; t < T; t++) threads.push_back(std::thread(work, t));
        work(0);
        for (size_t t = 0; t < threads.size(); t++) threads[t].join();
    }
}

// ---------------------------------------------------------------------------
// Wave scheduler (SURVEY §7 "deterministic conflict-free collapse
// batching").  RemoveBulges (src/bulgeremoval.cpp:330-431) splits into a
// read-only DETECTION (everything up to — but excluding — the first
// collapse: branch walks, bulge grouping in boost order, the first
// surviving pair and its imlp/jmlp/kmerId priority verdict,
// bulgeremoval.cpp:405-407) and an APPLICATION that resumes the loops at
// the recorded pair and mutates exactly as the serial code would.
// Detection for a WINDOW of candidate ids runs on all cores against a
// frozen state; application then replays ids in ascending id order.  An
// id's recorded detection is reused only when nothing applied earlier in
// the order touched its footprint:
//
//   touched_at[id]  — last apply step whose span rewrite or mark
//                     erase/add a walk from this id's instances could
//                     see (the mark_walk_neighbors bound, which is also
//                     what makes the sparse sweep's skipping sound);
//   count_epoch[b]  — last apply step that changed b's point count
//                     (the priority verdict reads counts of every id on
//                     the two branches: iset below);
//   delta_epoch[c]  — last apply step that length-shifted chromosome c
//                     (shifts are translation-invariant for walks, but
//                     the overlap test compares absolute spans of two
//                     branches that may straddle the shift point, so any
//                     shift in an instance chromosome invalidates).
//
// Stale ids are recomputed serially in place — identical output, only
// the cached detection is discarded.  Result: byte-for-byte the serial
// sweep, with the dominant detection cost running data-parallel.
// ---------------------------------------------------------------------------

struct DetectResult {
    uint8_t state = 0;  // 0 unset, 1 no bulges, 2 collapse intent
    std::vector<i64> start_nodes;
    std::vector<uint8_t> end_char;
    std::vector<std::vector<int> > bulges;
    size_t nb0 = 0, i0 = 0, j0 = 0;  // loop coordinates of the first pair
    i64 j_dist0 = 0, i_dist0 = 0;
    bool iless0 = false;
    std::vector<i64> iset;  // ids whose counts the priority verdicts read
    std::vector<int> chrs;  // instance chromosomes (delta invalidation)
    void reset() {
        state = 0;
        start_nodes.clear();
        end_char.clear();
        bulges.clear();
        iset.clear();
        chrs.clear();
    }
};

// Collect the count-read footprint.  Counts are read ONLY by
// max_bif_multiplicity walks, which scan_forward at most mb steps from
// an instance on the instance's OWN strand array
// (src/bulgeremoval.cpp:39-53) — so the ids whose counts this id's
// application may read are exactly the ids owning marks in that
// directional window.
void collect_footprint(const Engine& e, i64 k, i64 mb,
                       const std::vector<i64>& start_nodes,
                       DetectResult& out) {
    for (size_t i = 0; i < start_nodes.size(); i++) {
        i64 idx = start_nodes[i];
        int strand = e.node_strand[idx];
        int c = e.node_chr[idx];
        i64 pos = e.node_pos[idx];
        out.chrs.push_back(c);
        i64 len = (i64)e.chars[c].size();
        i64 lo, hi;
        if (strand == 0) {
            lo = pos + 1;
            hi = pos + mb - 1;
        } else {
            lo = pos - mb + 1;
            hi = pos - 1;
        }
        if (lo < 0) lo = 0;
        if (hi > len - 1) hi = len - 1;
        const MarkBits& bits = e.mark_bits[strand][c];
        const PosMap& arr = e.bif_at[strand][c];
        for (i64 p = bits.next_set(lo); p >= 0 && p <= hi;
             p = bits.next_set(p + 1)) {
            i64 b = e.node_bif[arr.find(p)];
            if (b != NO_BIF) out.iset.push_back(b);
        }
    }
    std::sort(out.iset.begin(), out.iset.end());
    out.iset.erase(std::unique(out.iset.begin(), out.iset.end()),
                   out.iset.end());
    std::sort(out.chrs.begin(), out.chrs.end());
    out.chrs.erase(std::unique(out.chrs.begin(), out.chrs.end()),
                   out.chrs.end());
}

// One function, three modes (they share every loop so the replayed
// control flow cannot diverge from the serial reference):
//   rec != 0  : detection — read-only, stops at the first collapse
//   res != 0  : application — resumes at res's recorded first pair
//   both 0    : the serial RemoveBulges (fallback for stale ids)
i64 process_bulges(Engine& e, i64 k, i64 min_branch, i64 bif_id,
                   DetectResult* rec, const DetectResult* res) {
    i64 ret = 0;
    if (prof2()) g_sweep_stats.n_ids++;
    std::vector<i64> start_nodes_local;
    const std::vector<i64>* snp;
    if (res != nullptr) {
        snp = &res->start_nodes;
    } else {
        for (int strand = 0; strand < 2; strand++) {
            for (i64 v = e.list_head[strand][bif_id]; v >= 0;
                 v = e.node_next[v])
                start_nodes_local.push_back(v);
        }
        snp = &start_nodes_local;
    }
    const std::vector<i64>& start_nodes = *snp;
    if (start_nodes.size() < 2) {
        if (rec) rec->state = 1;
        return ret;
    }
    Acc _acc_detect(&g_sweep_stats.detect_ms);

    std::vector<uint8_t> end_char;
    std::vector<std::vector<int> > bulges_local;
    const std::vector<std::vector<int> >* bp;
    std::vector<Mark> marks;
    if (res != nullptr) {
        end_char = res->end_char;  // pre-collapse snapshot (validated)
        bp = &res->bulges;
    } else {
        end_char.assign(start_nodes.size(), EMPTY_CH);
        for (size_t i = 0; i < start_nodes.size(); i++) {
            i64 idx = start_nodes[i];
            int strand = e.node_strand[idx];
            int c = e.node_chr[idx];
            i64 pos = e.node_pos[idx];
            if (proper_kmer(e, strand, c, pos, k + 1)) {
                end_char[i] = char_at(e, strand, c, advance(pos, strand, k));
            }
        }

        // AnyBulges with boost iteration order
        Boost154Map visit;
        for (size_t i = 0; i < start_nodes.size(); i++) {
            if (end_char[i] == EMPTY_CH) continue;
            i64 idx = start_nodes[i];
            int strand = e.node_strand[idx];
            int c = e.node_chr[idx];
            i64 pos = e.node_pos[idx];
            i64 start = e.get_bif(strand, c, pos);
            scan_forward(e, strand, c, pos, min_branch, marks);
            for (size_t m = 0; m < marks.size(); m++) {
                i64 b = e.node_bif[marks[m].node];
                if (b == start) break;
                BoostMapValue* entry = visit.find((u64)b);
                if (entry == nullptr) {
                    visit.insert((u64)b, end_char[i], (int)i);
                } else if (entry->end_char != end_char[i]) {
                    entry->branch_ids.push_back((int)i);
                    break;
                }
            }
        }
        bulges_local.clear();
        for (BoostNode* n = visit.prev_start_next; n != nullptr; n = n->next) {
            if (n->value.branch_ids.size() > 1)
                bulges_local.push_back(n->value.branch_ids);
        }
        bp = &bulges_local;
    }
    const std::vector<std::vector<int> >& bulges = *bp;
    if (bulges.empty()) {
        if (rec) rec->state = 1;
        return ret;
    }
    Acc _acc_pairs(&g_sweep_stats.pairs_ms);
    std::vector<std::pair<i64, i64> > vis;
    size_t nb_start = res ? res->nb0 : 0;
    for (size_t nb = nb_start; nb < bulges.size(); nb++) {
        const std::vector<int>& bulge = bulges[nb];
        size_t i_start = (res && nb == res->nb0) ? res->i0 : 0;
        for (size_t id_i = i_start; id_i < bulge.size(); id_i++) {
            int kmer_i = bulge[id_i];
            i64 node_i = start_nodes[kmer_i];
            if (e.node_bif[node_i] == NO_BIF) continue;
            int si = e.node_strand[node_i];
            int ci = e.node_chr[node_i];
            i64 pi = e.node_pos[node_i];
            fill_visit(e, si, ci, pi, min_branch, vis);
            bool resume_here =
                (res && nb == res->nb0 && id_i == res->i0);
            size_t j_start = resume_here ? res->j0 : id_i + 1;
            for (size_t id_j = j_start; id_j < bulge.size(); id_j++) {
                int kmer_j = bulge[id_j];
                i64 node_j = start_nodes[kmer_j];
                if (resume_here && id_j == res->j0) {
                    // the recorded first pair: every read it depends on
                    // was validated unchanged, so reuse the verdict
                    ret++;
                    i64 i_dist = res->i_dist0;
                    i64 j_dist = res->j_dist0;
                    if (res->iless0) {
                        end_char[kmer_j] = end_char[kmer_i];
                        collapse_bulge(e, k, node_i, i_dist, node_j, j_dist);
                    } else {
                        end_char[kmer_i] = end_char[kmer_j];
                        collapse_bulge(e, k, node_j, j_dist, node_i, i_dist);
                        pi = e.node_pos[node_i];
                        fill_visit(e, si, ci, pi, min_branch, vis);
                    }
                    resume_here = false;
                    continue;
                }
                if (e.node_bif[node_j] == NO_BIF
                    || end_char[kmer_i] == end_char[kmer_j]) continue;
                int sj = e.node_strand[node_j];
                int cj = e.node_chr[node_j];
                i64 pj = e.node_pos[node_j];
                scan_forward(e, sj, cj, pj, min_branch, marks);
                for (size_t m = 0; m < marks.size(); m++) {
                    i64 now_bif = e.node_bif[marks[m].node];
                    if (now_bif == bif_id) break;
                    std::vector<std::pair<i64, i64> >::iterator vt =
                        std::lower_bound(vis.begin(), vis.end(),
                                         std::make_pair(now_bif, (i64)0));
                    if (vt != vis.end() && vt->first == now_bif) {
                        i64 j_dist = marks[m].step;
                        i64 i_dist = vt->second;
                        if (overlap(e, k, node_i, i_dist, node_j, j_dist)) break;
                        i64 imlp = max_bif_multiplicity(e, node_i, i_dist);
                        i64 jmlp = max_bif_multiplicity(e, node_j, j_dist);
                        bool iless = imlp > jmlp || (imlp == jmlp && kmer_i < kmer_j);
                        if (rec) {
                            // detection stops at the first collapse:
                            // record the pair + verdict, mutate nothing
                            rec->state = 2;
                            rec->nb0 = nb;
                            rec->i0 = id_i;
                            rec->j0 = id_j;
                            rec->j_dist0 = j_dist;
                            rec->i_dist0 = i_dist;
                            rec->iless0 = iless;
                            rec->start_nodes = start_nodes;
                            rec->end_char = end_char;
                            rec->bulges = bulges;
                            collect_footprint(e, k, min_branch, start_nodes,
                                              *rec);
                            return 0;
                        }
                        ret++;
                        if (iless) {
                            end_char[kmer_j] = end_char[kmer_i];
                            collapse_bulge(e, k, node_i, i_dist, node_j, j_dist);
                        } else {
                            end_char[kmer_i] = end_char[kmer_j];
                            collapse_bulge(e, k, node_j, j_dist, node_i, i_dist);
                            pi = e.node_pos[node_i];
                            fill_visit(e, si, ci, pi, min_branch, vis);
                        }
                        break;
                    }
                }
            }
        }
    }
    if (rec) {
        // Walked every pair, nothing to collapse.  This verdict involved
        // overlap tests (absolute spans), so a chromosome length shift
        // must invalidate it: record the instance chromosomes.
        rec->state = 1;
        for (size_t i = 0; i < start_nodes.size(); i++)
            rec->chrs.push_back(e.node_chr[start_nodes[i]]);
        std::sort(rec->chrs.begin(), rec->chrs.end());
        rec->chrs.erase(std::unique(rec->chrs.begin(), rec->chrs.end()),
                        rec->chrs.end());
        return ret;
    }
    e.cleanup();
    return ret;
}

i64 remove_bulges(Engine& e, i64 k, i64 min_branch, i64 bif_id) {
    return process_bulges(e, k, min_branch, bif_id, nullptr, nullptr);
}

// SIBELIA_TPU_WAVE: unset -> default window 8192; 0 -> wave scheduler
// off (strictly serial sweep); N -> window of N candidate ids.
i64 wave_window() {
    static i64 w = [] {
        const char* v = std::getenv("SIBELIA_TPU_WAVE");
        if (!v || !v[0]) return (i64)1024;
        return (i64)std::atoll(v);
    }();
    return w;
}

// One sweep iteration under the wave scheduler: parallel frozen-state
// detection of a window of candidate ids, then in-order application
// with epoch invalidation (stale ids recompute serially — identical
// output, see the scheduler header above).
i64 g_wave_skip1 = 0, g_wave_resume = 0, g_wave_stale = 0,
    g_wave_uncached = 0;
double g_wave_detect_ms = 0;

i64 sweep_iteration_wave(Engine& e, i64 k, i64 min_branch, i64 win,
                         std::vector<DetectResult>& results) {
    i64 total = 0;
    if ((i64)results.size() < win) results.resize((size_t)win);
    std::vector<i64> wids;
    wids.reserve((size_t)win);
    i64 cursor = 0;
    while (cursor <= e.max_id) {
        wids.clear();
        i64 hi = cursor;
        while (hi <= e.max_id && (i64)wids.size() < win) {
            if (e.visit_now[(size_t)hi]) wids.push_back(hi);
            hi++;
        }
        if (!wids.empty()) {
            i64 wave_epoch = e.apply_step;
            unsigned hw = std::thread::hardware_concurrency();
            int T = (int)std::min<unsigned>(hw ? hw : 1, 8);
            if ((i64)wids.size() < 64) T = 1;
            auto detect_range = [&](int t) {
                for (size_t w = (size_t)t; w < wids.size(); w += (size_t)T) {
                    results[w].reset();
                    process_bulges(e, k, min_branch, wids[w], &results[w],
                                   nullptr);
                }
            };
            std::chrono::steady_clock::time_point dt0 =
                std::chrono::steady_clock::now();
            if (T == 1) {
                detect_range(0);
            } else {
                std::vector<std::thread> th;
                for (int t = 1; t < T; t++) th.emplace_back(detect_range, t);
                detect_range(0);
                for (std::thread& x : th) x.join();
            }
            g_wave_detect_ms += std::chrono::duration<double, std::milli>(
                std::chrono::steady_clock::now() - dt0).count();
            size_t w = 0;
            for (i64 id = cursor; id < hi; id++) {
                while (w < wids.size() && wids[w] < id) w++;
                if (!e.visit_now[(size_t)id]) continue;
                e.cur_id = id;
                DetectResult* d = nullptr;
                if (w < wids.size() && wids[w] == id) d = &results[w];
                bool valid = false;
                if (d != nullptr && d->state != 0) {
                    valid = e.touched_at[(size_t)id] < wave_epoch;
                    if (valid) {
                        for (size_t ci = 0; ci < d->chrs.size(); ci++)
                            if (e.delta_epoch[(size_t)d->chrs[ci]] >=
                                wave_epoch) {
                                valid = false;
                                break;
                            }
                    }
                    if (valid && d->state == 2) {
                        for (size_t bi = 0; bi < d->iset.size(); bi++)
                            if (e.count_epoch[(size_t)d->iset[bi]] >=
                                wave_epoch) {
                                valid = false;
                                break;
                            }
                    }
                }
                i64 r;
                if (valid && d->state == 1) {
                    g_wave_skip1++;
                    r = 0;
                } else if (valid && d->state == 2) {
                    g_wave_resume++;
                    r = process_bulges(e, k, min_branch, id, nullptr, d);
                } else {
                    if (d != nullptr) g_wave_stale++; else g_wave_uncached++;
                    r = process_bulges(e, k, min_branch, id, nullptr,
                                       nullptr);
                }
                total += r;
                if (r > 0) e.visit_next[(size_t)id] = 1;
                e.apply_step++;
            }
        }
        cursor = hi;
    }
    return total;
}

}  // namespace

extern "C" {

void* engine_create(int n_chr, const i64* chr_lens,
                    const uint8_t* const* chars,
                    const int32_t* const* origpos,
                    const i64* sep_origpos) {
    Engine* e = new Engine();
    e->n_chr = n_chr;
    e->chars.resize(n_chr);
    e->origpos.resize(n_chr);
    e->sep_origpos.assign(sep_origpos, sep_origpos + n_chr);
    for (int c = 0; c < n_chr; c++) {
        e->chars[c].assign(chars[c], chars[c] + chr_lens[c]);
        e->origpos[c].assign(origpos[c], origpos[c] + chr_lens[c]);
        for (int s = 0; s < 2; s++) {
            e->bif_at[s].push_back(PosMap());
            e->bif_at[s].back().reset(chr_lens[c]);
            e->mark_bits[s].push_back(MarkBits());
            e->mark_bits[s].back().init(chr_lens[c]);
        }
    }
    return e;
}

// instances per strand in scan order (chr asc, coord order matching the
// reference walk); coords are positive-frame.  Coords/bifs are int32 /
// uint32 on the wire: per-chromosome positions and ids are bounded well
// below 2^31 by the 1 GB input cap, and the packed staging copies are
// ~2 GB smaller at that scale for it.
void engine_set_bifs(void* handle, i64 max_id,
                     i64 n0, const int32_t* chr0, const int32_t* coord0,
                     const uint32_t* bif0,
                     i64 n1, const int32_t* chr1, const int32_t* coord1,
                     const uint32_t* bif1) {
    Engine* e = (Engine*)handle;
    e->max_id = max_id;
    for (int s = 0; s < 2; s++) {
        e->list_head[s].assign((size_t)max_id + 2, (i64)-1);
        e->list_cnt[s].assign((size_t)max_id + 2, 0);
    }
    e->apply_step = 0;
    e->touched_at.assign((size_t)max_id + 2, (i64)-1);
    e->count_epoch.assign((size_t)max_id + 2, (i64)-1);
    e->delta_epoch.assign((size_t)e->n_chr, (i64)-1);
    e->node_strand.clear();
    e->node_chr.clear();
    e->node_pos.clear();
    e->node_bif.clear();
    e->node_next.clear();
    e->free_nodes.clear();
    // one upfront reservation: the free list bounds growth near the
    // instance count, and push_back doubling would otherwise leak
    // ~the final size into the slab on every reallocation
    size_t cap = (size_t)(n0 + n1) + (size_t)(n0 + n1) / 8 + 1024;
    e->node_strand.reserve(cap);
    e->node_chr.reserve(cap);
    e->node_pos.reserve(cap);
    e->node_bif.reserve(cap);
    e->node_next.reserve(cap);
    const int32_t* chrs[2] = {chr0, chr1};
    const int32_t* coords[2] = {coord0, coord1};
    const uint32_t* bifs[2] = {bif0, bif1};
    i64 counts[2] = {n0, n1};
    for (int s = 0; s < 2; s++) {
        for (i64 i = 0; i < counts[s]; i++) {
            i64 idx = (i64)e->node_strand.size();
            e->node_strand.push_back((int8_t)s);
            e->node_chr.push_back(chrs[s][i]);
            e->node_pos.push_back(coords[s][i]);
            e->node_bif.push_back(bifs[s][i]);
            e->bif_at[s][chrs[s][i]].insert(coords[s][i], idx);
            e->mark_bits[s][chrs[s][i]].set(coords[s][i]);
            e->node_next.push_back(e->list_head[s][bifs[s][i]]);
            e->list_head[s][bifs[s][i]] = idx;
            e->list_cnt[s][bifs[s][i]]++;
        }
    }
}

i64 engine_simplify(void* handle, i64 k, i64 min_branch, i64 max_iterations) {
    Engine* e = (Engine*)handle;
    const char* pv = std::getenv("SIBELIA_TPU_PROF");
    bool prof = pv && pv[0] == '1';
    i64 total = 0;
    i64 iterations = 0;
    // progress pacing as the reference dense loop (blockfinder.cpp:28-40)
    i64 pcount = 0, pprog = 0;
    i64 pthresh = ((e->max_id + 1) * max_iterations) / PROGRESS_STRIDE;
    if (pthresh < 1) pthresh = 1;
    if (e->progress_fn) e->progress_fn(0, 0);
    for (;;) {
        iterations++;
        i64 before = total;
        std::chrono::steady_clock::time_point t0 =
            std::chrono::steady_clock::now();
        for (i64 id = 0; id <= e->max_id; id++) {
            total += remove_bulges(*e, k, min_branch, id);
            if (++pcount >= pthresh && e->progress_fn) {
                pcount = 0;
                pprog = pprog + 1 < PROGRESS_STRIDE ? pprog + 1
                                                    : PROGRESS_STRIDE;
                e->progress_fn((long long)pprog, 1);
            }
        }
        if (prof) {
            double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
            std::fprintf(stderr,
                         "[prof] simplify k=%lld iter=%lld bulges=%lld"
                         " %8.1f ms\n",
                         (long long)k, (long long)iterations,
                         (long long)(total - before), ms);
        }
        if (!(total > 0 && iterations < max_iterations)) break;
    }
    if (e->progress_fn) e->progress_fn((long long)PROGRESS_STRIDE, 2);
    return total;
}

// Sparse sweep driver: identical output to engine_simplify (the dense
// reference loop, src/blockfinder.cpp:16-51), visiting only ids that can
// have bulges.  Iteration 1 visits `cand0` (caller-provided candidate
// bitmap — e.g. computed on the device during enumeration — or the parallel
// host prefilter when NULL); later iterations visit only ids flagged by
// the mutation hooks during earlier collapses.  Differentially tested
// against the dense Python engine (tests/test_native_engine.py).
i64 engine_simplify_sparse(void* handle, i64 k, i64 min_branch,
                           i64 max_iterations, const uint8_t* cand0,
                           i64 cand_len) {
    Engine* e = (Engine*)handle;
    const char* pv = std::getenv("SIBELIA_TPU_PROF");
    bool prof = pv && pv[0] == '1';
    std::chrono::steady_clock::time_point t0 =
        std::chrono::steady_clock::now();
    if (cand0 != nullptr) {
        i64 m = cand_len < e->max_id + 1 ? cand_len : e->max_id + 1;
        e->visit_now.assign((size_t)e->max_id + 1, 0);
        std::memcpy(e->visit_now.data(), cand0, (size_t)m);
    } else {
        bool filled = false;
        if (e->reprefilter_fn) {
            e->visit_now.assign((size_t)e->max_id + 1, 0);
            filled = e->reprefilter_fn(e->visit_now.data(),
                                       e->max_id + 1) != 0;
        }
        if (!filled) prefilter_candidates(*e, k, min_branch, e->visit_now);
    }
    e->visit_next.assign((size_t)e->max_id + 1, 0);
    if (prof) {
        double ms = std::chrono::duration<double, std::milli>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
        i64 nc = 0;
        for (size_t i = 0; i < e->visit_now.size(); i++) nc += e->visit_now[i];
        std::fprintf(stderr,
                     "[prof] candidates k=%lld %lld/%lld (%s) %8.1f ms\n",
                     (long long)k, (long long)nc, (long long)(e->max_id + 1),
                     cand0 ? "device" : "host", ms);
    }
    e->tracking = true;
    e->mb_cur = min_branch;
    i64 total = 0;
    i64 iterations = 0;
    if (e->progress_fn) e->progress_fn(0, 0);
    for (;;) {
        iterations++;
        i64 before = total;
        t0 = std::chrono::steady_clock::now();
        if (wave_window() > 0) {
            static thread_local std::vector<DetectResult> results;
            total += sweep_iteration_wave(*e, k, min_branch, wave_window(),
                                          results);
        } else {
            for (i64 id = 0; id <= e->max_id; id++) {
                if (!e->visit_now[(size_t)id]) continue;
                e->cur_id = id;
                i64 r = remove_bulges(*e, k, min_branch, id);
                total += r;
                if (r > 0) e->visit_next[(size_t)id] = 1;
            }
        }
        if (prof) {
            double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
            std::fprintf(stderr,
                         "[prof] sparse k=%lld iter=%lld bulges=%lld"
                         " %8.1f ms\n",
                         (long long)k, (long long)iterations,
                         (long long)(total - before), ms);
        }
        if (prof2()) {
            std::fprintf(stderr,
                         "[prof2] wave skip1=%lld resume=%lld stale=%lld"
                         " uncached=%lld detect_par=%.0fms\n",
                         (long long)g_wave_skip1, (long long)g_wave_resume,
                         (long long)g_wave_stale, (long long)g_wave_uncached,
                         g_wave_detect_ms);
            g_wave_skip1 = g_wave_resume = g_wave_stale = g_wave_uncached = 0;
            g_wave_detect_ms = 0;
            SweepStats& s = g_sweep_stats;
            std::fprintf(stderr,
                         "[prof2] sweep iter=%lld ids=%lld col=%lld"
                         " delta=%lld total=%.0fms pairs=%.0fms"
                         " collapse=%.0fms cleanup=%.0fms"
                         " erase=%.0f repl=%.0f upd=%.0f walk=%.0f"
                         " vec=%.0f bits=%.0f map=%.0f interp=%.0f"
                         " swept=%lld\n",
                         (long long)iterations, (long long)s.n_ids,
                         (long long)s.n_collapse, (long long)s.n_delta,
                         s.detect_ms, s.pairs_ms,
                         s.collapse_ms, s.cleanup_ms,
                         s.erase_ms, s.replace_ms, s.update_ms, s.walk_ms,
                         s.vec_ms, s.bits_ms, s.map_ms, s.interp_ms,
                         (long long)s.n_swept);
            s.reset();
        }
        if (e->progress_fn)
            e->progress_fn(
                (long long)std::min<i64>(
                    PROGRESS_STRIDE,
                    iterations * PROGRESS_STRIDE / max_iterations),
                1);
        if (!(total > 0 && iterations < max_iterations)) break;
        e->visit_now.swap(e->visit_next);
        std::fill(e->visit_next.begin(), e->visit_next.end(), 0);
        i64 n_flagged = 0;
        for (size_t i = 0; i < e->visit_now.size(); i++)
            n_flagged += e->visit_now[i];
        if (n_flagged == 0) break;  // remaining iterations are no-ops
        if (n_flagged > (e->max_id + 1) / 8) {
            // The side-effect flags are a sound but loose bound: after a
            // collapse-heavy pass most flagged ids have no bulge left.
            // The parallel prefilter is a SUPERSET of "AnyBulges reports
            // a group" (same guarantee the sparse driver already relies
            // on), so intersecting it with the flags only skips ids the
            // serial reference would leave untouched.
            std::vector<uint8_t> cand;
            bool filled = false;
            if (e->reprefilter_fn) {
                cand.assign((size_t)e->max_id + 1, 0);
                filled = e->reprefilter_fn(cand.data(),
                                           e->max_id + 1) != 0;
            }
            if (!filled)
                prefilter_candidates(*e, k, min_branch, cand,
                                     &e->visit_now);
            for (size_t i = 0; i < e->visit_now.size(); i++)
                e->visit_now[i] &= cand[i];
        }
    }
    if (e->progress_fn) e->progress_fn((long long)PROGRESS_STRIDE, 2);
    e->tracking = false;
    return total;
}

void engine_set_progress(void* handle, ProgressFn fn) {
    ((Engine*)handle)->progress_fn = fn;
}

void engine_set_reprefilter(void* handle, ReprefilterFn fn) {
    ((Engine*)handle)->reprefilter_fn = fn;
}

// Export the live instance table (nodes whose bif point still stands)
// for the device detection kernel; count first, then fill.
i64 engine_live_node_count(void* handle) {
    Engine* e = (Engine*)handle;
    i64 n = 0;
    for (size_t i = 0; i < e->node_bif.size(); i++)
        if ((i64)e->node_bif[i] != NO_BIF) n++;
    return n;
}

void engine_export_nodes(void* handle, int8_t* strand_out,
                         int32_t* chr_out, int64_t* pos_out,
                         uint32_t* bif_out) {
    Engine* e = (Engine*)handle;
    i64 w = 0;
    for (size_t i = 0; i < e->node_bif.size(); i++) {
        if ((i64)e->node_bif[i] == NO_BIF) continue;
        strand_out[w] = e->node_strand[i];
        chr_out[w] = e->node_chr[i];
        pos_out[w] = (int64_t)e->node_pos[i];
        bif_out[w] = e->node_bif[i];
        ++w;
    }
}

void engine_export_chars(void* handle, int c, uint8_t* out) {
    Engine* e = (Engine*)handle;
    std::memcpy(out, e->chars[c].data(), e->chars[c].size());
}

i64 engine_chr_len(void* handle, int c) {
    return (i64)((Engine*)handle)->chars[c].size();
}

void engine_get_chr(void* handle, int c, uint8_t* chars_out,
                    int32_t* origpos_out) {
    Engine* e = (Engine*)handle;
    std::memcpy(chars_out, e->chars[c].data(), e->chars[c].size());
    std::memcpy(origpos_out, e->origpos[c].data(),
                e->origpos[c].size() * sizeof(int32_t));
}

void engine_destroy(void* handle) {
    delete (Engine*)handle;
}

// ---------------------------------------------------------------------------
// standalone LSB radix argsort for the host ranking kernel (numpy's stable
// sort for 64-bit keys is a comparison sort; 16-bit-digit counting passes
// are ~10x faster at genome scale)
// ---------------------------------------------------------------------------

void radix_argsort_u64(const u64* keys, i64 n, i64* order_out) {
    std::vector<i64> idx_a((size_t)n), idx_b((size_t)n);
    for (i64 i = 0; i < n; i++) idx_a[i] = i;
    std::vector<i64> count(1 << 16);
    i64* src = idx_a.data();
    i64* dst = idx_b.data();
    for (int pass = 0; pass < 4; pass++) {
        int shift = pass * 16;
        // skip passes whose digit is constant
        u64 first_digit = n ? ((keys[src[0]] >> shift) & 0xFFFF) : 0;
        bool constant = true;
        std::fill(count.begin(), count.end(), 0);
        for (i64 i = 0; i < n; i++) {
            u64 d = (keys[src[i]] >> shift) & 0xFFFF;
            count[d]++;
            constant = constant && (d == first_digit);
        }
        if (constant) continue;
        i64 acc = 0;
        for (size_t d = 0; d < count.size(); d++) {
            i64 c = count[d];
            count[d] = acc;
            acc += c;
        }
        for (i64 i = 0; i < n; i++) {
            u64 d = (keys[src[i]] >> shift) & 0xFFFF;
            dst[count[d]++] = src[i];
        }
        std::swap(src, dst);
    }
    std::memcpy(order_out, src, (size_t)n * sizeof(i64));
}

}  // extern "C"
