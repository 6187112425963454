// Native host runtime: packet-header ring buffer + exact-match verdict
// cache.
//
// The TPU-native equivalent of the reference's native fast path: where
// cilium's per-packet hot loop lives in kernel C (bpf_lxc.c ingestion,
// bpf/lib/policy.h __policy_can_access on pinned BPF hash maps), this
// framework ingests packet headers through a lock-free SPSC ring into
// struct-of-arrays batches (feeding the TPU verdict kernel) and
// short-circuits repeat flows through a C++ open-addressing hash cache
// (the policymap/proxymap analog, pkg/maps/policymap + bpf/lib/maps.h).
//
// The cache hash is in lockstep with the device kernel
// (cilium_tpu/compiler/hashtab.py hash_mix) so host-cached entries and
// device tables agree on layout; Python asserts the struct ABI against
// numpy dtypes (pkg/alignchecker analog) via pkt_header_offsets().
//
// C ABI only — consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <shared_mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Packet header record (fixed 24-byte layout, little-endian fields).
// ---------------------------------------------------------------------------

struct PktHeader {
    uint32_t endpoint;
    uint32_t saddr;
    uint32_t daddr;
    uint16_t sport;
    uint16_t dport;
    uint8_t proto;
    uint8_t direction;
    uint8_t tcp_flags;
    uint8_t is_fragment;
    uint32_t length;
};

int pkt_header_size() { return (int)sizeof(PktHeader); }

// Field offsets in declaration order, for the Python align-checker.
int pkt_header_offsets(uint32_t* out, int max_fields) {
    static const uint32_t offs[] = {
        offsetof(PktHeader, endpoint), offsetof(PktHeader, saddr),
        offsetof(PktHeader, daddr),    offsetof(PktHeader, sport),
        offsetof(PktHeader, dport),    offsetof(PktHeader, proto),
        offsetof(PktHeader, direction), offsetof(PktHeader, tcp_flags),
        offsetof(PktHeader, is_fragment), offsetof(PktHeader, length),
    };
    int n = (int)(sizeof(offs) / sizeof(offs[0]));
    if (max_fields < n) n = max_fields;
    for (int i = 0; i < n; i++) out[i] = offs[i];
    return n;
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring of PktHeader records.
//
// Single producer (the ingestion thread — NIC tap / proxy / simulator),
// single consumer (the batcher draining toward the device). Capacity is
// rounded to a power of two; indices are monotonically increasing
// uint64s masked on access (never wrap in practice).
// ---------------------------------------------------------------------------

struct Ring {
    std::vector<PktHeader> buf;
    uint64_t mask;
    alignas(64) std::atomic<uint64_t> head{0};  // consumer position
    alignas(64) std::atomic<uint64_t> tail{0};  // producer position
    alignas(64) std::atomic<uint64_t> dropped{0};
};

static uint64_t next_pow2_u64(uint64_t v) {
    uint64_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

void* ring_create(uint64_t capacity) {
    if (capacity < 2) capacity = 2;
    uint64_t cap = next_pow2_u64(capacity);
    Ring* r = new (std::nothrow) Ring();
    if (!r) return nullptr;
    r->buf.resize(cap);
    r->mask = cap - 1;
    return r;
}

void ring_destroy(void* h) { delete static_cast<Ring*>(h); }

uint64_t ring_capacity(void* h) {
    return static_cast<Ring*>(h)->mask + 1;
}

uint64_t ring_size(void* h) {
    Ring* r = static_cast<Ring*>(h);
    // head first: head only grows toward tail, so a tail read that
    // happens after can never be smaller (unsigned underflow guard)
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    return tail - head;
}

uint64_t ring_dropped(void* h) {
    return static_cast<Ring*>(h)->dropped.load(std::memory_order_relaxed);
}

// Push up to n records; returns how many fit. Rejected records are NOT
// auto-counted as drops — a producer that retries later lost nothing;
// one that discards calls ring_note_dropped (the perf-ring
// lost-samples analog stays accurate either way).
uint64_t ring_push_burst(void* h, const PktHeader* recs, uint64_t n) {
    Ring* r = static_cast<Ring*>(h);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t free_slots = (r->mask + 1) - (tail - head);
    uint64_t take = n < free_slots ? n : free_slots;
    for (uint64_t i = 0; i < take; i++)
        r->buf[(tail + i) & r->mask] = recs[i];
    r->tail.store(tail + take, std::memory_order_release);
    return take;
}

void ring_note_dropped(void* h, uint64_t n) {
    static_cast<Ring*>(h)->dropped.fetch_add(n,
                                             std::memory_order_relaxed);
}

// Drain up to max records into struct-of-arrays output — the exact
// layout the batched TPU step consumes (one contiguous int32 array per
// field, written straight into numpy-owned memory).
uint64_t ring_pop_batch_soa(void* h, uint64_t max_records,
                            int32_t* endpoint, int32_t* saddr,
                            int32_t* daddr, int32_t* sport,
                            int32_t* dport, int32_t* proto,
                            int32_t* direction, int32_t* tcp_flags,
                            int32_t* is_fragment, int32_t* length) {
    Ring* r = static_cast<Ring*>(h);
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t avail = tail - head;
    uint64_t take = avail < max_records ? avail : max_records;
    for (uint64_t i = 0; i < take; i++) {
        const PktHeader& p = r->buf[(head + i) & r->mask];
        endpoint[i] = (int32_t)p.endpoint;
        saddr[i] = (int32_t)p.saddr;
        daddr[i] = (int32_t)p.daddr;
        sport[i] = (int32_t)p.sport;
        dport[i] = (int32_t)p.dport;
        proto[i] = (int32_t)p.proto;
        direction[i] = (int32_t)p.direction;
        tcp_flags[i] = (int32_t)p.tcp_flags;
        is_fragment[i] = (int32_t)p.is_fragment;
        length[i] = (int32_t)p.length;
    }
    r->head.store(head + take, std::memory_order_release);
    return take;
}

// ---------------------------------------------------------------------------
// Exact-match verdict cache.
//
// Open-addressing, linear-probe hash over two uint32 key words — the
// same (key_a, key_b) packing and the same multiplicative mix as the
// device tables, so host fast-path hits and TPU batch verdicts share
// one key universe. Reader-writer locked: lookups are the hot path
// (shared), control-plane sync takes the exclusive lock.
// ---------------------------------------------------------------------------

static inline uint32_t hash_mix(uint32_t a, uint32_t b) {
    // MUST stay in lockstep with compiler/hashtab.py hash_mix and
    // ops/hashtab_ops.py hash_mix_jnp.
    uint32_t h = a * 0x9E3779B1u;
    h ^= h >> 15;
    h = h + b * 0x85EBCA6Bu;
    h ^= h >> 13;
    h = h * 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

struct VerdictCache {
    std::vector<uint32_t> key_a;
    std::vector<uint32_t> key_b;  // 0 == empty slot
    std::vector<int32_t> value;
    uint32_t mask = 0;
    uint64_t entries = 0;
    mutable std::shared_mutex mu;

    void init(uint64_t slots) {
        key_a.assign(slots, 0);
        key_b.assign(slots, 0);
        value.assign(slots, 0);
        mask = (uint32_t)(slots - 1);
        entries = 0;
    }

    // exclusive lock held
    bool insert_locked(uint32_t ka, uint32_t kb, int32_t v) {
        uint32_t h = hash_mix(ka, kb) & mask;
        for (uint32_t probe = 0; probe <= mask; probe++) {
            uint32_t s = (h + probe) & mask;
            if (key_b[s] == 0) {
                key_a[s] = ka;
                key_b[s] = kb;
                value[s] = v;
                entries++;
                return true;
            }
            if (key_a[s] == ka && key_b[s] == kb) {
                value[s] = v;
                return true;
            }
        }
        return false;
    }

    void grow_locked() {
        std::vector<uint32_t> oa(std::move(key_a)), ob(std::move(key_b));
        std::vector<int32_t> ov(std::move(value));
        init((uint64_t)(mask + 1) * 2);
        for (size_t i = 0; i < ob.size(); i++)
            if (ob[i] != 0) insert_locked(oa[i], ob[i], ov[i]);
    }
};

void* vc_create(uint64_t slots) {
    VerdictCache* c = new (std::nothrow) VerdictCache();
    if (!c) return nullptr;
    c->init(next_pow2_u64(slots < 8 ? 8 : slots));
    return c;
}

void vc_destroy(void* h) { delete static_cast<VerdictCache*>(h); }

// key_b == 0 is reserved for empty slots (same builder invariant as the
// device tables); returns 0 on reserved-key misuse, 1 on success.
int vc_update(void* h, uint32_t ka, uint32_t kb, int32_t value) {
    if (kb == 0) return 0;
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::unique_lock<std::shared_mutex> lk(c->mu);
    if ((c->entries + 1) * 2 > (uint64_t)c->mask + 1) c->grow_locked();
    return c->insert_locked(ka, kb, value) ? 1 : 0;
}

// Bulk insert/update for control-plane sync: one lock acquisition and
// one Python->C transition per endpoint instead of per entry. Returns
// the number of records applied (reserved kb==0 rows are skipped).
uint64_t vc_update_batch(void* h, const uint32_t* ka, const uint32_t* kb,
                         const int32_t* value, uint64_t n) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::unique_lock<std::shared_mutex> lk(c->mu);
    uint64_t applied = 0;
    for (uint64_t i = 0; i < n; i++) {
        if (kb[i] == 0) continue;
        if ((c->entries + 1) * 2 > (uint64_t)c->mask + 1) c->grow_locked();
        if (c->insert_locked(ka[i], kb[i], value[i])) applied++;
    }
    return applied;
}

int vc_delete(void* h, uint32_t ka, uint32_t kb) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::unique_lock<std::shared_mutex> lk(c->mu);
    uint32_t hh = hash_mix(ka, kb) & c->mask;
    for (uint32_t probe = 0; probe <= c->mask; probe++) {
        uint32_t s = (hh + probe) & c->mask;
        if (c->key_b[s] == 0) return 0;
        if (c->key_a[s] == ka && c->key_b[s] == kb) {
            // backward-shift deletion keeps probe chains intact
            uint32_t hole = s;
            for (uint32_t q = 1; q <= c->mask; q++) {
                uint32_t nxt = (s + q) & c->mask;
                if (c->key_b[nxt] == 0) break;
                uint32_t home = hash_mix(c->key_a[nxt], c->key_b[nxt]) &
                                c->mask;
                // can nxt's record legally move into the hole?
                uint32_t dist_nxt = (nxt - home) & c->mask;
                uint32_t dist_hole = (hole - home) & c->mask;
                if (dist_hole <= dist_nxt) {
                    c->key_a[hole] = c->key_a[nxt];
                    c->key_b[hole] = c->key_b[nxt];
                    c->value[hole] = c->value[nxt];
                    hole = nxt;
                }
            }
            c->key_b[hole] = 0;
            c->key_a[hole] = 0;
            c->value[hole] = 0;
            c->entries--;
            return 1;
        }
    }
    return 0;
}

// Batched lookup: out_value[i] = cached verdict, out_found[i] = 1 on
// hit. The host fast path for a whole ingest batch in one call.
uint64_t vc_lookup_batch(void* h, const uint32_t* ka, const uint32_t* kb,
                         uint64_t n, int32_t* out_value,
                         uint8_t* out_found) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::shared_lock<std::shared_mutex> lk(c->mu);
    uint64_t found_count = 0;
    for (uint64_t i = 0; i < n; i++) {
        out_found[i] = 0;
        out_value[i] = 0;
        uint32_t hh = hash_mix(ka[i], kb[i]) & c->mask;
        for (uint32_t probe = 0; probe <= c->mask; probe++) {
            uint32_t s = (hh + probe) & c->mask;
            if (c->key_b[s] == 0) break;
            if (c->key_a[s] == ka[i] && c->key_b[s] == kb[i]) {
                out_value[i] = c->value[s];
                out_found[i] = 1;
                found_count++;
                break;
            }
        }
    }
    return found_count;
}

// Full 3-stage __policy_can_access (bpf/lib/policy.h:46-110) over a
// batch in ONE native call: exact (identity,dport,proto,dir) ->
// L3-only (identity,0,0,dir; never redirects, policy.h:83) ->
// L4-wildcard (0,dport,proto,dir) -> drop (-1).  One shared-lock
// acquisition and zero Python/numpy ops on the hot path — this is what
// lets small latency-critical batches undercut the device round trip.
// Key packing MUST stay in lockstep with compiler/policy_tables.py
// pack_key/pack_meta: key_b = (dport<<16)|(proto<<8)|(dir<<1)|1.
// MUST stay in lockstep with compiler/policy_tables.py pack_meta —
// exported as vc_pack_meta (like vc_hash_mix) so the Python side can
// lockstep-test the layout instead of trusting a comment.
static inline uint32_t pack_meta_c(uint32_t dport, uint32_t proto,
                                   uint32_t dir) {
    return ((dport & 0xFFFFu) << 16) | ((proto & 0xFFu) << 8) |
           ((dir & 1u) << 1) | 1u;
}

uint32_t vc_pack_meta(uint32_t dport, uint32_t proto, uint32_t dir) {
    return pack_meta_c(dport, proto, dir);
}

static inline bool vc_find(const VerdictCache* c, uint32_t ka,
                           uint32_t kb, int32_t* out) {
    uint32_t hh = hash_mix(ka, kb) & c->mask;
    for (uint32_t probe = 0; probe <= c->mask; probe++) {
        uint32_t s = (hh + probe) & c->mask;
        if (c->key_b[s] == 0) return false;
        if (c->key_a[s] == ka && c->key_b[s] == kb) {
            *out = c->value[s];
            return true;
        }
    }
    return false;
}

uint64_t vc_classify_batch(void* h, const uint32_t* identity,
                           const int32_t* dport, const int32_t* proto,
                           const int32_t* direction, uint64_t n,
                           int32_t* out_verdict) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::shared_lock<std::shared_mutex> lk(c->mu);
    uint64_t hits = 0;
    for (uint64_t i = 0; i < n; i++) {
        uint32_t dir = (uint32_t)direction[i] & 1u;
        uint32_t kb_exact = pack_meta_c((uint32_t)dport[i],
                                        (uint32_t)proto[i], dir);
        uint32_t kb_l3 = pack_meta_c(0, 0, dir);
        int32_t v;
        if (vc_find(c, identity[i], kb_exact, &v)) {
            out_verdict[i] = v;
            hits++;
        } else if (vc_find(c, identity[i], kb_l3, &v)) {
            out_verdict[i] = 0;  // L3-only match never redirects
            hits++;
        } else if (vc_find(c, 0, kb_exact, &v)) {
            out_verdict[i] = v;
            hits++;
        } else {
            out_verdict[i] = -1;
        }
    }
    return hits;
}

// ---------------------------------------------------------------------------
// Scalar DFA walk: the live proxy's per-request L7 verdict path.
//
// The envoy/cilium_l7policy.cc analog: the reference enforces HTTP
// rules inside Envoy's C++ filter chain; here the SAME stacked DFA
// tables the TPU batch kernel uses (compiler/regexc.py: table [S,256]
// int32, accept [S] u8, starts [R] i32, state 0 = dead) are walked in
// native code for single in-flight requests, so a live connection
// never pays a device round trip.  Two-tier, like the verdict path:
// C++ for latency, TPU for bulk.
// ---------------------------------------------------------------------------

uint64_t dfa_match_scalar(const int32_t* table, const uint8_t* accept,
                          const int32_t* starts, uint64_t n_regex,
                          const uint8_t* data, uint64_t len,
                          uint8_t* out_hit) {
    uint64_t hits = 0;
    for (uint64_t r = 0; r < n_regex; r++) {
        int32_t state = starts[r];
        for (uint64_t i = 0; i < len && state != 0; i++)
            state = table[(uint64_t)state * 256 + data[i]];
        out_hit[r] = accept[state] ? 1 : 0;
        hits += out_hit[r];
    }
    return hits;
}

uint64_t vc_len(void* h) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::shared_lock<std::shared_mutex> lk(c->mu);
    return c->entries;
}

uint64_t vc_slots(void* h) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::shared_lock<std::shared_mutex> lk(c->mu);
    return (uint64_t)c->mask + 1;
}

void vc_flush(void* h) {
    VerdictCache* c = static_cast<VerdictCache*>(h);
    std::unique_lock<std::shared_mutex> lk(c->mu);
    c->init((uint64_t)c->mask + 1);
}

// Reference hash exported so Python can lockstep-test it.
uint32_t vc_hash_mix(uint32_t a, uint32_t b) { return hash_mix(a, b); }

}  // extern "C"
