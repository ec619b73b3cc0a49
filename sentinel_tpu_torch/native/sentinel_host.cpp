// Native host-runtime primitives for the TPU flow-control engine.
//
// The device engine consumes fixed-shape micro-batches; the host hot path
// is "many request threads append events, one tick thread drains a batch".
// In the reference this role is played by lock-free Java structures
// (LongAdder queues, COW maps — SURVEY §5 "race detection").  Here:
//
//  - sx_ring:    a bounded MPMC ring buffer of acquire/complete events
//                (atomic ticket acquisition, per-slot sequence numbers —
//                 the classic Vyukov bounded queue), drained in batch
//                 order directly into caller-provided arrays so Python
//                 receives ready-to-use int32/float32 buffers.
//  - sx_intern:  an open-addressing FNV-1a string -> dense id table with
//                a single writer lock and lock-free readers (the analog
//                of CtSph's copy-on-write chainMap, CtSph.java:207-211).
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (pybind11 is not available in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// event ring
// ---------------------------------------------------------------------------

struct sx_event {
    int32_t res;
    int32_t count;
    int32_t origin_id;
    int32_t param_hash;
    int32_t flags;    // bit0 inbound, bit1 prioritized, bit2 completion
    float   rt_ms;    // completions
    int32_t error;    // completions
    int32_t user_tag; // round-trips to the drainer (e.g. future index)
    int32_t aux0;     // completions: hot-param release lane 0
    int32_t aux1;     // completions: hot-param release lane 1
    int32_t aux2;     // completions: hot-param release lane 2
    int32_t aux3;     // completions: hot-param release lane 3
};

struct sx_slot {
    std::atomic<uint64_t> seq;
    sx_event ev;
};

struct sx_ring {
    uint64_t mask;
    sx_slot* slots;
    alignas(64) std::atomic<uint64_t> head; // next write ticket
    alignas(64) std::atomic<uint64_t> tail; // next read ticket
};

sx_ring* sx_ring_new(uint64_t capacity_pow2) {
    if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1)) != 0)
        return nullptr;
    auto* r = new (std::nothrow) sx_ring();
    if (!r) return nullptr;
    r->slots = new (std::nothrow) sx_slot[capacity_pow2];
    if (!r->slots) { delete r; return nullptr; }
    r->mask = capacity_pow2 - 1;
    for (uint64_t i = 0; i <= r->mask; ++i)
        r->slots[i].seq.store(i, std::memory_order_relaxed);
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    return r;
}

void sx_ring_free(sx_ring* r) {
    if (!r) return;
    delete[] r->slots;
    delete r;
}

// push one event; returns 0 on success, -1 if the ring is full.
// aux0..aux3 carry the four hot-param release lanes (param_dims <= 4)
int32_t sx_ring_push(sx_ring* r, int32_t res, int32_t count, int32_t origin_id,
                     int32_t param_hash, int32_t flags, float rt_ms,
                     int32_t error, int32_t user_tag, int32_t aux0,
                     int32_t aux1, int32_t aux2, int32_t aux3) {
    uint64_t pos = r->head.load(std::memory_order_relaxed);
    for (;;) {
        sx_slot& s = r->slots[pos & r->mask];
        uint64_t seq = s.seq.load(std::memory_order_acquire);
        int64_t diff = (int64_t)seq - (int64_t)pos;
        if (diff == 0) {
            if (r->head.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed))
            {
                s.ev = {res, count, origin_id, param_hash, flags, rt_ms,
                        error, user_tag, aux0, aux1, aux2, aux3};
                s.seq.store(pos + 1, std::memory_order_release);
                return 0;
            }
        } else if (diff < 0) {
            return -1; // full
        } else {
            pos = r->head.load(std::memory_order_relaxed);
        }
    }
}

// drain up to max_n events into parallel arrays; returns count drained.
// Single-consumer use is expected (the tick thread), but the ticket
// scheme stays correct with several.
int64_t sx_ring_drain(sx_ring* r, int64_t max_n, int32_t* res, int32_t* count,
                      int32_t* origin_id, int32_t* param_hash, int32_t* flags,
                      float* rt_ms, int32_t* error, int32_t* user_tag,
                      int32_t* aux0, int32_t* aux1, int32_t* aux2,
                      int32_t* aux3) {
    int64_t n = 0;
    while (n < max_n) {
        uint64_t pos = r->tail.load(std::memory_order_relaxed);
        sx_slot& s = r->slots[pos & r->mask];
        uint64_t seq = s.seq.load(std::memory_order_acquire);
        int64_t diff = (int64_t)seq - (int64_t)(pos + 1);
        if (diff == 0) {
            if (!r->tail.compare_exchange_weak(pos, pos + 1,
                                               std::memory_order_relaxed))
                continue;
            const sx_event& e = s.ev;
            res[n] = e.res; count[n] = e.count; origin_id[n] = e.origin_id;
            param_hash[n] = e.param_hash; flags[n] = e.flags;
            rt_ms[n] = e.rt_ms; error[n] = e.error; user_tag[n] = e.user_tag;
            aux0[n] = e.aux0; aux1[n] = e.aux1;
            aux2[n] = e.aux2; aux3[n] = e.aux3;
            s.seq.store(pos + r->mask + 1, std::memory_order_release);
            ++n;
        } else {
            break; // empty (or producer mid-write: next drain gets it)
        }
    }
    return n;
}

int64_t sx_ring_size(sx_ring* r) {
    return (int64_t)(r->head.load(std::memory_order_relaxed) -
                     r->tail.load(std::memory_order_relaxed));
}

// ---------------------------------------------------------------------------
// string interner
// ---------------------------------------------------------------------------

struct sx_intern_entry {
    std::atomic<uint64_t> hash; // 0 = empty
    std::atomic<int32_t> id;    // valid once hash is published
    char* key;
    uint32_t len;
};

struct sx_intern {
    uint64_t mask;
    sx_intern_entry* entries;
    std::atomic<int32_t> next_id;
    int32_t max_ids;
    std::mutex write_lock;
};

static uint64_t fnv1a(const char* p, uint64_t n) {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t i = 0; i < n; ++i) {
        h ^= (unsigned char)p[i];
        h *= 1099511628211ull;
    }
    return h ? h : 1; // 0 is the empty marker
}

sx_intern* sx_intern_new(uint64_t capacity_pow2, int32_t first_id,
                         int32_t max_ids) {
    if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1)) != 0)
        return nullptr;
    auto* t = new (std::nothrow) sx_intern();
    if (!t) return nullptr;
    t->entries = new (std::nothrow) sx_intern_entry[capacity_pow2]();
    if (!t->entries) { delete t; return nullptr; }
    t->mask = capacity_pow2 - 1;
    t->next_id.store(first_id, std::memory_order_relaxed);
    t->max_ids = max_ids;
    return t;
}

void sx_intern_free(sx_intern* t) {
    if (!t) return;
    for (uint64_t i = 0; i <= t->mask; ++i) delete[] t->entries[i].key;
    delete[] t->entries;
    delete t;
}

// lookup-or-insert; returns the dense id, or -1 when id space / table full.
// Readers are lock-free (acquire loads); inserts take the writer lock.
int32_t sx_intern_get(sx_intern* t, const char* key, uint32_t len) {
    uint64_t h = fnv1a(key, len);
    uint64_t idx = h & t->mask;
    // fast path: lock-free probe
    for (uint64_t probes = 0; probes <= t->mask; ++probes) {
        uint64_t eh = t->entries[idx].hash.load(std::memory_order_acquire);
        if (eh == 0) break;
        if (eh == h) {
            const sx_intern_entry& e = t->entries[idx];
            if (e.len == len && std::memcmp(e.key, key, len) == 0)
                return e.id.load(std::memory_order_acquire);
        }
        idx = (idx + 1) & t->mask;
    }
    // slow path: insert under lock (re-probe: someone may have raced us)
    std::lock_guard<std::mutex> g(t->write_lock);
    idx = h & t->mask;
    for (uint64_t probes = 0; probes <= t->mask; ++probes) {
        sx_intern_entry& e = t->entries[idx];
        uint64_t eh = e.hash.load(std::memory_order_acquire);
        if (eh == h && e.len == len && std::memcmp(e.key, key, len) == 0)
            return e.id.load(std::memory_order_acquire);
        if (eh == 0) {
            int32_t id = t->next_id.load(std::memory_order_relaxed);
            if (id >= t->max_ids) return -1;
            char* copy = new (std::nothrow) char[len];
            if (!copy) return -1;
            std::memcpy(copy, key, len);
            e.key = copy;
            e.len = len;
            e.id.store(id, std::memory_order_release);
            e.hash.store(h, std::memory_order_release); // publish last
            t->next_id.store(id + 1, std::memory_order_relaxed);
            return id;
        }
        idx = (idx + 1) & t->mask;
    }
    return -1; // table full
}

int32_t sx_intern_count(sx_intern* t, int32_t first_id) {
    return t->next_id.load(std::memory_order_relaxed) - first_id;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// native front door: epoll TCP server for the cluster token protocol's FLOW
// fast path (SURVEY §2.9 "native boundary"; the reference's analog is the
// Netty pipeline in NettyTransportServer.java:88-93).
//
// Per-request Python costs ~100-300 us on an asyncio loop; this path does
// socket -> frame parse -> flow-id map -> acquire ring in C, the Python
// tick thread drains acquires straight into engine batch columns, and
// verdicts return through a response ring that this thread writes back to
// the sockets.  Python runs per TICK, not per request.
//
// Protocol handled natively on ONE port (TokenServerHandler.java:61-75
// parity): PING (replied inline), MSG_TYPE_FLOW, MSG_TYPE_PARAM_FLOW
// (param values hashed in C — int/long/bool/string; a double falls back to
// STATUS_FAIL, matching ParamFlowRequestDataWriter's primitives+strings
// envelope), and CONCURRENT acquire/release (routed to the host manager
// via the same ring, answered through respond_ex).  Multi-param requests
// fan out to one engine item per value and JOIN in the pend slot (all
// values must pass).  SO_REUSEPORT sharding: N fronts on one port, the
// kernel load-balances accepted connections across io threads.
// ---------------------------------------------------------------------------

#include <sys/epoll.h>
#include <sys/socket.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <unistd.h>
#include <fcntl.h>
#include <time.h>
#include <algorithm>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int8_t ST_TOO_MANY = -2;
constexpr int8_t ST_BAD = -4;
constexpr int8_t ST_FAIL = -1;
constexpr int8_t ST_OK = 0;
constexpr int8_t ST_NO_RULE = 5;

struct sx_conn {
    int fd;
    uint32_t gen;
    std::vector<uint8_t> rbuf;
    std::vector<uint8_t> wbuf;
    size_t woff = 0;
    bool closing = false;
};

struct Pend {
    int fd;
    uint32_t gen;
    int32_t xid;
    uint8_t type;       // request MSG_TYPE (response framing + joins)
    int16_t remaining;  // outstanding engine items (multi-param join)
    int8_t worst;       // first non-OK status seen across joined items
};

struct FlowSlot {
    std::atomic<int64_t> key;  // (flow_id << 1) | is_param; 0 = empty
    std::atomic<int32_t> row;
    std::atomic<int32_t> lane;  // param hash lane (param mappings only)
};

}  // namespace

struct sx_front {
    int listen_fd = -1;
    int epfd = -1;
    int port = 0;
    std::atomic<bool> running{false};
    std::thread io;
    sx_ring* acq = nullptr;   // front -> tick: res=row, count, flags bit1=prio,
                              // user_tag=correlation slot
    sx_ring* resp = nullptr;  // tick -> front: res=corr, count=verdict,
                              // origin_id=wait_ms
    std::vector<Pend> pend;
    std::vector<int32_t> freelist;
    FlowSlot* fmap = nullptr;
    uint64_t fmask = 0;
    std::unordered_map<int, sx_conn*> conns;
    uint32_t gen_seq = 0;
    // optional request guard: max FLOW requests per second, -1 = off
    std::atomic<int64_t> guard_max{-1};
    int64_t guard_epoch = 0;
    int64_t guard_count = 0;
};

extern "C" {

static void sxf_set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

sx_front* sx_front_new(int port, uint64_t ring_pow2, uint64_t pending_cap,
                       uint64_t fmap_pow2, int32_t reuseport) {
    auto* f = new (std::nothrow) sx_front();
    if (!f) return nullptr;
    f->acq = sx_ring_new(ring_pow2);
    f->resp = sx_ring_new(ring_pow2);
    f->fmap = new (std::nothrow) FlowSlot[fmap_pow2];
    if (!f->acq || !f->resp || !f->fmap) {
        if (f->acq) sx_ring_free(f->acq);
        if (f->resp) sx_ring_free(f->resp);
        delete[] f->fmap;
        delete f;
        return nullptr;
    }
    f->fmask = fmap_pow2 - 1;
    for (uint64_t i = 0; i < fmap_pow2; ++i) {
        f->fmap[i].key.store(0, std::memory_order_relaxed);
        f->fmap[i].row.store(-1, std::memory_order_relaxed);
        f->fmap[i].lane.store(0, std::memory_order_relaxed);
    }
    // INVARIANT: pending_cap <= ring capacity, so at most pending_cap
    // responses can ever be in flight and the response ring cannot fill —
    // sx_front_respond's failure branch is defensive, not expected
    if (pending_cap > ring_pow2) pending_cap = ring_pow2;
    f->pend.resize(pending_cap);
    f->freelist.reserve(pending_cap);
    for (int64_t i = (int64_t)pending_cap - 1; i >= 0; --i)
        f->freelist.push_back((int32_t)i);

    auto fail = [&]() {
        if (f->listen_fd >= 0) close(f->listen_fd);
        sx_ring_free(f->acq);
        sx_ring_free(f->resp);
        delete[] f->fmap;
        delete f;
        return (sx_front*)nullptr;
    };
    f->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    if (f->listen_fd < 0) return fail();
    int one = 1;
    setsockopt(f->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    if (reuseport)
        setsockopt(f->listen_fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)port);
    if (bind(f->listen_fd, (sockaddr*)&addr, sizeof addr) != 0 ||
        listen(f->listen_fd, 1024) != 0) {
        return fail();
    }
    socklen_t alen = sizeof addr;
    getsockname(f->listen_fd, (sockaddr*)&addr, &alen);
    f->port = ntohs(addr.sin_port);
    sxf_set_nonblock(f->listen_fd);
    return f;
}

int32_t sx_front_port(sx_front* f) { return f ? f->port : -1; }

// typed key: (flow_id << 1) | is_param — flow and param rule ids live in
// independent spaces (ClusterFlowRuleManager vs ClusterParamFlowRuleManager)
static int32_t sxf_map_put(sx_front* f, int64_t key, int32_t row, int32_t lane) {
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    for (uint64_t i = 0; i <= f->fmask; ++i) {
        uint64_t idx = (h + i) & f->fmask;
        int64_t k = f->fmap[idx].key.load(std::memory_order_acquire);
        if (k == key || k == 0) {
            f->fmap[idx].row.store(row, std::memory_order_relaxed);
            f->fmap[idx].lane.store(lane, std::memory_order_relaxed);
            f->fmap[idx].key.store(key, std::memory_order_release);
            return 0;
        }
    }
    return -1;  // map full
}

// flow_id -> engine row; 0 is not a valid flow id (used as empty marker)
int32_t sx_front_map_flow(sx_front* f, int64_t flow_id, int32_t row) {
    if (!f || flow_id == 0) return -1;
    return sxf_map_put(f, flow_id << 1, row, 0);
}

// param flow_id -> engine row of its $cluster/param resource + hash lane.
// The event ring carries exactly two hash lanes (a0/a1): a mapping with
// lane>1 would silently hash to 0 in sxf_parse and pass unchecked, so
// refuse it here — such rules stay on the asyncio server, which handles
// arbitrary lanes.
int32_t sx_front_map_param(sx_front* f, int64_t flow_id, int32_t row,
                           int32_t lane) {
    if (!f || flow_id == 0 || lane < 0 || lane > 1) return -1;
    return sxf_map_put(f, (flow_id << 1) | 1, row, lane);
}

// wipe every flow mapping (rule reload re-adds the live set; clear-all
// avoids open-addressing tombstones).  Lookups racing a clear observe
// NO_RULE briefly, matching the asyncio server's reload window.
void sx_front_clear_flows(sx_front* f) {
    if (!f) return;
    for (uint64_t i = 0; i <= f->fmask; ++i) {
        f->fmap[i].row.store(-1, std::memory_order_relaxed);
        f->fmap[i].lane.store(0, std::memory_order_relaxed);
        f->fmap[i].key.store(0, std::memory_order_release);
    }
}

// acquire-ring backlog (tick-side: keep draining without a timer wait)
int64_t sx_front_acq_backlog(sx_front* f) {
    return f ? sx_ring_size(f->acq) : 0;
}

void sx_front_set_guard(sx_front* f, int64_t max_per_sec) {
    if (f) f->guard_max.store(max_per_sec, std::memory_order_relaxed);
}

static int32_t sxf_lookup(sx_front* f, int64_t key, int32_t* lane_out) {
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    for (uint64_t i = 0; i <= f->fmask; ++i) {
        uint64_t idx = (h + i) & f->fmask;
        int64_t k = f->fmap[idx].key.load(std::memory_order_acquire);
        if (k == key) {
            if (lane_out) *lane_out = f->fmap[idx].lane.load(std::memory_order_relaxed);
            return f->fmap[idx].row.load(std::memory_order_relaxed);
        }
        if (k == 0) return -1;
    }
    return -1;
}

// hash_param parity with core/rule_tensors.hash_param: ints/bools multiply
// by the golden ratio constant (low bits survive mod-2^64 wrap, so this
// matches Python's arbitrary-precision product & 0x7FFFFFFF); strings are
// 32-bit FNV-1a masked to 31 bits; 0 maps to 1 ("no parameter" sentinel).
static int32_t sxf_hash_int(int64_t v) {
    uint64_t h = (uint64_t)v * 0x9E3779B1ull;
    int32_t r = (int32_t)(h & 0x7FFFFFFFull);
    return r == 0 ? 1 : r;
}
static int32_t sxf_hash_str(const uint8_t* s, size_t n) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < n; ++i) h = (h ^ s[i]) * 16777619u;
    int32_t r = (int32_t)(h & 0x7FFFFFFFu);
    return r == 0 ? 1 : r;
}

static void sxf_queue_resp(sx_conn* c, int32_t xid, uint8_t type, int8_t status,
                           int32_t remaining, int32_t wait_ms,
                           int64_t token_id = 0) {
    // 2-byte BE length + xid(4) type(1) status(1) + typed payload:
    //   flow/param/batch -> remaining(4) wait(4); concurrent acq -> token(8)
    uint8_t body[14];
    body[0] = (uint8_t)(xid >> 24); body[1] = (uint8_t)(xid >> 16);
    body[2] = (uint8_t)(xid >> 8);  body[3] = (uint8_t)xid;
    body[4] = type;
    body[5] = (uint8_t)status;
    size_t n = 6;
    if (type == 1 || type == 2 || type == 10) {
        body[6] = (uint8_t)(remaining >> 24); body[7] = (uint8_t)(remaining >> 16);
        body[8] = (uint8_t)(remaining >> 8);  body[9] = (uint8_t)remaining;
        body[10] = (uint8_t)(wait_ms >> 24);  body[11] = (uint8_t)(wait_ms >> 16);
        body[12] = (uint8_t)(wait_ms >> 8);   body[13] = (uint8_t)wait_ms;
        n = 14;
    } else if (type == 3) {
        for (int i = 0; i < 8; ++i)
            body[6 + i] = (uint8_t)(token_id >> (8 * (7 - i)));
        n = 14;
    }
    c->wbuf.push_back((uint8_t)(n >> 8));
    c->wbuf.push_back((uint8_t)n);
    c->wbuf.insert(c->wbuf.end(), body, body + n);
}

static void sxf_flush(sx_front* f, sx_conn* c) {
    while (c->woff < c->wbuf.size()) {
        ssize_t w = write(c->fd, c->wbuf.data() + c->woff, c->wbuf.size() - c->woff);
        if (w > 0) {
            c->woff += (size_t)w;
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            break;  // EPOLLOUT (level-triggered epoll retries us next loop)
        } else {
            c->closing = true;
            break;
        }
    }
    if (c->woff >= c->wbuf.size()) {
        c->wbuf.clear();
        c->woff = 0;
    } else if (c->woff > (1u << 20)) {
        c->wbuf.erase(c->wbuf.begin(), c->wbuf.begin() + c->woff);
        c->woff = 0;
    }
}

static bool sxf_guard_ok(sx_front* f) {
    int64_t mx = f->guard_max.load(std::memory_order_relaxed);
    if (mx < 0) return true;
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC_COARSE, &ts);
    if (ts.tv_sec != f->guard_epoch) {
        f->guard_epoch = ts.tv_sec;
        f->guard_count = 0;
    }
    return ++f->guard_count <= mx;
}

static void sxf_parse(sx_front* f, sx_conn* c) {
    size_t off = 0;
    auto& b = c->rbuf;
    while (b.size() - off >= 2) {
        size_t len = ((size_t)b[off] << 8) | b[off + 1];
        if (b.size() - off - 2 < len) break;
        const uint8_t* p = b.data() + off + 2;
        off += 2 + len;
        if (len < 5) continue;
        int32_t xid = ((int32_t)p[0] << 24) | ((int32_t)p[1] << 16) |
                      ((int32_t)p[2] << 8) | (int32_t)p[3];
        uint8_t type = p[4];
        if (type == 0) {  // PING — namespace payload ignored (single-tenant door)
            sxf_queue_resp(c, xid, 0, ST_OK, 0, 0);
            continue;
        }
        if (type == 1 && len >= 5 + 13) {  // FLOW
            int64_t flow_id = 0;
            for (int i = 0; i < 8; ++i) flow_id = (flow_id << 8) | p[5 + i];
            int32_t count = ((int32_t)p[13] << 24) | ((int32_t)p[14] << 16) |
                            ((int32_t)p[15] << 8) | (int32_t)p[16];
            uint8_t prio = p[17];
            int32_t row = sxf_lookup(f, flow_id << 1, nullptr);
            if (row < 0) {
                sxf_queue_resp(c, xid, 1, ST_NO_RULE, 0, 0);
                continue;
            }
            if (!sxf_guard_ok(f) || f->freelist.empty()) {
                sxf_queue_resp(c, xid, 1, ST_TOO_MANY, 0, 0);
                continue;
            }
            int32_t corr = f->freelist.back();
            f->freelist.pop_back();
            f->pend[corr] = Pend{c->fd, c->gen, xid, 1, 1, ST_OK};
            if (sx_ring_push(f->acq, row, count, 0, 0, (1 << 4) | (prio ? 2 : 0),
                             0.0f, 0, corr, 0, 0, 0, 0) != 0) {
                f->freelist.push_back(corr);
                sxf_queue_resp(c, xid, 1, ST_TOO_MANY, 0, 0);
            }
            continue;
        }
        if (type == 2 && len >= 5 + 12) {  // PARAM_FLOW
            int64_t flow_id = 0;
            for (int i = 0; i < 8; ++i) flow_id = (flow_id << 8) | p[5 + i];
            int32_t count = ((int32_t)p[13] << 24) | ((int32_t)p[14] << 16) |
                            ((int32_t)p[15] << 8) | (int32_t)p[16];
            int32_t lane = 0;
            int32_t row = sxf_lookup(f, (flow_id << 1) | 1, &lane);
            if (row < 0) {
                sxf_queue_resp(c, xid, 2, ST_NO_RULE, 0, 0);
                continue;
            }
            // parse typed params (ParamFlowRequestDataWriter envelope,
            // protocol.py tags): int(0x00 i32) long(0x01 i64) double(0x02)
            // string(0x03 u16+utf8) bool(0x04).  A double can't reproduce
            // Python's str() hashing in C — answer FAIL and let the caller
            // use the asyncio server.
            int32_t hashes[16];
            int k = 0;
            bool bad = false, dbl = false;
            size_t q = 17;  // offset of the params blob within the frame
            while (q < len && k < 16) {
                uint8_t tag = p[q++];
                if (tag == 0 && q + 4 <= len) {
                    int32_t v = ((int32_t)p[q] << 24) | ((int32_t)p[q + 1] << 16) |
                                ((int32_t)p[q + 2] << 8) | (int32_t)p[q + 3];
                    hashes[k++] = sxf_hash_int(v);
                    q += 4;
                } else if (tag == 1 && q + 8 <= len) {
                    int64_t v = 0;
                    for (int i = 0; i < 8; ++i) v = (v << 8) | p[q + i];
                    hashes[k++] = sxf_hash_int(v);
                    q += 8;
                } else if (tag == 4 && q + 1 <= len) {
                    hashes[k++] = sxf_hash_int(p[q] ? 1 : 0);
                    q += 1;
                } else if (tag == 3 && q + 2 <= len) {
                    size_t sn = ((size_t)p[q] << 8) | p[q + 1];
                    q += 2;
                    if (q + sn > len) { bad = true; break; }
                    hashes[k++] = sxf_hash_str(p + q, sn);
                    q += sn;
                } else if (tag == 2) {
                    dbl = true;
                    break;
                } else {
                    bad = true;
                    break;
                }
            }
            if (dbl) { sxf_queue_resp(c, xid, 2, ST_FAIL, 0, 0); continue; }
            if (k == 16 && q < len) {
                // more than 16 values: refuse loudly rather than silently
                // check a prefix (the asyncio server handles such requests)
                sxf_queue_resp(c, xid, 2, ST_FAIL, 0, 0);
                continue;
            }
            if (bad || k == 0) { sxf_queue_resp(c, xid, 2, ST_BAD, 0, 0); continue; }
            if (!sxf_guard_ok(f) || f->freelist.empty()) {
                sxf_queue_resp(c, xid, 2, ST_TOO_MANY, 0, 0);
                continue;
            }
            int32_t corr = f->freelist.back();
            f->freelist.pop_back();
            f->pend[corr] = Pend{c->fd, c->gen, xid, 2, (int16_t)k, ST_OK};
            int pushed = 0;
            for (int i = 0; i < k; ++i) {
                int32_t a0 = lane == 0 ? hashes[i] : 0;
                int32_t a1 = lane == 1 ? hashes[i] : 0;
                if (sx_ring_push(f->acq, row, count, 0, 0, (2 << 4), 0.0f, 0,
                                 corr, a0, a1, 0, 0) != 0)
                    break;
                ++pushed;
            }
            if (pushed == 0) {
                f->freelist.push_back(corr);
                sxf_queue_resp(c, xid, 2, ST_TOO_MANY, 0, 0);
            } else if (pushed < k) {
                // partial push: the join completes over the pushed items
                // with a TOO_MANY floor so the caller sees backpressure
                f->pend[corr].remaining = (int16_t)pushed;
                f->pend[corr].worst = ST_TOO_MANY;
            }
            continue;
        }
        if ((type == 3 && len >= 5 + 12) || (type == 4 && len >= 5 + 8)) {
            // CONCURRENT acquire/release: host-managed (TTL token table) —
            // ride the same ring, answered via sx_front_respond_ex
            int64_t v = 0;
            for (int i = 0; i < 8; ++i) v = (v << 8) | p[5 + i];
            int32_t count = 1;
            if (type == 3)
                count = ((int32_t)p[13] << 24) | ((int32_t)p[14] << 16) |
                        ((int32_t)p[15] << 8) | (int32_t)p[16];
            if (!sxf_guard_ok(f) || f->freelist.empty()) {
                sxf_queue_resp(c, xid, type, ST_TOO_MANY, 0, 0);
                continue;
            }
            int32_t corr = f->freelist.back();
            f->freelist.pop_back();
            f->pend[corr] = Pend{c->fd, c->gen, xid, type, 1, ST_OK};
            if (sx_ring_push(f->acq, -1, count, 0, 0, ((int32_t)type << 4),
                             0.0f, 0, corr, (int32_t)(v >> 32),
                             (int32_t)(v & 0xFFFFFFFF), 0, 0) != 0) {
                f->freelist.push_back(corr);
                sxf_queue_resp(c, xid, type, ST_TOO_MANY, 0, 0);
            }
            continue;
        }
        sxf_queue_resp(c, xid, type, ST_FAIL, 0, 0);
    }
    if (off) b.erase(b.begin(), b.begin() + off);
}

static void sxf_drain_responses(sx_front* f) {
    constexpr int64_t MAXB = 8192;
    static thread_local std::vector<int32_t> corr(MAXB), verdict(MAXB),
        wait(MAXB), th(MAXB), tl(MAXB), i2(MAXB), i3(MAXB), a0(MAXB), a1(MAXB),
        a2(MAXB), a3(MAXB);
    static thread_local std::vector<float> f0(MAXB);
    for (;;) {
        int64_t n = sx_ring_drain(f->resp, MAXB, corr.data(), verdict.data(),
                                  wait.data(), th.data(), tl.data(), f0.data(),
                                  i2.data(), i3.data(), a0.data(), a1.data(),
                                  a2.data(), a3.data());
        if (n <= 0) break;
        for (int64_t i = 0; i < n; ++i) {
            int32_t slot = corr[i];
            if (slot < 0 || (size_t)slot >= f->pend.size()) continue;
            Pend& pd = f->pend[slot];
            int8_t st = (int8_t)verdict[i];
            if (st != ST_OK && pd.worst == ST_OK) pd.worst = st;
            if (--pd.remaining > 0) continue;  // multi-param join pending
            Pend done = pd;
            f->freelist.push_back(slot);
            auto it = f->conns.find(done.fd);
            if (it == f->conns.end() || it->second->gen != done.gen) continue;
            int8_t final_st = done.type == 2 ? done.worst : st;
            int64_t tok = ((int64_t)(uint32_t)th[i] << 32) | (uint32_t)tl[i];
            sxf_queue_resp(it->second, done.xid, done.type, final_st, 0,
                           wait[i], tok);
        }
        if (n < MAXB) break;
    }
}

static void sxf_close(sx_front* f, sx_conn* c) {
    epoll_ctl(f->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    f->conns.erase(c->fd);
    delete c;
}

static void sxf_io_loop(sx_front* f) {
    f->epfd = epoll_create1(0);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = f->listen_fd;
    epoll_ctl(f->epfd, EPOLL_CTL_ADD, f->listen_fd, &ev);
    std::vector<epoll_event> evs(256);
    uint8_t buf[65536];
    while (f->running.load(std::memory_order_relaxed)) {
        int n = epoll_wait(f->epfd, evs.data(), (int)evs.size(), 1);
        for (int i = 0; i < n; ++i) {
            int fd = evs[i].data.fd;
            if (fd == f->listen_fd) {
                for (;;) {
                    int cfd = accept(f->listen_fd, nullptr, nullptr);
                    if (cfd < 0) break;
                    sxf_set_nonblock(cfd);
                    int one = 1;
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
                    auto* c = new sx_conn();
                    c->fd = cfd;
                    c->gen = ++f->gen_seq;
                    f->conns[cfd] = c;
                    epoll_event cev{};
                    cev.events = EPOLLIN;
                    cev.data.fd = cfd;
                    epoll_ctl(f->epfd, EPOLL_CTL_ADD, cfd, &cev);
                }
                continue;
            }
            auto it = f->conns.find(fd);
            if (it == f->conns.end()) continue;
            sx_conn* c = it->second;
            for (;;) {
                ssize_t r = read(fd, buf, sizeof buf);
                if (r > 0) {
                    c->rbuf.insert(c->rbuf.end(), buf, buf + r);
                    if (r < (ssize_t)sizeof buf) break;
                } else if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
                    break;
                } else {
                    c->closing = true;
                    break;
                }
            }
            if (!c->closing) sxf_parse(f, c);
        }
        sxf_drain_responses(f);
        std::vector<sx_conn*> dead;
        for (auto& kv : f->conns) {
            sxf_flush(f, kv.second);
            if (kv.second->closing && kv.second->woff >= kv.second->wbuf.size())
                dead.push_back(kv.second);
        }
        for (auto* c : dead) sxf_close(f, c);
    }
    for (auto& kv : f->conns) {
        close(kv.first);
        delete kv.second;
    }
    f->conns.clear();
    close(f->epfd);
    f->epfd = -1;
}

int32_t sx_front_start(sx_front* f) {
    if (!f || f->running.load()) return -1;
    f->running.store(true);
    f->io = std::thread(sxf_io_loop, f);
    return 0;
}

void sx_front_stop(sx_front* f) {
    if (!f) return;
    if (f->running.exchange(false) && f->io.joinable()) f->io.join();
}

void sx_front_free(sx_front* f) {
    if (!f) return;
    sx_front_stop(f);
    if (f->listen_fd >= 0) close(f->listen_fd);
    sx_ring_free(f->acq);
    sx_ring_free(f->resp);
    delete[] f->fmap;
    delete f;
}

// tick side: drain pending FLOW acquires into batch columns.
// prio[i] receives 1 for prioritized requests (bit1 of the event flags).
int64_t sx_front_drain_acquires(sx_front* f, int64_t max_n, int32_t* row,
                                int32_t* count, int32_t* prio, int32_t* corr) {
    static thread_local std::vector<int32_t> scratch_i;
    static thread_local std::vector<float> scratch_f;
    if ((int64_t)scratch_i.size() < max_n * 7) scratch_i.resize(max_n * 7);
    if ((int64_t)scratch_f.size() < max_n) scratch_f.resize(max_n);
    int32_t* origin = scratch_i.data();
    int32_t* ph = origin + max_n;
    int32_t* err = ph + max_n;
    int32_t* a0 = err + max_n;
    int32_t* a1 = a0 + max_n;
    int32_t* a2 = a1 + max_n;
    int32_t* a3 = a2 + max_n;
    int64_t n = sx_ring_drain(f->acq, max_n, row, count, origin, ph, prio,
                              scratch_f.data(), err, corr, a0, a1, a2, a3);
    for (int64_t i = 0; i < n; ++i) prio[i] = (prio[i] >> 1) & 1;
    return n;
}

// tick side: typed drain — kind[i] = MSG_TYPE (1 flow, 2 param, 3/4
// concurrent acquire/release); a0/a1 carry param hash lanes (kind 2) or
// the 64-bit flow/token id halves (kinds 3/4)
int64_t sx_front_drain_acquires2(sx_front* f, int64_t max_n, int32_t* row,
                                 int32_t* count, int32_t* prio, int32_t* corr,
                                 int32_t* kind, int32_t* a0, int32_t* a1) {
    static thread_local std::vector<int32_t> scratch_i;
    static thread_local std::vector<float> scratch_f;
    if ((int64_t)scratch_i.size() < max_n * 5) scratch_i.resize(max_n * 5);
    if ((int64_t)scratch_f.size() < max_n) scratch_f.resize(max_n);
    int32_t* origin = scratch_i.data();
    int32_t* ph = origin + max_n;
    int32_t* err = ph + max_n;
    int32_t* a2 = err + max_n;
    int32_t* a3 = a2 + max_n;
    int64_t n = sx_ring_drain(f->acq, max_n, row, count, origin, ph, prio,
                              scratch_f.data(), err, corr, a0, a1, a2, a3);
    for (int64_t i = 0; i < n; ++i) {
        int32_t fl = prio[i];
        prio[i] = (fl >> 1) & 1;
        int32_t k = fl >> 4;
        kind[i] = k ? k : 1;  // legacy pushes carried no kind bits
    }
    return n;
}

// tick side: push verdicts for drained acquires
int32_t sx_front_respond(sx_front* f, int64_t n, const int32_t* corr,
                         const int32_t* status, const int32_t* wait_ms) {
    int32_t dropped = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (sx_ring_push(f->resp, corr[i], status[i], wait_ms[i], 0, 0, 0.0f,
                         0, 0, 0, 0, 0, 0) != 0)
            ++dropped;
    }
    return dropped;
}

// tick side: typed respond with 64-bit token ids (concurrent acquire)
int32_t sx_front_respond_ex(sx_front* f, int64_t n, const int32_t* corr,
                            const int32_t* status, const int32_t* wait_ms,
                            const int32_t* tok_hi, const int32_t* tok_lo) {
    int32_t dropped = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (sx_ring_push(f->resp, corr[i], status[i], wait_ms[i], tok_hi[i],
                         tok_lo[i], 0.0f, 0, 0, 0, 0, 0, 0) != 0)
            ++dropped;
    }
    return dropped;
}

// ---------------------------------------------------------------------------
// batch build: the tick builder's segment-key presort
// ---------------------------------------------------------------------------
//
// The client presorts every engine batch by the segment keys before
// upload (runtime/client._run_tick).  np.lexsort is the numpy fallback;
// these produce the IDENTICAL stable permutation (std::stable_sort with
// lexicographic key compare == np.lexsort with the keys reversed) plus
// the inverse permutation in the same pass, without numpy's per-key
// temporary allocations.  Keys are int32 columns of equal length n;
// `order` receives the argsort, `inv` (nullable) the inverse.

static void sx_inverse(int64_t n, const int32_t* order, int32_t* inv) {
    for (int64_t i = 0; i < n; ++i) inv[order[i]] = (int32_t)i;
}

// acquire side: np.lexsort((k4, k3, k2, k1, k0)) — k0 most significant
int64_t sx_batch_sort5(int64_t n, const int32_t* k0, const int32_t* k1,
                       const int32_t* k2, const int32_t* k3,
                       const int32_t* k4, int32_t* order, int32_t* inv) {
    for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
    std::stable_sort(order, order + n, [&](int32_t a, int32_t b) {
        if (k0[a] != k0[b]) return k0[a] < k0[b];
        if (k1[a] != k1[b]) return k1[a] < k1[b];
        if (k2[a] != k2[b]) return k2[a] < k2[b];
        if (k3[a] != k3[b]) return k3[a] < k3[b];
        return k4[a] < k4[b];
    });
    if (inv) sx_inverse(n, order, inv);
    return n;
}

// completion side: np.lexsort((k2, k1, k0))
int64_t sx_batch_sort3(int64_t n, const int32_t* k0, const int32_t* k1,
                       const int32_t* k2, int32_t* order, int32_t* inv) {
    for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
    std::stable_sort(order, order + n, [&](int32_t a, int32_t b) {
        if (k0[a] != k0[b]) return k0[a] < k0[b];
        if (k1[a] != k1[b]) return k1[a] < k1[b];
        return k2[a] < k2[b];
    });
    if (inv) sx_inverse(n, order, inv);
    return n;
}

// -- protocol v2 BATCH framing (cluster/protocol.py) ------------------------
//
// Fixed-width big-endian column entries:
//   request entry  (14 B): [kind:u8][id:i64][count:i32][flags:u8]
//   response entry (17 B): [status:i8][remaining:i32][wait:i32][token:i64]
// Pack/unpack is the per-frame hot loop on both sides of the wire; the
// numpy fallback (ring.py structured dtypes) produces IDENTICAL bytes.

static inline void sxw_be32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);  p[3] = (uint8_t)v;
}
static inline void sxw_be64(uint8_t* p, uint64_t v) {
    sxw_be32(p, (uint32_t)(v >> 32));
    sxw_be32(p + 4, (uint32_t)v);
}
static inline uint32_t sxr_be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}
static inline uint64_t sxr_be64(const uint8_t* p) {
    return ((uint64_t)sxr_be32(p) << 32) | (uint64_t)sxr_be32(p + 4);
}

int64_t sx_frame_pack_entries(int64_t n, const uint8_t* kinds,
                              const int64_t* ids, const int32_t* counts,
                              const uint8_t* flags, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint8_t* e = out + i * 14;
        e[0] = kinds[i];
        sxw_be64(e + 1, (uint64_t)ids[i]);
        sxw_be32(e + 9, (uint32_t)counts[i]);
        e[13] = flags[i];
    }
    return n;
}

int64_t sx_frame_unpack_entries(int64_t n, const uint8_t* buf, uint8_t* kinds,
                                int64_t* ids, int32_t* counts,
                                uint8_t* flags) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* e = buf + i * 14;
        kinds[i] = e[0];
        ids[i] = (int64_t)sxr_be64(e + 1);
        counts[i] = (int32_t)sxr_be32(e + 9);
        flags[i] = e[13];
    }
    return n;
}

int64_t sx_frame_pack_results(int64_t n, const int8_t* statuses,
                              const int32_t* remainings, const int32_t* waits,
                              const int64_t* tokens, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint8_t* e = out + i * 17;
        e[0] = (uint8_t)statuses[i];
        sxw_be32(e + 1, (uint32_t)remainings[i]);
        sxw_be32(e + 5, (uint32_t)waits[i]);
        sxw_be64(e + 9, (uint64_t)tokens[i]);
    }
    return n;
}

int64_t sx_frame_unpack_results(int64_t n, const uint8_t* buf,
                                int8_t* statuses, int32_t* remainings,
                                int32_t* waits, int64_t* tokens) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* e = buf + i * 17;
        statuses[i] = (int8_t)e[0];
        remainings[i] = (int32_t)sxr_be32(e + 1);
        waits[i] = (int32_t)sxr_be32(e + 5);
        tokens[i] = (int64_t)sxr_be64(e + 9);
    }
    return n;
}

}  // extern "C"
