// Host-side IO runtime: mmap'd vector files, batched row gather, LRU row cache.
//
// This is the TPU framework's native analogue of the reference's disk IO
// stack: io_uring batched sector reads (diskann-disk/.../platform/linux.rs),
// the aligned reader (aligned_read.rs) and the node cache
// (data_model/cache.rs).  On a TPU host the "device" is host RAM / page
// cache; the hot operations are batched row gathers feeding HBM staging
// buffers, which this implements with mmap + multithreaded memcpy and an
// optional LRU cache for hot rows.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

struct File {
    int fd = -1;
    const uint8_t* base = nullptr;  // mmap base (row 0, header skipped)
    size_t map_len = 0;
    int64_t n = 0;
    int64_t dim = 0;
    int64_t row_bytes = 0;
};

struct LruCache {
    // fixed-capacity LRU over row ids; values are offsets into `slab`
    explicit LruCache(int64_t cap, int64_t row_bytes)
        : cap(cap), row_bytes(row_bytes), slab(cap * row_bytes) {}
    int64_t cap;
    int64_t row_bytes;
    std::vector<uint8_t> slab;
    std::unordered_map<int64_t, int64_t> pos;   // row id -> slot
    std::vector<int64_t> slot_row;              // slot -> row id
    std::vector<int64_t> lru_prev, lru_next;    // doubly linked list by slot
    int64_t head = -1, tail = -1;               // head = most recent
    std::mutex mu;
    std::atomic<int64_t> hits{0}, misses{0};

    void touch(int64_t slot) {
        if (head == slot) return;
        // unlink
        if (lru_prev[slot] >= 0) lru_next[lru_prev[slot]] = lru_next[slot];
        if (lru_next[slot] >= 0) lru_prev[lru_next[slot]] = lru_prev[slot];
        if (tail == slot) tail = lru_prev[slot];
        // push front
        lru_prev[slot] = -1;
        lru_next[slot] = head;
        if (head >= 0) lru_prev[head] = slot;
        head = slot;
        if (tail < 0) tail = slot;
    }

    int64_t get_or_insert(int64_t row, const uint8_t* src, bool* was_hit) {
        std::lock_guard<std::mutex> lock(mu);
        auto it = pos.find(row);
        if (it != pos.end()) {
            *was_hit = true;
            hits.fetch_add(1, std::memory_order_relaxed);
            touch(it->second);
            return it->second;
        }
        *was_hit = false;
        misses.fetch_add(1, std::memory_order_relaxed);
        int64_t slot;
        if ((int64_t)slot_row.size() < cap) {
            slot = (int64_t)slot_row.size();
            slot_row.push_back(row);
            lru_prev.push_back(-1);
            lru_next.push_back(head);
            if (head >= 0) lru_prev[head] = slot;
            head = slot;
            if (tail < 0) tail = slot;
        } else {
            slot = tail;  // evict least-recent
            pos.erase(slot_row[slot]);
            slot_row[slot] = row;
            touch(slot);
        }
        std::memcpy(slab.data() + slot * row_bytes, src, row_bytes);
        pos[row] = slot;
        return slot;
    }
};

struct Pipe {
    // async gather pipeline: tickets enqueue row-gather jobs executed by a
    // worker pool; wait() blocks until a ticket's chunks all complete.
    // The io_uring submission/completion-queue analogue.
    struct Job {
        const File* f;
        std::shared_ptr<std::vector<int64_t>> ids;
        uint8_t* out;              // caller-owned destination
        int64_t lo, hi;            // chunk range within ids
        std::atomic<int64_t>* remaining;
    };
    std::deque<Job> q;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::vector<std::thread> workers;
    std::unordered_map<int64_t, std::shared_ptr<std::atomic<int64_t>>> tickets;
    std::unordered_map<int64_t, std::shared_ptr<std::vector<int64_t>>> ticket_ids;
    int64_t next_ticket = 1;
    bool stop = false;

    explicit Pipe(int64_t n_threads) {
        for (int64_t t = 0; t < n_threads; ++t) {
            workers.emplace_back([this] { run(); });
        }
    }

    ~Pipe() {
        {
            std::lock_guard<std::mutex> lock(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }

    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [this] { return stop || !q.empty(); });
                if (stop && q.empty()) return;
                job = std::move(q.front());
                q.pop_front();
            }
            const int64_t rb = job.f->row_bytes;
            const int64_t* ids = job.ids->data();
            for (int64_t i = job.lo; i < job.hi; ++i) {
                int64_t id = ids[i];
                if (id < 0) id = 0;
                if (id >= job.f->n) id = job.f->n - 1;
                std::memcpy(job.out + i * rb, job.f->base + id * rb, rb);
            }
            if (job.remaining->fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lock(mu);
                done_cv.notify_all();
            }
        }
    }

    int64_t submit(const File* f, const int64_t* ids, int64_t count,
                   uint8_t* out) {
        auto idv = std::make_shared<std::vector<int64_t>>(ids, ids + count);
        int64_t n_chunks =
            std::max<int64_t>(1, std::min<int64_t>((int64_t)workers.size(),
                                                   count / 2048 + 1));
        auto rem = std::make_shared<std::atomic<int64_t>>(n_chunks);
        int64_t ticket;
        {
            std::lock_guard<std::mutex> lock(mu);
            ticket = next_ticket++;
            tickets[ticket] = rem;
            ticket_ids[ticket] = idv;
            int64_t per = (count + n_chunks - 1) / n_chunks;
            for (int64_t c = 0; c < n_chunks; ++c) {
                int64_t lo = c * per, hi = std::min(count, lo + per);
                if (lo >= hi) { rem->fetch_sub(1); continue; }
                q.push_back(Job{f, idv, out, lo, hi, rem.get()});
            }
        }
        cv.notify_all();
        return ticket;
    }

    void wait(int64_t ticket) {
        std::shared_ptr<std::atomic<int64_t>> rem;
        {
            std::lock_guard<std::mutex> lock(mu);
            auto it = tickets.find(ticket);
            if (it == tickets.end()) return;
            rem = it->second;
        }
        std::unique_lock<std::mutex> lock(mu);
        done_cv.wait(lock, [&] { return rem->load() <= 0; });
        tickets.erase(ticket);
        ticket_ids.erase(ticket);
    }
};

// ---- io_uring batched reads (raw syscalls; no liburing in the image) ----
//
// The reference's Linux disk path submits batched sector reads through
// io_uring (`diskann-disk/src/platform/linux.rs`).  This is the same
// mechanism against the row file: one ring, waves of IORING_OP_READ sqes,
// completions drained in bulk.  mmap+memcpy wins when the file is page-
// cache-resident (this host), io_uring wins on real SSD cold reads; both
// paths share the clamp/row semantics.  Containers often disable the
// io_uring syscalls, so creation probes and callers must fall back.

static int sys_io_uring_setup(unsigned entries, io_uring_params* p) {
    return (int)syscall(__NR_io_uring_setup, entries, p);
}
static int sys_io_uring_enter(int fd, unsigned to_submit,
                              unsigned min_complete, unsigned flags) {
    return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

namespace {

struct Uring {
    int ring_fd = -1;
    unsigned depth = 0;
    unsigned cq_entries = 0;
    bool poisoned = false;   // enter failed with reads in flight: stale
                             // CQEs / late writes make the ring unusable
    void* sq_mm = nullptr;
    size_t sq_len = 0;
    void* cq_mm = nullptr;      // == sq_mm under IORING_FEAT_SINGLE_MMAP
    size_t cq_len = 0;
    io_uring_sqe* sqes = nullptr;
    size_t sqes_len = 0;
    unsigned* sq_head = nullptr;
    unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    unsigned* cq_head = nullptr;
    unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    std::mutex mu;   // one gather at a time per ring

    ~Uring() {
        if (sqes) munmap(sqes, sqes_len);
        if (cq_mm && cq_mm != sq_mm) munmap(cq_mm, cq_len);
        if (sq_mm) munmap(sq_mm, sq_len);
        if (ring_fd >= 0) ::close(ring_fd);
    }
};

Uring* uring_create(unsigned depth) {
    io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    int fd = sys_io_uring_setup(depth, &p);
    if (fd < 0) return nullptr;   // kernel/seccomp refused: caller falls back
    auto* u = new Uring();
    u->ring_fd = fd;
    u->depth = p.sq_entries;
    u->cq_entries = p.cq_entries;
    u->sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    u->cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
        u->sq_len = u->cq_len = std::max(u->sq_len, u->cq_len);
    }
    u->sq_mm = mmap(nullptr, u->sq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (u->sq_mm == MAP_FAILED) { u->sq_mm = nullptr; delete u; return nullptr; }
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
        u->cq_mm = u->sq_mm;
    } else {
        u->cq_mm = mmap(nullptr, u->cq_len, PROT_READ | PROT_WRITE,
                        MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
        if (u->cq_mm == MAP_FAILED) { u->cq_mm = nullptr; delete u; return nullptr; }
    }
    u->sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    u->sqes = (io_uring_sqe*)mmap(nullptr, u->sqes_len,
                                  PROT_READ | PROT_WRITE,
                                  MAP_SHARED | MAP_POPULATE, fd,
                                  IORING_OFF_SQES);
    if (u->sqes == MAP_FAILED) { u->sqes = nullptr; delete u; return nullptr; }
    auto* sqb = (uint8_t*)u->sq_mm;
    u->sq_head = (unsigned*)(sqb + p.sq_off.head);
    u->sq_tail = (unsigned*)(sqb + p.sq_off.tail);
    u->sq_mask = (unsigned*)(sqb + p.sq_off.ring_mask);
    u->sq_array = (unsigned*)(sqb + p.sq_off.array);
    auto* cqb = (uint8_t*)u->cq_mm;
    u->cq_head = (unsigned*)(cqb + p.cq_off.head);
    u->cq_tail = (unsigned*)(cqb + p.cq_off.tail);
    u->cq_mask = (unsigned*)(cqb + p.cq_off.ring_mask);
    u->cqes = (io_uring_cqe*)(cqb + p.cq_off.cqes);
    return u;
}

// Gather rows via waves of IORING_OP_READ.  Returns 0 on success, -1 on a
// ring failure (caller should fall back to hio_gather).  Short/failed reads
// are repaired with pread so the output is always fully populated.
int uring_gather(Uring* u, const File* f, const int64_t* ids, int64_t count,
                 uint8_t* out) {
    std::lock_guard<std::mutex> lock(u->mu);
    if (u->poisoned) return -1;
    const int64_t rb = f->row_bytes;
    const unsigned mask = *u->sq_mask;
    int64_t next = 0;       // next row to submit
    int64_t done = 0;       // completions drained
    while (done < count) {
        // fill the ring — bounded by CQ capacity too: SQ slots free at
        // submit time, so an unpaced loop could overflow the CQ (EBUSY /
        // dropped completions)
        unsigned head =
            __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
        unsigned tail = *u->sq_tail;
        unsigned space = u->depth - (tail - head);
        unsigned in_flight = (unsigned)(next - done);
        if (space > u->cq_entries - in_flight)
            space = u->cq_entries - in_flight;
        unsigned batch = 0;
        while (batch < space && next < count) {
            int64_t id = ids[next];
            if (id < 0) id = 0;
            if (id >= f->n) id = f->n - 1;
            unsigned idx = (tail + batch) & mask;
            io_uring_sqe* sqe = &u->sqes[idx];
            std::memset(sqe, 0, sizeof(*sqe));
            sqe->opcode = IORING_OP_READ;
            sqe->fd = f->fd;
            sqe->addr = (uint64_t)(out + next * rb);
            sqe->len = (unsigned)rb;
            sqe->off = (uint64_t)(8 + id * rb);   // skip [n][dim] header
            sqe->user_data = (uint64_t)next;
            u->sq_array[idx] = idx;
            ++batch;
            ++next;
        }
        __atomic_store_n(u->sq_tail, tail + batch, __ATOMIC_RELEASE);
        unsigned want = (unsigned)std::min<int64_t>(next - done, 1);
        int r;
        do {
            r = sys_io_uring_enter(u->ring_fd, batch, want,
                                   IORING_ENTER_GETEVENTS);
            batch = 0;  // sqes are consumed even when the wait is EINTR'd
        } while (r < 0 && errno == EINTR);
        if (r < 0) {
            // reads may still be in flight: stale CQEs would corrupt the
            // next gather and late kernel writes its output buffer —
            // poison the ring so the caller falls back permanently
            u->poisoned = true;
            return -1;
        }
        // drain completions
        unsigned chead = *u->cq_head;
        unsigned ctail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
        const unsigned cmask = *u->cq_mask;
        while (chead != ctail) {
            const io_uring_cqe* cqe = &u->cqes[chead & cmask];
            int64_t i = (int64_t)cqe->user_data;
            if (cqe->res != (int32_t)rb) {
                // short read / error: repair synchronously
                int64_t id = ids[i];
                if (id < 0) id = 0;
                if (id >= f->n) id = f->n - 1;
                if (pread(f->fd, out + i * rb, rb, 8 + id * rb) != rb) {
                    std::memcpy(out + i * rb, f->base + id * rb, rb);
                }
            }
            ++chead;
            ++done;
        }
        __atomic_store_n(u->cq_head, chead, __ATOMIC_RELEASE);
    }
    return 0;
}

}  // namespace

}  // namespace

extern "C" {

// Open a [n:i32][dim:i32] header binary file of `elem_size`-byte elements.
// Returns an opaque handle or nullptr.
void* hio_open(const char* path, int64_t elem_size) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    int32_t hdr[2];
    if (pread(fd, hdr, 8, 0) != 8) { ::close(fd); return nullptr; }
    auto* f = new File();
    f->fd = fd;
    f->n = hdr[0];
    f->dim = hdr[1];
    f->row_bytes = f->dim * elem_size;
    f->map_len = (size_t)st.st_size;
    void* m = mmap(nullptr, f->map_len, PROT_READ, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) { ::close(fd); delete f; return nullptr; }
    madvise(m, f->map_len, MADV_RANDOM);
    f->base = (const uint8_t*)m + 8;
    return f;
}

int64_t hio_rows(void* h) { return ((File*)h)->n; }
int64_t hio_dim(void* h) { return ((File*)h)->dim; }

// Gather `count` rows into `out` (count * row_bytes). Ids out of range are
// clamped. Uses up to `threads` worker threads for large batches.
void hio_gather(void* h, const int64_t* ids, int64_t count, uint8_t* out,
                int64_t threads) {
    File* f = (File*)h;
    const int64_t rb = f->row_bytes;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t id = ids[i];
            if (id < 0) id = 0;
            if (id >= f->n) id = f->n - 1;
            std::memcpy(out + i * rb, f->base + id * rb, rb);
        }
    };
    if (threads <= 1 || count < 4096) {
        work(0, count);
        return;
    }
    std::vector<std::thread> ts;
    int64_t per = (count + threads - 1) / threads;
    for (int64_t t = 0; t < threads; ++t) {
        int64_t lo = t * per, hi = std::min(count, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

void hio_close(void* h) {
    File* f = (File*)h;
    munmap((void*)(f->base - 8), f->map_len);
    ::close(f->fd);
    delete f;
}

// ---- LRU row cache (node cache analogue) ----
void* hio_cache_create(void* h, int64_t capacity_rows) {
    File* f = (File*)h;
    return new LruCache(capacity_rows, f->row_bytes);
}

void hio_gather_cached(void* h, void* c, const int64_t* ids, int64_t count,
                       uint8_t* out) {
    File* f = (File*)h;
    LruCache* cache = (LruCache*)c;
    const int64_t rb = f->row_bytes;
    for (int64_t i = 0; i < count; ++i) {
        int64_t id = ids[i];
        if (id < 0) id = 0;
        if (id >= f->n) id = f->n - 1;
        bool hit = false;
        int64_t slot = cache->get_or_insert(id, f->base + id * rb, &hit);
        std::memcpy(out + i * rb, cache->slab.data() + slot * rb, rb);
    }
}

int64_t hio_cache_hits(void* c) { return ((LruCache*)c)->hits.load(); }
int64_t hio_cache_misses(void* c) { return ((LruCache*)c)->misses.load(); }
void hio_cache_destroy(void* c) { delete (LruCache*)c; }

// ---- async gather pipeline (io_uring submission-queue analogue) ----
void* hio_pipe_create(int64_t n_threads) { return new Pipe(n_threads); }

// Enqueue an async gather of `count` rows into caller-owned `out`
// (count * row_bytes; must stay alive until hio_pipe_wait).  Returns a
// ticket id.
int64_t hio_pipe_submit(void* p, void* h, const int64_t* ids, int64_t count,
                        uint8_t* out) {
    return ((Pipe*)p)->submit((File*)h, ids, count, out);
}

void hio_pipe_wait(void* p, int64_t ticket) { ((Pipe*)p)->wait(ticket); }
void hio_pipe_destroy(void* p) { delete (Pipe*)p; }

// ---- io_uring reader (reference linux.rs analogue; probes at create) ----
void* hio_uring_create(int64_t depth) {
    if (depth < 1) depth = 256;
    return uring_create((unsigned)depth);
}

// 0 = ok, -1 = ring failure (fall back to hio_gather)
int64_t hio_uring_gather(void* u, void* h, const int64_t* ids, int64_t count,
                         uint8_t* out) {
    return uring_gather((Uring*)u, (File*)h, ids, count, out);
}

void hio_uring_destroy(void* u) { delete (Uring*)u; }

}  // extern "C"
