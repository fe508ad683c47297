// The packed list walk's hop tail for Hopper (sm_90a): kernel K3.
//
// Replaces no Pallas kernel.  The JAX package writes this step as plain jnp
// inside its jitted hop (diskann_tpu/graph/search.py, beam_search_scored,
// steps 2-5 with the packed scorer's epilogue), and XLA fuses it into the
// hop's program.  Eager PyTorch issues the same step as ~90 small launches
// a hop (where, reshape, two stable radix sorts, a membership test by sort
// and binary search, cumsum, gathers), and at one query a request the host's
// ~20 us a launch, not the card, set the walk's time.  K3 does it in one
// launch after K1 (fatrow_expand), one block a query row:
//
//   1. each candidate's distance from K1's ids, aux words and int32 dots,
//      with the plain version's float32 operations in its order and no
//      contraction (__fmul_rn, __fadd_rn, __fsub_rn, then the clamp at 0),
//      so every distance is bitwise the plain one; slots of invalid beam
//      entries and -1 neighbours are no candidate (distance +inf);
//   2. dedup by a hash table in shared memory (open addressing, twice the
//      ids it holds): each id keeps the least slot-major index that names
//      it, and the list's ids take -1, so a candidate is fresh when its
//      id's entry is its own index: the first copy, as the plain version's
//      stable sort by id and its list test keep;
//   3. the merge: a fresh candidate whose distance key is not below the
//      list's largest can land at rank L or later (the list wins ties), so
//      only the others are sorted (bitonic, by (key, id), unique among
//      fresh ids).  A candidate's rank in the stable sort of [list,
//      candidates in id order] is its sorted index plus the list entries at
//      or below its key; a list entry's the list entries before it plus the
//      fresh candidates strictly below (all of them sorted) plus, for a key
//      above +inf (NaN), every candidate that is not fresh (distance +inf,
//      id -1); ranks under L are written, the rest of the list is filled
//      with those (+inf, -1, expanded) entries, and the expanded bits are
//      carried as the plain version packs them (id * 2 | expanded, int32);
//   4. the next hop's frontier: warp 0 ballots over the new list for the
//      first W unexpanded entries, writes their ids as the next beam (-1
//      past the last) and marks them expanded; a row with any unexpanded
//      entry sets this hop's flag byte, and block 0 clears the other one
//      for the next hop (the walk reads the flag before the next launch).
//
// The distance key orders floats as torch's sorts do: -0.0 equal to +0.0,
// every NaN above +inf and equal to each other.
//
// What bounds it on this card: bytes would allow ~11 us at the batch
// shape (B=8192, W=4, r_pack=84, L=24): per row W * r_pack * 12 bytes of
// ids, aux and dots read (the rest of K1's 512-byte sections is not read),
// the list read and written (12 bytes an entry), beam, cmps, hops, qscale
// and qsq; 4.7 KB a row, 38 MB a call, over 3.35 TB/s.  A row's work is a
// chain of dependent shared-memory steps, each behind a barrier, so the
// kernel is bound by that chain's latency and the SM's issue rate, not by
// bytes.  The design shortens the chain: no sort of all W * r_pack
// candidates (two such sorts, by id and by distance, take ~90 barrier
// stages a row; a first design that made them read 0.29 ms a call at that
// shape), only of the fresh ones
// that can still enter the list; and it keeps many small blocks on an SM (128
// threads and ~16 KB of shared memory a row at that shape) so that one
// block's barriers overlap another's work.  PERF.md gives the measured
// time.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB: a block's most on sm_90
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kEmpty = -1;                  // a free hash slot (ids are >= 0)
constexpr uint32_t kInfKey = 0xff800000u;   // order_key(+inf)
constexpr unsigned long long kPad = ~0ull;

struct Args {
  const int* ids;          // [B*W, stride]: K1's id sections
  const int* aux;          // [B*W, stride]: K1's aux sections (float32 bits)
  const int* dots;         // [B*W, dstride]: K1's int32 dots
  const float* qscale;     // [B]
  const float* qsq;        // [B]
  const int* beam;         // [B, W]: this hop's expanded ids (-1: none)
  int* beam_out;           // [B, W]: the next hop's
  float* best_d;           // [B, L], in place
  int* best_i;
  int* best_e;
  int* cmps;               // [B], in place
  int* hops;
  unsigned char* flag_set;    // this hop's flag
  unsigned char* flag_clear;  // the next hop's, cleared by block 0
  long long stride, dstride;
  int w, rp, l, c;         // beam width, r_pack, list width, W * r_pack
  int p, hbits;            // next pow2 of c; log2 of the hash slots
  int inner_product;
};

// torch's sort order of a float32 as an unsigned key: -0.0 folds into
// +0.0, NaN sorts last
__device__ __forceinline__ uint32_t order_key(float d) {
  if (d != d) return 0xffffffffu;
  const uint32_t u = __float_as_uint(__fadd_rn(d, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t hash_slot(int id, int hbits) {
  return (static_cast<uint32_t>(id) * 0x9e3779b1u) >> (32 - hbits);
}

// The slot of id (>= 0), claimed if it is not in the table yet.
__device__ __forceinline__ int hash_insert(int* hk, int hbits, int id) {
  const uint32_t mask = (1u << hbits) - 1u;
  for (uint32_t h = hash_slot(id, hbits);; h = (h + 1u) & mask) {
    const int prev = atomicCAS(hk + h, kEmpty, id);
    if (prev == kEmpty || prev == id) return static_cast<int>(h);
  }
}

// The slot of an id already in the table.
__device__ __forceinline__ int hash_find(const int* hk, int hbits, int id) {
  const uint32_t mask = (1u << hbits) - 1u;
  uint32_t h = hash_slot(id, hbits);
  while (hk[h] != id) h = (h + 1u) & mask;
  return static_cast<int>(h);
}

// Ascending bitonic sort of p (a power of two) keys in shared memory by the
// block's threads; ends with a barrier.
__device__ void bitonic_sort(unsigned long long* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & size) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
hop_merge_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [p]
  int* hk = reinterpret_cast<int*>(keys + a.p);          // [1 << hbits] ids
  int* hv = hk + (1 << a.hbits);                         // least index (-1: list)
  float* cdist = reinterpret_cast<float*>(hv + (1 << a.hbits));  // [c]
  int* cid = reinterpret_cast<int*>(cdist + a.c);        // [c] id, -1: none
  float* ld = reinterpret_cast<float*>(cid + a.c);       // [l] the list as it came
  int* li = reinterpret_cast<int*>(ld + a.l);
  int* le = li + a.l;
  uint32_t* lk = reinterpret_cast<uint32_t*>(le + a.l);  // its distance keys
  float* od = reinterpret_cast<float*>(lk + a.l);        // [l] the merged list
  int* oi = reinterpret_cast<int*>(od + a.l);
  int* oe = oi + a.l;
  int* valid = oe + a.l;                                 // [w] beam slot valid
  // fresh candidates, expanded slots, sorted candidates, the list's top key
  int* counts = valid + a.w;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long b = blockIdx.x;
  const long long row = b * a.l;
  const float inf = __int_as_float(0x7f800000);
  const int hn = 1 << a.hbits;

  if (tid < 4) counts[tid] = 0;
  for (int h = tid; h < hn; h += nt) {
    hk[h] = kEmpty;
    hv[h] = INT_MAX;
  }
  for (int k = tid; k < a.w; k += nt) valid[k] = a.beam[b * a.w + k] >= 0;
  for (int i = tid; i < a.l; i += nt) {
    const float d = a.best_d[row + i];
    ld[i] = d;
    li[i] = a.best_i[row + i];
    le[i] = a.best_e[row + i];
    lk[i] = order_key(d);
    od[i] = inf;   // what no list entry or fresh candidate takes: the
    oi[i] = -1;    // (+inf, -1, expanded) of the candidates not fresh
    oe[i] = 1;
  }
  __syncthreads();

  // 1. candidates and their ids' least index; the list's ids take -1
  const float qs = a.qscale[b];
  const float qq = a.qsq[b];
  for (int j = tid; j < a.c; j += nt) {
    const int slot = j / a.rp;
    const int k = j - slot * a.rp;
    const long long r = b * a.w + slot;
    const int id = valid[slot] ? a.ids[r * a.stride + k] : -1;
    float d = inf;
    if (id >= 0) {
      const float dot = __fmul_rn(__int2float_rn(a.dots[r * a.dstride + k]), qs);
      if (a.inner_product) {
        d = -dot;
      } else {
        d = __fsub_rn(__fadd_rn(qq, __int_as_float(a.aux[r * a.stride + k])),
                      __fmul_rn(2.0f, dot));
        d = d < 0.0f ? 0.0f : d;   // NaN passes, as clamp_min lets it
      }
      atomicMin(hv + hash_insert(hk, a.hbits, id), j);
    }
    cdist[j] = d;
    cid[j] = id < 0 ? -1 : id;
  }
  uint32_t kmax = 0;
  for (int i = tid; i < a.l; i += nt) {
    if (li[i] >= 0) atomicMin(hv + hash_insert(hk, a.hbits, li[i]), -1);
    kmax = lk[i] > kmax ? lk[i] : kmax;
  }
  if (kmax) atomicMax(reinterpret_cast<unsigned*>(counts + 3), kmax);
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < a.w; ++k) n += valid[k];
    counts[1] = n;
  }
  __syncthreads();

  // 2. the fresh candidates (first copies, not in the list); those below
  //    the list's top key go to the sort as (key, id)
  const uint32_t top_key = static_cast<uint32_t>(counts[3]);
  int fresh_n = 0;
  for (int j = tid; j < a.c; j += nt) {
    const int id = cid[j];
    if (id >= 0 && hv[hash_find(hk, a.hbits, id)] == j) {
      ++fresh_n;
      const uint32_t k = order_key(cdist[j]);
      if (k < top_key) {
        keys[atomicAdd(counts + 2, 1)] =
            (static_cast<unsigned long long>(k) << 32) | static_cast<uint32_t>(id);
      }
    }
  }
  if (fresh_n) atomicAdd(counts, fresh_n);
  __syncthreads();
  const int q = counts[2];
  int pq = 1;
  while (pq < q) pq <<= 1;
  for (int t = q + tid; t < pq; t += nt) keys[t] = kPad;
  __syncthreads();
  bitonic_sort(keys, pq);
  const int not_fresh = a.c - counts[0];

  // 3. ranks in the stable merge of [list, candidates in id order]; a
  //    candidate's rank is at least its sorted index, so only the first L
  //    can land in the list
  const int top = q < a.l ? q : a.l;
  for (int t = tid; t < top; t += nt) {
    const uint32_t k = static_cast<uint32_t>(keys[t] >> 32);
    const int id = static_cast<int>(static_cast<uint32_t>(keys[t]));
    int r = t;
    for (int i = 0; i < a.l; ++i) r += lk[i] <= k;
    if (k > kInfKey) {
      r += not_fresh;   // a NaN after every (+inf) candidate not fresh
    } else if (k == kInfKey) {
      // +inf ties with the candidates not fresh: those earlier in id order
      for (int j = 0; j < a.c; ++j) {
        const int cj = cid[j];
        r += cj >= 0 && cj < id && hv[hash_find(hk, a.hbits, cj)] != j;
      }
    }
    if (r < a.l) {
      const int key = static_cast<int>(static_cast<uint32_t>(id) * 2u);
      od[r] = cdist[hv[hash_find(hk, a.hbits, id)]];
      oi[r] = key >> 1;
      oe[r] = key & 1;
    }
  }
  for (int i = tid; i < a.l; i += nt) {
    const uint32_t k = lk[i];
    int r = k > kInfKey ? not_fresh : 0;
    for (int m = 0; m < a.l; ++m) r += lk[m] < k || (lk[m] == k && m < i);
    const unsigned long long below = static_cast<unsigned long long>(k) << 32;
    int lo = 0, hi = q;   // fresh candidates with a key below k
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < below) lo = mid + 1; else hi = mid;
    }
    r += lo;
    if (r < a.l) {
      const int key = static_cast<int>(static_cast<uint32_t>(li[i]) * 2u +
                                       static_cast<uint32_t>(le[i]));
      od[r] = ld[i];
      oi[r] = key >> 1;
      oe[r] = key & 1;
    }
  }
  __syncthreads();

  // 4. the next frontier: the first W unexpanded entries, in list order
  if (tid < 32) {
    int found = 0;
    for (int base = 0; base < a.l && found < a.w; base += 32) {
      const int i = base + tid;
      const bool u = i < a.l && oe[i] == 0 && oi[i] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, u);
      if (u) {
        const int rank = found + __popc(m & ((1u << tid) - 1u));
        if (rank < a.w) {
          a.beam_out[b * a.w + rank] = oi[i];
          oe[i] = 1;
        }
      }
      found += __popc(m);
    }
    for (int k = found + tid; k < a.w; k += 32) a.beam_out[b * a.w + k] = -1;
    if (tid == 0 && found > 0) *a.flag_set = 1;
    if (tid == 0 && b == 0) *a.flag_clear = 0;
  }
  __syncthreads();
  for (int i = tid; i < a.l; i += nt) {
    a.best_d[row + i] = od[i];
    a.best_i[row + i] = oi[i];
    a.best_e[row + i] = oe[i];
  }
  if (tid == 0) {
    a.cmps[b] += counts[0];
    a.hops[b] += counts[1];
  }
}

}  // namespace

// One hop tail of the packed list walk for `rows` query rows (see the note
// above; the wrapper `hop_merge` checks every tensor).  ids / aux [rows*w,
// stride] and dots [rows*w, dstride] are K1's outputs; beam [rows, w] this
// hop's ids, beam_out [rows, w] the next hop's; best_d / best_i / best_e
// [rows, l], cmps and hops [rows] are updated in place; flag_set and
// flag_clear are single bytes.  threads (a multiple of 32, <= 512), the
// hash table's log2 size and smem_bytes come from the wrapper, which sizes
// them from (w * rp, l, w); a size the kernel does not hold is refused.
// Returns a cudaError_t: the shared-memory attribute's, else the launch's.
extern "C" int hop_merge_launch(const void* ids, const void* aux, const void* dots,
                                const void* qscale, const void* qsq, const void* beam,
                                void* beam_out, void* best_d, void* best_i, void* best_e,
                                void* cmps, void* hops, void* flag_set, void* flag_clear,
                                long long rows, int w, int rp, int l, long long stride,
                                long long dstride, int inner_product, int threads,
                                int hash_bits, int smem_bytes, void* stream) {
  if (rows == 0) return 0;
  if (w < 1 || rp < 1 || l < w || stride < rp || dstride < rp || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || rows > 0x7fffffffLL ||
      hash_bits < 1 || hash_bits > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long c = 1LL * w * rp;
  long long p = 1;
  while (p < c) p <<= 1;
  // the table holds each candidate id and list id at most once, at half load
  const long long slots = 1LL << hash_bits;
  const long long need = 8 * p + 8 * slots + 8 * c + 28LL * l + 4LL * w + 16;
  if (slots < 2 * (c + l) || need > smem_bytes || smem_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.aux = static_cast<const int*>(aux);
  a.dots = static_cast<const int*>(dots);
  a.qscale = static_cast<const float*>(qscale);
  a.qsq = static_cast<const float*>(qsq);
  a.beam = static_cast<const int*>(beam);
  a.beam_out = static_cast<int*>(beam_out);
  a.best_d = static_cast<float*>(best_d);
  a.best_i = static_cast<int*>(best_i);
  a.best_e = static_cast<int*>(best_e);
  a.cmps = static_cast<int*>(cmps);
  a.hops = static_cast<int*>(hops);
  a.flag_set = static_cast<unsigned char*>(flag_set);
  a.flag_clear = static_cast<unsigned char*>(flag_clear);
  a.stride = stride;
  a.dstride = dstride;
  a.w = w;
  a.rp = rp;
  a.l = l;
  a.c = static_cast<int>(c);
  a.p = static_cast<int>(p);
  a.hbits = hash_bits;
  a.inner_product = inner_product;

  // the most dynamic shared memory the kernel may take, set once a device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(hop_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
  }
  hop_merge_kernel<<<static_cast<unsigned>(rows), threads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
