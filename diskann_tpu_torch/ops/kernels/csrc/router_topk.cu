// The bf16 router's product, epilogue and top-n_start for Hopper (sm_90a):
// kernel K4.
//
// Replaces no Pallas kernel.  The JAX package leaves the bf16 router to XLA
// (diskann_tpu/graph/index.py, the packed router's product with
// preferred_element_type=bfloat16, its epilogue and top-k), which fuses the
// epilogue into the product's output.  Eager PyTorch wrote the whole
// [B, S] bf16 distance block to device memory (the product, then three
// elementwise passes over it) and ran a radix top-k over it: at B=8192,
// S=65536 that is a 1.07 GB block, read and written ~8 times, for a
// product of 1.4e11 FLOP.  K4 does the same arithmetic in one pass over the
// router table and writes only each query's n_start router ids:
//
//   dot = bf16(sum_k bf16(qs[b,k]) * bf16(rc[s,k]))   (float32 sum, rounded once)
//   t   = bf16(bf16(qsq[b]) + bf16(raux[s]))
//   d   = bf16(t - 2 * dot)                            (L2; inner product: -dot)
//
// then the n_start smallest d of each row, exact, ascending by (d, column):
// on equal distances the lower column wins.  The bf16 operations of the
// epilogue are the hardware's (add.bf16x2 and fma.bf16x2, each rounded
// once to nearest even), which equal the reference's float32 operation
// rounded to bf16: a sum of two bf16 values computed in float32 and then
// rounded to bf16 is the correctly rounded sum (24 >= 2 * 8 + 2 bits), and
// -2 * dot is exact.  The float32 accumulation order of the product is the
// tensor cores', so a dot may round to the neighbouring bf16 value where
// the library's product rounds the other way: that is the one place K4 and
// the plain version may differ.  The distance order: -0.0 equals +0.0, NaN
// sorts above +inf, all NaNs equal.
//
// What bounds it on this card: operations.  At B=8192, S=65536, dp=128 the
// product is 2 * B * S * dp = 1.37e11 FLOP, 0.139 ms at the dense bf16 peak
// (989 TFLOP/s); the router table (8 MB of int8 codes) stays in the 50 MB
// L2, and the queries and the outputs are a few MB.  What the design does:
//
//   - a block holds 128 queries as bf16 in shared memory (the depth
//     padded with zeros to 128) and walks its split of the router rows in
//     tiles of 64.  Eight product warps each keep their 32 queries' A
//     fragments in registers for the whole walk (dp <= 128; a wider dp
//     reloads them for each 128-deep stage); the products are mma.sync
//     m16n8k16 bf16 with float32 sums, B fragments by ldmatrix, the k-loop
//     of fixed depth and free of branches.  Four selection warps load each
//     stage's int8 codes into registers a stage ahead and convert them to
//     bf16 (exact for |c| <= 127) into a ring of two shared-memory stages
//     ("full" and "empty" named barriers);
//   - the product warps run the epilogue in registers on bf16x2 pairs and
//     write the tile's bf16 distances to one of three [128 x 64]
//     shared-memory tiles.  The selection warps consume them a stage
//     behind (named barriers "full" and "empty" a tile), so the selection
//     of one tile runs beside the product of the next: a first design that
//     had the same warps do both, behind one barrier a tile, took 1.02 ms
//     at the batch shape, 7x its bound;
//   - a selection thread keeps one query row's list over every tile of
//     its split, in ascending column order: a sorted list of (key, column)
//     of NS >= n_start entries in registers.  The chunks of eight whose
//     bf16x2 min lies below the list's last entry are collected first
//     (most tiles have none); in them only the distances below it, found
//     by a bf16x2 compare, reach the list, and an entry beats the last
//     only if its key is strictly less.  (On the benchmark's router a
//     query's nearest rows arrive at random columns all through the walk,
//     so some row of every selection warp keeps finding one; a first
//     selection that keyed all eight distances of every such chunk, one
//     after another, took 1.00 ms there against 0.60 on random tables.)
//   - the grid is query tiles x splits of the router rows, sized from B
//     and S to put about one block on each SM (B=8192: 64 tiles x 2
//     splits; B=1: one tile x 132 splits); each selection thread writes its
//     list to a small candidate buffer, and a second launch merges a row's
//     lists (one warp a row) and maps the columns to router ids.
//
// The [B, S] block never reaches device memory.  PERF.md gives the
// measured time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// 12 warps: 8 product warps (4 along the queries x 2 along the tile's
// router rows) and 4 selection warps (one thread a query row)
constexpr int kMmaThreads = 256;
constexpr int kSelThreads = 128;
constexpr int kThreads = kMmaThreads + kSelThreads;
constexpr int kBQ = 128;        // queries a block
constexpr int kBS = 64;         // router rows a tile
constexpr int kNT = kBS / 16;   // n8 tiles a product warp: its half of a tile's rows
constexpr int kKC = 128;        // a stage's depth, in bf16 elements (dp is padded to it)
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kMaxNS = 32;
constexpr uint32_t kEmptyKey = 0x10000u;   // above every bf16 key
constexpr uint32_t kNaN2 = 0x7fc07fc0u;    // bf16x2 NaN: every compare with it fails
constexpr uint32_t kNeg2 = 0xc000c000u;    // bf16x2 (-2, -2)
constexpr int kDist = 3;        // distance tiles: the selection may fall this far behind
// named barriers (0 is __syncthreads'): a stage of the ring filled, emptied
// (two each); a distance tile filled, emptied (kDist each)
constexpr int kBarStageFull = 1;
constexpr int kBarStageEmpty = 3;
constexpr int kBarDistFull = 5;
constexpr int kBarDistEmpty = kBarDistFull + kDist;

struct Args {
  const float* qs;        // [B, dp]
  const float* qsq;       // [B] (L2 only)
  const int8_t* rc;       // [S, dp]
  const float* raux;      // [S]
  const int* ids;         // [S]
  unsigned long long* cand;   // [B, splits, ns]: key << 32 | column
  int* out;               // [B, n_out]
  long long b;
  int s, dp, dpp, chunk_bits;  // dp rounded up to 128; log2 of the 128-deep stages a tile
  int splits, tiles, n_out, inner_product;
  int stride_a, stride_b, stride_d;   // bytes a row of each shared tile
  int off_b, off_r, off_d;            // byte offsets of the stages, raux, distances
};

// The order of a bf16 distance as a 16-bit key: -0.0 folds into +0.0, NaN
// sorts last, every NaN equal.
__device__ __forceinline__ uint32_t order_key(uint32_t b) {
  if ((b & 0x7f80u) == 0x7f80u && (b & 0x7fu)) return 0xffffu;
  if (b == 0x8000u) b = 0;
  return (b & 0x8000u) ? (~b & 0xffffu) : (b | 0x8000u);
}

// The bf16x2 threshold of a list whose last key is k: every distance not
// below it has a key >= k.  An empty or NaN last entry gives NaN, which
// sends every chunk to the exact test.
__device__ __forceinline__ uint32_t threshold2(uint32_t k) {
  if (k >= 0xff81u) return kNaN2;
  const uint32_t b = (k & 0x8000u) ? (k & 0x7fffu) : (~k & 0xffffu);
  return b | (b << 16);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 int8 codes -> 2 bf16x2 words, exactly: each byte biased by 128 into the
// mantissa of 2^23, the bias taken off in float32, the high halves kept.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float base = 8388736.0f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - base;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - base;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542)) - base;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543)) - base;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A sorted list of NS (key, column) entries, ascending; a new entry goes
// after every entry of an equal key (its column is the larger).
template <int NS>
struct List {
  uint32_t key[NS];
  int col[NS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      key[i] = kEmptyKey;
      col[i] = -1;
    }
  }

  __device__ __forceinline__ void insert(uint32_t k, int c) {
    key[NS - 1] = k;
    col[NS - 1] = c;
#pragma unroll
    for (int i = NS - 1; i > 0; --i) {
      if (key[i] < key[i - 1]) {
        const uint32_t tk = key[i];
        key[i] = key[i - 1];
        key[i - 1] = tk;
        const int tc = col[i];
        col[i] = col[i - 1];
        col[i - 1] = tc;
      }
    }
  }
};

// The int8 codes of one stage (a tile's 64 rows, one 128-deep chunk of
// them: 512 groups of 16 bytes), held in a selection thread's registers
// between their load and their store as bf16.
constexpr int kRawGroups = kBS * kKC / 16 / kSelThreads;   // 4

struct Stage {
  uint4 raw[kRawGroups];
  float raux;
};

__device__ __forceinline__ void load_stage(const Args& a, int h, int row0, int chunk,
                                           Stage& st) {
#pragma unroll
  for (int i = 0; i < kRawGroups; ++i) {
    const int g = h + i * kSelThreads;
    const int k0 = chunk * kKC + (g & 7) * 16;
    const int s = row0 + (g >> 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < a.s && k0 < a.dp) {
      const int8_t* p = a.rc + static_cast<long long>(s) * a.dp + k0;
      if (a.dp % 16 == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {   // dp = 4 or 8: the row's first group holds it whole
        v.x = __ldg(reinterpret_cast<const uint32_t*>(p));
        if (a.dp > 4) v.y = __ldg(reinterpret_cast<const uint32_t*>(p + 4));
      }
    }
    st.raw[i] = v;
  }
  st.raux = (chunk == 0 && h < kBS && row0 + h < a.s) ? __ldg(a.raux + row0 + h) : 0.0f;
}

__device__ __forceinline__ void store_stage(unsigned char* smem, const Args& a, int h,
                                            int buf, int chunk, int raux_buf,
                                            const Stage& st) {
  unsigned char* base = smem + a.off_b + buf * kBS * a.stride_b;
#pragma unroll
  for (int i = 0; i < kRawGroups; ++i) {
    const int g = h + i * kSelThreads;
    uint4 lo, hi;
    i8x4_to_bf16(st.raw[i].x, lo.x, lo.y);
    i8x4_to_bf16(st.raw[i].y, lo.z, lo.w);
    i8x4_to_bf16(st.raw[i].z, hi.x, hi.y);
    i8x4_to_bf16(st.raw[i].w, hi.z, hi.w);
    uint4* dst = reinterpret_cast<uint4*>(base + (g >> 3) * a.stride_b + (g & 7) * 32);
    dst[0] = lo;
    dst[1] = hi;
  }
  if (chunk == 0 && h < kBS) {
    reinterpret_cast<__nv_bfloat16*>(smem + a.off_r)[raux_buf * kBS + h] =
        __float2bfloat16_rn(st.raux);
  }
}

// One product warp's A fragments for the 128-deep chunk `chunk` of the
// query tile: [m-tile][k-step][4], from the bf16 query tile by ldmatrix.
__device__ __forceinline__ void load_a(const Args& a, const unsigned char* smem, int wm,
                                       int chunk, uint32_t (&af)[2][8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int row = wm * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int k = chunk * kKC + ks * 16 + 8 * (lane >> 4);
      ldsm_x4(smem_addr(smem + row * a.stride_a + k * 2), af[mt][ks][0], af[mt][ks][1],
              af[mt][ks][2], af[mt][ks][3]);
    }
  }
}

// The product warps: each stage's products into registers once the
// selection warps have filled it ("stage full"), and at a tile's last
// chunk the epilogue into distance tile t % kDist once tile t - kDist has
// been selected ("distance empty"), then "distance full"; the stage is
// handed back ("stage empty") after both.
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem, int n_tiles,
                                        long long q0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;      // the warp's 32 queries
  const int wn = warp >> 2;     // the warp's half of the tile's rows
  const int g = lane >> 2, t4 = lane & 3;
  const int units = n_tiles << a.chunk_bits;

  // bf16(qsq) of the thread's four epilogue rows, twice in a word
  uint32_t qq[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = q0 + wm * 32 + mt * 16 + g + 8 * h;
      const float v = (!a.inner_product && r < a.b) ? __ldg(a.qsq + r) : 0.0f;
      qq[mt][h] = as_u32(__float2bfloat162_rn(v));
    }
  }
  uint32_t af[2][8][4];
  if (a.chunk_bits == 0) load_a(a, smem, wm, 0, af);
  float acc[2][kNT][4];
  for (int u = 0; u < units; ++u) {
    const int t = u >> a.chunk_bits;
    const int c = u & ((1 << a.chunk_bits) - 1);
    if (a.chunk_bits) load_a(a, smem, wm, c, af);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    bar_sync(kBarStageFull + (u & 1), kThreads);
    const unsigned char* bstage = smem + a.off_b + (u & 1) * kBS * a.stride_b;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t bf[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int n = wn * (kBS / 2) + np * 16 + (lane & 7) + 8 * (lane >> 4);
        const int k = ks * 16 + 8 * ((lane >> 3) & 1);
        ldsm_x4(smem_addr(bstage + n * a.stride_b + k * 2), bf[2 * np][0], bf[2 * np][1],
                bf[2 * np + 1][0], bf[2 * np + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt][ks], bf[nt][0], bf[nt][1]);
    }
    if (c == (1 << a.chunk_bits) - 1) {
      const int b = t % kDist;
      if (t >= kDist) bar_sync(kBarDistEmpty + b, kThreads);   // tile t - kDist selected
      const __nv_bfloat16* rx =
          reinterpret_cast<const __nv_bfloat16*>(smem + a.off_r) + (t & 1) * kBS;
      unsigned char* dt = smem + a.off_d + b * kBQ * a.stride_d;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wn * (kBS / 2) + nt * 8 + 2 * t4;
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(rx + col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 dot =
                __float22bfloat162_rn(make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
            __nv_bfloat162 d;
            if (a.inner_product) {
              d = __hneg2(dot);
            } else {
              const __nv_bfloat162 tt = __hadd2(as_bf2(qq[mt][h]), as_bf2(r2));
              d = __hfma2(as_bf2(kNeg2), dot, tt);
            }
            const int row = wm * 32 + mt * 16 + g + 8 * h;
            *reinterpret_cast<uint32_t*>(dt + row * a.stride_d + col * 2) = as_u32(d);
          }
        }
      }
      bar_arrive(kBarDistFull + b, kThreads);
    }
    if (u + 2 < units) bar_arrive(kBarStageEmpty + (u & 1), kThreads);
  }
}

// One selection thread's scan of distance tile t for query row `row`: the
// chunks of eight that hold a distance below the list's last entry first
// (most tiles hold none), then in each of them only those distances, in
// ascending column order.
template <int NS>
__device__ __forceinline__ void select_tile(const Args& a, const unsigned char* dtile, int row,
                                            int c0, List<NS>& list, uint32_t& thr2) {
  const unsigned char* p = dtile + row * a.stride_d;
  unsigned slow = 0u;
#pragma unroll
  for (int ch = 0; ch < kBS / 8; ++ch) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + ch * 16);
    const __nv_bfloat162 mc = __hmin2(__hmin2(as_bf2(v.x), as_bf2(v.y)),
                                      __hmin2(as_bf2(v.z), as_bf2(v.w)));
    if (!__hbge2(mc, as_bf2(thr2))) slow |= 1u << ch;
  }
  if (c0 + kBS > a.s) {   // the ragged last tile: its partial chunk in, none past S
    const int valid = a.s - c0;
    if (valid & 7) slow |= 1u << (valid >> 3);
    slow &= (1u << ((valid + 7) >> 3)) - 1u;
  }
  while (slow) {
    const int ch = __ffs(slow) - 1;
    slow &= slow - 1u;
    const int col = c0 + ch * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(p + ch * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    // the distances below the list's last entry: every one while the list
    // has a free slot (or a NaN last entry), else by a bf16x2 compare
    // (false for NaN, -0.0 equal to +0.0: the keys' order)
    unsigned mask = 0xffu;
    if (thr2 != kNaN2) {
      mask = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t r = as_u32(__hlt2(as_bf2(w[q]), as_bf2(thr2)));   // 1.0: 0x3f80
        mask |= (((r >> 7) & 1u) | ((r >> 22) & 2u)) << (2 * q);
      }
    }
    if (col + 8 > a.s) mask &= (1u << (a.s - col)) - 1u;
    const unsigned long long lo = (static_cast<unsigned long long>(w[1]) << 32) | w[0];
    const unsigned long long hi = (static_cast<unsigned long long>(w[3]) << 32) | w[2];
    while (mask) {
      const int e = __ffs(mask) - 1;
      mask &= mask - 1u;
      const uint32_t bits =
          static_cast<uint32_t>((e < 4 ? lo >> (16 * e) : hi >> (16 * (e - 4))) & 0xffffu);
      const uint32_t k = order_key(bits);
      if (k < list.key[NS - 1]) list.insert(k, col + e);
    }
    thr2 = threshold2(list.key[NS - 1]);
  }
}

// The selection warps: they fill the stage ring (each stage's int8 codes
// loaded a stage ahead into registers, converted to bf16 once the
// product warps have emptied it) and, one stage behind, select: thread r
// keeps query row r's list over every tile of the split.
template <int NS>
__device__ __forceinline__ void select(const Args& a, unsigned char* smem, int split,
                                       int t_begin, int n_tiles, long long q0) {
  const int h = threadIdx.x - kMmaThreads;   // also the query row
  const bool live = q0 + h < a.b;
  const int units = n_tiles << a.chunk_bits;
  const int last = (1 << a.chunk_bits) - 1;
  List<NS> list;
  list.clear();
  uint32_t thr2 = kNaN2;
  Stage st;
  load_stage(a, h, t_begin * kBS, 0, st);
  for (int u = 0; u <= units; ++u) {
    if (u < units) {
      if (u >= 2) bar_sync(kBarStageEmpty + (u & 1), kThreads);
      store_stage(smem, a, h, u & 1, u & last, (u >> a.chunk_bits) & 1, st);
      bar_arrive(kBarStageFull + (u & 1), kThreads);
      if (u + 1 < units) {
        load_stage(a, h, (t_begin + ((u + 1) >> a.chunk_bits)) * kBS, (u + 1) & last, st);
      }
    }
    // the tile whose last stage was u - 1
    if (u >= 1 && ((u - 1) & last) == last) {
      const int t = (u - 1) >> a.chunk_bits;
      const int b = t % kDist;
      bar_sync(kBarDistFull + b, kThreads);
      if (live) {
        select_tile<NS>(a, smem + a.off_d + b * kBQ * a.stride_d, h, (t_begin + t) * kBS,
                        list, thr2);
      }
      if (t + kDist < n_tiles) bar_arrive(kBarDistEmpty + b, kThreads);
    }
  }
  if (live) {
    unsigned long long* out = a.cand + ((q0 + h) * a.splits + split) * NS;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      out[i] = (static_cast<unsigned long long>(list.key[i]) << 32) |
               static_cast<uint32_t>(list.col[i]);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1) router_topk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.y) * kBQ;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * a.tiles / a.splits);
  const int t_end = static_cast<int>(static_cast<long long>(split + 1) * a.tiles / a.splits);
  const int n_tiles = t_end - t_begin;

  // the query tile as bf16, zero past B and past dp
  {
    const int pairs = a.dpp / 2;
    for (int i = tid; i < kBQ * pairs; i += kThreads) {
      const int r = i / pairs;
      const int k = (i - r * pairs) * 2;
      float2 v = make_float2(0.0f, 0.0f);
      if (q0 + r < a.b && k < a.dp) {
        v = *reinterpret_cast<const float2*>(a.qs + (q0 + r) * a.dp + k);
      }
      *reinterpret_cast<__nv_bfloat162*>(smem + r * a.stride_a + k * 2) =
          __float22bfloat162_rn(v);
    }
  }
  __syncthreads();
  if (tid < kMmaThreads) {
    produce(a, smem, n_tiles, q0);
  } else {
    select<NS>(a, smem, split, t_begin, n_tiles, q0);
  }
}

// One warp a query row: the n_out smallest of its splits' candidate lists
// by (key, column), mapped to router ids.
template <int NS>
__global__ void __launch_bounds__(128) router_merge_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= a.b) return;
  const int total = a.splits * NS;
  const unsigned long long* c = a.cand + row * total;
  unsigned long long l[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) l[i] = ~0ull;
  for (int j = lane; j < total; j += 32) {
    const unsigned long long v = c[j];
    if (v < l[NS - 1]) {
      l[NS - 1] = v;
#pragma unroll
      for (int i = NS - 1; i > 0; --i) {
        if (l[i] < l[i - 1]) {
          const unsigned long long x = l[i];
          l[i] = l[i - 1];
          l[i - 1] = x;
        }
      }
    }
  }
  for (int o = 0; o < a.n_out; ++o) {
    unsigned long long m = l[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xffffffffu, m, off);
      m = y < m ? y : m;
    }
    const unsigned win = __ballot_sync(0xffffffffu, l[0] == m);
    if (lane == __ffs(win) - 1) {
#pragma unroll
      for (int i = 0; i < NS - 1; ++i) l[i] = l[i + 1];
      l[NS - 1] = ~0ull;
    }
    if (lane == 0) {
      const int col = static_cast<int>(static_cast<uint32_t>(m));
      a.out[row * a.n_out + o] = (col >= 0 && col < a.s) ? a.ids[col] : -1;
    }
  }
}

template <int NS>
cudaError_t launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(router_topk_kernel<NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
  }
  const long long qtiles = (a.b + kBQ - 1) / kBQ;
  router_topk_kernel<NS><<<dim3(a.splits, static_cast<unsigned>(qtiles)), kThreads,
                           smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  router_merge_kernel<NS><<<static_cast<unsigned>((a.b + 3) / 4), 128, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The bf16 router for `b` queries over `s` router rows (see the note
// above; the wrapper `router_topk` checks every tensor): qs [b, dp] and
// qsq [b] float32 (qsq unread for inner product), rc [s, dp] int8, raux [s]
// float32, ids [s] int32; cand [b, splits, ns] uint64 scratch; out
// [b, n_out] int32.  ns (4, 8, 16 or 32 list entries, >= n_out), splits
// and smem_bytes come from the wrapper's plan; a plan the kernel does not
// hold is refused.  Returns a cudaError_t: the shared-memory attribute's,
// else the launches'.
extern "C" int router_topk_launch(const void* qs, const void* qsq, const void* rc,
                                  const void* raux, const void* ids, void* cand, void* out,
                                  long long b, int s, int dp, int n_out, int inner_product,
                                  int ns, int splits, int smem_bytes, void* stream) {
  if (b == 0) return 0;
  const long long qtiles = (b + kBQ - 1) / kBQ;
  if (b < 0 || qtiles > 65535 || s < 1 || dp < 4 || dp > 512 || dp % 4 != 0 ||
      128 % (dp / 4) != 0 ||
      n_out < 1 || n_out > ns || n_out > s || ns > kMaxNS ||
      splits < 1 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.qs = static_cast<const float*>(qs);
  a.qsq = static_cast<const float*>(qsq);
  a.rc = static_cast<const int8_t*>(rc);
  a.raux = static_cast<const float*>(raux);
  a.ids = static_cast<const int*>(ids);
  a.cand = static_cast<unsigned long long*>(cand);
  a.out = static_cast<int*>(out);
  a.b = b;
  a.s = s;
  a.dp = dp;
  a.dpp = (dp + kKC - 1) / kKC * kKC;
  a.chunk_bits = a.dpp == 128 ? 0 : a.dpp == 256 ? 1 : 2;
  a.tiles = (s + kBS - 1) / kBS;
  a.splits = splits;
  a.n_out = n_out;
  a.inner_product = inner_product;
  a.stride_a = a.dpp * 2 + 16;
  a.stride_b = kKC * 2 + 16;
  a.stride_d = kBS * 2 + 16;
  a.off_b = kBQ * a.stride_a;
  a.off_r = a.off_b + 2 * kBS * a.stride_b;
  a.off_d = a.off_r + 2 * kBS * 2;   // a multiple of 16
  const int need = a.off_d + kDist * kBQ * a.stride_d;
  if (splits > a.tiles || need > smem_bytes || smem_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ns) {
    case 4: err = launch<4>(a, smem_bytes, st); break;
    case 8: err = launch<8>(a, smem_bytes, st); break;
    case 16: err = launch<16>(a, smem_bytes, st); break;
    case 32: err = launch<32>(a, smem_bytes, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
