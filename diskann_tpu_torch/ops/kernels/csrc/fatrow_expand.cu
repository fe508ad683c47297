// Fused fat-row expand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel diskann_tpu/ops/kernels/fatrow_expand.py
// (function `fatrow_expand`, body `_kernel`).  For each beam slot s it reads
// the fat row of node beam[s] (clamped to the table) from the int32 word
// table rows[(cap+1)*nwr, 128] (layout: graph/packed.py), copies the id
// section and the aux section out raw, and takes the int32 dot of each of
// the neighbours' int8 codes with the slot's int8 query.  Dots are written
// in neighbour-slot order: no lane-block interleave as on the TPU.
//
// What bounds it on this card: bytes.  A slot reads the prefix of its fat
// row, (2*idw + codr) * 512 bytes (11,776 B at r_pack=84 / dp=128, 6,656 B
// at 88 / 64, 3,072 B at 64 / 32, 1,536 B at r_pack=16 for dp <= 32), one
// __dp4a per 4 bytes, and writes 2*idw*512 bytes of ids and aux and its
// dots.  The rows are scattered over a multi-GB table, so nothing is reused
// from L2 and the kernel can at best stream at device-memory bandwidth
// (3.35 TB/s, ~25 GB/s an SM; Little's law at ~0.8 us asks ~20 KB in flight
// on every SM, all the time).
//
// Why the first design fell short of that: one 4-warp block per slot, each
// warp loading one 512-byte row per loop iteration with no prefetch.  At
// most 16 such blocks fit an SM, 32 KB in flight, and none while a block
// waits on its dependent load of beam[s]; a slot of 6 code rows (dp=32) or
// 13 (dp=64) amortises that wait poorly, and at r_pack=16 three of the four
// warps had no code row.
//
// This design: persistent blocks, one a SM (the wrapper's `plan`), walk
// groups of `sps` consecutive slots; a prefix under ~8 KB shares a stage
// with others (2 slots at dp=32, 5 at r_pack=16), so the fixed cost of a
// stage is amortised.  Each warp owns `depth` stages of a ring in dynamic
// shared memory and both fills and drains them: its lanes prefetch the beam
// ids of its next 32 / sps groups a batch ahead and clamp them, then per
// group lane 0 arms the stage's mbarrier with the bytes to expect and each
// slot's whole prefix comes by one bulk async copy (cp.async.bulk ...
// mbarrier::complete_tx::bytes), the queries by one more (cp.async for the
// 4- and 8-byte queries of dp = 4 and 8).  No thread spends registers on the
// rows, and the padding rows up to nwr are not read.  The warp waits on the
// stage's barrier, copies ids and aux out as coalesced int4 stores, scores
// the code rows into the stage's dots area, refills the stage with its
// group `depth` ahead, and stores the dots coalesced.  The ring is ~128 KB
// a block: 12 stages of one slot (138 KB) at dp=128, 24 (156 KB) at dp=64,
// 24 of two slots (144 KB) at dp=32, 12-24 of five slots (90-180 KB) at
// r_pack=16, 6-7 (132-147 KB) at dp=256 / 512; so each SM keeps several
// times Little's 20 KB in flight.  Stages start on 128-byte boundaries: bulk
// copies into stages aligned to 16 bytes only ran measurably slower.
// Each warp issues its own copies: one producer warp feeding the others
// through full and empty barriers serialises every copy's issue on that
// warp and falls behind at every width, and with no hand-off between warps
// the full barriers alone suffice.
//
// Two lane maps score a 512-byte code row (dp/4 divides 128):
//  - dp >= 16 (DPW = dp/4 >= 4 words per code): each lane holds 4 words of
//    one code and the matching 4 query words and does 4 __dp4a; kG = DPW/4
//    lanes share a code.  kG rows are scored at once and summed by a
//    butterfly (kG - 1 independent shuffles for kG rows where a shuffle tree
//    per row takes log2(kG) dependent ones: the tree made the scoring, not
//    the bytes, bound a warp's stage at dp >= 128);
//  - dp = 4 or 8 (DPW = 1 or 2): one lane's 4 words hold 4 or 2 whole
//    codes, so each __dp4a (or pair) is one neighbour's dot, with no
//    shuffle; the query word(s) are the same for every code of the row.
// Row offsets are 64-bit: the dp=128 table at 1M rows holds ~3.1e9 words.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;        // 227 KB: a block's most on sm_90
constexpr int kMaxWarps = 16;           // 512 threads
constexpr int kMaxSlotsPerStage = 32;   // one lane per slot
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr long long round16(long long x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The barrier's current phase also waits for this thread's earlier cp.async
// copies: its pending count rises by one now and falls when they land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

template <int N>  // bytes: 4 or 8, aligned to N on both sides
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

// One bulk async copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Sum kG lanes' partial dots of kG rows: at step kOff each lane keeps the
// half of its rows on its side of bit kOff and adds its partner's part of
// them, so lane l ends with acc[0] = row (l % kG)'s whole dot.
template <int kG, int kOff>
__device__ __forceinline__ void butterfly(int (&acc)[kG], int lane) {
  if constexpr (kOff > 0) {
    const bool upper = lane & kOff;
#pragma unroll
    for (int u = 0; u < kOff; ++u) {
      const int keep = upper ? acc[u + kOff] : acc[u];
      const int give = upper ? acc[u] : acc[u + kOff];
      acc[u] = keep + __shfl_xor_sync(0xffffffffu, give, kOff);
    }
    butterfly<kG, kOff / 2>(acc, lane);
  }
}

// Order this thread's earlier generic-proxy accesses to shared memory
// before its later async-proxy ones (the next bulk copy into a stage read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

struct Args {
  const char* rows;
  const int* beam;
  const signed char* qiw;
  int4* ids;
  int4* aux;
  int* dots;
  long long n_nodes, bw;
  int idw, codr, nwr;
  int sps, stages, warps, stride;
};

template <int DPW>  // int32 words per code = dp / 4
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
fatrow_expand_kernel(const Args a) {
  constexpr int kCpr = 128 / DPW;             // codes per 128-word row
  extern __shared__ __align__(128) unsigned char smem[];

  const int prefix = (2 * a.idw + a.codr) * 512;   // bytes a slot reads
  const int p16 = prefix / 16;
  const int sec = a.idw * 32;                      // int4 per id (= aux) section
  const int width = a.codr * kCpr;                 // dots per slot
  const int qoff = a.sps * prefix;                 // the stage's queries
  const int doff = qoff + static_cast<int>(round16(a.sps * DPW * 4));  // its dots
  const int depth = a.stages / a.warps;            // stages a warp owns
  const long long n_groups = (a.bw + a.sps - 1) / a.sps;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * a.stride);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int k = 0; k < a.stages; ++k) mbar_init(full + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // This warp's i-th group of slots is first + i * step, in its stage
  // warp * depth + i % depth.
  const long long first = blockIdx.x + static_cast<long long>(warp) * gridDim.x;
  const long long step = static_cast<long long>(a.warps) * gridDim.x;
  const int mine = first < n_groups ? static_cast<int>((n_groups - first + step - 1) / step) : 0;

  // Beam ids come a batch of gpb groups at a time, one batch ahead: lane l
  // holds (clamped) the node of slot l % sps of the batch's group l / sps.
  const int gpb = 32 / a.sps;
  auto load_batch = [&](int i0) -> long long {
    const int i = i0 + lane / a.sps;
    const long long s = (first + i * step) * a.sps + lane % a.sps;
    if (lane >= gpb * a.sps || i >= mine || s >= a.bw) return 0;
    const long long node = __ldg(a.beam + s);
    return node < 0 ? 0 : (node >= a.n_nodes ? a.n_nodes - 1 : node);
  };
  int batch = 0;
  long long cur = load_batch(0);
  long long nxt = load_batch(gpb);

  // Start group i's copies into stage `stage`: each slot's prefix by one
  // bulk copy, the queries by one more (by cp.async at dp = 4 or 8), all
  // completing on the stage's barrier.
  auto issue = [&](int i, int stage) {
    while (i >= batch + gpb) {
      batch += gpb;
      cur = nxt;
      nxt = load_batch(batch + gpb);
    }
    const long long node =
        __shfl_sync(0xffffffffu, cur, ((i - batch) * a.sps + lane) & 31);
    const long long s0 = (first + i * step) * a.sps;
    const int ns = static_cast<int>(a.bw - s0 < a.sps ? a.bw - s0 : a.sps);
    unsigned char* st = smem + stage * a.stride;
    const signed char* qsrc = a.qiw + s0 * (4 * DPW);
    if constexpr (DPW >= 4) {
      // the group's queries, ns * dp contiguous bytes, by one more bulk copy
      if (lane == 0) {
        mbar_arrive_expect_tx(full + stage, ns * (prefix + 4 * DPW));
        bulk_copy(st + qoff, qsrc, ns * 4 * DPW, full + stage);
      }
    } else {
      // 4 or 8 bytes a query: by cp.async, which the barrier also awaits
      for (int c = lane; c < ns; c += 32) cp_async<4 * DPW>(st + qoff + c * 4 * DPW, qsrc + c * 4 * DPW);
      cp_async_arrive(full + stage);
      __syncwarp();
      if (lane == 0) mbar_arrive_expect_tx(full + stage, ns * prefix);
    }
    __syncwarp();
    if (lane < ns) {
      bulk_copy(st + lane * prefix, a.rows + node * a.nwr * 512LL, prefix, full + stage);
    }
  };

  for (int i = 0; i < depth && i < mine; ++i) issue(i, warp * depth + i);
  int pos = 0;         // group i sits in stage warp * depth + pos ...
  uint32_t phase = 0;  // ... in round i / depth, of this parity
  for (int i = 0; i < mine; ++i) {
    const long long s0 = (first + i * step) * a.sps;
    const int ns = static_cast<int>(a.bw - s0 < a.sps ? a.bw - s0 : a.sps);
    const int stage = warp * depth + pos;
    // the warp issued this round of the stage after it consumed the round
    // before, so a parity wait never meets a barrier two phases behind
    mbar_wait(full + stage, phase);
    unsigned char* st = smem + stage * a.stride;
    const int4* pre = reinterpret_cast<const int4*>(st);
    int* dsm = reinterpret_cast<int*>(st + doff);

    // ids and aux: 512 contiguous bytes per store instruction
    for (int j = 0; j < ns; ++j) {
      int4* ids = a.ids + (s0 + j) * sec;
      int4* aux = a.aux + (s0 + j) * sec;
      for (int k = lane; k < sec; k += 32) {
        ids[k] = pre[j * p16 + k];
        aux[k] = pre[j * p16 + sec + k];
      }
    }

    // code rows, scored into the stage's dots area
    for (int j = 0; j < ns; ++j) {
      const int4* code = pre + j * p16 + 2 * sec;
      const unsigned char* q = st + qoff + j * 4 * DPW;
      int* dj = dsm + j * width;
      if constexpr (DPW >= 4) {
        // lane l covers row words [4l, 4l+4): code l / kG of the row, code
        // words [4(l % kG), 4(l % kG) + 4) -- the same query words for every
        // row.  kG rows at a time: each lane takes its kG partial dots,
        // then a butterfly over the kG lanes of a code halves the rows at
        // every step (kG - 1 shuffles for kG rows, all independent), and
        // leaves lane l the whole dot of row l % kG of the batch
        constexpr int kG = DPW / 4;  // lanes per code (4 words per lane)
        constexpr int kUnroll = kG == 1 ? 4 : 1;
        const int4 qv = reinterpret_cast<const int4*>(q)[lane % kG];
#pragma unroll kUnroll
        for (int r0 = 0; r0 < a.codr; r0 += kG) {
          int acc[kG];
#pragma unroll
          for (int u = 0; u < kG; ++u) {
            const int4 w = r0 + u < a.codr ? code[(r0 + u) * 32 + lane] : make_int4(0, 0, 0, 0);
            acc[u] = __dp4a(w.w, qv.w, __dp4a(w.z, qv.z, __dp4a(w.y, qv.y, __dp4a(w.x, qv.x, 0))));
          }
          butterfly<kG, kG / 2>(acc, lane);
          const int r = r0 + lane % kG;
          if (r < a.codr) dj[r * kCpr + lane / kG] = acc[0];
        }
      } else {
        // lane l covers row words [4l, 4l+4) = codes [4l/DPW, 4(l+1)/DPW)
        const int* qw = reinterpret_cast<const int*>(q);
        const int q0 = qw[0];
        const int q1 = DPW == 2 ? qw[1] : 0;
#pragma unroll 4
        for (int r = 0; r < a.codr; ++r) {
          const int4 w = code[r * 32 + lane];
          if constexpr (DPW == 1) {
            *reinterpret_cast<int4*>(dj + r * kCpr + 4 * lane) =
                make_int4(__dp4a(w.x, q0, 0), __dp4a(w.y, q0, 0),
                          __dp4a(w.z, q0, 0), __dp4a(w.w, q0, 0));
          } else {
            *reinterpret_cast<int2*>(dj + r * kCpr + 2 * lane) =
                make_int2(__dp4a(w.y, q1, __dp4a(w.x, q0, 0)),
                          __dp4a(w.w, q1, __dp4a(w.z, q0, 0)));
          }
        }
      }
    }
    __syncwarp();
    // the prefix and the queries are read: refill the stage (the copies leave
    // its dots area alone), then store the dots
    if (i + depth < mine) {
      fence_proxy_async();
      issue(i + depth, stage);
    }

    // the group's dots are contiguous in the output: coalesced stores
    const int nd = ns * width;
    if (width % 4 == 0) {
      int4* dst = reinterpret_cast<int4*>(a.dots + s0 * width);
      const int4* src = reinterpret_cast<const int4*>(dsm);
      for (int k = lane; k < nd / 4; k += 32) dst[k] = src[k];
    } else {
      int* dst = a.dots + s0 * width;
      for (int k = lane; k < nd; k += 32) dst[k] = dsm[k];
    }
    __syncwarp();
    if (++pos == depth) {
      pos = 0;
      phase ^= 1;
    }
  }
}

template <int DPW>
int launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  // the most dynamic shared memory the kernel may take, set once a device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(fatrow_expand_kernel<DPW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_relaxed);
  }
  fatrow_expand_kernel<DPW><<<grid, 32 * a.warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: [n_nodes * nwr, 128] int32, beam: [bw] int32, qiw: [bw, dp] int8;
// outputs ids/aux [bw, idw*128] int32 and dots [bw, codr*(128/(dp/4))]
// int32.  dp must be 4, 8, 16, 32, 64, 128, 256 or 512: every dp with
// 128 % (dp/4) == 0, as in the reference.  The plan (the wrapper's `plan`):
// slots a stage, stages, warps a block (they divide the stages), blocks,
// the stage stride and the dynamic shared memory in bytes; a plan that does
// not hold the stage it describes, or exceeds 227 KB, is refused.  Returns a cudaError_t: the
// shared-memory attribute's, else the launch's.
extern "C" int fatrow_expand_launch(const void* rows, long long n_nodes,
                                    const void* beam, const void* qiw,
                                    long long bw, int rp, int dp,
                                    int slots_per_stage, int stages,
                                    int warps, int grid,
                                    int stage_stride, int smem_bytes, void* ids,
                                    void* aux, void* dots, void* stream) {
  const int dpw = dp / 4;
  Args a;
  a.rows = static_cast<const char*>(rows);
  a.beam = static_cast<const int*>(beam);
  a.qiw = static_cast<const signed char*>(qiw);
  a.ids = static_cast<int4*>(ids);
  a.aux = static_cast<int4*>(aux);
  a.dots = static_cast<int*>(dots);
  a.n_nodes = n_nodes;
  a.bw = bw;
  a.idw = (rp + 127) / 128;
  a.codr = (rp * dpw + 127) / 128;
  a.nwr = (2 * a.idw + a.codr + 7) / 8 * 8;
  a.sps = slots_per_stage;
  a.stages = stages;
  a.warps = warps;
  a.stride = stage_stride;
  if (bw == 0) return 0;
  if (dp % 4 != 0 || dpw < 1 || 128 % dpw != 0 || n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long prefix = (2LL * a.idw + a.codr) * 512;
  const long long width = static_cast<long long>(a.codr) * (128 / dpw);
  const long long need = a.sps * prefix + round16(1LL * a.sps * dp) + round16(a.sps * width * 4);
  if (a.sps < 1 || a.sps > kMaxSlotsPerStage || stages < 1 || warps < 1 ||
      warps > kMaxWarps || stages % warps != 0 || grid < 1 ||
      stage_stride % 128 != 0 ||
      stage_stride < need || smem_bytes > kMaxSmem ||
      smem_bytes < 1LL * stages * stage_stride + 8LL * stages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dpw) {
    case 1: return launch<1>(a, grid, smem_bytes, st);
    case 2: return launch<2>(a, grid, smem_bytes, st);
    case 4: return launch<4>(a, grid, smem_bytes, st);
    case 8: return launch<8>(a, grid, smem_bytes, st);
    case 16: return launch<16>(a, grid, smem_bytes, st);
    case 32: return launch<32>(a, grid, smem_bytes, st);
    case 64: return launch<64>(a, grid, smem_bytes, st);
    case 128: return launch<128>(a, grid, smem_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* diskann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
