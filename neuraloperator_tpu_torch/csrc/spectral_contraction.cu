// Per-mode complex channel contractions of the spectral convolution: the
// forward (K1) and the two halves of its backward (K2, K3).
//
//   K1  out[b, o, m] = sum_i x[b, i, m] * w[i, o, m]
//   K2   dx[b, i, m] = sum_o g[b, o, m] * conj(w[i, o, m])
//   K3   dw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]
//
// (complex, split re/im). They replace the TPU kernel `_kernel` driven by
// `_mode_contraction` in neuraloperator_tpu/ops/pallas/spectral_contraction.py
// with the dimension numbers `_FWD` (K1), `_BWD_X` with conj_b (K2) and
// `_BWD_W` with conj_a (K3); `_pallas_bwd` runs K2 and K3 for every
// spectral layer's backward.
//
// What bounds them: bytes. Each touches one weight-sized array (K1 and K2
// read w, K3 writes dw), and a weight element serves only the B batch rows
// of its own mode, so they do 8 B flops per complex weight element (B / 1
// flop per byte in f32). The flagship layer (I = O = 64, M = 64 * 33 = 2112
// modes) in f32 moves 69.2 MB of weight plus 2 * B * 1.08 MB of the
// batch-sized operand and result: 86.5 MB at B = 8, 25.8 us at 3.35 TB/s;
// 103.8 MB at B = 16, 31.0 us; 71.3 MB at B = 1, 21.3 us. The flops
// (1.1 GFLOP at B = 16) take 16.5 us at the 67 TFLOP/s of plain f32: under
// the byte time, but not by enough to be ignored.
//
// Common to all three:
// * Natural layout. x and g are (B, I, M) and (B, O, M), w and dw the
//   stored (I, O, M) pair, modes fastest, so no transpose pass runs before
//   or after a kernel. (The TPU kernel moved the mode axis to the front
//   because Mosaic's batched dot needs the batch dims first.)
// * Each block owns a tile of consecutive modes and stages the slices of
//   its operands there in shared memory.
// * Four-product complex multiply (4 FMAs per multiply-add) on the CUDA
//   cores in f32, not Karatsuba and not TF32: the kernels are memory-bound,
//   so the saved multiply buys nothing, while Karatsuba costs extra adds and
//   the cancellation in t3 - t1 - t2. Each output is summed in one thread
//   in a fixed order, so two launches on the same inputs agree bit for bit.
// * Operands are f32 or bf16 (__nv_bfloat16, staged as they are and widened
//   exactly with __bfloat162float as they are read); outputs are f32.
// * Persistent grids, sized from the queried SM count and occupancy
//   (`block_occupancy`, cached per kernel and device).
// * Two load paths, a template flag of each kernel: aligned (every plane's
//   base and the row stride M * sizeof(T) multiples of 16 bytes, as at the
//   flagship's M = 2112), where the copies into shared memory are
//   asynchronous (TMA tensor loads for K1/K2, 16-byte cp.async.cg copies
//   for K3) and stores are 16-byte vectors; and element loads and stores
//   masked at M for any other M (77, 100, ...).
// * The ragged mode tile and the channel and batch tails are staged as
//   zeros and never stored. The kernels launch on the caller's stream and
//   allocate nothing; the caller allocates the outputs.
//
// The sections below hold the shared helpers, K1/K2
// (`channel_contraction_kernel`) and K3 (`weight_grad_kernel`), each with
// its own note.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of a block, all kernels (8 warps)
constexpr int kQuad = 4;       // consecutive modes per thread
// The dynamic shared memory a kernel may be given: all of a block's 227 KB.
constexpr int kMaxSmemBytes = 227 * 1024;

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Four consecutive values from shared memory, widened to f32.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The current device's SM count and the blocks of one kernel variant an SM
// holds at smem bytes of dynamic shared memory, queried on first use and
// kept, so that a launch makes no device queries.
int block_occupancy(const void* kernel, int smem, int* sms, int* per_sm) {
  struct Seen {
    const void* kernel;
    int device, smem, sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& e : seen) {
    if (e.kernel == kernel && e.device == dev && e.smem == smem) {
      *sms = e.sms;
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  seen.push_back({kernel, dev, smem, *sms, *per_sm});
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------------------------ K1, K2
//
// out[b, n, m] = sum_k a[b, k, m] * w(k, n, m), where w's element (k, n, m)
// sits at k * w_sk + n * w_sn + m and is conjugated when CONJ. K1 is
// a = x, (k, n) = (i, o), w_sk = O * M, w_sn = M; K2 is a = g,
// (k, n) = (o, i), w_sk = M, w_sn = O * M, CONJ. A weight row along m is
// contiguous in both, so one ring and one schedule serve both.
//
// What bounds them: bytes, as for K3 (the head note): at the flagship's
// widths in f32 21.3 us at B = 1, 25.8 us at B = 8 and 31.0 us at B = 16
// over 3.35 TB/s. The FMAs (16.5 us at B = 16) have to overlap the stream.
//
// What held the earlier design back (one thread per mode, the batch tile of
// at most 8 rows on grid.z, loads issued 4 channels ahead into registers:
// 49.6 us at f32 B = 8 and 93.9 us at B = 16 on an H100), and what this
// one does about each:
// 1. Above B = 8 the weight was read once per batch tile, the second read
//    mostly from device memory (the weight, 69.2 MB in f32, is over the
//    50 MB L2). Here a block serves every batch row up to kCcMaxRows = 16
//    of its unit from one read of the unit's weight (the batch tile is 1,
//    8 or 16 rows by B). Past 16 rows the batch tiles of one mode range are
//    consecutive units, which neighbouring blocks run at the same time, so
//    the weight's repeated reads hit L2.
// 2. One block of 8 warps per SM loaded in bursts: a warp had no bytes in
//    flight while it spent its loads on FMAs. Here the unit's operands
//    stream through a ring of kCcStages shared-memory stages, each holding
//    one chunk of kCcChunk contracted channels: the weight's box of
//    kCcModes modes x kCcOut channels x kCcChunk and the batch operand's
//    box of kCcModes x kCcChunk x the tile's rows, real and imaginary
//    planes apart. One thread starts the chunk's four TMA tensor loads,
//    which report to the stage's mbarrier; the loads of the next
//    kCcStages - 1 chunks are in flight while a chunk is summed, and one
//    barrier per chunk hands its stage back. The ring runs on across
//    units, so it drains once per block, not once per unit. (16-byte
//    cp.async copies issued by every thread were tried first: a warp
//    waited at its copies for the memory system and summed nothing
//    meanwhile, so copying and summing took turns.) The weight's loads
//    are marked evict-first in L2: it is read once and is larger than L2,
//    and left unmarked it pushed out the lines the other operands and the
//    outputs were using.
// 3. Loads moved 4 bytes a thread. Here the TMA unit moves whole boxes and
//    zero-fills what lies past M, N, K or B; a thread reads its operands
//    from shared memory as 4-mode vectors.
// 4. The batch operand was re-read through L1/L2 by the blocks of every
//    channel group. Here it is staged once per unit and read from shared
//    memory as broadcasts: the lanes of a warp that differ in channel read
//    the same batch row.
// What is left: the stream alone (the sums switched off) reads near what
// one torch.sum over the same bytes reaches on the card
// (scripts/ab_spectral_contraction.py prints that yardstick); at B = 16
// the FMAs and their shared-memory reads take about as long as the stream,
// and the two overlap only in part.
//
// Work split. A unit is one tile of kCcModes modes and kCcOut output
// channels (a channel group). A thread owns one quad of modes, NT output
// channels n = ng + NG * j (its channel slot ng, j < NT) and RT batch rows
// of the tile; the 256 threads cover the tile's rows and kCcOut channels:
// a 16-row tile takes RT = NT = 4 (128 f32 sums a thread), an 8-row tile
// RT = 4, NT = 2, one row RT = NT = 1. Per contracted channel a thread
// reads NT weight quads and RT batch quads from shared memory (real and
// imaginary parts) and does 16 NT RT FMAs: 256 FMAs for 16 vector reads at
// the 16-row tile. Each sum runs over k in ascending order.
//
// The staged planes are dense boxes (the TMA layout): a weight row is
// kCcModes values of one (k, n), so the lanes of a warp, consecutive in
// quad and then in channel slot, read consecutive 16-byte (f32) or 8-byte
// (bf16) pieces: no bank conflicts. The element path (rows not 16-byte
// aligned) stages the same boxes with plain loads.

constexpr int kCcModes = 16;                 // modes of a unit
constexpr int kCcQuads = kCcModes / kQuad;   // lanes that share a row
constexpr int kCcOut = kThreads / kCcQuads;  // output channels of a unit
constexpr int kCcChunk = 4;                  // contracted channels per stage
constexpr int kCcStages = 4;                 // ring stages
constexpr int kCcMaxRows = 16;               // batch rows a block holds

template <int BT>
struct CcTile {
  static constexpr int kRows = BT < 4 ? BT : 4;        // RT
  static constexpr int kRowGroups = BT / kRows;        // threads along the rows
  static constexpr int kSlots = kCcOut / kRowGroups;   // NG
  static constexpr int kOut = kCcOut / kSlots;         // NT
  static constexpr int kWarpsAlongN = kSlots / (32 / kCcQuads);
  static_assert(kCcQuads * kSlots * kRowGroups == kThreads, "the threads cover the tile");
  // elements of one plane's box: weight (kCcChunk, kCcOut, kCcModes),
  // batch operand (BT, kCcChunk, kCcModes)
  static constexpr int kW = kCcChunk * kCcOut * kCcModes;
  static constexpr int kA = BT * kCcChunk * kCcModes;
  static constexpr int kStage = 2 * (kW + kA);  // w re, w im, a re, a im
};

template <int BT>
using CcAcc = float4[CcTile<BT>::kRows][CcTile<BT>::kOut];

// The tensor maps of the four planes (TMA path); unused on the element path.
struct CcMaps {
  CUtensorMap wr, wi, ar, ai;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the stage's phase, expecting `bytes` from its loads.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The box of `map` at coordinates (c0, c1, c2), innermost first, into dst,
// counted on bar. STREAM marks the lines evict-first in L2: the weight is
// read once a call and is larger than L2, so it should not push out what
// the other operands and the caller's next kernels use.
template <bool STREAM>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  if (STREAM) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_addr(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The element path's TMA box: element (j0, j1, j2) of a plane with extents
// (d0, d1, d2) and strides (1, s1, s2) for j in [c, c + n) goes to dst's
// dense (n2, n1, n0) box; what lies outside the extents is zero.
template <typename T>
__device__ __forceinline__ void load_box(T* dst, const T* __restrict__ src,
                                         int d0, int d1, int d2, int64_t s1,
                                         int64_t s2, int n0, int n1, int n2,
                                         int c0, int c1, int c2) {
  for (int k = threadIdx.x; k < n0 * n1 * n2; k += blockDim.x) {
    const int j0 = c0 + k % n0, j1 = c1 + k / n0 % n1, j2 = c2 + k / (n0 * n1);
    dst[k] = j0 < d0 && j1 < d1 && j2 < d2 ? src[j2 * s2 + j1 * s1 + j0]
                                           : zero_value<T>();
  }
}

// acc += x * c per mode: (x_r c_r - x_i c_i) + i (x_r c_i + x_i c_r).
__device__ __forceinline__ void mac(float& ar, float& ai, float xr, float xi,
                                    float cr, float ci) {
  ar = fmaf(xr, cr, ar);
  ar = fmaf(-xi, ci, ar);
  ai = fmaf(xr, ci, ai);
  ai = fmaf(xi, cr, ai);
}

// Sum one staged chunk into a thread's sums: slot ng, row group rg, quad q.
template <typename T, int BT, bool CONJ>
__device__ __forceinline__ void accumulate_chunk(const T* st, int ng, int rg,
                                                 int q, CcAcc<BT>& acc_r,
                                                 CcAcc<BT>& acc_i) {
  using Tile = CcTile<BT>;
  const T* w_re = st + ng * kCcModes + q * kQuad;
  const T* a_re = st + 2 * Tile::kW + rg * Tile::kRows * kCcChunk * kCcModes + q * kQuad;
#pragma unroll
  for (int kc = 0; kc < kCcChunk; ++kc) {
    float4 c_r[Tile::kOut], c_i[Tile::kOut];
#pragma unroll
    for (int j = 0; j < Tile::kOut; ++j) {
      const int o = (kc * kCcOut + j * Tile::kSlots) * kCcModes;
      c_r[j] = load_quad(w_re + o);
      c_i[j] = load_quad(w_re + Tile::kW + o);
      if (CONJ) c_i[j] = make_float4(-c_i[j].x, -c_i[j].y, -c_i[j].z, -c_i[j].w);
    }
#pragma unroll
    for (int i = 0; i < Tile::kRows; ++i) {
      const int o = (i * kCcChunk + kc) * kCcModes;
      const float4 x_r = load_quad(a_re + o);
      const float4 x_i = load_quad(a_re + Tile::kA + o);
#pragma unroll
      for (int j = 0; j < Tile::kOut; ++j) {
        float4& r = acc_r[i][j];
        float4& v = acc_i[i][j];
        mac(r.x, v.x, x_r.x, x_i.x, c_r[j].x, c_i[j].x);
        mac(r.y, v.y, x_r.y, x_i.y, c_r[j].y, c_i[j].y);
        mac(r.z, v.z, x_r.z, x_i.z, c_r[j].z, c_i[j].z);
        mac(r.w, v.w, x_r.w, x_i.w, c_r[j].w, c_i[j].w);
      }
    }
  }
}

// Write a thread's sums: rows b0 + i, channels n0 + NG * j, modes m .. m + 3
// (masked at B, N and M).
template <int BT, bool ALIGNED>
__device__ __forceinline__ void store_sums(float* __restrict__ out_r,
                                           float* __restrict__ out_i, int B,
                                           int N, int M, int b0, int n0, int m,
                                           const CcAcc<BT>& acc_r,
                                           const CcAcc<BT>& acc_i) {
  using Tile = CcTile<BT>;
#pragma unroll
  for (int i = 0; i < Tile::kRows; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kOut; ++j) {
      const int b = b0 + i, n = n0 + j * Tile::kSlots;
      if (b >= B || n >= N || m >= M) continue;
      const int64_t o = (static_cast<int64_t>(b) * N + n) * M + m;
      if (ALIGNED) {  // M is a multiple of 4: the quad is whole
        *reinterpret_cast<float4*>(out_r + o) = acc_r[i][j];
        *reinterpret_cast<float4*>(out_i + o) = acc_i[i][j];
      } else {
        const float vr[4] = {acc_r[i][j].x, acc_r[i][j].y, acc_r[i][j].z, acc_r[i][j].w};
        const float vi[4] = {acc_i[i][j].x, acc_i[i][j].y, acc_i[i][j].z, acc_i[i][j].w};
#pragma unroll
        for (int e = 0; e < kQuad; ++e) {
          if (m + e < M) {
            out_r[o + e] = vr[e];
            out_i[o + e] = vi[e];
          }
        }
      }
    }
  }
}

// ALIGNED: the TMA path; otherwise every thread stages the boxes itself.
template <typename T, int BT, bool CONJ, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 1)
    channel_contraction_kernel(const __grid_constant__ CcMaps maps,
                               const T* __restrict__ ar,
                               const T* __restrict__ ai,
                               const T* __restrict__ wr,
                               const T* __restrict__ wi,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i, int B, int K, int N,
                               int M, int64_t w_sk, int64_t w_sn) {
  using Tile = CcTile<BT>;
  extern __shared__ __align__(128) unsigned char cc_smem[];
  T* smem = reinterpret_cast<T*>(cc_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kCcStages * Tile::kStage);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % kCcQuads;
  const int ng = (warp % Tile::kWarpsAlongN) * (32 / kCcQuads) + lane / kCcQuads;
  const int rg = warp / Tile::kWarpsAlongN;
  const bool issuer = !ALIGNED || threadIdx.x == 0;  // who stages a chunk
  const int n_kc = (K + kCcChunk - 1) / kCcChunk;
  const int n_bt = (B + BT - 1) / BT;
  const int n_ng = (N + kCcOut - 1) / kCcOut;
  const int units = (M + kCcModes - 1) / kCcModes * n_ng * n_bt;
  const int mine = units > static_cast<int>(blockIdx.x)
                       ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int steps = mine * n_kc;
  // Step s sums chunk s % n_kc of unit blockIdx.x + (s / n_kc) * gridDim.x.
  // A unit is (mode tile, channel group, batch tile), batch tile fastest:
  // the batch tiles of one mode range run at once on neighbouring blocks,
  // so the weight's repeated reads hit L2. unit_base(s) is the unit's
  // first mode, output channel and batch row.
  auto unit_base = [&](int s, int& m0, int& n0, int& b0) {
    const int u = blockIdx.x + (s / n_kc) * gridDim.x;
    m0 = u / (n_bt * n_ng) * kCcModes;
    n0 = u / n_bt % n_ng * kCcOut;
    b0 = u % n_bt * BT;
  };
  auto stage = [&](int s) {
    if (s >= steps) return;
    int m0, n0, b0;
    unit_base(s, m0, n0, b0);
    const int k0 = s % n_kc * kCcChunk;
    T* st = smem + (s % kCcStages) * Tile::kStage;
    if (ALIGNED) {
      uint64_t* bar = &full[s % kCcStages];
      mbar_expect(bar, Tile::kStage * sizeof(T));
      tma_load<true>(st, &maps.wr, m0, n0, k0, bar);
      tma_load<true>(st + Tile::kW, &maps.wi, m0, n0, k0, bar);
      tma_load<false>(st + 2 * Tile::kW, &maps.ar, m0, k0, b0, bar);
      tma_load<false>(st + 2 * Tile::kW + Tile::kA, &maps.ai, m0, k0, b0, bar);
    } else {
      const int64_t ks = static_cast<int64_t>(K) * M;
      load_box(st, wr, M, N, K, w_sn, w_sk, kCcModes, kCcOut, kCcChunk, m0, n0, k0);
      load_box(st + Tile::kW, wi, M, N, K, w_sn, w_sk, kCcModes, kCcOut, kCcChunk, m0, n0, k0);
      load_box(st + 2 * Tile::kW, ar, M, K, B, M, ks, kCcModes, kCcChunk, BT, m0, k0, b0);
      load_box(st + 2 * Tile::kW + Tile::kA, ai, M, K, B, M, ks, kCcModes, kCcChunk, BT,
               m0, k0, b0);
    }
  };

  if (ALIGNED && threadIdx.x == 0) {
    // fetch the descriptors while the barriers are set up
    prefetch_map(&maps.wr);
    prefetch_map(&maps.wi);
    prefetch_map(&maps.ar);
    prefetch_map(&maps.ai);
    for (int i = 0; i < kCcStages; ++i) mbar_init(&full[i]);
    mbar_fence_init();
  }
  __syncthreads();
  if (issuer) {
    for (int s = 0; s < kCcStages - 1; ++s) stage(s);
  }
  CcAcc<BT> acc_r, acc_i;
  for (int s = 0; s < steps; ++s) {
    // chunk s - 1 is summed, so its stage takes chunk s + kCcStages - 1;
    // on the element path this barrier also publishes chunk s
    __syncthreads();
    if (issuer) stage(s + kCcStages - 1);
    if (ALIGNED) mbar_wait(&full[s % kCcStages], (s / kCcStages) & 1);
    const int kc = s % n_kc;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < Tile::kRows; ++i) {
#pragma unroll
        for (int j = 0; j < Tile::kOut; ++j) {
          acc_r[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          acc_i[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    accumulate_chunk<T, BT, CONJ>(smem + (s % kCcStages) * Tile::kStage, ng, rg,
                                  q, acc_r, acc_i);
    if (kc == n_kc - 1) {
      int m0, n0, b0;
      unit_base(s, m0, n0, b0);
      store_sums<BT, ALIGNED>(out_r, out_i, B, N, M, b0 + rg * Tile::kRows,
                              n0 + ng, m0 + q * kQuad, acc_r, acc_i);
    }
  }
}

// How K1/K2 run a shape: the batch tile, the load path, the dynamic shared
// memory, the work units and the blocks launched.
struct CcPlan {
  int batch_tile, aligned, smem_bytes, units, grid;
};

template <typename T>
using CcKernel = void (*)(CcMaps, const T*, const T*, const T*, const T*,
                          float*, float*, int, int, int, int, int64_t, int64_t);

template <typename T, bool CONJ, int BT>
CcKernel<T> contraction_variant(bool aligned) {
  return aligned ? channel_contraction_kernel<T, BT, CONJ, true>
                 : channel_contraction_kernel<T, BT, CONJ, false>;
}

template <typename T, bool CONJ>
int plan_contraction(int B, int K, int N, int M, bool ptrs_aligned,
                     CcPlan* plan, CcKernel<T>* kernel) {
  if (B <= 0 || K <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  const int bt = B == 1 ? 1 : B <= 8 ? 8 : kCcMaxRows;
  const int64_t units = static_cast<int64_t>((M + kCcModes - 1) / kCcModes) *
                        ((N + kCcOut - 1) / kCcOut) * ((B + bt - 1) / bt);
  if (units * ((K + kCcChunk - 1) / kCcChunk) > 2147483647 - kCcStages) {
    return cudaErrorInvalidValue;
  }
  const int stage = bt == 1   ? CcTile<1>::kStage
                    : bt == 8 ? CcTile<8>::kStage
                              : CcTile<kCcMaxRows>::kStage;
  plan->batch_tile = bt;
  plan->aligned = ptrs_aligned && (static_cast<int64_t>(M) * sizeof(T)) % 16 == 0;
  plan->smem_bytes = static_cast<int>(kCcStages * (stage * sizeof(T) + sizeof(uint64_t)));
  plan->units = static_cast<int>(units);
  *kernel = bt == 1   ? contraction_variant<T, CONJ, 1>(plan->aligned)
            : bt == 8 ? contraction_variant<T, CONJ, 8>(plan->aligned)
                      : contraction_variant<T, CONJ, kCcMaxRows>(plan->aligned);
  int sms = 0, per_sm = 0;
  const int err = block_occupancy(reinterpret_cast<const void*>(*kernel),
                                  plan->smem_bytes, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  plan->grid = static_cast<int>(
      std::min<int64_t>(units, static_cast<int64_t>(sms) * per_sm));
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (the
// library links no driver API).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of one plane with extents (d0, d1, d2), strides (1, s1, s2) in
// elements, read in boxes (n0, n1, n2); zeros past the extents. A map
// depends on nothing else, so the last kMapCache encoded are kept and
// reused: the weight is the same tensor call after call, and the caching
// allocator hands the batch operand the same addresses in a steady loop
// (encoding takes microseconds of host time, as long as the launch).
constexpr int kMapCache = 16;

template <typename T>
int encode_box(CUtensorMap* map, const void* plane, int64_t d0, int64_t d1,
               int64_t d2, int64_t s1, int64_t s2, int n0, int n1, int n2) {
  struct Key {
    const void* plane;
    int64_t shape[8];
    bool operator==(const Key& o) const {
      return plane == o.plane && std::equal(shape, shape + 8, o.shape);
    }
  };
  static std::mutex mu;
  static Key keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int filled = 0, next = 0;
  const Key key = {plane, {d0, d1, d2, s1, s2, n0, n1, n2}};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    if (keys[i] == key) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1 * sizeof(T)),
                                 static_cast<cuuint64_t>(s2 * sizeof(T))};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(n0), static_cast<cuuint32_t>(n1),
                             static_cast<cuuint32_t>(n2)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(plane), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  filled = std::max(filled, next == 0 ? kMapCache : next);
  return cudaSuccess;
}

template <typename T, bool CONJ>
int launch_contraction(const void* ar, const void* ai, const void* wr,
                       const void* wi, void* out_r, void* out_i, int B, int K,
                       int N, int M, int64_t w_sk, int64_t w_sn,
                       void* stream) {
  const bool ptrs_aligned = aligned16(ar) && aligned16(ai) && aligned16(wr) &&
                            aligned16(wi) && aligned16(out_r) && aligned16(out_i);
  CcPlan plan;
  CcKernel<T> kernel;
  int err = plan_contraction<T, CONJ>(B, K, N, M, ptrs_aligned, &plan, &kernel);
  if (err != cudaSuccess) return err;
  CcMaps maps = {};
  if (plan.aligned) {
    const int bt = plan.batch_tile, kc = kCcChunk;
    const int64_t mm = M;
    // weight planes (M, N, K) in boxes of a chunk; batch planes (M, K, B)
    // in boxes of a chunk's rows of the batch tile
    if ((err = encode_box<T>(&maps.wr, wr, M, N, K, w_sn, w_sk, kCcModes, kCcOut, kc)) ||
        (err = encode_box<T>(&maps.wi, wi, M, N, K, w_sn, w_sk, kCcModes, kCcOut, kc)) ||
        (err = encode_box<T>(&maps.ar, ar, M, K, B, mm, K * mm, kCcModes, kc, bt)) ||
        (err = encode_box<T>(&maps.ai, ai, M, K, B, mm, K * mm, kCcModes, kc, bt))) {
      return err;
    }
  }
  kernel<<<plan.grid, kThreads, plan.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const T*>(ar), static_cast<const T*>(ai),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<float*>(out_r), static_cast<float*>(out_i), B, K, N, M,
      w_sk, w_sn);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K3
//
// dw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m], written for Hopper.
//
// Work split. A mode tile is 16 consecutive modes. Its output is the
// (I, O, 16) block of dw; its inputs are the (B, I, 16) slice of x and the
// (B, O, 16) slice of g. A sub-tile is 32 input x 16 output channels of a
// mode tile: one block of 256 threads (8 warps) computes it, a warp owning
// 4 input channels and a thread 4 consecutive modes (lane % 4) of 2 output
// channels (o = lane / 4 and lane / 4 + 8 within the sub-tile), so a thread
// keeps 4 x 2 x 4 complex sums in registers and sums over the whole batch
// itself, in ascending b: no atomics, no second pass, the same result from
// run to run.
//
// Persistent grid. The launcher starts min(work units, SMs x blocks per SM)
// blocks (the SM count and the occupancy are queried, not assumed); block k
// walks units k, k + grid, k + 2 grid, ... Stores are plain st.global from
// registers (16-byte vectors, streaming cache hint), so a warp goes on to
// the FMAs of its next sub-tile while the stores of the last one drain:
// the 69.2 MB of the flagship's dw leave at an even rate through the life
// of each block instead of in a burst at the end of each wave. (TMA bulk
// stores from a shared-memory staging buffer were the alternative; they
// cost 32 KB of shared memory, a barrier per sub-tile and a second copy of
// every output value, for stores that are already full 64-byte runs.)
//
// Two schedules, chosen per call by the launcher:
// * Resident (B * (I + O) rows of the mode tile fit in kDwResidentBytes of
//   shared memory; the flagship, B = 8, I = O = 64, takes 128 KB in f32 and
//   64 KB in bf16): a unit is a mode tile. The block copies the tile's whole
//   x and g slices into shared memory once and walks every sub-tile from
//   there, so each input value crosses from L2 into an SM once. The copies
//   start at the beginning of the tile in the order the sub-tiles need
//   them, one cp.async group per channel block (x's first input block with
//   g's first output block, then g's other output blocks, then x's other
//   input blocks), and each sub-tile waits only for the groups it reads.
// * Streamed (larger B, I or O): a unit is one sub-tile of one mode tile,
//   and the block walks its batch in chunks of 8 rows through two stages
//   of shared memory (the next chunk's copies in flight while this one is
//   summed; 96 KB in f32). Each x value then crosses from L2 ceil(O / 16)
//   times and each g value ceil(I / 32) times (8 and 4 at B = 32,
//   I = O = 128); consecutive units share a mode tile, so the re-reads hit
//   L2.
//
// Two load paths, a template flag of the same kernel:
// * aligned (every plane's base and row stride M * sizeof(T) a multiple of
//   16 bytes; the flagship's M = 2112): 16-byte cp.async.cg copies, modes
//   past M zero-filled by the copy's source size, 16-byte vector stores;
// * unaligned (M = 77 or 33, say): plain element loads into shared memory
//   and element stores, masked at M.
// (TMA loads were the alternative for the aligned path: they would need a
// tensor map encoded on the host per call (cuTensorMapEncodeTiled) and
// mbarrier waits, to move the same 16-byte-aligned rows that one cp.async
// per thread already moves with the copies in flight; the loads are 17 MB
// of the flagship's 86.5 MB.)
// The operands stay in their own type in shared memory (bf16 halves the
// bytes staged) and are widened to f32 as they are read from there. (A
// widening placed right after a masked global load, as a staging loop
// through registers does, holds back the next instruction until that
// load's data arrives, so the loads go out one at a time; the copies here
// keep all of them in flight.) The FMAs are f32 on the CUDA cores, exact
// for bf16 operands and within 1e-5 of the plain f32 version (TF32 would
// not be).
//
// Shared-memory rows. A staged row is one (b, channel) pair at the tile's
// 16 modes: its real and its imaginary part, 16 values each. The 8 output
// channels a warp reads at once are 8 rows: for f32 each row is 128 bytes
// and starts at bank 0, so odd channels store the imaginary part first;
// for bf16 rows are 64 bytes and the swap follows the channel's second
// bit. A warp's read of 8 rows then takes the fewest wavefronts (4 in f32,
// 2 in bf16); x's rows are read by all 8 lane groups at once (a broadcast).

constexpr int kDwModes = 16;    // modes per mode tile
constexpr int kDwQuad = 4;      // consecutive modes per thread
constexpr int kDwWarps = 8;
constexpr int kDwThreads = 32 * kDwWarps;
static_assert(kDwThreads == kThreads, "block_occupancy queries kThreads");
constexpr int kDwTileI = 4;     // input channels per warp (and thread)
constexpr int kDwTileO = 2;     // output channels per thread
constexpr int kDwGroupsO = 32 / (kDwModes / kDwQuad);  // 8 lane groups
constexpr int kDwBlockI = kDwWarps * kDwTileI;          // 32 per sub-tile
constexpr int kDwBlockO = kDwGroupsO * kDwTileO;        // 16 per sub-tile
constexpr int kDwRow = 2 * kDwModes;  // elements of a staged row
constexpr int kDwBatchChunk = 8;      // batch rows per stage when streamed
constexpr int64_t kDwResidentBytes = 192 * 1024;
static_assert(kDwResidentBytes <= kMaxSmemBytes, "a plan fits the attribute");

// Which half of a staged row holds the real part of channel c (see above).
template <typename T>
__device__ __forceinline__ int dw_swap(int c) {
  return (sizeof(T) == 4 ? c : c >> 1) & 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's copy groups are pending; past 7 it
// waits for 7, which is only stricter.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Copy channels [c0, c0 + nc) x batch rows [b0, b0 + nb) of a (B, C, M)
// operand at modes [m0, m0 + 16) into staged rows: (b - b0, c - c0) goes to
// dst + ((b - b0) * ld + c - c0) * kDwRow. Channels past C and modes past M
// are zeros. ALIGNED starts cp.async copies (the caller commits and waits);
// otherwise the values are stored before it returns.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ re,
                                           const T* __restrict__ im, int C,
                                           int M, int b0, int nb, int c0,
                                           int nc, int m0) {
  constexpr int kVec = ALIGNED ? 16 / sizeof(T) : 1;  // elements per copy
  constexpr int kPer = kDwModes / kVec;               // copies per half row
  const int n = nb * nc * 2 * kPer;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int e = k % kPer;
    int r = k / kPer;
    const int part = r & 1;  // 0 real, 1 imaginary
    r >>= 1;
    const int c = r % nc, b = r / nc;
    const int ch = c0 + c, m = m0 + e * kVec;
    const bool valid = ch < C && m < M;
    const T* plane = part ? im : re;
    const int64_t j = (static_cast<int64_t>(b0 + b) * C + ch) * M + m;
    T* to = dst + (b * ld + c) * kDwRow + (part ^ dw_swap<T>(ch)) * kDwModes +
            e * kVec;
    if (ALIGNED) {
      cp_async16(to, valid ? plane + j : plane, valid);
    } else {
      *to = valid ? plane[j] : zero_value<T>();
    }
  }
}

// acc += conj(x) * g = (x_r g_r + x_i g_i) + i (x_r g_i - x_i g_r), per mode.
__device__ __forceinline__ void cmac(float& ar, float& ai, float xr, float xi,
                                     float gr, float gi) {
  ar = fmaf(xr, gr, ar);
  ar = fmaf(xi, gi, ar);
  ai = fmaf(xr, gi, ai);
  ai = fmaf(-xi, gr, ai);
}

using DwAcc = float4[kDwTileI][kDwTileO];

// Sum nb staged batch rows into a thread's sums. xs is the staged row of
// the thread's first input channel (global index xc) at batch row 0, with
// ldx rows per batch row; gs, gc and ldg likewise for its first output
// channel, the second sitting kDwGroupsO rows further. q is the thread's
// mode quad.
template <typename T>
__device__ __forceinline__ void accumulate_dw(const T* xs, int ldx, int xc,
                                              const T* gs, int ldg, int gc,
                                              int nb, int q, DwAcc& acc_r,
                                              DwAcc& acc_i) {
  for (int b = 0; b < nb; ++b) {
    float4 g_r[kDwTileO], g_i[kDwTileO];
#pragma unroll
    for (int c = 0; c < kDwTileO; ++c) {
      const T* row = gs + (b * ldg + c * kDwGroupsO) * kDwRow + q * kDwQuad;
      const int s = dw_swap<T>(gc + c * kDwGroupsO);
      g_r[c] = load_quad(row + s * kDwModes);
      g_i[c] = load_quad(row + (1 - s) * kDwModes);
    }
#pragma unroll
    for (int a = 0; a < kDwTileI; ++a) {
      const T* row = xs + (b * ldx + a) * kDwRow + q * kDwQuad;
      const int s = dw_swap<T>(xc + a);
      const float4 x_r = load_quad(row + s * kDwModes);
      const float4 x_i = load_quad(row + (1 - s) * kDwModes);
#pragma unroll
      for (int c = 0; c < kDwTileO; ++c) {
        float4& r = acc_r[a][c];
        float4& i = acc_i[a][c];
        cmac(r.x, i.x, x_r.x, x_i.x, g_r[c].x, g_i[c].x);
        cmac(r.y, i.y, x_r.y, x_i.y, g_r[c].y, g_i[c].y);
        cmac(r.z, i.z, x_r.z, x_i.z, g_r[c].z, g_i[c].z);
        cmac(r.w, i.w, x_r.w, x_i.w, g_r[c].w, g_i[c].w);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(DwAcc& acc_r, DwAcc& acc_i) {
#pragma unroll
  for (int a = 0; a < kDwTileI; ++a) {
#pragma unroll
    for (int c = 0; c < kDwTileO; ++c) {
      acc_r[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_i[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Write a thread's sums: input channels i0 + a, output channels
// o0 + c * kDwGroupsO, modes m .. m + 3 (masked at I, O and M).
template <bool ALIGNED>
__device__ __forceinline__ void store_dw(float* __restrict__ dw_r,
                                         float* __restrict__ dw_i, int I,
                                         int O, int M, int i0, int o0, int m,
                                         const DwAcc& acc_r,
                                         const DwAcc& acc_i) {
#pragma unroll
  for (int a = 0; a < kDwTileI; ++a) {
#pragma unroll
    for (int c = 0; c < kDwTileO; ++c) {
      const int i = i0 + a, o = o0 + c * kDwGroupsO;
      if (i >= I || o >= O || m >= M) continue;
      const int64_t j = (static_cast<int64_t>(i) * O + o) * M + m;
      if (ALIGNED) {  // M is a multiple of 4: the quad is whole
        __stcs(reinterpret_cast<float4*>(dw_r + j), acc_r[a][c]);
        __stcs(reinterpret_cast<float4*>(dw_i + j), acc_i[a][c]);
      } else {
        const float vr[4] = {acc_r[a][c].x, acc_r[a][c].y, acc_r[a][c].z, acc_r[a][c].w};
        const float vi[4] = {acc_i[a][c].x, acc_i[a][c].y, acc_i[a][c].z, acc_i[a][c].w};
#pragma unroll
        for (int e = 0; e < kDwQuad; ++e) {
          if (m + e < M) {
            dw_r[j + e] = vr[e];
            dw_i[j + e] = vi[e];
          }
        }
      }
    }
  }
}

template <typename T, bool RESIDENT, bool ALIGNED>
__global__ void __launch_bounds__(kDwThreads, 1)
    weight_grad_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                       const T* __restrict__ gr, const T* __restrict__ gi,
                       float* __restrict__ dw_r, float* __restrict__ dw_i,
                       int B, int I, int O, int M) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* smem = reinterpret_cast<T*>(dw_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % (kDwModes / kDwQuad), og = lane / (kDwModes / kDwQuad);
  const int n_ib = (I + kDwBlockI - 1) / kDwBlockI;
  const int n_ob = (O + kDwBlockO - 1) / kDwBlockO;
  const int n_mt = (M + kDwModes - 1) / kDwModes;
  DwAcc acc_r, acc_i;

  if (RESIDENT) {
    const int ipad = n_ib * kDwBlockI, opad = n_ob * kDwBlockO;
    T* xs = smem;                                  // (B, ipad) rows
    T* gs = smem + static_cast<int64_t>(B) * ipad * kDwRow;  // (B, opad) rows
    const int groups = n_ob + n_ib - 1;
    for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
      const int m0 = mt * kDwModes;
      for (int k = 0; k < groups; ++k) {  // in the order of first use below
        if (k < n_ob) {
          if (k == 0) {
            stage_rows<T, ALIGNED>(xs, ipad, xr, xi, I, M, 0, B, 0, kDwBlockI, m0);
          }
          stage_rows<T, ALIGNED>(gs + k * kDwBlockO * kDwRow, opad, gr, gi, O, M,
                                 0, B, k * kDwBlockO, kDwBlockO, m0);
        } else {
          const int ib = k - n_ob + 1;
          stage_rows<T, ALIGNED>(xs + ib * kDwBlockI * kDwRow, ipad, xr, xi, I,
                                 M, 0, B, ib * kDwBlockI, kDwBlockI, m0);
        }
        cp_async_commit();
      }
      int ready = -1;  // groups known to have landed, block-wide
      for (int ib = 0; ib < n_ib; ++ib) {
        for (int ob = 0; ob < n_ob; ++ob) {
          const int need = ib == 0 ? ob : n_ob + ib - 1;
          if (need > ready) {
            cp_async_wait_upto(groups - 1 - need);
            __syncthreads();
            ready = need;
          }
          const int i0 = ib * kDwBlockI + warp * kDwTileI;
          const int o0 = ob * kDwBlockO + og;
          zero_acc(acc_r, acc_i);
          accumulate_dw<T>(xs + i0 * kDwRow, ipad, i0, gs + o0 * kDwRow, opad,
                           o0, B, q, acc_r, acc_i);
          store_dw<ALIGNED>(dw_r, dw_i, I, O, M, i0, o0, m0 + q * kDwQuad,
                            acc_r, acc_i);
        }
      }
      __syncthreads();  // the next tile's copies overwrite the slices
    }
  } else {
    const int n_bc = (B + kDwBatchChunk - 1) / kDwBatchChunk;
    const int stage = kDwBatchChunk * (kDwBlockI + kDwBlockO) * kDwRow;
    const int units = n_mt * n_ib * n_ob;
    const int mine = units > static_cast<int>(blockIdx.x)
                         ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                         : 0;
    const int steps = mine * n_bc;
    // step s: unit blockIdx.x + (s / n_bc) * gridDim.x, batch chunk s % n_bc;
    // a unit is (mode tile, input block, output block), output block fastest
    auto prefetch = [&](int s) {
      const int u = blockIdx.x + (s / n_bc) * gridDim.x, bc = s % n_bc;
      const int ob = u % n_ob, ib = (u / n_ob) % n_ib, mt = u / (n_ob * n_ib);
      const int b0 = bc * kDwBatchChunk, nb = min(kDwBatchChunk, B - b0);
      T* st = smem + (s & 1) * stage;
      stage_rows<T, ALIGNED>(st, kDwBlockI, xr, xi, I, M, b0, nb,
                             ib * kDwBlockI, kDwBlockI, mt * kDwModes);
      stage_rows<T, ALIGNED>(st + kDwBatchChunk * kDwBlockI * kDwRow, kDwBlockO,
                             gr, gi, O, M, b0, nb, ob * kDwBlockO, kDwBlockO,
                             mt * kDwModes);
      cp_async_commit();
    };
    if (steps > 0) prefetch(0);
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        prefetch(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int u = blockIdx.x + (s / n_bc) * gridDim.x, bc = s % n_bc;
      const int ob = u % n_ob, ib = (u / n_ob) % n_ib, mt = u / (n_ob * n_ib);
      const int b0 = bc * kDwBatchChunk, nb = min(kDwBatchChunk, B - b0);
      const T* st = smem + (s & 1) * stage;
      const int xl = warp * kDwTileI;  // the thread's rows within the stage
      const int i0 = ib * kDwBlockI + xl, o0 = ob * kDwBlockO + og;
      if (bc == 0) zero_acc(acc_r, acc_i);
      accumulate_dw<T>(st + xl * kDwRow, kDwBlockI, i0,
                       st + (kDwBatchChunk * kDwBlockI + og) * kDwRow,
                       kDwBlockO, o0, nb, q, acc_r, acc_i);
      if (bc == n_bc - 1) {
        store_dw<ALIGNED>(dw_r, dw_i, I, O, M, i0, o0, mt * kDwModes + q * kDwQuad,
                          acc_r, acc_i);
      }
      __syncthreads();  // step s + 2 copies into this stage
    }
  }
}

// How K3 runs a shape: which schedule and load path, its shared memory,
// work units and grid.
struct DwPlan {
  int resident, aligned, smem_bytes, units, grid;
};

template <typename T>
using DwKernel = void (*)(const T*, const T*, const T*, const T*, float*,
                          float*, int, int, int, int);

template <typename T>
DwKernel<T> weight_grad_variant(bool resident, bool aligned) {
  if (resident) {
    return aligned ? weight_grad_kernel<T, true, true>
                   : weight_grad_kernel<T, true, false>;
  }
  return aligned ? weight_grad_kernel<T, false, true>
                 : weight_grad_kernel<T, false, false>;
}

template <typename T>
int plan_weight_grad(int B, int I, int O, int M, bool ptrs_aligned,
                     DwPlan* plan, DwKernel<T>* kernel) {
  if (B <= 0 || I <= 0 || O <= 0 || M <= 0) return cudaErrorInvalidValue;
  const int64_t n_ib = (I + kDwBlockI - 1) / kDwBlockI;
  const int64_t n_ob = (O + kDwBlockO - 1) / kDwBlockO;
  const int64_t n_mt = (M + kDwModes - 1) / kDwModes;
  const int64_t resident_bytes = static_cast<int64_t>(B) *
                                 (n_ib * kDwBlockI + n_ob * kDwBlockO) *
                                 kDwRow * sizeof(T);
  const bool resident = resident_bytes <= kDwResidentBytes;
  const int64_t units = resident ? n_mt : n_mt * n_ib * n_ob;
  if (units > 2147483647) return cudaErrorInvalidValue;
  plan->resident = resident;
  plan->aligned = ptrs_aligned && (static_cast<int64_t>(M) * sizeof(T)) % 16 == 0;
  plan->smem_bytes = static_cast<int>(
      resident ? resident_bytes
               : 2 * kDwBatchChunk * (kDwBlockI + kDwBlockO) * kDwRow * sizeof(T));
  plan->units = static_cast<int>(units);
  *kernel = weight_grad_variant<T>(plan->resident, plan->aligned);
  int sms = 0, per_sm = 0;
  const int err = block_occupancy(reinterpret_cast<const void*>(*kernel),
                               plan->smem_bytes, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  plan->grid = static_cast<int>(
      std::min<int64_t>(units, static_cast<int64_t>(sms) * per_sm));
  return cudaSuccess;
}

template <typename T>
int launch_weight_grad(const void* xr, const void* xi, const void* gr,
                       const void* gi, void* dw_r, void* dw_i, int B, int I,
                       int O, int M, void* stream) {
  const bool ptrs_aligned = aligned16(xr) && aligned16(xi) && aligned16(gr) &&
                            aligned16(gi) && aligned16(dw_r) && aligned16(dw_i);
  DwPlan plan;
  DwKernel<T> kernel;
  const int err = plan_weight_grad<T>(B, I, O, M, ptrs_aligned, &plan, &kernel);
  if (err != cudaSuccess) return err;
  kernel<<<plan.grid, kDwThreads, plan.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(gr), static_cast<const T*>(gi),
      static_cast<float*>(dw_r), static_cast<float*>(dw_i), B, I, O, M);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// All operands contiguous; each function returns the cudaError_t of its
// launch (0 on success).

// K1: x parts (B, I, M), w parts (I, O, M) -> out (B, O, M) f32.
int nop_mode_contraction_f32(const void* xr, const void* xi, const void* wr,
                             const void* wi, void* out_r, void* out_i, int B,
                             int I, int O, int M, void* stream) {
  return launch_contraction<float, false>(xr, xi, wr, wi, out_r, out_i, B, I,
                                          O, M, int64_t{O} * M, M, stream);
}

int nop_mode_contraction_bf16(const void* xr, const void* xi, const void* wr,
                              const void* wi, void* out_r, void* out_i, int B,
                              int I, int O, int M, void* stream) {
  return launch_contraction<__nv_bfloat16, false>(
      xr, xi, wr, wi, out_r, out_i, B, I, O, M, int64_t{O} * M, M, stream);
}

// K2: g parts (B, O, M), w parts (I, O, M) -> dx (B, I, M) f32.
int nop_mode_contraction_dx_f32(const void* gr, const void* gi,
                                const void* wr, const void* wi, void* dx_r,
                                void* dx_i, int B, int I, int O, int M,
                                void* stream) {
  return launch_contraction<float, true>(gr, gi, wr, wi, dx_r, dx_i, B, O, I,
                                         M, M, int64_t{O} * M, stream);
}

int nop_mode_contraction_dx_bf16(const void* gr, const void* gi,
                                 const void* wr, const void* wi, void* dx_r,
                                 void* dx_i, int B, int I, int O, int M,
                                 void* stream) {
  return launch_contraction<__nv_bfloat16, true>(
      gr, gi, wr, wi, dx_r, dx_i, B, O, I, M, M, int64_t{O} * M, stream);
}

// K3: x parts (B, I, M), g parts (B, O, M) -> dw (I, O, M) f32.
int nop_mode_contraction_dw_f32(const void* xr, const void* xi,
                                const void* gr, const void* gi, void* dw_r,
                                void* dw_i, int B, int I, int O, int M,
                                void* stream) {
  return launch_weight_grad<float>(xr, xi, gr, gi, dw_r, dw_i, B, I, O, M,
                                   stream);
}

int nop_mode_contraction_dw_bf16(const void* xr, const void* xi,
                                 const void* gr, const void* gi, void* dw_r,
                                 void* dw_i, int B, int I, int O, int M,
                                 void* stream) {
  return launch_weight_grad<__nv_bfloat16>(xr, xi, gr, gi, dw_r, dw_i, B, I,
                                           O, M, stream);
}

// How K1 (dx 0) or K2 (dx 1) would run a shape (as `launch_contraction`
// decides): out[0] the batch tile (rows served by one read of the weight),
// out[1] 1 for the aligned (TMA) load path, out[2] dynamic shared
// memory in bytes, out[3] work units, out[4] blocks launched. bf16 selects
// the operand type; ptrs_aligned says whether every plane's base is
// 16-byte aligned.
int nop_mode_contraction_plan(int bf16, int dx, int B, int I, int O, int M,
                              int ptrs_aligned, int* out) {
  const int K = dx ? O : I, N = dx ? I : O;
  const bool al = ptrs_aligned != 0;
  CcPlan plan;
  int err;
  if (bf16) {
    CcKernel<__nv_bfloat16> kernel;
    err = dx ? plan_contraction<__nv_bfloat16, true>(B, K, N, M, al, &plan, &kernel)
             : plan_contraction<__nv_bfloat16, false>(B, K, N, M, al, &plan, &kernel);
  } else {
    CcKernel<float> kernel;
    err = dx ? plan_contraction<float, true>(B, K, N, M, al, &plan, &kernel)
             : plan_contraction<float, false>(B, K, N, M, al, &plan, &kernel);
  }
  if (err == cudaSuccess) {
    out[0] = plan.batch_tile;
    out[1] = plan.aligned;
    out[2] = plan.smem_bytes;
    out[3] = plan.units;
    out[4] = plan.grid;
  }
  return err;
}

// How K3 would run a shape (as `launch_weight_grad` decides): out[0] 1 for
// the resident schedule, 0 for the streamed one; out[1] 1 for the aligned
// (cp.async) load path; out[2] dynamic shared memory in bytes; out[3] work
// units; out[4] blocks launched. bf16 selects the operand type;
// ptrs_aligned says whether every plane's base is 16-byte aligned.
int nop_mode_contraction_dw_plan(int bf16, int B, int I, int O, int M,
                                 int ptrs_aligned, int* out) {
  DwPlan plan;
  int err;
  if (bf16) {
    DwKernel<__nv_bfloat16> kernel;
    err = plan_weight_grad<__nv_bfloat16>(B, I, O, M, ptrs_aligned != 0, &plan,
                                          &kernel);
  } else {
    DwKernel<float> kernel;
    err = plan_weight_grad<float>(B, I, O, M, ptrs_aligned != 0, &plan, &kernel);
  }
  if (err == cudaSuccess) {
    out[0] = plan.resident;
    out[1] = plan.aligned;
    out[2] = plan.smem_bytes;
    out[3] = plan.units;
    out[4] = plan.grid;
  }
  return err;
}

const char* nop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
