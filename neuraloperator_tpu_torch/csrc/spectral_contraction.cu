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
// of its own mode, so at B <= 8 they do about 2 flops per weight byte. The
// flagship layer (I = O = 64, M = 64 * 33 = 2112 modes, f32, B = 8) moves
// 69.2 MB of weight-sized data plus 2 * 8.65 MB of the batch-sized operand
// and result: 86.5 MB, 26 us at 3.35 TB/s, against 0.55 GFLOP (8 flops per
// complex multiply-add), 8 us even at the 67 TFLOP/s of plain f32.
//
// Design:
// * Natural layout. x and g are (B, I, M) and (B, O, M), w and dw the
//   stored (I, O, M) pair, modes fastest. Neighbouring threads take
//   neighbouring modes, so every load and store of a warp is one contiguous
//   run along M and no transpose pass runs before or after a kernel. (The
//   TPU kernel moved the mode axis to the front because Mosaic's batched
//   dot needs the batch dims first; a GPU thread has no such constraint.)
// * K1 and K2 are one kernel (`channel_contraction_kernel`): a batch-sized
//   operand a (B, K, M) times a weight whose (k, n, m) element sits at
//   k * w_sk + n * w_sn + m, summed over k, into (B, N, M); K2 swaps the two
//   weight strides (it contracts over O and produces I) and conjugates w.
//   Each weight element is read from device memory once, by one thread. A
//   thread owns one mode, NT output channels and BT batch rows, and walks
//   the K contracted channels keeping its BT * NT complex sums in
//   registers; a is small next to w and is re-read through L1/L2 by the
//   threads of the other output channels.
// * K3 writes the weight-sized result (`weight_grad_kernel`): a
//   persistent grid whose blocks keep a mode tile's x and g slices in
//   shared memory (cp.async copies) and stream dw out from registers; see
//   the note at its section below.
// * Bytes in flight (K1/K2): a thread issues the loads of S contracted
//   channels before the FMAs that use them, so each warp keeps S times more
//   bytes in flight than a load-then-use loop. NT and S are chosen per batch
//   tile (`launch` below): the sums grow with BT, and registers cap the
//   warps an SM holds.
// * Four-product complex multiply (4 FMAs per multiply-add), not Karatsuba:
//   the kernels are memory-bound, so the saved multiply buys nothing, while
//   Karatsuba costs extra adds and the cancellation in t3 - t1 - t2.
// * Operands are f32 or bf16 (__nv_bfloat16, widened exactly with
//   __bfloat162float); products and sums are f32, outputs f32.
// * The ragged mode tile (M not a multiple of 32) and the channel and batch
//   tails are masked. The kernels launch on the caller's stream and
//   allocate nothing; the caller allocates the outputs.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kModesPerBlock = 32;  // threadIdx.x: one warp along the modes
constexpr int kChannelGroups = 8;   // threadIdx.y

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Accumulate contracted channels [k, k + S) into the sums. All
// 2 * S * (NT + BT) loads are issued before the first FMA; rows past B and
// channels past N read a valid neighbour instead and their sums are never
// stored.
template <typename T, int BT, int NT, int S, bool CONJ>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ ar, const T* __restrict__ ai,
    const T* __restrict__ wr, const T* __restrict__ wi, int B, int K, int N,
    int64_t mm, int64_t w_sk, int64_t w_sn, int m, int n0, int b0, int k,
    float (&acc_r)[BT][NT], float (&acc_i)[BT][NT]) {
  T w_r[S][NT], w_i[S][NT], a_r[S][BT], a_i[S][BT];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int nn = min(n0 + n, N - 1);
      const int64_t j = (k + s) * w_sk + nn * w_sn + m;
      w_r[s][n] = wr[j];
      w_i[s][n] = wi[j];
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int bb = min(b0 + b, B - 1);
      const int64_t j = (static_cast<int64_t>(bb) * K + k + s) * mm + m;
      a_r[s][b] = ar[j];
      a_i[s][b] = ai[j];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float c_r = widen(w_r[s][n]);
      const float c_i = CONJ ? -widen(w_i[s][n]) : widen(w_i[s][n]);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float x_r = widen(a_r[s][b]), x_i = widen(a_i[s][b]);
        acc_r[b][n] = fmaf(x_r, c_r, acc_r[b][n]);
        acc_r[b][n] = fmaf(-x_i, c_i, acc_r[b][n]);
        acc_i[b][n] = fmaf(x_r, c_i, acc_i[b][n]);
        acc_i[b][n] = fmaf(x_i, c_r, acc_i[b][n]);
      }
    }
  }
}

// a (B, K, M) times w (element (k, n, m) at k * w_sk + n * w_sn + m),
// summed over k, into out (B, N, M); w conjugated when CONJ.
template <typename T, int BT, int NT, int S, bool CONJ>
__global__ void __launch_bounds__(kModesPerBlock * kChannelGroups)
    channel_contraction_kernel(const T* __restrict__ ar,
                               const T* __restrict__ ai,
                               const T* __restrict__ wr,
                               const T* __restrict__ wi,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i, int B, int K, int N,
                               int M, int64_t w_sk, int64_t w_sn) {
  const int m = blockIdx.x * kModesPerBlock + threadIdx.x;
  const int n0 = (blockIdx.y * kChannelGroups + threadIdx.y) * NT;
  const int b0 = blockIdx.z * BT;
  if (m >= M || n0 >= N) return;  // no barrier below, so an early exit is safe

  const int64_t mm = M;
  float acc_r[BT][NT];
  float acc_i[BT][NT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc_r[b][n] = 0.f;
      acc_i[b][n] = 0.f;
    }
  }
  int k = 0;
  for (; k + S <= K; k += S) {
    accumulate<T, BT, NT, S, CONJ>(ar, ai, wr, wi, B, K, N, mm, w_sk, w_sn, m,
                                   n0, b0, k, acc_r, acc_i);
  }
  for (; k < K; ++k) {  // the K % S tail
    accumulate<T, BT, NT, 1, CONJ>(ar, ai, wr, wi, B, K, N, mm, w_sk, w_sn, m,
                                   n0, b0, k, acc_r, acc_i);
  }

#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b >= B) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n0 + n < N) {
        const int64_t j = (static_cast<int64_t>(b0 + b) * N + n0 + n) * mm + m;
        out_r[j] = acc_r[b][n];
        out_i[j] = acc_i[b][n];
      }
    }
  }
}

template <typename T, int BT, int NT, int S, bool CONJ>
void launch_tile(const void* ar, const void* ai, const void* wr,
                 const void* wi, void* out_r, void* out_i, int B, int K,
                 int N, int M, int64_t w_sk, int64_t w_sn,
                 cudaStream_t stream) {
  constexpr int kOutPerBlock = kChannelGroups * NT;
  const dim3 block(kModesPerBlock, kChannelGroups);
  const dim3 grid((M + kModesPerBlock - 1) / kModesPerBlock,
                  (N + kOutPerBlock - 1) / kOutPerBlock, (B + BT - 1) / BT);
  channel_contraction_kernel<T, BT, NT, S, CONJ><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<float*>(out_r), static_cast<float*>(out_i), B, K, N, M,
      w_sk, w_sn);
}

// The batch tile is the smallest of 1, 2, 4, 8 that holds B (8 above that):
// the weight is streamed once per batch tile, so B <= 8 reads it once.
// Output channels per thread (NT) and contracted channels per load batch
// (S), by tile, as timed on an H100 for K1 at the flagship shape
// (I = O = 64, M = 2112) over 4-16 channel groups, NT in {1, 2, 4} and S in
// {1, 2, 4, 8}: B = 1 runs fastest at NT = 2, S = 4 and B = 8 at NT = 4,
// S = 4; B = 2 and 4 take NT = 2 without load batches. K2 has the same
// shape with I and O swapped and takes the same tiles.
template <typename T, bool CONJ>
int launch_contraction(const void* ar, const void* ai, const void* wr,
                       const void* wi, void* out_r, void* out_i, int B, int K,
                       int N, int M, int64_t w_sk, int64_t w_sn,
                       void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  if ((B + 7) / 8 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    launch_tile<T, 1, 2, 4, CONJ>(ar, ai, wr, wi, out_r, out_i, B, K, N, M,
                                  w_sk, w_sn, s);
  } else if (B == 2) {
    launch_tile<T, 2, 2, 1, CONJ>(ar, ai, wr, wi, out_r, out_i, B, K, N, M,
                                  w_sk, w_sn, s);
  } else if (B <= 4) {
    launch_tile<T, 4, 2, 1, CONJ>(ar, ai, wr, wi, out_r, out_i, B, K, N, M,
                                  w_sk, w_sn, s);
  } else {
    launch_tile<T, 8, 4, 4, CONJ>(ar, ai, wr, wi, out_r, out_i, B, K, N, M,
                                  w_sk, w_sn, s);
  }
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
constexpr int kDwTileI = 4;     // input channels per warp (and thread)
constexpr int kDwTileO = 2;     // output channels per thread
constexpr int kDwGroupsO = 32 / (kDwModes / kDwQuad);  // 8 lane groups
constexpr int kDwBlockI = kDwWarps * kDwTileI;          // 32 per sub-tile
constexpr int kDwBlockO = kDwGroupsO * kDwTileO;        // 16 per sub-tile
constexpr int kDwRow = 2 * kDwModes;  // elements of a staged row
constexpr int kDwBatchChunk = 8;      // batch rows per stage when streamed
constexpr int64_t kDwResidentBytes = 192 * 1024;

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

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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

__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// The current device's SM count and the blocks of one K3 variant an SM
// holds at smem bytes of dynamic shared memory, queried on first use and
// kept, so that a launch makes no device queries.
int dw_occupancy(const void* kernel, int smem, int* sms, int* per_sm) {
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
  // every plan's shared memory is at most kDwResidentBytes
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDwResidentBytes));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kDwThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  seen.push_back({kernel, dev, smem, *sms, *per_sm});
  return cudaSuccess;
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
  const int err = dw_occupancy(reinterpret_cast<const void*>(*kernel),
                               plan->smem_bytes, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  plan->grid = static_cast<int>(
      std::min<int64_t>(units, static_cast<int64_t>(sms) * per_sm));
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
