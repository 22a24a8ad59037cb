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
// * K3 writes the weight-sized result (`weight_grad_kernel`). A thread owns
//   one mode and a 4 x 4 tile of (input, output) channels and loops over
//   the whole batch itself, so the batch reduction needs no atomics and no
//   second pass, and its result is the same from run to run. The block
//   (32 modes x 16 x 8 channels) stages its x and g rows in shared memory,
//   4 batch rows at a time, so each value crosses from L2 once per block
//   instead of once per warp that uses it. (A first version without
//   staging, each thread one input channel and 8 output channels reading x
//   and g straight from global memory, ran at 10x its bound.)
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

#include <cstdint>

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

// K3 tiles: a block owns 32 modes x 16 input channels x 8 output channels;
// each of its 256 threads owns one mode and a 4 x 4 (i, o) tile, with
// threadIdx.y = (input group) * 2 + (output group).
constexpr int kDwTileI = 4;
constexpr int kDwTileO = 4;
constexpr int kDwGroupsO = 2;
constexpr int kDwBlockI = kDwTileI * (kChannelGroups / kDwGroupsO);  // 16
constexpr int kDwBlockO = kDwTileO * kDwGroupsO;                     // 8
constexpr int kDwBatchChunk = 4;  // batch rows staged per pass

// Stage rows [b0, b0 + kDwBatchChunk) x [c0, c0 + ROWS) of a (B, C, M)
// operand at the block's 32 modes (this thread's is m) into shared memory,
// widened to f32, with zeros past B, C and M (they add nothing to the sums).
template <typename T, int ROWS>
__device__ __forceinline__ void stage_rows(
    const T* __restrict__ re, const T* __restrict__ im, int B, int C,
    int64_t mm, int m, int b0, int c0, float (&s_re)[kDwBatchChunk][ROWS][kModesPerBlock],
    float (&s_im)[kDwBatchChunk][ROWS][kModesPerBlock]) {
  constexpr int kRows = kDwBatchChunk * ROWS;
  static_assert(kRows % kChannelGroups == 0, "rows must split over the channel groups");
  float v_re[kRows / kChannelGroups], v_im[kRows / kChannelGroups];
#pragma unroll
  for (int k = 0; k < kRows / kChannelGroups; ++k) {  // all loads first
    const int r = k * kChannelGroups + threadIdx.y;
    const int b = b0 + r / ROWS, c = c0 + r % ROWS;
    v_re[k] = 0.f;
    v_im[k] = 0.f;
    if (m < mm && b < B && c < C) {
      const int64_t j = (static_cast<int64_t>(b) * C + c) * mm + m;
      v_re[k] = widen(re[j]);
      v_im[k] = widen(im[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows / kChannelGroups; ++k) {
    const int r = k * kChannelGroups + threadIdx.y;
    s_re[r / ROWS][r % ROWS][threadIdx.x] = v_re[k];
    s_im[r / ROWS][r % ROWS][threadIdx.x] = v_im[k];
  }
}

// dw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]. The block stages the
// x and g rows of its tile for kDwBatchChunk batch rows at a time in shared
// memory (each value is loaded from L2 once per block, coalesced along the
// modes) and every thread accumulates its 4 x 4 tile from there.
// blockIdx.x walks the output-channel tiles fastest, then the input-channel
// tiles, so the blocks that share an x or g slice run together and find it
// in L2; blockIdx.y is the mode tile.
template <typename T>
__global__ void __launch_bounds__(kModesPerBlock * kChannelGroups)
    weight_grad_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                       const T* __restrict__ gr, const T* __restrict__ gi,
                       float* __restrict__ dw_r, float* __restrict__ dw_i,
                       int B, int I, int O, int M) {
  __shared__ float sx_r[kDwBatchChunk][kDwBlockI][kModesPerBlock];
  __shared__ float sx_i[kDwBatchChunk][kDwBlockI][kModesPerBlock];
  __shared__ float sg_r[kDwBatchChunk][kDwBlockO][kModesPerBlock];
  __shared__ float sg_i[kDwBatchChunk][kDwBlockO][kModesPerBlock];

  const int o_tiles = (O + kDwBlockO - 1) / kDwBlockO;
  const int i0 = (blockIdx.x / o_tiles) * kDwBlockI;
  const int o0 = (blockIdx.x % o_tiles) * kDwBlockO;
  const int m = blockIdx.y * kModesPerBlock + threadIdx.x;
  const int ti = (threadIdx.y / kDwGroupsO) * kDwTileI;  // within the block tile
  const int to = (threadIdx.y % kDwGroupsO) * kDwTileO;
  const int64_t mm = M;

  float acc_r[kDwTileI][kDwTileO];
  float acc_i[kDwTileI][kDwTileO];
#pragma unroll
  for (int a = 0; a < kDwTileI; ++a) {
#pragma unroll
    for (int c = 0; c < kDwTileO; ++c) {
      acc_r[a][c] = 0.f;
      acc_i[a][c] = 0.f;
    }
  }
  for (int b0 = 0; b0 < B; b0 += kDwBatchChunk) {
    stage_rows<T, kDwBlockI>(xr, xi, B, I, mm, m, b0, i0, sx_r, sx_i);
    stage_rows<T, kDwBlockO>(gr, gi, B, O, mm, m, b0, o0, sg_r, sg_i);
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kDwBatchChunk; ++b) {
      float a_r[kDwTileI], a_i[kDwTileI], c_r[kDwTileO], c_i[kDwTileO];
#pragma unroll
      for (int a = 0; a < kDwTileI; ++a) {
        a_r[a] = sx_r[b][ti + a][threadIdx.x];
        a_i[a] = sx_i[b][ti + a][threadIdx.x];
      }
#pragma unroll
      for (int c = 0; c < kDwTileO; ++c) {
        c_r[c] = sg_r[b][to + c][threadIdx.x];
        c_i[c] = sg_i[b][to + c][threadIdx.x];
      }
#pragma unroll
      for (int a = 0; a < kDwTileI; ++a) {
#pragma unroll
        for (int c = 0; c < kDwTileO; ++c) {
          // conj(x) * g = (x_r g_r + x_i g_i) + i (x_r g_i - x_i g_r)
          acc_r[a][c] = fmaf(a_r[a], c_r[c], acc_r[a][c]);
          acc_r[a][c] = fmaf(a_i[a], c_i[c], acc_r[a][c]);
          acc_i[a][c] = fmaf(a_r[a], c_i[c], acc_i[a][c]);
          acc_i[a][c] = fmaf(-a_i[a], c_r[c], acc_i[a][c]);
        }
      }
    }
    __syncthreads();  // the next pass overwrites the staged rows
  }
  if (m >= M) return;
#pragma unroll
  for (int a = 0; a < kDwTileI; ++a) {
    const int i = i0 + ti + a;
#pragma unroll
    for (int c = 0; c < kDwTileO; ++c) {
      const int o = o0 + to + c;
      if (i < I && o < O) {
        const int64_t j = (static_cast<int64_t>(i) * O + o) * mm + m;
        dw_r[j] = acc_r[a][c];
        dw_i[j] = acc_i[a][c];
      }
    }
  }
}

template <typename T>
int launch_weight_grad(const void* xr, const void* xi, const void* gr,
                       const void* gi, void* dw_r, void* dw_i, int B, int I,
                       int O, int M, void* stream) {
  if (B <= 0 || I <= 0 || O <= 0 || M <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = static_cast<int64_t>((I + kDwBlockI - 1) / kDwBlockI) *
                        ((O + kDwBlockO - 1) / kDwBlockO);
  const int m_tiles = (M + kModesPerBlock - 1) / kModesPerBlock;
  if (tiles > 2147483647 || m_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 block(kModesPerBlock, kChannelGroups);
  const dim3 grid(static_cast<unsigned>(tiles), m_tiles);
  weight_grad_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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

const char* nop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
