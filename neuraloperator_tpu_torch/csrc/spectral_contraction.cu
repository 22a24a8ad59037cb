// Per-mode complex channel contraction of the spectral convolution (K1).
//
//   out[b, o, m] = sum_i x[b, i, m] * w[i, o, m]      (complex, split re/im)
//
// Replaces the TPU kernel `_kernel` driven by `_mode_contraction` with the
// forward dimension numbers `_FWD` in
// neuraloperator_tpu/ops/pallas/spectral_contraction.py.
//
// What bounds it: bytes. A weight element serves only the B batch rows of
// its own mode, so at serving batch sizes (B <= 8) the kernel does about
// 2 flops per byte of weight it reads. The flagship layer (I = O = 64,
// M = 64 * 33 = 2112 modes, f32) reads 69.2 MB of weight per launch plus
// 2 * 4.3 MB of x and writes 2 * 4.3 MB at B = 8: 86.5 MB, 26 us at
// 3.35 TB/s, against 0.55 GFLOP (8 flops per complex multiply-add), which
// takes 8 us even at the 67 TFLOP/s of plain f32.
//
// Design:
// * Natural layout. x is (B, I, M), w is the stored (I, O, M) pair and out
//   is (B, O, M), modes fastest. Neighbouring threads take neighbouring
//   modes, so every load and store of a warp is one contiguous run along M
//   and no transpose pass runs before or after the kernel. (The TPU kernel
//   moved the mode axis to the front because Mosaic's batched dot needs the
//   batch dims first; a GPU thread has no such constraint.)
// * Each weight element is read from device memory once, by one thread.
//   A thread owns one mode, OT output channels and BT batch rows, and walks
//   the I input channels keeping its BT * OT complex sums in registers. x is
//   small next to w and is re-read through L1/L2 by the threads of the
//   other output channels.
// * Bytes in flight: a thread issues the loads of S input channels before
//   the FMAs that use them, so each warp keeps S times more weight bytes in
//   flight than a load-then-use loop. OT and S are chosen per batch tile
//   (`launch` below): the sums grow with BT, and registers cap the warps an
//   SM holds, so the tiles trade warps for loads in flight differently.
// * Four-product complex multiply (4 FMAs per multiply-add), not Karatsuba:
//   the kernel is memory-bound, so the saved multiply buys nothing, while
//   Karatsuba costs extra adds and the cancellation in t3 - t1 - t2.
// * Operands are f32 or bf16 (__nv_bfloat16, widened exactly with
//   __bfloat162float); products and sums are f32, outputs f32.
// * The ragged mode tile (M not a multiple of 32), the output-channel tail
//   and the batch tail are masked. The kernel launches on the caller's
//   stream and allocates nothing; the caller allocates the outputs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kModesPerBlock = 32;  // threadIdx.x: one warp along the modes
constexpr int kOutGroups = 8;       // threadIdx.y

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Accumulate input channels [i, i + S) into the sums. All 2 * S * (OT + BT)
// loads are issued before the first FMA; rows past B and channels past O
// read a valid neighbour instead and their sums are never stored.
template <typename T, int BT, int OT, int S>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ xr, const T* __restrict__ xi,
    const T* __restrict__ wr, const T* __restrict__ wi, int B, int I, int O,
    int64_t mm, int m, int o0, int b0, int i, float (&acc_r)[BT][OT],
    float (&acc_i)[BT][OT]) {
  T w_r[S][OT], w_i[S][OT], x_r[S][BT], x_i[S][BT];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      const int oo = min(o0 + o, O - 1);
      const int64_t k = (static_cast<int64_t>(i + s) * O + oo) * mm + m;
      w_r[s][o] = wr[k];
      w_i[s][o] = wi[k];
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int bb = min(b0 + b, B - 1);
      const int64_t k = (static_cast<int64_t>(bb) * I + i + s) * mm + m;
      x_r[s][b] = xr[k];
      x_i[s][b] = xi[k];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      const float c_r = widen(w_r[s][o]), c_i = widen(w_i[s][o]);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float a_r = widen(x_r[s][b]), a_i = widen(x_i[s][b]);
        acc_r[b][o] = fmaf(a_r, c_r, acc_r[b][o]);
        acc_r[b][o] = fmaf(-a_i, c_i, acc_r[b][o]);
        acc_i[b][o] = fmaf(a_r, c_i, acc_i[b][o]);
        acc_i[b][o] = fmaf(a_i, c_r, acc_i[b][o]);
      }
    }
  }
}

template <typename T, int BT, int OT, int S>
__global__ void __launch_bounds__(kModesPerBlock * kOutGroups)
    mode_contraction_kernel(const T* __restrict__ xr,
                            const T* __restrict__ xi,
                            const T* __restrict__ wr,
                            const T* __restrict__ wi,
                            float* __restrict__ out_r,
                            float* __restrict__ out_i, int B, int I, int O,
                            int M) {
  const int m = blockIdx.x * kModesPerBlock + threadIdx.x;
  const int o0 = (blockIdx.y * kOutGroups + threadIdx.y) * OT;
  const int b0 = blockIdx.z * BT;
  if (m >= M || o0 >= O) return;  // no barrier below, so an early exit is safe

  const int64_t mm = M;
  float acc_r[BT][OT];
  float acc_i[BT][OT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      acc_r[b][o] = 0.f;
      acc_i[b][o] = 0.f;
    }
  }
  int i = 0;
  for (; i + S <= I; i += S) {
    accumulate<T, BT, OT, S>(xr, xi, wr, wi, B, I, O, mm, m, o0, b0, i, acc_r,
                             acc_i);
  }
  for (; i < I; ++i) {  // the I % S tail
    accumulate<T, BT, OT, 1>(xr, xi, wr, wi, B, I, O, mm, m, o0, b0, i, acc_r,
                             acc_i);
  }

#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b >= B) break;
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (o0 + o < O) {
        const int64_t k = (static_cast<int64_t>(b0 + b) * O + o0 + o) * mm + m;
        out_r[k] = acc_r[b][o];
        out_i[k] = acc_i[b][o];
      }
    }
  }
}

template <typename T, int BT, int OT, int S>
void launch_tile(const void* xr, const void* xi, const void* wr,
                 const void* wi, void* out_r, void* out_i, int B, int I,
                 int O, int M, cudaStream_t stream) {
  constexpr int kOutPerBlock = kOutGroups * OT;
  const dim3 block(kModesPerBlock, kOutGroups);
  const dim3 grid((M + kModesPerBlock - 1) / kModesPerBlock,
                  (O + kOutPerBlock - 1) / kOutPerBlock, (B + BT - 1) / BT);
  mode_contraction_kernel<T, BT, OT, S><<<grid, block, 0, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<float*>(out_r), static_cast<float*>(out_i), B, I, O, M);
}

// The batch tile is the smallest of 1, 2, 4, 8 that holds B (8 above that):
// the weight is streamed once per batch tile, so B <= 8 reads it once.
// Output channels per thread (OT) and input channels per load batch (S), by
// tile, as timed on an H100 at the flagship shape (I = O = 64, M = 2112)
// over 4-16 channel groups, OT in {1, 2, 4} and S in {1, 2, 4, 8}: B = 1
// runs fastest at OT = 2, S = 4 and B = 8 at OT = 4, S = 4; B = 2 and 4
// take OT = 2 without load batches.
template <typename T>
int launch(const void* xr, const void* xi, const void* wr, const void* wi,
           void* out_r, void* out_i, int B, int I, int O, int M,
           void* stream) {
  if (B <= 0 || I <= 0 || O <= 0 || M <= 0) return cudaErrorInvalidValue;
  if ((B + 7) / 8 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    launch_tile<T, 1, 2, 4>(xr, xi, wr, wi, out_r, out_i, B, I, O, M, s);
  } else if (B == 2) {
    launch_tile<T, 2, 2, 1>(xr, xi, wr, wi, out_r, out_i, B, I, O, M, s);
  } else if (B <= 4) {
    launch_tile<T, 4, 2, 1>(xr, xi, wr, wi, out_r, out_i, B, I, O, M, s);
  } else {
    launch_tile<T, 8, 4, 4>(xr, xi, wr, wi, out_r, out_i, B, I, O, M, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x parts (B, I, M), w parts (I, O, M), outputs (B, O, M) f32; all
// contiguous. Returns the cudaError_t of the launch (0 on success).
int nop_mode_contraction_f32(const void* xr, const void* xi, const void* wr,
                             const void* wi, void* out_r, void* out_i, int B,
                             int I, int O, int M, void* stream) {
  return launch<float>(xr, xi, wr, wi, out_r, out_i, B, I, O, M, stream);
}

int nop_mode_contraction_bf16(const void* xr, const void* xi, const void* wr,
                              const void* wi, void* out_r, void* out_i, int B,
                              int I, int O, int M, void* stream) {
  return launch<__nv_bfloat16>(xr, xi, wr, wi, out_r, out_i, B, I, O, M,
                               stream);
}

const char* nop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
