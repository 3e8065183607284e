// Fixed-point quantized GEMM for Hopper (sm_90a): HLSCNN's conv PE array.
//
// Replaces the Pallas TPU kernel repro/kernels/fx_gemm.py (fx_gemm, body
// _kernel, quantizer _fx_quant). Computes, per batch entry z,
//
//     out[z] = FXq_o(FXq_x(x[z]) @ FXq_w(w[z])^T)
//
// where FXq_s(v) = clamp(rint(v * 2^f), qmin, qmax) / 2^f is a signed
// fixed-point lattice (HLSCNN: activations 16 bits / 8 fraction bits,
// weights 16/11 or 8/3). The fused HLSCNN conv runner passes im2col patches
// (B, 144, 800) and the (32, 800) weight of one fused group: the grid's
// z-axis is the batch and a batch stride of 0 shares the weight, so one
// launch serves the group. Ragged M/N/K edges are masked here (FXq(0) == 0);
// callers pass unpadded tensors.
//
// Exact accumulation. Each quantized operand is an integer k on a 2^-f grid
// with |k| <= 2^(bits-1), so a product is an integer below 2^30 units of
// 2^-(fx+fw) and a sum of K <= 800 of them stays below 2^40 units: exact in
// float64, in any order. The kernel therefore stages the integer k of each
// operand in shared memory as a double, accumulates with float64 FMAs,
// scales the exact sum by 2^-(fx+fw) (exact), rounds it once to float32 and
// applies the float32 output quantizer. The plain version (kernels/ref.py
// fx_gemm_ref) and the HLSCNN ILA's CONV_START take the same three steps,
// so all three agree bit for bit at every shape, whatever order cuBLAS or
// this kernel sums in. The wrapper refuses shapes where exactness fails.
//
// Design: one block per (16 output rows x 32 output columns, sample), 256
// threads, two outputs per thread; K staged through shared memory in chunks
// of 32, each element quantized once as it is staged. The fused B = 8 group
// is 9 x 1 x 8 = 72 blocks.
//
// Bound: a B = 8 group reads 3.69 MB of patches and 0.10 MB of weight and
// writes 0.15 MB (1.18 us at 3.35 TB/s); its 59 MFLOP take 0.88 us at the
// 67 TFLOP/s float32 rate, so the bytes bound it. This simple kernel runs
// float64 FMAs on the CUDA cores at low occupancy (72 blocks on 132 SMs) and
// is latency-bound well above that. The later design: split-K (free, since
// the sum is exact in any order), implicit im2col from the activation image
// (3.69 MB of patches come from 66 KB of activations), and the exact
// int8 hi/lo split of the 16-bit operands on s8 wgmma with int32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;

struct Fx {
  float scale;  // 2^f
  float qmin;
  float qmax;
};

// the lattice integer of v: clamp(rint(v * 2^f), qmin, qmax)
__device__ __forceinline__ float fx_int(float v, Fx s) {
  return fminf(fmaxf(rintf(v * s.scale), s.qmin), s.qmax);
}

__global__ void __launch_bounds__(THREADS)
fx_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int M, int N, int K,
               long long x_bs, long long w_bs, Fx xs_, Fx ws_, Fx os_,
               double inv_xw) {
  __shared__ double xs[BK][BM + 1];
  __shared__ double ws[BK][BN + 1];

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % BN;  // output column within the tile
  const int ty = threadIdx.x / BN;  // output rows ty and ty + 8
  x += z * x_bs;
  w += z * w_bs;
  out += (long long)z * M * N;

  double acc0 = 0.0, acc1 = 0.0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage and quantize: 16 x 32 of x (2 per thread), 32 x 32 of w (4)
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS;
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      const float v = (m < M && k < K) ? x[(long long)m * K + k] : 0.0f;
      xs[c][r] = (double)fx_int(v, xs_);
    }
#pragma unroll
    for (int s = 0; s < (BN * BK) / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS;
      const int r = i / BK, c = i % BK;
      const int n = n0 + r, k = k0 + c;
      const float v = (n < N && k < K) ? w[(long long)n * K + k] : 0.0f;
      ws[c][r] = (double)fx_int(v, ws_);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const double b = ws[k][tx];
      acc0 = fma(xs[k][ty], b, acc0);
      acc1 = fma(xs[k][ty + 8], b, acc1);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const double acc[2] = {acc0, acc1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
    // the exact sum, scaled exactly, rounded once to float32 (nearest even)
    const float y = __double2float_rn(acc[i] * inv_xw);
    // through int, as the plain version's int32 representation (no -0.0)
    out[(long long)m * N + n] = (float)(int)fx_int(y, os_) / os_.scale;
  }
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// x: (B, M, K), w: (*, N, K), out: (B, M, N), all fp32 and contiguous;
// *_bs are batch strides in elements (0 = shared). Each spec is its scale
// 2^f and integer range; inv_xw = 2^-(fx + fw).
int fx_gemm_launch(const float* x, const float* w, float* out, int B, int M,
                   int N, int K, long long x_bs, long long w_bs,
                   float x_scale, float x_qmin, float x_qmax,
                   float w_scale, float w_qmin, float w_qmax,
                   float o_scale, float o_qmin, float o_qmax, double inv_xw,
                   void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  fx_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, out, M, N, K, x_bs, w_bs, Fx{x_scale, x_qmin, x_qmax},
      Fx{w_scale, w_qmin, w_qmax}, Fx{o_scale, o_qmin, o_qmax}, inv_xw);
  return (int)cudaGetLastError();
}

const char* fx_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
