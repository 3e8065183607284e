// AdaptivFloat quantized GEMM for Hopper (sm_90a): FlexASR's PE array.
//
// Replaces the Pallas TPU kernel repro/kernels/af_gemm.py (af_gemm, body
// _kernel, quantizer _af_quant). Computes, per batch entry z,
//
//     out[z] = AFq_o(AFq_x(x[z]) @ AFq_w(w[z])^T + b[z])
//
// in AdaptivFloat(n_bits, n_exp) with per-tensor exponent biases, fp32
// accumulation and a bias + re-quantization epilogue. The grid's z-axis is
// the batch: the fused FlexASR runner's whole group (per-sample activation
// and output biases, one weight tensor) is one launch; the Executor's kernel
// mode is the same kernel with B = 1. A batch stride of 0 shares an operand
// across the batch. Ragged M/N/K edges are masked here (AFq(0) == 0, so
// zero-filled K padding changes no sum); callers pass unpadded tensors.
//
// Design: 64x64 output tiles, 256 threads, a 4x4 register tile per thread,
// K in steps of 32. x and w tiles are quantized onto the AF lattice as they
// are staged in shared memory, so the quantized operands never touch device
// memory. Each thread accumulates its outputs with fp32 FMAs in ascending k.
//
// The quantizer mirrors the PyTorch plain version (repro_torch/accel/
// numerics.py) operation for operation, so the two agree bit for bit:
// exponent floor(logf(x) / ln2), powers of two from ldexpf, rintf (round
// half to even, never roundf), the exponent clamp, the mantissa clamp and
// its bump to 2.0, saturation at the top and the flush below vmin / 2.
//
// Bound: an AF value (n_man = 4) has 5 significant bits and is exact in
// bf16, so every product can run exactly on the bf16 tensor cores. At that
// rate the bytes bound the main path's shapes: a fused group of B = 16
// (128,128)x(256,128)^T is 134 MFLOP (0.14 us at 989 TFLOP/s) over ~3.3 MB
// (1.0 us at 3.35 TB/s). This simple kernel runs fp32 FMA on the CUDA
// cores instead, whose rate (67 TFLOP/s, 2.0 us for that group) is itself
// above the bound, and a launch is dominated by latency. The later design:
// a bf16 wgmma with fp32 accumulation (TMA-staged tiles, quantize in the
// producer) computes the same function on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
// float32 nearest to ln 2 (0x3f317218), the constant the plain version uses
constexpr float LN2F = 0.693147182f;

__device__ __forceinline__ float exp2i(float e) { return ldexpf(1.0f, (int)e); }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ float af_quant(float x, float e_lo, int n_exp, int n_man) {
  const float e_hi = e_lo + (float)((1 << n_exp) - 1);
  const float top = 2.0f - ldexpf(1.0f, -n_man);
  const float p = ldexpf(1.0f, n_man);
  const float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float safe = ax > 0.0f ? ax : 1.0f;
  const float e = clampf(floorf(logf(safe) / LN2F), e_lo, e_hi);
  const float man = clampf(ax / exp2i(e), 1.0f, top);
  float man_q = rintf(man * p) / p;
  const bool bump = man_q >= 2.0f;
  const float e2 = clampf(e + (bump ? 1.0f : 0.0f), e_lo, e_hi);
  man_q = (bump && e2 > e) ? 1.0f : fminf(man_q, top);
  float q = man_q * exp2i(e2);
  q = fminf(q, top * exp2i(e_hi));
  if (ax < exp2i(e_lo) * 0.5f) q = 0.0f;
  return sign * q;
}

__global__ void __launch_bounds__(THREADS)
af_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, const float* __restrict__ bx,
               const float* __restrict__ bw, const float* __restrict__ bo,
               float* __restrict__ out, int M, int N, int K,
               long long x_bs, long long w_bs, long long b_bs,
               int bx_bs, int bw_bs, int bo_bs, int n_exp, int n_man) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float ws[BK][BN + 4];

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  x += z * x_bs;
  w += z * w_bs;
  b += z * b_bs;
  out += (long long)z * M * N;
  const float ex = bx[z * bx_bs];
  const float ew = bw[z * bw_bs];
  const float eo = bo[z * bo_bs];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage and quantize: 64 x 32 of x and of w, 8 elements each per thread
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS;
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, n = n0 + r, k = k0 + c;
      const float xv = (m < M && k < K) ? x[(long long)m * K + k] : 0.0f;
      const float wv = (n < N && k < K) ? w[(long long)n * K + k] : 0.0f;
      xs[c][r] = af_quant(xv, ex, n_exp, n_man);
      ws[c][r] = af_quant(wv, ew, n_exp, n_man);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float y = acc[i][j] + b[n];
      out[(long long)m * N + n] = af_quant(y, eo, n_exp, n_man);
    }
  }
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// x: (B, M, K), w: (*, N, K), b: (*, N), out: (B, M, N), all fp32 and
// contiguous; *_bs are batch strides in elements (0 = shared).
int af_gemm_launch(const float* x, const float* w, const float* b,
                   const float* bx, const float* bw, const float* bo,
                   float* out, int B, int M, int N, int K,
                   long long x_bs, long long w_bs, long long b_bs,
                   int bx_bs, int bw_bs, int bo_bs, int n_exp, int n_man,
                   void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  af_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, b, bx, bw, bo, out, M, N, K, x_bs, w_bs, b_bs, bx_bs, bw_bs,
      bo_bs, n_exp, n_man);
  return (int)cudaGetLastError();
}

const char* af_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
