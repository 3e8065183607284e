// int8 x int8 -> int32 GEMM for Hopper (sm_90a): VTA's GEMM core.
//
// Replaces the Pallas TPU kernel repro/kernels/int8_gemm.py (int8_gemm, body
// _kernel; its wrapper ops.int8_gemm pads to 128-multiples). Computes
//
//     out = a @ b^T      a: (M, K) int8, b: (N, K) int8, out: (M, N) int32
//
// exactly: int32 accumulation of int8 products is exact in any order while
// K < 2^17 (the wrapper checks). Ragged M/N/K edges are masked here, so the
// wrapper passes unpadded tensors.
//
// Design: one block per 32 x 32 output tile, 256 threads, four outputs per
// thread; K staged through shared memory in chunks of 64, four int8 values
// packed per 32-bit word so that __dp4a does four multiply-adds at once.
// Rows are padded to 17 words so the threads of a warp read distinct banks.
//
// Bound: the VTA kernel-mode shapes of the ResMLP row are tiny ((64,16) x
// (16,16) up to (16,128) x (64,128): at most 41 KB moved, 0.26 MOP), so a
// launch is dominated by its fixed latency, far above both the bytes bound
// (nanoseconds at 3.35 TB/s) and the operations bound (1,979 TOP/s int8 on
// the tensor cores). This kernel runs dp4a on the CUDA cores; the later
// design for large shapes is s8 wgmma with int32 accumulation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 64;            // int8 values per staged chunk
constexpr int KW = BK / 4;        // 32-bit words per staged row
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ int as[BM][KW + 1];
  __shared__ int bs[BN][KW + 1];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % BN;  // output column within the tile
  const int ty = threadIdx.x / BN;  // output rows ty + 8 * i, i < 4

  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage: 32 x 64 bytes of a and of b, 8 bytes each per thread
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int i = threadIdx.x + s * THREADS;
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, n = n0 + r, k = k0 + c;
      reinterpret_cast<int8_t*>(&as[r][0])[c] = (m < M && k < K) ? a[(long long)m * K + k] : 0;
      reinterpret_cast<int8_t*>(&bs[r][0])[c] = (n < N && k < K) ? b[(long long)n * K + k] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      const int bv = bs[tx][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __dp4a(as[ty + 8 * i][kw], bv, acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m < M) out[(long long)m * N + n] = acc[i];
  }
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// a: (M, K), b: (N, K) int8 and out: (M, N) int32, all contiguous.
int int8_gemm_launch(const int8_t* a, const int8_t* b, int32_t* out, int M,
                     int N, int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  int8_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M, N, K);
  return (int)cudaGetLastError();
}

const char* int8_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
