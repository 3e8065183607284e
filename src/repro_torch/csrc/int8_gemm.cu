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
// Bound: the VTA kernel-mode shapes of the ResMLP row are tiny ((64,16) x
// (16,16) up to (16,128) x (64,128): at most 41 KB moved, 0.26 MOP), so
// the least time the card could take (nanoseconds of bytes at 3.35 TB/s,
// less of operations at 1,979 TOP/s int8) is far below a launch. What a
// call costs is the launch and the latency chain inside the kernel: each
// dependent trip to global memory, each barrier.
//
// Design: the chain is one global round trip. Each warp owns a 16 x 8
// output tile and computes it on the int8 tensor cores with
// mma.sync.m16n8k32 (s8 x s8, exact int32 sums). Both a and b are
// K-contiguous, which is the layout of mma's row-major A and column-major B
// fragments: each fragment register is four consecutive bytes of one row.
// A sum over k may take k in any order, so long as A and B take the same
// one: a thread's four registers of two k-steps (a "pair", 64 values of k)
// are the 16 consecutive bytes at k = 64 p + 16 tig of its row, loaded with
// one 16-byte load where K is a multiple of 16 and the rows start on 16
// bytes, else byte by byte. No shared memory and no barrier. Up to K = 256
// (every shape of the main path) all pairs are loaded before the first
// mma, so every load is in flight at once; above it the warp streams its
// pairs and keeps the loads of the next two in flight. Rows past M,
// columns past N and k past K are zero: every load is unconditional (one
// that would fall out of range reads the operand's first bytes instead)
// and its value is then replaced by 0, so no branch sits between the
// loads. K = 16 is one pair, mostly zero. A block is four warps side by
// side along N (a 16 x 32 output tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // per block, along N
constexpr int BM = 16;            // rows of an mma tile
constexpr int BN = 8 * WARPS;     // columns of a block
constexpr int PAIR = 64;          // k of two mma steps
constexpr int MAX_UNROLL = 4;     // pairs loaded up front (K <= 256)

// one k-step's fragments: A (16 x 32, rows g and g + 8) and B (32 x 8, column g)
struct Frag {
  uint32_t a[4], b[2];
};

// 16 bytes of row ``row`` at k .. k + 15, 0 where row >= rows or k + i >= K;
// WIDE (K % 16 == 0, rows on 16 bytes): one load, wholly inside or past K.
// K > 0, so row 0 at k 0 is always a valid address.
template <bool WIDE>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p, int row, int rows, int k,
                                        int K) {
  if constexpr (WIDE) {
    const bool ok = row < rows && k < K;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + (ok ? (long long)row * K + k : 0)));
    return ok ? v : make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool ok = row < rows && k + i < K;
      const uint32_t v = (uint8_t)__ldg(p + (ok ? (long long)row * K + k + i : 0));
      w[i / 4] |= (ok ? v : 0u) << (8 * (i % 4));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// k-steps 2 p and 2 p + 1: thread tig's words are k = 64 p + 16 tig + 4 w;
// words 0 and 1 are step 2 p's registers 0 and 2 of A (0 and 1 of B), words
// 2 and 3 step 2 p + 1's. A and B take the same permutation of k.
template <bool WIDE>
__device__ __forceinline__ void load_pair(Frag (&f)[2], const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ b, int m0, int n, int g,
                                          int tig, int M, int N, int K, int p) {
  const int k = PAIR * p + 16 * tig;
  const uint4 r0 = load16<WIDE>(a, m0 + g, M, k, K), r1 = load16<WIDE>(a, m0 + g + 8, M, k, K);
  const uint4 c = load16<WIDE>(b, n, N, k, K);
  f[0] = {{r0.x, r1.x, r0.y, r1.y}, {c.x, c.y}};
  f[1] = {{r0.z, r1.z, r0.w, r1.w}, {c.z, c.w}};
}

__device__ __forceinline__ void mma(int (&c)[4], const Frag& f) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(f.a[0]), "r"(f.a[1]), "r"(f.a[2]), "r"(f.a[3]), "r"(f.b[0]), "r"(f.b[1]));
}

// NP > 0: exactly NP pairs, all loaded before the first mma; NP == 0: any
// number, streamed with the loads of the next two pairs in flight
template <int NP, bool WIDE>
__global__ void __launch_bounds__(32 * WARPS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;   // mma fragment coordinates
  const int m0 = blockIdx.y * BM;
  const int n_base = blockIdx.x * BN + 8 * warp;
  if (n_base >= N) return;                  // a warp past N has nothing to do
  const int n = n_base + g;                 // this thread's column of B

  int c[4] = {0, 0, 0, 0};
  if (K > 0) {
    if constexpr (NP > 0) {
      Frag f[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) load_pair<WIDE>(f[p], a, b, m0, n, g, tig, M, N, K, p);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        mma(c, f[p][0]);
        mma(c, f[p][1]);
      }
    } else {
      const int np = (K + PAIR - 1) / PAIR;
      Frag f[3][2];
      load_pair<WIDE>(f[0], a, b, m0, n, g, tig, M, N, K, 0);
      load_pair<WIDE>(f[1], a, b, m0, n, g, tig, M, N, K, 1);   // np > MAX_UNROLL
      for (int p0 = 0; p0 < np; p0 += 3) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int p = p0 + u;
          if (p < np) {
            if (p + 2 < np) load_pair<WIDE>(f[(u + 2) % 3], a, b, m0, n, g, tig, M, N, K, p + 2);
            mma(c, f[u][0]);
            mma(c, f[u][1]);
          }
        }
      }
    }
  }

  // c[0], c[1]: row g, columns 2 tig and 2 tig + 1; c[2], c[3]: row g + 8
  const int col = n_base + 2 * tig;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + g + 8 * (i / 2), cc = col + (i % 2);
    if (row < M && cc < N) out[(long long)row * N + cc] = c[i];
  }
}

template <int NP>
cudaError_t launch_np(bool wide, const int8_t* a, const int8_t* b, int32_t* out, int M, int N,
                      int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  if (wide) int8_gemm_kernel<NP, true><<<grid, 32 * WARPS, 0, stream>>>(a, b, out, M, N, K);
  else int8_gemm_kernel<NP, false><<<grid, 32 * WARPS, 0, stream>>>(a, b, out, M, N, K);
  return cudaGetLastError();
}

// nothing: the least a launch of this kernel's block shape costs
__global__ void __launch_bounds__(32 * WARPS) empty_kernel() {}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// a: (M, K), b: (N, K) int8 and out: (M, N) int32, all contiguous; ``wide``
// (K a multiple of 16 and a, b 16-byte aligned) lets fragments load 16
// bytes at a time.
int int8_gemm_launch(const int8_t* a, const int8_t* b, int32_t* out, int M, int N, int K,
                     int wide, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool w = wide != 0;
  switch ((K + PAIR - 1) / PAIR) {
    case 0:   // K = 0: the zero sums, no load
    case 1: return (int)launch_np<1>(w, a, b, out, M, N, K, st);
    case 2: return (int)launch_np<2>(w, a, b, out, M, N, K, st);
    case 3: return (int)launch_np<3>(w, a, b, out, M, N, K, st);
    case MAX_UNROLL: return (int)launch_np<MAX_UNROLL>(w, a, b, out, M, N, K, st);
    default: return (int)launch_np<0>(w, a, b, out, M, N, K, st);
  }
}

// Launches the empty kernel (one block of int8_gemm's shape) on ``stream``:
// the launch floor the small GEMMs are measured against.
int int8_gemm_empty_launch(void* stream) {
  empty_kernel<<<1, 32 * WARPS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* int8_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
