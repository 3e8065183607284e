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
// Exact accumulation. Each quantized operand is an integer q on a 2^-f grid
// with -2^15 <= q < 2^15. The kernel splits it exactly into a signed high
// byte and an unsigned low byte, q = 256 * (q >> 8) + (q & 255) (at the
// edge: -2^15 = 256 * -128 + 0, 2^15 - 1 = 256 * 127 + 255), and multiplies
// the bytes on the int8 tensor cores (mma.sync m16n8k32; s8 x s8, s8 x u8,
// u8 x s8, u8 x u8) with int32 sums, exact: a 32-deep chunk adds at most
// 32 * 255^2 < 2^21, and the sums move into float64 every 512 chunks, long
// before 2^31. Combined as 65536 hh + 256 (hl + lh) + ll, every term and
// every partial sum is an integer below 2^53 at any K the wrapper's
// check_exact admits (below 2^40 at K = 800), so it is exact in float64 in
// any order. The sum is scaled by 2^-(fx+fw) (exact), rounded once to
// float32 and passed through the float32 output quantizer. The plain
// version (kernels/ref.py fx_gemm_ref) and the HLSCNN ILA's CONV_START take
// the same three steps, so all three agree bit for bit at every shape,
// whatever order cuBLAS or this kernel sums in.
//
// Design: one launch per call. A cluster of SPLIT = 8 blocks computes one
// 16 x 32 output tile of one sample, each block one slice of K (K / 8
// rounded up to 4: 100 at K = 800), which costs nothing since the sum is
// exact in any order. The fused B = 8 group is 8 x 9 x 8 = 576 blocks of 4
// warps, about 4 per SM, all resident at once. Each block streams its
// slice in chunks of 32 through a 3-stage ring of cp.async copies (16-byte
// .cg where K % 4 == 0, else 4-byte), so the next two chunks' copies are in
// flight while this chunk is quantized (each element once, into its two
// bytes) and multiplied (each warp one 16 x 8 tile, four mma per chunk).
// Then each block leaves its partial tile in its shared memory, the cluster
// synchronises, and block s sums the eight partials of its 64 outputs over
// distributed shared memory in rank order 0..7 and runs the epilogue; a
// second cluster barrier keeps every partial alive until it has been read.
// No scratch in device memory, no atomics, no second launch, and the same
// bits every run.
//
// Bound: a B = 8 group reads 3.69 MB of patches and 0.10 MB of weight and
// writes 0.15 MB (1.18 us at 3.35 TB/s); its 59 MFLOP take 0.88 us at the
// 67 TFLOP/s float32 rate, so the bytes bound it. Why the tensor cores:
// with float64 FMAs on the CUDA cores (the plain version's exact route)
// each output needs three 8-byte shared loads per two FMAs, so shared
// memory sets the pace; as int8 mma the products cost four instructions
// per warp per chunk, and each block's chain of copies, quantization,
// barriers and the cluster's reduction sets it instead.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 16;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 128;   // 4 warps, one 8-column slab of the tile each
constexpr int SPLIT = 8;       // K slices: the blocks of one cluster
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int LDR = BK + 4;    // ring row stride in floats: 16-byte aligned rows
constexpr int LDB = 12;        // byte-plane row stride in words (48 bytes): no bank conflicts
constexpr int FLUSH = 512;     // chunks between moves of the int32 sums into float64

struct Fx {
  float scale;  // 2^f
  float qmin;
  float qmax;
};

// the lattice integer of v: clamp(rint(v * 2^f), qmin, qmax)
__device__ __forceinline__ float fx_int(float v, Fx s) {
  return fminf(fmaxf(rintf(v * s.scale), s.qmin), s.qmax);
}

// an integer-valued float of magnitude below 2^22, as an int (exact)
__device__ __forceinline__ int float_to_int_exact(float r) {
  return __float_as_int(r + 12582912.0f) - 0x4B400000;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A (16 x 32, row) * B (32 x 8, col) in int32; A and B bytes signed or not
#define FX_MMA(AT, BT)                                                               \
  __device__ __forceinline__ void mma_##AT##_##BT(int* c, const unsigned* a,         \
                                                  const unsigned* b) {               \
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." #AT "." #BT ".s32 "        \
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"           \
                 : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                    \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])); \
  }
FX_MMA(s8, s8)
FX_MMA(s8, u8)
FX_MMA(u8, s8)
FX_MMA(u8, u8)
#undef FX_MMA

// four consecutive lattice integers -> their high bytes and low bytes, packed
__device__ __forceinline__ void split4(float4 v, Fx s, unsigned& hi, unsigned& lo) {
  const int q[4] = {float_to_int_exact(fx_int(v.x, s)), float_to_int_exact(fx_int(v.y, s)),
                    float_to_int_exact(fx_int(v.z, s)), float_to_int_exact(fx_int(v.w, s))};
  hi = 0;
  lo = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi |= (unsigned)((q[i] >> 8) & 255) << (8 * i);
    lo |= (unsigned)(q[i] & 255) << (8 * i);
  }
}

// VEC: K % 4 == 0 and 16-byte aligned bases (16-byte copies)
template <bool VEC>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
fx_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int slice, int tiles_n,
               long long x_bs, long long w_bs, Fx xs_, Fx ws_, Fx os_, double inv_xw) {
  __shared__ __align__(16) float xr[STAGES][BM][LDR];
  __shared__ __align__(16) float wr[STAGES][BN][LDR];
  __shared__ unsigned xh[BM][LDB], xl[BM][LDB];  // byte planes of this chunk
  __shared__ unsigned wh[BN][LDB], wl[BN][LDB];
  __shared__ double part[BM][BN];

  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // K slice
  const int z = blockIdx.z;
  const int m0 = (blockIdx.y / tiles_n) * BM;
  const int n0 = (blockIdx.y % tiles_n) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  x += z * x_bs;
  w += z * w_bs;
  const int k_begin = s * slice;
  const int k_end = min(K, k_begin + slice);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // chunk t of this slice into ring stage t % STAGES, zero past the edges
  auto load = [&](int t) {
    const int st = t % STAGES;
    const int k0 = k_begin + t * BK;
    constexpr int W = VEC ? 4 : 1;  // floats per copy
    constexpr int PER_ROW = BK / W;
#pragma unroll
    for (int i = threadIdx.x; i < (BM + BN) * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * W;
      const bool is_x = r < BM;
      const int rr = is_x ? r : r - BM;
      const int row = (is_x ? m0 : n0) + rr;
      const bool ok = row < (is_x ? M : N) && k0 + c < k_end;
      const float* src = is_x ? x : w;
      if (ok) src += (long long)row * K + k0 + c;
      cp_async<4 * W>(is_x ? &xr[st][rr][c] : &wr[st][rr][c], src, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  int hh[4] = {0, 0, 0, 0}, hl[4] = {0, 0, 0, 0}, lh[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] += 65536.0 * hh[i] + 256.0 * hl[i] + 256.0 * lh[i] + (double)ll[i];
      hh[i] = hl[i] = lh[i] = ll[i] = 0;
    }
  };
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // chunk t has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; chunk t - 1's mma are done
    const int st = t % STAGES;
    // quantize each element once and split it: groups of 4 consecutive k
#pragma unroll
    for (int i = threadIdx.x; i < (BM + BN) * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), q = i % (BK / 4);
      if (r < BM)
        split4(*reinterpret_cast<const float4*>(&xr[st][r][4 * q]), xs_, xh[r][q], xl[r][q]);
      else
        split4(*reinterpret_cast<const float4*>(&wr[st][r - BM][4 * q]), ws_, wh[r - BM][q],
               wl[r - BM][q]);
    }
    // refill the stage quantized in the previous iteration
    if (t + STAGES - 1 < nk) load(t + STAGES - 1);
    cp_async_commit();
    __syncthreads();
    const unsigned ah[4] = {xh[g][tig], xh[g + 8][tig], xh[g][tig + 4], xh[g + 8][tig + 4]};
    const unsigned al[4] = {xl[g][tig], xl[g + 8][tig], xl[g][tig + 4], xl[g + 8][tig + 4]};
    const int n = 8 * warp + g;
    const unsigned bh[2] = {wh[n][tig], wh[n][tig + 4]};
    const unsigned bl[2] = {wl[n][tig], wl[n][tig + 4]};
    mma_s8_s8(hh, ah, bh);
    mma_s8_u8(hl, ah, bl);
    mma_u8_s8(lh, al, bh);
    mma_u8_u8(ll, al, bl);
    if (t % FLUSH == FLUSH - 1) flush();
  }
  cp_async_wait<0>();
  flush();

  // this warp's 16 x 8 slab: rows g and g + 8, columns 2 tig and 2 tig + 1
  const int c = 8 * warp + 2 * tig;
  part[g][c] = acc[0];
  part[g][c + 1] = acc[1];
  part[g + 8][c] = acc[2];
  part[g + 8][c + 1] = acc[3];
  cluster.sync();
  constexpr int SHARE = BM * BN / SPLIT;  // outputs each block finishes
  if (threadIdx.x < SHARE) {
    const int i = s * SHARE + threadIdx.x;
    const int r = i / BN, col = i % BN;
    double sum = 0.0;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) sum += cluster.map_shared_rank(&part[0][0], q)[i];
    const int m = m0 + r, n = n0 + col;
    if (m < M && n < N) {
      // the exact sum, scaled exactly, rounded once to float32 (nearest even)
      const float y = __double2float_rn(sum * inv_xw);
      // through int, as the plain version's int32 representation (no -0.0)
      out[(long long)z * M * N + (long long)m * N + n] = (float)(int)fx_int(y, os_) / os_.scale;
    }
  }
  cluster.sync();
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// x: (B, M, K), w: (*, N, K), out: (B, M, N), all fp32 and contiguous;
// *_bs are batch strides in elements (0 = shared). Each spec is its scale
// 2^f and integer range (at most 16 bits); inv_xw = 2^-(fx + fw).
int fx_gemm_launch(const float* x, const float* w, float* out, int B, int M,
                   int N, int K, long long x_bs, long long w_bs,
                   float x_scale, float x_qmin, float x_qmax,
                   float w_scale, float w_qmin, float w_qmax,
                   float o_scale, float o_qmin, float o_qmax, double inv_xw,
                   void* stream) {
  const int slice = ((K + SPLIT - 1) / SPLIT + 3) & ~3;
  const int tiles_n = (N + BN - 1) / BN;
  const dim3 grid(SPLIT, ((M + BM - 1) / BM) * tiles_n, B);
  const bool vec = K % 4 == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  const Fx xs{x_scale, x_qmin, x_qmax}, ws{w_scale, w_qmin, w_qmax}, os{o_scale, o_qmin, o_qmax};
  if (vec)
    fx_gemm_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, w, out, M, N, K, slice, tiles_n, x_bs, w_bs, xs, ws, os, inv_xw);
  else
    fx_gemm_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, w, out, M, N, K, slice, tiles_n, x_bs, w_bs, xs, ws, os, inv_xw);
  return (int)cudaGetLastError();
}

const char* fx_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
