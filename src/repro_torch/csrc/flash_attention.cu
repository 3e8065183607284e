// FlashAttention for Hopper (sm_90a): online-softmax attention with GQA and
// an optional causal mask, the LM serving path's prefill and encoder
// attention.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _kernel). Computes, for every batch b and query
// head h (reading KV head h / (Hq / Hkv), no KV copy),
//
//     o[b, h] = softmax(q[b, h] k[b, hk]^T / sqrt(D), masked) v[b, hk]
//
// the Pallas kernel's function, not its block structure: q, k and v are
// upcast to fp32; the scores, the running max m, the denominator l and the
// accumulator stay fp32; masked scores are the finite NEG_INF = -1e30 (never
// -inf, whose rescale would give inf - inf = NaN); l == 0 becomes 1; the
// output is rounded to q's type (round to nearest even for bf16). The
// causal mask is q_idx >= k_idx, aligned top-left as in the Pallas kernel.
//
// Beyond the Pallas kernel (whose wrapper pads S and Sk to 128-multiples and
// lets padded keys into a non-causal softmax): ragged S and Sk are masked
// here, so padded keys never get weight; any head dim D from 1 to 256; and
// every operand is addressed through its own (batch, sequence, head)
// strides with a unit head-dim stride, so the model passes (B, S, H, D)
// activations without a transpose copy.
//
// Design: one block of 256 threads per (64 query rows, batch x query
// head). The Pallas kernel's sequential KV grid axis becomes a loop inside
// the block over 64-key tiles staged in shared memory (fp32, rows padded
// to an odd length so the 16 lanes that read one column of 16 rows hit 16
// banks). A thread owns 4 query rows x 4 keys of each score tile and the
// same 4 rows x D/16 columns of the output, so m, l and the accumulator
// live in registers; a row's max and sum reduce over its 16 lanes with
// warp shuffles, and the probabilities pass through shared memory to the
// P.V product. Causal blocks stop at the diagonal (the tiles past it have
// zero weight exactly) and run heaviest first. The head dim is a template
// bound (64, 128 or 256, zero-padded), which sets the shared memory: 66 KB,
// 115 KB and 214 KB, above the 48 KB default, so each instantiation raises
// its dynamic shared-memory limit before its first launch on each device.
//
// Bound: at the TinyLlama prefill shape (B 4, Hq 32, Hkv 4, S = Sk = 1024,
// D 64, bf16, causal) the operations bound it: Q.K^T of bf16 inputs is
// exact on the bf16 tensor cores (989 TFLOP/s, 0.009 ms), but P.V
// multiplies fp32 probabilities, exact at the fp32 rate (67 TFLOP/s,
// 0.128 ms); the two units run side by side, so 0.128 ms against 0.011 ms
// for the 38 MB moved. This kernel runs every product as an fp32 FMA on the
// CUDA cores. The later design: wgmma for both products (Q.K^T in bf16;
// P.V with P split into three bf16 terms, exact, or rounded to bf16 where
// a caller accepts it), TMA-staged K/V tiles and warp-specialised
// producer/consumer warpgroups (FlashAttention-3). With the three-term
// split every product runs on the tensor cores, and the bound drops to
// 0.035 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per staged tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 1;      // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

//: element strides of a (B, S, H, D) operand; the D stride is 1
struct Strides {
  long long b, s, h;
};

constexpr size_t smem_bytes(int dmax) {
  return sizeof(float) * ((size_t)BQ * (dmax + 1) + (size_t)BK * (dmax + 1) +
                          (size_t)BK * dmax + (size_t)BQ * PLD);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides qs,
                       Strides ks, Strides vs, Strides os, int Hq, int Hkv,
                       int S, int Sk, int D, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NJ = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* k_s = q_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][DMAX]
  float* p_s = v_s + BK * DMAX;  // [BQ][PLD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int tx = threadIdx.x % 16;  // keys tx + 16 j, output columns tx + 16 jj
  const int ty = threadIdx.x / 16;  // query rows ty + 16 i

  for (int e = threadIdx.x; e < BQ * DMAX; e += THREADS) {
    const int r = e / DMAX, c = e % DMAX;
    q_s[r * LD + c] = (q0 + r < S && c < D) ? to_f32(qb[(q0 + r) * qs.s + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < BK * DMAX; e += THREADS) {
      const int r = e / DMAX, c = e % DMAX;
      const bool in = k0 + r < Sk && c < D;
      k_s[r * LD + c] = in ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.0f;
      v_s[r * DMAX + c] = in ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool masked = kj >= Sk || (causal && qi < kj);
        s[i][j] = masked ? NEG_INF : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        p_s[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = v_s[kk * DMAX + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) store(ob + qi * os.s + c, acc[i][jj] / li);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int Hq, int Hkv, int S,
           int Sk, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DMAX);
  // the limit holds per device: one setting per instantiation and device,
  // made before its first launch there (outside any CUDA-graph capture,
  // which the callers warm up before). Two threads that race here both set
  // it, which is harmless; devices past the mask's 64 set it every time.
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(configured.load() & bit) || bit == 0) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured.fetch_or(bit);
  }
  dim3 grid(B * Hq, (S + BQ - 1) / BQ, 1);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, qs, ks, vs, os, Hq, Hkv, S,
      Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, Strides qs,
             Strides ks, Strides vs, Strides os, int B, int Hq, int Hkv, int S,
             int Sk, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, Sk, D, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, Sk, D, scale, causal, stream);
  return launch<T, 256>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, Sk, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns the cudaError_t of the launch (0 = ok).
// q: (B, S, Hq, D), k and v: (B, Sk, Hkv, D), o: (B, S, Hq, D), each given
// by its (batch, sequence, head) element strides with a unit D stride;
// dtype 0 is float32, 1 bfloat16 (all four tensors alike).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int dtype, int B, int Hq, int Hkv, int S, int Sk, int D,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_ss, long long o_sh,
                           float scale, int causal, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Sk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, Sk, D, scale, causal, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, Sk, D, scale,
                                 causal, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
