// AdaptivFloat quantized GEMM for Hopper (sm_90a): FlexASR's PE array.
//
// Replaces the Pallas TPU kernel repro/kernels/af_gemm.py (af_gemm, body
// _kernel, quantizer _af_quant). Computes, per batch entry z,
//
//     out[z] = AFq_o(AFq_x(x[z]) @ AFq_w(w[z])^T + b[z])
//
// in AdaptivFloat(n_bits, n_exp) with per-tensor exponent biases (one per
// sample where the caller gives one), fp32 sums in the reference's order
// and a bias + re-quantization epilogue. The fused FlexASR runner's whole group (B = 8:
// per-sample activation and output biases, one weight tensor) is one call;
// the Executor's kernel mode is the same call with B = 1. A batch stride of
// 0 shares an operand across the batch. Callers pass unpadded tensors.
//
// Two launches per call, in stream order:
//
// 1. af_quant_kernel quantizes every element of x (B, M, K) and of w once:
//    one block per 32 x 32 tile, four independent elements per thread, read
//    along K, turned in shared memory and written k-major into fp32
//    scratch, (B, K, Mp) and (*, K, Np), rows padded to multiples of 4 by
//    zeros (AFq(0) == 0). w gets one copy, or one per sample when its bias
//    is per-sample.
// 2. af_product_kernel reads only lattice values: K tiles of 32 rows staged
//    with 16-byte cp.async two stages deep (the next tile's copy in flight
//    during this tile's FMAs); each thread owns 2x2 outputs and per k reads
//    one 8-byte pair of x (the same for a warp's lanes) and one of w
//    (consecutive across lanes), a shared-memory wavefront each for four
//    fp32 FMAs per lane; then b[n] and the output quantizer on its 4
//    outputs at once. The tile is 32x32 where that gives at least 132 blocks (a fused
//    group: 256 blocks at B = 8), else 16x16, else 8x8 (kernel mode: 16,
//    32, 16 and 2 blocks for ResMLP's tok, fc1, fc2 and head).
//
// Two launches rather than one cooperative launch behind a grid barrier:
// the product reads every quantized row of its tile, so it waits for the
// whole pass either way, and the stream orders two launches with nothing
// co-resident to guarantee; a CUDA graph replays them back to back.
//
// Sum order: the reference's Pallas kernel, compiled by XLA for the CPU.
// It pads K to a multiple of 128 and adds each 128-wide block's dot into
// an fp32 total; XLA's CPU dot at 128 x 128 x 128 is acc = 0, then acc =
// fma(xq[k], wq[k], acc) for k ascending, bit for bit. So each output is
// that fp32 __fmaf_rn chain, restarted at 0 every 128 k (the stage loop
// folds it into the total every 128 / BK tiles; a padded k would add
// fma(0, 0, acc): acc, but +0 for a -0 acc, added once where a block is
// short), then __fadd_rn(total, b[n]), every result with
// denormals flushed to zeros of their sign as XLA's CPU code runs. Where
// the grid is one block (B = 1, M, N and K at most 128) XLA simplifies
// 0 + acc to acc, so the total is the first block's acc itself: only the
// sign of a zero sum depends on it. The plain version
// (kernels/ref.py::af_block_sums) is the same chain in tensor ops, exact
// FMAs included. No split-K and no mma/wgmma: the tensor cores do not sum
// in this order. Nor would they pay: a fused B = 8 group is 67 MFLOP over
// 1.70 MB, 39 FLOP per byte, far below the ~295 at which the bf16 tensor
// cores and not the memory bound an H100; at the 67 TFLOP/s fp32 rate its
// products take 1.0 us.
//
// The quantizer is the plain version's (repro_torch/accel/numerics.py::
// af_quantize), which is the reference's as XLA compiles it for the CPU,
// operation for operation, in its compiled form (numerics.tier): the
// exponent floor(log_f32(x) * float32(1 / ln 2)), every power of two
// exp2_ref(e) = exp_f32(float32(ln 2) * e) (an ulp or more off 2^e at most
// e outside [-12, 12], 0 at e <= -126), the mantissa ax * exp2_neg(e) =
// ax * exp_f32(-(float32(ln 2) * e)) (XLA rewrites the reference's ax /
// exp2(e) into that product; finite where exp2_ref(e) is 0, down to a
// window top of -127), rintf (round half to even), the exponent clamp,
// the mantissa clamp and its bump to 2.0, saturation at the top and the
// flush below vmin / 2, with denormals read and written as zeros of their
// sign, jnp.sign's +-0 and NaN, and NaN carried through every clamp and
// minimum as torch carries it. A window's 2^n_exp powers and their
// reciprocals, vmax and flush point are computed once per block into
// shared memory (Window), as the plain version reads them from tables of
// exp2_ref and exp2_neg at the integers. log_f32 and exp_f32 are Cephes's polynomials
// as XLA's CPU code evaluates them: __fmaf_rn exactly where that code
// fuses a multiply-add, __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
// everywhere else, so that -fmad=true (which the product loop keeps)
// contracts nothing else. No logf, expf, exp2f or ldexpf: IEEE operations
// round alike on the card and on the CPU.
//
// Bound: a fused B = 8 group reads 0.52 MB of x, 0.13 MB of w and writes
// 1.05 MB of output; 1.70 MB at 3.35 TB/s is 0.51 us, and the bytes bound
// it (the products take 0.07 us on the bf16 tensor cores, where AF(8,3)
// values are exact). What sets the pace is latency and instruction count:
// a quantization is ~80 dependent instructions (the log polynomial), so it
// runs once per element across the whole card with 4
// independent elements per thread, and the product runs one 8-byte shared
// load per two FMAs over 4 outputs per thread and at least 132 blocks.
// Each of the two launches then costs about what a launch of a small
// kernel costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;                 // quantize pass: QT x QT tiles,
constexpr int QTHREADS = QT * QT / 4;  // 4 elements per thread
constexpr int BK = 32;         // product: K rows staged per cp.async stage
constexpr int AF_BK = 128;     // the reference's K block (kernels/ref.py AF_BK)
static_assert(AF_BK % BK == 0, "a K block is whole stages");
constexpr int STAGES = 2;      // product: cp.async ring depth
constexpr int MAX_N_EXP = 5;   // exponent field bits (kernels/af_gemm.py checks)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);  // NaN stays NaN, as in torch.clamp
}
__device__ __forceinline__ float minf(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);  // NaN wins, as in torch.minimum
}
// denormals as zeros of their sign, as XLA's CPU code reads and writes them
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 0x1p-126f ? copysignf(0.0f, x) : x;
}
// 2^n for n in [-126, 127], from the exponent bits
__device__ __forceinline__ float pow2i(int n) { return __int_as_float((n + 127) << 23); }

// Cephes's constants as Eigen's plog_float / pexp_float hold them (numerics.py
// names each), from their bits
#define F32(b) __int_as_float(b)
#define LOG_P0 0x3d9021bb
#define LOG_P1 0xbdebd1b8
#define LOG_P2 0x3def251a
#define LOG_P3 0xbdfe5d4f
#define LOG_P4 0x3e11e9bf
#define LOG_P5 0xbe2aae50
#define LOG_P6 0x3e4cceac
#define LOG_P7 0xbe7ffffc
#define LOG_P8 0x3eaaaaaa
#define EXP_P0 0x39506967
#define EXP_P1 0x3ab743ce
#define EXP_P2 0x3c088908
#define EXP_P3 0x3d2aa9c1
#define EXP_P4 0x3e2aaaaa
#define SQRTHF 0x3f3504f3
#define LN2_LO 0xb95e8083
#define LN2_HI 0x3f318000
#define INV_LN2 0x3fb8aa3b
#define LN2 0x3f317218
#define EXP_LO 0xc2af999a  // -87.8
#define EXP_HI 0x42b1999a  // 88.8

// numerics.log_f32: XLA's CPU log
__device__ float log_f32(float x) {
  x = flush(x);
  const int bits = __float_as_int(fmaxf(x, 0x1p-126f));
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x807fffff) | 0x3f000000);  // [0.5, 1)
  const bool low = m < F32(SQRTHF);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z2 = __fmul_rn(z, z), z3 = __fmul_rn(z2, z);
  float y = __fmaf_rn(z, F32(LOG_P0), F32(LOG_P1));
  float y1 = __fmaf_rn(z, F32(LOG_P3), F32(LOG_P4));
  float y2 = __fmaf_rn(z, F32(LOG_P6), F32(LOG_P7));
  y = __fmaf_rn(y, z, F32(LOG_P2));
  y1 = __fmaf_rn(y1, z, F32(LOG_P5));
  y2 = __fmaf_rn(y2, z, F32(LOG_P8));
  y = __fmaf_rn(y, z3, y1);
  y = __fmaf_rn(y, z3, y2);
  y = __fmaf_rn(y, z3, __fmul_rn(e, F32(LN2_LO)));
  float r = __fadd_rn(__fsub_rn(z, __fmul_rn(0.5f, z2)), y);
  r = __fadd_rn(r, __fmul_rn(e, F32(LN2_HI)));
  if (x < 0.0f || x != x) r = __int_as_float(0x7fc00000);
  if (x == __int_as_float(0x7f800000)) r = x;
  if (x == 0.0f) r = __int_as_float(0xff800000);
  return r;
}

// numerics.exp_f32: XLA's CPU exp
__device__ float exp_f32(float x) {
  x = clampf(x, F32(EXP_LO), F32(EXP_HI));
  const float n = clampf(floorf(__fmaf_rn(x, F32(INV_LN2), 0.5f)), -127.0f, 127.0f);
  float r = __fsub_rn(x, __fmul_rn(n, F32(LN2_HI)));
  r = __fmaf_rn(n, -F32(LN2_LO), r);
  float y = __fmaf_rn(r, F32(EXP_P0), F32(EXP_P1));
  y = __fmaf_rn(y, r, F32(EXP_P2));
  y = __fmaf_rn(y, r, F32(EXP_P3));
  y = __fmaf_rn(y, r, F32(EXP_P4));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fmaf_rn(y, __fmul_rn(r, r), r);
  y = __fadd_rn(y, 1.0f);
  return flush(__fmul_rn(y, __int_as_float(((int)n + 127) << 23)));
}

// numerics.exp2_ref: jnp.exp2 as XLA computes it
__device__ __forceinline__ float exp2_ref(float e) { return exp_f32(__fmul_rn(e, F32(LN2))); }
// numerics.exp2_neg: exp(-B) for B = e * ln 2, what XLA multiplies by in
// place of a division by exp2(e)
__device__ __forceinline__ float exp2_neg(float e) { return exp_f32(-__fmul_rn(e, F32(LN2))); }

// One exponent window's constants, computed once per block in shared
// memory: its 2^n_exp powers exp2_ref(e_lo + i) and their reciprocals
// exp2_neg(e_lo + i), the plain version's tables (numerics.exp2_ref_int,
// exp2_neg_int) at the window's exponents, and what comes of them.
struct Window {
  float scale[1 << MAX_N_EXP];
  float rscale[1 << MAX_N_EXP];
  float e_lo, e_hi, last, top, p, inv_p, vmax, flush;
};

// Every thread of the block calls it; the powers are spread over the threads.
__device__ void af_window(Window& w, float e_lo, int n_exp, int n_man) {
  const int last = (1 << n_exp) - 1;
  for (int i = threadIdx.x; i <= last; i += blockDim.x) {
    const float e = __fadd_rn(e_lo, (float)i);
    const float s = exp2_ref(e);
    w.scale[i] = s;
    w.rscale[i] = exp2_neg(e);
    if (i == 0) w.flush = flush(__fmul_rn(s, 0.5f));
    if (i == last) w.vmax = __fmul_rn(__fsub_rn(2.0f, pow2i(-n_man)), s);
  }
  if (threadIdx.x == 0) {
    w.e_lo = e_lo;
    w.e_hi = __fadd_rn(e_lo, (float)last);
    w.last = (float)last;
    w.top = __fsub_rn(2.0f, pow2i(-n_man));
    w.p = pow2i(n_man);
    w.inv_p = pow2i(-n_man);
  }
  __syncthreads();
}

// table[e - e_lo] for e in [e_lo, e_hi] (a NaN or an infinite window reads
// its first entry: every entry is then the same)
__device__ __forceinline__ float power(const Window& w, const float* table, float e) {
  return table[(int)fminf(fmaxf(__fsub_rn(e, w.e_lo), 0.0f), w.last)];
}

__device__ float af_quant(float x, const Window& w) {
  x = flush(x);
  const float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : x);  // jnp.sign
  const float ax = fabsf(x);
  const float safe = ax > 0.0f ? ax : 1.0f;
  const float e = clampf(floorf(__fmul_rn(log_f32(safe), F32(INV_LN2))), w.e_lo, w.e_hi);
  const float man = clampf(flush(__fmul_rn(ax, power(w, w.rscale, e))), 1.0f, w.top);
  float man_q = __fmul_rn(rintf(__fmul_rn(man, w.p)), w.inv_p);
  const bool bump = man_q >= 2.0f;
  const float e2 = clampf(__fadd_rn(e, bump ? 1.0f : 0.0f), w.e_lo, w.e_hi);
  man_q = (bump && e2 > e) ? 1.0f : minf(man_q, w.top);
  float q = minf(__fmul_rn(man_q, power(w, w.scale, e2)), w.vmax);
  if (ax < w.flush) q = 0.0f;
  return __fmul_rn(sign, q);
}

__device__ __forceinline__ float4 af_quant4(float4 v, const Window& w) {
  return make_float4(af_quant(v.x, w), af_quant(v.y, w), af_quant(v.z, w), af_quant(v.w, w));
}

// One operand of the quantize pass: rows of K in src (batch stride src_bs,
// 0 = shared), `rows` rows per sample; dst holds the transpose, rows of k
// with `rows` padded to rows4 (a multiple of 4) by zeros.
struct Operand {
  const float* src;
  float* dst;
  const float* bias;
  long long src_bs;
  int rows;
  int rows4;
  int bias_bs;
  int tiles;  // QT x QT tiles: samples * ceil(rows4 / QT) * ceil(K / QT)
};

// One block per QT x QT tile of (rows, k) of one sample: each thread reads
// and quantizes 4 consecutive k of one row (coalesced along K), the tile
// turns in shared memory, and each thread writes 4 consecutive rows of one
// k (coalesced along the rows).
__global__ void __launch_bounds__(QTHREADS)
af_quant_kernel(Operand a, Operand b, int K, int n_exp, int n_man, bool vec) {
  __shared__ float tile[QT][QT + 1];  // [k][row]
  int t = blockIdx.x;
  Operand o = a;
  if (t >= a.tiles) {
    t -= a.tiles;
    o = b;
  }
  const int tk = (K + QT - 1) / QT, tr = (o.rows4 + QT - 1) / QT;
  const int k0 = (t % tk) * QT;
  t /= tk;
  const int r0 = (t % tr) * QT;
  const int z = t / tr;
  __shared__ Window win;
  af_window(win, o.bias[z * o.bias_bs], n_exp, n_man);
  {
    const int r = threadIdx.x / (QT / 4), c = 4 * (threadIdx.x % (QT / 4));
    const int row = r0 + r, k = k0 + c;
    const float* s = o.src + z * o.src_bs + (long long)row * K + k;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < o.rows) {
      if (vec && k < K) {
        v = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        v.x = k < K ? __ldg(s) : 0.0f;
        v.y = k + 1 < K ? __ldg(s + 1) : 0.0f;
        v.z = k + 2 < K ? __ldg(s + 2) : 0.0f;
        v.w = k + 3 < K ? __ldg(s + 3) : 0.0f;
      }
    }
    const float4 q = af_quant4(v, win);
    tile[c][r] = q.x;
    tile[c + 1][r] = q.y;
    tile[c + 2][r] = q.z;
    tile[c + 3][r] = q.w;
  }
  __syncthreads();
  const int kk = threadIdx.x / (QT / 4), c = 4 * (threadIdx.x % (QT / 4));
  if (k0 + kk < K && r0 + c < o.rows4)
    *reinterpret_cast<float4*>(o.dst + ((long long)z * K + k0 + kk) * o.rows4 + r0 + c) =
        make_float4(tile[kk][c], tile[kk][c + 1], tile[kk][c + 2], tile[kk][c + 3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// xq: (B, K, Mp) and wq: (*, K, Np) lattice values, k-major, Mp and Np
// multiples of 4. Thread (tx, ty) owns rows 2ty, 2ty+1 and columns 2tx,
// 2tx+1 of the tile: per k one 8-byte load of x (the same for the warp's
// lanes of one ty) and one of w (consecutive across lanes), 4 FMAs.
// one_block: the grid is one 128-cube block (see "Sum order").
template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 4)
af_product_kernel(const float* __restrict__ xq, const float* __restrict__ wq,
                  const float* __restrict__ b, const float* __restrict__ bo,
                  float* __restrict__ out, int M, int N, int K, int Mp, int Np,
                  long long wq_bs, long long b_bs, int bo_bs, int n_exp, int n_man,
                  int one_block) {
  constexpr int T = BM * BN / 4;
  constexpr int TX = BN / 2;
  constexpr int VX = BM / 4, VW = BN / 4;  // 16-byte vectors per row of a tile
  __shared__ __align__(16) float xs[STAGES][BK][BM];
  __shared__ __align__(16) float ws[STAGES][BK][BN];

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  xq += (long long)z * K * Mp;
  wq += z * wq_bs;
  b += z * b_bs;
  out += (long long)z * M * N;
  __shared__ Window win;  // the output's, ready before the loop's first sync
  af_window(win, bo[z * bo_bs], n_exp, n_man);

  // chunk t (rows t*BK.. of K) into ring stage t % STAGES, zero past the edges
  auto load = [&](int t) {
    const int st = t % STAGES, k0 = t * BK;
#pragma unroll
    for (int i = threadIdx.x; i < BK * (VX + VW); i += T) {
      const int r = i / (VX + VW), c = 4 * (i % (VX + VW));
      const bool is_x = c < BM;
      const int col = is_x ? m0 + c : n0 + c - BM;
      const bool ok = k0 + r < K && col < (is_x ? Mp : Np);
      const float* src = is_x ? xq : wq;
      if (ok) src += (long long)(k0 + r) * (is_x ? Mp : Np) + col;
      cp_async16(is_x ? &xs[st][r][c] : &ws[st][r][c - BM], src, ok ? 16 : 0);
    }
  };

  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float total[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();  // chunk t has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; chunk t - 1 is consumed
    if (t + STAGES - 1 < nk) load(t + STAGES - 1);  // into chunk t - 1's stage
    cp_async_commit();
    const int s = t % STAGES;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&xs[s][k][2 * ty]);
      const float2 w2 = *reinterpret_cast<const float2*>(&ws[s][k][2 * tx]);
      acc[0][0] = flush(__fmaf_rn(a.x, w2.x, acc[0][0]));
      acc[0][1] = flush(__fmaf_rn(a.x, w2.y, acc[0][1]));
      acc[1][0] = flush(__fmaf_rn(a.y, w2.x, acc[1][0]));
      acc[1][1] = flush(__fmaf_rn(a.y, w2.y, acc[1][1]));
    }
    // the end of a 128-wide block of k (or of K): into the total, restart
    if ((t + 1) % (AF_BK / BK) == 0 || t == nk - 1) {
      // a block short of 128 ends with the reference's padded k, fma(0, 0,
      // acc): +0 for a -0 acc (the zero-filled rows of a short stage
      // already did it)
      const float pad = (t == nk - 1 && K % AF_BK != 0) ? 0.0f : -0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], pad);
          total[i][j] = one_block ? acc[i][j] : flush(__fadd_rn(total[i][j], acc[i][j]));
          acc[i][j] = 0.0f;
        }
    }
  }
  cp_async_wait<0>();

  // + b[n] (read with denormals as zero), then the output quantizer on the
  // 4 outputs at once
  const int m = m0 + 2 * ty, n = n0 + 2 * tx;
  const float b0 = n < N ? flush(b[n]) : 0.0f, b1 = n + 1 < N ? flush(b[n + 1]) : 0.0f;
  const float4 y = af_quant4(make_float4(flush(__fadd_rn(total[0][0], b0)),
                                         flush(__fadd_rn(total[0][1], b1)),
                                         flush(__fadd_rn(total[1][0], b0)),
                                         flush(__fadd_rn(total[1][1], b1))),
                             win);
  if (m < M) {
    if (n < N) out[(long long)m * N + n] = y.x;
    if (n + 1 < N) out[(long long)m * N + n + 1] = y.y;
  }
  if (m + 1 < M) {
    if (n < N) out[(long long)(m + 1) * N + n] = y.z;
    if (n + 1 < N) out[(long long)(m + 1) * N + n + 1] = y.w;
  }
}

template <int BM, int BN>
long long n_blocks(int B, int M, int N) {
  return (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM) * B;
}

template <int BM, int BN>
int launch_product(const float* xq, const float* wq, const float* b, const float* bo,
                   float* out, int B, int M, int N, int K, int Mp, int Np, long long wq_bs,
                   long long b_bs, int bo_bs, int n_exp, int n_man, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, B);
  const int one_block = B == 1 && M <= AF_BK && N <= AF_BK && K <= AF_BK;
  af_product_kernel<BM, BN><<<grid, BM * BN / 4, 0, stream>>>(
      xq, wq, b, bo, out, M, N, K, Mp, Np, wq_bs, b_bs, bo_bs, n_exp, n_man, one_block);
  return (int)cudaGetLastError();
}

constexpr long long SMS = 132;  // an H100 SXM's streaming multiprocessors

}  // namespace

extern "C" {

// Launches the two kernels on ``stream``; returns the first cudaError_t
// (0 = ok). x: (B, M, K), w: (*, N, K), b: (*, N), out: (B, M, N), all fp32
// and contiguous; *_bs are batch strides in elements (0 = shared).
// Scratch, k-major: xq holds B * K * Mp floats and wq Bq * K * Np, Mp and
// Np = M and N rounded up to 4, Bq = 1 when w and its bias are both shared,
// else B.
int af_gemm_launch(const float* x, const float* w, const float* b,
                   const float* bx, const float* bw, const float* bo,
                   float* out, float* xq, float* wq, int B, int M, int N, int K,
                   long long x_bs, long long w_bs, long long b_bs,
                   int bx_bs, int bw_bs, int bo_bs, int n_exp, int n_man,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int Mp = (M + 3) & ~3, Np = (N + 3) & ~3;
  const int Bq = (w_bs == 0 && bw_bs == 0) ? 1 : B;
  const long long wq_bs = Bq == 1 ? 0 : (long long)K * Np;
  const int tk = (K + QT - 1) / QT;
  const Operand xo{x, xq, bx, x_bs, M, Mp, bx_bs, B * ((Mp + QT - 1) / QT) * tk};
  const Operand wo{w, wq, bw, w_bs, N, Np, bw_bs, Bq * ((Np + QT - 1) / QT) * tk};
  const bool vec = K % 4 == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  if (xo.tiles + wo.tiles > 0) {
    af_quant_kernel<<<xo.tiles + wo.tiles, QTHREADS, 0, st>>>(xo, wo, K, n_exp, n_man, vec);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (n_blocks<32, 32>(B, M, N) >= SMS)
    return launch_product<32, 32>(xq, wq, b, bo, out, B, M, N, K, Mp, Np, wq_bs, b_bs,
                                  bo_bs, n_exp, n_man, st);
  if (n_blocks<16, 16>(B, M, N) >= SMS)
    return launch_product<16, 16>(xq, wq, b, bo, out, B, M, N, K, Mp, Np, wq_bs, b_bs,
                                  bo_bs, n_exp, n_man, st);
  return launch_product<8, 8>(xq, wq, b, bo, out, B, M, N, K, Mp, Np, wq_bs, b_bs, bo_bs,
                              n_exp, n_man, st);
}

const char* af_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
