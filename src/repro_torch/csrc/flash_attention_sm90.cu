// FlashAttention on Hopper's tensor cores (sm_90a): the wgmma designs of
// the LM serving path's attention, for bf16 inputs (T = 1) and for fp32
// inputs (T = 3, each operand as three bf16 terms).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _kernel) for bfloat16 and float32 q, k, v. It
// computes the Pallas kernel's function, for every batch b and query head h
// (reading KV head h / (Hq / Hkv), no KV copy),
//
//     o[b, h] = softmax(q[b, h] k[b, hk]^T * scale, masked) v[b, hk]
//
// with every product exact or below fp32's own rounding, and only the
// order of the fp32 sums changed:
//
// * bf16 inputs: S = Q.K^T on wgmma m64nNk16 f32.bf16.bf16: a bf16 x bf16
//   product is exact in fp32, and the accumulator is fp32.
// * fp32 inputs: a split pass (split3_kernel, a launch of its own) writes
//   each of q, k and v as three bf16 terms, hi = bf16(x), mid = bf16(x -
//   hi), lo = bf16(x - hi - mid), whose sum is x exactly (24 significant
//   bits in three pieces of 8, for |x| >= 2^-110), into scratch laid out
//   (3, B, H, L, DP8) (DP8: D rounded up to 8), the term first, so the
//   tensor maps below read the terms as a batch of 3 B. The kernel then
//   takes S = sum over i + j <= 2 of Q_i.K_j^T, six wgmmas into one fp32
//   accumulator, and P.V = sum over i + j <= 2 of P_i.V_j, six register-A
//   wgmmas. The three pairs it drops (mid.lo, lo.mid, lo.lo) each weigh at
//   most 2^-24 |a||b|: |mid| <= 2^-8 |a| and |lo| <= 2^-16 |a| (round to
//   nearest on 8 significant bits, bounded by a power of two), which is
//   below fp32's own rounding of the sum they belong to.
//   tests/test_torch_flash.py checks the bound on seeded inputs.
// * P stays fp32, as in the Pallas kernel (which upcasts q, k, v and runs
//   both products in fp32). Each p is cut in registers into three bf16
//   terms the same way, whose sum is p exactly (for p >= 2^-110; below,
//   lo falls on bf16's subnormal grid and the sum is within 2^-134 of p).
//   For bf16 inputs P.V is three register-A wgmmas (A = a term, B = the V
//   tile read transposed from shared memory) into one fp32 accumulator:
//   each product hi*v, mid*v, lo*v is exact in fp32.
// * Masked and padded scores are the finite NEG_INF = -1e30; the causal
//   mask is q_idx >= k_idx, aligned top-left; the running max m and
//   denominator l are fp32, l == 0 -> 1; the output is rounded to bf16,
//   nearest even (bf16 inputs) or written in fp32; ragged S and Sk are
//   masked, so padded keys get no weight; operands and output are
//   addressed through their (batch, sequence, head) strides. The scores
//   are kept in log2 units (scale * log2(e) folded into one FFMA) and
//   exponentiated with ex2.approx (relative error about 2^-22): the same
//   function as exp(s - m) up to that rounding, inside the fp32 tolerance.
//
// Design. One block per (64 NC query rows, batch x query head): warpgroup
// 0 is the producer (one thread issues every copy; with two consumers the
// group gives its registers away with setmaxnreg), warpgroups 1..NC are
// the consumers, 64 query rows each, with S, m, l and O in registers. The
// producer copies the Q tile (all its terms) once and then K and V tiles
// of BK keys into a ring of 2-4 stages with TMA (cp.async.bulk.tensor,
// completion on mbarriers). The tensor maps are built on the host over the
// operands' (B, S, H, D) strides with the 128-byte swizzle that the wgmma
// shared-memory descriptors read; TMA's out-of-bounds zero fill pads
// ragged S and Sk and pads D up to DP, a multiple of 64 (so 112 reads as
// 128). Each consumer warp releases a stage with one arrive once its
// products are done. Causal blocks stop at the diagonal (the tiles past
// it have zero weight exactly) and run heaviest first. Within a consumer
// the products and the softmax take turns; the consumers overlap each
// other.
//
// Tiles (Cfg). The Q terms and two K/V stages must fit 220 KB of shared
// memory: Cfg takes the first of (NC 2, BK 64), (2, 32), (1, 64), (1, 32),
// (1, 16) that does. bf16 takes (2, 64) at every head dim. fp32 takes
// (2, 64) at DP 64 (48 KB of Q terms, three 48 KB stages), (2, 32) at DP
// 128, (1, 32) at DP 192 and (1, 16) at DP 256.
//
// Registers. With two consumers ptxas allocates for the 168 registers a
// thread of a 384-thread block starts with, and serialises the wgmmas of
// a tile (its warning C7512) when O (DP/2 a thread), the three P terms
// (3 BK/4) and the scores (BK/2) do not fit beside the addressing. In
// bf16, at DP 64 and 128 they fit: no spills, no serialisation; at DP 192
// the wgmmas are serialised, at DP 256 serialised with spills. Both still
// take the bf16 head dims of MLA (192) and Gemma (256) here. The fp32
// instantiations hold the same S, P terms and O as bf16 at DP 64 and
// fewer at the larger head dims (their K tiles are narrower); one
// consumer leaves a thread 255 registers. chip_smoke.py reports the
// registers, spills, serialisation and HGMMA count of every
// instantiation. Tiles of 128 keys, and issuing the next tile's Q.K^T
// before P.V so a consumer's softmax overlaps its own products
// (FlashAttention-3), were both measured slower than this at the
// TinyLlama shape in bf16: they need more registers than 168 and ptxas
// serialises them.
//
// cuTensorMapEncodeTiled, a libcuda function, is looked up with
// cudaGetDriverEntryPoint, so the library links no -lcuda.
//
// Bound: at the TinyLlama prefill shape (B 4, Hq 32, Hkv 4, S = Sk = 1024,
// D 64, causal) the bf16 design's four GEMM-equivalents (Q.K^T and three
// P.V) over the kept score pairs take 0.035 ms at the bf16 tensor-core
// rate, above the 0.011 ms it takes to move the 38 MB of q, k, v and o;
// the fp32 design's twelve (six pairs each for Q.K^T and P.V) take 0.104
// ms, above the 0.0225 ms of its 75.5 MB. The split pass moves 105 MB
// (0.031 ms at 3.35 TB/s). The softmax and the split of P (about ten
// fp32 instructions per score, one ex2 and three bf16 conversions for
// every two) run on the CUDA cores and the special-function unit beside
// them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 220 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;

// K/V stages of bk keys that fit beside the T terms of a Q tile of 64 nc rows
constexpr int fit_stages(int T, int DP, int nc, int bk) {
  return (SMEM_LIMIT - T * nc * 64 * DP * 2) / (2 * T * bk * DP * 2);
}

// the tiles of head dim DP (a multiple of 64) with T bf16 terms per operand:
// the first of (two consumer warpgroups, 64-key tiles), (2, 32), (1, 64),
// (1, 32), (1, 16) whose ring holds two stages
template <int DP, int T>
struct Cfg {
  static constexpr int PICK = fit_stages(T, DP, 2, 64) >= 2   ? 0
                              : fit_stages(T, DP, 2, 32) >= 2 ? 1
                              : fit_stages(T, DP, 1, 64) >= 2 ? 2
                              : fit_stages(T, DP, 1, 32) >= 2 ? 3
                                                              : 4;
  static constexpr int NC = PICK <= 1 ? 2 : 1;              // consumer warpgroups
  static constexpr int BK = PICK == 0 || PICK == 2 ? 64 : PICK == 4 ? 16 : 32;  // keys per tile
  static constexpr int BQ = 64 * NC;                        // query rows per block
  static constexpr int THREADS = 128 * (NC + 1);            // + the producer warpgroup
  static constexpr int CHUNKS = DP / 64;                    // 64-column (128-byte) chunks
  static constexpr int Q_BYTES = BQ * DP * 2;               // one term of the Q tile
  static constexpr int KV_BYTES = BK * DP * 2;              // one term of a K or V tile
  static constexpr int STAGE_BYTES = 2 * T * KV_BYTES;      // K terms, then V terms
  static constexpr int FIT = fit_stages(T, DP, NC, BK);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + T * Q_BYTES + STAGES * STAGE_BYTES;  // + alignment slack
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
};

// the T (T + 1) / 2 pairs (i, j) of terms with i + j < T, largest first:
// (0, 0), then (0, 1), (1, 0), then (0, 2), (1, 1), (2, 0)
__host__ __device__ constexpr int pair_a(int pr) { return pr == 2 || pr == 4 ? 1 : pr == 5 ? 2 : 0; }
__host__ __device__ constexpr int pair_b(int pr) { return pr == 1 || pr == 4 ? 1 : pr == 3 ? 2 : 0; }

struct Params {
  int B, S, Sk, Hq, group;       // group = Hq / Hkv
  int causal;
  float scale_log2;              // scale * log2(e)
  int q_slot[3], k_slot[3], v_slot[3];   // tensor-map coordinates of head, seq, batch
  void* o;                       // bf16 (T = 1) or fp32 (T = 3)
  long long o_sb, o_ss, o_sh;    // output element strides, unit D stride
  int D;
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// a phase that never completes (a copy the hardware refused) traps after
// about 2^34 cycles, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// a box of 64 columns of one head: coordinate 0 is the column, and head,
// sequence position and batch go in the slots (1-3) the host gave them
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int head, int seq, int batch, int slot_h,
                                         int slot_s) {
  const int c1 = slot_h == 1 ? head : slot_s == 1 ? seq : batch;
  const int c2 = slot_h == 2 ? head : slot_s == 2 ? seq : batch;
  const int c3 = slot_h == 3 ? head : slot_s == 3 ? seq : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma operand lists: "{%0, ..., %(n-1)}" and the n accumulators
#define R10(x) "%" #x "0, %" #x "1, %" #x "2, %" #x "3, %" #x "4, %" #x "5, %" #x "6, %" #x \
               "7, %" #x "8, %" #x "9"
#define RL8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define RL16 "{" R10() ", %10, %11, %12, %13, %14, %15}"
#define RL32 "{" R10() ", " R10(1) ", " R10(2) ", %30, %31}"
#define RL64 "{" R10() ", " R10(1) ", " R10(2) ", " R10(3) ", " R10(4) ", " R10(5) \
             ", %60, %61, %62, %63}"
#define RL96 "{" R10() ", " R10(1) ", " R10(2) ", " R10(3) ", " R10(4) ", " R10(5) ", " \
             R10(6) ", " R10(7) ", " R10(8) ", %90, %91, %92, %93, %94, %95}"
#define RL128 "{" R10() ", " R10(1) ", " R10(2) ", " R10(3) ", " R10(4) ", " R10(5) ", " \
              R10(6) ", " R10(7) ", " R10(8) ", " R10(9) ", " R10(10) ", " R10(11)      \
              ", %120, %121, %122, %123, %124, %125, %126, %127}"
#define F8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
                 c(d[i + 6]), c(d[i + 7])
#define F32(c, i) F8(c, i), F8(c, i + 8), F8(c, i + 16), F8(c, i + 24)
#define DL8(c) F8(c, 0)
#define DL16(c) F8(c, 0), F8(c, 8)
#define DL32(c) F32(c, 0)
#define DL64(c) F32(c, 0), F32(c, 32)
#define DL96(c) F32(c, 0), F32(c, 32), F32(c, 64)
#define DL128(c) F32(c, 0), F32(c, 32), F32(c, 64), F32(c, 96)

// D (64 x N, fp32) (+)= A (64 x 16) . B (16 x N); A and B K-major in shared
// memory (Q.K^T: the Q rows and the K rows, both contiguous along D). The
// first step of a product (``_first``) writes D without reading it, so the
// old scores are dead while P.V runs.
#define DEF_WGMMA_SS(NAME, N, NOUT, RL, DL, OA, OB, OS, ACC)                              \
  __device__ __forceinline__ void NAME(float(&d)[NOUT], uint64_t da, uint64_t db) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " OS ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL ", " OA   \
                 ", " OB ", p, 1, 1, 0, 0;\n}\n"                                          \
                 : DL                                                                     \
                 : "l"(da), "l"(db), "r"(ACC));                                           \
  }
DEF_WGMMA_SS(wgmma_ss_n16, 16, 8, RL8, DL8("+f"), "%8", "%9", "%10", 1)
DEF_WGMMA_SS(wgmma_ss_first_n16, 16, 8, RL8, DL8("=f"), "%8", "%9", "%10", 0)
DEF_WGMMA_SS(wgmma_ss_n32, 32, 16, RL16, DL16("+f"), "%16", "%17", "%18", 1)
DEF_WGMMA_SS(wgmma_ss_first_n32, 32, 16, RL16, DL16("=f"), "%16", "%17", "%18", 0)
DEF_WGMMA_SS(wgmma_ss_n64, 64, 32, RL32, DL32("+f"), "%32", "%33", "%34", 1)
DEF_WGMMA_SS(wgmma_ss_first_n64, 64, 32, RL32, DL32("=f"), "%32", "%33", "%34", 0)

// D (64 x N, fp32) += A (64 x 16, registers) . B (16 x N); B MN-major in
// shared memory (P.V: the V rows, contiguous along D, read transposed)
#define DEF_WGMMA_RS(N, NOUT, RL, DL, A0, A1, A2, A3, OB, OS)                             \
  __device__ __forceinline__ void wgmma_rs_n##N(float(&d)[NOUT], const uint32_t(&a)[4],  \
                                                uint64_t db) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " OS ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " RL ", {" A0 \
                 ", " A1 ", " A2 ", " A3 "}, " OB ", p, 1, 1, 1;\n}\n"                    \
                 : DL                                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));          \
  }
DEF_WGMMA_RS(64, 32, RL32, DL32("+f"), "%32", "%33", "%34", "%35", "%36", "%37")
DEF_WGMMA_RS(128, 64, RL64, DL64("+f"), "%64", "%65", "%66", "%67", "%68", "%69")
DEF_WGMMA_RS(192, 96, RL96, DL96("+f"), "%96", "%97", "%98", "%99", "%100", "%101")
DEF_WGMMA_RS(256, 128, RL128, DL128("+f"), "%128", "%129", "%130", "%131", "%132", "%133")

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         bool first) {
  if constexpr (N == 64) {
    if (first) wgmma_ss_first_n64(d, da, db);
    else wgmma_ss_n64(d, da, db);
  } else if constexpr (N == 32) {
    if (first) wgmma_ss_first_n32(d, da, db);
    else wgmma_ss_n32(d, da, db);
  } else {
    if (first) wgmma_ss_first_n16(d, da, db);
    else wgmma_ss_n16(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);   // .x (low half) = lo_col
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + mid + lo, three bf16 terms for two neighbouring columns, each
// packed as a wgmma A-fragment register (lower column in the low half)
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16x2_bits(p0, p1);
  const float r0 = p0 - __uint_as_float(hi << 16);
  const float r1 = p1 - __uint_as_float(hi & 0xFFFF0000u);
  mid = bf16x2_bits(r0, r1);
  lo = bf16x2_bits(r0 - __uint_as_float(mid << 16), r1 - __uint_as_float(mid & 0xFFFF0000u));
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -------------------------------------------------------------------- kernel

template <int DP, int T>
__global__ void __launch_bounds__(Cfg<DP, T>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<DP, T>;
  constexpr int BQ = C::BQ, BK = C::BK, NPAIRS = T * (T + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];   // full, empty, Q

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;   // 128-byte swizzle atoms
  const uint32_t kv_s = q_s + T * C::Q_BYTES;                    // stage st: K, then V
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[MAX_STAGES]);
  const uint32_t q_bar = smem_u32(&bars[2 * MAX_STAGES]);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * C::NC);   // one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy; term t of batch b is
    // batch t B + b of the tensor maps
    if constexpr (C::NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, T * C::Q_BYTES);
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load(q_s + t * C::Q_BYTES + c * BQ * 128, &qmap, q_bar, 64 * c, h, q0,
                   t * p.B + b, p.q_slot[0], p.q_slot[1]);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty0 + 8 * st, ((i / C::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t k_dst = kv_s + st * C::STAGE_BYTES;
        mbar_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load(k_dst + t * C::KV_BYTES + c * BK * 128, &kmap, full, 64 * c, hk, i * BK,
                     t * p.B + b, p.k_slot[0], p.k_slot[1]);
            tma_load(k_dst + (T + t) * C::KV_BYTES + c * BK * 128, &vmap, full, 64 * c, hk,
                     i * BK, t * p.B + b, p.v_slot[0], p.v_slot[1]);
          }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 takes query rows q0..q0+63, 2 the next 64
  if constexpr (C::NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row_a = r0 + 16 * warp + gid, row_b = row_a + 8;
  // tiles this warpgroup's rows need (the rest it only releases)
  const int n_mine = r0 >= p.S ? 0
                     : p.causal ? (min(p.Sk, r0 + 64) + BK - 1) / BK
                                : n_tiles;

  float o[DP / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  uint32_t hi[BK / 16][4], mid[BK / 16][4], lo[BK / 16][4];
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;
  const uint32_t qa = q_s + cw * 64 * 128;   // this warpgroup's rows of each Q chunk

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % C::STAGES;
    const uint32_t k_s = kv_s + st * C::STAGE_BYTES, v_s = k_s + T * C::KV_BYTES;
    mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);
    if (i < n_mine) {
      // S = sum of Q_a K_b^T over the pairs of terms, each over DP / 16
      // steps of 16 columns; the first step writes S without reading it, so
      // the last tile's scores are dead during P V
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        const uint32_t off = (j % 4) * 32u;   // 16 columns within the 128-byte row
#pragma unroll
        for (int pr = 0; pr < NPAIRS; ++pr)
          wgmma_ss<BK>(s,
                       sw128_desc(qa + pair_a(pr) * C::Q_BYTES + (j / 4) * BQ * 128 + off, 16,
                                  1024),
                       sw128_desc(k_s + pair_b(pr) * C::KV_BYTES + (j / 4) * BK * 128 + off, 16,
                                  1024),
                       j == 0 && pr == 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in place: s[4 j + e] is row (e < 2 ? a : b), key
      // k0 + 8 j + 2 tq + (e & 1); the raw scores become p, and m is kept
      // in log2 units, so p = 2^(s * scale_log2 - m) is one FFMA and one ex2
      const int k0 = i * BK;
      if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > r0)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * tq + (e & 1);
            if (key >= p.Sk || (p.causal && key > (e < 2 ? row_a : row_b)))
              s[4 * j + e] = NEG_INF;
          }
      }
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * p.scale_log2);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * p.scale_log2);
      const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(fmaf(s[4 * j + e], p.scale_log2, -(e < 2 ? mn_a : mn_b)));
          s[4 * j + e] = pv;
          if (e < 2) sum_a += pv;
          else sum_b += pv;
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // P = hi + mid + lo; the accumulator layout of S is the A-fragment
      // layout: keys 16 kk .. 16 kk + 15 are s[8 kk .. 8 kk + 7]
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], mid[kk][r], lo[kk][r]);

      // O += P V: B is 16 keys x DP columns of a V term, MN-major, 8-key
      // groups 1024 bytes apart and 64-column chunks BK * 128 bytes apart.
      // bf16: the three terms of P times V; fp32: the six pairs of a P term
      // and a V term whose indices sum to at most 2
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(v_s + kk * 16 * 128, BK * 128, 1024);
        if constexpr (T == 1) {
          wgmma_rs<DP>(o, hi[kk], db);
          wgmma_rs<DP>(o, mid[kk], db);
          wgmma_rs<DP>(o, lo[kk], db);
        } else {
          const uint64_t db1 = sw128_desc(v_s + C::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
          const uint64_t db2 = sw128_desc(v_s + 2 * C::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
          wgmma_rs<DP>(o, hi[kk], db);
          wgmma_rs<DP>(o, hi[kk], db1);
          wgmma_rs<DP>(o, mid[kk], db);
          wgmma_rs<DP>(o, hi[kk], db2);
          wgmma_rs<DP>(o, mid[kk], db1);
          wgmma_rs<DP>(o, lo[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(hi);
      fence_regs(mid);
      fence_regs(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // epilogue: O / l, rounded to bf16 or kept fp32; o[4 j + e] is row
  // (e < 2 ? a : b), column 8 j + 2 tq + (e & 1)
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float den_a = l_a == 0.0f ? 1.0f : l_a, den_b = l_b == 0.0f ? 1.0f : l_b;
  using Out = std::conditional_t<T == 1, __nv_bfloat16, float>;
  Out* ob = static_cast<Out*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * tq + (e & 1);
      const int row = e < 2 ? row_a : row_b;
      if (col < p.D && row < p.S) {
        const float val = o[4 * j + e] / (e < 2 ? den_a : den_b);
        if constexpr (T == 1) ob[row * p.o_ss + col] = __float2bfloat16_rn(val);
        else ob[row * p.o_ss + col] = val;
      }
    }
  }
}

// The split pass of the fp32 design: for each of q, k and v (given by its
// (batch, sequence, head) element strides, unit D stride) the three bf16
// terms of every element, term t of row (b, h, l) at ((t B + b) H + h) L + l
// of a (3 B, H, L, DP8) scratch; columns D..DP8-1 are zero. One thread per
// four columns of a row: one 16-byte load where the operand allows it (D a
// multiple of 4, 16-byte aligned rows), else four, and one 8-byte store per
// term. It moves each input byte once and 1.5 bytes out per input byte.
struct SplitOperand {
  const float* src;
  uint2* dst;               // four bf16 per element
  long long sb, sl, sh;     // source element strides
  int H, L;
  long long rows;           // B H L
  int vec;                  // rows load as float4
};

struct SplitArgs {
  SplitOperand op[3];
  int D, DP8;
};

__global__ void __launch_bounds__(256) split3_kernel(const __grid_constant__ SplitArgs args) {
  const int quads = args.DP8 / 4;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  long long row = idx / quads;
  const int c = (int)(idx % quads) * 4;
  int which = 0;
  while (which < 3 && row >= args.op[which].rows) row -= args.op[which++].rows;
  if (which == 3) return;
  const SplitOperand& a = args.op[which];
  const long long l = row % a.L, hb = row / a.L;
  const float* src = a.src + (hb / a.H) * a.sb + l * a.sl + (hb % a.H) * a.sh + c;
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.vec) {
    if (c < args.D) x = *reinterpret_cast<const float4*>(src);
  } else {
    if (c < args.D) x.x = src[0];
    if (c + 1 < args.D) x.y = src[1];
    if (c + 2 < args.D) x.z = src[2];
    if (c + 3 < args.D) x.w = src[3];
  }
  uint2 hi, mid, lo;
  split3(x.x, x.y, hi.x, mid.x, lo.x);
  split3(x.z, x.w, hi.y, mid.y, lo.y);
  const long long term = a.rows * quads, at = row * quads + c / 4;
  a.dst[at] = hi;
  a.dst[term + at] = mid;
  a.dst[2 * term + at] = lo;
}

// ---------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)f
                                                                        : nullptr;
  }();
  return fn;
}

// A 4-d map over a (B, L, H, D) bf16 operand at element strides (sb, sl, sh)
// with a unit D stride, boxes of 64 columns x ``rows`` positions of one head
// of one batch. The three outer dimensions go in order of their strides;
// ``slot`` receives the coordinate position of (head, seq, batch). A
// dimension of extent 1 is never stepped, so its stride is replaced by the
// largest real one.
int make_map(CUtensorMap* map, int* slot, const void* base, int B, int L, int H, int D,
             long long sb, long long sl, long long sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Dim {
    long long stride, size;
    int box, which;
  } dims[3] = {{sh, H, 1, 0}, {sl, L, rows, 1}, {sb, B, 1, 2}};
  long long widest = 8;
  for (const Dim& d : dims)
    if (d.size > 1 && d.stride > widest) widest = d.stride;
  for (Dim& d : dims)
    if (d.size == 1) d.stride = widest;
  for (int i = 1; i < 3; ++i)   // insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, 0, 0, 0}, gstride[3];
  cuuint32_t box[4] = {64, 0, 0, 0}, estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = (cuuint64_t)dims[i].size;
    gstride[i] = (cuuint64_t)dims[i].stride * 2;
    box[i + 1] = (cuuint32_t)dims[i].box;
    slot[dims[i].which] = i + 1;
  }
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim,
                      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the three operands' tensor maps (batch extent B, which is T times the
// model's batch for the term-stacked fp32 scratch) and the launch of
// instantiation <DP, T>
template <int DP, int T>
int launch(const void* q, const void* k, const void* v, Params& p, int B, int Hq, int Hkv,
           int S, int Sk, int D, const long long* qs, const long long* ks, const long long* vs,
           cudaStream_t stream) {
  using C = Cfg<DP, T>;
  CUtensorMap qm, km, vm;
  int err_map = make_map(&qm, p.q_slot, q, B, S, Hq, D, qs[0], qs[1], qs[2], C::BQ);
  if (!err_map)
    err_map = make_map(&km, p.k_slot, k, B, Sk, Hkv, D, ks[0], ks[1], ks[2], C::BK);
  if (!err_map)
    err_map = make_map(&vm, p.v_slot, v, B, Sk, Hkv, D, vs[0], vs[1], vs[2], C::BK);
  if (err_map) return err_map;
  // the shared-memory limit holds per device: one setting per instantiation
  // and device, before its first launch there (outside any graph capture)
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(configured.load() & bit) || bit == 0) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<DP, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured.fetch_or(bit);
  }
  dim3 grid(p.B * Hq, (S + C::BQ - 1) / C::BQ, 1);
  flash_wgmma_kernel<DP, T><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

template <int T>
int launch_dp(const void* q, const void* k, const void* v, Params& p, int B, int Hq, int Hkv,
              int S, int Sk, int D, const long long* qs, const long long* ks,
              const long long* vs, cudaStream_t st) {
  // D is padded to DP, a multiple of 64, by the tensor maps' zero fill
  if (D <= 64) return launch<64, T>(q, k, v, p, B, Hq, Hkv, S, Sk, D, qs, ks, vs, st);
  if (D <= 128) return launch<128, T>(q, k, v, p, B, Hq, Hkv, S, Sk, D, qs, ks, vs, st);
  if (D <= 192) return launch<192, T>(q, k, v, p, B, Hq, Hkv, S, Sk, D, qs, ks, vs, st);
  return launch<256, T>(q, k, v, p, B, Hq, Hkv, S, Sk, D, qs, ks, vs, st);
}

Params make_params(void* o, int B, int Hq, int Hkv, int S, int Sk, int D, long long o_sb,
                   long long o_ss, long long o_sh, float scale, int causal) {
  Params p;
  p.B = B;
  p.S = S;
  p.Sk = Sk;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.scale_log2 = (float)((double)scale * LOG2E);
  p.o = o;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.D = D;
  return p;
}

bool bad_shape(int B, int Hq, int Hkv, int S, int Sk, int D) {
  return D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Sk < 1 || S < 1 || B < 1;
}

}  // namespace

extern "C" {

// Launches on ``stream``; returns a cudaError_t (0 = ok). q: (B, S, Hq, D),
// k and v: (B, Sk, Hkv, D), o: (B, S, Hq, D), all bfloat16, each given by
// its (batch, sequence, head) element strides with a unit D stride.
// Preconditions (else cudaErrorInvalidValue, nothing launched): 1 <= D <=
// 256; q, k, v 16-byte aligned with strides of 16-byte multiples (those of
// extent-1 dimensions excepted); Hq a multiple of Hkv; Sk >= 1.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o, int B,
                                int Hq, int Hkv, int S, int Sk, int D, long long q_sb,
                                long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_ss, long long o_sh, float scale,
                                int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, S, Sk, D)) return (int)cudaErrorInvalidValue;
  for (const void* t : {q, k, v})
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(o, B, Hq, Hkv, S, Sk, D, o_sb, o_ss, o_sh, scale, causal);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  return launch_dp<1>(q, k, v, p, B, Hq, Hkv, S, Sk, D, qs, ks, vs, (cudaStream_t)stream);
}

// The fp32 design: two launches on ``stream`` (the split pass, then the
// kernel); returns a cudaError_t (0 = ok). q, k, v, o as above in float32,
// at any (batch, sequence, head) strides with a unit D stride; qt, kt, vt:
// bf16 scratch of 3 B Hq S DP8, 3 B Hkv Sk DP8 and 3 B Hkv Sk DP8 elements
// (DP8 = D rounded up to 8), each 16-byte aligned. Preconditions as above
// for the shape (else cudaErrorInvalidValue, nothing launched).
int flash_attention_sm90_fp32_launch(const void* q, const void* k, const void* v, void* o,
                                     void* qt, void* kt, void* vt, int B, int Hq, int Hkv,
                                     int S, int Sk, int D, long long q_sb, long long q_ss,
                                     long long q_sh, long long k_sb, long long k_ss,
                                     long long k_sh, long long v_sb, long long v_ss,
                                     long long v_sh, long long o_sb, long long o_ss,
                                     long long o_sh, float scale, int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, S, Sk, D)) return (int)cudaErrorInvalidValue;
  for (const void* t : {qt, kt, vt})
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int dp8 = (D + 7) / 8 * 8;
  cudaStream_t st = (cudaStream_t)stream;
  SplitArgs args;
  args.D = D;
  args.DP8 = dp8;
  const void* src[3] = {q, k, v};
  void* dst[3] = {qt, kt, vt};
  const long long strides[3][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  long long rows = 0;
  for (int i = 0; i < 3; ++i) {
    SplitOperand& a = args.op[i];
    a.src = static_cast<const float*>(src[i]);
    a.dst = static_cast<uint2*>(dst[i]);
    a.sb = strides[i][0];
    a.sl = strides[i][1];
    a.sh = strides[i][2];
    a.H = i == 0 ? Hq : Hkv;
    a.L = i == 0 ? S : Sk;
    a.rows = (long long)B * a.H * a.L;
    a.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(src[i]) % 16 == 0 &&
            a.sb % 4 == 0 && a.sl % 4 == 0 && a.sh % 4 == 0;
    rows += a.rows;
  }
  const long long threads = rows * (dp8 / 4);
  split3_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the scratch as (3 B, L, H, DP8) operands: element strides of batch,
  // sequence and head
  Params p = make_params(o, B, Hq, Hkv, S, Sk, D, o_sb, o_ss, o_sh, scale, causal);
  const long long qs[3] = {(long long)Hq * S * dp8, dp8, (long long)S * dp8};
  const long long ks[3] = {(long long)Hkv * Sk * dp8, dp8, (long long)Sk * dp8};
  return launch_dp<3>(qt, kt, vt, p, 3 * B, Hq, Hkv, S, Sk, D, qs, ks, ks, st);
}

const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
