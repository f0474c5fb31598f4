// Flash attention forward (prefill) with a per-position validity mask.
//
// Replaces the TPU kernel mraudio_tpu/ops/attention.py::flash_attention
// (_flash_kernel).  For each (b, h): out = softmax(mask(q k^T / sqrt(D))) v
// over q (S, D) and k/v (KV, D), bf16 in and out, where a key column is
// attended when mask[b, key] != 0 and, if causal, key <= query (queries
// start at column 0).  Fully masked query rows give exact zeros.  The
// softmax statistics (row max m, row sum l) and the output accumulator
// stay in f32; the probabilities are rounded to bf16 for p v.
//
// Bound on the card: operations.  At the prefill shape (B=3, H=32,
// S~5.35k, KV~5.42k, D=128, causal) one call is ~7e11 FLOP against
// ~0.3 GB of q/k/v/out traffic, far above the bf16 ridge point, so the
// products must run on wgmma, the only path to Hopper's tensor-core rate.
//
// Design.  One CTA per (128 queries, h, b): two consumer warpgroups of 64
// query rows and one producer warp.  The producer's lane 0 loads the q
// tile once and streams 128-key K and V tiles through TMA (4-D tensor
// maps over the strided (D, S, H, B) views, 128-byte swizzle, ragged
// edges zero-filled) into a 2-stage ring with mbarrier completion, plus
// the tile's 128 mask bytes by a bulk copy; the consumers free a stage
// through an "empty" mbarrier.  S = q k^T is wgmma m64n128k16 with both
// operands in shared memory (K-major).  The mask and the online softmax
// run on the f32 accumulators in registers: a tile whose 128 mask bytes
// are all set (one warp vote) and that lies below the diagonal skips the
// per-element mask; the scale, folded with log2 e, enters one fma before
// a single ex2.approx per score.  p is packed to bf16 in the accumulator
// layout, which is the register A-operand layout of the next product,
// and o += p v is wgmma m64nDk16 with A from registers and V from shared
// memory (MN-major, transposed by the descriptor).  K and V of a stage
// have separate "full" barriers, so S can start before V lands.  The two
// warpgroups run independently, so one's softmax overlaps the other's
// products.  Causal CTAs stop at the tile that holds their last query.
// CTAs go GROUP (b, h) pairs at a time with the heaviest causal tiles
// first inside a group.  Output rows are written straight from
// registers.

#include <cuda_bf16.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BQ = 128;          // query rows per CTA
constexpr int BK = 128;          // keys per tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int CONSUMERS = 2;     // warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 bf16
constexpr int GROUP = 8;         // (b, h) pairs whose q tiles are scheduled together
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers around the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands:
// lbo unused, sbo = 1024 (next 8 rows).  MN-major operands: lbo = bytes to
// the next 64-column block, sbo = 1024 (next 8 rows of K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// 2^x in one MUFU op; -1e30-scale arguments give +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128 f32) = A (64 x 16, shared) * B (16 x 128, shared, K-major); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offsets in shared memory (from a 1024-aligned base).  Each operand
// tile is stored as D/64 blocks of (rows x 64) bf16, 128-byte rows, in the
// TMA/wgmma 128-byte swizzle.
template <int D>
struct Layout {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int M_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = M_OFF + STAGES * BK;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int D>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void pv_product<128>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void pv_product<64>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                     int kvp, __nv_bfloat16* __restrict__ o, int H, int S, int KV, long long o_sb,
                     long long o_sh, long long o_ss, float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int HALVES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw);
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  // Schedule: GROUP (b, h) pairs at a time, so that their K and V stay in
  // L2 while all their q tiles run; inside a group the heaviest causal
  // tiles (the last queries) go first.
  const int nq = (S + BQ - 1) / BQ, n_bh = gridDim.x / nq;
  const int grp = blockIdx.x / (GROUP * nq), rem = blockIdx.x % (GROUP * nq);
  const int heads = min(GROUP, n_bh - grp * GROUP);
  const int bh = grp * GROUP + rem % heads;
  const int h = bh % H, b = bh / H;
  const int q0 = (nq - 1 - rem / heads) * BQ;
  int ntiles = (KV + BK - 1) / BK;
  if (causal) ntiles = min(ntiles, (q0 + BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, BQ * D * 2);
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load_4d(base + L::Q_OFF + hh * BQ * ROW_BYTES, &tq, hh * 64, q0, h, b, q_full);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t kf = k_full + 8 * s, vf = v_full + 8 * s;
        mbar_expect_tx(kf, BK * D * 2 + BK);
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + hh * BK * ROW_BYTES, &tk, hh * 64,
                      j * BK, h, b, kf);
        bulk_load(base + L::M_OFF + s * BK, mask + (size_t)b * kvp + (size_t)j * BK, BK, kf);
        mbar_expect_tx(vf, BK * D * 2);
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + hh * BK * ROW_BYTES, &tv, hh * 64,
                      j * BK, h, b, vf);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64; this thread
  // holds rows row0 and row0 + 8 of the accumulators.
  const int wg = warp / 4, wi = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  const int warp_row_min = q0 + wg * 64 + wi * 16;

  float sacc[BK / 2];
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint32_t qs = base + L::Q_OFF + wg * 64 * ROW_BYTES;

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const int k0 = j * BK;
    mbar_wait(k_full + 8 * s, ph);

    // S = q k^T (64 x 128 per warpgroup)
    const uint32_t ks = base + L::K_OFF + s * L::KV_BYTES;
    fence_regs<BK / 2>(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the swizzled row
      const uint64_t da = smem_desc(qs + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024);
      const uint64_t db = smem_desc(ks + (kk / 4) * BK * ROW_BYTES + off, 16, 1024);
      wgmma_ss_n128(sacc, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<BK / 2>(sacc);

    // row max of the raw scores over attended keys (masked -> -1e30); a
    // tile with every key valid and clear of the diagonal skips the mask
    const unsigned char* mk = sm + L::M_OFF + s * BK;
    const uint32_t m4 = reinterpret_cast<const uint32_t*>(mk)[lane];
    const bool all_valid =
        __all_sync(0xFFFFFFFFu, ((m4 - 0x01010101u) & ~m4 & 0x80808080u) == 0);
    const bool diag = causal && k0 + BK - 1 > warp_row_min;
    float mx0 = m0, mx1 = m1;
    if (all_valid && !diag) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i + 0], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int c = i * 8 + t * 2;
        const uint32_t mb = *reinterpret_cast<const uint16_t*>(mk + c);
        const int key = k0 + c;
        const bool v0 = (mb & 0xFFu) != 0, v1 = (mb >> 8) != 0;
        if (!(v0 && (!diag || key <= row0))) sacc[4 * i + 0] = NEG_INF;
        if (!(v1 && (!diag || key + 1 <= row0))) sacc[4 * i + 1] = NEG_INF;
        if (!(v0 && (!diag || key <= row1))) sacc[4 * i + 2] = NEG_INF;
        if (!(v1 && (!diag || key + 1 <= row1))) sacc[4 * i + 3] = NEG_INF;
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i + 0], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));

    // p = 2^((s - m) * scale * log2 e): masked entries (s = -1e30) give
    // exactly 0, and a row with nothing attended so far subtracts 0
    // instead of -1e30.
    const float mu0 = (mx0 == NEG_INF ? 0.f : mx0) * scale_log2;
    const float mu1 = (mx1 == NEG_INF ? 0.f : mx1) * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      sacc[4 * i + 0] = ex2(fmaf(sacc[4 * i + 0], scale_log2, -mu0));
      sacc[4 * i + 1] = ex2(fmaf(sacc[4 * i + 1], scale_log2, -mu0));
      sacc[4 * i + 2] = ex2(fmaf(sacc[4 * i + 2], scale_log2, -mu1));
      sacc[4 * i + 3] = ex2(fmaf(sacc[4 * i + 3], scale_log2, -mu1));
      sum0 += sacc[4 * i + 0] + sacc[4 * i + 1];
      sum1 += sacc[4 * i + 2] + sacc[4 * i + 3];
    }
    sum0 += __shfl_xor_sync(0xFFFFFFFFu, sum0, 1);
    sum0 += __shfl_xor_sync(0xFFFFFFFFu, sum0, 2);
    sum1 += __shfl_xor_sync(0xFFFFFFFFu, sum1, 1);
    sum1 += __shfl_xor_sync(0xFFFFFFFFu, sum1, 2);
    const float alpha0 = ex2((m0 - mx0) * scale_log2), alpha1 = ex2((m1 - mx1) * scale_log2);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[4 * i + 0] *= alpha0;
      oacc[4 * i + 1] *= alpha0;
      oacc[4 * i + 2] *= alpha1;
      oacc[4 * i + 3] *= alpha1;
    }
    // p as bf16 A fragments: keys 16 kt .. 16 kt + 15 are accumulator
    // octets 2 kt and 2 kt + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      pa[kt][0] = pack_bf16(sacc[8 * kt + 0], sacc[8 * kt + 1]);
      pa[kt][1] = pack_bf16(sacc[8 * kt + 2], sacc[8 * kt + 3]);
      pa[kt][2] = pack_bf16(sacc[8 * kt + 4], sacc[8 * kt + 5]);
      pa[kt][3] = pack_bf16(sacc[8 * kt + 6], sacc[8 * kt + 7]);
    }

    // o += p v
    mbar_wait(v_full + 8 * s, ph);
    const uint32_t vs = base + L::V_OFF + s * L::KV_BYTES;
    fence_regs<D / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      pv_product<D>(oacc, pa[kt], smem_desc(vs + kt * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs<D / 2>(oacc);
    fence_regs<BK / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + col) =
          pack_bf16(oacc[4 * i + 0] * inv0, oacc[4 * i + 1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * o_ss + col) =
          pack_bf16(oacc[4 * i + 2] * inv1, oacc[4 * i + 3] * inv1);
  }
}

// ---------------------------------------------------------------- host side

// A 4-D map over a strided (B, H, rows, D) bf16 view, dims (D, rows, H, B);
// boxes of 64 x box_rows, 128-byte swizzle, zeros past the edges.
bool make_qkv_map(CUtensorMap* map, const void* ptr, int D, int rows, int H, int B, long long sb,
                  long long sh, long long ss, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const uint8_t* mask, int kvp, __nv_bfloat16* o, int B, int H, int S, int KV,
                   long long o_sb, long long o_sh, long long o_ss, float scale_log2, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Layout<D>::BYTES + 1024;  // + alignment slack for the 1024-byte base
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int grid = B * H * ((S + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, mask, kvp, o, H, S, KV, o_sb,
                                                       o_sh, o_ss, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, S, D), k/v: (B, H, KV, D), o: (B, H, S, D), all bf16 and
// addressed through element strides (sb, sh, ss; the D axis is
// contiguous).  mask: (B, kvp) uint8, contiguous, kvp a multiple of 128,
// zero past KV.  D is 64 or 128; every stride must be a multiple of 8
// elements and the bases 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int S, int KV, int kvp, int D,
                                   long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                   long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                   long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                                   float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || S < 1 || KV < 1 || kvp % BK || kvp < KV || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_qkv_map(&tq, q, D, S, H, B, q_sb, q_sh, q_ss, BQ) ||
      !make_qkv_map(&tk, k, D, KV, H, B, k_sb, k_sh, k_ss, BK) ||
      !make_qkv_map(&tv, v, D, KV, H, B, v_sb, v_sh, v_ss, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const float sl2 = scale * LOG2E;
  cudaError_t e = D == 128 ? launch<128>(tq, tk, tv, mp, kvp, op, B, H, S, KV, o_sb, o_sh, o_ss,
                                         sl2, causal, st)
                           : launch<64>(tq, tk, tv, mp, kvp, op, B, H, S, KV, o_sb, o_sh, o_ss,
                                        sl2, causal, st);
  return static_cast<int>(e);
}
