// Flash attention forward (prefill) with a per-position validity mask.
//
// Replaces the TPU kernel mraudio_tpu/ops/attention.py::flash_attention
// (_flash_kernel).  For each (b, h): out = softmax(mask(q k^T / sqrt(D))) v
// over q (S, D) and k/v (KV, D), bf16 in and out, where a key column is
// attended when mask[b, key] != 0 and, if causal, key <= query (queries
// start at column 0).  Fully masked query rows give exact zeros.  The
// softmax statistics (row max m, row sum l) and the output accumulator
// stay in f32.
//
// Bound on the card: operations.  At the prefill shape (B=3, H=32,
// S~5.35k, KV~5.42k, D=128, causal) one call is ~7e11 FLOP against
// ~0.3 GB of q/k/v/out traffic, far above the bf16 ridge point.
//
// Design (simple first version): one CTA of 4 warps per (q tile of 64
// rows, h, b); each warp owns 16 query rows.  K and V tiles of 64 keys
// are staged through shared memory (padded rows, conflict-free fragment
// reads); q k^T and p v run on the tensor cores as mma.sync m16n8k16
// (bf16 in, f32 accumulate) with the online softmax between them in
// registers — the probabilities are rounded to bf16 as the A operand of
// p v.  Causal CTAs stop at the last kv tile that meets the diagonal,
// as the TPU kernel does, and are launched heaviest-first.  Ragged q and
// kv edges are masked here instead of padding copies.  Tensors are read
// through strides, so (B, S, H, D) buffers need no transposed copy.
// Later work: TMA + wgmma, double-buffered tiles, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // queries per CTA (16 per warp)
constexpr int BK = 64;   // keys per tile
constexpr int PAD = 8;   // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(*reinterpret_cast<uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<uint16_t*>(&hi)) << 16);
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                     __nv_bfloat16* __restrict__ o, int S, int KV, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                     long long o_sh, long long o_ss, float scale, int causal) {
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];
  __shared__ int ms[BK];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = qt * BQ + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int* mb = mask + (long long)b * KV;

  // q fragments (A operand, row-major 16 x D per warp), zero past S
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + t4 * 2;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(qb + row0 * q_ss + col);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(qb + row1 * q_ss + col);
    qf[kk][0] = row0 < S ? p0[0] : 0u;
    qf[kk][1] = row1 < S ? p1[0] : 0u;
    qf[kk][2] = row0 < S ? p0[4] : 0u;
    qf[kk][3] = row1 < S ? p1[4] : 0u;
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int num_tiles = (KV + BK - 1) / BK;
  if (causal) num_tiles = min(num_tiles, (qt * BQ + BQ + BK - 1) / BK);

  for (int j = 0; j < num_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < BK * D / 8; c += blockDim.x) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const int key = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < KV) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * k_ss + cc);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * v_ss + cc);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + cc) = kv4;
      *reinterpret_cast<uint4*>(vs + r * LD + cc) = vv4;
    }
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      ms[threadIdx.x] = key < KV ? mb[key] : 0;
    }
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = ks + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(sacc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // mask, scale, row max
    uint32_t valid = 0;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int key = k0 + col;
        const int row = e < 2 ? row0 : row1;
        const bool ok = ms[col] != 0 && key < KV && (!causal || key <= row);
        const float s = ok ? sacc[nt][e] * scale : NEG_INF;
        sacc[nt][e] = s;
        valid |= (ok ? 1u : 0u) << (nt * 4 + e);
        if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // p = exp(s - m_new) where valid, exactly 0 elsewhere
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (valid >> (nt * 4 + e)) & 1u;
        const float p = ok ? expf(sacc[nt][e] - (e < 2 ? mx0 : mx1)) : 0.f;
        sacc[nt][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[i][0] *= alpha0;
      oacc[i][1] *= alpha0;
      oacc[i][2] *= alpha1;
      oacc[i][3] *= alpha1;
    }

    // out += p v: the s accumulators of two key octets form one A fragment
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kt][0], sacc[2 * kt][1]);
      a[1] = pack_bf16(sacc[2 * kt][2], sacc[2 * kt][3]);
      a[2] = pack_bf16(sacc[2 * kt + 1][0], sacc[2 * kt + 1][1]);
      a[3] = pack_bf16(sacc[2 * kt + 1][2], sacc[2 * kt + 1][3]);
      const __nv_bfloat16* vp = vs + (kt * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = vp + dt * 8;
        const uint32_t b0 = pack_raw(p[0], p[LD]);
        const uint32_t b1 = pack_raw(p[8 * LD], p[9 * LD]);
        mma_bf16(oacc[dt], a, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + col) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * o_ss + col) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

}  // namespace

// q: (B, H, S, D), k/v: (B, H, KV, D), o: (B, H, S, D), all bf16 and
// addressed through element strides (sb, sh, ss; the D axis is
// contiguous).  mask: (B, KV) int32, contiguous.  D is 64 or 128; every
// stride must be a multiple of 8 elements and the bases 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int S, int KV, int D, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || S < 1 || KV < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, 128, 0, s>>>(qp, kp, vp, mp, op, S, KV, q_sb, q_sh, q_ss, k_sb,
                                               k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                                               scale, causal);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, 128, 0, s>>>(qp, kp, vp, mp, op, S, KV, q_sb, q_sh, q_ss, k_sb,
                                              k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                                              scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
