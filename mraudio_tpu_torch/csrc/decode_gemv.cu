// Decode GEMV with a reduction order fixed by K alone.
//
// Replaces the TPU kernel mraudio_tpu/ops/gemv.py::decode_gemv
// (_gemv_kernel).  y[r, n] = bf16( (sum_k x[r, k] * w[k, n]) * scale[n] )
// for bf16 activations x (B, K), row-major weights w (K, N) in int8
// (weight-only quantization, f32 per-column scale) or bf16 (no scale).
//
// Reduction order (a function of K alone; no launch setting changes a bit):
//   * K is cut into segments of W = seg_width(K) rows, the reference's
//     _pick_block(K): 512 if it divides K, else 256, else 128, else K
//     itself when K <= 512; any other K takes W = 128 with a shorter last
//     segment.  K = 4096 gives 8 segments of 512, K = 11008 43 of 256.
//   * Inside segment [s0, s1): 16 chains; chain c sums x[r, k] * w[k, n]
//     for k = s0 + c, s0 + c + 16, ... < s1 in ascending k, one f32 fma
//     each (int8 and bf16 products are exact in f32).  The segment's
//     partial is the balanced tree over chain index:
//     p = ((c0+c1)+(c2+c3)) + ((c4+c5)+(c6+c7)) + ... (16 leaves).
//   * y = p_0 + p_1 + ... + p_{S-1}, added in ascending segment order,
//     starting from +0; then * scale[n] in f32, then rounding to bf16.
// The reference pins the same structure (f32 partial dots over fixed
// k tiles, added in ascending tile order); inside a tile its order is
// the dot's own, here the 16-chain tree.  ops/gemv.py::
// decode_gemv_in_order writes the same order out in PyTorch.
//
// Bound on the card: bytes.  Decode rows are few (B <= 32), so every
// weight byte serves B fmas: one layer's seven int8 projections at B = 3
// move 202 MB for 1.2 GFLOP.  Widening int8 to f32 and the fmas still
// take about half of the instruction slots at the byte rate, so the loads must
// stay in flight without costing the threads registers or instructions.
//
// Design.  A CTA owns a strip of 128 bytes of every weight row (128 int8
// or 64 bf16 columns) and a contiguous run of segments; the CTAs of one
// strip form a thread-block cluster of 2, 4, 8 or 16 that split the
// segments.  One producer thread streams the CTA's weights by TMA in
// boxes of 64 rows x 128 bytes into a 3-stage ring of mbarriers (24 KB
// in flight per CTA, up to four CTAs per SM).  Four consumer warps run the 16 chains: lane
// (r4, c8) of warp tw runs chain 4 * tw + r4 over 16 bytes of columns,
// reading rows c, c + 16, c + 32, c + 48 of each box from shared memory;
// each warp frees a stage through an "empty" mbarrier.  int8 widens to
// f32 with a byte permute and one subtract.  At a segment's end the 16
// chains fold by two warp shuffles and a 4-way sum through a
// double-buffered staging area into the segment's partial of each
// output, which is stored straight into the shared memory of the CTA of
// the cluster that finishes that output (distributed shared memory,
// overlapped with the streaming; a cluster barrier at the start makes
// sure every CTA has started before the first such store).  After the
// closing cluster barrier, each CTA adds, for its share of the strip's
// outputs, all segment partials in ascending order: no atomics, no
// global scratch.  x rows of the CTA's
// k range are staged once in shared memory, as f32.  Batch rows go R <= 4
// at a time (grid.y).

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;

namespace {

constexpr int CONSUMERS = 128;         // 4 warps x 4 row lanes = the 16 chains of a segment
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int BOX_ROWS = 64;           // weight rows per TMA box (4 per chain)
constexpr int ROW_BYTES = 128;         // bytes of one weight row in a strip
constexpr int BOX_BYTES = BOX_ROWS * ROW_BYTES;
constexpr int STAGES = 3;
constexpr int XR = 4;                  // f32 x values stored per k (batch rows padded to 4)
constexpr int MAX_SMEM = 232448;

int seg_width(int K) {
  if (K % 512 == 0) return 512;
  if (K % 256 == 0) return 256;
  if (K % 128 == 0) return 128;
  if (K <= 512) return K;
  return 128;
}

// 4 int8 weights -> f32: bytes biased to unsigned, placed in the mantissa
// of 2^23, minus 2^23 + 128.  Exact.
__device__ __forceinline__ void widen(uint32_t v, float* f, int8_t) {
  const uint32_t u = v ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}
// 2 bf16 weights -> f32.
__device__ __forceinline__ void widen(uint32_t v, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(v << 16);
  f[1] = __uint_as_float(v & 0xFFFF0000u);
}

struct Shape {
  int B, K, N, W, nseg, C;
};

// Shared memory, from a 1024-aligned base: ring (STAGES boxes) |
// barriers (full, empty) | x slice (k, 4) f32 | received partials (all
// segments, this CTA's R * BN / C outputs) f32 | staging (2, 4 warps, R,
// BN) f32.
struct Layout {
  int bar, x, recv, stage, bytes;
  __host__ __device__ Layout(const Shape& s, int R, int BN) {
    const int loc = (s.nseg + s.C - 1) / s.C;
    bar = STAGES * BOX_BYTES;
    x = bar + 2 * STAGES * 8;
    recv = x + loc * s.W * XR * 4;
    stage = recv + s.nseg * (R * BN / s.C) * 4;
    bytes = stage + 2 * 4 * R * BN * 4;
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

template <typename W, int R>
__global__ void __launch_bounds__(THREADS) gemv_kernel(const __grid_constant__ CUtensorMap wmap,
                                                       const __nv_bfloat16* __restrict__ x,
                                                       const float* __restrict__ scale,
                                                       __nv_bfloat16* __restrict__ y, Shape s) {
  constexpr int COLS = 16 / sizeof(W);                     // columns per lane (16 bytes)
  constexpr int BN = 8 * COLS;                             // strip width
  constexpr int PER = 4 / sizeof(W);                       // weights per 32-bit word

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / s.C) * BN;
  const int r0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const int lo = rank * s.nseg / s.C, hi = (rank + 1) * s.nseg / s.C;
  const int klo = lo * s.W, khi = min(hi * s.W, s.K);
  const int nbox = (s.W + BOX_ROWS - 1) / BOX_ROWS;  // boxes per segment
  const int total = (hi - lo) * nbox;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const Layout L(s, R, BN);
  const uint32_t full = base + L.bar, empty = full + 8 * STAGES;
  float* xs = reinterpret_cast<float*>(sm + L.x);
  float* recv = reinterpret_cast<float*>(sm + L.recv);
  const int per = R * BN / s.C;  // outputs each CTA of the cluster finishes
  float* stage = reinterpret_cast<float*>(sm + L.stage);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  // Every CTA of the cluster must have started before any of them writes
  // into another's shared memory (the partials below).  Without this
  // barrier the 152064-wide lm_head (2376 strips, many waves of clusters)
  // faulted with "unspecified launch failure" at cluster = 8.
  cluster.sync();

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < total; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, ((i / STAGES) - 1) & 1);
        const int row = (lo + i / nbox) * s.W + (i % nbox) * BOX_ROWS;
        mbar_expect_tx(full + 8 * st, BOX_BYTES);
        tma_load_2d(base + st * BOX_BYTES, &wmap, n0, row, full + 8 * st);
      }
    }
    __syncwarp();
  } else {  // consumers
    const int r4 = lane / 8, c8 = lane % 8;
    const int chain = warp * 4 + r4;

    // x rows r0 .. r0 + R of this CTA's k range, as f32 xs[k - klo][r] (zeros past B)
#pragma unroll 4
    for (int k = klo + tid; k < khi; k += CONSUMERS) {
      float v[XR];
#pragma unroll
      for (int r = 0; r < XR; ++r)
        v[r] = r < R && r0 + r < s.B ? __bfloat162float(x[(size_t)(r0 + r) * s.K + k]) : 0.f;
      *reinterpret_cast<float4*>(xs + (size_t)(k - klo) * XR) = make_float4(v[0], v[1], v[2], v[3]);
    }
    consumers_sync();

    // one weight row of this lane's 16 bytes into the R x COLS chains
    auto row_fma = [&](float (&acc)[R][COLS], const unsigned char* wrow, const float* xk) {
      const uint4 v = *reinterpret_cast<const uint4*>(wrow);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      const float4 xv = *reinterpret_cast<const float4*>(xk);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      float wf[COLS];
#pragma unroll
      for (int q = 0; q < 4; ++q) widen(words[q], wf + q * PER, W());
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(xr[r], wf[c], acc[r][c]);
    };

    float acc[R][COLS];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

    for (int i = 0; i < total; ++i) {
      const int st = i % STAGES;
      const int g = lo + i / nbox, j = i % nbox;
      const int s1 = min((g + 1) * s.W, s.K);
      const int kb = g * s.W + j * BOX_ROWS;
      mbar_wait(full + 8 * st, (i / STAGES) & 1);
      const unsigned char* box = sm + st * BOX_BYTES + chain * ROW_BYTES + c8 * 16;
      const float* xk = xs + (size_t)(kb + chain - klo) * XR;
      if (kb + BOX_ROWS <= s1) {  // a whole box inside the segment
#pragma unroll
        for (int u = 0; u < BOX_ROWS / 16; ++u)
          row_fma(acc, box + 16 * u * ROW_BYTES, xk + 16 * u * XR);
      } else {
#pragma unroll
        for (int u = 0; u < BOX_ROWS / 16; ++u)
          if (kb + chain + 16 * u < s1) row_fma(acc, box + 16 * u * ROW_BYTES, xk + 16 * u * XR);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (j != nbox - 1) continue;

      // segment done: fold its 16 chains into one partial
      float* sg = stage + ((i / nbox) % 2) * 4 * R * BN;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          float v = acc[r][c];
          v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);   // (c0+c1), (c2+c3) of the warp's 4
          v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);  // ((c0+c1)+(c2+c3))
          acc[r][c] = 0.f;
          if (r4 == 0) sg[(warp * R + r) * BN + c8 * COLS + c] = v;
        }
      consumers_sync();  // also orders the reads of this buffer two segments ago
      // the segment's partial of output e goes to the CTA that finishes e
      for (int e = tid; e < R * BN; e += CONSUMERS)
        cluster.map_shared_rank(recv, e / per)[(size_t)g * per + e % per] =
            (sg[e] + sg[R * BN + e]) + (sg[2 * R * BN + e] + sg[3 * R * BN + e]);
    }
  }

  cluster.sync();  // every partial of this CTA's outputs has arrived

  for (int e = tid; e < per; e += THREADS) {
    const int o = rank * per + e;
    const int r = o / BN, col = o % BN;
    float sum = 0.f;
#pragma unroll 8
    for (int g = 0; g < s.nseg; ++g) sum += recv[(size_t)g * per + e];  // ascending segments
    const int n = n0 + col;
    if (n < s.N && r0 + r < s.B) {
      const float v = scale != nullptr ? sum * scale[n] : sum;
      y[(size_t)(r0 + r) * s.N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <typename W, int R>
cudaError_t launch(const CUtensorMap& wmap, const void* x, const void* scale, void* y, Shape s,
                   cudaStream_t stream) {
  constexpr int BN = ROW_BYTES / sizeof(W);
  const size_t smem = (size_t)Layout(s, R, BN).bytes + 1024;  // + alignment slack
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = gemv_kernel<W, R>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && s.C > 8)  // 16 CTAs per cluster is beyond the portable 8
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  const int strips = (s.N + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * s.C, (s.B + R - 1) / R, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, wmap, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), s);
}

template <typename W>
cudaError_t dispatch_rows(const CUtensorMap& wmap, const void* x, const void* scale, void* y,
                          Shape s, int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<W, 1>(wmap, x, scale, y, s, stream);
    case 2: return launch<W, 2>(wmap, x, scale, y, s, stream);
    case 3: return launch<W, 3>(wmap, x, scale, y, s, stream);
    case 4: return launch<W, 4>(wmap, x, scale, y, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, K) bf16; w: (K, N) int8 (w_is_int8 = 1) or bf16, rows `ld`
// elements apart (ld >= N; ld * element bytes a multiple of 16); scale:
// (N,) f32 or null; y: (B, N) bf16.  Requires K % 8 == 0, N % 8 == 0,
// 16-byte aligned x and w.  Launch settings (neither changes the result):
// cluster = CTAs per strip (2, 4, 8 or 16), rows = batch rows per CTA (1-4).
extern "C" int decode_gemv(const void* x, const void* w, const void* scale, void* y, int B,
                           int K, int N, int ld, int w_is_int8, int cluster, int rows,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = w_is_int8 ? 1 : 2;
  if (B < 1 || K < 8 || N < 8 || K % 8 || N % 8 || ld < N || (ld * esize) % 16 || rows < 1 ||
      rows > 4 || (cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.B = B;
  s.K = K;
  s.N = N;
  s.W = seg_width(K);
  s.nseg = (K + s.W - 1) / s.W;
  s.C = cluster;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / esize), BOX_ROWS};
  if (!make_map(&wmap, w_is_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, w, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = w_is_int8 ? dispatch_rows<int8_t>(wmap, x, scale, y, s, rows, st)
                                  : dispatch_rows<__nv_bfloat16>(wmap, x, scale, y, s, rows, st);
  return static_cast<int>(e);
}
