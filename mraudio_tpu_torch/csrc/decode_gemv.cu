// Decode GEMV with a fixed ascending-k f32 reduction per output.
//
// Replaces the TPU kernel mraudio_tpu/ops/gemv.py::decode_gemv
// (_gemv_kernel).  y[r, n] = bf16( (sum_k x[r, k] * w[k, n]) * scale[n] )
// for bf16 activations x (B, K), row-major weights w (K, N) in int8
// (weight-only quantization, f32 per-column scale) or bf16 (no scale).
//
// Bound on the card: bytes.  Decode rows are few (B <= 32), so every
// weight byte is used B times: at B = 3 the int8 gate/up projection
// (4096 x 11008) moves 45 MB for 0.27 GFLOP.  The contract also fixes
// the reduction order: each output sums k in ascending order in one f32
// accumulator, so the result is bit-identical across runs and does not
// depend on the tile sizes (no split-K, no atomics).  That makes the
// sequential k chain per output the second limit: at most N/32 warps
// exist (128 for N = 4096, about one per SM), so each warp must retire
// its k loop with few instructions per k.
//
// Design: one thread owns one output column and walks k in order, with
// R <= 4 batch rows as independent accumulator chains.  A block of
// `block_n` threads owns `block_n` adjacent columns; weight rows are read
// coalesced along N.  The weight tile (BK rows x block_n columns) and the
// matching x slice stream through a STAGES-deep cp.async ring in shared
// memory, so many loads stay in flight per block.  Each stage's x slice
// is widened to f32 once per block, and the k loop is unrolled by 4 with
// one 16-byte broadcast load of x per row: per k a thread issues about
// one weight load, one convert and R FMAs.  Row groups of 4 batch rows
// are separate blocks (grid.y).  The scale is applied once, after the
// full sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 8;
constexpr int ROWS = 4;  // batch rows per block (accumulator chains per thread)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(int8_t w) { return static_cast<float>(w); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 w) { return __bfloat162float(w); }

// 8 adjacent weight columns: 8 bytes of int8 or 16 bytes of bf16.
template <typename W>
__device__ __forceinline__ void copy8cols(W* dst, const W* src) {
  if constexpr (sizeof(W) == 1) {
    cp_async8(dst, src);
  } else {
    cp_async16(dst, src);
  }
}

template <typename W, int R, int BK>
__global__ void gemv_kernel(const __nv_bfloat16* __restrict__ x,  // (B, K)
                            const W* __restrict__ w,              // (K, N)
                            const float* __restrict__ scale,      // (N,) or null
                            __nv_bfloat16* __restrict__ y,        // (B, N)
                            int B, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int X_STAGE = R * BK;  // bf16 elements of x per stage
  const int bn = blockDim.x;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * bn;
  const int r0 = blockIdx.y * ROWS;
  const int w_stage = BK * bn;  // weight elements per stage
  W* ws = reinterpret_cast<W*>(smem);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)STAGES * w_stage * sizeof(W));
  float* xf = reinterpret_cast<float*>(xs + STAGES * X_STAGE);  // (R, BK) f32
  const int num_kt = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    W* wd = ws + stage * w_stage;
    const int cpr = bn / 8;  // 8-column chunks per weight row
    for (int c = tid; c < BK * cpr; c += bn) {
      const int kr = c / cpr, cc = (c % cpr) * 8;
      const int k = k0 + kr, n = n0 + cc;
      if (k < K && n < N) copy8cols(wd + kr * bn + cc, w + (size_t)k * N + n);
    }
    __nv_bfloat16* xd = xs + stage * X_STAGE;
    constexpr int XCPR = BK / 8;
    for (int c = tid; c < R * XCPR; c += bn) {
      const int r = c / XCPR, kc = (c % XCPR) * 8;
      const int k = k0 + kc;
      if (r0 + r < B && k < K) cp_async16(xd + r * BK + kc, x + (size_t)(r0 + r) * K + k);
    }
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < num_kt) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < num_kt; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt-1 and xf are free
    const int nk = kt + STAGES - 1;
    if (nk < num_kt) load_stage(nk % STAGES, nk);
    cp_commit();
    const __nv_bfloat16* xt = xs + (kt % STAGES) * X_STAGE;
    for (int i = tid; i < X_STAGE; i += bn) xf[i] = __bfloat162float(xt[i]);
    __syncthreads();

    const W* wt = ws + (kt % STAGES) * w_stage + tid;
    const int kn = min(BK, K - kt * BK);
    if (kn == BK) {
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        const float w0 = to_f32(wt[(kk + 0) * bn]);
        const float w1 = to_f32(wt[(kk + 1) * bn]);
        const float w2 = to_f32(wt[(kk + 2) * bn]);
        const float w3 = to_f32(wt[(kk + 3) * bn]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xf + r * BK + kk);
          acc[r] = fmaf(xv.x, w0, acc[r]);
          acc[r] = fmaf(xv.y, w1, acc[r]);
          acc[r] = fmaf(xv.z, w2, acc[r]);
          acc[r] = fmaf(xv.w, w3, acc[r]);
        }
      }
    } else {  // ragged last tile
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = to_f32(wt[kk * bn]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xf[r * BK + kk], wv, acc[r]);
      }
    }
  }
  cp_wait<0>();

  const int n = n0 + tid;
  if (n < N) {
    const float s = scale != nullptr ? scale[n] : 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r < B) {
        const float v = scale != nullptr ? acc[r] * s : acc[r];
        y[(size_t)(r0 + r) * N + n] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <typename W, int R, int BK>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, int B, int K, int N,
                   int block_n, cudaStream_t stream) {
  const size_t smem = (size_t)STAGES * ((size_t)BK * block_n * sizeof(W) +
                                        (size_t)R * BK * sizeof(__nv_bfloat16)) +
                      (size_t)R * BK * sizeof(float);
  auto kern = gemv_kernel<W, R, BK>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + block_n - 1) / block_n, (B + ROWS - 1) / ROWS);
  kern<<<grid, block_n, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, K, N);
  return cudaGetLastError();
}

template <typename W, int BK>
cudaError_t dispatch_rows(const void* x, const void* w, const void* scale, void* y, int B, int K,
                          int N, int block_n, cudaStream_t stream) {
  // R = rows handled per block; a single group of B < 4 rows keeps
  // exactly B accumulator chains.
  switch (B < ROWS ? B : ROWS) {
    case 1: return launch<W, 1, BK>(x, w, scale, y, B, K, N, block_n, stream);
    case 2: return launch<W, 2, BK>(x, w, scale, y, B, K, N, block_n, stream);
    case 3: return launch<W, 3, BK>(x, w, scale, y, B, K, N, block_n, stream);
    default: return launch<W, 4, BK>(x, w, scale, y, B, K, N, block_n, stream);
  }
}

template <typename W>
cudaError_t dispatch(const void* x, const void* w, const void* scale, void* y, int B, int K, int N,
                     int block_n, int block_k, cudaStream_t stream) {
  if (block_k == 128) return dispatch_rows<W, 128>(x, w, scale, y, B, K, N, block_n, stream);
  if (block_k == 64) return dispatch_rows<W, 64>(x, w, scale, y, B, K, N, block_n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, K) bf16; w: (K, N) int8 (w_is_int8 = 1) or bf16; scale: (N,) f32
// or null; y: (B, N) bf16.  Requires K % 8 == 0, N % 8 == 0,
// block_n % 32 == 0 (<= 1024), block_k 64 or 128, 16-byte aligned x/w.
extern "C" int decode_gemv(const void* x, const void* w, const void* scale, void* y, int B, int K,
                           int N, int w_is_int8, int block_n, int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || K % 8 || N % 8 || block_n % 32 || block_n < 32 || block_n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = w_is_int8 ? dispatch<int8_t>(x, w, scale, y, B, K, N, block_n, block_k, s)
                            : dispatch<__nv_bfloat16>(x, w, scale, y, B, K, N, block_n, block_k, s);
  return static_cast<int>(e);
}
