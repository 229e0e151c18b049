// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, driven by `_flash_forward`
// (multiverso_tpu/ops/attention_kernels.py:54-158, pallas_call at :138).
//
// What it computes, per (batch*head) slice of q, k, v [S, D]:
//   out = softmax(q k^T * scale [causal-masked]) v,   scale = 1/sqrt(D)
// with the TPU kernel's numerics: both products accumulate in f32, the
// online softmax keeps a running max m, a denominator l and an f32 output
// accumulator across k tiles, p is rounded to the input dtype before p @ v,
// masked entries get p = 0 (the `s > NEG_INF/2` guard), rows with l == 0
// give 0, and the optional lse output is m + log(l), written as (B*H, S) f32
// (no 8-lane TPU padding).
//
// Design (first version: right and simple). One thread block of 256
// threads per (64-row q tile, batch*head). The q tile is staged once in
// shared memory as f32; the block loops over 64-row k/v tiles, staged in
// shared memory as f32. Each thread owns a 4x4 patch of the 64x64 score
// tile (rows ty+16i, cols tx+16j) and a 4 x D/16 patch of the output
// accumulator in registers; scores go through shared memory for the
// row-wise softmax (4 threads per row, warp shuffles). Causal: the k loop
// stops at the last tile that touches the diagonal, which is the TPU
// kernel's block skip. All arithmetic is FMA on the CUDA cores.
//
// What bounds it on the card: at the main path's shape (2,16,1024,128)
// bf16 causal the work is ~8.6 GFLOP and the traffic ~34 MB, so an ideal
// kernel is memory-bound at ~10 us (3.35 TB/s). This version is bound by
// the f32 FMA rate of the CUDA cores and one 116 KB block per SM; the
// tensor-core (mma/wgmma + TMA) redesign is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads per block
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1)     // q tile, padded rows
       + (size_t)BK * (D + 1)     // k tile, padded rows
       + (size_t)BK * D           // v tile
       + (size_t)BQ * (BK + 1)    // scores / p
       + 3 * (size_t)BQ;          // running max, denominator, correction
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  float* sM = sP + BQ * BKP;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, gr = q0 + r;
    sQ[r * DP + c] = gr < S ? to_f<T>(q[base + (size_t)gr * D + c]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, gr = k0 + r;
      const bool ok = gr < S;
      sK[r * DP + c] = ok ? to_f<T>(k[base + (size_t)gr * D + c]) : 0.f;
      sV[r * D + c] = ok ? to_f<T>(v[base + (size_t)gr * D + c]) : 0.f;
    }
    __syncthreads();

    // scores: s = (q k^T) * scale, masked entries NEG_INF
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kc = k0 + c;
        const bool ok = kc < S && (!causal || kc <= q0 + r);
        sP[r * BKP + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 columns each
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* row = sP + r * BKP + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_next);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float sv = row[c];
        // rows whose every position is masked would get exp(0) = 1
        const float p = sv > NEG_INF * 0.5f ? expf(sv - m_next) : 0.f;
        sum += p;
        row[c] = to_f<T>(from_f<T>(p));  // p in the input dtype for p @ v
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        sM[r] = m_next;
        sL[r] = sL[r] * corr + sum;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * BKP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int gr = q0 + r;
    if (gr >= S) continue;
    float l = sL[r];
    l = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[base + (size_t)gr * D + tx + 16 * j] = from_f<T>(acc[i][j] / l);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * S + gr] = sM[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int bh, int S, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, S, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, S, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, S, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o: contiguous (bh, S, D); lse: (bh, S) float32 or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mv_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int S, int D,
                            int dtype, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bh <= 0 || bh > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, l, bh, S, scale, causal, st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, l, bh, S, scale,
                                        causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
