// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, driven by `_flash_forward`
// (multiverso_tpu/ops/attention_kernels.py:54-158, pallas_call at :138).
//
// What it computes, per (batch*head) slice of q, k, v [S, D]:
//   out = softmax(q k^T * scale [causal-masked]) v,   scale = 1/sqrt(D)
// with the TPU kernel's numerics: both products accumulate in f32, the
// online softmax keeps a running max m, a denominator l and an f32 output
// accumulator across k tiles, l sums the unrounded f32 p while p is rounded
// to the input dtype before p @ v, masked entries get p = 0 (the
// `s > NEG_INF/2` guard), rows with l == 0 give 0, and the optional lse
// output is m + log(l), written as (B*H, S) f32 (no 8-lane TPU padding).
//
// Two designs, chosen by dtype inside mv_flash_fwd:
//
// bfloat16: tensor cores (flash_fwd_wgmma). One block of three warpgroups
//   per (128-row q tile, batch*head): warpgroups 0 and 1 each own 64 q
//   rows; one thread of warpgroup 2 is the producer. The q tile is loaded
//   once by TMA; k and v tiles of 128 rows stream through a ring of 3
//   stages (TMA, one `full` mbarrier per stage; the consumers arrive on the
//   stage's `empty` mbarrier after their last wgmma on it). Per k tile a
//   consumer warpgroup computes S = Q K^T with wgmma (both operands K-major
//   in shared memory), masks and scales S, runs the online softmax in the
//   accumulator's registers (a row lives in one quad: max and sum by two
//   shuffles), rescales O, and adds P V with wgmma, P as bf16 registers (A)
//   and V read MN-major (the transpose bit). The warpgroup issues tile t's
//   Q K^T together with tile t-1's P V, so its row pass of tile t overlaps
//   the P V product. Tiles are bf16 in shared memory, 128-byte swizzled
//   (hopper.cuh). Causal: k tiles past the q tile's diagonal are not
//   loaded, and only tiles that cross the diagonal or the end of S are
//   masked; blocks run longest first (q tiles in reverse). Shared memory at
//   D=128: 1 KB alignment slack + 32 KB q + 3 x (32 KB k + 32 KB v) =
//   230,400 B of the 232,448 a block may have. Per consumer thread: 64 f32
//   of O, 64 of S and 32 registers of P; setmaxnreg moves registers from
//   the producer warpgroup (24) to the consumers (240).
// float32: FMA on the CUDA cores (flash_fwd_kernel), kept because the
//   tensor cores would take f32 as TF32. One block of 256 threads per
//   (64-row q tile, batch*head); q, k and v tiles staged in shared memory
//   as f32 (116 KB at D=128); each thread owns a 4x4 patch of the 64x64
//   score tile and a 4 x D/16 patch of the output; scores go through shared
//   memory for the row-wise softmax.
//
// What bounds it on the card: at the main path's shape (2,16,1024,128)
// bf16 causal the work is ~8.6 GFLOP and the traffic ~34 MB, so an ideal
// kernel is memory-bound at ~10 us (3.35 TB/s) and near the tensor cores'
// ~8.7 us. The bf16 design keeps every intermediate on chip and reads each
// k/v tile once per q tile (16 times per head at S=1024, from L2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads per block
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1)     // q tile, padded rows
       + (size_t)BK * (D + 1)     // k tile, padded rows
       + (size_t)BK * D           // v tile
       + (size_t)BQ * (BK + 1)    // scores / p
       + 3 * (size_t)BQ;          // running max, denominator, correction
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
    sQ[r * DP + c] = gr < S ? q[base + (size_t)gr * D + c] : 0.f;
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
      sK[r * DP + c] = ok ? k[base + (size_t)gr * D + c] : 0.f;
      sV[r * D + c] = ok ? v[base + (size_t)gr * D + c] : 0.f;
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
        row[c] = p;
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
      o[base + (size_t)gr * D + tx + 16 * j] = acc[i][j] / l;
    if (lse != nullptr && tx == 0) lse[(size_t)bh * S + gr] = sM[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, scale,
      causal);
  return cudaGetLastError();
}

cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int bh, int S, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, bh, S, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, lse, bh, S, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, lse, bh, S, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ bf16: wgmma + TMA design

namespace wg {

constexpr int BQ = 128;     // q rows per block: two consumer warpgroups
// k/v rows per stage; with BK = BQ every tile a warpgroup walks holds an
// unmasked pair of its rows, so none is skipped
constexpr int BK = 128;
constexpr int STAGES = 3;   // k/v ring depth
constexpr int NT = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int CONSUMERS = 256;

// DP: head dim as loaded (D, or 64 for D = 32: zero-filled columns)
template <int DP>
constexpr int smem_bytes() {
  return 1024 + BQ * DP * 2 + STAGES * 2 * BK * DP * 2;
}

// The row pass of one S tile in the accumulator's registers: scale, mask
// (only a tile crossing the diagonal or the end of S), and the online
// softmax of the thread's two rows (row0, row0 + 8), each spread over one
// quad. Leaves p in sc, updates m and l, and returns the rows' correction
// of the running output in corr.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, int wrow0,
                                             int tq, int S, int causal,
                                             float scale) {
  const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wrow0);
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e] * scale;
      if (edge) {
        const int col = k0 + 8 * i + 2 * tq + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (!(col < S && (!causal || col <= row))) x = NEG_INF;
      }
      sc[4 * i + e] = x;
    }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_next = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_next);
    m[r] = m_next;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    // rows whose every position is masked would get exp(0) = 1
    const float p = sc[i] > NEG_INF * 0.5f ? expf(sc[i] - m[r]) : 0.f;
    sum[r] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
                const __grid_constant__ CUtensorMap tmK,
                const __grid_constant__ CUtensorMap tmV,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int D, float scale, int causal) {
  using namespace hopper;
  constexpr int NB = DP / 64;            // 64-column boxes in a row
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;  // one k or v tile
  constexpr int NJ = DP / 16;            // k16 steps over the head dim
  constexpr int NO = DP / 2;             // O floats per consumer thread
  constexpr int NS = BK / 2;             // S floats per consumer thread
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + Q_BYTES;
  uint8_t* sV = sK + STAGES * KV_BYTES;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0)
    init_ring<STAGES>(full_bar, empty_bar, &q_bar, CONSUMERS);
  __syncthreads();

  if (wgi == 2) {
    // producer: one thread issues every TMA load of the block
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_bar, Q_BYTES);
      tma_load_tile<NB, BQ>(sQ, &tmQ, &q_bar, q0, bh);
      produce_kv<NB, BK, STAGES>(sK, sV, &tmK, &tmV, full_bar, empty_bar,
                                 ntiles, bh, 0);
    }
  } else {
    // consumers: warpgroup wgi owns q rows q0 + 64*wgi .. +63; this thread
    // holds rows row0 and row0 + 8, columns 8i + 2*tq + {0, 1}
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int tq = lane % 4;
    const int wrow0 = q0 + wgi * 64;
    const int row0 = wrow0 + warp * 16 + lane / 4;

    float oacc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    mbar_wait(&q_bar, 0);
    // Per tile t >= 1: S_t = Q K_t^T and O += P_{t-1} V_{t-1} go to the
    // tensor cores as two commit groups, and the row pass of S_t runs
    // while P V does. O is rescaled by tile t's correction once
    // P_{t-1} V_{t-1} is in, so O_t = O_{t-1} corr_t + P_t V_t, the same
    // sum as one tile at a time. Tile 0 is peeled off, so that every
    // wgmma of the loop is issued on one path.
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    uint32_t pa[BK / 16][4];
    float corr[2];
    mbar_wait(&full_bar[0], 0);
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wgmma_ss(sc, desc_kmajor(sQ, BQ, wgi * 64, j), desc_kmajor(sK, BK, 0, j),
               j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    softmax_tile(sc, m, l, corr, 0, row0, wrow0, tq, S, causal, scale);
    pack_a_frags(sc, pa);   // O is 0: no rescale
    for (int t = 1; t < ntiles; ++t) {
      const int s = t % STAGES;
      const uint8_t* vt = sV + ((t - 1) % STAGES) * KV_BYTES;
      mbar_wait(&full_bar[s], (t / STAGES) & 1);
      fence_operand(sc);
      fence_operand(oacc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(sc, desc_kmajor(sQ, BQ, wgi * 64, j),
                 desc_kmajor(sK + s * KV_BYTES, BK, 0, j), j > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb(oacc, pa[j], desc_mnmajor(vt, BK, j), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operand(sc);
      softmax_tile(sc, m, l, corr, t * BK, row0, wrow0, tq, S, causal,
                   scale);
      wgmma_wait<0>();
      fence_operand(oacc);
      mbar_arrive(&empty_bar[(t - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= corr[(i >> 1) & 1];
      pack_a_frags(sc, pa);
    }
    // the last tile's P V
    {
      const uint8_t* vt = sV + ((ntiles - 1) % STAGES) * KV_BYTES;
      fence_operand(oacc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb(oacc, pa[j], desc_mnmajor(vt, BK, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(oacc);
      mbar_arrive(&empty_bar[(ntiles - 1) % STAGES]);
    }

    const size_t base = (size_t)bh * S * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float lr = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + 2 * tq;
        if (col < D)
          *reinterpret_cast<uint32_t*>(o + base + (size_t)row * D + col) =
              pack_bf16(oacc[4 * i + 2 * r] / lr, oacc[4 * i + 2 * r + 1] / lr);
      }
      if (lse != nullptr && tq == 0)
        lse[(size_t)bh * S + row] = m[r] + logf(lr);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = hopper::make_map(&mq, q, bh, S, D, BQ);
  if (err == cudaSuccess) err = hopper::make_map(&mk, k, bh, S, D, BK);
  if (err == cudaSuccess) err = hopper::make_map(&mv, v, bh, S, D, BK);
  if (err != cudaSuccess) return err;
  constexpr int smem = smem_bytes<DP>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  flash_fwd_wgmma<DP><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, S, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

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
    return (int)launch_d(D, q, k, v, o, l, bh, S, scale, causal, st);
  if (dtype == 1) {
    switch (D) {
      case 32:
      case 64:
        return (int)wg::launch<64>(q, k, v, o, l, bh, S, D, scale, causal, st);
      case 128:
        return (int)wg::launch<128>(q, k, v, o, l, bh, S, D, scale, causal,
                                    st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
