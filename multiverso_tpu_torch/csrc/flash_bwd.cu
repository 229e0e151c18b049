// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels,
// dQ (B2) and dK/dV (B3).
//
// Replaces the Pallas TPU kernels driven by `_flash_backward`
// (multiverso_tpu/ops/attention_kernels.py:248-296):
//   B2 `_bwd_dq_kernel`  (:190-213, pallas_call at :262)
//   B3 `_bwd_dkv_kernel` (:216-245, pallas_call at :280)
// and their shared tile recompute `_bwd_p_ds` (:161-187).
//
// What they compute, per (batch*head) slice of q, k, v, o, dO [S, D] and the
// forward's lse [S], with scale = 1/sqrt(D) and the TPU kernels' numerics:
//   s     = (q k^T) * scale in f32, causal-masked entries -1e30
//   p     = exp(s - lse)                        (masked entries give p = 0)
//   delta = rowsum(dO * o) in f32, from o in its own dtype
//   dp    = dO v^T in f32
//   ds    = (p * (dp - delta) * scale), rounded to the input dtype
//   B2:  dQ = ds k                      f32 accumulation, written once
//   B3:  dV = p^T dO (p rounded to dO's dtype), dK = ds^T q, same, each
//        summed over a q tile of 64 rows from 0 and added to the running
//        sum tile by tile (the TPU kernel's per-block f32 scratch)
// Rows and columns past S are masked in the kernel, so S need not be a
// multiple of a tile.
//
// Design. The TPU grid's sequential axis becomes a loop inside the block,
// and the TPU's split into two kernels without atomics is kept, so each
// output tile has one owner and a result is the same from run to run.
//
// bfloat16: tensor cores. Both kernels are blocks of three warpgroups:
//   warpgroups 0 and 1 are consumers that each own 64 rows of the block's
//   output tile, one thread of warpgroup 2 is the producer. The block's own
//   tiles are loaded once by TMA; the tiles it walks stream through a ring
//   of 3 stages (TMA into bf16 tiles, 128-byte swizzle, `full` and `empty`
//   mbarriers per stage; hopper.cuh). Every product is a wgmma with f32
//   accumulators in registers; p and ds are computed in the accumulators'
//   register layout and packed to bf16 A fragments for the products that
//   take them (the packing is the TPU's astype to the input dtype).
//   setmaxnreg moves registers from the producer warpgroup (24) to the
//   consumers (240).
// B2 (flash_bwd_dq_wgmma): one block per (128-row q tile, batch*head). The
//   q and dO tiles are loaded once; k and v tiles of 64 rows stream. Per k
//   tile a consumer warpgroup computes S = Q K^T and dP = dO V^T (all
//   operands K-major in shared memory), p and ds, and dQ += dS K with the
//   same k tile read MN-major (B, the transpose bit); tile t's S and dP are
//   issued together with tile t-1's dS K, so the row pass overlaps that
//   product. lse and delta of its rows are read once per block (delta from
//   o and dO in bf16). Causal: k tiles past the q tile's diagonal are not
//   loaded, blocks run longest first. Shared memory at D=128: 1 KB
//   alignment slack + 32 KB q + 32 KB dO + 3 x (16 KB k + 16 KB v) =
//   164,864 B. Per consumer thread: 64 f32 of dQ, 32 of S, 32 of dP and 16
//   registers of dS.
// B3 (flash_bwd_dkv_wgmma): the transpose of B2's loop. One block per
//   (128-row k/v tile, batch*head). The k and v tiles are loaded once; q and
//   dO tiles of 64 rows stream, each stage with the tile's lse and delta
//   (512 B, one bulk copy). A pre-pass (flash_bwd_dkv_delta), launched
//   just before, writes those per q tile: delta = rowsum(dO * o) once per
//   row, with B2's sum, instead of once per (k tile, q tile) as the TPU
//   kernel recomputes it. Per q tile a consumer warpgroup computes
//   S^T = K Q^T, then p^T = exp(S^T scale - lse) while dP^T = V dO^T runs,
//   then dS^T = p^T (dP^T - delta) scale, and dV += P^T dO and dK += dS^T Q
//   with dO and q read MN-major, one 64-column half at a time into a fresh
//   accumulator that is then added to f32 running sums in registers; each
//   tile's products are waited on before the next tile's start. Causal: q
//   tiles before the k tile's diagonal are not loaded, blocks run longest
//   first (k tile 0 first). Shared memory at
//   D=128: 1 KB alignment slack + 32 KB k + 32 KB v + 3 x (16 KB q + 16 KB
//   dO + 512 B lse/delta) = 166,400 B. Per consumer thread: 64 f32 each of
//   dK and dV, 32 of S^T and 32 of dP^T (then 16 registers each of P^T and
//   dS^T, and 32 f32 of the half being summed).
// float32: FMA on the CUDA cores (the tensor cores would take f32 as
//   TF32). B2: one block of 256 threads per (64-row q tile, batch*head);
//   the q and dO tiles, the tile's lse and delta stay in shared memory; the
//   block loops over 64-row k/v tiles (causal: up to the diagonal tile) and
//   keeps dQ in registers. B3: one block per (64-row k tile, batch*head);
//   the k and v tiles stay in shared memory; the block loops over q tiles
//   (causal: from the diagonal tile on), recomputes p and ds for each, and
//   keeps dK and dV in registers, each q tile's sum added to them in turn.
//   Tiles are staged with padded rows; each thread owns a 4x4 patch of the
//   64x64 p/ds tile (rows ty+16i, cols tx+16j) and a 4 x D/16 patch of each
//   accumulator; p and ds go through shared memory between the two
//   products; delta is recomputed per q tile, as the TPU kernel does.
//   Shared memory at D=128: 149,248 B (B2) and 165,888 B (B3), one block
//   per SM, with cudaFuncAttributeMaxDynamicSharedMemorySize set first.
//
// What bounds them on the card: at the training path's shape
// (2,16,1024,128) bf16 causal, an ideal B2 moves ~50.5 MB and does
// ~12.9 GFLOP, an ideal B3 ~58.9 MB and ~17.2 GFLOP, so both are
// memory-bound near balance at ~15 us and ~18 us (3.35 TB/s, 989 TFLOP/s).
// The bf16 kernels keep every intermediate on chip and read each streamed
// tile once per block (from L2); the FMA kernels are bound by the f32 FMA
// rate of the CUDA cores and by one block per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------ float32: FMA design

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads per block

template <int D>
constexpr size_t dq_smem_floats() {
  return (size_t)(2 * BQ + 2 * BK) * (D + 1)  // q, dO, k, v tiles
       + (size_t)BQ * (BK + 1)                // ds
       + 2 * (size_t)BQ;                      // lse, delta
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return (size_t)(2 * BK + 2 * BQ) * (D + 1)  // k, v, q, dO tiles
       + 2 * (size_t)BQ * (BK + 1)            // p, ds
       + 2 * (size_t)BQ;                      // lse, delta
}

// Rows r0 .. r0+ROWS of src ([S, D], row-major) into dst (leading dim D+1);
// rows past S are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D, gr = r0 + r;
    dst[r * (D + 1) + c] = gr < S ? src[(size_t)gr * D + c] : 0.f;
  }
}

// lse and delta = rowsum(dO * o) of the q tile at q0, 4 threads per row.
// sDO is the staged dO tile; o is read from device memory.
template <int D>
__device__ __forceinline__ void row_stats(float* sLse, float* sDelta,
                                          const float* sDO,
                                          const float* __restrict__ o,
                                          const float* __restrict__ lse,
                                          int q0, int S) {
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int gr = q0 + r;
  float acc = 0.f;
  if (gr < S) {
    for (int c = part; c < D; c += 4)
      acc = fmaf(sDO[r * (D + 1) + c], o[(size_t)gr * D + c], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    sDelta[r] = acc;
    sLse[r] = gr < S ? lse[gr] : 0.f;
  }
}

// The shared tile recompute (`_bwd_p_ds`): this thread's 4x4 patch of p and
// ds for the q tile at q0 and the k tile at k0.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* sQ, const float* sDO,
                                          const float* sK, const float* sV,
                                          const float* sLse,
                                          const float* sDelta, int q0, int k0,
                                          int S, int causal, float scale,
                                          float p[4][4], float ds[4][4]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sQ[(ty + 16 * i) * DP + d];
      g[i] = sDO[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = sK[(tx + 16 * j) * DP + d];
      w[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    const float l = sLse[ty + 16 * i];
    const float delta = sDelta[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      const bool ok = gr < S && kc < S && (!causal || kc <= gr);
      // __fmul_rn: no fused multiply-add, the same roundings as the TPU's
      const float pv = ok ? expf(__fmul_rn(s[i][j], scale) - l) : 0.f;
      p[i][j] = pv;
      ds[i][j] = __fmul_rn(pv * (dp[i][j] - delta), scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    int S, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * DP;
  float* sK = sDO + BQ * DP;
  float* sV = sK + BK * DP;
  float* sDS = sV + BK * DP;
  float* sLse = sDS + BQ * BKP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<D, BQ>(sQ, q + base, q0, S);
  load_tile<D, BQ>(sDO, dO + base, q0, S);
  __syncthreads();
  row_stats<D>(sLse, sDelta, sDO, o + base, lse + (size_t)bh * S, q0, S);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: k tiles past the diagonal tile are all masked (the TPU skip)
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BK>(sK, k + base, k0, S);
    load_tile<D, BK>(sV, v + base, k0, S);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, k0, S, causal, scale, p,
                 ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDS[(ty + 16 * i) * BKP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ += ds @ k
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d4[i] = sDS[(ty + 16 * i) * BKP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = sK[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(d4[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[base + (size_t)gr * D + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dO,
                     const float* __restrict__ lse, float* __restrict__ dk,
                     float* __restrict__ dv, int S, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sDO = sQ + BQ * DP;
  float* sP = sDO + BQ * DP;
  float* sDS = sP + BQ * BKP;
  float* sLse = sDS + BQ * BKP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * S * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<D, BK>(sK, k + base, k0, S);
  load_tile<D, BK>(sV, v + base, k0, S);

  // rows ty+16i of this k tile, columns tx+16j
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q tiles before the one holding row k0 are all masked
  const int tfirst = causal ? k0 / BQ : 0;
  const int ntiles = (S + BQ - 1) / BQ;
  for (int t = tfirst; t < ntiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BQ>(sQ, q + base, q0, S);
    load_tile<D, BQ>(sDO, dO + base, q0, S);
    __syncthreads();
    row_stats<D>(sLse, sDelta, sDO, o + base, lse_bh, q0, S);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, k0, S, causal, scale, p,
                 ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (ty + 16 * i) * BKP + tx + 16 * j;
        sP[e] = p[i][j];
        sDS[e] = ds[i][j];
      }
    __syncthreads();

    // dV += p^T @ dO, dK += ds^T @ q: the tile's q rows summed from 0, then
    // added to the running sums (the plain version's grouping)
    float dk_t[4][DJ], dv_t[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) dk_t[i][j] = dv_t[i][j] = 0.f;
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * BKP + ty + 16 * i];
        dsv[i] = sDS[r * BKP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float g = sDO[r * DP + tx + 16 * j];
        const float qv = sQ[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_t[i][j] = fmaf(pv[i], g, dv_t[i][j]);
          dk_t[i][j] = fmaf(dsv[i], qv, dk_t[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dk_acc[i][j] += dk_t[i][j];
        dv_acc[i][j] += dv_t[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = k0 + ty + 16 * i;
    if (gr >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t e = base + (size_t)gr * D + tx + 16 * j;
      dk[e] = dk_acc[i][j];
      dv[e] = dv_acc[i][j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* o, const float* dO, const float* lse,
                      float* dq, int bh, int S, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, o, dO, lse, dq,
                                                     S, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* o, const float* dO, const float* lse,
                       float* dk, float* dv, int bh, int S, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, o, dO, lse, dk,
                                                      dv, S, scale, causal);
  return cudaGetLastError();
}

cudaError_t dq_d(int D, const void* q, const void* k, const void* v,
                 const void* o, const void* dO, const float* lse, void* dq,
                 int bh, int S, float scale, int causal, cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* gf = static_cast<const float*>(dO);
  auto* out = static_cast<float*>(dq);
  switch (D) {
    case 32: return launch_dq<32>(qf, kf, vf, of, gf, lse, out, bh, S, scale, causal, st);
    case 64: return launch_dq<64>(qf, kf, vf, of, gf, lse, out, bh, S, scale, causal, st);
    case 128: return launch_dq<128>(qf, kf, vf, of, gf, lse, out, bh, S, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dkv_d(int D, const void* q, const void* k, const void* v,
                  const void* o, const void* dO, const float* lse, void* dk,
                  void* dv, int bh, int S, float scale, int causal,
                  cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* gf = static_cast<const float*>(dO);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  switch (D) {
    case 32: return launch_dkv<32>(qf, kf, vf, of, gf, lse, dkf, dvf, bh, S, scale, causal, st);
    case 64: return launch_dkv<64>(qf, kf, vf, of, gf, lse, dkf, dvf, bh, S, scale, causal, st);
    case 128: return launch_dkv<128>(qf, kf, vf, of, gf, lse, dkf, dvf, bh, S, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------- bfloat16: wgmma + TMA designs

namespace wg {

constexpr int NT = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int CONSUMERS = 256;

// B2
constexpr int BQ = 128;     // q rows per block: two consumer warpgroups
constexpr int BK = 64;      // k/v rows per stage
constexpr int STAGES = 3;   // k/v ring depth

// B3
constexpr int BKV = 128;                 // k/v rows per block
constexpr int BQT = 64;                  // q/dO rows per stage
constexpr int DKV_STAGES = 3;            // q/dO ring depth
constexpr int STATS = 2 * BQT;           // lse, then delta, of one q tile
constexpr int STATS_BYTES = STATS * 4;

// DP: head dim as loaded (D, or 64 for D = 32: zero-filled columns)
template <int DP>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * BQ * DP * 2 + STAGES * 2 * BK * DP * 2;
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * BKV * DP * 2 +
         DKV_STAGES * (2 * BQT * DP * 2 + STATS_BYTES);
}

// delta = rowsum(dO * o) of one row, in f32 from o and dO in bf16: a quad
// of threads per row, thread tq summing 8 columns from 8*tq on, every 32,
// 16 bytes at a time; every thread of the quad returns the sum. `valid`
// false (a row past S) gives 0.
__device__ __forceinline__ float row_delta(const __nv_bfloat16* o_row,
                                           const __nv_bfloat16* do_row,
                                           int D, int tq, bool valid) {
  float acc = 0.f;
  if (valid) {
    for (int c = 8 * tq; c < D; c += 32) {
      const uint4 a = *reinterpret_cast<const uint4*>(do_row + c);
      const uint4 b = *reinterpret_cast<const uint4*>(o_row + c);
      const auto* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const auto* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 x = __bfloat1622float2(a2[h]);
        const float2 y = __bfloat1622float2(b2[h]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// p and ds of one tile in the accumulators' registers, for the thread's
// rows row0 and row0 + 8: p = exp(s*scale - lse) (masked or past S: 0) and
// ds = p (dp - delta) scale, left in sc unrounded (the bf16 packing of the
// A fragments rounds it). __fmul_rn: no fused multiply-add, the same
// roundings as the TPU's.
template <int NS>
__device__ __forceinline__ void ds_tile(float (&sc)[NS], const float (&dp)[NS],
                                        const float (&lse_r)[2],
                                        const float (&delta)[2], int k0,
                                        int row0, int tq, int S, int causal,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = k0 + 8 * i + 2 * tq + (e & 1);
      const int row = row0 + 8 * r;
      const bool ok = row < S && col < S && (!causal || col <= row);
      const float p =
          ok ? expf(__fmul_rn(sc[4 * i + e], scale) - lse_r[r]) : 0.f;
      sc[4 * i + e] = __fmul_rn(p * (dp[4 * i + e] - delta[r]), scale);
    }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmDO,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, int S, int D, float scale,
                   int causal) {
  using namespace hopper;
  constexpr int NB = DP / 64;            // 64-column boxes in a row
  constexpr int Q_BYTES = BQ * DP * 2;   // the q or the dO tile
  constexpr int KV_BYTES = BK * DP * 2;  // one k or v tile
  constexpr int NJ = DP / 16;            // k16 steps over the head dim
  constexpr int NO = DP / 2;             // dQ floats per consumer thread
  constexpr int NS = BK / 2;             // S (and dP) floats per thread
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sDO = sQ + Q_BYTES;
  uint8_t* sK = sDO + Q_BYTES;
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
      mbar_expect_tx(&q_bar, 2 * Q_BYTES);
      tma_load_tile<NB, BQ>(sQ, &tmQ, &q_bar, q0, bh);
      tma_load_tile<NB, BQ>(sDO, &tmDO, &q_bar, q0, bh);
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
    const size_t base = (size_t)bh * S * D;

    // lse and delta = rowsum(dO * o) of the two rows
    float lse_r[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t off = base + (size_t)row * D;
      delta[r] = row_delta(o + off, dO + off, D, tq, row < S);
      lse_r[r] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    }

    float dqacc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dqacc[i] = 0.f;
    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    uint32_t da[BK / 16][4];

    // Per tile t >= 1: S_t = Q K_t^T and dP_t = dO V_t^T go to the tensor
    // cores as one commit group, dQ += dS_{t-1} K_{t-1} as a second, and
    // the row pass of tile t runs while the dQ product does. Tile 0 is
    // peeled off, so that every wgmma of the loop is issued on one path.
    mbar_wait(&q_bar, 0);
    mbar_wait(&full_bar[0], 0);
    fence_operand(sc);
    fence_operand(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wgmma_ss(sc, desc_kmajor(sQ, BQ, wgi * 64, j), desc_kmajor(sK, BK, 0, j),
               j > 0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wgmma_ss(dp, desc_kmajor(sDO, BQ, wgi * 64, j),
               desc_kmajor(sV, BK, 0, j), j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);
    ds_tile(sc, dp, lse_r, delta, 0, row0, tq, S, causal, scale);
    pack_a_frags(sc, da);
    for (int t = 1; t < ntiles; ++t) {
      const int s = t % STAGES;
      const uint8_t* kt = sK + s * KV_BYTES;
      const uint8_t* vt = sV + s * KV_BYTES;
      const uint8_t* kprev = sK + ((t - 1) % STAGES) * KV_BYTES;
      mbar_wait(&full_bar[s], (t / STAGES) & 1);
      fence_operand(sc);
      fence_operand(dp);
      fence_operand(dqacc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(sc, desc_kmajor(sQ, BQ, wgi * 64, j),
                 desc_kmajor(kt, BK, 0, j), j > 0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(dp, desc_kmajor(sDO, BQ, wgi * 64, j),
                 desc_kmajor(vt, BK, 0, j), j > 0);
      wgmma_commit();
      // dQ += dS K: dS as bf16 A fragments, the k tile read MN-major
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb(dqacc, da[j], desc_mnmajor(kprev, BK, j), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operand(sc);
      fence_operand(dp);
      ds_tile(sc, dp, lse_r, delta, t * BK, row0, tq, S, causal, scale);
      wgmma_wait<0>();
      fence_operand(dqacc);
      mbar_arrive(&empty_bar[(t - 1) % STAGES]);
      pack_a_frags(sc, da);
    }
    // the last tile's dS K
    {
      const uint8_t* kt = sK + ((ntiles - 1) % STAGES) * KV_BYTES;
      fence_operand(dqacc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs_tb(dqacc, da[j], desc_mnmajor(kt, BK, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dqacc);
      mbar_arrive(&empty_bar[(ntiles - 1) % STAGES]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + 2 * tq;
        if (col < D)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * D + col) =
              pack_bf16(dqacc[4 * i + 2 * r], dqacc[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dO, const float* lse,
                      void* dq, int bh, int S, int D, float scale, int causal,
                      cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err = hopper::make_map(&mq, q, bh, S, D, BQ);
  if (err == cudaSuccess) err = hopper::make_map(&mdo, dO, bh, S, D, BQ);
  if (err == cudaSuccess) err = hopper::make_map(&mk, k, bh, S, D, BK);
  if (err == cudaSuccess) err = hopper::make_map(&mv, v, bh, S, D, BK);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_smem_bytes<DP>();
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  flash_bwd_dq_wgmma<DP><<<grid, NT, smem, stream>>>(
      mq, mdo, mk, mv, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), lse,
      static_cast<__nv_bfloat16*>(dq), S, D, scale, causal);
  return cudaGetLastError();
}

// B3's pre-pass: lse and delta = rowsum(dO * o) of every q row, written
// per 64-row q tile as stats[bh][tile] = {lse of its rows, delta of its
// rows} (rows past S: 0), so that one bulk copy stages both next to the
// tile's q and dO. One block per (q tile, batch*head), a quad per row.
__global__ void __launch_bounds__(4 * BQT)
flash_bwd_dkv_delta(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ stats,
                    int S, int D) {
  const int bh = blockIdx.y;
  const int r = threadIdx.x / 4;
  const int tq = threadIdx.x % 4;
  const int row = blockIdx.x * BQT + r;
  const size_t off = ((size_t)bh * S + row) * D;
  const float delta = row_delta(o + off, dO + off, D, tq, row < S);
  if (tq == 0) {
    float* st = stats + ((size_t)bh * gridDim.x + blockIdx.x) * STATS;
    st[r] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    st[BQT + r] = delta;
  }
}

// p^T of one q tile in the accumulators' registers, for the thread's k
// rows kr0 and kr0 + 8 and q columns q0 + 8i + 2*tq + {0, 1}:
// p = exp(s*scale - lse) (masked, or either index past S: 0), with the
// columns' lse from the stage's stats st
template <int NS>
__device__ __forceinline__ void p_tile_t(float (&sc)[NS], const float* st,
                                         int q0, int kr0, int tq, int S,
                                         int causal, float scale) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(st + 8 * i + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = kr0 + 8 * (e >> 1);
      const int qc = q0 + 8 * i + 2 * tq + (e & 1);
      const bool ok = kr < S && qc < S && (!causal || kr <= qc);
      sc[4 * i + e] =
          ok ? expf(__fmul_rn(sc[4 * i + e], scale) - ((e & 1) ? l.y : l.x))
             : 0.f;
    }
  }
}

// dS^T = p^T (dP^T - delta) scale over dp, in place, with the columns'
// delta from the stage's stats st; left unrounded (the bf16 packing of
// the A fragments rounds it)
template <int NS>
__device__ __forceinline__ void ds_tile_t(float (&dp)[NS],
                                          const float (&p)[NS],
                                          const float* st, int tq,
                                          float scale) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    const float2 d =
        *reinterpret_cast<const float2*>(st + BQT + 8 * i + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * i + e] = __fmul_rn(
          p[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? d.y : d.x)), scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmDO,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const float* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int S, int D,
                    float scale, int causal) {
  using namespace hopper;
  constexpr int NB = DP / 64;             // 64-column boxes in a row
  constexpr int KV_BYTES = BKV * DP * 2;  // the k or the v tile
  constexpr int QT_BYTES = BQT * DP * 2;  // one q or dO tile
  constexpr int NJ = DP / 16;             // k16 steps over the head dim
  constexpr int NH = DP / 64;             // 64-column halves of dK and dV
  constexpr int NS = BQT / 2;             // S^T (and dP^T) floats per thread
  __shared__ __align__(8) uint64_t full_bar[DKV_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[DKV_STAGES];
  __shared__ __align__(8) uint64_t kv_bar;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sV = sK + KV_BYTES;
  uint8_t* sQ = sV + KV_BYTES;
  uint8_t* sDO = sQ + DKV_STAGES * QT_BYTES;
  uint8_t* sStats = sDO + DKV_STAGES * QT_BYTES;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // causal: k tile 0 is the longest
  const int nqt = (S + BQT - 1) / BQT;
  // causal: q tiles before the one holding row k0 are all masked
  const int tfirst = causal ? k0 / BQT : 0;
  const int ntiles = nqt - tfirst;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0)
    init_ring<DKV_STAGES>(full_bar, empty_bar, &kv_bar, CONSUMERS);
  __syncthreads();

  if (wgi == 2) {
    // producer: one thread issues every TMA load of the block
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(&kv_bar, 2 * KV_BYTES);
      tma_load_tile<NB, BKV>(sK, &tmK, &kv_bar, k0, bh);
      tma_load_tile<NB, BKV>(sV, &tmV, &kv_bar, k0, bh);
      produce_kv<NB, BQT, DKV_STAGES, STATS_BYTES>(
          sQ, sDO, &tmQ, &tmDO, full_bar, empty_bar, ntiles, bh, tfirst,
          sStats,
          reinterpret_cast<const uint8_t*>(stats + (size_t)bh * nqt * STATS));
    }
  } else {
    // consumers: warpgroup wgi owns k rows k0 + 64*wgi .. +63; this thread
    // holds k rows kr0 and kr0 + 8; in S^T and dP^T q columns
    // 8i + 2*tq + {0, 1}, in half h of dK and dV head-dim columns
    // 64h + 8i + 2*tq + {0, 1}
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int tq = lane % 4;
    const int kr0 = k0 + wgi * 64 + warp * 16 + lane / 4;

    // dK and dV are summed over the q tiles in f32 registers by plain adds
    // (round to nearest); the tensor cores sum one q tile's 64 rows into a
    // fresh accumulator. A wgmma accumulator carried over all q tiles would
    // sum up to 64 k16 steps on the tensor cores, whose adds round
    // otherwise: at |dV| >= 1 that moved bf16 results by an ulp against the
    // f32 sums of the plain version.
    float dkacc[NH][32], dvacc[NH][32];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[h][i] = dvacc[h][i] = 0.f;
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];

    mbar_wait(&kv_bar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % DKV_STAGES;
      const uint8_t* qt = sQ + s * QT_BYTES;
      const uint8_t* dot = sDO + s * QT_BYTES;
      const float* st =
          reinterpret_cast<const float*>(sStats + s * STATS_BYTES);
      const int q0 = (tfirst + t) * BQT;
      mbar_wait(&full_bar[s], (t / DKV_STAGES) & 1);
      // S^T = K Q^T and dP^T = V dO^T, all operands K-major, as two commit
      // groups: p^T is computed while dP^T runs. sc and dp are written from
      // 0 by their first k16 step, and live only within the tile.
      float sc[NS], dp[NS];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(sc, desc_kmajor(sK, BKV, wgi * 64, j),
                 desc_kmajor(qt, BQT, 0, j), j > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(dp, desc_kmajor(sV, BKV, wgi * 64, j),
                 desc_kmajor(dot, BQT, 0, j), j > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operand(sc);
      p_tile_t(sc, st, q0, kr0, tq, S, causal, scale);
      wgmma_wait<0>();
      fence_operand(dp);
      ds_tile_t(dp, sc, st, tq, scale);
      pack_a_frags(sc, pa);
      pack_a_frags(dp, da);
      // dV += P^T dO and dK += dS^T Q, one 64-column half at a time: P^T
      // and dS^T as bf16 A fragments, the half's box of the dO and q tiles
      // read MN-major
#pragma unroll
      for (int h = 0; h < 2 * NH; ++h) {
        const bool is_v = h < NH;
        const int hh = is_v ? h : h - NH;
        float acc[32];  // written from 0 by the first k16 step
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQT / 16; ++j)
          wgmma_rs_tb(acc, is_v ? pa[j] : da[j],
                      desc_mnmajor((is_v ? dot : qt) + hh * BQT * 128, BQT,
                                   j),
                      j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        float (&run)[32] = is_v ? dvacc[hh] : dkacc[hh];
#pragma unroll
        for (int i = 0; i < 32; ++i) run[i] += acc[i];
      }
      mbar_arrive(&empty_bar[s]);
    }

    const size_t base = (size_t)bh * S * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kr0 + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * h + 8 * i + 2 * tq;
          if (col < D) {
            const size_t e = base + (size_t)row * D + col;
            *reinterpret_cast<uint32_t*>(dk + e) = pack_bf16(
                dkacc[h][4 * i + 2 * r], dkacc[h][4 * i + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dv + e) = pack_bf16(
                dvacc[h][4 * i + 2 * r], dvacc[h][4 * i + 2 * r + 1]);
          }
        }
    }
  }
}

// the pre-pass into `stats`, then the main kernel, on one stream
template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dO, const float* lse,
                       float* stats, void* dk, void* dv, int bh, int S, int D,
                       float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err = hopper::make_map(&mq, q, bh, S, D, BQT);
  if (err == cudaSuccess) err = hopper::make_map(&mdo, dO, bh, S, D, BQT);
  if (err == cudaSuccess) err = hopper::make_map(&mk, k, bh, S, D, BKV);
  if (err == cudaSuccess) err = hopper::make_map(&mv, v, bh, S, D, BKV);
  if (err != cudaSuccess) return err;
  constexpr int smem = dkv_smem_bytes<DP>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nqt = (S + BQT - 1) / BQT;
  flash_bwd_dkv_delta<<<dim3(nqt, bh), 4 * BQT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), lse, stats, S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BKV - 1) / BKV);
  flash_bwd_dkv_wgmma<DP><<<grid, NT, smem, stream>>>(
      mq, mdo, mk, mv, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o, dO, dq, dk, dv: contiguous (bh, S, D) of that dtype; lse:
// (bh, S) float32 from the forward; stats (bfloat16 dK/dV only, else
// unused): contiguous (bh, ceil(S/64), 128) float32 scratch for the
// pre-pass. Each returns the cudaError_t of its launch (0 on success).
extern "C" int mv_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, const void* lse,
                               void* dq, int bh, int S, int D, int dtype,
                               int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (bh <= 0 || bh > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dq_d(D, q, k, v, o, dO, l, dq, bh, S, scale, causal, st);
  if (dtype == 1) {
    switch (D) {
      case 32:
      case 64:
        return (int)wg::launch_dq<64>(q, k, v, o, dO, l, dq, bh, S, D, scale,
                                      causal, st);
      case 128:
        return (int)wg::launch_dq<128>(q, k, v, o, dO, l, dq, bh, S, D, scale,
                                       causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* o, const void* dO,
                                const void* lse, void* dk, void* dv,
                                void* stats, int bh, int S, int D, int dtype,
                                int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sts = static_cast<float*>(stats);
  if (bh <= 0 || bh > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dkv_d(D, q, k, v, o, dO, l, dk, dv, bh, S, scale, causal, st);
  if (dtype == 1) {
    if (sts == nullptr) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32:
      case 64:
        return (int)wg::launch_dkv<64>(q, k, v, o, dO, l, sts, dk, dv, bh, S,
                                       D, scale, causal, st);
      case 128:
        return (int)wg::launch_dkv<128>(q, k, v, o, dO, l, sts, dk, dv, bh, S,
                                        D, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
