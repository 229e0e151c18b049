// Hopper (sm_90a) building blocks shared by the bf16 flash-attention
// kernels of flash_fwd.cu (B1) and flash_bwd.cu (B2): mbarriers, TMA tile
// loads, wgmma descriptors and instructions, and the host-side encoding of
// the tensor maps.
//
// Tile layout in shared memory. A tile of R rows of a [S, D] head is loaded
// by TMA as D/64 boxes of 64 bf16 columns (128 bytes, one 128-byte swizzle
// atom wide) by R rows, each box R*128 bytes, 1024-byte aligned, swizzled
// in 8-row groups of 1024 bytes. The same tile is read by wgmma two ways:
//
// * K-major (D is the product's depth: q k^T, dO v^T): k16 step j starts at
//   box j/4, byte 32*(j%4) inside the atom's row; 8-row groups lie 1024 B
//   apart (SBO); LBO is unused by a swizzled K-major layout (set to 1).
// * MN-major (the tile's rows are the depth: p v, ds k; the transpose bit):
//   k16 step j starts at row 16*j, i.e. byte 2048*j of box 0; along N the
//   next 64 columns are the next box, R*128 B on (LBO); the next 8 rows of
//   the depth are 1024 B on (SBO).
//
// A head dim of 32 is loaded as one 64-column box whose columns 32..63 lie
// past the tensor's end and are zero-filled by TMA: they add exact zeros
// to every product, and the kernels store only the first D columns.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (column c0, row c1, head c2) of `map` into dst; completes
// on `bar` as transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the barriers of a block with one producer thread and `consumers`
// consumer threads: a `full` (1 arrival + TMA bytes) and an `empty`
// (every consumer) barrier per ring stage, and one for the tiles loaded
// once; called by one thread before the block's __syncthreads
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full_bar,
                                          uint64_t* empty_bar,
                                          uint64_t* once_bar,
                                          uint32_t consumers) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full_bar[s], 1);
    mbar_init(&empty_bar[s], consumers);
  }
  mbar_init(once_bar, 1);
  fence_barrier_init();
}

// one tile by TMA: rows row0 .. row0+ROWS-1 of head bh as NB boxes of 64
// columns, each ROWS*128 bytes, completing on `bar`
template <int NB, int ROWS>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int bh) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
    tma_load_3d(dst + b * ROWS * 128, map, bar, 64 * b, row0, bh);
}

// The producer of a ring of STAGES k/v stages: k and v tiles 0 .. ntiles-1
// of ROWS rows each, tile t into stage t % STAGES once the consumers have
// released that stage's previous use, completing on the stage's `full`
// barrier
template <int NB, int ROWS, int STAGES>
__device__ __forceinline__ void produce_kv(uint8_t* sK, uint8_t* sV,
                                           const CUtensorMap* tmK,
                                           const CUtensorMap* tmV,
                                           uint64_t* full_bar,
                                           uint64_t* empty_bar, int ntiles,
                                           int bh) {
  constexpr int TILE_BYTES = NB * ROWS * 128;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(&empty_bar[s], ((t / STAGES) - 1) & 1);
    mbar_expect_tx(&full_bar[s], 2 * TILE_BYTES);
    tma_load_tile<NB, ROWS>(sK + s * TILE_BYTES, tmK, &full_bar[s], t * ROWS,
                            bh);
    tma_load_tile<NB, ROWS>(sV + s * TILE_BYTES, tmV, &full_bar[s], t * ROWS,
                            bh);
  }
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's commit groups are pending (the
// groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows row0 .. row0+63 (or the tile's N rows) of a tile of
// `rows` rows per box, k16 step j of the depth D
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int rows,
                                                int row0, int j) {
  return desc_sw128(smem_u32(tile) + (j >> 2) * rows * 128 + row0 * 128 +
                        (j & 3) * 32,
                    16, 1024);
}

// MN-major operand: k16 step j over the tile's rows, all D columns as N
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int rows,
                                                 int j) {
  return desc_sw128(smem_u32(tile) + j * 2048, rows * 128, 1024);
}

// two floats as a bf16 pair (round to nearest even), low half first: one
// 32-bit register of a wgmma A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma_ss and wgmma_rs_tb are overloaded on the accumulator's size, which
// gives N (32 floats a thread: N = 64; 64 floats: N = 128).

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B both K-major in shared
// memory (128-byte swizzle), f32 accumulators in registers
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B both K-major in shared
// memory (128-byte swizzle), f32 accumulators in registers
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16 pairs in the
// accumulator's fragment layout), B MN-major in shared memory (transpose bit)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (bf16 pairs in the
// accumulator's fragment layout), B MN-major in shared memory (transpose bit)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// An f32 accumulator tile of N columns (N/2 floats a thread) rounded to
// bf16 as the A fragments of a following wgmma whose depth is those N
// columns: k16 step j covers columns 16j .. 16j+15, the accumulator's n8
// blocks 2j and 2j+1, and the two layouts agree register for register
template <int NA>
__device__ __forceinline__ void pack_a_frags(const float (&acc)[NA],
                                             uint32_t (&a)[NA / 8][4]) {
#pragma unroll
  for (int j = 0; j < NA / 8; ++j) {
    a[j][0] = pack_bf16(acc[8 * j + 0], acc[8 * j + 1]);
    a[j][1] = pack_bf16(acc[8 * j + 2], acc[8 * j + 3]);
    a[j][2] = pack_bf16(acc[8 * j + 4], acc[8 * j + 5]);
    a[j][3] = pack_bf16(acc[8 * j + 6], acc[8 * j + 7]);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map (D, S, bh) over a contiguous (bh, S, D) bf16 tensor, boxes of
// 64 columns by `rows` rows of one head, 128-byte swizzle. A box past the
// end of S (or, at D = 32, past the end of D) is zero-filled instead of
// reading the next head's rows. The map holds the data pointer, so it is
// encoded on every launch (a host cost of a few microseconds).
inline cudaError_t make_map(CUtensorMap* map, const void* x, int bh, int S,
                            int D, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(x), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
