// K2: the W8A8 GEMM (port of voxtral_tpu/ops/w8_pallas.py::w8_matmul_pallas,
// kernel _w8_kernel):
//
//   out[m, n] = (float(sum_k xq[m, k] * codes[n, k]) * sx[m]) * scale[n]
//
// This file holds the C entry point that voxtral_tpu_torch/ops/w8_kernel.py
// loads with ctypes, and the Hopper tensor-core GEMM that takes every
// product of more than 16 rows (encoder, adapter, prefill).  Up to 16
// rows (decode, the ADA vectors, the lm_head) the product is a weight
// stream and runs the GEMVs of w8_common.cuh, which K1, K4, K5 and K7
// share.
//
// What bounds the GEMM on the H100: at the encoder's shapes (M = 32-608,
// K and N in the thousands) the int8 operation count over the tensor
// cores' 1979 TOP/s, and for the thin ones the ~10 MB of operands over
// 3.35 TB/s; both are a few microseconds.  The CUDA-core dp4a tiles it
// replaces ran 25-35x above that.  The design:
//   * wgmma.mma_async m64n128k32 .s32.s8.s8: int8 wgmma wants both
//     operands K-major in shared memory, which is exactly the layout of
//     xq [M, K] and codes [N, K] (row n = output n).  One consumer
//     warpgroup per 64 output rows (a 64 x 128 or 128 x 128 tile).
//   * TMA 2-D tile loads (128 rows x 128 bytes of K, 128-byte swizzle,
//     zero fill past the matrix edges) into a ring of kStages stages,
//     each guarded by a "full" mbarrier (the TMA's transaction bytes)
//     and an "empty" one (the consumers' release); one producer warp
//     keeps the loads in flight, and the consumers keep one group of
//     products in flight while they wait for the next stage.
//   * Exact split-K: where the output tiles are fewer than the 132 SMs,
//     grid.z cuts K into up to 8 slices, and the slices of one output
//     tile form a thread-block cluster.  Each slice stages its int32
//     tile in shared memory; slice z then adds rows [z r, z r + r) of
//     every slice's tile, in slice order, through distributed shared
//     memory, and writes their epilogue.  Integer addition is exact in
//     any order, so the sum is the one-slice sum bit for bit; nothing
//     goes through global memory but the result.
//   * The epilogue writes four columns a thread from the staged tile
//     (16-byte stores), as w8_epilogue's (float(acc) * sx) * scale.
// The result equals w8_matmul_plain (ops/w8_kernel.py) bit for bit.  The
// wrapper picks the route and the split from the shape before the launch
// (ops/w8_kernel.py::k2_plan); shapes the tiles cannot take (K % 32 !=
// 0, rows not 16-byte aligned, M <= 16) take the GEMVs.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "w8_common.cuh"

namespace vx {
namespace {

namespace cg = cooperative_groups;

enum K2Route { kRouteGemv = 0, kRouteWgmma64 = 1, kRouteWgmma128 = 2 };

constexpr int kBK = 128;     // K bytes per stage: one 128-byte swizzle row
constexpr int kBN = 128;     // output columns per tile (wgmma N)
constexpr int kStages = 4;   // TMA ring depth
constexpr int kTileLd = kBN + 8;  // ints a row of the staged int32 tile
constexpr int kMaxSlices = 8;     // K slices: a portable cluster

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// A box of the 2-D tensor map at (k, row) into shared memory, completing
// on ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), the
// tile 1024-byte aligned.  The k32 slice s of a 128-byte row starts 32 s
// bytes further (the swizzle is applied by the hardware on the address).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, int8 in, exact int32 out.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int NWG>
constexpr size_t wgmma_smem_bytes() {
  // 1024 bytes of slack to align the ring; the A and B stages, reused
  // after the main loop for the int32 tile (kTileLd ints a row); the
  // full / empty barriers.
  constexpr size_t ring = static_cast<size_t>(kStages) * (64 * NWG + kBN) * kBK;
  constexpr size_t tile = static_cast<size_t>(64 * NWG) * kTileLd * 4;
  return 1024 + (ring > tile ? ring : tile) + 2 * kStages * sizeof(uint64_t);
}

// One CTA per (128-column tile n, 64 NWG-row tile m, K slice z); the
// slices of a tile form one cluster (1, 1, gridDim.z).  Warps 0 .. 4 NWG
// - 1 are the consumer warpgroups (rows 64 w .. 64 w + 63 of the tile
// each), warp 4 NWG the producer.  After the main loop every CTA stages
// its int32 tile in shared memory; slice z then adds rows [z r, z r + r)
// of every slice's tile (r = BM / slices) in slice order through
// distributed shared memory and writes their epilogue, four columns a
// thread.
template <int NWG>
__global__ void __launch_bounds__(128 * NWG + 32) w8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,
    const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ sx,
    const float* __restrict__ scale, float* __restrict__ out, int M, int N,
    int K, int kb_per_split) {
  constexpr int BM = 64 * NWG;
  constexpr int kThreads = 128 * NWG + 32;
  constexpr uint32_t kStageBytes = (BM + kBN) * kBK;
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t a0 = base;                              // [kStages][BM][128]
  const uint32_t b0 = base + kStages * BM * kBK;         // [kStages][BN][128]
  constexpr size_t ring = static_cast<size_t>(kStages) * (BM + kBN) * kBK;
  constexpr size_t tile_bytes = static_cast<size_t>(BM) * kTileLd * 4;
  const uint32_t bars =
      base + static_cast<uint32_t>(ring > tile_bytes ? ring : tile_bytes);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  int* part = reinterpret_cast<int*>(base_ptr);          // [BM][kTileLd]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kb_total = (K + kBK - 1) / kBK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = max(min(kb_per_split, kb_total - kb0), 0);
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        const int k = (kb0 + i) * kBK;
        tma_load_2d(a0 + s * BM * kBK, &tmap_x, k, m0, full(s));
        tma_load_2d(b0 + s * kBN * kBK, &tmap_w, k, n0, full(s));
      }
    }
  } else {
    // Consumers: stage i's products are issued, then stage i - 1's are
    // waited for and its buffers released, so one group stays in flight.
    const int wg = warp >> 2;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % kStages;
      mbar_wait(full(s), (i / kStages) & 1);
      const uint64_t da = sw128_desc(a0 + s * BM * kBK + wg * 64 * kBK);
      const uint64_t db = sw128_desc(b0 + s * kBN * kBK);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0) mbar_arrive(empty((i - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // Accumulator layout (m64nNk32): thread (warp wi of the warpgroup,
    // lane) holds rows 16 wi + lane / 4 (+ 8) and, for each 8-column
    // chunk c, columns 8 c + 2 (lane % 4) + {0, 1}: acc[4 c + 2 h + e].
    // Every stage was consumed, so the ring's memory takes the tile.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
    const int lane = threadIdx.x & 31, wi = warp & 3;
    const int r0 = wg * 64 + wi * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(part + (r0 + 8 * h) * kTileLd + 8 * c + c0) =
            make_int2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
  cl.sync();  // every slice's tile is in its shared memory

  const int slices = static_cast<int>(cl.num_blocks());
  const int z = static_cast<int>(cl.block_rank());
  const int rows = (BM + slices - 1) / slices;
  const bool vec = (N % 4) == 0;
  for (int it = threadIdx.x; it < rows * (kBN / 4); it += kThreads) {
    const int r = z * rows + it / (kBN / 4), c = 4 * (it % (kBN / 4));
    const int m = m0 + r, n = n0 + c;
    if (r >= BM || m >= M || n >= N) continue;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < slices; ++q) {  // slice order
      const int4 v = *reinterpret_cast<const int4*>(
          cl.map_shared_rank(part, q) + r * kTileLd + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float s = sx[m];
    float* o = out + static_cast<size_t>(m) * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(
          w8_epilogue(sum.x, s, scale[n]), w8_epilogue(sum.y, s, scale[n + 1]),
          w8_epilogue(sum.z, s, scale[n + 2]),
          w8_epilogue(sum.w, s, scale[n + 3]));
    } else {
      const int z4[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int e = 0; e < 4 && n + e < N; ++e)
        o[e] = w8_epilogue(z4[e], s, scale[n + e]);
    }
  }
  cl.sync();  // no CTA leaves while another reads its tile
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the
// library links no libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The 2-D map of an int8 [rows, K] row-major matrix, read in boxes of
// box_rows x 128 bytes with the 128-byte swizzle; out-of-bounds reads
// are zeros.
bool int8_tensor_map(CUtensorMap* map, const void* ptr, int rows, int K,
                     int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG>
cudaError_t launch_w8_wgmma(const int8_t* xq, const float* sx,
                            const int8_t* codes, const float* scale,
                            float* out, int M, int N, int K, int splits,
                            cudaStream_t st) {
  CUtensorMap tx, tw;
  if (!int8_tensor_map(&tx, xq, M, K, 64 * NWG) ||
      !int8_tensor_map(&tw, codes, N, K, kBN))
    return cudaErrorNotSupported;
  constexpr size_t smem = wgmma_smem_bytes<NWG>();
  const cudaError_t e = cudaFuncSetAttribute(
      w8_wgmma_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int kb_total = (K + kBK - 1) / kBK;
  const int kb_per = (kb_total + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + 64 * NWG - 1) / (64 * NWG),
                     splits);
  cfg.blockDim = dim3(128 * NWG + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8_wgmma_kernel<NWG>, tx, tw, sx, scale,
                            out, M, N, K, kb_per);
}

}  // namespace
}  // namespace vx

// route: kRouteGemv (w8_common.cuh's GEMVs: dp4a up to 8 rows, int8
// mma.sync up to 64 on aligned K % 64 == 0 rows, dp4a in groups of 8
// otherwise), kRouteWgmma64 / kRouteWgmma128 (the tensor-core GEMM with
// 64- or 128-row tiles; M > 16, K % 32 == 0, 16-byte aligned xq and
// codes).  splits (1 .. kMaxSlices) cuts K into that many slices, one
// cluster of slices per output tile.
extern "C" int vx_w8_matmul(const void* xq, const void* sx, const void* codes,
                            const void* scale, void* out, int M, int N, int K,
                            int route, int splits, void* stream) {
  using namespace vx;
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(codes);
  const float* s_x = static_cast<const float*>(sx);
  const float* s_w = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteGemv) {
    launch_w8_gemv(x8, s_x, w8, s_w, nullptr, o, M, N, K, st);
    return static_cast<int>(cudaGetLastError());
  }
  if ((route != kRouteWgmma64 && route != kRouteWgmma128) || M <= 16 ||
      K % 32 || !aligned16(xq) || !aligned16(codes) || splits < 1 ||
      splits > kMaxSlices)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      route == kRouteWgmma64
          ? launch_w8_wgmma<1>(x8, s_x, w8, s_w, o, M, N, K, splits, st)
          : launch_w8_wgmma<2>(x8, s_x, w8, s_w, o, M, N, K, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
