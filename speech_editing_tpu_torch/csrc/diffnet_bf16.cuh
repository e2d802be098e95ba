// What the bf16 forms of K1 (diffnet_block.cu) and K5 (diffnet_block_bwd.cu)
// share: a ring of weight tiles in shared memory filled by TMA, multicast
// over a thread-block cluster, and the warpgroup products (wgmma.cuh) that
// read it with A from registers.
//
// Every kernel here is a CTA of two consumer warpgroups (warps 0-7) on 64
// time rows and a producer warp (warp 8). The consumers stage their
// activations in shared memory in padded rows (row stride 16 mod 128
// bytes), load each k16 step's A operand from them by ldmatrix at any row
// offset (the conv taps' t - d, t, t + d: a row-shifted view that a wgmma
// descriptor could not start inside a swizzle atom), and multiply by
// weight tiles through descriptors, each warpgroup by its half of each
// tile's columns. Each product is a pair, two N-wide
// accumulators over the same A (K1: gate columns n and C + n, so the gate
// is thread-local; K5: output columns n and n + C/2).
//
// The ring: S stages (2-6, as shared memory allows; the host picks S), a
// stage the two weight tiles of BK = 64 k rows of one pair, each a tile of
// 64-byte-swizzled 32-element atoms (wgmma.cuh's layout):
//  * MN-major (K1's Wd, Wc and Wo, [K, 2C] with N contiguous): atom a holds
//    columns 32a.. of the 64 k rows, 64 bytes a row, 4096 bytes an atom;
//    k16 step s starts at row 16 s (desc_mn);
//  * K-major (K5's Wo^T and Wd^T read from Wo [C, 2C] and Wd [3C, 2C], k
//    contiguous): atom a holds k 32a.. of the N rows, 64 bytes a row, N * 64
//    bytes an atom; k16 step s starts in atom s / 2, 32 (s % 2) bytes in.
// Each atom is one TMA box of a 2-D tensor map over the weight with the
// 64-byte swizzle, whose pattern (address bits 4-5 XOR bits 7-8) is the
// descriptors' layout type 2. The producer warp waits for a stage's
// "empty" barrier, posts the stage's bytes on its "full" barrier
// (expect_tx) and issues its boxes. In a cluster of `share` CTAs that hold
// neighbouring time tiles (the same weights), CTA r issues boxes r, r +
// share, ... with .multicast::cluster, so each box lands in every CTA of the
// cluster at the same offset and completes each one's full barrier: the
// weights are read from L2 once a cluster, not once a tile. A stage's empty
// barrier counts the releases of the eight consumer warps of every CTA of
// the cluster (remote mbarrier arrives), since the next fill writes into
// all of them.
//
// A consumer warpgroup runs each stage as one batch of asynchronous
// wgmmas (4 k16 steps x 2 products) with A in one of two register buffers:
// after committing stage i it waits for stage i - 1's batch (wait<1>),
// releases that stage and reuses its A registers, so loads of the next A
// overlap the products in flight. (Two batches in flight, wait<2> with a
// third buffer, keep a stage more out of the ring, and measured slower.)
// Two warpgroups, rather than one on all the columns, halve each thread's
// accumulators and epilogue and give each scheduler two warps: with one
// warpgroup an SM, the epilogues' dependent chains ran exposed.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace bf16_form {

using bf16 = __nv_bfloat16;
using tf32x3::smem_u32;

constexpr int BK = 64;                      // k rows of a ring stage
constexpr int CONSUMERS = 256;              // two warpgroups on 64 time rows
constexpr int NTHREADS = CONSUMERS + 32;    // and the producer warp
constexpr int ROWS = wgmma::ROWS;
constexpr int MAX_STAGES = 6;
constexpr float RSQRT2 = 0.70710678118654752440f;

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a, b rounded to nearest into two consecutive bf16 (a at p)
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The gate's functions on the special-function unit (tanh.approx, relative
// error under 2^-10.9; sigmoid(x) = (1 + tanh(x / 2)) / 2): their results are
// rounded to bf16 (2^-9) or multiply values that are, and the accurate
// library forms' branches and divisions lengthen the epilogues' dependent
// chains, which few warps an SM leave exposed.
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return 0.5f + 0.5f * tanh_fast(0.5f * x);
}

// The A operand of one k16 step for this warp's 16 rows, from a row-major
// tile at a (the warp's first row, the step's first column; row stride ld
// bf16, 16 mod 128 bytes): ldmatrix.x4's matrices are (rows 0-7, k 0-7),
// (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15), lanes 8m ..
// 8m + 7 addressing the rows of matrix m, so that registers 0-3 are the
// wgmma (and mma.sync m16n8k16) A fragment a0-a3.
__device__ __forceinline__ void load_a(const bf16* a, int ld, int lane, uint32_t (&r)[4]) {
  const int m = lane >> 3;
  const bf16* p = a + ((m & 1) * 8 + (lane & 7)) * ld + (m >> 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Columns 8k + 2t, 8k + 2t + 1 of one row in r[k] (k < 4) of lane t of each
// quad (lanes 4g .. 4g + 3), as four accumulator tiles of a wgmma lay them
// out, bf16 pairs: exchanged among the quad by shuffles so that lane t holds
// the 8 columns 8t .. 8t + 7, one 16-byte store: a warp's store then
// writes 64 contiguous bytes of each of its 8 rows, not 16. Every lane of
// the warp calls it.
__device__ __forceinline__ uint4 quad_gather(const uint32_t (&r)[4], int lane) {
  const int t = lane & 3;
  const auto pick = [&](int i) { return i == 0 ? r[0] : i == 1 ? r[1] : i == 2 ? r[2] : r[3]; };
  uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // from lane (t + s) % 4 of the quad, which sends its r[(its t - s) % 4]
    const uint32_t got = __shfl_sync(0xffffffffu, pick((t - s) & 3), (lane & ~3) | ((t + s) & 3));
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = k == ((t + s) & 3) ? got : o[k];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// -- barriers, clusters and TMA ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (a CTA barrier when the launch
// has no cluster).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The consumer warpgroup alone (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// An arrival on the barrier at bar's offset in CTA `cta` of the cluster
// (this one included); with `release`, releasing this thread's earlier
// memory accesses to the cluster (not needed where the accesses were
// wgmma's reads, complete once its wait returned).
template <bool release>
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(cta));
  if (release)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Wait for the phase of the given parity, acquiring what the cluster's
// arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Box (c0, c1) (column, row) of the 2-D tensor map at map into shared
// memory at dst, completing bar's transaction; multicast to the CTAs of
// `mask` (each at the same offsets) unless mask is 0.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar, uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask == 0)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(m), "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
        "l"(m), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
}

// The ring's barriers and the consumers' release of a stage.
struct Ring {
  uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint64_t peers;   // K1's cluster split: g's shares of the peers have landed

  // one thread; `share` CTAs read each stage, `peers` arrivals complete
  // the split's exchange
  __device__ void init(int stages, int share, int n_peers) {
    for (int s = 0; s < stages; ++s) {
      tf32x3::mbar_init(&full[s], 1);
      tf32x3::mbar_init(&empty[s], CONSUMERS / 32 * share);
    }
    tf32x3::mbar_init(&peers, n_peers > 0 ? n_peers : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a consumer warp, once its products have read stage i: one arrival on
  // the stage's empty barrier of every CTA of the cluster that shares it
  __device__ void release(int i, int stages, int share, int lane) {
    __syncwarp();
    if (share == 1 && lane == 0) tf32x3::mbar_arrive(&empty[i % stages]);
    if (share > 1 && lane < share) mbar_arrive_cluster<false>(&empty[i % stages], lane);
  }
};

// The producer loop (one lane): stage i of n, its `boxes` boxes; box(i, j,
// map, c0, c1, offset) names box j; a cluster of `share` CTAs issues box j
// from CTA j % share to all of them.
template <typename Box>
__device__ __forceinline__ void produce(Ring& ring, uint8_t* tiles, int n, int stages,
                                        uint32_t stage_bytes, int boxes, int share,
                                        Box box) {
  const int rank = share > 1 ? (int)cluster_rank() : 0;
  const uint16_t mask = share > 1 ? (uint16_t)((1u << share) - 1) : 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    if (i >= stages) tf32x3::mbar_wait(&ring.empty[s], (i / stages - 1) & 1);
    mbar_expect_tx(&ring.full[s], stage_bytes);
    for (int j = rank; j < boxes; j += share) {
      const CUtensorMap* map;
      int c0, c1, offset;
      box(i, j, map, c0, c1, offset);
      tma_box(smem_u32(tiles + (size_t)s * stage_bytes + offset), map, c0, c1, &ring.full[s],
              mask);
    }
  }
}

// One ring stage of a pair product on the consumer warpgroup: A for k16
// steps 0-3 from arow (this warp's first row, the stage's first column;
// row stride lda) into a, then 8 wgmmas into lo and hi from the stage's
// tiles at lo_addr and hi_addr (B MN-major, TB = 1, or K-major, TB = 0,
// whose atoms are kblock bytes apart). scale 0 starts the sums.
template <int TB, int NACC>
__device__ __forceinline__ void stage_mma(float (&lo)[NACC], float (&hi)[NACC], uint32_t (&a)[4][4],
                                          const bf16* arow, int lda, uint32_t lo_addr,
                                          uint32_t hi_addr, uint32_t kblock, bool first, int lane) {
#pragma unroll
  for (int s = 0; s < 4; ++s) load_a(arow + 16 * s, lda, lane, a[s]);
  wgmma::fence_operands(a);
  wgmma::fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t dl = TB ? wgmma::desc_mn(lo_addr, s) : wgmma::desc_k(lo_addr, s, kblock);
    const uint64_t dh = TB ? wgmma::desc_mn(hi_addr, s) : wgmma::desc_k(hi_addr, s, kblock);
    wgmma::mma_rs<TB>(lo, a[s], dl, !(first && s == 0));
    wgmma::mma_rs<TB>(hi, a[s], dh, !(first && s == 0));
  }
  wgmma::commit();
}

// Stages first .. first + n - 1 of a product on a consumer warpgroup:
// run(i, a, start) loads stage i's A into a and issues its batch (start:
// the product's first stage); one batch stays in flight while the next is
// issued, each stage released once its batch has completed; before(k)
// runs ahead of stage first + k. The last batch is left for drain().
template <typename Run, typename Before>
__device__ __forceinline__ void issue_stages(Ring& ring, int first, int n, int stages, int share,
                                             int lane, Run run, Before before) {
  uint32_t a0[4][4], a1[4][4];
  const auto step = [&](int k, uint32_t (&a)[4][4]) {
    if (k >= n) return;
    before(k);
    run(first + k, a, k == 0);
    if (k > 0) {
      wgmma::wait<1>();
      ring.release(first + k - 1, stages, share, lane);
    }
  };
  for (int k = 0; k < n; k += 2) {
    step(k, a0);
    step(k + 1, a1);
  }
}

// The batch issue_stages left in flight: waited for and its stage released.
__device__ __forceinline__ void drain(Ring& ring, int first, int n, int stages, int share,
                                      int lane) {
  wgmma::wait<0>();
  ring.release(first + n - 1, stages, share, lane);
}

// The K-major and MN-major tiles of a stage: two of n * 128 bytes (64 k
// rows of n columns, or n rows of 64 k).
__host__ __device__ constexpr uint32_t tile_bytes(int n) { return (uint32_t)n * 128; }

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the runtime loaded
// (no link against libcuda, no toolkit-version-specific entry point).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib != nullptr ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
                          : nullptr;
  }();
  return fn;
}

// A map of the row-major bf16 matrix w [rows, cols] in boxes of 32 columns
// (64 bytes) by box_rows rows, 64-byte swizzle. 0 or a CUDA error.
inline int weight_map(CUtensorMap* map, const bf16* w, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The ring stages that fit beside `fixed` bytes of activations (and 1024
// of alignment) in a block of `kernel`, at most MAX_STAGES; 0 if fewer
// than two do.
template <typename Kernel>
int ring_stages(Kernel kernel, size_t fixed, size_t stage_bytes) {
  const size_t limit = tf32x3::max_dynamic_smem(kernel);
  if (limit < fixed + 1024 + 2 * stage_bytes) return 0;
  const size_t s = (limit - fixed - 1024) / stage_bytes;
  return s < (size_t)MAX_STAGES ? (int)s : MAX_STAGES;
}

// A launch of Kernel (args: its parameters' addresses) on grid CTAs in
// clusters of `cluster`, NTHREADS each, with smem bytes of dynamic shared
// memory; the first call sets the kernel's limit to the largest block.
template <auto Kernel>
int launch_clustered(int grid, int cluster, size_t smem, cudaStream_t stream, void** args) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tf32x3::max_dynamic_smem(Kernel));
  if (allowed != cudaSuccess) return (int)allowed;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(Kernel), args);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// A plan's value kept at cache[index] (racing threads store the same
// value); compute() (at least 0) on a miss.
template <typename Compute>
int cached(int (&cache)[256], int index, Compute compute) {
  int v = __atomic_load_n(&cache[index], __ATOMIC_RELAXED);
  if (v == 0) {
    v = compute() + 1;
    __atomic_store_n(&cache[index], v, __ATOMIC_RELAXED);
  }
  return v - 1;
}

}  // namespace bf16_form
