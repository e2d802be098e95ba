// Non-causal softmax attention backward with key padding, float32, sm_90a.
//
// Replaces the backward of the Pallas TPU flash attention that
// speech_editing_tpu/ops/flash_attention.py (flash_mha -> _flash_bhtd)
// drives: the custom VJP of JAX's bundled
// jax/experimental/pallas/ops/tpu/flash_attention.py (_flash_attention_bwd_dkv
// and _flash_attention_bwd_dq, with di = rowsum(o * do) computed outside
// them). Over [B, T, h, d], q pre-scaled (sm_scale = 1), with lse [B, h, Tq]
// the forward's per-row logsumexp:
//   di_i  = sum_c o_ic do_ic
//   p_ij  = exp(q_i . k_j - lse_i)   (0 for a pad key j, or a row with no
//                                      valid key: lse_i = -inf)
//   dv_j  = sum_i p_ij do_i
//   ds_ij = p_ij (do_i . v_j - di_i)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// Pad keys get exactly zero dk and dv; a row with no valid key gets dq = 0.
//
// Bound on the H100: bytes. At the train shape (B = 78, T = 48 tokens,
// h = 2, d = 96, 24-48 valid keys a row) the five products are
// 10*T*h*d*sum(valid keys) = 0.25 GFLOP, 1.5 us at the 3xTF32 rate (495 / 3
// = 165 TFLOP/s), against 23 MB of q, k, v, o, do, dq, dk and dv, 6.9 us at
// 3.35 TB/s. The design reads each input once and writes each output once,
// in one launch, and keeps S, P, dP and dS on chip.
//
// Design: one CTA of 8 warps per (64-key tile, head, batch row); di is
// computed inside.
//  * When Tq <= 64 and Tk <= 64 (every call of the flagship paths) one CTA
//    per (b, h) does everything. It stages Q, K, V and dO once with
//    cp.async (rows 4 mod 32 floats apart, zero-filled to the m16 tile and
//    d to the k8 step, any d <= 128), and O in the rows that P and dS take
//    later, where it forms di = rowsum(O dO). It forms S = Q K^T and dP =
//    dO V^T once each (three independent mma chains a tile), P = exp(S -
//    lse) and dS = P (dP - di) into shared memory, then dV = P^T dO, dK =
//    dS^T Q and dQ = dS K: five products, all on the tensor cores at
//    float32 accuracy (3xTF32 mma.sync, tf32x3.cuh; k-permuted fragments,
//    so the transposed operands load without bank conflicts). Keys past the
//    tile's last valid key take no part in any product.
//  * In the last three products warps 0-3 hold dV and warps 4-7 dK, each
//    over every m16 row tile and a quarter of the d columns, and dQ is
//    spread the same way, so the four SM sub-partitions share every product
//    evenly; dQ is written once, with no atomics. At B = 78, h = 2 the 156
//    CTAs fit on the 132 SMs at two a SM (103 KB of shared memory and at
//    most 128 registers a thread each), so there is no second wave.
//  * Longer sequences take key tiles of 64: each key tile's CTA loops over
//    the query tiles and accumulates dK and dV; dQ takes a second pass in
//    the same launch, one CTA per query tile looping over the key tiles,
//    which forms S and dP again (seven products where the single tile
//    needs five). No atomics, and no zeroed buffer: every output element
//    is written once by one thread, in a fixed order, so results are
//    bit-reproducible from run to run.
// The attribute that lets a CTA take more than 48 KB of shared memory is
// set once per process.
//
// The bf16 form (attention_bwd_bf16) replaces the same backward run on bf16
// q, k, v, o and do (the JAX package's use_bf16 training). It rounds where
// the Pallas backward rounds (_flash_attention_dkv_kernel,
// _flash_attention_dq_kernel): s = q k^T and dp = do v^T accumulated in
// f32 from the bf16 operands, p and ds = p (dp - di) in f32 with di =
// rowsum(o do) in f32; dv = p^T do with p cast to bf16, dk = ds^T q and dq
// = ds k with ds cast to bf16, each accumulated in f32 and rounded once to
// bf16. Bound on the H100: bytes at the flagship's B = 78 x S = 48 (11.5
// MB, 3.4 us, against 0.25 GFLOP, 0.25 us at 989 TFLOP/s); operations on
// CampNet's decoder rows (T = 1536: five products over the valid keys,
// 50.7 GFLOP, 51 us, against 38 MB, 11 us). Design, on Hopper's warpgroup
// products (wgmma.cuh), still one launch with no atomics and no zeroed
// buffer, every output element written once in a fixed order:
//  * Key CTAs, one warpgroup each: 64 keys whose K and V stay staged; the
//    query tiles (Q, dO, O and lse of 64 rows) come through a two-stage
//    cp.async ring, di = rowsum(O dO) formed once a tile as it arrives
//    (two threads a row). S^T = K Q^T and dP^T = V dO^T run on shared-memory
//    wgmma (K-major); P^T = exp(S^T - lse) and dS^T = P^T (dP^T - di) in f32
//    registers, rounded there to bf16 as the A operands of dV += P^T dO and
//    dK += dS^T Q (register-A wgmma; dO and Q MN-major). dK and dV stay in
//    f32 registers across the loop (226 registers a thread at d = 96, no
//    spills). A CTA of only pad keys writes zeros and returns.
//  * dQ CTAs, one warpgroup each: 64 query rows (Q, dO staged once, di from
//    O once) over the key tiles that have a valid key, through the ring;
//    S = Q K^T and dP = dO V^T (K-major), P and dS in registers, dQ += dS K
//    (dS rounded as the register A, K MN-major), dQ stored once. The two
//    kinds recompute S and dP: seven products where five would do.
//  * One key tile (Tk <= 64, every call of the flagship paths): the key
//    CTAs form dQ too, from dS^T stored in shared memory as its bf16 (A and
//    K both MN-major), and there are no dQ CTAs: five products.
// Pad keys get dk = dv = 0 exactly, a row with no valid key dq = 0. Every
// exponential is ex2.approx.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

using namespace tf32x3;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 64;         // query rows and keys of a tile
constexpr int LDP = TILE + 4;    // row stride of P and dS: 4 mod 32 floats
constexpr int MT = TILE / 16;    // m16 tiles of a tile

// Rows staged of a tile of n <= TILE rows: whole m16 tiles.
__host__ __device__ inline int tile_rows(int n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int first_tile(int T) {
  return tile_rows(T < TILE ? T : TILE);
}

// Q and dO, K and V, P and dS, for the first (largest) tiles of Tq and Tk.
template <int NDT>
size_t smem_bytes(int Tq, int Tk) {
  const int qc = first_tile(Tq), kc = first_tile(Tk);
  return sizeof(float) * ((size_t)(2 * qc + 2 * kc) * row_ld<NDT>() + (size_t)2 * qc * LDP);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Smem {
  float *q, *dout, *k, *v, *p, *ds;
  float *lse, *di, *valid;   // [TILE] each
};

// The key rows the products need: through the tile's last valid key, in
// whole m16 tiles (keys past it have p = 0, so dk = dv = 0 and no share in
// dq).
__device__ __forceinline__ int live_rows(const float* valid, int kr) {
  const int lane = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(0xffffffffu, lane < kr && valid[lane] > 0.f);
  const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < kr && valid[lane + 32] > 0.f);
  const int last = hi ? 63 - __clz(hi) : lo ? 31 - __clz(lo) : -1;
  return tile_rows(last + 1);
}

// Stages the query tile (Q, dO, lse, and di from O and dO) and/or the key
// tile (K, V, which keys are valid). O lands in the rows of P and dS, which
// are free until p_and_ds (LD <= 2 LDP), and di is formed there. Returns
// live_rows of a new key tile.
template <int DP, int LD>
__device__ __forceinline__ int stage_tiles(const Smem& sm, bool new_q, bool new_k,
                                            const float* q, const float* k, const float* v,
                                            const float* o, const float* dout, const float* lse,
                                            const unsigned char* key_pad, int b, int hh, int q0,
                                            int nq, int k0, int nk, int Tq, int Tk, int H, int D,
                                            bool vec) {
  static_assert(LD <= 2 * LDP, "O does not fit in the rows of P and dS");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = tile_rows(nq), kr = tile_rows(nk);
  if (new_q) {
    stage_rows<DP, LD>(sm.q, q, b, q0, qr, Tq, H, D, hh, vec, tid, NTHREADS);
    stage_rows<DP, LD>(sm.dout, dout, b, q0, qr, Tq, H, D, hh, vec, tid, NTHREADS);
    stage_rows<DP, LD>(sm.p, o, b, q0, qr, Tq, H, D, hh, vec, tid, NTHREADS);
  }
  if (new_k) {
    stage_rows<DP, LD>(sm.k, k, b, k0, kr, Tk, H, D, hh, vec, tid, NTHREADS);
    stage_rows<DP, LD>(sm.v, v, b, k0, kr, Tk, H, D, hh, vec, tid, NTHREADS);
  }
  cp_async_commit();
  if (new_k) {
    for (int r = tid; r < kr; r += NTHREADS) {
      const int key = k0 + r;
      sm.valid[r] = r < nk && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key]);
    }
  }
  if (new_q) {
    for (int r = tid; r < qr; r += NTHREADS)
      sm.lse[r] = r < nq ? lse[((size_t)b * H + hh) * Tq + q0 + r] : -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();
  const int live = new_k ? live_rows(sm.valid, kr) : 0;
  if (!new_q) return live;
  // di = rowsum(o * do), a warp a row (columns past D are zero in both)
  for (int r = warp; r < qr; r += NWARPS) {
    float acc = 0.f;
#pragma unroll
    for (int c = lane; c < DP; c += 32) acc = fmaf(sm.p[r * LD + c], sm.dout[r * LD + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) sm.di[r] = acc;
  }
  __syncthreads();   // O is read: P and dS may take its rows
  return live;
}

// P and dS [qr][kl] of the staged tiles, one (m16, n8) tile a job: S = Q K^T
// and dP = dO V^T, each formed once.
template <int DP, int LD>
__device__ __forceinline__ void p_and_ds(const Smem& sm, int qr, int kl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nnt = kl / 8, n_jobs = qr / 16 * nnt;
  for (int job = warp; job < n_jobs; job += NWARPS) {
    const int r0 = job / nnt * 16, c0 = job % nnt * 8;
    float sp[3][4] = {}, dpp[3][4] = {}, s[4], dp[4];
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      uint32_t qhi[4], qlo[4], dhi[4], dlo[4], khi[2], klo[2], vhi[2], vlo[2];
      load_a(sm.q + r0 * LD + kk, LD, lane, qhi, qlo);
      load_a(sm.dout + r0 * LD + kk, LD, lane, dhi, dlo);
      load_b<false>(sm.k + c0 * LD + kk, LD, lane, khi, klo);
      load_b<false>(sm.v + c0 * LD + kk, LD, lane, vhi, vlo);
      mma3_sep(sp, qhi, qlo, khi, klo);
      mma3_sep(dpp, dhi, dlo, vhi, vlo);
    }
    sum3(sp, s);
    sum3(dpp, dp);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr, c = c0 + 2 * t4;
      const float lse_r = sm.lse[r], di_r = sm.di[r];
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = lse_r != -INFINITY && sm.valid[c + e] > 0.f;
        p[e] = live ? expf(s[2 * hr + e] - lse_r) : 0.f;
        ds[e] = live ? p[e] * (dp[2 * hr + e] - di_r) : 0.f;
      }
      st2(sm.p + r * LDP + c, p[0], p[1]);
      st2(sm.ds + r * LDP + c, ds[0], ds[1]);
    }
  }
}

// A warp's accumulator tiles in the last three products. dV (warps 0-3) and
// dK (warps 4-7): every m16 key tile, and the NKV n8 column tiles w % 4 +
// 4i. dQ: every m16 query tile, and the n8 column tiles w + 8i (NQ at most).
// So each SM sub-partition (warps s and s + 4) takes an equal share of every
// product whatever the number of rows, and a B fragment serves every m16
// tile.
template <int NDT>
struct Own {
  static constexpr int NKV = NDT / 4, NQ = (NDT + 7) / 8;
};

// dV += P^T dO (or dK += dS^T Q) over the qr staged query rows, for the key
// rows below kl.
template <int NDT, int LD>
__device__ __forceinline__ void add_kv(const Smem& sm, float (&acc)[MT][Own<NDT>::NKV][4],
                                       bool is_dk, int qr, int kl) {
  constexpr int NKV = Own<NDT>::NKV;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const float* a = is_dk ? sm.ds : sm.p;
  const float* bs = is_dk ? sm.q : sm.dout;
  for (int kq = 0; kq < qr; kq += 8) {
    uint32_t bh[NKV][2], bl[NKV][2];
#pragma unroll
    for (int i = 0; i < NKV; ++i) load_b_kp(bs + kq * LD + (w4 + 4 * i) * 8, LD, lane, bh[i], bl[i]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (16 * mt >= kl) break;
      uint32_t ah[4], al[4];
      load_at_kp(a + kq * LDP + 16 * mt, LDP, lane, ah, al);
#pragma unroll
      for (int i = 0; i < NKV; ++i) mma3(acc[mt][i], ah, al, bh[i], bl[i]);
    }
  }
}

// dQ += dS K over the key rows below kl, for the M m16 query tiles from m0,
// those below qr.
template <int NDT, int LD, int M>
__device__ __forceinline__ void add_dq(const Smem& sm, float (&acc)[M][Own<NDT>::NQ][4], int m0,
                                       int qr, int kl) {
  constexpr int NQ = Own<NDT>::NQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kk = 0; kk < kl; kk += 8) {
    uint32_t bh[NQ][2], bl[NQ][2];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      if (warp + 8 * i < NDT) load_b_kp(sm.k + kk * LD + (warp + 8 * i) * 8, LD, lane, bh[i], bl[i]);
#pragma unroll
    for (int mt = 0; mt < M; ++mt) {
      if (16 * (m0 + mt) >= qr) break;
      uint32_t ah[4], al[4];
      load_a_kp(sm.ds + 16 * (m0 + mt) * LDP + kk, LDP, lane, ah, al);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        if (warp + 8 * i < NDT) mma3(acc[mt][i], ah, al, bh[i], bl[i]);
    }
  }
}

// Writes a warp's accumulator tiles, acc[mt][i] at rows t0 + 16 mt and
// columns 8 (n0 + nstep i), to head hh of batch row b of x [B, T, H, D],
// rows < T and columns < D, two floats a store where D is even.
template <int M, int NI>
__device__ __forceinline__ void store_tiles(float* x, const float (&acc)[M][NI][4], int b,
                                            int t0, int T, int H, int D, int hh, int n0,
                                            int nstep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < M; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + 16 * mt + g + 8 * hr;
      if (t >= T) continue;
      float* row = x + ((size_t)b * T + t) * H * D + (size_t)hh * D;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = (n0 + nstep * i) * 8 + 2 * t4;
        const float v0 = acc[mt][i][2 * hr], v1 = acc[mt][i][2 * hr + 1];
        if (D % 2 == 0) {
          if (c < D) st2(row + c, v0, v1);
        } else {
          if (c < D) row[c] = v0;
          if (c + 1 < D) row[c + 1] = v1;
        }
      }
    }
}

// blockIdx.x < n_kv: the CTA of key tile blockIdx.x, over every query tile
// (and dq too when n_kv == 1); else the dq CTA of query tile blockIdx.x -
// n_kv, over every key tile.
template <int NDT, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB) attention_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, const unsigned char* __restrict__ key_pad,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
    int H, int D, int n_kv, int vec) {
  constexpr int DP = NDT * 8, LD = row_ld<NDT>();
  constexpr int NKV = Own<NDT>::NKV, NQ = Own<NDT>::NQ;
  extern __shared__ float4 smem4[];
  __shared__ float lse_s[TILE], di_s[TILE], valid_s[TILE];
  const int qc = first_tile(Tq), kc = first_tile(Tk);
  Smem sm;
  sm.q = reinterpret_cast<float*>(smem4);   // [qc][LD]
  sm.dout = sm.q + qc * LD;                   // [qc][LD]
  sm.k = sm.dout + qc * LD;                   // [kc][LD]
  sm.v = sm.k + kc * LD;                      // [kc][LD]
  sm.p = sm.v + kc * LD;                      // [qc][LDP]
  sm.ds = sm.p + qc * LDP;                    // [qc][LDP]
  sm.lse = lse_s;
  sm.di = di_s;
  sm.valid = valid_s;

  const int b = blockIdx.z, hh = blockIdx.y, warp = threadIdx.x >> 5;
  if (blockIdx.x < n_kv) {
    const int k0 = blockIdx.x * TILE, nk = max(0, min(TILE, Tk - k0));
    const int n_qt = max(1, (Tq + TILE - 1) / TILE);
    const bool is_dk = warp >= 4;
    float kv_acc[MT][NKV][4] = {};   // dV or dK
    int kl = 0;
    for (int it = 0; it < n_qt; ++it) {
      const int q0 = it * TILE, nq = max(0, min(TILE, Tq - q0)), qr = tile_rows(nq);
      if (it > 0) __syncthreads();   // the last query tile is no longer read
      const int live = stage_tiles<DP, LD>(sm, true, it == 0, q, k, v, o, dout, lse, key_pad, b,
                                           hh, q0, nq, k0, nk, Tq, Tk, H, D, vec);
      if (it == 0) kl = live;
      p_and_ds<DP, LD>(sm, qr, kl);
      __syncthreads();
      add_kv<NDT, LD>(sm, kv_acc, is_dk, qr, kl);
      // every key is here: this tile's dq is whole, one m16 tile at a time
      for (int mt = 0; n_kv == 1 && 16 * mt < qr; ++mt) {
        float dq_acc[1][NQ][4] = {};
        add_dq<NDT, LD, 1>(sm, dq_acc, mt, qr, kl);
        store_tiles<1, NQ>(dq, dq_acc, b, q0 + 16 * mt, Tq, H, D, hh, warp, 8);
      }
    }
    store_tiles<MT, NKV>(is_dk ? dk : dv, kv_acc, b, k0, Tk, H, D, hh, warp & 3, 4);
  } else {
    const int q0 = (blockIdx.x - n_kv) * TILE, nq = max(0, min(TILE, Tq - q0));
    const int qr = tile_rows(nq);
    float dq_acc[MT][NQ][4] = {};
    for (int it = 0; it < n_kv; ++it) {
      const int k0 = it * TILE, nk = max(0, min(TILE, Tk - k0));
      if (it > 0) __syncthreads();   // the last key tile is no longer read
      const int kl = stage_tiles<DP, LD>(sm, it == 0, true, q, k, v, o, dout, lse, key_pad, b,
                                         hh, q0, nq, k0, nk, Tq, Tk, H, D, vec);
      p_and_ds<DP, LD>(sm, qr, kl);
      __syncthreads();
      add_dq<NDT, LD, MT>(sm, dq_acc, 0, qr, kl);
    }
    store_tiles<MT, NQ>(dq, dq_acc, b, q0, Tq, H, D, hh, warp, 8);
  }
}

template <int NDT>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, const unsigned char* key_pad, float* dq, float* dk, float* dv,
           int B, int Tq, int Tk, int H, int D, bool vec, cudaStream_t stream) {
  // two CTAs a SM where their registers allow (128 a thread)
  constexpr int MINB = NDT <= 12 ? 2 : 1;
  auto kernel = attention_bwd_kernel<NDT, MINB>;
  // once per process: room for the largest tiles (64 x 64)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<NDT>(TILE, TILE));
  if (attr != cudaSuccess) return (int)attr;
  const int n_kv = Tk > TILE ? (Tk + TILE - 1) / TILE : 1;
  const int n_q = n_kv == 1 ? 0 : Tq > TILE ? (Tq + TILE - 1) / TILE : 1;
  const size_t smem = smem_bytes<NDT>(Tq, Tk);
  kernel<<<dim3(n_kv + n_q, H, B), NTHREADS, smem, stream>>>(q, k, v, o, dout, lse, key_pad, dq,
                                                            dk, dv, Tq, Tk, H, D, n_kv, vec);
  return (int)cudaGetLastError();
}


// -- the bf16 form -------------------------------------------------------------

namespace bf16_form {

using namespace attention_bf16;
using bf16 = __nv_bfloat16;
using wgmma::Tile;
using wgmma::align1024;
using wgmma::stage_tile;

constexpr int ROWS = wgmma::ROWS;   // keys of a key CTA, query rows of a dQ CTA, rows of a tile
constexpr int NT = 128;             // one warpgroup a CTA
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of either kind of CTA: eight tiles, and dS^T (64 x 64)
// where the key CTAs form dQ; 1024-byte aligned.
template <int DP, bool WITH_DQ>
constexpr int smem_bytes() {
  return 1024 + 8 * Tile<DP>::BYTES + (WITH_DQ ? Tile<ROWS>::BYTES : 0);
}

// di = rowsum(O dO) in f32 of the 64 staged rows, two threads a row, into
// di[64]; the caller synchronises before and after.
template <int DP>
__device__ __forceinline__ void row_dots(const uint8_t* o_s, const uint8_t* do_s, float* di) {
  constexpr int CPR = DP / 8;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float acc = 0.f;
#pragma unroll
  for (int c8 = half * (CPR / 2); c8 < (half + 1) * (CPR / 2); ++c8) {
    const int off = Tile<DP>::chunk(r, 8 * c8);
    const uint4 a = *reinterpret_cast<const uint4*>(o_s + off);
    const uint4 d = *reinterpret_cast<const uint4*>(do_s + off);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[i]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) di[r] = acc;
}

// An accumulator's rows row0 and row0 + 8 (below T) to head hh of batch
// row b of x [B, T, H, D], rounded once to bf16.
template <int NACC>
__device__ __forceinline__ void store_rows(bf16* x, const float (&acc)[NACC], int b, int row0,
                                           int T, int H, int D, int hh, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    bf16* dst = x + (((size_t)b * T + row) * H + hh) * D;
#pragma unroll
    for (int jj = 0; jj < NACC / 4; ++jj)
      store2(dst, 8 * jj + 2 * t4, D, acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
  }
}

// p = exp(s - lse) and ds = p (dp - di) over one accumulator pair, in
// place; 0 where the key is padding or the row has no valid key.
__device__ __forceinline__ void p_ds(float& s, float& dp, bool live, float lse2, float di) {
  const float p = live ? exp2_approx(fmaf(s, LOG2E, -lse2)) : 0.f;
  dp = live ? p * (dp - di) : 0.f;
  s = p;
}

// The key CTA of keys [k0, k0 + 64): K and V stay staged; the query tiles
// (Q, dO, O, lse) come through a two-stage ring. S^T = K Q^T and dP^T =
// V dO^T (shared-memory operands, K-major), P^T and dS^T in registers,
// then dV += P^T dO and dK += dS^T Q (A from registers, dO and Q MN-major).
// WITH_DQ (every key in this one tile, Tk <= 64): each query tile's dQ is
// whole here too, dQ = dS K from dS^T stored in shared memory (both
// operands MN-major), so there are no dQ CTAs: five products, not seven.
template <int DP, bool WITH_DQ>
__device__ __forceinline__ void key_cta(uint8_t* base, uint64_t* masks, float (*lse_s)[ROWS],
                                        float (*di_s)[ROWS], const bf16* q, const bf16* k,
                                        const bf16* v, const bf16* o, const bf16* dout,
                                        const float* lse, const unsigned char* key_pad, bf16* dq,
                                        bf16* dk, bf16* dv, int k0, int Tq, int Tk, int H, int D,
                                        bool vec) {
  constexpr int NACC = DP / 2, TB = Tile<DP>::BYTES;
  const int b = blockIdx.z, hh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint8_t* const k_s = base;
  uint8_t* const v_s = base + TB;
  uint8_t* const ring = base + 2 * TB;   // stage s: Q, dO, O at ring + 3 s TB
  uint8_t* const dst_s = base + 8 * TB;  // dS^T [64 keys][64 queries] (WITH_DQ)

  stage_tile<DP>(k_s, k, b, k0, Tk, H, D, hh, vec, tid, NT);
  stage_tile<DP>(v_s, v, b, k0, Tk, H, D, hh, vec, tid, NT);
  cp_async_commit();
  tile_masks(masks, key_pad, b, Tk, k0 / ROWS, 1);
  __syncthreads();
  const uint64_t keys = masks[0];
  const int nk = min(ROWS, Tk - k0);
  if (keys == 0) {   // only pad keys: dk = dv = 0 (and dq = 0 where they are all the keys)
    for (int e = tid; e < nk * D; e += NT) {
      const size_t at = (((size_t)b * Tk + k0 + e / D) * H + hh) * D + e % D;
      dk[at] = dv[at] = __float2bfloat16_rn(0.f);
    }
    for (int e = tid; WITH_DQ && e < Tq * D; e += NT)
      dq[(((size_t)b * Tq + e / D) * H + hh) * D + e % D] = __float2bfloat16_rn(0.f);
    cp_async_wait_all();
    return;
  }
  // this thread's key rows 16 warp + g and + 8
  const bool key_ok[2] = {bool((keys >> (16 * warp + g)) & 1), bool((keys >> (16 * warp + g + 8)) & 1)};

  auto stage_query = [&](int it, int st) {
    uint8_t* t = ring + 3 * st * TB;
    const int q0 = it * ROWS;
    stage_tile<DP>(t, q, b, q0, Tq, H, D, hh, vec, tid, NT);
    stage_tile<DP>(t + TB, dout, b, q0, Tq, H, D, hh, vec, tid, NT);
    stage_tile<DP>(t + 2 * TB, o, b, q0, Tq, H, D, hh, vec, tid, NT);
    if (tid < ROWS) {
      if (q0 + tid < Tq)
        cp_async4(&lse_s[st][tid], lse + ((size_t)b * H + hh) * Tq + q0 + tid);
      else
        lse_s[st][tid] = -INFINITY;
    }
    cp_async_commit();
  };

  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  float dv_acc[NACC], dk_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  const int n_qt = (Tq + ROWS - 1) / ROWS;
  if (n_qt > 0) stage_query(0, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    wgmma::fence_proxy_async();
    __syncthreads();   // query tile it landed; the other stage is no longer read
    if (it + 1 < n_qt) stage_query(it + 1, st ^ 1);
    uint8_t* const t = ring + 3 * st * TB;
    row_dots<DP>(t + 2 * TB, t + TB, di_s[st]);
    __syncthreads();
    const uint32_t q_addr = smem_u32(t), do_addr = q_addr + TB;

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float s[32], dp[32];
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::mma_ss<0, 0>(s, wgmma::desc_k(k_addr, kk), wgmma::desc_k(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::mma_ss<0, 0>(dp, wgmma::desc_k(v_addr, kk), wgmma::desc_k(do_addr, kk), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - di), per query column
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * t4;
      const float2 ls = *reinterpret_cast<const float2*>(&lse_s[st][c]);
      const float2 dd = *reinterpret_cast<const float2*>(&di_s[st][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = e & 1 ? ls.y : ls.x, dq = e & 1 ? dd.y : dd.x;
        p_ds(s[4 * jj + e], dp[4 * jj + e], key_ok[e >> 1] && lq != -INFINITY, lq * LOG2E, dq);
      }
    }
    // dV += P^T dO, dK += dS^T Q: the A operands are the rounded accumulators
    uint32_t pa[ROWS / 16][4], da[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      wgmma::acc_to_a(s, kk, pa[kk]);
      wgmma::acc_to_a(dp, kk, da[kk]);
    }
    wgmma::fence_operands(pa);
    wgmma::fence_operands(da);
    wgmma::fence_operands(dv_acc);
    wgmma::fence_operands(dk_acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma::mma_rs<1>(dv_acc, pa[kk], wgmma::desc_mn(do_addr, kk), 1);
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma::mma_rs<1>(dk_acc, da[kk], wgmma::desc_mn(q_addr, kk), 1);
    if constexpr (WITH_DQ) {
      // dS^T into shared memory as the bf16 it was rounded to: register a of
      // k16 step kk holds keys 16 warp + g (+ 8 for a1, a3), queries 16 kk +
      // 2 t4 (+ 8 for a2, a3) and the next
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * warp + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1);
          *reinterpret_cast<uint32_t*>(dst_s + Tile<ROWS>::chunk(r, c) + 4 * t4) = da[kk][i];
        }
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(dv_acc);
    wgmma::fence_operands(dk_acc);
    if constexpr (WITH_DQ) {
      // dQ = dS K over the 64 keys: A = dS (queries down, stored k-rows of dS^T), B = K
      wgmma::fence_proxy_async();
      __syncthreads();
      float dq_acc[NACC];
      wgmma::fence_operands(dq_acc);
      wgmma::fence();
      const uint32_t dst_addr = smem_u32(dst_s);
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        wgmma::mma_ss<1, 1>(dq_acc, wgmma::desc_mn(dst_addr, kk), wgmma::desc_mn(k_addr, kk),
                            kk > 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operands(dq_acc);
      store_rows(dq, dq_acc, b, it * ROWS + 16 * warp + g, Tq, H, D, hh, t4);
    }
  }
  cp_async_wait_all();

  // dk, dv rounded once; a pad key's rows are 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + g + 8 * r;
    if (key >= Tk) continue;
    const size_t at = (((size_t)b * Tk + key) * H + hh) * D;
    const float keep = key_ok[r] ? 1.f : 0.f;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int c = 8 * jj + 2 * t4, i = 4 * jj + 2 * r;
      store2(dv + at, c, D, dv_acc[i] * keep, dv_acc[i + 1] * keep);
      store2(dk + at, c, D, dk_acc[i] * keep, dk_acc[i + 1] * keep);
    }
  }
}

// The dQ CTA of query rows [q0, q0 + 64): Q, dO (and O, for di) stay
// staged; the key tiles with a valid key (K, V) come through a two-stage
// ring. S = Q K^T and dP = dO V^T (K-major), P and dS in registers, dQ +=
// dS K (A from registers, K MN-major).
template <int DP>
__device__ __forceinline__ void dq_cta(uint8_t* base, uint64_t* masks, float* di_s,
                                       const bf16* q, const bf16* k, const bf16* v,
                                       const bf16* o, const bf16* dout, const float* lse,
                                       const unsigned char* key_pad, bf16* dq, int q0, int Tq,
                                       int Tk, int H, int D, bool vec) {
  constexpr int NACC = DP / 2, TB = Tile<DP>::BYTES;
  const int b = blockIdx.z, hh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint8_t* const q_s = base;
  uint8_t* const do_s = base + TB;
  uint8_t* const o_s = base + 2 * TB;
  uint8_t* const ring = base + 3 * TB;   // stage s: K, V at ring + 2 s TB

  stage_tile<DP>(q_s, q, b, q0, Tq, H, D, hh, vec, tid, NT);
  stage_tile<DP>(do_s, dout, b, q0, Tq, H, D, hh, vec, tid, NT);
  stage_tile<DP>(o_s, o, b, q0, Tq, H, D, hh, vec, tid, NT);
  cp_async_commit();
  // this thread's rows 16 warp + g and + 8: lse (log2 units) and di
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lse2[r] = row < Tq ? lse[((size_t)b * H + hh) * Tq + row] * LOG2E : -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();
  row_dots<DP>(o_s, do_s, di_s);
  wgmma::fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) di[r] = di_s[16 * warp + g + 8 * r];

  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  float dq_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dq_acc[i] = 0.f;
  const auto stage = [&](int j, int st) {
    uint8_t* t = ring + 2 * st * TB;
    stage_tile<DP>(t, k, b, j * ROWS, Tk, H, D, hh, vec, tid, NT);
    stage_tile<DP>(t + TB, v, b, j * ROWS, Tk, H, D, hh, vec, tid, NT);
    cp_async_commit();
  };
  const auto compute = [&](int st, uint64_t keys) {
    const uint32_t k_addr = smem_u32(ring + 2 * st * TB), v_addr = k_addr + TB;
    float s[32], dp[32];
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::mma_ss<0, 0>(s, wgmma::desc_k(q_addr, kk), wgmma::desc_k(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::mma_ss<0, 0>(dp, wgmma::desc_k(do_addr, kk), wgmma::desc_k(v_addr, kk), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t4 + (i & 1), r = (i >> 1) & 1;
      p_ds(s[i], dp[i], ((keys >> col) & 1) && lse2[r] != -INFINITY, lse2[r], di[r]);
    }
    uint32_t da[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) wgmma::acc_to_a(dp, kk, da[kk]);
    wgmma::fence_operands(da);
    wgmma::fence_operands(dq_acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma::mma_rs<1>(dq_acc, da[kk], wgmma::desc_mn(k_addr, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(dq_acc);
  };
  for_live_tiles(masks, key_pad, b, Tk, stage, compute);

  store_rows(dq, dq_acc, b, q0 + 16 * warp + g, Tq, H, D, hh, t4);
}

// blockIdx.x < n_kv: the key CTA of key tile blockIdx.x; else the dQ CTA
// of query tile blockIdx.x - n_kv (none when WITH_DQ: n_kv = 1).
template <int DP, bool WITH_DQ>
__global__ void __launch_bounds__(NT, 1) attention_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const unsigned char* __restrict__ key_pad, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int H, int D, int n_kv, int vec) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t masks[MASK_TILES];
  __shared__ __align__(16) float lse_s[2][ROWS];
  __shared__ __align__(16) float di_s[2][ROWS];
  uint8_t* const base = align1024(smem_raw);
  if ((int)blockIdx.x < n_kv)
    key_cta<DP, WITH_DQ>(base, masks, lse_s, di_s, q, k, v, o, dout, lse, key_pad, dq, dk, dv,
                         blockIdx.x * ROWS, Tq, Tk, H, D, vec);
  else if constexpr (!WITH_DQ)
    dq_cta<DP>(base, masks, di_s[0], q, k, v, o, dout, lse, key_pad, dq,
               (blockIdx.x - n_kv) * ROWS, Tq, Tk, H, D, vec);
}

template <int DP, bool WITH_DQ>
int launch_form(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, const unsigned char* key_pad, bf16* dq, bf16* dk, bf16* dv,
                int B, int Tq, int Tk, int H, int D, bool vec, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<DP, WITH_DQ>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DP, WITH_DQ>());
  if (attr != cudaSuccess) return (int)attr;
  const int n_kv = (Tk + ROWS - 1) / ROWS, n_q = WITH_DQ ? 0 : (Tq + ROWS - 1) / ROWS;
  if (n_kv + n_q == 0) return 0;
  kernel<<<dim3(n_kv + n_q, H, B), NT, smem_bytes<DP, WITH_DQ>(), stream>>>(
      q, k, v, o, dout, lse, key_pad, dq, dk, dv, Tq, Tk, H, D, n_kv, vec);
  return (int)cudaGetLastError();
}

// One key tile (Tk <= 64, every call of the flagship paths): key CTAs that
// form dQ too. Longer rows: key CTAs and dQ CTAs. No keys (Tk = 0): dQ
// CTAs alone, which write dq = 0.
template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, const unsigned char* key_pad, bf16* dq, bf16* dk, bf16* dv, int B,
           int Tq, int Tk, int H, int D, bool vec, cudaStream_t stream) {
  if (Tk > 0 && Tk <= ROWS)
    return launch_form<DP, true>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D,
                                 vec, stream);
  return launch_form<DP, false>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D,
                                vec, stream);
}

}  // namespace bf16_form

}  // namespace

// q, o, dout, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D]; lse [B, H, Tq];
// key_pad [B, Tk] bytes (nonzero = pad) or null. Requires 1 <= D <= 128 (the
// wrapper checks); returns cudaErrorInvalidValue otherwise.
extern "C" int attention_bwd_f32(const float* q, const float* k, const float* v,
                                 const float* o, const float* dout, const float* lse,
                                 const unsigned char* key_pad, float* dq, float* dk,
                                 float* dv, int B, int Tq, int Tk, int H, int D,
                                 void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if ((size_t)B * H == 0) return 0;
  const bool vec = D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
                                   (uintptr_t)dout) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<4>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  if (D <= 64) return launch<8>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  if (D <= 96)
    return launch<12>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  return launch<16>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
}

// The bf16 form: every tensor bf16 as above but lse, float32 [B, H, Tq].
extern "C" int attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const __nv_bfloat16* o,
                                  const __nv_bfloat16* dout, const float* lse,
                                  const unsigned char* key_pad, __nv_bfloat16* dq,
                                  __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int Tq, int Tk,
                                  int H, int D, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if ((size_t)B * H == 0) return 0;
  const bool vec = D % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
                                   (uintptr_t)dout) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return bf16_form::launch<32>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  if (D <= 64)
    return bf16_form::launch<64>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  if (D <= 96)
    return bf16_form::launch<96>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
  return bf16_form::launch<128>(q, k, v, o, dout, lse, key_pad, dq, dk, dv, B, Tq, Tk, H, D, vec, s);
}
