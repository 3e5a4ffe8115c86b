// Flash-attention backward on fp32 inputs for Hopper (sm_90a): K3's fp32
// pair, dK/dV and dQ.
//
// Replaces, on fp32 inputs, the JAX package's Pallas TPU kernel
// diffusion_finetuning_tpu/ops/flash_attention.py:_bwd_kernel (:285,
// pallas_call :362): the FlashAttention-2 backward of
// csrc/flash_attention_bwd.cu with fp32 products and sums (JAX rounds P and
// dS to the inputs' dtype: fp32 here, no rounding).  The fp32 trainers (the
// default precision) run it.
//
// Bound on an H100 SXM: 10 * BH * Sq * Skv * d operations (five products);
// on the split product (three TF32 products, split_f32.cuh) at 494.7 TFLOP/s
// the SD1.5 512^2 training self-attention at BH=8, S=4096, d=40 is 161 GFLOP
// of tensor work, about 0.33 ms.  The cross-attention calls (Skv=77) are
// bound by bytes.
//
// Design.  Three of the five products contract over an index that runs
// along the rows of an operand as stored (dV += P^T dO and dK += dS^T Q over
// q, dQ += dS K over kv); tf32 wgmma has no transpose bit, so:
//   * a prep pass (split_f32.cuh) writes, once a call, the split copies the
//     kernels load by TMA: Q, dO, K and V as [big; small] rows (2, BH, S,
//     d_pad), and Q, dO and K transposed, (2, BH, d_pad, S rounded to 8),
//     their rows permuted within groups of 8 so that the A fragments of
//     P^T, dS^T and dS come straight from the accumulators;
//   * dK/dV (flash_bwd_f32_kernel): grid (ceil(Skv/64), BH, q_splits); a
//     CTA is one warpgroup owning 64 kv rows, K and V big/small held in
//     shared memory, walking its q tiles of BR rows (32 up to d_pad 72, 16
//     up to 96, else 8: dK and dV take d_pad/2 registers each and the 8
//     tiles of a stage take shared memory) through a ring of 2 stages (1 at
//     d_pad 160) of Q, dO, Q^T, dO^T big/small tiles.  S^T = K Q^T and dP^T
//     = V dO^T are split products from shared memory; P^T and dS^T are formed
//     in registers and split into A fragments; dV += P^T dO^T' and dK +=
//     dS^T Q^T' read the transposed tiles.  With q_splits > 1 each CTA writes
//     an fp32 partial that the last CTA of its kv tile sums in split order
//     (wgmma.cuh:last_to_arrive), as K3's bf16 kernel does;
//   * dQ (flash_bwd_dq_f32_kernel): grid (ceil(Sq/64), BH); a CTA is one
//     warpgroup owning 64 q rows, Q and dO big/small held, walking the kv
//     tiles of N rows (64 up to d_pad 48, 32 up to 80, 16 up to 112, else 8)
//     in their order through a ring of K, V, K^T big/small: S = Q K^T and dP
//     = dO V^T split, dS in registers, dQ += dS K^T'.  dQ is summed over the
//     kv tiles in one order, so it repeats bit for bit.
// Each kv tile's dQ product, and each q tile's dK and dV products (up to
// d_pad 128: registers), go into a fresh accumulator that FADD adds to the
// running sum: the tensor cores' fp32 sums are not rounded to nearest, and
// carried through a 4096-long loop their error reached 3e-5 relative L2
// (measured; the gate is 1e-5).
#include "split_f32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockN = 64;  // kv rows a CTA of the dK/dV kernel
constexpr int kSmemMax = 232448;

// --- dK/dV ---

__host__ __device__ constexpr int bwd_q_rows(int DP) { return DP <= 72 ? 32 : DP <= 96 ? 16 : 8; }

template <int DP, int S>
constexpr size_t bwd_smem_for() {
  constexpr int BR = bwd_q_rows(DP);
  return 1024 + 4 * (size_t)dft::f32_tile_bytes(kBlockN, DP) +
         (size_t)S * 8 * dft::f32_tile_bytes(BR, DP) + 8 * (1 + S) + 16;
}

template <int DP>
struct BwdTiles {
  static constexpr int BR = bwd_q_rows(DP);
  static constexpr int S = bwd_smem_for<DP, 2>() <= kSmemMax ? 2 : 1;  // ring stages
  static constexpr int SWD = dft::f32_swizzle(DP);  // row tiles (k = d along a row)
  static constexpr int SWQ = dft::f32_swizzle(BR);  // transposed tiles (k = q along a row)
  static constexpr int KVB = dft::f32_tile_bytes(kBlockN, DP);  // a K or V tile
  static constexpr int QB = dft::f32_tile_bytes(BR, DP);        // a Q, dO, Q^T or dO^T tile
  // stage: Q big, Q small, dO big, dO small, Q^T big, Q^T small, dO^T big, dO^T small
  static constexpr int STAGE = 8 * QB;
  static constexpr size_t smem() { return bwd_smem_for<DP, S>(); }
  // a q tile's dV and dK products each into a fresh accumulator, added to
  // dV and dK by FADD (registers: up to d_pad 128; above, the few q tiles of
  // the SD shapes accumulate on the tensor cores)
  static constexpr bool kTileSums = DP <= 128;
};

// dK and dV of 64 kv rows of a head: maps over [big; small] copies, heads
// bh + (0 or BH): q/o/k/v rows (2 BH, S, DP), qt/ot transposed (2 BH, DP, S8)
template <int DP>
__global__ void __launch_bounds__(128, 1)
    flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap omap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qtmap,
                         const __grid_constant__ CUtensorMap otmap,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dkv_part, int* __restrict__ counters, int BH,
                         int sq, int skv, int d, float scale, float logit_scale, int q_splits) {
  using T = BwdTiles<DP>;
  constexpr int BR = T::BR, S = T::S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* Kb = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + T::KVB);
  float* Vb = reinterpret_cast<float*>(smem + 2 * T::KVB);
  float* Vs = reinterpret_cast<float*>(smem + 3 * T::KVB);
  unsigned char* ring = smem + 4 * T::KVB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + S * T::STAGE);  // K/V's, one a stage
  int* flag = reinterpret_cast<int*>(bars + 1 + S);

  const int bh = blockIdx.y, kv0 = blockIdx.x * kBlockN, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (sq + BR - 1) / BR;
  const int it0 = (int)((long long)split * n_qt / q_splits);
  const int it1 = (int)((long long)(split + 1) * n_qt / q_splits);
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (tid == 0) {
    for (int i = 0; i < 1 + S; ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();

  auto tile = [&](int s, int i) { return reinterpret_cast<float*>(ring + s * T::STAGE + i * T::QB); };
  auto fetch = [&](int it, int s) {  // q tile `it` into stage s; thread 0
    const int q0 = it * BR;
    dft::mbar_expect_tx(&bars[1 + s], 8 * BR * DP * 4);
    for (int h = 0; h < 2; ++h) {
      dft::tma_load_tile_f32<BR, DP, T::SWD>(tile(s, h), &qmap, q0, 0, bh + h * BH, &bars[1 + s]);
      dft::tma_load_tile_f32<BR, DP, T::SWD>(tile(s, 2 + h), &omap, q0, 0, bh + h * BH,
                                             &bars[1 + s]);
      dft::tma_load_tile_f32<DP, BR, T::SWQ>(tile(s, 4 + h), &qtmap, 0, q0, bh + h * BH,
                                             &bars[1 + s]);
      dft::tma_load_tile_f32<DP, BR, T::SWQ>(tile(s, 6 + h), &otmap, 0, q0, bh + h * BH,
                                             &bars[1 + s]);
    }
  };
  if (tid == 0) {
    dft::mbar_expect_tx(&bars[0], 4 * kBlockN * DP * 4);
    dft::tma_load_tile_f32<kBlockN, DP, T::SWD>(Kb, &kmap, kv0, 0, bh, &bars[0]);
    dft::tma_load_tile_f32<kBlockN, DP, T::SWD>(Ks, &kmap, kv0, 0, bh + BH, &bars[0]);
    dft::tma_load_tile_f32<kBlockN, DP, T::SWD>(Vb, &vmap, kv0, 0, bh, &bars[0]);
    dft::tma_load_tile_f32<kBlockN, DP, T::SWD>(Vs, &vmap, kv0, 0, bh + BH, &bars[0]);
    for (int i = 0; i < S && it0 + i < it1; ++i) fetch(it0 + i, i);
  }
  dft::mbar_wait(&bars[0], 0);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int kvr = warp * 16 + g;  // this thread's kv rows of the tile: kvr, kvr + 8
  const bool kv_ok0 = kv0 + kvr < skv, kv_ok1 = kv0 + kvr + 8 < skv;

  for (int it = it0; it < it1; ++it) {
    const int s = (it - it0) % S;
    dft::mbar_wait(&bars[1 + s], ((it - it0) / S) & 1);
    const int q0 = it * BR;
    const float *Qb = tile(s, 0), *Qs = tile(s, 1), *Ob = tile(s, 2), *Os = tile(s, 3);
    const float *Qtb = tile(s, 4), *Qts = tile(s, 5), *Otb = tile(s, 6), *Ots = tile(s, 7);

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BR q columns
    float sT[BR / 2], dpT[BR / 2];
    dft::fence_operands(sT);
    dft::fence_operands(dpT);
    dft::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      dft::wgmma_tf32_ss(sT, dft::desc_f32<kBlockN, T::SWD>(Ks, kc),
                         dft::desc_f32<BR, T::SWD>(Qb, kc), kc > 0);
      dft::wgmma_tf32_ss(sT, dft::desc_f32<kBlockN, T::SWD>(Kb, kc),
                         dft::desc_f32<BR, T::SWD>(Qs, kc), 1);
      dft::wgmma_tf32_ss(sT, dft::desc_f32<kBlockN, T::SWD>(Kb, kc),
                         dft::desc_f32<BR, T::SWD>(Qb, kc), 1);
    }
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      dft::wgmma_tf32_ss(dpT, dft::desc_f32<kBlockN, T::SWD>(Vs, kc),
                         dft::desc_f32<BR, T::SWD>(Ob, kc), kc > 0);
      dft::wgmma_tf32_ss(dpT, dft::desc_f32<kBlockN, T::SWD>(Vb, kc),
                         dft::desc_f32<BR, T::SWD>(Os, kc), 1);
      dft::wgmma_tf32_ss(dpT, dft::desc_f32<kBlockN, T::SWD>(Vb, kc),
                         dft::desc_f32<BR, T::SWD>(Ob, kc), 1);
    }
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(sT);
    dft::fence_operands(dpT);

    // P^T = exp2(S^T * scale * log2 e - lse), dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < BR / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = q0 + nt * 8 + 2 * t + j;
        const bool q_ok = qc < sq;
        const float l = q_ok ? lse[qc] : 0.f, dl = q_ok ? delta[qc] : 0.f;
        const float p0 = (q_ok && kv_ok0) ? exp2f(sT[4 * nt + j] * logit_scale - l) : 0.f;
        const float p1 = (q_ok && kv_ok1) ? exp2f(sT[4 * nt + 2 + j] * logit_scale - l) : 0.f;
        sT[4 * nt + j] = p0;
        sT[4 * nt + 2 + j] = p1;
        dpT[4 * nt + j] = p0 * (dpT[4 * nt + j] - dl) * scale;
        dpT[4 * nt + 2 + j] = p1 * (dpT[4 * nt + 2 + j] - dl) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, k over the tile's q rows: A fragments
    // in the permuted column order of the transposed tiles
    uint32_t phi[BR / 8][4], plo[BR / 8][4], dhi[BR / 8][4], dlo[BR / 8][4];
#pragma unroll
    for (int i = 0; i < BR / 8; ++i) {
      dft::split_frag(phi[i], plo[i], sT[4 * i], sT[4 * i + 2], sT[4 * i + 1], sT[4 * i + 3]);
      dft::split_frag(dhi[i], dlo[i], dpT[4 * i], dpT[4 * i + 2], dpT[4 * i + 1],
                      dpT[4 * i + 3]);
    }
    if constexpr (T::kTileSums) {  // each product into tmp, then added by FADD
      float tmp[DP / 2];
      dft::fence_operands(tmp);
      dft::wgmma_fence();
#pragma unroll
      for (int i = 0; i < BR / 8; ++i) {
        dft::wgmma_tf32_rs(tmp, plo[i], dft::desc_f32<DP, T::SWQ>(Otb, i), i > 0);
        dft::wgmma_tf32_rs(tmp, phi[i], dft::desc_f32<DP, T::SWQ>(Ots, i), 1);
        dft::wgmma_tf32_rs(tmp, phi[i], dft::desc_f32<DP, T::SWQ>(Otb, i), 1);
      }
      dft::wgmma_commit();
      dft::wgmma_wait<0>();
      dft::fence_operands(tmp);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv_acc[i] += tmp[i];
      dft::wgmma_fence();
#pragma unroll
      for (int i = 0; i < BR / 8; ++i) {
        dft::wgmma_tf32_rs(tmp, dlo[i], dft::desc_f32<DP, T::SWQ>(Qtb, i), i > 0);
        dft::wgmma_tf32_rs(tmp, dhi[i], dft::desc_f32<DP, T::SWQ>(Qts, i), 1);
        dft::wgmma_tf32_rs(tmp, dhi[i], dft::desc_f32<DP, T::SWQ>(Qtb, i), 1);
      }
      dft::wgmma_commit();
      dft::wgmma_wait<0>();
      dft::fence_operands(tmp);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk_acc[i] += tmp[i];
    } else {
      dft::fence_operands(dv_acc);
      dft::fence_operands(dk_acc);
      dft::wgmma_fence();
#pragma unroll
      for (int i = 0; i < BR / 8; ++i) {
        dft::wgmma_tf32_rs(dv_acc, plo[i], dft::desc_f32<DP, T::SWQ>(Otb, i), 1);
        dft::wgmma_tf32_rs(dv_acc, phi[i], dft::desc_f32<DP, T::SWQ>(Ots, i), 1);
        dft::wgmma_tf32_rs(dv_acc, phi[i], dft::desc_f32<DP, T::SWQ>(Otb, i), 1);
      }
#pragma unroll
      for (int i = 0; i < BR / 8; ++i) {
        dft::wgmma_tf32_rs(dk_acc, dlo[i], dft::desc_f32<DP, T::SWQ>(Qtb, i), 1);
        dft::wgmma_tf32_rs(dk_acc, dhi[i], dft::desc_f32<DP, T::SWQ>(Qts, i), 1);
        dft::wgmma_tf32_rs(dk_acc, dhi[i], dft::desc_f32<DP, T::SWQ>(Qtb, i), 1);
      }
      dft::wgmma_commit();
      dft::wgmma_wait<0>();
      dft::fence_operands(dv_acc);
      dft::fence_operands(dk_acc);
    }
    __syncthreads();  // stage s is reused
    if (tid == 0 && it + S < it1) fetch(it + S, s);
  }

  if (q_splits > 1) {
    // this split's fp32 partial in register order (dk_acc then dv_acc), then
    // the last split to arrive at this (head, kv tile) sums all of them in
    // split order
    const size_t block = (size_t)128 * DP;
    const size_t tile_id = (size_t)bh * gridDim.x + blockIdx.x;
    float* mine = dkv_part + ((size_t)split * gridDim.y * gridDim.x + tile_id) * block;
    dft::part_store(mine, dk_acc, tid, 128);
    dft::part_store(mine + 128 * (DP / 2), dv_acc, tid, 128);
    if (!dft::last_to_arrive(counters + tile_id, q_splits, flag)) return;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * block;
    const float* part = dkv_part + tile_id * block;
    for (int sp = 0; sp < q_splits; ++sp, part += split_stride) {
      dft::part_add(dk_acc, part, tid, 128);
      dft::part_add(dv_acc, part + 128 * (DP / 2), tid, 128);
    }
  }

  float* dkb = dk + (size_t)bh * skv * d;
  float* dvb = dv + (size_t)bh * skv * d;
  const int r0 = kv0 + kvr, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = dt * 8 + 2 * t + j;
      if (c < d) {
        if (r0 < skv) {
          dkb[(size_t)r0 * d + c] = dk_acc[4 * dt + j];
          dvb[(size_t)r0 * d + c] = dv_acc[4 * dt + j];
        }
        if (r1 < skv) {
          dkb[(size_t)r1 * d + c] = dk_acc[4 * dt + 2 + j];
          dvb[(size_t)r1 * d + c] = dv_acc[4 * dt + 2 + j];
        }
      }
    }
  }
}

// --- dQ ---

__host__ __device__ constexpr int dq_kv_rows(int DP) {
  return DP <= 48 ? 64 : DP <= 80 ? 32 : DP <= 112 ? 16 : 8;
}

template <int DP, int S>
constexpr size_t dq_smem_for() {
  constexpr int N = dq_kv_rows(DP);
  return 1024 + 4 * (size_t)dft::f32_tile_bytes(64, DP) +
         (size_t)S * 6 * dft::f32_tile_bytes(N, DP) + 8 * (1 + S);
}

template <int DP>
struct DqTiles {
  static constexpr int N = dq_kv_rows(DP);
  static constexpr int S = dq_smem_for<DP, 2>() <= kSmemMax ? 2 : 1;
  static constexpr int SWD = dft::f32_swizzle(DP);  // row tiles (k = d)
  static constexpr int SWK = dft::f32_swizzle(N);   // K^T tiles (k = kv)
  static constexpr int QB = dft::f32_tile_bytes(64, DP);  // a Q or dO tile
  static constexpr int KB = dft::f32_tile_bytes(N, DP);   // a K, V or K^T tile
  // stage: K big, K small, V big, V small, K^T big, K^T small
  static constexpr int STAGE = 6 * KB;
  static constexpr size_t smem() { return dq_smem_for<DP, S>(); }
};

// dQ of 64 q rows of a head: thread rows r0, r0 + 8; dQ in acc[DP / 2]
template <int DP>
__global__ void __launch_bounds__(128, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap omap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap ktmap,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int BH, int sq, int skv, int d, float scale,
                            float logit_scale) {
  using T = DqTiles<DP>;
  constexpr int N = T::N, S = T::S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* Qb = reinterpret_cast<float*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + T::QB);
  float* Ob = reinterpret_cast<float*>(smem + 2 * T::QB);
  float* Os = reinterpret_cast<float*>(smem + 3 * T::QB);
  unsigned char* ring = smem + 4 * T::QB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + S * T::STAGE);

  const int bh = blockIdx.y, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int n_kv = (skv + N - 1) / N;
  if (tid == 0) {
    for (int i = 0; i < 1 + S; ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();
  auto tile = [&](int j, int i) {
    return reinterpret_cast<float*>(ring + (j % S) * T::STAGE + i * T::KB);
  };
  auto load_kv = [&](int j) {  // thread 0
    uint64_t* bar = &bars[1 + j % S];
    dft::mbar_expect_tx(bar, 6 * N * DP * 4);
    for (int h = 0; h < 2; ++h) {
      dft::tma_load_tile_f32<N, DP, T::SWD>(tile(j, h), &kmap, j * N, 0, bh + h * BH, bar);
      dft::tma_load_tile_f32<N, DP, T::SWD>(tile(j, 2 + h), &vmap, j * N, 0, bh + h * BH, bar);
      dft::tma_load_tile_f32<DP, N, T::SWK>(tile(j, 4 + h), &ktmap, 0, j * N, bh + h * BH, bar);
    }
  };
  if (tid == 0) {
    dft::mbar_expect_tx(&bars[0], 4 * 64 * DP * 4);
    dft::tma_load_tile_f32<64, DP, T::SWD>(Qb, &qmap, q0, 0, bh, &bars[0]);
    dft::tma_load_tile_f32<64, DP, T::SWD>(Qs, &qmap, q0, 0, bh + BH, &bars[0]);
    dft::tma_load_tile_f32<64, DP, T::SWD>(Ob, &omap, q0, 0, bh, &bars[0]);
    dft::tma_load_tile_f32<64, DP, T::SWD>(Os, &omap, q0, 0, bh + BH, &bars[0]);
    for (int j = 0; j < S && j < n_kv; ++j) load_kv(j);
  }
  const bool ok0 = r0 < sq, ok1 = r1 < sq;
  const float l0 = ok0 ? lse[(size_t)bh * sq + r0] : 0.f;
  const float l1 = ok1 ? lse[(size_t)bh * sq + r1] : 0.f;
  const float e0 = ok0 ? delta[(size_t)bh * sq + r0] : 0.f;
  const float e1 = ok1 ? delta[(size_t)bh * sq + r1] : 0.f;
  dft::mbar_wait(&bars[0], 0);

  float acc[DP / 2], tmp[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    dft::mbar_wait(&bars[1 + j % S], (j / S) & 1);
    const float *Kb = tile(j, 0), *Ks = tile(j, 1), *Vb = tile(j, 2), *Vs = tile(j, 3);
    const float *Ktb = tile(j, 4), *Kts = tile(j, 5);
    float s[N / 2], dp[N / 2];
    dft::fence_operands(s);
    dft::fence_operands(dp);
    dft::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWD>(Qs, kc), dft::desc_f32<N, T::SWD>(Kb, kc),
                         kc > 0);
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWD>(Qb, kc), dft::desc_f32<N, T::SWD>(Ks, kc),
                         1);
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWD>(Qb, kc), dft::desc_f32<N, T::SWD>(Kb, kc),
                         1);
    }
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      dft::wgmma_tf32_ss(dp, dft::desc_f32<64, T::SWD>(Os, kc), dft::desc_f32<N, T::SWD>(Vb, kc),
                         kc > 0);
      dft::wgmma_tf32_ss(dp, dft::desc_f32<64, T::SWD>(Ob, kc), dft::desc_f32<N, T::SWD>(Vs, kc),
                         1);
      dft::wgmma_tf32_ss(dp, dft::desc_f32<64, T::SWD>(Ob, kc), dft::desc_f32<N, T::SWD>(Vb, kc),
                         1);
    }
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(s);
    dft::fence_operands(dp);
    // dS = P (dP - delta) scale, P = exp2(S * scale * log2 e - lse), in place of S
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool kv_ok = j * N + nt * 8 + 2 * t + jj < skv;
        const float p0 = (ok0 && kv_ok) ? exp2f(s[4 * nt + jj] * logit_scale - l0) : 0.f;
        const float p1 = (ok1 && kv_ok) ? exp2f(s[4 * nt + 2 + jj] * logit_scale - l1) : 0.f;
        s[4 * nt + jj] = p0 * (dp[4 * nt + jj] - e0) * scale;
        s[4 * nt + 2 + jj] = p1 * (dp[4 * nt + 2 + jj] - e1) * scale;
      }
    }
    uint32_t dhi[N / 8][4], dlo[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      dft::split_frag(dhi[i], dlo[i], s[4 * i], s[4 * i + 2], s[4 * i + 1], s[4 * i + 3]);
    dft::fence_operands(tmp);
    dft::wgmma_fence();
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      dft::wgmma_tf32_rs(tmp, dlo[i], dft::desc_f32<DP, T::SWK>(Ktb, i), i > 0);
      dft::wgmma_tf32_rs(tmp, dhi[i], dft::desc_f32<DP, T::SWK>(Kts, i), 1);
      dft::wgmma_tf32_rs(tmp, dhi[i], dft::desc_f32<DP, T::SWK>(Ktb, i), 1);
    }
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(tmp);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += tmp[i];  // in kv order, rounded to nearest
    __syncthreads();  // no thread still reads tile j's stage
    if (tid == 0 && j + S < n_kv) load_kv(j + S);
  }
  float* dqb = dq + (size_t)bh * sq * d;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = dt * 8 + 2 * t + jj;
      if (c < d) {
        if (ok0) dqb[(size_t)r0 * d + c] = acc[4 * dt + jj];
        if (ok1) dqb[(size_t)r1 * d + c] = acc[4 * dt + 2 + jj];
      }
    }
  }
}

template <typename K>
cudaError_t configure(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq, float* dk, float* dv,
                   float* work, long long work_floats, float* part, int* counters, int bh,
                   int sq, int skv, int d, float scale, int q_splits, cudaStream_t st) {
  using B = BwdTiles<DP>;
  using Q = DqTiles<DP>;
  const int sq8 = (sq + 7) / 8 * 8, skv8 = (skv + 7) / 8 * 8;
  const int n_qt = (sq + B::BR - 1) / B::BR;
  if (q_splits < 1 || q_splits > n_qt || (q_splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  float* qs = work;                       // (2, bh, sq, DP) rows
  float* os = qs + 2LL * bh * sq * DP;    // dO
  float* ks = os + 2LL * bh * sq * DP;    // (2, bh, skv, DP)
  float* vs = ks + 2LL * bh * skv * DP;
  float* qt = vs + 2LL * bh * skv * DP;   // (2, bh, DP, sq8) transposed
  float* ot = qt + 2LL * bh * DP * sq8;
  float* kt = ot + 2LL * bh * DP * sq8;   // (2, bh, DP, skv8)
  if (work_floats < 2LL * bh * DP * (2LL * sq + 2LL * skv + 2LL * sq8 + skv8))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = configure(flash_bwd_f32_kernel<DP>, B::smem());
    if (err == cudaSuccess) err = configure(flash_bwd_dq_f32_kernel<DP>, Q::smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaError_t err = dft::split_rows(q, qs, bh, sq, d, DP, st);
  if (err == cudaSuccess) err = dft::split_rows(dout, os, bh, sq, d, DP, st);
  if (err == cudaSuccess) err = dft::split_rows(k, ks, bh, skv, d, DP, st);
  if (err == cudaSuccess) err = dft::split_rows(v, vs, bh, skv, d, DP, st);
  if (err == cudaSuccess) err = dft::split_cols(q, qt, bh, sq, d, DP, st);
  if (err == cudaSuccess) err = dft::split_cols(dout, ot, bh, sq, d, DP, st);
  if (err == cudaSuccess) err = dft::split_cols(k, kt, bh, skv, d, DP, st);
  if (err != cudaSuccess) return err;
  // dK/dV maps (boxes of BR q rows, 64 kv rows, BR transposed columns)
  CUtensorMap qm{}, om{}, km{}, vm{}, qtm{}, otm{};
  if (!(dft::make_tile_map_f32(&qm, qs, 2 * bh, sq, DP, B::BR, B::SWD) &&
        dft::make_tile_map_f32(&om, os, 2 * bh, sq, DP, B::BR, B::SWD) &&
        dft::make_tile_map_f32(&km, ks, 2 * bh, skv, DP, kBlockN, B::SWD) &&
        dft::make_tile_map_f32(&vm, vs, 2 * bh, skv, DP, kBlockN, B::SWD) &&
        dft::make_tile_map_f32(&qtm, qt, 2 * bh, DP, sq8, DP, B::SWQ) &&
        dft::make_tile_map_f32(&otm, ot, 2 * bh, DP, sq8, DP, B::SWQ)))
    return cudaErrorNotSupported;
  flash_bwd_f32_kernel<DP><<<dim3((skv + kBlockN - 1) / kBlockN, bh, q_splits), 128, B::smem(),
                             st>>>(qm, om, km, vm, qtm, otm, lse, delta, dk, dv, part, counters,
                                   bh, sq, skv, d, scale, scale * kLog2e, q_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dQ maps (boxes of 64 q rows, N kv rows, N transposed columns)
  CUtensorMap dqm{}, dom{}, dkm{}, dvm{}, dktm{};
  if (!(dft::make_tile_map_f32(&dqm, qs, 2 * bh, sq, DP, 64, Q::SWD) &&
        dft::make_tile_map_f32(&dom, os, 2 * bh, sq, DP, 64, Q::SWD) &&
        dft::make_tile_map_f32(&dkm, ks, 2 * bh, skv, DP, Q::N, Q::SWD) &&
        dft::make_tile_map_f32(&dvm, vs, 2 * bh, skv, DP, Q::N, Q::SWD) &&
        dft::make_tile_map_f32(&dktm, kt, 2 * bh, DP, skv8, DP, Q::SWK)))
    return cudaErrorNotSupported;
  flash_bwd_dq_f32_kernel<DP><<<dim3((sq + 63) / 64, bh), 128, Q::smem(), st>>>(
      dqm, dom, dkm, dvm, dktm, lse, delta, dq, bh, sq, skv, d, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq (bh, sq, d); k, v, dk, dv (bh, skv, d); lse and delta (bh, sq):
// fp32, contiguous, 1 <= d <= 160.  work: fp32 scratch of work_floats >= 2 *
// bh * d_pad * (2 sq + 2 skv + 2 sq8 + skv8) for the split copies (d_pad: d
// rounded up to 8 up to 64, to 16 above; sq8, skv8: rounded up to 8).
// q_splits CTAs a (head, 64 kv rows) of the dK/dV kernel (1 .. its q tiles:
// ceil(sq / q_rows), q_rows 32 up to d_pad 72, 16 up to 96, else 8); with
// q_splits > 1, part is fp32 scratch of q_splits * bh * ceil(skv/64) * 128 *
// d_pad floats and counters bh * ceil(skv/64) ints, zero on entry and left
// zero.  Returns the launches' cudaError_t (0 = launched).
extern "C" int dft_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk,
                                 void* dv, void* work, long long work_floats, void* part,
                                 void* counters, int bh, int sq, int skv, int d, float scale,
                                 int q_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || skv < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
#define DFT_F32_CASE(DP)                                                                      \
  case DP:                                                                                    \
    return static_cast<int>(launch<DP>(                                                       \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<const float*>(dout),                       \
        static_cast<const float*>(lse), static_cast<const float*>(delta),                    \
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),           \
        static_cast<float*>(work), work_floats, static_cast<float*>(part),                   \
        static_cast<int*>(counters), bh, sq, skv, d, scale, q_splits, st))
  switch (dft::f32_dpad(d)) {
    DFT_F32_CASE(8);
    DFT_F32_CASE(16);
    DFT_F32_CASE(24);
    DFT_F32_CASE(32);
    DFT_F32_CASE(40);
    DFT_F32_CASE(48);
    DFT_F32_CASE(56);
    DFT_F32_CASE(64);
    DFT_F32_CASE(80);
    DFT_F32_CASE(96);
    DFT_F32_CASE(112);
    DFT_F32_CASE(128);
    DFT_F32_CASE(144);
    DFT_F32_CASE(160);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DFT_F32_CASE
}
