// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// diffusion_finetuning_tpu/ops/flash_attention.py:_bwd_kernel (:285), reached
// through _bwd (:349, pallas_call :362) from the custom VJP _flash_bwd (:445).
// Same function, the FlashAttention-2 backward: with the forward's base-2
// lse (BH, Sq) and delta = rowsum(dO * O) (BH, Sq, computed outside, as JAX
// :355), per KV block
//   P  = exp2(S * scale * log2(e) - lse)      S = Q K^T, fp32
//   dV += P^T dO                              P rounded to bf16 (JAX p_lo)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             the natural scale; rounded to bf16
//   dK += dS^T Q,  dQ += dS K                 fp32 accumulation
// KV columns at or past skv and q rows at or past sq get P = 0, so they add
// nothing to dK, dV or dQ.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 10 * BH * Sq *
// Skv * d operations (five products).  SD1.5 512^2 self-attention at BH=8,
// S=4096, d=40 is 54 GFLOP, about 54 us; the cross-attention calls (Skv=77)
// are bound by bytes (q, dO, dq: 3 x 2.6 MB at S=4096, d=40; about 3 us).
//
// Design.  The TPU kernel walks the q blocks in a sequential grid and keeps
// dK/dV resident across it; on Hopper the CTAs run in parallel, so the loop
// over q moves inside the CTA, and a third grid dimension splits it:
//   * grid (ceil(Skv/64), BH, q_splits); a CTA is one warpgroup owning 64 KV
//     rows (warp w: rows 16w..16w+15) and walks q tiles [split*n/q_splits,
//     (split+1)*n/q_splits) of the n = ceil(Sq/BR) tiles.  The host
//     (ops/flash_attention.py:bwd_q_splits) picks the fewest q_splits giving
//     two waves (>= 264 CTAs) with at least 4 q tiles a split, and one wave
//     wherever Sq allows, so the Skv=77 calls, 2 KV tiles a head, no longer
//     run 16 CTAs (4096 x 77 at BH=8: 256);
//   * K and V of the tile arrive once; Q, dO, lse and delta of the next q
//     tiles are in flight in a ring (2 stages at 64-row q tiles, else 3)
//     while the current tile computes.  All come by TMA (one thread starts them,
//     the stage's mbarrier completes) into wgmma.cuh's swizzled layout, 128
//     bytes up to d_pad 64 and else the widest swizzle d_pad fills (32 bytes
//     at d_pad 80), so that the pad costs no CTAs an SM; TMA zero-fills rows
//     past Sq and Skv and columns past d (40 -> 48), so the pads cost no
//     device memory.  lse and delta come from the flat (BH*Sq) vectors, so a
//     ragged last tile reads rows of the next head, which the q mask drops.
//     Synchronous copies, and cp.async in their place, had taken a third of
//     the time at S=4096.  A d that is not a multiple of 8 takes plain
//     element loads, routed by shape;
//   * the four products whose M side is the 64-row KV tile run on wgmma
//     (bf16 in, fp32 accumulate): S^T = K Q^T and dP^T = V dO^T with both
//     operands from shared memory (N = BR q columns), dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T as register A fragments built from the
//     accumulators and dO / Q read MN-major (N = d_pad);
//   * dQ is a second kernel (flash_bwd_dq_kernel), so that it sums over the
//     KV tiles in one fixed order, as JAX's fori_loop over KV blocks does,
//     and repeats bit for bit whatever the q splits, the stream or the run:
//     grid (ceil(Sq/QT), BH), QT = 64 or 128 q rows (one or two consumer
//     warpgroups; K1's q-tile rule, ops/flash_attention.py:fwd_q_tile),
//     Q and dO held in shared memory, K/V tiles through a TMA ring in KV
//     order; per tile S = Q K^T and dP = dO V^T on wgmma (A and B from
//     shared memory), P and dS formed as this kernel forms them, dS rounded
//     to bf16 into register A fragments, and dQ += dS K (B = the K tile
//     read MN-major) in fp32 registers, the product of tile j-1 running
//     beside tile j's S and dP; dQ is written once, in q's dtype.
//     It costs two products more than a dQ inside this kernel (seven for
//     five), but no cross-CTA sum: adding each KV tile's dQ tile in KV order
//     (a turn counter a (head, q tile), each CTA waiting for the CTA of the
//     KV tile before) made 4096^2 three times slower, the CTAs of a head
//     waiting in a chain of L2 round trips (PERF.md);
//   * with q_splits > 1 each CTA writes its dK/dV as an fp32 partial to
//     scratch (q_splits, BH, ceil(Skv/64), 64 x d_pad x 2, in register order
//     so that a warp's float4 accesses are contiguous); the last CTA of a
//     (head, KV tile) to arrive (__threadfence + an arrival counter, which it
//     resets to 0) sums the partials in split order and writes bf16, so dK
//     and dV are deterministic and no second launch is needed.
// Registers: dK and dV take d_pad/2 floats a thread each (160 at d=160), so
// the q tile is as narrow as they force (q_rows: BR = 64 up to d_pad 64, 32
// up to 96, else 16).
// fp32 inputs take csrc/flash_attention_bwd_f32.cu (split products on the
// tensor cores).
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockN = 64;  // kv rows per CTA (16 per warp)
constexpr int kThreads = 128;
// Q/dO/lse/delta ring depth: tile it computes while the next one or two are
// in flight (two stages at 64-row tiles, to keep three CTAs an SM)
__host__ __device__ constexpr int q_stages(int BR) { return BR == 64 ? 2 : 3; }
// floats between a ring stage's lse and delta runs (128-byte aligned TMA destinations)
__host__ __device__ constexpr int l_stride(int BR) { return BR < 32 ? 32 : BR; }

// swizzle bytes of the TMA tiles: 128 (the fewest, widest requests) up to
// d_pad 64; above, the widest whose slabs d_pad fills, since shared memory
// spent on padding there costs CTAs an SM (d_pad 80: 32 bytes)
__host__ __device__ constexpr int swizzle(int DP) {
  return DP <= 64 || DP % 64 == 0 ? 128 : DP % 32 == 0 ? 64 : 32;
}

// q rows per tile: 64 where the registers allow, narrower as dK and dV grow
// with the head dim
constexpr int q_rows(int DP) { return DP <= 64 ? 64 : DP <= 96 ? 32 : 16; }

// from a 1024-byte aligned base: K, V, the ring's Q and dO tiles, the
// ring's lse and delta, the barriers and a flag
template <int DP, int BR>
constexpr size_t bf16_smem_bytes() {
  constexpr int SW = swizzle(DP);
  return 1024 +
         sizeof(__nv_bfloat16) * (size_t)(2 * dft::tile_elems(kBlockN, DP, SW) +
                                          2 * q_stages(BR) * dft::tile_elems(BR, DP, SW)) +
         sizeof(float) * (size_t)(2 * q_stages(BR) * l_stride(BR)) +
         sizeof(uint64_t) * (1 + q_stages(BR)) + 16;
}

// dK and dV
template <int DP, int BR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap omap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap lmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ dkv_part, int* __restrict__ counters, int sq,
                          int skv, int d, float scale, float logit_scale, int q_splits) {
  constexpr int KC = DP / 16;          // k-chunks over the head dim
  constexpr int DT = DP / 8;           // n-tiles over the head dim
  constexpr int NQ = BR / 8;           // n-tiles of S^T over the q rows
  constexpr int QC = BR / 16;          // k-chunks over the q rows
  constexpr int SW = swizzle(DP);
  constexpr int TQ = dft::tile_elems(BR, DP, SW);       // elements of one Q or dO tile
  constexpr int TKV = dft::tile_elems(kBlockN, DP, SW);  // elements of the K or V tile
  constexpr int kQStages = q_stages(BR);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(  // 64 x DP; 1024-byte aligned
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* Vs = Ks + TKV;                                     // 64 x DP
  __nv_bfloat16* Qring = Vs + TKV;  // stage s: Q at 2*s*TQ, dO at 2*s*TQ + TQ
  constexpr int LST = l_stride(BR);
  float* Lring = reinterpret_cast<float*>(Qring + 2 * kQStages * TQ);  // lse at 2*s*LST, delta LST on
  // barriers: K/V's, then one a ring stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(Lring + 2 * kQStages * LST);
  int* flag = reinterpret_cast<int*>(bars + 1 + kQStages);

  const int bh = blockIdx.y, kv0 = blockIdx.x * kBlockN, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (sq + BR - 1) / BR;
  const int it0 = (int)((long long)split * n_qt / q_splits);
  const int it1 = (int)((long long)(split + 1) * n_qt / q_splits);
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  const size_t kv_off = (size_t)bh * skv * d;

  const bool tma = (d & 7) == 0;  // 16-byte rows: TMA; else plain loads
  // lse/delta rows by TMA only where every head's run starts on 16 bytes
  // (Sq % 4 == 0): TMA refuses an innermost start that is not (an illegal
  // instruction), so other Sq take plain loads for them
  const bool tma_vec = tma && (sq & 3) == 0;
  if (tma && tid == 0) {
    for (int i = 0; i < 1 + kQStages; ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();

  // start copying q tile `it` (Q, dO, lse, delta) into ring stage s
  auto fetch = [&](int it, int s) {
    const int q0 = it * BR;
    __nv_bfloat16* qs = Qring + 2 * s * TQ;
    float* ls = Lring + 2 * s * LST;
    if (tma) {
      if (tid == 0) {  // lse/delta: the flat (BH*Sq) vectors; a ragged tile reads masked rows
        dft::fence_proxy_async();
        dft::mbar_expect_tx(&bars[1 + s], 2 * TQ * 2 + (tma_vec ? 2 * BR * 4 : 0));
        dft::tma_load_tile<BR, DP, SW>(qs, &qmap, q0, bh, &bars[1 + s]);
        dft::tma_load_tile<BR, DP, SW>(qs + TQ, &omap, q0, bh, &bars[1 + s]);
        if (tma_vec) {
          dft::tma_load_vec(ls, &lmap, bh * sq + q0, &bars[1 + s]);
          dft::tma_load_vec(ls + LST, &dmap, bh * sq + q0, &bars[1 + s]);
        }
      }
    } else {
      dft::load_tile_elems<BR, DP, SW>(qs, q, q0, sq, d, tid, kThreads);
      dft::load_tile_elems<BR, DP, SW>(qs + TQ, dout, q0, sq, d, tid, kThreads);
    }
    if (!tma_vec) {
      for (int i = tid; i < BR; i += kThreads) {
        const bool ok = q0 + i < sq;
        ls[i] = ok ? lse[q0 + i] : 0.f;
        ls[LST + i] = ok ? delta[q0 + i] : 0.f;
      }
    }
  };

  if (tma) {
    if (tid == 0) {
      dft::mbar_expect_tx(&bars[0], 2 * TKV * 2);
      dft::tma_load_tile<kBlockN, DP, SW>(Ks, &kmap, kv0, bh, &bars[0]);
      dft::tma_load_tile<kBlockN, DP, SW>(Vs, &vmap, kv0, bh, &bars[0]);
    }
  } else {
    dft::load_tile_elems<kBlockN, DP, SW>(Ks, k + kv_off, kv0, skv, d, tid, kThreads);
    dft::load_tile_elems<kBlockN, DP, SW>(Vs, v + kv_off, kv0, skv, d, tid, kThreads);
  }
  for (int i = 0; i < kQStages - 1 && it0 + i < it1; ++i) fetch(it0 + i, i);
  if (tma) dft::mbar_wait(&bars[0], 0);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int kvr = warp * 16 + g;  // this thread's kv rows of the tile: kvr, kvr + 8
  const bool kv_ok0 = kv0 + kvr < skv, kv_ok1 = kv0 + kvr + 8 < skv;

  for (int it = it0; it < it1; ++it) {
    const int s = (it - it0) % kQStages;
    if (it + kQStages - 1 < it1)  // into the stage tile it-1 used; in flight meanwhile
      fetch(it + kQStages - 1, (it - it0 + kQStages - 1) % kQStages);
    if (tma) dft::mbar_wait(&bars[1 + s], ((it - it0) / kQStages) & 1);
    dft::fence_proxy_async();
    __syncthreads();
    const int q0 = it * BR;
    const __nv_bfloat16* Qs = Qring + 2 * s * TQ;
    const __nv_bfloat16* dOs = Qs + TQ;
    const float* lse_s = Lring + 2 * s * LST;
    const float* dlt_s = lse_s + LST;

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BR q columns
    float sT[BR / 2], dpT[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) sT[i] = dpT[i] = 0.f;
    dft::fence_operands(sT);
    dft::fence_operands(dpT);
    dft::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      dft::wgmma_ss<0, 0>(sT, dft::desc_kmajor<kBlockN, SW>(Ks, kc),
                          dft::desc_kmajor<BR, SW>(Qs, kc), 1);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      dft::wgmma_ss<0, 0>(dpT, dft::desc_kmajor<kBlockN, SW>(Vs, kc),
                          dft::desc_kmajor<BR, SW>(dOs, kc), 1);
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(sT);
    dft::fence_operands(dpT);

    // P^T = exp2(S^T * scale * log2 e - lse), dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * t + j;
        const bool q_ok = q0 + qc < sq;
        const float l = lse_s[qc], dl = dlt_s[qc];
        const float p0 = (q_ok && kv_ok0) ? exp2f(sT[4 * nt + j] * logit_scale - l) : 0.f;
        const float p1 = (q_ok && kv_ok1) ? exp2f(sT[4 * nt + 2 + j] * logit_scale - l) : 0.f;
        sT[4 * nt + j] = p0;
        sT[4 * nt + 2 + j] = p1;
        dpT[4 * nt + j] = p0 * (dpT[4 * nt + j] - dl) * scale;
        dpT[4 * nt + 2 + j] = p1 * (dpT[4 * nt + 2 + j] - dl) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q (k runs over the q rows of the tile),
    // with P^T and dS^T rounded to bf16 as register A fragments
    uint32_t pa[QC][4], da[QC][4];
#pragma unroll
    for (int qc = 0; qc < QC; ++qc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[qc][r] = dft::pack_bf16(sT[8 * qc + 2 * r], sT[8 * qc + 2 * r + 1]);
        da[qc][r] = dft::pack_bf16(dpT[8 * qc + 2 * r], dpT[8 * qc + 2 * r + 1]);
      }
    }
    dft::fence_operands(dv_acc);
    dft::fence_operands(dk_acc);
    dft::wgmma_fence();
#pragma unroll
    for (int qc = 0; qc < QC; ++qc)
      dft::wgmma_rs<1>(dv_acc, pa[qc], dft::desc_mnmajor<BR, SW>(dOs, qc), 1);
#pragma unroll
    for (int qc = 0; qc < QC; ++qc)
      dft::wgmma_rs<1>(dk_acc, da[qc], dft::desc_mnmajor<BR, SW>(Qs, qc), 1);
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(dv_acc);
    dft::fence_operands(dk_acc);
    __syncthreads();  // stage s is reused
  }

  if (q_splits > 1) {
    // this split's fp32 partial, in register order: float4 i of thread tid
    // (dk_acc then dv_acc) at (i * 128 + tid) * 4, so that each access of a
    // warp is 512 contiguous bytes; then the last split to arrive at this
    // (head, KV tile) sums all of them, in split order, into its registers
    constexpr int NV = DP / 4;  // float4s a thread
    const size_t block = (size_t)kThreads * DP;
    float* mine = dkv_part + (((size_t)split * gridDim.y + bh) * gridDim.x + blockIdx.x) * block;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      *reinterpret_cast<float4*>(mine + (i * kThreads + tid) * 4) =
          make_float4(dk_acc[4 * i], dk_acc[4 * i + 1], dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
      *reinterpret_cast<float4*>(mine + ((NV / 2 + i) * kThreads + tid) * 4) =
          make_float4(dv_acc[4 * i], dv_acc[4 * i + 1], dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
    if (!dft::last_to_arrive(counters + (size_t)bh * gridDim.x + blockIdx.x, q_splits, flag))
      return;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * block;
    const float* part = dkv_part + ((size_t)bh * gridDim.x + blockIdx.x) * block;
    for (int sp = 0; sp < q_splits; ++sp, part += split_stride) {
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(part + (i * kThreads + tid) * 4));
        const float4 b = __ldcg(
            reinterpret_cast<const float4*>(part + ((NV / 2 + i) * kThreads + tid) * 4));
        dk_acc[4 * i] += a.x;
        dk_acc[4 * i + 1] += a.y;
        dk_acc[4 * i + 2] += a.z;
        dk_acc[4 * i + 3] += a.w;
        dv_acc[4 * i] += b.x;
        dv_acc[4 * i + 1] += b.y;
        dv_acc[4 * i + 2] += b.z;
        dv_acc[4 * i + 3] += b.w;
      }
    }
  }

  __nv_bfloat16* dkb = dk + kv_off;
  __nv_bfloat16* dvb = dv + kv_off;
  const int r0 = kv0 + kvr, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = dt * 8 + 2 * t + j;
      if (c < d) {
        if (r0 < skv) {
          dkb[(size_t)r0 * d + c] = __float2bfloat16(dk_acc[4 * dt + j]);
          dvb[(size_t)r0 * d + c] = __float2bfloat16(dv_acc[4 * dt + j]);
        }
        if (r1 < skv) {
          dkb[(size_t)r1 * d + c] = __float2bfloat16(dk_acc[4 * dt + 2 + j]);
          dvb[(size_t)r1 * d + c] = __float2bfloat16(dv_acc[4 * dt + 2 + j]);
        }
      }
    }
  }
}

// --- dQ ---

// K/V ring stages of the dQ kernel: 4 where they fit beside Q and dO
template <int DP, int NWG>
__host__ __device__ constexpr int dq_stages() {
  constexpr size_t tile = 2 * (size_t)dft::tile_elems(kBlockN, DP, swizzle(DP));
  return 1024 + 2 * NWG * tile + 4 * 2 * tile + 64 <= 232448 ? 4 : 3;
}
template <int DP, int NWG>
constexpr size_t dq_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (size_t)(2 * NWG + 2 * dq_stages<DP, NWG>()) *
                    dft::tile_elems(kBlockN, DP, swizzle(DP)) +
         sizeof(uint64_t) * (1 + dq_stages<DP, NWG>());
}

// dQ of NWG*64 q rows of one head: warpgroup w owns rows 64w.., its thread
// rows r0 and r0 + 8 (g = lane / 4), dQ in acc[DP / 2].
template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128, NWG == 2 && DP <= 64 ? 2 : 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq,
                        int skv, int d, float scale, float logit_scale) {
  constexpr int SW = swizzle(DP);
  constexpr int KC = DP / 16;
  constexpr int QR = NWG * 64;
  constexpr int NTHR = NWG * 128;
  constexpr int TILE = dft::tile_elems(kBlockN, DP, SW);  // one 64-row K or V tile
  constexpr int TQ = dft::tile_elems(QR, DP, SW);        // the Q or dO tile
  constexpr int S = dq_stages<DP, NWG>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* dOs = Qs + TQ;
  __nv_bfloat16* ring = dOs + TQ;  // stage st: K at 2*st*TILE, V TILE on
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 2 * S * TILE);  // Q/dO's, one a stage

  const int bh = blockIdx.y, q0 = blockIdx.x * QR;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;  // this thread's q rows
  const int n_kv = (skv + kBlockN - 1) / kBlockN;
  const size_t kv_off = (size_t)bh * skv * d;
  const bool tma = (d & 7) == 0;
  if (tma && tid == 0) {
    for (int i = 0; i < 1 + S; ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();
  auto load_kv = [&](int j) {  // TMA: started by thread 0; else complete on return
    __nv_bfloat16* kd = ring + (j % S) * 2 * TILE;
    if (tma) {
      if (tid == 0) {
        dft::mbar_expect_tx(&bars[1 + j % S], 2 * TILE * 2);
        dft::tma_load_tile<kBlockN, DP, SW>(kd, &kmap, j * kBlockN, bh, &bars[1 + j % S]);
        dft::tma_load_tile<kBlockN, DP, SW>(kd + TILE, &vmap, j * kBlockN, bh, &bars[1 + j % S]);
      }
    } else {
      dft::load_tile_elems<kBlockN, DP, SW>(kd, k + kv_off, j * kBlockN, skv, d, tid, NTHR);
      dft::load_tile_elems<kBlockN, DP, SW>(kd + TILE, v + kv_off, j * kBlockN, skv, d, tid,
                                            NTHR);
    }
  };
  if (tma) {
    if (tid == 0) {
      dft::mbar_expect_tx(&bars[0], 2 * TQ * 2);
      dft::tma_load_tile<QR, DP, SW>(Qs, &qmap, q0, bh, &bars[0]);
      dft::tma_load_tile<QR, DP, SW>(dOs, &omap, q0, bh, &bars[0]);
    }
  } else {
    dft::load_tile_elems<QR, DP, SW>(Qs, q + (size_t)bh * sq * d, q0, sq, d, tid, NTHR);
    dft::load_tile_elems<QR, DP, SW>(dOs, dout + (size_t)bh * sq * d, q0, sq, d, tid, NTHR);
  }
  for (int j = 0; j < (tma ? S - 1 : 1) && j < n_kv; ++j) load_kv(j);  // tiles 0..S-2
  const bool ok0 = r0 < sq, ok1 = r1 < sq;
  const float l0 = ok0 ? lse[(size_t)bh * sq + r0] : 0.f;
  const float l1 = ok1 ? lse[(size_t)bh * sq + r1] : 0.f;
  const float e0 = ok0 ? delta[(size_t)bh * sq + r0] : 0.f;
  const float e1 = ok1 ? delta[(size_t)bh * sq + r1] : 0.f;
  if (tma) dft::mbar_wait(&bars[0], 0);
  // this warpgroup's 64 rows of Q and dO: row 64*wg of the QR-row tiles
  const __nv_bfloat16* Qw = Qs + wg * 64 * (SW / 2);
  const __nv_bfloat16* dOw = dOs + wg * 64 * (SW / 2);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t da[kBlockN / 16][4];  // dS of the tile before, as bf16 A fragments
  // Iteration j: S_j = Q K_j^T, dP_j = dO V_j^T and dQ += dS_{j-1} K_{j-1}
  // run on the tensor cores together; once all three land, dS_j is formed
  // in place of dS_{j-1}.  (Forming dS_j while the dQ product still runs,
  // from a second buffer, was slower: the buffer, indexed by j's parity,
  // went to local memory.)  Tile j+S-2 is copied meanwhile into the stage
  // of tile j-2, whose dQ product landed before the barrier (element
  // loads: tile j+1, once this iteration's products have landed).
  for (int j = 0; j <= n_kv; ++j) {
    if (tma && j < n_kv) dft::mbar_wait(&bars[1 + j % S], (j / S) & 1);
    dft::fence_proxy_async();  // element loads of tile j are seen by wgmma
    __syncthreads();  // tile j is in; every warpgroup is done with tile j-2's stage
    if (tma && j >= 1 && j + S - 2 < n_kv) load_kv(j + S - 2);
    float s[kBlockN / 2], dp[kBlockN / 2];
    const __nv_bfloat16* Kt = ring + (j % S) * 2 * TILE;
    dft::fence_operands(s);
    dft::fence_operands(dp);
    dft::fence_operands(acc);
    dft::wgmma_fence();
    if (j < n_kv) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        dft::wgmma_ss<0, 0>(s, dft::desc_kmajor<QR, SW>(Qw, kc),
                            dft::desc_kmajor<kBlockN, SW>(Kt, kc), kc > 0);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        dft::wgmma_ss<0, 0>(dp, dft::desc_kmajor<QR, SW>(dOw, kc),
                            dft::desc_kmajor<kBlockN, SW>(Kt + TILE, kc), kc > 0);
      dft::wgmma_commit();
    }
    if (j >= 1) {
      const __nv_bfloat16* Kp = ring + ((j - 1) % S) * 2 * TILE;
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc)
        dft::wgmma_rs<1>(acc, da[kc], dft::desc_mnmajor<kBlockN, SW>(Kp, kc), 1);
      dft::wgmma_commit();
    }
    if (j == n_kv) break;
    dft::wgmma_wait<0>();
    dft::fence_operands(acc);
    dft::fence_operands(s);
    dft::fence_operands(dp);
    // dS in place of S, then as bf16 A fragments (k-chunk kc = kv 16kc..)
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool kv_ok = j * kBlockN + nt * 8 + 2 * t + jj < skv;
        const float p0 = (ok0 && kv_ok) ? exp2f(s[4 * nt + jj] * logit_scale - l0) : 0.f;
        const float p1 = (ok1 && kv_ok) ? exp2f(s[4 * nt + 2 + jj] * logit_scale - l1) : 0.f;
        s[4 * nt + jj] = p0 * (dp[4 * nt + jj] - e0) * scale;
        s[4 * nt + 2 + jj] = p1 * (dp[4 * nt + 2 + jj] - e1) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      da[kc][0] = dft::pack_bf16(s[8 * kc], s[8 * kc + 1]);
      da[kc][1] = dft::pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      da[kc][2] = dft::pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      da[kc][3] = dft::pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    // no TMA: tile j+1 into the stage of tile j+1-S (<= j-2), free since
    // the barrier
    if (!tma && j + 1 < n_kv) load_kv(j + 1);
  }
  dft::wgmma_wait<0>();
  dft::fence_operands(acc);
  __nv_bfloat16* dqb = dq + (size_t)bh * sq * d;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = dt * 8 + 2 * t + jj;
      if (c < d) {
        if (ok0) dqb[(size_t)r0 * d + c] = __float2bfloat16(acc[4 * dt + jj]);
        if (ok1) dqb[(size_t)r1 * d + c] = __float2bfloat16(acc[4 * dt + 2 + jj]);
      }
    }
  }
}

template <int DP, int NWG>
cudaError_t launch_dq(const CUtensorMap& km, const CUtensorMap& vm, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int skv, int d, float scale, float logit_scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP, NWG>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int SW = swizzle(DP);
  CUtensorMap qm{}, om{};  // unused (zero) when d % 8 != 0
  if ((d & 7) == 0 && !(dft::make_tile_map(&qm, q, bh, sq, d, NWG * 64, SW) &&
                        dft::make_tile_map(&om, dout, bh, sq, d, NWG * 64, SW)))
    return cudaErrorNotSupported;
  const dim3 grid((sq + NWG * 64 - 1) / (NWG * 64), bh);
  flash_bwd_dq_kernel<DP, NWG><<<grid, NWG * 128, smem, stream>>>(
      qm, om, km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), sq, skv, d, scale, logit_scale);
  return cudaGetLastError();
}

// dK/dV (q_splits CTAs a KV tile), then dQ (dq_tile q rows a CTA)
template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        float* dkv_part, int* counters, int bh, int sq, int skv, int d,
                        float scale, float logit_scale, int q_splits, int dq_tile,
                        cudaStream_t stream) {
  constexpr int BR = q_rows(DP);
  constexpr size_t smem = bf16_smem_bytes<DP, BR>();
  if (dq_tile != 64 && dq_tile != 128) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<DP, BR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qm{}, om{}, km{}, vm{}, lm{}, dm{};  // unused (zero) when d % 8 != 0
  constexpr int SW = swizzle(DP);
  if ((d & 7) == 0 && !(dft::make_tile_map(&qm, q, bh, sq, d, BR, SW) &&
                        dft::make_tile_map(&om, dout, bh, sq, d, BR, SW) &&
                        dft::make_tile_map(&km, k, bh, skv, d, kBlockN, SW) &&
                        dft::make_tile_map(&vm, v, bh, skv, d, kBlockN, SW) &&
                        dft::make_vec_map(&lm, lse, (long long)bh * sq, BR) &&
                        dft::make_vec_map(&dm, delta, (long long)bh * sq, BR)))
    return cudaErrorNotSupported;
  const dim3 grid((skv + kBlockN - 1) / kBlockN, bh, q_splits);
  flash_bwd_bf16_kernel<DP, BR><<<grid, kThreads, smem, stream>>>(
      qm, om, km, vm, lm, dm, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dkv_part, counters, sq, skv, d, scale, logit_scale,
      q_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dq_tile == 64 ? launch_dq<DP, 1>(km, vm, q, k, v, dout, lse, delta, dq, bh, sq, skv, d,
                                          scale, logit_scale, stream)
                       : launch_dq<DP, 2>(km, vm, q, k, v, dout, lse, delta, dq, bh, sq, skv, d,
                                          scale, logit_scale, stream);
}

}  // namespace

// q, dout, dq (bh, sq, d); k, v, dk, dv (bh, skv, d); lse (base 2), delta
// (bh, sq) fp32.  All contiguous.  dtype: 1 = bf16 (q, k, v, dout, dq, dk,
// dv; fp32 inputs: dft_flash_bwd_f32).  Two launches: dK/dV, then dQ summed
// over the KV tiles in their order.  q_splits: CTAs per (head, 64 KV rows),
// each over its share of the q tiles.  With q_splits > 1, dkv_part
// is fp32 scratch of q_splits * bh * ceil(skv/64) blocks of 2 * 64 * d_pad
// (d_pad = d rounded up to 16: one KV tile's dK and dV) and counters bh *
// ceil(skv/64) ints, zero on entry and left zero on exit.  dq_tile (bf16):
// q rows a CTA of the dQ kernel, 64 or 128.
// Returns the launches' cudaError_t (0 = launched).
extern "C" int dft_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, void* dk, void* dv,
                             void* dkv_part, void* counters, int bh, int sq, int skv, int d,
                             float scale, int dtype, int q_splits, int dq_tile, void* stream) {
  const float logit_scale = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (q_splits < 1 || q_splits > 65535 ||
      (q_splits > 1 && (dtype != 1 || dkv_part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    float* part = static_cast<float*>(dkv_part);
    int* cnt = static_cast<int*>(counters);
#define DFT_BWD_CASE(DP)                                                                    \
  case DP:                                                                                  \
    return launch_bf16<DP>(q, k, v, dout, l, dl, dq, dk, dv, part, cnt, bh, sq, skv, d,    \
                           scale, logit_scale, q_splits, dq_tile, st)
    switch ((d + 15) / 16 * 16) {
      DFT_BWD_CASE(16);
      DFT_BWD_CASE(32);
      DFT_BWD_CASE(48);
      DFT_BWD_CASE(64);
      DFT_BWD_CASE(80);
      DFT_BWD_CASE(96);
      DFT_BWD_CASE(112);
      DFT_BWD_CASE(128);
      DFT_BWD_CASE(144);
      DFT_BWD_CASE(160);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DFT_BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
