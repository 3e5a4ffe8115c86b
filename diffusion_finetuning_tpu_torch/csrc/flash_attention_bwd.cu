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
// Design (a first, simple kernel).  The TPU kernel walks the q blocks in a
// sequential grid and keeps dK/dV resident across it; on Hopper the CTAs
// run in parallel, so the loop over q moves inside the CTA:
//   * one CTA of 4 warps per (batch*head, 64-row KV tile); each warp owns 16
//     KV rows and keeps their dK and dV in fp32 registers for the whole call;
//   * K and V of the tile are copied to shared memory once; per iteration a
//     tile of BR q rows (Q, dO, lse, delta) is copied in, the head dim
//     zero-padded to a multiple of 16 in shared memory (40 -> 48), never in
//     device memory, rows padded by 8 elements against bank conflicts;
//   * S^T = K Q^T and dP^T = V dO^T run on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate); P^T and dS^T become A fragments in registers for
//     dV += P^T dO and dK += dS^T Q, whose B fragments come from ldmatrix.trans;
//   * dQ needs a sum over all KV tiles of a head, which live in different
//     CTAs: each CTA writes dS (bf16) to shared memory, the 4 warps compute
//     the (BR x d) tile dS K and add it with fp32 atomicAdd into a zeroed
//     fp32 buffer that the wrapper allocates and casts to q's dtype.  The
//     order of those additions varies from run to run (a few fp32 ulps).
// Registers: dK and dV take d_pad/2 floats a thread each (160 at d=160), so
// the q tile shrinks with the head dim (BR = 32 up to d_pad 96, else 16).
// Known slowness: the cross-attention calls give only ceil(77/64) = 2 KV
// tiles per head (16 CTAs on 132 SMs at BH=8); splitting the q loop over
// several CTAs with an fp32 reduction of dK/dV is the fix, still to come.
// No TMA, wgmma or copy/compute overlap yet.  fp32 inputs take a plain FMA
// kernel (flash_bwd_f32_kernel) with the same math.
#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockN = 64;  // kv rows per CTA (16 per warp)
constexpr int kPad = 8;      // shared-memory row padding (elements)
constexpr int kThreads = 128;

// Copy rows [row0, row0 + R) of a (rows, d) bf16 matrix into an (R, DP + 8)
// shared tile, zero-filling rows past `rows` and columns past d.
template <int R, int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int d) {
  constexpr int LD = DP + kPad;
  if ((d & 7) == 0) {
    constexpr int CH = DP / 8;
    for (int c = threadIdx.x; c < R * CH; c += blockDim.x) {
      const int r = c / CH, col = (c % CH) * 8, gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && col < d)
        val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + col);
      *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
    }
  } else {
    for (int c = threadIdx.x; c < R * DP; c += blockDim.x) {
      const int r = c / DP, col = c % DP, gr = row0 + r;
      dst[r * LD + col] =
          (gr < rows && col < d) ? src[(size_t)gr * d + col] : __float2bfloat16(0.f);
    }
  }
}

template <int DP, int BR>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(2 * kBlockN + 2 * BR) * (DP + kPad) +
                                  (size_t)BR * (kBlockN + kPad)) +
         sizeof(float) * 2 * BR;
}

template <int DP, int BR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int skv, int d, float scale,
                          float logit_scale) {
  constexpr int LD = DP + kPad;
  constexpr int LDS = kBlockN + kPad;  // row stride of the dS tile (BR x 64)
  constexpr int KC = DP / 16;          // k-chunks over the head dim
  constexpr int DT = DP / 8;           // n-tiles over the head dim
  constexpr int NQ = BR / 8;           // n-tiles of S^T over the q rows
  constexpr int QC = BR / 16;          // k-chunks over the q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 64 x LD
  __nv_bfloat16* Vs = Ks + kBlockN * LD;                            // 64 x LD
  __nv_bfloat16* Qs = Vs + kBlockN * LD;                            // BR x LD
  __nv_bfloat16* dOs = Qs + BR * LD;                                // BR x LD
  __nv_bfloat16* dSs = dOs + BR * LD;                               // BR x LDS, dS[q][kv]
  float* lse_s = reinterpret_cast<float*>(dSs + BR * LDS);          // BR
  float* dlt_s = lse_s + BR;                                        // BR

  const int bh = blockIdx.y, kv0 = blockIdx.x * kBlockN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  dq_acc += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  const size_t kv_off = (size_t)bh * skv * d;

  load_rows<kBlockN, DP>(Ks, k + kv_off, kv0, skv, d);
  load_rows<kBlockN, DP>(Vs, v + kv_off, kv0, skv, d);

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }
  const __nv_bfloat16* kw = Ks + warp * 16 * LD;  // this warp's 16 kv rows
  const __nv_bfloat16* vw = Vs + warp * 16 * LD;
  const bool kv_ok0 = kv0 + warp * 16 + g < skv, kv_ok1 = kv0 + warp * 16 + g + 8 < skv;

  for (int q0 = 0; q0 < sq; q0 += BR) {
    __syncthreads();  // the previous tile's Q, dO and dS are no longer read
    load_rows<BR, DP>(Qs, q, q0, sq, d);
    load_rows<BR, DP>(dOs, dout, q0, sq, d);
    for (int i = threadIdx.x; i < BR; i += blockDim.x) {
      const bool ok = q0 + i < sq;
      lse_s[i] = ok ? lse[q0 + i] : 0.f;
      dlt_s[i] = ok ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x BR q columns
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + 2 * t;
      const uint32_t ka[4] = {dft::ld_u32(kw + g * LD + c), dft::ld_u32(kw + (g + 8) * LD + c),
                              dft::ld_u32(kw + g * LD + c + 8),
                              dft::ld_u32(kw + (g + 8) * LD + c + 8)};
      const uint32_t va[4] = {dft::ld_u32(vw + g * LD + c), dft::ld_u32(vw + (g + 8) * LD + c),
                              dft::ld_u32(vw + g * LD + c + 8),
                              dft::ld_u32(vw + (g + 8) * LD + c + 8)};
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const __nv_bfloat16* qr = Qs + (nt * 8 + g) * LD + c;
        const __nv_bfloat16* dr = dOs + (nt * 8 + g) * LD + c;
        dft::mma_bf16(s[nt], ka, dft::ld_u32(qr), dft::ld_u32(qr + 8));
        dft::mma_bf16(dp[nt], va, dft::ld_u32(dr), dft::ld_u32(dr + 8));
      }
    }

    // P^T = exp2(S^T * scale * log2 e - lse), dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * t + j;
        const bool q_ok = q0 + qc < sq;
        const float l = lse_s[qc], dl = dlt_s[qc];
        const float p0 = (q_ok && kv_ok0) ? exp2f(s[nt][j] * logit_scale - l) : 0.f;
        const float p1 = (q_ok && kv_ok1) ? exp2f(s[nt][2 + j] * logit_scale - l) : 0.f;
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        dp[nt][j] = p0 * (dp[nt][j] - dl) * scale;
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - dl) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q (k runs over the q rows of the tile)
#pragma unroll
    for (int qc = 0; qc < QC; ++qc) {
      uint32_t pa[4], da[4];
      pa[0] = dft::pack_bf16(s[2 * qc][0], s[2 * qc][1]);
      pa[1] = dft::pack_bf16(s[2 * qc][2], s[2 * qc][3]);
      pa[2] = dft::pack_bf16(s[2 * qc + 1][0], s[2 * qc + 1][1]);
      pa[3] = dft::pack_bf16(s[2 * qc + 1][2], s[2 * qc + 1][3]);
      da[0] = dft::pack_bf16(dp[2 * qc][0], dp[2 * qc][1]);
      da[1] = dft::pack_bf16(dp[2 * qc][2], dp[2 * qc][3]);
      da[2] = dft::pack_bf16(dp[2 * qc + 1][0], dp[2 * qc + 1][1]);
      da[3] = dft::pack_bf16(dp[2 * qc + 1][2], dp[2 * qc + 1][3]);
      const __nv_bfloat16* dor = dOs + (qc * 16 + (lane & 15)) * LD;
      const __nv_bfloat16* qrr = Qs + (qc * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        dft::ldmatrix_x2_trans(b0, b1, dor + dt * 8);
        dft::mma_bf16(dv_acc[dt], pa, b0, b1);
        dft::ldmatrix_x2_trans(b0, b1, qrr + dt * 8);
        dft::mma_bf16(dk_acc[dt], da, b0, b1);
      }
    }

    // dS (bf16) to shared memory as dS[q][kv], for dQ = dS K
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * t + j;
        dSs[qc * LDS + warp * 16 + g] = __float2bfloat16(dp[nt][j]);
        dSs[qc * LDS + warp * 16 + g + 8] = __float2bfloat16(dp[nt][2 + j]);
      }
    }
    __syncthreads();

    // dQ tile (BR x DP) += dS (BR x 64) K (64 x DP): 16x8 output tiles over the warps
    for (int tile = warp; tile < QC * DT; tile += kThreads / 32) {
      const int mt = tile / DT, dt = tile % DT;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        const __nv_bfloat16* ar = dSs + mt * 16 * LDS + kc * 16 + 2 * t;
        const uint32_t a[4] = {dft::ld_u32(ar + g * LDS), dft::ld_u32(ar + (g + 8) * LDS),
                               dft::ld_u32(ar + g * LDS + 8),
                               dft::ld_u32(ar + (g + 8) * LDS + 8)};
        uint32_t b0, b1;
        dft::ldmatrix_x2_trans(b0, b1, Ks + (kc * 16 + (lane & 15)) * LD + dt * 8);
        dft::mma_bf16(acc, a, b0, b1);
      }
      const int r0 = q0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = dt * 8 + 2 * t + j;
        if (col < d) {
          if (r0 < sq) atomicAdd(dq_acc + (size_t)r0 * d + col, acc[j]);
          if (r1 < sq) atomicAdd(dq_acc + (size_t)r1 * d + col, acc[2 + j]);
        }
      }
    }
  }

  const int r0 = kv0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* dkb = dk + kv_off;
  __nv_bfloat16* dvb = dv + kv_off;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = dt * 8 + 2 * t + j;
      if (c < d) {
        if (r0 < skv) {
          dkb[(size_t)r0 * d + c] = __float2bfloat16(dk_acc[dt][j]);
          dvb[(size_t)r0 * d + c] = __float2bfloat16(dv_acc[dt][j]);
        }
        if (r1 < skv) {
          dkb[(size_t)r1 * d + c] = __float2bfloat16(dk_acc[dt][2 + j]);
          dvb[(size_t)r1 * d + c] = __float2bfloat16(dv_acc[dt][2 + j]);
        }
      }
    }
  }
}

// fp32 inputs: the same math with plain FMA in shared memory; one CTA per
// (batch*head, 16 kv rows), q in tiles of 16 rows, dK/dV in shared memory.
constexpr int kF32N = 16, kF32M = 16;

size_t f32_smem_bytes(int d) {
  return sizeof(float) * (size_t)(6 * 16 * d + 2 * kF32N * (kF32M + 1) + 2 * kF32M);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq_acc, float* __restrict__ dk,
                         float* __restrict__ dv, int sq, int skv, int d, float scale,
                         float logit_scale) {
  extern __shared__ float sm[];
  float* Ks = sm;                      // kF32N x d
  float* Vs = Ks + kF32N * d;          // kF32N x d
  float* dKs = Vs + kF32N * d;         // kF32N x d
  float* dVs = dKs + kF32N * d;        // kF32N x d
  float* Qs = dVs + kF32N * d;         // kF32M x d
  float* dOs = Qs + kF32M * d;         // kF32M x d
  float* P = dOs + kF32M * d;          // kF32N x (kF32M + 1)
  float* dS = P + kF32N * (kF32M + 1); // kF32N x (kF32M + 1)
  float* Ls = dS + kF32N * (kF32M + 1);
  float* Ds = Ls + kF32M;

  const int bh = blockIdx.y, kv0 = blockIdx.x * kF32N, tid = threadIdx.x;
  const float* kb = k + (size_t)bh * skv * d;
  const float* vb = v + (size_t)bh * skv * d;
  const float* qb = q + (size_t)bh * sq * d;
  const float* db = dout + (size_t)bh * sq * d;
  float* dqb = dq_acc + (size_t)bh * sq * d;
  for (int i = tid; i < kF32N * d; i += kThreads) {
    const int gr = kv0 + i / d;
    const bool ok = gr < skv;
    Ks[i] = ok ? kb[(size_t)gr * d + i % d] : 0.f;
    Vs[i] = ok ? vb[(size_t)gr * d + i % d] : 0.f;
    dKs[i] = dVs[i] = 0.f;
  }
  for (int q0 = 0; q0 < sq; q0 += kF32M) {
    __syncthreads();
    for (int i = tid; i < kF32M * d; i += kThreads) {
      const int gr = q0 + i / d;
      const bool ok = gr < sq;
      Qs[i] = ok ? qb[(size_t)gr * d + i % d] : 0.f;
      dOs[i] = ok ? db[(size_t)gr * d + i % d] : 0.f;
    }
    if (tid < kF32M) {
      const bool ok = q0 + tid < sq;
      Ls[tid] = ok ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
      Ds[tid] = ok ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kF32N * kF32M; i += kThreads) {
      const int r = i / kF32M, c = i % kF32M;
      float sv = 0.f, dpv = 0.f;
      for (int e = 0; e < d; ++e) {
        sv = fmaf(Ks[r * d + e], Qs[c * d + e], sv);
        dpv = fmaf(Vs[r * d + e], dOs[c * d + e], dpv);
      }
      const bool ok = kv0 + r < skv && q0 + c < sq;
      const float p = ok ? exp2f(sv * logit_scale - Ls[c]) : 0.f;
      P[r * (kF32M + 1) + c] = p;
      dS[r * (kF32M + 1) + c] = p * (dpv - Ds[c]) * scale;
    }
    __syncthreads();
    for (int i = tid; i < kF32N * d; i += kThreads) {
      const int r = i / d, col = i % d;
      float a = dVs[i], b = dKs[i];
      for (int c = 0; c < kF32M; ++c) {
        a = fmaf(P[r * (kF32M + 1) + c], dOs[c * d + col], a);
        b = fmaf(dS[r * (kF32M + 1) + c], Qs[c * d + col], b);
      }
      dVs[i] = a;
      dKs[i] = b;
    }
    for (int i = tid; i < kF32M * d; i += kThreads) {
      const int c = i / d, col = i % d;
      if (q0 + c < sq) {
        float a = 0.f;
        for (int r = 0; r < kF32N; ++r) a = fmaf(dS[r * (kF32M + 1) + c], Ks[r * d + col], a);
        atomicAdd(dqb + (size_t)(q0 + c) * d + col, a);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kF32N * d; i += kThreads) {
    const int gr = kv0 + i / d;
    if (gr < skv) {
      dk[(size_t)bh * skv * d + (size_t)gr * d + i % d] = dKs[i];
      dv[(size_t)bh * skv * d + (size_t)gr * d + i % d] = dVs[i];
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                        int bh, int sq, int skv, int d, float scale, float logit_scale,
                        cudaStream_t stream) {
  constexpr int BR = DP <= 96 ? 32 : 16;
  constexpr size_t smem = bf16_smem_bytes<DP, BR>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<DP, BR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((skv + kBlockN - 1) / kBlockN, bh);
  flash_bwd_bf16_kernel<DP, BR><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      dq_acc, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq, skv, d,
      scale, logit_scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout (bh, sq, d); k, v, dk, dv (bh, skv, d); lse (base 2), delta (bh, sq)
// fp32; dq_acc (bh, sq, d) fp32, zeroed by the caller, receives dQ by atomic
// adds.  All contiguous.  dtype: 0 = fp32, 1 = bf16 (q, k, v, dout, dk, dv).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int dft_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq_acc, void* dk,
                             void* dv, int bh, int sq, int skv, int d, float scale, int dtype,
                             void* stream) {
  const float logit_scale = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == 1) {
#define DFT_BWD_CASE(DP) \
  case DP:               \
    return launch_bf16<DP>(q, k, v, dout, l, dl, acc, dk, dv, bh, sq, skv, d, scale, logit_scale, st)
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
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((skv + kF32N - 1) / kF32N, bh);
    flash_bwd_f32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, dl, acc, static_cast<float*>(dk),
        static_cast<float*>(dv), sq, skv, d, scale, logit_scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
