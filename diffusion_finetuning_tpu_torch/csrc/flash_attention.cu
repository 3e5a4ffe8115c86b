// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// diffusion_finetuning_tpu/ops/flash_attention.py:_fwd_kernel (:87), reached
// through _fwd (:141, pallas_call :152).  Same function: per (batch*head,
// q-block) K/V blocks stream through an online softmax with a running max m,
// a running sum l and an fp32 accumulator; columns at or past kv_len are
// masked to -1e30 (not -inf, so no row can turn into NaN); the logit scale
// folds in log2(e) and the softmax uses exp2.  Outputs: O = acc / l in the
// input dtype and lse = m + log2(l) in fp32, i.e. the log-sum-exp of the
// scaled logits in BASE 2 (lse_natural = lse * ln 2) -- the convention the
// backward kernel of the training slice reads.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the SD1.5
// 512^2 CFG self-attention at S=4096, d=40, BH=16 is 4*16*4096^2*40 = 43
// GFLOP, about 43 us; S=1024, d=80 is 5.4 GFLOP, about 5.4 us.  The
// cross-attention calls (KV=77) are memory-bound: q and o at S=4096 are
// about 10 MB, about 3 us.
//
// Design (a first, simple kernel): one CTA of 4 warps per (batch*head,
// 64-row q tile); each warp owns 16 q rows.  K/V tiles of 64 rows are copied
// into shared memory, the head dim zero-padded there (not in device memory)
// to a multiple of 16 (40 -> 48), rows padded by 8 elements so that the
// fragment loads are free of bank conflicts.  Q stays in registers as mma A
// fragments; S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 with fp32
// accumulation; P is rounded to bf16 in registers (the Pallas kernel casts p
// to v's dtype) and V fragments come from ldmatrix.trans.  The row sum l is
// kept per thread and reduced across the quad once at the end.  No TMA,
// wgmma or copy/compute overlap yet.  fp32 inputs take a plain FMA kernel
// (flash_fwd_f32_kernel) with the same math.
//
// K4, the head-packed forward (dft_flash_fwd with G > 1), replaces the Pallas
// kernel _fwd_kernel_packed (:178, via _fwd_packed :239, pallas_call :254):
// G heads per program, outputs bit-equal to K1's.  On the TPU packing
// shrinks the grid by G and hands Mosaic G independent chains to
// interleave.  Here a CTA of the grid (ceil(Sq/64), BH/G) runs the per-head
// body below for its G heads in turn: the same instructions in the same
// order per head, so bit-equality holds by construction.  It moves the same
// bytes and operations as K1 (same bound); it trades CTAs for a longer life
// per CTA, which helps only where K1's grid is larger than the card.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 64;  // q rows per CTA
constexpr int kBlockN = 64;  // kv rows per shared-memory tile
constexpr int kPad = 8;      // shared-memory row padding (elements)

// Copy rows [row0, row0 + 64) of a (rows, d) bf16 matrix into a (64, DP + 8)
// shared tile, zero-filling rows past `rows` and columns past d.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int d) {
  constexpr int LD = DP + kPad;
  if ((d & 7) == 0) {
    constexpr int CH = DP / 8;
    for (int c = threadIdx.x; c < kBlockN * CH; c += blockDim.x) {
      const int r = c / CH, col = (c % CH) * 8, gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && col < d)
        val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + col);
      *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
    }
  } else {
    for (int c = threadIdx.x; c < kBlockN * DP; c += blockDim.x) {
      const int r = c / DP, col = c % DP, gr = row0 + r;
      dst[r * LD + col] =
          (gr < rows && col < d) ? src[(size_t)gr * d + col] : __float2bfloat16(0.f);
    }
  }
}

// One (head, 64-row q tile) of the forward: qb/kb/vb/ob point at the head's
// (sq, d) / (skv, d) matrices and lseb at its sq lse values.  Every kernel
// below runs this body, so the packed kernel (K4) computes each head with the
// same instructions in the same order as K1 and its outputs are bit-equal.
template <int DP>
__device__ __forceinline__ void flash_fwd_bf16_head(const __nv_bfloat16* __restrict__ qb,
                                                    const __nv_bfloat16* __restrict__ kb,
                                                    const __nv_bfloat16* __restrict__ vb,
                                                    __nv_bfloat16* __restrict__ ob,
                                                    float* __restrict__ lseb, int q0, int sq,
                                                    int skv, int d, float logit_scale,
                                                    __nv_bfloat16* Ks) {
  constexpr int LD = DP + kPad;
  constexpr int KC = DP / 16;       // k-chunks of the QK^T product
  constexpr int DT = DP / 8;        // n-tiles of the PV product
  constexpr int NT = kBlockN / 8;   // n-tiles of S
  __nv_bfloat16* Vs = Ks + kBlockN * LD;  // Q is staged in Ks first

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  __syncthreads();  // a previous head's last tile is no longer read
  load_tile<DP>(Ks, qb, q0, sq, d);
  __syncthreads();
  uint32_t qa[KC][4];
  {
    const __nv_bfloat16* qs = Ks + warp * 16 * LD;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qa[kc][0] = dft::ld_u32(qs + g * LD + kc * 16 + 2 * t);
      qa[kc][1] = dft::ld_u32(qs + (g + 8) * LD + kc * 16 + 2 * t);
      qa[kc][2] = dft::ld_u32(qs + g * LD + kc * 16 + 2 * t + 8);
      qa[kc][3] = dft::ld_u32(qs + (g + 8) * LD + kc * 16 + 2 * t + 8);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int kv0 = 0; kv0 < skv; kv0 += kBlockN) {
    __syncthreads();  // the previous tile (or the staged Q) is no longer read
    load_tile<DP>(Ks, kb, kv0, skv, d);
    load_tile<DP>(Vs, vb, kv0, skv, d);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        dft::mma_bf16(s[nt], qa[kc], dft::ld_u32(kr + kc * 16), dft::ld_u32(kr + kc * 16 + 8));
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = kv0 + nt * 8 + 2 * t + j < skv;
        s[nt][j] = valid ? s[nt][j] * logit_scale : kNegInf;
        s[nt][2 + j] = valid ? s[nt][2 + j] * logit_scale : kNegInf;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(s[nt][j] - mn0);
        s[nt][2 + j] = exp2f(s[nt][2 + j] - mn1);
        rs0 += s[nt][j];
        rs1 += s[nt][2 + j];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }

#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = dft::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = dft::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = dft::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = dft::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vr = Vs + (kc * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        dft::ldmatrix_x2_trans(b0, b1, vr + dt * 8);
        dft::mma_bf16(acc[dt], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = dt * 8 + 2 * t + j;
      if (c < d) {
        if (r0 < sq) ob[(size_t)r0 * d + c] = __float2bfloat16(acc[dt][j] * inv0);
        if (r1 < sq) ob[(size_t)r1 * d + c] = __float2bfloat16(acc[dt][2 + j] * inv1);
      }
    }
  }
  if (t == 0) {
    if (r0 < sq) lseb[r0] = m0 + log2f(l0);
    if (r1 < sq) lseb[r1] = m1 + log2f(l1);
  }
}

template <int DP>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int sq, int skv, int d, float logit_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bh = blockIdx.y;
  flash_fwd_bf16_head<DP>(q + bh * sq * d, k + bh * skv * d, v + bh * skv * d, o + bh * sq * d,
                          lse + bh * sq, blockIdx.x * kBlockM, sq, skv, d, logit_scale,
                          reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

// K4: G heads per CTA, one after the other (JAX _fwd_kernel_packed carries G
// independent softmax chains through one program; here the heads run in
// turn through the same shared tiles, so each head's arithmetic is K1's).
template <int DP>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_packed_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
                                 int skv, int d, float logit_scale, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (int i = 0; i < G; ++i) {
    const size_t bh = (size_t)blockIdx.y * G + i;
    flash_fwd_bf16_head<DP>(q + bh * sq * d, k + bh * skv * d, v + bh * skv * d,
                            o + bh * sq * d, lse + bh * sq, blockIdx.x * kBlockM, sq, skv, d,
                            logit_scale, reinterpret_cast<__nv_bfloat16*>(smem_raw));
  }
}

// fp32 inputs: the same online softmax with plain FMA in shared memory.
constexpr int kF32M = 16, kF32N = 32, kF32Threads = 128;

size_t f32_smem_bytes(int d) {
  return sizeof(float) * (size_t)(2 * kF32M * d + kF32N * (d + 1) + kF32N * d +
                                  kF32M * (kF32N + 1) + 3 * kF32M);
}

__device__ __forceinline__ void flash_fwd_f32_head(const float* __restrict__ qb,
                                                   const float* __restrict__ kb,
                                                   const float* __restrict__ vb,
                                                   float* __restrict__ ob,
                                                   float* __restrict__ lseb, int q0, int sq,
                                                   int skv, int d, float logit_scale, float* sm) {
  float* Qs = sm;                          // kF32M x d
  float* Os = Qs + kF32M * d;              // kF32M x d
  float* Ks = Os + kF32M * d;              // kF32N x (d + 1)
  float* Vs = Ks + kF32N * (d + 1);        // kF32N x d
  float* S = Vs + kF32N * d;               // kF32M x (kF32N + 1)
  float* Mr = S + kF32M * (kF32N + 1);
  float* Lr = Mr + kF32M;
  float* Ar = Lr + kF32M;

  const int tid = threadIdx.x;
  __syncthreads();  // a previous head's outputs are written
  for (int i = tid; i < kF32M * d; i += kF32Threads) {
    const int r = i / d, c = i % d;
    Qs[i] = (q0 + r < sq) ? qb[(size_t)(q0 + r) * d + c] : 0.f;
    Os[i] = 0.f;
  }
  if (tid < kF32M) {
    Mr[tid] = kNegInf;
    Lr[tid] = 0.f;
  }
  for (int kv0 = 0; kv0 < skv; kv0 += kF32N) {
    __syncthreads();
    for (int i = tid; i < kF32N * d; i += kF32Threads) {
      const int r = i / d, c = i % d, gr = kv0 + r;
      const bool ok = gr < skv;
      Ks[r * (d + 1) + c] = ok ? kb[(size_t)gr * d + c] : 0.f;
      Vs[r * d + c] = ok ? vb[(size_t)gr * d + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kF32M * kF32N; i += kF32Threads) {
      const int r = i / kF32N, c = i % kF32N;
      float a = 0.f;
      for (int e = 0; e < d; ++e) a = fmaf(Qs[r * d + e], Ks[c * (d + 1) + e], a);
      S[r * (kF32N + 1) + c] = (kv0 + c < skv) ? a * logit_scale : kNegInf;
    }
    __syncthreads();
    if (tid < kF32M) {
      float* row = S + tid * (kF32N + 1);
      const float m_old = Mr[tid];
      float mx = m_old;
      for (int c = 0; c < kF32N; ++c) mx = fmaxf(mx, row[c]);
      float sum = 0.f;
      for (int c = 0; c < kF32N; ++c) {
        const float p = exp2f(row[c] - mx);
        row[c] = p;
        sum += p;
      }
      const float alpha = exp2f(m_old - mx);
      Lr[tid] = Lr[tid] * alpha + sum;
      Mr[tid] = mx;
      Ar[tid] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < kF32M * d; i += kF32Threads) {
      const int r = i / d, c = i % d;
      float a = Os[i] * Ar[r];
      const float* row = S + r * (kF32N + 1);
      for (int j = 0; j < kF32N; ++j) a = fmaf(row[j], Vs[j * d + c], a);
      Os[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < kF32M * d; i += kF32Threads) {
    const int r = i / d;
    if (q0 + r < sq) ob[(size_t)(q0 + r) * d + i % d] = Os[i] / Lr[r];
  }
  if (tid < kF32M && q0 + tid < sq) lseb[q0 + tid] = Mr[tid] + log2f(Lr[tid]);
}

// G = 1: K1's fp32 variant; G > 1: K4's (heads blockIdx.y * G .. + G - 1 in turn).
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv, int d, float logit_scale,
                         int G) {
  extern __shared__ float sm[];
  for (int i = 0; i < G; ++i) {
    const size_t bh = (size_t)blockIdx.y * G + i;
    flash_fwd_f32_head(q + bh * sq * d, k + bh * skv * d, v + bh * skv * d, o + bh * sq * d,
                       lse + bh * sq, blockIdx.x * kF32M, sq, skv, d, logit_scale, sm);
  }
}

// G heads per CTA; G = 1 is K1, G > 1 the packed K4.
template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int sq, int skv, int d, float logit_scale, int G, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh / G);
  const size_t smem = 2 * kBlockN * (DP + kPad) * sizeof(__nv_bfloat16);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (G == 1)
    flash_fwd_bf16_kernel<DP><<<grid, 128, smem, stream>>>(qp, kp, vp, op, lse, sq, skv, d,
                                                           logit_scale);
  else
    flash_fwd_bf16_packed_kernel<DP><<<grid, 128, smem, stream>>>(qp, kp, vp, op, lse, sq, skv,
                                                                  d, logit_scale, G);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k/v (bh, skv, d), o like q, lse (bh, sq) fp32; all contiguous.
// dtype: 0 = fp32, 1 = bf16.  G heads per CTA: 1 runs K1, G > 1 (dividing bh)
// runs K4, whose O and lse are bit-equal to K1's.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int dft_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int sq, int skv, int d, float scale, int dtype, int G,
                             void* stream) {
  const float logit_scale = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (G < 1 || bh % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch ((d + 15) / 16 * 16) {
      case 16: return launch_bf16<16>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 32: return launch_bf16<32>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 48: return launch_bf16<48>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 64: return launch_bf16<64>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 80: return launch_bf16<80>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 96: return launch_bf16<96>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 112: return launch_bf16<112>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 128: return launch_bf16<128>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 144: return launch_bf16<144>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      case 160: return launch_bf16<160>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kF32M - 1) / kF32M, bh / G);
    flash_fwd_f32_kernel<<<grid, kF32Threads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), l, sq, skv, d, logit_scale, G);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
