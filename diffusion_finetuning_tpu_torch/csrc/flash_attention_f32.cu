// Flash-attention forward on fp32 inputs for Hopper (sm_90a): K1's fp32
// kernel, and K4's (G heads a CTA, run in turn).
//
// Replaces, on fp32 inputs, the JAX package's Pallas TPU kernels
// diffusion_finetuning_tpu/ops/flash_attention.py:_fwd_kernel (:87,
// pallas_call :152) and _fwd_kernel_packed (:178, :254): fp32 products with
// fp32 sums (:106-119), the online softmax of csrc/flash_attention.cu (row
// max m, row sum l, -1e30 past kv_len, exp2 with log2(e) folded into the
// logit scale), O = acc / l and the base-2 lse = m + log2(l).  fp32 pipes
// (Pipeline.from_pretrained's default) and the trainers' default precision
// run it.
//
// Bound on an H100 SXM: 4 * BH * Sq * Skv * d operations; on the split
// product (three TF32 products, split_f32.cuh) at 494.7 TFLOP/s dense TF32
// the SD1.5 512^2 CFG self-attention at S=4096, d=40, BH=16 is 129 GFLOP of
// tensor work, about 0.26 ms; the calls of one CFG UNet step about 1.5 ms.
// The cross-attention calls (Skv=77) are bound by bytes.
//
// Design.
//   * A prep pass (split_f32.cuh) writes the split copies once a call: Q and
//     K as [big; small] (2, BH, S, d_pad) rows, V as [big; small] transposed
//     (2, BH, d_pad, Skv rounded to 8), its kv rows permuted within groups
//     of 8 so that P's A fragments come straight from the S accumulator.
//     The head dim is zero-padded to d_pad (a multiple of 8), so every tile
//     comes by TMA, whatever d is.
//   * A CTA is one warpgroup owning 64 q rows of a head (G heads in turn).
//     Q big and small arrive once; K big/small and V^T big/small tiles of N
//     kv rows (64 up to d_pad 64, 32 up to 128, else 16: shared memory)
//     stream through a ring of 2 stages by TMA, the next tile in flight
//     while one is multiplied.  Tiles use wgmma.cuh's swizzled layout at
//     the widest swizzle the row fills (split_f32.cuh:f32_swizzle).
//   * S = Q K^T: per 8-column k-chunk small*big, big*small, big*big (wgmma
//     m64nNk8 tf32, A and B from shared memory), one fp32 accumulator.  The
//     online softmax runs on it in registers in fp32 (exp2f); P is split
//     into big and small A fragments in registers, and P V is the split
//     product against the V^T tiles (wgmma m64n{d_pad}k8, A from
//     registers) into a fresh accumulator, added to O by FMA: the tensor
//     cores' fp32 sums are not rounded to nearest, and carried through the
//     whole kv loop (1,536 additions at Skv = 4096) their error grew to
//     2.9e-5 relative L2 at 4096^2 (measured); per tile it stays near fp32's.
//   * Two CTAs share an SM at d_pad <= 40 (101 KB of shared memory each), so
//     one CTA's softmax overlaps the other's products.
#include "split_f32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;

// kv rows a tile: as many as shared memory allows two stages of
__host__ __device__ constexpr int kv_rows(int DP) { return DP <= 64 ? 64 : DP <= 128 ? 32 : 16; }

template <int DP>
struct FwdTiles {
  static constexpr int N = kv_rows(DP);
  static constexpr int SWQ = dft::f32_swizzle(DP);  // Q and K tiles (k = d along a row)
  static constexpr int SWV = dft::f32_swizzle(N);   // V^T tiles (k = kv along a row)
  static constexpr int QB = dft::f32_tile_bytes(64, DP);  // a Q tile
  static constexpr int KB = dft::f32_tile_bytes(N, DP);   // a K or V^T tile
  static constexpr int STAGE = 4 * KB;  // K big, K small, V^T big, V^T small
  static constexpr size_t smem() {
    return 1024 + 2 * (size_t)QB + kStages * (size_t)STAGE + 8 * (1 + kStages);
  }
};

// Online softmax of one N-column tile S (at kv0) into P, in place: rows g
// and g + 8 of the thread's warp; al0/al1 take O from the old row maxima to
// the new ones.  The row max is taken on the raw products (logit_scale > 0).
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], int kv0, int skv, int t,
                                               float logit_scale, float& m0, float& m1,
                                               float& l0, float& l1, float& al0, float& al1) {
  if (kv0 + N > skv) {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (kv0 + nt * 8 + 2 * t + jj >= skv) s[4 * nt + jj] = s[4 * nt + 2 + jj] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mx0 = fmaxf(mx0, s[4 * nt + jj]);
      mx1 = fmaxf(mx1, s[4 * nt + 2 + jj]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * logit_scale), mn1 = fmaxf(m1, mx1 * logit_scale);
  al0 = exp2f(m0 - mn0);
  al1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      s[4 * nt + jj] = exp2f(fmaf(s[4 * nt + jj], logit_scale, -mn0));
      s[4 * nt + 2 + jj] = exp2f(fmaf(s[4 * nt + 2 + jj], logit_scale, -mn1));
      rs0 += s[4 * nt + jj];
      rs1 += s[4 * nt + 2 + jj];
    }
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}

// One (head, 64-row q tile): Q of head `head` (its small half at head bh +
// head), K/V tiles through the ring; `seq` tiles went through the ring
// before (earlier heads), `qphase` is Q's barrier phase.
template <int DP>
__device__ __forceinline__ void fwd_head(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, int head, int bh,
                                         float* __restrict__ ob, float* __restrict__ lseb,
                                         int q0, int sq, int skv, int d, float logit_scale,
                                         unsigned char* smem, uint64_t* bars, int seq,
                                         int qphase) {
  using T = FwdTiles<DP>;
  constexpr int N = T::N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* Qb = reinterpret_cast<const float*>(smem);
  const float* Qs = reinterpret_cast<const float*>(smem + T::QB);
  unsigned char* ring = smem + 2 * T::QB;
  const int n_kv = (skv + N - 1) / N;
  auto tile = [&](int j, int i) {  // tile i (K big, K small, V^T big, V^T small) of kv tile j
    return reinterpret_cast<float*>(ring + ((seq + j) % kStages) * T::STAGE + i * T::KB);
  };
  auto load_kv = [&](int j) {  // started by thread 0
    uint64_t* bar = &bars[1 + (seq + j) % kStages];
    dft::mbar_expect_tx(bar, 4 * N * DP * 4);
    for (int h = 0; h < 2; ++h) {
      dft::tma_load_tile_f32<N, DP, T::SWQ>(tile(j, h), kmap, j * N, 0, head + h * bh, bar);
      dft::tma_load_tile_f32<DP, N, T::SWV>(tile(j, 2 + h), vmap, 0, j * N, head + h * bh,
                                            bar);
    }
  };
  if (tid == 0) {
    dft::mbar_expect_tx(&bars[0], 2 * 64 * DP * 4);
    dft::tma_load_tile_f32<64, DP, T::SWQ>(const_cast<float*>(Qb), qmap, q0, 0, head, &bars[0]);
    dft::tma_load_tile_f32<64, DP, T::SWQ>(const_cast<float*>(Qs), qmap, q0, 0, head + bh,
                                           &bars[0]);
    for (int j = 0; j < kStages && j < n_kv; ++j) load_kv(j);
  }
  dft::mbar_wait(&bars[0], qphase);

  float o[DP / 2], pv[DP / 2], s[N / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0, al1;
  uint32_t phi[N / 8][4], plo[N / 8][4];
  for (int j = 0; j < n_kv; ++j) {
    dft::mbar_wait(&bars[1 + (seq + j) % kStages], ((seq + j) / kStages) & 1);
    const float *Kb = tile(j, 0), *Ks = tile(j, 1), *Vb = tile(j, 2), *Vs = tile(j, 3);
    dft::fence_operands(s);
    dft::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWQ>(Qs, kc), dft::desc_f32<N, T::SWQ>(Kb, kc),
                         kc > 0);
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWQ>(Qb, kc), dft::desc_f32<N, T::SWQ>(Ks, kc),
                         1);
      dft::wgmma_tf32_ss(s, dft::desc_f32<64, T::SWQ>(Qb, kc), dft::desc_f32<N, T::SWQ>(Kb, kc),
                         1);
    }
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(s);
    online_softmax<N>(s, j * N, skv, t, logit_scale, m0, m1, l0, l1, al0, al1);
    // P's A fragments: logical (row, column) (g, c) holds kv 2c (c < 4) or
    // 2(c - 4) + 1, the order of V^T's columns
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      dft::split_frag(phi[i], plo[i], s[4 * i], s[4 * i + 2], s[4 * i + 1], s[4 * i + 3]);
    dft::fence_operands(pv);
    dft::wgmma_fence();
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      dft::wgmma_tf32_rs(pv, plo[i], dft::desc_f32<DP, T::SWV>(Vb, i), i > 0);
      dft::wgmma_tf32_rs(pv, phi[i], dft::desc_f32<DP, T::SWV>(Vs, i), 1);
      dft::wgmma_tf32_rs(pv, phi[i], dft::desc_f32<DP, T::SWV>(Vb, i), 1);
    }
    dft::wgmma_commit();
    dft::wgmma_wait<0>();
    dft::fence_operands(pv);
    // O = O alpha + P_j V_j, rounded to nearest: the tensor cores' own sums
    // (not rounded to nearest) span one tile, not the whole kv loop
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] = fmaf(o[4 * i], al0, pv[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], al0, pv[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], al1, pv[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], al1, pv[4 * i + 3]);
    }
    __syncthreads();  // no thread still reads tile j's stage
    if (tid == 0 && j + kStages < n_kv) load_kv(j + kStages);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = dt * 8 + 2 * t + jj;
      if (c < d) {
        if (r0 < sq) ob[(size_t)r0 * d + c] = o[4 * dt + jj] * inv0;
        if (r1 < sq) ob[(size_t)r1 * d + c] = o[4 * dt + 2 + jj] * inv1;
      }
    }
  }
  if (t == 0) {
    if (r0 < sq) lseb[r0] = m0 + log2f(l0);
    if (r1 < sq) lseb[r1] = m1 + log2f(l1);
  }
}

// heads blockIdx.y * G .. + G - 1 in turn, q rows 64 * blockIdx.x ..
template <int DP>
__global__ void __launch_bounds__(128, DP <= 40 ? 2 : 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
                         float* __restrict__ lse, int bh, int sq, int skv, int d,
                         float logit_scale, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * FwdTiles<DP>::QB +
                                               kStages * FwdTiles<DP>::STAGE);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();
  const int n_kv = (skv + FwdTiles<DP>::N - 1) / FwdTiles<DP>::N;
  for (int i = 0; i < G; ++i) {
    const int head = blockIdx.y * G + i;
    fwd_head<DP>(&qmap, &kmap, &vmap, head, bh, o + (size_t)head * sq * d,
                 lse + (size_t)head * sq, blockIdx.x * 64, sq, skv, d, logit_scale, smem, bars,
                 i * n_kv, i & 1);
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   float* work, long long work_floats, int bh, int sq, int skv, int d,
                   float logit_scale, int G, cudaStream_t st) {
  using T = FwdTiles<DP>;
  const int r8 = (skv + 7) / 8 * 8;
  float* qs = work;                               // (2, bh, sq, DP)
  float* ks = qs + 2LL * bh * sq * DP;            // (2, bh, skv, DP)
  float* vt = ks + 2LL * bh * skv * DP;           // (2, bh, DP, r8)
  if (work_floats < 2LL * bh * DP * (sq + skv + r8)) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaError_t err = dft::split_rows(q, qs, bh, sq, d, DP, st);
  if (err == cudaSuccess) err = dft::split_rows(k, ks, bh, skv, d, DP, st);
  if (err == cudaSuccess) err = dft::split_cols(v, vt, bh, skv, d, DP, st);
  if (err != cudaSuccess) return err;
  CUtensorMap qm{}, km{}, vm{};
  if (!(dft::make_tile_map_f32(&qm, qs, 2 * bh, sq, DP, 64, T::SWQ) &&
        dft::make_tile_map_f32(&km, ks, 2 * bh, skv, DP, T::N, T::SWQ) &&
        dft::make_tile_map_f32(&vm, vt, 2 * bh, DP, r8, DP, T::SWV)))
    return cudaErrorNotSupported;
  const dim3 grid((sq + 63) / 64, bh / G);
  flash_fwd_f32_kernel<DP><<<grid, 128, T::smem(), st>>>(qm, km, vm, o, lse, bh, sq, skv, d,
                                                         logit_scale, G);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k/v (bh, skv, d), o like q, lse (bh, sq): fp32, contiguous,
// 1 <= d <= 160.  work: fp32 scratch of work_floats >= 2 * bh * d_pad * (sq +
// skv + skv rounded up to 8) for the split copies (d_pad: d rounded up to 8
// up to 64, to 16 above).  G heads a CTA, in turn (dividing bh): O and lse
// equal G = 1's bit for bit.  Returns the launches' cudaError_t (0 =
// launched).
extern "C" int dft_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, void* work, long long work_floats, int bh, int sq,
                                 int skv, int d, float scale, int G, void* stream) {
  const float logit_scale = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || bh % G != 0 || sq < 1 || skv < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  float *op = static_cast<float*>(o), *lp = static_cast<float*>(lse),
        *wp = static_cast<float*>(work);
#define DFT_F32_CASE(DP) \
  case DP:               \
    return static_cast<int>(                                                              \
        launch<DP>(qp, kp, vp, op, lp, wp, work_floats, bh, sq, skv, d, logit_scale, G, st))
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
