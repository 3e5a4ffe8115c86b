// Fused LoRA dense for Hopper (sm_90a):
//   y = x W^T + b + scale * (h up^T),   h = round_to_x_dtype(x down^T)
// with W in nn.Linear layout (N, K), up (N, r), down (r, K), scale an fp32
// device scalar, b optional, and fp32 accumulation throughout.
//
// Replaces the JAX package's Pallas TPU kernel
// diffusion_finetuning_tpu/ops/lora_matmul.py:_kernel (:38), reached through
// _fused (:50, pallas_call :56).  As there, h is rounded to x's dtype before
// the up-product (:44) and the order of the sums is base, LoRA term, bias.
// The rank is zero-padded to 16 (one k-chunk) in shared memory, not to the
// TPU's 128 lanes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at M=8192,
// K=N=320 the kernel must move about 10.6 MB (x, W, y), about 3.2 us --
// memory-bound; the GEGLU projection M=8192, K=320, N=2560 is 13.4 GFLOP and
// about 47 MB, about 14 us either way.  Most SD1.5 calls are small (M 77 to
// 512 rows at N = 320..1280): there the bound is a few microseconds, and a
// call lasts about as long as one CTA's short k-loop and epilogue.
//
// Design.  A CTA computes a BM x BN tile of y (64 x 64, 64 x 128 or 128 x
// 128: one or two consumer warpgroups of 64 rows), K in steps of 64 (one
// 128-byte swizzled slab, csrc/wgmma.cuh's layout):
//   * one producer warp keeps a ring of 4 stages full by TMA: the x tile
//     (BM x 64), the W tile (BN x 64) and the down tile (16 x 64: rows past
//     r arrive as zeros, so the rank pad costs no memory); rows past M and N
//     and columns past K are zero-filled too.  A stage is refilled once every
//     consumer thread has arrived on its `empty` barrier;
//   * each consumer warpgroup runs the base product x W^T (wgmma m64nBNk16)
//     and h = x down^T (wgmma m64n16k16) on the same x tile in the same
//     k-loop, so x is read once per N tile; one k-step's products stay in
//     flight while the next step's are issued;
//   * ops/lora_matmul.py:plan picks the largest tile whose grid fills the
//     card; where even 64 x 64 tiles fill under half of it, a third grid
//     dimension splits the k-loop (only there: a split's partials cost more
//     than the 77- and 154-row calls' whole k-loop, measured on the card).
//     Each split stores its fp32 base and h accumulators; the last CTA of a
//     tile to arrive sums them in split order (deterministic, one launch,
//     csrc/wgmma.cuh:last_to_arrive).  h is summed in fp32 before its one
//     rounding, so a split computes the same function as the whole loop;
//   * the epilogue rounds h to bf16 as an mma.sync A fragment (a warp's
//     wgmma accumulator is the mma.sync layout repeated), multiplies it by
//     the up tile (mma.sync m16n8k16, up held in shared memory), and stores
//     base + scale * lora + bias, rounded once, as bf16 pairs.
// fp32 inputs take a plain FMA kernel (lora_dense_f32_kernel) with the same
// math, unsplit.
#include "wgmma.cuh"

namespace {

constexpr int kBK = 64;     // k a stage: one 128-byte swizzled slab
constexpr int kSW = 128;    // swizzle bytes of every TMA tile
constexpr int kR = 16;      // padded rank: one k-chunk
constexpr int kLDU = kR + 8;  // shared row stride of the up tile (elements)
constexpr int kStages = 4;

template <int NWG, int BN>
struct Tile {
  static constexpr int BM = NWG * 64;
  static constexpr int NC = NWG * 128;            // consumer threads
  static constexpr int THREADS = NC + 32;         // and one producer warp
  static constexpr int A = BM * kBK, B = BN * kBK, D = kR * kBK;  // elements a stage
  static constexpr int STAGE = A + B + D;
  static constexpr int NA = BN / 2;               // base accumulator floats a thread
  static constexpr int PART = NC * (NA + 8);      // floats of a split's partial
  static constexpr size_t smem() {
    return 1024 + 2 * ((size_t)kStages * STAGE + BN * kLDU) + 8 * 2 * kStages + 16;
  }
};

template <int NWG, int BN>
__global__ void __launch_bounds__(Tile<NWG, BN>::THREADS)
    lora_dense_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const __nv_bfloat16* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ up,
                           const float* __restrict__ scale_ptr, __nv_bfloat16* __restrict__ y,
                           float* __restrict__ part, int* __restrict__ counters, int M, int N,
                           int K, int r, int splits) {
  using T = Tile<NWG, BN>;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(  // 1024-byte aligned stages
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* Us = ring + kStages * T::STAGE;  // BN x kLDU
  uint64_t* full = reinterpret_cast<uint64_t*>(Us + BN * kLDU);
  uint64_t* empty = full + kStages;
  int* flag = reinterpret_cast<int*>(empty + kStages);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int nk = (K + kBK - 1) / kBK;
  const int k0 = (int)((long long)split * nk / splits);
  const int k1 = (int)((long long)(split + 1) * nk / splits);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      dft::mbar_init(&full[i], 1);
      dft::mbar_init(&empty[i], T::NC);
    }
    dft::mbar_init_fence();
  }
  // the up tile (BN x r, zero-padded to kR columns), read in the epilogue
  for (int i = tid; i < BN * kR; i += T::THREADS) {
    const int n = i / kR, j = i % kR;
    Us[n * kLDU + j] =
        (n0 + n < N && j < r) ? up[(size_t)(n0 + n) * r + j] : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[T::NA], hacc[8];
#pragma unroll
  for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) hacc[i] = 0.f;

  if (tid >= T::NC) {  // the producer warp: one thread starts every copy
    if (tid == T::NC) {
      for (int ks = k0; ks < k1; ++ks) {
        const int i = ks - k0, s = i % kStages;
        if (i >= kStages) dft::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        __nv_bfloat16* st = ring + s * T::STAGE;
        dft::mbar_expect_tx(&full[s], T::STAGE * 2);
        dft::tma_load_slab(st, &xmap, ks * kBK, m0, 0, &full[s]);
        dft::tma_load_slab(st + T::A, &wmap, ks * kBK, n0, 0, &full[s]);
        dft::tma_load_slab(st + T::A + T::B, &dmap, ks * kBK, 0, 0, &full[s]);
      }
    }
  } else {
    const int wg = tid >> 7;
    for (int ks = k0; ks < k1; ++ks) {
      const int i = ks - k0, s = i % kStages;
      dft::mbar_wait(&full[s], (i / kStages) & 1);
      const __nv_bfloat16* st = ring + s * T::STAGE;
      const __nv_bfloat16* As = st + wg * 64 * kBK;
      dft::fence_operands(acc);
      dft::fence_operands(hacc);
      dft::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        dft::wgmma_ss<0, 0>(acc, dft::desc_kmajor<64, kSW>(As, kc),
                            dft::desc_kmajor<BN, kSW>(st + T::A, kc), 1);
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        dft::wgmma_ss<0, 0>(hacc, dft::desc_kmajor<64, kSW>(As, kc),
                            dft::desc_kmajor<kR, kSW>(st + T::A + T::B, kc), 1);
      dft::wgmma_commit();
      dft::wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (i > 0) dft::mbar_arrive(&empty[(i - 1) % kStages]);
    }
    dft::wgmma_wait<0>();
    dft::fence_operands(acc);
    dft::fence_operands(hacc);
  }

  if (splits > 1) {
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * T::PART;
    if (tid < T::NC) {
      float* mine = part + split * split_stride + tile * T::PART;
      dft::part_store(mine, acc, tid, T::NC);
      dft::part_store(mine + T::NC * T::NA, hacc, tid, T::NC);
    }
    if (!dft::last_to_arrive(counters + tile, splits, flag)) return;
    if (tid < T::NC) {
#pragma unroll
      for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) hacc[i] = 0.f;
      const float* p = part + tile * T::PART;
      for (int sp = 0; sp < splits; ++sp, p += split_stride) {
        dft::part_add(acc, p, tid, T::NC);
        dft::part_add(hacc, p + T::NC * T::NA, tid, T::NC);
      }
    }
  }
  if (tid >= T::NC) return;

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale = *scale_ptr;
  // h rounded to bf16: rows 16*warp + g (+8) of this warpgroup, as the A
  // fragment of the up-product (k = the padded rank)
  uint32_t ha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ha[i] = dft::pack_bf16(hacc[2 * i], hacc[2 * i + 1]);
  const int row0 = m0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
  const bool pairs = (N & 1) == 0;  // bf16 pairs 4-byte aligned
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const __nv_bfloat16* p = Us + (nt * 8 + g) * kLDU + 2 * t;
    float lo[4] = {0.f, 0.f, 0.f, 0.f};
    dft::mma_bf16(lo, ha, dft::ld_u32(p), dft::ld_u32(p + 8));
    const int n = n0 + nt * 8 + 2 * t;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float b0 = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = bias != nullptr && two ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= M) continue;
      const float v0 = acc[4 * nt + 2 * half] + scale * lo[2 * half] + b0;
      const float v1 = acc[4 * nt + 2 * half + 1] + scale * lo[2 * half + 1] + b1;
      __nv_bfloat16* dst = y + (size_t)row * N + n;
      if (two && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        if (two) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int NWG, int BN>
cudaError_t launch_bf16(const void* x, const void* w, const void* bias, const void* up,
                        const void* down, const float* scale, void* y, float* part,
                        int* counters, int M, int N, int K, int r, int splits,
                        cudaStream_t stream) {
  using T = Tile<NWG, BN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(lora_dense_bf16_kernel<NWG, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap xm{}, wm{}, dm{};
  if (!(dft::make_tile_map(&xm, x, 1, M, K, T::BM, kSW) &&
        dft::make_tile_map(&wm, w, 1, N, K, BN, kSW) &&
        dft::make_tile_map(&dm, down, 1, r, K, kR, kSW)))
    return cudaErrorNotSupported;
  const dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, splits);
  lora_dense_bf16_kernel<NWG, BN><<<grid, T::THREADS, T::smem(), stream>>>(
      xm, wm, dm, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(up), scale, static_cast<__nv_bfloat16*>(y), part,
      counters, M, N, K, r, splits);
  return cudaGetLastError();
}

// fp32 inputs: plain FMA, 64x64 tiles, 4x4 outputs per thread.
constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    lora_dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ up,
                          const float* __restrict__ down, const float* __restrict__ scale_ptr,
                          float* __restrict__ y, int M, int N, int K, int r) {
  __shared__ float Xs[kFK][kFM + 1];
  __shared__ float Ws[kFK][kFN + 1];
  __shared__ float Hs[kFM][kR + 1];
  __shared__ float Us[kFN][kR + 1];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // h = x down^T for this tile's rows, and the up tile
  for (int i = tid; i < kFM * kR; i += kFThreads) {
    const int row = i / kR, j = i % kR;
    float a = 0.f;
    if (m0 + row < M && j < r)
      for (int kk = 0; kk < K; ++kk)
        a = fmaf(x[(size_t)(m0 + row) * K + kk], down[(size_t)j * K + kk], a);
    Hs[row][j] = a;
  }
  for (int i = tid; i < kFN * kR; i += kFThreads) {
    const int n = i / kR, j = i % kR;
    Us[n][j] = (n0 + n < N && j < r) ? up[(size_t)(n0 + n) * r + j] : 0.f;
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
    for (int i = tid; i < kFK * kFM; i += kFThreads) {
      const int row = i / kFK, kk = i % kFK;
      Xs[kk][row] = (m0 + row < M && k0 + kk < K) ? x[(size_t)(m0 + row) * K + k0 + kk] : 0.f;
      Ws[kk][row] = (n0 + row < N && k0 + kk < K) ? w[(size_t)(n0 + row) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Xs[kk][ty * 4 + i];
        b[i] = Ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
  const float scale = *scale_ptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (m0 + row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      if (n0 + col >= N) continue;
      float lo = 0.f;
      for (int q = 0; q < kR; ++q) lo = fmaf(Hs[row][q], Us[col][q], lo);
      const float b = bias != nullptr ? bias[n0 + col] : 0.f;
      y[(size_t)(m0 + row) * N + n0 + col] = acc[i][j] + scale * lo + b;
    }
  }
}

}  // namespace

// x (M, K), w (N, K), bias (N) or NULL, up (N, r), down (r, K), scale one
// fp32 value on the device, y (M, N); all contiguous, 1 <= r <= 16.
// dtype: 0 = fp32 (plain FMA kernel; bm, bn, splits ignored), 1 = bf16 (K a
// multiple of 8): (bm, bn) in {(64, 64), (64, 128), (128, 128)} rows and
// columns a CTA (ops/lora_matmul.py:TILES), splits CTAs
// along K (1 .. ceil(K/64)).  With splits > 1, part is fp32 scratch of
// splits * ceil(M/bm) * ceil(N/bn) * bm * (bn + 16) floats and counters
// ceil(M/bm) * ceil(N/bn) ints, zero on entry and left zero on exit.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int dft_lora_dense(const void* x, const void* w, const void* bias, const void* up,
                              const void* down, const void* scale, void* y, void* part,
                              void* counters, int M, int N, int K, int r, int dtype, int bm,
                              int bn, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > kR || M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const int nk = (K + kBK - 1) / kBK;
    if (K % 8 != 0 || splits < 1 || splits > nk ||
        (splits > 1 && (part == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    float* p = static_cast<float*>(part);
    int* c = static_cast<int*>(counters);
    const float* s = static_cast<const float*>(scale);
#define DFT_LORA_CASE(NWG, BN)                                                                \
  if (bm == NWG * 64 && bn == BN)                                                             \
    return static_cast<int>(                                                                  \
        launch_bf16<NWG, BN>(x, w, bias, up, down, s, y, p, c, M, N, K, r, splits, st));
    DFT_LORA_CASE(1, 64)
    DFT_LORA_CASE(1, 128)
    DFT_LORA_CASE(2, 128)
#undef DFT_LORA_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    lora_dense_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(up),
        static_cast<const float*>(down), static_cast<const float*>(scale),
        static_cast<float*>(y), M, N, K, r);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
