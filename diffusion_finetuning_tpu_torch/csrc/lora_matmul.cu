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
//
// fp32 inputs (the trainers' default precision and fp32 pipes) take
// lora_dense_tf32_kernel, the same structure on the split product of
// csrc/split_f32.cuh (fp32 values as big + small TF32 halves, three
// tensor-core products a product, a third of 494.7 TFLOP/s dense TF32):
//   * one prep launch (split_rows3) writes x and down as [big; small]
//     copies, K zero-padded to 8, so that they come by TMA whatever K is;
//     W too where many CTAs along M read each W tile, while where at most 4
//     do (the text projections, M <= 256) W arrives as it lies and the
//     consumers split each stage's W tile in shared memory, the next one
//     while this one's products run (ops/lora_matmul.py:f32_w_in_smem, by
//     shape: measured, each route is the faster where it is taken).  No
//     split copy is kept per weight: a merged fp32 pipe rewrites W, and at
//     SD1.5 the copies would hold about 1.5 GB;
//   * a stage is 32 fp32 of k, one 128-byte slab per half; B is the W tile
//     with down's 16 rows below it, so one wgmma m64n{BN+16}k8 a product
//     gives the base product and h (the accumulator's last 16 columns):
//     small*big + big*small + big*big per k-chunk.  The ring holds 3 stages
//     of a 128 x 128 tile (68 KB a stage) or 4 of the others;
//   * each stage's products go into a fresh accumulator that FADD adds to
//     the running sums: the tensor cores' fp32 sums are not rounded to
//     nearest, and over a whole k-loop their error would grow past the fp32
//     gate (PERF.md);
//   * ops/lora_matmul.py:plan_f32 takes the largest tile whose grid fills
//     half the card (a CTA of the split product is three times a bf16 one's
//     work: fewer, larger CTAs measured faster than a full wave of small
//     ones), and splits the k-loop of the 77- to 154-row calls to half a
//     wave; the last CTA sums the partials in split order;
//   * the epilogue keeps h in fp32 (JAX's rounding to x's dtype is a no-op
//     there), gathers a row's 16 rank values from its quad by shuffles,
//     forms h up^T by FMA over the rank, and stores base + scale * lora +
//     bias as fp32 pairs.
// Bound on an H100 SXM: the SD1.5 CFG UNet step's 144 calls carry 364.1
// GFLOP, 2.21 ms on the split product; the operands move 8 bytes a value
// from the split copies (4 for a W split in shared memory).
#include "split_f32.cuh"

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

// --- fp32 inputs: the split product (csrc/split_f32.cuh) on tf32 wgmma ---

constexpr int kFK = 32;  // k a stage: 32 fp32 values, one 128-byte swizzled slab

template <int NWG, int BN>
struct TileF32 {
  static constexpr int BM = NWG * 64;
  static constexpr int NC = NWG * 128;      // consumer threads
  static constexpr int THREADS = NC + 32;   // and one producer warp
  static constexpr int BR = BN + kR;        // B's rows: the W tile, then down's 16
  static constexpr int XH = BM * kFK, BH = BR * kFK;  // floats of one half tile
  static constexpr int STAGE = 2 * (XH + BH);         // [big; small] of x and of B
  static constexpr int STAGES = NWG == 2 ? 3 : 4;     // as many as 227 KB hold
  static constexpr int NA = BR / 2;   // accumulator floats a thread: base, then h's 8
  static constexpr int PART = NC * NA;  // floats of a split's partial
  static constexpr size_t smem() {
    return 1024 + 4 * ((size_t)STAGES * STAGE + kR * BN) + 8 * 2 * STAGES + 16;
  }
};

// The base product and h in one wgmma a product: B is the W tile with
// down's 16 rows below it (m64n{BN+16}k8), so the accumulator's columns
// past BN are h.  WS: W arrives as fp32 (one TMA slab a stage, from W
// itself) and the consumers split it in shared memory, the next stage's W
// while this stage's products run; else W comes split from the prep pass
// like x and down.
template <int NWG, int BN, bool WS>
__global__ void __launch_bounds__(TileF32<NWG, BN>::THREADS)
    lora_dense_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const float* __restrict__ bias, const float* __restrict__ up,
                           const float* __restrict__ scale_ptr, float* __restrict__ y,
                           float* __restrict__ part, int* __restrict__ counters, int M, int N,
                           int K, int r, int splits) {
  using T = TileF32<NWG, BN>;
  constexpr int NB = BN / 2;  // base accumulator floats a thread; h follows
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  float* ring = reinterpret_cast<float*>(  // 1024-byte aligned stages
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  float* Ut = ring + T::STAGES * T::STAGE;  // kR x BN: up transposed
  uint64_t* full = reinterpret_cast<uint64_t*>(Ut + kR * BN);
  uint64_t* empty = full + T::STAGES;
  int* flag = reinterpret_cast<int*>(empty + T::STAGES);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int nk = (K + kFK - 1) / kFK;
  const int k0 = (int)((long long)split * nk / splits);
  const int k1 = (int)((long long)(split + 1) * nk / splits);

  if (tid == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      dft::mbar_init(&full[i], 1);
      dft::mbar_init(&empty[i], T::NC);
    }
    dft::mbar_init_fence();
  }
  // the up tile, transposed (rank x BN), zero past r and N: read in the epilogue
  for (int i = tid; i < kR * BN; i += T::THREADS) {
    const int j = i / BN, n = i % BN;
    Ut[i] = (n0 + n < N && j < r) ? up[(size_t)(n0 + n) * r + j] : 0.f;
  }
  __syncthreads();

  float acc[T::NA];
#pragma unroll
  for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;

  if (tid >= T::NC) {  // the producer warp: one thread starts every copy
    if (tid == T::NC) {
      for (int ks = k0; ks < k1; ++ks) {
        const int i = ks - k0, s = i % T::STAGES;
        if (i >= T::STAGES) dft::mbar_wait(&empty[s], (i / T::STAGES - 1) & 1);
        float* st = ring + s * T::STAGE;
        dft::mbar_expect_tx(&full[s], (T::STAGE - (WS ? BN * kFK : 0)) * 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the big halves, then the small ones
          float* b = st + 2 * T::XH + h * T::BH;
          dft::tma_load_slab(st + h * T::XH, &xmap, ks * kFK, m0, h, &full[s]);
          if (!WS || h == 0) dft::tma_load_slab(b, &wmap, ks * kFK, n0, h, &full[s]);
          dft::tma_load_slab(b + BN * kFK, &dmap, ks * kFK, 0, h, &full[s]);
        }
      }
    }
  } else {
    const int wg = tid >> 7;
    // WS: stage s's fp32 W tile into [big; small] in place, all consumers
    // sharing the work; visible to wgmma after the named barrier below
    auto split_w = [&](int s) {
      float4* wb = reinterpret_cast<float4*>(ring + s * T::STAGE + 2 * T::XH);
      float4* ws = wb + T::BH / 4;
#pragma unroll
      for (int e = tid; e < BN * kFK / 4; e += T::NC) {
        const float4 v = wb[e];
        const float4 b = make_float4(dft::tf32_rna(v.x), dft::tf32_rna(v.y), dft::tf32_rna(v.z),
                                     dft::tf32_rna(v.w));
        wb[e] = b;
        ws[e] = make_float4(dft::tf32_rna(v.x - b.x), dft::tf32_rna(v.y - b.y),
                            dft::tf32_rna(v.z - b.z), dft::tf32_rna(v.w - b.w));
      }
      dft::fence_proxy_async();
    };
    if (WS && k0 < k1) {
      dft::mbar_wait(&full[0], 0);
      split_w(0);
      dft::bar_sync(1, T::NC);
    }
    float sacc[T::NA];  // one stage's products: fresh, then added by FADD
    for (int ks = k0; ks < k1; ++ks) {
      const int i = ks - k0, s = i % T::STAGES;
      if (!WS) dft::mbar_wait(&full[s], (i / T::STAGES) & 1);
      const float* st = ring + s * T::STAGE;
      const float *xb = st + wg * 64 * kFK, *xs = xb + T::XH;
      const float *bb = st + 2 * T::XH, *bs = bb + T::BH;
      dft::fence_operands(sacc);
      dft::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kFK / 8; ++kc) {
        const uint64_t ab = dft::desc_f32<64, kSW>(xb, kc);
        dft::wgmma_tf32_ss(sacc, dft::desc_f32<64, kSW>(xs, kc),
                           dft::desc_f32<T::BR, kSW>(bb, kc), kc > 0);
        dft::wgmma_tf32_ss(sacc, ab, dft::desc_f32<T::BR, kSW>(bs, kc), 1);
        dft::wgmma_tf32_ss(sacc, ab, dft::desc_f32<T::BR, kSW>(bb, kc), 1);
      }
      dft::wgmma_commit();
      const bool next = WS && ks + 1 < k1;
      if (next) {  // the next stage's W, split while this stage's products run
        dft::mbar_wait(&full[(i + 1) % T::STAGES], ((i + 1) / T::STAGES) & 1);
        split_w((i + 1) % T::STAGES);
      }
      dft::wgmma_wait<0>();
      dft::fence_operands(sacc);
      dft::mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < T::NA; ++j) acc[j] += sacc[j];
      if (next) dft::bar_sync(1, T::NC);
    }
  }

  if (splits > 1) {
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * T::PART;
    if (tid < T::NC) dft::part_store(part + split * split_stride + tile * T::PART, acc, tid, T::NC);
    if (!dft::last_to_arrive(counters + tile, splits, flag)) return;
    if (tid < T::NC) {
#pragma unroll
      for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;
      const float* p = part + tile * T::PART;
      for (int sp = 0; sp < splits; ++sp, p += split_stride) dft::part_add(acc, p, tid, T::NC);
    }
  }
  if (tid >= T::NC) return;

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale = *scale_ptr;
  // h in fp32, rows g and g + 8 of this warp: all kR rank columns, gathered
  // from the quad (thread t holds h's columns 2t, 2t + 1, 8 + 2t, 9 + 2t)
  float h0[kR], h1[kR];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int src = (lane & ~3) | q;
    h0[2 * q] = __shfl_sync(0xffffffffu, acc[NB + 0], src);
    h0[2 * q + 1] = __shfl_sync(0xffffffffu, acc[NB + 1], src);
    h0[8 + 2 * q] = __shfl_sync(0xffffffffu, acc[NB + 4], src);
    h0[9 + 2 * q] = __shfl_sync(0xffffffffu, acc[NB + 5], src);
    h1[2 * q] = __shfl_sync(0xffffffffu, acc[NB + 2], src);
    h1[2 * q + 1] = __shfl_sync(0xffffffffu, acc[NB + 3], src);
    h1[8 + 2 * q] = __shfl_sync(0xffffffffu, acc[NB + 6], src);
    h1[9 + 2 * q] = __shfl_sync(0xffffffffu, acc[NB + 7], src);
  }
  const int row0 = m0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
  const bool pairs = (N & 1) == 0;  // fp32 pairs 8-byte aligned
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int c = nt * 8 + 2 * t, n = n0 + c;
    if (n >= N) continue;
    // lo = h up^T by FMA in fp32, the rank in order
    float lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < r) {
        const float2 u = *reinterpret_cast<const float2*>(Ut + j * BN + c);
        lo[0] = fmaf(h0[j], u.x, lo[0]);
        lo[1] = fmaf(h0[j], u.y, lo[1]);
        lo[2] = fmaf(h1[j], u.x, lo[2]);
        lo[3] = fmaf(h1[j], u.y, lo[3]);
      }
    }
    const bool two = n + 1 < N;
    const float b0 = bias != nullptr ? bias[n] : 0.f;
    const float b1 = bias != nullptr && two ? bias[n + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= M) continue;
      const float v0 = acc[4 * nt + 2 * half] + scale * lo[2 * half] + b0;
      const float v1 = acc[4 * nt + 2 * half + 1] + scale * lo[2 * half + 1] + b1;
      float* dst = y + (size_t)row * N + n;
      if (two && pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (two) dst[1] = v1;
      }
    }
  }
}

template <int NWG, int BN, bool WS>
cudaError_t launch_f32(const float* x, const float* w, const float* bias, const float* up,
                       const float* down, const float* scale, float* y, float* work, float* part,
                       int* counters, int M, int N, int K, int r, int splits,
                       cudaStream_t stream) {
  using T = TileF32<NWG, BN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(lora_dense_tf32_kernel<NWG, BN, WS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int kp = (K + 7) / 8 * 8;
  float* xs = work;                       // (2, M, kp)
  float* ds = xs + 2LL * M * kp;          // (2, r, kp)
  float* ws = ds + 2LL * r * kp;          // (2, N, kp), without WS
  cudaError_t err = dft::split_rows3(x, xs, M, down, ds, r, w, ws, WS ? 0 : N, K, kp, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap xm{}, wm{}, dm{};
  if (!(dft::make_tile_map_f32(&xm, xs, 2, M, kp, T::BM, kSW) &&
        (WS ? dft::make_tile_map_f32(&wm, w, 1, N, K, BN, kSW)
            : dft::make_tile_map_f32(&wm, ws, 2, N, kp, BN, kSW)) &&
        dft::make_tile_map_f32(&dm, ds, 2, r, kp, kR, kSW)))
    return cudaErrorNotSupported;
  const dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, splits);
  lora_dense_tf32_kernel<NWG, BN, WS><<<grid, T::THREADS, T::smem(), stream>>>(
      xm, wm, dm, bias, up, scale, y, part, counters, M, N, K, r, splits);
  return cudaGetLastError();
}

}  // namespace

// bf16 x (M, K), w (N, K), bias (N) or NULL, up (N, r), down (r, K), scale
// one fp32 value on the device, y (M, N); all contiguous, 1 <= r <= 16, K a
// multiple of 8.  (bm, bn) in {(64, 64), (64, 128), (128, 128)} rows and
// columns a CTA (ops/lora_matmul.py:TILES), splits CTAs along K (1 ..
// ceil(K/64)).  With splits > 1, part is fp32 scratch of splits *
// ceil(M/bm) * ceil(N/bn) * bm * (bn + 16) floats and counters ceil(M/bm) *
// ceil(N/bn) ints, zero on entry and left zero on exit.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int dft_lora_dense(const void* x, const void* w, const void* bias, const void* up,
                              const void* down, const void* scale, void* y, void* part,
                              void* counters, int M, int N, int K, int r, int bm, int bn,
                              int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = (K + kBK - 1) / kBK;
  if (r < 1 || r > kR || M < 1 || N < 1 || K < 1 || K % 8 != 0 || splits < 1 || splits > nk ||
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

// The same on fp32 operands, any K >= 1: the split product on tf32 wgmma.
// (bm, bn) as above, splits CTAs along K (1 .. ceil(K/32)); w_split 1 splits
// W in shared memory (K a multiple of 4: W's rows are read by TMA as they
// lie), 0 through the prep pass.  work is fp32 scratch of work_floats >= 2 *
// kp * (M + r + (w_split ? 0 : N)) floats (kp: K rounded up to 8) for the
// split copies; part and counters as above.  Returns the launches'
// cudaError_t (0 = launched).
extern "C" int dft_lora_dense_f32(const void* x, const void* w, const void* bias, const void* up,
                                  const void* down, const void* scale, void* y, void* work,
                                  long long work_floats, void* part, void* counters, int M,
                                  int N, int K, int r, int bm, int bn, int splits, int w_split,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = (K + kFK - 1) / kFK;
  const long long kp = (K + 7) / 8 * 8;
  if (r < 1 || r > kR || M < 1 || N < 1 || K < 1 || splits < 1 || splits > nk ||
      (w_split != 0 && (w_split != 1 || K % 4 != 0)) || work == nullptr ||
      work_floats < 2 * kp * ((long long)M + r + (w_split ? 0 : N)) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *xp = static_cast<const float*>(x), *wp = static_cast<const float*>(w),
              *bp = static_cast<const float*>(bias), *upp = static_cast<const float*>(up),
              *dp = static_cast<const float*>(down), *sp = static_cast<const float*>(scale);
  float *yp = static_cast<float*>(y), *wk = static_cast<float*>(work),
        *pp = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
#define DFT_LORA_F32_CASE(NWG, BN, WS)                                                   \
  if (bm == NWG * 64 && bn == BN && w_split == WS)                                       \
    return static_cast<int>(launch_f32<NWG, BN, WS>(xp, wp, bp, upp, dp, sp, yp, wk, pp, \
                                                    c, M, N, K, r, splits, st));
  DFT_LORA_F32_CASE(1, 64, 0)
  DFT_LORA_F32_CASE(1, 128, 0)
  DFT_LORA_F32_CASE(2, 128, 0)
  DFT_LORA_F32_CASE(1, 64, 1)
  DFT_LORA_F32_CASE(1, 128, 1)
  DFT_LORA_F32_CASE(2, 128, 1)
#undef DFT_LORA_F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
