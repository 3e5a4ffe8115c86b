// Stride-1, same-padded 3x3 convolution for Hopper (sm_90a):
//   y[b, o, h, w] = bias[o] + sum_{c, kh, kw} x[b, c, h + kh - 1, w + kw - 1] * wt[o, c, kh, kw]
// with x NCHW, wt OIHW (PyTorch's layouts), y NCHW, taps outside the image
// reading zero, fp32 accumulation and one rounding at the end.
//
// Replaces the JAX package's Pallas TPU kernel
// diffusion_finetuning_tpu/ops/conv_pallas.py:_kernel (:72), reached through
// _conv3x3_fwd (:95, pallas_call :119).  Same function: the 9 tap products
// accumulate in fp32 and the bias joins before the one rounding.  The TPU
// wrapper stacks nine shifted copies of the padded input (x9, :111-114) so
// that Mosaic sees tile-aligned 2D blocks; this kernel never builds that
// stack, nor a padded or channels-last copy of x: it reads x where it lies.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2*B*H*W*C*O*9
// operations against x + wt + y bytes.  The SD1.5 UNet's routed convs are
// operation-bound: at B=2, 64x64, 320 -> 320 it is 15.1 GFLOP (15.3 us)
// against 10.5 MB (3.1 us); the 37 routed convs of one CFG step at 512^2
// carry about 0.50 TFLOP, about 0.51 ms.
//
// Design (conv3x3_wgmma_kernel, bf16, W a multiple of 8 up to 128): an
// implicit GEMM with the roles chosen for NCHW, M = output channels, N =
// pixels, K = 9 taps x C, so that a row of the accumulator is a run of one
// output channel's pixels:
//   * A, the weights, by TMA from the tap-major copy w9 (9, O, C) that the
//     wrapper keeps (ops/conv3x3.py:tap_major; OIHW keeps a tap's channels
//     18 bytes apart, which no tensor map can stride): a (BM x 64 channels)
//     128-byte swizzled K-major tile of one tap;
//   * B, the pixels, by TMA straight from NCHW x through a 4-D map over
//     (W, H, C, B) (csrc/wgmma.cuh:make_nchw_map): a box of P pixels of one
//     image row x 64 channels lands as one slab of wgmma's MN-major layout
//     with a swizzle of 2P bytes (P = 64, 32 or 16 pixels for W = 64, 32,
//     16; at W = 8 the 16-pixel box is half zeros, and above 64 a row takes
//     two boxes), 128/P boxes a k-step.  The tap's row shift dy is the
//     box's start row, and TMA zero-fills rows outside the image, so the
//     halo needs no padded copy and no predicate.  The column shift dx
//     cannot be a start coordinate (TMA starts the innermost dimension only
//     on whole 16 bytes), so every box starts at column 0 and the k-loop
//     runs in three phases, dx = +1, 0, -1, whose products are shifted by a
//     column in the accumulator between and after them (warp shuffles,
//     see the kernel);
//   * a CTA holds one consumer warpgroup (64 output channels) over 128
//     pixels (whole image rows of one image), and one producer warp keeps
//     a ring of 4 stages in flight; wgmma m64n128k16,
//     one k-step's products in flight while the next are issued;
//   * where the grid cannot fill the card (the 16x16 and 8x8 levels, K up to
//     11,520 over 20-80 tiles), the k-loop is split over a third grid
//     dimension and the last CTA of a tile sums the fp32 partials in split
//     order (deterministic, one launch); ops/conv3x3.py:plan picks the tile
//     and the splits;
//   * the epilogue adds the bias, rounds once and stores bf16 pairs along
//     the pixel runs of NCHW y.
// conv3x3_bf16_kernel (the first design: mma.sync, pixels gathered by
// predicated element loads from NCHW, the OIHW weight read as it lies) takes
// the bf16 shapes whose rows TMA cannot stride: W not a multiple of 8, or
// above 128 -- chosen by shape, never after a failure.
//
// fp32 inputs (conv3x3_tf32_kernel, every shape) take the same roles on the
// split product of csrc/split_f32.cuh (big + small TF32 halves, three
// tensor-core products a product).  tf32 wgmma has no transpose bit, so
// both operands are K-major:
//   * a prep pass writes x as NHWC [big; small] (split_nhwc, channels
//     zero-padded to cp, a multiple of 8), read through a 4-D map over (cp,
//     W, H, 2B): a box of 32 channels x box pixels x 128/box image rows lands
//     as a K-major (128 pixels x 32 k) tile.  Channels are innermost, so
//     both tap shifts are box start coordinates (W + dx, H + dy) and TMA
//     zero-fills the halo and the columns past W: no column phases and no
//     accumulator shuffles, and any W (box 8, 16, 32, 64 or 128 pixels, a
//     row over several tiles past 128);
//   * the weight comes from a split tap-major copy (2, 9, O, cp), cached per
//     weight as the bf16 copy is (ops/conv3x3.py:tap_major_split);
//   * a stage is one tap and 32 channels (48 KB with both halves, 4
//     stages); each stage's products go into a fresh accumulator that FADD
//     adds to the running sum (the tensor cores' sums are not rounded to
//     nearest);
//   * the k-loop (9 taps x ceil(cp / 32)) splits into the runs that best
//     fill whole waves (ops/conv3x3.py:plan_f32: 2 or 3 at SD1.5's convs,
//     measured), the last CTA summing in split order; the epilogue adds the
//     bias and stores fp32 pairs along the pixel runs.
// Bound: the SD1.5 UNet's 17 fp32-routed convs of a CFG step at 512^2 carry
// 271.8 GFLOP, 1.65 ms on the split product.
#include "split_f32.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kLDK = kBK + 8;  // shared row stride (elements): conflict-free fragment loads
constexpr int kAK = kBK * kBM / kThreads;  // k values of one A step per thread (16)

constexpr size_t bf16_smem_bytes() { return sizeof(__nv_bfloat16) * 2 * (kBM + kBN) * kLDK; }

__global__ void __launch_bounds__(kThreads)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                        int B, int C, int H, int W, int O) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kBM][kLDK]
  __nv_bfloat16* Bs = As + 2 * kBM * kLDK;                          // [2][kBN][kLDK]

  const int HW = H * W, M = B * HW, K = 9 * C;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows wm*32.., cols wn*64..

  // this thread's A pixel and k slice
  const int am = tid % kBM, ak = (tid / kBM) * kAK;
  const int pm = m0 + am;
  const bool pvalid = pm < M;
  const int pb = pvalid ? pm / HW : 0, prem = pvalid ? pm % HW : 0;
  const int ph = prem / W, pw = prem % W;
  const __nv_bfloat16* xb = x + (size_t)pb * C * HW;

  uint32_t areg[kAK / 2];  // the next A step, two bf16 per register
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAK / 2; ++i) {
      uint16_t v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + ak + 2 * i + j;
        const int c = k / 9, tap = k - 9 * c;
        const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
        const bool ok = pvalid && k < K && hh >= 0 && hh < H && ww >= 0 && ww < W;
        v[j] = ok ? __bfloat16_as_ushort(xb[(size_t)c * HW + hh * W + ww]) : (uint16_t)0;
      }
      areg[i] = (uint32_t)v[0] | ((uint32_t)v[1] << 16);
    }
  };
  auto store_a = [&](int stage) {
    uint4* dst = reinterpret_cast<uint4*>(As + stage * kBM * kLDK + am * kLDK + ak);
    dst[0] = make_uint4(areg[0], areg[1], areg[2], areg[3]);
    dst[1] = make_uint4(areg[4], areg[5], areg[6], areg[7]);
  };
  auto load_b = [&](int stage, int k0) {
    __nv_bfloat16* bs = Bs + stage * kBN * kLDK;
    constexpr int CH = kBK / 8;  // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < kBN * CH; c += kThreads) {
      const int row = c / CH, col = (c % CH) * 8;
      const bool ok = n0 + row < O && k0 + col < K;
      dft::cp_async16(bs + row * kLDK + col, ok ? wt + (size_t)(n0 + row) * K + k0 + col : wt,
                      ok ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_a(0);
  load_b(0, 0);
  dft::cp_async_commit();
  store_a(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a((kt + 1) * kBK);  // in flight while this step computes
      load_b(cur ^ 1, (kt + 1) * kBK);
      dft::cp_async_commit();
      dft::cp_async_wait<1>();
    } else {
      dft::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As + cur * kBM * kLDK + (wm * 32) * kLDK;
    const __nv_bfloat16* bs = Bs + cur * kBN * kLDK + (wn * 64) * kLDK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = as + (mt * 16 + g) * kLDK + kk + 2 * t;
        af[mt][0] = dft::ld_u32(p);
        af[mt][1] = dft::ld_u32(p + 8 * kLDK);
        af[mt][2] = dft::ld_u32(p + 8);
        af[mt][3] = dft::ld_u32(p + 8 * kLDK + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* p = bs + (nt * 8 + g) * kLDK + kk + 2 * t;
        const uint32_t b0 = dft::ld_u32(p), b1 = dft::ld_u32(p + 8);
        dft::mma_bf16(acc[0][nt], af[0], b0, b1);
        dft::mma_bf16(acc[1][nt], af[1], b0, b1);
      }
    }
    // the other stage was last read in the previous step, which every warp
    // has left (the __syncthreads above)
    if (more) store_a(cur ^ 1);
    __syncthreads();  // this stage is refilled by the next step's loads
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      const int b = m / HW, rem = m % HW;
      __nv_bfloat16* yb = y + (size_t)b * O * HW + rem;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 64 + nt * 8 + 2 * t + j;
          if (n >= O) continue;
          const float bv = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
          yb[(size_t)n * HW] = __float2bfloat16(acc[mt][nt][2 * half + j] + bv);
        }
      }
    }
  }
}

// --- the Hopper design (see the top) ---

constexpr int kGStages = 4;
constexpr int kGBN = 128;  // pixels a CTA
constexpr int kGBK = 64;   // channels a k-step

// 64 output channels a CTA: 128 (two consumer warpgroups) won only at the
// 8x8 and 16x16 levels at batch 2, by 3-8%, and lost elsewhere
struct ConvTile {
  static constexpr int BM = 64;
  static constexpr int NC = 128;           // consumer threads: one warpgroup
  static constexpr int THREADS = NC + 32;  // and one producer warp
  static constexpr int A = BM * kGBK, B = kGBN * kGBK, STAGE = A + B;  // elements a stage
  static constexpr int PART = NC * (kGBN / 2);  // floats of a split's partial
  static constexpr size_t smem() {
    return 1024 + 2 * (size_t)kGStages * STAGE + 8 * 2 * kGStages + 16;
  }
};

// Column shifts of a consumer's m64n128 accumulator within image rows of WP
// columns (the tile is kGBN / WP image rows of WP pixels).  Thread (g =
// lane / 4, t = lane % 4) holds columns 8i + 2t, 8i + 2t + 1 in d[4i],
// d[4i + 1] (row g) and d[4i + 2], d[4i + 3] (row g + 8); the neighbours
// come by warp shuffles from the lanes of the same g.
//
// shift_left: new[c] = old[c + 1]; a row's last column takes 0 (ROT false)
// or the row's first column (ROT true).
template <int WP, bool ROT, int N>
__device__ __forceinline__ void shift_left(float (&d)[N], int lane) {
  constexpr int G = WP / 8;  // 8-column groups a row
  const int t = lane & 3, next = (lane & ~3) | ((t + 1) & 3), first = lane & ~3;
  float nd[N];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const bool row_end = (i + 1) % G == 0;
    const int inext = row_end ? i + 1 - G : i + 1;
    const float a0 = __shfl_sync(0xffffffffu, d[4 * i], next);
    const float a2 = __shfl_sync(0xffffffffu, d[4 * i + 2], next);
    const float b0 = __shfl_sync(0xffffffffu, d[4 * inext], first);
    const float b2 = __shfl_sync(0xffffffffu, d[4 * inext + 2], first);
    nd[4 * i] = d[4 * i + 1];
    nd[4 * i + 2] = d[4 * i + 3];
    nd[4 * i + 1] = t < 3 ? a0 : (row_end && !ROT) ? 0.f : b0;
    nd[4 * i + 3] = t < 3 ? a2 : (row_end && !ROT) ? 0.f : b2;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = nd[i];
}

// rotate_right: new[c] = old[c - 1]; a row's first column takes its last.
template <int WP, int N>
__device__ __forceinline__ void rotate_right(float (&d)[N], int lane) {
  constexpr int G = WP / 8;
  const int t = lane & 3, prev = (lane & ~3) | ((t + 3) & 3), last = lane | 3;
  float nd[N];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int iprev = i % G == 0 ? i - 1 + G : i - 1;
    const float a1 = __shfl_sync(0xffffffffu, d[4 * i + 1], prev);
    const float a3 = __shfl_sync(0xffffffffu, d[4 * i + 3], prev);
    const float b1 = __shfl_sync(0xffffffffu, d[4 * iprev + 1], last);
    const float b3 = __shfl_sync(0xffffffffu, d[4 * iprev + 3], last);
    nd[4 * i + 1] = d[4 * i];
    nd[4 * i + 3] = d[4 * i + 2];
    nd[4 * i] = t > 0 ? a1 : b1;
    nd[4 * i + 2] = t > 0 ? a3 : b3;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = nd[i];
}

// One (image, rows = kGBN / WP image rows, BM output channels, k split)
// tile.  The k-loop runs over the phases dx = +1, 0, -1 (9 * cb steps:
// phase, then dy, then the 64-channel block).  x comes through xmap (xmap_m
// in phase dx = -1: the same map with W - 1 columns) in boxes of P = SW/2
// pixels of one image row x 64 channels, one slab each, at W coordinate 0
// (or 64): TMA takes a box's innermost start only in whole 16 bytes, so a
// box is never shifted by dx.  The accumulator is shifted instead, between
// and after the phases (y = R(Z-) + Z0 + L(Z+), Zdx the products of phase
// dx at the unshifted columns):
//   after dx = +1: shift_left, 0 into a row's last column -> L(Z+);
//   after dx = 0:  rotate left (a row's first column into its last);
//   after dx = -1: rotate right, which restores that first column; Z-'s
//                  last column, which the rotation would carry to column 0,
//                  is 0 because xmap_m ends one column short.
// A split whose k-range ends in phase +1 applies the first shift at its end
// (the shifts are linear, so the partials still sum to y).
template <int SW, int WP>
__global__ void __launch_bounds__(ConvTile::THREADS)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap xmap_m,
                         const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part, int* __restrict__ counters, int C, int H,
                         int W, int O, int tpi, int splits) {
  using T = ConvTile;
  constexpr int P = SW / 2, ROWS = kGBN / WP;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(  // 1024-byte aligned stages
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGStages * T::STAGE);
  uint64_t* empty = full + kGStages;
  int* flag = reinterpret_cast<int*>(empty + kGStages);

  const int b = blockIdx.x / tpi, h0 = (blockIdx.x % tpi) * ROWS;
  const int o0 = blockIdx.y * T::BM, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int cb = (C + kGBK - 1) / kGBK, per_phase = 3 * cb, nk = 3 * per_phase;
  const int k0 = (int)((long long)split * nk / splits);
  const int k1 = (int)((long long)(split + 1) * nk / splits);

  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) {
      dft::mbar_init(&full[i], 1);
      dft::mbar_init(&empty[i], T::NC);
    }
    dft::mbar_init_fence();
  }
  __syncthreads();

  float acc[kGBN / 2];
#pragma unroll
  for (int i = 0; i < kGBN / 2; ++i) acc[i] = 0.f;

  if (tid >= T::NC) {  // the producer warp: one thread starts every copy
    if (tid == T::NC) {
      for (int ks = k0; ks < k1; ++ks) {
        const int i = ks - k0, s = i % kGStages;
        const int phase = ks / per_phase, dy = (ks % per_phase) / cb - 1;
        const int c0 = (ks % cb) * kGBK, tap = (dy + 1) * 3 + (1 - phase) + 1;
        const CUtensorMap* xm = phase == 2 ? &xmap_m : &xmap;
        if (i >= kGStages) dft::mbar_wait(&empty[s], (i / kGStages - 1) & 1);
        __nv_bfloat16* st = ring + s * T::STAGE;
        dft::mbar_expect_tx(&full[s], T::STAGE * 2);
        dft::tma_load_slab(st, &amap, c0, o0, tap, &full[s]);
        // slab j: pixels v = jP.. of the tile, image row v / WP from column v % WP
#pragma unroll
        for (int v = 0; v < kGBN; v += P)
          dft::tma_load_4d(st + T::A + v * kGBK, xm, v % WP, h0 + v / WP + dy, c0, b, &full[s]);
      }
    }
  } else {
    const int lane = tid & 31;
    bool pending = false;  // the previous step's stage is not yet released
    for (int ks = k0; ks < k1; ++ks) {
      const int i = ks - k0, s = i % kGStages, phase = ks / per_phase;
      dft::mbar_wait(&full[s], (i / kGStages) & 1);
      const __nv_bfloat16* st = ring + s * T::STAGE;
      dft::fence_operands(acc);
      dft::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kGBK / 16; ++kc)
        dft::wgmma_ss<0, 1>(acc, dft::desc_kmajor<64, 128>(st, kc),
                            dft::desc_mnmajor<kGBK, SW>(st + T::A, kc), 1);
      dft::wgmma_commit();
      const bool last = ks + 1 == k1, turn = !last && (ks + 1) / per_phase != phase;
      if (!last && !turn) {
        dft::wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (pending) dft::mbar_arrive(&empty[(i + kGStages - 1) % kGStages]);
        pending = true;
        continue;
      }
      dft::wgmma_wait<0>();
      dft::fence_operands(acc);
      if (pending) dft::mbar_arrive(&empty[(i + kGStages - 1) % kGStages]);
      dft::mbar_arrive(&empty[s]);
      pending = false;
      if (phase == 0) shift_left<WP, false>(acc, lane);
      else if (phase == 1 && turn) shift_left<WP, true>(acc, lane);
      else if (phase == 2) rotate_right<WP>(acc, lane);
    }
    dft::fence_operands(acc);
  }

  if (splits > 1) {
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * T::PART;
    if (tid < T::NC) dft::part_store(part + split * split_stride + tile * T::PART, acc, tid, T::NC);
    if (!dft::last_to_arrive(counters + tile, splits, flag)) return;
    if (tid < T::NC) {
#pragma unroll
      for (int i = 0; i < kGBN / 2; ++i) acc[i] = 0.f;
      const float* p = part + tile * T::PART;
      for (int sp = 0; sp < splits; ++sp, p += split_stride) dft::part_add(acc, p, tid, T::NC);
    }
  }
  if (tid >= T::NC) return;

  // accumulator rows: output channels 16*warp + g (+8); columns 8i + 2t
  // (+1): pixels of the tile, two neighbours of one row
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int oa = o0 + warp * 16 + g, ob = oa + 8;
  const float ba = bias != nullptr && oa < O ? __bfloat162float(bias[oa]) : 0.f;
  const float bb = bias != nullptr && ob < O ? __bfloat162float(bias[ob]) : 0.f;
#pragma unroll
  for (int i = 0; i < kGBN / 8; ++i) {
    const int v = 8 * i + 2 * t, h = h0 + v / WP, w = v % WP;
    if (h >= H || w >= W) continue;  // W is even: w + 1 < W too
    const size_t pix = (size_t)h * W + w;
    if (oa < O)
      *reinterpret_cast<__nv_bfloat162*>(y + ((size_t)b * O + oa) * H * W + pix) =
          __floats2bfloat162_rn(acc[4 * i] + ba, acc[4 * i + 1] + ba);
    if (ob < O)
      *reinterpret_cast<__nv_bfloat162*>(y + ((size_t)b * O + ob) * H * W + pix) =
          __floats2bfloat162_rn(acc[4 * i + 2] + bb, acc[4 * i + 3] + bb);
  }
}

template <int SW, int WP>
cudaError_t launch_wgmma(const void* x, const void* w9, const void* bias, void* y, float* part,
                         int* counters, int B, int C, int H, int W, int O, int splits,
                         cudaStream_t stream) {
  using T = ConvTile;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<SW, WP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)T::smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tpi = (H + kGBN / WP - 1) / (kGBN / WP);
  CUtensorMap am{}, xm{}, xm1{};
  if (!(dft::make_tile_map(&am, w9, 9, O, C, T::BM, 128) &&
        dft::make_nchw_map(&xm, x, B, C, H, W, W, SW) &&
        dft::make_nchw_map(&xm1, x, B, C, H, W, W - 1, SW)))
    return cudaErrorNotSupported;
  const dim3 grid(B * tpi, (O + T::BM - 1) / T::BM, splits);
  conv3x3_wgmma_kernel<SW, WP><<<grid, T::THREADS, T::smem(), stream>>>(
      am, xm, xm1, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
      part, counters, C, H, W, O, tpi, splits);
  return cudaGetLastError();
}

// --- fp32 inputs: the split product (csrc/split_f32.cuh) on tf32 wgmma ---

constexpr int kFC = 32;  // channels a k-step: 32 fp32 values, one 128-byte slab

// 64 output channels by kGBN pixels a CTA, as the bf16 tile
struct ConvTileF32 {
  static constexpr int BM = 64;
  static constexpr int NC = 128;           // consumer threads: one warpgroup
  static constexpr int THREADS = NC + 32;  // and one producer warp
  static constexpr int AH = BM * kFC, BH = kGBN * kFC;  // floats of one half
  static constexpr int STAGE = 2 * (AH + BH);           // [big; small] of both
  static constexpr int PART = NC * (kGBN / 2);          // floats of a split's partial
  static constexpr size_t smem() {
    return 1024 + 4 * (size_t)kGStages * STAGE + 8 * 2 * kGStages + 16;
  }
};

// One (image, rows x box pixels, 64 output channels, k split) tile: pixels
// (h0 + v / box, w0 + v % box) of the tile's kGBN, v = the accumulator's
// column.  The k-loop runs over the 9 taps, then the 32-channel blocks: the
// weight slab of (tap, channels) from the split tap-major copy, and the
// pixel box of NHWC x at (channels, w0 + dx, h0 + dy) -- the tap's shift is
// the box's start, and TMA zero-fills the halo and the columns past W.
__global__ void __launch_bounds__(ConvTileF32::THREADS)
    conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap xmap, const float* __restrict__ bias,
                        float* __restrict__ y, float* __restrict__ part,
                        int* __restrict__ counters, int B, int cp, int H, int W, int O,
                        int log_box, int row_tiles, int col_tiles, int splits) {
  using T = ConvTileF32;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  float* ring = reinterpret_cast<float*>(  // 1024-byte aligned stages
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGStages * T::STAGE);
  uint64_t* empty = full + kGStages;
  int* flag = reinterpret_cast<int*>(empty + kGStages);

  const int box = 1 << log_box, rows = kGBN >> log_box;
  const int per_image = row_tiles * col_tiles;
  const int b = blockIdx.x / per_image, rem = blockIdx.x % per_image;
  const int h0 = (rem / col_tiles) * rows, w0 = (rem % col_tiles) * box;
  const int o0 = blockIdx.y * T::BM, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int cb = (cp + kFC - 1) / kFC, nk = 9 * cb;
  const int k0 = (int)((long long)split * nk / splits);
  const int k1 = (int)((long long)(split + 1) * nk / splits);

  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) {
      dft::mbar_init(&full[i], 1);
      dft::mbar_init(&empty[i], T::NC);
    }
    dft::mbar_init_fence();
  }
  __syncthreads();

  float acc[kGBN / 2];
#pragma unroll
  for (int i = 0; i < kGBN / 2; ++i) acc[i] = 0.f;

  if (tid >= T::NC) {  // the producer warp: one thread starts every copy
    if (tid == T::NC) {
      for (int ks = k0; ks < k1; ++ks) {
        const int i = ks - k0, s = i % kGStages;
        const int tap = ks / cb, c0 = (ks % cb) * kFC;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        if (i >= kGStages) dft::mbar_wait(&empty[s], (i / kGStages - 1) & 1);
        float* st = ring + s * T::STAGE;
        dft::mbar_expect_tx(&full[s], T::STAGE * 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the big halves, then the small ones
          dft::tma_load_slab(st + h * T::AH, &amap, c0, o0, h * 9 + tap, &full[s]);
          dft::tma_load_4d(st + 2 * T::AH + h * T::BH, &xmap, c0, w0 + dx, h0 + dy, h * B + b,
                           &full[s]);
        }
      }
    }
  } else {
    float sacc[kGBN / 2];  // one stage's products: fresh, then added by FADD
    for (int ks = k0; ks < k1; ++ks) {
      const int i = ks - k0, s = i % kGStages;
      dft::mbar_wait(&full[s], (i / kGStages) & 1);
      const float* st = ring + s * T::STAGE;
      const float *ab = st, *as = st + T::AH, *xb = st + 2 * T::AH, *xs = xb + T::BH;
      dft::fence_operands(sacc);
      dft::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kFC / 8; ++kc) {
        const uint64_t wb = dft::desc_f32<64, 128>(ab, kc);
        dft::wgmma_tf32_ss(sacc, dft::desc_f32<64, 128>(as, kc),
                           dft::desc_f32<kGBN, 128>(xb, kc), kc > 0);
        dft::wgmma_tf32_ss(sacc, wb, dft::desc_f32<kGBN, 128>(xs, kc), 1);
        dft::wgmma_tf32_ss(sacc, wb, dft::desc_f32<kGBN, 128>(xb, kc), 1);
      }
      dft::wgmma_commit();
      dft::wgmma_wait<0>();
      dft::fence_operands(sacc);
      dft::mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < kGBN / 2; ++j) acc[j] += sacc[j];
    }
  }

  if (splits > 1) {
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t split_stride = (size_t)gridDim.y * gridDim.x * T::PART;
    if (tid < T::NC)
      dft::part_store(part + split * split_stride + tile * T::PART, acc, tid, T::NC);
    if (!dft::last_to_arrive(counters + tile, splits, flag)) return;
    if (tid < T::NC) {
#pragma unroll
      for (int i = 0; i < kGBN / 2; ++i) acc[i] = 0.f;
      const float* p = part + tile * T::PART;
      for (int sp = 0; sp < splits; ++sp, p += split_stride) dft::part_add(acc, p, tid, T::NC);
    }
  }
  if (tid >= T::NC) return;

  // accumulator rows: output channels 16*warp + g (+8); columns 8i + 2t
  // (+1): two neighbouring pixels of one box row (box is even)
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int oa = o0 + warp * 16 + g, ob = oa + 8;
  const float ba = bias != nullptr && oa < O ? bias[oa] : 0.f;
  const float bb = bias != nullptr && ob < O ? bias[ob] : 0.f;
  const bool pairs = (W & 1) == 0;  // fp32 pairs 8-byte aligned
#pragma unroll
  for (int i = 0; i < kGBN / 8; ++i) {
    const int v = 8 * i + 2 * t, h = h0 + (v >> log_box), w = w0 + (v & (box - 1));
    if (h >= H || w >= W) continue;
    const bool two = w + 1 < W;
    const size_t pix = (size_t)h * W + w;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = half ? ob : oa;
      if (o >= O) continue;
      const float bv = half ? bb : ba;
      const float v0 = acc[4 * i + 2 * half] + bv, v1 = acc[4 * i + 2 * half + 1] + bv;
      float* dst = y + ((size_t)b * O + o) * H * W + pix;
      if (two && pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (two) dst[1] = v1;
      }
    }
  }
}

}  // namespace

// bf16 x (B, C, H, W), wt (O, C, 3, 3), bias (O) or NULL, y (B, O, H, W);
// all contiguous, C a multiple of 8 (16-byte weight rows): the element-load
// route, for the shapes dft_conv3x3_wgmma does not take.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int dft_conv3x3(const void* x, const void* wt, const void* bias, void* y, int B, int C,
                           int H, int W, int O, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  if (B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bf16_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (O + kBN - 1) / kBN);
  conv3x3_bf16_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), B, C, H, W, O);
  return static_cast<int>(cudaGetLastError());
}

// fp32 x (B, C, H, W), any shape; w9s (2, 9, O, cp) the split tap-major
// weight, [big; small] of w9[kh*3+kw, o, c] = wt[o, c, kh, kw], channels
// zero-padded to cp = C rounded up to 8 (ops/conv3x3.py:tap_major_split);
// bias (O) or NULL; y (B, O, H, W); all contiguous.  box in {8, 16, 32, 64,
// 128} pixels of an image row a TMA box reads (W <= box, or box = 128 and a
// row spans ceil(W / 128) tiles), 128 / box rows a tile; splits CTAs along
// K (1 .. 9 * ceil(cp / 32)).  work: fp32 scratch of work_floats >= 2 * B *
// H * W * cp floats for x's split NHWC copy.  With splits > 1, part is fp32
// scratch of splits * tiles * 64 * 128 floats and counters `tiles` ints
// (tiles = B * ceil(H / rows) * ceil(W / box) * ceil(O / 64),
// ops/conv3x3.py:plan_f32), zero on entry and left zero on exit.  Returns the
// launches' cudaError_t (0 = launched).
extern "C" int dft_conv3x3_f32(const void* x, const void* w9s, const void* bias, void* y,
                               void* work, long long work_floats, void* part, void* counters,
                               int B, int C, int H, int W, int O, int box, int splits,
                               void* stream) {
  using T = ConvTileF32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cp = (C + 7) / 8 * 8, nk = 9 * ((cp + kFC - 1) / kFC);
  int log_box = 3;
  while (log_box < 7 && (1 << log_box) < box) ++log_box;
  if (B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || box != (1 << log_box) ||
      (W > box && box != 128) || splits < 1 || splits > nk || work == nullptr ||
      work_floats < 2LL * B * H * W * cp ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem());
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  float* xs = static_cast<float*>(work);  // (2, B, H, W, cp)
  cudaError_t err = dft::split_nhwc(static_cast<const float*>(x), xs, B, C, H * W, cp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kGBN / box, row_tiles = (H + rows - 1) / rows, col_tiles = (W + box - 1) / box;
  CUtensorMap am{}, xm{};
  if (!(dft::make_tile_map_f32(&am, static_cast<const float*>(w9s), 18, O, cp, T::BM, 128) &&
        dft::make_nhwc_map_f32(&xm, xs, 2 * B, H, W, cp, box, rows)))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid(B * row_tiles * col_tiles, (O + T::BM - 1) / T::BM, splits);
  conv3x3_tf32_kernel<<<grid, T::THREADS, T::smem(), st>>>(
      am, xm, static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(part), static_cast<int*>(counters), B, cp, H, W, O, log_box,
      row_tiles, col_tiles, splits);
  return static_cast<int>(cudaGetLastError());
}

// The Hopper design: bf16 x (B, C, H, W) with W a multiple of 8 and at most
// 128, C a multiple of 8; w9 (9, O, C) the tap-major weight (w9[kh*3+kw, o,
// c] = wt[o, c, kh, kw]); bias (O) or NULL; y (B, O, H, W); all contiguous.
// sw in {32, 64, 128} the pixel tile's swizzle (sw/2 pixels a TMA box; an
// image row is sw/2 pixels wide in the tile, or 128 where W > 64), splits
// CTAs along K (1 .. 9 * ceil(C/64)).  With splits > 1, part is fp32
// scratch of splits * tiles * 64 * 128 floats and counters `tiles` ints
// (tiles = the grid's B * ceil(H / rows) * ceil(O / 64),
// ops/conv3x3.py:plan), zero on entry and
// left zero on exit.  Returns the launch's cudaError_t (0 = launched).
extern "C" int dft_conv3x3_wgmma(const void* x, const void* w9, const void* bias, void* y,
                                 void* part, void* counters, int B, int C, int H, int W, int O,
                                 int sw, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = 9 * ((C + kGBK - 1) / kGBK);
  const int wp = W > 64 ? 128 : sw / 2;
  if (B < 1 || C < 1 || H < 1 || O < 1 || W < 8 || W % 8 != 0 || W > wp || C % 8 != 0 ||
      splits < 1 || splits > nk || (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
#define DFT_CONV_CASE(SW, WP)                                                               \
  if (sw == SW && wp == WP)                                                                 \
    return static_cast<int>(launch_wgmma<SW, WP>(x, w9, bias, y, p, c, B, C, H, W, O, splits, st));
  DFT_CONV_CASE(32, 16)
  DFT_CONV_CASE(64, 32)
  DFT_CONV_CASE(128, 64)
  DFT_CONV_CASE(128, 128)
#undef DFT_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
