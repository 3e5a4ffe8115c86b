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
// stack, nor a padded or channels-last copy: it reads x and wt where they lie.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2*B*H*W*C*O*9
// operations against x + wt + y bytes.  The SD1.5 UNet's routed convs are
// operation-bound: at B=2, 64x64, 320 -> 320 it is 15.1 GFLOP (15.3 us)
// against 10.5 MB (3.1 us); the 37 routed convs of one CFG step at 512^2
// carry about 0.50 TFLOP, about 0.51 ms.
//
// Design (a first, simple kernel): an implicit GEMM with M = B*H*W output
// pixels, N = O and K = 9*C ordered k = c*9 + kh*3 + kw, so that a row of
// the B operand is a row of the OIHW weight as it lies in memory.  A CTA of
// 8 warps computes a 128 x 128 tile (4 x 2 warps of 32 x 64) on mma.sync
// m16n8k16 (bf16 in, fp32 out), K in steps of 32 through two shared-memory
// stages:
//   - B (weights): 16-byte cp.async copies of contiguous OIHW rows,
//     zero-filled past O and past K (O is masked, never padded in memory);
//   - A (pixels x taps): each thread owns one output pixel of the tile and
//     16 consecutive k of each step.  It loads them from NCHW with predicated
//     2-byte loads (zero where the tap falls outside the image: the halo),
//     neighbouring threads reading neighbouring pixels, keeps the next step's
//     values in registers while the current step computes, and stores them
//     k-contiguous (two 16-byte stores) so the mma A fragments are plain
//     32-bit shared loads.
// The epilogue adds the bias in fp32, rounds once and writes NCHW directly.
// No TMA, wgmma or split-K yet: the 8x8 level (M = 64 or 128) runs one CTA
// row.  fp32 inputs take a plain FMA kernel (conv3x3_f32_kernel) with the
// same math.
#include "common.cuh"

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

// fp32 inputs: the same implicit GEMM with plain FMA, 64x64 tiles, 4x4
// outputs per thread.
constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ y, int B, int C, int H,
                       int W, int O) {
  __shared__ float Xs[kFK][kFM + 1];
  __shared__ float Ws[kFK][kFN + 1];
  const int HW = H * W, M = B * HW, K = 9 * C;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
    for (int i = tid; i < kFK * kFM; i += kFThreads) {
      const int row = i % kFM, kk = i / kFM;  // neighbouring threads, neighbouring pixels
      const int m = m0 + row, k = k0 + kk;
      float a = 0.f;
      if (m < M && k < K) {
        const int b = m / HW, rem = m % HW, c = k / 9, tap = k % 9;
        const int hh = rem / W + tap / 3 - 1, ww = rem % W + tap % 3 - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          a = x[((size_t)b * C + c) * HW + hh * W + ww];
      }
      Xs[kk][row] = a;
    }
    for (int i = tid; i < kFK * kFN; i += kFThreads) {
      const int row = i / kFK, kk = i % kFK;
      Ws[kk][row] = (n0 + row < O && k0 + kk < K) ? wt[(size_t)(n0 + row) * K + k0 + kk] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int b = m / HW, rem = m % HW;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= O) continue;
      y[((size_t)b * O + n) * HW + rem] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

}  // namespace

// x (B, C, H, W), wt (O, C, 3, 3), bias (O) or NULL, y (B, O, H, W); all
// contiguous, and C a multiple of 8 for bf16 (16-byte weight rows).
// dtype: 0 = fp32, 1 = bf16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int dft_conv3x3(const void* x, const void* wt, const void* bias, void* y, int B, int C,
                           int H, int W, int O, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  if (B < 1 || C < 1 || H < 1 || W < 1 || O < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bf16_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((unsigned)((M + kBM - 1) / kBM), (O + kBN - 1) / kBN);
    conv3x3_bf16_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), B, C, H, W, O);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) {
    const dim3 grid((unsigned)((M + kFM - 1) / kFM), (O + kFN - 1) / kFN);
    conv3x3_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<float*>(y), B, C, H, W, O);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
