// GroupNorm over channels-last (NHWC) activations, with an optional
// per-(batch, channel) add before it and an optional SiLU after it:
//   v[b, p, c] = round_T(x[b, p, c] + add[b, c])        (v = x without an add)
//   y[b, p, c] = act((v - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c])
// with g = c / (C / G), mean and the biased variance of group g of image b
// over its HW * C / G values, rstd = 1 / sqrt(var + eps), act SiLU (v / (1 +
// e^-v)) or none, statistics and arithmetic in fp32 and one rounding of y to
// T (bf16 or fp32).  x, y: (B, HW, C); add: (B, C) or NULL; gamma, beta: (C).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it with its neighbours in NHWC.  On the card the port ran PyTorch's
// GroupNorm on NCHW (a moments pass, then an apply pass), a SiLU pass and
// the time-embedding add as passes of their own, and cuDNN transposed every
// convolution's input and output to NHWC and back.  This kernel serves the
// channels-last layout of the generation path (models/layers.py), where
// PyTorch's GroupNorm would copy every activation back to NCHW.
//
// Bound on an H100 SXM: bytes, x read and y written once, 2 * B*HW*C *
// sizeof(T) over 3.35 TB/s (add, gamma and beta are noise); at SD1.5's
// 64x64x320 level, batch 2, 5.2 MB, 1.6 us.
//
// Design: two launches on the stream, no atomics on data.
//   * group_norm_stats_kernel: grid (tiles, B), a CTA a tile of `tile_px`
//     pixels of one image, all C channels.  A thread owns one 16-byte vector
//     of channels (8 bf16 or 4 fp32) and walks the tile's pixels R apart
//     (R = threads / (C / vector)), two loads in flight; it sums each
//     channel shifted by its first value (no cancellation where the mean is
//     large against the spread), then the CTA merges channel partials into
//     group partials (Chan's pairwise update: count, mean, M2) through
//     shared memory and warp shuffles, and stores one (mean, M2) per group
//     and tile.  The last CTA of an image to arrive (csrc/wgmma.cuh's
//     arrival pattern, counters left zero) merges the tiles' partials in
//     tile order, then writes per-channel scale = gamma * rstd and shift =
//     beta - mean * scale in fp32 (B, C, 2).
//   * group_norm_apply_kernel: the same tiles walked in reverse order, so
//     that the first tiles it reads are the last the stats pass left in the
//     50 MB L2: at the UNet's levels the whole tensor stays there and x
//     leaves device memory once; at the VAE's 256^2-768^2 levels twice.  y =
//     v * scale + shift, SiLU, one rounding, 16-byte stores.
// Deterministic: every sum runs in a fixed order.  ops/group_norm.py:plan
// picks the threads and the tile (one or two waves of CTAs, each thread at
// least 4 loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16-byte loads a thread issues before it uses them.  Measured on an H100 at
// 4 x 128 x 768^2 bf16: 2 gave 0.644 ms, 4 0.712, 8 0.683 (more registers,
// fewer CTAs an SM); at the UNet's levels 2 was as fast or faster.  Reading
// x evict-first in the second pass gained nothing.
constexpr int kUnroll = 2;

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static float value(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static float round(float v) { return v; }
  __device__ static float value(float v) { return v; }
};

// (n, mean, m2) += (nb, mb, m2b): Chan's pairwise update of a count, a mean
// and a sum of squared deviations
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb, w = nb / nn, d = mb - mean;
  mean += d * w;
  m2 += m2b + d * d * n * w;
  n = nn;
}

__device__ __forceinline__ void warp_merge(float& n, float& mean, float& m2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    merge(n, mean, m2, nb, mb, m2b);
  }
}

template <typename T>
__device__ __forceinline__ void load_add(const T* add, int b, int C, int c0,
                                         float (&a)[Pack<T>::N]) {
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i)
    a[i] = add == nullptr ? 0.f : Pack<T>::value(add[(size_t)b * C + c0 + i]);
}

// v = round_T(x + add), or x itself without an add
template <typename T, bool ADD>
__device__ __forceinline__ float input(float x, float a) {
  return ADD ? Pack<T>::round(x + a) : x;
}

// MAXT: the most threads a CTA of the instance has (512, or 1024 for the
// widest channel counts), which sets the registers a thread may hold
template <typename T, bool ADD, int MAXT>
__global__ void __launch_bounds__(MAXT) group_norm_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ add, const T* __restrict__ gamma,
    const T* __restrict__ beta, float* __restrict__ part, int* __restrict__ counters,
    float* __restrict__ ss, int HW, int C, int G, int tile_px, float eps) {
  constexpr int N = Pack<T>::N;
  extern __shared__ float sm[];  // [R][C] means, [R][C] M2s, [R] counts
  __shared__ int flag;
  const int V = C / N, R = blockDim.x / V, tid = threadIdx.x;
  const int v = tid % V, r = tid / V, c0 = v * N;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int p0 = tile * tile_px, p1 = min(HW, p0 + tile_px);
  float* s_mean = sm;
  float* s_m2 = sm + R * C;
  float* s_n = sm + 2 * R * C;

  float a[N], k[N], s1[N], s2[N];
  load_add(add, b, C, c0, a);
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = s1[i] = s2[i] = 0.f;
  int n = 0;
  const T* xb = x + (size_t)b * HW * C + c0;
  int p = p0 + r;
  if (p < p1) {
    float f[N];
    Pack<T>::load(xb + (size_t)p * C, f);
#pragma unroll
    for (int i = 0; i < N; ++i) k[i] = input<T, ADD>(f[i], a[i]);
  }
  for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
    float f[kUnroll][N];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) Pack<T>::load(xb + (size_t)(p + j * R) * C, f[j]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float d = input<T, ADD>(f[j][i], a[i]) - k[i];
        s1[i] += d;
        s2[i] += d * d;
      }
    n += kUnroll;
  }
  for (; p < p1; p += R) {
    float f[N];
    Pack<T>::load(xb + (size_t)p * C, f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = input<T, ADD>(f[i], a[i]) - k[i];
      s1[i] += d;
      s2[i] += d * d;
    }
    ++n;
  }
  const float nf = (float)n;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float q = n ? s1[i] / nf : 0.f;
    s_mean[r * C + c0 + i] = k[i] + q;
    s_m2[r * C + c0 + i] = n ? fmaxf(s2[i] - s1[i] * q, 0.f) : 0.f;
  }
  if (v == 0) s_n[r] = nf;
  __syncthreads();

  // channels and pixel lanes -> one (mean, M2) a group of this tile
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const int cg = C / G, entries = R * cg;
  for (int g = warp; g < G; g += warps) {
    float gn = 0.f, gm = 0.f, gm2 = 0.f;
    for (int e = lane; e < entries; e += 32) {
      const int er = e / cg, c = g * cg + e % cg;
      merge(gn, gm, gm2, s_n[er], s_mean[er * C + c], s_m2[er * C + c]);
    }
    warp_merge(gn, gm, gm2);
    if (lane == 0) {
      float* dst = part + (((size_t)b * G + g) * tiles + tile) * 2;
      dst[0] = gm;
      dst[1] = gm2;
    }
  }

  // the last tile of image b to arrive turns the groups' statistics into
  // per-channel scale and shift
  __threadfence();
  __syncthreads();
  if (tid == 0) flag = atomicAdd(counters + b, 1) == tiles - 1;
  __syncthreads();
  if (!flag) return;
  __threadfence();
  if (tid == 0) counters[b] = 0;
  float* s_gmean = sm;  // [G] means, [G] rstd: the channel partials are spent
  float* s_grstd = sm + G;
  __syncthreads();
  for (int g = warp; g < G; g += warps) {
    float gn = 0.f, gm = 0.f, gm2 = 0.f;
    for (int t = lane; t < tiles; t += 32) {
      const float* src = part + (((size_t)b * G + g) * tiles + t) * 2;
      const float tn = (float)((min(HW, (t + 1) * tile_px) - t * tile_px) * cg);
      merge(gn, gm, gm2, tn, __ldcg(src), __ldcg(src + 1));
    }
    warp_merge(gn, gm, gm2);
    if (lane == 0) {
      s_gmean[g] = gm;
      s_grstd[g] = rsqrtf(fmaxf(gm2 / gn, 0.f) + eps);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float scale = Pack<T>::value(gamma[c]) * s_grstd[g];
    ss[((size_t)b * C + c) * 2] = scale;
    ss[((size_t)b * C + c) * 2 + 1] = Pack<T>::value(beta[c]) - s_gmean[g] * scale;
  }
}

template <typename T, bool ADD, bool SILU, int MAXT>
__global__ void __launch_bounds__(MAXT) group_norm_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ add, const float* __restrict__ ss,
    T* __restrict__ y, int HW, int C, int tile_px) {
  constexpr int N = Pack<T>::N;
  const int V = C / N, R = blockDim.x / V, tid = threadIdx.x;
  const int v = tid % V, r = tid / V, c0 = v * N;
  const int b = gridDim.y - 1 - blockIdx.y, tile = gridDim.x - 1 - blockIdx.x;
  const int p0 = tile * tile_px, p1 = min(HW, p0 + tile_px);
  float a[N], scale[N], shift[N];
  load_add(add, b, C, c0, a);
  const float4* s4 = reinterpret_cast<const float4*>(ss + ((size_t)b * C + c0) * 2);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float4 q = s4[i];
    scale[2 * i] = q.x;
    shift[2 * i] = q.y;
    scale[2 * i + 1] = q.z;
    shift[2 * i + 1] = q.w;
  }
  const size_t base = (size_t)b * HW * C + c0;
  auto out = [&](const float (&f)[N], size_t off) {
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = input<T, ADD>(f[i], a[i]) * scale[i] + shift[i];
      o[i] = SILU ? t / (1.f + expf(-t)) : t;
    }
    Pack<T>::store(y + off, o);
  };
  int p = p0 + r;
  for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
    float f[kUnroll][N];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      Pack<T>::load(x + base + (size_t)(p + j * R) * C, f[j]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) out(f[j], base + (size_t)(p + j * R) * C);
  }
  for (; p < p1; p += R) {
    float f[N];
    Pack<T>::load(x + base + (size_t)p * C, f);
    out(f, base + (size_t)p * C);
  }
}

// both launches of one instance: T, an add or none, and the CTA size bound
template <typename T, bool ADD, int MAXT>
int launch_pair(const T* x, const T* add, const T* gamma, const T* beta, T* y, float* part,
                float* ss, int* counters, int B, int HW, int C, int G, int threads, int tile_px,
                float eps, bool silu, size_t smem, cudaStream_t st) {
  static size_t allowed = 46 * 1024;  // dynamic shared memory the instance may take
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(group_norm_stats_kernel<T, ADD, MAXT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid((HW + tile_px - 1) / tile_px, B);
  group_norm_stats_kernel<T, ADD, MAXT><<<grid, threads, smem, st>>>(
      x, add, gamma, beta, part, counters, ss, HW, C, G, tile_px, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (silu)
    group_norm_apply_kernel<T, ADD, true, MAXT><<<grid, threads, 0, st>>>(x, add, ss, y, HW, C,
                                                                         tile_px);
  else
    group_norm_apply_kernel<T, ADD, false, MAXT><<<grid, threads, 0, st>>>(x, add, ss, y, HW, C,
                                                                          tile_px);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* add, const void* gamma, const void* beta, void* y,
           void* part, void* ss, void* counters, int B, int HW, int C, int G, int threads,
           int tile_px, float eps, int silu, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const int V = C / N;
  if (B < 1 || HW < 1 || G < 1 || C % G != 0 || C % N != 0 || threads < V ||
      threads % V != 0 || threads > 1024 || tile_px < 1 || (tile_px % (threads / V)) != 0 ||
      ((uintptr_t)x | (uintptr_t)y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = threads / V;
  const size_t smem = (2 * (size_t)R * C + R) * sizeof(float);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const T *xt = static_cast<const T*>(x), *at = static_cast<const T*>(add);
  const T *gt = static_cast<const T*>(gamma), *bt = static_cast<const T*>(beta);
  T* yt = static_cast<T*>(y);
  float *pt = static_cast<float*>(part), *st_ = static_cast<float*>(ss);
  int* ct = static_cast<int*>(counters);
  const bool s = silu != 0;
  if (threads <= 512) {
    if (add) return launch_pair<T, true, 512>(xt, at, gt, bt, yt, pt, st_, ct, B, HW, C, G,
                                              threads, tile_px, eps, s, smem, st);
    return launch_pair<T, false, 512>(xt, at, gt, bt, yt, pt, st_, ct, B, HW, C, G, threads,
                                      tile_px, eps, s, smem, st);
  }
  if (add) return launch_pair<T, true, 1024>(xt, at, gt, bt, yt, pt, st_, ct, B, HW, C, G,
                                             threads, tile_px, eps, s, smem, st);
  return launch_pair<T, false, 1024>(xt, at, gt, bt, yt, pt, st_, ct, B, HW, C, G, threads,
                                     tile_px, eps, s, smem, st);
}

}  // namespace

// x, y (B, HW, C) channels-last, 16-byte aligned; add (B, C) or NULL; gamma,
// beta (C); all of one dtype, fp32 (fp32 = 1) or bf16, contiguous.  part:
// fp32 scratch of 2 * B * G * tiles floats, ss: fp32 scratch of 2 * B * C,
// counters: B ints, zero on entry and left zero (tiles = ceil(HW / tile_px)).
// threads a multiple of C / vector (vector = 8 bf16 or 4 fp32) up to 1024;
// tile_px a multiple of threads / (C / vector).  Returns the launches'
// cudaError_t (0 = launched).
extern "C" int dft_group_norm(const void* x, const void* add, const void* gamma,
                              const void* beta, void* y, void* part, void* ss, void* counters,
                              int B, int HW, int C, int G, int threads, int tile_px, float eps,
                              int silu, int fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch<float>(x, add, gamma, beta, y, part, ss, counters, B, HW, C, G, threads,
                         tile_px, eps, silu, st);
  return launch<__nv_bfloat16>(x, add, gamma, beta, y, part, ss, counters, B, HW, C, G,
                               threads, tile_px, eps, silu, st);
}
