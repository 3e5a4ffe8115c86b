// fp32 operands for the split (3xTF32) products of the fp32 kernels (K1,
// K3, K2, K5; sm_90a): each value x becomes big = tf32(x) and small =
// tf32(x - big), both rounded to nearest (cvt.rna), and a product a b becomes
//   small_a big_b + big_a small_b + big_a big_b
// on wgmma's tf32 path -- CUTLASS's "big/small" fast-fp32 split.  The
// dropped small_a small_b term and the two roundings leave about 2^-22 of
// |a b| a product, near fp32's own 2^-24 rounding of the sums, at three
// tensor-core products (a third of 494.7 TFLOP/s dense TF32 on an H100 SXM)
// where the FMA units give 67 TFLOP/s.  The tensor cores' fp32 sums are not
// rounded to nearest, so every kernel sums one tile's or one stage's
// products in a fresh accumulator and adds it to its running sum by FADD.
//
// tf32 wgmma reads both operands K-major (no transpose bit), and a register
// A fragment holds columns t and t + 4 of each 8-column k-chunk where a
// wgmma accumulator holds columns 2t and 2t + 1.  So the flash kernels
// build A fragments from accumulators (P, dS) in place by permuting the
// contraction index: logical column c of a chunk is element perm(c) of the
// 8 (0, 2, 4, 6, 1, 3, 5, 7), and the operand read against it (V, dO, Q or
// K, transposed) is stored in that order.
//
// A prep pass per call writes the split copies the kernels load by TMA:
//   * split_rows: x (B, rows, d) -> big, small (B, rows, DP), the contraction
//     dim zero-padded to DP (16-byte rows whatever d is); split_rows3 does
//     it for up to three matrices in one launch;
//   * split_cols: x (B, rows, d) -> big, small (B, DP, R8), transposed, R8 =
//     rows rounded up to 8, rows permuted within each group of 8 and zero
//     past `rows` and past d;
//   * split_nhwc: NCHW x (B, C, H, W) -> big, small (B, H, W, CP), channels
//     innermost and zero-padded to CP, through a shared-memory transpose.
// Each is one pass over x (read once, two copies written), bound by bytes.
#pragma once

#include "wgmma.cuh"

namespace dft {

// head dim of the fp32 kernels: d rounded up to 8 up to 64, to 16 above
__host__ __device__ constexpr int f32_dpad(int d) {
  return d <= 64 ? (d + 7) / 8 * 8 : (d + 15) / 16 * 16;
}

// swizzle bytes of a tile whose rows hold C fp32 values: the widest whose
// slabs (SW/4 values) C fills, so that a tile has no padding
__host__ __device__ constexpr int f32_swizzle(int C) {
  return C % 32 == 0 ? 128 : C % 16 == 0 ? 64 : 32;
}

// bytes of an R x C fp32 tile in shared memory, rounded up to the 1024-byte
// period of the widest swizzle, so that every tile after it stays aligned
__host__ __device__ constexpr int f32_tile_bytes(int R, int C) {
  return (R * C * 4 + 1023) / 1024 * 1024;
}

// the row of x at logical column j of a transposed copy
__host__ __device__ constexpr int perm_row(int j) {
  return (j & ~7) | ((j & 7) < 4 ? 2 * (j & 7) : 2 * ((j & 7) - 4) + 1);
}

// wgmma descriptor of k-chunk kc (8 values) of an R-row fp32 tile swizzled by
// SW bytes: the bf16 K-major descriptor on the same bytes
template <int R, int SW>
__device__ __forceinline__ uint64_t desc_f32(const float* tile, int kc) {
  return desc_kmajor<R, SW>(reinterpret_cast<const __nv_bfloat16*>(tile), kc);
}

// an R x C fp32 tile swizzled by SW bytes: C / (SW/4) slabs, slab i one TMA
// box of SW/4 columns x R rows at (row0, col0 + i * SW/4) of head `head`
// (make_tile_map_f32's box), all completing on `bar`
template <int R, int C, int SW>
__device__ __forceinline__ void tma_load_tile_f32(float* dst, const CUtensorMap* map, int row0,
                                                  int col0, int head, uint64_t* bar) {
#pragma unroll
  for (int i = 0; i < C / (SW / 4); ++i)
    tma_load_slab(dst + i * R * (SW / 4), map, col0 + i * (SW / 4), row0, head, bar);
}

// big and small halves of 4 values as a register A fragment
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0,
                                           float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b = tf32_rna(v[i]);
    hi[i] = __float_as_uint(b);
    lo[i] = __float_as_uint(tf32_rna(v[i] - b));
  }
}

__global__ void split_rows_kernel(const float* __restrict__ x, float* __restrict__ big,
                                  float* __restrict__ small, int d, int dp, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % dp);
    const float v = c < d ? x[(i / dp) * d + c] : 0.f;
    const float b = tf32_rna(v);
    big[i] = b;
    small[i] = tf32_rna(v - b);
  }
}

__global__ void split_cols_kernel(const float* __restrict__ x, float* __restrict__ big,
                                  float* __restrict__ small, int rows, int r8, int d, int dp,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = perm_row((int)(i % r8));
    const int c = (int)((i / r8) % dp);
    const long long b = i / ((long long)r8 * dp);
    const float v = (r < rows && c < d) ? x[(b * rows + r) * d + c] : 0.f;
    const float hi = tf32_rna(v);
    big[i] = hi;
    small[i] = tf32_rna(v - hi);
  }
}

// split_rows of up to three (rows, d) matrices at once (one launch): x_i ->
// out_i = [big; small], each n_i = rows_i * dp values
__global__ void split_rows3_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                                   const float* __restrict__ x2, float* __restrict__ o0,
                                   float* __restrict__ o1, float* __restrict__ o2, long long n0,
                                   long long n1, long long n2, int d, int dp) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n0 + n1 + n2;
       i += (long long)gridDim.x * blockDim.x) {
    const bool first = i < n0, second = !first && i < n0 + n1;
    const long long j = first ? i : second ? i - n0 : i - n0 - n1;
    const long long n = first ? n0 : second ? n1 : n2;
    const float* x = first ? x0 : second ? x1 : x2;
    float* o = first ? o0 : second ? o1 : o2;
    const int c = (int)(j % dp);
    const float v = c < d ? x[(j / dp) * d + c] : 0.f;
    const float b = tf32_rna(v);
    o[j] = b;
    o[n + j] = tf32_rna(v - b);
  }
}

// one 32 x 32 (channels x pixels) block of image blockIdx.z, transposed
// through shared memory: reads along the pixels, writes along the channels
__global__ void split_nhwc_kernel(const float* __restrict__ x, float* __restrict__ big,
                                  float* __restrict__ small, int C, int HW, int cp) {
  __shared__ float tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int c = c0 + j, p = p0 + tx;
    tile[j][tx] = (c < C && p < HW) ? x[((size_t)b * C + c) * HW + p] : 0.f;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int p = p0 + j, c = c0 + tx;
    if (p >= HW || c >= cp) continue;
    const float v = tile[tx][j], hi = tf32_rna(v);
    const size_t o = ((size_t)b * HW + p) * cp + c;
    big[o] = hi;
    small[o] = tf32_rna(v - hi);
  }
}

inline int split_blocks(long long n) {
  const long long b = (n + 255) / 256;
  return (int)(b < 132 * 16 ? b : 132 * 16);
}

// x (B, rows, d) -> out = [big; small], each (B, rows, dp)
inline cudaError_t split_rows(const float* x, float* out, int B, int rows, int d, int dp,
                              cudaStream_t st) {
  const long long n = (long long)B * rows * dp;
  split_rows_kernel<<<split_blocks(n), 256, 0, st>>>(x, out, out + n, d, dp, n);
  return cudaGetLastError();
}

// x (B, rows, d) -> out = [big; small], each (B, dp, r8) transposed and permuted
inline cudaError_t split_cols(const float* x, float* out, int B, int rows, int d, int dp,
                              cudaStream_t st) {
  const int r8 = (rows + 7) / 8 * 8;
  const long long n = (long long)B * dp * r8;
  split_cols_kernel<<<split_blocks(n), 256, 0, st>>>(x, out, out + n, rows, r8, d, dp, n);
  return cudaGetLastError();
}

// x_i (rows_i, d) -> out_i = [big; small], each (rows_i, dp), for i < 3 (rows_i
// may be 0: that matrix is skipped), in one launch
inline cudaError_t split_rows3(const float* x0, float* o0, int rows0, const float* x1, float* o1,
                               int rows1, const float* x2, float* o2, int rows2, int d, int dp,
                               cudaStream_t st) {
  const long long n0 = (long long)rows0 * dp, n1 = (long long)rows1 * dp,
                  n2 = (long long)rows2 * dp;
  split_rows3_kernel<<<split_blocks(n0 + n1 + n2), 256, 0, st>>>(x0, x1, x2, o0, o1, o2, n0, n1,
                                                                  n2, d, dp);
  return cudaGetLastError();
}

// NCHW x (B, C, hw = H * W) -> out = [big; small], each (B, hw, cp), cp >= C
inline cudaError_t split_nhwc(const float* x, float* out, int B, int C, int hw, int cp,
                              cudaStream_t st) {
  const dim3 grid((hw + 31) / 32, (cp + 31) / 32, B);
  split_nhwc_kernel<<<grid, dim3(32, 8), 0, st>>>(x, out, out + (long long)B * hw * cp, C, hw,
                                                  cp);
  return cudaGetLastError();
}

}  // namespace dft
