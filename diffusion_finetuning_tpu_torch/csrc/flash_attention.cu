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
// backward kernel reads.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the SD1.5
// 512^2 CFG self-attention at S=4096, d=40, BH=16 is 4*16*4096^2*40 = 43
// GFLOP, about 43 us; S=1024, d=80 is 5.4 GFLOP, about 5.4 us.  The
// cross-attention calls (KV=77) are memory-bound: q and o at S=4096 are
// about 10 MB, about 3 us.
//
// Design.  A CTA holds NWG consumer warpgroups (1 or 2), each owning 64 q
// rows; the host picks NWG (ops/flash_attention.py:fwd_q_tile): 128-row
// tiles, which read K/V once for twice the rows, where their grid still
// covers half the SMs.
//   * Q, and K/V through a ring of 4 shared-memory stages (3 for two
//     warpgroups at d_pad > 128, where 4 do not fit), arrive by TMA (one
//     cp.async.bulk.tensor a 64-column slab, started by one thread,
//     completing on the stage's mbarrier), two 64-row tiles ahead (one with
//     3 stages): while tile j is multiplied, tile j-1 is still read (its V)
//     and the next ones are in flight.  Tiles use wgmma.cuh's 128-byte
//     swizzled layout, which the TMA box writes as it is; TMA zero-fills
//     columns past d and rows past Skv, so the head dim is padded (40 -> 48)
//     in shared memory only.  Copies by cp.async, or by TMA into an
//     unswizzled layout (16-byte rows, one request each), had taken a
//     quarter of the time at S=4096.  A d that is not a multiple of 8 has
//     rows that are not 16-byte aligned, which TMA refuses: such a d takes
//     plain element loads (no overlap), routed by shape, never after a
//     failure.
//   * Q is copied once and held as wgmma A fragments in registers.
//     S = Q K^T is wgmma m64n64k16 (B = the K tile, K-major); O += P V is
//     wgmma m64n{DP}k16 with P's bf16 A fragments built in registers from the
//     S accumulator (the Pallas kernel casts p to v's dtype) and B = the V
//     tile read MN-major (the transpose bit), fp32 accumulation.
//   * The online softmax runs on the accumulator in registers: each thread
//     holds rows g and g+8 of its warp, the row max is reduced across the
//     quad, the row sum l is kept per thread and reduced once at the end;
//     exp2 is the bare ex2.approx instruction (dft::ex2).  Within a
//     warpgroup it overlaps the tensor cores: S_j and P_{j-1} V_{j-1} are
//     started together, the softmax of S_j runs while the PV product is
//     in flight, and O is rescaled to the new row maxima after it lands.
//   * Two CTAs of two warpgroups share an SM where registers allow
//     (d_pad <= 64), so one CTA's softmax also overlaps the other's products.
// fp32 inputs take csrc/flash_attention_f32.cu (split products on the
// tensor cores).
//
// K4, the head-packed forward (dft_flash_fwd with G > 1), replaces the Pallas
// kernel _fwd_kernel_packed (:178, via _fwd_packed :239, pallas_call :254):
// G heads per program, outputs bit-equal to K1's.  On the TPU packing
// shrinks the grid by G and hands Mosaic G independent chains to
// interleave.  Here the heads share no data, so packing pays only if a
// CTA's heads run at the same time: a CTA of the grid (ceil(Sq/(64*NWG)),
// BH/G) holds HG head groups of NWG warpgroups each, one head a group.
//   * Each head group runs K1's per-head arithmetic (the same helpers
//     below: 64-row warpgroups, 64-column K/V tiles in the same order, the
//     same ex2.approx FMA and masks), so O and lse are bit-equal to K1's at
//     any q tile.  Its Q rows go straight from device memory into the
//     wgmma A fragments (zero past Sq and d, as K1's TMA fills them), so Q
//     takes no shared memory.
//   * Each head group has its own ring of S K/V stages (K1's 128-byte
//     swizzled tiles) with an mbarrier a stage; the group's first thread
//     issues its TMA loads as K1's does, S-2 tiles ahead, and the group
//     synchronises only on its own named barrier (bar.sync 1 + group,
//     once a tile, where K1 has its __syncthreads), so the heads run
//     independently of each other.  A head dim that is not a multiple of
//     8 (no TMA) has the group copy its tiles with element loads.
//   * Shared memory sets HG and S: S = min(4, what fits HG rings), and HG
//     is the largest of 4, 2, 1 dividing G whose rings fit with S >= 2 and
//     that keeps K1's registers a thread (at most 4 warpgroups a CTA up to
//     d_pad 64, 2 above).  Where HG < G the CTA runs its heads in G/HG
//     rounds, still in one launch.  At d_pad 160 two heads fit only 2
//     stages; there tile j+1 is loaded into the stage that P_{j-1} V_{j-1}
//     frees mid-iteration.  A separate producer warp issuing every head's
//     loads cost those registers: ptxas serialised the wgmmas at d_pad 160
//     and refused two groups of two warpgroups there.
//   * The host sizes the q tile for the packed grid
//     (ops/flash_attention.py:packed_q_tile).
// It moves the same bytes and does the same operations as K1 (the same
// bound).  fp32 inputs run csrc/flash_attention_f32.cu's kernel with the G
// heads in turn.
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockN = 64;  // kv rows per shared-memory stage
constexpr int kSwizzle = 128;  // bytes: 64-column TMA boxes, the fewest requests
// K/V ring depth: tiles j-1 (its V read), j, and the tiles in flight; 3
// (one ahead) where 4 would not fit in shared memory
__host__ __device__ constexpr int kv_stages(int DP, int NWG) {
  return NWG == 2 && DP > 128 ? 3 : 4;
}

template <int DP, int NWG>
__host__ __device__ constexpr size_t bf16_tiles_bytes() {
  return sizeof(__nv_bfloat16) *
         (size_t)(dft::tile_elems(NWG * 64, DP, kSwizzle) +
                  2 * kv_stages(DP, NWG) * dft::tile_elems(64, DP, kSwizzle));
}
// the tiles (from a 1024-byte aligned base), then the mbarriers: Q's, then
// one a K/V stage
template <int DP, int NWG>
constexpr size_t bf16_smem_bytes() {
  return 1024 + bf16_tiles_bytes<DP, NWG>() + sizeof(uint64_t) * (1 + kv_stages(DP, NWG));
}

// --- the per-head arithmetic of K1, shared by K4 ---
//
// A warpgroup owns 64 q rows; its thread holds rows g and g + 8 of its warp
// (g = lane / 4, t = lane % 4), S of one 64-column tile in s[32], O in
// o[DP / 2], and P as bf16 A fragments in pa.

// S = Q K^T of the K tile `kt` (64 rows, swizzled by SW bytes), started
template <int DP, int SW>
__device__ __forceinline__ void start_s(float (&s)[kBlockN / 2], uint32_t (&qa)[DP / 16][4],
                                        const __nv_bfloat16* kt) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    dft::wgmma_rs<0>(s, qa[kc], dft::desc_kmajor<kBlockN, SW>(kt, kc), kc > 0);
  dft::wgmma_commit();
}
// O += P V of the V tile `vt`, started
template <int DP, int SW>
__device__ __forceinline__ void start_pv(float (&o)[DP / 2], uint32_t (&pa)[kBlockN / 16][4],
                                         const __nv_bfloat16* vt) {
#pragma unroll
  for (int kc = 0; kc < kBlockN / 16; ++kc)
    dft::wgmma_rs<1>(o, pa[kc], dft::desc_mnmajor<kBlockN, SW>(vt, kc), 1);
  dft::wgmma_commit();
}
// Online softmax of S (the tile at kv0) into P, in place; al0/al1 take O
// from the old row maxima to the new ones.  The row max is taken on the raw
// products (logit_scale > 0) and the scale folded into the exponent's FMA;
// only the ragged last tile is masked.
__device__ __forceinline__ void online_softmax(float (&s)[kBlockN / 2], int kv0, int skv, int t,
                                               float logit_scale, float& m0, float& m1,
                                               float& l0, float& l1, float& al0, float& al1) {
  if (kv0 + kBlockN > skv) {
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (kv0 + nt * 8 + 2 * t + jj >= skv) s[4 * nt + jj] = s[4 * nt + 2 + jj] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
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
  al0 = dft::ex2(m0 - mn0);
  al1 = dft::ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      s[4 * nt + jj] = dft::ex2(fmaf(s[4 * nt + jj], logit_scale, -mn0));
      s[4 * nt + 2 + jj] = dft::ex2(fmaf(s[4 * nt + 2 + jj], logit_scale, -mn1));
      rs0 += s[4 * nt + jj];
      rs1 += s[4 * nt + 2 + jj];
    }
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}
// O *= alpha, then P (fp32 in s) to bf16 A fragments
template <int DP>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DP / 2], uint32_t (&pa)[kBlockN / 16][4],
                                                 const float (&s)[kBlockN / 2], float al0,
                                                 float al1) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    o[4 * i] *= al0;
    o[4 * i + 1] *= al0;
    o[4 * i + 2] *= al1;
    o[4 * i + 3] *= al1;
  }
#pragma unroll
  for (int kc = 0; kc < kBlockN / 16; ++kc) {
    pa[kc][0] = dft::pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = dft::pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = dft::pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = dft::pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}
// O = acc / l (bf16) and lse = m + log2(l) of rows r0 and r0 + 8
template <int DP>
__device__ __forceinline__ void store_out(const float (&o)[DP / 2], float l0, float l1, float m0,
                                          float m1, __nv_bfloat16* __restrict__ ob,
                                          float* __restrict__ lseb, int r0, int sq, int d,
                                          int t) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = dt * 8 + 2 * t + jj;
      if (c < d) {
        if (r0 < sq) ob[(size_t)r0 * d + c] = __float2bfloat16(o[4 * dt + jj] * inv0);
        if (r1 < sq) ob[(size_t)r1 * d + c] = __float2bfloat16(o[4 * dt + 2 + jj] * inv1);
      }
    }
  }
  if (t == 0) {
    if (r0 < sq) lseb[r0] = m0 + log2f(l0);
    if (r1 < sq) lseb[r1] = m1 + log2f(l1);
  }
}

// One (head, NWG*64-row q tile) of K1.  qb/kb/vb/ob point at head bh's (sq,
// d) / (skv, d) matrices and lseb at its sq lse values; with d a multiple of
// 8 the tiles come by TMA through qmap/kmap/vmap (boxes of NWG*64 and 64
// rows) instead.
template <int DP, int NWG>
__device__ __forceinline__ void flash_fwd_bf16_head(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap, int bh,
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, __nv_bfloat16* __restrict__ ob,
    float* __restrict__ lseb, int q0, int sq, int skv, int d, float logit_scale,
    __nv_bfloat16* smem, uint64_t* bars) {
  constexpr int KC = DP / 16;        // k-chunks of the QK^T product
  constexpr int TILE = dft::tile_elems(kBlockN, DP, kSwizzle);  // elements of one K or V stage
  constexpr int NTHR = NWG * 128;
  constexpr int QR = NWG * 64;       // q rows of the CTA
  constexpr int kStages = kv_stages(DP, NWG);
  constexpr int PD = kStages - 2;    // tiles in flight ahead of the one multiplied
  __nv_bfloat16* Qs = smem;                                 // QR x DP
  __nv_bfloat16* Ks = Qs + dft::tile_elems(QR, DP, kSwizzle);        // kStages x (64 x DP)
  __nv_bfloat16* Vs = Ks + kStages * TILE;

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 7) * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int n_kv = (skv + kBlockN - 1) / kBlockN;
  const bool tma = (d & 7) == 0;  // 16-byte rows: TMA; else plain loads
  auto load_kv = [&](int j) {     // start copying K/V tile j into its stage
    const int st = j % kStages;
    __nv_bfloat16* kd = Ks + st * TILE;
    __nv_bfloat16* vd = Vs + st * TILE;
    if (tma) {
      if (tid == 0) {
        dft::fence_proxy_async();
        dft::mbar_expect_tx(&bars[1 + st], 2 * TILE * 2);
        dft::tma_load_tile<kBlockN, DP, kSwizzle>(kd, kmap, j * kBlockN, bh, &bars[1 + st]);
        dft::tma_load_tile<kBlockN, DP, kSwizzle>(vd, vmap, j * kBlockN, bh, &bars[1 + st]);
      }
    } else {
      dft::load_tile_elems<kBlockN, DP, kSwizzle>(kd, kb, j * kBlockN, skv, d, tid, NTHR);
      dft::load_tile_elems<kBlockN, DP, kSwizzle>(vd, vb, j * kBlockN, skv, d, tid, NTHR);
    }
  };
  auto wait_kv = [&](int j) {
    if (tma) dft::mbar_wait(&bars[1 + j % kStages], (j / kStages) & 1);
  };

  if (tma) {
    if (tid == 0) {
      dft::fence_proxy_async();
      dft::mbar_expect_tx(&bars[0], dft::tile_elems(QR, DP, kSwizzle) * 2);
      dft::tma_load_tile<QR, DP, kSwizzle>(Qs, qmap, q0, bh, &bars[0]);
    }
  } else {
    dft::load_tile_elems<QR, DP, kSwizzle>(Qs, qb, q0, sq, d, tid, NTHR);
  }
  for (int j = 0; j <= PD && j < n_kv; ++j) load_kv(j);  // tiles 0..PD in flight
  if (tma) {
    dft::mbar_wait(&bars[0], 0);
    wait_kv(0);
  }
  dft::fence_proxy_async();
  __syncthreads();

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = dft::ld_u32(Qs + dft::tile_off<QR, kSwizzle>(row0, 16 * kc + 2 * t));
    qa[kc][1] = dft::ld_u32(Qs + dft::tile_off<QR, kSwizzle>(row0 + 8, 16 * kc + 2 * t));
    qa[kc][2] = dft::ld_u32(Qs + dft::tile_off<QR, kSwizzle>(row0, 16 * kc + 8 + 2 * t));
    qa[kc][3] = dft::ld_u32(Qs + dft::tile_off<QR, kSwizzle>(row0 + 8, 16 * kc + 8 + 2 * t));
  }
  float s[kBlockN / 2];  // S of one tile (64 x 64 per warpgroup), then its P
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[kBlockN / 16][4];  // P (bf16) as A fragments: k-chunk kc = kv 16kc..16kc+15
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows row0 and row0 + 8

  float al0, al1;
  dft::fence_operands(s);
  dft::wgmma_fence();
  start_s<DP, kSwizzle>(s, qa, Ks);
  dft::wgmma_wait<0>();
  dft::fence_operands(s);
  online_softmax(s, 0, skv, t, logit_scale, m0, m1, l0, l1, al0, al1);
  rescale_and_pack<DP>(o, pa, s, al0, al1);

  // Iteration j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are both started; the
  // softmax of S_j runs while the PV product is still on the tensor cores,
  // and O is rescaled once that product is done (O then holds the tiles
  // before j at row maxima m_j).  Tile j+PD is copied meanwhile into the
  // stage tile j-2 (or j-1) used, free since the barrier.
  for (int j = 1; j < n_kv; ++j) {
    wait_kv(j);
    dft::fence_proxy_async();
    __syncthreads();  // tile j is in for every thread; no warpgroup still reads its stage
    if (j + PD < n_kv) load_kv(j + PD);
    dft::fence_operands(s);
    dft::fence_operands(o);
    dft::wgmma_fence();
    start_s<DP, kSwizzle>(s, qa, Ks + (j % kStages) * TILE);
    start_pv<DP, kSwizzle>(o, pa, Vs + ((j - 1) % kStages) * TILE);
    dft::wgmma_wait<1>();  // S_j
    dft::fence_operands(s);
    online_softmax(s, j * kBlockN, skv, t, logit_scale, m0, m1, l0, l1, al0, al1);
    dft::wgmma_wait<0>();  // P_{j-1} V_{j-1}
    dft::fence_operands(o);
    rescale_and_pack<DP>(o, pa, s, al0, al1);
  }
  dft::fence_operands(o);
  dft::wgmma_fence();
  start_pv<DP, kSwizzle>(o, pa, Vs + ((n_kv - 1) % kStages) * TILE);
  dft::wgmma_wait<0>();
  dft::fence_operands(o);
  store_out<DP>(o, l0, l1, m0, m1, ob, lseb, q0 + row0, sq, d, t);
}

// Two CTAs of two warpgroups an SM where registers allow (d_pad <= 64):
// one CTA's softmax then overlaps the other's products.
constexpr int min_blocks(int DP, int NWG) { return NWG == 2 && DP <= 64 ? 2 : 1; }

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128, min_blocks(DP, NWG))
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int sq, int skv, int d, float logit_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the tiles' 1024-byte aligned base (the swizzle's period), then the barriers
  auto* smem = reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bf16_tiles_bytes<DP, NWG>() / 2);
  if ((d & 7) == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 1 + kv_stages(DP, NWG); ++i) dft::mbar_init(&bars[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();
  const int bh = blockIdx.y;
  flash_fwd_bf16_head<DP, NWG>(&qmap, &kmap, &vmap, bh, q + (size_t)bh * sq * d,
                               k + (size_t)bh * skv * d, v + (size_t)bh * skv * d,
                               o + (size_t)bh * sq * d, lse + (size_t)bh * sq,
                               blockIdx.x * NWG * 64, sq, skv, d, logit_scale, smem, bars);
}

// --- K4 ---

// bytes of one K/V stage (a K and a V tile of 64 rows)
__host__ __device__ constexpr int packed_stage_bytes(int DP) {
  return 2 * 2 * dft::tile_elems(kBlockN, DP, kSwizzle);
}
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may have on the H100
// ring stages of each of HG head groups: as many as fit, at most 4 (after
// the 1024-byte alignment and 16 bytes a stage for its barrier)
__host__ __device__ constexpr int packed_stages(int DP, int HG) {
  return (kSmemMax - 1024) / (HG * (packed_stage_bytes(DP) + 16)) < 4
             ? (kSmemMax - 1024) / (HG * (packed_stage_bytes(DP) + 16))
             : 4;
}
template <int DP, int HG>
constexpr size_t packed_smem_bytes() {
  return 1024 + (size_t)HG * packed_stages(DP, HG) * (packed_stage_bytes(DP) + 16);
}
// HG head groups of NWG warpgroups fit a CTA, with rings of at least 2
// stages and K1's registers a thread: 4 warpgroups a CTA up to d_pad 64
// (K1 runs 2 CTAs of 2 there, at most 128 registers a thread), else 2
// (K1: one CTA of at most 2, up to 255)
__host__ __device__ constexpr bool packed_fits(int DP, int NWG, int HG) {
  return HG * NWG <= (DP <= 64 ? 4 : 2) && packed_stages(DP, HG) >= 2;
}

// One (head, NWG*64-row q tile) of K4, run by one head group (`tid` its
// thread, 0..NWG*128-1; `bar_id` its named barrier) on its own ring: Ks
// holds stage st's K tile at 2*st*TILE and its V tile TILE on, `full` the
// stages' mbarriers.  seq0 tiles of the ring went through it before
// (earlier rounds).  The arithmetic is K1's, step for step.
template <int DP, int NWG, int S>
__device__ __forceinline__ void packed_head(
    const CUtensorMap* kmap, const CUtensorMap* vmap, int bh,
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, __nv_bfloat16* __restrict__ ob,
    float* __restrict__ lseb, int q0, int sq, int skv, int d, float logit_scale,
    __nv_bfloat16* Ks, uint64_t* full, int seq0, int tid, int bar_id) {
  constexpr int SW = kSwizzle;
  constexpr int KC = DP / 16;
  constexpr int TILE = dft::tile_elems(kBlockN, DP, SW);
  constexpr int NTHR = NWG * 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 7) * 64 + warp * 16 + g;
  const int n_kv = (skv + kBlockN - 1) / kBlockN;
  const bool tma = (d & 7) == 0;
  auto kt = [&](int j) { return Ks + ((seq0 + j) % S) * 2 * TILE; };
  // start copying tile j into its stage: TMA from the group's first thread,
  // else element loads by the whole group (complete on return)
  auto load_kv = [&](int j) {
    if (tma) {
      if (tid == 0) {
        uint64_t* bar = &full[(seq0 + j) % S];
        dft::mbar_expect_tx(bar, 2 * TILE * 2);
        dft::tma_load_tile<kBlockN, DP, SW>(kt(j), kmap, j * kBlockN, bh, bar);
        dft::tma_load_tile<kBlockN, DP, SW>(kt(j) + TILE, vmap, j * kBlockN, bh, bar);
      }
    } else {
      dft::load_tile_elems<kBlockN, DP, SW>(kt(j), kb, j * kBlockN, skv, d, tid, NTHR);
      dft::load_tile_elems<kBlockN, DP, SW>(kt(j) + TILE, vb, j * kBlockN, skv, d, tid, NTHR);
    }
  };
  // With 3 or more stages the loads go as K1's, S-2 tiles ahead from the
  // barrier that opens each iteration; with 2 (d_pad 160, two heads) tile
  // j+1 goes, S-1 ahead, into the stage P_{j-1} V_{j-1} frees mid-iteration
  constexpr bool kEarly = S >= 3;

  // Q (rows q0 + row0, + 8) as A fragments, read from device memory
  auto ldq = [&](int r, int c) -> uint32_t {
    if (r >= sq || c >= d) return 0u;
    const __nv_bfloat16* p = qb + (size_t)r * d + c;
    if ((d & 1) == 0) return dft::ld_u32(p);  // c even: c + 1 < d
    const uint32_t lo = __bfloat16_as_ushort(p[0]);
    const uint32_t hi = c + 1 < d ? __bfloat16_as_ushort(p[1]) : 0u;
    return lo | (hi << 16);
  };
  uint32_t qa[KC][4];
  const int r0 = q0 + row0;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = ldq(r0, 16 * kc + 2 * t);
    qa[kc][1] = ldq(r0 + 8, 16 * kc + 2 * t);
    qa[kc][2] = ldq(r0, 16 * kc + 8 + 2 * t);
    qa[kc][3] = ldq(r0 + 8, 16 * kc + 8 + 2 * t);
  }
  dft::bar_sync(bar_id, NTHR);  // the group's previous round no longer reads the ring
  for (int j = 0; j < (kEarly ? S - 1 : S) && j < n_kv; ++j) load_kv(j);
  float s[kBlockN / 2];
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[kBlockN / 16][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  float al0, al1;
  if (tma) {
    dft::mbar_wait(&full[seq0 % S], (seq0 / S) & 1);
  } else {
    dft::fence_proxy_async();
    dft::bar_sync(bar_id, NTHR);
  }
  dft::fence_operands(s);
  dft::wgmma_fence();
  start_s<DP, SW>(s, qa, kt(0));
  dft::wgmma_wait<0>();
  dft::fence_operands(s);
  online_softmax(s, 0, skv, t, logit_scale, m0, m1, l0, l1, al0, al1);
  rescale_and_pack<DP>(o, pa, s, al0, al1);
  // Iteration j as K1's, the group's named barrier in place of K1's
  // __syncthreads
  for (int j = 1; j < n_kv; ++j) {
    if (tma) dft::mbar_wait(&full[(seq0 + j) % S], ((seq0 + j) / S) & 1);
    if (kEarly || !tma) {
      dft::fence_proxy_async();
      dft::bar_sync(bar_id, NTHR);
    }
    if (kEarly && j + S - 2 < n_kv) load_kv(j + S - 2);
    dft::fence_operands(s);
    dft::fence_operands(o);
    dft::wgmma_fence();
    start_s<DP, SW>(s, qa, kt(j));
    start_pv<DP, SW>(o, pa, kt(j - 1) + TILE);
    dft::wgmma_wait<1>();  // S_j
    dft::fence_operands(s);
    online_softmax(s, j * kBlockN, skv, t, logit_scale, m0, m1, l0, l1, al0, al1);
    dft::wgmma_wait<0>();  // P_{j-1} V_{j-1}
    dft::fence_operands(o);
    if (!kEarly && j + S - 1 < n_kv) {
      dft::bar_sync(bar_id, NTHR);
      load_kv(j + S - 1);
    }
    rescale_and_pack<DP>(o, pa, s, al0, al1);
  }
  dft::fence_operands(o);
  dft::wgmma_fence();
  start_pv<DP, SW>(o, pa, kt(n_kv - 1) + TILE);
  dft::wgmma_wait<0>();
  dft::fence_operands(o);
  store_out<DP>(o, l0, l1, m0, m1, ob, lseb, r0, sq, d, t);
}

// Heads blockIdx.y * G + r * HG + h (head group h, round r < G / HG) of q
// tile blockIdx.x; HG head groups of NWG*128 threads.
template <int DP, int NWG, int HG>
__global__ void __launch_bounds__(HG * NWG * 128, 1)
    flash_fwd_bf16_packed_kernel(const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
                                 int skv, int d, float logit_scale, int G) {
  constexpr int S = packed_stages(DP, HG);
  constexpr int TILE = dft::tile_elems(kBlockN, DP, kSwizzle);
  constexpr int NTHR = NWG * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // head group h's ring at 2*S*TILE*h (1024-byte aligned), then the barriers
  auto* ring = reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + HG * 2 * S * TILE);  // [h][S]
  if ((d & 7) == 0 && threadIdx.x == 0) {
    for (int i = 0; i < HG * S; ++i) dft::mbar_init(&full[i], 1);
    dft::mbar_init_fence();
  }
  __syncthreads();  // the last CTA-wide barrier: head groups go on alone
  const int n_kv = (skv + kBlockN - 1) / kBlockN;
  const int group = threadIdx.x / NTHR, tid = threadIdx.x % NTHR;
  for (int r = 0; r < G / HG; ++r) {
    const int bh = blockIdx.y * G + r * HG + group;
    packed_head<DP, NWG, S>(&kmap, &vmap, bh, q + (size_t)bh * sq * d, k + (size_t)bh * skv * d,
                            v + (size_t)bh * skv * d, o + (size_t)bh * sq * d,
                            lse + (size_t)bh * sq, blockIdx.x * NWG * 64, sq, skv, d,
                            logit_scale, ring + group * 2 * S * TILE, full + group * S,
                            r * n_kv, tid, 1 + group);
  }
}

// K1: one head a CTA, NWG*64 q rows.
template <int DP, int NWG>
cudaError_t launch_bf16_tile(const void* q, const void* k, const void* v, void* o, float* lse,
                             int bh, int sq, int skv, int d, float logit_scale,
                             cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<DP, NWG>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qm{}, km{}, vm{};  // unused (zero) when d is not a multiple of 8
  if ((d & 7) == 0 && !(dft::make_tile_map(&qm, q, bh, sq, d, NWG * 64, kSwizzle) &&
                        dft::make_tile_map(&km, k, bh, skv, d, kBlockN, kSwizzle) &&
                        dft::make_tile_map(&vm, v, bh, skv, d, kBlockN, kSwizzle)))
    return cudaErrorNotSupported;
  const dim3 grid((sq + NWG * 64 - 1) / (NWG * 64), bh);
  flash_fwd_bf16_kernel<DP, NWG><<<grid, NWG * 128, smem, stream>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, skv, d,
      logit_scale);
  return cudaGetLastError();
}

// K4: G heads a CTA, HG of them at a time, NWG*64 q rows.
template <int DP, int NWG, int HG>
cudaError_t launch_packed(const void* q, const void* k, const void* v, void* o, float* lse,
                          int bh, int sq, int skv, int d, float logit_scale, int G,
                          cudaStream_t stream) {
  constexpr size_t smem = packed_smem_bytes<DP, HG>();
  static_assert(smem <= kSmemMax, "K4's rings do not fit");
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_packed_kernel<DP, NWG, HG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap km{}, vm{};  // unused (zero) when d is not a multiple of 8
  if ((d & 7) == 0 && !(dft::make_tile_map(&km, k, bh, skv, d, kBlockN, kSwizzle) &&
                        dft::make_tile_map(&vm, v, bh, skv, d, kBlockN, kSwizzle)))
    return cudaErrorNotSupported;
  const dim3 grid((sq + NWG * 64 - 1) / (NWG * 64), bh / G);
  flash_fwd_bf16_packed_kernel<DP, NWG, HG><<<grid, HG * NWG * 128, smem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, skv, d,
      logit_scale, G);
  return cudaGetLastError();
}

// HG: the most heads of G (4, 2 or 1, dividing G) whose rings and threads fit
template <int DP, int NWG>
cudaError_t launch_packed_groups(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int bh, int sq, int skv, int d, float logit_scale,
                                 int G, cudaStream_t stream) {
  if constexpr (packed_fits(DP, NWG, 4)) {
    if (G % 4 == 0)
      return launch_packed<DP, NWG, 4>(q, k, v, o, lse, bh, sq, skv, d, logit_scale, G, stream);
  }
  if constexpr (packed_fits(DP, NWG, 2)) {
    if (G % 2 == 0)
      return launch_packed<DP, NWG, 2>(q, k, v, o, lse, bh, sq, skv, d, logit_scale, G, stream);
  }
  static_assert(packed_fits(DP, NWG, 1), "one head group must fit");
  return launch_packed<DP, NWG, 1>(q, k, v, o, lse, bh, sq, skv, d, logit_scale, G, stream);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int sq, int skv, int d, float logit_scale, int G, int q_tile,
                        cudaStream_t stream) {
  if (q_tile != 64 && q_tile != 128) return cudaErrorInvalidValue;
  if (G == 1)
    return q_tile == 64
               ? launch_bf16_tile<DP, 1>(q, k, v, o, lse, bh, sq, skv, d, logit_scale, stream)
               : launch_bf16_tile<DP, 2>(q, k, v, o, lse, bh, sq, skv, d, logit_scale, stream);
  return q_tile == 64 ? launch_packed_groups<DP, 1>(q, k, v, o, lse, bh, sq, skv, d,
                                                    logit_scale, G, stream)
                      : launch_packed_groups<DP, 2>(q, k, v, o, lse, bh, sq, skv, d,
                                                    logit_scale, G, stream);
}

}  // namespace

// q (bh, sq, d), k/v (bh, skv, d), o like q, lse (bh, sq) fp32; all contiguous.
// dtype: 1 = bf16 (fp32 inputs: dft_flash_fwd_f32).  G heads per CTA: 1 runs
// K1, G > 1 (dividing bh) runs K4, whose O and lse are bit-equal to K1's at
// the same q_tile.  q_tile: q rows per CTA, 64 or 128 (one or two
// warpgroups).  Returns the launch's cudaError_t (0 = launched).
extern "C" int dft_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int sq, int skv, int d, float scale, int dtype, int G,
                             int q_tile, void* stream) {
  const float logit_scale = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (G < 1 || bh % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
#define DFT_FWD_CASE(DP) \
  case DP:               \
    return launch_bf16<DP>(q, k, v, o, l, bh, sq, skv, d, logit_scale, G, q_tile, st)
    switch ((d + 15) / 16 * 16) {
      DFT_FWD_CASE(16);
      DFT_FWD_CASE(32);
      DFT_FWD_CASE(48);
      DFT_FWD_CASE(64);
      DFT_FWD_CASE(80);
      DFT_FWD_CASE(96);
      DFT_FWD_CASE(112);
      DFT_FWD_CASE(128);
      DFT_FWD_CASE(144);
      DFT_FWD_CASE(160);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DFT_FWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
