// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2), dQ (K3).
//
// Replaces the Pallas TPU kernels of veomni_tpu/ops/pallas/flash_attention.py:
//   K1 flash_fwd_tma_kernel <- _fwd_kernel      (:49-106, launched by _fwd :109)
//   K2 flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (:155-205, launched by _bwd :255)
//   K3 flash_bwd_dq_kernel  <- _bwd_dq_kernel   (:208-252, launched by _bwd :255)
//
// What they compute (same as the Pallas kernels): causal or full attention
// over packed sequences, where a query attends only to keys of its own
// segment id; GQA maps q head h to kv head h / (Hq / Hkv) without copying
// K/V. Scores and softmax are f32; the forward writes O (bf16) and the row
// log-sum-exp (f32); the backward recomputes P = exp(S - LSE) and uses
// delta = rowsum(dO * O), which the caller computes in plain torch as the
// reference does in XLA. A query row with no visible key gives O = 0 and
// LSE = -1e30; the backward treats such a row's LSE as 0 (reference :188).
//
// Layout: q/o/dq [B,S,Hq,D], k/v/dk/dv [B,S,Hkv,D] contiguous bf16 (the
// facade layout, so the reference wrapper's [B,S,H,D] <-> [B,H,S,D] swaps are
// not copies here), seg [B,S] int32, lse/delta [B,Hq,S] f32, seg_rng
// [B,S/32,2] int32 (per 32-token block: min and max segment id). D = 128.
//
// What bounds them on the H100: at S = 4096 every kernel does ~100-200
// FLOPs per byte it must move, so the tensor cores bound them (989 TFLOP/s
// bf16 dense) and the design goal is to keep S and P on chip and the tensor
// cores fed:
//   * the sequential k-block grid axis of the TPU kernel, which carries the
//     online-softmax state in VMEM scratch, becomes a loop inside one CTA;
//     the running max, sum and f32 accumulator live in registers;
//   * packed rows hold several documents, and a tile pair whose segment-id
//     ranges do not overlap has no visible (query, key) pair: it is skipped
//     (its contribution is exactly zero, so results are unchanged). The
//     caller passes each 32-token block's [min, max] segment id;
//   * causal loops stop at the diagonal, and the grids start the heaviest
//     (last) q tiles first to shorten the tail.
// K1 (flash_fwd_tma_kernel) is built from csrc/hopper.cuh like the grouped
// GEMMs: a 128-row q tile per block on two consumer warpgroups of 64 rows
// and one producer thread (setmaxnreg moves the registers). Q, K, V and O
// are 2-D tensor maps over [B*S, H*128] in boxes of 64 head dims (S % 128 ==
// 0, so a 128-row box never straddles two batch rows); Q is loaded once, K
// and V in 128-key tiles through a 2-stage ring of mbarriers (K and V on
// barriers of their own, so Q K^T starts before V lands; ~161 KB of shared
// memory). S = Q K^T is wgmma m64n128k16 with both operands K-major; the
// online softmax runs in the accumulator layout with exp2f (scale * log2 e
// folded in) and quad shuffles; P goes to bf16 in registers and is wgmma's
// register A operand for O += P V, with V MN-major (the transpose flag). The
// per-element mask (causal order, equal segment ids) runs only on tiles
// that reach past the diagonal or whose q rows and keys are not all one
// segment; producer and consumers walk one list of k tiles (walk_k_tiles).
// O / l leaves through the warpgroup's Q boxes by TMA stores.
// K2 and K3 are the first port's kernels: each warp owns 16 rows and issues
// mma.sync m16n8k16 with the S accumulator reused in registers as the A
// operand; K2 loops over the q heads of one kv group inside the CTA, so
// dK/dV are summed over the group on chip and written once in bf16 (the
// reference writes per-q-head f32 dK/dV and group-sums them in XLA,
// :297-299). Their redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int D = 128;        // head dim
constexpr int LD = D + 8;     // padded smem row (bf16): 68 words, conflict-free fragments
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG = -1e30f;

// dq (K3): 64 q rows per CTA (16 per warp), 64-key tiles
constexpr int FQ = 64;
constexpr int FK = 64;
// dkv: 64 keys per CTA (16 per warp), 32-query tiles
constexpr int BK2 = 64;
constexpr int BQ2 = 32;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16 lo, const __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment (16x16, row-major) of rows r0..r0+15, cols c0..c0+15 of an smem tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s, int r0, int c0,
                                       int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * LD + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (16x8) where B[k][n] = s[n0 + n][k0 + k]  (B = tile^T; consecutive in k)
__device__ __forceinline__ void load_bt(uint32_t b[2], const __nv_bfloat16* s, int n0, int k0,
                                        int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16x8) where B[k][n] = s[k0 + k][n0 + n]  (B = tile; strided in k)
__device__ __forceinline__ void load_b(uint32_t b[2], const __nv_bfloat16* s, int k0, int n0,
                                       int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * LD + n0 + g;
  b[0] = pack_bf16(p[0], p[LD]);
  b[1] = pack_bf16(p[8 * LD], p[9 * LD]);
}

// rows x D tile of a [B,S,H,D] tensor (rows along S) into padded smem.
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk, bool causal) {
  return sq == sk && (!causal || qi >= kj);
}

constexpr int RB = 32;  // tokens per segment-range block (vt_seg_range_block)

// [lo, hi] segment-id range of tokens [t0, t0 + n) of row b (n a multiple of RB)
__device__ __forceinline__ int2 seg_range(const int* rng, int b, int S, int t0, int n) {
  const int* r = rng + ((int64_t)b * (S / RB) + t0 / RB) * 2;
  int2 out = make_int2(r[0], r[1]);
  for (int i = 1; i < n / RB; ++i) {
    out.x = min(out.x, r[2 * i]);
    out.y = max(out.y, r[2 * i + 1]);
  }
  return out;
}

__device__ __forceinline__ bool disjoint(int2 a, int2 b) { return a.y < b.x || b.y < a.x; }

// ---------------------------------------------------------------- K1 forward
// K1 is the Hopper design (TMA, an mbarrier ring, wgmma, warp roles); K2 and
// K3 below are still the first port's mma.sync kernels.
constexpr int KV_TILE = 128;         // keys per K/V tile
constexpr int FWD_CW = 2;            // consumer warpgroups: 64 q rows each
constexpr int KV_STAGES = 2;
constexpr int Q_BOX = 64 * 128;      // one 64-row x 64-column box of Q (or O), bytes
constexpr int KV_BOX = KV_TILE * 128;  // one 128-key x 64-column box of K or V
constexpr int KV_STAGE = 4 * KV_BOX;   // a stage: K's two boxes, then V's
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int CW>
struct FwdTile {
  static constexpr int BQ = 64 * CW;         // q rows per block
  static constexpr int THREADS = 128 * (CW + 1);
  static constexpr int Q_BYTES = CW * 2 * Q_BOX;
  // 1024 bytes of alignment slack, Q (O staged in its place), the ring, then
  // the barriers: Q's, and per stage K full, V full, empty
  static constexpr size_t SMEM = 1024 + Q_BYTES + KV_STAGES * KV_STAGE + 8 * (1 + 3 * KV_STAGES);
};

// The k tiles that q rows [q0, q0 + bq) of row b see, in order: tile(k0,
// masked) for each tile whose segment range meets the q rows' (a pair of
// disjoint ranges has no visible (query, key) pair and is skipped); masked
// is true where the per-element mask is needed: the tile reaches past the
// causal diagonal, or the q rows and the keys are not all of one and the
// same segment. The producer and the consumers walk the same list.
template <typename Tile>
__device__ __forceinline__ void walk_k_tiles(const int* rng, int b, int S, int q0, int bq,
                                             bool causal, Tile tile) {
  const int2 qr = seg_range(rng, b, S, q0, bq);
  const int nk = causal ? (q0 + bq - 1) / KV_TILE + 1 : S / KV_TILE;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * KV_TILE;
    const int2 kr = seg_range(rng, b, S, k0, KV_TILE);
    if (disjoint(qr, kr)) continue;  // no visible pair
    const bool masked = (causal && k0 + KV_TILE - 1 > q0) || qr.x != qr.y || kr.x != qr.x || kr.y != qr.x;
    tile(k0, masked);
  }
}

// grid (Hq, B, S / BQ), the last (heaviest causal) q tiles first; block
// FwdTile<CW>::THREADS: warpgroup 0 the producer, 1..CW the consumers.
// tm_q, tm_o: [B*S, Hq*128] in 64 x 64 boxes; tm_k, tm_v: [B*S, Hkv*128] in
// 128 x 64 boxes.
template <int CW>
__global__ void __launch_bounds__(FwdTile<CW>::THREADS, 1)
flash_fwd_tma_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_o,
                     const int* __restrict__ seg, const int* __restrict__ seg_rng,
                     float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal) {
  typedef FwdTile<CW> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023) & ~1023u;  // box (warpgroup w, half j) at (2w + j) Q_BOX
  const uint32_t ring = q_smem + T::Q_BYTES;       // stage s at s KV_STAGE
  const uint32_t q_full = ring + KV_STAGES * KV_STAGE;
  const uint32_t k_full = q_full + 8;               // stage s: + 8 s
  const uint32_t v_full = k_full + 8 * KV_STAGES;
  const uint32_t empty = v_full + 8 * KV_STAGES;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * T::BQ;  // heaviest causal tiles first
  const int hk = h / (Hq / Hkv);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CW);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads Q once, then K and V tile by tile
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_k = &tm_k;
      const CUtensorMap* map_v = &tm_v;
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int w = 0; w < CW; ++w)
        for (int j = 0; j < 2; ++j)
          tma_load_2d(q_smem + (2 * w + j) * Q_BOX, &tm_q, q_full, h * D + 64 * j, b * S + q0 + 64 * w);
      int stage = 0;
      uint32_t phase = 0;
      walk_k_tiles(seg_rng, b, S, q0, T::BQ, causal, [&](int k0, bool) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * KV_STAGE;
        mbar_arrive_expect_tx(k_full + 8 * stage, 2 * KV_BOX);
        tma_load_2d(st, map_k, k_full + 8 * stage, hk * D, b * S + k0);
        tma_load_2d(st + KV_BOX, map_k, k_full + 8 * stage, hk * D + 64, b * S + k0);
        mbar_arrive_expect_tx(v_full + 8 * stage, 2 * KV_BOX);
        tma_load_2d(st + 2 * KV_BOX, map_v, v_full + 8 * stage, hk * D, b * S + k0);
        tma_load_2d(st + 3 * KV_BOX, map_v, v_full + 8 * stage, hk * D + 64, b * S + k0);
        if (++stage == KV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw ..
    setmaxnreg_inc<CW == 2 ? 232 : 240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r0 = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // fragment rows r0, r0 + 8 of the 64
    const int qi0 = q0 + 64 * cw + r0, qi1 = qi0 + 8;
    const int* segb = seg + (int64_t)b * S;
    const int sq0 = segb[qi0], sq1 = segb[qi1];
    const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 instead of exp
    const uint32_t qa = q_smem + 2 * cw * Q_BOX;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // running max (log2 units), partial sums
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    walk_k_tiles(seg_rng, b, S, q0, T::BQ, causal, [&](int k0, bool masked) {
      const uint32_t st = ring + stage * KV_STAGE;
      // S = Q K^T: both K-major; 16 head dims (32 bytes of a swizzled row) per
      // step. The first step ignores s (scale_d 0), so no value of s lives
      // from one tile to the next.
      float s[64];
      mbar_wait(k_full + 8 * stage, phase);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = 32 * (kd % 4);
        wgmma_m64n128k16<0>(s, wgmma_desc(qa + (kd / 4) * Q_BOX + off, 16, 1024),
                            wgmma_desc(st + (kd / 4) * KV_BOX + off, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // online softmax in the accumulator layout: this thread holds rows r0
      // (s[4j], s[4j+1]) and r0 + 8 (s[4j+2], s[4j+3]), keys 8j + 2t (+1)
      float mx0 = NEG, mx1 = NEG;
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int kj = k0 + 8 * j + 2 * t;
          const int2 sk = *reinterpret_cast<const int2*>(segb + kj);
          s[4 * j + 0] = visible(qi0, kj, sq0, sk.x, causal) ? s[4 * j + 0] * sl2 : NEG;
          s[4 * j + 1] = visible(qi0, kj + 1, sq0, sk.y, causal) ? s[4 * j + 1] * sl2 : NEG;
          s[4 * j + 2] = visible(qi1, kj, sq1, sk.x, causal) ? s[4 * j + 2] * sl2 : NEG;
          s[4 * j + 3] = visible(qi1, kj + 1, sq1, sk.y, causal) ? s[4 * j + 3] * sl2 : NEG;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= sl2;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
      if (masked) {  // a masked key holds NEG: its P is 0 even while the row's max is NEG
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          s[4 * j + 0] = s[4 * j + 0] > 0.5f * NEG ? exp2f(s[4 * j + 0] - mn0) : 0.f;
          s[4 * j + 1] = s[4 * j + 1] > 0.5f * NEG ? exp2f(s[4 * j + 1] - mn0) : 0.f;
          s[4 * j + 2] = s[4 * j + 2] > 0.5f * NEG ? exp2f(s[4 * j + 2] - mn1) : 0.f;
          s[4 * j + 3] = s[4 * j + 3] > 0.5f * NEG ? exp2f(s[4 * j + 3] - mn1) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          s[4 * j + 0] = exp2f(s[4 * j + 0] - mn0);
          s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
          s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
          s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // O += P V: P in bf16 registers (A), V MN-major (B, head dims
      // contiguous: two 64-column blocks KV_BOX apart), 16 keys per step
      uint32_t p[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        p[4 * kk + 0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(v_full + 8 * stage, phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_TILE / 16; ++kk)
        wgmma_m64n128k16_rs<1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                               wgmma_desc(st + 2 * KV_BOX + 2048 * kk, KV_BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage's K and V are consumed
      if (++stage == KV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    });

    // Epilogue: O / l in bf16 into this warpgroup's Q boxes (its Q is no
    // longer read) in the 128-byte swizzle, then two TMA stores; the LSE
    // in natural-log units. A row with no visible key: O = 0, LSE = NEG.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    unsigned char* ob = smem_raw + (qa - raw);
    const int sw = r0 & 7;  // the same for r0 + 8
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      unsigned char* pj = ob + (j / 8) * Q_BOX + ((j & 7) ^ sw) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(pj + r0 * 128) = pack_f32(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(pj + (r0 + 8) * 128) =
          pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    fence_proxy_async();
    if (cw == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < 2; ++j) tma_store_2d(&tm_o, qa + j * Q_BOX, h * D + 64 * j, b * S + q0 + 64 * cw);
      bulk_commit();
      bulk_wait<0>();  // the block's shared memory outlives the stores
    }
    if (t == 0) {
      float* lrow = lse + ((int64_t)b * Hq + h) * S;
      lrow[qi0] = l0 == 0.f ? NEG : (m0 + log2f(l0)) * LN2;
      lrow[qi1] = l1 == 0.f ? NEG : (m1 + log2f(l1)) * LN2;
    }
  }
}

template <int CW>
int launch_flash_fwd(const void* q, const void* k, const void* v, const void* seg, const void* seg_rng,
                     void* o, void* lse, int B, int S, int Hq, int Hkv, float scale, int causal,
                     cudaStream_t stream) {
  typedef FwdTile<CW> T;
  // a runtime call first: it makes the device's context current on this
  // thread, which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tma_kernel<CW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const uint64_t rows = (uint64_t)B * S;
  int err = encode_bf16_2d(&tm_q, q, rows, (uint64_t)Hq * D, 64, 64);
  if (!err) err = encode_bf16_2d(&tm_o, o, rows, (uint64_t)Hq * D, 64, 64);
  if (!err) err = encode_bf16_2d(&tm_k, k, rows, (uint64_t)Hkv * D, KV_TILE, 64);
  if (!err) err = encode_bf16_2d(&tm_v, v, rows, (uint64_t)Hkv * D, KV_TILE, 64);
  if (err) return err;
  dim3 grid(Hq, B, S / T::BQ);
  flash_fwd_tma_kernel<CW><<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, (const int*)seg, (const int*)seg_rng, (float*)lse, S, Hq, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K3 dQ
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                    const int* __restrict__ seg_rng, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    int S, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + FQ * LD;
  __nv_bfloat16* Ks = dOs + FQ * LD;
  __nv_bfloat16* Vs = Ks + FK * LD;
  int* segk = reinterpret_cast<int*>(Vs + FK * LD);

  const int nq = S / FQ;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * FQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qstride = (int64_t)Hq * D, kstride = (int64_t)Hkv * D;

  load_tile<FQ>(Qs, q + ((int64_t)b * S + q0) * qstride + (int64_t)h * D, qstride);
  load_tile<FQ>(dOs, dout + ((int64_t)b * S + q0) * qstride + (int64_t)h * D, qstride);

  const int r_lo = warp * 16 + g;
  const int qi0 = q0 + r_lo, qi1 = qi0 + 8;
  const int sq0 = seg[(int64_t)b * S + qi0], sq1 = seg[(int64_t)b * S + qi1];
  const float* lrow = lse + ((int64_t)b * Hq + h) * S;
  const float* drow = delta + ((int64_t)b * Hq + h) * S;
  float ls0 = lrow[qi0], ls1 = lrow[qi1];
  ls0 = ls0 <= 0.5f * NEG ? 0.f : ls0;
  ls1 = ls1 <= 0.5f * NEG ? 0.f : ls1;
  const float dl0 = drow[qi0], dl1 = drow[qi1];

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int2 qr = seg_range(seg_rng, b, S, q0, FQ);
  const int nk = causal ? (q0 + FQ - 1) / FK + 1 : S / FK;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * FK;
    if (disjoint(qr, seg_range(seg_rng, b, S, k0, FK))) continue;  // uniform over the CTA
    __syncthreads();
    load_tile<FK>(Ks, k + ((int64_t)b * S + k0) * kstride + (int64_t)hk * D, kstride);
    load_tile<FK>(Vs, v + ((int64_t)b * S + k0) * kstride + (int64_t)hk * D, kstride);
    for (int i = threadIdx.x; i < FK; i += NTHREADS) segk[i] = seg[(int64_t)b * S + k0 + i];
    __syncthreads();

    float s[FK / 8][4], dp[FK / 8][4];
#pragma unroll
    for (int n = 0; n < FK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4], ad[4];
      load_a(a, Qs, warp * 16, kd * 16, g, t);
      load_a(ad, dOs, warp * 16, kd * 16, g, t);
#pragma unroll
      for (int n = 0; n < FK / 8; ++n) {
        uint32_t bb[2];
        load_bt(bb, Ks, n * 8, kd * 16, g, t);
        mma16816(s[n], a, bb);
        load_bt(bb, Vs, n * 8, kd * 16, g, t);
        mma16816(dp[n], ad, bb);
      }
    }
    // dS = P * (dP - delta) * scale, with P = exp(S * scale - LSE) on visible keys
#pragma unroll
    for (int n = 0; n < FK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int kj = k0 + col;
        const bool lo = e < 2;
        const bool vis = lo ? visible(qi0, kj, sq0, segk[col], causal)
                            : visible(qi1, kj, sq1, segk[col], causal);
        const float p = vis ? expf(s[n][e] * scale - (lo ? ls0 : ls1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (lo ? dl0 : dl1)) * scale;
      }
    }
    // dQ += dS @ K
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t bb[2];
        load_b(bb, Ks, kk * 16, nd * 8, g, t);
        mma16816(acc[nd], a, bb);
      }
    }
  }

  __nv_bfloat16* d0 = dq + ((int64_t)b * S + qi0) * qstride + (int64_t)h * D;
  __nv_bfloat16* d1 = dq + ((int64_t)b * S + qi1) * qstride + (int64_t)h * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(d0 + col) = pack_f32(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<uint32_t*>(d1 + col) = pack_f32(acc[nd][2], acc[nd][3]);
  }
}

// ---------------------------------------------------------------- K2 dK, dV
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ seg_rng, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int Hq, int Hkv, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK2 * LD;
  __nv_bfloat16* Qs = Vs + BK2 * LD;
  __nv_bfloat16* dOs = Qs + BQ2 * LD;
  float* lses = reinterpret_cast<float*>(dOs + BQ2 * LD);
  float* dls = lses + BQ2;
  int* segq = reinterpret_cast<int*>(dls + BQ2);

  const int jk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = jk * BK2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qstride = (int64_t)Hq * D, kstride = (int64_t)Hkv * D;

  load_tile<BK2>(Ks, k + ((int64_t)b * S + k0) * kstride + (int64_t)hk * D, kstride);
  load_tile<BK2>(Vs, v + ((int64_t)b * S + k0) * kstride + (int64_t)hk * D, kstride);

  const int kj0 = k0 + warp * 16 + g, kj1 = kj0 + 8;  // key rows held by this thread
  const int sk0 = seg[(int64_t)b * S + kj0], sk1 = seg[(int64_t)b * S + kj1];

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int iq_start = causal ? k0 / BQ2 : 0;
  const int nq = S / BQ2;
  const int2 kr = seg_range(seg_rng, b, S, k0, BK2);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* lrow = lse + ((int64_t)b * Hq + h) * S;
    const float* drow = delta + ((int64_t)b * Hq + h) * S;
    for (int iq = iq_start; iq < nq; ++iq) {
      const int q0 = iq * BQ2;
      if (disjoint(kr, seg_range(seg_rng, b, S, q0, BQ2))) continue;  // uniform over the CTA
      __syncthreads();
      load_tile<BQ2>(Qs, q + ((int64_t)b * S + q0) * qstride + (int64_t)h * D, qstride);
      load_tile<BQ2>(dOs, dout + ((int64_t)b * S + q0) * qstride + (int64_t)h * D, qstride);
      for (int i = threadIdx.x; i < BQ2; i += NTHREADS) {
        const float l = lrow[q0 + i];
        lses[i] = l <= 0.5f * NEG ? 0.f : l;
        dls[i] = drow[q0 + i];
        segq[i] = seg[(int64_t)b * S + q0 + i];
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ2 queries
      float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
      for (int n = 0; n < BQ2 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4], av[4];
        load_a(a, Ks, warp * 16, kd * 16, g, t);
        load_a(av, Vs, warp * 16, kd * 16, g, t);
#pragma unroll
        for (int n = 0; n < BQ2 / 8; ++n) {
          uint32_t bb[2];
          load_bt(bb, Qs, n * 8, kd * 16, g, t);
          mma16816(s[n], a, bb);
          load_bt(bb, dOs, n * 8, kd * 16, g, t);
          mma16816(dp[n], av, bb);
        }
      }
      // P^T on visible pairs; dS^T = P^T * (dP^T - delta) * scale
#pragma unroll
      for (int n = 0; n < BQ2 / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const int qi = q0 + col;
          const bool vis = e < 2 ? visible(qi, kj0, segq[col], sk0, causal)
                                 : visible(qi, kj1, segq[col], sk1, causal);
          const float p = vis ? expf(s[n][e] * scale - lses[col]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dls[col]) * scale;
        }
      }
      // dV += P^T dO ; dK += dS^T Q
#pragma unroll
      for (int kq = 0; kq < BQ2 / 16; ++kq) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_f32(s[2 * kq][0], s[2 * kq][1]);
        ap[1] = pack_f32(s[2 * kq][2], s[2 * kq][3]);
        ap[2] = pack_f32(s[2 * kq + 1][0], s[2 * kq + 1][1]);
        ap[3] = pack_f32(s[2 * kq + 1][2], s[2 * kq + 1][3]);
        ad[0] = pack_f32(dp[2 * kq][0], dp[2 * kq][1]);
        ad[1] = pack_f32(dp[2 * kq][2], dp[2 * kq][3]);
        ad[2] = pack_f32(dp[2 * kq + 1][0], dp[2 * kq + 1][1]);
        ad[3] = pack_f32(dp[2 * kq + 1][2], dp[2 * kq + 1][3]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t bb[2];
          load_b(bb, dOs, kq * 16, nd * 8, g, t);
          mma16816(dva[nd], ap, bb);
          load_b(bb, Qs, kq * 16, nd * 8, g, t);
          mma16816(dka[nd], ad, bb);
        }
      }
    }
  }

  __nv_bfloat16* k_0 = dk + ((int64_t)b * S + kj0) * kstride + (int64_t)hk * D;
  __nv_bfloat16* k_1 = dk + ((int64_t)b * S + kj1) * kstride + (int64_t)hk * D;
  __nv_bfloat16* v_0 = dv + ((int64_t)b * S + kj0) * kstride + (int64_t)hk * D;
  __nv_bfloat16* v_1 = dv + ((int64_t)b * S + kj1) * kstride + (int64_t)hk * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(k_0 + col) = pack_f32(dka[nd][0], dka[nd][1]);
    *reinterpret_cast<uint32_t*>(k_1 + col) = pack_f32(dka[nd][2], dka[nd][3]);
    *reinterpret_cast<uint32_t*>(v_0 + col) = pack_f32(dva[nd][0], dva[nd][1]);
    *reinterpret_cast<uint32_t*>(v_1 + col) = pack_f32(dva[nd][2], dva[nd][3]);
  }
}

constexpr size_t DQ_SMEM = (size_t)(2 * FQ + 2 * FK) * LD * sizeof(__nv_bfloat16) + FK * sizeof(int);
constexpr size_t DKV_SMEM =
    (size_t)(2 * BK2 + 2 * BQ2) * LD * sizeof(__nv_bfloat16) + 3 * BQ2 * sizeof(float);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launch on the given stream; the caller checks shapes, types and
// contiguity (S % 128 == 0, Hq % Hkv == 0, D == 128, 16-byte aligned).
extern "C" {

// tokens per block of the seg_rng argument, so the caller can check its layout
int vt_seg_range_block(void) { return RB; }

int vt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                 const void* seg_rng, void* o, void* lse, int B, int S, int Hq, int Hkv,
                 float scale, int causal, void* stream) {
  return launch_flash_fwd<FWD_CW>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal,
                                  (cudaStream_t)stream);
}

int vt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                     const void* seg_rng, const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int Hq, int Hkv, float scale, int causal,
                     void* stream) {
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BK2, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)seg, (const int*)seg_rng, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

int vt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                    const void* seg_rng, const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int Hq, int Hkv, float scale, int causal,
                    void* stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / FQ, Hq, B);
  flash_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)seg, (const int*)seg_rng, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq, S, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // extern "C"
