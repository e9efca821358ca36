// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2), dQ (K3).
//
// Replaces the Pallas TPU kernels of veomni_tpu/ops/pallas/flash_attention.py:
//   K1 flash_fwd_tma_kernel     <- _fwd_kernel      (:49-106, launched by _fwd :109)
//   K2 flash_bwd_dkv_tma_kernel <- _bwd_dkv_kernel  (:155-205, launched by _bwd :255)
//   K3 flash_bwd_dq_tma_kernel  <- _bwd_dq_kernel   (:208-252, launched by _bwd :255)
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
// [B,S/32,2] int32 (per 32-token block: min and max segment id). D is 64,
// 72, 80, 128 or 256: each kernel is a template on the head dim it computes
// at (D) and the one it reads and writes (DA), instantiated at (64, 64),
// (128, 72), (128, 80), (128, 128) and (256, 256).
//
// Head dims 72 (the Qwen3-VL vision towers: 16 heads of 72) and 80 (the
// Qwen2-VL / Qwen2.5-VL towers: 16 heads of 80) are not a whole number of
// 64-column boxes, so a 2-D map over [B*S, H*DA] would put head h + 1's
// first columns into head h's second box: wrong numbers, not a crash. At
// DA != D the loads and stores go through 3-D maps over [B*S, H, DA]
// instead (head_map_3d): a box at column 64 holds head columns 64..DA-1 and
// zeros past them (TMA fills a box's out-of-bounds elements with zeros on
// load and leaves them out on store; a row of 72 or 80 bf16 values is 144
// or 160 bytes, a multiple of the 16-byte stride TMA needs), and the kernels
// compute at D = 128's tiles. The zero columns add nothing to Q K^T,
// dP = dO V^T, P V, dS K, P^T dO or dS^T Q, and the output columns past DA
// are computed as zeros and never stored. The price is D = 128's MMA work:
// 1.78x (D 72) and 1.6x (D 80) the operations of the exact width.
//
// Head dims. TMA and wgmma see a row of D bf16 values as D / 64 boxes of 64
// columns (one 128-byte swizzled row each), so D changes how many boxes a
// tile has, the N of the products whose output is D wide (O += P V, dQ +=
// dS K, dV += P^T dO, dK += dS^T Q: wgmma m64n64 at D = 64) and the depth
// of the ones that contract over D (S, dP: D / 16 steps), not the layout of
// a box. D = 64 keeps D = 128's tiles and stages with half the bytes and
// registers. D = 256 has to give up some: K1 walks 64-key tiles (O is 128
// f32 accumulators a thread beside S's 32); K2 computes dK and dV in two
// 128-column halves, each a work item of its own that recomputes S^T and
// dP^T in full (dK and dV together would be 256 accumulators a thread), on a
// 1-stage Q/dO ring (K and V of a 128-key tile take 128 KB); K3 keeps its
// 64-key tiles on a 1-stage K/V ring (Q and dO take 128 KB) and holds dQ's
// 128 accumulators a thread.
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
// are 2-D tensor maps over [B*S, H*D] in boxes of 64 head dims (S % 128 ==
// 0, so a 128-row box never straddles two batch rows); Q is loaded once, K
// and V in 128-key tiles through a 2-stage ring of mbarriers (K and V on
// barriers of their own, so Q K^T starts before V lands; ~161 KB of shared
// memory at D = 128). S = Q K^T is wgmma m64n128k16 with both operands K-major; the
// online softmax runs in the accumulator layout with exp2f (scale * log2 e
// folded in) and quad shuffles; P goes to bf16 in registers and is wgmma's
// register A operand for O += P V, with V MN-major (the transpose flag). The
// per-element mask (causal order, equal segment ids) runs only on tiles
// that reach past the diagonal or whose q rows and keys are not all one
// segment; producer and consumers walk one list of k tiles (walk_k_tiles).
// O / l leaves through the warpgroup's Q boxes by TMA stores.
// K2 (flash_bwd_dkv_tma_kernel) is built the same way, around a 128-key
// tile of one kv head (64 keys per consumer warpgroup): K and V are loaded
// once and are the K-major A operands of S^T = K Q^T and dP^T = V dO^T
// (wgmma m64n64k16); Q and dO stream in 64-row q tiles through a 2-stage
// ring, with their rows' LSE, delta and segment ids (1-D bulk copies on the
// same barrier). P^T = exp2(S^T scale log2 e - LSE log2 e) and dS^T = P^T
// (dP^T - delta) scale go to bf16 in registers and are the register A
// operands of dV += P^T dO and dK += dS^T Q, with dO and Q MN-major. A work
// item walks (q head, q tile) pairs from the causal diagonal on, skips
// disjoint segment ranges (walk_q_tiles) and masks every q tile it walks
// element by element; dK and dV are summed over the q-head group on chip
// and written once in bf16 (the reference writes per-q-head f32 dK/dV and
// group-sums them in XLA, :297-299). Where a batch
// gives too few work items to fill the card, the wrapper splits each group
// over `split` items (dkv_group_split), which write f32 partials to a
// workspace; a second kernel of the same call sums them in a fixed order,
// so the result is the same bit for bit in every launch (no atomics).
// K3 (flash_bwd_dq_tma_kernel) is K1's skeleton with dO loaded beside Q:
// a 128-row q tile per block on two consumer warpgroups, Q and dO loaded
// once, K and V in 64-key (DQ_KT) tiles through a 2-stage ring (K and V on
// barriers of their own). S = Q K^T and dP = dO V^T have K-major operands;
// dS = P (dP - delta) scale goes to bf16 in registers and is the register A
// operand of dQ += dS K, with K read MN-major from the same box that S read
// K-major. Producer and consumers walk walk_k_tiles at DQ_KT keys, masking
// as K1 does. dQ leaves through the warpgroup's Q boxes by TMA stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG = -1e30f;

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

// Whether a kernel computing at head dim D reads and writes head dim DA
// through 3-D maps [B*S, H, DA] (the header's head dims 72 and 80), or through 2-D
// maps [B*S, H*DA] in boxes of 64 whole head dims.
__host__ __device__ constexpr bool head_map_3d(int D, int DA) { return DA != D; }

// The 64-column box j of head h over rows [row, row + box rows) into
// shared memory at dst, counted on barrier bar.
template <int D, int DA>
__device__ __forceinline__ void load_head_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int j, int row) {
  if constexpr (head_map_3d(D, DA)) tma_load_3d(dst, map, bar, 64 * j, h, row);
  else tma_load_2d(dst, map, bar, h * DA + 64 * j, row);
}

// The same box from shared memory at src to the tensor (columns past DA are
// not written)
template <int D, int DA>
__device__ __forceinline__ void store_head_box(const CUtensorMap* map, uint32_t src, int h, int j,
                                               int row) {
  if constexpr (head_map_3d(D, DA)) tma_store_3d(map, src, 64 * j, h, row);
  else tma_store_2d(map, src, h * DA + 64 * j, row);
}

// The tensor map of a [B*S, heads, DA] operand for box_rows x 64 boxes
template <int D, int DA>
int encode_heads(CUtensorMap* map, const void* ptr, uint64_t rows, int heads, uint32_t box_rows) {
  if (head_map_3d(D, DA)) return encode_bf16_heads(map, ptr, rows, heads, DA, box_rows);
  return encode_bf16_2d(map, ptr, rows, (uint64_t)heads * DA, box_rows, 64);
}

// ---------------------------------------------------------------- K1 forward
// K1, K2 and K3 are built alike: TMA, an mbarrier ring, wgmma, warp roles.
constexpr int KV_TILE = 128;         // keys per K/V tile (64 at D = 256)
constexpr int FWD_CW = 2;            // consumer warpgroups: 64 q rows each
constexpr int KV_STAGES = 2;
constexpr int Q_BOX = 64 * 128;      // one 64-row x 64-column box of Q (or O), bytes
constexpr int KV_BOX = KV_TILE * 128;  // one 128-key x 64-column box of K or V
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, int CW>
struct FwdTile {
  static constexpr int NB = D / 64;                    // 64-column boxes of a head row
  static constexpr int KT = D == 256 ? 64 : KV_TILE;   // keys per K/V tile
  static constexpr int KBOX = KT * 128;                // one KT-key x 64-column box of K or V
  static constexpr int STAGE = 2 * NB * KBOX;          // a stage: K's NB boxes, then V's
  static constexpr int BQ = 64 * CW;         // q rows per block
  static constexpr int THREADS = 128 * (CW + 1);
  static constexpr int Q_BYTES = CW * NB * Q_BOX;
  // 1024 bytes of alignment slack, Q (O staged in its place), the ring, then
  // the barriers: Q's, and per stage K full, V full, empty
  static constexpr size_t SMEM = 1024 + Q_BYTES + KV_STAGES * STAGE + 8 * (1 + 3 * KV_STAGES);
};

// The KT-key tiles that q rows [q0, q0 + bq) of row b see, in order: tile(k0,
// masked) for each tile whose segment range meets the q rows' (a pair of
// disjoint ranges has no visible (query, key) pair and is skipped); masked
// is true where the per-element mask is needed: the tile reaches past the
// causal diagonal, or the q rows and the keys are not all of one and the
// same segment. The producer and the consumers walk the same list.
template <int KT, typename Tile>
__device__ __forceinline__ void walk_k_tiles(const int* rng, int b, int S, int q0, int bq,
                                             bool causal, Tile tile) {
  const int2 qr = seg_range(rng, b, S, q0, bq);
  const int nk = causal ? (q0 + bq - 1) / KT + 1 : S / KT;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * KT;
    const int2 kr = seg_range(rng, b, S, k0, KT);
    if (disjoint(qr, kr)) continue;  // no visible pair
    const bool masked = (causal && k0 + KT - 1 > q0) || qr.x != qr.y || kr.x != qr.x || kr.y != qr.x;
    tile(k0, masked);
  }
}

// grid (Hq, B, S / BQ), the last (heaviest causal) q tiles first; block
// FwdTile::THREADS: warpgroup 0 the producer, 1..CW the consumers.
// tm_q, tm_o: [B*S, Hq*D] in 64 x 64 boxes; tm_k, tm_v: [B*S, Hkv*D] in
// KT x 64 boxes.
template <int D, int CW, int DA>
__global__ void __launch_bounds__(FwdTile<D, CW>::THREADS, 1)
flash_fwd_tma_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_o,
                     const int* __restrict__ seg, const int* __restrict__ seg_rng,
                     float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal) {
  typedef FwdTile<D, CW> T;
  constexpr int NB = T::NB, KT = T::KT, KBOX = T::KBOX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023) & ~1023u;  // box (warpgroup w, column box j) at (NB w + j) Q_BOX
  const uint32_t ring = q_smem + T::Q_BYTES;       // stage s at s STAGE
  const uint32_t q_full = ring + KV_STAGES * T::STAGE;
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
        for (int j = 0; j < NB; ++j)
          load_head_box<D, DA>(q_smem + (NB * w + j) * Q_BOX, &tm_q, q_full, h, j, b * S + q0 + 64 * w);
      int stage = 0;
      uint32_t phase = 0;
      walk_k_tiles<KT>(seg_rng, b, S, q0, T::BQ, causal, [&](int k0, bool) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * T::STAGE;
        mbar_arrive_expect_tx(k_full + 8 * stage, NB * KBOX);
        for (int j = 0; j < NB; ++j) load_head_box<D, DA>(st + j * KBOX, map_k, k_full + 8 * stage, hk, j, b * S + k0);
        mbar_arrive_expect_tx(v_full + 8 * stage, NB * KBOX);
        for (int j = 0; j < NB; ++j)
          load_head_box<D, DA>(st + (NB + j) * KBOX, map_v, v_full + 8 * stage, hk, j, b * S + k0);
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
    const uint32_t qa = q_smem + NB * cw * Q_BOX;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // running max (log2 units), partial sums
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    walk_k_tiles<KT>(seg_rng, b, S, q0, T::BQ, causal, [&](int k0, bool masked) {
      const uint32_t st = ring + stage * T::STAGE;
      // S = Q K^T: both K-major; 16 head dims (32 bytes of a swizzled row) per
      // step, D / 16 steps over the NB boxes. The first step ignores s
      // (scale_d 0), so no value of s lives from one tile to the next.
      float s[KT / 2];
      mbar_wait(k_full + 8 * stage, phase);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = 32 * (kd % 4);  // the 32-byte chunk of Q's and K's swizzled rows
        wgmma_ss<KT, 0>(s, wgmma_desc(qa + (kd / 4) * Q_BOX + off, 16, 1024),
                        wgmma_desc(st + (kd / 4) * KBOX + off, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // online softmax in the accumulator layout: this thread holds rows r0
      // (s[4j], s[4j+1]) and r0 + 8 (s[4j+2], s[4j+3]), keys 8j + 2t (+1)
      float mx0 = NEG, mx1 = NEG;
      if (masked) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const int kj = k0 + 8 * j + 2 * t;
          const int2 sk = *reinterpret_cast<const int2*>(segb + kj);
          s[4 * j + 0] = visible(qi0, kj, sq0, sk.x, causal) ? s[4 * j + 0] * sl2 : NEG;
          s[4 * j + 1] = visible(qi0, kj + 1, sq0, sk.y, causal) ? s[4 * j + 1] * sl2 : NEG;
          s[4 * j + 2] = visible(qi1, kj, sq1, sk.x, causal) ? s[4 * j + 2] * sl2 : NEG;
          s[4 * j + 3] = visible(qi1, kj + 1, sq1, sk.y, causal) ? s[4 * j + 3] * sl2 : NEG;
        }
      } else {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) s[i] *= sl2;
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
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
        for (int j = 0; j < KT / 8; ++j) {
          s[4 * j + 0] = s[4 * j + 0] > 0.5f * NEG ? exp2f(s[4 * j + 0] - mn0) : 0.f;
          s[4 * j + 1] = s[4 * j + 1] > 0.5f * NEG ? exp2f(s[4 * j + 1] - mn0) : 0.f;
          s[4 * j + 2] = s[4 * j + 2] > 0.5f * NEG ? exp2f(s[4 * j + 2] - mn1) : 0.f;
          s[4 * j + 3] = s[4 * j + 3] > 0.5f * NEG ? exp2f(s[4 * j + 3] - mn1) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          s[4 * j + 0] = exp2f(s[4 * j + 0] - mn0);
          s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
          s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
          s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
        }
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // O += P V: P in bf16 registers (A), V MN-major (B, head dims
      // contiguous: NB 64-column blocks KBOX apart), 16 keys per step
      uint32_t p[KT / 4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        p[4 * kk + 0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(v_full + 8 * stage, phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs<D, 1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                       wgmma_desc(st + NB * KBOX + 2048 * kk, KBOX, 1024), 1);
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
    // longer read) in the 128-byte swizzle, then NB TMA stores; the LSE
    // in natural-log units. A row with no visible key: O = 0, LSE = NEG.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    unsigned char* ob = smem_raw + (qa - raw);
    const int sw = r0 & 7;  // O's swizzle: the same for r0 + 8
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* pj = ob + (j / 8) * Q_BOX + ((j & 7) ^ sw) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(pj + r0 * 128) = pack_f32(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(pj + (r0 + 8) * 128) =
          pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    fence_proxy_async();
    if (cw == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < NB; ++j) store_head_box<D, DA>(&tm_o, qa + j * Q_BOX, h, j, b * S + q0 + 64 * cw);
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

template <int D, int CW, int DA = D>
int launch_flash_fwd(const void* q, const void* k, const void* v, const void* seg, const void* seg_rng,
                     void* o, void* lse, int B, int S, int Hq, int Hkv, float scale, int causal,
                     cudaStream_t stream) {
  typedef FwdTile<D, CW> T;
  // a runtime call first: it makes the device's context current on this
  // thread, which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tma_kernel<D, CW, DA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const uint64_t rows = (uint64_t)B * S;
  int err = encode_heads<D, DA>(&tm_q, q, rows, Hq, 64);
  if (!err) err = encode_heads<D, DA>(&tm_o, o, rows, Hq, 64);
  if (!err) err = encode_heads<D, DA>(&tm_k, k, rows, Hkv, T::KT);
  if (!err) err = encode_heads<D, DA>(&tm_v, v, rows, Hkv, T::KT);
  if (err) return err;
  dim3 grid(Hq, B, S / T::BQ);
  flash_fwd_tma_kernel<D, CW, DA><<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, (const int*)seg, (const int*)seg_rng, (float*)lse, S, Hq, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K2 dK, dV
// A work item is a 128-key tile of one kv head (two consumer warpgroups of
// 64 keys each), the q heads h0 .. h0 + nh - 1 of its group and (at D = 256)
// one 128-column half of dK and dV; K and V are loaded once, Q, dO and their
// rows' LSE, delta and segment ids stream in 64-row q tiles through a ring
// of 2 stages (1 at D = 256).
constexpr int DKV_KT = 128;                  // keys per work item
constexpr int DKV_QT = 64;                   // q rows per streamed tile
constexpr int DKV_STAGES = 2;
constexpr int DKV_PRODUCER_REGS = 40, DKV_CONSUMER_REGS = 232;  // setmaxnreg
constexpr int DKV_ROW_BYTES = DKV_QT * 4;    // one tile's LSE (or delta, or segment ids)

template <int D>
struct DkvTile {
  static constexpr int NB = D / 64;                   // 64-column boxes of a head row
  static constexpr int OB = D == 256 ? 2 : NB;        // boxes of dK and dV per work item
  static constexpr int HALVES = NB / OB;              // work items per (key tile, q heads)
  static constexpr int DH = 64 * OB;                  // dK and dV columns per work item
  static constexpr int STAGES = D == 256 ? 1 : DKV_STAGES;
  static constexpr int STAGE = 2 * NB * Q_BOX + 1024;  // Q's NB boxes, dO's NB, the three rows (padded)
  // 1024 bytes of alignment slack, K's NB boxes and V's NB, the ring, then
  // the barriers: K and V's, and per stage full and empty
  static constexpr size_t SMEM = 1024 + 2 * NB * KV_BOX + STAGES * STAGE + 8 * (1 + 2 * STAGES);
};

// The (q head, q tile) pairs that keys [k0, k0 + DKV_KT) of row b see, in
// order: for each q head h0 .. h0 + nh - 1, the 64-row q tiles from the
// causal diagonal on whose segment range meets the keys' (a pair of disjoint
// ranges has no visible (query, key) pair and is skipped). The producer and
// the consumers walk the same list. The consumers mask every tile they walk:
// a second, unmasked path in their loop makes ptxas spill the accumulators
// (540 bytes of spill stores against 312) and takes ~1.5x as long
// (flash_variants' dkv-mask-flagged).
template <typename Tile>
__device__ __forceinline__ void walk_q_tiles(const int* rng, int b, int S, int k0, int h0, int nh,
                                             bool causal, Tile tile) {
  const int2 kr = seg_range(rng, b, S, k0, DKV_KT);
  const int first = causal ? k0 / DKV_QT : 0;
  for (int h = h0; h < h0 + nh; ++h) {
    for (int iq = first; iq < S / DKV_QT; ++iq) {
      const int q0 = iq * DKV_QT;
      const int2 qr = seg_range(rng, b, S, q0, DKV_QT);
      if (disjoint(kr, qr)) continue;  // no visible pair
      tile(h, q0);
    }
  }
}

// 1-D grid of B * Hkv * (S / DKV_KT) * split * HALVES work items, the first
// key tiles (the heaviest under a causal mask) first; block 384 threads:
// warpgroup 0 the producer, 1 and 2 the consumers. tm_q, tm_do: [B*S, Hq*D]
// in 64 x 64 boxes; tm_k, tm_v: [B*S, Hkv*D] in 128 x 64 boxes; tm_dk,
// tm_dv: the same in 64 x 64 boxes. With split > 1 the item's f32 partial
// sums go to ws [split, B, S, Hkv, D] (dK), then [split, B, S, Hkv, D] (dV),
// else dK and dV leave in bf16 by TMA stores.
template <int D, int DA>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_tma_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k, __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_dk, __grid_constant__ const CUtensorMap tm_dv,
                         const int* __restrict__ seg, const int* __restrict__ seg_rng,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ ws, int B, int S, int Hq, int Hkv, int split, float scale,
                         int causal) {
  typedef DkvTile<D> T;
  constexpr int NB = T::NB, OB = T::OB, DH = T::DH, STAGES = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t kv_smem = (raw + 1023) & ~1023u;  // K box j at j KV_BOX, V box j at (NB + j) KV_BOX
  const uint32_t ring = kv_smem + 2 * NB * KV_BOX;  // stage s at s STAGE
  const uint32_t kv_full = ring + STAGES * T::STAGE;
  const uint32_t full = kv_full + 8;               // stage s: + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const int per_tile = B * Hkv * split * T::HALVES;
  const int k0 = ((int)blockIdx.x / per_tile) * DKV_KT;  // the first key tiles first
  const int rest = (int)blockIdx.x % per_tile;
  const int b = rest / (Hkv * split * T::HALVES), hk = rest / (split * T::HALVES) % Hkv;
  const int sp = rest / T::HALVES % split, half = rest % T::HALVES;
  const int group = Hq / Hkv, nh = group / split;
  const int h0 = hk * group + sp * nh;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads K and V once, then Q, dO and the rows tile by tile
    setmaxnreg_dec<DKV_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_q = &tm_q;
      const CUtensorMap* map_do = &tm_do;
      mbar_arrive_expect_tx(kv_full, 2 * NB * KV_BOX);
      for (int j = 0; j < NB; ++j) {
        load_head_box<D, DA>(kv_smem + j * KV_BOX, &tm_k, kv_full, hk, j, b * S + k0);
        load_head_box<D, DA>(kv_smem + (NB + j) * KV_BOX, &tm_v, kv_full, hk, j, b * S + k0);
      }
      int stage = 0;
      uint32_t phase = 0;
      walk_q_tiles(seg_rng, b, S, k0, h0, nh, causal, [&](int h, int q0) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * T::STAGE;
        const uint32_t bar = full + 8 * stage;
        mbar_arrive_expect_tx(bar, 2 * NB * Q_BOX + 3 * DKV_ROW_BYTES);
        for (int j = 0; j < NB; ++j) {
          load_head_box<D, DA>(st + j * Q_BOX, map_q, bar, h, j, b * S + q0);
          load_head_box<D, DA>(st + (NB + j) * Q_BOX, map_do, bar, h, j, b * S + q0);
        }
        const int64_t row = ((int64_t)b * Hq + h) * S + q0;
        bulk_load_1d(st + 2 * NB * Q_BOX, lse + row, DKV_ROW_BYTES, bar);
        bulk_load_1d(st + 2 * NB * Q_BOX + DKV_ROW_BYTES, delta + row, DKV_ROW_BYTES, bar);
        bulk_load_1d(st + 2 * NB * Q_BOX + 2 * DKV_ROW_BYTES, seg + (int64_t)b * S + q0, DKV_ROW_BYTES, bar);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    // ---- consumers: warpgroup cw owns keys k0 + 64 cw ..
    setmaxnreg_inc<DKV_CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r0 = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // fragment rows r0, r0 + 8 of the 64
    const int kj0 = k0 + 64 * cw + r0, kj1 = kj0 + 8;
    const int sk0 = seg[(int64_t)b * S + kj0], sk1 = seg[(int64_t)b * S + kj1];
    const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 instead of exp
    const uint32_t ka = kv_smem + cw * Q_BOX;  // this warpgroup's 64 rows of K's first box
    const uint32_t va = ka + NB * KV_BOX;      // and of V's
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(kv_full, 0);
    walk_q_tiles(seg_rng, b, S, k0, h0, nh, causal, [&](int, int q0) {
      const uint32_t st = ring + stage * T::STAGE;
      const unsigned char* rows = smem_raw + (st + 2 * NB * Q_BOX - raw);
      const float* lse_t = reinterpret_cast<const float*>(rows);
      const float* delta_t = reinterpret_cast<const float*>(rows + DKV_ROW_BYTES);
      const int* seg_t = reinterpret_cast<const int*>(rows + 2 * DKV_ROW_BYTES);
      // S^T = K Q^T and dP^T = V dO^T, all four operands K-major, over all D
      // head dims; the first step of each ignores the accumulator (scale_d 0)
      float s[32], dp[32];
      mbar_wait(full + 8 * stage, phase);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = (kd / 4) * KV_BOX + 32 * (kd % 4);
        wgmma_m64n64k16<0>(s, wgmma_desc(ka + off, 16, 1024),
                           wgmma_desc(st + (kd / 4) * Q_BOX + 32 * (kd % 4), 16, 1024), kd > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = (kd / 4) * KV_BOX + 32 * (kd % 4);
        wgmma_m64n64k16<0>(dp, wgmma_desc(va + off, 16, 1024),
                           wgmma_desc(st + (NB + kd / 4) * Q_BOX + 32 * (kd % 4), 16, 1024), kd > 0);
      }
      wgmma_commit();
      // P^T = exp2(S^T scale log2 e - LSE log2 e) in the accumulator layout:
      // this thread holds keys r0 (s[4j], s[4j+1]) and r0 + 8 (s[4j+2],
      // s[4j+3]), q columns 8j + 2t (+1); a row without a visible key has
      // LSE -1e30, read as 0 (reference :188)
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        const float l0 = (l.x <= 0.5f * NEG ? 0.f : l.x) * LOG2E;
        const float l1 = (l.y <= 0.5f * NEG ? 0.f : l.y) * LOG2E;
        const int2 sq = *reinterpret_cast<const int2*>(seg_t + c);
        s[4 * j + 0] = visible(q0 + c, kj0, sq.x, sk0, causal) ? exp2f(fmaf(s[4 * j + 0], sl2, -l0)) : 0.f;
        s[4 * j + 1] = visible(q0 + c + 1, kj0, sq.y, sk0, causal) ? exp2f(fmaf(s[4 * j + 1], sl2, -l1)) : 0.f;
        s[4 * j + 2] = visible(q0 + c, kj1, sq.x, sk1, causal) ? exp2f(fmaf(s[4 * j + 2], sl2, -l0)) : 0.f;
        s[4 * j + 3] = visible(q0 + c + 1, kj1, sq.y, sk1, causal) ? exp2f(fmaf(s[4 * j + 3], sl2, -l1)) : 0.f;
      }
      // dS^T = P^T (dP^T - delta) scale
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * t);
        dp[4 * j + 0] = s[4 * j + 0] * (dp[4 * j + 0] - dl.x) * scale;
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dl.y) * scale;
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dl.x) * scale;
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dl.y) * scale;
      }
      // dV += P^T dO and dK += dS^T Q over this item's DH columns: P^T and
      // dS^T in bf16 registers (A), dO and Q MN-major (B, head dims
      // contiguous: 64-column boxes Q_BOX apart), 16 q rows per step
      uint32_t p[16], ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        p[i] = pack_f32(s[2 * i], s[2 * i + 1]);
        ds[i] = pack_f32(dp[2 * i], dp[2 * i + 1]);
      }
      const uint32_t q_half = st + half * OB * Q_BOX;  // Q's boxes of this item's columns
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_QT / 16; ++kk)
        wgmma_rs<DH, 1>(dv, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                        wgmma_desc(q_half + NB * Q_BOX + 2048 * kk, Q_BOX, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < DKV_QT / 16; ++kk)
        wgmma_rs<DH, 1>(dk, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                        wgmma_desc(q_half + 2048 * kk, Q_BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(p);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is consumed
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    });

    if (split == 1) {
      // dK and dV in bf16 into this warpgroup's rows of this item's K and V
      // boxes (no longer read) in the 128-byte swizzle, then TMA stores
      unsigned char* kb = smem_raw + (ka - raw) + half * OB * KV_BOX;
      unsigned char* vb = smem_raw + (va - raw) + half * OB * KV_BOX;
      const int sw = r0 & 7;  // the same for r0 + 8
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int off = (j / 8) * KV_BOX + ((j & 7) ^ sw) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(kb + off + r0 * 128) = pack_f32(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(kb + off + (r0 + 8) * 128) = pack_f32(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(vb + off + r0 * 128) = pack_f32(dv[4 * j], dv[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(vb + off + (r0 + 8) * 128) = pack_f32(dv[4 * j + 2], dv[4 * j + 3]);
      }
      fence_proxy_async();
      if (cw == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
      if ((threadIdx.x & 127) == 0) {
        for (int j = half * OB; j < half * OB + OB; ++j) {
          store_head_box<D, DA>(&tm_dk, ka + j * KV_BOX, hk, j, b * S + k0 + 64 * cw);
          store_head_box<D, DA>(&tm_dv, va + j * KV_BOX, hk, j, b * S + k0 + 64 * cw);
        }
        bulk_commit();
        bulk_wait<0>();  // the block's shared memory outlives the stores
      }
    } else {
      // f32 partial sums of this item's q heads, summed by dkv_split_sum_kernel
      // (the DA head dims: the computed columns past DA are zeros, not kept)
      const int64_t plane = (int64_t)B * S * Hkv * DA;
      float* wk = ws + sp * plane + ((int64_t)b * S + kj0) * Hkv * DA + (int64_t)hk * DA + half * DH;
      float* wv = wk + split * plane;
      const int64_t row8 = 8 * (int64_t)Hkv * DA;  // key row r0 + 8
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (DA != D && c >= DA) continue;
        *reinterpret_cast<float2*>(wk + c) = make_float2(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<float2*>(wk + row8 + c) = make_float2(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<float2*>(wv + c) = make_float2(dv[4 * j], dv[4 * j + 1]);
        *reinterpret_cast<float2*>(wv + row8 + c) = make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// dK, dV [B,S,Hkv,D] bf16 = the sum of ws's split partials (dK's, then dV's),
// split 0 first: the same order in every launch, so the same bits. Four
// values per thread.
__global__ void dkv_split_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv, int64_t n, int split) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = ws + which * split * n + i;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int p = 1; p < split; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(src + p * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 out = make_uint2(pack_f32(acc.x, acc.y), pack_f32(acc.z, acc.w));
    *reinterpret_cast<uint2*>((which ? dv : dk) + i) = out;
  }
}

template <int D, int DA = D>
int launch_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                         const void* seg_rng, const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, void* ws, int split, int B, int S, int Hq, int Hkv,
                         float scale, int causal, cudaStream_t stream) {
  typedef DkvTile<D> T;
  if (split < 1 || (Hq / Hkv) % split || (split > 1 && !ws)) return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread too), which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_tma_kernel<D, DA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  const uint64_t rows = (uint64_t)B * S;
  int err = encode_heads<D, DA>(&tm_q, q, rows, Hq, DKV_QT);
  if (!err) err = encode_heads<D, DA>(&tm_do, dout, rows, Hq, DKV_QT);
  if (!err) err = encode_heads<D, DA>(&tm_k, k, rows, Hkv, DKV_KT);
  if (!err) err = encode_heads<D, DA>(&tm_v, v, rows, Hkv, DKV_KT);
  if (!err) err = encode_heads<D, DA>(&tm_dk, dk, rows, Hkv, 64);
  if (!err) err = encode_heads<D, DA>(&tm_dv, dv, rows, Hkv, 64);
  if (err) return err;
  const int items = B * Hkv * (S / DKV_KT) * split * T::HALVES;
  flash_bwd_dkv_tma_kernel<D, DA><<<items, 384, T::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, (const int*)seg, (const int*)seg_rng,
      (const float*)lse, (const float*)delta, (float*)ws, B, S, Hq, Hkv, split, scale, causal);
  if (split > 1) {
    const int64_t n = (int64_t)B * S * Hkv * DA;
    dkv_split_sum_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
        (const float*)ws, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, split);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K3 dQ
// K1's skeleton: a 128-row q tile of one q head per block (64 rows per
// consumer warpgroup); Q and dO are loaded once, K and V arrive in DQ_KT-key
// tiles through a ring of 2 stages (1 at D = 256; K and V on barriers of
// their own).
constexpr int DQ_BQ = 128;                   // q rows per block
constexpr int DQ_KT = 64;                    // keys per K/V tile: the n of S's and dP's m64n64 wgmma
constexpr int DQ_STAGES = 2;
constexpr int DQ_PRODUCER_REGS = 40, DQ_CONSUMER_REGS = 232;  // setmaxnreg
constexpr int DQ_KBOX = DQ_KT * 128;         // one DQ_KT-key x 64-column box of K or V, bytes

template <int D>
struct DqTile {
  static constexpr int NB = D / 64;                    // 64-column boxes of a head row
  static constexpr int STAGES = D == 256 ? 1 : DQ_STAGES;
  static constexpr int STAGE = 2 * NB * DQ_KBOX;       // a stage: K's NB boxes, then V's
  // 1024 bytes of alignment slack, Q's 2 NB boxes and dO's 2 NB (dQ staged
  // in Q's place), the ring, then the barriers: Q and dO's, and per stage K
  // full, V full, empty
  static constexpr size_t SMEM = 1024 + 4 * NB * Q_BOX + STAGES * STAGE + 8 * (1 + 3 * STAGES);
};

// grid (Hq, B, S / DQ_BQ), the last (heaviest causal) q tiles first; block
// 384 threads: warpgroup 0 the producer, 1 and 2 the consumers. tm_q, tm_do,
// tm_dq: [B*S, Hq*D] in 64 x 64 boxes; tm_k, tm_v: [B*S, Hkv*D] in
// DQ_KT x 64 boxes.
template <int D, int DA>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_tma_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_do,
                        __grid_constant__ const CUtensorMap tm_k, __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_dq, const int* __restrict__ seg,
                        const int* __restrict__ seg_rng, const float* __restrict__ lse,
                        const float* __restrict__ delta, int S, int Hq, int Hkv, float scale, int causal) {
  typedef DqTile<D> T;
  constexpr int NB = T::NB, STAGES = T::STAGES, DQ_STAGE = T::STAGE;
  constexpr int NS = DQ_KT / 2;  // accumulators of a 64 x DQ_KT score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023) & ~1023u;  // Q box (warpgroup w, column box j) at (NB w + j) Q_BOX
  const uint32_t do_smem = q_smem + 2 * NB * Q_BOX;  // dO's the same
  const uint32_t ring = do_smem + 2 * NB * Q_BOX;    // stage s at s DQ_STAGE
  const uint32_t q_full = ring + STAGES * DQ_STAGE;
  const uint32_t k_full = q_full + 8;              // stage s: + 8 s
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * DQ_BQ;  // heaviest causal tiles first
  const int hk = h / (Hq / Hkv);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads Q and dO once, then K and V tile by tile
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_k = &tm_k;
      const CUtensorMap* map_v = &tm_v;
      mbar_arrive_expect_tx(q_full, 4 * NB * Q_BOX);
      for (int w = 0; w < 2; ++w)
        for (int j = 0; j < NB; ++j) {
          load_head_box<D, DA>(q_smem + (NB * w + j) * Q_BOX, &tm_q, q_full, h, j, b * S + q0 + 64 * w);
          load_head_box<D, DA>(do_smem + (NB * w + j) * Q_BOX, &tm_do, q_full, h, j, b * S + q0 + 64 * w);
        }
      int stage = 0;
      uint32_t phase = 0;
      walk_k_tiles<DQ_KT>(seg_rng, b, S, q0, DQ_BQ, causal, [&](int k0, bool) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * DQ_STAGE;
        mbar_arrive_expect_tx(k_full + 8 * stage, NB * DQ_KBOX);
        for (int j = 0; j < NB; ++j)
          load_head_box<D, DA>(st + j * DQ_KBOX, map_k, k_full + 8 * stage, hk, j, b * S + k0);
        mbar_arrive_expect_tx(v_full + 8 * stage, NB * DQ_KBOX);
        for (int j = 0; j < NB; ++j)
          load_head_box<D, DA>(st + (NB + j) * DQ_KBOX, map_v, v_full + 8 * stage, hk, j, b * S + k0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw ..
    setmaxnreg_inc<DQ_CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r0 = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // fragment rows r0, r0 + 8 of the 64
    const int qi0 = q0 + 64 * cw + r0, qi1 = qi0 + 8;
    const int* segb = seg + (int64_t)b * S;
    const int sq0 = segb[qi0], sq1 = segb[qi1];
    // each row's LSE (in log2 units; a row without a visible key has LSE
    // -1e30, read as 0, reference :188) and delta, once per q tile
    const float* lrow = lse + ((int64_t)b * Hq + h) * S;
    const float* drow = delta + ((int64_t)b * Hq + h) * S;
    const float ls0 = (lrow[qi0] <= 0.5f * NEG ? 0.f : lrow[qi0]) * LOG2E;
    const float ls1 = (lrow[qi1] <= 0.5f * NEG ? 0.f : lrow[qi1]) * LOG2E;
    const float dl0 = drow[qi0], dl1 = drow[qi1];
    const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 instead of exp
    const uint32_t qa = q_smem + NB * cw * Q_BOX;
    const uint32_t da = do_smem + NB * cw * Q_BOX;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    walk_k_tiles<DQ_KT>(seg_rng, b, S, q0, DQ_BQ, causal, [&](int k0, bool masked) {
      const uint32_t st = ring + stage * DQ_STAGE;
      // S = Q K^T and dP = dO V^T, all four operands K-major; the first step
      // of each ignores the accumulator (scale_d 0)
      float s[NS], dp[NS];
      mbar_wait(k_full + 8 * stage, phase);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = 32 * (kd % 4);
        wgmma_m64n64k16<0>(s, wgmma_desc(qa + (kd / 4) * Q_BOX + off, 16, 1024),
                           wgmma_desc(st + (kd / 4) * DQ_KBOX + off, 16, 1024), kd > 0);
      }
      wgmma_commit();
      mbar_wait(v_full + 8 * stage, phase);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = 32 * (kd % 4);
        wgmma_m64n64k16<0>(dp, wgmma_desc(da + (kd / 4) * Q_BOX + off, 16, 1024),
                           wgmma_desc(st + (NB + kd / 4) * DQ_KBOX + off, 16, 1024), kd > 0);
      }
      wgmma_commit();
      // P = exp2(S scale log2 e - LSE log2 e) in the accumulator layout: this
      // thread holds rows r0 (s[4j], s[4j+1]) and r0 + 8 (s[4j+2], s[4j+3]),
      // keys 8j + 2t (+1)
      wgmma_wait<1>();
      fence_regs(s);
      if (masked) {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          const int kj = k0 + 8 * j + 2 * t;
          const int2 sk = *reinterpret_cast<const int2*>(segb + kj);
          s[4 * j + 0] = visible(qi0, kj, sq0, sk.x, causal) ? exp2f(fmaf(s[4 * j + 0], sl2, -ls0)) : 0.f;
          s[4 * j + 1] = visible(qi0, kj + 1, sq0, sk.y, causal) ? exp2f(fmaf(s[4 * j + 1], sl2, -ls0)) : 0.f;
          s[4 * j + 2] = visible(qi1, kj, sq1, sk.x, causal) ? exp2f(fmaf(s[4 * j + 2], sl2, -ls1)) : 0.f;
          s[4 * j + 3] = visible(qi1, kj + 1, sq1, sk.y, causal) ? exp2f(fmaf(s[4 * j + 3], sl2, -ls1)) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          s[4 * j + 0] = exp2f(fmaf(s[4 * j + 0], sl2, -ls0));
          s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -ls0));
          s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -ls1));
          s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -ls1));
        }
      }
      // dS = P (dP - delta) scale, in bf16 registers: the A operand of
      // dQ += dS K, with K MN-major (head dims contiguous: K's NB boxes
      // DQ_KBOX apart) from the box S read K-major, 16 keys per step
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t ds[NS / 2];
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        ds[2 * j] = pack_f32(s[4 * j + 0] * (dp[4 * j + 0] - dl0) * scale,
                             s[4 * j + 1] * (dp[4 * j + 1] - dl0) * scale);
        ds[2 * j + 1] = pack_f32(s[4 * j + 2] * (dp[4 * j + 2] - dl1) * scale,
                                 s[4 * j + 3] * (dp[4 * j + 3] - dl1) * scale);
      }
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_KT / 16; ++kk)
        wgmma_rs<D, 1>(dq, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                       wgmma_desc(st + 2048 * kk, DQ_KBOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage's K and V are consumed
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    });

    // Epilogue: dQ in bf16 into this warpgroup's Q boxes (its Q is no longer
    // read) in the 128-byte swizzle, then NB TMA stores
    unsigned char* qb = smem_raw + (qa - raw);
    const int sw = r0 & 7;  // the same for r0 + 8
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* pj = qb + (j / 8) * Q_BOX + ((j & 7) ^ sw) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(pj + r0 * 128) = pack_f32(dq[4 * j], dq[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(pj + (r0 + 8) * 128) = pack_f32(dq[4 * j + 2], dq[4 * j + 3]);
    }
    fence_proxy_async();
    if (cw == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < NB; ++j) store_head_box<D, DA>(&tm_dq, qa + j * Q_BOX, h, j, b * S + q0 + 64 * cw);
      bulk_commit();
      bulk_wait<0>();  // the block's shared memory outlives the stores
    }
  }
}

template <int D, int DA = D>
int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                        const void* seg_rng, const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int S, int Hq, int Hkv, float scale, int causal,
                        cudaStream_t stream) {
  typedef DqTile<D> T;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread too), which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tma_kernel<D, DA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  const uint64_t rows = (uint64_t)B * S;
  int err = encode_heads<D, DA>(&tm_q, q, rows, Hq, 64);
  if (!err) err = encode_heads<D, DA>(&tm_do, dout, rows, Hq, 64);
  if (!err) err = encode_heads<D, DA>(&tm_dq, dq, rows, Hq, 64);
  if (!err) err = encode_heads<D, DA>(&tm_k, k, rows, Hkv, DQ_KT);
  if (!err) err = encode_heads<D, DA>(&tm_v, v, rows, Hkv, DQ_KT);
  if (err) return err;
  dim3 grid(Hq, B, S / DQ_BQ);
  flash_bwd_dq_tma_kernel<D, DA><<<grid, 384, T::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dq, (const int*)seg, (const int*)seg_rng, (const float*)lse,
      (const float*)delta, S, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launch on the given stream (cudaErrorInvalidValue for a head dim
// it was not built for); the caller checks shapes, types and contiguity
// (S % 128 == 0, Hq % Hkv == 0, D in 64 / 80 / 128 / 256, 16-byte aligned).
extern "C" {

// tokens per block of the seg_rng argument, so the caller can check its layout
int vt_seg_range_block(void) { return RB; }

int vt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                 const void* seg_rng, void* o, void* lse, int B, int S, int Hq, int Hkv, int D,
                 float scale, int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_flash_fwd<64, FWD_CW>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal, st);
    case 72: return launch_flash_fwd<128, FWD_CW, 72>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal, st);
    case 80: return launch_flash_fwd<128, FWD_CW, 80>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal, st);
    case 128: return launch_flash_fwd<128, FWD_CW>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal, st);
    case 256: return launch_flash_fwd<256, FWD_CW>(q, k, v, seg, seg_rng, o, lse, B, S, Hq, Hkv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

int vt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                     const void* seg_rng, const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, void* ws, int split, int B, int S, int Hq, int Hkv, int D,
                     float scale, int causal, void* stream) {
  // split: the wrapper's dkv_group_split; ws holds 2 * split f32 planes when split > 1
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_flash_bwd_dkv<64>(q, k, v, seg, seg_rng, dout, lse, delta,
                                             dk, dv, ws, split, B, S, Hq, Hkv, scale, causal, st);
    case 72: return launch_flash_bwd_dkv<128, 72>(q, k, v, seg, seg_rng, dout, lse, delta,
                                                  dk, dv, ws, split, B, S, Hq, Hkv, scale, causal, st);
    case 80: return launch_flash_bwd_dkv<128, 80>(q, k, v, seg, seg_rng, dout, lse, delta,
                                                  dk, dv, ws, split, B, S, Hq, Hkv, scale, causal, st);
    case 128: return launch_flash_bwd_dkv<128>(q, k, v, seg, seg_rng, dout, lse, delta,
                                               dk, dv, ws, split, B, S, Hq, Hkv, scale, causal, st);
    case 256: return launch_flash_bwd_dkv<256>(q, k, v, seg, seg_rng, dout, lse, delta,
                                               dk, dv, ws, split, B, S, Hq, Hkv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

int vt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                    const void* seg_rng, const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int Hq, int Hkv, int D, float scale, int causal,
                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_flash_bwd_dq<64>(q, k, v, seg, seg_rng, dout, lse, delta, dq, B, S, Hq, Hkv,
                                            scale, causal, st);
    case 72: return launch_flash_bwd_dq<128, 72>(q, k, v, seg, seg_rng, dout, lse, delta, dq, B, S, Hq,
                                                 Hkv, scale, causal, st);
    case 80: return launch_flash_bwd_dq<128, 80>(q, k, v, seg, seg_rng, dout, lse, delta, dq, B, S, Hq,
                                                 Hkv, scale, causal, st);
    case 128: return launch_flash_bwd_dq<128>(q, k, v, seg, seg_rng, dout, lse, delta, dq, B, S, Hq, Hkv,
                                              scale, causal, st);
    case 256: return launch_flash_bwd_dq<256>(q, k, v, seg, seg_rng, dout, lse, delta, dq, B, S, Hq, Hkv,
                                              scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
