// Grouped GEMM for Hopper (sm_90a): forward (K4), dLHS (K5), dRHS (K6).
//
// Replaces the Pallas TPU kernels of veomni_tpu/ops/pallas/grouped_gemm.py:
//   K4 gmm_tma_kernel<false> <- _gmm_kernel      (:37-61, launched by _gmm_raw :79)
//   K5 gmm_tma_kernel<true>  <- _gmm_dlhs_kernel (:104-130, launched by _gmm_dlhs :133)
//   K6 gmm_t_kernel          <- _gmm_t_kernel    (:166-190, launched by _gmm_transpose :193)
//
// What they compute (same as the Pallas kernels). Rows of lhs [M,K] are
// sorted by expert; expert e owns rows [starts[e], starts[e+1]) (starts
// [E+1] int32, the prefix sum of the group sizes, non-decreasing):
//   K4  out[M,N]    = lhs[r,:] @ rhs[e(r)]            rhs [E,K,N]
//   K5  dlhs[M,K]   = g[r,:] @ rhs[e(r)]^T            g [M,N], contracting N
//   K6  drhs[E,K,N] = sum over rows r of e: lhs[r,:]^T g[r,:]; zero for an empty expert
// Products are bf16 x bf16 on the tensor cores with f32 accumulation; each
// output is written once, in bf16. A row outside every expert (at or past
// starts[E]) gives 0 (K4, K5). M may be any positive count; K and N are
// multiples of 128.
//
// Layout: every tensor is contiguous row-major bf16, so rhs is N-contiguous
// ([E,K,N]). K5 reads it as a K x N block contracted along N, without a
// transposed copy.
//
// What bounds them on the H100: at the MoE train step's shapes (M = 131072
// routed rows, E = 128; gate/up K = 2048, N = 768, down K = 768, N = 2048)
// each kernel does 2 M K N = 4.1e11 FLOPs against ~1.14 GB of traffic (each
// input read once, the output written once), ~360 FLOPs per byte, above the
// card's ~295: the tensor cores bound them (989 TFLOP/s bf16 dense, 0.417
// ms), with the bytes (0.34 ms at 3.35 TB/s) within 20% of that. So the
// design keeps the tensor cores fed and reads each input about once:
//
// K4 / K5 (one kernel template, gmm_tma_kernel; they differ only in how B is
// stored):
//   * TMA loads of 128 x 64 A tiles (lhs or g rows, contraction contiguous)
//     and 64-deep B tiles (rhs[e] viewed as [E*K, N]) into a ring of
//     1024-byte aligned stages in the 128-byte swizzle, each completed on an
//     mbarrier ("full") and handed back on another ("empty"): no thread
//     spends registers or instructions on addresses, and no __syncthreads in
//     the mainloop. Rows past M arrive as zeros (TMA's out-of-bounds fill).
//     The weights' loads ask L2 to keep them (evict-last): every row tile of
//     an expert reads them, while each band of rows is read by the few blocks
//     that share it at about the same time;
//   * wgmma from two consumer warpgroups, each 64 rows of a 128 x TN output
//     tile (TN = 256 where the output width allows it, else 128: 128 x 256
//     measured 3-14% faster at the MoE shapes, see PERF.md), f32 accumulators
//     in registers; one producer thread in a third warpgroup issues every
//     load (warp specialisation, setmaxnreg moves the registers to the
//     consumers). A is K-major; B is MN-major for K4 (rhs[e] as [K, N],
//     output columns contiguous: wgmma's transpose flag for B) and K-major
//     for K5 (rows k0.. of rhs[e], contracted along N);
//   * experts per tile: TMA cannot zero single rows, so a block takes the
//     experts that meet its tile one at a time (binary search of the group
//     starts, kept in shared memory, for the first; about 1.1 per 128-row
//     tile at this routing): the mainloop over the whole tile with rhs[e],
//     then an epilogue that writes only the expert's rows, in bf16, into the
//     output tile staged in shared memory (the 128-byte swizzle again, so the
//     8 rows a warp writes at once hit distinct banks), and resets the
//     accumulators. The rows that no expert owns are staged as 0, and the
//     whole tile leaves in one TMA store per 64 columns, asynchronous, with
//     rows past M clipped by TMA. (Stores from registers, 4 bytes a thread
//     in 16-byte pieces of rows, made the epilogue the largest cost: PERF.md);
//   * a persistent, dynamic schedule: one block per SM; its producer draws
//     tile numbers in order from an atomic counter and hands them to the
//     consumers through a 2-slot ring of shared-memory mbarriers. A tile that
//     two experts share costs two passes, and static striding left some
//     blocks with many more of those than others (PERF.md); drawn in order,
//     the tiles in flight still share a few experts' weights and a band of
//     rows in the 50 MB L2 (all column tiles of a row tile are adjacent). The
//     producer loads the next tile's stages during an epilogue. The ring has
//     3 stages at TN 256 (5 at 128): the staged tile takes the room of a
//     fourth.
// K6 (not yet redesigned: TMA, wgmma and a persistent schedule are later
// work) owns one (expert, k tile, n tile), loops over its expert's rows
// masking the tail, 128 x 128 tiles of 8 warps of 64 x 32 with mma.sync
// m16n8k16 fed by ldmatrix.trans, a 3-stage cp.async pipeline over 32-deep
// chunks, and writes zeros for an empty expert (the wrapper allocates the
// output with torch.empty). Offsets are 64 bit: M x K reaches 2.7e8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// K6's tiling
constexpr int BM = 128;  // output tile rows (K4 and K5 too)
constexpr int BN = 128;  // output tile cols
constexpr int BC = 32;   // contraction depth of one pipeline stage
constexpr int STAGES = 3;
constexpr int WM = 64, WN = 32;  // warp tile: 2 x 4 warps cover 128 x 128
constexpr int NTHREADS = (BM / WM) * (BN / WN) * 32;
// Padded shared-memory rows (bf16): the 8 row addresses of one ldmatrix
// phase fall in distinct banks (80 B and 272 B strides).
constexpr int LD_RC = BC + 8;   // tile stored [128 rows][contraction]
constexpr int LD_CR = BN + 8;   // tile stored [contraction][128 cols]
constexpr int RC_ELEMS = BM * LD_RC;
constexpr int CR_ELEMS = BC * LD_CR;

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared; with pred false the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 32-deep contraction chunk into the accumulators of this warp's 64 x 32
// sub-tile. A is the [out rows x contraction] operand, B the [contraction x
// out cols] one. A_T / B_T: the stage stores that operand contraction-major
// ([BC][LD_CR]) and ldmatrix transposes it; otherwise it is stored
// [128][LD_RC] with the contraction contiguous.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4][4], const bf16* As, const bf16* Bs,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BC; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mr = wm * WM + i * 16;
      if (A_T) {
        ldsm_x4_t(a[i], As + (kk + (lane & 7) + (lane >> 4) * 8) * LD_CR + mr + ((lane >> 3) & 1) * 8);
      } else {
        ldsm_x4(a[i], As + (mr + (lane & 15)) * LD_RC + kk + (lane >> 4) * 8);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int nb = wn * WN + j * 8;
      uint32_t r[4];
      if (B_T) {
        ldsm_x4_t(r, Bs + (kk + (lane & 15)) * LD_CR + nb + (lane >> 4) * 8);
      } else {
        ldsm_x4(r, Bs + (nb + (lane & 7) + (lane >> 4) * 8) * LD_RC + kk + ((lane >> 3) & 1) * 8);
      }
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j]);
  }
}

// BC rows x 128 columns of a row-major matrix into a [BC][LD_CR] stage:
// rows row0.., columns col0..; a row is zero-filled unless below hi.
__device__ __forceinline__ void load_cr(bf16* dst, const bf16* src, int64_t ld, int row0,
                                        int col0, int hi) {
#pragma unroll
  for (int i = 0; i < BC * BN / 8 / NTHREADS; ++i) {
    const int id = threadIdx.x + i * NTHREADS;
    const int r = id >> 4, c = (id & 15) * 8;
    const int row = row0 + r;
    const bool ok = row < hi;
    cp_async16(dst + r * LD_CR + c, ok ? src + (int64_t)row * ld + col0 + c : src, ok);
  }
}

// The multi-stage cp.async pipeline over nchunks contraction chunks;
// load(As, Bs, chunk) issues one chunk's copies into a stage.
template <bool A_T, bool B_T, typename Load>
__device__ __forceinline__ void run_pipeline(float (&acc)[4][4][4], bf16* smem, int nchunks,
                                             Load load, int wm, int wn, int lane) {
  constexpr int A_ELEMS = A_T ? CR_ELEMS : RC_ELEMS;
  constexpr int STAGE = A_ELEMS + (B_T ? CR_ELEMS : RC_ELEMS);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(smem + s * STAGE, smem + s * STAGE + A_ELEMS, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and chunk c-1's stage is free
    const int nxt = c + STAGES - 1;
    if (nxt < nchunks) {
      bf16* st = smem + (nxt % STAGES) * STAGE;
      load(st, st + A_ELEMS, nxt);
    }
    cp_async_commit();
    const bf16* st = smem + (c % STAGES) * STAGE;
    mma_chunk<A_T, B_T>(acc, st, st + A_ELEMS, wm, wn, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages may be refilled by the next call
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// The 128 x 128 tile at (row0, col0) of a row-major [rows, ld] bf16 output;
// rows at or past `rows` (the masked tail of the last row tile) are not written.
__device__ __forceinline__ void store_tile(bf16* out, int64_t ld, int rows, int row0, int col0,
                                           const float (&acc)[4][4][4], int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + wm * WM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + wn * WN + j * 8 + 2 * t;
      if (r < rows)
        *reinterpret_cast<uint32_t*>(out + (int64_t)r * ld + c) = pack_f32(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < rows)
        *reinterpret_cast<uint32_t*>(out + (int64_t)(r + 8) * ld + c) =
            pack_f32(acc[i][j][2], acc[i][j][3]);
    }
  }
}

constexpr size_t stage_bytes(bool a_t, bool b_t) {
  return (size_t)((a_t ? CR_ELEMS : RC_ELEMS) + (b_t ? CR_ELEMS : RC_ELEMS)) * sizeof(bf16);
}
constexpr size_t T_PIPE = STAGES * stage_bytes(true, true);

// First expert whose rows end after row lo (E if none); gs is non-decreasing.
__device__ __forceinline__ int first_expert(const int* gs, int E, int lo) {
  int a = 0, b = E;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (gs[mid + 1] > lo) b = mid; else a = mid + 1;
  }
  return a;
}

// ------------------------------------------------------- K4 / K5: TMA + wgmma
constexpr int BK = 64;            // contraction depth of a stage: one 128-byte swizzled row
constexpr int GMM_THREADS = 384;  // warpgroup 0: the producer; 1 and 2: the consumers
constexpr int A_BYTES = BM * BK * 2;     // a stage's A tile: 128 rows x 64
constexpr int B_BLOCK = BK * 64 * 2;     // K4: 64 contraction rows x 64 output columns

template <int TN>  // output tile width
struct TmaTile {
  static constexpr int B_BYTES = TN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STG_BYTES = BM * TN * 2;  // the output tile, staged for TMA stores
  static constexpr int STAGES = (216 * 1024 - STG_BYTES) / STAGE_BYTES;  // 3 at TN 256, 5 at 128
  static constexpr int ACC = TN / 2;  // f32 accumulators per consumer thread
  // dynamic shared memory: 1024 bytes of alignment slack, the ring, the
  // staged output tile, a full and an empty barrier per stage, the tile
  // ring (2 full and 2 empty barriers, 2 tile numbers, padding), the E+1
  // starts
  static size_t smem_bytes(int E) {
    return 1024 + (size_t)STAGES * (STAGE_BYTES + 16) + STG_BYTES + 48 + (size_t)(E + 1) * sizeof(int);
  }
};

// One output tile t (row tile t / col_tiles, column tile t % col_tiles):
// for each expert that owns rows of the tile, expert(m0, w0, e, lo, hi,
// nchunks) with the tile's first row m0 and column w0, the expert's rows
// [lo, hi) clamped to M, and the contraction chunks to run; then
// tile_done(m0, w0). The producer and the consumers walk the same tiles over
// the same shared-memory starts, so they agree on every stage of the ring.
// (DLHS names the kernel, K5 if true; gmm_fault_check plants its K4 and K5
// faults on the expert call.)
template <bool DLHS, int TN, typename Expert, typename TileDone>
__device__ __forceinline__ void walk_tile(const int* gs, int E, int M, int col_tiles, int t,
                                          int nchunks, Expert expert, TileDone tile_done) {
  const int m0 = t / col_tiles * BM, w0 = t % col_tiles * TN;
  const int mend = min(m0 + BM, M);
  for (int e = first_expert(gs, E, m0); e < E && gs[e] < mend; ++e) {
    const int lo = gs[e], hi = min(gs[e + 1], M);  // rows of e that exist
    if (lo >= hi) continue;  // empty expert (uniform over the block)
    expert(m0, w0, e, lo, hi, nchunks);
  }
  tile_done(m0, w0);
}

// Tile tickets of the dynamic schedule: a launch draws from one slot (the
// host rotates through them, so launches on two streams at once do not
// share one), and the block that draws the launch's last ticket sets it
// back to 0.
constexpr int TICKET_SLOTS = 64;
__device__ unsigned int g_tickets[TICKET_SLOTS];
std::atomic<unsigned int> g_launches{0};

template <int TN, int TRANS_B>
__device__ __forceinline__ void wgmma_tile(float (&d)[TN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (TN == 256) {
    wgmma_m64n256k16<TRANS_B>(d, desc_a, desc_b, 1);
  } else {
    wgmma_m64n128k16<TRANS_B>(d, desc_a, desc_b, 1);
  }
}

template <int R>
__device__ __forceinline__ void zero_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// This thread's two fragment rows r0 and r0 + 8 (of the tile at row m0) of
// a 64 x TN accumulator, columns c0 + 8j (+1), into the staged output tile:
// TN / 64 boxes of 128 rows x 128 bytes in the 128-byte swizzle (16-byte
// chunk k of row r at chunk k ^ (r % 8); the 8 rows a warp writes at once
// fall in 8 distinct chunks, so no bank is hit twice). The rows whose output
// row lies in [lo, hi) get the accumulators (ZERO: zeros).
template <int TN, bool ZERO>
__device__ __forceinline__ void stage_rows(unsigned char* stg, int m0, int r0, int c0, int lo,
                                           int hi, const float (&d)[TN / 2]) {
  const int sw = r0 & 7;  // the same for r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (m0 + r >= lo && m0 + r < hi) {
      unsigned char* p = stg + r * 128 + c0 * 2;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + (j / 8) * (BM * 128) + ((j & 7) ^ sw) * 16) =
            ZERO ? 0u : pack_f32(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// K4 (DLHS false): out [M, W = N] from A = lhs [M, C = K] and rhs [E, K, N].
// K5 (DLHS true):  out [M, W = K] from A = g [M, C = N] and rhs [E, K, N].
// tm_a: A in BM x BK boxes; tm_b: rhs as [E*K, N] in BK x 64 boxes (K4) or
// TN x BK boxes (K5). grid: min(tiles, SMs); block: GMM_THREADS.
template <bool DLHS, int TN>
__global__ void __launch_bounds__(GMM_THREADS, 1)
gmm_tma_kernel(__grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_b,
               __grid_constant__ const CUtensorMap tm_out, const int* __restrict__ starts, int M,
               int K, int W, int C, int E, int slot) {
  typedef TmaTile<TN> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t stg = ring + T::STAGES * T::STAGE_BYTES;  // the staged output tile
  const uint32_t full_bar = stg + T::STG_BYTES;            // stage s: + 8 s
  const uint32_t empty_bar = full_bar + 8 * T::STAGES;
  // the tile ring: the producer hands each tile number to the consumers
  const uint32_t tile_full = empty_bar + 8 * T::STAGES;  // slot s: + 8 s, 2 slots
  const uint32_t tile_empty = tile_full + 16;
  int* tile_id = reinterpret_cast<int*>(smem_raw + (tile_empty + 16 - raw));
  int* gs = tile_id + 4;
  for (int i = threadIdx.x; i <= E; i += GMM_THREADS) gs[i] = starts[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);      // the producer's arrival + the stage's TMA bytes
      mbar_init(empty_bar + 8 * s, 8);     // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tile_full + 8 * s, 1);
      mbar_init(tile_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nchunks = C / BK;
  const int col_tiles = W / TN;
  const int tiles = (M + BM - 1) / BM * col_tiles;

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_a = &tm_a;  // param-space addresses, as TMA wants them
      const CUtensorMap* map_b = &tm_b;
      const uint64_t keep = l2_evict_last();  // rhs[e] is read by every row tile of e
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](int m0, int w0, int e, int, int, int n) {
            for (int c = 0; c < n; ++c) {
              mbar_wait(empty_bar + 8 * stage, phase ^ 1);  // the consumers freed the stage
              const uint32_t full = full_bar + 8 * stage;
              const uint32_t a = ring + stage * T::STAGE_BYTES, b = a + A_BYTES;
              mbar_arrive_expect_tx(full, T::STAGE_BYTES);
              tma_load_2d(a, map_a, full, c * BK, m0);
              if constexpr (DLHS) {  // rows w0.. of rhs[e], contraction chunk c
                tma_load_2d_hint(b, map_b, full, c * BK, e * K + w0, keep);
              } else {  // contraction rows c*BK.. of rhs[e], 64 columns at a time
#pragma unroll
                for (int j = 0; j < TN / 64; ++j)
                  tma_load_2d_hint(b + j * B_BLOCK, map_b, full, w0 + 64 * j, e * K + c * BK, keep);
              }
              if (++stage == T::STAGES) {
                stage = 0;
                phase ^= 1;
              }
            }
          };
      // The dynamic schedule: tiles go out in order, each to the first
      // block that is free, so blocks that drew tiles of two experts do not
      // hold up the launch. The next ticket is drawn before this tile's
      // loads, so the atomic's round trip hides behind them.
      unsigned int* ticket = &g_tickets[slot];
      const int last = tiles + (int)gridDim.x - 1;  // every block draws one ticket past the tiles
      int t = (int)atomicAdd(ticket, 1u);
      if (t == last) atomicExch(ticket, 0u);
      for (int i = 0;; ++i) {  // slot i % 2, phase (i / 2) % 2
        const int s = i & 1;
        mbar_wait(tile_empty + 8 * s, ((i >> 1) & 1) ^ 1);
        tile_id[s] = t;
        mbar_arrive(tile_full + 8 * s);
        if (t >= tiles) break;
        const int next = (int)atomicAdd(ticket, 1u);
        walk_tile<DLHS, TN>(gs, E, M, col_tiles, t, nchunks, load, [](int, int) {});
        if (next == last) atomicExch(ticket, 0u);
        t = next;
      }
    }
  } else {
    // ---- consumers: warpgroup cw computes rows 64 cw.. of each tile
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    const int row = cw * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // fragment row (+8)
    const int col = 2 * (lane & 3);                                       // fragment column (+8j)
    unsigned char* stg_p = smem_raw + (stg - raw);
    const CUtensorMap* map_out = &tm_out;
    const bool storer = threadIdx.x == 128;  // issues and waits for the tile's TMA stores
    bool staging = false;                    // this tile's staging has begun
    auto begin_staging = [&]() {  // once per tile: the previous tile's stores have read it
      if (!staging) {
        if (storer) bulk_wait_read<0>();
        named_barrier<1, 256>();
        staging = true;
      }
    };
    float acc[T::ACC];
    zero_regs(acc);
    int stage = 0;
    uint32_t phase = 0;
    auto compute = [&](int m0, int w0, int, int lo, int hi, int n) {
          int used = 0;  // the stage of the previous chunk
          for (int c = 0; c < n; ++c) {
            mbar_wait(full_bar + 8 * stage, phase);  // the stage's bytes have landed
            const uint32_t a = ring + stage * T::STAGE_BYTES + cw * (A_BYTES / 2);
            const uint32_t b = ring + stage * T::STAGE_BYTES + A_BYTES;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k) {  // 16-deep steps: 32 bytes along a swizzled row
              const uint64_t da = wgmma_desc(a + 32 * k, 16, 1024);
              if constexpr (DLHS) {
                wgmma_tile<TN, 0>(acc, da, wgmma_desc(b + 32 * k, 16, 1024));
              } else {  // 16 contraction rows of 128 bytes per step; 64-column blocks B_BLOCK apart
                wgmma_tile<TN, 1>(acc, da, wgmma_desc(b + 2048 * k, B_BLOCK, 1024));
              }
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous chunk's products are done: free its stage
            if (c > 0 && lane == 0) mbar_arrive(empty_bar + 8 * used);
            used = stage;
            if (++stage == T::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          wgmma_wait<0>();
          fence_regs(acc);
          if (n > 0 && lane == 0) mbar_arrive(empty_bar + 8 * used);
          begin_staging();
          stage_rows<TN, false>(stg_p, m0, row, col, lo, hi, acc);  // e's rows only
          zero_regs(acc);
        };
    auto finish = [&](int m0, int w0) {
          begin_staging();
          stage_rows<TN, true>(stg_p, m0, row, col, gs[E], M, acc);  // rows no expert owns
          fence_proxy_async();
          named_barrier<1, 256>();
          if (storer) {  // rows past M are not written
#pragma unroll
            for (int j = 0; j < TN / 64; ++j) tma_store_2d(map_out, stg + j * BM * 128, w0 + 64 * j, m0);
            bulk_commit();
          }
          staging = false;
        };
    for (int i = 0;; ++i) {  // slot i % 2, phase (i / 2) % 2
      const int s = i & 1;
      mbar_wait(tile_full + 8 * s, (i >> 1) & 1);
      const int t = tile_id[s];
      __syncwarp();  // every lane has read the slot
      if (lane == 0) mbar_arrive(tile_empty + 8 * s);
      if (t >= tiles) break;
      walk_tile<DLHS, TN>(gs, E, M, col_tiles, t, nchunks, compute, finish);
    }
    if (storer) bulk_wait<0>();
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// K4 (DLHS false): a = lhs [M,K], out [M,N]. K5 (DLHS true): a = g [M,N],
// out [M,K]. Tensor maps are encoded per call (the pointers change) and
// passed by value as kernel parameters.
template <bool DLHS, int TN>
int launch_gmm_tma(const void* a, const void* rhs, const void* starts, void* out, int M, int K,
                   int N, int E, cudaStream_t stream) {
  typedef TmaTile<TN> T;
  const int W = DLHS ? K : N, C = DLHS ? N : K;
  const size_t smem = T::smem_bytes(E);
  // A runtime call first: it makes the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // cuTensorMapEncodeTiled below needs.
  cudaError_t e = cudaFuncSetAttribute(gmm_tma_kernel<DLHS, TN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the thread's error state stays clean for the next call
    return (int)e;
  }
  CUtensorMap tm_a, tm_b, tm_out;
  int err = encode_bf16_2d(&tm_a, a, M, C, BM, BK);
  if (!err) err = encode_bf16_2d(&tm_b, rhs, (uint64_t)E * K, N, DLHS ? TN : BK, DLHS ? BK : 64);
  if (!err) err = encode_bf16_2d(&tm_out, out, M, W, BM, 64);
  if (err) return err;
  const int slot = (int)(g_launches.fetch_add(1) % TICKET_SLOTS);
  const int tiles = (M + BM - 1) / BM * (W / TN), sms = sm_count();
  gmm_tma_kernel<DLHS, TN><<<tiles < sms ? tiles : sms, GMM_THREADS, smem, stream>>>(
      tm_a, tm_b, tm_out, (const int*)starts, M, K, W, C, E, slot);
  return (int)cudaGetLastError();
}

// The output tile width: 256 where the output width is a multiple of it.
template <bool DLHS>
int launch_gmm(const void* a, const void* rhs, const void* starts, void* out, int M, int K, int N,
               int E, void* stream) {
  const int W = DLHS ? K : N;
  return W % 256 == 0
             ? launch_gmm_tma<DLHS, 256>(a, rhs, starts, out, M, K, N, E, (cudaStream_t)stream)
             : launch_gmm_tma<DLHS, 128>(a, rhs, starts, out, M, K, N, E, (cudaStream_t)stream);
}

// ---------------------------------------------------------------- K6 dRHS
// grid (N / BN, K / BM, E); out tile rows k0.., cols n0.. of drhs[e] [K,N]
__global__ void __launch_bounds__(NTHREADS, 2)
gmm_t_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ g,
             const int* __restrict__ starts, bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pipe = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
  // rows of expert e, clamped to the M rows that exist (the only reads not
  // bounded by an output tile)
  const int hi = min(starts[e + 1], M), lo = min(starts[e], hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
  zero_acc(acc);
  // rows lo.. in chunks of BC; the last chunk is masked at hi
  run_pipeline<true, true>(acc, pipe, (hi - lo + BC - 1) / BC, [&](bf16* As, bf16* Bs, int c) {
    load_cr(As, lhs, K, lo + c * BC, k0, hi);
    load_cr(Bs, g, N, lo + c * BC, n0, hi);
  }, wm, wn, lane);
  store_tile(out + (int64_t)e * K * N, N, K, k0, n0, acc, wm, wn, lane);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launch on the given stream; the caller checks shapes, types and
// contiguity (M > 0; K, N multiples of 128; starts [E+1] int32,
// non-decreasing, starts[0] = 0; rows past M are never read).
extern "C" {

// output tile edge; the wrapper checks its alignment rule against it
int vt_gmm_tile(void) { return BM; }

int vt_gmm_fwd(const void* lhs, const void* rhs, const void* starts, void* out, int M, int K,
               int N, int E, void* stream) {
  return launch_gmm<false>(lhs, rhs, starts, out, M, K, N, E, stream);
}

int vt_gmm_dlhs(const void* g, const void* rhs, const void* starts, void* out, int M, int K,
                int N, int E, void* stream) {
  return launch_gmm<true>(g, rhs, starts, out, M, K, N, E, stream);
}

int vt_gmm_t(const void* lhs, const void* g, const void* starts, void* out, int M, int K, int N,
             int E, void* stream) {
  cudaError_t err = allow_smem(gmm_t_kernel, T_PIPE);
  if (err != cudaSuccess) return (int)err;
  gmm_t_kernel<<<dim3(N / BN, K / BM, E), NTHREADS, T_PIPE, (cudaStream_t)stream>>>(
      (const bf16*)lhs, (const bf16*)g, (const int*)starts, (bf16*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
