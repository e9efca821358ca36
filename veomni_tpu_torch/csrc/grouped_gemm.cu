// Grouped GEMM for Hopper (sm_90a): forward (K4), dLHS (K5), dRHS (K6).
//
// Replaces the Pallas TPU kernels of veomni_tpu/ops/pallas/grouped_gemm.py:
//   K4 gmm_tma_kernel<false> <- _gmm_kernel      (:37-61, launched by _gmm_raw :79)
//   K5 gmm_tma_kernel<true>  <- _gmm_dlhs_kernel (:104-130, launched by _gmm_dlhs :133)
//   K6 gmm_t_tma_kernel      <- _gmm_t_kernel    (:166-190, launched by _gmm_transpose :193)
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
// multiples of 8 (TMA's rule: a row of a tensor map is a multiple of 16
// bytes).
//
// Widths that are not a multiple of the tiles (128 rows of K6's K, 128 or
// 256 output columns, 64-deep contraction chunks): the last tiles reach past
// the tensor, and TMA's out-of-bounds handling covers them. A load fills the
// part of a box outside the tensor with zeros, so a contraction tail adds
// nothing (its lhs or g columns are zeros), and a store leaves out the part
// outside, so an output tail is never written. For that the box must meet
// the tensor's own edge, not the next expert's rows: K4 reads rhs as a 3-D
// tensor [E, K, N] (its contraction tail of expert e reads zeros, not the
// rows of e + 1) and K6 writes drhs as [E, K, N] (its K tail of e is not
// written over e + 1's first rows). K5's B tile holds output rows of rhs[e]:
// its K tail reads e + 1's rows, and their products land in output columns
// at or past K, which the store leaves out.
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
// K6 (gmm_t_tma_kernel) is built from the same blocks and the same ring,
// tile ring, ticket counters and staged TMA-store epilogue:
//   * an output tile is 128 rows of K x TN columns of N of one expert's
//     drhs[e] (TN as above); each consumer warpgroup owns 64 K rows. The
//     mainloop runs over the expert's rows [starts[e], min(starts[e+1], M))
//     in 64-row chunks; a stage holds the chunk's lhs rows x the tile's 128
//     K columns (one 64-column box per consumer warpgroup) and its g rows x
//     TN columns. The rows are the contraction and the strided dimension of
//     both, so both operands are MN-major (wgmma's transpose flags for A and
//     B);
//   * expert boundaries: a chunk may start at any row, but TMA fills zeros
//     only past M, so the expert's last chunk reads rows of the next experts.
//     Option (a) of the design, in the lhs operand: before that chunk's
//     products each consumer warpgroup zeroes those rows of its own lhs box
//     (fence.proxy.async, then a 128-thread named barrier; no other
//     warpgroup reads the box), which makes their products 0. Rows past
//     starts[E] are only ever read as such a tail, and zeroed. An empty
//     expert runs no chunk and its tiles are staged as zeros: the wrapper
//     allocates the output with torch.empty;
//   * the epilogue overlaps the mainloops around it: the producer runs ahead
//     into the next tile's stages while the consumers stage the tile, and
//     the staging buffer is reused once the previous tile's TMA stores have
//     read it (bulk_wait_read), so the stores run during the next mainloop;
//   * the persistent schedule draws tiles in order, expert-major, from the
//     same ticket counters, so the tiles of one expert (48 at the MoE
//     shapes) share its ~5.8 MB of lhs and g rows in L2.
// Offsets are 64 bit where they must be: M x K reaches 2.7e8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int BM = 128;  // output tile rows (K6: rows of drhs[e], i.e. K)

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
// tm_a: A in BM x BK boxes; tm_b: rhs as [E, K, N] in BK x 64 boxes of one
// expert (K4) or as [E*K, N] in TN x BK boxes (K5). grid: min(tiles, SMs);
// block: GMM_THREADS.
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
  const int nchunks = (C + BK - 1) / BK;  // the last chunk's tail reads zeros
  const int col_tiles = (W + TN - 1) / TN;  // the last tile's tail is not stored
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
                  tma_load_3d_hint(b + j * B_BLOCK, map_b, full, w0 + 64 * j, c * BK, e, keep);
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
  if (!err)
    err = DLHS ? encode_bf16_2d(&tm_b, rhs, (uint64_t)E * K, N, TN, BK)
               : encode_bf16_3d(&tm_b, rhs, E, K, N, BK, 64);
  if (!err) err = encode_bf16_2d(&tm_out, out, M, W, BM, 64);
  if (err) return err;
  const int slot = (int)(g_launches.fetch_add(1) % TICKET_SLOTS);
  const int tiles = (M + BM - 1) / BM * ((W + TN - 1) / TN), sms = sm_count();
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
// One output tile t of drhs, drawn expert-major: expert t / (k_tiles *
// n_tiles), then its k tile, then its n tile, so the tiles of one expert
// (48 at the MoE shapes) run at about the same time and share its lhs and g
// rows in L2. Calls expert(e, k0, n0, lo, hi, nchunks) with the tile's first
// row k0 and column n0 of drhs[e], the expert's rows [lo, hi) clamped to M
// and the BK-row chunks that cover them (0 for an empty expert). The
// producer and the consumers walk the same tiles, so they agree on every
// stage of the ring.
template <int TN, typename Expert>
__device__ __forceinline__ void walk_t_tile(const int* gs, int M, int k_tiles, int n_tiles, int t,
                                            Expert expert) {
  const int per_expert = k_tiles * n_tiles;
  const int e = t / per_expert, r = t % per_expert;
  const int hi = min(gs[e + 1], M), lo = min(gs[e], hi);
  expert(e, r / n_tiles * BM, r % n_tiles * TN, lo, hi, (hi - lo + BK - 1) / BK);
}

// Rows [valid, BK) of one BK-row x 128-byte box of a stage become zeros
// (128 threads; whole 128-byte rows, so the swizzle does not matter).
__device__ __forceinline__ void zero_box_rows(unsigned char* box, int valid, int tid) {
  for (int i = tid; i < (BK - valid) * 8; i += 128)
    *reinterpret_cast<uint4*>(box + valid * 128 + i * 16) = make_uint4(0u, 0u, 0u, 0u);
}

template <int TN>
__device__ __forceinline__ void wgmma_t_tile(float (&d)[TN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (TN == 256) {
    wgmma_m64n256k16<1, 1>(d, desc_a, desc_b, 1);
  } else {
    wgmma_m64n128k16<1, 1>(d, desc_a, desc_b, 1);
  }
}

// K6: drhs [E, K, N] from lhs [M, K] and g [M, N]. tm_lhs, tm_g: BK x 64
// boxes (rows are the contraction, so both operands are MN-major for
// wgmma); tm_out: drhs as [E, K, N] in BM x 64 boxes of one expert. grid: min(tiles, SMs);
// block: GMM_THREADS. Shared memory is laid out as in gmm_tma_kernel
// (TmaTile<TN>): a stage holds a chunk's lhs rows x the tile's 128 K
// columns (two boxes, one per consumer warpgroup) and its g rows x the
// tile's TN columns.
template <int TN>
__global__ void __launch_bounds__(GMM_THREADS, 1)
gmm_t_tma_kernel(__grid_constant__ const CUtensorMap tm_lhs, __grid_constant__ const CUtensorMap tm_g,
                 __grid_constant__ const CUtensorMap tm_out, const int* __restrict__ starts, int M,
                 int K, int N, int E, int slot) {
  typedef TmaTile<TN> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t stg = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t full_bar = stg + T::STG_BYTES;
  const uint32_t empty_bar = full_bar + 8 * T::STAGES;
  const uint32_t tile_full = empty_bar + 8 * T::STAGES;
  const uint32_t tile_empty = tile_full + 16;
  int* tile_id = reinterpret_cast<int*>(smem_raw + (tile_empty + 16 - raw));
  int* gs = tile_id + 4;
  for (int i = threadIdx.x; i <= E; i += GMM_THREADS) gs[i] = starts[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tile_full + 8 * s, 1);
      mbar_init(tile_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int k_tiles = (K + BM - 1) / BM, n_tiles = (N + TN - 1) / TN;  // tails: zeros in, not stored
  const int tiles = E * k_tiles * n_tiles;

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full; it runs ahead into the
    // next tile's stages while the consumers stage this tile's output
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_lhs = &tm_lhs;
      const CUtensorMap* map_g = &tm_g;
      const uint64_t keep = l2_evict_last();  // every tile of the expert reads these rows
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](int, int k0, int n0, int lo, int, int n) {
            for (int c = 0; c < n; ++c) {
              mbar_wait(empty_bar + 8 * stage, phase ^ 1);
              const uint32_t full = full_bar + 8 * stage;
              const uint32_t a = ring + stage * T::STAGE_BYTES, b = a + A_BYTES;
              const int r0 = lo + c * BK;  // any row: a TMA box may start anywhere
              mbar_arrive_expect_tx(full, T::STAGE_BYTES);
              tma_load_2d_hint(a, map_lhs, full, k0, r0, keep);
              tma_load_2d_hint(a + A_BYTES / 2, map_lhs, full, k0 + 64, r0, keep);
#pragma unroll
              for (int j = 0; j < TN / 64; ++j)
                tma_load_2d_hint(b + j * B_BLOCK, map_g, full, n0 + 64 * j, r0, keep);
              if (++stage == T::STAGES) {
                stage = 0;
                phase ^= 1;
              }
            }
          };
      unsigned int* counter = &g_tickets[slot];  // the schedule of gmm_tma_kernel
      const int last = tiles + (int)gridDim.x - 1;
      int t = (int)atomicAdd(counter, 1u);
      if (t == last) atomicExch(counter, 0u);
      for (int i = 0;; ++i) {
        const int s = i & 1;
        mbar_wait(tile_empty + 8 * s, ((i >> 1) & 1) ^ 1);
        tile_id[s] = t;
        mbar_arrive(tile_full + 8 * s);
        if (t >= tiles) break;
        const int next = (int)atomicAdd(counter, 1u);
        walk_t_tile<TN>(gs, M, k_tiles, n_tiles, t, load);
        if (next == last) atomicExch(counter, 0u);
        t = next;
      }
    }
  } else {
    // ---- consumers: warpgroup cw computes K rows 64 cw.. of each tile
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    const int row = cw * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;
    const int col = 2 * (lane & 3);
    unsigned char* stg_p = smem_raw + (stg - raw);
    const CUtensorMap* map_out = &tm_out;
    const bool storer = threadIdx.x == 128;
    float acc[T::ACC];
    zero_regs(acc);
    int stage = 0;
    uint32_t phase = 0;
    auto compute = [&](int e, int k0, int n0, int lo, int hi, int n) {
          int used = 0;
          for (int c = 0; c < n; ++c) {
            mbar_wait(full_bar + 8 * stage, phase);
            // this warpgroup's 64 K columns of the chunk's lhs rows; the g rows
            const uint32_t a = ring + stage * T::STAGE_BYTES + cw * (A_BYTES / 2);
            const uint32_t b = ring + stage * T::STAGE_BYTES + A_BYTES;
            // The expert boundary: TMA fills zeros only past M, so the
            // expert's last chunk brings rows of the next experts (or rows no
            // expert owns). They become zeros in this warpgroup's own lhs box,
            // which no other warpgroup reads, before the chunk's products.
            const int valid = min(hi - (lo + c * BK), BK);  // rows of the chunk that are e's
            if (valid < BK) {
              zero_box_rows(smem_raw + (a - raw), valid, threadIdx.x & 127);
              fence_proxy_async();  // wgmma (the async proxy) sees the zeros
              if (cw == 0) named_barrier<2, 128>(); else named_barrier<3, 128>();
            }
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k)  // 16 contraction rows of 128 bytes per step
              wgmma_t_tile<TN>(acc, wgmma_desc(a + 2048 * k, B_BLOCK, 1024),
                               wgmma_desc(b + 2048 * k, B_BLOCK, 1024));
            wgmma_commit();
            wgmma_wait<1>();
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
          // The epilogue stages the tile (zeros for an empty expert: the
          // output is not zeroed beforehand) once the previous tile's stores
          // have read the buffer, which they did while this tile's mainloop
          // ran; this tile's stores run during the next tile's mainloop.
          if (storer) bulk_wait_read<0>();
          named_barrier<1, 256>();
          stage_rows<TN, false>(stg_p, 0, row, col, 0, BM, acc);
          fence_proxy_async();
          named_barrier<1, 256>();
          if (storer) {
#pragma unroll
            for (int j = 0; j < TN / 64; ++j)
              tma_store_3d(map_out, stg + j * BM * 128, n0 + 64 * j, k0, e);
            bulk_commit();
          }
          zero_regs(acc);  // the next tile's sum
        };
    for (int i = 0;; ++i) {
      const int s = i & 1;
      mbar_wait(tile_full + 8 * s, (i >> 1) & 1);
      const int t = tile_id[s];
      __syncwarp();
      if (lane == 0) mbar_arrive(tile_empty + 8 * s);
      if (t >= tiles) break;
      walk_t_tile<TN>(gs, M, k_tiles, n_tiles, t, compute);
    }
    if (storer) bulk_wait<0>();
  }
}

template <int TN>
int launch_gmm_t(const void* lhs, const void* g, const void* starts, void* out, int M, int K, int N,
                 int E, cudaStream_t stream) {
  const size_t smem = TmaTile<TN>::smem_bytes(E);
  // a runtime call first: autograd runs K6 on its backward thread (launch_gmm_tma)
  cudaError_t e = cudaFuncSetAttribute(gmm_t_tma_kernel<TN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  CUtensorMap tm_lhs, tm_g, tm_out;
  int err = encode_bf16_2d(&tm_lhs, lhs, M, K, BK, 64);
  if (!err) err = encode_bf16_2d(&tm_g, g, M, N, BK, 64);
  if (!err) err = encode_bf16_3d(&tm_out, out, E, K, N, BM, 64);
  if (err) return err;
  const int slot = (int)(g_launches.fetch_add(1) % TICKET_SLOTS);
  const int tiles = E * ((K + BM - 1) / BM) * ((N + TN - 1) / TN), sms = sm_count();
  gmm_t_tma_kernel<TN><<<tiles < sms ? tiles : sms, GMM_THREADS, smem, stream>>>(
      tm_lhs, tm_g, tm_out, (const int*)starts, M, K, N, E, slot);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after its launch on the given stream; the caller checks shapes, types and
// contiguity (M > 0; K, N multiples of 8; starts [E+1] int32,
// non-decreasing, starts[0] = 0; rows past M are never read).
extern "C" {

// what K and N must be multiples of (16 bytes of bf16: TMA's row rule); the
// wrapper checks its widths against it
int vt_gmm_align(void) { return 8; }

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
  return N % 256 == 0
             ? launch_gmm_t<256>(lhs, g, starts, out, M, K, N, E, (cudaStream_t)stream)
             : launch_gmm_t<128>(lhs, g, starts, out, M, K, N, E, (cudaStream_t)stream);
}

}  // extern "C"
