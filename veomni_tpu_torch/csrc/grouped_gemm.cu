// Grouped GEMM for Hopper (sm_90a): forward (K4), dLHS (K5), dRHS (K6).
//
// Replaces the Pallas TPU kernels of veomni_tpu/ops/pallas/grouped_gemm.py:
//   K4 gmm_fwd_kernel  <- _gmm_kernel      (:37-61, launched by _gmm_raw :79)
//   K5 gmm_dlhs_kernel <- _gmm_dlhs_kernel (:104-130, launched by _gmm_dlhs :133)
//   K6 gmm_t_kernel    <- _gmm_t_kernel    (:166-190, launched by _gmm_transpose :193)
//
// What they compute (same as the Pallas kernels). Rows of lhs [M,K] are
// sorted by expert; expert e owns rows [starts[e], starts[e+1]) (starts
// [E+1] int32, the prefix sum of the group sizes, non-decreasing):
//   K4  out[M,N]    = lhs[r,:] @ rhs[e(r)]            rhs [E,K,N]
//   K5  dlhs[M,K]   = g[r,:] @ rhs[e(r)]^T            g [M,N], contracting N
//   K6  drhs[E,K,N] = sum over rows r of e: lhs[r,:]^T g[r,:]; zero for an empty expert
// Products are bf16 x bf16 on the tensor cores with f32 accumulation; each
// output is written once, in bf16. A row outside every expert gives 0 (K4, K5).
// M may be any positive count (the last row tile is masked); K and N are
// multiples of 128.
//
// Layout: every tensor is contiguous row-major bf16, so rhs is N-contiguous
// ([E,K,N]), which K5 reads as a K x N block contracted along N without a
// transposed copy.
//
// What bounds them on the H100: at the MoE train step's shapes (M = 131072
// routed rows, K/N = 2048/768, E = 128) each kernel does ~2 M K N = 4.1e11
// FLOPs against ~1.1 GB of traffic, ~360 FLOPs per byte: the tensor cores
// bound them (989 TFLOP/s bf16 dense). The design answer:
//   * the Pallas grid walks (m tile, n tile, every expert) and skips the pairs
//     that do not meet; on Hopper that would launch E-fold idle blocks. Here a
//     K4/K5 block owns one (m tile, n tile), binary-searches the group starts
//     (kept in shared memory) for the first expert that meets its rows and
//     loops only over the experts that do (about 1.1 per 128-row tile at this
//     routing). Rows outside the current expert enter shared memory as zeros
//     (cp.async zero-fill), so they add nothing to the accumulator;
//   * a K6 block owns one (expert, k tile, n tile) and loops only over its
//     expert's rows, masking the tail; an empty expert writes zeros (the
//     wrapper allocates the output with torch.empty);
//   * 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync m16n8k16 fed by
//     ldmatrix (.trans where the contraction runs down the rows of the stored
//     tile: K4's and K6's right operand, K6's left operand), and a 3-stage
//     cp.async pipeline over 32-deep contraction chunks;
//   * offsets are 64 bit: M x K reaches 2.7e8 at these shapes.
// Not yet done (later work): TMA, wgmma, persistent scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output tile rows
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// 128 rows x BC contraction columns of a row-major matrix into a [128][LD_RC]
// stage: rows row0.., columns col0..; a row is zero-filled unless in [lo, hi).
__device__ __forceinline__ void load_rc(bf16* dst, const bf16* src, int64_t ld, int row0,
                                        int col0, int lo, int hi) {
#pragma unroll
  for (int i = 0; i < BM * BC / 8 / NTHREADS; ++i) {
    const int id = threadIdx.x + i * NTHREADS;
    const int r = id >> 2, c = (id & 3) * 8;
    const int row = row0 + r;
    const bool ok = row >= lo && row < hi;
    cp_async16(dst + r * LD_RC + c, ok ? src + (int64_t)row * ld + col0 + c : src, ok);
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

// First expert whose rows end after row lo (E if none); gs is non-decreasing.
__device__ __forceinline__ int first_expert(const int* gs, int E, int lo) {
  int a = 0, b = E;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (gs[mid + 1] > lo) b = mid; else a = mid + 1;
  }
  return a;
}

constexpr size_t stage_bytes(bool a_t, bool b_t) {
  return (size_t)((a_t ? CR_ELEMS : RC_ELEMS) + (b_t ? CR_ELEMS : RC_ELEMS)) * sizeof(bf16);
}
constexpr size_t FWD_PIPE = STAGES * stage_bytes(false, true);
constexpr size_t DLHS_PIPE = STAGES * stage_bytes(false, false);
constexpr size_t T_PIPE = STAGES * stage_bytes(true, true);

// ---------------------------------------------------------------- K4 forward
// grid (N / BN, ceil(M / BM)); out tile rows m0.., cols n0..
__global__ void __launch_bounds__(NTHREADS, 2)
gmm_fwd_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
               const int* __restrict__ starts, bf16* __restrict__ out, int M, int K, int N,
               int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pipe = reinterpret_cast<bf16*>(smem_raw);
  int* gs = reinterpret_cast<int*>(smem_raw + FWD_PIPE);
  for (int i = threadIdx.x; i <= E; i += NTHREADS) gs[i] = starts[i];
  __syncthreads();

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
  zero_acc(acc);
  for (int e = first_expert(gs, E, m0); e < E && gs[e] < m0 + BM; ++e) {
    const int lo = gs[e], hi = min(gs[e + 1], M);  // rows of e that exist
    if (lo >= hi) continue;  // empty expert (uniform over the block)
    const bf16* w = rhs + (int64_t)e * K * N;
    run_pipeline<false, true>(acc, pipe, K / BC, [&](bf16* As, bf16* Bs, int c) {
      load_rc(As, lhs, K, m0, c * BC, lo, hi);
      load_cr(Bs, w, N, c * BC, n0, K);
    }, wm, wn, lane);
  }
  store_tile(out, N, M, m0, n0, acc, wm, wn, lane);
}

// ---------------------------------------------------------------- K5 dLHS
// grid (K / BN, ceil(M / BM)); out tile rows m0.., cols k0.. of dlhs [M,K]
__global__ void __launch_bounds__(NTHREADS, 2)
gmm_dlhs_kernel(const bf16* __restrict__ g, const bf16* __restrict__ rhs,
                const int* __restrict__ starts, bf16* __restrict__ out, int M, int K, int N,
                int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pipe = reinterpret_cast<bf16*>(smem_raw);
  int* gs = reinterpret_cast<int*>(smem_raw + DLHS_PIPE);
  for (int i = threadIdx.x; i <= E; i += NTHREADS) gs[i] = starts[i];
  __syncthreads();

  const int k0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
  zero_acc(acc);
  for (int e = first_expert(gs, E, m0); e < E && gs[e] < m0 + BM; ++e) {
    const int lo = gs[e], hi = min(gs[e + 1], M);
    if (lo >= hi) continue;
    const bf16* w = rhs + (int64_t)e * K * N;  // rows k0.. of rhs[e], contracted along N
    run_pipeline<false, false>(acc, pipe, N / BC, [&](bf16* As, bf16* Bs, int c) {
      load_rc(As, g, N, m0, c * BC, lo, hi);
      load_rc(Bs, w, N, k0, c * BC, 0, K);
    }, wm, wn, lane);
  }
  store_tile(out, K, M, m0, k0, acc, wm, wn, lane);
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
  const size_t smem = FWD_PIPE + (size_t)(E + 1) * sizeof(int);
  cudaError_t err = allow_smem(gmm_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gmm_fwd_kernel<<<dim3(N / BN, (M + BM - 1) / BM), NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)lhs, (const bf16*)rhs, (const int*)starts, (bf16*)out, M, K, N, E);
  return (int)cudaGetLastError();
}

int vt_gmm_dlhs(const void* g, const void* rhs, const void* starts, void* out, int M, int K,
                int N, int E, void* stream) {
  const size_t smem = DLHS_PIPE + (size_t)(E + 1) * sizeof(int);
  cudaError_t err = allow_smem(gmm_dlhs_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gmm_dlhs_kernel<<<dim3(K / BN, (M + BM - 1) / BM), NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)rhs, (const int*)starts, (bf16*)out, M, K, N, E);
  return (int)cudaGetLastError();
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
