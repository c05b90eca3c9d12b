// Gram-matrix kernels for Hopper (sm_90a), bound to Python through ctypes
// (ops/kernels/gram.py). Four kernels, one shared library:
//
//   gram_fwd         G[n] = F[n]^T F[n] / HW                      (N, C, C)
//   gram_bwd         dF[n] = F[n] (dG[n] + dG[n]^T) / HW          (N, HW, C)
//   pooled_gram_fwd  G[n] = (F[n] P^T)^T (F[n] P^T) / HW          (N, S, S)
//                    with P = adaptive_pool_matrix(C, S), never built
//   pooled_gram_bwd  dF[n] = F[n] P^T (dG[n] + dG[n]^T) P / HW    (N, HW, C)
//
// F is the (N, HW, C) view of an NHWC activation (C contiguous), f32 or
// bf16; every sum is taken in f32 and the result is cast to F's type once.
// Launches go on the caller's stream, never synchronise and allocate
// nothing: the wrapper passes every output buffer in. Each C entry returns
// cudaGetLastError() so that a refused launch is seen.
//
// Sums are deterministic and no sum is taken with atomics: gram_fwd and
// pooled_gram_fwd add the partials of their HW splits in split order within
// a thread-block cluster, in one launch with no scratch in device memory.
//
// ---------------------------------------------------------------------------
// gram_fwd replaces heuristique_style_transfer_code_tpu/ops/pallas/
// gram_kernel.py::gram_pallas (pallas_call at :60). G is symmetric, so the
// work that is needed is its C(C+1)/2 distinct entries: N*HW*C*(C+1)
// operations. What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16,
// 67 TFLOP/s f32 without TF32) at the main path's shapes:
//   (4,56,56,256) bf16  bytes: 6.95 MB, 2.1 us (operations 0.8 us)
//   (4,56,56,256) f32   operations: 0.83 GFLOP, 12.3 us (bytes 4.1 us)
//   (4,7,7,2048)  bf16  bytes: 33.5 MB of output, 10.3 us
//   (4,7,7,2048)  f32   bytes: 67 MB of output, 20.5 us (operations 12.3 us)
//   (4,56,56,64)        bytes: 1.6 MB (bf16), 3.3 MB (f32), under 1 us
// Design. One launch covers every image. A block computes one 64x64 tile
// (bi <= bj) of the upper triangle for one image and one split of HW; a
// diagonal tile loads its operand once and uses it as both. The epilogue
// stages the tile in shared memory and writes it to (bi, bj) and its
// transpose to (bj, bi) with TMA or 16-byte row stores, so every output
// byte is written once, coalesced. Where the tiles leave the SMs idle
// (C = 64 or 256 at N = 4), HW is split over the blocks of a cluster, which
// reduce their partials through distributed shared memory (below): one
// launch, no scratch in device memory. Two mainloops:
//   wgmma (bf16, C % 8 == 0, 16-byte-aligned F): a producer warp issues TMA
//     loads (3-D map over (C, HW, N), 64 channels x 64 or 128 rows a box,
//     128-byte swizzle, zeros past HW and C) into a ring of stages on
//     mbarriers; one consumer warpgroup runs wgmma.m64n64k16 with both
//     operands MN-major (A = F^T, B = F) and releases each stage when the
//     group that read it retires. The epilogue's tiles leave by TMA stores.
//   ffma (f32, and bf16 that TMA cannot take): 256 threads, 4x4 outputs
//     each from float4 shared-memory reads, 16 HW rows per stage through a
//     4-stage ring of 16-byte cp.async copies (scalar loads where C % 4 != 0
//     or for bf16). f32 stays off the tensor cores: TF32 would break the
//     1e-4 parity with the JAX f32 path.
// What the card showed (PERF.md, Findings): each mainloop stage pays a fixed
// cost in barrier wait and release, so wgmma stages hold 128 rows (8
// wgmmas) where HW allows; at (4,56,56,256) the 64x64 tiles pull about 25 MB
// from L2 (from the shapes), which bounds the bf16 kernel there (128x128
// tiles halve that but lost more in their reduction); a division per output
// entry took its slow path, so the epilogue multiplies by one reciprocal.
//
// gram_bwd is the VJP the style loop needs every iteration (JAX derives it
// by autodiff of the einsum): dF = F (dG + dG^T) / HW for any dG, a product
// of M = HW, N = C, K = C per image, 2 N HW C^2 operations. What bounds it
// on an H100 SXM: at (4,56,56,256) f32 operations, 1.64 GFLOP in 24.5 us;
// bf16 bytes (F, dG, dF: 13.4 MB, 4.0 us; operations 1.7 us, 3.3 us with
// both halves of the dual product); at (4,7,7,2048) the bytes of dG (33.5 MB
// bf16, 67 MB f32), about 10 and 21 us. Design: one launch over (row tile,
// col tile) of dF for every image; where those leave the SMs idle (layer4:
// 4 x 32 tiles of 49 rows, K = 2048) the contraction is split over the
// blocks of a cluster and reduced through distributed shared memory, as
// gram_fwd's HW splits. dG and dG^T are both loaded as tiles of dG, so the
// symmetrised matrix never reaches device memory. Two mainloops:
//   wgmma (bf16, C % 8 == 0, 16-byte-aligned F, dG, dF): gram_fwd's producer
//     warp, TMA ring and consumer warpgroup; A = F K-major, and for each 16
//     channels two wgmmas into one f32 accumulator, B = dG[k, j] (MN-major)
//     and B = dG[j, k] (K-major): twice the tensor work, no rounding of
//     dG + dG^T and no barrier for the sum; 128 x 128 tiles where C % 128
//     == 0 and they fill the SMs, else 64 x 64.
//   ffma (f32, and bf16 that TMA cannot take): 8 x 8 outputs a thread in a
//     64 x 128 (or, where C <= 64 < HW, 128 x 64) tile, a 3-stage 16-byte
//     cp.async ring of F, dG[k, j] and dG[j, k] tiles; the transposed tile
//     is added into the other one stage ahead, under the one barrier a
//     stage; 3 blocks an SM.
// What the card showed (PERF.md, Findings): bf16 at (4,56,56,256) is
// bound by the dual-B tiles' traffic from L2 (a build without the wgmmas
// took 9.8 of 11.3 us with 128 x 64 tiles; 128 x 128 tiles cut it); f32
// there ran at 74-84 us whatever its stages, unrolling or tile, until the
// tile count fit one round of the SMs' block slots.
//
// pooled_gram_fwd for S > MAX_S (16) takes two launches instead:
// pooled_project_kernel writes Y = F P^T in f32 from the same bins, then
// gram_fwd's FFMA route computes Y^T Y / HW (the wrapper casts G once).
//
// pooled_gram_fwd replaces gram_kernel.py::pooled_gram_pallas (pallas_call at
// :100). Bound: bytes. It must read F once, and its work is about one add
// per element plus S(S+1)/2 FMAs per row: 7.7 us for (8,56,56,256) f32 and
// 3.8 us in bf16 at 3.35 TB/s, under 1 us at layer4's (8,7,7,2048). Design:
// P is the adaptive-pooling matrix, whose row o is 1/len on the contiguous
// bin [floor(o C / S), ceil((o + 1) C / S)), so the kernel computes the bins
// from (C, S) and never reads P: the projection is S bin sums per row, each
// times its f32 weight 1/len. One launch: image n's HW rows are split over
// the blocks of one thread-block cluster (balanced, up to 16, chosen so that
// N x splits fills the SMs), and a split's rows are one contiguous span of F
// that the block streams once through a ring of ~20 KB shared-memory stages,
// each filled by one TMA bulk copy onto an mbarrier (scalar loads where C or
// the base is not 16-byte aligned). Per stage, each thread sums one (bin,
// part) of a row from 16-byte groups, the lanes of a warp on the bins of a
// row so that they read distinct bank groups; the edge groups, which a bin
// shares with its neighbour, are read again and weighted 0/1 (a long bin, as
// layer4's 293 channels, is cut into parts added in order). The same barrier
// that frees a stage lets each thread add its (row group, pair) products of
// the S(S+1)/2 distinct entries for the stage before. Each block pushes its
// partial into block 0's shared memory (st.shared::cluster), one cluster
// barrier follows, and block 0 adds the splits in order, scales by one
// reciprocal of HW and writes G and its mirror.
// The first stages' copies go out before the rest of the setup, so their
// latency hides it.
// What the card showed (PERF.md, Findings; tools/pooled_gram_phases.py):
// one TMA copy per row into a padded layout cost more to issue than a
// stage's work, so a stage is one copy; above the stream alone the
// per-stage bin sums, latency-bound on 8 warps, are what remain. More
// threads a block, two rows a thread, larger stages (16-block clusters of
// more than ~113 KB blocks fit only 7 at a time), and bf16 bin sums on
// mma.sync from swizzled TMA tiles all lost.
// ---------------------------------------------------------------------------

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int TILE = 64;       // output tile edge (gram_fwd, gram_bwd)
constexpr int BK = 16;         // contraction rows per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = TILE + 1;  // row pitch that spreads transposed stores over banks

// (bi, bj), bi <= bj, of upper-triangle tile t, numbered t = bj (bj + 1) / 2 + bi
// (ops/kernels/gram.py _triangle_tile mirrors it).
__device__ __forceinline__ void tri_tile(int t, int& bi, int& bj) {
  int j = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  if ((j + 1) * (j + 2) / 2 <= t) ++j;
  if (j * (j + 1) / 2 > t) --j;
  bj = j;
  bi = t - j * (j + 1) / 2;
}

// ---- split reduction over a thread-block cluster ---------------------------
// The blocks of one tile's HW splits form one cluster (1, splits, 1), so the
// split index is the block's rank in it. The tile is cut into one sub-block
// per split; block r owns sub-block r. After its mainloop every block stores
// each sub-block of its f32 partial into slot `split` of the owner's receive
// buffer (distributed shared memory), one cluster barrier makes them visible,
// and each owner adds its slots in split order (deterministic, no atomics, no
// scratch in device memory, one launch) and writes its sub-block and mirror.
constexpr int MAX_SPLITS = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Splits s = 1, 2, 4, 8, 16 cut the tile of 2^lrows x 2^lcols (64 x 64 in
// gram_fwd; 64 or 128 a side in gram_bwd) into sr x sc sub-blocks of br x bc
// = (rows / sr) x (cols / sc): at least 16 x 16, so every row of a sub-block
// and of its mirror is a whole number of 16-byte stores. All are powers of
// two, so owners and offsets are shifts and masks.
struct SubGrid {
  int lsc, lbr, lbc;  // log2 of sc, br, bc
  int br, bc;
  __host__ __device__ explicit SubGrid(int splits, int lrows = 6, int lcols = 6) {
    int ls = 0;  // log2 of splits
    while ((1 << ls) < splits) ++ls;
    const int lsr = ls >= 3 ? 2 : (ls >= 1 ? 1 : 0);
    lsc = ls - lsr;
    lbr = lrows - lsr;
    lbc = lcols - lsc;
    br = 1 << lbr;
    bc = 1 << lbc;
  }
  __host__ __device__ int row0(int split) const { return (split >> lsc) << lbr; }
  __host__ __device__ int col0(int split) const { return (split & ((1 << lsc) - 1)) << lbc; }
};

// Stores N = 2 or 4 partial columns (row, col..col + N) of split `split`,
// v.x.., into the receive buffer [splits][br][bc] of the block that owns them.
template <int N>
__device__ __forceinline__ void push_partial(float* recv, const SubGrid& sg, int split, int row,
                                             int col, float4 v) {
  const int owner = ((row >> sg.lbr) << sg.lsc) + (col >> sg.lbc);
  const float* slot =
      recv + (((split << sg.lbr) + (row & (sg.br - 1))) << sg.lbc) + (col & (sg.bc - 1));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(slot)), "r"(owner));
  if constexpr (N == 4) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
                 "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
  } else {
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(v.x), "f"(v.y)
                 : "memory");
  }
}

// After the cluster barrier: adds the received slots in split order and
// hands each sum of 4 columns to out(row, col), relative to the sub-block.
template <typename Out>
__device__ __forceinline__ void sum_received(const float* recv, const SubGrid& sg, int splits,
                                             Out out) {
  const int lq = sg.lbc - 2;  // log2 of the float4s in a sub-block row
  const int slot = sg.br * sg.bc;
  for (int e = threadIdx.x; e < slot / 4; e += blockDim.x) {
    const float* p = recv + 4 * e;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(p + sp * slot);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out(e >> lq, 4 * (e & ((1 << lq) - 1)), s);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Writes the staged f32 block s (rows x cols, pitch cols + 1) to G at
// (r0, c0), or its transpose (cols x rows), 16 bytes per store along G's
// rows where C allows it.
template <typename T>
__device__ __forceinline__ void store_block(const float* s, int rows, int cols, T* g, int c,
                                            int r0, int c0, bool transpose) {
  constexpr int V = 16 / sizeof(T);
  const int pitch = cols + 1;
  const int out_rows = transpose ? cols : rows;
  const int out_cols = transpose ? rows : cols;
  auto at = [&](int r, int cc) { return transpose ? s[cc * pitch + r] : s[r * pitch + cc]; };
  if (c % V == 0) {
    const int chunks = out_cols / V;
    for (int e = threadIdx.x; e < out_rows * chunks; e += blockDim.x) {
      const int r = e / chunks;
      const int q = e % chunks;
      const int row = r0 + r;
      const int col = c0 + q * V;
      if (row >= c || col >= c) continue;
      alignas(16) T v[V];
#pragma unroll
      for (int m = 0; m < V; ++m) v[m] = from_f32<T>(at(r, q * V + m));
      *reinterpret_cast<uint4*>(g + static_cast<size_t>(row) * c + col) =
          *reinterpret_cast<const uint4*>(v);
    }
  } else {
    for (int e = threadIdx.x; e < out_rows * out_cols; e += blockDim.x) {
      const int r = e / out_cols;
      const int cc = e % out_cols;
      if (r0 + r < c && c0 + cc < c)
        g[static_cast<size_t>(r0 + r) * c + c0 + cc] = from_f32<T>(at(r, cc));
    }
  }
}

// ---- ffma route -------------------------------------------------------------
constexpr int FFMA_STAGES = 4;  // cp.async ring: 3 stages in flight during the FMAs

// One triangle tile (blockIdx.x) of image blockIdx.z over split blockIdx.y
// of HW. ASYNC: f32 with C % 4 == 0 and a 16-byte-aligned F, loaded by
// cp.async; otherwise (bf16, ragged C) scalar loads through the same ring.
// SPLIT: more than one split, reduced over the cluster.
template <typename T, bool ASYNC, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
gram_fwd_kernel(const T* __restrict__ f, T* __restrict__ g, int hw, int c, int splits,
                int rows_per_split) {
  // the ring [FFMA_STAGES][2][BK][TILE] (after the mainloop: the staged
  // output block), then for SPLIT the receive buffer: 48 KB in all
  constexpr int RING = FFMA_STAGES * 2 * BK * TILE;
  static_assert(RING >= TILE * PAD, "the staged tile reuses the ring");
  __shared__ __align__(16) float smem[RING + (SPLIT ? TILE * TILE : 0)];
  const int t = blockIdx.x;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  int bi, bj;
  tri_tile(t, bi, bj);
  const bool diag = bi == bj;
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k_begin = split * rows_per_split;
  const int k_end = split == splits - 1 ? hw : min(hw, k_begin + rows_per_split);
  const int stages = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const T* fn = f + static_cast<size_t>(n) * hw * c;
  auto As = [&](int buf) { return smem + buf * 2 * BK * TILE; };
  auto Bs = [&](int buf) { return diag ? As(buf) : As(buf) + BK * TILE; };  // diagonal: B = A

  auto load = [&](int st) {
    float* a = As(st % FFMA_STAGES);
    float* b = a + BK * TILE;
    const int k0 = k_begin + st * BK;
    if constexpr (ASYNC) {  // one 16-byte chunk per thread and operand
      const int kk = threadIdx.x / 16;
      const int col = 4 * (threadIdx.x % 16);
      const int k = k0 + kk;
      const bool kin = k < k_end;
      const bool ain = kin && i0 + col < c;
      const bool bin = kin && j0 + col < c;
      cp_async16(a + kk * TILE + col, ain ? fn + static_cast<size_t>(k) * c + i0 + col : fn, ain);
      if (!diag)
        cp_async16(b + kk * TILE + col, bin ? fn + static_cast<size_t>(k) * c + j0 + col : fn, bin);
    } else {
      for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
        const int kk = e / TILE;
        const int col = e % TILE;
        const int k = k0 + kk;
        const bool kin = k < k_end;
        const size_t row = static_cast<size_t>(k) * c;
        a[e] = (kin && i0 + col < c) ? to_f32(fn[row + i0 + col]) : 0.f;
        if (!diag) b[e] = (kin && j0 + col < c) ? to_f32(fn[row + j0 + col]) : 0.f;
      }
    }
  };
  // every iteration commits one group (empty past the end), so once at most
  // FFMA_STAGES - 1 groups are pending this stage has landed
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int st = 0; st < FFMA_STAGES - 1; ++st) {
    if (st < stages) load(st);
    commit();
  }
  for (int st = 0; st < stages; ++st) {
    if (st + FFMA_STAGES - 1 < stages) load(st + FFMA_STAGES - 1);
    commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FFMA_STAGES - 1) : "memory");
    __syncthreads();
    const float* a = As(st % FFMA_STAGES);
    const float* b = Bs(st % FFMA_STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av4 = *reinterpret_cast<const float4*>(a + kk * TILE + ty * 4);
      const float4 bv4 = *reinterpret_cast<const float4*>(b + kk * TILE + tx * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float inv = 1.f / static_cast<float>(hw);  // one division, not one per entry
  T* gn = g + static_cast<size_t>(n) * c * c;
  if constexpr (!SPLIT) {
    float* blk = smem;  // the whole tile, pitch PAD
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) blk[(ty * 4 + r) * PAD + tx * 4 + s] = acc[r][s] * inv;
    __syncthreads();
    store_block<T>(blk, TILE, TILE, gn, c, i0, j0, false);
    if (!diag) store_block<T>(blk, TILE, TILE, gn, c, j0, i0, true);
    return;
  }
  float* recv = smem + RING;
  float* blk = smem;  // the reduced sub-block, pitch bc + 1
  const SubGrid sg(splits);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    push_partial<4>(recv, sg, split, ty * 4 + r, tx * 4,
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  cluster_sync();  // every split's partial has reached its owner
  sum_received(recv, sg, splits, [&](int r, int cq, float4 s) {
    float* d = blk + r * (sg.bc + 1) + cq;
    d[0] = s.x * inv;
    d[1] = s.y * inv;
    d[2] = s.z * inv;
    d[3] = s.w * inv;
  });
  __syncthreads();
  const int gr = i0 + sg.row0(split);
  const int gc = j0 + sg.col0(split);
  store_block<T>(blk, sg.br, sg.bc, gn, c, gr, gc, false);
  if (!diag) store_block<T>(blk, sg.br, sg.bc, gn, c, gc, gr, true);
}

// ---- wgmma route ----------------------------------------------------------
// A block computes one 64 x 64 tile with one consumer warpgroup (warps 0-3)
// and a producer warp (warp 4) that issues the TMA loads, so no block
// barrier sits in the mainloop. A stage holds KROWS HW rows of A =
// F[k, i0..] and B = F[k, j0..], 128 bytes a row: 64 rows (HW <= 64) or 128,
// so each barrier wait and release is spread over 4 or 8 wgmmas.
constexpr int WG = 160;
constexpr int RING_BYTES = 96 * 1024;        // two blocks fit on an SM
constexpr int MAX_STAGES = 6;
constexpr int TILE_BYTES = TILE * TILE * 2;  // one 64 x 64 bf16 tile
constexpr int RECV_BYTES = TILE * TILE * 4;  // splits x (64 * 64 / splits) f32

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Suspends the thread until the phase completes (the hint bounds the
// suspension, as CUTLASS's ClusterBarrier::wait does).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity), "r"(0x989680)
        : "memory");
  }
}

// TMA at coordinates (column, row, image) of a 3-D map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Shared-memory matrix descriptor of a bf16 operand tile of 128-byte rows
// under the 128-byte swizzle (CUTLASS make_gmma_desc, LayoutType B128), the
// tile base 1024-byte aligned so the base offset stays 0. 8 rows of 128
// bytes form one swizzle atom, so the stride-byte offset (next 8 rows) is
// 1024 bytes; the leading-byte offset is unused with one atom across. The
// same bits serve both majors:
//   MN-major (64 MN x 16 K): the rows are K; the next 16 K start 2048 bytes on.
//   K-major (64 MN x 16 K of a 64-wide K row): the rows are MN; the next 16 K
//     start 32 bytes on, inside the atom (as CUTLASS's descriptor iterator).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D(64x64, f32) += A(64x16) B(16x64); TA, TB: 1 where the operand is
// MN-major, 0 where it is K-major (gram_fwd: A = F^T and B = F, both 1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of bf16 element (r, col) in a 64x64 tile of 128-byte rows
// under the 128-byte swizzle (16-byte chunk index XOR r % 8), as TMA
// writes and reads it from a 1024-byte-aligned base.
__device__ __forceinline__ uint32_t sw128(int r, int col) {
  const int byte = col * 2;
  return r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// One triangle tile (blockIdx.x) of image blockIdx.z over split blockIdx.y.
// Accumulator fragment of consumer thread tid: element i sits at row
// 16 (tid / 32) + (tid % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (tid % 4) + i % 2. SPLIT: gmap_d and gmap_m store the
// sub-block (box bc x br) and its mirror (box br x bc); otherwise both are
// the 128-byte-swizzled 64 x 64 map of G and the epilogue stages straight
// from the fragments.
template <bool SPLIT, int KROWS>
__global__ void __launch_bounds__(WG)
gram_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap fmap,
                      const __grid_constant__ CUtensorMap gmap_d,
                      const __grid_constant__ CUtensorMap gmap_m, int hw, int splits,
                      int rows_per_split, int stages, int ring_bytes) {
  constexpr int OPERAND_BYTES = KROWS * TILE * 2;
  constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;
  // dynamic shared memory, with no static shared memory before it, starts
  // 1024-byte aligned as the 128-byte swizzle needs: the ring of stages
  // (after the mainloop: the output staging), for SPLIT the receive buffer,
  // then the mbarriers
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw;
  float* recv = reinterpret_cast<float*>(smem_raw + ring_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + ring_bytes + (SPLIT ? RECV_BYTES : 0));
  uint64_t* empty = full + MAX_STAGES;  // full: stage landed; empty: stage read by the wgmmas
  if ((smem_u32(smem_raw) & 1023) != 0) __trap();
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // warp-uniform for the compiler
  const int lane = tid % 32;
  const int t = blockIdx.x;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  int bi, bj;
  tri_tile(t, bi, bj);
  const bool diag = bi == bj;
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int k_begin = split * rows_per_split;
  const int k_end = split == splits - 1 ? hw : min(hw, k_begin + rows_per_split);
  const int nkb = k_end > k_begin ? (k_end - k_begin + KROWS - 1) / KROWS : 0;
  if (nkb > stages && stages < 2) __trap();  // the ring could not turn over

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (warp == 4) {
    // producer: keeps up to `stages` blocks of KROWS HW rows in flight; rows
    // past HW (the last block of a split that ends HW) arrive as zeros
    if (lane == 0) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(&empty[s], (kb / stages - 1) & 1);
        uint8_t* a = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], diag ? OPERAND_BYTES : STAGE_BYTES);
        tma_load(a, &fmap, &full[s], i0, k_begin + kb * KROWS, n);
        if (!diag) tma_load(a + OPERAND_BYTES, &fmap, &full[s], j0, k_begin + kb * KROWS, n);
      }
    }
  } else {
    // consumers: one wgmma group per stage; a stage goes back to the producer
    // once the group after it has been issued and it has retired
    fence_acc(acc);
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % stages;
      mbar_wait(&full[s], (kb / stages) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE_BYTES);
      const uint32_t b = diag ? a : a + OPERAND_BYTES;  // a diagonal tile is its own B
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < KROWS / 16; ++k16)
        wgmma_m64n64k16<1, 1>(acc, desc_sw128(a + k16 * 2048), desc_sw128(b + k16 * 2048));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<1>();
      fence_acc(acc);
      if (kb >= 1 && lane == 0) mbar_arrive(&empty[(kb - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
  }
  __syncthreads();  // every wgmma has retired and every stage has landed: the ring is free

  const float inv = 1.f / static_cast<float>(hw);  // one division, not one per entry
  if constexpr (!SPLIT) {  // G[i0.., j0..] and its transpose, swizzled
    uint8_t* direct = ring;
    uint8_t* mirror = ring + TILE_BYTES;
    if (warp < 4) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane & 3);
        const __nv_bfloat16 lo = __float2bfloat16(acc[i] * inv);
        const __nv_bfloat16 hi = __float2bfloat16(acc[i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(direct + sw128(row, col)) = __halves2bfloat162(lo, hi);
        if (!diag) {
          *reinterpret_cast<__nv_bfloat16*>(mirror + sw128(col, row)) = lo;
          *reinterpret_cast<__nv_bfloat16*>(mirror + sw128(col + 1, row)) = hi;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {  // rows and columns past a ragged C are clipped
      tma_store(&gmap_d, direct, j0, i0, n);
      if (!diag) tma_store(&gmap_d, mirror, i0, j0, n);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    return;
  }
  const SubGrid sg(splits);
  if (warp < 4) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      push_partial<2>(recv, sg, split, row, col, make_float4(acc[i], acc[i + 1], 0.f, 0.f));
    }
  }
  cluster_sync();  // every split's partial has reached its owner
  __nv_bfloat16* direct = reinterpret_cast<__nv_bfloat16*>(ring);  // [br][bc]
  __nv_bfloat16* mirror = direct + sg.br * sg.bc;                    // [bc][br]
  sum_received(recv, sg, splits, [&](int r, int cq, float4 s) {
    const float v[4] = {s.x * inv, s.y * inv, s.z * inv, s.w * inv};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const __nv_bfloat16 h = __float2bfloat16(v[m]);
      direct[r * sg.bc + cq + m] = h;
      mirror[(cq + m) * sg.br + r] = h;
    }
  });
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {  // rows and columns past a ragged C are clipped
    const int gr = i0 + sg.row0(split);
    const int gc = j0 + sg.col0(split);
    tma_store(&gmap_d, direct, gc, gr, n);
    if (!diag) tma_store(&gmap_m, mirror, gr, gc, n);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- gram_bwd -----------------------------------------------------------------
// dF[n] = F[n] (dG[n] + dG[n]^T) / HW, a product of M = HW, N = C, K = C per
// image. Block (blockIdx.x, blockIdx.y, blockIdx.z) computes output tile
// blockIdx.x = row tile * col_tiles + col tile of image blockIdx.z over
// split blockIdx.y of the contraction: channels [split k_per_split, ...),
// the last split taking the rest of C. More than one split reduces over the
// cluster, as gram_fwd's HW splits do, except that the partials land in the
// owners' rings: a first cluster barrier shows that every block has left its
// mainloop, the pushes follow, then a second barrier.

// Channels [begin, end) of split `split`: k_per_split each, the last the rest.
__device__ __forceinline__ void k_range(int c, int split, int splits, int k_per_split, int& begin,
                                        int& end) {
  begin = min(c, split * k_per_split);
  end = split == splits - 1 ? c : min(c, begin + k_per_split);
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// Writes 4 consecutive entries of a dF row from column col, clipped at C,
// times inv; one 16- (f32) or 8-byte (bf16) store where C % 4 == 0.
template <typename T>
__device__ __forceinline__ void store4(T* row, int col, int c, float4 v, float inv) {
  const float e[4] = {v.x * inv, v.y * inv, v.z * inv, v.w * inv};
  if (c % 4 == 0) {
    if (col >= c) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + col) = make_float4(e[0], e[1], e[2], e[3]);
    } else {
      alignas(8) const __nv_bfloat162 p[2] = {__floats2bfloat162_rn(e[0], e[1]),
                                              __floats2bfloat162_rn(e[2], e[3])};
      *reinterpret_cast<uint2*>(row + col) = *reinterpret_cast<const uint2*>(p);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < c) row[col + q] = from_f32<T>(e[q]);
}

// ffma route: 128 threads, 8 x 8 outputs each, in a BM x BN tile of 64 x 128
// or, where C <= 64 < HW, 128 x 64. A stage holds BWD_BK channels: A =
// F[r0.., k0..] as [row][k], B = dG[k0.., j0..] as [k][col] and B' =
// dG[j0.., k0..] as [col][k], each by 16-byte cp.async (or scalar loads).
// Stage st + 1's B' is added into its B while stage st's FMAs run, so the
// one block barrier a stage also publishes that sum. Three stages and at
// most 170 registers a thread let 3 blocks share an SM: at (4,56,56,256)
// the 392 tiles of 64 x 128 then run in one round (PERF.md, Findings).
constexpr int BWD_BK = 16;
constexpr int BWD_STAGES = 3;  // one stage in flight under the FMAs; 3 blocks an SM
constexpr int BWD_PITCH = BWD_BK + 4;    // rows of A and B': 16-byte aligned, 4 banks apart

template <int BM, int BN>
struct BwdTile {
  static constexpr int TX = BN / 8;  // threads across the columns
  static constexpr int TY = BM / 8;  // and down the rows
  static constexpr int THREADS = TX * TY;
  static constexpr int A = BM * BWD_PITCH;
  static constexpr int B = BWD_BK * BN;
  static constexpr int B2 = BN * BWD_PITCH;
  static constexpr int STAGE = A + B + B2;  // floats
  static constexpr size_t SMEM = BWD_STAGES * STAGE * sizeof(float);
  static_assert(BM * BN * sizeof(float) <= SMEM, "the split partials land in the ring");
  static_assert(BM * BWD_BK % (4 * THREADS) == 0 && BN * BWD_BK % (4 * THREADS) == 0,
                "every thread loads the same number of chunks");
};

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Thread (tx, ty) owns rows ty + TY r (r < 8) and columns BN/2 h + 4 tx + q
// (h < 2, q < 4) of the tile, so a warp's float4 reads of A and B hit
// distinct banks. ASYNC: f32 with C % 4 == 0 on 16-byte-aligned F and dG.
template <typename T, bool ASYNC, int BM, int BN>
__global__ void __launch_bounds__(BwdTile<BM, BN>::THREADS, 3)
gram_bwd_kernel(const T* __restrict__ f, const T* __restrict__ dg, T* __restrict__ df, int hw,
                int c, int col_tiles, int splits, int k_per_split) {
  using Tl = BwdTile<BM, BN>;
  extern __shared__ __align__(16) float bwd_smem[];
  const int tid = threadIdx.x;
  const int tx = tid % Tl::TX;
  const int ty = tid / Tl::TX;
  const int r0 = (blockIdx.x / col_tiles) * BM;
  const int j0 = (blockIdx.x % col_tiles) * BN;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  int k_begin, k_end;
  k_range(c, split, splits, k_per_split, k_begin, k_end);
  const int stages = (k_end - k_begin + BWD_BK - 1) / BWD_BK;
  const T* fn = f + static_cast<size_t>(n) * hw * c;
  const T* dgn = dg + static_cast<size_t>(n) * c * c;
  auto stage_a = [&](int st) { return bwd_smem + (st % BWD_STAGES) * Tl::STAGE; };

  auto load = [&](int st) {
    float* a = stage_a(st);
    float* b = a + Tl::A;
    float* b2 = b + Tl::B;
    const int k0 = k_begin + st * BWD_BK;
    // fixed trip counts, so a stage's copies go out back to back; k_end and C
    // are multiples of 4, so a chunk is all in or all out
    if constexpr (ASYNC) {
      constexpr int Q = BWD_BK / 4;  // 16-byte chunks of a row of A or B'
#pragma unroll
      for (int i = 0; i < BM * Q / Tl::THREADS; ++i) {
        const int e = tid + i * Tl::THREADS;
        const int row = e / Q, k = k0 + 4 * (e % Q), r = r0 + row;
        const bool in = r < hw && k < k_end;
        cp_async16(a + row * BWD_PITCH + 4 * (e % Q), in ? fn + static_cast<size_t>(r) * c + k : fn,
                   in);
      }
#pragma unroll
      for (int i = 0; i < BN * Q / Tl::THREADS; ++i) {
        const int e = tid + i * Tl::THREADS;
        const int kk = e / (BN / 4), j = j0 + 4 * (e % (BN / 4)), k = k0 + kk;
        const bool in = k < k_end && j < c;
        cp_async16(b + kk * BN + 4 * (e % (BN / 4)), in ? dgn + static_cast<size_t>(k) * c + j : dgn,
                   in);
        const int col = e / Q, kt = k0 + 4 * (e % Q), jt = j0 + col;
        const bool in_t = jt < c && kt < k_end;
        cp_async16(b2 + col * BWD_PITCH + 4 * (e % Q),
                   in_t ? dgn + static_cast<size_t>(jt) * c + kt : dgn, in_t);
      }
    } else {  // scalar loads: unrolled like the copies above, they spill
      for (int e = tid; e < BM * BWD_BK; e += Tl::THREADS) {
        const int row = e / BWD_BK, kk = e % BWD_BK, r = r0 + row, k = k0 + kk;
        a[row * BWD_PITCH + kk] = r < hw && k < k_end ? to_f32(fn[static_cast<size_t>(r) * c + k]) : 0.f;
      }
      for (int e = tid; e < BWD_BK * BN; e += Tl::THREADS) {
        const int kk = e / BN, col = e % BN, k = k0 + kk, j = j0 + col;
        b[e] = k < k_end && j < c ? to_f32(dgn[static_cast<size_t>(k) * c + j]) : 0.f;
      }
      for (int e = tid; e < BN * BWD_BK; e += Tl::THREADS) {
        const int col = e / BWD_BK, kk = e % BWD_BK, j = j0 + col, k = k0 + kk;
        b2[col * BWD_PITCH + kk] = j < c && k < k_end ? to_f32(dgn[static_cast<size_t>(j) * c + k]) : 0.f;
      }
    }
  };
  // B[k][col] += B'[col][k] for stage st, four k a thread from one float4
  auto add_transpose = [&](int st) {
    float* b = stage_a(st) + Tl::A;
    const float* b2 = b + Tl::B;
#pragma unroll
    for (int i = 0; i < BN * BWD_BK / 4 / Tl::THREADS; ++i) {
      const int e = tid + i * Tl::THREADS;
      const int col = e % BN, k4 = 4 * (e / BN);
      const float4 t = *reinterpret_cast<const float4*>(b2 + col * BWD_PITCH + k4);
      b[k4 * BN + col] += t.x;
      b[(k4 + 1) * BN + col] += t.y;
      b[(k4 + 2) * BN + col] += t.z;
      b[(k4 + 3) * BN + col] += t.w;
    }
  };
  // every load commits one group (empty past the end), so group i is stage i
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int st = 0; st < BWD_STAGES - 1; ++st) {
    if (st < stages) load(st);
    commit();
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(BWD_STAGES - 2) : "memory");  // stage 0
  __syncthreads();
  if (stages > 0) add_transpose(0);
  for (int st = 0; st < stages; ++st) {
    // Stage st + 1 has landed; after the barrier every thread's copies of it
    // and its sums of stage st are visible, and stage st - 1's slot is free.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(BWD_STAGES - 3) : "memory");
    __syncthreads();
    if (st + BWD_STAGES - 1 < stages) load(st + BWD_STAGES - 1);
    commit();
    if (st + 1 < stages) add_transpose(st + 1);
    const float* a = stage_a(st);
    const float* b = a + Tl::A;
#pragma unroll
    for (int k4 = 0; k4 < BWD_BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = *reinterpret_cast<const float4*>(a + (ty + Tl::TY * r) * BWD_PITCH + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(b + (k4 + kk) * BN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(b + (k4 + kk) * BN + BN / 2 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float ar = lane_of(av[r], kk);
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(ar, bv[s], acc[r][s]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float inv = 1.f / static_cast<float>(hw);  // one division, not one per entry
  T* dfn = df + static_cast<size_t>(n) * hw * c;
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = r0 + ty + Tl::TY * r;
      if (row >= hw) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4<T>(dfn + static_cast<size_t>(row) * c, j0 + BN / 2 * h + 4 * tx, c,
                  make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]),
                  inv);
    }
    return;
  }
  cluster_sync();  // every block of the cluster has left its mainloop: the rings are free
  float* recv = bwd_smem;
  const SubGrid sg(splits, ilog2(BM), ilog2(BN));
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      push_partial<4>(recv, sg, split, ty + Tl::TY * r, BN / 2 * h + 4 * tx,
                      make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                  acc[r][4 * h + 3]));
  cluster_sync();  // every split's partial has reached its owner
  const int gr = r0 + sg.row0(split);
  const int gc = j0 + sg.col0(split);
  sum_received(recv, sg, splits, [&](int r, int cq, float4 s) {
    if (gr + r < hw) store4<T>(dfn + static_cast<size_t>(gr + r) * c, gc + cq, c, s, inv);
  });
}

// wgmma route (bf16, C % 8 == 0, 16-byte-aligned F, dG and dF): one
// consumer warpgroup (warps 0-3) and a producer warp (warp 4), as
// gram_fwd_wgmma_kernel. A stage holds 64 channels k0..: A = F[r0.., k0..]
// (BM = 64 or 128 rows of 128 bytes, K-major), B = dG[k0.., j0..] (MN-major)
// and B' = dG[j0.., k0..] (K-major) for each 64 columns, TMA loads from two
// 3-D maps, all 128-byte swizzled with zeros past HW and C. The tile is
// 64 x 64 or 128 x 128 (C % 128 == 0, so no column tile lies wholly past
// C). Per 16 channels and 64 x 64 quarter, wgmma adds A B and A B' into
// one f32 accumulator: the symmetrised
// dG is never formed and nothing is rounded before the product. The
// epilogue scales by one reciprocal of HW and leaves by TMA stores that clip
// the HW and C tails; with splits, by 8-byte row stores after the cluster
// reduction.
template <int BM, int BN>
__global__ void __launch_bounds__(WG, 2)
gram_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap fmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap dfmap, __nv_bfloat16* __restrict__ df,
                      int hw, int c, int col_tiles, int splits, int k_per_split, int stages,
                      int ring_bytes) {
  constexpr int MH = BM / 64;  // 64-row halves of the tile
  constexpr int NH = BN / 64;  // and 64-column ones
  constexpr int A_BYTES = BM * 128;
  constexpr int STAGE_BYTES = A_BYTES + 2 * NH * TILE_BYTES;  // A, then NH B, then NH B'
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + ring_bytes);
  uint64_t* empty = full + MAX_STAGES;
  if ((smem_u32(smem_raw) & 1023) != 0) __trap();
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int r0 = (blockIdx.x / col_tiles) * BM;
  const int j0 = (blockIdx.x % col_tiles) * BN;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  int k_begin, k_end;
  k_range(c, split, splits, k_per_split, k_begin, k_end);
  const int nkb = (k_end - k_begin + TILE - 1) / TILE;
  if (nkb > stages && stages < 2) __trap();  // the ring could not turn over

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[MH][NH][32];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int q = 0; q < NH; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][q][i] = 0.f;
  if (warp == 4) {
    if (lane == 0) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % stages;
        const int k0 = k_begin + kb * TILE;
        if (kb >= stages) mbar_wait(&empty[s], (kb / stages - 1) & 1);
        uint8_t* a = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(a, &fmap, &full[s], k0, r0, n);
        for (int q = 0; q < NH; ++q) {
          tma_load(a + A_BYTES + q * TILE_BYTES, &gmap, &full[s], j0 + TILE * q, k0, n);
          tma_load(a + A_BYTES + (NH + q) * TILE_BYTES, &gmap, &full[s], k0, j0 + TILE * q, n);
        }
      }
    }
  } else {
    auto fence_all = [&] {
#pragma unroll
      for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int q = 0; q < NH; ++q) fence_acc(acc[h][q]);
    };
    fence_all();
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % stages;
      mbar_wait(&full[s], (kb / stages) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE_BYTES);
      const uint32_t b = a + A_BYTES;
      const uint32_t bt = b + NH * TILE_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < TILE / 16; ++k16) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          const uint64_t da = desc_sw128(a + h * TILE_BYTES + k16 * 32);
#pragma unroll
          for (int q = 0; q < NH; ++q) {
            const uint32_t bq = b + q * TILE_BYTES;
            const uint32_t btq = bt + q * TILE_BYTES;
            wgmma_m64n64k16<0, 1>(acc[h][q], da, desc_sw128(bq + k16 * 2048));  // F dG
            wgmma_m64n64k16<0, 0>(acc[h][q], da, desc_sw128(btq + k16 * 32));   // F dG^T
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<1>();
      fence_all();
      if (kb >= 1 && lane == 0) mbar_arrive(&empty[(kb - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_all();
  }
  __syncthreads();  // every wgmma has retired and every stage has landed: the ring is free

  const float inv = 1.f / static_cast<float>(hw);  // one division, not one per entry
  if (splits == 1) {  // each 64 x 64 quarter of the tile, swizzled, then one TMA store
    if (warp < 4) {
#pragma unroll
      for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int q = 0; q < NH; ++q)
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
            const int col = 8 * (i >> 2) + 2 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(ring + (h * NH + q) * TILE_BYTES + sw128(row, col)) =
                __floats2bfloat162_rn(acc[h][q][i] * inv, acc[h][q][i + 1] * inv);
          }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {  // rows past HW and columns past C are clipped
      for (int h = 0; h < MH; ++h)
        for (int q = 0; q < NH; ++q)
          if (r0 + 64 * h < hw && j0 + 64 * q < c)
            tma_store(&dfmap, ring + (h * NH + q) * TILE_BYTES, j0 + 64 * q, r0 + 64 * h, n);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    return;
  }
  cluster_sync();  // every block of the cluster has left its mainloop: the rings are free
  float* recv = reinterpret_cast<float*>(ring);
  const SubGrid sg(splits, ilog2(BM), ilog2(BN));
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int q = 0; q < NH; ++q)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = 64 * h + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
          const int col = 64 * q + 8 * (i >> 2) + 2 * (lane & 3);
          push_partial<2>(recv, sg, split, row, col,
                          make_float4(acc[h][q][i], acc[h][q][i + 1], 0.f, 0.f));
        }
  }
  cluster_sync();  // every split's partial has reached its owner
  const int gr = r0 + sg.row0(split);
  const int gc = j0 + sg.col0(split);
  __nv_bfloat16* dfn = df + static_cast<size_t>(n) * hw * c;
  sum_received(recv, sg, splits, [&](int r, int cq, float4 s) {
    if (gr + r < hw) store4(dfn + static_cast<size_t>(gr + r) * c, gc + cq, c, s, inv);
  });
}

// ---- pooled_gram_fwd --------------------------------------------------------
constexpr int PG_THREADS = 256;
constexpr int MAX_S = 16;
constexpr int MAX_PAIRS = MAX_S * (MAX_S + 1) / 2;  // distinct entries of a 16 x 16 G
constexpr int PG_MAX_STAGE_ROWS = 64;
constexpr int PG_SUMS = PG_MAX_STAGE_ROWS * MAX_S;  // >= rows x S x parts (pooled_gram_launch)
constexpr int PG_STAGE_BYTES = 20 * 1024;           // rows per stage: as many as fit
constexpr int PG_MAX_SLOTS = 4;                     // with the static arrays, 2 blocks an SM
constexpr int PG_MAX_ROW_BYTES = 96 * 1024;         // two one-row stages fit

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Bytes from global memory into shared memory by TMA, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The channels of one 16-byte group of a staged row, as f32 (bf16 widens
// exactly by a shift).
template <typename T>
struct Group;
template <>
struct Group<float> {
  static constexpr int V = 4;
  __device__ static void unpack(uint4 u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Group<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(uint4 u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Adds a group's channels into four running sums, channel j into a[j % 4].
template <typename T>
__device__ __forceinline__ void add_group(float (&a)[4], uint4 u) {
  float x[Group<T>::V];
  Group<T>::unpack(u, x);
#pragma unroll
  for (int j = 0; j < Group<T>::V; ++j) a[j & 3] += x[j];
}

// The same for an edge group: channel j weighted by m[j], 1 inside the bin
// and 0 outside it.
template <typename T>
__device__ __forceinline__ void add_group(float (&a)[4], uint4 u, const float (&m)[Group<T>::V]) {
  float x[Group<T>::V];
  Group<T>::unpack(u, x);
#pragma unroll
  for (int j = 0; j < Group<T>::V; ++j) a[j & 3] = fmaf(x[j], m[j], a[j & 3]);
}

// Split i = blockIdx.y (the block's rank in its cluster) of image
// blockIdx.z: HW / splits rows from i (HW / splits) + min(i, HW % splits),
// one more for the first HW % splits splits. ASYNC: C * sizeof(T) a multiple of
// 16 on a 16-byte-aligned F; thread 0 stages each stage's rows, one span of
// F, with one TMA bulk copy onto the slot's mbarrier. Otherwise every thread
// stages by scalar loads into the same layout, zeros past C. The dynamic
// ring holds `slots` stages of stage_rows rows, `pitch` bytes a row.
// Thread t sums part t % (S parts) % parts of bin t % (S parts) / parts
// over rows t / (S parts), + row_groups, ... of each stage (the lanes of a
// warp on the bins of a row read distinct bank groups), and adds the
// products of pair t % pairs over rows t / pairs, + groups, ... of the stage
// before.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(PG_THREADS)
pooled_gram_kernel(const T* __restrict__ f, T* __restrict__ g, int hw, int c, int s, int splits,
                   int stage_rows, int parts, int row_groups, int pitch, int slots) {
  extern __shared__ __align__(16) uint8_t pg_ring[];
  __shared__ float part_s[2][PG_SUMS];             // [stage % 2][row][bin][part]
  __shared__ float red_s[PG_THREADS];              // [row group][pair] at the end
  __shared__ float recv[MAX_SPLITS * MAX_PAIRS];   // block 0: [split][pair]
  __shared__ uint64_t full[PG_MAX_SLOTS];          // ASYNC: a slot's rows have landed
  __shared__ int bin_lo[MAX_S], bin_hi[MAX_S];
  __shared__ float bin_w[MAX_S];
  __shared__ uint16_t pair_s[MAX_PAIRS];
  using G = Group<T>;
  constexpr int V = G::V;

  // Every block of the cluster must have started before any writes into
  // block 0's shared memory: arrive now, wait just before the push.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  const int base_rows = hw / splits;
  const int extra = hw - base_rows * splits;
  const int k_begin = split * base_rows + min(split, extra);
  const int k_end = k_begin + base_rows + (split < extra ? 1 : 0);
  const int stages = (k_end - k_begin + stage_rows - 1) / stage_rows;
  const size_t row_bytes = static_cast<size_t>(c) * sizeof(T);
  const uint8_t* fn = reinterpret_cast<const uint8_t*>(f) + static_cast<size_t>(n) * hw * row_bytes;
  const uint32_t ring = smem_u32(pg_ring);
  auto slot = [&](int st) { return (st % slots) * stage_rows * pitch; };  // byte offset
  auto stage_len = [&](int st) { return min(stage_rows, k_end - k_begin - st * stage_rows); };
  auto load = [&](int st) {  // the stage's rows are one contiguous span of F
    const int rows = stage_len(st);
    const uint8_t* src = fn + static_cast<size_t>(k_begin + st * stage_rows) * row_bytes;
    if constexpr (ASYNC) {  // one bulk copy: the layout is F's own (pitch = row bytes)
      if (tid != 0) return;
      uint64_t* bar = &full[st % slots];
      // the slot's last reads (generic proxy) come before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, static_cast<uint32_t>(rows * row_bytes));
      bulk_load(ring + slot(st), src, static_cast<uint32_t>(rows * row_bytes), bar);
    } else {
      uint8_t* dst = pg_ring + slot(st);
      const T* sp = reinterpret_cast<const T*>(src);
      const int width = pitch / static_cast<int>(sizeof(T));
      for (int i = tid; i < rows * width; i += PG_THREADS) {
        const int r = i / width;
        const int col = i - r * width;
        reinterpret_cast<T*>(dst + r * pitch)[col] = col < c ? sp[r * c + col] : from_f32<T>(0.f);
      }
    }
  };

  // The first stages' copies go out before the rest of the setup, which
  // their latency then hides.
  const int ahead = max(1, slots - 1);
  if (ASYNC && tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int st = 0; st < ahead && st < stages; ++st) load(st);

  const int pairs = s * (s + 1) / 2;
  // Block tables, so that each thread's setup needs few divisions:
  // adaptive-pooling bin o = [floor(o C / S), ceil((o + 1) C / S)) with
  // weight 1 / len, and pair e = (pa, pb), pa <= pb, numbered row by row of
  // the upper triangle.
  if (tid < s) {
    bin_lo[tid] = tid * c / s;
    bin_hi[tid] = ((tid + 1) * c + s - 1) / s;
    bin_w[tid] = __frcp_rn(static_cast<float>(bin_hi[tid] - bin_lo[tid]));
  }
  if (tid < pairs) {
    int a = 0, b = tid;
    while (b >= s - a) {
      b -= s - a;
      ++a;
    }
    pair_s[tid] = static_cast<uint16_t>(a << 8 | (a + b));
  }
  __syncthreads();  // the tables, the mbarriers and (scalar path) the first stages

  // bin sums: this thread's (bin, part) and first row; its 16-byte groups
  // [ga, gb): an edge group at ga where the bin starts inside it, whole
  // groups [body, tail), an edge group at tail where the bin ends inside it
  const int bins_parts = s * parts;
  const int rg = tid / bins_parts;
  const int bp = tid - rg * bins_parts;
  const bool summing = rg < row_groups;
  const int o = bp / parts;
  const int lo = bin_lo[o];
  const int hi = bin_hi[o];
  const int g0 = lo / V;
  const int per = ((hi + V - 1) / V - g0 + parts - 1) / parts;
  const int ga = g0 + (bp - o * parts) * per;
  const int gb = min((hi + V - 1) / V, ga + per);
  const bool head = ga < gb && (ga * V < lo || ga * V + V > hi);
  const int body = head ? ga + 1 : ga;
  const int tail = gb - 1 >= body && gb * V > hi ? gb - 1 : gb;
  float mh[V], mt[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mh[j] = ga * V + j >= lo && ga * V + j < hi ? 1.f : 0.f;
    mt[j] = tail * V + j >= lo && tail * V + j < hi ? 1.f : 0.f;
  }
  const float scale = parts == 1 ? bin_w[o] : 1.f;  // a whole bin's sum leaves as its mean

  // products: this thread's pair (pa, pb) and its row group q
  const int groups = PG_THREADS / pairs;
  const int q = tid / pairs;
  const int e = tid - q * pairs;
  const int pa = pair_s[e] >> 8;
  const int pb = pair_s[e] & 0xff;
  const float wa = bin_w[pa];
  const float wb = bin_w[pb];

  auto sum_bins = [&](int st) {  // stage st's rows into part_s[st % 2]
    const int rows = stage_len(st);
    const uint32_t base = ring + slot(st);
    float* out = part_s[st & 1] + bp;
#pragma unroll 1
    for (int r = rg; r < rows; r += row_groups) {
      const uint32_t row = base + r * pitch;
      // the edge groups' loads go out with the first whole groups', and the
      // whole groups eight at a time: a row costs one or two round trips
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 uh = head ? lds128(row + 16 * ga) : zero;
      const uint4 ut = tail < gb ? lds128(row + 16 * tail) : zero;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int gi = body; gi < tail; gi += 8) {
        uint4 u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] = gi + k < tail ? lds128(row + 16 * (gi + k)) : zero;
#pragma unroll
        for (int k = 0; k < 8; ++k) add_group<T>(a, u[k]);
      }
      add_group<T>(a, uh, mh);
      add_group<T>(a, ut, mt);
      out[r * bins_parts] = ((a[0] + a[1]) + (a[2] + a[3])) * scale;
    }
  };
  float acc = 0.f;
  auto add_products = [&](int st) {  // stage st's rows, from part_s[st % 2]
    const int rows = stage_len(st);
    const float* sums = part_s[st & 1];
#pragma unroll 4
    for (int r = q; r < rows; r += groups) {
      const float* ra = sums + (r * s + pa) * parts;
      const float* rb = sums + (r * s + pb) * parts;
      float ma = ra[0], mb = rb[0];
      if (parts > 1) {  // the parts in order, then the weight
        for (int p = 1; p < parts; ++p) {
          ma += ra[p];
          mb += rb[p];
        }
        ma *= wa;
        mb *= wb;
      }
      acc = fmaf(ma, mb, acc);
    }
  };

  // Stage st + ahead goes into the slot that stage st - 1 has left, once the
  // barrier shows every thread has summed it. One barrier a stage: the
  // products of stage st - 1 overlap the sums of stage st.
  for (int st = 0; st < stages; ++st) {
    if (ASYNC) mbar_wait(&full[st % slots], (st / slots) & 1);
    __syncthreads();
    if (st + ahead < stages) load(st + ahead);
    if (summing) sum_bins(st);
    if (st > 0 && q < groups) add_products(st - 1);
  }
  __syncthreads();
  if (stages > 0 && q < groups) add_products(stages - 1);

  if (q < groups) red_s[q * pairs + e] = acc;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < pairs) {  // this block's partial, row groups in order, to slot `split` of block 0
    float part = red_s[tid];
    for (int j = 1; j < groups; ++j) part += red_s[j * pairs + tid];
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_u32(recv + split * pairs + tid)), "r"(0));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(part) : "memory");
  }
  cluster_sync();  // every split's partial has reached block 0
  if (split != 0 || tid >= pairs) return;
  float sum = recv[tid];
  for (int sp = 1; sp < splits; ++sp) sum += recv[sp * pairs + tid];
  const T v = from_f32<T>(sum * (1.f / static_cast<float>(hw)));
  T* gn = g + static_cast<size_t>(n) * s * s;
  gn[pa * s + pb] = v;
  gn[pb * s + pa] = v;
}

// pooled_gram_fwd past MAX_S, first launch: Y[row, o] = w_o x (sum of row's
// channels in bin o), f32, one thread per (row, bin); the bins and weights
// are pooled_gram_kernel's. A byte-bound pass over F that gram_fwd's FFMA
// route on Y (N, HW, S) follows.
constexpr int PP_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PP_THREADS)
pooled_project_kernel(const T* __restrict__ f, float* __restrict__ y, size_t rows, int c, int s) {
  const size_t i = static_cast<size_t>(blockIdx.x) * PP_THREADS + threadIdx.x;
  if (i >= rows * s) return;
  const size_t row = i / s;
  const int o = static_cast<int>(i - row * s);
  const int lo = o * c / s;
  const int hi = ((o + 1) * c + s - 1) / s;
  const T* fr = f + row * c;
  float sum = 0.f;
  for (int k = lo; k < hi; ++k) sum += to_f32(fr[k]);
  y[i] = sum * __frcp_rn(static_cast<float>(hi - lo));
}

// ---- pooled_gram_bwd --------------------------------------------------------
// The VJP of pooled_gram_fwd, for family-2 training. It has no Pallas
// counterpart: the JAX package differentiates the XLA composition
// (heuristique_style_transfer_code_tpu/ops/gram.py:56-77). Per image, with
// Y = F P^T (HW, S) and M = (dG + dG^T) / HW (S x S), dY = Y M and dF = dY P:
//   dF[r, c] = sum over the bins o that hold channel c of w_o (Y[r] M)[o].
// Bound: bytes. F is read once and dF written once (dG is S^2 an image); the
// work is about 2 C + 2 S^2 operations a row. At the training step's b32
// stage outputs on an H100 SXM (3.35 TB/s): (32,56,56,256) f32 205 MB, 61 us;
// (32,28,28,512) and (32,14,14,1024) 103 and 51 MB; bf16 half of each.
// Design: a block takes a tile of one image's rows, as many as fit in
// PGB_TILE_BYTES (32 rows of C = 256 f32), and stages it in shared memory
// with coalesced 16-byte cp.async copies (scalar loads where a row is not a
// whole number of 16 bytes or F is misaligned), each row padded by 16 bytes
// so that the rows of a warp's reads fall in different banks. It builds M in
// f32 from dG, and the bins (lo, hi, w) as pooled_gram_kernel computes them
// (floor(o C / S), ceil((o + 1) C / S), 1 / len by __frcp_rn). Then, each
// phase over the whole tile, one barrier apart: the (row, bin, part) sums of
// the staged channels (a long bin cut into parts, so that every thread has
// one; an edge channel of overlapping bins is read for each bin that holds
// it); Y = their sums in part order times w; z_o = w_o (Y M)[o]; and dF, 16
// bytes a store, each channel the sum of z_o over the bins that hold it in
// increasing o (the first is floor(c S / C), and lo and hi rise with o). F
// is read once and dF written once; no atomics, every sum in a fixed order,
// so two calls give the same bits. S up to PGB_MAX_S (64); a row of F up to
// PG_MAX_ROW_BYTES (96 KB), as pooled_gram_kernel stages.
// What the card showed (PERF.md, Findings): a first version with a warp a
// row, summing each bin from device memory with a butterfly reduction,
// reached 37% (f32) and 20% (bf16) of the bound at (32,56,56,256).
constexpr int PGB_THREADS = 256;
constexpr int PGB_MAX_S = 64;
constexpr int PGB_TILE_BYTES = 32 * 1024;
constexpr int PGB_MAX_ROWS = 64;

// The tile's rows and the parts a bin is cut into (ops/kernels/gram.py
// _pooled_gram_bwd_plan mirrors it), and the block's shared memory: the tile,
// M, w, lo, hi, the part sums, Y and z.
struct PgbPlan {
  int rows, parts, pitch;  // pitch: bytes a staged row
  size_t smem;
};

PgbPlan pgb_plan(int hw, int c, int s, int es) {
  PgbPlan p;
  const int row_bytes = c * es;
  p.rows = max(1, min(min(PGB_MAX_ROWS, PGB_TILE_BYTES / row_bytes), hw));
  p.parts = max(1, PGB_THREADS / (p.rows * s));
  p.pitch = (row_bytes + 16 + 15) / 16 * 16;
  const size_t pairs = static_cast<size_t>(p.rows) * s;
  p.smem = static_cast<size_t>(p.rows) * p.pitch +
           4 * (static_cast<size_t>(s) * s + 3 * s + pairs * p.parts + 2 * pairs);
  return p;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(PGB_THREADS)
pooled_gram_bwd_kernel(const T* __restrict__ f, const T* __restrict__ dg, T* __restrict__ df,
                       int hw, int c, int s, int rows_per_tile, int parts, int pitch) {
  extern __shared__ __align__(16) uint8_t pgb_smem[];
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, hw - r0);
  const size_t base = (static_cast<size_t>(n) * hw + r0) * c;  // the tile's first element
  uint8_t* tile = pgb_smem;
  float* m = reinterpret_cast<float*>(pgb_smem + static_cast<size_t>(rows_per_tile) * pitch);
  float* w = m + s * s;
  int* lo = reinterpret_cast<int*>(w + s);
  int* hi = lo + s;
  float* psum = reinterpret_cast<float*>(hi + s);  // [row][bin][part]
  float* ys = psum + rows_per_tile * s * parts;    // [row][bin]
  float* zs = ys + rows_per_tile * s;              // [row][bin]

  // stage the tile's rows (the copies go out first, so the setup hides them)
  if constexpr (VEC) {
    const int chunks = c * static_cast<int>(sizeof(T)) / 16;  // 16-byte groups a row
    const uint8_t* src = reinterpret_cast<const uint8_t*>(f + base);
    for (int i = tid; i < rows * chunks; i += PGB_THREADS) {
      const int r = i / chunks;
      const int k = i - r * chunks;
      cp_async16(tile + static_cast<size_t>(r) * pitch + 16 * k,
                 src + static_cast<size_t>(r) * c * sizeof(T) + 16 * k, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = tid; i < rows * c; i += PGB_THREADS) {
      const int r = i / c;
      reinterpret_cast<T*>(tile + static_cast<size_t>(r) * pitch)[i - r * c] = f[base + i];
    }
  }
  const float inv_hw = 1.f / static_cast<float>(hw);
  const T* dgn = dg + static_cast<size_t>(n) * s * s;
  for (int i = tid; i < s * s; i += PGB_THREADS) {
    const int a = i / s;
    const int b = i - a * s;
    m[i] = (to_f32(dgn[a * s + b]) + to_f32(dgn[b * s + a])) * inv_hw;
  }
  for (int o = tid; o < s; o += PGB_THREADS) {
    lo[o] = o * c / s;
    hi[o] = ((o + 1) * c + s - 1) / s;
    w[o] = __frcp_rn(static_cast<float>(hi[o] - lo[o]));
  }
  if constexpr (VEC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // (row, bin, part) sums; a part is plen channels of its bin, in order
  const int pairs = rows * s;
  const int plen = ((c + s - 1) / s + 1 + parts - 1) / parts;  // a bin holds <= ceil(C/S) + 1
  for (int i = tid; i < pairs * parts; i += PGB_THREADS) {
    const int pair = i / parts;
    const int part = i - pair * parts;
    const int r = pair / s;
    const int o = pair - r * s;
    const T* row = reinterpret_cast<const T*>(tile + static_cast<size_t>(r) * pitch);
    const int begin = lo[o] + part * plen;
    const int end = min(hi[o], begin + plen);
    float a0 = 0.f, a1 = 0.f;
    int k = begin;
    for (; k + 1 < end; k += 2) {
      a0 += to_f32(row[k]);
      a1 += to_f32(row[k + 1]);
    }
    if (k < end) a0 += to_f32(row[k]);
    psum[i] = a0 + a1;
  }
  __syncthreads();
  for (int i = tid; i < pairs; i += PGB_THREADS) {
    float sum = 0.f;
    for (int part = 0; part < parts; ++part) sum += psum[i * parts + part];
    ys[i] = sum * w[i % s];
  }
  __syncthreads();
  for (int i = tid; i < pairs; i += PGB_THREADS) {
    const int r = i / s;
    const int o = i - r * s;
    const float* y = ys + r * s;
    float acc = 0.f;
    for (int q = 0; q < s; ++q) acc = fmaf(y[q], m[q * s + o], acc);
    zs[i] = acc * w[o];
  }
  __syncthreads();

  // dF: each channel the sum of z over the bins that hold it, in bin order
  T* out = df + base;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int vecs = c / V;  // 16-byte groups a row
    for (int i = tid; i < rows * vecs; i += PGB_THREADS) {
      const int r = i / vecs;
      const int c0 = (i - r * vecs) * V;
      const float* z = zs + r * s;
      int o = static_cast<int>(static_cast<long long>(c0) * s / c);
      alignas(16) T v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ch = c0 + j;
        while (hi[o] <= ch) ++o;
        float acc = 0.f;
        for (int q = o; q < s && lo[q] <= ch; ++q) acc += z[q];
        v[j] = from_f32<T>(acc);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * c + c0) =
          *reinterpret_cast<const uint4*>(v);
    }
  } else {
    for (int i = tid; i < rows * c; i += PGB_THREADS) {
      const int r = i / c;
      const int ch = i - r * c;
      const float* z = zs + r * s;
      float acc = 0.f;
      for (int q = static_cast<int>(static_cast<long long>(ch) * s / c); q < s && lo[q] <= ch;
           ++q)
        acc += z[q];
      out[i] = from_f32<T>(acc);
    }
  }
}

template <typename T>
cudaError_t pooled_gram_bwd(const void* f, const void* dg, void* df, int n, int hw, int c, int s,
                            cudaStream_t stream) {
  if (static_cast<size_t>(c) * sizeof(T) > PG_MAX_ROW_BYTES) return cudaErrorInvalidValue;
  const PgbPlan p = pgb_plan(hw, c, s, static_cast<int>(sizeof(T)));
  const bool vec = c * sizeof(T) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(df)) & 15) == 0;
  const auto kernel = vec ? pooled_gram_bwd_kernel<T, true> : pooled_gram_bwd_kernel<T, false>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((hw + p.rows - 1) / p.rows), static_cast<unsigned>(n));
  kernel<<<grid, PGB_THREADS, p.smem, stream>>>(static_cast<const T*>(f),
                                                static_cast<const T*>(dg), static_cast<T*>(df), hw,
                                                c, s, p.rows, p.parts, p.pitch);
  return cudaGetLastError();
}

// Launch with the split axis as a cluster (1, splits, 1); above 8 blocks a
// cluster is non-portable and has to be allowed per kernel.
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads, size_t smem, int splits,
                             cudaStream_t stream, Args... args) {
  if (splits > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = static_cast<unsigned>(splits);
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool ASYNC>
cudaError_t gram_fwd_ffma(const void* f, void* g, int n, int hw, int c, int n_tri, int splits,
                          int rows_per_split, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_tri), static_cast<unsigned>(splits),
                  static_cast<unsigned>(n));
  const T* fp = static_cast<const T*>(f);
  T* gp = static_cast<T*>(g);
  if (splits == 1)
    return launch_clustered(gram_fwd_kernel<T, ASYNC, false>, grid, THREADS, 0, 1, stream, fp, gp,
                            hw, c, 1, rows_per_split);
  return launch_clustered(gram_fwd_kernel<T, ASYNC, true>, grid, THREADS, 0, splits, stream, fp,
                          gp, hw, c, splits, rows_per_split);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map over a (depth, rows, inner) bf16 array, inner contiguous, with a
// box of box_inner x box_rows x 1; zeros are read and nothing is written out
// of bounds.
bool encode_bf16(CUtensorMap* map, const void* base, int inner, int rows, int depth,
                 int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 only; TMA needs 16-byte global strides and base addresses, and the
// splits must start on a stage boundary. A tensor map that cannot be
// encoded is reported as cudaErrorInvalidValue.
template <int KROWS>
cudaError_t gram_fwd_wgmma(const void* f, void* g, int n, int hw, int c, int n_tri, int splits,
                           int rows_per_split, cudaStream_t stream) {
  if (c % 8 != 0 || (reinterpret_cast<uintptr_t>(f) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(g) & 15) != 0 || rows_per_split % KROWS != 0)
    return cudaErrorInvalidValue;
  const bool split = splits > 1;
  const SubGrid sg(splits);
  CUtensorMap fmap, gmap_d, gmap_m;
  if (!encode_bf16(&fmap, f, c, hw, n, TILE, KROWS, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (split ? !encode_bf16(&gmap_d, g, c, c, n, sg.bc, sg.br, CU_TENSOR_MAP_SWIZZLE_NONE) ||
                  !encode_bf16(&gmap_m, g, c, c, n, sg.br, sg.bc, CU_TENSOR_MAP_SWIZZLE_NONE)
            : !encode_bf16(&gmap_d, g, c, c, n, TILE, TILE, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!split) gmap_m = gmap_d;
  const int stage_bytes = 2 * KROWS * TILE * 2;
  // the longest split (the last takes the rest of HW) sets the ring's depth;
  // a split of two or more blocks needs two stages or more
  const int longest = max(min(rows_per_split, hw), hw - (splits - 1) * rows_per_split);
  const int blocks = (longest + KROWS - 1) / KROWS;
  const int stages = min(min(MAX_STAGES, RING_BYTES / stage_bytes), blocks);
  const int ring_bytes = max(stages * stage_bytes, 2 * TILE_BYTES);  // and the output staging
  const size_t smem = static_cast<size_t>(ring_bytes) + (split ? RECV_BYTES : 0) +
                      2 * MAX_STAGES * sizeof(uint64_t);
  const auto kernel =
      split ? gram_fwd_wgmma_kernel<true, KROWS> : gram_fwd_wgmma_kernel<false, KROWS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_tri), static_cast<unsigned>(splits),
                  static_cast<unsigned>(n));
  return launch_clustered(kernel, grid, WG, smem, splits, stream, fmap, gmap_d, gmap_m, hw, splits,
                          rows_per_split, stages, ring_bytes);
}

// The longest split's channels (the last takes the rest of C).
int longest_k(int c, int splits, int k_per_split) {
  return max(min(k_per_split, c), c - (splits - 1) * k_per_split);
}

template <typename T, bool ASYNC, int BM, int BN>
cudaError_t gram_bwd_ffma(const void* f, const void* dg, void* df, int n, int hw, int c,
                          int splits, int k_per_split, cudaStream_t stream) {
  const auto kernel = gram_bwd_kernel<T, ASYNC, BM, BN>;
  constexpr size_t smem = BwdTile<BM, BN>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int col_tiles = (c + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>((hw + BM - 1) / BM * col_tiles),
                  static_cast<unsigned>(splits), static_cast<unsigned>(n));
  return launch_clustered(kernel, grid, BwdTile<BM, BN>::THREADS, smem, splits, stream,
                          static_cast<const T*>(f), static_cast<const T*>(dg), static_cast<T*>(df),
                          hw, c, col_tiles, splits, k_per_split);
}

// col_tile 128 takes the 64 x 128 tile, 64 the 128 x 64 one.
template <typename T, bool ASYNC>
cudaError_t gram_bwd_ffma(const void* f, const void* dg, void* df, int n, int hw, int c,
                          int col_tile, int splits, int k_per_split, cudaStream_t stream) {
  return col_tile == 128
             ? gram_bwd_ffma<T, ASYNC, 64, 128>(f, dg, df, n, hw, c, splits, k_per_split, stream)
             : gram_bwd_ffma<T, ASYNC, 128, 64>(f, dg, df, n, hw, c, splits, k_per_split, stream);
}

// bf16 only; TMA needs 16-byte global strides and base addresses. A tensor
// map that cannot be encoded is reported as cudaErrorInvalidValue.
template <int BM, int BN>
cudaError_t gram_bwd_wgmma(const void* f, const void* dg, void* df, int n, int hw, int c,
                           int splits, int k_per_split, cudaStream_t stream) {
  if (c % 8 != 0 || k_per_split % TILE != 0 || ((reinterpret_cast<uintptr_t>(f) |
      reinterpret_cast<uintptr_t>(dg) | reinterpret_cast<uintptr_t>(df)) & 15) != 0)
    return cudaErrorInvalidValue;
  CUtensorMap fmap, gmap, dfmap;
  if (!encode_bf16(&fmap, f, c, hw, n, TILE, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(&gmap, dg, c, c, n, TILE, TILE, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(&dfmap, df, c, hw, n, TILE, TILE, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  constexpr int stage_bytes = BM * 128 + 2 * (BN / TILE) * TILE_BYTES;
  const int blocks = (longest_k(c, splits, k_per_split) + TILE - 1) / TILE;
  const int stages = max(1, min(min(MAX_STAGES, RING_BYTES / stage_bytes), blocks));
  // the ring also holds the output staging and, with splits, the partials
  const int ring_bytes = max(stages * stage_bytes, splits > 1 ? BM * BN * 4 : BM * BN * 2);
  const size_t smem = static_cast<size_t>(ring_bytes) + 2 * MAX_STAGES * sizeof(uint64_t);
  const auto kernel = gram_bwd_wgmma_kernel<BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int col_tiles = (c + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>((hw + BM - 1) / BM * col_tiles),
                  static_cast<unsigned>(splits), static_cast<unsigned>(n));
  return launch_clustered(kernel, grid, WG, smem, splits, stream, fmap, gmap, dfmap,
                          static_cast<__nv_bfloat16*>(df), hw, c, col_tiles, splits, k_per_split,
                          stages, ring_bytes);
}

// Stage rows, ring slots, and the threads' (bin, part, row group) layout
// follow from C, S and the longest split; see the design note at the top. A
// row of F over PG_MAX_ROW_BYTES is refused as cudaErrorInvalidValue.
template <typename T, bool ASYNC>
cudaError_t pooled_gram_launch(const void* f, void* g, int n, int hw, int c, int s, int splits,
                               cudaStream_t stream) {
  if (static_cast<size_t>(c) * sizeof(T) > PG_MAX_ROW_BYTES) return cudaErrorInvalidValue;
  const int pitch = static_cast<int>((static_cast<size_t>(c) * sizeof(T) + 15) / 16 * 16);
  const int longest = (hw + splits - 1) / splits;
  // (bin, part, row group) pieces for the threads: a stage holds up to
  // 256 / S rows (a thread for each row and bin) or a whole multiple of that
  // many; fewer rows take more parts a bin. rows x S x parts <= max(256,
  // 64 S) stays within PG_SUMS.
  int stage_rows = max(1, min(min(PG_MAX_STAGE_ROWS, PG_STAGE_BYTES / pitch), longest));
  const int row_cap = PG_THREADS / s;
  if (stage_rows > row_cap) stage_rows -= stage_rows % row_cap;
  const int parts = max(1, PG_THREADS / (s * stage_rows));
  const int row_groups = min(stage_rows, PG_THREADS / (s * parts));
  const int stage_bytes = stage_rows * pitch;
  const int stages = (longest + stage_rows - 1) / stage_rows;
  // every stage in flight at once where there are few; two slots at least
  // once there are two stages
  const int slots = stages == 1 ? 1 : max(2, min(min(PG_MAX_SLOTS, stages + 1),
                                                 2 * PG_MAX_ROW_BYTES / stage_bytes));
  const size_t smem = static_cast<size_t>(slots) * stage_bytes;
  const auto kernel = pooled_gram_kernel<T, ASYNC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(1, static_cast<unsigned>(splits), static_cast<unsigned>(n));
  return launch_clustered(kernel, grid, PG_THREADS, smem, splits, stream, static_cast<const T*>(f),
                          static_cast<T*>(g), hw, c, s, splits, stage_rows, parts, row_groups,
                          pitch, slots);
}

// Route: bulk copies where C * sizeof(T) % 16 == 0 on a 16-byte-aligned F,
// scalar loads otherwise (ops/kernels/gram.py _pooled_gram_route mirrors it).
template <typename T>
cudaError_t pooled_gram_fwd(const void* f, void* g, int n, int hw, int c, int s, int splits,
                            cudaStream_t stream) {
  const bool aligned = c % Group<T>::V == 0 && (reinterpret_cast<uintptr_t>(f) & 15) == 0;
  return aligned ? pooled_gram_launch<T, true>(f, g, n, hw, c, s, splits, stream)
                 : pooled_gram_launch<T, false>(f, g, n, hw, c, s, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every entry returns a cudaError_t as int.
extern "C" {

// route: 0 = ffma, 1 = wgmma (bf16 only; stages of 128 HW rows when HW > 64,
// so rows_per_split must then be a multiple of 128); splits: 1, 2, 4, 8 or 16.
int hst_gram_fwd(const void* f, void* g, int n, int hw, int c, int splits, int rows_per_split,
                 int route, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0)
    return cudaErrorInvalidValue;
  const int side = (c + TILE - 1) / TILE;
  const int n_tri = side * (side + 1) / 2;
  if (route == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    return hw > 64 ? gram_fwd_wgmma<128>(f, g, n, hw, c, n_tri, splits, rows_per_split, st)
                   : gram_fwd_wgmma<64>(f, g, n, hw, c, n_tri, splits, rows_per_split, st);
  }
  if (dtype == 1)
    return gram_fwd_ffma<__nv_bfloat16, false>(f, g, n, hw, c, n_tri, splits, rows_per_split,
                                               st);
  if (c % 4 == 0 && (reinterpret_cast<uintptr_t>(f) & 15) == 0)
    return gram_fwd_ffma<float, true>(f, g, n, hw, c, n_tri, splits, rows_per_split, st);
  return gram_fwd_ffma<float, false>(f, g, n, hw, c, n_tri, splits, rows_per_split, st);
}

// route: 0 = ffma (tiles of row_tile x col_tile = 64 x 128 or 128 x 64),
// 1 = wgmma (bf16 only, C % 8 == 0, k_per_split a multiple of 64; 64 x 64
// tiles, or 128 x 128 where C % 128 == 0); splits: 1, 2, 4,
// 8 or 16, the blocks of one cluster, each over k_per_split channels (a
// multiple of 16) and the last over the rest of C (ops/kernels/gram.py
// _gram_bwd_plan).
int hst_gram_bwd(const void* f, const void* dg, void* df, int n, int hw, int c, int route,
                 int row_tile, int col_tile, int splits, int k_per_split, int dtype,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0 ||
      (row_tile != 64 && row_tile != 128) || (col_tile != 64 && col_tile != 128) ||
      k_per_split < BWD_BK || k_per_split % BWD_BK != 0)
    return cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || row_tile != col_tile || (col_tile == 128 && c % 128 != 0))
      return cudaErrorInvalidValue;
    return row_tile == 64 ? gram_bwd_wgmma<64, 64>(f, dg, df, n, hw, c, splits, k_per_split, st)
                          : gram_bwd_wgmma<128, 128>(f, dg, df, n, hw, c, splits, k_per_split, st);
  }
  if (row_tile * col_tile != 64 * 128) return cudaErrorInvalidValue;  // 64 x 128 or 128 x 64
  if (dtype == 1)
    return gram_bwd_ffma<__nv_bfloat16, false>(f, dg, df, n, hw, c, col_tile, splits, k_per_split,
                                               st);
  if (c % 4 == 0 && ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(dg)) & 15) == 0)
    return gram_bwd_ffma<float, true>(f, dg, df, n, hw, c, col_tile, splits, k_per_split, st);
  return gram_bwd_ffma<float, false>(f, dg, df, n, hw, c, col_tile, splits, k_per_split, st);
}

// Y = F P^T as f32 (N, HW, S) into y, for pooled_gram_fwd's route past
// MAX_S (the wrapper then takes gram_fwd's FFMA route on Y); s >= 1.
int hst_pooled_project(const void* f, void* y, int n, int hw, int c, int s, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || hw < 1 || c < 1) return cudaErrorInvalidValue;
  const size_t rows = static_cast<size_t>(n) * hw;
  const unsigned blocks = static_cast<unsigned>((rows * s + PP_THREADS - 1) / PP_THREADS);
  if (dtype == 0)
    pooled_project_kernel<float><<<blocks, PP_THREADS, 0, st>>>(static_cast<const float*>(f),
                                                                static_cast<float*>(y), rows, c, s);
  else
    pooled_project_kernel<__nv_bfloat16><<<blocks, PP_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<float*>(y), rows, c, s);
  return cudaGetLastError();
}

// dF (N, HW, C) in F's type from F and dG (N, S, S) of F's type; s: 1..64,
// any HW, a row of F up to 96 KB (ops/kernels/gram.py pooled_gram_bwd).
int hst_pooled_gram_bwd(const void* f, const void* dg, void* df, int n, int hw, int c, int s,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > PGB_MAX_S || n < 1 || hw < 1 || c < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return pooled_gram_bwd<float>(f, dg, df, n, hw, c, s, st);
  return pooled_gram_bwd<__nv_bfloat16>(f, dg, df, n, hw, c, s, st);
}

// s: 1..16; splits: 1..16, the blocks of one image's cluster; any C and HW.
int hst_pooled_gram_fwd(const void* f, void* g, int n, int hw, int c, int s, int splits, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > MAX_S || splits < 1 || splits > MAX_SPLITS || hw < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return pooled_gram_fwd<float>(f, g, n, hw, c, s, splits, st);
  return pooled_gram_fwd<__nv_bfloat16>(f, g, n, hw, c, s, splits, st);
}

}  // extern "C"
