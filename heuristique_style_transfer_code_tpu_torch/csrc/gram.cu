// Gram-matrix kernels for Hopper (sm_90a), bound to Python through ctypes
// (ops/kernels/gram.py). Three kernels, one shared library:
//
//   gram_fwd         G[n] = F[n]^T F[n] / HW                      (N, C, C)
//   gram_bwd         dF[n] = F[n] (dG[n] + dG[n]^T) / HW          (N, HW, C)
//   pooled_gram_fwd  G[n] = (F[n] P^T)^T (F[n] P^T) / HW          (N, S, S)
//
// F is the (N, HW, C) view of an NHWC activation (C contiguous), f32 or
// bf16; every sum is taken in f32 and the result is cast to F's type once.
// Launches go on the caller's stream, never synchronise and allocate
// nothing: the wrapper passes every output and scratch buffer in. Each C
// entry returns cudaGetLastError() so that a refused launch is seen.
//
// Sums are deterministic: a split of the HW axis writes f32 partials to a
// scratch buffer and a second pass adds them in split order (no atomics).
//
// ---------------------------------------------------------------------------
// gram_fwd replaces heuristique_style_transfer_code_tpu/ops/pallas/
// gram_kernel.py::gram_pallas (pallas_call at :60). Bound on an H100: the
// exact f32 path does 2*N*HW*C^2 FMA-operations without TF32, so it is bound
// by the 67 TFLOP/s f32 rate (about 25 us at (4,56,56,256)); bf16 inputs are
// bound by bytes or the tensor-core rate. Design: the Pallas kernel ran one
// grid program per image, which lost to XLA's batched einsum; here ONE
// launch covers all N images as a grid of 64x64 output tiles per image,
// HW streamed through shared memory 16 rows at a time, 4x4 outputs per
// thread in registers. When tiles x N would leave most of the 132 SMs idle
// (C = 64 or 256 at small N), HW is split across blocks and reduced in a
// second pass. wgmma/TMA and the symmetry of G are left for later work.
//
// gram_bwd is the VJP the style loop needs every iteration (JAX derives it
// by autodiff of the einsum). Same tiling over (HW, C) output tiles, the
// contraction over C; dG and dG^T are both read in the tile load and added
// in shared memory, so the symmetrised matrix never reaches device memory.
//
// pooled_gram_fwd replaces gram_kernel.py::pooled_gram_pallas (pallas_call at
// :100). Bound: bytes (it reads F once; S <= 16 makes it ~S FLOPs/element),
// about 7.7 us for (8,56,56,256) f32 at 3.35 TB/s. Design: as in the Pallas
// kernel the (HW, S) projection PF never leaves the chip. P sits in shared
// memory; each warp projects one row of F at a time (lanes stride over C,
// coalesced), reduces the S partial sums with a shuffle butterfly (every
// lane ends with bit-identical sums) and adds the row's S x S outer product
// into per-lane f32 registers. HW is split across blocks so that layer1's
// few images still fill the SMs; the second pass adds the splits in order.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

// One (i, j) tile of G for image n over the HW rows [k_begin, k_end).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_fwd_kernel(const T* __restrict__ f, T* __restrict__ g, float* __restrict__ ws,
                int hw, int c, int splits, int rows_per_split) {
  __shared__ float As[BK][TILE];
  __shared__ float Bs[BK][TILE];
  const int n = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k_begin = split * rows_per_split;
  const int k_end = min(hw, k_begin + rows_per_split);
  const T* fn = f + static_cast<size_t>(n) * hw * c;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int kk = e / TILE;
      const int col = e % TILE;
      const int k = k0 + kk;
      const bool kin = k < k_end;
      const size_t row = static_cast<size_t>(k) * c;
      As[kk][col] = (kin && i0 + col < c) ? to_f32(fn[row + i0 + col]) : 0.f;
      Bs[kk][col] = (kin && j0 + col < c) ? to_f32(fn[row + j0 + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = As[kk][ty + 16 * r];
        b[r] = Bs[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }

  const float hwf = static_cast<float>(hw);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= c) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j >= c) continue;
      if (splits == 1) {
        g[(static_cast<size_t>(n) * c + i) * c + j] = from_f32<T>(acc[r][s] / hwf);
      } else {
        ws[((static_cast<size_t>(n) * splits + split) * c + i) * c + j] = acc[r][s];
      }
    }
  }
}

// Second pass of a split sum: out[n, e] = sum over splits of ws[n, split, e],
// in split order, divided by HW and cast once. m = elements per image.
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                    int m, int splits, size_t total, float hwf) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t n = idx / m;
  const size_t e = idx % m;
  const float* src = ws + n * splits * m + e;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += src[static_cast<size_t>(sp) * m];
  out[idx] = from_f32<T>(sum / hwf);
}

// One (r, j) tile of dF for image n: sum over k of F[r, k] * (dG[k, j] + dG[j, k]).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_bwd_kernel(const T* __restrict__ f, const T* __restrict__ dg, T* __restrict__ df,
                int hw, int c) {
  __shared__ float As[BK][PAD];  // As[kk][row] = F[r0 + row, k0 + kk]
  __shared__ float Bs[BK][PAD];  // Bs[kk][col] = dG[k0 + kk, j0 + col] + dG[j0 + col, k0 + kk]
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* fn = f + static_cast<size_t>(n) * hw * c;
  const T* dgn = dg + static_cast<size_t>(n) * c * c;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;

  for (int k0 = 0; k0 < c; k0 += BK) {
    // F rows: 16 consecutive k per row; dG[k, j]: 64 consecutive j per k
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int row = e / BK;
      const int kk = e % BK;
      const int r = r0 + row;
      const int k = k0 + kk;
      As[kk][row] = (r < hw && k < c) ? to_f32(fn[static_cast<size_t>(r) * c + k]) : 0.f;
      const int kb = k0 + e / TILE;
      const int col = e % TILE;
      const int j = j0 + col;
      Bs[e / TILE][col] =
          (kb < c && j < c) ? to_f32(dgn[static_cast<size_t>(kb) * c + j]) : 0.f;
    }
    __syncthreads();
    // dG[j, k]: 16 consecutive k per j, added onto the tile loaded above
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int col = e / BK;
      const int kk = e % BK;
      const int j = j0 + col;
      const int k = k0 + kk;
      if (j < c && k < c) Bs[kk][col] += to_f32(dgn[static_cast<size_t>(j) * c + k]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = As[kk][ty + 16 * r];
        b[r] = Bs[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }

  const float hwf = static_cast<float>(hw);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= hw) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j < c) df[(static_cast<size_t>(n) * hw + row) * c + j] = from_f32<T>(acc[r][s] / hwf);
    }
  }
}

constexpr int PG_THREADS = 256;
constexpr int PG_WARPS = PG_THREADS / 32;
constexpr int MAX_S = 16;
constexpr int PAIRS_PER_LANE = MAX_S * MAX_S / 32;

// Rows [k_begin, k_end) of image n: each warp projects a row onto the S bins
// and adds the row's outer product; the block then sums its warps in order.
template <typename T>
__global__ void __launch_bounds__(PG_THREADS)
pooled_gram_kernel(const T* __restrict__ f, const float* __restrict__ p, T* __restrict__ g,
                   float* __restrict__ ws, int hw, int c, int s, int splits,
                   int rows_per_split) {
  extern __shared__ float p_s[];  // (S, C) bin-averaging matrix
  __shared__ float pf_s[PG_WARPS][MAX_S];
  __shared__ float red_s[PG_WARPS][MAX_S * MAX_S];
  const int n = blockIdx.y;
  const int split = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ss2 = s * s;
  const int k_begin = split * rows_per_split;
  const int k_end = min(hw, k_begin + rows_per_split);

  for (int e = threadIdx.x; e < s * c; e += PG_THREADS) p_s[e] = p[e];
  __syncthreads();

  float acc[PAIRS_PER_LANE];
  int pa[PAIRS_PER_LANE], pb[PAIRS_PER_LANE];
#pragma unroll
  for (int t = 0; t < PAIRS_PER_LANE; ++t) {
    const int pair = lane + 32 * t;
    acc[t] = 0.f;
    pa[t] = pair < ss2 ? pair / s : 0;
    pb[t] = pair < ss2 ? pair % s : 0;
  }

  const T* fn = f + static_cast<size_t>(n) * hw * c;
  for (int k = k_begin + warp; k < k_end; k += PG_WARPS) {
    const T* row = fn + static_cast<size_t>(k) * c;
    float part[MAX_S];
#pragma unroll
    for (int o = 0; o < MAX_S; ++o) part[o] = 0.f;
    for (int cc = lane; cc < c; cc += 32) {
      const float x = to_f32(row[cc]);
#pragma unroll
      for (int o = 0; o < MAX_S; ++o)
        if (o < s) part[o] = fmaf(x, p_s[o * c + cc], part[o]);
    }
#pragma unroll
    for (int o = 0; o < MAX_S; ++o) {
      if (o < s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[o] += __shfl_xor_sync(0xffffffffu, part[o], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < MAX_S; ++o)
        if (o < s) pf_s[warp][o] = part[o];
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < PAIRS_PER_LANE; ++t)
      if (lane + 32 * t < ss2) acc[t] = fmaf(pf_s[warp][pa[t]], pf_s[warp][pb[t]], acc[t]);
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < PAIRS_PER_LANE; ++t)
    if (lane + 32 * t < ss2) red_s[warp][lane + 32 * t] = acc[t];
  __syncthreads();
  for (int e = threadIdx.x; e < ss2; e += PG_THREADS) {
    float sum = 0.f;
    for (int w = 0; w < PG_WARPS; ++w) sum += red_s[w][e];
    if (splits == 1) {
      g[static_cast<size_t>(n) * ss2 + e] = from_f32<T>(sum / static_cast<float>(hw));
    } else {
      ws[(static_cast<size_t>(n) * splits + split) * ss2 + e] = sum;
    }
  }
}

template <typename T>
cudaError_t launch_reduce(const float* ws, T* out, int m, int splits, int n, float hwf,
                          cudaStream_t stream) {
  const size_t total = static_cast<size_t>(n) * m;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, out, m, splits, total, hwf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gram_fwd(const void* f, void* g, void* ws, int n, int hw, int c, int splits,
                     int rows_per_split, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((c + TILE - 1) / TILE);
  const dim3 grid(tiles, tiles, static_cast<unsigned>(n * splits));
  gram_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<T*>(g), static_cast<float*>(ws), hw, c, splits,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(static_cast<const float*>(ws), static_cast<T*>(g), c * c, splits, n,
                          static_cast<float>(hw), stream);
}

template <typename T>
cudaError_t gram_bwd(const void* f, const void* dg, void* df, int n, int hw, int c,
                     cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((c + TILE - 1) / TILE),
                  static_cast<unsigned>((hw + TILE - 1) / TILE), static_cast<unsigned>(n));
  gram_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(dg), static_cast<T*>(df), hw, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pooled_gram_fwd(const void* f, const void* p, void* g, void* ws, int n, int hw,
                            int c, int s, int splits, int rows_per_split,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(s) * c * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pooled_gram_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(n));
  pooled_gram_kernel<T><<<grid, PG_THREADS, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(p), static_cast<T*>(g),
      static_cast<float*>(ws), hw, c, s, splits, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(static_cast<const float*>(ws), static_cast<T*>(g), s * s, splits, n,
                          static_cast<float>(hw), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every entry returns a cudaError_t as int.
extern "C" {

int hst_gram_fwd(const void* f, void* g, void* ws, int n, int hw, int c, int splits,
                 int rows_per_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gram_fwd<float>(f, g, ws, n, hw, c, splits, rows_per_split, st);
  return gram_fwd<__nv_bfloat16>(f, g, ws, n, hw, c, splits, rows_per_split, st);
}

int hst_gram_bwd(const void* f, const void* dg, void* df, int n, int hw, int c, int dtype,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gram_bwd<float>(f, dg, df, n, hw, c, st);
  return gram_bwd<__nv_bfloat16>(f, dg, df, n, hw, c, st);
}

int hst_pooled_gram_fwd(const void* f, const void* p, void* g, void* ws, int n, int hw, int c,
                        int s, int splits, int rows_per_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pooled_gram_fwd<float>(f, p, g, ws, n, hw, c, s, splits, rows_per_split, st);
  return pooled_gram_fwd<__nv_bfloat16>(f, p, g, ws, n, hw, c, s, splits, rows_per_split, st);
}

}  // extern "C"
