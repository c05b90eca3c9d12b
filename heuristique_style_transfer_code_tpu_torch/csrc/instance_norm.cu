// Instance-norm kernel for Hopper (sm_90a), bound to Python through ctypes
// (ops/kernels/instance_norm.py):
//
//   instance_norm_fwd  y[b, r, c] = (x[b, r, c] - mu[b, c]) * a[b, c] + bias[b, c],
//                      a = scale * rsqrt(var + eps), optional ReLU     (B, HW, C)
//
// x is the (B, HW, C) view of an NHWC activation (C contiguous), f32 or
// bf16; scale and bias are per-image (B, C) f32 rows (a conditional net's
// blended affines, or one style's row repeated). mu and var are f32 and
// two-pass accurate; the output is cast to x's type once. Launches go on
// the caller's stream, never synchronise and allocate nothing: the wrapper
// passes the output and the scratch buffers in. The C entry returns
// cudaGetLastError() so that a refused launch is seen.
//
// ---------------------------------------------------------------------------
// Replaces heuristique_style_transfer_code_tpu/ops/pallas/
// instance_norm_kernel.py::instance_norm_pallas (pallas_call at :192).
//
// Bound on an H100: bytes. A few FLOPs per element against 4 or 2 bytes
// read and written; at 1 read and 1 write, (8,224,224,32) f32 moves
// 102.8 MB, about 31 us at 3.35 TB/s.
//
// Design. The TPU kernel kept one whole image in VMEM per grid step, so its
// statistics and its apply shared one read of x. A Hopper SM has 227 KB of
// shared memory against a 6.4 MB image, and one block per image would leave
// most of the 132 SMs idle at B = 8, so here each image's HW rows are split
// over many blocks and the work takes three launches:
//
//   1. in_stats: each block holds ITEMS 16-byte vectors per thread in
//      registers (1 read of x). It shifts them by the image's first row
//      K[c] (x - K is exact where x and K are within a factor 2 of each
//      other, and keeps the sums small whatever the mean), sums them, takes
//      the block mean u_b, then sums (u - u_b)^2 over the same registers: a
//      true two-pass within the block, never E[x^2] - E[x]^2. Each block
//      writes (sum u, sum (u - u_b)^2) per channel to a workspace.
//   2. in_finalize: per (b, c), the image's blocks are merged in a fixed
//      order (Chan et al.: M2 = sum_b [M2_b + n_b (u_b - u)^2]), so the
//      result is bit-identical from run to run (no atomics). It writes K,
//      the mean of u and a = scale * rsqrt(M2 / HW + eps); mu = K + u.
//   3. in_apply: y = ((x - K) - u) * a + bias (+ ReLU), 1 read and 1 write.
//      Not x * a + (bias - mu * a), as the TPU kernel had it: at a channel
//      mean of 1e3 that cancels two numbers of size 1e3, and even x - mu
//      carries mu's rounding at 1e3 (3e-5), about 1e-5 of the output.
//
// So the kernel moves 2 reads and 1 write where the TPU kernel moved 1 and
// 1; the bound above is the 1 + 1. Thread-block clusters with distributed
// shared memory (one image per cluster, x kept on chip between the passes),
// or the statistics fused into the convolution's epilogue, are the ways to
// the one read, left for later work.
//
// Any C >= 1 and any HW: 16-byte vectors (4 f32 or 8 bf16 channels) where
// C is a multiple of the vector and the pointers are 16-byte aligned, one
// channel per lane otherwise. None of the TPU kernel's limits (C dividing
// 128, H*W*C a multiple of 128, the VMEM budget) applies.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // vectors each thread keeps in registers

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

// V consecutive elements at p, widened to f32; one 16-byte load when V
// elements fill 16 bytes.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T buf[V];
    *reinterpret_cast<uint4*>(buf) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32<T>(buf[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32<T>(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T buf[V];
#pragma unroll
    for (int i = 0; i < V; ++i) buf[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// Block geometry, shared by in_stats and in_apply. A block covers `rows`
// consecutive rows of one image and up to `cb` vectors of its channels:
// thread t takes vector column t % cb and rows (t / cb) + i * rl for
// i < ITEMS, so at item i the block's threads read one contiguous stretch
// of memory when cb covers all of C.
struct Geometry {
  int hw, c, cb, rl;
};

// Pass 1: per block and channel, (sum of u, sum of (u - u_b)^2) with
// u = x - K, K the image's first row, u_b the block's mean of u.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_stats_kernel(const T* __restrict__ x, float2* __restrict__ ws, Geometry g) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  const bool active = lane_r < g.rl && cvec * V < g.c;
  const int row0 = split * g.rl * ITEMS;
  const int n_b = min(g.rl * ITEMS, g.hw - row0);
  const int ncol = g.cb * V;
  float* part = smem;                  // [rl][ncol] per-thread partials
  float* sum_s = part + g.rl * ncol;   // [ncol] block sums of u
  float* mean_s = sum_s + ncol;        // [ncol] block means of u
  const T* img = x + static_cast<size_t>(b) * g.hw * g.c;

  float u[ITEMS][V];
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  if (active) {
    float k[V];
    load_vec<T, V>(img + cvec * V, k);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = i * g.rl + lane_r;
      if (r < n_b) {
        load_vec<T, V>(img + static_cast<size_t>(row0 + r) * g.c + cvec * V, u[i]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          u[i][v] -= k[v];
          s[v] += u[i][v];
        }
      }
    }
  }
  if (lane_r < g.rl) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[lane_r * ncol + lane_c * V + v] = s[v];
  }
  __syncthreads();
  for (int j = tid; j < ncol; j += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < g.rl; ++r) acc += part[r * ncol + j];
    sum_s[j] = acc;
    mean_s[j] = acc / static_cast<float>(n_b);
  }
  __syncthreads();
  float q[V];
#pragma unroll
  for (int v = 0; v < V; ++v) q[v] = 0.f;
  if (active) {
    float m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = mean_s[lane_c * V + v];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i * g.rl + lane_r < n_b) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = u[i][v] - m[v];
          q[v] = fmaf(d, d, q[v]);
        }
      }
    }
  }
  // every read of `part` happened before the barrier above
  if (lane_r < g.rl) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[lane_r * ncol + lane_c * V + v] = q[v];
  }
  __syncthreads();
  for (int j = tid; j < ncol; j += THREADS) {
    const int ch = group * ncol + j;
    if (ch < g.c) {
      float acc = 0.f;
      for (int r = 0; r < g.rl; ++r) acc += part[r * ncol + j];
      ws[(static_cast<size_t>(b) * gridDim.x + split) * g.c + ch] = make_float2(sum_s[j], acc);
    }
  }
}

// Pass 2: per (b, c), merge the image's splits in a fixed order. A block
// takes FIN_C channels of one image; its FIN_S thread rows each add every
// FIN_S-th split, then thread row 0 adds the FIN_S partials in order.
constexpr int FIN_C = 32, FIN_S = 16;

template <typename T>
__global__ void __launch_bounds__(FIN_C * FIN_S)
in_finalize_kernel(const T* __restrict__ x, const float2* __restrict__ ws,
                   const float* __restrict__ scale, float4* __restrict__ coef, int hw, int c,
                   int splits, int rows, float eps) {
  __shared__ float red[FIN_S][FIN_C];
  __shared__ float ubar_s[FIN_C];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * FIN_C + tx, b = blockIdx.y;
  const bool valid = ch < c;
  const float2* w = ws + static_cast<size_t>(b) * splits * c + ch;
  float acc = 0.f;
  if (valid)
    for (int s = ty; s < splits; s += FIN_S) acc += w[static_cast<size_t>(s) * c].x;
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int i = 0; i < FIN_S; ++i) t += red[i][tx];
    ubar_s[tx] = t / static_cast<float>(hw);
  }
  __syncthreads();
  const float ubar = ubar_s[tx];
  float m2 = 0.f;
  if (valid) {
    for (int s = ty; s < splits; s += FIN_S) {
      const float2 p = w[static_cast<size_t>(s) * c];
      const float n_s = static_cast<float>(min(rows, hw - s * rows));
      const float d = p.x / n_s - ubar;
      m2 += p.y + n_s * d * d;
    }
  }
  red[ty][tx] = m2;  // thread row 0 read `red` before the barrier above
  __syncthreads();
  if (ty == 0 && valid) {
    float t = 0.f;
    for (int i = 0; i < FIN_S; ++i) t += red[i][tx];
    const size_t bc = static_cast<size_t>(b) * c + ch;
    const float k = to_f32<T>(x[static_cast<size_t>(b) * hw * c + ch]);
    coef[bc] = make_float4(k, ubar, scale[bc] * rsqrtf(t / static_cast<float>(hw) + eps), 0.f);
  }
}

// Pass 3: y = ((x - K) - u) * a + bias, ReLU when asked, in x's type.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_apply_kernel(const T* __restrict__ x, const float4* __restrict__ coef,
                const float* __restrict__ bias, T* __restrict__ y, Geometry g) {
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  if (lane_r >= g.rl || cvec * V >= g.c) return;
  const int row0 = split * g.rl * ITEMS;
  const int n_b = min(g.rl * ITEMS, g.hw - row0);
  float k[V], ubar[V], a[V], beta[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int bc = b * g.c + cvec * V + v;
    const float4 p = coef[bc];
    k[v] = p.x;
    ubar[v] = p.y;
    a[v] = p.z;
    beta[v] = bias[bc];
  }
  const size_t base = static_cast<size_t>(b) * g.hw * g.c + cvec * V;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = i * g.rl + lane_r;
    if (r < n_b) {
      const size_t off = base + static_cast<size_t>(row0 + r) * g.c;
      float v_[V];
      load_vec<T, V>(x + off, v_);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = fmaf((v_[v] - k[v]) - ubar[v], a[v], beta[v]);
        v_[v] = RELU ? fmaxf(t, 0.f) : t;
      }
      store_vec<T, V>(y + off, v_);
    }
  }
}

template <typename T, int V>
int launch(const void* x_, const void* scale, const void* bias, void* y_, void* ws, void* coef,
           int batch, int hw, int c, int cb, int rl, int splits, int groups, float eps, int relu,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  const Geometry g{hw, c, cb, rl};
  const dim3 grid(splits, groups, batch);
  const size_t smem = static_cast<size_t>(rl + 2) * cb * V * sizeof(float);
  in_stats_kernel<T, V><<<grid, THREADS, smem, st>>>(x, static_cast<float2*>(ws), g);
  in_finalize_kernel<T><<<dim3((c + FIN_C - 1) / FIN_C, batch), dim3(FIN_C, FIN_S), 0, st>>>(
      x, static_cast<const float2*>(ws), static_cast<const float*>(scale),
      static_cast<float4*>(coef), hw, c, splits, rl * ITEMS, eps);
  if (relu)
    in_apply_kernel<T, V, true><<<grid, THREADS, 0, st>>>(
        x, static_cast<const float4*>(coef), static_cast<const float*>(bias), y, g);
  else
    in_apply_kernel<T, V, false><<<grid, THREADS, 0, st>>>(
        x, static_cast<const float4*>(coef), static_cast<const float*>(bias), y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 to read 16-byte vectors (C a multiple of 16 / sizeof(T), pointers
// 16-byte aligned), 0 for one channel per lane. cb, rl, splits and groups
// are the block geometry the wrapper computed (ops/kernels/instance_norm.py).
int hst_instance_norm_fwd(const void* x, const void* scale, const void* bias, void* y, void* ws,
                          void* coef, int batch, int hw, int c, int cb, int rl, int splits,
                          int groups, float eps, int relu, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      return launch<float, 4>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits, groups,
                              eps, relu, st);
    return launch<float, 1>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits, groups,
                            eps, relu, st);
  }
  if (vec)
    return launch<__nv_bfloat16, 8>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits,
                                    groups, eps, relu, st);
  return launch<__nv_bfloat16, 1>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits,
                                  groups, eps, relu, st);
}

}  // extern "C"
