// Instance-norm kernels for Hopper (sm_90a), bound to Python through ctypes
// (ops/kernels/instance_norm.py):
//
//   instance_norm_fwd  y[b, r, c] = (x[b, r, c] - mu[b, c]) * a[b, c] + bias[b, c],
//                      a = scale * rsqrt(var + eps), optional ReLU     (B, HW, C)
//   instance_norm_bwd  its VJP: dx, dscale, dbias from x, dy (and y under ReLU)
//
// The backward's split route (three launches) is at the end of the "split"
// section below, its cluster route (one launch) at the end of the file.
//
// x is the (B, HW, C) view of an NHWC activation (C contiguous), f32 or
// bf16; scale and bias are per-image (B, C) f32 rows (a conditional net's
// blended affines, or one style's row repeated). mu and var are f32 and
// two-pass accurate; the output is cast to x's type once. Launches go on
// the caller's stream, never synchronise and allocate nothing: the wrapper
// passes the output (and the split route's scratch) in. Each C entry
// returns cudaGetLastError() (or the error of the launch itself) so that a
// refused launch is seen.
//
// ---------------------------------------------------------------------------
// Replaces heuristique_style_transfer_code_tpu/ops/pallas/
// instance_norm_kernel.py::instance_norm_pallas (pallas_call at :192).
//
// Bound on an H100: bytes. A few FLOPs per element against 4 or 2 bytes
// read and written; at 1 read and 1 write, (8,224,224,32) f32 moves
// 102.8 MB, about 31 us at 3.35 TB/s.
//
// Both routes shift x by the image's first row K[c] before any sum: x - K
// is exact where x and K are within a factor 2 of each other, and keeps the
// sums small whatever the mean. The statistics are of u = x - K. The split
// route applies y = ((x - K) - u_mean) * a + bias, the cluster route
// y = (x - K) * a + (bias - u_mean * a), which is one FADD an element less
// and as accurate: both subtract the large part, K, first. Not
// x * a + (bias - mu * a), as the TPU kernel had it: at a channel mean of
// 1e3 that cancels two numbers of size 1e3, and even x - mu carries mu's
// rounding at 1e3 (3e-5), about 1e-5 of the output. No sum is taken with
// atomics: every result is the same from run to run.
//
// Route "cluster" (in_cluster_kernel; the wrapper's plan picks it for the
// fast-style net's shapes): one launch, one thread-block cluster of k <= 16
// blocks per image, 1 read of x and 1 write of y where the image fits in
// the cluster's shared memory. The TPU kernel kept a whole image in VMEM;
// here the cluster's blocks together take its place:
//   1. Block r of the cluster owns a contiguous stretch of the image's rows
//      (HW / k, one more for the first HW % k blocks). Thread 0 issues TMA
//      bulk copies of all of it at once: the resident rows (as many as fit
//      in the block's 227 KB) in chunks onto one mbarrier each (L2
//      evict-first: they are not read again), and the rest, where the image
//      does not fit, through a ring of stages (L2 evict-last: they are read
//      again for the apply). Each thread sums u over its rows as the chunks
//      land (f32). A streamed stage is taken two-pass over the thread's
//      rows of it, about their own mean, and merged exactly into the
//      thread's running (n, mean, M2) (Chan et al.: M2 += M2_g +
//      n n_g / (n + n_g) (mean_g - mean)^2), in stage order.
//   2. The block's per-channel sums (threads added in a fixed tree) go to
//      every block of the cluster through distributed shared memory: st.async
//      into slot r of each block, each store counted on the receiver's
//      mbarrier, which waits for all k x C x 4 bytes. Every block adds the k
//      slots in rank order: the same mean in every block, no scratch in
//      device memory, no cluster barrier.
//   3. Each thread sums (u - mean)^2 over its resident rows, from shared
//      memory, and adds its streamed rows' M2 + n (mean_s - mean)^2: a true
//      two-pass over the whole image. A second exchange, into a second
//      buffer on a second mbarrier, gives var and a = scale * rsqrt(var +
//      eps).
//   4. The apply writes y with 16-byte stores: first the streamed rows,
//      re-read through the ring while they are still in L2, then the
//      resident rows from shared memory. Where the block streams rows, y
//      leaves with evict-first stores that keep those rows in L2; where
//      the image is resident, with plain stores that leave y in L2 for the
//      next layer.
// One cluster barrier a call, arrived at once the mbarriers are set up and
// waited on before the first remote store (every arrive has its wait). All
// stores into a block's shared memory are counted on its two exchange
// mbarriers, so once it has waited on them no other block touches it, and
// it may leave as soon as its own stores are issued.
// What the card showed (tools/instance_norm_sweep.py; PERF.md, Findings):
// blocks that fill an SM are needed to spread a cluster over k SMs, and an
// H100 SXM then holds at most 7 clusters of 10..16 such blocks, 9 of 9 and
// 15 of 8 at once, so B = 8 takes k = 8 (64 SMs): 16 would run the eighth
// image in a second round. Where the image does not fit in 8 x 227 KB,
// rows stream through 3 stages of 64 KB and keep only what is left
// resident: more bytes in flight an SM beat more resident rows, since the
// second read comes from L2. The per-SM rate of the stream in and of the
// stores out, and the chain of two exchanges, bound the small images.
// The plan picks k, the resident rows and the ring so that all B clusters
// are resident at once (cudaOccupancyMaxActiveClusters, queried on the
// card). Needs C % (16 / sizeof(T)) == 0, C <= 256 and 16-byte-aligned x
// and y.
//
// Route "split" (in_stats, in_finalize, in_apply: three launches; the plan
// takes it where a cluster per image cannot serve: few images, which would
// leave most SMs idle, C that is not a whole number of 16-byte vectors,
// misaligned pointers, C > 256):
//   1. in_stats: each block holds ITEMS 16-byte vectors per thread in
//      registers (1 read of x), sums u, takes the block mean u_b, then sums
//      (u - u_b)^2 over the same registers: a true two-pass within the
//      block. Each block writes (sum u, sum (u - u_b)^2) per channel to a
//      workspace.
//   2. in_finalize: per (b, c), the image's blocks are merged in a fixed
//      order (Chan: M2 = sum_b [M2_b + n_b (u_b - u)^2]). It writes K, the
//      mean of u and a = scale * rsqrt(M2 / HW + eps).
//   3. in_apply: y = ((x - K) - u) * a + bias (+ ReLU), 1 read and 1 write.
// So it moves 2 reads and 1 write. It takes any C >= 1 and any HW:
// 16-byte vectors (4 f32 or 8 bf16 channels) where C is a multiple of the
// vector and the pointers are 16-byte aligned, one channel per lane
// otherwise. None of the TPU kernel's limits (C dividing 128, H*W*C a
// multiple of 128, the VMEM budget) applies to either route.
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
int split_launch(const void* x_, const void* scale, const void* bias, void* y_, void* ws,
                 void* coef, int batch, int hw, int c, int cb, int rl, int splits, int groups,
                 float eps, int relu, cudaStream_t st) {
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

// ---- instance_norm_bwd -----------------------------------------------------
//
// The VJP of the forward (JAX differentiates its XLA composition,
// ops/norm.py:70-75 and nn/transformer_net.py:94-105; the TPU kernel had
// no backward). With u = x - K, mean ubar and r = rsqrt(var + eps) of u,
// xhat = (u - ubar) r, g = dy (times 1[y > 0] under ReLU):
//   dbias  = sum_HW g
//   dscale = sum_HW g xhat = r sum_HW g (u - ubar)
//   dx     = scale r (g - dbias / HW - xhat dscale / HW)
// Under ReLU the mask comes from the forward's output y, so the backward
// agrees with the forward about every unit, however the statistics round
// (a mask recomputed from x would flip where the pre-activation lies
// within an ulp of 0, and each flip moves dbias by a whole dy).
//
// Route "split": three launches on the split route's geometry, no atomics
// (the same result from run to run); the wrapper's plan takes it where the
// cluster route (in_bwd_cluster_kernel, below) cannot hold the image's
// strips in the card's shared memory at once, or C or a pointer is odd:
//   1. in_bwd_reduce: each block holds BWD_ITEMS vectors of u and of g per
//      thread in registers and writes, per channel, (sum u, sum (u - u_b)^2,
//      sum g, sum g (u - u_b)) about its own mean u_b: one read of x, dy
//      (and y). HW is split over many blocks, so a single image (the style
//      loop runs at B = 1) still fills the card.
//   2. in_bwd_finalize: per (b, c), the image's blocks merged in a fixed
//      order (Chan: M2 = sum [M2_b + n_b d_b^2], sum g (u - ubar) =
//      sum [H_b + d_b G_b], d_b = u_b - ubar); writes dscale, dbias and the
//      apply's coefficients.
//   3. in_bwd_apply: dx = a ((g - dbias / HW) - (u - ubar) r dscale / HW),
//      a = scale r, a second read of x, dy (and y), one write of dx in x's
//      type.
// Bound on an H100: bytes. It moves 2 reads of x and dy (and y) and a write
// of dx, where the function needs one read of x and dy and a write of dx.

constexpr int BWD_ITEMS = 4;  // vectors of u and of g each thread keeps in registers

// Per-channel sums of a per-thread value over the block's row lanes, in a
// fixed order, into out[0, ncol); `part` is [rl][ncol] scratch. Every
// thread of the block calls it.
template <int V>
__device__ __forceinline__ void column_sums(float* part, float* out, const float (&val)[V],
                                            const Geometry& g, int lane_r, int lane_c) {
  const int ncol = g.cb * V;
  if (lane_r < g.rl) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[lane_r * ncol + lane_c * V + v] = val[v];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ncol; j += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < g.rl; ++r) acc += part[r * ncol + j];
    out[j] = acc;
  }
  __syncthreads();
}

// g = dy, masked by y > 0 under ReLU.
template <typename T, int V, bool RELU>
__device__ __forceinline__ void load_grad(const T* __restrict__ dy, const T* __restrict__ y,
                                          size_t off, float (&out)[V]) {
  load_vec<T, V>(dy + off, out);
  if constexpr (RELU) {
    float yv[V];
    load_vec<T, V>(y + off, yv);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = yv[v] > 0.f ? out[v] : 0.f;
  }
}

// Pass 1: per block and channel (sum u, sum (u - u_b)^2, sum g,
// sum g (u - u_b)).
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                     float4* __restrict__ ws, Geometry g) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  const bool active = lane_r < g.rl && cvec * V < g.c;
  const int row0 = split * g.rl * BWD_ITEMS;
  const int n_b = min(g.rl * BWD_ITEMS, g.hw - row0);
  const int ncol = g.cb * V;
  float* part = smem;               // [rl][ncol]
  float* sum_u = part + g.rl * ncol;  // [ncol] each
  float* sum_g = sum_u + ncol;
  float* m2_s = sum_g + ncol;
  float* h_s = m2_s + ncol;
  const size_t img = static_cast<size_t>(b) * g.hw * g.c;

  float u[BWD_ITEMS][V], gr[BWD_ITEMS][V];
  float s[V], sg[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = sg[v] = 0.f;
  if (active) {
    float k[V];
    load_vec<T, V>(x + img + cvec * V, k);
#pragma unroll
    for (int i = 0; i < BWD_ITEMS; ++i) {
      const int r = i * g.rl + lane_r;
      if (r < n_b) {
        const size_t off = img + static_cast<size_t>(row0 + r) * g.c + cvec * V;
        load_vec<T, V>(x + off, u[i]);
        load_grad<T, V, RELU>(dy, y, off, gr[i]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          u[i][v] -= k[v];
          s[v] += u[i][v];
          sg[v] += gr[i][v];
        }
      }
    }
  }
  column_sums<V>(part, sum_u, s, g, lane_r, lane_c);
  column_sums<V>(part, sum_g, sg, g, lane_r, lane_c);
  float q[V], h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) q[v] = h[v] = 0.f;
  if (active) {
    float m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = sum_u[lane_c * V + v] / static_cast<float>(n_b);
#pragma unroll
    for (int i = 0; i < BWD_ITEMS; ++i) {
      if (i * g.rl + lane_r < n_b) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = u[i][v] - m[v];
          q[v] = fmaf(d, d, q[v]);
          h[v] = fmaf(gr[i][v], d, h[v]);
        }
      }
    }
  }
  column_sums<V>(part, m2_s, q, g, lane_r, lane_c);
  column_sums<V>(part, h_s, h, g, lane_r, lane_c);
  for (int j = tid; j < ncol; j += THREADS) {
    const int ch = group * ncol + j;
    if (ch < g.c)
      ws[(static_cast<size_t>(b) * gridDim.x + split) * g.c + ch] =
          make_float4(sum_u[j], m2_s[j], sum_g[j], h_s[j]);
  }
}

// Pass 2: per (b, c), merge the image's blocks in a fixed order; writes
// dscale, dbias and, for the apply, coef[2 bc] = (K, ubar, a, r dscale / HW)
// and coef[2 bc + 1].x = dbias / HW.
template <typename T>
__global__ void __launch_bounds__(FIN_C * FIN_S)
in_bwd_finalize_kernel(const T* __restrict__ x, const float4* __restrict__ ws,
                       const float* __restrict__ scale, float4* __restrict__ coef,
                       float* __restrict__ dscale, float* __restrict__ dbias, int hw, int c,
                       int splits, int rows, float eps) {
  __shared__ float red[3][FIN_S][FIN_C];
  __shared__ float ubar_s[FIN_C];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * FIN_C + tx, b = blockIdx.y;
  const bool valid = ch < c;
  const float4* w = ws + static_cast<size_t>(b) * splits * c + ch;
  float acc = 0.f;
  if (valid)
    for (int s = ty; s < splits; s += FIN_S) acc += w[static_cast<size_t>(s) * c].x;
  red[0][ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int i = 0; i < FIN_S; ++i) t += red[0][i][tx];
    ubar_s[tx] = t / static_cast<float>(hw);
  }
  __syncthreads();
  const float ubar = ubar_s[tx];
  float m2 = 0.f, gs = 0.f, hs = 0.f;
  if (valid) {
    for (int s = ty; s < splits; s += FIN_S) {
      const float4 p = w[static_cast<size_t>(s) * c];
      const float n_s = static_cast<float>(min(rows, hw - s * rows));
      const float d = p.x / n_s - ubar;
      m2 += p.y + n_s * d * d;
      gs += p.z;
      hs += p.w + d * p.z;
    }
  }
  red[0][ty][tx] = m2;  // thread row 0 read red[0] before the barrier above
  red[1][ty][tx] = gs;
  red[2][ty][tx] = hs;
  __syncthreads();
  if (ty == 0 && valid) {
    float tm = 0.f, tg = 0.f, th = 0.f;
    for (int i = 0; i < FIN_S; ++i) {
      tm += red[0][i][tx];
      tg += red[1][i][tx];
      th += red[2][i][tx];
    }
    const size_t bc = static_cast<size_t>(b) * c + ch;
    const float inv_hw = 1.f / static_cast<float>(hw);
    const float r = rsqrtf(tm * inv_hw + eps);
    const float ds = r * th;
    dbias[bc] = tg;
    dscale[bc] = ds;
    const float k = to_f32<T>(x[static_cast<size_t>(b) * hw * c + ch]);
    coef[2 * bc] = make_float4(k, ubar, scale[bc] * r, r * ds * inv_hw);
    coef[2 * bc + 1] = make_float4(tg * inv_hw, 0.f, 0.f, 0.f);
  }
}

// Pass 3: dx = a ((g - dbias / HW) - (u - ubar) r dscale / HW) in x's type.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                    const float4* __restrict__ coef, T* __restrict__ dx, Geometry g) {
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  if (lane_r >= g.rl || cvec * V >= g.c) return;
  const int row0 = split * g.rl * BWD_ITEMS;
  const int n_b = min(g.rl * BWD_ITEMS, g.hw - row0);
  float k[V], ubar[V], a[V], rds[V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t bc = static_cast<size_t>(b) * g.c + cvec * V + v;
    const float4 p = coef[2 * bc];
    k[v] = p.x;
    ubar[v] = p.y;
    a[v] = p.z;
    rds[v] = p.w;
    db[v] = coef[2 * bc + 1].x;
  }
  const size_t base = static_cast<size_t>(b) * g.hw * g.c + cvec * V;
#pragma unroll
  for (int i = 0; i < BWD_ITEMS; ++i) {
    const int r = i * g.rl + lane_r;
    if (r < n_b) {
      const size_t off = base + static_cast<size_t>(row0 + r) * g.c;
      float xv[V], gv[V];
      load_vec<T, V>(x + off, xv);
      load_grad<T, V, RELU>(dy, y, off, gv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        xv[v] = a[v] * ((gv[v] - db[v]) - ((xv[v] - k[v]) - ubar[v]) * rds[v]);
      store_vec<T, V>(dx + off, xv);
    }
  }
}

template <typename T, int V, bool RELU>
int bwd_launch(const void* x_, const void* dy_, const void* y_, const void* scale, void* dx_,
               void* dscale, void* dbias, void* ws, void* coef, int batch, int hw, int c, int cb,
               int rl, int splits, int groups, float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* dy = static_cast<const T*>(dy_);
  const T* y = static_cast<const T*>(y_);
  const Geometry g{hw, c, cb, rl};
  const dim3 grid(splits, groups, batch);
  const size_t smem = static_cast<size_t>(rl + 4) * cb * V * sizeof(float);
  in_bwd_reduce_kernel<T, V, RELU><<<grid, THREADS, smem, st>>>(x, dy, y,
                                                                static_cast<float4*>(ws), g);
  in_bwd_finalize_kernel<T><<<dim3((c + FIN_C - 1) / FIN_C, batch), dim3(FIN_C, FIN_S), 0, st>>>(
      x, static_cast<const float4*>(ws), static_cast<const float*>(scale),
      static_cast<float4*>(coef), static_cast<float*>(dscale), static_cast<float*>(dbias), hw, c,
      splits, rl * BWD_ITEMS, eps);
  in_bwd_apply_kernel<T, V, RELU><<<grid, THREADS, 0, st>>>(
      x, dy, y, static_cast<const float4*>(coef), static_cast<T*>(dx_), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int bwd_dispatch(const void* x, const void* dy, const void* y, const void* scale, void* dx,
                 void* dscale, void* dbias, void* ws, void* coef, int batch, int hw, int c,
                 int cb, int rl, int splits, int groups, float eps, int relu, cudaStream_t st) {
  if (relu)
    return bwd_launch<T, V, true>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw, c, cb,
                                  rl, splits, groups, eps, st);
  return bwd_launch<T, V, false>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw, c, cb,
                                 rl, splits, groups, eps, st);
}

// ---- the banded entry points (--shard_spatial) ------------------------------
//
// Under spatial partitioning each rank holds a band of an image's rows
// (parallel/spatial.py), and the statistics are the whole image's. The
// split route already has the seam: its statistics pass ends in small
// per-(image, channel) partials. So the band runs the split geometry on
// its rows alone, the rank exchanges the partials with the other bands and
// merges them in rank order (Chan, on the host side of the launch), and the
// apply passes take the merged numbers:
//   instance_norm_band_stats       in_stats_kernel on the band (shifted by
//                                  the band's first row), then
//                                  in_band_finalize_kernel: (n, mean, M2)
//                                  of the band about its own mean
//   instance_norm_band_apply       y = (x - mean) * rstd (+ ReLU)
//   instance_norm_band_bwd_reduce  (sum g, sum g xhat) of the band, xhat =
//                                  (x - mean) rstd, g = dy under y's mask:
//                                  per block, then merged in block order
//   instance_norm_band_bwd_apply   dx = rstd ((g - sum g / n) - xhat sum g xhat / n)
// coef is (B, C) float4 (mean, rstd, 1 / n, 0) of the whole image. Bound on
// an H100: bytes, as the split route: stats read the band once, apply
// reads it and writes y, the backward reads x, dy (and y) twice and writes
// dx.

// Per (b, c), the band's blocks merged in a fixed order into (n, mean, M2)
// about the band's own mean, mean = K + ubar (in_finalize_kernel's merge).
template <typename T>
__global__ void __launch_bounds__(FIN_C * FIN_S)
in_band_finalize_kernel(const T* __restrict__ x, const float2* __restrict__ ws,
                        float* __restrict__ stats, int hw, int c, int splits, int rows) {
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
    stats[3 * bc] = static_cast<float>(hw);
    stats[3 * bc + 1] = k + ubar;
    stats[3 * bc + 2] = t;
  }
}

// The mean, rstd and 1 / n of V channels from coef.
template <int V>
__device__ __forceinline__ void load_coef(const float4* __restrict__ coef, size_t bc0,
                                          float (&mean)[V], float (&rstd)[V],
                                          float (&inv_n)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 p = coef[bc0 + v];
    mean[v] = p.x;
    rstd[v] = p.y;
    inv_n[v] = p.z;
  }
}

// y = (x - mean) * rstd, ReLU when asked, in x's type.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_band_apply_kernel(const T* __restrict__ x, const float4* __restrict__ coef,
                     T* __restrict__ y, Geometry g) {
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  if (lane_r >= g.rl || cvec * V >= g.c) return;
  const int row0 = split * g.rl * ITEMS;
  const int n_b = min(g.rl * ITEMS, g.hw - row0);
  float mean[V], rstd[V], inv_n[V];
  load_coef<V>(coef, static_cast<size_t>(b) * g.c + cvec * V, mean, rstd, inv_n);
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
        const float t = (v_[v] - mean[v]) * rstd[v];
        v_[v] = RELU ? fmaxf(t, 0.f) : t;
      }
      store_vec<T, V>(y + off, v_);
    }
  }
}

// Per block and channel (sum g, sum g xhat) of the band.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_band_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const T* __restrict__ y, const float4* __restrict__ coef,
                          float2* __restrict__ ws, Geometry g) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  const bool active = lane_r < g.rl && cvec * V < g.c;
  const int row0 = split * g.rl * BWD_ITEMS;
  const int n_b = min(g.rl * BWD_ITEMS, g.hw - row0);
  const int ncol = g.cb * V;
  float* part = smem;                 // [rl][ncol]
  float* sum_g = part + g.rl * ncol;  // [ncol] each
  float* sum_h = sum_g + ncol;
  float sg[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sg[v] = sh[v] = 0.f;
  if (active) {
    float mean[V], rstd[V], inv_n[V];
    load_coef<V>(coef, static_cast<size_t>(b) * g.c + cvec * V, mean, rstd, inv_n);
    const size_t base = static_cast<size_t>(b) * g.hw * g.c + cvec * V;
#pragma unroll
    for (int i = 0; i < BWD_ITEMS; ++i) {
      const int r = i * g.rl + lane_r;
      if (r < n_b) {
        const size_t off = base + static_cast<size_t>(row0 + r) * g.c;
        float xv[V], gv[V];
        load_vec<T, V>(x + off, xv);
        load_grad<T, V, RELU>(dy, y, off, gv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sg[v] += gv[v];
          sh[v] = fmaf(gv[v], (xv[v] - mean[v]) * rstd[v], sh[v]);
        }
      }
    }
  }
  column_sums<V>(part, sum_g, sg, g, lane_r, lane_c);
  column_sums<V>(part, sum_h, sh, g, lane_r, lane_c);
  for (int j = tid; j < ncol; j += THREADS) {
    const int ch = group * ncol + j;
    if (ch < g.c)
      ws[(static_cast<size_t>(b) * gridDim.x + split) * g.c + ch] = make_float2(sum_g[j], sum_h[j]);
  }
}

// Per (b, c), the band's blocks added in a fixed order: out = (sum g, sum g xhat).
__global__ void __launch_bounds__(FIN_C * FIN_S)
in_band_bwd_finalize_kernel(const float2* __restrict__ ws, float2* __restrict__ out, int c,
                            int splits) {
  __shared__ float red[2][FIN_S][FIN_C];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * FIN_C + tx, b = blockIdx.y;
  const bool valid = ch < c;
  const float2* w = ws + static_cast<size_t>(b) * splits * c + ch;
  float gs = 0.f, hs = 0.f;
  if (valid) {
    for (int s = ty; s < splits; s += FIN_S) {
      const float2 p = w[static_cast<size_t>(s) * c];
      gs += p.x;
      hs += p.y;
    }
  }
  red[0][ty][tx] = gs;
  red[1][ty][tx] = hs;
  __syncthreads();
  if (ty == 0 && valid) {
    float tg = 0.f, th = 0.f;
    for (int i = 0; i < FIN_S; ++i) {
      tg += red[0][i][tx];
      th += red[1][i][tx];
    }
    out[static_cast<size_t>(b) * c + ch] = make_float2(tg, th);
  }
}

// dx = rstd ((g - sum g / n) - xhat sum g xhat / n), sums the whole image's.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
in_band_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ y, const float4* __restrict__ coef,
                         const float2* __restrict__ sums, T* __restrict__ dx, Geometry g) {
  const int split = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane_c = tid % g.cb, lane_r = tid / g.cb;
  const int cvec = group * g.cb + lane_c;
  if (lane_r >= g.rl || cvec * V >= g.c) return;
  const int row0 = split * g.rl * BWD_ITEMS;
  const int n_b = min(g.rl * BWD_ITEMS, g.hw - row0);
  const size_t bc0 = static_cast<size_t>(b) * g.c + cvec * V;
  float mean[V], rstd[V], inv_n[V], mg[V], mh[V];
  load_coef<V>(coef, bc0, mean, rstd, inv_n);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float2 s = sums[bc0 + v];
    mg[v] = s.x * inv_n[v];
    mh[v] = s.y * inv_n[v];
  }
  const size_t base = static_cast<size_t>(b) * g.hw * g.c + cvec * V;
#pragma unroll
  for (int i = 0; i < BWD_ITEMS; ++i) {
    const int r = i * g.rl + lane_r;
    if (r < n_b) {
      const size_t off = base + static_cast<size_t>(row0 + r) * g.c;
      float xv[V], gv[V];
      load_vec<T, V>(x + off, xv);
      load_grad<T, V, RELU>(dy, y, off, gv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        xv[v] = rstd[v] * ((gv[v] - mg[v]) - (xv[v] - mean[v]) * rstd[v] * mh[v]);
      store_vec<T, V>(dx + off, xv);
    }
  }
}

template <typename T, int V>
int band_stats_launch(const void* x_, void* ws, void* stats, int batch, int hw, int c, int cb,
                      int rl, int splits, int groups, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const Geometry g{hw, c, cb, rl};
  const size_t smem = static_cast<size_t>(rl + 2) * cb * V * sizeof(float);
  in_stats_kernel<T, V><<<dim3(splits, groups, batch), THREADS, smem, st>>>(
      x, static_cast<float2*>(ws), g);
  in_band_finalize_kernel<T><<<dim3((c + FIN_C - 1) / FIN_C, batch), dim3(FIN_C, FIN_S), 0, st>>>(
      x, static_cast<const float2*>(ws), static_cast<float*>(stats), hw, c, splits, rl * ITEMS);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int band_apply_launch(const void* x, const void* coef, void* y, int batch, int hw, int c, int cb,
                      int rl, int splits, int groups, int relu, cudaStream_t st) {
  const Geometry g{hw, c, cb, rl};
  const dim3 grid(splits, groups, batch);
  const float4* cf = static_cast<const float4*>(coef);
  if (relu)
    in_band_apply_kernel<T, V, true><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), cf,
                                                               static_cast<T*>(y), g);
  else
    in_band_apply_kernel<T, V, false><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), cf,
                                                                static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RELU>
int band_bwd_reduce_launch(const void* x, const void* dy, const void* y, const void* coef,
                           void* ws, void* out, int batch, int hw, int c, int cb, int rl,
                           int splits, int groups, cudaStream_t st) {
  const Geometry g{hw, c, cb, rl};
  const size_t smem = static_cast<size_t>(rl + 2) * cb * V * sizeof(float);
  in_band_bwd_reduce_kernel<T, V, RELU><<<dim3(splits, groups, batch), THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const float4*>(coef), static_cast<float2*>(ws), g);
  in_band_bwd_finalize_kernel<<<dim3((c + FIN_C - 1) / FIN_C, batch), dim3(FIN_C, FIN_S), 0, st>>>(
      static_cast<const float2*>(ws), static_cast<float2*>(out), c, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RELU>
int band_bwd_apply_launch(const void* x, const void* dy, const void* y, const void* coef,
                          const void* sums, void* dx, int batch, int hw, int c, int cb, int rl,
                          int splits, int groups, cudaStream_t st) {
  const Geometry g{hw, c, cb, rl};
  in_band_bwd_apply_kernel<T, V, RELU><<<dim3(splits, groups, batch), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const float4*>(coef), static_cast<const float2*>(sums), static_cast<T*>(dx), g);
  return static_cast<int>(cudaGetLastError());
}

// f32 or bf16, 16-byte vectors or one channel a lane: the four instances of
// a banded launch, with the ReLU's two where it has them.
#define HST_BAND_DISPATCH(LAUNCH, ...)                                      \
  do {                                                                      \
    if (dtype == 0)                                                         \
      return vec ? LAUNCH<float, 4>(__VA_ARGS__) : LAUNCH<float, 1>(__VA_ARGS__); \
    return vec ? LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__)                      \
               : LAUNCH<__nv_bfloat16, 1>(__VA_ARGS__);                     \
  } while (0)

template <typename T, int V>
int band_bwd_reduce_relu(const void* x, const void* dy, const void* y, const void* coef, void* ws,
                         void* out, int batch, int hw, int c, int cb, int rl, int splits,
                         int groups, int relu, cudaStream_t st) {
  if (relu)
    return band_bwd_reduce_launch<T, V, true>(x, dy, y, coef, ws, out, batch, hw, c, cb, rl,
                                              splits, groups, st);
  return band_bwd_reduce_launch<T, V, false>(x, dy, y, coef, ws, out, batch, hw, c, cb, rl, splits,
                                             groups, st);
}

template <typename T, int V>
int band_bwd_apply_relu(const void* x, const void* dy, const void* y, const void* coef,
                        const void* sums, void* dx, int batch, int hw, int c, int cb, int rl,
                        int splits, int groups, int relu, cudaStream_t st) {
  if (relu)
    return band_bwd_apply_launch<T, V, true>(x, dy, y, coef, sums, dx, batch, hw, c, cb, rl,
                                             splits, groups, st);
  return band_bwd_apply_launch<T, V, false>(x, dy, y, coef, sums, dx, batch, hw, c, cb, rl, splits,
                                            groups, st);
}

// ---- route "cluster" -------------------------------------------------------

constexpr int CL_THREADS = 256;
constexpr int MAX_CLUSTER = 16;      // non-portable above 8
constexpr int MAX_CHUNKS = 16;       // resident chunks, one mbarrier each
constexpr int MAX_SLOTS = 4;         // ring stages
constexpr int MAX_CL_C = 256;        // a thread per channel in the exchanges
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int UNROLL = 4;            // shared-memory loads in flight a thread

// What the wrapper's plan chose (ops/kernels/instance_norm.py _plan).
struct ClusterPlan {
  int hw, c, k;    // rows and channels of an image, blocks of its cluster
  int res_rows;    // rows a block keeps resident, at most
  int chunk_rows;  // resident rows a TMA chunk
  int stage_rows;  // streamed rows a ring stage (0 where every row is resident)
  int slots;       // ring stages (0 likewise)
  int min_smem;    // shared memory a block asks for at least: above half an SM's,
                   // no two blocks share an SM
};

// in_cluster_kernel's dynamic shared memory, region by region, as byte
// offsets (ops/kernels/instance_norm.py _cluster_smem mirrors it): the
// resident rows at 0, the ring, the two exchange buffers [2][k][C] f32, the
// block sum's partials (at most [threads][V] f32), the per-channel mean, a
// and bias - mean * a [3][C] f32, the mbarriers (resident chunks, ring
// slots, the two exchanges); `total` is what a block asks for, at least
// min_smem.
struct ClusterLayout {
  size_t ring, recv, red, coef, bars, used, total;
  __host__ __device__ ClusterLayout(const ClusterPlan& p, int elem) {
    const size_t row = static_cast<size_t>(p.c) * elem;
    ring = static_cast<size_t>(p.res_rows) * row;
    recv = ring + static_cast<size_t>(p.slots) * p.stage_rows * row;
    red = recv + 2 * static_cast<size_t>(p.k) * p.c * 4;
    coef = red + static_cast<size_t>(CL_THREADS) * (16 / elem) * 4;
    bars = coef + 3 * static_cast<size_t>(p.c) * 4;
    used = bars + 8 * (MAX_CHUNKS + MAX_SLOTS + 2);
    total = used > static_cast<size_t>(p.min_smem) ? used : static_cast<size_t>(p.min_smem);
  }
};

bool cluster_plan_ok(const ClusterPlan& p, int elem) {
  const int v = 16 / elem;
  if (p.k < 1 || p.k > MAX_CLUSTER || p.hw < 1 || p.c < v || p.c % v != 0 || p.c > MAX_CL_C ||
      p.res_rows < 0 || p.chunk_rows < 1 || p.min_smem < 0 ||
      p.stage_rows < 0 || p.slots < 0 ||
      p.slots > MAX_SLOTS || (p.res_rows + p.chunk_rows - 1) / p.chunk_rows > MAX_CHUNKS)
    return false;
  const int longest = (p.hw + p.k - 1) / p.k;
  if (longest > p.res_rows && (p.stage_rows < 1 || p.slots < 1)) return false;
  return ClusterLayout(p, elem).total <= MAX_SMEM;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// Bytes from global memory into shared memory by TMA, completing on `bar`,
// under an L2 cache policy.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

// The channels of one 16-byte vector, as f32 (bf16 widens exactly by a
// shift), and back.
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
  __device__ static uint4 pack(const float (&x)[4]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
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
  // two channels a conversion (cvt.rn.bf16x2.f32), rounded to nearest even
  __device__ static uint4 pack(const float (&x)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Per-channel sum of every thread's V values (clobbered), added in a fixed
// order, into threads tid < C / 4 as channels 4 tid .. 4 tid + 3. Where
// C / V divides 32, the lanes of a warp that share a column are added by
// shuffles first and each warp's partial goes to red[warp][C]; otherwise
// each row lane's values go to red[lane_r][C]. Then the rows of red, in
// order. Every thread of the block must call it, and a block barrier must
// come between two calls (the second writes red).
template <int V>
__device__ float4 block_sum(float (&v)[V], bool active, int lane_r, int lane_c, int cv, int rl,
                            int c, float* red) {
  const int tid = threadIdx.x;
  int rows = rl;
  if (32 % cv == 0) {
    for (int off = cv; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
    if ((tid & 31) < cv) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[(tid >> 5) * c + lane_c * V + i] = v[i];
    }
    rows = CL_THREADS / 32;
  } else if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[lane_r * c + lane_c * V + i] = v[i];
  }
  __syncthreads();
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < c / 4) {
    for (int r = 0; r < rows; ++r) {
      const float4 t = reinterpret_cast<const float4*>(red + r * c)[tid];
      out.x += t.x;
      out.y += t.y;
      out.z += t.z;
      out.w += t.w;
    }
  }
  return out;
}

// Channels 4 threadIdx.x .. + 3 summed over the k slots of buf[k][C], in
// rank order (every block adds them alike).
__device__ __forceinline__ float4 slot_sum4(const float* buf, int k, int c) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < k; ++r) {
    const float4 t = reinterpret_cast<const float4*>(buf + r * c)[threadIdx.x];
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  return s;
}

// Phase marks for tools/instance_norm_sweep.py and
// tools/instance_norm_bwd_sweep.py, which build this source with
// -DIN_PHASE_TRACE: thread 0 of each block (blockIdx.y x gridDim.x +
// blockIdx.x; the backward's at B = 1) stores %clock64 at mark i to
// in_phase_clock[block][i] and %globaltimer to in_phase_time, and at mark 0
// its SM (%smid) to in_phase_clock[block][7]. Empty otherwise.
#ifdef IN_PHASE_TRACE
constexpr int IN_MARKS = 8;
__device__ unsigned long long in_phase_clock[1 << 16];
__device__ unsigned long long in_phase_time[1 << 16];
#define IN_MARK(i)                                                                   \
  do {                                                                               \
    if (threadIdx.x == 0) {                                                          \
      unsigned long long t_, c_;                                                     \
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t_));                       \
      asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c_));                           \
      const size_t at_ = (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * \
                             IN_MARKS + (i);                                          \
      in_phase_clock[at_] = c_;                                                      \
      in_phase_time[at_] = t_;                                                       \
      if ((i) == 0) {                                                                \
        unsigned int sm_;                                                            \
        asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm_));                            \
        in_phase_clock[at_ + 7] = sm_;                                               \
      }                                                                              \
    }                                                                                \
  } while (0)
#else
#define IN_MARK(i) \
  do {             \
  } while (0)
#endif

// Calls f(r, v) for rows r = first, first + step, ... < end, v the 16-byte
// vector at base + r * pitch in shared memory, loading U rows before the
// first of them is used.
template <int U, typename F>
__device__ __forceinline__ void for_rows(const uint8_t* base, uint32_t pitch, int first, int end,
                                         int step, F f) {
  int r = first;
  for (; r + (U - 1) * step < end; r += U * step) {
    uint4 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      v[j] = *reinterpret_cast<const uint4*>(base + static_cast<uint32_t>(r + j * step) * pitch);
#pragma unroll
    for (int j = 0; j < U; ++j) f(r + j * step, v[j]);
  }
  for (; r < end; r += step)
    f(r, *reinterpret_cast<const uint4*>(base + static_cast<uint32_t>(r) * pitch));
}

// Stores v at `slot` (an address in this block's shared memory) in every
// block of the cluster, this one included, each store counted on that
// block's mbarrier `bar` (st.async: the receiver waits for its bytes, no
// cluster barrier).
__device__ __forceinline__ void push_slot(const void* slot, uint64_t* bar, int k, float4 v) {
  const uint32_t local = smem_u32(slot);
  const uint32_t local_bar = smem_u32(bar);
  for (int dst = 0; dst < k; ++dst) {
    uint32_t remote, remote_bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(dst));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote_bar)
                 : "r"(local_bar), "r"(dst));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(remote),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
        : "memory");
  }
}

// Stores v into slot `rank` of buf[k][C] (channels 4 threadIdx.x .. + 3)
// in every block of the cluster (the receiver waits for k x C x 4 bytes).
__device__ __forceinline__ void push_all(float* buf, uint64_t* bar, uint32_t rank, int k, int c,
                                         float4 v) {
  push_slot(buf + rank * c + 4 * threadIdx.x, bar, k, v);
}

// y = (x - K) * a + (bias - u_mean * a) (+ ReLU) of one 16-byte vector, in
// x's type.
template <typename T, bool RELU, int V>
__device__ __forceinline__ uint4 apply_vec(uint4 raw, const float (&k)[V], const float (&a)[V],
                                           const float (&shift)[V]) {
  float u[V];
  Group<T>::unpack(raw, u);
  float t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    t[i] = fmaf(u[i] - k[i], a[i], shift[i]);
    if (RELU) t[i] = fmaxf(t[i], 0.f);
  }
  return Group<T>::pack(t);
}

// One image per cluster (blockIdx.y), block `rank` of it over its stretch
// of rows; see the design note at the top. Thread t takes vector column
// t % (C / V) and rows t / (C / V), + rl, ... of every region, so a warp
// reads and writes contiguous memory.
template <typename T, bool RELU>
__global__ void __launch_bounds__(CL_THREADS, 1)
in_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, ClusterPlan p, float eps) {
  extern __shared__ __align__(128) uint8_t cl_smem[];
  constexpr int V = Group<T>::V;
  IN_MARK(0);
  const int tid = threadIdx.x;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int b = blockIdx.y;
  const int c = p.c;
  const ClusterLayout L(p, sizeof(T));
  const uint32_t row_bytes = static_cast<uint32_t>(c * sizeof(T));
  const int base = p.hw / p.k, extra = p.hw % p.k;
  const int r0 = static_cast<int>(rank) * base + min(static_cast<int>(rank), extra);
  const int n = base + (static_cast<int>(rank) < extra ? 1 : 0);
  const int res = min(n, p.res_rows);  // resident rows: [r0 + nstr, r0 + n)
  const int nstr = n - res;            // streamed rows: [r0, r0 + nstr)
  const int stages = nstr > 0 ? (nstr + p.stage_rows - 1) / p.stage_rows : 0;
  const int chunks = (res + p.chunk_rows - 1) / p.chunk_rows;
  const size_t img = static_cast<size_t>(b) * p.hw * c;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(x + img);
  uint64_t* landed = reinterpret_cast<uint64_t*>(cl_smem + L.bars);  // resident chunks
  uint64_t* full = landed + MAX_CHUNKS;                              // ring slots
  uint64_t* got = full + MAX_SLOTS;  // the two exchanges' k x C partials have landed
  const uint32_t sbase = smem_u32(cl_smem);
  const uint32_t stage_bytes = static_cast<uint32_t>(p.stage_rows) * row_bytes;
  const uint64_t keep = l2_evict_last(), drop = l2_evict_first();

  // Ring stage g < stages is streamed stage g's first read; stage g >=
  // stages reads streamed stage g - stages again, for the apply.
  auto load_stage = [&](int g) {
    const int s = g < stages ? g : g - stages;
    const uint32_t bytes = min(p.stage_rows, nstr - s * p.stage_rows) * row_bytes;
    uint64_t* bar = &full[g % p.slots];
    // the slot's last reads (generic proxy) come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);
    bulk_load(sbase + static_cast<uint32_t>(L.ring) + (g % p.slots) * stage_bytes,
              src + static_cast<size_t>(r0 + s * p.stage_rows) * row_bytes, bytes, bar,
              g < stages ? keep : drop);
  };
  if (tid == 0) {
    for (int i = 0; i < chunks; ++i) mbar_init(&landed[i], 1);
    for (int i = 0; i < p.slots; ++i) mbar_init(&full[i], 1);
    for (int e = 0; e < 2; ++e) {
      mbar_init(&got[e], 1);
      mbar_expect_tx(&got[e], static_cast<uint32_t>(p.k * c * 4));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block of the cluster must have initialised its mbarriers before
  // any remote store: arrive now, wait just before the first exchange.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid == 0) {  // every copy of the block's rows goes out at once
    // (with fewer stages than slots, the second reads go out now too)
    for (int g = 0; g < min(p.slots, 2 * stages); ++g) load_stage(g);
    for (int i = 0; i < chunks; ++i) {
      const uint32_t bytes = min(p.chunk_rows, res - i * p.chunk_rows) * row_bytes;
      mbar_expect_tx(&landed[i], bytes);
      bulk_load(sbase + i * p.chunk_rows * row_bytes,
                src + static_cast<size_t>(r0 + nstr + i * p.chunk_rows) * row_bytes, bytes,
                &landed[i], drop);
    }
  }

  const int cv = c / V;
  const int rl = CL_THREADS / cv;
  const int lane_c = tid % cv, lane_r = tid / cv;
  const bool active = lane_r < rl;
  const uint8_t* col = cl_smem + lane_c * 16;  // this thread's column of the resident rows
  float sc[4] = {}, bi[4] = {};  // the image's scale and bias of channels 4 tid .. + 3
  if (tid < c / 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[i] = __ldg(scale + b * c + 4 * tid + i);
      bi[i] = __ldg(bias + b * c + 4 * tid + i);
    }
  }
  float kf[V];  // the shift K: the image's first row
  Group<T>::unpack(active ? __ldg(reinterpret_cast<const uint4*>(x + img) + lane_c)
                          : make_uint4(0u, 0u, 0u, 0u),
                   kf);
  float s_all[V], m_s[V], q_s[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s_all[i] = m_s[i] = q_s[i] = 0.f;
  float n_s = 0.f;
  __syncthreads();  // the mbarriers are initialised

  // 1a. streamed stages: two-pass over the thread's rows of the stage, then
  // a Chan merge into (n_s, m_s, q_s)
  for (int g = 0; g < stages; ++g) {
    mbar_wait(&full[g % p.slots], (g / p.slots) & 1);
    const int rows = min(p.stage_rows, nstr - g * p.stage_rows);
    if (active && lane_r < rows) {
      const uint8_t* st = col + L.ring + (g % p.slots) * stage_bytes;
      float sg[V], qg[V], mg[V];
#pragma unroll
      for (int i = 0; i < V; ++i) sg[i] = qg[i] = 0.f;
      for_rows<UNROLL>(st, row_bytes, lane_r, rows, rl, [&](int, uint4 raw) {
        float u[V];
        Group<T>::unpack(raw, u);
#pragma unroll
        for (int i = 0; i < V; ++i) sg[i] += u[i] - kf[i];
      });
      const float fg = static_cast<float>((rows - lane_r + rl - 1) / rl);
#pragma unroll
      for (int i = 0; i < V; ++i) mg[i] = sg[i] / fg;
      for_rows<UNROLL>(st, row_bytes, lane_r, rows, rl, [&](int, uint4 raw) {
        float u[V];
        Group<T>::unpack(raw, u);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = (u[i] - kf[i]) - mg[i];
          qg[i] = fmaf(d, d, qg[i]);
        }
      });
      const float nn = n_s + fg;
      const float w = fg / nn, w2 = n_s * w;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = mg[i] - m_s[i];
        m_s[i] = fmaf(d, w, m_s[i]);
        q_s[i] += qg[i] + d * d * w2;
        s_all[i] += sg[i];
      }
      n_s = nn;
    }
    __syncthreads();  // every thread has read the slot
    if (tid == 0 && g + p.slots < 2 * stages) load_stage(g + p.slots);
  }
  IN_MARK(1);
  // 1b. resident chunks, summed as they land
  for (int i = 0; i < chunks; ++i) {
    mbar_wait(&landed[i], 0);
    if (active)
      for_rows<UNROLL>(col, row_bytes, i * p.chunk_rows + lane_r,
                       min(res, (i + 1) * p.chunk_rows), rl, [&](int, uint4 raw) {
                         float u[V];
                         Group<T>::unpack(raw, u);
#pragma unroll
                         for (int j = 0; j < V; ++j) s_all[j] += u[j] - kf[j];
                       });
  }
  IN_MARK(2);

  // 2. the mean of u over the cluster
  float* recv = reinterpret_cast<float*>(cl_smem + L.recv);  // [2][k][C]
  float* red = reinterpret_cast<float*>(cl_smem + L.red);
  float4* coef = reinterpret_cast<float4*>(cl_smem + L.coef);  // mean, a, shift: [3][C / 4]
  const int c4 = c / 4;
  // this thread's V channels of coefficient row j
  auto coefs = [&](int j, float (&out)[V]) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = coef[j * c4 + lane_c * (V / 4) + q];
      out[4 * q] = t.x;
      out[4 * q + 1] = t.y;
      out[4 * q + 2] = t.z;
      out[4 * q + 3] = t.w;
    }
  };
  const float4 sum_u = block_sum<V>(s_all, active, lane_r, lane_c, cv, rl, c, red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block has started
  if (tid < c4) push_all(recv, &got[0], rank, p.k, c, sum_u);
  mbar_wait(&got[0], 0);  // every block's sums have reached this one
  IN_MARK(3);
  const float inv_hw = 1.f / static_cast<float>(p.hw);
  if (tid < c4) {
    const float4 t = slot_sum4(recv, p.k, c);
    coef[tid] = make_float4(t.x * inv_hw, t.y * inv_hw, t.z * inv_hw, t.w * inv_hw);
  }
  __syncthreads();
  float ubar[V];
  coefs(0, ubar);

  // 3. sum of (u - mean)^2: the resident rows from shared memory, the
  // streamed ones from their merged (n_s, m_s, q_s)
  float q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = m_s[i] - ubar[i];
    q[i] = fmaf(n_s * d, d, q_s[i]);
  }
  if (active)
    for_rows<UNROLL>(col, row_bytes, lane_r, res, rl, [&](int, uint4 raw) {
      float u[V];
      Group<T>::unpack(raw, u);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = (u[i] - kf[i]) - ubar[i];
        q[i] = fmaf(d, d, q[i]);
      }
    });
  const float4 m2 = block_sum<V>(q, active, lane_r, lane_c, cv, rl, c, red);
  if (tid < c4) push_all(recv + p.k * c, &got[1], rank, p.k, c, m2);
  // Every store into this block's shared memory is counted on got[0] or
  // got[1], so once they complete no other block touches it and it may
  // leave whenever it is done.
  mbar_wait(&got[1], 0);
  IN_MARK(4);
  if (tid < c4) {
    const float4 t = slot_sum4(recv + p.k * c, p.k, c);
    const float4 m = coef[tid];
    float4 a4;
    a4.x = sc[0] * rsqrtf(fmaf(t.x, inv_hw, eps));
    a4.y = sc[1] * rsqrtf(fmaf(t.y, inv_hw, eps));
    a4.z = sc[2] * rsqrtf(fmaf(t.z, inv_hw, eps));
    a4.w = sc[3] * rsqrtf(fmaf(t.w, inv_hw, eps));
    coef[c4 + tid] = a4;
    // bias - u_mean * a
    coef[2 * c4 + tid] = make_float4(fmaf(-m.x, a4.x, bi[0]), fmaf(-m.y, a4.y, bi[1]),
                                     fmaf(-m.z, a4.z, bi[2]), fmaf(-m.w, a4.w, bi[3]));
  }
  __syncthreads();
  float a[V], shift[V];
  coefs(1, a);
  coefs(2, shift);
  // y stays in L2 for the next layer, unless this block streams rows that
  // are still to be read again there
  const bool streaming = nstr > 0;

  // 4. the apply: streamed rows first, through the ring, while they are in
  // L2; then the resident rows
  uint4* yv = reinterpret_cast<uint4*>(y + img) + lane_c;  // cv 16-byte vectors a row
  for (int s = 0; s < stages; ++s) {
    const int g = stages + s;
    mbar_wait(&full[g % p.slots], (g / p.slots) & 1);
    const int rows = min(p.stage_rows, nstr - s * p.stage_rows);
    if (active) {
      uint4* out = yv + static_cast<size_t>(r0 + s * p.stage_rows) * cv;
      for_rows<UNROLL>(col + L.ring + (g % p.slots) * stage_bytes, row_bytes, lane_r, rows, rl,
                       [&](int r, uint4 raw) {
                         __stcs(out + static_cast<size_t>(r) * cv,
                                apply_vec<T, RELU, V>(raw, kf, a, shift));
                       });
    }
    __syncthreads();  // every thread has read the slot
    if (tid == 0 && g + p.slots < 2 * stages) load_stage(g + p.slots);
  }
  IN_MARK(5);
  if (active) {
    uint4* out = yv + static_cast<size_t>(r0 + nstr) * cv;
    for_rows<UNROLL>(col, row_bytes, lane_r, res, rl, [&](int r, uint4 raw) {
      const uint4 v = apply_vec<T, RELU, V>(raw, kf, a, shift);
      if (streaming)
        __stcs(out + static_cast<size_t>(r) * cv, v);
      else
        out[static_cast<size_t>(r) * cv] = v;
    });
  }
  IN_MARK(6);
}

// The launch configuration of a kernel whose clusters are k blocks along
// x, asking for `smem` bytes of dynamic shared memory a block.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int k, dim3 grid, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (k > 8) {  // above 8 blocks a cluster is non-portable and has to be allowed
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(k);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t cluster_attributes(void (*kernel)(const T*, const float*, const float*, T*,
                                              ClusterPlan, float),
                               const ClusterPlan& p, cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& attr, int batch, cudaStream_t st) {
  return cluster_config(kernel, ClusterLayout(p, sizeof(T)).total, p.k,
                        dim3(static_cast<unsigned>(p.k), static_cast<unsigned>(batch)), cfg, attr,
                        st);
}

template <typename T, bool RELU>
cudaError_t cluster_launch(const void* x, const void* scale, const void* bias, void* y, int batch,
                           const ClusterPlan& p, float eps, cudaStream_t st) {
  const auto kernel = in_cluster_kernel<T, RELU>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_attributes<T>(kernel, p, cfg, attr, batch, st);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<T*>(y), p, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t cluster_occupancy(const ClusterPlan& p, int* clusters) {
  const auto kernel = in_cluster_kernel<T, true>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_attributes<T>(kernel, p, cfg, attr, 1, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// ---- instance_norm_bwd, route "cluster" ------------------------------------
//
// in_bwd_cluster_kernel: the backward in one launch (the design note at the
// backward's split route gives the formulas). One thread-block cluster of k
// <= 16 blocks covers an (image b, group of G channels); G is a power-of-two
// number of 16-byte vectors (the plan takes 64 or 32 bytes of a row, whole
// sectors), so that a style loop's single image still spreads over the card
// as B x ceil(C / G) x k blocks. Block `rank` owns the image's rows
// [r0, r0 + n) (HW / k rows, one more for the first HW % k blocks, as the
// forward splits them):
//   1. Each thread cp.async-copies its own 16-byte vectors of the block's
//      G-channel strips of x and dy (and y under ReLU) into shared memory,
//      every copy at once in LOAD_GROUPS commit groups, and reads back only
//      what it copied: no block barrier. Under ReLU it writes g = dy 1[y >
//      0] over dy (exact in x's type), so y is read once and never again.
//   2. Per channel, about the block's own mean u_b of u = x - K (K the
//      image's first row): sum u and sum g, each group as it lands, a block
//      sum, u_b; then M2 = sum (u - u_b)^2 and H = sum g (u - u_b): two
//      passes over shared memory, none over HBM. Block sums add a warp's
//      lanes by shuffles and the 8 warps in order.
//   3. The block's (sum u, M2, sum g, H), a float4 a channel, goes to slot
//      `rank` of every block of the cluster through distributed shared
//      memory (st.async, counted on the receiver's mbarrier). Every block
//      merges the k slots in rank order as in_bwd_finalize does (Chan's M2
//      and the cross term), so every block holds bit-identical dscale,
//      dbias and apply coefficients; rank 0 writes the (b, c) rows of
//      dscale and dbias. No atomics: the same result from run to run.
//   4. dx = a ((g - dbias / HW) - (u - ubar) r dscale / HW) from shared
//      memory, one 16-byte store a vector, in x's type.
// Traffic: one read of x, dy (and y), one write of dx, no workspace. Two
// cluster barriers, each arrive paired with its wait: the first orders every
// block's mbarrier init before any remote store; the second is arrived
// (relaxed) once a block's own mbarrier has completed and waited on before
// it exits, so that no block leaves while its stores into a peer are in
// flight. Bound on an H100: bytes, but at the style loop's b1 shapes (0.7-3
// MB a tensor) the chain of phases sets the time (tools/
// instance_norm_bwd_sweep.py marks them): the copies in at about the HBM
// rate, two block sums, the exchange, the apply.
// Needs C % (16 / sizeof(T)) == 0, 16-byte-aligned x, dy, dx (and y), k <=
// HW, and the block's strips within 227 KB of shared memory.

constexpr int MAX_BWD_GV = 32;  // 16-byte vectors a group: one warp's lanes at most

// What the wrapper's plan chose (ops/kernels/instance_norm.py _bwd_plan).
struct BwdClusterPlan {
  int hw, c;  // rows and channels of an image
  int g, k;   // channels of a group, blocks of its cluster
};

// in_bwd_cluster_kernel's dynamic shared memory as byte offsets
// (ops/kernels/instance_norm.py _bwd_smem mirrors it): the longest block's
// strips of x at 0, g and y (ReLU only), each [rows][G] in x's type; the
// exchange [k][G] float4; the block sums' partials [8 warps][2][G] f32; the
// apply's coefficients [4][G] f32; one mbarrier. `total` is what a block
// asks for.
struct BwdLayout {
  size_t g_off, y_off, recv, red, coef, bar, total;
  __host__ __device__ BwdLayout(const BwdClusterPlan& p, int elem, bool relu) {
    const size_t strip = static_cast<size_t>((p.hw + p.k - 1) / p.k) * p.g * elem;
    g_off = strip;
    y_off = 2 * strip;
    recv = (relu ? 3 : 2) * strip;
    red = recv + static_cast<size_t>(p.k) * p.g * 16;
    coef = red + 2 * 8 * static_cast<size_t>(p.g) * 4;
    bar = coef + 4 * static_cast<size_t>(p.g) * 4;
    total = bar + 8;
  }
};

bool bwd_plan_ok(const BwdClusterPlan& p, int elem, bool relu) {
  const int v = 16 / elem;
  const int gv = p.g / v;
  if (p.hw < 1 || p.c < v || p.c % v != 0 || p.g < v || p.g % v != 0 || gv > MAX_BWD_GV ||
      (gv & (gv - 1)) != 0 || p.k < 1 || p.k > MAX_CLUSTER || p.k > p.hw ||
      (p.c + p.g - 1) / p.g > 65535)
    return false;
  return BwdLayout(p, elem, relu).total <= MAX_SMEM;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

constexpr int LOAD_GROUPS = 4;  // cp.async groups a thread commits

// Waits until at most `pending` (< LOAD_GROUPS) of the thread's cp.async
// groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Per-channel block sums of two per-thread values (a, b: V channels from
// vector column `col` of gv), added in a fixed order: the lanes of a warp
// that share a column by shuffles, then each warp's partial into
// red[warp][2][G]; the caller adds the 8 rows in order after the barrier
// this ends with. Every thread of the block calls it, and a block barrier
// must come between the caller's reads of red and the next call.
template <int V>
__device__ __forceinline__ void block_sum2(float (&a)[V], float (&b)[V], int gv, int col,
                                          float* red, int g) {
  for (int off = gv; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < gv) {  // here lane == col
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[(2 * warp) * g + col * V + i] = a[i];
      red[(2 * warp + 1) * g + col * V + i] = b[i];
    }
  }
  __syncthreads();
}

// One cluster an (image, channel group): blockIdx.x is the block's rank in
// it, blockIdx.y the group, blockIdx.z the image; see the note above.
// Thread t takes vector column t % gv of the strip and its vectors t, t +
// 256, ... ([rows][gv] row-major), so a warp reads and writes whole 32-byte
// sectors of consecutive rows.
template <typename T, bool RELU>
__global__ void __launch_bounds__(CL_THREADS, 2)
in_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ dscale, float* __restrict__ dbias, BwdClusterPlan p,
                      float eps) {
  extern __shared__ __align__(128) uint8_t bw_smem[];
  constexpr int V = Group<T>::V;
  IN_MARK(0);
  const int tid = threadIdx.x;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int grp = blockIdx.y, b = blockIdx.z;
  const int c = p.c, g = p.g, gv = g / V;
  const BwdLayout L(p, sizeof(T), RELU);
  const int base = p.hw / p.k, extra = p.hw % p.k;
  const int r0 = static_cast<int>(rank) * base + min(static_cast<int>(rank), extra);
  const int n = base + (static_cast<int>(rank) < extra ? 1 : 0);
  const int c0 = grp * g;                   // the group's first channel
  const int gvn = min(gv, (c - c0) / V);    // its vectors: fewer in a partial last group
  const int col = tid % gv;                 // gv divides the block's 256 threads
  const int row_shift = __ffs(gv) - 1;      // vector j lies in row j >> row_shift
  const bool active = col < gvn;
  const int nvec = n * gv;
  const size_t img = static_cast<size_t>(b) * p.hw * c;
  const size_t first = img + static_cast<size_t>(r0) * c + c0 + col * V;  // (row r0, col)
  uint4* xs = reinterpret_cast<uint4*>(bw_smem);
  uint4* gs = reinterpret_cast<uint4*>(bw_smem + L.g_off);
  uint4* ys = reinterpret_cast<uint4*>(bw_smem + L.y_off);
  float4* recv = reinterpret_cast<float4*>(bw_smem + L.recv);  // [k][G]
  float* red = reinterpret_cast<float*>(bw_smem + L.red);       // [8][2][G]
  float* coef = reinterpret_cast<float*>(bw_smem + L.coef);     // [4][G]
  uint64_t* bar = reinterpret_cast<uint64_t*>(bw_smem + L.bar);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, static_cast<uint32_t>(p.k * g * 16));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's mbarrier is initialised before any remote store: arrive
  // now, wait just before the exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. the strips, every copy at once, in LOAD_GROUPS runs of the thread's
  // vectors j = tid + i x 256; a thread copies and reads its own
  const int per = active && tid < nvec ? (nvec - tid + CL_THREADS - 1) / CL_THREADS : 0;
  const int run = (per + LOAD_GROUPS - 1) / LOAD_GROUPS;
  for (int s = 0; s < LOAD_GROUPS; ++s) {
    for (int i = s * run; i < min(per, (s + 1) * run); ++i) {
      const int j = tid + i * CL_THREADS;
      const size_t off = first + static_cast<size_t>(j >> row_shift) * c;
      cp_async16(xs + j, x + off);
      cp_async16(gs + j, dy + off);
      if (RELU) cp_async16(ys + j, y + off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float kf[V];  // the shift K: the image's first row
  Group<T>::unpack(active ? __ldg(reinterpret_cast<const uint4*>(x + img + c0 + col * V))
                          : make_uint4(0u, 0u, 0u, 0u),
                   kf);
  const float sc = tid < g && c0 + tid < c ? __ldg(scale + static_cast<size_t>(b) * c + c0 + tid)
                                           : 0.f;

  // 2a. sum u and sum g (g written over dy under ReLU), each run as it lands
  float su[V], sg[V];
#pragma unroll
  for (int i = 0; i < V; ++i) su[i] = sg[i] = 0.f;
  for (int s = 0; s < LOAD_GROUPS; ++s) {
    cp_async_wait(LOAD_GROUPS - 1 - s);
    for (int i = s * run; i < min(per, (s + 1) * run); ++i) {
      const int j = tid + i * CL_THREADS;
      float u[V], gr[V];
      Group<T>::unpack(xs[j], u);
      Group<T>::unpack(gs[j], gr);
      if (RELU) {
        float yv[V];
        Group<T>::unpack(ys[j], yv);
#pragma unroll
        for (int v = 0; v < V; ++v) gr[v] = yv[v] > 0.f ? gr[v] : 0.f;
        gs[j] = Group<T>::pack(gr);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        su[v] += u[v] - kf[v];
        sg[v] += gr[v];
      }
    }
  }
  IN_MARK(1);
  block_sum2<V>(su, sg, gv, col, red, g);
  IN_MARK(2);
  float tot_u = 0.f, tot_g = 0.f;  // thread t < G: channel c0 + t's block sums
  if (tid < g) {
    for (int r = 0; r < 8; ++r) {
      tot_u += red[(2 * r) * g + tid];
      tot_g += red[(2 * r + 1) * g + tid];
    }
    coef[tid] = tot_u / static_cast<float>(n);  // u_b
  }
  __syncthreads();
  float mb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mb[i] = coef[col * V + i];

  // 2b. M2 and H about u_b
  float q[V], h[V];
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = h[i] = 0.f;
  if (active) {
#pragma unroll 4
    for (int j = tid; j < nvec; j += CL_THREADS) {
      float u[V], gr[V];
      Group<T>::unpack(xs[j], u);
      Group<T>::unpack(gs[j], gr);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = (u[i] - kf[i]) - mb[i];
        q[i] = fmaf(d, d, q[i]);
        h[i] = fmaf(gr[i], d, h[i]);
      }
    }
  }
  block_sum2<V>(q, h, gv, col, red, g);  // its barrier also orders the reads of coef above
  IN_MARK(3);

  // 3. the exchange and the merge, in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < g) {
    float m2 = 0.f, hs = 0.f;
    for (int r = 0; r < 8; ++r) {
      m2 += red[(2 * r) * g + tid];
      hs += red[(2 * r + 1) * g + tid];
    }
    push_slot(recv + rank * g + tid, bar, p.k, make_float4(tot_u, m2, tot_g, hs));
  }
  mbar_wait(bar, 0);  // every block's partials have reached this one
  IN_MARK(4);
  // no peer stores into this block any more (relaxed: an arrive with
  // release semantics cost about 1 us here, and nothing is published by it)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float inv_hw = 1.f / static_cast<float>(p.hw);
  if (tid < g) {
    const float4* slot = recv + tid;
    float s = 0.f;
#pragma unroll 4
    for (int r = 0; r < p.k; ++r) s += slot[r * g].x;
    const float ubar = s / static_cast<float>(p.hw);
    float m2 = 0.f, gsum = 0.f, hs = 0.f;
#pragma unroll 4
    for (int r = 0; r < p.k; ++r) {
      const float4 t = slot[r * g];
      const float n_r = static_cast<float>(base + (r < extra ? 1 : 0));
      const float d = t.x / n_r - ubar;
      m2 += t.y + n_r * d * d;
      gsum += t.z;
      hs += t.w + d * t.z;
    }
    const float rr = rsqrtf(m2 * inv_hw + eps);
    const float ds = rr * hs;
    coef[tid] = ubar;
    coef[g + tid] = sc * rr;
    coef[2 * g + tid] = rr * ds * inv_hw;
    coef[3 * g + tid] = gsum * inv_hw;
    if (rank == 0 && c0 + tid < c) {
      const size_t bc = static_cast<size_t>(b) * c + c0 + tid;
      dscale[bc] = ds;
      dbias[bc] = gsum;
    }
  }
  __syncthreads();
  IN_MARK(5);
  float ub[V], a[V], rds[V], db[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ub[i] = coef[col * V + i];
    a[i] = coef[g + col * V + i];
    rds[i] = coef[2 * g + col * V + i];
    db[i] = coef[3 * g + col * V + i];
  }

  // 4. the apply
  if (active) {
    uint4* out = reinterpret_cast<uint4*>(dx + first);
    const size_t pitch = c / V;  // 16-byte vectors a row
#pragma unroll 4
    for (int j = tid; j < nvec; j += CL_THREADS) {
      float u[V], gr[V];
      Group<T>::unpack(xs[j], u);
      Group<T>::unpack(gs[j], gr);
#pragma unroll
      for (int i = 0; i < V; ++i)
        u[i] = a[i] * ((gr[i] - db[i]) - ((u[i] - kf[i]) - ub[i]) * rds[i]);
      out[static_cast<size_t>(j >> row_shift) * pitch] = Group<T>::pack(u);
    }
  }
  IN_MARK(6);
  // 5. every peer has received this block's partials before it leaves
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, bool RELU>
cudaError_t bwd_cluster_config(const BwdClusterPlan& p, int batch, cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& attr, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.k), static_cast<unsigned>((p.c + p.g - 1) / p.g),
                  static_cast<unsigned>(batch));
  return cluster_config(in_bwd_cluster_kernel<T, RELU>, BwdLayout(p, sizeof(T), RELU).total, p.k,
                        grid, cfg, attr, st);
}

template <typename T, bool RELU>
cudaError_t bwd_cluster_launch(const void* x, const void* dy, const void* y, const void* scale,
                               void* dx, void* dscale, void* dbias, int batch,
                               const BwdClusterPlan& p, float eps, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_cluster_config<T, RELU>(p, batch, cfg, attr, st);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, in_bwd_cluster_kernel<T, RELU>, static_cast<const T*>(x),
                           static_cast<const T*>(dy), static_cast<const T*>(y),
                           static_cast<const float*>(scale), static_cast<T*>(dx),
                           static_cast<float*>(dscale), static_cast<float*>(dbias), p, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool RELU>
cudaError_t bwd_cluster_occupancy(const BwdClusterPlan& p, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_cluster_config<T, RELU>(p, 1, cfg, attr, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, in_bwd_cluster_kernel<T, RELU>, &cfg);
}

}  // namespace

extern "C" {

// Route "split". vec: 1 to read 16-byte vectors (C a multiple of 16 /
// sizeof(T), pointers 16-byte aligned), 0 for one channel per lane. cb, rl,
// splits and groups are the block geometry the wrapper computed
// (ops/kernels/instance_norm.py _geometry). dtype: 0 = float32, 1 = bfloat16.
int hst_instance_norm_split(const void* x, const void* scale, const void* bias, void* y, void* ws,
                            void* coef, int batch, int hw, int c, int cb, int rl, int splits,
                            int groups, float eps, int relu, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      return split_launch<float, 4>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits,
                                    groups, eps, relu, st);
    return split_launch<float, 1>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits,
                                  groups, eps, relu, st);
  }
  if (vec)
    return split_launch<__nv_bfloat16, 8>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl,
                                          splits, groups, eps, relu, st);
  return split_launch<__nv_bfloat16, 1>(x, scale, bias, y, ws, coef, batch, hw, c, cb, rl, splits,
                                        groups, eps, relu, st);
}

// instance_norm_bwd: dx (x's type), dscale and dbias ((B, C) f32) from x,
// dy (x's type) and, where relu, the forward's output y. ws is (B, splits,
// C) float4 scratch, coef (B, C, 2) float4. cb, rl, splits and groups are
// the split geometry of BWD_ITEMS rows a thread (ops/kernels/instance_norm.py
// _geometry); vec and dtype as for the split route.
int hst_instance_norm_bwd(const void* x, const void* dy, const void* y, const void* scale,
                          void* dx, void* dscale, void* dbias, void* ws, void* coef, int batch,
                          int hw, int c, int cb, int rl, int splits, int groups, float eps,
                          int relu, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu && y == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec)
      return bwd_dispatch<float, 4>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw, c,
                                    cb, rl, splits, groups, eps, relu, st);
    return bwd_dispatch<float, 1>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw, c, cb,
                                  rl, splits, groups, eps, relu, st);
  }
  if (vec)
    return bwd_dispatch<__nv_bfloat16, 8>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw,
                                          c, cb, rl, splits, groups, eps, relu, st);
  return bwd_dispatch<__nv_bfloat16, 1>(x, dy, y, scale, dx, dscale, dbias, ws, coef, batch, hw,
                                        c, cb, rl, splits, groups, eps, relu, st);
}

// Route "cluster": k blocks an image (a cluster), each keeping up to
// res_rows rows resident in chunks of chunk_rows and streaming the rest
// through `slots` stages of stage_rows, asking for at least min_smem bytes
// of shared memory. A plan the kernel cannot take (C % vector, C > 256,
// misaligned x or y, more than 16 chunks or 4 slots, shared memory over
// 227 KB) is refused with cudaErrorInvalidValue.
int hst_instance_norm_cluster(const void* x, const void* scale, const void* bias, void* y,
                              int batch, int hw, int c, int k, int res_rows, int chunk_rows,
                              int stage_rows, int slots, int min_smem, float eps, int relu,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ClusterPlan p{hw, c,       k,       res_rows,  chunk_rows,
                      stage_rows, slots, min_smem};
  const int elem = dtype == 0 ? 4 : 2;
  if (!cluster_plan_ok(p, elem) || batch < 1 || batch > 65535 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return relu ? cluster_launch<float, true>(x, scale, bias, y, batch, p, eps, st)
                : cluster_launch<float, false>(x, scale, bias, y, batch, p, eps, st);
  return relu ? cluster_launch<__nv_bfloat16, true>(x, scale, bias, y, batch, p, eps, st)
              : cluster_launch<__nv_bfloat16, false>(x, scale, bias, y, batch, p, eps, st);
}

// How many clusters of this plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters, and the plan's dynamic
// shared memory a block into *smem.
int hst_instance_norm_cluster_occupancy(int hw, int c, int k, int res_rows, int chunk_rows,
                                        int stage_rows, int slots, int min_smem, int dtype,
                                        int* clusters, int* smem) {
  const ClusterPlan p{hw, c,       k,       res_rows,  chunk_rows,
                      stage_rows, slots, min_smem};
  const int elem = dtype == 0 ? 4 : 2;
  if (!cluster_plan_ok(p, elem)) return cudaErrorInvalidValue;
  *smem = static_cast<int>(ClusterLayout(p, elem).total);
  return dtype == 0 ? cluster_occupancy<float>(p, clusters)
                    : cluster_occupancy<__nv_bfloat16>(p, clusters);
}

// instance_norm_bwd on route "cluster": one launch, a cluster of k blocks an
// (image, group of g channels). Arguments otherwise as
// hst_instance_norm_bwd's, without scratch. A plan the kernel cannot take
// (C % vector, g not a power-of-two number of vectors up to 32, k > HW,
// shared memory over 227 KB, misaligned x, dy, dx or y) is refused with
// cudaErrorInvalidValue, a refused launch with its own error.
int hst_instance_norm_bwd_cluster(const void* x, const void* dy, const void* y,
                                  const void* scale, void* dx, void* dscale, void* dbias,
                                  int batch, int hw, int c, int g, int k, float eps, int relu,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdClusterPlan p{hw, c, g, k};
  const int elem = dtype == 0 ? 4 : 2;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx) |
                         (relu ? reinterpret_cast<uintptr_t>(y) : 0);
  if (!bwd_plan_ok(p, elem, relu != 0) || batch < 1 || batch > 65535 || (addr & 15) != 0 ||
      (relu && y == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return relu ? bwd_cluster_launch<float, true>(x, dy, y, scale, dx, dscale, dbias, batch, p,
                                                  eps, st)
                : bwd_cluster_launch<float, false>(x, dy, y, scale, dx, dscale, dbias, batch, p,
                                                   eps, st);
  return relu ? bwd_cluster_launch<__nv_bfloat16, true>(x, dy, y, scale, dx, dscale, dbias, batch,
                                                        p, eps, st)
              : bwd_cluster_launch<__nv_bfloat16, false>(x, dy, y, scale, dx, dscale, dbias,
                                                         batch, p, eps, st);
}

// How many clusters of this backward plan's shape the card holds at once
// into *clusters, and the plan's dynamic shared memory a block into *smem.
int hst_instance_norm_bwd_cluster_occupancy(int hw, int c, int g, int k, int relu, int dtype,
                                            int* clusters, int* smem) {
  const BwdClusterPlan p{hw, c, g, k};
  const int elem = dtype == 0 ? 4 : 2;
  if (!bwd_plan_ok(p, elem, relu != 0)) return cudaErrorInvalidValue;
  *smem = static_cast<int>(BwdLayout(p, elem, relu != 0).total);
  if (dtype == 0)
    return relu ? bwd_cluster_occupancy<float, true>(p, clusters)
                : bwd_cluster_occupancy<float, false>(p, clusters);
  return relu ? bwd_cluster_occupancy<__nv_bfloat16, true>(p, clusters)
              : bwd_cluster_occupancy<__nv_bfloat16, false>(p, clusters);
}


// The banded entry points (see "the banded entry points" above). cb, rl,
// splits and groups are the split geometry of the band (ITEMS rows a
// thread for stats and apply, BWD_ITEMS for the backward); vec and dtype
// as for the split route. stats is (B, C, 3) f32, coef (B, C) float4,
// sums and the reduce's out (B, C) float2, ws the split route's scratch
// ((B, splits, C) float2).
int hst_instance_norm_band_stats(const void* x, void* ws, void* stats, int batch, int hw, int c,
                                 int cb, int rl, int splits, int groups, int vec, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HST_BAND_DISPATCH(band_stats_launch, x, ws, stats, batch, hw, c, cb, rl, splits, groups, st);
}

int hst_instance_norm_band_apply(const void* x, const void* coef, void* y, int batch, int hw,
                                 int c, int cb, int rl, int splits, int groups, int relu, int vec,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HST_BAND_DISPATCH(band_apply_launch, x, coef, y, batch, hw, c, cb, rl, splits, groups, relu,
                    st);
}

int hst_instance_norm_band_bwd_reduce(const void* x, const void* dy, const void* y,
                                      const void* coef, void* ws, void* out, int batch, int hw,
                                      int c, int cb, int rl, int splits, int groups, int relu,
                                      int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu && y == nullptr) return cudaErrorInvalidValue;
  HST_BAND_DISPATCH(band_bwd_reduce_relu, x, dy, y, coef, ws, out, batch, hw, c, cb, rl, splits,
                    groups, relu, st);
}

int hst_instance_norm_band_bwd_apply(const void* x, const void* dy, const void* y,
                                     const void* coef, const void* sums, void* dx, int batch,
                                     int hw, int c, int cb, int rl, int splits, int groups,
                                     int relu, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu && y == nullptr) return cudaErrorInvalidValue;
  HST_BAND_DISPATCH(band_bwd_apply_relu, x, dy, y, coef, sums, dx, batch, hw, c, cb, rl, splits,
                    groups, relu, st);
}

}  // extern "C"

#ifdef IN_PHASE_TRACE
// The phase marks of the last launches: n entries of each array.
extern "C" int hst_instance_norm_phase_marks(void* clocks, void* times, int n) {
  const size_t bytes = n * sizeof(unsigned long long);
  const cudaError_t err = cudaMemcpyFromSymbol(clocks, in_phase_clock, bytes);
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(times, in_phase_time, bytes);
}
#endif
