// The UNet's batch norm + ReLU on channels-last activations: the forward in
// train and eval mode, the backward in train mode.
//
// Replaces no Pallas kernel. The JAX package leaves batch norm to XLA,
// which fuses the statistics, the normalisation and the ReLU into the
// convolutions' neighbours. The port's library route ran it as cuDNN's
// float32 NCHW batch norm on a float32 copy of every bfloat16 conv output,
// with casts, scratch fills and running-statistics updates around it and
// layout transposes around every conv: ~400 of the ~675 busy ms of a D=96
// training step (PERF.md).
//
// What it computes, for the rows r of y viewed as (R = N*H*W, C) with the
// channels contiguous (NHWC), per channel c:
//   train: mean, var (biased) over the rows; inside a data group over every
//          rank's rows (the wrapper combines the ranks' partial moments)
//   eval:  mean, var = the running statistics
//   scale = w * rsqrt(var + eps), shift = b - mean * scale
//   z = relu(y * scale + shift)          (float32, then rounded to y's type)
// and in train mode running = (1 - momentum) * running + momentum * batch,
// with the biased batch variance (flax's rule), and num_batches_tracked + 1.
// The backward, with g = dz where z > 0 (else 0) and xhat = (y - mean) *
// rsqrt(var + eps):
//   dbias = sum_r g, dweight = sum_r g * xhat      (this rank's rows)
//   dx = scale * (g - Sg / n - xhat * Sgx / n)     (Sg, Sgx and n over the
//                                                   group's rows)
// An eval-mode norm has no backward here: nothing trains a frozen UNet.
// The ReLU's mask is recomputed from y exactly as the forward rounded z, so
// nothing but y and four floats a channel are kept for the backward.
//
// Precision. Everything is float32 arithmetic on values read from bfloat16
// (or float32). The statistics are not a one-pass E[x^2] - E[x]^2: each
// thread keeps Welford's (count, mean, M2) over its rows, a block merges
// its threads' by Chan's formula in a fixed tree, and the finalise step
// merges the blocks' partials in float64, in a fixed order. The backward's
// sums are float32 within a block and float64 across blocks. No atomics:
// every result is bitwise repeatable.
//
// Bound. Bytes: 4-8 operations an element against the card's ~295 per
// byte. A train-mode pair reads y three times and writes z once in the
// forward (statistics; apply), and reads dz and y twice and writes dx once
// in the backward (sums; dx): 8 passes of the activation. Eval is 2.
//
// Design. Four row kernels share one layout: a block of 256 threads is a
// grid of (row lanes x packs), a pack being 16 bytes of channels (8
// bfloat16 or 4 float values, one vector load) where C allows, else one
// value. Consecutive threads read consecutive packs of a row, so a warp
// reads whole rows; each thread walks rows with a stride of the grid's row
// lanes, four loads in flight, and keeps its pack's per-channel constants
// in registers. The grid is one wave of resident blocks (fewer for small
// tensors), so at every UNet shape, from 96x400x512x32 down to 64x2x8x512
// crops, the statistics come in at most ~1,000 partials a channel. Two small
// merge kernels (one warp a 32 channels, eight warps over the partials)
// finish the statistics and the backward's sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // rows a thread has in flight
constexpr int kRowsPerThread = 8; // at least, before the grid grows
constexpr int kMaxEntries = 256;  // (kernel, device) occupancy cache

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T: one 16-byte access where V * sizeof(T) == 16
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<Pack<T, V>*>(&raw);
  } else {
    Pack<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = p[i];
    return out;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& val) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&val);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = val.v[i];
  }
}

// z as the forward rounds it, from y and the channel's scale and shift
template <typename T>
__device__ __forceinline__ T relu_affine(float x, float scale, float shift) {
  return from_f<T>(fmaxf(fmaf(x, scale, shift), 0.f));
}

// The row kernels' layout: thread -> (row lane, pack); block (x, y) ->
// (x-th share of the rows, y-th slice of `cols` packs)
struct Lanes {
  int cols, rowlanes, rl, c0;
  bool active;
  int64_t first, step;
};

template <int V>
__device__ __forceinline__ Lanes lanes(int C) {
  const int packs = C / V;
  Lanes L;
  L.cols = min(packs, kThreads);
  L.rowlanes = kThreads / L.cols;
  L.rl = threadIdx.x / L.cols;
  const int pack = blockIdx.y * L.cols + threadIdx.x % L.cols;
  L.c0 = pack * V;
  L.active = L.rl < L.rowlanes && pack < packs;
  L.first = L.rl + (int64_t)L.rowlanes * blockIdx.x;
  L.step = (int64_t)L.rowlanes * gridDim.x;
  return L;
}

// Each row of a thread's share, kUnroll loads in flight: fn(u, r) with u
// the slot loaded by load_fn(u, r).
template <typename Load, typename Use>
__device__ __forceinline__ void walk_rows(const Lanes& L, int64_t rows,
                                          Load load_fn, Use use_fn) {
  for (int64_t r0 = L.first; r0 < rows; r0 += L.step * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * L.step;
      if (r < rows) load_fn(u, r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * L.step;
      if (r < rows) use_fn(u, r);
    }
  }
}

// ---------------------------------------------------------------- forward

// Welford's (count, mean, M2) of each channel over a block's rows ->
// part[block] = (mean[C], M2[C]) and counts[block].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ y, int64_t rows, int C,
                float* __restrict__ part, double* __restrict__ counts) {
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[V][kThreads];
  __shared__ float s_m2[V][kThreads];
  const Lanes L = lanes<V>(C);
  const int t = threadIdx.x;
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  if (L.active) {
    Pack<T, V> buf[kUnroll];
    walk_rows(
        L, rows,
        [&](int u, int64_t r) { buf[u] = load<T, V>(y + r * C + L.c0); },
        [&](int u, int64_t) {
          n += 1.f;
          const float inv = __frcp_rn(n);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float x = to_f(buf[u].v[i]);
            const float d = x - mean[i];
            mean[i] = fmaf(d, inv, mean[i]);
            m2[i] = fmaf(d, x - mean[i], m2[i]);
          }
        });
  }
  s_n[t] = n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_mean[i][t] = mean[i];
    s_m2[i][t] = m2[i];
  }
  __syncthreads();
  // a fixed tree over the row lanes of each pack: at level s, lane rl (a
  // multiple of 2s) takes in lane rl + s
  for (int s = 1; s < L.rowlanes; s <<= 1) {
    if (L.active && L.rl % (2 * s) == 0 && L.rl + s < L.rowlanes) {
      const int o = t + s * L.cols;
      const float nb = s_n[o];
      if (nb > 0.f) {
        const float na = n, nn = na + nb, f = nb / nn;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = s_mean[i][o] - mean[i];
          mean[i] = fmaf(d, f, mean[i]);
          m2[i] += s_m2[i][o] + d * d * na * f;
        }
        n = nn;
        s_n[t] = n;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s_mean[i][t] = mean[i];
          s_m2[i][t] = m2[i];
        }
      }
    }
    __syncthreads();
  }
  if (L.active && L.rl == 0) {
    float* p = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[L.c0 + i] = mean[i];
      p[C + L.c0 + i] = m2[i];
    }
    if (blockIdx.y == 0 && t == 0) counts[blockIdx.x] = (double)n;
  }
}

// Chan's merge of P partials (mean, M2 and a count each), one warp per
// stride of partials and one lane per channel, then the warps in order.
// With `stat`: stat = (mean, invstd, scale, shift)[C] and, where `tracked`
// is given, the running statistics moved and `tracked` counted. P == 0
// takes mean and var from the running statistics (eval). With `merged`:
// merged = (mean, M2)[C] of all P partials.
__global__ void __launch_bounds__(kThreads)
bn_finalise_kernel(const float* __restrict__ part,
                   const double* __restrict__ counts, int P, int C,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float eps, float momentum,
                   float* running_mean, float* running_var, int64_t* tracked,
                   float* __restrict__ merged, float* __restrict__ stat) {
  __shared__ double s_n[kWarps][32], s_mean[kWarps][32], s_m2[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  if (c < C) {
    for (int p = warp; p < P; p += kWarps) {
      const double nb = counts[p];
      if (nb > 0.0) {
        const double mb = part[(size_t)p * 2 * C + c];
        const double mb2 = part[(size_t)p * 2 * C + C + c];
        const double nn = n + nb, f = nb / nn, d = mb - mean;
        mean += d * f;
        m2 += mb2 + d * d * n * f;
        n = nn;
      }
    }
  }
  s_n[warp][lane] = n;
  s_mean[warp][lane] = mean;
  s_m2[warp][lane] = m2;
  __syncthreads();
  if (warp != 0 || c >= C) return;
  for (int k = 1; k < kWarps; ++k) {
    const double nb = s_n[k][lane];
    if (nb > 0.0) {
      const double nn = n + nb, f = nb / nn, d = s_mean[k][lane] - mean;
      mean += d * f;
      m2 += s_m2[k][lane] + d * d * n * f;
      n = nn;
    }
  }
  if (merged != nullptr) {
    merged[c] = (float)mean;
    merged[C + c] = (float)m2;
  }
  if (stat == nullptr) return;
  double var;
  float meanf;
  if (P == 0) {
    meanf = running_mean[c];
    var = (double)running_var[c];
  } else {
    meanf = (float)mean;
    var = m2 / n;
  }
  const float invstd = (float)(1.0 / sqrt(var + (double)eps));
  const float scale = weight[c] * invstd;
  stat[c] = meanf;
  stat[C + c] = invstd;
  stat[2 * C + c] = scale;
  stat[3 * C + c] = bias[c] - meanf * scale;
  if (P > 0 && tracked != nullptr) {
    running_mean[c] =
        fmaf(momentum, meanf, running_mean[c] * (1.f - momentum));
    running_var[c] =
        fmaf(momentum, (float)var, running_var[c] * (1.f - momentum));
    if (c == 0) *tracked += 1;
  }
}

// z = relu(y * scale + shift), rounded to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ y, int64_t rows, int C,
                const float* __restrict__ stat, T* __restrict__ z) {
  const Lanes L = lanes<V>(C);
  if (!L.active) return;
  float scale[V], shift[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = stat[2 * C + L.c0 + i];
    shift[i] = stat[3 * C + L.c0 + i];
  }
  Pack<T, V> buf[kUnroll];
  walk_rows(
      L, rows,
      [&](int u, int64_t r) { buf[u] = load<T, V>(y + r * C + L.c0); },
      [&](int u, int64_t r) {
        Pack<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i)
          out.v[i] = relu_affine<T>(to_f(buf[u].v[i]), scale[i], shift[i]);
        store<T, V>(z + r * C + L.c0, out);
      });
}

// --------------------------------------------------------------- backward

// Per block: (sum g, sum g * xhat)[C] -> part[block]
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ dz, const T* __restrict__ y,
                     int64_t rows, int C, const float* __restrict__ stat,
                     float* __restrict__ part) {
  __shared__ float s_g[V][kThreads];
  __shared__ float s_gx[V][kThreads];
  const Lanes L = lanes<V>(C);
  const int t = threadIdx.x;
  float sg[V], sgx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.f;
  if (L.active) {
    float mean[V], invstd[V], scale[V], shift[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = stat[L.c0 + i];
      invstd[i] = stat[C + L.c0 + i];
      scale[i] = stat[2 * C + L.c0 + i];
      shift[i] = stat[3 * C + L.c0 + i];
    }
    Pack<T, V> bd[kUnroll], by[kUnroll];
    walk_rows(
        L, rows,
        [&](int u, int64_t r) {
          bd[u] = load<T, V>(dz + r * C + L.c0);
          by[u] = load<T, V>(y + r * C + L.c0);
        },
        [&](int u, int64_t) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float x = to_f(by[u].v[i]);
            const bool on = to_f(relu_affine<T>(x, scale[i], shift[i])) > 0.f;
            const float g = on ? to_f(bd[u].v[i]) : 0.f;
            sg[i] += g;
            sgx[i] = fmaf(g, (x - mean[i]) * invstd[i], sgx[i]);
          }
        });
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_g[i][t] = sg[i];
    s_gx[i][t] = sgx[i];
  }
  __syncthreads();
  for (int s = 1; s < L.rowlanes; s <<= 1) {
    if (L.active && L.rl % (2 * s) == 0 && L.rl + s < L.rowlanes) {
      const int o = t + s * L.cols;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sg[i] += s_g[i][o];
        sgx[i] += s_gx[i][o];
        s_g[i][t] = sg[i];
        s_gx[i][t] = sgx[i];
      }
    }
    __syncthreads();
  }
  if (L.active && L.rl == 0) {
    float* p = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[L.c0 + i] = sg[i];
      p[C + L.c0 + i] = sgx[i];
    }
  }
}

// sums = (sum g, sum g * xhat)[C] over P partials, in float64, in order
__global__ void __launch_bounds__(kThreads)
bn_sum_kernel(const float* __restrict__ part, int P, int C,
              float* __restrict__ sums) {
  __shared__ double s_a[kWarps][32], s_b[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int p = warp; p < P; p += kWarps) {
      a += part[(size_t)p * 2 * C + c];
      b += part[(size_t)p * 2 * C + C + c];
    }
  }
  s_a[warp][lane] = a;
  s_b[warp][lane] = b;
  __syncthreads();
  if (warp != 0 || c >= C) return;
  for (int k = 1; k < kWarps; ++k) {
    a += s_a[k][lane];
    b += s_b[k][lane];
  }
  sums[c] = (float)a;
  sums[C + c] = (float)b;
}

// dx = scale * (g - Sg / n - (y - mean) * invstd * Sgx / n)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ dz, const T* __restrict__ y, int64_t rows,
             int C, const float* __restrict__ stat,
             const float* __restrict__ sums, double n, T* __restrict__ dx) {
  const Lanes L = lanes<V>(C);
  if (!L.active) return;
  float mean[V], scale[V], shift[V], k1[V], k2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = L.c0 + i;
    mean[i] = stat[c];
    scale[i] = stat[2 * C + c];
    shift[i] = stat[3 * C + c];
    k1[i] = (float)((double)sums[c] / n);
    k2[i] = stat[C + c] * (float)((double)sums[C + c] / n);
  }
  Pack<T, V> bd[kUnroll], by[kUnroll];
  walk_rows(
      L, rows,
      [&](int u, int64_t r) {
        bd[u] = load<T, V>(dz + r * C + L.c0);
        by[u] = load<T, V>(y + r * C + L.c0);
      },
      [&](int u, int64_t r) {
        Pack<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x = to_f(by[u].v[i]);
          const bool on = to_f(relu_affine<T>(x, scale[i], shift[i])) > 0.f;
          const float g = on ? to_f(bd[u].v[i]) : 0.f;
          out.v[i] = from_f<T>(scale[i] * (g - k1[i] - (x - mean[i]) * k2[i]));
        }
        store<T, V>(dx + r * C + L.c0, out);
      });
}

// ------------------------------------------------------------------ host

template <typename T>
constexpr int pack_of() {
  return 16 / (int)sizeof(T);
}

template <typename T>
int vec_of(int C) {
  return C % pack_of<T>() == 0 ? pack_of<T>() : 1;
}

// Blocks of `kernel` resident at once on the current device (cached per
// kernel and device: the occupancy query costs microseconds a call)
int resident_blocks(const void* kernel, int* out) {
  struct Entry {
    const void* kernel;
    int dev, blocks;
  };
  static Entry cache[kMaxEntries];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev) {
      *out = cache[i].blocks;
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (used < kMaxEntries) cache[used++] = Entry{kernel, dev, *out};
  return 0;
}

// (blocks along the rows, slices of packs) of a row kernel: one wave of
// resident blocks, fewer where a thread would get under kRowsPerThread rows
int row_grid(const void* kernel, int64_t rows, int C, int V, dim3* grid) {
  int resident = 0;
  const int rc = resident_blocks(kernel, &resident);
  if (rc) return rc;
  const int packs = C / V;
  const int cols = packs < kThreads ? packs : kThreads;
  const int rowlanes = kThreads / cols;
  const int slices = (packs + cols - 1) / cols;
  int64_t blocks = (rows + (int64_t)rowlanes * kRowsPerThread - 1) /
                   ((int64_t)rowlanes * kRowsPerThread);
  int64_t wave = resident / slices;
  if (wave < 1) wave = 1;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  *grid = dim3((unsigned)blocks, (unsigned)slices, 1);
  return 0;
}

int finish() { return (int)cudaGetLastError(); }

bool bad(int64_t rows, int C, int dtype) {
  return rows < 1 || C < 1 || (dtype != 0 && dtype != 1);
}

bool aligned(int V, int size, const void* p) {
  return V * size != 16 || ((uintptr_t)p & 15) == 0;
}

template <typename T>
int stats(const void* y, int64_t rows, int C, float* part, double* counts,
          int* parts, cudaStream_t stream) {
  const int V = vec_of<T>(C);
  if (!aligned(V, sizeof(T), y)) return (int)cudaErrorMisalignedAddress;
  dim3 grid;
  int rc;
  if (V == 1) {
    rc = row_grid((const void*)bn_stats_kernel<T, 1>, rows, C, V, &grid);
    if (rc) return rc;
    bn_stats_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)y, rows, C, part, counts);
  } else {
    rc = row_grid((const void*)bn_stats_kernel<T, pack_of<T>()>, rows, C, V,
                  &grid);
    if (rc) return rc;
    bn_stats_kernel<T, pack_of<T>()><<<grid, kThreads, 0, stream>>>(
        (const T*)y, rows, C, part, counts);
  }
  *parts = (int)grid.x;
  return finish();
}

template <typename T>
int apply(const void* y, int64_t rows, int C, const float* stat, void* z,
          cudaStream_t stream) {
  const int V = vec_of<T>(C);
  if (!aligned(V, sizeof(T), y) || !aligned(V, sizeof(T), z))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid;
  int rc;
  if (V == 1) {
    rc = row_grid((const void*)bn_apply_kernel<T, 1>, rows, C, V, &grid);
    if (rc) return rc;
    bn_apply_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)y, rows, C, stat, (T*)z);
  } else {
    rc = row_grid((const void*)bn_apply_kernel<T, pack_of<T>()>, rows, C, V,
                  &grid);
    if (rc) return rc;
    bn_apply_kernel<T, pack_of<T>()><<<grid, kThreads, 0, stream>>>(
        (const T*)y, rows, C, stat, (T*)z);
  }
  return finish();
}

template <typename T>
int bwd_reduce(const void* dz, const void* y, int64_t rows, int C,
               const float* stat, float* part, int* parts,
               cudaStream_t stream) {
  const int V = vec_of<T>(C);
  if (!aligned(V, sizeof(T), dz) || !aligned(V, sizeof(T), y))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid;
  int rc;
  if (V == 1) {
    rc = row_grid((const void*)bn_bwd_reduce_kernel<T, 1>, rows, C, V, &grid);
    if (rc) return rc;
    bn_bwd_reduce_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)dz, (const T*)y, rows, C, stat, part);
  } else {
    rc = row_grid((const void*)bn_bwd_reduce_kernel<T, pack_of<T>()>, rows,
                  C, V, &grid);
    if (rc) return rc;
    bn_bwd_reduce_kernel<T, pack_of<T>()><<<grid, kThreads, 0, stream>>>(
        (const T*)dz, (const T*)y, rows, C, stat, part);
  }
  *parts = (int)grid.x;
  return finish();
}

template <typename T>
int dx_pass(const void* dz, const void* y, int64_t rows, int C,
            const float* stat, const float* sums, double n, void* dx,
            cudaStream_t stream) {
  const int V = vec_of<T>(C);
  if (!aligned(V, sizeof(T), dz) || !aligned(V, sizeof(T), y) ||
      !aligned(V, sizeof(T), dx))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid;
  int rc;
  if (V == 1) {
    rc = row_grid((const void*)bn_dx_kernel<T, 1>, rows, C, V, &grid);
    if (rc) return rc;
    bn_dx_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)dz, (const T*)y, rows, C, stat, sums, n, (T*)dx);
  } else {
    rc = row_grid((const void*)bn_dx_kernel<T, pack_of<T>()>, rows, C, V,
                  &grid);
    if (rc) return rc;
    bn_dx_kernel<T, pack_of<T>()><<<grid, kThreads, 0, stream>>>(
        (const T*)dz, (const T*)y, rows, C, stat, sums, n, (T*)dx);
  }
  return finish();
}

}  // namespace

// The most partials a statistics or backward-sums launch writes, for any
// shape: part holds (this, 2, C) floats and counts this many doubles.
extern "C" int qea_bn_max_parts() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return sms * (2048 / kThreads);
}

// Statistics of y (rows, C), channels contiguous, dtype 0 bfloat16 or 1
// float32: part (P, 2, C) floats of (mean, M2), counts (P) doubles; *parts
// gets P.
extern "C" int qea_bn_stats(const void* y, int64_t rows, int C, int dtype,
                            float* part, double* counts, int* parts,
                            cudaStream_t stream) {
  if (bad(rows, C, dtype)) return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? stats<bf16>(y, rows, C, part, counts, parts, stream)
             : stats<float>(y, rows, C, part, counts, parts, stream);
}

// The merge of P partials into stat (4, C) = (mean, invstd, scale, shift)
// and, with tracked, the moved running statistics; P == 0 reads the
// running statistics (eval) and moves nothing. merged (2, C) = (mean, M2)
// of the partials where given; stat may then be null.
extern "C" int qea_bn_finalise(const float* part, const double* counts, int P,
                               int C, const float* weight, const float* bias,
                               float eps, float momentum, float* running_mean,
                               float* running_var, int64_t* tracked,
                               float* merged, float* stat,
                               cudaStream_t stream) {
  const bool no_running = running_mean == nullptr || running_var == nullptr;
  if (P < 0 || C < 1 || (P == 0 && (stat == nullptr || no_running)) ||
      (tracked != nullptr && (stat == nullptr || no_running)) ||
      (stat != nullptr && (weight == nullptr || bias == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + 31) / 32;
  bn_finalise_kernel<<<blocks, kThreads, 0, stream>>>(
      part, counts, P, C, weight, bias, eps, momentum, running_mean,
      running_var, tracked, merged, stat);
  return finish();
}

// z (rows, C) = relu(y * scale + shift) in y's dtype
extern "C" int qea_bn_apply(const void* y, int64_t rows, int C, int dtype,
                            const float* stat, void* z, cudaStream_t stream) {
  if (bad(rows, C, dtype)) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? apply<bf16>(y, rows, C, stat, z, stream)
                    : apply<float>(y, rows, C, stat, z, stream);
}

// The backward's partial sums: part (P, 2, C) of (sum g, sum g * xhat);
// *parts gets P
extern "C" int qea_bn_bwd_reduce(const void* dz, const void* y, int64_t rows,
                                 int C, int dtype, const float* stat,
                                 float* part, int* parts,
                                 cudaStream_t stream) {
  if (bad(rows, C, dtype)) return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? bwd_reduce<bf16>(dz, y, rows, C, stat, part, parts, stream)
             : bwd_reduce<float>(dz, y, rows, C, stat, part, parts, stream);
}

// sums (2, C) = the P partials added up
extern "C" int qea_bn_sum(const float* part, int P, int C, float* sums,
                          cudaStream_t stream) {
  if (P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  bn_sum_kernel<<<(C + 31) / 32, kThreads, 0, stream>>>(part, P, C, sums);
  return finish();
}

// dx (rows, C) in y's dtype; sums (2, C) over n rows
extern "C" int qea_bn_dx(const void* dz, const void* y, int64_t rows, int C,
                         int dtype, const float* stat, const float* sums,
                         double n, void* dx, cudaStream_t stream) {
  if (bad(rows, C, dtype) || sums == nullptr || !(n > 0.0))
    return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? dx_pass<bf16>(dz, y, rows, C, stat, sums, n, dx, stream)
             : dx_pass<float>(dz, y, rows, C, stat, sums, n, dx, stream);
}

extern "C" const char* qea_bn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
