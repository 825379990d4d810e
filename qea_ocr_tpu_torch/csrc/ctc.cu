// CTC loss, both recursions: the forward (alpha) kernel gives each row's
// negative log-likelihood of its labels under time-major log-probabilities,
// the backward (beta) kernel its gradient with respect to the log-probs.
//
// Replaces: qea_ocr_tpu/ops/pallas/ctc_pallas.py `_forward_kernel` and
// `_backward_kernel` (TPU), together with the label preparation around them
// (`_prep`, `_extend_labels`), the 1e5 clamp of `_ctc_fwd_impl` and the
// upstream scaling and one-hot scatter to the vocabulary of `_ctc_vjp_bwd`.
//
// Semantics kept from the TPU kernels:
//   * labels equal to pad_id count as blank;
//   * extended labels z are blank-interleaved, S = 2L+1;
//   * the skip transition s-2 -> s is allowed iff s >= 2, z[s] != blank
//     and z[s] != z[s-2];
//   * alpha[0, s] = E[0, s] for s < 2, and "-inf" (the surrogate -1e30)
//     elsewhere; log-sum-exp of three terms returns -1e30 when all three are
//     below -5e29;
//   * NLL = -LSE(alpha[T-1, elen-1], alpha[T-1, elen-2]) with
//     elen = 2*len+1, so a zero-length label scores -sum_t log p(blank);
//   * an infeasible row (no alignment fits in T steps) ends at the -1e30
//     surrogate and is clamped to exactly 1e5;
//   * beta[T-1, s] = 0 at s = elen-1, elen-2 and "-inf" elsewhere;
//     beta[t, s] = LSE(c[s], c[s+1], c[s+2] if skip[s+2]) with
//     c = beta[t+1] + E[t+1], masked to s < elen;
//   * d nll / d log_probs[t, b, v] = -sum_{s: z[s] = v} exp(alpha[t, s] +
//     beta[t, s] - logZ), times the upstream gradient g[b];
//   * a row clamped to 1e5 has gradient exactly 0 (the clamp passes none,
//     and its beta is all "-inf" anyway), and nothing is ever NaN.
// Beyond the TPU kernels: a label outside [0, V) that is not pad_id gets an
// emission of -1e30 instead of being read out of bounds, and a length
// outside [0, L] scores 1e5 with gradient 0.
//
// Bound: the T-step serial dependency, not bytes or FLOPs. Each step is one
// log-sum-exp per extended position (3 expf + 1 logf) and one scattered
// 4-byte emission load. At T=31, S=201 and B=128 the forward reads about
// 1.5 MB of log-probs and the backward writes as much, so each is a chain of
// 31 short latency-bound steps.
//
// Forward design: one block per batch row, one thread per extended
// position (S is rounded up to a whole number of warps; at most 1024, so
// L <= 511). The recursion's state lives in shared memory, double-buffered,
// so each step needs exactly one __syncthreads: step t reads buffer t%2 and
// writes buffer (t+1)%2. Each thread keeps its own z[s] and skip flag in
// registers and reads its emission log_probs[t, b, z[s]] directly; the TPU
// kernel's one-hot einsum was a workaround for the TPU's weak gathers.
// expf/logf are the accurate library functions (no fast-math intrinsics),
// in both kernels.
//
// alpha for the backward: when a gradient is wanted the forward also writes
// alpha, as (B, T, S) float32, and the backward reads it. Recomputing it in
// the backward instead would double that kernel's serial chain (62 dependent
// steps for 31), while the write is one coalesced S-float store per step
// that nothing waits for (38 MB at B=1536). Without a gradient the pointer
// is null and nothing is written.
//
// Backward design. Only a band of positions can matter: a row the forward
// did not clamp has an alignment in T steps, so len <= T and every s that
// beta can reach lies below elen <= min(S, 2T+1) (63 at T=31, against
// S=201); a clamped row's gradient is 0 and its block stores zeros and
// stops. So a block takes one row with one thread per position of that
// band (64 threads at T=31, two warps), and the chain of T steps has one
// __syncthreads each on the double-buffered c = beta + E. What it keeps off
// the chain:
//   * global memory. Before the chain each thread issues all T of its alpha
//     reads (coalesced across threads) and all T of its emission reads (a
//     gather inside one 380-byte row of log-probs) as cp.async copies into
//     shared memory, in flight together and holding no registers; a thread
//     reads back only its own column. No step waits on device memory, and
//     only the band's alpha is read.
//   * the gradient. A step adds its beta into its alpha in shared memory;
//     the T terms exp(alpha + beta - logZ) are taken after the chain.
//   * the scatter to the vocabulary. The row's whole (T, V) gradient sits in
//     shared memory (11.8 KB at T=31, V=95) and goes to device memory once,
//     after the last barrier. The blank's terms (even s) are summed for each
//     step by one thread, in position order; each symbol's first position
//     in the label (found while the copies land) sums the terms of all its
//     positions, in label order, into its slot, so each slot has one writer.
// No atomics: every sum is taken in a fixed order, and the result is
// bitwise repeatable; against the plain version (one scatter_add) it
// differs by float32 rounding of that order.
//
// Tried on the way, and slower on the card (PERF.md): all T loads held in
// registers over the full S with fully unrolled steps (about 100 registers,
// two blocks an SM: slower than the first port at large B); the same from
// shared memory with rolled steps; one warp a row over the band with two
// positions a lane (the two positions of a step run one after the other).
// What is left is the chain itself: one accurate three-way log-sum-exp, a
// shared round trip and a barrier a step, as in the forward.
//
// Hopper's own units do not apply. There is no matrix product, so wgmma has
// nothing to do. TMA wants 16-byte-aligned starts and strides: a row of
// log-probs is 380 bytes at a stride of B*380, and a row's alpha block
// (T*S floats, 24,924 bytes at T=31, L=100) is not a multiple of 16 either;
// a TMA copy from a start that is not 16-byte aligned is an illegal
// instruction on this card. cp.async (4 bytes a copy) takes any alignment.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kClamp = 1e5f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  if (!(m > 0.5f * kNeg)) return kNeg;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ int label_at(const int* row, int k, int pad_id,
                                        int blank) {
  const int v = row[k];
  return v == pad_id ? blank : v;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ lengths,
                                 float* __restrict__ nll,
                                 float* __restrict__ alpha_out, int T, int B,
                                 int V, int L, int pad_id, int blank) {
  extern __shared__ float alpha[];  // 2 * blockDim.x floats
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int S = 2 * L + 1;
  const bool active = s < S;
  const int* row = labels + (size_t)b * L;

  int z = blank;
  bool skip = false;
  if (active && (s & 1)) {
    const int k = s >> 1;
    z = label_at(row, k, pad_id, blank);
    if (k >= 1) {
      skip = z != blank && z != label_at(row, k - 1, pad_id, blank);
    }
  }
  const bool z_ok = z >= 0 && z < V;
  const float* lp = log_probs + (size_t)b * V + z;
  const size_t t_stride = (size_t)B * V;

  float* cur = alpha;
  float* nxt = alpha + blockDim.x;
  // alpha_out is (B, T, S); null when no gradient is wanted
  float* a_out = alpha_out ? alpha_out + (size_t)b * T * S + s : nullptr;
  if (active) {
    cur[s] = (s < 2 && z_ok) ? lp[0] : kNeg;
    if (a_out) a_out[0] = cur[s];
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    if (active) {
      const float a1 = s >= 1 ? cur[s - 1] : kNeg;
      const float a2 = skip ? cur[s - 2] : kNeg;
      const float e = z_ok ? lp[t * t_stride] : kNeg;
      const float a = lse3(cur[s], a1, a2) + e;
      nxt[s] = a;
      if (a_out) a_out[(size_t)t * S] = a;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (s == 0) {
    const int len = lengths[b];
    float out = kClamp;
    if (len >= 0 && len <= L) {
      const int elen = 2 * len + 1;
      const float l1 = cur[elen - 1];
      const float l2 = elen >= 2 ? cur[elen - 2] : kNeg;
      const float m = fmaxf(l1, l2);
      if (m > 0.5f * kNeg) {
        out = fminf(-(m + logf(expf(l1 - m) + expf(l2 - m))), kClamp);
      }
    }
    nll[b] = out;
  }
}

// 4-byte copy from device to shared memory that does not hold the thread
// (cp.async): a thread can have all of its loads in flight at once.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One block per batch row, one thread per extended position of the band
// s < n = blockDim.x that holds every live position; see the header.
// Shared memory, in 4-byte words: c = beta + E (2, n), E and the terms
// (T, n) each, the row's gradient (T, V), the blank's totals (T) and the
// label's symbols z[2k+1] (n / 2).
__global__ void __launch_bounds__(1024)
ctc_beta_grad_kernel(const float* __restrict__ log_probs,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     const float* __restrict__ alpha,
                     const float* __restrict__ nll,
                     const float* __restrict__ grad_out,
                     float* __restrict__ grad_lp, int T, int B, int V, int L,
                     int pad_id, int blank) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int n = blockDim.x;
  const int S = 2 * L + 1;
  const size_t t_stride = (size_t)B * V;
  float* out = grad_lp + (size_t)b * V;

  // A row the forward did not clamp has 0 <= len <= L and an alignment in
  // T steps, so len <= T and elen <= min(S, 2T+1) <= n: beta is "-inf" at
  // every s >= elen, and those positions contribute exactly 0.
  const float row_nll = nll[b];
  const int len = lengths[b];
  if (!(row_nll < kClamp) || len < 0 || 2 * len + 1 > n) {
    for (int i = s; i < T * V; i += n) {
      const int t = i / V;
      out[t * t_stride + (i - t * V)] = 0.0f;
    }
    return;
  }
  const int elen = 2 * len + 1;
  const bool active = s < elen;
  float* cbuf = smem;                        // [2][n]
  float* emit = cbuf + 2 * n;                // [T][n]
  float* term = emit + T * n;                // [T][n]
  float* grad = term + T * n;                // [T][V]
  float* blank_total = grad + T * V;         // [T]
  int* zk = reinterpret_cast<int*>(blank_total + T);  // [n / 2]

  int z = blank;
  bool skip_dep = false;  // transition s -> s+2 allowed, i.e. skip[s+2]
  if (active && (s & 1)) {
    const int* row = labels + (size_t)b * L;
    const int k = s >> 1;
    z = label_at(row, k, pad_id, blank);
    if (k + 1 < L) {
      const int z2 = label_at(row, k + 1, pad_id, blank);
      skip_dep = z2 != blank && z2 != z;
    }
    zk[k] = z;
  }
  const bool z_ok = z >= 0 && z < V;

  // every global load of the chain, in flight together; each thread reads
  // back only its own column, so waiting for its own copies is enough
  if (active) {
    const float* e_src = log_probs + (size_t)b * V + z;
    const float* a_src = alpha + (size_t)b * T * S + s;
    float* e_dst = emit + s;
    float* a_dst = term + s;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      if (z_ok) copy_async(e_dst, e_src);
      else *e_dst = kNeg;
      copy_async(a_dst, a_src);
      e_src += t_stride;
      a_src += S;
      e_dst += n;
      a_dst += n;
    }
  }
  const float logz = -row_nll;
  const float g = grad_out[b];
  for (int i = s; i < T * V; i += n) grad[i] = 0.0f;
  // while the copies land: is this position its symbol's first in the
  // label (the one that will sum the symbol's terms)?
  __syncthreads();
  bool first = (s & 1) && active && z_ok;
  for (int i = 0; i < (s >> 1) && first; ++i) first = zk[i] != z;
  copy_async_wait();

  float beta = s == elen - 1 || s == elen - 2 ? 0.0f : kNeg;
  for (int t = T - 1; t >= 0; --t) {
    if (active) {
      if (t < T - 1) {
        const float* c_nxt = cbuf + ((t + 1) & 1) * n;
        const float c1 = s + 1 < elen ? c_nxt[s + 1] : kNeg;
        const float c2 = skip_dep && s + 2 < elen ? c_nxt[s + 2] : kNeg;
        beta = lse3(c_nxt[s], c1, c2);
      }
      cbuf[(t & 1) * n + s] = beta + emit[t * n + s];
      term[t * n + s] += beta;
    }
    __syncthreads();
  }

  // the terms, all T independent
  if (active) {
#pragma unroll 8
    for (int t = 0; t < T; ++t)
      term[t * n + s] = -expf(term[t * n + s] - logz) * g;
  }
  __syncthreads();

  // the blank's total for each step (even s, in order), and each symbol's
  // first position in the label sums the terms of all its positions, in
  // label order, into its slot: one writer a slot, no atomics
  for (int t = s; t < T; t += n) {
    float sum = 0.0f;
#pragma unroll 8
    for (int e = 0; e < elen; e += 2) sum += term[t * n + e];
    blank_total[t] = sum;
  }
  if (first) {
#pragma unroll 8
    for (int t = 0; t < T; ++t) grad[t * V + z] = term[t * n + s];
    for (int i = (s >> 1) + 1; i < len; ++i) {
      if (zk[i] != z) continue;
#pragma unroll 8
      for (int t = 0; t < T; ++t) grad[t * V + z] += term[t * n + 2 * i + 1];
    }
  }
  __syncthreads();

  // the row's (T, V) gradient to device memory; (t, v) of element
  // i = s + m * n advance without a division
  const int dt = n / V, dv = n - dt * V;
  int t = s / V, v = s - t * V;
#pragma unroll 4
  for (int i = s; i < T * V; i += n) {
    float x = grad[i];
    if (v == blank) x = blank_total[t] + x;
    out[t * t_stride + v] = x;
    t += dt;
    v += dv;
    if (v >= V) {
      v -= V;
      ++t;
    }
  }
}

}  // namespace

// alpha_out: (B, T, 2L+1) float32 for a later qea_ctc_beta_bwd, or null.
extern "C" int qea_ctc_alpha_fwd(const float* log_probs, const int* labels,
                                 const int* lengths, float* nll,
                                 float* alpha_out, int T, int B, int V, int L,
                                 int pad_id, int blank, cudaStream_t stream) {
  const int S = 2 * L + 1;
  const int threads = (S + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  ctc_alpha_kernel<<<B, threads, smem, stream>>>(log_probs, labels, lengths,
                                                 nll, alpha_out, T, B, V, L,
                                                 pad_id, blank);
  return (int)cudaGetLastError();
}

// grad_lp (T, B, V) = d sum_b(grad_out[b] * nll[b]) / d log_probs, from the
// alpha and the (clamped) nll that qea_ctc_alpha_fwd wrote for these inputs.
extern "C" int qea_ctc_beta_bwd(const float* log_probs, const int* labels,
                                const int* lengths, const float* alpha,
                                const float* nll, const float* grad_out,
                                float* grad_lp, int T, int B, int V, int L,
                                int pad_id, int blank, cudaStream_t stream) {
  // the band: every extended position a row that the forward did not clamp
  // can use, min(S, 2T+1), in whole warps; and the kernel's shared memory
  // (ctc_cuda.grad_smem_bytes says the same)
  const int band = L < T ? 2 * L + 1 : 2 * T + 1;
  const int threads = (band + 31) / 32 * 32;
  const long long smem =
      4 * (2LL * threads * (T + 1) + (long long)T * V + T + threads / 2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctc_beta_grad_kernel<<<B, threads, (size_t)smem, stream>>>(
      log_probs, labels, lengths, alpha, nll, grad_out, grad_lp, T, B, V, L,
      pad_id, blank);
  return (int)cudaGetLastError();
}

extern "C" const char* qea_ctc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
