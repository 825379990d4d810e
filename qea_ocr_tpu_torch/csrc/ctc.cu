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
// The band. Only positions s < min(S, 2T+1) can ever be reached (at step t
// only s <= 2t+1), and the recursion at s reads only s-1 and s-2, so the
// positions above the band never change a value below it. A row the forward
// does not clamp has an alignment in T steps, so len <= T and
// elen <= min(S, 2T+1): both kernels work on that band alone, one thread a
// position, rounded up to whole warps, n = round32(min(2L+1, 2T+1))
// (`band_threads`; 64 threads at T=31, L=100 against S=201: two warps).
//
// Forward design: one block per batch row, one thread per position of the
// band (n <= 1024, so any T while L <= 511). Every band position is computed
// from the same operands in the same order as over the full S, so the NLL
// is the same bit for bit; a row whose last position elen-1 lies at or
// beyond n has len > T, cannot be feasible and gives exactly 1e5, as over
// the full S. The recursion's state lives in shared memory,
// double-buffered, so each step needs exactly one __syncthreads: step t
// reads buffer t%2 and writes buffer (t+1)%2; each thread keeps its own
// alpha, z[s] and skip flag in registers. Nothing on the chain waits for
// device memory: before the first step the emissions go into a ring in
// shared memory as cp.async copies, in chunks of steps (all T at once at
// T=31; else two buffers of up to 32 steps, the next chunk landing while
// the chain runs on this one, sized so that a block never needs more than
// the 48 KB it may have without opting in). The blank's emission of a step
// is that of every even position and every pad, so it is copied once a
// step and shared (one copy a thread, its address known before the labels
// arrive); a position with another class copies its own column, and reads
// back only that. `lengths[b]` is read early too. A step is then the
// log-sum-exp (`lse3`, with no branch), two shared reads, one shared write
// and one barrier. The TPU kernel's one-hot einsum was a workaround for the
// TPU's weak gathers. expf/logf are the accurate library functions
// (no fast-math intrinsics), in both kernels.
//
// Tried for the forward, and slower on the card (PERF.md): each position
// gathering all its emissions itself (1,984 scattered copies a row at T=31,
// a prologue as long as the chain at B=1536); the exchange by warp
// shuffles, each warp reading the warp below's top position from a tagged
// shared slot instead of a block barrier (slower even at one warp, with no
// slot to wait for); chunks of 8 steps; alpha stored from shared memory
// after each chunk instead of once a step.
//
// alpha for the backward: when a gradient is wanted the forward also writes
// alpha over the band, as (B, T, n) float32 (positions at or above S hold
// the -1e30 surrogate), and the backward reads it. Recomputing it in the
// backward instead would double that kernel's serial chain (62 dependent
// steps for 31), while the write is one coalesced n-float store per step
// that nothing waits for (12 MB at B=1536). Without a gradient the pointer
// is null and nothing is written.
//
// Backward design. Every s that beta can reach lies below elen, inside the
// band; a clamped row's gradient is 0 and its block stores zeros and stops.
// So a block takes one row with one thread per position of the band, and
// the chain of T steps has one __syncthreads each on the double-buffered
// c = beta + E. What it keeps off the chain:
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
// Tried on the way for the backward, and slower on the card (PERF.md): all
// T loads held in registers over the full S with fully unrolled steps
// (about 100 registers, two blocks an SM: slower than the first port at
// large B); the same from shared memory with rolled steps; one warp a row
// over the band with two positions a lane (the two positions of a step run
// one after the other). What is left is the chain itself: one accurate
// three-way log-sum-exp, a shared round trip and a barrier a step, as in
// the forward.
//
// Hopper's own units do not apply. There is no matrix product, so wgmma has
// nothing to do. The emissions are a gather, one float per position out of
// a 380-byte row of log-probs at a stride of B*380: no TMA box holds them,
// and a TMA copy from a start that is not 16-byte aligned is an illegal
// instruction on this card. cp.async (4 bytes a copy) takes any alignment.
// alpha's band leaves and returns as coalesced n-float rows, which plain
// loads and stores already move at full width.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kClamp = 1e5f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
constexpr int kFwdSmem = 48 * 1024;  // shared memory without opting in
constexpr int kFwdChunk = 32;       // steps a chunk of the forward's ring

// The three-way log-sum-exp of both chains, -1e30 where all three are at or
// below -5e29. Both sides are computed and one is selected, with no branch
// (every operand is finite or -inf, so nothing traps): in both chains the
// positions just above the reachable front diverge from those below it at
// every step, and the branch cost more than the arithmetic it skips.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  const float r = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m > 0.5f * kNeg ? r : kNeg;
}

__device__ __forceinline__ int label_at(const int* row, int k, int pad_id,
                                        int blank) {
  const int v = row[k];
  return v == pad_id ? blank : v;
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

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `kPending` of this thread's committed groups are in
// flight
template <int kPending>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One block per batch row, one thread per position of the band
// s < n = blockDim.x; see the header. Shared memory, in 4-byte words: alpha
// (2, n), double-buffered, then the emission ring: one buffer of `chunk`
// steps (chunk = T) or two (chunk < T), each the blank's emissions (chunk)
// and the other positions' (chunk, n).
__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ log_probs,
                 const int* __restrict__ labels,
                 const int* __restrict__ lengths, float* __restrict__ nll,
                 float* __restrict__ alpha_out, int T, int B, int V, int L,
                 int chunk, int pad_id, int blank) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int n = blockDim.x;
  const int S = 2 * L + 1;
  const bool active = s < S;
  const size_t t_stride = (size_t)B * V;
  const int n_chunks = (T + chunk - 1) / chunk;
  float* cur = smem;
  float* nxt = smem + n;
  float* blank_ring = smem + 2 * n;
  float* ring = blank_ring + (n_chunks > 1 ? 2 : 1) * chunk;

  // The blank's emission of each step is every blank position's (and every
  // pad's): thread s copies that of the chunk's step s (chunk <= 32 <= n),
  // into a ring all threads read after a barrier. Its address does not
  // depend on the labels, so chunk 0's copies go out before they load.
  const bool blank_ok = blank >= 0 && blank < V;
  const float* blank_src = log_probs + (size_t)b * V + blank;
  auto issue_blank = [&](int k) {
    const int t = k * chunk + s;
    if (blank_ok && s < chunk && t < T)
      copy_async(blank_ring + (k & 1) * chunk + s, blank_src + t * t_stride);
  };
  issue_blank(0);
  const int len = lengths[b];  // read now, used after the chain

  int z = blank;
  bool skip = false;
  if (active && (s & 1)) {
    const int* row = labels + (size_t)b * L;
    const int k = s >> 1;
    z = label_at(row, k, pad_id, blank);
    if (k >= 1) {
      skip = z != blank && z != label_at(row, k - 1, pad_id, blank);
    }
  }
  const bool z_ok = z >= 0 && z < V;
  // a position whose class is not the blank has a column of its own: its
  // emissions, or -1e30 where the class is out of range
  const bool own = active && !(z == blank && z_ok);
  const float* e_src = log_probs + (size_t)b * V + z;

  // this thread's own column of chunk k into buffer k % 2; it closes chunk
  // k's commit group, the blank's copy included
  auto issue_own = [&](int k) {
    if (own) {
      float* dst = ring + (k & 1) * chunk * n + s;
      const int t1 = min(T, (k + 1) * chunk);
      for (int t = k * chunk; t < t1; ++t, dst += n) {
        if (z_ok) copy_async(dst, e_src + t * t_stride);
        else *dst = kNeg;
      }
    }
    copy_async_commit();
  };
  issue_own(0);
  if (n_chunks > 1) {
    issue_blank(1);
    issue_own(1);
  }

  // alpha_out is (B, T, n); null when no gradient is wanted
  float* a_out = alpha_out ? alpha_out + (size_t)b * T * n + s : nullptr;
  float mine = kNeg;  // this position's alpha at the last step
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) copy_async_wait_group<1>();
    else copy_async_wait_group<0>();
    __syncthreads();  // the blank's copies of chunk k, for every thread
    const int e_stride = own ? n : 1;
    const float* e = own ? ring + (k & 1) * chunk * n + s
                         : blank_ring + (k & 1) * chunk;
    int t = k * chunk;
    const int t1 = min(T, t + chunk);
    if (t == 0) {
      mine = active && s < 2 ? e[0] : kNeg;
      cur[s] = mine;
      if (a_out) a_out[0] = mine;
      __syncthreads();
      ++t;
      e += e_stride;
    }
    for (; t < t1; ++t, e += e_stride) {
      if (active) {
        const float a1 = s >= 1 ? cur[s - 1] : kNeg;
        const float a2 = skip ? cur[s - 2] : kNeg;
        mine = lse3(mine, a1, a2) + *e;
        nxt[s] = mine;
      }
      if (a_out) a_out[(size_t)t * n] = mine;
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // every thread is past its last read of buffer k % 2
    if (k + 2 < n_chunks) {
      issue_blank(k + 2);
      issue_own(k + 2);
    }
  }

  if (s == 0) {
    float out = kClamp;
    if (len >= 0 && len <= L) {
      const int elen = 2 * len + 1;
      // elen > n: len > T, so both positions are out of reach and the row
      // is clamped, as over the full S
      if (elen <= n) {
        const float l1 = cur[elen - 1];
        const float l2 = elen >= 2 ? cur[elen - 2] : kNeg;
        const float m = fmaxf(l1, l2);
        if (m > 0.5f * kNeg) {
          out = fminf(-(m + logf(expf(l1 - m) + expf(l2 - m))), kClamp);
        }
      }
    }
    nll[b] = out;
  }
}

// One block per batch row, one thread per position of the band
// s < n = blockDim.x; see the header.
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
    const float* a_src = alpha + (size_t)b * T * n + s;
    float* e_dst = emit + s;
    float* a_dst = term + s;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      if (z_ok) copy_async(e_dst, e_src);
      else *e_dst = kNeg;
      copy_async(a_dst, a_src);
      e_src += t_stride;
      a_src += n;
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

// Threads a row in both kernels: the band min(2L+1, 2T+1) in whole warps
// (ctc_cuda.band_threads says the same).
static int band_threads(int T, int L) {
  const int band = L < T ? 2 * L + 1 : 2 * T + 1;
  return (band + 31) / 32 * 32;
}

// alpha_out: (B, T, band_threads(T, L)) float32 for a later
// qea_ctc_beta_bwd, or null.
extern "C" int qea_ctc_alpha_fwd(const float* log_probs, const int* labels,
                                 const int* lengths, float* nll,
                                 float* alpha_out, int T, int B, int V, int L,
                                 int pad_id, int blank, cudaStream_t stream) {
  const int threads = band_threads(T, L);
  // the emission ring: chunks of at most kFwdChunk steps, two buffers of
  // them beside alpha's two rows within kFwdSmem, or one buffer of all T
  int chunk = (kFwdSmem / 4 - 2 * threads) / (2 * (threads + 1));
  chunk = chunk < kFwdChunk ? chunk : kFwdChunk;
  const int buffers = T <= chunk ? 1 : 2;
  if (T <= chunk) chunk = T;
  const size_t smem =
      4 * ((size_t)2 * threads + (size_t)buffers * chunk * (threads + 1));
  ctc_alpha_kernel<<<B, threads, smem, stream>>>(log_probs, labels, lengths,
                                                 nll, alpha_out, T, B, V, L,
                                                 chunk, pad_id, blank);
  return (int)cudaGetLastError();
}

// grad_lp (T, B, V) = d sum_b(grad_out[b] * nll[b]) / d log_probs, from the
// alpha and the (clamped) nll that qea_ctc_alpha_fwd wrote for these inputs.
extern "C" int qea_ctc_beta_bwd(const float* log_probs, const int* labels,
                                const int* lengths, const float* alpha,
                                const float* nll, const float* grad_out,
                                float* grad_lp, int T, int B, int V, int L,
                                int pad_id, int blank, cudaStream_t stream) {
  // the band, and the kernel's shared memory (ctc_cuda.grad_smem_bytes
  // says the same)
  const int threads = band_threads(T, L);
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
