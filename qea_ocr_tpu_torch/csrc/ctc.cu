// CTC forward (alpha) recursion: per-sample negative log-likelihood of the
// labels under time-major log-probabilities.
//
// Replaces: qea_ocr_tpu/ops/pallas/ctc_pallas.py `_forward_kernel` (TPU),
// together with the label preparation around it (`_prep`,
// `_extend_labels`) and the 1e5 clamp of `_ctc_fwd_impl`.
//
// Semantics kept from the TPU kernel:
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
//     surrogate and is clamped to exactly 1e5.
// Beyond the TPU kernel: a label outside [0, V) that is not pad_id gets an
// emission of -1e30 instead of being read out of bounds, and a length
// outside [0, L] scores 1e5.
//
// Bound: the T-step serial dependency, not bytes or FLOPs. Each step is one
// log-sum-exp per extended position (3 expf + 1 logf) and one scattered
// 4-byte emission load. At T=31, S=201 and B=128 the whole call reads about
// 0.8 MB of emissions (one float per (t, b, s)), so it is a chain of 31
// short latency-bound steps.
//
// Design: one block per batch row, one thread per extended position (S is
// rounded up to a whole number of warps; at most 1024, so L <= 511). alpha
// lives in shared memory, double-buffered, so each step needs exactly one
// __syncthreads: step t reads buffer t%2 and writes buffer (t+1)%2. Each
// thread keeps its own z[s] and skip flag in registers and reads its
// emission log_probs[t, b, z[s]] directly; the TPU kernel's one-hot einsum
// was a workaround for the TPU's weak gathers. expf/logf are the accurate
// library functions (no fast-math intrinsics).
// alpha is not written out: the backward recursion that needs it belongs to
// training and will either recompute it or add an output here.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kClamp = 1e5f;

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
                                 float* __restrict__ nll, int T, int B, int V,
                                 int L, int pad_id, int blank) {
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
  if (active) cur[s] = (s < 2 && z_ok) ? lp[0] : kNeg;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    if (active) {
      const float a1 = s >= 1 ? cur[s - 1] : kNeg;
      const float a2 = skip ? cur[s - 2] : kNeg;
      const float e = z_ok ? lp[t * t_stride] : kNeg;
      nxt[s] = lse3(cur[s], a1, a2) + e;
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

}  // namespace

extern "C" int qea_ctc_alpha_fwd(const float* log_probs, const int* labels,
                                 const int* lengths, float* nll, int T, int B,
                                 int V, int L, int pad_id, int blank,
                                 cudaStream_t stream) {
  const int S = 2 * L + 1;
  const int threads = (S + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  ctc_alpha_kernel<<<B, threads, smem, stream>>>(log_probs, labels, lengths,
                                                 nll, T, B, V, L, pad_id,
                                                 blank);
  return (int)cudaGetLastError();
}

extern "C" const char* qea_ctc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
