// Strip-gather forward: crop each text box out of its document and centre
// it in an h_out x w_out tile, white (1.0) outside the crop.
//
// Replaces: qea_ocr_tpu/ops/pallas/gather_pallas.py `_fwd_kernel` (TPU).
// The TPU kernel moved pixels as 0/1 permutation matmuls over an
// (8,128)-aligned VMEM window, because a TPU gather is row-at-a-time vector
// work. Here each output cell is one indexed load, so none of that is needed:
// no window, no alignment gate, any document height and width.
//
// Bound: device-memory bytes. Every output float is written once and at most
// one document float is read for it; there is no arithmetic to speak of. At
// the slice's shapes (8 docs x 16 strips of 32x128) the whole call moves
// about 0.5 MB, so launch latency dominates.
//
// Design: one block per (document, strip). Threads walk the tile in
// row-major order, so neighbouring threads write neighbouring columns
// (coalesced 128-byte stores) and read neighbouring document pixels of the
// same row. The box is read once per thread from global memory (a broadcast
// through L1). Semantics are those of the XLA path in
// qea_ocr_tpu/ops/text_stack.py `_extract_one`: rows/cols outside the box
// are white, and source coordinates are clamped to the document's edge, so a
// box that pokes out of the document repeats edge pixels.
#include <cuda_runtime.h>

namespace {

// Python-style floor division by 2 (C++ `/` truncates toward zero).
__device__ __forceinline__ int floor_half(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

__global__ void gather_fwd_kernel(const float* __restrict__ docs,
                                  const int* __restrict__ bboxes,
                                  float* __restrict__ out, int S, int H,
                                  int W, int h_out, int w_out) {
  const int ds = blockIdx.x;  // d * S + s
  const int d = ds / S;
  const int* box = bboxes + 4 * (size_t)ds;
  const int x_min = box[0], y_min = box[1], x_max = box[2], y_max = box[3];
  const int row0 = y_min - floor_half(h_out - (y_max - y_min));
  const int col0 = x_min - floor_half(w_out - (x_max - x_min));
  const float* doc = docs + (size_t)d * H * W;
  float* tile = out + (size_t)ds * h_out * w_out;
  const int n = h_out * w_out;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = row0 + idx / w_out;
    const int c = col0 + idx % w_out;
    float v = 1.0f;
    if (r >= y_min && r < y_max && c >= x_min && c < x_max) {
      const int rc = min(max(r, 0), H - 1);
      const int cc = min(max(c, 0), W - 1);
      v = doc[(size_t)rc * W + cc];
    }
    tile[idx] = v;
  }
}

}  // namespace

extern "C" int qea_gather_fwd(const float* docs, const int* bboxes,
                              float* out, int D, int S, int H, int W,
                              int h_out, int w_out, cudaStream_t stream) {
  gather_fwd_kernel<<<D * S, 256, 0, stream>>>(docs, bboxes, out, S, H, W,
                                               h_out, w_out);
  return (int)cudaGetLastError();
}

extern "C" const char* qea_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
