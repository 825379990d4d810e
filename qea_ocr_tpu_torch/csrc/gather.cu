// Strip gather, forward and backward. Forward: crop each text box out of its
// document and centre it in an h_out x w_out tile, white (1.0) outside the
// crop. Backward: add every tile's gradient back into its document's.
//
// Replaces: qea_ocr_tpu/ops/pallas/gather_pallas.py `_fwd_kernel` and
// `_bwd_kernel` (TPU). The TPU kernels moved pixels as 0/1 permutation
// matmuls over an (8,128)-aligned VMEM window, because a TPU gather is
// row-at-a-time vector work. Here each cell is one indexed load, so none of
// that is needed: no window, no alignment gate, any document height and
// width.
//
// Bound: device-memory bytes. Forward: every output float is written once
// and at most one document float is read for it. Backward: every tile cell
// under a box is read once and every document float written once. There is
// no arithmetic to speak of. At the slice's shapes (8 docs x 16 strips of
// 32x128, 400x512 documents) the forward moves about 4 MB and the backward
// about 7 MB, so launch latency weighs on both.
//
// Forward design: one warp per tile row. A block of 8 warps covers 8 rows
// of one (document, strip) tile, in a grid of (D*S, ceil(h_out / 8)): 512
// blocks at the slice's shapes, against the card's 132 SMs. Each warp reads
// the box (broadcast loads of one 16-byte line) and takes row0 and col0
// from it once; no cell pays a division or a modulo. A row outside
// [y_min, y_max) is stored white without touching the document. Inside,
// lane i owns 4 consecutive cells of the row, issues their (up to) 4 loads
// from the clamped document row together, neighbouring lanes on
// neighbouring columns, and stores them as one float4 where w_out % 4 == 0
// (each tile row then starts 16-byte aligned), else one by one; it steps
// 128 columns at a time where w_out > 128. Semantics are those of the XLA
// path in qea_ocr_tpu/ops/text_stack.py `_extract_one`: rows/cols outside
// the box are white, and source coordinates are clamped to the document's
// edge, so a box that pokes out of the document repeats edge pixels. It is
// a copy, with no arithmetic on the values, so it equals the plain version
// bit for bit, at any h_out, w_out, H and W.
//
// Backward design: the gather formulation, tiled and culled. The TPU kernel
// walked a document's strips serially so that overlapping boxes accumulate
// without races; a scatter on this card would need global atomics and give
// sums whose order changes from run to run. Instead each document pixel
// loops over the boxes in strip order and adds the tile cells that the
// forward filled from it, so every output is written once, with no atomics
// and no zero-fill pass, and the order of additions is fixed (strip, then
// tile row, then tile column): the result is bitwise repeatable. Inside the
// document a box gives a pixel at most one cell. At the document's edge the
// forward's clamp makes an edge pixel the source of every cell of a
// poking-out box that lies beyond that edge, so an edge pixel's row (column)
// range opens to -infinity or +infinity before it is cut to the box and the
// tile.
//
// Most pixels lie under no box, so a block takes a 32-row x 128-column tile
// of one document (416 blocks at 8 x 400x512) and each warp 4 rows of it;
// a lane owns 4 consecutive pixels of each row, stored as one float4 where
// W % 4 == 0 (rows then start 16-byte aligned), else one by one. Each warp
// culls the boxes once for its 4 x 128 pixels: lane i tests box i of a chunk
// of 32 against that range, opened to +-infinity at the document's edges as
// for a pixel, and `__ballot_sync` gives the survivors in strip order; the
// warp walks only those, taking each one's source range from its lane by
// shuffle. A warp that no box touches stores zeros and is done. Culling per
// warp rather than per block needs no shared list and no barrier, and the
// tighter range drops more boxes; it costs each warp a 16-byte load a box,
// from L2 after the first. No per-pixel division is left. For each box a
// lane issues the loads of all its 16 pixels together (a pixel off the
// document's edge takes at most one cell of a box), so a box costs the warp
// one round trip to memory; a box gives neighbouring pixels neighbouring
// cells of one tile row, so the lanes of a warp read along tile rows. Only
// a pixel on the document's edge loops over the cells the clamp moved onto
// it, four loads at a time, after its box's batch.
// A box that pokes far out of the document makes its edge pixels walk many
// cells, so their blocks take several times the others' and set the
// kernel's time (PERF.md).
//
// Hopper's own units do not apply: there is no matrix product for wgmma,
// and the work is a sparse gather under the boxes plus a dense store, which
// plain 16-byte stores already issue at full width; TMA would add an
// mbarrier round trip per tile and could not stage the boxes' cells, whose
// starts are not 16-byte aligned.
#include <cuda_runtime.h>

namespace {

// Python-style floor division by 2 (C++ `/` truncates toward zero).
__device__ __forceinline__ int floor_half(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

constexpr int kFwdRows = 8;  // tile rows a block: one a warp
constexpr int kFwdThreads = 32 * kFwdRows;
constexpr int kMaxGridY = 65535;

// grid (D * S, min(ceil(h_out / kFwdRows), kMaxGridY)), kFwdThreads
// threads; see the header.
__global__ void __launch_bounds__(kFwdThreads)
gather_fwd_kernel(const float* __restrict__ docs,
                  const int* __restrict__ bboxes, float* __restrict__ out,
                  int S, int H, int W, int h_out, int w_out) {
  const int ds = blockIdx.x;  // d * S + s
  const int lane = threadIdx.x & 31;
  const int* box = bboxes + 4 * (size_t)ds;
  const int x_min = box[0], y_min = box[1], x_max = box[2], y_max = box[3];
  const int row0 = y_min - floor_half(h_out - (y_max - y_min));
  const int col0 = x_min - floor_half(w_out - (x_max - x_min));
  const float* doc = docs + (size_t)(ds / S) * H * W;
  float* tile = out + (size_t)ds * h_out * w_out;
  const bool vec = (w_out & 3) == 0;
  for (int r = blockIdx.y * kFwdRows + (threadIdx.x >> 5); r < h_out;
       r += gridDim.y * kFwdRows) {
    const int y = row0 + r;
    const bool row_in = y >= y_min && y < y_max;
    const float* src = doc + (size_t)min(max(y, 0), H - 1) * W;
    float* o = tile + (size_t)r * w_out;
    for (int c = 4 * lane; c < w_out; c += 128) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = col0 + c + q;
        v[q] = row_in && c + q < w_out && x >= x_min && x < x_max
                   ? src[min(max(x, 0), W - 1)]
                   : 1.0f;
      }
      if (vec) {
        *reinterpret_cast<float4*>(o + c) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < w_out) o[c + q] = v[q];
      }
    }
  }
}

constexpr int kBwdTileRows = 32;   // rows of a block's tile; 4 a warp
constexpr int kBwdTileCols = 128;  // 4 pixels a lane
constexpr int kBwdThreads = 256;
constexpr int kFar = 1 << 30;

// grid (ceil(W / 128), ceil(H / 32), D), kBwdThreads threads; see the header.
__global__ void __launch_bounds__(kBwdThreads)
gather_bwd_kernel(const float* __restrict__ grads,
                  const int* __restrict__ bboxes, float* __restrict__ d_docs,
                  int S, int H, int W, int h_out, int w_out) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.z;
  const int y_first = blockIdx.y * kBwdTileRows + 4 * (threadIdx.x >> 5);
  if (y_first >= H) return;  // whole warp
  const int y_last = min(y_first + 4, H) - 1;
  const int x_first = blockIdx.x * kBwdTileCols;
  const int x_last = min(x_first + kBwdTileCols, W) - 1;
  // the warp's pixels, opened at the document's edges
  const int wr_lo = y_first == 0 ? -kFar : y_first;
  const int wr_hi = y_last == H - 1 ? kFar : y_last;
  const int wc_lo = x_first == 0 ? -kFar : x_first;
  const int wc_hi = x_last == W - 1 ? kFar : x_last;
  const int x0 = x_first + 4 * lane;  // this lane's first column
  // no edge row or column among this lane's 16 pixels (columns past W are
  // never stored)
  const bool interior = y_first > 0 && y_last < H - 1 && x0 > 0 &&
                        x0 + 3 < W - 1;
  const int* boxes = bboxes + 4 * (size_t)d * S;
  const float* doc_grads = grads + (size_t)d * S * h_out * w_out;

  float acc[4][4] = {};
  for (int base = 0; base < S; base += 32) {
    // lane i: the document rows and columns box base+i is read from
    int ra = 0, rb = -1, ca = 0, cb = -1, row0 = 0, col0 = 0;
    if (base + lane < S) {
      const int* box = boxes + 4 * (base + lane);
      const int x_min = box[0], y_min = box[1], x_max = box[2],
                y_max = box[3];
      row0 = y_min - floor_half(h_out - (y_max - y_min));
      col0 = x_min - floor_half(w_out - (x_max - x_min));
      ra = max(y_min, row0);
      rb = min(y_max, row0 + h_out) - 1;
      ca = max(x_min, col0);
      cb = min(x_max, col0 + w_out) - 1;
    }
    const bool hit = ra <= rb && ca <= cb && ra <= wr_hi && rb >= wr_lo &&
                     ca <= wc_hi && cb >= wc_lo;
    unsigned live = __ballot_sync(0xffffffffu, hit);
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const int jra = __shfl_sync(0xffffffffu, ra, j);
      const int jrb = __shfl_sync(0xffffffffu, rb, j);
      const int jca = __shfl_sync(0xffffffffu, ca, j);
      const int jcb = __shfl_sync(0xffffffffu, cb, j);
      const int jrow0 = __shfl_sync(0xffffffffu, row0, j);
      const int jcol0 = __shfl_sync(0xffffffffu, col0, j);
      const float* tile = doc_grads + (size_t)(base + j) * h_out * w_out;
      // a pixel off the document's edge takes at most one cell of a box:
      // those 16 loads are issued together
      float v[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int y = y_first + k;
        const bool row_in = y > 0 && y < H - 1 && y >= jra && y <= jrb;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + q;
          v[k][q] = row_in && x > 0 && x < W - 1 && x >= jca && x <= jcb
                        ? tile[(y - jrow0) * w_out + (x - jcol0)]
                        : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] += v[k][q];
      if (interior) continue;
      // an edge pixel takes every cell the clamp moved onto it
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int y = y_first + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + q;
          if (y > y_last || x >= W || (y > 0 && y < H - 1 && x > 0 &&
                                       x < W - 1))
            continue;
          const int r_a = max(y == 0 ? -kFar : y, jra);
          const int r_b = min(y == H - 1 ? kFar : y, jrb);
          const int c_a = max(x == 0 ? -kFar : x, jca);
          const int c_b = min(x == W - 1 ? kFar : x, jcb);
          for (int r = r_a; r <= r_b; ++r)
#pragma unroll 4
            for (int c = c_a; c <= c_b; ++c)
              acc[k][q] += tile[(r - jrow0) * w_out + (c - jcol0)];
        }
      }
    }
  }

  float* out = d_docs + (size_t)d * H * W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = y_first + k;
    if (y > y_last || x0 >= W) continue;
    float* o = out + (size_t)y * W + x0;
    if ((W & 3) == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (x0 + q < W) o[q] = acc[k][q];
    }
  }
}

}  // namespace

extern "C" int qea_gather_fwd(const float* docs, const int* bboxes,
                              float* out, int D, int S, int H, int W,
                              int h_out, int w_out, cudaStream_t stream) {
  const int row_blocks = (h_out + kFwdRows - 1) / kFwdRows;
  const dim3 grid(D * S, row_blocks < kMaxGridY ? row_blocks : kMaxGridY);
  gather_fwd_kernel<<<grid, kFwdThreads, 0, stream>>>(docs, bboxes, out, S,
                                                      H, W, h_out, w_out);
  return (int)cudaGetLastError();
}

// d_docs (D, 1, H, W) = sum over strips of grads (D, S, h_out, w_out) at the
// document pixels the forward read them from. Every element is written.
extern "C" int qea_gather_bwd(const float* grads, const int* bboxes,
                              float* d_docs, int D, int S, int H, int W,
                              int h_out, int w_out, cudaStream_t stream) {
  const dim3 grid((W + kBwdTileCols - 1) / kBwdTileCols,
                  (H + kBwdTileRows - 1) / kBwdTileRows, D);
  gather_bwd_kernel<<<grid, kBwdThreads, 0, stream>>>(grads, bboxes, d_docs,
                                                      S, H, W, h_out, w_out);
  return (int)cudaGetLastError();
}

extern "C" const char* qea_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
