// Channel-major 3x3 SAME convolution on padded-flat activations:
//
//   Y[d, co, y, x] = sum_{dy, dx, ci} Wt[dy, dx, co, ci] * X[d, ci, y+dy-1, x+dx-1]
//
// with bfloat16 operands, float32 accumulation, an optional epilogue
// relu(y + shift[co]) on the accumulator, and a bfloat16 output.
// Activations are (D, C, (H+2)*W): every channel plane carries one halo row
// above and one below the image. The input's halo rows are never read (they
// count as zeros, whatever they hold); the output's halo rows are written as
// zeros.
//
// Replaces: qea_ocr_tpu/ops/pallas/conv_cmajor.py `_kernel` (TPU). The TPU
// kernel put the whole image plane on the 128-lane axis, took the three
// vertical taps as lane-offset views of one double-buffered DMA band, rolled
// partial outputs for the horizontal taps, and so needed W % 128 == 0, a
// tile height that divides H and a VMEM budget. None of that is carried
// over: this kernel takes any Cin, Cout, H and W.
//
// Bound: device-memory bytes at the UNet's shapes. The largest conv of the
// path (D=8, 64 -> 32 channels at 400x512) reads 211 MB and writes 105 MB
// (0.094 ms at 3.35 TB/s) for 60 GFLOP (0.061 ms at the bf16 tensor-core
// peak). So the products must run on the tensor cores, and the input tile
// must be read from device memory once per block, not once per tap.
//
// Design: an implicit GEMM per block, M = output channels, N = pixels,
// K = 9 taps x input channels. A block of 8 warps owns a tile of 8 rows x 32
// columns and up to 64 output channels; warp r owns row r: MT x 4
// `mma.sync.m16n8k16` accumulator tiles (16 channels x 8 pixels each) in
// registers. Input channels are walked in chunks of 16. For a chunk the block
// stages, in shared memory,
//   xs[(8+2) x (32+2) pixels][16 ci]   the tile with its one-pixel border,
//                                      pixel-major, so that the two
//                                      consecutive-k values of an mma operand
//                                      register are one aligned 32-bit load
//                                      at any tap offset;
//   ws[9 taps][16*MT co][16 ci]        the weights of the chunk;
// both with a row stride of 24 values (48 bytes), which spreads a warp's
// fragment loads and the 16-byte staging stores over all 32 banks. Reads
// beyond the image (border, halo rows) and beyond Cin or Cout are staged as
// zeros, so the mma loop has no masks. Then 9 taps x MT x 4 mma's per warp.
// The tile is read from device memory once per 64 output channels; the
// neighbours' shared border costs (10*34)/(8*32) = 1.33x. The epilogue adds
// the shift, clamps, and stores pairs of pixels; blocks of the first and last
// tile row also zero their columns of the output's halo rows.
// Not done here: cp.async or TMA staging, double buffering, ldmatrix,
// wgmma: one chunk is staged, consumed, and the next staged; several blocks
// per SM hide the latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // tile rows = warps per block
constexpr int TW = 32;             // tile columns = 4 mma n-tiles
constexpr int CK = 16;             // input channels per chunk = mma k
constexpr int CKP = 24;            // shared-memory row stride (values)
constexpr int XR = TH + 2;
constexpr int XC = TW + 2;
constexpr int THREADS = 32 * TH;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, size_t at,
                                           float v0, float v1, bool second,
                                           bool paired) {
  if (second && paired) {
    *reinterpret_cast<__nv_bfloat162*>(out + at) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    out[at] = __float2bfloat16_rn(v0);
    if (second) out[at + 1] = __float2bfloat16_rn(v1);
  }
}

// x (D, Cin, (H+2)*W) bf16; w (9, Cout, Cin) bf16, tap = 3*dy + dx;
// shift (Cout) f32 or null; out (D, Cout, (H+2)*W) bf16.
// grid (ceil(W/32), ceil(H/8), D * co_chunks), 256 threads.
template <int MT>
__global__ void __launch_bounds__(THREADS)
conv_cmajor_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ shift,
                   __nv_bfloat16* __restrict__ out,
                   int Cin, int Cout, int H, int W, int co_chunks) {
  constexpr int CO = 16 * MT;      // output channels per block
  __shared__ __align__(16) __nv_bfloat16 xs[XR * XC * CKP];
  __shared__ __align__(16) __nv_bfloat16 ws[9 * CO * CKP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int d = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z - d * co_chunks) * CO;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)(H + 2) * W;
  const __nv_bfloat16* xin = x + (size_t)d * Cin * plane;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();               // the previous chunk has been consumed
    // the input tile with its border: 8 channels of one pixel per item
    for (int item = tid; item < 2 * XR * XC; item += THREADS) {
      const int half = item / (XR * XC);
      const int pix = item - half * (XR * XC);
      const int r = pix / XC, c = pix - r * XC;
      const int gy = y0 + r - 1, gx = x0 + c - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int cb = c0 + 8 * half;
      const __nv_bfloat16* src =
          xin + (size_t)cb * plane + (size_t)(gy + 1) * W + gx;
      __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (inside && cb + k < Cin) ? src[(size_t)k * plane] : zero;
      *reinterpret_cast<uint4*>(xs + pix * CKP + 8 * half) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7]));
    }
    // the chunk's weights: 8 input channels of one (tap, co) per item
    for (int item = tid; item < 2 * 9 * CO; item += THREADS) {
      const int half = item & 1;
      const int row = item >> 1;   // tap * CO + co
      const int tap = row / CO;
      const int co = co0 + row - tap * CO;
      const int cb = c0 + 8 * half;
      const __nv_bfloat16* src = w + ((size_t)tap * Cout + co) * Cin + cb;
      __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (co < Cout && cb + k < Cin) ? src[k] : zero;
      *reinterpret_cast<uint4*>(ws + row * CKP + 8 * half) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7]));
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      // B operands: 16 ci x 8 pixels, for the 4 pixel groups of this row
      uint32_t b[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16* p =
            xs + ((warp + dy) * XC + 8 * n + g + dx) * CKP + 2 * t;
        b[n][0] = *reinterpret_cast<const uint32_t*>(p);
        b[n][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // A operand: 16 co x 16 ci of this tap
        const __nv_bfloat16* p = ws + (tap * CO + 16 * m + g) * CKP + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(p);
        a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * CKP);
        a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * CKP + 8);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n]);
      }
    }
  }

  // epilogue: thread (g, t) holds, per tile, channels g and g+8 at the two
  // pixels 2t and 2t+1
  __nv_bfloat16* oimg = out + (size_t)d * Cout * plane;
  const bool paired = (W & 1) == 0;   // then every pair is aligned
  const int y = y0 + warp;
  if (y < H) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int co = co0 + 16 * m + g + 8 * hrow;
        if (co >= Cout) continue;
        const float s = shift != nullptr ? shift[co] : 0.0f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int px = x0 + 8 * n + 2 * t;
          if (px >= W) continue;
          float v0 = acc[m][n][2 * hrow], v1 = acc[m][n][2 * hrow + 1];
          if (shift != nullptr) {
            v0 = fmaxf(v0 + s, 0.0f);
            v1 = fmaxf(v1 + s, 0.0f);
          }
          store_pair(oimg, (size_t)co * plane + (size_t)(y + 1) * W + px, v0,
                     v1, px + 1 < W, paired);
        }
      }
    }
  }
  // the output's halo rows, by the blocks of the first and last tile row
  const bool top = blockIdx.y == 0, bottom = blockIdx.y == gridDim.y - 1;
  if (top || bottom) {
    for (int item = tid; item < CO * TW; item += THREADS) {
      const int co = co0 + item / TW, px = x0 + item % TW;
      if (co >= Cout || px >= W) continue;
      __nv_bfloat16* p = oimg + (size_t)co * plane + px;
      if (top) p[0] = zero;
      if (bottom) p[(size_t)(H + 1) * W] = zero;
    }
  }
}

template <int MT>
void launch(const void* x, const void* w, const float* shift, void* out,
            int D, int Cin, int Cout, int H, int W, cudaStream_t stream) {
  const int co_chunks = (Cout + 16 * MT - 1) / (16 * MT);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, D * co_chunks);
  conv_cmajor_kernel<MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), shift,
      static_cast<__nv_bfloat16*>(out), Cin, Cout, H, W, co_chunks);
}

}  // namespace

// x (D, Cin, (H+2)*W) bf16, w (9, Cout, Cin) bf16, shift (Cout) f32 or null
// (null: no epilogue), out (D, Cout, (H+2)*W) bf16.
// The caller keeps D * ceil(Cout / 64) and ceil(H / 8) within 65535.
extern "C" int qea_conv_cmajor(const void* x, const void* w,
                               const float* shift, void* out, int D, int Cin,
                               int Cout, int H, int W, cudaStream_t stream) {
  if (Cout <= 16)
    launch<1>(x, w, shift, out, D, Cin, Cout, H, W, stream);
  else if (Cout <= 32)
    launch<2>(x, w, shift, out, D, Cin, Cout, H, W, stream);
  else
    launch<4>(x, w, shift, out, D, Cin, Cout, H, W, stream);
  return (int)cudaGetLastError();
}

extern "C" const char* qea_conv_cmajor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
