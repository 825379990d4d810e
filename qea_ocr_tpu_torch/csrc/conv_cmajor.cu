// Channel-major 3x3 SAME convolution on padded-flat activations:
//
//   Y[d, co, y, x] = sum_{dy, dx, ci} Wt[dy, dx, ci, co] * X[d, ci, y+dy-1, x+dx-1]
//
// with bfloat16 operands, float32 accumulation, an optional epilogue
// relu(y + shift[co]) on the accumulator, and a bfloat16 output.
// Activations are (D, C, (H+2)*W): every channel plane carries one halo row
// above and one below the image. The input's halo rows are never read (they
// count as zeros, whatever they hold); the output's halo rows are written as
// zeros. Any Cin >= 1, Cout and H; W % 8 == 0 (TMA wants 16-byte strides).
//
// Replaces: qea_ocr_tpu/ops/pallas/conv_cmajor.py `_kernel` (TPU). The TPU
// kernel put the whole image plane on the 128-lane axis, took the vertical
// taps as lane-offset views of one double-buffered DMA band and rolled
// partial outputs for the horizontal taps, so it needed W % 128 == 0 and a
// tile height that divides H. None of that is carried over.
//
// Bound, on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense, 295 FLOP a byte):
// a 3x3 conv does 9*Cin FLOP-pairs per output value, so with Cout = 32 it
// does ~144 FLOP per byte it must move and device-memory bytes bound it
// (enc1.2, 32 -> 32 at 400x512, D=8: 210 MB, 0.063 ms); at 128 -> 64
// (dec2.1) it is the tensor cores (60 GFLOP, 0.061 ms). So the products run
// on `wgmma`, and the input is read from device memory once per block
// (the overlap of neighbouring blocks, 2 rows and 16 pixels, is served by
// the L2).
//
// Design: an implicit GEMM per block with M = 64 consecutive pixels of one
// image row, N = output channels (16, 32, 64, 128 or 256: Cout rounded up,
// more than 256 go to further blocks) and K = 16 input channels of one tap.
// A block owns R rows x 64 columns x N channels; it is 2 consumer
// warpgroups of R/2 rows each (accumulators in registers, R/2 x N/2 floats
// a thread) and 1 producer warp.
//  * Three copies of the tile. `wgmma` reads A through a descriptor whose
//    start is 16-byte aligned, so a horizontal tap (one pixel, 2 bytes)
//    cannot be a shifted view of one staged tile; TMA, too, faults on a
//    start in the innermost dimension that is not 16-byte aligned (measured:
//    illegal instruction). So per chunk of 16 input channels the producer
//    loads by TMA the centre copy (64 pixels at x0, R+2 rows) and the 8
//    pixels left and right of it; the consumers build copies 0 and 2
//    (X[px-1] and X[px+1]) from them in shared memory, one 128-byte line
//    a thread with byte permutes, while the previous chunk's products run.
//    The tensor map spans the padded-flat tensor from image row 0 with dims
//    (W, C, H, D) and a box (64, 16, R+2, 1), so shared memory holds
//    [row][ci][64 px] with the 128-byte swizzle: a row's 16 channels are two
//    whole swizzle atoms, and a vertical tap is an atom-aligned offset. The
//    A operand of tap (dy, dx) for block row r is copy dx at row r+dy, read
//    MN-major (pixels contiguous). Rows -1 and H, columns beyond 0..W-1 and
//    channels >= Cin lie outside the map, so TMA fills them with zeros: the
//    input's halo rows are never read and the product loop has no masks.
//  * Weights: the wrapper packs them, zero-padded, as (9, ceil(Cin/16),
//    Cout8, 16) bf16; one 4-d TMA per chunk brings the 9 taps' [N][16]
//    K-major tiles of this block's channels (32-byte swizzle).
//  * Pipeline: 2 stages on mbarriers (full: TMA bytes landed; empty: both
//    warpgroups' products on the stage are done). The producer keeps the
//    next chunk in flight; a consumer builds chunk c's copies, issues its
//    9 x R/2 `wgmma`s, commits, and waits only for chunk c-1's group before
//    releasing that stage.
//  * Epilogue: shift + ReLU on the accumulators in registers, then a bf16
//    tile [row][co][64 px] in the (now free) stage memory, padded to a
//    144-byte line so the fragment's scattered 2-byte stores hit distinct
//    banks, then 16-byte coalesced stores of whole 128-byte pixel runs (a
//    fragment's neighbouring values are channels, a plane apart in this
//    layout). The first and last tile row's blocks zero the halo rows.
// Shared memory: 2 stages of 3(R+2)*2 KB + 2(R+2)*256 + 9*N*32 bytes
// (R = 8 for N <= 64: 141-167 KB), so one block an SM. Registers: ptxas
// gives a thread at most 168, what 12 warps (3 whole warpgroups, not the 9
// warps launched) leave; at N >= 64 it spills 56 bytes (`chip_smoke.py`
// logs `-Xptxas -v`).
// Not done here: persistent blocks, clusters and TMA multicast of the
// weights.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int PX = 64;                    // pixels of one wgmma (M)
constexpr int CK = 16;                    // input channels a chunk (K)
constexpr int LINE = PX * 2;              // bytes of one channel's 64 pixels
constexpr int ROWB = CK * LINE;           // one staged row: 16 lines, 2 KB
constexpr int STAGES = 2;
constexpr int NWG = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * NWG + 32;   // + one producer warp
constexpr int EP_LINE = LINE + 16;        // epilogue line stride, bytes

// rows a consumer warpgroup owns for a block of N channels
__host__ __device__ constexpr int rows_per_wg(int n) {
  return n >= 256 ? 1 : n >= 128 ? 2 : 4;
}

template <int N>
struct Tile {
  static constexpr int RW = rows_per_wg(N);
  static constexpr int R = NWG * RW;                 // rows of the block
  static constexpr int COPYB = (R + 2) * ROWB;       // one staged copy
  static constexpr int HB = (R + 2) * CK * 16;       // one 8-pixel halo
  static constexpr int HOFF = 3 * COPYB;             // the two halos
  static constexpr int WOFF = HOFF + 2 * HB;         // the weights
  static constexpr int WB = 9 * N * CK * 2;          // the 9 taps' weights
  static constexpr int TX = COPYB + 2 * HB + WB;     // TMA bytes a chunk
  static constexpr int STAGEB = (WOFF + WB + 1023) / 1024 * 1024;
  static constexpr int EPB = R * N * EP_LINE;        // epilogue tile
  static constexpr int MAINB = STAGES * STAGEB > EPB ? STAGES * STAGEB : EPB;
  // + 1 KB to align the base to the 128-byte swizzle's 1 KB atom
  static constexpr int SMEM = 1024 + MAINB + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// layout (1: 128-byte swizzle, 3: 32-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// the shifted copies of one staged line (one row, one channel): copy 0
// holds X[px - 1], copy 2 X[px + 1], both in the 128-byte swizzle the
// centre copy landed in; `left` is the word whose high half is X[-1],
// `right` the word whose low half is X[64]
__device__ __forceinline__ void shift_line(const uint8_t* centre, uint8_t* c0,
                                           uint8_t* c2, int line,
                                           uint32_t left, uint32_t right) {
  uint4 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = *reinterpret_cast<const uint4*>(centre + ((j ^ (line & 7)) << 4));
  // (a, b) -> high half of a, then low half of b: one pixel to the left
  auto cat = [](uint32_t a, uint32_t b) { return __byte_perm(a, b, 0x5432); };
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t prev = j == 0 ? left : v[j - 1].w;
    const uint32_t next = j == 7 ? right : v[j + 1].x;
    const int at = (j ^ (line & 7)) << 4;
    *reinterpret_cast<uint4*>(c0 + at) = make_uint4(
        cat(prev, v[j].x), cat(v[j].x, v[j].y), cat(v[j].y, v[j].z),
        cat(v[j].z, v[j].w));
    *reinterpret_cast<uint4*>(c2 + at) = make_uint4(
        cat(v[j].x, v[j].y), cat(v[j].y, v[j].z), cat(v[j].z, v[j].w),
        cat(v[j].w, next));
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 pixels x N channels, f32) += A (64 x 16, MN-major) * B (16 x N,
// K-major), scale-d 1, A transposed
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 16) wgmma_n16(d, da, db);
  else if constexpr (N == 32) wgmma_n32(d, da, db);
  else if constexpr (N == 64) wgmma_n64(d, da, db);
  else if constexpr (N == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// xmap: the input, dims (W, Cin, H, D) from image row 0, box (64, 16, R+2,
// 1), 128-byte swizzle; hmap: the same with box (8, 16, R+2, 1), no
// swizzle; wmap: the packed weights, dims (16, Cout8, ceil(Cin/16), 9), box
// (16, N, 1, 9), 32-byte swizzle; shift (Cout) f32 or null; out (D, Cout,
// (H+2)*W) bf16.
// grid (ceil(W/64), ceil(H/R), D * co_blocks), THREADS threads.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
conv_cmajor_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ shift,
                   __nv_bfloat16* __restrict__ out, int Cin, int Cout, int H,
                   int W, int co_blocks) {
  using T = Tile<N>;
  constexpr int RW = T::RW, R = T::R;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full0 = base + T::MAINB;          // full[s], then empty[s]
  auto full = [&](int s) { return full0 + 8 * s; };
  auto empty = [&](int s) { return full0 + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int nch = (Cin + CK - 1) / CK;
  const int x0 = blockIdx.x * PX, y0 = blockIdx.y * R;
  const int d = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - d * co_blocks) * N;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // the producer: one thread keeps the next chunk's copies in flight
    if (tid == 128 * NWG) {
      for (int c = 0; c < nch; ++c) {
        const int s = c % STAGES, k = c / STAGES;
        if (k > 0) mbar_wait(empty(s), (k - 1) & 1);
        const uint32_t stage = base + s * T::STAGEB;
        mbar_expect_tx(full(s), T::TX);
        // the centre copy, then the 8 pixels left and right of it: TMA
        // takes only 16-byte aligned starts in the innermost dimension
        tma_load_4d(stage + T::COPYB, &xmap, x0, c * CK, y0 - 1, d, full(s));
        tma_load_4d(stage + T::HOFF, &hmap, x0 - 8, c * CK, y0 - 1, d,
                    full(s));
        tma_load_4d(stage + T::HOFF + T::HB, &hmap, x0 + PX, c * CK, y0 - 1,
                    d, full(s));
        tma_load_4d(stage + T::WOFF, &wmap, 0, co0, c, 0, full(s));
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns block rows wg*RW .. wg*RW+RW-1
  const int wg = tid >> 7, t = tid & 127;
  float acc[RW][N / 2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.0f;
#pragma unroll
  for (int r = 0; r < RW; ++r) fence_regs(acc[r]);

  for (int c = 0; c < nch; ++c) {
    const int s = c % STAGES;
    mbar_wait(full(s), (c / STAGES) & 1);
    const uint32_t stage = base + s * T::STAGEB;
    // build copies 0 and 2 from the centre and the halos, one staged line
    // (row, channel) a thread, while chunk c-1's products still run
    uint8_t* const gs = gbase + s * T::STAGEB;
    for (int line = tid; line < (R + 2) * CK; line += 128 * NWG)
      shift_line(gs + T::COPYB + line * LINE, gs + line * LINE,
                 gs + 2 * T::COPYB + line * LINE, line,
                 *reinterpret_cast<const uint32_t*>(gs + T::HOFF + 16 * line +
                                                    12),
                 *reinterpret_cast<const uint32_t*>(gs + T::HOFF + T::HB +
                                                    16 * line));
    // generic stores, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(128 * NWG) : "memory");
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      // B: the tap's [N][16] tile, 8-row groups 256 bytes apart
      const uint64_t db = desc(stage + T::WOFF + tap * N * CK * 2, 16, 256, 3);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        // A: copy dx at block row wg*RW + r + dy (one row below the top
        // halo row the copy starts at): 2 atoms of 8 channels, 1 KB apart
        const uint32_t a = stage + dx * T::COPYB + (wg * RW + r + dy) * ROWB;
        wgmma<N>(acc[r], desc(a, 1024, 1024, 1), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();           // chunk c-1's products are done
    if (c > 0 && t == 0) mbar_arrive(empty((c - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < RW; ++r) fence_regs(acc[r]);
  // both warpgroups are done with the stages: reuse them for the epilogue
  asm volatile("bar.sync 1, %0;" ::"n"(128 * NWG) : "memory");

  // thread t holds, per 8-channel group i, pixels p and p+8 (p = 16*warp +
  // lane/4) of channels 8i + 2*(lane%4) and the one after
  const int warp = t >> 5, lane = t & 31;
  const int p = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    uint8_t* ep = gbase + (wg * RW + r) * N * EP_LINE;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 8 * i + cq + (e & 1), px = p + 8 * (e >> 1);
        float v = acc[r][4 * i + e];
        if (shift != nullptr) {
          const float sh = co0 + co < Cout ? shift[co0 + co] : 0.0f;
          v = fmaxf(v + sh, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat16*>(ep + co * EP_LINE + 2 * px) =
            __float2bfloat16_rn(v);
      }
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(128 * NWG) : "memory");

  // 16-byte stores: item = (row, co, 8-pixel run); W % 8 == 0, so a run is
  // inside the image or outside it whole
  const size_t plane = (size_t)(H + 2) * W;
  __nv_bfloat16* const oimg = out + (size_t)d * Cout * plane;
  for (int item = tid; item < R * N * 8; item += 128 * NWG) {
    const int q = item & 7, co = (item >> 3) % N, r = item / (8 * N);
    const int y = y0 + r, gco = co0 + co, px = x0 + 8 * q;
    if (y < H && gco < Cout && px < W)
      *reinterpret_cast<uint4*>(oimg + gco * plane + (size_t)(y + 1) * W +
                                px) =
          *reinterpret_cast<const uint4*>(gbase + (r * N + co) * EP_LINE +
                                          16 * q);
  }
  // the output's halo rows, by the blocks of the first and last tile row
  const bool top = y0 == 0, bottom = y0 + R >= H;
  if (top || bottom) {
    for (int item = tid; item < N * 8; item += 128 * NWG) {
      const int q = item & 7, gco = co0 + (item >> 3), px = x0 + 8 * q;
      if (gco >= Cout || px >= W) continue;
      __nv_bfloat16* const pl = oimg + gco * plane + px;
      if (top) *reinterpret_cast<uint4*>(pl) = make_uint4(0, 0, 0, 0);
      if (bottom)
        *reinterpret_cast<uint4*>(pl + (size_t)(H + 1) * W) =
            make_uint4(0, 0, 0, 0);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's encoder, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

char error_text[160];

// codes below 0 are this file's own; others are cudaError_t
int encode_error(const char* what, int rc) {
  snprintf(error_text, sizeof error_text,
           "cuTensorMapEncodeTiled refused the %s map (CUresult %d)", what, rc);
  return -1;
}

template <int N>
int launch(const void* x, const void* wp, const float* shift, void* out,
           int D, int Cin, int Cout, int H, int W, cudaStream_t stream) {
  using T = Tile<N>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) {
    snprintf(error_text, sizeof error_text,
             "the driver has no cuTensorMapEncodeTiled");
    return -1;
  }
  const int nch = (Cin + CK - 1) / CK, cout8 = (Cout + 7) / 8 * 8;
  const cuuint64_t plane = (cuuint64_t)(H + 2) * W;
  CUtensorMap xmap, hmap, wmap;
  for (int halo = 0; halo < 2; ++halo) {
    // from image row 0 of channel 0 of document 0: rows -1 and H are
    // outside the map, so the halo rows are never read
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)Cin,
                                (cuuint64_t)H, (cuuint64_t)D};
    const cuuint64_t strides[3] = {2 * plane, 2 * (cuuint64_t)W,
                                   2 * plane * Cin};
    const cuuint32_t box[4] = {halo ? 8u : (cuuint32_t)PX, CK, T::R + 2, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult rc = encode(
        halo ? &hmap : &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
        const_cast<__nv_bfloat16*>(static_cast<const __nv_bfloat16*>(x)) + W,
        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
        halo ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return encode_error("input", (int)rc);
  }
  {
    const cuuint64_t dims[4] = {CK, (cuuint64_t)cout8, (cuuint64_t)nch, 9};
    const cuuint64_t strides[3] = {2 * CK, 2 * CK * (cuuint64_t)cout8,
                                   2 * CK * (cuuint64_t)cout8 * nch};
    const cuuint32_t box[4] = {CK, N, 1, 9};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult rc = encode(
        &wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(wp),
        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return encode_error("weight", (int)rc);
  }
  static bool sized = false;
  if (!sized) {
    const cudaError_t rc = cudaFuncSetAttribute(
        conv_cmajor_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    sized = true;
  }
  const int co_blocks = (Cout + N - 1) / N;
  const dim3 grid((W + PX - 1) / PX, (H + T::R - 1) / T::R, D * co_blocks);
  conv_cmajor_kernel<N><<<grid, THREADS, T::SMEM, stream>>>(
      xmap, hmap, wmap, shift, static_cast<__nv_bfloat16*>(out), Cin, Cout,
      H, W, co_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (D, Cin, (H+2)*W) bf16, 16-byte aligned; wp the packed weights (9,
// ceil(Cin/16), ceil(Cout/8)*8, 16) bf16, zero-padded; shift (Cout) f32 or
// null (null: no epilogue); out (D, Cout, (H+2)*W) bf16. Cin >= 1,
// W % 8 == 0; the caller keeps D * ceil(Cout / N) and ceil(H / R) within
// 65535 (N and R as `Tile` chooses them; `ops/cuda/conv_cmajor_cuda.py`
// keeps the same table).
extern "C" int qea_conv_cmajor(const void* x, const void* wp,
                               const float* shift, void* out, int D, int Cin,
                               int Cout, int H, int W, cudaStream_t stream) {
  if (Cout <= 16)
    return launch<16>(x, wp, shift, out, D, Cin, Cout, H, W, stream);
  if (Cout <= 32)
    return launch<32>(x, wp, shift, out, D, Cin, Cout, H, W, stream);
  if (Cout <= 64)
    return launch<64>(x, wp, shift, out, D, Cin, Cout, H, W, stream);
  if (Cout <= 128)
    return launch<128>(x, wp, shift, out, D, Cin, Cout, H, W, stream);
  return launch<256>(x, wp, shift, out, D, Cin, Cout, H, W, stream);
}

extern "C" const char* qea_conv_cmajor_error_string(int code) {
  return code < 0 ? error_text : cudaGetErrorString((cudaError_t)code);
}
