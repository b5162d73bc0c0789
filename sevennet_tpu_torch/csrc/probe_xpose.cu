// Transpose probes: 32 x 32 tiles through shared memory, with and without
// a pad that keeps the tile's column reads free of bank conflicts.
//
// Replaces three Pallas TPU probes:
//   - scripts_dev/r2_pallas_mm.py:transpose (pallas_call at :76, body
//     :68-73): a (m, n) resident, s (1, 1); acc (n, m) from 0, XP_REP reps of
//     acc = 0.5 acc + (a (1 + s i)).T (XP_CARRY);
//   - scripts_dev/r5_xpose_probe.py:xpose (pallas_call at :96, kernel :90):
//     (NK, dim_x) -> (dim_x, NK), streamed in blocks of T_b rows (XP_XPOSE);
//   - scripts_dev/r5_xpose_probe.py:xpose2 (pallas_call at :114, kernel
//     :111-112): in.T.T, a round trip through a transposed tile, the
//     backward's dxg (XP_ROUND_TRIP).
//
// A CTA of 256 threads owns one 32 x 32 tile of the input; thread (ty, tx)
// holds rows ty, ty + 8, ty + 16, ty + 24 at column tx, read and written
// 128 bytes a warp. A transpose is a shared-memory write by rows and a read
// by columns, tile[tx][ty + 8 j]: the 32 lanes of a warp read 32 rows of
// one column. With a row stride of 32 floats (PAD 0) they all hit one bank,
// a 32-way conflict; with 33 (PAD 1) 32 banks. XP_CARRY runs that
// transpose XP_REP times on a tile held in registers (each rep scales it
// first, as the script does); XP_ROUND_TRIP transposes the tile into the
// registers' transposed orientation and back before it stores it: two
// column reads, bitwise the input. What bounds them on an H100: HBM
// (XP_XPOSE and XP_ROUND_TRIP move 629 MB at the script's shape), and
// shared memory's column reads where the tile is not padded.
#include <cuda_runtime.h>

#define XP_TILE 32
#define XP_NT 256
#define XP_J (XP_TILE * XP_TILE / XP_NT)  // rows of the tile a thread holds
#define XP_REP 16  // XP_CARRY's reps (r2_pallas_mm.py:11; REP in probes/xpose.py)

enum { XP_XPOSE = 0, XP_ROUND_TRIP = 1, XP_CARRY = 2 };

struct XposeArgs {
  const float* x;  // (R, C)
  const float* s;  // (1, 1): XP_CARRY's s
  float* out;      // (C, R); XP_ROUND_TRIP (R, C)
  int R, C;
};

template <int MODE, int PAD>
__global__ void __launch_bounds__(XP_NT) probe_xpose_kernel(XposeArgs p) {
  __shared__ float tile[XP_TILE][XP_TILE + PAD];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.y * XP_TILE, c0 = blockIdx.x * XP_TILE;
  float v[XP_J];
#pragma unroll
  for (int j = 0; j < XP_J; ++j) {
    const int r = r0 + ty + 8 * j, c = c0 + tx;
    v[j] = r < p.R && c < p.C ? __ldg(p.x + (size_t)r * p.C + c) : 0.0f;
  }
  if (MODE == XP_CARRY) {
    // output element (c0 + ty + 8 j, r0 + tx) of the (C, R) result
    const float s = __ldg(p.s);
    float acc[XP_J] = {};
#pragma unroll 1
    for (int i = 0; i < XP_REP; ++i) {
      const float f = __fadd_rn(1.0f, __fmul_rn(s, (float)i));
#pragma unroll
      for (int j = 0; j < XP_J; ++j) tile[ty + 8 * j][tx] = __fmul_rn(v[j], f);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < XP_J; ++j)
        acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.5f), tile[tx][ty + 8 * j]);
      __syncthreads();  // every column is read before the next rep writes
    }
#pragma unroll
    for (int j = 0; j < XP_J; ++j) {
      const int c = c0 + ty + 8 * j, r = r0 + tx;
      if (c < p.C && r < p.R) p.out[(size_t)c * p.R + r] = acc[j];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < XP_J; ++j) tile[ty + 8 * j][tx] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < XP_J; ++j) v[j] = tile[tx][ty + 8 * j];  // x[r0 + tx][c0 + ty + 8 j]
  if (MODE == XP_XPOSE) {
#pragma unroll
    for (int j = 0; j < XP_J; ++j) {
      const int c = c0 + ty + 8 * j, r = r0 + tx;
      if (c < p.C && r < p.R) p.out[(size_t)c * p.R + r] = v[j];
    }
    return;
  }
  __syncthreads();  // the first transpose is read out before the second writes
#pragma unroll
  for (int j = 0; j < XP_J; ++j) tile[ty + 8 * j][tx] = v[j];  // the transposed tile
  __syncthreads();
#pragma unroll
  for (int j = 0; j < XP_J; ++j) {
    const int r = r0 + ty + 8 * j, c = c0 + tx;
    if (r < p.R && c < p.C) p.out[(size_t)r * p.C + c] = tile[tx][ty + 8 * j];
  }
}

template <int MODE>
static int launch(int pad, const XposeArgs& p, cudaStream_t s) {
  const dim3 grid((p.C + XP_TILE - 1) / XP_TILE, (p.R + XP_TILE - 1) / XP_TILE);
  if (pad) probe_xpose_kernel<MODE, 1><<<grid, XP_NT, 0, s>>>(p);
  else probe_xpose_kernel<MODE, 0><<<grid, XP_NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// mode: XP_XPOSE, XP_ROUND_TRIP or XP_CARRY (XP_REP reps); pad: 0 or 1
// float of padding a tile row.
extern "C" int probe_xpose_launch(int mode, int pad, XposeArgs p, void* stream) {
  if (p.R <= 0 || p.C <= 0 || (pad != 0 && pad != 1) ||
      (p.R + XP_TILE - 1) / XP_TILE > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == XP_XPOSE) return launch<XP_XPOSE>(pad, p, s);
  if (mode == XP_ROUND_TRIP) return launch<XP_ROUND_TRIP>(pad, p, s);
  if (mode == XP_CARRY) return launch<XP_CARRY>(pad, p, s);
  return (int)cudaErrorInvalidValue;
}
