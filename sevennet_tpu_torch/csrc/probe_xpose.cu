// Transpose probes: 32 x 32 tiles through shared memory, laid out so that
// the tile's column reads are free of bank conflicts.
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
// A transpose is a shared-memory write by rows and a read by columns: the
// 32 lanes of a warp read 32 rows of one column. Two layouts of the tile
// keep those reads on 32 banks: PAD 1 puts its rows 33 floats apart; PAD 0
// keeps them 32 apart (unpadded) and stores element (r, c) at column
// c ^ r, a 4-byte XOR swizzle (xp_at), under which a row and a column both
// cover every bank once. (Row-major at 32 floats, a column would sit in
// one bank: a 32-way conflict, which the PAD 0 form paid before the
// swizzle.)
//
// probe_xpose_kernel: a CTA of 256 threads owns one tile; thread (ty, tx)
// holds rows ty, ty + 8, ty + 16, ty + 24 at column tx, read and written
// 128 bytes a warp. XP_CARRY runs the transpose XP_REP times on a tile
// held in registers (each rep scales it first, as the script does);
// XP_XPOSE transposes it once; XP_ROUND_TRIP at PAD 1 transposes it into
// the registers' transposed orientation and back before it stores it.
//
// probe_xpose_rt_kernel, XP_ROUND_TRIP at PAD 0: a CTA owns 32 rows x 128
// columns (four swizzled tiles) and moves them with 16-byte accesses where
// the columns and pointers allow (VEC): every thread issues its four loads
// before it touches shared memory, so that an SM keeps about 64 bytes a
// thread in flight. The tile goes through shared memory twice: written by
// rows (16-byte stores, each float4's lanes permuted by the swizzle) and
// read by columns into registers (x transposed), written back by rows of
// the transpose and read by its columns, four scalars a float4 of the
// output (a warp's quarter over 4 rows x 8 float4s, on 32 banks). What
// bounds the round trip on an H100 is then HBM (629 MB at the script's
// shape), as for XP_XPOSE.
#include <cuda_runtime.h>

#define XP_TILE 32
#define XP_NT 256
#define XP_J (XP_TILE * XP_TILE / XP_NT)  // rows of the tile a thread holds
#define XP_REP 16  // XP_CARRY's reps (r2_pallas_mm.py:11; REP in probes/xpose.py)
#define XP_RT_TILES 4  // tiles side by side in a round-trip CTA at PAD 0

enum { XP_XPOSE = 0, XP_ROUND_TRIP = 1, XP_CARRY = 2 };

struct XposeArgs {
  const float* x;  // (R, C)
  const float* s;  // (1, 1): XP_CARRY's s
  float* out;      // (C, R); XP_ROUND_TRIP (R, C)
  int R, C;
};

// The place of tile element (r, c): rows 32 + PAD floats apart; at PAD 0
// column c ^ r.
template <int PAD>
__device__ __forceinline__ int xp_at(int r, int c) {
  return PAD ? r * (XP_TILE + PAD) + c : r * XP_TILE + (c ^ r);
}

template <int MODE, int PAD>
__global__ void __launch_bounds__(XP_NT) probe_xpose_kernel(XposeArgs p) {
  __shared__ float tile[XP_TILE * (XP_TILE + PAD)];
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
      for (int j = 0; j < XP_J; ++j) tile[xp_at<PAD>(ty + 8 * j, tx)] = __fmul_rn(v[j], f);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < XP_J; ++j)
        acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.5f), tile[xp_at<PAD>(tx, ty + 8 * j)]);
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
  for (int j = 0; j < XP_J; ++j) tile[xp_at<PAD>(ty + 8 * j, tx)] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < XP_J; ++j) v[j] = tile[xp_at<PAD>(tx, ty + 8 * j)];  // x[r0 + tx][c0 + ty + 8 j]
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
  for (int j = 0; j < XP_J; ++j) tile[xp_at<PAD>(ty + 8 * j, tx)] = v[j];  // the transposed tile
  __syncthreads();
#pragma unroll
  for (int j = 0; j < XP_J; ++j) {
    const int r = r0 + ty + 8 * j, c = c0 + tx;
    if (r < p.R && c < p.C) p.out[(size_t)r * p.C + c] = tile[xp_at<PAD>(tx, ty + 8 * j)];
  }
}

// XP_ROUND_TRIP at PAD 0 (see the top): CTA (bx, by) owns rows 32 by .. +31
// and columns 128 bx .. +127, tile t its columns 32 t .. +31. Warp w's
// access j: loads take row 4 w + j, float4 q = lane (tile lane / 8; the
// swizzle's permutation of a float4's lanes is then j, fixed), stores tile
// j, rows 4 w + lane / 8, float4 lane % 8. VEC: 16-byte global accesses
// (C % 4 == 0, x and out 16-byte aligned); else 4-byte ones, guarded
// element by element.
template <bool VEC>
__global__ void __launch_bounds__(XP_NT) probe_xpose_rt_kernel(XposeArgs p) {
  __shared__ __align__(16) float tile[XP_RT_TILES * XP_TILE * XP_TILE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.y * XP_TILE, c0 = blockIdx.x * XP_RT_TILES * XP_TILE;
  float4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 4 * w + j, c = c0 + 4 * lane;
    if (VEC) {
      v[j] = r < p.R && c < p.C ? __ldg(reinterpret_cast<const float4*>(p.x + (size_t)r * p.C + c))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[k] = r < p.R && c + k < p.C ? __ldg(p.x + (size_t)r * p.C + c + k) : 0.0f;
      v[j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  // the first transpose: rows in (element (r, c + k) of tile t at column
  // (c + k) ^ r = (c ^ (r & 28)) + (k ^ j), r % 4 = j) ...
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * w + j, t = lane >> 3, c = 4 * (lane & 7);
    const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    *reinterpret_cast<float4*>(tile + t * XP_TILE * XP_TILE + r * XP_TILE + (c ^ (r & 28))) =
        make_float4(e[0 ^ j], e[1 ^ j], e[2 ^ j], e[3 ^ j]);
  }
  __syncthreads();
  // ... columns out: u[t][i] = x[r0 + lane][c0 + 32 t + 4 w + i]
  float u[XP_RT_TILES][4];
#pragma unroll
  for (int t = 0; t < XP_RT_TILES; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[t][i] = tile[t * XP_TILE * XP_TILE + xp_at<0>(lane, 4 * w + i)];
  __syncthreads();  // the first transpose is read out before the second writes
  // the second: the transpose's rows in (row 4 w + i of tile t holds column
  // c0 + 32 t + 4 w + i of x) ...
#pragma unroll
  for (int t = 0; t < XP_RT_TILES; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tile[t * XP_TILE * XP_TILE + xp_at<0>(4 * w + i, lane)] = u[t][i];
  __syncthreads();
  // ... its columns out, x's rows again: four scalars a float4
#pragma unroll
  for (int j = 0; j < XP_RT_TILES; ++j) {
    const int rl = 4 * w + (lane >> 3), cl = 4 * (lane & 7);
    const float* tj = tile + j * XP_TILE * XP_TILE;
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = tj[xp_at<0>(cl + k, rl)];
    const int r = r0 + rl, c = c0 + XP_TILE * j + cl;
    if (VEC) {
      if (r < p.R && c < p.C)
        *reinterpret_cast<float4*>(p.out + (size_t)r * p.C + c) = make_float4(e[0], e[1], e[2], e[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r < p.R && c + k < p.C) p.out[(size_t)r * p.C + c + k] = e[k];
    }
  }
}

template <int MODE>
static int launch(int pad, const XposeArgs& p, cudaStream_t s) {
  const dim3 grid((p.C + XP_TILE - 1) / XP_TILE, (p.R + XP_TILE - 1) / XP_TILE);
  if (pad) {
    probe_xpose_kernel<MODE, 1><<<grid, XP_NT, 0, s>>>(p);
  } else if constexpr (MODE == XP_ROUND_TRIP) {
    const dim3 g((p.C + XP_RT_TILES * XP_TILE - 1) / (XP_RT_TILES * XP_TILE), grid.y);
    const bool vec = p.C % 4 == 0 && ((size_t)p.x | (size_t)p.out) % 16 == 0;
    if (vec) probe_xpose_rt_kernel<true><<<g, XP_NT, 0, s>>>(p);
    else probe_xpose_rt_kernel<false><<<g, XP_NT, 0, s>>>(p);
  } else {
    probe_xpose_kernel<MODE, 0><<<grid, XP_NT, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// mode: XP_XPOSE, XP_ROUND_TRIP or XP_CARRY (XP_REP reps); pad: 1 float of
// padding a tile row, or 0 (the swizzled tile; the round trip's
// probe_xpose_rt_kernel).
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
