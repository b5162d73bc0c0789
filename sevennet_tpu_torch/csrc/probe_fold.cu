// K-fold probes: the sum over a receiver's K neighbour slots of a dim_mid
// tile, alone, at the engine's shapes, on the CUDA cores or the tensor
// cores.
//
// Replaces the Pallas TPU probe scripts_dev/r3_fold_probe.py:make (pallas_call
// at :85, kernel :51-83). Input x (NB T, DX), T = A K, DX = DM / 8: block b
// holds the rows b T + k A + a, slot k of receiver b A + a (the TPU's
// k-major rows). Output (NB A, DM):
//   out[b A + a, c] = sum over k of x[b T + k A + a, cmap[c]],
// where cmap is the script's column map, given by the host: for the tile
// variants (roll, mxu2, mxu3) output column start + j of a tile of mul rows
// reads input column (start / 8 + j) mod DX (:54-60, tiles of MULS, :22);
// for bigroll column r reads r mod DX (:79-82). The variants:
//   roll, bigroll  the sum over k in the script's halving order (_kfold,
//                  :36-49: halve while the count is even, peel the last slot
//                  onto the first while it is odd: 72 -> 36 -> 18 -> 9 -> 8
//                  -> 4 -> 2 -> 1) in fp32 on the CUDA cores
//                  (probe_fold_roll_kernel<K>);
//   mxu2, mxu3     the product with the 0/1 matrix fold (T, A), fold[t][t
//                  mod A] = 1, on the tensor cores: each x split into 2 or 3
//                  bf16 pieces (round to nearest even, x - hi rounded again,
//                  :63-77), bf16 mma.sync.m16n8k16 with fp32 accumulation
//                  (probe_fold_mma_kernel<PIECES>). The 0/1 products are
//                  exact; the sum runs in another order than the script's.
//
// roll: one CTA per (a, b) stages the K input rows of receiver b A + a (K
// DX floats, 113 KB at the script's shape: two CTAs an SM) by cp.async; a
// thread folds output column c from the column cmap[c] of the slab, its K
// values in registers, in the halving order, with explicit adds (K a
// template argument, so every index is fixed at compile time). Every
// output column is folded, as the TPU folds every tile: 8 output columns
// read each input column.
// mxu: the product is out^T[a, c] = sum_t fold[t][a] x[b T + t][cmap[c]],
// M = A (fold^T the A operand, 2 m16 tiles at A 32), N = the output
// columns (n8 tiles), K = t. One CTA per (block b, 784 output columns): 14
// warps, each 7 n8 tiles and every m16 tile (56 fp32 accumulators a
// thread), over t in stages of FM_TK rows of all DX input columns and of
// fold, double-buffered by cp.async. The rows are padded to DXP = 4 mod 8
// floats, which keeps the B fragments' four rows (t, t + 1, t + 8, t + 9
// of 2 tig) on distinct banks. The product is dense, as the TPU's MXU
// runs it: 2 A T DM multiply-adds a block and piece.
// What bounds them on an H100: HBM (1.154 GB in, 125.6 MB out at the
// script's shape, 0.38 ms); mxu3's 0.43 TFLOP of bf16 products come near
// it.
#include <cuda_bf16.h>

#include "fused_conv_common.cuh"

#define FR_NT 256
#define FM_WARPS 14
#define FM_NTW 7     // n8 tiles of a warp
#define FM_MT 2      // m16 tiles: A <= 32
#define FM_TK 32     // rows of t a stage holds
#define FM_NT (FM_WARPS * 32)
#define FM_COLS (FM_WARPS * FM_NTW * 8)  // output columns of a CTA

struct FoldArgs {
  const float* x;     // (NB T, DX)
  const float* fold;  // (T, A)
  const int* cmap;    // (DM,)
  float* out;         // (NB A, DM)
  int NB, K, A, DX, DM;
};

// the script's halving order on v[0 .. KC): the sum lands in v[0]
template <int KC, int KM>
__device__ __forceinline__ void kfold(float (&v)[KM]) {
  if constexpr (KC > 1) {
    if constexpr (KC % 2 == 0) {
#pragma unroll
      for (int k = 0; k < KC / 2; ++k) v[k] = __fadd_rn(v[k], v[k + KC / 2]);
      kfold<KC / 2>(v);
    } else {
      v[0] = __fadd_rn(v[0], v[KC - 1]);
      kfold<KC - 1>(v);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(FR_NT) probe_fold_roll_kernel(FoldArgs p) {
  extern __shared__ float slab[];  // K x DX: the receiver's K input rows
  const int a = blockIdx.x, b = blockIdx.y;
  const int dx4 = p.DX >> 2;
  const float* in = p.x + ((size_t)b * K * p.A + a) * p.DX;
  for (int i = threadIdx.x; i < K * dx4; i += FR_NT) {
    const int k = i / dx4, c = i - k * dx4;
    cp_async16(slab + k * p.DX + 4 * c, in + (size_t)k * p.A * p.DX + 4 * c, 16);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  float* o = p.out + ((size_t)b * p.A + a) * p.DM;
  for (int c = threadIdx.x; c < p.DM; c += FR_NT) {
    const int ci = __ldg(p.cmap + c);
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = slab[k * p.DX + ci];
    kfold<K>(v);
    o[c] = v[0];
  }
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *(unsigned*)&h;
}

// bf16 c (16 x 8) += a (16 x 16) b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the pieces of x: x rounded to bf16, then what is left, rounded again
template <int PIECES>
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16 (&q)[PIECES]) {
  float r = x;
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    q[i] = __float2bfloat16_rn(r);
    if (i + 1 < PIECES) r = __fsub_rn(r, __bfloat162float(q[i]));
  }
}

__host__ __device__ inline int fold_dxp(int dx) { return dx % 8 == 4 ? dx : dx + 4; }

template <int PIECES>
__global__ void __launch_bounds__(FM_NT) probe_fold_mma_kernel(FoldArgs p) {
  extern __shared__ float sm[];  // 2 stages of FM_TK x DXP input rows, then 2 of FM_TK x A fold rows
  const int DXP = fold_dxp(p.DX), T = p.K * p.A, b = blockIdx.y;
  float* xs = sm;
  float* fs = sm + 2 * FM_TK * DXP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n_mt = p.A / 16;
  int ci[FM_NTW];
  bool on[FM_NTW];
#pragma unroll
  for (int j = 0; j < FM_NTW; ++j) {
    const int c = blockIdx.x * FM_COLS + (warp * FM_NTW + j) * 8 + gid;
    on[j] = c - gid < p.DM;  // the n8 tile starts inside DM (DM a multiple of 8)
    ci[j] = on[j] ? __ldg(p.cmap + c) : 0;
  }
  float acc[FM_MT][FM_NTW][4];
#pragma unroll
  for (int m = 0; m < FM_MT; ++m)
#pragma unroll
    for (int j = 0; j < FM_NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

  const float* xb = p.x + (size_t)b * T * p.DX;
  const int n_stage = (T + FM_TK - 1) / FM_TK;
  auto stage = [&](int st) {
    const int t0 = st * FM_TK, rows = min(FM_TK, T - t0);
    float* xd = xs + (st & 1) * FM_TK * DXP;
    float* fd = fs + (st & 1) * FM_TK * p.A;
    const int dx4 = p.DX >> 2, a4 = p.A >> 2;
    for (int i = threadIdx.x; i < rows * dx4; i += FM_NT) {
      const int r = i / dx4, c = i - r * dx4;
      cp_async16(xd + r * DXP + 4 * c, xb + (size_t)(t0 + r) * p.DX + 4 * c, 16);
    }
    for (int i = threadIdx.x; i < rows * a4; i += FM_NT)
      cp_async16(fd + 4 * i, p.fold + (size_t)t0 * p.A + 4 * i, 16);
    cp_async_commit();
  };
  stage(0);
#pragma unroll 1
  for (int st = 0; st < n_stage; ++st) {
    if (st + 1 < n_stage) stage(st + 1);
    cp_async_wait(st + 1 < n_stage ? 1 : 0);
    __syncthreads();
    const float* xd = xs + (st & 1) * FM_TK * DXP;
    const float* fd = fs + (st & 1) * FM_TK * p.A;
    const int rows = min(FM_TK, T - st * FM_TK);
#pragma unroll 1
    for (int k0 = 0; k0 < rows; k0 += 16) {
      // A = fold^T: A[m][k] = fold[k0 + k][16 mt + m], exact in bf16
      unsigned af[FM_MT][4];
#pragma unroll
      for (int m = 0; m < FM_MT; ++m) {
        if (m >= n_mt) continue;  // the fold stage holds A columns
        const int a0 = 16 * m + gid;
        const float* f0 = fd + (k0 + 2 * tig) * p.A;
        const float* f8 = f0 + 8 * p.A;
        af[m][0] = pack_bf16(__float2bfloat16_rn(f0[a0]), __float2bfloat16_rn(f0[p.A + a0]));
        af[m][1] = pack_bf16(__float2bfloat16_rn(f0[a0 + 8]), __float2bfloat16_rn(f0[p.A + a0 + 8]));
        af[m][2] = pack_bf16(__float2bfloat16_rn(f8[a0]), __float2bfloat16_rn(f8[p.A + a0]));
        af[m][3] = pack_bf16(__float2bfloat16_rn(f8[a0 + 8]), __float2bfloat16_rn(f8[p.A + a0 + 8]));
      }
#pragma unroll
      for (int j = 0; j < FM_NTW; ++j) {
        if (!on[j]) continue;
        // B[k][n] = x[t0 + k0 + k][cmap[c_n]]: this lane's k = 2 tig, 2 tig + 1, + 8, + 9
        const float* col = xd + (k0 + 2 * tig) * DXP + ci[j];
        __nv_bfloat16 q0[PIECES], q1[PIECES], q2[PIECES], q3[PIECES];
        split_bf16<PIECES>(col[0], q0);
        split_bf16<PIECES>(col[DXP], q1);
        split_bf16<PIECES>(col[8 * DXP], q2);
        split_bf16<PIECES>(col[9 * DXP], q3);
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const unsigned bf[2] = {pack_bf16(q0[q], q1[q]), pack_bf16(q2[q], q3[q])};
#pragma unroll
          for (int m = 0; m < FM_MT; ++m)
            if (m < n_mt) mma_bf16(acc[m][j], af[m], bf);
        }
      }
    }
    __syncthreads();  // the stage is read out before it is refilled
  }
#pragma unroll
  for (int m = 0; m < FM_MT; ++m) {
    if (m >= n_mt) continue;
#pragma unroll
    for (int j = 0; j < FM_NTW; ++j) {
      if (!on[j]) continue;
      const int c = blockIdx.x * FM_COLS + (warp * FM_NTW + j) * 8 + 2 * tig;
      float* o = p.out + ((size_t)b * p.A + 16 * m + gid) * p.DM + c;
      *(float2*)o = make_float2(acc[m][j][0], acc[m][j][1]);
      *(float2*)(o + 8 * (size_t)p.DM) = make_float2(acc[m][j][2], acc[m][j][3]);
    }
  }
}

template <int K>
static int launch_roll(const FoldArgs& p, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];  // one per instance
  const size_t smem = sizeof(float) * K * p.DX;
  cudaError_t err = raise_smem_limit((const void*)probe_fold_roll_kernel<K>, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  probe_fold_roll_kernel<K><<<dim3(p.A, p.NB), FR_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int PIECES>
static int launch_mma(const FoldArgs& p, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];
  const size_t smem = sizeof(float) * 2 * FM_TK * (fold_dxp(p.DX) + p.A);
  cudaError_t err = raise_smem_limit((const void*)probe_fold_mma_kernel<PIECES>, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  probe_fold_mma_kernel<PIECES><<<dim3((p.DM + FM_COLS - 1) / FM_COLS, p.NB), FM_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// variant: 0 roll / bigroll (their column maps differ), 2 or 3: mxu2, mxu3.
// roll: K one of FOLD_KS (probes/fold.py), K DX floats of shared memory.
// mxu: A 16 or 32. Both: DX a multiple of 4, DM of 8, the pointers 16-byte
// aligned, every cmap entry in [0, DX) (not checked here).
extern "C" int probe_fold_launch(int pieces, FoldArgs p, void* stream) {
  if (p.NB <= 0 || p.NB > 65535 || p.K <= 0 || p.A <= 0 || p.DX <= 0 || p.DX % 4 ||
      p.DM <= 0 || p.DM % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pieces == 0) {
    switch (p.K) {
      case 8: return launch_roll<8>(p, s);
      case 9: return launch_roll<9>(p, s);
      case 72: return launch_roll<72>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (p.A % 16 || p.A > 16 * FM_MT) return (int)cudaErrorInvalidValue;
  if (pieces == 2) return launch_mma<2>(p, s);
  if (pieces == 3) return launch_mma<3>(p, s);
  return (int)cudaErrorInvalidValue;
}
