// Fold-order probe of the emb/sh fused conv forward: the function of B4 fwd
// (radial MLP on emb, tmp = w3j_pack sh, the uvu terms, the sum over each
// receiver's K slots) as a plain fp32 kernel on the CUDA cores, in three
// orders of the K sum.
//
// Replaces the Pallas TPU probe scripts_dev/r4_fold_probe.py:make (pallas_call
// at :153, kernel :72-141). The variants differ only in the order of the K
// sum of each output column's terms (v[k] = sum over the instruction's (m,
// p, r) of (xg[k, x0 + m mul + u] w[k, w0 + u]) tmp[k, r], terms added in
// the table's order):
//   sliceadd  all K values of a column kept, then halved in place in the
//             script's order (_fold_sliceadd, :52-65: halve while the count
//             is even, add the last onto the first while it is odd);
//   group4/8  kg running sums, slot k into sum k mod kg, over the K / kg
//             groups in order (terms of a group in the table's order), then
//             the kg sums halved (:111-140).
// The TPU's k-major rows stay behind: xg (N K, dim_x), emb (N K, n_basis)
// and sh (N K, dim_f) are receiver-major (row i K + k), as B4 fwd reads
// them; out (N, dim_mid) in the grouped mid layout.
//
// One CTA of 256 threads per receiver. Shared memory holds the receiver's
// emb and sh rows, two hidden activations (K x the widest hidden layer) and,
// per instruction, its rows of tmp (K x its Wigner rows), its mul columns
// of w, its d1 mul columns of the K gathered rows xg, and a stage that holds
// one weight block of the MLP and then, for sliceadd, one K-value column a
// thread. The radial MLP (fc_dense): each layer's weights (the last
// layer's din x mul block per instruction) are staged by cp.async; a thread
// computes four adjacent columns for FC_KC slots at a time, reading four
// float4 of weights and a float4 of activations a slot (a broadcast across
// the warp) per four inputs, 16 FMAs each; then 1/sqrt(fan_in) and,
// between layers, silu times the normalization constant (:80-85). tmp: a
// thread per entry. The terms: thread (u, pr) takes output rows p = pr, pr
// + 256 / mul, ... of the instruction, each row's (m, r) pairs listed by
// the host in the table's order, FC_KC or kg slots at once, every operand
// from shared memory. Products and sums of the terms and folds are explicit
// __fmul_rn / __fadd_rn, in the script's order; the MLP and tmp are fmaf
// dot products. What bounds it on an H100: the fp32 pipes, about 147 kFLOP
// a slot at SevenNet-0's widths (the MLP's 66 k multiply-adds), 1.58 ms at
// 67 TFLOP/s for 721,152 slots against 0.47 ms for the 1.56 GB it reads;
// this simple kernel runs one CTA an SM (215 KB of shared memory for
// sliceadd, 174 KB for the groups) and reads three shared-memory operands a
// term.
#include "fused_conv_common.cuh"

#define FC_NT 256
#define FC_MAXL 8  // MLP weight matrices
#define FC_KC 8    // slots a thread takes at once: a dense layer's run, sliceadd's batch
#define FC_REC 10  // ints of an instruction record

enum { FC_SLICEADD = 0, FC_GROUP4 = 1, FC_GROUP8 = 2 };

struct FoldConvArgs {
  const float* xg;   // (N K, dim_x)
  const float* emb;  // (N K, n_basis)
  const float* sh;   // (N K, dim_f)
  const float* w3j;  // (R, dim_f)
  // n_ins records of FC_REC ints (x_start, d1, d3, mul, w_start, g_start,
  // u_off, u_tot, where the row starts lie, first Wigner row), then per
  // instruction the d3 + 1 starts of each output row's (m, r) pairs, then
  // the pairs (table order within a row); an instruction's Wigner rows are
  // consecutive
  const int* itab;
  float* out;        // (N, dim_mid)
  const float* w[FC_MAXL];  // (dims[l], dims[l + 1])
  float inv_sqrt[FC_MAXL];  // 1 / sqrt(dims[l])
  int dims[FC_MAXL + 1];
  // max_mul, max_xw, max_rows: the widest instruction's mul, d1 mul and
  // Wigner rows
  int nl, N, K, dim_x, dim_f, R, dim_mid, n_ins, max_mul, max_xw, max_rows;
  float act_cst;
};

struct FcCarve {
  int emb, sh, h0, h1, tmp, w, xs, stage, total;  // float offsets
};

__host__ __device__ inline int fc_round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline FcCarve fc_carve(const FoldConvArgs& p, int variant) {
  int hmax = 4;
  for (int l = 1; l < p.nl; ++l) hmax = p.dims[l] > hmax ? p.dims[l] : hmax;
  FcCarve c;
  int o = 0;
  c.emb = o, o += fc_round4(p.K * p.dims[0]);
  c.sh = o, o += fc_round4(p.K * p.dim_f);
  c.h0 = o, o += fc_round4(p.K * hmax);
  c.h1 = o, o += fc_round4(p.K * hmax);
  c.tmp = o, o += fc_round4(p.K * p.max_rows);
  c.w = o, o += fc_round4(p.K * p.max_mul);
  c.xs = o, o += fc_round4(p.K * p.max_xw);
  // a weight block of the MLP, then (sliceadd) a K-value column a thread
  int stage = p.dims[p.nl - 1] * p.max_mul;
  for (int l = 0; l + 1 < p.nl; ++l) {
    const int n = p.dims[l] * p.dims[l + 1];
    stage = n > stage ? n : stage;
  }
  if (variant == FC_SLICEADD && FC_NT * p.K > stage) stage = FC_NT * p.K;
  c.stage = o, o += stage;
  c.total = o;
  return c;
}

__device__ __forceinline__ float silu_cst(float z, float cst) { return z / (1.0f + expf(-z)) * cst; }

template <int KG>
__device__ __forceinline__ void fold_regs(float (&v)[KG]) {
#pragma unroll
  for (int h = KG / 2; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < h; ++k) v[k] = __fadd_rn(v[k], v[k + h]);
}

// Stages rows j < din, columns col0 .. col0 + ncols of W (row stride ldw)
// in ws by 16-byte cp.async, as one commit group.
__device__ __forceinline__ void fc_stage_w(float* ws, const float* W, int ldw, int col0, int din,
                                           int ncols) {
  const int n4 = ncols >> 2;
  for (int i = threadIdx.x; i < din * n4; i += FC_NT) {
    const int j = i / n4, c = i - j * n4;
    cp_async16(ws + j * ncols + 4 * c, W + (size_t)j * ldw + col0 + 4 * c, 16);
  }
  cp_async_commit();
}

// out[k][c] = (hin[k] . ws[:, c]) scale for c < ncols, k < K, then silu
// times cst (ACT); ws (din x ncols) staged in shared memory. Thread (cg, kr)
// of FC_NT / (ncols / 4) replicas computes columns 4 cg .. 4 cg + 3 for slots
// kr, kr + replicas, ... in runs of FC_KC: per four inputs j it reads four
// float4 of ws and one float4 of hin a slot (the same address across a
// warp's lanes of one replica: a broadcast), 16 FMAs each.
template <bool ACT>
__device__ __forceinline__ void fc_dense(const float* hin, int din, const float* ws, int ncols,
                                         float* out, int K, float scale, float cst) {
  const int ncg = ncols >> 2, nrep = FC_NT / ncg;
  const int cg = threadIdx.x % ncg, kr = threadIdx.x / ncg;
  for (int k0 = kr; k0 < K; k0 += nrep * FC_KC) {
    float acc[FC_KC][4];
#pragma unroll
    for (int q = 0; q < FC_KC; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < din; j += 4) {
      float4 w4[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) w4[t] = *(const float4*)(ws + (j + t) * ncols + 4 * cg);
#pragma unroll
      for (int q = 0; q < FC_KC; ++q) {
        const int k = k0 + q * nrep;
        if (k < K) {
          const float4 h4 = *(const float4*)(hin + k * din + j);
          const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[q][0] = fmaf(h[t], w4[t].x, acc[q][0]);
            acc[q][1] = fmaf(h[t], w4[t].y, acc[q][1]);
            acc[q][2] = fmaf(h[t], w4[t].z, acc[q][2]);
            acc[q][3] = fmaf(h[t], w4[t].w, acc[q][3]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < FC_KC; ++q) {
      const int k = k0 + q * nrep;
      if (k < K) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = ACT ? silu_cst(acc[q][e] * scale, cst) : acc[q][e] * scale;
        *(float4*)(out + k * ncols + 4 * cg) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// one term at slot k: (x[k][xc] w[k][u]) tmp[k][r], all from shared memory
__device__ __forceinline__ float fc_term(const float* xs, int xw, int xc, const float* wS, int mul,
                                         int u, const float* tmpS, int nr, int r, int k) {
  return __fmul_rn(__fmul_rn(xs[k * xw + xc], wS[k * mul + u]), tmpS[k * nr + r]);
}

template <int V>
__global__ void __launch_bounds__(FC_NT, 1) probe_fold_conv_kernel(FoldConvArgs p) {
  extern __shared__ float sm[];
  const FcCarve cv = fc_carve(p, V);
  float* embS = sm + cv.emb;
  float* shS = sm + cv.sh;
  float* tmpS = sm + cv.tmp;  // the instruction's Wigner rows
  float* wS = sm + cv.w;
  const int K = p.K, tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * K;
  for (int i = tid; i < K * p.dims[0]; i += FC_NT) embS[i] = __ldg(p.emb + e0 * p.dims[0] + i);
  for (int i = tid; i < K * p.dim_f; i += FC_NT) shS[i] = __ldg(p.sh + e0 * p.dim_f + i);
  __syncthreads();

  // hidden layers, ping-pong between h0 and h1
  const float* hin = embS;
  int din = p.dims[0];
  float* stg = sm + cv.stage;  // a staged weight block; sliceadd's K-value columns
  for (int l = 0; l + 1 < p.nl; ++l) {
    float* hout = sm + (l & 1 ? cv.h1 : cv.h0);
    const int dout = p.dims[l + 1];
    fc_stage_w(stg, p.w[l], dout, 0, din, dout);
    cp_async_wait(0);
    __syncthreads();
    fc_dense<true>(hin, din, stg, dout, hout, K, p.inv_sqrt[l], p.act_cst);
    __syncthreads();
    hin = hout, din = dout;
  }
  float* xs = sm + cv.xs;
  const float* xrow = p.xg + e0 * p.dim_x;
  float* orow = p.out + (size_t)blockIdx.x * p.dim_mid;

  for (int ins = 0; ins < p.n_ins; ++ins) {
    const int* rec = p.itab + ins * FC_REC;
    const int x0 = rec[0], d3 = rec[2], mul = rec[3], g0 = rec[5], u_off = rec[6],
              u_tot = rec[7], r0 = rec[9];
    const int* poff = p.itab + rec[8];  // d3 + 1 starts of each row's (m, r) pairs
    const int xw = rec[1] * mul, nr = (poff[d3] - poff[0]) / 2;
    const int nrep = FC_NT / mul, u = tid % mul, pr = tid / mul;
    __syncthreads();  // the last instruction is done with xs, tmp, wS and the stage
    // the instruction's x columns of the receiver's K rows and its block of
    // W3, in flight while tmp is computed
    for (int i = tid; i < K * (xw >> 2); i += FC_NT) {
      const int k = i / (xw >> 2), c = i - k * (xw >> 2);
      cp_async16(xs + k * xw + 4 * c, xrow + (size_t)k * p.dim_x + x0 + 4 * c, 16);
    }
    fc_stage_w(stg, p.w[p.nl - 1], p.dims[p.nl], rec[4], din, mul);
    // its Wigner rows of tmp = w3j_pack sh, and its mul columns of w
    for (int i = tid; i < K * nr; i += FC_NT) {
      const int k = i / nr, r = i - k * nr;
      float z = 0.0f;
      for (int f = 0; f < p.dim_f; ++f)
        z = fmaf(__ldg(p.w3j + (r0 + r) * p.dim_f + f), shS[k * p.dim_f + f], z);
      tmpS[i] = z;
    }
    cp_async_wait(0);
    __syncthreads();
    fc_dense<false>(hin, din, stg, mul, wS, K, p.inv_sqrt[p.nl - 1], 0.0f);
    __syncthreads();
    // the terms and the K sum of output rows pp = pr, pr + nrep, ...
    for (int pp = pr; pp < d3; pp += nrep) {
      const int t0 = poff[pp], t1 = poff[pp + 1];
      float res = 0.0f;  // a row without terms is zero
      if (t1 > t0) {
        if (V == FC_SLICEADD) {
          float* col = stg + tid;  // this thread's K values, FC_NT apart
          for (int k0 = 0; k0 < K; k0 += FC_KC) {
            float v[FC_KC];
#pragma unroll
            for (int q = 0; q < FC_KC; ++q) v[q] = 0.0f;
            for (int t = t0; t < t1; t += 2) {
              const int xc = p.itab[t] * mul + u, r = p.itab[t + 1] - r0;
#pragma unroll
              for (int q = 0; q < FC_KC; ++q)
                if (k0 + q < K)
                  v[q] = __fadd_rn(v[q], fc_term(xs, xw, xc, wS, mul, u, tmpS, nr, r, k0 + q));
            }
#pragma unroll
            for (int q = 0; q < FC_KC; ++q)
              if (k0 + q < K) col[(k0 + q) * FC_NT] = v[q];
          }
          for (int kc = K; kc > 1;) {
            if (kc % 2 == 0) {
              const int h = kc / 2;
              for (int k0 = 0; k0 < h; k0 += FC_KC) {  // FC_KC independent adds in flight
                float a[FC_KC], b[FC_KC];
#pragma unroll
                for (int q = 0; q < FC_KC; ++q)
                  if (k0 + q < h) a[q] = col[(k0 + q) * FC_NT], b[q] = col[(k0 + q + h) * FC_NT];
#pragma unroll
                for (int q = 0; q < FC_KC; ++q)
                  if (k0 + q < h) col[(k0 + q) * FC_NT] = __fadd_rn(a[q], b[q]);
              }
              kc = h;
            } else {
              col[0] = __fadd_rn(col[0], col[(kc - 1) * FC_NT]);
              kc -= 1;
            }
          }
          res = col[0];
        } else {
          constexpr int KG = V == FC_GROUP4 ? 4 : 8;
          float acc[KG];
#pragma unroll
          for (int q = 0; q < KG; ++q) acc[q] = 0.0f;
          for (int g = 0; g < K / KG; ++g)
            for (int t = t0; t < t1; t += 2) {
              const int xc = p.itab[t] * mul + u, r = p.itab[t + 1] - r0;
#pragma unroll
              for (int q = 0; q < KG; ++q)
                acc[q] = __fadd_rn(acc[q], fc_term(xs, xw, xc, wS, mul, u, tmpS, nr, r,
                                                   g * KG + q));
            }
          fold_regs<KG>(acc);
          res = acc[0];
        }
      }
      orow[g0 + pp * u_tot + u_off + u] = res;
    }
  }
}

template <int V>
static int launch_v(const FoldConvArgs& p, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];
  const size_t smem = sizeof(float) * fc_carve(p, V).total;
  cudaError_t err = raise_smem_limit((const void*)probe_fold_conv_kernel<V>, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  probe_fold_conv_kernel<V><<<p.N, FC_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// variant: FC_SLICEADD, FC_GROUP4 or FC_GROUP8 (K a multiple of 4 or 8).
// Every instruction's mul and every hidden width is a multiple of 4 whose
// quarter divides FC_NT, n_basis and dim_x are multiples of 4, at least one
// hidden layer (checked by the wrapper, probes/fold_conv.py).
extern "C" int probe_fold_conv_launch(int variant, FoldConvArgs p, void* stream) {
  if (p.N <= 0 || p.K <= 0 || p.nl < 2 || p.nl > FC_MAXL || p.max_mul <= 0 ||
      p.max_mul > FC_NT || fc_carve(p, variant).total * sizeof(float) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == FC_SLICEADD) return launch_v<FC_SLICEADD>(p, s);
  if (variant == FC_GROUP4 && p.K % 4 == 0) return launch_v<FC_GROUP4>(p, s);
  if (variant == FC_GROUP8 && p.K % 8 == 0) return launch_v<FC_GROUP8>(p, s);
  return (int)cudaErrorInvalidValue;
}
