// Backward fused conv. From the receiver cotangent ybar (N, dim_mid) it
// emits the per-edge x-cotangents dxg (N*K, dim_x) and, in vec mode, the
// edge-vector cotangents dvec (3, N*K); in emb/sh mode the embedding and
// spherical-harmonic cotangents demb (N*K, n_basis) and dsh (N*K, dim_f).
// The caller turns dxg into dx with the mirror gather
// (sevennet_tpu_torch/ops/fused_conv.py, as sevennet_tpu/ops/fused_conv.py:
// 1584-1590 does in XLA).
//
// Replaces: the Pallas TPU kernel sevennet_tpu/ops/fused_conv.py:
// make_fused_conv_bwd2, out_slots=1 (pallas_call at :1222):
//   - fused_conv_bwd_launch: `embed` set, param_grads=False (B2, serving
//     and MD);
//   - fused_conv_bwd_pg_launch + param_grad_reduce_launch: `embed` set,
//     param_grads=True (B2', training), which also gives the radial-MLP
//     weight gradients dW_l = sum_edges h_l (x) g_l / sqrt(d_l) and dcoef
//     (:1060-1098);
//   - fused_conv_bwd_slot_launch: out_slots > 1 (B3, pallas_call at :1208),
//     B2 on one row chunk of the ring backward writing into a buffer slot;
//   - fused_conv_bwd_embsh_launch and fused_conv_bwd_embsh_pg_launch +
//     param_grad_reduce_launch (no dcoef): embed=None (B4 bwd and B4').
//     They also serve B5, make_fused_conv_bwd (pallas_call at :875), the
//     round-2 factoring of the same pullback.
//
// Like the TPU kernel it recomputes the radial MLP (keeping
// pre-activations) instead of storing per-edge residuals, and it uses the
// factored products of its docstring (:906-920): a = sum_p ybar tmp feeds
// both dxg = w a and dw = sum_m x a, and dtmp reuses x * w. The embedding and
// spherical-harmonic cotangents are chained to dvec inside the kernel
// (_emb_sh_bwd_rows, :272-318), including the projection
// (du - u (u.du)) / r + u dr.
//
// What bounds it on an H100, and the design (fused_conv_common.cuh): about
// twice the forward's operations, most of them the last MLP layer run
// forward (to rebuild w) and backward (dz2 = dw W3^T). Both run on the
// tensor cores as 3xTF32 mma.sync (fp32 accuracy), W3 staged in 64-column
// blocks by cp.async, each pass streaming it once per tile; the backward
// product splits its k dimension (W3's columns) over the warps and adds
// their partial sums in warp order. The uvu pullback is 3xTF32 products
// over host task tables (dtmp per instruction and m; dxg and dw per x irrep
// and 8 channels, over the instructions that read it), each output owned by
// one warp, so there are no atomics; the MLP's other products, tmp, dsh and
// demb are 3xTF32 too. The chain of the embedding and spherical-harmonic
// cotangents to dvec runs a warp per edge, lanes over the basis functions
// and derivative terms, with warp sums and no local tables. Slots past the
// cutoff get exact zeros without any arithmetic.
//
// Emb/sh mode walks every slot, padding included: a slot whose emb row is
// zero has w = 0, so its dxg and dsh are zero, but its demb is not (dw =
// sum x a does not vanish with w, and silu'(0) = 1/2). The TPU kernel
// emits that demb and the model masks it afterwards (model/model.py:387),
// so this kernel emits it too.
//
// The parameter gradients are sums over every edge of the system. The TPU
// kernel adds each grid step's dW into its output (:1064-1072), which works
// because its grid runs in order; here CTAs run in no order, and dW3 alone
// (64 x 960 fp32 for SevenNet-0) does not fit beside the tiles in shared
// memory. So B2' is two passes, both deterministic:
//   1. the CTA of atom i writes, for each of its edges inside the cutoff, a
//      record of the factors the products need (emb, h1, h2 and their
//      cotangents dz1, dz2, dw, plus the per-edge dcoef terms) into a
//      workspace row at the edge's flat slot, and a validity byte for every
//      slot of row i;
//   2. param_grad_reduce_launch forms dW_l = H_l^T G_l over the workspace:
//      64 x 64 output tiles per CTA over a fixed chunk of rows (invalid rows
//      read as zeros), each chunk's tile to a partial buffer, then one pass
//      that sums the partials in chunk order. It is bound by fp32
//      operations (2 d_in d_out per edge and layer); the workspace is read
//      once per 64-column tile of G.
#include "fused_conv_common.cuh"

// Per-edge record of the parameter-gradient workspace (B2'): row stride and
// the column of each field, in this order (ctypes mirror: _WsLayout in
// sevennet_tpu_torch/ops/fused_conv.py). Kept out of ConvDims: a larger
// ConvDims grows the kernels' stack frame and slowed B1 and B2 by 5-9 %.
struct WsLayout {
  int stride, emb, h1, h2, dz1, dz2, dw, dc;
};

// Writes the workspace record of each edge of the tile: emb, h1, h2, dz1,
// dz2 and dw, in the column order of WsLayout (emb .. dw). The per-edge
// dcoef terms (columns dc ..) are written by the chain step.
__device__ inline void write_records(const WsLayout& L, const Tile& t, int ne,
                                     float* __restrict__ work) {
  const int W = L.dc;
  for (int idx = threadIdx.x; idx < ne * W; idx += NT) {
    const int e = idx / W, c = idx - e * W;
    float v;
    if (c < L.h1) v = t.embT[(c - L.emb) * TE + e];
    else if (c < L.h2) v = t.h1T[(c - L.h1) * TE + e];
    else if (c < L.dz1) v = t.h2T[(c - L.h2) * TE + e];
    else if (c < L.dz2) v = t.dz1T[(c - L.dz1) * TE + e];
    else if (c < L.dw) v = t.dz2T[(c - L.dz2) * TE + e];
    else v = t.ws[e * t.SW + (c - L.dw)];
    work[(size_t)t.flats[e] * L.stride + c] = v;
  }
}

// dz2 (TE x h2) = (dw W3^T) / sqrt(h2) * silu'(z2) * cst, with dw in t.ws:
// 3xTF32 mma.sync over the column blocks of W3 (pipelined as in
// w3_forward, row stride SBB), OG hidden units per pass. The k dimension is
// split over the warps: warp w takes the 8 columns of k-step w of every
// block against all n-tiles, so each dw fragment is loaded and split once.
// The NWARP partial sums go through t.stage after the last block and are
// added in warp order. The caller has issued the first pass's first block
// into buffer 0 (stage_w3(..., 0, min(OG, round8(h2)), w3_block_col(d, 0),
// SBB)).
__device__ inline void w3_backward(const ConvDims& d, const Tile& t, const float* __restrict__ W3) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h2p = round8(d.h2);
  const int nblk = (d.numel + BN - 1) / BN;
  const int S = t.nstage;
  const float inv_h2 = (float)(1.0 / sqrt((double)d.h2));
  const float cst = d.act_cst;
  for (int og = 0; og < h2p; og += OG) {
    const int nrow = min(OG, h2p - og);
    for (int jb = og > 0 ? 0 : 1; jb < S - 1 && jb < nblk; ++jb)
      stage_w3(d, W3, t.stage + jb * OG * SBB, og, nrow, w3_block_col(d, jb), SBB);
    float acc[OG / 8][4];
#pragma unroll
    for (int nt = 0; nt < OG / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    for (int jb = 0; jb < nblk; ++jb) {
      const int ahead = jb + S - 1;
      if (ahead < nblk)
        stage_w3(d, W3, t.stage + (ahead % S) * OG * SBB, og, nrow, w3_block_col(d, ahead), SBB);
      cp_async_wait(min(S - 1, nblk - 1 - jb));
      __syncthreads();
      const float* Bs = t.stage + (jb % S) * OG * SBB;
      const int jk = w3_block_col(d, jb) + warp * 8;
      const int j = jk + q;
      if (jk < d.numel) {
        float a[4];
        a[0] = j < d.numel ? t.ws[g * t.SW + j] : 0.0f;
        a[1] = j < d.numel ? t.ws[(g + 8) * t.SW + j] : 0.0f;
        a[2] = j + 4 < d.numel ? t.ws[g * t.SW + j + 4] : 0.0f;
        a[3] = j + 4 < d.numel ? t.ws[(g + 8) * t.SW + j + 4] : 0.0f;
        unsigned ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < OG / 8; ++nt) {
          if (nt * 8 < nrow) {
            const float* b_row = Bs + (nt * 8 + g) * SBB + warp * 8 + q;
            const float b[2] = {b_row[0], b_row[4]};
            mma_3xtf32(acc[nt], ah, al, b);
          }
        }
      }
      __syncthreads();
    }
    float* red = t.stage;  // (NWARP * TE, OG) partial sums, row stride SBF
#pragma unroll
    for (int nt = 0; nt < OG / 8; ++nt) {
      if (nt * 8 < nrow) {
        float* r0 = red + (warp * TE + g) * SBF + nt * 8 + 2 * q;
        r0[0] = acc[nt][0];
        r0[1] = acc[nt][1];
        r0[8 * SBF] = acc[nt][2];
        r0[8 * SBF + 1] = acc[nt][3];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nrow * TE; idx += NT) {
      const int o = idx / TE, e = idx - o * TE;
      if (og + o < d.h2) {
        float s = 0.0f;
        for (int w = 0; w < NWARP; ++w) s += red[(w * TE + e) * SBF + o];
        const float z = t.z2T[(og + o) * TE + e];
        const float sg = sigmoidf_(z);
        t.dz2T[(og + o) * TE + e] = s * inv_h2 * (sg * (1.0f + z * (1.0f - sg)) * cst);
      }
    }
    __syncthreads();
  }
}

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode; (da, db):
// (dvec, unused) in vec mode, (demb, dsh) in emb/sh mode.
template <bool PG, bool EMBSH>
__global__ void __launch_bounds__(NT, 1) fused_conv_bwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ ea, const float* __restrict__ eb,
    const float* __restrict__ W1, const float* __restrict__ W2,
    const float* __restrict__ W3, const float* __restrict__ ybar,
    const int* __restrict__ itab, const float* __restrict__ ftab,
    float* __restrict__ dxg, float* __restrict__ da, float* __restrict__ db, WsLayout L,
    float* __restrict__ work, unsigned char* __restrict__ wvalid) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, true, (char*)smem_raw, &t);
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NK = d.N * d.K;
  const int NB = d.n_basis, DF = d.dim_f;
  Prof prof;
  prof.start();
  load_tabs(d, t, itab);
  list_slots<EMBSH>(d, t, i, ea);
  const int nv = *t.count;
  if (PG) {
    for (int k = tid; k < d.K; k += NT) wvalid[(size_t)i * d.K + k] = t.valid[k];
  }

  // exact zeros for the slots outside the cutoff (vec mode)
  for (int idx = tid; !EMBSH && idx < d.K * d.dim_x; idx += NT) {
    const int k = idx / d.dim_x;
    if (!t.valid[k]) dxg[(size_t)(i * d.K + k) * d.dim_x + (idx - k * d.dim_x)] = 0.0f;
  }
  for (int k = tid; !EMBSH && k < d.K; k += NT) {
    if (!t.valid[k]) {
      const int flat = i * d.K + k;
      da[flat] = 0.0f;
      da[NK + flat] = 0.0f;
      da[2 * NK + flat] = 0.0f;
    }
  }
  for (int c = tid; c < d.dim_mid; c += NT) t.yb[yb_at(c)] = ybar[(size_t)i * d.dim_mid + c];
  prof.mark(0);

  const float* w3j = ftab + d.w3j;
  const float inv_nb = (float)(1.0 / sqrt((double)NB));
  const float inv_h1 = (float)(1.0 / sqrt((double)d.h1));
  const float cst = d.act_cst;

  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile<EMBSH>(d, t, i, t0, ne, x, src, ea, eb, W1, W2, W3, itab, ftab, prof);
    // W3's first block for the dz2 product is copied during the uvu steps
    stage_w3(d, W3, t.stage, 0, min(OG, round8(d.h2)), w3_block_col(d, 0), SBB);

    // the uvu pullback on the tensor cores: dtmp first (it reads w), then
    // dxg and dw (written over w)
    uvu_dtmp(t);
    __syncthreads();
    prof.mark(8);
    uvu_dxg_dw(d, t, ne, dxg);
    __syncthreads();
    prof.mark(9);
    // dz2 = (dw @ W3^T) / sqrt(h2) * silu'(z2) * cst on the tensor cores
    w3_backward(d, t, W3);
    prof.mark(5);
    // dz1 = (dz2 @ W2^T) / sqrt(h1) * silu'(z1) * cst and dsh = dtmp w3j_pack,
    // then demb = (dz1 @ W1^T) / sqrt(n_basis): 3xTF32 on the tensor cores
    {
      const float* z1T = t.z1T;
      small_product(t.dz2T, TE, 1, d.h2, W2, 1, d.h2, d.h1, t.dz1T, TE, 1,
                    [=](float s, int o, int e) {
                      const float z = z1T[o * TE + e];
                      const float sg = sigmoidf_(z);
                      return s * inv_h1 * (sg * (1.0f + z * (1.0f - sg)) * cst);
                    });
    }
    small_product(t.dtmp, 1, t.SR, d.R, w3j, DF, 1, DF, t.dsh, 1, DF,
                  [](float v, int, int) { return v; });
    __syncthreads();
    small_product(t.dz1T, TE, 1, d.h1, W1, 1, d.h1, NB, t.demb, 1, NB,
                  [=](float v, int, int) { return v * inv_nb; });
    __syncthreads();
    prof.mark(6);
    if (PG) write_records(L, t, ne, work);
    if (EMBSH) {
      // demb and dsh rows out, coalesced along each row
      for (int idx = tid; idx < ne * NB; idx += NT) {
        const int e = idx / NB;
        da[(size_t)t.flats[e] * NB + (idx - e * NB)] = t.demb[idx];
      }
      for (int idx = tid; idx < ne * DF; idx += NT) {
        const int e = idx / DF;
        db[(size_t)t.flats[e] * DF + (idx - e * DF)] = t.dsh[idx];
      }
    } else {
      // chain demb and dsh to the edge vector: a warp per edge, lanes over
      // the basis functions and the derivative terms, warp sums
      const float pref = (float)(2.0 / (double)d.cutoff);
      const int4* st = (const int4*)(t.tabs + d.shd_terms);
      const int* sf = t.tabs + d.shd_terms + 4 * d.n_shd;  // component c of each term
      const float* sc = ftab + d.shd_coef;
      for (int e = warp; e < ne; e += NWARP) {
        const float* g = t.geo + e * 8;
        const float r = g[0], rinv = g[1], u0 = g[2], u1 = g[3], u2 = g[4], env = g[5], denv = g[6];
        const int flat = t.flats[e];
        float* dc = PG ? work + (size_t)flat * L.stride + L.dc : nullptr;
        float dr = 0.0f;
        for (int n = lane; n < NB; n += 32) {
          const float c = eb[n];
          const float sr = sinf(c * r), cr = cosf(c * r);
          const float dembdr = pref * (c * cr * (rinv * env) + sr * (denv * rinv - env * rinv * rinv));
          dr += t.demb[e * NB + n] * dembdr;
          // d emb_n / d c_n = pref * cos(c_n r) * env (_emb_sh_bwd_rows, :316-317)
          if (PG) dc[n] = t.demb[e * NB + n] * (pref * cr * env);
        }
        float du0 = 0.0f, du1 = 0.0f, du2 = 0.0f;
        const Pow3 px(u0), py(u1), pz(u2);
        for (int q = lane; q < d.n_shd; q += 32) {
          const int4 tm = st[q];  // (f, a, b, c) of dY_f/du_comp
          const float v = sc[q] * (t.dsh[e * DF + tm.x] * (px(tm.y) * py(tm.z) * pz(tm.w)));
          const int comp = sf[q];
          du0 += comp == 0 ? v : 0.0f;
          du1 += comp == 1 ? v : 0.0f;
          du2 += comp == 2 ? v : 0.0f;
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
          dr += __shfl_xor_sync(0xffffffffu, dr, sh);
          du0 += __shfl_xor_sync(0xffffffffu, du0, sh);
          du1 += __shfl_xor_sync(0xffffffffu, du1, sh);
          du2 += __shfl_xor_sync(0xffffffffu, du2, sh);
        }
        if (lane == 0) {
          const float udu = u0 * du0 + u1 * du1 + u2 * du2;
          da[flat] = (du0 - u0 * udu) * rinv + u0 * dr;
          da[NK + flat] = (du1 - u1 * udu) * rinv + u1 * dr;
          da[2 * NK + flat] = (du2 - u2 * udu) * rinv + u2 * dr;
        }
      }
    }
    __syncthreads();
    prof.mark(7);
  }
  prof.store();
}

// ---------------------------------------------------------------------------
// second pass of B2': C = scale * A^T B over the valid workspace rows
// ---------------------------------------------------------------------------

#define RT 64  // output tile: RT rows of A's columns x RT columns of B's
#define RK 16  // workspace rows per step

struct ReduceArgs {
  const float* work;
  const unsigned char* valid;
  int rows, stride, chunk;
  int a_off, da;  // A = work[:, a_off : a_off + da]; a_off < 0: a column of ones
  int b_off, db;  // B = work[:, b_off : b_off + db]
  float* partial; // (n_chunks, da, db)
};

// One 64 x 64 tile of A^T B over rows [z * chunk, (z + 1) * chunk): 256
// threads, 4 x 4 outputs each, in registers; rows step RK at a time through
// shared memory, loaded along the workspace columns (coalesced).
__global__ void __launch_bounds__(256) pg_partial_kernel(ReduceArgs p) {
  __shared__ __align__(16) float As[RK][RT];
  __shared__ __align__(16) float Bs[RK][RT];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.x * RT, a0 = blockIdx.y * RT;
  const int r_begin = blockIdx.z * p.chunk;
  const int r_end = min(p.rows, r_begin + p.chunk);
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int r0 = r_begin; r0 < r_end; r0 += RK) {
    for (int idx = threadIdx.x; idx < RK * RT; idx += 256) {
      const int k = idx / RT, c = idx - k * RT;
      const int r = r0 + k;
      const bool ok = r < r_end && p.valid[r];
      const float* row = p.work + (size_t)r * p.stride;
      float a = 0.0f, b = 0.0f;
      if (ok && a0 + c < p.da) a = p.a_off < 0 ? 1.0f : row[p.a_off + a0 + c];
      if (ok && b0 + c < p.db) b = row[p.b_off + b0 + c];
      As[k][c] = a;
      Bs[k][c] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const float4 av = *(const float4*)&As[k][ty * 4];
      const float4 bv = *(const float4*)&Bs[k][tx * 4];
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int a = a0 + ty * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int b = b0 + tx * 4 + v;
      if (a < p.da && b < p.db)
        p.partial[((size_t)blockIdx.z * p.da + a) * p.db + b] = acc[u][v];
    }
  }
}

// out[o] = scale * sum over chunks, in chunk order, of partial[chunk, o]
__global__ void pg_final_kernel(const float* __restrict__ partial, int n_chunks, int n,
                                float scale, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * n + o];
  out[o] = s * scale;
}

template <bool PG, bool EMBSH>
static int launch_bwd(const ConvDims& d, int* limits, const float* x, const int* src,
                      const float* ea, const float* eb, const float* W1, const float* W2,
                      const float* W3, const float* ybar, const int* itab, const float* ftab,
                      float* dxg, float* da, float* db, const WsLayout& L, float* work,
                      unsigned char* wvalid, void* stream) {
  const size_t smem = carve(d, true, nullptr, nullptr);
  cudaError_t err =
      raise_smem_limit((const void*)fused_conv_bwd_kernel<PG, EMBSH>, smem, limits);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_bwd_kernel<PG, EMBSH><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, ea, eb, W1, W2, W3, ybar, itab, ftab, dxg, da, db, L, work, wvalid);
  return (int)cudaGetLastError();
}

static int smem_limit[MAX_DEVICES];
static int smem_limit_pg[MAX_DEVICES];
static int smem_limit_embsh[MAX_DEVICES];
static int smem_limit_embsh_pg[MAX_DEVICES];

// B2. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_conv_bwd_launch(ConvDims d, const float* x, const int* src, const float* vec,
                                     const float* coef, const float* W1, const float* W2,
                                     const float* W3, const float* ybar, const int* itab,
                                     const float* ftab, float* dxg, float* dvec, void* stream) {
  return launch_bwd<false, false>(d, smem_limit, x, src, vec, coef, W1, W2, W3, ybar, itab, ftab,
                                  dxg, dvec, nullptr, WsLayout{}, nullptr, nullptr, stream);
}

// B3, the ring backward's per-chunk kernel. Replaces the Pallas TPU kernel
// make_fused_conv_bwd2 with out_slots > 1 (sevennet_tpu/ops/fused_conv.py,
// pallas_call at :1208, caller :2061-2074): B2 on the d.N = RC receiver
// rows of one chunk, its dxg written in place into slot `slot` of the
// caller's rolling buffer buf (S * RC*K rows of dim_x). The TPU kernel
// takes the slot by scalar prefetch and aliases the buffer to its output;
// here the slot is a pointer offset, so B2's kernel serves unchanged:
// src_c and ybar_c point at the chunk's first row, vec_c and dvec are the
// chunk's own (3, RC*K) columns, and the zero rows of slots past the
// cutoff land inside the slot too. Rows of other slots are not touched.
// What bounds it: B2's fp32 operations on the chunk's edges.
extern "C" int fused_conv_bwd_slot_launch(ConvDims d, const float* x, const int* src_c,
                                          const float* vec_c, const float* coef, const float* W1,
                                          const float* W2, const float* W3, const float* ybar_c,
                                          const int* itab, const float* ftab, float* buf, int slot,
                                          float* dvec, void* stream) {
  float* dxg = buf + (size_t)slot * d.N * d.K * d.dim_x;
  return launch_bwd<false, false>(d, smem_limit, x, src_c, vec_c, coef, W1, W2, W3, ybar_c, itab,
                                  ftab, dxg, dvec, nullptr, WsLayout{}, nullptr, nullptr, stream);
}

// B2', first pass: B2 plus the workspace records (N*K rows of L.stride
// floats) and the validity byte of every slot (N*K).
extern "C" int fused_conv_bwd_pg_launch(ConvDims d, WsLayout L, const float* x, const int* src,
                                        const float* vec, const float* coef, const float* W1,
                                        const float* W2, const float* W3, const float* ybar,
                                        const int* itab, const float* ftab, float* dxg,
                                        float* dvec, float* work, unsigned char* wvalid,
                                        void* stream) {
  return launch_bwd<true, false>(d, smem_limit_pg, x, src, vec, coef, W1, W2, W3, ybar, itab,
                                 ftab, dxg, dvec, nullptr, L, work, wvalid, stream);
}

// B4 bwd: emb (N*K, n_basis), sh (N*K, dim_f) -> dxg, demb, dsh.
extern "C" int fused_conv_bwd_embsh_launch(ConvDims d, const float* x, const int* src,
                                           const float* emb, const float* sh, const float* W1,
                                           const float* W2, const float* W3, const float* ybar,
                                           const int* itab, const float* ftab, float* dxg,
                                           float* demb, float* dsh, void* stream) {
  return launch_bwd<false, true>(d, smem_limit_embsh, x, src, emb, sh, W1, W2, W3, ybar, itab,
                                 ftab, dxg, demb, dsh, WsLayout{}, nullptr, nullptr, stream);
}

// B4', first pass: B4 bwd plus the records (no dcoef columns: L.dc is the
// end of the record) and a validity byte of 1 for every slot.
extern "C" int fused_conv_bwd_embsh_pg_launch(ConvDims d, WsLayout L, const float* x,
                                              const int* src, const float* emb, const float* sh,
                                              const float* W1, const float* W2, const float* W3,
                                              const float* ybar, const int* itab,
                                              const float* ftab, float* dxg, float* demb,
                                              float* dsh, float* work, unsigned char* wvalid,
                                              void* stream) {
  return launch_bwd<true, true>(d, smem_limit_embsh_pg, x, src, emb, sh, W1, W2, W3, ybar, itab,
                                ftab, dxg, demb, dsh, L, work, wvalid, stream);
}

// B2' (and B4'), second pass: dW1 (n_basis, h1), dW2 (h1, h2), dW3 (h2,
// numel) and dcoef (n_basis) from the workspace; partial holds
// ceil(N*K / chunk) * (n_basis*h1 + h1*h2 + h2*numel + n_basis) floats.
// With dcoef null (emb/sh mode, no dcoef columns) the last product is
// skipped and partial needs n_basis floats less per chunk.
extern "C" int param_grad_reduce_launch(ConvDims d, WsLayout L, const float* work,
                                        const unsigned char* wvalid,
                                        int chunk, float* partial, float* dW1, float* dW2,
                                        float* dW3, float* dcoef, void* stream) {
  const int rows = d.N * d.K;
  const int n_chunks = (rows + chunk - 1) / chunk;
  struct Product {
    int a_off, da, b_off, db;
    double fan_in;
    float* out;
  } prods[4] = {
      {L.emb, d.n_basis, L.dz1, d.h1, (double)d.n_basis, dW1},
      {L.h1, d.h1, L.dz2, d.h2, (double)d.h1, dW2},
      {L.h2, d.h2, L.dw, d.numel, (double)d.h2, dW3},
      {-1, 1, L.dc, d.n_basis, 1.0, dcoef},
  };
  cudaStream_t s = (cudaStream_t)stream;
  size_t off = 0;
  for (const Product& q : prods) {
    if (q.out == nullptr) continue;
    const int n = q.da * q.db;
    if (n_chunks > 0) {
      ReduceArgs a = {work, wvalid, rows, L.stride, chunk, q.a_off, q.da, q.b_off, q.db,
                      partial + off};
      dim3 grid((q.db + RT - 1) / RT, (q.da + RT - 1) / RT, n_chunks);
      pg_partial_kernel<<<grid, 256, 0, s>>>(a);
    }
    pg_final_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial + off, n_chunks, n,
                                                    (float)(1.0 / sqrt(q.fan_in)), q.out);
    off += (size_t)n_chunks * n;
  }
  return (int)cudaGetLastError();
}
