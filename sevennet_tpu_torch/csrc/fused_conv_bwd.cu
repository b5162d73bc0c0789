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
//   - fused_conv_bwd_pg_launch + pg_reduce_launch (pg_reduce.cu): `embed` set,
//     param_grads=True (B2', training), which also gives the radial-MLP
//     weight gradients dW_l = sum_edges h_l (x) g_l / sqrt(d_l) and dcoef
//     (:1060-1098);
//   - fused_conv_bwd_slot_launch: out_slots > 1 (B3, pallas_call at :1208),
//     B2 on one row chunk of the ring backward writing into a buffer slot;
//   - fused_conv_bwd_embsh_launch and fused_conv_bwd_embsh_pg_launch +
//     pg_reduce_launch (no dcoef): embed=None (B4 bwd and B4').
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
// forward (to rebuild w) and backward (dz = dw W3^T). Both run on the
// tensor cores as 3xTF32 mma.sync (fp32 accuracy), W3 staged in 64-column
// blocks by cp.async, each streaming it once per tile; the backward
// product splits its k dimension (W3's columns) over the warps and adds
// their partial sums in warp order. The uvu pullback is 3xTF32 products
// over host task tables (dtmp per instruction and m; dxg and dw per x irrep
// and 8 channels, over the instructions that read it), each output owned by
// one warp, so there are no atomics; the MLP's other products, tmp, dsh and
// demb are 3xTF32 too. The chain of the embedding and spherical-harmonic
// cotangents to dvec runs a warp per edge, lanes over the basis functions
// and derivative terms, with warp sums and no local tables. Slots past the
// cutoff get exact zeros without any arithmetic. It walks the column blocks
// of w (fused_conv_common.cuh) in order: per block it rebuilds the block's
// w and tmp, runs the block's pullback and adds the block's share of dxg,
// dsh and the last hidden layer's dz to the earlier blocks'. A layer too
// wide for one CTA runs on a cluster (fused_conv_common.cuh): each CTA walks
// the row's edges once over its rank's blocks, adds its dxg in a tile of
// shared memory that it stores once per tile of edges, and rank 0 adds the
// ranks' shares of dsh and dz in rank order and runs the chain. That keeps
// dxg out of device memory until it is whole: walked in passes instead, the
// accumulating tasks read dxg back block by block, 6.6-6.8 times its size
// per launch at mf-ompa's layers 2-3, 57 % of the kernel's time there.
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
//      record of the factors the products need (emb, every hidden layer's
//      h and their cotangents dz, dw, plus the per-edge dcoef terms) into a
//      workspace row at the edge's flat slot, and a validity byte for every
//      slot of row i;
//   2. pg_reduce_launch (pg_reduce.cu) forms dW_l = H_l^T G_l over the
//      workspace: one launch over every product's output tiles and row
//      chunks (invalid rows zero-filled by the copies), 3xTF32 on the
//      tensor cores, each chunk's tile to a partial buffer, then a second
//      launch that adds the partials in chunk order. It is bound by the
//      bytes of the records, each read once (pg_reduce.cu has the design).
#include "fused_conv_common.cuh"

// Per-edge record of the parameter-gradient workspace (B2'): row stride and
// the first column of each field, in this order: emb, the hidden layers'
// activations h (layer by layer), their cotangents dz (the same order), dw,
// the dcoef terms (ctypes mirror: _WsLayout in
// sevennet_tpu_torch/ops/fused_conv.py). Kept out of ConvDims: a larger
// ConvDims grows the kernels' stack frame and slowed B1 and B2 by 5-9 %.
struct WsLayout {
  int stride, emb, h, dz, dw, dc;
};

// Writes the workspace record of each edge of the tile but dw and the dcoef
// terms: emb, h and dz of every hidden layer (columns emb .. dw). dw is
// written per column block (write_dw_records), the dcoef terms by the
// chain step.
__device__ inline void write_records(const ConvDims& d, const WsLayout& L, const Tile& t, int ne,
                                     float* __restrict__ work) {
  const int W = L.dw;
  for (int idx = threadIdx.x; idx < ne * W; idx += NT) {
    const int e = idx / W, c = idx - e * W;
    float v;
    if (c < L.h) {
      v = t.embT[(c - L.emb) * TE + e];
    } else {
      int o = c < L.dz ? c - L.h : c - L.dz, l = 0, h = hidden_width(t, 0);
      const float* z = t.zh;
      for (; o >= h; h = hidden_width(t, ++l)) {
        o -= h;
        z += 2 * TE * h;
      }
      // h_l follows z_l; dz_l lies over z_l, the last layer's in dzl
      v = c < L.dz ? z[TE * h + o * TE + e] : (l == d.nh - 1 ? t.dzl : z)[o * TE + e];
    }
    work[(size_t)t.flats[e] * L.stride + c] = v;
  }
}

// The dw columns of column block B (over w in t.ws) into the records (CL:
// at W3's columns, by the block's map).
template <bool CL = false>
__device__ inline void write_dw_records(const WsLayout& L, const Tile& t, const Blk& B, int ne,
                                        float* __restrict__ work) {
  const int* gmap = CL ? blk_gmap(t.tabs, B) : nullptr;
  for (int idx = threadIdx.x; idx < ne * B.width; idx += NT) {
    const int e = idx / B.width, j = idx - e * B.width;
    work[(size_t)t.flats[e] * L.stride + L.dw + w3_col<CL>(gmap, B.c0 + j)] = t.ws[e * t.SW + j];
  }
}

// dz of the last hidden layer's row o, edge e, from its sum s over a
// cluster's ranks: s / sqrt(hl) * silu'(z) * cst; with no hidden layer
// (hl = n_basis, the sum is demb) s / sqrt(hl). (w3_backward's last block
// applies the same on one CTA.)
__device__ __forceinline__ float dz_last(const ConvDims& d, const Tile& t, int o, int e, float s) {
  const float inv_h2 = (float)(1.0 / sqrt((double)d.hl));
  if (d.nh == 0) return s * inv_h2;
  const float z = t.zh[TE * 2 * (d.hsum - d.hl) + o * TE + e];
  const float sg = sigmoidf_(z);
  return s * inv_h2 * (sg * (1.0f + z * (1.0f - sg)) * d.act_cst);
}

// dz of the last hidden layer (TE x hl) = (dw W3^T) / sqrt(hl) * silu'(z) *
// cst, with dw of column block B in t.ws: 3xTF32 mma.sync over the block's
// W3 sub-blocks (pipelined as in w3_forward, row stride SBB), OG hidden
// units per pass. The k dimension is split over the warps: warp w takes
// the 8 columns of k-step w of every sub-block against all n-tiles, so each
// dw fragment is loaded and split once. The NWARP partial sums go through
// t.stage after the last sub-block and are added in warp order, then to
// what the earlier blocks left in t.dzl (block order); the last block
// applies silu' (a cluster's CTAs leave it to the sum over the ranks,
// cluster_sums). The caller has issued the first sub-block into
// buffer 0 (stage_w3(..., 0, min(OG, round8(hl)), w3_sub_col(B, 0), B.c0 +
// B.width, SBB)). CL: a cluster's block (stage_w3).
template <bool CL = false>
__device__ inline void w3_backward(const ConvDims& d, const Tile& t, const float* __restrict__ W3,
                                   const Blk& B, bool first, bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h2p = round8(d.hl);
  const int nblk = (B.width + BN - 1) / BN;
  const int jend = B.c0 + B.width;
  const int S = t.nstage;
  const float inv_h2 = (float)(1.0 / sqrt((double)d.hl));
  const float cst = d.act_cst;
  const int* gmap = CL ? blk_gmap(t.tabs, B) : nullptr;
  for (int og = 0; og < h2p; og += OG) {
    const int nrow = min(OG, h2p - og);
    for (int jb = og > 0 ? 0 : 1; jb < S - 1 && jb < nblk; ++jb)
      stage_w3<CL>(d, W3, t.stage + jb * OG * SBB, og, nrow, w3_sub_col(B, jb), jend, SBB, gmap);
    float acc[OG / 8][4];
#pragma unroll
    for (int nt = 0; nt < OG / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    for (int jb = 0; jb < nblk; ++jb) {
      const int ahead = jb + S - 1;
      if (ahead < nblk)
        stage_w3<CL>(d, W3, t.stage + (ahead % S) * OG * SBB, og, nrow, w3_sub_col(B, ahead), jend,
                     SBB, gmap);
      cp_async_wait(min(S - 1, nblk - 1 - jb));
      __syncthreads();
      const float* Bs = t.stage + (jb % S) * OG * SBB;
      const int jk = w3_sub_col(B, jb) + warp * 8;
      const int j = jk + q, c = j - B.c0;
      if (jk < jend) {
        float a[4];
        a[0] = j < jend ? t.ws[g * t.SW + c] : 0.0f;
        a[1] = j < jend ? t.ws[(g + 8) * t.SW + c] : 0.0f;
        a[2] = j + 4 < jend ? t.ws[g * t.SW + c + 4] : 0.0f;
        a[3] = j + 4 < jend ? t.ws[(g + 8) * t.SW + c + 4] : 0.0f;
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
      if (og + o < d.hl) {
        float s = 0.0f;
        for (int w = 0; w < NWARP; ++w) s += red[(w * TE + e) * SBF + o];
        float* dz = t.dzl + (og + o) * TE + e;
        if (!first) s = *dz + s;
        if (last && d.nh > 0) {
          const float z = t.zh[TE * 2 * (d.hsum - d.hl) + (og + o) * TE + e];
          const float sg = sigmoidf_(z);
          s = s * inv_h2 * (sg * (1.0f + z * (1.0f - sg)) * cst);
        } else if (last) {
          s = s * inv_h2;  // no hidden layer: this is demb (hl = n_basis)
        }
        *dz = s;
      }
    }
    __syncthreads();
  }
}

// A cluster's block B: the block's run of ybar (its instructions' outputs,
// d3 runs of mul columns of the row each, a warp an instruction) into t.yb
// by asynchronous copies, committed as one group; the block's w3_forward
// waits for it. yb_at(c) holds the rank's output column B's first + c.
__device__ inline void load_block_ybar(const ConvDims& d, const Tile& t, const float* __restrict__ ybar,
                                       int i, const Blk& B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = blk_y0(t.tabs, B), k0 = blk_k0(t.tabs, B);
  for (int k = k0 + warp; k < k0 + blk_nk(t.tabs, B); k += NWARP) {
    const UvuIns I = uvu_ins(t.tabs, k);
    const int* rec = t.tabs + t.tabs[0] + k * UVU_INS;
    const float* yrow = ybar + (size_t)i * d.dim_mid + rec[UVU_GY];
    for (int p = 0; p < I.d3; ++p)
      for (int u = lane; u < I.mul; u += 32)
        cp_async4(t.yb + yb_at(I.y_start - y0 + p * I.mul + u), yrow + p * rec[UVU_GUT] + u, 4);
  }
  cp_async_commit();
}

// The backward's work on column block B after its w and tmp (for block 0
// load_tile's): the uvu pullback, dsh and the last hidden layer's dz,
// added to the earlier blocks' unless FIRST, and dxg, added to the earlier
// blocks' with ACC; with PG the block's dw records. Block 0 is its own
// instance, so that a layer of one block (every SevenNet-0 layer) runs
// straight through, with nothing to add. CL: a cluster's block, its ybar
// read here for blocks after the first (the caller reads block 0's before
// load_tile), dxg added in the CTA's tile.
template <bool PG, bool FIRST, bool ACC = !FIRST, bool CL = false>
__device__ __forceinline__ void bwd_block(const ConvDims& d, const Tile& t, const Blk& B, bool last,
                                          int ne, int i, const float* __restrict__ W3,
                                          const float* __restrict__ ftab,
                                          const float* __restrict__ ybar, float* __restrict__ dxg,
                                          const WsLayout& L, float* __restrict__ work, Prof& prof) {
  const int DF = d.dim_f;
  const int yoff = CL ? blk_y0(t.tabs, B) : 0;
  if (!FIRST) {
    if (CL) load_block_ybar(d, t, ybar, i, B);
    block_tmp(d, t, ftab, B);
    stage_w3_first<CL>(d, W3, t, B);
    w3_forward<3, false, CL>(d, t, W3, B);
    prof.mark(3);
  }
  // W3's first sub-block for the dz product is copied during the uvu steps
  stage_w3<CL>(d, W3, t.stage, 0, min(OG, round8(d.hl)), w3_sub_col(B, 0), B.c0 + B.width, SBB,
               CL ? blk_gmap(t.tabs, B) : nullptr);
  // the uvu pullback on the tensor cores: dtmp first (it reads w), then
  // dsh += dtmp w3j_pack[B's rows] and dxg, dw (written over w)
  uvu_dtmp<CL>(t, B, yoff);
  __syncthreads();
  prof.mark(8);
  {
    const float* dsh = t.dsh;
    small_product(t.dtmp, 1, t.SR, B.rows, ftab + (size_t)B.r0 * DF, DF, 1, DF, t.dsh, 1, DF,
                  [=](float v, int f, int e) { return FIRST ? v : dsh[e * DF + f] + v; });
  }
  uvu_dxg_dw<ACC, CL>(d, t, ne, dxg, B, yoff);
  __syncthreads();
  prof.mark(9);
  // dz of the last hidden layer += (dw @ W3^T) / sqrt(hl) * silu'(z) * cst
  w3_backward<CL>(d, t, W3, B, FIRST, last);
  if (PG) write_dw_records<CL>(L, t, B, ne, work);
  prof.mark(5);
}

// Rank 0 of a cluster, after the barrier that publishes every rank's
// partial sums of the tile: dz of the last hidden layer = dz_last(sum of
// the ranks' in rank order) and dsh = the ranks' sum in rank order, read
// from the other ranks' shared memory, into its own t.dzl and t.dsh.
__device__ inline void cluster_sums(const ConvDims& d, const Tile& t) {
  const int nr = cluster_ctas();
  for (int idx = threadIdx.x; idx < d.hl * TE; idx += NT) {
    float s = t.dzl[idx];
    for (int r = 1; r < nr; ++r) s += peer(t.dzl, r)[idx];
    t.dzl[idx] = dz_last(d, t, idx / TE, idx % TE, s);
  }
  for (int idx = threadIdx.x; idx < TE * d.dim_f; idx += NT) {
    float s = t.dsh[idx];
    for (int r = 1; r < nr; ++r) s += peer(t.dsh, r)[idx];
    t.dsh[idx] = s;
  }
}

// A cluster's CTA: its dxg tile's rows e < ne (the rank's columns) to the
// tile's edges' rows of dxg, 16 bytes a copy.
__device__ inline void store_dxg_tile(const ConvDims& d, const Tile& t, int ne, float* __restrict__ dxg) {
  const int c4 = t.tabs[H_XW] / XMAP;
  const int* xmap = t.tabs + t.tabs[H_XMAP];
  for (int idx = threadIdx.x; idx < ne * c4; idx += NT) {
    const int e = idx / c4, c = idx - e * c4;
    const float4 v = *(const float4*)(t.dxt + e * t.SX + XMAP * c);
    *(float4*)(dxg + (size_t)t.flats[e] * d.dim_x + xmap[c]) = v;
  }
}

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode; (da, db):
// (dvec, unused) in vec mode, (demb, dsh) in emb/sh mode. mblk: the ybar
// columns the CTA holds (the row's; a cluster's, its widest block's). CL: a
// cluster's CTA (rank cluster_rank() of receiver row blockIdx.x / C, xw
// columns of x, fused_conv_common.cuh): it adds its dxg in its tile and
// stores it, and rank 0 adds the ranks' dz and dsh and runs the chain.
template <bool PG, bool EMBSH, bool CL>
__global__ void __launch_bounds__(NT, 1) fused_conv_bwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ ea, const float* __restrict__ eb, MlpWeights W,
    const float* __restrict__ W3, const float* __restrict__ ybar,
    const int* __restrict__ itab, const float* __restrict__ ftab,
    float* __restrict__ dxg, float* __restrict__ da, float* __restrict__ db, WsLayout L,
    float* __restrict__ work, unsigned char* __restrict__ wvalid, int mblk, int xw) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, true, (char*)smem_raw, &t, mblk, CL ? xw : -1);
  const int i = CL ? (int)blockIdx.x / cluster_ctas() : (int)blockIdx.x;
  const bool lead = !CL || cluster_rank() == 0;  // forms the edge cotangents
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NK = d.N * d.K;
  const int NB = d.n_basis, DF = d.dim_f;
  Prof prof;
  prof.start();
  if constexpr (CL)
    load_rank_tabs(d, t, itab, cluster_rank());
  else
    load_tabs(d, t, itab);
  list_slots<EMBSH>(d, t, i, ea);
  const int nv = *t.count;
  if (PG && lead) {
    for (int k = tid; k < d.K; k += NT) wvalid[(size_t)i * d.K + k] = t.valid[k];
  }

  // exact zeros for the slots outside the cutoff (vec mode; a cluster's CTA
  // its rank's columns of dxg)
  const int xn = CL ? t.tabs[H_XW] : d.dim_x;
  const int* xmap = t.tabs + t.tabs[H_XMAP];
  for (int idx = tid; !EMBSH && idx < d.K * xn; idx += NT) {
    const int k = idx / xn, c = idx - k * xn;
    if (!t.valid[k])
      dxg[(size_t)(i * d.K + k) * d.dim_x + (CL ? xmap[c / XMAP] + c % XMAP : c)] = 0.0f;
  }
  for (int k = tid; !EMBSH && lead && k < d.K; k += NT) {
    if (!t.valid[k]) {
      const int flat = i * d.K + k;
      da[flat] = 0.0f;
      da[NK + flat] = 0.0f;
      da[2 * NK + flat] = 0.0f;
    }
  }

  const float inv_nb = (float)(1.0 / sqrt((double)NB));
  const float cst = d.act_cst;

  // one CTA holds the row's ybar, a cluster's CTA a block's at a time
  if (!CL) {
    const int mw = t.tabs[H_MW];
    for (int c = tid; c < mw; c += NT) t.yb[yb_at(c)] = ybar[(size_t)i * d.dim_mid + c];
  }
  prof.mark(0);
  const int nb = n_blocks(t.tabs);

  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    if (CL) load_block_ybar(d, t, ybar, i, uvu_blk(t.tabs, 0));
    load_tile<EMBSH, 3, false, MLP_FULL, true, CL>(d, t, i, t0, ne, x, src, ea, eb, W, W3, ftab,
                                                   uvu_blk(t.tabs, 0), prof);
    // rank 0 has read this CTA's partial sums of the previous tile
    if (CL && t0 > 0) cluster_wait();
    bwd_block<PG, true, false, CL>(d, t, uvu_blk(t.tabs, 0), !CL && nb == 1, ne, i, W3, ftab, ybar,
                                   dxg, L, work, prof);
    for (int b = 1; b < nb; ++b)
      bwd_block<PG, false, true, CL>(d, t, uvu_blk(t.tabs, b), !CL && b == nb - 1, ne, i, W3, ftab,
                                     ybar, dxg, L, work, prof);
    if constexpr (CL) {
      store_dxg_tile(d, t, ne, dxg);
      // every rank's partial sums published; rank 0 adds them in rank order
      cluster_arrive();
      cluster_wait();
      if (lead) cluster_sums(d, t);
      cluster_arrive();
      __syncthreads();
      prof.mark(11);
      if (!lead) continue;
    }
    // down the hidden layers, dz_l = (dz_{l+1} @ W_{l+1}^T) / sqrt(h_l) *
    // silu'(z_l) * cst over z_l, then demb = (dz_0 @ W_0^T) / sqrt(n_basis):
    // 3xTF32 on the tensor cores
    for (int l = d.nh - 2; l >= 0; --l) {
      const int h = hidden_width(t, l), h_next = hidden_width(t, l + 1);
      float* zT = hidden_z(t, l);
      const float* dz_next = l + 1 == d.nh - 1 ? t.dzl : zT + 2 * TE * h;
      const float inv = (float)(1.0 / sqrt((double)h));
      small_product(dz_next, TE, 1, h_next, mlp_weight(W, l + 1), 1, h_next, h, zT, TE, 1,
                    [=](float s, int o, int e) {
                      const float z = zT[o * TE + e];
                      const float sg = sigmoidf_(z);
                      return s * inv * (sg * (1.0f + z * (1.0f - sg)) * cst);
                    });
      __syncthreads();
    }
    if (d.nh > 0) {
      const int h0 = hidden_width(t, 0);
      small_product(d.nh == 1 ? t.dzl : t.zh, TE, 1, h0, mlp_weight(W, 0), 1, h0, NB, t.demb, 1,
                    NB, [=](float v, int, int) { return v * inv_nb; });
    } else {
      // no hidden layer: the W3 product left demb in dzl, (n_basis x TE)
      for (int idx = tid; idx < TE * NB; idx += NT) {
        const int e = idx / NB;
        t.demb[idx] = t.dzl[(idx - e * NB) * TE + e];
      }
    }
    __syncthreads();
    prof.mark(6);
    if (PG) write_records(d, L, t, ne, work);
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
  // pairs the last tile's arrive: no CTA leaves while rank 0 may still read
  // its shared memory
  if (CL && nv > 0) cluster_wait();
  prof.store();
}

template <bool PG, bool EMBSH>
static int launch_bwd(const ConvDims& d, int mblk, int xw, int cl, int* limits, const float* x,
                      const int* src, const float* ea, const float* eb, const MlpWeights& W,
                      const float* ybar, const int* itab, const float* ftab, float* dxg, float* da,
                      float* db, const WsLayout& L, float* work, unsigned char* wvalid,
                      void* stream) {
  const size_t smem = carve(d, true, nullptr, nullptr, mblk, cl > 1 ? xw : -1);
  if (cl > 1)
    return launch_cluster(fused_conv_bwd_kernel<PG, EMBSH, true>, d.N * cl, cl, smem, stream,
                          limits + MAX_DEVICES, d, x, src, ea, eb, W,
                          W.w[d.nh], ybar, itab, ftab, dxg, da, db, L, work, wvalid, mblk, xw);
  const void* fn = (const void*)fused_conv_bwd_kernel<PG, EMBSH, false>;
  cudaError_t err = raise_smem_limit(fn, smem, limits);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_bwd_kernel<PG, EMBSH, false><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, ea, eb, W, W.w[d.nh], ybar, itab, ftab, dxg, da, db, L, work, wvalid, mblk, xw);
  return (int)cudaGetLastError();
}

// per entry: the one-CTA kernel's smem limit by device, then the cluster
// kernel's
static int smem_limit[2 * MAX_DEVICES];
static int smem_limit_pg[2 * MAX_DEVICES];
static int smem_limit_embsh[2 * MAX_DEVICES];
static int smem_limit_embsh_pg[2 * MAX_DEVICES];

// B2. Returns cudaGetLastError() after the launch (0 = launched), or
// CLUSTER_UNSCHEDULABLE. mblk, xw, cl: the ybar columns a CTA holds, a
// cluster's x columns (-1: one CTA) and CTAs per receiver row
// (ops/fused_conv.py: BlockPlan.launch_args).
extern "C" int fused_conv_bwd_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                     const int* src, const float* vec, const float* coef,
                                     MlpWeights W, const float* ybar, const int* itab,
                                     const float* ftab, float* dxg, float* dvec, void* stream) {
  return launch_bwd<false, false>(d, mblk, xw, cl, smem_limit, x, src, vec, coef, W, ybar, itab,
                                  ftab, dxg, dvec, nullptr, WsLayout{}, nullptr, nullptr, stream);
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
extern "C" int fused_conv_bwd_slot_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                          const int* src_c,
                                          const float* vec_c, const float* coef, MlpWeights W,
                                          const float* ybar_c, const int* itab, const float* ftab,
                                          float* buf, int slot, float* dvec, void* stream) {
  float* dxg = buf + (size_t)slot * d.N * d.K * d.dim_x;
  return launch_bwd<false, false>(d, mblk, xw, cl, smem_limit, x, src_c, vec_c, coef, W, ybar_c,
                                  itab, ftab, dxg, dvec, nullptr, WsLayout{}, nullptr, nullptr,
                                  stream);
}

// B2', first pass: B2 plus the workspace records (N*K rows of L.stride
// floats) and the validity byte of every slot (N*K).
extern "C" int fused_conv_bwd_pg_launch(ConvDims d, int mblk, int xw, int cl, WsLayout L,
                                        const float* x, const int* src,
                                        const float* vec, const float* coef, MlpWeights W,
                                        const float* ybar, const int* itab, const float* ftab,
                                        float* dxg, float* dvec, float* work,
                                        unsigned char* wvalid, void* stream) {
  return launch_bwd<true, false>(d, mblk, xw, cl, smem_limit_pg, x, src, vec, coef, W, ybar, itab,
                                 ftab, dxg, dvec, nullptr, L, work, wvalid, stream);
}

// B4 bwd: emb (N*K, n_basis), sh (N*K, dim_f) -> dxg, demb, dsh.
extern "C" int fused_conv_bwd_embsh_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                           const int* src,
                                           const float* emb, const float* sh, MlpWeights W,
                                           const float* ybar, const int* itab, const float* ftab,
                                           float* dxg, float* demb, float* dsh, void* stream) {
  return launch_bwd<false, true>(d, mblk, xw, cl, smem_limit_embsh, x, src, emb, sh, W, ybar, itab,
                                 ftab, dxg, demb, dsh, WsLayout{}, nullptr, nullptr, stream);
}

// B4 bwd into a slot, the emb/sh ring backward's per-chunk kernel. Replaces
// the Pallas TPU kernel make_fused_conv_bwd2 with embed=None as the JAX
// emb/sh ring runs it per chunk (sevennet_tpu/ops/fused_conv.py, pallas_call
// at :1222, caller :1857-1863): B4 bwd on the d.N = RC receiver rows of one
// chunk, its dxg written in place into slot `slot` of the caller's rolling
// buffer buf (S * RC*K rows of dim_x), as B3 is B2's kernel into a slot. The
// slot is a pointer offset: src_c, ybar_c, emb_c and sh_c point at the
// chunk's first row, demb and dsh are the chunk's own (RC*K) rows. Rows of
// other slots are not touched. What bounds it: B4 bwd's fp32 operations on
// the chunk's edges.
extern "C" int fused_conv_bwd_embsh_slot_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                                const int* src_c, const float* emb_c,
                                                const float* sh_c, MlpWeights W,
                                                const float* ybar_c, const int* itab,
                                                const float* ftab, float* buf, int slot,
                                                float* demb, float* dsh, void* stream) {
  float* dxg = buf + (size_t)slot * d.N * d.K * d.dim_x;
  return launch_bwd<false, true>(d, mblk, xw, cl, smem_limit_embsh, x, src_c, emb_c, sh_c, W, ybar_c,
                                 itab, ftab, dxg, demb, dsh, WsLayout{}, nullptr, nullptr, stream);
}

// B4', first pass: B4 bwd plus the records (no dcoef columns: L.dc is the
// end of the record) and a validity byte of 1 for every slot.
extern "C" int fused_conv_bwd_embsh_pg_launch(ConvDims d, int mblk, int xw, int cl, WsLayout L,
                                              const float* x,
                                              const int* src, const float* emb, const float* sh,
                                              MlpWeights W, const float* ybar, const int* itab,
                                              const float* ftab, float* dxg, float* demb,
                                              float* dsh, float* work, unsigned char* wvalid,
                                              void* stream) {
  return launch_bwd<true, true>(d, mblk, xw, cl, smem_limit_embsh_pg, x, src, emb, sh, W, ybar, itab,
                                ftab, dxg, demb, dsh, L, work, wvalid, stream);
}
