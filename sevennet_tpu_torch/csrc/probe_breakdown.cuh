// Breakdown and knock-out probes of the emb/sh fused conv forward (B4 fwd,
// fused_conv_fwd.cu): B4's tile loop with compile-time phase parameters,
// one instantiation per variant of the TPU probes
//   scripts_dev/r2_fused_breakdown.py:build (pallas_call at :170),
//   build_feat (:262), build_featroll (:343)  csrc/probe_breakdown.cu,
//                                             probe_breakdown_k.cu,
//                                             probe_breakdown_feat.cu
//   scripts_dev/r3_fwd_knockout.py:make (:128) csrc/probe_knockout.cu
// Each TPU variant is a partial or whole forward conv on the gathered
// sender rows xg (N K, dim_x), emb (N K, n_basis), sh (N K, dim_f): the
// radial MLP (w), tmp = sh w3j_pack^T, the uvu terms (x w) tmp[r] per
// (instruction, m, p), the sum over each receiver's K slots, the stores.
// The wrapper (probes/breakdown.py, probes/knockout.py) passes x = xg and
// src = arange(N K).view(N, K), the identity gather, so that a variant's
// input is the script's xg and the full instantiation is B4 fwd itself.
// What each computes is the TPU kernel's function at A = 1 receiver per
// grid step on receiver-major rows (one CTA per receiver here): every K-sum
// method gives the true per-receiver sum, the witnesses write slot 0.
//
// The phases (struct Phases, one row per variant in pb_phases):
//   passes  TF32 passes of the MLP layers, W3 and tmp products: 3 (3xTF32,
//           fp32 accuracy, the TPU's Precision.HIGHEST) or 1 (one TF32
//           pass, the counterpart of the TPU's one bf16 MXU pass at
//           default precision); the uvu product is always 3xTF32, the
//           counterpart of the VPU's fp32 FMAs
//   mlp     MLP_FULL, MLP_KNOCK (w = 0.1 emb[:, 0], no MLP layer, no W3
//           staged), MLP_NONE (the transpose witness: the gather alone)
//   tmp     whether tmp is formed
//   uvu     none; PB_UVU_MMA, B4's: the K sum inside the mma's k dimension
//           (m, 8 edges), plus outacc across tiles; PB_UVU_EDGE: per-edge
//           messages, the mma's k over m only (uvu_edges), then ksum
//   ksum    of the per-edge messages: PB_KS_RUN, a running sum in edge
//           order, in registers (the script's reshape-sum); PB_KS_HALVE, a
//           halving chain over a tile's 16 edges in shared memory, as
//           probe_fold_conv.cu's sliceadd (16 -> 8 as edges 8-15 are added onto
//           the staged rows of edges 0-7, then 8 -> 4 -> 2 -> 1: the
//           script's kred and roll chain), the tiles' sums then added in
//           order; PB_KS_MM, a 0/1 mma.sync product (the script's ONES
//           matrix) over 8 staged edges at a time; PB_KS_NONE (tp adds each
//           edge's messages into its lanes; nofold stages them)
//   out     what is stored: the conv's grouped columns; the 128 padded
//           lanes that tp and tpred* add every (instruction, p) into (per
//           receiver, or per edge for tp, slot 0's row written); storek's
//           aligned 128-column windows, last writer wins (a host map
//           omap); slot 0's message (nofold); slot 0's w, tmp or x row;
//           the broadcast w[0, 0] + tmp[0, 0] (notp, nothing)
//   feat    feature-major tiles (build_feat, build_featroll): xs, ws and
//           tmp stored (features, TE) with rows FS = 20 floats apart, a
//           padded layout (probe_xpose.cu: an unpadded one conflicts)
// A CTA cannot hold all K slots' messages (96 x 3,136 floats is 1.2 MB),
// so the halving and 0/1 sums run per 16-edge tile, as B4's mma sum does.
//
// What bounds them on an H100: as B4 fwd, the W3 product's staging per
// tile; the per-edge uvu product runs 16 mma per task and tile where B4's
// runs 2 d1 (d1 = 1 for a third of SevenNet-0's instructions), and the 0/1
// product 8 more per 8 edges. The variants measure, by what they remove,
// what each phase costs inside B4's overlap (chip_smoke.py:breakdown_phase).
#pragma once

#include "fused_conv_common.cuh"

enum { PB_UVU_NONE = 0, PB_UVU_MMA = 1, PB_UVU_EDGE = 2 };
enum { PB_KS_NONE = 0, PB_KS_RUN = 1, PB_KS_HALVE = 2, PB_KS_MM = 3 };
enum {
  PB_OUT_GROUPED = 0,
  PB_OUT_LANES = 1,       // 128 lanes, per receiver (tpred, tpredk, tpredmm)
  PB_OUT_STOREK = 2,      // grouped, then stored through omap
  PB_OUT_SLOT0 = 3,       // slot 0's message, grouped (nofold)
  PB_OUT_EDGE_LANES = 4,  // 128 lanes per edge, slot 0's row (tp)
  PB_OUT_W = 5,           // slot 0's w row (mlp, featroll mlp_only)
  PB_OUT_TMP = 6,         // slot 0's tmp row
  PB_OUT_X = 7,           // slot 0's x row (transpose)
  PB_OUT_BCAST = 8        // w[0, 0] + tmp[0, 0] in every column (notp, nothing)
};
#define PB_LANES 128  // the TPU's lane width, the padded columns of tp and tpred*
#define PB_MSTR 136   // row stride of a warp's staged messages (8 mod 32: conflict-free reads)

// the variants, numbered as probes/breakdown.py and probes/knockout.py
// number them (_KERNEL)
enum {
  PB_MLP = 0, PB_MLP_HI, PB_TMP, PB_TP, PB_TPRED, PB_FULL, PB_FULL_HI,      // probe_breakdown.cu
  PB_TPREDK, PB_STOREK, PB_FULLK, PB_TPREDMM, PB_FULLMM,                    // probe_breakdown_k.cu
  PB_FEAT_FULL, PB_FEAT_TRANSPOSE, PB_FEATROLL_FULL, PB_FEATROLL_MLP,       // probe_breakdown_feat.cu
  PB_KO_FULL, PB_KO_NOMLP, PB_KO_NOTP, PB_KO_NOFOLD, PB_KO_NOTHING          // probe_knockout.cu
};

struct Phases {
  int passes, mlp;
  bool tmp;
  int uvu, ksum, out;
  bool feat;
};

__host__ __device__ constexpr Phases pb_phases(int v) {
  switch (v) {
    case PB_MLP: return {1, MLP_FULL, false, PB_UVU_NONE, PB_KS_NONE, PB_OUT_W, false};
    case PB_MLP_HI: return {3, MLP_FULL, false, PB_UVU_NONE, PB_KS_NONE, PB_OUT_W, false};
    case PB_TMP: return {1, MLP_FULL, true, PB_UVU_NONE, PB_KS_NONE, PB_OUT_TMP, false};
    case PB_TP: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_NONE, PB_OUT_EDGE_LANES, false};
    case PB_TPRED: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_RUN, PB_OUT_LANES, false};
    case PB_FULL: return {1, MLP_FULL, true, PB_UVU_MMA, PB_KS_NONE, PB_OUT_GROUPED, false};
    case PB_TPREDK: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_HALVE, PB_OUT_LANES, false};
    case PB_STOREK: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_HALVE, PB_OUT_STOREK, false};
    case PB_FULLK: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_HALVE, PB_OUT_GROUPED, false};
    case PB_TPREDMM: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_MM, PB_OUT_LANES, false};
    case PB_FULLMM: return {1, MLP_FULL, true, PB_UVU_EDGE, PB_KS_MM, PB_OUT_GROUPED, false};
    case PB_FEAT_FULL: return {3, MLP_FULL, true, PB_UVU_EDGE, PB_KS_MM, PB_OUT_GROUPED, true};
    case PB_FEAT_TRANSPOSE: return {3, MLP_NONE, false, PB_UVU_NONE, PB_KS_NONE, PB_OUT_X, true};
    case PB_FEATROLL_FULL: return {3, MLP_FULL, true, PB_UVU_EDGE, PB_KS_HALVE, PB_OUT_GROUPED, true};
    case PB_FEATROLL_MLP: return {3, MLP_FULL, true, PB_UVU_NONE, PB_KS_NONE, PB_OUT_W, true};
    case PB_KO_NOMLP: return {3, MLP_KNOCK, true, PB_UVU_MMA, PB_KS_NONE, PB_OUT_GROUPED, false};
    case PB_KO_NOTP: return {3, MLP_FULL, true, PB_UVU_NONE, PB_KS_NONE, PB_OUT_BCAST, false};
    case PB_KO_NOFOLD: return {3, MLP_FULL, true, PB_UVU_EDGE, PB_KS_NONE, PB_OUT_SLOT0, false};
    case PB_KO_NOTHING: return {3, MLP_KNOCK, true, PB_UVU_NONE, PB_KS_NONE, PB_OUT_BCAST, false};
    default: return {3, MLP_FULL, true, PB_UVU_MMA, PB_KS_NONE, PB_OUT_GROUPED, false};  // B4
  }
}

// a warp's 8 staged edges of 128 messages fit in the stage that W3 leaves
// free during the uvu step (stage_floats: at least NWARP TE SBF floats)
static_assert(NWARP * 8 * PB_MSTR <= NWARP * TE * SBF, "staged messages fit the W3 stage");
static_assert(TE * PB_LANES <= NWARP * TE * SBF, "tp's lanes fit the W3 stage");

__device__ __forceinline__ float sum_quad(float v) {  // over the 4 lanes of a fragment row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Lane (g, q)'s messages of one edge into row j of a warp's staged
// messages (ADD: onto it), column (channel, p) = channel * 8 + p of the
// task's 128.
template <bool ADD = false>
__device__ __forceinline__ void stage_messages(float* mbuf, int j, int g, int q,
                                               const float (&c)[4]) {
  float* row = mbuf + j * PB_MSTR;
  const int col[4] = {g * 8 + 2 * q, g * 8 + 2 * q + 1, (g + 8) * 8 + 2 * q,
                      (g + 8) * 8 + 2 * q + 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) row[col[k]] = ADD ? row[col[k]] + c[k] : c[k];
}

// The uvu product as per-edge messages: for edge e and task (instruction,
// 16 channels from u0), msg[e, u, p] = sum_m (x[e, m, u] w[e, u]) tmp[e,
// r(m, p)], one 16 (channels) x 8 (m) x 8 (p) 3xTF32 mma.sync per edge;
// lane (g, q) holds channels u0 + g and u0 + g + 8 at p = 2q, 2q + 1. Then
// the K sum KSUM and the stores OUT (see the top of this file). buf: the
// W3 stage, free here (the staged messages of KS_HALVE, KS_MM and nofold,
// tp's per-edge lanes). Every edge's messages reach shared memory, the
// running sum or the lanes: ptxas drops an mma whose result nothing reads,
// so nofold stages them too.
template <int KSUM, int OUT, bool FEAT>
__device__ inline void uvu_edges(const Tile& t, const Blk& B, int t0) {
  const int* tab = t.tabs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int* tasks = tab + tab[7];
  const int* runs = tab + tab[B.rec + 6];
  float* mbuf = t.stage + warp * 8 * PB_MSTR;  // KS_MM: 8 edges x (16 channels x 8 p)
  for (int task = runs[warp]; task < runs[warp + 1]; ++task) {
    const UvuIns I = uvu_ins(tab, tasks[4 * task]);
    const int u0 = tasks[4 * task + 1];
    const int ua = u0 + g, ub = u0 + g + 8;  // A rows: channels
    const bool oka = ua < I.mul, okb = ub < I.mul;
    const bool m0 = q < I.d1, m1 = q + 4 < I.d1;  // A columns: m = q, q + 4
    const int xa = I.x_start + q * I.mul, xb = I.x_start + (q + 4) * I.mul;
    const int ra = m0 && g < I.d3 ? I.rtab[q * UVU_D + g] : -1;  // B (m, p = g)
    const int rb = m1 && g < I.d3 ? I.rtab[(q + 4) * UVU_D + g] : -1;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // KS_RUN
    float mm[8][4];                            // KS_MM: 8 row tiles of 16 message columns
    if constexpr (KSUM == PB_KS_MM) {
#pragma unroll
      for (int rt = 0; rt < 8; ++rt) mm[rt][0] = mm[rt][1] = mm[rt][2] = mm[rt][3] = 0.0f;
    }
#pragma unroll
    for (int e0 = 0; e0 < TE; e0 += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j;
        const float wa = oka ? ws_at<FEAT>(t, e, I.w_start + ua) : 0.0f;
        const float wb = okb ? ws_at<FEAT>(t, e, I.w_start + ub) : 0.0f;
        float a[4];
        a[0] = oka && m0 ? xs_at<FEAT>(t, e, xa + ua) * wa : 0.0f;
        a[1] = okb && m0 ? xs_at<FEAT>(t, e, xa + ub) * wb : 0.0f;
        a[2] = oka && m1 ? xs_at<FEAT>(t, e, xb + ua) * wa : 0.0f;
        a[3] = okb && m1 ? xs_at<FEAT>(t, e, xb + ub) * wb : 0.0f;
        const float b[2] = {ra >= 0 ? tmp_at<FEAT>(t, e, ra) : 0.0f,
                            rb >= 0 ? tmp_at<FEAT>(t, e, rb) : 0.0f};
        unsigned ah[4], al[4];
        split4(a, ah, al);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(c, ah, al, b);
        if constexpr (KSUM == PB_KS_RUN) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] += c[k];
        } else if constexpr (KSUM == PB_KS_HALVE) {
          // 16 -> 8: edges 0-7 staged, edges 8-15 added onto them
          if (e0 == 0)
            stage_messages(mbuf, j, g, q, c);
          else
            stage_messages<true>(mbuf, j, g, q, c);
        } else if constexpr (KSUM == PB_KS_MM) {
          stage_messages(mbuf, j, g, q, c);
        } else if constexpr (OUT == PB_OUT_EDGE_LANES) {
          // tp: this edge's messages added over p into its 128 lanes
          const float sa = sum_quad(c[0] + c[1]), sb = sum_quad(c[2] + c[3]);
          if (q == 0) {
            if (oka) atomicAdd(t.stage + e * PB_LANES + ua, sa);
            if (okb) atomicAdd(t.stage + e * PB_LANES + ub, sb);
          }
        } else if constexpr (OUT == PB_OUT_SLOT0) {
          stage_messages(mbuf, j, g, q, c);
          if (e == 0 && t0 == 0) {  // nofold: slot 0's message, no K sum
            const int p = 2 * q;
            if (oka && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ua] = c[0];
            if (oka && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ua] = c[1];
            if (okb && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ub] = c[2];
            if (okb && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ub] = c[3];
          }
        }
      }
      if constexpr (KSUM == PB_KS_MM) {
        // the 0/1 product: row tile rt (message columns rt 16 ..) times a
        // 0/1 column of the 8 edges, 3xTF32; lanes q = 0 get the sums of
        // columns rt 16 + g and rt 16 + g + 8 (channels u0 + 2 rt and + 1,
        // p = g)
        __syncwarp();
        const float one = g == 0 ? 1.0f : 0.0f;
        const float b[2] = {one, one};
#pragma unroll
        for (int rt = 0; rt < 8; ++rt) {
          if (u0 + 2 * rt < I.mul) {
            float a[4];
            a[0] = mbuf[q * PB_MSTR + rt * 16 + g];
            a[1] = mbuf[q * PB_MSTR + rt * 16 + g + 8];
            a[2] = mbuf[(q + 4) * PB_MSTR + rt * 16 + g];
            a[3] = mbuf[(q + 4) * PB_MSTR + rt * 16 + g + 8];
            unsigned ah[4], al[4];
            split4(a, ah, al);
            mma_3xtf32(mm[rt], ah, al, b);
          }
        }
        __syncwarp();
      }
    }
    // the tile's sums of the task's columns
    if constexpr (KSUM == PB_KS_RUN || KSUM == PB_KS_HALVE) {
      float r[4];
      if constexpr (KSUM == PB_KS_HALVE) {
        // 8 -> 4 -> 2 -> 1 in shared memory, lane l on the columns l + 32 i
        __syncwarp();
#pragma unroll
        for (int h = 4; h > 0; h >>= 1) {
#pragma unroll
          for (int j = 0; j < h; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mbuf[j * PB_MSTR + lane + 32 * i] += mbuf[(j + h) * PB_MSTR + lane + 32 * i];
          __syncwarp();
        }
        r[0] = mbuf[g * 8 + 2 * q];
        r[1] = mbuf[g * 8 + 2 * q + 1];
        r[2] = mbuf[(g + 8) * 8 + 2 * q];
        r[3] = mbuf[(g + 8) * 8 + 2 * q + 1];
        __syncwarp();  // read before the next task stages over row 0
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = acc[k];
      }
      if constexpr (OUT == PB_OUT_LANES) {
        const float sa = sum_quad(r[0] + r[1]), sb = sum_quad(r[2] + r[3]);
        if (q == 0) {
          if (oka) atomicAdd(t.outacc + ua, sa);
          if (okb) atomicAdd(t.outacc + ub, sb);
        }
      } else {  // grouped columns, each owned by this task
        const int p = 2 * q;
        if (oka && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ua] += r[0];
        if (oka && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ua] += r[1];
        if (okb && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ub] += r[2];
        if (okb && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ub] += r[3];
      }
    } else if constexpr (KSUM == PB_KS_MM) {
#pragma unroll
      for (int rt = 0; rt < 8; ++rt) {
        const int ca = u0 + 2 * rt, cb = ca + 1;
        if constexpr (OUT == PB_OUT_LANES) {
          // over p: the lanes q = 0 (lane 4 g); the other lanes hold zeros
          float sa = mm[rt][0], sb = mm[rt][2];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, o);
            sb += __shfl_xor_sync(0xffffffffu, sb, o);
          }
          if (lane == 0) {
            if (ca < I.mul) atomicAdd(t.outacc + ca, sa);
            if (cb < I.mul) atomicAdd(t.outacc + cb, sb);
          }
        } else if (q == 0 && g < I.d3) {
          if (ca < I.mul) t.outacc[I.y_start + g * I.u_tot + ca] += mm[rt][0];
          if (cb < I.mul) t.outacc[I.y_start + g * I.u_tot + cb] += mm[rt][2];
        }
      }
    }
  }
}

// Block B's w and tmp after block 0 (which load_tile forms), by phase.
template <int V>
__device__ inline void pb_block(const ConvDims& d, const Tile& t, const float* __restrict__ W3,
                                const float* __restrict__ ftab, const Blk& B) {
  constexpr Phases P = pb_phases(V);
  if constexpr (P.tmp) block_tmp<P.passes, P.feat>(d, t, ftab, B);
  if constexpr (P.mlp == MLP_FULL) {
    stage_w3_first(d, W3, t, B);
    w3_forward<P.passes, P.feat>(d, t, W3, B);
  } else {
    if constexpr (P.mlp == MLP_KNOCK) knock_w<P.feat>(t, B);
    __syncthreads();
  }
}

// B4 fwd's kernel (fused_conv_fwd.cu:fused_conv_fwd_kernel<true>) with the
// phases of variant V; omap (dim_mid ints, storek only): the grouped column
// each output column takes, -1 for zero.
template <int V>
__global__ void __launch_bounds__(NT, 1) probe_breakdown_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ emb, const float* __restrict__ sh, MlpWeights W,
    const float* __restrict__ W3, const int* __restrict__ itab, const float* __restrict__ ftab,
    const int* __restrict__ omap, float* __restrict__ out) {
  constexpr Phases P = pb_phases(V);
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve<P.feat>(d, false, (char*)smem_raw, &t);
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  Prof prof;
  prof.start();
  load_tabs(d, t, itab);
  list_slots<true>(d, t, i, emb);
  const int nv = *t.count;
  for (int c = tid; c < d.dim_mid; c += NT) t.outacc[c] = 0.0f;
  prof.mark(0);

  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile<true, P.passes, P.feat, P.mlp, P.tmp>(d, t, i, t0, ne, x, src, emb, sh, W, W3, ftab,
                                                    uvu_blk(t.tabs, 0), prof);
    for (int b = 0; b < n_blocks(t.tabs); ++b) {
      const Blk B = uvu_blk(t.tabs, b);
      if (b > 0) {  // load_tile formed block 0's w and tmp
        pb_block<V>(d, t, W3, ftab, B);
        prof.mark(3);
      }
      if constexpr (P.out == PB_OUT_W) {
        if (t0 == 0)
          for (int c = tid; c < B.width; c += NT) t.outacc[B.c0 + c] = ws_at<P.feat>(t, 0, c);
      } else if constexpr (P.out == PB_OUT_TMP) {
        if (t0 == 0)
          for (int r = tid; r < B.rows; r += NT) t.outacc[B.r0 + r] = tmp_at<P.feat>(t, 0, r);
      } else if constexpr (P.out == PB_OUT_X) {
        if (t0 == 0 && b == 0)
          for (int c = tid; c < d.dim_x; c += NT) t.outacc[c] = xs_at<P.feat>(t, 0, c);
      } else if constexpr (P.out == PB_OUT_BCAST) {
        if (t0 == 0 && b == 0 && tid == 0) t.outacc[0] = ws_at<P.feat>(t, 0, 0) + tmp_at<P.feat>(t, 0, 0);
      }
      if constexpr (P.uvu == PB_UVU_MMA) {
        // out[c] += sum_e sum_terms x[e, xc] * w[e, wc] * tmp[e, r], on the tensor cores
        uvu_forward(t, B);
      } else if constexpr (P.uvu == PB_UVU_EDGE) {
        if constexpr (P.out == PB_OUT_EDGE_LANES) {
          for (int k = tid; k < TE * PB_LANES; k += NT) t.stage[k] = 0.0f;
          __syncthreads();
        }
        uvu_edges<P.ksum, P.out, P.feat>(t, B, t0);
        if constexpr (P.out == PB_OUT_EDGE_LANES) {
          __syncthreads();
          if (t0 == 0)
            for (int u = tid; u < PB_LANES; u += NT) t.outacc[u] += t.stage[u];
        }
      }
      __syncthreads();
      prof.mark(4);
    }
  }
  for (int c = tid; c < d.dim_mid; c += NT) {
    float v;
    if constexpr (P.out == PB_OUT_STOREK) {
      const int s = omap[c];
      v = s >= 0 ? t.outacc[s] : 0.0f;
    } else if constexpr (P.out == PB_OUT_BCAST) {
      v = t.outacc[0];
    } else {
      v = t.outacc[c];
    }
    out[(size_t)i * d.dim_mid + c] = v;
  }
  prof.mark(0);
  prof.store();
}

// Launches variant V on d.N receivers; cudaGetLastError() after the
// launch, or cudaErrorInvalidValue when the layer's tiles do not fit a
// CTA's shared memory.
template <int V>
static int pb_launch(const ConvDims& d, const float* x, const int* src, const float* emb,
                     const float* sh, const MlpWeights& W, const int* itab, const float* ftab,
                     const int* omap, float* out, void* stream) {
  static int smem_limit[MAX_DEVICES];
  constexpr Phases P = pb_phases(V);
  const size_t smem = carve<P.feat>(d, false, nullptr, nullptr);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit((const void*)probe_breakdown_kernel<V>, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    probe_breakdown_kernel<V><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, emb, sh, W, W.w[d.nh], itab, ftab, omap, out);
  return (int)cudaGetLastError();
}

#define PB_CASE(V) \
  case V:          \
    return pb_launch<V>(d, x, src, emb, sh, W, itab, ftab, omap, out, stream);

// The C entry of a probe library: variant v of those it instantiates.
#define PB_ENTRY(NAME, CASES)                                                                     \
  extern "C" int NAME(int v, ConvDims d, const float* x, const int* src, const float* emb,        \
                      const float* sh, MlpWeights W, const int* itab, const float* ftab,          \
                      const int* omap, float* out, void* stream) {                                \
    switch (v) { CASES }                                                                          \
    return (int)cudaErrorInvalidValue;                                                            \
  }
