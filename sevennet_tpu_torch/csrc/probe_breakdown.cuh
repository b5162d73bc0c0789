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
//           default precision); B4's uvu product (PB_UVU_MMA) is always
//           3xTF32, the per-edge product (PB_UVU_EDGE) fp32 FMAs on the
//           CUDA cores, the counterparts of the VPU's fp32 FMAs
//   mlp     MLP_FULL, MLP_KNOCK (w = 0.1 emb[:, 0], no MLP layer, no W3
//           staged), MLP_NONE (the transpose witness: the gather alone)
//   tmp     whether tmp is formed
//   uvu     none; PB_UVU_MMA, B4's: the K sum inside the mma's k dimension
//           (m, 8 edges), plus outacc across tiles; PB_UVU_EDGE: per-edge
//           messages (uvu_edges, below), then ksum
//   ksum    of the per-edge messages: PB_KS_RUN, a running sum in edge
//           order, in registers (the script's reshape-sum); PB_KS_HALVE, a
//           halving chain over a tile's 16 edges (16 -> 8 as edges 8-15 are
//           added onto the staged rows of edges 0-7, then 8 -> 4 -> 2 -> 1:
//           the script's kred and roll chain; in shared memory, or across
//           the lanes of the feature-major mapping), the tiles' sums then
//           added in order; PB_KS_MM, a 0/1 mma.sync product (the script's
//           ONES matrix) over staged edges; PB_KS_NONE (tp adds each edge's
//           messages into its lanes; nofold stages them)
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
// The per-edge product (uvu_edges) runs from a host table of tasks
// (probes/breakdown.py:edge_plan), each an instruction's channels from u0,
// balanced over the 8 warps by their cost, and is compiled per instruction
// shape (the paths of l <= 2, probe_fold_conv_paths.cuh: d1, d3 and the
// (m, p) pairs that have a Wigner row), so that its terms are unrolled
// with no test per pair. Each lane forms x[e, m, u] w[e, u] once per m and
// adds the terms in the table's (m, p) order by fmaf from zero. Edge-major
// tiles: lanes on consecutive channels, VW of them a lane (up to 4 at mul
// 128, 2 at 64, 1 at 32: the host picks under each variant's cap,
// probes/breakdown.py:EDGE_VW; at most 2 under the 0/1 sum, whose two
// staged edges must fit a warp's share of the stage, and under the halving
// chain, whose partial sums must fit the registers), so that x and w are
// read as 4-, 8- or 16-byte words without conflict and tmp[e, r] is a
// broadcast. Feature-major tiles
// (whose rows are FS floats apart, where lanes on channels would conflict
// 4 ways): lanes on the 16 edges, the two half-warps on channels 4 apart
// (80 floats, 16 banks), 8 channels a task, tmp read once a task. The
// 0/1 product runs two TF32 passes (lo then hi of the messages: B is exact
// in TF32, so a third pass would add zeros) on m16n8k8 tiles whose k mixes
// edges and column sets, so that several of the 8 N columns carry a sum:
// edge-major 2 edges x 4 sets of 16 columns (N columns 0-3, lanes q < 2),
// feature-major 4 edges x 2 sets (N columns 0-1, lanes q = 0); both read
// their fragments without conflict.
//
// What bounds them on an H100: as B4 fwd, the W3 product's staging per
// tile; then the per-edge product's shared-memory reads (x, w, tmp's
// broadcasts: about 310 wavefronts an edge at SevenNet-0's widths with one
// channel a lane), and the stores and fragment reads of the staged
// messages where a K sum stages them. The variants measure, by what they
// remove, what each phase costs inside B4's overlap
// (chip_smoke.py:breakdown_phase; edge_breakdown.py for the per-edge phase).
#pragma once

#include "fused_conv_common.cuh"
#include "probe_fold_conv_paths.cuh"

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
#define PB_WBUF (TE * SBF)  // floats of the W3 stage each warp stages its per-edge messages in
#define PB_ET_RUNS 2  // the per-edge table's warp runs start here (after its tasks' offset and count)

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

// the warps' message buffers (PB_WBUF each) and tp's per-edge lanes fit the
// stage that W3 leaves free during the uvu step (stage_floats: at least
// NWARP TE SBF)
static_assert(TE * PB_LANES <= NWARP * TE * SBF, "tp's lanes fit the W3 stage");

// bits set in m; the place in an instruction record's rtab (m * UVU_D + p)
// of the first pair of a path's mask
__host__ __device__ constexpr int pb_popc(unsigned long long m) {
  return m ? int(m & 1ull) + pb_popc(m >> 1) : 0;
}
__host__ __device__ constexpr int pb_first_bit(unsigned long long m, int b = 0) {
  return (m >> b) & 1ull ? b : pb_first_bit(m, b + 1);
}
template <int D3>
__host__ __device__ constexpr int pb_first_pair(unsigned long long m) {
  return pb_first_bit(m) / D3 * UVU_D + pb_first_bit(m) % D3;
}
// the least stride >= n that is rem (mod 32), at compile time (bank_stride)
__host__ __device__ constexpr int pb_stride(int n, int rem) { return n + ((rem - n) % 32 + 32) % 32; }

// VW consecutive floats from p (4-, 8- or 16-byte aligned), zeros if !ok;
// and VW into p
template <int VW>
__device__ __forceinline__ void lds_vec(float (&v)[VW], const float* p, bool ok) {
  if constexpr (VW == 4) {
    const float4 a = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (VW == 2) {
    const float2 a = ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = ok ? *p : 0.0f;
  }
}
template <int VW>
__device__ __forceinline__ void sts_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// The terms of one edge (m outer, p inner: the table's order) of path
// (D1, D3, MASK): msg[p][c] += xw[m][c] tmp[r0 + j], j the pair's rank;
// tv(j) reads tmp.
template <int D1, int D3, unsigned long long MASK, int VW, typename TV>
__device__ __forceinline__ void path_terms(const float (&xw)[D1][VW], TV tv, float (&msg)[D3][VW]) {
#pragma unroll
  for (int p = 0; p < D3; ++p)
#pragma unroll
    for (int c = 0; c < VW; ++c) msg[p][c] = 0.0f;
  int j = 0;
#pragma unroll
  for (int m = 0; m < D1; ++m)
#pragma unroll
    for (int p = 0; p < D3; ++p)
      if ((MASK >> (m * D3 + p)) & 1ull) {
        const float t = tv(j++);
#pragma unroll
        for (int c = 0; c < VW; ++c) msg[p][c] = fmaf(xw[m][c], t, msg[p][c]);
      }
}

// Edge-major tiles: edge e's messages for the lane's VW channels from u
// (zeros where !ok), xw = x w once per m; r0 is the instruction's first
// Wigner row in the block.
template <int D1, int D3, unsigned long long MASK, int VW>
__device__ __forceinline__ void edge_msgs(const Tile& t, const UvuIns& I, int r0, int u, bool ok,
                                          int e, float (&msg)[D3][VW]) {
  float w[VW], xw[D1][VW];
  lds_vec<VW>(w, t.ws + e * t.SW + I.w_start + u, ok);
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    lds_vec<VW>(xw[m], t.xs + e * t.SX + I.x_start + m * I.mul + u, ok);
#pragma unroll
    for (int c = 0; c < VW; ++c) xw[m][c] *= w[c];
  }
  const float* tr = t.tmp + e * t.SR + r0;
  path_terms<D1, D3, MASK, VW>(xw, [=](int j) { return tr[j]; }, msg);
}

// A task's sums over the tile (sum[p][c], channels u + c) into the output:
// the 128 lanes, added over p; else the grouped columns the task owns.
template <int OUT, int D3, int VW>
__device__ __forceinline__ void ksum_store(const Tile& t, const UvuIns& I, int u, bool ok,
                                           const float (&sum)[D3][VW]) {
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < VW; ++c) {
    if constexpr (OUT == PB_OUT_LANES) {
      float s = sum[0][c];
#pragma unroll
      for (int p = 1; p < D3; ++p) s += sum[p][c];
      atomicAdd(t.outacc + u + c, s);
    } else {
#pragma unroll
      for (int p = 0; p < D3; ++p) t.outacc[I.y_start + p * I.u_tot + u + c] += sum[p][c];
    }
  }
}

// One task on edge-major tiles: channels u0 .. u0 + 32 VW of instruction I
// (path D1, D3, MASK), lane l on u0 + l VW .. + VW, every edge of the tile,
// then its K sum and stores. mbuf: the warp's PB_WBUF floats of the stage.
template <int KSUM, int OUT, int D1, int D3, unsigned long long MASK, int VW>
__device__ inline void edge_task(const Tile& t, const UvuIns& I, int u0, int t0, float* mbuf,
                                       int lane) {
  const int r0 = I.rtab[pb_first_pair<D3>(MASK)];
  const int u = u0 + lane * VW;
  const bool ok = u < I.mul;
  if constexpr (KSUM == PB_KS_HALVE) {
    // the chain 16 -> 8 -> 4 -> 2 -> 1 (v_j = m_j + m_j+8, w_j = v_j +
    // v_j+4, x_j = w_j + w_j+2, x_0 + x_1) in registers: step i forms w_j,
    // j = 2 (i % 2) + i / 2, from edges j, j + 8, j + 4, j + 12; steps 0-1
    // give x_0, steps 2-3 x_1
    float x0[D3][VW], x[D3][VW];
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int j = 2 * (i & 1) + (i >> 1);
      float m0[D3][VW], m1[D3][VW], w[D3][VW];
      edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, j, m0);
      edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, j + 8, m1);
#pragma unroll
      for (int p = 0; p < D3; ++p)
#pragma unroll
        for (int c = 0; c < VW; ++c) w[p][c] = m0[p][c] + m1[p][c];
      edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, j + 4, m0);
      edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, j + 12, m1);
#pragma unroll
      for (int p = 0; p < D3; ++p)
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          w[p][c] += m0[p][c] + m1[p][c];
          if (i & 1)
            x[p][c] += w[p][c];
          else
            x[p][c] = w[p][c];
          if (i == 1) x0[p][c] = x[p][c];
        }
    }
#pragma unroll
    for (int p = 0; p < D3; ++p)
#pragma unroll
      for (int c = 0; c < VW; ++c) x[p][c] = x0[p][c] + x[p][c];
    ksum_store<OUT, D3, VW>(t, I, u, ok, x);
  } else if constexpr (KSUM == PB_KS_MM) {
    // 2 edges staged as rows [edge][column c = p 32 VW + lane VW + c] (SM
    // floats apart, 8 mod 32), then per 64 columns one m16n8k8 tile: A[i][k]
    // = message (edge k & 1, column 16 n + i), n = (k & 3) / 2 + 2 (k / 4),
    // B[k][n'] = 1 where n' = n: D[i][n] sums column 16 n + i over the two
    // edges; 8 such k-steps (the 16 edges) add into each tile's accumulator
    constexpr int C = 32 * VW * D3, SM = pb_stride(C, 8), NTL = (C + 63) / 64;
    static_assert(2 * SM <= PB_WBUF, "two staged edges fit the warp's buffer");
    const int g = lane >> 2, q = lane & 3;
    const unsigned one = __float_as_uint(1.0f);
    const unsigned b[2] = {g == (q >> 1) ? one : 0u, g == (q >> 1) + 2 ? one : 0u};
    float acc[NTL][4] = {};
    const float* arow = mbuf + (q & 1) * SM + 16 * (q >> 1) + g;
#pragma unroll 1
    for (int e0 = 0; e0 < TE; e0 += 2) {
#pragma unroll
      for (int ei = 0; ei < 2; ++ei) {
        float msg[D3][VW];
        edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, e0 + ei, msg);
#pragma unroll
        for (int p = 0; p < D3; ++p) sts_vec<VW>(mbuf + ei * SM + p * 32 * VW + lane * VW, msg[p]);
      }
      __syncwarp();
#pragma unroll
      for (int tt = 0; tt < NTL; ++tt) {
        const bool top = 64 * tt + 32 < C;  // columns 32-63 of the tile are the task's
        float a[4] = {arow[64 * tt], arow[64 * tt + 8], top ? arow[64 * tt + 32] : 0.0f,
                      top ? arow[64 * tt + 40] : 0.0f};
        unsigned ah[4], al[4];
        split4(a, ah, al);
        mma_tf32(acc[tt], al, b);
        mma_tf32(acc[tt], ah, b);
      }
      __syncwarp();  // read before the next edges are staged
    }
    if (q < 2) {
#pragma unroll
      for (int tt = 0; tt < NTL; ++tt)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // c-slot s: row g + 8 (s / 2), N column 2 q + s % 2
          const int c = 64 * tt + 16 * (2 * q + (s & 1)) + g + 8 * (s >> 1);
          const int uu = u0 + c % (32 * VW);
          if (c < C && uu < I.mul) {
            if constexpr (OUT == PB_OUT_LANES)
              atomicAdd(t.outacc + uu, acc[tt][s]);
            else
              t.outacc[I.y_start + c / (32 * VW) * I.u_tot + uu] += acc[tt][s];
          }
        }
    }
  } else {
    // the running sum, tp's per-edge lanes and nofold's staging: 4 / VW
    // edges a step, so that a lane holds 4 values of each p (its VW
    // channels of each edge); the same steps in all three, so that their
    // products compile alike
    constexpr int EU = 4 / VW;
    static_assert(D3 * 128 <= PB_WBUF, "a step's messages fit the warp's buffer");
    float acc[D3][VW] = {};
#pragma unroll 1
    for (int e0 = 0; e0 < TE; e0 += EU) {
      float v[D3][4];
#pragma unroll
      for (int ei = 0; ei < EU; ++ei) {
        float msg[D3][VW];
        edge_msgs<D1, D3, MASK, VW>(t, I, r0, u, ok, e0 + ei, msg);
#pragma unroll
        for (int p = 0; p < D3; ++p)
#pragma unroll
          for (int c = 0; c < VW; ++c) v[p][ei * VW + c] = msg[p][c];
      }
      if constexpr (KSUM == PB_KS_RUN) {
        // in edge order
#pragma unroll
        for (int ei = 0; ei < EU; ++ei)
#pragma unroll
          for (int p = 0; p < D3; ++p)
#pragma unroll
            for (int c = 0; c < VW; ++c) acc[p][c] += v[p][ei * VW + c];
      } else if constexpr (OUT == PB_OUT_EDGE_LANES) {
        // tp: each edge's messages added over p into its 128 lanes
        if (ok) {
#pragma unroll
          for (int ei = 0; ei < EU; ++ei)
#pragma unroll
            for (int c = 0; c < VW; ++c) {
              float sp = v[0][ei * VW + c];
#pragma unroll
              for (int p = 1; p < D3; ++p) sp += v[p][ei * VW + c];
              atomicAdd(t.stage + (e0 + ei) * PB_LANES + u + c, sp);
            }
        }
      } else {
        static_assert(OUT == PB_OUT_SLOT0, "the per-edge product without a K sum: tp or nofold");
        // nofold: every message staged by 16-byte stores, slot 0's stored
#pragma unroll
        for (int p = 0; p < D3; ++p) sts_vec<4>(mbuf + (32 * p + lane) * 4, v[p]);
        if (e0 == 0 && t0 == 0 && ok) {
#pragma unroll
          for (int p = 0; p < D3; ++p)
#pragma unroll
            for (int c = 0; c < VW; ++c) t.outacc[I.y_start + p * I.u_tot + u + c] = v[p][c];
        }
      }
    }
    if constexpr (KSUM == PB_KS_RUN) ksum_store<OUT, D3, VW>(t, I, u, ok, acc);
  }
}

// One task on feature-major tiles (rows FS floats apart): 8 channels from
// u0, lane (e = l % 16, h = l / 16) on edge e and, in step s, channel u0 +
// 4 h + s; tmp[., e] read once. The halving chain runs across the 16 lanes
// of a half-warp (xor 8, 4, 2, 1: lane e < 8 adds e + 8 first, the
// chain's order); the 0/1 product stages the messages as columns (p 8 +
// channel) of 16 edges (FS floats apart: the half-warps 16 banks apart),
// then per 32 columns one m16n8k8 tile: A[i][k] = message (edge 4 ks + k %
// 4, column 16 (k / 4) + i), B[k][n] = 1 where n = k / 4: D[i][n] sums
// column 16 n + i over 4 edges; 4 k-steps.
template <int KSUM, int OUT, int D1, int D3, unsigned long long MASK>
__device__ inline void feat_task(const Tile& t, const UvuIns& I, int u0, float* mbuf, int lane) {
  static_assert(OUT == PB_OUT_GROUPED && (KSUM == PB_KS_HALVE || KSUM == PB_KS_MM),
                "the feature-major variants are the conv with the halving or the 0/1 sum");
  constexpr int NP = pb_popc(MASK), C = 8 * D3;
  static_assert(C * FS <= PB_WBUF, "the task's staged messages fit the warp's buffer");
  const int e = lane & 15, hh = lane >> 4;
  const int r0 = I.rtab[pb_first_pair<D3>(MASK)];
  float tv[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) tv[j] = t.tmp[(r0 + j) * t.SR + e];
#pragma unroll 2
  for (int s = 0; s < 4; ++s) {
    const int ul = 4 * hh + s, uu = u0 + ul;
    const bool ok = uu < I.mul;
    const float w = ok ? t.ws[(I.w_start + uu) * t.SW + e] : 0.0f;
    float xw[D1][1], msg[D3][1];
#pragma unroll
    for (int m = 0; m < D1; ++m) xw[m][0] = (ok ? t.xs[(I.x_start + m * I.mul + uu) * t.SX + e] : 0.0f) * w;
    path_terms<D1, D3, MASK, 1>(xw, [&](int j) { return tv[j]; }, msg);
#pragma unroll
    for (int p = 0; p < D3; ++p) {
      if constexpr (KSUM == PB_KS_HALVE) {
        float v = msg[p][0];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (e == 0 && ok) t.outacc[I.y_start + p * I.u_tot + uu] += v;
      } else {
        mbuf[(8 * p + ul) * FS + e] = msg[p][0];
      }
    }
  }
  if constexpr (KSUM == PB_KS_MM) {
    constexpr int NTL = (C + 31) / 32;
    const int g = lane >> 2, q = lane & 3;
    const unsigned one = __float_as_uint(1.0f);
    const unsigned b[2] = {g == 0 ? one : 0u, g == 1 ? one : 0u};
    float acc[NTL][4] = {};
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int tt = 0; tt < NTL; ++tt) {
        // fragment a[r] reads column 32 tt + 8 r' + g (r' = 0, 1, 2, 3 for
        // a0, a1, a2, a3), the task's where 32 tt + 8 (r' + 1) <= C
        const float* ap = mbuf + (32 * tt + g) * FS + 4 * ks + q;
        float a[4] = {32 * tt + 8 <= C ? ap[0] : 0.0f, 32 * tt + 16 <= C ? ap[8 * FS] : 0.0f,
                      32 * tt + 24 <= C ? ap[16 * FS] : 0.0f, 32 * tt + 32 <= C ? ap[24 * FS] : 0.0f};
        unsigned ah[4], al[4];
        split4(a, ah, al);
        mma_tf32(acc[tt], al, b);
        mma_tf32(acc[tt], ah, b);
      }
    if (q == 0) {
#pragma unroll
      for (int tt = 0; tt < NTL; ++tt)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // c-slot s: row g + 8 (s / 2), N column s % 2
          const int c = 32 * tt + 16 * (s & 1) + 8 * (s >> 1) + g;
          const int uu = u0 + c % 8;
          if (c < C && uu < I.mul) t.outacc[I.y_start + c / 8 * I.u_tot + uu] += acc[tt][s];
        }
    }
    __syncwarp();  // read before the next task stages over the buffer
  }
}

// A task of path (D1, D3, MASK): the mapping of the tiles, and on
// edge-major tiles the channels a lane (VW, the host's) where the K sum
// allows more than one.
template <int KSUM, int OUT, bool FEAT, int D1, int D3, unsigned long long MASK>
__device__ __forceinline__ void edge_path(const Tile& t, const UvuIns& I, int u0, int vw, int t0,
                                          float* mbuf, int lane) {
  if constexpr (FEAT) {
    feat_task<KSUM, OUT, D1, D3, MASK>(t, I, u0, mbuf, lane);
  } else if constexpr (KSUM == PB_KS_MM || KSUM == PB_KS_HALVE) {
    if (vw == 2)
      edge_task<KSUM, OUT, D1, D3, MASK, 2>(t, I, u0, t0, mbuf, lane);
    else
      edge_task<KSUM, OUT, D1, D3, MASK, 1>(t, I, u0, t0, mbuf, lane);
  } else {
    if (vw == 4)
      edge_task<KSUM, OUT, D1, D3, MASK, 4>(t, I, u0, t0, mbuf, lane);
    else if (vw == 2)
      edge_task<KSUM, OUT, D1, D3, MASK, 2>(t, I, u0, t0, mbuf, lane);
    else
      edge_task<KSUM, OUT, D1, D3, MASK, 1>(t, I, u0, t0, mbuf, lane);
  }
}

// The uvu product as per-edge messages msg[e, u, p] = sum_m (x[e, m, u]
// w[e, u]) tmp[e, r(m, p)] on the CUDA cores, then the K sum KSUM and the
// stores OUT (see the top of this file): column block b's tasks of the
// per-edge table etab (ints: its tasks' offset, its tasks, then per block
// NWARP + 1 run starts; a task (instruction, first channel, path,
// channels a lane)), warp w taking runs[w] .. runs[w + 1]. The W3 stage is
// free here: the staged messages of KS_HALVE, KS_MM and nofold, PB_WBUF
// floats a warp, and tp's per-edge lanes. Every edge's messages reach
// shared memory, the running sum or the lanes (ptxas drops arithmetic whose
// result nothing reads, so nofold stages them).
template <int KSUM, int OUT, bool FEAT>
__device__ inline void uvu_edges(const Tile& t, int b, const int* __restrict__ etab, int t0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* runs = etab + PB_ET_RUNS + b * (NWARP + 1);
  const int4* tasks = reinterpret_cast<const int4*>(etab + __ldg(etab));
  float* mbuf = t.stage + warp * PB_WBUF;
  const int end = __ldg(runs + warp + 1);
  for (int k = __ldg(runs + warp); k < end; ++k) {
    const int4 tk = __ldg(tasks + k);
    const UvuIns I = uvu_ins(t.tabs, tk.x);
    switch (tk.z) {
#define PB_EDGE_PATH(ID, D1, D3, MASK)                                                \
  case ID:                                                                            \
    edge_path<KSUM, OUT, FEAT, D1, D3, MASK>(t, I, tk.y, tk.w, t0, mbuf, lane); \
    break;
      FC_PATHS(PB_EDGE_PATH)
#undef PB_EDGE_PATH
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
// each output column takes, -1 for zero; etab (the per-edge variants
// only): the per-edge product's task table (uvu_edges).
template <int V>
__global__ void __launch_bounds__(NT, 1) probe_breakdown_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ emb, const float* __restrict__ sh, MlpWeights W,
    const float* __restrict__ W3, const int* __restrict__ itab, const float* __restrict__ ftab,
    const int* __restrict__ omap, const int* __restrict__ etab, float* __restrict__ out) {
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
        uvu_edges<P.ksum, P.out, P.feat>(t, b, etab, t0);
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
                     const int* omap, const int* etab, float* out, void* stream) {
  static int smem_limit[MAX_DEVICES];
  constexpr Phases P = pb_phases(V);
  const size_t smem = carve<P.feat>(d, false, nullptr, nullptr);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit((const void*)probe_breakdown_kernel<V>, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    probe_breakdown_kernel<V><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, emb, sh, W, W.w[d.nh], itab, ftab, omap, etab, out);
  return (int)cudaGetLastError();
}

#define PB_CASE(V) \
  case V:          \
    return pb_launch<V>(d, x, src, emb, sh, W, itab, ftab, omap, etab, out, stream);

// The C entry of a probe library: variant v of those it instantiates.
#define PB_ENTRY(NAME, CASES)                                                                     \
  extern "C" int NAME(int v, ConvDims d, const float* x, const int* src, const float* emb,        \
                      const float* sh, MlpWeights W, const int* itab, const float* ftab,          \
                      const int* omap, const int* etab, float* out, void* stream) {               \
    switch (v) { CASES }                                                                          \
    return (int)cudaErrorInvalidValue;                                                            \
  }
