// Forward fused conv: radial embedding + radial MLP + uvu tensor product +
// sum over each receiver's neighbour slots, in one kernel.
//
// Replaces: the Pallas TPU kernel sevennet_tpu/ops/fused_conv.py:
// make_fused_conv_fwd (pallas_call at :678), with `embed` set
// (fused_conv_fwd_launch, B1: vec mode, the embedding computed from the
// edge vectors) and with embed=None (fused_conv_fwd_embsh_launch, B4: emb
// and sh read precomputed). The emb/sh entry also serves B6,
// sevennet_tpu/ops/pallas_conv.py:make_dense_conv_kernel (pallas_call at
// :194), the same function on the un-permuted (N, K) layout. What it
// computes is the same; how is not: the TPU kernel's k-major lane order,
// 128-lane fold chain and VMEM blocking stay behind. Here one CTA owns one
// receiver atom and walks its neighbour slots in the natural row-major
// (N, K) layout, gathering x[src] itself (no gathered (N*K, dim_x) array
// in device memory).
//
// What bounds it on an H100, and the design (fused_conv_common.cuh): the
// radial MLP's last layer, h (16 x 64) W3 (64 x 960) per tile of 16 edges
// for SevenNet-0's middle layers, is most of the operations. It runs on the
// tensor cores as 3xTF32 mma.sync (fp32 accuracy), with W3 (245,760 B, more
// than a CTA's 227 KB of shared memory) staged through shared memory in
// 64-column blocks by cp.async, several blocks in flight; the x[src] rows
// arrive by cp.async too. MLP layers 1-2, tmp and the uvu product (per
// instruction and 16 channels, summed over the tile's (edge, m)) are 3xTF32
// products as well; the edge geometry, Bessel basis and spherical
// harmonics are spread over the CTA's threads. Every intermediate stays in
// shared memory, w and tmp one column block at a time (one block for
// SevenNet-0, three for SevenNet-l3i5's lmax-3 layers), the output
// accumulator whole (a cluster's CTA its rank's outputs: SevenNet-MF-ompa's
// two widest layers, fused_conv_common.cuh). Measured, the W3
// product takes half the time, bound by the mma.sync 3xTF32 path and W3's
// streaming (PERF.md). Edges past the cutoff (padding) are skipped in vec mode: their
// message is exactly zero. In emb/sh mode every slot is walked (a padded
// slot's zero emb row gives a zero message).
#include "fused_conv_common.cuh"

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode. CL: a
// cluster's CTA (rank cluster_rank() of receiver row blockIdx.x / C), which
// forms the outputs of its rank's instructions, disjoint from the other
// ranks', in the rank's order, and writes each instruction's d3 runs of mul
// columns to the row's output; mblk: the output columns the CTA holds, xw
// (CL): its x columns (fused_conv_common.cuh:carve).
template <bool EMBSH, bool CL>
__global__ void __launch_bounds__(NT, 1) fused_conv_fwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ ea, const float* __restrict__ eb, MlpWeights W,
    const float* __restrict__ W3, const int* __restrict__ itab, const float* __restrict__ ftab, float* __restrict__ out,
    int mblk, int xw) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, false, (char*)smem_raw, &t, mblk, CL ? xw : -1);
  const int i = CL ? (int)blockIdx.x / cluster_ctas() : (int)blockIdx.x;
  const int tid = threadIdx.x;
  Prof prof;
  prof.start();
  if constexpr (CL)
    load_rank_tabs(d, t, itab, cluster_rank());
  else
    load_tabs(d, t, itab);
  list_slots<EMBSH>(d, t, i, ea);
  const int nv = *t.count;
  const int mw = t.tabs[H_MW];
  for (int c = tid; c < mw; c += NT) t.outacc[c] = 0.0f;
  prof.mark(0);
  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile<EMBSH, 3, false, MLP_FULL, true, CL>(d, t, i, t0, ne, x, src, ea, eb, W, W3, ftab,
                                                   uvu_blk(t.tabs, 0), prof);
    for (int b = 0; b < n_blocks(t.tabs); ++b) {
      const Blk B = uvu_blk(t.tabs, b);
      if (b > 0) {  // load_tile formed block 0's w and tmp
        block_tmp(d, t, ftab, B);
        stage_w3_first<CL>(d, W3, t, B);
        w3_forward<3, false, CL>(d, t, W3, B);
        prof.mark(3);
      }
      // out[c] += sum_e sum_terms x[e, xc] * w[e, wc] * tmp[e, r], on the tensor cores
      uvu_forward(t, B);
      __syncthreads();
      prof.mark(4);
    }
  }
  if constexpr (CL) {
    // each instruction's outputs: d3 runs of mul columns of the row, a warp an instruction
    const int lane = tid & 31, warp = tid >> 5;
    for (int k = warp; k < t.tabs[H_NK]; k += NWARP) {
      const UvuIns I = uvu_ins(t.tabs, k);
      const int* rec = t.tabs + t.tabs[0] + k * UVU_INS;
      float* o = out + (size_t)i * d.dim_mid + rec[UVU_GY];
      for (int p = 0; p < I.d3; ++p)
        for (int u = lane; u < I.mul; u += 32) o[p * rec[UVU_GUT] + u] = t.outacc[I.y_start + p * I.mul + u];
    }
  } else {
    for (int c = tid; c < mw; c += NT) out[(size_t)i * d.dim_mid + c] = t.outacc[c];
  }
  prof.mark(0);
  prof.store();
}

template <bool EMBSH>
static int launch_fwd(const ConvDims& d, int mblk, int xw, int cl, int* limits, const float* x,
                      const int* src, const float* ea, const float* eb, const MlpWeights& W,
                      const int* itab, const float* ftab, float* out, void* stream) {
  const size_t smem = carve(d, false, nullptr, nullptr, mblk, cl > 1 ? xw : -1);
  if (cl > 1)
    return launch_cluster(fused_conv_fwd_kernel<EMBSH, true>, d.N * cl, cl, smem, stream,
                          limits + MAX_DEVICES, d, x, src, ea, eb, W,
                          W.w[d.nh], itab, ftab, out, mblk, xw);
  cudaError_t err = raise_smem_limit((const void*)fused_conv_fwd_kernel<EMBSH, false>, smem, limits);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_fwd_kernel<EMBSH, false><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, ea, eb, W, W.w[d.nh], itab, ftab, out, mblk, xw);
  return (int)cudaGetLastError();
}

// per entry: the one-CTA kernel's smem limit by device, then the cluster
// kernel's
static int smem_limit[2 * MAX_DEVICES];
static int smem_limit_embsh[2 * MAX_DEVICES];

// B1. Returns cudaGetLastError() after the launch (0 = launched), or
// CLUSTER_UNSCHEDULABLE. mblk, xw, cl: the output columns a CTA holds, a
// cluster's x columns (-1: one CTA) and CTAs per receiver row
// (ops/fused_conv.py: BlockPlan.launch_args).
extern "C" int fused_conv_fwd_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                     const int* src, const float* vec, const float* coef,
                                     MlpWeights W, const int* itab, const float* ftab, float* out,
                                     void* stream) {
  return launch_fwd<false>(d, mblk, xw, cl, smem_limit, x, src, vec, coef, W, itab, ftab, out,
                           stream);
}

// B4 (and B6): emb (N*K, n_basis) and sh (N*K, dim_f) receiver-major.
extern "C" int fused_conv_fwd_embsh_launch(ConvDims d, int mblk, int xw, int cl, const float* x,
                                           const int* src, const float* emb, const float* sh,
                                           MlpWeights W, const int* itab, const float* ftab,
                                           float* out, void* stream) {
  return launch_fwd<true>(d, mblk, xw, cl, smem_limit_embsh, x, src, emb, sh, W, itab, ftab, out,
                          stream);
}
