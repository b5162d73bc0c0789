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
// radial MLP's last layer, h2 (16 x 64) W3 (64 x 960) per tile of 16 edges
// for SevenNet-0's middle layers, is most of the operations. It runs on the
// tensor cores as 3xTF32 mma.sync (fp32 accuracy), with W3 (245,760 B, more
// than a CTA's 227 KB of shared memory) staged through shared memory in
// 64-column blocks by cp.async, several blocks in flight; the x[src] rows
// arrive by cp.async too. MLP layers 1-2, tmp and the uvu product (per
// instruction and 16 channels, summed over the tile's (edge, m)) are 3xTF32
// products as well; the edge geometry, Bessel basis and spherical
// harmonics are spread over the CTA's threads. Every intermediate stays in
// shared memory. Measured, the W3 product takes half the time, bound by the
// mma.sync 3xTF32 path and W3's streaming (PERF.md). Edges past the cutoff (padding) are skipped in vec mode: their
// message is exactly zero. In emb/sh mode every slot is walked (a padded
// slot's zero emb row gives a zero message).
#include "fused_conv_common.cuh"

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode.
template <bool EMBSH>
__global__ void __launch_bounds__(NT, 1) fused_conv_fwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ ea, const float* __restrict__ eb,
    const float* __restrict__ W1, const float* __restrict__ W2,
    const float* __restrict__ W3, const int* __restrict__ itab,
    const float* __restrict__ ftab, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, false, (char*)smem_raw, &t);
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  Prof prof;
  prof.start();
  load_tabs(d, t, itab);
  list_slots<EMBSH>(d, t, i, ea);
  const int nv = *t.count;
  for (int c = tid; c < d.dim_mid; c += NT) t.outacc[c] = 0.0f;
  prof.mark(0);

  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile<EMBSH>(d, t, i, t0, ne, x, src, ea, eb, W1, W2, W3, itab, ftab, prof);
    // out[c] += sum_e sum_terms x[e, xc] * w[e, wc] * tmp[e, r], on the tensor cores
    uvu_forward(t);
    __syncthreads();
    prof.mark(4);
  }
  for (int c = tid; c < d.dim_mid; c += NT) out[(size_t)i * d.dim_mid + c] = t.outacc[c];
  prof.mark(0);
  prof.store();
}

template <bool EMBSH>
static int launch_fwd(const ConvDims& d, int* limits, const float* x, const int* src,
                      const float* ea, const float* eb, const float* W1, const float* W2,
                      const float* W3, const int* itab, const float* ftab, float* out,
                      void* stream) {
  const size_t smem = carve(d, false, nullptr, nullptr);
  cudaError_t err = raise_smem_limit((const void*)fused_conv_fwd_kernel<EMBSH>, smem, limits);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_fwd_kernel<EMBSH><<<d.N, NT, smem, (cudaStream_t)stream>>>(
        d, x, src, ea, eb, W1, W2, W3, itab, ftab, out);
  return (int)cudaGetLastError();
}

static int smem_limit[MAX_DEVICES];
static int smem_limit_embsh[MAX_DEVICES];

// B1. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_conv_fwd_launch(ConvDims d, const float* x, const int* src, const float* vec,
                                     const float* coef, const float* W1, const float* W2,
                                     const float* W3, const int* itab, const float* ftab,
                                     float* out, void* stream) {
  return launch_fwd<false>(d, smem_limit, x, src, vec, coef, W1, W2, W3, itab, ftab, out, stream);
}

// B4 (and B6): emb (N*K, n_basis) and sh (N*K, dim_f) receiver-major.
extern "C" int fused_conv_fwd_embsh_launch(ConvDims d, const float* x, const int* src,
                                           const float* emb, const float* sh, const float* W1,
                                           const float* W2, const float* W3, const int* itab,
                                           const float* ftab, float* out, void* stream) {
  return launch_fwd<true>(d, smem_limit_embsh, x, src, emb, sh, W1, W2, W3, itab, ftab, out,
                          stream);
}
