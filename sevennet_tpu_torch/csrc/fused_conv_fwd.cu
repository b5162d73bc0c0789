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
// What bounds it on an H100: fp32 operations. Per edge the last radial-MLP
// layer alone is h2 * numel FMAs (64 * 960 for SevenNet-0's middle layers),
// against a few KB of input, so the kernel sits far above the fp32 ridge
// point. The design keeps every intermediate (embedding, hidden layers,
// per-edge weights, Wigner contraction) in shared memory, reads the largest
// weight (64 x 960 fp32 = 245,760 B, more than a CTA's 227 KB of shared
// memory) through L2 once per tile of TE edges, coalesced along its
// columns, and keeps TE accumulators per thread in registers. No tensor
// cores: TF32 would break the fp32 budget. Edges past the cutoff (padding)
// are skipped in vec mode: their message is exactly zero. In emb/sh mode
// every slot is walked (a padded slot's zero emb row gives a zero message).
#include "fused_conv_common.cuh"

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode.
template <bool EMBSH>
__global__ void __launch_bounds__(NT) fused_conv_fwd_kernel(
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
  list_slots<EMBSH>(d, t, i, ea);
  const int nv = *t.count;
  for (int c = tid; c < d.dim_mid; c += NT) t.outacc[c] = 0.0f;

  const int* f_ptr = itab + d.f_ptr;
  const int4* f_terms = (const int4*)(itab + d.f_terms);
  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile<EMBSH>(d, t, i, t0, ne, x, src, ea, eb, W1, W2, W3, itab, ftab);
    // out[c] += sum_e sum_terms x[e, xc] * w[e, wc] * tmp[e, r]
    for (int c = tid; c < d.dim_mid; c += NT) {
      float acc = 0.0f;
      const int q1 = f_ptr[c + 1];
      for (int q = f_ptr[c]; q < q1; ++q) {
        const int4 tm = f_terms[q];  // (xc, wc, r, -)
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < TE; ++e)
          s += t.xs[e * t.SX + tm.x] * t.ws[e * t.SW + tm.y] * t.tmp[e * t.SR + tm.z];
        acc += s;
      }
      t.outacc[c] += acc;
    }
    __syncthreads();
  }
  for (int c = tid; c < d.dim_mid; c += NT) out[(size_t)i * d.dim_mid + c] = t.outacc[c];
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
