// Forward fused conv, vec mode: radial embedding + radial MLP + uvu tensor
// product + sum over each receiver's neighbour slots, in one kernel.
//
// Replaces: the Pallas TPU kernel sevennet_tpu/ops/fused_conv.py:
// make_fused_conv_fwd with `embed` set (pallas_call at :678). What it
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
// are skipped: their message is exactly zero.
#include "fused_conv_common.cuh"

__global__ void __launch_bounds__(NT) fused_conv_fwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ vec, const float* __restrict__ coef,
    const float* __restrict__ W1, const float* __restrict__ W2,
    const float* __restrict__ W3, const int* __restrict__ itab,
    const float* __restrict__ ftab, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, false, (char*)smem_raw, &t);
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  list_slots(d, t, i, vec);
  const int nv = *t.count;
  for (int c = tid; c < d.dim_mid; c += NT) t.outacc[c] = 0.0f;

  const int* f_ptr = itab + d.f_ptr;
  const int4* f_terms = (const int4*)(itab + d.f_terms);
  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile(d, t, i, t0, ne, x, src, vec, coef, W1, W2, W3, itab, ftab);
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

static int smem_limit[MAX_DEVICES];

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_conv_fwd_launch(ConvDims d, const float* x, const int* src, const float* vec,
                                     const float* coef, const float* W1, const float* W2,
                                     const float* W3, const int* itab, const float* ftab,
                                     float* out, void* stream) {
  const size_t smem = carve(d, false, nullptr, nullptr);
  cudaError_t err = raise_smem_limit((const void*)fused_conv_fwd_kernel, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_fwd_kernel<<<d.N, NT, smem, (cudaStream_t)stream>>>(d, x, src, vec, coef, W1, W2,
                                                                   W3, itab, ftab, out);
  return (int)cudaGetLastError();
}
