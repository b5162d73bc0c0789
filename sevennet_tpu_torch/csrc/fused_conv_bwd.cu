// Backward fused conv, vec mode, without parameter gradients: from the
// receiver cotangent ybar (N, dim_mid) it emits the per-edge x-cotangents
// dxg (N*K, dim_x) and the edge-vector cotangents dvec (3, N*K). The caller
// turns dxg into dx with the mirror gather (sevennet_tpu_torch/ops/
// fused_conv.py, as sevennet_tpu/ops/fused_conv.py:1584-1590 does in XLA).
//
// Replaces: the Pallas TPU kernel sevennet_tpu/ops/fused_conv.py:
// make_fused_conv_bwd2 with `embed` set, param_grads=False, out_slots=1
// (pallas_call at :1222). Like that kernel it recomputes the radial MLP
// (keeping pre-activations) instead of storing per-edge residuals, and it
// uses the factored products of its docstring (:906-920): the weight
// cotangent reuses the x/tmp products, dtmp reuses x*w. The embedding and
// spherical-harmonic cotangents are chained to dvec inside the kernel
// (_emb_sh_bwd_rows, :272-318), including the projection
// (du - u (u.du)) / r + u dr.
//
// What bounds it on an H100: fp32 operations, about twice the forward's:
// the last MLP layer runs forward (to rebuild w) and backward
// (dh2 = dw @ W3^T). Per tile of TE edges, W3 (245,760 B for SevenNet-0,
// too big for shared memory) is read twice through L2: once by column for
// w, once by row, one warp per hidden unit with lanes along the columns,
// for dh2. Every per-edge cotangent is owned by one thread (CSR tables by
// x column, weight column and Wigner row), so there are no atomics.
// Slots past the cutoff get exact zeros without any arithmetic.
#include "fused_conv_common.cuh"

__global__ void __launch_bounds__(NT) fused_conv_bwd_kernel(
    ConvDims d, const float* __restrict__ x, const int* __restrict__ src,
    const float* __restrict__ vec, const float* __restrict__ coef,
    const float* __restrict__ W1, const float* __restrict__ W2,
    const float* __restrict__ W3, const float* __restrict__ ybar,
    const int* __restrict__ itab, const float* __restrict__ ftab,
    float* __restrict__ dxg, float* __restrict__ dvec) {
  extern __shared__ float4 smem_raw[];
  Tile t;
  carve(d, true, (char*)smem_raw, &t);
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NK = d.N * d.K;
  const int NB = d.n_basis, DF = d.dim_f;
  list_slots(d, t, i, vec);
  const int nv = *t.count;

  // exact zeros for the slots outside the cutoff
  for (int idx = tid; idx < d.K * d.dim_x; idx += NT) {
    const int k = idx / d.dim_x;
    if (!t.valid[k]) dxg[(size_t)(i * d.K + k) * d.dim_x + (idx - k * d.dim_x)] = 0.0f;
  }
  for (int k = tid; k < d.K; k += NT) {
    if (!t.valid[k]) {
      const int flat = i * d.K + k;
      dvec[flat] = 0.0f;
      dvec[NK + flat] = 0.0f;
      dvec[2 * NK + flat] = 0.0f;
    }
  }
  for (int c = tid; c < d.dim_mid; c += NT) t.yb[c] = ybar[(size_t)i * d.dim_mid + c];

  const int* dx_ptr = itab + d.dx_ptr;
  const int4* dx_terms = (const int4*)(itab + d.dx_terms);
  const int* dw_ptr = itab + d.dw_ptr;
  const int4* dw_terms = (const int4*)(itab + d.dw_terms);
  const int* dt_ptr = itab + d.dt_ptr;
  const int4* dt_terms = (const int4*)(itab + d.dt_terms);
  const float* w3j = ftab + d.w3j;
  const float inv_nb = (float)(1.0 / sqrt((double)NB));
  const float inv_h1 = (float)(1.0 / sqrt((double)d.h1));
  const float inv_h2 = (float)(1.0 / sqrt((double)d.h2));
  const float cst = d.act_cst;

  for (int t0 = 0; t0 < nv; t0 += TE) {
    const int ne = min(TE, nv - t0);
    load_tile(d, t, i, t0, ne, x, src, vec, coef, W1, W2, W3, itab, ftab);

    // dxg[e, xc] = sum_terms ybar[c] * w[e, wc] * tmp[e, r]
    for (int xc = tid; xc < d.dim_x; xc += NT) {
      float acc[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = 0.0f;
      const int q1 = dx_ptr[xc + 1];
      for (int q = dx_ptr[xc]; q < q1; ++q) {
        const int4 tm = dx_terms[q];  // (c, wc, r, -)
        const float y = t.yb[tm.x];
#pragma unroll
        for (int e = 0; e < TE; ++e) acc[e] += y * t.ws[e * t.SW + tm.y] * t.tmp[e * t.SR + tm.z];
      }
#pragma unroll
      for (int e = 0; e < TE; ++e)
        if (e < ne) dxg[(size_t)t.flats[e] * d.dim_x + xc] = acc[e];
    }
    // dtmp[e, r] = sum_terms x[e, xc] * w[e, wc] * ybar[c]
    for (int idx = tid; idx < d.R * TE; idx += NT) {
      const int r = idx / TE, e = idx - r * TE;
      float s = 0.0f;
      const int q1 = dt_ptr[r + 1];
      for (int q = dt_ptr[r]; q < q1; ++q) {
        const int4 tm = dt_terms[q];  // (c, xc, wc, -)
        s += t.xs[e * t.SX + tm.y] * t.ws[e * t.SW + tm.z] * t.yb[tm.x];
      }
      t.dtmp[e * t.SR + r] = s;
    }
    __syncthreads();
    // dw[e, wc] = sum_terms x[e, xc] * ybar[c] * tmp[e, r], written over w
    for (int j = tid; j < d.numel; j += NT) {
      float acc[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = 0.0f;
      const int q1 = dw_ptr[j + 1];
      for (int q = dw_ptr[j]; q < q1; ++q) {
        const int4 tm = dw_terms[q];  // (c, xc, r, -)
        const float y = t.yb[tm.x];
#pragma unroll
        for (int e = 0; e < TE; ++e) acc[e] += t.xs[e * t.SX + tm.y] * (y * t.tmp[e * t.SR + tm.z]);
      }
#pragma unroll
      for (int e = 0; e < TE; ++e) t.ws[e * t.SW + j] = acc[e];
    }
    __syncthreads();
    // dz2 = (dw @ W3^T) / sqrt(h2) * silu'(z2) * cst: one warp per hidden
    // unit, lanes along W3's row (coalesced), then a warp reduction per edge
    for (int o = warp; o < d.h2; o += NT / 32) {
      float p[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) p[e] = 0.0f;
      for (int j = lane; j < d.numel; j += 32) {
        const float wv = __ldg(W3 + (size_t)o * d.numel + j);
#pragma unroll
        for (int e = 0; e < TE; ++e) p[e] += t.ws[e * t.SW + j] * wv;
      }
#pragma unroll
      for (int e = 0; e < TE; ++e) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) p[e] += __shfl_xor_sync(0xffffffffu, p[e], sh);
      }
      float mine = 0.0f;
#pragma unroll
      for (int e = 0; e < TE; ++e)
        if (lane == e) mine = p[e];
      if (lane < TE) {
        const float z = t.z2T[o * TE + lane];
        const float sg = sigmoidf_(z);
        t.dz2T[o * TE + lane] = mine * inv_h2 * (sg * (1.0f + z * (1.0f - sg)) * cst);
      }
    }
    __syncthreads();
    // dz1 = (W2 @ dz2) / sqrt(h1) * silu'(z1) * cst
    for (int idx = tid; idx < TE * d.h1; idx += NT) {
      const int o = idx / TE, e = idx - o * TE;
      float s = 0.0f;
      for (int k = 0; k < d.h2; ++k) s += W2[o * d.h2 + k] * t.dz2T[k * TE + e];
      const float z = t.z1T[idx];
      const float sg = sigmoidf_(z);
      t.dz1T[idx] = s * inv_h1 * (sg * (1.0f + z * (1.0f - sg)) * cst);
    }
    // dsh = w3j_pack^T @ dtmp
    for (int idx = tid; idx < TE * DF; idx += NT) {
      const int e = idx / DF, f = idx - e * DF;
      float s = 0.0f;
      for (int r = 0; r < d.R; ++r) s += w3j[r * DF + f] * t.dtmp[e * t.SR + r];
      t.dsh[e * DF + f] = s;
    }
    __syncthreads();
    // demb = (W1 @ dz1) / sqrt(n_basis)
    for (int idx = tid; idx < TE * NB; idx += NT) {
      const int e = idx / NB, n = idx - e * NB;
      float s = 0.0f;
      for (int k = 0; k < d.h1; ++k) s += W1[n * d.h1 + k] * t.dz1T[k * TE + e];
      t.demb[e * NB + n] = s * inv_nb;
    }
    __syncthreads();
    // chain demb and dsh to the edge vector: one thread per edge
    if (tid < ne) {
      const int e = tid;
      const float* g = t.geo + e * 8;
      const float r = g[0], rinv = g[1], u0 = g[2], u1 = g[3], u2 = g[4], env = g[5], denv = g[6];
      const float pref = (float)(2.0 / (double)d.cutoff);
      float dr = 0.0f;
      for (int n = 0; n < NB; ++n) {
        const float c = coef[n];
        const float sr = sinf(c * r), cr = cosf(c * r);
        const float dembdr = pref * (c * cr * (rinv * env) + sr * (denv * rinv - env * rinv * rinv));
        dr += t.demb[e * NB + n] * dembdr;
      }
      float px[LMAXP], py[LMAXP], pz[LMAXP];
      px[0] = py[0] = pz[0] = 1.0f;
      for (int p = 1; p < LMAXP; ++p) {
        px[p] = px[p - 1] * u0;
        py[p] = py[p - 1] * u1;
        pz[p] = pz[p - 1] * u2;
      }
      float du[3] = {0.0f, 0.0f, 0.0f};
      const int4* st = (const int4*)(itab + d.shd_terms);
      const int* sf = itab + d.shd_terms + 4 * d.n_shd;  // component c of each term
      const float* sc = ftab + d.shd_coef;
      for (int q = 0; q < d.n_shd; ++q) {
        const int4 tm = st[q];  // (f, a, b, c) of dY_f/du_comp
        du[sf[q]] += sc[q] * (t.dsh[e * DF + tm.x] * (px[tm.y] * py[tm.z] * pz[tm.w]));
      }
      const float udu = u0 * du[0] + u1 * du[1] + u2 * du[2];
      const int flat = t.flats[e];
      dvec[flat] = (du[0] - u0 * udu) * rinv + u0 * dr;
      dvec[NK + flat] = (du[1] - u1 * udu) * rinv + u1 * dr;
      dvec[2 * NK + flat] = (du[2] - u2 * udu) * rinv + u2 * dr;
    }
    __syncthreads();
  }
}

static int smem_limit[MAX_DEVICES];

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_conv_bwd_launch(ConvDims d, const float* x, const int* src, const float* vec,
                                     const float* coef, const float* W1, const float* W2,
                                     const float* W3, const float* ybar, const int* itab,
                                     const float* ftab, float* dxg, float* dvec, void* stream) {
  const size_t smem = carve(d, true, nullptr, nullptr);
  cudaError_t err = raise_smem_limit((const void*)fused_conv_bwd_kernel, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (d.N > 0)
    fused_conv_bwd_kernel<<<d.N, NT, smem, (cudaStream_t)stream>>>(d, x, src, vec, coef, W1, W2,
                                                                   W3, ybar, itab, ftab, dxg, dvec);
  return (int)cudaGetLastError();
}
