// Shared pieces of the fused-conv kernels (forward: fused_conv_fwd.cu,
// backward: fused_conv_bwd.cu).
//
// Both kernels run one CTA per receiver atom i. The CTA first lists the
// slots of row i whose edge lies inside the cutoff (padded slots carry a
// sentinel vector past the cutoff, so their envelope, their message and
// every cotangent they produce are exactly zero), then walks those edges in
// tiles of TE. For each tile it computes in shared memory:
//
//   geometry  r, 1/r, u = v/r, envelope and its derivative
//   emb       Bessel basis 2/rc * sin(c_n r)/r * env           (TE, NB)
//   sh        real spherical harmonics of u up to lmax          (TE, DF)
//   tmp       w3j_pack @ sh                                     (TE, R)
//   h1, h2    the radial MLP's hidden layers (silu * cst)       (H, TE)
//   w         the last MLP layer, the per-edge uvu weights      (TE, numel)
//   xs        the gathered sender features x[src]               (TE, dim_x)
//
// The uvu tensor product itself is table driven. Every elementary product
// of the layer is one term (c, xc, wc, r): output column c of the grouped
// mid layout gets x[xc] * w[wc] * tmp[r]. The host sorts the terms four ways
// (CSR by c, by xc, by wc and by r) so that each thread owns an output
// column or a cotangent column and sums its own terms: no atomics, and the
// result does not depend on the launch.
//
// All arithmetic is fp32 FMA on the CUDA cores (no TF32: the repo's force
// budget needs full fp32, as the TPU kernels pin their dots to HIGHEST).
//
// Emb/sh mode (template flag EMBSH; the TPU kernels with embed=None) takes
// a precomputed embedding emb (N*K, NB) and spherical harmonics sh (N*K, DF)
// in place of the edge vectors and the Bessel coefficients: the tile reads
// their rows instead of computing them, and there is no radius to list the
// slots by, so the CTA walks all K slots of its row. A padded slot carries a
// zero emb row: its w and message are exactly zero (the MLP has no bias).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256     // threads per CTA
#define TE 16      // edges per tile
#define LMAXP 4    // powers table size: lmax <= 3

// Layer description, filled by sevennet_tpu_torch/ops/fused_conv.py
// (ctypes mirror: _ConvDims). All fields are 4 bytes: no padding.
struct ConvDims {
  int N, K, dim_x, dim_mid, numel, R, dim_f, n_basis, h1, h2;
  int lmax;
  int cutoff_kind;   // 0 = polynomial (p = cutoff_arg), 1 = XPLOR (r_on = cutoff_arg)
  float cutoff, cutoff_arg, act_cst;
  // offsets (in ints) into the int table
  int f_ptr, f_terms, dx_ptr, dx_terms, dw_ptr, dw_terms, dt_ptr, dt_terms;
  int sh_terms, n_sh, shd_terms, n_shd;
  // offsets (in floats) into the float table
  int w3j, sh_coef, shd_coef;
};

// Shared-memory carve-up of one CTA. Row strides of the (TE, *) arrays are
// odd, so threads that walk the edge index hit distinct banks.
struct Tile {
  int *slots, *count, *srcs, *flats;
  unsigned char* valid;
  float *geo, *embT, *sh, *tmp, *z1T, *h1T, *z2T, *h2T, *xs, *ws;
  float *outacc;                                  // forward only
  float *yb, *dtmp, *dz2T, *dz1T, *demb, *dsh;    // backward only
  int SX, SW, SR;
};

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

__host__ __device__ inline size_t take(size_t& off, size_t nbytes) {
  size_t o = off;
  off += (nbytes + 15) & ~size_t(15);
  return o;
}

// Assigns the pointers of t inside base (when base is non-null) and
// returns the bytes the layout needs. The host calls it with base = null.
__host__ __device__ inline size_t carve(const ConvDims& d, bool bwd, char* base, Tile* t) {
  size_t off = 0;
  const int SX = odd_stride(d.dim_x), SW = odd_stride(d.numel), SR = odd_stride(d.R);
  size_t o_slots = take(off, sizeof(int) * d.K);
  size_t o_valid = take(off, d.K);
  size_t o_count = take(off, sizeof(int) * 4);
  size_t o_srcs = take(off, sizeof(int) * TE);
  size_t o_flats = take(off, sizeof(int) * TE);
  size_t o_geo = take(off, sizeof(float) * TE * 8);
  size_t o_emb = take(off, sizeof(float) * TE * d.n_basis);
  size_t o_sh = take(off, sizeof(float) * TE * d.dim_f);
  size_t o_tmp = take(off, sizeof(float) * TE * SR);
  size_t o_z1 = take(off, sizeof(float) * TE * d.h1);
  size_t o_h1 = take(off, sizeof(float) * TE * d.h1);
  size_t o_z2 = take(off, sizeof(float) * TE * d.h2);
  size_t o_h2 = take(off, sizeof(float) * TE * d.h2);
  size_t o_xs = take(off, sizeof(float) * TE * SX);
  size_t o_ws = take(off, sizeof(float) * TE * SW);
  size_t o_out = 0, o_yb = 0, o_dtmp = 0, o_dz2 = 0, o_dz1 = 0, o_demb = 0, o_dsh = 0;
  if (!bwd) {
    o_out = take(off, sizeof(float) * d.dim_mid);
  } else {
    o_yb = take(off, sizeof(float) * d.dim_mid);
    o_dtmp = take(off, sizeof(float) * TE * SR);
    o_dz2 = take(off, sizeof(float) * TE * d.h2);
    o_dz1 = take(off, sizeof(float) * TE * d.h1);
    o_demb = take(off, sizeof(float) * TE * d.n_basis);
    o_dsh = take(off, sizeof(float) * TE * d.dim_f);
  }
  if (base) {
    t->slots = (int*)(base + o_slots);
    t->valid = (unsigned char*)(base + o_valid);
    t->count = (int*)(base + o_count);
    t->srcs = (int*)(base + o_srcs);
    t->flats = (int*)(base + o_flats);
    t->geo = (float*)(base + o_geo);
    t->embT = (float*)(base + o_emb);
    t->sh = (float*)(base + o_sh);
    t->tmp = (float*)(base + o_tmp);
    t->z1T = (float*)(base + o_z1);
    t->h1T = (float*)(base + o_h1);
    t->z2T = (float*)(base + o_z2);
    t->h2T = (float*)(base + o_h2);
    t->xs = (float*)(base + o_xs);
    t->ws = (float*)(base + o_ws);
    t->outacc = bwd ? nullptr : (float*)(base + o_out);
    t->yb = bwd ? (float*)(base + o_yb) : nullptr;
    t->dtmp = bwd ? (float*)(base + o_dtmp) : nullptr;
    t->dz2T = bwd ? (float*)(base + o_dz2) : nullptr;
    t->dz1T = bwd ? (float*)(base + o_dz1) : nullptr;
    t->demb = bwd ? (float*)(base + o_demb) : nullptr;
    t->dsh = bwd ? (float*)(base + o_dsh) : nullptr;
    t->SX = SX;
    t->SW = SW;
    t->SR = SR;
  }
  return off;
}

// Raises kernel fn's dynamic shared-memory limit on the current device to
// smem bytes when it is not that high yet. The attribute persists, so a
// launch pays the driver call only when a layer needs more than any before.
#define MAX_DEVICES 64
inline cudaError_t raise_smem_limit(const void* fn, size_t smem, int* limit_by_device) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (int)smem <= limit_by_device[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) limit_by_device[dev] = (int)smem;
  return err;
}

__device__ __forceinline__ float edge_radius(const float* vec, int NK, int flat) {
  const float v0 = vec[flat], v1 = vec[NK + flat], v2 = vec[2 * NK + flat];
  return fmaxf(sqrtf(v0 * v0 + v1 * v1 + v2 * v2), 1e-12f);
}

// True where the envelope or its derivative can be nonzero; outside, the
// edge's message and all its cotangents are exactly zero.
__device__ __forceinline__ bool inside_cutoff(const ConvDims& d, float r) {
  if (d.cutoff_kind == 0) return r * (float)(1.0 / (double)d.cutoff) < 1.0f;
  return r < d.cutoff;
}

// Envelope and its r-derivative, both clamped to zero beyond the cutoff
// (sevennet_tpu/ops/fused_conv.py:_env_rows).
__device__ __forceinline__ void envelope(const ConvDims& d, float r, float& env, float& denv) {
  if (d.cutoff_kind == 0) {
    const int ip = (int)d.cutoff_arg;
    const float p = (float)ip;
    const float inv_c = (float)(1.0 / (double)d.cutoff);
    const float x = r * inv_c;
    const float c0 = (p + 1.0f) * (p + 2.0f) / 2.0f;
    const float c1 = p * (p + 2.0f);
    const float c2 = p * (p + 1.0f) / 2.0f;
    // x^p by binary exponentiation, in the order XLA multiplies
    float xp = 1.0f, base = x;
    bool first = true;
    for (int e = ip; e > 0; e >>= 1) {
      if (e & 1) {
        xp = first ? base : xp * base;
        first = false;
      }
      if (e > 1) base = base * base;
    }
    const float val = 1.0f - c0 * xp + c1 * xp * x - c2 * xp * x * x;
    const float dval =
        (-c0 * p * xp / fmaxf(x, 1e-12f) + c1 * (p + 1.0f) * xp - c2 * (p + 2.0f) * xp * x) * inv_c;
    const bool in = x < 1.0f;
    env = in ? val : 0.0f;
    denv = in ? dval : 0.0f;
    return;
  }
  const double on = (double)d.cutoff_arg, cut = (double)d.cutoff;
  const float on_sq = (float)(on * on), cut_sq = (float)(cut * cut);
  const float inv = (float)(1.0 / ((cut * cut - on * on) * (cut * cut - on * on) * (cut * cut - on * on)));
  const float r_sq = r * r;
  const float a = cut_sq - r_sq;
  const float b = cut_sq + 2.0f * r_sq - 3.0f * on_sq;
  const float smooth = a * a * b * inv;
  const float dsmooth = (-4.0f * r * a * b + 4.0f * r * a * a) * inv;
  env = r < d.cutoff_arg ? 1.0f : (r < d.cutoff ? smooth : 0.0f);
  denv = (r >= d.cutoff_arg && r < d.cutoff) ? dsmooth : 0.0f;
}

__device__ __forceinline__ float sigmoidf_(float z) { return 1.0f / (1.0f + expf(-z)); }

// Warp 0 lists the slots of row i inside the cutoff, in slot order. In
// emb/sh mode every slot of the row is listed.
template <bool EMBSH>
__device__ inline void list_slots(const ConvDims& d, const Tile& t, int i, const float* vec) {
  if (EMBSH) {
    for (int k = threadIdx.x; k < d.K; k += NT) {
      t.slots[k] = k;
      t.valid[k] = 1;
    }
    if (threadIdx.x == 0) *t.count = d.K;
    __syncthreads();
    return;
  }
  const int NK = d.N * d.K;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int k0 = 0; k0 < d.K; k0 += 32) {
      const int k = k0 + lane;
      bool v = false;
      if (k < d.K) v = inside_cutoff(d, edge_radius(vec, NK, i * d.K + k));
      const unsigned m = __ballot_sync(0xffffffffu, v);
      if (k < d.K) t.valid[k] = v ? 1 : 0;
      if (v) t.slots[cnt + __popc(m & ((1u << lane) - 1u))] = k;
      cnt += __popc(m);
    }
    if (lane == 0) *t.count = cnt;
  }
  __syncthreads();
}

// Fills one tile of ne <= TE edges (slots t0 .. t0+ne of the list). Rows
// e >= ne are zero, so loops may run over all TE rows. (ea, eb) are
// (vec, coef) in vec mode and (emb, sh) in emb/sh mode.
template <bool EMBSH>
__device__ inline void load_tile(const ConvDims& d, const Tile& t, int i, int t0, int ne,
                                 const float* __restrict__ x, const int* __restrict__ src,
                                 const float* __restrict__ ea, const float* __restrict__ eb,
                                 const float* __restrict__ W1, const float* __restrict__ W2,
                                 const float* __restrict__ W3, const int* __restrict__ itab,
                                 const float* __restrict__ ftab) {
  const int tid = threadIdx.x;
  const int NK = d.N * d.K;
  const int NB = d.n_basis, DF = d.dim_f;
  if (EMBSH) {
    // (a) the slots' emb and sh rows, read along the rows
    if (tid < TE) {
      const int flat = tid < ne ? i * d.K + t.slots[t0 + tid] : -1;
      t.flats[tid] = flat;
      t.srcs[tid] = tid < ne ? src[flat] : 0;
    }
    for (int idx = tid; idx < TE * NB; idx += NT) {
      const int e = idx / NB, n = idx - e * NB;
      t.embT[n * TE + e] = e < ne ? ea[(size_t)(i * d.K + t.slots[t0 + e]) * NB + n] : 0.0f;
    }
    for (int idx = tid; idx < TE * DF; idx += NT) {
      const int e = idx / DF;
      t.sh[idx] = e < ne ? eb[(size_t)(i * d.K + t.slots[t0 + e]) * DF + (idx - e * DF)] : 0.0f;
    }
  } else if (tid < TE) {
    // (a) geometry, Bessel embedding and spherical harmonics: one thread per edge
    const int e = tid;
    float* g = t.geo + e * 8;
    float* sh = t.sh + e * DF;
    for (int f = 0; f < DF; ++f) sh[f] = 0.0f;
    if (e < ne) {
      const int flat = i * d.K + t.slots[t0 + e];
      t.flats[e] = flat;
      t.srcs[e] = src[flat];
      const float v0 = ea[flat], v1 = ea[NK + flat], v2 = ea[2 * NK + flat];
      const float r = fmaxf(sqrtf(v0 * v0 + v1 * v1 + v2 * v2), 1e-12f);
      const float rinv = 1.0f / r;
      const float u0 = v0 * rinv, u1 = v1 * rinv, u2 = v2 * rinv;
      float env, denv;
      envelope(d, r, env, denv);
      g[0] = r; g[1] = rinv; g[2] = u0; g[3] = u1; g[4] = u2; g[5] = env; g[6] = denv; g[7] = 0.0f;
      const float s = (float)(2.0 / (double)d.cutoff) * rinv * env;
      for (int n = 0; n < NB; ++n) t.embT[n * TE + e] = sinf(eb[n] * r) * s;
      float px[LMAXP], py[LMAXP], pz[LMAXP];
      px[0] = py[0] = pz[0] = 1.0f;
      for (int p = 1; p < LMAXP; ++p) {
        px[p] = px[p - 1] * u0;
        py[p] = py[p - 1] * u1;
        pz[p] = pz[p - 1] * u2;
      }
      const int4* st = (const int4*)(itab + d.sh_terms);
      const float* sc = ftab + d.sh_coef;
      for (int q = 0; q < d.n_sh; ++q) {
        const int4 tm = st[q];  // (f, a, b, c)
        sh[tm.x] += sc[q] * (px[tm.y] * py[tm.z] * pz[tm.w]);
      }
    } else {
      t.flats[e] = -1;
      t.srcs[e] = 0;
      for (int k = 0; k < 8; ++k) g[k] = 0.0f;
      for (int n = 0; n < NB; ++n) t.embT[n * TE + e] = 0.0f;
    }
  }
  __syncthreads();
  // (b) gather x[src] rows, (c) tmp = w3j_pack @ sh, (d) first MLP layer
  for (int idx = tid; idx < TE * d.dim_x; idx += NT) {
    const int e = idx / d.dim_x, c = idx - e * d.dim_x;
    t.xs[e * t.SX + c] = e < ne ? x[(size_t)t.srcs[e] * d.dim_x + c] : 0.0f;
  }
  const float* w3j = ftab + d.w3j;
  for (int idx = tid; idx < TE * d.R; idx += NT) {
    const int e = idx / d.R, r = idx - e * d.R;
    float s = 0.0f;
    for (int f = 0; f < DF; ++f) s += w3j[r * DF + f] * t.sh[e * DF + f];
    t.tmp[e * t.SR + r] = s;
  }
  const float inv_nb = (float)(1.0 / sqrt((double)NB));
  for (int idx = tid; idx < TE * d.h1; idx += NT) {
    const int o = idx / TE, e = idx - o * TE;
    float s = 0.0f;
    for (int n = 0; n < NB; ++n) s += W1[n * d.h1 + o] * t.embT[n * TE + e];
    const float z = s * inv_nb;
    t.z1T[idx] = z;
    t.h1T[idx] = z * sigmoidf_(z) * d.act_cst;
  }
  __syncthreads();
  // (e) second MLP layer
  const float inv_h1 = (float)(1.0 / sqrt((double)d.h1));
  for (int idx = tid; idx < TE * d.h2; idx += NT) {
    const int o = idx / TE, e = idx - o * TE;
    float s = 0.0f;
    for (int k = 0; k < d.h1; ++k) s += W2[k * d.h2 + o] * t.h1T[k * TE + e];
    const float z = s * inv_h1;
    t.z2T[idx] = z;
    t.h2T[idx] = z * sigmoidf_(z) * d.act_cst;
  }
  __syncthreads();
  // (f) last MLP layer: thread per weight column, TE edges in registers;
  // W3 is read once per tile, coalesced along its columns
  const float inv_h2 = (float)(1.0 / sqrt((double)d.h2));
  for (int j = tid; j < d.numel; j += NT) {
    float acc[TE];
#pragma unroll
    for (int e = 0; e < TE; ++e) acc[e] = 0.0f;
    for (int k = 0; k < d.h2; ++k) {
      const float wv = __ldg(W3 + (size_t)k * d.numel + j);
      const float4* hrow = (const float4*)(t.h2T + k * TE);
#pragma unroll
      for (int q = 0; q < TE / 4; ++q) {
        const float4 h = hrow[q];
        acc[4 * q + 0] += h.x * wv;
        acc[4 * q + 1] += h.y * wv;
        acc[4 * q + 2] += h.z * wv;
        acc[4 * q + 3] += h.w * wv;
      }
    }
#pragma unroll
    for (int e = 0; e < TE; ++e) t.ws[e * t.SW + j] = acc[e] * inv_h2;
  }
  __syncthreads();
}
