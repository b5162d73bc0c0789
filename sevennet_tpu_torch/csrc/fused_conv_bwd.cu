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
// factored products of its docstring (:906-920): the weight cotangent
// reuses the x/tmp products, dtmp reuses x*w. The embedding and
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

// (ea, eb): (vec, coef) in vec mode, (emb, sh) in emb/sh mode; (da, db):
// (dvec, unused) in vec mode, (demb, dsh) in emb/sh mode.
template <bool PG, bool EMBSH>
__global__ void __launch_bounds__(NT) fused_conv_bwd_kernel(
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
    load_tile<EMBSH>(d, t, i, t0, ne, x, src, ea, eb, W1, W2, W3, itab, ftab);

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
    } else if (tid < ne) {
      // chain demb and dsh to the edge vector: one thread per edge
      const int e = tid;
      const float* g = t.geo + e * 8;
      const float r = g[0], rinv = g[1], u0 = g[2], u1 = g[3], u2 = g[4], env = g[5], denv = g[6];
      const float pref = (float)(2.0 / (double)d.cutoff);
      float* dc = PG ? work + (size_t)t.flats[e] * L.stride + L.dc : nullptr;
      float dr = 0.0f;
      for (int n = 0; n < NB; ++n) {
        const float c = eb[n];
        const float sr = sinf(c * r), cr = cosf(c * r);
        const float dembdr = pref * (c * cr * (rinv * env) + sr * (denv * rinv - env * rinv * rinv));
        dr += t.demb[e * NB + n] * dembdr;
        // d emb_n / d c_n = pref * cos(c_n r) * env (_emb_sh_bwd_rows, :316-317)
        if (PG) dc[n] = t.demb[e * NB + n] * (pref * cr * env);
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
      da[flat] = (du[0] - u0 * udu) * rinv + u0 * dr;
      da[NK + flat] = (du[1] - u1 * udu) * rinv + u1 * dr;
      da[2 * NK + flat] = (du[2] - u2 * udu) * rinv + u2 * dr;
    }
    __syncthreads();
  }
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
