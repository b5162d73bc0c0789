// Matmul-rate probe: acc = 0.5 acc + a_i @ b, REP times, in one kernel.
//
// Replaces two Pallas TPU probes of the same template:
//   - scripts_dev/r2_pallas_mm.py:mm (pallas_call at :54 .. :60): a_i = a *
//     (1 + s i), the rate of independent products;
//   - scripts_dev/r2_pallas_fma.py:mm (pallas_call at :115 .. :120): a_i = a +
//     acc[0, 0] 1e-20, each product waiting on the last, the latency of a
//     dependent chain (CARRY).
// a (m, k) and b (k, n) are fp32, or bf16 for the bf16 variant; the output
// (copies, m, n) is fp32, `copies` independent copies of the product (the
// TPU contract is one).
//
// A CTA (one warpgroup, 128 threads) owns a 64 x 32 tile of one copy's
// output; a and b stay in shared memory across the REP products when k <=
// 64 (the JAX kernel holds them in VMEM), else their 64-deep k chunks are
// restaged from L2 in every product. Variants, each the way the conv runs
// (or would run) its products:
//   ffma             fp32 on the CUDA cores, 4 x 4 outputs a thread;
//   tf32             mma.sync.m16n8k8, one TF32 pass on operands rounded once
//                    (cvt.rna) when staged;
//   3xtf32           the conv's 3xTF32 split (fused_conv_common.cuh:
//                    mma_3xtf32, split4), cvt.rna inside the loop;
//   3xtf32_presplit  the same three products on hi/lo halves split once when
//                    staged: the price of the cvts;
//   wgmma_tf32       wgmma.mma_async m64n32k8, both operands from shared
//                    memory through matrix descriptors (K-major, no swizzle),
//                    operands rounded once when staged;
//   bf16             mma.sync.m16n8k16 on bf16, fp32 accumulation.
// The factor 1 + s i is applied to each product, (1 + s i)(a @ b) = (a (1 +
// s i)) @ b; the carry of r2_pallas_fma is added to the A operand, so every
// product depends on the one before. The JAX kernel's acc[0, 0] is the
// whole output's first entry, which one TPU core holds; here each CTA
// carries its own tile's first entry: 1e-20 of it is below the rounding of
// a, so the function is the same.
//
// What bounds it on an H100: the tensor cores' issue rate (tf32, 3xtf32,
// wgmma, bf16) or the fp32 pipes (ffma) once a and b sit in shared memory;
// at k = 512 the chunks' restaging from L2 too.
#include <cuda_bf16.h>

#include "fused_conv_common.cuh"

#define PT 128  // threads: one warpgroup, warp w owning rows 16w .. 16w+15
#define PBM 64
#define PBN 32
#define PKC 64  // k per staged chunk
#define LDK (PKC + 4)   // row stride of K-contiguous fp32 tiles (conflict-free fragments)
#define LDH (PKC + 8)   // the same for bf16 tiles

enum { V_FFMA = 0, V_TF32 = 1, V_3XTF32 = 2, V_3XTF32_PRESPLIT = 3, V_WGMMA_TF32 = 4, V_BF16 = 5 };

struct MmArgs {
  const void* a;
  const void* b;
  float* out;
  const float* s;  // the (1, 1) scalar of r2_pallas_mm (unused with the carry)
  int m, k, n, rep, copies;
};

__device__ __forceinline__ float ldf(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[i]) : __ldg((const float*)p + i);
}

// core-matrix layout of a K-major operand with G 8-row groups, no swizzle:
// core matrix (row group rg, k group kg) of 8 rows x 4 values (128 B) at
// (kg * G + rg) * 32 floats, its rows 16 B apart
__device__ __forceinline__ int core_at(int r, int k, int G) {
  return ((k >> 2) * G + (r >> 3)) * 32 + (r & 7) * 4 + (k & 3);
}

// Stages rows row0 .. row0+64 of a and columns col0 .. col0+32 of b, k0 ..
// k0+64, into shared memory in the variant's layout; zeros outside.
template <int V>
__device__ void stage(const MmArgs& p, char* sm, int row0, int col0, int k0) {
  const bool bf = V == V_BF16;
  float* A = (float*)sm;
  for (int idx = threadIdx.x; idx < PBM * PKC; idx += PT) {
    const int r = idx / PKC, kk = idx - r * PKC;
    const int gr = row0 + r, gk = k0 + kk;
    const float v = gr < p.m && gk < p.k ? ldf(p.a, (size_t)gr * p.k + gk, bf) : 0.0f;
    if (V == V_FFMA) {
      A[kk * (PBM + 4) + r] = v;
    } else if (V == V_TF32) {
      A[r * LDK + kk] = __uint_as_float(tf32_rna(v));
    } else if (V == V_3XTF32) {
      A[r * LDK + kk] = v;
    } else if (V == V_3XTF32_PRESPLIT) {
      unsigned hi, lo;
      split_tf32(v, hi, lo);
      A[r * LDK + kk] = __uint_as_float(hi);
      A[PBM * LDK + r * LDK + kk] = __uint_as_float(lo);
    } else if (V == V_WGMMA_TF32) {
      A[core_at(r, kk, PBM / 8)] = __uint_as_float(tf32_rna(v));
    } else {
      ((__nv_bfloat16*)A)[r * LDH + kk] = __float2bfloat16(v);
    }
  }
  const int a_floats = V == V_FFMA ? PKC * (PBM + 4)
                       : V == V_3XTF32_PRESPLIT ? 2 * PBM * LDK
                       : V == V_WGMMA_TF32 ? PBM * PKC
                       : V == V_BF16 ? PBM * LDH / 2 : PBM * LDK;
  float* B = A + a_floats;
  for (int idx = threadIdx.x; idx < PKC * PBN; idx += PT) {
    const int kk = idx / PBN, c = idx - kk * PBN;
    const int gk = k0 + kk, gc = col0 + c;
    const float v = gk < p.k && gc < p.n ? ldf(p.b, (size_t)gk * p.n + gc, bf) : 0.0f;
    if (V == V_FFMA) {
      B[kk * (PBN + 4) + c] = v;
    } else if (V == V_TF32) {
      B[c * LDK + kk] = __uint_as_float(tf32_rna(v));
    } else if (V == V_3XTF32) {
      B[c * LDK + kk] = v;
    } else if (V == V_3XTF32_PRESPLIT) {
      unsigned hi, lo;
      split_tf32(v, hi, lo);
      B[c * LDK + kk] = __uint_as_float(hi);
      B[PBN * LDK + c * LDK + kk] = __uint_as_float(lo);
    } else if (V == V_WGMMA_TF32) {
      B[core_at(c, kk, PBN / 8)] = __uint_as_float(tf32_rna(v));
    } else {
      ((__nv_bfloat16*)B)[c * LDH + kk] = __float2bfloat16(v);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: m64n32k8, TF32 operands from shared memory, fp32 accumulators
// ---------------------------------------------------------------------------

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (between core matrices adjacent in K) and stride byte
// offset (between 8-row groups), all in 16-byte units.
__device__ __forceinline__ unsigned long long wgmma_desc(const float* smem, int lbo, int sbo) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 32, 16 floats a thread in the mma.sync C layout, n-tile j at d[4j
// .. 4j+3] for rows 16 warp + g, + 8) (+)= A (64 x 8) B (8 x 32)
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], unsigned long long da,
                                               unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// bf16 c (16 x 8) += a (16 x 16) b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned bf16x2_plus(unsigned v, float c) {
  __nv_bfloat162 h = *(__nv_bfloat162*)&v;
  h = __floats2bfloat162_rn(__low2float(h) + c, __high2float(h) + c);
  return *(unsigned*)&h;
}

// P += A B over one staged chunk of kc (a multiple of 8; 16 for bf16) k
// values; carry c added to every A value (CARRY).
template <int V, bool CARRY>
__device__ __forceinline__ void chunk_product(char* sm, int kc, float c, float (&P)[16]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const float* A = (const float*)sm;
  if (V == V_FFMA) {
    const float* B = A + PKC * (PBM + 4);
    const int ty = tid >> 3, tx = tid & 7;
    for (int k = 0; k < kc; ++k) {
      float4 av = *(const float4*)&A[k * (PBM + 4) + ty * 4];
      const float4 bv = *(const float4*)&B[k * (PBN + 4) + tx * 4];
      if (CARRY) {
        av.x += c; av.y += c; av.z += c; av.w += c;
      }
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) P[u * 4 + v] = fmaf(a4[u], b4[v], P[u * 4 + v]);
    }
  } else if (V == V_BF16) {
    const unsigned short* Ah = (const unsigned short*)A;
    const unsigned short* Bh = Ah + PBM * LDH;
    const int r0 = warp * 16;
    for (int kb = 0; kb < kc; kb += 16) {
      unsigned a[4];
      a[0] = *(const unsigned*)&Ah[(r0 + g) * LDH + kb + 2 * q];
      a[1] = *(const unsigned*)&Ah[(r0 + g + 8) * LDH + kb + 2 * q];
      a[2] = *(const unsigned*)&Ah[(r0 + g) * LDH + kb + 2 * q + 8];
      a[3] = *(const unsigned*)&Ah[(r0 + g + 8) * LDH + kb + 2 * q + 8];
      if (CARRY) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = bf16x2_plus(a[i], c);
      }
#pragma unroll
      for (int nt = 0; nt < PBN / 8; ++nt) {
        const unsigned b[2] = {*(const unsigned*)&Bh[(nt * 8 + g) * LDH + kb + 2 * q],
                               *(const unsigned*)&Bh[(nt * 8 + g) * LDH + kb + 2 * q + 8]};
        float* p4 = P + 4 * nt;
        float acc[4] = {p4[0], p4[1], p4[2], p4[3]};
        mma_bf16(acc, a, b);
        p4[0] = acc[0]; p4[1] = acc[1]; p4[2] = acc[2]; p4[3] = acc[3];
      }
    }
  } else {
    // TF32 variants: A (64 x LDK) rows, B stored transposed (32 x LDK)
    const int r0 = warp * 16;
    const float* B = A + (V == V_3XTF32_PRESPLIT ? 2 : 1) * PBM * LDK;
    for (int kb = 0; kb < kc; kb += 8) {
      float a[4] = {A[(r0 + g) * LDK + kb + q], A[(r0 + g + 8) * LDK + kb + q],
                    A[(r0 + g) * LDK + kb + q + 4], A[(r0 + g + 8) * LDK + kb + q + 4]};
      unsigned ah[4], al[4];
      if (V == V_3XTF32_PRESPLIT) {
        const float* Al = A + PBM * LDK;
        float l[4] = {Al[(r0 + g) * LDK + kb + q], Al[(r0 + g + 8) * LDK + kb + q],
                      Al[(r0 + g) * LDK + kb + q + 4], Al[(r0 + g + 8) * LDK + kb + q + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = __float_as_uint(a[i]);
          al[i] = __float_as_uint(CARRY ? l[i] + c : l[i]);
        }
      } else if (V == V_3XTF32) {
        if (CARRY) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] += c;
        }
        split4(a, ah, al);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(CARRY ? a[i] + c : a[i]);
      }
#pragma unroll
      for (int nt = 0; nt < PBN / 8; ++nt) {
        const float* br = B + (nt * 8 + g) * LDK + kb + q;
        float acc[4] = {P[4 * nt], P[4 * nt + 1], P[4 * nt + 2], P[4 * nt + 3]};
        if (V == V_3XTF32) {
          const float b[2] = {br[0], br[4]};
          mma_3xtf32(acc, ah, al, b);
        } else if (V == V_3XTF32_PRESPLIT) {
          const float* brl = br + PBN * LDK;
          const unsigned bh[2] = {__float_as_uint(br[0]), __float_as_uint(br[4])};
          const unsigned bl[2] = {__float_as_uint(brl[0]), __float_as_uint(brl[4])};
          // the order of mma_3xtf32: lo hi, hi lo, hi hi
          mma_tf32(acc, al, bh);
          mma_tf32(acc, ah, bl);
          mma_tf32(acc, ah, bh);
        } else {
          const unsigned b[2] = {__float_as_uint(br[0]), __float_as_uint(br[4])};
          mma_tf32(acc, ah, b);
        }
        P[4 * nt] = acc[0]; P[4 * nt + 1] = acc[1]; P[4 * nt + 2] = acc[2]; P[4 * nt + 3] = acc[3];
      }
    }
  }
}

// The wgmma product of one staged chunk: A at a_op (core layout, 8 row
// groups), B at A + PBM * PKC (4 row groups); the first k-step overwrites P
// unless `accumulate`.
__device__ __forceinline__ void chunk_wgmma(const float* a_op, const float* B, int kc,
                                            bool accumulate, float (&P)[16]) {
  wgmma_fence();
  for (int kb = 0; kb < kc; kb += 8) {
    // a k-step is 2 core matrices along K: 2 * G * 128 bytes further on
    const unsigned long long da = wgmma_desc(a_op + (kb >> 2) * (PBM / 8) * 32, (PBM / 8) * 128, 128);
    const unsigned long long db = wgmma_desc(B + (kb >> 2) * (PBN / 8) * 32, (PBN / 8) * 128, 128);
    wgmma_m64n32k8(P, da, db, accumulate || kb > 0 ? 1 : 0);
  }
  wgmma_commit();
  wgmma_wait0();
}

template <int V, bool CARRY>
__global__ void __launch_bounds__(PT) probe_mm_kernel(MmArgs p) {
  extern __shared__ __align__(128) char sm[];
  __shared__ float carry[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tiles_n = (p.n + PBN - 1) / PBN;
  const int row0 = (blockIdx.x / tiles_n) * PBM, col0 = (blockIdx.x % tiles_n) * PBN;
  const int copy = blockIdx.y;
  const int nchunk = (p.k + PKC - 1) / PKC;
  const int kstep = V == V_BF16 ? 16 : (V == V_FFMA ? 1 : 8);
  float* A = (float*)sm;
  float* Bw = A + PBM * PKC;          // wgmma: B after A
  float* A2 = Bw + PBN * PKC;         // wgmma, CARRY: A + c
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  if (nchunk == 1) {
    stage<V>(p, sm, row0, col0, 0);
    if (V == V_WGMMA_TF32) fence_async_shared();
    __syncthreads();
  }
  float c = 0.0f;
  const float sv = CARRY ? 0.0f : __ldg(p.s);
  for (int it = 0; it < p.rep; ++it) {
    if (CARRY && it > 0) {
      if (tid == 0) carry[it & 1] = acc[0] * 1e-20f;
      __syncthreads();
      c = carry[it & 1];
    }
    float P[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) P[i] = 0.0f;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int k0 = ch * PKC;
      const int kc = (min(PKC, p.k - k0) + kstep - 1) / kstep * kstep;
      if (nchunk > 1) {
        __syncthreads();
        stage<V>(p, sm, row0, col0, k0);
        if (V == V_WGMMA_TF32) fence_async_shared();
        __syncthreads();
      }
      if (V == V_WGMMA_TF32) {
        const float* a_op = A;
        if (CARRY) {
          // the perturbed A, rounded by the tensor cores' truncation
          for (int idx = tid; idx < PBM * PKC; idx += PT) A2[idx] = A[idx] + c;
          fence_async_shared();
          __syncthreads();
          a_op = A2;
        }
        chunk_wgmma(a_op, Bw, kc, ch > 0, P);
        if (CARRY) __syncthreads();
      } else {
        chunk_product<V, CARRY>(sm, kc, c, P);
      }
    }
    const float f = CARRY ? 1.0f : 1.0f + sv * (float)it;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = acc[i] * 0.5f + f * P[i];
  }
  float* out = p.out + (size_t)copy * p.m * p.n;
  if (V == V_FFMA) {
    const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = row0 + ty * 4 + u, cc = col0 + tx * 4 + v;
        if (r < p.m && cc < p.n) out[(size_t)r * p.n + cc] = acc[u * 4 + v];
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < PBN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + warp * 16 + g + (i >> 1) * 8, cc = col0 + nt * 8 + 2 * q + (i & 1);
        if (r < p.m && cc < p.n) out[(size_t)r * p.n + cc] = acc[4 * nt + i];
      }
  }
}

static size_t mm_smem(int v) {
  switch (v) {
    case V_FFMA: return sizeof(float) * PKC * (PBM + 4 + PBN + 4);
    case V_3XTF32_PRESPLIT: return sizeof(float) * 2 * (PBM + PBN) * LDK;
    case V_WGMMA_TF32: return sizeof(float) * (2 * PBM + PBN) * PKC;
    case V_BF16: return sizeof(unsigned short) * (PBM + PBN) * LDH;
    default: return sizeof(float) * (PBM + PBN) * LDK;
  }
}

static int smem_limit[2][6][MAX_DEVICES];

template <int V, bool CARRY>
static int launch(const MmArgs& p, void* stream) {
  const size_t smem = mm_smem(V);
  cudaError_t err = raise_smem_limit((const void*)probe_mm_kernel<V, CARRY>, smem,
                                     smem_limit[CARRY][V]);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.m + PBM - 1) / PBM) * ((p.n + PBN - 1) / PBN);
  if (tiles > 0 && p.copies > 0)
    probe_mm_kernel<V, CARRY><<<dim3(tiles, p.copies), PT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool CARRY>
static int launch_variant(int variant, const MmArgs& p, void* stream) {
  switch (variant) {
    case V_FFMA: return launch<V_FFMA, CARRY>(p, stream);
    case V_TF32: return launch<V_TF32, CARRY>(p, stream);
    case V_3XTF32: return launch<V_3XTF32, CARRY>(p, stream);
    case V_3XTF32_PRESPLIT: return launch<V_3XTF32_PRESPLIT, CARRY>(p, stream);
    case V_WGMMA_TF32: return launch<V_WGMMA_TF32, CARRY>(p, stream);
    case V_BF16: return launch<V_BF16, CARRY>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches variant `variant` (0 ffma, 1 tf32, 2 3xtf32, 3 3xtf32_presplit, 4
// wgmma_tf32, 5 bf16: a and b bf16) of the REP product, with the carry of
// r2_pallas_fma when `carry`. Returns cudaGetLastError() after the launch.
extern "C" int probe_mm_launch(int variant, int carry, MmArgs p, void* stream) {
  return carry ? launch_variant<true>(variant, p, stream) : launch_variant<false>(variant, p, stream);
}
