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
// TPU contract is one). Variants, each the way the conv runs (or would run)
// its products:
//   ffma             fp32 on the CUDA cores, 4 x 4 outputs a thread;
//   tf32             mma.sync.m16n8k8, one TF32 pass on operands rounded once
//                    (cvt.rna) when staged;
//   3xtf32           fp32 accuracy as 3xTF32 (hi = cvt.rna(a), lo = cvt.rna(a
//                    - hi), lo hi + hi lo + hi hi), A split for every product:
//                    the price of the cvts;
//   3xtf32_presplit  the same three products, A split once;
//   wgmma_tf32       wgmma.mma_async m64n32k8, both operands from shared
//                    memory through matrix descriptors (K-major, no swizzle),
//                    operands rounded once when staged;
//   bf16             mma.sync.m16n8k16 on bf16, fp32 accumulation.
// The factor 1 + s i is applied to each product, (1 + s i)(a @ b) = (a (1 +
// s i)) @ b; the carry of r2_pallas_fma is added to the A operand, so every
// product depends on the one before. The JAX kernel's acc[0, 0] is the
// whole output's first entry, which one TPU core holds; here each CTA (in
// the 3xTF32 kernel each warpgroup) carries its own tile's first entry:
// 1e-20 of it is below the rounding of a, so the function is the same.
//
// probe_mm_kernel (ffma, tf32, wgmma_tf32, bf16): a CTA (one warpgroup, 128
// threads) owns a 64 x 32 tile of one copy's output; a and b stay in shared
// memory across the REP products when k <= 64 (the JAX kernel holds them in
// VMEM), else their 64-deep k chunks are restaged from L2 in every product.
//
// probe_mm3x_kernel (3xtf32, 3xtf32_presplit). What bounds it on an H100:
// the TF32 tensor cores' issue rate, three products per fp32 one (0.0122
// ms at 1024 x 64 x 960, 495/3 TFLOP/s). The first design ran the three
// products on the kernel above's mma.sync tiles, 64 x 32 a CTA and one
// warpgroup, and reached 31.6 TFLOP/s there (0.0636 ms, 19 % of the bound;
// PERF.md's kernel table): about 95 TFLOP/s of raw TF32, the rate of one warpgroup's
// m64n32 wgmma. This one:
//   - wgmma.mma_async m64nBNk8 TF32 (BN = MM_BN, 64), A from registers (the
//     mma.sync A fragment of each warp's 16 rows), B from shared memory;
//     every one of the REP products runs on the tensor cores, k-step by
//     k-step in the order lo hi, hi lo, hi hi, into a fresh accumulator P
//     (the tensor cores add with truncation), then acc = 0.5 acc + (1 + s
//     i) P in fp32;
//   - a CTA of two warpgroups, each with its own 64 x BN output tile and its
//     own B buffer and named barrier (no block-wide barrier on the way): the
//     host (probes/mm_rate.py:mm_plan) sets them side by side in m (mw 2:
//     1024 x 960 is 120 CTAs, one wave on 132 SMs) or on the two halves of
//     k's steps of one tile (ks 2, the halves' sums added through shared
//     memory at the end: 480 x 512 x 1024 is 128 CTAs instead of 64);
//   - B split once into hi and lo K-major core matrices (8 n x 4 k, 128
//     bytes, no swizzle) in the warpgroup's buffer, A loaded once into
//     registers (__ldg), a 64-deep chunk of k at a time. The rate contract
//     is linear in the products, so a chunk serves all REP products before
//     the next is staged (acc of each chunk, summed): at k 512 a chunk is
//     staged once a call, not once a product. The carried chain needs the
//     whole product for its next A, so it restages its chunks every product
//     when k > 64 (no TPU-script shape does);
//   - 3xtf32 splits A in registers for every product (volatile cvt, which
//     the compiler may not hoist out of the REP loop; on sm_90 a cvt.rna.tf32
//     is a few integer and compare instructions, no conversion unit), half
//     the k-steps' split while the other half's products run; the carried
//     chain splits after adding the carry; 3xtf32_presplit splits A once
//     (the carry is added to lo, as the first design did);
//   - the warpgroup index comes through a shuffle, so that the compiler
//     knows every wgmma's path is uniform across a warp: without it ptxas
//     serialized the wgmma (C7520, "divergent path") and the design ran at
//     0.036 ms.
// It takes 0.0261-0.0269 ms (3xtf32) and 0.0215 (3xtf32_presplit) at 1024
// x 64 x 960, 225 and 281 TFLOP/s of raw TF32; the chain 0.0326 / 0.0214
// (probe_ab.py and chip_smoke.py, H100 SXM, 700 W; PERF.md).
// mm_breakdown.py times this kernel against builds of mm_breakdown.patch
// (wgmma N 32; 3xtf32_presplit's A from shared memory; 3xtf32's split not
// overlapped with the products); the wrappers never load those.
#include <cuda_bf16.h>

#include "fused_conv_common.cuh"

#define MM_BN 64   // the 3xTF32 kernel's output columns a warpgroup (wgmma N)
#define M3_NT 256  // the 3xTF32 kernel: two warpgroups
#define M3_KS 8    // k-steps (of 8) a staged chunk

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
  int mw, ks;  // the 3xTF32 kernel's plan (probes/mm_rate.py:mm_plan)
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
    } else if (V == V_WGMMA_TF32) {
      A[core_at(r, kk, PBM / 8)] = __uint_as_float(tf32_rna(v));
    } else {
      ((__nv_bfloat16*)A)[r * LDH + kk] = __float2bfloat16(v);
    }
  }
  const int a_floats = V == V_FFMA ? PKC * (PBM + 4)
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
    // tf32: A (64 x LDK) rows, B stored transposed (32 x LDK)
    const int r0 = warp * 16;
    const float* B = A + PBM * LDK;
    for (int kb = 0; kb < kc; kb += 8) {
      const float a[4] = {A[(r0 + g) * LDK + kb + q], A[(r0 + g + 8) * LDK + kb + q],
                          A[(r0 + g) * LDK + kb + q + 4], A[(r0 + g + 8) * LDK + kb + q + 4]};
      unsigned ah[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(CARRY ? a[i] + c : a[i]);
#pragma unroll
      for (int nt = 0; nt < PBN / 8; ++nt) {
        const float* br = B + (nt * 8 + g) * LDK + kb + q;
        float acc[4] = {P[4 * nt], P[4 * nt + 1], P[4 * nt + 2], P[4 * nt + 3]};
        const unsigned b[2] = {__float_as_uint(br[0]), __float_as_uint(br[4])};
        mma_tf32(acc, ah, b);
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

// ---------------------------------------------------------------------------
// 3xTF32 on wgmma (3xtf32, 3xtf32_presplit): two warpgroups a CTA
// ---------------------------------------------------------------------------

#define M3_NA (MM_BN / 2)              // accumulator floats a thread
#define M3_G (MM_BN / 8)               // 8-column groups of B
#define M3_BUF (M3_KS * 8 * MM_BN)     // floats of a chunk's B hi (or lo)
#define M3_TOT_AT (2 * M3_BUF)         // a chunk's sums (k > 64)
#define M3_WG_FLOATS (M3_TOT_AT + M3_NA * 128)

// d (64 x 64, the mma.sync C layout of each warp's 16 rows, 8-column group
// j at d[4j .. 4j+3]) (+)= A (64 x 8) B (8 x 64): A from registers (each
// warp's mma.sync m16n8k8 A fragment), B a K-major tile in shared memory.
__device__ __forceinline__ void m3_wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                            unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// TF32 split that the compiler may not hoist out of the REP loop
// (volatile): 3xtf32's cvts stay in every product
__device__ __forceinline__ void m3_split_v(float a, unsigned& hi, unsigned& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  const float r = a - __uint_as_float(hi);
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// named barrier 1 + wg: the 128 threads of warpgroup wg
__device__ __forceinline__ void m3_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// B rows 8 s0 .. 8 (s0 + ns) (ns k-steps) and columns col0 .. col0 + MM_BN,
// split, as K-major core matrices (k quad kq, column group n / 8) of 8 n x
// 4 k at 32 (kq M3_G + n / 8) + 4 (n % 8) floats, hi at Bh, lo M3_BUF on;
// zeros past k and n. Thread wt of the warpgroup's 128 loads all of its
// values before it splits and stores any (one wait on L2, not one a job).
__device__ __forceinline__ void m3_stage_b(const MmArgs& p, float* Bh, int s0, int ns, int col0,
                                           int wt) {
  constexpr int J = 2 * M3_KS * MM_BN / 128;  // a thread's (k quad, column) jobs
  const float* b = (const float*)p.b;
  float v[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int job = wt + 128 * j, kq = job / MM_BN, n = job - kq * MM_BN, gn = col0 + n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = 8 * s0 + 4 * kq + e;
      v[j][e] = kq < 2 * ns && gk < p.k && gn < p.n ? __ldg(b + (size_t)gk * p.n + gn) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int job = wt + 128 * j, kq = job / MM_BN, n = job - kq * MM_BN;
    if (kq < 2 * ns) {
      unsigned h[4], l[4];
      split4(v[j], h, l);
      float* at = Bh + (kq * M3_G + (n >> 3)) * 32 + (n & 7) * 4;
      *(uint4*)at = make_uint4(h[0], h[1], h[2], h[3]);
      *(uint4*)(at + M3_BUF) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// A of k-steps s0 .. s0 + ns as each lane's fragments: rows r0 + g (+ 8),
// columns 8 s + q (+ 4); zeros past m, k and ns
__device__ __forceinline__ void m3_load_a(const MmArgs& p, float (&ar)[M3_KS][4], int r0, int g,
                                          int q, int s0, int ns) {
  const float* a = (const float*)p.a;
#pragma unroll
  for (int s = 0; s < M3_KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i & 1), kk = 8 * (s0 + s) + q + 4 * (i >> 1);
      ar[s][i] = s < ns && r < p.m && kk < p.k ? __ldg(a + (size_t)r * p.k + kk) : 0.0f;
    }
}

template <int N>
__device__ __forceinline__ void m3_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// after a wait: the compiler may not move accesses of d (a wgmma's
// accumulators) to before it
__device__ __forceinline__ void m3_fence_operand(float (&d)[M3_NA]) {
#pragma unroll
  for (int e = 0; e < M3_NA; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// 3xtf32's split of k-steps s0 .. s1 (of the chunk's ns) of ar (+ c) into
// ah and lo, for this product
template <bool CARRY>
__device__ __forceinline__ void m3_split(const float (&ar)[M3_KS][4], unsigned (&ah)[M3_KS][4],
                                         unsigned (&lo)[M3_KS][4], int s0, int s1, int ns,
                                         float c) {
#pragma unroll
  for (int s = 0; s < M3_KS; ++s)
    if (s >= s0 && s < s1 && s < ns) {
#pragma unroll
      for (int i = 0; i < 4; ++i) m3_split_v(CARRY ? ar[s][i] + c : ar[s][i], ah[s][i], lo[s][i]);
    }
}

// P (+)= A B over k-steps s0 .. s1 (of the chunk's ns), 3xTF32 (lo hi, hi
// lo, hi hi a k-step), A's hi and lo from registers (ah, lo); P starts
// afresh at k-step 0 unless `accumulate`. One wgmma group, committed, not
// waited for.
__device__ __forceinline__ void m3_issue(float (&P)[M3_NA], const unsigned (&ah)[M3_KS][4],
                                         const unsigned (&lo)[M3_KS][4], const float* Bh, int s0,
                                         int s1, int ns, bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < M3_KS; ++s)
    if (s >= s0 && s < s1 && s < ns) {
      const unsigned long long bh = wgmma_desc(Bh + 2 * s * M3_G * 32, M3_G * 128, 128);
      const unsigned long long bl = wgmma_desc(Bh + M3_BUF + 2 * s * M3_G * 32, M3_G * 128, 128);
      m3_wgmma_rs(P, lo[s], bh, accumulate || s > 0 ? 1 : 0);
      m3_wgmma_rs(P, ah[s], bl, 1);
      m3_wgmma_rs(P, ah[s], bh, 1);
    }
  wgmma_commit();
}

// P (+)= (A + c) B over the ns k-steps of the staged chunk, waited for:
// 3xtf32 splits ar (+ c) here; 3xtf32_presplit takes ah, al split once (c
// added to lo).
template <bool PRESPLIT, bool CARRY>
__device__ __forceinline__ void m3_products(float (&P)[M3_NA], const float (&ar)[M3_KS][4],
                                            unsigned (&ah)[M3_KS][4],
                                            const unsigned (&al)[M3_KS][4], const float* Bh,
                                            int ns, float c, bool accumulate) {
  unsigned lo[M3_KS][4];
  if constexpr (!PRESPLIT) {
    m3_split<CARRY>(ar, ah, lo, 0, M3_KS, ns, c);
  } else {
#pragma unroll
    for (int s = 0; s < M3_KS; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lo[s][i] = CARRY ? __float_as_uint(__uint_as_float(al[s][i]) + c) : al[s][i];
  }
  m3_issue(P, ah, lo, Bh, 0, M3_KS, ns, accumulate);
  m3_wait<0>();
  m3_fence_operand(P);
}

__device__ __forceinline__ void m3_epilogue(float (&acc)[M3_NA], const float (&P)[M3_NA], float f) {
#pragma unroll
  for (int e = 0; e < M3_NA; ++e) acc[e] = acc[e] * 0.5f + f * P[e];
}

// The rate contract's REP products of one staged chunk into acc (from 0),
// one product's wgmma group at a time. 3xtf32 splits the second half of
// the k-steps while the first half's products run, and the next product's
// first half while the second half's run. (A second accumulator, product
// i + 1 issued before acc takes product i, made ptxas serialize the wgmma:
// 0.0270 ms against 0.0217 for 3xtf32_presplit.)
template <bool PRESPLIT>
__device__ __forceinline__ void m3_rate_chunk(float (&acc)[M3_NA], const float (&ar)[M3_KS][4],
                                              unsigned (&ah)[M3_KS][4], unsigned (&al)[M3_KS][4],
                                              const float* Bh, int ns, float sv, int rep) {
  float P[M3_NA];
#pragma unroll
  for (int e = 0; e < M3_NA; ++e) acc[e] = 0.0f;
  if constexpr (PRESPLIT) {
    for (int it = 0; it < rep; ++it) {
      m3_products<true, false>(P, ar, ah, al, Bh, ns, 0.0f, false);
      m3_epilogue(acc, P, 1.0f + sv * (float)it);
    }
  } else {
    constexpr int H = M3_KS / 2;
    unsigned lo[M3_KS][4];
    m3_split<false>(ar, ah, lo, 0, H, ns, 0.0f);
    for (int it = 0; it < rep; ++it) {
      m3_issue(P, ah, lo, Bh, 0, H, ns, false);
      m3_split<false>(ar, ah, lo, H, M3_KS, ns, 0.0f);
      m3_issue(P, ah, lo, Bh, H, M3_KS, ns, true);
      m3_wait<1>();
      if (it + 1 < rep) m3_split<false>(ar, ah, lo, 0, H, ns, 0.0f);
      m3_wait<0>();
      m3_fence_operand(P);
      m3_epilogue(acc, P, 1.0f + sv * (float)it);
    }
  }
}

// Stages chunk s0 (ns k-steps) for warpgroup wg: B split into its buffer,
// A into registers (split once by 3xtf32_presplit), between the
// warpgroup's barriers.
template <bool PRESPLIT>
__device__ __forceinline__ void m3_stage(const MmArgs& p, float* Bh, float (&ar)[M3_KS][4],
                                         unsigned (&ah)[M3_KS][4], unsigned (&al)[M3_KS][4],
                                         int s0, int ns, int col0, int r0, int wg, int wt) {
  const int g = (wt & 31) >> 2, q = wt & 3;
  m3_wg_sync(wg);  // the last products have read the buffer
  m3_stage_b(p, Bh, s0, ns, col0, wt);
  m3_load_a(p, ar, r0, g, q, s0, ns);
  if (PRESPLIT) {
#pragma unroll
    for (int s = 0; s < M3_KS; ++s) split4(ar[s], ah[s], al[s]);
  }
  fence_async_shared();
  m3_wg_sync(wg);
}

// Warpgroup wg of CTA (tile, copy) computes rows row0 .. row0 + 64 of its
// tile over its k-steps s_lo .. s_hi (the plan: mw 2, the tile's two row
// halves, every k-step; ks 2, the tile's one row block, half the k-steps
// each, warpgroup 1's sums added into warpgroup 0's at the end).
template <bool PRESPLIT, bool CARRY>
__global__ void __launch_bounds__(M3_NT, 1) probe_mm3x_kernel(MmArgs p) {
  extern __shared__ __align__(128) float m3_sm[];
  __shared__ float carry[2][2];
  // wg through a shuffle: the compiler then knows it (and all that follows
  // from it: rows, k-steps) is the same across a warp, so that no wgmma
  // lies on a path it must assume divergent (ptxas serializes those)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, q = lane & 3;
  const int tiles_n = (p.n + MM_BN - 1) / MM_BN;
  const int tm = blockIdx.x / tiles_n, col0 = (blockIdx.x - tm * tiles_n) * MM_BN;
  const int row0 = tm * 64 * p.mw + (p.mw == 2 ? 64 * wg : 0);
  const int nks = (p.k + 7) >> 3, per = (nks + p.ks - 1) / p.ks;
  const int s_lo = p.ks == 2 ? wg * per : 0, s_hi = min(nks, s_lo + per);
  if (p.ks == 1 && row0 >= p.m) return;  // no block-wide barrier follows with ks 1
  float* Bh = m3_sm + wg * M3_WG_FLOATS;
  const int r0 = row0 + 16 * warp;
  float acc[M3_NA], ar[M3_KS][4];
  unsigned ah[M3_KS][4], al[M3_KS][4];
#pragma unroll
  for (int e = 0; e < M3_NA; ++e) acc[e] = 0.0f;
  if (!CARRY) {
    // the rate contract is linear in the products: each chunk runs all REP
    // products (its own acc), the chunks' accs summed in shared memory (each
    // thread its own slots)
    const float sv = __ldg(p.s);
    const bool multi = s_hi - s_lo > M3_KS;
    float* tot = Bh + M3_TOT_AT;
    for (int s0 = s_lo; s0 < s_hi; s0 += M3_KS) {
      const int ns = min(M3_KS, s_hi - s0);
      m3_stage<PRESPLIT>(p, Bh, ar, ah, al, s0, ns, col0, r0, wg, wt);
      m3_rate_chunk<PRESPLIT>(acc, ar, ah, al, Bh, ns, sv, p.rep);
      if (multi) {
#pragma unroll
        for (int e = 0; e < M3_NA; ++e)
          tot[e * 128 + wt] = (s0 == s_lo ? 0.0f : tot[e * 128 + wt]) + acc[e];
      }
    }
    if (multi) {
#pragma unroll
      for (int e = 0; e < M3_NA; ++e) acc[e] = tot[e * 128 + wt];
    }
  } else {
    // the carried chain: product i needs all of product i - 1
    const bool single = s_hi - s_lo <= M3_KS;
    if (single)
      m3_stage<PRESPLIT>(p, Bh, ar, ah, al, s_lo, s_hi - s_lo, col0, r0, wg, wt);
    float c = 0.0f, P[M3_NA];
    for (int it = 0; it < p.rep; ++it) {
      if (it > 0) {
        if (wt == 0) carry[wg][it & 1] = acc[0] * 1e-20f;  // the tile's first entry
        m3_wg_sync(wg);
        c = carry[wg][it & 1];
      }
      for (int s0 = s_lo; s0 < s_hi; s0 += M3_KS) {
        const int ns = min(M3_KS, s_hi - s0);
        if (!single) m3_stage<PRESPLIT>(p, Bh, ar, ah, al, s0, ns, col0, r0, wg, wt);
        m3_products<PRESPLIT, true>(P, ar, ah, al, Bh, ns, c, s0 > s_lo);
      }
      m3_epilogue(acc, P, 1.0f);
    }
  }
  if (p.ks == 2) {
    __syncthreads();  // both warpgroups' products are done: the buffers are free
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < M3_NA; ++e) m3_sm[e * 128 + wt] = acc[e];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < M3_NA; ++e) acc[e] += m3_sm[e * 128 + wt];
  }
  float* out = p.out + (size_t)blockIdx.y * p.m * p.n;
  const bool pairs = (p.n & 1) == 0 && ((size_t)p.out & 7) == 0;
#pragma unroll
  for (int j = 0; j < M3_G; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, cc = col0 + 8 * j + 2 * q;
      if (r >= p.m || cc >= p.n) continue;
      float* o = out + (size_t)r * p.n + cc;
      if (pairs) {
        *(float2*)o = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[0] = acc[4 * j + 2 * h];
        if (cc + 1 < p.n) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
}

static int smem_limit3[2][2][MAX_DEVICES];

// The 3xTF32 kernel with the host's plan: mw 2 and ks 1, or mw 1 and ks 2
// (not with the carry, and at least 2 k-steps).
template <bool PRESPLIT, bool CARRY>
static int launch3x(const MmArgs& p, void* stream) {
  const bool plan_ok = (p.mw == 2 && p.ks == 1) ||
                       (p.mw == 1 && p.ks == 2 && !CARRY && (p.k + 7) / 8 >= 2);
  if (!plan_ok || p.copies > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * M3_WG_FLOATS;
  cudaError_t err = raise_smem_limit((const void*)probe_mm3x_kernel<PRESPLIT, CARRY>, smem,
                                     smem_limit3[PRESPLIT][CARRY]);
  if (err != cudaSuccess) return (int)err;
  const int ctas = ((p.m + 64 * p.mw - 1) / (64 * p.mw)) * ((p.n + MM_BN - 1) / MM_BN);
  if (ctas > 0 && p.copies > 0)
    probe_mm3x_kernel<PRESPLIT, CARRY>
        <<<dim3(ctas, p.copies), M3_NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static size_t mm_smem(int v) {
  switch (v) {
    case V_FFMA: return sizeof(float) * PKC * (PBM + 4 + PBN + 4);
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
    case V_3XTF32: return launch3x<false, CARRY>(p, stream);
    case V_3XTF32_PRESPLIT: return launch3x<true, CARRY>(p, stream);
    case V_WGMMA_TF32: return launch<V_WGMMA_TF32, CARRY>(p, stream);
    case V_BF16: return launch<V_BF16, CARRY>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches variant `variant` (0 ffma, 1 tf32, 2 3xtf32, 3 3xtf32_presplit, 4
// wgmma_tf32, 5 bf16: a and b bf16) of the REP product, with the carry of
// r2_pallas_fma when `carry`; 3xtf32 and 3xtf32_presplit on the 3xTF32
// kernel with the plan's mw and ks. Returns cudaGetLastError() after the
// launch.
extern "C" int probe_mm_launch(int variant, int carry, MmArgs p, void* stream) {
  return carry ? launch_variant<true>(variant, p, stream) : launch_variant<false>(variant, p, stream);
}
