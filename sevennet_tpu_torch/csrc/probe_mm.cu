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
//   ffma             fp32 on the CUDA cores, 8 x 8 outputs a thread;
//   tf32             mma.sync.m16n8k8, one TF32 pass on operands rounded once
//                    (cvt.rna's rounding) when their fragments are loaded;
//   3xtf32           fp32 accuracy as 3xTF32 (hi = cvt.rna(a), lo = cvt.rna(a
//                    - hi), lo hi + hi lo + hi hi), A split for every product:
//                    the price of the cvts;
//   3xtf32_presplit  the same three products, A split once;
//   wgmma_tf32       wgmma.mma_async m64n64k8 or m64n128k8, both operands
//                    from shared memory through matrix descriptors (K-major,
//                    no swizzle), operands rounded once when staged;
//   bf16             mma.sync.m16n8k16 on bf16, fp32 accumulation.
// The factor 1 + s i scales the products, (1 + s i)(a @ b) = (a (1 + s i))
// @ b (the 3xTF32 kernel each product's, the others their weighted sum at
// the store, below); the carry of r2_pallas_fma is added to the A operand, so every
// product depends on the one before. The JAX kernel's acc[0, 0] is the
// whole output's first entry, which one TPU core holds; here each warpgroup
// carries its own tile's first entry: 1e-20 of it is below the rounding of
// a, so the function is the same.
//
// All three kernels run a CTA a tile and copy, of two warpgroups on one plan
// (probes/mm_rate.py: mm_plan): each warpgroup owns a 64 x 64 output tile
// with its own buffers and named barrier, side by side in m (mw 2: 1024 x
// 960 is 120 CTA tiles, one wave on 132 SMs) or on the two halves of k's
// steps of one tile (ks 2, the halves' sums added through shared memory at
// the end: 480 x 512 x 1024 is 128 instead of 64); ffma, tf32, wgmma_tf32
// and bf16 also one warpgroup a CTA (mw 1, ks 1: 1024 x 9 x 185's chain on
// 48 SMs, not 24), wgmma_tf32 also on 64 x 128 tiles. The rate contract is
// linear in the products, so a staged 64-deep chunk of k serves all REP
// products before the next is staged (acc of each chunk, summed): at any k
// a chunk is staged once a call, not once a product. The carried chain
// needs the whole product for its next A, so it restages its chunks every
// product when k > 64 (no TPU-script shape does).
//
// probe_mm_ffma_kernel (ffma). What bounds it on an H100: FFMA issue, 67
// TFLOP/s (0.0300 ms at 1024 x 64 x 960). A thread's 8 x 8 outputs take four
// 16-byte shared loads a k (8 rows of A, staged transposed; two rows of 4 of
// B) for 64 FFMA; the warpgroup's two halves of 64 threads take the two
// halves of a chunk's k (their sums added through shared memory), and two
// CTAs an SM (registers; one for the chain, whose carry would spill at 128
// registers). Its shared loads go through an offset the
// compiler cannot see across products, so nothing of a product is hoisted
// out of the REP loop. Chunks are staged by 16-byte loads into registers
// (4-byte ones where a row is not 16-byte aligned: k 9, n 185), all issued
// before any store; the chain adds c to A's values as they feed the FFMAs.
//
// probe_mm_tc_kernel (tf32, wgmma_tf32, bf16). What bounds it on an H100:
// the tensor cores' rate, 495 TFLOP/s TF32 (0.0041 ms at 1024 x 64 x 960)
// and 989 bf16 (0.0020); at one copy of the TPU scripts' shapes the cost of
// a call outside its products (the launch, the first chunk's staging, the
// store: 3-7 us) is of the same size. So:
//   - a warpgroup's stagings (its chunks, or for the restaged chain each
//     product's) form one stream, each chunk copied by cp.async into one of
//     two buffers while the chunk before runs its products; the store is
//     fire and forget;
//   - the copies are 16 bytes where rows are 16-byte aligned (else 4 bytes a
//     value; bf16 with k or n not a multiple of 8 by loads and stores),
//     zero-filled past m, n and the chunk's k: tf32's and bf16's A and B
//     row-major (padded rows), wgmma_tf32's as K-major core matrices (8 rows
//     x 4 k, 128 bytes), B's values 4 bytes at a time into their transposed
//     places (TF32 wgmma reads K-major operands only), each thread's 16-byte
//     pieces then rounded to TF32 in place;
//   - tf32, bf16: a warp owns a 32 x 32 tile (2 x 4 mma tiles); its A and B
//     fragments of a chunk (64 + 64 registers for tf32, 32 + 32 for bf16 at
//     k 64) are loaded once from the staged chunk (tf32 rounding them) and
//     serve all REP products: a product issues its mmas with no
//     shared-memory load;
//   - wgmma_tf32: m64nNk8 with N 64, or 128 where a warpgroup's k-steps are
//     one chunk (mm_plan takes it at the k-64 shapes: 128 and 120 CTAs of
//     one warpgroup). At N 64 a k-step reads 2 KB of A and 2 KB of B for
//     32,768 MACs, 128 B a clock at the peak, shared memory's full rate (N
//     32 needed 192 B and capped it at two thirds); at N 128 it reads 6 KB
//     for twice the MACs, 96 B a clock: 0.0120 against 0.0130 ms at 1024 x
//     64 x 960, where N 64 on 120 CTAs of two warpgroups was the best of
//     its arrangements (mm_breakdown.py --only wgmma). One product is one
//     wgmma group of the chunk's k-steps, waited for before the acc update:
//     two accumulators, each product issued while the one before ran and
//     the wait deferred by one product, were slower at every shape (0.0164
//     against 0.0130 ms at 1024 x 64 x 960 at N 64, 0.0172 against 0.0120
//     at N 128; the same measurement). The warpgroup
//     index comes through a shuffle (see the 3xTF32 kernel). The chain
//     rewrites its A tile plus c from registers that hold the staged A (8
//     16-byte stores a thread a product: no second buffer and no
//     shared-memory read).
// In the rate contract both run u = 0.5 u + P a product (the mma's or
// wgmma's accumulators, the FFMAs' sums: one multiply an output a product)
// and multiply the output once by W / S (mm_weight): acc = sum_i
// 0.5^(REP-1-i) (1 + s i) P = W P and u = S P, so that no factor 1 + s i,
// which may be 0, divides anything. Every product runs: the mmas and
// wgmmas are volatile asm, each product's accumulators differ from the
// last's. mm_breakdown.py times knock-out builds of both kernels (no
// staging, no products, no acc update, no store) from mm_breakdown.patch;
// the wrappers never load those.
//
// probe_mm3x_kernel (3xtf32, 3xtf32_presplit). What bounds it on an H100:
// the TF32 tensor cores' issue rate, three products per fp32 one (0.0122
// ms at 1024 x 64 x 960, 495/3 TFLOP/s). The first design ran the three
// products on mma.sync tiles, 64 x 32 a CTA and one
// warpgroup, and reached 31.6 TFLOP/s there (0.0636 ms, 19 % of the bound;
// PERF.md's kernel table): about 95 TFLOP/s of raw TF32, the rate of one warpgroup's
// m64n32 wgmma. This one:
//   - wgmma.mma_async m64nBNk8 TF32 (BN = MM_BN, 64), A from registers (the
//     mma.sync A fragment of each warp's 16 rows), B from shared memory;
//     every one of the REP products runs on the tensor cores, k-step by
//     k-step in the order lo hi, hi lo, hi hi, into a fresh accumulator P
//     (the tensor cores add with truncation), then acc = 0.5 acc + (1 + s
//     i) P in fp32;
//   - B split once into hi and lo K-major core matrices (8 n x 4 k, 128
//     bytes, no swizzle) in the warpgroup's buffer, A loaded once into
//     registers (__ldg), a 64-deep chunk of k at a time;
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

enum { V_FFMA = 0, V_TF32 = 1, V_3XTF32 = 2, V_3XTF32_PRESPLIT = 3, V_WGMMA_TF32 = 4, V_BF16 = 5 };

struct MmArgs {
  const void* a;
  const void* b;
  float* out;
  const float* s;  // the (1, 1) scalar of r2_pallas_mm (unused with the carry)
  int m, k, n, rep, copies;
  int mw, ks;  // the plan (probes/mm_rate.py:mm_plan)
  int rows;    // a warpgroup tile's rows: 64, or (ffma) 32
  int bn;      // a warpgroup tile's columns: 64, or (wgmma_tf32) 128
};

// ---------------------------------------------------------------------------
// wgmma: TF32 operands from shared memory through matrix descriptors
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

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
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

// ---------------------------------------------------------------------------
// Staging helpers of probe_mm_ffma_kernel and probe_mm_tc_kernel
// ---------------------------------------------------------------------------

// 4 floats of the row-major x (leading dimension ld) at row r, columns c ..
// c + 3 (c a multiple of 4); zeros at and past column ce and for r >= re.
// One 16-byte load when vec (ld a multiple of 4, x 16-byte aligned) and all
// four lie before ce.
__device__ __forceinline__ float4 m1_ld4(const float* x, int r, int re, int c, int ce, int ld,
                                         bool vec) {
  const float* at = x + (size_t)r * ld + c;
  if (vec && r < re && c + 4 <= ce) return __ldg((const float4*)at);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= re || c >= ce) return v;
  v.x = __ldg(at);
  if (c + 1 < ce) v.y = __ldg(at + 1);
  if (c + 2 < ce) v.z = __ldg(at + 2);
  if (c + 3 < ce) v.w = __ldg(at + 3);
  return v;
}

// The same for 8 bf16 (c a multiple of 8), as four words; vec: ld a
// multiple of 8
__device__ __forceinline__ uint4 m1_ld8h(const unsigned short* x, int r, int re, int c, int ce,
                                         int ld, bool vec) {
  if (r >= re || c >= ce) return make_uint4(0, 0, 0, 0);
  const unsigned short* at = x + (size_t)r * ld + c;
  if (vec && c + 8 <= ce) return __ldg((const uint4*)at);
  unsigned w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned lo = c + 2 * e < ce ? __ldg(at + 2 * e) : 0u;
    const unsigned hi = c + 2 * e + 1 < ce ? __ldg(at + 2 * e + 1) : 0u;
    w[e] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero; Inf and
// NaN kept) in integer instructions: the cvt runs on a slow pipe, and 64 of
// them a thread took 3,800 cycles of staging a 64 x 64 chunk
__device__ __forceinline__ float m1_rna(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u & 0x7F800000u) == 0x7F800000u ? u : (u + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float4 m1_tf32(float4 v) {
  return make_float4(m1_rna(v.x), m1_rna(v.y), m1_rna(v.z), m1_rna(v.w));
}

template <int NA>
__device__ __forceinline__ void mm_scale(float (&d)[NA], float f) {
#pragma unroll
  for (int e = 0; e < NA; ++e) d[e] *= f;
}

// The rate contract's weight of the products: acc = sum_i 0.5^(REP-1-i) (1
// + s i) P = W P, where the kernels run u = sum_i 0.5^(REP-1-i) P = S P
// product by product; the output is u W / S (0 without products). Every
// factor 1 + s i may be 0 or negative: nothing divides by one.
__device__ __forceinline__ float mm_weight(float sv, int rep) {
  float w = 0.0f, s = 0.0f;
  for (int it = 0; it < rep; ++it) {
    w = 0.5f * w + (1.0f + sv * (float)it);
    s = 0.5f * s + 1.0f;
  }
  return rep > 0 ? w / s : 0.0f;
}

// ---------------------------------------------------------------------------
// probe_mm_ffma_kernel (ffma): two warpgroups a CTA on the CUDA cores
// ---------------------------------------------------------------------------

#define MF_NA 64                                 // accumulators a thread, at most (8 x 8)
#define MF_WG_FLOATS (2 * 64 * 64 + MF_NA * 64)  // a chunk's A^T and B; the halves' sums

// Stages the warpgroup's chunk: a's rows row0 .. row0 + rows transposed (64
// k x 64 rows, zeros past) and b's columns col0 .. col0 + 64 (64 k x 64 n)
// at k k0 .. k0 + 64, zeros at and past kend (and past m and n), by 16-byte
// loads (thread wt's jobs wt + 128 j), every load issued before any store
// (one wait on L2).
__device__ __forceinline__ void mf_stage(const MmArgs& p, float* buf, int row0, int col0, int k0,
                                         int kend, int wt) {
  const float* a = (const float*)p.a;
  const float* b = (const float*)p.b;
  const bool va = (p.k & 3) == 0 && ((size_t)a & 15) == 0;
  const bool vb = (p.n & 3) == 0 && ((size_t)b & 15) == 0;
  float* At = buf;
  float* Bs = buf + 64 * 64;
  float4 xa[8], xb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int job = wt + 128 * j;
    xa[j] = m1_ld4(a, row0 + (job & 63), min(p.m, row0 + p.rows), k0 + 4 * (job >> 6), kend,
                   p.k, va);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int job = wt + 128 * j;
    xb[j] = m1_ld4(b, k0 + (job >> 4), kend, col0 + 4 * (job & 15), p.n, p.n, vb);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int job = wt + 128 * j, r = job & 63, kq = job >> 6;
    At[(4 * kq) * 64 + r] = xa[j].x;
    At[(4 * kq + 1) * 64 + r] = xa[j].y;
    At[(4 * kq + 2) * 64 + r] = xa[j].z;
    At[(4 * kq + 3) * 64 + r] = xa[j].w;
    *(float4*)&Bs[(job >> 4) * 64 + 4 * (job & 15)] = xb[j];
  }
}

// u += (A + c) B over the staged chunk's kc values of k (c is 0 unless
// CARRY): thread (ty, tx) of half h of the warpgroup, TR rows from TR ty and
// columns 4 tx .. and 32 + 4 tx .., u[8 row + 4 column group + x], over
// half h of the chunk's k. Its shared loads go through an offset the
// compiler cannot see, so that they stay in every product.
template <bool CARRY, int TR>
__device__ __forceinline__ void mf_product(float (&u)[8 * TR], const float* buf, int kc, float c,
                                           int wt) {
  int off = 0;
  asm volatile("" : "+r"(off));
  const float* At = buf + off;
  const float* Bs = At + 64 * 64;
  const int h = wt >> 6, ty = (wt & 63) >> 3, tx = wt & 7;
  auto step = [&](int k) {
    float a8[8];
#pragma unroll
    for (int q4 = 0; q4 < TR / 4; ++q4) {
      const float4 a4 = *(const float4*)&At[k * 64 + TR * ty + 4 * q4];
      a8[4 * q4] = a4.x; a8[4 * q4 + 1] = a4.y; a8[4 * q4 + 2] = a4.z; a8[4 * q4 + 3] = a4.w;
    }
    const float4 b0 = *(const float4*)&Bs[k * 64 + 4 * tx];
    const float4 b1 = *(const float4*)&Bs[k * 64 + 32 + 4 * tx];
    const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float ai = CARRY ? a8[i] + c : a8[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) u[8 * i + j] = fmaf(ai, b8[j], u[8 * i + j]);
    }
  };
  // half h of the warpgroup: the chunk's k from k0 to k1
  const int kh = (kc + 1) >> 1, k1 = h ? kc : kh;
  int k = h ? kh : 0;
  for (; k + 8 <= k1; k += 8) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) step(k + kk);
  }
  for (; k + 4 <= k1; k += 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) step(k + kk);
  }
  for (; k < k1; ++k) step(k);
}

// Warpgroup wg of CTA (tile, copy) computes rows row0 .. row0 + 8 TR of its
// tile over its k-steps s_lo .. s_hi (mm_plan: mw 2, the tile's two row
// halves, every k-step; ks 2, the tile's one row block, half the k-steps
// each, warpgroup 1's sums added into warpgroup 0's at the end; mw 1 and ks
// 1, one warpgroup a CTA, and then TR 4 where the plan asks for 32-row
// tiles: twice the CTAs, half the FFMAs a thread). The warpgroup's two
// halves (64 threads each) take the two halves of a chunk's k, their sums
// added through the warpgroup's tot; half 0 stores.
template <bool CARRY, int TR>
__global__ void __launch_bounds__(M3_NT, CARRY ? 1 : 2) probe_mm_ffma_kernel(MmArgs p) {
  constexpr int NA = 8 * TR;  // accumulators a thread
  extern __shared__ __align__(128) float mf_sm[];
  __shared__ float carry[2][2][2];
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int h = wt >> 6, t = wt & 63;
  const int tiles_n = (p.n + 63) >> 6;
  const int tm = blockIdx.x / tiles_n, col0 = (blockIdx.x - tm * tiles_n) * 64;
  const int row0 = tm * 8 * TR * p.mw + (p.mw == 2 ? 8 * TR * wg : 0);
  const int nks = (p.k + 7) >> 3, per = (nks + p.ks - 1) / p.ks;
  const int s_lo = p.ks == 2 ? wg * per : 0, s_hi = min(nks, s_lo + per);
  if (p.ks == 1 && row0 >= p.m) return;  // no block-wide barrier follows with ks 1
  float* buf = mf_sm + wg * MF_WG_FLOATS;
  float* tot = buf + 2 * 64 * 64;
  float u[NA];
  // the halves' sums (and the chunks', k > 64) in tot, each thread its own
  // slots: half 0's first, then half 1's added
  auto add_tot = [&](bool first) {
    if (h == 0) {
#pragma unroll
      for (int e = 0; e < NA; ++e) tot[e * 64 + t] = (first ? 0.0f : tot[e * 64 + t]) + u[e];
    }
    m3_wg_sync(wg);
    if (h == 1) {
#pragma unroll
      for (int e = 0; e < NA; ++e) tot[e * 64 + t] += u[e];
    }
  };
  // waits for the warpgroup's last products to have read its buffer, then
  // stages k-steps s0 .. s0 + ns
  auto load = [&](int s0, int ns) {
    m3_wg_sync(wg);
    mf_stage(p, buf, row0, col0, 8 * s0, min(p.k, 8 * (s0 + ns)), wt);
    m3_wg_sync(wg);
  };
#pragma unroll
  for (int e = 0; e < NA; ++e) u[e] = 0.0f;
  if (!CARRY) {
    // each chunk runs all REP products (u from 0), the chunks' accs summed
    for (int s0 = s_lo; s0 < s_hi; s0 += M3_KS) {
      const int ns = min(M3_KS, s_hi - s0), kc = min(p.k, 8 * (s0 + ns)) - 8 * s0;
      load(s0, ns);
#pragma unroll
      for (int e = 0; e < NA; ++e) u[e] = 0.0f;
      for (int it = 0; it < p.rep; ++it) {
        mm_scale(u, 0.5f);  // the weights 1 + s i are applied once, at the store
        mf_product<false, TR>(u, buf, kc, 0.0f, wt);
      }
      add_tot(s0 == s_lo);
    }
  } else {
    // the carried chain: product i needs all of product i - 1
    const bool single = s_hi - s_lo <= M3_KS;
    if (single) load(s_lo, s_hi - s_lo);
    for (int it = 0; it < p.rep; ++it) {
      // acc = 0.5 acc, c of the tile's first entry (the halves' sum); both 0
      // at it 0, where acc is
      if (t == 0) carry[wg][h][it & 1] = u[0];
      m3_wg_sync(wg);
      const float c = (carry[wg][0][it & 1] + carry[wg][1][it & 1]) * 1e-20f;
#pragma unroll
      for (int e = 0; e < NA; ++e) u[e] *= 0.5f;
      for (int s0 = s_lo; s0 < s_hi; s0 += M3_KS) {
        const int ns = min(M3_KS, s_hi - s0), kc = min(p.k, 8 * (s0 + ns)) - 8 * s0;
        if (!single) load(s0, ns);
        mf_product<true, TR>(u, buf, kc, c, wt);
      }
    }
    add_tot(true);
  }
  m3_wg_sync(wg);
  if (h == 0) {
#pragma unroll
    for (int e = 0; e < NA; ++e) u[e] = tot[e * 64 + t];
  }
  if (p.ks == 2) {
    __syncthreads();  // both warpgroups' products are done: the buffers are free
    if (wg == 1 && h == 0) {
#pragma unroll
      for (int e = 0; e < NA; ++e) mf_sm[e * 64 + t] = u[e];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < NA; ++e) u[e] += mf_sm[e * 64 + t];
  }
  if (h == 1) return;
  if (!CARRY) mm_scale(u, mm_weight(__ldg(p.s), p.rep));
  // thread (ty, tx) of half 0: rows TR ty .., columns 4 tx .. and 32 + 4 tx ..
  float* out = p.out + (size_t)blockIdx.y * p.m * p.n;
  const int ty = t >> 3, tx = t & 7;
  const bool quads = (p.n & 3) == 0 && ((size_t)p.out & 15) == 0;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int r = row0 + TR * ty + i, cc = col0 + 32 * hc + 4 * tx;
      if (r >= p.m || cc >= p.n) continue;
      const float* v = u + 8 * i + 4 * hc;
      float* o = out + (size_t)r * p.n + cc;
      if (quads) {
        *(float4*)o = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cc + e < p.n) o[e] = v[e];
      }
    }
}

// ---------------------------------------------------------------------------
// probe_mm_tc_kernel (tf32, wgmma_tf32, bf16): two warpgroups a CTA, or one
// ---------------------------------------------------------------------------

#define TC_LDA 68  // tf32: row stride of A (64 rows x 64 k)
#define TC_LDB 72  // tf32: of B (64 k x 64 n); bf16: of A and B, in halves

// Floats of variant V's staged chunk at TN output columns a warpgroup (TN
// 128: wgmma_tf32 only), of the warpgroup's region (its buffers, two where
// TN is 64, one where it is 128, which the plan takes only at k <= 64, and
// at TN 64 its chunks' sums) and of the CTA's shared memory (and warpgroup
// 1's sums, ks 2)
template <int V, int TN>
__host__ __device__ constexpr int tc_buf() {
  return V == V_WGMMA_TF32 ? 64 * 64 + 64 * TN : 64 * TC_LDA + 64 * TC_LDB;
}
template <int V, int TN>
__host__ __device__ constexpr int tc_wg_floats() {
  return TN == 64 ? 2 * tc_buf<V, TN>() + 32 * 128 : tc_buf<V, TN>();
}
template <int V, int TN>
__host__ __device__ constexpr int tc_floats(int wgs, int ks) {
  return wgs * tc_wg_floats<V, TN>() + (ks == 2 ? TN / 2 * 128 : 0);
}

// d (64 x N in m3_wgmma_rs's layout, 8-column group j at d[4j .. 4j+3])
// (+)= A (64 x 8) B (8 x N), both K-major tiles in shared memory; N 64 or
// 128
__device__ __forceinline__ void tc_wgmma_ss(float (&d)[32], unsigned long long a,
                                            unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void tc_wgmma_ss(float (&d)[64], unsigned long long a,
                                            unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// after a wait: the compiler may not move accesses of d to before it
template <int NA>
__device__ __forceinline__ void tc_fence_operand(float (&d)[NA]) {
#pragma unroll
  for (int e = 0; e < NA; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// wgmma_tf32's 16-byte pieces of thread wt: A's (row r, k quad kq), j of 8,
// a warp's 32 on 8 rows x 4 quads (64 bytes of each row read, 4 x 128 bytes
// written); B's (column n, k quad kq), j of TN / 8, a warp's 32 on 32
// columns
__device__ __forceinline__ void tc_a_piece(int wt, int j, int& r, int& kq) {
  const int J = (wt >> 5) + 4 * j, lane = wt & 31;
  r = 8 * (J & 7) + (lane & 7);
  kq = 4 * (J >> 3) + (lane >> 3);
}
template <int TN>
__device__ __forceinline__ void tc_b_piece(int wt, int j, int& n, int& kq) {
  const int J = (wt >> 5) + 4 * j;
  n = 32 * (J % (TN / 32)) + (wt & 31);
  kq = J / (TN / 32);
}

// at of (row r, 4 k from 4 kq) in a K-major core-matrix tile of R rows
template <int R>
__device__ __forceinline__ int tc_core(int r, int kq) {
  return (kq * (R / 8) + (r >> 3)) * 32 + (r & 7) * 4;
}

// The warpgroup's chunk, to be staged into buf: a's rows row0 .. row0 + 64
// and b's columns col0 .. col0 + TN at k k0 .. k0 + 64, zeros at and past
// kend (and past m and n).
struct TcChunk {
  float* buf;
  int row0, col0, k0, kend;
};

// Issues the cp.async copies of piece pc of a thread's part of chunk x (not
// committed), into variant V's layout:
//   tf32        A (64 rows x TC_LDA), B (64 k x TC_LDB), 8 pieces of each;
//   wgmma_tf32  A and B (n as rows) as K-major core matrices, each thread
//               8 16-byte pieces of A (tc_a_piece), TN / 8 of B
//               (tc_b_piece), B's values 4 bytes at a time;
//   bf16        A (64 rows x TC_LDB halves), B (64 k x TC_LDB halves), 4
//               pieces of each (pieces 8-15 empty); where k or n is not a
//               multiple of 8, by loads and stores at piece 0, not copies.
// 16-byte copies where rows are 16-byte aligned, else 4 bytes a value.
template <int V, int TN>
__device__ __forceinline__ void tc_stage_piece(const MmArgs& p, const TcChunk& x, int wt, int pc) {
  const int row0 = x.row0, col0 = x.col0, k0 = x.k0, kend = x.kend;
  if constexpr (V == V_BF16) {
    const unsigned short* a = (const unsigned short*)p.a;
    const unsigned short* b = (const unsigned short*)p.b;
    unsigned short* Ah = (unsigned short*)x.buf;
    unsigned short* Bh = Ah + 64 * TC_LDB;
    if ((p.k & 7) == 0 && (p.n & 7) == 0 && (((size_t)a | (size_t)b) & 15) == 0) {
      if (pc >= 8) return;
      const int job = wt + 128 * (pc & 3), rk = job >> 3, c = 8 * (job & 7);
      if (pc < 4) {
        const bool ok = row0 + rk < p.m && k0 + c < kend;
        cp_async16((float*)&Ah[rk * TC_LDB + c],
                   (const float*)(ok ? a + (size_t)(row0 + rk) * p.k + k0 + c : a), ok ? 16 : 0);
      } else {
        const bool ok = k0 + rk < kend && col0 + c < p.n;
        cp_async16((float*)&Bh[rk * TC_LDB + c],
                   (const float*)(ok ? b + (size_t)(k0 + rk) * p.n + col0 + c : b), ok ? 16 : 0);
      }
    } else if (pc == 0) {
      uint4 xa[4], xb[4];  // every load issued before any store: one wait on L2
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int job = wt + 128 * j;
        xa[j] = m1_ld8h(a, row0 + (job >> 3), p.m, k0 + 8 * (job & 7), kend, p.k, false);
        xb[j] = m1_ld8h(b, k0 + (job >> 3), kend, col0 + 8 * (job & 7), p.n, p.n, false);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int job = wt + 128 * j, at = (job >> 3) * TC_LDB + 8 * (job & 7);
        *(uint4*)&Ah[at] = xa[j];
        *(uint4*)&Bh[at] = xb[j];
      }
    }
  } else {
    const float* a = (const float*)p.a;
    const float* b = (const float*)p.b;
    float* As = x.buf;
    float* Bs = x.buf + (V == V_TF32 ? 64 * TC_LDA : 64 * 64);
    if (pc < 8) {
      int r, kq;
      if (V == V_TF32) {
        r = (wt + 128 * pc) >> 4;
        kq = wt & 15;
      } else {
        tc_a_piece(wt, pc, r, kq);
      }
      float* dst = As + (V == V_TF32 ? r * TC_LDA + 4 * kq : tc_core<64>(r, kq));
      const int gr = row0 + r, gk = k0 + 4 * kq;
      const float* src = a + (size_t)gr * p.k + gk;
      if ((p.k & 3) == 0 && ((size_t)a & 15) == 0) {
        const bool ok = gr < p.m && gk < kend;
        cp_async16(dst, ok ? src : a, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < p.m && gk + e < kend;
          cp_async4(dst + e, ok ? src + e : a, ok ? 4 : 0);
        }
      }
    } else if (V == V_WGMMA_TF32) {
      int nn, kq;
      tc_b_piece<TN>(wt, pc - 8, nn, kq);
      float* dst = Bs + tc_core<TN>(nn, kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + 4 * kq + e;
        const bool ok = gk < kend && col0 + nn < p.n;
        cp_async4(dst + e, ok ? b + (size_t)gk * p.n + col0 + nn : b, ok ? 4 : 0);
      }
    } else {
      const int kk = (wt + 128 * (pc - 8)) >> 4, c = 4 * (wt & 15);
      float* dst = Bs + kk * TC_LDB + c;
      const int gk = k0 + kk, gc = col0 + c;
      const float* src = b + (size_t)gk * p.n + gc;
      if ((p.n & 3) == 0 && ((size_t)b & 15) == 0) {
        const bool ok = gk < kend && gc < p.n;
        cp_async16(dst, ok ? src : b, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gk < kend && gc + e < p.n;
          cp_async4(dst + e, ok ? src + e : b, ok ? 4 : 0);
        }
      }
    }
  }
}

// All of a thread's copies of chunk x, committed
template <int V, int TN>
__device__ __forceinline__ void tc_stage(const MmArgs& p, const TcChunk& x, int wt) {
#pragma unroll
  for (int pc = 0; pc < 8 + TN / 8; ++pc) tc_stage_piece<V, TN>(p, x, wt, pc);
  cp_async_commit();
}

// wgmma_tf32: the thread's own pieces of the staged chunk (its copies,
// landed) rounded to TF32 in place; A's also into ar (the chain adds c to
// them)
template <int TN>
__device__ __forceinline__ void tc_round(float* buf, int wt, float4 (&ar)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int r, kq;
    tc_a_piece(wt, j, r, kq);
    float4* at = (float4*)(buf + tc_core<64>(r, kq));
    ar[j] = m1_tf32(*at);
    *at = ar[j];
  }
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    int nn, kq;
    tc_b_piece<TN>(wt, j, nn, kq);
    float4* at = (float4*)(buf + 64 * 64 + tc_core<TN>(nn, kq));
    *at = m1_tf32(*at);
  }
}

// wgmma_tf32's chain: the staged A tile plus c, from ar
__device__ __forceinline__ void tc_rewrite_a(float* As, const float4 (&ar)[8], float c, int wt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int r, kq;
    tc_a_piece(wt, j, r, kq);
    *(float4*)&As[tc_core<64>(r, kq)] =
        make_float4(ar[j].x + c, ar[j].y + c, ar[j].z + c, ar[j].w + c);
  }
}

__device__ __forceinline__ unsigned tc_rna_bits(unsigned x) {
  return __float_as_uint(m1_rna(__uint_as_float(x)));
}

// tf32 and bf16: warp (wm, wn) owns rows 32 wm .. and columns 32 wn .. of
// the warpgroup's tile, as 2 x 4 mma tiles; its fragments of the staged
// chunk's nsv instruction k-steps (8 deep for tf32, rounded to TF32 here;
// 16 for bf16) into registers, once a chunk.
template <int V>
__device__ __forceinline__ void tc_frags(const float* buf, int nsv, int wm, int wn, int g, int q,
                                         unsigned (&af)[M3_KS][2][4],
                                         unsigned (&bfr)[M3_KS][4][2]) {
  if constexpr (V == V_TF32) {
    const unsigned* As = (const unsigned*)buf;
    const unsigned* Bs = As + 64 * TC_LDA;
#pragma unroll
    for (int s = 0; s < M3_KS; ++s)
      if (s < nsv) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            af[s][mt][i] = tc_rna_bits(
                As[(32 * wm + 16 * mt + g + 8 * (i & 1)) * TC_LDA + 8 * s + q + 4 * (i >> 1)]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bfr[s][nt][j] = tc_rna_bits(Bs[(8 * s + q + 4 * j) * TC_LDB + 32 * wn + 8 * nt + g]);
      }
  } else if constexpr (V == V_BF16) {
    const unsigned* A32 = (const unsigned*)buf;  // rows of TC_LDB / 2 words
    const unsigned short* Bh = (const unsigned short*)buf + 64 * TC_LDB;
#pragma unroll
    for (int s = 0; s < M3_KS / 2; ++s)
      if (s < nsv) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            af[s][mt][i] = A32[(32 * wm + 16 * mt + g + 8 * (i & 1)) * (TC_LDB / 2) + 8 * s + q +
                               4 * (i >> 1)];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = 16 * s + 2 * q + 8 * j, n = 32 * wn + 8 * nt + g;
            bfr[s][nt][j] = (unsigned)Bh[kk * TC_LDB + n] | (unsigned)Bh[(kk + 1) * TC_LDB + n] << 16;
          }
      }
  }
}

// u += (A + c) B over the staged chunk's ns k-steps (of 8); c is 0 unless
// CARRY. tf32, bf16: u[4 (4 mt + nt) + i], the mma's C fragment of tile
// (mt, nt), from the fragments in registers. wgmma_tf32: one wgmma group
// on buf, waited for.
template <int V, bool CARRY, int TN>
__device__ __forceinline__ void tc_product(float (&u)[TN / 2], const float* buf, int ns, float c,
                                           const unsigned (&af)[M3_KS][2][4],
                                           const unsigned (&bfr)[M3_KS][4][2]) {
  if constexpr (V == V_WGMMA_TF32) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < M3_KS; ++s)
      if (s < ns)  // a k-step: 2 core matrices along K, 8 (A) or TN / 8 (B) row groups each
        tc_wgmma_ss(u, wgmma_desc(buf + s * 2 * 8 * 32, 8 * 128, 128),
                    wgmma_desc(buf + 64 * 64 + s * 2 * (TN / 8) * 32, (TN / 8) * 128, 128));
    wgmma_commit();
    m3_wait<0>();
    tc_fence_operand(u);
  } else {
    constexpr int NSV = V == V_BF16 ? M3_KS / 2 : M3_KS;
    const int nsv = V == V_BF16 ? (ns + 1) >> 1 : ns;
#pragma unroll
    for (int s = 0; s < NSV; ++s)
      if (s < nsv) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[mt][i] = !CARRY ? af[s][mt][i]
                       : V == V_BF16 ? bf16x2_plus(af[s][mt][i], c)
                                     : __float_as_uint(__uint_as_float(af[s][mt][i]) + c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float* u4 = u + 4 * (4 * mt + nt);
            float acc[4] = {u4[0], u4[1], u4[2], u4[3]};
            if (V == V_BF16)
              mma_bf16(acc, a[mt], bfr[s][nt]);
            else
              mma_tf32(acc, a[mt], bfr[s][nt]);
            u4[0] = acc[0]; u4[1] = acc[1]; u4[2] = acc[2]; u4[3] = acc[3];
          }
      }
  }
}

// The rate contract's REP products of one staged chunk, u from 0: u = 0.5 u
// + A B a product (the weights 1 + s i are applied once, at the store)
template <int V, int TN>
__device__ __forceinline__ void tc_rate_chunk(float (&u)[TN / 2], const float* buf, int ns,
                                              int rep, const unsigned (&af)[M3_KS][2][4],
                                              const unsigned (&bfr)[M3_KS][4][2]) {
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) u[e] = 0.0f;
  for (int it = 0; it < rep; ++it) {
    mm_scale(u, 0.5f);
    tc_product<V, false, TN>(u, buf, ns, 0.0f, af, bfr);
  }
}

// u[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 q + e of the tile
// (wgmma); tile (mt, nt) = (j / 4, j % 4) of warp (wm, wn) (mma)
template <int V, int TN>
__device__ __forceinline__ void tc_store(const MmArgs& p, const float (&u)[TN / 2], float* out,
                                         int row0, int col0, int warp, int g, int q) {
  const bool pairs = (p.n & 1) == 0 && ((size_t)p.out & 7) == 0;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + g + 8 * hr +
                    (V == V_WGMMA_TF32 ? 16 * warp : 32 * (warp & 1) + 16 * (j >> 2));
      const int cc = col0 + 2 * q + (V == V_WGMMA_TF32 ? 8 * j : 32 * (warp >> 1) + 8 * (j & 3));
      if (r >= p.m || cc >= p.n) continue;
      float* o = out + (size_t)r * p.n + cc;
      if (pairs) {
        *(float2*)o = make_float2(u[4 * j + 2 * hr], u[4 * j + 2 * hr + 1]);
      } else {
        o[0] = u[4 * j + 2 * hr];
        if (cc + 1 < p.n) o[1] = u[4 * j + 2 * hr + 1];
      }
    }
}

// CTA (tile, copy), tile = blockIdx.x, copy = blockIdx.y. Warpgroup wg
// computes rows row0 .. row0 + 64 and columns col0 .. col0 + TN of the
// CTA's tile over its k-steps s_lo .. s_hi (mm_plan: mw 2, the tile's two
// row halves, every k-step, a warpgroup whose rows start past m returning;
// ks 2, the tile's one row block, half the k-steps each, warpgroup 1's
// sums added into warpgroup 0's; mw 1 and ks 1, one warpgroup a CTA). Its
// stagings form a stream of events: its nch chunks (the rate contract, and
// the chain at k <= 64, whose one chunk serves the REP products), or REP x
// nch (the chain at k > 64: each product restages its chunks). An event's
// chunk lies in one of two buffers (one at TN 128, where nch is 1); the
// next event's is copied into the other while it runs.
template <int V, bool CARRY, int TN>
__global__ void __launch_bounds__(M3_NT, 1) probe_mm_tc_kernel(MmArgs p) {
  constexpr int NA = TN / 2, BUF = tc_buf<V, TN>();
  extern __shared__ __align__(128) float tc_sm[];
  __shared__ float carry[2][2];
  // wg through a shuffle, as in probe_mm3x_kernel: no wgmma on a path ptxas
  // must assume divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, q = lane & 3;
  const int tiles_n = (p.n + TN - 1) / TN;
  const int tm = blockIdx.x / tiles_n, col0 = (blockIdx.x - tm * tiles_n) * TN;
  const int row0 = tm * 64 * p.mw + (p.mw == 2 ? 64 * wg : 0);
  const int nks = (p.k + 7) >> 3, per = (nks + p.ks - 1) / p.ks;
  const int s_lo = p.ks == 2 ? wg * per : 0, s_hi = min(nks, s_lo + per);
  if (p.ks == 1 && row0 >= p.m) return;  // no block-wide barrier follows with ks 1
  const int nch = (s_hi - s_lo + M3_KS - 1) / M3_KS;  // chunks
  const bool restage = CARRY && nch > 1;
  const int evs = restage ? p.rep * nch : nch;  // events
  float* bufs = tc_sm + wg * tc_wg_floats<V, TN>();
  float* tot = bufs + 2 * BUF;  // TN 64
  // event ev's chunk into buffer b
  auto chunk = [&](int ev, int b) {
    const int s0 = s_lo + M3_KS * (ev % nch);
    return TcChunk{bufs + b * BUF, row0, col0, 8 * s0, min(p.k, 8 * min(s0 + M3_KS, s_hi))};
  };
  float u[NA];
  float4 ar[8];
  unsigned af[M3_KS][2][4], bfr[M3_KS][4][2];
  float cv = 0.0f;  // the chain's carry of the current product
  if (evs > 0) tc_stage<V, TN>(p, chunk(0, 0), wt);
#pragma unroll
  for (int i = 0; i < NA; ++i) u[i] = 0.0f;
  for (int ev = 0; ev < evs; ++ev) {
    float* buf = bufs + (TN == 64 ? ev & 1 : 0) * BUF;
    cp_async_wait(0);
    if (V == V_WGMMA_TF32) {
      tc_round<TN>(buf, wt, ar);
      fence_async_shared();
    }
    m3_wg_sync(wg);  // the chunk is staged; the warpgroup is done with the other buffer
    if (ev + 1 < evs) tc_stage<V, TN>(p, chunk(ev + 1, (ev + 1) & 1), wt);
    const int c = ev % nch, ns = min(M3_KS, s_hi - s_lo - M3_KS * c);
    tc_frags<V>(buf, V == V_BF16 ? (ns + 1) >> 1 : ns, warp & 1, warp >> 1, g, q, af, bfr);
    if (!CARRY) {
      // the chunk's REP products, the chunks' sums in tot (each thread its
      // own slots)
      tc_rate_chunk<V, TN>(u, buf, ns, p.rep, af, bfr);
      if (nch > 1) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const float sum = (c == 0 ? 0.0f : tot[i * 128 + wt]) + u[i];
          tot[i * 128 + wt] = sum;
          u[i] = sum;
        }
      }
    } else {
      // the carried chain: product i needs all of product i - 1; with one
      // chunk the event runs all REP products, else product ev / nch's
      // chunk c
      const int it0 = restage ? ev / nch : 0, it1 = restage ? it0 + 1 : p.rep;
      for (int it = it0; it < it1; ++it) {
        // at a product's first chunk: acc = 0.5 acc, c of the tile's first
        // entry (both 0 at it 0, where acc is); the barrier and the
        // multiply unconditional, so that no path defines wgmma's
        // accumulators
        if (wt == 0 && c == 0) carry[wg][it & 1] = u[0];
        m3_wg_sync(wg);
        if (c == 0) cv = carry[wg][it & 1] * 1e-20f;
        mm_scale(u, c == 0 ? 0.5f : 1.0f);
        if (V == V_WGMMA_TF32) {
          tc_rewrite_a(buf, ar, cv, wt);
          fence_async_shared();
          m3_wg_sync(wg);
        }
        tc_product<V, true, TN>(u, buf, ns, cv, af, bfr);
      }
    }
  }
  // ks 2 adds warpgroup 1's sums into warpgroup 0's, which stores
  if (p.ks == 2) {
    float* half1 = tc_sm + 2 * tc_wg_floats<V, TN>();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < NA; ++i) half1[i * 128 + wt] = u[i];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < NA; ++i) u[i] += half1[i * 128 + wt];
  }
  if (!CARRY) mm_scale(u, mm_weight(__ldg(p.s), p.rep));
  tc_store<V, TN>(p, u, p.out + (size_t)blockIdx.y * p.m * p.n, row0, col0, warp, g, q);
}

// The plan's arrangements: mw 2 and ks 1, or mw 1 and ks 2 (not with the
// carry, and at least 2 k-steps), or (not the 3xTF32 kernel, `single`) one
// warpgroup a CTA
static bool plan_ok(const MmArgs& p, bool carry, bool single) {
  return ((p.mw == 2 && p.ks == 1) || (p.mw == 1 && p.ks == 2 && !carry && (p.k + 7) / 8 >= 2) ||
          (single && p.mw == 1 && p.ks == 1)) &&
         p.copies <= 65535;
}

static int smem_limit3[2][2][MAX_DEVICES];
static int smem_limit_ffma[2][2][MAX_DEVICES];
static int smem_limit_tc[2][6][2][MAX_DEVICES];

// The 3xTF32 kernel with the host's plan.
template <bool PRESPLIT, bool CARRY>
static int launch3x(const MmArgs& p, void* stream) {
  if (!plan_ok(p, CARRY, false)) return (int)cudaErrorInvalidValue;
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

// ffma with the host's plan: a CTA a tile and copy, 64-row tiles a
// warpgroup, or 32-row ones (one warpgroup a CTA).
template <bool CARRY, int TR>
static int launch_ffma(const MmArgs& p, void* stream) {
  if (!plan_ok(p, CARRY, true) || (TR == 4 && p.mw * p.ks != 1)) return (int)cudaErrorInvalidValue;
  const int wgs = p.mw * p.ks;  // warpgroups a CTA
  const size_t smem = sizeof(float) * MF_WG_FLOATS * wgs;
  cudaError_t err = raise_smem_limit((const void*)probe_mm_ffma_kernel<CARRY, TR>,
                                     sizeof(float) * MF_WG_FLOATS * 2,
                                     smem_limit_ffma[CARRY][TR / 8]);
  if (err != cudaSuccess) return (int)err;
  const int ctas = ((p.m + 8 * TR * p.mw - 1) / (8 * TR * p.mw)) * ((p.n + 63) / 64);
  if (ctas > 0 && p.copies > 0)
    probe_mm_ffma_kernel<CARRY, TR>
        <<<dim3(ctas, p.copies), 128 * wgs, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// tf32, wgmma_tf32 and bf16 with the host's plan: a CTA a tile and copy
// of two warpgroups (mw 2 or ks 2) or one (mw 1, ks 1); TN 128 only where
// each warpgroup's k-steps are one chunk.
template <int V, bool CARRY, int TN>
static int launch_tc(const MmArgs& p, void* stream) {
  const int nks = (p.k + 7) / 8;
  if (!plan_ok(p, CARRY, true) || (TN == 128 && (nks + p.ks - 1) / p.ks > M3_KS))
    return (int)cudaErrorInvalidValue;
  const int wgs = p.mw * p.ks;  // warpgroups a CTA
  const size_t smem = sizeof(float) * tc_floats<V, TN>(wgs, p.ks);
  cudaError_t err = raise_smem_limit((const void*)probe_mm_tc_kernel<V, CARRY, TN>,
                                     sizeof(float) * tc_floats<V, TN>(2, 2),
                                     smem_limit_tc[CARRY][V][TN / 128]);
  if (err != cudaSuccess) return (int)err;
  const int ctas = ((p.m + 64 * p.mw - 1) / (64 * p.mw)) * ((p.n + TN - 1) / TN);
  if (ctas > 0 && p.copies > 0)
    probe_mm_tc_kernel<V, CARRY, TN>
        <<<dim3(ctas, p.copies), 128 * wgs, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool CARRY>
static int launch_variant(int variant, const MmArgs& p, void* stream) {
  if ((p.rows != 64 && !(variant == V_FFMA && p.rows == 32)) ||
      (p.bn != 64 && !(variant == V_WGMMA_TF32 && p.bn == 128)))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case V_FFMA:
      return p.rows == 32 ? launch_ffma<CARRY, 4>(p, stream) : launch_ffma<CARRY, 8>(p, stream);
    case V_TF32: return launch_tc<V_TF32, CARRY, 64>(p, stream);
    case V_3XTF32: return launch3x<false, CARRY>(p, stream);
    case V_3XTF32_PRESPLIT: return launch3x<true, CARRY>(p, stream);
    case V_WGMMA_TF32:
      return p.bn == 128 ? launch_tc<V_WGMMA_TF32, CARRY, 128>(p, stream)
                         : launch_tc<V_WGMMA_TF32, CARRY, 64>(p, stream);
    case V_BF16: return launch_tc<V_BF16, CARRY, 64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches variant `variant` (0 ffma, 1 tf32, 2 3xtf32, 3 3xtf32_presplit, 4
// wgmma_tf32, 5 bf16: a and b bf16) of the REP product, with the carry of
// r2_pallas_fma when `carry`, on the plan's mw and ks (ffma on its kernel,
// 3xtf32 and 3xtf32_presplit on the 3xTF32 kernel, the others on the
// tensor-core kernel). Returns cudaGetLastError() after the launch.
extern "C" int probe_mm_launch(int variant, int carry, MmArgs p, void* stream) {
  return carry ? launch_variant<true>(variant, p, stream) : launch_variant<false>(variant, p, stream);
}
