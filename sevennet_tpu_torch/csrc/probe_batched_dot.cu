// Batched small products probe: per atom i and path group g, Y_g[i] =
// S_g[i] (d3, K d1) @ XW_g[i] (K d1, mul), fp32 at fp32 accuracy.
//
// Replaces the Pallas TPU probe scripts_dev/r4_batched_dot_probe.py:
// make_pallas (pallas_call at :95): the MXU form of SevenNet-0's forward uvu
// product at K 72, three path groups (d3, K d1, mul) = (9, 72, 128), (20,
// 216, 64), (22, 360, 32), N = 10,016 atoms, HIGHEST precision. The TPU
// kernel takes blocks of A atoms per grid step; here a persistent CTA per
// SM walks (atom, group) items.
//
// What bounds it on an H100: HBM. The function reads S and XW once and
// writes Y once, about 2.03 GB for 12.3 GFLOP (6 operations a byte), 0.605
// ms at 3.35 TB/s, far below the 3xTF32 tensor cores' rate per byte. The
// first design (two item-sized buffers, a block-wide barrier an item, eight
// warps on mma.sync (16-row, 8-column) tiles, each fragment loaded by
// scalar loads and split again for every tile) took 1.445 ms, its product
// on staged tiles alone 0.961 (rep 4 against rep 1; chip_smoke.py
// --bd-probe, H100, 700 W). What bd_breakdown.py measured on the way here:
// 3xTF32 on mma.sync stays about 0.65-0.69 ms a product however its
// fragments are fed (mma.sync's TF32 rate on this card is about 80 TFLOP/s,
// probes/mm_rate.py's tf32 variant); copies by cp.async from one warp
// streamed at 2.25 TB/s; one consuming warpgroup's chain of waits,
// barriers, loads and products per chunk is latency-bound, so the product
// needs several warpgroups at once. This design takes 0.762 ms (probe_ab.py,
// the first design 1.432-1.446 in turns on the same card), its stream alone
// 0.711 and its products alone 0.697 (bd_breakdown.py's knock-outs), 0.50
// ms a product on staged tiles:
//   - Persistent, one CTA an SM, four warpgroups, each with its own items
//     (item j of the CTA to warpgroup j mod 4, from its first chunk to Y:
//     no sums pass between them) and its own share of a ring of `ns`
//     stages (2 each): its thread 0 streams the items as chunks of `ch` =
//     40 contraction rows (at most 22 KB: group 0 is a chunk of 40 and one
//     of 32 rows, group 1 five of 40 and one of 16, group 2 nine of 40) by
//     TMA (cp.async.bulk.tensor), completion counted on each stage's `full`
//     mbarrier, and refills a stage with the chunk ns / 4 on as soon as the
//     warpgroup has read it (one named barrier a chunk). XW arrives
//     in boxes of 32 columns (128 bytes) x ch rows with the 128-byte
//     swizzle, which the fragment loads undo, so that a stage needs no pad;
//     S as one box of ch columns x d3 rows. (A producer warp of its own
//     beside two warpgroups put 3 warps on one SM sub-partition and capped
//     the registers at 168: ptxas spilled and serialized the wgmma. Here
//     16 warps use 106 registers of their 128.)
//   - The product as out^T: Y^T (mul x d3) = XW^T (mul x K d1) S^T, on
//     3xTF32 wgmma m64nNk8 (lo hi + hi lo + hi hi, fused_conv_common.cuh's
//     split), M the mul columns in m64 tiles (1 or 2), N = d3 rounded up to
//     n8 tiles (NT8). A (XW^T) from registers, each lane's fragments loaded
//     from the staged boxes and split once; B (S^T) a K-major tile in
//     shared memory, which TF32 wgmma requires, so the warpgroup first
//     writes the chunk's S columns split into hi and lo core matrices (8 n x
//     4 k, no swizzle), as csrc/pg_reduce.cu does. The contraction index is
//     permuted inside each k8 step (fragment k t <-> row 2t, t + 4 <-> row
//     2t + 1, the same in B's core matrices) and rows 16 w + g, + 8 of m64
//     tile u are XW columns 64 u + 16 w + 2g, + 1, so that a lane's A
//     fragments of a step are two 8-byte loads and its Y two 8-byte stores.
//     Each chunk's products go to a fresh accumulator (the tensor cores add
//     with truncation), added to an fp32 sum; a chunk runs 5 k8 steps
//     whatever its rows (a step past them has zero A and B), in two
//     batches whose A registers are their own (106 registers, no spills).
// `rep` > 1 repeats each chunk's product (B's split, A's loads and split,
// the wgmma) into the fresh accumulator (the output does not change), which
// times the product on staged tiles apart from the stream.
#include <cuda.h>

#include "fused_conv_common.cuh"

#define BD_GROUPS 3
#define BD_CWG 4                      // warpgroups
#define BD_NT (128 * BD_CWG)
#define BD_NSMAX 8                    // stages at most
#define BD_NT8 3                      // n8 tiles of d3 at most (d3 <= 24)
#define BD_MT 2                       // m64 tiles of mul at most (mul <= 128)
#define BD_KS 5                       // k8 steps a chunk (ch = 40)
#define BD_CB 32                      // XW columns a TMA box: the 128-byte swizzle's span
#define BD_ALIGN 1024                 // bytes: the 128-byte swizzle's atom, a stage's alignment
// A measurement build (bd_breakdown.py) knocks a phase out: 1 the products
// (the consumers wait for each stage, release it and write zero sums), 2 the
// copies (the producer arrives on `full` without copying: the products run
// on whatever the stages hold), 3 two of 3xTF32's three products (hi hi
// alone). The wrappers never load such a build.
#ifndef BD_KO
#define BD_KO 0
#endif

struct BdGroup {
  const float* S;   // (N, d3, kk)
  const float* XW;  // (N, kk, mul)
  float* Y;         // (N, d3, mul)
  int d3, kk, mul;
};

// the host's plan (probes/batched_dot.py:bd_plan): contraction rows a chunk,
// stages in the ring, floats a stage, floats of a warpgroup's B tiles
struct BdArgs {
  BdGroup g[BD_GROUPS];
  int N, rep;
  int ch, ns, stage, bbuf;
};

// the kernel's parameters: BdArgs with each group's XW and S as tensor maps
struct BdTma {
  CUtensorMap txw[BD_GROUPS];  // XW as (mul, N kk) fp32, boxes (32, ch), 128-byte swizzle
  CUtensorMap ts[BD_GROUPS];   // S as (kk, N d3) fp32, boxes (ch, d3)
  BdArgs a;
};

// group gi of the args by selects on constant indices (no local copy)
__device__ __forceinline__ BdGroup group(const BdArgs& p, int gi) {
  return gi == 0 ? p.g[0] : (gi == 1 ? p.g[1] : p.g[2]);
}

__device__ __forceinline__ unsigned bd_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bd_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bd_smem(bar)), "r"(count)
               : "memory");
}

// waits until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void bd_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(bd_smem(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bd_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bd_smem(bar)) : "memory");
}

__device__ __forceinline__ void bd_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bd_smem(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box of map at (c0, c1) into dst, completion on bar
__device__ __forceinline__ void bd_tma2(void* dst, const CUtensorMap* map, int c0, int c1,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(bd_smem(dst)),
      "l"((unsigned long long)map), "r"(bd_smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// named barrier 1 + w: the threads of consumer warpgroup w
__device__ __forceinline__ void bd_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (between core matrices adjacent in K) and stride byte
// offset (between 8-row groups of N), in 16-byte units (pg_reduce.cu's).
__device__ __forceinline__ unsigned long long bd_desc(const float* smem, int lbo, int sbo) {
  const unsigned addr = bd_smem(smem);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 8 NT8) (+)= a (64 x 8, registers) b (8 x 8 NT8, K-major in shared
// memory), TF32 in, fp32 out: warp w of the warpgroup holds rows 16 w + g,
// + 8 of a as mma.sync's m16n8k8 A fragment, and of d, n8 group j at
// d[4j .. 4j + 3] (columns 8j + 2t, + 1; rows g, g + 8).
template <int NT8>
__device__ __forceinline__ void bd_wgmma(float (&d)[4 * NT8], const unsigned (&a)[4],
                                         unsigned long long b, int accumulate);

template <>
__device__ __forceinline__ void bd_wgmma<1>(float (&d)[4], const unsigned (&a)[4],
                                            unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void bd_wgmma<2>(float (&d)[8], const unsigned (&a)[4],
                                            unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void bd_wgmma<3>(float (&d)[12], const unsigned (&a)[4],
                                            unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void bd_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void bd_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void bd_wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The chunks of a warpgroup's items in order: item j of the CTA (atom
// blockIdx.x + (j / 3) gridDim.x, group j % 3) belongs to warpgroup j %
// BD_CWG.
struct BdCursor {
  int i, gi, k0;  // atom, group, first contraction row; i >= N: past the last
};

__device__ __forceinline__ BdCursor bd_first(const BdArgs& p, int wg) {
  BdCursor c{(int)blockIdx.x, wg, 0};
  while (c.gi >= BD_GROUPS) {
    c.gi -= BD_GROUPS;
    c.i += gridDim.x;
  }
  return c;
}

__device__ __forceinline__ void bd_advance(const BdArgs& p, BdCursor& c) {
  c.k0 += p.ch;
  if (c.k0 < group(p, c.gi).kk) return;
  c.k0 = 0;
  c.gi += BD_CWG;  // the warpgroup's next item: BD_CWG items on
  while (c.gi >= BD_GROUPS) {
    c.gi -= BD_GROUPS;
    c.i += gridDim.x;
  }
}

// Thread wt == 0 of the warpgroup: the TMA boxes of chunk c into stage st,
// completion on bar (without copies in a measurement build without them).
__device__ __forceinline__ void bd_issue(const BdTma& m, const BdCursor& c, float* st,
                                         unsigned long long* bar) {
  const BdArgs& p = m.a;
  const BdGroup G = group(p, c.gi);
  // a tensor map's address by constant indices (a parameter's, not a local copy's)
  const CUtensorMap* txw = c.gi == 0 ? &m.txw[0] : (c.gi == 1 ? &m.txw[1] : &m.txw[2]);
  const CUtensorMap* ts = c.gi == 0 ? &m.ts[0] : (c.gi == 1 ? &m.ts[1] : &m.ts[2]);
  const int ncb = (G.mul + BD_CB - 1) / BD_CB;
#if BD_KO != 2
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bd_expect_tx(bar, 4u * p.ch * (ncb * BD_CB + G.d3));
  for (int b = 0; b < ncb; ++b)
    bd_tma2(st + b * BD_CB * p.ch, txw, b * BD_CB, c.i * G.kk + c.k0, bar);
  bd_tma2(st + ncb * BD_CB * p.ch, ts, c.k0, c.i * G.d3, bar);
#else
  (void)txw, (void)ts, (void)st, (void)ncb;
  bd_arrive(bar);
#endif
}

// A batch of BD_KB k8 steps' A fragments (XW^T rows 16 wq + g, + 8 of an
// m64 tile: XW columns c, c + 1; rows 8s + 2tq, + 1 of the chunk) from the
// swizzled box at xb (its 16-byte piece q of row r at q ^ (r % 8)), split
// into TF32 hi and lo; zero past the chunk's nst steps or the box count.
#define BD_KB 3
__device__ __forceinline__ void bd_load_a(const float* xb, bool ok, int piece, int half, int tq,
                                          int s0, int nst, unsigned (&h)[BD_KB][4],
                                          unsigned (&l)[BD_KB][4]) {
#pragma unroll
  for (int q = 0; q < BD_KB; ++q) {
    const int s = s0 + q, r = 8 * s + 2 * tq;
    float2 v0 = make_float2(0.f, 0.f), v1 = v0;
    if (ok && s < nst) {
      v0 = *(const float2*)(xb + r * BD_CB + ((piece ^ (r & 7)) << 2) + half);
      v1 = *(const float2*)(xb + (r + 1) * BD_CB + ((piece ^ ((r + 1) & 7)) << 2) + half);
    }
    const float a[4] = {v0.x, v0.y, v1.x, v1.y};
    split4(a, h[q], l[q]);
  }
}

// the batch's 3xTF32 products into acc (the chunk's first zeroes it), one
// wgmma group
template <int NT8>
__device__ __forceinline__ void bd_mma_batch(float (&acc)[4 * NT8], const unsigned (&h)[BD_KB][4],
                                             const unsigned (&l)[BD_KB][4], const float* bb,
                                             int s0) {
  constexpr int BQ = 128 * NT8;
  bd_wgmma_fence();
#pragma unroll
  for (int q = 0; q < BD_KB; ++q) {
    const int s = s0 + q;
    if (s < BD_KS) {
      const unsigned long long dh = bd_desc(bb + s * BQ, NT8 * 128, 128);
#if BD_KO != 3
      const unsigned long long dl = bd_desc(bb + s * BQ + 64 * NT8, NT8 * 128, 128);
      bd_wgmma<NT8>(acc, l[q], dh, s > 0);
      bd_wgmma<NT8>(acc, h[q], dl, 1);
      bd_wgmma<NT8>(acc, h[q], dh, 1);
#else
      bd_wgmma<NT8>(acc, h[q], dh, s > 0);
#endif
    }
  }
  bd_wgmma_commit();
}

// A measurement build with -DBD_PROF has each warpgroup's thread 0 add
// clock64() cycles into bd_prof[warpgroup]: waiting for a stage, B's split,
// A and the products, the refill (its barrier and the copies' issue), Y
// (bd_breakdown.py reads and clears them through batched_dot_prof).
#ifdef BD_PROF
__device__ unsigned long long bd_prof[BD_CWG][5];
#define BD_MARK(k)                                                      \
  do {                                                                  \
    const long long now = clock64();                                    \
    if (wt == 0) atomicAdd(&bd_prof[wg][k], (unsigned long long)(now - clk)); \
    clk = now;                                                          \
  } while (0)
#else
#define BD_MARK(k) \
  do {             \
  } while (0)
#endif

// One (atom i, group G) item of warpgroup wg (thread wt of 128, its warp
// wq, lane (g, tq)): every chunk of the item from the warpgroup's ring
// (nsw stages from `ring`, chunk counter t); per chunk B's split, then for
// each m64 tile of mul in turn its products into a fresh accumulator, in
// two batches of steps with A registers of their own (the second batch's
// loads and split run while the first multiplies), added to the tile's sums; after the chunk, the stage refilled with the chunk nsw
// on (cursor pc); then Y. NT8 n8 tiles of d3.
template <int NT8>
__device__ __forceinline__ void bd_item(const BdTma& m, const BdGroup& G, int i, int& t,
                                        BdCursor& pc, float* ring, int nsw, float* bb,
                                        unsigned long long* full, int wg, int wt) {
  constexpr int NA = 4 * NT8, N8 = 8 * NT8, BQ = 128 * NT8;  // B floats a step (hi, lo)
  const BdArgs& p = m.a;
  const int lane = wt & 31, wq = wt >> 5, g = lane >> 2, tq = lane & 3;
  const int ch = p.ch, ncb = (G.mul + BD_CB - 1) / BD_CB, mt = (G.mul + 63) >> 6;
  float sum[BD_MT][NA];
#pragma unroll
  for (int u = 0; u < BD_MT; ++u)
#pragma unroll
    for (int e = 0; e < NA; ++e) sum[u][e] = 0.0f;
#ifdef BD_PROF
  long long clk = clock64();
#endif
  for (int k0 = 0; k0 < G.kk; k0 += ch, ++t) {
    const int slot = t % nsw, nst = min(ch, G.kk - k0) >> 3;
    bd_wait(&full[slot], (t / nsw) & 1);
    BD_MARK(0);
    float* Xs = ring + slot * p.stage;
    const float* Ss = Xs + ncb * BD_CB * ch;
#if BD_KO != 1
    for (int rr = 0; rr < p.rep; ++rr) {
      bd_wg_sync(wg);  // the last products' reads of B are done
      // B of step s: S^T's 8 rows (k) x N8 columns (d3), split, as core
      // matrices (kg, n / 8) of 8 n x 4 k at 32 (kg NT8 + n / 8) + 4 (n % 8)
      // floats, hi then lo; core k position 4 kg + e holds row 2e + kg
      for (int job = wt; job < BD_KS * 2 * N8; job += 128) {
        const int s = job / (2 * N8), kg = (job / N8) & 1, n = job % N8;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (s < nst && n < G.d3) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = Ss[n * ch + 8 * s + kg + 2 * e];
        }
        unsigned h[4], l[4];
        split4(v, h, l);
        float* at = bb + s * BQ + (kg * NT8 + (n >> 3)) * 32 + (n & 7) * 4;
        *(uint4*)at = make_uint4(h[0], h[1], h[2], h[3]);
        *(uint4*)(at + 64 * NT8) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bd_wg_sync(wg);
      BD_MARK(1);
#pragma unroll
      for (int u = 0; u < BD_MT; ++u) {
        if (u < mt) {
          const int c = 64 * u + 16 * wq + 2 * g, box = c / BD_CB;
          const int piece = (c % BD_CB) >> 2, half = c & 2;
          const float* xb = Xs + box * BD_CB * ch;
          const bool ok = box < ncb;
          float acc[NA];
          unsigned h0[BD_KB][4], l0[BD_KB][4], h1[BD_KB][4], l1[BD_KB][4];
          static_assert(BD_KS <= 2 * BD_KB, "two batches a chunk");
          bd_load_a(xb, ok, piece, half, tq, 0, nst, h0, l0);
          bd_mma_batch<NT8>(acc, h0, l0, bb, 0);
          bd_load_a(xb, ok, piece, half, tq, BD_KB, nst, h1, l1);
          bd_mma_batch<NT8>(acc, h1, l1, bb, BD_KB);
          bd_wgmma_wait0();
          if (rr == p.rep - 1) {
#pragma unroll
            for (int e = 0; e < NA; ++e) sum[u][e] += acc[e];
          }
        }
      }
      BD_MARK(2);
    }
#endif
    // the stage is read: refill it with the chunk nsw on
    bd_wg_sync(wg);
    if (wt == 0 && pc.i < p.N) bd_issue(m, pc, Xs, &full[slot]);
    bd_advance(p, pc);
    BD_MARK(3);
  }
  // Y: D row 16 wq + g + 8h of tile u is column c + h, D column 8j + 2tq (+ 1) row n (+ 1)
  float* Y = G.Y + (size_t)i * G.d3 * G.mul;
#pragma unroll
  for (int u = 0; u < BD_MT; ++u) {
    const int c = 64 * u + 16 * wq + 2 * g;
    if (c < G.mul) {
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = 8 * j + 2 * tq;
        if (n < G.d3)
          *(float2*)(Y + (size_t)n * G.mul + c) = make_float2(sum[u][4 * j], sum[u][4 * j + 2]);
        if (n + 1 < G.d3)
          *(float2*)(Y + (size_t)(n + 1) * G.mul + c) =
              make_float2(sum[u][4 * j + 1], sum[u][4 * j + 3]);
      }
    }
  }
  BD_MARK(4);
}

// Two warpgroups, each with its half of the ring: warpgroup wg streams its
// own items' chunks (bd_advance) into its stages and computes them; its
// thread 0 issues every copy, first its first nsw chunks, then after each
// chunk the one nsw on into the stage just read.
__global__ void __launch_bounds__(BD_NT, 1) batched_dot_kernel(const __grid_constant__ BdTma m) {
  extern __shared__ __align__(BD_ALIGN) unsigned char bd_raw[];
  const BdArgs& p = m.a;
  float* ring0 = (float*)(bd_raw + ((BD_ALIGN - bd_smem(bd_raw) % BD_ALIGN) % BD_ALIGN));
  float* bbuf = ring0 + p.ns * p.stage;  // each warpgroup's B tiles
  unsigned long long* full0 = (unsigned long long*)(bbuf + BD_CWG * p.bbuf);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2, wt = threadIdx.x & 127, nsw = p.ns / BD_CWG;
  float* ring = ring0 + wg * nsw * p.stage;
  unsigned long long* full = full0 + wg * nsw;
  float* bb = bbuf + wg * p.bbuf;
  if (wt == 0)
    for (int s = 0; s < nsw; ++s) bd_mbar_init(&full[s], 1);
  __syncthreads();
  BdCursor pc = bd_first(p, wg);  // the next chunk to copy
  for (int s = 0; s < nsw; ++s) {
    if (wt == 0 && pc.i < p.N) bd_issue(m, pc, ring + s * p.stage, &full[s]);
    bd_advance(p, pc);
  }
  int t = 0;
  for (BdCursor c = bd_first(p, wg); c.i < p.N;) {
    const BdGroup G = group(p, c.gi);
    switch ((G.d3 + 7) >> 3) {
      case 1: bd_item<1>(m, G, c.i, t, pc, ring, nsw, bb, full, wg, wt); break;
      case 2: bd_item<2>(m, G, c.i, t, pc, ring, nsw, bb, full, wg, wt); break;
      default: bd_item<3>(m, G, c.i, t, pc, ring, nsw, bb, full, wg, wt); break;
    }
    c.k0 = G.kk;  // past the item's chunks: on to the warpgroup's next item
    bd_advance(p, c);
  }
}

static int smem_limit_bd[MAX_DEVICES];

static size_t bd_smem_bytes(const BdArgs& p) {
  return sizeof(float) * ((size_t)p.ns * p.stage + BD_CWG * p.bbuf) +
         sizeof(unsigned long long) * p.ns + BD_ALIGN;
}

typedef CUresult (*BdEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the runtime
// (no link to libcuda)
static BdEncodeTiled bd_encode_tiled() {
  static BdEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (BdEncodeTiled)ptr;
  }
  return fn;
}

// a 2-d fp32 tensor map of `rows` rows of `cols` floats at ptr, boxes (bc, br)
static bool bd_map(BdEncodeTiled enc, CUtensorMap* map, const float* ptr, int cols, long long rows,
                   int bc, int br, CUtensorMapSwizzle swizzle) {
  const cuuint64_t size[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bc, (cuuint32_t)br}, ones[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptr, size, stride, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// BD_PROF builds: copies bd_prof into out (BD_CWG x 5 values) and clears it.
extern "C" int batched_dot_prof(unsigned long long* out) {
#ifdef BD_PROF
  cudaError_t err = cudaMemcpyFromSymbol(out, bd_prof, sizeof(bd_prof));
  const unsigned long long zero[BD_CWG * 5] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(bd_prof, zero, sizeof(bd_prof));
  return (int)err;
#else
  (void)out;
  return (int)cudaErrorInvalidValue;
#endif
}

// Layout constants the host's plan must follow (probes/batched_dot.py):
// consumer warpgroups, stages at most, n8 tiles and m64 tiles at most, k8
// steps a chunk, XW columns a box, a stage's alignment in bytes.
extern "C" void batched_dot_layout(int* out) {
  const int v[] = {BD_CWG, BD_NSMAX, BD_NT8, BD_MT, BD_KS, BD_CB, BD_ALIGN};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// Launches the batched product: one CTA per SM (at most one per atom), with
// the host's plan (checked here for what the kernel needs: chunks of 8
// BD_KS rows; every group's chunk fits a stage of whole swizzle atoms, its B
// tiles a warpgroup's buffer), S, XW 16-byte aligned (not checked here).
// Returns cudaGetLastError() after the launch.
extern "C" int batched_dot_launch(BdArgs p, void* stream) {
  if (p.rep < 1 || p.ch != 8 * BD_KS || p.ns < 2 * BD_CWG || p.ns > BD_NSMAX || p.ns % BD_CWG ||
      (p.stage * 4) % BD_ALIGN || p.bbuf % 4)
    return (int)cudaErrorInvalidValue;
  BdTma m;
  BdEncodeTiled enc = bd_encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  for (int gi = 0; gi < BD_GROUPS; ++gi) {
    const BdGroup& G = p.g[gi];
    const int nt8 = (G.d3 + 7) / 8, mt = (G.mul + 63) / 64, ncb = (G.mul + BD_CB - 1) / BD_CB;
    if (G.kk < 8 || G.kk % 8 || G.mul < 8 || G.mul % 8 || mt > BD_MT || G.d3 < 1 ||
        nt8 > BD_NT8 || p.ch * (ncb * BD_CB + G.d3) > p.stage || p.bbuf < BD_KS * 128 * nt8 ||
        !bd_map(enc, &m.txw[gi], G.XW, G.mul, (long long)p.N * G.kk, BD_CB, p.ch,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
        !bd_map(enc, &m.ts[gi], G.S, G.kk, (long long)p.N * G.d3, p.ch, G.d3,
                CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  m.a = p;
  const size_t smem = bd_smem_bytes(p);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit((const void*)batched_dot_kernel, smem, smem_limit_bd);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int grid = p.N < sms ? p.N : sms;
  if (grid > 0) batched_dot_kernel<<<grid, BD_NT, smem, (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}
