// Fold-order probe of the emb/sh fused conv forward: the function of B4 fwd
// (radial MLP on emb, tmp = w3j_pack sh, the uvu terms, the sum over each
// receiver's K slots) in three orders of the K sum, the MLP on the tensor
// cores (3xTF32 wgmma), the terms and the sums on the CUDA cores.
//
// Replaces the Pallas TPU probe scripts_dev/r4_fold_probe.py:make (pallas_call
// at :153, kernel :72-141). The variants differ only in the order of the K
// sum of each output column's terms (v[k] = sum over the instruction's (m,
// p, r) of (xg[k, x0 + m mul + u] w[k, w0 + u]) tmp[k, r], terms added in
// the table's order, which is m's):
//   sliceadd  each slot's v[k], then the K values halved in the script's
//             order (_fold_sliceadd, :52-65: halve while the count is even,
//             add the last onto the first while it is odd);
//   group4/8  kg running sums, slot k into sum k mod kg, over the K / kg
//             groups in order, each term added as it comes, then the kg sums
//             halved (:111-140).
// The TPU's k-major rows stay behind: xg (N K, dim_x), emb (N K, n_basis)
// and sh (N K, dim_f) are receiver-major (row i K + k), as B4 fwd reads
// them; out (N, dim_mid) in the grouped mid layout.
//
// Tiling. A CTA is two warpgroups, each on receivers of its own (receiver
// 2 b + wg, then every 2 gridDim on; the grid is what the SMs hold). The MLP
// runs transposed, w^T = W^T h^T: wgmma m64nNPk8 with M = 64 of a layer's
// output columns and N = NP, the receiver's K slots rounded up to 8 (a
// "position" n of N holds one slot), A = W^T from registers (hi and lo TF32
// halves, split once a call by probe_fold_conv_prep_kernel into the
// register order of the A fragment, read from L2, 4 k-steps at a time:
// with all 8 and the accumulator live, ptxas serialized every wgmma,
// C7512), B = the layer's input (emb, or the last hidden layer) as hi and
// lo K-major core matrices in shared memory; lo hi, hi lo, hi hi a k-step.
// Hidden layers (at most 64 wide) take one tile; W3 (hl x numel) takes
// probes/fold_conv.py:plan's tiles: 4 warps x 16 channels of one
// instruction (an instruction of fewer channels padded), the instructions
// grouped by their x block (x stays in L2 between its instructions), row g
// + 8 h of a warp's 16 holding channel u0 + 2 g + h, so that a lane holds w
// of channels u, u + 1 for 2 NP / 8 positions. The accumulator thus leaves,
// in lane (g, q) of the warp, w of its two channels at the positions 8 j +
// 2 q + e: the terms run from there, with no store of w. Per tile, before
// the products, the warpgroup forms the tile's Wigner rows of tmp (its
// "window", rows first to last of its instructions; dense over dim_f, fmaf
// in f's order) into shared memory, laid out [row][position]: a warp reads
// tmp as a broadcast (lanes of one q share a position, four positions in
// four banks).
//
// The terms. A warp's instruction is one of the compiled shapes
// (probe_fold_conv_paths.cuh: d1, d3 and the pairs' mask; a switch over
// the path picks FcTerms<..., D1, D3, MASK>), so that the pairs, their
// Wigner rows (the instruction's first plus the rank in the mask) and the
// lanes' positions are compile-time constants: no table is read inside the
// slot loop. Per position: x of the two channels for every m (8-byte
// loads from L2), x w once per (m, u) (__fmul_rn, the same rounding as the
// script's x w), then each pair's term (x w) tmp (__fmul_rn) added with
// __fadd_rn.
//
// The K sum in registers, each variant in exactly its plain version's
// order. Lane q of the four that share a channel holds K / 4 slots
// (probes/fold_conv.py:lane_slots, the same map):
//   group4: the slots q mod 4, one running sum; the four sums halved
//     across lanes (q with q ^ 2, then q ^ 1: shuffles);
//   group8: the sums q and q + 4, two running sums; halved in the lane,
//     then across lanes as group4;
//   sliceadd: K = c 2^a. The first a halvings sum S_r (r < c) over slots r
//     + c b, b < 2^a, b's top bit first: lane q holds b = q + 4 t, t <
//     2^(a-2), summed as a binary counter over t in bit-reversed order,
//     then b's bits 1 and 0 across lanes (q ^ 2, q ^ 1); the S_r come in the
//     post-order of the odd/even tree over c (sa_top), their sums on a small
//     stack of registers. At K 72: c 9, a 3; a lane holds 18 slots, two of
//     each S_r.
// Every lane ends with the column's sum; lane q = 0 stores it.
//
// Shared memory a warpgroup (SevenNet-0 at K 72: 53,632 B, a CTA 107,264 B,
// 2 CTAs and 16 warps an SM): the last hidden layer's hi and lo (NP x 64 x
// 2 floats), sh ([f][position]) and the tmp window (49 rows), whose room
// emb's hi and lo take before the first tile.
//
// What bounds it (fold_conv_breakdown.py, knock-out builds of
// fold_conv_breakdown.patch; N 10,016, K 72, H100 SXM at 700 W; PERF.md):
// group4 / group8 / sliceadd 5.8 / 6.1 / 7.4 ms against the 0.64 ms bound.
// Without the terms and sums (the MLP's products, the tmp windows, the
// split weights' loads) 1.55 ms; without x's loads 3.3 / 3.7 / 4.1 ms: the
// x loads, one round trip to L2 a position, about 2.5 ms; the rest is the
// terms' issue with 128 registers a thread (240-512 B of stack) and
// sliceadd's shuffles and stack. The terms' x is what a next design would
// stage (cp.async into shared memory, which the carve has no room for at
// 2 CTAs an SM).
#include <type_traits>
#include <utility>

#include "fused_conv_common.cuh"
#include "probe_fold_conv_paths.cuh"

#define FC_NT 256   // two warpgroups
#define FC_MAXL 8   // MLP weight matrices
#define FC_KH 4     // k-steps of A in registers at a time
#define FC_GREC 8   // ints of a warp's record (probes/fold_conv.py GREC)
#define FC_HMAX 64  // widest hidden layer and n_basis (one 64-row wgmma tile)

enum { FC_SLICEADD = 0, FC_GROUP4 = 1, FC_GROUP8 = 2 };

struct FoldConvArgs {
  const float* xg;   // (N K, dim_x)
  const float* emb;  // (N K, n_basis)
  const float* sh;   // (N K, dim_f)
  const float* w3j;  // (R, dim_f)
  // per W3 tile and warp: path (-1: none), x_start, mul, u0, g_start +
  // u_off, u_tot, first Wigner row - the tile's, w_start
  const int* gtab;
  const int* ttab;   // per W3 tile: first Wigner row, rows
  float* frag;       // the split weights, written by the prep kernel
  float* out;        // (N, dim_mid)
  const float* w[FC_MAXL];  // (dims[l], dims[l + 1])
  float inv_sqrt[FC_MAXL];  // 1 / sqrt(dims[l])
  int dims[FC_MAXL + 1];
  // hk: k of the hidden activations (8 ceil(widest hidden / 8)); nbk:
  // emb's (8 ceil(n_basis / 8)); tw_rows: the tmp window's rows
  int nl, N, K, dim_x, dim_f, dim_mid, n_tiles, hk, nbk, tw_rows;
  float act_cst;
};

// ---------------------------------------------------------------------------
// compile-time shape of a variant at K
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int fc_ctz(int k) {
  int a = 0;
  while (k > 0 && !(k & 1)) k >>= 1, ++a;
  return a;
}

__host__ __device__ constexpr int fc_ones(int x) {  // trailing ones
  int n = 0;
  while (x & 1) x >>= 1, ++n;
  return n;
}

__host__ __device__ constexpr int fc_bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

// The top of the sliceadd fold over c values (odd: add the last onto the
// first; even: halve) as a post-order walk of its tree: the values' order,
// the additions that follow each, the stack's size before each is pushed,
// the stack's depth (probes/fold_conv.py:_sa_top).
struct SaTop {
  int order[32], pops[32], sp[32], depth;
};

__host__ __device__ constexpr SaTop sa_top(int c) {
  int lc[64] = {}, rc[64] = {}, cur[32] = {};
  int len = c, nid = c;
  for (int r = 0; r < c; ++r) cur[r] = r;
  while (len > 1) {
    if (len % 2 == 0) {
      const int h = len / 2;
      for (int k = 0; k < h; ++k) lc[nid] = cur[k], rc[nid] = cur[k + h], cur[k] = nid++;
      len = h;
    } else {
      lc[nid] = cur[0], rc[nid] = cur[len - 1], cur[0] = nid++;
      len -= 1;
    }
  }
  SaTop t{};
  int stk[64] = {}, seen[64] = {}, top = 0, n = 0, size = 0;
  stk[top++] = cur[0];
  while (top > 0) {
    const int v = stk[top - 1];
    if (v < c) {
      t.order[n] = v, t.pops[n] = 0, t.sp[n] = size++, ++n, --top;
      t.depth = size > t.depth ? size : t.depth;
    } else if (!seen[v]) {
      seen[v] = 1;
      stk[top++] = rc[v];
      stk[top++] = lc[v];
    } else {
      --top, t.pops[n - 1] += 1, --size;
    }
  }
  return t;
}

template <int V, int K>
struct FcShape {
  static constexpr int NP = (K + 7) / 8 * 8;  // positions (wgmma N)
  static constexpr int PR = K / 4;            // a lane's positions that hold a slot
  static constexpr int A = fc_ctz(K);
  static constexpr int C = K >> A;            // sliceadd: the odd part
  static constexpr int LOGT = A >= 2 ? A - 2 : 0;
  static constexpr int T = 1 << LOGT;         // sliceadd: a lane's leaves of one S_r
  static constexpr int DEPTH = V == FC_SLICEADD ? sa_top(C).depth : 1;
  static_assert(K % 4 == 0 && K <= 128, "K a multiple of 4, at most 128 (32 positions a lane)");
  static_assert(V != FC_GROUP8 || K % 8 == 0, "group8 takes K a multiple of 8");
  static_assert(V != FC_SLICEADD || (A >= 2 && C <= 32), "sliceadd: K = c 2^a, a >= 2");
};

// Lane q's position I holds slot base + mult q (probes/fold_conv.py:lane_slots)
template <int V, int K, int I>
struct FcPos {
  using S = FcShape<V, K>;
  static constexpr int rho = I / S::T, tp = I % S::T;  // sliceadd: which S_r, which leaf
  static constexpr bool slot_held = I < S::PR;
  static constexpr int r = V == FC_SLICEADD && slot_held ? sa_top(S::C).order[rho] : 0;
  static constexpr int base = V == FC_SLICEADD ? r + 4 * S::C * fc_bitrev(tp, S::LOGT)
                              : V == FC_GROUP4 ? 4 * I
                                               : 8 * (I / 2) + 4 * (I % 2);
  static constexpr int mult = V == FC_SLICEADD ? S::C : 1;
  static constexpr int pops = V == FC_SLICEADD && slot_held ? sa_top(S::C).pops[rho] : 0;
  static constexpr int sp = V == FC_SLICEADD && slot_held ? sa_top(S::C).sp[rho] : 0;
};

// f(integral_constant<int, I>) for I = 0 .. N - 1, unrolled at compile time
template <int N, int I = 0, typename F>
__device__ __forceinline__ void fc_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    fc_for<N, I + 1>(static_cast<F&&>(f));
  }
}

// the slot at position n (-1: none), for the loads of emb and sh
template <int V, int K>
__device__ __forceinline__ int fc_slot_at(int n) {
  const int q = (n & 7) >> 1, i = 2 * (n >> 3) + (n & 1);
  int s = -1;
  fc_for<FcShape<V, K>::PR>([&](auto I_) {
    constexpr int I = decltype(I_)::value;
    if (i == I) s = FcPos<V, K, I>::base + FcPos<V, K, I>::mult * q;
  });
  return s;
}

// ---------------------------------------------------------------------------
// wgmma: m64nNPk8 TF32, A from registers, B K-major core matrices in shared
// memory; the accumulator in the mma.sync C layout of each warp's 16 rows,
// 8-column group j at d[4j .. 4j+3] (rows g, g + 8; columns 2q, 2q + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long fc_desc(const float* smem, int lbo, int sbo) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void fc_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void fc_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void fc_fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// named barrier 1 + wg: the 128 threads of warpgroup wg
__device__ __forceinline__ void fc_bar(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }

template <int NP>
__device__ __forceinline__ void fc_wgmma(float (&d)[NP / 2], const unsigned (&a)[4],
                                         unsigned long long b, int accumulate);

template <>
__device__ __forceinline__ void fc_wgmma<24>(float (&d)[12], const unsigned (&a)[4],
                                             unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void fc_wgmma<72>(float (&d)[36], const unsigned (&a)[4],
                                             unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// (position n, k) of a K-major B operand: core matrices of 8 positions x 4 k
// (128 B), the k quad's G = NP / 8 matrices side by side
__host__ __device__ __forceinline__ int fc_core(int n, int k, int G) {
  return ((k >> 2) * G + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3);
}

// A's hi and lo fragments of k-steps s0 .. s0 + FC_KH (of ks) from the
// split weights (the prep kernel's order: 8 floats a thread and k-step, hi
// then lo)
__device__ __forceinline__ void fc_load_a(const float* fr, int s0, int ks, int wt,
                                          unsigned (&ah)[FC_KH][4], unsigned (&al)[FC_KH][4]) {
#pragma unroll
  for (int s = 0; s < FC_KH; ++s)
    if (s0 + s < ks) {
      const float* f = fr + ((size_t)(s0 + s) * 128 + wt) * 8;
      const float4 h = __ldg((const float4*)f), l = __ldg((const float4*)(f + 4));
      ah[s][0] = __float_as_uint(h.x), ah[s][1] = __float_as_uint(h.y);
      ah[s][2] = __float_as_uint(h.z), ah[s][3] = __float_as_uint(h.w);
      al[s][0] = __float_as_uint(l.x), al[s][1] = __float_as_uint(l.y);
      al[s][2] = __float_as_uint(l.z), al[s][3] = __float_as_uint(l.w);
    }
}

// d (+)= A B over k-steps s0 .. s0 + FC_KH (of ks), 3xTF32 (lo hi, hi lo,
// hi hi), B's hi at B and lo NP kdim floats on; d starts afresh at k-step
// 0; one wgmma group, committed, not waited for
template <int NP>
__device__ __forceinline__ void fc_products(float (&d)[NP / 2], const unsigned (&ah)[FC_KH][4],
                                            const unsigned (&al)[FC_KH][4], const float* B,
                                            int kdim, int s0, int ks) {
  constexpr int G = NP / 8;
  fc_fence();
#pragma unroll
  for (int s = 0; s < FC_KH; ++s)
    if (s0 + s < ks) {
      const int k = s0 + s;
      const unsigned long long bh = fc_desc(B + 2 * k * G * 32, G * 128, 128);
      const unsigned long long bl = fc_desc(B + NP * kdim + 2 * k * G * 32, G * 128, 128);
      fc_wgmma<NP>(d, al[s], bh, k > 0 ? 1 : 0);
      fc_wgmma<NP>(d, ah[s], bl, 1);
      fc_wgmma<NP>(d, ah[s], bh, 1);
    }
  fc_commit();
}

// waits for the products; the compiler may not move reads of d before it
template <int NA>
__device__ __forceinline__ void fc_wait(float (&d)[NA]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int e = 0; e < NA; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d = A B over ks k-steps, FC_KH k-steps of A in registers at a time:
// each half's products run pipelined, waited for before the next half's A
// is loaded (with all of A and the accumulator live, ptxas serialized every
// wgmma: C7512)
template <int NP>
__device__ __forceinline__ void fc_matmul(float (&d)[NP / 2], const float* fr, const float* B,
                                          int kdim, int ks, int wt) {
#pragma unroll 1
  for (int s0 = 0; s0 < ks; s0 += FC_KH) {
    unsigned ah[FC_KH][4], al[FC_KH][4];
    fc_load_a(fr, s0, ks, wt, ah, al);
    fc_products<NP>(d, ah, al, B, kdim, s0, ks);
    fc_wait(d);
  }
}

__device__ __forceinline__ float fc_param(const float (&a)[FC_MAXL], int l) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < FC_MAXL; ++j) v = l == j ? a[j] : v;
  return v;
}

__device__ __forceinline__ const float* fc_weight(const FoldConvArgs& p, int l) {
  const float* v = p.w[0];
#pragma unroll
  for (int j = 1; j < FC_MAXL; ++j) v = l == j ? p.w[j] : v;
  return v;
}

// ---------------------------------------------------------------------------
// the terms and the K sum of one warp's 16 channels of one instruction
// ---------------------------------------------------------------------------

struct FcGroup {
  int path, x0, mul, u0, obase, u_tot, roff;
};

// The terms and sums of one warp's channels u and u + 1 (lane (g, q)):
// every index of the state arrays is a template constant and every
// function is force-inlined, so that the arrays live in registers.
template <int V, int K, int D1, int D3, unsigned long long MASK>
struct FcTerms {
  using S = FcShape<V, K>;
  static constexpr int NP = S::NP;
  // group sums (group4: one a column, group8: two), sliceadd's binary
  // counter and stack
  float gs[D3][2][2], part[D3][2][S::LOGT + 1], stk[D3][2][S::DEPTH];

  // position i: the slot's x and w, x w a pair (m, u), each term added in
  // m's order (sliceadd: into the slot's v, then v into the fold)
  template <int i>
  __device__ __forceinline__ void position(const FoldConvArgs& p, const float (&d)[NP / 2],
                                           const FcGroup& gr, const float* xb, const float* tb,
                                           int q, float sc) {
    constexpr int j = i / 2, e = i % 2;
    using Pos = FcPos<V, K, i>;
    const float* xp = xb + (size_t)(Pos::base + Pos::mult * q) * p.dim_x;
    float2 xv[D1];
#pragma unroll
    for (int m = 0; m < D1; ++m) xv[m] = __ldg((const float2*)(xp + m * gr.mul));
    const float w0 = d[4 * j + e] * sc, w1 = d[4 * j + 2 + e] * sc;
    float v[D3][2];
#pragma unroll
    for (int pp = 0; pp < D3; ++pp) v[pp][0] = v[pp][1] = 0.0f;
#pragma unroll
    for (int m = 0; m < D1; ++m) {
      const float xw0 = __fmul_rn(xv[m].x, w0), xw1 = __fmul_rn(xv[m].y, w1);
#pragma unroll
      for (int pp = 0; pp < D3; ++pp) {
        const int bit = m * D3 + pp;
        if ((MASK >> bit) & 1ull) {
          const int rk = __popcll(MASK & ((1ull << bit) - 1ull));
          const float t = tb[rk * NP + 8 * j + e];
          const float t0 = __fmul_rn(xw0, t), t1 = __fmul_rn(xw1, t);
          if constexpr (V == FC_SLICEADD) {
            v[pp][0] = __fadd_rn(v[pp][0], t0);
            v[pp][1] = __fadd_rn(v[pp][1], t1);
          } else {
            constexpr int ci = V == FC_GROUP8 ? e : 0;
            gs[pp][0][ci] = __fadd_rn(gs[pp][0][ci], t0);
            gs[pp][1][ci] = __fadd_rn(gs[pp][1][ci], t1);
          }
        }
      }
    }
    if constexpr (V == FC_SLICEADD) {
      // leaf tp of S_r: carries of the binary counter over t, then, at the
      // last leaf, b's bits 1 and 0 across lanes and S_r onto the stack
      constexpr int ones = fc_ones(Pos::tp);
      constexpr int carries = ones < S::LOGT ? ones : S::LOGT;
#pragma unroll
      for (int pp = 0; pp < D3; ++pp)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = v[pp][h];
#pragma unroll
          for (int l = 0; l < carries; ++l) x = __fadd_rn(part[pp][h][l], x);
          if constexpr (Pos::tp < S::T - 1) {
            part[pp][h][ones] = x;
          } else {
            x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
            x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
            stk[pp][h][Pos::sp] = x;
#pragma unroll
            for (int c = 0; c < Pos::pops; ++c)  // the two newest: Pos::sp - c - 1, Pos::sp - c
              stk[pp][h][Pos::sp - c - 1] =
                  __fadd_rn(stk[pp][h][Pos::sp - c - 1], stk[pp][h][Pos::sp - c]);
          }
        }
    }
  }

  template <int i>
  __device__ __forceinline__ void positions(const FoldConvArgs& p, const float (&d)[NP / 2],
                                            const FcGroup& gr, const float* xb, const float* tb,
                                            int q, float sc) {
    if constexpr (i < S::PR) {
      position<i>(p, d, gr, xb, tb, q, sc);
      positions<i + 1>(p, d, gr, xb, tb, q, sc);
    }
  }

  __device__ __forceinline__ void run(const FoldConvArgs& p, const float (&d)[NP / 2],
                                      const FcGroup& gr, const float* TW, int recv, float sc) {
    // opaque to the compiler: nothing of the terms is computed before the
    // products (hoisted, it would hold registers across them)
    int tid = threadIdx.x, rv = recv;
    asm volatile("" : "+r"(tid), "+r"(rv));
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int u = gr.u0 + 2 * g;  // this lane's channels u, u + 1 (mul even: both or neither)
    const bool held = u < gr.mul;
    const float* xb = p.xg + (size_t)rv * K * p.dim_x + gr.x0 + (held ? u : 0);
    const float* tb = TW + gr.roff * NP + 2 * q;
#pragma unroll
    for (int pp = 0; pp < D3; ++pp)
      gs[pp][0][0] = gs[pp][0][1] = gs[pp][1][0] = gs[pp][1][1] = 0.0f;
    positions<0>(p, d, gr, xb, tb, q, sc);
    // each column's sum in every lane (the group sums halved across
    // lanes), stored by lane q = 0
    float res[D3][2];
#pragma unroll
    for (int pp = 0; pp < D3; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (V == FC_SLICEADD) {
          res[pp][h] = stk[pp][h][0];
        } else {
          float s = V == FC_GROUP8 ? __fadd_rn(gs[pp][h][0], gs[pp][h][1]) : gs[pp][h][0];
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
          res[pp][h] = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
        }
      }
    if (q == 0 && held) {
      float* o = p.out + (size_t)rv * p.dim_mid + gr.obase + u;
#pragma unroll
      for (int pp = 0; pp < D3; ++pp) o[pp * gr.u_tot] = res[pp][0], o[pp * gr.u_tot + 1] = res[pp][1];
    }
  }
};

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct FcCarve {
  int h, sh, tw, total;  // float offsets in a warpgroup's region
};

__host__ __device__ inline FcCarve fc_carve(const FoldConvArgs& p, int np) {
  FcCarve c{};
  int o = 0;
  c.h = o, o += 2 * np * p.hk;
  c.sh = o, o += np * p.dim_f;
  c.tw = o;
  const int a = np * p.tw_rows, b = 2 * np * p.nbk;
  o += a > b ? a : b;
  c.total = (o + 31) & ~31;
  return c;
}

// The weights split into TF32 hi and lo, as A fragments (W^T: rows are a
// layer's output columns), 8 floats a thread of the warpgroup and k-step:
// the hidden layers' one tile each, then W3's tiles (the plan's channel of
// each row). A thread a fragment.
__global__ void probe_fold_conv_prep_kernel(FoldConvArgs p) {
  int hid = 0;
  for (int l = 0; l + 1 < p.nl; ++l) hid += (p.dims[l] + 7) >> 3;
  const int hl = p.dims[p.nl - 1], ks3 = (hl + 7) >> 3, numel = p.dims[p.nl];
  const int total = 128 * (hid + p.n_tiles * ks3);
  for (int id = blockIdx.x * blockDim.x + threadIdx.x; id < total; id += gridDim.x * blockDim.x) {
    const int wt = id & 127, step = id >> 7;
    const int warp = wt >> 5, g = (wt & 31) >> 2, q = wt & 3;
    float a[4];
    if (step < hid) {
      int l = 0, s = step;
      while (s >= ((p.dims[l] + 7) >> 3)) s -= (p.dims[l] + 7) >> 3, ++l;
      const int din = p.dims[l], dout = p.dims[l + 1];
      const float* W = fc_weight(p, l);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * warp + g + 8 * (i & 1), k = 8 * s + q + 4 * (i >> 1);
        a[i] = row < dout && k < din ? __ldg(W + (size_t)k * dout + row) : 0.0f;
      }
    } else {
      const int t = (step - hid) / ks3, s = (step - hid) - t * ks3;
      const int* gp = p.gtab + (t * 4 + warp) * FC_GREC;
      const float* W3 = fc_weight(p, p.nl - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = g + 8 * (i & 1), k = 8 * s + q + 4 * (i >> 1);
        const int u = gp[3] + 2 * (rr & 7) + (rr >> 3);
        a[i] = gp[0] >= 0 && u < gp[2] && k < hl ? __ldg(W3 + (size_t)k * numel + gp[7] + u)
                                                 : 0.0f;
      }
    }
    unsigned hi[4], lo[4];
    split4(a, hi, lo);
    float4* o = (float4*)(p.frag + (size_t)id * 8);
    o[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                       __uint_as_float(hi[3]));
    o[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                       __uint_as_float(lo[3]));
  }
}

#define FC_CASE(id, d1, d3, mask)                          \
  case id:                                                 \
    FcTerms<V, K, d1, d3, mask>().run(p, d, gr, TW, recv, sc3); \
    break;

template <int V, int K>
__global__ void __launch_bounds__(FC_NT, 2) probe_fold_conv_kernel(FoldConvArgs p) {
  using S = FcShape<V, K>;
  constexpr int NP = S::NP, G = NP / 8;
  extern __shared__ __align__(128) float fc_sm[];
  // wg through a shuffle: the compiler then knows it is the same across a
  // warp, so that no wgmma lies on a path it must assume divergent
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31, g = lane >> 2, q = lane & 3;
  const FcCarve cv = fc_carve(p, NP);
  float* H = fc_sm + wg * cv.total + cv.h;
  float* SH = fc_sm + wg * cv.total + cv.sh;
  float* TW = fc_sm + wg * cv.total + cv.tw;  // the tmp window; emb's hi and lo before it
  const int my_slot = wt < NP ? fc_slot_at<V, K>(wt) : -1;
  int hid = 0;
  for (int l = 0; l + 1 < p.nl; ++l) hid += (p.dims[l] + 7) >> 3;
  const int hl = p.dims[p.nl - 1], ks3 = (hl + 7) >> 3;
  const float* fr3 = p.frag + (size_t)hid * 1024;
  const float sc3 = fc_param(p.inv_sqrt, p.nl - 1);
  const int nb = p.dims[0];
  for (int recv = blockIdx.x * 2 + wg; recv < p.N; recv += gridDim.x * 2) {
    fc_bar(wg);  // the last receiver's terms are done with every buffer
    if (wt < NP) {
      const size_t row = (size_t)recv * K + (my_slot >= 0 ? my_slot : 0);
      for (int k = 0; k < p.nbk; ++k) {
        const float v = my_slot >= 0 && k < nb ? __ldg(p.emb + row * nb + k) : 0.0f;
        unsigned hi, lo;
        split_tf32(v, hi, lo);
        const int at = fc_core(wt, k, G);
        TW[at] = __uint_as_float(hi);
        TW[NP * p.nbk + at] = __uint_as_float(lo);
      }
      for (int f = 0; f < p.dim_f; ++f)
        SH[f * NP + wt] = my_slot >= 0 ? __ldg(p.sh + row * p.dim_f + f) : 0.0f;
    }
    fc_fence_async();
    fc_bar(wg);
    // the hidden layers, each into H (hi and lo) over its input
    const float* B = TW;
    int kdim = p.nbk;
    const float* fr = p.frag;
    for (int l = 0; l + 1 < p.nl; ++l) {
      const int ks = (p.dims[l] + 7) >> 3;
      float d[NP / 2];
      fc_matmul<NP>(d, fr, B, kdim, ks, wt);
      fc_bar(wg);  // every warp's products have read B: H may be written
      const float sc = fc_param(p.inv_sqrt, l);
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hr = 16 * warp + g + 8 * h;  // hidden unit
          if (hr < p.hk) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float z = d[4 * j + 2 * h + e] * sc;
              unsigned hi, lo;
              split_tf32(z / (1.0f + expf(-z)) * p.act_cst, hi, lo);
              const int at = fc_core(8 * j + 2 * q + e, hr, G);
              H[at] = __uint_as_float(hi);
              H[NP * p.hk + at] = __uint_as_float(lo);
            }
          }
        }
      fc_fence_async();
      fc_bar(wg);
      fr += (size_t)ks * 1024, B = H, kdim = p.hk;
    }
    // W3's tiles: w of the tile's channels at every position, then the terms
#pragma unroll 1
    for (int t = 0; t < p.n_tiles; ++t) {
      const int r_lo = __ldg(p.ttab + 2 * t), rows = __ldg(p.ttab + 2 * t + 1);
      fc_bar(wg);  // the last tile's terms are done with the window
      for (int idx = wt; idx < rows * NP; idx += 128) {
        const int r = idx / NP, n = idx - r * NP;
        const float* wr = p.w3j + (size_t)(r_lo + r) * p.dim_f;
        float z = 0.0f;
        for (int f = 0; f < p.dim_f; ++f) z = fmaf(__ldg(wr + f), SH[f * NP + n], z);
        TW[idx] = z;
      }
      float d[NP / 2];
      fc_matmul<NP>(d, fr3 + (size_t)t * ks3 * 1024, H, p.hk, ks3, wt);
      fc_bar(wg);  // the window is whole
      const int* gp = p.gtab + (t * 4 + warp) * FC_GREC;
      const FcGroup gr{__ldg(gp), __ldg(gp + 1), __ldg(gp + 2), __ldg(gp + 3),
                       __ldg(gp + 4), __ldg(gp + 5), __ldg(gp + 6)};
      switch (gr.path) {
        FC_PATHS(FC_CASE)
        default:
          break;
      }
    }
  }
}

template <int V, int K>
static cudaError_t fc_occupancy(const FoldConvArgs& p, size_t& smem, int& ctas,
                                cudaFuncAttributes* attr) {
  static int smem_limit[MAX_DEVICES];
  smem = sizeof(float) * 2 * fc_carve(p, FcShape<V, K>::NP).total;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit((const void*)probe_fold_conv_kernel<V, K>, smem, smem_limit);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, probe_fold_conv_kernel<V, K>, FC_NT,
                                                      smem);
  if (err == cudaSuccess && attr) err = cudaFuncGetAttributes(attr, probe_fold_conv_kernel<V, K>);
  return err;
}

template <int V, int K>
static int launch_v(const FoldConvArgs& p, cudaStream_t s) {
  size_t smem;
  int ctas = 0, dev = 0, sms = 0;
  cudaError_t err = fc_occupancy<V, K>(p, smem, ctas, nullptr);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  int hid = 0;
  for (int l = 0; l + 1 < p.nl; ++l) hid += (p.dims[l] + 7) >> 3;
  const int frags = 128 * (hid + p.n_tiles * ((p.dims[p.nl - 1] + 7) >> 3));
  probe_fold_conv_prep_kernel<<<(frags + 255) / 256, 256, 0, s>>>(p);
  const int pairs = (p.N + 1) / 2;
  probe_fold_conv_kernel<V, K><<<pairs < sms * ctas ? pairs : sms * ctas, FC_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

static bool fc_args_ok(const FoldConvArgs& p) {
  if (p.N <= 0 || p.nl < 2 || p.nl > FC_MAXL || p.n_tiles <= 0 || p.hk > FC_HMAX ||
      p.nbk > FC_HMAX || p.hk % 8 || p.nbk % 8)
    return false;
  for (int l = 0; l + 1 < p.nl; ++l)
    if (p.dims[l] <= 0 || p.dims[l] > FC_HMAX || (l > 0 && p.dims[l] > p.hk)) return false;
  return p.dims[0] <= p.nbk;
}

// the variant's kernel at K: a switch over the compiled (variant, K)
template <typename F>
static int fc_dispatch(int variant, int k, F&& f) {
  if (k == 24) {
    if (variant == FC_SLICEADD) return f(std::integral_constant<int, FC_SLICEADD>{}, std::integral_constant<int, 24>{});
    if (variant == FC_GROUP4) return f(std::integral_constant<int, FC_GROUP4>{}, std::integral_constant<int, 24>{});
    if (variant == FC_GROUP8) return f(std::integral_constant<int, FC_GROUP8>{}, std::integral_constant<int, 24>{});
  } else if (k == 72) {
    if (variant == FC_SLICEADD) return f(std::integral_constant<int, FC_SLICEADD>{}, std::integral_constant<int, 72>{});
    if (variant == FC_GROUP4) return f(std::integral_constant<int, FC_GROUP4>{}, std::integral_constant<int, 72>{});
    if (variant == FC_GROUP8) return f(std::integral_constant<int, FC_GROUP8>{}, std::integral_constant<int, 72>{});
  }
  return (int)cudaErrorInvalidValue;
}

// variant: FC_SLICEADD, FC_GROUP4 or FC_GROUP8; K 24 or 72; n_basis and
// hidden widths at most 64; the tables of probes/fold_conv.py:plan (checked
// by the wrapper, _check_kernel). Launches the weights' split, then the conv.
extern "C" int probe_fold_conv_launch(int variant, FoldConvArgs p, void* stream) {
  if (!fc_args_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return fc_dispatch(variant, p.K, [&](auto V_, auto K_) {
    return launch_v<decltype(V_)::value, decltype(K_)::value>(p, s);
  });
}

// out: shared memory a CTA (bytes), CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes (cudaFuncGetAttributes) of the variant's kernel at K
extern "C" int probe_fold_conv_occupancy(int variant, FoldConvArgs p, int* out) {
  if (!fc_args_ok(p)) return (int)cudaErrorInvalidValue;
  return fc_dispatch(variant, p.K, [&](auto V_, auto K_) {
    size_t smem;
    int ctas = 0;
    cudaFuncAttributes attr{};
    const cudaError_t err =
        fc_occupancy<decltype(V_)::value, decltype(K_)::value>(p, smem, ctas, &attr);
    out[0] = (int)smem, out[1] = ctas, out[2] = attr.numRegs, out[3] = (int)attr.localSizeBytes;
    return (int)err;
  });
}
