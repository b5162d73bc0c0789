// K-fold probes: the sum over a receiver's K neighbour slots of a dim_mid
// tile, alone, at the engine's shapes, on the CUDA cores or the tensor
// cores.
//
// Replaces the Pallas TPU probe scripts_dev/r3_fold_probe.py:make (pallas_call
// at :85, kernel :51-83). Input x (NB T, DX), T = A K, DX = DM / 8: block b
// holds the rows b T + k A + a, slot k of receiver b A + a (the TPU's
// k-major rows). Output (NB A, DM):
//   out[b A + a, c] = sum over t of fold[t][a] x[b T + t, cmap[c]],
// where cmap is the script's column map, given by the host: for the tile
// variants (roll, mxu2, mxu3) output column start + j of a tile of mul rows
// reads input column (start / 8 + j) mod DX (:54-60, tiles of MULS, :22);
// for bigroll column r reads r mod DX (:79-82). The variants:
//   roll, bigroll  the sum over k in the script's halving order (_kfold,
//                  :36-49: halve while the count is even, peel the last slot
//                  onto the first while it is odd: 72 -> 36 -> 18 -> 9 -> 8
//                  -> 4 -> 2 -> 1) in fp32 on the CUDA cores, for the 0/1
//                  fold matrix fold[t][t mod A] = 1 (probe_fold_roll_kernel<K>);
//   mxu2, mxu3     the product with the fold matrix, read from its argument
//                  (T, A), on the tensor cores: each x split into 2 or 3
//                  bf16 pieces (round to nearest even, x - the pieces so far
//                  rounded again, :63-77), the fold rounded to bf16 (exact
//                  for 0/1), bf16 products exact in fp32, fp32 sums
//                  (probe_fold_mma_kernel<PIECES, PAIRS>). The sum runs in
//                  another order than the script's.
//
// roll (redesigned for Hopper): the function reads x once (1.131 GB at the
// script's shape) and writes out once (125.6 MB): 0.375 ms at 3.35 TB/s.
// Folding every output column from staged data, as the TPU folds every
// tile (8 output columns read each input column), reads 9.05 GB of shared
// memory, about 0.3 ms at 128 B a clock an SM, so the stream and the folds
// must overlap. The first design (one CTA a receiver staging its whole 113
// KB slab by cp.async, then folding it) overlapped nothing inside a CTA:
// 0.517 ms. Now (probe_fold_roll_kernel<K, VEC>):
//   - persistent CTAs, one an SM, take receivers in turn; a receiver's K
//     rows arrive as slices of ROLL_SW = 56 input columns (16 KB, 7 a
//     receiver; the last slice of another DX may be narrower), one TMA box
//     each (x viewed as (DX, A, K NB)), issued by a producer thread into a
//     ring of up to 12 stages (full/empty mbarriers, no block-wide barrier
//     in the loop);
//   - 8 consumer warps fold, from each stage, exactly the output columns
//     whose input column lies in its slice (the host's inverse column map,
//     probes/fold.py:roll_plan, sorted by input column so that neighbouring
//     threads read neighbouring words), each on its own: K loads and K - 1
//     adds in the script's halving order, as a tree per slot group so that
//     few values are live; where every aligned run of 4 output columns reads
//     an aligned run of 4 input columns (both of the script's maps), a
//     thread folds a run with 16-byte loads. A receiver's units go to the
//     threads in turn, continuing across receivers.
// Measured (fold_breakdown.py --roll, H100, 700 W): the stream alone 0.364
// ms (97 % of the bound), the folds alone 0.27-0.33, together 0.44-0.46:
// both share the SM's shared-memory bandwidth (the TMA's writes and the
// folds' reads); slices of 28 or 112 columns and 12 consumer warps ran as
// fast, not faster. The same kernel with copies by cp.async took 0.87 ms
// from one producer warp and 0.50 from four, whose copies held up the
// folds' loads.
//
// mxu (redesigned for Hopper): the product runs dense, as the TPU's MXU
// runs it, 2 A T DM multiply-adds a block and piece, oriented as
//   out^T (DM x A) = X_map^T (DM x T) . fold (T x A),
// M the output columns (m64 tiles), N = 32 (A, padded with zero columns at
// A 16), K = t (k16), on wgmma.mma_async m64n32k16 bf16 with fp32
// accumulation. Each output column's operand is read and split on its own,
// as if its data were its own: a thread loads its fragment's fp32
// x[t][cmap[c]] from the staged rows (rows 2 t, + 1, + 8, + 9 of the k16
// step; A rows g and g + 8 are output columns c and c + 1, so that where
// the map sends them to input columns ci, ci + 1 (ci even) one 8-byte load
// a row reads both, PAIRS; on an H100 that took mxu2 from 1.40 to 1.15 ms
// and mxu3 from 1.88 to 1.62 at the script's shape, against the same
// kernel with one 4-byte load a column, whose mxu3 also spills 24 B:
// chip_smoke.py --fold-probe on each, in turns), splits it into PIECES
// bf16 pieces and packs them as wgmma's register A operand, one wgmma per
// piece. B is the fold's rows in bf16 K-major core matrices (8 n x 8 k,
// no swizzle), 1 KB a k16 step, written for the call by a first small
// kernel (probe_fold_bprep_kernel), so that no thread writes what wgmma
// reads and the loop needs no proxy fence.
//   - One x read through L2 a block: a block's DM / 64 m64 tiles (49 at the
//     script's shape) go to a thread-block cluster, FM_TPW tiles a CTA (7 x
//     7). Each stage (FM_R = 16 rows of x) is loaded once by TMA
//     (cp.async.bulk.tensor, boxes of W <= 252 columns: DX = 392 is two
//     boxes of 196) and its B by one more box, all multicast to every CTA
//     of the cluster, completion counted on each CTA's `full` mbarrier. W =
//     4 mod 8 floats is the staged row pitch, so the fragment loads (rows 2
//     t + {0, 1, 8, 9}, 8 columns or 8 pairs) hit distinct banks. TMA
//     zero-fills the columns past DX and the rows past a block. A cp.async
//     copy path was not built: knocking the TMA loads and their waits out
//     saves 9-13 % (fold_breakdown.py), a bound on what any copy path could
//     save, and cp.async has no multicast (7 reads of a block through L2).
//   - Warp-specialised: a producer warpgroup (40 registers by setmaxnreg)
//     and two consumer warpgroups (232), each with every tile's
//     accumulators (16 fp32 registers a tile), taking alternate stages of a
//     ring of ns stages of x and 2 ns of B. A TMA issue holds its thread for
//     about 2,700 cycles (fold_breakdown.py), so the producer of rank r
//     issues the stages n = r mod cl, each once every CTA has released the
//     slot's last round (one remote arrive a consumer warp on the issuing
//     rank's `empty`). No block-wide barrier in the loop.
//   - A consumer warpgroup splits a whole k16 step (its 7 tiles, each into
//     its own A registers), then issues the step's 7 PIECES wgmma after one
//     fence and waits for them only before its next split: a warpgroup keeps
//     about one wgmma group moving (register A is read as a group runs), so
//     the two warpgroups ping-pong, one splitting while the other's
//     products run.
//   - At the end consumer warpgroup 2 hands its sums to warpgroup 1 through
//     shared memory (a fixed order of the two partial sums).
// What bounds it on an H100 (fold_breakdown.py's knock-outs): the function
// is bound by HBM (1.154 GB in, 125.6 MB out, 0.375 ms) and the design's
// dense bf16 products take 0.293 ms (mxu2) and 0.439 ms (mxu3) at 989
// TFLOP/s, but register-A m64n32k16 wgmma runs at about half that rate, the
// split's ALU work costs about as much again and overlaps it only in part,
// and clusters of 7 CTAs (one an SM) hold 105 of the 132 SMs.
#include <cuda.h>
#include <cuda_bf16.h>

#include "fused_conv_common.cuh"

#define FM_R 16        // rows of x a stage: one k16 step
#define FM_BBYTES 1024 // B of a stage: 16 x 32 bf16
#define FM_NSMAX 8     // stages in the ring at most (the host picks an even count)
#define FM_TPW 7       // m64 tiles of a CTA (each warpgroup's accumulators)
#define FM_CLMAX 8     // CTAs of a cluster (portable)
#define FM_BOXW 252    // widest TMA box of x: <= 256 columns, 4 mod 8
#define FM_NT 384      // threads: a producer warpgroup, two consumer warpgroups
// A measurement build (fold_breakdown.py) knocks phases of the mxu kernel
// out: 1 the products (the pieces are folded into the sums by an integer
// xor instead), 2 the loads of x (each value a register's bits), 3 the TMA
// loads and the waits for them (the staged data is whatever shared memory
// holds), 4 the split (the pieces are x's raw bits), 5 all but the products,
// 6 the products and the TMA (the loads and the split alone), 7 the TMA and,
// in consumer warpgroup 1, the loads and the split, in warpgroup 2 the
// products (each engine alone in a warpgroup of its own). The wrappers never
// load such a build.
#ifndef FOLD_MMA_KO
#define FOLD_MMA_KO 0
#endif
#define KO_PRODUCTS (FOLD_MMA_KO == 1 || FOLD_MMA_KO == 6)
#define KO_LOADS (FOLD_MMA_KO == 2 || FOLD_MMA_KO == 5)
#define KO_TMA (FOLD_MMA_KO == 3 || FOLD_MMA_KO == 5 || FOLD_MMA_KO == 6 || FOLD_MMA_KO == 7)
#define KO_SPLIT (FOLD_MMA_KO == 4 || FOLD_MMA_KO == 5)

// A measurement build with -DFOLD_MMA_PROF has each consumer warpgroup's
// thread 0 add clock64() cycles into fm_prof: [rank 0 or another rank][the
// stage loop, its waits for `full`, its releases (the arrive and arming
// `full`), stages] (probe_fold_prof reads and clears them).
#ifdef FOLD_MMA_PROF
__device__ unsigned long long fm_prof[2][4];
#define FM_CLOCK() clock64()
#else
#define FM_CLOCK() 0ll
#endif

struct FoldArgs {
  const float* x;     // (NB T, DX)
  const float* fold;  // (T, A)
  const int* cmap;    // (DM,)
  float* out;         // (NB A, DM)
  unsigned char* bq;  // mxu: B of T / 16 stages, FM_BBYTES each (the wrapper's scratch)
  int NB, K, A, DX, DM;
  // mxu: the host's plan (probes/fold.py:mma_plan): m64 tiles, CTAs of a
  // cluster, CTAs a block, TMA boxes of x a stage and their width, stages
  // in the ring; whether output columns 2i, 2i + 1 read input columns ci,
  // ci + 1 with ci even (probes/fold.py:mma_pairs)
  int tiles, cl, ctas, nbox, W, ns, pairs;
};

// ---------------------------------------------------------------------------
// mxu: wgmma, TMA multicast, mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned fm_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *(const unsigned*)&h;
}

// B of every stage: bq[s] = fold rows 16 s .. 16 s + 15 (0 for n >= A) in
// bf16, core matrix (k / 8, n / 8) at 128 (4 (k / 8) + n / 8) bytes, its row
// n % 8 at 16 (n % 8); a thread the 4 k of one (s, n, k / 4).
__global__ void __launch_bounds__(256) probe_fold_bprep_kernel(const float* fold, int T, int A,
                                                               unsigned char* bq) {
  const int i = blockIdx.x * 256 + threadIdx.x, s = i >> 7, n = (i >> 2) & 31, kq = i & 3;
  if (s * FM_R >= T) return;
  float f[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = FM_R * s + 4 * kq + r;
    f[r] = n < A ? fold[(size_t)t * A + n] : 0.0f;
  }
  *(uint2*)(bq + (size_t)s * FM_BBYTES + ((kq >> 1) * 4 + (n >> 3)) * 128 + (n & 7) * 16 +
            (kq & 1) * 8) = make_uint2(fm_pack(f[0], f[1]), fm_pack(f[2], f[3]));
}

struct FoldMma {
  CUtensorMap tmx;  // x as (NB, T, DX) fp32, boxes (W, FM_R, 1)
  CUtensorMap tmb;  // the B stages as (T / 16, FM_BBYTES / 4) 4-byte words, a box a stage
  const int* cmap;
  float* out;
  int A, DM, T, W, nbox, tiles, ctas, cl, ns, per, ring;
};

__device__ __forceinline__ unsigned fm_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fm_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(fm_smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fm_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(fm_smem(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` of *bar has completed
__device__ __forceinline__ void fm_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(fm_smem(bar)),
      "r"(parity)
      : "memory");
}

// whether that phase has completed, without waiting
__device__ __forceinline__ bool fm_test(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(fm_smem(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// arrives on the barrier at *bar's offset in rank r's shared memory
__device__ __forceinline__ void fm_arrive_rank(unsigned long long* bar, int r) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(fm_smem(bar)), "r"(r));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// TMA: the box of map at (c0, c1, c2) into dst, completion on bar, into the
// same offsets of every CTA of mask (cl > 1) or of this CTA
__device__ __forceinline__ void fm_tma3(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        unsigned long long* bar, unsigned short mask, int cl) {
  const unsigned long long m = (unsigned long long)map;
  if (cl > 1)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(fm_smem(dst)),
        "l"(m), "r"(fm_smem(bar)), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(fm_smem(dst)),
        "l"(m), "r"(fm_smem(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void fm_tma2(void* dst, const CUtensorMap* map, int c0, int c1,
                                        unsigned long long* bar, unsigned short mask, int cl) {
  const unsigned long long m = (unsigned long long)map;
  if (cl > 1)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(fm_smem(dst)),
        "l"(m), "r"(fm_smem(bar)), "h"(mask), "r"(c0), "r"(c1)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(fm_smem(dst)),
        "l"(m), "r"(fm_smem(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// ---------------------------------------------------------------------------
// roll, bigroll: a ring of column slices
// ---------------------------------------------------------------------------

#ifndef FR_CW
#define FR_CW 8                   // consumer warps (a measurement build may set another count)
#endif
#define FR_NT (32 * (FR_CW + 1))  // and one producer warp
// A measurement build (fold_breakdown.py --roll) knocks a phase of the roll
// kernel out: 1 the folds (the consumers wait for each stage and release
// it), 2 the copies (the producer arrives on `full` without a TMA: the folds
// read whatever the stages hold). The wrappers never load such a build.
#ifndef FOLD_ROLL_KO
#define FOLD_ROLL_KO 0
#endif
#define FR_NSMAX 12               // stages in the ring at most
#define FR_ALIGN 128              // bytes: a TMA destination's alignment

struct RollArgs {
  const float* x;     // (NB T, DX)
  float* out;         // (NB A, DM)
  const int2* units;  // the host's inverse map (probes/fold.py:roll_plan): per slice, its
                      // units (output column, input column - the slice's first), each 4
                      // columns (vec) or 1
  const int* uoff;    // (nsl + 1,): slice s's units are [uoff[s], uoff[s + 1])
  int NB, A, DX, DM, SW, nsl, ns, vec;
};

// the kernel's parameters: RollArgs with x as a tensor map
struct RollTma {
  CUtensorMap tmx;  // x as (DX, A, K NB) fp32, boxes (SW, 1, K): a receiver's K rows of a slice
  float* out;
  const int2* units;
  const int* uoff;
  int NB, A, DX, DM, SW, nsl, ns, stride;  // stride: floats a stage, K SW rounded up to 32
};

__device__ __forceinline__ float fr_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 fr_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// the script's halving order on v[0 .. KC): the sum lands in v[0]
template <int KC, int KM, class V>
__device__ __forceinline__ void kfold(V (&v)[KM]) {
  if constexpr (KC > 1) {
    if constexpr (KC % 2 == 0) {
#pragma unroll
      for (int k = 0; k < KC / 2; ++k) v[k] = fr_add(v[k], v[k + KC / 2]);
      kfold<KC / 2>(v);
    } else {
      v[0] = fr_add(v[0], v[KC - 1]);
      kfold<KC - 1>(v);
    }
  }
}

// the halvings of K while it is even (72 -> 9: 3; 8 -> 1: 3; 9: 0)
template <int K>
__host__ __device__ constexpr int fr_halvings() {
  int h = 0;
  while (((K >> h) & 1) == 0) ++h;
  return h;
}

template <bool VEC>
struct FrCols {
  typedef float T;
};
template <>
struct FrCols<true> {
  typedef float4 T;
};

// slot k's value of the unit's columns after L of the halvings: the script's
// v[k] after L levels, v_L[k] = v_{L-1}[k] + v_{L-1}[k + K / 2^L], each leaf
// read from the stage where the tree needs it
template <int K, int L, bool VEC>
__device__ __forceinline__ typename FrCols<VEC>::T fr_halved(const float* col, int SW, int k) {
  if constexpr (L == 0) {
    if constexpr (VEC) return *(const float4*)(col + k * SW);
    else return col[k * SW];
  } else {
    return fr_add(fr_halved<K, L - 1, VEC>(col, SW, k),
                  fr_halved<K, L - 1, VEC>(col, SW, k + (K >> L)));
  }
}

// Persistent: CTA q takes receivers q, q + grid, ...; each receiver's K rows
// arrive as nsl slices of SW input columns (the last may be narrower: TMA
// fills the columns past DX with zeros, which nothing reads), a stage each,
// copied by one TMA box from the producer warp into a ring of ns stages
// (completion on `full`); the consumer threads fold, from each stage, the
// output columns whose input column lies in its slice, every one of them on
// its own (K loads and K - 1 adds), and release it on `empty` (one arrival
// a warp). A receiver's units, in slice order, go to the 256 consumer
// threads in turn, continuing across receivers, so that every thread folds
// as many as the others within one.
template <int K, bool VEC>
__global__ void __launch_bounds__(FR_NT, 1) probe_fold_roll_kernel(const __grid_constant__ RollTma p) {
  extern __shared__ __align__(FR_ALIGN) unsigned char fr_smem[];
  float* ring = (float*)(fr_smem + ((FR_ALIGN - fm_smem(fr_smem) % FR_ALIGN) % FR_ALIGN));
  unsigned long long* full = (unsigned long long*)(ring + (size_t)p.ns * p.stride);
  unsigned long long* empty = full + p.ns;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ns; ++s) {
      fm_mbar_init(&full[s], 1);
      fm_mbar_init(&empty[s], FR_CW);
    }
  }
  __syncthreads();
  const int nrecv = p.NB * p.A;

  if (warp == FR_CW) {  // the producer
    if (lane == 0) {
      int t = 0;
      for (int rcv = blockIdx.x; rcv < nrecv; rcv += gridDim.x) {
        const int b = rcv / p.A, a = rcv - b * p.A;
        for (int s = 0; s < p.nsl; ++s, ++t) {
          const int slot = t % p.ns;
          if (t >= p.ns) fm_wait(&empty[slot], ((t / p.ns) - 1) & 1);
#if FOLD_ROLL_KO != 2
          fm_expect_tx(&full[slot], 4u * K * p.SW);
          fm_tma3(ring + slot * p.stride, &p.tmx, s * p.SW, a, b * K, &full[slot], 0, 1);
#else
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(fm_smem(&full[slot]))
                       : "memory");
#endif
        }
      }
    }
    return;
  }

  typedef typename FrCols<VEC>::T V;
  constexpr int H = fr_halvings<K>(), M = K >> H;
  constexpr int T = 32 * FR_CW;
  const int n_units = p.uoff[p.nsl];
  int t = 0, base = 0;  // base: the units handed out before this receiver, mod T
  for (int rcv = blockIdx.x; rcv < nrecv; rcv += gridDim.x) {
    float* o = p.out + (size_t)rcv * p.DM;
    for (int s = 0; s < p.nsl; ++s, ++t) {
      const int slot = t % p.ns;
      fm_wait(&full[slot], (t / p.ns) & 1);
      const float* st = ring + slot * p.stride;
      const int u0 = __ldg(p.uoff + s), u1 = __ldg(p.uoff + s + 1);
      // this thread's units j of the slice: base + j = threadIdx.x mod T
      for (int j = u0 + (((int)threadIdx.x - base - u0) % T + T) % T; j < u1 && FOLD_ROLL_KO != 1;
           j += T) {
        const int2 u = __ldg(p.units + j);
        const float* col = st + u.y;
        V v[M];
#pragma unroll
        for (int k = 0; k < M; ++k) v[k] = fr_halved<K, H, VEC>(col, p.SW, k);
        kfold<M>(v);
        *(V*)(o + u.x) = v[0];
      }
      __syncwarp();
      if (lane == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(fm_smem(&empty[slot]))
                     : "memory");
      }
    }
    base = (base + n_units) % T;
  }
}

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (between core matrices adjacent in K), stride byte
// offset (between 8-row groups), in 16-byte units (pg_reduce.cu's).
__device__ __forceinline__ unsigned long long fm_desc(const void* smem, int lbo, int sbo) {
  const unsigned addr = fm_smem(smem);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 32) += a (64 x 16, bf16, registers) b (16 x 32, bf16, K-major in
// shared memory): warp w of the warpgroup holds rows 16 w + g, + 8 of a as
// mma.sync's m16n8k16 A fragment, and of d, n8 group j at d[4j .. 4j + 3]
// (columns 8j + 2t, + 1; rows g, g + 8).
__device__ __forceinline__ void fm_wgmma(float (&d)[16], const unsigned (&a)[4],
                                         unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void fm_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fm_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fm_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// v[h][s]: x at the thread's fragment rows 2 t + {0, 1, 8, 9} (s) of its
// columns c (h 0, A row g) and c + 1 (h 1, A row g + 8); into fr[q] its
// piece q, as wgmma's A registers: {rows g, g + 8} x {k 2t, 2t + 1}, then
// {k 2t + 8, 2t + 9}. A piece is the rest rounded to bf16 (nearest even),
// and the rest minus it is exact in fp32; a bf16 half is a float's upper
// 16 bits.
template <int PIECES>
__device__ __forceinline__ void fm_split(const float (&v)[2][4], unsigned (&fr)[PIECES][4],
                                         bool ko = KO_SPLIT) {
  if (ko) {
#pragma unroll
    for (int q = 0; q < PIECES; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) fr[q][i] = __float_as_uint(v[i & 1][(i >> 1) * 2 + q % 2]);
    return;
  }
  float r[8] = {v[0][0], v[0][1], v[1][0], v[1][1], v[0][2], v[0][3], v[1][2], v[1][3]};
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = fm_pack(r[2 * i], r[2 * i + 1]);
      fr[q][i] = u;
      if (q + 1 < PIECES) {
        r[2 * i] = __fsub_rn(r[2 * i], __uint_as_float(u << 16));
        r[2 * i + 1] = __fsub_rn(r[2 * i + 1], __uint_as_float(u & 0xffff0000u));
      }
    }
  }
}

// The fragment's 8 values from the staged rows x: PAIRS, columns c and c
// + 1 read input columns ci and ci + 1 (ci even), one 8-byte load a row;
// else each column at its own offset.
template <bool PAIRS>
__device__ __forceinline__ void fm_load(float (&v)[2][4], const float* x, const int (&off)[2],
                                        int W, bool ko = KO_LOADS) {
  if (ko) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[h][i] = __int_as_float(off[h] ^ (int)(size_t)x ^ i);
    return;
  }
  if constexpr (PAIRS) {
    const float* c = x + off[0];
    const float2 a = *(const float2*)c, b = *(const float2*)(c + W);
    const float2 d = *(const float2*)(c + 8 * W), e = *(const float2*)(c + 9 * W);
    v[0][0] = a.x, v[1][0] = a.y, v[0][1] = b.x, v[1][1] = b.y;
    v[0][2] = d.x, v[1][2] = d.y, v[0][3] = e.x, v[1][3] = e.y;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* c = x + off[h];
      v[h][0] = c[0];
      v[h][1] = c[W];
      v[h][2] = c[8 * W];
      v[h][3] = c[9 * W];
    }
  }
}

// stage s's x (TMA boxes) into ring slot s % ns and its B (one TMA box)
// into B slot s % 2 ns of every CTA of the cluster
__device__ __forceinline__ void fm_issue(const FoldMma& p, int s, int b, float* xs,
                                         unsigned char* bs, unsigned long long* full,
                                         int xstage) {
  const unsigned short mask = (unsigned short)((1u << p.cl) - 1);
  const int si = s % p.ns;
  float* xd = xs + si * xstage;
  fm_tma2(bs + s % (2 * p.ns) * FM_BBYTES, &p.tmb, 0, s, full + si, mask, p.cl);
  for (int i = 0; i < p.nbox; ++i)
    fm_tma3(xd + i * FM_R * p.W, &p.tmx, i * p.W, s * FM_R, b, full + si, mask, p.cl);
}

// Block blockIdx.y, m64 tiles [q tiles / ctas, (q + 1) tiles / ctas) of it,
// q = blockIdx.x; a cluster is blockIdx.x's run of cl CTAs. Warpgroup 0
// produces: its thread 0 issues the stages that fall to its rank (stage n:
// rank n % cl, which spreads the issuing over the cluster; an issue holds
// its thread for thousands of cycles), each once every CTA has released the
// slot's last round, waiting on its `empty` as long as it takes.
// Warpgroups 1 and 2 consume, warpgroup 1 + w the stages s = w mod 2 (ns
// even: its ring slots); each one's thread 0 arms its CTA's `full` for a
// stage's bytes once it has consumed the slot's last round. setmaxnreg
// moves the producer's registers to the consumers.
template <int PIECES, bool PAIRS>
__global__ void __launch_bounds__(FM_NT, 1) probe_fold_mma_kernel(
    const __grid_constant__ FoldMma p) {
  // the dynamic shared memory starts 128-byte aligned (the TMA's
  // destinations); indexed from the array itself, so that the loads of x
  // stay shared-memory loads
  extern __shared__ __align__(128) float fm_smem[];
  const int xstage = p.nbox * FM_R * p.W;  // floats of a stage of x
  float* xs = fm_smem;
  unsigned char* bs = (unsigned char*)(xs + p.ns * xstage);
  unsigned long long* full = (unsigned long long*)(fm_smem + p.ring);
  unsigned long long* empty = full + p.ns;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int rank = cluster_rank(), b = blockIdx.y, nstage = p.T / FM_R;
  const unsigned bytes = (unsigned)(4 * xstage + FM_BBYTES);
  if (tid == 0) {
    for (int s = 0; s < p.ns; ++s) {
      fm_mbar_init(full + s, 1);
      fm_mbar_init(empty + s, 4 * p.cl);
    }
    for (int s = 0; s < min(p.ns, nstage); ++s) fm_expect_tx(full + s, bytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the descriptors into the TMA unit's cache before their first use
    asm volatile("prefetch.tensormap [%0];\nprefetch.tensormap [%1];\n" ::"l"(
                     (unsigned long long)&p.tmx),
                 "l"((unsigned long long)&p.tmb)
                 : "memory");
  }
  // every CTA's barriers are set before a multicast or a remote arrive
  cluster_arrive();
  cluster_wait();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0 && !KO_TMA)
      for (int n = rank; n < nstage; n += p.cl) {
        // a rank's empty[ni] sees the releases of every per-th round of slot ni
        if (n >= p.ns) fm_wait(empty + n % p.ns, ((n / p.ns - 1) / p.per) & 1);
        fm_issue(p, n, b, xs, bs, full, xstage);
      }
    __syncwarp();
    // no CTA leaves while another may still arrive on its barriers
    cluster_arrive();
    cluster_wait();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;  // this consumer warpgroup
  // FOLD_MMA_KO 7: an engine knocked out in each warpgroup
  const bool ko_alu = FOLD_MMA_KO == 7 && cw == 0, ko_mma = FOLD_MMA_KO == 7 && cw == 1;
  const int g = lane >> 2, t = lane & 3;
  const int q = blockIdx.x, t0 = q * p.tiles / p.ctas, nt = (q + 1) * p.tiles / p.ctas - t0;
  // A row g of warp w's 16 is output column 16 w + 2 g of the tile, row g
  // + 8 the next one; each column's float offset in a stage at its row 2 t.
  // A column past DM or of a tile past nt reads column 0 and is not stored.
  int off[FM_TPW][2];
#pragma unroll
  for (int j = 0; j < FM_TPW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (t0 + j) * 64 + 16 * warp + 2 * g + h;
      const int ci = j < nt && c < p.DM ? __ldg(p.cmap + c) : 0;
      off[j][h] = (ci / p.W) * FM_R * p.W + ci % p.W + 2 * t * p.W;
    }
  float acc[FM_TPW][16];
#pragma unroll
  for (int j = 0; j < FM_TPW; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.0f;
  unsigned fr[FM_TPW][PIECES][4];
  float v[2][4];
  long long c_loop = FM_CLOCK(), c_wait = 0, c_release = 0;
  // stage s: ring slot si, its round; the rank that issues the slot's next
  // round, (s + ns) % cl
  int si = cw, round = 0, to = (cw + p.ns) % p.cl;
  for (int s = cw; s < nstage; s += 2) {
    const long long c0 = FM_CLOCK();
    if (!KO_TMA) fm_wait(full + si, round & 1);
    c_wait += FM_CLOCK() - c0;
    // the A registers are free once this warpgroup's last products have
    // read them: split the stage's tiles, then issue their products after
    // one fence, so that they run while the other warpgroup splits
    const unsigned long long desc = fm_desc(bs + s % (2 * p.ns) * FM_BBYTES, 4 * 128, 128);
    const float* x = xs + si * xstage;
    fm_load<PAIRS>(v, x, off[0], p.W, KO_LOADS || ko_alu);
    fm_wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < FM_TPW; ++j) {
      fm_split<PIECES>(v, fr[j], KO_SPLIT || ko_alu);
      if (j + 1 < FM_TPW) fm_load<PAIRS>(v, x, off[j + 1], p.W, KO_LOADS || ko_alu);
    }
    if (KO_PRODUCTS || ko_mma) {
#pragma unroll
      for (int j = 0; j < FM_TPW; ++j)
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][4 * pc + i] = __uint_as_float(__float_as_uint(acc[j][4 * pc + i]) ^ fr[j][pc][i]);
    } else {
      fm_wgmma_fence();
#pragma unroll
      for (int j = 0; j < FM_TPW; ++j)
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) fm_wgmma(acc[j], fr[j][pc], desc);
      fm_wgmma_commit();
    }
    // the stage's x is in registers: release its slot to the rank that
    // issues the slot's next round, and arm `full` for it (the stage's B, in
    // a ring twice as deep, is rewritten only after the slot's next round
    // is released, by which time this warpgroup has waited for its products)
    __syncwarp();
    const long long c1 = FM_CLOCK();
    if (lane == 0 && !KO_TMA) {
      fm_arrive_rank(empty + si, to);
      if (wt == 0 && s + p.ns < nstage) fm_expect_tx(full + si, bytes);
    }
    __syncwarp();
    c_release += FM_CLOCK() - c1;
    si += 2;
    if (si >= p.ns) si -= p.ns, ++round;
    to += 2;
    while (to >= p.cl) to -= p.cl;
  }
  fm_wgmma_wait<0>();
#ifdef FOLD_MMA_PROF
  if (wt == 0) {
    unsigned long long* prof = fm_prof[rank == 0 ? 0 : 1];
    const long long v[4] = {FM_CLOCK() - c_loop, c_wait, c_release, (nstage - cw + 1) / 2};
    for (int i = 0; i < 4; ++i) atomicAdd(prof + i, (unsigned long long)v[i]);
  }
#else
  (void)c_loop, (void)c_wait, (void)c_release;
#endif
  // every stage is consumed, so no load is in flight into the ring: it
  // carries warpgroup 2's sums to warpgroup 1 (the barriers after it stay)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (cw == 1)
#pragma unroll
    for (int j = 0; j < FM_TPW; ++j)
#pragma unroll
      for (int e = 0; e < 16; ++e) fm_smem[(j * 16 + e) * 128 + wt] = acc[j][e];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (cw == 0) {
    float* out = p.out + (size_t)b * p.A * p.DM;
#pragma unroll
    for (int j = 0; j < FM_TPW; ++j) {
      if (j >= nt) continue;
      const int c = (t0 + j) * 64 + 16 * warp + 2 * g;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        // d[i]: A row g (column c) or g + 8 (c + 1) by i / 2, n = a = 8 jn
        // + 2 t + i % 2
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          d[i] = acc[j][4 * jn + i] + fm_smem[(j * 16 + 4 * jn + i) * 128 + wt];
        const int a = 8 * jn + 2 * t;
        if (c < p.DM && a < p.A) {
          *(float2*)(out + (size_t)a * p.DM + c) = make_float2(d[0], d[2]);
          *(float2*)(out + (size_t)(a + 1) * p.DM + c) = make_float2(d[1], d[3]);
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();
}

// floats of the mxu kernel's rings (ns stages of x, 2 ns of B), at least
// what carries warpgroup 1's sums; the barriers follow them
static int fm_ring_floats(int ns, int nbox, int W) {
  const int ring = ns * (nbox * FM_R * W + 2 * FM_BBYTES / 4);
  const int sums = FM_TPW * 16 * 128;
  return ring > sums ? ring : sums;
}

static size_t fm_smem_bytes(int ns, int nbox, int W) {
  return (size_t)4 * fm_ring_floats(ns, nbox, W) + 2 * ns * 8;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to libcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
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
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

template <int K, bool VEC>
static int launch_roll(const RollArgs& a, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];  // one per instance
  RollTma p;
  // x as (DX, A, K NB) fp32 in boxes (SW, 1, K), zero past its edges
  const cuuint64_t size[3] = {(cuuint64_t)a.DX, (cuuint64_t)a.A, (cuuint64_t)K * a.NB};
  const cuuint64_t stride[2] = {(cuuint64_t)a.DX * 4, (cuuint64_t)a.A * a.DX * 4};
  const cuuint32_t box[3] = {(cuuint32_t)a.SW, 1, K}, ones[3] = {1, 1, 1};
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr ||
      enc(&p.tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)a.x, size, stride, box, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  p.out = a.out;
  p.units = a.units;
  p.uoff = a.uoff;
  p.NB = a.NB;
  p.A = a.A;
  p.DX = a.DX;
  p.DM = a.DM;
  p.SW = a.SW;
  p.nsl = a.nsl;
  p.ns = a.ns;
  p.stride = (K * a.SW + 31) / 32 * 32;
  const size_t smem = (sizeof(float) * p.stride + 2 * sizeof(unsigned long long)) * p.ns + FR_ALIGN;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  void (*fn)(RollTma) = probe_fold_roll_kernel<K, VEC>;
  cudaError_t err = raise_smem_limit((const void*)fn, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nrecv = a.NB * a.A, grid = nrecv < sms ? nrecv : sms;
  fn<<<grid, FR_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

static cudaLaunchAttribute fm_cluster_attr(int cl) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

#define FM_SHAPES 8  // cluster shapes remembered per device and instance

template <int PIECES, bool PAIRS>
static int launch_mma(const FoldArgs& a, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];
  static long long checked[MAX_DEVICES][FM_SHAPES];  // (smem << 8 | cl) found resident
  const int T = a.K * a.A;
  FoldMma p;
  // x as (NB, T, DX) fp32 in boxes (W, FM_R, 1), zero past its edges
  const cuuint64_t size[3] = {(cuuint64_t)a.DX, (cuuint64_t)T, (cuuint64_t)a.NB};
  const cuuint64_t stride[2] = {(cuuint64_t)a.DX * 4, (cuuint64_t)T * a.DX * 4};
  const cuuint32_t box[3] = {(cuuint32_t)a.W, FM_R, 1}, ones[3] = {1, 1, 1};
  // the B stages as (T / 16, FM_BBYTES / 4) 4-byte words, a box a stage
  const cuuint64_t bsize[2] = {FM_BBYTES / 4, (cuuint64_t)(T / FM_R)};
  const cuuint64_t bstride[1] = {FM_BBYTES};
  const cuuint32_t bbox[2] = {FM_BBYTES / 4, 1};
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr ||
      enc(&p.tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)a.x, size, stride, box, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&p.tmb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)a.bq, bsize, bstride, bbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  p.cmap = a.cmap;
  p.out = a.out;
  p.A = a.A;
  p.DM = a.DM;
  p.T = T;
  p.W = a.W;
  p.nbox = a.nbox;
  p.tiles = a.tiles;
  p.ctas = a.ctas;
  p.cl = a.cl;
  p.ns = a.ns;
  int g = a.ns, h = a.cl;  // per = cl / gcd(ns, cl)
  while (h) {
    const int r = g % h;
    g = h;
    h = r;
  }
  p.per = a.cl / g;
  p.ring = fm_ring_floats(a.ns, a.nbox, a.W);
  const int nstage = T / FM_R;
  probe_fold_bprep_kernel<<<(nstage * 128 + 255) / 256, 256, 0, s>>>(a.fold, T, a.A, a.bq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fm_smem_bytes(a.ns, a.nbox, a.W);
  void (*fn)(FoldMma) = probe_fold_mma_kernel<PIECES, PAIRS>;
  err = raise_smem_limit((const void*)fn, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas, a.NB);
  cfg.blockDim = dim3(FM_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1] = {fm_cluster_attr(a.cl)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const long long shape = (long long)smem << 8 | a.cl;
  int slot = -1;
  for (int i = 0; dev < MAX_DEVICES && i < FM_SHAPES && slot < 0; ++i)
    if (checked[dev][i] == shape || checked[dev][i] == 0) slot = i;
  if (slot < 0 || checked[dev][slot] != shape) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return CLUSTER_UNSCHEDULABLE;
    if (slot >= 0) checked[dev][slot] = shape;
  }
  err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Layout constants the host's plan must follow (probes/fold.py:mma_plan):
// the m64 tile, tiles a CTA, CTAs a cluster at most, the widest box, rows a
// stage, stages at most, threads, B bytes a stage.
extern "C" void probe_fold_layout(int* out) {
  const int v[] = {64, FM_TPW, FM_CLMAX, FM_BOXW, FM_R, FM_NSMAX, FM_NT, FM_BBYTES};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// FOLD_MMA_PROF builds: copies fm_prof into out (8 values) and clears it.
extern "C" int probe_fold_prof(unsigned long long* out) {
#ifdef FOLD_MMA_PROF
  cudaError_t err = cudaMemcpyFromSymbol(out, fm_prof, sizeof(fm_prof));
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fm_prof, zero, sizeof(fm_prof));
  return (int)err;
#else
  (void)out;
  return (int)cudaErrorInvalidValue;
#endif
}

// Clusters of cl CTAs of the mxu kernel (a ring of ns stages of nbox boxes
// of W columns) resident at once on the current device, or a negative CUDA
// error: what the host prints beside the plan.
extern "C" int probe_fold_clusters(int cl, int ns, int nbox, int W) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1);
  cfg.blockDim = dim3(FM_NT);
  cfg.dynamicSmemBytes = fm_smem_bytes(ns, nbox, W);
  cudaLaunchAttribute attr[1] = {fm_cluster_attr(cl)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* fn = (const void*)probe_fold_mma_kernel<3, true>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// roll / bigroll (their column maps differ): K one of FOLD_KS
// (probes/fold.py), the host's plan of probes/fold.py:roll_plan (slices of
// SW columns, a multiple of 4, the last narrower; ns stages of K SW floats;
// vec: every unit 4 columns, output and input columns multiples of 4). DX a
// multiple of 4, DM of 8, x and out 16-byte aligned; every unit inside its
// slice and the output row (not checked here).
extern "C" int probe_fold_roll_launch(int K, RollArgs p, void* stream) {
  if (p.NB <= 0 || p.A <= 0 || p.DX <= 0 || p.DX % 4 || p.DM <= 0 || p.DM % 8 || p.SW <= 0 ||
      p.SW % 4 || p.nsl != (p.DX + p.SW - 1) / p.SW || p.ns < 2 || p.ns > FR_NSMAX ||
      p.units == nullptr || p.uoff == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K * 2 + (p.vec ? 1 : 0)) {
    case 16: return launch_roll<8, false>(p, s);
    case 17: return launch_roll<8, true>(p, s);
    case 18: return launch_roll<9, false>(p, s);
    case 19: return launch_roll<9, true>(p, s);
    case 144: return launch_roll<72, false>(p, s);
    case 145: return launch_roll<72, true>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Layout constants the host's roll plan must follow (probes/fold.py):
// threads folding, stages at most.
extern "C" void probe_fold_roll_layout(int* out) {
  out[0] = 32 * FR_CW;
  out[1] = FR_NSMAX;
}

// mxu2, mxu3 (pieces 2 or 3): A 16 or 32, the plan of
// probes/fold.py:mma_plan (checked here for what the kernel needs), bq T /
// 16 KB (16-byte aligned); two launches, the fold's B stages, then the
// product. DX a multiple of 4, DM of 8, the pointers 16-byte aligned, every
// cmap entry in [0, DX) (not checked here).
extern "C" int probe_fold_launch(int pieces, FoldArgs p, void* stream) {
  if (p.NB <= 0 || p.NB > 65535 || p.K <= 0 || p.A <= 0 || p.DX <= 0 || p.DX % 4 ||
      p.DM <= 0 || p.DM % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((p.A != 16 && p.A != 32) || p.tiles != (p.DM + 63) / 64 || p.cl < 1 ||
      p.cl > FM_CLMAX || p.ctas % p.cl || p.ctas * FM_TPW < p.tiles || p.W % 8 != 4 ||
      p.W > FM_BOXW || p.nbox * p.W < p.DX || (p.nbox - 1) * p.W >= p.DX || p.ns < 2 ||
      p.ns > FM_NSMAX || p.ns % 2 || fm_smem_bytes(p.ns, p.nbox, p.W) > SMEM_LIMIT ||
      p.bq == nullptr)
    return (int)cudaErrorInvalidValue;
  if (pieces == 2) return p.pairs ? launch_mma<2, true>(p, s) : launch_mma<2, false>(p, s);
  if (pieces == 3) return p.pairs ? launch_mma<3, true>(p, s) : launch_mma<3, false>(p, s);
  return (int)cudaErrorInvalidValue;
}
