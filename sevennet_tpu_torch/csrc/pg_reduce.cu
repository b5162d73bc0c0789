// Second pass of B2' and B4': the radial MLP's weight gradients and, in vec
// mode, dcoef, summed over the per-edge records that the first pass
// (fused_conv_bwd.cu: fused_conv_bwd_pg_launch, fused_conv_bwd_embsh_pg_launch)
// writes into the workspace. For each weight matrix dW_l = A_l^T B_l /
// sqrt(d_in) over the rows with valid != 0 (A_l, B_l: column ranges of a
// record; ops/fused_conv.py:_reduce_products), and dcoef = the column sums
// of the dc terms.
//
// Replaces: the in-kernel dW accumulation of the Pallas TPU backward,
// sevennet_tpu/ops/fused_conv.py:1060-1072 (dW_l) and :1089-1098 (dcoef),
// which adds each grid step's sums into its output because the TPU grid
// runs in order. Here CTAs run in no order, so the sums go by row chunk to
// a partial buffer and a second kernel adds the chunks in chunk order: the
// result depends only on the shapes, never on the launch.
//
// What bounds it on an H100: bytes. Each record is read once (4 (sum of the
// MLP's widths in and out + n_basis) bytes a valid row: 849 MB at a
// 3,000-atom SevenNet-0 layer 1-3 shape, 0.253 ms at 3.35 TB/s), while the
// products, as 3xTF32 on the tensor cores, need 0.138 ms there; 0.997 ms
// per 3,000-atom pass in all. mma.sync does not reach that: at 3xTF32 it
// runs about 32 TFLOP/s on this card (PERF.md, the PR 6 probes), below
// torch.mm's fp32 rate, so the products run on wgmma. Measured (PERF.md,
// PR 10), the copies hold it back: the copying warps' issue waits on the
// memory system, and with fewer copying warps, with bulk copies of each row
// segment (cp.async.bulk) from one warp, or with the TMA's 2D boxes the
// kernel was slower.
//
// The design:
//   - one launch for every product's partial sums: the host lists the
//     output tiles of all products (ops/fused_conv.py:reduce_tiles) and the
//     grid walks tile x row chunk, chunk-major, so the CTAs that read the
//     same rows run together and the columns that several tiles share (the
//     narrow side of a wide product) come from L2. dcoef is a product with
//     a ones column, on the tensor cores too. The chunk size follows the
//     row count (ops/fused_conv.py:reduce_chunk: about one chunk per SM). A
//     second launch adds the partials.
//   - a tile is C (M x N) = sum over rows of M-side columns (x) N-side
//     columns, M the wider operand (up to PG_TM = 128 columns, an m64 tile
//     for each of two consuming warpgroups), N the narrower (up to PG_TN =
//     64; a product with a side of at most 8 columns, dW1 and dcoef, runs
//     n8). The products are 3xTF32 (fp32 accuracy, the split of
//     fused_conv_common.cuh: lo*hi + hi*lo + hi*hi) on wgmma.mma_async
//     m64nNk8: the M operand from registers, loaded and split per thread
//     from the staged rows; the N operand from shared memory, where TF32
//     wgmma takes only K-major tiles, so each stage's N rows are split and
//     written transposed into hi and lo core-matrix tiles (8 columns x 4
//     rows, no swizzle), a small pass since N is the narrow side.
//   - the tensor cores add into their accumulator with truncation, so each
//     stage's products go to a fresh accumulator that is then added to a
//     running fp32 sum.
//   - warp-specialized over a ring of PG_STAGES stages of PG_RK rows: 8
//     warps copy (16-byte cp.async, completion counted on an mbarrier), 4
//     transpose, 8 (two warpgroups) run the products (pg_partial_kernel).
//     A field of the record need not start on a 16-byte boundary (at odd
//     MLP widths), so each row's copies take the aligned superset of the
//     field's columns and the fragments read from the field's first column
//     on (the host requires a 16-byte aligned workspace). Rows past the
//     chunk or with valid == 0 are zero-filled by the copies themselves
//     (source size 0), in both operands: an invalid record may hold
//     anything (NaN), and 0 x NaN is NaN inside an mma.
//   - staged rows padded to 8 (mod 32) words, so that the M fragment loads
//     (row t, column g) and the transposing reads of a warp hit 32 distinct
//     banks.
#include "fused_conv_common.cuh"

#define PG_CWG 2                       // consuming warpgroups, an m64 tile each
#define PG_CPW 8                       // copying warps
#define PG_CP0 (32 * PG_CPW)           // first transposing thread
#define PG_CS0 (PG_CP0 + 128)          // first consuming thread
#define PG_NT (PG_CS0 + 128 * PG_CWG)  // threads per CTA
#define PG_TM (64 * PG_CWG)            // tile rows: the M side's columns
#define PG_TN 64                       // tile columns: the N side's
#define PG_RK 16                       // workspace rows per stage: two k8 steps
#define PG_KS (PG_RK / 8)              // k8 steps a stage
#define PG_STAGES 8                    // stage buffers in the ring
#define PG_SA (PG_TM + 8)              // row stride of a staged M tile (8 mod 32)
#define PG_SB (PG_TN + 8)              // and of an N tile
#define PG_BT (PG_TN * PG_RK)          // floats of a transposed N tile (hi or lo)
#define PG_MAX_CHUNK 4096              // rows of a chunk (its validity bytes in shared memory)
#define PG_MAX_TILES 64                // output tiles of a call
#define PG_MAX_PROD (MAX_MLP + 1)      // products: a weight matrix each, and dcoef
// a stage buffer: M rows, N rows, the N rows transposed (hi, lo)
#define PG_STAGE_FLOATS (PG_RK * (PG_SA + PG_SB) + 2 * PG_BT)
#define PG_SMEM (PG_STAGES * (PG_STAGE_FLOATS * 4 + 3 * 8) + PG_MAX_CHUNK)

// One output tile (ops/fused_conv.py:reduce_tiles builds them). Each
// operand is copied from record column *_col on, *_cols floats a row (both
// multiples of 4), and its fragments read *_len columns from *_col + *_sh
// on. n_col < 0: the N operand is a ones column (n_len 1). Entry (m, n) of
// the tile is partial element out + m sm + n sn of the chunk's partial sums.
struct PgTile {
  int m_col, m_sh, m_cols, m_len;
  int n_col, n_sh, n_cols, n_len;
  int out, sm, sn;
};

struct PgPlan {
  const float* work;             // (rows, stride) records
  const unsigned char* valid;    // (rows,)
  float* partial;                // (n_chunks, total)
  int rows, stride, chunk, n_tiles, total;
  PgTile tile[PG_MAX_TILES];
};

// ---------------------------------------------------------------------------
// wgmma m64nNk8, TF32, A from registers, B a K-major tile in shared memory
// ---------------------------------------------------------------------------

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading byte offset (between core matrices adjacent in K) and stride byte
// offset (between 8-column groups), in 16-byte units (as probe_mm.cu's).
__device__ __forceinline__ unsigned long long pg_desc(const float* smem, int lbo, int sbo) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x N) = a (64 x 8) b (8 x N), + d if accumulate: warp w of the
// warpgroup holds rows 16 w + g, + 8 of a as mma.sync's m16n8k8 A fragment,
// and of d, n8 group j at d[4j .. 4j+3] (columns 8j + 2t, + 1).
__device__ __forceinline__ void wgmma_n8(float* d, const unsigned (&a)[4], unsigned long long b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float* d, const unsigned (&a)[4], unsigned long long b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void pg_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void pg_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void pg_wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory ordered before async-proxy reads
// (wgmma's)
__device__ __forceinline__ void pg_fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned pg_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void pg_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(pg_smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void pg_mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(pg_smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void pg_mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(pg_smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// the partial sums
// ---------------------------------------------------------------------------

// Rows [kb, kb + PG_RK) of the chunk (first row r0, nr rows) into stage
// buffer (As, Bs), by the copying warps: warp w takes rows w, w + PG_CPW,
// .., its lanes the 16-byte pieces of each row's M and N columns (none for
// a ones column); a row past the chunk or invalid is zero-filled by the
// copies themselves. Each thread then has bar count the completion of its
// copies.
__device__ __forceinline__ void pg_stage(const PgPlan& p, const PgTile& T, int r0, int nr, int kb,
                                         const unsigned char* vs, float* As, float* Bs,
                                         unsigned long long* bar) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = T.n_col < 0 ? 0 : T.n_cols;
#pragma unroll
  for (int i = 0; i < PG_RK / PG_CPW; ++i) {
    const int rr = warp + PG_CPW * i, r = kb + rr;
    const bool ok = r < nr && vs[r];
    const float* row = p.work + (size_t)(r0 + (ok ? r : 0)) * p.stride;
    for (int c = 4 * lane; c < T.m_cols; c += 128)
      cp_async16(As + rr * PG_SA + c, row + T.m_col + c, ok ? 16 : 0);
    for (int c = 4 * lane; c < nq; c += 128)
      cp_async16(Bs + rr * PG_SB + c, row + T.n_col + c, ok ? 16 : 0);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(pg_smem_addr(bar))
               : "memory");
}

// The partial sums of tile blockIdx.x % n_tiles over row chunk blockIdx.x /
// n_tiles, warp-specialized over a ring of PG_STAGES stage buffers (each
// the stage's M rows, N rows, and the N rows split and transposed), with
// three mbarriers a buffer:
//   - warps 0 .. PG_CPW - 1 copy: they wait until the consumers have
//     released the buffer (`empty`), then issue the stage's copies, whose
//     completion `rows` counts (pg_stage);
//   - the next 4 warps transpose: they wait for the rows, write the N rows split
//     into hi and lo K-major tiles (a thread per column and 4-row group; a
//     ones column is written into every buffer at the start) and arrive on
//     `ready`;
//   - the last PG_CWG warpgroups compute, each its m64 tile of the output: per
//     stage they wait for `ready`, load and split their M fragments, issue
//     three wgmma (lo*hi, hi*lo, hi*hi) per k8 step into a fresh
//     accumulator, wait for them, release the buffer and add the
//     accumulator to the running sum. Copies and transposes run ahead by
//     the ring, and one consumer's products run while the other loads.
//     (Overlapping a warpgroup's own stages, with two accumulators, made
//     ptxas serialize every wgmma: it reads the flushed accumulator as one
//     of the pipeline's.)
// The tensor cores add into an accumulator with truncation, so a chain over
// the whole chunk would drift by up to about half an ulp of the sum per k8
// step; here the stage's six products are the longest chain, and the sums
// over stages are rounded fp32 adds (chip_smoke.py holds both against a
// float64 sum). Both consumer
// warpgroups issue their m64 tile whatever m_len is (rows past it are not
// stored), and the roles branch on a warp-uniform value, so that ptxas
// does not serialize the wgmma.
__global__ void __launch_bounds__(PG_NT, 1) pg_partial_kernel(const __grid_constant__ PgPlan p) {
  extern __shared__ float4 pg_smem[];
  float* ring = (float*)pg_smem;
  unsigned long long* bars = (unsigned long long*)(ring + PG_STAGES * PG_STAGE_FLOATS);
  unsigned long long* rows_full = bars;
  unsigned long long* ready = bars + PG_STAGES;
  unsigned long long* empty = bars + 2 * PG_STAGES;
  unsigned char* vs = (unsigned char*)(bars + 3 * PG_STAGES);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int z = blockIdx.x / p.n_tiles;
  const PgTile T = p.tile[blockIdx.x - z * p.n_tiles];
  const int r0 = z * p.chunk, nr = min(p.chunk, p.rows - r0);
  const int nsteps = (nr + PG_RK - 1) / PG_RK;
  const bool ones = T.n_col < 0, n8 = T.n_len <= 8;
  const int G = n8 ? 1 : PG_TN / 8;  // 8-column groups of the N tile
  auto As = [&](int b) { return ring + b * PG_STAGE_FLOATS; };
  auto Bs = [&](int b) { return ring + b * PG_STAGE_FLOATS + PG_RK * PG_SA; };
  auto Bt = [&](int b) { return ring + b * PG_STAGE_FLOATS + PG_RK * (PG_SA + PG_SB); };
  for (int r = tid; r < nsteps * PG_RK; r += PG_NT) vs[r] = r < nr ? p.valid[r0 + r] : 0;
  if (tid < PG_STAGES) {
    pg_mbar_init(rows_full + tid, PG_CP0);
    pg_mbar_init(ready + tid, 128);
    pg_mbar_init(empty + tid, 4 * PG_CWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ones) {
    // B[k][n] = 1 for n = 0: hi 1, lo 0, in every buffer
    for (int q = tid; q < PG_STAGES * 8 * PG_RK; q += PG_NT) {
      const int b = q / (8 * PG_RK), i = q - b * 8 * PG_RK;
      Bt(b)[i] = (i >> 2 & 7) == 0 ? 1.0f : 0.0f;
      Bt(b)[PG_BT + i] = 0.0f;
    }
  }
  pg_fence_async_shared();
  __syncthreads();

  if (tid < PG_CP0) {
    for (int s = 0; s < nsteps; ++s) {
      const int b = s % PG_STAGES;
      if (s >= PG_STAGES) pg_mbar_wait(empty + b, (s / PG_STAGES - 1) & 1);
      pg_stage(p, T, r0, nr, s * PG_RK, vs, As(b), Bs(b), rows_full + b);
    }
    return;
  }
  if (tid < PG_CS0) {
    const int nc = G * 8;
    for (int s = 0; s < nsteps; ++s) {
      const int b = s % PG_STAGES;
      pg_mbar_wait(rows_full + b, (s / PG_STAGES) & 1);
      if (!ones) {
        // a thread per (column n, 4-row group kg): 4 rows in, a float4 of
        // hi and one of lo out, core matrix (kg, n / 8), its row n % 8
        const float* B = Bs(b) + T.n_sh;
        float* hi = Bt(b);
        for (int q = tid - PG_CP0; q < nc * (PG_RK / 4); q += 128) {
          const int n = q % nc, kg = q / nc;
          const float* src = B + 4 * kg * PG_SB + n;
          unsigned h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(src[i * PG_SB], h[i], l[i]);
          const int at = (kg * G + (n >> 3)) * 32 + (n & 7) * 4;
          *(uint4*)(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
          *(uint4*)(hi + PG_BT + at) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        pg_fence_async_shared();
      }
      pg_mbar_arrive(ready + b);
    }
    return;
  }

  // consumers: rows 16 w + g, + 8 of the tile, w their warp among them
  const int g = lane >> 2, t = lane & 3;
  const int m = 16 * (warp - PG_CS0 / 32) + g;
  float acc[32], sum[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = sum[j] = 0.0f;
  for (int s = 0; s < nsteps; ++s) {
    const int b = s % PG_STAGES;
    const unsigned parity = (s / PG_STAGES) & 1;
    pg_mbar_wait(rows_full + b, parity);
    pg_mbar_wait(ready + b, parity);
    const float* A = As(b) + T.m_sh + m;
    unsigned fr[PG_KS][2][4];  // M fragments of the stage: hi, lo
#pragma unroll
    for (int ks = 0; ks < PG_KS; ++ks) {
      const float* a0 = A + (8 * ks + t) * PG_SA;
      const float a[4] = {a0[0], a0[8], a0[4 * PG_SA], a0[4 * PG_SA + 8]};
      split4(a, fr[ks][0], fr[ks][1]);
    }
    unsigned long long dh[PG_KS], dl[PG_KS];
#pragma unroll
    for (int ks = 0; ks < PG_KS; ++ks) {
      // k step ks: core rows 8 ks .. 8 ks + 7, two row groups of G core matrices
      dh[ks] = pg_desc(Bt(b) + 2 * ks * G * 32, G * 128, 128);
      dl[ks] = pg_desc(Bt(b) + PG_BT + 2 * ks * G * 32, G * 128, 128);
    }
    pg_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PG_KS; ++ks) {
      if (n8) {
        wgmma_n8(acc, fr[ks][1], dh[ks], ks);
        wgmma_n8(acc, fr[ks][0], dl[ks], 1);
        wgmma_n8(acc, fr[ks][0], dh[ks], 1);
      } else {
        wgmma_n64(acc, fr[ks][1], dh[ks], ks);
        wgmma_n64(acc, fr[ks][0], dl[ks], 1);
        wgmma_n64(acc, fr[ks][0], dh[ks], 1);
      }
    }
    pg_wgmma_commit();
    pg_wgmma_wait0();
    // the stage's products are done: its buffer back, its sum added
    __syncwarp();
    if (lane == 0) pg_mbar_arrive(empty + b);
#pragma unroll
    for (int j = 0; j < 32; ++j) sum[j] += acc[j];
  }

  float* out = p.partial + (size_t)z * p.total + T.out;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int mh = m + (h >> 1) * 8, nh = n + (h & 1);
      if (mh < T.m_len && nh < T.n_len) out[mh * T.sm + nh * T.sn] = sum[4 * j + h];
    }
  }
}

struct PgFinal {
  const float* partial;  // (n_chunks, total)
  float* out[PG_MAX_PROD];
  int begin[PG_MAX_PROD + 1];  // product p: outputs [begin[p], begin[p + 1]) of the total
  float scale[PG_MAX_PROD];
  int n_prod, n_chunks, total;
};

// out[p][o - begin[p]] = scale[p] * sum over chunks, in chunk order, of
// partial[chunk, o]
__global__ void __launch_bounds__(PG_NT) pg_final_kernel(const __grid_constant__ PgFinal f) {
  const int o = blockIdx.x * PG_NT + threadIdx.x;
  if (o >= f.total) return;
  int p = 0;
  while (p + 1 < f.n_prod && o >= f.begin[p + 1]) ++p;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < f.n_chunks; ++c) s += f.partial[(size_t)c * f.total + o];
  f.out[p][o - f.begin[p]] = s * f.scale[p];
}

static int smem_limit[MAX_DEVICES];

// Layout constants the host's tile table must follow (ops/fused_conv.py:
// check_reduce_layout): threads, tile rows and columns, rows per stage,
// staged row strides, largest chunk, tiles and products of a call.
extern "C" void pg_reduce_layout(int* out) {
  const int v[] = {PG_NT, PG_TM, PG_TN, PG_RK, PG_SA, PG_SB, PG_MAX_CHUNK, PG_MAX_TILES,
                   PG_MAX_PROD};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// tiles: n_tiles x 11 ints (struct PgTile); prods: n_prod products, outputs
// [begins[p], begins[p + 1]) of total, each to outs[p] scaled by scales[p].
// work must be 16-byte aligned, stride a multiple of 4. partial holds
// ceil(rows / chunk) * total floats. Two launches, none when rows is 0 but
// the final one (zeros). Returns cudaGetLastError().
extern "C" int pg_reduce_launch(const int* tiles, int n_tiles, const int* begins,
                                const float* scales, float* const* outs, int n_prod,
                                const float* work, const unsigned char* wvalid, int rows,
                                int stride, int chunk, float* partial, void* stream) {
  if (n_tiles > PG_MAX_TILES || n_prod > PG_MAX_PROD || chunk > PG_MAX_CHUNK || chunk % PG_RK ||
      ((size_t)work & 15) || stride % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (rows + chunk - 1) / chunk;
  const int total = begins[n_prod];
  if (n_chunks > 0 && n_tiles > 0) {
    cudaError_t err = raise_smem_limit((const void*)pg_partial_kernel, PG_SMEM, smem_limit);
    if (err != cudaSuccess) return (int)err;
    PgPlan p;
    p.work = work;
    p.valid = wvalid;
    p.partial = partial;
    p.rows = rows;
    p.stride = stride;
    p.chunk = chunk;
    p.n_tiles = n_tiles;
    p.total = total;
    for (int i = 0; i < n_tiles; ++i) {
      const int* e = tiles + 11 * i;
      p.tile[i] = PgTile{e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7], e[8], e[9], e[10]};
    }
    pg_partial_kernel<<<n_chunks * n_tiles, PG_NT, PG_SMEM, s>>>(p);
  }
  PgFinal f;
  f.partial = partial;
  for (int i = 0; i < n_prod; ++i) {
    f.out[i] = outs[i];
    f.scale[i] = scales[i];
  }
  for (int i = 0; i <= n_prod; ++i) f.begin[i] = begins[i];
  f.n_prod = n_prod;
  f.n_chunks = n_chunks;
  f.total = total;
  if (total > 0) pg_final_kernel<<<(total + PG_NT - 1) / PG_NT, PG_NT, 0, s>>>(f);
  return (int)cudaGetLastError();
}
