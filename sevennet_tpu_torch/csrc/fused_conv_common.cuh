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
//   z, h      the radial MLP's hidden layers, any number of them: the
//             pre-activations and silu(z) * cst                 (H_l, TE)
//   tmp       w3j_pack @ sh, one column block's rows            (TE, R_b)
//   w         the last MLP layer, the per-edge uvu weights of
//             one column block                                  (TE, W_b)
//   xs        the gathered sender features x[src]               (TE, dim_x)
//
// Column blocks: the uvu weights of instruction i are mul_i consecutive
// columns of w, and its Wigner rows consecutive rows of w3j_pack. The host
// groups consecutive instructions into blocks (ops/fused_conv.py:
// plan_blocks, the widest that let the CTA's shared memory fit; one block
// for every SevenNet-0 layer) and lists each block's columns, rows and uvu
// tasks in the int table. The kernels form w and tmp for one block, run that
// block's uvu tasks, and go on to the next, so w needs one block's columns
// of shared memory (lmax-3 widths, 1,760 columns, do not fit whole). The
// forward's blocks write disjoint output columns; the backward's add their
// dxg and their share of dz and dsh in block order, a fixed order. Block 0
// is formed by load_tile, as the whole of w was before there were blocks,
// and the backward's block 0 is an instance of its own (bwd_block<.., true>)
// that stores where the later blocks add: a layer of one block runs
// straight through, at the speed it had before blocking (PERF.md).
//
// The uvu tensor product runs from host-built task tables (instruction
// records with the Wigner row of each (m, p), and task lists): its sums
// over channels, over (edge, m) or over p are small matrix products, each
// task owned by one warp, so there are no atomics and the result does not
// depend on the launch (uvu_forward, uvu_dtmp, uvu_dxg_dw).
//
// Precision: fp32, the force budget's. The matrix products (the radial MLP's
// layers, tmp = sh w3j_pack^T, the uvu products, and in the backward their
// transposes and dsh) run on the tensor cores as 3xTF32: mma.sync.m16n8k8
// (TE = 16 edges are its M) on operands split as hi = cvt.rna.tf32(a), lo =
// cvt.rna.tf32(a - hi), accumulating lo*hi + hi*lo + hi*hi in fp32; the
// dropped lo*lo is about 2^-22 of |a b|. Emulated at W3's shapes
// (tests/test_torch_split_tf32.py) the split is within 7e-7 of the largest
// exact value, as a plain fp32 product is, where one TF32 pass is 3e-4 off.
// The rest (geometry, Bessel basis, spherical harmonics and their chain to
// the edge vector, activations) is fp32 on the CUDA cores.
//
// W3, the last layer's weights (64 x 960 fp32 for SevenNet-0, more than a
// CTA's shared memory), is staged through shared memory in sub-blocks of 64
// columns by cp.async, up to MAX_STAGES sub-blocks in flight, each CTA
// starting at its own; the forward product (w) and the backward one (dz of
// the last hidden layer) each stream it once per tile.
//
// What bounds the kernels on an H100: the two W3 products, about half of
// either kernel's time, bound by the mma.sync path of 3xTF32 (three mma and
// four cvt per k-step) and W3's streaming from L2 (PERF.md has the measured
// sections; wgmma on 64-edge tiles is the next step).
//
// Clusters: where a layer's output accumulator (forward), ybar (backward) and
// task tables do not fit a CTA whole (SevenNet-MF-ompa's widest layers, 13,504
// and 15,552 mid columns), a thread-block cluster of C CTAs (2, else 4; the
// CL instances) walks each receiver row's edges once, C CTAs side by side
// (ops/fused_conv.py:plan_blocks). Rank r owns a set of x irreps: their
// columns of the x tile and of an on-chip dxg tile, the instructions that
// read them, those instructions' columns of w (W3's columns by a map, a
// block's gmap) and their output columns. Every output column and every
// dxg column thus belongs to one rank: the forward's ranks write disjoint
// outputs, and the backward's add their dxg over their blocks in shared
// memory and store each tile's rows once. What the ranks share is the last
// hidden layer's dz and dsh (each rank's blocks add their share, without
// silu'): after a cluster barrier rank 0 reads the other ranks' partial sums
// through distributed shared memory, adds them in rank order (fixed, so the
// result does not depend on the launch), applies silu', and alone runs the
// chain down the hidden layers to demb and dvec (or writes demb and dsh) and
// B2''s per-edge records but dw (each rank writes its own dw columns). A
// second barrier, split (arrive after the sums, wait before the next tile's
// first partial sum), keeps the other ranks from overwriting a partial sum
// that rank 0 has not read yet. The backward holds ybar a column block at a
// time (the block's instructions' outputs are a run of the rank's, read
// from device memory by asynchronous copies while the block's w is formed),
// which leaves room for wider blocks. The geometry, MLP hidden layers and
// the rank's x[src] columns are formed once per tile in each CTA. What
// bounds the cluster form on an H100 (conv_breakdown.py): as on one CTA,
// the two W3 products (about half of B2's cycles) and the uvu pullback
// (about a third); the cluster adds its barrier waits and rank 0's sums,
// 3-9 % of the cycles, mostly the other ranks waiting while rank 0 runs
// the chain, which the host weighs when it splits the irreps
// (ops/fused_conv.py:_rank_cost). A layer that fits one CTA (every
// SevenNet-0 and l3i5 layer, mf-ompa's layers 0, 1 and 4) runs the one-CTA
// instances (CL false) unchanged.
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
#define NWARP (NT / 32)
#define TE 16      // edges per tile: the M of mma.m16n8k8
#define BN 64      // W3 columns per staged block: one 8-column k-step per warp
#define SBF (BN + 8)  // row stride of a staged block for the forward product
#define SBB (BN + 4)  // and for the backward product (conflict-free fragments)
#define OG 64      // hidden units per pass of the backward product
#define MAX_STAGES 4       // W3 blocks in flight, fewer where shared memory is short
#define SMEM_LIMIT 232448  // dynamic shared memory a CTA may have on sm_90
#define MAX_MLP 8          // radial-MLP weight matrices (hidden layers + 1)
#define FS (TE + 4)        // row stride of a feature-major tile (4 mod 8: conflict-free fragments)

// Layer description, filled by sevennet_tpu_torch/ops/fused_conv.py
// (ctypes mirror: _ConvDims). All fields are 4 bytes: no padding.
struct ConvDims {
  int N, K, dim_x, dim_mid, numel;
  int rblk;          // Wigner rows of the widest column block (tmp, dtmp)
  int dim_f, n_basis;
  int nh, hsum, hl;  // the radial MLP's hidden layers: count, total and last width
  int wblk;          // columns of the widest column block of w
  int cutoff_kind;   // 0 = polynomial (p = cutoff_arg), 1 = XPLOR (r_on = cutoff_arg)
  float cutoff, cutoff_arg, act_cst;
  // offsets (in ints) into the int table, which starts with the uvu tables
  int sh_terms, n_sh, shd_terms, n_shd;
  // offsets (in floats) into the float table, which starts with w3j_pack
  int sh_coef, shd_coef;
};

// The radial MLP's weight matrices, layer l (n_in x n_out) at w[l], the
// last one (W3 above) at w[nh]; ctypes mirror: _MlpWeights.
struct MlpWeights {
  const float* w[MAX_MLP];
};

// w[l] by selects on constant indices: a dynamic index into a kernel
// parameter would copy the struct to the stack.
__device__ __forceinline__ const float* mlp_weight(const MlpWeights& W, int l) {
  const float* p = W.w[0];
#pragma unroll
  for (int j = 1; j < MAX_MLP; ++j) p = l == j ? W.w[j] : p;
  return p;
}

// Shared-memory carve-up of one CTA. The row strides of xs and ws put a
// warp's mma fragments in distinct banks: 4 (mod 32) in the backward, whose
// fragments are (edge g, column q) (dtmp, the dz product), 8 in the
// forward, whose uvu fragments are (edge q, channel g). tmp's rows are odd.
// The hidden layers lie in zh, layer l as z_l (h_l x TE) then h_l (h_l x
// TE); the backward writes dz_l over z_l, but the last layer's dz, which the
// column blocks add up, has a buffer of its own (dzl).
struct Tile {
  int *slots, *count, *srcs, *flats;
  unsigned char* valid;
  float *geo, *embT, *sh, *tmp, *zh, *hlT, *xs, *ws;
  float *outacc;                              // forward only
  float *yb, *dtmp, *dzl, *demb, *dsh;        // backward only
  float* dxt;    // a cluster's backward: the rank's dxg columns of the tile (row stride SX)
  float* stage;  // nstage staged W3 sub-blocks; the backward's dz partial sums
  int* tabs;     // the int table's first tab_ints(d) ints: uvu and monomial tables
  int SX, SW, SR, nstage;
};

// Entry (edge e, column c) of the x, w and tmp tiles: edge-major, or
// feature-major (FEAT, carve<true>).
template <bool FEAT>
__device__ __forceinline__ float& xs_at(const Tile& t, int e, int c) {
  return FEAT ? t.xs[c * t.SX + e] : t.xs[e * t.SX + c];
}
template <bool FEAT>
__device__ __forceinline__ float& ws_at(const Tile& t, int e, int c) {
  return FEAT ? t.ws[c * t.SW + e] : t.ws[e * t.SW + c];
}
template <bool FEAT>
__device__ __forceinline__ float& tmp_at(const Tile& t, int e, int r) {
  return FEAT ? t.tmp[r * t.SR + e] : t.tmp[e * t.SR + r];
}

// Section clocks for the breakdown of a kernel's time (profile builds only:
// ops/kernels.py builds a separate library with -DFUSED_CONV_PROFILE, which
// no wrapper loads). Thread 0 of each CTA adds the clock64() cycles since
// the previous mark to section s, after a barrier, and at the end writes
// the CTA's NSEC sums to g_prof[blockIdx.x * NSEC + s]. In other builds
// every method is empty and the struct vanishes.
#define NSEC 12
struct Prof {
#ifdef FUSED_CONV_PROFILE
  long long last, acc[NSEC];
  __device__ void start() {
    for (int s = 0; s < NSEC; ++s) acc[s] = 0;
    last = clock64();
  }
  __device__ void mark(int s) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      acc[s] += now - last;
      last = now;
    }
  }
  __device__ void store();
#else
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void store() {}
#endif
};

#ifdef FUSED_CONV_PROFILE
__device__ long long* g_prof;
__device__ void Prof::store() {
  if (threadIdx.x == 0 && g_prof)
    for (int s = 0; s < NSEC; ++s) g_prof[(size_t)blockIdx.x * NSEC + s] = acc[s];
}
// Points the profile build's kernels at a (grid, NSEC) int64 buffer.
extern "C" int fused_conv_prof_set(long long* buf) {
  return (int)cudaMemcpyToSymbol(g_prof, &buf, sizeof(buf));
}
#endif

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// the least stride >= n that is rem (mod 32)
__host__ __device__ inline int bank_stride(int n, int rem) { return n + ((rem - n) % 32 + 32) % 32; }

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// nstage W3 sub-blocks of round8(hl) rows (at least OG), and at least the
// backward product's NWARP x TE x OG partial sums (row stride SBF), which
// reuse the same floats.
__host__ __device__ inline int stage_floats(const ConvDims& d, int nstage) {
  const int rows = round8(d.hl) > OG ? round8(d.hl) : OG;
  const int n = nstage * rows * SBF;
  return n > NWARP * TE * SBF ? n : NWARP * TE * SBF;
}

// ybar (mblk columns at most: the row's, or a cluster's column block's) is kept skewed in shared memory,
// column c at c + c / 32 (yb_at), so that the uvu pullback's fragments,
// which step through ybar by an output block's channel count (often a
// multiple of 32), fall in distinct banks.
__host__ __device__ inline int yb_floats(int mblk) { return mblk + (mblk >> 5) + 1; }
__host__ __device__ inline int yb_at(int c) { return c + (c >> 5); }

// The int table up to the end of the monomial terms of the spherical
// harmonics' derivatives (a rank's uvu tables, sh terms, dsh terms, their
// components): copied to shared memory once per CTA, since the tiles read
// it in dependent chains.
__host__ __device__ inline int tab_ints(const ConvDims& d) { return d.shd_terms + 5 * d.n_shd; }

// Copies the tables into t.tabs; the caller's next barrier publishes them.
__device__ inline void load_tabs(const ConvDims& d, const Tile& t, const int* __restrict__ itab) {
  for (int k = threadIdx.x; k < tab_ints(d); k += NT) t.tabs[k] = itab[k];
}

// The rank fields of a table's header (ops/fused_conv.py: H_NEXT ..): the
// next rank's table in itab (0 after the last), the rank's x columns, its
// output columns, the place of its x column map in the table (XMAP columns
// an entry), its instructions; and in each instruction record the layer's
// first mid column of its outputs and its group's channels.
#define H_NEXT 10
#define H_XW 11
#define H_MW 19
#define H_XMAP 20
#define H_NK 21
#define UVU_GY 57
#define UVU_GUT 58
#define GMAP 8  // W3 columns per entry of a cluster block's column map
#define XMAP 4  // x columns per entry of a rank's x column map

// Copies rank r's uvu tables (each rank's table is d.sh_terms ints, padded,
// rank 0's at the start of itab, each linked from the one before) and the
// monomial terms into t.tabs; the caller's next barrier publishes them.
__device__ inline void load_rank_tabs(const ConvDims& d, const Tile& t, const int* __restrict__ itab,
                                      int r) {
  int off = 0;
  for (int j = 0; j < r; ++j) off = itab[off + H_NEXT];
  for (int k = threadIdx.x; k < tab_ints(d); k += NT) t.tabs[k] = itab[k < d.sh_terms ? off + k : k];
}

// ---------------------------------------------------------------------------
// Thread-block clusters (sm_90)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}

// The two halves of a cluster barrier: every thread of every CTA of the
// cluster arrives (release: its earlier shared-memory writes and reads are
// ordered before), then waits (acquire) until all have.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of *p in rank r's shared memory (distributed shared memory).
__device__ __forceinline__ const float* peer(const float* p, int r) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(r));
  return (const float*)out;
}

__host__ __device__ inline size_t take(size_t& off, size_t nbytes) {
  size_t o = off;
  off += (nbytes + 15) & ~size_t(15);
  return o;
}

// Assigns the pointers of t inside base (when base is non-null) and
// returns the bytes the layout needs, for a CTA that holds mblk output
// columns (< 0: dim_mid; the forward's accumulator, the backward's ybar)
// and, on a cluster, xw columns of x (< 0: one CTA, all of x; a cluster's
// backward also holds its dxg tile). The host calls it with base = null,
// and keeps a copy of it (ops/fused_conv.py:carve_bytes) that plans the
// ranks and column blocks; fused_conv_smem_bytes lets it check the two
// agree. FEAT (the breakdown probes' feature-major tiles, forward only):
// xs, ws and tmp are stored transposed, (features, TE), every row FS floats
// apart.
template <bool FEAT = false>
__host__ __device__ inline size_t carve(const ConvDims& d, bool bwd, char* base, Tile* t,
                                        int mblk = -1, int xw = -1) {
  if (mblk < 0) mblk = d.dim_mid;
  size_t off = 0;
  const int rem = bwd ? 4 : 8;
  const int SX = FEAT ? FS : bank_stride(xw < 0 ? d.dim_x : xw, rem),
            SW = FEAT ? FS : bank_stride(d.wblk, rem),
            SR = FEAT ? FS : odd_stride(d.rblk);
  // rows of the three tiles and the floats of each row
  const int nx = FEAT ? d.dim_x : TE, nw = FEAT ? d.wblk : TE, nr = FEAT ? d.rblk : TE;
  size_t o_dxt = 0;
  size_t o_slots = take(off, sizeof(int) * d.K);
  size_t o_valid = take(off, d.K);
  size_t o_count = take(off, sizeof(int) * 4);
  size_t o_srcs = take(off, sizeof(int) * TE);
  size_t o_flats = take(off, sizeof(int) * TE);
  size_t o_geo = take(off, sizeof(float) * TE * 8);
  size_t o_emb = take(off, sizeof(float) * TE * d.n_basis);
  size_t o_sh = take(off, sizeof(float) * TE * d.dim_f);
  size_t o_tmp = take(off, sizeof(float) * nr * SR);
  size_t o_zh = take(off, sizeof(float) * TE * 2 * d.hsum);
  size_t o_xs = take(off, sizeof(float) * nx * SX);
  size_t o_ws = take(off, sizeof(float) * nw * SW);
  size_t o_tabs = take(off, sizeof(int) * tab_ints(d));
  size_t o_out = 0, o_yb = 0, o_dtmp = 0, o_dzl = 0, o_demb = 0, o_dsh = 0;
  if (!bwd) {
    o_out = take(off, sizeof(float) * mblk);
  } else {
    o_yb = take(off, sizeof(float) * yb_floats(mblk));
    o_dtmp = take(off, sizeof(float) * TE * SR);
    o_dzl = take(off, sizeof(float) * TE * d.hl);
    o_demb = take(off, sizeof(float) * TE * d.n_basis);
    o_dsh = take(off, sizeof(float) * TE * d.dim_f);
    if (xw >= 0) o_dxt = take(off, sizeof(float) * TE * SX);
  }
  // last: as many W3 sub-blocks in flight as the CTA's shared memory
  // allows, on a 128-byte boundary (its phase against 128 bytes moved the
  // one-CTA kernels' times by a few per cent on the card; this one measured
  // best, PERF.md)
  off = (off + 127) & ~size_t(127);
  int nstage = MAX_STAGES;
  while (nstage > 2 && off + sizeof(float) * stage_floats(d, nstage) > SMEM_LIMIT) --nstage;
  size_t o_stage = take(off, sizeof(float) * stage_floats(d, nstage));
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
    t->zh = (float*)(base + o_zh);
    // h of the last hidden layer, or with none the embedding (hl = n_basis)
    t->hlT = d.nh > 0 ? t->zh + TE * (2 * (d.hsum - d.hl) + d.hl) : t->embT;
    t->xs = (float*)(base + o_xs);
    t->ws = (float*)(base + o_ws);
    t->stage = (float*)(base + o_stage);
    t->tabs = (int*)(base + o_tabs);
    t->outacc = bwd ? nullptr : (float*)(base + o_out);
    t->yb = bwd ? (float*)(base + o_yb) : nullptr;
    t->dtmp = bwd ? (float*)(base + o_dtmp) : nullptr;
    t->dzl = bwd ? (float*)(base + o_dzl) : nullptr;
    t->demb = bwd ? (float*)(base + o_demb) : nullptr;
    t->dsh = bwd ? (float*)(base + o_dsh) : nullptr;
    t->dxt = bwd && xw >= 0 ? (float*)(base + o_dxt) : nullptr;
    t->SX = SX;
    t->SW = SW;
    t->SR = SR;
    t->nstage = nstage;
  }
  return off;
}

// The bytes of carve's layout for a layer, so that the host can check its
// copy (ops/fused_conv.py:check_carve) before a layer shape's first launch.
extern "C" long long fused_conv_smem_bytes(ConvDims d, int bwd, int mblk, int xw) {
  return (long long)carve(d, bwd != 0, nullptr, nullptr, mblk, xw);
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

// What a cluster launch returns when no cluster of its shape can be
// resident on the device (cudaOccupancyMaxActiveClusters gives 0); the
// host raises on it (ops/kernels.py).
#define CLUSTER_UNSCHEDULABLE (-2)

// Launches kernel fn on grid CTAs of NT threads in clusters of cl (grid a
// multiple of cl) with smem bytes of dynamic shared memory, raising its
// limit first (raise_smem_limit, limit_by_device); at the first launch of
// each shape (smem, cl) on a device it checks that such a cluster can be
// resident. Returns cudaGetLastError() after the launch, or
// CLUSTER_UNSCHEDULABLE.
#define CLUSTER_SHAPES 8  // shapes remembered per device and kernel
template <typename... Params, typename... Args>
static int launch_cluster(void (*fn)(Params...), int grid, int cl, size_t smem, void* stream,
                          int* limit_by_device, Args... args) {
  static long long checked[MAX_DEVICES][CLUSTER_SHAPES];  // (smem << 8 | cl) found resident
  cudaError_t err = raise_smem_limit((const void*)fn, smem, limit_by_device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const long long shape = (long long)smem << 8 | cl;
  int slot = -1;
  for (int s = 0; dev < MAX_DEVICES && s < CLUSTER_SHAPES && slot < 0; ++s)
    if (checked[dev][s] == shape || checked[dev][s] == 0) slot = s;
  if (slot < 0 || checked[dev][slot] != shape) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return CLUSTER_UNSCHEDULABLE;
    if (slot >= 0) checked[dev][slot] = shape;
  }
  if (grid > 0) {
    err = cudaLaunchKernelEx(&cfg, fn, args...);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
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

// ---------------------------------------------------------------------------
// W3 products on the tensor cores at fp32 accuracy (3xTF32)
// ---------------------------------------------------------------------------

// a = hi + lo, both rounded to TF32 (10-bit mantissa); hi*hi + hi*lo + lo*hi
// leaves out lo*lo, about 2^-22 of |a b|.
__device__ __forceinline__ unsigned tf32_rna(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8) b (8 x 8), one TF32 mma.sync. Fragments (g =
// lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, on split fragments: the two small products first.
// PASSES = 1 (the breakdown probes, csrc/probe_breakdown.cuh) keeps only
// hi*hi: one TF32 pass, the counterpart of a TPU dot at default precision;
// the lo halves are then dead and not computed.
template <int PASSES = 3>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const float (&b)[2]) {
  static_assert(PASSES == 1 || PASSES == 3, "one TF32 pass or three");
  unsigned bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  if constexpr (PASSES == 3) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
  }
  mma_tf32(c, ah, bh);
}

// The same three products, each into its own accumulator (c[0..2]): three
// independent mma chains instead of one; add them with sum3.
template <int PASSES = 3>
__device__ __forceinline__ void mma_3xtf32_3(float (&c)[3][4], const unsigned (&ah)[4],
                                             const unsigned (&al)[4], const float (&b)[2]) {
  static_assert(PASSES == 1 || PASSES == 3, "one TF32 pass or three");
  unsigned bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  if constexpr (PASSES == 3) {
    mma_tf32(c[0], al, bh);
    mma_tf32(c[1], ah, bl);
  }
  mma_tf32(c[2], ah, bh);
}

__device__ __forceinline__ void sum3(const float (&c)[3][4], float (&out)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (c[0][i] + c[1][i]) + c[2][i];
}

__device__ __forceinline__ void zero3(float (&c)[3][4]) {
#pragma unroll
  for (int z = 0; z < 3; ++z) c[z][0] = c[z][1] = c[z][2] = c[z][3] = 0.0f;
}

__device__ __forceinline__ void split4(const float (&a)[4], unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// ---------------------------------------------------------------------------
// W3 staged through shared memory by asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// waits for every committed group but the newest n (n < MAX_STAGES) of them
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A column block of w (ops/fused_conv.py:_uvu_tables): its first column of
// w (and of W3), width, first Wigner row and rows, and where its record
// lies in the table (the offsets of its warps' runs of each uvu task list
// follow at rec + 4, 5, 6; read where a step starts, not held across the
// block).
#define UVU_BLK 12
#define UVU_HEADER 24  // the header's ints; the block records follow it
#define UVU_MLP 12     // the hidden widths' place in the header
struct Blk {
  int c0, width, r0, rows, rec;
};

__device__ __forceinline__ int n_blocks(const int* tab) { return tab[9]; }

__device__ __forceinline__ Blk uvu_blk(const int* tab, int b) {
  const int rec = UVU_HEADER + b * UVU_BLK;
  return Blk{tab[rec], tab[rec + 1], tab[rec + 2], tab[rec + 3], rec};
}

// A cluster block's W3 column map (GMAP columns an entry), its first
// instruction and instructions, and its first output column and output
// columns in the rank's (the run of ybar the backward holds for it).
__device__ __forceinline__ const int* blk_gmap(const int* tab, const Blk& B) { return tab + tab[B.rec + 7]; }
__device__ __forceinline__ int blk_k0(const int* tab, const Blk& B) { return tab[B.rec + 8]; }
__device__ __forceinline__ int blk_nk(const int* tab, const Blk& B) { return tab[B.rec + 9]; }
__device__ __forceinline__ int blk_y0(const int* tab, const Blk& B) { return tab[B.rec + 10]; }

// W3's column of column j of a block's staging (w3_sub_col's columns):
// j itself, or on a cluster (whose blocks' columns start at 0) by the
// block's map.
template <bool CL>
__device__ __forceinline__ int w3_col(const int* gmap, int j) {
  return CL ? gmap[j / GMAP] + j % GMAP : j;
}

// Width of hidden layer l.
__device__ __forceinline__ int hidden_width(const Tile& t, int l) { return t.tabs[UVU_MLP + l]; }

// z of hidden layer l; its h follows at + TE * hidden_width(t, l).
__device__ __forceinline__ float* hidden_z(const Tile& t, int l) {
  float* z = t.zh;
  for (int j = 0; j < l; ++j) z += 2 * TE * hidden_width(t, j);
  return z;
}

// The CTAs walk a block's 64-column W3 sub-blocks from different starts
// (CTA i from sub-block i mod nsub), so that at any time they read all of
// the block and not the same few L2 lines. Column of the jb-th sub-block
// this CTA multiplies.
__device__ __forceinline__ int w3_sub_col(const Blk& B, int jb) {
  const int nsub = (B.width + BN - 1) / BN;
  int b = jb + (int)(blockIdx.x % nsub);
  if (b >= nsub) b -= nsub;
  return B.c0 + b * BN;
}

// Starts the copy of W3[row0 : row0 + nrows, j0 : j0 + BN] into dst (row
// stride sb floats) and commits it as one group; rows past hl and columns
// past jend (the end of the block) are filled with zeros. 16-byte copies
// where W3's rows and the block's ends allow. CL: the columns are the
// block's own, W3's by the map gmap (GMAP columns an entry, each entry on
// a 16-byte boundary).
template <bool CL = false>
__device__ inline void stage_w3(const ConvDims& d, const float* __restrict__ W3, float* dst,
                                int row0, int nrows, int j0, int jend, int sb,
                                const int* gmap = nullptr) {
  const bool wide = ((d.numel | j0 | jend) & 3) == 0 && ((uintptr_t)W3 & 15) == 0;
  if (wide) {
    for (int idx = threadIdx.x; idx < nrows * (BN / 4); idx += NT) {
      const int r = idx / (BN / 4), c = (idx - r * (BN / 4)) * 4;
      const int k = row0 + r, j = j0 + c;
      const bool ok = k < d.hl && j < jend;
      cp_async16(dst + r * sb + c, ok ? W3 + (size_t)k * d.numel + w3_col<CL>(gmap, j) : W3,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * BN; idx += NT) {
      const int r = idx / BN, c = idx - r * BN;
      const int k = row0 + r, j = j0 + c;
      const bool ok = k < d.hl && j < jend;
      cp_async4(dst + r * sb + c, ok ? W3 + (size_t)k * d.numel + w3_col<CL>(gmap, j) : W3,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The first W3 sub-block of block B for the forward product, into buffer 0.
template <bool CL = false>
__device__ __forceinline__ void stage_w3_first(const ConvDims& d, const float* __restrict__ W3,
                                               const Tile& t, const Blk& B) {
  stage_w3<CL>(d, W3, t.stage, 0, round8(d.hl), w3_sub_col(B, 0), B.c0 + B.width, SBF,
               CL ? blk_gmap(t.tabs, B) : nullptr);
}

// Powers u^a, a <= 3, of a unit-vector component, by selects instead of a
// dynamically indexed table (which would live on the stack); u2 = u * u,
// u3 = u2 * u, the order in which x^p = x^(p-1) * x forms them.
struct Pow3 {
  float u1, u2, u3;
  __device__ __forceinline__ explicit Pow3(float u) : u1(u), u2(u * u), u3(u * u * u) {}
  __device__ __forceinline__ float operator()(int a) const {
    return a == 0 ? 1.0f : (a == 1 ? u1 : (a == 2 ? u2 : u3));
  }
};

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

// A fragments of the last hidden layer (TE x hl, stored transposed) for
// the 8 k-steps of hidden units kg * 64 .., split into hi and lo; zero past
// hl.
__device__ __forceinline__ void hl_fragments(const ConvDims& d, const Tile& t, int kg,
                                             unsigned (&ah)[8][4], unsigned (&al)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int k = kg * 64 + ks * 8 + q;
    float a[4];
    a[0] = k < d.hl ? t.hlT[k * TE + g] : 0.0f;
    a[1] = k < d.hl ? t.hlT[k * TE + g + 8] : 0.0f;
    a[2] = k + 4 < d.hl ? t.hlT[(k + 4) * TE + g] : 0.0f;
    a[3] = k + 4 < d.hl ? t.hlT[(k + 4) * TE + g + 8] : 0.0f;
    split4(a, ah[ks], al[ks]);
  }
}

// The last MLP layer on column block B, w (TE x B.width) = h (TE x hl)
// W3[:, block] / sqrt(hl), written to t.ws: 3xTF32 mma.sync over sub-blocks
// of BN columns that stage_w3 copies into t.stage, t.nstage - 1 in flight
// ahead of the one multiplied. Warp w owns the 8-column n-tile w of each
// sub-block; its A fragments (h, split into hi and lo) stay in registers
// across the sub-blocks, 64 hidden units at a time. The caller has issued
// the first sub-block into buffer 0 (stage_w3_first). PASSES: TF32 passes
// of each product (3, or 1 for the breakdown probes); FEAT: w stored
// transposed (carve<true>); CL: a cluster's block (stage_w3).
template <int PASSES = 3, bool FEAT = false, bool CL = false>
__device__ inline void w3_forward(const ConvDims& d, const Tile& t, const float* __restrict__ W3,
                                  const Blk& B) {
  const int* gmap = CL ? blk_gmap(t.tabs, B) : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h2p = round8(d.hl);
  const int nblk = (B.width + BN - 1) / BN;
  const int jend = B.c0 + B.width;
  const int S = t.nstage;
  const int nkg = (h2p + 63) / 64;  // groups of 64 hidden units (8 k-steps)
  const float inv_h2 = (float)(1.0 / sqrt((double)d.hl));
  for (int jb = 1; jb < S - 1 && jb < nblk; ++jb)
    stage_w3<CL>(d, W3, t.stage + jb * h2p * SBF, 0, h2p, w3_sub_col(B, jb), jend, SBF, gmap);
  unsigned ah[8][4], al[8][4];
  if (nkg == 1) hl_fragments(d, t, 0, ah, al);
  for (int jb = 0; jb < nblk; ++jb) {
    const int ahead = jb + S - 1;
    if (ahead < nblk)
      stage_w3<CL>(d, W3, t.stage + (ahead % S) * h2p * SBF, 0, h2p, w3_sub_col(B, ahead), jend,
                   SBF, gmap);
    cp_async_wait(min(S - 1, nblk - 1 - jb));
    __syncthreads();
    const float* Bs = t.stage + (jb % S) * h2p * SBF;
    const int j = w3_sub_col(B, jb) + warp * 8;
    if (j < jend) {
      float c3[3][4], c[4];
      zero3(c3);
      for (int kg = 0; kg < nkg; ++kg) {
        if (nkg > 1) hl_fragments(d, t, kg, ah, al);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int k = kg * 64 + ks * 8;
          if (k < h2p) {
            const float b[2] = {Bs[(k + q) * SBF + warp * 8 + g], Bs[(k + q + 4) * SBF + warp * 8 + g]};
            mma_3xtf32_3<PASSES>(c3, ah[ks], al[ks], b);
          }
        }
      }
      sum3(c3, c);
      const int j0 = j + 2 * q;
      const int c0 = j0 - B.c0;
      if (j0 < jend) {
        ws_at<FEAT>(t, g, c0) = c[0] * inv_h2;
        ws_at<FEAT>(t, g + 8, c0) = c[2] * inv_h2;
      }
      if (j0 + 1 < jend) {
        ws_at<FEAT>(t, g, c0 + 1) = c[1] * inv_h2;
        ws_at<FEAT>(t, g + 8, c0 + 1) = c[3] * inv_h2;
      }
    }
    __syncthreads();
  }
}

// out (TE x n_out) = in (TE x n_in) M on the tensor cores in 3xTF32: in[e][k]
// at in[k * ik + e * ie] in shared memory, M[k][n] at M[k * sk + n * sn] in
// global memory, and out[e][n] at out[n * on + e * oe] = epilogue(sum, n, e).
// Warps over the 8-wide n-tiles. PASSES: TF32 passes (3, or 1 for the
// breakdown probes).
template <int PASSES = 3, typename Epi>
__device__ inline void small_product(const float* in, int ik, int ie, int n_in,
                                     const float* __restrict__ M, int sk, int sn, int n_out,
                                     float* out, int on, int oe, Epi epilogue) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  for (int n0 = warp * 8; n0 < n_out; n0 += NWARP * 8) {
    float c6[2][3][4], c[4], c1[4];
    zero3(c6[0]);
    zero3(c6[1]);
    const int n = n0 + g;
    for (int k00 = 0; k00 < n_in; k00 += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // two k-steps, two sets of accumulators
        const int k = k00 + 8 * h + q;
        float a[4];
        a[0] = k < n_in ? in[k * ik + g * ie] : 0.0f;
        a[1] = k < n_in ? in[k * ik + (g + 8) * ie] : 0.0f;
        a[2] = k + 4 < n_in ? in[(k + 4) * ik + g * ie] : 0.0f;
        a[3] = k + 4 < n_in ? in[(k + 4) * ik + (g + 8) * ie] : 0.0f;
        unsigned ah[4], al[4];
        split4(a, ah, al);
        const float b[2] = {
            k < n_in && n < n_out ? __ldg(M + (size_t)k * sk + (size_t)n * sn) : 0.0f,
            k + 4 < n_in && n < n_out ? __ldg(M + (size_t)(k + 4) * sk + (size_t)n * sn) : 0.0f};
        mma_3xtf32_3<PASSES>(c6[h], ah, al, b);
      }
    }
    sum3(c6[0], c);
    sum3(c6[1], c1);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += c1[i];
    const int c0 = n0 + 2 * q;
    if (c0 < n_out) {
      out[c0 * on + g * oe] = epilogue(c[0], c0, g);
      out[c0 * on + (g + 8) * oe] = epilogue(c[2], c0, g + 8);
    }
    if (c0 + 1 < n_out) {
      out[(c0 + 1) * on + g * oe] = epilogue(c[1], c0 + 1, g);
      out[(c0 + 1) * on + (g + 8) * oe] = epilogue(c[3], c0 + 1, g + 8);
    }
  }
}

// ---------------------------------------------------------------------------
// The uvu tensor product on the tensor cores
// ---------------------------------------------------------------------------
//
// For instruction (x irrep of d1 components and mul channels, output irrep
// of d3 components) and edge e, the product reads x[e, m, u], w[e, u] and
// tmp[e, r(m, p)], r the Wigner row of the pair (m, p). Its sums over the
// channels u or over (edge, m) are small matrix products, which run as
// 3xTF32 mma.sync over task tables that the host builds
// (sevennet_tpu_torch/ops/fused_conv.py:_uvu_tables) at the start of itab,
// each list in runs per warp balanced by the host; the kernels read them
// from the CTA's shared-memory copy (t.tabs).
#define UVU_INS 64
#define UVU_D 7

// The task tables' layout, which the host checks its copy against before
// its first launch (ops/fused_conv.py: UVU_WARPS, UVU_INS, UVU_MAX_D,
// UVU_BLK, MAX_MLP, UVU_HEADER): the host balances the tasks into exactly
// NWARP runs.
extern "C" void fused_conv_uvu_layout(int* out) {
  out[0] = NWARP;
  out[1] = UVU_INS;
  out[2] = UVU_D;
  out[3] = UVU_BLK;
  out[4] = MAX_MLP;
  out[5] = UVU_HEADER;
}

struct UvuIns {  // an instruction's record
  int x_start, d1, d3, mul;
  int w_start;      // first column in its block of w
  int y_start, u_tot;
  const int* rtab;  // rtab[m * UVU_D + p]: Wigner row of (m, p) in its block, -1 if none
};

__device__ __forceinline__ UvuIns uvu_ins(const int* tab, int k) {
  const int* rec = tab + tab[0] + k * UVU_INS;
  return UvuIns{rec[0], rec[1], rec[2], rec[3], rec[4], rec[5], rec[6], rec + 8};
}

// Forward: out[c(p, u)] += sum over the tile's (edge, m) of x[e, m, u] w[e, u]
// tmp[e, r(m, p)], a (16 channels x 16 d1) by (16 d1 x d3) product per task
// (instruction, 16 channels from u0), its k dimension walked as (m, 8 edges).
// Each output column belongs to one task: no two warps add to it. The
// tasks of column block B.
__device__ inline void uvu_forward(const Tile& t, const Blk& B) {
  const int* tab = t.tabs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int* tasks = tab + tab[7];
  const int* runs = tab + tab[B.rec + 6];
  for (int task = runs[warp]; task < runs[warp + 1]; ++task) {
    const UvuIns I = uvu_ins(tab, tasks[4 * task]);
    const int u0 = tasks[4 * task + 1];
    const int ua = u0 + g, ub = u0 + g + 8;  // A rows (channels)
    float c6[2][3][4];
    zero3(c6[0]);
    zero3(c6[1]);
    for (int m = 0; m < I.d1; ++m) {
      const int rb = g < I.d3 ? I.rtab[m * UVU_D + g] : -1;  // B column p = g
      const int xm = I.x_start + m * I.mul;
#pragma unroll
      for (int e0 = 0; e0 < TE; e0 += 8) {
        const int ea = e0 + q, eb = e0 + q + 4;  // k = edges
        float a[4];
        a[0] = ua < I.mul ? t.xs[ea * t.SX + xm + ua] * t.ws[ea * t.SW + I.w_start + ua] : 0.0f;
        a[1] = ub < I.mul ? t.xs[ea * t.SX + xm + ub] * t.ws[ea * t.SW + I.w_start + ub] : 0.0f;
        a[2] = ua < I.mul ? t.xs[eb * t.SX + xm + ua] * t.ws[eb * t.SW + I.w_start + ua] : 0.0f;
        a[3] = ub < I.mul ? t.xs[eb * t.SX + xm + ub] * t.ws[eb * t.SW + I.w_start + ub] : 0.0f;
        const float b[2] = {rb >= 0 ? t.tmp[ea * t.SR + rb] : 0.0f,
                            rb >= 0 ? t.tmp[eb * t.SR + rb] : 0.0f};
        unsigned ah[4], al[4];
        split4(a, ah, al);
        mma_3xtf32_3(c6[e0 / 8], ah, al, b);
      }
    }
    float c0[4], c1[4];
    sum3(c6[0], c0);
    sum3(c6[1], c1);
    const int p = 2 * q;
    if (ua < I.mul && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ua] += c0[0] + c1[0];
    if (ua < I.mul && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ua] += c0[1] + c1[1];
    if (ub < I.mul && p < I.d3) t.outacc[I.y_start + p * I.u_tot + ub] += c0[2] + c1[2];
    if (ub < I.mul && p + 1 < I.d3) t.outacc[I.y_start + (p + 1) * I.u_tot + ub] += c0[3] + c1[3];
  }
}

// Backward, dtmp[e, r(m, p)] = sum_u x[e, m, u] w[e, u] ybar[p, u]: per task
// (instruction, m) a (TE x mul) by (mul x d3) product, k over the channels.
// Six accumulators (two k-step parities times the three products) keep the
// mma chains short. Each Wigner row belongs to one (instruction, m, p). The
// tasks of column block B, whose rows dtmp holds; CL: ybar's column c lies
// at yb_at(c - yoff) (a cluster holds the block's run of ybar from yoff).
template <bool CL = false>
__device__ inline void uvu_dtmp(const Tile& t, const Blk& B, int yoff = 0) {
  if (!CL) yoff = 0;
  const int* tab = t.tabs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int* tasks = tab + tab[2];
  const int* runs = tab + tab[B.rec + 4];
  for (int task = runs[warp]; task < runs[warp + 1]; ++task) {
    const UvuIns I = uvu_ins(tab, tasks[4 * task]);
    const int m = tasks[4 * task + 1];
    const int xm = I.x_start + m * I.mul;
    float cc[6][4];
#pragma unroll
    for (int z = 0; z < 6; ++z) cc[z][0] = cc[z][1] = cc[z][2] = cc[z][3] = 0.0f;
    for (int k0 = 0; k0 < I.mul; k0 += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = k0 + 8 * h + q, v = u + 4;
        float a[4], b[2];
        a[0] = u < I.mul ? t.xs[g * t.SX + xm + u] * t.ws[g * t.SW + I.w_start + u] : 0.0f;
        a[1] = u < I.mul ? t.xs[(g + 8) * t.SX + xm + u] * t.ws[(g + 8) * t.SW + I.w_start + u] : 0.0f;
        a[2] = v < I.mul ? t.xs[g * t.SX + xm + v] * t.ws[g * t.SW + I.w_start + v] : 0.0f;
        a[3] = v < I.mul ? t.xs[(g + 8) * t.SX + xm + v] * t.ws[(g + 8) * t.SW + I.w_start + v] : 0.0f;
        b[0] = u < I.mul && g < I.d3 ? t.yb[yb_at(I.y_start - yoff + g * I.u_tot + u)] : 0.0f;
        b[1] = v < I.mul && g < I.d3 ? t.yb[yb_at(I.y_start - yoff + g * I.u_tot + v)] : 0.0f;
        unsigned ah[4], al[4], bh[2], bl[2];
        split4(a, ah, al);
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[1], bh[1], bl[1]);
        mma_tf32(cc[3 * h], al, bh);
        mma_tf32(cc[3 * h + 1], ah, bl);
        mma_tf32(cc[3 * h + 2], ah, bh);
      }
    }
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = ((cc[0][i] + cc[1][i]) + (cc[3][i] + cc[4][i])) + (cc[2][i] + cc[5][i]);
    const int p = 2 * q;
    const int r0 = p < I.d3 ? I.rtab[m * UVU_D + p] : -1;
    const int r1 = p + 1 < I.d3 ? I.rtab[m * UVU_D + p + 1] : -1;
    if (r0 >= 0) {
      t.dtmp[g * t.SR + r0] = c[0];
      t.dtmp[(g + 8) * t.SR + r0] = c[2];
    }
    if (r1 >= 0) {
      t.dtmp[g * t.SR + r1] = c[1];
      t.dtmp[(g + 8) * t.SR + r1] = c[3];
    }
  }
}

// Backward, a[e, m, u] = sum_p ybar[p, u] tmp[e, r(m, p)] (one (TE x d3) by
// (d3 x 8) product per instruction, m and 8 channels), then dxg[e, m, u] +=
// w[e, u] a and dw[e, u] = sum_m x[e, m, u] a. A task (x irrep, 8 channels
// from u0, column block B) walks every instruction of the block that reads
// the irrep, so it owns its dxg columns and, per instruction, its dw
// columns: dxg goes to global memory (rows e < ne), or on a cluster (CL) to
// the CTA's dxg tile t.dxt (every row; the caller stores the tile), dw over
// w in t.ws (dtmp, which reads w, is done). Block 0's tasks write the dxg of
// every x irrep of the CTA (zeros where none of its instructions reads it);
// the later blocks' (ACC) add to it. yoff: as uvu_dtmp.
template <bool ACC, bool CL = false>
__device__ inline void uvu_dxg_dw(const ConvDims& d, const Tile& t, int ne,
                                  float* __restrict__ dxg, const Blk& B, int yoff = 0) {
  if (!CL) yoff = 0;
  const int* tab = t.tabs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int* tasks = tab + tab[4];
  const int* list = tab + tab[5];
  const int* runs = tab + tab[B.rec + 5];
  for (int task = runs[warp]; task < runs[warp + 1]; ++task) {
    const int* T = tasks + 8 * task;
    const int x_start = T[0], d1 = T[1], mul = T[2], l0 = T[3], nl = T[4], u0 = T[5];
    // C fragment positions: rows e = g, g + 8; channels u = u0 + 2q, + 1
    const int e_[4] = {g, g, g + 8, g + 8};
    const int uc = u0 + 2 * q;
    const bool ok[4] = {uc < mul, uc + 1 < mul, uc < mul, uc + 1 < mul};
    float dx[UVU_D][4];
#pragma unroll
    for (int m = 0; m < UVU_D; ++m) dx[m][0] = dx[m][1] = dx[m][2] = dx[m][3] = 0.0f;

    for (int li = 0; li < nl; ++li) {
      const UvuIns I = uvu_ins(tab, list[l0 + li]);
      float wv[4], dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = ok[i] ? t.ws[e_[i] * t.SW + I.w_start + uc + (i & 1)] : 0.0f;
      // this lane's Wigner rows, loaded together ahead of the m steps
      int ra[UVU_D], rb[UVU_D];
#pragma unroll
      for (int m = 0; m < UVU_D; ++m) {
        ra[m] = m < d1 && q < I.d3 ? I.rtab[m * UVU_D + q] : -1;
        rb[m] = m < d1 && q + 4 < I.d3 ? I.rtab[m * UVU_D + q + 4] : -1;
      }
      const bool bq = q < I.d3 && u0 + g < mul, bq4 = q + 4 < I.d3 && u0 + g < mul;
      const float b[2] = {bq ? t.yb[yb_at(I.y_start - yoff + q * I.u_tot + u0 + g)] : 0.0f,
                          bq4 ? t.yb[yb_at(I.y_start - yoff + (q + 4) * I.u_tot + u0 + g)] : 0.0f};
#pragma unroll
      for (int m = 0; m < UVU_D; ++m) {
        if (m < d1) {
          float a[4];
          a[0] = ra[m] >= 0 ? t.tmp[g * t.SR + ra[m]] : 0.0f;
          a[1] = ra[m] >= 0 ? t.tmp[(g + 8) * t.SR + ra[m]] : 0.0f;
          a[2] = rb[m] >= 0 ? t.tmp[g * t.SR + rb[m]] : 0.0f;
          a[3] = rb[m] >= 0 ? t.tmp[(g + 8) * t.SR + rb[m]] : 0.0f;
          unsigned ah[4], al[4];
          split4(a, ah, al);
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_3xtf32(c, ah, al, b);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = ok[i] ? t.xs[e_[i] * t.SX + x_start + m * mul + uc + (i & 1)] : 0.0f;
            dx[m][i] += wv[i] * c[i];
            dw[i] += xv * c[i];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i]) t.ws[e_[i] * t.SW + I.w_start + uc + (i & 1)] = dw[i];
    }
#pragma unroll
    for (int m = 0; m < UVU_D; ++m) {
      if (m < d1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (CL && ok[i]) {
            float* p = t.dxt + e_[i] * t.SX + x_start + m * mul + uc + (i & 1);
            *p = ACC ? *p + dx[m][i] : dx[m][i];
          } else if (!CL && ok[i] && e_[i] < ne) {
            float* p = dxg + (size_t)t.flats[e_[i]] * d.dim_x + x_start + m * mul + uc + (i & 1);
            *p = ACC ? __ldcg(p) + dx[m][i] : dx[m][i];
          }
      }
    }
  }
}

// tmp (TE x B.rows) = sh w3j_pack[B's rows]^T, 3xTF32 on the tensor cores
// (PASSES, FEAT: as w3_forward; sh and tmp are then stored transposed).
template <int PASSES = 3, bool FEAT = false>
__device__ __forceinline__ void block_tmp(const ConvDims& d, const Tile& t,
                                          const float* __restrict__ ftab, const Blk& B) {
  if constexpr (FEAT)
    small_product<PASSES>(t.sh, TE, 1, d.dim_f, ftab + (size_t)B.r0 * d.dim_f, 1, d.dim_f, B.rows,
                          t.tmp, t.SR, 1, [](float v, int, int) { return v; });
  else
    small_product<PASSES>(t.sh, 1, d.dim_f, d.dim_f, ftab + (size_t)B.r0 * d.dim_f, 1, d.dim_f,
                          B.rows, t.tmp, 1, t.SR, [](float v, int, int) { return v; });
}

// What load_tile forms of the radial MLP's output w: the MLP (MLP_FULL);
// the breakdown probes' knock-out, w[e, c] = 0.1 emb[e, 0] with no MLP
// layer and no W3 staged (MLP_KNOCK); nothing (MLP_NONE).
#define MLP_FULL 0
#define MLP_KNOCK 1
#define MLP_NONE 2

// The knock-out's w of column block B: every column 0.1 emb[e, 0] (rows e
// >= ne are zero with emb). The caller's next barrier publishes it.
template <bool FEAT>
__device__ __forceinline__ void knock_w(const Tile& t, const Blk& B) {
  for (int idx = threadIdx.x; idx < TE * B.width; idx += NT) {
    const int e = idx / B.width;
    ws_at<FEAT>(t, e, idx - e * B.width) = t.embT[e] * 0.1f;
  }
}

// Fills one tile of ne <= TE edges (slots t0 .. t0+ne of the list) up to
// w and tmp of column block B0, the layer's first. Rows e >= ne are zero,
// so loops may run over all TE rows. (ea, eb) are (vec, coef) in vec mode
// and (emb, sh) in emb/sh mode. The breakdown probes (csrc/probe_breakdown.cuh,
// emb/sh mode only) set the rest: TF32 passes of the MLP and tmp products
// (PASSES), feature-major tiles (FEAT), what is formed of w (MLP) and
// whether tmp is (TMP); the defaults are B1's and B4's tile. CL: a
// cluster's CTA, which gathers its rank's columns of x (the x column map)
// and forms its block's w by the block's W3 column map.
template <bool EMBSH, int PASSES = 3, bool FEAT = false, int MLP = MLP_FULL, bool TMP = true,
          bool CL = false>
__device__ inline void load_tile(const ConvDims& d, const Tile& t, int i, int t0, int ne,
                                 const float* __restrict__ x, const int* __restrict__ src,
                                 const float* __restrict__ ea, const float* __restrict__ eb,
                                 const MlpWeights& W, const float* __restrict__ W3,
                                 const float* __restrict__ ftab, const Blk& B0, Prof& prof) {
  static_assert(EMBSH || (PASSES == 3 && !FEAT && MLP == MLP_FULL && TMP),
                "the probes' tiles are emb/sh mode");
  const int tid = threadIdx.x;
  const int NK = d.N * d.K;
  const int NB = d.n_basis, DF = d.dim_f;
  // W3's first sub-block is copied while the tile's inputs are formed
  if constexpr (MLP == MLP_FULL) stage_w3_first<CL>(d, W3, t, B0);
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
      const float v = e < ne ? eb[(size_t)(i * d.K + t.slots[t0 + e]) * DF + (idx - e * DF)] : 0.0f;
      if constexpr (FEAT)
        t.sh[(idx - e * DF) * TE + e] = v;
      else
        t.sh[idx] = v;
    }
  } else {
    // (a) geometry, a thread per edge; then the Bessel embedding, a thread
    // per (basis function, edge), and the spherical harmonics, a thread per
    // (edge, harmonic) summing its monomial terms in table order
    if (tid < TE) {
      const int e = tid;
      float* g = t.geo + e * 8;
      if (e < ne) {
        const int flat = i * d.K + t.slots[t0 + e];
        t.flats[e] = flat;
        t.srcs[e] = src[flat];
        const float v0 = ea[flat], v1 = ea[NK + flat], v2 = ea[2 * NK + flat];
        const float r = fmaxf(sqrtf(v0 * v0 + v1 * v1 + v2 * v2), 1e-12f);
        const float rinv = 1.0f / r;
        float env, denv;
        envelope(d, r, env, denv);
        g[0] = r; g[1] = rinv; g[2] = v0 * rinv; g[3] = v1 * rinv; g[4] = v2 * rinv;
        g[5] = env; g[6] = denv; g[7] = 0.0f;
      } else {
        t.flats[e] = -1;
        t.srcs[e] = 0;
        for (int k = 0; k < 8; ++k) g[k] = 0.0f;
      }
    }
    __syncthreads();
    const float pref = (float)(2.0 / (double)d.cutoff);
    for (int idx = tid; idx < TE * NB; idx += NT) {
      const int n = idx / TE, e = idx - n * TE;
      const float* g = t.geo + e * 8;
      t.embT[idx] = e < ne ? sinf(eb[n] * g[0]) * (pref * g[1] * g[5]) : 0.0f;
    }
    const int4* st = (const int4*)(t.tabs + d.sh_terms);
    const float* sc = ftab + d.sh_coef;
    for (int idx = tid; idx < TE * DF; idx += NT) {
      const int e = idx / DF, f = idx - e * DF;
      const float* g = t.geo + e * 8;
      float acc = 0.0f;
      if (e < ne) {
        const Pow3 px(g[2]), py(g[3]), pz(g[4]);
        for (int qt = 0; qt < d.n_sh; ++qt) {
          const int4 tm = st[qt];  // (f, a, b, c)
          if (tm.x == f) acc += sc[qt] * (px(tm.y) * py(tm.z) * pz(tm.w));
        }
      }
      t.sh[idx] = acc;
    }
  }
  __syncthreads();
  prof.mark(1);
  // (b) the x[src] rows by asynchronous copies (zeros past ne): the uvu
  // step reads them after w3_forward's first wait, which covers this group.
  // Feature-major: 4-byte copies, a warp along a row's columns.
  if constexpr (CL) {
    // the rank's columns, XMAP at a time from the layer's (x column map)
    const int xn = t.tabs[H_XW];
    const int* xmap = t.tabs + t.tabs[H_XMAP];
    if ((d.dim_x & 3) == 0 && ((uintptr_t)x & 15) == 0) {
      const int c4 = xn >> 2;
      for (int idx = tid; idx < TE * c4; idx += NT) {
        const int e = idx / c4, c = idx - e * c4;
        const bool ok = e < ne;
        cp_async16(t.xs + e * t.SX + 4 * c, ok ? x + (size_t)t.srcs[e] * d.dim_x + xmap[c] : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < TE * xn; idx += NT) {
        const int e = idx / xn, c = idx - e * xn;
        const bool ok = e < ne;
        cp_async4(t.xs + e * t.SX + c,
                  ok ? x + (size_t)t.srcs[e] * d.dim_x + xmap[c / XMAP] + c % XMAP : x, ok ? 4 : 0);
      }
    }
  } else if constexpr (FEAT) {
    for (int idx = tid; idx < TE * d.dim_x; idx += NT) {
      const int e = idx / d.dim_x, c = idx - e * d.dim_x;
      const bool ok = e < ne;
      cp_async4(t.xs + c * t.SX + e, ok ? x + (size_t)t.srcs[e] * d.dim_x + c : x, ok ? 4 : 0);
    }
  } else if ((d.dim_x & 3) == 0 && ((uintptr_t)x & 15) == 0) {
    const int c4 = d.dim_x >> 2;
    for (int idx = tid; idx < TE * c4; idx += NT) {
      const int e = idx / c4, c = (idx - e * c4) * 4;
      const bool ok = e < ne;
      cp_async16(t.xs + e * t.SX + c, ok ? x + (size_t)t.srcs[e] * d.dim_x + c : x, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < TE * d.dim_x; idx += NT) {
      const int e = idx / d.dim_x, c = idx - e * d.dim_x;
      const bool ok = e < ne;
      cp_async4(t.xs + e * t.SX + c, ok ? x + (size_t)t.srcs[e] * d.dim_x + c : x, ok ? 4 : 0);
    }
  }
  cp_async_commit();
  // (c) tmp of block 0 and (d) the MLP's hidden layers, each z = h W /
  // sqrt(n_in) and h = silu(z) * cst, 3xTF32 on the tensor cores
  if constexpr (TMP) block_tmp<PASSES, FEAT>(d, t, ftab, B0);
  if constexpr (MLP == MLP_FULL) {
    const float cst = d.act_cst;
    const float* in = t.embT;
    int n_in = NB;
    float* zT = t.zh;
    for (int l = 0; l < d.nh; ++l) {
      const int h = hidden_width(t, l);
      const float inv = (float)(1.0 / sqrt((double)n_in));
      float* hT = zT + TE * h;
      small_product<PASSES>(in, TE, 1, n_in, mlp_weight(W, l), h, 1, h, hT, TE, 1,
                            [=](float v, int o, int e) {
                              const float z = v * inv;
                              zT[o * TE + e] = z;
                              return z * sigmoidf_(z) * cst;
                            });
      __syncthreads();
      prof.mark(l == 0 ? 2 : 10);
      in = hT;
      n_in = h;
      zT = hT + TE * h;
    }
    // (f) block 0's columns of w, the last MLP layer on the tensor cores
    w3_forward<PASSES, FEAT, CL>(d, t, W3, B0);
  } else {
    // no MLP: the knock-out's w, or none; then the x rows' wait
    if constexpr (MLP == MLP_KNOCK) knock_w<FEAT>(t, B0);
    cp_async_wait(0);
    __syncthreads();
  }
  prof.mark(3);
}
