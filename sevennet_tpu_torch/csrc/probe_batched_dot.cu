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
// writes Y once, about 2.03 GB for 12.3 GFLOP (6 operations a byte), far
// below the 3xTF32 tensor cores' rate per byte. So the design streams: each
// item's S (d3 x Kd1) and XW (Kd1 x mul) rows arrive by 16-byte cp.async
// into one of two shared-memory buffers while the CTA multiplies the
// other's, and the product runs as the conv's 3xTF32 mma.sync
// (fused_conv_common.cuh: mma_3xtf32_3): M = d3 padded to 16 or 32 rows, a
// warp per (16-row, 8-column) output tile, k over K d1. `rep` > 1 repeats
// the product on the staged item (each repetition recomputes the same Y),
// which times the tensor-core step apart from the stream.
#include "fused_conv_common.cuh"

#define BD_GROUPS 3
#define BD_NT 256

struct BdGroup {
  const float* S;   // (N, d3, kk)
  const float* XW;  // (N, kk, mul)
  float* Y;         // (N, d3, mul)
  int d3, kk, mul;
};

struct BdArgs {
  BdGroup g[BD_GROUPS];
  int N, rep;
};

// row strides in shared memory: fragments (row g, k q) of S and (k q, col
// g) of XW fall in distinct banks
__host__ __device__ inline int s_stride(int kk) { return kk + 4; }
__host__ __device__ inline int xw_stride(int mul) { return mul + 8; }

__host__ __device__ inline int item_floats(const BdGroup& G) {
  return G.d3 * s_stride(G.kk) + G.kk * xw_stride(G.mul);
}

// group gi of the args by selects on constant indices (no local copy)
__device__ __forceinline__ BdGroup group(const BdArgs& p, int gi) {
  return gi == 0 ? p.g[0] : (gi == 1 ? p.g[1] : p.g[2]);
}

// Starts the copies of item (atom i, group G) into buf and commits them.
__device__ inline void stage_item(const BdGroup& G, int i, float* buf) {
  const float* S = G.S + (size_t)i * G.d3 * G.kk;
  const float* XW = G.XW + (size_t)i * G.kk * G.mul;
  float* Ss = buf;
  float* Xs = buf + G.d3 * s_stride(G.kk);
  const int cs = G.kk >> 2, cx = G.mul >> 2;
  for (int idx = threadIdx.x; idx < G.d3 * cs; idx += BD_NT) {
    const int r = idx / cs, c = (idx - r * cs) * 4;
    cp_async16(Ss + r * s_stride(G.kk) + c, S + (size_t)r * G.kk + c, 16);
  }
  for (int idx = threadIdx.x; idx < G.kk * cx; idx += BD_NT) {
    const int r = idx / cx, c = (idx - r * cx) * 4;
    cp_async16(Xs + r * xw_stride(G.mul) + c, XW + (size_t)r * G.mul + c, 16);
  }
  cp_async_commit();
}

// Y[i] = S[i] XW[i] from the staged item, rep times; tiles (16 rows, 8
// columns) over the warps.
__device__ inline void item_product(const BdGroup& G, int i, const float* buf, int rep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const float* Ss = buf;
  const float* Xs = buf + G.d3 * s_stride(G.kk);
  const int LS = s_stride(G.kk), LX = xw_stride(G.mul);
  const int ntn = G.mul >> 3, ntiles = ((G.d3 + 15) >> 4) * ntn;
  for (int task = warp; task < ntiles; task += BD_NT / 32) {
    const int m0 = (task / ntn) * 16, n0 = (task - (task / ntn) * ntn) * 8;
    const int ra = m0 + g, rb = m0 + g + 8;
    float c[4];
    for (int r = 0; r < rep; ++r) {
      float c3[3][4];
      zero3(c3);
      for (int k = 0; k < G.kk; k += 8) {
        float a[4];
        a[0] = ra < G.d3 ? Ss[ra * LS + k + q] : 0.0f;
        a[1] = rb < G.d3 ? Ss[rb * LS + k + q] : 0.0f;
        a[2] = ra < G.d3 ? Ss[ra * LS + k + q + 4] : 0.0f;
        a[3] = rb < G.d3 ? Ss[rb * LS + k + q + 4] : 0.0f;
        unsigned ah[4], al[4];
        split4(a, ah, al);
        const float b[2] = {Xs[(k + q) * LX + n0 + g], Xs[(k + q + 4) * LX + n0 + g]};
        mma_3xtf32_3(c3, ah, al, b);
      }
      sum3(c3, c);
    }
    float* Y = G.Y + (size_t)i * G.d3 * G.mul;
    const int col = n0 + 2 * q;
    if (ra < G.d3) {
      Y[ra * G.mul + col] = c[0];
      Y[ra * G.mul + col + 1] = c[1];
    }
    if (rb < G.d3) {
      Y[rb * G.mul + col] = c[2];
      Y[rb * G.mul + col + 1] = c[3];
    }
  }
}

__global__ void __launch_bounds__(BD_NT, 1) batched_dot_kernel(BdArgs p, int buf_floats) {
  extern __shared__ __align__(16) float smem[];
  // items t of this CTA: atom blockIdx.x + (t / 3) gridDim.x, group t % 3
  const int n_mine = p.N > (int)blockIdx.x ? (p.N - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int n_items = BD_GROUPS * n_mine;
  if (n_items == 0) return;
  stage_item(group(p, 0), blockIdx.x, smem);
  for (int t = 0; t < n_items; ++t) {
    const int i = blockIdx.x + (t / BD_GROUPS) * gridDim.x;
    if (t + 1 < n_items) {
      const int i1 = blockIdx.x + ((t + 1) / BD_GROUPS) * gridDim.x;
      stage_item(group(p, (t + 1) % BD_GROUPS), i1, smem + ((t + 1) & 1) * buf_floats);
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();
    item_product(group(p, t % BD_GROUPS), i, smem + (t & 1) * buf_floats, p.rep);
    __syncthreads();
  }
}

static int smem_limit_bd[MAX_DEVICES];

// Launches the batched product: one CTA per SM (at most one per atom).
// Returns cudaGetLastError() after the launch.
extern "C" int batched_dot_launch(BdArgs p, void* stream) {
  int buf = 0;
  for (int gi = 0; gi < BD_GROUPS; ++gi) {
    const int f = item_floats(p.g[gi]);
    buf = f > buf ? f : buf;
    if ((p.g[gi].kk & 7) || (p.g[gi].mul & 7)) return (int)cudaErrorInvalidValue;
  }
  buf = (buf + 3) & ~3;  // keep the second buffer 16-byte aligned
  const size_t smem = sizeof(float) * 2 * buf;
  cudaError_t err = raise_smem_limit((const void*)batched_dot_kernel, smem, smem_limit_bd);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int grid = p.N < sms ? p.N : sms;
  if (grid > 0) batched_dot_kernel<<<grid, BD_NT, smem, (cudaStream_t)stream>>>(p, buf);
  return (int)cudaGetLastError();
}
