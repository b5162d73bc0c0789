// Gather probes: rows and columns of a table taken by an index list.
//
// Replaces three Pallas TPU probes:
//   - scripts_dev/r3_gather_probe.py:make_take (pallas_call at :27): out =
//     x[idx], rows of a resident (N, D) table, SevenNet-0's x[src] at its
//     9,999-atom shape (N 10,016, D 480 = dim_x of 128x0e+64x1e+32x2e,
//     721,152 = 313 blocks of 2,304 indices) (probe_gather_rows_kernel);
//   - scripts_dev/r2_pallas_caps.py:p2 (pallas_call at :91): the same on a
//     (512, 480) table for 1,024 indices (probe_gather_rows_kernel);
//   - scripts_dev/r2_pallas_caps.py:p1 (pallas_call at :55, and its timed
//     loop at :68): out[d, t] = tbl[d, idx[t]], columns of a (480, 512)
//     table for 1,024 indices (probe_gather_cols_kernel).
//
// Rows. A warp copies one output row at a time, 16 bytes a lane, in a
// grid-stride loop of as many CTAs as can be resident. Two variants of the
// same contract:
//   GR_LDG       the row is read through the read-only path (__ldg of
//                float4s, four of them in flight a lane) and written out;
//   GR_CP_ASYNC  the row is staged in the warp's shared memory by 16-byte
//                cp.async, the next row's copy in flight while the last one
//                is stored: the conv's x[src] gather (load_tile,
//                fused_conv_common.cuh).
// STREAM writes the output with streaming stores (st.global.cs), so that
// the output, read by nobody here, does not push the table out of L2.
// What bounds it on an H100: HBM, through the output (1.385 GB at G1's
// shape against a 19.2 MB table that L2 can hold).
//
// Columns. A CTA stages a band of GC_BAND rows of the table in shared
// memory (GC_BAND x W floats: 16 KB at W 512; the whole table, 983 KB, does
// not fit a CTA), then writes out[d, t] = smem[d][idx[t]] for its rows, the
// threads of a warp on consecutive t: coalesced stores, and shared-memory
// reads at random banks, the resident-table gather of the conv's uvu
// operand formation (Wigner rows, task tables). At the TPU shape it moves 3
// MB: a few microseconds, bound by the launch and its latency as much as by
// HBM.
#include "fused_conv_common.cuh"

#define GR_NT 256
#define GC_NT 256
#define GC_BAND 8  // table rows a CTA stages

enum { GR_LDG = 0, GR_CP_ASYNC = 1 };

struct RowsArgs {
  const float* x;  // (N, D)
  const int* idx;  // (T,)
  float* out;      // (copies, T, D)
  int N, D, T, copies;
};

struct ColsArgs {
  const float* tbl;  // (D, W)
  const int* idx;    // (T,)
  float* out;        // (copies, D, T)
  int D, W, T, copies;
};

static int smem_limit_gc[MAX_DEVICES];

template <bool STREAM>
__device__ __forceinline__ void store4(float4* p, float4 v) {
  if (STREAM) __stcs(p, v);
  else *p = v;
}

template <int V, bool STREAM>
__global__ void __launch_bounds__(GR_NT) probe_gather_rows_kernel(RowsArgs p) {
  extern __shared__ float4 stage[];  // GR_CP_ASYNC: two rows a warp
  const int lane = threadIdx.x & 31;
  const long long nw = (long long)gridDim.x * (GR_NT / 32);
  const long long rows = (long long)p.copies * p.T;
  const int d4 = p.D >> 2;
  long long r = (long long)blockIdx.x * (GR_NT / 32) + (threadIdx.x >> 5);
  if (V == GR_LDG) {
    for (; r < rows; r += nw) {
      const float4* in = (const float4*)(p.x + (size_t)__ldg(p.idx + r % p.T) * p.D);
      float4* o = (float4*)(p.out + r * p.D);
      for (int c0 = 0; c0 < d4; c0 += 128) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          if (c < d4) v[u] = __ldg(in + c);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          if (c < d4) store4<STREAM>(o + c, v[u]);
        }
      }
    }
  } else {
    float4* buf = stage + (threadIdx.x >> 5) * 2 * d4;
    auto issue = [&](long long row, float4* dst) {
      const float* in = p.x + (size_t)__ldg(p.idx + row % p.T) * p.D;
      for (int c = lane; c < d4; c += 32) cp_async16((float*)(dst + c), in + 4 * c, 16);
    };
    if (r < rows) issue(r, buf);
    cp_async_commit();
    for (int s = 0; r < rows; r += nw, s ^= 1) {
      if (r + nw < rows) issue(r + nw, buf + (s ^ 1) * d4);
      cp_async_commit();  // possibly empty: one group per row keeps the count
      cp_async_wait(1);   // row r's copies are in
      __syncwarp();
      float4* o = (float4*)(p.out + r * p.D);
      const float4* src = buf + s * d4;
      for (int c = lane; c < d4; c += 32) store4<STREAM>(o + c, src[c]);
      __syncwarp();  // every lane has read the buffer the next issue refills
    }
    cp_async_wait(0);
  }
}

__global__ void __launch_bounds__(GC_NT) probe_gather_cols_kernel(ColsArgs p) {
  extern __shared__ float band[];  // GC_BAND x W
  const int d0 = blockIdx.x * GC_BAND;
  const int nd = min(GC_BAND, p.D - d0);
  const float4* src = (const float4*)(p.tbl + (size_t)d0 * p.W);
  for (int i = threadIdx.x; i < nd * (p.W >> 2); i += GC_NT) ((float4*)band)[i] = __ldg(src + i);
  __syncthreads();
  float* o = p.out + ((size_t)blockIdx.y * p.D + d0) * p.T;
  for (int t = threadIdx.x; t < p.T; t += GC_NT) {
    const int j = __ldg(p.idx + t);
#pragma unroll 4
    for (int d = 0; d < nd; ++d) o[(size_t)d * p.T + t] = band[d * p.W + j];
  }
}

template <int V, bool STREAM>
static int launch_rows(const RowsArgs& p, cudaStream_t s) {
  static int smem_limit[MAX_DEVICES];  // one per instance
  const auto kernel = probe_gather_rows_kernel<V, STREAM>;
  const size_t smem = V == GR_CP_ASYNC ? sizeof(float4) * (GR_NT / 32) * 2 * (p.D / 4) : 0;
  cudaError_t err = raise_smem_limit((const void*)kernel, smem, smem_limit);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GR_NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long need = ((long long)p.copies * p.T + GR_NT / 32 - 1) / (GR_NT / 32);
  const long long grid = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, GR_NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// variant: GR_LDG or GR_CP_ASYNC; stream: streaming stores. D a multiple of
// 4, the pointers 16-byte aligned, every index in [0, N) (not checked here).
extern "C" int probe_gather_rows_launch(int variant, int stream_stores, RowsArgs p,
                                        void* stream) {
  if (p.N <= 0 || p.D <= 0 || p.D % 4 || p.T <= 0 || p.copies <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == GR_LDG)
    return stream_stores ? launch_rows<GR_LDG, true>(p, s) : launch_rows<GR_LDG, false>(p, s);
  if (variant == GR_CP_ASYNC)
    return stream_stores ? launch_rows<GR_CP_ASYNC, true>(p, s)
                         : launch_rows<GR_CP_ASYNC, false>(p, s);
  return (int)cudaErrorInvalidValue;
}

// W a multiple of 4, the pointers 16-byte aligned, every index in [0, W).
extern "C" int probe_gather_cols_launch(ColsArgs p, void* stream) {
  if (p.D <= 0 || p.W <= 0 || p.W % 4 || p.T <= 0 || p.copies <= 0 || p.copies > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * GC_BAND * p.W;
  cudaError_t err = raise_smem_limit((const void*)probe_gather_cols_kernel, smem, smem_limit_gc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.D + GC_BAND - 1) / GC_BAND, p.copies);
  probe_gather_cols_kernel<<<grid, GC_NT, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
