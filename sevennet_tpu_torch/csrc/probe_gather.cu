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
//     table for 1,024 indices (probe_gather_cols_kernel<R, VEC>).
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
// Columns. out[c, d, t] = tbl[d, idx[t]]: the resident-table gather of the
// conv's uvu operand formation (Wigner rows, task tables). At the TPU shape
// it moves 3 MB, a few microseconds: what p1 asks is the fixed price of one
// such gather, so the launch and the latency of its dependent loads bound
// it as much as HBM does. The first design (a CTA staging a band of 8 table
// rows in shared memory, a barrier, then 4-byte stores; 60 CTAs at the
// script's shape) took 12.64 us as one call alone against index_select's
// 11.52 (PERF.md's kernel table). This one has no shared memory and no barrier: a
// thread owns a quad of 4 consecutive t, loads their indices once (one
// 16-byte load), reads its R rows' 4 entries each straight from the table
// (983 KB, L2-resident between calls) with every load of the thread in
// flight at once, and writes each row's quad as one 16-byte store. A CTA is
// GC_QB quads x GC_RG row lanes; the host picks R (probes/gather.py:
// cols_plan) so that one copy at the script's shape (480 x 1,024) runs on
// 240 CTAs, more than the card's 132 SMs. T not a multiple of 4, or an
// index or output pointer off the 16-byte grid, takes the same kernel with
// 4-byte loads and stores (VEC false).
#include "fused_conv_common.cuh"

#define GR_NT 256
#define GC_QB 64   // quads of t a CTA (probes/gather.py COLS_QB)
#define GC_RG 4    // row lanes a CTA (probes/gather.py COLS_RG)
#define GC_NT (GC_QB * GC_RG)

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
  int rows;          // R, rows a thread (1, 2 or 4): the host's plan
};

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

// Thread (quad q of GC_QB, row lane l of GC_RG) of CTA (x, y, copy): t =
// 4 (x GC_QB + q) .. + 3, rows d = y GC_RG R + l + GC_RG r for r < R.
template <int R, bool VEC>
__global__ void __launch_bounds__(GC_NT) probe_gather_cols_kernel(ColsArgs p) {
  const int t0 = 4 * (blockIdx.x * GC_QB + threadIdx.x % GC_QB);
  const int d0 = blockIdx.y * GC_RG * R + threadIdx.x / GC_QB;
  if (t0 >= p.T) return;
  float* o = p.out + (size_t)blockIdx.z * p.D * p.T;
  if (VEC) {
    const int4 j = __ldg((const int4*)(p.idx + t0));
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = p.tbl + (size_t)min(d0 + GC_RG * r, p.D - 1) * p.W;
      v[r] = make_float4(__ldg(row + j.x), __ldg(row + j.y), __ldg(row + j.z), __ldg(row + j.w));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = d0 + GC_RG * r;
      if (d < p.D) *(float4*)(o + (size_t)d * p.T + t0) = v[r];
    }
  } else {
    const int nt = min(4, p.T - t0);
    int j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) j[u] = u < nt ? __ldg(p.idx + t0 + u) : 0;
    float v[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = p.tbl + (size_t)min(d0 + GC_RG * r, p.D - 1) * p.W;
#pragma unroll
      for (int u = 0; u < 4; ++u) v[r][u] = __ldg(row + j[u]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = d0 + GC_RG * r;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d < p.D && u < nt) o[(size_t)d * p.T + t0 + u] = v[r][u];
    }
  }
}

// No work: the floor of a launch timed by the probes' method (one call
// captured in a CUDA graph, probes/_lib.py:graph_ms), beside which a single
// gather's time is read.
__global__ void probe_empty_kernel() {}

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

template <int R>
static void launch_cols(const ColsArgs& p, bool vec, cudaStream_t s) {
  const dim3 grid((p.T + 4 * GC_QB - 1) / (4 * GC_QB), (p.D + GC_RG * R - 1) / (GC_RG * R),
                  p.copies);
  if (vec) probe_gather_cols_kernel<R, true><<<grid, GC_NT, 0, s>>>(p);
  else probe_gather_cols_kernel<R, false><<<grid, GC_NT, 0, s>>>(p);
}

// Every index in [0, W) (not checked here); p.rows 1, 2 or 4. 16-byte
// accesses where T % 4 == 0 and idx and out are 16-byte aligned.
extern "C" int probe_gather_cols_launch(ColsArgs p, void* stream) {
  if (p.D <= 0 || p.W <= 0 || p.T <= 0 || p.copies <= 0 || p.copies > 65535 ||
      (p.rows != 1 && p.rows != 2 && p.rows != 4) ||
      (p.D + GC_RG * p.rows - 1) / (GC_RG * p.rows) > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = p.T % 4 == 0 && (size_t)p.idx % 16 == 0 && (size_t)p.out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.rows == 1) launch_cols<1>(p, vec, s);
  else if (p.rows == 2) launch_cols<2>(p, vec, s);
  else launch_cols<4>(p, vec, s);
  return (int)cudaGetLastError();
}

extern "C" int probe_empty_launch(void* stream) {
  probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
