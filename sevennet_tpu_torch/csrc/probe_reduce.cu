// K-reduction probes: sums over K consecutive rows or columns, carried
// REP times over an input that is read from HBM once.
//
// Replaces three Pallas TPU probes:
//   - scripts_dev/r2_pallas_fma.py:kreduce (pallas_call at :94, body
//     :86-92): x (T, mul), A groups of K = T / A rows; acc (A, mul) from 0,
//     REP reps of xi = x + acc[0, 0], acc = acc + xi.reshape(A, K,
//     mul).sum(1) * 1e-8 (probe_reduce_rows_kernel<RC_KREDUCE>);
//   - scripts_dev/r2_pallas_mm.py:subreduce (pallas_call at :120, body
//     :112-117): a (A K, mul), s (1, 1); acc = 0.5 acc + (a (1 + s
//     i)).reshape(A, K, mul).sum(1), i = 0 .. REP - 1
//     (probe_reduce_rows_kernel<RC_SCALED>);
//   - scripts_dev/r2_pallas_mm.py:lanereduce (pallas_call at :98, body
//     :90-95): the same over K consecutive columns of a (rows, A K), out
//     (rows, A) (probe_reduce_lanes_kernel).
//
// Rows. One thread per output (a, c) holds its column's K inputs in
// registers for all RD_REP reps (K <= RD_KMAX) and walks them in RD_P
// interleaved partial sums, p[k % 4] += xi[k], then (p0 + p1) + (p2 + p3):
// four independent FADD chains a thread, so a rep costs K / 4 dependent adds
// and not K. kreduce's carry makes every column's rep i + 1 wait on acc[0,
// 0] after rep i. CTAs cannot share that without a grid-wide barrier, so
// every CTA holds one more warp whose first thread recomputes column 0 of
// group 0 with the same code as its owner in CTA 0 (bitwise the same value)
// and passes it on through shared memory, two __syncthreads a rep.
//
// Lanes. A warp owns 32 / K segments (K < 32) or one segment of K = 32 E
// elements, E <= 4 a lane, held in registers across the reps; a rep sums
// each lane's elements, then the lanes by a butterfly of __shfl_xor_sync.
//
// Every product and sum is an explicit __fmul_rn / __fadd_rn: no FMA
// contraction, no fast-math, the order above. What bounds them on an H100:
// HBM for the one read (12.8 MB at kreduce mul 3,136), then the dependent
// adds of the RD_REP reps: a few microseconds either way.
#include "fused_conv_common.cuh"

#define RD_NT 256    // output threads of a rows CTA; a lanes CTA's threads
#define RD_KMAX 128  // rows a thread holds (r2_pallas_fma.py:84: K = 1024 / 8)
#define RD_P 4       // interleaved partial sums of a walk
#define RD_LMAX 4    // elements a lane holds in a lane segment
#define RD_REP 16    // reps of a call (r2_pallas_fma.py:16, r2_pallas_mm.py:11; REP in reduce.py)

enum { RA_ROWS = 0, RA_LANES = 1 };
enum { RC_KREDUCE = 0, RC_SCALED = 1 };

struct ReduceArgs {
  const float* x;  // rows: (A K, mul); lanes: (rows, A K)
  const float* s;  // (1, 1): RC_SCALED's s
  float* out;      // rows: (A, mul); lanes: (rows, A)
  int A, K, mul, rows;
};

// sum over k < K of xi[k]: x + c0 (kreduce) or x * f (scaled)
template <int C>
__device__ __forceinline__ float walk(const float (&v)[RD_KMAX], int K, float c0, float f) {
  float p[RD_P] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < RD_KMAX; ++k)
    if (k < K) {
      const float xi = C == RC_KREDUCE ? __fadd_rn(v[k], c0) : __fmul_rn(v[k], f);
      p[k % RD_P] = __fadd_rn(p[k % RD_P], xi);
    }
  return __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
}

template <int C>
__global__ void __launch_bounds__(RD_NT + 32) probe_reduce_rows_kernel(ReduceArgs p) {
  __shared__ float s_c0;  // kreduce: acc[0, 0] after the last rep
  const int o = blockIdx.x * RD_NT + threadIdx.x;
  const bool mine = threadIdx.x < RD_NT && o < p.A * p.mul;
  const bool chain = C == RC_KREDUCE && threadIdx.x == RD_NT;  // column 0 of group 0
  const int a = mine ? o / p.mul : 0, c = mine ? o % p.mul : 0;
  float v[RD_KMAX];
#pragma unroll
  for (int k = 0; k < RD_KMAX; ++k)
    v[k] = (mine || chain) && k < p.K ? __ldg(p.x + (size_t)(a * p.K + k) * p.mul + c) : 0.0f;
  float acc = 0.0f;
  if (C == RC_KREDUCE) {
    if (chain) s_c0 = 0.0f;
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < RD_REP; ++i) {
      const float c0 = s_c0;
      __syncthreads();  // every thread has read it before the chain thread writes
      acc = __fadd_rn(acc, __fmul_rn(walk<C>(v, p.K, c0, 0.0f), 1e-8f));
      if (chain) s_c0 = acc;
      __syncthreads();
    }
  } else {
    const float s = __ldg(p.s);
#pragma unroll 1
    for (int i = 0; i < RD_REP; ++i) {
      const float f = __fadd_rn(1.0f, __fmul_rn(s, (float)i));
      acc = __fadd_rn(__fmul_rn(acc, 0.5f), walk<C>(v, p.K, 0.0f, f));
    }
  }
  if (mine) p.out[o] = acc;
}

__global__ void __launch_bounds__(RD_NT) probe_reduce_lanes_kernel(ReduceArgs p) {
  const int lane = threadIdx.x & 31;
  const int span = min(p.K, 32);  // lanes of a segment
  const int per = p.K / span;     // elements of a lane
  const long long g = ((long long)blockIdx.x * (RD_NT / 32) + (threadIdx.x >> 5)) * (32 / span) +
                      lane / span;  // segment (r, a), its elements at g K
  const bool mine = g < (long long)p.rows * p.A;
  float v[RD_LMAX];
#pragma unroll
  for (int j = 0; j < RD_LMAX; ++j)
    v[j] = mine && j < per ? __ldg(p.x + g * p.K + j * span + lane % span) : 0.0f;
  const float s = __ldg(p.s);
  float acc = 0.0f;
#pragma unroll 1
  for (int i = 0; i < RD_REP; ++i) {
    const float f = __fadd_rn(1.0f, __fmul_rn(s, (float)i));
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < RD_LMAX; ++j)
      if (j < per) part = __fadd_rn(part, __fmul_rn(v[j], f));
    for (int off = span >> 1; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    acc = __fadd_rn(__fmul_rn(acc, 0.5f), part);
  }
  if (mine && lane % span == 0) p.out[g] = acc;
}

// axis: RA_ROWS (kreduce with RC_KREDUCE, subreduce with RC_SCALED) or
// RA_LANES (lanereduce, RC_SCALED only). Rows: K <= RD_KMAX. Lanes: K a
// power of two below 32, or a multiple of 32 up to 32 RD_LMAX.
extern "C" int probe_reduce_launch(int axis, int carry, ReduceArgs p, void* stream) {
  if (p.A <= 0 || p.K <= 0 || (carry != RC_KREDUCE && carry != RC_SCALED))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis == RA_ROWS) {
    if (p.K > RD_KMAX || p.mul <= 0) return (int)cudaErrorInvalidValue;
    const int grid = (p.A * p.mul + RD_NT - 1) / RD_NT;
    if (carry == RC_KREDUCE) probe_reduce_rows_kernel<RC_KREDUCE><<<grid, RD_NT + 32, 0, s>>>(p);
    else probe_reduce_rows_kernel<RC_SCALED><<<grid, RD_NT, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (axis != RA_LANES || carry != RC_SCALED || p.rows <= 0) return (int)cudaErrorInvalidValue;
  const bool ok = p.K < 32 ? 32 % p.K == 0 : p.K % 32 == 0 && p.K <= 32 * RD_LMAX;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long per_cta = (long long)(RD_NT / 32) * (32 / (p.K < 32 ? p.K : 32));
  const long long grid = ((long long)p.rows * p.A + per_cta - 1) / per_cta;
  probe_reduce_lanes_kernel<<<(unsigned)grid, RD_NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}
