// FMA-rate probes: fp32 multiply-add chains on the CUDA cores.
//
// Replaces three Pallas TPU probes:
//   - scripts_dev/r2_pallas_fma.py:fma (pallas_call at :72, body :48-70):
//     REP reps of a carried chain, each rep xi = x + acc, then R = 133 steps
//     acc += xi * t[r % 8], then acc *= 1e-8 (probe_fma_kernel, CARRY);
//   - scripts_dev/r2_pallas_caps.py:fma_probe (pallas_call at :127, body
//     :103-133): one pass from acc = 0, acc += x * t[r % 8] for r < 133
//     (probe_fma_kernel without CARRY);
//   - scripts_dev/r4_vpu_roofline.py:kernel (pallas_call at :28, body
//     :18-26): elementwise, 64 iterations of acc += a * b; a += 1e-9
//     (probe_vpu_kernel).
// The first two come in two layouts, the TPU's "sublane against lane
// broadcast": feature-major x (mul, T) and t (8, T), where an element (m, j)
// takes the t of its column j, and edge-major x (T, mul) and t (T, 8), where
// it takes the t of its row j. On Hopper the difference is how many t
// values a thread holds: a thread owns FMA_E consecutive elements of the
// contiguous array, which in the feature-major layout lie in FMA_E columns
// (8 x FMA_E t values in registers) and in the edge-major one in one row (8
// t values, shared by its elements). The output holds `copies` independent
// copies of the function (the TPU contract is one): at mul 32 one copy is
// 8,192 threads, too few to hide the FFMA latency on 132 SMs.
//
// What bounds them on an H100: the fp32 pipes. The chains run as explicit
// fmaf (one FFMA a step, never reassociated: no fast-math), each thread's
// FMA_E chains independent so that their FFMAs overlap the latency of one.
// The edge-major and feature-major chains do the same FFMAs; their loads
// differ. probe_vpu_kernel streams a, b and out once (float4 loads and
// stores, a grid-stride loop) and does 64 FFMA + 64 FADD per element: with
// the FADD counted as a full issue slot it sits at the ridge of the fp32
// rate and HBM.
#include <cuda_runtime.h>

#define FMA_R 133    // steps of a chain (r2_pallas_fma.py:45, r2_pallas_caps.py:104)
#define FMA_E 4      // consecutive output elements a thread owns: independent chains
#define FMA_NT 128
#define VPU_ITERS 64  // r4_vpu_roofline.py:14
#define VPU_NT 256

enum { L_FEAT = 0, L_EDGE = 1 };

struct FmaArgs {
  const float* x;  // (mul, T) feature-major, (T, mul) edge-major
  const float* t;  // (8, T) feature-major, (T, 8) edge-major
  float* out;      // (copies, mul, T) or (copies, T, mul)
  int mul, T, rep, copies;
};

template <int LAYOUT, bool CARRY>
__global__ void __launch_bounds__(FMA_NT) probe_fma_kernel(FmaArgs p) {
  const int per_copy = p.mul * p.T / FMA_E;
  const int tid = blockIdx.x * FMA_NT + threadIdx.x;
  if (tid >= per_copy) return;
  const int e0 = tid * FMA_E;  // first element, flat in the contiguous array
  float tv[8][FMA_E];
  if (LAYOUT == L_FEAT) {
    const int j = e0 % p.T;  // FMA_E columns j .. j + FMA_E - 1 of row e0 / T
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 v = __ldg((const float4*)(p.t + (size_t)r * p.T + j));
      tv[r][0] = v.x, tv[r][1] = v.y, tv[r][2] = v.z, tv[r][3] = v.w;
    }
  } else {
    const int j = e0 / p.mul;  // one row j, FMA_E features
    const float4 lo = __ldg((const float4*)(p.t + (size_t)j * 8));
    const float4 hi = __ldg((const float4*)(p.t + (size_t)j * 8 + 4));
    const float row[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < FMA_E; ++e) tv[r][e] = row[r];
  }
  const float4 xv = __ldg((const float4*)(p.x + e0));
  const float x[FMA_E] = {xv.x, xv.y, xv.z, xv.w};
  float acc[FMA_E] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (CARRY) {
#pragma unroll 1
    for (int i = 0; i < p.rep; ++i) {
      float xi[FMA_E];
#pragma unroll
      for (int e = 0; e < FMA_E; ++e) xi[e] = x[e] + acc[e];
#pragma unroll
      for (int r = 0; r < FMA_R; ++r)
#pragma unroll
        for (int e = 0; e < FMA_E; ++e) acc[e] = fmaf(xi[e], tv[r & 7][e], acc[e]);
#pragma unroll
      for (int e = 0; e < FMA_E; ++e) acc[e] *= 1e-8f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < FMA_R; ++r)
#pragma unroll
      for (int e = 0; e < FMA_E; ++e) acc[e] = fmaf(x[e], tv[r & 7][e], acc[e]);
  }
  *(float4*)(p.out + (size_t)blockIdx.y * p.mul * p.T + e0) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__global__ void __launch_bounds__(VPU_NT) probe_vpu_kernel(const float4* __restrict__ a,
                                                           const float4* __restrict__ b,
                                                           float4* __restrict__ out,
                                                           long long n4) {
  const long long stride = (long long)gridDim.x * VPU_NT;
  for (long long i = (long long)blockIdx.x * VPU_NT + threadIdx.x; i < n4; i += stride) {
    const float4 av = __ldg(a + i), bv = __ldg(b + i);
    float A[4] = {av.x, av.y, av.z, av.w};
    const float B[4] = {bv.x, bv.y, bv.z, bv.w};
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int it = 0; it < VPU_ITERS; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] = fmaf(A[e], B[e], acc[e]);
        A[e] = A[e] + 1e-9f;  // not a no-op: it moves every |a| below 2^-5
      }
    out[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// layout: L_FEAT or L_EDGE; carry: r2_pallas_fma's REP carried reps (p.rep)
// or r2_pallas_caps's one pass. The fast dimension (T feature-major, mul
// edge-major) must be a multiple of FMA_E, the pointers 16-byte aligned.
extern "C" int probe_fma_launch(int layout, int carry, FmaArgs p, void* stream) {
  const int fast = layout == L_FEAT ? p.T : p.mul;
  if (p.mul <= 0 || p.T <= 0 || p.copies <= 0 || p.copies > 65535 || fast % FMA_E ||
      (layout != L_FEAT && layout != L_EDGE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.mul * p.T / FMA_E + FMA_NT - 1) / FMA_NT, p.copies);
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == L_FEAT) {
    if (carry) probe_fma_kernel<L_FEAT, true><<<grid, FMA_NT, 0, s>>>(p);
    else probe_fma_kernel<L_FEAT, false><<<grid, FMA_NT, 0, s>>>(p);
  } else {
    if (carry) probe_fma_kernel<L_EDGE, true><<<grid, FMA_NT, 0, s>>>(p);
    else probe_fma_kernel<L_EDGE, false><<<grid, FMA_NT, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// a, b, out: n floats each, n a multiple of 4, 16-byte aligned. A
// grid-stride loop over float4s, as many CTAs as can be resident.
extern "C" int probe_vpu_launch(const float* a, const float* b, float* out, long long n,
                                void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_vpu_kernel, VPU_NT, 0)) !=
      cudaSuccess)
    return (int)err;
  const long long n4 = n / 4, need = (n4 + VPU_NT - 1) / VPU_NT;
  const long long grid = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
  probe_vpu_kernel<<<(unsigned)grid, VPU_NT, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (const float4*)b, (float4*)out, n4);
  return (int)cudaGetLastError();
}
