// HiNM packed matmul  y (B, n_out) = x (B, n_in) @ W_packed^T, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/hinm_spmm.py:hinm_spmm (_kernel),
// the paper's SpMM: per output tile t of V rows,
//   y[b, t*V + v] = sum_j vals[t,v,j] * x[b, vec_idx[t, (j/N)*M + nm_idx[t,v,j]]]
// The vec_idx gather is the global->shared indexed load that makes the
// runtime channel permutation free: a permuted vec_idx costs what an
// identity one costs.
//
// What bounds it on the H100: at decode (B = a few slots) the kernel reads
// every packed weight byte once (bf16 vals + int8 nm_idx + int32 vec_idx =
// 0.8125 B per dense weight at 2:4 and 50% vectors) and does ~B FMAs per
// value, so it is bound by device-memory bytes (3.35 TB/s).  At prefill
// (B in the hundreds) the arithmetic grows with B while the weight bytes do
// not; this first kernel runs that arithmetic on the CUDA cores in f32 and
// is bound by operations there (no tensor cores yet).
//
// Design: one thread block per (tile t, batch block of BB rows), 8 warps.
// The tile's kept x columns are gathered through vec_idx into shared
// memory in chunks of KC kept columns (f32, KC*BB floats; the down
// projection's K = 2432 would not fit whole).  Warp w owns rows v = w,
// w+8, ... of the tile (V is a multiple of 8): its lanes stride over the
// row's packed values, so reads of vals/nm_idx are coalesced and each
// packed byte is read once per batch block; every lane keeps BB partial
// sums in registers, a warp shuffle reduces them, and lane 0 adds the row's
// chunk sum into a shared f32 accumulator.  Output is written in x's dtype.
// The k/v projections have only T = 4 tiles, so at decode their grid is 4
// blocks on a 132-SM card; splitting K across blocks is later work, as are
// tensor cores (mma.sp / wgmma), TMA and a hardware N:M metadata layout.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KC = 512;      // kept columns staged per chunk (multiple of M)
constexpr int WARPS = 8;
constexpr int V_MAX = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BB>
__global__ void __launch_bounds__(WARPS * 32)
hinm_spmm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                 const int8_t* __restrict__ nm_idx, const int* __restrict__ vec_idx,
                 T* __restrict__ y, int B, int n_in, int n_out, int V, int K,
                 int Kn, int N, int M) {
  __shared__ float xs[KC * BB];        // gathered x: xs[kk * BB + bb]
  __shared__ float part[V_MAX * BB];   // per-row sums: part[v * BB + bb]
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* vrow = vec_idx + (size_t)t * K;

  for (int i = tid; i < V * BB; i += blockDim.x) part[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = tid; i < kc * BB; i += blockDim.x) {
      const int kk = i / BB, bb = i - kk * BB;
      float xv = 0.f;
      if (bb < nb) xv = to_f(x[(size_t)(b0 + bb) * n_in + vrow[k0 + kk]]);
      xs[i] = xv;
    }
    __syncthreads();
    const int j0 = (k0 / M) * N, j1 = ((k0 + kc) / M) * N;
    for (int v = warp; v < V; v += WARPS) {
      const T* vr = vals + ((size_t)t * V + v) * Kn;
      const int8_t* sr = nm_idx + ((size_t)t * V + v) * Kn;
      float acc[BB];
#pragma unroll
      for (int bb = 0; bb < BB; ++bb) acc[bb] = 0.f;
      for (int j = j0 + lane; j < j1; j += 32) {
        const float w = to_f(vr[j]);
        const float* xp = xs + ((j / N) * M + (int)sr[j] - k0) * BB;
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) acc[bb] = fmaf(w, xp[bb], acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < BB; ++bb) {
        float a = acc[bb];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[bb] = a;
      }
      if (lane == 0) {
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) part[v * BB + bb] += acc[bb];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < V * nb; i += blockDim.x) {
    const int bb = i / V, v = i - bb * V;
    y[(size_t)(b0 + bb) * n_out + (size_t)t * V + v] = from_f<T>(part[v * BB + bb]);
  }
}

template <typename T, int BB>
cudaError_t launch(const void* x, const void* vals, const void* nm_idx,
                   const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                   int K, int Kn, int N, int M, cudaStream_t stream) {
  dim3 grid(T_, (B + BB - 1) / BB);
  hinm_spmm_kernel<T, BB><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int8_t*>(nm_idx), static_cast<const int*>(vec_idx),
      static_cast<T*>(y), B, n_in, T_ * V, V, K, Kn, N, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* vals, const void* nm_idx,
                     const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                     int K, int Kn, int N, int M, cudaStream_t s) {
  if (B <= 4) return launch<T, 4>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, s);
  if (B <= 8) return launch<T, 8>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, s);
  return launch<T, 16>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, vals and y share it).  Returns the
// cudaError_t of the launch; the Python wrapper raises when it is not 0.
extern "C" int hinm_spmm_launch(const void* x, const void* vals, const void* nm_idx,
                                const void* vec_idx, void* y, int B, int n_in,
                                int T_, int V, int K, int Kn, int N, int M,
                                int dtype, void* stream) {
  if (V <= 0 || V % WARPS != 0 || V > V_MAX || KC % M != 0 || K % M != 0 ||
      Kn != K / M * N || B <= 0 || T_ <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1
      ? dispatch<__nv_bfloat16>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, s)
      : dispatch<float>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, s);
  return (int)e;
}
