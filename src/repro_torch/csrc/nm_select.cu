// N:M magnitude select for sm_90a: along the last axis, keep the N entries
// of every group of M with the largest |w| (ties to the lower index), copy
// them bit for bit (-0.0 included) and write +0 in the other M - N slots.
//
// Replaces the TPU kernel src/repro/kernels/nm_select.py:nm_select (_kernel),
// which ranks each group by the same O(M^2) compare-reduce in one VMEM pass
// over (256, 512) blocks.
//
// What bounds it on the H100: one read and one write of every element and a
// few compares per element, so device-memory bytes (3.35 TB/s) bound it:
// a (896, 4864) bf16 weight is 17.4 MB read + written, 5.2 us.
//
// Design: one thread per M-group, grid-stride over the groups.  A thread
// loads its group as one vector (M * sizeof(T) bytes: 8 B for bf16 and 16 B
// for f32 at M = 4), so a warp reads 32 neighbouring groups as one coalesced
// transaction; the values stay raw bits, the ranks are computed on the
// exact magnitudes (sign bit cleared, bf16 widened to f32) in registers,
// and the group is stored back as one vector.  No shared memory, no
// synchronisation: the TPU kernel's 2-D blocking has no work to do here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;  // grid-stride beyond 16 blocks per SM

template <typename U, int M>
struct alignas(sizeof(U) * M) Group {
  U v[M];
};

template <typename U> __device__ __forceinline__ float magnitude(U bits);
template <> __device__ __forceinline__ float magnitude<uint32_t>(uint32_t b) {
  return __uint_as_float(b & 0x7fffffffu);
}
template <> __device__ __forceinline__ float magnitude<uint16_t>(uint16_t b) {
  return __uint_as_float(((uint32_t)b & 0x7fffu) << 16);  // bf16 -> f32 is exact
}

template <typename U, int M>
__global__ void __launch_bounds__(THREADS)
nm_select_kernel(const Group<U, M>* __restrict__ w, Group<U, M>* __restrict__ out,
                 long long n_groups, int N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x; gi < n_groups;
       gi += stride) {
    const Group<U, M> g = w[gi];
    float a[M];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = magnitude<U>(g.v[i]);
    Group<U, M> o;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      int rank = 0;  // entries that beat entry i: larger, or equal and earlier
#pragma unroll
      for (int j = 0; j < M; ++j) rank += (a[j] > a[i]) || (a[j] == a[i] && j < i);
      o.v[i] = rank < N ? g.v[i] : (U)0;
    }
    out[gi] = o;
  }
}

template <typename U, int M>
cudaError_t launch(const void* w, void* out, long long n_groups, int N, cudaStream_t s) {
  long long blocks = (n_groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  nm_select_kernel<U, M><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const Group<U, M>*>(w), static_cast<Group<U, M>*>(out), n_groups, N);
  return cudaGetLastError();
}

template <typename U>
cudaError_t dispatch(const void* w, void* out, long long n_groups, int N, int M,
                     cudaStream_t s) {
  switch (M) {
    case 2: return launch<U, 2>(w, out, n_groups, N, s);
    case 4: return launch<U, 4>(w, out, n_groups, N, s);
    case 8: return launch<U, 8>(w, out, n_groups, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// w and out: contiguous, n_groups * m elements, aligned to m * element size.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch;
// the Python wrapper raises when it is not 0.
extern "C" int nm_select_launch(const void* w, void* out, long long n_groups, int n,
                                int m, int dtype, void* stream) {
  if (n_groups <= 0 || n <= 0 || n >= m) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch<uint16_t>(w, out, n_groups, n, m, s)
                             : dispatch<uint32_t>(w, out, n_groups, n, m, s);
  return (int)e;
}
