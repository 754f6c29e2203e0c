// HiNM packed matmul  y (B, n_out) = x (B, n_in) @ W_packed^T, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/hinm_spmm.py:hinm_spmm (_kernel),
// the paper's SpMM: per output tile t of V rows,
//   y[b, t*V + v] = sum_j vals[t,v,j] * x[b, vec_idx[t, (j/N)*M + nm_idx[t,v,j]]]
// The vec_idx gather is the indexed load that makes the runtime channel
// permutation free: a permuted vec_idx costs what an identity one costs.
// The packed format is read as it is: vals (T, V, Kn), int8 nm_idx (T, V, Kn),
// int32 vec_idx (T, K), Kn = K / M * N.  Sums are f32; y is in x's dtype.
//
// Two variants behind one entry point; hinm_spmm_variant picks by dtype and
// batch (the crossover ROWS_MAX_B was measured, see PERF.md):
//
// A, "rows" — f32 at every B, bf16 at B <= ROWS_MAX_B (decode).  Bound by
//   device-memory bytes: each packed weight byte is read once per batch
//   block for ~B FMAs.  At decode the bytes are a few hundred KB to 3 MB a
//   projection, so what counts is how many DRAM round trips lie in a row and
//   how many blocks are resident at once.  Design: one warp per output row,
//   8 rows (one tile's, sharing its vec_idx row) a block, so a launch has
//   n_out warps and needs no split-K.  A lane first issues its share of its
//   row's weights into registers (16-byte vals loads, 8- or 4-byte nm_idx
//   loads); then the block copies the tile's vec_idx and, for small bf16
//   batches, x's rows whole into shared memory with cp.async, so weights,
//   vec_idx and x cost one round trip together.  The K kept columns are then
//   gathered into xs[k][b] (batch innermost: one value's B inputs are one
//   vector load).  Sums reduce across the warp with shuffles.  Rows of one
//   16-byte chunk a lane preload one chunk, under a register cap that keeps
//   every gate/up block of a decode step resident at once.  Rows that are
//   not 16-byte aligned, or whose Kn is not a multiple of the vector width,
//   take a scalar path.
//
// B, "mma" — bf16 at B > ROWS_MAX_B (prefill).  Bound by operations, so on
//   tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate), the batch on
//   the MMA's M side, the tile's V rows on N (steps of 8, so V = 8 needs no
//   grouping of tiles), the kept columns on K: half the multiply-adds of a
//   dense matmul on the masked weight.  x is first transposed once per call
//   into scratch xt (n_in, Bp) (Bp = B rounded up to 128, zero padded), so a
//   K-chunk's gather is BM contiguous values per kept column: 16-byte
//   cp.async copies, whatever the permutation.  One block of 8 warps per
//   (tile, BM = 64 or 128 batch rows); a warp owns 32 batch rows x 32 tile
//   rows, and the warps a tile does not need split each chunk's k-steps
//   (summed in shared memory at the end).  Per chunk of KC = 64 kept
//   columns, x rows and the raw packed vals/nm_idx go through a STAGES-deep
//   cp.async ring; the next chunk's rows are decompressed (2:4 vectorised,
//   any N:M with M | KC by group) into one of two dense bf16 (V x KC) tiles
//   while the tensor cores run on the other, one barrier a chunk.  A
//   fragments come from ldmatrix .trans on xs[k][b], B fragments from the
//   dense tile; rows are padded by 8 bf16 against bank conflicts.  A grid
//   under one block per SM (few tiles, small batch) splits K over
//   blockIdx.z into f32 partials that sum_splits adds up.  Packed rows that
//   are not 16-byte aligned are copied into the ring with scalar loads.
//
// Both run over a stack of E experts in one launch (the TPU kernel vmapped
// over an expert axis, src/repro/models/moe.py:_expert_linear): expert e
// reads x + e*B*n_in, its own vals/nm_idx (+ e*T*V*Kn) and vec_idx
// (+ e*T*K), and writes y + e*B*n_out, B being the rows of one expert.  The
// expert is folded into blockIdx.y beside the batch blocks, and every
// block's work is the single-matrix launch's: a stack's expert gives the
// bits a launch of that expert alone gives.  "mma" transposes and, on a
// split K, sums each expert's rows in its own share of the scratch.
//
// Every launch is a programmatic dependent launch (launch_pdl): a grid is
// scheduled while the kernel before it finishes, which hides most of the
// launch latency between the back-to-back projections of a layer and
// between transpose_pad, spmm_mma and sum_splits.  Before it waits, "rows"
// prefetches its rows' weights and the tile's vec_idx into L2, so their
// DRAM round trip overlaps the kernel before it.
//
// Left for later: sparse tensor cores (mma.sp with nm_idx repacked as the
// hardware's metadata), wgmma/TMA at prefill, and one launch for the
// projections that share x (q/k/v, gate/up).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use (sm_90)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// the tile's K vec_idx entries into shared memory, all copies in flight at
// once (read one by one, each first touch is a DRAM round trip)
__device__ __forceinline__ void stage_vec_idx(int* vs, const int* vrow, int K) {
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(vrow) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(vs) & 15) == 0)
    for (int k = 4 * threadIdx.x; k < K; k += 4 * blockDim.x) cp_async16(vs + k, vrow + k);
  else
    for (int k = threadIdx.x; k < K; k += blockDim.x) cp_async4(vs + k, vrow + k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Launch with programmatic stream serialization: the grid may be scheduled
// while the previous kernel in the stream finishes, so its launch latency
// overlaps that kernel's tail.  Each kernel launched so either waits
// (griddepcontrol.wait) before it touches memory, or touches before the wait
// only data that kernels finished before the previous one wrote.
template <typename... P, typename... A>
cudaError_t launch_pdl(void (*kernel)(P...), dim3 grid, dim3 block, int smem, cudaStream_t s,
                       A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
// Warm L2 with [p, p + bytes), one 128-byte line a lane.  Safe before
// pdl_wait: L2 is the card's point of coherence and nothing is consumed.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes, int lane, int lanes) {
  const char* c = static_cast<const char*>(p);
  for (int o = lane * 128; o < bytes; o += lanes * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
}
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::); }

// ---------------------------------------------------------------- variant A
constexpr int ROW_WARPS = 8;        // rows (one per warp) of a block, of one tile
constexpr int PRE_LONG = 5;         // 16-byte weight chunks a lane issues before the gather
constexpr int ROWS_MAX_B = 8;       // bf16 batches up to this run on variant A
constexpr int XF_MAX = 48 * 1024;  // x rows up to this size are copied whole
// kept columns a thread gathers per round: ~32 bytes of x in flight, in registers
template <typename T, int BB>
__host__ __device__ constexpr int gather_u() {
  return BB * (int)sizeof(T) >= 32 ? 1 : 32 / (BB * (int)sizeof(T)) > 8 ? 8
                                        : 32 / (BB * (int)sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int rows_smem(int K, int BB) {
  return K * BB * (int)sizeof(T) + K * 4;                 // xs, then vs
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one 16-byte chunk of a packed row: CW values and their CW int8 slots
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int CW = 8;
  using Idx = uint2;
  __device__ static float val(const uint4& v, int e) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    return __bfloat162float(h[e]);
  }
  __device__ static int slot(const uint2& s, int e) {
    return (int)(((e < 4 ? s.x : s.y) >> (8 * (e & 3))) & 0xffu);
  }
};
template <> struct Chunk<float> {
  static constexpr int CW = 4;
  using Idx = unsigned;
  __device__ static float val(const uint4& v, int e) {
    return reinterpret_cast<const float*>(&v)[e];
  }
  __device__ static int slot(const unsigned& s, int e) { return (int)((s >> (8 * e)) & 0xffu); }
};

// the BB batch inputs of one kept column, one vector load from shared memory
template <typename T, int BB>
struct alignas(BB * sizeof(T) >= 16 ? 16 : BB * sizeof(T)) XPack { T v[BB]; };

template <typename T, int BB, int PRE, bool XF>
__global__ void __launch_bounds__(ROW_WARPS * 32, PRE == 1 && BB <= 4 ? 5 : 2)
spmm_rows(const T* __restrict__ x, const T* __restrict__ vals,
          const int8_t* __restrict__ nm_idx, const int* __restrict__ vec_idx,
          T* __restrict__ y, int B, int n_in, int n_out, int V, int K, int Kn,
          int N, int M, int xf_bytes, int nby) {
  using C = Chunk<T>;
  // blockIdx.y = expert * nby + batch block: step to the expert's operands
  const int e = blockIdx.y / nby, by = blockIdx.y - e * nby;
  x += (size_t)e * B * n_in;
  vals += (size_t)e * n_out * Kn;
  nm_idx += (size_t)e * n_out * Kn;
  vec_idx += (size_t)e * (n_out / V) * K;
  y += (size_t)e * B * n_out;
  using XP = XPack<T, BB>;
  using Idx = typename C::Idx;
  constexpr int CW = C::CW;
  {   // the row's weights and the tile's vec_idx head for L2 while the
      // kernel before finishes; nothing is read or written before pdl_wait
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const size_t row = (size_t)blockIdx.x * ROW_WARPS + w;
    prefetch_l2(vals + row * Kn, Kn * (int)sizeof(T), l, 32);
    prefetch_l2(nm_idx + row * Kn, Kn, l, 32);
    if (w == 0) prefetch_l2(vec_idx + (size_t)(blockIdx.x * ROW_WARPS / V) * K, K * 4, l, 32);
  }
  pdl_wait();
  pdl_trigger();
  extern __shared__ __align__(16) unsigned char smem[];
  T* xf = reinterpret_cast<T*>(smem);                     // x rows b0.., whole (XF)
  XP* xs = reinterpret_cast<XP*>(smem + xf_bytes);        // xs[k].v[b]
  int* vs = reinterpret_cast<int*>(smem + xf_bytes + (size_t)K * sizeof(XP));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;            // output row, packed order
  const int t = (blockIdx.x * ROW_WARPS) / V;
  const int b0 = by * BB;
  const int nb = min(BB, B - b0);
  const T* vr = vals + (size_t)r * Kn;
  const int8_t* sr = nm_idx + (size_t)r * Kn;
  const bool vec = (reinterpret_cast<uintptr_t>(vr) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(sr) & (CW - 1)) == 0;
  const int nchunk = vec ? Kn / CW : 0;

  // the row's first weights, in flight while the block stages x and vec_idx
  uint4 wv[PRE];
  Idx wi[PRE];
#pragma unroll
  for (int p = 0; p < PRE; ++p) {
    const int c = lane + 32 * p;
    if (c < nchunk) {
      wv[p] = __ldg(reinterpret_cast<const uint4*>(vr) + c);
      wi[p] = __ldg(reinterpret_cast<const Idx*>(sr) + c);
    }
  }

  // small x: its nb rows copied whole (coalesced, no dependence on vec_idx),
  // so weights, x and vec_idx take one DRAM round trip together
  if (XF) {
    const T* src = x + (size_t)b0 * n_in;
    const int n = nb * n_in;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n * (int)sizeof(T)) % 16 == 0)
      for (int i = threadIdx.x * CW; i < n; i += blockDim.x * CW) cp_async16(xf + i, src + i);
    else
      for (int i = threadIdx.x; i < n; i += blockDim.x) xf[i] = src[i];
  }
  stage_vec_idx(vs, vec_idx + (size_t)t * K, K);          // waits for both copies
  constexpr int GATHER_U = gather_u<T, BB>();
  for (int k0 = threadIdx.x; k0 < K; k0 += GATHER_U * blockDim.x) {
    XP pk[GATHER_U];                                      // GATHER_U columns' loads in flight
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      const int k = k0 + u * blockDim.x;
      const int col = k < K ? vs[k] : 0;
#pragma unroll
      for (int b = 0; b < BB; ++b)
        pk[u].v[b] = !(k < K && b < nb) ? from_f<T>(0.f)
                     : XF ? xf[b * n_in + col] : x[(size_t)(b0 + b) * n_in + col];
    }
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u)
      if (k0 + u * blockDim.x < K) xs[k0 + u * blockDim.x] = pk[u];
  }
  __syncthreads();

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.f;
  auto fma_chunk = [&](const uint4& v, const Idx& s, int c) {
    int q = (c * CW) / N, rr = c * CW - q * N;            // group and place of value c*CW
#pragma unroll
    for (int e = 0; e < CW; ++e) {
      const float w = C::val(v, e);
      const XP xv = xs[q * M + C::slot(s, e)];
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = fmaf(w, to_f(xv.v[b]), acc[b]);
      if (++rr == N) { rr = 0; ++q; }
    }
  };
#pragma unroll
  for (int p = 0; p < PRE; ++p) {
    const int c = lane + 32 * p;
    if (c < nchunk) fma_chunk(wv[p], wi[p], c);
  }
  for (int c = lane + 32 * PRE; c < nchunk; c += 32)
    fma_chunk(__ldg(reinterpret_cast<const uint4*>(vr) + c),
              __ldg(reinterpret_cast<const Idx*>(sr) + c), c);
  for (int j = nchunk * CW + lane; j < Kn; j += 32) {      // scalar tail
    const float w = to_f(vr[j]);
    const XP xv = xs[(j / N) * M + (int)sr[j]];
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[b] = fmaf(w, to_f(xv.v[b]), acc[b]);
  }

#pragma unroll
  for (int b = 0; b < BB; ++b) {
    float a = acc[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[b] = a;
  }
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (lane == b && b < nb) y[(size_t)(b0 + b) * n_out + r] = from_f<T>(acc[b]);
}

template <typename T, int BB, int PRE, bool XF>
cudaError_t launch_rows(const void* x, const void* vals, const void* nm_idx,
                        const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                        int K, int Kn, int N, int M, int xf_bytes, int E, cudaStream_t s) {
  static int smem_set = 0;
  const int smem = xf_bytes + rows_smem<T>(K, BB);
  const int nby = (B + BB - 1) / BB;
  if ((long long)E * nby > 65535) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(spmm_rows<T, BB, PRE, XF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int n_out = T_ * V;
  dim3 grid(n_out / ROW_WARPS, E * nby);
  return launch_pdl(spmm_rows<T, BB, PRE, XF>, grid, dim3(ROW_WARPS * 32), smem, s,
                    static_cast<const T*>(x), static_cast<const T*>(vals),
                    static_cast<const int8_t*>(nm_idx), static_cast<const int*>(vec_idx),
                    static_cast<T*>(y), B, n_in, n_out, V, K, Kn, N, M, xf_bytes, nby);
}

// rows of at most one 16-byte chunk a lane preload one (few registers, so
// many blocks resident); longer rows preload PRE_LONG.  XF: x staged whole
template <typename T, int BB, bool XF>
cudaError_t launch_rows_shape(const void* x, const void* vals, const void* nm_idx,
                              const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                              int K, int Kn, int N, int M, int xf, int E, cudaStream_t s) {
  if (Kn <= 32 * Chunk<T>::CW)
    return launch_rows<T, BB, 1, XF>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M,
                                     xf, E, s);
  return launch_rows<T, BB, PRE_LONG, XF>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn,
                                          N, M, xf, E, s);
}

template <typename T, int BB>
cudaError_t launch_rows_xf(const void* x, const void* vals, const void* nm_idx,
                           const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                           int K, int Kn, int N, int M, int E, cudaStream_t s) {
  const int xf = ((B < BB ? B : BB) * n_in * (int)sizeof(T) + 15) & ~15;
  constexpr bool small = std::is_same<T, __nv_bfloat16>::value && BB <= 4;
  if (small && xf <= XF_MAX && xf + rows_smem<T>(K, BB) <= MAX_SMEM)
    return launch_rows_shape<T, BB, small>(
        x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, xf, E, s);
  return launch_rows_shape<T, BB, false>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn,
                                         N, M, 0, E, s);
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const void* vals, const void* nm_idx,
                          const void* vec_idx, void* y, int B, int n_in, int T_, int V,
                          int K, int Kn, int N, int M, int E, cudaStream_t s) {
  int bb = B <= 1 ? 1 : B <= 4 ? 4 : B <= 8 ? 8 : 16;
  while (bb > 1 && rows_smem<T>(K, bb) > MAX_SMEM) bb = bb == 4 ? 1 : bb / 2;
  if (rows_smem<T>(K, bb) > MAX_SMEM) return cudaErrorInvalidValue;
  switch (bb) {
    case 1: return launch_rows_xf<T, 1>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s);
    case 4: return launch_rows_xf<T, 4>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s);
    case 8: return launch_rows_xf<T, 8>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s);
    default: return launch_rows_xf<T, 16>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s);
  }
}

// ---------------------------------------------------------------- variant B
constexpr int BM_MAX = 128;         // batch rows of a block (MMA M side): 64 or 128
constexpr int KC = 64;              // kept columns per chunk (MMA K side)
constexpr int STAGES = 4;           // depth of the cp.async ring
constexpr int WS_LD = KC + 8;       // dense weight row (KC kept columns), padded
constexpr int MMA_V_MAX = 64;       // a warp owns 32 batch rows x 32 tile rows
constexpr int MMA_WARPS = 8;        // (BM/32) x (V/32) warp tiles x KSPLIT k-step groups
constexpr int MMA_BM128_BLOCKS = 100;     // BM = 128 while that keeps ~one block per SM
constexpr int MMA_SPLIT_BLOCKS = 132;     // split K while the grid has fewer blocks

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

struct MmaSmem {                    // byte offsets of one block's dynamic shared memory
  int xs, wv, wi, stage, ws, vs, total;
  __host__ __device__ MmaSmem(int BM, int V, int PK, int K) {
    xs = 0;                         // ring stage: xs[KC][BM + 8], raw vals, raw nm_idx
    wv = KC * (BM + 8) * 2;
    wi = wv + round16(V * PK * 2);
    stage = wi + round16(V * PK);
    ws = STAGES * stage;            // two dense weight tiles ws[V][WS_LD]
    vs = ws + 2 * V * WS_LD * 2;    // the tile's vec_idx
    total = vs + K * 4;
    // the k-step groups' sums, (MMA_WARPS - warp tiles) x 4 KB, reuse the ring:
    // at most 24 KB, and the ring is over 36 KB for every BM and V taken
  }
};

// xt (n_in, Bp) = x (B, n_in)^T, zero in the columns b >= B, per expert
// (blockIdx.y = expert * Bp/64 + batch tile).  64 x 64 tiles,
// 16-byte loads and stores; the tile's 16-byte segments are XOR-swizzled by
// row so the column reads of the store phase hit distinct banks.
__global__ void __launch_bounds__(256)
transpose_pad(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xt, int B,
              int n_in, int Bp) {
  __shared__ __align__(16) unsigned short tile[64 * 64];  // [b][k], bf16 bits
  pdl_wait();
  pdl_trigger();                    // spmm_mma may start its prologue
  const int nby = Bp / 64, e = blockIdx.y / nby;
  x += (size_t)e * B * n_in;
  xt += (size_t)e * n_in * Bp;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  const int k0 = blockIdx.x * 64, b0 = (blockIdx.y - e * nby) * 64;
  const bool vec = n_in % 8 == 0 && k0 + 64 <= n_in && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
    const int b = i >> 3, seg = i & 7, bb = b0 + b, k = k0 + seg * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (bb < B) {
      if (vec) {
        v = *reinterpret_cast<const uint4*>(xb + (size_t)bb * n_in + k);
      } else {
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned lo = k + 2 * q < n_in ? xb[(size_t)bb * n_in + k + 2 * q] : 0u;
          const unsigned hi = k + 2 * q + 1 < n_in ? xb[(size_t)bb * n_in + k + 2 * q + 1] : 0u;
          w[q] = lo | (hi << 16);
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(tile + b * 64 + ((seg ^ (b >> 3)) & 7) * 8) = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
    const int kk = i >> 3, seg = i & 7, k = k0 + kk;
    if (k >= n_in) continue;
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = seg * 8 + 2 * q;                      // rows b, b+1 share b >> 3 = seg
      const int off = (((kk >> 3) ^ seg) & 7) * 8 + (kk & 7);
      w[q] = (unsigned)tile[b * 64 + off] | ((unsigned)tile[(b + 1) * 64 + off] << 16);
    }
    *reinterpret_cast<uint4*>(xt + (size_t)k * Bp + b0 + seg * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 16-bit lane `s` (0..3) of a group of four dense slots holding the two kept
// values v (low, high half of `v2`) at slots i0 and i1
__device__ __forceinline__ unsigned slot_val(unsigned v2, int i0, int i1, int s) {
  return i0 == s ? (v2 & 0xffffu) : i1 == s ? (v2 >> 16) : 0u;
}

template <int BM>
__global__ void __launch_bounds__(MMA_WARPS * 32)
spmm_mma(const __nv_bfloat16* __restrict__ xt, const __nv_bfloat16* __restrict__ vals,
         const int8_t* __restrict__ nm_idx, const int* __restrict__ vec_idx,
         __nv_bfloat16* __restrict__ y, float* __restrict__ part, int B, int Bp, int n_out,
         int V, int K, int Kn, int N, int M, int fast, int cps, int n_in, int nby) {
  constexpr int XS_LD = BM + 8;     // xs row (one kept column's BM inputs), padded
  constexpr int WM = BM / 32;       // warps along the batch
  extern __shared__ __align__(16) unsigned char smem[];
  const int PK = KC / M * N;                              // packed values per row per chunk
  const MmaSmem L(BM, V, PK, K);
  // blockIdx.y = expert * nby + batch block: step to the expert's operands
  const int e = blockIdx.y / nby, t = blockIdx.x, b0 = (blockIdx.y - e * nby) * BM;
  xt += (size_t)e * n_in * Bp;
  vals += (size_t)e * n_out * Kn;
  nm_idx += (size_t)e * n_out * Kn;
  vec_idx += (size_t)e * (n_out / V) * K;
  y += (size_t)e * B * n_out;
  if (part) part += (size_t)e * gridDim.z * B * n_out;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* vs = reinterpret_cast<int*>(smem + L.vs);
  const __nv_bfloat16* vt = vals + (size_t)t * V * Kn;
  const int8_t* st = nm_idx + (size_t)t * V * Kn;
  // split blockIdx.z takes chunks [c0, c0 + nc) and, when the grid is split
  // (part != nullptr), writes f32 partial sums that sum_splits adds up
  const int c0 = blockIdx.z * cps, nc = min((K + KC - 1) / KC - c0, cps);
  const bool nm24 = N == 2 && M == 4;

  // the thread's 16-byte copies of a chunk's packed rows (fast path), worked
  // out once: source at chunk 0, byte offset in the stage, log2 of the width
  constexpr int WQ = 3;             // V * (PK/8 + PK/16) <= 64 * 9 copies over 256 threads
  const char* wsrc[WQ];
  int wdst[WQ], wsh[WQ];
#pragma unroll
  for (int u = 0; u < WQ; ++u) {
    const int pv = PK / 8, pi = PK / 16, i = tid + u * MMA_WARPS * 32;
    const int row = i / (pv + pi), p = i % (pv + pi);
    wsrc[u] = nullptr;
    if (!fast || i >= V * (pv + pi)) continue;
    if (p < pv) {
      wsrc[u] = reinterpret_cast<const char*>(vt + (size_t)row * Kn + p * 8);
      wdst[u] = L.wv + (row * PK + p * 8) * 2;
      wsh[u] = 1;
    } else {
      wsrc[u] = reinterpret_cast<const char*>(st + (size_t)row * Kn + (p - pv) * 16);
      wdst[u] = L.wi + row * PK + (p - pv) * 16;
      wsh[u] = 0;
    }
  }

  // copy chunk c (x rows through vec_idx, raw packed rows) into ring stage s
  auto issue = [&](int c, int s) {
    unsigned char* base = smem + s * L.stage;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + L.xs);
    const int k0 = c * KC, kc = min(KC, K - k0);
#pragma unroll
    for (int i = tid; i < KC * (BM / 8); i += MMA_WARPS * 32) {   // a compile-time count
      const int kk = i / (BM / 8), part = i % (BM / 8);
      __nv_bfloat16* dst = xs + kk * XS_LD + part * 8;
      if (kk < kc)
        cp_async16(dst, xt + (size_t)vs[k0 + kk] * Bp + b0 + part * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    __nv_bfloat16* wv = reinterpret_cast<__nv_bfloat16*>(base + L.wv);
    int8_t* wi = reinterpret_cast<int8_t*>(base + L.wi);
    const int j0 = k0 / M * N, pk = kc / M * N;
    if (fast && pk == PK) {                               // 16-byte rows: PK % 16 == 0
#pragma unroll
      for (int u = 0; u < WQ; ++u)
        if (wsrc[u]) cp_async16(base + wdst[u], wsrc[u] + ((size_t)j0 << wsh[u]));
    } else {
      for (int i = tid; i < V * pk; i += blockDim.x) {
        const int row = i / pk, jj = i % pk;
        wv[row * PK + jj] = vt[(size_t)row * Kn + j0 + jj];
        wi[row * PK + jj] = st[(size_t)row * Kn + j0 + jj];
      }
    }
  };

  // dense bf16 tile ws[v][k] of chunk c (ring stage s), zeros in the pruned slots
  auto decompress = [&](int c, int s, __nv_bfloat16* ws) {
    const unsigned char* base = smem + s * L.stage;
    const __nv_bfloat16* wv = reinterpret_cast<const __nv_bfloat16*>(base + L.wv);
    const int8_t* wi = reinterpret_cast<const int8_t*>(base + L.wi);
    const int kc = min(KC, K - c * KC);
    if (nm24 && kc == KC) {         // 2:4, whole chunk: 4 packed values -> 8 dense, vectorised
      for (int i = tid; i < V * (KC / 8); i += blockDim.x) {
        const int row = i / (KC / 8), h = i % (KC / 8);
        const uint2 v = *reinterpret_cast<const uint2*>(wv + row * PK + h * 4);
        const unsigned s4 = *reinterpret_cast<const unsigned*>(wi + row * PK + h * 4);
        unsigned d[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {                     // group q: values, slots 2q and 2q+1
          const unsigned v2 = q ? v.y : v.x;
          const int i0 = (s4 >> (16 * q)) & 0xff, i1 = (s4 >> (16 * q + 8)) & 0xff;
          d[2 * q] = slot_val(v2, i0, i1, 0) | (slot_val(v2, i0, i1, 1) << 16);
          d[2 * q + 1] = slot_val(v2, i0, i1, 2) | (slot_val(v2, i0, i1, 3) << 16);
        }
        *reinterpret_cast<uint4*>(ws + row * WS_LD + h * 8) = make_uint4(d[0], d[1], d[2], d[3]);
      }
    } else {                        // any N:M with M | KC, and a partial last chunk
      const int GR = KC / M;
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < V * GR; i += blockDim.x) {
        const int row = i / GR, grp = i % GR;
        __nv_bfloat16* d = ws + row * WS_LD + grp * M;
        for (int e = 0; e < M; ++e) d[e] = zero;
        if (grp * M < kc)
          for (int n = 0; n < N; ++n) d[wi[row * PK + grp * N + n]] = wv[row * PK + grp * N + n];
      }
    }
  };

  float acc[2][4][4];               // [m-tile][n-tile][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
  // warp = (k-step group kg, warp tile wt = (wn, wm)); the KSPLIT groups
  // split each chunk's KC/16 k-steps and are summed at the end
  const int WT = WM * ((V + 31) / 32), KSPLIT = MMA_WARPS / WT;
  const int kg = warp / WT, wt = warp % WT, wm = wt % WM, wn = wt / WM, ntiles = V / 8;
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* ws0 = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);

  stage_vec_idx(vs, vec_idx + (size_t)t * K, K);
  // launched early behind transpose_pad, whose only output is xt: everything
  // above read data written before it started; wait before copying x
  pdl_wait();
  pdl_trigger();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) issue(c0 + s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  decompress(c0, 0, ws0);
  for (int i = 0; i < nc; ++i) {   // chunk c0 + i, ring stage i % STAGES, dense tile i % 2
    cp_async_wait<STAGES - 3>();
    __syncthreads();          // chunk i+1 landed, ws[i%2] is written; chunk i-1 is done with
    if (i + STAGES - 1 < nc) issue(c0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    if (i + 1 < nc) decompress(c0 + i + 1, (i + 1) % STAGES, ws0 + ((i + 1) & 1) * V * WS_LD);

    const unsigned ws_s = (unsigned)__cvta_generic_to_shared(ws0 + (i & 1) * V * WS_LD);
    const unsigned xs_s = (unsigned)__cvta_generic_to_shared(smem + (i % STAGES) * L.stage + L.xs);
#pragma unroll
    for (int q = 0; q < KC / 16; ++q) {
      const int ks = kg + q * KSPLIT;
      if (ks >= KC / 16) break;
      unsigned a[2][4];
      const int kr = ks * 16 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int bc = wm * 32 + m * 16 + ((lane >> 3) & 1) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[m][0]), "=r"(a[m][1]), "=r"(a[m][2]), "=r"(a[m][3])
            : "r"(xs_s + (unsigned)(kr * XS_LD + bc) * 2));
      }
      // B fragments of n-tiles (nt, nt+1) by one ldmatrix.x4 on ws[v][k]
      // (matrix q: tile nt + q/2, k half q%2); a lone last tile by .x2
      unsigned bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int nt = wn * 4 + j;
        const int q = lane >> 3;
        const unsigned addr = ws_s + (unsigned)(((nt + (q >> 1)) * 8 + (lane & 7)) * WS_LD +
                                                ks * 16 + (q & 1) * 8) * 2;
        if (nt + 1 < ntiles)
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(bf[j][0]), "=r"(bf[j][1]), "=r"(bf[j + 1][0]), "=r"(bf[j + 1][1])
                       : "r"(addr));
        else if (nt < ntiles)
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(bf[j][0]), "=r"(bf[j][1])
                       : "r"(addr));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (wn * 4 + j < ntiles) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(acc[m][j][0]), "+f"(acc[m][j][1]), "+f"(acc[m][j][2]), "+f"(acc[m][j][3])
                : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]), "r"(bf[j][0]),
                  "r"(bf[j][1]));
        }
      }
    }
  }

  // sum the k-step groups through the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);            // red[(kg-1)*WT + wt][e][lane]
  if (kg > 0) {
    float* r = red + (size_t)((kg - 1) * WT + wt) * 32 * 32 + lane;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[((m * 4 + j) * 4 + e) * 32] = acc[m][j][e];
  }
  __syncthreads();
  if (kg > 0) return;
  for (int o = 1; o < KSPLIT; ++o) {
    const float* r = red + (size_t)((o - 1) * WT + wt) * 32 * 32 + lane;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += r[((m * 4 + j) * 4 + e) * 32];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = wn * 4 + j;
      if (nt < ntiles) {
        const int col = t * V + nt * 8 + tig * 2;
        const int row = b0 + wm * 32 + m * 16 + g;
        if (part) {
          float* pz = part + (size_t)blockIdx.z * B * n_out + col;
          if (row < B)
            *reinterpret_cast<float2*>(pz + (size_t)row * n_out) =
                make_float2(acc[m][j][0], acc[m][j][1]);
          if (row + 8 < B)
            *reinterpret_cast<float2*>(pz + (size_t)(row + 8) * n_out) =
                make_float2(acc[m][j][2], acc[m][j][3]);
        } else {
          if (row < B)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * n_out + col) =
                __floats2bfloat162_rn(acc[m][j][0], acc[m][j][1]);
          if (row + 8 < B)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row + 8) * n_out + col) =
                __floats2bfloat162_rn(acc[m][j][2], acc[m][j][3]);
        }
      }
    }
}

// y = the sum of the S f32 partials part[z] (n values each, n % 4 == 0), in
// bf16, for expert blockIdx.y (its S partials, then its n outputs)
__global__ void sum_splits(const float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                           int n, int S) {
  pdl_wait();
  pdl_trigger();
  part += (size_t)blockIdx.y * S * n;
  y += (size_t)blockIdx.y * n;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < S; ++z) {
    const float4 b = *reinterpret_cast<const float4*>(part + (size_t)z * n + i);
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(a.x, a.y);
  *reinterpret_cast<__nv_bfloat162*>(y + i + 2) = __floats2bfloat162_rn(a.z, a.w);
}

int pad_batch(int B) { return (B + BM_MAX - 1) / BM_MAX * BM_MAX; }

bool mma_takes(int V, int M) { return V <= MMA_V_MAX && KC % M == 0; }

// a call's block shape: BM = 128 (half the x traffic of BM = 64) when that
// still gives about one block per SM, and
// K split S ways (S <= 8, at least two chunks a split) while the
// (tile, batch block) grid is under MMA_SPLIT_BLOCKS
struct MmaPlan {
  int bm, splits, cps;
  MmaPlan(int B, int T_, int V, int K) {
    bm = V <= 32 && (long long)T_ * ((B + 127) / 128) >= MMA_BM128_BLOCKS ? 128 : 64;
    const int blocks = T_ * ((B + bm - 1) / bm), nch = (K + KC - 1) / KC;
    splits = 1;
    while (splits < 8 && blocks * splits < MMA_SPLIT_BLOCKS && nch / (2 * splits) >= 2)
      splits *= 2;
    cps = (nch + splits - 1) / splits;
    splits = (nch + cps - 1) / cps;
  }
};

template <int BM>
cudaError_t launch_mma_bm(const __nv_bfloat16* xt, float* part, const void* vals,
                          const void* nm_idx, const void* vec_idx, void* y, int B, int Bp,
                          int T_, int V, int K, int Kn, int N, int M, const MmaPlan& plan,
                          int n_in, int E, cudaStream_t s) {
  static int smem_set = 0;
  const int PK = KC / M * N;
  const int smem = MmaSmem(BM, V, PK, K).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(spmm_mma<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int nby = (B + BM - 1) / BM;
  if ((long long)E * nby > 65535) return cudaErrorInvalidValue;
  const int fast = PK % 16 == 0 && Kn % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(vals) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(nm_idx) & 15) == 0;
  cudaError_t e = launch_pdl(
      spmm_mma<BM>, dim3(T_, E * nby, plan.splits), dim3(MMA_WARPS * 32), smem, s,
      xt, static_cast<const __nv_bfloat16*>(vals), static_cast<const int8_t*>(nm_idx),
      static_cast<const int*>(vec_idx), static_cast<__nv_bfloat16*>(y),
      plan.splits > 1 ? part : nullptr, B, Bp, T_ * V, V, K, Kn, N, M, fast, plan.cps, n_in,
      nby);
  if (e != cudaSuccess || plan.splits == 1) return e;
  const int n = B * T_ * V;
  return launch_pdl(sum_splits, dim3((n / 4 + 255) / 256, E), dim3(256), 0, s,
                    static_cast<const float*>(part), static_cast<__nv_bfloat16*>(y), n,
                    plan.splits);
}

cudaError_t launch_mma(const void* x, const void* vals, const void* nm_idx,
                       const void* vec_idx, void* y, void* scratch, int B, int n_in,
                       int T_, int V, int K, int Kn, int N, int M, int E, int T_plan,
                       cudaStream_t s) {
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const int Bp = pad_batch(B);
  const MmaPlan plan(B, T_plan, V, K);
  auto* xt = static_cast<__nv_bfloat16*>(scratch);
  float* part = reinterpret_cast<float*>(xt + (size_t)E * n_in * Bp);
  if ((long long)E * (Bp / 64) > 65535) return cudaErrorInvalidValue;
  cudaError_t e = launch_pdl(transpose_pad, dim3((n_in + 63) / 64, E * (Bp / 64)), dim3(256), 0, s,
                             static_cast<const __nv_bfloat16*>(x), xt, B, n_in, Bp);
  if (e != cudaSuccess) return e;
  if (plan.bm == 128)
    return launch_mma_bm<128>(xt, part, vals, nm_idx, vec_idx, y, B, Bp, T_, V, K, Kn, N, M,
                              plan, n_in, E, s);
  return launch_mma_bm<64>(xt, part, vals, nm_idx, vec_idx, y, B, Bp, T_, V, K, Kn, N, M,
                           plan, n_in, E, s);
}

}  // namespace

// Which variant a call runs: 0 = "rows" (A), 1 = "mma" (B).  dtype: 0 =
// float32, 1 = bfloat16 (x, vals and y share it).
extern "C" int hinm_spmm_variant(int B, int V, int M, int dtype) {
  return dtype == 1 && B > ROWS_MAX_B && mma_takes(V, M) ? 1 : 0;
}

// bf16 elements of the scratch a call of `variant` over E experts needs: for
// variant B each expert's transposed x, then each expert's f32 partial sums
// of a split K; 0 for variant A.  The plan is one expert's (that of a
// launch of the expert alone, so a stack's expert gives its bits), made for
// T_plan tiles (see hinm_spmm_launch).
extern "C" long long hinm_spmm_scratch_elems(int variant, int E, int B, int n_in, int T_,
                                             int V, int K, int T_plan) {
  if (variant != 1) return 0;
  const MmaPlan plan(B, T_plan, V, K);
  return (long long)E * ((long long)n_in * pad_batch(B) +
                         (plan.splits > 1 ? 2LL * plan.splits * B * T_ * V : 0));
}

// Launch `variant` over a stack of E experts (E = 1: one matrix); B is one
// expert's rows.  T_plan is the tile count "mma" sizes its plan (BM, the
// K split) for: T_ for a whole matrix; a rank's T_ tiles of a T-sharded
// weight pass the whole weight's count, so each tile's sums run in the
// order the whole launch runs them and the slices concatenate bit for bit
// to it ("rows" has no split and ignores it).  Returns the cudaError_t of
// the launch (the Python wrapper raises when it is not 0).
// cudaErrorInvalidValue: a shape or variant the kernel does not take.
extern "C" int hinm_spmm_launch(int variant, int E, const void* x, const void* vals,
                                const void* nm_idx, const void* vec_idx, void* y,
                                void* scratch, int B, int n_in, int T_, int V, int K, int Kn,
                                int N, int M, int dtype, int T_plan, void* stream) {
  if (V <= 0 || V % 8 != 0 || N <= 0 || M <= N || K <= 0 || K % M != 0 ||
      Kn != K / M * N || B <= 0 || T_ <= 0 || n_in <= 0 || E <= 0 || T_plan < T_)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || !mma_takes(V, M)) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, vals, nm_idx, vec_idx, y, scratch, B, n_in, T_, V, K, Kn, N,
                           M, E, T_plan, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 1
      ? dispatch_rows<__nv_bfloat16>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s)
      : dispatch_rows<float>(x, vals, nm_idx, vec_idx, y, B, n_in, T_, V, K, Kn, N, M, E, s));
}
