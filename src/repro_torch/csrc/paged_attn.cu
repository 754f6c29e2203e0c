// Paged-KV decode attention for sm_90a: split over the KV length, one combine.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py:paged_decode_attn
// (_kernel): attention for s query rows per slot over the slot's KV rows,
// resolved page by page through its block table bt.  The mask is
// kpos <= q_pos (which also hides sentinel pages and rollback-swept rows,
// whose kpos is 2**30) plus, with window > 0, kpos > q_pos - window.  GQA:
// the G query heads of a KV group stack into Gs = s*G rows, s-major (row r
// is query s-index r / G).  Scores and the accumulator are f32; a masked
// score is the finite NEG_INF = -1e30, so a row whose every key is masked
// (an idle lane) gets p = exp(s - m) = 1 for every visited key and the
// reference's answer, the mean of V over every visited table entry.  The
// epilogue divides by max(l, 1e-30) as the reference does.  Every
// block-table entry is visited, sentinel pages included: skipping a page
// that every row masks would change exactly those idle-lane rows.
//
// What bounds it on the H100: each (slot, KV head) reads its n_bt pages of
// K and V once and does 4*Gs*hd flops per key (~7 flops a byte in bf16 at
// s = 1, far under the card's ~295 ridge), so bytes bound it; at serving
// sizes (4 slots, 16 pages of 16 rows, 2 KV heads) that is a few hundred
// KB, ~0.1 us at 3.35 TB/s.  What it really pays is latency: a launch and
// the dependent DRAM round trips (table entry, then the page it names).
//
// The first design (one 128-thread block per (slot, KV head)) lost to that
// latency four ways: 8 blocks on 132 SMs; a serial walk over the table, a
// dependent bt read and four barriers per page with nothing of the next
// page in flight; 2-byte scalar loads; softmax statistics by one thread per
// row while the rest waited.  This design:
//   * split_kernel: one 256-thread block per (split, KV head, slot).  A split is a
//     contiguous run of table entries (split i of n covers entries
//     [i*n_bt/n, (i+1)*n_bt/n), never empty); the wrapper picks n from the
//     shapes alone (kernels/paged_attn.py:split_count), so a captured CUDA
//     graph stays valid whatever bt holds.  The block reads its table
//     entries once, then issues every K, V and kpos row of its pages as
//     cp.async copies (16 bytes a lane where rows are 16-byte aligned) and
//     waits once.  Scores: 8 lanes share a key, each holding a 16-byte
//     slice of its row, reduced by __shfl_xor_sync; the pre-scaled f32 q
//     sits in shared memory; a lane scores 8 query rows at once so their
//     shuffles overlap.  Softmax statistics: a warp takes 4 rows at once,
//     max and sum by shuffles.  p @ V: each thread owns a 16-byte slice of
//     one output row over a share of the keys, reduced by shuffles.  With one
//     split the block writes the output; otherwise it writes (m, l, acc) to
//     an f32 workspace the wrapper allocates.
//   * combine_kernel (only with more than one split): one warp per output
//     row: M = max m_i, w_i = exp(m_i - M), l = sum w_i l_i,
//     acc = sum w_i acc_i, out = acc / max(l, 1e-30) -- exact for every row,
//     an idle lane's included (all m_i = NEG_INF, so every w_i = 1).
// Both are programmatic dependent launches: each waits (griddepcontrol.wait)
// before it touches global memory, and split_kernel lets the combine's
// blocks get resident while it runs.  Nothing is carried between calls.
// CUDA cores only: at s = 1 tensor cores are not the lever (see above).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KEY_LANES = 8;                   // lanes that share one key's score
constexpr int KEY_GROUPS = THREADS / KEY_LANES;
constexpr int ROWS = 8;                        // query rows a key group scores at once
constexpr int ROWS_W = 4;                      // rows a warp's softmax reduces at once
static_assert(ROWS == KEY_LANES, "each lane of a key group keeps one of its rows");
constexpr size_t SMEM_MAX = 232448;            // 227 KB, a block's most on sm_90
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VE elements of T at p, widened to f32: one 16-byte load when VE*sizeof(T) is 16.
template <typename T, int VE>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VE]) {
  if constexpr (VE == 1) {
    f[0] = to_f(*p);
  } else if constexpr (sizeof(T) == 2) {
    static_assert(VE == 8, "bf16 vectors are 8 wide");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  } else {
    static_assert(VE == 4, "f32 vectors are 4 wide");
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
}

template <typename T, int VE>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VE]) {
  if constexpr (VE == 1) {
    *p = from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 2) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// f32 vectors of VE (the q rows in shared memory, the workspace partials)
template <int VE>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[VE]) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VE; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + j);
      f[j] = u.x, f[j + 1] = u.y, f[j + 2] = u.z, f[j + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VE; ++j) f[j] = p[j];
  }
}

template <int VE>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VE]) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VE; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VE; ++j) p[j] = f[j];
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES));
}

// one VE-element chunk of a K or V row into shared memory: cp.async where
// the chunk is 4 or 16 bytes, a plain copy for a lone bf16
template <typename T, int VE>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  constexpr int BYTES = VE * (int)sizeof(T);
  if constexpr (BYTES >= 4)
    cp_async<BYTES>(dst, src);
  else
    *dst = *src;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::); }

// Launch with programmatic stream serialization: the grid may be scheduled
// while the kernel before it in the stream finishes; each kernel here waits
// (griddepcontrol.wait) before it reads or writes global memory.
template <typename... P, typename... A>
cudaError_t launch_pdl(void (*kernel)(P...), dim3 grid, int smem, cudaStream_t s, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
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

// Shared memory of split_kernel for splits of up to max_pages pages, K and
// V rows staged at a stride of rs = hd + VE elements; the wrapper's
// split_count budgets against the same sum with VE at its 16 bytes.
size_t smem_bytes(int Gs, int hd, int rs, int page, int max_pages, int isz) {
  const size_t keys = (size_t)max_pages * page;
  const size_t head = sizeof(float) * ((size_t)Gs * hd + (size_t)Gs * keys + 2 * (size_t)Gs) +
                      sizeof(int) * (keys + Gs + max_pages);
  return ((head + 15) & ~(size_t)15) + 2 * keys * rs * isz;
}

// One block per (split, KV head, slot).  VE: elements of a row chunk, 16
// bytes' worth where rows are 16-byte aligned, else 1.
template <typename T, int VE>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ kpos,
             const int* __restrict__ bt, const int* __restrict__ q_pos,
             T* __restrict__ out, float* __restrict__ ws, int S, int H, int KV, int hd,
             int page, int n_bt, int n_splits, int max_pages, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / KV, Gs = S * G, C = hd / VE;  // C: chunks of a row
  const int e0 = (int)((long long)split * n_bt / n_splits);
  const int np = (int)((long long)(split + 1) * n_bt / n_splits) - e0;
  const int nk = np * page, max_keys = max_pages * page;

  float* q_s = reinterpret_cast<float*>(smem);  // Gs x hd, pre-scaled
  float* sc = q_s + Gs * hd;                    // Gs x nk scores, then p
  float* m_s = sc + Gs * max_keys;              // Gs
  float* l_s = m_s + Gs;                        // Gs
  int* kp_s = reinterpret_cast<int*>(l_s + Gs); // nk
  int* qp_s = kp_s + max_keys;                  // Gs
  int* pg_s = qp_s + Gs;                        // np
  const size_t head = reinterpret_cast<unsigned char*>(pg_s + max_pages) - smem;
  // K and V rows one 16-byte chunk (VE elements) apart beyond hd, so the
  // rows p @ V reads at once start on different banks
  const int rs = hd + VE;
  T* k_s = reinterpret_cast<T*>(smem + ((head + 15) & ~(size_t)15));  // nk x rs
  T* v_s = k_s + (size_t)max_keys * rs;                                // nk x rs

  pdl_wait();
  pdl_trigger();
  // the split's table entries, q (pre-scaled f32) and each row's position
  for (int i = tid; i < np; i += THREADS) pg_s[i] = bt[(size_t)b * n_bt + e0 + i];
  for (int i = tid; i < Gs * C; i += THREADS) {
    const int r = i / C, ch = i - r * C, si = r / G, g = r - si * G;
    float f[VE];
    load_vec<T, VE>(q + (((size_t)b * S + si) * H + kvh * G + g) * hd + ch * VE, f);
#pragma unroll
    for (int j = 0; j < VE; ++j) f[j] *= scale;
    store_f32<VE>(q_s + r * hd + ch * VE, f);
  }
  for (int r = tid; r < Gs; r += THREADS) qp_s[r] = q_pos[(size_t)b * S + r / G];
  __syncthreads();
  // every K, V and kpos row of the split's pages in flight at once; one wait
  for (int i = tid; i < nk * C; i += THREADS) {
    const int c = i / C, ch = i - c * C, e = c / page;
    const size_t off = (((size_t)pg_s[e] * page + (c - e * page)) * KV + kvh) * hd + ch * VE;
    stage<T, VE>(k_s + (size_t)c * rs + ch * VE, k_pool + off);
    stage<T, VE>(v_s + (size_t)c * rs + ch * VE, v_pool + off);
  }
  for (int c = tid; c < nk; c += THREADS) {
    const int e = c / page;
    cp_async<4>(kp_s + c, kpos + (size_t)pg_s[e] * page + (c - e * page));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: 8 lanes per key, each a 16-byte slice of the row, ROWS query
  // rows at once so their shuffles overlap; every lane of a warp runs the
  // same trip counts, so the shuffles see the whole warp
  const int grp = tid / KEY_LANES, sub = tid % KEY_LANES;
  for (int c0 = 0; c0 < nk; c0 += KEY_GROUPS) {
    const int c = c0 + grp;
    const bool valid = c < nk;
    const T* kr = k_s + (size_t)(valid ? c : 0) * rs;
    const int kp = valid ? kp_s[c] : 0;
    for (int r0 = 0; r0 < Gs; r0 += ROWS) {
      float s[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) s[j] = 0.f;
      for (int ch = sub; ch < C; ch += KEY_LANES) {
        float kf[VE];
        load_vec<T, VE>(kr + ch * VE, kf);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          if (r0 + j < Gs) {
            float qf[VE];
            load_f32<VE>(q_s + (r0 + j) * hd + ch * VE, qf);
#pragma unroll
            for (int e = 0; e < VE; ++e) s[j] = fmaf(qf[e], kf[e], s[j]);
          }
        }
      }
      float mine = 0.f;  // lane sub keeps row r0 + sub
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        s[j] += __shfl_xor_sync(FULL, s[j], 4);
        s[j] += __shfl_xor_sync(FULL, s[j], 2);
        s[j] += __shfl_xor_sync(FULL, s[j], 1);
        if (j == sub) mine = s[j];
      }
      const int r = r0 + sub;
      if (valid && r < Gs) {
        const int qp = qp_s[r];
        bool ok = kp <= qp;
        if (window > 0) ok = ok && (kp > qp - window);
        sc[r * nk + c] = ok ? mine : NEG_INF;
      }
    }
  }
  __syncthreads();

  // softmax statistics: a warp takes ROWS_W rows at once, lanes over the
  // keys, max and sum by shuffles
  const size_t part = (((size_t)b * KV + kvh) * n_splits + split) * Gs;  // this split's rows
  const size_t rows = (size_t)B * KV * n_splits * Gs;                    // all partial rows
  for (int r0 = warp * ROWS_W; r0 < Gs; r0 += WARPS * ROWS_W) {
    float mx[ROWS_W], sum[ROWS_W];
#pragma unroll
    for (int j = 0; j < ROWS_W; ++j) {
      mx[j] = NEG_INF;
      sum[j] = 0.f;
      if (r0 + j < Gs)
        for (int c = lane; c < nk; c += 32) mx[j] = fmaxf(mx[j], sc[(r0 + j) * nk + c]);
    }
#pragma unroll
    for (int j = 0; j < ROWS_W; ++j) mx[j] = warp_max(mx[j]);
#pragma unroll
    for (int j = 0; j < ROWS_W; ++j) {
      if (r0 + j < Gs) {
        float* sr = sc + (r0 + j) * nk;
        for (int c = lane; c < nk; c += 32) {
          const float e = expf(sr[c] - mx[j]);
          sr[c] = e;
          sum[j] += e;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS_W; ++j) sum[j] = warp_sum(sum[j]);
    if (lane < ROWS_W) {
      float m = mx[0], l = sum[0];
#pragma unroll
      for (int j = 1; j < ROWS_W; ++j)
        if (j == lane) m = mx[j], l = sum[j];
      const int r = r0 + lane;
      if (r < Gs) {
        m_s[r] = m;
        l_s[r] = l;
        if (n_splits > 1) {
          ws[rows * hd + part + r] = m;
          ws[rows * (hd + 1) + part + r] = l;
        }
      }
    }
  }
  __syncthreads();

  // p @ V: a thread owns one (row, chunk) over every kg-th key; the kg
  // threads of a (row, chunk) are neighbouring lanes, summed by shuffles.
  // kg comes from one query's G rows, not from Gs: each output row is then
  // summed in the same order whatever S is, so a speculative verify's row
  // i is bitwise the i-th single-row decode step's (same splits given)
  const int pairs = Gs * C;
  int kg = 1;
  while (kg < 32 && 2 * kg * G * C <= THREADS) kg *= 2;
  for (int t0 = 0; t0 < pairs * kg; t0 += THREADS) {
    const int t = t0 + tid, pair = t / kg, kq = t - pair * kg;
    const bool valid = pair < pairs;
    const int r = valid ? pair / C : 0, ch = pair - r * C;
    float acc[VE];
#pragma unroll
    for (int j = 0; j < VE; ++j) acc[j] = 0.f;
    if (valid) {
      const float* pr = sc + r * nk;
#pragma unroll 4
      for (int c = kq; c < nk; c += kg) {
        float vf[VE];
        load_vec<T, VE>(v_s + (size_t)c * rs + ch * VE, vf);
        const float p = pr[c];
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[j] = fmaf(p, vf[j], acc[j]);
      }
    }
    for (int o = kg / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < VE; ++j) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
    }
    if (valid && kq == 0) {
      if (n_splits == 1) {
        const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[j] = acc[j] / den;
        const int si = r / G, g = r - si * G;
        store_vec<T, VE>(out + (((size_t)b * S + si) * H + kvh * G + g) * hd + ch * VE, acc);
      } else {
        store_f32<VE>(ws + (part + r) * hd + ch * VE, acc);
      }
    }
  }
}

// One warp per output row (slot, KV head, row of Gs): the exact combine of
// the splits' (m, l, acc) partials.  Each warp keeps its w_i in shared
// memory (with its l_i: 2 * WARPS * n_splits floats) so the acc loads go
// out eight at a time.
template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int B, int S, int H,
               int KV, int hd, int n_splits) {
  extern __shared__ float w_all[];
  const int G = H / KV, Gs = S * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  float* w_s = w_all + 2 * warp * n_splits;  // m_i, then w_i
  float* l_s = w_s + n_splits;
  pdl_wait();
  pdl_trigger();
  if (row >= B * KV * Gs) return;  // whole warps only
  const int r = row % Gs, bh = row / Gs, kvh = bh % KV, b = bh / KV;
  const size_t rows = (size_t)B * KV * n_splits * Gs;
  const size_t first = (size_t)bh * n_splits * Gs + r;  // split 0's partial row
  const float* m = ws + rows * hd + first;              // m[i * Gs]
  const float* l = ws + rows * (hd + 1) + first;
  const float* acc = ws + first * hd;                   // acc[i * Gs * hd + d]
  float mx = NEG_INF, ls = 0.f;
  for (int i = lane; i < n_splits; i += 32) {  // m_i and l_i in flight together
    w_s[i] = m[(size_t)i * Gs];
    l_s[i] = l[(size_t)i * Gs];
    mx = fmaxf(mx, w_s[i]);
  }
  mx = warp_max(mx);
  for (int i = lane; i < n_splits; i += 32) {
    const float w = expf(w_s[i] - mx);
    w_s[i] = w;
    ls += w * l_s[i];
  }
  const float den = fmaxf(warp_sum(ls), 1e-30f);
  __syncwarp();  // every lane's w_i before any lane reads them all
  const int si = r / G, g = r - si * G;
  T* o = out + (((size_t)b * S + si) * H + kvh * G + g) * hd;
  for (int d = lane; d < hd; d += 32) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_splits; ++i) a = fmaf(w_s[i], acc[(size_t)i * Gs * hd + d], a);
    o[d] = from_f<T>(a / den);
  }
}

template <typename T, int VE>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* kpos,
                   const void* bt, const void* q_pos, void* out, void* ws, int B, int S,
                   int H, int KV, int hd, int page, int n_bt, int n_splits, int window,
                   float scale, cudaStream_t stream) {
  const int Gs = S * (H / KV);
  const int max_pages = (n_bt + n_splits - 1) / n_splits;
  const size_t smem = smem_bytes(Gs, hd, hd + VE, page, max_pages, (int)sizeof(T));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = split_kernel<T, VE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = launch_pdl(
      kern, dim3(n_splits, KV, B), (int)smem, stream, static_cast<const T*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(kpos), static_cast<const int*>(bt),
      static_cast<const int*>(q_pos), static_cast<T*>(out), static_cast<float*>(ws), S, H,
      KV, hd, page, n_bt, n_splits, max_pages, window, scale);
  if (e != cudaSuccess || n_splits == 1) return e;
  const size_t csmem = sizeof(float) * 2 * WARPS * n_splits;
  if (csmem > SMEM_MAX) return cudaErrorInvalidValue;
  if (csmem > 48 * 1024) {
    const cudaError_t e2 = cudaFuncSetAttribute(
        combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
    if (e2 != cudaSuccess) return e2;
  }
  return launch_pdl(combine_kernel<T>, dim3((B * KV * Gs + WARPS - 1) / WARPS), (int)csmem, stream,
                    static_cast<const float*>(ws), static_cast<T*>(out), B, S, H, KV, hd,
                    n_splits);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).  ws:
// f32 workspace of B*KV*n_splits*Gs*(hd + 2) floats, unused (may be null)
// when n_splits is 1.  Split i of n_splits covers table entries
// [i*n_bt/n_splits, (i+1)*n_bt/n_splits).  Returns the cudaError_t of the
// launches; the wrapper raises when it is not 0.
extern "C" int paged_attn_launch(const void* q, const void* k_pool, const void* v_pool,
                                 const void* kpos, const void* bt, const void* q_pos,
                                 void* out, void* ws, int B, int S, int H, int KV, int hd,
                                 int page, int n_bt, int n_splits, int window, float scale,
                                 int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || page <= 0 || n_bt <= 0 ||
      n_splits < 1 || n_splits > n_bt || (n_splits > 1 && ws == nullptr) ||
      B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isz = dtype == 1 ? 2 : 4;
  const bool vec = (hd * isz) % 16 == 0 && aligned16(q) && aligned16(k_pool) &&
                   aligned16(v_pool) && aligned16(out) && aligned16(ws);
  cudaError_t e;
  if (dtype == 1)
    e = vec ? launch<__nv_bfloat16, 8>(q, k_pool, v_pool, kpos, bt, q_pos, out, ws, B, S, H,
                                       KV, hd, page, n_bt, n_splits, window, scale, s)
            : launch<__nv_bfloat16, 1>(q, k_pool, v_pool, kpos, bt, q_pos, out, ws, B, S, H,
                                       KV, hd, page, n_bt, n_splits, window, scale, s);
  else
    e = vec ? launch<float, 4>(q, k_pool, v_pool, kpos, bt, q_pos, out, ws, B, S, H, KV, hd,
                               page, n_bt, n_splits, window, scale, s)
            : launch<float, 1>(q, k_pool, v_pool, kpos, bt, q_pos, out, ws, B, S, H, KV, hd,
                               page, n_bt, n_splits, window, scale, s);
  return (int)e;
}
