// Paged-KV decode attention for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py:paged_decode_attn
// (_kernel): attention for s query rows per slot over the slot's KV rows,
// resolved page by page through its block table bt, with an online
// softmax.  The mask is kpos <= q_pos (which also hides sentinel pages and
// rollback-swept rows, whose kpos is 2**30) plus, with window > 0,
// kpos > q_pos - window.  GQA: the G query heads of a KV group stack into
// Gs = s*G rows, s-major (row r is query s-index r / G).  Scores and the
// accumulator are f32; the finite NEG_INF = -1e30 keeps a fully masked
// page from producing exp(-inf - -inf) = NaN, so rows whose every key is
// masked (idle lanes) give the same defined values as the reference, and
// the epilogue divides by max(l, 1e-30) as the reference does.  Every
// block-table entry is visited, sentinel pages included, as the reference
// does; skipping them early is a later optimisation that changes those rows.
//
// What bounds it on the H100: each (slot, KV head) reads its n_bt pages of
// K and V once (page*hd elements each) and does 4*Gs*hd flops per key, so
// it is bound by device-memory bytes; at serving sizes (a few slots, 16
// pages of 16 rows, 2 KV heads) that is a few hundred KB per layer and the
// launch itself dominates.
//
// Design: one thread block (128 threads) per (slot b, KV head).  The Gs
// pre-scaled query rows and the f32 accumulator live in shared memory; per
// page the block stages K (rows padded by one float against bank
// conflicts), V and kpos in shared memory, computes the Gs x page masked
// scores, one thread per row does the online-softmax statistics in the
// reference's order (m_new = max(m, max s); p = exp(s - m_new);
// corr = exp(m - m_new); l = l*corr + sum p), and the block updates
// acc = acc*corr + p @ V.  G = 7 (not a power of two) and any s >= 1 are
// plain loop bounds.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int Gs, int hd, int page) {
  return sizeof(float) * ((size_t)2 * Gs * hd + (size_t)page * (hd + 1) +
                          (size_t)page * hd + (size_t)Gs * page + 3 * (size_t)Gs) +
         sizeof(int) * ((size_t)page + Gs);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ kpos,
                  const int* __restrict__ bt, const int* __restrict__ q_pos,
                  T* __restrict__ out, int S, int H, int KV, int hd, int page,
                  int n_bt, int window, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV, Gs = S * G, hdp = hd + 1;
  float* q_s = sm;                     // Gs * hd, pre-scaled f32
  float* acc = q_s + Gs * hd;          // Gs * hd
  float* k_s = acc + Gs * hd;          // page * hdp
  float* v_s = k_s + page * hdp;       // page * hd
  float* sc = v_s + page * hd;         // Gs * page scores, then probabilities
  float* m_s = sc + Gs * page;         // Gs running max
  float* l_s = m_s + Gs;               // Gs running sum
  float* c_s = l_s + Gs;               // Gs correction of this page
  int* kp_s = reinterpret_cast<int*>(c_s + Gs);  // page
  int* qp_s = kp_s + page;                        // Gs

  for (int i = tid; i < Gs * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, si = r / G, g = r - si * G;
    q_s[i] = to_f(q[(((size_t)b * S + si) * H + kvh * G + g) * hd + d]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < Gs; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = q_pos[(size_t)b * S + r / G];
  }
  for (int i = 0; i < n_bt; ++i) {
    __syncthreads();  // previous page fully consumed (and q/stat init visible)
    const size_t p = (size_t)bt[(size_t)b * n_bt + i];
    for (int idx = tid; idx < page * hd; idx += THREADS) {
      const int c = idx / hd, d = idx - c * hd;
      const size_t off = ((p * page + c) * KV + kvh) * hd + d;
      k_s[c * hdp + d] = to_f(k_pool[off]);
      v_s[idx] = to_f(v_pool[off]);
    }
    for (int c = tid; c < page; c += THREADS) kp_s[c] = kpos[p * page + c];
    __syncthreads();
    for (int idx = tid; idx < Gs * page; idx += THREADS) {
      const int r = idx / page, c = idx - r * page;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + c * hdp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      const int kp = kp_s[c], qp = qp_s[r];
      bool ok = kp <= qp;
      if (window > 0) ok = ok && (kp > qp - window);
      sc[idx] = ok ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < Gs; r += THREADS) {
      float* sr = sc + r * page;
      float mx = sr[0];
      for (int c = 1; c < page; ++c) mx = fmaxf(mx, sr[c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < page; ++c) {
        const float e = expf(sr[c] - m_new);
        sr[c] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
    for (int idx = tid; idx < Gs * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const float* pr = sc + r * page;
      float a = 0.f;
      for (int c = 0; c < page; ++c) a = fmaf(pr[c], v_s[c * hd + d], a);
      acc[idx] = acc[idx] * c_s[r] + a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < Gs * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd, si = r / G, g = r - si * G;
    out[(((size_t)b * S + si) * H + kvh * G + g) * hd + d] =
        from_f<T>(acc[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* kpos, const void* bt, const void* q_pos, void* out,
                   int B, int S, int H, int KV, int hd, int page, int n_bt,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(S * (H / KV), hd, page);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, KV);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(kpos),
      static_cast<const int*>(bt), static_cast<const int*>(q_pos),
      static_cast<T*>(out), S, H, KV, hd, page, n_bt, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// Returns the cudaError_t of the launch; the wrapper raises when it is not 0.
extern "C" int paged_attn_launch(const void* q, const void* k_pool, const void* v_pool,
                                 const void* kpos, const void* bt, const void* q_pos,
                                 void* out, int B, int S, int H, int KV, int hd,
                                 int page, int n_bt, int window, float scale,
                                 int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || page <= 0 || n_bt <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1
      ? launch<__nv_bfloat16>(q, k_pool, v_pool, kpos, bt, q_pos, out, B, S, H, KV,
                              hd, page, n_bt, window, scale, s)
      : launch<float>(q, k_pool, v_pool, kpos, bt, q_pos, out, B, S, H, KV, hd,
                      page, n_bt, window, scale, s);
  return (int)e;
}
