// Paged single-token GQA decode attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py ::
// paged_attention (body _paged_kernel). Bound through ctypes by
// src/repro_torch/kernels/paged_attention.py, whose docstring states what
// bounds it on the card and what this design does about it.
//
// One CTA per (kv head, batch row), 256 threads, serving all g query rows
// of the group. The CTA stages its q rows (rounded to bf16) and its own
// page-table row in shared memory, then in three fixed-order passes:
//   1. one thread per visible slot (slot <= pos[b]) reads the slot's K row
//      and writes s = (bf16 q . bf16 k) * scale for every query row;
//   2. one warp per query row takes m = max, p = exp(s - m), l = sum p and
//      stores bf16(p / l), the exact global softmax of the TPU kernel;
//   3. one thread per (query row, dim) sums bf16(p / l) * bf16 v over the
//      visible slots in slot order.
// Masked slots are skipped: the TPU kernel gives them exp(-inf) = 0. No
// atomics and no order that depends on anything but pos[b], so each
// row's bits are independent of batch size, padding lanes and page
// placement.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;  // query rows per kv head (the wrapper checks)
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool_k,
                       const __nv_bfloat16* __restrict__ pool_v,
                       const int* __restrict__ pages,
                       const int* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ scratch, int kv, int g,
                       int page_size, int n_pages, int pool_pages,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int s_max = n_pages * page_size;
  const int n = max(0, min(pos[b] + 1, s_max));  // visible slots
  float* sq = smem;                                        // g * HD
  int* spage = reinterpret_cast<int*>(sq + g * HD);        // n_pages
  float* S = scratch != nullptr                            // g * s_max
                 ? scratch + (size_t)(b * kv + h) * g * s_max
                 : reinterpret_cast<float*>(spage + n_pages);

  const __nv_bfloat16* qb = q + (size_t)(b * kv + h) * g * HD;
  for (int i = tid; i < g * HD; i += THREADS) sq[i] = __bfloat162float(qb[i]);
  for (int i = tid; i < n_pages; i += THREADS)
    spage[i] = min(max(pages[(size_t)b * n_pages + i], 0), pool_pages - 1);
  __syncthreads();

  // 1. scores
  for (int slot = tid; slot < n; slot += THREADS) {
    const size_t row = (size_t)spage[slot / page_size] * page_size + slot % page_size;
    const uint4* krow = reinterpret_cast<const uint4*>(pool_k + (row * kv + h) * HD);
    float acc[MAXG];
#pragma unroll
    for (int j = 0; j < MAXG; ++j) acc[j] = 0.f;
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 raw = krow[c];
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(k2[t]);
        kf[2 * t] = f.x;
        kf[2 * t + 1] = f.y;
      }
#pragma unroll
      for (int j = 0; j < MAXG; ++j) {
        if (j < g) {
          const float* qj = sq + j * HD + c * 8;
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[j] = fmaf(qj[t], kf[t], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXG; ++j)
      if (j < g) S[(size_t)j * s_max + slot] = acc[j] * scale;
  }
  __syncthreads();

  // 2. global softmax, one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int j = warp; j < g; j += WARPS) {
    float* Sj = S + (size_t)j * s_max;
    float m = -INFINITY;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, Sj[s]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(Sj[s] - m);
      Sj[s] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
    for (int s = lane; s < n; s += 32)
      Sj[s] = __bfloat162float(__float2bfloat16(Sj[s] / l));
  }
  __syncthreads();

  // 3. o = sum over visible slots of bf16(p / l) * bf16 v, in slot order
  for (int i = tid; i < g * HD; i += THREADS) {
    const int j = i / HD, d = i % HD;
    const float* Sj = S + (size_t)j * s_max;
    float acc = 0.f;
    for (int s = 0; s < n; ++s) {
      const size_t row = (size_t)spage[s / page_size] * page_size + s % page_size;
      acc = fmaf(Sj[s], __bfloat162float(pool_v[(row * kv + h) * HD + d]), acc);
    }
    out[((size_t)(b * kv + h) * g + j) * HD + d] = acc;
  }
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* pages, const void* pos, void* out, void* scratch, int B,
           int kv, int g, int page_size, int n_pages, int pool_pages,
           float scale, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<HD><<<dim3(kv, B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(scratch), kv, g, page_size, n_pages, pool_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,kv,g,hd) bf16; pools (pool_pages,page_size,kv,hd) bf16; pages
// (B,n_pages) int32; pos (B,) int32; out (B,kv,g,hd) f32; scratch
// (B,kv,g,n_pages*page_size) f32 or null (then the scores live in the
// `smem` bytes of shared memory). Returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* pool_k,
                                   const void* pool_v, const void* pages,
                                   const void* pos, void* out, void* scratch,
                                   int B, int kv, int g, int hd, int page_size,
                                   int n_pages, int pool_pages, float scale,
                                   int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, pool_k, pool_v, pages, pos, out, scratch, B, kv, g,
                      page_size, n_pages, pool_pages, scale, smem, s);
  if (hd == 128)
    return launch<128>(q, pool_k, pool_v, pages, pos, out, scratch, B, kv, g,
                       page_size, n_pages, pool_pages, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
