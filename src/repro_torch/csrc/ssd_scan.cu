// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py :: ssd_scan (body
// _ssd_kernel). Bound through ctypes by src/repro_torch/kernels/ssd_scan.py,
// whose docstring states what bounds it on the card, what this design does
// about it, and its rounding and determinism contracts.
//
// One CTA per (head h, batch row b), 256 threads, walking the sequence in
// sub-chunks of Q steps (chunk / pipeline) in order. The running state
// (P x N, f32) lives in shared memory across sub-chunks, as the TPU kernel
// keeps it in VMEM scratch. Per sub-chunk:
//   1. warp 0 takes a_cs = cumsum(a) (each lane a contiguous run, then a
//      fixed shuffle scan of the lane totals);
//   2. for each tile of TILE query rows: y = exp(a_cs[q]) c_q . state, then
//      for each key tile up to the diagonal, L = (c . b^T) masked by
//      exp(a_cs[q] - a_cs[k]) for k <= q (never evaluated for k > q, where
//      it would overflow), y += L x; y is written in x's dtype;
//   3. state = exp(a_cs[-1]) state + sum_k exp(a_cs[-1] - a_cs[k]) x_k b_k^T.
// After the last sub-chunk the state goes to state_out when it is given.
// Every product runs on the CUDA cores in f32 over tiles staged in shared
// memory; loop orders are fixed and there are no atomics, so row b's bits
// do not depend on the batch.
//
// The model layout is read through strides (last dim unit-stride): x
// (B,L,H,P), a (B,L,H), b/c (B,L,G,N); y (B,L,H,P) is written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // rows per tile (the wrapper's TILE)
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, l, h;  // elements; h is the head (x, a) or group (b, c) stride
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [r0, r0 + TILE) of a (len x W) strided matrix into a padded f32 tile
// (row stride LD); rows past `len` are zero. `acs`, if given, multiplies
// row r by expf(scale_ref - acs[r0 + r]).
template <typename E, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const E* src, long long row_stride,
                                          int r0, int len, const float* acs,
                                          float scale_ref) {
  for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
    const int r = i / W, col = i % W;
    float v = 0.f;
    if (r0 + r < len) {
      v = to_f(src[(long long)(r0 + r) * row_stride + col]);
      if (acs != nullptr) v *= expf(scale_ref - acs[r0 + r]);
    }
    dst[r * LD + col] = v;
  }
}

template <typename E, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const E* __restrict__ x, const float* __restrict__ a,
                const E* __restrict__ bm, const E* __restrict__ cm,
                E* __restrict__ y, float* __restrict__ state_out, int L, int Q,
                int h_per_g, Strides sx, Strides sa, Strides sb, Strides sc) {
  constexpr int NP = N + 1;     // padded rows: conflict-free column walks
  constexpr int TP = TILE + 1;
  constexpr int YJ = P / 16;    // y / L tiles: rows ty*4+i, cols tx+16j
  constexpr int SI = P / 8;     // state: rows sp+8i, cols sn+32j
  constexpr int SJ = N / 32;
  extern __shared__ __align__(16) float smem[];
  float* st = smem;             // P x NP     running state
  float* cs = st + P * NP;      // TILE x NP  c rows of the query tile
  float* bs = cs + TILE * NP;   // TILE x NP  b rows of the key tile
  float* xs = bs + TILE * NP;   // TILE x P   x rows of the key tile
  float* ls = xs + TILE * P;    // TILE x TP  masked, decayed c . b
  float* acs = ls + TILE * TP;  // Q          cumsum of a over the sub-chunk

  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / h_per_g;
  const int ty = tid / 16, tx = tid % 16;
  const int sp = tid / 32, sn = tid % 32;
  const int n_tiles = (Q + TILE - 1) / TILE;
  const E* xb = x + b * sx.b + h * sx.h;
  const float* ab = a + b * sa.b + h * sa.h;
  const E* bb = bm + b * sb.b + g * sb.h;
  const E* cb = cm + b * sc.b + g * sc.h;
  const long long y_row = (long long)H * P;
  E* yb = y + (long long)b * L * y_row + (long long)h * P;

  for (int i = tid; i < P * NP; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();  // the last sub-chunk's readers of acs and st are done
    if (tid < 32) {   // 1. a_cs
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += ab[(long long)(c0 + i) * sa.l];
        acs[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, o);
        if (tid >= o) incl += v;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int i = lo; i < hi; ++i) acs[i] += excl;
    }
    __syncthreads();
    const float a_last = acs[Q - 1];

    // 2. y, one tile of query rows at a time
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * TILE;
      load_tile<E, N, NP>(cs, cb + (long long)c0 * sc.l, sc.l, q0, Q, nullptr, 0.f);
      __syncthreads();
      float acc[4][YJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < YJ; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {  // c_q . state
        float cv[4], sv[YJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < YJ; ++j) sv[j] = st[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < YJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        const float d = q < Q ? expf(acs[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < YJ; ++j) acc[i][j] *= d;
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TILE;
        __syncthreads();  // the last key tile's readers of bs, xs, ls are done
        load_tile<E, N, NP>(bs, bb + (long long)c0 * sb.l, sb.l, k0, Q, nullptr, 0.f);
        load_tile<E, P, P>(xs, xb + (long long)c0 * sx.l, sx.l, k0, Q, nullptr, 0.f);
        __syncthreads();
        float lv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) lv[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {  // c . b^T
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) lv[i][j] = fmaf(cv[i], bv[j], lv[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            const float w = (q < Q && k <= q) ? expf(acs[q] - acs[k]) : 0.f;
            ls[(ty * 4 + i) * TP + tx + 16 * j] = lv[i][j] * w;
          }
        }
        __syncthreads();
        for (int k = 0; k < TILE; ++k) {  // y += L x
          float lq[4], xv[YJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) lq[i] = ls[(ty * 4 + i) * TP + k];
#pragma unroll
          for (int j = 0; j < YJ; ++j) xv[j] = xs[k * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < YJ; ++j) acc[i][j] = fmaf(lq[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q < Q) {
          E* row = yb + (long long)(c0 + q) * y_row;
#pragma unroll
          for (int j = 0; j < YJ; ++j) store(row + tx + 16 * j, acc[i][j]);
        }
      }
      __syncthreads();  // cs is reloaded by the next query tile
    }

    // 3. state = exp(a_last) state + sum_k (exp(a_last - a_cs[k]) x_k) b_k^T
    float sacc[SI][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) sacc[i][j] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * TILE;
      __syncthreads();
      load_tile<E, N, NP>(bs, bb + (long long)c0 * sb.l, sb.l, k0, Q, nullptr, 0.f);
      load_tile<E, P, P>(xs, xb + (long long)c0 * sx.l, sx.l, k0, Q, acs, a_last);
      __syncthreads();
      for (int k = 0; k < TILE; ++k) {
        float xv[SI], bv[SJ];
#pragma unroll
        for (int i = 0; i < SI; ++i) xv[i] = xs[k * P + sp + 8 * i];
#pragma unroll
        for (int j = 0; j < SJ; ++j) bv[j] = bs[k * NP + sn + 32 * j];
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
          for (int j = 0; j < SJ; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    const float d_last = expf(a_last);
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        float* s = st + (sp + 8 * i) * NP + sn + 32 * j;
        *s = *s * d_last + sacc[i][j];
      }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + ((long long)b * H + h) * P * N;
    for (int i = tid; i < P * N; i += THREADS) so[i] = st[(i / N) * NP + i % N];
  }
}

template <typename E, int P, int N>
int launch(const void* x, const void* a, const void* b, const void* c, void* y,
           void* state_out, int B, int L, int H, int Q, int h_per_g, Strides sx,
           Strides sa, Strides sb, Strides sc, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<E, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<E, P, N><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(a), static_cast<const E*>(b),
      static_cast<const E*>(c), static_cast<E*>(y), static_cast<float*>(state_out), L, Q,
      h_per_g, sx, sa, sb, sc);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(int P, int N, const void* x, const void* a, const void* b, const void* c,
             void* y, void* state_out, int B, int L, int H, int Q, int h_per_g,
             Strides sx, Strides sa, Strides sb, Strides sc, int smem, cudaStream_t s) {
#define SSD_CASE(PP, NN)                                                             \
  if (P == PP && N == NN)                                                            \
    return launch<E, PP, NN>(x, a, b, c, y, state_out, B, L, H, Q, h_per_g, sx, sa, \
                             sb, sc, smem, s);
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B,L,H,P) and b, c (B,L,G,N) in float32 (dtype 0) or bfloat16 (dtype
// 1), strided with a unit last dim; a (B,L,H) float32, strided; y
// (B,L,H,P) contiguous in x's dtype; state_out (B,H,P,N) float32 or null.
// Q divides L. `smem` is the dynamic shared memory the wrapper computed.
// Returns a cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* b, const void* c,
                            void* y, void* state_out, int B, int L, int H, int G, int P,
                            int N, int Q, int dtype, long long sxb, long long sxl,
                            long long sxh, long long sab, long long sal, long long sah,
                            long long sbb, long long sbl, long long sbg, long long scb,
                            long long scl, long long scg, int smem, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || L < 1 || G < 1 || H % G || Q < 1 || L % Q) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sx{sxb, sxl, sxh}, sa{sab, sal, sah}, sb{sbb, sbl, sbg}, sc{scb, scl, scg};
  if (dtype == 0)
    return dispatch<float>(P, N, x, a, b, c, y, state_out, B, L, H, Q, H / G, sx, sa, sb,
                           sc, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, a, b, c, y, state_out, B, L, H, Q, H / G, sx,
                                   sa, sb, sc, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
