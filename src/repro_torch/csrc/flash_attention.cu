// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (body _flash_kernel). Bound through ctypes by
// src/repro_torch/kernels/flash_attention.py, whose docstring states what
// bounds it on the card and what this design does about it.
//
// One CTA per (64-row q tile, q head, batch row), 256 threads: four
// threads per q row, each owning a quarter of the row's score columns
// and a quarter of its output dims. Per kv block of 64 keys the CTA
// stages K and V in shared memory, computes s = (bf16 q . bf16 k) * scale
// in f32, applies the causal mask, and runs the online softmax with f32
// m / l / acc and the all-masked guards of the XLA path (_flash_row):
// m_safe = 0 where m is -inf, corr = 0 where the old m is -inf. p is
// rounded to bf16 before the PV product. The kv walk always starts at
// key 0 with the same block size, so a block fully masked for a row is
// an exact no-op for it and each row's bits depend only on that row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // q rows per CTA
constexpr int BK = 64;             // keys per kv block
constexpr int TPR = 4;             // threads per q row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int PLD = BK + 1;        // P tile row stride (floats): skews banks
constexpr unsigned FULL = 0xffffffffu;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }  // bf16: 16-byte rows, skewed banks

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * BK) * row_stride<D>() * sizeof(__nv_bfloat16) +
         (size_t)BQ * PLD * sizeof(float);
}

// rows [0, valid) of a (rows, D) bf16 tile from global memory into a
// padded shared tile; rows past `valid` are zero
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                          int valid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = reinterpret_cast<const uint4*>(src + (size_t)r * D)[c];
    *reinterpret_cast<uint4*>(dst + r * row_stride<D>() + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int* __restrict__ probe,
                 int H, int Hkv, int Sq, int Skv, int q_offset, int causal,
                 float scale) {
  constexpr int LD = row_stride<D>();
  constexpr int DPT = D / TPR;   // output dims per thread
  constexpr int CPT = BK / TPR;  // score columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;
  float* sP = reinterpret_cast<float*>(sV + BK * LD);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int row0 = tile * BQ;
  const int rows = min(BQ, Sq - row0);
  const int nk = (Skv + BK - 1) / BK;
  // causal skip decided by the tile's last row (CTA-uniform)
  const int nblk = causal ? min(nk, (q_offset + row0 + rows - 1) / BK + 1) : nk;
  const int qpos = q_offset + row0 + r;

  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  load_tile<D>(sQ, q + ((size_t)(b * H + h) * Sq + row0) * D, rows);

  float m = -INFINITY, l = 0.f, acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q is staged and the previous block's K/V are consumed
    load_tile<D>(sK, kb + (size_t)k0 * D, min(BK, Skv - k0));
    load_tile<D>(sV, vb + (size_t)k0 * D, min(BK, Skv - k0));
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = 0.f;
    const __nv_bfloat162* qrow =
        reinterpret_cast<const __nv_bfloat162*>(sQ + r * LD);
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 qd = __bfloat1622float2(qrow[d2]);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float2 kd = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(sK + (part + TPR * i) * LD)[d2]);
        s[i] = fmaf(qd.x, kd.x, s[i]);
        s[i] = fmaf(qd.y, kd.y, s[i]);
      }
    }
    float mblk = -INFINITY;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int kpos = k0 + part + TPR * i;
      const bool visible = kpos < Skv && (!causal || kpos <= qpos);
      s[i] = visible ? s[i] * scale : -INFINITY;
      mblk = fmaxf(mblk, s[i]);
    }
    // the four threads of a row are adjacent lanes of one warp
    mblk = fmaxf(mblk, __shfl_xor_sync(FULL, mblk, 1));
    mblk = fmaxf(mblk, __shfl_xor_sync(FULL, mblk, 2));
    const float m_new = fmaxf(m, mblk);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = expf(s[i] - m_safe);
      psum += p;
      sP[r * PLD + part + TPR * i] = __bfloat162float(__float2bfloat16(p));
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's P entries come from lanes of this warp

    float pv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) pv[i] = 0.f;
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * PLD + c];
      const __nv_bfloat162* vrow =
          reinterpret_cast<const __nv_bfloat162*>(sV + c * LD + part * DPT);
#pragma unroll
      for (int i = 0; i < DPT / 2; ++i) {
        const float2 vd = __bfloat1622float2(vrow[i]);
        pv[2 * i] = fmaf(p, vd.x, pv[2 * i]);
        pv[2 * i + 1] = fmaf(p, vd.y, pv[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = acc[i] * corr + pv[i];
  }

  if (r < rows) {
    const float l_safe = fmaxf(l, 1e-37f);
    __nv_bfloat16* o = out + ((size_t)(b * H + h) * Sq + row0 + r) * D + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = __float2bfloat16(acc[i] / l_safe);
  }
  if (probe != nullptr && threadIdx.x == 0) {
    int* pr = probe + ((size_t)(b * H + h) * gridDim.x + tile) * 2;
    pr[0] = nk;    // kv blocks visited
    pr[1] = nblk;  // kv blocks computed
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* probe,
           int B, int H, int Hkv, int Sq, int Skv, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<int*>(probe), H, Hkv, Sq, Skv, q_offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Skv,D), out (B,H,Sq,D): bf16, contiguous.
// probe (B,H,ceil(Sq/64),2) int32 or null. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* probe, int B, int H,
                                   int Hkv, int Sq, int Skv, int D,
                                   int q_offset, int causal, float scale,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, out, probe, B, H, Hkv, Sq, Skv, q_offset, causal, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, out, probe, B, H, Hkv, Sq, Skv, q_offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
