// Causal GQA flash-attention forward for Hopper (sm_90a): the kernel and
// its launch, templated on the head dim D and the tiles BQ (q rows a CTA)
// and BK (keys a kv block). Each of flash_attention.cu (the default tiles,
// BQ = BK = 64), flash_attention_q64.cu and flash_attention_q128.cu
// instantiates some (D, BQ, BK) and exports the plain C interface of
// FLASH_C_INTERFACE; the wrapper loads the library of the tiles it is
// asked for. One translation unit each, so the tiles build in parallel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (body _flash_kernel), whose block_q / block_k are the
// tiles here. Bound through ctypes by
// src/repro_torch/kernels/flash_attention.py, whose docstring states what
// bounds it on the card and what this design does about it.
//
// One CTA per (BQ-row q tile, q head, batch row), two groups of BQ / 16
// warps; in each group a warp owns 16 q rows, and group g walks the kv
// blocks g, g + 2, ... of BK keys, so the longest chain of blocks (the
// causal tail) is halved. Per kv block:
//   - S = Q K^T on the tensor cores (mma.sync m16n8k16, bf16 operands fed
//     by ldmatrix, f32 accumulators), then s = S * scale and the causal
//     mask;
//   - the online softmax with f32 m / l / acc (m and s in log2 units, so
//     p = exp2(s - m)) and the all-masked guards of the XLA path
//     (_flash_row): m_safe = 0 where m is -inf, corr = 0 where the old m
//     is -inf; the row statistics are reduced by shuffles among the four
//     lanes that share a row of the mma fragment;
//   - p is rounded to bf16 and the S accumulator fragment, so rounded, is
//     the A operand of O += P V on the tensor cores: P never leaves the
//     registers.
// Each group double-buffers its K and V blocks in padded shared tiles
// (16-byte rows skewed by 16 bytes, so ldmatrix has no bank conflicts) by
// cp.async: its next block is in flight while one computes. At the end
// the two groups' (m, l, acc) merge in a fixed order. The heaviest q
// tiles (the causal tail) are launched first.
//
// With `stats` given, the CTA also writes each row's softmax statistics
// after the merge, in the convention of the XLA path (_flash_row) that
// the backward reads: m, the row's maximum score in natural units (-inf
// where the row saw no key), and l, the sum of exp(s - m), at least
// 1e-37; as f32 planes m (B,H,Sq) then l (B,H,Sq). Without it nothing
// else changes: the launch computes and writes what it did before.
//
// The kv walk always starts at key 0 with the same block size, the same
// parity of blocks goes to the same group, a block fully masked for a row
// is an exact no-op for it (p = 0, corr = 1), a group that saw nothing of
// a row adds exact zeros in the merge, and the tensor core forms each
// output element from its own row alone: each row's bits depend only on
// that row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GROUPS = 2;                // warp groups, each on every other kv block
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// one warp per 16 q rows per group: 256 threads at BQ = 64, 512 at 128
template <int BQ>
__host__ __device__ constexpr int threads() { return GROUPS * BQ / 16 * 32; }

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }  // bf16

// Q; K x 2, V x 2 a group (the wrapper's flash_resources, the same formula)
template <int D, int BQ, int BK>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + GROUPS * 4 * BK) * row_stride<D>() * sizeof(__nv_bfloat16);
}

// two CTAs an SM (<= 128 registers a thread) only where the live state
// fits: D = 64 with 64-row q tiles and kv blocks of at most 64 keys. At
// 512 threads two CTAs would cap a thread at 64 registers, and the score
// and output fragments spill.
template <int D, int BQ, int BK>
struct MinBlocks {
  static constexpr int value = (D == 64 && BQ == 64 && BK <= 64) ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [0, valid) of a (ROWS, D) bf16 tile from global memory into a
// padded shared tile by 16-byte cp.async, spread over `NTHREADS` threads
// (thread `tid` of them); rows past `valid` are zero-filled. Where the
// tile's vectors are no whole number a thread (D = 80: 10 a row, 640 a
// 64-row tile over 256 threads), the last pass is guarded; elsewhere the
// guard is a constant and compiles away.
template <int D, int NTHREADS, int ROWS>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int valid,
                                        int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int VECS = ROWS * VPR;
  constexpr bool WHOLE = VECS % NTHREADS == 0;
  static_assert(D % 16 == 0, "whole k steps of 16 and 16-byte rows");
#pragma unroll
  for (int it = 0; it < (VECS + NTHREADS - 1) / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    if (!WHOLE && i >= VECS) break;
    const int r = i / VPR, c = i % VPR;
    const bool in = r < valid;
    const __nv_bfloat16* g = src + (size_t)(in ? r : 0) * D + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * row_stride<D>() + c * 8)),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier of one warp group (ids 1 and 2; __syncthreads is 0), with
// immediate ids so that the kernel reserves three barriers, not sixteen
template <int GROUP_THREADS>
__device__ __forceinline__ void group_sync(int group) {
  if (group == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(GROUP_THREADS) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(GROUP_THREADS) : "memory");
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp2(m_old - m_new) for the online softmax, exactly 1 where the max did
// not move and 0 where nothing was seen: a fully masked block, or a group
// that saw nothing, must leave the row's bits as they are
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f
         : m_old == m_new   ? 1.f
                            : exp2_approx(m_old - m_new);
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(threads<BQ>(), MinBlocks<D, BQ, BK>::value)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int* __restrict__ probe,
                 float* __restrict__ stats, int H, int Hkv, int Sq, int Skv,
                 int q_offset, int causal, float scale) {
  constexpr int THREADS = threads<BQ>();
  constexpr int GROUP_THREADS = THREADS / GROUPS;
  constexpr int LD = row_stride<D>();
  constexpr int KD = D / 16;  // k steps of the QK^T product
  constexpr int ND = D / 8;   // n tiles of the PV product (taken in pairs)
  static_assert(ND % 2 == 0, "PV n tiles in pairs: D a multiple of 16");
  constexpr int NS = BK / 8;  // n tiles of the QK^T product
  constexpr int TILE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);

  // heaviest tiles first: blocks start in blockIdx order, x fastest
  const int ntiles = gridDim.z, tile = ntiles - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / (BQ / 16), wq = warp % (BQ / 16);  // kv parity, q slice
  const int gtid = threadIdx.x % GROUP_THREADS;
  const int gr = lane / 4, tg = lane % 4;  // fragment row group, thread in group
  const int row0 = tile * BQ;
  const int rows = min(BQ, Sq - row0);
  const int nk = (Skv + BK - 1) / BK;
  // causal skip decided by the tile's last row (CTA-uniform)
  const int nblk = causal ? min(nk, (q_offset + row0 + rows - 1) / BK + 1) : nk;
  // this group's blocks: j = group, group + 2, ...
  const int my_n = (nblk - group + GROUPS - 1) / GROUPS;
  // absolute positions of the warp's first row and this lane's two
  // fragment rows; scores are kept in log2 units
  const int warp_pos = q_offset + row0 + wq * 16;
  const int qpos0 = warp_pos + gr, qpos1 = qpos0 + 8;
  const float scale_log2 = scale * 1.4426950408889634f;

  __nv_bfloat16* sK = sQ + BQ * LD + group * 4 * TILE;  // this group's two K
  __nv_bfloat16* sV = sK + 2 * TILE;                    // and two V buffers
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  cp_tile<D, THREADS, BQ>(sQ, q + ((size_t)(b * H + h) * Sq + row0) * D, rows,
                          threadIdx.x);
  if (my_n > 0) {
    const int k0 = group * BK;
    cp_tile<D, GROUP_THREADS, BK>(sK, kb + (size_t)k0 * D, min(BK, Skv - k0),
                                  gtid);
    cp_tile<D, GROUP_THREADS, BK>(sV, vb + (size_t)k0 * D, min(BK, Skv - k0),
                                  gtid);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();  // Q and each group's first block arrived

  // ldmatrix x4 lane roles: matrix mi = lane / 8, its row lane % 8
  const int mi = lane / 8, mr = lane % 8;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < my_n; ++i) {
    const int k0 = (group + GROUPS * i) * BK;
    const __nv_bfloat16* cK = sK + (i & 1) * TILE;
    const __nv_bfloat16* cV = sV + (i & 1) * TILE;
    if (i + 1 < my_n) {  // the group's next block lands while this one computes
      const int k1 = k0 + GROUPS * BK;
      cp_tile<D, GROUP_THREADS, BK>(sK + ((i + 1) & 1) * TILE,
                                    kb + (size_t)k1 * D, min(BK, Skv - k1),
                                    gtid);
      cp_tile<D, GROUP_THREADS, BK>(sV + ((i + 1) & 1) * TILE,
                                    vb + (size_t)k1 * D, min(BK, Skv - k1),
                                    gtid);
    }
    cp_commit();
    if (i > 0) {
      cp_wait<1>();  // all but the newest group of copies: this block arrived
      group_sync<GROUP_THREADS>(group);
    }

    // S = Q K^T: n tiles of 8 keys; ldmatrix x4 gives b0/b1 of two tiles
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(sQ + (wq * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(cK + (np * 16 + (mi >> 1) * 8 + mr) * LD +
                                 kk * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * np], qa, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
      }
    }

    // scale (in log2 units: exp(x) = exp2(x log2 e)), mask, row maxima
    // (e / 2 picks the fragment row: gr or gr + 8); only blocks that
    // reach past Skv or past the warp's first row need the mask, which is
    // written without short-circuit operators so that it compiles to
    // selects, not branches
    const bool masked = (k0 + BK > Skv) | (causal && k0 + BK - 1 > warp_pos);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    if (masked) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * tg + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool visible = (kpos < Skv) & ((causal == 0) | (kpos <= qpos));
          s[n][e] = visible ? s[n][e] : -INFINITY;
        }
      }
    }
    float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mb[0] = fmaxf(mb[0], fmaxf(s[n][0], s[n][1]));
      mb[1] = fmaxf(mb[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(FULL, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(FULL, mb[r], 2));
      const float m_new = fmaxf(m[r], mb[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = rescale(m[r], m_new);
      m[r] = m_new;
    }
    // p = exp2(s - m_safe); l sums p in f32, PV takes bf16(p) from registers
    float psum[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_approx(s[n][e] - m_safe[e >> 1]);
        psum[e >> 1] += p[e];
      }
      // the accumulator of n tile n is half of the A operand of k step n / 2
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);      // row gr
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row gr + 8
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(FULL, psum[r], 1);
      psum[r] += __shfl_xor_sync(FULL, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: k steps of 16 keys; ldmatrix x4.trans gives b0/b1 of two
    // n tiles of 8 dims
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(cV + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                                       dp * 16 + (mi >> 1) * 8));
        mma_bf16(o[2 * dp], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], r[2], r[3]);
      }
    }
    group_sync<GROUP_THREADS>(group);  // this block's buffers are free for the group's next but one
  }

  // merge: group 1 hands its state to group 0 through shared memory (the
  // K/V buffers, now free), in its fragment layout; group 0 combines the
  // two in a fixed order, so a row's bits still depend on that row alone
  constexpr int MERGE = ND * 4 + 4;  // floats a lane: o, m, l
  float* sM = reinterpret_cast<float*>(sQ + BQ * LD);
  const int slot = wq * 32 + lane;   // [value][warp, lane]: no bank conflicts
  __syncthreads();
  if (group == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sM[(n * 4 + e) * GROUP_THREADS + slot] = o[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sM[(ND * 4 + r) * GROUP_THREADS + slot] = m[r];
      sM[(ND * 4 + 2 + r) * GROUP_THREADS + slot] = l[r];
    }
  }
  __syncthreads();
  if (group == 1) return;
  float c0[2], c1[2], l_safe[2], m_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = sM[(ND * 4 + r) * GROUP_THREADS + slot];
    const float l1 = sM[(ND * 4 + 2 + r) * GROUP_THREADS + slot];
    const float mm = fmaxf(m[r], m1);
    c0[r] = rescale(m[r], mm);
    c1[r] = rescale(m1, mm);
    l_safe[r] = fmaxf(l[r] * c0[r] + l1 * c1[r], 1e-37f);
    m_row[r] = mm;
  }
  static_assert(MERGE * GROUP_THREADS * sizeof(float) <=
                    GROUPS * 4 * TILE * sizeof(__nv_bfloat16),
                "the merge buffer fits in the K/V buffers (BQ <= 4 BK)");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq * 16 + gr + 8 * r;
    if (row < rows) {
      __nv_bfloat16* orow = out + ((size_t)(b * H + h) * Sq + row0 + row) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float x0 = o[n][2 * r] * c0[r] +
                         sM[(n * 4 + 2 * r) * GROUP_THREADS + slot] * c1[r];
        const float x1 = o[n][2 * r + 1] * c0[r] +
                         sM[(n * 4 + 2 * r + 1) * GROUP_THREADS + slot] * c1[r];
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tg) =
            __floats2bfloat162_rn(x0 / l_safe[r], x1 / l_safe[r]);
      }
    }
  }
  if (stats != nullptr && tg == 0) {  // one lane of the four a row has
    const size_t plane = (size_t)gridDim.y * H * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq * 16 + gr + 8 * r;
      if (row < rows) {
        const size_t i = (size_t)(b * H + h) * Sq + row0 + row;
        stats[i] = m_row[r] * 0.6931471805599453f;  // log2 units -> natural
        stats[plane + i] = l_safe[r];
      }
    }
  }
  if (probe != nullptr && threadIdx.x == 0) {
    int* pr = probe + ((size_t)(b * H + h) * ntiles + tile) * 2;
    pr[0] = nk;    // kv blocks visited
    pr[1] = nblk;  // kv blocks computed
  }
}

// the shared-memory opt-in, set once per (instantiation, device)
template <int D, int BQ, int BK>
cudaError_t configure(int device) {
  static bool configured[MAX_DEVICES] = {};
  if (device < MAX_DEVICES && configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<D, BQ, BK>());
  if (err == cudaSuccess && device < MAX_DEVICES) configured[device] = true;
  return err;
}

template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, void* probe,
           void* stats, int B, int H, int Hkv, int Sq, int Skv, int q_offset,
           int causal, float scale, int device, cudaStream_t stream) {
  const cudaError_t err = configure<D, BQ, BK>(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D, BQ, BK><<<grid, threads<BQ>(), smem_bytes<D, BQ, BK>(),
                                stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<int*>(probe), static_cast<float*>(stats), H, Hkv, Sq, Skv,
      q_offset, causal, scale);
  return (int)cudaGetLastError();
}

// the kernel's attributes from cudaFuncGetAttributes, after the opt-in:
// out = {static shared bytes, dynamic shared bytes (the opt-in), registers
// a thread, local bytes a thread (spills), threads a block at most, CTAs
// an SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's
// threads and dynamic shared bytes}
template <int D, int BQ, int BK>
int attrs(int device, int* out) {
  cudaError_t err = configure<D, BQ, BK>(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, flash_fwd_kernel<D, BQ, BK>);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, flash_fwd_kernel<D, BQ, BK>, threads<BQ>(),
      smem_bytes<D, BQ, BK>());
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  out[5] = ctas;
  return 0;
}

inline int select_device(int device) {
  int current = -1;
  if (device < 0) return (int)cudaErrorInvalidDevice;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    return (int)cudaSetDevice(device);
  return 0;
}

}  // namespace

#define FLASH_LAUNCH(D_, BQ_, BK_)                                         \
  if (D == D_ && block_q == BQ_ && block_k == BK_)                         \
    return launch<D_, BQ_, BK_>(q, k, v, out, probe, stats, B, H, Hkv, Sq, \
                                Skv, q_offset, causal, scale, device,      \
                                static_cast<cudaStream_t>(stream));
#define FLASH_ATTRS(D_, BQ_, BK_)                  \
  if (D == D_ && block_q == BQ_ && block_k == BK_) \
    return attrs<D_, BQ_, BK_>(device, out);

// The C interface of a translation unit that instantiates the (D, BQ, BK)
// listed by CASES(X), a macro that applies X to each:
//   flash_attention_fwd: q (B,H,Sq,D), k/v (B,Hkv,Skv,D), out (B,H,Sq,D):
//     bf16, contiguous; probe (B,H,ceil(Sq/block_q),2) int32 or null;
//     stats (2,B,H,Sq) f32 (m, l) or null;
//   flash_attention_attrs: the instantiation's attributes (see attrs);
// each returns a cudaError_t (cudaErrorInvalidValue for tiles the unit
// does not instantiate).
#define FLASH_C_INTERFACE(CASES)                                             \
  extern "C" int flash_attention_fwd(                                        \
      const void* q, const void* k, const void* v, void* out, void* probe,   \
      void* stats, int B, int H, int Hkv, int Sq, int Skv, int D,            \
      int block_q, int block_k, int q_offset, int causal, float scale,       \
      int device, void* stream) {                                            \
    const int err = select_device(device);                                   \
    if (err) return err;                                                     \
    CASES(FLASH_LAUNCH)                                                      \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  extern "C" int flash_attention_attrs(int D, int block_q, int block_k,      \
                                       int device, int* out) {               \
    const int err = select_device(device);                                   \
    if (err) return err;                                                     \
    CASES(FLASH_ATTRS)                                                       \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  extern "C" const char* error_string(int code) {                            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));               \
  }
