// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py :: ssd_scan (body
// _ssd_kernel). Bound through ctypes by src/repro_torch/kernels/ssd_scan.py,
// whose docstring states what bounds it on the card, the design, and its
// rounding and determinism contracts.
//
// Two launches on one stream, over chunks of Q steps (chunk / pipeline):
//
//   1. ssd_state_kernel, one CTA per (half of the P state rows, pair of
//      heads of one group, batch row): streams the sequence in tiles of T
//      steps; at each chunk's start one warp a head takes a_cs = cumsum(a)
//      over the chunk (the only place it is taken; written to `acs` for
//      the scan); per tile the decayed x, exp(a_cs[-1] - a_cs[k]) x_k, is
//      split into XPARTS bf16 parts and S += parts^T b on the tensor cores
//      (the b tile shared by the two heads); at each chunk's end the f32
//      carry in chunk order, state = exp(a_cs[-1]) state + S, with prev[c]
//      (the state before chunk c + 1) written in x's dtype, and the final
//      state when asked.
//   2. ssd_chunk_scan_kernel, one CTA per (64-row q tile, chunk, batch row
//      x group x block of HB heads of the group), heaviest q tiles first:
//      y = exp(a_cs[q]) c_q . prev^T + sum_{k<=q} bf16((c_q . b_k)
//      exp(a_cs[q] - a_cs[k])) x_k. The c . b^T tile is computed once per
//      key tile for all heads of the block. The decay is taken per element
//      only on each warp's diagonal block of 16 keys, for k <= q; below it
//      as a row factor exp(a_cs[q] - a_cs[kend]) times a key factor
//      exp(a_cs[kend] - a_cs[k]), both <= 1 for a <= 0 (kend the 16-key
//      block's last step); above it the products are skipped. y leaves
//      through shared memory in 16-byte rows.
//
// bf16 products run on the tensor cores (mma.sync m16n8k16, bf16 operands
// fed by ldmatrix, f32 accumulators) over tiles staged by 16-byte cp.async
// (rows past the chunk zero-filled, so any Q works). The f32 instantiation
// runs the same kernels with every product as f32 FMAs on the CUDA cores.
// Loop orders are fixed and there are no atomics: row b's bits do not
// depend on the batch.
//
// The model layout is read through strides (last dim unit-stride, rows
// 16-byte aligned): x (B,L,H,P), a (B,L,H), b/c (B,L,G,N); y (B,L,H,P) is
// written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;   // rows of a staged tile: steps, q rows, state rows
constexpr int P = 64;   // head dim
constexpr int HB = 4;   // heads per chunk-scan CTA
constexpr int XPARTS = 3;  // bf16 parts of the decayed x in the chunk states
constexpr int KB = 16;  // keys a decay block: the k depth of one mma
constexpr int NKB = T / KB;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, l, h;  // elements; h is the head (x, a) or group (b, c) stride
};

template <typename E>
constexpr bool kF32 = std::is_same<E, float>::value;

// padded smem row of W elements: a 16-byte skew, so ldmatrix has no bank
// conflicts and every row stays 16-byte aligned for cp.async
template <typename E, int W>
__host__ __device__ constexpr int ld() { return W + 16 / (int)sizeof(E); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [0, valid) of a (T x W) strided matrix into a padded smem tile by
// 16-byte cp.async over the CTA; rows past `valid` are zero-filled
template <typename E, int W>
__device__ __forceinline__ void cp_rows(E* dst, const E* src, long long stride,
                                        int valid) {
  constexpr int EPV = 16 / (int)sizeof(E);  // elements per vector
  constexpr int VPR = W / EPV;              // vectors per row
  for (int i = threadIdx.x; i < T * VPR; i += THREADS) {
    const int r = i / VPR, v = i % VPR;
    const bool in = r < valid;
    const E* g = src + (in ? (long long)r * stride : 0) + v * EPV;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * ld<E, W>() + v * EPV)),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int NG>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NG) : "memory");
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// w * (a pair of bf16 values) in f32, split into NP bf16 parts, each the
// rounding of what the parts before it left; three parts hold the f32
// product exactly (8 + 8 + 8 significant bits)
template <int NP>
__device__ __forceinline__ void split_scaled(uint32_t v, float w0, float w1,
                                             uint32_t (&part)[NP]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  float v0 = f.x * w0, v1 = f.y * w1;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    part[i] = as_u32(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// inclusive cumsum of a over Q steps (stride `stride`) into acs, by one
// warp: each lane a contiguous run, then a fixed shuffle scan of the run
// totals. The only routine that takes a_cs: every pass reads its output.
__device__ __forceinline__ void chunk_cumsum(float* acs, const float* a,
                                             long long stride, int Q, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += a[(long long)i * stride];
    acs[i] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int i = lo; i < hi; ++i) acs[i] += excl;
}

// ------------------------------------------------- chunk states and carry

constexpr int PH = P / 2;   // state rows of a state-kernel CTA
constexpr int SH = 2;       // heads of a state-kernel CTA (one group), sharing b
constexpr int SSTAGES = 2;  // tiles in flight or in use in the state kernel
constexpr int ABUF = 2;     // chunks of a in use or in flight (a(c) lands during chunk c - 1)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <typename E, int N>
__host__ __device__ constexpr size_t state_smem(int Q) {
  return (size_t)SSTAGES * T * (ld<E, N>() + SH * ld<E, PH>()) * sizeof(E) +
         (kF32<E> ? 0 : (size_t)SH * XPARTS * T * ld<__nv_bfloat16, PH>() * 2) +
         (size_t)SH * (ABUF + 2) * ((Q + T - 1) / T) * T * sizeof(float);
}

// The chunk states of rows [PH ph, PH ph + PH) of the (P x N) states of up
// to SH heads of one group, and their f32 carry in chunk order: prev[c] =
// state (x's dtype) before chunk c + 1, state = exp(a_cs[-1]) state + S_c
// with S_c = sum_k exp(a_cs[-1] - a_cs[k]) x_k b_k^T; the final state when
// asked. The CTA streams the sequence in tiles of T steps (one b tile for
// its heads), the next tile in flight while one computes. Warp (hw, mw,
// nw) owns head hw, state rows 16 mw.. of the half, columns N/2 nw.. .
template <typename E, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_state_kernel(const E* __restrict__ x, const float* __restrict__ a,
                 const E* __restrict__ bm, float* __restrict__ acs_out,
                 E* __restrict__ prev, float* __restrict__ state_out, int L, int Q,
                 int H, int h_per_g, Strides sx, Strides sa, Strides sb) {
  constexpr int LDX = ld<E, PH>(), LDB = ld<E, N>(), LDQ = ld<__nv_bfloat16, PH>();
  constexpr int NW = N / 2, NT = NW / 8;  // columns, n tiles of a warp
  constexpr int STAGE = T * (LDB + SH * LDX);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ph = blockIdx.x, b = blockIdx.z;
  const int n_hp = (h_per_g + SH - 1) / SH;
  const int g = blockIdx.y / n_hp, h0 = g * h_per_g + (blockIdx.y % n_hp) * SH;
  const int nh = min(SH, g * h_per_g + h_per_g - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hw = warp / 4, mw = (warp / 2) % 2, nw = warp % 2;
  static_assert(THREADS == SH * 4 * 32, "a warp per head, 16 state rows and N / 2 columns");
  const int gr = lane / 4, tg = lane % 4, mi = lane / 8, mr = lane % 8;
  const int ntc = (Q + T - 1) / T, QP = ntc * T, nc = L / Q, ntot = nc * ntc;
  E* stage = reinterpret_cast<E*>(smem);  // SSTAGES x (b tile, SH x tiles of the half)
  __nv_bfloat16* s_xp =                   // SH x XPARTS x T x LDQ: decayed x, split
      reinterpret_cast<__nv_bfloat16*>(stage + SSTAGES * STAGE);
  float* s_a = reinterpret_cast<float*>(s_xp + (kF32<E> ? 0 : SH * XPARTS * T * LDQ));
  float* s_acs = s_a + SH * ABUF * QP;  // SH x QP: a_cs (s_a: a, chunk c in c % ABUF)
  float* s_w = s_acs + SH * QP;         // SH x QP: exp(a_cs[-1] - a_cs)

  const E* bb = bm + b * sb.b + g * sb.h;
  // tile t, and with a chunk's first tile the chunk's a (a 4-byte
  // cp.async an element), as one group of copies
  auto issue = [&](int t) {
    if (t < ntot) {
      const int c = t / ntc, j = t % ntc;
      const long long row0 = (long long)c * Q + j * T;
      E* bs = stage + (t % SSTAGES) * STAGE;
      cp_rows<E, N>(bs, bb + row0 * sb.l, sb.l, min(T, Q - j * T));
      for (int hh = 0; hh < nh; ++hh)
        cp_rows<E, PH>(bs + T * LDB + hh * T * LDX,
                       x + b * sx.b + (h0 + hh) * sx.h + ph * PH + row0 * sx.l, sx.l,
                       min(T, Q - j * T));
      if (j == 0)
        for (int hh = 0; hh < nh; ++hh)
          for (int k = tid; k < Q; k += THREADS)
            cp_async4(s_a + (hh * ABUF + c % ABUF) * QP + k,
                      a + b * sa.b + (h0 + hh) * sa.h + ((long long)c * Q + k) * sa.l);
    }
    cp_commit();
  };

  float acc[NT][4], st[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = st[n][e] = 0.f;
  const bool active = hw < nh;  // the warp has a head (warp-uniform)
  const int m0 = mw * 16 + gr;  // this lane's fragment rows m0, m0 + 8 of the half
  for (int t = 0; t < SSTAGES - 1; ++t) issue(t);
  for (int t = 0; t < ntot; ++t) {
    const int c = t / ntc, j = t % ntc;
    issue(t + SSTAGES - 1);  // lands while the tiles before it compute
    cp_wait<SSTAGES - 1>();
    __syncthreads();  // tile t (and, with the chunk's first tile, its a) arrived
    if (j == 0) {     // the chunk's a_cs (once, here) and decay weights
      if (warp < nh)
        chunk_cumsum(s_acs + warp * QP, s_a + (warp * ABUF + c % ABUF) * QP, 1, Q, lane);
      __syncthreads();
      for (int hh = 0; hh < nh; ++hh) {
        const float* A = s_acs + hh * QP;
        for (int k = tid; k < QP; k += THREADS) {
          s_w[hh * QP + k] = k < Q ? expf(A[Q - 1] - A[k]) : 0.f;
          if (ph == 0 && k < Q)
            acs_out[((long long)b * H + h0 + hh) * L + (long long)c * Q + k] = A[k];
        }
      }
      __syncthreads();
    }
    const E* bs = stage + (t % SSTAGES) * STAGE;
    const E* xs = bs + T * LDB + hw * T * LDX;
    const float* w = s_w + hw * QP + j * T;
    if constexpr (kF32<E>) {
      if (active)
        for (int k = 0; k < T; ++k) {
          const float v0 = w[k] * xs[k * LDX + m0], v1 = w[k] * xs[k * LDX + m0 + 8];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int col = nw * NW + n * 8 + 2 * tg;
            const float b0 = bs[k * LDB + col], b1 = bs[k * LDB + col + 1];
            acc[n][0] = fmaf(v0, b0, acc[n][0]);
            acc[n][1] = fmaf(v0, b1, acc[n][1]);
            acc[n][2] = fmaf(v1, b0, acc[n][2]);
            acc[n][3] = fmaf(v1, b1, acc[n][3]);
          }
        }
    } else {
      // the decayed x of the tile, split into XPARTS bf16 tiles (each
      // element once), then A = parts^T: ldmatrix.trans gives the fragment
      // (p = 16 mw + gr (+8), k = 16 kk + 2 tg (+1) (+8))
      for (int i = tid; i < nh * T * PH / 2; i += THREADS) {
        const int hh = i / (T * PH / 2), k = (i / (PH / 2)) % T, p = (i % (PH / 2)) * 2;
        const float wk = s_w[hh * QP + j * T + k];
        uint32_t part[XPARTS];
        split_scaled<XPARTS>(
            *reinterpret_cast<const uint32_t*>(bs + T * LDB + (hh * T + k) * LDX + p), wk,
            wk, part);
#pragma unroll
        for (int q = 0; q < XPARTS; ++q)
          *reinterpret_cast<uint32_t*>(s_xp + ((hh * XPARTS + q) * T + k) * LDQ + p) = part[q];
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) {
          uint32_t xa[XPARTS][4];
#pragma unroll
          for (int q = 0; q < XPARTS; ++q)
            ldmatrix_x4_trans(xa[q], smem_addr(s_xp + ((hw * XPARTS + q) * T + kk * 16 +
                                                       (mi >> 1) * 8 + mr) * LDQ +
                                               mw * 16 + (mi & 1) * 8));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, smem_addr(bs + (kk * 16 + (mi & 1) * 8 + mr) * LDB +
                                           nw * NW + np * 16 + (mi >> 1) * 8));
#pragma unroll
            for (int q = 0; q < XPARTS; ++q) {
              mma_bf16(acc[2 * np], xa[q], r[0], r[1]);
              mma_bf16(acc[2 * np + 1], xa[q], r[2], r[3]);
            }
          }
        }
      }
    }
    if (j == ntc - 1 && active) {  // the chunk's end: the f32 carry, in chunk order
      const float d = expf(s_acs[hw * QP + Q - 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] = fmaf(st[n][e], d, acc[n][e]);
          acc[n][e] = 0.f;
        }
      if (c + 1 < nc) {
        E* pv = prev + (((long long)b * H + h0 + hw) * (nc - 1) + c) * P * N + (ph * PH) * N;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = nw * NW + n * 8 + 2 * tg;
          store2(pv + m0 * N + col, st[n][0], st[n][1]);
          store2(pv + (m0 + 8) * N + col, st[n][2], st[n][3]);
        }
      }
    }
    __syncthreads();  // the stage, the split tiles and s_w are reused
  }
  if (state_out != nullptr && active) {
    float* so = state_out + ((long long)b * H + h0 + hw) * P * N + (ph * PH) * N;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = nw * NW + n * 8 + 2 * tg;
      store2(so + m0 * N + col, st[n][0], st[n][1]);
      store2(so + (m0 + 8) * N + col, st[n][2], st[n][3]);
    }
  }
}

// ---------------------------------------------------------------- chunk scan

constexpr int WH = 2;  // heads a chunk-scan warp

// the tiles of one key tile: b and the x of each head of the block
template <typename E, int N>
__host__ __device__ constexpr int stage_elems() { return T * (ld<E, N>() + HB * ld<E, P>()); }

// prev of every head of the block; read before the first key tile, so it
// shares its region with the key tile's (two CTAs an SM at the serving
// shape: 113,664 bytes of shared memory each)
template <typename E, int N>
__host__ __device__ constexpr int union_elems() {
  return HB * P * ld<E, N>() > stage_elems<E, N>() ? HB * P * ld<E, N>()
                                                   : stage_elems<E, N>();
}

template <typename E, int N>
__host__ __device__ constexpr size_t scan_smem(int Q) {
  return (size_t)(T * ld<E, N>() + union_elems<E, N>()) * sizeof(E) +
         ((size_t)T * (T + 4) + (size_t)HB * ((Q + T - 1) / T) * T +
          (size_t)HB * T * (NKB + 1)) *
             sizeof(float);
}

// exp(a_cs[q0 + r] - a_cs[k0 + k]) for key k of the warp's diagonal block
// of KB keys, where k <= q; 0 above the diagonal and past the chunk. The
// exponent is clamped to <= 0 (a no-op for k <= q, as a <= 0), so the one
// that the select discards cannot overflow; one MUFU.EX2 (__expf).
__device__ __forceinline__ float decay_diag(const float* A, int q0, int k0, int Q, int r,
                                            int k) {
  const int q = q0 + r, kk = k0 + k;
  const float e = __expf(fminf(A[q] - A[kk], 0.f));
  return (kk <= q) & (q < Q) ? e : 0.f;
}

// y for q rows [q0, q0 + T) of one chunk and up to HB heads of one group.
// Warp (rs, wg) owns q rows 16 rs.. of heads WH wg.. of the block, all P
// head dims; of the c . b^T tile it computes q rows 16 rs.. and KW keys
// from KW wg.
template <typename E, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_kernel(const E* __restrict__ x, const E* __restrict__ bm,
                      const E* __restrict__ cm, const float* __restrict__ acs,
                      const E* __restrict__ prev, E* __restrict__ y,
                      int* __restrict__ counts, int L, int Q, int H, int G,
                      int h_per_g, int pipeline, Strides sx, Strides sb,
                      Strides sc) {
  constexpr int LDN = ld<E, N>(), LDX = ld<E, P>(), LDC = T + 4;
  constexpr int NJ = P / 8;          // n tiles of a warp's y columns
  constexpr int KW = T / (HB / WH);  // keys of a warp's c . b^T slice
  static_assert(THREADS == 4 * (HB / WH) * 32, "a warp per 16 q rows and WH heads");
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qt = gridDim.x, qt = n_qt - 1 - blockIdx.x;  // heaviest first
  const int ci = blockIdx.y, nc = gridDim.y;
  const int n_hb = (h_per_g + HB - 1) / HB;
  const int hb = blockIdx.z % n_hb, g = (blockIdx.z / n_hb) % G;
  const int b = blockIdx.z / (n_hb * G);
  const int h0 = g * h_per_g + hb * HB, nh = min(HB, h_per_g - hb * HB);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rs = warp % 4, wg = warp / 4;
  const int gr = lane / 4, tg = lane % 4, mi = lane / 8, mr = lane % 8;
  const int q0 = qt * T, QS = n_qt * T;
  const int r0 = rs * 16 + gr, r1 = r0 + 8;  // this lane's fragment rows
  const long long c0 = (long long)ci * Q;
  // the probe's counter block: this sub-chunk scanned, for each head of
  // the block, counted in its chunk of pipeline sub-chunks (one CTA of
  // the sub-chunk adds: the one of q tile 0)
  if (counts != nullptr && qt == 0 && tid < nh)
    atomicAdd(counts + ((long long)b * H + h0 + tid) * (nc / pipeline) + ci / pipeline, 1);

  E* s_c = reinterpret_cast<E*>(smem);  // T x LDN  c rows of the q tile
  E* s_stage = s_c + T * LDN;           // b tile, HB x tiles
  E* s_prev = s_stage;                  // HB x P x LDN  prev, a head each
  float* s_cb = reinterpret_cast<float*>(s_stage + union_elems<E, N>());  // T x LDC
  float* s_acs = s_cb + T * LDC;          // HB x QS  a_cs, a head each
  float* s_eq = s_acs + HB * QS;          // HB x T x NKB  row factors
  float* s_ek = s_eq + HB * T * NKB;      // HB x T  key factors

  auto issue_tiles = [&](int kt) {
    const int k0 = kt * T, krows = min(T, Q - k0);
    cp_rows<E, N>(s_stage, bm + b * sb.b + g * sb.h + (c0 + k0) * sb.l, sb.l, krows);
    for (int hh = 0; hh < nh; ++hh)
      cp_rows<E, P>(s_stage + T * LDN + hh * T * LDX,
                    x + b * sx.b + (h0 + hh) * sx.h + (c0 + k0) * sx.l, sx.l, krows);
    cp_commit();
  };
  cp_rows<E, N>(s_c, cm + b * sc.b + g * sc.h + (c0 + q0) * sc.l, sc.l, min(T, Q - q0));
  if (ci > 0)
    for (int hh = 0; hh < nh; ++hh)
      cp_rows<E, N>(s_prev + hh * P * LDN,
                    prev + (((long long)b * H + h0 + hh) * (nc - 1) + ci - 1) * P * N, N,
                    P);
  const int na = min(Q, q0 + T);  // a_cs up to the tile's last row
  for (int hh = 0; hh < nh; ++hh)
    for (int j = tid; j < na; j += THREADS)
      cp_async4(s_acs + hh * QS + j, acs + ((long long)b * H + h0 + hh) * L + c0 + j);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  float acc[WH][NJ][4];
#pragma unroll
  for (int w = 0; w < WH; ++w)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[w][j][0] = acc[w][j][1] = acc[w][j][2] = acc[w][j][3] = 0.f;

  // y = exp(a_cs[q]) c_q . prev^T (prev is 0 for the first chunk)
  if (ci > 0) {
    if constexpr (kF32<E>) {
#pragma unroll
      for (int w = 0; w < WH; ++w) {
        const int hh = wg * WH + w;
        if (hh >= nh) break;
        const E* pv = s_prev + hh * P * LDN;
        for (int n = 0; n < N; ++n) {
          const float cv0 = s_c[r0 * LDN + n], cv1 = s_c[r1 * LDN + n];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int p = j * 8 + 2 * tg;
            const float p0 = pv[p * LDN + n], p1 = pv[(p + 1) * LDN + n];
            acc[w][j][0] = fmaf(cv0, p0, acc[w][j][0]);
            acc[w][j][1] = fmaf(cv0, p1, acc[w][j][1]);
            acc[w][j][2] = fmaf(cv1, p0, acc[w][j][2]);
            acc[w][j][3] = fmaf(cv1, p1, acc[w][j][3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4];
        ldmatrix_x4(ca, smem_addr(s_c + (rs * 16 + (lane & 15)) * LDN + kk * 16 +
                                  (lane >> 4) * 8));
#pragma unroll
        for (int w = 0; w < WH; ++w) {
          const int hh = wg * WH + w;
          if (hh >= nh) break;
          const E* pv = s_prev + hh * P * LDN;
#pragma unroll
          for (int np = 0; np < NJ / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, smem_addr(pv + (np * 16 + (mi >> 1) * 8 + mr) * LDN + kk * 16 +
                                     (mi & 1) * 8));
            mma_bf16(acc[w][2 * np], ca, r[0], r[1]);
            mma_bf16(acc[w][2 * np + 1], ca, r[2], r[3]);
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < WH; ++w) {
      const int hh = wg * WH + w;
      if (hh >= nh) break;
      const float* A = s_acs + hh * QS;
      const float e0 = q0 + r0 < Q ? expf(A[q0 + r0]) : 0.f;
      const float e1 = q0 + r1 < Q ? expf(A[q0 + r1]) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[w][j][0] *= e0;
        acc[w][j][1] *= e0;
        acc[w][j][2] *= e1;
        acc[w][j][3] *= e1;
      }
    }
  }
  __syncthreads();  // the prev tiles are free for the key tiles
  issue_tiles(0);

  // y += sum over key tiles kt <= qt of ((c . b^T) o decay) x; the other
  // CTA on the SM computes while this one waits for its tiles
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T;
    const bool diag = kt == qt;
    cp_wait<0>();
    // the decay factors of the key blocks (kend = the block's last step in
    // the chunk): ek per key, eq per q row and key block
    for (int i = tid; i < nh * T * (NKB + 1); i += THREADS) {
      const int hh = i / (T * (NKB + 1)), j = i % (T * (NKB + 1));
      const float* Ah = s_acs + hh * QS;
      if (j < T) {
        const int kend = min(k0 + (j / KB) * KB + KB - 1, Q - 1);
        s_ek[hh * T + j] = k0 + j < Q ? expf(fminf(Ah[kend] - Ah[k0 + j], 0.f)) : 0.f;
      } else {
        const int r = (j - T) / NKB, kb = (j - T) % NKB;
        const int kend = min(k0 + kb * KB + KB - 1, Q - 1);
        s_eq[(hh * T + r) * NKB + kb] =
            q0 + r < Q ? expf(fminf(Ah[q0 + r] - Ah[kend], 0.f)) : 0.f;
      }
    }
    __syncthreads();  // tile kt arrived; the factors are written
    const E* s_b = s_stage;

    // c . b^T for q rows 16 rs.., keys KW wg.. of the tile, once for all
    // heads (on the diagonal tile not where every key is past every row)
    if (!(diag && wg * KW > rs * 16 + 15)) {
      float cb[KW / 8][4] = {};
      if constexpr (kF32<E>) {
        for (int n = 0; n < N; ++n) {
          const float cv0 = s_c[r0 * LDN + n], cv1 = s_c[r1 * LDN + n];
#pragma unroll
          for (int j = 0; j < KW / 8; ++j) {
            const int k = wg * KW + j * 8 + 2 * tg;
            const float b0 = s_b[k * LDN + n], b1 = s_b[(k + 1) * LDN + n];
            cb[j][0] = fmaf(cv0, b0, cb[j][0]);
            cb[j][1] = fmaf(cv0, b1, cb[j][1]);
            cb[j][2] = fmaf(cv1, b0, cb[j][2]);
            cb[j][3] = fmaf(cv1, b1, cb[j][3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t ca[4];
          ldmatrix_x4(ca, smem_addr(s_c + (rs * 16 + (lane & 15)) * LDN + kk * 16 +
                                    (lane >> 4) * 8));
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, smem_addr(s_b + (wg * KW + np * 16 + (mi >> 1) * 8 + mr) * LDN +
                                     kk * 16 + (mi & 1) * 8));
            mma_bf16(cb[2 * np], ca, r[0], r[1]);
            mma_bf16(cb[2 * np + 1], ca, r[2], r[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        const int k = wg * KW + j * 8 + 2 * tg;
        store2(s_cb + r0 * LDC + k, cb[j][0], cb[j][1]);
        store2(s_cb + r1 * LDC + k, cb[j][2], cb[j][3]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < WH; ++w) {
      const int hh = wg * WH + w;
      if (hh >= nh) break;
      const float* A = s_acs + hh * QS;
      const float* eq = s_eq + hh * T * NKB;
      const float* ek = s_ek + hh * T;
      const E* xs = s_b + T * LDN + hh * T * LDX;
      if constexpr (kF32<E>) {
        for (int k = 0; k < T; ++k) {
          const int kb = k / KB;
          float w0 = eq[r0 * NKB + kb] * ek[k], w1 = eq[r1 * NKB + kb] * ek[k];
          if (diag && kb >= rs) {
            w0 = kb == rs ? decay_diag(A, q0, k0, Q, r0, k) : 0.f;
            w1 = kb == rs ? decay_diag(A, q0, k0, Q, r1, k) : 0.f;
          }
          const float l0 = s_cb[r0 * LDC + k] * w0, l1 = s_cb[r1 * LDC + k] * w1;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int p = j * 8 + 2 * tg;
            const float x0 = xs[k * LDX + p], x1 = xs[k * LDX + p + 1];
            acc[w][j][0] = fmaf(l0, x0, acc[w][j][0]);
            acc[w][j][1] = fmaf(l0, x1, acc[w][j][1]);
            acc[w][j][2] = fmaf(l1, x0, acc[w][j][2]);
            acc[w][j][3] = fmaf(l1, x1, acc[w][j][3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) {
          if (diag && kk > rs) break;  // above the diagonal: L is 0
          // A fragment of L = bf16((c . b^T) o decay): rows r0 / r1, keys
          // 16 kk + 2 tg (+1) (+8); the decay below the warp's diagonal
          // block a row factor times a key factor, on it taken per element
          float2 v[4], dw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = *reinterpret_cast<const float2*>(s_cb + ((j & 1) ? r1 : r0) * LDC +
                                                    kk * 16 + (j >> 1) * 8 + 2 * tg);
          if (diag && kk == rs) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = (j & 1) ? r1 : r0, k = kk * 16 + (j >> 1) * 8 + 2 * tg;
              dw[j] = make_float2(decay_diag(A, q0, k0, Q, r, k),
                                  decay_diag(A, q0, k0, Q, r, k + 1));
            }
          } else {
            const float e0 = eq[r0 * NKB + kk], e1 = eq[r1 * NKB + kk];
            const float2 f0 = *reinterpret_cast<const float2*>(ek + kk * 16 + 2 * tg);
            const float2 f1 = *reinterpret_cast<const float2*>(ek + kk * 16 + 8 + 2 * tg);
            dw[0] = make_float2(e0 * f0.x, e0 * f0.y);
            dw[1] = make_float2(e1 * f0.x, e1 * f0.y);
            dw[2] = make_float2(e0 * f1.x, e0 * f1.y);
            dw[3] = make_float2(e1 * f1.x, e1 * f1.y);
          }
          uint32_t la[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) la[j] = pack_bf16(v[j].x * dw[j].x, v[j].y * dw[j].y);
#pragma unroll
          for (int dp = 0; dp < NJ / 2; ++dp) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, smem_addr(xs + (kk * 16 + (mi & 1) * 8 + mr) * LDX +
                                           dp * 16 + (mi >> 1) * 8));
            mma_bf16(acc[w][2 * dp], la, r[0], r[1]);
            mma_bf16(acc[w][2 * dp + 1], la, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // the tiles, s_cb, s_eq and s_ek are reused
    if (kt + 1 <= qt) issue_tiles(kt + 1);
  }

  // y through shared memory (the stage region, free after the last
  // barrier), then out in 16-byte vectors: the heads of the block are
  // adjacent in a row of y
  E* s_y = s_stage;  // HB x T x LDX
  static_assert(HB * T * LDX <= stage_elems<E, N>(), "y fits in the stage region");
#pragma unroll
  for (int w = 0; w < WH; ++w) {
    const int hh = wg * WH + w;
    if (hh >= nh) break;
    E* yw = s_y + hh * T * LDX;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int p = j * 8 + 2 * tg;
      store2(yw + r0 * LDX + p, acc[w][j][0], acc[w][j][1]);
      store2(yw + r1 * LDX + p, acc[w][j][2], acc[w][j][3]);
    }
  }
  __syncthreads();
  constexpr int EPV = 16 / (int)sizeof(E), VPR = P / EPV;
  const int rows = min(T, Q - q0);
  for (int i = tid; i < T * HB * VPR; i += THREADS) {
    const int r = i / (HB * VPR), hh = (i / VPR) % HB, v = i % VPR;
    if (r < rows && hh < nh)
      *reinterpret_cast<uint4*>(y + (((long long)b * L + c0 + q0 + r) * H + h0 + hh) * P +
                                v * EPV) =
          *reinterpret_cast<const uint4*>(s_y + (hh * T + r) * LDX + v * EPV);
  }
}

// ---------------------------------------------------------------- host

template <typename E, int N>
size_t max_smem(int Q) {
  const size_t s1 = state_smem<E, N>(Q), s3 = scan_smem<E, N>(Q);
  return s1 > s3 ? s1 : s3;
}

template <typename E, int N>
int launch(const void* x, const void* a, const void* b, const void* c, void* y,
           void* state_out, void* acs, void* prev, void* counts, int B, int L, int H,
           int G, int Q, int pipeline, Strides sx, Strides sa, Strides sb, Strides sc,
           int device, cudaStream_t stream) {
  // the shared-memory opt-in (the device's maximum) is set once per
  // (instantiation, device); each launch asks for what its Q needs
  static bool configured[MAX_DEVICES] = {};
  if (device >= MAX_DEVICES || !configured[device]) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_state_kernel<E, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<E, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    if (device < MAX_DEVICES) configured[device] = true;
  }
  const int nc = L / Q, h_per_g = H / G, n_hb = (h_per_g + HB - 1) / HB;
  const E* xe = static_cast<const E*>(x);
  ssd_state_kernel<E, N><<<dim3(P / PH, G * ((h_per_g + SH - 1) / SH), B), THREADS,
                           state_smem<E, N>(Q), stream>>>(
      xe, static_cast<const float*>(a), static_cast<const E*>(b), static_cast<float*>(acs),
      static_cast<E*>(prev), static_cast<float*>(state_out), L, Q, H, h_per_g, sx, sa, sb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<E, N><<<dim3((Q + T - 1) / T, nc, B * G * n_hb), THREADS,
                                scan_smem<E, N>(Q), stream>>>(
      xe, static_cast<const E*>(b), static_cast<const E*>(c),
      static_cast<const float*>(acs), static_cast<const E*>(prev), static_cast<E*>(y),
      static_cast<int*>(counts), L, Q, H, G, h_per_g, pipeline, sx, sb, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) the larger of the two kernels needs for
// sub-chunks of Q steps; 0 for a (dtype, N) the kernels do not take.
extern "C" int ssd_scan_smem(int dtype, int N, int Q) {
  if (dtype == 0 && N == 64) return (int)max_smem<float, 64>(Q);
  if (dtype == 0 && N == 128) return (int)max_smem<float, 128>(Q);
  if (dtype == 1 && N == 64) return (int)max_smem<__nv_bfloat16, 64>(Q);
  if (dtype == 1 && N == 128) return (int)max_smem<__nv_bfloat16, 128>(Q);
  return 0;
}

// x (B,L,H,P) and b, c (B,L,G,N) in float32 (dtype 0) or bfloat16 (dtype
// 1), strided with a unit last dim and 16-byte aligned rows; a (B,L,H)
// float32, strided; y (B,L,H,P) contiguous in x's dtype; state_out
// (B,H,P,N) float32 or null. Scratch, contiguous: acs (B,H,L) float32 and
// prev (B,H,L/Q-1,P,N) in x's dtype. Q divides L. counts: the probe's
// counter block, int32 (B,H,L/(Q*pipeline)) zeroed, or null. Launches the
// two kernels on `stream`; returns a cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* b, const void* c,
                            void* y, void* state_out, void* acs, void* prev, void* counts,
                            int B, int L, int H, int G, int Pd, int N, int Q, int dtype,
                            int pipeline, long long sxb,
                            long long sxl, long long sxh, long long sab, long long sal,
                            long long sah, long long sbb, long long sbl, long long sbg,
                            long long scb, long long scl, long long scg, int device,
                            void* stream) {
  int current = -1;
  if (device < 0) return (int)cudaErrorInvalidDevice;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  if (B < 1 || L < 1 || G < 1 || H % G || Q < 1 || L % Q || Pd != P || pipeline < 1 ||
      (L / Q) % pipeline)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sx{sxb, sxl, sxh}, sa{sab, sal, sah}, sb{sbb, sbl, sbg}, sc{scb, scl, scg};
#define SSD_CASE(DT, E, NN)                                                                  \
  if (dtype == DT && N == NN)                                                                \
    return launch<E, NN>(x, a, b, c, y, state_out, acs, prev, counts, B, L, H, G, Q,       \
                         pipeline, sx, sa, sb, sc, device, s);
  SSD_CASE(0, float, 64)
  SSD_CASE(0, float, 128)
  SSD_CASE(1, __nv_bfloat16, 64)
  SSD_CASE(1, __nv_bfloat16, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
