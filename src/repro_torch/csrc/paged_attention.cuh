// Paged single-token GQA decode attention for Hopper (sm_90a): the two
// kernels and their launch, templated on the head dim HD, the query rows
// per kv head G (8 or 16) and the tile TS (slots a CTA). Each of
// paged_attention.cu (the default tile, TS = 64) and
// paged_attention_tiles.cu (TS = 32 and 128) instantiates some and exports
// the plain C interface of PAGED_C_INTERFACE; the wrapper loads the
// library of the tile it is asked for. One translation unit each, so the
// tiles build in parallel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py ::
// paged_attention (body _paged_kernel). Bound through ctypes by
// src/repro_torch/kernels/paged_attention.py, whose docstring states what
// bounds it on the card and what this design does about it.
//
// Each batch row's visible slots (slot <= pos[b]) are cut into tiles of
// TS slots from slot 0, and each launch takes one CTA per (slot tile,
// kv head, batch row), four warps serving all g query rows of the group.
// Inside a CTA each warp reads whole K / V rows: HD / 8 lanes take one row
// as 16-byte vectors, so a warp's loads are coalesced, and every load of a
// thread is issued before the first is used. Two launches keep the TPU
// kernel's exact global softmax:
//   1. statistics: s = (bf16 q . bf16 k) * scale for the tile's slots and
//      the tile's m_i = max s and l_i = sum exp(s - m_i) per query row;
//   2. output, a programmatic dependent launch: it loads its K and V rows
//      and recomputes its tile's scores while launch 1 runs, then waits
//      for it and takes m = max_i m_i and l = sum_i exp(m_i - m) l_i over
//      the row's tiles (each lane its tiles in order, then a fixed
//      butterfly), and forms the tile's partial o_t = sum over its slots
//      of bf16(exp(s - m) / l) * bf16 v; the last CTA of a (row, kv head)
//      to arrive (an integer counter that launch 1 zeroes) sums the
//      partials in tile order into the output.
// Launch 2 can also write the probe's counter block: the slots each CTA
// reads, per (row, kv head, tile) (0 for a tile past pos).
// Masked slots are skipped: the TPU kernel gives them exp(-inf) = 0. No
// floating-point atomics, and every reduction runs in an order fixed by
// pos[b] alone, so each row's bits are independent of batch size, padding
// lanes and page placement.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 16;         // query rows per kv head (the wrapper checks)
constexpr unsigned FULL = 0xffffffffu;

// the 16-byte vectors of K or V rows a lane loads for a tile of TS slots:
// HD / 8 lanes a row, TS / WARPS slots a warp
template <int HD, int TS>
__host__ __device__ constexpr int iters() {
  return TS / WARPS / (32 / (HD / 8));
}

// the shared memory of each launch, one struct so that its size is the
// C layout's (the wrapper's paged_resources, the same formula)
template <int G, int TS>
struct StatsSmem {
  float sS[G][TS];  // the tile's scores
  int srow[TS];     // pool row of each slot
};

template <int HD, int G, int TS>
struct OutputSmem {
  float sS[G][TS];
  float sm[G], sl[G];               // the row's global max and sum
  __align__(16) float sP[TS][G];    // bf16(p / l), 0 past nv
  float sO[WARPS][G * HD];          // each warp's partial output
  int srow[TS];
  bool last;
};

// static shared memory a block may have (48 KB): head dim 128 with 16
// query rows a kv head and tiles of 128 slots needs 49,808 bytes and is
// not instantiated (the wrapper's budget refuses it)
constexpr size_t STATIC_SMEM = 48 * 1024;

template <int HD, int G, int TS>
constexpr bool fits() {
  return sizeof(OutputSmem<HD, G, TS>) <= STATIC_SMEM;
}

// scratch carved from one f32 buffer (the wrapper sizes it the same way)
struct Scratch {
  float* opart;  // (B, kv, nt, g, HD) partial outputs per tile
  float* m;      // (B, kv, g, nt) tile maxima
  float* l;      // (B, kv, g, nt) tile sums
  int* arrived;  // (B, kv) CTAs of launch 2 done
};

__host__ __device__ inline Scratch carve(float* base, int B, int kv, int g,
                                         int hd, int nt) {
  Scratch sc;
  const size_t bk = (size_t)B * kv;
  sc.opart = base;
  sc.m = sc.opart + bk * nt * g * hd;
  sc.l = sc.m + bk * g * nt;
  sc.arrived = reinterpret_cast<int*>(sc.l + bk * g * nt);
  return sc;
}

// the tile's geometry: its visible slots nv, and the row's tiles nt_row
struct Tile {
  int nv, nt_row;
};

template <int TS>
__device__ __forceinline__ Tile tile_of(const int* pos, int b, int t,
                                        int s_max) {
  const int n = max(0, min(pos[b] + 1, s_max));  // the row's visible slots
  return Tile{min(TS, n - t * TS), (n + TS - 1) / TS};
}

// pool row of each of the tile's slots (page ids clamped into the pool);
// slots past the table repeat its last, so every load stays in bounds. It
// does not read pos, so the page-table and pos loads overlap.
template <int TS>
__device__ __forceinline__ void pool_rows(int* srow, const int* pages, int t,
                                          int b, int n_pages, int page_size,
                                          int pool_pages) {
  for (int i = threadIdx.x; i < TS; i += THREADS) {
    const int slot = min(t * TS + i, n_pages * page_size - 1);
    const int pid =
        min(max(pages[(size_t)b * n_pages + slot / page_size], 0), pool_pages - 1);
    srow[i] = pid * page_size + slot % page_size;
  }
}

// a 16-byte load through the read-only path; volatile keeps the compiler
// from sinking a thread's loads to their first use
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = __bfloat1622float2(h2[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}

// the lane's 16-byte chunk c of each of the group's g query rows
template <int HD, int G>
__device__ __forceinline__ void load_q(uint4 (&qraw)[G], const __nv_bfloat16* q,
                                       size_t bh, int g, int c) {
#pragma unroll
  for (int j = 0; j < G; ++j)
    qraw[j] = j < g ? ldg16(q + (bh * g + j) * HD + c * 8) : make_uint4(0, 0, 0, 0);
}

// The lane's rows of the tile, as the warp walks them: rows
// warp * SPW + it * RPW + lane / LPR, chunk lane % LPR
template <int HD, int TS>
__device__ __forceinline__ void load_rows(uint4 (&raw)[iters<HD, TS>()],
                                          const __nv_bfloat16* pool,
                                          const int* srow, int kv, int h) {
  constexpr int LPR = HD / 8, RPW = 32 / LPR, SPW = TS / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int it = 0; it < SPW / RPW; ++it) {
    const int i = warp * SPW + it * RPW + lane / LPR;
    raw[it] = ldg16(pool + ((size_t)srow[i] * kv + h) * HD + (lane % LPR) * 8);
  }
}

// s = (bf16 q . bf16 k) * scale of the tile's first nv slots into sS[j][i]:
// eight products a lane, then a fixed butterfly over the row's lanes
template <int HD, int G, int TS>
__device__ __forceinline__ void tile_scores(float (*sS)[TS],
                                            const uint4 (&qraw)[G],
                                            const uint4 (&kraw)[iters<HD, TS>()],
                                            int g, int nv, float scale) {
  constexpr int LPR = HD / 8, RPW = 32 / LPR, SPW = TS / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % LPR;
  float qf[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) unpack8(qraw[j], qf[j]);
#pragma unroll
  for (int it = 0; it < SPW / RPW; ++it) {
    const int i = warp * SPW + it * RPW + lane / LPR;
    float kf[8];
    unpack8(kraw[it], kf);
    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      acc[j] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j] = fmaf(qf[j][e], kf[e], acc[j]);
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) {
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g && j % LPR == c && i < nv) sS[j][i] = acc[j] * scale;
  }
}

template <int HD, int G, int TS>
__global__ void __launch_bounds__(THREADS)
paged_stats_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ pool_k,
                   const int* __restrict__ pages, const int* __restrict__ pos,
                   float* __restrict__ scratch, int B, int kv, int g,
                   int page_size, int n_pages, int pool_pages, float scale) {
  constexpr int ITERS = iters<HD, TS>();
  __shared__ StatsSmem<G, TS> sh;
  auto& sS = sh.sS;
  int* srow = sh.srow;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s_max = n_pages * page_size, nt = gridDim.x;
  const Scratch sc = carve(scratch, B, kv, g, HD, nt);
  const size_t bh = (size_t)b * kv + h;
  // launch 2 may start now: it does all it can before it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (t == 0 && threadIdx.x == 0) sc.arrived[bh] = 0;  // for launch 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4 qraw[G];  // q, pos and the page table load side by side
  load_q<HD, G>(qraw, q, bh, g, lane % (HD / 8));
  const Tile tl = tile_of<TS>(pos, b, t, s_max);
  pool_rows<TS>(srow, pages, t, b, n_pages, page_size, pool_pages);
  if (tl.nv <= 0) return;
  __syncthreads();
  uint4 kraw[ITERS];
  load_rows<HD, TS>(kraw, pool_k, srow, kv, h);
  tile_scores<HD, G, TS>(sS, qraw, kraw, g, tl.nv, scale);
  __syncthreads();
  // the tile's max and sum per query row, one warp per row
  for (int j = warp; j < g; j += WARPS) {
    float mx = -INFINITY;
    for (int i = lane; i < tl.nv; i += 32) mx = fmaxf(mx, sS[j][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.f;
    for (int i = lane; i < tl.nv; i += 32) sum += expf(sS[j][i] - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      sc.m[(bh * g + j) * nt + t] = mx;
      sc.l[(bh * g + j) * nt + t] = sum;
    }
  }
}

template <int HD, int G, int TS>
__global__ void __launch_bounds__(THREADS)
paged_output_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ pages, const int* __restrict__ pos,
                    float* __restrict__ out, float* __restrict__ scratch,
                    int* __restrict__ counts, int B, int kv, int g, int page_size,
                    int n_pages, int pool_pages, float scale) {
  constexpr int LPR = HD / 8;
  constexpr int RPW = 32 / LPR;
  constexpr int SPW = TS / WARPS;
  constexpr int ITERS = iters<HD, TS>();
  __shared__ OutputSmem<HD, G, TS> sh;
  auto& sS = sh.sS;
  auto& sP = sh.sP;
  auto& sO = sh.sO;
  float* sm = sh.sm;
  float* sl = sh.sl;
  int* srow = sh.srow;
  bool& last = sh.last;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s_max = n_pages * page_size, nt = gridDim.x;
  const Scratch sc = carve(scratch, B, kv, g, HD, nt);
  const size_t bh = (size_t)b * kv + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % LPR, r = lane / LPR;
  float* o_row = out + bh * g * HD;
  uint4 qraw[G];
  load_q<HD, G>(qraw, q, bh, g, c);
  const Tile tl = tile_of<TS>(pos, b, t, s_max);
  if (counts != nullptr && threadIdx.x == 0) counts[bh * nt + t] = max(tl.nv, 0);
  pool_rows<TS>(srow, pages, t, b, n_pages, page_size, pool_pages);
  if (tl.nv <= 0) {
    if (t == 0)  // no visible slot at all: the output is 0
      for (int i = threadIdx.x; i < g * HD; i += THREADS) o_row[i] = 0.f;
    return;
  }
  __syncthreads();
  // nothing up to the wait depends on launch 1: K and V rows, the scores
  uint4 kraw[ITERS], vraw[ITERS];
  load_rows<HD, TS>(kraw, pool_k, srow, kv, h);
  load_rows<HD, TS>(vraw, pool_v, srow, kv, h);
  tile_scores<HD, G, TS>(sS, qraw, kraw, g, tl.nv, scale);
  // launch 1's tile statistics and zeroed counter are visible after this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the row's global max and sum from its tiles, one warp per query row:
  // each lane takes tiles lane, lane + 32, ... in order, then a fixed
  // butterfly
  for (int j = warp; j < g; j += WARPS) {
    const float* mj = sc.m + (bh * g + j) * nt;
    const float* lj = sc.l + (bh * g + j) * nt;
    float mx = -INFINITY;
    for (int i = lane; i < tl.nt_row; i += 32) mx = fmaxf(mx, mj[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.f;
    for (int i = lane; i < tl.nt_row; i += 32) sum = fmaf(expf(mj[i] - mx), lj[i], sum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      sm[j] = mx;
      sl[j] = sum;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TS * G; idx += THREADS) {
    const int j = idx / TS, i = idx % TS;
    float p = 0.f;
    if (j < g && i < tl.nv)
      p = __bfloat162float(__float2bfloat16(expf(sS[j][i] - sm[j]) / sl[j]));
    sP[i][j] = p;
  }
  __syncthreads();

  // slots past nv have p = 0 and add exact zeros
  float acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = warp * SPW + it * RPW + r;
    float vf[8];
    unpack8(vraw[it], vf);
#pragma unroll
    for (int j4 = 0; j4 < G; j4 += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sP[i][j4]);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[j4 + jj][e] = fmaf(p[jj], vf[e], acc[j4 + jj][e]);
    }
  }
  // the warp's row groups, a fixed butterfly; then the warps in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] += __shfl_xor_sync(FULL, acc[j][e], o);
  if (r == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g)
#pragma unroll
        for (int e = 0; e < 8; ++e) sO[warp][j * HD + c * 8 + e] = acc[j][e];
  }
  __syncthreads();
  float* part = sc.opart + (bh * nt + t) * g * HD;
  for (int idx = threadIdx.x; idx < g * HD; idx += THREADS) {
    float s = sO[0][idx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += sO[w][idx];
    part[idx] = s;
  }

  // the last CTA of (b, h) to arrive sums the tiles' partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sc.arrived[bh], 1) == tl.nt_row - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // (sixteen tiles' loads in flight at once, then a sequential sum)
  const float* parts = sc.opart + bh * nt * g * HD;
  for (int idx = threadIdx.x; idx < g * HD; idx += THREADS) {
    float s = 0.f;
    for (int i0 = 0; i0 < tl.nt_row; i0 += 16) {
      float x[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        x[u] = i0 + u < tl.nt_row ? __ldcg(parts + (size_t)(i0 + u) * g * HD + idx)
                                  : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (i0 + u < tl.nt_row) s = i0 + u == 0 ? x[u] : s + x[u];
    }
    o_row[idx] = s;
  }
}

template <int HD, int G, int TS>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* pages, const void* pos, void* out, void* scratch,
           void* counts, int B, int kv, int g, int page_size, int n_pages,
           int pool_pages, float scale, cudaStream_t stream) {
  const int nt = (n_pages * page_size + TS - 1) / TS;
  const dim3 grid(nt, kv, B);
  paged_stats_kernel<HD, G, TS><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const int*>(pages), static_cast<const int*>(pos),
      static_cast<float*>(scratch), B, kv, g, page_size, n_pages, pool_pages,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: launch 2 overlaps launch 1
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, paged_output_kernel<HD, G, TS>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(scratch), static_cast<int*>(counts), B, kv, g,
      page_size, n_pages, pool_pages, scale);
}

template <int HD, int TS>
int launch_g(const void* q, const void* pool_k, const void* pool_v,
             const void* pages, const void* pos, void* out, void* scratch,
             void* counts, int B, int kv, int g, int page_size, int n_pages,
             int pool_pages, float scale, cudaStream_t stream) {
  if (g <= 8)
    return launch<HD, 8, TS>(q, pool_k, pool_v, pages, pos, out, scratch,
                             counts, B, kv, g, page_size, n_pages, pool_pages,
                             scale, stream);
  if constexpr (fits<HD, MAXG, TS>())
    return launch<HD, MAXG, TS>(q, pool_k, pool_v, pages, pos, out, scratch,
                                counts, B, kv, g, page_size, n_pages,
                                pool_pages, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// the two kernels' attributes from cudaFuncGetAttributes: out = {static
// shared bytes, registers a thread, local bytes a thread (spills)} of the
// statistics kernel, then of the output kernel
template <int HD, int G, int TS>
int attrs(int* out) {
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, paged_stats_kernel<HD, G, TS>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&b, paged_output_kernel<HD, G, TS>);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)b.sharedSizeBytes;
  out[4] = b.numRegs;
  out[5] = (int)b.localSizeBytes;
  return 0;
}

template <int HD, int TS>
int attrs_g(int g, int* out) {
  if (g <= 8) return attrs<HD, 8, TS>(out);
  if constexpr (fits<HD, MAXG, TS>()) return attrs<HD, MAXG, TS>(out);
  return (int)cudaErrorInvalidValue;
}

inline int select_device(int device) {
  int current = -1;
  if (device < 0) return (int)cudaErrorInvalidDevice;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    return (int)cudaSetDevice(device);
  return 0;
}

}  // namespace

#define PAGED_LAUNCH(HD_, TS_)                                              \
  if (hd == HD_ && tile_slots == TS_)                                       \
    return launch_g<HD_, TS_>(q, pool_k, pool_v, pages, pos, out, scratch,  \
                              counts, B, kv, g, page_size, n_pages,         \
                              pool_pages, scale,                            \
                              static_cast<cudaStream_t>(stream));
#define PAGED_ATTRS(HD_, TS_) \
  if (hd == HD_ && tile_slots == TS_) return attrs_g<HD_, TS_>(g, out);

// The C interface of a translation unit that instantiates the (HD, TS)
// listed by CASES(X), a macro that applies X to each, for g <= 8 and
// g <= 16:
//   paged_attention_fwd: q (B,kv,g,hd) bf16; pools (pool_pages,page_size,
//     kv,hd) bf16; pages (B,n_pages) int32; pos (B,) int32; out (B,kv,g,hd)
//     f32; scratch: f32 of B * kv * (g * (nt * hd + 2 * nt) + 1) elements,
//     nt = ceil(n_pages * page_size / tile_slots); counts: the probe's
//     counter block, int32 (B, kv, nt), or null;
//   paged_attention_attrs: the kernels' attributes (see attrs_g);
// each returns a cudaError_t (cudaErrorInvalidValue for a head dim or
// tile the unit does not instantiate).
#define PAGED_C_INTERFACE(CASES)                                              \
  extern "C" int paged_attention_fwd(                                         \
      const void* q, const void* pool_k, const void* pool_v,                  \
      const void* pages, const void* pos, void* out, void* scratch,           \
      void* counts, int B, int kv, int g, int hd, int page_size, int n_pages, \
      int pool_pages, int tile_slots, float scale, int device,                \
      void* stream) {                                                         \
    const int err = select_device(device);                                    \
    if (err) return err;                                                      \
    if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;                 \
    CASES(PAGED_LAUNCH)                                                       \
    return (int)cudaErrorInvalidValue;                                        \
  }                                                                           \
  extern "C" int paged_attention_attrs(int hd, int g, int tile_slots,         \
                                       int device, int* out) {                \
    const int err = select_device(device);                                    \
    if (err) return err;                                                      \
    if (g < 1 || g > MAXG) return (int)cudaErrorInvalidValue;                 \
    CASES(PAGED_ATTRS)                                                        \
    return (int)cudaErrorInvalidValue;                                        \
  }                                                                           \
  extern "C" const char* error_string(int code) {                             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
