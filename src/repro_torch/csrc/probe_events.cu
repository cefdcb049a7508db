// Probe-state transitions for the profiler (repro_torch.core.instrument):
// the counterpart of the TPU path's emit_events + CycleSource
// (src/repro/core/instrument.py). One launch applies one scope
// transition's exits and enters to the int64 probe state:
//
//   cycle  ()             the clock
//   cnt    (3, n)         STARTS / TOTALS / ENDS planes
//   calls  (n,)           completed calls per probe
//   ring   (n, depth, 2)  (start, end) of the first `depth` calls, or of
//                         the current window for a spilling probe
//
// "now" is, in model mode, the clock plus the segment cycles passed in
// (the clock is written back), and in wallclock mode the SM's
// %globaltimer (ns), read in stream order, so it times execution, not
// launch. All events of a launch share one "now" and run in order, so
// an exit and the next enter of one probe (a loop's iteration boundary)
// may share a launch:
//
//   exit p:  TOTALS[p] += now, ENDS[p] = now, ring end, calls[p] += 1
//   enter p: STARTS[p] = now on the first call, TOTALS[p] -= now,
//            ring start
//
// The ring slot is calls % depth for a spilling probe and
// min(calls, depth - 1) (written only while calls < depth) otherwise.
// The work is a few dependent 8-byte loads and stores, so one thread
// does it. Arithmetic is on uint64 (wrapping), the bits of int64.
//
// A second kernel, probe_grid, folds one probed kernel call's grid steps
// into the same state (repro_torch.core.kernelprobe): for each step of the
// TPU kernel's grid, in its sequential order (last axis fastest), what a
// chain of the transitions above would apply, at the model clock:
//
//   grid enter, + transfer cycles,
//   for each inner scope in body order: enter, + its cycles, exit,
//   grid exit.
//
// A scope's cycles at a step are one entry of its cost table, picked by
// its rule from the step's last grid coordinate and the kernel's counter
// block (the rule codes of core/kernelprobe.py). One CTA does the fold,
// each warp a contiguous run of 32-step chunks, a lane a step of each
// chunk (so a warp's counter reads are in flight together): the warps'
// sums, scanned across the CTA, give each warp the clock at its first
// step, and a scan over the lanes gives each lane its step's, whose ring
// slots it then writes. A probe's totals are the sum of
// its spans; its ring gets what the transitions would have left there: the
// first `depth` calls, or, for a spilling probe, the last call of each
// slot. A spilling probe's windows that fill during the fold go, whole,
// to a device block at the row the host gives (its earlier slots of the
// first window copied from the ring before any write), so the host copies
// the block once.
//
// Plain C interface (ctypes), as the other kernels of this directory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_EVENTS = 64;
constexpr int STARTS = 0, TOTALS = 1, ENDS = 2;

struct Events {
  int n;
  int code[MAX_EVENTS];  // pid << 2 | enter << 1 | spill
};

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void probe_events_kernel(uint64_t* __restrict__ cycle,
                                    uint64_t* __restrict__ cnt,
                                    uint64_t* __restrict__ calls,
                                    uint64_t* __restrict__ ring, int n_probes,
                                    int depth, int wallclock, uint64_t seg,
                                    Events ev) {
  const uint64_t now = wallclock ? globaltimer() : cycle[0] + seg;
  cycle[0] = now;
  const uint64_t d = static_cast<uint64_t>(depth);
  for (int i = 0; i < ev.n; ++i) {
    const int code = ev.code[i];
    const int p = code >> 2;
    const bool enter = (code >> 1) & 1, spill = code & 1;
    const uint64_t c = calls[p];
    const uint64_t slot = spill ? c % d : (c < d - 1 ? c : d - 1);
    const bool write = spill || c < d;
    uint64_t* r = ring + (static_cast<uint64_t>(p) * d + slot) * 2;
    if (enter) {
      if (c == 0) cnt[STARTS * n_probes + p] = now;
      cnt[TOTALS * n_probes + p] -= now;
      if (write) r[0] = now;
    } else {
      cnt[TOTALS * n_probes + p] += now;
      cnt[ENDS * n_probes + p] = now;
      if (write) r[1] = now;
      calls[p] = c + 1;
    }
  }
}

// The steps of %globaltimer as one thread sees them: the first n
// differences between successive distinct readings (0 where the timer
// did not move within the spin budget).
__global__ void globaltimer_steps_kernel(uint64_t* out, int n) {
  uint64_t last = globaltimer();
  int k = 0;
  for (long long it = 0; k < n && it < (1LL << 26); ++it) {
    const uint64_t t = globaltimer();
    if (t != last) {
      out[k++] = t - last;
      last = t;
    }
  }
  for (; k < n; ++k) out[k] = 0;
}

constexpr int MAX_IDS = 8;      // the grid node and up to 7 inner scopes
constexpr int MAX_TABLE = 320;  // cost-table entries, all scopes
constexpr int FOLD_THREADS = 512, FOLD_WARPS = FOLD_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
enum Rule { CONST = 0, FIRST, LAST, BELOW, AT_END, COUNT, SLOTS };

struct GridPlan {
  long long steps, transfer;
  int last;      // the grid's last (fastest) axis
  int n_scopes;  // inner scopes; id 0 is the grid node
  int rule[MAX_IDS], off[MAX_IDS], size[MAX_IDS];
  int kv, nt, tile, sps;  // the SLOTS rule's geometry
  int id[MAX_IDS + 1], spill[MAX_IDS + 1], dump_off[MAX_IDS + 1];
  long long table[MAX_TABLE];
};

// A step's place in the grid: its index, its row (the leading axes,
// flattened) and its column (the last axis). 32-bit: the host checks that
// the steps fit, and a 64-bit division is a long software routine.
struct Step {
  int s, row, col;
};

__device__ __forceinline__ Step step_at(const GridPlan& pl, int s) {
  const int row = s / pl.last;
  return Step{s, row, s - row * pl.last};
}

// scope j's cycles at step st
__device__ __forceinline__ uint64_t scope_cycles(const GridPlan& pl, const int* cnt,
                                                 const Step& st, int j) {
  const int row = st.row, col = st.col;
  int v = 0;
  switch (pl.rule[j]) {
    case FIRST: v = col == 0; break;
    case LAST: v = col == pl.last - 1; break;
    case BELOW: v = col < cnt[2 * row + 1]; break;
    case AT_END: v = col == cnt[2 * row + 1] - 1; break;
    case COUNT: v = cnt[st.s]; break;
    case SLOTS: {
      const int lo = col * pl.sps, hi = lo + pl.sps;
      for (int t = lo / pl.tile; t <= (hi - 1) / pl.tile && t < pl.nt; ++t)
        for (int h = 0; h < pl.kv; ++h) {
          const int c = min(max(cnt[(row * pl.kv + h) * pl.nt + t], 0), pl.tile);
          const int a = max(lo, t * pl.tile), b = min(hi, t * pl.tile + c);
          v += b > a ? b - a : 0;
        }
      break;
    }
    default: v = 0;
  }
  v = min(max(v, 0), pl.size[j] - 1);
  return (uint64_t)pl.table[pl.off[j] + v];
}

template <int NS>
__device__ __forceinline__ uint64_t step_cycles(const GridPlan& pl, const int* cnt,
                                                int s) {
  const Step st = step_at(pl, s);
  uint64_t d = (uint64_t)pl.transfer;
#pragma unroll
  for (int j = 0; j < NS; ++j) d += scope_cycles(pl, cnt, st, j);
  return d;
}

// the (enter, exit) of call c0 + s of id k
__device__ __forceinline__ void record(const GridPlan& pl, int k, uint64_t c0, long long s,
                                       uint64_t in, uint64_t out, uint64_t* ring, int depth,
                                       uint64_t* dump, int dump_rows) {
  const int p = pl.id[k];
  if (p < 0) return;
  const uint64_t d = (uint64_t)depth, n = c0 + (uint64_t)s, end = c0 + (uint64_t)pl.steps;
  if (!pl.spill[k]) {
    if (n < d) {
      uint64_t* r = ring + ((uint64_t)p * d + n) * 2;
      r[0] = in;
      r[1] = out;
    }
    return;
  }
  const uint64_t w = n / d, slot = n % d;
  if ((w + 1) * d <= end) {
    const long long row = pl.dump_off[k] + (long long)(w - c0 / d);
    if (row >= 0 && row < dump_rows) {
      uint64_t* r = dump + ((uint64_t)row * d + slot) * 2;
      r[0] = in;
      r[1] = out;
    }
  }
  if (n + d >= end) {
    uint64_t* r = ring + ((uint64_t)p * d + slot) * 2;
    r[0] = in;
    r[1] = out;
  }
}

__device__ __forceinline__ uint64_t warp_incl_scan(uint64_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// NS inner scopes (a template argument, so that the per-step arrays stay
// in registers)
template <int NS>
__global__ void __launch_bounds__(FOLD_THREADS)
probe_grid_kernel(uint64_t* __restrict__ cycle, uint64_t* __restrict__ cnt,
                  uint64_t* __restrict__ calls, uint64_t* __restrict__ ring, int n_probes,
                  int depth, const int* __restrict__ counters, uint64_t* __restrict__ dump,
                  int dump_rows, GridPlan pl) {
  constexpr int n_ids = NS + 1;
  __shared__ uint64_t wbase[FOLD_WARPS], total;
  __shared__ uint64_t c0[n_ids], tot[n_ids];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint64_t d = (uint64_t)depth;
  if (tid < n_ids) {
    c0[tid] = pl.id[tid] >= 0 ? calls[pl.id[tid]] : 0;
    tot[tid] = 0;
  }
  const uint64_t t0 = cycle[0];
  // warp w takes a contiguous run of 32-step chunks; lane l step 32 ch + l
  const int steps = (int)pl.steps;
  const int n_chunks = (steps + 31) / 32;
  const int per = (n_chunks + FOLD_WARPS - 1) / FOLD_WARPS;
  const int ch0 = min(n_chunks, warp * per), ch1 = min(n_chunks, ch0 + per);
  uint64_t mine = 0;
  for (int ch = ch0; ch < ch1; ++ch) {
    const int s = ch * 32 + lane;
    if (s < steps) mine += step_cycles<NS>(pl, counters, s);
  }
  mine = warp_sum(mine);
  if (lane == 0) wbase[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const uint64_t v = lane < FOLD_WARPS ? wbase[lane] : 0;
    const uint64_t incl = warp_incl_scan(v, lane);
    if (lane < FOLD_WARPS) wbase[lane] = t0 + incl - v;
    if (lane == 31) total = incl;
  }
  // a spilling probe's first window, if it fills now: its slots written
  // before this fold go to the dump before any ring write
  for (int k = 0; k < n_ids; ++k) {
    const int p = pl.id[k];
    const uint64_t r = c0[k] % d;
    if (p < 0 || !pl.spill[k] || r == 0 || (c0[k] / d + 1) * d > c0[k] + pl.steps ||
        pl.dump_off[k] < 0 || pl.dump_off[k] >= dump_rows)
      continue;
    for (uint64_t i = tid; i < 2 * r; i += FOLD_THREADS)
      dump[(uint64_t)pl.dump_off[k] * d * 2 + i] = ring[(uint64_t)p * d * 2 + i];
  }
  __syncthreads();
  uint64_t base = wbase[warp];
  uint64_t acc[n_ids] = {};
  for (int ch = ch0; ch < ch1; ++ch) {
    const int s = ch * 32 + lane;
    const bool live = s < steps;
    const Step st = step_at(pl, live ? s : 0);
    uint64_t c[NS > 0 ? NS : 1];
    uint64_t dur = live ? (uint64_t)pl.transfer : 0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      c[j] = live ? scope_cycles(pl, counters, st, j) : 0;
      dur += c[j];
    }
    const uint64_t incl = warp_incl_scan(dur, lane);
    if (live) {
      const uint64_t g_in = base + incl - dur;
      uint64_t now = g_in + (uint64_t)pl.transfer;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t in = now;
        now += c[j];
        acc[j + 1] += c[j];
        record(pl, j + 1, c0[j + 1], s, in, now, ring, depth, dump, dump_rows);
      }
      acc[0] += dur;
      record(pl, 0, c0[0], s, g_in, now, ring, depth, dump, dump_rows);
    }
    base += __shfl_sync(FULL, incl, 31);
  }
#pragma unroll
  for (int k = 0; k < n_ids; ++k) {
    const uint64_t v = warp_sum(acc[k]);
    if (lane == 0 && v) atomicAdd((unsigned long long*)&tot[k], (unsigned long long)v);
  }
  __syncthreads();
  if (tid != 0) return;
  // first enter and last exit of each id: from steps 0 and steps - 1
  const uint64_t t_end = t0 + total;
  uint64_t first = t0 + (uint64_t)pl.transfer, last = t_end;
  uint64_t first_c[MAX_IDS], last_c[MAX_IDS];
  const Step s_first = step_at(pl, 0), s_last = step_at(pl, steps - 1);
  for (int j = 0; j < pl.n_scopes; ++j) {
    first_c[j] = scope_cycles(pl, counters, s_first, j);
    last_c[j] = scope_cycles(pl, counters, s_last, j);
  }
  uint64_t after = 0;  // cycles of the last step's scopes after scope j
  for (int j = pl.n_scopes - 1; j >= 0; --j) after += last_c[j];
  for (int k = 0; k < n_ids; ++k) {
    uint64_t in, out;
    if (k == 0) {
      in = t0;
      out = t_end;
    } else {
      in = first;
      first += first_c[k - 1];
      after -= last_c[k - 1];
      out = last - after;
    }
    const int p = pl.id[k];
    if (p < 0) continue;
    if (c0[k] == 0) cnt[STARTS * n_probes + p] = in;
    cnt[ENDS * n_probes + p] = out;
    cnt[TOTALS * n_probes + p] += tot[k];
    calls[p] = c0[k] + (uint64_t)pl.steps;
  }
  cycle[0] = t_end;
}

int set_device(int device) {
  int current = -1;
  if (device < 0) return (int)cudaErrorInvalidDevice;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int probe_events(void* cycle, void* cnt, void* calls, void* ring,
                            int n_probes, int depth, int wallclock,
                            long long seg, const int* codes, int n_events,
                            int device, void* stream) {
  if (n_events < 0 || n_events > MAX_EVENTS || depth < 1)
    return (int)cudaErrorInvalidValue;
  const int err = set_device(device);
  if (err) return err;
  Events ev;
  ev.n = n_events;
  for (int i = 0; i < n_events; ++i) {
    if ((codes[i] >> 2) >= n_probes) return (int)cudaErrorInvalidValue;
    ev.code[i] = codes[i];
  }
  probe_events_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(cycle), static_cast<uint64_t*>(cnt),
      static_cast<uint64_t*>(calls), static_cast<uint64_t*>(ring), n_probes,
      depth, wallclock, static_cast<uint64_t>(seg), ev);
  return (int)cudaGetLastError();
}

extern "C" int globaltimer_steps(void* out, int n, int device, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  globaltimer_steps_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out), n);
  return (int)cudaGetLastError();
}

// One probed kernel call's grid steps (see the top of this file). rules,
// sizes: n_scopes ints; table: the scopes' cost tables, concatenated;
// geom: the SLOTS rule's (kv, nt, tile, sps); ids, spill, dump_off:
// n_scopes + 1 ints, the grid node first (-1: not probed / no dump rows).
// counters: int32, n_counters of them; dump: (dump_rows, depth, 2) int64
// or null.
extern "C" int probe_grid(void* cycle, void* cnt, void* calls, void* ring, int n_probes,
                          int depth, const void* counters, long long n_counters,
                          long long steps, int last, long long transfer, int n_scopes,
                          const int* rules, const int* sizes, const long long* table,
                          const int* geom, const int* ids, const int* spill,
                          const int* dump_off, void* dump, int dump_rows, int device,
                          void* stream) {
  if (depth < 1 || steps < 1 || steps > (1LL << 30) || last < 1 || steps % last ||
      n_scopes < 0 || n_scopes + 1 > MAX_IDS || n_counters < 1)
    return (int)cudaErrorInvalidValue;
  const int err = set_device(device);
  if (err) return err;
  GridPlan pl;
  pl.steps = steps;
  pl.transfer = transfer;
  pl.last = last;
  pl.n_scopes = n_scopes;
  pl.kv = geom[0];
  pl.nt = geom[1];
  pl.tile = geom[2];
  pl.sps = geom[3];
  int off = 0;
  for (int j = 0; j < n_scopes; ++j) {
    if (sizes[j] < 1 || off + sizes[j] > MAX_TABLE || rules[j] < CONST || rules[j] > SLOTS)
      return (int)cudaErrorInvalidValue;
    pl.rule[j] = rules[j];
    pl.size[j] = sizes[j];
    pl.off[j] = off;
    for (int i = 0; i < sizes[j]; ++i) pl.table[off + i] = table[off + i];
    off += sizes[j];
  }
  // the counter block must hold what the rules read
  const long long rows = steps / last;
  for (int j = 0; j < n_scopes; ++j) {
    const int r = rules[j];
    if (((r == BELOW || r == AT_END) && n_counters < rows * 2) ||
        (r == COUNT && n_counters < steps) ||
        (r == SLOTS && (pl.kv < 1 || pl.nt < 1 || pl.tile < 1 || pl.sps < 1 ||
                        n_counters < rows * pl.kv * pl.nt)))
      return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k <= n_scopes; ++k) {
    if (ids[k] >= n_probes) return (int)cudaErrorInvalidValue;
    pl.id[k] = ids[k];
    pl.spill[k] = spill[k];
    pl.dump_off[k] = dump_off[k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t *cy = static_cast<uint64_t*>(cycle), *cn = static_cast<uint64_t*>(cnt),
           *ca = static_cast<uint64_t*>(calls), *ri = static_cast<uint64_t*>(ring),
           *du = static_cast<uint64_t*>(dump);
  const int* co = static_cast<const int*>(counters);
#define FOLD_CASE(NS)                                                                  \
  case NS:                                                                             \
    probe_grid_kernel<NS><<<1, FOLD_THREADS, 0, s>>>(cy, cn, ca, ri, n_probes, depth, co, \
                                                     du, dump_rows, pl);               \
    break;
  switch (n_scopes) {
    FOLD_CASE(0)
    FOLD_CASE(1)
    FOLD_CASE(2)
    FOLD_CASE(3)
    FOLD_CASE(4)
    FOLD_CASE(5)
    FOLD_CASE(6)
    FOLD_CASE(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FOLD_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
