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

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
