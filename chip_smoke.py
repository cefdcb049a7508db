#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the port's CUDA kernels from src/repro_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel);
3. holds the flash-attention kernel against its plain PyTorch version
   and the naive oracle at the serving shapes, checks that rows taken at
   a q offset equal the whole call's rows bitwise, and that the probe
   counts equal the plain version's;
4. holds the paged-attention kernel against its plain version and checks
   that each row is bitwise invariant to batching and page placement;
5. holds the SSD-scan kernels (chunk states and their carry, then the
   chunk scan) against their plain version (y and the final state) at
   the mamba2-370m serving shape, with two groups and a pipeline of 2,
   and, padded as ssm_apply pads, against the exact recurrence; checks
   that each row is bitwise invariant to batching, and that the shared
   memory the SSD search space declares to the DSE budget
   (``ssd_scan.ssd_smem_bytes``) is the kernels' ``ssd_scan_smem``;
6. serves tinyllama-1.1b at full width (random weights from a seed)
   through the engine: whole-prompt prefill with the decode kernel,
   chunked prefill, dense decode, and the legacy loop; the launch
   counters are zeroed before each run and must equal 22 x the steps;
7. serves mamba2-370m at full width (48 layers, the legacy loop: the
   engine refuses the ssm family) with 8 x 1024 prompt tokens and 32 new
   tokens; the SSD wrapper calls must equal 48 x the prefill steps
   (each call launches the kernels of ssd_scan.KERNELS);
8. probes the port's full-width prefills and decode step with
   ``repro_torch.core.probe`` (every scope a probe): the tinyllama-1.1b
   prefill (8 x 512) and ``decode_step``, and the mamba2-370m prefill
   (8 x 1024). In model mode the device record must equal the oracle's,
   the probed logits and caches must equal the unprobed ones bitwise,
   and the flash (SSD) wrapper must launch 22 (48) times inside the
   probed prefill; in wallclock mode (``%globaltimer``) the calls must
   equal the oracle's, every ring interval must lie inside its parent
   probe's and start <= end. Holds the probe-events kernel against its
   plain version over a sequence of transitions (integer equality) and
   prints the report's top rows, the probe's overhead (probed against
   unprobed wall time, and its parts: the host's bookkeeping with the
   launches made no-ops, the argument check, the probe kernels' device
   time; transitions and launches per call, state bytes), the host time
   of a scope marker with no probe, and the resolution of
   ``%globaltimer``;
9. serves tinyllama-1.1b at full width (8 x 512 prompt tokens, 32 new,
   the decode kernel) through two engines, one probed (``probe=True``,
   default targets, 16 probes, every (phase, shape) step in a
   ``ProbeSession``, published to a ``ControlPlane`` on port 0) and one
   not: after a warm-up run of each (the probed one captures its steps
   there), the checked runs must give 256/256 equal token ids with
   bitwise-equal first-step logits, flash and paged launches of 22 x
   the steps in both, equal phase steps, zero retraces, and request
   bills that sum to the phase totals (each decode round billed to all
   its riders); while the engine is live the status server's
   ``/status``, ``/probes``, ``/engine/phases`` (== ``phase_stats``) and
   ``/metrics`` are fetched. Prints the phase and request tables, each
   request's wall latency (submit to its ``request`` publish, host clock,
   by a bus subscriber) beside the batch wall, per step family the
   transitions, ``probe_events`` launches and dumps of a step, the
   host-device syncs in a step (``torch.cuda.set_sync_debug_mode``) with
   the session's host mirrors and with the device reads they replace,
   the capture time and ``state_nbytes``; then the batch walls in turns
   (median of 3): unprobed, probed, probed with those device reads, and
   probed with the spilled rows' copies made no-ops;
10. serves mamba2-370m at full width through the legacy loop profiled
   (``profile=True``, ``profile_every=8``: the decode loop under a
   ``ProbeSession``): the token ids must equal the unprofiled serve's of
   step 7, the prefill must make 48 SSD wrapper calls, and the final
   snapshot's calls per probe must equal the 31 steps x a one-shot
   probe's; the ``[probe]`` lines, the table and the bump chart are
   printed by ``serve``;
11. trains tinyllama-1.1b at full width and depth (22 layers, f32
   master params, bf16 compute, remat full; random weights from seed 0;
   B 8 x S 2048 tokens a step from the port's ``TokenPipeline``, seed 0)
   through ``build_train_step``: first the flash kernel at the training
   shape, its output and row statistics (m, l) against the plain version
   and the output with statistics bitwise the serving launch's, and the
   backward (``_flash_bwd``) from the kernel's forward against the same
   backward from the plain forward; then 1 warm-up and 2 timed steps
   (finite losses, flash launches == 2 x 22 x steps: forward and remat
   recompute; no paged or SSD launch), step wall, tokens/s, peak memory
   and model FLOP/s against the bf16 peak, a profiled step, the
   optimizer's time and its 2-D row scans' share; the step's forward and
   backward with the kernel forward against the same with the plain
   forward (loss, grad norm, every gradient leaf); the step on bf16
   master params (so AdamW scans no 2-D leaf by rows: their capture and
   oracle took minutes) unprobed and probed (model clock, every scope a
   probe): params, moments, loss and grad norm bitwise equal, record ==
   oracle, no write-guard copy, 44 flash launches, and probe paths and
   calls equal to the same step's probed on the CPU at smoke width with
   22 layers and the card's row and chunk plans (so the backward's
   ``~bwd`` and ``rematted_computation`` scopes reach the card's autograd
   thread), apart from the optimizer's scans over the leaves over 128
   MiB, which equal the reference rule's (five stacked leaves by layer);
   probed against unprobed walls, transitions and launches
   a step, the ``~bwd`` share of the model clock; then the trainer
   (``launch.train.train``, its ``--probe``: a ``ProbeSession``) for 1
   step, its ``[probe]`` lines and tables printed;
12. times each kernel (CUDA events, median) beside its plain version, a
   library call where one computes the same function (attention: SDPA
   under its flash backend), and its bound, at the main path's shapes:
   flash for the whole prefill and for a chunk (Sq=128 at q offset 384)
   and, with its statistics, at the training shape (B 8, S 2048),
   paged with all 8 rows at pos 543 and with random positions, the SSD
   scan at the mamba2-370m prefill shape, one probe transition (two
   events); and counts the tensor-core instructions (HMMA, HGMMA) in
   each library's SASS (cuobjdump): the flash and SSD kernels must have
   some.

13. grid-step probing (``ProbeConfig(kernel_probes=...)``): the
   tinyllama prefill (8 x 512) with ``flash_kernel`` probed (record ==
   oracle, logits bitwise, 22 flash and 22 ``probe_grid`` launches, grid
   calls 22 x 8 x 32 x 8 x 8, kernel-scope totals == grid totals; then
   every probe spilling at depth 256: ``kv_block``'s step cycles take two
   values, as many computed as the kernel's counts, and the grid keeps
   every step), probed against unprobed wall; the fold given a non-causal
   launch's counter block (record != oracle); the engine's chunked
   prefill step (128 rows at q offset 384) with the same checks; the
   mamba2 prefill (8 x 1024) with ``ssd_kernel`` (48 folds, grid calls 48
   x 8 x 32 x 4) and its wall; the engine's paged decode step at the
   serving shape with ``paged_kernel`` (record == oracle, outputs and
   pools bitwise); then the fold kernel's time beside its bound;
14. design-space exploration (``repro_torch.core.dse``): ``run_dse`` over
   the tinyllama prefill (8 x 512) at 3 storages x 4 offload ratios, each
   point's record == the oracle's and logits bitwise the unprobed ones,
   and its Pareto table; ``DSEEngine.tune`` (a fresh eval cache under
   build/) over flash at the training shape (B 8, S 2048), the model's
   prefill (B 8, S 512) and the engine's one-prompt prefill (B 1, S 512),
   paged at the engine's decode shape (8 rows at pos 543, bf16 queries),
   the SSD scan at one mamba2-370m layer (8 x 1024) and the engine's
   chunked-prefill quantum at 32 prompt pages: each flash and paged
   tile's declared shared memory == what the kernel's attributes report
   (for flash the C++ copy of the formula, the opt-in, with no static
   shared memory, and the driver's occupancy at least the CTAs an SM the
   tile is compiled for; for paged the compiler's static bytes), every
   tile the budget keeps held against its plain version at that tile (a
   tile it prunes refused by the kernel too), each chunk size's last
   logits within ``CHUNK_LOGIT_ATOL`` of the whole prompt's (and a
   changed context outside it), each measured candidate's probed
   ``%globaltimer`` ns a step beside its CUDA-event time and whether the
   two rank the candidates alike, flash at the training shape beside
   SDPA, then a warm re-run: 0 new measurements, the same winner; then
   ``serve --autotune`` from that cache beside the untuned serve: flash and
   paged launches 22 x steps, every one at the winner tuned at its own
   shape (the engine's prefill and decode), the ids shared (reported).
   The kernels line lists every (kernel, tile) pair checked.
15. the remaining model families (random weights from seed 0 in each
   config's ``param_dtype``): the flash kernel at head dim 80 at
   zamba2-2.7b's prefill (B 4, 32 q over 32 kv heads, S 512) against its
   plain version, rows at q offsets bitwise the whole call's, timed
   beside SDPA's flash backend with its bound, and its attributes; the
   SSD scan at one zamba2 layer (B 4, L 512, 80 heads of 64, N 64)
   against its plain version, timed with its bound; zamba2-2.7b at full
   width and depth served by the legacy loop (4 x 512 prompt tokens, 16
   new: flash 9 and SSD 54 wrapper calls a prefill, no paged launch),
   then a probed decode step (record == oracle, logits and caches bitwise
   the unprobed step's); granite-moe-1b-a400m at full width and depth
   through the engine (8 x 512, 32 new, the decode kernel: flash and
   paged launches 24 x steps; the capacity path's dropped assignments per
   layer; the legacy loop's ids beside the engine's, reported);
   musicgen-large at full width and depth and qwen2-vl-72b at full width
   with 2 of 80 layers (M-RoPE) through the legacy loop on synthetic
   frontend embeddings (flash 48 and 2 a prefill); arctic-480b at full
   width with 1 of 35 layers through the engine (4 x 512, 8 new,
   ``max_memory_allocated``); each of those kernel shapes held against
   its plain version and timed; then mamba2-370m trained at full width
   (B 8 x S 2048, 1 warm-up and 1 timed step: wall, tokens/s, peak
   memory, the optimizer's row scans, no kernel launch: training takes
   the plain SSD path), one step of bf16 master params (no row scans)
   probed (outputs bitwise the unprobed step's, record == oracle, paths
   and calls the CPU's at smoke
   width with 48 layers and the card's chunk plan, apart from the
   optimizer's scans over the leaves over 128 MiB, which equal the
   reference rule's). The kernels line gains one entry a (kernel, shape)
   of this step.
16. the conformance harness (``repro_torch.testing``) and the engine soak
   (``repro_torch.engine.soak``): ``run_conformance`` with all five
   invariants on the card for the fast corpus's kernel graphs, seeds 0,
   3, 4, 6 and 7 (kernel grid probing on), with the harness's flash and
   SSD launches counted; each graph's unprobed call launches its flash
   (seeds 0, 7) or SSD (3, 4, 6) block's kernel once and agrees with its
   plain twin (``build(plain=True)``) within ``GRAPH_RTOL``; then the
   soak at full width and depth tinyllama-1.1b (random weights from
   seed 0), decode kernel on, 3 waves x 8 requests, plain and then under
   pressure with chunks of 2 pages and every step probed: every soak
   assertion (zero retraces, all served, balanced pages, flat host
   memory, live tensors and device memory), flash launches == 22 x the
   prefill and chunk steps and paged == 22 x the decode rounds after
   warm-up, per wave pages, hit rate, evictions, memory and wall, and
   tokens/s; then the flash kernel at seed 0's padded shape, the SSD
   kernels at seed 6's and paged at the soak's decode shape against their
   plain versions, timed with their bounds. The kernels line gains those
   three entries.
17. mesh-aware probing over ``torch.distributed`` (``repro_torch.core.
   mesh_probe``, one rank a device): NCCL with more ranks than cards
   must raise (naming gloo); world 1 over NCCL in this process: the
   legacy serve of tinyllama-1.1b at full width with ``--mesh 1
   --profile`` (8 x 512, 16 new; ids == the unprofiled legacy serve's,
   flash 22, the session's calls == steps x one step's) and one
   full-width ``build_dp_train_step`` (B 4 x S 512, bf16 master params,
   so AdamW scans no row) under ``mesh_probe``: record == ``ShardOracle``
   exactly, outputs bitwise ``unprobed()``'s, ``grad_exchange``'s
   all-reduces at G 1 with 0 wire bytes, flash 44 (forward and remat
   recompute); world 2 over gloo, both ranks on this card
   (``launch.mesh.spawn``; a failed rank fails the step): which
   collectives gloo runs on the card's tensors, each kind in a world of
   its own so that a crash is reported (all-reduce, the DP step's one
   kind, asserted), the skew workload (record == oracle on every device,
   bitwise, 3-step session == 3 x one-shot, ``dynamic`` growing with the
   device), the DP step at smoke width with head dim 64 (the same checks,
   ``grad_exchange`` wire bytes > 0, flash 4 a rank in its probed call)
   and one all-reduce-mean of its gradients timed, then, in the same two
   ranks, the full-width mesh decode session (batch 8 split 4/4; ids ==
   the unprofiled serve's, flash 22 a rank). One ``mesh [...]`` line a
   run: world, backend, probes, per-device span and skew, comm cycles,
   probed and unprobed wall, capture seconds, flash launches. Then flash
   at the DP step's shape with statistics against plain (1e-2 of max
   |plain|; a dropped causal mask must fail it), timed beside SDPA with
   its bound: one more kernels-line entry.
18. logical-axis sharding over DTensor (``repro_torch.distributed.
   sharding``), world 1 over NCCL in this process, mesh ("data",
   "model") = (1, 1): (a) the ``TRAIN_RULES`` ``build_train_step`` on
   params placed by ``distribute_params`` against the unsharded step,
   tinyllama-1.1b full width, B 4 x S 512, bf16 master params, one
   warm-up each (loss, grad norm, params, mu, nu bitwise; flash 44; both
   walls, the aten ops a step through DTensor and their host cost);
   (b) ``remat="dots"`` against ``"full"``, the step's loss and
   gradients (bitwise, flash 44 each, the layers' unbatched products
   recomputed by full and none by dots, the memory held after the
   forward and the peak of each); (c) ``build_prefill_step`` + 16 steps
   of ``build_decode_step`` under ``SERVE_RULES``, 8 x 512 (ids == the
   unsharded legacy serve's, flash 22; ``prefill_microbatches`` 2 vs 1
   within the chunked-prefill limit); (d) granite-moe-1b-a400m full
   width, ``loss_fn`` through the sharded MoE (``shard_map``) against the
   local path, bitwise. (e), in spawned processes beside (b)-(d): a gloo
   world of 2 on this card, one DTensor ``Shard(0)`` -> ``Replicate``
   redistribute (an all-gather) of the card's tensors, reported; only if
   it runs, the smoke auto-sharded train step at (1, 2) (head dim 64)
   against the unsharded one (loss rel 2e-3). (f), after (a): minicpm-
   2b (36 of 48 q heads real, the pad heads zero) at full width and 2 of
   40 layers, B 4 x S 512, bf16 master params: the auto-sharded train
   step under ``TRAIN_RULES`` at (1, 1) against the unsharded step,
   bitwise (loss, grad norm, params, moments), flash 4 on both (AdamW's
   scan threshold raised for both, so the embedding is updated whole:
   (f) holds the step with whole-leaf AdamW only). (g), after (f): what a
   model rank runs for its own block of arctic-480b's padded q heads on
   the 16x16 mesh (4 of 64 a rank, B 2 x S 4096, head dim 128): the
   training flash with its VJP and the prefill's flash, for the block
   of heads 4-7 (kv heads 0, 1, 1, 1) against the unsharded path with
   the flash's plain version (FLASH_ATOL, BWD_RTOL), flash launched once
   each, and for a block of pad heads: zeros, no launch.
   One ``sharding [...]`` line a run. It launches flash at shapes the
   kernels line has, so it adds no entry.
19. the dry run and the roofline (``repro_torch.launch.{dryrun,
   hlo_cost, roofline}``): (a) six one-device cells at full width, bf16
   master params, mesh "1" (no process group): tinyllama-1.1b's train
   step (B 4 x S 512), prefill (8 x 512) and decode step (B 8 at cache
   544); mamba2-370m's train step at full depth (B 4 x S 512, the plain
   chunked SSD scan); zamba2-2.7b's at 12 of 54 layers (2 groups; B 2 x
   S 512, flash at head dim 80 through the shared attention); qwen2-vl-
   72b's at 1 of 80 layers in 2 microbatches (B 2 x S 512, the M-RoPE
   positions split on their batch dim, flash at head dim 128, int8
   moments). Each is traced by ``lower_cell`` on the meta device, then
   run on the card (``dryrun.build_cell``, random from seed 0) under the
   same counter (``hlo_cost.analyze``): FLOPs and bytes equal the meta
   record's exactly, no collective, flash launches 44, 22, 0, 0, 4 and 4
   (each the meta record's count of flash regions), the measured peak
   (``max_memory_allocated`` over the call, the arguments resident)
   within ``DRY_MEM_RTOL`` of ``peak_estimate_bytes``, and the roofline
   bound at most the measured wall (tinyllama's the median of 3 steps,
   the others' the warm-up step: AdamW's row scans of their embeddings
   or unembeddings take seconds); prints the roofline fraction and
   useful ratio, and for tinyllama's training ``_train_flops`` beside
   ``model_flops`` and the counted FLOPs. Flash at the two new training
   shapes is held against its plain version and timed (two kernels-line
   entries). (b) ``python -m repro_torch.launch.dryrun --arch A --shape
   S --mesh 16x16 --force`` (256 fake ranks, no card) for tinyllama's
   train_4k and six cells of the ssm, hybrid, int8-moment and M-RoPE
   archs (mamba2-370m and zamba2-2.7b train_4k and long_500k,
   arctic-480b and qwen2-vl-72b train_4k) and of the padded-head minicpm-
   2b (train_4k, prefill_32k), nine subprocesses started together at the
   start of step 19, beside (a): each rc 0 and a record with no error,
   its per-device FLOPs and peak within ``DRY_JAX_FACTOR`` (1.25) of
   JAX's (``JAX_16X16``: JAX's ``lower_cell`` of the same cell on a CPU
   host; mamba2's long_500k FLOPs at most JAX's); one ``dryrun [...]``
   line each with its per-device FLOPs, bytes, wire bytes by kind, peak
   GiB, both ratios to JAX's, dominant term and trace seconds.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits 1 before printing any result. The last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import urllib.request
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and dense bf16 tensor-core
# FLOP/s (the port's one definition, ``core.costmodel``), and f32 FLOP/s
# outside the tensor cores
from repro_torch.core.costmodel import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.core.costmodel import PEAK_FLOPS_BF16 as BF16_FLOPS  # noqa: E402
F32_FLOPS = 67e12
# spin of the timing hold, ~20 ms at the H100's ~1.98 GHz boost clock
HOLD_CYCLES = 40_000_000

# kernel vs plain version, bf16 outputs of |x| <~ 3: a few bf16 ulps
# (2^-8 relative), since both round p to bf16 after maxima and sums
# taken in different orders
FLASH_ATOL = 3e-2
# kernel vs the naive f32 oracle: bf16 rounding of p on top of that
FLASH_REF_ATOL = 6e-2
# paged kernel vs plain version, f32 outputs: summation order, and a
# rare bf16 flip of p / l (weights ~1/544 each)
PAGED_ATOL = 1e-3
# SSD kernels, relative to max |value|. Against their plain version on
# the same bf16 inputs: the plain version also rounds the decay, the
# decayed x and the chunk states to bf16, where the kernels keep them to
# f32 precision (the decayed x split into bf16 parts), a few bf16 ulps on
# y, and on the state about one bf16 rounding of the chunk states.
# Against the plain version (or the exact recurrence) on f32 copies of
# the same inputs: y is rounded once to bf16 (and L and prev once each,
# as the plain version rounds them), within one bf16 ulp of max |y|; the
# state is f32 on both sides, f32 summation order over up to 1024 steps.
SSD_RTOL = dict(y=2e-2, state=1e-2)
SSD_F32_RTOL = dict(y=8e-3, state=2e-5)

# the training phase, kernel statistics against the plain version: m is
# a maximum of f32 scores, the kernel's taken in log2 units and scaled
# back (a few f32 ulps of |m| <~ 10); l sums ~2048 exp terms in f32 in
# another order, with the MUFU exp2 (a few ulps each)
STATS_M_ATOL, STATS_L_RTOL = 1e-4, 1e-4
# the flash backward from the kernel's forward against the same backward
# from the plain forward, bf16 grads: the two forwards' outputs differ by
# a few bf16 ulps (FLASH_ATOL) and their m, l by the above, and the
# backward rounds p and ds to bf16: a few bf16 ulps (2^-8 relative each)
# of the largest |grad|
BWD_RTOL = 2e-2
# one forward and backward of the train step with the kernel forward
# against one with the plain forward (same params and batch): the two
# attention outputs differ by a few bf16 ulps in each of 22 layers. The
# limits are ~35x, 10x and 2x the card's readings at this step (loss
# 2.9e-6, grad norm 5.0e-4, the worst gradient leaf 9.3e-3 of its
# largest |value|, the embedding's; NVIDIA H100 80GB HBM3, 700 W). They
# hold the kernel's integration: a non-causal forward, an output 1 % off
# or row statistics off by 1 % or left in log2 units fail them. At random
# weights q.k is small and attention near uniform, so a softmax scale
# 10 % off moves the step by less than the bf16 noise: the train flash
# check (a), on unit-normal q, k, v, holds the scale.
STEP_LOSS_ATOL, STEP_GNORM_RTOL, STEP_GRAD_RTOL = 1e-4, 5e-3, 2e-2
# a chunked-prefill schedule against the whole-prompt prefill, last
# logits: each chunk's GEMMs run at another M, so every activation is
# rounded to bf16 in another order, as between the port's and the JAX
# package's bf16 logits (5e-2, PERF.md section 2); the card read 0 at
# chunks of 4-32 pages and 4.151e-2 at 1-2 pages (NVIDIA H100 80GB HBM3,
# 700 W). The check's teeth: another first half of the prompt (as a
# schedule that lost the context would see) moves the last logits by
# more, asserted on the card
CHUNK_LOGIT_ATOL = 5e-2
# two timed and two session steps: the whole script stays well inside its
# time limit
TRAIN_B, TRAIN_S, TRAIN_WARM, TRAIN_STEPS, SESSION_STEPS = 8, 2048, 1, 2, 1

ARCH, BATCH, PROMPT, MAX_NEW, CHUNK = "tinyllama-1.1b", 8, 512, 32, 8
WALL_TURNS = 3
SSM_ARCH, SSM_PROMPT = "mamba2-370m", 1024


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 30, warmup: int = 3, hold: bool = True) -> float:
    """Median device time of one call, CUDA events around each call,
    after warm-up. With ``hold`` the stream first spins for ~20 ms
    (``torch.cuda._sleep``) so that the host enqueues every call before
    the first runs, and the host's own cost per call stays out of the
    time; without it each call is timed alone, host in the loop, which
    adds the host's cost wherever it exceeds the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
        if not hold:
            e1.synchronize()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def host_us(fn, reps: int = 50, batches: int = 7) -> float:
    """Host time of one call (enqueue only: the stream is held, so no
    call waits for the device): the median over ``batches`` of the mean
    over ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(means)


def sass_counts(so) -> dict:
    """Tensor-core instructions in a built library's SASS."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    return {name: len(re.findall(rf"\b{name}\b", sass))
            for name in ("HMMA", "HGMMA", "LDSM", "LDGSTS")}


def sdpa_flash(torch, F, q, k, v, q_offset: int):
    """One SDPA call under its flash backend on the kernel's inputs: is
    causal (lower right when Sq < Skv, i.e. q rows at q_offset + i). GQA
    by ``enable_gqa``, or, if the backend refuses it, K/V expanded to the
    q heads outside the timed call. Returns (fn, how)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right
    Sq, Skv = q.shape[2], k.shape[2]
    assert q_offset == Skv - Sq

    def call(kk, vv, gqa):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            if Sq == Skv:
                return F.scaled_dot_product_attention(
                    q, kk, vv, is_causal=True, enable_gqa=gqa)
            return F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=causal_lower_right(Sq, Skv),
                enable_gqa=gqa)
    try:
        call(k, v, True)
        return (lambda: call(k, v, True)), "flash backend, enable_gqa"
    except RuntimeError:
        rep = q.shape[1] // k.shape[1]
        ke, ve = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        call(ke, ve, False)
        return ((lambda: call(ke, ve, False)),
                "flash backend, K/V expanded to the q heads")


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(torch, fa, flash_attention_ref, dev):
    """Serving shapes of one prefill: B=1, 32 q heads over 4 kv heads,
    head dim 64, S=512, bf16."""
    B, H, Hkv, S, D = 1, 32, 4, 512, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, probe = fa.flash_attention(q, k, v, with_probe=True)
    plain, probe_plain = fa.flash_attention_plain(q, k, v, with_probe=True)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    err_ref = (out.float() - flash_attention_ref(q, k, v).float()
               ).abs().max().item()
    print(f"flash (a) S=512: max |kernel - plain| {err:.3e} "
          f"(atol {FLASH_ATOL}), max |kernel - ref| {err_ref:.3e} "
          f"(atol {FLASH_REF_ATOL})")
    assert torch.isfinite(out.float()).all()
    assert err <= FLASH_ATOL and err_ref <= FLASH_REF_ATOL
    part = fa.flash_attention(q[:, :, 384:].contiguous(), k, v, q_offset=384)
    same = torch.equal(part, out[:, :, 384:])
    print(f"flash (b) Sq=128 at q_offset 384 == rows 384-511 bitwise: {same}")
    assert same
    same = torch.equal(probe, probe_plain)
    print(f"flash (c) probe counts == plain: {same} "
          f"(tile 7 visited/computed {probe[0, 0, 7].tolist()})")
    assert same
    pairs = S * (S + 1) // 2                       # visible (q, k) pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    # the chunked step: rows 384-511 against 512 keys
    qc = q[:, :, 384:].contiguous()
    c_pairs = sum(range(385, S + 1))
    c_bytes = 2 * (2 * qc.numel() + k.numel() + v.numel())
    return dict(inputs=(q, k, v), err=err,
                bound=bound(nbytes, 4.0 * B * H * D * pairs),
                chunk_inputs=(qc, k, v),
                chunk_bound=bound(c_bytes, 4.0 * B * H * D * c_pairs))


def check_paged(torch, pa, dev):
    """Serving shapes of one decode round: 8 rows, 4 kv heads x 8 q rows,
    head dim 64, pages of 16, 34 pages per row, a pool of 274 pages."""
    B, kv, g, hd, ps, npg, P = 8, 4, 8, 64, 16, 34, 274
    s_max = ps * npg
    gen = torch.Generator(device=dev).manual_seed(1)
    cpu = torch.Generator().manual_seed(1)
    q = torch.randn((B, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_k, pool_v = (torch.randn((P, ps, kv, hd), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
    pages = (torch.randperm(P - 1, generator=cpu)[:B * npg] + 1).reshape(
        B, npg).to(torch.int32)
    pos = torch.randint(0, s_max, (B,), generator=cpu, dtype=torch.int32)
    pos[0], pos[1] = 0, s_max - 1
    pages[B - 1], pos[B - 1] = 0, 0                # a padding lane
    pages, pos = pages.to(dev), pos.to(dev)
    out = pa.paged_attention(q, pool_k, pool_v, pages, pos)
    plain = pa.paged_attention_plain(q, pool_k, pool_v, pages, pos)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    print(f"paged: max |kernel - plain| {err:.3e} (atol {PAGED_ATOL})")
    assert torch.isfinite(out).all() and err <= PAGED_ATOL
    rows = all(torch.equal(pa.paged_attention(q[b:b + 1], pool_k, pool_v,
                                              pages[b:b + 1], pos[b:b + 1]),
                           out[b:b + 1]) for b in range(B))
    print(f"paged: row b of the B=8 call == B=1 call on row b bitwise: {rows}")
    assert rows
    perm = torch.randperm(P, generator=cpu).to(dev)
    moved_k, moved_v = torch.empty_like(pool_k), torch.empty_like(pool_v)
    moved_k[perm], moved_v[perm] = pool_k, pool_v
    moved = torch.equal(pa.paged_attention(
        q, moved_k, moved_v, perm[pages.long()].to(torch.int32), pos), out)
    print(f"paged: permuted pool placement gives a bitwise-equal output: "
          f"{moved}")
    assert moved
    # the serve's own shape: every row at its last decode position
    full = ((torch.randperm(P - 1, generator=cpu)[:B * npg] + 1).reshape(
        B, npg).to(torch.int32).to(dev),
        torch.full((B,), s_max - 1, dtype=torch.int32, device=dev))
    err_full = (pa.paged_attention(q, pool_k, pool_v, *full)
                - pa.paged_attention_plain(q, pool_k, pool_v, *full)
                ).abs().max().item()
    print(f"paged: all {B} rows at pos {s_max - 1}: max |kernel - plain| "
          f"{err_full:.3e} (atol {PAGED_ATOL})")
    assert err_full <= PAGED_ATOL
    # the counter block (slots read per row, kv head, tile) against the
    # plain version's, at both position sets; the output with it is the
    # output without it
    for what, args in (("mixed pos", (pages, pos)), ("serve pos", full)):
        o_c, got = pa._paged(q, pool_k, pool_v, *args, True)
        _, want = pa.paged_attention_plain(q, pool_k, pool_v, *args,
                                           with_counts=True)
        diff = (got.long() - want.long()).abs().max().item()
        same = torch.equal(o_c, pa.paged_attention(q, pool_k, pool_v, *args))
        print(f"paged counter block {tuple(got.shape)} at {what}: max "
              f"|kernel - plain| {diff} (exact), output bitwise the "
              f"uncounted one: {same}")
        assert diff == 0 and same

    def paged_bound(pos):
        visible = int((pos.long() + 1).clamp(max=s_max).sum())
        nbytes = (2 * q.numel() + 2 * 2 * visible * kv * hd
                  + 4 * pages.numel() + 4 * pos.numel() + 4 * out.numel())
        return bound(nbytes, 4.0 * kv * g * hd * visible)
    return dict(inputs=(q, pool_k, pool_v, pages, pos), err=max(err, err_full),
                bound=paged_bound(pos),
                serve_inputs=(q, pool_k, pool_v) + full,
                serve_bound=paged_bound(full[1]))


def ssd_inputs(torch, dev, B, L, H, P, G, N, seed):
    """Realistic SSD inputs: dt log-uniform in [1e-3, 1e-1] and A uniform
    in [1, 16] (the mamba2 inits), x = N(0, 1) dt and b, c = N(0, 1) in
    bf16, a = -A dt in f32; the model layout."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.exp(torch.empty((B, L, H), device=dev).uniform_(
        -6.9078, -2.3026, generator=gen))
    A = torch.empty((H,), device=dev).uniform_(1.0, 16.0, generator=gen)
    x = (torch.randn((B, L, H, P), generator=gen, device=dev)
         * dt[..., None]).to(torch.bfloat16)
    b, c = (torch.randn((B, L, G, N), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    return x, -A * dt, b, c


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_ssd_smem(torch, ssd):
    """The shared memory the SSD search space declares to the DSE budget
    (``ssd_scan.ssd_smem_bytes``) against the kernels' own formula
    (``ssd_scan_smem`` of the built library), for both dtypes, both
    state dims and chunks of 16 to 4096 steps."""
    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan", ssd._SIGNATURES)
    diff = [(dt, N, Q) for dt, code in ssd.DTYPES.items()
            for N in (64, 128, 32) for Q in (16, 64, 100, 256, 1024, 4096)
            if lib.ssd_scan_smem(code, N, Q) != ssd.ssd_smem_bytes(
                torch.empty((), dtype=dt).element_size(), N, Q)]
    print(f"ssd shared memory declared to the DSE budget == the kernels' "
          f"ssd_scan_smem: {not diff} ({diff or 'every case'})")
    assert not diff, diff


def check_ssd(torch, ssd, ssd_ref, dev):
    """The mamba2-370m prefill shape: B=8, L=1024, 32 heads of P=64, one
    group, N=128, chunk 256, bf16."""
    check_ssd_smem(torch, ssd)
    B, L, H, P, G, N, chunk = 8, 1024, 32, 64, 1, 128, 256
    x, a, b, c = ssd_inputs(torch, dev, B, L, H, P, G, N, seed=2)
    y, st = ssd.ssd_scan(x, a, b, c, chunk=chunk, h_per_g=H // G,
                         return_final_state=True)
    py, pst = ssd.ssd_scan_plain(x, a, b, c, chunk=chunk, h_per_g=H // G,
                                 return_final_state=True)
    fy, fst = ssd.ssd_scan_plain(x.float(), a, b.float(), c.float(),
                                 chunk=chunk, h_per_g=H // G,
                                 return_final_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    errs = dict(y=rel_err(y, py), state=rel_err(st, pst))
    f32 = dict(y=rel_err(y, fy), state=rel_err(st, fst))
    print(f"ssd (a) L=1024: max |kernel - plain| / max |plain|: y "
          f"{errs['y']:.3e}, state {errs['state']:.3e} (rtol {SSD_RTOL}); "
          f"vs plain on f32 copies: y {f32['y']:.3e}, state "
          f"{f32['state']:.3e} (rtol {SSD_F32_RTOL}); max |y| "
          f"{fy.abs().max().item():.3f}, max |state| "
          f"{fst.abs().max().item():.3f}")
    assert all(errs[k] <= SSD_RTOL[k] and f32[k] <= SSD_F32_RTOL[k]
               for k in errs)
    # the counter block (sub-chunks scanned per b, h, chunk) against the
    # plain version's; the output with it is the output without it
    y_c, st_c, got = ssd._ssd(x, a, b, c, chunk, chunk, H // G, 1, True,
                              True)
    _, want = ssd.ssd_scan_plain(x, a, b, c, chunk=chunk, h_per_g=H // G,
                                 with_counts=True)
    diff = (got.long() - want.long()).abs().max().item()
    same = torch.equal(y_c, y) and torch.equal(st_c, st)
    print(f"ssd counter block {tuple(got.shape)} at L={L}: max |kernel - "
          f"plain| {diff} (exact), y and state bitwise the uncounted ones: "
          f"{same}")
    assert diff == 0 and same

    x2, a2, b2, c2 = ssd_inputs(torch, dev, 2, 512, H, P, 2, N, seed=3)
    y2, st2 = ssd.ssd_scan(x2, a2, b2, c2, chunk=chunk, pipeline=2,
                           h_per_g=H // 2, return_final_state=True)
    fy2, fst2 = ssd.ssd_scan_plain(x2.float(), a2, b2.float(), c2.float(),
                                   chunk=chunk, pipeline=2, h_per_g=H // 2,
                                   return_final_state=True)
    e2 = dict(y=rel_err(y2, fy2), state=rel_err(st2, fst2))
    print(f"ssd (b) G=2, pipeline=2, L=512: vs plain on f32 copies: y "
          f"{e2['y']:.3e}, state {e2['state']:.3e}")
    assert all(e2[k] <= SSD_F32_RTOL[k] for k in e2)

    S = 300                       # padded to 512 with a=0, x=0, as ssm_apply
    x3, a3, b3, c3 = (t[:, :S] for t in (x, a, b, c))
    pad = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, 512 - S))
           for t in (x3, a3, b3, c3)]
    y3, st3 = ssd.ssd_scan(*pad, chunk=chunk, h_per_g=H // G,
                           return_final_state=True)
    ry, rst = ssd_ref(x3.permute(0, 2, 1, 3), a3.permute(0, 2, 1),
                      b3.permute(0, 2, 1, 3), c3.permute(0, 2, 1, 3))
    e3 = dict(y=rel_err(y3[:, :S], ry.permute(0, 2, 1, 3)),
              state=rel_err(st3, rst))
    print(f"ssd (c) S=300 padded to 512 vs the exact recurrence (ssd_ref): "
          f"y {e3['y']:.3e}, state {e3['state']:.3e}")
    assert all(e3[k] <= SSD_F32_RTOL[k] for k in e3)

    rows = True
    for bi in range(B):
        yb, sb = ssd.ssd_scan(x[bi:bi + 1], a[bi:bi + 1], b[bi:bi + 1],
                              c[bi:bi + 1], chunk=chunk, h_per_g=H // G,
                              return_final_state=True)
        rows &= torch.equal(yb, y[bi:bi + 1]) and torch.equal(sb, st[bi:bi + 1])
    print(f"ssd (d) row b of the B=8 call == B=1 call on row b bitwise "
          f"(y and state): {rows}")
    assert rows
    Q, nc = chunk, L // chunk
    tri = Q * (Q + 1) // 2                         # causal (q, k) pairs
    flops = 2.0 * (B * G * nc * tri * N          # c . b, once per group
                   + B * H * nc * tri * P        # (L * decay) x
                   + 2 * B * H * L * P * N)      # c . state, state update
    nbytes = (2 * (x.numel() + y.numel() + b.numel() + c.numel())
              + 4 * (a.numel() + st.numel()))
    return dict(inputs=(x, a, b, c), chunk=chunk, h_per_g=H // G,
                err=(y.float() - py.float()).abs().max().item(),
                bound=bound(nbytes, flops))


def serve_ssm(torch, counters, serve, ssd_kernels):
    """mamba2-370m at full width through serve(): one legacy prefill of
    48 SSD-kernel layers, then the recurrent decode in plain PyTorch."""
    L = 48
    serve(SSM_ARCH, smoke=False, batch=2, prompt_len=64, max_new=2)
    for fn in counters:
        fn.launches = 0
    res = serve(SSM_ARCH, smoke=False, batch=BATCH, prompt_len=SSM_PROMPT,
                max_new=MAX_NEW)
    torch.cuda.synchronize()
    got = tuple(fn.launches for fn in counters)
    V = 50280
    assert res.tokens.shape == (BATCH, MAX_NEW) and not res.stats
    assert ((res.tokens >= 0) & (res.tokens < V)).all()
    assert torch.isfinite(res.first_logits[:, :V]).all()
    per_call = len(ssd_kernels)
    print(f"serve [{SSM_ARCH}]: {res.seconds * 1e3:.1f} ms, "
          f"{BATCH * MAX_NEW / res.seconds:.1f} tokens/s; 1 prefill step of "
          f"{BATCH} x {SSM_PROMPT}, {MAX_NEW - 1} decode steps; launches "
          f"flash, paged, ssd {got} (want (0, 0, {L})); SSD kernel launches "
          f"{per_call} x {got[2]} = {per_call * got[2]} "
          f"({', '.join(ssd_kernels)})")
    assert got == (0, 0, L)
    return got[2], res


def ssm_consistency(torch, dev):
    """prefill(S) + decode(1) against prefill(S + 1), bf16 on the card,
    the counterpart of tests/test_models.py's check; printed, not
    asserted (bf16 rounds every activation in another order on each
    side)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    m = Model(get_config(SSM_ARCH))
    p = m._compute_cast(m.init(0, dev))
    S, V = SSM_PROMPT, m.cfg.vocab_size
    toks = torch.randint(0, V, (2, S + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    _, cache = m.prefill(p, {"tokens": toks[:, :S]}, S + 1)
    dl, _, _ = m.decode_step(p, cache, {"tokens": toks[:, S:], "pos": S})
    pl, _ = m.prefill(p, {"tokens": toks}, S + 1)
    err = rel_err(dl[:, :V], pl[:, :V])
    same = (dl[:, :V].argmax(-1) == pl[:, :V].argmax(-1)).tolist()
    print(f"{SSM_ARCH} prefill({S}) + decode(1) vs prefill({S + 1}), bf16: "
          f"max |diff| / max |logit| {err:.3e}; same argmax {same}")


def walls_ms(torch, fns: dict, reps: int = 9, warm: bool = True) -> dict:
    """Median wall time (ms) of one call of each function, host in the
    loop, device synced after each call; the functions take turns, so
    that a slow spell of the shared host falls on all of them. ``warm``
    calls each once first (off where the caller just ran them)."""
    ts = {k: [] for k in fns}
    if warm:
        for k, fn in fns.items():
            fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) * 1e3 for k, v in ts.items()}


def _flat(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _parent(paths, i):
    """Index of the nearest probed ancestor of probe i, or None."""
    p = paths[i]
    while "/" in p:
        p = p.rsplit("/", 1)[0]
        if p in paths:
            return paths.index(p)
    return None


def check_probe_events(torch, kpe, dev):
    """The probe-events kernel against its plain version (run on copies
    of the same state on the card) over 60 random transitions, model
    clock, two of five probes spilling: integer equality."""
    import random
    rnd = random.Random(5)
    n, depth = 5, 3
    spill = (False, True, False, True, False)
    ks = {k: torch.zeros(sh, dtype=torch.int64, device=dev) for k, sh in
          (("cycle", ()), ("cnt", (3, n)), ("calls", (n,)),
           ("ring", (n, depth, 2)))}
    ps = {k: v.clone() for k, v in ks.items()}
    open_ = set()
    for _ in range(60):
        exits = sorted(p for p in open_ if rnd.random() < 0.5)
        enters = sorted(p for p in set(range(n)) - open_ - set(exits)
                        if rnd.random() < 0.5)
        open_ = (open_ - set(exits)) | set(enters)
        codes = ([kpe.encode(p, False, spill[p]) for p in exits]
                 + [kpe.encode(p, True, spill[p]) for p in enters])
        seg = rnd.randrange(1 << 40)
        kpe.probe_events(ks, codes, seg)
        kpe.probe_events_plain(ps, codes, seg)
    torch.cuda.synchronize()
    err = max((ks[k] - ps[k]).abs().max().item() for k in ks)
    print(f"probe_events: 60 transitions, kernel == plain (int64): "
          f"{err == 0} (max |diff| {err})")
    assert err == 0
    # one typical transition: exit a probe, enter its sibling
    codes = [kpe.encode(0, False, False), kpe.encode(2, True, False)]
    nbytes = 2 * 8 + len(codes) * 6 * 8     # clock, then per event
    return dict(state=ks, codes=codes, err=err, bound=bound(nbytes, 0.0))


def _record_equals_oracle(dec, oc) -> bool:
    n = len(oc.calls)
    return (dec["cycle"] == oc.cycle and all(
        int(dec[k][i]) == getattr(oc, k)[i]
        for k in ("starts", "ends", "totals", "calls") for i in range(n))
        and all([tuple(r) for r in dec["ring"][i].tolist()] == oc.ring[i]
                for i in range(n)))


def probe_program(torch, name, fn, make, counters, want, kpe):
    """Probe one full-width program in both cycle sources; returns the
    numbers the report prints."""
    from repro_torch.core import ProbeConfig, decode_record, probe
    cfg = ProbeConfig(inline="off_all", max_probes=64)
    pf = probe(fn, cfg)
    t0 = time.perf_counter()
    pf.ensure_built(*make())
    capture_s = time.perf_counter() - t0
    plain = _flat(fn(*make()))
    args = make()
    for c in counters.values():
        c.launches = 0
    kpe.probe_events.launches = 0
    out, rec = pf(*args)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    pe_launches = kpe.probe_events.launches
    same = all(torch.equal(a, b) for a, b in zip(_flat(out), plain))
    dec = decode_record(rec)
    oc = pf.oracle(*make())
    exact = _record_equals_oracle(dec, oc)
    stats = pf.last_run
    print(f"probe [{name}] model clock: {len(pf.probe_paths())} probes, "
          f"capture {capture_s * 1e3:.0f} ms; record == oracle: {exact}; "
          f"outputs bitwise == unprobed: {same}; launches {got} (want "
          f"{want}); {stats['transitions']} transitions, "
          f"{stats['launches']} probe_events launches "
          f"(counter {pe_launches}); state {pf.resource_bytes()} bytes; "
          f"span {dec['cycle']} cycles")
    assert exact and same and got == want
    assert pe_launches == stats["launches"]
    for line in pf.report(rec).table().splitlines()[:14]:
        print(f"  {line}")

    pw = probe(fn, cfg.replace(cycle_source="wallclock"))
    pw.ensure_built(*make())
    _, wrec = pw(*make())
    wd = decode_record(wrec)
    assert pw.probe_paths() == pf.probe_paths()
    calls_ok = [int(c) for c in wd["calls"]] == oc.calls
    paths = list(pw.probe_paths())
    nested = True
    for i in range(len(paths)):
        kept = min(int(wd["calls"][i]), cfg.buffer_depth)
        ring = wd["ring"][i][:kept]
        nested &= bool((ring[:, 0] <= ring[:, 1]).all())
        nested &= bool(wd["starts"][i] <= wd["ends"][i])
        par = _parent(paths, i)
        if par is None:
            continue
        pr = wd["ring"][par][:min(int(wd["calls"][par]), cfg.buffer_depth)]
        nested &= all(((pr[:, 0] <= s) & (e <= pr[:, 1])).any()
                      for s, e in ring)
    totals = {p: int(t) for p, t in zip(paths, wd["totals"])}
    calls = {p: int(c) for p, c in zip(paths, wd["calls"])}
    print(f"probe [{name}] wallclock: calls == oracle: {calls_ok}; ring "
          f"intervals inside their parents', start <= end: {nested}")
    assert calls_ok and nested
    rows = sorted(paths, key=lambda p: -totals[p])[:8]
    for p in rows:
        print(f"  {p:<40} {calls[p]:>4} calls {totals[p] / 1e3:>10.1f} us "
              f"({totals[p] / 1e3 / max(calls[p], 1):.1f} us a call)")
    launcher = kpe.Launcher.__call__

    def no_launch():            # the host's bookkeeping alone
        kpe.Launcher.__call__ = lambda self, codes, seg=0, wallclock=0: None
        try:
            pf(*args)
        finally:
            kpe.Launcher.__call__ = launcher
    w = walls_ms(torch, dict(unprobed=lambda: fn(*args),
                             model=lambda: pf(*args),
                             wallclock=lambda: pw(*args),
                             no_launch=no_launch,
                             ensure_built=lambda: pf.ensure_built(*args)))
    print(f"probe [{name}] wall per call (median of 9, in turns): unprobed "
          f"{w['unprobed']:.2f} ms, probed (model clock) {w['model']:.2f} "
          f"ms, probed (wallclock) {w['wallclock']:.2f} ms; probed with the "
          f"probe_events launches made no-ops {w['no_launch']:.2f} ms; "
          f"ensure_built alone {w['ensure_built']:.3f} ms")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pf(*args)
        torch.cuda.synchronize()
    pe = [e for e in prof.key_averages() if "probe_events" in e.key]
    dev_us = sum(getattr(e, "device_time_total", 0) for e in pe)
    print(f"probe [{name}] probe_events kernels under torch.profiler: "
          f"{sum(e.count for e in pe)}, {dev_us:.1f} us of device time")
    return dict(launches=pe_launches, wall=totals, calls=calls)


def probe_phase(torch, fa, ssd, kpe, dev):
    """The probe core over the full-width serving programs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import scope
    from repro_torch.models import Model
    counters = dict(flash=fa.flash_attention, ssd=ssd.ssd_scan)
    gen = torch.Generator(device=dev).manual_seed(6)

    m = Model(get_config(ARCH))
    p = m._compute_cast(m.init(0, dev))
    V, cache_len = m.cfg.vocab_size, PROMPT + MAX_NEW
    toks = torch.randint(0, V, (BATCH, PROMPT), device=dev, generator=gen,
                         dtype=torch.int32)
    res = probe_program(
        torch, f"{ARCH} prefill {BATCH}x{PROMPT}",
        lambda p_, b: m.prefill(p_, b, cache_len),
        lambda: (p, {"tokens": toks}), counters, dict(flash=22, ssd=0), kpe)
    _, cache = m.prefill(p, {"tokens": toks}, cache_len)
    step = {"tokens": toks[:, -1:], "pos": PROMPT}
    probe_program(
        torch, f"{ARCH} decode_step at pos {PROMPT}", m.decode_step,
        lambda: (p, {k: v.clone() for k, v in cache.items()}, step),
        counters, dict(flash=0, ssd=0), kpe)
    del m, p, cache

    m = Model(get_config(SSM_ARCH))
    p = m._compute_cast(m.init(0, dev))
    toks = torch.randint(0, m.cfg.vocab_size, (BATCH, SSM_PROMPT),
                         device=dev, generator=gen, dtype=torch.int32)
    sres = probe_program(
        torch, f"{SSM_ARCH} prefill {BATCH}x{SSM_PROMPT}",
        lambda p_, b: m.prefill(p_, b, SSM_PROMPT + MAX_NEW),
        lambda: (p, {"tokens": toks}), counters, dict(flash=0, ssd=48), kpe)
    del m, p

    steps = kpe.globaltimer_steps(dev)
    nz = steps[steps > 0]
    print(f"%globaltimer steps seen by one spinning thread: min "
          f"{int(nz.min())} ns, median {int(nz.median())} ns, max "
          f"{int(nz.max())} ns over {nz.numel()} steps")
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with scope.named_scope("x"):
            pass
    marker_ns = (time.perf_counter() - t0) / n * 1e9
    print(f"host time of one named_scope enter + exit with no probe: "
          f"{marker_ns:.0f} ns")
    return dict(launches=res["launches"], flash_wall=res["wall"],
                flash_calls=res["calls"], ssd_wall=sres["wall"],
                ssd_calls=sres["calls"])


def kernel_probed(torch, name, fn, make, kernels, launches, counters, kpe,
                  cfg, grid_calls, twin=None):
    """One program probed with ``cfg`` (kernel probes on): the record
    equals the oracle integer for integer, the outputs equal the unprobed
    ones bitwise (``twin`` makes the unprobed call's arguments when the
    program writes its inputs), each kernel and the fold launch
    ``launches`` times, the grid probes' calls are ``grid_calls``,
    kernel-scope totals equal grid totals. Returns (pf, record, report,
    numbers)."""
    from repro_torch.core import decode_record, probe
    pf = probe(fn, cfg)
    t0 = time.perf_counter()
    pf.ensure_built(*make())
    capture_s = time.perf_counter() - t0
    args = make()
    want = _flat(fn(*(twin() if twin else make())))
    for c in counters.values():
        c.launches = 0
    kpe.probe_grid.launches = 0
    out, rec = pf(*args)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    folds = kpe.probe_grid.launches
    same = all(torch.equal(a, b) for a, b in zip(_flat(out), want))
    dec = decode_record(rec)
    t0 = time.perf_counter()
    oc = pf.oracle(*make())
    oracle_s = time.perf_counter() - t0
    exact = _record_equals_oracle(dec, oc)
    paths = list(pf.probe_paths())
    grids = [i for i, p in enumerate(paths) if p.endswith("/grid")]
    calls = [int(dec["calls"][i]) for i in grids]
    sums = all(int(dec["totals"][i]) == int(dec["totals"][paths.index(
        paths[i].rsplit("/", 1)[0])]) for i in grids)
    rep = pf.report(rec)
    print(f"kernel probe [{name}]: {len(paths)} probes, capture "
          f"{capture_s * 1e3:.0f} ms, oracle {oracle_s:.1f} s; record == "
          f"oracle: {exact}; outputs bitwise == unprobed: {same}; kernel "
          f"launches {got}, probe_grid launches {folds} (want {launches} "
          f"each); grid calls {calls} (want [{grid_calls}]); kernel-scope "
          f"totals == grid totals: {sums}; {pf.last_run}")
    assert exact and same and sums and grids
    assert folds == launches == pf.last_run["folds"]
    assert all(got[k] == launches for k in kernels), got
    assert calls == [grid_calls], calls
    return pf, rec, rep, dict(folds=folds, dec=dec, oc=oc, args=args)


def _skew(torch, name, rep, path, counts, n_calls):
    """The causal skew in the device record: ``kv_block``'s step
    durations take two values (computed, skipped), as many computed as
    the kernel's computed counts say, and the grid's recorded steps are
    every step and sum to its total."""
    kv = rep.row(path + "/kv_block")
    grid = rep.row(path)
    durs = [e - s for s, e in kv.iters]
    gd = [e - s for s, e in grid.iters]
    values = sorted(set(durs))
    computed = n_calls * int(counts[..., 1].sum())
    ok = (len(values) == 2 and durs.count(values[1]) == computed
          and len(gd) == grid.calls and sum(gd) == grid.total_cycles
          and max(gd) > min(gd))
    print(f"kernel probe [{name}] causal skew in the device record: "
          f"kv_block step cycles {values} (skipped, computed), "
          f"{durs.count(values[-1])} computed steps (the kernel's counts: "
          f"{computed}); grid steps recorded {len(gd)}/{grid.calls}, "
          f"cycles {min(gd)}..{max(gd)}, sum == total: "
          f"{sum(gd) == grid.total_cycles}")
    assert ok


def kernel_probe_phase(torch, fa, pa, ssd, kpe, dev, smi):
    """Grid-step probing (``ProbeConfig(kernel_probes=...)``) over the
    full-width main paths: (a) the tinyllama prefill, (b) a chunked
    prefill step at q offset 384, (c) the mamba2 prefill, (d) a paged
    decode step, (e) a foreign counter block caught. Returns the fold
    kernel's line numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ProbeConfig, decode_record, probe, scope
    from repro_torch.core import kernel_grid_heat, kernel_grid_table
    from repro_torch.engine import build_chunk_prefill, build_paged_decode
    from repro_torch.models import Model
    counters = dict(flash=fa.flash_attention, paged=pa.paged_attention,
                    ssd=ssd.ssd_scan)
    gen = torch.Generator(device=dev).manual_seed(8)
    base = ProbeConfig(inline="off_all", max_probes=64, buffer_depth=4)
    print(f"# grid-step probing ({smi})")
    folds = 0

    # (a) the tinyllama prefill, 8 x 512
    m = Model(get_config(ARCH))
    p = m._compute_cast(m.init(0, dev))
    cfg = m.cfg
    L, H, Hkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    cache_len = PROMPT + MAX_NEW
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                         generator=gen, dtype=torch.int32)

    def prefill(p_, b):
        return m.prefill(p_, b, cache_len)
    fcfg = base.replace(kernel_probes=("flash_kernel",))
    nq = -(-PROMPT // fa.BLOCK_Q)
    steps = BATCH * H * nq * nq
    pf, rec, rep, a = kernel_probed(
        torch, f"{ARCH} prefill {BATCH}x{PROMPT}", prefill,
        lambda: (p, {"tokens": toks}), ("flash",), L,
        dict(flash=fa.flash_attention), kpe, fcfg, L * steps)
    folds += a["folds"]
    kpath = next(q for q in pf.probe_paths() if q.endswith("/grid"))
    print(kernel_grid_table(pf.hierarchy, rep))
    qz = torch.zeros((BATCH, H, PROMPT, hd), dtype=torch.bfloat16, device=dev)
    kz = torch.zeros((BATCH, Hkv, PROMPT, hd), dtype=torch.bfloat16,
                     device=dev)
    _, counts = fa.flash_attention(qz, kz, kz, with_probe=True)
    spf, _, srep, sa = kernel_probed(
        torch, f"{ARCH} prefill {BATCH}x{PROMPT}, every probe spilling at "
        f"depth 256", prefill, lambda: (p, {"tokens": toks}), ("flash",), L,
        dict(flash=fa.flash_attention), kpe,
        fcfg.replace(offload=1.0, buffer_depth=256), L * steps)
    folds += sa["folds"]
    _skew(torch, "prefill", srep, kpath, counts.cpu(), L)
    print("\n".join(kernel_grid_heat(spf.hierarchy, srep).splitlines()[:9]))
    print(f"  spilled rows {spf.sink.dumps}, fold dumps included; report "
          f"history of every spilled probe == the oracle's: "
          f"{all(r.iters == sa['oc'].history[i] for i, r in enumerate(srep.rows) if spf.assignment.spill[i])}")
    del spf, srep, sa
    w = walls_ms(torch, dict(unprobed=lambda: prefill(p, {"tokens": toks}),
                             probed=lambda: pf(p, {"tokens": toks})), reps=5)
    print(f"kernel probe [prefill] wall per call (median of 5, in turns): "
          f"unprobed {w['unprobed']:.2f} ms, probed with kernel probes "
          f"{w['probed']:.2f} ms ({100 * (w['probed'] / w['unprobed'] - 1):+.0f}"
          f" %) ({smi})")
    walls = dict(prefill=w)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pf(p, {"tokens": toks})
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "probe_grid" in e.key]
    print(f"kernel probe [prefill] probe_grid kernels under torch.profiler: "
          f"{sum(e.count for e in ev)}, "
          f"{sum(getattr(e, 'device_time_total', 0) for e in ev):.1f} us of "
          f"device time")

    # (e) a foreign counter block: the causal plan folded with the counts
    # of a non-causal launch
    q1 = torch.randn((BATCH, H, PROMPT, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    k1, v1 = (torch.randn((BATCH, Hkv, PROMPT, hd), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))

    def teeth(q, k, v):
        with scope.named_scope("attn"):
            with scope.kernel_region(
                    "flash_attention", lambda: fa.flash_cost(q, k, v),
                    lambda: fa.flash_plan(q, k, v)) as region:
                out = fa.flash_attention(q, k, v)
                _, wrong = fa.flash_attention(q, k, v, causal=False,
                                              with_probe=True)
                region.fold(wrong)
            return out
    tpf = probe(teeth, base.replace(kernel_probes=("*",)))
    _, trec = tpf(q1, k1, v1)
    tdec = decode_record(trec)
    toc = tpf.oracle(q1, k1, v1)
    caught = not _record_equals_oracle(tdec, toc)
    print(f"kernel probe [teeth]: the fold given a non-causal launch's "
          f"counter block: record != oracle: {caught} (clock {tdec['cycle']}"
          f" against the oracle's {toc.cycle})")
    assert caught

    # (b) a chunked prefill step: 128 rows at q offset 384 (24 context
    # pages of 16, a chunk of 8), against a pool of random K/V
    ps, ctx, chunk = 16, 24, 8
    pool_shape = (L, ctx + 2, ps, Hkv, hd)
    pools = [torch.randn(pool_shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    cstep = build_chunk_prefill(m, ctx, chunk, ps)
    cb = {"tokens": toks[:1, :chunk * ps],
          "ctx_pages": torch.arange(1, ctx + 1, device=dev,
                                    dtype=torch.int32),
          "last_idx": torch.tensor([chunk * ps - 1], device=dev,
                                   dtype=torch.int32)}
    csteps = H * 2 * (ctx + chunk) * ps // fa.BLOCK_K
    cpf, _, crep, ca = kernel_probed(
        torch, "chunked prefill 128 rows at q offset 384", cstep,
        lambda: (p, pools[0], pools[1], cb), ("flash",), L,
        dict(flash=fa.flash_attention), kpe,
        fcfg.replace(offload=1.0, buffer_depth=64), L * csteps)
    folds += ca["folds"]
    qc = torch.zeros((1, H, chunk * ps, hd), dtype=torch.bfloat16,
                     device=dev)
    kc = torch.zeros((1, Hkv, (ctx + chunk) * ps, hd), dtype=torch.bfloat16,
                     device=dev)
    _, ccounts = fa.flash_attention(qc, kc, kc, q_offset=ctx * ps,
                                    with_probe=True)
    ckpath = next(q for q in cpf.probe_paths() if q.endswith("/grid"))
    _skew(torch, "chunk", crep, ckpath, ccounts.cpu(), L)
    del cpf, crep, ca, pools, m, p, pf, rec, rep
    torch.cuda.empty_cache()

    # (c) the mamba2 prefill, 8 x 1024
    m = Model(get_config(SSM_ARCH))
    p = m._compute_cast(m.init(0, dev))
    stoks = torch.randint(0, m.cfg.vocab_size, (BATCH, SSM_PROMPT),
                          device=dev, generator=gen, dtype=torch.int32)
    from repro_torch.models.ssm import ssm_dims
    sd = ssm_dims(m.cfg)
    ssteps = BATCH * sd["heads"] * (SSM_PROMPT // min(sd["chunk"], SSM_PROMPT))

    def sprefill(p_, b):
        return m.prefill(p_, b, SSM_PROMPT + MAX_NEW)
    spf, _, _, sa = kernel_probed(
        torch, f"{SSM_ARCH} prefill {BATCH}x{SSM_PROMPT}", sprefill,
        lambda: (p, {"tokens": stoks}), ("ssd",), m.cfg.num_layers,
        dict(ssd=ssd.ssd_scan), kpe,
        base.replace(kernel_probes=("ssd_kernel",)), m.cfg.num_layers * ssteps)
    folds += sa["folds"]
    w = walls_ms(torch, dict(unprobed=lambda: sprefill(p, {"tokens": stoks}),
                             probed=lambda: spf(p, {"tokens": stoks})),
                 reps=5)
    print(f"kernel probe [mamba2 prefill] wall per call (median of 5, in "
          f"turns): unprobed {w['unprobed']:.2f} ms, probed with kernel "
          f"probes {w['probed']:.2f} ms "
          f"({100 * (w['probed'] / w['unprobed'] - 1):+.0f} %) ({smi})")
    walls["ssm_prefill"] = w
    del spf, sa, m, p
    torch.cuda.empty_cache()

    # (d) a paged decode step of the engine at the serving shape: 8 rows
    # near the end of 34 pages of 16, pool of 274 pages, positions given
    # as host ints
    m = Model(get_config(ARCH))
    p = m._compute_cast(m.init(0, dev))
    n_pages, P = 34, 274
    dshape = (L, P, ps, Hkv, hd)
    dpools = [torch.randn(dshape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    twins = [t.clone() for t in dpools]
    pages = (torch.randperm(P - 1, generator=gen, device=dev)[
        :BATCH * n_pages] + 1).to(torch.int32).reshape(BATCH, n_pages)
    pos = [PROMPT + 31 - 3 * i for i in range(BATCH)]
    dstep = build_paged_decode(m, BATCH, n_pages, ps, use_kernel=True)
    db = {"tokens": toks[:, -1:], "pages": pages,
          "pos": torch.tensor(pos, dtype=torch.int32, device=dev),
          "pos_host": tuple(pos)}
    dpf, _, _, da = kernel_probed(
        torch, f"{ARCH} paged decode {BATCH} rows at pos {pos[-1]}..{pos[0]}",
        dstep, lambda: (p, dpools[0], dpools[1], db), ("paged",), L,
        dict(paged=pa.paged_attention), kpe,
        base.replace(kernel_probes=("paged_kernel",)),
        L * BATCH * n_pages, twin=lambda: (p, twins[0], twins[1], db))
    folds += da["folds"]
    same_pools = all(torch.equal(a_, b_) for a_, b_ in zip(dpools, twins))
    print(f"kernel probe [decode]: pools after the probed and the unprobed "
          f"step bitwise equal: {same_pools}")
    assert same_pools
    del dpf, da, dpools, twins, m, p
    torch.cuda.empty_cache()
    return dict(folds=folds, walls=walls)


def serve_runs(torch, fa, pa, ssd, serve):
    """Full-width serving through the port's entry point. Returns the
    launch counts of the main path (whole prefill + decode kernel)."""
    L = 22
    t0 = time.perf_counter()
    serve(ARCH, smoke=False, batch=2, prompt_len=32, max_new=2,
          engine_kernel=True)
    print(f"warm-up serve (2 x 32 tokens): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms incl. weight init")
    runs = {}
    for name, kw in (("kernel", dict(engine_kernel=True)),
                     ("chunked", dict(engine_kernel=True,
                                      prefill_chunk=CHUNK)),
                     ("dense", dict(engine_kernel=False)),
                     ("legacy", dict(engine=False))):
        fa.flash_attention.launches = 0
        pa.paged_attention.launches = 0
        ssd.ssd_scan.launches = 0
        res = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                    max_new=MAX_NEW, **kw)
        torch.cuda.synchronize()
        flash, paged = fa.flash_attention.launches, pa.paged_attention.launches
        assert res.tokens.shape == (BATCH, MAX_NEW)
        assert ((res.tokens >= 0) & (res.tokens < 32000)).all()
        assert torch.isfinite(res.first_logits[:, :32000]).all()
        if res.stats:
            ph = res.stats["phases"]
            prefill = ph["prefill"]["steps"] + ph.get("chunkpf",
                                                      {"steps": 0})["steps"]
            decode = ph["decode"]["steps"]
            want = (L * prefill, L * decode if kw["engine_kernel"] else 0)
            assert res.stats["retraces"] == 0
        else:
            prefill, decode = 1, MAX_NEW - 1
            want = (L, 0)
        print(f"serve [{name}]: {res.seconds * 1e3:.1f} ms, "
              f"{BATCH * MAX_NEW / res.seconds:.1f} tokens/s; "
              f"{prefill} prefill steps, {decode} decode rounds; launches "
              f"flash {flash}, paged {paged} (want {want[0]}, {want[1]})")
        assert (flash, paged) == want and ssd.ssd_scan.launches == 0
        runs[name] = (res, flash, paged)
    base = runs["kernel"][0]
    for name in ("chunked", "dense", "legacy"):
        res = runs[name][0]
        same = int((res.tokens == base.tokens).sum())
        dl = (res.first_logits - base.first_logits).abs().max().item()
        print(f"token ids shared with [kernel]: [{name}] {same}/"
              f"{base.tokens.size}; first-step max |logit diff| {dl:.3e}")
    return runs["kernel"][1], runs["kernel"][2]


@contextlib.contextmanager
def session_device_reads():
    """Run probe sessions as the parent tree did: the call counts read
    from the device at every call and ``clock()`` read from the device
    (the values are the host mirrors', so the bills are unchanged)."""
    from repro_torch.core.instrument import state_clock
    from repro_torch.core.pragma import ProbedFunction
    from repro_torch.core.streaming import ProbeSession
    run, clock = ProbedFunction._run, ProbeSession.clock

    def read_run(self, state, args, kwargs, calls=None):
        if any(self.assignment.spill):
            state["calls"].cpu()
        return run(self, state, args, kwargs, calls=calls)
    ProbedFunction._run = read_run
    ProbeSession.clock = lambda self: (state_clock(self._state)
                                       if self._state is not None else 0)
    try:
        yield
    finally:
        ProbedFunction._run, ProbeSession.clock = run, clock


@contextlib.contextmanager
def no_spill_copies():
    """Run probe sessions with the spilled rows' copies made no-ops (the
    rings still fill; the sinks get nothing): the host cost of the
    offload, by difference."""
    from repro_torch.core.instrument import Runner
    dump = Runner._dump
    Runner._dump = lambda self, pid, base: None
    try:
        yield
    finally:
        Runner._dump = dump


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def probed_engine_phase(torch, fa, pa, kpe, dev):
    """tinyllama-1.1b at full width through a probed engine and an
    unprobed one (see the module docstring, step 9). Returns the
    probe_events launches of the checked probed run."""
    from collections import defaultdict
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models import Model
    from repro_torch.telemetry import ControlPlane, TelemetryBus
    m = Model(get_config(ARCH))
    L = m.cfg.num_layers
    params = m.init(0, dev)
    V = m.cfg.vocab_size
    prompts = torch.randint(0, V, (BATCH, PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).numpy()
    pages = -(-(PROMPT + MAX_NEW - 1) // 16)
    ecfg = dict(page_size=16, pool_pages=BATCH * pages + 2, max_pages=pages,
                buckets=(1, BATCH), use_kernel=True)
    plane = ControlPlane(0).start()
    buses = {"plain": TelemetryBus(), "probed": plane.bus}
    engines = {name: InferenceEngine(
        m, params, EngineConfig(**ecfg, probe=name == "probed"),
        bus=buses[name]) for name in buses}
    done_at = {name: [] for name in buses}
    for name, bus in buses.items():
        bus.subscribe("request", lambda info, name=name: done_at[name].append(
            (info["rid"], time.perf_counter())))

    def serve_once(name):
        eng = engines[name]
        done_at[name].clear()
        before = {k: dict(v) for k, v in eng.phase_stats.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for row in prompts:
            eng.submit(row.tolist(), MAX_NEW)
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lat = {rid: t - t0 for rid, t in done_at[name]}
        delta = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
                 for k, v in eng.phase_stats.items()}
        eng.drain()
        return done, wall, [lat[r.rid] for r in done], delta

    for name in engines:                     # warm-up; the probed engine
        serve_once(name)                     # captures its steps here
    checked = {}
    for name in engines:
        fa.flash_attention.launches = 0
        pa.paged_attention.launches = 0
        kpe.probe_events.launches = 0
        done, wall, lat, delta = serve_once(name)
        checked[name] = dict(done=done, wall=wall, lat=lat, delta=delta,
                             flash=fa.flash_attention.launches,
                             paged=pa.paged_attention.launches,
                             pe=kpe.probe_events.launches)
    eng = engines["probed"]
    docs = {ep: _get(plane.server.url + ep) for ep in
            ("/status", "/probes", "/engine/phases", "/metrics")}
    c, u = checked["probed"], checked["plain"]
    toks = {k: [r.out_tokens for r in v["done"]] for k, v in checked.items()}
    same = sum(a == b for ra, rb in zip(toks["probed"], toks["plain"])
               for a, b in zip(ra, rb))
    logits = all(torch.equal(a.first_logits, b.first_logits)
                 for a, b in zip(c["done"], u["done"]))
    steps = {k: {p: v["steps"] for p, v in ck["delta"].items()}
             for k, ck in checked.items()}
    want = (L * steps["plain"]["prefill"], L * steps["plain"]["decode"])
    print(f"probed engine [{ARCH}, {BATCH} x {PROMPT} + {MAX_NEW}, decode "
          f"kernel]: token ids equal to the unprobed engine's {same}/"
          f"{BATCH * MAX_NEW}; first-step logits bitwise equal: {logits}; "
          f"launches flash, paged: probed ({c['flash']}, {c['paged']}), "
          f"unprobed ({u['flash']}, {u['paged']}) (want {want}); phase "
          f"steps {steps['probed']} (unprobed {steps['plain']}); retraces "
          f"{eng.retraces()}; probe_events launches {c['pe']}")
    assert same == BATCH * MAX_NEW and logits
    assert (c["flash"], c["paged"]) == (u["flash"], u["paged"]) == want
    assert steps["probed"] == steps["plain"] and eng.retraces() == 0
    ph = c["delta"]
    bills = {p: sum(r.phase_cycles[p] for r in c["done"])
             for p in ("prefill", "cache")}
    assert bills == {p: ph[p]["cycles"] for p in bills}, (bills, ph)
    assert all(r.phase_cycles["decode"] == ph["decode"]["cycles"]
               for r in c["done"])    # every request rode every round
    eng_doc = json.loads(docs["/engine/phases"])
    probes_doc = json.loads(docs["/probes"])
    status = json.loads(docs["/status"])
    print(f"status server {plane.server.url} while the engine is live: "
          f"/status {len(docs['/status'])} B ({status['engine']}), /probes "
          f"{len(docs['/probes'])} B (streams {sorted(probes_doc)}), "
          f"/engine/phases {len(docs['/engine/phases'])} B, /metrics "
          f"{len(docs['/metrics'])} B; /engine/phases == phase_stats: "
          f"{eng_doc['phases'] == eng.phase_stats}")
    assert eng_doc["phases"] == eng.phase_stats
    assert set(probes_doc) == {f"engine/{p}x{s}" for p, s in eng._steps}
    assert b"repro_engine_phase_cycles_total" in docs["/metrics"]
    print("# per-phase cycle attribution (checked probed run, cumulative "
          "over the warm-up and checked runs)")
    print(eng.phase_table())
    print("# per-request phase bill (checked probed run)")
    print(eng.request_table(c["done"]))
    for k, ck in checked.items():
        print(f"per-request wall latency, submit to its request publish "
              f"[{k}] (ms): "
              f"{[round(t * 1e3, 1) for t in ck['lat']]}; batch wall "
              f"{ck['wall'] * 1e3:.1f} ms")

    def count_syncs(name):
        """Host-device syncs in one serve, in each phase's steps and in
        all; torch warns once per synchronizing operation."""
        e = engines[name]
        per = defaultdict(int)
        step = e._step

        def spy(phase, size, *args):
            n0 = len(w)
            out = step(phase, size, *args)
            per[phase] += len(w) - n0
            return out
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            e._step = spy
            try:
                _, _, _, delta = serve_once(name)
            finally:
                e._step = step
                torch.cuda.set_sync_debug_mode("default")
        return ({p: round(per[p] / delta[p]["steps"], 2) for p in per},
                len(w))
    syncs = {"unprobed": count_syncs("plain"), "probed": count_syncs("probed")}
    with session_device_reads():
        syncs["probed, device reads"] = count_syncs("probed")
    for k, (per, total) in syncs.items():
        print(f"host-device syncs [{k}]: per step of each phase {per}; "
              f"{total} in the serve")
    for (phase, size), entry in sorted(eng._steps.items()):
        st = entry.pf.last_run
        print(f"session engine/{phase}x{size}: {entry.steps} steps, "
              f"{len(entry.paths)} probes; last step {st['transitions']} "
              f"transitions, {st['launches']} probe_events launches, "
              f"{st['dumps']} dumps; capture {entry.pf.capture_seconds * 1e3:.1f}"
              f" ms ({entry.pf.captures} capture); state_nbytes "
              f"{entry.state_nbytes()}; rows dropped {entry.sink.dropped}")
        assert entry.pf.captures == 1 and entry.sink.dropped == 0
    modes = {"unprobed": contextlib.nullcontext,
             "probed": contextlib.nullcontext,
             "probed, device reads": session_device_reads,
             "probed, spill copies made no-ops": no_spill_copies}
    walls = {k: [] for k in modes}
    for i in range(WALL_TURNS):
        order = list(walls) if i % 2 == 0 else list(walls)[::-1]
        for k in order:
            with modes[k]():
                walls[k].append(serve_once("plain" if k == "unprobed"
                                           else "probed")[1])
    print(f"batch walls in turns (ms, median of {WALL_TURNS}): " + ", ".join(
        f"{k} {statistics.median(v) * 1e3:.1f} "
        f"({[round(t * 1e3, 1) for t in v]})" for k, v in walls.items()))
    for e in engines.values():
        e.close()
    plane.finish()
    return c["pe"]


def profiled_ssm_phase(torch, fa, pa, ssd, serve, plain, dev):
    """mamba2-370m at full width, the legacy loop profiled (module
    docstring, step 10); ``plain`` is step 7's unprofiled serve."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ProbeConfig, decode_record, probe
    from repro_torch.distributed.steps import build_decode_step
    from repro_torch.models import Model
    L = get_config(SSM_ARCH).num_layers
    for fn in (fa.flash_attention, pa.paged_attention, ssd.ssd_scan):
        fn.launches = 0
    res = serve(SSM_ARCH, smoke=False, batch=BATCH, prompt_len=SSM_PROMPT,
                max_new=MAX_NEW, profile=True, profile_every=8)
    torch.cuda.synchronize()
    got = (fa.flash_attention.launches, pa.paged_attention.launches,
           ssd.ssd_scan.launches)
    same = int((res.tokens == plain.tokens).sum())
    snap = res.snapshot
    m = Model(get_config(SSM_ARCH))
    p = m._compute_cast(m.init(0, dev))
    toks = torch.randint(0, m.cfg.vocab_size, (1, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))
    _, cache = m.prefill(p, {"tokens": toks}, 17)
    # the legacy loop probes build_decode_step (JAX's ``decode`` root)
    pf = probe(build_decode_step(m), ProbeConfig(offload=1.0,
                                                 max_probes=16))
    _, rec = pf(p, cache, {"tokens": toks[:, -1:], "pos": 16})
    one = dict(zip(pf.probe_paths(),
                   (int(c) for c in decode_record(rec)["calls"])))
    calls_ok = (tuple(snap.paths) == pf.probe_paths() and all(
        r.calls == snap.steps * one[r.path] for r in snap.rows))
    print(f"profiled serve [{SSM_ARCH}, legacy loop]: {res.seconds * 1e3:.1f}"
          f" ms (unprofiled {plain.seconds * 1e3:.1f} ms); token ids equal to "
          f"the unprofiled serve's {same}/{plain.tokens.size}; launches flash, "
          f"paged, ssd {got} (want (0, 0, {L})); {snap.steps} decode steps, "
          f"calls per probe == steps x one-shot: {calls_ok}; state "
          f"{snap.state_nbytes} B")
    assert same == plain.tokens.size and got == (0, 0, L) and calls_ok
    assert snap.steps == MAX_NEW - 1
    del m, p, cache


def _tree_equal(torch, a, b) -> bool:
    from repro_torch.optim import adamw
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _train_flops(cfg, B, S) -> float:
    """Model FLOPs of one train step: 2 N T a matmul pass over the N
    matmul weights (the layers' and the unembedding; the embedding is a
    gather) plus the causal attention products, once forward, twice
    backward and once more in the remat recompute (layers and loss
    chunks): 8 N T + 4 attention."""
    from repro_torch.kernels.flash_attention import flash_cost
    d, L = cfg.d_model, cfg.num_layers
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    per_layer = d * hd * (2 * H + 2 * kv) + 3 * d * cfg.d_ff
    n_mm = L * per_layer + d * cfg.padded_vocab_size
    import torch
    q = torch.empty((B, H, S, hd), device="meta")
    k = torch.empty((B, kv, S, hd), device="meta")
    attn = L * flash_cost(q, k, k)[0]
    return 8.0 * n_mm * B * S + 4.0 * attn


def profile_train_step(torch, run, wall_ms: float) -> None:
    """One train step under ``torch.profiler``: device busy time (the
    union of kernel, memcpy and memset intervals) against the unprofiled
    step wall, and device time by kernel, the largest first."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = os.path.join(ROOT, "build", "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "train_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset") and "dur" in e]
    assert dev, "the profiler recorded no device activity"
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    n_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    print(f"train step profiled: device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / wall_ms / 1e3:.1f} % of the unprofiled "
          f"{wall_ms:.1f} ms wall; {len(dev)} device activities, {n_ops} "
          f"host ops; device time by kernel (ms, share of busy, calls):")
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:12]:
        print(f"  {us / 1e3:9.2f}  {100 * us / busy:5.1f} %  {n:6d}  "
              f"{name[:110]}")


def check_train_flash(torch, fa, dev):
    """The flash kernel at the training shape (B 8, 32 q heads over 4 kv
    heads, S 2048, D 64): output and row statistics against the plain
    version; the backward (``_flash_bwd``) from the kernel's forward
    against the same backward from the plain forward."""
    from repro_torch.models import attention as attn
    B, H, Hkv, S, D = TRAIN_B, 32, 4, TRAIN_S, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, m, l = fa.flash_attention(q, k, v, with_stats=True)
    po, pm, pl = fa.flash_attention_plain(q, k, v, with_stats=True)
    serve_out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - po.float()).abs().max().item()
    m_err = (m - pm).abs().max().item()
    l_err = ((l - pl).abs() / pl).max().item()
    same = torch.equal(serve_out, out)
    print(f"train flash (a) S=2048 B=8: max |kernel - plain| out {err:.3e} "
          f"(atol {FLASH_ATOL}), m {m_err:.3e} (atol {STATS_M_ATOL}), l rel "
          f"{l_err:.3e} (rtol {STATS_L_RTOL}); output with stats == "
          f"without, bitwise: {same}")
    assert err <= FLASH_ATOL and m_err <= STATS_M_ATOL
    assert l_err <= STATS_L_RTOL and same
    assert torch.isfinite(m).all() and (l >= 1.0).all()
    # backward from each forward, same cotangent; (B,S,H,D) layout
    dout = torch.randn((B, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kr, vr = (t.repeat_interleave(H // Hkv, dim=2) for t in (kt, vt))
    grads = []
    for o_, m_, l_ in ((out, m, l), (po, pm, pl)):
        grads.append(attn._flash_bwd(1024, 1024, (qt, kr, vr, o_.transpose(
            1, 2), m_, l_), dout))
    torch.cuda.synchronize()
    bwd_err = max((a.float() - b.float()).abs().max().item() /
                  b.float().abs().max().item() for a, b in zip(*grads))
    print(f"train flash (b) backward from the kernel's forward vs from the "
          f"plain forward: max |d| / max |grad| {bwd_err:.3e} (rtol "
          f"{BWD_RTOL})")
    assert bwd_err <= BWD_RTOL
    assert all(torch.isfinite(g.float()).all() for g in grads[0])
    flops, nbytes = fa.flash_cost(q, k, v, with_stats=True)
    return dict(inputs=(q, k, v), err=err, bound=bound(nbytes, flops),
                stats_err=(m_err, l_err), bwd_err=bwd_err)


def step_kernel_vs_plain(torch, fa, model, params, batch, kernel=None):
    """The train step's loss and gradients (``loss_fn`` under
    ``torch.autograd.grad``, as ``build_train_step`` takes them) with
    the flash forward by ``kernel`` (default: the CUDA kernel's wrapper)
    and by its plain function. Returns |loss diff|, the grad norms'
    relative difference, the largest max |d| / max |grad| over the
    gradient leaves, and that leaf's index."""
    from unittest import mock
    from repro_torch.models import attention as attn
    from repro_torch.optim import adamw

    def loss_and_grads(fwd):
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
        with mock.patch.object(attn.kops, "flash_attention", fwd), \
                torch.enable_grad():
            loss, _ = model.loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
        return loss.detach(), list(grads)

    lk, gk = loss_and_grads(kernel or fa.flash_attention)
    lp, gp = loss_and_grads(fa.flash_attention_plain)
    dl = abs(float(lk) - float(lp))
    nk, np_ = float(adamw.global_norm(gk)), float(adamw.global_norm(gp))
    rel = [((a.float() - b.float()).abs().max() /
            b.float().abs().max()).item() for a, b in zip(gk, gp)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return dl, abs(nk / np_ - 1), rel[worst], worst


def adamw_scans(params) -> dict:
    """The reference optimizer's loop nodes for ``params``
    (``src/repro/optim/adamw.py``: every leaf of two or more dimensions
    over 128 MiB is updated under a ``lax.scan`` over its leading axis),
    in leaf order: {``optimizer/adamw/scan#k``: trip count}."""
    from repro_torch.optim import adamw
    big = [p for p in adamw.tree_leaves(params)
           if p.dim() >= 2 and p.numel() * p.element_size() > 128 * 2**20]
    return {f"optimizer/adamw/scan#{i}": p.shape[0]
            for i, p in enumerate(big)}


SCAN_ROWS = 64      # step 11: rows of the f32 leaf whose row scan is probed


def check_row_scan(torch, dev, tcfg, sched) -> None:
    """Step 11: AdamW's row scan of an f32 2-D leaf just over the 128 MiB
    threshold (``SCAN_ROWS`` rows, the full-width embedding's rule at a
    few rows), probed alone: the update's outputs bitwise the unprobed
    ones, record == oracle, and its scan the reference rule's."""
    from repro_torch.core import ProbeConfig, decode_record, probe, scope
    from repro_torch.optim import adamw
    cols = adamw.SCAN_THRESHOLD_BYTES // (4 * SCAN_ROWS) + 1
    gen = torch.Generator(device=dev).manual_seed(11)
    p, g = ({"w": torch.randn(SCAN_ROWS, cols, generator=gen, device=dev)}
            for _ in range(2))
    opt = adamw.init(p)

    def update(p, g, opt):
        with scope.named_scope("optimizer"):
            return adamw.update(p, g, opt, tcfg, sched)
    want = update(p, g, opt)
    pf = probe(update, ProbeConfig(inline="off_all", max_probes=500),
               device=dev)
    got, rec = pf(p, g, opt)
    eq = (_tree_equal(torch, got[0], want[0])
          and _tree_equal(torch, tuple(got[1]), tuple(want[1]))
          and _tree_equal(torch, got[2], want[2]))
    dec, oc = decode_record(rec), pf.oracle(p, g, opt)
    exact = (dec["cycle"] == oc.cycle and list(dec["calls"]) == oc.calls
             and list(dec["totals"]) == oc.totals
             and list(dec["starts"]) == oc.starts
             and list(dec["ends"]) == oc.ends)
    scans = {q: int(c) for q, c in zip(pf.probe_paths(), dec["calls"])
             if q.startswith("optimizer/adamw/scan#")}
    print(f"AdamW row scan of an f32 ({SCAN_ROWS}, {cols}) leaf probed "
          f"alone: outputs == unprobed bitwise: {eq}; record == oracle: "
          f"{exact}; scans {scans} == the reference rule's: "
          f"{scans == adamw_scans(p)}")
    assert eq and exact and scans == adamw_scans(p)


def train_phase(torch, fa, pa, ssd, dev, smi):
    """Step 11: train tinyllama-1.1b at full width and depth (random
    weights from seed 0, batches from the port's TokenPipeline, seed 0)
    through ``build_train_step``, probe one step, and run the trainer's
    ``ProbeSession`` (``launch.train.train(probe_targets=...)``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core import ProbeConfig, decode_record, probe
    from repro_torch.core.hierarchy import write_copies
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import make_schedule

    tf = check_train_flash(torch, fa, dev)
    cfg = get_config(ARCH)
    B, S = TRAIN_B, TRAIN_S
    model = Model(cfg)
    tcfg = TrainConfig(total_steps=100, warmup_steps=10)
    step = build_train_step(model, tcfg)
    params = model.init(0, device=dev)
    opt = adamw.init(params, cfg.moment_dtype)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0))
    n_batches = TRAIN_WARM + TRAIN_STEPS + 1
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                pipe.batch_at(i).items()} for i in range(n_batches)]
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)

    def run(n, first):
        nonlocal params, opt
        walls, losses = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batches[first + i])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        return walls, losses

    w_warm, l_warm = run(TRAIN_WARM, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    walls, losses = run(TRAIN_STEPS, TRAIN_WARM)
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"train tinyllama-1.1b full width, B={B} S={S}: losses "
          f"{[round(x, 4) for x in l_warm + losses]}; flash/paged/ssd "
          f"launches {launches} over {TRAIN_STEPS} steps")
    assert all(math.isfinite(x) for x in l_warm + losses)
    assert launches == [2 * cfg.num_layers * TRAIN_STEPS, 0, 0], launches
    ms = statistics.median(walls) * 1e3
    flops = _train_flops(cfg, B, S)
    print(f"train step wall {ms:.1f} ms (median of {TRAIN_STEPS}, host clock, "
          f"synced; runs {[round(w * 1e3, 1) for w in walls]}), "
          f"{B * S / ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, {flops:.3e} model FLOP a step = "
          f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{100 * flops / (ms / 1e3) / BF16_FLOPS:.1f} % of the dense bf16 "
          f"peak ({smi})")

    profile_train_step(torch, lambda: step(params, opt, batches[-1]), ms)

    # the optimizer alone, and the part of it in the 2-D leaves' scans (a
    # row at a time: the embedding and the unembedding)
    sched = make_schedule(cfg.schedule, tcfg)
    rows = {str(i): p for i, p in enumerate(adamw.tree_leaves(params))
            if p.dim() == 2 and
            p.numel() * p.element_size() > adamw.SCAN_THRESHOLD_BYTES}
    rows_opt = adamw.init(rows, cfg.moment_dtype)
    opt_ms = walls_ms(torch, {
        "update": lambda: adamw.update(params, params, opt, tcfg, sched),
        "rows": lambda: adamw.update(rows, rows, rows_opt, tcfg, sched)},
        reps=1, warm=False)
    del rows, rows_opt
    print(f"optimizer update {opt_ms['update']:.1f} ms a step, of which the "
          f"row scans of the 2-D leaves {opt_ms['rows']:.1f} ms (one run, "
          f"after the timed steps ran it, host clock, synced)")

    # the step's forward and backward with the flash forward by the kernel
    # and by its plain function, same params and batch
    batch = batches[-1]
    dl, dg, dgrad, leaf = step_kernel_vs_plain(torch, fa, model, params,
                                               batch)
    print(f"train step, kernel forward vs plain forward: |loss diff| {dl:.3e}"
          f" (atol {STEP_LOSS_ATOL}), grad norm rel {dg:.3e} (rtol "
          f"{STEP_GNORM_RTOL}), max |d| / max |grad| over the leaves "
          f"{dgrad:.3e} at leaf {leaf} (rtol {STEP_GRAD_RTOL})")
    assert dl <= STEP_LOSS_ATOL and dg <= STEP_GNORM_RTOL
    assert dgrad <= STEP_GRAD_RTOL

    # the step unprobed and probed (model clock, every scope a probe), on
    # bf16 master params: no 2-D leaf is then over 128 MiB, so AdamW
    # scans none by rows (34,048 iterations whose capture, probed run and
    # oracle took minutes of the script); the stacked layers still scan
    del params, opt
    torch.cuda.empty_cache()
    model = Model(cfg.replace(param_dtype="bfloat16"))
    step = build_train_step(model, tcfg)
    params = model.init(0, device=dev)
    opt = adamw.init(params, cfg.moment_dtype)
    copies0 = write_copies()
    pf = probe(step, ProbeConfig(inline="off_all", max_probes=500),
               device=dev)
    t0 = time.perf_counter()
    pf.ensure_built(params, opt, batch)
    cap_s = time.perf_counter() - t0
    want = step(params, opt, batch)
    for c in counters:
        c.launches = 0
    got, rec = pf(params, opt, batch)
    p_launches = [c.launches for c in counters]
    eq = (_tree_equal(torch, got[0], want[0])
          and _tree_equal(torch, tuple(got[1]), tuple(want[1]))
          and all(torch.equal(got[2][k], want[2][k]) for k in want[2]))
    del got, want
    oc = pf.oracle(params, opt, batch)
    dec = decode_record(rec)
    paths = pf.probe_paths()
    exact = (dec["cycle"] == oc.cycle and list(dec["calls"]) == oc.calls
             and list(dec["totals"]) == oc.totals
             and list(dec["starts"]) == oc.starts
             and list(dec["ends"]) == oc.ends)
    copies = write_copies() - copies0
    print(f"probed train step (bf16 master params): outputs (params, "
          f"moments, loss, grad norm) == unprobed bitwise: {eq}; record == "
          f"oracle: {exact}; flash "
          f"launches {p_launches[0]}; write-guard copies {copies}; "
          f"{len(paths)} probes, capture {cap_s:.1f} s")
    assert eq and exact and copies == 0
    assert p_launches == [2 * cfg.num_layers, 0, 0], p_launches

    # the same step probed on the CPU at smoke width, 22 layers, with the
    # card's row and chunk plans (two q blocks of the flash backward, one
    # loss chunk): the same paths and calls, but the optimizer's scans
    # over the leaves over 128 MiB, which only full width has; those
    # equal the reference's rule applied to the full-width params
    ccfg = smoke_config(ARCH).replace(num_layers=cfg.num_layers,
                                      loss_chunk=128)
    cm = Model(ccfg)
    cp = cm.init(0, device="cpu")
    cb = {k: v[:2, :128].cpu() % ccfg.vocab_size for k, v in batch.items()}
    cpf = probe(build_train_step(cm, tcfg),
                ProbeConfig(inline="off_all", max_probes=500), device="cpu")
    _, crec = cpf(cp, adamw.init(cp), cb)
    cpu = list(zip(cpf.probe_paths(), decode_record(crec)["calls"].tolist()))
    card = list(zip(paths, dec["calls"].tolist()))
    scans = [(p, c) for p, c in card if p.startswith("optimizer/adamw/scan#")]
    same = [pc for pc in card if pc not in scans] == cpu
    bwd = [p for p in paths if "~bwd" in p]
    print(f"probe paths and calls on the card == the CPU's at smoke width: "
          f"{same} ({len(bwd)} ~bwd paths, "
          f"{sum('rematted_computation' in p for p in paths)} under "
          f"rematted_computation); the card's optimizer scans: {scans}")
    want_scans = adamw_scans(params)
    print(f"the card's optimizer scans == the reference rule's "
          f"{sorted(want_scans.items())}: {dict(scans) == want_scans}")
    assert same and bwd
    assert len(scans) == len(want_scans) and dict(scans) == want_scans
    check_row_scan(torch, dev, tcfg, sched)

    ids = {p: i for i, p in enumerate(paths)}
    bwd_share = int(dec["totals"][ids["loss~bwd"]]) / dec["cycle"]
    walls_pu = walls_ms(torch, {"unprobed": lambda: step(params, opt, batch),
                                "probed": lambda: pf(params, opt, batch)},
                        reps=1, warm=False)
    run_stats = pf.last_run
    print(f"probe overhead: step wall {walls_pu['unprobed']:.1f} ms unprobed, "
          f"{walls_pu['probed']:.1f} ms probed (one each, in turns, both "
          f"run just before); "
          f"{run_stats['transitions']} transitions, {run_stats['launches']} "
          f"probe_events launches a step; ~bwd share of the model clock "
          f"{100 * bwd_share:.1f} % ({smi})")
    del pf
    del params, opt, batches
    torch.cuda.empty_cache()

    # the trainer's ProbeSession (its --probe): JAX's settings
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    _, _, hist = train(ARCH, smoke=False, steps=SESSION_STEPS, batch=B,
                       seq=S, probe_targets=("",), probe_every=1,
                       log_every=1, device=dev)
    print(f"trainer under a ProbeSession: {SESSION_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s (init and capture included), "
          f"losses {[round(x, 4) for x in hist]}, flash launches "
          f"{fa.flash_attention.launches}")
    assert len(hist) == SESSION_STEPS and all(math.isfinite(x) for x in hist)
    # the capture's run launches the kernel too
    assert fa.flash_attention.launches == \
        2 * cfg.num_layers * (SESSION_STEPS + 1)
    torch.cuda.empty_cache()
    return dict(flash=tf, launches=launches[0], step_ms=ms, peak=peak)


def train_kernel(torch, fa, tr) -> dict:
    """The flash kernel's line at the training shape, with statistics:
    timed held, beside its plain version and SDPA's flash backend."""
    import torch.nn.functional as F
    q, k, v = tr["flash"]["inputs"]
    ms = time_ms(lambda: fa.flash_attention(q, k, v, with_stats=True))
    no_stats = time_ms(lambda: fa.flash_attention(q, k, v))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                     with_stats=True), reps=3)
    sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
    lib = time_ms(sdpa)
    print(f"flash at the training shape (B 8, H 32 over 4, S 2048, D 64), "
          f"with statistics: {ms * 1e3:.1f} us held (bound "
          f"{tr['flash']['bound'][0] * 1e3:.1f} us by "
          f"{tr['flash']['bound'][1]}), without statistics {no_stats * 1e3:.1f}"
          f" us (the statistics cost {100 * (ms / no_stats - 1):+.1f} %), "
          f"plain {plain * 1e3:.1f} us, SDPA ({how}) {lib * 1e3:.1f} us")
    return dict(name="flash_attention (train, with_stats)", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:121",
                launches=tr["launches"], max_abs_err=tr["flash"]["err"],
                ms=ms, plain_ms=plain, bound_ms=tr["flash"]["bound"][0],
                bound_by=tr["flash"]["bound"][1], library_ms=lib)


# the H100's published peak table gives no integer rate; the fold's
# integer work is held to its float32 rate outside the tensor cores
CUDA_CORE_OPS = 67e12


def fold_line(torch, fa, kpe, dev, launches) -> dict:
    """The fold kernel (``probe_grid``) at the prefill's flash grid (8 x
    32 x 8 x 8 steps, ring depth 4): against its plain version on copies
    of one state (prior calls and ring rows, two of the four ids
    spilling into a dump block), then its device time held, its plain
    version's, its bound (four ids, none spilling)."""
    import numpy as np
    from repro_torch.core import init_state
    q = torch.zeros((BATCH, 32, PROMPT, 64), dtype=torch.bfloat16,
                    device=dev)
    kv = torch.zeros((BATCH, 4, PROMPT, 64), dtype=torch.bfloat16, device=dev)
    plan = fa.flash_plan(q, kv, kv)
    _, counts = fa.flash_attention(q, kv, kv, with_probe=True)
    _, want = fa.flash_attention_plain(q, kv, kv, with_probe=True)
    assert torch.equal(counts, want)
    cnp = counts.cpu().numpy()

    rng = np.random.default_rng(7)
    ids, spill, depth = [0, 1, 2, 3], [False, True, False, True], 4
    base = init_state(4, depth, dev)
    base["calls"].copy_(torch.tensor([3, 6, 1, 0], device=dev))
    base["cycle"].fill_(int(rng.integers(0, 1 << 30)))
    base["ring"].copy_(torch.from_numpy(
        rng.integers(0, 1 << 20, (4, depth, 2))).to(dev))
    rows, offs = kpe.grid_dump_rows(base["calls"].tolist(), ids, spill,
                                    plan.steps, depth)
    ks = {k: v.clone() for k, v in base.items()}
    ps = {k: v.clone() for k, v in base.items()}
    dk, dp = (torch.zeros((len(rows), depth, 2), dtype=torch.int64,
                          device=dev) for _ in range(2))
    kpe.probe_grid(ks, plan, counts, ids, spill, dk, offs)
    kpe.probe_grid_plain(ps, plan, cnp, ids, spill, dp, offs)
    torch.cuda.synchronize()
    err = max([(ks[k] - ps[k]).abs().max().item() for k in ks]
              + [(dk - dp).abs().max().item()])
    print(f"probe_grid == plain at {plan.steps} steps (flash counts == "
          f"plain; 2 of 4 ids spilling, {len(rows)} dump rows; cycle, cnt, "
          f"calls, ring, dump): max |diff| {err} (exact)")
    assert err == 0

    ids, spill = [0, 1, 2, 3], [False] * 4
    st = init_state(4, 4, dev)
    ms = time_ms(lambda: kpe.probe_grid(st, plan, counts, ids, spill))
    plain = time_ms(lambda: kpe.probe_grid_plain(st, plan, cnp, ids, spill),
                    reps=5, hold=False)
    # each counter read once; per id its three planes and calls read and
    # written, the clock, and the first `depth` ring slots written
    nbytes = counts.numel() * 4 + 4 * 4 * 8 * 2 + 16 + 4 * 4 * 16
    # per step and id: a rule, a table read, an add, a ring test
    ops = plan.steps * len(ids) * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS
    bnd = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    print(f"probe_grid (the fold) at {plan.steps} steps: {ms * 1e3:.1f} us "
          f"held (bound {bnd * 1e3:.3f} us by {by}), plain {plain * 1e3:.1f} "
          f"us, {launches} launches in the grid-step phase's probed runs")
    return dict(name="probe_grid", route="cuda",
                source="src/repro_torch/csrc/probe_events.cu",
                replaces="src/repro/core/kernelprobe.py:379",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None)


# the step-14 tune: successive halving from 1 probed step to 4
DSE_STEPS = 4


def _rank_alike(a, b) -> bool:
    """Do two measures order the same candidates the same way?"""
    order = lambda d: sorted(d, key=lambda k: (d[k], k))  # noqa: E731
    return order(a) == order(b)


def tune_space(torch, name, space, cache, check, smi, max_steps=DSE_STEPS):
    """Step 14 (b) for one space: every candidate the budget keeps held
    against its plain version (``check(config)`` -> max error, asserted
    inside), the tune, each measured candidate's cycles beside its
    CUDA-event time, then a warm re-run. Returns (result, {config key:
    (event ms, err)})."""
    from repro_torch.core import DSEEngine
    eng = DSEEngine(space, cache=cache, max_steps=max_steps)
    t0 = time.perf_counter()
    res = eng.tune()
    tune_s = time.perf_counter() - t0
    print(res.leaderboard())
    rows = {}
    for t in res.trials:
        key = json.dumps(t.config, sort_keys=True)
        if t.pruned is not None:
            # a tile the card cannot hold is refused by the kernel too
            try:
                space.bind(t.config)(*space.args)
            except ValueError as e:
                print(f"  {name} {key}: pruned ({t.pruned}); the kernel "
                      f"refuses it: {str(e)[:60]}...")
                continue
            raise AssertionError(f"{name} {key} was pruned but launched")
        err = check(t.config)
        fn = space.bind(t.config)
        ms = time_ms(lambda: fn(*space.args), reps=20)
        rows[key] = (ms, err)
    meas = {json.dumps(t.config, sort_keys=True): t.cycles_per_step
            for t in res.trials if t.measured and t.pruned is None}
    for key, cyc in sorted(meas.items(), key=lambda kv: kv[1]):
        print(f"  {name} {key}: measured {cyc:.0f} {eng.cycle_source} "
              f"cycles a step ({'ns' if eng.cycle_source == 'wallclock' else 'model cycles'}), "
              f"CUDA events {rows[key][0] * 1e3:.1f} us held; max |kernel "
              f"- plain| {rows[key][1]:.3e}")
    ev = {k: rows[k][0] for k in meas}
    # the candidates each measure ran at the finalists' rung
    top = [json.dumps(t.config, sort_keys=True) for t in res.trials
           if t.measured and t.steps == res.best.steps]
    print(f"  {name}: winner {res.best.config} ({res.speedup:.3f}x the "
          f"default by the probe); the probe's cycles and CUDA events rank "
          f"the {len(meas)} measured candidates alike: "
          f"{_rank_alike(meas, ev)} (the finalists {len(top)}: "
          f"{_rank_alike({k: meas[k] for k in top}, {k: ev[k] for k in top})})"
          f"; {res.n_measurements} measurements, {res.measured_steps} steps, "
          f"{tune_s:.1f} s ({smi})")
    warm = DSEEngine(space, cache=cache, max_steps=max_steps).tune()
    print(f"  {name}: warm re-run {warm.n_measurements} new measurements, "
          f"{warm.n_cache_hits} cache hits, winner {warm.best.config}")
    assert warm.n_measurements == 0 and warm.best.config == res.best.config
    return res, rows


def dse_phase(torch, fa, pa, ssd, kpe, dev, smi):
    """Step 14 (see the module docstring): run_dse over the full-width
    tinyllama prefill, DSEEngine.tune over the main path's kernels and the
    chunked-prefill schedule, then serve --autotune from the cache."""
    import shutil

    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.core import EvalCache, ProbeConfig, run_dse
    from repro_torch.core.incremental import device_kind
    from repro_torch.kernels import search_spaces as ss
    from repro_torch.kernels import tuning
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    print(f"# design-space exploration ({smi})")
    out = dict(tiles=[])

    # (a) probe storage x offload over the full-width prefill
    m = Model(get_config(ARCH))
    p = m._compute_cast(m.init(0, dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, m.cfg.vocab_size, (BATCH, PROMPT), device=dev,
                         generator=gen, dtype=torch.int32)
    fn = lambda p_, b: m.prefill(p_, b, PROMPT + MAX_NEW)  # noqa: E731
    plain = _flat(fn(p, {"tokens": toks}))
    seen = []

    def check(pf, dec, outp):
        oc = pf.oracle(p, {"tokens": toks})
        same = all(torch.equal(a, b) for a, b in zip(_flat(outp), plain))
        seen.append((_record_equals_oracle(dec, oc), same))
        assert seen[-1] == (True, True), (pf.config, seen[-1])
    t0 = time.perf_counter()
    res = run_dse(fn, (p, {"tokens": toks}),
                  ProbeConfig(inline="off_all", max_probes=64), check=check)
    print(res.table())
    print(f"run_dse [{ARCH} prefill {BATCH}x{PROMPT}]: {len(res.points)} "
          f"points, {len(res.pareto)} on the Pareto front, best "
          f"{res.best().storage} at {res.best().offload_ratio:.2f}; record == "
          f"oracle and logits bitwise the unprobed at every point: "
          f"{all(a and b for a, b in seen)} ({len(seen)} checked); "
          f"{time.perf_counter() - t0:.1f} s")
    assert len(res.points) == len(seen) == 12
    del m, p, plain

    # (b) the kernels' tiles at the main path's shapes
    root = os.path.join(ROOT, "build", "dse_cache")
    shutil.rmtree(root, ignore_errors=True)
    cache = EvalCache(root)
    tuning.clear_tuned()

    def flash_check(space):
        q, k, v = space.args

        def check(cfg):
            o = fa.flash_attention(q, k, v, **cfg)
            r = fa.flash_attention_plain(q, k, v, **cfg)
            torch.cuda.synchronize()
            err = (o.float() - r.float()).abs().max().item()
            assert err <= FLASH_ATOL, (cfg, err)
            return err
        return check

    def smem_checks(kind, D, space):
        for cfg in space.candidates():
            if kind == "flash":
                r = fa.flash_resources(D, cfg["block_q"], cfg["block_k"])
                if r.smem_bytes > 232448:
                    continue
                a = fa.flash_attrs(D, cfg["block_q"], cfg["block_k"])
                got, want = a["dynamic_smem"] + a["static_smem"], r.smem_bytes
                need = fa.flash_min_blocks(D, cfg["block_q"], cfg["block_k"])
                extra = (f"{a['registers']} registers, {a['local_bytes']} "
                         f"local bytes a thread; the driver fits "
                         f"{a['ctas_per_sm']} CTAs an SM, compiled for "
                         f"{need}")
                assert a["static_smem"] == 0 and a["ctas_per_sm"] >= need, \
                    (cfg, a)
            else:
                a = pa.paged_attrs(D, 8, cfg["tile_slots"])
                got = (a["stats_smem"], a["output_smem"])
                want = pa.paged_smem_bytes(D, 8, cfg["tile_slots"])
                extra = (f"{a['stats_registers']}/{a['output_registers']} "
                         f"registers, {a['stats_local_bytes']}/"
                         f"{a['output_local_bytes']} local bytes a thread")
            print(f"  {kind} {cfg}: declared shared memory {want}, the "
                  f"kernel's attributes {got} ({extra})")
            assert got == want, (kind, cfg, got, want)

    sdpa_ms = {}
    winners = {}
    for label, B, S in (("train", BATCH, TRAIN_S), ("serve", BATCH, PROMPT),
                        ("engine", 1, PROMPT)):
        sp = ss.flash_attention_space(B=B, H=32, Hkv=4, S=S, D=64,
                                      device=dev)
        if label == "serve":
            smem_checks("flash", 64, sp)
        r, rows = tune_space(torch, f"flash ({label} B {B} S {S})", sp,
                             cache, flash_check(sp), smi)
        winners[label] = (r.best.config["block_q"], r.best.config["block_k"])
        q, k, v = sp.args
        sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
        sdpa_ms[label] = time_ms(sdpa)
        best = json.dumps(r.best.config, sort_keys=True)
        dflt = json.dumps(r.default.config, sort_keys=True)
        print(f"  flash ({label}): tuned {r.best.config} "
              f"{rows[best][0] * 1e3:.1f} us beside the default "
              f"{rows[dflt][0] * 1e3:.1f} us and SDPA ({how}) "
              f"{sdpa_ms[label] * 1e3:.1f} us, CUDA events held")
        if label != "train":
            nbytes, flops = fa.flash_cost(q, k, v)[1], fa.flash_cost(q, k, v)[0]
            bnd = bound(nbytes, flops)
            for key, (ms, err) in rows.items():
                cfg = json.loads(key)
                # the plain version is host-bound: timed with the host in
                # the loop, as a call costs a caller
                plain_ms = time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, **cfg), reps=3, hold=False)
                out["tiles"].append(dict(
                    kernel="flash", cfg=cfg, ms=ms, err=err, plain=plain_ms,
                    bound=bnd, lib=sdpa_ms[label], shape=(label, B, S),
                    source="src/repro_torch/csrc/"
                           f"{fa.flash_library(cfg['block_q'], cfg['block_k'])}.cu",
                    replaces="src/repro/kernels/flash_attention.py:121"))

    # paged at the serving decode shape: 8 rows at pos 543
    sp = ss.paged_attention_space(B=BATCH, KV=4, G=8, HD=64, page_size=16,
                                  n_pages=34, pool_pages=274,
                                  pos=(543,) * BATCH, q_dtype=torch.bfloat16,
                                  device=dev)
    smem_checks("paged", 64, sp)

    def paged_check(cfg):
        args = sp.args
        o = pa.paged_attention(*args, tile_slots=cfg["tile_slots"])
        r = pa.paged_attention_plain(*args)
        o_c, got = pa._paged(*args, True, cfg["tile_slots"])
        _, want = pa.paged_attention_plain(*args, with_counts=True,
                                           tile_slots=cfg["tile_slots"])
        torch.cuda.synchronize()
        err = (o - r).abs().max().item()
        assert err <= PAGED_ATOL and torch.equal(got, want) and \
            torch.equal(o_c, o), (cfg, err)
        return err
    r, rows = tune_space(torch, "paged (decode B 8 pos 543)", sp, cache,
                         paged_check, smi)
    winners["paged"] = r.best.config["tile_slots"]
    q, pk, pv, pages, pos = sp.args
    pbound = bound(*reversed(pa.paged_cost(q, pk, pv, pages, pos)))
    for key, (ms, err) in rows.items():
        cfg = json.loads(key)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(*sp.args), reps=5,
                           hold=False)
        out["tiles"].append(dict(
            kernel="paged", cfg=cfg, ms=ms, err=err, plain=plain_ms,
            bound=pbound, lib=None,
            source=f"src/repro_torch/csrc/{pa.paged_library(cfg['tile_slots'])}.cu",
            replaces="src/repro/kernels/paged_attention.py:94"))

    # SSD at one mamba2-370m prefill layer; each chunk held on realistic
    # inputs (the mamba2 inits) of the same shape
    B_, L_, H_, P_, G_, N_ = BATCH, SSM_PROMPT, 32, 64, 1, 128
    sp = ss.ssd_scan_space(B=B_, H=H_, G=G_, L=L_, P=P_, N=N_,
                           dtype=torch.bfloat16, device=dev)
    real = ssd_inputs(torch, dev, B_, L_, H_, P_, G_, N_, seed=2)

    def ssd_check(cfg):
        y, st = ssd.ssd_scan(*real, chunk=cfg["chunk"], h_per_g=H_ // G_,
                             return_final_state=True)
        py, pst = ssd.ssd_scan_plain(*real, chunk=cfg["chunk"],
                                     h_per_g=H_ // G_,
                                     return_final_state=True)
        torch.cuda.synchronize()
        errs = dict(y=rel_err(y, py), state=rel_err(st, pst))
        assert all(errs[k] <= SSD_RTOL[k] for k in errs), (cfg, errs)
        return max(errs.values())
    r, rows = tune_space(torch, f"ssd (mamba2 layer B {B_} L {L_})", sp,
                         cache, ssd_check, smi)
    sbound = bound(*reversed(ssd.ssd_cost(*real, 256, True)))
    for key, (ms, err) in rows.items():
        cfg = json.loads(key)
        plain_ms = time_ms(lambda: ssd.ssd_scan_plain(
            *real, chunk=cfg["chunk"], h_per_g=H_ // G_,
            return_final_state=True), reps=3, hold=False)
        out["tiles"].append(dict(
            kernel="ssd", cfg=cfg, ms=ms, err=err, plain=plain_ms,
            bound=sbound, lib=None, source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:83"))

    # the engine's chunked-prefill quantum at 32 prompt pages (full width)
    sp = ss.chunked_prefill_space(arch=ARCH, prompt_pages=PROMPT // 16,
                                  full=True, device=dev)
    V = get_config(ARCH).vocab_size
    ref = sp.bind(sp.default)(*sp.args)[0][:, :V]
    # the teeth: another first half of the prompt moves the last logits
    params, pk, pv, toks = sp.args
    other = toks.clone()
    other[:, :toks.shape[1] // 2] = (other[:, :toks.shape[1] // 2] + 1) % V
    moved = (sp.bind(sp.default)(params, pk, pv, other)[0][:, :V] - ref
             ).abs().max().item()
    print(f"  chunked_prefill: another first half of the prompt moves the "
          f"last logits by {moved:.3e} (atol {CHUNK_LOGIT_ATOL})")
    assert moved > CHUNK_LOGIT_ATOL, moved
    del other

    def chunk_check(cfg):
        lg = sp.bind(cfg)(*sp.args)[0][:, :V]
        torch.cuda.synchronize()
        err = (lg - ref).abs().max().item()
        assert err <= CHUNK_LOGIT_ATOL, (cfg, err)
        return err
    tune_space(torch, f"chunked_prefill ({ARCH}, {PROMPT // 16} pages)", sp,
               cache, chunk_check, smi, max_steps=2)
    del sp, ref, params, pk, pv, toks

    # (c) serve --autotune from this cache, beside the untuned serve
    kw = dict(smoke=False, batch=BATCH, prompt_len=PROMPT, max_new=MAX_NEW,
              engine_kernel=True)
    runs = {}
    for name, extra in (("untuned", {}),
                        ("autotune", dict(autotune=True, tune_cache=root))):
        fa.flash_attention.launches = pa.paged_attention.launches = 0
        fa.flash_attention.tile_launches.clear()
        pa.paged_attention.tile_launches.clear()
        res = serve(ARCH, **kw, **extra)
        torch.cuda.synchronize()
        ph = res.stats["phases"]
        L = get_config(ARCH).num_layers
        want = (L * (ph["prefill"]["steps"]
                     + ph.get("chunkpf", {"steps": 0})["steps"]),
                L * ph["decode"]["steps"])
        got = (fa.flash_attention.launches, pa.paged_attention.launches)
        print(f"serve [{name}]: {res.seconds * 1e3:.1f} ms; launches flash "
              f"{got[0]}, paged {got[1]} (want {want}); by tile: flash "
              f"{dict(fa.flash_attention.tile_launches)}, paged "
              f"{dict(pa.paged_attention.tile_launches)}")
        assert got == want and res.stats["retraces"] == 0
        runs[name] = (res, dict(fa.flash_attention.tile_launches),
                      dict(pa.paged_attention.tile_launches))
    # each launch at the winner tuned at its own shape: the engine's
    # one-prompt prefill and its decode (not the 8 x 512 or training
    # shape's winners, also loaded)
    flash_t, paged_t = runs["autotune"][1], runs["autotune"][2]
    print(f"serve --autotune: flash at {flash_t} (the engine prefill's "
          f"winner {winners['engine']}), paged at {paged_t} (the decode's "
          f"winner {winners['paged']})")
    assert set(flash_t) == {winners["engine"]} and \
        set(paged_t) == {winners["paged"]}, (flash_t, paged_t, winners)
    tuned = {k: len(cache.winners(k, device_kind(dev)))
             for k in tuning.KERNEL_IDS}
    tuning.clear_tuned()
    a, b = runs["untuned"][0], runs["autotune"][0]
    same = int((a.tokens == b.tokens).sum())
    V = get_config(ARCH).vocab_size
    dl = (a.first_logits[:, :V] - b.first_logits[:, :V]).abs().max().item()
    print(f"serve --autotune loaded winners at {tuned} shapes; token ids "
          f"shared with the "
          f"untuned serve: {same}/{a.tokens.size} (reported: other tiles "
          f"round differently); first-step max |logit diff| {dl:.3e}")
    out["serve_tiles"] = (runs["autotune"][1], runs["autotune"][2])
    return out


# -------------------------------------------------------------- step 15
# the remaining model families at full width, through the entry points

HYBRID, MOE_ARCH, AUDIO, VLM, BIG_MOE = (
    "zamba2-2.7b", "granite-moe-1b-a400m", "musicgen-large", "qwen2-vl-72b",
    "arctic-480b")
FAM_PROMPT = 512
SSM_TRAIN_B, SSM_TRAIN_S = 8, 2048
SMI = [""]                     # the card, for step 15's lines


def _zero(counters):
    for c in counters:
        c.launches = 0


def _launches(counters):
    return tuple(c.launches for c in counters)


def _kernel_line(name, source, replaces, launches, err, ms, plain_ms, bnd,
                 lib_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=lib_ms)


FLASH_SRC = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:121")
PAGED_SRC = ("src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:94")
SSD_SRC = ("src/repro_torch/csrc/ssd_scan.cu",
           "src/repro/kernels/ssd_scan.py:83")


def flash_at(torch, F, fa, dev, B, H, Hkv, S, D, seed, label, smi,
             offsets=False):
    """The flash kernel at one prefill shape of a family's path: against
    its plain version (and, with ``offsets``, rows at a q offset bitwise
    the whole call's), its time held beside the plain version's and
    SDPA's flash backend, and its bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, S, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out = fa.flash_attention(q, k, v)
    plain = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= FLASH_ATOL, err
    if offsets:
        offs = ((3 * S // 4, S // 4), (S // 5, 37), (S - 1, 1))
        rows = all(torch.equal(
            fa.flash_attention(q[:, :, o:o + n].contiguous(), k, v,
                               q_offset=o), out[:, :, o:o + n])
            for o, n in offs)
        print(f"flash {label}: rows at q offsets {offs} (offset, rows) == "
              f"the whole call's bitwise: {rows}")
        assert rows
    flops, nbytes = fa.flash_cost(q, k, v)
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3)
    sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
    lib_ms = time_ms(sdpa)
    d_lib = (sdpa().float() - out.float()).abs().max().item()
    bnd = bound(nbytes, flops)
    print(f"flash {label} (B {B}, {H}/{Hkv} heads, S {S}, D {D}): max "
          f"|kernel - plain| {err:.3e} (atol {FLASH_ATOL}); {ms * 1e3:.1f} us "
          f"held (bound {bnd[0] * 1e3:.2f} us by {bnd[1]}: {flops:.3e} FLOP, "
          f"{nbytes:.3e} B), plain {plain_ms * 1e3:.1f} us, SDPA ({how}) "
          f"{lib_ms * 1e3:.1f} us, |SDPA - kernel| {d_lib:.3e} ({smi})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bnd, lib_ms=lib_ms)


def paged_at(torch, pa, dev, B, kv, g, hd, n_pages, seed, label, smi):
    """The paged kernel at a family's engine decode shape (every row at
    its last position of ``n_pages`` pages of 16) against its plain
    version, held time and bound."""
    ps, P = 16, B * n_pages + 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    q = torch.randn((B, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_k, pool_v = (torch.randn((P, ps, kv, hd), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
    pages = (torch.randperm(P - 1, generator=cpu)[:B * n_pages] + 1).reshape(
        B, n_pages).to(torch.int32).to(dev)
    pos = torch.full((B,), ps * n_pages - 1, dtype=torch.int32, device=dev)
    args = (q, pool_k, pool_v, pages, pos)
    out = pa.paged_attention(*args)
    err = (out - pa.paged_attention_plain(*args)).abs().max().item()
    assert torch.isfinite(out).all() and err <= PAGED_ATOL, err
    flops, nbytes = pa.paged_cost(*args)
    ms = time_ms(lambda: pa.paged_attention(*args))
    plain_ms = time_ms(lambda: pa.paged_attention_plain(*args), reps=3)
    bnd = bound(nbytes, flops)
    print(f"paged {label} (B {B}, {kv} kv heads x {g} rows, hd {hd}, "
          f"{n_pages} pages): max |kernel - plain| {err:.3e} (atol "
          f"{PAGED_ATOL}); {ms * 1e3:.1f} us held (bound "
          f"{bnd[0] * 1e3:.2f} us by {bnd[1]}), plain {plain_ms * 1e3:.1f} us "
          f"({smi})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bnd, lib_ms=None)


def ssd_zamba2(torch, ssd, dev, smi):
    """The SSD scan at one zamba2-2.7b layer: B 4, L 512, 80 heads of 64,
    one group, N 64, chunk 256, bf16."""
    B, L, H, P, G, N, chunk = 4, 512, 80, 64, 1, 64, 256
    x, a, b, c = ssd_inputs(torch, dev, B, L, H, P, G, N, seed=5)
    kw = dict(chunk=chunk, h_per_g=H // G, return_final_state=True)
    y, st = ssd.ssd_scan(x, a, b, c, **kw)
    py, pst = ssd.ssd_scan_plain(x, a, b, c, **kw)
    fy, fst = ssd.ssd_scan_plain(x.float(), a, b.float(), c.float(), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    errs = dict(y=rel_err(y, py), state=rel_err(st, pst))
    f32 = dict(y=rel_err(y, fy), state=rel_err(st, fst))
    flops, nbytes = ssd.ssd_cost(x, a, b, c, chunk, True)
    ms = time_ms(lambda: ssd.ssd_scan(x, a, b, c, **kw))
    plain_ms = time_ms(lambda: ssd.ssd_scan_plain(x, a, b, c, **kw), reps=3)
    bnd = bound(nbytes, flops)
    print(f"ssd zamba2 layer (B {B}, L {L}, H {H}, P {P}, G {G}, N {N}): "
          f"max |kernel - plain| / max |plain|: y {errs['y']:.3e}, state "
          f"{errs['state']:.3e} (rtol {SSD_RTOL}); vs plain on f32 copies: "
          f"y {f32['y']:.3e}, state {f32['state']:.3e} (rtol "
          f"{SSD_F32_RTOL}); {ms * 1e3:.1f} us held (bound "
          f"{bnd[0] * 1e3:.2f} us by {bnd[1]}: {flops:.3e} FLOP, "
          f"{nbytes:.3e} B), plain {plain_ms * 1e3:.1f} us ({smi})")
    assert all(errs[k] <= SSD_RTOL[k] and f32[k] <= SSD_F32_RTOL[k]
               for k in errs)
    return dict(err=(y.float() - py.float()).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound=bnd, lib_ms=None)


def _serve_line(name, res, got, want, extra=""):
    n = res.tokens.size
    print(f"serve [{name}]: {res.seconds * 1e3:.1f} ms, "
          f"{n / res.seconds:.1f} tokens/s; launches flash, paged, ssd "
          f"{got} (want {want}){extra} ({SMI[0]})")
    assert got == want, (name, got, want)


def _check_tokens(torch, res, V, shape):
    assert res.tokens.shape == shape
    assert ((res.tokens >= 0) & (res.tokens < V)).all()
    assert torch.isfinite(res.first_logits[:, :V]).all()


def hybrid_serve(torch, counters, serve, dev):
    """zamba2-2.7b at full width and depth (54 SSM layers in 9 groups, a
    shared attention block after each) through the legacy loop, then a
    probed decode step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ProbeConfig, decode_record, probe
    from repro_torch.models import Model
    cfg = get_config(HYBRID)
    L, G = cfg.num_layers, cfg.num_layers // cfg.shared_attn_every
    serve(HYBRID, smoke=False, batch=2, prompt_len=64, max_new=2)
    _zero(counters)
    res = serve(HYBRID, smoke=False, batch=4, prompt_len=FAM_PROMPT,
                max_new=16)
    torch.cuda.synchronize()
    got = _launches(counters)
    _check_tokens(torch, res, cfg.vocab_size, (4, 16))
    _serve_line(HYBRID, res, got, (G, 0, L),
                f"; 1 prefill of 4 x {FAM_PROMPT}: {G} flash calls at head "
                f"dim 80, {L} SSD wrapper calls")

    m = Model(cfg)
    p = m._compute_cast(m.init(0, dev))
    toks = torch.randint(0, cfg.vocab_size, (4, FAM_PROMPT + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    _, cache = m.prefill(p, {"tokens": toks[:, :-1]}, FAM_PROMPT + 8)
    batch = {"tokens": toks[:, -1:], "pos": FAM_PROMPT}

    def make():
        return p, {k: v.clone() for k, v in cache.items()}, batch
    pf = probe(m.decode_step, ProbeConfig(inline="off_all", max_probes=500),
               device=dev)
    t0 = time.perf_counter()
    pf.ensure_built(*make())
    cap = time.perf_counter() - t0
    want = _flat(m.decode_step(*make()))
    _zero(counters)
    out, rec = pf(*make())
    torch.cuda.synchronize()
    d_launch = _launches(counters)
    same = all(torch.equal(a, b) for a, b in zip(_flat(out), want))
    exact = _record_equals_oracle(decode_record(rec), pf.oracle(*make()))
    paths = pf.probe_paths()
    print(f"probe [{HYBRID} decode step, {SMI[0]}]: {len(paths)} probes ("
          f"{sum('shared_attn' in q for q in paths)} under shared_attn, "
          f"{sum('ssm_layer' in q for q in paths)} under ssm_layer), capture "
          f"{cap:.1f} s; record == oracle: {exact}; logits and caches == "
          f"unprobed bitwise: {same}; launches {d_launch} (want (0, 0, 0))")
    assert exact and same and d_launch == (0, 0, 0)
    del p, cache, m
    torch.cuda.empty_cache()
    return got


def moe_serve(torch, counters, serve, dev):
    """granite-moe-1b-a400m at full width and depth through the engine
    (whole-prompt prefill, the paged decode kernel), the capacity path's
    drops per layer counted on the way, then the legacy loop's ids."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    L, B, new = cfg.num_layers, 8, 32
    serve(MOE_ARCH, smoke=False, batch=2, prompt_len=32, max_new=2,
          engine_kernel=True)
    orig = moe._moe_local
    drops, assigned = [], []

    def counted(x, router_w, wi, wg, wo, cfg_):
        _, kept, _ = moe.routing({"router": router_w}, x, cfg_)
        drops.append((~kept).sum())
        assigned.append(kept.numel())
        return orig(x, router_w, wi, wg, wo, cfg_)
    _zero(counters)
    moe._moe_local = counted
    try:
        res = serve(MOE_ARCH, smoke=False, batch=B, prompt_len=FAM_PROMPT,
                    max_new=new, engine_kernel=True)
    finally:
        moe._moe_local = orig
    torch.cuda.synchronize()
    got = _launches(counters)
    _check_tokens(torch, res, cfg.vocab_size, (B, new))
    ph = res.stats["phases"]
    pre, dec = ph["prefill"]["steps"], ph["decode"]["steps"]
    assert res.stats["retraces"] == 0
    _serve_line(f"{MOE_ARCH}, engine", res, got, (L * pre, L * dec, 0),
                f"; {pre} prefill steps, {dec} decode rounds (the wall "
                f"includes the drop count's second routing pass)")
    per = torch.stack(drops).view(-1, L).sum(0).tolist()
    tot = torch.tensor(assigned).view(-1, L).sum(0).tolist()
    print(f"{MOE_ARCH} capacity path ({SMI[0]}): (token, expert) "
          f"assignments dropped "
          f"per layer over the serve {per} of {tot[0]} each "
          f"({100 * sum(per) / sum(tot):.2f} % overall; capacity factor "
          f"{cfg.moe.capacity_factor}, {cfg.moe.num_experts} experts, "
          f"top-{cfg.moe.top_k})")
    _zero(counters)
    leg = serve(MOE_ARCH, smoke=False, batch=B, prompt_len=FAM_PROMPT,
                max_new=new, engine=False)
    torch.cuda.synchronize()
    same = int((leg.tokens == res.tokens).sum())
    print(f"{MOE_ARCH} legacy loop: {leg.seconds * 1e3:.1f} ms, launches "
          f"{_launches(counters)}; token ids shared with the engine "
          f"{same}/{res.tokens.size} (reported: the legacy prefill routes "
          f"all {B} prompts as one batch, so its capacities and drops "
          f"differ)")
    assert _launches(counters) == (L, 0, 0)
    torch.cuda.empty_cache()
    return got, pre, dec


def frontend_serves(torch, counters, serve):
    """musicgen-large at full width and depth, and qwen2-vl-72b at full
    width with 2 of its 80 layers, through the legacy loop on synthetic
    frontend embeddings (M-RoPE for qwen2-vl)."""
    from repro_torch.configs.registry import get_config
    out = {}
    for arch, layers, B, new in ((AUDIO, None, 4, 16), (VLM, 2, 2, 8)):
        cfg = get_config(arch)
        L = layers or cfg.num_layers
        _zero(counters)
        res = serve(arch, smoke=False, batch=B, prompt_len=FAM_PROMPT,
                    max_new=new, layers=layers)
        torch.cuda.synchronize()
        got = _launches(counters)
        _check_tokens(torch, res, cfg.vocab_size, (B, new))
        _serve_line(f"{arch}, {L} of {cfg.num_layers} layers", res, got,
                    (L, 0, 0), f"; 1 prefill of {B} x {FAM_PROMPT} "
                    f"embeddings ({cfg.frontend} frontend, {cfg.pos_emb})")
        out[arch] = got
        torch.cuda.empty_cache()
    return out


def big_moe_serve(torch, counters, serve, dev):
    """arctic-480b at full width, 1 of its 35 layers (128 experts of
    7168 x 4864, ~27 GB at bf16), through the engine."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(BIG_MOE)
    B, new = 4, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    res = serve(BIG_MOE, smoke=False, batch=B, prompt_len=FAM_PROMPT,
                max_new=new, engine_kernel=True, layers=1)
    torch.cuda.synchronize()
    got = _launches(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    _check_tokens(torch, res, cfg.vocab_size, (B, new))
    ph = res.stats["phases"]
    pre, dec = ph["prefill"]["steps"], ph["decode"]["steps"]
    _serve_line(f"{BIG_MOE}, 1 of {cfg.num_layers} layers, engine", res, got,
                (pre, dec, 0), f"; {pre} prefill steps, {dec} decode "
                f"rounds; max_memory_allocated {peak / 2**30:.2f} GiB "
                f"(weight init included)")
    torch.cuda.empty_cache()
    return got, pre, dec, peak


def ssm_train_phase(torch, counters, dev, smi):
    """mamba2-370m trains at full width (48 layers, f32 master params,
    bf16 compute, remat full, the plain SSD path), B 8 x S 2048 from the
    port's TokenPipeline: 1 warm-up and 1 timed step, the optimizer's
    row scans, then one step of bf16 master params (no 2-D leaf scanned
    by rows) probed: outputs bitwise the unprobed step's, record ==
    oracle, and paths and calls those of the same step
    probed on the CPU at smoke width with 48 layers and the card's chunk
    plan (8 SSD chunks, one loss chunk), apart from the optimizer's scans
    over the leaves over 128 MiB."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core import ProbeConfig, decode_record, probe
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import make_schedule
    cfg = get_config(SSM_ARCH)
    B, S = SSM_TRAIN_B, SSM_TRAIN_S
    model = Model(cfg)
    tcfg = TrainConfig(total_steps=100, warmup_steps=10)
    step = build_train_step(model, tcfg)
    params = model.init(0, device=dev)
    opt = adamw.init(params, cfg.moment_dtype)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                pipe.batch_at(i).items()} for i in range(2)]
    params, opt, met = step(params, opt, batches[0])
    warm = float(met["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    walls, losses = [], []
    for i in (1,):
        prev = (params, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batches[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    got = _launches(counters)
    want = (params, opt, met)
    ms = statistics.median(walls) * 1e3
    print(f"train {SSM_ARCH} full width, B={B} S={S}: losses "
          f"{[round(x, 4) for x in [warm] + losses]}; step wall {ms:.1f} ms "
          f"(one run after 1 warm-up, host clock, synced; runs "
          f"{[round(w * 1e3, 1) for w in walls]}), {B * S / ms * 1e3:.0f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB ({smi}); launches "
          f"flash, paged, ssd {got} (want (0, 0, 0): training takes the "
          f"plain SSD path, as JAX's)")
    assert all(math.isfinite(x) for x in [warm] + losses)
    assert got == (0, 0, 0)
    sched = make_schedule(cfg.schedule, tcfg)
    rows = {str(i): q for i, q in enumerate(adamw.tree_leaves(params))
            if q.dim() == 2 and
            q.numel() * q.element_size() > adamw.SCAN_THRESHOLD_BYTES}
    n_rows = sum(q.shape[0] for q in rows.values())
    r_ms = 0.0
    if rows:
        rows_opt = adamw.init(rows, cfg.moment_dtype)
        r_ms = walls_ms(torch, {"rows": lambda: adamw.update(
            rows, rows, rows_opt, tcfg, sched)}, reps=1, warm=False)["rows"]
        del rows_opt
    del rows
    print(f"{SSM_ARCH} optimizer: the row scans of the 2-D leaves over "
          f"128 MiB ({n_rows} rows: the embedding and the unembedding) "
          f"take {r_ms:.1f} ms of the {ms:.1f} ms step "
          f"({100 * r_ms / ms:.1f} %; one run, after the steps ran it, host "
          f"clock, synced)")

    # one step of bf16 master params, unprobed and probed: no 2-D leaf is
    # then over 128 MiB, so AdamW scans none by rows (their capture and
    # oracle took minutes of the script); the stacked layers still scan
    del prev, want, params, opt
    torch.cuda.empty_cache()
    model = Model(cfg.replace(param_dtype="bfloat16"))
    step = build_train_step(model, tcfg)
    pp = model.init(0, device=dev)
    po = adamw.init(pp, cfg.moment_dtype)
    want_scans = adamw_scans(pp)
    batch = batches[1]
    pf = probe(step, ProbeConfig(inline="off_all", max_probes=500),
               device=dev)
    t0 = time.perf_counter()
    pf.ensure_built(pp, po, batch)
    cap = time.perf_counter() - t0
    want = step(pp, po, batch)
    out, rec = pf(pp, po, batch)
    torch.cuda.synchronize()
    eq = (_tree_equal(torch, out[0], want[0])
          and _tree_equal(torch, tuple(out[1]), tuple(want[1]))
          and all(torch.equal(out[2][k], want[2][k]) for k in want[2]))
    del out
    dec = decode_record(rec)
    oc = pf.oracle(pp, po, batch)
    exact = (dec["cycle"] == oc.cycle and list(dec["calls"]) == oc.calls
             and list(dec["totals"]) == oc.totals)
    paths = pf.probe_paths()
    print(f"probed {SSM_ARCH} train step, bf16 master params ({smi}): "
          f"outputs (params, moments, loss, "
          f"grad norm) == unprobed bitwise: {eq}; record == oracle: "
          f"{exact}; {len(paths)} probes, capture {cap:.1f} s, "
          f"{pf.last_run['transitions']} transitions")
    assert eq and exact
    del pp, po, want, batches
    torch.cuda.empty_cache()

    ccfg = smoke_config(SSM_ARCH).replace(num_layers=cfg.num_layers,
                                          loss_chunk=128)
    assert 128 // ccfg.ssm.chunk_size == S // cfg.ssm.chunk_size
    cm_ = Model(ccfg)
    cp = cm_.init(0, device="cpu")
    cb = {k: v[:2, :128].cpu() % ccfg.vocab_size for k, v in batch.items()}
    cpf = probe(build_train_step(cm_, tcfg),
                ProbeConfig(inline="off_all", max_probes=500), device="cpu")
    _, crec = cpf(cp, adamw.init(cp), cb)
    cpu = list(zip(cpf.probe_paths(), decode_record(crec)["calls"].tolist()))
    card = list(zip(paths, dec["calls"].tolist()))
    scans = [(q, c) for q, c in card if q.startswith("optimizer/adamw/scan#")]
    same = [pc for pc in card if pc not in scans] == cpu
    print(f"{SSM_ARCH} probe paths and calls on the card == the CPU's at "
          f"smoke width: {same} ({sum('~bwd' in q for q in paths)} ~bwd "
          f"paths, {sum('state_pass' in q for q in paths)} under "
          f"state_pass); the card's optimizer scans: {scans}")
    print(f"the card's optimizer scans == the reference rule's "
          f"{sorted(want_scans.items())}: {dict(scans) == want_scans}")
    assert same and dict(scans) == want_scans
    return dict(step_ms=ms, peak=peak, rows_ms=r_ms)


def families_phase(torch, fa, pa, ssd, dev, smi):
    """Step 15: the kernel checks at the new shapes, then zamba2-2.7b,
    granite-moe-1b-a400m, musicgen-large, qwen2-vl-72b (2 layers),
    arctic-480b (1 layer) served, and mamba2-370m trained."""
    import torch.nn.functional as F
    from repro_torch.launch.serve import serve
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    SMI[0] = smi
    print(f"step 15, the remaining families, on {smi}")
    t0 = time.perf_counter()
    k80 = flash_at(torch, F, fa, dev, 4, 32, 32, FAM_PROMPT, 80, 80,
                   f"D 80 at {HYBRID}'s prefill", smi, offsets=True)
    attrs = fa.flash_attrs(80)
    print(f"flash D 80 at 64/64: {attrs} (compiled for "
          f"{fa.flash_min_blocks(80, 64, 64)} CTA an SM)")
    s64 = ssd_zamba2(torch, ssd, dev, smi)
    hy = hybrid_serve(torch, counters, serve, dev)
    print(f"step 15 zamba2 done at {time.perf_counter() - t0:.1f} s")
    (mo, m_pre, m_dec) = moe_serve(torch, counters, serve, dev)
    fr = frontend_serves(torch, counters, serve)
    (ar, a_pre, a_dec, a_peak) = big_moe_serve(torch, counters, serve, dev)
    print(f"step 15 serves done at {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs.registry import get_config
    gm, ac = get_config(MOE_ARCH), get_config(BIG_MOE)
    shapes = [
        ("flash_attention D64 (granite-moe-1b-a400m engine prefill, B 1, "
         "16/8 heads, S 512)", FLASH_SRC, mo[0],
         flash_at(torch, F, fa, dev, 1, 16, 8, FAM_PROMPT, 64, 81,
                  f"{MOE_ARCH} engine prefill", smi)),
        ("paged_attention (granite-moe-1b-a400m decode, B 8, 8 kv heads x 2 "
         "rows, hd 64, 34 pages)", PAGED_SRC, mo[1],
         paged_at(torch, pa, dev, 8, gm.num_kv_heads, gm.q_per_kv, 64,
                  34, 82, f"{MOE_ARCH} decode", smi)),
        ("flash_attention D64 (musicgen-large prefill, B 4, 32/32 heads, "
         "S 512)", FLASH_SRC, fr[AUDIO][0],
         flash_at(torch, F, fa, dev, 4, 32, 32, FAM_PROMPT, 64, 83,
                  f"{AUDIO} prefill", smi)),
        ("flash_attention D128 (qwen2-vl-72b prefill, B 2, 64/8 heads, "
         "S 512)", FLASH_SRC, fr[VLM][0],
         flash_at(torch, F, fa, dev, 2, 64, 8, FAM_PROMPT, 128, 84,
                  f"{VLM} prefill", smi)),
        ("flash_attention D128 (arctic-480b engine prefill, B 1, 56/8 heads, "
         "S 512)", FLASH_SRC, ar[0],
         flash_at(torch, F, fa, dev, 1, ac.num_heads, ac.num_kv_heads,
                  FAM_PROMPT, 128, 85, f"{BIG_MOE} engine prefill", smi)),
        ("paged_attention (arctic-480b decode, B 4, 8 kv heads x 7 rows, "
         "hd 128, 33 pages)", PAGED_SRC, ar[1],
         paged_at(torch, pa, dev, 4, ac.num_kv_heads, ac.q_per_kv, 128, 33,
                  86, f"{BIG_MOE} decode", smi)),
    ]
    tr = ssm_train_phase(torch, counters, dev, smi)
    print(f"step 15 took {time.perf_counter() - t0:.1f} s")
    lines = [
        _kernel_line("flash_attention D80 (zamba2-2.7b prefill, B 4, 32/32 "
                     "heads, S 512)", *FLASH_SRC, hy[0], k80["err"],
                     k80["ms"], k80["plain_ms"], k80["bound"],
                     k80["lib_ms"]),
        _kernel_line("ssd_scan N64 (zamba2-2.7b layer, B 4, L 512, H 80, "
                     "P 64)", *SSD_SRC, hy[2], s64["err"], s64["ms"],
                     s64["plain_ms"], s64["bound"], None)]
    for name, src, n, r in shapes:
        lines.append(_kernel_line(name, *src, n, r["err"], r["ms"],
                                  r["plain_ms"], r["bound"], r["lib_ms"]))
    return dict(lines=lines, train=tr, arctic_peak=a_peak)


def tile_lines(tiles, serve_tiles) -> list:
    """The kernels-line entries of every (kernel, tile) step 14 checked;
    ``launches`` are the autotuned serve's at that tile (the SSD chunks':
    0, no SSD on that path)."""
    flash_l, paged_l = serve_tiles
    lines = []
    for t in tiles:
        cfg = t["cfg"]
        if t["kernel"] == "flash":
            label, B, S = t["shape"]
            # the autotuned serve launches flash at the engine's shape only
            n = flash_l.get((cfg["block_q"], cfg["block_k"]), 0) \
                if label == "engine" else 0
            name = (f"flash_attention tile block_q={cfg['block_q']} "
                    f"block_k={cfg['block_k']} (B {B} S {S})")
        elif t["kernel"] == "paged":
            n = paged_l.get(cfg["tile_slots"], 0)
            name = f"paged_attention tile tile_slots={cfg['tile_slots']}"
        else:
            n = 0
            name = f"ssd_scan chunk={cfg['chunk']} (mamba2 layer)"
        lines.append(dict(name=name, route="cuda", source=t["source"],
                          replaces=t["replaces"], launches=n,
                          max_abs_err=t["err"], ms=t["ms"],
                          plain_ms=t["plain"], bound_ms=t["bound"][0],
                          bound_by=t["bound"][1], library_ms=t["lib"]))
    return lines

# -------------------------------------------------------------- step 16
# the conformance harness and the engine soak

CONF_SEEDS = (0, 3, 4, 6, 7)    # the fast corpus's kernel graphs
# a graph's output sum(x * x) against its plain twin (``build(plain=
# True)``), relative: only the kernel block differs. Flash: the kernel and
# its plain version round p to bf16 after maxima and sums taken in other
# orders, a few bf16 ulps (2^-8) of some outputs, damped by the block's
# 0.5 residual and averaged over the sum; SSD in f32: summation order
# (1e-5 of max |y| against plain, tests/test_torch_cuda.py)
GRAPH_RTOL = 1e-3
# the SSD kernels in f32 against their plain version at the graph's
# shape, relative to max |y|
SSD_GRAPH_RTOL = 1e-5
# the flash kernel against its plain version at a graph's padded shape,
# relative to max |plain|: the graph's values are small (v ~ 0.1, near
# uniform weights), so an absolute bf16 limit set for randn inputs would
# be the size of the outputs. A few bf16 ulps (2^-8) of the largest
# output pass; a kernel that drops the causal mask reads ~1 (checked)
FLASH_GRAPH_RTOL = 1e-2
SOAK_WAVES, SOAK_RPW = 3, 8


@contextlib.contextmanager
def _spy(mod, names, seen):
    """Record the first call's arguments of ``mod.<name>`` for each name."""
    real = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def call(*a, **k):
            seen.setdefault(n, (a, k))
            return real[n](*a, **k)
        return call
    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(mod, n, real[n])


def conformance_seeds(torch, counters, dev):
    """Step 16 (a): every invariant of ``run_conformance`` on the card for
    the kernel graphs among the fast seeds; each graph's unprobed call
    launches its kernel blocks' kernels once each and agrees with its
    plain twin; returns the launches of the whole harness run and each
    seed's kernel inputs."""
    from repro_torch.kernels import ops as kops
    from repro_torch.testing import (INVARIANTS, build, random_spec,
                                     run_conformance)
    _zero(counters)
    stats = {}
    for seed in CONF_SEEDS:
        t0 = time.perf_counter()
        stats[seed] = run_conformance(random_spec(seed), device=dev)
        stats[seed]["seconds"] = time.perf_counter() - t0
        assert stats[seed]["invariants"] == INVARIANTS
    torch.cuda.synchronize()
    harness = _launches(counters)
    print(f"conformance harness over seeds {CONF_SEEDS}: launches flash, "
          f"paged, ssd {harness}")
    assert harness[0] > 0 and harness[2] > 0 and harness[1] == 0, harness
    inputs = {}
    for seed in CONF_SEEDS:
        spec = random_spec(seed)
        fn, args = build(spec, device=dev)
        want = (sum(b.kind == "flash_kernel" for b in spec.blocks), 0,
                sum(b.kind == "ssd_kernel" for b in spec.blocks))
        _zero(counters)
        out = fn(*args)
        torch.cuda.synchronize()
        got = _launches(counters)
        with _spy(kops, ("flash_attention", "ssd_scan"), {}) as seen:
            again = fn(*args)
        inputs[seed] = seen
        plain = build(spec, device=dev, plain=True)[0](*args)
        torch.cuda.synchronize()
        rel = abs(out.item() - plain.item()) / abs(plain.item())
        st = stats[seed]
        blocks = ", ".join(f"{b.kind}/{b.wrapper}" for b in spec.blocks)
        print(f"conformance seed {seed} ({blocks}): "
              f"{st['n_probes']} probes, {st['cycle']} cycles, "
              f"{st['seconds']:.2f} s, all {len(INVARIANTS)} invariants; "
              f"one unprobed call launches flash, paged, ssd {got} (want "
              f"{want}); output {out.item():.6f}, |graph - plain twin| / "
              f"|plain| {rel:.3e} (rtol {GRAPH_RTOL})")
        assert got == want, (seed, got, want)
        assert torch.equal(out, again) and torch.isfinite(out)
        assert rel <= GRAPH_RTOL, (seed, rel)
    return harness, inputs


def harness_flash_line(torch, F, fa, inputs, launches, smi):
    """The flash kernel at a graph's padded shape (seed 0: B 2, 2 heads,
    S 32, head dim 16 padded to 64, bf16) against its plain version."""
    (q, k, v), _ = inputs[0]["flash_attention"]
    out = fa.flash_attention(q, k, v)
    plain = fa.flash_attention_plain(q, k, v)
    # teeth: a kernel that ignored the causal mask
    unmasked = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    top = plain.float().abs().max().item()
    rel, wrong = rel_err(out, plain), rel_err(unmasked, plain)
    assert torch.isfinite(out.float()).all() and rel <= FLASH_GRAPH_RTOL, rel
    assert wrong > FLASH_GRAPH_RTOL, wrong
    flops, nbytes = fa.flash_cost(q, k, v)
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3)
    sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
    lib_ms = time_ms(sdpa)
    bnd = bound(nbytes, flops)
    B, H, S, D = q.shape
    print(f"flash at graphgen seed 0 (B {B}, {H} heads, S {S}, D {D} "
          f"padded from 16): max |kernel - plain| {err:.3e}, max |plain| "
          f"{top:.3e}, ratio {rel:.3e} (rtol {FLASH_GRAPH_RTOL}; without "
          f"the causal mask {wrong:.3e}); {ms * 1e3:.1f} us held (bound "
          f"{bnd[0] * 1e3:.4f} us by {bnd[1]}), plain {plain_ms * 1e3:.1f} "
          f"us, SDPA ({how}) {lib_ms * 1e3:.1f} us ({smi})")
    return _kernel_line(
        f"flash_attention D64 padded (graphgen seed 0, B {B}, {H}/{H} heads, "
        f"S {S}, head dim 16 zero-padded)", *FLASH_SRC, launches[0], err, ms,
        plain_ms, bnd, lib_ms)


def harness_ssd_line(torch, ssd, inputs, launches, smi):
    """The SSD kernels at a graph's padded shape (seed 6: B 1, L 32, 2
    heads, P 16 padded to 64, N 8 padded to 64, chunk 16, f32) against
    their plain version."""
    (x, a, b, c), kw = inputs[6]["ssd_scan"]
    kw = dict(chunk=kw["chunk"], h_per_g=kw["h_per_g"])
    y = ssd.ssd_scan(x, a, b, c, **kw)
    py = ssd.ssd_scan_plain(x, a, b, c, **kw)
    torch.cuda.synchronize()
    rel = rel_err(y, py)
    err = (y - py).abs().max().item()
    assert torch.isfinite(y).all() and rel <= SSD_GRAPH_RTOL, rel
    flops, nbytes = ssd.ssd_cost(x, a, b, c, kw["chunk"], False)
    ms = time_ms(lambda: ssd.ssd_scan(x, a, b, c, **kw))
    plain_ms = time_ms(lambda: ssd.ssd_scan_plain(x, a, b, c, **kw), reps=3)
    bnd = bound(nbytes, flops, F32_FLOPS)
    B, L, H, P = x.shape
    print(f"ssd at graphgen seed 6 (B {B}, L {L}, H {H}, P {P}, N "
          f"{b.shape[3]}, chunk {kw['chunk']}, f32): max |kernel - plain| / "
          f"max |plain| {rel:.3e} (rtol {SSD_GRAPH_RTOL}); {ms * 1e3:.1f} us "
          f"held (bound {bnd[0] * 1e3:.5f} us by {bnd[1]}), plain "
          f"{plain_ms * 1e3:.1f} us ({smi})")
    return _kernel_line(
        f"ssd_scan f32 (graphgen seed 6, B {B}, L {L}, H {H}, P 16 and N 8 "
        f"zero-padded to 64, chunk {kw['chunk']})", *SSD_SRC, launches[2],
        err, ms, plain_ms, bnd, None)


@contextlib.contextmanager
def _zero_after_warmup(torch, counters):
    """Counts from the soak's first wave on: the engine's warm-up (every
    step built and, probed, captured) is set-up."""
    from repro_torch.engine.engine import InferenceEngine
    real = InferenceEngine.warmup

    def warmup(self):
        real(self)
        torch.cuda.synchronize()
        _zero(counters)
    InferenceEngine.warmup = warmup
    try:
        yield
    finally:
        InferenceEngine.warmup = real


def soak_runs(torch, counters, dev, smi):
    """Step 16 (b): the soak at full width and depth tinyllama-1.1b
    (random weights from seed 0), decode kernel on: plain, then under
    pressure with chunked prefill and every step probed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine.soak import soak
    cfg = get_config(ARCH)
    runs = {}
    for name, kw in (("kernel", dict()),
                     ("pressure chunk 2 probed",
                      dict(pressure=True, chunk=2, probe=True))):
        t0 = time.perf_counter()
        with _zero_after_warmup(torch, counters):
            print(f"soak [{name}] ({ARCH} full, {SOAK_WAVES} waves x "
                  f"{SOAK_RPW} requests, {smi}):")
            out = soak(waves=SOAK_WAVES, requests_per_wave=SOAK_RPW, seed=0,
                       use_kernel=True, device=dev, cfg=cfg, **kw)
        torch.cuda.synchronize()
        got = _launches(counters)
        ph = out["phases"]
        pre = ph["prefill"]["steps"] + ph.get("chunkpf", {}).get("steps", 0)
        dec = ph["decode"]["steps"]
        want = (cfg.num_layers * pre, cfg.num_layers * dec, 0)
        wall = sum(out["wave_seconds"])
        print(f"soak [{name}]: {out['served']} served, {out['tokens']} "
              f"tokens in {wall * 1e3:.1f} ms of waves, "
              f"{out['tokens'] / wall:.1f} tokens/s ({smi}); prefill and "
              f"chunk steps {pre}, decode rounds {dec}, buckets "
              f"{out['buckets']}, pages peak {out['pages_peak']}, hit rate "
              f"{out['prefix_hit_rate']:.3f}, evictions {out['evictions']}; "
              f"host mem {out['mem_first']} -> {out['mem_last']} B, live "
              f"tensors {out['buffers_first']} -> {out['buffers_last']}, "
              f"device mem {out['device_mem_first']} -> "
              f"{out['device_mem_last']} B; launches flash, paged, ssd {got} "
              f"(want {want}); {time.perf_counter() - t0:.1f} s with "
              f"warm-up")
        assert got == want, (name, got, want)
        assert out["retraces"] == 0 and out["served"] == SOAK_WAVES * SOAK_RPW
        runs[name] = dict(out=out, launches=got)
    return runs


def harness_phase(torch, fa, pa, ssd, dev, smi):
    """Step 16: the conformance harness on the card over the kernel
    graphs, the soak at full width, and the kernels at their shapes."""
    import torch.nn.functional as F
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    print(f"step 16, the conformance harness and the soak, on {smi}")
    t0 = time.perf_counter()
    harness, inputs = conformance_seeds(torch, counters, dev)
    print(f"step 16 conformance done at {time.perf_counter() - t0:.1f} s")
    runs = soak_runs(torch, counters, dev, smi)
    print(f"step 16 soaks done at {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    paged_l = sum(r["launches"][1] for r in runs.values())
    pg = paged_at(torch, pa, dev, 4, cfg.num_kv_heads, cfg.q_per_kv,
                  cfg.resolved_head_dim, 8, 87, f"{ARCH} soak decode", smi)
    lines = [
        harness_flash_line(torch, F, fa, inputs, harness, smi),
        harness_ssd_line(torch, ssd, inputs, harness, smi),
        _kernel_line(f"paged_attention (the soak's decode, {ARCH}, B 4, "
                     f"{cfg.num_kv_heads} kv heads x {cfg.q_per_kv} rows, hd "
                     f"{cfg.resolved_head_dim}, 8 pages)", *PAGED_SRC,
                     paged_l, pg["err"], pg["ms"], pg["plain_ms"],
                     pg["bound"], None)]
    print(f"step 16 took {time.perf_counter() - t0:.1f} s")
    return lines


MESH_B, MESH_S, MESH_NEW = 4, 512, 16     # step 17: DP batch, serve tokens
# the flash kernel against its plain version at the mesh DP step's shape
# (randn, bf16), relative to max |plain| as at the graph's shape: most
# output rows are averages of hundreds of values (~0.1), so an absolute
# limit of a few ulps of the largest output would be a large share of
# a typical one. A few bf16 ulps (2^-8) of max |plain| pass; a kernel
# that drops the causal mask fails it
FLASH_MESH_RTOL = 1e-2


def _mesh_line(label, world, backend, probes, rec, comm_cyc, probed_s,
               unprobed_s, capture_s, flash):
    """One line a step 17 run: the device-major record's spans and skew
    beside the walls, the capture and the flash launches."""
    skew = max(rec["skew"]) if rec.get("skew") else 0
    print(f"mesh [{label}]: world {world} over {backend}, {probes} probes; "
          f"per-device span {rec['cycle']} cycles, max skew {skew}; comm "
          f"{comm_cyc} cycles; probed {probed_s * 1e3:.1f} ms, unprobed "
          f"{unprobed_s * 1e3:.1f} ms; capture {capture_s:.2f} s; flash "
          f"launches {flash}", flush=True)


def _comm_cycles(sites) -> int:
    from repro_torch.core.costmodel import LINK_BYTES_PER_CYCLE
    return int(math.ceil(sum(s[5] for s in sites) / LINK_BYTES_PER_CYCLE))


def mesh_phase(torch, fa, pa, ssd, dev, smi):
    """Step 17: mesh-aware probing over torch.distributed. World 1 over
    NCCL in this process (its launch counters count): the legacy serve
    with ``--mesh 1 --profile`` at full width and one full-width
    data-parallel train step under ``mesh_probe``; world 2 over gloo with
    both ranks on this card (``launch.mesh.spawn``; the kernels built
    above, so the ranks load them): the collectives gloo takes on the
    card's tensors, the skew workload, the DP step at smoke width with
    head dim 64, and the full-width mesh decode session."""
    import datetime
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.core import ProbeConfig, mesh_probe
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.compat import P
    from repro_torch.distributed.steps import build_dp_train_step
    from repro_torch.launch.mesh import make_mesh, spawn
    from repro_torch.launch.serve import serve
    from repro_torch.optim import adamw
    from repro_torch.testing import mesh_ranks
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    print(f"step 17, mesh-aware probing over torch.distributed, on {smi}")
    t0 = time.perf_counter()
    n = torch.cuda.device_count() + 1
    try:
        spawn(mesh_ranks.failing_rank, (n,), device="cuda")
    except ValueError as e:
        assert 'backend="gloo"' in str(e), e
        print(f"NCCL over {n} ranks on {n - 1} card(s) refused: {e}")
    else:
        raise AssertionError("NCCL with more ranks than cards did not raise")
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=120))
    flash_main = 0
    try:
        mesh = make_mesh((1,), ("dev",))
        # (a) serve --no-engine --profile --mesh 1 at full width
        plain = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                      max_new=MESH_NEW, engine=False, device=dev)
        _zero(counters)
        res = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                    max_new=MESH_NEW, engine=False, profile=True,
                    profile_every=8, profile_mesh=(1,), device=dev,
                    _mesh=mesh)
        launches = _launches(counters)
        flash_main += launches[0]
        snap = res.snapshot
        rec = snap.record
        same = bool(np.array_equal(res.tokens, plain.tokens))
        one = rec.calls[0] // snap.steps
        print(f"mesh serve world 1 (nccl): ids == the unprofiled legacy "
              f"serve's: {same}; {snap.steps} steps, calls == steps x one "
              f"step's: {bool((rec.calls == snap.steps * one).all())}; "
              f"launches {launches} (want (22, 0, 0))")
        assert same and snap.steps == MESH_NEW - 1 and rec.n_devices == 1
        assert (rec.calls == snap.steps * one).all()
        assert launches == (22, 0, 0), launches
        _mesh_line(f"serve {ARCH} {BATCH}x{PROMPT}+{MESH_NEW}", 1, "nccl",
                   len(rec.paths), dict(cycle=rec.cycle.tolist(),
                                        skew=rec.skew().tolist()), 0,
                   res.seconds, plain.seconds, res.stats["capture_s"],
                   launches[0])
        # (b) one full-width DP train step under mesh_probe
        model = mesh_ranks.smoke_model(full=True)
        cfg = model.cfg
        params = model.init(0, dev)
        opt = adamw.init(params, cfg.moment_dtype)
        gen = torch.Generator(device=dev).manual_seed(17)
        batch = {k: torch.randint(0, cfg.vocab_size, (MESH_B, MESH_S),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = build_dp_train_step(
            model, TrainConfig(total_steps=10, warmup_steps=1), axis="dev")
        mpf = mesh_probe(step, mesh, (P(), P(), P("dev")), (P(), P(), P()),
                         ProbeConfig(targets=("grads", "grad_exchange",
                                              "optimizer"), depth_limit=2),
                         device=dev)
        mpf.ensure_built(params, opt, batch)
        torch.cuda.synchronize()
        _zero(counters)
        ts = time.perf_counter()
        (p1, o1, m1), state = mpf(params, opt, batch)
        torch.cuda.synchronize()
        probed_s = time.perf_counter() - ts
        launches = _launches(counters)
        flash_main += launches[0]
        ts = time.perf_counter()
        p2, o2, m2 = mpf.unprobed()(params, opt, batch)
        torch.cuda.synchronize()
        unprobed_s = time.perf_counter() - ts
        bitwise = (_tree_equal(torch, p1, p2) and
                   _tree_equal(torch, o1.mu, o2.mu) and
                   _tree_equal(torch, o1.nu, o2.nu) and
                   torch.equal(m1["loss"], m2["loss"]) and
                   torch.equal(m1["grad_norm"], m2["grad_norm"]))
        rec = mpf.decode(state)
        oc = mpf.oracle(params, opt, batch, device=0)
        exact = mesh_ranks._oracle_matches(rec, oc, 0)
        sites = mesh_ranks._sites(mpf)
        ge = [s for s in sites if s[0] == "grad_exchange"]
        print(f"mesh DP train step world 1 (nccl), {ARCH} full width "
              f"(bf16 master params), B {MESH_B} x S {MESH_S}: loss "
              f"{float(m1['loss']):.4f}; outputs == unprobed bitwise: "
              f"{bitwise}; record == ShardOracle: {exact}; grad_exchange "
              f"{len(ge)} all-reduces, G {sorted({s[3] for s in ge})}, wire "
              f"bytes {sum(s[5] for s in ge)}; launches {launches} (want "
              f"(44, 0, 0): forward and remat recompute x 22 layers)")
        assert bitwise and exact and math.isfinite(float(m1["loss"]))
        assert ge and all(s[1] == "all-reduce" and s[3] == 1 and s[5] == 0
                          for s in ge), ge
        assert launches == (2 * cfg.num_layers, 0, 0), launches
        _mesh_line(f"DP train {ARCH} {MESH_B}x{MESH_S}", 1, "nccl",
                   len(rec.paths), dict(cycle=rec.cycle.tolist(),
                                        skew=rec.skew().tolist()),
                   _comm_cycles(sites), probed_s, unprobed_s,
                   mpf.capture_seconds, launches[0])
        del p1, o1, p2, o2, params, opt, state, mpf
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"step 17 world 1 done at {time.perf_counter() - t0:.1f} s")
    # (c) world 2 over gloo, both ranks on this card
    card = str(dev)
    rng = np.random.default_rng(17)
    b2 = {k: rng.integers(0, 257, (4, 64)).astype(np.int32)
          for k in ("tokens", "labels")}
    cols = mesh_ranks.backend_collectives(card, "gloo")
    print(f"gloo on {card} tensors, a world of 2 a kind: {cols} (done at "
          f"{time.perf_counter() - t0:.1f} s)")
    kw = dict(arch=ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
              max_new=MESH_NEW, engine=False, profile=True, profile_every=8,
              profile_mesh=(2,))
    ranks = spawn(mesh_ranks.card_world2_rank, (2,), backend="gloo",
                  device=card, args=(b2, kw))
    w = [r["workload"] for r in ranks]
    wrec = w[0]["record"]
    pid = wrec["paths"].index("dynamic")
    per_dev = [t[pid] for t in wrec["totals"]]
    print(f"mesh skew workload world 2 (gloo): record == ShardOracle on "
          f"every device: {[x['oracle_ok'] for x in w]}, bitwise: "
          f"{[x['bit_ok'] for x in w]}, 3-step session == 3 x one-shot: "
          f"{[x['sess_ok'] for x in w]}; 'dynamic' per device {per_dev}")
    assert all(x["oracle_ok"] and x["bit_ok"] and x["sess_ok"] for x in w)
    assert per_dev[1] > per_dev[0]
    skew = [max(c) - min(c) for c in zip(*wrec["totals"])]
    _mesh_line("skew workload", 2, "gloo", len(wrec["paths"]),
               dict(cycle=wrec["cycle"], skew=skew), _comm_cycles(
                   w[0]["sites"]), w[0]["probed_s"], w[0]["unprobed_s"],
               w[0]["capture_s"], 0)
    d = [r["dp"] for r in ranks]
    dsites = [s for s in d[0]["sites"] if s[0] == "grad_exchange"]
    print(f"mesh DP train step world 2 (gloo), smoke width, head dim 64: "
          f"record == ShardOracle: {[x['oracle_ok'] for x in d]}, bitwise: "
          f"{[x['bit_ok'] for x in d]}, loss {d[0]['loss']:.4f}; "
          f"grad_exchange wire bytes {sum(s[5] for s in dsites)} (G "
          f"{sorted({s[3] for s in dsites})}); flash launches of the probed "
          f"call a rank {[x['flash_launches'] for x in d]} (want 4: forward "
          f"and remat recompute x 2 layers); one all-reduce-mean of the "
          f"smoke gradients {[round(r['allreduce_ms'], 3) for r in ranks]} "
          f"ms a rank")
    assert cols["all-reduce"] == "ok", cols
    assert all(x["oracle_ok"] and x["bit_ok"] for x in d)
    assert dsites and sum(s[5] for s in dsites) > 0
    assert all(x["flash_launches"] == 4 for x in d), d
    drec = d[0]["record"]
    _mesh_line("DP train smoke hd 64", 2, "gloo", len(drec["paths"]),
               dict(cycle=drec["cycle"], skew=[]),
               _comm_cycles(d[0]["sites"]), d[0]["probed_s"],
               d[0]["unprobed_s"], d[0]["capture_s"], d[0]["flash_launches"])
    sr = [r["serve"] for r in ranks]
    srec = sr[0]["record"]
    calls = np.asarray(srec["calls"])
    print(f"mesh serve world 2 (gloo), {ARCH} full width, batch {BATCH} "
          f"split 4/4: ids == the unprofiled serve's: "
          f"{[bool(np.array_equal(r['tokens'], plain.tokens)) for r in sr]}; "
          f"{sr[0]['steps']} steps, devices' calls equal: "
          f"{bool((calls == calls[0]).all())}; launches a rank "
          f"{[r['launches'] for r in sr]}; state {sr[0]['state_nbytes']} B")
    assert all(np.array_equal(r["tokens"], plain.tokens) for r in sr)
    assert (calls == calls[0]).all() and sr[0]["steps"] == MESH_NEW - 1
    assert all(r["launches"] == dict(flash=22, paged=0) for r in sr), sr
    _mesh_line(f"serve {ARCH} {BATCH}x{PROMPT}+{MESH_NEW}", 2, "gloo",
               len(srec["paths"]), dict(cycle=srec["cycle"],
                                        skew=sr[0]["skew"]), 0,
               sr[0]["seconds"], plain.seconds, sr[0]["capture_s"],
               sr[0]["launches"]["flash"])
    # the flash kernel at the DP step's training shape, with statistics
    gen = torch.Generator(device=dev).manual_seed(170)
    q = torch.randn((MESH_B, 32, MESH_S, 64), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((MESH_B, 4, MESH_S, 64), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    out = fa.flash_attention(q, k, v, with_stats=True)[0]
    ref = fa.flash_attention_plain(q, k, v, with_stats=True)[0]
    # teeth: a kernel that ignored the causal mask
    unmasked = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    rel, wrong = rel_err(out, ref), rel_err(unmasked, ref)
    assert torch.isfinite(out.float()).all() and rel <= FLASH_MESH_RTOL, rel
    assert wrong > FLASH_MESH_RTOL, wrong
    ms = time_ms(lambda: fa.flash_attention(q, k, v, with_stats=True))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, with_stats=True), reps=3)
    sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
    lib_ms = time_ms(sdpa)
    flops, nbytes = fa.flash_cost(q, k, v, with_stats=True)
    bnd = bound(nbytes, flops)
    print(f"flash at the mesh DP step's shape (B {MESH_B}, 32/4 heads, S "
          f"{MESH_S}, D 64), with statistics: {ms * 1e3:.1f} us held (bound "
          f"{bnd[0] * 1e3:.2f} us by {bnd[1]}), plain {plain_ms * 1e3:.1f} us,"
          f" SDPA ({how}) {lib_ms * 1e3:.1f} us, max |kernel - plain| "
          f"{err:.3e}, max |plain| {top:.3e}, ratio {rel:.3e} (rtol "
          f"{FLASH_MESH_RTOL}; without the causal mask {wrong:.3e}) ({smi})")
    print(f"step 17 took {time.perf_counter() - t0:.1f} s")
    return _kernel_line(
        f"flash_attention (step 17: the mesh DP train step, {ARCH}, B "
        f"{MESH_B} S {MESH_S}, with statistics, and the mesh serve's "
        f"prefill)", *FLASH_SRC, flash_main, err, ms, plain_ms, bnd, lib_ms)



SHARD_DECODE = 16       # step 18: decode steps of the sharded serve
MOE_B, MOE_S = 1, 512   # step 18 (d): granite-moe (step 15 prefill shape)


class _OpCount:
    """A ``TorchDispatchMode`` counting the aten ops dispatched inside."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                key = str(func.overloadpacket)
                self.n[key] = self.n.get(key, 0) + 1
                return func(*args, **(kwargs or {}))
        return Mode()


def _sharding_line(label, **kw):
    print(f"sharding [{label}]: " + ", ".join(f"{k} {v}" for k, v in
                                               kw.items()), flush=True)


# step 18 (f): a config with padded q heads (minicpm-2b: 36 of 48 real),
# full width at 2 of its 40 layers
PADDED, PADDED_LAYERS = "minicpm-2b", 2


def padded_world1(torch, fa, pa, ssd, dev, smi, batch, mesh, on,
                  sync_wall):
    """Step 18 (f): the auto-sharded train step of ``PADDED`` at world 1
    against its unsharded step, bitwise, with the flash kernel launched
    (2 a layer: the forward and its remat recompute). At world 1 nothing
    splits the padded heads, so the step takes the unsharded attention
    (the kernel over the 36 real heads, the pad heads zero), the path the
    (1, 1) contract holds; a mesh that splits them runs each rank's real
    heads alone (``models.attention._rank_heads``, held on 4 gloo ranks
    in ``tests/test_torch_mesh_contracts.py``). AdamW's scan threshold is
    raised for both steps, so the 122,753-row embedding is updated whole
    (a row at a time it would take minutes); the same update on both
    sides."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    cfg = get_config(PADDED).replace(num_layers=PADDED_LAYERS,
                                     param_dtype="bfloat16")
    assert cfg.resolved_padded_heads > cfg.num_heads
    model = Model(cfg)
    step = build_train_step(model, TrainConfig(total_steps=10,
                                               warmup_steps=1))
    params = model.init(0, dev)
    tokens = {k: v % cfg.vocab_size for k, v in batch.items()}
    threshold = adamw.SCAN_THRESHOLD_BYTES
    adamw.SCAN_THRESHOLD_BYTES = 1 << 40
    try:
        opt = adamw.init(params, cfg.moment_dtype)
        step(params, opt, tokens)                           # warm-up
        _zero(counters)
        (p1, o1, m1), wall1, _ = sync_wall(lambda: step(params, opt, tokens))
        plain_launches = _launches(counters)
        ctx = on(shd.TRAIN_RULES)
        with ctx[0], ctx[1]:
            dp = shd.distribute_params(params, model.schema(), mesh,
                                       shd.TRAIN_RULES)
            dopt = adamw.init(dp, cfg.moment_dtype)
            step(dp, dopt, tokens)                          # warm-up
            _zero(counters)
            (p2, o2, m2), wall2, _ = sync_wall(lambda: step(dp, dopt, tokens))
            launches = _launches(counters)
            p2, o2, m2 = shd.gather((p2, o2, m2))
    finally:
        adamw.SCAN_THRESHOLD_BYTES = threshold
    same = (bool(torch.equal(m1["loss"], m2["loss"])) and
            bool(torch.equal(m1["grad_norm"], m2["grad_norm"])) and
            _tree_equal(torch, p1, p2) and _tree_equal(torch, o1.mu, o2.mu)
            and _tree_equal(torch, o1.nu, o2.nu))
    want = (2 * cfg.num_layers, 0, 0)
    print(f"(f) auto-sharded train step {PADDED} full width ({cfg.num_heads}"
          f" of {cfg.resolved_padded_heads} q heads real), "
          f"{PADDED_LAYERS} of 40 layers, B {MESH_B} S {MESH_S}, bf16 master "
          f"params, TRAIN_RULES on (1, 1): loss {float(m2['loss']):.6f}, grad "
          f"norm {float(m2['grad_norm']):.6f}; == the unsharded step's "
          f"bitwise: {same}; flash launches {launches}, unsharded "
          f"{plain_launches} (want {want}); walls: unsharded "
          f"{wall1 * 1e3:.1f} ms, sharded {wall2 * 1e3:.1f} ms ({smi})")
    assert same, "the padded-head sharded step differs at world 1"
    assert launches == plain_launches == want, (launches, plain_launches)
    _sharding_line(f"train {PADDED} padded heads TRAIN_RULES (1,1)",
                   wall_ms=round(wall2 * 1e3, 1),
                   plain_ms=round(wall1 * 1e3, 1), flash=launches[0],
                   bitwise=same)


# step 18 (g): one model rank's blocks of arctic-480b's padded q heads on
# the 16x16 mesh (56 real of 64, 4 a rank, 7 q heads a kv head): the
# rank of heads 4-7 (kv heads 0, 1, 1, 1) and a rank of pad heads, at
# its train_4k microbatch (B 256 / 16 data ranks / 8 microbatches)
RANK_ARCH, RANK_FIRSTS, RANK_B, RANK_S = "arctic-480b", (4, 56), 2, 4096


def padded_rank_blocks(torch, fa, pa, ssd, dev, smi):
    """Step 18 (g): what a model rank runs for its own block of padded q
    heads under a mesh that splits them (``models.attention._rank_heads``
    hands these bodies each rank's block), on the card's tensors: the
    training flash with its VJP (``_CausalFlash`` with ``heads``) and the
    prefill's (``_attend_real``), for a block of real heads and a block
    of pad heads. Held against attention's plain computation on the same
    inputs: the unsharded path (``causal_flash`` / the flash over all
    real heads, kv not repeated) with the flash's plain version, its
    output's heads of the block, and its gradients from a cotangent that
    is zero outside the block (so kv takes the block's heads' part
    alone; the other heads add exact zeros). Forward within FLASH_ATOL,
    gradients within BWD_RTOL of their largest value; the pad block's
    output and gradients exactly zero. Launches: one a real block's
    forward, none for a block of pad heads."""
    from unittest import mock
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    cfg = get_config(RANK_ARCH)
    H, Hp, n_kv, D = (cfg.num_heads, cfg.resolved_padded_heads,
                      cfg.num_kv_heads, cfg.resolved_head_dim)
    n, S, plan = Hp // 16, RANK_S, (cfg.attn_chunk, cfg.attn_chunk)
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q_all, k, v = rnd(RANK_B, S, H, D), rnd(RANK_B, S, n_kv, D), \
        rnd(RANK_B, S, n_kv, D)
    dout = rnd(RANK_B, S, n, D)
    for first in RANK_FIRSTS:
        real = max(0, min(n, H - first))
        q = torch.cat([q_all[:, :, first:first + real],
                       rnd(RANK_B, S, n - real, D)], dim=2)
        heads = (first, H, cfg.q_per_kv)
        qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
        _zero(counters)
        out = attn._CausalFlash.apply(qk, kk, vk, *plan, heads)
        train_launches = _launches(counters)
        got = torch.autograd.grad(out, (qk, kk, vk), dout)
        _zero(counters)
        pre = attn._attend_real(q, k, v, heads)[0]
        pre_launches = _launches(counters)
        torch.cuda.synchronize()
        if not real:
            zero = all(not t.any() for t in (out, pre, *got))
            print(f"(g) {RANK_ARCH} rank block of pad heads {first}-"
                  f"{first + n - 1}: output and gradients zero: {zero}; "
                  f"flash launches train {train_launches}, prefill "
                  f"{pre_launches} (want 0)")
            assert zero and train_launches == pre_launches == (0, 0, 0)
            continue
        # the plain reference over every real head, the cotangent zero
        # outside the block
        d_all = torch.zeros((RANK_B, S, H, D), dtype=dout.dtype, device=dev)
        d_all[:, :, first:first + real] = dout[:, :, :real]
        qa = q_all.clone()
        qa[:, :, first:first + real] = q[:, :, :real]
        qr, kr, vr = (t.clone().requires_grad_() for t in (qa, k, v))
        with mock.patch.object(attn.kops, "flash_attention",
                               fa.flash_attention_plain):
            ref = attn.causal_flash(qr, kr, vr, *plan)
            want = torch.autograd.grad(ref, (qr, kr, vr), d_all)
            ref_pre = attn.causal_attend(qa, k, v, cfg)
        blk = slice(first, first + real)
        want = (want[0][:, :, blk], want[1], want[2])
        err = max((out[:, :, :real].float() - ref[:, :, blk].float())
                  .abs().max().item(),
                  (pre[:, :, :real].float() - ref_pre[:, :, blk].float())
                  .abs().max().item())
        pads = all(not t[:, :, real:].any() for t in (out, pre, got[0]))
        g_err = max((a.float() - b.float()).abs().max().item() /
                    b.float().abs().max().item()
                    for a, b in zip((got[0][:, :, :real], got[1], got[2]),
                                    want))
        kv_of = sorted({(first + i) // cfg.q_per_kv for i in range(real)})
        print(f"(g) {RANK_ARCH} rank block of q heads {first}-"
              f"{first + n - 1} (kv heads {kv_of}), B {RANK_B} S {S} D {D}"
              f": max |kernel - plain| out {err:.3e} (atol {FLASH_ATOL}), "
              f"gradients max |d| / max |grad| {g_err:.3e} (rtol "
              f"{BWD_RTOL}); pad heads zero: {pads}; flash launches train "
              f"{train_launches}, prefill {pre_launches} (want 1 each) "
              f"({smi})")
        assert err <= FLASH_ATOL and g_err <= BWD_RTOL and pads, (err, g_err)
        assert train_launches == pre_launches == (1, 0, 0)
        assert all(torch.isfinite(g.float()).all() for g in got)


def sharding_phase(torch, fa, pa, ssd, dev, smi):
    """Step 18: logical-axis sharding over DTensor. World 1 over NCCL in
    this process, mesh ("data", "model") = (1, 1): (a) the auto-sharded
    ``build_train_step`` under ``TRAIN_RULES`` against the unsharded step
    at full width (B 4 x S 512, bf16 master params), bitwise, with the
    walls and the DTensor dispatch's host cost; (b) ``remat="dots"``
    against ``"full"``: the step's loss and gradients bitwise, no
    unbatched matmul recomputed, the memory held after the forward and
    the peak of each; (c) ``build_prefill_step`` + 16 steps of
    ``build_decode_step`` under ``SERVE_RULES`` against the unsharded
    legacy serve's ids, and
    ``prefill_microbatches`` 2 against 1; (d) granite-moe's loss through
    the sharded MoE against the local path, bitwise. Then (e) a world of
    2 over gloo on this card: one ``Shard(0)`` -> ``Replicate``
    redistribute of a card tensor, and only if it runs, the smoke
    auto-sharded train step at (1, 2) against the unsharded one, in
    spawned processes beside (b)-(d)."""
    import datetime
    import gc
    import tempfile
    import threading

    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.steps import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step)
    from repro_torch.launch.mesh import make_mesh, spawn
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.testing import mesh_ranks, sharded_ranks
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    print(f"step 18, logical-axis sharding over DTensor, on {smi}")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=dev, timeout=datetime.timedelta(seconds=120))

    def sync_wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, host

    card = str(dev)
    e_out = {}

    def gloo_world2():
        """(e): its own worlds of spawned ranks, so it runs beside (b)-(d)
        (the script's process only waits on it)."""
        try:
            red = spawn(sharded_ranks.redistribute_rank, (2,),
                        backend="gloo", device=card, timeout=60)
            e_out["kind"] = ("ok" if all(r["ok"] for r in red) else
                             "wrong value")
        except RuntimeError as e:
            e_out["kind"] = "crashed (" + str(e).splitlines()[0][:120] + ")"
            return
        if e_out["kind"] == "ok":
            over = dict(compute_dtype="bfloat16", head_dim=64, d_model=256)
            e_out["train"] = spawn(
                sharded_ranks.checks_rank, (1, 2), backend="gloo",
                device=card, args=([((1, 2), ("data", "model"), {
                    "train": dict(over=over)})],))[0]["train"]

    flash_main = 0
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        on = lambda rules: (compat.mesh_context(mesh),   # noqa: E731
                            shd.axis_rules(rules, mesh))
        # (a) the auto-sharded train step against the unsharded one
        model = mesh_ranks.smoke_model(full=True)
        cfg = model.cfg
        tcfg = TrainConfig(total_steps=10, warmup_steps=1)
        step = build_train_step(model, tcfg)
        params = model.init(0, dev)
        gen = torch.Generator(device=dev).manual_seed(18)
        batch = {k: torch.randint(0, cfg.vocab_size, (MESH_B, MESH_S),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        opt = adamw.init(params, cfg.moment_dtype)
        step(params, opt, batch)                            # warm-up
        (p1, o1, m1), wall1, host1 = sync_wall(
            lambda: step(params, opt, batch))
        ctx = on(shd.TRAIN_RULES)
        with ctx[0], ctx[1]:
            dp = shd.distribute_params(params, model.schema(), mesh,
                                       shd.TRAIN_RULES)
            dopt = adamw.init(dp, cfg.moment_dtype)
            with _OpCount() as ops:                         # warm-up
                _, first, _ = sync_wall(lambda: step(dp, dopt, batch))
            n_ops = sum(ops.n.values())
            _zero(counters)
            (p2, o2, m2), wall2, host2 = sync_wall(
                lambda: step(dp, dopt, batch))
            launches = _launches(counters)
            p2, o2, m2 = shd.gather((p2, o2, m2))
        flash_main += launches[0]
        same = (bool(torch.equal(m1["loss"], m2["loss"])) and
                bool(torch.equal(m1["grad_norm"], m2["grad_norm"])) and
                _tree_equal(torch, p1, p2) and
                _tree_equal(torch, o1.mu, o2.mu) and
                _tree_equal(torch, o1.nu, o2.nu))
        print(f"(a) auto-sharded train step {ARCH} full width, B {MESH_B} S "
              f"{MESH_S}, bf16 master params, TRAIN_RULES on (1, 1): loss "
              f"{float(m2['loss']):.6f}, grad norm "
              f"{float(m2['grad_norm']):.6f}; loss, grad norm, params, mu, "
              f"nu == the unsharded step's bitwise: {same}; flash launches "
              f"{launches} (want (44, 0, 0)); walls: unsharded "
              f"{wall1 * 1e3:.1f} ms (host {host1 * 1e3:.1f} ms), sharded "
              f"{wall2 * 1e3:.1f} ms (host {host2 * 1e3:.1f} ms), first "
              f"sharded step (ops counted) {first:.2f} s; {n_ops} aten ops a "
              f"step through "
              f"DTensor, {(host2 - host1) / n_ops * 1e6:.1f} us of host "
              f"each beyond the plain dispatch ({smi})")
        assert same, "the auto-sharded step differs at world 1"
        assert launches == (2 * cfg.num_layers, 0, 0), launches
        _sharding_line("train TRAIN_RULES (1,1)", wall_ms=round(wall2 * 1e3, 1),
                       plain_ms=round(wall1 * 1e3, 1),
                       host_us_per_op=round((host2 - host1) / n_ops * 1e6, 1),
                       flash=launches[0], bitwise=same)
        del p1, o1, p2, o2, dp, dopt, opt
        gc.collect()                 # DTensors in cycles: free them now
        torch.cuda.empty_cache()
        print(f"step 18 (a) done at {time.perf_counter() - t0:.1f} s")
        padded_world1(torch, fa, pa, ssd, dev, smi, batch, mesh, on,
                      sync_wall)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"step 18 (f) done at {time.perf_counter() - t0:.1f} s")
        padded_rank_blocks(torch, fa, pa, ssd, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"step 18 (g) done at {time.perf_counter() - t0:.1f} s")
        # (e) starts now, in its own processes, beside (b)-(d)
        world2 = threading.Thread(target=gloo_world2)
        world2.start()

        # (b) remat="dots" against "full": the step's loss and gradients
        # (what remat changes; the optimizer's peak would hide it)
        res = {}
        for remat in ("full", "dots"):
            m = Model(cfg.replace(remat=remat))
            gc.collect()             # nothing freed inside the measurement
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            _zero(counters)
            leaves = adamw.tree_map(
                lambda p: p.detach().requires_grad_(True), params)
            held = []

            def loss_and_grads():
                loss, _ = m.loss_fn(leaves, batch)
                held.append(torch.cuda.memory_allocated(dev) - base)
                return loss, torch.autograd.grad(loss,
                                                 adamw.tree_leaves(leaves))
            with _OpCount() as ops:
                out, wall, _ = sync_wall(loss_and_grads)
            res[remat] = dict(out=out, wall=wall, mm=ops.n.get("aten.mm", 0),
                              addmm=ops.n.get("aten.addmm", 0),
                              flash=_launches(counters)[0], held=held[0],
                              peak=torch.cuda.max_memory_allocated(dev) - base)
            del leaves
        with torch.no_grad(), _OpCount() as fwd:
            model.loss_fn(params, batch)
        chunks = MESH_S // min(cfg.loss_chunk, MESH_S)
        layer_mm = fwd.n.get("aten.mm", 0) - chunks
        f, d = res["full"], res["dots"]
        same = (bool(torch.equal(f["out"][0], d["out"][0])) and all(
            torch.equal(a, b) for a, b in zip(f["out"][1], d["out"][1])))
        extra = (d["held"] - f["held"]) / 2**30
        print(f"(b) remat dots vs full, loss and gradients of the step: "
              f"bitwise {same}; "
              f"flash launches {f['flash']} / {d['flash']} (want 44 each); "
              f"aten.mm in the step {f['mm']} / {d['mm']}: full recomputes "
              f"the layers' {layer_mm} unbatched products, dots "
              f"{layer_mm - (f['mm'] - d['mm'])} of them (addmm "
              f"{f['addmm']} / {d['addmm']}); held after the forward "
              f"{f['held'] / 2**30:.2f} / {d['held'] / 2**30:.2f} GiB (dots "
              f"{extra:+.2f} GiB; predicted +1.6 GB = 1.49 GiB), peak above "
              f"the params (activations and gradients) "
              f"{f['peak'] / 2**30:.2f} / {d['peak'] / 2**30:.2f} GiB; walls "
              f"{f['wall'] * 1e3:.1f} / {d['wall'] * 1e3:.1f} ms ({smi})")
        assert same and f["flash"] == d["flash"] == 2 * cfg.num_layers
        assert f["mm"] - d["mm"] == layer_mm and f["addmm"] == d["addmm"]
        _sharding_line("remat dots vs full", held_gib=[
            round(f["held"] / 2**30, 2), round(d["held"] / 2**30, 2)],
            peak_gib=[
            round(f["peak"] / 2**30, 2), round(d["peak"] / 2**30, 2)],
            wall_ms=[round(f["wall"] * 1e3, 1), round(d["wall"] * 1e3, 1)],
            mm_recomputed=[layer_mm, layer_mm - (f["mm"] - d["mm"])],
            bitwise=same)
        del res, f, d, params
        torch.cuda.empty_cache()
        print(f"step 18 (b) done at {time.perf_counter() - t0:.1f} s")

        # (c) the serving step builders under SERVE_RULES
        plain = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                      max_new=SHARD_DECODE + 1, engine=False, device=dev)
        smodel = Model(get_config(ARCH))
        sparams = smodel._compute_cast(smodel.init(0, dev))
        prompts = torch.randint(0, smodel.cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32).to(dev)
        cache_len = PROMPT + SHARD_DECODE
        sc = ShapeConfig("serve", cache_len, BATCH, "prefill")
        decode = build_decode_step(smodel)
        ctx = on(shd.SERVE_RULES)
        with ctx[0], ctx[1], torch.no_grad():
            dparams = shd.distribute_params(sparams, smodel.schema(), mesh,
                                            shd.SERVE_RULES)
            _zero(counters)
            (logits, cache), pf_wall, _ = sync_wall(lambda: build_prefill_step(
                smodel, sc)(dparams, {"tokens": prompts}))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            ids = [nxt]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(SHARD_DECODE):
                logits, cache, nxt = decode(dparams, cache, {
                    "tokens": nxt[:, None], "pos": PROMPT + i})
                ids.append(nxt)
            torch.cuda.synchronize()
            dec_wall = (time.perf_counter() - t) / SHARD_DECODE
            launches = _launches(counters)
            placed = str(tuple(cache["k"].placements))
            ids = torch.stack([shd.gather(x) for x in ids], 1).cpu().numpy()
            m2 = Model(get_config(ARCH).replace(prefill_microbatches=2))
            (l2, c2), pf2_wall, _ = sync_wall(lambda: build_prefill_step(
                m2, sc)(dparams, {"tokens": prompts}))
            (l1, c1) = build_prefill_step(smodel, sc)(
                dparams, {"tokens": prompts})
            l1, l2, c1, c2 = shd.gather((l1, l2, c1, c2))
        flash_main += launches[0]
        same = bool(np.array_equal(ids, plain.tokens))
        V = smodel.cfg.vocab_size
        mb_diff = (l1[:, :V] - l2[:, :V]).abs().max().item()
        cache_same = all(torch.equal(c1[k], c2[k]) for k in c1)
        print(f"(c) SERVE_RULES (1, 1) prefill {BATCH}x{PROMPT} + "
              f"{SHARD_DECODE} decode steps, {ARCH} full width: ids == the "
              f"unsharded legacy serve's: {same}; cache placements {placed};"
              f" launches {launches} (want (22, 0, 0)); prefill "
              f"{pf_wall * 1e3:.1f} ms, decode {dec_wall * 1e3:.1f} ms a step"
              f" (the unsharded legacy serve {plain.seconds * 1e3:.1f} ms in "
              f"all); prefill_microbatches 2 vs 1: {pf2_wall * 1e3:.1f} ms, "
              f"max |last logits diff| {mb_diff:.3e} (atol {CHUNK_LOGIT_ATOL}), "
              f"caches equal: {cache_same} ({smi})")
        assert same and launches == (cfg.num_layers, 0, 0), launches
        assert mb_diff <= CHUNK_LOGIT_ATOL
        _sharding_line("serve SERVE_RULES (1,1)",
                       prefill_ms=round(pf_wall * 1e3, 1),
                       decode_ms=round(dec_wall * 1e3, 2),
                       microbatches2_ms=round(pf2_wall * 1e3, 1),
                       ids_equal=same, flash=launches[0])
        del dparams, sparams, cache, c1, c2
        torch.cuda.empty_cache()
        print(f"step 18 (c) done at {time.perf_counter() - t0:.1f} s")

        # (d) granite-moe's loss through the sharded MoE, world 1
        mo = Model(get_config("granite-moe-1b-a400m"))
        mp = mo.init(0, dev)
        mb = {k: torch.randint(0, mo.cfg.vocab_size, (MOE_B, MOE_S),
                               generator=gen, device=dev, dtype=torch.int32)
              for k in ("tokens", "labels")}
        with torch.no_grad():
            (l_loc, _), w_loc, _ = sync_wall(lambda: mo.loss_fn(mp, mb))
            ctx = on(shd.TRAIN_RULES)
            with ctx[0], ctx[1]:
                dmp = shd.distribute_params(mp, mo.schema(), mesh,
                                            shd.TRAIN_RULES)
                (l_sh, _), w_sh, _ = sync_wall(lambda: mo.loss_fn(dmp, mb))
                l_sh = shd.gather(l_sh)
        same = bool(torch.equal(l_loc, l_sh))
        print(f"(d) granite-moe-1b-a400m full width, loss_fn B {MOE_B} S "
              f"{MOE_S}: sharded MoE (shard_map over (1, 1)) "
              f"{float(l_sh):.6f} vs local {float(l_loc):.6f}, bitwise "
              f"{same}; walls {w_sh * 1e3:.1f} / {w_loc * 1e3:.1f} ms")
        assert same
        _sharding_line("moe TRAIN_RULES (1,1)", wall_ms=round(w_sh * 1e3, 1),
                       local_ms=round(w_loc * 1e3, 1), bitwise=same)
        del mp, dmp
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"step 18 world 1 done at {time.perf_counter() - t0:.1f} s")

    world2.join()
    kind = e_out["kind"]
    print(f"(e) gloo on {card} tensors, a world of 2: DTensor Shard(0) -> "
          f"Replicate redistribute (an all-gather): {kind}")
    if kind == "ok":
        r = e_out["train"]
        rel = abs(r["loss"][1] - r["loss"][0]) / abs(r["loss"][0])
        print(f"(e) smoke auto-sharded train step at (1, 2) on the card "
              f"(head dim 64, bf16): loss {r['loss']}, rel {rel:.2e} (2e-3)")
        assert rel < 2e-3
    _sharding_line("gloo world 2 on the card", redistribute=kind)
    print(f"step 18 took {time.perf_counter() - t0:.1f} s")
    return flash_main


# -------------------------------------------------------------- step 19
# (arch, label, seq_len, global_batch, kind, config overrides, flash
# launches): step 19's one-device cells, bf16 master params throughout.
# zamba2 is cut to 12 of its 54 layers (2 groups of 6 ssm layers, each
# followed by the shared attention); qwen2-vl to 1 of 80 layers, trained
# in 2 microbatches (the M-RoPE split). Flash launches a layer call twice
# in training (the forward and its remat recompute): 2 x 22 tinyllama, 2
# x 2 zamba2 (head dim 80), 2 x 1 x 2 microbatches qwen2-vl (head dim
# 128); mamba2 trains through the plain chunked SSD scan (no kernel)
DRY_CELLS = (
    (ARCH, "train_b4", 512, 4, "train", {}, 44),
    (ARCH, "prefill_b8", 512, 8, "prefill", {}, 22),
    (ARCH, "decode_b8", 544, 8, "decode", {}, 0),
    (SSM_ARCH, "train_b4", 512, 4, "train", {}, 0),
    (HYBRID, "train_b2", 512, 2, "train", {"num_layers": 12}, 4),
    (VLM, "train_mb2", 512, 2, "train",
     {"num_layers": 1, "train_microbatches": 2}, 4),
)
# step 19 (b): the production cells traced on the 16x16 fake world, all
# at once, one subprocess each
DRY_WORLD_CELLS = ((ARCH, "train_4k"), (SSM_ARCH, "train_4k"),
                   (HYBRID, "train_4k"), (SSM_ARCH, "long_500k"),
                   (HYBRID, "long_500k"), (BIG_MOE, "train_4k"),
                   (VLM, "train_4k"), (PADDED, "train_4k"),
                   (PADDED, "prefill_32k"))
# JAX's per-device (FLOPs, peak estimate bytes) of the same cells on the
# 16x16 mesh: ``repro.launch.dryrun.lower_cell`` (jax 0.9.0 on a CPU host,
# 512 forced host devices; the JAX package does not run on the card's
# machine), and the factor each record of (b) must lie within: 1.25 for
# FLOPs and peaks, mamba2's long_500k decode at most JAX's FLOPs
JAX_16X16 = {
    (ARCH, "train_4k"): (4.2246531428079e13, 5762898412),
    (SSM_ARCH, "train_4k"): (1.6731768919317e13, 3430453676),
    (HYBRID, "train_4k"): (1.36779747994554e14, 7409552820),
    (SSM_ARCH, "long_500k"): (2.2621436e7, 18352208),
    (HYBRID, "long_500k"): (3.612885854e9, 787292052),
    (BIG_MOE, "train_4k"): (6.51040166292818e14, 36663263068),
    (VLM, "train_4k"): (2.339773657333781e15, 29571940420),
    (PADDED, "train_4k"): (1.1471637702012e14, 9578968044),
    (PADDED, "prefill_32k"): (1.21328954530572e14, 53564926352),
}
DRY_JAX_FACTOR = 1.25
DRY_JAX_FLOPS_FACTOR = {(SSM_ARCH, "long_500k"): 1.0}
# the card's peak over a step (``max_memory_allocated`` above what was
# allocated before it, plus the arguments) against the dry run's
# live-bytes estimate: the caching allocator rounds each block up to 512
# bytes, and an op that takes a workspace from the allocator without a
# dispatched op of its own is not in the estimate. The card read |rel| <
# 5e-5 for the train, prefill and decode steps (NVIDIA H100 80GB HBM3,
# 700 W; the cuBLAS workspace is allocated by the warm-up, before the
# measured call)
DRY_MEM_RTOL = 1e-2
# step 19 (b)'s subprocesses, from the start of step 19 (they run beside
# (a); started together on the card's host they took 30-63 s)
DRY_WORLD_TIMEOUT = 400.0


def dryrun_phase(torch, F, fa, pa, ssd, dev, smi):
    """Step 19: the dry run and the roofline (module docstring). Returns
    the kernels-line entries of the flash shapes its training cells
    launch."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.models import Model
    counters = (fa.flash_attention, pa.paged_attention, ssd.ssd_scan)
    print(f"step 19, the dry run and the roofline, on {smi}")
    t0 = time.perf_counter()
    # (b)'s traces need no card: started first, they run beside (a)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape_name in DRY_WORLD_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape_name, "--mesh", "16x16", "--force"]
        (dryrun.RESULTS_DIR / f"{arch}__{shape_name}__16x16.json").unlink(
            missing_ok=True)
        procs.append((arch, shape_name, cmd, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    flash_train = {}
    for arch, label, S, B, kind, over, flash in DRY_CELLS:
        extra = dict({"param_dtype": "bfloat16"}, **over)
        cfg = get_config(arch).replace(**extra)
        shape = ShapeConfig(label, S, B, kind)
        rec = dryrun.lower_cell(arch, shape, "1", extra_cfg=extra)
        model = Model(cfg)
        step, args = dryrun.build_cell(model, shape, device=dev, seed=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(*args)                    # warm-up: kernels, cuBLAS workspace
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t]
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        card = analyze(step, *args)
        torch.cuda.synchronize()
        launches = _launches(counters)
        del card["result"]
        gc.collect()
        peak = (torch.cuda.max_memory_allocated() - base
                + rec["memory"]["argument_bytes"])
        # tinyllama's wall is the median of 3 steps after the warm-up; the
        # other archs' steps take seconds (AdamW's row scans of their
        # embeddings or unembeddings), so theirs is the warm-up's
        if arch == ARCH:
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(*args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        wall = statistics.median(walls)
        terms = roofline.cell_terms(rec, 1, shape=shape)
        est = rec["memory"]["peak_estimate_bytes"]
        mem_rel = (peak - est) / est
        print(f"(a) {arch} {label} ({B} x {S}, {over or 'full depth'}): "
              f"meta flops {rec['flops_per_device']:.6e} bytes "
              f"{rec['bytes_per_device']:.6e} (trace {rec['trace_s']} s); "
              f"card flops {card['flops']:.6e} bytes {card['bytes']:.6e}; "
              f"collectives {card['collectives']}; launches (flash, paged, "
              f"ssd) {launches}, meta kernel regions "
              f"{rec['kernel_regions']}")
        print(f"(a) {label}: peak measured {peak / 2**30:.3f} GiB vs "
              f"estimate {est / 2**30:.3f} GiB ({peak - est:+d} bytes, rel "
              f"{mem_rel:+.2e}; "
              f"arguments {rec['memory']['argument_bytes'] / 2**30:.3f} "
              f"GiB, temp {rec['memory']['temp_bytes'] / 2**30:.3f} GiB); "
              f"wall {wall * 1e3:.2f} ms, bound "
              f"{terms['bound_step_s'] * 1e3:.3f} ms by {terms['dominant']}"
              f" (compute {terms['compute_s'] * 1e3:.3f}, memory "
              f"{terms['memory_s'] * 1e3:.3f} ms): roofline fraction "
              f"{terms['roofline_fraction']:.4f}, bound / wall "
              f"{terms['bound_step_s'] / wall:.4f}, useful ratio "
              f"{terms['useful_ratio']:.4f}")
        if kind == "train" and arch == ARCH:
            print(f"(a) {label}: model_flops (6 N D) "
                  f"{terms['model_flops']:.6e}, _train_flops "
                  f"{_train_flops(cfg, B, S):.6e}, counted "
                  f"{rec['flops_per_device']:.6e}")
        assert card["flops"] == rec["flops_per_device"], label
        assert card["bytes"] == rec["bytes_per_device"], label
        assert not card["collectives"] and not rec["collectives"], label
        assert launches == (flash, 0, 0), (arch, label, launches)
        assert rec["kernel_regions"].get("flash_attention", 0) == flash
        assert abs(mem_rel) <= DRY_MEM_RTOL, (arch, label, mem_rel)
        assert terms["bound_step_s"] <= wall, (label, terms, wall)
        if kind == "train" and arch != ARCH:
            flash_train[arch] = launches[0]
        _dry_line(f"{arch} {label}", flops=rec["flops_per_device"],
                  card_equal=True, flash=launches[0],
                  peak_gib=round(peak / 2**30, 3),
                  est_gib=round(est / 2**30, 3), mem_rel=f"{mem_rel:+.2e}",
                  wall_ms=round(wall * 1e3, 2),
                  bound_ms=round(terms["bound_step_s"] * 1e3, 3))
        del step, args, card
        gc.collect()
        torch.cuda.empty_cache()
    print(f"step 19 (a) done at {time.perf_counter() - t0:.1f} s")
    hy, vl = get_config(HYBRID), get_config(VLM)
    lines = [
        _kernel_line("flash_attention D80 (zamba2-2.7b training, B 2, 32/32 "
                     "heads, S 512)", *FLASH_SRC, flash_train[HYBRID],
                     *_flash_line(flash_at(
                         torch, F, fa, dev, 2, hy.num_heads,
                         hy.num_kv_heads, 512, 80, 91,
                         f"{HYBRID} training (step 19)", smi))),
        _kernel_line("flash_attention D128 (qwen2-vl-72b training "
                     "microbatch, B 1, 64/8 heads, S 512)", *FLASH_SRC,
                     flash_train[VLM], *_flash_line(flash_at(
                         torch, F, fa, dev, 1, vl.num_heads,
                         vl.num_kv_heads, 512, 128, 92,
                         f"{VLM} training (step 19)", smi)))]

    # (b) the production cells on the 16x16 fake world, started above
    failed = []
    for arch, shape_name, cmd, proc in procs:
        try:
            out, err = proc.communicate(timeout=max(
                30.0, DRY_WORLD_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        sub_s = time.perf_counter() - t0
        print(f"(b) {' '.join(cmd[1:])}: rc {proc.returncode} by "
              f"{sub_s:.1f} s into step 19")
        path = dryrun.RESULTS_DIR / f"{arch}__{shape_name}__16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode or "error" in rec or not rec:
            print(out[-2000:], err[-2000:], rec.get("traceback", ""))
            failed.append((arch, shape_name))
            continue
        terms = roofline.cell_terms(rec, dryrun.CHIPS["16x16"])
        coll = {k: v["wire_bytes"] for k, v in rec["collectives"].items()}
        print(f"(b) {arch} {shape_name} on 16x16 (256 fake ranks): per "
              f"device flops {rec['flops_per_device']:.6e}, bytes "
              f"{rec['bytes_per_device']:.6e}, collective bytes {coll}, "
              f"peak {rec['memory']['peak_estimate_bytes'] / 2**30:.3f} "
              f"GiB, dominant {terms['dominant']} (compute "
              f"{terms['compute_s']:.4f} s, memory {terms['memory_s']:.4f} "
              f"s, collective {terms['collective_s']:.4f} s), useful ratio "
              f"{terms['useful_ratio']:.4f}, trace_s {rec['trace_s']}")
        jax_flops, jax_peak = JAX_16X16[(arch, shape_name)]
        f_max = DRY_JAX_FLOPS_FACTOR.get((arch, shape_name), DRY_JAX_FACTOR)
        peak = rec["memory"]["peak_estimate_bytes"]
        vs_jax = (rec["flops_per_device"] / jax_flops, peak / jax_peak)
        print(f"(b) {arch} {shape_name}: per device flops / JAX's "
              f"{vs_jax[0]:.4f} (limit {f_max}), peak / JAX's "
              f"{vs_jax[1]:.4f} (limit {DRY_JAX_FACTOR}); JAX "
              f"{jax_flops:.6e} FLOP, {jax_peak / 2**30:.3f} GiB")
        _dry_line(f"{arch} {shape_name} 16x16", trace_s=rec["trace_s"],
                  flops=rec["flops_per_device"],
                  bytes=rec["bytes_per_device"], wire=coll,
                  dominant=terms["dominant"],
                  peak_gib=round(peak / 2**30, 3),
                  flops_vs_jax=round(vs_jax[0], 4),
                  peak_vs_jax=round(vs_jax[1], 4))
        if vs_jax[0] > f_max or vs_jax[1] > DRY_JAX_FACTOR:
            failed.append((arch, shape_name, vs_jax))
    print(f"(b) {len(procs)} cells done {time.perf_counter() - t0:.1f} s "
          f"into step 19")
    assert not failed, failed
    print(f"step 19 took {time.perf_counter() - t0:.1f} s")
    return lines


def _flash_line(r) -> tuple:
    """``flash_at``'s result as ``_kernel_line``'s last arguments."""
    return r["err"], r["ms"], r["plain_ms"], r["bound"], r["lib_ms"]


def _dry_line(label, **kw):
    print(f"dryrun [{label}]: " + ", ".join(f"{k} {v}" for k, v in
                                             kw.items()), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import probe_events as kpe
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import flash_attention_ref, ssd_ref
    from repro_torch.launch.serve import serve

    smi = nvidia_smi()
    print(f"card: {smi} ({torch.cuda.get_device_name(0)}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass = {name: sass_counts(so) for name, so in libs.items()}
    for name, counts in sass.items():
        print(f"  {name}: SASS {counts}")
    for name in ("flash_attention", "flash_attention_q64",
                 "flash_attention_q128", "ssd_scan"):
        assert sass[name]["HMMA"] + sass[name]["HGMMA"] > 0, (
            f"the {name} kernels run no tensor-core instruction")
    def done(steps: str) -> None:
        print(f"steps {steps} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    pev = check_probe_events(torch, kpe, dev)
    flash = check_flash(torch, fa, flash_attention_ref, dev)
    paged = check_paged(torch, pa, dev)
    scan = check_ssd(torch, ssd, ssd_ref, dev)
    done("1-5")
    flash_launches, paged_launches = serve_runs(torch, fa, pa, ssd, serve)
    ssd_launches, ssm_plain = serve_ssm(
        torch, (fa.flash_attention, pa.paged_attention, ssd.ssd_scan), serve,
        ssd.KERNELS)
    ssm_consistency(torch, dev)
    done("6-7")
    probed = probe_phase(torch, fa, ssd, kpe, dev)
    done("8")
    pe_launches = probed_engine_phase(torch, fa, pa, kpe, dev)
    profiled_ssm_phase(torch, fa, pa, ssd, serve, ssm_plain, dev)
    done("9-10")
    tr = train_phase(torch, fa, pa, ssd, dev, smi)
    done("11")
    kprobe = kernel_probe_phase(torch, fa, pa, ssd, kpe, dev, smi)
    done("13")
    t_dse = time.perf_counter()
    dse = dse_phase(torch, fa, pa, ssd, kpe, dev, smi)
    print(f"step 14 took {time.perf_counter() - t_dse:.1f} s")
    fam = families_phase(torch, fa, pa, ssd, dev, smi)
    harness = harness_phase(torch, fa, pa, ssd, dev, smi)
    mesh = mesh_phase(torch, fa, pa, ssd, dev, smi)
    sharding_phase(torch, fa, pa, ssd, dev, smi)
    dry = dryrun_phase(torch, F, fa, pa, ssd, dev, smi)
    done("14-19")

    q, k, v = flash["inputs"]
    fl_ms = time_ms(lambda: fa.flash_attention(q, k, v))
    fl_alone = time_ms(lambda: fa.flash_attention(q, k, v), hold=False)
    fl_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5)
    sdpa, how = sdpa_flash(torch, F, q, k, v, 0)
    fl_lib = time_ms(sdpa)
    d_lib = (sdpa().float() - fa.flash_attention(q, k, v).float()
             ).abs().max().item()
    qc, kc, vc = flash["chunk_inputs"]
    ch_ms = time_ms(lambda: fa.flash_attention(qc, kc, vc, q_offset=384))
    ch_plain = time_ms(lambda: fa.flash_attention_plain(qc, kc, vc,
                                                        q_offset=384), reps=5)
    sdpa_c, how_c = sdpa_flash(torch, F, qc, kc, vc, 384)
    ch_lib = time_ms(sdpa_c)
    d_lib_c = (sdpa_c().float() - fa.flash_attention(
        qc, kc, vc, q_offset=384).float()).abs().max().item()
    print(f"SDPA ({how}) vs the kernel: max |diff| {d_lib:.3e}; chunk "
          f"({how_c}): {d_lib_c:.3e}")
    print(f"flash chunk Sq=128 at q_offset 384, Skv=512: {ch_ms * 1e3:.1f} us "
          f"(bound {flash['chunk_bound'][0] * 1e3:.2f} us by "
          f"{flash['chunk_bound'][1]}), plain {ch_plain * 1e3:.1f} us, SDPA "
          f"{ch_lib * 1e3:.1f} us")
    pin, sin_ = paged["inputs"], paged["serve_inputs"]
    pg_ms = time_ms(lambda: pa.paged_attention(*sin_))
    pg_alone = time_ms(lambda: pa.paged_attention(*sin_), hold=False)
    pg_plain = time_ms(lambda: pa.paged_attention_plain(*sin_), reps=5)
    pr_ms = time_ms(lambda: pa.paged_attention(*pin))
    pr_plain = time_ms(lambda: pa.paged_attention_plain(*pin), reps=5)
    print(f"paged at random pos: {pr_ms * 1e3:.1f} us "
          f"(bound {paged['bound'][0] * 1e3:.2f} us by {paged['bound'][1]}),"
          f" plain {pr_plain * 1e3:.1f} us")
    print(f"timed alone, host in the loop: flash "
          f"{fl_alone * 1e3:.1f} us, paged {pg_alone * 1e3:.1f} us; host "
          f"time per wrapper call: flash "
          f"{host_us(lambda: fa.flash_attention(q, k, v)):.1f} us, paged "
          f"{host_us(lambda: pa.paged_attention(*sin_)):.1f} us")
    sin, skw = scan["inputs"], dict(chunk=scan["chunk"],
                                    h_per_g=scan["h_per_g"],
                                    return_final_state=True)
    sc_ms = time_ms(lambda: ssd.ssd_scan(*sin, **skw))
    sc_alone = time_ms(lambda: ssd.ssd_scan(*sin, **skw), hold=False)
    sc_plain = time_ms(lambda: ssd.ssd_scan_plain(*sin, **skw), reps=5)
    print(f"ssd timed alone, host in the loop: {sc_alone * 1e3:.1f} us; host "
          f"time per wrapper call: "
          f"{host_us(lambda: ssd.ssd_scan(*sin, **skw)):.1f} us")
    fw = probed["flash_wall"]["layers/scan#0/layer/attn/flash"]
    fc = probed["flash_calls"]["layers/scan#0/layer/attn/flash"]
    qf, kf, vf = (torch.randn((BATCH,) + t.shape[1:], device=dev).to(
        torch.bfloat16) for t in flash["inputs"])
    fl8_ms = time_ms(lambda: fa.flash_attention(qf, kf, vf))
    sw = probed["ssd_wall"]["layers/scan#0/layer/ssd"]
    sc_calls = probed["ssd_calls"]["layers/scan#0/layer/ssd"]
    print(f"wallclock probe totals beside the kernel times: attn/flash "
          f"{fw / fc / 1e3:.1f} us a call (the kernel alone at B={BATCH}: "
          f"{fl8_ms * 1e3:.1f} us), ssd {sw / sc_calls / 1e3:.1f} us a call "
          f"(the kernels alone: {sc_ms * 1e3:.1f} us)")
    pst, pcodes = pev["state"], pev["codes"]
    launch = kpe.Launcher(pst)      # as the instrumented run launches it
    pe_ms = time_ms(lambda: launch(pcodes, 7))
    # the plain version reads the state on the host: no stream hold
    pe_plain = time_ms(lambda: kpe.probe_events_plain(pst, pcodes, 7),
                       reps=5, hold=False)
    print(f"probe_events one transition: host time per launch "
          f"{host_us(lambda: launch(pcodes, 7)):.1f} us")
    fold = fold_line(torch, fa, kpe, dev, kprobe["folds"])
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:121",
             launches=flash_launches, max_abs_err=flash["err"], ms=fl_ms,
             plain_ms=fl_plain, bound_ms=flash["bound"][0],
             bound_by=flash["bound"][1], library_ms=fl_lib),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:94",
             launches=paged_launches, max_abs_err=paged["err"], ms=pg_ms,
             plain_ms=pg_plain, bound_ms=paged["serve_bound"][0],
             bound_by=paged["serve_bound"][1], library_ms=None),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:83",
             launches=ssd_launches, max_abs_err=scan["err"], ms=sc_ms,
             plain_ms=sc_plain, bound_ms=scan["bound"][0],
             bound_by=scan["bound"][1], library_ms=None),
        dict(name="probe_events", route="cuda",
             source="src/repro_torch/csrc/probe_events.cu",
             replaces="src/repro/core/instrument.py:292",
             launches=pe_launches, max_abs_err=float(pev["err"]),
             ms=pe_ms, plain_ms=pe_plain, bound_ms=pev["bound"][0],
             bound_by=pev["bound"][1], library_ms=None),
        train_kernel(torch, fa, tr),
        fold,
    ] + tile_lines(dse["tiles"], dse["serve_tiles"]) + fam["lines"] + \
        harness + [mesh] + dry
    for kn in kernels:
        print(f"{kn['name']}: {kn['ms'] * 1e3:.1f} us (bound "
              f"{kn['bound_ms'] * 1e3:.2f} us by {kn['bound_by']}), plain "
              f"{kn['plain_ms'] * 1e3:.1f} us, library "
              f"{'-' if kn['library_ms'] is None else round(kn['library_ms'] * 1e3, 1)}"
              f" us, {kn['launches']} launches on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
