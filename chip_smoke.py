#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--tenants 64] [--ticks 4]

Phases, one JSON object per line:

1. setup   — torch and CUDA versions, the card's name and power limit,
             and the port's provenance block
             (``repro_torch.obs.provenance_block(device="cuda")``: git SHA,
             torch, CUDA, backend, the card's name and power limit).
2. build   — compiles the four CUDA kernel sources of the checkout
             (alloc_objective, flash_attention, decode_attention,
             rwkv6_scan) with nvcc into build/repro_torch_kernels/, one
             nvcc each, all started together, and times it.
   flash_build, rwkv_build — each instantiation of flash_attention
             (float32 and bfloat16, dh 16 to 128) and of rwkv6_scan
             (prefill and decode forms, float32 and bfloat16, hs 8 to 64):
             registers and spills from ptxas -v, and its HMMA
             (tensor-core) instructions counted in the library's machine
             code by cuobjdump -sass, where the toolkit has it; fails if
             a flash instantiation or an rwkv6_scan prefill one has none.
3. kernels — every alloc_objective entry (fleet value+gradient, fleet
             value-only, single-problem) on the card at the five shapes the
             replay gives the fleet entries (B = 64 and T = 48, 4, 12 for
             the value form, T = 4, 1 for value+gradient), each on the
             padded bucket and on the unpadded n = 1880, and the
             single-problem entry at S = 128 and at the scenario
             pipeline's S = 72 (6 starts x 12 ladder rungs), against its plain
             PyTorch version on the same inputs (rtol = atol = 1e-4); at
             the padded shapes the kernel's and the plain version's device
             time per call (calls back to back in a CUDA graph, between
             CUDA events; the kernel's launch alone, its wrapper's (B, 8)
             scalar row built beforehand), wall time per call of the
             wrappers (CUDA events around calls from the host), the launch
             plan, and the least time the card could take (bytes at
             3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is
             larger); and the device time of a one-element add, the cost
             of one launch in a CUDA graph.
4. replay  — the port's main path through its entry point:
             ``replay_fleet(make_cloud_catalog(), tenants,
             replay_mode="batched", run_ca_baseline=True,
             ca_engine="vectorized")`` with 64 tenants over the full
             1880-type catalog, 4 ticks (1 cold solve_fleet, 3 warm
             solve_fleet_step), launch counts zeroed just before and read
             just after, and the alloc_objective launches also counted by
             entry and (B, T); the Cluster-Autoscaler baseline on the host, timed
             apart (``ca_s``), with its cost integral, SLO-violation ticks
             and the optimizer's savings against it; then the same replay
             with hot_loop="ref" (the plain PyTorch eq. (1)) on the card,
             which the kernel replay must match to the solver's tolerance
             (per tenant rtol 0.05, fleet aggregate 2e-2, identical per-tick
             satisfaction flags), and the CA baseline once more through its
             sequential per-tenant oracle, whose counts and metrics must
             equal the vectorized engine's for every tenant.
   replay_scored — the kernel replay once more, every alloc_objective
             launch also evaluated by the plain version and by eq. (1) in
             float64: the largest error of each against float64, and of
             the kernel against the plain version, over the 1e-4 tolerance;
             and the replay with eq. (1) in float64 throughout, against the
             plain and the kernel replays (per-tenant cost, tenants whose
             committed counts differ): how near float32 rounding the
             replay gate sits. It fails unless the kernel's f and g are no
             farther from float64 than the plain version's (or within the
             tolerance), and the kernel replay commits the float64
             replay's counts for every tenant at every tick.
5. profile — torch.profiler over one warm tick of the same fleet, cut to
             PROFILE_STEPS = 30 PGD iterations (the tick runs 340; the
             profiler's own processing of the whole tick took ~73 s):
             device busy share, the kernels that take the time, and the
             device time and launches of the alloc_objective kernel.
   kernels also checks and times this slice's shapes at n = 1880: the
             single-problem entry at S = 12 and 1 (a branch-and-bound
             node's ladder and gradient) and S = 48 and 4 (the sequential
             controller's cold tick, 4 starts), and the fleet entries at
             B = 1 (its warm tick: T = 1 value+gradient, T = 12 value).
6. scenarios — the paper's one-shot comparison, the main path of
             alloc_objective's single-problem form: ``optimize`` (6 starts,
             seed 0) on the five scenarios of ``build_scenarios`` over the
             full catalog, once with the kernel and once plain
             (use_kernel=False), launch counts zeroed just before each run
             and read just after, against the Cluster-Autoscaler's median
             cost over seeds 0-2. It fails unless every allocation is
             integral and satisfies its demand, the kernel run's eq. (1) at
             its counts lies within 1e-4 of the plain run's (or both commit
             the same counts), the kernel run launched the single-problem
             form and the plain run nothing, each optimizer cost is at most
             1.05 x the CA's and the mean savings lie in 30-85%
             (tests/core/test_scenarios_api.py).
   bnb     — branch-and-bound: ``optimize(use_bnb=True, n_starts=6,
             seed=0, bnb_nodes=8)`` on s4_memory (24 nodes until the
             priced-scenario phases joined) with the kernel and plain,
             launch counts zeroed just before each run and read just
             after: nodes explored, relaxation solves, incumbent updates,
             gap, wall seconds, launches by entry and shape, and the cost
             against the scenarios phase's multistart answer and the CA
             median. It fails unless every allocation is integral and
             satisfies its demand, used_bnb holds, the kernel run launched
             the single-problem form only and the plain run nothing, the
             two runs are equally feasible, and their answers (eq. (1) at
             the counts) agree within 0.05 or each lies within 0.05 of an
             answer the reference reaches under a one-ulp change of the
             problem (REF_S4_BNB; ``bnb_spread.py`` measures the port's
             spread).
   sequential — the control loop: the first two tenants of the replay
             phase (diurnal, flash_crowd; four until the serving phase
             needed the time) over the full catalog, 4 ticks, CA
             off, replayed with ``replay_mode="sequential"``, with
             ``"batched"`` and ``hot_loop="vmap"``, and with ``"batched"``
             and ``hot_loop="kernel"``; wall, cold and warm solve seconds
             and launches by entry and shape of each. It fails unless the
             sequential and vmap replays commit the same counts for every
             tenant at every tick, bit for bit, and the kernel replay lies
             within rtol 0.05 per tenant and 2e-2 over the fleet of the
             sequential one, with identical satisfaction flags.
   scenario_terms — the priced-scenario path: (a) eq. (1) with all
             three scenario terms attached, the kernel route against the
             plain route (rtol = atol = 1e-4) at the single-problem
             S = 72, n = 3760 and the fleet B = 8, n = 4096, T = 1 and
             12; (b) the three fleets of benchmarks/scenario_bench.py
             (``with_slo_pricing`` 2.0, ``with_priority_classes`` at
             eviction price 0.6, ``make_spot_fleet`` at rate 0.08: n =
             3760, padded to 4096) on the full catalog, 8 tenants, 6 ticks
             (the bench's 24 cut for time), batched, CA on, with the
             kernel and with hot_loop="ref", launch counts zeroed just
             before each run and read just after: cost, SLO ticks, churn,
             savings against the CA; the kernel run within the replay's
             tolerances of the plain one, or, tenant by tenant, of one of
             the plain run's twins under one-ulp demand changes; no
             interrupted spot twin held; (c) ``grid_search`` on
             s3_enterprise with benchmarks/solver_bench.py's 3 x 3 grid,
             kernel and plain, every point's rounded cost within 0.05.
   bucketing — 32 tenants spread over ``instances[::k]``, k in 1, 2, 8,
             40: ``solve_fleet_bucketed`` with the kernel and plain and
             ``solve_fleet`` over one stack padded to 2048, from the same
             starts; seconds, ``padding_stats`` both ways, integer
             objectives within the replay's tolerances with equal
             feasibility. slice_shapes — the kernel at these two phases'
             shapes (n = 4096, the Pareto grid's B = 9, the four
             buckets) against its plain version, timed with its bound.
   mpc     — the receding-horizon controller (``repro_torch.horizon``) on
             the scenario fleet before pricing (8 tenants, diurnal and
             flash_crowd) over the full catalog (n = 1880 in the bucket's
             2048), the first 3 ticks (1 cold, 2 warm) of its 6, batched,
             CA off: (a)
             ``replay_fleet(controller="mpc", horizon=1)`` with the kernel
             commits the myopic batched kernel replay's counts for every
             tenant and tick; (b) ``horizon=8``, ``forecaster=
             "last_value"``, the adaptive engine, with the kernel
             (``run_oracle_baseline=True``) and with hot_loop="ref",
             launch counts zeroed just before each run and read just
             after: cost, churn, SLO ticks, the kernel run's regret
             against its oracle twin, cold and warm tick
             seconds, PGD iterations per warm tick, launches by entry and
             shape (the window's B x H = 64 stack at T = 1 and 12); held
             as the scenario replays are, one-ulp twins included; (c) one
             ``solve_horizon_fleet_step`` with the ADMM engine and
             ``capture_trace=True`` on (b)'s tick-1 windows, kernel and
             plain: the worst lane's residual histories, the committed
             counts held at the replay's tolerances; (d) torch.profiler
             over one adaptive warm step on those windows, 60 iterations
             (device busy share, launches). obs_export — no new replay:
             the myopic batched kernel replay of (a), recorded under
             ``telemetry()``, written with ``write_jsonl`` and
             ``write_chrome_trace`` to a temporary directory, both files
             revalidated, and rolled up by ``ReplayReport``; and
             ``admm_trace_summary`` of each lane of (c)'s traced kernel
             step. It fails on a validation problem, a report without a
             ``replay/tick`` span or with other tick counts than the
             replay's, a ``replay/stack`` span without its
             ``stack/padding_waste`` sample, or a summary whose first and
             final residuals or outer iterations are not those of
             ``admm_residual_history``. mpc_shapes — the
             kernel at the window's B x H = 64 and the ADMM planned
             prox's B x (H - 1) = 56 stacks (n = 2048; T = 1 value and
             gradient, T = 12 value) against its plain version, timed
             with its bound.
   serve_alloc — the online allocation service (``repro_torch.serve``):
             the demo session of ``python -m repro_torch.serve`` (full
             catalog, SERVE_LANES = 4 of its 8 lanes, 24 ticks, flash-crowd
             demand, a departure at tick 12) (a) with the kernel and
             plain, no deadline: the
             same decisions, each objective within 0.05 and the sum within
             2e-2, equal feasibility and staleness; p50 and p99 tick
             latency, cold-join and warm-tick seconds, launches by entry
             and shape; (b) with the kernel under half of (a)'s median
             warm-tick time: every decision feasible, one at least
             truncated, no warm solve past its budget by more than its
             longest chunk and its fixed work; miss and truncation rates;
             (c) the degradation sweep of benchmarks/serve_bench.py at the
             full catalog (budgets 0.5-64 ms, chunks of 8, a fake clock at
             0.25 ms a reading, demand x3, delta_max 64), kernel and plain:
             the bench's five checks for each, the two within 0.05 at
             every budget, the generous budget bit for bit the untruncated
             solve; (d) 2 lanes, 3 ticks with HealthMonitor(kkt_every=1):
             every decision's KKT stationarity residual finite, each
             certificate timed. The kernels
             phase also times the warm tick's shapes (B = 8, n = 1880:
             T = 1 value+gradient, T = 12 value).
7. attention — the flash_attention and decode_attention kernels on the card
             against their plain PyTorch versions (on the float32 values of
             the same inputs; rtol = atol = 2e-4 in float32, 2e-2 in
             bfloat16), at qwen1.5-4b's serving shapes and at shapes that
             cover GQA, the sliding window, a ragged S, part-filled and
             ring-buffer validity and bfloat16, and at mixtral-8x22b's
             (prefill (8, 1024, 48/8, window 4096), decode (8, 48/8,
             1056 slots)); in float32 each kernel and its plain version
             are also held to the plain version in float64 (rms error over
             the float64 output's rms): a flash kernel's within F64_RATIO
             times the plain version's, a decode kernel's reported; for
             each: device and wall ms
             of the kernel, of its plain version and of
             torch.nn.functional.scaled_dot_product_attention on the same
             inputs (timed only, on no path of the port), each timed over
             rotating copies of its inputs so that every call finds the L2
             cache cold, as a layer of the served model does; the least time
             the card could take (bytes at 3.35 TB/s or operations at the
             peak rate of the kernel's route, whichever is larger: flash in
             float32 as 3xTF32, three TF32 products at 495 TFLOP/s for each
             product, with the FP32-pipe figure at 67 TFLOP/s beside it;
             bfloat16 at 989 TFLOP/s; decode_attention in float32 at
             67 TFLOP/s).
8. serve   — the second main path: qwen1.5-4b at full width and depth
             (40 layers, d_model 2560, float32, random weights from --seed)
             through ``init_model``, ``make_prefill_step`` and
             ``make_decode_step``: 8 prompts of 1024 tokens, then 32
             greedy decode steps; launch counts zeroed just before
             and read just after (one flash launch per layer per prefill,
             one decode launch per layer per step). Then (a) the same tokens
             through the plain path (use_kernel=False) on the card,
             teacher-forced with the kernel run's tokens, and (b) forward
             over prompt + generated tokens: every step's logits must agree
             at rtol = atol = 2e-3. Prefill ms, decode ms per token,
             tokens/s, peak memory, and the device busy share and top
             kernels of one decode step and of one prefill (torch.profiler,
             each window opened by a primer of spin kernels that the sums
             leave out).
9. rwkv    — the rwkv6_scan kernel on the card against its plain PyTorch
             version (the chunked closed form, on the float32 values of the
             same inputs; rtol = atol = 1e-3 in float32, 2e-2 in bfloat16),
             every case with a nonzero bonus u and state s0: rwkv6-7b's
             prefill shape (timed for the kernels line), its decode shape
             (S = 1, chunk 1: the kernel's decode form), a ragged S =
             1056, decays in [0.02, 0.5] (the clamp at e^-60 bites), head
             size 16 with chunk 16, and
             bfloat16; kernel and plain device ms over rotating input
             copies, and the bound: bytes at 3.35 TB/s or operations on
             the kernel's route, whichever is larger (the prefill form's
             products as 3xTF32, three TF32 products for each at
             495 TFLOP/s, with the FP32-pipe figure at 67 TFLOP/s beside
             it; the decode form forms no products). PyTorch has no one
             call that computes WKV, so there is no library time. Every
             float32 prefill case (S > 1) is also held to the chunked form
             in float64: the kernel's rms error, of y and of the final
             state, within F64_RATIO times the plain version's.
10. serve_rwkv — the third main path: rwkv6-7b at full width and depth (32
             layers, d_model 4096, float32, random weights from --seed,
             with u drawn from N(0, 0.5) and w_base spread over [-6, -1]
             across channels) through the same step functions and prompts
             as phase 8, after phase 8's weights are freed: one rwkv6_scan
             launch per layer per prefill and per decode step, no other
             kernel. The random model moves its own logits past 2e-3
             under float32-sized perturbations, so end to end the logits
             are held to a measured yardstick: the plain path run three
             more times with the embedding table perturbed by 1e-7 of
             itself; the kernel path's logits must lie no farther from the
             plain path's and from forward's than the farthest of those,
             and each greedy token must be their argmax but at a near tie
             (within twice the largest perturbed difference). And per
             layer, through the model's on_layer hook: the prefill, every
             decode step and forward over prompt + generated tokens run
             again, each time-mix block also run plain on the same input
             and cache; output and new state must agree at rtol = atol =
             2e-3.

11. serve_moe — the fourth main path: mixtral-8x22b at full width (d_model
             6144, 48/8 heads, 8 experts top-2 of d_ff 16384, window 4096,
             float32), its depth cut to its first MOE_LAYERS = 4 of 56
             layers (the record's ``reduced``; 10.4 B parameters), through
             the same step functions and prompts as phase 8, after phase
             10's weights are freed: one flash launch per layer per prefill,
             one decode launch per layer per step, no other kernel. The
             prefill's MoE runs in capacity mode (B S K = 16384 > 4096,
             C = 320), each decode step dropless (C = 2); every routing is
             recorded (``RoutingLog``): the share of prefill assignments
             dropped, none in decode. Each attention block of the prefill,
             every decode step and forward over the prompt runs again plain
             on the same input and must agree at 2e-4 (ATTN_TOL); forward
             over the prompt must agree with the prefill at 2e-3 (over
             prompt + generated tokens it would run another capacity). End
             to end (``moe_end_to_end``): within SERVE_TOL of the plain
             path; or every routing parting a near tie, no logit past
             SERVE_TOL in a row before its parting, and the kernel path
             within SERVE_TOL or the measured yardstick of the plain path
             forced onto its routing (the plain path under 1e-7 embedding
             noise, NOISE_SEEDS draws). Reported beside it: the prefill
             with its attention in float64 (``float64_attention``), and
             how far the kernel path and the plain path each lie from it.
             Prefill ms, decode ms a step, peak memory, profiles as phase
             8's.
12. mamba  — one Mamba block at jamba-1.5-large's full width (d_model
             8192, d_inner 16384, N 16, dt_rank 512): 8 x 1024 prefill from
             a zeroed MambaCache, 32 one-token steps, against the block
             over all 1056 tokens at 2e-3; prefill ms, decode ms a step,
             peak memory. (Jamba whole does not fit one card at full width:
             a period of 8 layers holds four 16-expert FFNs of 38.7 GB each
             in float32.)
13. families — every registered config at reduced() size (d_head 16): 2
             prompts of 40 tokens and 8 decode steps, kernel route against
             plain (launch.routes.check_routes; 2e-4 prefill, 2e-3 decode, 3e-3 for mixtral with its
             window cut to 32 so the ring wraps), launches counted per
             attention and RWKV layer, none on the plain route.
14. train  — the fifth main path: training on the plain route (the
             kernels have no backward), float32, after every earlier
             phase's memory is freed (``train_checks``): (a) qwen1.5-4b at
             full width and depth (40 layers, 3.95 B parameters, remat
             "full") through ``repro_torch.launch.train.train``, the
             launcher's loop: 3 steps of 8 x 128 (the reference
             launcher's), one more under torch.profiler (busy share, top
             operations), one of 1 x 2048 (past 1024 the attention is
             ``_chunked_flash`` under remat); per step loss, grad norm,
             lr, seconds, peak GiB and kernel launches; fails unless every
             loss and grad norm is finite, every parameter leaf moved,
             step 0's loss equals ``loss_fn`` under no_grad within 1e-5
             relative and no kernel launched; (b) 2 of its layers at full
             width, one step in float32 and in float64 (``float64_model``):
             loss, every gradient leaf, m and v within TWIN_TOL; (c)
             ``_chunked_flash`` against ``_sdpa`` at (1, 2048, 20/20, 128),
             outputs and q/k/v gradients at 2e-4, both against float64;
             (d) every kernel wrapper refuses operands that require grad.
15. distributed — the distributed substrate in a world of one over NCCL
             (``distributed_checks``; one card, so multi-rank behaviour is
             held to the reference by the CPU tests over gloo): (a)
             ``ElasticFleet`` on make_tpu_catalog() (n = 18), the
             reference test's job: the initial plan, a replan after 30%
             of the fleet fails, examples/autoscale_controller.py's seven
             load scales, with the alloc_objective kernel and plain (equal
             counts, or the kernel run's those of a plain run with the
             job's FLOPs one ulp away), launches by shape, each launched
             shape timed against plain (its rows on the kernels line); (b)
             int8 gradient compression at a qwen1.5-4b leaf's shape (2560
             x 6912): ``compressed_psum`` equal to ``compress_decompress``,
             50 error-feedback steps with the running sum within one
             quantisation step; (c) ``launch.train.train`` on a 1x1 mesh
             (DTensor state) against the one-device loop, qwen1.5-4b at
             full width and 2 layers, 3 steps of 8 x 128 (loss, grad norm
             at 2e-4; parameters at rtol 2e-4, atol 2e-4 x the leaf's
             largest element); (d) ``TrainingSupervisor.run`` around the
             1x1 launcher on the reduced config: one failure injected
             after the first committed checkpoint, the ``replan_shards``
             hook asking (a)'s fleet, the resumed steps' losses against an
             uninterrupted run's at 2e-4. (d) is at reduced size: a
             checkpoint of qwen1.5-4b at full width holds about 47 GB
             (3.95 B parameters and both moments in float32), too long to
             write within the smoke's time.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
L2_BYTES = 50e6               # H100 L2 cache
PRIMER = 32                   # spin kernels that open a profiler window
RTOL = ATOL = 1e-4            # kernel vs plain (tests/kernels/test_kernels.py:32)
TENANT_RTOL, FLEET_RTOL = 0.05, 2e-2   # tests/fleet/test_solve_fleet.py:113-117
# attention kernel vs plain (tests/kernels/test_kernels.py:10-11)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# served logits vs plain path and forward (tests/models/test_model_parts.py:40)
SERVE_TOL = 2e-3
NOISE_SEEDS = 3               # perturbed plain runs: the measured yardstick
# a float32 kernel's rms error against float64 over plain float32's on the
# same inputs: the float32 routes are meant to round as float32 does, and
# twice allows for another order of summation (a float32 flash kernel that
# summed in the tensor cores' truncating accumulators reached 8-10 x)
F64_RATIO = 2.0
# kernel vs plain (tests/kernels/test_kernels.py:138-139); bf16 outputs round
RWKV_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
SERVE_ARCH = "qwen1.5-4b"
RWKV_ARCH = "rwkv6-7b"
# mixtral-8x22b at full width, its depth cut to MOE_LAYERS of 56: 4 layers
# hold 10.4 B parameters (41.7 GB in float32), all 56 would hold 564 GB
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 4
# one Mamba block at jamba-1.5-large's full width
MAMBA_ARCH = "jamba-1.5-large-398b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 1024, 32
# the scenario comparison as tests/core/test_scenarios_api.py makes it:
# optimize's starts (:14), the CA's median over seeds 0-2 (:15-18),
# optimizer cost <= 1.05 x the CA's (:36), mean savings in percent (:54)
SCENARIO_STARTS, CA_SEEDS, CA_SLACK = 6, 3, 1.05
SAVINGS_BAND = (30.0, 85.0)
FUN_RTOL = 1e-4               # kernel vs plain optimize: eq. (1) at the counts
# branch-and-bound runs (scenario, engine, use_kernel): s4_memory, where
# the search changes the reference's answer most, kernel and plain (a
# kernel run of s3_enterprise, the other such scenario, was cut for time)
BNB_RUNS = (("s4_memory", "kernel", True), ("s4_memory", "plain", False))
# the search's node budget: 8 since the priced-scenario phases joined the
# smoke (the default 24 took 88-110 s a run on the card, 12 took 71-81 s)
BNB_NODES = 8
# eq. (1) at the counts optimize(use_bnb=True, n_starts=6, seed=0,
# bnb_nodes=BNB_NODES) commits on s4_memory in the reference, on the
# unchanged problem ("none") and with c or d scaled by 1 +- 2^-23 (each
# entry moves by at most one float32 ulp; tests/test_torch_bnb_spread.py
# reproduces them): a one-ulp change moves the reference's own answer by
# 7.6%, past TENANT_RTOL
REF_S4_BNB = {"none": 0.5812824368476868, "c+": 0.6254016757011414,
              "c-": 0.6254016757011414, "d+": 0.6254016757011414,
              "d-": 0.5812824368476868}
# the sequential phase's engines (name, replay_mode, hot_loop) and tenants
SEQUENTIAL_RUNS = (("sequential", "sequential", "kernel"),
                   ("vmap", "batched", "vmap"),
                   ("kernel", "batched", "kernel"))
SEQUENTIAL_TENANTS = 2        # the first two (diurnal, flash_crowd)
# the profiled warm tick's PGD iterations (the tick runs 340 to converge;
# torch.profiler's processing grows with the launches, ~360 an iteration)
PROFILE_STEPS = 30
# the serving demo of ``python -m repro_torch.serve`` (lanes, ticks, base
# demand) and the degradation sweep's budgets (benchmarks/serve_bench.py);
# 4 of the demo's 8 lanes since the train phase joined (each lane's cold
# join took ~5 s of every session, three sessions)
SERVE_LANES, SERVE_TICKS = 4, 24
HEALTH_LANES = 2              # the health-monitored session's lanes
SERVE_BASE = [8.0, 16.0, 4.0, 100.0]
DEGRADATION_BUDGETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0)
SERVE_SLACK_MS = 1.0          # host time a warm solve may add past its chunk
REPLACES = {
    "alloc_objective_fleet": "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective_fleet_value":
        "src/repro/kernels/alloc_objective/kernel.py:136",
    "alloc_objective": "src/repro/kernels/alloc_objective/kernel.py:102",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:82",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:56",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:73",
    "rwkv6_scan_decode": "src/repro/kernels/rwkv6_scan/kernel.py:73",
}
# (B, S, H, G, dh, window, dtype): qwen1.5-4b's prefill shape first (timed
# for the kernels line), mixtral-8x22b's, then GQA with nemotron-4-15b's
# heads, a sliding window, a ragged S and bfloat16
FLASH_CASES = {
    "qwen-prefill": (8, 1024, 20, 20, 128, 0, "float32"),
    # mixtral-8x22b's prefill (the window, 4096, is longer than the prompt)
    "mixtral-prefill": (8, 1024, 48, 8, 128, 4096, "float32"),
    "gqa-48/8": (2, 1024, 48, 8, 128, 0, "float32"),
    "window-256": (2, 1024, 20, 20, 128, 256, "float32"),
    "odd-S-1000": (2, 1000, 20, 20, 128, 0, "float32"),
    "bf16": (8, 1024, 20, 20, 128, 0, "bfloat16"),
}
# (B, S_max, H, G, dh, valid, dtype); valid is "last" (every slot, the
# serving run's last step), "prefix:n" (slots < n: a part-filled cache or a
# ring buffer before its wrap) or "band:n" (the n slots before S_max: a
# sliding window)
DECODE_CASES = {
    "qwen-decode": (8, 1056, 20, 20, 128, "last", "float32"),
    "part-filled": (8, 1056, 20, 20, 128, "prefix:700", "float32"),
    "ring-250": (8, 250, 20, 20, 128, "prefix:181", "float32"),
    "window-256": (8, 1056, 20, 20, 128, "band:256", "float32"),
    # mixtral-8x22b's decode: its 1056-slot ring (min(s_max, window))
    # full at the last step
    "gqa-48/8": (8, 1056, 48, 8, 128, "last", "float32"),
    "bf16": (8, 1056, 20, 20, 128, "last", "bfloat16"),
}
# (B, S, H, hs, chunk, (w_lo, w_hi), dtype): rwkv6-7b's prefill and decode
# shapes first (timed for the kernels line), then a ragged S, decays strong
# enough that the clamp bites, head size 16 and bfloat16
RWKV_CASES = {
    "rwkv-prefill": (8, 1024, 64, 64, 64, (0.7, 0.999), "float32"),
    "rwkv-decode": (8, 1, 64, 64, 1, (0.7, 0.999), "float32"),
    "ragged-1056": (8, 1056, 64, 64, 64, (0.7, 0.999), "float32"),
    "clamp": (8, 1024, 64, 64, 64, (0.02, 0.5), "float32"),
    "hs16-chunk16": (8, 1024, 256, 16, 16, (0.7, 0.999), "float32"),
    "bf16": (8, 1024, 64, 64, 64, (0.7, 0.999), "bfloat16"),
}
# the priced-scenario fleets of benchmarks/scenario_bench.py::_fleet on
# the full catalog (base demand x 25, noise 0.08, 2 starts, churn 6),
# 6 ticks (1 cold, 5 warm) of the bench's 24, and solver_bench's grid
SCENARIO_TENANTS, SCENARIO_TICKS = 8, 6
SCENARIO_BASE = [8.0, 16.0, 4.0, 100.0]
SCENARIO_PRIORITIES = [("critical", "standard", "batch")[i % 3]
                       for i in range(SCENARIO_TENANTS)]
EVICTION_PRICE = 0.6
GRID_ALPHAS, GRID_GAMMAS = (0.005, 0.02, 0.1), (0.001, 0.005, 0.02)
L_RUNGS = 12                  # SolverConfig().n_backtracks
# demand scalings 1 + k 2^-23 of the plain replay's one-ulp twins: where a
# scenario replay rests on near-tied roundings, a tenant that parts from
# the plain replay is held to the answers those twins reach (the
# priority fleet's tenant 2 does; tests/test_torch_scenario_spread.py
# shows the reference's own answer there moving by 22% under one ulp)
ULP_STEPS = (1, -1)
# the receding-horizon phase: the scenario fleet (unpriced) and the
# reference's default window, 3 ticks (1 cold, 2 warm) of its traces' 6:
# a warm tick takes 4-9 s and the phase replays the fleet three times
# (kernel with its oracle twin, plain), which more ticks would lift past
# the smoke's margin under 1200 s on a slower host;
# MPC_PROFILE_STEPS bounds the profiled warm step (torch.profiler's
# event processing grows with its launches)
MPC_HORIZON, MPC_TICKS, MPC_PROFILE_STEPS = 8, 3, 60
# the train phase: qwen1.5-4b at full width and depth, the reference
# launcher's batch and sequence (8 x 128) for TRAIN_STEPS steps, then one
# step of 1 x TRAIN_LONG_SEQ (past 1024: _chunked_flash under remat); the
# float64 twin at TWIN_LAYERS of its 40 layers, held at TWIN_TOL (max
# |error| of a leaf over its largest float64 element; v squares the
# gradient, so twice the gradient's)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen1.5-4b", 8, 128, 3
TRAIN_LONG_SEQ, TRAIN_LR, TWIN_LAYERS = 2048, 1e-3, 2
TWIN_TOL = {"loss": 1e-5, "grad": 2e-4, "m": 2e-4, "v": 4e-4}
# the distributed phase: (a) ElasticFleet on make_tpu_catalog() with the
# reference test's job (tests/distributed/test_substrates.py), 30% of the
# fleet failed, then examples/autoscale_controller.py's seven load scales;
# (b) int8 compression at a qwen1.5-4b gradient leaf's shape, 50 error-
# feedback steps; (c) the launcher on a 1x1 mesh against the one-device
# loop, TRAIN_ARCH at full width and MESH_LAYERS layers, TRAIN_BATCH x
# TRAIN_SEQ, MESH_STEPS steps, at MESH_TOL (loss, grad norm; parameters at
# rtol MESH_TOL and atol MESH_TOL x the leaf's largest element, a key bias,
# whose gradient is rounding noise, at 10x); (d) the supervisor's restart
# loop around the launcher on the reduced config, SUPERVISED_STEPS steps,
# a checkpoint every SUPERVISED_EVERY, one failure at SUPERVISED_FAIL
ELASTIC_JOB = dict(name="train-104b", hlo_flops=2.5e16, hlo_bytes=1e14,
                   collective_bytes=5e12, bytes_per_device=8e9, devices=256,
                   step_budget_s=1.0)
ELASTIC_FAILED, ELASTIC_SCALES = 0.3, (1.0, 1.3, 1.8, 1.4, 0.8, 0.6, 1.0)
COMPRESS_SHAPE, COMPRESS_STEPS = (2560, 6912), 50
MESH_LAYERS, MESH_STEPS, MESH_TOL = 2, 3, 2e-4
NOISE_LEAVES = ("bk",)
SUPERVISED_STEPS, SUPERVISED_EVERY, SUPERVISED_FAIL = 6, 2, 3
# the bucketed fleet: tenants spread over instances[::k] of the catalog
BUCKET_TENANTS, BUCKET_STRIDES = 32, (1, 2, 8, 40)
# base demands of examples/fleet_replay.py's four tenants, by trace kind
BASES = {"diurnal": [8, 16, 4, 100.0], "flash_crowd": [4, 8, 2, 50.0],
         "ramp": [6, 24, 3, 150.0], "weekly": [16, 64, 6, 300.0]}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time per call of ``fn()``, back to back: ``reps`` calls
    captured into one CUDA graph and the graph replayed between CUDA events,
    so no host time lies between the launches. (Not torch.profiler's
    per-kernel sums: the profiler misses the first launches of a window.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def call_ms(fn, reps: int = 50) -> float:
    """Mean wall time per call of ``fn()`` between CUDA events: the device
    time plus whatever host time the launches leave the device idle."""
    import torch
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kern, plain, launch=None) -> dict:
    """The kernel and its plain version, each by device time (back to back
    in a CUDA graph) and by wall time per call (host included). ``launch``,
    where given, launches the kernel alone (no operand set-up on the card)
    and is what the device time is taken of."""
    return {"ms": device_ms(launch or kern), "plain_ms": device_ms(plain),
            "call_ms": call_ms(kern), "plain_call_ms": call_ms(plain)}


def profile_once(fn, top_n: int = 6, match: str | None = None) -> dict:
    """Run ``fn()`` once under torch.profiler: wall ms (host clock to a
    synchronize), the summed device time of the CUDA kernels, the busy
    share, the launch count, the kernels that take the most time and, if
    ``match`` is given, the device ms and count of the kernels whose name
    holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a primer of PRIMER short spin kernels, left out of the sums: the
        # profiler has been seen to miss the first launches of a window
        for _ in range(PRIMER):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    primer_seen = sum(e.count for e in events if "spin_kernel" in e.key)
    events = [e for e in events if "spin_kernel" not in e.key]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:top_n]
    matched = {}
    if match is not None:
        hits = [e for e in events if match in e.key]
        matched = {"matched": {
            "name": match, "count": sum(e.count for e in hits),
            "ms": sum(e.device_time_total for e in hits) / 1e3}}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, **matched,
            "primer_launches_seen": [primer_seen, PRIMER],
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "device_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                     "count": e.count} for e in top]}


def bound(nbytes, flops, flops_per_s) -> dict:
    """The least time the card could take: bytes at the memory rate or
    operations at the peak rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def make_tenants(TenantSpec, make_trace, n: int, ticks: int, seed: int):
    """``n`` tenants cycling over the four trace kinds of
    examples/fleet_replay.py, base demands drawn around that example's."""
    import numpy as np
    rng = np.random.default_rng(seed)
    kinds = list(BASES)
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        base = np.asarray(BASES[kind]) * rng.uniform(0.5, 2.0, size=4)
        out.append(TenantSpec(
            name=f"{kind}-{i}",
            trace=make_trace(kind, base, ticks, seed=seed * 1000 + i),
            delta_max=16.0 if kind == "flash_crowd" else 8.0))
    return out


def kernel_bound(B, T, n, m, p, with_grad):
    """(bound_ms, bound_by, bytes, flops): each input read once, each output
    written once; flops of the two passes over n."""
    elems = (B * T * n + B * m * n + B * p * n + B * n + B * m + B * 8
             + B * T + (B * T * n if with_grad else 0))
    flops = B * T * (2 * (m + p + 1) * n
                     + (2 * (m + p) * n if with_grad else 0))
    t_bytes = 4 * elems / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", 4 * elems, flops)


def scored_replay(ops, ref, run_replay) -> dict:
    """Run ``run_replay()`` with every alloc_objective launch also evaluated
    by the plain version and by eq. (1) in float64 on the same inputs; the
    largest error of the kernel's and of the plain version's f and g against
    float64, over the 1e-4 tolerance, and of the kernel against the plain
    version: how near float32 rounding the replay gate sits."""
    worst = collections.defaultdict(float)
    launch = ops._launch

    def over(got, want):
        return float(((got.double() - want.double()).abs()
                      / (ATOL + RTOL * want.double().abs())).max())

    def scored(entry, X, K, E, c, d, scal, with_grad):
        f, g = launch(entry, X, K, E, c, d, scal, with_grad)
        params = [scal[:, i] for i in range(5)]
        args = (X, K, E, c, d, *params)
        if with_grad:
            got = {"kernel": (f, g),
                   "plain": ref.alloc_objective_fleet_ref(*args)}
            f64, g64 = ref.alloc_objective_fleet_ref(
                *(t.double() for t in args))
        else:
            got = {"kernel": (f, None),
                   "plain": (ref.alloc_objective_fleet_value(*args), None)}
            f64, g64 = ref.alloc_objective_fleet_value(
                *(t.double() for t in args)), None
        for who, (fv, gv) in got.items():
            worst[f"{who}_f_vs_float64"] = max(worst[f"{who}_f_vs_float64"],
                                               over(fv, f64))
            if with_grad:
                worst[f"{who}_g_vs_float64"] = max(
                    worst[f"{who}_g_vs_float64"], over(gv, g64))
        worst["kernel_f_vs_plain"] = max(worst["kernel_f_vs_plain"],
                                         over(f, got["plain"][0]))
        if with_grad:
            worst["kernel_g_vs_plain"] = max(worst["kernel_g_vs_plain"],
                                             over(g, got["plain"][1]))
        return f, g

    ops._launch = scored
    try:
        run_replay()
    finally:
        ops._launch = launch
    return dict(worst)


def float64_replay(ops, ref, run_replay):
    """``run_replay()`` with every eq. (1) evaluation of the fleet solver
    done by the plain version in float64 (rounded to float32 after)."""
    import torch
    entries = ops.fleet_value, ops.fleet_value_and_grad

    def args(prob, X):
        Q = prob.params
        return [t.double() for t in (X, prob.K, prob.E, prob.c, prob.d,
                                     Q.alpha, Q.beta1, Q.beta2, Q.beta3,
                                     Q.gamma)]

    def value(prob, X, use_kernel=True):
        return ref.alloc_objective_fleet_value(*args(prob, X)).float()

    def value_and_grad(prob, X, use_kernel=True):
        f, g = ref.alloc_objective_fleet_ref(*args(prob, X))
        return f.float(), g.float()

    ops.fleet_value, ops.fleet_value_and_grad = value, value_and_grad
    try:
        return run_replay()
    finally:
        ops.fleet_value, ops.fleet_value_and_grad = entries
        torch.cuda.synchronize()


def disagreement(name, got, want, rtol, atol) -> dict:
    """The largest difference of ``got`` from ``want`` and the largest
    difference over its tolerance (atol + rtol |want|)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    return {"max_abs_err": err.max().item(),
            "max_err_over_tol": (err / (atol + rtol * want.abs())).max().item()}


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """disagreement(), raised on when it is over the tolerance or ``got`` is
    not finite."""
    import torch
    rec = disagreement(name, got, want, rtol, atol)
    if not rec["max_err_over_tol"] <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {rec}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    return rec


def flash_bound(B, S, H, G, dh, window, dtype) -> dict:
    """q, k, v read once and o written once; 4 dh operations (q.k and p.v)
    per live (query, key) pair, the pairs this causal (and windowed) mask
    keeps. The operations are counted for the kernel's route: in bfloat16
    at the bf16 tensor-core rate; in float32 as 3xTF32, three TF32 products
    for each, at the TF32 rate (the same work on the FP32 pipes is kept as
    ``fp32_pipe_bound_ms``)."""
    if window > 0:
        w = min(window, S)
        live = w * (w + 1) // 2 + (S - w) * w
    else:
        live = S * (S + 1) // 2
    itemsize = 4 if dtype == "float32" else 2
    nbytes = itemsize * (2 * B * S * H * dh + 2 * B * S * G * dh)
    flops = 4 * dh * live * B * H
    if dtype != "float32":
        return {**bound(nbytes, flops, BF16_FLOPS_PER_S), "route": "bf16"}
    rec = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return {**rec, "flops": flops, "route": "3xTF32",
            "fp32_pipe_bound_ms": bound(nbytes, flops,
                                        F32_FLOPS_PER_S)["bound_ms"]}


TYPE_NAMES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
# each kernel's instantiations: (mangled-name pattern, key of a match, how
# many there are, which keys must hold tensor-core instructions)
BUILDS = {
    "flash_attention": (
        re.compile(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
        lambda m: f"{TYPE_NAMES[m.group(1)]}/dh{m.group(2)}", 8,
        lambda key: True),
    "rwkv6_scan": (
        re.compile(r"rwkv6_(chunks|step)_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
        lambda m: (f"{'prefill' if m.group(1) == 'chunks' else 'decode'}/"
                   f"{TYPE_NAMES[m.group(2)]}/hs{m.group(3)}"), 16,
        lambda key: key.startswith("prefill/")),
}


def build_report(kernel: str, library) -> dict:
    """Each instantiation of ``kernel`` (a key of BUILDS) in ``library``:
    registers and spills (ptxas -v) and HMMA (tensor-core) instructions in
    the library's machine code. Raises unless the build log holds every
    instantiation, or if one that must run on the tensor cores has no HMMA
    (where cuobjdump can tell)."""
    from repro_torch.kernels.build import (instantiation_report, ptxas_report,
                                           sass_counts)
    pattern, name, count, needs_hmma = BUILDS[kernel]
    hmma = sass_counts(library, "HMMA")
    out = instantiation_report(ptxas_report(library), hmma, pattern, name)
    if len(out) != count:
        raise AssertionError(f"{kernel}: expected {count} instantiations in "
                             f"the build log, found {sorted(out)}")
    missing = [key for key, rec in out.items()
               if hmma is not None and needs_hmma(key) and not rec["hmma"]]
    if missing:
        raise AssertionError(f"{kernel}: instantiations without tensor-core "
                             f"instructions: {missing}")
    return {"instantiations": out, "sass_read": hmma is not None}


def decode_bound(B, H, G, dh, n_valid, S, itemsize, flops_per_s) -> dict:
    """The valid cache rows of k and v, q and o once, the int32 validity;
    4 dh operations per (head, valid position)."""
    nbytes = (itemsize * (2 * B * G * n_valid * dh + 2 * B * H * dh)
              + 4 * S)
    return bound(nbytes, 4 * dh * n_valid * B * H, flops_per_s)


def rotation(sets):
    """A function that returns the next of ``sets`` on every call: timed
    calls cycle through enough copies of their inputs that each finds the
    50 MB L2 cold, as a layer of the served model finds its own weights and
    cache."""
    it = itertools.cycle(sets)
    return lambda: next(it)


def copies_for(nbytes: int) -> int:
    """Input copies so that the other copies, read in between, exceed twice
    the 50 MB L2."""
    return min(8, 2 + int(2 * L2_BYTES // max(nbytes, 1)))


def float64_errors(kern, plain, exact) -> dict:
    """A float32 kernel's output and its plain version's, each as the rms
    of its difference from ``exact()`` (the plain version in float64) over
    the rms of that, and the first over the second."""
    ref = exact()
    rms = lambda t: float(t.double().pow(2).mean().sqrt())
    errs = {"kernel_rms_rel": rms(kern.double() - ref) / rms(ref),
            "plain_rms_rel": rms(plain.double() - ref) / rms(ref)}
    errs["kernel_over_plain"] = errs["kernel_rms_rel"] / errs["plain_rms_rel"]
    return errs


def attention_checks(seed: int, dev):
    """Each attention kernel against its plain version at FLASH_CASES and
    DECODE_CASES, timed beside the plain version and SDPA over rotating
    input copies. Returns (checks, {kernel name: the record of its serving
    shape})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rand = lambda shape, dt: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
    rate = {"float32": F32_FLOPS_PER_S, "bfloat16": BF16_FLOPS_PER_S}
    checks, measured = [], {}
    for case, (B, S, H, G, dh, window, dtype) in FLASH_CASES.items():
        dt = getattr(torch, dtype)
        est = flash_bound(B, S, H, G, dh, window, dtype)
        sets = [(rand((B, S, H, dh), dt), rand((B, S, G, dh), dt),
                 rand((B, S, G, dh), dt))
                for _ in range(copies_for(est["bytes"]))]
        q, k, v = sets[0]
        got = fops.flash_attention(q, k, v, window).float()
        want = fref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        window)
        rec = compare(f"flash_attention {case}", got, want, ATTN_TOL[dtype],
                      ATTN_TOL[dtype])
        if dtype == "float32":
            rec["vs_float64"] = float64_errors(
                got, want, lambda: fref.flash_attention_ref(
                    q.double(), k.double(), v.double(), window))
            if not (rec["vs_float64"]["kernel_over_plain"] <= F64_RATIO):
                raise AssertionError(f"flash_attention {case}: farther from "
                                     f"float64 than float32 rounds: "
                                     f"{rec['vs_float64']}")
        del got, want
        mask = None
        if window > 0:
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
        kern_in, plain_in = rotation(sets), rotation(sets)
        lib_in = rotation([tuple(t.transpose(1, 2).contiguous() for t in st)
                           for st in sets])
        kern = lambda: fops.flash_attention(*kern_in(), window)
        plain = lambda: fref.flash_attention_ref(
            *(t.float() for t in plain_in()), window)
        library = lambda: F.scaled_dot_product_attention(
            *lib_in(), attn_mask=mask, is_causal=mask is None,
            enable_gqa=H != G)
        rec.update(name="flash_attention", case=case, dtype=dtype,
                   shape={"B": B, "S": S, "H": H, "G": G, "dh": dh,
                          "window": window}, input_copies=len(sets),
                   **timings(kern, plain), library_ms=device_ms(library),
                   library_call_ms=call_ms(library), **est)
        checks.append(rec)
        measured.setdefault("flash_attention", rec)
        del sets, q, k, v, kern_in, plain_in, lib_in
    for case, (B, S, H, G, dh, valid, dtype) in DECODE_CASES.items():
        dt = getattr(torch, dtype)
        kind, _, n = valid.partition(":")
        pos = torch.arange(S, device=dev)
        ok = (pos >= 0 if kind == "last" else pos < int(n) if kind == "prefix"
              else pos >= S - int(n))
        valid_i = ok.to(torch.int32)
        est = decode_bound(B, H, G, dh, int(ok.sum()), S, dt.itemsize,
                           rate[dtype])
        sets = [(rand((B, 1, H, dh), dt), rand((B, G, S, dh), dt),
                 rand((B, G, S, dh), dt))
                for _ in range(copies_for(est["bytes"]))]
        q, kc, vc = sets[0]
        got = dops.decode_attention(q, kc, vc, valid_i).float()
        want = dref.decode_attention_ref(q.float(), kc.float(), vc.float(),
                                         ok)
        rec = compare(f"decode_attention {case}", got, want, ATTN_TOL[dtype],
                      ATTN_TOL[dtype])
        if dtype == "float32":
            rec["vs_float64"] = float64_errors(
                got, want, lambda: dref.decode_attention_ref(
                    q.double(), kc.double(), vc.double(), ok))
        del got, want
        kern_in, plain_in = rotation(sets), rotation(sets)
        lib_in = rotation([(st[0].transpose(1, 2).contiguous(), st[1], st[2])
                           for st in sets])
        kern = lambda: dops.decode_attention(*kern_in(), valid_i)
        plain = lambda: dref.decode_attention_ref(
            *(t.float() for t in plain_in()), ok)
        library = lambda: F.scaled_dot_product_attention(
            *lib_in(), attn_mask=ok[None, None, None, :], enable_gqa=H != G)
        rec.update(name="decode_attention", case=case, dtype=dtype,
                   shape={"B": B, "S_max": S, "H": H, "G": G, "dh": dh,
                          "valid": valid, "n_valid": int(ok.sum())},
                   input_copies=len(sets),
                   **timings(kern, plain), library_ms=device_ms(library),
                   library_call_ms=call_ms(library), **est)
        checks.append(rec)
        measured.setdefault("decode_attention", rec)
        del sets, q, kc, vc, kern_in, plain_in, lib_in
    # a batch row's output does not depend on the other rows
    B, S, H, G, dh, _, _ = FLASH_CASES["gqa-48/8"]
    q, k, v = rand((B, S, H, dh), torch.float32), \
        rand((B, S, G, dh), torch.float32), rand((B, S, G, dh), torch.float32)
    rows_alone = torch.cat([fops.flash_attention(q[i:i + 1].contiguous(),
                                                 k[i:i + 1].contiguous(),
                                                 v[i:i + 1].contiguous())
                            for i in range(B)])
    if not torch.equal(rows_alone, fops.flash_attention(q, k, v)):
        raise AssertionError("flash_attention: a row depends on its batch")
    return checks, measured


def rwkv_bound(B, S, H, hs, chunk, itemsize) -> dict:
    """r, k, v, w read and y written once, u, s0 read and s_final written
    once. Operations per (b, h) and chunk of c real positions: the products,
    4 hs per strictly lower (t, i) pair (the decayed r.k and att.v) and
    4 hs^2 per position (r S_0 and the state update); besides them 4 hs per
    position (the bonus) and hs^2 (the decay of S_0). The prefill form's
    route is 3xTF32: three TF32 products for each product at the TF32 rate,
    the rest at the float32 rate (the same work all on the FP32 pipes is
    kept as ``fp32_pipe_bound_ms``). The decode form (S = 1) forms no
    products: the float32 rate."""
    full, tail = divmod(S, chunk)
    count = lambda per: B * H * (full * per(chunk) + (per(tail) if tail
                                                       else 0))
    mm = count(lambda c: 2 * hs * c * (c - 1) + 4 * c * hs * hs)
    rest = count(lambda c: 4 * c * hs + hs * hs)
    nbytes = itemsize * 5 * B * S * H * hs + 4 * (H * hs + 2 * B * H * hs * hs)
    fp32 = bound(nbytes, mm + rest, F32_FLOPS_PER_S)
    if S == 1:
        return {**fp32, "route": "fp32"}
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * mm / TF32_FLOPS_PER_S + rest / F32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": mm + rest, "route": "3xTF32",
            "fp32_pipe_bound_ms": fp32["bound_ms"]}


def rwkv_checks(seed: int, dev):
    """The rwkv6_scan kernel against its plain version at RWKV_CASES, timed
    beside it over rotating input copies; every float32 prefill case also
    against the chunked form in float64 (y and the final state, each
    within F64_RATIO times the plain version's rms error). Returns (checks, {kernels-line
    name: the record of its serving shape})."""
    import torch
    from repro_torch.kernels.rwkv6_scan import ops as sops
    from repro_torch.kernels.rwkv6_scan import ref as sref

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    measured_as = {"rwkv-prefill": "rwkv6_scan",
                   "rwkv-decode": "rwkv6_scan_decode"}
    checks, measured = [], {}
    for case, (B, S, H, hs, chunk, (lo, hi), dtype) in RWKV_CASES.items():
        dt = getattr(torch, dtype)
        est = rwkv_bound(B, S, H, hs, chunk, dt.itemsize)

        def inputs():
            rand = lambda *shape: torch.randn(shape, generator=gen,
                                              device=dev)
            w = lo + (hi - lo) * torch.rand((B, S, H, hs), generator=gen,
                                            device=dev)
            return (rand(B, S, H, hs).to(dt), rand(B, S, H, hs).to(dt),
                    rand(B, S, H, hs).to(dt), w.to(dt),
                    0.5 * rand(H, hs), 0.5 * rand(B, H, hs, hs))

        sets = [inputs() for _ in range(copies_for(est["bytes"]))]
        r, k, v, w, u, s0 = sets[0]
        y, sf = sops.rwkv6_scan(r, k, v, w, u, s0, chunk)
        yr, sr = sref.rwkv6_scan_chunked(r.float(), k.float(), v.float(),
                                         w.float(), u, s0, chunk)
        rec = compare(f"rwkv6_scan {case}",
                      torch.cat([y.float().flatten(), sf.flatten()]),
                      torch.cat([yr.flatten(), sr.flatten()]),
                      RWKV_TOL[dtype], RWKV_TOL[dtype])
        if dtype == "float32" and S > 1:
            # the prefill form's 3xTF32 chains against the chunked form in
            # float64, beside plain float32's: y and the final state
            y64, s64 = sref.rwkv6_scan_chunked(
                *(t.double() for t in (r, k, v, w, u, s0)), chunk,
                compute_dtype=torch.float64)
            rec["vs_float64"] = {
                "y": float64_errors(y, yr, lambda: y64),
                "state": float64_errors(sf, sr, lambda: s64)}
            del y64, s64
            worst = max(e["kernel_over_plain"]
                        for e in rec["vs_float64"].values())
            if not worst <= F64_RATIO:
                raise AssertionError(f"rwkv6_scan {case}: farther from "
                                     f"float64 than float32 rounds: "
                                     f"{rec['vs_float64']}")
        kern_in, plain_in = rotation(sets), rotation(sets)
        kern = lambda: sops.rwkv6_scan(*kern_in(), chunk)
        plain = lambda: sref.rwkv6_scan_chunked(
            *(t.float() for t in plain_in()), chunk)
        rec.update(name="rwkv6_scan", case=case, dtype=dtype,
                   shape={"B": B, "S": S, "H": H, "hs": hs, "chunk": chunk,
                          "w": [lo, hi]}, input_copies=len(sets),
                   **timings(kern, plain), library_ms=None, **est)
        checks.append(rec)
        if case in measured_as:
            measured[measured_as[case]] = rec
        del sets, r, k, v, w, u, s0, y, sf, yr, sr, kern_in, plain_in
    return checks, measured


def _rwkv_weights(params, gen) -> None:
    """u drawn from N(0, 0.5) and w_base spread evenly over [-6, -1] across
    channels, RWKV-6's own time-decay range: the reference's init (u = 0,
    w_base = -6) leaves the bonus unexercised and every decay at 0.9975."""
    import torch
    for layer in params["layers"]:
        mix = layer["mix"]
        mix["u"].normal_(0.0, 0.5, generator=gen)
        mix["w_base"].copy_(torch.linspace(-6.0, -1.0, mix["w_base"].numel()))


def float64_scan(run):
    """``run()`` with the RWKV model's WKV scan evaluated in float64 (the
    chunked form, rounded to float32 after): the plain path made more exact
    at the one place where the kernel path differs from it."""
    import torch
    import repro_torch.models.rwkv as rwkv_mod
    from repro_torch.kernels.rwkv6_scan import ref as sref

    def scan(r, k, v, w, u, s0, chunk, use_kernel=None):
        y, s_final = sref.rwkv6_scan_chunked(
            *(t.double() for t in (r, k, v, w, u, s0)), chunk,
            compute_dtype=torch.float64)
        return y.float(), s_final.float()

    kept, rwkv_mod.rwkv6_scan = rwkv_mod.rwkv6_scan, scan
    try:
        return run()
    finally:
        rwkv_mod.rwkv6_scan = kept


def rwkv_end_to_end(plain_run, params, cfg, gen, kern, plain, fwd, toks,
                    phase) -> dict:
    """rwkv6-7b's logits end to end, held to a measured yardstick. A random
    rwkv6-7b moves its own logits past SERVE_TOL under perturbations of
    float32 rounding's size, so SERVE_TOL cannot separate a right path from
    a wrong one there. Instead the plain path runs again NOISE_SEEDS times,
    each with the embedding table perturbed by 1e-7 of itself (a fresh
    draw each time), and:

    - the kernel path's logits must lie no farther (max_err_over_tol at
      SERVE_TOL) from the plain path's, and from forward's, than the
      farthest of these perturbed runs lies from the plain path;
    - every greedy token must be the argmax of the plain path's and of
      forward's logits, except at a near tie: where the token's logit lies
      within twice the largest perturbed difference of the top one.

    The same two rules hold the kernel path to the plain path with the WKV
    scan evaluated in float64 (``float64_scan``), whose own distance from
    the plain path is reported beside it, as is the plain path's with the
    scan in chunks of 32 (the same function, rounded otherwise). Each
    difference also gives its max_err_over_tol at each step (the prefill,
    then the decode steps)."""
    import torch

    def dis(name, got, want):
        rec = disagreement(name, got, want, SERVE_TOL, SERVE_TOL)
        over = (got - want).abs() / (SERVE_TOL + SERVE_TOL * want.abs())
        rec["over_tol_by_step"] = over.flatten(1).max(1).values.tolist()
        return rec

    table = params["embed"]["table"]
    floors = []
    for _ in range(NOISE_SEEDS):
        noise = torch.randn(table.shape, generator=gen, device=table.device)
        perturbed = {**params, "embed": {"table": table * (1 + 1e-7 * noise)}}
        del noise
        floors.append(dis("plain path, perturbed", plain_run(perturbed),
                          plain))
        del perturbed
    limit = max(f["max_err_over_tol"] for f in floors)
    tie = 2 * max(f["max_abs_err"] for f in floors)
    rec = {"noise_floors": floors, "limit_over_tol": limit,
           "near_tie_abs": tie,
           "witness_chunk32": dis("plain path, chunk 32", plain_run(
               params, cfg.scaled(scan_chunk=32)), plain)}
    exact = float64_scan(lambda: plain_run(params))
    rec["plain_vs_float64_scan"] = dis("plain path vs float64 scan", plain,
                                       exact)
    chosen = torch.stack(toks)                      # (steps + 1, B, 1)
    for name, want in (("plain", plain), ("forward", fwd),
                       ("float64_scan", exact)):
        got = dis(f"{phase} vs {name}", kern, want)
        top = want.max(-1).values
        at = want.gather(-1, chosen)[..., 0]
        got.update(tokens=int(top.numel()),
                   tokens_argmax=int((want.argmax(-1) == chosen[..., 0]
                                      ).sum()),
                   tokens_within_tie=int((top - at <= tie).sum()))
        rec[f"vs_{name}"] = got
        if not (got["max_err_over_tol"] <= limit
                and got["tokens_within_tie"] == got["tokens"]):
            raise AssertionError(f"{phase}: the kernel path's logits lie "
                                 f"outside the plain path's noise: {got}, "
                                 f"limit {limit}, near tie {tie}")
    return rec


def rwkv_layerwise(cfg, params, prompts, toks, s_max) -> dict:
    """Every time-mix block of the RWKV serving run held to its plain
    version on the same input, at full width and depth, through the model's
    own layer loop (its ``on_layer`` hook): the prefill, each greedy decode
    step and forward over prompt + generated tokens (a ragged last chunk)
    run again along the kernel path, and at each layer the block runs again
    with use_kernel=False on the same input and cache; its output and its
    new state must agree at SERVE_TOL. Returns the largest disagreement."""
    import torch
    from repro_torch.models import decode_step, forward, prefill

    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0, "layer_calls": 0}
    where = ["prefill"]

    def check(i, y, cache, rerun):
        y_plain, cache_plain = rerun(False)
        for what, got, want in (("output", y, y_plain),
                                ("state", cache.wkv, cache_plain.wkv)):
            rec = compare(f"serve_rwkv {where[0]} layer {i} {what}", got,
                          want, SERVE_TOL, SERVE_TOL)
            for key in ("max_abs_err", "max_err_over_tol"):
                worst[key] = max(worst[key], rec[key])
        worst["layer_calls"] += 1

    with torch.inference_mode():
        S = prompts.shape[1]
        _, caches = prefill(cfg, params, {"tokens": prompts}, s_max,
                            on_layer=check)
        for i, tok in enumerate(toks[:-1]):
            where[0] = f"decode {i}"
            _, caches = decode_step(cfg, params, caches, tok, S + i,
                                    on_layer=check)
        where[0] = "forward"
        forward(cfg, params, {"tokens": torch.cat([prompts] + toks[:-1],
                                                  dim=1)}, on_layer=check)
    return worst


class RoutingLog:
    """Inside it, every MoE routing (``repro_torch.models.moe.route``) is
    recorded call by call: the chosen experts, the router probabilities,
    the kept assignments and the capacity. With ``force`` (an earlier
    log's calls), each call's expert choices are replaced by the recorded
    ones, call for call, through ``routing_from_choice`` (as ``route``
    forms its own): the run then follows that run's routing."""

    def __init__(self, force=None):
        self.calls, self.force = [], force

    def __enter__(self):
        import repro_torch.models.moe as moe_mod
        self.mod, self.kept = moe_mod, moe_mod.route

        def route(p, cfg, x, no_drop):
            r = self.kept(p, cfg, x, no_drop)
            if self.force is not None:
                r = moe_mod.routing_from_choice(
                    r.probs, self.force[len(self.calls)]["expert_idx"],
                    r.capacity)
            self.calls.append({"expert_idx": r.expert_idx, "probs": r.probs,
                               "keep": r.keep, "capacity": r.capacity})
            return r

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.kept

    def dropped(self, calls) -> dict:
        """The share of assignments dropped over ``calls`` (a slice)."""
        keep = [c["keep"] for c in self.calls[calls]]
        n = sum(k.numel() for k in keep)
        kept = sum(int(k.sum()) for k in keep)
        return {"assignments": n, "dropped": n - kept,
                "dropped_share": (n - kept) / n if n else None,
                "capacity": sorted({c["capacity"] for c in self.calls[calls]}),
                "by_call": [1 - float(k.float().mean()) for k in keep]}


def routing_partings(kern, plain, per_step: int, top_k: int) -> dict:
    """Where two runs' routings part: at each MoE call (``per_step`` calls
    a step: the prefill is step 0, decode step i is step i + 1), the tokens
    whose chosen expert sets differ. A row of the batch is clean until its
    first parting; after it, its later layers and steps see other inputs
    (and, under capacity, the row's other slots move), so only a parting in
    a clean row is a first parting. A first parting is a near tie when its
    margin in the plain run (log p of the K-th expert minus that of the
    K+1-th) is at most twice the largest log-probability difference
    between the two runs over the call's clean tokens that did not part:
    the router's own rounding noise at that call. Returns the first
    partings with their margins, the count of later ones, and each row's
    first parted step (None if it never parts)."""
    import torch
    rows = kern[0]["expert_idx"].shape[0]
    first_step = [None] * rows
    firsts, later = [], 0
    for j, (ck, cp) in enumerate(zip(kern, plain)):
        step = j // per_step
        ek = ck["expert_idx"].sort(-1).values
        ep = cp["expert_idx"].sort(-1).values
        differ = (ek != ep).any(-1)                        # (B, S)
        lk, lp = ck["probs"].log(), cp["probs"].log()
        delta = (lk - lp).abs().amax(-1)                   # (B, S)
        clean = torch.tensor([s is None for s in first_step],
                             device=differ.device)[:, None]
        quiet = clean & ~differ
        noise = float(delta[quiet].max()) if bool(quiet.any()) else 0.0
        top = lp.topk(top_k + 1, dim=-1).values
        margin = top[..., top_k - 1] - top[..., top_k]
        for b, s in differ.nonzero().tolist():
            if first_step[b] is not None and first_step[b] < step:
                later += 1
                continue
            firsts.append({
                "call": j, "step": step, "layer": j % per_step, "row": b,
                "token": s, "kernel_experts": ek[b, s].tolist(),
                "plain_experts": ep[b, s].tolist(),
                "margin_logp": float(margin[b, s]),
                "router_noise_logp": noise,
                "near_tie": float(margin[b, s]) <= 2 * noise})
        for b in differ.any(-1).nonzero().flatten().tolist():
            if first_step[b] is None:
                first_step[b] = step
    return {"first_partings": firsts, "later_partings": later,
            "rows_first_parted_at_step": first_step,
            "all_near_ties": all(f["near_tie"] for f in firsts)}


def moe_end_to_end(plain_run, params, kern, plain, kern_log, plain_log,
                   gen, per_step, top_k, phase) -> dict:
    """The MoE model's logits end to end against the plain path. Float32
    rounding can flip a near-tied top-k expert choice, and under capacity
    the later slots of that row with it: the row then runs other experts
    from there on. So: within SERVE_TOL of the plain path, done
    (``gate`` "serve_tol"). Otherwise ("yardstick") three things must hold:

    - every first parting of the two runs' routings is a near tie
      (``routing_partings``);
    - every logit past SERVE_TOL lies in a row at or after its first
      parting (a row whose routing never parted stays within SERVE_TOL);
    - the kernel path lies within SERVE_TOL, or within the measured
      yardstick, of the plain path forced onto the kernel path's routing
      (the same expert choices, so only the continuous differences remain).
      The yardstick is ``rwkv_end_to_end``'s: the farthest that the plain
      path (itself forced onto its own routing) moves under NOISE_SEEDS
      perturbations of the embedding table by 1e-7 of itself.

    Everything is reported whatever the first comparison gives."""
    import torch
    rec = {"vs_plain": disagreement(f"{phase} vs plain path", kern, plain,
                                    SERVE_TOL, SERVE_TOL)}
    over = ((kern - plain).abs() / (SERVE_TOL + SERVE_TOL * plain.abs())
            ).amax(-1)                                     # (steps + 1, B)
    parts = routing_partings(kern_log.calls, plain_log.calls, per_step,
                             top_k)
    rec["routing"] = parts
    parted = parts["rows_first_parted_at_step"]
    rec["over_tol_without_parting"] = [
        (t, b) for t, b in (over > 1).nonzero().tolist()
        if parted[b] is None or parted[b] > t]
    table = params["embed"]["table"]
    floors = []
    for _ in range(NOISE_SEEDS):
        eps = torch.randn(table.shape, generator=gen, device=table.device)
        run_params = {**params, "embed": {"table": table * (1 + 1e-7 * eps)}}
        del eps
        with RoutingLog(force=plain_log.calls):
            got = plain_run(run_params)
        floors.append(disagreement("plain path, embedding 1e-7", got, plain,
                                   SERVE_TOL, SERVE_TOL))
        del run_params, got
    rec["noise_floors"] = floors
    rec["limit_over_tol"] = max(f["max_err_over_tol"] for f in floors)
    with RoutingLog(force=kern_log.calls):
        forced = plain_run(params)
    rec["vs_plain_forced_routing"] = disagreement(
        f"{phase} vs plain path on its routing", kern, forced, SERVE_TOL,
        SERVE_TOL)
    del forced
    off = rec["vs_plain_forced_routing"]["max_err_over_tol"]
    rec["gate"] = ("serve_tol" if rec["vs_plain"]["max_err_over_tol"] <= 1.0
                   else "yardstick" if (
                       parts["all_near_ties"]
                       and not rec["over_tol_without_parting"]
                       and off <= max(1.0, rec["limit_over_tol"]))
                   else "failed")
    if rec["gate"] == "failed" or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f"{phase}: the kernel path parts from the plain "
                             f"path beyond its rounding and its routing's "
                             f"near ties: {rec}")
    return rec


def float64_attention(run):
    """``run()`` with every full-sequence attention of the model computed
    in float64 (the plain version on float64 copies of q, k and v, one
    batch row at a time), its output rounded back to float32: the witness
    that the kernel path and the plain path are both held against."""
    import torch
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.flash_attention import ref as fref

    def attend(q, k, v, window=0, use_kernel=None):
        return torch.cat([fref.flash_attention_ref(
            q[b:b + 1].double(), k[b:b + 1].double(), v[b:b + 1].double(),
            window).to(q.dtype) for b in range(q.shape[0])])

    kept, attn_mod.flash_attention = attn_mod.flash_attention, attend
    try:
        return run()
    finally:
        attn_mod.flash_attention = kept


def attention_layerwise(cfg, params, prompts, toks, s_max, phase) -> dict:
    """Every attention block of a serving run held to its plain version on
    the same input (ATTN_TOL), through the model's ``on_layer`` hook: the
    prefill, each decode step, and forward over the prompt run again along
    the kernel path, and each attention block runs again with
    use_kernel=False on the same input and cache. Returns the largest
    disagreement, and under ``rms_rel`` the largest rms of the difference
    over the rms of the plain block's output, for the full-sequence form
    (flash_attention) and the decode form (decode_attention) apart."""
    import torch
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.transformer import layer_kinds

    kinds = [blk for blk, _ in layer_kinds(cfg)]
    tol = ATTN_TOL[cfg.dtype]
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0, "layer_calls": 0,
             "tol": tol, "rms_rel": {"full": 0.0, "decode": 0.0}}
    where = ["prefill"]

    def check(i, y, cache, rerun):
        if kinds[i] != "attn":
            return
        y_plain, _ = rerun(False)
        rec = compare(f"{phase} {where[0]} layer {i} attention", y, y_plain,
                      tol, tol)
        for key in ("max_abs_err", "max_err_over_tol"):
            worst[key] = max(worst[key], rec[key])
        rms = lambda t: t.double().pow(2).mean().sqrt().item()
        form = "decode" if y.shape[1] == 1 else "full"
        worst["rms_rel"][form] = max(worst["rms_rel"][form],
                                     rms(y - y_plain) / rms(y_plain))
        worst["layer_calls"] += 1

    with torch.inference_mode():
        S = prompts.shape[1]
        _, caches = prefill(cfg, params, {"tokens": prompts}, s_max,
                            on_layer=check)
        for i, tok in enumerate(toks[:-1]):
            where[0] = f"decode {i}"
            _, caches = decode_step(cfg, params, caches, tok, S + i,
                                    on_layer=check)
        where[0] = "forward"
        forward(cfg, params, {"tokens": prompts}, on_layer=check)
    return worst


def serve(seed: int, dev, arch: str, phase: str, n_layers: int = 0):
    """A serving main path: ``arch`` at full width and depth (or its first
    ``n_layers`` layers), prefill and greedy decode through the step
    functions, then the plain-path and teacher-forcing checks. Returns
    (record, launches of the prefill, launches of the decode steps)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.alloc_objective import ops as aops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as sops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward, init_model

    kernel_ops = (aops, fops, dops, sops)

    def counts():
        return {k: n for ops in kernel_ops for k, n in ops.LAUNCHES.items()}

    def reset():
        for ops in kernel_ops:
            ops.reset_launches()

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers:
        cfg = cfg.scaled(n_layers=n_layers)
    rwkv = cfg.blocks_in_group[0][0] == "rwkv"
    moe = "moe" in cfg.ffn_pattern
    routing = RoutingLog if moe else contextlib.nullcontext
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    s_max = S + steps
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    if rwkv:
        _rwkv_weights(params, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    prefill = make_prefill_step(cfg, s_max=s_max)
    decode = make_decode_step(cfg)
    # warm-up on a short prompt: cuBLAS handles and the kernels' libraries
    lg, caches = prefill(params, {"tokens": prompts[:, :64]})
    decode(params, caches, lg.argmax(-1, keepdim=True), 64)
    del lg, caches
    torch.cuda.synchronize()

    reset()
    torch.cuda.reset_peak_memory_stats()
    with routing() as kern_routes:
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = counts()
        step_logits = [logits]
        toks = [logits.argmax(-1, keepdim=True)]
        t0 = time.perf_counter()
        for i in range(steps):
            logits, caches = decode(params, caches, toks[i], S + i)
            step_logits.append(logits)
            toks.append(logits.argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = counts()
    decode_launches = {k: n - prefill_launches[k] for k, n in launches.items()}
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    if rwkv:
        want_prefill, want_decode = {"rwkv6_scan": L}, {"rwkv6_scan": L * steps}
    else:   # every layer of the served attention models is attention
        want_prefill = {"flash_attention": L}
        want_decode = {"decode_attention": L * steps}
    for got, want in ((prefill_launches, want_prefill),
                      (decode_launches, want_decode)):
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{phase} launches {got}, expected {want} "
                                 f"and no other kernel")
    kern_logits = torch.stack(step_logits)            # (steps + 1, B, V)
    if not (kern_logits.shape == (steps + 1, B, cfg.vocab_size)
            and bool(torch.isfinite(kern_logits).all())):
        raise AssertionError(f"{phase}: logits of the wrong shape or not "
                             f"finite")

    # one decode step under the profiler: the last step again (an attention
    # step writes the same token to the same slot; an RWKV step advances its
    # state once more, which nothing reads after); then one more prefill
    step_prof = profile_once(
        lambda: decode(params, caches, toks[steps - 1], S + steps - 1))
    # the same device time over a step's time without the profiler (its
    # overhead lengthens the host's share)
    step_prof["device_busy_share_unprofiled"] = (
        step_prof["device_busy_ms"] / (decode_s / steps * 1e3))
    prefill_prof = profile_once(
        lambda: prefill(params, {"tokens": prompts}))
    prefill_prof["device_busy_share_unprofiled"] = (
        prefill_prof["device_busy_ms"] / (prefill_s * 1e3))
    del caches

    # (a) the plain path on the card, teacher-forced with the kernel's tokens
    def plain_run(run_params, run_cfg=cfg):
        plain_prefill = make_prefill_step(run_cfg, s_max=s_max,
                                          use_kernel=False)
        plain_decode = make_decode_step(run_cfg, use_kernel=False)
        logits, caches = plain_prefill(run_params, {"tokens": prompts})
        out = [logits]
        for i in range(steps):
            logits, caches = plain_decode(run_params, caches, toks[i], S + i)
            out.append(logits)
        return torch.stack(out)

    reset()
    with routing() as plain_routes:
        plain_logits = plain_run(params)
    if any(counts().values()):
        raise AssertionError(f"the plain path launched kernels: {counts()}")
    # (b) teacher forcing: forward over prompt + generated tokens; for an
    # MoE model over the prompt alone, against the prefill: forward over
    # S + steps tokens would run the capacity of that length (C = 330 at
    # 1056 tokens, 320 at 1024) and drop other assignments, in the
    # reference too
    seq = (prompts if moe else torch.cat([prompts] + toks[:steps], dim=1))
    with torch.inference_mode():
        full, aux = forward(cfg, params, {"tokens": seq})
    forward_logits = full[:, S - 1:].transpose(0, 1)
    del full
    if moe:
        layerwise = attention_layerwise(cfg, params, prompts, toks, s_max,
                                        phase)
        checks = moe_end_to_end(plain_run, params, kern_logits, plain_logits,
                                kern_routes, plain_routes, gen, L,
                                cfg.top_k, phase)
        checks["layerwise_attention"] = layerwise
        # the prefill with its attention in float64: which path lies nearer
        with RoutingLog() as witness_routes:
            witness = float64_attention(lambda: prefill(
                params, {"tokens": prompts})[0])
        checks["float64_attention_witness"] = {
            "kernel": disagreement(f"{phase} prefill vs float64 attention",
                                   kern_logits[0], witness, SERVE_TOL,
                                   SERVE_TOL),
            "plain": disagreement("plain prefill vs float64 attention",
                                  plain_logits[0], witness, SERVE_TOL,
                                  SERVE_TOL),
            "routing_vs_kernel": routing_partings(
                kern_routes.calls[:L], witness_routes.calls, L, cfg.top_k)}
        del witness
        checks["vs_forward"] = compare(f"{phase} prefill vs forward",
                                       kern_logits[:1], forward_logits,
                                       SERVE_TOL, SERVE_TOL)
        checks["forward_aux"] = float(aux)
        checks["prefill_routing"] = kern_routes.dropped(slice(0, L))
        checks["decode_routing"] = kern_routes.dropped(slice(L, None))
        if checks["decode_routing"]["dropped"]:
            raise AssertionError(f"{phase}: decode dropped assignments")
    elif rwkv:
        checks = rwkv_end_to_end(plain_run, params, cfg, gen, kern_logits,
                                 plain_logits, forward_logits, toks, phase)
        checks["layerwise"] = rwkv_layerwise(cfg, params, prompts, toks,
                                             s_max)
    else:
        checks = {
            "vs_plain": compare(f"{phase} vs plain path", kern_logits,
                                plain_logits, SERVE_TOL, SERVE_TOL),
            "vs_forward": compare(f"{phase} vs forward", kern_logits,
                                  forward_logits, SERVE_TOL, SERVE_TOL)}
    del forward_logits
    rec = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "reduced": ({"n_layers": [cfg.n_layers, full_layers]}
                       if cfg.n_layers != full_layers else {}),
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(params)),
           "B": B, "prompt": S, "steps": steps, "s_max": s_max,
           "init_s": init_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": B * S / prefill_s,
           "decode_ms_per_token": decode_s / steps * 1e3,
           "decode_launches_per_step": {k: n / steps for k, n in
                                        decode_launches.items()},
           "decode_tokens_per_s": B * steps / decode_s,
           "peak_memory_gib": peak / 2 ** 30, "launches": launches,
           "prefill_launches": prefill_launches,
           "decode_launches": decode_launches,
           **checks, "tol": SERVE_TOL,
           "argmax_equal_plain": bool(torch.equal(
               kern_logits.argmax(-1), plain_logits.argmax(-1))),
           "decode_step_profile": step_prof,
           "prefill_profile": prefill_prof}
    return rec, prefill_launches, decode_launches


def mamba_checks(seed: int, dev) -> dict:
    """One Mamba block at jamba-1.5-large's full width (d_model 8192,
    d_inner 16384, N 16, dt_rank 512; random weights from ``seed``): a
    prefill of SERVE_PROMPT tokens for SERVE_BATCH rows from a zeroed
    MambaCache, then SERVE_STEPS one-token steps carrying the cache on,
    against the block over all SERVE_PROMPT + SERVE_STEPS tokens at once
    (SERVE_TOL, tests/models/test_model_parts.py:40). Prefill ms, decode ms
    a step and peak memory; the block is plain PyTorch (the reference's
    scan is jnp, no Pallas kernel), so it launches no kernel of ours."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import MambaCache
    from repro_torch.models.mamba import init_mamba, mamba_block

    cfg = get_config(MAMBA_ARCH)
    B, S, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    p = init_mamba(gen, cfg, torch.float32, dev)
    x = torch.randn((B, S + steps, cfg.d_model), generator=gen, device=dev)
    with torch.inference_mode():
        mamba_block(p, cfg, x[:, :64])                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y, cache = mamba_block(p, cfg, x[:, :S],
                               MambaCache.zeros(B, cfg, torch.float32, dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ys = [y]
        t0 = time.perf_counter()
        for t in range(S, S + steps):
            y, cache = mamba_block(p, cfg, x[:, t:t + 1], cache)
            ys.append(y)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        whole, final = mamba_block(p, cfg, x)
    rec = {"arch": cfg.name, "d_model": cfg.d_model,
           "d_inner": cfg.mamba_d_inner, "d_state": cfg.mamba_d_state,
           "dt_rank": p["dt_proj"].shape[0],
           "params": sum(t.numel() for t in p.values()),
           "B": B, "prompt": S, "steps": steps,
           "chunk": cfg.scan_chunk or min(256, S),
           "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": decode_s / steps * 1e3,
           "peak_memory_gib": peak / 2 ** 30, "tol": SERVE_TOL,
           "prefill_then_decode_vs_whole": disagreement(
               "mamba", torch.cat(ys, dim=1), whole, SERVE_TOL, SERVE_TOL),
           "final_state_vs_whole": disagreement(
               "mamba state", cache.ssm, final.ssm, SERVE_TOL, SERVE_TOL)}
    if not (rec["prefill_then_decode_vs_whole"]["max_err_over_tol"] <= 1.0
            and rec["final_state_vs_whole"]["max_err_over_tol"] <= 1.0
            and bool(torch.isfinite(whole).all())):
        raise AssertionError(f"mamba: prefill then decode parts from the "
                             f"block over the whole sequence: {rec}")
    return rec


def families_checks(seed: int, dev) -> dict:
    """Every registered config at reduced() size (d_head 16) on the card,
    through ``repro_torch.launch.routes.check_routes`` (as
    tests/test_torch_families_cuda.py): its BATCH prompts of PROMPT tokens
    and STEPS greedy decode steps through the step functions, the kernel
    route against the plain route fed the kernel route's tokens at its TOL (2e-4 prefill, 2e-3 decode, 3e-3 for
    mixtral, whose window is cut so that its ring buffer wraps); launch
    counts zeroed before each run and read after: one flash launch per
    attention layer per prefill, one decode launch per attention layer per
    step, one rwkv6_scan launch per RWKV layer per prefill and per step,
    none on the plain route. MoE, Mamba, the hybrid and the vision frontend
    go through the card with both attention kernels."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import routes

    out = {}
    for arch in list_archs():
        t0 = time.perf_counter()
        out[arch] = routes.check_routes(arch, seed=seed, device=dev)
        out[arch]["seconds"] = time.perf_counter() - t0
    return {"B": routes.BATCH, "prompt": routes.PROMPT,
            "steps": routes.STEPS, "configs": out}


@contextlib.contextmanager
def float64_model():
    """Inside it the model code computes in float64 where its tensors are
    float64: ``Tensor.float()`` leaves a float64 tensor as it is (rmsnorm,
    RoPE, the scores, the loss's logits and AdamW all widen with it) and
    the activation type "float32" reads as float64. Tensors made with an
    explicit float32 type stay float32 (the RoPE tables, the aux-loss zero,
    AdamW's bias corrections and lr): shared by both runs, or rounded once."""
    import torch
    import repro_torch.models.transformer as tmod
    widen, name_to_dtype = torch.Tensor.float, tmod.torch_dtype
    torch.Tensor.float = lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else widen(self, *a, **kw))
    tmod.torch_dtype = lambda name: (torch.float64 if name == "float32"
                                     else name_to_dtype(name))
    try:
        yield
    finally:
        torch.Tensor.float, tmod.torch_dtype = widen, name_to_dtype


def _train_fingerprint(params) -> list:
    """Up to 4096 evenly strided elements of every parameter leaf."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    out = []
    for p in tree_leaves(params):
        flat = p.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() // 4096)].clone())
    return out


def _rel_errors(got, want) -> dict:
    """Per leaf, max |got - want| over max |want|; the largest, and its
    leaf."""
    errs = [float((g.double() - w).abs().max() / w.abs().max().clamp_min(
        1e-300)) for g, w in zip(got, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return {"max_rel": errs[worst], "leaf": worst, "leaves": len(errs)}


def train_checks(seed: int, dev, kernel_ops) -> dict:
    """The training path on the card (plain route, autograd, AdamW in
    place), float32:

    (a) TRAIN_ARCH at full width and depth through
        ``repro_torch.launch.train.train`` (the launcher's loop and
        settings): TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ (the
        reference launcher's batch and length), one more under
        torch.profiler, then one of 1 x TRAIN_LONG_SEQ, where the full
        depth runs _chunked_flash under remat. Per step the loss, grad
        norm, lr, seconds, peak GiB and kernel launches. Raises unless
        every loss and grad norm is finite, every parameter leaf moved,
        step 0's loss equals loss_fn under no_grad within 1e-5 relative,
        and no kernel launched (the LAUNCHES counters).
    (b) TRAIN_ARCH at full width, TWIN_LAYERS layers, TRAIN_BATCH x
        TRAIN_SEQ: loss_fn, its gradient and one AdamW step in float32 and
        the same code in float64 (``float64_model``); the loss, every
        gradient leaf, m and v held at TWIN_TOL.
    (c) _chunked_flash against _sdpa at (1, TRAIN_LONG_SEQ, H = G = 20,
        dh 128): outputs and q/k/v gradients at ATTN_TOL, and both
        against _sdpa in float64 (rms error over the float64 rms).
    (d) every kernel wrapper asked to launch on operands that require
        grad raises (the kernels have no backward)."""
    import gc
    import torch
    import repro_torch.models.attention as tattn
    from repro_torch.configs import get_config
    from repro_torch.kernels.alloc_objective import ops as aops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as sops
    from repro_torch.launch import train as launch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    def launches():
        return sum(v for o in kernel_ops for v in o.LAUNCHES.values())

    def as_batch(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    rec = {}
    # ---- (a) full width and depth through the launcher's loop -----------
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    n_params = sum(p.numel() for p in adamw.tree_leaves(params))
    before = _train_fingerprint(params)
    first = as_batch(SyntheticLM(DataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)).global_batch(0))
    with torch.no_grad():
        loss0 = float(loss_fn(cfg, params, first)[0])
    del first
    for o in kernel_ops:
        o.reset_launches()
    per_step = []

    def on_step(step, metrics, seconds):
        per_step.append({"launches": launches(),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        torch.cuda.reset_peak_memory_stats()

    total = TRAIN_STEPS + 2
    params, state, hist = launch.train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=TRAIN_LR, device=dev, seed=seed, params=params,
        total_steps=total, ckpt_every=total + 1, log=lambda *_: None,
        on_step=on_step)
    # one more step of the same shape under the profiler
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=20,
                                total_steps=total)
    step_fn = make_train_step(cfg, opt_cfg)
    prof_batch = as_batch(SyntheticLM(DataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)).global_batch(
            TRAIN_STEPS))
    out = []
    profile = profile_once(lambda: out.append(step_fn(params, state,
                                                      prof_batch)), top_n=8)
    params, state, metrics = out.pop()
    profile.update(step=TRAIN_STEPS, loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   launches=launches(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del prof_batch, metrics
    torch.cuda.reset_peak_memory_stats()
    params, state, long_hist = launch.train(
        cfg, steps=1, batch=1, seq=TRAIN_LONG_SEQ, lr=TRAIN_LR, device=dev,
        seed=seed, params=params, opt_state=state,
        first_step=TRAIN_STEPS + 1, total_steps=total,
        ckpt_every=total + 1, log=lambda *_: None, on_step=on_step)
    hist = [dict(h, shape=[TRAIN_BATCH, TRAIN_SEQ]) for h in hist] + [
        dict(h, shape=[1, TRAIN_LONG_SEQ]) for h in long_hist]
    for h, extra in zip(hist, per_step):
        h.update(extra)
    moved = [bool((a != b).any()) for a, b in
             zip(before, _train_fingerprint(params))]
    rec["full"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "remat": cfg.remat, "loss_chunk": cfg.loss_chunk,
        "steps": hist, "profiled_step": profile,
        "step0_loss_no_grad": loss0,
        "step0_rel_diff": abs(hist[0]["loss"] - loss0) / abs(loss0),
        "leaves": len(moved), "leaves_moved": sum(moved),
        "kernel_launches": launches()}
    del params, state, before, out
    gc.collect()
    torch.cuda.empty_cache()
    full = rec["full"]
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist) and math.isfinite(profile["loss"])
    if not (finite and full["leaves_moved"] == full["leaves"]
            and full["step0_rel_diff"] <= 1e-5
            and full["kernel_launches"] == 0
            and all(h["launches"] == 0 for h in hist)):
        raise AssertionError(f"train: the full-depth run failed its gates: "
                             f"{ {k: v for k, v in full.items() if k not in ('steps', 'profiled_step')} } "
                             f"finite={finite}")

    # ---- (b) a shallower step held to float64 ----------------------------
    twin_cfg = cfg.scaled(n_layers=TWIN_LAYERS)
    base = init_model(twin_cfg, torch.Generator(device=dev).manual_seed(
        seed + 1), dev)
    batch = as_batch(SyntheticLM(DataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)).global_batch(0))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=20, total_steps=10)

    def one_step(params, moment_dtype):
        leaves = [p.requires_grad_(True) for p in adamw.tree_leaves(params)]
        loss, _ = loss_fn(twin_cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        kept = [g.detach().clone() for g in grads]
        slot = iter(grads)
        tree = adamw.tree_map(lambda _: next(slot), params)
        del grads, slot
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        state = adamw.AdamWState(torch.zeros((), dtype=torch.int32,
                                             device=dev),
                                 adamw.tree_map(zeros, params),
                                 adamw.tree_map(zeros, params))
        _, state, _ = adamw.update(opt_cfg, tree, state, params)
        return (float(loss.detach()), kept, adamw.tree_leaves(state.m),
                adamw.tree_leaves(state.v))

    t32 = one_step(adamw.tree_map(lambda p: p.detach().clone(), base),
                   torch.float32)
    with float64_model():
        t64 = one_step(adamw.tree_map(lambda p: p.detach().double(), base),
                       torch.float64)
    del base, batch
    twin = {"layers": TWIN_LAYERS, "tol": TWIN_TOL,
            "loss_32": t32[0], "loss_64": t64[0],
            "loss_rel": abs(t32[0] - t64[0]) / abs(t64[0]),
            "grad": _rel_errors(t32[1], t64[1]),
            "m": _rel_errors(t32[2], t64[2]),
            "v": _rel_errors(t32[3], t64[3])}
    rec["float64_twin"] = twin
    del t32, t64
    gc.collect()
    torch.cuda.empty_cache()
    if not (twin["loss_rel"] <= TWIN_TOL["loss"]
            and all(twin[k]["max_rel"] <= TWIN_TOL[k]
                    for k in ("grad", "m", "v"))):
        raise AssertionError(f"train: float32 step farther from float64 "
                             f"than TWIN_TOL: {twin}")

    # ---- (c) _chunked_flash against _sdpa -------------------------------
    H, dh, S = cfg.n_heads, cfg.d_head, TRAIN_LONG_SEQ
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    q, k, v, dy = (torch.randn((1, S, H, dh), generator=gen, device=dev)
                   for _ in range(4))
    mask = tattn.causal_mask(S, S, 0, 0, dev)

    def attend(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves,
                                                         dy.to(dtype)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunked = attend(lambda q, k, v: tattn._chunked_flash(q, k, v, 0),
                     torch.float32)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    sdpa = attend(lambda q, k, v: tattn._sdpa(q, k, v, mask), torch.float32)
    with float64_model():
        exact = attend(lambda q, k, v: tattn._sdpa(q, k, v, mask),
                       torch.float64)
    rms = lambda t: float(t.double().pow(2).mean().sqrt())
    names = ("out", "dq", "dk", "dv")
    flash = {"shape": [1, S, H, H, dh], "tol": ATTN_TOL["float32"],
             "seconds": chunked_s,
             "vs_sdpa": {n: disagreement(f"_chunked_flash {n}", a, b,
                                         ATTN_TOL["float32"],
                                         ATTN_TOL["float32"])
                         for n, a, b in zip(names, chunked, sdpa)},
             "vs_float64": {n: {"chunked_rms_rel": rms(a.double() - x)
                                / rms(x),
                                "sdpa_rms_rel": rms(b.double() - x) / rms(x)}
                            for n, a, b, x in zip(names, chunked, sdpa,
                                                  exact)}}
    rec["chunked_flash"] = flash
    del q, k, v, dy, chunked, sdpa, exact
    torch.cuda.empty_cache()
    if not all(r["max_err_over_tol"] <= 1.0
               for r in flash["vs_sdpa"].values()):
        raise AssertionError(f"train: _chunked_flash parts from _sdpa: "
                             f"{flash['vs_sdpa']}")

    # ---- (d) the kernels refuse autograd ---------------------------------
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    t = lambda *s: torch.randn(s, generator=g, device=dev)
    q = t(1, 64, 4, 64).requires_grad_(True)
    kv = t(1, 64, 4, 64)
    cache = t(1, 4, 64, 64)
    r = t(1, 64, 4, 64).requires_grad_(True)
    w = torch.rand((1, 64, 4, 64), generator=g, device=dev)
    X = torch.rand((1, 4, 128), generator=g, device=dev).requires_grad_(True)
    zeros = lambda *s: torch.zeros(s, device=dev)
    calls = {
        "flash_attention": lambda: fops.flash_attention(q, kv, kv),
        "decode_attention": lambda: dops.decode_attention(
            q[:, :1], cache, cache, torch.ones(64, dtype=torch.int32,
                                               device=dev)),
        "rwkv6_scan": lambda: sops.rwkv6_scan(r, kv, kv, w, t(4, 64),
                                              t(1, 4, 64, 64)),
        "alloc_objective_fleet": lambda: aops._launch(
            "alloc_objective_fleet", X, zeros(1, 4, 128), zeros(1, 2, 128),
            zeros(1, 128), zeros(1, 4), zeros(1, 8), True)}
    refused = {}
    for name, call in calls.items():
        before_n = launches()
        try:
            call()
            refused[name] = "launched"
        except RuntimeError as e:
            refused[name] = ("refused" if "has no backward" in str(e)
                             else f"other error: {e}")
        if launches() != before_n:
            refused[name] = "launched"
    rec["autograd_refused"] = refused
    if any(v != "refused" for v in refused.values()):
        raise AssertionError(f"train: a kernel did not refuse autograd: "
                             f"{refused}")
    return rec


def _elastic_run(TJob, ElasticFleet, dev, use_kernel: bool,
                 ulp: int = 0) -> tuple:
    """ElasticFleet's replans in order (initial, after ELASTIC_FAILED of
    the fleet fails, each of ELASTIC_SCALES), the job's FLOPs moved by
    ``ulp`` float64 ulps. Returns (fleet, [(label, plan, churn)])."""
    import numpy as np
    flops = ELASTIC_JOB["hlo_flops"]
    for _ in range(abs(ulp)):
        flops = float(np.nextafter(flops, np.inf if ulp > 0 else -np.inf))
    fleet = ElasticFleet(TJob(**dict(ELASTIC_JOB, hlo_flops=flops)),
                         delta_max=64.0, device=dev, use_kernel=use_kernel)
    plans = [("initial", fleet.initial_plan())]
    failed = np.ceil(fleet.controller.x_current * ELASTIC_FAILED)
    plans.append(("failure", fleet.replan_after_failure(failed)))
    for s in ELASTIC_SCALES:
        plans.append((f"x{s}", fleet.replan_for_demand(s)))
    churn = [st.churn for st in fleet.controller.history]
    return fleet, [(lb, pl, ch) for (lb, pl), ch in zip(plans, churn)]


def _elastic_shape_case(ops, ref, prob, key: str, gen) -> dict:
    """An entry at a shape the elastic run launched (``entry@B=1,T=..,
    n=..``) on the run's own problem, against its plain version, timed,
    with its bound: the single-problem entry (the cold multistart) or the
    fleet entries at B = 1 (the warm incremental solve stacks its one
    problem, ``core.problem.unsqueeze_problem``)."""
    import torch
    from repro_torch.core.problem import unsqueeze_problem
    name = key.split("@")[0]
    T = int(key.split("T=")[1].split(",")[0])
    st = unsqueeze_problem(prob)
    X = (2.0 * torch.rand((1, T, prob.n), generator=gen, device=prob.device)
         * st.mask[:, None, :]).contiguous()
    args = (st.K, st.E, st.c, st.d, *ops._params(st))
    grad = name != "alloc_objective_fleet_value"
    if name == "alloc_objective":
        kern = lambda: ops.batched_value_and_grad(prob, X[0])
        plain = lambda: ref.alloc_objective_ref(X[0], *(
            a[0] for a in args))
        scal = ops._single_scalars(prob)
    elif grad:
        kern = lambda: ops.fleet_value_and_grad(st, X)
        plain = lambda: ref.alloc_objective_fleet_ref(X, *args)
        scal = ops._fleet_scalars(st)
    else:
        kern = lambda: (ops.fleet_value(st, X),)
        plain = lambda: (ref.alloc_objective_fleet_value(X, *args),)
        scal = ops._fleet_scalars(st)
    flat = lambda out: torch.cat([t.flatten() for t in out])
    rec = compare(key, flat(kern()), flat(plain()))
    m, p = prob.K.shape[0], prob.E.shape[0]
    bound_ms, bound_by, nbytes, flops = kernel_bound(1, T, prob.n, m, p,
                                                     grad)
    rec.update(name=name, shape={"B": 1, "T": T, "n": prob.n, "m": m,
                                 "p": p},
               **timings(kern, plain, lambda: ops._launch(
                   name, X, st.K, st.E, st.c, st.d, scal, grad)),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    return rec


def _params_close(got, want, tol) -> dict:
    """Per leaf of two parameter trees (full tensors): the largest
    |got - want| over (tol |want| + atol), atol = tol x the leaf's largest
    element (10x for NOISE_LEAVES); the worst leaf."""
    worst, where = 0.0, None

    def walk(g, w, path):
        nonlocal worst, where
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        else:
            a, b = g.detach().double(), w.detach().double()
            atol = tol * float(b.abs().max()) * (
                10 if path.split(".")[-1] in NOISE_LEAVES else 1)
            over = float(((a - b).abs() / (atol + tol * b.abs()).clamp_min(
                1e-300)).max())
            if over > worst:
                worst, where = over, path
    walk(got, want, "")
    return {"max_err_over_tol": worst, "leaf": where}


def distributed_checks(seed: int, dev, ops, ref) -> tuple:
    """The distributed substrate on the card, in a world of one over NCCL
    (``launch.mesh.init_distributed``; the group is destroyed at the end):

    (a) ``ElasticFleet`` on make_tpu_catalog(): the replans of
        ``_elastic_run`` with the kernel and plain. Raises unless the two
        commit equal counts at every replan, or the kernel run's equal
        those of a plain run with the job's FLOPs one float64 ulp up or
        down (ULP_STEPS). Launches by shape, chips, cost, churn; the
        kernel at each launched shape against plain, timed (returned as
        the kernels line's rows).
    (b) ``compress_decompress`` and ``compressed_psum`` on the NCCL world
        at COMPRESS_SHAPE float32: equal; over COMPRESS_STEPS error-
        feedback steps the running sum within one quantisation step
        (max |error|) of the true sum.
    (c) ``launch.train.train`` on a 1x1 ("data", "model") mesh against the
        one-device loop: TRAIN_ARCH at full width, MESH_LAYERS layers,
        MESH_STEPS steps of TRAIN_BATCH x TRAIN_SEQ; loss and grad norm at
        MESH_TOL, parameters after the last step as ``_params_close``;
        per step seconds and peak GiB, each run's alone (the other run's
        parameters wait on the host).
    (d) ``TrainingSupervisor.run`` around the 1x1 launcher on the reduced
        TRAIN_ARCH: one failure injected at step SUPERVISED_FAIL, after the
        checkpoint of step SUPERVISED_FAIL - 1 is committed; the
        ``replan_shards`` hook takes the data-shard count from (a)'s
        kernel fleet's ``replan_after_failure`` (on one card the mesh stays
        1x1: the count is recorded, the global batch is the same stream);
        the resumed steps' losses against an uninterrupted run's at
        MESH_TOL.
    Returns (record, the kernels line's rows)."""
    import gc
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.workloads import JobSpec
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed.elastic import ElasticFleet
    from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                         TrainingSupervisor)
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compress as gc_mod

    rec, rows = {}, []
    t0 = time.perf_counter()
    init_distributed(dev)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"distributed: expected a world of one over "
                             f"NCCL, got {dist.get_backend()} x "
                             f"{dist.get_world_size()}")
    rec["process_group_s"] = time.perf_counter() - t0
    try:
        # ---- (a) the allocator's elastic replans ----------------------
        t0 = time.perf_counter()
        ops.reset_launches()
        with ShapeCounts(ops, with_n=True) as shapes:
            kfleet, kern = _elastic_run(JobSpec, ElasticFleet, dev, True)
        k_launches, k_s = dict(ops.LAUNCHES), time.perf_counter() - t0
        t0 = time.perf_counter()
        ops.reset_launches()
        _, plain = _elastic_run(JobSpec, ElasticFleet, dev, False)
        p_launches, p_s = dict(ops.LAUNCHES), time.perf_counter() - t0
        if any(p_launches.values()):
            raise AssertionError(f"distributed: the plain elastic run "
                                 f"launched {p_launches}")
        counts = lambda run: [pl.counts.tolist() for _, pl, _ in run]
        equal = counts(kern) == counts(plain)
        twins = {}
        if not equal:
            for k in ULP_STEPS:
                twins[k] = counts(_elastic_run(JobSpec, ElasticFleet, dev,
                                               False, ulp=k)[1])
        within = equal or counts(kern) in twins.values()
        show = lambda run: [{"label": lb, "chips": pl.total_chips,
                             "cost_per_hour": pl.cost_per_hour,
                             "mesh": list(pl.mesh_shape), "churn": ch,
                             "counts": pl.counts.tolist()}
                            for lb, pl, ch in run]
        rec["elastic"] = {
            "catalog_n": kfleet.catalog.n, "job": ELASTIC_JOB,
            "kernel": {"seconds": k_s, "launches": k_launches,
                       "launches_by_shape": shapes.by_shape(),
                       "plans": show(kern)},
            "plain": {"seconds": p_s, "plans": show(plain)},
            "counts_equal": equal, "ulp_twins_run": sorted(twins),
            "within_one_ulp_spread": within}
        if not within or not k_launches["alloc_objective"]:
            raise AssertionError(f"distributed: elastic kernel run parts "
                                 f"from plain: {rec['elastic']}")
        prob = kfleet.controller.make_problem(
            kfleet.controller.history[0].demand)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for key, n in shapes.by_shape().items():
            r = _elastic_shape_case(ops, ref, prob, key, gen)
            rows.append(("elastic", key, r, n))
        rec["elastic"]["shapes"] = [{"key": k, **r, "launches": n}
                                    for _, k, r, n in rows]

        # ---- (b) int8 gradient compression on NCCL --------------------
        t0 = time.perf_counter()
        g_gen = torch.Generator(device=dev).manual_seed(seed + 1)
        g = torch.randn(COMPRESS_SHAPE, generator=g_gen, device=dev)
        err = torch.zeros_like(g)
        deq, new_err = gc_mod.compress_decompress(g, err)
        summed, psum_err = gc_mod.compressed_psum(g, err)
        psum_equal = bool(torch.equal(deq, summed)
                          and torch.equal(new_err, psum_err))
        true_sum = torch.zeros(COMPRESS_SHAPE, dtype=torch.float64,
                               device=dev)
        seen_sum = torch.zeros_like(true_sum)
        err = torch.zeros_like(g)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(COMPRESS_STEPS):
            g = torch.randn(COMPRESS_SHAPE, generator=g_gen, device=dev)
            deq, err = gc_mod.compress_decompress(g, err)
            true_sum += g.double()
            seen_sum += deq.double()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - s0
        resid = float((true_sum - seen_sum).abs().max())
        max_err = float(err.abs().max())
        rec["compress"] = {
            "shape": list(COMPRESS_SHAPE), "psum_equals_local": psum_equal,
            "steps": COMPRESS_STEPS, "running_sum_resid": resid,
            "final_max_abs_error": max_err, "loop_s": loop_s,
            "seconds": time.perf_counter() - t0}
        del g, err, deq, new_err, summed, psum_err, true_sum, seen_sum
        if not (psum_equal and resid <= max_err + 1e-5):
            raise AssertionError(f"distributed: compression failed: "
                                 f"{rec['compress']}")

        # ---- (c) the launcher on a 1x1 mesh -----------------------------
        t0 = time.perf_counter()
        cfg = get_config(TRAIN_ARCH).scaled(n_layers=MESH_LAYERS)
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        runs = {}
        # each run's parameters wait on the host, so that each peak is its
        # own run's alone
        host = lambda tree, where: adamw.tree_map(
            lambda t: t.detach().to(where), tree)
        with tempfile.TemporaryDirectory() as tmp:
            for name, m in (("one_device", None), ("mesh_1x1", mesh)):
                torch.cuda.reset_peak_memory_stats()
                params, state, hist = launch.train(
                    cfg, steps=MESH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    lr=TRAIN_LR, device=dev, seed=seed, mesh=m,
                    ckpt_every=MESH_STEPS + 1, ckpt_dir=tmp,
                    log=lambda *_: None)
                if m is not None:
                    params, _ = launch.gather_state(params, state)
                runs[name] = (host(params, "cpu"), hist)
                del params, state
                gc.collect()
                torch.cuda.empty_cache()
        (p1, h1), (pm, hm) = runs["one_device"], runs["mesh_1x1"]
        p1, pm = host(p1, dev), host(pm, dev)
        rel = lambda key: max(abs(a[key] - b[key]) / abs(b[key])
                              for a, b in zip(hm, h1))
        close = _params_close(pm, p1, MESH_TOL)
        rec["mesh_train"] = {
            "arch": cfg.name, "layers": MESH_LAYERS, "d_model": cfg.d_model,
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "tol": MESH_TOL,
            "one_device": [{k: h.get(k) for k in ("loss", "grad_norm",
                                                  "seconds", "peak_gib")}
                           for h in h1],
            "mesh_1x1": [{k: h.get(k) for k in ("loss", "grad_norm",
                                                "seconds", "peak_gib")}
                         for h in hm],
            "loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
            "params": close, "seconds": time.perf_counter() - t0}
        del runs, p1, pm
        gc.collect()
        torch.cuda.empty_cache()
        if not (rec["mesh_train"]["loss_rel"] <= MESH_TOL
                and rec["mesh_train"]["grad_norm_rel"] <= MESH_TOL
                and close["max_err_over_tol"] <= 1.0):
            raise AssertionError(f"distributed: the 1x1 mesh run parts from "
                                 f"the one-device run: {rec['mesh_train']}")

        # ---- (d) the supervisor's restart loop --------------------------
        t0 = time.perf_counter()
        small = launch.train_config(TRAIN_ARCH, True, TRAIN_SEQ)
        run = lambda **kw: launch.train(
            small, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, device=dev,
            seed=seed, mesh=mesh, total_steps=SUPERVISED_STEPS,
            log=lambda *_: None, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            _, _, straight = run(steps=SUPERVISED_STEPS,
                                 ckpt_every=SUPERVISED_EVERY,
                                 ckpt_dir=f"{tmp}/straight")
            attempts = []

            def fail_once(step, metrics, seconds):
                if step == SUPERVISED_FAIL and len(attempts) == 1:
                    raise RuntimeError("host_down")

            def train_fn(start_step, num_shards):
                attempts.append({"start_step": start_step,
                                 "num_shards": num_shards})
                kw = {}
                d = ckpt.latest_step_dir(f"{tmp}/sup")
                if d is not None:
                    like = init_model(small, torch.Generator(
                        device=dev).manual_seed(seed), dev)
                    step, tree, _ = ckpt.load(d, {"p": like,
                                                  "o": adamw.init(like)})
                    kw = dict(params=tree["p"], opt_state=tree["o"],
                              first_step=step + 1)
                first = kw.get("first_step", 0)
                _, _, hist = run(steps=SUPERVISED_STEPS - first,
                                 ckpt_every=SUPERVISED_EVERY,
                                 ckpt_dir=f"{tmp}/sup", on_step=fail_once,
                                 **kw)
                attempts[-1]["history"] = hist
                return SUPERVISED_STEPS

            failed = np.ceil(kfleet.controller.x_current * ELASTIC_FAILED)
            replans = []

            def replan_shards(old):
                plan = kfleet.replan_after_failure(failed)
                replans.append({"from": old, "to": plan.mesh_shape[0],
                                "chips": plan.total_chips})
                return plan.mesh_shape[0]

            sup = TrainingSupervisor(SupervisorConfig(), f"{tmp}/sup")
            final = sup.run(train_fn, total_steps=SUPERVISED_STEPS,
                            initial_shards=kern[0][1].mesh_shape[0],
                            replan_shards=replan_shards)
        resumed = attempts[-1].get("history", [])
        want = {h["step"]: h["loss"] for h in straight}
        diffs = [abs(h["loss"] - want[h["step"]]) / abs(want[h["step"]])
                 for h in resumed]
        rec["supervisor"] = {
            "arch": small.name, "steps": SUPERVISED_STEPS,
            "ckpt_every": SUPERVISED_EVERY, "fail_at": SUPERVISED_FAIL,
            "final_step": final, "restarts": sup.restarts,
            "events": [vars(e) for e in sup.events], "replans": replans,
            "attempts": [{k: a[k] for k in ("start_step", "num_shards")}
                         for a in attempts],
            "resumed_steps": [h["step"] for h in resumed],
            "resumed_loss_rel": diffs, "tol": MESH_TOL,
            "seconds": time.perf_counter() - t0}
        if not (final == SUPERVISED_STEPS and sup.restarts == 1
                and [e.step for e in sup.events] == [SUPERVISED_FAIL - 1]
                and [h["step"] for h in resumed]
                == list(range(SUPERVISED_FAIL, SUPERVISED_STEPS))
                and max(diffs) <= MESH_TOL):
            raise AssertionError(f"distributed: the supervised run failed "
                                 f"its gates: {rec['supervisor']}")
    finally:
        dist.destroy_process_group()
    return rec, rows


def scenario_checks(dev, ops) -> dict:
    """The paper's one-shot comparison on the card: ``optimize`` on s1-s5
    over the full catalog, with the alloc_objective kernel and plain,
    against the Cluster-Autoscaler's median cost over seeds 0-2; launch
    counts zeroed just before each run and read just after. Raises unless
    every allocation is integral and satisfies its demand, the kernel's
    eq. (1) at its counts lies within FUN_RTOL of the plain run's (or the
    two commit the same counts), the kernel run launched the single-problem
    form and the plain run nothing, each optimizer cost is at most CA_SLACK
    x the CA median and the mean savings lie in SAVINGS_BAND."""
    import numpy as np
    import torch
    from repro_torch.core import (build_scenarios, evaluate,
                                  make_cloud_catalog, optimize,
                                  simulate_cluster_autoscaler)
    catalog = make_cloud_catalog()
    rows = []
    total = collections.Counter()
    for sc in build_scenarios(catalog):
        runs = {}
        for who, use_kernel in (("kernel", True), ("plain", False)):
            ops.reset_launches()
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = optimize(catalog, sc, n_starts=SCENARIO_STARTS, seed=0,
                           use_kernel=use_kernel, device=dev)
            torch.cuda.synchronize()
            runs[who] = (res, time.perf_counter() - s0, dict(ops.LAUNCHES))
        (kern, k_s, k_l), (plain, p_s, p_l) = runs["kernel"], runs["plain"]
        total.update(k_l)
        s0 = time.perf_counter()
        ca = float(np.median([evaluate(catalog, simulate_cluster_autoscaler(
            catalog, sc.pools, sc.demand, seed=sd).counts,
            sc.demand).total_cost for sd in range(CA_SEEDS)]))
        ca_s = time.perf_counter() - s0
        cost = kern.metrics.total_cost
        row = {"scenario": sc.name, "optimizer_cost": cost,
               "plain_cost": plain.metrics.total_cost, "ca_cost": ca,
               "savings_pct": 100.0 * (ca - cost) / ca,
               "fun": kern.fun, "plain_fun": plain.fun,
               "fun_rel_diff_vs_plain": abs(kern.fun - plain.fun)
               / abs(plain.fun),
               "counts_equal": bool(np.array_equal(kern.counts,
                                                   plain.counts)),
               "satisfied": [kern.metrics.satisfied,
                             plain.metrics.satisfied],
               "integral": bool(all(np.array_equal(r.counts,
                                                   np.round(r.counts))
                                    for r in (kern, plain))),
               "wall_s": k_s, "plain_wall_s": p_s, "ca_s": ca_s,
               "launches": k_l, "plain_launches": p_l}
        rows.append(row)
        if not (all(row["satisfied"]) and row["integral"]):
            raise AssertionError(f"{sc.name}: an allocation is not integral "
                                 f"or misses the demand: {row}")
        if not (row["counts_equal"]
                or row["fun_rel_diff_vs_plain"] <= FUN_RTOL):
            raise AssertionError(f"{sc.name}: the kernel run's eq. (1) "
                                 f"disagrees with the plain run's: {row}")
        if (k_l["alloc_objective"] == 0 or k_l["alloc_objective_fleet"]
                or k_l["alloc_objective_fleet_value"] or any(p_l.values())):
            raise AssertionError(f"{sc.name}: launches {k_l}, plain {p_l}")
        if not cost <= CA_SLACK * ca:
            raise AssertionError(f"{sc.name}: optimizer ${cost:.4f} against "
                                 f"the CA's ${ca:.4f}")
    mean = float(np.mean([r["savings_pct"] for r in rows]))
    if not SAVINGS_BAND[0] <= mean <= SAVINGS_BAND[1]:
        raise AssertionError(f"mean savings {mean:.1f}% outside "
                             f"{SAVINGS_BAND}")
    return {"n": catalog.n, "n_starts": SCENARIO_STARTS, "scenarios": rows,
            "mean_savings_pct": mean, "launches": dict(total)}


class ShapeCounts:
    """Counts the alloc_objective kernel's launches by entry and shape
    (``entry@B=..,T=..``, and ``,n=..`` with ``with_n``) while in a
    ``with`` block, by wrapping the wrappers' one launch function."""

    def __init__(self, ops, with_n: bool = False):
        self.ops = ops
        self.with_n = with_n
        self.counts = collections.Counter()

    def __enter__(self):
        self.launch = launch = self.ops._launch

        def counted(entry, X, *a, **kw):
            out = launch(entry, X, *a, **kw)
            n = f",n={X.shape[2]}" if self.with_n else ""
            self.counts[f"{entry}@B={X.shape[0]},T={X.shape[1]}{n}"] += 1
            return out

        self.ops._launch = counted
        return self

    def __exit__(self, *exc):
        self.ops._launch = self.launch
        return False

    def by_shape(self) -> dict:
        return dict(sorted(self.counts.items()))


def bnb_checks(dev, ops, scen) -> dict:
    """Branch-and-bound on the card through ``optimize(use_bnb=True,
    n_starts=6, seed=0)`` (BNB_NODES nodes) over the full catalog,
    the runs of BNB_RUNS, launch counts zeroed just before each run and
    read just after. Beside each: nodes explored, relaxation solves,
    incumbent updates, gap, wall seconds, launches by entry and shape, and
    the cost against the scenarios phase's multistart answer (``scen``)
    and the CA median.

    Raises unless every allocation is integral and satisfies its demand,
    ``used_bnb`` holds, the kernel run launched the single-problem form
    only and the plain run nothing, the two s4 runs are equally feasible,
    and their answers (eq. (1) at the counts) agree within TENANT_RTOL or
    each lies within TENANT_RTOL of an answer the reference reaches on s4
    under a one-ulp change of the problem (REF_S4_BNB). The second arm is
    there because a node's relaxation stops at its iteration budget and
    the branch variable is the most fractional one, so rounding alone
    picks between the reference's answers; ``bnb_spread.py`` measures
    that spread for both paths."""
    import numpy as np
    import torch
    import repro_torch.core.api as api_mod
    import repro_torch.core.branch_bound as bb_mod
    from repro_torch.core import build_scenarios, make_cloud_catalog
    catalog = make_cloud_catalog()
    scenarios = {sc.name: sc for sc in build_scenarios(catalog)}
    phase_rows = {r["scenario"]: r for r in scen["scenarios"]}
    seen = {}
    solves = [0]
    wrapped = (api_mod.multistart_solve, api_mod.branch_and_bound,
               bb_mod.solve_relaxation)

    def keep(name, fn):
        def wrapper(*a, **kw):
            seen[name] = out = fn(*a, **kw)
            return out
        return wrapper

    def counted_solve(*a, **kw):
        solves[0] += 1
        return wrapped[2](*a, **kw)

    api_mod.multistart_solve = keep("ms", wrapped[0])
    api_mod.branch_and_bound = keep("bnb", wrapped[1])
    bb_mod.solve_relaxation = counted_solve
    rows = {}
    try:
        for name, who, use_kernel in BNB_RUNS:
            sc = scenarios[name]
            seen.clear()
            solves[0] = 0
            ops.reset_launches()
            with ShapeCounts(ops) as shapes:
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                res = api_mod.optimize(catalog, sc, n_starts=SCENARIO_STARTS,
                                       seed=0, use_bnb=True,
                                       bnb_nodes=BNB_NODES,
                                       use_kernel=use_kernel, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
            ms, bnb = seen["ms"], seen["bnb"]
            ref_row = phase_rows[name]
            cost = res.metrics.total_cost
            row = {"scenario": name, "engine": who, "wall_s": wall,
                   "nodes_explored": bnb.nodes_explored,
                   "relaxation_solves": solves[0],
                   "incumbent_updates": bnb.incumbent_updates,
                   "gap": bnb.gap, "bnb_fun": bnb.fun,
                   "multistart_fun_int": float(ms.fun_int), "fun": res.fun,
                   "kept_multistart": bool(np.array_equal(
                       res.counts, ms.x_int.cpu().numpy())),
                   "cost": cost,
                   "multistart_cost": ref_row["optimizer_cost"],
                   "ca_cost": ref_row["ca_cost"],
                   "savings_vs_multistart_pct":
                       100.0 * (ref_row["optimizer_cost"] - cost)
                       / ref_row["optimizer_cost"],
                   "savings_vs_ca_pct": 100.0 * (ref_row["ca_cost"] - cost)
                   / ref_row["ca_cost"],
                   "satisfied": res.metrics.satisfied,
                   "integral": bool(np.array_equal(res.counts,
                                                   np.round(res.counts))),
                   "used_bnb": res.used_bnb,
                   "launches": dict(ops.LAUNCHES),
                   "launches_by_shape": shapes.by_shape()}
            rows[(name, who)] = (row, res)
            if not (row["satisfied"] and row["integral"] and res.used_bnb):
                raise AssertionError(f"bnb {name} ({who}): {row}")
            launches = row["launches"]
            if use_kernel and (launches["alloc_objective"] == 0
                               or launches["alloc_objective_fleet"]
                               or launches["alloc_objective_fleet_value"]):
                raise AssertionError(f"bnb {name} ({who}): {launches}")
            if not use_kernel and any(launches.values()):
                raise AssertionError(f"bnb {name} (plain) launched {launches}")
    finally:
        (api_mod.multistart_solve, api_mod.branch_and_bound,
         bb_mod.solve_relaxation) = wrapped
    kern, plain = (rows[("s4_memory", who)][1] for who in ("kernel", "plain"))

    def near(got, want):
        return abs(got - want) <= TENANT_RTOL * abs(want)

    def in_spread(fun):
        return any(near(fun, want) for want in REF_S4_BNB.values())

    gate = {"counts_equal": bool(np.array_equal(kern.counts, plain.counts)),
            "fun_rel_diff": abs(kern.fun - plain.fun) / abs(plain.fun),
            "rtol": TENANT_RTOL,
            "satisfied_equal": (kern.metrics.satisfied
                                == plain.metrics.satisfied),
            "reference_spread": sorted(set(REF_S4_BNB.values())),
            "kernel_in_reference_spread": in_spread(kern.fun),
            "plain_in_reference_spread": in_spread(plain.fun)}
    agree = gate["counts_equal"] or near(kern.fun, plain.fun)
    spread = (gate["kernel_in_reference_spread"]
              and gate["plain_in_reference_spread"])
    gate["held_by"] = ("kernel vs plain" if agree else
                       "reference spread" if spread else None)
    if not (gate["satisfied_equal"] and gate["held_by"]):
        raise AssertionError(f"bnb s4: the kernel and plain runs part beyond "
                             f"the reference's own spread: {gate}")
    return {"n": catalog.n, "n_starts": SCENARIO_STARTS,
            "runs": [r for r, _ in rows.values()],
            "s4_kernel_vs_plain": gate}


def sequential_checks(catalog, tenants, ops, replay_mod) -> dict:
    """The sequential control loop on the card: ``tenants`` replayed with
    the CA off three ways — ``replay_mode="sequential"`` (one controller
    solve per tenant per tick), ``"batched"`` with ``hot_loop="vmap"`` (each
    tenant solved alone inside the batched engine) and ``"batched"`` with
    ``hot_loop="kernel"`` — launch counts zeroed just before each run and
    read just after; cold and warm solve seconds apart. Raises unless the
    sequential and vmap replays commit the same counts for every tenant at
    every tick, bit for bit, and the kernel replay lies within TENANT_RTOL
    of the sequential one per tenant and FLEET_RTOL over the fleet, with
    identical satisfaction flags."""
    import numpy as np
    import torch
    from repro_torch.core.controller import (
        InfrastructureOptimizationController as Ctl)
    solve_s = collections.defaultdict(float)
    wrapped = {"cold_start_counts": Ctl.cold_start_counts,
               "incremental_counts": Ctl.incremental_counts,
               "solve_fleet": replay_mod.solve_fleet,
               "solve_fleet_step": replay_mod.solve_fleet_step}
    kinds = {"cold_start_counts": "cold", "incremental_counts": "warm",
             "solve_fleet": "cold", "solve_fleet_step": "warm"}

    def timed(name):
        fn = wrapped[name]

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            solve_s[kinds[name]] += time.perf_counter() - s0
            return out
        return wrapper

    Ctl.cold_start_counts = timed("cold_start_counts")
    Ctl.incremental_counts = timed("incremental_counts")
    replay_mod.solve_fleet = timed("solve_fleet")
    replay_mod.solve_fleet_step = timed("solve_fleet_step")
    runs = {}
    try:
        for who, mode, hot_loop in SEQUENTIAL_RUNS:
            solve_s.clear()
            ops.reset_launches()
            with ShapeCounts(ops) as shapes:
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                out = replay_mod.replay_fleet(catalog, tenants,
                                              replay_mode=mode,
                                              hot_loop=hot_loop,
                                              run_ca_baseline=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
            counts = [np.stack([s.counts for s in r.steps])
                      for r in out.tenants]
            if not all(np.isfinite(c).all() and np.array_equal(c, np.round(c))
                       for c in counts):
                raise AssertionError(f"{who}: non-integral counts")
            runs[who] = (out, counts, {
                "engine": who, "replay_mode": mode, "hot_loop": hot_loop,
                "wall_s": wall, "cold_s": solve_s["cold"],
                "warm_s": solve_s["warm"],
                "cost_integral": out.metrics.total_cost_integral,
                "satisfied_ticks": int(sum(s.metrics.satisfied
                                           for r in out.tenants
                                           for s in r.steps)),
                "launches": dict(ops.LAUNCHES),
                "launches_by_shape": shapes.by_shape()})
            if not ops.LAUNCHES["alloc_objective_fleet"] and not ops.LAUNCHES[
                    "alloc_objective"]:
                raise AssertionError(f"{who}: the kernel never launched")
    finally:
        Ctl.cold_start_counts = wrapped["cold_start_counts"]
        Ctl.incremental_counts = wrapped["incremental_counts"]
        replay_mod.solve_fleet = wrapped["solve_fleet"]
        replay_mod.solve_fleet_step = wrapped["solve_fleet_step"]
    seq, seq_counts, _ = runs["sequential"]
    _, vmap_counts, _ = runs["vmap"]
    kern, _, _ = runs["kernel"]
    differ = [b for b, (x, y) in enumerate(zip(seq_counts, vmap_counts))
              if not np.array_equal(x, y)]
    cost_s = np.asarray([r.metrics.cost_integral for r in seq.tenants])
    cost_k = np.asarray([r.metrics.cost_integral for r in kern.tenants])
    rel = np.abs(cost_k - cost_s) / np.abs(cost_s)
    agg = abs(cost_k.sum() - cost_s.sum()) / cost_s.sum()
    sat = lambda o: [[s.metrics.satisfied for s in r.steps] for r in o.tenants]
    rec = {"tenants": [t.name for t in tenants],
           "ticks": int(tenants[0].trace.shape[0]), "n": catalog.n,
           "runs": [r for _, _, r in runs.values()],
           "vmap_tenants_with_other_counts": differ,
           "kernel_max_tenant_rel_diff": float(rel.max()),
           "kernel_fleet_rel_diff": float(agg),
           "kernel_satisfied_flags_equal": sat(kern) == sat(seq)}
    if differ:
        raise AssertionError(f"the vmap replay commits other counts than the "
                             f"sequential one for tenants {differ}")
    if not (rel.max() <= TENANT_RTOL and agg <= FLEET_RTOL
            and rec["kernel_satisfied_flags_equal"]):
        raise AssertionError(f"the kernel replay disagrees with the "
                             f"sequential one: {rec}")
    return rec


def _replay_record(out, wall, launches, shapes) -> dict:
    """The numbers a scenario replay prints: cost, SLO ticks, churn and
    savings against the CA, wall seconds and launches."""
    m = out.metrics
    return {"wall_s": wall, "cost_integral": m.total_cost_integral,
            "slo_violation_ticks": m.total_slo_violation_ticks,
            "total_churn": m.total_churn,
            "ca_cost_integral": m.baseline_cost_integral,
            "ca_slo_violation_ticks": sum(t.slo_violation_ticks
                                          for t in m.baseline),
            "savings_vs_ca_pct": m.cost_savings_vs_baseline_pct,
            "launches": launches, "launches_by_shape": shapes}


def _held_interrupted_twins(specs, out) -> int:
    """(tenant, tick) cells that hold a spot twin its availability row
    marks down."""
    import numpy as np
    held = 0
    for spec, rep in zip(specs, out.tenants):
        if spec.spot_idx is None:
            continue
        avail = np.asarray(spec.spot_availability)
        for t, step in enumerate(rep.steps):
            down = spec.spot_idx[avail[min(t, len(avail) - 1)] <= 0.0]
            held += int((step.counts[down] > 0).any())
    return held


def _fleet_agreement(got, want) -> dict:
    """Per-tenant and fleet relative differences of two replays' cost
    integrals, and whether their per-tick satisfaction flags are equal."""
    import numpy as np
    a = np.asarray([r.metrics.cost_integral for r in got.tenants])
    b = np.asarray([r.metrics.cost_integral for r in want.tenants])
    sat = lambda o: [[s.metrics.satisfied for s in r.steps]
                     for r in o.tenants]
    return {"max_tenant_rel_diff": float((np.abs(a - b) / np.abs(b)).max()),
            "fleet_rel_diff": float(abs(a.sum() - b.sum()) / b.sum()),
            "satisfied_flags_equal": sat(got) == sat(want)}


def _agrees(rec) -> bool:
    return (rec["max_tenant_rel_diff"] <= TENANT_RTOL
            and rec["fleet_rel_diff"] <= FLEET_RTOL
            and rec["satisfied_flags_equal"])


def _within_spread(kern, plains) -> dict:
    """Whether each tenant of the kernel replay lies within TENANT_RTOL of
    the same tenant in one of ``plains`` (the plain replay and its twins
    under one-ulp demand changes) with that run's satisfaction flags, and
    the fleet's cost integral within FLEET_RTOL of the sum of those chosen
    tenants' integrals; and the plain runs' own largest per-tenant
    spread."""
    import numpy as np
    cost = lambda o: np.asarray([r.metrics.cost_integral for r in o.tenants])
    flags = lambda o: [[s.metrics.satisfied for s in r.steps]
                       for r in o.tenants]
    k, kf = cost(kern), flags(kern)
    ps = [(cost(p), flags(p)) for p in plains]
    near, chosen = [], []
    for t in range(len(k)):
        cands = [(abs(k[t] - c[t]) / abs(c[t]), c[t]) for c, f in ps
                 if f[t] == kf[t]]
        rel, c_t = min(cands, default=(float("inf"), float("nan")))
        near.append(float(rel))
        chosen.append(c_t)
    fleet = float(abs(k.sum() - sum(chosen)) / sum(chosen))
    spread = np.max([np.abs(c - ps[0][0]) / np.abs(ps[0][0])
                     for c, _ in ps], axis=0)
    return {"tenant_rel_diff_to_nearest_plain": near,
            "fleet_rel_diff_to_chosen_plain": fleet,
            "plain_one_ulp_spread": [float(v) for v in spread],
            "within": bool(max(near) <= TENANT_RTOL
                           and fleet <= FLEET_RTOL)}


def scenario_base_specs(TenantSpec, make_trace) -> list:
    """The tenants of benchmarks/scenario_bench.py::_fleet before pricing:
    SCENARIO_TENANTS alternating diurnal and flash_crowd around
    SCENARIO_BASE x 25 x (0.7 + 0.2 (s mod 3)), noise 0.08, 2 starts,
    churn 6, SCENARIO_TICKS ticks. Built with the given ``TenantSpec`` and
    ``make_trace``, so a CPU test can build the same fleet with the JAX
    package's."""
    import numpy as np
    base = np.asarray(SCENARIO_BASE) * 25
    specs = []
    for s in range(SCENARIO_TENANTS):
        kind = ("diurnal", "flash_crowd")[s % 2]
        kw = dict(seed=s, noise=0.08)
        kw.update(dict(amplitude=0.45, phase=3.0 * s) if kind == "diurnal"
                  else dict(burst_scale=2.5, decay=5.0))
        specs.append(TenantSpec(
            name=f"{kind}{s}", n_starts=2, delta_max=6.0,
            trace=make_trace(kind, base * (0.7 + 0.2 * (s % 3)),
                             SCENARIO_TICKS, **kw)))
    return specs


def scenario_terms_checks(dev, ops) -> tuple:
    """The priced-scenario path on the card: (a) eq. (1) with all three
    scenario terms attached (spot risk on the spot catalog's twins, an SLO
    price, a flat eviction price), the kernel route against the plain
    route at RTOL / ATOL: the single-problem form at S = 72, n = 3760 and
    the fleet form at B = 8, n = 4096, T = 1 and 12; (b) the three fleets
    of benchmarks/scenario_bench.py (``with_slo_pricing``,
    ``with_priority_classes``, ``make_spot_fleet``) on the full catalog,
    SCENARIO_TENANTS tenants, SCENARIO_TICKS ticks, each replayed batched
    with the CA on, with the kernel and with ``hot_loop="ref"``, launch
    counts zeroed just before each kernel run and read just after; (c)
    ``grid_search`` on s3_enterprise with the solver bench's grid, kernel
    and plain. Raises unless (a) agrees, each kernel replay lies within
    TENANT_RTOL per tenant and FLEET_RTOL over the fleet of its plain twin
    with equal satisfaction — or, where it does not, each of its tenants
    lies within TENANT_RTOL of the same tenant in the plain replay or in
    one of its twins under one-ulp demand changes (ULP_STEPS), with that
    run's satisfaction flags, and the fleet within FLEET_RTOL of the sum
    of the tenants so chosen, as the bnb phase holds its answers to the
    reference's one-ulp spread — launched both fleet entries (the plain
    one nothing) and no replay holds an interrupted spot twin, and each
    grid point's rounded cost and eq. (1) lie within TENANT_RTOL of plain.
    Returns (record, probes): probes are (label, stacked problem, T) of the
    spot fleet and the grid, whose shapes the kernels line times."""
    from dataclasses import replace

    import numpy as np
    import torch
    import repro_torch.fleet.replay as replay_mod
    from repro_torch.core import objective as obj
    from repro_torch.core import terms as tterms
    from repro_torch.core.catalog import make_cloud_catalog
    from repro_torch.core.pareto import _grid_problem, grid_search
    from repro_torch.core.api import problem_from_scenario
    from repro_torch.core.problem import lane, matvec, problem_to
    from repro_torch.core.scenarios import build_scenarios
    from repro_torch.fleet import (TenantSpec, bucket_dims, make_spot_fleet,
                                   make_trace, replay_fleet, stack_problems,
                                   with_priority_classes, with_slo_pricing)
    catalog = make_cloud_catalog()
    specs = scenario_base_specs(TenantSpec, make_trace)
    spot_cat, spot_specs = make_spot_fleet(catalog, specs,
                                           interruption_rate=0.08)
    fleets = {
        "slo": (catalog, with_slo_pricing(specs, price=2.0)),
        "priority": (catalog, with_priority_classes(
            specs, SCENARIO_PRIORITIES, catalog=catalog,
            eviction_price=EVICTION_PRICE)),
        "spot": (spot_cat, spot_specs)}

    # (a) all three kinds on the spot fleet's tick-0 problems
    gen = torch.Generator(device=dev).manual_seed(1)
    probs = [replay_mod._make_controller(spot_cat, sp).make_problem(
        np.asarray(sp.trace[0])) for sp in spot_specs]
    extra = [tterms.make_term("slo_penalty", price=2.0),
             tterms.make_term("priority_eviction",
                              price=np.full(spot_cat.n, 0.05, np.float32))]
    three = [tterms.with_terms(p, list(p.terms) + extra) for p in probs]
    # the bucket the replay stacks the spot fleet in (n = 4096)
    pad = dict(zip(("n_max", "m_max", "p_max"), bucket_dims(
        spot_cat.n, len(spot_cat.matrices()[0]), len(spot_cat.providers))))
    spot_stack = stack_problems(probs, device=dev, **pad).problem
    three_stack = stack_problems(three, device=dev, **pad).problem
    single = problem_to(three[0], dev)

    def pts(prob, lead):
        # points from 1e-4 to 1 of a unit box: the smaller ones fall short
        # of the demand, so the SLO hinge and the shortage term are live
        scale = torch.logspace(-4, 0, lead[-1], device=dev)[:, None]
        mask = prob.mask if len(lead) == 1 else prob.mask[:, None, :]
        return (torch.rand((*lead, prob.n), generator=gen, device=dev)
                * scale * mask).contiguous()

    B = SCENARIO_TENANTS
    checks = []
    for label, prob, X in (
            ("single S=72", single, pts(single, (72,))),
            (f"fleet B={B},T=1", three_stack, pts(three_stack, (B, 1))),
            (f"fleet B={B},T={L_RUNGS}", three_stack,
             pts(three_stack, (B, L_RUNGS)))):
        fk, gk = obj.value_and_grad(prob, X, use_kernel=True)
        fp, gp = obj.value_and_grad(prob, X, use_kernel=False)
        rec = compare(f"terms {label}", torch.cat([fk.flatten(), gk.flatten()]),
                      torch.cat([fp.flatten(), gp.flatten()]))
        Kx = matvec(prob, prob.K, X)
        short = (lane(prob, prob.d, Kx) - Kx > 0).any(-1)
        checks.append({"case": label, "n": prob.n,
                       "kinds": [t.kind for t in prob.terms],
                       "short_share": float(short.float().mean()), **rec})

    # (b) the three scenario fleets, kernel then plain
    replays = {}
    for name, (cat, fleet) in fleets.items():
        runs = {}
        for who, hot_loop in (("kernel", "kernel"), ("plain", "ref")):
            ops.reset_launches()
            with ShapeCounts(ops, with_n=True) as shapes:
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                out = replay_fleet(cat, fleet, replay_mode="batched",
                                   run_ca_baseline=True, hot_loop=hot_loop,
                                   device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
            counts = np.stack([s.counts for r in out.tenants
                               for s in r.steps])
            if not (np.isfinite(counts).all()
                    and np.array_equal(counts, np.round(counts))):
                raise AssertionError(f"{name} {who}: non-integral counts")
            runs[who] = (out, _replay_record(out, wall, dict(ops.LAUNCHES),
                                             shapes.by_shape()))
        (k_out, k_rec), (p_out, p_rec) = runs["kernel"], runs["plain"]
        agree = _fleet_agreement(k_out, p_out)
        held = [_held_interrupted_twins(fleet, o) for o in (k_out, p_out)]
        replays[name] = {"n": cat.n, "kinds": sorted({t.kind for sp in fleet
                                                      for t in sp.terms}),
                         "kernel": k_rec, "plain": p_rec, **agree,
                         "interrupted_twins_held": held}
        if not _agrees(agree):
            # near-tied roundings: hold each tenant to the answers the
            # plain replay itself gives under one-ulp demand changes
            plains = [p_out]
            for k in ULP_STEPS:
                f = 1.0 + k * 2.0 ** -23
                twin = [replace(sp, trace=np.asarray(sp.trace) * f)
                        for sp in fleet]
                plains.append(replay_fleet(cat, twin, replay_mode="batched",
                                           run_ca_baseline=False,
                                           hot_loop="ref", device=dev))
            spread = _within_spread(k_out, plains)
            replays[name]["one_ulp_plain_spread"] = spread
            if not spread["within"]:
                raise AssertionError(f"{name}: the kernel replay disagrees "
                                     f"with the plain one and with its "
                                     f"one-ulp twins: {agree}, {spread}")
        if (not k_rec["launches"]["alloc_objective_fleet"]
                or not k_rec["launches"]["alloc_objective_fleet_value"]
                or any(p_rec["launches"].values())):
            raise AssertionError(f"{name}: launches {k_rec['launches']}, "
                                 f"plain {p_rec['launches']}")
        if any(held):
            raise AssertionError(f"{name}: interrupted spot twins held {held}")

    # (c) the solver bench's Pareto grid on s3_enterprise
    s3 = problem_from_scenario(catalog, build_scenarios(catalog)[2],
                               device=dev)
    grid = {}
    for who, use_kernel in (("kernel", True), ("plain", False)):
        ops.reset_launches()
        with ShapeCounts(ops, with_n=True) as shapes:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            pts_ = grid_search(s3, alphas=GRID_ALPHAS, gammas=GRID_GAMMAS,
                               use_kernel=use_kernel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        grid[who] = {"wall_s": wall, "launches": dict(ops.LAUNCHES),
                     "launches_by_shape": shapes.by_shape(),
                     "points": [{**p.params, "cost": p.cost,
                                 "fragmentation": p.fragmentation,
                                 "diversity": p.diversity,
                                 "objective": p.objective,
                                 "on_frontier": p.on_frontier}
                                for p in pts_]}
    cost = {w: np.asarray([p["cost"] for p in grid[w]["points"]])
            for w in grid}
    fval = {w: np.asarray([p["objective"] for p in grid[w]["points"]])
            for w in grid}
    grid["max_cost_rel_diff"] = float(
        (np.abs(cost["kernel"] - cost["plain"]) / cost["plain"]).max())
    grid["max_objective_rel_diff"] = float(
        (np.abs(fval["kernel"] - fval["plain"]) / fval["plain"]).max())
    if not (grid["max_cost_rel_diff"] <= TENANT_RTOL
            and grid["max_objective_rel_diff"] <= TENANT_RTOL):
        raise AssertionError(f"grid: kernel disagrees with plain: "
                             f"{grid['max_cost_rel_diff']}, "
                             f"{grid['max_objective_rel_diff']}")
    if (not grid["kernel"]["launches"]["alloc_objective_fleet"]
            or any(grid["plain"]["launches"].values())):
        raise AssertionError(f"grid launches {grid['kernel']['launches']}, "
                             f"plain {grid['plain']['launches']}")
    settings = [(a, 0.5, 0.05, 50.0, g) for a in GRID_ALPHAS
                for g in GRID_GAMMAS]
    grid_stack = _grid_problem(s3, settings)
    probes = [("spot", spot_stack, "alloc_objective_fleet", 1),
              ("spot", spot_stack, "alloc_objective_fleet_value", L_RUNGS),
              ("spot", spot_stack, "alloc_objective_fleet", 2),
              ("spot", spot_stack, "alloc_objective_fleet_value",
               2 * L_RUNGS),
              ("grid", grid_stack, "alloc_objective_fleet", 1),
              ("grid", grid_stack, "alloc_objective_fleet_value", L_RUNGS)]
    return ({"tenants": SCENARIO_TENANTS, "ticks": SCENARIO_TICKS,
             "objective_checks": checks, "replays": replays,
             "grid": grid}, probes)


def bucketing_checks(dev, ops, seed: int) -> tuple:
    """Shape bucketing on the card: BUCKET_TENANTS tenants spread over the
    full catalog's sub-catalogs ``instances[::k]``, k in BUCKET_STRIDES
    (n = 1880, 940, 235, 47), each tenant's tick-0 demand from the replay
    phase's tenant builder. ``solve_fleet_bucketed`` with the kernel and
    plain (``hot_loop="ref"``), and ``solve_fleet`` over the fleet padded
    to one n = 2048 stack with the kernel, from the same starts (drawn per
    tenant at its true shape); launch counts zeroed just before the
    bucketed kernel solve and read just after. Raises unless the bucketed
    kernel solve lies within TENANT_RTOL per tenant and FLEET_RTOL over
    the fleet of the bucketed plain one and of the global kernel one, with
    equal feasibility, and launched in every bucket. Returns (record,
    probes), probes (label, bucket's stacked problem, T) for the kernels
    line."""
    import numpy as np
    import torch
    from repro_torch.core.api import problem_from_demand
    from repro_torch.core.catalog import Catalog, make_cloud_catalog
    from repro_torch.fleet import (TenantSpec, bucket_problems, make_trace,
                                   padding_stats, solve_fleet,
                                   solve_fleet_bucketed, stack_problems)
    full = make_cloud_catalog()
    cats = [Catalog(full.instances[::k]) for k in BUCKET_STRIDES]
    tenants = make_tenants(TenantSpec, make_trace, BUCKET_TENANTS, 1, seed)
    probs = [problem_from_demand(cats[i % len(cats)],
                                 np.asarray(sp.trace[0]), device=dev)
             for i, sp in enumerate(tenants)]
    bucketed = bucket_problems(probs, device=dev)
    runs = {}

    def run(who, fn):
        ops.reset_launches()
        with ShapeCounts(ops, with_n=True) as shapes:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        runs[who] = (res, {"seconds": wall, "launches": dict(ops.LAUNCHES),
                           "launches_by_shape": shapes.by_shape()})

    run("bucketed_kernel", lambda: solve_fleet_bucketed(
        probs, bucketed=bucketed, hot_loop="kernel", device=dev))
    run("bucketed_plain", lambda: solve_fleet_bucketed(
        probs, bucketed=bucketed, hot_loop="ref", device=dev))
    glob = stack_problems(probs, n_max=2048, m_max=4, p_max=2, device=dev)
    run("global_kernel", lambda: solve_fleet(glob, hot_loop="kernel",
                                             device=dev))
    f = {w: r.fun_int.cpu().numpy().astype(np.float64)
         for w, (r, _) in runs.items()}
    feas = {w: r.feasible.cpu().numpy() for w, (r, _) in runs.items()}

    def agree(a, b):
        rel = np.abs(f[a] - f[b]) / np.abs(f[b])
        return {"max_tenant_rel_diff": float(rel.max()),
                "fleet_rel_diff": float(abs(f[a].sum() - f[b].sum())
                                        / abs(f[b].sum())),
                "feasible_equal": bool(np.array_equal(feas[a], feas[b])),
                "tenants_equal_exactly": int((f[a] == f[b]).sum())}

    rec = {"tenants": BUCKET_TENANTS, "strides": list(BUCKET_STRIDES),
           "n": [c.n for c in cats],
           "buckets": [[int(x) for x in b.problem.K.shape]
                       for b in bucketed.batches],
           "padding_bucketed": padding_stats(probs, bucketed),
           "padding_global": padding_stats(probs),
           "runs": {w: r for w, (_, r) in runs.items()},
           "kernel_vs_plain": agree("bucketed_kernel", "bucketed_plain"),
           "bucketed_vs_global": agree("bucketed_kernel", "global_kernel"),
           "feasible": int(feas["bucketed_kernel"].sum())}
    for key in ("kernel_vs_plain", "bucketed_vs_global"):
        r = rec[key]
        if not (r["max_tenant_rel_diff"] <= TENANT_RTOL
                and r["fleet_rel_diff"] <= FLEET_RTOL
                and r["feasible_equal"]):
            raise AssertionError(f"bucketing {key}: {r}")
    shapes = runs["bucketed_kernel"][1]["launches_by_shape"]
    for b in bucketed.batches:
        n = b.problem.K.shape[2]
        if not any(k.endswith(f",n={n}") for k in shapes):
            raise AssertionError(f"bucket n={n} never launched the kernel")
    if any(runs["bucketed_plain"][1]["launches"].values()):
        raise AssertionError("the plain bucketed solve launched kernels")
    n_starts = 4      # solve_fleet's default
    probes = [(f"bucket n={b.problem.K.shape[2]}", b.problem, entry, T)
              for b in bucketed.batches
              for entry, T in (("alloc_objective_fleet", n_starts),
                               ("alloc_objective_fleet_value",
                                n_starts * L_RUNGS))]
    return rec, probes


def mpc_checks(dev, ops) -> tuple:
    """The receding-horizon controller on the card, on the scenario
    phases' fleet before pricing (``scenario_base_specs``: 8 tenants
    alternating diurnal and flash_crowd, no terms; its traces' first
    MPC_TICKS ticks) over the full catalog (n = 1880 in the bucket's
    2048), batched, CA off:
    (a) ``controller="mpc", horizon=1`` with the kernel against the
    myopic batched kernel replay; (b) ``horizon=MPC_HORIZON``, the
    last-value forecaster, the adaptive engine, with the kernel (and
    ``run_oracle_baseline``: the regret against the oracle twin) and with
    ``hot_loop="ref"`` (no twin: it feeds no gate), launch counts zeroed
    just before each run and read just after, tick times from the replay's
    telemetry spans; (c) one ``solve_horizon_fleet_step`` with the ADMM
    engine and ``capture_trace=True`` on (b)'s tick-1 windows (the
    controllers stepped through tick 0 with (b)'s kernel counts), kernel
    and plain. Raises unless (a) commits the myopic replay's counts for
    every tenant and tick; (b) the kernel replay lies within TENANT_RTOL
    per tenant and FLEET_RTOL over the fleet of the plain one with equal
    satisfaction — or each tenant within TENANT_RTOL of the plain replay
    or of one of its twins under one-ulp demand changes (ULP_STEPS), and
    the fleet within FLEET_RTOL of those — and the kernel run launched the
    fleet entries at B = 8 x MPC_HORIZON (the plain run nothing); (c) the
    committed counts' eq. (1) (plain, at the tick-0 problems) of kernel
    and plain lie within TENANT_RTOL per lane and FLEET_RTOL summed, with
    equal feasibility, and the kernel run launched the planned prox's
    B·(H-1) stack; (d) profiles one adaptive warm step on the same
    windows, MPC_PROFILE_STEPS iterations. Returns (record, probes,
    observed): probes are (label, stacked problem, entry, T) of the window
    stack and the planned prox's stack, whose shapes the kernels line
    times; observed holds what ``obs_export_checks`` reads (the myopic
    replay and its recorder, the kernel ADMM step's trace and residual
    histories)."""
    from dataclasses import replace

    import numpy as np
    import torch
    import repro_torch.fleet.replay as replay_mod
    from repro_torch.core import objective as obj
    from repro_torch.core.catalog import make_cloud_catalog
    from repro_torch.fleet import (TenantSpec, bucket_dims, make_trace,
                                   replay_fleet)
    from repro_torch.horizon import (DEFAULT_COUPLING_EPS,
                                     DEFAULT_COUPLING_W, HorizonSolverConfig,
                                     admm_residual_history,
                                     solve_horizon_fleet_step, stack_windows)
    from repro_torch.horizon.problem import flatten_lanes
    from repro_torch.horizon.solver import _window
    from repro_torch.obs.telemetry import telemetry
    catalog = make_cloud_catalog()
    specs = [replace(sp, trace=np.asarray(sp.trace)[:MPC_TICKS])
             for sp in scenario_base_specs(TenantSpec, make_trace)]
    B, H = len(specs), MPC_HORIZON
    dims = bucket_dims(catalog.n, len(catalog.matrices()[0]),
                       len(catalog.providers))
    counts = lambda out: [[s.counts for s in r.steps] for r in out.tenants]
    mpc_kw = dict(replay_mode="batched", controller="mpc", horizon=H,
                  forecaster="last_value",
                  solver_config=HorizonSolverConfig(),
                  run_ca_baseline=False, device=dev)

    def run(hot_loop, fleet, **kw):
        """One replay, launches counted, its telemetry ticks timed; returns
        the result, its record and its telemetry recorder."""
        ops.reset_launches()
        with ShapeCounts(ops, with_n=True) as shapes, telemetry() as rec:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = replay_fleet(catalog, fleet, hot_loop=hot_loop, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        ticks = [e.dur_us / 1e6 for e in rec.spans("replay/tick")]
        flat = np.stack([c for r in counts(out) for c in r])
        if not (np.isfinite(flat).all()
                and np.array_equal(flat, np.round(flat))):
            raise AssertionError("mpc: non-integral counts")
        return out, {"wall_s": wall, "tick_s": ticks,
                     "launches": dict(ops.LAUNCHES),
                     "launches_by_shape": shapes.by_shape()}, rec

    # (a) H = 1 against the myopic batched kernel replay
    myo, myo_rec, myo_tel = run("kernel", specs, replay_mode="batched",
                                run_ca_baseline=False, device=dev)
    h1, h1_rec, _ = run("kernel", specs, **{**mpc_kw, "horizon": 1})
    h1_equal = all(np.array_equal(x, y) for a, b in zip(counts(myo),
                                                       counts(h1))
                   for x, y in zip(a, b))
    part_a = {"myopic": {k: myo_rec[k] for k in ("wall_s", "launches")},
              "mpc_h1": {k: h1_rec[k] for k in ("wall_s", "launches")},
              "counts_equal": h1_equal}
    if not h1_equal:
        raise AssertionError("mpc: H = 1 commits other counts than the "
                             "myopic replay")

    # (b) H = MPC_HORIZON, kernel (with the oracle twin) then plain
    runs = {}
    for who, hot_loop in (("kernel", "kernel"), ("plain", "ref")):
        out, rec, _ = run(hot_loop, specs,
                          run_oracle_baseline=who == "kernel", **mpc_kw)
        m = out.metrics
        ticks = rec["tick_s"][:MPC_TICKS]     # the replay's; the twin's next
        iters = [sum(r.steps[t].solver_iters for r in out.tenants)
                 for t in range(1, MPC_TICKS)]
        rec.update(cost_integral=m.total_cost_integral,
                   total_churn=m.total_churn,
                   slo_violation_ticks=m.total_slo_violation_ticks,
                   oracle_cost_integral=m.oracle_cost_integral,
                   regret_vs_oracle=m.regret_vs_oracle,
                   cold_tick_s=ticks[0], warm_tick_s=ticks[1:],
                   oracle_tick_s=rec["tick_s"][MPC_TICKS:],
                   pgd_iters_per_warm_tick=iters,
                   pgd_iters_per_lane_per_warm_tick=[i / B for i in iters],
                   summary=m.summary().splitlines())
        del rec["tick_s"]
        runs[who] = (out, rec)
    (k_out, k_rec), (p_out, p_rec) = runs["kernel"], runs["plain"]
    part_b = {"horizon": H, "kernel": k_rec, "plain": p_rec,
              **_fleet_agreement(k_out, p_out)}
    if not _agrees(part_b):
        plains = [p_out]
        for k in ULP_STEPS:
            f = 1.0 + k * 2.0 ** -23
            twin = [replace(sp, trace=np.asarray(sp.trace) * f)
                    for sp in specs]
            plains.append(run("ref", twin, **mpc_kw)[0])
        spread = _within_spread(k_out, plains)
        part_b["one_ulp_plain_spread"] = spread
        if not spread["within"]:
            raise AssertionError(f"mpc: the kernel replay disagrees with "
                                 f"the plain one and its one-ulp twins: "
                                 f"{spread}")
    n_pad = dims[0]
    for key in (f"alloc_objective_fleet@B={B * H},T=1,n={n_pad}",
                f"alloc_objective_fleet_value@B={B * H},T={L_RUNGS},"
                f"n={n_pad}"):
        if not k_rec["launches_by_shape"].get(key):
            raise AssertionError(f"mpc: {key} never launched")
    if any(p_rec["launches"].values()):
        raise AssertionError(f"mpc: the plain replay launched "
                             f"{p_rec['launches']}")

    # (c) ADMM on (b)'s tick-1 windows
    ctls = [replay_mod._make_mpc_controller(
        catalog, sp, horizon=H, forecaster="last_value",
        forecaster_kwargs=None, coupling_w=DEFAULT_COUPLING_W,
        coupling_eps=DEFAULT_COUPLING_EPS,
        solver_config=HorizonSolverConfig())
        for sp in specs]
    for ctl, sp, rep in zip(ctls, specs, k_out.tenants):
        ctl.window_demands(np.asarray(sp.trace[0]))
        ctl.apply_counts(sp.trace[0], rep.steps[0].counts, replanned=True)
        ctl.plan = np.tile(rep.steps[0].counts, (H, 1))
    wins = [ctl.window_problems(ctl.window_demands(np.asarray(sp.trace[1])))
            for ctl, sp in zip(ctls, specs)]
    hp = stack_windows(wins, n_max=dims[0], m_max=dims[1], p_max=dims[2],
                       device=dev)
    X_cur = np.zeros((B, dims[0]), np.float32)
    X_init = np.zeros((B, H, dims[0]), np.float32)
    for i, ctl in enumerate(ctls):
        X_cur[i, :catalog.n] = ctl.x_current
        X_init[i, :, :catalog.n] = ctl.shifted_plan()
    delta = np.asarray([sp.delta_max for sp in specs], np.float32)
    W = _window(hp.problem, hp.coupling_w, hp.coupling_eps, B, H)
    admm, admm_traced = {}, {}
    for who, hot_loop in (("kernel", "kernel"), ("plain", "ref")):
        ops.reset_launches()
        with ShapeCounts(ops, with_n=True) as shapes:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = solve_horizon_fleet_step(
                hp, X_cur, delta, x_init=X_init,
                cfg=HorizonSolverConfig(solver="admm"), capture_trace=True,
                hot_loop=hot_loop, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        primal = res.diag.primal_res.cpu().numpy()
        worst = int(np.argmax(primal))
        lanes = [admm_residual_history(type(res.trace)(
            *(f[b] for f in res.trace))) for b in range(B)]
        hist = lanes[worst]
        admm_traced[who] = (res.trace, lanes)
        admm[who] = {
            "seconds": wall, "launches": dict(ops.LAUNCHES),
            "launches_by_shape": shapes.by_shape(),
            "outer_iters": res.diag.admm_iters.cpu().tolist(),
            "inner_iters": res.iters.cpu().tolist(),
            "final_primal": primal.tolist(),
            "final_dual": res.diag.dual_res.cpu().tolist(),
            "worst_lane": worst,
            "first_primal": [float(h[0][0]) for h in lanes],
            "worst_primal_history": hist[0].tolist(),
            "worst_dual_history": hist[1].tolist(),
            "fun_int": obj.objective(W.P0, res.x_int,
                                     use_kernel=False).cpu().numpy(),
            "feasible": res.feasible.cpu().tolist()}
    fk, fp = admm["kernel"]["fun_int"], admm["plain"]["fun_int"]
    rel = np.abs(fk - fp) / np.abs(fp)
    for who in admm:
        admm[who]["fun_int"] = admm[who]["fun_int"].tolist()
    part_c = {"max_lane_rel_diff": float(rel.max()),
              "sum_rel_diff": float(abs(fk.sum() - fp.sum()) / fp.sum()),
              "feasible_equal": (admm["kernel"]["feasible"]
                                 == admm["plain"]["feasible"]), **admm}
    if not (part_c["max_lane_rel_diff"] <= TENANT_RTOL
            and part_c["sum_rel_diff"] <= FLEET_RTOL
            and part_c["feasible_equal"]):
        raise AssertionError(f"mpc: the ADMM kernel step disagrees with "
                             f"plain: {part_c['max_lane_rel_diff']}, "
                             f"{part_c['sum_rel_diff']}")
    key = f"alloc_objective_fleet@B={B * (H - 1)},T=1,n={n_pad}"
    if not admm["kernel"]["launches_by_shape"].get(key):
        raise AssertionError(f"mpc: {key} never launched")
    # (d) one adaptive warm step on the same windows under torch.profiler,
    # MPC_PROFILE_STEPS iterations: the MPC warm tick's device busy share
    # and launches an iteration
    step = lambda: solve_horizon_fleet_step(
        hp, X_cur, delta, x_init=X_init, device=dev,
        cfg=HorizonSolverConfig(steps=MPC_PROFILE_STEPS))
    warm = step()
    torch.cuda.synchronize()
    prof = profile_once(step, top_n=8, match="alloc_objective")
    part_d = {"what": "one solve_horizon_fleet_step, adaptive, tick 1",
              "iters": warm.iters.cpu().tolist(), **prof}
    probes = [("window", flatten_lanes(hp.problem), "alloc_objective_fleet",
               1),
              ("window", flatten_lanes(hp.problem),
               "alloc_objective_fleet_value", L_RUNGS),
              ("admm_planned", W.rest, "alloc_objective_fleet", 1),
              ("admm_planned", W.rest, "alloc_objective_fleet_value",
               L_RUNGS)]
    observed = {"replay": myo, "recorder": myo_tel,
                "admm_trace": admm_traced["kernel"][0],
                "admm_history": admm_traced["kernel"][1]}
    return ({"tenants": B, "ticks": MPC_TICKS, "n": catalog.n,
             "bucket": list(dims), "h1_vs_myopic": part_a,
             "replay": part_b, "admm": part_c, "profile": part_d}, probes,
            observed)


def obs_export_checks(replay, recorder, admm_trace, admm_history) -> dict:
    """The port's observability exports on the mpc phase's records, no new
    replay: the myopic batched kernel replay's recorder written with
    ``write_jsonl`` and ``write_chrome_trace`` to a temporary directory,
    both files revalidated, and rolled up by ``ReplayReport``; and
    ``admm_trace_summary`` of each lane of the kernel ADMM step's trace
    (CUDA tensors) against ``admm_residual_history`` of the same lane.
    Raises on a validation problem, a report without a ``replay/tick``
    span or with other tick counts than the replay's, a ``replay/stack``
    span holding no ``stack/padding_waste`` sample, or a summary that is
    not the residual history's."""
    import tempfile

    from repro_torch.obs import (ReplayReport, admm_trace_summary,
                                 lane_trace, validate_chrome_trace,
                                 validate_jsonl, write_chrome_trace,
                                 write_jsonl)
    with tempfile.TemporaryDirectory() as tmp:
        trace = write_chrome_trace(recorder, Path(tmp) / "trace.json")
        jsonl = write_jsonl(recorder, Path(tmp) / "trace.jsonl")
        problems = ([f"trace: {p}" for p in validate_chrome_trace(trace)]
                    + [f"jsonl: {p}" for p in validate_jsonl(jsonl)])
        sizes = {"trace_bytes": trace.stat().st_size,
                 "jsonl_bytes": jsonl.stat().st_size}
    report = ReplayReport.from_recorder(recorder)
    ticks = max(len(t.steps) for t in replay.tenants)
    waste = [ts for ts, _ in recorder.gauges.get("stack/padding_waste", [])]
    stacks = recorder.spans("replay/stack")
    unsampled = [e.tags for e in stacks
                 if not any(e.ts_us <= ts <= e.ts_us + e.dur_us
                            for ts in waste)]
    summaries = [admm_trace_summary(lane_trace(admm_trace, b))
                 for b in range(len(admm_history))]
    admm_equal = [bool(
        s["admm_iters"] == len(primal) and s["primal_first"] == primal[0]
        and s["primal_final"] == primal[-1] and s["dual_first"] == dual[0]
        and s["dual_final"] == dual[-1])
        for s, (primal, dual) in zip(summaries, admm_history)]
    rec = {"problems": problems, **sizes, "spans": len(recorder.events),
           "report_ticks": report.n_ticks, "replay_ticks": ticks,
           "stack_spans": len(stacks), "padding_waste_samples": len(waste),
           "stack_spans_unsampled": unsampled, "report": report.to_dict(),
           "admm_summaries": summaries, "admm_summary_equal": admm_equal}
    if problems:
        raise AssertionError(f"obs_export: invalid exports: {problems}")
    if not recorder.spans("replay/tick") or report.n_ticks != ticks:
        raise AssertionError(f"obs_export: the report counts "
                             f"{report.n_ticks} ticks, the replay {ticks}")
    if not stacks or unsampled:
        raise AssertionError(f"obs_export: replay/stack spans without a "
                             f"padding_waste sample: {unsampled} of "
                             f"{len(stacks)}")
    if not (summaries and all(admm_equal)):
        raise AssertionError(f"obs_export: admm_trace_summary differs from "
                             f"admm_residual_history: {admm_equal}")
    return rec


def serve_alloc_checks(dev, ops, seed: int) -> dict:
    """The online allocation service on the card (``repro_torch.serve``):
    the demo session of ``python -m repro_torch.serve`` (full catalog,
    SERVE_LANES lanes, SERVE_TICKS ticks, flash-crowd demand, one
    departure at mid-session) through ``run_demo``.

    (a) with the kernel and with ``hot_loop="ref"``, no deadline; launch
        counts zeroed just before the kernel session and read just after,
        by entry and shape. Raises unless the two make the same decisions
        with equal feasibility and staleness, each decision's objective
        within TENANT_RTOL of the plain one and their sum within
        FLEET_RTOL, and the kernel session launched both fleet entries and
        the single-problem one while the plain one launched nothing.
    (b) with the kernel under a deadline of half (a)'s median warm-tick
        time. Raises unless every decision is feasible, one at least
        reports ``deadline_hit``, and no warm solve outlasts its budget by
        more than its longest chunk plus its fixed work (the chunked
        state's init, and the setup and rounding around the chunk loop,
        each timed with a synchronize) plus SERVE_SLACK_MS of host time.
    (c) the degradation sweep of ``benchmarks/serve_bench.py`` at the full
        catalog: one warm solve (demand x3 from the kernel multistart's
        answer at the base demand, delta_max 64) under budgets of
        DEGRADATION_BUDGETS ms, chunks of 8 iterations and a fake clock
        at 0.25 ms a reading, with the kernel and plain. Raises unless
        both pass the bench's five checks, the two engines' rounded
        objectives agree within TENANT_RTOL at every budget, and the
        generous budget gives the untruncated solve bit for bit.
    (d) a short session (HEALTH_LANES lanes, 3 ticks) with
        ``HealthMonitor(kkt_every=1)``: every decision certified by
        ``kkt_report`` on the card, the certificates timed apart. Raises
        unless every stationarity residual is finite."""
    import numpy as np
    import torch
    import repro_torch.core.incremental as incremental_mod
    import repro_torch.obs.health as health_mod
    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import (is_feasible, make_cloud_catalog,
                                  multistart_solve, objective_value,
                                  problem_from_demand, round_and_polish,
                                  solve_incremental_info)
    from repro_torch.core.controller import (
        InfrastructureOptimizationController as Ctl)
    from repro_torch.core.pgd import AnytimeConfig
    from repro_torch.fleet.traces import flash_crowd_trace
    from repro_torch.obs import HealthMonitor
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.__main__ import run_demo
    catalog = make_cloud_catalog()
    times = collections.defaultdict(list)
    anytime_log = []
    wrapped = {"cold": Ctl.cold_start_counts,
               "kkt": health_mod.HealthMonitor._certify,
               "warm": engine_mod.ServeEngine._warm_solve,
               "solve": engine_mod.solve_fleet_step,
               "run_anytime": incremental_mod.run_anytime}

    def synced(kind):
        fn = wrapped[kind]

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - s0) * 1e3)
            return out
        return wrapper

    def timed_anytime(init_fn, chunk_fn, cfg, anytime):
        chunk_ms, init_ms = [], []

        def init():
            s0 = time.perf_counter()
            out = init_fn()
            torch.cuda.synchronize()
            init_ms.append((time.perf_counter() - s0) * 1e3)
            return out

        def chunk(state, it_end):
            s0 = time.perf_counter()
            out = chunk_fn(state, it_end)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - s0) * 1e3)
            return out

        s0 = time.perf_counter()
        state, report = wrapped["run_anytime"](init, chunk, cfg, anytime)
        anytime_log.append({
            "budget_ms": anytime.deadline_ms, "chunks": report.chunks,
            "deadline_hit": report.deadline_hit,
            "anytime_ms": (time.perf_counter() - s0) * 1e3,
            "init_ms": init_ms[0], "max_chunk_ms": max(chunk_ms, default=0.0),
            "solve_index": len(times["solve"])})
        return state, report

    def session(hot_loop, deadline_ms):
        times.clear()
        anytime_log.clear()
        ops.reset_launches()
        with ShapeCounts(ops) as shapes:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            eng = run_demo(lanes=SERVE_LANES, ticks=SERVE_TICKS,
                           deadline_ms=deadline_ms, seed=seed,
                           hot_loop=hot_loop, device=dev, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        s = eng.summary()
        warm = list(times["warm"])
        return eng, {
            "hot_loop": hot_loop, "deadline_ms": deadline_ms, "wall_s": wall,
            "decisions": s.decisions, "ticks": s.ticks,
            "p50_latency_ms": s.p50_latency_ms,
            "p99_latency_ms": s.p99_latency_ms, "miss_rate": s.miss_rate,
            "truncated_rate": s.truncated_rate,
            "mean_staleness": s.mean_staleness,
            "max_staleness": s.max_staleness,
            "cold_joins": len(times["cold"]),
            "cold_join_s": sum(times["cold"]) / 1e3,
            "warm_ticks": len(warm), "warm_tick_s": sum(warm) / 1e3,
            "warm_tick_ms_median": float(np.median(warm)) if warm else None,
            "warm_tick_ms_max": max(warm, default=None),
            "launches": dict(ops.LAUNCHES),
            "launches_by_shape": shapes.by_shape()}

    Ctl.cold_start_counts = synced("cold")
    engine_mod.ServeEngine._warm_solve = synced("warm")
    engine_mod.solve_fleet_step = synced("solve")
    incremental_mod.run_anytime = timed_anytime
    try:
        # (a) kernel against plain, no deadline
        k_eng, k_rec = session("kernel", None)
        solves_k = list(times["solve"])
        p_eng, p_rec = session("ref", None)
        # (b) the kernel under a real deadline
        deadline = 0.5 * k_rec["warm_tick_ms_median"]
        d_eng, d_rec = session("kernel", deadline)
        solve_ms = list(times["solve"])
        budgets = list(anytime_log)
    finally:
        Ctl.cold_start_counts = wrapped["cold"]
        engine_mod.ServeEngine._warm_solve = wrapped["warm"]
        engine_mod.solve_fleet_step = wrapped["solve"]
        incremental_mod.run_anytime = wrapped["run_anytime"]
    k_l = k_rec["launches"]
    if not (k_l["alloc_objective"] and k_l["alloc_objective_fleet"]
            and k_l["alloc_objective_fleet_value"]):
        raise AssertionError(f"serve (a): the kernel session launched {k_l}")
    if any(p_rec["launches"].values()):
        raise AssertionError(f"serve (a): the plain session launched "
                             f"{p_rec['launches']}")
    key = lambda r: (r.tick, r.tenant)
    if [key(r) for r in k_eng.records] != [key(r) for r in p_eng.records]:
        raise AssertionError("serve (a): the two sessions decided other "
                             "(tick, tenant) pairs")
    obj_k = np.asarray([r.objective for r in k_eng.records])
    obj_p = np.asarray([r.objective for r in p_eng.records])
    rel = np.abs(obj_k - obj_p) / np.abs(obj_p)
    agg = abs(obj_k.sum() - obj_p.sum()) / obj_p.sum()
    flags = lambda e: [(r.feasible, r.staleness, r.cold) for r in e.records]
    gate_a = {"max_decision_rel_diff": float(rel.max()),
              "aggregate_rel_diff": float(agg),
              "feasibility_staleness_equal": flags(k_eng) == flags(p_eng),
              "all_feasible": bool(all(r.feasible for r in k_eng.records)),
              "warm_solve_ms": solves_k}
    if not (rel.max() <= TENANT_RTOL and agg <= FLEET_RTOL
            and gate_a["feasibility_staleness_equal"]):
        raise AssertionError(f"serve (a): kernel against plain {gate_a}")
    over = []
    for log in budgets:
        total = solve_ms[log["solve_index"]]
        fixed = log["init_ms"] + (total - log["anytime_ms"])
        over.append({**log, "solve_ms": total,
                     "overrun_ms": total - log["budget_ms"],
                     "allowed_ms": log["max_chunk_ms"] + fixed
                     + SERVE_SLACK_MS})
    gate_b = {"deadline_ms": deadline,
              "all_feasible": bool(all(r.feasible for r in d_eng.records)),
              "deadline_hits": int(sum(r.deadline_hit
                                       for r in d_eng.records)),
              "warm_solves": over,
              "overruns": [o for o in over
                           if o["overrun_ms"] > o["allowed_ms"]]}
    if not (gate_b["all_feasible"] and gate_b["deadline_hits"]
            and len(over) == d_rec["warm_ticks"] and not gate_b["overruns"]):
        raise AssertionError(f"serve (b): the deadline session {gate_b}")
    # (c) the degradation sweep, kernel and plain
    s0 = time.perf_counter()
    base = np.asarray(SERVE_BASE, np.float64)
    x_cur = multistart_solve(problem_from_demand(catalog, base, device=dev),
                             n_starts=4).x_int
    prob = problem_from_demand(catalog, base * 3.0, device=dev)
    sweep = {}
    for who, use_kernel in (("kernel", True), ("plain", False)):
        rows = []
        ops.reset_launches()
        for budget in DEGRADATION_BUDGETS:
            t = [0.0]

            def clock():
                t[0] += 0.25e-3
                return t[0]

            x_best, iters, report = solve_incremental_info(
                prob, x_cur, 64.0, use_kernel=use_kernel,
                anytime=AnytimeConfig(deadline_ms=budget, chunk_iters=8,
                                      clock=clock))
            x_int = round_and_polish(prob, x_best, use_kernel=use_kernel)
            rows.append({
                "budget_ms": budget, "iters": int(iters),
                "deadline_hit": report.deadline_hit,
                "chunks": report.chunks,
                "objective_relaxed": float(objective_value(
                    prob, x_best, use_kernel)),
                "objective_int": float(objective_value(prob, x_int,
                                                       use_kernel)),
                "feasible": bool(is_feasible(prob, x_int, 1e-3))})
        x_full, it_full = solve_incremental_info(prob, x_cur, 64.0,
                                                 use_kernel=use_kernel)
        merits = [r["objective_relaxed"] for r in rows]
        checks = {
            "monotone_objective": all(b <= a + 1e-6 for a, b in
                                      zip(merits, merits[1:])),
            "monotone_iters": all(r2["iters"] >= r1["iters"]
                                  for r1, r2 in zip(rows, rows[1:])),
            "all_feasible": all(r["feasible"] for r in rows),
            "tight_budget_truncates": rows[0]["deadline_hit"],
            "generous_budget_completes": not rows[-1]["deadline_hit"],
            "generous_equals_untruncated": bool(
                torch.equal(x_best, x_full) and int(iters) == int(it_full))}
        sweep[who] = {"rows": rows, "checks": checks,
                      "launches": dict(ops.LAUNCHES)}
        if not all(checks.values()):
            raise AssertionError(f"serve (c) {who}: {checks}")
    rel_c = [abs(a["objective_int"] - b["objective_int"])
             / abs(b["objective_int"]) for a, b in
             zip(sweep["kernel"]["rows"], sweep["plain"]["rows"])]
    sweep["kernel_vs_plain_rel_diff"] = rel_c
    if max(rel_c) > TENANT_RTOL:
        raise AssertionError(f"serve (c): kernel against plain {rel_c}")
    if not sweep["kernel"]["launches"]["alloc_objective_fleet"] or any(
            sweep["plain"]["launches"].values()):
        raise AssertionError("serve (c): launches "
                             f"{sweep['kernel']['launches']}, plain "
                             f"{sweep['plain']['launches']}")
    sweep["seconds"] = time.perf_counter() - s0
    # (d) the health monitor certifying every decision on the card
    s0 = time.perf_counter()
    times.clear()
    rng = np.random.default_rng(seed)
    mon = HealthMonitor(kkt_every=1)
    eng = ServeEngine(catalog, HEALTH_LANES, health=mon, device=dev)
    traces = [flash_crowd_trace(base * rng.uniform(0.5, 1.5, size=4), 3,
                                seed=seed + k) for k in range(HEALTH_LANES)]
    health_mod.HealthMonitor._certify = synced("kkt")
    try:
        for k, tr in enumerate(traces):
            eng.register(f"t{k}", demand=tr[0])
        eng.tick()
        for t in (1, 2):
            for k, tr in enumerate(traces):
                eng.submit(f"t{k}", tr[t])
            eng.tick()
    finally:
        health_mod.HealthMonitor._certify = wrapped["kkt"]
    rep = mon.report()
    health = {"lanes": HEALTH_LANES, "decisions": len(eng.records),
              "kkt_ticks_certified": rep.kkt_ticks_certified,
              "kkt_ms": times["kkt"],
              "worst_kkt_stationarity": rep.worst_kkt_stationarity,
              "worst_kkt": rep.worst_kkt,
              "nonfinite_events": rep.nonfinite_events,
              "seconds": time.perf_counter() - s0}
    if not (rep.nonfinite_events == 0 and rep.kkt_ticks_certified
            == len(eng.records) and rep.worst_kkt_stationarity is not None
            and np.isfinite(rep.worst_kkt_stationarity)):
        raise AssertionError(f"serve (d): {health}")
    return {"n": catalog.n, "lanes": SERVE_LANES, "ticks": SERVE_TICKS,
            "kernel": k_rec, "plain": p_rec, "kernel_vs_plain": gate_a,
            "deadline": d_rec, "deadline_gate": gate_b,
            "degradation": sweep, "health": health}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=4)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    import repro_torch.fleet.replay as replay_mod
    from repro_torch.core.catalog import make_cloud_catalog
    from repro_torch.fleet import TenantSpec, make_trace, replay_fleet
    from repro_torch.fleet.batching import stack_problems, tenant_problem
    from repro_torch.kernels.alloc_objective import ops, ref
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as sops
    from repro_torch.obs.provenance import provenance_block
    sources = {"alloc_objective": ops.SOURCE, "flash_attention": fops.SOURCE,
               "decode_attention": dops.SOURCE, "rwkv6_scan": sops.SOURCE}

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi,
          "provenance": provenance_block(config=vars(args),
                                         seeds=[args.seed], device=dev),
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = build_libraries(list(sources.values()))
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "libraries": {
        name: {"library": libs[src].name,
               "ptxas": [ln.strip() for ln in
                         libs[src].with_suffix(".log").read_text().splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln]}
        for name, src in sources.items()}})

    for phase, kernel in (("flash_build", "flash_attention"),
                          ("rwkv_build", "rwkv6_scan")):
        emit({"phase": phase, **build_report(kernel, libs[sources[kernel]])})

    # ---- inputs: the fleet's tick-0 problems, as the replay stacks them --
    catalog = make_cloud_catalog()
    tenants = make_tenants(TenantSpec, make_trace, args.tenants, args.ticks,
                           args.seed)
    ctls = [replay_mod._make_controller(catalog, s) for s in tenants]
    groups = replay_mod._replay_batch_groups(ctls, tenants)
    if len(groups) != 1:
        raise AssertionError(f"expected one shape bucket, got {list(groups)}")
    (n_pad, m_pad, p_pad, n_starts), = groups
    probs = [c.make_problem(np.asarray(s.trace[0])) for c, s in
             zip(ctls, tenants)]
    batch = stack_problems(probs, n_max=n_pad, m_max=m_pad, p_max=p_pad,
                           device=dev)
    ragged = stack_problems(probs, device=dev)     # unpadded n = 1880

    # ---- kernels ------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    L = 12   # SolverConfig().n_backtracks: the ladder's rungs per start

    def points(prob, T):
        B, n = prob.c.shape
        return (2.0 * torch.rand((B, T, n), generator=gen, device=dev)
                * prob.mask[:, None, :]).contiguous()

    def plain_args(prob):
        Q = prob.params
        return (prob.K, prob.E, prob.c, prob.d, Q.alpha, Q.beta1, Q.beta2,
                Q.beta3, Q.gamma)

    t0 = time.perf_counter()
    one = torch.zeros(1, device=dev)
    launch_floor_ms = device_ms(lambda: one.add_(1))
    measured = {}
    checks = []
    def fleet_case(name, T, prob, timed):
        """A fleet entry at (B, T) on ``prob`` against its plain version;
        device ms, plan and bound where ``timed``."""
        X = points(prob, T)
        B, n = prob.c.shape
        grad = name == "alloc_objective_fleet"
        scal = ops._fleet_scalars(prob)
        launch = lambda: ops._launch(name, X, prob.K, prob.E, prob.c, prob.d,
                                     scal, grad)
        if grad:
            f, g = ops.fleet_value_and_grad(prob, X)
            fr, gr = ref.alloc_objective_fleet_ref(X, *plain_args(prob))
            rec = compare(name, torch.cat([f.flatten(), g.flatten()]),
                          torch.cat([fr.flatten(), gr.flatten()]))
            kern = lambda: ops.fleet_value_and_grad(prob, X)
            plain = lambda: ref.alloc_objective_fleet_ref(X, *plain_args(prob))
        else:
            f = ops.fleet_value(prob, X)
            fr = ref.alloc_objective_fleet_value(X, *plain_args(prob))
            rec = compare(name, f, fr)
            kern = lambda: ops.fleet_value(prob, X)
            plain = lambda: ref.alloc_objective_fleet_value(
                X, *plain_args(prob))
        torch.cuda.synchronize()
        rec.update(name=name, shape={"B": B, "T": T, "n": n, "m": m_pad,
                                     "p": p_pad})
        if timed:
            bound_ms, bound_by, nbytes, flops = kernel_bound(
                B, T, n, m_pad, p_pad, grad)
            plan = ops.launch_plan(B, T, n, m_pad, p_pad,
                                   ops._sm_count(dev.index))
            rec.update(**timings(kern, plain, launch), bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, flops=flops,
                       plan=plan._asdict())
        checks.append(rec)
        return rec

    def single_case(S):
        """The single-problem entry at S points of tenant 0 (n = 1880)
        against its plain version, timed, with its bound."""
        Xs = (2.0 * torch.rand((S, single.n), generator=gen, device=dev)
              * single.mask).contiguous()
        f, g = ops.batched_value_and_grad(single, Xs)
        fr, gr = ref.alloc_objective_ref(Xs, *plain_args(single))
        rec = compare("alloc_objective", torch.cat([f, g.flatten()]),
                      torch.cat([fr, gr.flatten()]))
        bound_ms, bound_by, nbytes, flops = kernel_bound(1, S, single.n,
                                                         m_pad, p_pad, True)
        scal = ops._single_scalars(single)
        rec.update(name="alloc_objective",
                   shape={"S": S, "n": single.n, "m": m_pad, "p": p_pad},
                   **timings(lambda: ops.batched_value_and_grad(single, Xs),
                             lambda: ref.alloc_objective_ref(
                                 Xs, *plain_args(single)),
                             lambda: ops._launch(
                                 "alloc_objective", Xs[None], single.K[None],
                                 single.E[None], single.c[None],
                                 single.d[None], scal, True)),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops)
        checks.append(rec)
        return rec

    # the replay's shapes (entry, T): the cold tick's ladder and gradient
    # (the first of each is the kernels line's), its value after rounding,
    # the warm tick's ladder and gradient; each on the padded bucket (timed)
    # and on the unpadded catalog (n = 1880, checked)
    shapes = [("alloc_objective_fleet_value", n_starts * L),
              ("alloc_objective_fleet", n_starts),
              ("alloc_objective_fleet_value", n_starts),
              ("alloc_objective_fleet_value", L),
              ("alloc_objective_fleet", 1)]
    for (name, T), prob in itertools.product(shapes, (batch.problem,
                                                       ragged.problem)):
        rec = fleet_case(name, T, prob, timed=prob.c.shape[1] == n_pad)
        if prob.c.shape[1] == n_pad:
            measured.setdefault(name, rec)
    # the single-problem entry on tenant 0 (n = 1880): S = 128 points, then
    # the scenario pipeline's ladder, 6 starts x L rungs (the kernels line's)
    single = tenant_problem(batch, 0)
    for S in (128, SCENARIO_STARTS * L):
        rec = single_case(S)
    measured["alloc_objective"] = rec
    # this slice's shapes at n = 1880, keyed as ShapeCounts keys them: a
    # branch-and-bound node's ladder (S = 12) and gradient (S = 1) and the
    # sequential cold tick's ladder (S = 4 * L) and gradient (S = 4) in the
    # single-problem form; the sequential warm tick's gradient (T = 1) and
    # ladder (T = L) in the fleet forms at B = 1 (tenant 0 alone)
    slice_measured = {f"alloc_objective@B=1,T={S}": single_case(S)
                      for S in (L, 1, n_starts * L, n_starts)}
    alone = stack_problems([probs[0]], device=dev).problem
    for name, T in (("alloc_objective_fleet", 1),
                    ("alloc_objective_fleet_value", L)):
        slice_measured[f"{name}@B=1,T={T}"] = fleet_case(name, T, alone,
                                                         timed=True)
    # the serving engine's warm tick: SERVE_LANES lanes, unpadded n = 1880
    lanes = stack_problems(probs[:SERVE_LANES], device=dev).problem
    serve_measured = {
        f"{name}@B={SERVE_LANES},T={T}": fleet_case(name, T, lanes,
                                                    timed=True)
        for name, T in (("alloc_objective_fleet", 1),
                        ("alloc_objective_fleet_value", L))}
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "rtol": RTOL, "atol": ATOL, "launch_floor_ms": launch_floor_ms,
          "checks": checks})

    # ---- replay: the main path, kernel then plain ------------------------
    solve_log = []

    def timed(fn, kind_):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            solve_log.append({"solve": kind_,
                              "seconds": time.perf_counter() - s0,
                              "iters": int(res.iters.sum())})
            return res
        return wrapper

    replay_mod.solve_fleet = timed(replay_mod.solve_fleet, "cold")
    replay_mod.solve_fleet_step = timed(replay_mod.solve_fleet_step, "warm")
    # the CA baseline's host time, kept apart from the ticks'
    ca_log = []
    ca_fleet = replay_mod._replay_ca_fleet

    def timed_ca(*a, **kw):
        s0 = time.perf_counter()
        out = ca_fleet(*a, **kw)
        ca_log.append(time.perf_counter() - s0)
        return out

    replay_mod._replay_ca_fleet = timed_ca

    def run(hot_loop):
        solve_log.clear()
        ca_log.clear()
        for kernel_ops in (ops, fops, dops, sops):
            kernel_ops.reset_launches()
        with ShapeCounts(ops) as shapes:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = replay_fleet(catalog, tenants, replay_mode="batched",
                               run_ca_baseline=True, ca_engine="vectorized",
                               hot_loop=hot_loop)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        if any({**fops.LAUNCHES, **dops.LAUNCHES, **sops.LAUNCHES}.values()):
            raise AssertionError("the replay launched a model's kernels")
        return (out, wall, sum(ca_log), dict(ops.LAUNCHES), list(solve_log),
                shapes.by_shape())

    def summary(out, wall, ca_s, launches, solves, launches_by_shape):
        sat = np.asarray([[s.metrics.satisfied for s in r.steps]
                          for r in out.tenants])
        counts = np.stack([s.counts for r in out.tenants for s in r.steps])
        if not (np.isfinite(counts).all() and (counts >= 0).all()
                and np.array_equal(counts, np.round(counts))):
            raise AssertionError("replay committed non-integral counts")
        m = out.metrics
        return {"wall_s": wall, "ticks": args.ticks, "ca_s": ca_s,
                "tick_solves": solves,
                "host_s_per_tick": (wall - ca_s
                                    - sum(s["seconds"] for s in solves))
                / args.ticks,
                "ca_cost_integral": m.baseline_cost_integral,
                "cost_savings_vs_baseline_pct":
                    m.cost_savings_vs_baseline_pct,
                "ca_slo_violation_ticks": sum(t.slo_violation_ticks
                                              for t in m.baseline),
                "launches": launches,
                "launches_by_shape": launches_by_shape,
                "feasible_tenants": int(sat.all(1).sum()),
                "satisfied_ticks": int(sat.sum()),
                "cost_integral": out.metrics.total_cost_integral,
                "total_churn": out.metrics.total_churn,
                "solver_iters": out.metrics.solver_iters_percentiles,
                "summary": out.metrics.summary().splitlines()}, sat

    t0 = time.perf_counter()
    k_out, *k_rest = run("kernel")
    k_sum, k_sat = summary(k_out, *k_rest)
    main_launches = k_rest[2]
    for name in ("alloc_objective_fleet", "alloc_objective_fleet_value"):
        if main_launches[name] == 0:
            raise AssertionError(f"the replay never launched {name}")
    p_out, *p_rest = run("ref")
    p_sum, p_sat = summary(p_out, *p_rest)
    if any(p_rest[2].values()):
        raise AssertionError(f"the plain replay launched kernels: {p_rest[2]}")
    # the CA baseline once more through its sequential per-tenant oracle,
    # the path of replay_fleet(ca_engine="sequential")
    s0 = time.perf_counter()
    ca_seq = [replay_mod._ca_baseline(catalog, spec, "random", "wave")
              for spec in tenants]
    k_sum["ca_sequential_s"] = time.perf_counter() - s0
    k_sum["ca_engines_equal"] = all(
        r.ca_metrics == m and np.array_equal(r.ca_counts, c)
        for r, (m, c) in zip(k_out.tenants, ca_seq))
    if not k_sum["ca_engines_equal"]:
        raise AssertionError("the vectorized CA baseline disagrees with its "
                             "sequential oracle")
    k_cost = np.asarray([r.metrics.cost_integral for r in k_out.tenants])
    p_cost = np.asarray([r.metrics.cost_integral for r in p_out.tenants])
    rel = np.abs(k_cost - p_cost) / np.maximum(np.abs(p_cost), 1e-12)
    agg = abs(k_cost.sum() - p_cost.sum()) / p_cost.sum()
    emit({"phase": "replay", "seconds": time.perf_counter() - t0,
          "B": args.tenants, "n": catalog.n, "bucket": [n_pad, m_pad, p_pad],
          "n_starts": n_starts, "kernel": k_sum, "plain": p_sum,
          "max_tenant_rel_diff": float(rel.max()), "fleet_rel_diff": agg,
          "satisfied_flags_equal": bool(np.array_equal(k_sat, p_sat))})
    if not (rel.max() <= TENANT_RTOL and agg <= FLEET_RTOL
            and np.array_equal(k_sat, p_sat)):
        raise AssertionError("kernel replay disagrees with the plain replay")
    t0 = time.perf_counter()
    kernel_replay = lambda: replay_fleet(catalog, tenants,
                                         replay_mode="batched",
                                         run_ca_baseline=False)
    scores = scored_replay(ops, ref, kernel_replay)
    exact = float64_replay(ops, ref, kernel_replay)

    def against(out, other):
        cost = np.asarray([r.metrics.cost_integral for r in out.tenants])
        ref_cost = np.asarray([r.metrics.cost_integral for r in other.tenants])
        return {"max_tenant_rel_diff": float(
                    (np.abs(cost - ref_cost) / np.abs(ref_cost)).max()),
                "tenants_with_other_counts": [
                    b for b, (x, y) in enumerate(zip(out.tenants,
                                                     other.tenants))
                    if not all(np.array_equal(s.counts, t.counts)
                               for s, t in zip(x.steps, y.steps))]}

    k_vs_exact = against(k_out, exact)
    emit({"phase": "replay_scored", "seconds": time.perf_counter() - t0,
          "max_over_tol": scores,
          "float64_replay_vs_plain": against(exact, p_out),
          "kernel_replay_vs_float64": k_vs_exact})
    for v in "fg":
        if scores[f"kernel_{v}_vs_float64"] > max(
                1.0, scores[f"plain_{v}_vs_float64"]):
            raise AssertionError(f"the kernel's {v} is farther from float64 "
                                 "than the plain version's")
    if k_vs_exact["tenants_with_other_counts"]:
        raise AssertionError("the kernel replay commits other counts than "
                             "the float64 replay")

    # ---- profile one warm tick -------------------------------------------
    t0 = time.perf_counter()
    X_cur = torch.as_tensor(np.stack(
        [np.pad(r.steps[0].counts, (0, n_pad - catalog.n))
         for r in k_out.tenants]), dtype=torch.float32, device=dev)
    batch1 = stack_problems(
        [c.make_problem(np.asarray(s.trace[1])) for c, s in zip(ctls, tenants)],
        n_max=n_pad, m_max=m_pad, p_max=p_pad, device=dev)
    delta = torch.as_tensor([s.delta_max for s in tenants], device=dev)
    step = replay_mod.solve_fleet_step
    step(batch1, X_cur, delta, steps=PROFILE_STEPS)    # warm-up
    torch.cuda.synchronize()
    res = []
    prof = profile_once(lambda: res.append(step(batch1, X_cur, delta,
                                                steps=PROFILE_STEPS)),
                        top_n=8, match="alloc_objective")
    emit({"phase": "profile", "seconds": time.perf_counter() - t0,
          "what": f"one warm solve_fleet_step, {PROFILE_STEPS} iterations",
          "iters_max": int(res[0].iters.max()), **prof})

    # ---- scenarios: the paper's one-shot optimizer against the CA --------
    t0 = time.perf_counter()
    scen = scenario_checks(dev, ops)
    emit({"phase": "scenarios", "seconds": time.perf_counter() - t0, **scen})

    # ---- bnb: branch-and-bound through optimize(use_bnb=True) -----------
    t0 = time.perf_counter()
    bnb = bnb_checks(dev, ops, scen)
    emit({"phase": "bnb", "seconds": time.perf_counter() - t0, **bnb})

    # ---- sequential: the control loop, one solve per tenant per tick -----
    t0 = time.perf_counter()
    seq = sequential_checks(catalog, tenants[:SEQUENTIAL_TENANTS], ops,
                            replay_mod)
    emit({"phase": "sequential", "seconds": time.perf_counter() - t0, **seq})

    # ---- scenario_terms: priced fleets and the Pareto grid ---------------
    t0 = time.perf_counter()
    scen_terms, term_probes = scenario_terms_checks(dev, ops)
    emit({"phase": "scenario_terms", "seconds": time.perf_counter() - t0,
          **scen_terms})

    # ---- bucketing: shape-bucketed solving of a skewed fleet -------------
    t0 = time.perf_counter()
    buck, buck_probes = bucketing_checks(dev, ops, args.seed)
    emit({"phase": "bucketing", "seconds": time.perf_counter() - t0, **buck})
    # the kernel at these two phases' shapes against its plain version,
    # timed; launches from the run that gave the shape
    t0 = time.perf_counter()
    new_shapes = []
    for label, prob, name, T in term_probes + buck_probes:
        B, n = prob.c.shape
        key = f"{name}@B={B},T={T},n={n}"
        if label == "spot":
            shapes_seen = scen_terms["replays"]["spot"]["kernel"][
                "launches_by_shape"]
        elif label == "grid":
            shapes_seen = scen_terms["grid"]["kernel"]["launches_by_shape"]
        else:
            shapes_seen = buck["runs"]["bucketed_kernel"]["launches_by_shape"]
        rec = fleet_case(name, T, prob, timed=True)
        new_shapes.append((label, key, rec, shapes_seen.get(key, 0)))
    emit({"phase": "slice_shapes", "seconds": time.perf_counter() - t0,
          "checks": [{"label": lb, "key": k, **r, "launches": c}
                     for lb, k, r, c in new_shapes]})

    # ---- mpc: the receding-horizon controller ---------------------------
    t0 = time.perf_counter()
    mpc, mpc_probes, mpc_observed = mpc_checks(dev, ops)
    emit({"phase": "mpc", "seconds": time.perf_counter() - t0, **mpc})
    t0 = time.perf_counter()
    obs_export = obs_export_checks(**mpc_observed)
    emit({"phase": "obs_export", "seconds": time.perf_counter() - t0,
          **obs_export})
    # the kernel at the window's B·H stack and the ADMM planned prox's
    # B·(H-1) stack, timed; launches from the run that gave the shape
    t0 = time.perf_counter()
    for label, prob, name, T in mpc_probes:
        B, n = prob.c.shape
        key = f"{name}@B={B},T={T},n={n}"
        shapes_seen = (mpc["replay"]["kernel"] if label == "window"
                       else mpc["admm"]["kernel"])["launches_by_shape"]
        rec = fleet_case(name, T, prob, timed=True)
        new_shapes.append((label, key, rec, shapes_seen.get(key, 0)))
    emit({"phase": "mpc_shapes", "seconds": time.perf_counter() - t0,
          "checks": [{"label": lb, "key": k, **r, "launches": c}
                     for lb, k, r, c in new_shapes[-len(mpc_probes):]]})

    # ---- serve_alloc: the online allocation service ----------------------
    t0 = time.perf_counter()
    serve_alloc = serve_alloc_checks(dev, ops, args.seed)
    emit({"phase": "serve_alloc", "seconds": time.perf_counter() - t0,
          **serve_alloc})

    # ---- attention kernels ---------------------------------------------
    t0 = time.perf_counter()
    attn_checks, attn_measured = attention_checks(args.seed, dev)
    emit({"phase": "attention", "seconds": time.perf_counter() - t0,
          "tol": ATTN_TOL, "checks": attn_checks})
    torch.cuda.empty_cache()

    # ---- serve: the second main path -------------------------------------
    t0 = time.perf_counter()
    serve_rec, qwen_prefill, qwen_decode = serve(args.seed, dev, SERVE_ARCH,
                                                 "serve")
    serve_rec["seconds"] = time.perf_counter() - t0
    emit(serve_rec)
    torch.cuda.empty_cache()   # qwen1.5-4b's weights are gone with serve()

    # ---- the WKV scan kernel -----------------------------------------------
    t0 = time.perf_counter()
    rwkv_rec, rwkv_measured = rwkv_checks(args.seed, dev)
    emit({"phase": "rwkv", "seconds": time.perf_counter() - t0,
          "tol": RWKV_TOL, "library": None,
          "library_note": "PyTorch has no one call that computes WKV",
          "checks": rwkv_rec})
    torch.cuda.empty_cache()

    # ---- serve_rwkv: the third main path ---------------------------------
    t0 = time.perf_counter()
    rwkv_serve_rec, rwkv_prefill, rwkv_decode = serve(args.seed, dev,
                                                      RWKV_ARCH, "serve_rwkv")
    rwkv_serve_rec["seconds"] = time.perf_counter() - t0
    emit(rwkv_serve_rec)
    torch.cuda.empty_cache()

    # ---- serve_moe: the fourth main path --------------------------------
    t0 = time.perf_counter()
    moe_serve_rec, moe_prefill, moe_decode = serve(
        args.seed, dev, MOE_ARCH, "serve_moe", n_layers=MOE_LAYERS)
    moe_serve_rec["seconds"] = time.perf_counter() - t0
    emit(moe_serve_rec)
    torch.cuda.empty_cache()

    # ---- mamba: one block at jamba-1.5-large's width ---------------------
    t0 = time.perf_counter()
    mamba_rec = mamba_checks(args.seed, dev)
    emit({"phase": "mamba", "seconds": time.perf_counter() - t0,
          **mamba_rec})
    torch.cuda.empty_cache()

    # ---- families: every registered config at reduced() size -------------
    t0 = time.perf_counter()
    families = families_checks(args.seed, dev)
    emit({"phase": "families", "seconds": time.perf_counter() - t0,
          **families})

    # ---- train: the training path at full width and depth ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_rec = train_checks(args.seed, dev, (ops, fops, dops, sops))
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          **train_rec})

    # ---- distributed: the substrate in a world of one over NCCL ---------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_rec, dist_rows = distributed_checks(args.seed, dev, ops, ref)
    emit({"phase": "distributed", "seconds": time.perf_counter() - t0,
          **dist_rec})
    new_shapes.extend(dist_rows)

    # ---- the closing lines ---------------------------------------------
    kernels = []
    for name in ("alloc_objective_fleet", "alloc_objective_fleet_value",
                 "alloc_objective"):
        rec = measured[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/alloc_objective/csrc/"
                      "alloc_objective.cu",
            "replaces": REPLACES[name],
            "launches": (scen["launches"][name] if name == "alloc_objective"
                         else main_launches[name]),
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    # this slice's shapes, with their launches in the s4 kernel run of the
    # bnb phase (a node's S = 12 and 1) or in the sequential run
    bnb_shapes = next(r for r in bnb["runs"] if r["scenario"] == "s4_memory"
                      and r["engine"] == "kernel")["launches_by_shape"]
    seq_shapes = next(r for r in seq["runs"]
                      if r["engine"] == "sequential")["launches_by_shape"]
    for key, rec in slice_measured.items():
        name = key.split("@")[0]
        on_bnb = key in ("alloc_objective@B=1,T=12", "alloc_objective@B=1,T=1")
        launches = (bnb_shapes if on_bnb else seq_shapes).get(key, 0)
        if launches == 0:
            raise AssertionError(f"{key} was never launched on its path")
        kernels.append({
            "name": f"{name} ({key.split('@')[1]}, "
                    f"{'bnb' if on_bnb else 'sequential'})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/alloc_objective/csrc/"
                      "alloc_objective.cu",
            "replaces": REPLACES[name],
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    # the serving engine's warm-tick shapes, with their launches in the
    # serve_alloc phase's kernel session without a deadline
    serve_shapes = serve_alloc["kernel"]["launches_by_shape"]
    for key, rec in serve_measured.items():
        name = key.split("@")[0]
        if not serve_shapes.get(key):
            raise AssertionError(f"{key} was never launched on its path")
        kernels.append({
            "name": f"{name} ({key.split('@')[1]}, serve)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/alloc_objective/csrc/"
                      "alloc_objective.cu",
            "replaces": REPLACES[name],
            "launches": serve_shapes[key],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    # the spot fleet (n = 4096), the Pareto grid, the buckets, the MPC
    # window and the ADMM planned prox, with their launches in the run
    # that gave them
    for label, key, rec, launches in new_shapes:
        name = key.split("@")[0]
        if launches == 0:
            raise AssertionError(f"{key} was never launched on its path")
        kernels.append({
            "name": f"{name} ({key.split('@')[1]}, {label})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/alloc_objective/csrc/"
                      "alloc_objective.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    root = Path(__file__).resolve().parent
    # (name, the record of its timed shape, its kernel, its launches on the
    # main path)
    model_kernels = [
        ("flash_attention", attn_measured["flash_attention"],
         "flash_attention", qwen_prefill["flash_attention"]),
        ("decode_attention", attn_measured["decode_attention"],
         "decode_attention", qwen_decode["decode_attention"]),
        ("rwkv6_scan", rwkv_measured["rwkv6_scan"], "rwkv6_scan",
         rwkv_prefill["rwkv6_scan"]),
        ("rwkv6_scan_decode", rwkv_measured["rwkv6_scan_decode"],
         "rwkv6_scan", rwkv_decode["rwkv6_scan"])]
    # mixtral-8x22b's shapes, with their launches in the serve_moe run
    by_case = {(c["name"], c["case"]): c for c in attn_checks}
    model_kernels += [
        ("flash_attention (B=8,S=1024,H=48,G=8,window=4096, serve_moe)",
         by_case["flash_attention", "mixtral-prefill"], "flash_attention",
         moe_prefill["flash_attention"]),
        ("decode_attention (B=8,S_max=1056,H=48,G=8, serve_moe)",
         by_case["decode_attention", "gqa-48/8"], "decode_attention",
         moe_decode["decode_attention"])]
    for name, rec, kernel, launches in model_kernels:
        if launches == 0:
            raise AssertionError(f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(sources[kernel].relative_to(root)),
            "replaces": REPLACES[name.split(" ")[0]], "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
