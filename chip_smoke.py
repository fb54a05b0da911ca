"""Drive the PyTorch port's MCCM and LM serving paths on one NVIDIA card,
every LM family included, its training path, its meshes and its
dry-run, and check them.

    python3 chip_smoke.py [--seed N] [--designs N]

Phases, each printing one JSON line:

1. card and build: the card, torch/CUDA versions, both TF32 flags (set
   False here: no matmul or convolution may run in TF32), and the ``nvcc``
   builds of the five kernel sources (``flash_fwd`` has a bf16 and an f32
   source), started together, with their ptxas reports;
2. the search kernel against its plain PyTorch version on the card, on the
   baseline templates of every CNN x board, on 4096 ``sample_mixed`` rows
   of every CNN (ZCU102's pruned pair list), on 4096 ResNet-152 rows on a
   board beyond the pruning ladder (all 324 pairs) and on an
   all-infeasible batch: ⟨pf, ph, pw⟩ and the cost equal bit for bit, inf
   where the plain version has inf;
3. the main path, ``Session(board).evaluate(specs, net)``, against the
   golden metrics the JAX package computed on the CPU
   (``src/repro_torch/data/golden_mccm.npz``): ``n_ces`` exact, the other
   metrics within rtol 1e-5;
4. realistic load: ResNet-50 on ZCU102 (paper Tab. I), a DesignBatch of
   ``--designs`` (default 100,000, the DSE budget) ``sample_mixed`` designs
   from ``--seed``: end-to-end µs per design, the kernel's and the plain
   version's ms per chunk, the kernel's bound at the card's f32 rate and
   at the no-FMA rate of its contract (the operations the function needs
   on this chunk's data), the bound of PRs 11-16's count (``bound_5op_ms``),
   its launch plan, ptxas registers and spills, launches, peak memory and
   a profiler breakdown of the first 20,480 designs (written to
   ``chiprun_out/``);
5. the scalar path, ``Session(board).evaluate(spec, net)`` on every
   template of every CNN x board, against the golden scalar metrics the JAX
   package's Builder computed (exactly equal: both are the same Python
   arithmetic), and the batch path on the card against it within the JAX
   package's own scalar-vs-batch tolerances;
6. the Eq. 1 latency kernel at full width: the ⟨pf, ph, pw⟩ of each layer
   of the ``--designs`` designs of phase 4, as the batch path chooses them,
   through ``mccm_latency``: equal to its plain version and to the batch
   path's own cycles bit for bit, and to the scalar Builder's on the
   templates; launches, peak memory; and at three shapes (all designs at
   160 padded layers, the first 2048 of them, all at the 53 valid layers
   unpadded), each equal to its plain version bit for bit: ms, plain ms,
   bound and the launch plan the library reports (held to
   ``ops.latency_plan``);
7. the CE convolution kernel at full width: the 53 conv layers of
   ResNet-50 at their published widths (batch 1, unit-normal data from
   ``--seed``), each on its CE's ⟨pf, ph, pw⟩ in the port's Builder for
   every baseline arch with 11 CEs on ZCU102: the grid identity of Eq. 1
   exactly, for the grid the library reports it launched, the kernel
   equal to its plain version bit for bit and near ``conv2d``; ms per
   ResNet-50 pass beside ``conv2d``'s, the bound at the card's f32 rate,
   the bound at the contract's no-FMA rate and each design's grid floor;
   the slowest layers with their launch plans;
8. the flash-attention kernels at Llama-3.2-1B's attention shape (B 4, S
   4096, 32 query heads, 8 KV heads, head dim 64, causal) in bf16 (tensor
   cores) and f32 (FMA), plus a ragged (S 4000), a sliding-window and a
   head-dim-128 case in each dtype: the kernel against its plain version
   on the card within the stated tolerance, no input copied; ms, plain ms,
   ``scaled_dot_product_attention``'s ms (timed only), the bound, each
   kernel's launch plan (the f32 one equal to its Python mirror,
   ``flash_attn.ops.f32_plan``) and each instantiation's registers and
   spills;
9. the LM serving path at full width: Llama-3.2-1B in bf16 with random
   weights from ``--seed``, ``ServeEngine.generate`` on 4 prompts of
   2300-4000 tokens (so prefill's attention is the chunked path) and 16
   greedy tokens: ``flash_fwd`` launched once per layer in prefill and
   never in decode, no input copied, finite logits and in-vocab tokens,
   and the kernel
   against its plain version on layer 0's real q, k and v; prefill s,
   decode tokens/s, peak memory;
10. the reduced Llama config in f32 against the golden file the JAX
   package wrote (``src/repro_torch/data/golden_lm.npz``): greedy tokens
   equal, prefill's last logits within the stated tolerance, on a batch
   longer than 2048 tokens (chunked, the kernel) and a short one (dense);
11. the DSE path, ``Session(get_board()).explore`` on MobileNetV2: at the
   configurations of ``src/repro_torch/data/golden_dse.npz`` (the JAX
   package's explore on the CPU), the random sweep's designs and the
   search's first generation equal the golden draws exactly, each front
   equals the golden front (a row on one front only must be a near-tie
   within rtol 1e-5, reported in ``front_near_ties``), the front rows'
   metrics meet it (``n_ces`` exact, the rest within rtol 1e-5), and the
   first generation whose designs part from the golden run is reported
   (``search_diverged_at``); then a 100,000-design random sweep (seed 7)
   and search (seed 3), the paper's budget: the search strictly dominates
   the sweep's best-latency design on (latency, buffer), each front is
   ``pareto()`` of its sample and mutually non-dominated, 16 search front
   rows meet the scalar Builder; seconds and µs a design, per generation
   the host's breeding and the device step's seconds, search-kernel
   launches per explore, one step's kernel launches, busy time and idle
   share under the profiler, the repair's ms and launches at 4096
   designs, peak memory;
12. the serving lane, ``Session.submit`` and ``submit_search``: (a) one
   drain of ResNet-50/ZCU102 template probes and sweeps of 5,000 and 300
   specs, MobileNetV2/ZC706 probes and a 3,000-spec sweep and a notation
   string, every future equal to ``evaluate`` on the same specs bit for
   bit, the plan (chunks, merges, splits, shared pad) equal to the
   session's counters and one search launch a chunk; (b) 8 client threads
   submitting ~100,000 designs (interactive probes of 1-16 designs among
   batch-lane sweeps of 2,048-10,000), each result equal to ``evaluate``:
   wall, µs a design beside phase 4's, requests/s, p50/p99 latency by
   lane, the ``coalesced_*`` counters, padded over asked rows, launches a
   megabatch, and one drain under the profiler (kernels, busy time, idle
   share); (c) a 100,000-design random sweep by ``submit_search`` while a
   probe arrives every 5 ms: probe p50/p99 with and without the job, every
   probe's result and the job's designs equal to ``evaluate``'s and
   ``explore``'s; (d) a deadline of 1 ms, a queue
   of one, ``with`` and ``close``, and a fault injected into the search
   kernel in the drain: the right code on every future, the plain search
   never run, ``degraded`` 0; (e) ``benchmarks/serve_load.py``'s trace
   (64 requests over 4 CNNs x 4 boards on its arrival times, its session
   settings) through ``submit``, each result equal to ``evaluate``: p50/p99
   latency overall and by lane, designs/s, the counters; then its 100k
   random ``submit_search`` with one deadline-bearing probe beside it;
13. the schedule layer (``Session.schedule``, ``schedule_specs``,
   ``explore(refine="schedule")``): (a) the golden designs of
   ``src/repro_torch/data/golden_schedule.npz`` (the JAX package's
   ``schedule_specs`` on the CPU: the 12 templates of every CNN on ZC706
   and of ResNet-50 on every board) through ``schedule_specs`` and
   ``Session.schedule`` on the card, the discrete and per-layer fields
   equal, the composed metrics within rtol 1e-5, each CNN's golden
   artifact met, refined <= coarse, refined equal to coarse on rows that
   keep candidate 0 everywhere; (b) the card's plane on 2,048 of phase 4's
   designs equal bit for bit to the CPU's from the same layer state,
   all-tie layers choosing candidate 0; (c) 64 single designs across the
   CNNs on ZCU102, cold and warm p50/p99 ms, one cold call under the
   profiler; (d) phase 11's 100k random sweep refined: designs, front and
   metrics equal to the unrefined run's bit for bit, the refine's seconds;
   (e) ``schedule_specs`` on the first 20,480 of phase 4's designs (depth
   cut from 100,000): µs a design beside phase 4's, one search launch a
   chunk, peak memory, one chunk under the profiler; (f) a scorer fault on
   the card: ``BACKEND_FAULT`` after the retries, the CPU route never run;
14. multinet co-scheduling (``Session.deploy``, ``joint_evaluate``): (a)
   ``src/repro_torch/data/golden_multinet.npz`` (the JAX package on the
   CPU): ``joint_evaluate`` on its 256 seeded deployments in each mode
   (spatial and temporal on ResNet-50 + MobileNetV2 / ZC706, hybrid on the
   pair + DenseNet-121 under SLOs and a 1:2:1 request mix) and one
   ``Session.deploy`` per arm (budget 768, pop 256): designs, shares,
   splits, assignment, ``per_model_n_ces`` and fronts equal, the rest
   within rtol 1e-5, ``multinet_diverged_at`` null; (b) on the card, bit
   for bit: M = 1 spatial against ``evaluate_batch`` on every CNN (3 archs
   x {2, 9} CEs, VCU108), hybrid all-spatial against spatial, hybrid
   all-shared against temporal; (c) ``benchmarks/multinet_fronts.py``'s
   two studies and ``benchmarks/multinet_hybrid.py``'s through
   ``Session.deploy`` at their full budget (6,144, pop 512): per arm
   seconds, µs a deployment, search launches, front size, hypervolume, the
   pair's searched front dominating its equal-split front, the benchmarks'
   other checks reported; (d) ``benchmarks/perf_gate.py``'s points (M = 2
   spatial, M = 3 hybrid over three assignments, B 1,024): µs a deployment
   and a model evaluation, one call under the profiler; (e) a fault in the
   search kernel under ``deploy``: ``BACKEND_FAULT``, the plain search
   never run, ``degraded`` 0; ``submit_search`` on a list of nets equal to
   ``deploy``;
15. the socket server (``EvalServer``/``ServeClient``) and the serial
   island model (``SearchConfig(n_islands=k)``): (a) every op over
   loopback on a MobileNetV2/ZC706 card session (ping, observability,
   a scalar and lists of 2 and 3,000 specs, explores of 4,096 random and
   search, a ResNet-50 + MobileNetV2 deploy at 512), each reply equal to
   the same local call bit for bit and its search launches to the local
   call's; the largest reply's bytes and the seconds each writing thread
   spends encoding and sending; (b) phase 12 (e)'s trace sent on its
   arrival times over one pipelined connection with its session
   settings, each reply equal to ``evaluate``: p50/p99 overall and by
   lane and designs/s beside phase 12 (e)'s in-process figures, then its
   100k random explore over the wire with a deadline-bearing probe; (c)
   a malformed line and an unknown op, net and board (``INVALID_INPUT``,
   the connection still usable), a 1 ms deadline, a queue of one, the
   client-side timeout, a fault injected into the search kernel in the
   drain (``BACKEND_FAULT`` on the wire, the plain search never run,
   ``degraded`` 0) and a drained shutdown that delivers every reply;
   (d) ``src/repro_torch/data/golden_islands.npz`` (the JAX package's
   island search on the CPU at two configurations): every design, the
   fronts, island fronts, migrants and archive sizes exact, points and
   metrics within rtol 1e-5, ``islands_diverged_at`` null, one search
   launch a step; (e) 4 islands at the 100,000-design budget through
   ``Session.explore`` beside phase 11's serial search: the budget
   exact, four non-empty island fronts under the merged front, migrants,
   a rerun bit-identical; seconds, µs a design, per-generation breeding
   and step seconds, launches, peak memory; then configuration B killed
   after its second snapshot and resumed, bit for bit;
16. the LM families past dense: (a) at full width in bf16, random
   weights from ``--seed``, Granite-3.0-1B-A400M (MoE), Mamba2-370M,
   Zamba2-1.2B (hybrid) and InternVL2-2B (256 stub patches of width 1024
   ahead of the text) on phase 9's prompts, and Whisper-base on 4096 stub
   frames of width 512 with decoder prompts of 8-512 tokens, 16 greedy
   tokens each through ``ServeEngine.generate``: prefill s, decode
   tokens/s, peak memory, ``flash_fwd`` launches of ``generate``, of one
   prefill and of one decode step equal to ``flash_launches``, 0 input
   copies, finite logits and in-vocab tokens, a profiler's top kernels
   over one prefill and one decode step, and the kernel against its plain
   version on the family's real q, k and v (a prefill's first chunked
   call; Whisper's encoder layer 0, its cross-attention at Sq 512 and at
   Sq 1 over 4096 keys, non-causal), with the Sq 1 call's ms beside its
   plain version's, ``scaled_dot_product_attention``'s (timed only) and
   the bound; (b) ``src/repro_torch/data/golden_lm_families.npz`` (the
   JAX package on the CPU: the reduced MoE with drops, MoE with a shared
   expert, Mamba2, Zamba2, Whisper with 2100 frames and InternVL2, in
   f32): greedy tokens equal, prefill's last logits within the stated
   tolerance, launches as ``flash_launches`` counts;
17. training: (a) Llama-3.2-1B at full width in bf16, random weights
   from ``--seed``, through the launcher's pieces (``default_plan`` of
   ``train_4k``: per-layer remat, the loss in chunks of 512; its AdamW;
   ``init_state``, ``make_train_step``, the ``Pipeline``) on
   ``synth_batch`` at B 4 x S 4096 (``train_4k``'s length, its global
   batch of 256 cut to 4): one warm-up step and 3 timed ones (host clock
   ending in a synchronize), each step's loss and grad norm finite,
   ``flash_fwd`` launched twice a layer a step (the forward and remat's
   recompute) with 0 input copies, tokens/s, peak memory, one
   ``accum=2`` step at B 8, and one step under the profiler (busy share,
   top kernels, the flash backward's and the vocab-long GEMMs' shares);
   (b) ``src/repro_torch/data/golden_train.npz`` (the JAX package's
   losses and gradients of the reduced families in f32, on the CPU): each
   loss within 1e-5, each gradient leaf within 5e-5 of its scale,
   ``flash_fwd`` launches as ``train_flash_launches`` counts (Llama,
   Zamba2, Whisper and InternVL2 take the chunked path: the f32 kernel
   forward and the Function's backward); (c) the flash-attention
   Function at Llama's attention shape (B 1, S 4096, 32/8 heads of 64,
   causal) in f32 and bf16, its gradients against autograd through the
   plain dense attention in f32, its forward+backward ms beside the dense
   reference's and ``scaled_dot_product_attention``'s (timed only; the
   port never calls it).
18. the step model (``repro_torch.gpu``, ``repro_torch.roofline``): (a)
   ``H100``'s SMs, shared memory a block and HBM capacity equal what the
   card reports; (b) Llama-3.2-1B in bf16, random weights from ``--seed``,
   at B 4: a ``train_4k`` step at S 4096 (phase 17 (a)'s plan), a prefill
   of 4 prompts of 4096 and one decode step over a cache of 4096, each
   timed, then walked once by ``OpWalk`` (FLOPs by dtype, bytes,
   transcendentals, the census, the hand kernels' charges: 32 a train
   step and 16 a prefill, each equal to ``flash_fwd``'s launches in the
   walk), beside ``estimate`` of the cut cell, Eq. 10's accuracy of its
   FLOPs and bytes, the bound of the walk's FLOPs at each dtype's rate,
   peak memory and the record's roofline (written to
   ``chiprun_out/roofline/``); (c) the walk of a reduced Llama train step
   in f32 (chunked attention, remat) equal on the CPU and the card:
   FLOPs, bytes, transcendentals, census, charges; (d) the 15 one-device
   plans of the train cell ranked, and one timed step of the first- and
   the last-ranked plan that fit: the model's order against the card's
   (a finding); the phase within 60 s;
19. the design-axis mesh (``repro_torch.core.shard.EvalMesh``): (a) phase
   4's 100,000 ResNet-50/ZCU102 designs through ``Session(EvalConfig(
   mesh=4))`` (on one card the mesh clamps to 1: ``requested`` and
   ``ndevices`` reported) and through the same session with a mesh of
   four shards of the card, every metric equal to phase 4's arrays bit
   for bit; rows padded for each route, µs a design of both (median of
   3), search launches per shard; (b) phase 15 (e)'s 4-island
   MobileNetV2 search at 100,000 designs with one island a shard, run
   serial, sharded, sharded, serial: every design, metric, front and
   island front of each run equal to the first serial run's bit for bit;
   seconds, µs a design and a generation's median step seconds of each
   run, launches per shard; (c) ``joint_evaluate`` on phase 14 (a)'s
   deployments in each mode over the four shards, every field equal to
   the unsharded call bit for bit; (d) with more than one card visible,
   (a)-(c) again over ``min(4, count)`` cards, one shard a card, with
   launches per card; on one card that is reported.
20. the LM mesh (``repro_torch.launch.{mesh,plans,steps}``, DTensor
   placements, the ``local_map`` regions): (a) Llama-3.2-1B at full width
   in bf16, random weights from ``--seed``, through ``build_step`` on a
   1 x 1 mesh over NCCL (world 1) beside the single-device route of
   phases 17-18 on the same seed: a prefill of 4 x 4096 (``prefill_32k``
   cut), one decode step over a cache of 4097 (``decode_32k`` cut) and a
   ``train_4k`` step at B 4 (phase 17's cut): prefill's logits, the
   decode step's logits and tokens and the step's loss bit-equal, its
   parameters bit-equal or within 2e-6 relative (the line names the op
   where not), ``flash_fwd``'s launches equal, rank 0's layer-0 q, k and
   v through the kernel and its plain version; seconds, peak memory and
   collectives (count and bytes by kind) of each; (b) four ranks on the
   card over gloo on CUDA tensors: ``tests/torch_mesh_check.py``'s
   golden cases on a 2 x 2 mesh (the reduced f32 Llama and Granite:
   losses and gradients under each plan, a train step, prefill and
   greedy decode, the compressed step (its first loss; the rest of the
   CPU tests' 12-step trajectory reported), ``moe_ep`` and
   ``moe_ep_a2a`` with drops, the reshard onto 4 x 1) and its 1 x 4
   cases (heads that do not divide the model axis) against
   ``golden_mesh.npz`` with the CPU tests' tolerances, and the full-width
   prefill (one ``flash_fwd`` launch a layer on every rank) and decode
   step on 2 x 2: seconds, launches, collectives and peak memory a rank,
   the logits' distance from (a)'s; the same at full width in bf16 for
   Mamba2, Zamba2, Whisper and InternVL2 on phase 16's requests, each
   beside its single-device prefill and decode step run in (a) in bf16
   and in f32 (the reference): every rank's ``flash_fwd`` launches equal
   to the single device's (one a layer, a shared-block call, an encoder
   layer or a cross-attention, on the rank's heads), the last logits no
   further from the reference's than twice the single device's bf16
   route (or 2^-5 of the reference's scale) and the greedy tokens equal
   where its top two are not closer than twice that distance, seconds
   and peak memory a rank; then
   ``tests/torch_mesh_families_check.py``'s
   cases (the reduced f32 Mamba2, Zamba2, Whisper and InternVL2 on 2 x 2
   and 1 x 4: a loss and its gradients, prefill and greedy decode, and
   the 1 x 4 Zamba2 on a long cell's sequence-sharded cache) against
   ``golden_mesh_families.npz`` with the CPU tests' tolerances, their
   ``flash_fwd`` launches (the f32 kernel) counted a rank; (c) one rank a
   card over NCCL where four cards are visible; on one card that is
   reported.
21. the dry-run (``repro_torch.launch.dryrun``): (a) every assigned cell
   (``configs.cells``: 10 archs x 4 shapes, ``long_500k`` skipped where
   the JAX package skips it) on ``single`` (16 x 16, 256 ranks) and
   ``multi`` (2 x 16 x 16, 512 ranks), Kimi-K2 among them, each walked at
   full width as rank 0 of a fake world on ``meta`` tensors with the
   mesh's device type ``cuda``: one subprocess an arch and mesh, seven at
   once; a line a cell (``walk_s``, FLOPs a device, counted peak GiB,
   wire GiB, the roofline's dominant term); records under
   ``chiprun_out/dryrun/`` and each job's output under
   ``chiprun_out/dryrun_logs/``; (b) Eq. 10's accuracy of
   ``gpu.cost_model.estimate`` against each record's walk, term by term,
   as ``benchmarks/tpu_model_accuracy.py`` computes it; (c) one cell's
   record on ``cuda`` equal to its record on ``cpu``; (d) Llama-3.2-1B's
   train step at phase 18's cut on a 1 x 1 fake world: its walk equal to
   phase 18's walk of the real step (FLOPs, bytes, transcendentals,
   charges), its counted peak beside phases 17 and 18's
   ``max_memory_allocated``.  Any cell not ``ok`` fails the phase.

Then the ``kernels`` line (one entry per kernel source: the search's
launches those of phase 4's main path and of phase 19's sharded runs,
``flash_fwd``'s
bf16 source with its launches in phase 9, phase 20 (a) and phase 20
(b)'s full-width families on four ranks, and its largest
error over phases 8, 9, 16 and 20, its f32 source with its launches
in phase 10's long batch and phase 20 (b)'s families' cases), the card's
name and power limit as
``nvidia-smi`` gives them, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
the last line.  Without a visible card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: the card's figures: H100 SXM peaks (NVIDIA data sheet, at the 700 W
#: limit), its SMs, shared memory and HBM (read on the card, phase 18 (a))
from repro_torch.gpu.chip import H100  # noqa: E402

#: one SM's FP32 lanes at the 1.98 GHz boost clock
SM_F32_ISSUES_PER_S = 128 * 1.98e9
#: f32 operations a second where a multiply and an add are issued apart,
#: one operation an issue: half the FMA rate.  conv_ce's own contract (no
#: FMA, to equal its plain version bit for bit) holds it to this rate; its
#: bound_ms is at H100.peak_flops_f32, the card's rate for the function
F32_NO_FMA_OPS_PER_S = H100.sms * SM_F32_ISSUES_PER_S

KERNELS = {
    "parallelism_search": dict(
        name="parallelism_search", route="cuda",
        source="src/repro_torch/kernels/mccm_eval/csrc/parallelism_search.cu",
        replaces="src/repro/kernels/mccm_eval/kernel.py:119"),
    "mccm_latency": dict(
        name="mccm_latency", route="cuda",
        source="src/repro_torch/kernels/mccm_eval/csrc/mccm_latency.cu",
        replaces="src/repro/kernels/mccm_eval/kernel.py:44"),
    "conv_ce": dict(
        name="conv_ce", route="cuda",
        source="src/repro_torch/kernels/conv_ce/csrc/conv_ce.cu",
        replaces="src/repro/kernels/conv_ce/kernel.py:66"),
    "flash_fwd": dict(
        name="flash_fwd", route="cuda",
        source="src/repro_torch/kernels/flash_attn/csrc/flash_fwd_bf16.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:78"),
    "flash_fwd_f32": dict(
        name="flash_fwd_f32", route="cuda",
        source="src/repro_torch/kernels/flash_attn/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attn/kernel.py:78"),
}

#: device cycles of the sleep queued ahead of a timed run (~0.1 s)
SLEEP_CYCLES = 200_000_000

TEMPLATE_NS = (2, 5, 9, 11)
#: phase 2's board beyond the PES_HINTS ladder: no pair is pruned
UNPRUNED_PES = 100_000
RTOL_METRICS = 1e-5
#: batch path (f32) against the scalar Builder (exact), the JAX package's
#: own tolerances (tests/test_batch_eval.py:15): f32 threshold flips move
#: access_bytes
RTOL_SCALAR = {"latency_s": 1e-4, "throughput_ips": 1e-4,
               "buffer_bytes": 1e-4, "access_bytes": 0.04}
#: mccm_latency against the scalar Builder's exact integer cycles: f32
#: rounds a product above 2**24 (three roundings per layer), and the
#: total adds 160 such values
RTOL_LAYER_CYCLES = 1e-6
RTOL_TOTAL_CYCLES = 1e-5
#: conv_ce against conv2d (cuDNN, TF32 off): the two add each output's
#: C*KH*KW terms (up to 4608) in different orders, so they part by a few
#: f32 ulps of the largest partial sums
RTOL_CONV = 1e-4
CONV_ARCH_CES = 11
#: flash_fwd against its plain version on the card: element by element,
#: |got - want| <= rtol·|want| + atol at the dtype's
#: ``repro_torch.kernels.flash_attn.ref.TOLERANCE`` (f32: atol 2e-5; bf16:
#: one bf16 ulp, 2**-7·|want|, plus the same atol)
#: the reduced Llama config in f32 against the JAX package's logits: the
#: two packages sum d_model-long products in different orders; they part
#: by under 1e-6 on the CPU
LM_LOGITS_ATOL = 1e-5
#: phase 8's shapes: Llama-3.2-1B's attention at batch 4 and 4096 tokens,
#: a ragged length, a window that cuts KV tiles, and the widest head dim
FLASH_B, FLASH_S, FLASH_RAGGED_S, FLASH_WINDOW = 4, 4096, 4000, 1000
FLASH_WIDE_D = 128
#: phase 9: 4 prompts of 2300-4000 tokens (the longest 4000), so ``auto``
#: attention resolves to the chunked path; greedy new tokens
SERVE_PROMPTS, SERVE_LENS, SERVE_NEW_TOKENS = 4, (2300, 4000), 16
#: phase 4's profiled evaluate: its first 10 chunks of 2048 designs
PROFILE_DESIGNS = 20_480
#: phase 11: the DSE at the paper's budget on MobileNetV2 and the default
#: board, as the JAX package's acceptance test (tests/test_dse_search.py)
DSE_CNN, DSE_BUDGET, DSE_OBJ = "mobilenetv2", 100_000, ("latency_s",
                                                        "buffer_bytes")
DSE_RANDOM_SEED, DSE_SEARCH_SEED = 7, 3
#: front rows held to the scalar Builder (RTOL_SCALAR)
DSE_SCALAR_ROWS = 16
#: phase 12, the serving lane: (a)'s ResNet-50 sweeps of 5,000 and 300
#: specs and its MobileNetV2 sweep of 3,000; (b)'s 8 clients, each with 32
#: interactive probes of 1-16 designs among batch-lane sweeps of
#: 2,048-10,000 designs, ~100,000 designs in all, drawn from a pool of
#: 10,000 specs a net; (c)'s probe every 5 ms, 200 of them without a job
SUBMIT_SWEEPS = (5000, 300, 3000)
SUBMIT_CLIENTS, SUBMIT_PROBES_PER_CLIENT = 8, 32
SUBMIT_SWEEP_SIZES, SUBMIT_LOAD_DESIGNS = (2048, 10_000), 100_000
SUBMIT_POOL, SUBMIT_SEED = 10_000, 0
SUBMIT_PROBE_EVERY_S, SUBMIT_QUIET_PROBES = 0.005, 200
#: phase 12 (e): the repo's documented serving traffic,
#: benchmarks/serve_load.py (copied here: the script imports nothing of the
#: JAX side): its trace of 64 requests from seed 0 over 4 CNNs x 4 boards,
#: exponential arrivals of mean 0.1 s, 20 % batch-lane requests of 64-96
#: designs and 80 % interactive probes of 1-4; its session (VCU110, linger
#: 2 ms adaptive up to 20 ms); then its 100,000-design random submit_search
#: and one interactive probe with a 60 s deadline beside the job
TRACE_NETS = ("mobilenetv2", "resnet50", "xception", "densenet121")
TRACE_BOARDS = ("zc706", "vcu108", "vcu110", "zcu102")
TRACE_MEAN_ARRIVAL_S, TRACE_BULK_FRACTION = 0.1, 0.2
TRACE_REQUESTS, TRACE_SEED, TRACE_DEADLINE_S = 64, 0, 60.0
TRACE_LINGER_S, TRACE_LINGER_MAX_S = 0.002, 0.02
SUBMIT_COUNTERS = ("submits", "megabatches", "megabatch_requests",
                   "coalesced_chunks", "coalesced_merges",
                   "coalesced_splits", "rejected", "deadline_missed",
                   "degraded")
#: phase 13, the schedule layer: (b) the plane of the first 2,048 of
#: phase 4's designs (one full-width chunk); (c) 64 distinct designs
#: across the 7 CNNs on ZCU102, one ``Session.schedule`` call each; (d)
#: phase 11's 100k random sweep (seed 7), refined; (e) the first 20,480 of
#: phase 4's 100,000 designs (depth cut to keep the run short); (f) the
#: retries before a faulted scorer raises BACKEND_FAULT
SCHED_PLANE_DESIGNS = 2048
SCHED_SINGLE_DESIGNS, SCHED_SINGLE_BOARD = 64, "zcu102"
SCHED_FULL_DESIGNS = 20_480
SCHED_FAULT_RETRIES = 1
#: schedule_specs fields held to the golden file exactly: the discrete
#: ones and the per-layer plane fields; the rest (``ref_*``/``coarse_*``
#: metrics, ``seg_cyc_*``) within RTOL_METRICS
SCHED_EXACT = ("choice", "ce_of_layer", "seg_of_layer", "pipe_l", "valid_l",
               "seg_valid", "pf_l", "ph_l", "pw_l", "ref_n_ces",
               "coarse_n_ces", "phi", "tile_bytes", "companion_bytes",
               "floor_bytes", "budget_bytes", "lat_ref_l", "lat_coarse_l",
               "acc_ref_l", "acc_coarse_l", "n_tiles_l", "buf_l",
               "ce_buf_l", "alloc_seg")
#: an artifact's floats from the composed metrics (RTOL_METRICS), at its
#: top level and in its segments; every other field must be equal
SCHED_TOP_CLOSE = ("latency_s", "coarse_latency_s", "throughput_ips",
                   "access_bytes", "coarse_access_bytes", "energy_j",
                   "coarse_energy_j", "buffer_bytes")
SCHED_SEG_CLOSE = ("coarse_cyc", "refined_cyc")
#: phase 14, multinet: the golden file's discrete outputs held exactly
#: (the rest within RTOL_METRICS); (c) the repo's studies at their full
#: budget (benchmarks/multinet_fronts.py: the ResNet-50 + MobileNetV2 pair
#: on ZC706 and the pair + DenseNet-121 on VCU110, arms search,
#: equal_split, temporal; benchmarks/multinet_hybrid.py: the trio on
#: ZC706 under its SLOs and 1:2:1 request mix, arms search, temporal,
#: hybrid with objective="slo"), the pair's searched front held to dominate
#: its equal-split front; (d) benchmarks/perf_gate.py's two points
MULTINET_EXACT = ("pes_split", "buf_split", "assign", "per_model_n_ces")
MULTINET_PAIR = ("resnet50", "mobilenetv2")
MULTINET_TRIO = ("resnet50", "mobilenetv2", "densenet121")
MULTINET_FULL_BUDGET, MULTINET_FULL_POP = 6144, 512
MULTINET_HYBRID_CFG = dict(objective="slo", slo_s=(0.120, 0.030, 0.130),
                           weights=(1.0, 2.0, 1.0))
MULTINET_STUDIES = (
    ("resnet50+mobilenetv2", MULTINET_PAIR, "zc706",
     ("search", "equal_split", "temporal"), {}),
    ("resnet50+mobilenetv2+densenet121", MULTINET_TRIO, "vcu110",
     ("search", "equal_split", "temporal"), {}),
    ("hybrid:resnet50+mobilenetv2+densenet121", MULTINET_TRIO, "zc706",
     ("search", "temporal", "hybrid"), MULTINET_HYBRID_CFG))
MULTINET_GATED_STUDY = "resnet50+mobilenetv2"
MULTINET_GATE_B, MULTINET_GATE_REPS = 1024, 3
#: phase 15, the socket server: (a) tests/test_serve_server.py's session
#: (MobileNetV2 / ZC706), list evaluates of 2 and 3,000 specs, explores of
#: 4,096 (random and search), a deploy of the ResNet-50 + MobileNetV2 pair
#: at 512; (e) the island model at the paper's budget, 4 islands
WIRE_NET, WIRE_BOARD, WIRE_SPEC = "mobilenetv2", "zc706", "{L1-Last:CE1-CE4}"
WIRE_SWEEPS, WIRE_EXPLORE_N = (2, 3000), 4096
WIRE_DEPLOY, WIRE_DEPLOY_N = ("resnet50", "mobilenetv2"), 512
ISLANDS_FULL = 4
#: phase 16: the families past dense at full width, bf16, random weights
#: from --seed: four on phase 9's prompts (the VLM with its 256 stub
#: patches of width 1024 ahead of them), Whisper on 4096 stub frames of
#: width 512 and decoder prompts of 8-512 tokens; 16 greedy tokens each
FAMILY_SERVE = ("granite-moe-1b-a400m", "mamba2-370m", "zamba2-1.2b",
                "whisper-base", "internvl2-2b")
ENCDEC_SERVE_FRAMES, ENCDEC_SERVE_LENS = 4096, (8, 512)
#: phase 16 (b): the golden file of the reduced families in f32
GOLDEN_LM_FAMILIES = os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_lm_families.npz")
#: phase 17 (a): Llama-3.2-1B trained in bf16 at the JAX package's
#: ``train_4k`` length, its global batch of 256 cut to 4 (and 8 for the
#: ``accum=2`` step); one warm-up step and 3 timed ones; the launcher's
#: optimizer (peak lr 3e-3, 20 warm-up steps of 100) and plan (per-layer
#: remat, the loss in chunks of 512)
TRAIN_ARCH, TRAIN_S, TRAIN_B, TRAIN_ACCUM_B = "llama3.2-1b", 4096, 4, 8
TRAIN_TIMED_STEPS = 3
#: phase 17 (b): the JAX package's training losses and gradients of the
#: reduced families in f32; the loss within 1e-5, each gradient leaf
#: within 5e-5 of its own scale (its largest |value|, no floor) and
#: relatively, as tests/test_torch_train_models.py holds the CPU
GOLDEN_TRAIN = os.path.join(ROOT, "src", "repro_torch", "data",
                            "golden_train.npz")
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 1e-5, 5e-5
#: phase 17 (c): the flash-attention Function at Llama's attention shape
#: (B 1, S 4096, 32 / 8 heads of 64, causal); its gradients held to
#: autograd through the plain dense attention in f32, each within this
#: fraction of the reference's largest |value| (f32: the two sum in other
#: orders; bf16: q·scale, p and ds rounded to bf16 and the inputs' own
#: bf16 rounding of the gradients)
FN_B, FN_S, FN_H, FN_HKV, FN_D = 1, 4096, 32, 8, 64
FN_TOL = {"float32": 2e-5, "bfloat16": 1.5e-2}
OUT_DIR = os.path.join(ROOT, "chiprun_out")
#: phase 18: Llama-3.2-1B in bf16 at B 4: a ``train_4k`` step at S 4096
#: (phase 17 (a)'s), a prefill of 4 prompts of 4096 (``prefill_32k``'s
#: length cut to 4096) and one decode step over a cache of 4096
#: (``decode_32k``'s cut likewise); timed steps of each before its walk
STEP_CELLS = (("train", "train_4k"), ("prefill", "prefill_32k"),
              ("decode", "decode_32k"))
STEP_B, STEP_S, STEP_TIMED = 4, 4096, 2
#: the hand count of that train step's FLOPs (PERF.md §6: the layers'
#: bf16 GEMMs 1.28e14, the f32 unembedding 3.44e13, the flash backward's
#: f32 GEMMs 1.48e13), and the least share of it a walk should count
#: (the phase reports the share; a shortfall is explained op by op)
TRAIN_HAND_FLOPS, WALK_HAND_SHARE = 1.28e14 + 3.44e13 + 1.48e13, 0.9
#: the phase's time limit, seconds
STEP_MODEL_S = 60.0
#: phase 18 (d): plans tried from each end of the ranking until one runs
AUTOPLAN_TRIES = 3
#: phase 19: the design-axis mesh's width (four shards of the card, or
#: one shard a card over at most this many cards), the batch path's CPU
#: tile the sharded rows are padded to, and the timed runs of each route
MESH_SHARDS, MESH_TILE, MESH_RUNS = 4, 128, 3
#: phase 20: the LM mesh.  (a) Llama-3.2-1B at full width in bf16 on a
#: 1 x 1 mesh over NCCL: a ``train_4k`` step at B 4 x S 4096 (phase 17's
#: cut), a prefill of 4 x 4096 (``prefill_32k`` cut as phase 18's) and one
#: decode step over a cache of 4097 positions; the train step's parameters
#: within this relative distance of the single-device route's where not
#: bit-equal.  (b) four ranks on the one card over gloo on CUDA tensors:
#: the golden mesh cases (``golden_mesh.npz``) and the full-width prefill
#: and decode on a 2 x 2 mesh (no full-width training there: four copies
#: of the weights and their AdamW state, 4 x 12.4 GB, and gloo's host
#: staging of every collective); (c) one rank a card over NCCL where more
#: than one card is visible.  Tolerances of the golden cases as
#: tests/test_torch_mesh.py holds them on the CPU.
LM_MESH_ARCH, LM_MESH_B, LM_MESH_S, LM_MESH_RANKS = "llama3.2-1b", 4, 4096, 4
LM_MESH_PARAM_RTOL = 2e-6
LM_MESH_LOSS_ATOL, LM_MESH_RTOL_OF_SCALE, LM_MESH_MAX_FLIPS = 1e-5, 5e-5, 8
GOLDEN_MESH = os.path.join(ROOT, "src", "repro_torch", "data",
                           "golden_mesh.npz")
GOLDEN_MESH_FAMILIES = os.path.join(ROOT, "src", "repro_torch", "data",
                                    "golden_mesh_families.npz")
#: phase 20 (b) also runs the families past dense at full width in bf16 on
#: the 2 x 2 mesh: phase 16's prompts, frames and patches and its seed's
#: weights, a prefill and one decode step (fed the reference's greedy
#: token), beside (a)'s single-device route in bf16 and in f32 (the bf16
#: weights and inputs widened: the reference) on the same inputs.  bf16
#: alone says little: the full-width Mamba2's bf16 logits wander ~20 % of
#: their scale from the f32 ones on one device, as on the mesh (each
#: layer's roundings, in another order where tp's partial sums add).  So
#: the mesh's last logits must lie no further from the reference's, in
#: units of its largest |value|, than this factor times the single
#: device's bf16 route, or this floor (a wrong placement lands at O(1));
#: a greedy token may differ from the reference's only where its top two
#: are closer than twice the mesh's distance.
LM_MESH_FAMILIES = ("mamba2-370m", "zamba2-1.2b", "whisper-base",
                    "internvl2-2b")
LM_MESH_FAMILY_FACTOR, LM_MESH_FAMILY_FLOOR = 2.0, 2.0 ** -5

#: Phase 21: the dry-run (``repro_torch.launch.dryrun``) of every assigned
#: cell on both production meshes, one subprocess an arch and mesh (each
#: joins its own fake world), ``DRYRUN_JOBS`` at once, the heaviest first
#: (the 2 x 16 x 16 mesh's, whose DTensor planning costs ~3x); each
#: subprocess's time limit; the cell run again on ``cpu`` whose record
#: must equal its ``cuda`` one; Eq. 10's floors (1 ms of the card's bf16
#: compute, HBM and NVLink: smaller terms are "free" either way, as
#: ``benchmarks/tpu_model_accuracy.py`` skips them).
DRYRUN_JOBS, DRYRUN_TIMEOUT_S = 7, 900
DRYRUN_ORDER = ("kimi-k2-1t-a32b", "qwen2.5-32b", "zamba2-1.2b",
                "mamba2-370m", "qwen1.5-0.5b", "internvl2-2b",
                "h2o-danube-1.8b", "granite-moe-1b-a400m", "llama3.2-1b",
                "whisper-base")
DRYRUN_EQUAL_CELL = ("whisper-base", "prefill_32k", "single")
#: the sweep's mesh device type (the tensors are meta either way)
DRYRUN_DEVICE = "cuda"


class PhaseFailed(RuntimeError):
    pass


#: the script's start: each phase line carries the seconds since (t_s)
_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _START,
                      **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def ptxas_entries(built) -> list[dict]:
    """Each kernel instantiation of a build, from nvcc's ``-Xptxas -v``
    report: its (mangled) name, registers and spill-store bytes."""
    out, name, spill = [], None, 0
    for ln in built.ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(dict(entry=name, registers=int(m.group(1)),
                            spill_store_bytes=spill))
            name = None
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, by CUDA events.  A
    device-side sleep is queued first, so that the host has enqueued the
    launches before the device reaches them and the events time the device,
    not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms_each(fns) -> list[float]:
    """Device ms of each of ``fns``, run once each back to back behind a
    device-side sleep, by a CUDA event between consecutive calls."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(fns) + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    events[0].record()
    for fn, ev in zip(fns, events[1:]):
        fn()
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def phase_build(card: str) -> dict:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.conv_ce import ops as conv_ops
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    loaders = {"parallelism_search": lambda: mccm_ops.library(
                   "parallelism_search"),
               "mccm_latency": lambda: mccm_ops.library("mccm_latency"),
               "conv_ce": conv_ops.library,
               "flash_fwd": lambda: flash_ops.library(torch.bfloat16),
               "flash_fwd_f32": lambda: flash_ops.library(torch.float32)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as ex:
        futs = {k: ex.submit(f) for k, f in loaders.items()}
        built = {k: f.result() for k, f in futs.items()}
    wall = time.perf_counter() - t0
    kernels = {}
    for name, b in built.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           b.ptxas)]
        if not regs:
            raise PhaseFailed(f"no ptxas report for the {name} kernel")
        kernels[name] = dict(
            build_s=b.seconds, library=os.path.relpath(b.path, ROOT),
            registers=regs, spill_store_bytes=[int(x) for x in re.findall(
                r"(\d+) bytes spill stores", b.ptxas)],
            ptxas=[ln.strip() for ln in b.ptxas.splitlines()
                   if "ptxas info" in ln and ("Used" in ln or "spill" in ln
                                              or "Compiling" in ln)])
    info = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0),
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                load_s=wall, kernels=kernels)
    emit("build", **info)
    return info


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------
def _search_inputs(net, dev, db, device):
    """The search's arguments as the main path builds them: each design's
    PEs and CE index per layer, then the network's and board's tables."""
    from repro_torch.core.batch_eval import (_ce_maps, _pair_layer_tables,
                                             _search_ce, make_device_tables,
                                             make_tables, pes_hint)
    from repro_torch.kernels.mccm_eval import pair_tables
    t = make_tables(net, device=device)
    m = _ce_maps(db.to(device), t, make_device_tables(dev, device=device))
    pairs = pair_tables(t.candidates, pes_hint(dev.pes))
    return (m.pes_ce, _search_ce(m), *_pair_layer_tables(t, pairs))


def _compare(args, label: str, worst: dict) -> None:
    """The kernel against the plain version: ⟨pf, ph, pw⟩ and the finite
    costs equal bit for bit, inf in the same places."""
    import torch
    from repro_torch.kernels.mccm_eval import (parallelism_search,
                                               parallelism_search_ref)
    ker = parallelism_search(*args)
    ref = parallelism_search_ref(*args)
    torch.cuda.synchronize()
    for name, k, r in zip(("pf", "ph", "pw"), ker[:3], ref[:3]):
        if not torch.equal(k, r):
            n = int((k != r).sum())
            raise PhaseFailed(f"{label}: {name} differs in {n} entries")
    kc, rc = ker[3], ref[3]
    inf_k, inf_r = torch.isinf(kc), torch.isinf(rc)
    if not torch.equal(inf_k, inf_r):
        raise PhaseFailed(f"{label}: cost inf pattern differs")
    fin = ~inf_r
    if fin.any():
        diff = (kc[fin] - rc[fin]).abs()
        worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
        if not torch.equal(kc[fin], rc[fin]):
            raise PhaseFailed(f"{label}: cost differs in "
                              f"{int((diff > 0).sum())} entries, by up to "
                              f"{float(diff.max())}")
    worst["cases"] += 1
    worst["designs"] += kc.shape[0]


def phase_kernel(card: str, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.cnn.registry import CNN_NAMES, get_cnn
    from repro_torch.core.dse import encode_specs, sample_mixed
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES, get_board
    from repro_torch.core.device import DeviceSpec
    from repro_torch.kernels.mccm_eval import parallelism_search

    worst = dict(max_abs_err=0.0, cases=0, designs=0)
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        tmpl = encode_specs([make_arch(a, net, n) for a in ARCH_NAMES
                             for n in TEMPLATE_NS], len(net))
        for board in BOARD_NAMES:
            _compare(_search_inputs(net, get_board(board), tmpl, device),
                     f"{cnn}/{board}/templates", worst)
        mixed = sample_mixed(np.random.default_rng(1), len(net), 4096)
        _compare(_search_inputs(net, get_board("zcu102"), mixed, device),
                 f"{cnn}/zcu102/mixed4096", worst)
    # no pruning: all 324 pairs, 11 of a lane
    net = get_cnn("resnet152")
    unpruned = DeviceSpec("unpruned", UNPRUNED_PES, 32 << 20, 19.2)
    _compare(_search_inputs(net, unpruned, sample_mixed(
        np.random.default_rng(2), len(net), 4096), device),
        f"resnet152/{UNPRUNED_PES}pes/mixed4096", worst)
    # all-infeasible: CEs with 0 PEs and no layers -> <1, 1, 1> at inf
    args = list(_search_inputs(get_cnn("mobilenetv2"), get_board("zc706"),
                               encode_specs([make_arch("hybrid",
                                                       get_cnn("mobilenetv2"),
                                                       2)], 52), device))
    B, L = 3, args[1].shape[1]
    args[0] = torch.zeros(B, 16, device=device)
    args[1] = torch.full((B, L), -1, dtype=torch.int32, device=device)
    _compare(tuple(args), "all-infeasible", worst)
    pf, ph, pw, cost = parallelism_search(*args)
    if not (bool((pf == 1).all()) and bool((ph == 1).all())
            and bool((pw == 1).all()) and bool(torch.isinf(cost).all())):
        raise PhaseFailed("all-infeasible CEs did not give <1, 1, 1, inf>")
    emit("kernel_vs_plain", card=card, kernel="parallelism_search",
         replaces=KERNELS["parallelism_search"]["replaces"],
         cost="bit-equal", **worst)
    return worst


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------
def _check_metrics(got: dict, golden, prefix: str, worst: dict) -> None:
    import numpy as np
    for k, g in got.items():
        want = golden[f"{prefix}/{k}"]
        g = np.asarray(g)
        if k == "n_ces":
            if not np.array_equal(g, want):
                raise PhaseFailed(f"{prefix}: n_ces differs")
            continue
        if not np.isfinite(g).all():
            raise PhaseFailed(f"{prefix}: non-finite {k}")
        rel = float((np.abs(g - want) / np.maximum(np.abs(want), 1e-30)
                     ).max())
        worst[k] = max(worst.get(k, 0.0), rel)
        if rel > RTOL_METRICS:
            raise PhaseFailed(f"{prefix}: {k} rel err {rel} > "
                              f"{RTOL_METRICS}")


def phase_main_vs_golden(card: str, device) -> dict:
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.core.dse import decode_batch, sample_mixed
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES
    from repro_torch.kernels.mccm_eval import launches, reset_launches

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_mccm.npz"))
    worst: dict = {}
    sessions = {b: Session(get_board(b), device=str(device))
                for b in BOARD_NAMES}
    reset_launches()
    rows = 0
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        for board, ses in sessions.items():
            _check_metrics(ses.evaluate(specs, net), golden,
                           f"tmpl/{cnn}/{board}", worst)
            rows += len(specs)
    net = get_cnn("resnet50")
    mixed = decode_batch(sample_mixed(np.random.default_rng(0), len(net),
                                      256), len(net))
    _check_metrics(sessions["zcu102"].evaluate(mixed, net), golden,
                   "mixed/resnet50/zcu102", worst)
    rows += len(mixed)
    n = launches()
    emit("main_vs_golden", card=card, rows=rows, launches=n,
         rtol=RTOL_METRICS, max_rel_err=worst)
    if n["parallelism_search"] == 0:
        raise PhaseFailed("the main path launched no search kernel")
    return worst


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------
def phase_load(card: str, device, seed: int, n_designs: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.batch_eval import DEFAULT_CHUNK
    from repro_torch.core.dse import sample_mixed
    from repro_torch.kernels.mccm_eval import (last_launch, launches,
                                               parallelism_search,
                                               parallelism_search_ref,
                                               reset_launches)
    from repro_torch.kernels.mccm_eval import ops as mccm_ops

    net, board = get_cnn("resnet50"), get_board("zcu102")
    batch = sample_mixed(np.random.default_rng(seed), len(net), n_designs)
    ses = Session(board, device=str(device))
    ses.evaluate(batch, net)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = ses.evaluate(batch, net)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_launch = launches()["parallelism_search"]
    peak = torch.cuda.max_memory_allocated(device)
    if n_launch == 0:
        raise PhaseFailed("the main path launched no search kernel")
    for k, v in out.items():
        if v.shape[0] != n_designs or not bool(torch.isfinite(
                v.to(torch.float32)).all()):
            raise PhaseFailed(f"load: {k} has shape {tuple(v.shape)} or "
                              f"non-finite values")

    # the kernel alone, at one chunk of this batch
    args = _search_inputs(net, board, batch.take(slice(0, DEFAULT_CHUNK)),
                          device)
    kernel_ms = cuda_ms(lambda: parallelism_search(*args), 50)
    plan = last_launch()
    plain_ms = cuda_ms(lambda: parallelism_search_ref(*args), 3)
    pes, ce_idx, fc = args[:3]
    B, L, P = ce_idx.shape[0], fc.shape[0], fc.shape[1]
    # the search's operations on this chunk's data and its bytes
    # (mccm_ops.search_cost, which a walk charges too)
    cost = mccm_ops.search_cost(*args)
    ops = {k: cost[k] for k in ("live_layers", "live_rows", "ops_walk",
                                "ops_per_ce", "ops_tables")}
    ops.update(ops=cost["flops"], ops_5=cost["ops_5"])
    bytes_ms = cost["bytes"] / H100.hbm_bytes_per_s * 1e3
    ops_ms = ops["ops"] / H100.peak_flops_f32 * 1e3
    kernel = dict(
        **KERNELS["parallelism_search"], chunk_designs=B, layers_padded=L,
        pairs=P, bytes=cost["bytes"], **ops,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        contract_bound_ms=max(bytes_ms,
                              ops["ops"] / F32_NO_FMA_OPS_PER_S * 1e3),
        bound_5op_ms=max(bytes_ms,
                         ops["ops_5"] / H100.peak_flops_f32 * 1e3),
        library_ms=None, launches=n_launch, plan=plan.as_dict(),
        ptxas=[e for e in ptxas_entries(mccm_ops.library(
            "parallelism_search")) if f"ILi{plan.npl}E" in e["entry"]])
    # the profile covers the first PROFILE_DESIGNS designs: the profiler's
    # own processing grows with the kernels it records (~847 a chunk)
    part = batch.take(slice(0, min(PROFILE_DESIGNS, n_designs)))
    part_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ses.evaluate(part, net)
        torch.cuda.synchronize()
        part_walls.append(time.perf_counter() - t0)
    breakdown = _profile(ses, part, net, statistics.median(part_walls))
    info = dict(card=card, cnn="resnet50", board="zcu102", seed=seed,
                designs=n_designs, wall_s=walls,
                us_per_design=[w / n_designs * 1e6 for w in walls],
                us_per_design_median=statistics.median(walls)
                / n_designs * 1e6,
                launches=n_launch, runs=len(walls),
                max_memory_allocated=peak, kernel=kernel,
                profile=breakdown)
    emit("load", **info)
    kernel["us_per_design_median"] = info["us_per_design_median"]
    # phase 19 holds the sharded routes to these arrays
    kernel["arrays"] = out
    return kernel


def _profile(ses, batch, net, wall_unprofiled: float) -> dict:
    """Device time over one evaluate of ``batch``, from torch.profiler:
    busy time as the sum of the kernels' device times (one stream, so they
    do not overlap), the PyTorch ops that launched the most of it, and the
    full table in chiprun_out/profile_load.txt.  The idle share is taken against
    ``wall_unprofiled``, the median wall of the same evaluate without the
    profiler, whose own overhead stretches the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ses.evaluate(batch, net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    ops = [e for e in rows if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_load.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=60))
    if busy_s == 0:
        return {"device_time": "not measured", "wall_s_profiled": wall}
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    search = [e for e in kernels if "parallelism_search" in e.key]
    return {"designs": batch.batch,
            "wall_s_profiled": wall, "wall_s_unprofiled": wall_unprofiled,
            "device_busy_s": busy_s,
            "device_idle_share": max(0.0, 1 - busy_s / wall_unprofiled),
            "device_idle_share_profiled": max(0.0, 1 - busy_s / wall),
            "kernel_launches": sum(e.count for e in kernels),
            "search_kernel_s": sum(e.self_device_time_total
                                   for e in search) / 1e6,
            "top_ops": [{"op": e.key, "self_device_ms":
                         e.self_device_time_total / 1e3, "calls": e.count}
                        for e in top]}


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------
def _scalar_rows(metrics, fields) -> dict:
    """Scalar Metrics as the golden file keeps them: a float64 array per
    field, and ce_busy_s as (rows, 16) by CE id with NaN for no CE."""
    import numpy as np
    out = {k: np.array([float(getattr(m, k)) for m in metrics], np.float64)
           for k in fields if k != "ce_busy_s"}
    busy = np.full((len(metrics), 16), np.nan)
    for i, m in enumerate(metrics):
        for ce, b in m.ce_busy_s.items():
            busy[i, ce] = b
    out["ce_busy_s"] = busy
    return out


def phase_scalar(card: str, device) -> dict:
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES
    from repro_torch.kernels import launches, reset_launches

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_mccm.npz"))
    worst = {k: 0.0 for k in RTOL_SCALAR}
    parted: list[dict] = []
    designs = 0
    wall = 0.0
    reset_launches()
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        for board in BOARD_NAMES:
            ses = Session(get_board(board), device=str(device))
            prefix = f"scalar/{cnn}/{board}/"
            fields = [k[len(prefix):] for k in golden.files
                      if k.startswith(prefix)]
            t0 = time.perf_counter()
            ms = [ses.evaluate(s, net) for s in specs]
            wall += time.perf_counter() - t0
            got = _scalar_rows(ms, fields)
            if sorted(got) != sorted(fields):
                raise PhaseFailed(f"{prefix}: golden fields {fields}")
            for k, g in got.items():
                if not np.array_equal(g, golden[prefix + k],
                                      equal_nan=True):
                    raise PhaseFailed(f"{prefix}{k} differs from the "
                                      f"golden scalar metrics")
            batch = ses.evaluate(specs, net)           # on the card
            for k, tol in RTOL_SCALAR.items():
                rel = np.abs(batch[k] - got[k]) / np.abs(got[k])
                # rows where the JAX package's own batch path and Builder
                # part (the golden file holds both): phase 3 holds the
                # card's batch to the reference's batch there instead
                want = golden[f"tmpl/{cnn}/{board}/{k}"]
                ref_rel = np.abs(want - got[k]) / np.abs(got[k])
                for i in np.nonzero(ref_rel > tol)[0]:
                    parted.append(dict(cnn=cnn, board=board,
                                       design=specs[i].name, metric=k,
                                       reference_rel=float(ref_rel[i]),
                                       port_rel=float(rel[i])))
                rel = float(np.where(ref_rel > tol, 0.0, rel).max())
                worst[k] = max(worst[k], rel)
                if rel > tol:
                    raise PhaseFailed(f"{cnn}/{board}: batch {k} is {rel} "
                                      f"from the scalar Builder (> {tol})")
            designs += len(specs)
    n = launches()
    emit("scalar_path", card=card, designs=designs, scalar_s=wall,
         scalar_ms_per_design=wall / designs * 1e3, golden="exact",
         batch_vs_scalar_rtol=RTOL_SCALAR, batch_vs_scalar_max_rel=worst,
         reference_batch_parts_from_scalar=parted, launches=n)
    if n["parallelism_search"] == 0:
        raise PhaseFailed("the batch path launched no search kernel")
    return worst


# --------------------------------------------------------------------------
# phase 6
# --------------------------------------------------------------------------
def _layer_par(db, t, dt, search):
    """The per-layer ⟨pf, ph, pw⟩ (B, L, 3) that the batch path chooses
    for ``db``, chunk by chunk as ``evaluate_batch`` runs it, masked to 1
    off the valid layers as ``layer_state`` does; and ``layer_state``'s
    own (B, L) cycles for the same choice."""
    import torch
    from repro_torch.core.batch_eval import (DEFAULT_CHUNK, _ce_maps,
                                             _per_layer, _search_ce,
                                             layer_state)
    from repro_torch.kernels.mccm_eval import parallelism_search
    pars, comps = [], []
    for s in range(0, db.batch, DEFAULT_CHUNK):
        chunk = db.take(slice(s, s + DEFAULT_CHUNK))
        m = _ce_maps(chunk, t, dt)
        pf, ph, pw, _ = parallelism_search(m.pes_ce, _search_ce(m), *search)
        pars.append(torch.stack(
            [torch.where(m.valid_b, _per_layer(x, m), 1.0)
             for x in (pf, ph, pw)], -1))
        comps.append(layer_state(chunk, t, dt, m, (pf, ph, pw), 2).comp)
    return torch.cat(pars), torch.cat(comps)


def latency_setup(device, seed: int, n_designs: int):
    """Phase 6's net, board, tables, pair tables, (L, 4) dims and the
    ``n_designs`` ``sample_mixed`` designs of ``seed``, on ``device``."""
    import numpy as np
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.batch_eval import (_pair_layer_tables,
                                             make_device_tables,
                                             make_tables, pes_hint)
    from repro_torch.core.dse import sample_mixed
    from repro_torch.kernels.mccm_eval import pair_tables
    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=device)
    dt = make_device_tables(board, device=device)
    search = _pair_layer_tables(t, pair_tables(t.candidates,
                                               pes_hint(board.pes)))
    dims = torch.stack([t.F, t.CKK, t.OH, t.OW], 1)        # (L, 4)
    db = sample_mixed(np.random.default_rng(seed), len(net),
                      n_designs).to(device)
    return net, board, t, dt, search, dims, db


def _latency_bound(B: int, L: int) -> tuple[float, str, int, int]:
    """The latency function's bound at B designs of L layers: its bytes
    (dims and par read once, totals and cycles written once) at the card's
    memory rate against its operations (3 divisions, 3 ceils, 3 products,
    1 add an element) at its f32 rate, as ``mccm_eval.ops.latency_cost``
    counts them; bound ms, what sets it, bytes, operations."""
    from repro_torch.kernels.mccm_eval.ops import latency_cost
    cost = latency_cost(B, L)
    nbytes, ops = cost["bytes"], cost["flops"]
    bytes_ms = nbytes / H100.hbm_bytes_per_s * 1e3
    ops_ms = ops / H100.peak_flops_f32 * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


def _latency_shape(label: str, dims, par, comp) -> dict:
    """The latency kernel at one shape: equal to its plain version and to
    ``layer_state``'s cycles bit for bit, the plan the library reports
    equal to ``ops.latency_plan``; ms, plain ms and the bound."""
    import torch
    from repro_torch.kernels.mccm_eval import (mccm_latency,
                                               mccm_latency_ref)
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    B, L = par.shape[0], dims.shape[0]
    tot, cyc = mccm_latency(dims, par)
    ref_tot, ref_cyc = mccm_latency_ref(dims, par)
    torch.cuda.synchronize()
    if not (torch.equal(tot, ref_tot) and torch.equal(cyc, ref_cyc)
            and torch.equal(cyc, comp)):
        raise PhaseFailed(
            f"mccm_latency at {label} (B {B}, L {L}) differs from its plain "
            f"version in {int((tot != ref_tot).sum())} totals, "
            f"{int((cyc != ref_cyc).sum())} cycles, or from layer_state's "
            f"comp in {int((cyc != comp).sum())}")
    plan = mccm_ops.last_latency_launch()
    if plan != mccm_ops.latency_plan(B, L):
        raise PhaseFailed(f"mccm_latency at {label} ran {plan}, not "
                          f"{mccm_ops.latency_plan(B, L)}")
    bound_ms, bound_by, nbytes, ops = _latency_bound(B, L)
    return dict(label=label, designs=B, layers=L, bytes=nbytes, ops=ops,
                ms=cuda_ms(lambda: mccm_latency(dims, par), 20),
                plain_ms=cuda_ms(lambda: mccm_latency_ref(dims, par), 3),
                bound_ms=bound_ms, bound_by=bound_by, plan=plan.as_dict())


def phase_latency(card: str, device, seed: int, n_designs: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.core.batch_eval import DEFAULT_CHUNK
    from repro_torch.core.blocks import layer_cycles
    from repro_torch.core.dse import encode_specs
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.mccm_eval import (mccm_latency,
                                               mccm_latency_ref)

    net, board, t, dt, search, dims, db = latency_setup(device, seed,
                                                        n_designs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    par, comp = _layer_par(db, t, dt, search)
    tot, cyc = mccm_latency(dims, par)
    torch.cuda.synchronize()
    n = launches()
    peak = torch.cuda.max_memory_allocated(device)
    if n["mccm_latency"] == 0:
        raise PhaseFailed("the latency path launched no mccm_latency kernel")

    ref_tot, ref_cyc = mccm_latency_ref(dims, par)
    torch.cuda.synchronize()
    if not (torch.equal(tot, ref_tot) and torch.equal(cyc, ref_cyc)):
        raise PhaseFailed(
            f"mccm_latency differs from its plain version: "
            f"{int((tot != ref_tot).sum())} totals, "
            f"{int((cyc != ref_cyc).sum())} cycles")
    if not torch.equal(cyc, comp):
        raise PhaseFailed(f"mccm_latency differs from layer_state's comp in "
                          f"{int((cyc != comp).sum())} entries")
    max_abs_err = max(float((tot - ref_tot).abs().max()),
                      float((cyc - ref_cyc).abs().max()))

    # the 12 templates against the scalar Builder's exact cycles
    ses = Session(board, device=str(device))
    specs = [make_arch(a, net, n_) for a in ARCH_NAMES for n_ in TEMPLATE_NS]
    tpar, _ = _layer_par(encode_specs(specs, len(net), device=device), t, dt,
                         search)
    ttot, tcyc = mccm_latency(dims, tpar)
    tcyc, ttot = tcyc.cpu().numpy(), ttot.cpu().numpy()
    worst_layer = worst_total = 0.0
    for i, spec in enumerate(specs):
        acc = ses.build(spec, net)
        want = np.zeros(len(net))
        for seg in acc.segments:
            for k, li in enumerate(range(seg.spec.layer_lo,
                                         seg.spec.layer_hi + 1)):
                want[li] = layer_cycles(net[li], seg.ces[k % len(seg.ces)])
        worst_layer = max(worst_layer, float(
            (np.abs(tcyc[i, :len(net)] - want) / want).max()))
        worst_total = max(worst_total, abs(ttot[i] - want.sum())
                          / want.sum())
    if worst_layer > RTOL_LAYER_CYCLES or worst_total > RTOL_TOTAL_CYCLES:
        raise PhaseFailed(f"mccm_latency vs the scalar Builder: layer rel "
                          f"{worst_layer}, total rel {worst_total}")

    # the main shape, one batch-path chunk of it, and its valid layers
    # unpadded; no single PyTorch call adds a row in ascending order, so
    # library_ms stays null
    nv = t.L
    shapes = [_latency_shape(label, d, p, c) for label, d, p, c in (
        ("main", dims, par, comp),
        ("chunk", dims, par[:DEFAULT_CHUNK], comp[:DEFAULT_CHUNK]),
        ("valid", dims[:nv].contiguous(), par[:, :nv].contiguous(),
         comp[:, :nv]))]
    main = shapes[0]
    kernel = dict(
        **KERNELS["mccm_latency"], designs=main["designs"],
        layers_padded=main["layers"], bytes=main["bytes"], ops=main["ops"],
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, launches=n["mccm_latency"],
        max_abs_err=max_abs_err, plan=main["plan"])
    emit("latency", card=card, cnn="resnet50", board="zcu102", seed=seed,
         launches=n, max_memory_allocated=peak, equal_plain=True,
         equal_layer_state=True, template_layer_max_rel=worst_layer,
         template_total_max_rel=worst_total, kernel=kernel, shapes=shapes)
    return kernel


# --------------------------------------------------------------------------
# phase 7
# --------------------------------------------------------------------------
def _conv_layers(net, seed: int, device):
    """Each conv layer's 'same'-padded IFM and its weights, unit-normal f32
    from ``seed`` by numpy, on the card.  conv_ce is valid-only, so the
    IFM is padded here: total max((OH-1)*s + K - I, 0), half (rounded
    down) on top and left."""
    import numpy as np
    import torch
    import torch.nn.functional as nnf
    rng = np.random.default_rng(seed)
    out = []
    for l in net:
        x = torch.from_numpy(rng.standard_normal(
            (l.in_ch, l.ih, l.iw), dtype=np.float32)).to(device)
        w = torch.from_numpy(rng.standard_normal(
            (l.out_ch, l.in_ch, l.kh, l.kw), dtype=np.float32)).to(device)
        ph = max((l.oh - 1) * l.stride + l.kh - l.ih, 0)
        pw = max((l.ow - 1) * l.stride + l.kw - l.iw, 0)
        x = nnf.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        out.append((x, w))
    return out


def _ce_tiles(ses, spec, net):
    """⟨pf, ph, pw⟩ and the CE of every layer in the Builder's design."""
    acc = ses.build(spec, net)
    tiles = [None] * len(net)
    for seg in acc.segments:
        for k, li in enumerate(range(seg.spec.layer_lo,
                                     seg.spec.layer_hi + 1)):
            ce = seg.ces[k % len(seg.ces)]
            tiles[li] = (ce, (ce.par_of("f"), ce.par_of("oh"),
                              ce.par_of("ow")))
    return tiles


def phase_conv(card: str, device, seed: int) -> dict:
    import statistics as stats
    import torch
    import torch.nn.functional as nnf
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.blocks import layer_cycles
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.conv_ce import conv_ce, conv_ref, grid_size
    from repro_torch.kernels.conv_ce import ops as conv_ops

    net = get_cnn("resnet50")
    if any(l.kind == "dw" for l in net):
        raise PhaseFailed("the conv phase expects no depthwise layer")
    ses = Session(get_board("zcu102"), device=str(device))
    data = _conv_layers(net, seed, device)
    designs = {a: _ce_tiles(ses, make_arch(a, net, CONV_ARCH_CES), net)
               for a in ARCH_NAMES}
    # Eq. 1's grid of every layer run; a block runs on one SM, so a design
    # takes at least, layer by layer, its waves of 132 blocks, each the
    # time one SM takes for a whole tile's MACs at two issues a MAC
    eq1, grid_floor_ms = {}, {}
    for a, tiles in designs.items():
        floor = 0.0
        for l, (ce, par) in zip(net, tiles):
            ckk = l.in_ch * l.kh * l.kw
            eq1[a, l.name] = (-(-l.out_ch // par[0]), -(-l.oh // par[1]),
                              -(-l.ow // par[2]))
            blocks = grid_size(l.out_ch, l.oh, l.ow, *par)
            if blocks * ckk != layer_cycles(l, ce):
                raise PhaseFailed(f"{a}/{l.name}: grid x C*KH*KW is not "
                                  f"Eq. 1")
            floor += -(-blocks // H100.sms) * par[0] * par[1] * par[2] * ckk \
                * 2 / SM_F32_ISSUES_PER_S * 1e3
        grid_floor_ms[a] = floor

    def run(tiles):
        return [conv_ce(x, w, stride=l.stride, par_f=par[0],
                        par_oh=par[1], par_ow=par[2])
                for l, (x, w), (_, par) in zip(net, data, tiles)]

    torch.cuda.synchronize()
    reset_launches()
    outs, plans = {}, {}
    for a, tiles in designs.items():
        outs[a] = []
        for l, (x, w), (_, par) in zip(net, data, tiles):
            outs[a].append(conv_ce(x, w, stride=l.stride, par_f=par[0],
                                   par_oh=par[1], par_ow=par[2]))
            launch = conv_ops.last_launch()
            if launch.grid != eq1[a, l.name]:
                raise PhaseFailed(f"{a}/{l.name}: the library launched grid "
                                  f"{launch.grid}, Eq. 1's is "
                                  f"{eq1[a, l.name]}")
            plans[a, l.name] = launch.plan
    torch.cuda.synchronize()
    n = launches()
    if n["conv_ce"] != len(designs) * len(net):
        raise PhaseFailed(f"conv_ce launched {n['conv_ce']} times, not "
                          f"{len(designs) * len(net)}")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = [conv_ref(x, w, l.stride) for l, (x, w) in zip(net, data)]
    stop.record()
    torch.cuda.synchronize()
    plain_pass_ms = start.elapsed_time(stop)
    lib = [nnf.conv2d(x[None], w, stride=l.stride)[0]
           for l, (x, w) in zip(net, data)]
    max_abs_err = 0.0
    worst_lib = 0.0
    for a, got in outs.items():
        for l, g, r, lr in zip(net, got, plain, lib):
            if g.shape != (l.out_ch, l.oh, l.ow):
                raise PhaseFailed(f"{a}/{l.name}: shape {tuple(g.shape)}")
            if not torch.equal(g, r):
                raise PhaseFailed(
                    f"{a}/{l.name}: conv_ce differs from its plain version "
                    f"in {int((g != r).sum())} of {g.numel()} outputs")
            max_abs_err = max(max_abs_err, float((g - r).abs().max()))
            scale = float(lr.abs().max())
            excess = float(((g - lr).abs() - RTOL_CONV * lr.abs()).max())
            worst_lib = max(worst_lib, excess / scale)
            if excess > RTOL_CONV * scale:
                raise PhaseFailed(f"{a}/{l.name}: conv_ce is further from "
                                  f"conv2d than rtol {RTOL_CONV}, atol "
                                  f"{RTOL_CONV}*max|conv2d|")

    pass_ms = {a: cuda_ms(lambda t=tiles: run(t), 5)
               for a, tiles in designs.items()}
    # where a pass's time goes: the slowest layers of each design, with
    # the grid's blocks and the outputs a full tile holds
    slowest = {}
    for a, tiles in designs.items():
        each = cuda_ms_each([
            lambda l=l, x=x, w=w, par=par: conv_ce(
                x, w, stride=l.stride, par_f=par[0], par_oh=par[1],
                par_ow=par[2])
            for l, (x, w), (_, par) in zip(net, data, tiles)])
        top = sorted(range(len(net)), key=lambda i: -each[i])[:5]
        slowest[a] = [dict(
            layer=net[i].name, ms=each[i], tile=tiles[i][1],
            blocks=grid_size(net[i].out_ch, net[i].oh, net[i].ow,
                             *tiles[i][1]),
            ckk=net[i].in_ch * net[i].kh * net[i].kw,
            plan=plans[a, net[i].name].as_dict()) for i in top]
    library_ms = cuda_ms(lambda: [nnf.conv2d(x[None], w, stride=l.stride)
                                  for l, (x, w) in zip(net, data)], 5)
    big = max(range(len(net)), key=lambda i: net[i].in_ch * net[i].kh
              * net[i].kw)
    x, w = data[big]
    plain_big_ms = cuda_ms(lambda: conv_ref(x, w, net[big].stride), 1)
    # bound: 2 operations a MAC at the card's f32 rate; each padded input,
    # weight and output once (conv_ops.cost, which a walk charges too).
    # The contract's bound: the same operations at the no-FMA rate the
    # kernel is held to
    costs = [conv_ops.cost(*x.shape, *w.shape[:1], *w.shape[2:], l.stride,
                           x.dtype) for l, (x, w) in zip(net, data)]
    flops = sum(c["flops"] for c in costs)
    nbytes = sum(c["bytes"] for c in costs)
    bytes_ms = nbytes / H100.hbm_bytes_per_s * 1e3
    ops_ms = flops / H100.peak_flops_f32 * 1e3
    contract_bound_ms = max(bytes_ms, flops / F32_NO_FMA_OPS_PER_S * 1e3)
    kernel = dict(
        **KERNELS["conv_ce"], layers=len(net), designs=list(designs),
        flops=flops, bytes=nbytes,
        ms=stats.mean(pass_ms.values()), plain_ms=plain_pass_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms, launches=n["conv_ce"],
        max_abs_err=max_abs_err)
    emit("conv", card=card, cnn="resnet50", board="zcu102", seed=seed,
         ces=CONV_ARCH_CES, layer_runs=len(designs) * len(net),
         launches=n, grid_is_eq1=True, equal_plain=True,
         vs_conv2d=dict(rtol=RTOL_CONV, atol_of_max=RTOL_CONV,
                        worst_excess_of_max=worst_lib),
         pass_ms=pass_ms, grid_floor_ms=grid_floor_ms,
         bound_ms=kernel["bound_ms"], contract_bound_ms=contract_bound_ms,
         slowest_layers=slowest,
         conv2d_pass_ms=library_ms,
         plain_pass_ms=plain_pass_ms,
         plain_one_layer=dict(layer=net[big].name, ms=plain_big_ms),
         kernel=kernel)
    return kernel


# --------------------------------------------------------------------------
# phase 8
# --------------------------------------------------------------------------
def _attn_cost(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int,
               causal: bool, window, dtype, q_offset: int = 0) -> dict:
    """The least the card needs for one attention call: 4·D operations for
    each (query, key) pair the masks let through (2·D for q·k, 2·D for
    p·v), at the tensor-core rate in bf16 and the f32 rate in f32; q, k, v
    read once and the output written once (``flash_attn.ops.cost``, which
    a walk charges too)."""
    import torch
    from repro_torch.kernels.flash_attn.ops import cost
    c = cost(B, Sq, Sk, H, Hkv, D, causal, window, dtype, q_offset)
    pairs, ops, nbytes = c["pairs"], c["flops"], c["bytes"]
    ops_ms = ops / (H100.peak_flops_bf16 if dtype == torch.bfloat16
                    else H100.peak_flops_f32) * 1e3
    bytes_ms = nbytes / H100.hbm_bytes_per_s * 1e3
    return dict(pairs=pairs, ops=ops, bytes=nbytes,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _flash_tolerance(dtype) -> dict:
    from repro_torch.kernels.flash_attn.ref import TOLERANCE
    rtol, atol = TOLERANCE[dtype]
    return {"rtol_of_plain": rtol, "atol": atol}


def _flash_vs_plain(q, k, v, label: str, *, causal: bool = True,
                    window=None) -> float:
    """max |kernel - plain| on the card; fails where an element lies
    outside the dtype's element-wise tolerance, or on a non-finite or
    misshapen output."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attention, flash_fwd_ref
    from repro_torch.kernels.flash_attn.ref import excess
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_fwd_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if got.shape != q.shape or got.dtype != q.dtype:
        raise PhaseFailed(f"{label}: output {tuple(got.shape)} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise PhaseFailed(f"{label}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    over = excess(got, want)
    if over > 0:
        raise PhaseFailed(f"{label}: flash_fwd is up to {err} from its plain "
                          f"version, {over} past the tolerance "
                          f"{_flash_tolerance(q.dtype)}")
    return err


def phase_flash(card: str, device, seed: int) -> tuple[dict, dict]:
    """Phase 8; returns the ``kernels`` entries of the bf16 and the f32
    source (their launches are filled in from phases 9 and 10)."""
    import torch
    import torch.nn.functional as nnf
    from repro_torch.configs import get_config
    from repro_torch.kernels import copies, launches, reset_launches
    from repro_torch.kernels.flash_attn import flash_attention, flash_fwd_ref
    from repro_torch.kernels.flash_attn.ops import (f32_plan, launch_plan,
                                                    library)

    cfg = get_config("llama3.2-1b")
    B, S, H, Hkv = FLASH_B, FLASH_S, cfg.n_heads, cfg.n_kv_heads
    gen = torch.Generator(device=device).manual_seed(seed)
    cases = [(f"{name}_{tag}", dtype, s_len, window, D)
             for tag, dtype in (("bf16", torch.bfloat16),
                                ("f32", torch.float32))
             for name, s_len, window, D in (
                 ("llama", S, None, cfg.head_dim),
                 ("ragged", FLASH_RAGGED_S, None, cfg.head_dim),
                 ("window", S, FLASH_WINDOW, cfg.head_dim),
                 ("d128", S, None, FLASH_WIDE_D))]
    out = {}
    for label, dtype, s_len, window, D in cases:
        plan = launch_plan(D, dtype)
        if dtype == torch.float32 and plan != f32_plan(D):
            raise PhaseFailed(f"{label}: the library's plan {plan} is not "
                              f"its Python mirror's {f32_plan(D)}")
        q, k, v = (torch.randn(B, s_len, h, D, generator=gen, device=device
                               ).to(dtype) for h in (H, Hkv, Hkv))
        reset_launches()
        err = _flash_vs_plain(q, k, v, label, window=window)
        if launches()["flash_fwd"] != 1 or copies()["flash_fwd"] != 0:
            raise PhaseFailed(f"{label}: {launches()['flash_fwd']} launches,"
                              f" {copies()['flash_fwd']} input copies")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                             window=window), 10)
        plain_ms = cuda_ms(lambda: flash_fwd_ref(q, k, v, causal=True,
                                                 window=window), 2)
        # one PyTorch call computing the same function, timed only; the
        # port never calls it
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            def lib():
                return nnf.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(s_len, device=device)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)

            def lib():
                return nnf.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        library_ms = cuda_ms(lib, 10)
        lib_err = float((lib().transpose(1, 2).float() - flash_attention(
            q, k, v, causal=True, window=window).float()).abs().max())
        out[label] = dict(
            B=B, S=s_len, H=H, Hkv=Hkv, D=D, dtype=str(dtype), window=window,
            max_abs_err=err, tolerance=_flash_tolerance(dtype), ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            max_abs_diff_vs_library=lib_err,
            plan=plan,
            **_attn_cost(B, s_len, s_len, H, Hkv, D, True, window, dtype))
        del q, k, v, qt, kt, vt
    emit("flash", card=card, seed=seed, cases=out,
         ptxas={str(t): ptxas_entries(library(t))
                for t in (torch.bfloat16, torch.float32)})

    def entry(name, label, dtype):
        c = out[label]
        return dict(**KERNELS[name], ms=c["ms"], plain_ms=c["plain_ms"],
                    library_ms=c["library_ms"], bound_ms=c["bound_ms"],
                    bound_by=c["bound_by"],
                    max_abs_err=max(x["max_abs_err"] for x in out.values()
                                    if x["dtype"] == str(dtype)))
    return (entry("flash_fwd", "llama_bf16", torch.bfloat16),
            entry("flash_fwd_f32", "llama_f32", torch.float32))


# --------------------------------------------------------------------------
# phase 9
# --------------------------------------------------------------------------
def _device_profile(fn, name: str, top: int = 8,
                    share_of: str = "flash_fwd") -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    sum of its kernels' device times, one stream), the share of it taken by
    the kernel named ``share_of``, the kernels that took the most of it, and
    the full table in chiprun_out/profile_<name>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=40))
    if busy_s == 0:
        return {"device_time": "not measured", "wall_s_profiled": wall}
    share_s = sum(e.self_device_time_total for e in kernels
                  if share_of in e.key) / 1e6
    return {"wall_s_profiled": wall, "device_busy_s": busy_s,
            f"{share_of}_share_of_busy": share_s / busy_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [
                {"kernel": e.key[:80], "device_ms":
                 e.self_device_time_total / 1e3, "calls": e.count}
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[
                                    :top]]}


def phase_serve(card: str, device, seed: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import copies, launches, reset_launches
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("llama3.2-1b")
    engine = ServeEngine(cfg, seed=seed, device=str(device))
    model = engine.api.init(torch.Generator(device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_LENS
    lens = [hi] + rng.integers(lo, hi, SERVE_PROMPTS - 1).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    engine.generate(model, prompts, max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res = engine.generate(model, prompts, max_new_tokens=SERVE_NEW_TOKENS)
    n_main, c_main = launches()["flash_fwd"], copies()["flash_fwd"]
    peak = torch.cuda.max_memory_allocated(device)
    if n_main != cfg.n_layers or c_main != 0:
        raise PhaseFailed(f"generate launched flash_fwd {n_main} times, not "
                          f"once per layer ({cfg.n_layers}), and copied "
                          f"{c_main} inputs (want 0)")
    for i, toks in enumerate(res.tokens):
        if len(toks) != SERVE_NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise PhaseFailed(f"request {i}: tokens {toks}")

    # launches per stage: prefill alone, then one decode step alone
    toks = torch.zeros(len(prompts), max(lens), dtype=torch.long,
                       device=device)
    for i, p in enumerate(prompts):
        toks[i, max(lens) - len(p):] = torch.tensor(p, device=device)
    reset_launches()
    logits, cache = engine.api.prefill(model, toks, engine.rt,
                                       max_len=max(lens) + 2)
    torch.cuda.synchronize()
    n_prefill, c_prefill = launches()["flash_fwd"], copies()["flash_fwd"]
    reset_launches()
    step_logits, _ = engine.api.decode_step(
        model, cache, logits[:, -1].argmax(-1)[:, None], engine.rt)
    torch.cuda.synchronize()
    n_decode = launches()["flash_fwd"]
    if n_prefill != cfg.n_layers or n_decode != 0 or c_prefill != 0:
        raise PhaseFailed(f"flash_fwd launches: {n_prefill} in prefill "
                          f"(want {cfg.n_layers}), {n_decode} in a decode "
                          f"step (want 0); {c_prefill} input copies in "
                          f"prefill (want 0)")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(step_logits).all())):
        raise PhaseFailed("non-finite logits")
    if logits.shape != (len(prompts), 1, cfg.padded_vocab):
        raise PhaseFailed(f"prefill logits {tuple(logits.shape)}")
    # where the device time goes: one prefill, one decode step over the
    # prompts' full cache
    profile = {
        "prefill": _device_profile(lambda: engine.api.prefill(
            model, toks, engine.rt, max_len=max(lens) + 2), "serve_prefill"),
        "decode_step": _device_profile(lambda: engine.api.decode_step(
            model, cache, toks[:, -1:], engine.rt), "serve_decode")}
    del cache

    # the kernel on layer 0's real q, k and v
    with torch.no_grad():
        p0 = model["layers"][0]
        h = L.rms_norm(L.embed(model["embed"], toks, cfg), p0["ln1"],
                       cfg.norm_eps)
        q, k, v = L._qkv(p0["attn"], h, cfg)
        cos, sin = L.rope_angles(torch.arange(toks.shape[1], device=device),
                                 cfg.head_dim, cfg.rope_theta)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    err = _flash_vs_plain(q, k, v, "layer 0 q, k, v")
    info = dict(card=card, arch=cfg.name, dtype=cfg.dtype, params=n_params,
                seed=seed, prompt_lens=lens, new_tokens=SERVE_NEW_TOKENS,
                prefill_s=res.prefill_s, decode_s=res.decode_s,
                decode_steps=res.n_steps,
                decode_tokens_per_s=res.tokens_per_s,
                max_memory_allocated=peak,
                launches=dict(generate=n_main, prefill=n_prefill,
                              decode_step=n_decode),
                flash_fwd_copies=dict(generate=c_main, prefill=c_prefill),
                layer0_max_abs_err=err,
                layer0_tolerance=_flash_tolerance(cfg.torch_dtype),
                profile=profile,
                tokens_head=[t[:8] for t in res.tokens])
    emit("serve", **info)
    return info


def flash_launches(cfg, prompt_len: int, enc_len: int = 0) -> tuple:
    """``flash_fwd`` launches of one prefill and of one decode step of
    ``cfg``'s family under ``Runtime()`` (``auto``: the chunked path past
    2048 positions), for a padded prompt of ``prompt_len`` tokens (the
    VLM's patches go ahead of them) and, for the enc-dec, ``enc_len``
    frames: the dense and MoE stacks and the VLM one a layer in prefill;
    Mamba2 none; the hybrid one a call of its shared block; the enc-dec
    one an encoder layer, and one a decoder layer's cross-attention in
    prefill and in every decode step."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every if prompt_len > 2048 else 0,
                0)
    if cfg.family == "encdec":
        return (cfg.n_enc_layers * (enc_len > 2048)
                + cfg.n_dec_layers * (max(prompt_len, enc_len) > 2048),
                cfg.n_dec_layers * (enc_len > 2048))
    S = prompt_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    return (cfg.n_layers if S > 2048 else 0), 0


# --------------------------------------------------------------------------
# phase 10
# --------------------------------------------------------------------------
def phase_golden_lm(card: str, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import from_jax, unflatten
    from repro_torch.serve.engine import ServeEngine

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_lm.npz"))
    cfg = get_config(str(golden["arch"])).reduced().replace(
        dtype=str(golden["dtype"]))
    model = from_jax(unflatten(golden, "params/"), cfg, device=device)
    engine = ServeEngine(cfg, device=str(device))
    new = int(golden["new_tokens"])
    out = {}
    for batch in ("long", "short"):
        n = int(golden[f"{batch}/n_prompts"])
        prompts = [golden[f"{batch}/prompt/{i}"].tolist() for i in range(n)]
        reset_launches()
        res = engine.generate(model, prompts, max_new_tokens=new)
        n_flash = launches()["flash_fwd"]
        want = golden[f"{batch}/tokens"].tolist()
        if res.tokens != want:
            raise PhaseFailed(f"golden {batch}: tokens {res.tokens} != the "
                              f"JAX package's {want}")
        Lp = max(len(p) for p in prompts)
        toks = torch.zeros(n, Lp, dtype=torch.long, device=device)
        for i, p in enumerate(prompts):
            toks[i, Lp - len(p):] = torch.tensor(p, device=device)
        logits, _ = engine.api.prefill(model, toks, engine.rt)
        err = float(np.abs(logits[:, -1].cpu().numpy()
                           - golden[f"{batch}/last_logits"]).max())
        if err > LM_LOGITS_ATOL:
            raise PhaseFailed(f"golden {batch}: prefill logits {err} from "
                              f"the JAX package's (> {LM_LOGITS_ATOL})")
        want_flash = cfg.n_layers if Lp > 2048 else 0
        if n_flash != want_flash:
            raise PhaseFailed(f"golden {batch}: {n_flash} flash_fwd launches"
                              f", want {want_flash}")
        out[batch] = dict(prompt_lens=[len(p) for p in prompts],
                          tokens_equal=True, logits_max_abs_err=err,
                          flash_launches=n_flash)
    info = dict(card=card, arch=cfg.name, dtype=cfg.dtype,
                logits_atol=LM_LOGITS_ATOL, batches=out)
    emit("golden_lm", **info)
    return info


# --------------------------------------------------------------------------
# phase 11
# --------------------------------------------------------------------------
def _front_check(front, pts, g_front, g_pts, label: str) -> list:
    """A front (row indices, their oriented points) against the golden
    one: a row on one front only fails, unless its point lies within
    RTOL_METRICS of a point of the other front (a near-tie, returned)."""
    import numpy as np
    ties = []
    for side, rows, mine, other_rows, other in (
            ("port", front, pts, g_front, g_pts),
            ("golden", g_front, g_pts, front, pts)):
        for i, p in zip(rows, mine):
            if i in other_rows:
                continue
            rel = np.abs(other - p) / np.maximum(np.abs(p), 1e-30)
            if not (rel <= RTOL_METRICS).all(1).any():
                raise PhaseFailed(f"{label}: row {int(i)} is on the "
                                  f"{side} front only, with no near-tie")
            ties.append(dict(row=int(i), front=side, point=p.tolist()))
    return ties


def _front_metrics(metrics, front, golden, prefix: str, worst: dict):
    """The metrics of the rows on both fronts against the golden file's."""
    import numpy as np
    g_front = golden[f"{prefix}/front"]
    both = np.intersect1d(front, g_front)
    got = {k: np.asarray(v)[both] for k, v in metrics.items()}
    pos = np.searchsorted(g_front, both)
    want = {f"{prefix}/front/{k}": golden[f"{prefix}/front/{k}"][pos]
            for k in metrics}
    _check_metrics(got, want, f"{prefix}/front", worst)


def _golden_dse(ses, net) -> dict:
    """explore at the golden file's configurations, held to it."""
    import numpy as np
    from repro_torch.api import SearchConfig, orient
    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_dse.npz"))
    cfg = json.loads(str(golden["config"]))
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    worst: dict = {}
    out = {}
    for run in ("random", "search"):
        c = cfg[run]
        if run == "random":
            res = ses.explore(net, n=c["n"], seed=c["seed"],
                              chunk=c["chunk"])
        else:
            res = ses.explore(net, n=c["n"], strategy="search",
                              seed=c["seed"], config=SearchConfig(
                                  pop_size=c["pop_size"], seed=c["seed"]))
        designs = res.batch.to_numpy()
        same = np.ones(c["n"], bool)
        for f, a in zip(fields, designs):
            eq = golden[f"{run}/{f}"] == a
            same &= eq.reshape(len(eq), -1).all(1)
        pts = orient(res.metrics, DSE_OBJ)[res.front]
        g_front = golden[f"{run}/front"]
        g_pts = orient({k: golden[f"{run}/front/{k}"] for k in DSE_OBJ},
                       DSE_OBJ)
        info = dict(n=c["n"], front=len(res.front),
                    golden_front=len(g_front))
        if run == "random":
            if not same.all():
                raise PhaseFailed(f"golden random: {int((~same).sum())} "
                                  f"designs differ from the JAX package's "
                                  f"draws")
            info["front_near_ties"] = _front_check(
                res.front, pts, g_front, g_pts, "golden random")
            _front_metrics(res.metrics, res.front, golden, run, worst)
        else:
            pop = c["pop_size"]
            gens = [int(g) for g in range(c["n"] // pop)
                    if not same[g * pop:(g + 1) * pop].all()]
            if gens and gens[0] == 0:
                raise PhaseFailed("golden search: the first generation's "
                                  "designs differ from the JAX package's "
                                  "(host draws and repair)")
            info["search_diverged_at"] = gens[0] if gens else None
            if not gens:
                info["front_near_ties"] = _front_check(
                    res.front, pts, g_front, g_pts, "golden search")
                _front_metrics(res.metrics, res.front, golden, run, worst)
        out[run] = info
    out["rtol"] = RTOL_METRICS
    out["max_rel_err"] = worst
    return out


def _scalar_front_rows(ses, net, res) -> dict:
    """Up to DSE_SCALAR_ROWS front rows of a result against the port's
    scalar Builder, at the JAX package's scalar-vs-batch tolerances."""
    import numpy as np
    from repro_torch.core.dse import decode_design
    worst = {}
    rows = res.front[:DSE_SCALAR_ROWS]
    for i in rows:
        m = ses.evaluate(decode_design(res.batch, int(i), len(net)), net)
        for k, tol in RTOL_SCALAR.items():
            want = float(getattr(m, k))
            rel = abs(float(res.metrics[k][i]) - want) / max(abs(want),
                                                             1e-30)
            worst[k] = max(worst.get(k, 0.0), rel)
            if rel > tol:
                raise PhaseFailed(f"dse front row {int(i)}: {k} rel err "
                                  f"{rel} from the scalar Builder > {tol}")
    return dict(rows=len(rows), max_rel_err=worst)


def _step_costs(ses, net, res, device) -> dict:
    """One generation step at pop_size, on children bred from the search's
    front, under torch.profiler: its kernel launches, the device's busy
    time and idle share against the wall (the pulls included); and its
    repair alone: device ms by CUDA events (the loops' checks wait on the
    host) and kernel launches."""
    import numpy as np
    import torch
    from repro_torch.core.dse import SearchConfig, make_children
    from repro_torch.core.dse.encoding import repair_batch_torch
    from repro_torch.core.dse.search import search_step
    cfg = SearchConfig()
    pop = make_children(np.random.default_rng(0), res.batch.take(res.front),
                        len(net), cfg, cfg.pop_size).to(device)
    tables, devt = ses.tables(net), ses.device_tables()
    w = torch.tensor([0.5, 0.5], dtype=torch.float32, device=device)
    lo = torch.full((2,), float("inf"), device=device)
    hi = torch.full((2,), float("-inf"), device=device)

    def step():
        out = search_step(pop, tables, devt, w, lo, hi, objectives=DSE_OBJ,
                          min_ces=cfg.min_ces, max_ces=cfg.max_ces,
                          tile=ses.config.tile, chunk=ses.config.chunk)
        for t in out[2:5]:
            t.cpu()

    def repair():
        repair_batch_torch(pop, len(net), min_ces=cfg.min_ces,
                           max_ces=cfg.max_ces)
    step()
    prof = _device_profile(step, "dse_step")
    prof.pop("flash_fwd_share_of_busy", None)
    if "device_busy_s" in prof:
        prof["device_idle_share"] = max(
            0.0, 1 - prof["device_busy_s"] / prof["wall_s_profiled"])
    rprof = _device_profile(repair, "dse_repair")
    return dict(designs=cfg.pop_size, step=prof,
                repair=dict(ms=cuda_ms(repair, 10),
                            kernel_launches=rprof.get("kernel_launches")))


def phase_dse(card: str, device) -> dict:
    """The DSE path, ``Session.explore``, on MobileNetV2 and the default
    board: the golden configurations, then the paper's budget."""
    import numpy as np
    import torch
    from repro_torch.api import Session, get_board, get_cnn, orient, pareto
    from repro_torch.kernels import launches, reset_launches

    t_phase = time.perf_counter()
    net = get_cnn(DSE_CNN)
    ses = Session(get_board(), device=str(device))
    golden = _golden_dse(ses, net)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runs, results = {}, {}
    for run, kw in (("random", dict(seed=DSE_RANDOM_SEED)),
                    ("search", dict(strategy="search",
                                    seed=DSE_SEARCH_SEED))):
        reset_launches()
        t0 = time.perf_counter()
        res = ses.explore(net, n=DSE_BUDGET, **kw)
        wall = time.perf_counter() - t0
        n = launches()
        if n["parallelism_search"] == 0:
            raise PhaseFailed(f"dse {run}: explore launched no search "
                              f"kernel")
        for k, v in res.metrics.items():
            if v.shape != (DSE_BUDGET,) or not np.isfinite(v).all():
                raise PhaseFailed(f"dse {run}: {k} has shape {v.shape} or "
                                  f"non-finite values")
        pts = orient(res.metrics, DSE_OBJ)
        if not np.array_equal(np.sort(res.front), pareto(pts)):
            raise PhaseFailed(f"dse {run}: the front is not pareto() of "
                              f"its own sample")
        fp = pts[res.front]
        if any(((fp <= p).all(1) & (fp < p).any(1)).any() for p in fp):
            raise PhaseFailed(f"dse {run}: the front is not mutually "
                              f"non-dominated")
        results[run] = res
        runs[run] = dict(
            seconds=res.seconds, wall_s=wall,
            per_design_us=res.per_design_us, n_evals=res.n_evals,
            front=len(res.front), launches=n,
            generations=len(res.timings) if run == "search" else None,
            chunks=len(res.timings) if run == "random" else None,
            breed_s=[t["breed_s"] for t in res.timings],
            step_s=[t["step_s"] for t in res.timings])
    peak = torch.cuda.max_memory_allocated(device)
    rp = orient(results["random"].metrics, DSE_OBJ)
    ref = rp[int(np.argmin(rp[:, 0]))]
    sp = orient(results["search"].metrics, DSE_OBJ)
    dom = (sp <= ref).all(1) & (sp < ref).any(1)
    if not dom.any():
        raise PhaseFailed("dse: no searched design strictly dominates the "
                          "random sweep's best-latency design")
    scalar = _scalar_front_rows(ses, net, results["search"])
    step = _step_costs(ses, net, results["search"], device)
    info = dict(card=card, cnn=DSE_CNN, board=ses.default_device.name,
                budget=DSE_BUDGET, golden=golden, runs=runs,
                random_best_latency=ref.tolist(),
                search_dominating=int(dom.sum()),
                scalar_vs_front=scalar, step=step,
                max_memory_allocated=peak,
                compile=ses.compile_stats(),
                phase_s=time.perf_counter() - t_phase)
    emit("dse", **info)
    return info


# --------------------------------------------------------------------------
# phase 12
# --------------------------------------------------------------------------
def _spec_pool(net, n: int, seed: int) -> list:
    """``n`` designs of ``net`` as specs, decoded from ``sample_mixed``."""
    import numpy as np
    from repro_torch.core.dse import sample_mixed
    from repro_torch.core.dse.encoding import decode_batch
    return decode_batch(sample_mixed(np.random.default_rng(seed), len(net),
                                     n), len(net))


def _same_bits(got: dict, want: dict) -> bool:
    import numpy as np
    return got.keys() == want.keys() and all(
        np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
        for k in want)


def _quantiles(xs) -> dict:
    import numpy as np
    if not xs:
        return {"n": 0}
    a = np.asarray(xs) * 1e3
    return {"n": len(xs), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max())}


class _MegabatchProbe:
    """Wraps the drain for a block: each megabatch's chunks, asked and
    padded rows (each chunk at its own pad, read from the drain's plan),
    search-kernel launches and seconds."""

    def __enter__(self):
        from repro_torch.core import session as psession
        from repro_torch.kernels import launches
        self.records, self._mod, plans = [], psession, []
        real_plan = self._real_plan = psession.plan_megabatch
        real_run = self._real_run = psession.Session._run_megabatch

        def plan(*a, **kw):
            plans.append(real_plan(*a, **kw))
            return plans[-1]

        def run(ses, reqs):
            n_plans = len(plans)
            before = launches()["parallelism_search"]
            t0 = time.perf_counter()
            real_run(ses, reqs)
            s = time.perf_counter() - t0
            chunks = [c for p in plans[n_plans:] for c in p.chunks]
            self.records.append(dict(
                chunks=len(chunks), rows=sum(c.rows for c in chunks),
                padded=sum(c.pad for c in chunks),
                launches=launches()["parallelism_search"] - before, s=s))
        psession.plan_megabatch = plan
        psession.Session._run_megabatch = run
        return self

    def __exit__(self, *exc):
        self._mod.plan_megabatch = self._real_plan
        self._mod.Session._run_megabatch = self._real_run


def _submit_equality(ses, nets, boards) -> dict:
    """(a): one drain of a fixed mix equals ``evaluate`` bit for bit."""
    from repro_torch.core.coalesce import plan_megabatch
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels import launches, reset_launches
    (rnet, mnet), (rboard, mboard) = nets, boards
    reqs = [([make_arch(a, rnet, n)], rnet, rboard)
            for a in ARCH_NAMES for n in TEMPLATE_NS]
    pool = _spec_pool(rnet, SUBMIT_SWEEPS[0], 0)
    reqs += [(pool, rnet, rboard), (pool[:SUBMIT_SWEEPS[1]], rnet, rboard)]
    reqs += [([make_arch(a, mnet, n)], mnet, mboard)
             for a in ARCH_NAMES for n in TEMPLATE_NS]
    reqs.append((_spec_pool(mnet, SUBMIT_SWEEPS[2], 0), mnet, mboard))
    scalar = f"{{L1-Last:CE1-CE{TEMPLATE_NS[1]}}}"
    before = {k: getattr(ses.stats, k) for k in SUBMIT_COUNTERS}
    reset_launches()
    t0 = time.perf_counter()
    futs = [ses.submit(specs, net, board) for specs, net, board in reqs]
    futs.append(ses.submit(scalar, rnet, rboard))
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    n_launch = launches()["parallelism_search"]
    stats = {k: getattr(ses.stats, k) - before[k] for k in SUBMIT_COUNTERS}
    groups = [((net.name, board.name), len(specs))
              for specs, net, board in reqs] + [((rnet.name, rboard.name), 1)]
    plan = plan_megabatch(groups, ses.config.chunk, ses.config.tile)
    parted = [i for i, (specs, net, board) in enumerate(reqs)
              if not _same_bits(outs[i], ses.evaluate(specs, net, board))]
    want = ses.evaluate([scalar], rnet, rboard)
    if any(outs[-1][k] != float(want[k][0]) for k in want):
        parted.append(len(reqs))
    if parted:
        raise PhaseFailed(f"submit (a): requests {parted} part from "
                          f"evaluate on the same specs")
    if stats["megabatches"] != 1:
        raise PhaseFailed(f"submit (a): {stats['megabatches']} drains, "
                          f"not one")
    if (stats["coalesced_chunks"], stats["coalesced_merges"],
            stats["coalesced_splits"]) != (len(plan.chunks), plan.merges,
                                          plan.splits):
        raise PhaseFailed(f"submit (a): counters {stats} against the "
                          f"plan's {len(plan.chunks)} chunks, "
                          f"{plan.merges} merges, {plan.splits} splits")
    if n_launch != len(plan.chunks):
        raise PhaseFailed(f"submit (a): {n_launch} search launches for "
                          f"{len(plan.chunks)} chunks")
    return dict(requests=len(futs),
                designs=sum(len(r[0]) for r in reqs) + 1,
                chunks=len(plan.chunks), merges=plan.merges,
                splits=plan.splits, shared_pad=plan.shared_pad,
                chunk_rows=[c.rows for c in plan.chunks],
                launches=n_launch, wall_s=wall, bit_equal=True)


def _load_stream(nets, boards, seed: int) -> list:
    """8 clients' request lists: interactive probes of 1-16 designs and
    batch-lane sweeps of 2,048-10,000, on both nets, ~100,000 designs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sweeps, total = [], 0
    while total < SUBMIT_LOAD_DESIGNS - SUBMIT_CLIENTS \
            * SUBMIT_PROBES_PER_CLIENT * 8:
        size = int(rng.integers(SUBMIT_SWEEP_SIZES[0],
                                SUBMIT_SWEEP_SIZES[1] + 1))
        sweeps.append(("batch", len(sweeps) % 2, size,
                       int(rng.integers(0, SUBMIT_POOL - size + 1))))
        total += size
    clients = []
    for c in range(SUBMIT_CLIENTS):
        mine = sweeps[c::SUBMIT_CLIENTS]
        every = max(1, SUBMIT_PROBES_PER_CLIENT // (len(mine) + 1))
        seq = []
        for i in range(SUBMIT_PROBES_PER_CLIENT):
            if mine and i % every == 0:
                seq.append(mine.pop(0))
            size = int(rng.integers(1, 17))
            seq.append(("interactive", i % 2, size,
                        int(rng.integers(0, SUBMIT_POOL - size + 1))))
        seq += mine
        clients.append(seq)
    return clients


def _submit_load(ses, nets, boards, pools, want) -> dict:
    """(b): 8 client threads; probes wait for their result before the
    next, sweeps are collected at the end."""
    import threading
    import numpy as np
    from repro_torch.kernels import launches, reset_launches
    clients = _load_stream(nets, boards, SUBMIT_SEED)
    records, errors = [], []

    def client(seq):
        mine = []
        try:
            for lane, g, size, off in seq:
                rec = [lane, size, time.perf_counter(), None, g, off]
                f = ses.submit(pools[g][off:off + size], nets[g], boards[g],
                               priority=lane)
                f.add_done_callback(
                    lambda _, rec=rec: rec.__setitem__(3,
                                                       time.perf_counter()))
                mine.append((f, rec))
                if lane == "interactive":
                    f.result(timeout=600)
            for f, _ in mine:
                f.result(timeout=600)
        except Exception as e:  # noqa: BLE001 — reported by the phase
            errors.append(repr(e))
        records.extend(mine)

    before = {k: getattr(ses.stats, k) for k in SUBMIT_COUNTERS}
    reset_launches()
    with _MegabatchProbe() as probe:
        threads = [threading.Thread(target=client, args=(seq,))
                   for seq in clients]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
    n_launch = launches()["parallelism_search"]
    if errors or any(t.is_alive() for t in threads):
        raise PhaseFailed(f"submit (b): client errors {errors[:3]}")
    if n_launch == 0:
        raise PhaseFailed("submit (b): the drain launched no search kernel")
    stats = {k: getattr(ses.stats, k) - before[k] for k in SUBMIT_COUNTERS}
    wrong = 0
    for f, (lane, size, _, _, g, off) in records:
        out = f.result(timeout=0)
        if not _same_bits(out, {k: v[off:off + size]
                                for k, v in want[g].items()}):
            wrong += 1
    if wrong:
        raise PhaseFailed(f"submit (b): {wrong} results part from "
                          f"evaluate on the same specs")
    designs = sum(r[1] for _, r in records)
    lat = {lane: [r[3] - r[2] for _, r in records if r[0] == lane]
           for lane in ("interactive", "batch")}
    mb = probe.records
    return dict(clients=SUBMIT_CLIENTS, requests=len(records),
                designs=designs, wall_s=wall,
                us_per_design=wall / designs * 1e6,
                requests_per_s=len(records) / wall,
                latency={k: _quantiles(v) for k, v in lat.items()},
                counters=stats, launches=n_launch,
                megabatch_launches=[r["launches"] for r in mb],
                launches_per_megabatch=n_launch / max(len(mb), 1),
                padded_over_asked=sum(r["padded"] for r in mb)
                / max(sum(r["rows"] for r in mb), 1),
                megabatch_s=[r["s"] for r in mb],
                megabatch_rows=[r["rows"] for r in mb])


def _drain_profile(ses, nets, boards, pools) -> dict:
    """One drain (a 10,000-design sweep and 16 probes of each net) under
    torch.profiler: kernels, busy time and the idle share against the
    same drain's wall without the profiler."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    reqs = [(pools[0][:SUBMIT_SWEEP_SIZES[1]], 0)] \
        + [(pools[g][i:i + 4], g) for g in (0, 1) for i in range(16)]

    def one():
        futs = [ses.submit(specs, nets[g], boards[g]) for specs, g in reqs]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
    one()
    t0 = time.perf_counter()
    one()
    unprofiled = time.perf_counter() - t0
    before = ses.stats.megabatches
    reset_launches()
    prof = _device_profile(one, "submit")
    prof.pop("flash_fwd_share_of_busy", None)
    prof.update(designs=sum(len(s) for s, _ in reqs),
                megabatches=ses.stats.megabatches - before,
                search_kernel_launches=launches()["parallelism_search"],
                wall_s_unprofiled=unprofiled)
    if "device_busy_s" in prof:
        prof["device_idle_share"] = max(
            0.0, 1 - prof["device_busy_s"] / unprofiled)
    return prof


def _probe_stream(ses, net, board, spec, stop, n_max: int):
    """Probes of one design every SUBMIT_PROBE_EVERY_S until ``stop()``
    or ``n_max`` of them: each one's seconds from submit to result, and
    the results."""
    lat, futs = [], []
    t_next = time.perf_counter()
    while len(futs) < n_max and not stop():
        t0 = time.perf_counter()
        f = ses.submit([spec], net, board)
        f.add_done_callback(
            lambda _, t0=t0: lat.append(time.perf_counter() - t0))
        futs.append(f)
        t_next += SUBMIT_PROBE_EVERY_S
        time.sleep(max(0.0, t_next - time.perf_counter()))
    return lat, [f.result(timeout=600) for f in futs]


def _submit_lanes(ses, rnet, rboard) -> dict:
    """(c): a 100,000-design random sweep on the batch lane while a probe
    arrives every 5 ms; the job's designs against ``explore``'s."""
    import numpy as np
    from repro_torch.api import get_board, get_cnn
    from repro_torch.fpga.archs import make_arch
    net, board = get_cnn(DSE_CNN), get_board()
    spec = make_arch("segmented", rnet, TEMPLATE_NS[1])
    probe_want = ses.evaluate([spec], rnet, rboard)
    quiet, quiet_outs = _probe_stream(ses, rnet, rboard, spec,
                                      lambda: False, SUBMIT_QUIET_PROBES)
    t0 = time.perf_counter()
    job = ses.submit_search(net, n=DSE_BUDGET, dev=board,
                            seed=DSE_RANDOM_SEED)
    busy, busy_outs = _probe_stream(ses, rnet, rboard, spec, job.done,
                                    10 ** 6)
    res = job.result(timeout=900)
    job_s = time.perf_counter() - t0
    # the probes the drain served while the job thread launched the same
    # kernel: each equal to evaluate on its design, bit for bit
    wrong = sum(not _same_bits(out, probe_want)
                for out in quiet_outs + busy_outs)
    if wrong:
        raise PhaseFailed(f"submit (c): {wrong} of "
                          f"{len(quiet_outs) + len(busy_outs)} probes part "
                          f"from evaluate on the same design")
    want = ses.explore(net, n=DSE_BUDGET, dev=board, seed=DSE_RANDOM_SEED)
    if not all(np.array_equal(g, w) for g, w in
               zip(res.batch.to_numpy(), want.batch.to_numpy())):
        raise PhaseFailed("submit (c): the job's designs part from "
                          "explore's with the same seed")
    if not np.array_equal(res.front, want.front):
        raise PhaseFailed("submit (c): the job's front parts from "
                          "explore's")
    return dict(job=dict(cnn=DSE_CNN, board=board.name, n=DSE_BUDGET,
                         seed=DSE_RANDOM_SEED, wall_s=job_s,
                         seconds=res.seconds, explore_seconds=want.seconds,
                         designs_equal_explore=True),
                probe_every_ms=SUBMIT_PROBE_EVERY_S * 1e3,
                probes_without_job=_quantiles(quiet),
                probes_during_job=_quantiles(busy), probes_equal=True)


def _submit_failures(device, rnet, rboard) -> dict:
    """(d): deadline, admission, lifecycle and a fault in the drain."""
    from repro_torch.api import EvalError, Session
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    specs = [[make_arch(a, rnet, n)] for a in ARCH_NAMES
             for n in TEMPLATE_NS[:2]]
    codes = {}

    def code_of(fut):
        try:
            fut.result(timeout=600)
        except EvalError as e:
            return e.code
        return "ok"

    with Session(rboard, device=str(device)) as ses:
        codes["deadline"] = code_of(ses.submit(specs[0], rnet,
                                               deadline_s=0.001))
        codes["deadline_missed"] = ses.stats.deadline_missed
    with Session(rboard, device=str(device), max_queue=1,
                 linger_s=0.2) as ses:
        first = ses.submit(specs[0], rnet)
        try:
            ses.submit(specs[1], rnet)
            codes["queue"] = "accepted"
        except EvalError as e:
            codes["queue"] = e.code
        codes["queue_first"] = code_of(first)
        drain = ses._worker
    try:
        ses.submit(specs[0], rnet)
        codes["after_close"] = "accepted"
    except RuntimeError:
        codes["after_close"] = "RuntimeError"
    codes["threads_stopped"] = ses._worker is None \
        and not drain.is_alive()

    calls = {"cuda": 0, "plain": 0}
    real_plain = mccm_ops.parallelism_search_ref

    def hook(site, route):
        if route == "cuda":
            calls["cuda"] += 1
            raise RuntimeError("injected launch failure")

    def plain(*args):
        calls["plain"] += 1
        return real_plain(*args)

    prev = mccm_ops.set_fault_hook(hook)
    mccm_ops.parallelism_search_ref = plain
    try:
        with Session(rboard, device=str(device), max_retries=1,
                     linger_s=0.2) as ses:
            futs = [ses.submit(s, rnet) for s in specs]
            faults = [code_of(f) for f in futs]
            degraded, retried = ses.stats.degraded, ses.stats.retried
    finally:
        mccm_ops.set_fault_hook(prev)
        mccm_ops.parallelism_search_ref = real_plain
    codes.update(fault=faults, fault_kernel_calls=calls["cuda"],
                 plain_calls=calls["plain"], degraded=degraded,
                 retried=retried)
    want = dict(deadline=EvalError.DEADLINE_EXCEEDED, deadline_missed=1,
                queue=EvalError.QUEUE_FULL, queue_first="ok",
                after_close="RuntimeError", threads_stopped=True,
                fault=[EvalError.BACKEND_FAULT] * len(specs),
                fault_kernel_calls=2 * (1 + len(specs)), plain_calls=0,
                degraded=0, retried=1 + len(specs))
    bad = {k: (codes[k], v) for k, v in want.items() if codes[k] != v}
    if bad:
        raise PhaseFailed(f"submit (d): {bad}")
    return codes


def _trace_design(rng) -> str:
    """One notation string of ``benchmarks/serve_load.py``'s trace."""
    kind = rng.random()
    if kind < 0.5:
        return f"{{L1-Last:CE1-CE{rng.randint(1, 8)}}}"
    m = rng.randint(1, 8)
    a = rng.randint(1, 4)
    b = rng.randint(1, 4)
    return (f"{{L1-L{m}:CE1-CE{a}, "
            f"L{m + 1}-Last:CE{a + 1}-CE{a + b}}}")


def serve_trace(seed: int, n_requests: int) -> list:
    """``benchmarks/serve_load.py``'s ``make_trace``: ``n_requests``
    entries of ``{t, net, board, designs, priority}``, the same draws from
    ``random.Random(seed)``."""
    import random
    rng = random.Random(seed)
    t, trace = 0.0, []
    for _ in range(n_requests):
        t += rng.expovariate(1.0 / TRACE_MEAN_ARRIVAL_S)
        bulk = rng.random() < TRACE_BULK_FRACTION
        n = rng.randint(64, 96) if bulk else rng.randint(1, 4)
        trace.append({
            "t": round(t, 6),
            "net": rng.choice(TRACE_NETS),
            "board": rng.choice(TRACE_BOARDS),
            "designs": [_trace_design(rng) for _ in range(n)],
            "priority": "batch" if bulk else "interactive",
        })
    return trace


def _trace_session(device):
    """``benchmarks/serve_load.py``'s session settings: VCU110, linger 2 ms
    adaptive up to 20 ms."""
    from repro_torch.api import Session, get_board
    return Session(get_board("vcu110"), device=str(device),
                   linger_s=TRACE_LINGER_S, linger_max_s=TRACE_LINGER_MAX_S)


def _trace_warm(ses, trace, nets, boards) -> float:
    """``benchmarks/serve_load.py``'s warm-up: each net of the trace at
    the ladder's first sizes, each board once; returns its seconds."""
    import random
    warm_rng = random.Random(TRACE_SEED + 1)
    t0 = time.perf_counter()
    for name in sorted({e["net"] for e in trace}):
        for size in (1, 64, 128, 256):
            ses.evaluate([_trace_design(warm_rng) for _ in range(size)],
                         nets[name])
    for board in sorted({e["board"] for e in trace}):
        ses.evaluate(_trace_design(warm_rng), nets[trace[0]["net"]],
                     boards[board])
    return time.perf_counter() - t0


def _submit_trace(device) -> dict:
    """(e): ``benchmarks/serve_load.py``'s trace replayed on its arrival
    times through ``submit`` (in process; phase 15 (b) sends it over the
    socket server), with its session settings and warm-up, each result
    equal to ``evaluate``; then its 100k random ``submit_search`` and one
    deadline-bearing probe beside it."""
    from repro_torch.api import get_board, get_cnn
    trace = serve_trace(TRACE_SEED, TRACE_REQUESTS)
    nets = {n: get_cnn(n) for n in TRACE_NETS}
    boards = {b: get_board(b) for b in TRACE_BOARDS}
    lat = {}
    with _trace_session(device) as ses:
        warm_s = _trace_warm(ses, trace, nets, boards)
        before = {k: getattr(ses.stats, k) for k in SUBMIT_COUNTERS}
        futs = []
        with _MegabatchProbe() as probe:
            t0 = time.perf_counter()
            for i, e in enumerate(trace):
                now = time.perf_counter() - t0
                if e["t"] > now:
                    time.sleep(e["t"] - now)
                t_send = time.perf_counter()
                f = ses.submit(e["designs"], nets[e["net"]],
                               boards[e["board"]], priority=e["priority"])
                f.add_done_callback(
                    lambda _, i=i, t=t_send:
                    lat.__setitem__(i, time.perf_counter() - t))
                futs.append(f)
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        stats = {k: getattr(ses.stats, k) - before[k]
                 for k in SUBMIT_COUNTERS}
        parted = [i for i, e in enumerate(trace) if not _same_bits(
            outs[i], ses.evaluate(e["designs"], nets[e["net"]],
                                  boards[e["board"]]))]
        if parted:
            raise PhaseFailed(f"submit (e): requests {parted} part from "
                              f"evaluate on the same specs")
        probe_spec, probe_net, probe_board = \
            "{L1-Last:CE1-CE4}", nets["resnet50"], boards["zc706"]
        probe_want = ses.evaluate([probe_spec], probe_net, probe_board)
        job = ses.submit_search(nets["mobilenetv2"], DSE_BUDGET,
                                strategy="random", seed=TRACE_SEED)
        running = not job.done()
        t_probe = time.perf_counter()
        got = ses.submit(probe_spec, probe_net, probe_board,
                         deadline_s=TRACE_DEADLINE_S,
                         priority="interactive").result(timeout=600)
        probe_s = time.perf_counter() - t_probe
        t_dse = time.perf_counter()
        dse = job.result(timeout=900)
        dse_wait = time.perf_counter() - t_dse
    if any(got[k] != float(probe_want[k][0]) for k in probe_want):
        raise PhaseFailed("submit (e): the probe beside the job parts "
                          "from evaluate")
    if dse.n_evals != DSE_BUDGET:
        raise PhaseFailed(f"submit (e): the job scored {dse.n_evals} "
                          f"designs, not {DSE_BUDGET}")
    designs = sum(len(e["designs"]) for e in trace)
    mb = probe.records
    return dict(source="benchmarks/serve_load.py make_trace",
                seed=TRACE_SEED, requests=len(trace), designs=designs,
                batch_requests=sum(e["priority"] == "batch" for e in trace),
                warm_s=warm_s, wall_s=wall, designs_per_s=designs / wall,
                latency=_quantiles(list(lat.values())),
                latency_by_lane={lane: _quantiles(
                    [lat[i] for i, e in enumerate(trace)
                     if e["priority"] == lane])
                    for lane in ("interactive", "batch")},
                counters=stats, launches=sum(r["launches"] for r in mb),
                padded_over_asked=sum(r["padded"] for r in mb)
                / max(sum(r["rows"] for r in mb), 1),
                megabatch_ms=_quantiles([r["s"] for r in mb]),
                dse=dict(n=DSE_BUDGET, n_evals=dse.n_evals,
                         tail_wait_s=dse_wait, seconds=dse.seconds),
                interactive_under_dse=dict(
                    latency_s=probe_s, deadline_s=TRACE_DEADLINE_S,
                    met=probe_s < TRACE_DEADLINE_S,
                    dse_running_at_probe=running),
                bit_equal=True)


def phase_submit(card: str, device, us_per_design_phase4: float) -> dict:
    """The serving lane, ``Session.submit`` and ``submit_search``, on the
    card: equality, load, lanes and failure semantics."""
    import torch
    from repro_torch.api import Session, get_board, get_cnn
    t_phase = time.perf_counter()
    nets = (get_cnn("resnet50"), get_cnn("mobilenetv2"))
    boards = (get_board("zcu102"), get_board("zc706"))
    with Session(boards[0], device=str(device)) as ses:
        equality = _submit_equality(ses, nets, boards)
        pools = [_spec_pool(net, SUBMIT_POOL, SUBMIT_SEED + g)
                 for g, net in enumerate(nets)]
        want = [ses.evaluate(pools[g], nets[g], boards[g]) for g in (0, 1)]
        torch.cuda.synchronize()
        load = _submit_load(ses, nets, boards, pools, want)
        load["phase4_us_per_design"] = us_per_design_phase4
        load["profile"] = _drain_profile(ses, nets, boards, pools)
        lanes = _submit_lanes(ses, nets[0], boards[0])
        compile_stats = ses.compile_stats()
    failures = _submit_failures(device, nets[0], boards[0])
    trace = _submit_trace(device)
    info = dict(card=card, equality=equality, load=load, lanes=lanes,
                failures=failures, trace=trace, compile=compile_stats,
                phase_s=time.perf_counter() - t_phase)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "submit_megabatches.json"), "w") as f:
        json.dump({k: load.pop(k) for k in ("megabatch_launches",
                                            "megabatch_s",
                                            "megabatch_rows")}, f)
    emit("submit", **info)
    return info


# --------------------------------------------------------------------------
# phase 13
# --------------------------------------------------------------------------
def _artifact_diff(got: dict, want: dict, worst: dict) -> list:
    """Where an artifact (as a dict) parts from another: the composed
    floats beyond RTOL_METRICS, any other field not equal."""
    bad = []

    def close(g, w, where):
        rel = abs(g - w) / max(abs(w), 1e-30)
        worst[where] = max(worst.get(where, 0.0), rel)
        if rel > RTOL_METRICS:
            bad.append((where, g, w))

    if got.keys() != want.keys():
        return [("keys", sorted(got), sorted(want))]
    for k, w in want.items():
        if k in SCHED_TOP_CLOSE:
            close(got[k], w, k)
        elif k == "segments" and len(got[k]) == len(w):
            for gs, ws in zip(got[k], w):
                for f, v in ws.items():
                    if f in SCHED_SEG_CLOSE:
                        close(gs[f], v, f"segment.{f}")
                    elif gs.get(f) != v:
                        bad.append((f"segment.{f}", gs.get(f), v))
        elif got[k] != w:
            bad.append((k, "differs"))
    return bad


def _schedule_vs_golden(device) -> dict:
    """(a): every golden design through ``Session(board).schedule`` and
    through ``schedule_specs`` on the card, held to the JAX package's."""
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.core.notation import format_spec
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.schedule import build_artifact, schedule_specs

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_schedule.npz"))
    groups = sorted({tuple(k.split("/")[1:3]) for k in golden.files
                     if k.startswith("sched/")})
    sessions = {b: Session(get_board(b), device=str(device))
                for b in BOARD_NAMES}
    worst: dict = {}
    strict = untouched = designs = 0
    reset_launches()
    t0 = time.perf_counter()
    for cnn, board in groups:
        net, ses = get_cnn(cnn), sessions[board]
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        prefix = f"sched/{cnn}/{board}/"
        want = {k[len(prefix):]: golden[k] for k in golden.files
                if k.startswith(prefix)}
        out = schedule_specs(specs, net, ses.device_tables(),
                             tables=ses.tables(net))
        got = {k: v[:, :len(net)] if want[k].ndim == 2
               and v.shape[1] != want[k].shape[1] else v
               for k, v in out.items()}
        if sorted(got) != sorted(want):
            raise PhaseFailed(f"schedule (a) {cnn}/{board}: fields "
                              f"{sorted(set(got) ^ set(want))}")
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:
                raise PhaseFailed(f"schedule (a) {cnn}/{board}: {k} shape "
                                  f"{g.shape} != {w.shape}")
            if k in SCHED_EXACT:
                if not np.array_equal(g, w):
                    raise PhaseFailed(
                        f"schedule (a) {cnn}/{board}: {k} differs in "
                        f"{int((g != w).sum())} entries")
                continue
            if not np.isfinite(g).all():
                raise PhaseFailed(f"schedule (a) {cnn}/{board}: "
                                  f"non-finite {k}")
            rel = float((np.abs(g.astype(np.float64) - w)
                         / np.maximum(np.abs(w), 1e-30)).max())
            worst[k] = max(worst.get(k, 0.0), rel)
            if rel > RTOL_METRICS:
                raise PhaseFailed(f"schedule (a) {cnn}/{board}: {k} rel "
                                  f"err {rel} > {RTOL_METRICS}")
        lat, coarse = got["ref_latency_s"], got["coarse_latency_s"]
        if (lat > coarse).any():
            raise PhaseFailed(f"schedule (a) {cnn}/{board}: refined above "
                              f"coarse on {int((lat > coarse).sum())} rows")
        same = ~np.any((got["choice"] != 0) & got["valid_l"], axis=1)
        for k in ("latency_s", "throughput_ips", "access_bytes",
                  "buffer_bytes"):
            if not np.array_equal(got[f"ref_{k}"][same],
                                  got[f"coarse_{k}"][same]):
                raise PhaseFailed(f"schedule (a) {cnn}/{board}: ref_{k} "
                                  f"parts from coarse on an all-0 row")
        strict += int((lat < coarse).sum())
        untouched += int(same.sum())
        for i, spec in enumerate(specs):
            art = ses.schedule(spec, net)
            exp = build_artifact(want, i, net=net, board_name=board,
                                 design_repr=format_spec(spec, len(net)),
                                 wordbytes=get_board(board).wordbytes)
            bad = _artifact_diff(art.to_dict(), exp.to_dict(), worst)
            if bad:
                raise PhaseFailed(f"schedule (a) {cnn}/{board} design {i}: "
                                  f"artifact {bad[:3]}")
            designs += 1
    arts = 0
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        art = sessions["zc706"].schedule(make_arch("hybrid", net, 6), net)
        bad = _artifact_diff(json.loads(art.to_json()),
                             json.loads(str(golden[f"artifact/{cnn}"])),
                             worst)
        if bad:
            raise PhaseFailed(f"schedule (a) {cnn}: artifact parts from "
                              f"the golden JSON: {bad[:3]}")
        arts += 1
    n = launches()
    wall = time.perf_counter() - t0
    calls = designs + arts
    if n["parallelism_search"] < len(groups) + calls:
        raise PhaseFailed(f"schedule (a): {n['parallelism_search']} search "
                          f"launches for {len(groups)} schedule_specs calls "
                          f"and {calls} Session.schedule calls")
    for ses in sessions.values():
        ses.close()
    return dict(groups=len(groups), designs=designs, golden_artifacts=arts,
                launches=n, wall_s=wall, strictly_refined=strict,
                all_zero_rows=untouched, rtol=RTOL_METRICS,
                max_rel_err=worst)


def _schedule_plane(device, batch) -> dict:
    """(b): the card's plane against the CPU's, from one layer state."""
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.batch_eval import (LayerState, make_device_tables,
                                             make_tables)
    from repro_torch.schedule import coarse_state, plane_of_state

    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=device)
    dt = make_device_tables(board, device=device)
    part = batch.take(slice(0, SCHED_PLANE_DESIGNS)).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    m, st = coarse_state(part, t, dt)
    card = plane_of_state(t, dt, st, m.pipe_bool, m.valid_b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    plane_ms = cuda_ms(lambda: plane_of_state(t, dt, st, m.pipe_bool,
                                              m.valid_b), 5)
    host = plane_of_state(make_tables(net, device="cpu"),
                          make_device_tables(board, device="cpu"),
                          LayerState(*[x.cpu() for x in st]),
                          m.pipe_bool.cpu(), m.valid_b.cpu())
    if sorted(card) != sorted(host):
        raise PhaseFailed("schedule (b): the planes' fields differ")
    for k, h in host.items():
        c = card[k].cpu()
        if c.shape != h.shape or c.dtype != h.dtype \
                or not torch.equal(c, h):
            n = int((c != h).sum()) if c.shape == h.shape else -1
            raise PhaseFailed(f"schedule (b): {k} on the card parts from "
                              f"the CPU's in {n} entries")
    score = card["score"]
    valid = m.valid_b
    ties = (score == score[..., :1]).all(-1) & valid
    tie_choice = card["choice"][ties]
    if bool((tie_choice != 0).any()):
        raise PhaseFailed(f"schedule (b): {int((tie_choice != 0).sum())} "
                          f"all-tie layers did not choose candidate 0")
    return dict(cnn="resnet50", board="zcu102", designs=part.batch,
                layers_padded=t.max_L, candidates=score.shape[-1],
                fields=sorted(host), bit_equal=True,
                valid_layers=int(valid.sum()), all_tie_layers=int(
                    ties.sum()), all_tie_choice_0=True,
                refined_layers=int(((card["choice"] != 0) & valid).sum()),
                plane_ms=plane_ms, max_memory_allocated=peak)


def _schedule_single(device, seed: int) -> dict:
    """(c): use case 2, one design at a time: ``Session.schedule`` cold
    (a memo miss) and warm (a hit) on 64 designs across the CNNs."""
    import torch
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.core.notation import format_spec

    nets = [get_cnn(c) for c in CNN_NAMES]
    per = -(-(SCHED_SINGLE_DESIGNS + 1) // len(nets))
    pools = []
    for i, net in enumerate(nets):            # distinct designs a net
        seen = {}
        for spec in _spec_pool(net, 4 * per, seed + i):
            seen.setdefault(format_spec(spec, len(net)), spec)
        pools.append(list(seen.values())[:per])
    todo = [(nets[i % len(nets)], pools[i % len(nets)][i // len(nets)])
            for i in range(SCHED_SINGLE_DESIGNS + 1)]
    with Session(get_board(SCHED_SINGLE_BOARD), device=str(device)) as ses:
        for net in nets:                      # tables built outside timing
            ses.tables(net)
        ses.device_tables()
        cold, warm = [], []
        for net, spec in todo[:-1]:
            t0 = time.perf_counter()
            art = ses.schedule(spec, net)
            cold.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            again = ses.schedule(spec, net)
            warm.append(time.perf_counter() - t0)
            if again is not art or art.latency_s > art.coarse_latency_s:
                raise PhaseFailed("schedule (c): a warm call missed the "
                                  "memo or refined above coarse")
        stats = ses.stats.as_dict()
        if (stats["schedule_builds"], stats["schedule_hits"]) != (
                SCHED_SINGLE_DESIGNS, SCHED_SINGLE_DESIGNS):
            raise PhaseFailed(f"schedule (c): builds/hits {stats}")
        net, spec = todo[-1]
        torch.cuda.synchronize()
        prof = _device_profile(lambda: ses.schedule(spec, net),
                               "schedule_cold",
                               share_of="parallelism_search")
        cold_med = statistics.median(cold)
        if "device_busy_s" in prof:
            prof["device_idle_share"] = max(
                0.0, 1 - prof["device_busy_s"] / cold_med)
        compile_stats = ses.compile_stats()
    return dict(board=SCHED_SINGLE_BOARD, designs=SCHED_SINGLE_DESIGNS,
                cnns=len(nets), cold=_quantiles(cold), warm=_quantiles(warm),
                cold_median_s=cold_med, profile_cold=prof,
                compile=compile_stats)


def _schedule_front(device) -> dict:
    """(d): the 100k random sweep's front, refined."""
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn

    net = get_cnn(DSE_CNN)
    with Session(get_board(), device=str(device)) as ses:
        t0 = time.perf_counter()
        base = ses.explore(net, n=DSE_BUDGET, seed=DSE_RANDOM_SEED)
        base_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = ses.explore(net, n=DSE_BUDGET, seed=DSE_RANDOM_SEED,
                          refine="schedule")
        refined_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = ses._refine_front(base, net, None)
        refine_s = time.perf_counter() - t0
        board = ses.default_device.name
    if base.refined is not None or res.refined is None:
        raise PhaseFailed("schedule (d): refined is set on the wrong run")
    if not np.array_equal(res.front, base.front):
        raise PhaseFailed("schedule (d): the refined run's front parts")
    for a, b in zip(res.batch.to_numpy(), base.batch.to_numpy()):
        if not np.array_equal(a, b):
            raise PhaseFailed("schedule (d): the refined run's designs part")
    if not _same_bits(res.metrics, base.metrics):
        raise PhaseFailed("schedule (d): the refined run's metrics part")
    r = res.refined
    if not np.array_equal(r["coarse_latency_s"],
                          base.metrics["latency_s"][base.front]):
        raise PhaseFailed("schedule (d): refined coarse_latency_s parts "
                          "from the front rows' latency")
    if (r["latency_s"] > r["coarse_latency_s"]).any():
        raise PhaseFailed("schedule (d): refined above coarse")
    if not _same_bits(again, r):
        raise PhaseFailed("schedule (d): a second refine of the front "
                          "parts from the first")
    return dict(cnn=DSE_CNN, board=board, n=DSE_BUDGET,
                seed=DSE_RANDOM_SEED, front=int(res.front.size),
                explore_s=base_s, explore_refined_s=refined_s,
                refine_added_s=refined_s - base_s, refine_front_s=refine_s,
                strictly_refined=int((r["latency_s"]
                                      < r["coarse_latency_s"]).sum()),
                max_saving_frac=float(r["saving_frac"].max()),
                bit_equal=True)


def _schedule_full(device, batch, us_per_design_phase4: float) -> dict:
    """(e): ``schedule_specs`` at full width on phase 4's designs."""
    import numpy as np
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.batch_eval import (DEFAULT_CHUNK,
                                             make_device_tables, make_tables)
    from repro_torch.core.dse import decode_batch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.schedule import schedule_batch, schedule_specs

    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=device)
    dt = make_device_tables(board, device=device)
    specs = decode_batch(batch.take(slice(0, SCHED_FULL_DESIGNS)), len(net))
    chunks = -(-len(specs) // DEFAULT_CHUNK)
    schedule_specs(specs[:DEFAULT_CHUNK], net, dt, tables=t)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    out = schedule_specs(specs, net, dt, tables=t)
    wall = time.perf_counter() - t0
    n = launches()
    peak = torch.cuda.max_memory_allocated(device)
    if n["parallelism_search"] != chunks:
        raise PhaseFailed(f"schedule (e): {n['parallelism_search']} search "
                          f"launches for {chunks} chunks")
    for k, v in out.items():
        if v.shape[0] != len(specs) or not np.isfinite(
                v.astype(np.float64)).all():
            raise PhaseFailed(f"schedule (e): {k} has shape {v.shape} or "
                              f"non-finite values")
    lat, coarse = out["ref_latency_s"], out["coarse_latency_s"]
    if (lat > coarse).any():
        raise PhaseFailed("schedule (e): refined above coarse")
    # one chunk of the batch path's schedule twin under the profiler
    part = batch.take(slice(0, DEFAULT_CHUNK)).to(device)
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        schedule_batch(part, t, dt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    prof = _device_profile(lambda: schedule_batch(part, t, dt),
                           "schedule_chunk", share_of="parallelism_search")
    if "device_busy_s" in prof:
        prof["wall_s_unprofiled"] = statistics.median(walls)
        prof["device_idle_share"] = max(
            0.0, 1 - prof["device_busy_s"] / statistics.median(walls))
    return dict(cnn="resnet50", board="zcu102", designs=len(specs),
                cut_from=batch.batch, chunks=chunks, wall_s=wall,
                us_per_design=wall / len(specs) * 1e6,
                phase4_evaluate_us_per_design=us_per_design_phase4,
                launches=n, search_launches_per_chunk=n[
                    "parallelism_search"] / chunks,
                max_memory_allocated=peak,
                strictly_refined=int((lat < coarse).sum()),
                max_saving_frac=float((1 - lat / coarse).max()),
                chunk_profile=prof)


def _schedule_fault(device) -> dict:
    """(f): a scorer fault on the card ends in BACKEND_FAULT after the
    retries; the CPU route never runs."""
    from repro_torch.api import EvalError, Session, get_board, get_cnn
    from repro_torch.kernels.schedule_score import set_fault_hook

    calls = {"cuda": 0, "cpu": 0}

    def hook(site, route):
        calls[route] = calls.get(route, 0) + 1
        if route == "cuda":
            raise RuntimeError("injected scorer fault")

    net = get_cnn("resnet50")
    prev = set_fault_hook(hook)
    try:
        with Session(get_board("zcu102"), device=str(device),
                     max_retries=SCHED_FAULT_RETRIES) as ses:
            try:
                ses.schedule("{L1-Last:CE1-CE4}", net)
                code = "ok"
            except EvalError as e:
                code = e.code
            stats = ses.stats.as_dict()
            memo = ses.cache_stats()["schedule_artifacts"]["size"]
    finally:
        set_fault_hook(prev)
    got = dict(code=code, scorer_calls_cuda=calls["cuda"],
               plain_calls=calls["cpu"], retried=stats["retried"],
               degraded=stats["degraded"], memoized=memo)
    want = dict(code=EvalError.BACKEND_FAULT,
                scorer_calls_cuda=SCHED_FAULT_RETRIES + 1, plain_calls=0,
                retried=SCHED_FAULT_RETRIES, degraded=0, memoized=0)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise PhaseFailed(f"schedule (f): {bad}")
    return got


def phase_schedule(card: str, device, seed: int, n_designs: int,
                   us_per_design_phase4: float) -> dict:
    """The schedule layer on the card: against the golden file, the card's
    plane against the CPU's, use case 2 one design at a time, the DSE
    front refined, full width, and a fault."""
    import numpy as np
    from repro_torch.api import get_cnn
    from repro_torch.core.dse import sample_mixed

    t_phase = time.perf_counter()
    parts_s = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts_s[name] = time.perf_counter() - t0
        return out

    golden = part("a", _schedule_vs_golden, device)
    batch = sample_mixed(np.random.default_rng(seed),
                         len(get_cnn("resnet50")), n_designs)
    plane = part("b", _schedule_plane, device, batch)
    single = part("c", _schedule_single, device, seed)
    front = part("d", _schedule_front, device)
    full = part("e", _schedule_full, device, batch, us_per_design_phase4)
    fault = part("f", _schedule_fault, device)
    info = dict(card=card, golden=golden, plane=plane, single=single,
                front=front, full=full, fault=fault, parts_s=parts_s,
                phase_s=time.perf_counter() - t_phase)
    emit("schedule", **info)
    return info


# --------------------------------------------------------------------------
# phase 14
# --------------------------------------------------------------------------
def _multinet_golden() -> tuple:
    """The golden file and its configuration."""
    import numpy as np
    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_multinet.npz"))
    return golden, json.loads(str(golden["config"]))


def _multinet_check(got: dict, want: dict, label: str, worst: dict) -> None:
    """Discrete fields equal, the rest within RTOL_METRICS."""
    import numpy as np
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            raise PhaseFailed(f"{label}: {k} has shape {g.shape}, golden "
                              f"{w.shape}")
        if k in MULTINET_EXACT or w.dtype.kind in "biu":
            if not np.array_equal(g, w):
                raise PhaseFailed(f"{label}: {k} differs in "
                                  f"{int((g != w).sum())} entries")
            continue
        rel = np.abs(g.astype(np.float64) - w) / np.maximum(np.abs(w),
                                                            1e-30)
        worst[k] = max(worst.get(k, 0.0), float(rel.max()))
        if not (rel <= RTOL_METRICS).all():
            raise PhaseFailed(f"{label}: {k} rel err {float(rel.max())} "
                              f"> {RTOL_METRICS}")


def _multinet_eval_golden(device, golden, cfg) -> dict:
    """(a) ``joint_evaluate`` on the golden inputs, each mode."""
    import numpy as np
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.dse import MultiDesignBatch
    from repro_torch.core.multinet import joint_evaluate, make_multi_tables
    from repro_torch.kernels import launches, reset_launches
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    out, worst = {}, {}
    for mode, c in cfg["eval"].items():
        p = f"eval/{mode}"
        md = MultiDesignBatch.from_numpy(
            *(golden[f"{p}/in/{f}"] for f in fields), device=device)
        planes = {r: golden[f"{p}/in/{r}"]
                  for r in ("pes", "buf", "bw", "time", "assign")}
        if mode == "spatial":
            kw = dict(pes_shares=planes["pes"], buf_shares=planes["buf"],
                      bw_shares=planes["bw"])
        elif mode == "temporal":
            kw = dict(time_shares=planes["time"],
                      reconfig_s=c["reconfig_s"])
        else:
            kw = dict(assign=planes["assign"], pes_shares=planes["pes"],
                      buf_shares=planes["buf"], bw_shares=planes["bw"],
                      time_shares=planes["time"],
                      reconfig_s=c["reconfig_s"])
        mt = make_multi_tables([get_cnn(n) for n in c["nets"]],
                               weights=c["weights"], slo_s=c["slo_s"],
                               device=device)
        reset_launches()
        res = joint_evaluate(md, mt, get_board(c["board"]), mode=mode, **kw)
        got = {k: v.cpu().numpy() for k, v in res.items()}
        n = launches()["parallelism_search"]
        want = {k.rsplit("/", 1)[1]: golden[k] for k in golden.files
                if k.startswith(f"{p}/out/")}
        if set(got) != set(want):
            raise PhaseFailed(f"multinet (a) {mode}: keys "
                              f"{sorted(set(got) ^ set(want))}")
        _multinet_check(got, want, f"multinet (a) {mode}", worst)
        out[mode] = dict(models=len(c["nets"]), deployments=c["n"],
                         search_launches=n)
    out["max_rel_err"] = worst
    return out


def _multinet_deploy_golden(device, golden, cfg) -> dict:
    """(a) one ``Session.deploy`` per arm at the golden configurations."""
    import numpy as np
    from repro_torch.api import MultinetSearchConfig, Session, get_board, \
        get_cnn
    from repro_torch.kernels import launches, reset_launches
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    d = cfg["deploy"]
    out, worst = {}, {}
    ses = Session(get_board(d["board"]), device=str(device))
    for arm, c in d["arms"].items():
        nets = [get_cnn(n) for n in c["nets"]]
        reset_launches()
        if arm == "random":
            res = ses.deploy(nets, d["budget"], strategy="random",
                             seed=d["seed"], chunk=d["pop_size"])
        else:
            extra = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in c.items() if k != "nets"}
            res = ses.deploy(nets, d["budget"], strategy=arm,
                             config=MultinetSearchConfig(
                                 pop_size=d["pop_size"], seed=d["seed"],
                                 **extra))
        n = launches()["parallelism_search"]
        p = f"deploy/{arm}"
        same = np.ones(d["budget"], bool)
        for f, a in zip(fields, res.designs.to_numpy()):
            eq = golden[f"{p}/{f}"] == a
            same &= eq.reshape(len(eq), -1).all(1)
        pop = d["pop_size"]
        gens = [g for g in range(d["budget"] // pop)
                if not same[g * pop:(g + 1) * pop].all()]
        info = dict(models=len(nets), search_launches=n,
                    front=len(res.front),
                    multinet_diverged_at=gens[0] if gens else None)
        out[arm] = info
        if gens:
            raise PhaseFailed(f"multinet (a) deploy {arm}: designs part "
                              f"from the golden run at generation "
                              f"{gens[0]}")
        for k, v in res.shares.items():
            if not np.array_equal(v, golden[f"{p}/shares/{k}"]):
                raise PhaseFailed(f"multinet (a) deploy {arm}: shares {k} "
                                  f"differ")
        if not np.array_equal(res.front, golden[f"{p}/front"]):
            raise PhaseFailed(f"multinet (a) deploy {arm}: front "
                              f"{res.front.tolist()} != golden "
                              f"{golden[p + '/front'].tolist()}")
        _multinet_check({k: v[res.front] for k, v in res.metrics.items()},
                        {k: golden[f"{p}/front/{k}"] for k in res.metrics},
                        f"multinet (a) deploy {arm}", worst)
    ses.close()
    out["max_rel_err"] = worst
    return out


def _multinet_reductions(device, golden) -> dict:
    """(b) the JAX package's reductions, bit for bit on the card."""
    import numpy as np
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.core.batch_eval import evaluate_batch, make_tables
    from repro_torch.core.dse import (MultiDesignBatch, encode_specs,
                                      stack_designs)
    from repro_torch.core.multinet import joint_evaluate, make_multi_tables
    from repro_torch.core.multinet.joint_eval import PER_MODEL_KEYS
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    dev = get_board("vcu108")
    m1 = 0
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        db = encode_specs([make_arch(a, net, n) for a in ARCH_NAMES
                           for n in (2, 9)], len(net), device=device)
        single = evaluate_batch(db, make_tables(net, device=device), dev)
        out = joint_evaluate(stack_designs([db], 4), make_multi_tables(
            [net], device=device), dev)
        for k in PER_MODEL_KEYS:
            if not torch.equal(single[k], out[f"per_model_{k}"][:, 0]):
                raise PhaseFailed(f"multinet (b): M=1 spatial {cnn} {k} "
                                  f"differs from evaluate_batch")
        m1 += db.batch
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    md = MultiDesignBatch.from_numpy(
        *(golden[f"eval/spatial/in/{f}"] for f in fields), device=device)
    planes = {r: golden[f"eval/spatial/in/{r}"]
              for r in ("pes", "buf", "bw", "time")}
    mt = make_multi_tables([get_cnn(n) for n in MULTINET_PAIR],
                           device=device)
    board = get_board("zc706")
    sh = dict(pes_shares=planes["pes"], buf_shares=planes["buf"],
              bw_shares=planes["bw"])
    zeros = np.zeros((md.batch, 4), np.float32)
    ones = zeros.copy()
    ones[:, :2] = 1.0
    spatial = joint_evaluate(md, mt, board, **sh)
    hyb_s = joint_evaluate(md, mt, board, mode="hybrid", assign=zeros,
                           time_shares=planes["time"], **sh)
    temporal = joint_evaluate(md, mt, board, mode="temporal",
                              time_shares=planes["time"], reconfig_s=0.004)
    hyb_t = joint_evaluate(md, mt, board, mode="hybrid", assign=ones,
                           time_shares=planes["time"], reconfig_s=0.004,
                           **sh)
    for label, a_out, b_out, cols in (("all-spatial", spatial, hyb_s, 4),
                                      ("all-shared", temporal, hyb_t, 2)):
        for k, a in a_out.items():
            a, b = a, b_out[k]
            if a.dim() == 2:
                a, b = a[:, :cols], b[:, :cols]
            if not torch.equal(a, b):
                raise PhaseFailed(f"multinet (b): hybrid {label} {k} "
                                  f"differs")
    return dict(m1_designs=m1, m1_cnns=len(CNN_NAMES),
                hybrid_deployments=md.batch, bit_equal=True)


def _dominates(front, q) -> bool:
    return bool(((front <= q).all(1) & (front < q).any(1)).any())


def _multinet_studies(device) -> dict:
    """(c) the repo's two multinet studies through ``Session.deploy`` at
    their full budget, on the card."""
    import numpy as np
    from repro_torch.api import MultinetSearchConfig, Session, get_board, \
        get_cnn
    from repro_torch.core.dse.pareto import hypervolume_2d, knee_point
    from repro_torch.kernels import launches, reset_launches
    studies, checks = {}, {}
    for label, names, board, arms, extra in MULTINET_STUDIES:
        nets = [get_cnn(n) for n in names]
        ses = Session(get_board(board), device=str(device))
        res, per_arm = {}, {}
        for arm in arms:
            cfg = MultinetSearchConfig(pop_size=MULTINET_FULL_POP, seed=3,
                                       **extra)
            reset_launches()
            t0 = time.perf_counter()
            r = ses.deploy(nets, MULTINET_FULL_BUDGET, strategy=arm,
                           config=cfg)
            wall = time.perf_counter() - t0
            n = launches()["parallelism_search"]
            if n == 0:
                raise PhaseFailed(f"multinet (c) {label} {arm}: no search "
                                  f"kernel launched")
            for k, v in r.metrics.items():
                if v.shape[0] != MULTINET_FULL_BUDGET \
                        or not np.isfinite(v).all():
                    raise PhaseFailed(f"multinet (c) {label} {arm}: {k} "
                                      f"has shape {v.shape} or non-finite "
                                      f"values")
            res[arm] = r
            per_arm[arm] = dict(
                seconds=r.seconds, wall_s=wall, per_eval_us=r.per_eval_us,
                search_launches=n, front=len(r.front),
                generations=len(r.timings),
                breed_s=sum(t["breed_s"] for t in r.timings),
                step_s=sum(t["step_s"] for t in r.timings))
        ses.close()
        fronts = {a: r.front_points() for a, r in res.items()}
        allp = np.concatenate(list(fronts.values()))
        ref = allp.max(0) + 0.05 * np.maximum(np.ptp(allp, 0), 1e-9)
        for a in arms:
            per_arm[a]["hypervolume"] = hypervolume_2d(fronts[a], ref)
        study = dict(models=list(names), board=board, arms=per_arm,
                     hv_ref=ref.tolist())
        if "equal_split" in arms:
            sp = fronts["search"]
            for base in ("equal_split", "temporal"):
                checks[f"{label}:search_dominates_{base}_knee"] = \
                    _dominates(sp, knee_point(fronts[base]))
                checks[f"{label}:search_hv_beats_{base}"] = \
                    per_arm["search"]["hypervolume"] \
                    > per_arm[base]["hypervolume"]
            ep = fronts["equal_split"]
            weak = all(((sp <= q).all(1)).any() for q in ep)
            strict = any(_dominates(sp, q) for q in ep)
            study["search_weakly_dominates_equal_split"] = weak
            study["search_strictly_dominates_an_equal_split_point"] = strict
            if label == MULTINET_GATED_STUDY and not (
                    weak and strict and per_arm["search"]["hypervolume"]
                    > per_arm["equal_split"]["hypervolume"]):
                raise PhaseFailed(f"multinet (c) {label}: the searched "
                                  f"front does not dominate the "
                                  f"equal-split front")
        else:
            best = {a: float(-fronts[a][:, 0].min()) for a in arms}
            study["best_slo_attainment"] = best
            checks[f"{label}:hybrid_best_slo_ge_spatial"] = \
                best["hybrid"] >= best["search"] - 1e-9
            checks[f"{label}:hybrid_best_slo_ge_temporal"] = \
                best["hybrid"] >= best["temporal"] - 1e-9
        studies[label] = study
    return dict(budget=MULTINET_FULL_BUDGET, pop_size=MULTINET_FULL_POP,
                studies=studies, benchmark_checks=checks)


def _multinet_gate_points(device, seed: int) -> dict:
    """(d) ``benchmarks/perf_gate.py``'s two multinet points, B 1,024."""
    import numpy as np
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.dse import sample_assign, sample_mixed, \
        stack_designs
    from repro_torch.core.multinet import (joint_evaluate, make_multi_tables,
                                           sample_shares)
    from repro_torch.kernels import launches, reset_launches
    rng = np.random.default_rng(seed)
    board = get_board("zc706")
    B = MULTINET_GATE_B
    out = {}
    for label, names in (("multinet_m2", MULTINET_PAIR),
                         ("multinet_hybrid_m3", MULTINET_TRIO)):
        nets = [get_cnn(n) for n in names]
        m = len(nets)
        mt = make_multi_tables(nets, device=device)
        md = stack_designs([sample_mixed(rng, len(n), B) for n in nets],
                           4).to(device)
        sh = [sample_shares(rng, B, 4, m) for _ in range(4)]
        if m == 2:
            calls = [dict(pes_shares=sh[0], buf_shares=sh[1],
                          bw_shares=sh[2])]
        else:
            asg = sample_assign(rng, B, 4, m)
            shared = np.zeros_like(asg)
            shared[:, :m] = 1.0
            calls = [dict(mode="hybrid", assign=a, pes_shares=sh[0],
                          buf_shares=sh[1], bw_shares=sh[2],
                          time_shares=sh[3])
                     for a in (asg, np.zeros_like(asg), shared)]

        def run(kw):
            r = joint_evaluate(md, mt, board, **kw)
            r["worst_latency_s"].cpu()
        for kw in calls:
            run(kw)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(MULTINET_GATE_REPS):
            for kw in calls:
                run(kw)
        steady = (time.perf_counter() - t0) / (MULTINET_GATE_REPS
                                                * len(calls))
        n = launches()["parallelism_search"] / (MULTINET_GATE_REPS
                                                * len(calls))
        prof = _device_profile(lambda: run(calls[0]), label)
        prof.pop("flash_fwd_share_of_busy", None)
        if "device_busy_s" in prof:
            prof["device_idle_share"] = max(
                0.0, 1 - prof["device_busy_s"] / prof["wall_s_profiled"])
        out[label] = dict(B=B, models=m, assignments=len(calls),
                          steady_s=steady, us_per_deployment=steady / B * 1e6,
                          us_per_model_eval=steady / (B * m) * 1e6,
                          search_launches_per_call=n, profile=prof)
    return out


def _multinet_faults(device) -> dict:
    """(e) a search-kernel fault under ``deploy``, and ``submit_search``
    on a list of nets."""
    import numpy as np
    from repro_torch.api import (EvalError, MultinetSearchConfig, Session,
                                 get_board, get_cnn)
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    nets = [get_cnn(n) for n in MULTINET_PAIR]
    calls = {"cuda": 0, "plain": 0}
    real_plain = mccm_ops.parallelism_search_ref

    def hook(site, route):
        if route == "cuda":
            calls["cuda"] += 1
            raise RuntimeError("injected launch failure")

    def plain(*args):
        calls["plain"] += 1
        return real_plain(*args)

    cfg = MultinetSearchConfig(pop_size=256, seed=3)
    prev = mccm_ops.set_fault_hook(hook)
    mccm_ops.parallelism_search_ref = plain
    try:
        with Session(get_board("zc706"), device=str(device)) as ses:
            try:
                ses.deploy(nets, 512, config=cfg)
                code = "ok"
            except EvalError as e:
                code = e.code
            degraded = ses.stats.degraded
    finally:
        mccm_ops.set_fault_hook(prev)
        mccm_ops.parallelism_search_ref = real_plain
    got = dict(code=code, kernel_calls=calls["cuda"],
               plain_calls=calls["plain"], degraded=degraded)
    want = dict(code=EvalError.BACKEND_FAULT, kernel_calls=1,
                plain_calls=0, degraded=0)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise PhaseFailed(f"multinet (e): {bad}")
    with Session(get_board("zc706"), device=str(device)) as ses:
        want_r = ses.deploy(nets, 1024, config=cfg)
        got_r = ses.submit_search(nets, 1024, config=cfg).result(
            timeout=600)
    same = all(np.array_equal(a, b) for a, b in zip(
        got_r.designs.to_numpy(), want_r.designs.to_numpy())) \
        and np.array_equal(got_r.front, want_r.front) \
        and all(np.array_equal(got_r.metrics[k], v)
                for k, v in want_r.metrics.items())
    if not same:
        raise PhaseFailed("multinet (e): submit_search on a list of nets "
                          "differs from deploy")
    got["submit_search_equals_deploy"] = same
    return got


def phase_multinet(card: str, device, seed: int) -> dict:
    """Multinet co-scheduling on the card: against the golden file, the
    reductions, the repo's studies at full budget, perf_gate's points and
    the faults."""
    import torch
    t_phase = time.perf_counter()
    parts_s = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts_s[name] = time.perf_counter() - t0
        return out

    golden, cfg = _multinet_golden()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    evals = part("a_eval", _multinet_eval_golden, device, golden, cfg)
    deploys = part("a_deploy", _multinet_deploy_golden, device, golden, cfg)
    red = part("b", _multinet_reductions, device, golden)
    studies = part("c", _multinet_studies, device)
    gate = part("d", _multinet_gate_points, device, seed)
    faults = part("e", _multinet_faults, device)
    info = dict(card=card, golden_eval=evals, golden_deploy=deploys,
                reductions=red, studies=studies, gate=gate, faults=faults,
                max_memory_allocated=torch.cuda.max_memory_allocated(device),
                parts_s=parts_s, phase_s=time.perf_counter() - t_phase)
    emit("multinet", **info)
    return info


# --------------------------------------------------------------------------
# phase 15
# --------------------------------------------------------------------------
class _ReplyProbe:
    """Wraps the server's reply writers for a block: per writing thread
    (the session's drain or job thread, or a connection's reader), the
    replies, the seconds spent encoding and sending them, and the largest
    reply's bytes (counted after the clock stops)."""

    def __enter__(self):
        import json as _json
        import threading
        from repro_torch.serve import server as tserver
        self._cls, self.threads = tserver._Connection, {}
        real = self._real = (self._cls.reply, self._cls.fail)
        lock = threading.Lock()

        def timed(k):
            def writer(conn, rid, obj):
                t0 = time.perf_counter()
                real[k](conn, rid, obj)
                dt = time.perf_counter() - t0
                n = len(_json.dumps(tserver.jsonify(obj))) if k == 0 else 0
                name = threading.current_thread().name
                with lock:
                    r = self.threads.setdefault(
                        name, dict(replies=0, s=0.0, max_s=0.0,
                                   max_bytes=0))
                    r["replies"] += 1
                    r["s"] += dt
                    r["max_s"] = max(r["max_s"], dt)
                    r["max_bytes"] = max(r["max_bytes"], n)
            return writer
        self._cls.reply, self._cls.fail = timed(0), timed(1)
        return self

    def __exit__(self, *exc):
        self._cls.reply, self._cls.fail = self._real

    def summary(self) -> dict:
        t = self.threads
        return dict(by_thread=t,
                    max_reply_bytes=max((r["max_bytes"] for r in t.values()),
                                        default=0),
                    writer_s=sum(r["s"] for r in t.values()))


def _wire_same(got: dict, want: dict) -> bool:
    """A wire reply (lists of Python floats and ints) against local
    ``evaluate``'s arrays: the same keys, and each value bit for bit once
    cast back to the array's dtype."""
    import numpy as np
    return got.keys() == want.keys() and all(
        np.array_equal(np.asarray(got[k], np.asarray(w).dtype),
                       np.asarray(w)) for k, w in want.items())


def _same_summary(got: dict, want: dict) -> bool:
    """A wire summary against ``summarize_search`` of the local call: every
    field but the host clocks equal (front exact, floats bit for bit)."""
    skip = ("seconds", "per_design_us", "per_eval_us")
    return {k: v for k, v in got.items() if k not in skip} \
        == {k: v for k, v in want.items() if k not in skip}


def _wire_ops(device) -> dict:
    """(a): every op over loopback on a warmed card session (MobileNetV2
    / ZC706, as tests/test_serve_server.py), each reply equal to the same
    local call; search launches a request equal to the local call's."""
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.notation import format_spec
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve import EvalServer, ServeClient, summarize_search
    net = get_cnn(WIRE_NET)
    specs = [format_spec(s, len(net))
             for s in _spec_pool(net, max(WIRE_SWEEPS), SUBMIT_SEED)]
    out, bad = {}, []

    def counted(fn):
        reset_launches()
        t0 = time.perf_counter()
        r = fn()
        return r, launches()["parallelism_search"], time.perf_counter() - t0

    with Session(get_board(WIRE_BOARD), device=str(device),
                 linger_s=0.005) as ses:
        ses.evaluate([WIRE_SPEC], net)
        with EvalServer(ses) as srv, ServeClient(*srv.address) as cli, \
                _MegabatchProbe() as mb, _ReplyProbe() as rp:
            if cli.ping() != {"pong": True}:
                bad.append("ping")
            obs = cli.observability()
            if not {"compile", "stats", "caches", "breaker"} <= obs.keys():
                bad.append("observability")
            got, n, wall = counted(lambda: cli.evaluate(WIRE_SPEC, WIRE_NET))
            want = ses.evaluate([WIRE_SPEC], net)
            if got != {k: float(v[0]) for k, v in want.items()}:
                bad.append("scalar evaluate")
            out["scalar"] = dict(launches=n, wall_s=wall)
            for size in WIRE_SWEEPS:
                chunks = sum(r["chunks"] for r in mb.records)
                got, n, wall = counted(
                    lambda: cli.evaluate(specs[:size], WIRE_NET))
                chunks = sum(r["chunks"] for r in mb.records) - chunks
                if not _wire_same(got, ses.evaluate(specs[:size], net)):
                    bad.append(f"evaluate {size}")
                if n != chunks or n == 0:
                    bad.append(f"evaluate {size}: {n} launches, {chunks} "
                               f"chunks")
                out[f"evaluate_{size}"] = dict(launches=n, chunks=chunks,
                                               wall_s=wall)
            for label, kw in (("explore_random", dict(strategy="random",
                                                      seed=DSE_RANDOM_SEED)),
                              ("explore_search", dict(strategy="search",
                                                      seed=DSE_SEARCH_SEED))):
                got, n, wall = counted(
                    lambda: cli.explore(WIRE_NET, n=WIRE_EXPLORE_N, **kw))
                want, n_local, _ = counted(
                    lambda: ses.explore(net, WIRE_EXPLORE_N, **kw))
                if not _same_summary(got, summarize_search(want)):
                    bad.append(label)
                if n != n_local or n == 0:
                    bad.append(f"{label}: {n} launches, {n_local} local")
                out[label] = dict(n=WIRE_EXPLORE_N, launches=n,
                                  front=got["front_size"], wall_s=wall,
                                  seconds=got["seconds"])
            pair = [get_cnn(m) for m in WIRE_DEPLOY]
            got, n, wall = counted(lambda: cli.deploy(
                list(WIRE_DEPLOY), n=WIRE_DEPLOY_N, seed=DSE_SEARCH_SEED))
            want, n_local, _ = counted(lambda: ses.deploy(
                pair, WIRE_DEPLOY_N, seed=DSE_SEARCH_SEED))
            if not _same_summary(got, summarize_search(want)):
                bad.append("deploy")
            if n != n_local or n == 0:
                bad.append(f"deploy: {n} launches, {n_local} local")
            out["deploy"] = dict(nets=list(WIRE_DEPLOY), n=WIRE_DEPLOY_N,
                                 launches=n, front=got["front_size"],
                                 wall_s=wall)
            served = srv.requests_served
    if bad:
        raise PhaseFailed(f"wire (a): {bad}")
    out.update(requests_served=served, replies=rp.summary())
    return out


def _wire_trace(device, in_process: dict) -> dict:
    """(b): ``benchmarks/serve_load.py``'s trace sent over one pipelined
    ``ServeClient`` connection on its arrival times, with its session
    settings and warm-up, each reply equal to ``evaluate``; then its 100k
    random explore over the wire and one deadline-bearing probe beside
    it.  Phase 12 (e)'s in-process figures from this run beside."""
    from repro_torch.api import get_board, get_cnn
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve import EvalServer, ServeClient
    trace = serve_trace(TRACE_SEED, TRACE_REQUESTS)
    nets = {n: get_cnn(n) for n in TRACE_NETS}
    boards = {b: get_board(b) for b in TRACE_BOARDS}
    lat = {}
    with _trace_session(device) as ses:
        warm_s = _trace_warm(ses, trace, nets, boards)
        with EvalServer(ses) as srv, ServeClient(*srv.address) as cli, \
                _ReplyProbe() as rp:
            reset_launches()
            futs = []
            t0 = time.perf_counter()
            for i, e in enumerate(trace):
                now = time.perf_counter() - t0
                if e["t"] > now:
                    time.sleep(e["t"] - now)
                t_send = time.perf_counter()
                f = cli.evaluate_async(e["designs"], e["net"],
                                       board=e["board"],
                                       priority=e["priority"])
                f.add_done_callback(
                    lambda _, i=i, t=t_send:
                    lat.__setitem__(i, time.perf_counter() - t))
                futs.append(f)
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            n_launch = launches()["parallelism_search"]
            replies = rp.summary()
            parted = [i for i, e in enumerate(trace) if not _wire_same(
                outs[i], ses.evaluate(e["designs"], nets[e["net"]],
                                      boards[e["board"]]))]
            if parted:
                raise PhaseFailed(f"wire (b): requests {parted} part from "
                                  f"evaluate on the same specs")
            probe_want = ses.evaluate([WIRE_SPEC], nets["resnet50"],
                                      boards["zc706"])
            reset_launches()
            job = cli.request_async("explore", net="mobilenetv2",
                                    n=DSE_BUDGET, strategy="random",
                                    seed=TRACE_SEED)
            t_probe = time.perf_counter()
            got = cli.evaluate(WIRE_SPEC, "resnet50", board="zc706",
                               deadline_s=TRACE_DEADLINE_S,
                               priority="interactive")
            probe_s = time.perf_counter() - t_probe
            running = not job.done()
            dse = job.result(timeout=900)
            job_launches = launches()["parallelism_search"]
    if got != {k: float(v[0]) for k, v in probe_want.items()}:
        raise PhaseFailed("wire (b): the probe beside the job parts from "
                          "evaluate")
    if dse["n_evals"] != DSE_BUDGET or not dse["front_size"]:
        raise PhaseFailed(f"wire (b): the job scored {dse['n_evals']} "
                          f"designs, front {dse['front_size']}")
    if n_launch == 0 or job_launches == 0:
        raise PhaseFailed("wire (b): no search kernel launched")
    designs = sum(len(e["designs"]) for e in trace)
    return dict(source="benchmarks/serve_load.py make_trace",
                seed=TRACE_SEED, requests=len(trace), designs=designs,
                warm_s=warm_s, wall_s=wall, designs_per_s=designs / wall,
                latency=_quantiles(list(lat.values())),
                latency_by_lane={lane: _quantiles(
                    [lat[i] for i, e in enumerate(trace)
                     if e["priority"] == lane])
                    for lane in ("interactive", "batch")},
                launches=n_launch, replies=replies,
                in_process=dict(latency=in_process["latency"],
                                latency_by_lane=in_process["latency_by_lane"],
                                designs_per_s=in_process["designs_per_s"]),
                dse=dict(n=DSE_BUDGET, n_evals=dse["n_evals"],
                         front=dse["front_size"], seconds=dse["seconds"],
                         launches=job_launches),
                interactive_under_dse=dict(
                    latency_s=probe_s, deadline_s=TRACE_DEADLINE_S,
                    met=probe_s < TRACE_DEADLINE_S,
                    dse_running_at_probe=running),
                bit_equal=True)


def _wire_failures(device) -> dict:
    """(c): the taxonomy over the wire: bad lines, deadlines, admission, a
    client-side timeout, a kernel fault in the drain and a drained
    shutdown."""
    import socket
    from repro_torch.api import EvalError, Session, get_board, get_cnn
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.core.notation import format_spec
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    from repro_torch.serve import EvalServer, ServeClient
    net = get_cnn(WIRE_NET)
    specs = [format_spec(make_arch(a, net, n), len(net))
             for a in ARCH_NAMES for n in TEMPLATE_NS[:2]]
    codes = {}

    def code_of(call):
        try:
            call()
        except EvalError as e:
            return e.code
        return "ok"

    def server(**kw):
        ses = Session(get_board(WIRE_BOARD), device=str(device), **kw)
        return ses, EvalServer(ses).start()

    ses, srv = server(linger_s=0.005)
    with ses, ServeClient(*srv.address) as cli:
        with socket.create_connection(srv.address, timeout=60) as s:
            f = s.makefile("rw", encoding="utf-8")
            f.write("this is not json\n")
            f.flush()
            codes["malformed"] = json.loads(f.readline())["error"]["code"]
            f.write(json.dumps({"id": 1, "op": "ping"}) + "\n")
            f.flush()
            codes["malformed_then_ping"] = json.loads(f.readline())["ok"]
        for label, op, kw in (
                ("unknown_op", "warp_drive", {}),
                ("unknown_net", "evaluate", dict(designs=specs[:1],
                                                 net="nope")),
                ("unknown_board", "evaluate", dict(designs=specs[:1],
                                                   net=WIRE_NET,
                                                   board="nope"))):
            codes[label] = code_of(lambda: cli.request(op, **kw))
        codes["then_ping"] = cli.ping() == {"pong": True}
        srv.stop()
    ses, srv = server(linger_s=0.05)
    with ses, ServeClient(*srv.address) as cli:
        codes["deadline"] = code_of(
            lambda: cli.evaluate(specs[0], WIRE_NET, deadline_s=0.001))
        srv.stop()
    ses, srv = server(linger_s=0.5, max_queue=1)
    with ses, ServeClient(*srv.address) as cli:
        first = cli.evaluate_async(specs[0], WIRE_NET)
        time.sleep(0.1)
        codes["queue"] = code_of(lambda: cli.evaluate(specs[1], WIRE_NET))
        codes["queue_first"] = code_of(lambda: first.result(timeout=600))
        srv.stop()
    ses, srv = server(linger_s=0.5)
    with ses, ServeClient(*srv.address) as cli:
        codes["client_timeout"] = code_of(
            lambda: cli.evaluate(specs[0], WIRE_NET, timeout_s=0.01))
        with cli._plock:
            codes["abandoned"] = not cli._pending
        codes["after_timeout"] = code_of(
            lambda: cli.evaluate(specs[0], WIRE_NET, timeout_s=600))
        srv.stop()

    calls = {"cuda": 0, "plain": 0}
    real_plain = mccm_ops.parallelism_search_ref

    def hook(site, route):
        if route == "cuda":
            calls["cuda"] += 1
            raise RuntimeError("injected launch failure")

    def plain(*args):
        calls["plain"] += 1
        return real_plain(*args)

    prev = mccm_ops.set_fault_hook(hook)
    mccm_ops.parallelism_search_ref = plain
    try:
        ses, srv = server(max_retries=1, linger_s=0.2)
        with ses, ServeClient(*srv.address) as cli:
            futs = [cli.evaluate_async([s], WIRE_NET) for s in specs]
            faults = [code_of(lambda f=f: f.result(timeout=600))
                      for f in futs]
            degraded = ses.stats.degraded
            srv.stop()
    finally:
        mccm_ops.set_fault_hook(prev)
        mccm_ops.parallelism_search_ref = real_plain
    codes.update(fault=faults, fault_plain_calls=calls["plain"],
                 fault_kernel_calls=calls["cuda"], degraded=degraded)

    ses, srv = server(linger_s=0.3)
    with ses:
        ses.evaluate(specs, net)
        addr = srv.address
        with ServeClient(*addr) as cli:
            futs = [cli.evaluate_async([s], WIRE_NET) for s in specs]
            time.sleep(0.05)
            cli.shutdown(drain=True)
            outs = [f.result(timeout=600) for f in futs]
        want = [ses.evaluate([s], net) for s in specs]
        codes["shutdown_delivered"] = all(
            _wire_same(o, w) for o, w in zip(outs, want))
        time.sleep(0.3)
        try:
            socket.create_connection(addr, timeout=0.5).close()
            codes["listener_closed"] = False
        except OSError:
            codes["listener_closed"] = True
        srv.stop()
        srv.stop()
        codes["session_survives"] = _wire_same(
            {k: [v] for k, v in
             ses.submit(specs[0], net).result(timeout=600).items()},
            ses.evaluate(specs[:1], net))
    want = dict(malformed=EvalError.INVALID_INPUT, malformed_then_ping=True,
                unknown_op=EvalError.INVALID_INPUT,
                unknown_net=EvalError.INVALID_INPUT,
                unknown_board=EvalError.INVALID_INPUT, then_ping=True,
                deadline=EvalError.DEADLINE_EXCEEDED,
                queue=EvalError.QUEUE_FULL, queue_first="ok",
                client_timeout=EvalError.DEADLINE_EXCEEDED, abandoned=True,
                after_timeout="ok",
                fault=[EvalError.BACKEND_FAULT] * len(specs),
                fault_plain_calls=0, degraded=0, shutdown_delivered=True,
                listener_closed=True, session_survives=True)
    bad = {k: (codes[k], v) for k, v in want.items() if codes[k] != v}
    if bad or codes["fault_kernel_calls"] == 0:
        raise PhaseFailed(f"wire (c): {bad} {codes['fault_kernel_calls']}")
    return codes


def _island_plan(cfg: dict) -> tuple[list, int]:
    """Each generation's first row in an island search's evaluation
    order, then the budget; and its step calls, one an island and
    sub-round (the island loop's sizes: pop_n a generation and island,
    the final generation absorbing the remainder in sub-rounds of
    pop_n)."""
    I, budget = cfg["n_islands"], cfg["budget"]
    pop_n = min(cfg["pop_size"], max(budget // I, 1))
    gens = max(1, budget // (pop_n * I))
    last = pop_n + (budget - gens * pop_n * I + I - 1) // I
    steps = I * (gens - 1 + -(-last // pop_n))
    return [g * pop_n * I for g in range(gens)] + [budget], steps


def _islands_golden(device) -> dict:
    """(d): the island search on the card at golden_islands.npz's two
    configurations: every design, the fronts, island fronts, migrants and
    archive sizes exact, points and metrics within RTOL_METRICS."""
    import numpy as np
    from repro_torch.api import SearchConfig, get_board, get_cnn
    from repro_torch.core.dse.search import search
    from repro_torch.kernels import launches, reset_launches
    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_islands.npz"))
    cfgs = json.loads(str(golden["config"]))
    net = get_cnn(cfgs.pop("cnn"))
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    out, worst = {}, {}
    for run, c in sorted(cfgs.items()):
        reset_launches()
        res = search(net, get_board(), SearchConfig(**c), device=str(device))
        n_launch = launches()["parallelism_search"]
        same = np.ones(c["budget"], bool)
        for f, a in zip(fields, res.batch.to_numpy()):
            eq = golden[f"{run}/{f}"] == a
            same &= eq.reshape(len(eq), -1).all(1)
        starts, steps = _island_plan(c)
        parted = [g for g in range(len(starts) - 1)
                  if not same[starts[g]:starts[g + 1]].all()]
        diverged = parted[0] if parted else None
        hist = json.loads(str(golden[f"{run}/history"]))
        info = dict(config=c, launches=n_launch, step_calls=steps,
                    islands_diverged_at=diverged)
        if diverged is not None:
            row = starts[diverged] + int(np.argmin(
                same[starts[diverged]:starts[diverged + 1]]))
            info["first_parted_row"] = row
            raise PhaseFailed(f"islands (d) {run}: generation {diverged} "
                              f"parts from the golden run at row {row}: "
                              f"{info}")
        checks = {
            "front": np.array_equal(res.front_idx, golden[f"{run}/front"]),
            "island_fronts": len(res.island_fronts) == c["n_islands"]
            and all(np.array_equal(f, golden[f"{run}/island/{i}"])
                    for i, f in enumerate(res.island_fronts)),
            "migrants": [h["migrants"] for h in res.history]
            == [h["migrants"] for h in hist],
            "islands": [h["islands"] for h in res.history]
            == [h["islands"] for h in hist],
            "best_scalar_idx": res.history[-1]["best_scalar_idx"]
            == hist[-1]["best_scalar_idx"],
            "one_launch_a_step": n_launch == steps}
        if not all(checks.values()):
            raise PhaseFailed(f"islands (d) {run}: {checks}")
        _check_metrics({"points": res.points.ravel(), **res.metrics},
                       {f"{run}/points": golden[f"{run}/points"].ravel(),
                        **{f"{run}/{k}": golden[f"{run}/metric/{k}"]
                           for k in res.metrics}},
                       run, worst)
        info.update(front=len(res.front_idx),
                    island_fronts=[len(f) for f in res.island_fronts],
                    migrants=[h["migrants"] for h in res.history],
                    seconds=res.seconds)
        out[run] = info
    out["rtol"] = RTOL_METRICS
    out["max_rel_err"] = worst
    return out


def _islands_full(device, serial: dict) -> dict:
    """(e): the island model at the paper's budget through
    ``Session.explore``, beside phase 11's serial search from this run;
    deterministic; then configuration B killed after its second snapshot
    and resumed, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.api import (SearchConfig, Session, get_board, get_cnn,
                                 orient)
    from repro_torch.core import resilience
    from repro_torch.core.dse.search import search
    from repro_torch.kernels import launches, reset_launches
    net = get_cnn(DSE_CNN)
    cfg = SearchConfig(n_islands=ISLANDS_FULL, seed=DSE_SEARCH_SEED)
    runs = []
    with Session(get_board(), device=str(device)) as ses:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for _ in range(2):
            reset_launches()
            t0 = time.perf_counter()
            res = ses.explore(net, DSE_BUDGET, strategy="search", config=cfg)
            runs.append((res, time.perf_counter() - t0,
                         launches()["parallelism_search"]))
        peak = torch.cuda.max_memory_allocated(device)
    (res, wall, n_launch), (again, _, _) = runs
    pts = orient(res.metrics, DSE_OBJ)
    fp = pts[res.front]
    dominated = all((fp <= p).all(1).any()
                    for f in res.island_fronts for p in pts[f])
    migrants = sum(h["migrants"] for h in res.history)
    same = all(np.array_equal(a, b) for a, b in zip(
        res.batch.to_numpy(), again.batch.to_numpy())) \
        and all(np.array_equal(res.metrics[k], again.metrics[k])
                for k in res.metrics) \
        and np.array_equal(res.front, again.front) \
        and all(np.array_equal(a, b) for a, b in zip(res.island_fronts,
                                                      again.island_fronts))
    checks = dict(n_evals=res.n_evals == DSE_BUDGET,
                  island_fronts=len(res.island_fronts) == ISLANDS_FULL
                  and all(len(f) for f in res.island_fronts),
                  dominated=dominated, migrants=migrants > 0,
                  deterministic=same, launched=n_launch > 0)
    if not all(checks.values()):
        raise PhaseFailed(f"islands (e): {checks}")

    b = json.loads(str(np.load(os.path.join(
        ROOT, "src", "repro_torch", "data",
        "golden_islands.npz"))["config"]))["B"]
    path = os.path.join(OUT_DIR, "islands.ckpt")
    os.makedirs(OUT_DIR, exist_ok=True)
    board = get_board()
    plain = search(net, board, SearchConfig(**b), device=str(device))
    real, writes = resilience.save_checkpoint, []

    class Killed(BaseException):
        pass

    def save_twice_then_die(*args, **kwargs):
        real(*args, **kwargs)
        writes.append(args[1])
        if len(writes) == 2:
            raise Killed
    resilience.save_checkpoint = save_twice_then_die
    try:
        search(net, board, SearchConfig(**b, checkpoint_path=path,
                                        checkpoint_interval=1),
               device=str(device))
        killed = False
    except Killed:
        killed = True
    finally:
        resilience.save_checkpoint = real
    resumed = search(net, board, SearchConfig(**b, checkpoint_path=path,
                                              checkpoint_interval=1,
                                              resume=True),
                     device=str(device))
    os.remove(path)
    resume_same = killed and writes == ["dse-search-island"] * 2 \
        and all(np.array_equal(x, y) for x, y in zip(
            plain.batch.to_numpy(), resumed.batch.to_numpy())) \
        and np.array_equal(plain.points, resumed.points) \
        and all(np.array_equal(plain.metrics[k], resumed.metrics[k])
                for k in plain.metrics) \
        and np.array_equal(plain.front_idx, resumed.front_idx) \
        and plain.history == resumed.history \
        and all(np.array_equal(x, y) for x, y in zip(
            plain.island_fronts, resumed.island_fronts))
    if not resume_same:
        raise PhaseFailed("islands (e): the resumed run parts from the "
                          "uninterrupted one")
    return dict(cnn=DSE_CNN, budget=DSE_BUDGET, n_islands=ISLANDS_FULL,
                pop_size=cfg.pop_size, seed=DSE_SEARCH_SEED,
                seconds=res.seconds, wall_s=wall,
                per_design_us=res.per_design_us, launches=n_launch,
                generations=len(res.timings),
                breed_s=[t["breed_s"] for t in res.timings],
                step_s=[t["step_s"] for t in res.timings],
                front=len(res.front),
                island_fronts=[len(f) for f in res.island_fronts],
                migrants=migrants, max_memory_allocated=peak,
                serial=dict(per_design_us=serial["per_design_us"],
                            seconds=serial["seconds"],
                            launches=serial["launches"]
                            ["parallelism_search"],
                            generations=serial["generations"]),
                checks=checks, resume=dict(config=b, writes=len(writes),
                                           bit_equal=resume_same))


def phase_wire_islands(card: str, device, submit: dict, dse: dict) -> dict:
    """The socket server (``EvalServer``/``ServeClient``) and the serial
    island model on the card."""
    import torch
    t_phase = time.perf_counter()
    parts_s = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts_s[name] = time.perf_counter() - t0
        return out

    ops = part("a", _wire_ops, device)
    trace = part("b", _wire_trace, device, submit["trace"])
    failures = part("c", _wire_failures, device)
    golden = part("d", _islands_golden, device)
    full = part("e", _islands_full, device, dse["runs"]["search"])
    torch.cuda.synchronize()
    info = dict(card=card, ops=ops, trace=trace, failures=failures,
                islands_golden=golden, islands=full, parts_s=parts_s,
                phase_s=time.perf_counter() - t_phase)
    emit("wire_islands", **info)
    return info


# --------------------------------------------------------------------------
# phase 16
# --------------------------------------------------------------------------
class _AttnCapture:
    """While installed, the model code's chunked-attention calls run as
    they would and are recorded: each call's shapes and masks, and the
    q, k and v of the first call and of the first whose queries and keys
    differ in length (a cross-attention): the real inputs phase 16 holds
    the kernel to its plain version on."""

    def __init__(self):
        self.calls, self.kept = [], {}

    def __enter__(self):
        from repro_torch.models import layers as L
        self._L, inner = L, L.chunked_attention

        def capture(q, k, v, *, causal, window, q_offset=0, scale=None):
            cross = q.shape[1] != k.shape[1]
            self.calls.append(dict(Sq=q.shape[1], Sk=k.shape[1],
                                   causal=causal, window=window))
            for key in ("first",) + (("cross",) if cross else ()):
                self.kept.setdefault(key, dict(q=q, k=k, v=v, causal=causal,
                                               window=window))
            return inner(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)
        self._inner = inner
        L.chunked_attention = capture
        return self

    def __exit__(self, *exc):
        self._L.chunked_attention = self._inner


def _family_prompts(cfg, device, seed: int):
    """Phase 16's requests of a config: the prompts (phase 9's lengths, or
    8-512 decoder tokens for the enc-dec, the longest first) and the stub
    inputs made on the card from ``seed``: Whisper's 4096 frames, the
    VLM's patches."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lo, hi = ENCDEC_SERVE_LENS if cfg.family == "encdec" else SERVE_LENS
    lens = [hi] + rng.integers(lo, hi, SERVE_PROMPTS - 1).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    gen = torch.Generator(device=device).manual_seed(seed)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(
            SERVE_PROMPTS, ENCDEC_SERVE_FRAMES, cfg.frontend_dim,
            generator=gen, device=device).to(cfg.torch_dtype)
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(
            SERVE_PROMPTS, cfg.n_patches, cfg.frontend_dim, generator=gen,
            device=device).to(cfg.torch_dtype)
    return prompts, extra


def _padded(prompts, device):
    import torch
    Lp = max(map(len, prompts))
    toks = torch.zeros(len(prompts), Lp, dtype=torch.long, device=device)
    for i, p in enumerate(prompts):
        toks[i, Lp - len(p):] = torch.tensor(p, device=device)
    return toks


def _cross_decode_timing(c: dict) -> dict:
    """The kernel on a decode step's real cross-attention (Sq 1 over the
    encoder's keys): ms, plain ms, SDPA's ms (the yardstick only; the
    port never calls it) and the bound."""
    import torch.nn.functional as nnf
    from repro_torch.kernels.flash_attn import flash_attention, flash_fwd_ref
    q, k, v = c["q"], c["k"], c["v"]
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = dict(B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, D=D, dtype=str(q.dtype),
               ms=cuda_ms(lambda: flash_attention(q, k, v, causal=False),
                          50),
               plain_ms=cuda_ms(lambda: flash_fwd_ref(q, k, v, causal=False),
                                5),
               library_ms=cuda_ms(lambda: nnf.scaled_dot_product_attention(
                   qt, kt, vt, enable_gqa=True), 50),
               **_attn_cost(B, Sq, Sk, H, Hkv, D, False, None, q.dtype))
    return out


def _family_serve(device, arch: str, seed: int) -> dict:
    """Phase 16 (a) for one config at full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import copies, launches, reset_launches
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    cfg = get_config(arch)
    engine = ServeEngine(cfg, seed=seed, device=str(device))
    model = engine.api.init(torch.Generator(device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    prompts, extra = _family_prompts(cfg, device, seed)
    toks = _padded(prompts, device)
    enc_len = extra["frames"].shape[1] if "frames" in extra else 0
    want_pre, want_dec = flash_launches(cfg, toks.shape[1], enc_len)
    engine.generate(model, prompts, max_new_tokens=1,
                    extra_inputs=extra)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res = engine.generate(model, prompts, max_new_tokens=SERVE_NEW_TOKENS,
                          extra_inputs=extra)
    n_gen, c_gen = launches()["flash_fwd"], copies()["flash_fwd"]
    peak = torch.cuda.max_memory_allocated(device)
    if n_gen != want_pre + SERVE_NEW_TOKENS * want_dec or c_gen != 0:
        raise PhaseFailed(f"{arch}: generate launched flash_fwd {n_gen} "
                          f"times (want {want_pre} + {SERVE_NEW_TOKENS} x "
                          f"{want_dec}) and copied {c_gen} inputs")
    for i, t in enumerate(res.tokens):
        if len(t) != SERVE_NEW_TOKENS or not all(
                0 <= x < cfg.vocab_size for x in t):
            raise PhaseFailed(f"{arch} request {i}: tokens {t}")

    # launches a stage: one prefill, then one decode step, each alone
    batch = {"tokens": toks, **extra}
    with _AttnCapture() as pre_cap:
        reset_launches()
        logits, cache = engine.api.prefill(model, batch, engine.rt,
                                           max_len=toks.shape[1] + 2)
        torch.cuda.synchronize()
    n_pre, c_pre = launches()["flash_fwd"], copies()["flash_fwd"]
    with _AttnCapture() as dec_cap:
        reset_launches()
        step_logits, _ = engine.api.decode_step(
            model, cache, logits[:, -1].argmax(-1)[:, None], engine.rt)
        torch.cuda.synchronize()
    n_dec, c_dec = launches()["flash_fwd"], copies()["flash_fwd"]
    if (n_pre, n_dec, c_pre, c_dec) != (want_pre, want_dec, 0, 0):
        raise PhaseFailed(f"{arch}: flash_fwd launches {n_pre} in prefill "
                          f"(want {want_pre}), {n_dec} in a decode step "
                          f"(want {want_dec}); {c_pre} + {c_dec} copies")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(step_logits).all())):
        raise PhaseFailed(f"{arch}: non-finite logits")
    if logits.shape != (len(prompts), 1, cfg.padded_vocab):
        raise PhaseFailed(f"{arch}: prefill logits {tuple(logits.shape)}")
    tag = arch.split("-")[0]
    profile = {
        "prefill": _device_profile(lambda: engine.api.prefill(
            model, batch, engine.rt, max_len=toks.shape[1] + 2),
            f"family_{tag}_prefill"),
        "decode_step": _device_profile(lambda: engine.api.decode_step(
            model, cache, toks[:, -1:], engine.rt),
            f"family_{tag}_decode")}

    # the kernel against its plain version on the family's real q, k, v
    checks, cross_decode = {}, None
    cases = [("prefill_first", pre_cap.kept.get("first")),
             ("prefill_cross", pre_cap.kept.get("cross")),
             ("decode_cross", dec_cap.kept.get("cross"))]
    for label, c in cases:
        if c is None:
            continue
        err = _flash_vs_plain(c["q"], c["k"], c["v"], f"{arch} {label}",
                              causal=c["causal"], window=c["window"])
        checks[label] = dict(Sq=c["q"].shape[1], Sk=c["k"].shape[1],
                             H=c["q"].shape[2], Hkv=c["k"].shape[2],
                             D=c["q"].shape[3], causal=c["causal"],
                             dtype=str(c["q"].dtype), max_abs_err=err)
    if "decode_cross" in checks:
        cross_decode = _cross_decode_timing(dec_cap.kept["cross"])
    info = dict(
        arch=arch, family=cfg.family, dtype=cfg.dtype, params=n_params,
        prompt_lens=[len(p) for p in prompts], enc_frames=enc_len or None,
        patches=cfg.n_patches if cfg.family == "vlm" else None,
        new_tokens=SERVE_NEW_TOKENS, prefill_s=res.prefill_s,
        decode_s=res.decode_s, decode_steps=res.n_steps,
        decode_tokens_per_s=res.tokens_per_s, max_memory_allocated=peak,
        launches=dict(generate=n_gen, prefill=n_pre, decode_step=n_dec),
        flash_fwd_copies=dict(generate=c_gen, prefill=c_pre,
                              decode_step=c_dec),
        attention_calls=dict(prefill=pre_cap.calls[:2]
                             + pre_cap.calls[-1:], decode=dec_cap.calls[:1]),
        kernel_vs_plain=checks, tolerance=_flash_tolerance(cfg.torch_dtype),
        cross_decode=cross_decode, profile=profile,
        tokens_head=[t[:8] for t in res.tokens],
        family_s=time.perf_counter() - t0)
    del model, engine, cache, pre_cap, dec_cap, batch, extra
    torch.cuda.empty_cache()
    return info


def _families_golden(device) -> dict:
    """Phase 16 (b): ``golden_lm_families.npz`` on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import from_jax, unflatten
    from repro_torch.serve.engine import ServeEngine

    golden = np.load(GOLDEN_LM_FAMILIES)
    out = {}
    for arch in dict.fromkeys(k.split("/")[0] for k in golden.files):
        pre = arch + "/"
        cfg = get_config(arch).reduced().replace(
            dtype="float32", **json.loads(str(golden[pre + "overrides"])))
        model = from_jax(unflatten(golden, pre + "params/"), cfg,
                         device=device)
        engine = ServeEngine(cfg, device=str(device))
        new = int(golden[pre + "new_tokens"])
        rows = {}
        for batch in ("long", "short"):
            bp = f"{pre}{batch}/"
            n = int(golden[bp + "n_prompts"])
            prompts = [golden[f"{bp}prompt/{i}"].tolist() for i in range(n)]
            extra = {k: torch.from_numpy(golden[bp + k].astype(np.float32)
                                         ).to(device)
                     for k in ("frames", "patches") if bp + k in golden}
            toks = _padded(prompts, device)
            enc_len = extra["frames"].shape[1] if "frames" in extra else 0
            want_pre, want_dec = flash_launches(cfg, toks.shape[1], enc_len)
            reset_launches()
            res = engine.generate(model, prompts, max_new_tokens=new,
                                  extra_inputs=extra)
            n_flash = launches()["flash_fwd"]
            want = golden[bp + "tokens"].tolist()
            if res.tokens != want:
                raise PhaseFailed(f"golden {arch} {batch}: tokens "
                                  f"{res.tokens} != the JAX package's {want}")
            if n_flash != want_pre + new * want_dec:
                raise PhaseFailed(f"golden {arch} {batch}: {n_flash} "
                                  f"flash_fwd launches, want {want_pre} + "
                                  f"{new} x {want_dec}")
            logits, _ = engine.api.prefill(model, {"tokens": toks, **extra},
                                           engine.rt)
            err = float(np.abs(logits[:, -1].cpu().numpy()
                               - golden[bp + "last_logits"]).max())
            if err > LM_LOGITS_ATOL:
                raise PhaseFailed(f"golden {arch} {batch}: prefill logits "
                                  f"{err} from the JAX package's (> "
                                  f"{LM_LOGITS_ATOL})")
            rows[batch] = dict(prompt_lens=[len(p) for p in prompts],
                               enc_frames=enc_len or None, tokens_equal=True,
                               logits_max_abs_err=err, flash_launches=n_flash)
        out[arch] = rows
        del model, engine
    return out


def phase_families(card: str, device, seed: int) -> dict:
    """Phase 16: the LM families past dense at full width (a) and against
    the JAX package's goldens (b)."""
    t_phase = time.perf_counter()
    serve = {arch: _family_serve(device, arch, seed)
             for arch in FAMILY_SERVE}
    t_golden = time.perf_counter()
    golden = _families_golden(device)
    info = dict(card=card, seed=seed, serve=serve, golden=golden,
                logits_atol=LM_LOGITS_ATOL,
                golden_s=time.perf_counter() - t_golden,
                phase_s=time.perf_counter() - t_phase)
    emit("families", **info)
    return info


# --------------------------------------------------------------------------
# phase 17
# --------------------------------------------------------------------------
def train_flash_launches(cfg, rt, S: int, S_enc: int = 0) -> int:
    """``flash_fwd`` launches of one forward of ``cfg``'s loss under ``rt``
    (once more under remat's recompute) at sequence length ``S`` (the
    enc-dec: ``S_enc`` frames, ``S`` decoder tokens): a chunked call a
    layer (the hybrid: a call of its shared block; the enc-dec: an
    encoder layer and a decoder layer's self-attention, and its
    cross-attention past 2048 positions), where ``rt.attn_mode`` is
    ``chunked`` or ``auto`` past 2048 positions."""
    def chunked(n):
        return rt.attn_mode == "chunked" or (rt.attn_mode == "auto"
                                             and n > 2048)
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every) * chunked(S)
    if cfg.family == "encdec":
        return (cfg.n_enc_layers * chunked(S_enc)
                + cfg.n_dec_layers * (chunked(S) + (max(S, S_enc) > 2048)))
    if cfg.family == "vlm":
        S += cfg.n_patches
    return cfg.n_layers * chunked(S)


def _train_profile(fn, name: str, vocab: int, top: int = 10) -> dict:
    """One training step under torch.profiler (shapes recorded): the
    device's busy time, the shares of it of ``flash_fwd``, of the flash
    backward (the kernels launched under ``FlashAttentionBackward``), of
    the GEMMs with a vocab-long dim (the f32 unembedding, forward,
    recompute and backward) and of every op with a vocab-long dim (those
    GEMMs, the table's f32 widening and its gradient's cast), the top
    kernels, and the full table in chiprun_out/profile_<name>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=50))
    if busy_us == 0:
        return {"device_time": "not measured", "wall_s_profiled": wall}
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_fwd" in e.key)
    bwd_us = max([e.device_time_total for e in rows
                  if e.device_type == DeviceType.CPU
                  and "FlashAttentionBackward" in e.key] or [0])
    vocab_gemm_us = vocab_us = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or not any(
                vocab in shp for shp in (e.input_shapes or [])
                if isinstance(shp, (list, tuple))):
            continue
        vocab_us += e.self_device_time_total
        if e.key in ("aten::mm", "aten::addmm", "aten::bmm"):
            vocab_gemm_us += e.self_device_time_total
    return {"wall_s_profiled": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "flash_fwd_share_of_busy": flash_us / busy_us,
            "flash_backward_share_of_busy": bwd_us / busy_us,
            "vocab_gemm_share_of_busy": vocab_gemm_us / busy_us,
            "vocab_ops_share_of_busy": vocab_us / busy_us,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [
                {"kernel": e.key[:80], "device_ms":
                 e.self_device_time_total / 1e3, "calls": e.count}
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[
                                    :top]]}


def _train_full(device, seed: int) -> dict:
    """Phase 17 (a): Llama-3.2-1B trained at full width through the
    launcher's pieces (plan, optimizer, ``init_state``,
    ``make_train_step``, the ``Pipeline``)."""
    import math
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import Pipeline, synth_batch, to_device
    from repro_torch.kernels import copies, launches, reset_launches
    from repro_torch.launch.plans import default_plan
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k_cut", "train", TRAIN_S, TRAIN_B)
    plan = default_plan(cfg, SHAPES["train_4k"])
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=20, total_steps=100,
                         state_dtype=plan.opt_state_dtype,
                         factored=plan.opt_factored,
                         momentum=plan.opt_momentum)
    api, rt = get_model(cfg), plan.runtime()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = init_state(api, opt, torch.Generator(device=device).manual_seed(
        seed), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    step = make_train_step(api, rt, opt, device=device)
    pipe = Pipeline(cfg, shape, device=device, seed=seed)
    # a chunked call a layer in the forward, and again in remat's recompute
    want = train_flash_launches(cfg, rt, TRAIN_S) * (2 if rt.remat else 1)
    try:
        _, batch = next(pipe)
        state, m = step(state, batch)                          # warm-up
        torch.cuda.synchronize()
        warm = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        steps = []
        for _ in range(TRAIN_TIMED_STEPS):
            _, batch = next(pipe)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps.append(dict(step_s=dt, tokens_per_s=TRAIN_B * TRAIN_S / dt,
                              loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              flash_fwd=launches()["flash_fwd"],
                              copies=copies()["flash_fwd"]))
        peak = torch.cuda.max_memory_allocated(device)
        profile = _train_profile(lambda: step(state, batch), "train_step",
                                 cfg.padded_vocab)
    finally:
        pipe.close()
    bad = [s for s in steps if not (math.isfinite(s["loss"])
                                    and math.isfinite(s["grad_norm"]))]
    if bad or not math.isfinite(warm["loss"]):
        raise PhaseFailed(f"non-finite loss or grad_norm: {steps}")
    if any(s["flash_fwd"] != want or s["copies"] for s in steps):
        raise PhaseFailed(f"flash_fwd launches a step "
                          f"{[s['flash_fwd'] for s in steps]} (want {want}),"
                          f" copies {[s['copies'] for s in steps]} (want 0)")
    # one accum=2 step at twice the batch
    step2 = make_train_step(api, rt, opt, accum=2, device=device)
    big = to_device(synth_batch(cfg, shape, TRAIN_TIMED_STEPS + 2, seed=seed,
                                batch_override=TRAIN_ACCUM_B), device)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, m2 = step2(state, big)
    torch.cuda.synchronize()
    accum = dict(batch=TRAIN_ACCUM_B, accum=2,
                 step_s=time.perf_counter() - t0,
                 loss=float(m2["loss"]), grad_norm=float(m2["grad_norm"]),
                 flash_fwd=launches()["flash_fwd"])
    accum["tokens_per_s"] = TRAIN_ACCUM_B * TRAIN_S / accum["step_s"]
    if not (math.isfinite(accum["loss"]) and math.isfinite(
            accum["grad_norm"])) or accum["flash_fwd"] != 2 * want:
        raise PhaseFailed(f"accum=2 step: {accum} (want {2 * want} "
                          f"flash_fwd launches)")
    peak = max(peak, torch.cuda.max_memory_allocated(device))
    med = statistics.median(s["step_s"] for s in steps)
    if "device_busy_s" in profile:
        # the profiler's own cost doubles a step's wall: its busy time
        # against an unprofiled step says how busy the device is
        profile["device_busy_over_step_s"] = profile["device_busy_s"] / med
    out = dict(arch=cfg.name, dtype=cfg.dtype, params=n_params, seed=seed,
               batch=TRAIN_B, seq=TRAIN_S,
               cut="train_4k's global batch 256 cut to 4 (8 for accum=2)",
               plan=dict(remat=plan.remat, remat_group=plan.remat_group,
                         loss_chunk=plan.loss_chunk, accum=plan.accum,
                         opt_state_dtype=plan.opt_state_dtype),
               init_s=init_s, warmup=warm, steps=steps,
               step_s_median=med, tokens_per_s_median=TRAIN_B * TRAIN_S / med,
               flash_fwd_per_step_want=want, accum_step=accum,
               max_memory_allocated=peak, profile=profile)
    del state, step, step2, batch, big
    torch.cuda.empty_cache()
    return out


def _train_golden_case(arch: str, device) -> dict:
    """Phase 17 (b) for one arch of ``golden_train.npz``: the port's loss
    and gradients on the JAX package's params (read from the golden file
    the entry names), batch and runtime, against its values; on the card
    also the ``flash_fwd`` launches of the loss's forward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import flatten, from_jax, to_jax, \
        unflatten
    from repro_torch.models.registry import get_model
    from repro_torch.models.runtime import Runtime

    pre = arch + "/"
    with np.load(GOLDEN_TRAIN) as z:
        g = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    with np.load(os.path.join(os.path.dirname(GOLDEN_TRAIN),
                              str(g["params_file"]))) as z:
        params = unflatten({k: z[k] for k in z.files},
                           str(g["params_prefix"]))
    cfg = get_config(arch).reduced().replace(
        dtype="float32", **json.loads(str(g["overrides"])))
    rt = Runtime(**json.loads(str(g["runtime"])))
    model = from_jax(params, cfg, device=device).requires_grad_(True)
    batch = {k[len("batch/"):]: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in g.items() if k.startswith("batch/")}
    reset_launches()
    loss, metrics = get_model(cfg).loss(model, batch, rt)
    n_flash = launches()["flash_fwd"]
    names, ps = zip(*model.named_parameters())
    grads = flatten(to_jax(dict(zip(names, torch.autograd.grad(
        loss, ps, allow_unused=True, materialize_grads=True)))))
    want = {k[len("grads/"):]: v for k, v in g.items()
            if k.startswith("grads/")}
    if sorted(grads) != sorted(want):
        raise PhaseFailed(f"golden train {arch}: gradient leaves "
                          f"{sorted(grads.keys() ^ want.keys())} differ")
    # each leaf against its own scale (its largest |value|, no floor)
    excess, err, worst = -np.inf, -1.0, None
    for k, w in want.items():
        scale = float(np.abs(w).max(initial=0.0))
        d = np.abs(grads[k] - w)
        if float(d.max(initial=0.0)) / scale > err:
            err = float(d.max(initial=0.0)) / scale
            worst = dict(leaf=k, scale=scale, err=float(d.max()))
        excess = max(excess, float((d - TRAIN_GRAD_RTOL * np.abs(w)
                                    - TRAIN_GRAD_RTOL * scale).max(
                                        initial=-np.inf)))
    S_dec = batch["tokens"].shape[1]
    S_enc = batch["frames"].shape[1] if "frames" in batch else 0
    return dict(loss=loss.item(), loss_abs_err=abs(
        loss.item() - float(g["loss"])),
        nll_abs_err=abs(metrics["nll"].item() - float(g["nll"])),
        grad_leaves=len(want), grad_max_err_of_scale=err,
        grad_worst_leaf=worst, grad_excess=excess, runtime=json.loads(str(g["runtime"])),
        flash_launches=n_flash,
        flash_launches_want=train_flash_launches(cfg, rt, S_dec, S_enc))


def _train_golden(device) -> dict:
    """Phase 17 (b): every arch of ``golden_train.npz`` on the card."""
    import numpy as np
    with np.load(GOLDEN_TRAIN) as z:
        archs = list(dict.fromkeys(k.split("/")[0] for k in z.files))
    out = {}
    for arch in archs:
        r = _train_golden_case(arch, device)
        if r["loss_abs_err"] > TRAIN_LOSS_ATOL or r["grad_excess"] > 0 \
                or r["flash_launches"] != r["flash_launches_want"]:
            raise PhaseFailed(f"golden train {arch}: {r} (loss within "
                              f"{TRAIN_LOSS_ATOL}, gradients within "
                              f"{TRAIN_GRAD_RTOL} of each leaf's scale)")
        out[arch] = r
    return out


def _fn_case(device, dtype, seed: int) -> dict:
    """Phase 17 (c) in one dtype: the Function's gradients against
    autograd through the plain dense attention in f32 on the same inputs,
    and the forward+backward ms of both and of SDPA."""
    import torch
    import torch.nn.functional as nnf
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import layers as L
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)
    q = rnd(FN_B, FN_S, FN_H, FN_D).requires_grad_(True)
    k = rnd(FN_B, FN_S, FN_HKV, FN_D).requires_grad_(True)
    v = rnd(FN_B, FN_S, FN_HKV, FN_D).requires_grad_(True)
    dout = rnd(FN_B, FN_S, FN_H, FN_D)

    def fn_grads():
        out = L.chunked_attention(q, k, v, causal=True, window=None)
        return torch.autograd.grad(out, (q, k, v), dout)

    def dense_grads():
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        out = L.dense_attention(qf, kf, vf, causal=True, window=None)
        return torch.autograd.grad(out, (qf, kf, vf), dout.float())
    reset_launches()
    got = fn_grads()
    torch.cuda.synchronize()
    n_flash = launches()["flash_fwd"]
    want = dense_grads()
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != dtype or g.shape != w.shape \
                or not bool(torch.isfinite(g).all()):
            raise PhaseFailed(f"Function {dtype} {name}: {g.dtype} "
                              f"{tuple(g.shape)} or non-finite")
        scale = float(w.abs().max())
        errs[name] = float((g.float() - w).abs().max()) / scale
    del want
    tol = FN_TOL[str(dtype).removeprefix("torch.")]
    if max(errs.values()) > tol or n_flash != 1:
        raise PhaseFailed(f"Function {dtype}: errors {errs} of the dense "
                          f"reference's scale (> {tol}) or {n_flash} "
                          f"flash_fwd launches (want 1)")
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    dt_ = dout.transpose(1, 2)

    def sdpa():
        out = nnf.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dt_)
    return dict(dtype=str(dtype), max_err_of_scale=errs, tolerance=tol,
                fwd_bwd_ms=cuda_ms(fn_grads, 3),
                dense_fwd_bwd_ms=cuda_ms(dense_grads, 2),
                library_fwd_bwd_ms=cuda_ms(sdpa, 10))


def phase_train(card: str, device, seed: int) -> dict:
    """Phase 17: training on the card: (a) Llama-3.2-1B at full width,
    (b) the reduced families against ``golden_train.npz``, (c) the
    flash-attention Function at Llama's attention shape."""
    import torch
    t_phase = time.perf_counter()
    full = _train_full(device, seed)
    t_golden = time.perf_counter()
    golden = _train_golden(device)
    t_fn = time.perf_counter()
    fn = {str(dt).removeprefix("torch."): _fn_case(device, dt, seed)
          for dt in (torch.float32, torch.bfloat16)}
    info = dict(card=card, full=full, golden=golden,
                golden_tolerance=dict(loss_atol=TRAIN_LOSS_ATOL,
                                      grad_rtol_of_scale=TRAIN_GRAD_RTOL),
                function=dict(B=FN_B, S=FN_S, H=FN_H, Hkv=FN_HKV, D=FN_D,
                              causal=True, cases=fn),
                full_s=t_golden - t_phase, golden_s=t_fn - t_golden,
                function_s=time.perf_counter() - t_fn,
                phase_s=time.perf_counter() - t_phase)
    emit("train", **info)
    return info


# --------------------------------------------------------------------------
# phase 18
# --------------------------------------------------------------------------
def _spec_vs_card(device) -> dict:
    """Phase 18 (a): ``H100``'s SMs, shared memory a block and HBM
    capacity against what the card reports."""
    import torch
    props = torch.cuda.get_device_properties(device)
    card = dict(sms=props.multi_processor_count,
                smem_bytes_per_block=props.shared_memory_per_block_optin,
                hbm_capacity=props.total_memory)
    off = {k: (v, getattr(H100, k)) for k, v in card.items()
           if v != getattr(H100, k)}
    if off:
        raise PhaseFailed(f"H100 differs from the card (card, spec): {off}")
    return card


def _walked(fn, device) -> dict:
    """One call of ``fn`` under an ``OpWalk``; its counts, the census's top
    10, the hand kernels' charges (and ``flash_fwd``'s launches in the
    walk) and the 10 ops with the most FLOPs and the most bytes."""
    import torch
    from repro_torch.gpu.op_stats import fusion_count, op_census
    from repro_torch.gpu.op_walk import OpWalk
    from repro_torch.kernels import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with OpWalk() as walk:
        fn()
    torch.cuda.synchronize()
    c = walk.costs()
    return dict(walk=walk, walk_s=time.perf_counter() - t0,
                flash_launches=launches()["flash_fwd"], flops=c.flops,
                flops_by_dtype=c.flops_by_dtype, bytes=c.bytes_accessed,
                transcendentals=c.transcendentals,
                census_top10=op_census(walk, 10), charges=c.charges,
                fusion_count=fusion_count(walk),
                flops_by_op_top10=sorted(c.flops_by_op.items(),
                                         key=lambda kv: -kv[1])[:10],
                bytes_by_op_top10=sorted(c.bytes_by_op.items(),
                                         key=lambda kv: -kv[1])[:10])


def _timed(fn, reps: int) -> list[float]:
    """Host seconds of each of ``reps`` calls of ``fn``, each ending in a
    synchronize, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _step_cell(kind, shape_name, fn, cfg, plan, device, resident) -> dict:
    """Phase 18 (b) for one cell: timed steps, one walk, the estimate of
    the cut cell, Eq. 10's accuracies, the bounds, peak memory and the
    roofline of the record written to chiprun_out/roofline/."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.gpu.cost_model import estimate
    from repro_torch.roofline.analysis import (ART_DIR, analyze_cell,
                                               cell_record, dtype_bound_s)
    cut = dict(seq_len=STEP_S, global_batch=STEP_B)
    shape = dataclasses.replace(SHAPES[shape_name], **cut)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    steps = _timed(fn, STEP_TIMED)
    peak = torch.cuda.max_memory_allocated(device)
    w = _walked(fn, device)
    est = estimate(cfg, shape, plan)

    def acc(oracle, model):
        # Eq. 10, as benchmarks/tpu_model_accuracy.py computes it
        return 100.0 * (1.0 - abs(oracle - model) / oracle)
    cell = f"{cfg.name}__{shape_name}__1xH100"
    rec = cell_record(cell, cfg.name, shape_name, kind,
                      w.pop("walk").costs(),
                      {"argument_size_in_bytes": resident,
                       "temp_size_in_bytes": peak - resident,
                       "peak_memory_in_bytes": peak},
                      plan=dataclasses.asdict(plan), shape_cut=cut)
    os.makedirs(ART_DIR, exist_ok=True)
    with open(os.path.join(ART_DIR, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    roof = analyze_cell(rec)
    med = statistics.median(steps)
    return dict(
        cell=cell, batch=STEP_B, seq=STEP_S, steps_s=steps, step_s=med,
        **w,
        estimate=dict(flops=est.flops, useful_flops=est.useful_flops,
                      hbm_bytes=est.hbm_bytes, compute_s=est.compute_s,
                      memory_s=est.memory_s, dominant=est.dominant(),
                      fits=est.fits,
                      hbm_capacity_bytes=est.hbm_capacity_bytes,
                      mxu_utilization=est.mxu_utilization),
        eq10_accuracy=dict(flops=acc(w["flops"], est.useful_flops),
                           hbm=acc(w["bytes"], est.hbm_bytes)),
        dtype_bound_s=dtype_bound_s(w["flops_by_dtype"]),
        dtype_bound_over_step=dtype_bound_s(w["flops_by_dtype"]) / med,
        max_memory_allocated=peak, resident_bytes=resident,
        roofline=dict(compute_s=roof.compute_s, memory_s=roof.memory_s,
                      collective_s=roof.collective_s,
                      dominant=roof.dominant, model_flops=roof.model_flops,
                      useful_ratio=roof.useful_ratio,
                      peak_fraction=roof.peak_fraction,
                      recommendation=roof.recommendation))


def _step_cells(device, seed: int):
    """Phase 18 (b): the three Llama-3.2-1B cells; returns them, and what
    (d) reuses: the config, the train state, the optimizer and a batch."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.launch.plans import default_plan
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    api = get_model(cfg)
    plans = {name: default_plan(cfg, SHAPES[name])
             for _, name in STEP_CELLS}
    tplan = plans["train_4k"]
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=20, total_steps=100,
                         state_dtype=tplan.opt_state_dtype,
                         factored=tplan.opt_factored,
                         momentum=tplan.opt_momentum)
    state = init_state(api, opt, torch.Generator(device=device).manual_seed(
        seed), device=device)
    step = make_train_step(api, tplan.runtime(), opt, device=device)
    batch = to_device(synth_batch(cfg, ShapeSpec("train_4k_cut", "train",
                                                 STEP_S, STEP_B), 0,
                                  seed=seed), device)
    tokens = batch["tokens"]
    box = {"state": state}

    def train():
        box["state"], _ = step(box["state"], batch)

    prt = plans["prefill_32k"].runtime()
    with torch.no_grad():
        _, cache = api.prefill(box["state"].model, tokens, prt,
                               max_len=STEP_S + 1)
    drt = plans["decode_32k"].runtime()
    nxt = tokens[:, -1:]

    def prefill():
        api.prefill(box["state"].model, tokens, prt, max_len=STEP_S + 1)

    def decode():
        # the step writes position STEP_S of the cache in place; each
        # call starts from a cache of STEP_S positions
        api.decode_step(box["state"].model, dict(cache, len=STEP_S), nxt,
                        drt)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(device)
    cells = {}
    for (kind, name), fn in zip(STEP_CELLS, (train, prefill, decode)):
        cells[kind] = _step_cell(kind, name, fn, cfg, plans[name], device,
                                 resident)
    del cache
    return cells, (cfg, api, opt, box, batch)


def _walk_reduced_step(device, seed: int) -> dict:
    """Phase 18 (c) on one device: the walk of a reduced Llama train step
    in f32 (the chunked path, remat, a loss chunk of 12) from seeded
    weights, the batch already on the device."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.gpu.op_walk import OpWalk
    from repro_torch.models.registry import get_model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_config(TRAIN_ARCH).reduced().replace(dtype="float32")
    api = get_model(cfg)
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=0, total_steps=100)
    rt = Runtime(attn_mode="chunked", remat=True, loss_chunk=12)
    model = api.init(torch.Generator().manual_seed(seed)).to(device)
    state = init_state(api, opt, model=model, device=device)
    step = make_train_step(api, rt, opt, device=device)
    batch = to_device(synth_batch(cfg, ShapeSpec("t", "train", 32, 4), 0,
                                  seed=seed), device)
    with OpWalk() as walk:
        step(state, batch)
    c = walk.costs()
    return dict(flops=c.flops, bytes=c.bytes_accessed,
                transcendentals=c.transcendentals, census=c.census,
                charges=c.charges)


def _autoplan_check(device, reuse) -> dict:
    """Phase 18 (d): the 15 one-device plans of the train cell ranked by
    the model; one timed step, after a warm-up, of the first- and the
    last-ranked plan that fit.  A finding, not a gate: a plan the card
    cannot hold is reported, and the next-ranked plan that fits is tried
    in its place, up to ``AUTOPLAN_TRIES`` plans from each end."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.gpu.autoplan import rank
    from repro_torch.train.train_step import make_train_step
    cfg, api, opt, box, batch = reuse
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=STEP_S,
                                global_batch=STEP_B)
    ranked = rank(cfg, shape)
    fit = [r for r in ranked if r.est.fits]

    def run(r) -> dict:
        step = make_train_step(api, r.plan.runtime(), opt, device=device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        out = dict(plan=r.plan.name, remat=r.plan.remat,
                   remat_group=r.plan.remat_group,
                   loss_chunk=r.plan.loss_chunk, est_step_s=r.step_s,
                   est_hbm_capacity_bytes=r.est.hbm_capacity_bytes)
        try:
            box["state"], _ = step(box["state"], batch)          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            box["state"], _ = step(box["state"], batch)
            torch.cuda.synchronize()
            out.update(step_s=time.perf_counter() - t0,
                       max_memory_allocated=torch.cuda.max_memory_allocated(
                           device))
        except torch.cuda.OutOfMemoryError as e:
            out.update(step_s=None, out_of_memory=str(e).splitlines()[0])
        del step
        torch.cuda.empty_cache()
        return out

    def first_that_runs(order) -> list[dict]:
        tried = []
        for r in order[:AUTOPLAN_TRIES]:
            tried.append(run(r))
            if tried[-1]["step_s"] is not None:
                break
        return tried
    first, last = first_that_runs(fit), first_that_runs(fit[::-1])
    a, b = first[-1]["step_s"], last[-1]["step_s"]
    return dict(plans=len(ranked), fit=len(fit),
                ranking=[dict(plan=r.plan.name, est_step_s=r.step_s,
                              fits=r.est.fits,
                              est_hbm_capacity_bytes=r.est.hbm_capacity_bytes)
                         for r in ranked],
                first=first, last=last,
                order_matches=(a <= b if a is not None and b is not None
                               else None))


def _fusions_want(cfg) -> dict:
    """The hand kernels' charges a walk of each cell must count: the
    ``flash_fwd`` launches of its forward (``train_flash_launches``), twice
    in a train step under remat (the forward and the recompute)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.plans import default_plan
    out = {}
    for kind, name in STEP_CELLS:
        rt = default_plan(cfg, SHAPES[name]).runtime()
        n = train_flash_launches(cfg, rt, STEP_S if kind != "decode" else 1)
        out[kind] = n * (2 if kind == "train" and rt.remat else 1)
    return out


def phase_step_model(card: str, device, seed: int) -> dict:
    """Phase 18: the step model on the card: (a) ``H100`` against the
    card, (b) the walk, the estimate and the roofline of three Llama-3.2-1B
    cells, (c) the walk of a reduced train step equal on the CPU and the
    card, (d) autoplan's order against measured steps."""
    import torch
    t_phase = time.perf_counter()
    spec = _spec_vs_card(device)
    cells, reuse = _step_cells(device, seed)
    want = _fusions_want(reuse[0])
    t_c = time.perf_counter()
    routes = {"cpu": _walk_reduced_step(torch.device("cpu"), seed),
              "card": _walk_reduced_step(device, seed)}
    same = {k: routes["cpu"][k] == routes["card"][k]
            for k in routes["cpu"]}
    t_d = time.perf_counter()
    autoplan = _autoplan_check(device, reuse)
    del reuse
    torch.cuda.empty_cache()
    hand_share = cells["train"]["flops"] / TRAIN_HAND_FLOPS
    info = dict(card=card, seed=seed, spec_vs_card=spec,
                h100=dict(sms=H100.sms,
                          smem_bytes_per_block=H100.smem_bytes_per_block,
                          hbm_capacity=H100.hbm_capacity,
                          peak_flops_bf16=H100.peak_flops_bf16,
                          peak_flops_f32=H100.peak_flops_f32,
                          hbm_bytes_per_s=H100.hbm_bytes_per_s),
                cells=cells, fusion_count_want=want,
                train_walk_over_hand_count=hand_share,
                train_walk_reaches_share=hand_share >= WALK_HAND_SHARE,
                routes_equal=same, routes=routes, autoplan=autoplan,
                cells_s=t_c - t_phase, routes_s=t_d - t_c,
                autoplan_s=time.perf_counter() - t_d,
                phase_s=time.perf_counter() - t_phase)
    emit("step_model", **info)
    got = {k: (c["fusion_count"], c["flash_launches"])
           for k, c in cells.items()}
    if any(got[k] != (n, n) for k, n in want.items()):
        raise PhaseFailed(f"(fusion_count, flash_fwd launches) of each "
                          f"walk {got}, want {want} of each")
    if not all(same.values()):
        raise PhaseFailed(f"the CPU's and the card's walks differ: {same}")
    if info["phase_s"] > STEP_MODEL_S:
        raise PhaseFailed(f"phase 18 took {info['phase_s']:.1f} s, over "
                          f"{STEP_MODEL_S} s")
    return info


# --------------------------------------------------------------------------
# phase 19
# --------------------------------------------------------------------------
def _same(got: dict, want: dict) -> list:
    """The keys whose tensors or arrays differ in any bit (or dtype)."""
    import numpy as np
    import torch
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        g, w = got[k], want[k]
        if isinstance(w, torch.Tensor):
            if g.dtype != w.dtype or not torch.equal(g.to(w.device), w):
                bad.append(k)
        elif not np.array_equal(g, w):
            bad.append(k)
    return bad


def _per_shard(mesh) -> list:
    return [dict(device=str(d), **{k: v for k, v in t.items() if v})
            for d, t in zip(mesh.devices, mesh.shard_launches)]


def _mesh_evaluate(device, mesh, want: dict, seed: int,
                   n_designs: int) -> dict:
    """(a): phase 4's designs through the session's own mesh (``mesh=4``)
    and through ``mesh``, each bit-equal to phase 4's arrays."""
    import numpy as np
    import torch
    from repro_torch.api import EvalConfig, Session, get_board, get_cnn
    from repro_torch.core.batch_eval import padded_rows
    from repro_torch.core.dse import sample_mixed
    from repro_torch.kernels import launches, reset_launches
    net, board = get_cnn("resnet50"), get_board("zcu102")
    batch = sample_mixed(np.random.default_rng(seed), len(net), n_designs)
    cfg = EvalConfig(device=str(device), mesh=MESH_SHARDS)
    with Session(board, config=cfg) as own, \
            Session(board, device=str(device), mesh=1) as single, \
            Session(board, config=cfg) as sharded:
        sharded.mesh = mesh
        routes = {"session_mesh": own, "single": single, "sharded": sharded}
        for ses in routes.values():                 # warm-up
            ses.evaluate(batch, net)
        torch.cuda.synchronize()
        walls = {k: [] for k in routes}
        outs, counts = {}, {}
        for _ in range(MESH_RUNS):
            for name, ses in routes.items():
                mesh.reset_shard_launches()
                reset_launches()
                t0 = time.perf_counter()
                outs[name] = ses.evaluate(batch, net)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
                counts[name] = launches()["parallelism_search"]
        shard_launches = _per_shard(mesh)
        own_mesh = dict(requested=own.mesh.requested,
                        ndevices=own.mesh.ndevices,
                        devices=[str(d) for d in own.mesh.devices])
    bad = {k: _same(o, want) for k, o in outs.items()}
    if any(bad.values()):
        raise PhaseFailed(f"mesh (a): outputs part from phase 4's: {bad}")
    if counts["sharded"] == 0 or any(
            s.get("parallelism_search", 0) == 0 for s in shard_launches):
        raise PhaseFailed(f"mesh (a): a shard launched no search kernel: "
                          f"{shard_launches}")
    us = {k: statistics.median(v) / n_designs * 1e6
          for k, v in walls.items()}
    return dict(cnn="resnet50", board="zcu102", designs=n_designs,
                session_mesh=own_mesh, mesh=[str(d) for d in mesh.devices],
                padded_rows=dict(
                    sharded=padded_rows(n_designs, MESH_TILE, mesh.ndevices),
                    single=padded_rows(n_designs, MESH_TILE)),
                wall_s=walls, us_per_design=us, launches=counts,
                shard_launches=shard_launches, bit_equal=True)


def _mesh_islands(device, mesh) -> dict:
    """(b): phase 15 (e)'s island search with one island a shard, against
    the serial islands in this run, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.api import SearchConfig, Session, get_board, get_cnn
    from repro_torch.kernels import launches, reset_launches
    net = get_cnn(DSE_CNN)
    cfg = SearchConfig(n_islands=mesh.ndevices, seed=DSE_SEARCH_SEED)
    runs = {"serial": [], "sharded": []}
    for name in ("serial", "sharded", "sharded", "serial"):
        with Session(get_board(), device=str(device), mesh=1) as ses:
            if name == "sharded":
                ses.mesh = mesh
            mesh.reset_shard_launches()
            reset_launches()
            res = ses.explore(net, DSE_BUDGET, strategy="search", config=cfg)
            torch.cuda.synchronize()
            runs[name].append((res, launches()["parallelism_search"],
                               _per_shard(mesh)))
    want, n_serial, _ = runs["serial"][0]
    for got, n_launch, shard_launches in runs["sharded"] + runs["serial"]:
        same = dict(
            designs=all(np.array_equal(a, b) for a, b in zip(
                got.batch.to_numpy(), want.batch.to_numpy())),
            metrics=not _same(got.metrics, want.metrics),
            front=np.array_equal(got.front, want.front),
            island_fronts=len(got.island_fronts) == mesh.ndevices
            and all(np.array_equal(a, b) for a, b in zip(
                got.island_fronts, want.island_fronts)),
            history=got.history == want.history)
        if not all(same.values()):
            raise PhaseFailed(f"mesh (b): an island run parts from the "
                              f"first serial one: {same}")
        if n_launch == 0 or n_launch != n_serial:
            raise PhaseFailed(f"mesh (b): launches {n_launch} (serial "
                              f"{n_serial})")
    got, n_launch, shard_launches = runs["sharded"][-1]
    if any(s.get("parallelism_search", 0) == 0 for s in shard_launches):
        raise PhaseFailed(f"mesh (b): a shard launched no search kernel: "
                          f"{shard_launches}")

    def timed(name):
        rs = [r for r, _, _ in runs[name]]
        return dict(seconds=[r.seconds for r in rs],
                    per_design_us=[r.per_design_us for r in rs],
                    step_s_median=[statistics.median(
                        t["step_s"] for t in r.timings) for r in rs])
    return dict(cnn=DSE_CNN, budget=DSE_BUDGET, n_islands=mesh.ndevices,
                pop_size=cfg.pop_size, seed=DSE_SEARCH_SEED,
                order="serial sharded sharded serial", launches=n_launch,
                generations=len(got.timings),
                step_s=[t["step_s"] for t in got.timings],
                shard_launches=shard_launches, sharded=timed("sharded"),
                serial=timed("serial"), bit_equal=True)


def _mesh_joint(device, mesh) -> dict:
    """(c): ``joint_evaluate`` on phase 14 (a)'s deployments in each mode,
    sharded over ``mesh``, against the unsharded call bit for bit."""
    import torch
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.dse import MultiDesignBatch
    from repro_torch.core.multinet import joint_evaluate, make_multi_tables
    from repro_torch.kernels import launches, reset_launches
    golden, cfg = _multinet_golden()
    fields = ("seg_end", "seg_pipe", "seg_nce", "inter_pipe")
    mode_kw = {"spatial": ("pes_shares", "buf_shares", "bw_shares"),
               "temporal": ("time_shares", "reconfig_s"),
               "hybrid": ("assign", "pes_shares", "buf_shares", "bw_shares",
                          "time_shares", "reconfig_s")}
    out = {}
    for mode, c in cfg["eval"].items():
        p = f"eval/{mode}"
        md = MultiDesignBatch.from_numpy(
            *(golden[f"{p}/in/{f}"] for f in fields), device=device)
        given = dict(pes_shares=golden[f"{p}/in/pes"],
                     buf_shares=golden[f"{p}/in/buf"],
                     bw_shares=golden[f"{p}/in/bw"],
                     time_shares=golden[f"{p}/in/time"],
                     assign=golden[f"{p}/in/assign"],
                     reconfig_s=c["reconfig_s"])
        kw = {k: given[k] for k in mode_kw[mode]}
        mt = make_multi_tables([get_cnn(n) for n in c["nets"]],
                               weights=c["weights"], slo_s=c["slo_s"],
                               device=device)
        board = get_board(c["board"])
        want = joint_evaluate(md, mt, board, mode=mode, **kw)
        mesh.reset_shard_launches()
        reset_launches()
        got = joint_evaluate(md, mt, board, mode=mode, mesh=mesh, **kw)
        torch.cuda.synchronize()
        n = launches()["parallelism_search"]
        bad = _same(got, want)
        shard_launches = _per_shard(mesh)
        if bad:
            raise PhaseFailed(f"mesh (c) {mode}: {bad} part from the "
                              f"unsharded call")
        if n == 0 or any(s.get("parallelism_search", 0) == 0
                         for s in shard_launches):
            raise PhaseFailed(f"mesh (c) {mode}: launches {n}, per shard "
                              f"{shard_launches}")
        out[mode] = dict(models=len(c["nets"]), deployments=c["n"],
                         padded_rows=mesh.padded_rows(c["n"], MESH_TILE),
                         launches=n, shard_launches=shard_launches,
                         bit_equal=True)
    return out


def phase_mesh(card: str, device, want: dict, seed: int,
               n_designs: int) -> dict:
    """The design-axis mesh on the card: four shards of it, then, where
    more than one card is visible, one shard a card."""
    import torch
    from repro_torch.core.shard import EvalMesh
    t_phase = time.perf_counter()
    meshes = {"shards_of_one_card": EvalMesh(devices=[device] *
                                             MESH_SHARDS)}
    count = torch.cuda.device_count()
    if count > 1:
        meshes["across_cards"] = EvalMesh(min(MESH_SHARDS, count))
    info = dict(card=card, device_count=count)
    total = 0
    for name, mesh in meshes.items():
        parts = dict(evaluate=_mesh_evaluate(device, mesh, want, seed,
                                             n_designs),
                     islands=_mesh_islands(device, mesh),
                     joint=_mesh_joint(device, mesh))
        total += parts["evaluate"]["launches"]["sharded"] \
            + parts["islands"]["launches"] \
            + sum(m["launches"] for m in parts["joint"].values())
        info[name] = parts
    if count == 1:
        info["across_cards"] = "one card visible"
    info.update(launches=total, phase_s=time.perf_counter() - t_phase)
    emit("mesh", **info)
    return info


# --------------------------------------------------------------------------
# phase 20
# --------------------------------------------------------------------------
def _rendezvous(d: str) -> str:
    return "file://" + os.path.join(d, "rendezvous")


def _counted(fn, device, warm: bool = True, reps: int = 2):
    """(result, host seconds of each of ``reps`` timed calls, ``flash_fwd``
    launches, collectives by kind) of ``fn``: after a warm-up call (where
    ``warm``), one call under the collective counter, the counts set to 0
    just before it, then ``reps`` calls timed without the counter (each
    ending in a synchronize)."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.collectives import CollectiveCounter
    if warm:
        fn()
    torch.cuda.synchronize(device)
    reset_launches()
    with CollectiveCounter() as cc:
        out = fn()
        torch.cuda.synchronize(device)
    n_launch = launches()["flash_fwd"]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, times, n_launch, cc.report()


def _time_once(fn, device) -> float:
    """Host seconds of one call of ``fn``, ending in a synchronize."""
    import torch
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _lm_mesh_one(device, seed: int, out_dir: str) -> dict:
    """Phase 20 (a): full-width Llama-3.2-1B through ``build_step`` on a
    1 x 1 NCCL mesh beside the single-device route on the same seed."""
    import numpy as np
    import math
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.plans import default_plan
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config(LM_MESH_ARCH)
    api = get_model(cfg)
    B, S = LM_MESH_B, LM_MESH_S
    tshape = ShapeSpec("train_4k_cut", "train", S, B)
    pshape = ShapeSpec("prefill_32k_cut", "prefill", S, B)
    dshape = ShapeSpec("decode_32k_cut", "decode", S + 1, B)
    batch = to_device(synth_batch(cfg, tshape, 0, seed=seed), device)
    tokens = batch["tokens"]

    def model():
        return api.init(torch.Generator(device=device).manual_seed(seed))
    out = dict(config=dict(arch=LM_MESH_ARCH, dtype=cfg.dtype, B=B, S=S,
                           cache=S + 1, mesh={"data": 1, "model": 1},
                           backend="nccl",
                           cuts=["train_4k: batch 256 -> 4",
                                 "prefill_32k: 32 x 32768 -> 4 x 4096",
                                 "decode_32k: 128 x 32768 -> 4 x 4097"]))
    # the single-device route (phases 17 and 18)
    m = model()
    prt = default_plan(cfg, SHAPES["prefill_32k"]).runtime()
    drt = default_plan(cfg, SHAPES["decode_32k"]).runtime()
    with torch.no_grad():
        (lp, cache), p_s, p_launch, _ = _counted(
            lambda: api.prefill(m, tokens, prt, max_len=S + 1), device)
        tok = lp[:, -1, :cfg.vocab_size].argmax(-1)[:, None].int()
        (ld, _), d_s, d_launch, _ = _counted(
            lambda: api.decode_step(m, cache, tok, drt), device)
    del cache
    plain = dict(prefill_s=p_s, decode_s=d_s, prefill_flash=p_launch,
                 decode_flash=d_launch)
    # the mesh route on the same model, its parameters placed on 1 x 1
    with tempfile.TemporaryDirectory() as d:
        MESH.init_process_group("nccl", rank=0, world_size=1,
                                init_method=_rendezvous(d))
        try:
            mesh = MESH.make_mesh_spec(1, 1, device="cuda")
            pb = ST.build_step(cfg, pshape, mesh)
            db = ST.build_step(cfg, dshape, mesh)
            pb.place_model(m)
            torch.cuda.reset_peak_memory_stats(device)
            (lpm, cache), pm_s, pm_launch, pm_coll = _counted(
                lambda: pb.fn(m, {"tokens": tokens}, max_len=S + 1), device)
            lpm = lpm.full_tensor()
            tokm = lpm[:, -1, :cfg.vocab_size].argmax(-1)[:, None].int()
            (ldm, _), dm_s, dm_launch, dm_coll = _counted(
                lambda: db.fn(m, cache, tokm), device)
            ldm = ldm.full_tensor()
            serve_peak = torch.cuda.max_memory_allocated(device)
            del cache
            # rank 0's layer-0 local q, k and v through the kernel
            with torch.no_grad():
                loc = {k: (v.to_local() if isinstance(v, DTensor) else v)
                       for k, v in m["layers"][0]["attn"].named_parameters()}
                attn = L.Params(**{k: v.clone() for k, v in loc.items()})
                table = m["embed"]["table"].to_local()
                ln1 = L.Params(scale=m["layers"][0]["ln1"]["scale"]
                               .to_local().clone())
                h = L.rms_norm(table[tokens], ln1, cfg.norm_eps)
                q, k, v = L._qkv(attn, h, cfg)
                cos, sin = L.rope_angles(torch.arange(S, device=device),
                                         cfg.head_dim, cfg.rope_theta)
                q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
            layer0_err = _flash_vs_plain(q, k, v, "lm_mesh layer 0")
            del q, k, v, h, m
            np.save(os.path.join(out_dir, "prefill_logits.npy"),
                    lp[:, -1].float().cpu().numpy())
            np.save(os.path.join(out_dir, "decode_logits.npy"),
                    ld[:, -1].float().cpu().numpy())
            serve = dict(
                prefill_s=pm_s, decode_s=dm_s, prefill_flash=pm_launch,
                decode_flash=dm_launch, collectives=dict(prefill=pm_coll,
                                                         decode=dm_coll),
                peak_bytes=serve_peak,
                prefill_logits_bit_equal=bool(torch.equal(lpm, lp)),
                decode_tokens_equal=bool(torch.equal(tokm, tok)),
                decode_logits_bit_equal=bool(torch.equal(ldm, ld)),
                layer0_max_abs_err=layer0_err)
            # training: the single-device step, then the mesh's
            plan = default_plan(cfg, SHAPES["train_4k"])
            opt = make_optimizer("adamw", peak_lr=3e-3, warmup=20,
                                 total_steps=100,
                                 state_dtype=plan.opt_state_dtype,
                                 factored=plan.opt_factored,
                                 momentum=plan.opt_momentum)
            state = init_state(api, opt, model=model(), device=device)
            step = make_train_step(api, plan.runtime(), opt, device=device)
            box = {}

            def plain_step():
                box["state"], box["m"] = step(state, batch)
            # the first step counted and compared, a second one timed
            _, _, t_launch, _ = _counted(plain_step, device, warm=False,
                                         reps=0)
            mt = box.pop("m")
            want = {n: p.detach().clone()
                    for n, p in state.model.named_parameters()}
            loss, gnorm = mt["loss"].clone(), mt["grad_norm"].clone()
            t_s = _time_once(plain_step, device)
            box.clear()
            plain.update(train_s=t_s, train_flash=t_launch,
                         loss=float(loss), grad_norm=float(gnorm))
            del state, step, mt
            tb = ST.build_step(cfg, tshape, mesh, opt=opt)
            state = init_state(api, opt, model=tb.place_model(model()),
                               device=device)
            torch.cuda.reset_peak_memory_stats(device)
            (_, mm), _, tm_launch, tm_coll = _counted(
                lambda: tb.fn(state, batch), device, warm=False, reps=0)
            peak = torch.cuda.max_memory_allocated(device)
            rel, n_diff = 0.0, 0
            for n, p in state.model.named_parameters():
                got, w = p.detach().to_local().float(), want[n].float()
                diff = (got - w).abs()
                n_diff += int((diff > 0).sum())
                rel = max(rel, float(diff.max() / w.abs().max().clamp_min(
                    1e-30)))
            gn_equal = bool(torch.equal(mm["grad_norm"], gnorm))
            loss_equal = bool(torch.equal(mm["loss"], loss))
            m_loss, m_gnorm = float(mm["loss"]), float(mm["grad_norm"])
            tm_s = _time_once(lambda: tb.fn(state, batch), device)
            train = dict(
                step_s=tm_s, flash=tm_launch, collectives=tm_coll,
                peak_bytes=peak, loss=m_loss, grad_norm=m_gnorm,
                loss_bit_equal=loss_equal,
                grad_norm_bit_equal=gn_equal,
                params_bit_equal=n_diff == 0, params_differing=n_diff,
                params_max_rel=rel,
                differing_op=(None if n_diff == 0 else
                              "the gradient norm's sum of squares"
                              if not gn_equal else "the AdamW update"))
            del state, want
        finally:
            dist.destroy_process_group()
    out.update(single_device=plain, serve=serve, train=train)
    fails = []
    if not (serve["prefill_logits_bit_equal"] and serve["decode_tokens_equal"]
            and serve["decode_logits_bit_equal"]):
        fails.append("serving differs from the single-device route")
    if not train["loss_bit_equal"]:
        fails.append("the train step's loss differs")
    if not train["params_bit_equal"] and rel > LM_MESH_PARAM_RTOL:
        fails.append(f"parameters {rel} apart relatively")
    if (pm_launch, dm_launch, tm_launch) != (p_launch, d_launch, t_launch):
        fails.append(f"flash_fwd launches {(pm_launch, dm_launch, tm_launch)}"
                     f" != single device {(p_launch, d_launch, t_launch)}")
    if not math.isfinite(train["loss"]):
        fails.append("non-finite loss")
    if fails:
        raise PhaseFailed(f"lm_mesh (a): {fails}: {out}")
    out["launches"] = pm_launch + dm_launch + tm_launch
    return out


def _family_inputs(arch: str, device, seed: int):
    """(cfg, api, batch, B, S) of phase 16's requests of ``arch``: the
    padded prompts and the stub frames or patches, made on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    prompts, extra = _family_prompts(cfg, device, seed)
    toks = _padded(prompts, device)
    return cfg, get_model(cfg), {"tokens": toks, **extra}, *toks.shape


def _families_single(device, seed: int, a_dir: str) -> dict:
    """Phase 20 (a) for the families past dense: each arch's full-width
    prefill and one decode step on one device (the route of phases 16 and
    18), in f32 (the bf16 weights and inputs widened; its greedy token
    feeds every route's decode step) and in bf16; the last logits and the
    token saved under ``a_dir`` for (b)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.plans import default_plan
    from repro_torch.models.registry import get_model
    out = {}
    for arch in LM_MESH_FAMILIES:
        cfg, api, batch, B, S = _family_inputs(arch, device, seed)
        m = api.init(torch.Generator(device=device).manual_seed(seed))
        c32 = cfg.replace(dtype="float32")
        api32 = get_model(c32)
        m32 = api32.init(torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():
            for (n32, p32), (n, p) in zip(m32.named_parameters(),
                                          m.named_parameters()):
                assert n32 == n, (n32, n)
                p32.copy_(p)
        b32 = {k: v.float() if v.is_floating_point() else v
               for k, v in batch.items()}
        r = dict(B=B, S=S)
        tok = None
        for tag, a, mm, bb, c in (("f32", api32, m32, b32, c32),
                                  ("bf16", api, m, batch, cfg)):
            prt = default_plan(c, ShapeSpec("p", "prefill", S, B)).runtime()
            drt = default_plan(c, ShapeSpec("d", "decode", S + 1, B)
                               ).runtime()
            torch.cuda.reset_peak_memory_stats(device)
            with torch.no_grad():
                t0 = time.perf_counter()
                lp, cache = a.prefill(mm, bb, prt, max_len=S + 1)
                if tok is None:
                    tok = lp[:, -1, :cfg.vocab_size].argmax(-1)[:, None].int()
                ld, _ = a.decode_step(mm, cache, tok, drt)
                torch.cuda.synchronize(device)
            r[tag] = dict(seconds=time.perf_counter() - t0,
                          peak_bytes=torch.cuda.max_memory_allocated(device))
            np.save(os.path.join(a_dir, f"{arch}_{tag}_prefill.npy"),
                    lp[:, -1].float().cpu().numpy())
            np.save(os.path.join(a_dir, f"{arch}_{tag}_decode.npy"),
                    ld[:, -1].float().cpu().numpy())
            del lp, ld, cache
        np.save(os.path.join(a_dir, f"{arch}_token.npy"), tok.cpu().numpy())
        out[arch] = r
        del m, m32, batch, b32
        torch.cuda.empty_cache()
    return out


def _logits_vs(mesh, a_dir: str, arch: str, part: str, vocab: int) -> dict:
    """The mesh's last logits (B, V) against the single device's in f32
    (the reference) and in bf16 (read from ``a_dir``): each route's
    distance from the reference in units of its largest |value|, and the
    greedy tokens, which may differ from the reference's only where its
    top two are closer than twice the mesh's distance."""
    import numpy as np

    def load(tag):
        return np.load(os.path.join(a_dir, f"{arch}_{tag}_{part}.npy")
                       )[:, :vocab]
    mesh, ref, bf16 = mesh[:, :vocab], load("f32"), load("bf16")
    scale = float(np.abs(ref).max())
    err = float(np.abs(mesh - ref).max())
    single = float(np.abs(bf16 - ref).max()) / scale
    top2 = np.sort(ref, axis=-1)[:, -2:]
    same = mesh.argmax(-1) == ref.argmax(-1)
    near = (top2[:, 1] - top2[:, 0]) <= 2 * err
    return dict(mesh_rel=err / scale, single_bf16_rel=single,
                mesh_vs_single_bf16_rel=float(np.abs(mesh - bf16).max())
                / scale,
                tokens_equal_f32=int(same.sum()),
                tokens_equal_bf16=int((mesh.argmax(-1)
                                       == bf16.argmax(-1)).sum()),
                tokens=len(same), tokens_ok=bool((same | near).all()),
                ok=err / scale <= max(LM_MESH_FAMILY_FACTOR * single,
                                      LM_MESH_FAMILY_FLOOR))


def _families_full_rank(device, seed: int, a_dir: str) -> dict:
    """The families past dense at full width in bf16 on this world's 2 x 2
    mesh: each arch's prefill and one decode step through ``build_step``,
    their seconds, ``flash_fwd`` launches (and the single-device count
    they must equal), collectives and peak memory, and (rank 0) their
    logits and tokens against (a)'s single-device route."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    from torch.utils._pytree import tree_map
    mesh = MESH.make_mesh_spec(2, 2, device="cuda")
    out = {}
    for arch in LM_MESH_FAMILIES:
        t0 = time.perf_counter()
        cfg, api, batch, B, S = _family_inputs(arch, device, seed)
        enc = batch["frames"].shape[1] if "frames" in batch else 0
        want = flash_launches(cfg, S, enc)
        pb = ST.build_step(cfg, ShapeSpec("p", "prefill", S, B), mesh)
        db = ST.build_step(cfg, ShapeSpec("d", "decode", S + 1, B), mesh)
        m = pb.place_model(api.init(torch.Generator(device=device)
                                    .manual_seed(seed)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        # the counted prefill warms the timed one
        (lp, cache), p_s, p_launch, p_coll = _counted(
            lambda: pb.fn(m, batch, max_len=S + 1), device, warm=False,
            reps=1)
        lp = lp.full_tensor()
        tok = torch.from_numpy(np.load(os.path.join(
            a_dir, f"{arch}_token.npy"))).to(device)
        # a decode step moves an SSM's state on: the counted step runs on
        # the prefill's cache, the timed one on a copy taken before it
        spare = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, cache)
        (ld, _), _, d_launch, d_coll = _counted(
            lambda: db.fn(m, cache, tok), device, warm=False, reps=0)
        d_s = [_time_once(lambda: db.fn(m, spare, tok), device)]
        ld = ld.full_tensor()
        r = dict(B=B, S=S, enc_frames=enc or None, prefill_s=p_s,
                 decode_s=d_s, prefill_flash=p_launch, decode_flash=d_launch,
                 want_flash=list(want),
                 collectives=dict(prefill=p_coll, decode=d_coll),
                 peak_bytes=torch.cuda.max_memory_allocated(device),
                 finite=bool(torch.isfinite(lp).all())
                 and bool(torch.isfinite(ld).all()))
        if dist.get_rank() == 0:
            for part, lg in (("prefill", lp), ("decode", ld)):
                r[part] = _logits_vs(lg[:, -1].float().cpu().numpy(), a_dir,
                                     arch, part, cfg.vocab_size)
        r["arch_s"] = time.perf_counter() - t0
        out[arch] = r
        del m, cache, spare, lp, ld, batch, pb, db
        torch.cuda.empty_cache()
    return out


def _lm_mesh_full_rank(device, seed: int, a_dir: str) -> dict:
    """Full-width Llama-3.2-1B bf16 prefill and one decode step on this
    world's 2 x 2 mesh: seconds, launches, collectives, peak memory, and
    (rank 0) the logits' distance from (a)'s."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_MESH_ARCH)
    api = get_model(cfg)
    B, S = LM_MESH_B, LM_MESH_S
    batch = to_device(synth_batch(cfg, ShapeSpec("train_4k_cut", "train", S,
                                                 B), 0, seed=seed), device)
    mesh = MESH.make_mesh_spec(2, 2, device="cuda")
    pb = ST.build_step(cfg, ShapeSpec("prefill_32k_cut", "prefill", S, B),
                       mesh)
    db = ST.build_step(cfg, ShapeSpec("decode_32k_cut", "decode", S + 1, B),
                       mesh)
    m = pb.place_model(api.init(torch.Generator(device=device).manual_seed(
        seed)))
    torch.cuda.reset_peak_memory_stats(device)
    (lp, cache), p_s, p_launch, p_coll = _counted(
        lambda: pb.fn(m, {"tokens": batch["tokens"]}, max_len=S + 1), device)
    lp = lp.full_tensor()
    tok = lp[:, -1, :cfg.vocab_size].argmax(-1)[:, None].int()
    (ld, _), d_s, d_launch, d_coll = _counted(lambda: db.fn(m, cache, tok),
                                              device)
    ld = ld.full_tensor()
    out = dict(prefill_s=p_s, decode_s=d_s, prefill_flash=p_launch,
               decode_flash=d_launch,
               collectives=dict(prefill=p_coll, decode=d_coll),
               peak_bytes=torch.cuda.max_memory_allocated(device))
    nxt = ld[:, -1, :cfg.vocab_size].argmax(-1)
    out["tokens_ok"] = bool(torch.isfinite(ld).all()) and bool(
        ((nxt >= 0) & (nxt < cfg.vocab_size)).all())
    if dist.get_rank() == 0:
        a_p = np.load(os.path.join(a_dir, "prefill_logits.npy"))
        a_d = np.load(os.path.join(a_dir, "decode_logits.npy"))
        out["prefill_max_abs_err_vs_a"] = float(np.abs(
            lp[:, -1].float().cpu().numpy() - a_p).max())
        out["decode_max_abs_err_vs_a"] = float(np.abs(
            ld[:, -1].float().cpu().numpy() - a_d).max())
        out["decode_tokens_equal_a"] = bool(np.array_equal(
            tok.cpu().numpy()[:, 0], a_p[:, :cfg.vocab_size].argmax(-1)))
    return out


def _lm_mesh_rank(rank: int, world: int, backend: str, init: str,
                  out_dir: str, a_dir: str, seed: int) -> None:
    """One rank of (b) or (c): the full-width serving on the 2 x 2 mesh,
    then the golden mesh cases (``tests/torch_mesh_check.py``, the CPU
    tests' rank program); rank 0 writes the golden cases' arrays and each
    rank its own numbers under ``out_dir``."""
    import numpy as np
    import faulthandler

    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as MESH
    sys.path.append(os.path.join(ROOT, "tests"))
    import torch_mesh_check as mesh_check
    import torch_mesh_families_check as fam_check
    from repro_torch.kernels import launches
    faulthandler.enable()           # a crash in a rank prints its stack
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "gloo":
        torch.cuda.set_device(0)                # the ranks share one card
    MESH.init_process_group(backend, rank=rank, world_size=world,
                            init_method=init)
    device = torch.device("cuda", torch.cuda.current_device())
    mine: dict = {}
    try:
        t0 = time.perf_counter()
        mine["full"] = _lm_mesh_full_rank(device, seed, a_dir)
        mine["full_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mine["families_full"] = _families_full_rank(device, seed, a_dir)
        mine["families_full_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = mesh_check.run_2x2(mesh_check.golden(), "cuda",
                                 os.path.join(out_dir, "ckpt"))
        mine["golden_s"] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(out_dir, "golden_cases.npz"), **got)
        del got
        t0 = time.perf_counter()
        before = launches()["flash_fwd"]
        got = fam_check.run(fam_check.golden(), "cuda")
        mine["families_flash"] = launches()["flash_fwd"] - before
        mine["families_s"] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(out_dir, "families_cases.npz"), **got)
        del got
        mine["bad_modules"] = [m for m in sys.modules
                               if m in ("jax", "repro")
                               or m.startswith(("jax.", "repro."))]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(mine, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh_golden_check(got: dict) -> dict:
    """The golden mesh cases run on the card against ``golden_mesh.npz``,
    with tests/test_torch_mesh.py's tolerances; fails past any."""
    import numpy as np
    with np.load(GOLDEN_MESH) as z:
        g = {k: z[k] for k in z.files}
    worst: dict = {}
    fails = []

    def note(key, err):
        grp = "/".join(key.split("/")[:3])
        worst[grp] = max(worst.get(grp, 0.0), err)
    for k, w in g.items():
        if w.dtype.kind in "USO" or "/batch/" in k or "/init/" in k \
                or k.endswith("/moe/x"):
            continue
        if k not in got:
            fails.append(f"{k}: not run")
            continue
        a = got[k]
        if a.shape != w.shape:
            fails.append(f"{k}: shape {a.shape} != {w.shape}")
            continue
        if w.dtype.kind in "iu":
            if not np.array_equal(a, w):
                fails.append(f"{k} differs")
            continue
        if "/compress/grads/" in k or "/compress/residuals/" in k:
            arch, rest = k.split("/compress/")
            path = rest.split("/", 2)[-1] if rest.startswith(
                "residuals") else rest[len("grads/"):]
            q = np.abs(a - w) / g[f"{arch}/compress/scales/{path}"]
            note(k, float(q.max(initial=0.0)))
            worst[arch + " flips"] = worst.get(arch + " flips", 0) + int(
                (q > 1e-3).sum())
            if q.max(initial=0.0) > 1.0 + 1e-3:
                fails.append(f"{k}: {q.max()} quanta")
            continue
        if k.endswith("/compress/losses"):
            # the card runs one compressed step against the golden file;
            # the other 11 of the CPU tests' trajectory are reported: each
            # flip of an int8 rounding moves the rest of the trajectory
            worst[k + " (12 steps, reported)"] = float(np.abs(a - w).max())
            a, w = a[:1], w[:1]
        if k.endswith(("/loss", "/nll", "/aux", "/grad_norm", "/losses")):
            err = float(np.abs(a - w).max())
            tol = LM_MESH_LOSS_ATOL
        elif "/scales/" in k:
            err = float((np.abs(a - w) / w).max())
            tol = 1e-5
        else:
            err = float(np.abs(a - w).max()) / max(1.0, float(
                np.abs(w).max(initial=0.0)))
            tol = LM_MESH_RTOL_OF_SCALE
        note(k, err)
        if err > tol:
            fails.append(f"{k}: {err} > {tol}" + (
                f" (got {a.tolist()}, want {w.tolist()})" if a.size <= 16
                else ""))
    for arch in {k.split("/")[0] for k in g if "/compress/" in k}:
        if worst.get(arch + " flips", 0) > 2 * LM_MESH_MAX_FLIPS:
            fails.append(f"{arch}: {worst[arch + ' flips']} elements flip")
    for impl in ("ep", "ep_a2a"):
        key = f"granite-moe-1b-a400m/moe/{impl}/dropped"
        if int(got[key]) <= 0:
            fails.append(f"{key}: nothing dropped")
    ck = [k for k in got if k.startswith("reshard/4x1/")]
    if not ck:
        fails.append("no reshard arrays")
    if fails:
        raise PhaseFailed(f"lm_mesh golden cases: {fails[:10]}")
    return dict(worst=worst, dropped={
        impl: int(got[f"granite-moe-1b-a400m/moe/{impl}/dropped"])
        for impl in ("ep", "ep_a2a")},
        collectives={impl: json.loads(str(
            got[f"granite-moe-1b-a400m/moe/{impl}/collectives"]))
            for impl in ("ep", "ep_a2a")})


def _families_golden_check(got: dict) -> dict:
    """The SSM, hybrid, enc-dec and VLM families' mesh cases run on the
    card against ``golden_mesh_families.npz``, with
    tests/test_torch_mesh_families.py's tolerances; fails past any.
    Returns the worst error of each (mesh, arch, part)."""
    import numpy as np
    with np.load(GOLDEN_MESH_FAMILIES) as z:
        g = {k: z[k] for k in z.files}
    worst: dict = {}
    fails = []
    for k, w in g.items():
        if not k.startswith(("2x2/", "1x4/")):
            continue
        if k not in got or got[k].shape != w.shape:
            fails.append(f"{k}: not run, or of another shape")
            continue
        a = got[k]
        if w.dtype.kind in "iu":
            if not np.array_equal(a, w):
                fails.append(f"{k}: {a.tolist()} != {w.tolist()}")
            continue
        if k.endswith(("/loss", "/nll", "/aux")):
            err, tol = float(np.abs(a - w).max()), LM_MESH_LOSS_ATOL
        else:
            err = float(np.abs(a - w).max()) / max(1.0, float(
                np.abs(w).max(initial=0.0)))
            tol = LM_MESH_RTOL_OF_SCALE
        grp = "/".join(k.split("/")[:3])
        worst[grp] = max(worst.get(grp, 0.0), err)
        if err > tol:
            fails.append(f"{k}: {err} > {tol}")
    if fails:
        raise PhaseFailed(f"lm_mesh families' cases: {fails[:10]}")
    return worst


def _families_full_check(ranks: list) -> dict:
    """The families' full-width 2 x 2 runs of every rank: each rank's
    ``flash_fwd`` launches equal to the single-device count (one a layer
    on its heads), finite logits, and rank 0's logits and tokens as near
    (a)'s f32 reference as ``_logits_vs`` asks; fails past any.  Returns each arch's
    rank-0 comparison, seconds, launches and peak bytes of every rank."""
    fails, out = [], {}
    for arch in LM_MESH_FAMILIES:
        rs = [r[arch] for r in ranks]
        got = [(r["prefill_flash"], r["decode_flash"]) for r in rs]
        if any(g != tuple(rs[0]["want_flash"]) for g in got):
            fails.append(f"{arch}: flash_fwd launches a rank {got}, want "
                         f"{rs[0]['want_flash']}")
        if not all(r["finite"] for r in rs):
            fails.append(f"{arch}: non-finite logits")
        for part in ("prefill", "decode"):
            c = rs[0][part]
            if not (c["ok"] and c["tokens_ok"]):
                fails.append(f"{arch} {part}: {c}")
        out[arch] = dict(
            B=rs[0]["B"], S=rs[0]["S"], enc_frames=rs[0]["enc_frames"],
            prefill=rs[0]["prefill"], decode=rs[0]["decode"],
            flash_a_rank=got[0], prefill_s=[r["prefill_s"] for r in rs],
            decode_s=[r["decode_s"] for r in rs],
            peak_bytes=[r["peak_bytes"] for r in rs],
            collectives=rs[0]["collectives"],
            arch_s=[r["arch_s"] for r in rs])
    if fails:
        raise PhaseFailed(f"lm_mesh families at full width: {fails}")
    return out


def _lm_mesh_world(backend: str, world: int, a_dir: str, seed: int) -> dict:
    """Spawn ``world`` ranks of ``backend`` and gather their results: the
    golden cases held against ``golden_mesh.npz``, the reshard bit-equal,
    no rank importing ``jax`` or ``repro``, and the full-width prefill
    launching ``flash_fwd`` once a layer on every rank."""
    import numpy as np
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory() as d:
        out_dir = os.path.join(d, "out")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        mp.spawn(_lm_mesh_rank, args=(world, backend, _rendezvous(d),
                                      out_dir, a_dir, seed),
                 nprocs=world)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with np.load(os.path.join(out_dir, "golden_cases.npz")) as z:
            got = {k: z[k] for k in z.files}
        with np.load(os.path.join(out_dir, "families_cases.npz")) as z:
            fam = {k: z[k] for k in z.files}
        # kept beside the run's output, for a failure to be read there
        os.makedirs(OUT_DIR, exist_ok=True)
        np.savez_compressed(os.path.join(
            OUT_DIR, f"lm_mesh_golden_cases_{backend}.npz"), **got)
        with np.load(os.path.join(out_dir, "ckpt", "2x2", "step_00000001",
                                  "arrays.npz")) as z:
            saved = {k: z[k] for k in z.files}
    golden = _mesh_golden_check(got)
    families = _families_golden_check(fam)
    fam_flash = sum(r["families_flash"] for r in ranks)
    if fam_flash <= 0:
        raise PhaseFailed("lm_mesh families' cases launched no flash_fwd")
    off = [k for k, v in saved.items()
           if not np.array_equal(got[f"reshard/4x1/{k}"].astype(v.dtype), v)]
    if off:
        raise PhaseFailed(f"lm_mesh reshard onto 4 x 1 not bit-equal: {off}")
    bad = sorted({m for r in ranks for m in r["bad_modules"]})
    if bad:
        raise PhaseFailed(f"lm_mesh ranks imported {bad}")
    full = [r["full"] for r in ranks]
    if not all(f["tokens_ok"] for f in full):
        raise PhaseFailed(f"lm_mesh full-width tokens: {full}")
    layers = get_config(LM_MESH_ARCH).n_layers
    if any(f["prefill_flash"] != layers for f in full):
        raise PhaseFailed(f"lm_mesh full-width prefill: flash_fwd launches "
                          f"a rank {[f['prefill_flash'] for f in full]}, "
                          f"want {layers} (one a layer)")
    fam_full = _families_full_check([r["families_full"] for r in ranks])
    return dict(backend=backend, world=world, mesh={"data": 2, "model": 2},
                wall_s=wall, golden=golden, reshard_4x1_bit_equal=True,
                golden_s=[r["golden_s"] for r in ranks],
                families=families,
                families_s=[r["families_s"] for r in ranks],
                families_flash=[r["families_flash"] for r in ranks],
                families_launches=fam_flash,
                families_full=fam_full,
                families_full_s=[r["families_full_s"] for r in ranks],
                families_full_launches=sum(
                    f["prefill_flash"] + f["decode_flash"]
                    for r in ranks for f in r["families_full"].values()),
                full=full, full_s=[r["full_s"] for r in ranks],
                launches=sum(f["prefill_flash"] + f["decode_flash"]
                             for f in full))


def phase_lm_mesh(card: str, device, seed: int) -> dict:
    """Phase 20: the LM mesh (the module docstring's item 20)."""
    import torch
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as a_dir:
        one = _lm_mesh_one(device, seed, a_dir)
        emit("lm_mesh", part="(a) 1 x 1", **one)
        torch.cuda.empty_cache()
        t_fam = time.perf_counter()
        one["families_single"] = _families_single(device, seed, a_dir)
        one["families_single_s"] = time.perf_counter() - t_fam
        emit("lm_mesh", part="(a) families, one device",
             **one["families_single"])
        t_b = time.perf_counter()
        four = _lm_mesh_world("gloo", LM_MESH_RANKS, a_dir, seed)
        count = torch.cuda.device_count()
        across = ("one card visible" if count == 1 else
                  _lm_mesh_world("nccl", LM_MESH_RANKS, a_dir, seed)
                  if count >= LM_MESH_RANKS else
                  f"{count} cards visible: the 2 x 2 mesh needs "
                  f"{LM_MESH_RANKS}")
    info = dict(card=card, one_by_one=one, gloo_on_one_card=four,
                across_cards=across,
                tolerance=dict(param_rtol=LM_MESH_PARAM_RTOL,
                               loss_atol=LM_MESH_LOSS_ATOL,
                               rtol_of_scale=LM_MESH_RTOL_OF_SCALE,
                               compressed="one quantum"),
                a_s=t_b - t_phase, b_s=time.perf_counter() - t_b,
                launches=one["launches"] + four["families_full_launches"],
                families_launches=four["families_launches"],
                phase_s=time.perf_counter() - t_phase)
    emit("lm_mesh", **info)
    return info


# --------------------------------------------------------------------------
# phase 21
# --------------------------------------------------------------------------
def _dryrun_one_card(out_path: str, device: str = "cuda") -> None:
    """Phase 21 (d), in a process of its own (a fake world is its default
    group): Llama-3.2-1B's train step at phase 18's cut (B ``STEP_B`` x S
    ``STEP_S``) under phase 18's plan and optimizer, through
    ``build_step`` on a 1 x 1 mesh of a fake world of one, walked on meta
    tensors by ``launch.dryrun.walk_step``; its walk and counted memory
    written to ``out_path`` as JSON."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.plans import default_plan
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optimizer import make_optimizer
    torch.set_grad_enabled(True)
    MESH.join_fake_world(1)
    mesh = MESH.make_mesh_spec(1, 1, device=device)
    cfg = get_config(TRAIN_ARCH)
    plan = default_plan(cfg, SHAPES["train_4k"])
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=20, total_steps=100,
                         state_dtype=plan.opt_state_dtype,
                         factored=plan.opt_factored,
                         momentum=plan.opt_momentum)
    built = build_step(cfg, ShapeSpec("train_4k_cut", "train", STEP_S,
                                      STEP_B), mesh, plan, opt=opt)
    t0 = time.perf_counter()
    costs, memory = dryrun.walk_step(built)
    with open(out_path, "w") as f:
        json.dump(dict(flops=costs.flops, bytes=costs.bytes_accessed,
                       transcendentals=costs.transcendentals,
                       charges=costs.charges, memory=memory,
                       walk_s=time.perf_counter() - t0), f)


def _run_jobs(jobs: dict, log_dir: str) -> dict:
    """Run each job ({name: argv}) as a subprocess from the checkout's
    root, ``DRYRUN_JOBS`` at once in the dict's order, each within
    ``DRYRUN_TIMEOUT_S``; its output goes to ``log_dir/<name>.txt``.
    Returns {name: (exit code, seconds)}; a job past its limit is killed
    (code None)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    os.makedirs(log_dir, exist_ok=True)
    todo, running, done = list(jobs.items()), {}, {}
    try:
        while todo or running:
            while todo and len(running) < DRYRUN_JOBS:
                name, argv = todo.pop(0)
                log = open(os.path.join(log_dir, name + ".txt"), "w")
                running[name] = (subprocess.Popen(
                    argv, cwd=ROOT, env=env, stdout=log,
                    stderr=subprocess.STDOUT), log, time.perf_counter())
            time.sleep(0.5)
            for name, (proc, log, t0) in list(running.items()):
                late = time.perf_counter() - t0 > DRYRUN_TIMEOUT_S
                if proc.poll() is None and not late:
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
                done[name] = (None if late else proc.returncode,
                              time.perf_counter() - t0)
                del running[name]
    finally:
        for proc, log, _ in running.values():
            proc.kill()
            proc.wait()
            log.close()
    return done


def _eq10(recs: list) -> dict:
    """Eq. 10's accuracy of ``gpu.cost_model.estimate`` against each
    record's walk, term by term (FLOPs, HBM bytes, wire bytes), as the JAX
    package's ``benchmarks/tpu_model_accuracy.py`` computes it: each
    cell's ``default_plan`` on a stand-in of its mesh's shape, terms below
    their floor (1 ms of the card's rate) skipped."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.gpu.chip import H100
    from repro_torch.gpu.cost_model import estimate
    from repro_torch.launch.plans import default_plan

    class _MeshView:
        def __init__(self, shape: dict):
            self.shape = shape
    floor = {"flops": H100.peak_flops_bf16 * 1e-3,
             "hbm": H100.hbm_bytes_per_s * 1e-3,
             "wire": H100.link_bytes_per_s * H100.links * 1e-3}
    acc: dict = {k: [] for k in floor}
    cells = {}
    for rec in recs:
        cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
        mesh = _MeshView(rec["mesh_shape"])
        est = estimate(cfg, shape, default_plan(cfg, shape, mesh), mesh=mesh)
        walk = rec["walk"]
        pairs = {"flops": (walk["flops"], est.useful_flops),
                 "hbm": (walk["bytes_accessed"], est.hbm_bytes),
                 "wire": (walk["total_wire_bytes"], est.wire_bytes)}
        row = {}
        for k, (oracle, model) in pairs.items():
            if oracle < floor[k]:
                row[k] = None
                continue
            a = 100.0 * (1.0 - abs(oracle - model) / oracle)
            acc[k].append(a)
            row[k] = a
        cells[rec["cell"]] = row
    summary = {k: dict(mean=statistics.mean(v), min=min(v), n=len(v))
               for k, v in acc.items() if v}
    return dict(summary=summary, cells=cells, floors=floor)


def phase_dryrun(card: str, train: dict | None, step: dict | None) -> dict:
    """Phase 21: the dry-run (the module docstring's item 21)."""
    from repro_torch.configs import cells
    from repro_torch.roofline.analysis import analyze_cell
    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "dryrun")
    cpu_out = os.path.join(OUT_DIR, "dryrun_cpu")
    one_path = os.path.join(OUT_DIR, "dryrun_one_card.json")
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force"]
    jobs = {f"{arch}__{mesh}": dry + ["--device", DRYRUN_DEVICE, "--arch",
                                      arch, "--mesh", mesh, "--out", out]
            for mesh in ("multi", "single") for arch in DRYRUN_ORDER}
    arch, shape, mesh = DRYRUN_EQUAL_CELL
    jobs["cpu_cell"] = dry + ["--device", "cpu", "--arch", arch, "--shape",
                              shape, "--mesh", mesh, "--out", cpu_out]
    jobs["one_card"] = [sys.executable, "-c",
                        "import chip_smoke; chip_smoke._dryrun_one_card("
                        f"{one_path!r}, {DRYRUN_DEVICE!r})"]
    done = _run_jobs(jobs, os.path.join(OUT_DIR, "dryrun_logs"))
    sweep_s = time.perf_counter() - t_phase
    want = [(a, s, m) for a, s, skip in cells(include_skipped=True)
            if not skip and a in DRYRUN_ORDER for m in ("single", "multi")]
    recs, fails = [], []
    for a, s, m in want:
        path = os.path.join(out, f"{a}__{s}__{m}.json")
        if not os.path.exists(path):
            fails.append(f"{a}__{s}__{m}: no record (job "
                         f"{done.get(f'{a}__{m}')})")
            continue
        with open(path) as f:
            rec = json.load(f)
        if not rec["ok"]:
            fails.append(f"{rec['cell']}: {rec.get('error')}")
            continue
        recs.append(rec)
        roof = analyze_cell(rec)
        emit("dryrun", part="cell", cell=rec["cell"], ok=True,
             walk_s=rec["walk_s"], flops_per_device=rec["walk"]["flops"],
             peak_gib=rec["memory"]["peak_memory_in_bytes"] / 2**30,
             wire_gib=rec["collectives"]["total_wire"] / 2**30,
             dominant=roof.dominant, compute_s=roof.compute_s,
             memory_s=roof.memory_s, collective_s=roof.collective_s,
             useful_ratio=roof.useful_ratio)
    bad_jobs = {k: v for k, v in done.items() if v[0] != 0}
    # (c) one cell's records on cuda and on cpu
    same = None
    cuda_p = os.path.join(out, "__".join(DRYRUN_EQUAL_CELL) + ".json")
    cpu_p = os.path.join(cpu_out, "__".join(DRYRUN_EQUAL_CELL) + ".json")
    if os.path.exists(cuda_p) and os.path.exists(cpu_p):
        with open(cuda_p) as f:
            a_rec = json.load(f)
        with open(cpu_p) as f:
            b_rec = json.load(f)
        keys = ("ok", "mesh_shape", "plan", "memory", "collectives", "walk")
        same = {k: a_rec.get(k) == b_rec.get(k) for k in keys}
    # (d) phase 18's train cut on a 1 x 1 fake world
    one = None
    if os.path.exists(one_path):
        with open(one_path) as f:
            one = json.load(f)
    one_vs = None
    if one is not None and step is not None:
        real = step["cells"]["train"]
        one_vs = {k: (one[k], real[k]) for k in ("flops", "bytes",
                                                 "transcendentals",
                                                 "charges")}
        # the walk's count against the allocator's peak of the real step
        peak = one["memory"]["peak_memory_in_bytes"]
        one_vs["peak_counted_vs_phase18"] = (
            peak, real["max_memory_allocated"],
            peak / real["max_memory_allocated"])
        if train is not None:
            p17 = train["full"]["max_memory_allocated"]
            one_vs["peak_counted_vs_phase17"] = (peak, p17, peak / p17)
    eq10 = _eq10(recs)
    kimi = [r["cell"] for r in recs if r["arch"] == "kimi-k2-1t-a32b"]
    info = dict(card=card, cells=len(want), ok=len(recs), jobs=done,
                sweep_s=sweep_s, left_out=[], kimi_cells=kimi,
                eq10=eq10["summary"], eq10_floors=eq10["floors"],
                eq10_cells=eq10["cells"], cuda_cpu_equal=same,
                cuda_cpu_cell="__".join(DRYRUN_EQUAL_CELL),
                one_card=one, one_card_vs_real=one_vs,
                walk_s_total=sum(r["walk_s"] for r in recs),
                phase_s=time.perf_counter() - t_phase)
    emit("dryrun", **info)
    if fails or bad_jobs:
        raise PhaseFailed(f"dryrun: {len(fails)} cells not ok "
                          f"{fails[:6]}; jobs {bad_jobs}")
    if len(kimi) != 6:
        raise PhaseFailed(f"dryrun: Kimi-K2's cells {kimi}")
    if same is None or not all(same.values()):
        raise PhaseFailed(f"dryrun: the cuda and cpu records of "
                          f"{DRYRUN_EQUAL_CELL} differ: {same}")
    if one is None:
        raise PhaseFailed("dryrun: the 1 x 1 fake world's walk is missing")
    walk_keys = ("flops", "bytes", "transcendentals", "charges")
    if one_vs is not None and any(one_vs[k][0] != one_vs[k][1]
                                  for k in walk_keys):
        raise PhaseFailed(f"dryrun: the 1 x 1 fake world's walk differs "
                          f"from phase 18's: {one_vs}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--designs", type=int, default=100_000)
    ap.add_argument("--only", choices=("lm_mesh", "dryrun"), default=None,
                    help="run the kernels' build and this phase alone, and "
                         "print no kernels line and no ok line (debugging)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = nvidia_smi()

    phase_build(card)
    if args.only == "lm_mesh":
        phase_lm_mesh(card, device, args.seed)
        return 0
    if args.only == "dryrun":
        phase_dryrun(card, None, None)
        return 0
    err = phase_kernel(card, device)
    phase_main_vs_golden(card, device)
    search = phase_load(card, device, args.seed, args.designs)
    search["max_abs_err"] = err["max_abs_err"]
    phase_scalar(card, device)
    latency = phase_latency(card, device, args.seed, args.designs)
    conv = phase_conv(card, device, args.seed)
    flash, flash_f32 = phase_flash(card, device, args.seed)
    serve = phase_serve(card, device, args.seed)
    flash["launches"] = serve["launches"]["generate"]
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               serve["layer0_max_abs_err"])
    golden_lm = phase_golden_lm(card, device)
    flash_f32["launches"] = golden_lm["batches"]["long"]["flash_launches"]
    dse = phase_dse(card, device)
    submit = phase_submit(card, device, search["us_per_design_median"])
    phase_schedule(card, device, args.seed, args.designs,
                   search["us_per_design_median"])
    phase_multinet(card, device, args.seed)
    phase_wire_islands(card, device, submit, dse)
    families = phase_families(card, device, args.seed)
    train = phase_train(card, device, args.seed)
    step_model = phase_step_model(card, device, args.seed)
    mesh = phase_mesh(card, device, search.pop("arrays"), args.seed,
                      args.designs)
    search["launches"] += mesh["launches"]
    lm_mesh = phase_lm_mesh(card, device, args.seed)
    flash["launches"] += lm_mesh["launches"]
    flash_f32["launches"] += lm_mesh["families_launches"]
    phase_dryrun(card, train, step_model)
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               lm_mesh["one_by_one"]["serve"][
                                   "layer0_max_abs_err"])
    flash["max_abs_err"] = max([flash["max_abs_err"]] + [
        c["max_abs_err"] for f in families["serve"].values()
        for c in f["kernel_vs_plain"].values()])
    lost = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")]
    if lost:
        raise PhaseFailed(f"imported {lost}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in keys}
                                  for kernel in (search, latency, conv,
                                                 flash, flash_f32)]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
