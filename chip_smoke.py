#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gala_tpu_torch) once on one NVIDIA GPU and
check it.  Usage, from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, exits non-zero
and prints no "ok" line:

1. device   needs torch.cuda; prints the card's name and power limit.
2. build    builds the four kernel libraries from gala_tpu_torch/csrc/
            (the bell SpMM with its sampled form, the three attention
            kernels, the SDDMM, the row gather), one nvcc each,
            started together with the
            toolchain probe (ops.kernels._build.toolchain_available: a
            child process builds and launches csrc/probe.cu, x * 2), for
            sm_90a into gala_tpu_torch/_build/; prints ptxas's registers
            and spills (fails if the SpMM's pass 1, its sampled form, the
            attention forward's, bwd1's, bwd2's, their merge's or the
            SDDMM's kernels spill, at f32 and bf16), the probe's answer (fails unless
            True) and its kernel against x * 2 in this process, bitwise,
            at n = 1, 3, 16,384 and 2^20 + 3 and on views one float in,
            then timed beside torch.mul at its 128 x 128 tile and at 2^26
            floats (medians of 5 runs with their min-max, and the host's
            time per call at the tile), and, from the CUDA runtime, the
            launch limits of the unit kernels (registers, static and
            dynamic shared memory per block, resident blocks per SM;
            fails if no block fits).
3. train    the port's GCN path, as a user calls it: compile
            __graft_entry__.GCN_DSL (2-layer GCN, hidden 32) on the Arxiv
            stand-in at full size (scale 1.0, strategy auto -> bell) on
            "cuda", then train 20 epochs (warmup 2).  The kernel's launch
            counts are zeroed just before and read just after; the run
            must have launched the kernel and never run the plain version
            on the card, with finite falling loss and test accuracy >= 0.7.
4. kernel   the kernel against its plain PyTorch version on the card, on
            the layouts of that run (the full graph, a training subgraph
            and its transpose) and on a generated graph with hubs,
            self-loops and isolated rows, at F = 1, 32 and 128 (plus
            ragged widths on the generated graph).  Tolerance, per
            element, in f32: |kernel - plain| <= 1e-4 + 1e-4 * (|A| @ |x|).
            A row's rounding error grows with the magnitudes of its terms
            (up to 6,656 on a hub row), not with the result, which
            cancellation can make small; the two sum in different orders,
            and the plain version's hub sum (index_add_) is not even
            bitwise reproducible on CUDA.  Two calls of the kernel must be
            bitwise equal.  Then the kernel's and the plain version's
            times at the path's shapes (CUDA events, after a warm-up), the
            kernel's on the full layout against the same layout without
            its rows over 128 slots (the hub tail, per slot), and
            torch.sparse.mm's on the CSR form of the full layout's matrix
            (the library yardstick, held to the kernel first), beside the
            bound.
5. gat      the port's GAT path: compile __graft_entry__.GAT_DSL (2-layer
            GAT, hidden 32, one head) on the Arxiv stand-in at full size on
            "cuda" (strategy auto -> bell, fused attention layout) and
            train 20 epochs (warmup 2).  Every launch count is zeroed just
            before and read just after: the attention forward and bwd2
            kernels must have launched, no plain version may have run on
            the card, the bell SpMM must not have launched; finite falling
            loss and max test accuracy >= 0.6.
6. attn-kernel  the three attention kernels against their plain versions
            on the card (ops.kernels.attn_bell.compare_with_plain, whose
            docstring states the tolerance: 1e-4 + 1e-4 * the magnitudes
            of the summed terms), bwd1 also against the flash identity, on
            the GAT run's full-graph and training-subgraph layouts and on
            the generated hub graph, at (hf, H) = (32, 1), (40, 1), (32, 4),
            the padded (41, 1), (21, 3) (heads of 41 and 7 at their
            row pitch, 44 and 8 columns; 48 and 8 in the bf16 forward)
            and gat_heads(8, out=8)'s (64, 8), (328, 8) (8 heads of 41
            at 352 columns; 384 in the bf16 forward),
            and two forward calls bitwise equal; bwd1 (over the fwd
            layout's work units) and bwd2 (over the transpose layout's)
            also against their units emulations and a second call,
            bitwise, there and on the hub graph with masked units; then
            attention_aggregate forward and backward on the hub graph on
            the card against the same call on CPU tensors (same tolerance
            form), where a padded shape launches the forward's 16-byte
            form (<4> f32, <8> bf16) and bwd2's 4-column one, as does a
            many-head shape, each at its head template (<.., 1> at one
            head, <.., 8> at more: the heads across lanes); then
            each kernel's and plain version's times at the GAT
            path's shapes, and each kernel's on the full layout against
            the layout without its rows over 128 slots (bwd1 and bwd2
            fail above 1.5x per slot).
7. gat-edge the port's edge-valued GAT path: GAT_DSL with the
            attention_fusion pass off (the reference GALA's own GAT: SDDVV,
            leaky ReLU, edge softmax, SpMM with edge values) on the Arxiv
            stand-in at full size on "cuda", strategy auto -> ell, 20
            epochs (warmup 2).  The SpMM kernel (forward and dx on the ELL
            layouts, per-slot values) and the SDDMM kernel (the values'
            gradient) must have launched, no attention kernel and no plain
            version on the card; finite falling loss, max test accuracy
            >= 0.6.
8. sddmm-kernel  the SDDMM kernel against its plain version on the card,
            on that run's full-graph and training-subgraph edge lists at
            F = 1, 32 and 40 and on the generated hub graph's at F = 1,
            33, 40 and 128, and against a second call, bitwise.
            Tolerance per edge, in f32: |kernel - plain| <=
            1e-4 + 1e-4 * sum_f |a||b| (the plain version on |a|, |b|).
            Then the SpMM kernel with learned per-slot values on the ELL
            layout and its transpose against the row-descriptor plain
            version (phase 4's tolerance form), on the full graph and
            every training subgraph at F = 1, 32, 40 and 128 (the widths
            phases 7 and 9 give it) and on the generated hub graph at F =
            1, 33, 40 and 128; then the SDDMM kernel's, its plain
            version's and torch.sparse.sampled_addmm's times (the library
            call on the edge pattern, held to the kernel first) at F = 1,
            32 and 40 on the full graph, with the lane width it took (16
            bytes, 4 f32 elements, at F = 32 and 40).
9. gcn-sparser  GCN_DSL with `G = G.is_sparser(true);` (the sparsity-
            aware rewrite: precomputed edge values norm_src * norm_dst)
            on the same graph, strategy auto -> ell, 20 epochs: the SpMM
            kernel must have launched and the SDDMM kernel not (the
            values need no gradient); finite falling loss, max test
            accuracy >= 0.7.
10. sage    examples/sage.txt (2-layer GraphSAGE, mean aggregation, self
            FFN) with the Arxiv stand-in bound through data= (the DSL
            names Reddit), strategy auto -> bell, 20 epochs: the SpMM
            kernel must have launched; max test accuracy >= 0.6.
11. gin     examples/gin.txt (2-layer GIN, learned epsilons) on the
            Arxiv stand-in, the same checks; both epsilons finite and
            moved from 0.
12. sage-minibatch  train_sage_minibatch with gala_tpu's defaults
            (fanouts 25/10, batch 512, hidden 32, 10 epochs) on the Arxiv
            stand-in: the gather kernel launched exactly 3 x batches x
            epochs times, the SpMM kernel in validation, no plain version
            on the card; finite falling loss, max test accuracy >= 0.6.
            Prints epoch seconds, sampled edges/s and peak memory.
13. gather-kernel  the gather kernel against index_select, bitwise, at
            the path's shapes (the 169,343 x 128 table, one batch's t, n1
            and n2: 512, 12,800 and 128,000 rows) and at F = 1, 33, 128,
            602 in f32 and bf16 with M = 0, 1, 2,047, 2,049, 12,800,
            random and sorted indices; then the kernel's, the plain
            version's and torch.index_select's times at the n2 shape.
14. cli     `python -m gala_tpu_torch inference_sample examples/gin.txt
            --iters 8`, in-process on the default device (the card):
            three finite CSV fields.

Then int64 indices and column tiling, on the stand-in of the data step:
long-kernel  the Arxiv stand-in's bell and fused-attention layouts with
            their slots after 2^31 unused ones (ops.graph.shifted_slots:
            every work-unit start past 2^31, ~17 GB a layout, one at a
            time): the SpMM (f32 and bf16), attention fwd, bwd1 and bwd2
            against their plain versions on the layout itself (phases 4
            and 6's tolerances) and bitwise against themselves there;
            peak memory printed.
inference-long  GCN_DSL inference compiled with lower(use_long=True), the
            inference_long driver (int64 edge ids): its CSV line of 8
            epochs.  Then two graphs from one relabelled host graph with
            long_indices True and False: logits bitwise equal under the
            same weights, and inference ms/epoch of each, run in turns.
col-tile    table5's `dir` schedule, GCN_DSL + `G=G.col_tile(37000);`:
            inference on segment_scan and on bell (8 epochs, the SpMM
            kernel launched), 20 training epochs on bell (accuracy >=
            0.7), every layout's units in one column tile each, tile-major;
            the fused GAT with the tile, 20 epochs (accuracy >= 0.6: a
            shorter run validates only after its first step).  Each kernel
            on those tiled layouts against its plain version, f32 and bf16
            (the SpMM at F = 1, 32, 128 on the edge list, the full bell and
            the training subgraph's bell and transpose; attention fwd, bwd1
            and bwd2 at hf = 32, 40 on the full and training layouts;
            phases 4 and 6's tolerances); the SpMM kernel's times on the
            full bell tiled and untiled at F = 1, 32, 128, with units and
            partial rows.

Then table7's sampling schedules (scripts/evaluate.py job_table7, k =
20), each GCN_DSL plus one line, on the Arxiv stand-in loaded in phase
10's data step, strategy auto -> bell, for the DSL's own 100 epochs
(m1.train(iters=100), what table7 runs; warmup 2): at 20 epochs the
sampled programs have not learned yet (0.35-0.60 test accuracy in the
port's CPU run at scale 0.1), and 80 more epochs cost well under a
second on the card:
15. sample-none     GCN_DSL alone, table7's baseline row at the same
            epoch count: the SpMM kernel launched, no weights kernel.
16. sample-data     `G=G.sample(20);`: the graph resampled on the host
            (at most 20 in-edges a node); the SpMM kernel launched, no
            plain version on the card, no weights kernel; finite falling
            loss, max test accuracy >= 0.6; train and inference ms/epoch,
            accuracy and peak memory printed.
17. sample-kernel   `aggrFn=aggrFn.sample(20);`: the same resample, the
            degrees the constant 20; the same checks.
18. sample-dynamic  `aggrFn=aggrFn.sample(20).dynamic();`: every
            aggregation sampled, every graph built with its sampling
            inputs; every SpMM launch (forward and transpose) is the
            sampled form, bell_spmm_dyn, which computes the weights of
            the epoch's fresh (ra, rb) in its staging: no launch of a
            weights kernel; the same checks.
19. sample-dynamic-segment  the dynamic program at strategy segment (the
            edge-list layouts, value 1 a pick), 5 epochs: the same launch
            checks (no validation epoch after the first: no accuracy asked).
20. dyn-weights-kernel  the SpMM's sampled form on phase 18's
            full-graph, training-subgraph and transpose layouts and on the
            generated hub graph, at k = 1, 20 and 300, with the
            structural values, at F = 1, 32, 128: against the plain
            version (the plain weights into the row-descriptor plain
            SpMM; phase 4's tolerance form on the weights' magnitudes) and
            bitwise against the two-step path (the SpMM kernel run with
            the plain weights as its values), at bf16 too at F = 32; then
            its time at k = 20, F = 32 on the full bell beside the
            two-step recipe's SpMM (the weights made once beforehand), the
            plain version's and the bound (medians of 5 runs, min-max).

Then bf16 activations with f32 params (dtype=torch.bfloat16, gala_tpu's
mixed precision), on the same stand-in; each phase is its f32
counterpart's with bf16 inputs and the bf16 forms of the kernels, whose
launches count as "<kernel>_bf16":
21. train-bf16  GCN_DSL at bf16, 20 epochs: bell_spmm_bf16 launched, no
            plain version on the card, accuracy >= 0.7, bf16 features and
            f32 params after training.
22. kernel-bf16  phase 4 on bf16 inputs: the plain version computes in
            f32 from the same bf16 values and rounds once, so the
            tolerance is phase 4's plus one bf16 unit in the last place of
            the larger of the two results; times beside the bound with
            bf16 bytes, and torch.sparse.mm on a bf16 CSR matrix.
23. gat-bf16    GAT_DSL at bf16, 20 epochs: attn_fwd_bf16 and attn_bwd2_bf16
            launched, accuracy >= 0.6.
24. attn-kernel-bf16  phase 6 with x, vl, vr and dout in bf16 (the
            kernels' outputs are f32 at both types: phase 6's tolerance;
            attention_aggregate's bf16 out and gradients one unit more).
25. gat-edge-bf16  the unfused GAT at bf16, 5 epochs: sddmm_bf16 and
            bell_spmm_bf16 launched (no validation epoch after the first,
            so no accuracy is asked).
26. sddmm-kernel-bf16  phase 8 on bf16 operands (bf16 dots: one unit of
            slack; lanes of 8 bf16 elements, 16 bytes, at F = 32 and
            40), sampled_addmm on a bf16 pattern where the library
            takes one.
27. sage-minibatch-bf16  2 epochs from a bf16 feature table: 3 gather
            launches a batch (the byte-copy kernel takes both types),
            bell_spmm_bf16 in validation, accuracy >= 0.6.
28. gather-kernel-bf16  phase 13's path shapes and time with the bf16
            table.
29. sample-dynamic-bf16  phase 18 at bf16, 5 epochs: every SpMM launch
            the sampled form bell_spmm_dyn_bf16 (f32 weights at both
            types), no weights kernel.
NO_SPILL holds the bf16 forms of bwd1, bwd2 and the SDDMM too, and the
SpMM's sampled form at both types.

Then checkpoint/resume, failure recovery, profiling and the evaluation
twin, in f32 on the same stand-in; each phase zeroes every launch count
just before its run and reads them just after:
30. csr-stable  GCN_DSL compiled twice (lower's bell_order relabel and
            training subgraphs rebuild CSRs of 2.1M edges through the
            native counting sort, now stable): every tensor of the
            layouts bitwise equal; compile seconds with the stable sort
            and with the atomic-cursor sort of the copied csr_ops.cpp it
            replaced (native.coo_to_csr_cursors), and the native builds'
            seconds inside each.
31. pallas-bell GCN_DSL at strategy pallas_bell: the bell layout, every
            tensor equal to the stable compile's; 20 epochs (the SpMM
            kernel launched, no plain version, accuracy >= 0.7); logits
            from the same weights bitwise those of strategy bell.
32. checkpoint  GCN_DSL (f32, bell) and examples/gin.txt (learned
            epsilons) at full width: an unbroken 20-epoch run, twice (the
            atomics' spread: the row gathers' backward adds with
            atomics), against 10 epochs with checkpoint_path and 10 more
            with resume_from (valid_step 5 keeps the schedule aligned):
            losses within rtol 1e-4, final params within rtol 1e-3 / atol
            1e-5; the SpMM kernel launched in both segments.
33. recovery    resilience.train_with_recovery, 24 epochs of GCN_DSL in
            segments of 8, one injected failure: the progress file reads
            24, accuracy >= 0.7, a second call raises "already completed".
34. profile     utils.profiling.profile_trace around 3 training epochs in
            a marker region: the Chrome trace names the SpMM kernel (its
            symbol read from the trace, matched to the build's ptxas
            entries) and the region; no warning of a trace without device
            activity.
35. evaluate    scripts/evaluate_torch.py in-process: fig16 on Cora, 10
            epochs, at strategy auto and at pallas_bell (tag pallas): the
            bell rows launch the SpMM and the fused GAT's forward and
            bwd2; the rows well-formed and finite, every job's CSV header
            equal to scripts/evaluate.py's (read from its text).
36. export      GCN_DSL and the fused GAT_DSL (one head) on bell on the
            same stand-in: gala_tpu_torch.export.export_compiled on cuda
            (the kernels as the custom ops of ops.kernels.library), then a
            fresh python3 loads the artifact (importing no parser, IR,
            passes or lowering module), its forward bitwise the live
            cm.forward under the same weights, and replays 20 epochs: the
            SpMM (GCN), attention forward and bwd2 (GAT) launched there,
            no plain version on the card, accuracy >= 0.7 / 0.6; export
            and load seconds, artifact MB, and the replay's train and
            inference ms/epoch beside the live [train] and [gat] runs'.

Then the sharded path (gala_tpu_torch.parallel), on the same stand-in:
37. spmd        the single-device port's logits, invariant prefix and
            gradients of sum(logits^2) under make_params(0) for GCN_DSL,
            GAT_DSL, GCN_DSL + `G = G.is_sparser(true);` and the unfused
            GAT; [spmd-kernel]: the SpMM (forward, transpose, per-slot
            values), attention (fwd, bwd1, bwd2) and SDDMM kernels against
            their plain versions on each of 2 ranks' own layouts (the
            [local | halo | zero] gather table) of those programs' host
            graphs (phases 4, 6 and 8's tolerances); then 4 gloo ranks
            spawned on cuda:0 (NCCL refuses two ranks on one device; gloo
            takes the CUDA tensors and exchanges through host memory) run
            shard_compiled(use_bell=True) at 2 shards: [spmd-gcn] 20 epochs
            (accuracy >= 0.8, bell_spmm on each rank), [spmd-gat] 20
            epochs (>= 0.7, attn_fwd and attn_bwd2 on each rank), [spmd-ev]
            the sparse GCN 5 epochs (the learned-value bell SpMM; its
            precomputed values take no gradient, so no SDDMM), [spmd-ev-gat]
            the unfused GAT 5 epochs (one SDDMM per learned-value SpMM
            backward), [spmd-tp] GCN on a 2 x 2 mesh (col/row FFN splits):
            every run's logits, prefix and gradients within 1e-4 of the
            largest of the single device's, no plain version on the card,
            the halo's H and bytes per exchange and each rank's ms/epoch
            printed (2 ranks on one card: not a scale-out time); then
            [spmd-nccl], one NCCL rank, GCN 5 epochs, the same checks, and
            GCN on NCCL over every card where the host has two or more.
38. pp          the pipeline (gala_tpu_torch.parallel.pp), its jobs in the
            same spawns: [pp-gpipe] gpipe over 4 gloo ranks on cuda:0,
            linear + relu stages at B = 512, W = 832 (the SAGE activation's
            width), 8 microbatches, output and each stage's gradient of
            sum(out^2) within 1e-5 of the largest of the sequential
            product on the card; [pp-sage] make_sage_pipeline over 2 gloo
            ranks (ranks 0-1), train_sage_minibatch's defaults (fanouts
            25/10, batch 512, hidden 32) on one epoch's microbatches a
            step, 20 steps: step 1's loss (rtol 1e-5), gradients (1e-5 of
            the largest) and merged params (rtol 1e-4, atol 1e-5) against
            a sequential step on the card
            from the same init, falling losses, the merged params'
            full-graph accuracy within 0.005 of the sequential run's, the
            gather kernel 3 x n_micro x steps on stage 0 and never on stage
            1, the SpMM in validation, no plain version on the card; each
            stage's ms a step, the bubble, bytes a shift, peak memory;
            [pp-nccl] gpipe over one NCCL rank against its one-stage
            product, and the SAGE pipeline over NCCL ranks 0-1 where the
            host has two cards or more.

Every kernel's bound is the larger of its bytes (each input read once,
each output written once, in its own dtype) over 3.35 TB/s and its
operations over 67 TFLOP/s (f32 outside the tensor cores: the bf16
forms compute in f32; the weights kernel's k integer steps a slot at the
same scalar rate), from this run's inputs.  It ends with each
phase's seconds, a JSON line of the kernels (launches on the main path
of each kernel's phase, times, bound, library call; each bf16 form
beside its f32 time), the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-4
WIDTHS = (1, 32, 128)
KERNEL_SOURCE = "gala_tpu_torch/csrc/bell_spmm.cu"
REPLACES = "gala_tpu/ops/pallas/bell_spmm.py:440"
ATTN_SOURCE = "gala_tpu_torch/csrc/attn_bell.cu"
ATTN_REPLACES = {
    "attn_fwd": "gala_tpu/ops/pallas/attn_bell.py:174",
    "attn_bwd1": "gala_tpu/ops/pallas/attn_bell.py:307",
    "attn_bwd2": "gala_tpu/ops/pallas/attn_bell.py:456",
}
# (hf, H); the GAT path runs (32, 1), (40, 1); (41, 1) and (21, 3) run at a row pitch;
# gat_heads(8, out=8) runs (64, 8) and (328, 8), eight heads of 41 pitched to 352 columns
ATTN_SHAPES = ((32, 1), (40, 1), (32, 4), (41, 1), (21, 3), (64, 8), (328, 8))
SLOPE = 0.2
SDDMM_SOURCE = "gala_tpu_torch/csrc/sddmm.cu"
SDDMM_REPLACES = "gala_tpu/ops/pallas/sddmm.py:183"
SDDMM_WIDTHS = (1, 32, 40)  # timed; the gat-edge path runs 32 and 40
PROBE_SOURCE = "gala_tpu_torch/csrc/probe.cu"
PROBE_REPLACES = "gala_tpu/ops/pallas/__init__.py:29"
LIMITS_SOURCE = "gala_tpu_torch/csrc/unit_gather.cuh"
LIMITS_REPLACES = "scripts/pallas_bisect.py:40"
# kernels redesigned since the first slices: ptxas must report no spill for them,
# and for the bf16 forms of those that have one (the merge sums f32 partials at
# both types, so it has none)
NO_SPILL = ("spmm_unit_kernel", "attn_fwd_kernel", "attn_bwd1_kernel", "attn_bwd2_kernel",
            "attn_merge_sum_kernel", "sddmm_kernel")
NO_SPILL_BF16 = ("spmm_unit_kernel", "attn_fwd_kernel", "attn_bwd1_kernel", "attn_bwd2_kernel",
                 "sddmm_kernel")
BF16_MANGLED = "__nv_bfloat16"  # in the mangled name of every bf16 instantiation
# the SpMM's sampled form: template argument `true` (SAMPLED) in its mangled name
SAMPLED = ("spmm_unit_kernel", "Lb1E")
BF16 = torch.bfloat16
TAIL_LIMIT = 1.5
GATHER_SOURCE = "gala_tpu_torch/csrc/gather_rows.cu"
GATHER_REPLACES = "gala_tpu/ops/pallas/gather.py:77"
GATHER_WIDTHS = (1, 33, 128, 602)  # 602: the Reddit stand-in's width
GATHER_ROWS = (0, 1, 2047, 2049)
PROBE_SIZES = (1, 3, 16384, 2**20 + 3)  # the probe kernel against x * 2, bitwise
PROBE_TIMED = {"128x128": (128, 128), "2^26": (2**26,)}  # its tile; 512 MB moved
# the least time of a call: the larger of its bytes over the HBM rate and
# its operations over the f32 rate outside the tensor cores (NVIDIA's H100
# SXM data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# table7's sampling schedules (scripts/evaluate.py job_table7), k = 20, run
# for the DSL's own 100 epochs (m1.train(iters=100)), as table7 runs them
SAMPLE_K = 20
SAMPLE_LINES = {"none": "", "data": f"G=G.sample({SAMPLE_K});",
                "kernel": f"aggrFn=aggrFn.sample({SAMPLE_K});",
                "dynamic": f"aggrFn=aggrFn.sample({SAMPLE_K}).dynamic();"}
SAMPLE_ITERS = 100
DYN_SOURCE = "gala_tpu_torch/csrc/bell_spmm.cu"  # the SpMM's sampled form makes the weights
DYN_REPLACES = "gala_tpu/ops/spmm.py:894"  # XLA _dyn_counts / _dyn_reweight: no Pallas kernel
LONG_SHIFT = 2**31  # unused slots before a layout's own: every unit start past 2^31
COL_TILE = 37000  # table5's `dir` schedule, G=G.col_tile(37000) (scripts/evaluate.py:222)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, from CUDA events around `reps` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_runs(fn, runs=5, reps=20):
    """Median and (min, max) of `runs` cuda_ms readings of `reps` calls."""
    t = sorted(cuda_ms(fn, reps=reps) for _ in range(runs))
    return statistics.median(t), (t[0], t[-1])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def dtag(tag: str, dtype) -> str:
    """A phase's tag at `dtype`: the f32 phase's own, "-bf16" appended."""
    return tag if dtype == torch.float32 else f"{tag}-bf16"


def slack(got, want):
    """One bf16 unit in the last place where the result is bf16 (each side
    rounds its f32 sum once), 0 at f32: ops.kernels._build.rounding_slack."""
    from gala_tpu_torch.ops.kernels._build import rounding_slack

    return rounding_slack(got, want)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): each input read once and each output written
    once at the HBM rate, against the operations at the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layout_bytes(lay, vals=None) -> int:
    """What a kernel reads of a row-descriptor layout (BellDev, SlotRows)."""
    return nbytes(lay.flat_cols, lay.flat_vals if vals is None else vals, lay.row_start,
                  lay.row_len, lay.row_node, lay.diag)


def layout_csr(lay, n_out: int, n_src: int):
    """The matrix a row-descriptor layout holds, as a torch CSR tensor
    (row_node[i] gets slots [row_start[i], row_start[i] + row_len[i]),
    plus the diagonal): the input of the library call timed beside the
    SpMM kernel.  Padding slots add explicit zeros."""
    lens = lay.row_len.long()
    first = torch.cumsum(lens, 0) - lens
    slot = (torch.repeat_interleave(lay.row_start - first, lens)
            + torch.arange(int(lens.sum()), device=lens.device))
    rows = torch.repeat_interleave(lay.row_node.long(), lens)
    cols, vals = lay.flat_cols.long()[slot], lay.flat_vals[slot]
    if lay.diag is not None:
        ids = torch.arange(lay.diag.shape[0], device=lens.device)
        rows, cols = torch.cat([rows, ids]), torch.cat([cols, ids])
        vals = torch.cat([vals, lay.diag[:, 0]])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n_out, n_src),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def tail_ratio(tag, what, lay, call):
    """`call(layout)`'s time on the full layout and on the same layout
    without its rows over UNIT_SLOTS slots (ops.graph.select_rows), and
    the ratio of the two times per slot: near 1 when a slot of a long row
    costs what a slot of a short one does.  Each time is the median of 5
    readings of 20 calls taken in turns, full then short: a single reading
    can catch a dip of the card's clock.  Returns (full ms, short ms,
    ratio)."""
    from gala_tpu_torch.ops.graph import UNIT_SLOTS, select_rows

    short = select_rows(lay, lay.row_len <= UNIT_SLOTS)
    slots_full, slots_short = int(lay.row_len.sum()), int(short.row_len.sum())
    readings = [(cuda_ms(lambda: call(lay), reps=20), cuda_ms(lambda: call(short), reps=20))
                for _ in range(5)]
    t_full, t_short = (statistics.median(r) for r in zip(*readings))
    ratio = (t_full / slots_full) / (t_short / slots_short)
    print(f"[{tag}] tail, {what}: full layout {t_full:.4f} ms ({slots_full} slots), without "
          f"its rows over {UNIT_SLOTS} slots {t_short:.4f} ms ({slots_short} slots); time per "
          f"slot full / short {ratio:.3f}")
    return t_full, t_short, ratio


def hub_graph(device, attention=False, strategy="bell", dynamic_sample=False):
    """Weighted directed graph on 5,000 nodes: node 0 has in-degree 3,000
    (24 virtual rows of the binned layout), node 1 out-degree 2,000 (a hub
    of the transpose), every second node a self-loop, the last 500 nodes
    no edges."""
    from gala_tpu_torch.data.csr import coo_to_csr
    from gala_tpu_torch.ops.graph import Graph

    rng = np.random.default_rng(0)
    n = 5000
    src = np.concatenate([rng.integers(0, 4500, 40000), rng.integers(0, 4500, 3000),
                          np.full(2000, 1), np.arange(0, 4500, 2)])
    dst = np.concatenate([rng.integers(0, 4500, 40000), np.zeros(3000, np.int64),
                          rng.integers(0, 4500, 2000), np.arange(0, 4500, 2)])
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    host = coo_to_csr(src, dst, vals, n_rows=n)
    return host, Graph.from_host(host, strategy=strategy, device=device, attention=attention,
                                 edge_vals=strategy != "bell", dynamic_sample=dynamic_sample)


def check_units(ak, kind, what, lay, *args, tag="attn-kernel"):
    """bwd1 or bwd2 over units against its plain version and its units
    emulation (compare_with_plain's tolerance: 1e-4 + 1e-4 * the plain
    version on magnitudes) and against a second call, bitwise.  kind
    "bwd1": args x, vl, vr, dout, m, s on a fwd layout (its sds, A, B side
    by side); "bwd2": x, vl, w_tab, c_pad on a transpose layout.  Returns
    the largest |kernel - plain|."""
    if kind == "bwd1":
        x, vl, vr, dout, m, s = args
        call = lambda fn: torch.cat(fn(lay, x, vl, vr, dout, m, s, SLOPE), dim=1)  # noqa: E731
        a_sds, _, a_b = ak.attn_bwd1_reference(lay, x.abs(), vl, vr, dout.abs(), m, s, SLOPE)
        scale = torch.cat([a_sds, a_sds, a_b], dim=1)
    else:
        x, vl, w_tab, c_pad = args
        nh = vl.shape[1]
        d = w_tab.shape[1] - 4 * nh  # dout's block, at the table's pitch
        call = lambda fn: fn(lay, x, vl, w_tab, SLOPE, c_pad)  # noqa: E731
        a_tab = torch.cat([w_tab[:, :d].abs(), w_tab[:, d : d + 3 * nh],
                           -w_tab[:, d + 3 * nh :].abs()], dim=1)
        scale = ak.attn_bwd2_reference(lay, x.abs(), vl, a_tab, SLOPE, c_pad)
    kernel, plain, units = (getattr(ak, f"attn_{kind}{end}")
                            for end in ("", "_reference", "_units_reference"))
    got, again = call(kernel), call(kernel)
    torch.cuda.synchronize()
    errs = {}
    for name, want in (("plain", call(plain)), ("units emulation", call(units))):
        err = (got - want).abs()
        errs[name] = (err.max().item(), int((err > ATOL + RTOL * scale).sum()))
    same = torch.equal(got, again)
    print(f"[{tag}] {kind} over units, {what}: max |kernel - plain| "
          f"{errs['plain'][0]:.2e}, - units emulation {errs['units emulation'][0]:.2e}; "
          f"{sum(v[1] for v in errs.values())} elements out of tolerance; two calls bitwise "
          f"equal: {same}")
    if any(v[1] for v in errs.values()) or not torch.isfinite(got).all():
        raise AssertionError(f"{kind} {what}: out of tolerance {errs}")
    if not same:
        raise AssertionError(f"{kind} {what}: two calls differ")
    return errs["plain"][0]


def spills(log: str) -> dict:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    ptxas's -v report in an nvcc log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), int(m.group(2)))
    return out


def _train_checked(tag, cm, min_accuracy, iters=20):
    """`iters` epochs (warmup 2) of a compiled model with every launch
    count zeroed just before; prints and checks the run (at bf16 also the
    bf16 features and the f32 params after training).  Returns the result
    and the run's launches by kernel."""
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

    reset_counts()
    t0 = time.perf_counter()
    res = cm.train(iters=iters, warmup=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in all_counts().items()}
    on_cuda = {name: c.reference_calls_on_cuda for name, c in all_counts().items()}
    print(f"[{tag}] csv {res.csv(print_accuracy=True)}")
    print(f"[{tag}] seconds/epoch: train {res.total_time:.6f}, inference "
          f"{res.inference_time:.6f}; {iters} epochs with accuracy in {train_s:.1f} s")
    print(f"[{tag}] losses {json.dumps([round(v, 5) for v in res.losses])}")
    print(f"[{tag}] accuracies {json.dumps([round(v, 5) for v in res.accuracies])}")
    print(f"[{tag}] kernel launches {json.dumps(launches)}, plain-version calls on cuda "
          f"{json.dumps(on_cuda)}")
    print(f"[{tag}] peak memory allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    if any(on_cuda.values()):
        raise AssertionError(f"[{tag}] the path ran plain versions on the card: {on_cuda}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"[{tag}] non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"[{tag}] loss did not fall: {res.losses[0]} -> {res.losses[-1]}")
    if res.max_accuracy < min_accuracy:
        raise AssertionError(f"[{tag}] max test accuracy {res.max_accuracy} < {min_accuracy}")
    g = cm.full_graphs[0]
    with torch.no_grad():
        logits = cm.forward(res.params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
    if logits.shape != (g.n_pad, cm.n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"[{tag}] logits {tuple(logits.shape)} not finite or not "
                             "(n_pad, classes)")
    dtypes = sorted({str(p.dtype) for p in res.params.parameters()})
    print(f"[{tag}] features {cm.x.dtype}, logits {logits.dtype}, params {', '.join(dtypes)}")
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"[{tag}] params not all f32 after training: {dtypes}")
    return res, launches


def phase_train(gala_tpu_torch, dtype=torch.float32, data=None):
    """GCN_DSL on the Arxiv stand-in; at bf16 (dtype=torch.bfloat16, the
    features bf16, params f32) from `data`, the stand-in loaded once."""
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.ops.kernels._build import dtype_counts

    tag = dtag("train", dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", scale=1.0, device="cuda",
                                       dtype=dtype, data=data)
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    print(f"[{tag}] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges, {int(cm.x.shape[1])} features, {cm.n_classes} classes, "
          f"{g.bell.flat_cols.shape[0]} slots, {len(g.bell.bin_ks)} bins, {g.bell.n_big} hubs")
    if g.strategy != "bell" or cm.x.dtype != dtype:
        raise AssertionError(f"strategy {g.strategy}, features {cm.x.dtype}: expected bell, "
                             f"{dtype}")
    res, launches = _train_checked(tag, cm, 0.7)
    name = dtype_counts("bell_spmm", dtype).name
    if launches.get(name, 0) <= 0:
        raise AssertionError(f"the main path never launched the {name} kernel")
    return cm, launches[name], res


def phase_kernel(cm, kernel, dtype=torch.float32):
    """The SpMM kernel in `dtype` (f32, or its bf16 form on bf16 features)
    against its plain version, then timed.  Returns (max |kernel - plain|,
    times)."""
    from gala_tpu_torch.data.csr import densify

    tag = dtag("kernel", dtype)
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    if sub.bell.out_index is None or sub.t_bell is sub.bell:
        raise AssertionError("the training subgraph should have its own order and transpose")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    layouts = [
        ("arxiv full bell", full.bell, full.c_pad, full.n_pad),
        ("arxiv subgraph bell", sub.bell, sub.c_pad, sub.n_pad),
        ("arxiv subgraph t_bell", sub.t_bell, sub.n_pad, sub.c_pad),
    ]
    hub_host, hub = hub_graph("cuda")
    layouts += [("hub graph bell", hub.bell, hub.c_pad, hub.n_pad),
                ("hub graph t_bell", hub.t_bell, hub.n_pad, hub.c_pad)]

    max_err = 0.0
    for name, lay, rows, n_out in layouts:
        if (lay.flat_vals < 0).any() or (lay.diag is not None and (lay.diag < 0).any()):
            raise AssertionError(f"{name}: negative values, |A| @ |x| needs |A|")
        for f in WIDTHS + ((33, 40) if name.startswith("hub") else ()):
            x = rand(rows, f)
            out = kernel.bell_spmm(lay, x, n_out)
            ref = kernel.bell_spmm_reference(lay, x, n_out)
            scale = kernel.bell_spmm_reference(lay, x.abs(), n_out).float()  # |A| @ |x|
            err = (out.float() - ref.float()).abs()
            bad = int((err > ATOL + RTOL * scale + slack(out, ref)).sum())
            max_err = max(max_err, err.max().item())
            same = torch.equal(out, kernel.bell_spmm(lay, x, n_out))
            print(f"[{tag}] {name} F={f}: max |kernel - plain| {err.max().item():.3e}, "
                  f"max of that / (|A| @ |x|) {(err / scale.clamp_min(1e-30)).max().item():.3e}, "
                  f"{bad} elements out of tolerance; a second call bitwise equal: {same}")
            if bad or out.dtype != dtype:
                raise AssertionError(f"{name} F={f}: {bad} elements out of tolerance, "
                                     f"result {out.dtype}")
            if not same:
                raise AssertionError(f"{name} F={f}: two calls of the kernel differ")
    # the generated graph against the dense product, in float64 (at bf16 the
    # kernel rounds each value to bf16, by at most 2^-9 of it, and the
    # layout's diagonal sums a node's self-loops before that: 2^-8 |A| @ |x|)
    x = rand(hub.c_pad, 32)
    a = torch.from_numpy(densify(hub_host)).double()
    dense = a @ x[: hub.n_cols].double().cpu()
    scale = a @ x[: hub.n_cols].double().abs().cpu()
    got = kernel.bell_spmm(hub.bell, x, hub.n_pad)[: hub.n_nodes]
    err = (got.double().cpu() - dense).abs()
    rounding = 0.0 if dtype == torch.float32 else 2.0**-8 * scale
    print(f"[{tag}] hub graph F=32 vs dense A @ x in float64: max err {err.max().item():.3e}")
    if (err > ATOL + RTOL * scale + rounding + slack(got.cpu(), dense.float())).any():
        raise AssertionError("the kernel disagrees with the dense product")

    timings = {}
    for name, lay, rows, n_out in layouts[:3]:
        for f in WIDTHS:
            x = rand(rows, f)
            t_kernel = cuda_ms(lambda: kernel.bell_spmm(lay, x, n_out), reps=20)
            t_plain = cuda_ms(lambda: kernel.bell_spmm_reference(lay, x, n_out), reps=5)
            timings[(name, f)] = (t_kernel, t_plain)
            print(f"[{tag}] time {name} F={f}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")
    # the hub tail: the full layout against the same layout without its
    # rows over UNIT_SLOTS slots, per slot
    for f in WIDTHS:
        x = rand(full.c_pad, f)
        timings[("tail", f)] = tail_ratio(
            tag, f"arxiv full bell F={f}", full.bell,
            lambda lay: kernel.bell_spmm(lay, x, full.n_pad))

    # the library's one call for the same product: torch.sparse.mm on a CSR
    # tensor of the full layout's matrix (checked against the kernel first;
    # at bf16 a bf16 CSR matrix, where the library takes one)
    csr = layout_csr(full.bell, full.n_pad, full.c_pad)
    if dtype != torch.float32:
        csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      csr.values().to(dtype), csr.shape)
    for f in WIDTHS:
        x = rand(full.c_pad, f)
        out = kernel.bell_spmm(full.bell, x, full.n_pad)
        ms, by = bound(layout_bytes(full.bell) + nbytes(x, out),
                       2 * (full.bell.flat_cols.numel() + full.n_pad) * f)
        timings[("bound", f)] = (ms, by)
        t_lib = library_call(tag, "torch.sparse.mm", lambda: torch.sparse.mm(csr, x), out,
                             kernel.bell_spmm_reference(full.bell, x.abs(), full.n_pad), f)
        timings[("library", f)] = t_lib
        print(f"[{tag}] arxiv full bell F={f}: torch.sparse.mm (CSR, {csr.values().numel()} "
              f"stored values) {t_lib if t_lib is None else f'{t_lib:.4f}'} ms; bound "
              f"{ms:.4f} ms ({by})")
    return max_err, timings


def library_call(tag, name, call, mine, scale, f):
    """The library yardstick: `call()` held to the kernel's result `mine`
    (f32 tolerance, plus one bf16 unit where the result is bf16), then
    timed.  At f32 a result out of tolerance fails the run.  At bf16 the
    yardstick is None where the library refuses the dtype or sums in less
    than f32 (out of that tolerance), and the line says which: the port
    never calls it."""
    try:
        lib_out = call()
    except (RuntimeError, NotImplementedError) as exc:
        print(f"[{tag}] {name} at F={f}: the library takes no such call: "
              f"{str(exc).splitlines()[0][:200]}")
        return None
    if lib_out.is_sparse or lib_out.layout == torch.sparse_csr:
        lib_out = lib_out.values()
    err = (lib_out.float() - mine.float()).abs()
    if (err > ATOL + RTOL * scale.float() + 2 * slack(mine, lib_out.to(mine.dtype))).any():
        if mine.dtype == torch.float32:
            raise AssertionError(f"{name} differs from the kernel at F={f}: the library "
                                 "yardstick computes something else")
        print(f"[{tag}] {name} at F={f}: not the same sum as the kernel's f32 one (max "
              f"|library - kernel| {err.max().item():.3e}, "
              f"{(err / scale.float().clamp_min(1e-30)).max().item():.3e} of the summed "
              "magnitudes): no yardstick at this dtype")
        return None
    return cuda_ms(call, reps=20)


def phase_gat(gala_tpu_torch, dtype=torch.float32, data=None):
    """GAT_DSL (fused attention) on the Arxiv stand-in; at bf16 from `data`."""
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.ops.kernels._build import dtype_counts

    tag = dtag("gat", dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(GAT_DSL, mode="train", scale=1.0, device="cuda",
                                       dtype=dtype, data=data)
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    ops = [n.op.name for n in cm.program.loop.nodes]
    print(f"[{tag}] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges; program {','.join(ops)}")
    if g.attn is not None:
        for side, lay in (("fwd", g.attn.fwd), ("t", g.attn.t)):
            print(f"[{tag}] attention layout {side}: {lay.flat_cols.shape[0]} slots, "
                  f"{len(lay.bin_ks)} bins, {lay.n_big} hubs, longest row "
                  f"{int(lay.row_len.max())} slots")
    if g.strategy != "bell" or g.attn is None:
        raise AssertionError(f"strategy {g.strategy}, attention layout {g.attn is not None}: "
                             "expected bell with the fused attention layout")
    if ops.count("FUSED_ATTENTION") != 2:
        raise AssertionError(f"expected two fused attention ops, program {ops}")
    res, launches = _train_checked(tag, cm, 0.6)
    for name in ("attn_fwd", "attn_bwd2"):
        name = dtype_counts(name, dtype).name
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the GAT path never launched the {name} kernel")
    spmm = {k: v for k, v in launches.items() if k.startswith("bell_spmm") and v}
    if spmm:
        raise AssertionError(f"the GAT path launched the bell SpMM: {spmm}")
    return cm, launches, res


def device_kernels(fn) -> list:
    """The names of the device kernels that fn() launches (torch.profiler's
    CUDA activity).  fn runs twice inside one session and the names of
    both calls come back: a session can lose its first activities (on the
    card, late in this script, one held neither the call's host-to-device
    copies nor its first kernel, which ran: its merge kernel and outputs
    were there), so a launch check reads the second call too.  A kernel
    that each call launches once is then listed twice; the launch check
    prints each one's count, so a lost record shows as x1."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type.name == "CUDA"]


def _aggregate_on(device, ab, g, inputs):
    """attention_aggregate forward + backward of sum(out * dout) on `device`."""
    from gala_tpu_torch.ops.attention import attention_aggregate

    x, vl, vr, dout = (t.to(device) for t in inputs)
    for t in (x, vl, vr):
        t.requires_grad_(True)
    out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, ab, x, vl, vr)
    (out * dout).sum().backward()
    return [t.detach().cpu() for t in (out, x.grad, vl.grad, vr.grad)]


def phase_attn_kernel(cm, ak, dtype=torch.float32):
    """The three attention kernels in `dtype` (x, vl, vr and dout in it; m,
    s, w_tab and every output f32).  Returns (max |kernel - plain| per
    kernel, times)."""
    from gala_tpu_torch.ops.graph import masked_units

    tag = dtag("attn-kernel", dtype)
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    hub = hub_graph("cuda", attention=True)[1]
    graphs = [("arxiv full", full), ("arxiv training subgraph", sub), ("hub graph", hub)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731

    max_err = {name: 0.0 for name in ak.NAMES}
    for gname, g in graphs:
        for hf, nh in ATTN_SHAPES:
            inputs = (rand(g.c_pad, hf), rand(g.c_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, hf))
            res = ak.compare_with_plain(g.attn, *inputs, SLOPE, g.n_pad, g.c_pad)
            twice = [ak.attn_fwd(g.attn.fwd, *inputs[:3], SLOPE, g.n_pad, True)
                     for _ in range(2)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*twice))
            bad = {k: v for k, v in res.items() if v[1]}
            print(f"[{tag}] {gname} hf={hf} H={nh}: max |kernel - plain| "
                  + ", ".join(f"{k} {v[0]:.2e}" for k, v in res.items())
                  + f"; {sum(v[1] for v in res.values())} elements out of tolerance; two "
                  f"forward calls bitwise equal: {same}")
            if bad:
                raise AssertionError(f"{gname} hf={hf} H={nh}: out of tolerance {bad}")
            if not same:
                raise AssertionError(f"{gname} hf={hf} H={nh}: two forward calls differ")
            for k, (err, _) in res.items():
                name = "attn_" + k.split()[0]
                if "=" not in k:
                    max_err[name] = max(max_err[name], err)
            x, vl, vr, dout = inputs
            out, m, s = twice[0][:3]
            w_tab = ak.bwd2_table(x, dout, vr, m, s, ak.per_head_dot(dout, out, nh))
            for side, kind in (("fwd", "bwd1"), ("t", "bwd2")):
                lay = getattr(g.attn, side)
                lays = [("", lay)] + ([(", masked units", masked_units(lay))]
                                      if gname == "hub graph" else [])
                for extra, lay in lays:
                    if kind == "bwd1":  # under the forward's (m, s) on this layout
                        args = (x, vl, vr, dout,
                                *ak.attn_fwd_reference(lay, x, vl, vr, SLOPE, g.n_pad, False)[1:3])
                    else:
                        args = (x, vl, w_tab, g.c_pad)
                    err = check_units(ak, kind, f"{gname}{extra} hf={hf} H={nh}", lay, *args,
                                      tag=tag)
                    max_err[f"attn_{kind}"] = max(max_err[f"attn_{kind}"], err)

    # the op with its autograd on the card against the same op on CPU tensors
    # (at bf16 out and the gradients are bf16: one unit of slack each)
    hub_cpu = hub_graph("cpu", attention=True)[1]
    cpu_gen = torch.Generator().manual_seed(1)
    for hf, nh in ATTN_SHAPES:
        inputs = [torch.randn(shape, generator=cpu_gen).to(dtype) for shape in
                  ((hub.c_pad, hf), (hub.c_pad, nh), (hub.n_pad, nh), (hub.n_pad, hf))]
        got = _aggregate_on("cuda", hub.attn, hub, inputs)
        want = _aggregate_on("cpu", hub_cpu.attn, hub_cpu, inputs)
        scales = ak.aggregate_scales(hub_cpu.attn, *inputs, SLOPE, hub.n_pad, hub.c_pad)
        errs = []
        for name, gt, wt, sc in zip(("out", "dx", "dvl", "dvr"), got, want, scales):
            err = (gt.float() - wt.float()).abs()
            errs.append(f"{name} {err.max().item():.2e}")
            if gt.dtype != dtype or (err > 1e-4 + 1e-4 * sc + slack(gt, wt)).any():
                raise AssertionError(f"attention_aggregate hf={hf} H={nh}: {name} on the card "
                                     f"({gt.dtype}) differs from CPU by {err.max().item():.3e}")
        print(f"[{tag}] attention_aggregate hub graph hf={hf} H={nh}, card vs cpu: "
              + ", ".join(errs))
        fh = hf // nh
        if fh % 4 or nh > 1:  # padded or many heads: the 16-byte forward and the
            # 4-column bwd2, each at its heads' template (1, else ak's most, 8)
            names = device_kernels(lambda: _aggregate_on("cuda", hub.attn, hub,
                                                         [t.detach() for t in inputs]))
            maxh = 1 if nh == 1 else ak.MAX_HEADS
            lanes = (f"attn_fwd_kernel<{16 // dtype.itemsize}, {maxh},",
                     f"attn_bwd2_kernel<4, {maxh},")
            print(f"[{tag}] attention_aggregate hf={hf} H={nh} (pitch "
                  f"{ak.row_pitch(fh, 16 // dtype.itemsize)}) launches "
                  + ", ".join(f"{n} x{names.count(n)}"
                              for n in sorted({n for n in names if "attn_" in n})))
            if not all(any(k in n for n in names) for k in lanes):
                raise AssertionError(f"attention_aggregate hf={hf} H={nh}: no {lanes} launch "
                                     f"among {names}")

    timings = {}
    lay_f, lay_t = full.attn.fwd, full.attn.t
    for hf, nh in ATTN_SHAPES[:2]:
        x, vl = rand(full.c_pad, hf), rand(full.c_pad, nh)
        vr, dout = rand(full.n_pad, nh), rand(full.n_pad, hf)
        out, m, s, _, _ = ak.attn_fwd(lay_f, x, vl, vr, SLOPE, full.n_pad, False)
        sds = ak.per_head_dot(dout, out, nh)
        w_tab = ak.bwd2_table(x, dout, vr, m, s, sds)
        calls = {
            "attn_fwd": (lambda: ak.attn_fwd(lay_f, x, vl, vr, SLOPE, full.n_pad, True),
                         lambda: ak.attn_fwd_reference(lay_f, x, vl, vr, SLOPE, full.n_pad,
                                                       True)),
            "attn_bwd1": (lambda: ak.attn_bwd1(lay_f, x, vl, vr, dout, m, s, SLOPE),
                          lambda: ak.attn_bwd1_reference(lay_f, x, vl, vr, dout, m, s, SLOPE)),
            "attn_bwd2": (lambda: ak.attn_bwd2(lay_t, x, vl, w_tab, SLOPE, full.c_pad),
                          lambda: ak.attn_bwd2_reference(lay_t, x, vl, w_tab, SLOPE,
                                                         full.c_pad)),
        }
        # bytes: the layout, each input once (in its dtype), each output
        # once (f32); operations: per slot 2 a feature for each product over
        # the row (fwd: out and out+; bwd2: dx and dp) and ~8-12 a head for
        # the score, at the f32 rate (the kernels compute in f32)
        node, col, f32 = full.n_pad * nh * 4, full.c_pad * nh * 4, 4
        work = {
            "attn_fwd": (layout_bytes(lay_f) + nbytes(x, vl, vr) + 2 * full.n_pad * hf * f32
                         + 3 * node, lay_f.flat_cols.numel() * (4 * hf + 8 * nh)),
            "attn_bwd1": (layout_bytes(lay_f) + nbytes(x, vl, vr, dout, m, s) + 3 * node,
                          lay_f.flat_cols.numel() * (2 * hf + 12 * nh)),
            "attn_bwd2": (layout_bytes(lay_t) + nbytes(w_tab, x, vl) + full.c_pad * hf * f32
                          + col, lay_t.flat_cols.numel() * (4 * hf + 12 * nh)),
        }
        for name, (kern, plain) in calls.items():
            t_kernel = cuda_ms(kern, reps=20)
            t_plain = cuda_ms(plain, reps=5)
            ms, by = bound(*work[name])
            timings[(name, hf)] = (t_kernel, t_plain, ms, by)
            print(f"[{tag}] time {name} arxiv full hf={hf} H={nh}: kernel "
                  f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, bound {ms:.4f} ms ({by}); "
                  f"no single library call computes it")
        timings[("tail", hf)] = tail_ratio(
            tag, f"attn_fwd arxiv full hf={hf} H={nh}", lay_f,
            lambda lay: ak.attn_fwd(lay, x, vl, vr, SLOPE, full.n_pad, True))
        timings[("tail bwd1", hf)] = tail_ratio(
            tag, f"attn_bwd1 arxiv full hf={hf} H={nh}", lay_f,
            lambda lay: ak.attn_bwd1(lay, x, vl, vr, dout, m, s, SLOPE))
        timings[("tail bwd2", hf)] = tail_ratio(
            tag, f"attn_bwd2 arxiv full hf={hf} H={nh}", lay_t,
            lambda lay: ak.attn_bwd2(lay, x, vl, w_tab, SLOPE, full.c_pad))
        for tail in ("tail bwd1", "tail bwd2"):
            if timings[(tail, hf)][2] > TAIL_LIMIT:
                raise AssertionError(f"attn_{tail[5:]} hf={hf}: a slot of a long row costs "
                                     f"{timings[(tail, hf)][2]:.3f}x one of a short row "
                                     f"(limit {TAIL_LIMIT})")
    return max_err, timings


def _compile_spec(tag, spec, dtype=torch.float32, data=None):
    import gala_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_model(spec, mode="train", scale=1.0, device="cuda", dtype=dtype,
                                      data=data)
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    ops = [(n.op.name, len(n.inputs)) for n in cm.program.all_nodes()]
    print(f"[{tag}] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges (e_pad {g.e_pad}); program "
          f"{','.join(name for name, _ in ops)}")
    if g.ell is not None:
        for side, lay in (("fwd", g.ell), ("t", g.t_ell)):
            print(f"[{tag}] ELL layout {side}: K {lay.k}, {lay.flat_cols.shape[0]} slots "
                  f"({int(lay.row_len.sum())} in rows), longest row "
                  f"{int(lay.row_len.max())} slots")
    if g.strategy != "ell":
        raise AssertionError(f"[{tag}] strategy {g.strategy}, expected ell")
    return cm, ops


def phase_gat_edge(dtype=torch.float32, data=None, iters=20, min_accuracy=0.6):
    """GAT_DSL with the attention chain unfused; at bf16 from `data` (and
    a shorter run: its 5 epochs pass no validation epoch after the first,
    so no accuracy is asked of it)."""
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.dsl.parser import parse_source
    from gala_tpu_torch.ops.kernels._build import dtype_counts

    tag = dtag("gat-edge", dtype)
    spec = parse_source(GAT_DSL)
    spec.passes.attention_fusion = False
    cm, ops = _compile_spec(tag, spec, dtype, data)
    names = [name for name, _ in ops]
    if ("AGGREGATE_EDGE_SUM" not in names or "SOFTMAX" not in names
            or ("AGGREGATE_MUL_SUM", 3) not in ops or "FUSED_ATTENTION" in names):
        raise AssertionError(f"[{tag}] not the unfused GAT chain: {ops}")
    _, launches = _train_checked(tag, cm, min_accuracy, iters=iters)
    for name in ("sddmm", "bell_spmm"):
        name = dtype_counts(name, dtype).name
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[{tag}] the path never launched the {name} kernel")
    attn = {k: v for k, v in launches.items() if k.startswith("attn_") and v}
    if attn:
        raise AssertionError(f"[{tag}] the path launched attention kernels: {attn}")
    return cm, launches


def phase_gcn_sparser():
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.dsl.parser import parse_source

    spec = parse_source(GCN_DSL + "\nG = G.is_sparser(true);\n")
    if not spec.graph.sparser:
        raise AssertionError("[gcn-sparser] the schedule did not set is_sparser")
    cm, ops = _compile_spec("gcn-sparser", spec)
    if ("AGGREGATE_EDGE_MUL" not in [name for name, _ in ops]
            or ("AGGREGATE_MUL_SUM", 3) not in ops):
        raise AssertionError(f"[gcn-sparser] not the sparse rewrite: {ops}")
    _, launches = _train_checked("gcn-sparser", cm, 0.7)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[gcn-sparser] the path never launched the bell SpMM kernel")
    if launches.get("sddmm", 0) != 0:
        raise AssertionError(f"[gcn-sparser] the path launched the SDDMM kernel "
                             f"{launches['sddmm']} times: its edge values need no gradient")
    return launches


def phase_sddmm_kernel(cm, ks, kernel, dtype=torch.float32):
    """The SDDMM kernel and the SpMM with slot values in `dtype`.  Returns
    (max |kernel - plain| of the SDDMM, of the SpMM with slot values,
    times)."""
    tag = dtag("sddmm-kernel", dtype)
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    hub = hub_graph("cuda", strategy="ell")[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    cases = [("arxiv full", full, SDDMM_WIDTHS), ("arxiv training subgraph", sub, SDDMM_WIDTHS),
             ("hub graph", hub, (1, 33, 40, 128))]
    max_err = 0.0
    for name, g, widths in cases:
        for f in widths:
            a, b = rand(g.c_pad, f), rand(g.n_pad, f)
            out = ks.sddmm(g.src, g.dst, a, b)
            same = torch.equal(out, ks.sddmm(g.src, g.dst, a, b))
            ref = ks.sddmm_reference(g.src, g.dst, a, b)
            scale = ks.sddmm_reference(g.src, g.dst, a.abs(), b.abs()).float()
            err = (out.float() - ref.float()).abs()
            bad = int((err > ATOL + RTOL * scale + slack(out, ref)).sum())
            max_err = max(max_err, err.max().item())
            print(f"[{tag}] {name} ({g.e_pad} edges) F={f}: max |kernel - plain| "
                  f"{err.max().item():.3e}, max of that / (sum |a||b|) "
                  f"{(err / scale.clamp_min(1e-30)).max().item():.3e}, {bad} out of tolerance; "
                  f"a second call bitwise equal: {same}")
            if bad or out.dtype != dtype:
                raise AssertionError(f"[{tag}] {name} F={f}: {bad} edges out of tolerance, "
                                     f"result {out.dtype}")
            if not same:
                raise AssertionError(f"[{tag}] {name} F={f}: two calls differ")

    # every ELL layout and width the gat-edge and gcn-sparser paths give the
    # SpMM with slot values: 32/40 in training, 128 and 1 in the hoisted
    # prefix on the full graph
    spmm_cases = [("arxiv full", full, (1, 32, 40, 128))]
    spmm_cases += [(f"arxiv training subgraph {i}", t, (1, 32, 40, 128))
                   for i, t in enumerate(cm.train_graphs)]
    spmm_cases += [("hub graph", hub, (1, 33, 40, 128))]
    spmm_err = 0.0
    for name, g, widths in spmm_cases:
        evals = torch.rand((g.e_pad,), generator=gen, device="cuda")
        for side, lay, rows, n_out in (("ell", g.ell, g.c_pad, g.n_pad),
                                       ("t_ell", g.t_ell, g.n_pad, g.c_pad)):
            vals = lay.slot_values(evals)
            for f in widths:
                x = rand(rows, f)
                out = kernel.bell_spmm(lay, x, n_out, vals=vals)
                ref = kernel.bell_spmm_rows_reference(lay, x, n_out, vals)
                scale = kernel.bell_spmm_rows_reference(lay, x.abs(), n_out, vals).float()
                err = (out.float() - ref.float()).abs()
                bad = int((err > ATOL + RTOL * scale + slack(out, ref)).sum())
                spmm_err = max(spmm_err, err.max().item())
                print(f"[{tag}] bell_spmm with slot values, {name} {side} F={f}: "
                      f"max |kernel - plain| {err.max().item():.3e}, {bad} out of tolerance")
                if bad:
                    raise AssertionError(f"bell_spmm slot values {name} {side} F={f}: {bad} "
                                         "elements out of tolerance")

    # the library's one call: torch.sparse.sampled_addmm on the edge list's
    # pattern (rows dst, columns src: (b @ a^T)[dst, src] = <a[src], b[dst]>),
    # checked against the kernel run on the pattern's own (src, dst) pairs
    pattern = torch.sparse_coo_tensor(
        torch.stack([full.dst.long(), full.src.long()]),
        torch.ones(full.e_pad, device="cuda"), (full.n_pad, full.c_pad)).coalesce()
    rows_p, cols_p = pattern.indices()
    pattern = pattern.to_sparse_csr()
    pattern = torch.sparse_csr_tensor(pattern.crow_indices(), pattern.col_indices(),
                                      pattern.values().to(dtype), pattern.shape)
    timings = {}
    for f in SDDMM_WIDTHS:
        a, b = rand(full.c_pad, f), rand(full.n_pad, f)
        t_kernel = cuda_ms(lambda: ks.sddmm(full.src, full.dst, a, b), reps=20)
        t_plain = cuda_ms(lambda: ks.sddmm_reference(full.src, full.dst, a, b), reps=5)
        at = a.t().contiguous()
        mine = ks.sddmm(cols_p.int(), rows_p.int(), a, b)
        t_lib = library_call(tag, "torch.sparse.sampled_addmm",
                             lambda: torch.sparse.sampled_addmm(pattern, b, at, beta=0.0), mine,
                             ks.sddmm_reference(cols_p.int(), rows_p.int(), a.abs(), b.abs()), f)
        ms, by = bound(nbytes(full.src, full.dst, a, b) + full.e_pad * a.element_size(),
                       2 * full.e_pad * f)
        timings[("sddmm", f)] = (t_kernel, t_plain, t_lib, ms, by)
        vec = ks.lane_width(a, b)
        if f > 1 and vec != 16 // a.element_size():
            raise AssertionError(f"[{tag}] F={f}: lanes of {vec} elements, not 16 bytes")
        print(f"[{tag}] time sddmm arxiv full F={f} ({vec} elements a lane): kernel "
              f"{t_kernel:.4f} ms, "
              f"plain {t_plain:.4f} ms, torch.sparse.sampled_addmm "
              f"{t_lib if t_lib is None else f'{t_lib:.4f}'} ms ({pattern.values().numel()} "
              f"stored values), bound {ms:.4f} ms ({by})")
        if f == 1:
            continue  # the SpMM with slot values runs at the path's widths, 32 and 40
        evals = torch.rand((full.e_pad,), generator=gen, device="cuda")
        vals = full.ell.slot_values(evals)
        x = rand(full.c_pad, f)
        t_kernel = cuda_ms(lambda: kernel.bell_spmm(full.ell, x, full.n_pad, vals=vals), reps=20)
        t_plain = cuda_ms(lambda: kernel.bell_spmm_rows_reference(full.ell, x, full.n_pad, vals),
                          reps=5)
        timings[("bell_spmm ell", f)] = (t_kernel, t_plain)
        print(f"[{tag}] time bell_spmm on the ELL layout with slot values, arxiv full "
              f"F={f}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")
        tail_ratio(tag, f"bell_spmm on the ELL layout with slot values F={f}",
                   full.ell, lambda lay: kernel.bell_spmm(lay, x, full.n_pad, vals=vals))
    return max_err, spmm_err, timings


def _example(name: str) -> str:
    return f"examples/{name}.txt"


def phase_sage(arxiv):
    """examples/sage.txt names Reddit: the Arxiv stand-in is bound through
    data=, so every phase runs on one graph."""
    import gala_tpu_torch

    print("[sage] data: the Arxiv stand-in (scale 1.0) bound through data= "
          "(examples/sage.txt names Reddit)")
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_file(_example("sage"), mode="train", data=arxiv, device="cuda")
    g = cm.full_graphs[0]
    ops = [n.op.name for n in cm.program.all_nodes()]
    print(f"[sage] compiled in {time.perf_counter() - t0:.1f} s: strategy {g.strategy}, "
          f"{g.n_nodes} nodes, {g.n_edges} edges; program {','.join(ops)}")
    if g.strategy != "bell" or "FFN_SELF" not in ops:
        raise AssertionError(f"[sage] strategy {g.strategy}, program {ops}: expected bell and "
                             "the self FFN")
    _, launches = _train_checked("sage", cm, 0.6)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[sage] the path never launched the bell SpMM kernel")
    return launches


def phase_gin():
    import gala_tpu_torch

    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_file(_example("gin"), mode="train", scale=1.0, device="cuda")
    g = cm.full_graphs[0]
    ops = [n.op.name for n in cm.program.all_nodes()]
    print(f"[gin] compiled in {time.perf_counter() - t0:.1f} s: strategy {g.strategy}, "
          f"{g.n_nodes} nodes, {g.n_edges} edges; program {','.join(ops)}")
    if g.strategy != "bell" or "SCALAR_ADD_EPS_MULTIPLY" not in ops:
        raise AssertionError(f"[gin] strategy {g.strategy}, program {ops}: expected bell and "
                             "the learned epsilon")
    res, launches = _train_checked("gin", cm, 0.6)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[gin] the path never launched the bell SpMM kernel")
    eps = {k: float(res.params[k].detach()) for k in ("eps1", "eps2")}
    print(f"[gin] learned epsilons after training {json.dumps(eps)}")
    if not all(math.isfinite(v) and v != 0.0 for v in eps.values()):
        raise AssertionError(f"[gin] epsilons not finite or never moved from 0: {eps}")
    return launches


def phase_sage_minibatch(arxiv, dtype=torch.float32, iters=10):
    """train_sage_minibatch with gala_tpu's defaults (fanouts 25/10, batch
    512, hidden 32, 10 epochs) on the Arxiv stand-in; at bf16 (the feature
    table bf16, so the gathers copy bf16 rows) for `iters` epochs."""
    from gala_tpu_torch.ops.kernels._build import all_counts, dtype_counts, reset_counts
    from gala_tpu_torch.train_minibatch import train_sage_minibatch

    tag = dtag("sage-minibatch", dtype)
    g_host, feats, labels, masks = arxiv
    n_train = int(np.asarray(masks["train"]).sum())
    fanouts, batch = (25, 10), 512
    n_batches = -(-n_train // batch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_sage_minibatch(g_host, feats, labels, masks, device="cuda", dtype=dtype,
                               iters=iters)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in all_counts().items()}
    on_cuda = {name: c.reference_calls_on_cuda for name, c in all_counts().items()}
    f1, f2 = fanouts
    sampled = n_train * (f1 + f1 * f2)  # per epoch, scripts/bench_minibatch.py's count
    print(f"[{tag}] {n_train} training nodes, {n_batches} batches of {batch}, "
          f"fanouts {fanouts}, {iters} epochs in {run_s:.1f} s (sampling and validation "
          f"included)")
    print(f"[{tag}] epoch seconds (device work, after 1 warm-up epoch) "
          f"{res.total_time:.6f}; sampled edges/s {sampled / max(res.total_time, 1e-9):.1f}")
    print(f"[{tag}] losses {json.dumps([round(v, 5) for v in res.losses])}")
    print(f"[{tag}] accuracies {json.dumps([round(v, 5) for v in res.accuracies])}")
    print(f"[{tag}] kernel launches {json.dumps(launches)}, plain-version calls on "
          f"cuda {json.dumps(on_cuda)}")
    print(f"[{tag}] peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    want = 3 * n_batches * iters
    spmm = dtype_counts("bell_spmm", dtype).name
    dtypes = sorted({str(p.dtype) for p in res.params.parameters()})
    print(f"[{tag}] params {', '.join(dtypes)}")
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"[{tag}] params not all f32 after training: {dtypes}")
    if launches.get("gather_rows", 0) != want:
        raise AssertionError(f"[{tag}] {launches.get('gather_rows', 0)} gather "
                             f"launches, expected 3 x {n_batches} x {iters} = {want}")
    if launches.get(spmm, 0) <= 0:
        raise AssertionError(f"[{tag}] validation never launched the {spmm} kernel")
    if any(on_cuda.values()):
        raise AssertionError(f"[{tag}] plain versions ran on the card: {on_cuda}")
    if not all(math.isfinite(v) for v in res.losses) or not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"[{tag}] losses not finite and falling: {res.losses}")
    if res.max_accuracy < 0.6:
        raise AssertionError(f"[{tag}] max test accuracy {res.max_accuracy} < 0.6")
    return launches


def phase_gather_kernel(arxiv, kg, dtype=torch.float32):
    """The gather kernel against index_select, bitwise, at the minibatch
    path's shapes with the table in `dtype` and (in the f32 phase) at
    ragged, empty and odd ones in f32 and bf16; then times at the n2
    shape.  Returns (max |kernel - plain|, times)."""
    from gala_tpu_torch.data.minibatch import NeighborSampler

    tag = dtag("gather-kernel", dtype)
    g_host, feats, _, masks = arxiv
    eb = NeighborSampler(g_host, (25, 10), 512).epoch(np.flatnonzero(masks["train"]), 0)
    table = torch.from_numpy(np.asarray(feats, np.float32)).cuda().to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = {name: torch.from_numpy(np.ascontiguousarray(a[0]).reshape(-1)).cuda()
            for name, a in (("t", eb.targets), ("n1", eb.n1), ("n2", eb.n2))}
    max_err = 0.0
    for name, idx in path.items():
        for order, ids in (("sampled", idx), ("sorted", idx.sort().values)):
            max_err = max(max_err, kg.compare_with_plain(table, ids))
            print(f"[{tag}] path shape {name}: {tuple(table.shape)} {table.dtype} table, "
                  f"{ids.numel()} {order} indices: bitwise equal")
    for dt in (torch.float32, torch.bfloat16) if dtype == torch.float32 else ():
        for f in GATHER_WIDTHS:
            x = torch.randn((table.shape[0], f), generator=gen, device="cuda").to(dt)
            for m in GATHER_ROWS + (12800,):
                idx = torch.randint(0, x.shape[0], (m,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                for ids in (idx, idx.sort().values):
                    max_err = max(max_err, kg.compare_with_plain(x, ids))
            print(f"[{tag}] {str(dt)[6:]} F={f}: M = "
                  f"{', '.join(map(str, GATHER_ROWS + (12800,)))}, random and sorted: "
                  f"bitwise equal")
    torch.cuda.synchronize()

    idx = path["n2"]
    unique = int(torch.unique(idx).numel())
    row_bytes = table.shape[1] * table.element_size()
    ms, by = bound(nbytes(idx) + unique * row_bytes + idx.numel() * row_bytes, 0)
    t_kernel = cuda_ms(lambda: kg.gather_rows(table, idx), reps=50)
    t_plain = cuda_ms(lambda: kg.gather_rows_reference(table, idx), reps=50)
    t_lib = cuda_ms(lambda: torch.index_select(table, 0, idx), reps=50)
    print(f"[{tag}] time at the n2 shape ({idx.numel()} of {table.shape[0]} rows, "
          f"{unique} distinct, F={table.shape[1]} {table.dtype}): kernel {t_kernel:.4f} ms, plain "
          f"{t_plain:.4f} ms, torch.index_select {t_lib:.4f} ms, bound {ms:.4f} ms ({by})")
    return max_err, (t_kernel, t_plain, t_lib, ms, by)


def phase_probe():
    """The toolchain probe's kernel in this process (its library is the one
    the probe's child process built): x * 2 against the plain product,
    bitwise, at PROBE_SIZES and on views one float in (scalar stores);
    then the kernel, the plain product and torch.mul timed at the probe's
    128 x 128 tile and at 2^26 floats, each the median of 5 runs of 50
    calls with its min-max, and the host's time per call at the tile.
    Returns (max |kernel - plain|, {size: times})."""
    from gala_tpu_torch.ops.kernels._build import probe_x2

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for n in PROBE_SIZES:
        x = torch.randn((n + 1,), generator=gen, device="cuda")
        for v in (x[:n], x[1:]):
            got = probe_x2(v)
            if got.shape != v.shape or not torch.equal(got, v * 2.0):
                raise AssertionError(f"the probe kernel computes x * 2 wrongly at n={n}, "
                                     f"offset {v.storage_offset()}")
            err = max(err, (got - v * 2.0).abs().max().item())
    print(f"[build] probe kernel x * 2: bitwise equal to the plain product at n = "
          f"{', '.join(map(str, PROBE_SIZES))}, aligned and one float in")

    def host_ms(fn, calls=200):
        """The host's time per call, enqueue only (the card may lag)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e3

    times = {}
    for label, shape in PROBE_TIMED.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        t = {"ms": median_runs(lambda: probe_x2(x), reps=50),
             "plain_ms": median_runs(lambda: x * 2.0, reps=50),
             "library_ms": median_runs(lambda: torch.mul(x, 2.0), reps=50),
             "bound": bound(2 * nbytes(x), x.numel())}
        if label == "128x128":
            t["host_ms"] = {"probe_x2": host_ms(lambda: probe_x2(x)),
                            "torch.mul": host_ms(lambda: torch.mul(x, 2.0))}
        times[label] = t
        print(f"[build] probe kernel x * 2 at {label} f32: kernel {t['ms'][0]:.4f} ms "
              f"({t['ms'][1][0]:.4f}-{t['ms'][1][1]:.4f}), plain {t['plain_ms'][0]:.4f} ms, "
              f"torch.mul {t['library_ms'][0]:.4f} ms ({t['library_ms'][1][0]:.4f}-"
              f"{t['library_ms'][1][1]:.4f}), bound {t['bound'][0]:.6f} ms ({t['bound'][1]})"
              + ("" if "host_ms" not in t else
                 f"; host per call: probe_x2 {t['host_ms']['probe_x2']:.4f} ms, torch.mul "
                 f"{t['host_ms']['torch.mul']:.4f} ms"))
    return err, times


def phase_cli():
    """The CLI in-process, as `python -m gala_tpu_torch inference_sample
    examples/gin.txt --iters 8` (device default: the card; 8 epochs so
    the 5 warm-up epochs leave 3 timed)."""
    import contextlib
    import io

    from gala_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["inference_sample", _example("gin"), "--iters", "8"])
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"[cli] inference_sample examples/gin.txt: {line}")
    fields = [float(v) for v in line.split(",")]
    if len(fields) != 3 or not all(math.isfinite(v) for v in fields):
        raise AssertionError(f"[cli] expected three finite fields, got {line!r}")


def phase_long_kernel(arxiv, kernel, ak):
    """The unit kernels at 64-bit slot offsets: the Arxiv stand-in's bell
    and fused-attention layouts (Graph.from_host, no relabel) with their
    slots after 2^31 unused ones (ops.graph.shifted_slots, every unit start
    past 2^31), one layout at a time.  Each kernel there against its plain
    version on the layout itself (phases 4 and 6's tolerances) and against
    itself on the layout itself, bitwise.  Returns {kernel: max |kernel -
    plain|}."""
    from gala_tpu_torch.ops.graph import Graph, shifted_slots

    torch.cuda.reset_peak_memory_stats()
    g = Graph.from_host(arxiv[0], strategy="bell", device="cuda", attention=True)
    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = {}

    def report(name, far, near, want, scale):
        """far: the kernel at offsets past 2^31; near: it on the layout
        itself; want, scale: the plain version and its magnitudes."""
        same = all(torch.equal(a, b) for a, b in zip(far, near))
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(far, want))
        bad = sum(int(((a.float() - b.float()).abs() > ATOL + RTOL * s.float()
                       + slack(a, b)).sum()) for a, b, s in zip(far, want, scale))
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"[long-kernel] {name}: max |kernel - plain| {err:.3e}, {bad} elements out of "
              f"tolerance; bitwise equal to the kernel on the unshifted layout: {same}")
        if bad or not same:
            raise AssertionError(f"[long-kernel] {name}: {bad} out of tolerance, same {same}")

    for dtype in (torch.float32, BF16):
        for side, lay, rows, n_out in (("bell", g.bell, g.c_pad, g.n_pad),
                                       ("t_bell", g.t_bell, g.n_pad, g.c_pad)):
            if side == "t_bell" and g.t_bell is g.bell:
                continue
            far = shifted_slots(lay, LONG_SHIFT)
            x = torch.randn((rows, 32), generator=gen, device="cuda").to(dtype)
            print(f"[long-kernel] {side} {str(dtype)[6:]}: {far.flat_cols.numel()} slots, unit "
                  f"starts {int(far.units.start.min())}..{int(far.units.start.max())}")
            report(dtag(f"bell_spmm {side}", dtype), [kernel.bell_spmm(far, x, n_out)],
                   [kernel.bell_spmm(lay, x, n_out)], [kernel.bell_spmm_reference(lay, x, n_out)],
                   [kernel.bell_spmm_reference(lay, x.abs(), n_out)])
            del far
            torch.cuda.empty_cache()
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, vl, vr, dout = rand(g.c_pad, 32), rand(g.c_pad, 1), rand(g.n_pad, 1), rand(g.n_pad, 32)
    fwd_l, t_l = g.attn.fwd, g.attn.t
    far = shifted_slots(fwd_l, LONG_SHIFT)
    want = ak.attn_fwd_reference(fwd_l, x, vl, vr, SLOPE, g.n_pad, True)
    a_out, _, _, a_outpos, _ = ak.attn_fwd_reference(fwd_l, x.abs(), vl, vr, SLOPE, g.n_pad, True)
    report("attn_fwd", ak.attn_fwd(far, x, vl, vr, SLOPE, g.n_pad, True),
           ak.attn_fwd(fwd_l, x, vl, vr, SLOPE, g.n_pad, True), want,
           (a_out, torch.zeros_like(want[1]), want[2], a_outpos, want[4]))
    m, s = want[1], want[2]
    a_sds, _, _ = ak.attn_bwd1_reference(fwd_l, x.abs(), vl, vr, dout.abs(), m, s, SLOPE)
    b1_want = ak.attn_bwd1_reference(fwd_l, x, vl, vr, dout, m, s, SLOPE)
    report("attn_bwd1", ak.attn_bwd1(far, x, vl, vr, dout, m, s, SLOPE),
           ak.attn_bwd1(fwd_l, x, vl, vr, dout, m, s, SLOPE), b1_want,
           (a_sds, a_sds, b1_want[2]))
    del far
    torch.cuda.empty_cache()
    w_tab = ak.bwd2_table(x, dout, vr, m, s, b1_want[0])
    a_tab = ak.bwd2_table(x, dout.abs(), vr, m, s, -b1_want[0].abs())
    far = shifted_slots(t_l, LONG_SHIFT)
    report("attn_bwd2", [ak.attn_bwd2(far, x, vl, w_tab, SLOPE, g.c_pad)],
           [ak.attn_bwd2(t_l, x, vl, w_tab, SLOPE, g.c_pad)],
           [ak.attn_bwd2_reference(t_l, x, vl, w_tab, SLOPE, g.c_pad)],
           [ak.attn_bwd2_reference(t_l, x.abs(), vl, a_tab, SLOPE, g.c_pad)])
    del far
    torch.cuda.empty_cache()
    print(f"[long-kernel] peak memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return errs


def phase_inference_long(arxiv):
    """The inference_long driver's compile, lower(use_long=True): GCN_DSL
    inference on the Arxiv stand-in, int64 edge ids on the full graph, and
    its CSV line of 8 epochs.  Then two graphs built from one host graph,
    relabelled as lower() relabels it, with long_indices True and False:
    the program's logits on them bitwise equal under the same weights, and
    the two run in turns (int64, int32, int32, int64; 20 epochs each) for
    their ms/epoch.  Returns {edge-id dtype: [ms/epoch of each of its runs]}."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.data.ell import bell_order
    from gala_tpu_torch.data.reordering import apply_reorder
    from gala_tpu_torch.ops.graph import Graph

    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="inference", data=arxiv, device="cuda",
                                       use_long=True)
    g = cm.full_graphs[0]
    if g.strategy != "bell" or (g.row_ptr.dtype, g.t_row_ptr.dtype, g.bell.units.start.dtype) \
            != (torch.int64,) * 3:
        raise AssertionError(f"[inference-long] strategy {g.strategy}, edge ids "
                             f"{g.row_ptr.dtype} / {g.t_row_ptr.dtype}, unit starts "
                             f"{g.bell.units.start.dtype}")
    line = cm.run(iters=8)
    fields = [float(v) for v in line.split(",")]
    if len(fields) != 2 or not all(math.isfinite(v) for v in fields):
        raise AssertionError(f"[inference-long] expected two finite fields, got {line!r}")
    print(f"[inference-long] lower(use_long=True): csv {line}; inference "
          f"{fields[0] * 1e3:.4f} ms/epoch")

    host = apply_reorder(arxiv[0], bell_order(arxiv[0]))[0]
    graphs = {name: Graph.from_host(host, strategy="bell", undirected=cm.spec.graph.undirected,
                                    device="cuda", long_indices=name == "int64")
              for name in ("int64", "int32")}
    if graphs["int32"].row_ptr.dtype != torch.int32:
        raise AssertionError("[inference-long] the int32 graph has int64 edge ids")
    n_layers, params = len(cm.full_graphs), cm.make_params(0)
    logits = []
    for gr in graphs.values():
        cm.full_graphs = [gr] * n_layers
        with torch.no_grad():
            logits.append(cm.forward(params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x)))
    same = torch.equal(*logits)
    err = (logits[0] - logits[1]).abs().max().item()
    print(f"[inference-long] logits {tuple(logits[0].shape)} on the int64 graph bitwise equal to "
          f"the int32 graph's: {same} (max |difference| {err:.3e})")
    if not same or not torch.isfinite(logits[0]).all():
        raise AssertionError("[inference-long] the int64 graph's logits differ from the int32 "
                             "graph's")
    ms = {"int64": [], "int32": []}
    for name in ("int64", "int32", "int32", "int64"):
        cm.full_graphs = [graphs[name]] * n_layers
        ms[name].append(float(cm.run(iters=20).split(",")[0]) * 1e3)
    print("[inference-long] inference ms/epoch in turns (20 epochs a run): "
          + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in vs)}" for k, vs in ms.items()))
    return ms


def phase_col_tile(arxiv, kernel, ak):
    """table5's `dir` schedule: GCN_DSL + `G=G.col_tile(37000);` on the
    Arxiv stand-in, inference on segment_scan and on bell (8 epochs each,
    the SpMM kernel launched, finite CSV fields), then 20 training epochs
    on bell (accuracy >= 0.7); the fused GAT with the tile, 20 epochs
    (accuracy >= 0.6, the attention kernels launched).  Every layout's
    units lie in one tile each, tile-major.  Then each kernel on the tiled
    layouts the path ran against its plain version (f32 and bf16): the
    SpMM at F = 1, 32, 128 on the segment_scan edge list, the full bell
    and the training subgraph's bell and transpose (phase 4's tolerance),
    attention fwd, bwd1 and bwd2 at the GAT path's shapes on the full
    and training graphs' layouts (phase 6's).  Last the SpMM kernel's
    times on the full bell with and without the tiles, with units and
    partial rows.  Returns ({F: (tiled ms, untiled ms)}, the tiled and
    untiled (units, partials), {kernel: {dtype: max |kernel - plain|}})."""
    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL, GCN_DSL
    from gala_tpu_torch.data.ell import bell_order
    from gala_tpu_torch.data.reordering import apply_reorder
    from gala_tpu_torch.ops.graph import Graph
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

    source = GCN_DSL + f"G=G.col_tile({COL_TILE});\n"

    def check_tiles(tag, lay):
        u = lay.units
        keep = u.length > 0
        first = lay.flat_cols.long()[u.start[keep]] // COL_TILE
        last = lay.flat_cols.long()[u.start[keep] + u.length[keep].long() - 1] // COL_TILE
        if not torch.equal(first, last) or not bool((first[1:] >= first[:-1]).all()):
            raise AssertionError(f"[{tag}] units not in one column tile each, tile-major")
        return u.n_units, u.n_partials

    # (name, layout, its plain version, feature rows, output rows)
    spmm_layouts = []
    for strategy in ("segment_scan", "bell"):
        cm = gala_tpu_torch.compile_source(source, mode="inference", data=arxiv,
                                           strategy=strategy, device="cuda")
        if cm.spec.col_tile != COL_TILE:
            raise AssertionError(f"[col-tile] the directive did not parse: {cm.spec.col_tile}")
        g = cm.full_graphs[0]
        lay = g.bell if strategy == "bell" else g.seg
        units = check_tiles("col-tile", lay)
        reset_counts()
        line = cm.run(iters=8)
        launches = all_counts()["bell_spmm"].launches
        fields = [float(v) for v in line.split(",")]
        print(f"[col-tile] dir inference on {strategy}: units {units[0]}, partials {units[1]}; "
              f"csv {line}; bell_spmm launches {launches}")
        if launches <= 0 or not all(math.isfinite(v) for v in fields):
            raise AssertionError(f"[col-tile] {strategy}: {launches} launches, csv {line!r}")
        if strategy == "segment_scan":
            spmm_layouts.append(("segment_scan full seg", g.seg, kernel.bell_spmm_rows_reference,
                                 g.c_pad, g.n_pad))
        del cm
    cm = gala_tpu_torch.compile_source(source, mode="train", data=arxiv, strategy="bell",
                                       device="cuda")
    for g in cm.full_graphs[:1] + cm.train_graphs:
        check_tiles("col-tile", g.bell)
        check_tiles("col-tile", g.t_bell)
    _, launches = _train_checked("col-tile", cm, 0.7)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[col-tile] the tiled GCN never launched the SpMM kernel")
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    spmm_layouts += [("bell full", full.bell, kernel.bell_spmm_reference, full.c_pad, full.n_pad),
                     ("bell subgraph", sub.bell, kernel.bell_spmm_reference, sub.c_pad, sub.n_pad),
                     ("bell subgraph t_bell", sub.t_bell, kernel.bell_spmm_reference, sub.n_pad,
                      sub.c_pad)]
    del cm
    gat = gala_tpu_torch.compile_source(GAT_DSL + f"G=G.col_tile({COL_TILE});\n", mode="train",
                                        data=arxiv, device="cuda")
    attn_graphs = [("full", gat.full_graphs[0])] + [
        ("training subgraph", g) for g in (gat.train_graphs or [])[:1] if g.attn is not None]
    for gname, g in attn_graphs:
        for side in ("fwd", "t"):
            n_u, n_p = check_tiles("col-tile-gat", getattr(g.attn, side))
            print(f"[col-tile-gat] {gname} attention layout {side}: {n_u} units, {n_p} partials")
    _, launches = _train_checked("col-tile-gat", gat, 0.6)
    if launches.get("attn_fwd", 0) <= 0 or launches.get("attn_bwd2", 0) <= 0:
        raise AssertionError(f"[col-tile-gat] the attention kernels did not launch: {launches}")
    del gat

    # each kernel on the tiled layouts against its plain version
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}

    def note(name, dtype, err):
        errs.setdefault(name, {})
        errs[name][str(dtype)[6:]] = max(errs[name].get(str(dtype)[6:], 0.0), err)

    for dtype in (torch.float32, BF16):
        rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731,B023
        for name, lay, plain, rows, n_out in spmm_layouts:
            for f in WIDTHS:
                x = rand(rows, f)
                out, ref = kernel.bell_spmm(lay, x, n_out), plain(lay, x, n_out)
                scale = plain(lay, x.abs(), n_out).float()
                err = (out.float() - ref.float()).abs()
                bad = int((err > ATOL + RTOL * scale + slack(out, ref)).sum())
                note("bell_spmm", dtype, err.max().item())
                print(f"[col-tile] SpMM kernel on the tiled {name} {str(dtype)[6:]} F={f}: max "
                      f"|kernel - plain| {err.max().item():.3e}, {bad} elements out of tolerance")
                if bad or out.dtype != dtype:
                    raise AssertionError(f"[col-tile] tiled {name} F={f}: {bad} elements out of "
                                         f"tolerance, result {out.dtype}")
        for gname, g in attn_graphs:
            for hf, nh in ATTN_SHAPES[:2]:
                inputs = (rand(g.c_pad, hf), rand(g.c_pad, nh), rand(g.n_pad, nh),
                          rand(g.n_pad, hf))
                res = ak.compare_with_plain(g.attn, *inputs, SLOPE, g.n_pad, g.c_pad)
                print(f"[col-tile-gat] tiled {gname} {str(dtype)[6:]} hf={hf} H={nh}: max "
                      "|kernel - plain| " + ", ".join(f"{k} {v[0]:.2e}" for k, v in res.items())
                      + f"; {sum(v[1] for v in res.values())} elements out of tolerance")
                bad = {k: v for k, v in res.items() if v[1]}
                if bad:
                    raise AssertionError(f"[col-tile-gat] tiled {gname} hf={hf} H={nh}: out of "
                                         f"tolerance {bad}")
                for k, (err, _) in res.items():
                    if "=" not in k:
                        note("attn_" + k.split()[0], dtype, err)

    # the SpMM kernel on the tiled full bell and the graph untiled, relabelled
    # as lower() relabels it
    host = apply_reorder(arxiv[0], bell_order(arxiv[0]))[0]
    untiled = Graph.from_host(host, strategy="bell", device="cuda").bell
    tiled = full.bell
    shape = {"tiled": (tiled.units.n_units, tiled.units.n_partials),
             "untiled": (untiled.units.n_units, untiled.units.n_partials)}
    times = {}
    for f in WIDTHS:
        x = torch.randn((full.c_pad, f), generator=gen, device="cuda")
        t_untiled = cuda_ms(lambda: kernel.bell_spmm(untiled, x, full.n_pad), reps=20)
        t_tiled = cuda_ms(lambda: kernel.bell_spmm(tiled, x, full.n_pad), reps=20)
        times[f] = (t_tiled, t_untiled)
        print(f"[col-tile] SpMM kernel arxiv full bell F={f}: tiled ({COL_TILE} columns a tile; "
              f"{shape['tiled'][0]} units, {shape['tiled'][1]} partial rows) {t_tiled:.4f} ms, "
              f"untiled ({shape['untiled'][0]} units, {shape['untiled'][1]} partial rows) "
              f"{t_untiled:.4f} ms")
    return times, shape, errs


def phase_sample(mode, data, strategy="auto", dtype=torch.float32, iters=SAMPLE_ITERS,
                 min_accuracy=0.6):
    """GCN_DSL with table7's line for `mode` (k = 20) on the Arxiv
    stand-in `data`; `iters` epochs (warmup 2).  Checks the program
    (none: the whole graph; data and static kernel sampling: a resampled
    graph of degree <= 20; neither sampled aggregations; dynamic: every
    aggregation sampled, every graph with its sampling inputs) and the
    launches: the SpMM kernel in the run's dtype, no plain version on
    the card; for dynamic sampling every SpMM launch the sampled form
    (every SpMM of the program is sampled, its weights made in the
    kernel's staging) and no weights kernel, otherwise no sampled form.
    Returns (compiled model, launches, result)."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.ir.compute_ir import CompOpt
    from gala_tpu_torch.ops.kernels._build import dtype_counts

    tag = dtag(f"sample-{mode}" + ("" if strategy == "auto" else f"-{strategy}"), dtype)
    source = GCN_DSL + SAMPLE_LINES[mode] + "\n"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(source, mode="train", data=data, strategy=strategy,
                                       device="cuda", dtype=dtype)
    g = cm.full_graphs[0]
    aggs = [n for n in cm.program.all_nodes() if n.op.name.startswith("AGGREGATE")]
    sampled = [n.get_opt(CompOpt.SAMPLE_DYNAMIC) for n in aggs]
    print(f"[{tag}] {SAMPLE_LINES[mode]} compiled in {time.perf_counter() - t0:.1f} s: strategy "
          f"{g.strategy}, {g.n_nodes} nodes, {g.n_edges} edges (of {data[0].n_edges}), max "
          f"in-degree {int(g.deg.max())}; aggregations {[n.op.name for n in aggs]}, sampled "
          f"k {sampled}")
    want = "bell" if strategy == "auto" else strategy
    if g.strategy != want:
        raise AssertionError(f"[{tag}] strategy {g.strategy}, expected {want}")
    graphs = cm.full_graphs[:1] + cm.train_graphs
    if mode == "dynamic":
        if not aggs or any(k != SAMPLE_K for k in sampled) or any(
                n.op.name != "AGGREGATE_MUL_SUM" for n in aggs):
            raise AssertionError(f"[{tag}] not every aggregation is sampled: {aggs}")
        if any(gr.dyn_f is None or gr.dyn_t is None for gr in graphs):
            raise AssertionError(f"[{tag}] a graph lacks its sampling inputs")
    elif mode == "none":
        if any(sampled) or g.n_edges != data[0].n_edges:
            raise AssertionError(f"[{tag}] a sampled program or graph")
    elif any(sampled) or g.n_edges >= data[0].n_edges or int(g.deg.max()) > SAMPLE_K:
        raise AssertionError(f"[{tag}] not a resampled graph of degree <= {SAMPLE_K}")
    res, launches = _train_checked(tag, cm, min_accuracy, iters=iters)
    spmm = dtype_counts("bell_spmm", dtype).name
    sampled = dtype_counts("bell_spmm_dyn", dtype).name
    n_spmm, n_sampled = launches.get(spmm, 0), launches.get(sampled, 0)
    print(f"[{tag}] train {res.total_time * 1e3:.4f} ms/epoch, inference "
          f"{res.inference_time * 1e3:.4f} ms/epoch, max accuracy {res.max_accuracy:.5f}; "
          f"{spmm} {n_spmm} launches, {sampled} {n_sampled}")
    if n_spmm + n_sampled <= 0:
        raise AssertionError(f"[{tag}] the path never launched the SpMM kernel")
    want = (0, n_spmm + n_sampled) if mode == "dynamic" else (n_spmm, 0)
    if (n_spmm, n_sampled) != want:
        raise AssertionError(f"[{tag}] {n_spmm} {spmm} and {n_sampled} {sampled} launches: "
                             f"expected {want}")
    return cm, launches, res


def phase_dyn_weights_kernel(cm, seg_cm, kernel):
    """The SpMM's sampled form (the weights made in its staging) on the
    dynamic runs' layouts: the bell run's full-graph, training-subgraph
    and transpose bell layouts, the segment run's seg and t_seg layouts
    (the path of [sample-dynamic-segment]), and the generated hub graph's
    under both strategies; at k = 1, 20 and 300, each with and without
    the structural values (the bell path takes them, the segment path
    does not): against the plain version (the plain weights into the
    row-descriptor plain SpMM; phase 4's tolerance form, |A_s| @ |x| on
    the weights' magnitudes) at F = 1, 32, 128, and bitwise against the
    two-step path (bell_spmm with the plain weights as its values), at
    bf16 too at F = 32; then at k = 20, F = 32 on the full layout its time,
    the two-step recipe's SpMM on weights made once beforehand, and the
    plain version's (medians of 5 runs of 20 calls, min-max) beside the
    bound.  Returns (max |fused - plain|, times)."""
    from gala_tpu_torch.ops.kernels._build import dtype_counts

    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    s_full, s_sub = seg_cm.full_graphs[0], seg_cm.train_graphs[0]
    hub = hub_graph("cuda", dynamic_sample=True)[1]
    s_hub = hub_graph("cuda", strategy="segment", dynamic_sample=True)[1]
    layouts = []
    for name, g, fwd, t in (("arxiv full", full, "bell", "t_bell"),
                            ("arxiv subgraph", sub, "bell", "t_bell"),
                            ("arxiv full", s_full, "seg", "t_seg"),
                            ("arxiv subgraph", s_sub, "seg", "t_seg"),
                            ("hub graph", hub, "bell", "t_bell"),
                            ("hub graph", s_hub, "seg", "t_seg")):
        lay, t_lay = getattr(g, fwd), getattr(g, t)
        layouts.append((f"{name} {fwd}", lay, g.dyn_f, g.c_pad, g.n_pad))
        if t_lay is not lay:
            layouts.append((f"{name} {t}", t_lay, g.dyn_t, g.n_pad, g.c_pad))
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for name, lay, meta, rows, n_out in layouts:
        for (k, ra, rb), structural in itertools.product(
                ((1, 5, 7), (SAMPLE_K, 96, 96), (300, 17, 5)), (False, True)):
            w = kernel.dyn_weights_reference(meta.deg, meta.pos, k, ra, rb,
                                         lay.flat_vals if structural else None)
            bad, differ = [], []
            for dtype, f in [(torch.float32, f) for f in WIDTHS] + [(BF16, 32)]:
                x = torch.randn((rows, f), generator=gen, device="cuda").to(dtype)
                counts = dtype_counts("bell_spmm_dyn", dtype)
                launches = counts.launches
                out = kernel.bell_spmm_sampled(lay, x, n_out, meta, k, ra, rb, structural)
                two_step = kernel.bell_spmm(lay, x, n_out, vals=w)
                torch.cuda.synchronize()
                if counts.launches != launches + 1:
                    raise AssertionError(f"[dyn-weights-kernel] {name}: the sampled form "
                                         "launched no kernel")
                if not torch.equal(out, two_step):
                    differ.append((str(dtype)[6:], f))
                ref = kernel.bell_spmm_rows_reference(lay, x, n_out, w)
                scale = kernel.bell_spmm_rows_reference(lay, x.abs(), n_out, w.abs()).float()
                err = (out.float() - ref.float()).abs()
                max_err = max(max_err, err.max().item())
                n_bad = int((err > ATOL + RTOL * scale + slack(out, ref)).sum())
                if n_bad:
                    bad.append((str(dtype)[6:], f, n_bad))
            print(f"[dyn-weights-kernel] {name} ({meta.deg.numel()} slots) k={k} ra={ra} "
                  f"rb={rb} structural={structural}: sampled SpMM "
                  f"F={'/'.join(map(str, WIDTHS))} and bf16 F=32 bitwise equal to the two-step "
                  f"path: {not differ}; {sum(n for *_, n in bad)} elements out of the plain "
                  f"version's tolerance (weights sum {w.sum().item():.6g})")
            if differ or bad:
                raise AssertionError(f"[dyn-weights-kernel] {name} k={k} structural="
                                     f"{structural}: differs from the two-step path at "
                                     f"{differ}, out of tolerance at {bad}")
    lay, meta, ra, rb, f = full.bell, full.dyn_f, 96, 96, 32
    x = torch.randn((full.c_pad, f), generator=gen, device="cuda")
    w = kernel.dyn_weights_reference(meta.deg, meta.pos, SAMPLE_K, ra, rb, lay.flat_vals)
    t = {"ms": median_runs(
             lambda: kernel.bell_spmm_sampled(lay, x, full.n_pad, meta, SAMPLE_K, ra, rb, True)),
         "two_step_spmm_ms": median_runs(lambda: kernel.bell_spmm(lay, x, full.n_pad, vals=w)),
         "plain_ms": median_runs(lambda: kernel.bell_spmm_rows_reference(
             lay, x, full.n_pad, kernel.dyn_weights_reference(
                 meta.deg, meta.pos, SAMPLE_K, ra, rb, lay.flat_vals)), reps=5)}
    # bytes: the layout (its structural values among them), deg and pos,
    # x read once and the output written once; operations: 2 F a slot and
    # k steps of the count
    t["bound"] = bound(layout_bytes(lay) + nbytes(meta.deg, meta.pos, x)
                       + full.n_pad * f * x.element_size(),
                       (2 * f + SAMPLE_K) * lay.flat_cols.numel())
    span = lambda v: f"{v[0]:.4f} ms ({v[1][0]:.4f}-{v[1][1]:.4f})"  # noqa: E731
    print(f"[dyn-weights-kernel] time arxiv full bell ({meta.deg.numel()} slots) k={SAMPLE_K} "
          f"F={f}: sampled SpMM {span(t['ms'])}, the SpMM on weights made beforehand "
          f"{span(t['two_step_spmm_ms'])}, plain {span(t['plain_ms'])}, bound "
          f"{t['bound'][0]:.4f} ms ({t['bound'][1]}); no single library call computes it")
    return max_err, t


# ---- checkpoint/resume, failure recovery, profiling, the evaluation twin ---- #
def _new_counts():
    """Zero every launch count; returns a reader of the counts since."""
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

    reset_counts()

    def read():
        torch.cuda.synchronize()
        counts = all_counts().values()
        return ({c.name: c.launches for c in counts if c.launches},
                {c.name: c.reference_calls_on_cuda for c in counts if c.reference_calls_on_cuda})
    return read


def _no_plain(tag, on_cuda):
    if on_cuda:
        raise AssertionError(f"[{tag}] plain versions ran on the card: {on_cuda}")


def _tensors(obj, prefix="", seen=None):
    """{path: tensor} of every tensor reachable through a graph's
    dataclasses (layouts, work units, sampling inputs), each object once."""
    import dataclasses

    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if not dataclasses.is_dataclass(obj) or id(obj) in seen:
        return {}
    seen.add(id(obj))
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        items = enumerate(value) if isinstance(value, (list, tuple)) else [(None, value)]
        for i, v in items:
            name = f"{prefix}.{f.name}" if i is None else f"{prefix}.{f.name}[{i}]"
            out.update(_tensors(v, name, seen))
    return out


def _layout_tensors(cm):
    """Every tensor of a compiled model's graphs and its node inputs."""
    out = {"x": cm.x, "labels": cm.labels, "train_mask": cm.train_mask}
    for i, g in enumerate(cm.full_graphs[:1] + (cm.train_graphs or [])):
        out.update(_tensors(g, f"graph{i}"))
    return out


def phase_csr_stable(arxiv):
    """Two compiles of GCN_DSL on the Arxiv stand-in (lower's bell_order
    relabel and its training subgraphs rebuild CSRs of 2.1M edges through
    the native counting sort) give bitwise-equal layouts; compile seconds
    with the stable sort (both compiles) and with the copied source's
    atomic-cursor sort it replaced (native.coo_to_csr_cursors), and the
    seconds of the native sort calls inside each.  Returns the stable
    compile (phase pallas-bell compares against it)."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch import native

    if not native.available():
        raise AssertionError("[csr-stable] the native library did not build")
    real = native.coo_to_csr_native

    def compile_with(sort):
        spent = []

        def timed_sort(*args):
            t0 = time.perf_counter()
            out = sort(*args)
            spent.append((int(np.asarray(args[0]).shape[0]), time.perf_counter() - t0))
            return out

        native.coo_to_csr_native = timed_sort
        try:
            t0 = time.perf_counter()
            cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", data=arxiv, device="cuda",
                                               strategy="bell")
            torch.cuda.synchronize()
            return cm, time.perf_counter() - t0, spent
        finally:
            native.coo_to_csr_native = real

    runs = {}
    for name, sort in (("stable", real), ("stable again", real),
                       ("cursors", native.coo_to_csr_cursors)):
        cm, seconds, spent = compile_with(sort)
        runs[name] = (cm, seconds, spent)
        print(f"[csr-stable] compile with the {name.split()[0]} native sort: {seconds:.3f} s, "
              f"of which {len(spent)} native CSR builds {sum(s for _, s in spent):.3f} s "
              f"({', '.join(f'{e} edges {s:.4f} s' for e, s in spent)})")
    if not runs["stable"][2]:
        raise AssertionError("[csr-stable] the compile built no CSR through the native sort")
    a, b = (_layout_tensors(runs[k][0]) for k in ("stable", "stable again"))
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    c = _layout_tensors(runs["cursors"][0])
    cursor_differ = [k for k in a if k not in c or not torch.equal(a[k], c[k])]
    print(f"[csr-stable] two stable compiles: {len(a)} tensors, {len(differ)} differ; the "
          f"atomic-cursor compile differs from them in {len(cursor_differ)} "
          f"({', '.join(cursor_differ[:4])}{' ...' if len(cursor_differ) > 4 else ''})")
    if differ or a.keys() != b.keys():
        raise AssertionError(f"[csr-stable] two compiles differ: {differ[:8]}")
    del runs["stable again"], runs["cursors"]
    return runs["stable"][0], {k: round(v[1], 4) for k, v in runs.items()}


def phase_pallas_bell(arxiv, bell_cm):
    """GCN_DSL at strategy='pallas_bell' on the Arxiv stand-in: the bell
    layout (the same tensors as strategy='bell''s compile), 20 epochs
    that launch the SpMM kernel and no plain version, and logits from the
    same weights bitwise those of strategy='bell'."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL

    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", data=arxiv, device="cuda",
                                       strategy="pallas_bell")
    g = cm.full_graphs[0]
    a, b = _layout_tensors(cm), _layout_tensors(bell_cm)
    same_layout = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"[pallas-bell] strategy pallas_bell -> {g.strategy}: {g.bell.flat_cols.shape[0]} "
          f"slots; every layout tensor equal to strategy bell's: {same_layout}")
    if g.strategy != "bell" or not same_layout:
        raise AssertionError("[pallas-bell] not the bell layout of strategy='bell'")
    _, launches = _train_checked("pallas-bell", cm, 0.7)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[pallas-bell] the path never launched the bell SpMM kernel")
    params = cm.make_params(0)
    with torch.no_grad():
        logits = [m.forward(params, m.full_graphs, m.invariant(m.full_graphs, m.x))
                  for m in (cm, bell_cm)]
    same = torch.equal(*logits)
    print(f"[pallas-bell] logits {tuple(logits[0].shape)} bitwise those of strategy bell: {same}")
    if not same:
        raise AssertionError("[pallas-bell] logits differ from strategy='bell''s")
    return launches


# [checkpoint]'s tolerances: the row gathers' backward adds with atomics,
# so two unbroken runs differ in the last bits; the CPU parity tests'
# tolerances (tests/test_torch_checkpoint.py)
CKPT_LOSS_RTOL, CKPT_PARAM_RTOL, CKPT_PARAM_ATOL = 1e-4, 1e-3, 1e-5


def _diffs(a, b):
    """(max relative loss difference, max |param difference|, params out
    of the tolerance) between two results."""
    la, lb = np.asarray(a.losses), np.asarray(b.losses)
    loss = float(np.max(np.abs(la - lb) / np.abs(lb)))
    pb = dict(b.params.named_parameters())
    worst, bad = 0.0, []
    for name, p in a.params.named_parameters():
        d = (p.detach() - pb[name].detach()).abs()
        worst = max(worst, d.max().item())
        if (d > CKPT_PARAM_ATOL + CKPT_PARAM_RTOL * pb[name].detach().abs()).any():
            bad.append(name)
    return loss, worst, bad


def phase_checkpoint(arxiv, gcn_cm):
    """At full width on the Arxiv stand-in, GCN_DSL (f32, bell) and
    examples/gin.txt (learned epsilons): an unbroken 20-epoch run (twice:
    the atomics' run-to-run spread) against 10 epochs with checkpoint_path
    and 10 more with resume_from (valid_step 5 keeps the graph schedule
    aligned); losses within rtol CKPT_LOSS_RTOL, final params within
    CKPT_PARAM_RTOL / CKPT_PARAM_ATOL; the SpMM kernel launched in both
    segments, no plain version.  Returns launches by segment."""
    import tempfile

    import gala_tpu_torch

    gin = gala_tpu_torch.compile_file(_example("gin"), mode="train", data=arxiv, device="cuda")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cm in (("gcn", gcn_cm), ("gin", gin)):
            tag = f"checkpoint-{name}"
            runs = [cm.train(iters=20, warmup=2) for _ in range(2)]
            ck = os.path.join(tmp, f"{name}.pt")
            segments = []
            for seg, kw in (("first", {"checkpoint_path": ck}), ("resumed", {"resume_from": ck})):
                read = _new_counts()
                segments.append(cm.train(iters=10, warmup=2, **kw))
                launches[f"{tag}-{seg}"], on_cuda = read()
                _no_plain(tag, on_cuda)
                if launches[f"{tag}-{seg}"].get("bell_spmm", 0) <= 0:
                    raise AssertionError(f"[{tag}] the {seg} segment never launched the SpMM")
            first, second = segments
            resumed = dataclasses.replace(second, losses=first.losses + second.losses)
            spread = _diffs(runs[1], runs[0])
            got = _diffs(resumed, runs[0])
            print(f"[{tag}] unbroken 20 epochs twice: max relative loss difference "
                  f"{spread[0]:.3e}, max |param difference| {spread[1]:.3e}; 10 + 10 resumed "
                  f"against unbroken: {got[0]:.3e}, {got[1]:.3e} (tolerance: losses rtol "
                  f"{CKPT_LOSS_RTOL}, params rtol {CKPT_PARAM_RTOL} atol {CKPT_PARAM_ATOL}); "
                  f"launches first {json.dumps(launches[f'{tag}-first'])}, resumed "
                  f"{json.dumps(launches[f'{tag}-resumed'])}; accuracy unbroken "
                  f"{runs[0].max_accuracy:.4f}, resumed "
                  f"{max(first.max_accuracy, second.max_accuracy):.4f}; "
                  f"losses resumed {json.dumps([round(v, 5) for v in second.losses[:3]])} ...")
            if name == "gin":
                eps = {k: float(second.params[k].detach()) for k in ("eps1", "eps2")}
                print(f"[{tag}] epsilons after the resumed segment {json.dumps(eps)}, unbroken "
                      f"{json.dumps({k: float(runs[0].params[k].detach()) for k in eps})}")
            if got[0] > CKPT_LOSS_RTOL or got[2]:
                raise AssertionError(f"[{tag}] resumed run differs from the unbroken one: "
                                     f"losses {got[0]:.3e}, params out of tolerance {got[2]}")
    return launches


def phase_recovery(gcn_cm):
    """train_with_recovery over 24 epochs of GCN_DSL in segments of 8 with
    one injected failure (the second segment's first try): the progress
    file reads 24, test accuracy >= 0.7, the SpMM kernel launched in
    every segment and no plain version; a second call raises "already
    completed"."""
    import tempfile

    from gala_tpu_torch.resilience import load_progress, train_with_recovery

    calls = []

    def flaky_train(**kw):
        calls.append(kw["resume_from"])
        if len(calls) == 2:
            raise RuntimeError("injected device loss")
        return gcn_cm.train(warmup=2, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.pt")
        read = _new_counts()
        res = train_with_recovery(flaky_train, iters=24, checkpoint_path=ck, segment=8,
                                  max_restarts=2,
                                  on_failure=lambda exc, n: print(f"[recovery] restart {n} "
                                                                  f"after: {exc}"))
        launches, on_cuda = read()
        done = load_progress(ck)
        print(f"[recovery] 24 epochs in segments of 8: {len(calls)} train calls (resume_from "
              f"{['yes' if c else 'no' for c in calls]}), progress file {done} epochs, "
              f"{len(res.losses)} losses, max test accuracy {res.max_accuracy:.4f}, launches "
              f"{json.dumps(launches)}")
        _no_plain("recovery", on_cuda)
        if done != 24 or len(calls) != 4 or res.max_accuracy < 0.7:
            raise AssertionError(f"[recovery] progress {done}, {len(calls)} calls, accuracy "
                                 f"{res.max_accuracy}")
        if launches.get("bell_spmm", 0) <= 0:
            raise AssertionError("[recovery] the segments never launched the SpMM kernel")
        try:
            train_with_recovery(flaky_train, iters=24, checkpoint_path=ck, segment=8)
        except RuntimeError as exc:
            if "already completed" not in str(exc):
                raise
            print(f"[recovery] a second call raises: {exc}")
        else:
            raise AssertionError("[recovery] a second call retrained a completed run")
    return launches


def _kernel_identifiers(build_log: str) -> set:
    """The source names of a library's kernels, from the mangled entry
    names ptxas reports: _Z<length><name>..., or _ZN<length><name>...
    (a name in a namespace, the anonymous one among them), whose last
    component is the kernel's."""
    names = set()
    for entry in re.findall(r"Compiling entry function '([^']+)'", build_log):
        nested = entry.startswith("_ZN")
        name, pos = entry, 3 if nested else 2
        while entry.startswith("_Z") and (m := re.match(r"\d+", entry[pos:])):
            pos += len(m.group())
            name, pos = entry[pos : pos + int(m.group())], pos + int(m.group())
            if not nested:
                break
        names.add(name)
    return names


def phase_profile(gcn_cm, spmm_build_log):
    """profile_trace around 3 training epochs of GCN_DSL, inside a marker
    region: the Chrome trace exists, holds device kernels, names the SpMM
    kernel (its symbol read from the trace, matched against the names in
    the build's ptxas report) and the marker region; no warning that the
    profiler recorded no device activity."""
    import tempfile
    import warnings

    from gala_tpu_torch.utils.profiling import marker, profile_trace

    spmm_names = _kernel_identifiers(spmm_build_log)
    with tempfile.TemporaryDirectory() as tmp:
        read = _new_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile_trace(tmp) as log_dir:
                with marker("gala_smoke_train"):
                    gcn_cm.train(iters=3, warmup=1)
        launches, on_cuda = read()
        _no_plain("profile", on_cuda)
        traces = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
                  if f.endswith(".json") and not f.endswith(".counts.json")]
        if len(traces) != 1:
            raise AssertionError(f"[profile] expected one trace in {log_dir}, found {traces}")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    spmm = sorted(k for k in kernels if any(n in k for n in spmm_names))
    regions = [e for e in events if e.get("name") == "gala_smoke_train"]
    profiler_warnings = [str(w.message) for w in caught if "profile_trace" in str(w.message)]
    print(f"[profile] trace {size} bytes, {len(events)} events, {len(kernels)} distinct device "
          f"kernels; SpMM kernels named in it (ptxas entries {sorted(spmm_names)}): {spmm}; "
          f"marker regions {len(regions)}; launches {json.dumps(launches)}; profiler "
          f"warnings {profiler_warnings}")
    if not spmm or not regions or profiler_warnings or launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[profile] the trace does not name the SpMM kernel or the marker "
                             "region, or the profiler recorded no device activity; kernels "
                             f"in it: {sorted(kernels)[:8]}")
    return launches


def _evaluate_headers(path):
    """{job: the CSV header its job function appends to} of an evaluation
    script, read from its text."""
    with open(path) as f:
        src = f.read()
    blocks = re.split(r"^def job_", src, flags=re.M)[1:]
    return {b.split("(", 1)[0]: re.search(r'append_csv\(\s*out,\s*"([^"]+)"', b).group(1)
            for b in blocks}


def phase_evaluate():
    """scripts/evaluate_torch.py in-process: fig16 on Cora, 10 epochs, at
    strategy auto ('dense' at Cora's size) and at pallas_bell with the tag
    'pallas' (the bell layout: the SpMM kernel for gcn, gin and sage, the
    fused attention's forward and bwd2 kernels for gat); every row
    well-formed and finite, and each job's CSV header equal to
    scripts/evaluate.py's.  Returns the launches of each run."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location("evaluate_torch",
                                                  os.path.join("scripts", "evaluate_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    want, got = (_evaluate_headers(os.path.join("scripts", f"{name}.py"))
                 for name in ("evaluate", "evaluate_torch"))
    print(f"[evaluate] CSV headers of {len(got)} jobs equal to scripts/evaluate.py's: "
          f"{got == want}")
    if got != want:
        raise AssertionError(f"[evaluate] headers differ: {got} vs {want}")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for strategy, tag in (("auto", ""), ("pallas_bell", "pallas")):
            read = _new_counts()
            twin.main(["--job", "fig16", "--datasets", "Cora", "--iters", "10", "--strategy",
                       strategy, "--tag", tag, "--outdir", tmp])
            launches[strategy], on_cuda = read()
            _no_plain("evaluate", on_cuda)
            print(f"[evaluate] fig16 Cora at {strategy}: launches {json.dumps(launches[strategy])}")
        with open(os.path.join(tmp, "stat_fig16.csv")) as f:
            lines = f.read().strip().splitlines()
        with open(os.path.join(tmp, "devices.csv")) as f:
            print(f"[evaluate] devices.csv: {f.read().strip().splitlines()[-1]}")
    rows = [ln.split(",") for ln in lines[1:]]
    labels = [r[1] for r in rows]
    print(f"[evaluate] stat_fig16.csv: {lines[0]}; rows {json.dumps(lines[1:])}")
    if lines[0] != want["fig16"] or labels != twin.MODELS + [f"{m}-pallas" for m in twin.MODELS]:
        raise AssertionError(f"[evaluate] header {lines[0]}, labels {labels}")
    if not all(len(r) == 6 and all(math.isfinite(float(v)) for v in r[2:5]) for r in rows):
        raise AssertionError(f"[evaluate] malformed rows {rows}")
    bell = launches["pallas_bell"]
    if min(bell.get(k, 0) for k in ("bell_spmm", "attn_fwd", "attn_bwd2")) <= 0:
        raise AssertionError(f"[evaluate] the pallas_bell rows did not launch the SpMM and the "
                             f"fused attention's forward and bwd2: {bell}")
    return launches

# The [export] phase's child: a fresh python3 that loads the artifact (no
# compiler: it checks sys.modules), saves its forward's logits under the
# artifact's own weights, and replays `iters` epochs with every launch
# count zeroed just before and read just after.
_EXPORT_CHILD = """
import json, sys, time
import torch
from gala_tpu_torch.export import load_exported
from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

path, logits_path, iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
t0 = time.perf_counter()
em = load_exported(path)
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
torch.save(em.forward().detach().cpu(), logits_path)
reset_counts()
res = em.train(iters=iters)
torch.cuda.synchronize()
counts = all_counts().values()
print(json.dumps({
    "load_s": load_s, "device": str(em.device), "train_s": res.total_time,
    "inference_s": res.inference_time, "max_accuracy": res.max_accuracy, "losses": res.losses,
    "launches": {c.name: c.launches for c in counts if c.launches},
    "on_cuda": {c.name: c.reference_calls_on_cuda for c in counts if c.reference_calls_on_cuda},
    "compiler_modules": sorted(m for m in sys.modules if m.split(".")[:2] in [
        ["gala_tpu_torch", p] for p in ("dsl", "ir", "passes", "lowering")]),
    "jax_imported": sorted(m for m in sys.modules
                           if (m + ".").startswith(("jax.", "gala_tpu."))),
}))
"""
EXPORT_ITERS = 20
# program, its live phase, that phase's accuracy guard, the kernels its replay must launch
EXPORT_PROGRAMS = {"gcn": ("GCN_DSL", "train", 0.7, ("bell_spmm",)),
                   "gat": ("GAT_DSL", "gat", 0.6, ("attn_fwd", "attn_bwd2"))}


def phase_export(arxiv, live):
    """GCN_DSL and the fused GAT_DSL (one head), both on bell, on the Arxiv
    stand-in: export on cuda, load the artifact in a fresh python3 (which
    imports no compiler module), its forward under the artifact's weights
    bitwise the live cm.forward under the same weights (gradients on, as
    the artifact was traced), then EXPORT_ITERS replayed epochs: the
    program's kernels launched, no plain version on the card, the [train]
    and [gat] accuracy guards.  Prints the export and load seconds, the
    artifact's MB, and the replay's train and inference ms/epoch beside
    the live `live` runs' ([train], [gat]: warmup 2, training subgraphs
    between validation epochs; the replay: warmup 5, every epoch on the
    full graph).  Returns the replays' launches."""
    import tempfile

    import __graft_entry__
    import gala_tpu_torch
    from gala_tpu_torch.export import export_compiled

    launches = {}
    for name, (dsl, live_tag, min_accuracy, kernels) in EXPORT_PROGRAMS.items():
        tag = f"export-{name}"
        cm = gala_tpu_torch.compile_source(getattr(__graft_entry__, dsl), mode="train",
                                           data=arxiv, device="cuda")
        g = cm.full_graphs[0]
        if g.strategy != "bell" or (name == "gat") != (g.attn is not None):
            raise AssertionError(f"[{tag}] strategy {g.strategy}, attention layout "
                                 f"{g.attn is not None}")
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, "artifact")
            t0 = time.perf_counter()
            export_compiled(cm, art)
            export_s = time.perf_counter() - t0
            files = {f: os.path.getsize(os.path.join(art, f)) for f in sorted(os.listdir(art))}
            logits_path = os.path.join(tmp, "logits.pt")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", _EXPORT_CHILD, art, logits_path,
                                   str(EXPORT_ITERS)], capture_output=True, text=True,
                                  timeout=600)
            child_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"[{tag}] the loading process failed:\n{proc.stderr}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            got = torch.load(logits_path, weights_only=True)
        with torch.enable_grad():
            want = cm.forward(cm.make_params(0), cm.full_graphs,
                              cm.invariant(cm.full_graphs, cm.x)).detach().cpu()
        same = torch.equal(got, want)
        res = live[name]
        print(f"[{tag}] export {export_s:.2f} s, artifact {sum(files.values()) / 1e6:.1f} MB "
              f"({', '.join(f'{f} {n / 1e6:.1f} MB' for f, n in files.items())}); a fresh "
              f"python3 on {out['device']}: load {out['load_s']:.2f} s, whole process "
              f"{child_s:.1f} s; compiler modules imported {out['compiler_modules']}, modules of "
              f"JAX or its package imported {out['jax_imported']}")
        print(f"[{tag}] loaded forward {tuple(got.shape)} bitwise the live cm.forward under "
              f"the same weights: {same}")
        print(f"[{tag}] replay {EXPORT_ITERS} epochs (warmup 5): train "
              f"{out['train_s'] * 1e3:.4f} ms/epoch, inference {out['inference_s'] * 1e3:.4f} "
              f"ms/epoch, max accuracy {out['max_accuracy']:.4f}; live [{live_tag}] (warmup 2): "
              f"train {res.total_time * 1e3:.4f}, inference "
              f"{res.inference_time * 1e3:.4f} ms/epoch, max accuracy {res.max_accuracy:.4f}")
        print(f"[{tag}] replay losses {json.dumps([round(v, 5) for v in out['losses']])}")
        print(f"[{tag}] kernel launches {json.dumps(out['launches'])}, plain-version calls on "
              f"cuda {json.dumps(out['on_cuda'])}")
        _no_plain(tag, out["on_cuda"])
        if out["compiler_modules"] or out["jax_imported"] or out["device"] != "cuda":
            raise AssertionError(f"[{tag}] the loader imported {out['compiler_modules']} "
                                 f"(jax: {out['jax_imported']}) on {out['device']}")
        if not same:
            raise AssertionError(f"[{tag}] the loaded forward differs from the live one: max "
                                 f"{(got - want).abs().max().item():.3e}")
        missing = [k for k in kernels if out["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"[{tag}] the replay never launched {missing}")
        if not all(math.isfinite(v) for v in out["losses"]) or out["max_accuracy"] < min_accuracy:
            raise AssertionError(f"[{tag}] losses {out['losses']}, max accuracy "
                                 f"{out['max_accuracy']} < {min_accuracy}")
        launches[name] = out["launches"]
        del cm
    return launches


SPMD_WORLD = 4       # gloo ranks spawned for [spmd-gcn/gat/ev/tp], all on cuda:0
SPMD_SHARDS = 2      # the data axis of every [spmd-*] mesh but [spmd-tp]'s 2 x 2
SPMD_TOL = 1e-4      # of the largest |value|: logits, invariant prefix, gradients
SPARSER = "G = G.is_sparser(true);"
# tag: (DSL of __graft_entry__ + extra line, passes, mesh, epochs, accuracy guard, kernels
# the run must launch on every rank)
SPMD_PROGRAMS = {
    "spmd-gcn": ("GCN_DSL", "", {}, (SPMD_SHARDS, 1), 20, 0.8, ("bell_spmm",)),
    "spmd-gat": ("GAT_DSL", "", {}, (SPMD_SHARDS, 1), 20, 0.7, ("attn_fwd", "attn_bwd2")),
    "spmd-ev": ("GCN_DSL", SPARSER, {}, (SPMD_SHARDS, 1), 5, None, ("bell_spmm",)),
    "spmd-ev-gat": ("GAT_DSL", "", {"attention_fusion": False}, (SPMD_SHARDS, 1), 5, None,
                    ("bell_spmm", "sddmm")),
    "spmd-tp": ("GCN_DSL", "", {}, (4, 2), 0, None, ()),
}


def _spmd_source(dsl, extra):
    import __graft_entry__

    return getattr(__graft_entry__, dsl) + extra


def _spmd_reference(tag, source, passes, arxiv):
    """The single-device port on the card: make_params(0), the invariant
    prefix, the logits and the gradients of sum(logits[:n]^2), on host."""
    import gala_tpu_torch
    from gala_tpu_torch.dsl.parser import parse_source
    from gala_tpu_torch.weights import params_to_numpy

    spec = parse_source(source)
    for k, v in passes.items():
        setattr(spec.passes, k, v)
    cm = gala_tpu_torch.compile_model(spec, mode="train", data=arxiv, device="cuda")
    params = cm.make_params(0)
    with torch.no_grad():
        carry = cm.invariant(cm.full_graphs, cm.x)
    logits = cm.forward(params, cm.full_graphs, carry)
    n = cm.full_graphs[0].n_nodes
    (logits[:n].float() ** 2).sum().backward()
    grads = {k: v.grad.cpu().numpy() if isinstance(v, torch.Tensor) else
             {kk: vv.grad.cpu().numpy() for kk, vv in v.items()} for k, v in params.items()}
    ref = {"params": params_to_numpy(params), "n": n, "host_graph": cm.host_graph,
           "carry": [v.cpu().numpy() for _, v in sorted(carry.items())],
           "logits": logits.detach().cpu().numpy()[:n], "grads": grads}
    print(f"[{tag}] single-device reference: strategy {cm.full_graphs[0].strategy}, {n} nodes, "
          f"logits {tuple(logits.shape)}")
    del cm
    return ref


def _close(tag, what, got, want, tol=SPMD_TOL):
    """max |got - want| <= tol * max |want|; returns the ratio."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape:
        raise AssertionError(f"[{tag}] {what}: shape {got.shape} != {want.shape}")
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    if not err <= tol:
        raise AssertionError(f"[{tag}] {what}: max |got - reference| = {err:.3e} of the "
                             f"largest > {tol}")
    return err


def _check_spmd(tag, ranks, ref, n_ranks, min_accuracy, kernels, iters):
    """The ranks' results against the single-device reference; returns
    {rank: launches}."""
    from gala_tpu_torch.parallel import worker

    if sorted(ranks) != list(range(n_ranks)):
        raise AssertionError(f"[{tag}] results from ranks {sorted(ranks)}, expected {n_ranks}")
    first = ranks[0]
    n, r = ref["n"], first["rows_per_shard"]
    print(f"[{tag}] {n_ranks} rank(s), mesh {first['shape']}, backend {first['backend']}, "
          f"device {first['device']}, layouts {first['layouts']}, TP plan {first['plan']}; "
          f"compile + shard {max(x['compile_s'] for x in ranks.values()):.1f} s")
    by_d = {}
    for x in ranks.values():
        by_d.setdefault(x["coords"][0], x)
    errs = {"logits": _close(tag, "logits", np.concatenate(
        [by_d[d]["logits"] for d in sorted(by_d)])[:n], ref["logits"])}
    if len(first["carry"]) != len(ref["carry"]):
        raise AssertionError(f"[{tag}] invariant prefix of {len(first['carry'])} tensors, "
                             f"single device {len(ref['carry'])}")
    for i, want in enumerate(ref["carry"]):
        if want.ndim == 2:  # node tensors; edge vectors are in another order
            got = np.concatenate([by_d[d]["carry"][i] for d in sorted(by_d)])
            errs[f"carry[{i}]"] = _close(tag, f"invariant prefix [{i}]", got[:n], want[:n])
    if "grads" in first:
        got = worker.assemble(ranks, "grads")
        for name, want in ref["grads"].items():
            for k, w in (want.items() if isinstance(want, dict) else [(None, want)]):
                g = got[name][k] if k is not None else got[name]
                errs[f"grad {name}{'.' + k if k else ''}"] = _close(tag, f"gradient {name} {k}",
                                                                    g, w)
    print(f"[{tag}] max |sharded - single device| / max |single device|: "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    launches = {}
    label = (f"{n_ranks} ranks on one card, gloo exchange through host memory; not a scale-out "
             "time" if first["backend"] == "gloo" else f"{n_ranks} NCCL rank(s), a card each")
    if iters:
        for rank, x in ranks.items():
            print(f"[{tag}] rank {rank}: {iters} epochs, train {x['total_time'] * 1e3:.3f} "
                  f"ms/epoch, inference {x['inference_time'] * 1e3:.3f} ms/epoch ({label}); "
                  f"max accuracy {x['max_accuracy']:.4f}; losses "
                  f"{json.dumps([round(v, 5) for v in x['losses']])}; kernel launches "
                  f"{json.dumps(x['launches'])}, plain-version calls on cuda "
                  f"{json.dumps(x['on_cuda'])}")
            _no_plain(f"{tag} rank {rank}", x["on_cuda"])
            missing = [k for k in kernels if x["launches"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"[{tag}] rank {rank} never launched {missing}")
            if not all(math.isfinite(v) for v in x["losses"]):
                raise AssertionError(f"[{tag}] rank {rank}: non-finite loss {x['losses']}")
            if min_accuracy is not None and x["max_accuracy"] < min_accuracy:
                raise AssertionError(f"[{tag}] rank {rank}: max accuracy {x['max_accuracy']} "
                                     f"< {min_accuracy}")
            launches[rank] = x["launches"]
        if len({tuple(x["losses"]) for x in ranks.values()}) != 1:
            raise AssertionError(f"[{tag}] the ranks' losses differ")
    return launches


def phase_spmd_kernels(hosts, kernel, ak, ks):
    """The SpMM (forward and transpose, own and per-slot values), attention
    (fwd, bwd1, bwd2) and SDDMM kernels against their plain versions on
    each rank's own layouts at SPMD_SHARDS shards (over the rank's [local |
    halo | zero] gather table) of the host graphs the [spmd-*] programs
    shard (`hosts`: GCN's for the SpMM, the fused GAT's for attention, the
    unfused GAT's for per-slot values and the SDDMM), at the path's
    widths; phase 4's, 6's and 8's tolerances.  Returns {kernel: max
    |kernel - plain|}."""
    from gala_tpu_torch.parallel.graph import ShardedGraph

    tag = "spmd-kernel"
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    errs = {"bell_spmm": 0.0, "attn_fwd": 0.0, "attn_bwd1": 0.0, "attn_bwd2": 0.0, "sddmm": 0.0}
    sharded = {"gcn": ShardedGraph.from_host(hosts["gcn"], SPMD_SHARDS, use_bell=True),
               "gat": ShardedGraph.from_host(hosts["gat"], SPMD_SHARDS, use_bell=True,
                                             attention=True),
               "gat-edge": ShardedGraph.from_host(hosts["gat-edge"], SPMD_SHARDS,
                                                  use_bell=True, edge_vals=True)}

    def check_spmm(rank, what, lay, rows, n_out, perm=None):
        for f in WIDTHS:
            x = rand(rows, f)
            x[-1] = 0  # the zero row
            vals = None
            if perm is not None:
                evals = torch.rand((int(perm.max()) + 1,), generator=gen, device="cuda")
                evals[-1] = 0  # [evals | 0]
                vals = evals.index_select(0, perm).contiguous()
            out = kernel.bell_spmm(lay, x, n_out, vals=vals)
            ref = kernel.bell_spmm_plain(lay, x, n_out, vals)
            scale = kernel.bell_spmm_plain(lay, x.abs(), n_out, vals).float()
            err = (out - ref).abs()
            bad = int((err > ATOL + RTOL * scale).sum())
            errs["bell_spmm"] = max(errs["bell_spmm"], err.max().item())
            print(f"[{tag}] rank {rank} {what} F={f}: max |kernel - plain| "
                  f"{err.max().item():.3e}, {bad} out of tolerance")
            if bad:
                raise AssertionError(f"[{tag}] rank {rank} {what} F={f}: {bad} out of tolerance")

    for rank in range(SPMD_SHARDS):
        lg = sharded["gcn"].local(rank, "cuda")
        r, n_tab = lg.rows_per_shard, lg.n_tab
        print(f"[{tag}] rank {rank} (GCN): r {r}, H {lg.halo}, table {n_tab + 1} rows; bell "
              f"{lg.bell.flat_cols.numel()} slots {lg.bell.units.n_units} units, t_bell "
              f"{lg.t_bell.flat_cols.numel()} slots {lg.t_bell.units.n_units} units")
        check_spmm(rank, "GCN bell", lg.bell, n_tab + 1, r + 1)
        check_spmm(rank, "GCN t_bell", lg.t_bell, r + 1, n_tab + 1)
        lg = sharded["gat-edge"].local(rank, "cuda")
        r, n_tab = lg.rows_per_shard, lg.n_tab
        check_spmm(rank, "unfused-GAT bell, slot values", lg.bell, n_tab + 1, r + 1,
                   lg.ev.edge_perm)
        check_spmm(rank, "unfused-GAT t_bell, slot values", lg.t_bell, r + 1, n_tab + 1,
                   lg.ev.t_edge_perm)
        for f in (32, 40):
            a, b = rand(n_tab + 1, f), rand(r + 1, f)
            out = ks.sddmm(lg.ev.slot_src, lg.ev.slot_dst, a, b)
            ref = ks.sddmm_reference(lg.ev.slot_src, lg.ev.slot_dst, a, b)
            scale = ks.sddmm_reference(lg.ev.slot_src, lg.ev.slot_dst, a.abs(), b.abs())
            err = (out - ref).abs()
            bad = int((err > ATOL + RTOL * scale).sum())
            errs["sddmm"] = max(errs["sddmm"], err.max().item())
            print(f"[{tag}] rank {rank} sddmm over the unfused GAT's forward slots F={f}: max "
                  f"|kernel - plain| {err.max().item():.3e}, {bad} out of tolerance")
            if bad:
                raise AssertionError(f"[{tag}] rank {rank} sddmm F={f}: {bad} out of tolerance")
        lg = sharded["gat"].local(rank, "cuda")
        r, n_tab = lg.rows_per_shard, lg.n_tab
        for hf, nh in ATTN_SHAPES[:2]:
            x, vl, vr, dout = rand(n_tab + 1, hf), rand(n_tab + 1, nh), rand(r + 1, nh), rand(
                r + 1, hf)
            for t in (x, vl, vr, dout):
                t[-1] = 0
            res = ak.compare_with_plain(lg.attn, x, vl, vr, dout, SLOPE, r + 1, n_tab + 1)
            for check, (err, bad) in res.items():
                name = "attn_" + check.split()[0]
                errs[name] = max(errs[name], err)
                if bad:
                    raise AssertionError(f"[{tag}] rank {rank} hf={hf} {check}: {bad} out of "
                                         "tolerance")
            print(f"[{tag}] rank {rank} attention (GAT layouts) hf={hf} H={nh}: "
                  f"{json.dumps({k: float(f'{e:.3e}') for k, (e, _) in res.items()})}")
        del lg
    print(f"[{tag}] layouts and checks in {time.perf_counter() - t0:.1f} s")
    return errs


def phase_spmd(arxiv, kernel, ak, ks):
    """The sharded path (gala_tpu_torch.parallel) on the card: the
    SPMD_PROGRAMS in SPMD_WORLD gloo ranks sharing cuda:0 (one spawn, the
    [spmd-tp] mesh 2 x 2, the others on ranks 0-1), then [spmd-nccl] (one
    NCCL rank, GCN, 5 epochs) and, where the host has two cards or more,
    GCN on NCCL over every card.  Each run's logits, invariant prefix and
    gradients against the single-device port's under the same weights
    (SPMD_TOL of the largest), its accuracy and launches.  Returns
    ({kernel: max |kernel - plain| of phase_spmd_kernels}, {tag: {rank:
    launches}})."""
    import tempfile

    from gala_tpu_torch.parallel import multihost, worker

    refs, jobs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, (dsl, extra, passes, mesh, iters, _, _) in SPMD_PROGRAMS.items():
            source = _spmd_source(dsl, extra)
            key = (source, tuple(passes.items()))
            if key not in refs:
                refs[key] = _spmd_reference(tag, source, passes, arxiv)
            weights = os.path.join(tmp, f"{tag}.weights.pkl")
            worker.dump(refs[key]["params"], weights)
            jobs.append(dict(kind="compiled", name=tag, mesh=mesh, device="cuda", source=source,
                             passes=passes, data=("dataset", "Arxiv", 1.0), weights=weights,
                             shard={"use_bell": True}, iters=iters, warmup=2))
        def ref_of(tag):
            dsl, extra, passes = SPMD_PROGRAMS[tag][:3]
            return refs[(_spmd_source(dsl, extra), tuple(passes.items()))]

        errs = phase_spmd_kernels({"gcn": ref_of("spmd-gcn")["host_graph"],
                                   "gat": ref_of("spmd-gat")["host_graph"],
                                   "gat-edge": ref_of("spmd-ev-gat")["host_graph"]},
                                  kernel, ak, ks)
        pp, pp_nccl, pp_cards, pp_refs = pp_jobs(arxiv, tmp)
        t0 = time.perf_counter()
        multihost.spawn(worker.run_jobs, SPMD_WORLD, "gloo", jobs + pp, tmp, 2,
                        timeout=SPAWN_TIMEOUT)
        print(f"[spmd] {SPMD_WORLD} gloo ranks on cuda:0 (gloo takes the CUDA tensors; its "
              f"exchange crosses host memory) ran {len(jobs)} jobs and {len(pp)} pipeline jobs "
              f"in {time.perf_counter() - t0:.1f} s")
        launches = {}
        for tag, (_, _, _, mesh, iters, min_acc, kernels) in SPMD_PROGRAMS.items():
            ranks = worker.read_results(tmp, tag)
            launches[tag] = _check_spmd(tag, ranks, ref_of(tag), mesh[0], min_acc, kernels,
                                        iters)
            if tag == "spmd-gcn":
                x = ranks[0]
                h = x["halo"]
                print(f"[{tag}] halo: H = {h} rows per shard pair; each exchange sends "
                      f"{x['n_shards'] * h} rows of a rank's [local | halo] table: "
                      + ", ".join(f"{x['n_shards'] * h * f * 4 / 1e6:.1f} MB at F={f}"
                                  for f in (1, 32, 128)))
            if tag == "spmd-ev-gat":
                for rank, n in launches[tag].items():
                    want = 2 * iters  # one SDDMM per learned-value SpMM backward, 2 layers
                    if n.get("sddmm", 0) != want:
                        raise AssertionError(f"[{tag}] rank {rank}: {n.get('sddmm', 0)} SDDMM "
                                             f"launches, expected {want} (one per backward)")
            if tag == "spmd-ev":
                if not ranks[0]["layouts"]["ev"]:
                    raise AssertionError(f"[{tag}] no learned-value layouts")
                print(f"[{tag}] the sparse rewrite's edge values are precomputed (no "
                      f"gradient): SDDMM launches {[n.get('sddmm', 0) for n in launches[tag].values()]}")

        # the pipeline's gloo runs: 4 stages of linear + relu, then the SAGE
        # pipeline on ranks 0-1
        _check_gpipe("pp-gpipe", worker.read_results(tmp, "pp-gpipe"), pp_refs["gpipe"],
                     PP_GPIPE["stages"])
        launches["pp-sage"] = _check_sage("pp-sage", worker.read_results(tmp, "pp-sage"),
                                          pp_refs["sage"])

        # one NCCL rank (GCN; gpipe over one stage); then NCCL over every card
        # where the host has several (GCN; the SAGE pipeline over two)
        nccl = [dict(jobs[0], name="spmd-nccl", mesh=(1, 1), device=None, iters=5)] + pp_nccl
        t0 = time.perf_counter()
        multihost.spawn(worker.run_jobs, 1, "nccl", nccl, tmp, 2, timeout=SPAWN_TIMEOUT)
        print(f"[spmd-nccl] 1 NCCL rank ran in {time.perf_counter() - t0:.1f} s")
        launches["spmd-nccl"] = _check_spmd("spmd-nccl", worker.read_results(tmp, "spmd-nccl"),
                                            ref_of("spmd-gcn"), 1, None, ("bell_spmm",), 5)
        _check_gpipe("pp-nccl", worker.read_results(tmp, "pp-nccl"), pp_refs["gpipe-1"], 1)
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            multi = [dict(jobs[0], name="spmd-nccl-cards", mesh=(n_cards, 1), device=None,
                          iters=5)] + pp_cards
            multihost.spawn(worker.run_jobs, n_cards, "nccl", multi, tmp, 2,
                            timeout=SPAWN_TIMEOUT)
            launches["spmd-nccl-cards"] = _check_spmd(
                "spmd-nccl-cards", worker.read_results(tmp, "spmd-nccl-cards"), ref_of("spmd-gcn"),
                n_cards,
                None, ("bell_spmm",), 5)
            launches["pp-nccl-cards"] = _check_sage(
                "pp-nccl-cards", worker.read_results(tmp, "pp-nccl-cards"), pp_refs["sage"])
        else:
            print(f"[spmd-nccl-cards] [pp-nccl-cards] not run: this host has {n_cards} CUDA "
                  "device (NCCL takes one rank per device)")
    return errs, launches


# the pipeline (gala_tpu_torch.parallel.pp): [pp-sage] train_sage_minibatch's
# defaults (fanouts 25/10, batch 512, hidden 32) over one epoch's
# microbatches a step; [pp-gpipe] linear + relu stages at the SAGE
# activation's width, (1 + 25) x 32 = 832
PP_SAGE = dict(f1=25, f2=10, b=512, hidden=32, seed=0, steps=20)
PP_GPIPE = dict(stages=4, b=512, w=832, seed=0, n_micro=8)
PP_TOL = 1e-5           # [pp-gpipe]: of the largest |value|, output and gradients
PP_ACCURACY_TOL = 0.005  # [pp-sage]: merged params' accuracy against the sequential run's
SPAWN_TIMEOUT = 600     # seconds a rank of [spmd]/[pp] waits on a peer before it fails


def _gpipe_reference(n_stages):
    """The sequential product of [pp-gpipe]'s stages on the card: the
    outputs and the gradient of sum(out^2) to each stage's matrix."""
    from gala_tpu_torch.models.common import full_precision_matmuls
    from gala_tpu_torch.parallel import worker

    full_precision_matmuls()
    g = PP_GPIPE
    mats, xs = worker.gpipe_inputs(n_stages, g["b"], g["w"], g["n_micro"], g["seed"])
    ws = [torch.from_numpy(m).cuda().requires_grad_() for m in mats]
    outs = []
    for x in torch.from_numpy(xs).cuda():
        for w in ws:
            x = torch.relu(x @ w)
        outs.append(x)
    out = torch.stack(outs)
    (out ** 2).sum().backward()
    return {"out": out.detach().cpu().numpy(), "grads": [w.grad.cpu().numpy() for w in ws]}


def _sequential_sage(arxiv, micro):
    """[pp-sage]'s sequential single-device reference on the card: the same
    init (models.sage.init from PP_SAGE's seed), the same microbatches, one
    Adam step a step on the mean of the microbatches' masked losses
    (forward_minibatch, the gather kernel).  Step 1's loss and params,
    every loss, ms a step and the full-graph test accuracy after
    PP_SAGE["steps"] steps."""
    from gala_tpu_torch.models import sage
    from gala_tpu_torch.ops.graph import Graph
    from gala_tpu_torch.train import make_optimizer, masked_accuracy, masked_cross_entropy
    from gala_tpu_torch.train_minibatch import forward_minibatch
    from gala_tpu_torch.weights import params_to_numpy

    g_host, feats, labels, masks = arxiv
    g = Graph.from_host(g_host, device="cuda")
    xt = g.pad_nodes(np.asarray(feats, np.float32))
    params = sage.init(torch.Generator().manual_seed(PP_SAGE["seed"]), feats.shape[1],
                       [PP_SAGE["hidden"]], int(labels.max()) + 1).to("cuda")
    opt = make_optimizer(params)
    m = {k: torch.from_numpy(v).cuda() for k, v in micro.items()}
    n = m["t"].shape[0]
    out = {"losses": [], "step_ms": []}
    for i in range(PP_SAGE["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = sum(masked_cross_entropy(forward_minibatch(params, xt, m["t"][j], m["n1"][j],
                                                          m["n2"][j]).float(),
                                        m["y"][j], m["m"][j]) for j in range(n)) / n
        loss.backward()
        if i == 0:
            out["grads1"] = {k: p.grad.cpu().numpy() for k, p in params.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss.detach()))
        if i == 0:  # a copy: on the CPU the arrays would share the params' memory
            out["params1"] = copy.deepcopy(params_to_numpy(params))
    with torch.no_grad():
        out["accuracy"] = float(masked_accuracy(
            sage.forward(params, [g, g], xt), g.pad_nodes(np.asarray(labels, np.int64)),
            g.pad_nodes(np.asarray(masks["test"], bool))))
    return out


def pp_jobs(arxiv, tmp):
    """The [pp] jobs of the gloo spawn (parallel.worker's pp_gpipe on 4
    ranks, pp_sage on 2), the NCCL spawn's ([pp-nccl]: gpipe over one rank)
    and, for a host of 2 cards or more, the SAGE pipeline over NCCL; and
    their sequential references on the card.  Returns (gloo jobs, nccl
    jobs, cards jobs, refs)."""
    from gala_tpu_torch.data.minibatch import NeighborSampler
    from gala_tpu_torch.parallel import worker

    t0 = time.perf_counter()
    g_host, _, labels, masks = arxiv
    p = PP_SAGE
    # one epoch of train_sage_minibatch's sampler (epoch 0, seed 0, dynamic)
    eb = NeighborSampler(g_host, (p["f1"], p["f2"]), p["b"]).epoch(
        np.flatnonzero(np.asarray(masks["train"])), 0, seed=p["seed"])
    micro = {"t": eb.targets, "n1": eb.n1, "n2": eb.n2,
             "y": np.asarray(labels, np.int64)[eb.targets], "m": eb.mask}
    micro_path = os.path.join(tmp, "pp-micro.pkl")
    worker.dump(micro, micro_path)
    refs = {"sage": _sequential_sage(arxiv, micro), "gpipe": _gpipe_reference(PP_GPIPE["stages"]),
            "gpipe-1": _gpipe_reference(1)}
    seq = refs["sage"]
    print(f"[pp] sequential references on the card in {time.perf_counter() - t0:.1f} s: SAGE "
          f"{eb.targets.shape[0]} microbatches a step, step 1 loss {seq['losses'][0]:.6f}, "
          f"{p['steps']} steps {statistics.median(seq['step_ms'][1:]):.2f} ms a step "
          f"(median after step 1), accuracy {seq['accuracy']:.4f}")
    gp = PP_GPIPE
    gpipe = dict(kind="pp_gpipe", name="pp-gpipe", mesh=(gp["stages"],), device="cuda",
                 b=gp["b"], w=gp["w"], seed=gp["seed"],
                 cases={"warm-up": (1, gp["w"]), "card": (gp["n_micro"], gp["w"]),
                        "again": (gp["n_micro"], gp["w"])})
    sage = dict(kind="pp_sage", name="pp-sage", mesh=(2,), device="cuda",
                data=("dataset", "Arxiv", 1.0), micro=micro_path, f1=p["f1"],
                hidden=p["hidden"], seed=p["seed"], steps=p["steps"])
    nccl = [dict(gpipe, name="pp-nccl", mesh=(1,), device=None)]
    cards = [dict(sage, name="pp-nccl-cards", device=None)]
    return [gpipe, sage], nccl, cards, refs


def _check_gpipe(tag, ranks, ref, n_stages):
    """Every rank's output, and each stage's gradient, within PP_TOL of the
    largest of the sequential product's."""
    if sorted(ranks) != list(range(n_stages)):
        raise AssertionError(f"[{tag}] results from ranks {sorted(ranks)}, expected {n_stages}")
    gp = PP_GPIPE
    errs = {}
    for rank, x in ranks.items():
        case = x["cases"]["card"]
        errs[f"out rank {rank}"] = _close(tag, f"rank {rank} output", case["out"], ref["out"],
                                          PP_TOL)
        errs[f"grad stage {rank}"] = _close(tag, f"stage {rank} gradient", case["grad"],
                                            ref["grads"][rank], PP_TOL)
        again = x["cases"]["again"]
        print(f"[{tag}] rank {rank} ({x['backend']}, {x['device']}): forward "
              f"{case['forward_ms']:.2f} ms, backward {case['backward_ms']:.2f} ms for "
              f"{gp['n_micro']} microbatches of ({gp['b']}, {gp['w']}) f32 (a second call "
              f"{again['forward_ms']:.2f} / {again['backward_ms']:.2f} ms)")
    shift = gp["b"] * gp["w"] * 4
    errs = json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
    print(f"[{tag}] {n_stages} stages, {gp['n_micro']} microbatches: bubble "
          f"{(n_stages - 1) / (gp['n_micro'] + n_stages - 1):.4f}; {shift} bytes a shift, "
          f"{2 * gp['n_micro'] * (n_stages - 1)} shifts a forward and backward; max |pipelined "
          f"- sequential| / max |sequential|: {errs}")


def _check_sage(tag, ranks, ref):
    """Both stages against the sequential run: step 1's loss (rtol 1e-5),
    gradients (PP_TOL of the largest) and merged params (rtol 1e-4, atol
    1e-5), finite falling losses, the
    merged params' accuracy within PP_ACCURACY_TOL, the gather kernel
    3 x n_micro x steps on stage 0 and never on stage 1, the SpMM in
    validation, no plain version on the card.  Returns {rank: launches}."""
    if sorted(ranks) != [0, 1]:
        raise AssertionError(f"[{tag}] results from ranks {sorted(ranks)}, expected [0, 1]")
    steps = PP_SAGE["steps"]
    launches = {}
    for rank, x in ranks.items():
        n = x["n_micro"]
        np.testing.assert_allclose(x["losses"][0], ref["losses"][0], rtol=1e-5,
                                   err_msg=f"[{tag}] rank {rank} step 1 loss")
        for part in ("fc", "sfc"):
            for li in range(2):
                for k in ("w", "b"):
                    np.testing.assert_allclose(x["merged1"][part][li][k],
                                               ref["params1"][part][li][k], rtol=1e-4, atol=1e-5,
                                               err_msg=f"[{tag}] rank {rank} {part}[{li}].{k}")
        # stage s's "l{s+1}.fc.w" is the sequential params' "fc.{s}.w"
        grad_err = max(_close(tag, f"stage {rank} step 1 gradient {name}", g,
                              ref["grads1"][f"{name.split('.')[1]}.{rank}.{name.split('.')[2]}"],
                              PP_TOL)
                       for name, g in x["grads1"].items())
        losses = x["losses"]
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"[{tag}] rank {rank}: losses not finite and falling: {losses}")
        if abs(x["accuracy"] - ref["accuracy"]) > PP_ACCURACY_TOL:
            raise AssertionError(f"[{tag}] rank {rank}: accuracy {x['accuracy']} against the "
                                 f"sequential {ref['accuracy']} (> {PP_ACCURACY_TOL} apart)")
        want = 3 * n * steps if rank == 0 else 0
        if x["gather_calls"] != want or x["launches"].get("gather_rows", 0) != want:
            raise AssertionError(f"[{tag}] stage {rank}: {x['gather_calls']} gather launches in "
                                 f"the steps, {x['launches'].get('gather_rows', 0)} in all, "
                                 f"expected {want}")
        if x["launches"].get("bell_spmm", 0) <= 0:
            raise AssertionError(f"[{tag}] rank {rank}: validation never launched bell_spmm")
        _no_plain(f"{tag} rank {rank}", x["on_cuda"])
        ms = x["step_ms"]
        print(f"[{tag}] stage {rank} ({x['backend']}, {x['device']}): {steps} steps of {n} "
              f"microbatches, {statistics.median(ms[1:]):.2f} ms a step (median after step 1; "
              f"step 1 {ms[0]:.2f}), peak memory allocated {x.get('peak_mb', 0.0):.1f} MiB, "
              f"set-up {x['setup_s']:.1f} s; step 1 gradients within {grad_err:.2e} of the "
              f"largest; losses {json.dumps([round(v, 5) for v in losses])}; "
              f"accuracy {x['accuracy']:.4f} (sequential {ref['accuracy']:.4f}); kernel launches "
              f"{json.dumps(x['launches'])}")
        launches[rank] = x["launches"]
    x = ranks[0]
    shifts = 2 * x["n_micro"]
    shift_ms = ranks[1]["shift_ms"]
    print(f"[{tag}] bubble (P-1)/(n_micro+P-1) = {x['bubble']:.4f}; {x['shift_bytes']} bytes a "
          f"shift, {shifts} shifts a step, {shift_ms:.3f} ms a shift streamed alone ("
          f"{shifts * shift_ms:.1f} ms a step if none overlapped, "
          f"{shifts * shift_ms / statistics.median(x['step_ms'][1:]):.3f} of the step); "
          f"sequential on one device "
          f"{statistics.median(ref['step_ms'][1:]):.2f} ms a step; step 1 loss "
          f"{x['losses'][0]:.6f} against {ref['losses'][0]:.6f}")
    return launches


def kernel_rows(r, dtype, f32=None) -> list:
    """The kernels' line entries of one dtype's phases (`r`: their results;
    at bf16 `f32`, the f32 phases' results, gives each row its f32 time
    beside its own)."""
    sfx, bf = ("", "") if dtype == torch.float32 else ("_bf16", "-bf16")

    def at_f32(row, key):
        if f32 is not None:
            row["f32_ms"] = key(f32)
        return row

    t_kernel, t_plain = r["timings"][("arxiv full bell", 32)]
    ms, by = r["timings"][("bound", 32)]
    widths = {"ms_by_width": {f: r["timings"][("arxiv full bell", f)][0] for f in WIDTHS},
              "bound_ms_by_width": {f: r["timings"][("bound", f)][0] for f in WIDTHS},
              "library_ms_by_width": {f: r["timings"][("library", f)] for f in WIDTHS},
              "tail_by_width": {f: dict(zip(("full_ms", "short_rows_ms", "per_slot_ratio"),
                                            r["timings"][("tail", f)])) for f in WIDTHS}}
    spmm = f"bell_spmm{sfx}"
    paths = {"gcn": r["launches"], "gat-edge": r["edge_launches"].get(spmm, 0),
             "sage-minibatch": r["mb_launches"].get(spmm, 0)}
    if f32 is None:
        paths.update({"gcn-sparser": r["sparser_launches"].get(spmm, 0),
                      "sage": r["sage_launches"].get(spmm, 0),
                      "gin": r["gin_launches"].get(spmm, 0)})
    paths.update({f"sample-{mode}": n.get(spmm, 0) for mode, n in r["sample"].items()
                  if not mode.startswith("dynamic")})  # the sampled form's own row
    paths.update({p: n.get(spmm, 0) for p, n in r.get("paths", {}).items()})
    rows = [at_f32({
        "name": spmm, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": r["launches"],
        "max_abs_err": max(r["max_err"], r["ev_err"]),
        "ms": t_kernel, "plain_ms": t_plain, "bound_ms": ms, "bound_by": by,
        "library_ms": r["timings"][("library", 32)], "at": "arxiv full bell, F=32", **widths,
        "path": ", ".join(f"{p}{bf}" + (" (validation)" if p == "sage-minibatch" else "")
                          for p in paths),
        "path_launches": {f"{p}{bf}": n for p, n in paths.items()},
    }, lambda f: f["timings"][("arxiv full bell", 32)][0])]
    for name in ("attn_fwd", "attn_bwd1", "attn_bwd2"):
        t_kernel, t_plain, ms, by = r["attn_timings"][(name, 32)]
        tail = {"attn_fwd": "tail", "attn_bwd1": "tail bwd1", "attn_bwd2": "tail bwd2"}[name]
        hfs = [hf for hf, _ in ATTN_SHAPES[:2]]
        rows.append(at_f32({
            "ms_by_width": {hf: r["attn_timings"][(name, hf)][0] for hf in hfs},
            "bound_ms_by_width": {hf: r["attn_timings"][(name, hf)][2] for hf in hfs},
            "tail_by_width": {hf: dict(zip(("full_ms", "short_rows_ms", "per_slot_ratio"),
                                           r["attn_timings"][(tail, hf)])) for hf in hfs},
            "name": f"{name}{sfx}", "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_REPLACES[name], "launches": r["gat_launches"].get(f"{name}{sfx}", 0),
            "kernel_phase_launches": r["phase_launches"].get(f"{name}{sfx}", 0),
            "max_abs_err": r["attn_err"][name], "ms": t_kernel, "plain_ms": t_plain,
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "at": "arxiv full attention layout, hf=32, H=1",
            "path": f"gat{bf}" if name != "attn_bwd1" else "kernel phase only (the GAT path "
                                                           "takes the flash identity)",
            "path_launches": {f"gat{bf}": r["gat_launches"].get(f"{name}{sfx}", 0),
                              **{p: n.get(f"{name}{sfx}", 0)
                                 for p, n in r.get("paths", {}).items()
                                 if p.startswith(("evaluate", "export"))}},
        }, lambda f, name=name: f["attn_timings"][(name, 32)][0]))
    if "csr_compile_s" in r:
        rows[0]["compile_s_by_native_sort"] = r["csr_compile_s"]
    if f32 is None:  # the f32 phases' int64 and col_tile checks
        long_err = r["long_err"]
        rows[0]["long_starts_max_abs_err"] = {
            str(dt)[6:]: max(v for k, v in long_err.items()
                             if k.startswith("bell_spmm") and k.endswith("-bf16") == (dt == BF16))
            for dt in (torch.float32, BF16)}
        times, shape, tile_err = r["col_tile"]
        rows[0]["col_tile"] = {
            "at": f"arxiv full bell, G=G.col_tile({COL_TILE})",
            "tiled_ms_by_width": {f: t[0] for f, t in times.items()},
            "untiled_ms_by_width": {f: t[1] for f, t in times.items()},
            "units_partials": shape,
            "max_abs_err": tile_err["bell_spmm"]}
        for row in rows[1:4]:
            row["long_starts_max_abs_err"] = long_err[row["name"]]
            row["col_tile_max_abs_err"] = tile_err[row["name"]]
    t_kernel, t_plain, t_lib, ms, by = r["sddmm_timings"][("sddmm", 32)]
    rows.append(at_f32({
        "name": f"sddmm{sfx}", "route": "cuda", "source": SDDMM_SOURCE,
        "replaces": SDDMM_REPLACES, "launches": r["edge_launches"].get(f"sddmm{sfx}", 0),
        "max_abs_err": r["sddmm_err"], "ms": t_kernel, "plain_ms": t_plain, "bound_ms": ms,
        "bound_by": by, "library_ms": t_lib, "at": "arxiv full edge list, F=32",
        "path": f"gat-edge{bf}",
        "ms_by_width": {f: r["sddmm_timings"][("sddmm", f)][0] for f in SDDMM_WIDTHS},
        "bound_ms_by_width": {f: r["sddmm_timings"][("sddmm", f)][3] for f in SDDMM_WIDTHS},
        "path_launches": {f"gat-edge{bf}": r["edge_launches"].get(f"sddmm{sfx}", 0),
                          **({} if f32 is not None else {
                              "gcn-sparser": r["sparser_launches"].get("sddmm", 0)})},
    }, lambda f: f["sddmm_timings"][("sddmm", 32)][0]))
    t_kernel, t_plain, t_lib, ms, by = r["gather_times"]
    rows.append(at_f32({
        "name": f"gather_rows{sfx}", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": GATHER_REPLACES, "launches": r["mb_launches"].get("gather_rows", 0),
        "max_abs_err": r["gather_err"], "ms": t_kernel, "plain_ms": t_plain, "bound_ms": ms,
        "bound_by": by, "library_ms": t_lib,
        "at": f"arxiv feature table (169,343 x 128 {'f32' if f32 is None else 'bf16'}), one "
              "batch's n2 (128,000 rows)",
        "path": f"sage-minibatch{bf}",
        "path_launches": {f"sage-minibatch{bf}": r["mb_launches"].get("gather_rows", 0)},
    }, lambda f: f["gather_times"][0]))
    if "spmd" in r:  # the sharded path: each rank's launches, the per-rank layout checks
        for row in rows:
            if row["name"] in r["spmd_err"]:
                row["spmd_max_abs_err"] = r["spmd_err"][row["name"]]
            spmd = {f"{tag} rank {rank}": n[row["name"]] for tag, ranks in r["spmd"].items()
                    for rank, n in ranks.items() if n.get(row["name"])}
            if spmd:
                row["path_launches"].update(spmd)
                row["path"] += ", " + ", ".join(dict.fromkeys(k.rsplit(" rank", 1)[0]
                                                              for k in spmd))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    import gala_tpu_torch
    from gala_tpu_torch.data.datasets import load_dataset
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel
    from gala_tpu_torch.ops.kernels import gather as kg
    from gala_tpu_torch.ops.kernels import sddmm as ks
    from gala_tpu_torch.ops.kernels._build import all_counts, counts_for, toolchain_available

    t_start = time.perf_counter()
    probe_counts = counts_for("toolchain_probe")
    probe_counts.reset()  # the build phase is the probe's path
    with ThreadPoolExecutor(max_workers=6) as pool:
        probe = pool.submit(toolchain_available)
        builds = [pool.submit(mod.build) for mod in (kernel, ak, ks, kg)]
        builds = [b.result() for b in builds]
        probe_ok = probe.result()
    for build in builds:
        print(f"[build] {build.path} in {build.seconds:.1f} s")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")
    reported = {name: sp for build in builds for name, sp in spills(build.log).items()
                if any(k in name for k in NO_SPILL)}
    missing = [k for k in NO_SPILL if not any(k in name for name in reported)]
    missing += [f"{k} (bf16)" for k in NO_SPILL_BF16
                if not any(k in name and BF16_MANGLED in name for name in reported)]
    missing += [f"{SAMPLED[0]} sampled{' (bf16)' if bf else ''}" for bf in (False, True)
                if not any(all(k in name for k in SAMPLED) and (BF16_MANGLED in name) == bf
                           for name in reported)]
    spilled = {name: sp for name, sp in reported.items() if any(sp)}
    n_bf16 = sum(BF16_MANGLED in name for name in reported)
    n_sampled = sum(all(k in name for k in SAMPLED) for name in reported)
    print(f"[build] ptxas reports {len(reported)} instantiations of {', '.join(NO_SPILL)} "
          f"({n_bf16} of them bf16, {n_sampled} the SpMM's sampled form); spills: "
          f"{spilled or 'none'}")
    if missing or spilled:
        raise AssertionError(f"ptxas spills in the redesigned kernels: {spilled}; no report "
                             f"for {missing}")
    print(f"[build] toolchain probe (csrc/probe.cu, built and launched in a child process): "
          f"{probe_ok}")
    if not probe_ok:
        raise AssertionError("the toolchain probe failed")
    probe_launches = probe_counts.launches
    print(f"[build] toolchain probe kernel launches in the probe: {probe_launches}")
    if probe_launches < 1:
        raise AssertionError("the toolchain probe launched no kernel")
    probe = phase_probe()
    # the unit kernels' launch limits, from the CUDA runtime (H = 1, the
    # GAT path's heads, and H = 8, the most the attention kernels take)
    t0 = time.perf_counter()
    limits = {**kernel.launch_limits(), **{f"{name} H=1": lim for name, lim in
                                           ak.launch_limits(1).items()},
              **{f"{name} H=8": lim for name, lim in ak.launch_limits(8).items()}}
    limits_ms = (time.perf_counter() - t0) * 1e3
    for name, lim in limits.items():
        print(f"[build] launch limits {name}: {lim['registers']} registers, "
              f"{lim['static_smem']} B static and {lim['dynamic_smem']} B dynamic shared "
              f"memory per block, {lim['blocks_per_sm']} blocks per SM")
        if lim["blocks_per_sm"] < 1:
            raise AssertionError(f"{name} cannot launch: no block fits an SM")
    seconds = {"build": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[{name}] phase took {seconds[name]:.1f} s")
        return out

    r = {}  # each dtype's results, for the kernels' line
    cm, r["launches"], live_gcn = timed("train", phase_train, gala_tpu_torch)
    r["max_err"], r["timings"] = timed("kernel", phase_kernel, cm, kernel)
    del cm
    gat, r["gat_launches"], live_gat = timed("gat", phase_gat, gala_tpu_torch)
    before = {name: c.launches for name, c in all_counts().items()}
    r["attn_err"], r["attn_timings"] = timed("attn-kernel", phase_attn_kernel, gat, ak)
    r["phase_launches"] = {name: c.launches - before.get(name, 0)
                           for name, c in all_counts().items()}
    del gat
    gat_edge, r["edge_launches"] = timed("gat-edge", phase_gat_edge)
    r["sddmm_err"], r["ev_err"], r["sddmm_timings"] = timed(
        "sddmm-kernel", phase_sddmm_kernel, gat_edge, ks, kernel)
    del gat_edge
    r["sparser_launches"] = timed("gcn-sparser", phase_gcn_sparser)
    arxiv = timed("data", load_dataset, "Arxiv", None, 1.0)
    r["sage_launches"] = timed("sage", phase_sage, arxiv)
    r["gin_launches"] = timed("gin", phase_gin)
    r["mb_launches"] = timed("sage-minibatch", phase_sage_minibatch, arxiv)
    r["gather_err"], r["gather_times"] = timed("gather-kernel", phase_gather_kernel, arxiv, kg)
    timed("cli", phase_cli)
    # int64 indices and column tiling (the col_tile directive)
    r["long_err"] = timed("long-kernel", phase_long_kernel, arxiv, kernel, ak)
    r["long_ms"] = timed("inference-long", phase_inference_long, arxiv)
    r["col_tile"] = timed("col-tile", phase_col_tile, arxiv, kernel, ak)

    # table7's sampling schedules (k = 20) on the same stand-in
    r["sample"] = {}
    for mode in SAMPLE_LINES:
        cm, r["sample"][mode], _ = timed(f"sample-{mode}", phase_sample, mode, arxiv)
        if mode != "dynamic":
            del cm
    seg_cm, r["sample"]["dynamic-segment"], _ = timed(
        "sample-dynamic-segment", phase_sample, "dynamic", arxiv, "segment", torch.float32, 5,
        0.0)
    r["dyn_err"], r["dyn_times"] = timed(
        "dyn-weights-kernel", phase_dyn_weights_kernel, cm, seg_cm, kernel)
    del cm, seg_cm

    # bf16 activations with f32 params (dtype=torch.bfloat16) on the same
    # stand-in, loaded once above: the bf16 forms of the kernels
    b = {}
    cm, b["launches"], _ = timed("train-bf16", phase_train, gala_tpu_torch, BF16, arxiv)
    b["max_err"], b["timings"] = timed("kernel-bf16", phase_kernel, cm, kernel, BF16)
    del cm
    gat, b["gat_launches"], _ = timed("gat-bf16", phase_gat, gala_tpu_torch, BF16, arxiv)
    before = {name: c.launches for name, c in all_counts().items()}
    b["attn_err"], b["attn_timings"] = timed("attn-kernel-bf16", phase_attn_kernel, gat, ak,
                                             BF16)
    b["phase_launches"] = {name: c.launches - before.get(name, 0)
                           for name, c in all_counts().items()}
    del gat
    gat_edge, b["edge_launches"] = timed("gat-edge-bf16", phase_gat_edge, BF16, arxiv, 5, 0.0)
    b["sddmm_err"], b["ev_err"], b["sddmm_timings"] = timed(
        "sddmm-kernel-bf16", phase_sddmm_kernel, gat_edge, ks, kernel, BF16)
    del gat_edge
    b["mb_launches"] = timed("sage-minibatch-bf16", phase_sage_minibatch, arxiv, BF16, 2)
    b["gather_err"], b["gather_times"] = timed("gather-kernel-bf16", phase_gather_kernel, arxiv,
                                               kg, BF16)
    _, launches, _ = timed("sample-dynamic-bf16", phase_sample, "dynamic", arxiv, "auto", BF16,
                           5, 0.0)
    b["sample"] = {"dynamic": launches}

    # checkpoint/resume, failure recovery, profiling and the evaluation
    # twin, on the same stand-in (f32)
    gcn, r["csr_compile_s"] = timed("csr-stable", phase_csr_stable, arxiv)
    r["paths"] = {"pallas-bell": timed("pallas-bell", phase_pallas_bell, arxiv, gcn)}
    r["paths"].update(timed("checkpoint", phase_checkpoint, arxiv, gcn))
    r["paths"]["recovery"] = timed("recovery", phase_recovery, gcn)
    r["paths"]["profile"] = timed("profile", phase_profile, gcn, builds[0].log)
    del gcn
    evaluate = timed("evaluate", phase_evaluate)
    r["paths"].update({f"evaluate-{k}": v for k, v in evaluate.items()})
    # export: the artifact written here, loaded and replayed in a fresh process
    exported = timed("export", phase_export, arxiv, {"gcn": live_gcn, "gat": live_gat})
    r["paths"].update({f"export-{k}": v for k, v in exported.items()})
    # the sharded path: ranks spawned after every library was built above
    r["spmd_err"], r["spmd"] = timed("spmd", phase_spmd, arxiv, kernel, ak, ks)

    kernels = kernel_rows(r, torch.float32) + kernel_rows(b, BF16, f32=r)
    t = r["dyn_times"]
    dyn_paths = {f"sample-{mode}": n.get("bell_spmm_dyn", 0) for mode, n in r["sample"].items()
                 if mode.startswith("dynamic")}
    dyn_paths["sample-dynamic-bf16"] = b["sample"]["dynamic"].get("bell_spmm_dyn_bf16", 0)
    kernels.append({
        "name": "bell_spmm_dyn", "route": "cuda", "source": DYN_SOURCE, "replaces": DYN_REPLACES,
        "launches": dyn_paths["sample-dynamic"], "max_abs_err": r["dyn_err"], "ms": t["ms"][0],
        "ms_min_max": t["ms"][1], "two_step_spmm_ms": t["two_step_spmm_ms"][0],
        "two_step_spmm_ms_min_max": t["two_step_spmm_ms"][1], "plain_ms": t["plain_ms"][0],
        "plain_ms_min_max": t["plain_ms"][1], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "at": f"the dynamic run's full-graph bell, k={SAMPLE_K}, F=32, times its structural "
              "values (medians of 5 runs of 20 calls; two_step_spmm_ms: the SpMM kernel on "
              "weights made beforehand)",
        "path": ", ".join(dyn_paths), "path_launches": dyn_paths,
        "note": "the SpMM kernel's sampled form: the weights made in its staging; replaces "
                "the XLA weights _dyn_counts and _dyn_reweight, no Pallas kernel",
    })
    err, probe_times = probe
    tile = probe_times["128x128"]
    kernels.append({
        "name": "toolchain_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": probe_launches, "max_abs_err": err,
        "ms": tile["ms"][0], "plain_ms": tile["plain_ms"][0], "bound_ms": tile["bound"][0],
        "bound_by": tile["bound"][1], "library_ms": tile["library_ms"][0],
        "at": "x * 2 on a 128 x 128 f32 tile (medians of 5 runs of 50 calls)",
        "by_size": {label: {"ms": t["ms"][0], "ms_min_max": t["ms"][1],
                            "plain_ms": t["plain_ms"][0], "library_ms": t["library_ms"][0],
                            "library_ms_min_max": t["library_ms"][1], "bound_ms": t["bound"][0],
                            "bound_by": t["bound"][1], **({"host_ms_per_call": t["host_ms"]}
                                                          if "host_ms" in t else {})}
                    for label, t in probe_times.items()},
        "path": "build phase (toolchain_available: launched in its child process)",
    })
    kernels.append({
        "name": "launch_limits", "route": "cuda", "source": LIMITS_SOURCE,
        "replaces": LIMITS_REPLACES, "launches": None, "max_abs_err": None, "ms": limits_ms,
        "plain_ms": None, "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None,
        "at": "a CUDA runtime query (cudaFuncGetAttributes, "
              "cudaOccupancyMaxActiveBlocksPerMultiprocessor), host ms; no data kernel",
        "path": "build phase only", "limits": limits,
    })
    print(f"[done] phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
