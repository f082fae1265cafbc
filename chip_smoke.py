#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``), torch and CUDA versions, and builds
   the eight Hopper kernel libraries of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together (timed);
2. holds each kernel — pack, packed_conv2d, fused_binary_mlp,
   popcount_gemm, xnor_gemm, entry_conv — against its plain torch
   version on the
   card at the main paths' shapes and at edge shapes (odd N and F,
   valid_n masking, scalar and per-channel thresholds, pack_out on and
   off, stride 2, valid padding, ragged K, float32 and bf16), and times
   the kernel (its device time per launch, from torch.profiler), the
   plain version and, where one exists, the single PyTorch call that
   computes the same function (``library_ms``, never used by the port;
   both with CUDA events).  pack is held on ragged K (K % 4 != 0, K % 32
   != 0), a view at a 4-byte offset, NaN, -0.0 and denormal products,
   with and without a scale, through its path rule and every path the
   operands allow, and timed at both models' pack shapes at batches 1,
   32 and 256 (BinaryNet's with conv1's alpha as the scale) with every
   path, beside the multiply-then-pack route it replaces; its library
   must load 16 bytes a thread (LDG.E.128) in the vectorised variants.
   popcount_gemm (b1 mma.sync) is held on its edge shapes and on fc3
   and fc8 at batches 1, 32 and 256 in every epilogue, through its plan
   and with every tile forced, each tile timed beside ``torch.matmul``
   on float32 +-1; how many of the six shapes the plan got fastest is
   printed, and every kernel variant must hold BMMAs.  The binary
   kernels and every xnor_gemm
   output with exact sums (integer x, alpha a power of two) must be bit
   for bit equal; xnor_gemm's float outputs on normal x within
   1e-5 * max|y| (float32) or that plus one bf16 ulp (bf16).  xnor_gemm
   (bf16 mma.sync on the tensor cores) is also held at the row-tile
   boundaries (M = 16, 17, 65), with every output tile forced in turn,
   whole K and K split in 3, on x holding +-inf, NaN and values past
   bf16's largest finite (NaN/inf where the plain version has them,
   finite outputs within 1e-5 of their row's max |y|), and two calls on
   the same input must give the same bits; its ptxas report
   (registers, spills), shared memory per variant and the count of HMMA
   instructions in its library (cuobjdump) are printed.  packed_conv2d
   (b1 mma.sync on the tensor cores) is held bit for bit on the edge
   shapes (C32 = 1, 2, 12; odd F; stride 2; a 5x5 VALID window; valid_f
   masking) through its plan and with every tile forced in turn, and on
   the eight main-path convs (BinaryNet conv2-conv6, AlexNet
   conv3-conv5) at batches 256 and 1 in all three epilogues, two calls
   giving the same words; each main conv is timed beside ``F.conv2d``
   (TF32 off) and its bound at the b1 rate, and its library's BMMA/IMMA
   count must not be 0.  Its ``kernels`` entry sums BinaryNet
   conv2-conv6 at batch 256, as in earlier slices.  fused_binary_mlp
   (b1 mma.sync on a thread-block cluster that exchanges activations
   through distributed shared memory) is held bit for bit on five edge
   stacks (odd widths with fewer words than a cluster has blocks, K =
   50 and 97 bits, one layer, AlexNet fc6+fc7 at batch 1, 8 layers) and
   on the six main shapes (BinaryNet fc1+fc2 and AlexNet fc6+fc7 at
   batches 1, 32, 256), through its plan and with every (BM, CS) config
   that fits forced; each config is timed beside the plan's pick, and
   the chained route (one popcount_gemm launch a layer) beside them; how
   many of the six shapes the plan got fastest is printed, and every
   kernel variant in its library must hold BMMAs (cuobjdump).  Its
   ``kernels`` entry is BinaryNet fc1+fc2 at batch 256, as in earlier
   slices.  entry_conv (BinaryNet's conv1 with its signs packed in the
   epilogue, float32 FMAs) is held bit for bit against its plain
   version (cuDNN's conv, then the pack) on 8-bit integer pixels at
   BinaryNet's conv1 at batches 1, 7, 256 and 2048 and on edge shapes
   (K 3 to 7, stride 2, C 1 to 16, F 32 to 256, pad 0, a zero alpha,
   exact zero weights), and timed at batches 256 and 2048 beside its
   FMA bound, its plain version and the two steps it replaces on the
   card (``library_ms``: cuDNN's conv and the pack kernel, device
   time).  The fused half-step residual_conv (packed_conv's mainloop
   with ReActNet's epilogue on its tile: the zero-pad correction, batch
   norm, shortcut, RPReLU and the next sign's words) is held bit for
   bit against its plain version at each of ReActNet-A's 26 half-steps
   at batches 1, 7 and 256, on the signs and stream of the forward's
   own kernels, float stream by its bit patterns and sign words, and
   stem_conv (its 3x3x3 stem, batch norm and signs) at the 224x224 stem
   at those batches and at the 14 shapes of STEM_EDGES; both are timed
   over one forward at batch 256 beside their bound and plain version
   (the stem beside both its bounds, bytes and its products and sums
   unfused at the non-FMA rate, and beside cuDNN's conv alone, TF32
   off).  Bi-Real Net-18's kernels of its own, stem_conv's pooled
   kernel (the 7x7 stride-2 stem, batch norm, 3x3 max pool and signs;
   record ``stem_conv_pool``) and shortcut_conv (its three projections:
   2x2 average, float 1x1 conv, batch norm), are held bit for bit
   against their plain versions at batches 1, 7 and 256 on 8-bit pixels
   and the forward's own streams (its 16 fused half-steps too), and
   timed over one forward at batch 256 beside their bounds, plain
   versions and cuDNN's conv or torch's pool and matmul.  Before the
   phases, the
   ``mma.sync`` ceilings of bf16, s8 and b1 from registers are printed;
3. runs full-width BinaryNet CIFAR-10 through the port's entry points
   (``graph.compile(...).init/apply``) at batches 1, 32 and 256, with
   random weights from a seeded generator: the ``"cuda"`` logits must
   equal the ``"torch"`` backend's on the card exactly (and, at batch 1,
   the CPU's, with the head split off at binarize@conv2 returning the
   CPU's alpha-scaled activations), each forward must launch exactly 1
   entry_conv, 5 packed_conv2d, 1 fused_binary_mlp and 1 popcount_gemm,
   and no pack and no elementwise multiply (conv1's alpha is taken in
   entry_conv's epilogue);
4. runs full-width XNOR-AlexNet the same way at batches 1, 32 and 256:
   6 launches per forward (1 pack, 3 packed_conv2d, fc6+fc7 in one
   fused_binary_mlp, 1 popcount_gemm), conv1's and conv2's alpha
   multiplies kept (a float pool follows each: exactly 2 elementwise
   multiplies per forward), ``"cuda"`` logits equal to the
   ``"torch"`` backend's on the card; against the CPU it is split at
   ``binarize@conv3``: the float entry layers (cuDNN, TF32 off) within
   1e-5 * max|h|, then the CPU's float activations through the card's
   binary tail, exact;
4b. runs full-width ReActNet-A (``graph.ir.reactnet_a``, weights
   bound from their published form) at batches 1, 32 and 256 on
   unit-variance float pixels: each forward launches exactly 1
   stem_conv and 26 fused residual_conv (counts reset just before it),
   the ``"cuda"`` logits equal the ``"torch"``
   backend's on the card, and every logit lies within 1e-4 of the
   image's largest logit of the plain reference
   (``repro_torch.reference.reactnet``); full-width Bi-Real Net-18
   (``graph.ir.bireal_net18``) the same way on 8-bit pixels against
   ``repro_torch.reference.bireal``, 1 stem_conv, 3 shortcut_conv and
   16 residual_conv a forward, and at batch 256 also replayed from a
   CUDA graph (counts reset just before the replay), its logits equal
   to eager ``apply``'s;
5. replays both models at batches 1, 32 and 256 from one CUDA graph
   per forward (``graph.replay.GraphedApply``): the replayed logits
   must equal eager ``apply``'s bit for bit, and a replay must run 8
   and 6 of the port's kernels (the counts its capture recorded;
   the profiler's too where it shows a graph's kernels); prints ms per
   forward and images/s both ways, the capture time and the pool's
   memory;
6. serves full-width BinaryNet through ``BNNServer(max_batch=256,
   prewarm=True)`` — 512 requests of 1..256 rows (seed 0) from 4 client
   threads, twice (the first burst after start-up and the steady
   state), then 64 single-row requests one at a time — and XNOR-AlexNet
   through ``max_batch=32`` with 64 requests: every result must equal
   eager ``apply`` on its own rows, at most ``trace_bound`` graphs, no
   fallback
   and no retry; then one forced ``BackendFault`` must take the
   degraded step: the same kernels rerun eagerly on the card, without
   the graph (never the plain ``"torch"`` versions), the same logits,
   counted once.  Prints images/s, p50/p99 latency and the in-flight
   peak;
7. times the fused stack against the chained route (one popcount_gemm
   launch a layer), both replayed from CUDA graphs, at the six main
   shapes, the words equal;
8. drives ``binary_dense`` (the float->binary boundary layer, on
   xnor_gemm) at the decode GEMMs of the repo's LLM configs — (M, K, N)
   = (128, 4096, 4096), (128, 12288, 12288), (1, 8192, 8192) — in bf16
   and float32 through the public entry point, one launch each (two
   where K is split: the parts, then their sum);
9. trains full-width BinaryNet (``repro_torch.train``, random init from
   a seeded generator) on the reference's synthetic 10-class 32x32x3
   stream, the reference benchmark's job: 60 STE steps at batch 8, lr
   0.02; the eval accuracy on 4 held-out batches must exceed chance +
   0.15, and the same run checkpointed every 20 steps, cut at 30 and
   resumed must equal the uninterrupted one bit for bit (losses and
   params, bn, opt); the trained state is folded, exported and compiled
   for the ``"cuda"`` backend: ``check_sign_identity`` on 256 held-out
   rows must give exactly the eval forward's logits with 2 entry_conv
   (the eval forward's conv1 runs it too), 5 packed_conv2d, 1
   fused_binary_mlp and 1 popcount_gemm launch, and
   ``BNNServer(max_batch=256)`` the same logits; then 20 steps at batch
   256 are timed after 3 warm-ups (ms per step, images/s, peak memory),
   two steps' device time is split by torch.profiler (cuDNN convs,
   cuBLAS matmuls, the AdamW update, torch's elementwise kernels, the
   host-to-device copy), and one checkpoint save is timed;
10. runs the TULIP model and its simulator (``repro_torch.core``,
   ``repro_torch.sim``) on the card: ``run_torch`` must equal
   ``run_numpy`` (regs, outs, every cycle's outputs) on 256 PEs with
   random product bits for the scheduled programs of 9, 288 and 1023
   inputs, without and with the on-PE compare (ms per program both
   ways); ``run_dse()`` in full (both workloads at batch 2, two PE
   samples a layer, 33 configurations) must hold every gate (logits
   equal to ``apply``'s kernels, TULIP and MAC logits equal, PE
   programs, Table III, the closed form, the run_torch twin, energy
   ratio >= 3x) and equal the committed ``benchmarks/BENCH_dse.json``
   (the calibration, Table III, both designs' metrics, the energy
   ratios, every sweep row, both fronts) at rel_tol 1e-9; ``simulate``
   of BinaryNet at batch 256 and AlexNet at batch 32 (integer images,
   four PE samples a layer) must give ``apply``'s logits on the card bit
   for bit, with seconds per simulate, peak device memory and the
   device time split into the ``_exact_dot`` products, the oracle's
   kernels and the rest;
11. runs the LLM serving path (``repro_torch.models``,
   ``repro_torch.launch.serve``) on the card: (a) the binary surface of
   ``models.layers`` at qwen1.5-0.5b's and mixtral-8x22b's FFN widths
   (1024/2816 and 6144/16384) on 512 rows — ``dense`` with a packed x
   and ``packed_dense`` (one popcount_gemm launch each), the
   ``packed_mlp`` shim over a d -> d_ff -> d_ff -> d stack (the launches
   its plan gives: one fused_binary_mlp) — equal to the ``"torch"``
   backend bit for bit, ms per call beside the bound; (b) all ten
   reduced architectures in float32 (TF32 off): ``forward`` and
   ``prefill`` logits on the card within 1e-4 x max|logit| of the
   port's on the CPU, prefill + one decode step within it of the
   forward; (c) qwen1.5-0.5b at its published config (24 layers,
   vocab 151936, random bf16 params from a seeded generator) served by
   ``Engine`` — 8 requests of 17-200 tokens on 4 slots, max_new 16,
   capacity 256 — dense and packed: tokens/s, ms per prefill bucket,
   ms per decode step, its device time and kernels (torch.profiler),
   ``prefill_traces``, param bytes, peak memory, no port kernel
   launched (the float x packed-weight products are unpack -> matmul,
   as the reference's); then in float32 the packed prefill logits
   within 1e-4 x max|logit| of the dense ones on the packed layout's
   dense twin (the latent weights that are exactly 0, where the two
   layouts differ by the reference's own sign rules, are counted), the
   greedy tokens equal except at counted near-ties of the dense top
   two; (d) mixtral-8x22b, falcon-mamba-7b, recurrentgemma-2b,
   whisper-large-v3 and llama-3.2-vision-11b at full width, depth cut
   (2, 2, 3, 2 + 2 encoder, 5 layers), float32: prefill + 4 decode
   steps against the forward and packed against the dense twin within
   1e-4 x max|logit|, peak memory; each model freed before the next;
12. runs the LLM training path (``repro_torch.launch.train``,
   ``models.loss_fn``, ``chunked_xent``, remat) on the card, under
   deterministic algorithms: (a) all ten reduced architectures in
   float32, batch 2 x seq 16, the same params on the card and the CPU:
   one ``make_train_step``'s loss within 1e-5 (relative), every grad
   leaf within 1e-4 x max|g|, and on the card remat "full" and "dots"
   against "none" (bit for bit, or the largest difference printed and
   held to 1e-4 x max|g|); (b) qwen1.5-0.5b at its published config
   (24 layers, d_model 1024, d_ff 2816, vocab 151936, bf16) with
   logits_chunk 8192 and remat "full", global batch 8 x seq 512,
   through ``train``: 4 uninterrupted steps, then a run cut at 2
   (checkpoints every 2 in a temporary directory) and resumed to 4,
   whose losses, params and opt state must equal the uninterrupted
   run's bit for bit; prints the median step wall ms, device ms, busy
   share, kernels a step and the device time by group (torch.profiler),
   peak device memory, one checkpoint's size and save / restore
   seconds; (c) one loss + backward at that shape with logits_chunk
   8192 against 0: the peak must fall by at least half the full
   float32 logits (2.49 GB); remat "full" / "dots" against "none"
   printed; (d) ``examples/torch_train_bnn_lm.py``'s ``main``, the
   twin of the reference example (4 layers, d_model 128, vocab 2048,
   float32, batch 8 x seq 128, 200 steps, lr 1e-3): its own assert
   holds the mean loss of the last 10 steps below the first 10's.  No
   port kernel runs on this path (each part expects none);
13. runs the data faults, the tuning table and the auditor on the card:
   (a) ``seu_curve`` at 0, 1, 16, 256, 4096 flips and
   ``threshold_curve`` at sigma 0, 0.5, 1, 2, 4 over full-width
   BinaryNet (the script's seeded params, integer images): every row on
   64 images equal to the ``"torch"`` backend's on the CPU, the
   fault-free point argmax_match 1.0 with both deltas 0, each forward
   launching BinaryNet's 8 kernels; both curves' wall time at batch 256;
   (b) ``graph.tuning.tune_models`` times every plan the kernels take at
   every key of BinaryNet's and AlexNet's plans at batches 1, 32 and 256
   (each key's rule plan and time printed beside its best) into
   ``chiprun_out/tuning.json``; at each batch the forward on the rules'
   plans and, the table loaded and the model recompiled, on the tuned
   ones: the logits equal bit for bit, the replayed forward's ms printed
   both ways; a ``BNNServer(max_batch=32, prewarm=True)`` over the table
   captures at most ``trace_bound`` graphs and serves eager ``apply``'s
   logits; (c) ``CompiledBNN.audit()`` passes on both models at batches
   1, 32 and 256 with the table loaded (launches kernel by kernel, no
   banned int32 shape on the card, the shared-memory claims, the trace
   bound), the conv's shared-memory model equals its library's, and a
   planted int32 output (conv2's ``pack_out`` forced off) fails it;
14. runs the example twins and the dry-run: (a) the ``main`` of
   ``examples/torch_quickstart.py`` on the card (its six sections; its
   compiled BinaryNet's forward must launch exactly 1 entry_conv, 5
   packed_conv2d, 1 fused_binary_mlp and 1 popcount_gemm, by the
   counts and by the profiler (asked again, up to 3 times, where it
   shows fewer), its server take no fallback), of
   ``examples/torch_serve_bnn.py`` (dense and packed tokens equal, no
   port kernel) and of ``examples/torch_tulip_asic_sim.py`` (its lines
   equal to its CPU run's, no port kernel); (b)
   ``launch.dryrun.run_cell`` on meta tensors over every arch at
   decode_32k, long_500k and prefill_32k and qwen1.5-0.5b at train_4k,
   baseline and packed: every applicable cell ok, every skip with its
   reason; (c) at 12b's config one ``make_train_step`` counted by
   ``runtime.op_cost`` on meta tensors and on the card: the counts
   equal exactly, the dry-run's scaled count equal to the full one,
   argument + temp bytes within 20% of ``max_memory_allocated``; the
   flop and byte terms at the card's peak printed beside the step's
   device ms;
15. runs the device mesh, the sharding rules and data-parallel
   serving: (a) ``serving.data_mesh()`` over every visible card and, on
   a one-card machine, a mesh of 4 slots on cuda:0 (how many distinct
   cards each spans is printed); (b) full-width BinaryNet served by
   ``BNNServer(max_batch=256, mesh=...)`` on each mesh beside the
   one-device server (all prewarmed): 1, 2, 3, 4, 8, 11 and 255 rows
   each equal to the single-device ``apply`` bit for bit and launching
   8 kernels on every slot that received rows; phase 6's burst (512
   requests of 1..256 rows, seed 0, 4 threads) on every server, each
   result equal to ``apply`` on its own rows, then two steady bursts a
   server in turns (images/s, p50/p99); one flight of 200 rows under
   the profiler (8 kernels x 4 slots on the 4-slot mesh); no fallback,
   levels within ``trace_bound``; (c) XNOR-AlexNet at ``max_batch=32``
   on the same meshes: the split gate against the CPU first, then 1, 2,
   3, 4, 8, 11, 22 and 31 rows, each launching 6 kernels a slot that
   received rows and equal bit for bit to the single-device ``apply``
   of the pieces the mesh ran (cuDNN orders conv2's float sums by the
   batch), and against the whole batch's through the split: the
   pieces' float activations within 1e-5 * max|h|, the served logits
   the binary tail's on them (no burst: a burst's flights are cut where
   the checker cannot see); a flight of 27 rows under the profiler;
   (d) ``runtime.sharding.param_specs``' parameter bytes a device of
   qwen1.5-0.5b and mixtral-8x22b at their published configs on the
   (16, 16) and (2, 16, 16) meshes, baseline and packed (meta tensors);
16. trains SPMD over a ``torch.distributed`` mesh: a world-1 NCCL
   process group (one card takes one rank; a store file in a temporary
   directory, destroyed at the end of the phase) and
   ``launch.mesh.make_process_mesh()`` on it; (a) ``train(mesh=...)``
   at 12b's config and run (qwen1.5-0.5b, bf16, logits_chunk 8192,
   remat "full", batch 8 x seq 512, 4 steps) through the
   tensor-parallel step (the params' local blocks, the per-cycle FSDP
   gathers, the grads' reductions in the backward: each the identity
   with one rank on every axis): its losses, params and opt state
   (DTensors placed by ``param_specs``) must equal 12b's uninterrupted
   run bit for bit (12b's result is kept on the host, not rerun); then
   the mesh step's median wall ms of 5 on 12b's timed batch, printed
   beside 12b's; (b) at 2 layers (published widths), a mesh run cut at
   2 whose checkpoint the plain ``train`` resumes to 4, and a plain run
   cut at 2 that the mesh resumes, each equal to the plain
   uninterrupted run bit for bit; (c) two processes, each a gloo rank
   on the one card (CUDA tensors; ``python3 chip_smoke.py --tp-rank R
   DIR``), on a (data, model) = (1, 2) mesh: the tensor-parallel loss
   and grads of qwen1.5-0.5b at its published widths (2 layers,
   float32, batch 4 x seq 256, its first row's tokens and targets on
   each rank's first and last vocab rows) finite and within 1e-4 (the
   loss, relative; each rank's grad block x its max|g|) of the
   one-process step's on the card.  The
   multi-rank path at larger worlds (tensor parallelism over "model",
   FSDP over "data") runs on the CPU (``tests/test_torch_spmd.py``,
   ``tests/test_torch_tp.py``: 4 gloo ranks);
17. runs the dry-run on the production meshes (after phase 16's
   process group is destroyed): (a) on the host, the dry-run CLI with
   ``--mesh both`` (torch's fake process group of 256 and 512 ranks,
   meta tensors, the card hidden), one process per cell group, all
   started together: qwen1.5-0.5b and mixtral-8x22b at train_4k,
   prefill_32k and decode_32k baseline, and qwen1.5-0.5b decode_32k
   packed, on (16, 16) and (2, 16, 16): every cell ok, each baseline
   record's parameter bytes equal to phase 15d's ``param_specs`` bytes
   a device, each cell's flops, bytes, collectives by kind (the FSDP
   all-gathers, the grads' reduce-scatters, the tensor-parallel and
   batch all-reduces) and argument + temp bytes printed with their
   ratio to the card's memory (over 1.0 printed, not failed): the
   tensor-parallel steps (each layer on its "model" blocks, a cycle's
   weights gathered over "data" when it runs, the caches in their
   ``batch_specs`` blocks); (b) while (a) runs, at 12b's config the
   tensor-parallel mesh step (``make_mesh_train_step`` through
   ``dryrun.place_cell``) counted on meta tensors over a fake world of
   one and run on a world-1 NCCL mesh on the card under the same
   counter: flops and bytes equal exactly, argument + temp within 20%
   of ``max_memory_allocated``.

Steps 3-4 print images/s, ms per forward and peak device memory, step
8 ms per call; the launch counts of the ``kernels`` line are those of
steps 3-6, 8, 9, 10, 11, 13, 14 and 15, each counted from 0 just
before it runs (steps 12, 16 and 17 launch none, each checked) (a graph's
replay counts the kernels
its capture recorded; in step 10 the simulator's oracle ``apply``; in
step 11 the eight held calls of (a); in step 13 the curves, the
untuned and tuned forwards and the tuned server, not the tuner's
timing runs, and not the audit's, whose launches it records apart; in
step 14 the quickstart twin's ``main``; in step 15 the mesh servers'
held rows, bursts and profiled flights).  Any failure raises and exits
non-zero; no phase catches its own failure.  The last line is the
device summary JSON; the line before it the card's name and power
limit; before that the ``kernels`` JSON.  Results also go to
``chip_smoke.json`` in the output directory (see ``main``).
"""
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
MEM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # H100 SXM int8 tensor-core peak, dense ops/s
# +-1 products in b1 (AND-popcount) MMAs: 8x the int8 rate, as the b1
# mma.sync ceiling measured on the card stands to the s8 one
B1_OPS = 8 * INT8_OPS
BF16_OPS = 989e12          # H100 SXM bf16 tensor-core peak, dense FLOP/s
FP32_OPS = 67e12           # H100 SXM float32 outside the tensor cores
# float32 products or sums on their own (no FMA): one an instruction,
# 132 SMs x 128 lanes x 1.98 GHz, half the FMA rate's operations
FP32_UNFUSED_OPS = FP32_OPS / 2
BATCH = 256                # the batch kernel shapes are taken at
BATCHES = (1, 32, 256)     # the batches the forwards run at
DEVICE = "cuda"


def bound(nbytes, ops, rate):
    """Least time for the work, ms: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_b, t_o = nbytes / MEM_BPS * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def n_weight_copies(k, n):
    """Copies of a [K/32, N] word matrix that together exceed the 50 MB
    L2 (at most 16)."""
    return max(1, min(16, -(-(64 << 20) // (4 * k * n // 32))))


def rotating(fn, copies):
    """A call of ``fn`` on the next of ``copies`` each time: weights
    spread over more than the 50 MB L2 are read cold from device
    memory, as a decode step reads each layer's weights."""
    it = itertools.cycle(copies)
    return lambda: fn(next(it))


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of one call, by CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, symbol, iters=20):
    """Device time of one call's launches of the kernels whose symbol
    contains ``symbol`` (``repro_torch.trace.kernel_ms``: torch.profiler,
    an empty session asked again, never a time taken another way)."""
    from repro_torch.trace import kernel_ms as device_ms
    return device_ms(fn, symbol, iters)


def max_abs_err(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {tuple(a.shape)} "
                             f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


class Rand:
    """Seeded inputs made on the card."""

    def __init__(self, seed, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def normal(self, *shape):
        return torch.randn(shape, generator=self.g, device=self.device)

    def pm1(self, *shape):
        return torch.where(self.normal(*shape) > 0, 1.0, -1.0)

    def ints(self, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=self.g,
                             device=self.device, dtype=torch.int32)

    def words(self, *shape):
        """Random int32 words (every bit pattern but 0x7fffffff)."""
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=self.g,
                             device=self.device, dtype=torch.int64
                             ).to(torch.int32)


def expect_launches(what, counts, per_call):
    """Every kernel launched exactly as often as ``per_call`` says (the
    kernels it does not name: never)."""
    want = {k: per_call.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


# ------------------------------------------------------------------ #
# kernel phases                                                        #
# ------------------------------------------------------------------ #
# the main paths' pack shapes [rows per image, K]: BinaryNet's
# binarize@conv2 (with conv1's alpha as the scale) and AlexNet's
# binarize@conv3
PACK_MAIN = [("BinaryNet binarize@conv2", 1024, 128, True),
             ("AlexNet binarize@conv3", 169, 256, False)]
# edge shapes (M, K): K % 4 != 0, K % 32 != 0, K < 32
PACK_EDGES = [(37, 100), (5, 33), (70, 68), (9, 1), (300, 256)]


def pack_operands(rnd, m, k):
    """Normal x with NaN, -0.0 and 0.0 in row 0; a scale [K] with
    negative entries, a zero, and values that make row 1's products
    denormal or round them to 0."""
    x, scale = rnd.normal(m, k), rnd.normal(k)
    x[0, :3] = torch.tensor([float("nan"), -0.0, 0.0])[:k]
    scale[3:4] = 0.0
    if m > 1 and k > 7:
        x[1, 4:8] = torch.tensor([1e-20, -1e-20, 1e-30, 3e-23])
        scale[4:8] = torch.tensor([1e-20, 1e-20, 1e-30, -2e-23])
    return x, scale


def pack_sass():
    """The count of 128-bit global loads (LDG.E.128, with any cache
    qualifier: the loads of x are evict-first, LDG.E.EF.128) in each
    variant of the pack library (cuobjdump): the flat variants must load
    16 bytes a thread."""
    import re
    wide_load = re.compile(r"LDG\.E(\.\w+)*\.128")
    per_kernel, ops, name = {}, set(), None
    for line in sass_of("pack"):
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            per_kernel[name] = 0
        elif name and wide_load.search(line):
            per_kernel[name] += 1
            ops.add(wide_load.search(line).group(0))
    print(f"pack SASS: 128-bit loads ({sorted(ops)}) per kernel variant: "
          f"{per_kernel}")
    wide = [n for n in per_kernel if "flat" in n]
    if len(wide) != 2 or min(per_kernel[n] for n in wide) == 0:
        raise AssertionError("a vectorised pack variant holds no LDG.E.128")
    return per_kernel


def check_pack(rnd, rec):
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack import (PATHS, _launch, pack, pack_path,
                                          pack_plain)
    err = 0

    def paths(k, x, scale):
        """The plan's path first, then every other the operands allow."""
        first = pack_path(k, x.data_ptr(), _build.ptr(scale))
        return [first] + [p for p in PATHS[PATHS.index(first) + 1:]]

    # the edge shapes and a view at a 4-byte offset, with and without
    # the scale, through every path the operands allow
    for m, k in PACK_EDGES:
        x, scale = pack_operands(rnd, m, k)
        xo = torch.empty(m * k + 1, device=DEVICE)[1:].view(m, k)
        xo.copy_(x)
        for xx, sc in itertools.product((x, xo), (None, scale)):
            want = pack_plain(xx, sc)
            tag = (f"pack edge {m}x{k} scale={sc is not None} offset="
                   f"{xx.data_ptr() % 16}")
            err = max(err, check_equal(tag, pack(xx, sc), want))
            for path in paths(k, xx, sc):
                err = max(err, check_equal(f"{tag} {path}",
                                           _launch(xx, sc, path), want))
    x, scale = pack_operands(rnd, 4, 128)
    if [(int(pack(x, scale)[1, 0]) >> b) & 1 for b in range(4, 8)] != \
            [1, 0, 0, 0]:
        raise AssertionError("pack: a denormal product must give 1, one "
                             "that rounds to 0 must give 0")
    shapes = []
    # written before a timed call, as the forward's producer writes just
    # before its pack: dirty lines in the L2 that the pack's reads evict
    dirt = torch.empty(134 << 18, device=DEVICE)        # 134 MiB
    for (name, rows, k, scaled), batch in itertools.product(PACK_MAIN,
                                                            BATCHES):
        m = batch * rows
        x = rnd.normal(m, k)
        scale = (0.5 + rnd.normal(k).abs()) if scaled else None
        want = pack_plain(x, scale)
        tag = f"pack {name} B={batch} [{m}, {k}] scale={scaled}"
        err = max(err, check_equal(tag, pack(x, scale), want))
        path_ms = {}
        for path in paths(k, x, scale):
            err = max(err, check_equal(f"{tag} {path}",
                                       _launch(x, scale, path), want))
            path_ms[path] = kernel_ms(lambda: _launch(x, scale, path),
                                      "pack_kernel")
        ms = kernel_ms(lambda: pack(x, scale), "pack_kernel")
        after_write = kernel_ms(lambda: (dirt.fill_(1.0), pack(x, scale)),
                                "pack_kernel")
        plain = time_ms(lambda: pack_plain(x, scale), 3)
        nbytes = 4 * (m * k + m * ((k + 31) // 32)) + (4 * k if scaled else 0)
        b, by = bound(nbytes, m * k * (2 if scaled else 1), FP32_OPS)
        row = dict(name=name, batch=batch, m=m, k=k, scale=scaled, ms=ms,
                   after_write_ms=after_write, plain_ms=plain, bound_ms=b,
                   bound_by=by, path_ms=path_ms,
                   plan=pack_path(k, x.data_ptr(), _build.ptr(scale)))
        if scaled:
            # what the forward paid before: the separate multiply, then
            # the pack (CUDA events, host included)
            row["two_pass_event_ms"] = time_ms(lambda: pack(x * scale), 10)
            row["one_pass_event_ms"] = time_ms(lambda: pack(x, scale), 10)
        shapes.append(row)
        print(f"{tag}: kernel_ms={ms:.4f} (after a 134 MiB write "
              f"{after_write:.4f}) plain_ms={plain:.4f} "
              f"bound_ms={b:.5f} ({by}); {ms and b / ms:.3f} of the bound; "
              f"path {row['plan']}; every path: " + ", ".join(
                  f"{p} {t:.4f}" for p, t in path_ms.items()) +
              (f"; events: multiply then pack {row['two_pass_event_ms']:.4f}"
               f", pack with the scale {row['one_pass_event_ms']:.4f}"
               if scaled else ""))
    del dirt
    sums = {key: sum(r[key] for r in shapes)
            for key in ("ms", "after_write_ms", "bound_ms")}
    print("pack summed over the six forwards' shapes: " + " ".join(
        f"{key}={v:.5f}" for key, v in sums.items()))
    sass = pack_sass()
    # the kernels line: BinaryNet at batch 256, as in earlier slices
    main = next(r for r in shapes if r["name"].startswith("BinaryNet")
                and r["batch"] == BATCH)
    rec.append(dict(name="pack", route="cuda",
                    source="src/repro_torch/kernels/csrc/pack.cu",
                    replaces="src/repro/kernels/pack.py:40",
                    max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=None, shapes=shapes, sums=sums, sass=sass))


def conv_inputs(rnd, nb, h, w, c, f, k, s, pad):
    from repro_torch.kernels.ops import conv_padding
    from repro_torch.kernels.packed import pack_words
    from repro_torch.kernels.packed_conv import out_size, pad_words_spatial
    ph, pw = conv_padding(pad, k, k)
    x = rnd.pm1(nb, h, w, c)
    wt = rnd.pm1(k, k, c, f)
    xw = pad_words_spatial(pack_words(x, -1), ph, pw).contiguous()
    ww = pack_words(wt, 2).reshape(k * k * xw.shape[-1], f).contiguous()
    geo = dict(kh=k, kw=k, c=c, stride=s, ho=out_size(h, k, s, ph),
               wo=out_size(w, k, s, pw))
    return x, wt, xw, ww, geo, (ph, pw)


# the edge shapes of the conv: (N, H=W, C, F, K, stride, padding,
# threshold, pack_out, cut): odd C and F (C32 = 1, 2, 12; F = 10, 20,
# 33, 40, 37), stride 2, a 5x5 VALID window, C32 = 12 at 13x13 with
# F = 384; packed outputs with valid_f = F (a last word partial where
# F % 32 != 0) and, where cut = 3, valid_f = F - 3
CONV_EDGES = [(2, 8, 33, 20, 3, 1, "same", None, False, 0),
              (1, 9, 64, 32, 3, 2, "same", "scalar", True, 0),
              (1, 9, 64, 32, 3, 2, "same", "scalar", False, 0),
              (1, 7, 16, 10, 5, 1, "valid", "vector", False, 0),
              (2, 6, 3, 40, 3, 1, "same", "vector", True, 0),
              (2, 6, 50, 33, 3, 1, "same", "vector", True, 0),
              (1, 9, 64, 32, 3, 2, "same", "scalar", True, 3),
              (2, 6, 3, 40, 3, 1, "same", "vector", True, 3),
              (2, 6, 50, 33, 3, 1, "same", "vector", True, 3),
              (2, 13, 384, 384, 3, 1, "same", "vector", True, 0),
              (2, 13, 384, 384, 3, 1, "same", "vector", True, 3),
              (1, 13, 384, 37, 3, 1, "same", None, False, 0),
              (3, 11, 96, 70, 3, 2, "valid", "scalar", False, 0)]
CONV_BATCHES = (256, 1)


def conv_epilogues(rnd, f):
    """Keyword sets of the three epilogues, the main path's first: the
    packed decisions of a per-channel threshold, the dot, and +-1."""
    tvec = rnd.ints(-3, 4, f)
    return [dict(threshold_vec=tvec, pack_out=True), dict(),
            dict(threshold_vec=tvec)]


def sass_of(source):
    """The SASS lines of a kernel library (cuobjdump), to count its
    instructions; raises where cuobjdump is missing."""
    import shutil

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError(f"cuobjdump not found: {source}'s tensor-core "
                             f"instructions cannot be counted")
    return subprocess.run([tool, "-sass", str(_build._lib_path(source))],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()


def conv_sass():
    """The count of b1 (BMMA) and int8 (IMMA) tensor-core instructions,
    and of POPC, in the conv's library (cuobjdump): the kernel must have
    tensor-core MMAs.  (Its POPCs count pc_x and pc_w from the MMA
    fragments; no CUDA-core XNOR-popcount sums over K.)"""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.packed_conv import TILES
    lib = _build._load("packed_conv")
    lib.packed_conv2d_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.packed_conv2d_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    print("packed_conv per tile (16-byte copies, K = 144 words): dynamic "
          "shared memory bytes, blocks per SM: " + str({
              f"{bm}x{bn}": (lib.packed_conv2d_smem_bytes(bm, bn),
                             lib.packed_conv2d_blocks_per_sm(bm, bn, 144))
              for bm, bn in TILES}))
    sass = sass_of("packed_conv")
    counts = {op: sum(op in line for line in sass)
              for op in ("BMMA", "IMMA", "POPC", "LDSM")}
    print(f"packed_conv SASS: {counts}")
    if counts["BMMA"] + counts["IMMA"] == 0:
        raise AssertionError("packed_conv's library holds no BMMA or IMMA")
    return counts


def check_conv(rnd, rec):
    import torch.nn.functional as F

    from repro_torch.conv_tiles import MAIN_CONVS
    from repro_torch.kernels.packed_conv import (TILES, _launch,
                                                 packed_conv2d,
                                                 packed_conv2d_plain,
                                                 tile_plan)
    from repro_torch.kernels.ref import full_fp32
    err = 0
    # the edge shapes through the plan, then with every tile forced
    for nb, h, c, f, k, s, pad, thr, pack_out, cut in CONV_EDGES:
        _, _, xw, ww, geo, _ = conv_inputs(rnd, nb, h, h, c, f, k, s, pad)
        kw = dict(geo, pack_out=pack_out, valid_f=f - cut,
                  threshold=2 if thr == "scalar" else None,
                  threshold_vec=rnd.ints(-4, 4, f) if thr == "vector"
                  else None)
        tag = (f"packed_conv2d edge {nb}x{h}x{h}x{c}->{f} k{k} s{s} {pad} "
               f"{thr} pack_out={pack_out} valid_f={f - cut}")
        want = packed_conv2d_plain(xw, ww, **kw)
        err = max(err, check_equal(tag, packed_conv2d(xw, ww, **kw), want))
        for tile in TILES:
            err = max(err, check_equal(f"{tag} tile {tile}",
                                       _launch(xw, ww, tile, **kw), want))
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bound_int8_ms=0.0)
    ops_t = bytes_t = 0.0
    shapes = []
    for batch, (name, hw, c, f) in itertools.product(CONV_BATCHES,
                                                     MAIN_CONVS):
        x, wt, xw, ww, geo, (ph, pw) = conv_inputs(
            rnd, batch, hw, hw, c, f, 3, 1, "same")
        tag = f"packed_conv2d {name} B={batch}"
        kws = conv_epilogues(rnd, f)
        for kw in kws:
            err = max(err, check_equal(f"{tag} {sorted(kw)}",
                                       packed_conv2d(xw, ww, **geo, **kw),
                                       packed_conv2d_plain(xw, ww, **geo,
                                                           **kw)))
        kw = dict(geo, **kws[0])            # the main path's epilogue
        if not torch.equal(packed_conv2d(xw, ww, **kw),
                           packed_conv2d(xw, ww, **kw)):
            raise AssertionError(f"{tag}: two calls differ")
        m = batch * geo["ho"] * geo["wo"]
        plan = tile_plan(m, f, ww.shape[0])
        ms = kernel_ms(lambda: packed_conv2d(xw, ww, **kw),
                       "packed_conv_kernel", 10)
        plain = time_ms(lambda: packed_conv2d_plain(xw, ww, **kw), 1, 1)
        xf = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), value=-1.0)
        wf = wt.permute(3, 2, 0, 1).contiguous()
        with full_fp32():
            lib = time_ms(lambda: F.conv2d(xf, wf))
        del xf, wf
        nbytes = 4 * (xw.numel() + ww.numel() + f + m * ((f + 31) // 32))
        ops = 2 * m * f * 9 * c
        b, by = bound(nbytes, ops, B1_OPS)
        b8 = bound(nbytes, ops, INT8_OPS)[0]
        shapes.append(dict(name=name, batch=batch, m=m, f=f,
                           k_words=ww.shape[0], ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by,
                           bound_int8_ms=b8, plan=plan))
        print(f"{tag}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={b:.5f} ({by}; at the int8 "
              f"rate {b8:.5f}); {ms and b / ms:.3f} of the bound; plan "
              f"{plan}")
        # the kernels line: BinaryNet conv2-conv6 at batch 256, as in
        # earlier slices
        if batch == BATCH and name.startswith("BinaryNet"):
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", b),
                           ("library_ms", lib), ("bound_int8_ms", b8)):
                tot[key] += v
            ops_t += ops
            bytes_t += nbytes
    sass = conv_sass()
    sums = {}
    for group in ("BinaryNet", "AlexNet"):
        for batch in CONV_BATCHES:
            rows = [r for r in shapes
                    if r["name"].startswith(group) and r["batch"] == batch]
            sums[f"{group} B={batch}"] = {
                key: sum(r[key] for r in rows)
                for key in ("ms", "bound_ms", "bound_int8_ms", "library_ms")}
            print(f"packed_conv2d {group} B={batch} summed: " + " ".join(
                f"{key}={v:.5f}" for key, v in
                sums[f"{group} B={batch}"].items()))
    rec.append(dict(name="packed_conv2d", route="cuda",
                    source="src/repro_torch/kernels/csrc/packed_conv.cu",
                    replaces="src/repro/kernels/packed_conv.py:187",
                    max_abs_err=err, **tot,
                    bound_by=bound(bytes_t, ops_t, B1_OPS)[1],
                    shapes=shapes, sums=sums, sass=sass))


def packed_rows(rnd, m, k):
    from repro_torch.kernels.packed import pack_words
    return pack_words(rnd.pm1(m, k), -1).contiguous()


# the fused stack's edge stacks (M, K0, widths, thresholds: an int is a
# scalar): odd widths with fewer words than a cluster has blocks, K = 50
# and 97 bits (4-byte weight copies), one layer, AlexNet's fc6+fc7 at
# batch 1 with a scalar fc7 threshold, and 8 layers
FUSED_EDGES = [(37, 50, [20, 33], [2, "vector"]),
               (301, 97, [300, 65, 40], ["vector", 1, "vector"]),
               (5, 64, [32], ["vector"]),
               (1, 9216, [4096, 4096], ["vector", 0]),
               (70, 128, [64, 40, 96, 33, 20, 300, 65, 10],
                ["vector", 1, "vector", -2, "vector", 0, "vector", 3])]
# the main paths' stacks, each at BATCHES
FUSED_MAIN = [("BinaryNet fc1+fc2", 8192, [1024, 1024]),
              ("AlexNet fc6+fc7", 9216, [4096, 4096])]


def fused_operands(rnd, m, k0, ns, thr):
    x = packed_rows(rnd, m, k0)
    ws, ks, ts, k = [], [], [], k0
    for n, t in zip(ns, thr):
        ws.append(packed_rows(rnd, n, k))
        ks.append(k)
        ts.append(rnd.ints(-5, 5, n) if t == "vector" else t)
        k = n
    return x, ws, ks, ts


def fused_sass():
    """The count of b1 tensor-core instructions (BMMA), POPC and LDSM in
    the fused stack's library (cuobjdump), and of BMMA in each kernel
    variant: every variant must sum on the tensor cores.  (Its POPCs
    count pc_x once a layer from the activation buffer; no CUDA-core
    XNOR-popcount sums over K.)"""
    sass = sass_of("fused_mlp")
    counts = {op: sum(op in line for line in sass)
              for op in ("BMMA", "POPC", "LDSM", "IMMA")}
    per_kernel, name = {}, None
    for line in sass:
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            per_kernel[name] = 0
        elif name and "BMMA" in line:
            per_kernel[name] += 1
    print(f"fused_mlp SASS: {counts}; BMMA per kernel variant: "
          f"{sorted(per_kernel.values())}")
    if not per_kernel or min(per_kernel.values()) == 0:
        raise AssertionError("a fused_mlp kernel variant holds no BMMA")
    return dict(counts, bmma_per_variant=sorted(per_kernel.values()))


def check_fused(rnd, rec):
    from repro_torch.kernels.fused_mlp import (CLUSTERS, ROW_TILES,
                                               SMEM_BYTES, _launch,
                                               fused_mlp_words,
                                               fused_mlp_words_plain,
                                               launch_config, smem_bytes,
                                               stack_plan)
    from repro_torch.kernels.ops import binary_binary_dense
    from repro_torch.kernels.packed import PackedArray
    configs = [(bm, cs) for bm in ROW_TILES for cs in CLUSTERS]

    def fitting(m, k0, ns):
        buf = stack_plan(m, k0, ns)["buf_words"]
        return [c for c in configs if smem_bytes(c[0], buf) <= SMEM_BYTES]

    from repro_torch.kernels import fused_mlp
    dev = torch.device(DEVICE)
    active = {cs: fused_mlp._active_clusters(dev, 16, cs, 288)
              for cs in CLUSTERS}
    print(f"fused_binary_mlp: clusters the card runs at once (BM = 16, "
          f"AlexNet's buffers): {active}")
    err = 0
    # the edge stacks through the plan, then with every config forced
    for m, k0, ns, thr in FUSED_EDGES:
        x, ws, ks, ts = fused_operands(rnd, m, k0, ns, thr)
        tag = f"fused_mlp edge m={m} {k0}->{ns}"
        want = fused_mlp_words_plain(x, ws, ks, ts)
        err = max(err, check_equal(tag, fused_mlp_words(x, ws, ks, ts),
                                   want))
        for config in fitting(m, k0, ns):
            err = max(err, check_equal(f"{tag} config {config}",
                                       _launch(x, ws, ks, ts, config), want))
    shapes, fastest = [], 0
    for (name, k0, ns), batch in itertools.product(FUSED_MAIN, BATCHES):
        x, ws, ks, ts = fused_operands(rnd, batch, k0, ns,
                                       ["vector"] * len(ns))
        tag = f"fused_binary_mlp {name} B={batch}"
        want = fused_mlp_words_plain(x, ws, ks, ts)
        got = fused_mlp_words(x, ws, ks, ts)
        err = max(err, check_equal(tag, got, want))
        if not torch.equal(got, fused_mlp_words(x, ws, ks, ts)):
            raise AssertionError(f"{tag}: two calls differ")
        plan = launch_config(x.device, batch, k0, ns, x.shape[1])
        times = {}
        for config in fitting(batch, k0, ns):
            err = max(err, check_equal(f"{tag} config {config}",
                                       _launch(x, ws, ks, ts, config), want))
            times[config] = kernel_ms(
                lambda: _launch(x, ws, ks, ts, config), "fused_mlp_kernel")
        ms = kernel_ms(lambda: fused_mlp_words(x, ws, ks, ts),
                       "fused_mlp_kernel")
        # the chained route: one thresholded, packed popcount_gemm launch
        # a layer, as the plan takes where a stack does not fit
        xp = PackedArray(x, length=k0, axis=-1)
        wps = [PackedArray(w, length=k, axis=-1) for w, k in zip(ws, ks)]

        def chained():
            h = xp
            for w, t in zip(wps, ts):
                h = binary_binary_dense(h, w, threshold=t, pack_out=True)
            return h.words

        err = max(err, check_equal(f"{tag} chained", chained(), want))
        chained_ms = kernel_ms(chained, "popcount_gemm_kernel")
        plain = time_ms(lambda: fused_mlp_words_plain(x, ws, ks, ts), 2, 1)
        nbytes = 4 * (x.numel() + sum(w.numel() for w in ws) + sum(ns)
                      + batch * ((ns[-1] + 31) // 32))
        ops = 2 * batch * sum(n * k for n, k in zip(ns, ks))
        b, by = bound(nbytes, ops, B1_OPS)
        best = min(times, key=times.get)
        fastest += best == plan
        shapes.append(dict(name=name, batch=batch, ms=ms, plain_ms=plain,
                           chained_ms=chained_ms, bound_ms=b, bound_by=by,
                           bound_int8_ms=bound(nbytes, ops, INT8_OPS)[0],
                           plan=list(plan), fastest=list(best),
                           config_ms={f"{bm}x{cs}": t for (bm, cs), t
                                      in times.items()}))
        print(f"{tag}: kernel_ms={ms:.4f} (plan BM={plan[0]} CS={plan[1]}) "
              f"chained_ms={chained_ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={b:.5f} ({by}); {ms and b / ms:.3f} of the bound; "
              f"every config: " + ", ".join(
                  f"{bm}x{cs} {t:.4f}" for (bm, cs), t in times.items()))
    print(f"fused_binary_mlp: the plan's config is the fastest at "
          f"{fastest} of {len(shapes)} main shapes")
    sass = fused_sass()
    sums = {key: sum(r[key] for r in shapes)
            for key in ("ms", "chained_ms", "bound_ms")}
    print(f"fused_binary_mlp summed over the {len(shapes)} shapes: " + " ".join(
        f"{key}={v:.5f}" for key, v in sums.items()))
    # the kernels line: BinaryNet fc1+fc2 at batch 256, as in earlier
    # slices
    main = next(r for r in shapes if r["name"].startswith("BinaryNet")
                and r["batch"] == BATCH)
    rec.append(dict(name="fused_binary_mlp", route="cuda",
                    source="src/repro_torch/kernels/csrc/fused_mlp.cu",
                    replaces="src/repro/kernels/fused_mlp.py:143",
                    max_abs_err=err, ms=main["ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=None,
                    shapes=shapes, sums=sums, sass=sass,
                    plan_fastest=fastest, clusters_at_once=active))


# the main paths' classifier heads: (name, K, N), unthresholded
GEMM_MAIN = [("BinaryNet fc3", 1024, 10), ("AlexNet fc8", 4096, 1000)]
# edge shapes (M, K, N, threshold, pack_out): odd K and N, M = 1, 17, 300
GEMM_EDGES = [(37, 50, 20, "scalar", True), (5, 97, 33, "vector", True),
              (64, 128, 96, "vector", False), (3, 33, 65, None, False),
              (300, 2000, 70, "scalar", False),
              (130, 2000, 70, "vector", True), (1, 4096, 1000, None, False),
              (17, 1061, 65, "vector", True), (300, 1024, 10, "scalar", False)]


def gemm_epilogues(rnd, n):
    """The four epilogues, the main path's first: the dot, +-1 after a
    scalar threshold, +-1 after a per-channel one holding the int32
    extremes, packed decisions with valid_n = N - 3."""
    tvec = rnd.ints(-40, 41, n)
    tvec[:2] = torch.tensor([-2 ** 31, 2 ** 31 - 1], dtype=torch.int32)
    return [dict(), dict(threshold=-3), dict(threshold_vec=tvec),
            dict(threshold_vec=tvec, pack_out=True, valid_n=n - 3)]


def gemm_sass():
    """The count of b1 tensor-core instructions (BMMA), POPC and LDSM in
    the popcount_gemm library (cuobjdump), and of BMMA in each kernel
    variant: every variant must sum on the tensor cores."""
    sass = sass_of("popcount_gemm")
    counts = {op: sum(op in line for line in sass)
              for op in ("BMMA", "POPC", "LDSM", "IMMA")}
    per_kernel, name = {}, None
    for line in sass:
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            per_kernel[name] = 0
        elif name and "BMMA" in line:
            per_kernel[name] += 1
    print(f"popcount_gemm SASS: {counts}; BMMA per kernel variant: "
          f"{sorted(per_kernel.values())}")
    if not per_kernel or min(per_kernel.values()) == 0:
        raise AssertionError("a popcount_gemm kernel variant holds no BMMA")
    return dict(counts, bmma_per_variant=sorted(per_kernel.values()))


def check_gemm(rnd, rec):
    from repro_torch.kernels import _build
    from repro_torch.kernels.packed import unpack_words
    from repro_torch.kernels.popcount_gemm import (TILES, _launch,
                                                   popcount_gemm,
                                                   popcount_gemm_plain,
                                                   tile_plan)
    err = 0

    def tiles_for(kw):
        return [t for t in TILES if not kw.get("pack_out") or t[1] >= 32]

    # the edge shapes through the plan, then with every tile forced
    for m, k, n, thr, pack_out in GEMM_EDGES:
        xp, wp = packed_rows(rnd, m, k), packed_rows(rnd, n, k)
        kw = dict(threshold=2 if thr == "scalar" else None,
                  threshold_vec=rnd.ints(-5, 5, n) if thr == "vector"
                  else None, pack_out=pack_out,
                  valid_n=n - 3 if pack_out else None)
        tag = f"popcount_gemm edge {m}x{k}x{n} {thr} pack_out={pack_out}"
        want = popcount_gemm_plain(xp, wp, k, **kw)
        err = max(err, check_equal(tag, popcount_gemm(xp, wp, k, **kw), want))
        for tile in tiles_for(kw):
            err = max(err, check_equal(f"{tag} tile {tile}",
                                       _launch(xp, wp, k, tile, **kw), want))
    shapes, fastest = [], 0
    for (name, k, n), batch in itertools.product(GEMM_MAIN, BATCHES):
        xp, wp = packed_rows(rnd, batch, k), packed_rows(rnd, n, k)
        tag = f"popcount_gemm {name} B={batch}"
        for kw in gemm_epilogues(rnd, n):
            want = popcount_gemm_plain(xp, wp, k, **kw)
            got = popcount_gemm(xp, wp, k, **kw)
            err = max(err, check_equal(f"{tag} {sorted(kw)}", got, want))
            if not torch.equal(got, popcount_gemm(xp, wp, k, **kw)):
                raise AssertionError(f"{tag}: two calls differ")
            for tile in tiles_for(kw):
                err = max(err, check_equal(f"{tag} {sorted(kw)} tile {tile}",
                                           _launch(xp, wp, k, tile, **kw),
                                           want))
        p = tile_plan(batch, n, k // 32, _build.device_sms(xp.device))
        plan = (p["bm"], p["bn"], p["wk"])
        times = {tile: kernel_ms(lambda: _launch(xp, wp, k, tile),
                                 "popcount_gemm_kernel")
                 for tile in TILES}
        ms = kernel_ms(lambda: popcount_gemm(xp, wp, k),
                       "popcount_gemm_kernel")
        plain = time_ms(lambda: popcount_gemm_plain(xp, wp, k), 5)
        xf = unpack_words(xp, -1)
        wf = unpack_words(wp, -1).t().contiguous()
        if not torch.equal(torch.matmul(xf, wf).to(torch.int32),
                           popcount_gemm(xp, wp, k)):
            raise AssertionError(f"{tag}: float32 matmul yardstick "
                                 f"disagrees")
        lib = time_ms(lambda: torch.matmul(xf, wf), 20)
        nbytes = 4 * (xp.numel() + wp.numel() + batch * n)
        b, by = bound(nbytes, 2 * batch * n * k, B1_OPS)
        best = min(times, key=times.get)
        fastest += best == plan
        shapes.append(dict(name=name, batch=batch, m=batch, k=k, n=n, ms=ms,
                           plain_ms=plain, library_ms=lib, bound_ms=b,
                           bound_by=by, plan=list(plan), fastest=list(best),
                           blocks=p["blocks"],
                           tile_ms={"x".join(map(str, t)): v
                                    for t, v in times.items()}))
        print(f"{tag}: kernel_ms={ms:.4f} (plan {plan}, {p['blocks']} "
              f"blocks) plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={b:.5f} ({by}); {ms and b / ms:.3f} of the bound; "
              f"every tile: " + ", ".join(
                  f"{t} {v:.4f}" for t, v in times.items()))
    print(f"popcount_gemm: the plan's tile is the fastest at {fastest} of "
          f"{len(shapes)} main shapes")
    sums = {key: sum(r[key] for r in shapes)
            for key in ("ms", "bound_ms", "library_ms")}
    print("popcount_gemm summed over the six forwards' shapes: " + " ".join(
        f"{key}={v:.5f}" for key, v in sums.items()))
    sass = gemm_sass()
    # the kernels line: fc3 at batch 256, as in earlier slices
    main = next(r for r in shapes if r["name"] == "BinaryNet fc3"
                and r["batch"] == BATCH)
    rec.append(dict(name="popcount_gemm", route="cuda",
                    source="src/repro_torch/kernels/csrc/popcount_gemm.cu",
                    replaces="src/repro/kernels/popcount_gemm.py:144",
                    max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shapes=shapes, sums=sums,
                    sass=sass, plan_fastest=fastest))


# the decode-shape GEMMs of the repo's LLM configs (the reference's
# benchmarks/kernels_bench.py): (M, K, N); the last two are the d_model
# of Command R+ 104B and Command R 35B
DENSE_SHAPES = [(128, 4096, 4096), (128, 12288, 12288), (1, 8192, 8192)]
DENSE_DTYPES = (torch.bfloat16, torch.float32)


def xnor_operands(rnd, m, k, n, dtype, integer):
    """x [M, K] in ``dtype`` and alpha [N].  Integer x in [-3, 3] with
    alpha in {0.5, 1, 2}: every sum is exact in float32 in any order,
    so kernel and plain version must agree bit for bit."""
    if integer:
        x = rnd.ints(-3, 4, m, k).to(dtype)
        alpha = 2.0 ** rnd.ints(-1, 2, n).to(torch.float32)
    else:
        x = rnd.normal(m, k).to(dtype)
        alpha = 0.5 + 1.5 * torch.rand(n, generator=rnd.g,
                                       device=rnd.device)
    return x, alpha


def float_err(what, got, want):
    """Max abs error of a float output, checked against 1e-5 * max|y|
    (float32 sums in another order); a bf16 output may also differ by
    one bf16 ulp of the larger value (the rounding after the sum)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    tol = 1e-5 * float(w.abs().max())
    lim = torch.full_like(w, tol)
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        lim = lim + 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    if (err > lim).any():
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version beyond the tolerance (max abs err "
                             f"{float(err.max())}, 1e-5*max|y| = {tol})")
    return float(err.max())


def threshold_flips(what, x, wp, alpha, tvec):
    """Normal x: threshold decisions of kernel and plain version may
    differ only where |y - T| is within the float tolerance."""
    from repro_torch.kernels.ref import xnor_gemm_ref
    from repro_torch.kernels.xnor_gemm import xnor_gemm
    y = xnor_gemm_ref(x, wp, alpha)
    got = xnor_gemm(x, wp, alpha, threshold_vec=tvec).float()
    want = torch.where(y >= tvec, 1.0, -1.0)
    diff = got != want
    tol = 1e-5 * float(y.abs().max())
    worst = float((y - tvec).abs()[diff].max()) if diff.any() else 0.0
    if worst > tol:
        raise AssertionError(f"{what}: a threshold bit differs where "
                             f"|y - T| = {worst} > {tol}")
    return int(diff.sum())


def bits_of(t):
    """A float tensor's bit pattern (equal bits, NaN included)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def xnor_tiled(x, wp, alpha, tile, **kw):
    """xnor_gemm with its plan, or (tile not None) with that tile."""
    from repro_torch.kernels.xnor_gemm import _launch, xnor_gemm
    if tile is None:
        return xnor_gemm(x, wp, alpha, **kw)
    return _launch(x, wp, alpha, tile, **kw)


def check_nonfinite(rnd, dt, tile):
    """x holding +-inf, NaN and (float32) values above bf16's largest
    finite, up to +-FLT_MAX, one special value per row: the kernel's
    NaN and +-inf outputs must sit where the plain version's do, and
    every finite output within 1e-5 of its row's max |y| (plus one bf16
    ulp for bf16)."""
    from repro_torch.kernels.xnor_gemm import xnor_gemm_plain
    m, k, n = 19, 544, 97
    x = rnd.normal(m, k)
    big = 3.3e38 if dt == torch.bfloat16 else 3.4e38   # > bf16's max
    top = torch.finfo(dt).max
    inf, nan = float("inf"), float("nan")
    for r, c, v in [(0, 5, inf), (1, 7, -inf), (2, 9, nan), (3, 1, inf),
                    (3, 2, -inf), (4, 100, big), (5, 200, -big),
                    (6, 300, top), (7, 400, -top), (17, 3, nan),
                    (18, 543, -inf)]:
        x[r, c] = v
    x = x.to(dt)
    wp = rnd.words(k // 32, n)
    alpha = torch.ones(n, device=x.device)
    got = xnor_tiled(x, wp, alpha, tile)
    want = xnor_gemm_plain(x, wp, alpha)
    tag = f"xnor_gemm non-finite {dt} tile {tile}"
    g, w = got.float(), want.float()
    if not (torch.equal(g.isnan(), w.isnan()) and
            torch.equal(g.isinf(), w.isinf()) and
            torch.equal(g[g.isinf()], w[w.isinf()])):
        raise AssertionError(f"{tag}: NaN/inf pattern differs from the "
                             f"plain version's")
    fin = torch.isfinite(w)
    wf = torch.where(fin, w, 0.0)
    lim = 1e-5 * wf.abs().amax(dim=1, keepdim=True).expand_as(w)
    if dt == torch.bfloat16:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        lim = lim + 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    bad = fin & ((g - w).abs() > lim)
    if bad.any():
        raise AssertionError(f"{tag}: a finite output differs beyond its "
                             f"row's tolerance")
    if not torch.equal(bits_of(got), bits_of(xnor_tiled(x, wp, alpha,
                                                        tile))):
        raise AssertionError(f"{tag}: two calls differ")


def check_xnor(rnd, rec):
    from repro_torch.kernels.ops import binary_dense
    from repro_torch.kernels.packed import PackedArray, unpack_words
    from repro_torch.kernels.xnor_gemm import (TILES, tile_plan, xnor_gemm,
                                               xnor_gemm_plain)
    err = 0.0
    edges = [(m, k, n, dt, None, False) for m, k, n in
             [(128, 128, 128), (256, 512, 128), (128, 1024, 256),
              (384, 256, 384)] for dt in DENSE_DTYPES]
    edges += [(37, 96, 40, torch.float32, "scalar", True),
              (37, 96, 40, torch.bfloat16, "vector", True),
              (3 * 37, 544, 200, torch.float32, None, False),
              (3 * 37, 544, 200, torch.bfloat16, "vector", False),
              (5, 1024, 65, torch.float32, "scalar", False),
              (1, 2048, 97, torch.bfloat16, "scalar", True),
              # the row-tile boundaries: BM = 16 up to M = 16, then 64
              (16, 544, 97, torch.float32, None, False),
              (16, 96, 40, torch.bfloat16, "vector", True),
              (17, 544, 97, torch.bfloat16, None, False),
              (17, 96, 65, torch.float32, "scalar", True),
              (65, 544, 200, torch.float32, "vector", False),
              (65, 1024, 130, torch.bfloat16, None, False)]
    for m, k, n, dt, thr, pack_out in edges:
        wp = rnd.words(k // 32, n)
        tag = f"xnor_gemm edge {m}x{k}x{n} {dt} {thr} pack_out={pack_out}"
        kw = dict(threshold=0.5 if thr == "scalar" else None,
                  threshold_vec=rnd.ints(-6, 7, n).float()
                  if thr == "vector" else None, pack_out=pack_out,
                  valid_n=n - 5 if pack_out else None)
        x, alpha = xnor_operands(rnd, m, k, n, dt, integer=True)
        check_equal(tag, xnor_gemm(x, wp, alpha, **kw),
                    xnor_gemm_plain(x, wp, alpha, **kw))
        if thr is None:
            x, alpha = xnor_operands(rnd, m, k, n, dt, integer=False)
            err = max(err, float_err(tag + " normal x",
                                     xnor_gemm(x, wp, alpha),
                                     xnor_gemm_plain(x, wp, alpha)))
    # weights that start 4 bytes past a 16-byte boundary (a contiguous
    # view at a storage offset), with N a multiple of 4
    m, k, n = 37, 544, 200
    wp = rnd.words(k // 32 * n + 1)[1:].view(k // 32, n)
    x, alpha = xnor_operands(rnd, m, k, n, torch.bfloat16, integer=True)
    check_equal("xnor_gemm weights at a 4-byte offset",
                xnor_gemm(x, wp, alpha), xnor_gemm_plain(x, wp, alpha))
    # K = 40 through the entry point: x is zero-padded to 64 bits
    x, alpha = xnor_operands(rnd, 9, 40, 33, torch.float32, integer=True)
    wk = PackedArray(rnd.words(2, 33), length=40, axis=-2)
    check_equal("binary_dense K=40", binary_dense(x, wk, alpha),
                binary_dense(x, wk, alpha, backend="torch"))
    # every output tile of the kernel, whole K and K split in 3, in both
    # dtypes, on one ragged shape (M and N not multiples of any tile, K =
    # 17 words: no multiple of BK, and not of 3)
    for (bm, bn), splits, dt in itertools.product(TILES, (1, 3),
                                                  DENSE_DTYPES):
        tile = (bm, bn, splits)
        m, k, n = 150, 544, 200
        wp = rnd.words(k // 32, n)
        x, alpha = xnor_operands(rnd, m, k, n, dt, integer=True)
        tvec = rnd.ints(-6, 7, n).float()
        tag = f"xnor_gemm tile {tile} {m}x{k}x{n} {dt}"
        for kw in (dict(), dict(threshold_vec=tvec, pack_out=True,
                                valid_n=n - 7)):
            check_equal(f"{tag} exact {sorted(kw)}",
                        xnor_tiled(x, wp, alpha, tile, **kw),
                        xnor_gemm_plain(x, wp, alpha, **kw))
        x, alpha = xnor_operands(rnd, m, k, n, dt, integer=False)
        err = max(err, float_err(tag + " normal x",
                                 xnor_tiled(x, wp, alpha, tile),
                                 xnor_gemm_plain(x, wp, alpha)))
    for dt in DENSE_DTYPES:
        for tile in (None, (16, 64, 1), (64, 128, 2)):
            check_nonfinite(rnd, dt, tile)

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    shapes, biggest = [], (0.0, "operations")
    for m, k, n in DENSE_SHAPES:
        n_copies = n_weight_copies(k, n)
        wps = [rnd.words(k // 32, n) for _ in range(n_copies)]
        for dt in DENSE_DTYPES:
            tag = f"xnor_gemm {m}x{k}x{n} {str(dt)[6:]}"
            # float32 x runs three exact bf16 products on the tensor
            # cores: its work is three bf16 GEMMs
            passes = 1 if dt == torch.bfloat16 else 3
            x, alpha = xnor_operands(rnd, m, k, n, dt, integer=True)
            tvec = rnd.ints(-20, 21, n).float()
            for kw in (dict(), dict(threshold_vec=tvec),
                       dict(threshold_vec=tvec, pack_out=True)):
                check_equal(f"{tag} exact {sorted(kw)}",
                            xnor_gemm(x, wps[0], alpha, **kw),
                            xnor_gemm_plain(x, wps[0], alpha, **kw))
            x, alpha = xnor_operands(rnd, m, k, n, dt, integer=False)
            y = xnor_gemm(x, wps[0], alpha)
            e = float_err(tag, y, xnor_gemm_plain(x, wps[0], alpha))
            err = max(err, e)
            if not torch.equal(bits_of(y), bits_of(xnor_gemm(x, wps[0],
                                                             alpha))):
                raise AssertionError(f"{tag}: two calls on the same input "
                                     f"differ")
            flips = threshold_flips(tag, x, wps[0], alpha,
                                    rnd.normal(n) * 10)
            plan = tile_plan(m, n, k // 32, planes=passes)
            call = rotating(lambda w: xnor_gemm(x, w, alpha), wps)
            ms = kernel_ms(call, "xnor_gemm_kernel")
            event_ms = time_ms(call, 20)
            plain = time_ms(rotating(
                lambda w: xnor_gemm_plain(x, w, alpha), wps), 3, 1)
            w_pm1 = unpack_words(wps[0], axis=0, dtype=dt)
            lib = time_ms(lambda: torch.matmul(x, w_pm1) * alpha, 20)
            del w_pm1
            esize = x.element_size()
            nbytes = esize * m * k + 4 * (k // 32) * n + 4 * n \
                + esize * m * n
            b, by = bound(nbytes, 2 * m * k * n * passes, BF16_OPS)
            biggest = max(biggest, (b, by))
            shapes.append(dict(m=m, k=k, n=n, dtype=str(dt), ms=ms,
                               plain_ms=plain, bound_ms=b, bound_by=by,
                               library_ms=lib, event_ms=event_ms,
                               max_abs_err=e, plan=plan,
                               threshold_bits_differing=flips,
                               weight_copies=n_copies))
            print(f"{tag}: kernel_ms={ms:.4f} (events, host included: "
                  f"{event_ms:.4f}) plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b:.5f} ({by}); "
                  f"float max_abs_err {e:.3g}; threshold bits differing "
                  f"on normal x: {flips} of {m * n}; two calls "
                  f"bit-identical; plan {plan}")
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("bound_ms", b), ("library_ms", lib)):
                tot[key] += v
    rec.append(dict(name="xnor_gemm", route="cuda",
                    source="src/repro_torch/kernels/csrc/xnor_gemm.cu",
                    replaces="src/repro/kernels/xnor_gemm.py:126",
                    max_abs_err=err, **tot, bound_by=biggest[1],
                    shapes=shapes))


# entry_conv's shapes beside BinaryNet's conv1 (N, H=W, C, F, K, stride,
# padding): K 5 and 7, stride 2, C 1, 4 and 16, F 32, 96 and 256, VALID
ENTRY_EDGES = [(3, 13, 1, 32, 5, 2, 0), (2, 13, 4, 256, 3, 2, "same"),
               (2, 9, 3, 96, 3, 1, 1), (2, 40, 6, 64, 7, 2, 3),
               (2, 20, 16, 160, 3, 1, 1), (2, 200, 3, 64, 3, 1, 1)]
ENTRY_BATCHES = (1, 7, 256, 2048)        # BinaryNet's conv1
ENTRY_TIMED = (BATCH, 2048)              # timed there


def entry_operands(rnd, n, h, c, f, k):
    """8-bit integer pixels (float32 sums exact in any order), normal
    latent weights with exact zeros, alpha = mean|w| with a zero
    channel."""
    x = rnd.ints(0, 256, n, h, h, c).to(torch.float32)
    w = rnd.normal(k, k, c, f)
    w[0, 0, 0, :3] = 0.0
    alpha = w.abs().mean(dim=(0, 1, 2))
    alpha[5] = 0.0
    return x, w, alpha


def check_entry_conv(rnd, rec):
    from repro_torch.kernels.entry_conv import (entry_conv,
                                                entry_conv_plain,
                                                sign_weight_conv)
    from repro_torch.kernels.pack import pack
    err = 0
    shapes = [(n, 32, 3, 128, 3, 1, 1) for n in ENTRY_BATCHES] + \
        ENTRY_EDGES
    for n, h, c, f, k, s, pad in shapes:
        x, w, alpha = entry_operands(rnd, n, h, c, f, k)
        err = max(err, check_equal(
            f"entry_conv [{n}, {h}, {h}, {c}] k{k} s{s} p{pad} F={f}",
            entry_conv(x, w, alpha, s, pad),
            entry_conv_plain(x, w, alpha, s, pad)))
    rows = []
    for n in ENTRY_TIMED:
        x, w, alpha = entry_operands(rnd, n, 32, 3, 128, 3)

        def two_steps():
            y = sign_weight_conv(x, w, 1, 1)
            return pack(y.reshape(-1, 128), alpha)
        ms = kernel_ms(lambda: entry_conv(x, w, alpha, 1, 1),
                       "entry_convolve_bits_kernel")
        # the two steps' device time: every kernel of the call
        lib = kernel_ms(two_steps, "")
        plain = time_ms(lambda: entry_conv_plain(x, w, alpha, 1, 1), 3)
        nbytes = 4 * (n * 32 * 32 * 3 + n * 32 * 32 * 4 + 27 * 128 + 128)
        b, by = bound(nbytes, 2 * n * 32 * 32 * 128 * 27, FP32_OPS)
        rows.append(dict(batch=n, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b, bound_by=by,
                         ns_per_image=ms * 1e6 / n))
        print(f"entry_conv BinaryNet conv1 B={n}: kernel_ms={ms:.4f} "
              f"({ms * 1e6 / n:.1f} ns an image) plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} (cuDNN conv + pack kernel) "
              f"bound_ms={b:.5f} ({by}); {b / ms:.3f} of the bound")
    main = rows[0]
    rec.append(dict(name="entry_conv", route="cuda",
                    source="src/repro_torch/kernels/csrc/entry_conv.cu",
                    replaces="none (the JAX package leaves conv1 to XLA)",
                    max_abs_err=err, ms=main["ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shapes=rows))


# ReActNet-A's 26 half-steps are held bit for bit at these batches, on
# the signs and stream of the forward's own kernels, and timed over one
# forward at BATCH; the stem also at other sizes, widths, strides and
# pads (N, H, W, F, stride, pad): batches 1 and 7 at 224, an output
# height no tile divides and an odd width, F of 64, 96 and 128 at stride
# 1 and 2, pad 0 and 1, stride 3, three tiles across a row, and 300
# one-tile images (a block walks tiles across images)
RESIDUAL_BATCHES = (1, 7, BATCH)
STEM_EDGES = [(3, 17, 17, 96, 2, 0), (3, 19, 19, 64, 1, 1),
              (5, 224, 224, 32, 2, 1), (1, 224, 224, 32, 2, 1),
              (7, 224, 224, 32, 2, 1), (2, 45, 37, 32, 2, 1),
              (2, 30, 29, 64, 1, 0), (2, 31, 33, 64, 2, 1),
              (2, 23, 23, 96, 1, 1), (2, 21, 19, 128, 2, 1),
              (2, 20, 20, 128, 1, 0), (2, 25, 26, 32, 3, 2),
              (1, 40, 300, 32, 1, 1), (300, 9, 9, 32, 1, 1)]


def residual_calls(cb, params, x):
    """One eager forward of a residual network (ReActNet, Bi-Real Net)
    of ``x`` as its kernels' calls: the stem's arguments, each
    half-step's (its node, the sign's words, the filters, the
    correction, the table, the shortcut map, the fused kernel's
    options) and each projection's (its node, the stream, the 1x1
    weights, the table), each fed by the kernels' outputs."""
    from repro_torch.kernels import residual as kres
    from repro_torch.kernels.packed import PackedArray
    stem, steps, projs, h, bits = None, [], [], None, None
    for step in cb.plan:
        a = step.args
        if step.kind == "real_conv":
            p = params["stem"][a["stem_idx"]]
            stem = (x, p["w"], p["table"], dict(
                stride=a["stride"], pad=a["pad"], pool=a["pool"],
                write_bits=a["sign_next"]))
            h, bits = kres.stem_conv(stem[0], stem[1], stem[2], **stem[3])
        elif step.kind == "residual_conv":
            nd = cb.spec.residual_nodes[a["res_idx"]]
            p = params["res"][a["res_idx"]]
            sc, shortcut = h, a["shortcut"]
            if shortcut == "projection":
                projs.append((nd, h, p["proj_w"], p["proj_table"]))
                sc, shortcut = kres.shortcut_conv(*projs[-1][1:]), "identity"
            call = (nd, PackedArray(bits, length=nd.c_in, axis=-1), p["wf"],
                    p.get("corr"), p["table"], sc,
                    dict(shortcut=shortcut, stride=a["stride"],
                         pad=a["pad"], write_bits=a["sign_next"]))
            steps.append(call)
            h, bits = kres.residual_conv(*call[1:6], **call[6])
    return stem, steps, projs


def float_bits_equal(name, got, want):
    """A kernel's float32 tensor and its plain version's, bit for bit
    (the error in units of the bit patterns)."""
    return check_equal(name, got.view(torch.int32), want.view(torch.int32))


def epilogue_pair_equal(name, got, want):
    err = float_bits_equal(f"{name} stream", got[0], want[0])
    if (got[1] is None) != (want[1] is None):
        raise AssertionError(f"{name}: the kernel and its plain version "
                             f"disagree on writing the signs")
    if got[1] is not None:
        err = max(err, check_equal(f"{name} signs", got[1], want[1]))
    return err


def epilogue_bytes(nd, rows, bits):
    """The least bytes of one fused half-step's epilogue over ``rows``
    images: the float32 stream of every output element, the shortcut
    map it reads (the larger input map where it averages, the
    half-width one where it doubles), and with ``bits`` one bit an
    output element for the next sign."""
    n_out = nd.h_out * nd.w_out * nd.c_out
    sc = {"avgpool": nd.h_in * nd.w_in * nd.c_in,
          "duplicate": nd.h_out * nd.w_out * nd.c_in}.get(nd.shortcut, n_out)
    return rows * (4 * n_out + 4 * sc + (n_out / 8 if bits else 0))


def check_residual(rnd, rec):
    """The fused half-step ``residual_conv``
    (``packed_conv_kernel_residual_epilogue``) at ReActNet-A's 26
    half-steps and ``stem_conv`` at its stem (and at STEM_EDGES), bit
    for bit against their plain versions (``residual_conv_plain``,
    ``stem_conv_plain``), float stream by its bit patterns and sign
    words; each timed over one forward at BATCH beside its bound and
    plain version (two records)."""
    from repro_torch import graph
    from repro_torch.graph.ir import reactnet_a
    from repro_torch.kernels import residual as kres
    cb = graph.compile(reactnet_a(), device=DEVICE, batch=BATCH)
    params = cb.init(torch.Generator().manual_seed(0))
    err_s = err_f = 0
    for n in RESIDUAL_BATCHES:
        # unit-variance pixels: the stem's drawn batch norm centres them
        stem, steps, _ = residual_calls(cb, params,
                                        rnd.normal(n, 224, 224, 3))
        for nd, *call, kw in steps:
            err_f = max(err_f, epilogue_pair_equal(
                f"residual_conv {nd.name} B={n}",
                kres.residual_conv(*call, **kw),
                kres.residual_conv_plain(*call, **kw)))
        err_s = max(err_s, epilogue_pair_equal(
            f"stem_conv ReActNet-A B={n}",
            kres.stem_conv(stem[0], stem[1], stem[2], **stem[3]),
            kres.stem_conv_plain(stem[0], stem[1], stem[2], **stem[3])))
    for n, h, wi, f, s, pad in STEM_EDGES:
        x = rnd.ints(0, 256, n, h, wi, 3).to(torch.float32)
        w = rnd.normal(3, 3, 3, f)

        def u(lo, hi):
            return lo + (hi - lo) * torch.rand(f, generator=rnd.g,
                                               device=DEVICE)
        table = kres.stem_table(rnd.normal(f) * 100, u(1e4, 1.1e5),
                                u(0.5, 1.5), u(-0.5, 0.5), u(-0.5, 0.5))
        args = dict(stride=s, pad=pad)
        err_s = max(err_s, epilogue_pair_equal(
            f"stem_conv [{n}, {h}, {wi}, 3] F={f} s{s} p{pad}",
            kres.stem_conv(x, w, table, **args),
            kres.stem_conv_plain(x, w, table, **args)))
    rec.append(fused_residual_record(steps, err_f))

    x, w, table, args = stem
    ms = kernel_ms(lambda: kres.stem_conv(x, w, table, **args),
                   "stem_conv_bn_sign_kernel")
    plain = time_ms(lambda: kres.stem_conv_plain(x, w, table, **args), 3)
    lib = cudnn_conv_ms(x, w, args)
    st = cb.spec.stem_nodes[0]
    out = BATCH * st.h_out * st.w_out * st.c_out
    nbytes = 4 * x.numel() + 4 * out + out / 8
    # each output's taps: a product and a sum each, unfused (hazard 2b)
    ops = 2 * st.kh * st.kw * st.c_in * out
    b, by = bound(nbytes, ops, FP32_UNFUSED_OPS)
    b_bytes, b_ops = nbytes / MEM_BPS * 1e3, ops / FP32_UNFUSED_OPS * 1e3
    print(f"stem_conv ReActNet-A B={BATCH}: kernel_ms={ms:.4f} "
          f"bound_bytes_ms={b_bytes:.5f} ({nbytes / 1e6:.1f} MB at "
          f"{MEM_BPS / 1e12:.2f} TB/s) bound_ops_ms={b_ops:.5f} "
          f"({ops / 1e9:.2f} G products and sums unfused at "
          f"{FP32_UNFUSED_OPS / 1e12:.1f} T/s) plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} (cuDNN's conv alone, float32, TF32 off); "
          f"{b / ms:.3f} of the bound ({by})")
    rec.append(dict(name="stem_conv", route="cuda",
                    source="src/repro_torch/kernels/csrc/stem_conv.cu",
                    replaces="none (ReActNet is port-only)",
                    max_abs_err=err_s, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, bound_bytes_ms=b_bytes,
                    bound_ops_ms=b_ops, library_ms=lib))


def cudnn_conv_ms(x, w, args):
    """Device ms of cuDNN's float32 conv alone (TF32 off; no batch norm,
    pool or signs: every kernel it runs) on a stem's NHWC ``x`` and
    [K, K, C, F] ``w``."""
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return kernel_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, stride=args["stride"], padding=args["pad"]), "")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def check_bireal(rnd, rec):
    """Bi-Real Net-18's kernels of its own, ``stem_conv``'s pooled kernel
    (``stem_conv_pool_kernel``: the 7x7 stride-2 conv, batch norm, 3x3
    max pool and signs) and ``shortcut_conv`` (its three projections),
    bit for bit against their plain versions at RESIDUAL_BATCHES on
    8-bit pixels and the forward's own streams (its 16 fused half-steps
    too), float maps by their bit patterns and sign words; each timed
    over one forward at BATCH (two records, ``stem_conv_pool`` and
    ``shortcut_conv``)."""
    from repro_torch import graph
    from repro_torch.graph.ir import bireal_net18
    from repro_torch.kernels import residual as kres
    cb = graph.compile(bireal_net18(), device=DEVICE, batch=BATCH)
    params = cb.bind(cb.draw_residual(torch.Generator().manual_seed(0)))
    err_s = err_p = 0
    for n in RESIDUAL_BATCHES:
        x = rnd.ints(0, 256, n, 224, 224, 3).to(torch.float32)
        stem, steps, projs = residual_calls(cb, params, x)
        err_s = max(err_s, epilogue_pair_equal(
            f"stem_conv Bi-Real Net-18 B={n}",
            kres.stem_conv(stem[0], stem[1], stem[2], **stem[3]),
            kres.stem_conv_plain(stem[0], stem[1], stem[2], **stem[3])))
        for nd, *call in projs:
            err_p = max(err_p, float_bits_equal(
                f"shortcut_conv {nd.name} B={n}",
                kres.shortcut_conv(*call), kres.shortcut_conv_plain(*call)))
        for nd, *call, kw in steps:
            epilogue_pair_equal(f"residual_conv {nd.name} B={n}",
                                kres.residual_conv(*call, **kw),
                                kres.residual_conv_plain(*call, **kw))
    rec.append(pooled_stem_record(cb.spec.stem_nodes[0], stem, err_s))
    rec.append(shortcut_record(projs, err_p))


def pooled_stem_record(st, stem, err):
    """The pooled stem kernel on ``stem``'s arguments (one forward's stem
    at BATCH) beside its bounds (bytes: the pixels in, the pooled map
    and the words out; operations: the conv's products and sums
    unfused, as its stated precision has them, and at the FMA peak), its
    plain version and cuDNN's conv alone."""
    from repro_torch.kernels import residual as kres
    x, w, table, args = stem
    ms = kernel_ms(lambda: kres.stem_conv(x, w, table, **args),
                   "stem_conv_pool_kernel")
    plain = time_ms(lambda: kres.stem_conv_plain(x, w, table, **args), 1, 1)
    lib = cudnn_conv_ms(x, w, args)
    ho, wo = st.conv_hw()
    out = BATCH * st.h_out * st.w_out * st.c_out
    nbytes = 4 * x.numel() + 4 * out + out / 8
    ops = 2 * st.kh * st.kw * st.c_in * BATCH * ho * wo * st.c_out
    b, by = bound(nbytes, ops, FP32_UNFUSED_OPS)
    b_bytes, b_ops = nbytes / MEM_BPS * 1e3, ops / FP32_UNFUSED_OPS * 1e3
    b_fma = ops / FP32_OPS * 1e3
    print(f"stem_conv_pool Bi-Real Net-18 B={BATCH}: kernel_ms={ms:.4f} "
          f"bound_bytes_ms={b_bytes:.5f} ({nbytes / 1e6:.1f} MB) "
          f"bound_ops_ms={b_ops:.5f} ({ops / 1e9:.2f} G products and sums "
          f"unfused at {FP32_UNFUSED_OPS / 1e12:.1f} T/s) bound_fma_ms="
          f"{b_fma:.5f} (at {FP32_OPS / 1e12:.0f} TFLOP/s) plain_ms="
          f"{plain:.4f} library_ms={lib:.4f} (cuDNN's conv alone, float32, "
          f"TF32 off); {b / ms:.3f} of the bound ({by}), {b_fma / ms:.3f} "
          f"of the FMA bound")
    return dict(name="stem_conv_pool", route="cuda",
                source="src/repro_torch/kernels/csrc/stem_conv.cu",
                replaces="none (Bi-Real Net is port-only)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, bound_bytes_ms=b_bytes, bound_ops_ms=b_ops,
                bound_fma_ms=b_fma, library_ms=lib)


def shortcut_record(projs, err):
    """shortcut_conv over one forward's three projections at BATCH beside
    its bound (each projection's larger of its maps' bytes and its 1x1
    conv's products and sums unfused, summed), its plain version and
    torch's 2x2 average and matmul (TF32 off, no batch norm)."""
    from repro_torch.kernels import residual as kres

    def each(fn):
        return lambda: [fn(*call) for _, *call in projs]

    def library(x, w, table):
        a = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 2)
        return torch.matmul(a.permute(0, 2, 3, 1), w)
    ms = kernel_ms(each(kres.shortcut_conv), "shortcut_conv_kernel")
    plain = time_ms(each(kres.shortcut_conv_plain), 1, 1)
    lib = kernel_ms(each(library), "")
    b, bys, parts = 0.0, [], []
    for nd, x, w, _ in projs:
        n, h, wi, c = x.shape
        out = n * (h // 2) * (wi // 2) * w.shape[1]
        b_i, by = bound(4 * x.numel() + 4 * out, 2 * out * c,
                        FP32_UNFUSED_OPS)
        b, bys = b + b_i, bys + [by]
        parts.append(f"{nd.name} {b_i:.5f} ({by})")
    print(f"shortcut_conv Bi-Real Net-18 B={BATCH}, 3 projections: "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"(avg_pool2d + matmul, TF32 off) bound_ms={b:.5f} "
          f"({', '.join(parts)}); {b / ms:.3f} of the bound")
    return dict(name="shortcut_conv", route="cuda",
                source="src/repro_torch/kernels/csrc/shortcut_conv.cu",
                replaces="none (Bi-Real Net is port-only)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=" + ".join(bys), library_ms=lib)


def fused_residual_record(steps, err):
    """The fused half-step timed over one forward's 26 launches at
    BATCH: device time beside its bound (the epilogue's bytes at the
    memory's rate plus the convs' operations at the b1 rate) and its
    plain version.  ``err`` is its largest difference from its plain
    version."""
    from repro_torch.kernels import residual as kres

    def fused(fn):
        return lambda: [fn(*call, **kw) for _, *call, kw in steps]
    ms = kernel_ms(fused(kres.residual_conv),
                   "packed_conv_kernel_residual_epilogue")
    plain = time_ms(fused(kres.residual_conv_plain), 1, 0)
    nbytes = sum(epilogue_bytes(nd, BATCH, kw["write_bits"])
                 for nd, *_, kw in steps)
    ops_n = sum(2 * BATCH * nd.h_out * nd.w_out * nd.c_out * nd.k * nd.k *
                nd.c_in for nd, *_ in steps)
    b_bytes, b_ops = nbytes / MEM_BPS * 1e3, ops_n / B1_OPS * 1e3
    b = b_bytes + b_ops
    print(f"residual_conv (fused) ReActNet-A B={BATCH}, 26 half-steps: "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} (bytes "
          f"{b_bytes:.4f}, {nbytes / BATCH / 1e6:.2f} MB an image, + "
          f"operations {b_ops:.4f}); {b / ms:.3f} of the bound")
    return dict(name="residual_conv", route="cuda",
                source="src/repro_torch/kernels/csrc/packed_conv.cu",
                replaces="none (ReActNet is port-only)", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by="bytes + "
                "operations", bytes_ms=b_bytes, ops_ms=b_ops,
                library_ms=None)


# ------------------------------------------------------------------ #
# the main paths                                                       #
# ------------------------------------------------------------------ #
# conv1 packs its signs in entry_conv's epilogue: no pack launch
BINARYNET_PER_FORWARD = {"entry_conv": 1, "packed_conv2d": 5,
                         "fused_binary_mlp": 1, "popcount_gemm": 1}
# fc6+fc7 fused in one launch, fc8 the popcount head
ALEXNET_PER_FORWARD = {"pack": 1, "packed_conv2d": 3, "fused_binary_mlp": 1,
                       "popcount_gemm": 1}
SPLIT_AT = "binarize@conv3"       # AlexNet's first binary step


def to_cpu(tree):
    from repro_torch.kernels.packed import PackedArray
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    if isinstance(tree, PackedArray):
        return tree.to("cpu")
    return tree.cpu()


def binarynet_vs_cpu(spec, cb, params, x):
    """Integer images: BinaryNet's one float entry conv sums exactly in
    any order, so the card's logits equal the CPU's bit for bit.  The
    head split off at binarize@conv2 keeps conv1's alpha multiply: its
    float activations equal the CPU's and ``binary_weight_conv``'s, and
    the tail on them gives the logits."""
    from repro_torch import graph
    from repro_torch.core.bnn_layers import (binary_weight_conv,
                                             sign_weight_conv)
    # cuDNN's output follows the channels-last input, so the unscaled
    # NHWC view that the pack reads is contiguous: no copy before it
    if not sign_weight_conv(x, params["conv"][0]["w"],
                            padding=1).is_contiguous():
        raise AssertionError("conv1's NHWC output is not contiguous")
    cpu = graph.compile(spec, backend="torch", device="cpu"
                        ).apply(to_cpu(params), x.cpu())
    logits = cb.apply(params, x)
    if not torch.equal(logits.cpu(), cpu):
        raise AssertionError("card logits differ from the CPU's")
    head, tail = cb.split("binarize@conv2")
    cpu_head = graph.compile(spec, backend="torch", device="cpu"
                             ).split("binarize@conv2")[0]
    h = head.apply(params, x)
    p0 = params["conv"][0]
    if not (torch.equal(h.cpu(), cpu_head.apply(to_cpu(params), x.cpu()))
            and torch.equal(h, binary_weight_conv(x, p0["w"], padding=1,
                                                  alpha=p0["alpha"]))
            and torch.equal(tail.apply(params, h), logits)):
        raise AssertionError("BinaryNet split at binarize@conv2: the head's "
                             "scaled activations or the tail's logits "
                             "differ")
    return ("card logits equal to the CPU's; conv1's NHWC output "
            "contiguous; the split head's scaled activations equal the "
            "CPU's")


def alexnet_vs_cpu(spec, cb, params, x):
    """AlexNet's conv2 sums alpha-scaled floats, whose rounding depends
    on the order (cuDNN and the CPU differ): the float activations at
    binarize@conv3 must agree within 1e-5 * max|h| (TF32 off on the
    card), and the CPU's activations through the card's binary tail
    must give the CPU's logits exactly."""
    from repro_torch import graph
    cpu_head, cpu_tail = graph.compile(spec, backend="torch", device="cpu"
                                       ).split(SPLIT_AT)
    head, tail = cb.split(SPLIT_AT)
    pc = to_cpu(params)
    h_card = head.apply(params, x).cpu()
    h_cpu = cpu_head.apply(pc, x.cpu())
    err = float((h_card - h_cpu).abs().max())
    tol = 1e-5 * float(h_cpu.abs().max())
    if h_card.shape != h_cpu.shape or err > tol:
        raise AssertionError(f"AlexNet float layers: card vs CPU max abs "
                             f"err {err} > {tol}")
    flips = int(((h_card > 0) != (h_cpu > 0)).sum())
    if not torch.equal(tail.apply(params, h_cpu.to(x.device)).cpu(),
                       cpu_tail.apply(pc, h_cpu)):
        raise AssertionError("AlexNet binary tail: card logits differ "
                             "from the CPU's on the same activations")
    return (f"float layers within {err:.3g} of the CPU's (tol {tol:.3g}, "
            f"{flips} of {h_cpu.numel()} signs differ), binary tail on "
            f"the CPU's activations equal to the CPU's logits")


def mul_kernels(fn):
    """The elementwise multiply kernels (torch's MulFunctor) that one
    call of ``fn`` launches on the card, by torch.profiler."""
    from repro_torch.trace import device_kernels
    return sum(c for name, c in device_kernels(fn).items()
               if "MulFunctor" in name)


def forward_path(label, workload, per_forward, n_classes, vs_cpu,
                 cpu_batches, launches, multiplies):
    """Compile ``workload`` for the card at batches 1, 32 and 256 and run
    ``apply`` with random weights from a seeded generator; integer
    images in [-3, 3].  Checks the launch counts, the logits against the
    ``"torch"`` backend on the card (exact) and, at ``cpu_batches``,
    against the CPU with ``vs_cpu``, and that a forward launches exactly
    ``multiplies`` elementwise multiply kernels, as many as the plan's
    integer convs that keep their alpha; prints images/s, ms per forward
    and peak device memory."""
    from repro_torch import graph
    from repro_torch.kernels import _build
    spec = graph.from_workload(workload)
    out = {}
    for batch in BATCHES:
        cb = graph.compile(spec, device=DEVICE, batch=batch)
        if batch == 1:
            print(cb.describe())
            params = cb.init(torch.Generator().manual_seed(0))
        if cb.launch_count() != sum(per_forward.values()):
            raise AssertionError(f"{label}: plan has {cb.launch_count()} "
                                 f"launches")
        gen = torch.Generator().manual_seed(batch)
        h, w, c = spec.input_shape
        x = torch.randint(-3, 4, (batch, h, w, c), generator=gen
                          ).to(torch.float32).to(DEVICE)

        _build.reset_launch_counts()
        logits = cb.apply(params, x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        expect_launches(f"{label} batch {batch}", counts, per_forward)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

        if logits.shape != (batch, n_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: bad logits "
                                 f"{tuple(logits.shape)}")
        ref = graph.compile(spec, backend="torch", device=DEVICE
                            ).apply(params, x)
        if not torch.equal(logits, ref):
            raise AssertionError(f"{label} batch {batch}: cuda logits "
                                 f"differ from the torch backend's")
        note = vs_cpu(spec, cb, params, x) if batch in cpu_batches else ""
        # the float entry convs' alpha passes: BinaryNet's conv1 leaves its
        # alpha to the pack, AlexNet's conv1 and conv2 keep theirs; the
        # plan's integer convs that keep theirs must be that many too
        kept = sum(step.kind == "integer_conv" and
                   step.args["epilogue"] == "alpha" for step in cb.plan)
        if kept != multiplies:
            raise AssertionError(f"{label} batch {batch}: {kept} integer "
                                 f"convs keep their alpha multiply, "
                                 f"expected {multiplies}")
        muls, _ = profiled(f"{label} batch {batch}: elementwise multiply "
                           f"kernels per forward", lambda: mul_kernels(
                               lambda: cb.apply(params, x)), multiplies)

        iters = 20 if batch < 256 else 10
        cb.apply(params, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            cb.apply(params, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[batch] = dict(images_per_s=batch * iters / dt,
                          ms_per_forward=dt / iters * 1e3,
                          peak_mem_bytes=peak,
                          launches_per_forward=sum(counts.values()),
                          multiply_kernels=muls)
        print(f"{label} B={batch}: {batch * iters / dt:.1f} images/s, "
              f"{dt / iters * 1e3:.3f} ms/forward, peak device memory "
              f"{peak / 2**20:.1f} MiB, launches {counts}, {muls} "
              f"elementwise multiply kernels, logits equal to the torch "
              f"backend" + (f"; {note}" if note else ""))
    return out


# one ReActNet-A forward: the stem, then one fused residual_conv a
# half-step; the pool and the fc are torch's
REACTNET_PER_FORWARD = {"stem_conv": 1, "residual_conv": 26}
# one Bi-Real Net-18 forward: the pooled stem, a projection before each
# of the three half-steps that double the width, one fused residual_conv
# a half-step
BIREAL_PER_FORWARD = {"stem_conv": 1, "shortcut_conv": 3,
                      "residual_conv": 16}


def residual_table(spec):
    """A residual spec (ReActNet, Bi-Real Net) as its plain reference's
    layer table (a stem's max pool a row of its own)."""
    from repro_torch.graph import ir
    rows = []
    for nd in spec.nodes:
        if isinstance(nd, ir.RealConv):
            rows.append({"op": "real_conv", "k": nd.kh, "stride": nd.stride,
                         "pad": nd.pad, "out_hw": nd.conv_hw()[0]})
            if nd.pool:
                window, stride, pad = ir.STEM_POOL
                rows.append({"op": "maxpool", "window": window,
                             "stride": stride, "pad": pad})
        elif isinstance(nd, ir.ResidualBinaryConv):
            rows.append({"op": "conv", "kind": "binary", "name": nd.name,
                         "stride": nd.stride, "pad": nd.pad,
                         "shortcut": nd.shortcut})
        elif isinstance(nd, ir.GlobalAvgPool):
            rows.append({"op": "avgpool"})
        elif isinstance(nd, ir.RealDense):
            rows.append({"op": "real_dense"})
    return rows


def residual_path(label, spec, reference, per_forward, pixels, launches,
                  graphed=False, stem_key="stem_conv"):
    """Full-width ``spec`` through ``graph.compile(...).bind/apply`` at
    batches 1, 32 and 256, published-form weights from a seeded
    generator, ``pixels(batch, generator)`` in: each forward launches
    exactly ``per_forward`` (counts reset just before it), its logits
    equal the ``"torch"`` backend's on the card and lie within the plain
    ``reference``'s ``LOGIT_REL_TOL`` of its largest logit; with
    ``graphed``, at BATCH also through ``GraphedApply``: the capture
    records ``per_forward``, a replay launches it (counts reset just
    before it) and its logits equal eager ``apply``'s bit for bit.  The
    stem's launches add to ``launches`` under ``stem_key``.  Prints
    images/s, ms per forward and peak device memory."""
    from repro_torch import graph
    from repro_torch.graph.replay import GraphedApply
    from repro_torch.kernels import _build
    table = residual_table(spec)
    out = {}

    def counted(what, fn):
        _build.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        expect_launches(what, counts, per_forward)
        for k, v in counts.items():
            k = stem_key if k == "stem_conv" else k
            launches[k] = launches.get(k, 0) + v
        return got, counts

    for batch in BATCHES:
        cb = graph.compile(spec, device=DEVICE, batch=batch)
        if batch == 1:
            print(cb.describe())
            raw = cb.draw_residual(torch.Generator().manual_seed(0))
            params = cb.bind(raw)
            weights = list(raw["stem"]) + list(raw["res"]) + \
                list(raw["head"])
        if cb.launch_count() != sum(per_forward.values()):
            raise AssertionError(f"{label}: plan has "
                                 f"{cb.launch_count()} launches")
        x = pixels(batch, torch.Generator().manual_seed(batch)).to(DEVICE)
        logits, counts = counted(f"{label} batch {batch}",
                                 lambda: cb.apply(params, x))
        if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: bad logits "
                                 f"{tuple(logits.shape)}")
        plain = graph.compile(spec, backend="torch", device=DEVICE
                              ).apply(params, x)
        if not torch.equal(logits, plain):
            raise AssertionError(f"{label} batch {batch}: cuda logits "
                                 f"differ from the torch backend's")
        want = reference.logits(table, weights, x)
        gap = float(((logits - want).abs().amax(dim=1) /
                     want.abs().amax(dim=1)).max())
        if not gap <= reference.LOGIT_REL_TOL:
            raise AssertionError(f"{label} batch {batch}: a logit "
                                 f"{gap:.3g} of the image's largest off "
                                 f"the reference's")
        iters = 20 if batch < 256 else 10
        cb.apply(params, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            cb.apply(params, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[batch] = dict(images_per_s=batch * iters / dt,
                          ms_per_forward=dt / iters * 1e3,
                          peak_mem_bytes=peak, max_rel_gap=gap,
                          launches_per_forward=sum(counts.values()))
        print(f"{label} B={batch}: {batch * iters / dt:.1f} images/s, "
              f"{dt / iters * 1e3:.3f} ms/forward, peak device memory "
              f"{peak / 2**20:.1f} MiB, launches {counts}, logits equal to "
              f"the torch backend, {gap:.3g} of the largest logit off the "
              f"reference")
        if not (graphed and batch == BATCH):
            continue
        g = GraphedApply(cb, params, batch)
        if g.launches != per_forward:
            raise AssertionError(f"{label} B={batch}: the capture "
                                 f"recorded {g.launches}")
        got, counts = counted(f"{label} graphed B={batch}", lambda: g(x))
        if not torch.equal(got, logits):
            raise AssertionError(f"{label} B={batch}: replayed logits "
                                 f"differ from eager apply's")
        ms = wall_ms(lambda: g(x), 20)
        out[batch].update(graphed_ms=ms, graphed_images_per_s=batch / ms *
                          1e3)
        print(f"{label} graphed B={batch}: {ms:.4f} ms/forward "
              f"({batch / ms * 1e3:.1f} images/s) replayed, launches "
              f"{counts} per replay, replayed logits equal eager apply's")
    return out


def reactnet_path(launches):
    """ReActNet-A on unit-variance float pixels (``residual_path``)."""
    from repro_torch.graph.ir import reactnet_a
    from repro_torch.reference import reactnet

    def pixels(batch, gen):
        return torch.randn(batch, 224, 224, 3, generator=gen)
    return residual_path("ReActNet-A", reactnet_a(), reactnet,
                         REACTNET_PER_FORWARD, pixels, launches)


def bireal_path(launches):
    """Bi-Real Net-18 on 8-bit pixels, eager and replayed at BATCH
    (``residual_path``).  Its stem launches are the pooled kernel's: the
    kernels line counts them as ``stem_conv_pool``, apart from
    ReActNet-A's 3x3 stem."""
    from repro_torch.graph.ir import bireal_net18
    from repro_torch.reference import bireal

    def pixels(batch, gen):
        return torch.randint(0, 256, (batch, 224, 224, 3),
                             generator=gen).to(torch.float32)
    return residual_path("Bi-Real Net-18", bireal_net18(), bireal,
                         BIREAL_PER_FORWARD, pixels, launches, graphed=True,
                         stem_key="stem_conv_pool")


def dense_path(rnd, launches):
    """binary_dense, the public entry point, at the decode GEMMs in bf16
    and float32: one xnor_gemm launch per call, two where the plan
    splits K (the parts, then their sum), the output within the
    float tolerance of the "torch" backend's; prints ms per call through
    the entry point (host dispatch included, weights cold)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import binary_dense
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.kernels.xnor_gemm import tile_plan
    out = []
    for m, k, n in DENSE_SHAPES:
        wps = [PackedArray(rnd.words(k // 32, n), length=k, axis=-2)
               for _ in range(n_weight_copies(k, n))]
        for dt in DENSE_DTYPES:
            x, alpha = xnor_operands(rnd, m, k, n, dt, integer=False)
            _build.reset_launch_counts()
            y = binary_dense(x, wps[0], alpha)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            tag = f"binary_dense {m}x{k}x{n} {str(dt)[6:]}"
            plan = tile_plan(m, n, k // 32,
                             planes=3 if dt == torch.float32 else 1)
            expect_launches(tag, counts,
                            {"xnor_gemm": 1 if plan["splits"] == 1 else 2})
            for key, v in counts.items():
                launches[key] = launches.get(key, 0) + v
            err = float_err(tag, y, binary_dense(x, wps[0], alpha,
                                                 backend="torch"))
            ms = time_ms(rotating(lambda w: binary_dense(x, w, alpha), wps),
                         20)
            out.append(dict(m=m, k=k, n=n, dtype=str(dt), ms_per_call=ms,
                            max_abs_err=err))
            print(f"{tag}: {ms:.4f} ms/call through the entry point, "
                  f"max abs err {err:.3g} against the torch backend, "
                  f"launches {counts}")
    return out


# ------------------------------------------------------------------ #
# the graphed forward and the server                                   #
# ------------------------------------------------------------------ #
def images(spec, batch, seed):
    """Integer images in [-3, 3] for ``spec``, made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randint(-3, 4, (batch, *spec.input_shape), generator=gen,
                         device=DEVICE).to(torch.float32)


def wall_ms(fn, iters):
    """Host-clock ms per call of ``fn`` over ``iters`` calls ending in a
    synchronize, after a warm-up call (the latency a caller sees)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


PROFILER_PAD = 512     # one-element adds ahead of each profiled call


def port_kernels(fn):
    """The port's kernels one call of ``fn`` runs on the card, by the
    profiler (name -> launches).  A session can lose its first device
    records: on the H100, late in a long process, ten sessions in a row
    showed only the call's last three port kernels (a 50 ms wait before
    the call did not change that).  ``PROFILER_PAD`` one-element torch
    adds launched ahead of ``fn`` in each session take that loss; only
    the port's kernels are counted."""
    from repro_torch.trace import PORT_GROUPS, device_kernels
    pad = torch.zeros(1, device=DEVICE)

    def padded():
        for _ in range(PROFILER_PAD):
            pad.add_(1)
        return fn()

    seen = {}
    for name, count in device_kernels(padded).items():
        for frag, group in PORT_GROUPS:
            if frag in name:
                seen[group] = seen.get(group, 0) + count
                break
    return seen


PROFILER_VIEWS = 10    # views of one call, a growing pause between them


def profiled(what, view, want):
    """``view()``, a count of what one call ran on the card by the
    profiler (a number, or name -> launches), held to ``want``.  The
    profiler can drop the first records of a session, or all of them
    (seen on the H100: about one session in a hundred, in runs of up to
    three in a row; an eager forward's 8 port kernels shown as 4, a
    replay's as 3) but never shows a kernel that did not run, so a view
    with fewer is taken again, up to ``PROFILER_VIEWS`` times with a
    growing pause, and one with more fails at once.  Returns (the view,
    views taken)."""
    for n in range(1, PROFILER_VIEWS + 1):
        seen = view()
        if seen == want:
            return seen, n
        if isinstance(want, dict):
            if any(v > want.get(k, 0) for k, v in seen.items()):
                break
        elif seen > want:
            break
        time.sleep(0.05 * n)
    raise AssertionError(f"{what}: the profiler saw {seen or 'none'} in "
                         f"view {n}, the counts recorded {want}")


def replay_kernels(what, fn, want):
    """The port's kernels one call of ``fn`` ran on the card, by the
    profiler, held to ``want`` (the launches the counts recorded: for a
    replay, those its capture recorded) by ``profiled``.  Returns (what
    the profiler saw, views taken)."""
    return profiled(what, lambda: port_kernels(fn), want)


def graphed_path(launches):
    """Both models at batches 1, 32 and 256 through ``GraphedApply`` (one
    CUDA graph per forward, each in its own memory pool):
    the replayed logits must equal eager ``apply``'s bit for bit, a
    replay must run 8 and 6 of the port's kernels (the counts its
    capture recorded, and the profiler's count of the kernels a replay
    ran on the card); prints ms per forward and images/s both ways, the
    capture time and the memory the graph holds (``memory_reserved``
    around its capture, the previous graph freed and the allocator's
    cache emptied at both readings)."""
    from repro_torch import graph
    from repro_torch.core.workloads import (alexnet_imagenet,
                                            binarynet_cifar10)
    from repro_torch.graph.replay import GraphedApply
    from repro_torch.kernels import _build
    out = {}

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    for label, workload, per_forward in (
            ("BinaryNet", binarynet_cifar10(), BINARYNET_PER_FORWARD),
            ("AlexNet", alexnet_imagenet(), ALEXNET_PER_FORWARD)):
        spec = graph.from_workload(workload)
        params, g, rows = None, None, []
        for batch in BATCHES:
            cb = graph.compile(spec, device=DEVICE, batch=batch)
            if params is None:
                params = cb.init(torch.Generator().manual_seed(0))
            x = images(spec, batch, batch)
            eager = cb.apply(params, x)
            g = None
            r0 = reserved()
            g = GraphedApply(cb, params, batch)
            pool_bytes = reserved() - r0
            if g.launches != per_forward:
                raise AssertionError(f"{label} B={batch}: the capture "
                                     f"recorded {g.launches}")
            _build.reset_launch_counts()
            got = g(x)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            expect_launches(f"{label} graphed B={batch}", counts,
                            per_forward)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            if not torch.equal(got, eager):
                raise AssertionError(f"{label} B={batch}: replayed logits "
                                     f"differ from eager apply's")
            seen, profiles = replay_kernels(f"{label} B={batch} replay",
                                            lambda: g(x), g.launches)
            iters = 50 if batch < 256 else 20
            eager_ms = wall_ms(lambda: cb.apply(params, x), iters)
            graphed_ms = wall_ms(lambda: g(x), iters)
            rows.append(dict(batch=batch, eager_ms=eager_ms,
                             graphed_ms=graphed_ms,
                             eager_images_per_s=batch / eager_ms * 1e3,
                             graphed_images_per_s=batch / graphed_ms * 1e3,
                             capture_s=g.capture_s, pool_bytes=pool_bytes,
                             kernels_per_replay=sum(g.launches.values()),
                             profiler_kernels=seen, profiles=profiles))
            print(f"{label} graphed B={batch}: {graphed_ms:.4f} ms/forward "
                  f"({batch / graphed_ms * 1e3:.1f} images/s) replayed, "
                  f"{eager_ms:.4f} ms ({batch / eager_ms * 1e3:.1f} "
                  f"images/s) eager; capture {g.capture_s:.3f} s, pool "
                  f"{pool_bytes / 2**20:.1f} MiB, {counts} per replay "
                  f"(the profiler saw {seen}, profile {profiles}); "
                  f"replayed logits equal "
                  f"eager apply's")
        out[label] = rows
    return out


SERVED = (("BinaryNet", 256, 512), ("AlexNet", 32, 64))


def burst(srv, xs, clients=4):
    """Submit ``xs`` to a started server from ``clients`` threads at
    once; returns the results, the wall time and each request's latency
    (submit to resolution, ms), sorted."""
    import threading
    n_req = len(xs)
    futs, lat = [None] * n_req, [None] * n_req
    # a future wakes its waiters before it runs its callbacks: the
    # latencies are read only once every callback has run
    timed = threading.Semaphore(0)

    def done(f, i, t):
        lat[i] = (time.perf_counter() - t) * 1e3
        timed.release()

    def client(k):
        for i in range(k, n_req, clients):
            t = time.perf_counter()
            futs[i] = srv.submit(xs[i])
            futs[i].add_done_callback(lambda f, i=i, t=t: done(f, i, t))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for c in threads:
        c.start()
    for c in threads:
        c.join()
    out = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    for _ in range(n_req):
        if not timed.acquire(timeout=60):
            raise AssertionError("a latency callback never ran")
    return out, wall, sorted(lat)


def pcts(ms):
    """p50 and p99 of sorted milliseconds."""
    n = len(ms)
    return dict(p50=ms[n // 2], p99=ms[min(n - 1, int(0.99 * n))])


def serving_path(launches):
    """``BNNServer(max_batch, prewarm=True)`` over full-width BinaryNet
    (max_batch 256, 512 requests) and XNOR-AlexNet (32, 64): requests of
    rows drawn uniformly from 1..max_batch (seed 0) sent by 4 client
    threads, twice (the first burst after start-up, then the steady
    state), then 64 single-row requests one at a time.  Every result
    must equal eager ``apply`` on its own rows, graphs stay within
    ``trace_bound``, nothing falls back or retries, and the profiler
    must see one served flight run the kernels its graph's capture
    recorded (the counts every replay adds).  Then one forced
    ``BackendFault`` (``ChaosMonkey.fail_next``) must take the degraded
    step: the same kernels launched eagerly on the card (their counts
    move by one forward), the same logits, counted once.  Prints
    images/s, p50/p99 latency, the in-flight peak and how much memory
    the prewarmed server holds (``memory_reserved`` around its
    construction)."""
    import numpy as np

    from repro_torch import graph
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.kernels import _build
    from repro_torch.robustness import ChaosMonkey
    from repro_torch.serving import BackendFault, BNNServer, trace_bound
    from repro_torch.serving.bucketing import bucket_for, ragged_valid
    out = {}

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def level_launches(srv, n):
        """The launches the capture of ``n`` rows' level recorded."""
        bucket = bucket_for(n, srv.max_batch)
        return srv._graphs[(bucket, ragged_valid(n, bucket))].launches

    for label, max_batch, n_req in SERVED:
        spec = graph.from_workload(
            WORKLOADS["binarynet" if label == "BinaryNet" else "alexnet"])
        cb = graph.compile(spec, device=DEVICE, batch=max_batch)
        params = cb.init(torch.Generator().manual_seed(0))
        chaos = ChaosMonkey()
        srv = None                      # the previous model's graphs go
        r0 = reserved()
        t0 = time.perf_counter()
        # the whole burst is queued at once: no admission bound
        srv = BNNServer(cb, params, max_batch=max_batch, prewarm=True,
                        chaos=chaos, max_queue_rows=None, device=DEVICE)
        prewarm_s = time.perf_counter() - t0
        pool_bytes = reserved() - r0
        bound_n = trace_bound(max_batch, ragged=True)
        rows = np.random.default_rng(0).integers(1, max_batch + 1, n_req)
        data = images(spec, int(rows.sum()), 0)
        offs = np.concatenate([[0], np.cumsum(rows)])
        xs = [data[offs[i]:offs[i + 1]] for i in range(n_req)]
        torch.cuda.synchronize()
        srv.start()

        _build.reset_launch_counts()
        # the first burst after start-up pays the allocator's growth and
        # the threads' first CUDA calls; the second is the steady state
        bursts, got, seen = [], [], []
        for _ in range(2):
            out_b, wall, lat = burst(srv, xs)
            bursts.append(dict(wall_s=wall,
                               images_per_s=float(rows.sum()) / wall,
                               latency_ms=pcts(lat)))
            got += out_b
            seen += xs
        single_ms = []
        for i in range(64):
            x1 = data[i % data.shape[0]][None]
            t1 = time.perf_counter()
            got.append(srv.submit(x1).result(timeout=60))
            single_ms.append((time.perf_counter() - t1) * 1e3)
            seen.append(x1)
        counts = _build.launch_counts()
        st = srv.stats()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for x, y in zip(seen, got):
            if not torch.equal(y, cb.apply(params, x)):
                raise AssertionError(f"{label}: a served result "
                                     f"({x.shape[0]} rows) differs from "
                                     f"eager apply on its rows")
        faults = st["faults"]
        if st["jit_traces"] > bound_n or faults["backend_fallbacks"] or \
                faults["retries"] or faults["flights"]:
            raise AssertionError(f"{label} served: {st['jit_traces']} "
                                 f"graphs (bound {bound_n}), faults "
                                 f"{faults}")
        if counts.get("packed_conv2d", 0) == 0:
            raise AssertionError(f"{label} served: no kernel ran")
        # one served flight under the profiler: the kernels it ran on the
        # card are the ones its graph's capture recorded, which is what
        # each replay adds to the counts.  The flights are counted as they
        # are sent: device_kernels warms up with one, and a profiler
        # session that saw no device event is asked again (trace.TRIES)
        n1 = max_batch * 3 // 4
        x1 = data[:n1]
        want1 = level_launches(srv, n1)
        flights1 = [0]

        def flight():
            flights1[0] += 1
            return srv.submit(x1).result(timeout=60)

        _build.reset_launch_counts()
        seen1, profiles1 = replay_kernels(
            f"{label} served flight of {n1} rows", flight, want1)
        counted1 = {k: v for k, v in _build.launch_counts().items() if v}
        if counted1 != {k: flights1[0] * v for k, v in want1.items()}:
            raise AssertionError(f"{label} served flight of {n1} rows: "
                                 f"the counts rose by {counted1} in "
                                 f"{flights1[0]} flights, the capture "
                                 f"recorded {want1}")
        single = pcts(sorted(single_ms))
        res = dict(max_batch=max_batch, requests=n_req,
                   rows=int(rows.sum()), bursts=bursts,
                   single_row_ms=single,
                   inflight_peak=st["inflight_peak"],
                   graphs=st["jit_traces"], trace_bound=bound_n,
                   prewarm_s=prewarm_s, pool_bytes=pool_bytes,
                   profiled_flight=dict(rows=n1, profiler_kernels=seen1,
                                        profiles=profiles1,
                                        flights=flights1[0]),
                   batches=st["batches"], occupancy=st["occupancy"],
                   results_checked=len(seen), launches=counts)
        for name, bu in zip(("first", "steady"), bursts):
            print(f"{label} served (max_batch {max_batch}), {name} burst: "
                  f"{n_req} requests, {int(rows.sum())} images from 4 "
                  f"threads in {bu['wall_s']:.4f} s = "
                  f"{bu['images_per_s']:.1f} images/s; latency p50 "
                  f"{bu['latency_ms']['p50']:.3f} ms p99 "
                  f"{bu['latency_ms']['p99']:.3f} ms")
        print(f"{label} served: 64 single rows one at a time: p50 "
              f"{single['p50']:.3f} ms p99 {single['p99']:.3f} ms; "
              f"inflight_peak {st['inflight_peak']}; {st['batches']} "
              f"flights, occupancy {st['occupancy']:.3f}; "
              f"{st['jit_traces']} graphs (bound {bound_n}) captured in "
              f"{prewarm_s:.2f} s, pool {res['pool_bytes'] / 2**20:.1f} "
              f"MiB; all {len(seen)} results equal eager apply on their "
              f"own rows; launches {counts}; a profiled flight of {n1} "
              f"rows ran {seen1} (profile {profiles1}), as its capture "
              f"recorded")
        if label == "BinaryNet":
            x = data[:8]
            want8 = level_launches(srv, 8)
            chaos.fail_next(BackendFault("forced by chip_smoke"))
            _build.reset_launch_counts()
            y = srv.submit(x).result(timeout=120)
            rerun = {k: v for k, v in _build.launch_counts().items() if v}
            faults = srv.stats()["faults"]
            if not (y.device.type == torch.device(DEVICE).type
                    and torch.equal(y, cb.apply(params, x))
                    and faults["backend_fallbacks"] == 1
                    and faults["retries"] == 0
                    and srv._fallback is cb and rerun == want8):
                raise AssertionError(f"forced BackendFault: faults "
                                     f"{faults}, the degraded step "
                                     f"launched {rerun}")
            res["forced_fault"] = dict(faults, degraded_launches=rerun)
            print(f"{label} forced BackendFault: the degraded step reran "
                  f"the same kernels eagerly on {y.device} ({rerun}), "
                  f"logits equal to eager apply, faults {faults}")
        srv.stop()
        out[label] = res
    return out


def replayed_us(fn, reps=20, iters=20):
    """Device µs per call of ``fn`` inside a CUDA graph of ``reps``
    back-to-back calls, replayed ``iters`` times (CUDA events)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(g.replay, iters, 1) * 1e3 / reps


def fused_vs_chained(rnd):
    """The fused stack (one fused_binary_mlp launch) against the chained
    route (one popcount_gemm launch a layer), both replayed from CUDA
    graphs, at the six main shapes: the words must agree."""
    from repro_torch.kernels.fused_mlp import fused_binary_mlp
    from repro_torch.kernels.ops import binary_binary_dense
    from repro_torch.kernels.packed import PackedArray
    out = []
    for (name, k0, ns), batch in itertools.product(FUSED_MAIN, BATCHES):
        x, ws, ks, ts = fused_operands(rnd, batch, k0, ns,
                                       ["vector"] * len(ns))
        xp = PackedArray(x, length=k0, axis=-1)
        wps = [PackedArray(w, length=k, axis=-1) for w, k in zip(ws, ks)]

        def fused():
            return fused_binary_mlp(xp, wps, ts).words

        def chained():
            h = xp
            for w, t in zip(wps, ts):
                h = binary_binary_dense(h, w, threshold=t, pack_out=True)
            return h.words

        check_equal(f"{name} B={batch} fused vs chained", fused(),
                    chained())
        f_us, c_us = replayed_us(fused), replayed_us(chained)
        out.append(dict(name=name, batch=batch, fused_us=f_us,
                        chained_us=c_us))
        print(f"{name} B={batch} replayed: fused {f_us:.2f} us, chained "
              f"{c_us:.2f} us per stack")
    sums = {k: sum(r[k] for r in out) for k in ("fused_us", "chained_us")}
    print(f"fused vs chained, replayed, summed over the six shapes: {sums}")
    return dict(shapes=out, sums=sums)


# ------------------------------------------------------------------ #
# the training path                                                    #
# ------------------------------------------------------------------ #
# the reference's benchmark job (benchmarks/kernels_bench.py): BinaryNet
# at full width on the synthetic 10-class 32x32x3 stream, batch 8
TRAIN_DATA = dict(num_classes=10, height=32, width=32, channels=3,
                  global_batch=8, seed=0, flip_prob=0.02)
TRAIN_STEPS, TRAIN_LR, EVAL_BATCHES, MARGIN = 60, 0.02, 4, 0.15
CKPT_EVERY, RUN_STEPS = 20, 30           # the interrupted run's cut
SIGN_ROWS = 256                          # the exported forward's batch
TIMED_BATCH, TIMED_WARMUP, TIMED_STEPS = 256, 3, 20
# device kernel name -> group of the step's split: the first fragment a
# name holds decides (torch's own kernels are at::native::; cuDNN's FFT
# convs run complex cuBLAS GEMMs, "cf32", and complex pointwise kernels)
CUDNN_STEP = "cuDNN conv forward and backward"
CUBLAS_STEP = "cuBLAS fc matmuls"
TORCH_STEP = "elementwise, BN, STE, pools, loss"
STEP_GROUPS = (("Memcpy HtoD", "host-to-device copy"),
               ("at::native::", TORCH_STEP),
               *((f, CUDNN_STEP) for f in (
                   "conv", "fprop", "dgrad", "wgrad", "cudnn", "fft",
                   "winograd", "flip_filter", "nchwToNhwc", "nhwcToNchw",
                   "cf32", "_complex")),
               *((f, CUBLAS_STEP) for f in ("gemm", "gemv", "splitKreduce")))


def step_group(name):
    for frag, group in STEP_GROUPS:
        if frag in name:
            return group
    return "other: " + name[:60]


def leaves_equal(a, b):
    from repro_torch import tree
    fa, ta = tree.flatten(a)
    fb, tb = tree.flatten(b)
    return ta == tb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(fa, fb))


def train_path(launches):
    """Phase 9, the training path at BinaryNet's full width (random init
    from a seeded generator, the reference's synthetic stream):

    1. the reference's benchmark job — ``fit`` 60 steps at batch 8, lr
       0.02 — then ``evaluate`` on 4 held-out batches: accuracy above
       chance + 0.15; the same run with a checkpoint every 20 steps, cut
       at 30 and resumed: its losses and final (params, bn, opt) equal
       the uninterrupted run's bit for bit;
    2. ``export_compiled`` on the "cuda" backend and
       ``check_sign_identity`` on 256 held-out rows: logits exactly
       equal to the eval forward's, argmax agreement 1.0, the forward 1
       pack, 5 packed_conv2d, 1 fused_binary_mlp and 1 popcount_gemm
       launch; the same rows through ``BNNServer(max_batch=256)`` equal
       the eval logits;
    3. 20 steps at batch 256 after 3 warm-ups (host clock, the loss read
       each step as ``fit`` reads it; the batches made before): ms per
       step, images/s, peak memory; the device time of two steps split
       by torch.profiler into cuDNN convs, cuBLAS matmuls, torch's
       elementwise kernels and the host-to-device copy, the AdamW update
       profiled alone; the time to make a batch on the host and to save
       one checkpoint (``save``, and ``AsyncCheckpointer.save`` until it
       returns)."""
    import dataclasses
    import tempfile

    from repro_torch import graph, train, tree
    from repro_torch.checkpoint import AsyncCheckpointer, save
    from repro_torch.core.workloads import binarynet_cifar10
    from repro_torch.data import ImageDataConfig
    from repro_torch.data.images import eval_batch_at, image_batch_at
    from repro_torch.kernels import _build
    from repro_torch.optim import adamw
    from repro_torch.serving import BNNServer
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.trace import device_times
    t_phase = time.perf_counter()
    spec = graph.from_workload(binarynet_cifar10())
    dcfg = ImageDataConfig(**TRAIN_DATA)
    tcfg = train.TrainConfig(steps=TRAIN_STEPS, lr=TRAIN_LR)
    # the interrupted run first: it pays the one-time start-up (cuDNN's
    # handles and heuristics), so the uninterrupted run is timed warm
    rcfg = dataclasses.replace(tcfg, ckpt_every=CKPT_EVERY)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        part1 = train.fit(spec, dcfg, rcfg, ckpt_dir=d, run_steps=RUN_STEPS,
                          log_fn=lambda *_: None, device=DEVICE)
        part2 = train.fit(spec, dcfg, rcfg, ckpt_dir=d,
                          log_fn=lambda *_: None, device=DEVICE)
        resumed_s = time.perf_counter() - t0
    log = []
    t0 = time.perf_counter()
    full = train.fit(spec, dcfg, tcfg, log_fn=log.append, device=DEVICE)
    fit_s = time.perf_counter() - t0
    params, bn = full["params"], full["bn"]
    ev = train.evaluate(spec, params, bn, dcfg, n_batches=EVAL_BATCHES,
                        device=DEVICE)
    chance = 1.0 / dcfg.num_classes
    if not ev["acc"] > chance + MARGIN:
        raise AssertionError(f"BinaryNet trained: eval accuracy "
                             f"{ev['acc']} <= chance {chance} + {MARGIN}")
    print(f"BinaryNet trained {TRAIN_STEPS} steps x batch "
          f"{dcfg.global_batch} in {fit_s:.3f} s "
          f"({fit_s / TRAIN_STEPS * 1e3:.3f} ms/step, data included; the "
          f"interrupted run, start-up and checkpoints included, "
          f"{resumed_s:.3f} s): loss "
          f"{full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}, eval "
          f"accuracy {ev['acc']:.4f} on {ev['rows']} rows (chance "
          f"{chance:.2f}, margin {MARGIN})")
    for line in log:
        print(f"  {line}")

    resumed = part1["losses"] + part2["losses"]
    if not (part1["step"] == RUN_STEPS and part2["step"] == TRAIN_STEPS
            and resumed == full["losses"]
            and leaves_equal((part2["params"], part2["bn"], part2["opt"]),
                             (params, bn, full["opt"]))):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    print(f"resume: checkpoint every {CKPT_EVERY} steps, cut at "
          f"{RUN_STEPS} and resumed: {len(resumed)} losses and the final "
          f"(params, bn, opt) equal the uninterrupted run's bit for bit")

    scfg = dataclasses.replace(dcfg, global_batch=SIGN_ROWS)
    x = torch.from_numpy(eval_batch_at(scfg, EVAL_BATCHES + 1)["image"]
                         ).to(DEVICE)
    cb, sparams = train.export_compiled(spec, params, bn, batch=SIGN_ROWS,
                                        device=DEVICE)
    if cb.backend != "cuda":
        raise AssertionError(f"exported on {cb.backend}")
    _build.reset_launch_counts()
    stats = train.check_sign_identity(spec, params, bn, x, cb=cb,
                                      sparams=sparams)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    # the eval forward runs conv1 through the same entry_conv op as the
    # served one (train.models), so that its signs are the served ones
    sign_launches = {**BINARYNET_PER_FORWARD, "entry_conv": 2}
    expect_launches("the exported forward", counts, sign_launches)
    with torch.no_grad():
        eval_logits, _ = train.train_forward(spec, params, bn, x,
                                             train=False)
    srv = BNNServer(cb, sparams, max_batch=SIGN_ROWS, device=DEVICE)
    served = srv.apply_batch(x)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    srv = None                 # its graph's memory goes before the timing
    if not torch.equal(served, eval_logits):
        raise AssertionError("BNNServer's logits differ from the eval "
                             "forward's")
    print(f"export -> compile -> serve on the card: check_sign_identity "
          f"{stats} with {sign_launches} launches (the eval forward's "
          f"entry_conv included); "
          f"BNNServer(max_batch={SIGN_ROWS}).apply_batch equal to the "
          f"eval logits; launches with the server's {counts}")

    bcfg = dataclasses.replace(dcfg, global_batch=TIMED_BATCH)
    n = TIMED_WARMUP + TIMED_STEPS
    t0 = time.perf_counter()
    batches = [image_batch_at(bcfg, i) for i in range(n)]
    data_ms = (time.perf_counter() - t0) / n * 1e3
    state = list(train.init_train_state(torch.Generator().manual_seed(0),
                                        spec, device=DEVICE))
    state.append(adamw.init(state[0]))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, weight_decay=1e-4,
                                clip_norm=5.0, total_steps=n,
                                warmup_steps=max(1, n // 10))
    scale = train.default_logit_scale(spec)
    step = train.make_train_step(spec, opt_cfg, scale)

    def run(b):
        images = torch.from_numpy(b["image"]).to(DEVICE)
        labels = torch.from_numpy(b["label"]).to(DEVICE)
        new_params, new_bn, new_opt, m = step(*state, images, labels)
        state[:] = [new_params, new_bn, new_opt]
        return float(m["loss"])

    for b in batches[:TIMED_WARMUP]:
        run(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[TIMED_WARMUP:]:
        run(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()

    times = device_times(lambda: run(batches[-1]), iters=2)
    split = {}
    for name, us in times.items():
        g = step_group(name)
        split[g] = split.get(g, 0.0) + us
    _, _, _, grads = loss_and_grads(
        spec, state[0], state[1],
        torch.from_numpy(batches[-1]["image"]).to(DEVICE),
        torch.from_numpy(batches[-1]["label"]).to(DEVICE), scale)
    mask = train.clip_mask_for(state[0])
    with torch.no_grad():
        adam_us = sum(device_times(lambda: adamw.apply_updates(
            state[0], state[2], grads, opt_cfg, clip_mask=mask),
            iters=2).values())
    split["AdamW update"] = adam_us
    split[TORCH_STEP] = split.get(TORCH_STEP, 0.0) - adam_us
    device_us = sum(times.values())

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(d, 1, tuple(state), extra={"step": 1})
        save_s = time.perf_counter() - t0
        ck = AsyncCheckpointer(d)
        t0 = time.perf_counter()
        ck.save(2, tuple(state), extra={"step": 2})
        async_block_s = time.perf_counter() - t0
        ck.wait()
        async_total_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.leaves(tuple(state)))
    out = dict(fit_s=fit_s, resumed_fit_s=resumed_s, steps=TRAIN_STEPS,
               losses=full["losses"],
               eval=ev, resume_bit_identical=True, sign_identity=stats,
               served_equal=True, timed_batch=TIMED_BATCH,
               ms_per_step=step_ms,
               images_per_s=TIMED_BATCH / step_ms * 1e3,
               peak_mem_bytes=peak, data_ms_per_batch=data_ms,
               device_us_per_step=device_us,
               device_us_by_group=dict(sorted(split.items(),
                                              key=lambda kv: -kv[1])),
               step_kernels={k[:160]: v for k, v in sorted(
                   times.items(), key=lambda kv: -kv[1])},
               ckpt_bytes=nbytes, save_s=save_s,
               async_save_block_s=async_block_s,
               async_save_total_s=async_total_s)
    print(f"BinaryNet training at batch {TIMED_BATCH}: {step_ms:.3f} "
          f"ms/step ({TIMED_BATCH / step_ms * 1e3:.1f} images/s) over "
          f"{TIMED_STEPS} steps after {TIMED_WARMUP}, batches made before "
          f"({data_ms:.2f} ms a batch on the host); peak device memory "
          f"{peak / 2**20:.1f} MiB; device {device_us:.1f} us/step "
          f"(busy {device_us / 1e3 / step_ms:.3f})")
    for g, us in out["device_us_by_group"].items():
        print(f"  {us:10.1f} us/step  {g}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"checkpoint of {nbytes / 2**20:.1f} MiB (params, bn, opt): save "
          f"{save_s:.3f} s; AsyncCheckpointer.save returns after "
          f"{async_block_s:.3f} s, written after {async_total_s:.3f} s; "
          f"the training phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# the TULIP model and its simulator                                    #
# ------------------------------------------------------------------ #
SIM_SERVED = (("BinaryNet", "binarynet", 256, 10, BINARYNET_PER_FORWARD),
              ("AlexNet", "alexnet", 32, 1000, ALEXNET_PER_FORWARD))
SIM_PE_SAMPLES = 4
SIM_TREES = (9, 288, 1023)           # run_torch's programs, by fan-in
SIM_PES = 256                        # the paper's chip
DSE_REL_TOL = 1e-9
DSE_GATES = ("oracle_bit_identical", "mac_logits_bit_identical",
             "pe_programs_ok", "cycles_match_table3", "matches_closed_form",
             "run_torch_crosschecked")
# device kernel name -> group of a simulate's split: the oracle's port
# kernels by symbol, then cuDNN's convs (whose names can hold "gemm"),
# then cuBLAS's products, which are _exact_dot's
SIM_ORACLE = "the oracle's port kernels"
SIM_DOT = "_exact_dot products (cuBLAS, float32)"
SIM_REST = "the rest (entry convs, patches, pools, casts, copies)"
SIM_GROUPS = (*((f, SIM_ORACLE) for f in (
    "pack_kernel", "packed_conv_kernel", "fused_mlp_kernel",
    "popcount_gemm_kernel", "entry_convolve_bits_kernel")),
    *((f, SIM_REST) for f in ("convolve", "cudnn", "fft", "fprop",
                              "flip_filter", "nchwToNhwc", "nhwcToNchw")),
    *((f, SIM_DOT) for f in ("gemm", "gemv", "splitKreduce")))


def sim_group(name):
    for frag, group in SIM_GROUPS:
        if frag in name:
            return group
    return SIM_REST


def sim_device_split(fn):
    """Device ms of one call of ``fn`` by ``sim_group``, from
    torch.profiler (no warm-up: the call before it warmed up)."""
    from repro_torch.trace import _device_us, device_events
    split = {}
    for e in device_events(fn)[0]:
        g = sim_group(e.key)
        split[g] = split.get(g, 0.0) + _device_us(e) / 1e3
    return split


def dse_equal(what, got, want):
    """The port's DSE numbers against the committed artifact: floats
    within DSE_REL_TOL, everything else equal."""
    import math
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{what}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            dse_equal(f"{what}.{k}", got[k], want[k])
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} rows != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            dse_equal(f"{what}[{i}]", g, w)
    elif isinstance(want, float):
        if not math.isclose(got, want, rel_tol=DSE_REL_TOL):
            raise AssertionError(f"{what}: {got!r} != {want!r}")
    elif got != want:
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def pe_programs():
    """run_torch on the card against run_numpy, on 256 PEs with random
    product bits: the scheduled programs of 9, 288 and 1023 inputs,
    without and with the on-PE compare; regs, outs and every cycle's
    latched outputs identical; ms per program both ways."""
    import numpy as np

    from repro_torch.core.adder_tree import make_ext_inputs, schedule_tree
    from repro_torch.core.tulip_pe import read_value, run_numpy, run_torch
    rng = np.random.default_rng(0)
    out = []
    for n in SIM_TREES:
        for thr in (None, (n + 1) // 2):
            t0 = time.perf_counter()
            sched = schedule_tree(n, threshold=thr)
            sched_s = time.perf_counter() - t0
            bits = rng.integers(0, 2, (SIM_PES, n))
            ext = make_ext_inputs(sched.ext_layout, bits, sched.cycles)
            t0 = time.perf_counter()
            want = run_numpy(sched.program, ext, trace=True)
            numpy_ms = (time.perf_counter() - t0) * 1e3
            run_torch(sched.program, ext, device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run_torch(sched.program, ext, device=DEVICE)
            torch.cuda.synchronize()
            torch_ms = (time.perf_counter() - t0) * 1e3
            tag = f"run_torch, {n} inputs" + (f" >= {thr}" if thr else "")
            for name, g, w in zip(("regs", "outs", "hist"), got, want):
                if g.device.type != torch.device(DEVICE).type or \
                        not np.array_equal(g.cpu().numpy(), w):
                    raise AssertionError(f"{tag}: {name} differ from "
                                         f"run_numpy's")
            pc = read_value(want[0], sched.result_neuron, sched.result_bits)
            ok = np.array_equal(pc, bits.sum(1))
            if thr:
                ok &= np.array_equal(
                    want[2][:, sched.cmp_result_cycle, sched.cmp_neuron],
                    (bits.sum(1) >= thr).astype(np.int32))
            if not ok:
                raise AssertionError(f"{tag}: the program's popcount or "
                                     f"compare is wrong")
            out.append(dict(n=n, threshold=thr, cycles=sched.cycles,
                            pes=SIM_PES, torch_ms=torch_ms,
                            numpy_ms=numpy_ms, schedule_s=sched_s))
            print(f"{tag}: {sched.cycles} cycles on {SIM_PES} PEs, regs, "
                  f"outs and hist identical to run_numpy; {torch_ms:.1f} "
                  f"ms/program on the card, run_numpy {numpy_ms:.1f} ms; "
                  f"scheduled in {sched_s:.2f} s")
    return out


def dse_run(launches):
    """run_dse() in full on the card (both workloads at batch 2, two PE
    samples a layer, the 33 configurations): every gate held, the oracle
    launching each model's kernels once, and its model numbers equal to
    the committed benchmarks/BENCH_dse.json."""
    from repro_torch.kernels import _build
    from repro_torch.sim.dse import MIN_ENERGY_RATIO, run_dse
    bench = json.loads((ROOT / "benchmarks" / "BENCH_dse.json"
                        ).read_text())["dse"]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_dse(log=lambda line: print(f"  run_dse: {line}"),
                  device=DEVICE)
    torch.cuda.synchronize()
    dse_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    expect_launches("run_dse", counts, {
        k: BINARYNET_PER_FORWARD.get(k, 0) + ALEXNET_PER_FORWARD.get(k, 0)
        for k in counts})
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    dse = res["dse"]
    for wl, ref in zip(dse["workloads"], bench["workloads"]):
        for gate in DSE_GATES:
            if wl[gate] is not True:
                raise AssertionError(f"run_dse {wl['name']}: {gate} failed")
        if not wl["energy_ratio_vs_mac"] >= MIN_ENERGY_RATIO:
            raise AssertionError(f"run_dse {wl['name']}: energy ratio "
                                 f"{wl['energy_ratio_vs_mac']}")
        for key in ("name", "dataset", "batch", "pe_programs_checked",
                    "table3", "tulip", "mac_baseline",
                    "energy_ratio_vs_mac"):
            dse_equal(f"{wl['name']}.{key}", wl[key], ref[key])
    for key in ("calibration", "sweep", "pareto_fronts", "default_config",
                "comparison_points", "min_energy_ratio"):
        dse_equal(key, dse[key], bench[key])
    ratios = {wl["name"]: wl["energy_ratio_vs_mac"]
              for wl in dse["workloads"]}
    print(f"run_dse on the card: {dse_s:.1f} s; every gate held "
          f"({', '.join(DSE_GATES)}, energy ratio >= {MIN_ENERGY_RATIO}); "
          f"calibration, Table III, both designs' metrics, energy ratios "
          f"({', '.join(f'{k} {v:.3f}x' for k, v in ratios.items())}), "
          f"{len(dse['sweep'])} sweep rows and both Pareto fronts equal to "
          f"BENCH_dse.json (rel_tol {DSE_REL_TOL}); launches {counts}")
    return dict(seconds=dse_s, energy_ratios=ratios, env=res["env"],
                launches=counts)


def sim_path(launches):
    """Phase 10, the TULIP model and its simulator on the card:

    1. ``run_torch`` against ``run_numpy`` on 256 PEs (``pe_programs``);
    2. ``run_dse()`` in full (``dse_run``);
    3. ``simulate`` at a serving size — BinaryNet at batch 256, AlexNet
       at batch 32, integer images in [-3, 3], four PE samples a layer:
       logits equal to ``apply``'s on the card bit for bit (the oracle
       launches each model's kernels once), every gate held, the
       measured P/Z equal to ``table3_rows``; seconds per simulate, peak
       device memory, the host time of the sampler's draw over the
       largest layer, the seconds of a simulate without the sampler
       (``pe_samples=0``), and one more simulate's device time split by
       torch.profiler into the ``_exact_dot`` products, the oracle's
       port kernels and the rest."""
    import numpy as np

    from repro_torch import graph
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.kernels import _build
    from repro_torch.sim import simulate
    t_phase = time.perf_counter()
    out = {"pe_programs": pe_programs(), "dse": dse_run(launches)}
    for label, key, batch, classes, per_forward in SIM_SERVED:
        cb = graph.compile(WORKLOADS[key], device=DEVICE, batch=batch)
        params = cb.init(torch.Generator().manual_seed(0))
        x = images(cb.spec, batch, seed=batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        r = simulate(cb, params, x, pe_samples=SIM_PE_SAMPLES, seed=0)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_launches(f"{label} simulate", counts, per_forward)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if r.logits.device.type != torch.device(DEVICE).type or \
                r.logits.shape != (batch, classes) or \
                not torch.isfinite(r.logits).all():
            raise AssertionError(f"{label} simulate: bad logits")
        if not (r.oracle_bit_identical and r.counts_match_mapping
                and r.pe_programs_ok and r.run_torch_crosschecked
                and torch.equal(r.logits, cb.apply(params, x))):
            raise AssertionError(f"{label} simulate at batch {batch}: a "
                                 f"gate failed (oracle "
                                 f"{r.oracle_bit_identical}, counts "
                                 f"{r.counts_match_mapping}, PE programs "
                                 f"{r.pe_programs_ok})")
        pz = {d["layer"]: (d["P"], d["Z"]) for d in r.conv_pz()}
        if pz != {row["layer"]: (row["TULIP_P"], row["TULIP_Z"])
                  for row in cb.table3_rows()}:
            raise AssertionError(f"{label} simulate: P/Z differ from "
                                 f"table3_rows")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate(cb, params, x, pe_samples=0, seed=0)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        n_total = max(batch * nd.h_out * nd.w_out * nd.c_out
                      for nd in cb.spec.conv_nodes
                      if isinstance(nd, graph.BinaryConv))
        t0 = time.perf_counter()
        np.random.default_rng(0).choice(n_total, size=SIM_PE_SAMPLES,
                                        replace=False)
        draw_ms = (time.perf_counter() - t0) * 1e3

        split = sim_device_split(lambda: simulate(
            cb, params, x, pe_samples=SIM_PE_SAMPLES, seed=0))
        device_ms = sum(split.values())
        if not split.get(SIM_ORACLE) or not split.get(SIM_DOT):
            raise AssertionError(f"{label} simulate: the profiler shows no "
                                 f"device time of the oracle's kernels or "
                                 f"of the products ({split})")
        out[label] = dict(batch=batch, pe_samples=SIM_PE_SAMPLES,
                          seconds=sim_s, seconds_without_pe_samples=bare_s,
                          peak_mem_bytes=peak,
                          launches=counts, pe_nodes_checked=r.pe_nodes_checked,
                          draw_ms=draw_ms, draw_population=n_total,
                          device_ms=device_ms, device_ms_by_group=split)
        print(f"{label} simulate at batch {batch} ({SIM_PE_SAMPLES} PE "
              f"samples a layer, {r.pe_nodes_checked} nodes through real "
              f"programs): {sim_s:.2f} s, peak device memory "
              f"{peak / 2**20:.1f} MiB, logits equal to apply's on the "
              f"card, P/Z equal to table3_rows, launches {counts}; "
              f"{bare_s:.3f} s without the PE sampler (pe_samples=0); the "
              f"sampler's draw of {SIM_PE_SAMPLES} of {n_total} nodes "
              f"{draw_ms:.3f} ms; device {device_ms:.3f} ms a simulate "
              f"under the profiler:")
        for g, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:10.3f} ms  {g}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the simulator phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 11: the LLM serving path                                       #
# ------------------------------------------------------------------ #
LLM_ROWS = 512                      # rows of the binary-surface calls
# (label, d_model, d_ff): the FFN widths the binary surface runs at
LLM_FFN = (("qwen1.5-0.5b FFN", 1024, 2816),
           ("mixtral-8x22b FFN", 6144, 16384))
# float32 logits of two routes: |a - b| <= LLM_TOL * max|b| (the tests'
# tolerance, tests/test_torch_models.py)
LLM_TOL = 1e-4
TWIN_TOL = 1e-6                     # alpha = mean|w|, summed in another order
LLM_ARCH = "qwen1.5-0.5b"           # served at its published config
SERVE_SLOTS, SERVE_CAPACITY, SERVE_MAX_NEW = 4, 256, 16
SERVE_PROMPTS = (8, 17, 200)        # requests, shortest, longest prompt
# one architecture per other family at its published width, depth cut
FAMILY_CUTS = (("mixtral-8x22b", "MoE with SWA", dict(num_layers=2)),
               ("falcon-mamba-7b", "SSM", dict(num_layers=2)),
               ("recurrentgemma-2b", "hybrid", dict(num_layers=3)),
               ("whisper-large-v3", "enc-dec",
                dict(num_layers=2, encoder_layers=2)),
               ("llama-3.2-vision-11b", "VLM", dict(num_layers=5)))
FAMILY_PREFILL, FAMILY_DECODE = 16, 4


def llm_close(what, got, want):
    """float32 logits within LLM_TOL x max|want|; returns the ratio."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if err > LLM_TOL * scale:
        raise AssertionError(f"{what}: max err {err:.3g} > {LLM_TOL} x "
                             f"{scale:.3g}")
    return err / scale


def llm_kernels(rnd, launches):
    """11(a): the binary surface of ``models.layers`` at LLM widths,
    "cuda" against "torch" on the card, bit for bit: ``dense`` with a
    PackedArray x (popcount_gemm, int32 dot x alpha), ``packed_dense``
    (popcount_gemm with its pack epilogue) and the ``packed_mlp`` shim
    (a three-layer d -> d_ff -> d_ff -> d stack through
    ``compile_dense_stack``: fused_binary_mlp launches as its plan
    says); ms per call through the entry point and the bound."""
    from repro_torch.graph import compile_dense_stack
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.models import layers
    out = []
    m = LLM_ROWS
    for label, d, dff in LLM_FFN:
        xp = PackedArray.pack(rnd.normal(m, d))
        hp = PackedArray.pack(rnd.normal(m, dff))
        p_up = layers.pack_dense_params({"w": rnd.normal(d, dff)})
        p_dn = layers.pack_dense_params({"w": rnd.normal(dff, d)})
        t_up = rnd.ints(-40, 41, dff)
        stack = [layers.pack_dense_params({"w": rnd.normal(k, n)})
                 for k, n in ((d, dff), (dff, dff), (dff, d))]
        ts = [rnd.ints(-40, 41, dff), 0, rnd.ints(-40, 41, d)]
        plan = compile_dense_stack(d, [dff, dff, d], device=DEVICE,
                                   batch=m).plan
        want_stack = {"fused_binary_mlp": sum(s.kind == "fused_stack"
                                              for s in plan),
                      "popcount_gemm": sum(s.kind == "dense" for s in plan)}

        def plain_dense(p, x):
            s = kops.binary_binary_dense(x, p["wp"].move_pack_axis_last(),
                                         backend="torch")
            return s.to(p["alpha"].dtype) * p["alpha"]
        calls = (
            ("dense up", lambda: layers.dense(p_up, xp),
             lambda: plain_dense(p_up, xp), m, d, dff, False,
             {"popcount_gemm": 1}),
            ("dense down", lambda: layers.dense(p_dn, hp),
             lambda: plain_dense(p_dn, hp), m, dff, d, False,
             {"popcount_gemm": 1}),
            ("packed_dense up", lambda: layers.packed_dense(p_up, xp, t_up),
             lambda: layers.packed_dense(p_up, xp, t_up, backend="torch"),
             m, d, dff, True, {"popcount_gemm": 1}),
            ("packed_mlp 3 layers", lambda: layers.packed_mlp(stack, xp, ts),
             lambda: layers.packed_mlp(stack, xp, ts, backend="torch"),
             m, d, None, True, want_stack))
        for name, fn, plain, mm, k, n, words, per_call in calls:
            tag = f"{label} {name} ({mm} rows)"
            _build.reset_launch_counts()
            got = fn()
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            expect_launches(tag, counts, per_call)
            for key, v in counts.items():
                launches[key] = launches.get(key, 0) + v
            want = plain()
            if words:
                check_equal(tag, got.words, want.words)
                if got.length != want.length:
                    raise AssertionError(f"{tag}: length {got.length} vs "
                                         f"{want.length}")
            elif not torch.equal(got, want):
                raise AssertionError(f"{tag}: differs from the torch "
                                     f"backend")
            ms = time_ms(fn, 20)
            if n is None:        # the stack: three layers' words and ops
                dims = ((d, dff), (dff, dff), (dff, d))
                nbytes = sum(4 * (kk // 32) * nn for kk, nn in dims) \
                    + 4 * mm * (d // 32 + d // 32)
                ops = sum(2 * mm * kk * nn for kk, nn in dims)
            else:
                nbytes = 4 * (mm * k // 32 + n * k // 32) + (
                    4 * mm * (n // 32) if words else 4 * mm * n)
                ops = 2 * mm * k * n
            b_ms, b_by = bound(nbytes, ops, B1_OPS)
            out.append(dict(shape=label, call=name, rows=mm, ms=ms,
                            bound_ms=b_ms, bound_by=b_by, launches=counts))
            print(f"{tag}: equal to the torch backend bit for bit; "
                  f"{ms:.4f} ms/call through the entry point, bound "
                  f"{b_ms:.5f} ms ({b_by}); launches {counts}")
    return out


def llm_inputs(cfg, batch, seq, seed):
    """Tokens (+ Whisper frames / image embeddings) from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)))}
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype("float32"))
    elif cfg.frontend == "vision_patches":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype("float32"))
    return out


def llm_decode_run(params, cfg, inp, s0, steps):
    """forward over s0 + steps tokens, then prefill on s0 and ``steps``
    decode steps; every logit the decode gives must agree with the
    forward's at its position.  Returns (forward logits, prefill logits,
    the worst ratio)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_apply
    dev = params["embed"].device
    batch = {k: v.to(dev) for k, v in inp.items()}
    toks = batch["tokens"]
    ctx = M._ctx_from_inputs(params, cfg, batch)
    x, _, _ = M.forward(params, cfg, toks, ctx=ctx)
    fwd = logits_apply(params.get("lm_head", params["embed"]), x, True)
    pre = dict(batch, tokens=toks[:, :s0])
    logits0, caches = M.prefill(params, cfg, pre,
                                cache_capacity=s0 + steps)
    worst = llm_close(f"{cfg.name} prefill vs forward", logits0,
                      fwd[:, s0 - 1:s0])
    for t in range(steps):
        pos = s0 + t
        dec, caches = M.decode_step(params, cfg, {
            "tokens": toks[:, pos:pos + 1],
            "step": torch.full((toks.shape[0],), pos, dtype=torch.int32,
                               device=dev),
            "caches": caches})
        worst = max(worst, llm_close(f"{cfg.name} decode step {t}", dec,
                                     fwd[:, pos:pos + 1]))
    return fwd, logits0, worst


def llm_reduced_archs(launches):
    """11(b): all ten reduced architectures in float32 (TF32 off): the
    card's forward and prefill logits against the port's on the CPU,
    and on the card prefill + one decode step against the forward."""
    from repro_torch import tree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    out = {}
    for name in ARCHS:
        cfg = reduced(ARCHS[name]).replace(dtype="float32")
        cpu = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        card = tree.map(lambda t: t.to(DEVICE), cpu)
        inp = llm_inputs(cfg, 2, 13, seed=1)
        _build.reset_launch_counts()
        fwd, pre, dec_ratio = llm_decode_run(card, cfg, inp, 12, 1)
        torch.cuda.synchronize()
        expect_launches(f"{name} reduced", _build.launch_counts(), {})
        fwd_cpu, pre_cpu, _ = llm_decode_run(cpu, cfg, inp, 12, 1)
        r_fwd = llm_close(f"{name} forward card vs CPU", fwd, fwd_cpu)
        r_pre = llm_close(f"{name} prefill card vs CPU", pre, pre_cpu)
        out[name] = dict(forward_vs_cpu=r_fwd, prefill_vs_cpu=r_pre,
                         decode_vs_forward=dec_ratio)
        print(f"{name} reduced, float32: card vs CPU forward "
              f"{r_fwd:.2e}, prefill {r_pre:.2e}; prefill + decode vs "
              f"forward {dec_ratio:.2e} (x max|logit|, limit {LLM_TOL})")
    return out


def serve_timed(eng, reqs):
    """Run the Engine with every prefill and decode call timed (host
    clock, synchronised); returns (wall s, prefill ms by bucket, decode
    ms per step)."""
    pre_ms, dec_ms = {}, []
    get_prefill, decode = eng._get_prefill, eng._decode

    def timed_prefill(n):
        fn = get_prefill(n)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            pre_ms.setdefault(n, []).append(
                (time.perf_counter() - t0) * 1e3)
            return r
        return run

    def timed_decode(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = decode(*a)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        return r
    eng._get_prefill, eng._decode = timed_prefill, timed_decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs, log=lambda *_: None)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, pre_ms, dec_ms


def step_split(fn):
    """Device ms and kernels of one call of ``fn`` (torch.profiler over
    three calls after a warm-up, ``repro_torch.trace``)."""
    from repro_torch.trace import device_kernels, device_times
    times = device_times(fn, iters=3)
    out = {"device_ms": sum(times.values()) / 1e3,
           "kernels": sum(device_kernels(fn).values())}
    if DEVICE == "cuda" and not (out["kernels"] and out["device_ms"]):
        raise AssertionError(f"the profiler shows no device time: {out}")
    return out


def serve_requests(cfg, max_new=None):
    """SERVE_PROMPTS[0] prompts of numpy-seeded tokens, the shortest and
    the longest length among them."""
    import numpy as np

    from repro_torch.launch.serve import Request
    n, lo, hi = SERVE_PROMPTS
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n)
    lens[0], lens[1] = lo, hi
    return [Request(i, rng.integers(0, cfg.vocab_size, int(s)
                                    ).astype(np.int32),
                    max_new or SERVE_MAX_NEW)
            for i, s in enumerate(lens)]


def llm_serve(launches):
    """11(c): qwen1.5-0.5b at its published config (24 layers, d_model
    1024, vocab 151936, tied embeddings), random bf16 params from a
    seeded generator on the card, served by ``Engine`` — 8 requests of
    17-200 tokens on 4 slots, max_new 16, capacity 256 — dense and
    packed (after a short warm-up run each): tokens/s, ms per prefill
    bucket, ms per decode step, prefill_traces, param bytes and peak
    memory; the Engine launches none of the port's kernels (its float x
    packed-weight products are unpack -> matmul, as the reference's).
    Then in float32, the dense side on the packed layout's dense twin
    (``packed_twin``; the exact-zero weights, where the two layouts
    differ by the reference's own rules, are counted): packed and dense
    prefill logits within LLM_TOL, and the greedy tokens equal except
    where the dense run's top two logits lie within LLM_TOL
    (teacher-forced through ``forward``): such steps are counted and
    printed."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.quantize import pack_model_params
    cfg = get_arch(LLM_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = M.init_params(gen, cfg, DEVICE)
    out = {"arch": LLM_ARCH, "num_layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size}
    for packed in (False, True):
        tag = "packed" if packed else "dense"
        warm = Engine(cfg, params, SERVE_SLOTS, SERVE_CAPACITY,
                      packed=packed, device=DEVICE)
        warm.run([Request(0, serve_requests(cfg)[0].prompt, 2)],
                 log=lambda *_: None)
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = Engine(cfg, params, SERVE_SLOTS, SERVE_CAPACITY,
                     packed=packed, device=DEVICE)
        reqs = serve_requests(cfg)
        _build.reset_launch_counts()
        wall, pre_ms, dec_ms = serve_timed(eng, reqs)
        expect_launches(f"{LLM_ARCH} Engine {tag}", _build.launch_counts(),
                        {})
        peak = torch.cuda.max_memory_allocated()
        tokens = sum(len(r.out) for r in reqs)
        if any(len(r.out) != SERVE_MAX_NEW for r in reqs):
            raise AssertionError(f"{tag}: a request came back short")
        buckets = {n: sum(v) / len(v) for n, v in sorted(pre_ms.items())}
        if eng.prefill_traces != len(buckets):
            raise AssertionError(f"{tag}: {eng.prefill_traces} prefills "
                                 f"built for {len(buckets)} buckets")
        dec_sorted = sorted(dec_ms)
        step_batch = {"tokens": torch.zeros((SERVE_SLOTS, 1), dtype=torch.long,
                                            device=DEVICE),
                      "step": torch.from_numpy(eng.steps.copy()).to(DEVICE),
                      "caches": eng.caches}
        split = step_split(lambda: M.decode_step(eng.params, cfg,
                                                 step_batch))
        out[tag] = dict(
            tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            prefill_ms_by_bucket=buckets, prefill_traces=eng.prefill_traces,
            decode_steps=len(dec_ms), decode_ms_mean=sum(dec_ms) / len(dec_ms),
            decode_ms_median=dec_sorted[len(dec_sorted) // 2],
            param_bytes=eng.param_bytes, peak_mem_bytes=peak,
            peak_above_base_bytes=peak - base, base_bytes=base,
            decode_device_ms=split["device_ms"],
            decode_kernels=split["kernels"],
            out=[r.out for r in reqs])
        print(f"{LLM_ARCH} Engine {tag} (bf16, {SERVE_SLOTS} slots, "
              f"capacity {SERVE_CAPACITY}): {tokens} tokens in "
              f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; prefill ms "
              f"by bucket {({k: round(v, 3) for k, v in buckets.items()})}"
              f" ({eng.prefill_traces} buckets built); decode "
              f"{out[tag]['decode_ms_mean']:.3f} ms/step mean, "
              f"{out[tag]['decode_ms_median']:.3f} median over "
              f"{len(dec_ms)} steps ({split['device_ms']:.3f} ms of device "
              f"and {split['kernels']} kernels a step under the profiler: "
              f"busy {split['device_ms'] / out[tag]['decode_ms_median']:.3f}"
              f"); params {eng.param_bytes / 2**20:.1f} "
              f"MiB; peak device memory {peak / 2**20:.1f} MiB, "
              f"{(peak - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB held before (the dense bf16 params)")
        del eng
    params = tree.map(lambda t: t.to(torch.float32), params)
    cfg = cfg.replace(dtype="float32")
    packed = pack_model_params(params)
    twin, zeros = packed_twin(params, packed)
    reqs = {}
    worst = 0.0
    for tag, p in (("dense", twin), ("packed", packed)):
        reqs[tag] = serve_requests(cfg)
        Engine(cfg, p, SERVE_SLOTS, SERVE_CAPACITY, device=DEVICE).run(
            reqs[tag], log=lambda *_: None)
    emb = twin["embed"]
    raw = 0.0
    for r in reqs["dense"]:
        toks = torch.from_numpy(r.prompt).long().to(DEVICE)[None]
        lg_d, _ = M.prefill(twin, cfg, {"tokens": toks}, SERVE_CAPACITY)
        lg_p, _ = M.prefill(packed, cfg, {"tokens": toks}, SERVE_CAPACITY)
        lg_l, _ = M.prefill(params, cfg, {"tokens": toks}, SERVE_CAPACITY)
        worst = max(worst, llm_close(f"float32 prefill {r.rid} packed vs "
                                     f"dense", lg_p, lg_d))
        raw = max(raw, raw_vs_packed(f"float32 prefill {r.rid}", lg_p,
                                     lg_l, zeros, cfg))
    ties = []
    for rd, rp in zip(reqs["dense"], reqs["packed"]):
        j = next((i for i, (a, b) in enumerate(zip(rd.out, rp.out))
                  if a != b), None)
        if j is None:
            continue
        seq = torch.from_numpy(rd.prompt).long().tolist() + rd.out[:j]
        x, _, _ = M.forward(twin, cfg, torch.tensor([seq], device=DEVICE))
        lg = logits_apply(emb, x[:, -1], True)[0]
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        if gap > LLM_TOL * float(lg.abs().max()):
            raise AssertionError(f"float32 request {rd.rid}: packed and "
                                 f"dense tokens differ at step {j} where "
                                 f"the dense top-two gap is {gap:.3g}")
        ties.append(dict(rid=rd.rid, step=j, gap=gap))
    out["float32"] = dict(prefill_packed_vs_dense=worst, near_ties=ties,
                          requests_equal=len(reqs["dense"]) - len(ties),
                          zero_weights=zeros, prefill_packed_vs_latent=raw)
    print(f"{LLM_ARCH} float32 ({zeros} latent weights exactly 0, served "
          f"densely through the packed twin; packed vs the latent dense "
          f"prefill {raw:.2e}): packed vs dense prefill logits "
          f"{worst:.2e} x max|logit| (limit {LLM_TOL}); greedy tokens "
          f"equal in {len(reqs['dense']) - len(ties)} of "
          f"{len(reqs['dense'])} requests; {len(ties)} steps where the "
          f"tokens part at a near-tie of the dense top two {ties}")
    return out


def packed_twin(dense, packed):
    """The dense weights a packed tree encodes, and the count of exact
    zeros among the packed latent weights.

    Every packed projection becomes alpha * (+1 where w > 0, else -1)
    in the latent layout: the dense path then computes what the packed
    one does (mode "weights" recovers the same sign and alpha; mode
    "none", recurrentgemma's ``gate_proj``, multiplies by it directly).
    The two layouts differ in the reference too where a weight is
    exactly 0 (``ste_sign(0)`` is +1, the pack bit of 0 is -1) and
    where a packed key runs in mode "none": the count says how many
    zeros there were.  Each twin is held against the latent weights
    themselves (``check_twin``), so a wrong pack cannot pass as its own
    comparand."""
    if isinstance(dense, dict):
        out, zeros = {}, 0
        for k, v in dense.items():
            if k + "_p" in packed:
                alpha = packed[k + "_alpha"]
                w = packed[k + "_p"].unpack(alpha.dtype)
                out[k] = w * (alpha if alpha.ndim == w.ndim
                              else alpha.unsqueeze(-2))
                check_twin(k, v, out[k])
                zeros += int((v == 0).sum())
            else:
                out[k], z = packed_twin(v, packed[k])
                zeros += z
        return out, zeros
    if isinstance(dense, tuple):
        pairs = [packed_twin(a, b) for a, b in zip(dense, packed)]
        return tuple(t for t, _ in pairs), sum(z for _, z in pairs)
    return dense, 0


def check_twin(key, latent, twin):
    """The twin of packed key ``key`` against what the pack must encode,
    computed from the latent weights alone: mean|w| over the input axis
    (-2) times (+1 where w > 0, else -1), within TWIN_TOL of alpha at
    every weight.  Wrong bits, a wrong alpha axis or a wrong cycle slice
    fail here.  One [K, N] matrix at a time, to keep the card's memory
    for the model."""
    if twin.shape != latent.shape:
        raise AssertionError(f"twin of {key}: shape {tuple(twin.shape)} "
                             f"vs latent {tuple(latent.shape)}")
    lat = latent.reshape(-1, *latent.shape[-2:])
    tw = twin.reshape(-1, *twin.shape[-2:])
    for i in range(lat.shape[0]):
        w = lat[i].to(torch.float32)
        alpha = w.abs().mean(dim=-2, keepdim=True)
        want = torch.where(w > 0, alpha, -alpha)
        err = (tw[i].to(torch.float32) - want).abs()
        if bool((err > TWIN_TOL * alpha).any()):
            raise AssertionError(
                f"twin of {key}[{i}] disagrees with sign(w) x mean|w| of "
                f"the latent weights: max err {float(err.max()):.3g}")


def raw_vs_packed(what, packed_logits, dense_logits, zeros, cfg):
    """Packed against the latent dense logits: within LLM_TOL when no
    latent weight is exactly 0 and no packed projection runs in mode
    "none" (recurrentgemma's ``gate_proj``): then the twin is the latent
    weights' own sign and alpha.  Otherwise the ratio is only
    reported."""
    if zeros == 0 and "rglru" not in cfg.pattern_for_layers():
        return llm_close(f"{what} packed vs latent dense", packed_logits,
                         dense_logits)
    err = (packed_logits.float() - dense_logits.float()).abs().max()
    return float(err / dense_logits.float().abs().max())


def llm_families(launches):
    """11(d): one architecture per other family at its published width,
    the depth cut (FAMILY_CUTS), float32: prefill on 16 tokens + 4
    decode steps against the forward, then the packed forward against
    its dense twin (``packed_twin``: the zero weights counted); each
    model freed before the next."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.quantize import pack_model_params
    out = {}
    for name, family, cut in FAMILY_CUTS:
        full = get_arch(name)
        cfg = full.replace(dtype="float32", **cut)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(
            torch.Generator(device=DEVICE).manual_seed(0), cfg, DEVICE)
        inp = llm_inputs(cfg, 2, FAMILY_PREFILL + FAMILY_DECODE, seed=3)
        _build.reset_launch_counts()
        raw, _, dec_ratio = llm_decode_run(params, cfg, inp, FAMILY_PREFILL,
                                           FAMILY_DECODE)
        expect_launches(f"{name} cut", _build.launch_counts(), {})
        packed = pack_model_params(params)
        twin, zeros = packed_twin(params, packed)
        del params
        batch = {k: v.to(DEVICE) for k, v in inp.items()}
        logits = {}
        for tag, p in (("twin", twin), ("packed", packed)):
            x, _, _ = M.forward(p, cfg, batch["tokens"],
                                ctx=M._ctx_from_inputs(p, cfg, batch))
            logits[tag] = logits_apply(p.get("lm_head", p["embed"]), x,
                                       True)
            del x
        del twin
        got, fwd = logits["packed"], logits["twin"]
        pk_ratio = llm_close(f"{name} packed vs dense", got, fwd)
        raw_ratio = raw_vs_packed(f"{name}", got, raw, zeros, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        secs = time.perf_counter() - t0
        del packed, got, fwd, logits, raw
        torch.cuda.empty_cache()
        depth = {k: (v, getattr(full, k)) for k, v in cut.items()}
        out[name] = dict(family=family, depth_cut=depth,
                         decode_vs_forward=dec_ratio,
                         packed_vs_dense=pk_ratio, zero_weights=zeros,
                         packed_vs_latent_dense=raw_ratio,
                         peak_mem_bytes=peak, seconds=secs)
        print(f"{name} ({family}) at full width, float32, depth cut "
              + ", ".join(f"{k} {v} of {p}" for k, (v, p) in depth.items())
              + f": prefill + {FAMILY_DECODE} decode steps vs forward "
              f"{dec_ratio:.2e}, packed vs its dense twin {pk_ratio:.2e} "
              f"x max|logit| (limit {LLM_TOL}; {zeros} latent weights "
              f"exactly 0; against the latent dense forward "
              f"{raw_ratio:.2e}); peak device memory "
              f"{peak / 2**30:.2f} GiB; {secs:.1f} s")
    return out


def llm_path(rnd, launches):
    """Phase 11, the LLM serving path on the card: (a) the binary
    surface at LLM widths (``llm_kernels``), (b) the ten reduced
    architectures against the CPU (``llm_reduced_archs``), (c)
    qwen1.5-0.5b served at its published config (``llm_serve``), (d)
    one model per other family at full width (``llm_families``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {"kernels": llm_kernels(rnd, launches),
           "reduced": llm_reduced_archs(launches),
           "serve": llm_serve(launches),
           "families": llm_families(launches)}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the LLM phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 12: the LLM training path                                      #
# ------------------------------------------------------------------ #
LT_B, LT_S = 2, 16                  # 12a's batch
LT_LOSS_TOL = 1e-5                  # float32 loss, card vs CPU, relative
LT_GRAD_TOL = 1e-4                  # float32 grads: x max|g| of each leaf
# 12b / 12c: qwen1.5-0.5b at its published config, the logits chunk that
# the reference's dryrun.build_cell sets for a vocab >= 65536
FULL_BATCH, FULL_SEQ, FULL_CHUNK = 8, 512, 8192
FULL_STEPS, FULL_CUT, FULL_TIMED = 4, 2, 5
# 12d: examples/torch_train_bnn_lm.py's run (the reference example's
# default step count)
EXAMPLE_STEPS = 200
# device kernel name -> group of a training step's split (the first
# fragment a name holds decides)
LT_GROUPS = (("gemm", "cuBLAS matmuls"), ("xmma", "cuBLAS matmuls"),
             ("cutlass", "cuBLAS matmuls"),
             ("direct_copy", "casts and copies"),
             ("Memcpy", "casts and copies"),
             ("FillFunctor", "fills"), ("Memset", "fills"),
             ("reduce", "reductions (norms, softmax, loss, grad norm)"),
             ("index", "index, gather, scatter, sort"),
             ("gather", "index, gather, scatter, sort"),
             ("scatter", "index, gather, scatter, sort"),
             ("sort", "index, gather, scatter, sort"),
             ("CatArray", "cat, stack"),
             ("elementwise", "other elementwise (add, mul, where, exp, "
              "casts fused in)"))


def lt_group(name):
    for frag, group in LT_GROUPS:
        if frag in name:
            return group
    return "other"


def sync():
    torch.cuda.synchronize()


def lt_batch(cfg, batch, seq, seed):
    """A numpy-seeded token batch (+ Whisper frames / image embeddings)
    as int64 tokens and targets on the host."""
    inp = llm_inputs(cfg, batch, seq + 1, seed)
    toks = inp.pop("tokens").long()
    return dict(inp, tokens=toks[:, :-1], targets=toks[:, 1:])


def on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def grads_ratio(what, got, want, tol):
    """The worst leaf's max|got - want| / max|want|, held to ``tol``."""
    from repro_torch import tree
    worst = 0.0
    for i, (a, b) in enumerate(zip(tree.leaves(got), tree.leaves(want))):
        a, b = a.float().cpu(), b.float().cpu()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what} leaf {i}: shape {tuple(a.shape)} "
                                 f"vs {tuple(b.shape)} or non-finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if err > tol * scale:
            raise AssertionError(f"{what} leaf {i}: max err {err:.3g} > "
                                 f"{tol} x {scale:.3g}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def host_leaves(tree_):
    """Every leaf of a tree whole and on the host (a DTensor gathered)."""
    from repro_torch import tree
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().cpu() for t in tree.leaves(tree_)]


def bits_equal(a, b):
    """Two trees equal bit for bit (bf16 compared as its int16 bits)."""
    from repro_torch import tree

    def b16(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    fa, ta = tree.flatten(a)
    fb, tb = tree.flatten(b)
    return ta == tb and all(x.dtype == y.dtype and torch.equal(b16(x), b16(y))
                            for x, y in zip(fa, fb))


def llm_train_reduced():
    """12a: all ten reduced architectures in float32 (TF32 off), the
    same params (a CPU generator) on the card and on the CPU: one
    ``make_train_step``'s loss within LT_LOSS_TOL, ``loss_and_grads``'s
    every grad leaf within LT_GRAD_TOL x max|g|; on the card remat
    "full" and "dots" against "none" (bit for bit, or the largest
    difference printed and held to LT_GRAD_TOL).  The params after the
    step are printed, not held: a first AdamW step is about lr x
    sign(g), which a rounding-sized difference flips where g is near
    0."""
    from repro_torch import tree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import _build
    from repro_torch.launch.train import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    out = {}
    for name in ARCHS:
        cfg = reduced(ARCHS[name]).replace(dtype="float32")
        cpu = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        card = tree.map(lambda t: t.to(DEVICE), cpu)
        batch = lt_batch(cfg, LT_B, LT_S, seed=2)
        step = make_train_step(cfg, opt_cfg)
        _build.reset_launch_counts()
        p_g, _, m_g = step(card, adamw.init(card), on(batch, DEVICE))
        _, g_g = loss_and_grads(card, cfg, on(batch, DEVICE))
        remat = {}
        for r in ("full", "dots"):
            _, g_r = loss_and_grads(card, cfg.replace(remat=r),
                                    on(batch, DEVICE))
            remat[r] = 0.0 if bits_equal(g_r, g_g) else grads_ratio(
                f"{name} remat {r} vs none", g_r, g_g, LT_GRAD_TOL)
        sync()
        expect_launches(f"{name} train step", _build.launch_counts(), {})
        p_c, _, m_c = step(cpu, adamw.init(cpu), batch)
        _, g_c = loss_and_grads(cpu, cfg, batch)
        lg, lc = float(m_g["loss"]), float(m_c["loss"])
        r_loss = abs(lg - lc) / abs(lc)
        if r_loss > LT_LOSS_TOL or lg != lg:
            raise AssertionError(f"{name}: loss on the card {lg} vs CPU "
                                 f"{lc}")
        r_grad = grads_ratio(f"{name} grads card vs CPU", g_g, g_c,
                             LT_GRAD_TOL)
        r_step = max(float((a.cpu() - b).abs().max()) for a, b in
                     zip(tree.leaves(p_g), tree.leaves(p_c)))
        out[name] = dict(loss=lg, loss_vs_cpu=r_loss, grads_vs_cpu=r_grad,
                         params_after_step_max_abs_diff=r_step,
                         remat_vs_none=remat)
        print(f"{name} reduced, float32, B={LT_B} S={LT_S}: loss {lg:.6f}, "
              f"card vs CPU {r_loss:.2e} (limit {LT_LOSS_TOL}); grads "
              f"{r_grad:.2e} x max|g| (limit {LT_GRAD_TOL}); params after "
              f"the step max |diff| {r_step:.3g}; remat full / dots vs "
              f"none on the card "
              + " / ".join("bit for bit" if v == 0 else f"{v:.2e}"
                           for v in remat.values()))
    return out


def llm_train_full():
    """12b: qwen1.5-0.5b at its published config (24 layers, d_model
    1024, d_ff 2816, vocab 151936, bf16), logits_chunk 8192, remat
    "full", global batch 8 x seq 512, through ``launch.train.train``: 4
    uninterrupted steps, then a run cut at 2 (checkpoint every 2, into a
    temporary directory) and resumed to 4: its losses, params and opt
    state equal the uninterrupted run's bit for bit.  Then FULL_TIMED
    steps timed on the host clock (median), one step's device time,
    kernels and groups under torch.profiler, peak device memory of the
    uninterrupted run, and one checkpoint's size and save / restore
    seconds.  No port kernel runs on this path."""
    import tempfile

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.kernels import _build
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.optim import adamw
    from repro_torch.trace import device_kernels, device_times
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full")
    logs = []
    kw = dict(steps=FULL_STEPS, global_batch=FULL_BATCH, seq_len=FULL_SEQ,
              device=DEVICE, log_every=1, log_fn=logs.append)
    settle()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    ref = train(cfg, **kw)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as d:
        cut = train(cfg, ckpt_dir=d, ckpt_every=FULL_CUT, run_steps=FULL_CUT,
                    **kw)
        res = train(cfg, ckpt_dir=d, ckpt_every=FULL_CUT, **kw)
    sync()
    expect_launches(f"{LLM_ARCH} training", _build.launch_counts(), {})
    losses = cut["losses"] + res["losses"]
    if losses != ref["losses"] or any(x != x for x in losses):
        raise AssertionError(f"resumed losses {losses} vs uninterrupted "
                             f"{ref['losses']}")
    if not bits_equal((res["params"], res["opt_state"]),
                      (ref["params"], ref["opt_state"])):
        raise AssertionError("the resumed params / opt state differ from "
                             "the uninterrupted run's")
    del cut, res
    params, opt = ref["params"], ref["opt_state"]
    # phase 16 holds the mesh run against this run: a host copy of it
    kept = dict(losses=ref["losses"], state=host_leaves((params, opt)))
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=max(FULL_STEPS, 2),
                                warmup_steps=max(2, FULL_STEPS // 10))
    step_fn = make_train_step(cfg, opt_cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=FULL_SEQ,
                      global_batch=FULL_BATCH)
    batch = {k: torch.from_numpy(v).to(DEVICE).long()
             for k, v in global_batch_at(dcfg, FULL_STEPS).items()}
    wall = []
    for _ in range(FULL_TIMED):
        sync()
        t0 = time.perf_counter()
        _, _, met = step_fn(params, opt, batch)
        float(met["loss"])
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(wall)[len(wall) // 2]
    times = device_times(lambda: step_fn(params, opt, batch), iters=1)
    kernels = sum(device_kernels(lambda: step_fn(params, opt, batch)
                                 ).values())
    device_ms = sum(times.values()) / 1e3
    if DEVICE == "cuda" and not (kernels and device_ms):
        raise AssertionError("the profiler shows no device time of a step")
    groups = {}
    for k, us in times.items():
        groups[lt_group(k)] = groups.get(lt_group(k), 0.0) + us
    top = sorted(times.items(), key=lambda kv: -kv[1])[:15]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as d:
        t0 = time.perf_counter()
        path = save(d, FULL_STEPS, (params, opt))
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        (p2, o2), _ = restore(d, (params, opt))
        sync()
        restore_s = time.perf_counter() - t0
        if not bits_equal((p2, o2), (params, opt)):
            raise AssertionError("the restored checkpoint differs")
        del p2, o2
    out = dict(arch=LLM_ARCH, num_layers=cfg.num_layers,
               d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
               dtype=cfg.dtype, logits_chunk=FULL_CHUNK, remat="full",
               batch=FULL_BATCH, seq=FULL_SEQ, losses=ref["losses"],
               resume_bit_identical=True, run_s=run_s,
               step_wall_ms=wall, step_wall_ms_median=wall_ms,
               step_device_ms=device_ms, busy=device_ms / wall_ms,
               kernels_per_step=kernels,
               device_us_by_group=dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
               top_kernels_us=dict(top), peak_mem_bytes=peak,
               base_bytes=base, ckpt_bytes=nbytes, ckpt_save_s=save_s,
               ckpt_restore_s=restore_s,
               straggler_events=ref["straggler_events"], log=logs)
    print(f"{LLM_ARCH} training at its published config (bf16, "
          f"logits_chunk {FULL_CHUNK}, remat full, batch {FULL_BATCH} x "
          f"seq {FULL_SEQ}): losses {[round(x, 4) for x in ref['losses']]}"
          f"; cut at {FULL_CUT} and resumed: losses, params and opt state "
          f"equal the uninterrupted run's bit for bit; step "
          f"{wall_ms:.1f} ms median of {FULL_TIMED} (host clock; "
          f"{[round(x, 1) for x in wall]}), {device_ms:.1f} ms of device "
          f"and {kernels} kernels a step under the profiler: busy "
          f"{device_ms / wall_ms:.3f}; peak device memory "
          f"{peak / 2**30:.2f} GiB; checkpoint {nbytes / 2**30:.2f} GiB, "
          f"save {save_s:.2f} s, restore {restore_s:.2f} s; "
          f"{run_s:.1f} s for the uninterrupted run")
    print("  device us a step by group: " + ", ".join(
        f"{g} {us:.0f}" for g, us in out["device_us_by_group"].items()))
    kept["step_wall_ms_median"] = wall_ms
    return out, params, batch, kept


def settle():
    """Free what earlier work left to the cyclic collector, so a peak
    measured from here counts only what follows."""
    gc.collect()
    sync()
    torch.cuda.empty_cache()


def peak_of(fn):
    """Peak device bytes above those held before ``fn`` runs."""
    settle()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    sync()
    return torch.cuda.max_memory_allocated() - base


def llm_train_memory(params, batch):
    """12c: at 12b's shape, one ``loss_and_grads`` with logits_chunk 8192
    against 0 must lower the peak by at least half the full float32
    logits ([8, 512, 151936]); remat "full" / "dots" against "none"
    printed, not held."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import loss_and_grads
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full")
    logits = FULL_BATCH * FULL_SEQ * params["embed"].shape[0] * 4
    peaks = {}
    chunked = f"chunk {FULL_CHUNK}, remat full"
    for tag, c in ((chunked, cfg),
                   ("chunk 0, remat full", cfg.replace(logits_chunk=0)),
                   (f"chunk {FULL_CHUNK}, remat none",
                    cfg.replace(remat="none")),
                   (f"chunk {FULL_CHUNK}, remat dots",
                    cfg.replace(remat="dots"))):
        peaks[tag] = peak_of(lambda: loss_and_grads(params, c, batch))
    gap = peaks["chunk 0, remat full"] - peaks[chunked]
    if gap < logits / 2:
        raise AssertionError(f"the chunked loss lowers the peak by "
                             f"{gap / 2**30:.2f} GiB, less than half the "
                             f"{logits / 2**30:.2f} GiB of full logits")
    print(f"{LLM_ARCH} loss + backward peak above the params: "
          + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in peaks.items())
          + f"; the chunked loss saves {gap / 2**30:.2f} GiB (full float32 "
          f"logits {logits / 2**30:.2f} GiB)")
    return dict(peak_bytes=peaks, chunk_saves_bytes=gap,
                full_logits_bytes=logits)


def llm_train_example():
    """12d: ``examples/torch_train_bnn_lm.py``'s ``main`` (qwen family,
    4 layers, d_model 128, d_ff 384, vocab 2048, float32; batch 8 x seq
    128, 200 steps, lr 1e-3, a checkpoint every 50 into a temporary
    directory), whose own assert holds the mean loss of the last 10
    steps below that of the first 10."""
    logs = []
    t0 = time.perf_counter()
    out = example("train_bnn_lm").main(steps=EXAMPLE_STEPS, device=DEVICE,
                                       log=logs.append)
    secs = time.perf_counter() - t0
    first, last = out["first10"], out["last10"]
    print(f"{logs[0][len('training '):].split(' (')[0]} ({EXAMPLE_STEPS} "
          f"steps, batch 8 x seq 128, examples/torch_train_bnn_lm.py): "
          f"mean loss of the first 10 steps {first:.4f} -> last 10 "
          f"{last:.4f}; {secs:.1f} s, "
          f"{secs / EXAMPLE_STEPS * 1e3:.1f} ms a step")
    return dict(first10=first, last10=last, seconds=secs,
                losses=out["losses"], log=logs)


def llm_train_path(launches):
    """Phase 12, the LLM training path on the card: (a) the ten reduced
    architectures' step against the CPU and remat against none
    (``llm_train_reduced``), (b) qwen1.5-0.5b trained at its published
    config, cut and resumed (``llm_train_full``), (c) the chunked loss's
    and remat's peak memory (``llm_train_memory``), (d) the example's
    200 steps (``llm_train_example``).  No port kernel runs on this
    path: ``launches`` is not added to.  Returns the phase's record and
    (b)'s uninterrupted run on the host (losses, every leaf of params
    and opt state, the median step ms), which phase 16 is held to."""
    t_phase = time.perf_counter()
    out = {"reduced": llm_train_reduced()}
    out["full"], params, batch, kept = llm_train_full()
    out["memory"] = llm_train_memory(params, batch)
    del params, batch
    torch.cuda.empty_cache()
    out["example"] = llm_train_example()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the LLM training phase took {out['phase_s']:.1f} s")
    return out, kept


# ------------------------------------------------------------------ #
# phase 13: data faults, the tuning table, the auditor                 #
# ------------------------------------------------------------------ #
FAULT_FLIPS = (0, 1, 16, 256, 4096)
FAULT_SIGMAS = (0.0, 0.5, 1.0, 2.0, 4.0)
FAULT_ROWS = 64                # rows held against the CPU
FAULT_TIMED = 256              # rows of the timed curves
TUNE_MODELS = ("binarynet", "alexnet")
TUNED_SERVER_BATCH = 32        # max_batch of the prewarmed server
TUNING_TABLE = ROOT / "chiprun_out" / "tuning.json"


def phase13_models():
    """(label, spec, params, per_forward) of both models, the params
    from the script's seeded generator (as in phases 3-5)."""
    from repro_torch import graph
    from repro_torch.core.workloads import (alexnet_imagenet,
                                            binarynet_cifar10)
    out = []
    for label, wl, per in (("BinaryNet", binarynet_cifar10(),
                            BINARYNET_PER_FORWARD),
                           ("AlexNet", alexnet_imagenet(),
                            ALEXNET_PER_FORWARD)):
        spec = graph.from_workload(wl)
        params = graph.compile(spec, device=DEVICE).init(
            torch.Generator().manual_seed(0))
        out.append((label, spec, params, per))
    return out


def add_launches(launches, counts):
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def fault_curves(spec, params, per_forward, launches):
    """(a) ``seu_curve`` and ``threshold_curve`` over full-width
    BinaryNet on integer images: every row on the card equal to the
    ``"torch"`` backend's on the CPU on 64 images, the fault-free point
    exact, each forward launching BinaryNet's kernels; then both curves
    timed at batch 256 on the card (host clock, synchronised)."""
    from repro_torch import graph
    from repro_torch.kernels import _build
    from repro_torch.robustness import seu_curve, threshold_curve
    x = images(spec, FAULT_ROWS, 13)
    card = graph.compile(spec, device=DEVICE, batch=FAULT_ROWS)
    _build.reset_launch_counts()
    seu = seu_curve(card, params, x, FAULT_FLIPS, seed=0)
    thr = threshold_curve(card, params, x, FAULT_SIGMAS, seed=0)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    forwards = len(FAULT_FLIPS) + len(FAULT_SIGMAS) + 2
    expect_launches("fault curves", counts,
                    {k: v * forwards for k, v in per_forward.items()})
    add_launches(launches, counts)
    cpu = graph.compile(spec, backend="torch", device="cpu",
                        batch=FAULT_ROWS)
    pc, xc = to_cpu(params), x.cpu()
    if seu != seu_curve(cpu, pc, xc, FAULT_FLIPS, seed=0) or \
            thr != threshold_curve(cpu, pc, xc, FAULT_SIGMAS, seed=0):
        raise AssertionError("fault curves: the card's rows differ from the "
                             "CPU's")
    for rows in (seu, thr):
        r0 = rows[0]
        if r0["argmax_match"] != 1.0 or r0["mean_abs_logit_delta"] != 0.0 \
                or r0["max_abs_logit_delta"] != 0.0:
            raise AssertionError(f"fault curves: the fault-free point is "
                                 f"{r0}")
    for r in seu:
        print(f"seu_curve BinaryNet {FAULT_ROWS} rows: {r}")
    for r in thr:
        print(f"threshold_curve BinaryNet {FAULT_ROWS} rows: {r}")
    xt = images(spec, FAULT_TIMED, 14)
    timed = graph.compile(spec, device=DEVICE, batch=FAULT_TIMED)
    walls = {}
    for name, fn, pts in (("seu_curve", seu_curve, FAULT_FLIPS),
                          ("threshold_curve", threshold_curve,
                           FAULT_SIGMAS)):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(timed, params, xt, pts, seed=0)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        add_launches(launches, _build.launch_counts())
        print(f"{name} BinaryNet at batch {FAULT_TIMED}, {len(pts)} points: "
              f"{walls[name]:.3f} s wall on the card")
    return {"seu": seu, "threshold": thr, "wall_s": walls}


def tuned_forwards(models, launches):
    """(b) Tune both models' keys at batches 1, 32 and 256 into
    ``chiprun_out/tuning.json`` (``graph.tuning.tune_models``; each key's
    rule plan and time beside its best); then at each batch the untuned
    forward (empty table) and, after the table is loaded and the model
    recompiled, the tuned one: the logits equal bit for bit, the
    replayed forward timed both ways (host clock); then a prewarmed
    ``BNNServer`` over the table stays within ``trace_bound`` and serves
    eager ``apply``'s logits."""
    from repro_torch import graph
    from repro_torch.graph.replay import GraphedApply
    from repro_torch.graph.tuning import tune_models
    from repro_torch.kernels import _build, autotune
    from repro_torch.serving import BNNServer
    table = autotune.get_table()
    table.clear()
    t0 = time.perf_counter()
    rows = tune_models(TUNE_MODELS, BATCHES, DEVICE, decode=False, log=None)
    tune_s = time.perf_counter() - t0
    TUNING_TABLE.parent.mkdir(exist_ok=True)
    table.save(str(TUNING_TABLE))
    for r in rows:
        print(f"tuned {r['label']} {autotune.key_str(r['key'])}: rule "
              f"{r['rule']} {r['rule_ms']:.5f} ms, best {r['best']} "
              f"{r['best_ms']:.5f} ms")
    hits = sum(r["rule"] == r["best"] for r in rows)
    print(f"tuner: {len(rows)} keys in {tune_s:.1f} s, the rule's plan the "
          f"fastest at {hits}")
    table.clear()
    forwards = []
    _build.reset_launch_counts()
    for label, spec, params, per in models:
        for batch in BATCHES:
            x = images(spec, batch, 100 + batch)
            ms = {}
            for tuned in (False, True):
                table.clear()
                if tuned:
                    table.load(str(TUNING_TABLE))
                cb = graph.compile(spec, device=DEVICE, batch=batch)
                y = cb.apply(params, x)
                if not tuned:
                    want = y
                elif not torch.equal(y, want):
                    raise AssertionError(f"{label} B={batch}: the tuned "
                                         f"forward differs from the "
                                         f"untuned one")
                g = GraphedApply(cb, params, batch)
                if not torch.equal(g(x), want):
                    raise AssertionError(f"{label} B={batch}: a replay "
                                         f"differs from eager apply")
                ms["tuned" if tuned else "rule"] = wall_ms(lambda: g(x), 20)
                del g
            forwards.append(dict(model=label, batch=batch, **ms))
            print(f"{label} B={batch} replayed: {ms['rule']:.4f} ms/forward "
                  f"on the rules' plans, {ms['tuned']:.4f} ms on the "
                  f"tuned table; logits equal")
    spec, params = models[0][1], models[0][2]
    cb = graph.compile(spec, device=DEVICE, batch=TUNED_SERVER_BATCH)
    srv = BNNServer(cb, params, max_batch=TUNED_SERVER_BATCH, prewarm=True,
                    device=DEVICE)
    try:
        for rows_n in (1, 7, TUNED_SERVER_BATCH):
            x = images(spec, rows_n, 200 + rows_n)
            if not torch.equal(srv.apply_batch(x), cb.apply(params, x)):
                raise AssertionError(f"tuned server: {rows_n} rows differ "
                                     f"from eager apply")
        graphs, bound = srv.jit_traces(), srv.trace_bound()
    finally:
        srv.stop()
    torch.cuda.synchronize()
    add_launches(launches, _build.launch_counts())
    if graphs > bound:
        raise AssertionError(f"tuned server captured {graphs} graphs > "
                             f"trace_bound {bound}")
    print(f"BNNServer(max_batch={TUNED_SERVER_BATCH}, prewarm=True) over the "
          f"table: {graphs} graphs (trace_bound {bound}), results equal "
          f"eager apply")
    return {"keys": [dict(r, key=autotune.key_str(r["key"]),
                          times=[[e, ms] for e, ms in r["times"]])
                     for r in rows],
            "tune_s": tune_s, "rule_fastest": hits, "forwards": forwards,
            "server_graphs": graphs, "trace_bound": bound}


def audits(models):
    """(c) ``audit()`` on both models on the card at batches 1, 32 and
    256 with the tuned table loaded (its launches are recorded, not
    counted), the conv's shared-memory model held to the library's; then
    one ``pack_out`` forced off (a conv's int32 +-1 output, packed
    after) must fail the int32-escape check."""
    import ctypes
    import importlib
    from repro_torch import graph
    from repro_torch.analysis.audit import AuditError
    from repro_torch.kernels import _build, autotune, packed_conv
    from repro_torch.kernels.ops import binarize_pack
    lib = _build._load("packed_conv")
    lib.packed_conv2d_smem_bytes.argtypes = [ctypes.c_int] * 2
    for bm, bn in packed_conv.TILES:
        # k32 = 8 words, C32 % 4 == 0: one stage, a 16-byte table
        if lib.packed_conv2d_smem_bytes(bm, bn) != \
                packed_conv.smem_bytes(bm, bn, 8, 4) - 16:
            raise AssertionError(f"packed_conv.smem_bytes({bm}, {bn}) "
                                 f"differs from the library's")
    # the module, not the function graph re-exports under its name
    compile_mod = importlib.import_module("repro_torch.graph.compile")
    table = autotune.get_table()
    table.clear()
    table.load(str(TUNING_TABLE))
    out = []
    try:
        for label, spec, params, _ in models:
            for batch in BATCHES:
                cb = graph.compile(spec, device=DEVICE, batch=batch)
                report = cb.audit(params, images(spec, batch, 300 + batch),
                                  max_batch=256)
                print(report.format())
                out.append(dict(model=label, batch=batch,
                                launches=report.launches,
                                checks=[dict(name=c.name, ok=c.ok,
                                             skipped=c.skipped)
                                        for c in report.checks]))
        label, spec, params, _ = models[0]
        cb = graph.compile(spec, device=DEVICE, batch=32)
        orig = compile_mod.binary_conv
        calls = []

        def unpacked(h, wf, fold=None, pack_out=False, backend=None, **kw):
            calls.append(1)
            if len(calls) > 1:
                return orig(h, wf, fold=fold, pack_out=pack_out,
                            backend=backend, **kw)
            y = orig(h, wf, fold=fold, pack_out=False, backend=backend, **kw)
            return binarize_pack(y.to(torch.float32), backend=backend)
        compile_mod.binary_conv = unpacked
        try:
            cb.audit(params, images(spec, 32, 332))
        except AuditError as e:
            if "int32-escape" not in str(e):
                raise
            planted = str(e).splitlines()
        else:
            raise AssertionError("the audit passed a planted int32 output")
        finally:
            compile_mod.binary_conv = orig
        print("planted int32 output (conv2's pack_out forced off): "
              "the audit fails: " + next(line for line in planted
                                         if "int32-escape" in line).strip())
    finally:
        table.clear()
    return {"reports": out, "planted": planted}


def faults_tuning_audit_path(launches):
    """Phase 13: (a) the data faults' curves on the card against the
    CPU, (b) the tuning table — the search, the tuned forward and a
    prewarmed server over it — and (c) the auditor, passing on both
    models and failing where a fault is planted."""
    t_phase = time.perf_counter()
    models = phase13_models()
    out = {"faults": fault_curves(models[0][1], models[0][2], models[0][3],
                                  launches)}
    out["tuning"] = tuned_forwards(models, launches)
    out["audit"] = audits(models)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the faults, tuning and audit phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 14: the example twins and the dry-run                          #
# ------------------------------------------------------------------ #
# 14b: the dry-run over a named subset (the whole sweep takes minutes on
# the host): every arch at the three serving shapes, qwen1.5-0.5b's
# train_4k, at both variants
DRYRUN_SHAPES = ("decode_32k", "long_500k", "prefill_32k")
DRYRUN_TRAIN = ("qwen1.5-0.5b",)
DRYRUN_VARIANTS = ("baseline", "packed")
DRYRUN_MEM_TOL = 0.20          # argument + temp vs max_memory_allocated
BF16_TFLOPS = 989e12           # H100 SXM dense bf16, flop/s


def example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twins_on_card(launches):
    """14a: the quickstart, serve and tulip twins' ``main`` on the card
    (the training twin runs as 12d).  The quickstart's launches go into
    ``launches``; its compiled BinaryNet's forward must launch exactly
    BinaryNet's 8 kernels (the counts, and the profiler, asked again
    where it dropped records), its server take no fallback;
    the serve twin's dense and packed tokens are equal (its own
    assert) and it launches no port kernel; the tulip twin's lines equal
    its CPU run's."""
    from repro_torch.kernels import _build
    out = {}
    lines = []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    qs = example("quickstart").main(device=DEVICE, log=lines.append)
    sync()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    add_launches(launches, counts)
    missing = [k for k in BINARYNET_PER_FORWARD if not counts.get(k)]
    if missing:
        raise AssertionError(f"the quickstart launched no {missing}")
    bn = qs["binarynet"]
    if bn["compiled"].backend != "cuda" or bn["logits"].device.type \
            != torch.device(DEVICE).type:
        raise AssertionError("the quickstart's BinaryNet left the card")
    def forward():
        return bn["compiled"].apply(bn["params"], bn["image"])
    _build.reset_launch_counts()
    forward()
    sync()
    expect_launches("the quickstart's BinaryNet forward",
                    _build.launch_counts(), BINARYNET_PER_FORWARD)
    seen, _ = replay_kernels("the quickstart's BinaryNet forward", forward,
                             BINARYNET_PER_FORWARD)
    falls = qs["serve"]["stats"]["faults"]
    if falls["backend_fallbacks"] or falls["retries"]:
        raise AssertionError(f"the quickstart's server fell back: {falls}")
    out["quickstart"] = dict(seconds=secs, launches=counts,
                             forward_kernels=seen, lines=lines,
                             pareto_rows=qs["sim"]["pareto_rows"])
    print(f"examples/torch_quickstart.py on the card: {secs:.1f} s, "
          f"launches {counts}; its BinaryNet forward ran {seen} "
          f"(profiler), its server no fallback")
    for line in lines:
        if line.startswith(("[ASIC]", "[conv]", "[dse]", "[compile] 3",
                            "[serve]", "[sim]")):
            print(f"  {line}")

    _build.reset_launch_counts()
    logs = []
    t0 = time.perf_counter()
    sv = example("serve_bnn").main(device=DEVICE, log=logs.append)
    secs = time.perf_counter() - t0
    expect_launches("examples/torch_serve_bnn.py",
                    _build.launch_counts(), {})
    out["serve_bnn"] = dict(seconds=secs, dense=sv["dense"],
                            packed=sv["packed"], log=logs)
    print(f"examples/torch_serve_bnn.py on the card: {secs:.1f} s, dense "
          f"and packed tokens equal ({sum(map(len, sv['dense']))} "
          f"tokens), no port kernel")

    _build.reset_launch_counts()
    card, host = [], []
    t0 = time.perf_counter()
    tulip = example("tulip_asic_sim")
    tulip.main(device=DEVICE, log=card.append)
    secs = time.perf_counter() - t0
    tulip.main(device="cpu", log=host.append)
    expect_launches("examples/torch_tulip_asic_sim.py",
                    _build.launch_counts(), {})
    if card != host:
        raise AssertionError("the tulip twin's lines differ between the "
                             "card and the CPU")
    out["tulip_asic_sim"] = dict(seconds=secs, lines=card)
    print(f"examples/torch_tulip_asic_sim.py on the card: {secs:.1f} s, "
          f"{len(card)} lines, equal to its CPU run's; Table III "
          f"{'matched' if any('binary-layer P*Z' in x for x in card) else '?'}")
    return out


def dryrun_sweep():
    """14b: ``launch.dryrun.run_cell`` over DRYRUN_SHAPES for every arch
    and train_4k for DRYRUN_TRAIN, at DRYRUN_VARIANTS: every applicable
    cell ok, every skip with its reason."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    cells = [(a, s) for a in sorted(ARCHS) for s in DRYRUN_SHAPES] + \
        [(a, "train_4k") for a in DRYRUN_TRAIN]
    recs, tally = [], {"ok": 0, "skip": 0, "fail": 0}
    t0 = time.perf_counter()
    for variant in DRYRUN_VARIANTS:
        for arch, shape in cells:
            rec = dryrun.run_cell(arch, shape, "one_card", variant)
            status = ("skip" if not rec["applicable"]
                      else "ok" if rec.get("ok") else "fail")
            tally[status] += 1
            recs.append({k: rec.get(k) for k in (
                "arch", "shape", "variant", "applicable", "skip_reason",
                "ok", "error", "memory", "cost", "cost2", "wall_s")})
            if status == "skip" and not rec.get("skip_reason"):
                raise AssertionError(f"{arch} x {shape}: skipped without "
                                     f"a reason")
    secs = time.perf_counter() - t0
    failed = [(r["arch"], r["shape"], r["variant"], r["error"])
              for r in recs if r["applicable"] and not r["ok"]]
    print(f"dry-run over {len(cells)} cells x {len(DRYRUN_VARIANTS)} "
          f"variants on the host: ok {tally['ok']}, skip {tally['skip']}, "
          f"fail {tally['fail']}; {secs:.1f} s")
    if failed:
        raise AssertionError(f"dry-run cells failed: {failed}")
    return dict(tally=tally, seconds=secs, cells=recs)


def dryrun_vs_card():
    """14c: at 12b's config (qwen1.5-0.5b bf16, batch 8 x seq 512,
    logits_chunk 8192, remat "full") one ``make_train_step`` counted on
    meta tensors and run on the card under the same counter: the
    counts equal exactly, argument + temp bytes within DRYRUN_MEM_TOL of
    ``max_memory_allocated``; the scaled count (a cycle as the
    difference of two cut depths) equals the full one; the flop and byte
    terms at the card's peak printed beside the step's device ms."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import op_cost
    from repro_torch.trace import device_times
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full")
    shape = ShapeConfig("phase12b", FULL_SEQ, FULL_BATCH, "train")
    t0 = time.perf_counter()
    _, fn, meta_args = dryrun.build_cell(LLM_ARCH, "train_4k", "baseline",
                                         cfg, shape)
    with op_cost.Counter() as meta:
        fn(*meta_args)
    meta_s = time.perf_counter() - t0
    scaled = dryrun.step_cost(LLM_ARCH, "train_4k", "baseline", cfg, shape)
    if (scaled["cost2"].flops, scaled["cost2"].bytes) != \
            (meta.cost.flops, meta.cost.bytes):
        raise AssertionError(f"scaled count {scaled['cost2']} != full "
                             f"{meta.cost}")
    args_bytes = dryrun._nbytes(*meta_args)
    predicted = args_bytes + meta.peak_bytes

    params = init_params(torch.Generator(DEVICE).manual_seed(0), cfg,
                         DEVICE)
    opt = adamw.init(params)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                              generator=gen, dtype=v.dtype).to(DEVICE)
             for k, v in meta_args[-1].items()}
    settle()
    torch.cuda.reset_peak_memory_stats()
    with op_cost.Counter() as real:
        new = fn(params, opt, batch)
    sync()
    peak = torch.cuda.max_memory_allocated()
    loss = float(new[2]["loss"])
    del new
    if (real.cost.flops, real.cost.bytes) != (meta.cost.flops,
                                              meta.cost.bytes):
        diff = {op: (meta.by_op.get(op), real.by_op.get(op))
                for op in set(meta.by_op) | set(real.by_op)
                if meta.by_op.get(op) != real.by_op.get(op)}
        raise AssertionError(f"the card's count {real.cost} differs from "
                             f"the meta count {meta.cost}; ops (meta, "
                             f"card) {diff}")
    ratio = predicted / peak
    if abs(ratio - 1) > DRYRUN_MEM_TOL:
        raise AssertionError(f"argument + temp {predicted / 1e9:.2f} GB "
                             f"vs max_memory_allocated {peak / 1e9:.2f} "
                             f"GB: ratio {ratio:.3f}")
    times = device_times(lambda: fn(params, opt, batch), iters=1)
    device_ms = sum(times.values()) / 1e3
    flop_ms = meta.cost.flops / BF16_TFLOPS * 1e3
    byte_ms = meta.cost.bytes / MEM_BPS * 1e3
    print(f"dry-run vs the card, {LLM_ARCH} train step (bf16, batch "
          f"{FULL_BATCH} x seq {FULL_SEQ}, logits_chunk {FULL_CHUNK}, "
          f"remat full): count equal on meta and on the card "
          f"({meta.cost.flops:.6g} flops, {meta.cost.bytes:.6g} bytes, "
          f"{meta.ops} ops; meta run {meta_s:.1f} s), scaled count equal; "
          f"argument + temp {predicted / 1e9:.3f} GB vs "
          f"max_memory_allocated {peak / 1e9:.3f} GB (ratio "
          f"{ratio:.3f}); at the card's peak the flops take "
          f"{flop_ms:.1f} ms (bf16 {BF16_TFLOPS / 1e12:.0f} TFLOP/s) and "
          f"the bytes {byte_ms:.1f} ms (eager, unfused), the step "
          f"{device_ms:.1f} ms of device; loss {loss:.4f}")
    del params, opt, batch
    return dict(flops=meta.cost.flops, bytes=meta.cost.bytes, ops=meta.ops,
                argument_bytes=args_bytes, temp_bytes=meta.peak_bytes,
                max_memory_allocated=peak, mem_ratio=ratio,
                flop_ms_at_peak=flop_ms, byte_ms_at_peak=byte_ms,
                device_ms=device_ms, meta_s=meta_s,
                unpriced=dict(meta.unpriced))


def twins_dryrun_path(launches):
    """Phase 14: (a) the example twins on the card, (b) the dry-run
    sweep, (c) the dry-run held against the card."""
    t_phase = time.perf_counter()
    out = {"twins": twins_on_card(launches), "sweep": dryrun_sweep(),
           "vs_card": dryrun_vs_card()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the twins and dry-run phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 15: the mesh, the sharding rules, data-parallel serving        #
# ------------------------------------------------------------------ #
MESH_SLOTS = 4                  # slots of the mesh on one card
# (label, workload, max_batch, burst requests or None, row counts held,
# rows of the profiled flight: one piece on each of 4 slots)
MESH_SERVED = (("BinaryNet", "binarynet", 256, 512,
                (1, 2, 3, 4, 8, 11, 255), 200),
               ("AlexNet", "alexnet", 32, None,
                (1, 2, 3, 4, 8, 11, 22, 31), 27))
MESH_ROUNDS = 2                 # steady bursts a server, in turns
RULE_ARCHS = ("qwen1.5-0.5b", "mixtral-8x22b")


def per_device_bytes(arch, multi_pod, packed):
    """(bytes of ``arch``'s published params, the bytes one device holds
    of them under ``param_specs`` on the production mesh), on meta
    tensors: each leaf's bytes over the slots its spec splits it into."""
    import math

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import abstract_params
    from repro_torch.models.quantize import pack_model_params
    from repro_torch.runtime.sharding import P, param_specs
    mesh = make_production_mesh(multi_pod=multi_pod)
    params = abstract_params(get_arch(arch))
    if packed:
        params = pack_model_params(params)
    specs = tree.leaves(param_specs(params, mesh, ("decoder", "encoder")),
                        is_leaf=lambda s: isinstance(s, P))
    total = held = 0
    for leaf, spec in zip(tree.leaves(params), specs):
        t = leaf.words if isinstance(leaf, PackedArray) else leaf
        nbytes = t.numel() * t.element_size()
        split = math.prod(mesh.shape[a] for e in spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        total += nbytes
        held += nbytes // split
    return total, held


def rules_bytes():
    """15d: the parameter bytes a device holds of qwen1.5-0.5b and
    mixtral-8x22b at their published configs under ``param_specs``
    (FSDP over "data", TP over "model") on the (16, 16) and
    (2, 16, 16) meshes, baseline and packed."""
    out = {}
    for arch in RULE_ARCHS:
        for multi_pod in (False, True):
            for packed in (False, True):
                total, held = per_device_bytes(arch, multi_pod, packed)
                key = (f"{arch} {'2x16x16' if multi_pod else '16x16'} "
                       f"{'packed' if packed else 'baseline'}")
                out[key] = dict(total_bytes=total, per_device_bytes=held)
                print(f"param_specs {key}: {held} bytes a device of "
                      f"{total} ({total / held:.1f}x less)")
    return out


def replicated(cb, params, x, pieces):
    """What a mesh flight of ``x`` computes: each piece of ``pieces``
    (``BNNServer.split``) through the single-device ``apply`` at its
    graph's rows (zero-padded) and valid rows, the rows put back in
    order."""
    outs = []
    for _, lo, hi, rows, valid in pieces:
        xp = torch.zeros((rows, *x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        xp[:hi - lo] = x[lo:hi]
        outs.append(cb.apply(params, xp, valid_rows=valid)[:hi - lo])
    return torch.cat(outs)


def mesh_bursts(label, spec, cb, params, servers, max_batch, n_req,
                launches):
    """Phase 6's burst on every server: ``n_req`` requests of
    1..max_batch rows (seed 0) from 4 threads, every result equal to
    ``apply`` on its own rows; the first burst of each server warms it
    up, then ``MESH_ROUNDS`` steady bursts a server in turns (images/s,
    p50/p99 latency).  Starts the servers."""
    import numpy as np

    from repro_torch.kernels import _build
    rows = np.random.default_rng(0).integers(1, max_batch + 1, n_req)
    data = images(spec, int(rows.sum()), 0)
    offs = np.concatenate([[0], np.cumsum(rows)])
    xs = [data[offs[i]:offs[i + 1]] for i in range(n_req)]
    wants = [cb.apply(params, x) for x in xs]
    sync()
    for srv in servers.values():
        srv.start()
    names = list(servers)
    order = names + [n for r in range(MESH_ROUNDS)
                     for n in (names if r % 2 else names[::-1])]
    bursts = {n: [] for n in names}
    _build.reset_launch_counts()
    for i, name in enumerate(order):
        got, wall, lat = burst(servers[name], xs)
        for x, y, w in zip(xs, got, wants):
            if not torch.equal(y, w):
                raise AssertionError(f"{label} served by {name}: a result "
                                     f"({x.shape[0]} rows) differs from "
                                     f"apply on its own rows")
        if i >= len(names):            # the first burst of each warms up
            bursts[name].append(dict(wall_s=wall,
                                     images_per_s=float(rows.sum()) / wall,
                                     latency_ms=pcts(lat)))
    add_launches(launches, _build.launch_counts())
    for name in names:
        b = bursts[name]
        print(f"{label} served by {name}: steady bursts of {n_req} "
              f"requests ({int(rows.sum())} images, 4 threads) at "
              f"{[round(r['images_per_s'], 1) for r in b]} images/s, p50 "
              f"{[round(r['latency_ms']['p50'], 3) for r in b]} ms, p99 "
              f"{[round(r['latency_ms']['p99'], 3) for r in b]} ms; all "
              f"results equal apply on their own rows")
    return bursts


def mesh_model(label, key, max_batch, n_req, rows_list, flight_rows,
               meshes, launches):
    """15b/c: ``label`` at full width served by ``BNNServer(max_batch,
    mesh=...)`` on every mesh of ``meshes`` (prewarmed): each of
    ``rows_list`` launching one forward's kernels on every slot that
    received rows and equal bit for bit to the single-device ``apply``
    (BinaryNet, whose one float conv sums integers); AlexNet's conv2
    sums alpha-scaled floats in an order cuDNN picks by the batch, so
    each of its results is held bit for bit against the single-device
    ``apply`` of the pieces the mesh ran (``replicated``) and, through
    the split at ``SPLIT_AT``, against the whole batch's: the pieces'
    float activations within 1e-5 * max|h| of the whole batch's, the
    served logits the binary tail's on them.  With ``n_req``: beside
    the one-device server, a burst of ``n_req`` requests of
    1..max_batch rows (seed 0) from 4 threads, every result equal to
    ``apply`` on its own rows, then ``MESH_ROUNDS`` steady bursts a
    server in turns.  One flight of ``flight_rows`` rows under the
    profiler; no fallback, graphs within ``trace_bound``."""
    from repro_torch import graph
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.kernels import _build
    from repro_torch.serving import BNNServer
    per_forward = BINARYNET_PER_FORWARD if key == "binarynet" \
        else ALEXNET_PER_FORWARD
    spec = graph.from_workload(WORKLOADS[key])
    cb = graph.compile(spec, device=DEVICE, batch=max_batch)
    params = cb.init(torch.Generator().manual_seed(0))
    out = {}
    if key == "alexnet":
        # the float entry convs: the card against the CPU through the
        # split, before the mesh is held against the card
        out["split_gate"] = alexnet_vs_cpu(spec, cb, params,
                                           images(spec, 11, 15))
        print(f"AlexNet (phase 15) split gate: {out['split_gate']}")
        head, tail = cb.split(SPLIT_AT)
    servers, prewarm_s = {}, {}
    for name, mesh in [*([("one device", None)] if n_req else []),
                       *meshes.items()]:
        t0 = time.perf_counter()
        servers[name] = BNNServer(cb, params, max_batch=max_batch,
                                  prewarm=True, max_queue_rows=None,
                                  mesh=mesh, device=DEVICE)
        prewarm_s[name] = time.perf_counter() - t0

    held = {}
    for name in meshes:
        srv, rows_out = servers[name], []
        for rows in rows_list:
            x = images(spec, rows, 100 + rows)
            want = cb.apply(params, x)
            sync()
            _build.reset_launch_counts()
            got = srv.apply_batch(x)
            sync()
            counts = _build.launch_counts()
            add_launches(launches, counts)
            split = srv.split(rows)
            pieces = len(split)
            expect_launches(f"{label} on mesh {name}, {rows} rows", counts,
                            {k: v * pieces for k, v in per_forward.items()})
            rec = dict(rows=rows, pieces=pieces,
                       whole_batch_equal=torch.equal(got, want))
            if key == "alexnet":
                if not torch.equal(got, replicated(cb, params, x, split)):
                    raise AssertionError(f"AlexNet on mesh {name}: {rows} "
                                         f"rows differ from the apply of "
                                         f"the pieces it ran")
                h = replicated(head, params, x, split)
                h_whole = head.apply(params, x)
                err = float((h - h_whole).abs().max())
                tol = 1e-5 * float(h_whole.abs().max())
                if err > tol or not torch.equal(tail.apply(params, h), got):
                    raise AssertionError(f"AlexNet on mesh {name}, {rows} "
                                         f"rows: the pieces' float layers "
                                         f"{err} from the whole batch's "
                                         f"(tol {tol}), or the tail on "
                                         f"them differs from the served")
                rec.update(float_err=err, float_tol=tol, sign_flips=int(
                    ((h > 0) != (h_whole > 0)).sum()))
            elif not rec["whole_batch_equal"]:
                raise AssertionError(f"{label} on mesh {name}: {rows} rows "
                                     f"differ from the single-device apply")
            rows_out.append(rec)
        held[name] = rows_out
        exact = [r["rows"] for r in rows_out if r["whole_batch_equal"]]
        print(f"{label} on mesh {name} (max_batch {max_batch}): rows "
              f"{list(rows_list)}, pieces {[r['pieces'] for r in rows_out]}"
              f", each {sum(per_forward.values())} kernels a piece; equal "
              f"to the single-device apply of the whole batch bit for bit "
              f"at {exact}")
        if key == "alexnet":
            print(f"  AlexNet: every row count equal to the apply of the "
                  f"pieces it ran; the pieces' float activations within "
                  f"{max(r['float_err'] for r in rows_out):.3g} of the "
                  f"whole batch's (tol >= "
                  f"{min(r['float_tol'] for r in rows_out):.3g}), signs "
                  f"differing {[r['sign_flips'] for r in rows_out]}, the "
                  f"binary tail on them equal to the served logits")
        print(f"  prewarm "
              f"{prewarm_s[name]:.2f} s, {servers[name].jit_traces()} "
              f"levels, graphs a slot "
              f"{[s['graphs'] for s in servers[name].slots()]}")
    out["rows"] = held
    out["prewarm_s"] = prewarm_s
    if n_req:
        out["bursts"] = mesh_bursts(label, spec, cb, params, servers,
                                    max_batch, n_req, launches)
    else:
        for srv in servers.values():
            srv.start()

    flights = {}
    x1 = images(spec, flight_rows, 7)
    for name in meshes:
        srv = servers[name]
        pieces = len(srv.split(flight_rows))
        want1 = {k: v * pieces for k, v in per_forward.items()}
        n_flights = [0]

        def flight():
            n_flights[0] += 1
            return srv.submit(x1).result(timeout=60)

        _build.reset_launch_counts()
        seen, views = replay_kernels(f"{label} mesh {name} flight of "
                                     f"{flight_rows} rows", flight, want1)
        counted = {k: v for k, v in _build.launch_counts().items() if v}
        if counted != {k: n_flights[0] * v for k, v in want1.items()}:
            raise AssertionError(f"{label} mesh {name}: the counts rose by "
                                 f"{counted} in {n_flights[0]} flights of "
                                 f"{pieces} pieces")
        add_launches(launches, counted)
        flights[name] = dict(rows=flight_rows, pieces=pieces,
                             profiler_kernels=seen, views=views,
                             flights=n_flights[0])
        print(f"{label} mesh {name}: a profiled flight of {flight_rows} "
              f"rows ran {seen} (view {views}) = {pieces} slots x one "
              f"forward")
    out["profiled_flight"] = flights

    for name, srv in servers.items():
        srv.stop()
        st = srv.stats()
        faults = st["faults"]
        if any(faults.values()) or st["jit_traces"] > st["trace_bound"]:
            raise AssertionError(f"{label} served by {name}: faults "
                                 f"{faults}, {st['jit_traces']} levels "
                                 f"(bound {st['trace_bound']})")
        out.setdefault("servers", {})[name] = dict(
            devices=st["devices"], levels=st["jit_traces"],
            trace_bound=st["trace_bound"], batches=st["batches"],
            slots=srv.slots())
        if name != "one device":
            print(f"{label} served by {name}: devices {st['devices']}, "
                  f"slots {srv.slots()}, no fallback")
    return out


def mesh_path(launches):
    """Phase 15: (a) the meshes, ``serving.data_mesh()`` over every
    visible card and, on a one-card machine, ``MESH_SLOTS`` slots on
    cuda:0; (b) BinaryNet and (c) XNOR-AlexNet served on them
    (``mesh_model``); (d) ``param_specs``' bytes a device
    (``rules_bytes``)."""
    from repro_torch.serving import data_mesh
    t_phase = time.perf_counter()
    meshes = {"every card": data_mesh()}
    if torch.cuda.device_count() == 1:
        meshes[f"{MESH_SLOTS} slots on cuda:0"] = data_mesh(
            devices=[torch.device("cuda", 0)] * MESH_SLOTS)
    out = {"meshes": {}}
    for name, mesh in meshes.items():
        cards = len(mesh.distinct_devices())
        out["meshes"][name] = dict(shape=mesh.shape, slots=mesh.size,
                                   cards=cards)
        print(f"mesh {name}: {mesh.shape}, {mesh.size} slots on {cards} "
              f"distinct card(s)")
    for label, key, max_batch, n_req, rows_list, flight_rows in MESH_SERVED:
        out[label] = mesh_model(label, key, max_batch, n_req, rows_list,
                                flight_rows, meshes, launches)
    out["rules"] = rules_bytes()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the mesh phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 16: SPMD training over a torch.distributed mesh                #
# ------------------------------------------------------------------ #
SPMD_LAYERS = 2        # 16b's depth (the published widths)


def spmd_full(mesh, kept):
    """16a: ``train(mesh=...)`` on the world-1 NCCL mesh at 12b's
    config and run (qwen1.5-0.5b, bf16, logits_chunk 8192, remat
    "full", batch 8 x seq 512, FULL_STEPS steps): losses, params and opt
    state equal 12b's uninterrupted run (``kept``) bit for bit; then
    FULL_TIMED mesh steps on 12b's timed batch (host clock, median)
    beside 12b's.  No port kernel runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.kernels import _build
    from repro_torch.launch.train import make_mesh_train_step, train
    from repro_torch.optim import adamw
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full")
    logs = []
    settle()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    run = train(cfg, steps=FULL_STEPS, global_batch=FULL_BATCH,
                seq_len=FULL_SEQ, mesh=mesh, device=DEVICE, log_every=1,
                log_fn=logs.append)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"{LLM_ARCH} training on the mesh",
                    _build.launch_counts(), {})
    if run["losses"] != kept["losses"]:
        raise AssertionError(f"mesh losses {run['losses']} vs 12b's "
                             f"{kept['losses']}")
    if not bits_equal(host_leaves((run["params"], run["opt_state"])),
                      kept["state"]):
        raise AssertionError("the mesh run's params / opt state differ "
                             "from 12b's uninterrupted run")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=max(FULL_STEPS, 2),
                                warmup_steps=max(2, FULL_STEPS // 10))
    step_fn = make_mesh_train_step(cfg, opt_cfg, mesh)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=FULL_SEQ,
                      global_batch=FULL_BATCH)
    batch = {k: torch.from_numpy(v).to(DEVICE).long()
             for k, v in global_batch_at(dcfg, FULL_STEPS).items()}
    params, opt = run["params"], run["opt_state"]
    del run
    wall = []
    for _ in range(FULL_TIMED):
        sync()
        t0 = time.perf_counter()
        _, _, met = step_fn(params, opt, batch)
        float(met["loss"])
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(wall)[len(wall) // 2]
    base_ms = kept["step_wall_ms_median"]
    print(f"{LLM_ARCH} trained on the world-1 {dist.get_backend()} mesh "
          f"{mesh}: losses, "
          f"params and opt state equal 12b's uninterrupted run bit for "
          f"bit; step {wall_ms:.1f} ms median of {FULL_TIMED} (host clock; "
          f"{[round(x, 1) for x in wall]}) beside 12b's {base_ms:.1f} ms "
          f"({wall_ms / base_ms:.3f}x); peak device memory "
          f"{peak / 2**30:.2f} GiB; {run_s:.1f} s for the run")
    return dict(losses=kept["losses"], bit_identical_to_12b=True,
                run_s=run_s, step_wall_ms=wall, step_wall_ms_median=wall_ms,
                step_wall_ms_median_12b=base_ms, peak_mem_bytes=peak,
                log=logs)


def spmd_resume(mesh):
    """16b: qwen1.5-0.5b at its published widths cut to SPMD_LAYERS
    layers (same run otherwise): a mesh run cut at FULL_CUT whose
    checkpoint the plain ``train`` resumes, and a plain run cut there
    that the mesh resumes, each equal to the plain uninterrupted run bit
    for bit (losses, params, opt state)."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full",
                                     num_layers=SPMD_LAYERS)
    kw = dict(steps=FULL_STEPS, global_batch=FULL_BATCH, seq_len=FULL_SEQ,
              device=DEVICE, log_fn=lambda *_: None)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    ref = train(cfg, **kw)
    want_losses = ref["losses"]
    want = host_leaves((ref["params"], ref["opt_state"]))
    del ref
    out = {}
    for label, first, then in (("mesh -> plain", mesh, None),
                               ("plain -> mesh", None, mesh)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_spmd_") as d:
            cut = train(cfg, ckpt_dir=d, ckpt_every=FULL_CUT,
                        run_steps=FULL_CUT, mesh=first, **kw)
            res = train(cfg, ckpt_dir=d, ckpt_every=FULL_CUT, mesh=then,
                        **kw)
        losses = cut["losses"] + res["losses"]
        got = host_leaves((res["params"], res["opt_state"]))
        del cut, res
        if losses != want_losses:
            raise AssertionError(f"{label}: losses {losses} vs the "
                                 f"uninterrupted run's {want_losses}")
        if not bits_equal(got, want):
            raise AssertionError(f"{label}: the resumed params / opt state "
                                 f"differ from the uninterrupted run's")
        out[label] = dict(losses=losses, bit_identical=True)
    sync()
    expect_launches("the cut and resumed mesh runs", _build.launch_counts(),
                    {})
    secs = time.perf_counter() - t0
    print(f"{LLM_ARCH} at {SPMD_LAYERS} layers, published widths: a mesh "
          f"checkpoint at step {FULL_CUT} resumed by the plain train, and a "
          f"plain one resumed on the mesh, each equal to the uninterrupted "
          f"run bit for bit (losses, params, opt state); {secs:.1f} s")
    return dict(out, num_layers=SPMD_LAYERS, seconds=secs)


# 16c: the tensor-parallel step on two gloo ranks of the one card
TP_LAYERS = 2          # the published widths, depth cut
TP_BATCH, TP_SEQ = 4, 256
TP_TOL = 1e-4          # loss (relative) and each grad leaf (x its max|g|)
TP_DEADLINE = 300      # seconds the two rank processes may take


def tp_boundary_rows(v, m):
    """The first and last vocab rows of each of ``m`` model ranks'
    blocks of a ``v``-row vocab (a rank's last chunk is padded: a token
    just past it is the next rank's), and the vocab's last."""
    n = v // m
    return sorted({r for k in range(m)
                   for r in (k * n, k * n + 1, (k + 1) * n - 1)} | {v - 1})


def tp_rank_main(rank, where):
    """16c's rank program, ``python3 chip_smoke.py --tp-rank RANK DIR``:
    one of two gloo ranks (CUDA tensors on cuda:0; a store file in DIR)
    on a (data, model) = (1, 2) mesh.  qwen1.5-0.5b at its published
    widths, TP_LAYERS layers, float32, logits_chunk 8192, remat "full",
    a TP_BATCH x TP_SEQ batch of the token stream: the tensor-parallel
    ``mesh_loss_and_grads`` (the rank's grad blocks), then the
    one-process ``loss_and_grads`` on the same params and batch (its
    first row's tokens and targets set to ``tp_boundary_rows``), its
    grads cut to the rank's blocks (``distribute_tensor`` with no
    source rank sends nothing: DTensor's own collectives over gloo
    crash on CUDA tensors, PERF.md §6); the errors and the wall times
    go to DIR/tp{RANK}.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import init_params
    from repro_torch.runtime import sharding as shd
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{where}/store",
                            world_size=2, rank=rank)
    try:
        mesh = make_process_mesh(2, device="cuda")
        cfg = get_arch(LLM_ARCH).replace(dtype="float32",
                                         num_layers=TP_LAYERS,
                                         logits_chunk=FULL_CHUNK,
                                         remat="full")
        params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TP_SEQ,
                          global_batch=TP_BATCH)
        batch = {k: torch.from_numpy(v).to("cuda").long()
                 for k, v in global_batch_at(dcfg, 0).items()}
        rows = tp_boundary_rows(cfg.padded_vocab(), 2)
        for k in ("tokens", "targets"):
            batch[k][0, :len(rows)] = torch.tensor(rows, device="cuda")
        placed = shd.distribute(params, T.shardings(params, mesh)[0])
        groups = shd.tp_groups(mesh)

        def timed(fn, *args):
            fn(*args)                                       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3
        (loss, grads), tp_ms = timed(T.mesh_loss_and_grads, placed, cfg,
                                     batch, groups)
        (want, want_grads), one_ms = timed(T.loss_and_grads, params, cfg,
                                           batch)
        errs = []
        for g, w, p in zip(tree.leaves(grads), tree.leaves(want_grads),
                           tree.leaves(placed)):
            w = distribute_tensor(w, p.device_mesh, p.placements,
                                  src_data_rank=None).to_local()
            errs.append(float((g - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
        # NaN counts as the worst (a comparison with NaN is False)
        worst = max(range(len(errs)), key=lambda i: (
            math.inf if math.isnan(errs[i]) else errs[i]))
        Path(where, f"tp{rank}.json").write_text(json.dumps(dict(
            loss=float(loss), loss_one=float(want),
            loss_err=abs(float(loss) - float(want)) / abs(float(want)),
            grad_err=errs[worst], worst_leaf=worst, leaves=len(errs),
            leaves_over=sum(not e <= TP_TOL for e in errs),
            boundary_rows=rows, tp_ms=tp_ms, one_ms=one_ms)))
    finally:
        dist.destroy_process_group()
    return 0


def spmd_tensor_parallel():
    """16c: ``tp_rank_main`` in two processes (the card's one rank per
    process, gloo: it runs the step's all-reduce (sum, max), all-gather
    and reduce-scatter on CUDA tensors), killed at TP_DEADLINE; on each
    rank the loss finite and within TP_TOL of the one-process loss
    (relative) and every grad block within TP_TOL x the max|g| of the
    one-process grad's block (a NaN fails).  No port kernel runs."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
             str(r), d], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                left = TP_DEADLINE - (time.perf_counter() - t0)
                outs.append(p.communicate(timeout=max(left, 1)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"16c rank {r} exited {p.returncode}: "
                                     f"{err[-3000:]}")
        ranks = [json.loads(Path(d, f"tp{r}.json").read_text())
                 for r in range(2)]
    for r, got in enumerate(ranks):
        if not (math.isfinite(got["loss"]) and got["loss_err"] <= TP_TOL
                and got["grad_err"] <= TP_TOL and got["leaves_over"] == 0):
            raise AssertionError(f"16c rank {r}: the tensor-parallel step "
                                 f"vs one process: {got}")
    res = dict(max(ranks, key=lambda g: g["grad_err"]), ranks=ranks,
               seconds=time.perf_counter() - t0)
    print(f"{LLM_ARCH} at {TP_LAYERS} layers (published widths, float32, "
          f"batch {TP_BATCH} x seq {TP_SEQ}): the tensor-parallel step on "
          f"a (1, 2) mesh of two gloo ranks on the card (CUDA tensors) "
          f"against the one-process step: loss {res['loss']:.6f} vs "
          f"{res['loss_one']:.6f} (relative {res['loss_err']:.3g}), grad "
          f"blocks within {res['grad_err']:.3g} x max|g| (leaf "
          f"{res['worst_leaf']} of {res['leaves']}); loss and grads "
          f"{res['tp_ms']:.1f} ms (gloo through the host) vs "
          f"{res['one_ms']:.1f} ms; {res['seconds']:.1f} s")
    return res


def spmd_path(kept):
    """Phase 16, SPMD training over a ``torch.distributed`` mesh: a
    world-1 process group (NCCL on the card; a store file in a temporary
    directory, destroyed at the end of the phase), ``make_process_mesh()``
    on it, then (a) ``spmd_full`` against phase 12b's run ``kept`` and
    (b) ``spmd_resume``; then (c) ``spmd_tensor_parallel`` (on the
    card).  No port kernel runs on this path: the ``kernels`` line's
    launches are not added to."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_process_mesh
    t_phase = time.perf_counter()
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as d:
        dist.init_process_group(backend, init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_process_mesh(device=DEVICE)
            out = dict(mesh=str(mesh), backend=backend,
                       full=spmd_full(mesh, kept), resume=spmd_resume(mesh))
        finally:
            dist.destroy_process_group()
    if DEVICE == "cuda":
        out["tensor_parallel"] = spmd_tensor_parallel()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"the SPMD training phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# phase 17: the dry-run on the production meshes                       #
# ------------------------------------------------------------------ #
MESH_DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH_DRY_PACKED = (("qwen1.5-0.5b", "decode_32k"),)
MESH_DRY_DEADLINE = 150        # seconds the host sweep may take


def mesh_sweep_start(out_dir):
    """17a, started: the dry-run CLI with ``--mesh both`` (the (16, 16)
    and (2, 16, 16) meshes on torch's fake process group, meta tensors)
    on the host, one process per (arch, shape, variant) of RULE_ARCHS x
    MESH_DRY_SHAPES baseline and MESH_DRY_PACKED packed, all started
    together, the card hidden from them (the dry-run needs none)."""
    cells = [(a, s, "baseline") for a in RULE_ARCHS
             for s in MESH_DRY_SHAPES] + \
        [(a, s, "packed") for a, s in MESH_DRY_PACKED]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, variant in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "both", "--variant",
               variant, "--out", str(out_dir)]
        procs.append(((arch, shape, variant), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)))
    return dict(procs=procs, t0=time.perf_counter(), out=out_dir)


def mesh_sweep_stop(job):
    """Kill whatever of the sweep still runs."""
    for _, p in job["procs"]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def mesh_sweep_finish(job, total_memory):
    """17a, ended: every process exits 0 within MESH_DRY_DEADLINE and
    every cell is ok; each baseline record's parameter bytes equal
    ``param_specs``' bytes a device (phase 15d's ``per_device_bytes``);
    each cell's scaled flops, bytes, collectives by kind and argument +
    temp bytes printed, with their ratio to the card's memory (a ratio
    over 1.0 is printed, not failed)."""
    failed = []
    for cell, p in job["procs"]:
        left = MESH_DRY_DEADLINE - (time.perf_counter() - job["t0"])
        try:
            out, err = p.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            mesh_sweep_stop(job)
            raise AssertionError(f"the mesh dry-run passed its "
                                 f"{MESH_DRY_DEADLINE} s deadline at {cell}")
        if p.returncode:
            failed.append((cell, out[-2000:], err[-2000:]))
    secs = time.perf_counter() - job["t0"]
    if failed:
        raise AssertionError(f"mesh dry-run processes failed: {failed}")
    cells, over = [], []
    for (arch, shape, variant), _ in job["procs"]:
        for mesh in ("single", "multi"):
            path = job["out"] / f"{arch}__{shape}__{mesh}__{variant}.json"
            rec = json.loads(path.read_text())
            if not rec.get("ok"):
                raise AssertionError(f"{path.name}: {rec.get('error')}")
            mem = rec["memory"]
            if variant == "baseline":
                _, want = per_device_bytes(arch, mesh == "multi", False)
                got = mem["argument_split"]["params"]
                if got != want:
                    raise AssertionError(
                        f"{path.name}: {got} param bytes a device, "
                        f"param_specs gives {want}")
            held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            ratio = held / total_memory
            c2 = rec["cost2"]
            key = f"{arch} {shape} {mesh} {variant}"
            if ratio > 1.0:
                over.append(key)
            cells.append(dict(cell=key, flops=c2["flops"], bytes=c2["bytes"],
                              collectives=rec["collectives"],
                              collectives_static=rec["collectives_static"],
                              memory=mem, held_bytes=held,
                              ratio_to_card=ratio, wall_s=rec["wall_s"]))
            coll = {k: float(f"{v:.4g}")
                    for k, v in rec["collectives"].items()}
            print(f"mesh dry-run {key}: {c2['flops']:.4g} flops, "
                  f"{c2['bytes']:.4g} bytes, collectives {coll}, "
                  f"argument + temp {held / 1e9:.2f} GB = {ratio:.3f} of the "
                  f"card's {total_memory / 1e9:.1f} GB"
                  + (" (over)" if ratio > 1.0 else ""))
    print(f"mesh dry-run on the host: {len(cells)} cells ok in {secs:.1f} s "
          f"({len(job['procs'])} processes); over the card's memory: "
          f"{over or 'none'}")
    return dict(cells=cells, seconds=secs, over_card=over)


def mesh_dryrun_vs_card():
    """17b: at 12b's config (qwen1.5-0.5b bf16, batch 8 x seq 512,
    logits_chunk 8192, remat "full") the mesh step
    (``launch.train.make_mesh_train_step`` through
    ``dryrun.place_cell``) counted on meta tensors over a fake world of
    one, and run on a world-1 mesh on the card (NCCL; a store file in a
    temporary directory, destroyed after) under the same counter: flops
    and bytes equal exactly, argument + temp within DRYRUN_MEM_TOL of
    ``max_memory_allocated``; where they differ, the ops that differ.
    No port kernel runs."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_process_mesh
    from repro_torch.models import init_params, input_specs
    from repro_torch.runtime import op_cost
    cfg = get_arch(LLM_ARCH).replace(logits_chunk=FULL_CHUNK, remat="full")
    shape = ShapeConfig("phase12b", FULL_SEQ, FULL_BATCH, "train")
    t0 = time.perf_counter()
    with fake_world(1):
        _, fn, meta_args = dryrun.build_cell(
            LLM_ARCH, "train_4k", "baseline", cfg, shape,
            mesh=make_process_mesh(device="cpu"))
        with op_cost.Counter() as meta:
            fn(*meta_args)
        args_bytes = dryrun._nbytes(*meta_args)
        del fn, meta_args
    meta_s = time.perf_counter() - t0
    predicted = args_bytes + meta.peak_bytes

    params = init_params(torch.Generator(DEVICE).manual_seed(0), cfg,
                         DEVICE)
    gen = torch.Generator().manual_seed(1)
    inputs = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                               generator=gen, dtype=v.dtype).to(DEVICE)
              for k, v in input_specs(cfg, shape).items()}
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as d:
        dist.init_process_group(backend, init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_process_mesh(device=DEVICE)
            fn, args = dryrun.place_cell(cfg, shape, "baseline", mesh,
                                         params, inputs)
            del params, inputs
            settle()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            with op_cost.Counter() as real:
                new = fn(*args)
            sync()
            peak = torch.cuda.max_memory_allocated()
            loss = float(new[2]["loss"])
            del new, fn, args
        finally:
            dist.destroy_process_group()
    expect_launches("17b's mesh step", _build.launch_counts(), {})
    if (real.cost.flops, real.cost.bytes) != (meta.cost.flops,
                                              meta.cost.bytes):
        diff = {op: (meta.by_op.get(op), real.by_op.get(op))
                for op in set(meta.by_op) | set(real.by_op)
                if meta.by_op.get(op) != real.by_op.get(op)}
        raise AssertionError(f"the card's count {real.cost} differs from "
                             f"the meta count {meta.cost}; ops (meta, "
                             f"card) {diff}")
    ratio = predicted / peak
    if abs(ratio - 1) > DRYRUN_MEM_TOL:
        raise AssertionError(f"argument + temp {predicted / 1e9:.2f} GB "
                             f"vs max_memory_allocated {peak / 1e9:.2f} "
                             f"GB: ratio {ratio:.3f}")
    print(f"mesh dry-run vs the card, {LLM_ARCH} mesh train step at "
          f"world 1 ({backend}; bf16, batch {FULL_BATCH} x seq {FULL_SEQ}, "
          f"logits_chunk {FULL_CHUNK}, remat full): count equal on meta "
          f"(fake world of one) and on the card ({meta.cost.flops:.6g} "
          f"flops, {meta.cost.bytes:.6g} bytes, collectives "
          f"{dict(meta.cost.collectives)} (card "
          f"{dict(real.cost.collectives)}), {meta.ops} ops; meta run "
          f"{meta_s:.1f} s); argument + temp {predicted / 1e9:.3f} GB vs "
          f"max_memory_allocated {peak / 1e9:.3f} GB (ratio {ratio:.3f}); "
          f"loss {loss:.4f}")
    return dict(flops=meta.cost.flops, bytes=meta.cost.bytes,
                collectives=dict(meta.cost.collectives),
                collectives_card=dict(real.cost.collectives), ops=meta.ops,
                argument_bytes=args_bytes, temp_bytes=meta.peak_bytes,
                max_memory_allocated=peak, mem_ratio=ratio, meta_s=meta_s,
                unpriced=dict(meta.unpriced))


def mesh_dryrun_path():
    """Phase 17, the dry-run on the production meshes: (a) the host
    sweep started, (b) the mesh step counted on meta against the card
    while it runs, then (a) read and gated.  No port kernel runs on
    this path: the ``kernels`` line's launches are not added to."""
    t_phase = time.perf_counter()
    job = mesh_sweep_start(ROOT / "chiprun_out" / "dryrun_mesh")
    try:
        vs_card = mesh_dryrun_vs_card()
        sweep = mesh_sweep_finish(
            job, torch.cuda.get_device_properties(0).total_memory)
    finally:
        mesh_sweep_stop(job)
    out = dict(sweep=sweep, vs_card=vs_card,
               phase_s=time.perf_counter() - t_phase)
    print(f"the mesh dry-run phase took {out['phase_s']:.1f} s")
    return out


MMA_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// 16 independent mma.sync chains per warp, operands in registers
#define REPRO_PROBE(NAME, ACC, CONS, INSTR)                                  \
  __global__ void NAME(float* out, int iters) {                             \
    ACC d[16][4] = {};                                                       \
    const uint32_t a = threadIdx.x * 0x9E3779B9u, b = a * 3u;                \
    for (int it = 0; it < iters; ++it)                                       \
      _Pragma("unroll") for (int c = 0; c < 16; ++c)                         \
        asm volatile(INSTR " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "        \
                     "{%0,%1,%2,%3};"                                        \
                     : "+" CONS(d[c][0]), "+" CONS(d[c][1]),                 \
                       "+" CONS(d[c][2]), "+" CONS(d[c][3])                  \
                     : "r"(a), "r"(b), "r"(a ^ b), "r"(a + b), "r"(b),      \
                       "r"(a));                                              \
    float s = 0.f;                                                           \
    for (int c = 0; c < 16; ++c)                                             \
      s += (float)d[c][0] + (float)d[c][1] + (float)d[c][2] + (float)d[c][3]; \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                          \
  }
REPRO_PROBE(probe_bf16, float, "f",
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32")
REPRO_PROBE(probe_s8, int, "r",
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32")
REPRO_PROBE(probe_b1, int, "r",
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc")
extern "C" int mma_probe_launch(int kind, float* out, int blocks,
                                int iters) {
  if (kind == 0) probe_bf16<<<blocks, 512>>>(out, iters);
  else if (kind == 1) probe_s8<<<blocks, 512>>>(out, iters);
  else probe_b1<<<blocks, 512>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
# kind code of the probe, its multiply-accumulates per instruction (one
# per +-1 product for s8 and b1), and the dense rate it is held against
MMA_KINDS = {"bf16 m16n8k16": (0, 16 * 8 * 16, BF16_OPS, "bf16"),
             "s8 m16n8k32": (1, 16 * 8 * 32, INT8_OPS, "int8"),
             "b1 m16n8k256 and.popc": (2, 16 * 8 * 256, INT8_OPS, "int8")}


def mma_sync_ceilings():
    """The rate each mma.sync variant reaches on this card from
    registers (16 warps per block, 2 blocks per SM, 16 independent
    chains a warp), in 2 x multiply-accumulates per second (TFLOP/s for
    bf16, TOP/s of +-1 products for s8 and b1): the ceiling of a kernel
    built on that instruction, which is not the card's dense rate (that
    needs wgmma).  CUDA events."""
    import ctypes

    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_probe.cu"
    lib_path = _build.BUILD_DIR / "mma_probe.so"
    src.write_text(MMA_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int]
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 512, device=DEVICE)
    iters = 4000
    rates = {}
    for name, (kind, macs, _, _) in MMA_KINDS.items():
        def run():
            if lib.mma_probe_launch(kind, out.data_ptr(), blocks,
                                    iters) != 0:
                raise AssertionError(f"mma probe {name} launch failed")
        ms = time_ms(run, 3, 1)
        rates[name] = 2 * macs * 16 * iters * 16 * blocks / ms / 1e9
    return rates


def xnor_sass():
    """xnor_gemm's dynamic shared memory per variant and, where
    ``cuobjdump`` exists, the count of HMMA (tensor-core) instructions
    in its library: the kernel must have some."""
    import ctypes
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.xnor_gemm import TILES, X_DTYPES
    lib = _build._load("xnor_gemm")
    lib.xnor_gemm_smem_bytes.argtypes = [ctypes.c_int] * 3
    smem = {f"{bm}x{bn} {str(dt)[6:]}": lib.xnor_gemm_smem_bytes(bm, bn, code)
            for bm, bn in TILES for dt, code in X_DTYPES.items()}
    print(f"xnor_gemm dynamic shared memory per block, bytes: {smem}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("xnor_gemm: cuobjdump not found, HMMA count not read")
        return
    sass = subprocess.run([tool, "-sass", str(_build._lib_path("xnor_gemm"))],
                          capture_output=True, text=True, check=True).stdout
    hmma = sum("HMMA" in line for line in sass.splitlines())
    ffma = sum("FFMA" in line for line in sass.splitlines())
    print(f"xnor_gemm SASS: {hmma} HMMA, {ffma} FFMA instructions")
    if hmma == 0:
        raise AssertionError("xnor_gemm's library holds no HMMA")


def main():
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank_main(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    # phase 12 trains under deterministic algorithms, which needs cuBLAS's
    # workspace set before its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the matmul yardstick
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, parallel)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or (
                    src in ("xnor_gemm", "packed_conv")
                    and "Compiling entry" in line):
                print(f"ptxas {src}: {line.strip()}")
    xnor_sass()
    peak = mma_sync_ceilings()
    for name, rate in peak.items():
        _, _, dense, dense_name = MMA_KINDS[name]
        print(f"mma.sync {name} from registers: {rate:.1f} T ops/s "
              f"(2 x multiply-accumulates; {rate / (dense / 1e12):.3f} of "
              f"the dense {dense_name} rate)")

    rec = []
    rnd = Rand(1234, DEVICE)
    for phase in (check_pack, check_conv, check_fused, check_gemm,
                  check_xnor, check_entry_conv, check_residual,
                  check_bireal):
        first = len(rec)
        phase(rnd, rec)
        torch.cuda.synchronize()
        for r in rec[first:]:
            print(f"{r['name']}: held against its plain version "
                  f"(max_abs_err {r['max_abs_err']}); kernel_ms="
                  f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
                  f"{r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']})")

    from repro_torch.core.workloads import (alexnet_imagenet,
                                            binarynet_cifar10)
    launches = {}
    perf = forward_path("BinaryNet", binarynet_cifar10(),
                        BINARYNET_PER_FORWARD, 10, binarynet_vs_cpu, (1,),
                        launches, 0)
    alexnet = forward_path("AlexNet", alexnet_imagenet(),
                           ALEXNET_PER_FORWARD, 1000, alexnet_vs_cpu,
                           (1, 32), launches, 2)
    reactnet = reactnet_path(launches)
    bireal = bireal_path(launches)
    graphed = graphed_path(launches)
    served = serving_path(launches)
    stack_race = fused_vs_chained(rnd)
    dense = dense_path(rnd, launches)
    trained = train_path(launches)
    simulated = sim_path(launches)
    llm = llm_path(rnd, launches)
    llm_train, run_12b = llm_train_path(launches)
    faults = faults_tuning_audit_path(launches)
    twins = twins_dryrun_path(launches)
    meshed = mesh_path(launches)
    spmd = spmd_path(run_12b)
    del run_12b
    mesh_dry = mesh_dryrun_path()
    from repro_torch.trace import SESSIONS
    print(f"torch.profiler: {SESSIONS['opened']} sessions opened, "
          f"{SESSIONS['empty']} of them saw no device event and were "
          f"asked again")
    for r in rec:
        # launches on the main paths alone
        r["launches"] = launches.get(r["name"], 0)
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} never launched")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{k: r[k] for k in keys} for r in rec]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "kernels": kernels,
         **{f"{r['name']}_{part}": r[part] for r in rec
            for part in ("shapes", "sums") if part in r},
         "mma_sync_tops": peak,
         "binarynet": perf, "alexnet": alexnet, "reactnet": reactnet,
         "bireal": bireal,
         "binary_dense": dense,
         "graphed": graphed, "served": served,
         "fused_vs_chained_replayed": stack_race, "train": trained,
         "sim": simulated, "llm": llm, "llm_train": llm_train,
         "faults_tuning_audit": faults, "twins_dryrun": twins,
         "mesh": meshed, "spmd": spmd, "mesh_dryrun": mesh_dry,
         "profiler_sessions": SESSIONS,
         "device": device},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
