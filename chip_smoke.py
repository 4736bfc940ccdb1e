#!/usr/bin/env python3
"""Drive the PyTorch port (``mdgat_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run (exit code != 0) when it fails:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: ``nvcc`` compiles ``mdgat_tpu_torch/csrc/*.cu`` for sm_90a;
3. per-kernel parity on the card at the serving shapes, each kernel
   against its plain PyTorch twin on the same inputs: top-k / dense
   attention (B=64, H=4, N=M=256, Dh=32, k=128/64/dense, ragged masks, f32
   and bf16; and B=8, N=M=1024; then what its tiling makes risky: key
   counts 200 / 231 / 513, ragged query counts, head sizes 8-64, k = 1, k
   above the valid count, exact ties at the k-th value with thr bit-equal
   to the twin's, an all-masked batch entry, lse on and off), the GEMM and
   the whole eval layer at D=128, the Sinkhorn forward (64x256x256, the
   training step's 64x512x512, 8x1024x1024, 2x300x200, 20 iterations;
   4x512x512 and 2x1024x1024 at 100; no iteration) under its plan, each
   cluster size (2, 4, 8, 16), the other thread count and the other column
   form, bit-equal from run to run, then timed at the first three shapes
   under the plan and every cluster size x thread count x column form
   beside the clusters the card holds at once and the exp unit's floor;
   and shapes off that path (ragged N and M, odd GEMMs);
4. the serving path: the flagship MDGAT (L=9, D=128, default k-schedule,
   20 Sinkhorn iterations) with seeded weights behind
   ``Matcher(device="cuda")``: three ``match_batch`` calls of 64 ragged
   pairs of 200-256 keypoints and one ``register_batch``. The kernel launch
   counters are zeroed just before and read just after: every forward must
   launch the layer kernels 36 times and the Sinkhorn once. The matches
   must agree with the same Matcher run with ``use_kernels=False`` on the
   card on >= 99.9% of valid slots, and with the CPU path on a small batch;
5. times: CUDA-event times of each kernel and of the whole forward, for
   the kernel path and the plain path, beside the card's name and power
   limit (calls under 0.1 ms, the GEMM and dense attention beside
   ``torch.addmm`` and SDPA, are timed inside a CUDA graph, and the graph
   times say whether a kernel is slower than the library call; the
   attention kernel and the GEMM are timed so at the train shapes too);
   then a torch.profiler window over three kernel-path forwards (device time by
   kernel, the device's busy share);
6. per-kernel parity of the training kernels at the training shapes (B=64,
   N=M=512, D=128, 4 heads; k=128, k=64 and dense; ragged masks; self and
   cross) and at odd shapes, each against its plain twin under autograd on
   the card: the fused-MHA forward (out, thr, lse) and backward (all ten
   gradients, bit-equal from run to run, selection equal to the forward's
   on every row), every GEMM mode at aligned and odd shapes (the forward's q
   projection bit-equal to the backward's recomputation, through vector
   and guarded loads alike; the W^T mode
   timed beside ``torch.matmul(a, w.t())``; the A^T split-K product at the
   train step's two shapes, a ragged row count and odd shapes, bit-equal
   from run to run, timed in CUDA graphs beside ``torch.matmul(a.t(), b)``
   under its plan and other row splits), the two attention-backward kernels
   at 64 x 4 x 512 x 512 x 32 (k = 128, 64, dense) and 8 x 4 x 1024 x 1024
   x 32 (o, dq, dk, dv against the twin, bit-equal from run to run; each
   kernel's device time a launch from torch.profiler beside its bound, the
   keys kernel under both key tilings), the Sinkhorn replay backward (dZ,
   dalpha; also at 100 iterations, 4x512x512 and 2x1024x1024; its time at
   64x512x512 and 8x1024x1024 under its plan and each cluster size,
   bit-equal from run to run), and the
   whole-layer train kernels (h1, ssum, ssq, thr, lse, y, batch mean and
   variance; Sg, Sgh, dw2, db2, dscale, dbias; dx, dsrc and the fourteen
   parameter gradients with ragged key AND row masks and a cotangent that
   is non-zero on padded rows; bit-equal from run to run; one bfloat16
   case), the two dh2 launches of the BatchNorm backward (``tl_dh2_kernel``
   through ``bn_backward_sums`` and ``dh1_kernel``) against their twins at
   R = 32768 (f32 and bfloat16), an odd row count and D = 32 / 96,
   bit-equal from run to run, each timed by the profiler beside its bound
   and ``torch.matmul(g, w2.t())`` in a graph, the first-conv and dw2
   kernels (``tl_h1_kernel`` through ``h1_stats``, ``tl_dw2_kernel``
   through ``dw2_db2``) against their twins at R = 32768 (f32 and bfloat16),
   an odd row count with and without row mask, D = 32 / 96 and unaligned
   operands (the general forms), bit-equal from run to run, each timed by
   the profiler beside its previous design's time, its bound and its
   library call for the product, the second conv (``tl_fwd2_kernel``
   through ``bn_relu_conv2``) against ``bn_relu_conv2_reference`` at R =
   32768 (f32 and bfloat16), an odd row count, D = 32 / 96 and unaligned
   operands (the general form), bit-equal from run to run, every
   ``csrc/train_layer.cu`` kernel's ms a launch at the train shape, f32 and
   bfloat16 I/O, beside its bound and the library call for its product
   (``tl_fwd2_kernel`` also beside its previous design's time), and the
   gap-loss margin kernels (64x512x512, 8x1024x1024, 3x200x231, 2x1024x1024
   and pairs of one row or one column, ragged row and column masks and
   none, dustbin anchors, a cloud without a valid point: S0 / S1, the
   forward's counts exactly and, at random cotangents, dd / dbin_row /
   dbin_col bit-equal to the formula twins, the [B] loss and its
   gradients against ``ops/losses.gap_loss`` under autograd, bit-equal from
   run to run; the forward one kernel a call; their times and bounds, each
   beside its previous design's time and under each cluster size beside
   the clusters the card holds at once);
7. the training path: ``create_train_state`` with seeded weights and three
   steps of ``make_train_step`` on a synthetic batch of 64 pairs at 512
   keypoints, three arms, each with the launch counters zeroed just before
   and read just after. The default route (``train_layer=True``): 36
   whole-layer forwards and 36 backwards, no fused-MHA launch, 36
   attention-backward (rows + keys kernel) and 216 A^T GEMM launches, 1
   Sinkhorn forward and 1 backward per step. The fused-MHA route
   (``train_layer=False``): 36 fused-MHA forwards, 36 backwards (36
   attention-backward, 144 A^T GEMM launches), 1 and 1.
   The plain path (``use_kernels=False``): no launch. Losses and gradient
   norms of both kernel routes agree with the plain path, and four of the
   pairs on the card with the CPU; the loss is finite and falls; the peak
   memory of each arm; a torch.profiler window over one step of the
   default route (device time, busy share, and the step's device ms and
   launches of the rows, keys, A^T GEMM, Sinkhorn and train-layer kernels,
   the dh2 kernel's two instantiations apart); then times per
   kernel, per whole layer (the whole-layer backward at k = 128 and dense
   also in a CUDA graph) and per step (the arms in turns, a fourth with
   ``loss_kernel=True``);
8. the training entry point: a synthetic KITTI-layout dataset is written
   under ``chip_smoke_out/`` (9 sequences, 512 keypoints a frame, 64 pairs a
   sequence); the native keypoint loader builds, and two batches through it
   equal the numpy path's bit for bit; ``train_torch.main`` runs on it at
   full width on the disk path (batch 64, 512 keypoints, 2 epochs of 3
   steps, ``--loss_kernel true``, ``--memory_is_enough false``: the native
   loader must read batches), counters
   zeroed just before and read just after: per train step 36 whole-layer
   forwards, 36 backwards, 1 Sinkhorn forward, 1 backward, 1 gap-loss
   forward, 1 backward; per validation step 36 eval-layer calls, 1
   Sinkhorn, 1 gap-loss forward. The epoch loss is finite and falls, each
   epoch's checkpoint reads back (the last one equal to the final
   parameters), and the same run with ``--loss_kernel false`` launches no
   gap-loss kernel and logs the same losses within 2e-3; the loop's wall
   time per step is printed beside the bare step's.
9. the eval entry points: a synthetic KITTI-layout dataset whose test split
   holds 200 pairs (512 keypoints a frame, cut to the test preset's 256 by
   ``--ensure_kpts_num true``) and the checkpoint phase 8 saved;
   ``test_torch.main`` and ``test_registration_metric_torch.main`` at full
   width, batch 64 (three batches and a tail of 8, padded to 64), and
   ``test_torch.main --net superglue``, each with ``--use_kernels true``
   then ``false``, counters zeroed just before and read just after each
   run: per eval batch 36 layer calls, 216 GEMM, 36 attention and 1
   Sinkhorn launches and no other kernel (the plain runs none); the top-k
   of every layer call (superglue: all dense); match agreement
   between the two runs >= 99.9% of valid slots, and identical per-pair
   lines wherever a pair's matches are equal; the aggregate lines and each
   run's pairs/s by wall clock beside the serving phase's bare forward;
10. data-parallel training and multi-process eval: two ranks, subprocesses
   of this script over gloo sharing the card's one device (NCCL refuses two
   ranks on one device). Each rank trains on its 32 rows of the same three
   global batches of 64 pairs x 512 keypoints, from the same seeded
   weights, as a one-process kernel run in this process: loss and grad_norm
   of each step within the training tolerances of the one-process step,
   every parameter and running statistic ``torch.equal`` across the ranks
   after three steps, each rank's launch counts per step equal to the
   one-process step's, and per step exactly the collectives the step
   issues (``parallel.collective_counts``: one all-reduce each way per
   whole-layer call, two each way per plain BatchNorm call, one of the
   gradients, one of the loss); each rank's step ms beside the one-process
   step's (two ranks sharing one card: not a scaling figure) and the time
   of its all-reduces. Then ``train_torch.py`` as two ranks (1 epoch x 3
   steps: rank 0 alone writes the checkpoint, it loads, the losses are the
   train_cli phase's first epoch's), and ``test_torch.py`` and
   ``test_registration_metric_torch.py`` as two ranks over 256 pairs in
   batches of 64 (each rank's batches the one-process run's batches 1-2 or
   3-4: every pair's matches bit-equal, rank 0's aggregate lines equal to
   the one-process run's, rank 1's none).
11. context parallelism (the ``seq`` axis): the whole-layer train kernels
   against their twin at a seq member's shape (64 x 256 query rows against
   512 keys, ragged; half the query blocks, then every one, all padding);
   the flagship step as one data row of two seq ranks (each 256 of the 512
   keypoints of the same three global batches) and as 2 x 2 ranks (one
   step), subprocesses of this script over gloo on the one device, against
   phase 10's one-process steps within the training tolerances, every rank
   ``torch.equal``, launches per step equal to one process's, collectives
   exact (phase 10's, plus one input gather, one key gather a GNN layer
   each way, one tail gather each way), each rank's step ms and the time
   of its gathers; one step of the fused-MHA route (``train_layer=False``)
   as 1 x 2 seq ranks against the same step in one process; the eval forward at 64 x 256 as two seq ranks against
   one process (agreement >= 99.9%, matching scores within 1e-5 where the
   matches agree, and whether the outputs are bit-equal); then
   ``train_torch.py``, ``test_torch.py`` and
   ``test_registration_metric_torch.py`` with ``--seq_parallel 2`` as two
   ranks (the train losses the train_cli phase's first epoch's; rank 0's
   aggregate lines phase 10's one-process lines, rank 0 recording every
   pair and rank 1 none).
12. wide clouds (more than 1024 keypoints): every wide arm against its twin
   at 1025, 1500 and 4096 keys or columns with ragged masks: the attention
   forward (k = 128, 64, dense; lse; exact scores with thr equal to the
   twin's bit for bit; an all-masked entry; the slab in its global scratch
   at 6000 and 8192 keys), the attention backward (o, dq, dk, dv) and the
   fused-MHA forward and backward under autograd at 2 x 1500 (the rebuilt
   attention output equal to the forward's on every row), the Sinkhorn
   forward and backward (20 and 100 iterations), the gap-loss kernels (also
   at 20000 rows), every arm bit-equal from run to run, each timed at 2 x
   1500 x 1500 beside its twin and its bound; ``Matcher(device="cuda")
   .match`` on pairs of 1025 and 1500 keypoints against ``use_kernels=
   False`` (match agreement, matching scores) and one default-route
   training step of 2 pairs x 1500 keypoints against the plain route
   (loss, grad_norm), each with the counters zeroed just before and read
   just after (36 layers and 1 Sinkhorn a forward; 36 whole-layer forwards
   and backwards, 36 attention backwards, 1 + 1 Sinkhorn a step).
13. descriptors: the learned-descriptor modes and the FPFH variants at the
   published widths (D=128, 4 heads, L=9, the default k-schedule, 20
   Sinkhorn iterations, the reference's SSG / MSG radii, samples and
   channels) on raw clouds of 16384 x 8 points around the keypoints: the
   single-scale encoder's training (``train_step`` 3, 64 pairs x 512
   keypoints, three steps on the kernel route with ``loss_kernel`` and on
   the plain route in turns; loss and grad_norm within the training
   tolerances, the loss falls); the multi-scale encoder's staged training
   (``train_step`` 1, 2, 3, one step each at 16 pairs x 512: the batch cut
   for memory; step 1 no GNN and so no layer launch, step 2 no encoder
   gradient); the multi-scale, ``FPFH_only`` and ``FPFH_gloabal`` eval
   forwards at 64 x 256, kernels against plain (agreement >= 99.9%; the
   encoder's device ms beside the forward's); then ``train_torch.main``,
   ``test_torch.main`` and ``test_registration_metric_torch.main`` with
   ``--descriptor pointnetmsg`` on a synthetic tree with clouds of 4 x 512
   points. Counters zeroed just before and read just after each run: every
   train step launches what the training phase's FPFH step does (plus the
   gap-loss pair), every eval forward 36 / 216 / 36 / 1 and nothing else.
   Step ms, peak memory and the phase's wall time beside the card.
14. fast_topk: the attention kernel's fast arm (the JAX package's value
   bisection, the kernel routes' default; every phase above pins the
   exact arm, ``exact_topk=True`` / ``--pallas_exact_topk true``, since it
   holds the kernels against the exact plain route). At each call site,
   f32 and bf16: the kernel alone at 64 x 4 x 256 x 256 (k = 128, 64), at
   512 / 513 / 1024 / 1025 keys, k above the valid count and the wide arm
   at 2 x 4 x 1500 x 1500; the eval layer at 64 x 256 x 128; the fused-MHA
   forward and the whole-layer train forward at 64 x 512 x 128: thr
   ``torch.equal`` to ``ops/attention.py::fast_threshold`` on the kernel's
   own scores (the fmaf chain replayed bit for bit), at the resolution of
   the caller's input dtype, the output and lse within tolerance of the
   twin on those scores; the fused-MHA and the train-layer backward checks
   on fast residuals; both arms' ms a launch in turns, by events and in a
   CUDA graph, at the serving (k = 128, 64) and the train shape; the
   default serving forward (launches the exact route's, outputs checked,
   its time beside the exact arm's) and three default training steps
   (launches the exact route's, loss and grad_norm beside it); and
   ``tools/torch_topk_agreement.py`` at 4 batches of 64 pairs, seeded
   weights and the eval_cli phase's matching checkpoint.
15. matcher_mesh: one process serving over a grid of replicas, one thread
   and one stream a replica (``Matcher(data_parallel=N, seq_parallel=M)``,
   ``parallel/smap.py::make_eval_runtime``): the flagship model with seeded
   weights and the default (fast) arm, as 2 x 1, 1 x 2 and 2 x 2 grids
   whose cells share the card (``devices=[cuda:0] * N * M``), and 2 x 1 on
   two cards where the machine has them. On 64 and 63 pairs of 200-256
   keypoints (the second fills a row): every output ``np.array_equal`` to
   one device's ``Matcher`` on the same weights; counters zeroed just
   before and read just after each call: N * M times one forward's
   launches (36 / 216 / 36 / 1) and nothing else, and under a seq axis
   exactly N * M input gathers, 18 N * M key gathers and N * M tail gathers
   (none without one); a seq member made to raise fails the call at once,
   well inside the barrier's timeout, and leaves no thread; then
   ``match_batch`` of 64 pairs by CUDA events, one device and each grid in
   turns, and the 2 x 1 grid's two forwards enqueued in turn from one
   thread (no gain is claimed: the cells share one card).
16. cuda_graphs: the JAX package's compiled programs, as CUDA graphs
   captured once per shape bucket and replayed (``utils/graphs.py``).
   Every phase above runs eagerly (``graphs.disabled()``, also in the rank
   subprocesses): they count launches per call and time eager calls. The
   flagship model at its defaults (the fast arm): three train steps of 64
   pairs x 512 keypoints on three batches, f32 and then bfloat16, eagerly
   and through the graph cache from one seed, both with the capturable
   Adam: loss, grad_norm, every parameter, gradient, BN buffer and Adam
   moment ``torch.equal``; the graph arm's launches one eager step's at its
   warm-up and at its capture, none at its replay; step ms in turns and
   peak bytes, at f32 also device ms and busy share by torch.profiler; the
   same checks, untimed, with ``loss_kernel=True`` (the gap-loss pair) and
   on the fused-MHA route at the exact arm, so that every kernel of the
   slice runs inside a graph. The captured eval step after replayed
   updates equal to the eager one (the weights folded inside the graph).
   ``Matcher`` with graphs against ``cuda_graphs=False``, one device and a
   2 x 1 grid sharing the card, 64 and 63 pairs three times each:
   ``np.array_equal``, launches at warm-up and capture only;
   ``match_batch`` and forward ms in turns, busy shares.
   ``train_torch.main`` (2 epochs x 3 steps) and both eval CLIs (200
   pairs) with graphs and eagerly: equal losses and per-pair results, ms a
   step and ms a batch after the first. ``python3 chip_smoke.py --only
   cuda_graphs`` runs this phase alone (it writes the trees it needs) and
   prints no result line.
17. LightGlue (``models/lightglue.py``, ``csrc/lightglue.cu``) at its
   serving cell's shapes (16 pairs, 4 heads of 64, 2048 x 1900 keypoints,
   75-100% valid): the self-attention, the two-way cross-attention (m0 and
   m1), LayerNorm + GELU and the assignment-and-decision kernels, each
   against its float64 twin on the same inputs (``TOL["lg_*"]``) and
   bit-equal from run to run, each timed beside its plain twin, SDPA or
   ``F.layer_norm`` + ``F.gelu`` and its bound; then ``Matcher(net=
   "lightglue")`` on the benchmark's seeded weights: one eager call with
   the counters zeroed just before (each kernel's launches a forward,
   every other kernel none), the captured graph at 2048 keypoints (its
   replays launch nothing and equal the eager call), the plain route's
   matches, ms a call. ``python3 chip_smoke.py --only lightglue`` runs
   this phase alone and prints no result line.

The line before the last is a JSON object with one entry per kernel (its
time beside the plain twin's, the card's bound for the same work and, where
one PyTorch call computes the same function, that call's time); the
last line is ``{"ok": true, "device": {...}}``. Full results also go to
``chip_smoke_out/chip_smoke.json``, with ``ptxas.log`` and ``profile.txt``.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

# Tolerances of kernel vs plain twin on the card, same inputs. f32: both
# sides keep f32 internals; sums run in other orders (sequential FMA in the
# kernels, blocked reductions in torch), which moves results by ~1e-6
# relative. bf16: the output is rounded to bf16 once (about 3 significant
# digits), the internals are f32 on both sides.
TOL = {"attention_f32": 1e-4, "attention_bf16": 2e-2, "layer_f32": 1e-3,
       "layer_bf16": 1e-1, "gemm_f32": 1e-4, "gemm_bf16_rel": 1e-2,
       "sinkhorn_f32": 1e-4,
       # fused MHA: out, thr, lse absolute; a gradient's error is taken
       # relative to max(1, its largest entry): the weight gradients sum
       # 32768 rows in f32, in another order than torch does
       "mha_out": 1e-4, "mha_grad": 1e-4,
       # forward attention output against the one the backward rebuilds
       # from thr and lse (every row): rounding only, no flipped entry
       "mha_selection_gap": 1e-4,
       # Sinkhorn backward: dZ relative to max(1, largest entry), dalpha
       # relative; 20 iterations replayed and reversed in f32
       "sinkhorn_bwd": 1e-4,
       # whole-layer train kernels: thr, lse, batch mean and variance
       # absolute; y, h1 (f32 sums of 256 products of O(1) terms), ssum /
       # ssq, the six outputs of bwd1 and the gradients relative to max(1,
       # largest entry): sums of 32768 rows in f32, per
       # block of 64 rows and then block after block in the kernels, in
       # torch's own blocked order in the twin
       "train_layer_out": 1e-4, "train_layer_grad": 1e-4,
       # bfloat16: y and h1 are rounded to bf16 once (2^-8 relative, entries
       # up to ~10), and a stored h1 that rounds the other way on one side
       # can flip the ReLU mask of an entry near zero, which moves that row
       # of dx by one product term; relative to the largest entry
       # (the four exactly-zero bias gradients are not compared in bf16:
       # one such flip moves an entry of theirs by that row's whole term)
       "train_layer_out_bf16": 2e-2, "train_layer_grad_bf16": 5e-2,
       # the gradients of bk, bv, bm and b1 are zero in exact arithmetic (a
       # constant added to the keys leaves the softmax as it is, one added
       # to v, the message or h1 is taken out again by the batch mean), so
       # what either side returns is the f32 rounding of a column sum over
       # 32768 rows of O(1) terms that cancel: absolute, where the other
       # parameter gradients have entries of 10 to 1000
       "train_layer_zero_grad": 5e-3,
       # train steps, kernel path against plain path on the card and
       # against the CPU: relative. The two paths keep different f32 sums
       # through 18 layers forward and backward, near-tie rows may select
       # differently, and from the second step on the weights differ by
       # Adam's noise steps (at most lr on entries whose gradient is zero
       # in exact arithmetic)
       "train_loss_rel": 2e-3, "train_grad_norm_rel": 2e-2,
       # gap-loss margins: S0 / S1 are f32 sums of up to 1025 margins, lane
       # by lane and tile by tile in the kernel, in torch's blocked order in
       # the twin; elementwise relative to max(1, |twin|)
       "gap_margins": 5e-6,
       # at the same cotangents the kernel and its twin form every indicator
       # from the same f32 expression and the counts are exact, so dd,
       # dbin_row and dbin_col differ by rounding of one product and one
       # sum at most; relative to max(1, largest entry)
       "gap_cotangent": 1e-6,
       # the whole loss against ops/losses.gap_loss under autograd: the [B]
       # loss relative; its gradients absolute (entries are at most ~2 / N
       # times the anchor's count of active margins)
       "gap_loss": 2e-6, "gap_loss_grad": 2e-6,
       # eval forwards, kernel route against plain: the largest difference
       # of the [B, N+1, M+1] transport as probabilities (exp of the log
       # transport), as the wide serving check holds the matching scores
       "transport_prob": 1e-3,
       # LightGlue's attention kernels against their float64 twin on the
       # same float32 inputs, relative to the largest entry: f32 sums over
       # up to 2048 keys (and the online softmax's rescaling) in another
       # order; the f32 twin itself reads about 2e-6 there
       "lg_attention": 1e-5,
       # LayerNorm + GELU: a 512-wide mean and variance in f32, relative
       "lg_ln_gelu": 1e-6,
       # the assignment, read as the benchmark reads the program's answers
       # (architectures/lightglue.py::match_readings) against the float64
       # twin's inner block: an answered entry's gap to the best of its row
       # and column, an answered score's error (a probability), and how
       # clear the twin's decision was where the two disagree on matched
       # or not (only a near tie may differ)
       "lg_match_gap": 1e-5, "lg_score": 1e-5, "lg_decide": 1e-4}
# published peaks of one H100 SXM (dense, no sparsity): f32 outside the
# tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Query rows whose k-th and (k+1)-th valid scores lie within this gap are
# near ties: the two sides may keep different sets there, legitimately,
# because the score sums run in other orders. They are counted and left
# out of the attention and layer comparisons.
TIE_GAP = 1e-5
MIN_AGREEMENT = 0.999
# The phases before fast_topk hold the kernel routes against the plain
# route, which selects the exact top-k: they pin the kernels' exact arm
# (Config.exact_topk, the CLIs' --pallas_exact_topk). The default route,
# the fast arm, is the fast_topk phase's.
EXACT = dict(exact_topk=True)
EXACT_ARGV = ["--pallas_exact_topk", "true"]


def require(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


class Counter:
    """A wrapper's launch count: an integer attribute of the wrapper."""

    def __init__(self, wrapper, attr: str = "launches"):
        self.wrapper, self.attr = wrapper, attr

    def reset(self):
        setattr(self.wrapper, self.attr, 0)

    def read(self) -> int:
        return getattr(self.wrapper, self.attr)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph and replayed, so that no host work separates the launches.
    For calls so short (about 0.1 ms) that a host loop would leave the card
    idle between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # first use off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=replays, warmup=1) / reps


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take:
    each input read once and each output written once at the HBM rate, or
    the f32 operations at the FMA peak, whichever is longer."""
    t_b, t_f = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def turns_ms(fns, reps: int, warmup: int = 1):
    """The better of two turns of each function, taken in the order first
    to last, then last to first."""
    order = list(fns) + list(reversed(fns))
    ms = [cuda_ms(fn, reps, warmup) for fn in order]
    n = len(fns)
    return [min(ms[i], ms[2 * n - 1 - i]) for i in range(n)]


def abba_ms(kernel_fn, plain_fn, reps: int, warmup: int = 1):
    """(kernel ms, plain ms), the better of two turns each, taken in the
    order plain, kernel, kernel, plain."""
    plain, kernel = turns_ms([plain_fn, kernel_fn], reps, warmup)
    return kernel, plain


def near_tie_rows(s, valid, k: int):
    """[..., N] bool: rows whose k-th and (k+1)-th valid scores are within
    TIE_GAP (s [..., N, M] f32 scores, valid [..., N, M])."""
    import torch
    if not k or k >= s.shape[-1]:
        return torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)
    top = torch.where(valid, s, torch.full_like(s, -1e30)).topk(k + 1, dim=-1).values
    return (top[..., k - 1] - top[..., k]) < TIE_GAP


def ragged_mask(rng, b, m, lo, device):
    import torch
    counts = rng.integers(lo, m + 1, size=b)
    counts[0] = m                                   # one full row
    mask = np.arange(m)[None, :] < counts[:, None]
    return torch.from_numpy(mask).to(device)


# ---------------------------------------------------------------------------
# phase 3: per-kernel parity
# ---------------------------------------------------------------------------

def check_attention(rng, dev, report):
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    worst = 0.0
    cases = [(64, 256, k, dt) for k in (128, 64, 0)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, k, torch.float32) for k in (128, 0)]
    for b, n, k, dt in cases:
        h, dh = 4, 32
        q, kk, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh))
                                     .astype(np.float32)).to(dev, dt)
                    for _ in range(3))
        mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
        o, thr = A.topk_attention(q, kk, v, mask, k, dh ** -0.5)
        o_ref, thr_ref = A.topk_attention_reference(q, kk, v, mask, k,
                                                    dh ** -0.5)
        torch.cuda.synchronize()
        s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * dh ** -0.5
        valid = mask[:, None, None, :].expand(s.shape)
        tie = near_tie_rows(s, valid, k)
        keep = ~tie
        err = (o.float() - o_ref.float()).abs().amax(-1)[keep].max().item()
        terr = (thr - thr_ref).abs()[..., 0][keep].max().item()
        tol = TOL["attention_f32" if dt == torch.float32 else "attention_bf16"]
        name = f"attention b{b} n{n} k{k} {str(dt)[6:]}"
        print(f"{name}: max|o-o_ref| {err:.3e} max|thr-thr_ref| {terr:.3e} "
              f"tol {tol:g}; near-tie rows left out {int(tie.sum())} of "
              f"{tie.numel()}")
        require(torch.isfinite(o.float()).all().item(), f"{name}: non-finite")
        require(err <= tol and terr <= TOL["attention_f32"], f"{name} disagrees")
        if dt == torch.float32:
            worst = max(worst, err)
    report["topk_attention"]["max_abs_err"] = worst


def check_attention_edges(rng, dev):
    """What the tiled attention kernel makes risky: key counts off the
    256-key tile and the 32-key chunk, query counts off the row tile, every
    head size, k = 1, k above the valid count, exact ties at the k-th value
    (integer-valued q and k with a power-of-two scale make every score exact
    on both sides: all ties kept, thr equal bit for bit, no row left out),
    an all-masked batch entry, bf16 I/O, and the lse output on and off."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # b, h, n, m, dh, k, dtype, kind
        (3, 2, 37, 200, 32, 64, f32, ""), (2, 2, 70, 231, 32, 128, f32, ""),
        (2, 1, 100, 513, 32, 64, f32, ""), (2, 1, 33, 513, 32, 0, f32, ""),
        (3, 2, 37, 45, 8, 8, f32, ""), (3, 2, 37, 45, 16, 5, f32, ""),
        (2, 2, 37, 300, 64, 16, f32, ""), (2, 1, 20, 1000, 64, 0, f32, ""),
        (2, 2, 50, 120, 32, 1, f32, "k=1"),
        (2, 2, 50, 120, 32, 119, f32, "k above the valid count"),
        (2, 2, 70, 231, 16, 64, f32, "ties"), (2, 2, 33, 513, 64, 128, f32, "ties"),
        (2, 2, 40, 100, 16, 0, f32, "ties"),
        (3, 2, 37, 200, 32, 64, f32, "all-masked entry"),
        (3, 2, 37, 200, 32, 0, f32, "all-masked entry"),
        (2, 2, 70, 231, 32, 64, bf16, ""), (2, 1, 33, 513, 32, 0, bf16, ""),
        (2, 2, 37, 45, 8, 8, bf16, "")]
    for b, h, n, m, dh, k, dt, kind in cases:
        def t(*shape):
            x = rng.normal(size=shape)
            if kind == "ties":
                x = np.clip(np.round(x), -2, 2)
            return torch.from_numpy(x.astype(np.float32)).to(dev, dt)
        q, kk, v = t(b, h, n, dh), t(b, h, m, dh), t(b, h, m, dh)
        mask = ragged_mask(rng, b, m, m // 2, dev)
        if kind == "all-masked entry":
            mask[b - 1] = False
        scale = dh ** -0.5            # a power of two at dh 16 and 64
        o, thr, lse = A.topk_attention(q, kk, v, mask, k, scale, return_lse=True)
        o2, thr2 = A.topk_attention(q, kk, v, mask, k, scale)
        o_ref, thr_ref, lse_ref = A.topk_attention_reference(
            q, kk, v, mask, k, scale, return_lse=True)
        torch.cuda.synchronize()
        name = (f"attention edge {b}x{h}x{n}x{m} dh{dh} k{k} {str(dt)[6:]}"
                f"{' ' + kind if kind else ''}")
        require(torch.equal(o, o2) and torch.equal(thr, thr2),
                f"{name}: the lse output changes the result")
        require(torch.isfinite(o.float()).all().item(), f"{name}: non-finite")
        s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * scale
        valid = mask[:, None, None, :].expand(s.shape)
        if kind == "ties":
            require(torch.equal(thr, thr_ref),
                    f"{name}: thr differs from the k-th value")
            keep = torch.ones(s.shape[:-1], dtype=torch.bool, device=dev)
        else:   # a row with no more than k valid keys keeps them all: no tie
            keep = ~(near_tie_rows(s, valid, k) & (valid.sum(-1) > k))
        if kind == "all-masked entry":
            require(not o[b - 1].any().item()
                    and (lse[b - 1] == -1e30).all().item()
                    and (thr[b - 1] == (1e30 if k else -1e30)).all().item(),
                    f"{name}: all-masked rows")
        err = (o.float() - o_ref.float()).abs().amax(-1)[keep].max().item()
        terr = (thr - thr_ref).abs()[..., 0][keep].max().item()
        lerr = ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0))[..., 0][keep].max().item()
        tol = TOL["attention_f32" if dt == f32 else "attention_bf16"]
        print(f"{name}: max|o-o_ref| {err:.3e} max|thr-thr_ref| {terr:.3e} "
              f"lse rel {lerr:.3e} tol {tol:g}; rows left out "
              f"{int((~keep).sum())} of {keep.numel()}; lse on/off bit-equal")
        require(err <= tol and terr <= TOL["attention_f32"]
                and lerr <= TOL["attention_f32"], f"{name} disagrees")


def _random_layer(seed, dev, d=128, heads=4):
    import torch
    from mdgat_tpu_torch.models.gnn import AttentionalPropagation
    layer = AttentionalPropagation(d, heads, dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # non-trivial BN so the fold is exercised
        bn = layer.mlp[1]
        bn.running_mean.copy_(torch.randn(2 * d, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(2 * d, generator=g) + 0.5)
        bn.weight.copy_(torch.rand(2 * d, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(2 * d, generator=g) * 0.2)
        layer.mlp[3].bias.copy_(torch.randn(d, generator=g) * 0.1)
    return layer.to(dev).eval()


def check_layer(rng, dev, report):
    import torch
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    layer = _random_layer(5, dev)
    w = layer.kernel_weights()
    worst = 0.0
    for k, dt in ((128, torch.float32), (0, torch.float32),
                  (64, torch.bfloat16)):
        b, n, m, d = 64, 256, 256, 128
        x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev, dt)
        src = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32)).to(dev, dt)
        mask = ragged_mask(rng, b, m, 200, dev)
        y = Lk.fused_layer(x, src, mask, k, w)
        y_ref = Lk.fused_layer_reference(x, src, mask, k, w)
        torch.cuda.synchronize()
        q = (x.float() @ w.wq + w.bq).reshape(b, n, 4, 32).transpose(1, 2)
        kk = (src.float() @ w.wk + w.bk).reshape(b, m, 4, 32).transpose(1, 2)
        s = q @ kk.transpose(-1, -2)
        tie = near_tie_rows(s, mask[:, None, None, :].expand(s.shape), k).any(1)
        err = (y.float() - y_ref.float()).abs().amax(-1)[~tie].max().item()
        tol = TOL["layer_f32" if dt == torch.float32 else "layer_bf16"]
        name = f"layer d128 b{b} n{n} k{k} {str(dt)[6:]}"
        print(f"{name}: max|y-y_ref| {err:.3e} tol {tol:g}; near-tie rows "
              f"left out {int(tie.sum())} of {tie.numel()}")
        require(y.dtype == dt and y.shape == x.shape, f"{name}: dtype/shape")
        require(torch.isfinite(y.float()).all().item(), f"{name}: non-finite")
        require(err <= tol, f"{name} disagrees")
        if dt == torch.float32:
            worst = max(worst, err)
    report["eval_layer"]["max_abs_err"] = worst

    # the GEMM alone at the layer's largest product, against torch
    x = torch.from_numpy(rng.normal(size=(64 * 256, 256)).astype(np.float32)).to(dev)
    h = Lk.gemm(x, w.w1, w.b1, relu=True)
    h_ref = torch.relu(x @ w.w1 + w.b1)
    err = (h - h_ref).abs().max().item()
    print(f"gemm 16384x256x256 relu: max|h-h_ref| {err:.3e} tol {TOL['gemm_f32']:g}")
    require(err <= TOL["gemm_f32"], "gemm disagrees")
    report["gemm"]["max_abs_err"] = err


def check_ragged(rng, dev):
    """Shapes off the serving path: ragged query and key counts, every head
    size the attention kernel takes, the wider-row kernel variants, odd
    GEMM sizes with both A operands and a bf16 output."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dt)

    worst = {}
    for b, h, n, m, dh, k in ((3, 4, 37, 45, 8, 8), (3, 4, 37, 45, 16, 0),
                              (3, 2, 37, 45, 32, 8), (3, 2, 37, 45, 64, 8),
                              (2, 2, 300, 300, 32, 128), (2, 4, 70, 700, 32, 64)):
        q, kk, v = t(b, h, n, dh), t(b, h, m, dh), t(b, h, m, dh)
        mask = ragged_mask(rng, b, m, m // 2, dev)
        o, thr = A.topk_attention(q, kk, v, mask, k, dh ** -0.5)
        o_ref, thr_ref = A.topk_attention_reference(q, kk, v, mask, k, dh ** -0.5)
        s = torch.matmul(q, kk.transpose(-1, -2)) * dh ** -0.5
        keep = ~near_tie_rows(s, mask[:, None, None, :].expand(s.shape), k)
        err = max((o - o_ref).abs().amax(-1)[keep].max().item(),
                  (thr - thr_ref).abs()[..., 0][keep].max().item())
        worst[f"attention {b}x{h}x{n}x{m} dh{dh} k{k}"] = (err, TOL["attention_f32"])
    for d, heads, n, m, k, dt in ((32, 4, 37, 45, 8, torch.float32),
                                  (32, 4, 37, 45, None, torch.float32),
                                  (256, 4, 33, 50, 16, torch.bfloat16)):
        w = _random_layer(11, dev, d, heads).kernel_weights()
        x, src = t(3, n, d, dt=dt), t(3, m, d, dt=dt)
        mask = ragged_mask(rng, 3, m, m // 2, dev)
        y = Lk.fused_layer(x, src, mask, k, w)
        y_ref = Lk.fused_layer_reference(x, src, mask, k, w)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = TOL["layer_f32" if dt == torch.float32 else "layer_bf16"]
        worst[f"layer d{d} {n}x{m} k{k} {str(dt)[6:]}"] = (err, tol)
    a1, a2, w, bias = t(111, 45), t(111, 13), t(58, 70), t(70)
    res = t(111, 70, dt=torch.bfloat16)
    y = Lk.gemm(a1, w, bias, a2=a2, relu=True, res=res, out_dtype=torch.bfloat16)
    y_ref = res.float() + torch.relu(torch.cat([a1, a2], 1) @ w + bias)
    # bf16 output: one rounding, relative 2^-8 at most
    worst["gemm 111x58x70 two A, relu, residual, bf16 out (relative)"] = (
        ((y.float() - y_ref).abs() / y_ref.abs().clamp_min(1.0)).max().item(),
        TOL["gemm_bf16_rel"])
    for b, n, m in ((3, 37, 45), (2, 100, 300), (2, 50, 1000)):
        scores = t(b, n, m)
        rm, cm = ragged_mask(rng, b, n, n // 2, dev), ragged_mask(rng, b, m, m // 2, dev)
        ot = S.log_optimal_transport_kernel(scores, 0.7, 20, rm, cm)
        ref = S.log_optimal_transport_reference(scores, 0.7, 20, rm, cm)
        vb = rm[:, :, None] & cm[:, None, :]
        worst[f"sinkhorn {b}x{n}x{m}"] = (max(
            (ot.dense - ref.dense).abs()[vb].max().item(),
            (ot.bin_row - ref.bin_row).abs()[cm].max().item(),
            (ot.bin_col - ref.bin_col).abs()[rm].max().item(),
            (ot.corner - ref.corner).abs().max().item()), TOL["sinkhorn_f32"])
    torch.cuda.synchronize()
    for name, (err, tol) in worst.items():
        print(f"ragged {name}: max err {err:.3e} tol {tol:g}")
        require(err <= tol, f"ragged {name} disagrees")


def _sinkhorn_errs(ot, ref, rm, cm):
    """(max abs errors of dense / bin_row / bin_col / corner on the valid
    block, whether the padding kept the sentinel)."""
    vb = rm[:, :, None] & cm[:, None, :]
    errs = [(ot.dense - ref.dense).abs()[vb].max().item(),
            (ot.bin_row - ref.bin_row).abs()[cm].max().item(),
            (ot.bin_col - ref.bin_col).abs()[rm].max().item(),
            (ot.corner - ref.corner).abs().max().item()]
    return errs, bool((ot.dense[~vb] < -1e29).all())


# the forward's cluster sizes the sweeps ask for besides the plan's
SINKHORN_CLUSTERS = (2, 4, 8, 16)
SINKHORN_CONFIGS = [("plan", 0)] + [(f"G={c}", c) for c in SINKHORN_CLUSTERS]


def check_sinkhorn(rng, dev, report):
    """The forward against its twin (1e-4 absolute on the valid block, the
    padding at the sentinel) at the serving shape 64x256x256 (ragged), the
    train shape 64x512x512, 8x1024x1024, two N != M shapes (the second
    with 512 < M < 1024, where a CTA has threads past its columns), 100
    iterations at 4x512x512 and 2x1024x1024 and no iteration, through the
    entry (``log_optimal_transport_kernel``), and by launch under the plan
    and under each cluster size, every launch twice, bit-equal. The error
    reported is the largest over every shape and every launch."""
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    worst = 0.0
    for b, n, m, iters, lo in ((64, 256, 256, 20, 0.78), (64, 512, 512, 20, 0.78),
                               (8, 1024, 1024, 20, 0.78), (2, 300, 200, 20, 0.5),
                               (2, 200, 700, 20, 0.78),
                               (4, 512, 512, 100, 0.78), (2, 1024, 1024, 100, 0.78),
                               (3, 200, 231, 0, 0.5)):
        scores = torch.from_numpy(rng.normal(size=(b, n, m)).astype(np.float32)).to(dev)
        rm = ragged_mask(rng, b, n, int(lo * n), dev)
        cm = ragged_mask(rng, b, m, int(lo * m), dev)
        ref = S.log_optimal_transport_reference(scores, 1.0, iters, rm, cm)
        name = f"sinkhorn {b}x{n}x{m} {iters} it"
        ot = S.log_optimal_transport_kernel(scores, 1.0, iters, rm, cm)
        errs, pad_ok = _sinkhorn_errs(ot, ref, rm, cm)
        require(pad_ok, f"{name}: padding leaked")
        require(max(errs) <= TOL["sinkhorn_f32"], f"{name} disagrees")
        worst = max(worst, max(errs))
        scalars, lmu, lnu = S._prep(scores, torch.tensor(1.0, device=dev), rm, cm)
        line = []
        for label, g in SINKHORN_CONFIGS:
            run = lambda: S._forward(scores, scalars, lmu, lnu, iters, g)
            first, again = run(), run()
            torch.cuda.synchronize()
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"{name} ({label}) differs from run to run")
            e, pad_ok = _sinkhorn_errs(first, ref, rm, cm)
            require(pad_ok, f"{name} ({label}): padding leaked")
            require(max(e) <= TOL["sinkhorn_f32"], f"{name} ({label}) disagrees: "
                    + " ".join(f"{x:.3e}" for x in e))
            line.append(f"{label} {max(e):.2e}")
            worst = max(worst, max(e))
        print(f"{name}: entry max err dense/bin_row/bin_col/corner "
              f"{' '.join(f'{e:.3e}' for e in errs)}; by launch "
              + ", ".join(line) + f" (tol {TOL['sinkhorn_f32']:g}, each "
              f"bit-equal over two runs)")
    report["sinkhorn"]["max_abs_err"] = worst


# the previous design's times (this script on one H100 80GB HBM3 at 700 W,
# one block a pair, ms by events, 20 iterations, ragged masks)
SINKHORN_FWD_BEFORE_MS = {"64x256x256": 1.3583, "64x512x512": 5.9724,
                          "8x1024x1024": 19.7984}


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sinkhorn_fwd_sweep(rng, dev, report, card):
    """The forward alone (one launch by events, 20 iterations, ragged masks)
    at 64x256x256, 64x512x512 and 8x1024x1024: under the plan and under
    every cluster size, each beside how many such clusters the card holds
    at once; with the bounds: bytes (Z in,
    dense out), f32 operations, and the exp unit's floor (an expf an entry
    in the row pass and one in the column pass, 16 a clock an SM at the
    card's top SM clock)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    clock = sm_clock_hz()
    out = {}
    for b, n in ((64, 256), (64, 512), (8, 1024)):
        key = f"{b}x{n}x{n}"
        scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
        mask = ragged_mask(rng, b, n, n * 25 // 32, dev)
        scalars, lmu, lnu = S._prep(scores, torch.tensor(1.0, device=dev), mask, mask)
        plan = S.sinkhorn_plan(b, n, n)
        times = {"plan": cuda_ms(lambda: S._forward(scores, scalars, lmu, lnu, 20),
                                 reps=10, warmup=2)}
        waves = {}
        for label, g in SINKHORN_CONFIGS[1:]:
            times[label] = cuda_ms(lambda: S._forward(scores, scalars, lmu, lnu, 20, g),
                                   reps=10, warmup=2)
            waves[label] = S.active_clusters(n, n, g)
        valid = (mask.sum(1).float() ** 2).sum().item()
        entries = (mask.sum(1).float() + 1).pow(2).sum().item()   # with the bins
        nbytes, flops = 2 * 4.0 * b * n * n, 20 * 2 * 5.0 * valid
        bms, by = bound(nbytes, flops)
        exp_floor = 20 * 2 * entries / (16 * 132 * clock) * 1e3
        best = min(times, key=times.get)
        print(f"sinkhorn forward {key} 20 it on {card}, one launch by events: "
              f"plan (G={plan[0]}, {'resident' if plan[1] else 'streamed'}) "
              f"{times['plan']:.4f} ms (before {SINKHORN_FWD_BEFORE_MS[key]:.4f}); "
              f"bound {bms:.4f} ({by}), exp-unit floor {exp_floor:.4f}; "
              f"fastest {best} {times[best]:.4f}")
        print("  " + "; ".join(f"{k} {v:.4f} ({waves[k]} clusters at once)"
                               for k, v in times.items() if k != "plan"))
        out[key] = dict(times=times, active_clusters=waves, plan=list(plan),
                        bound_ms=bms, bound_by=by, exp_floor_ms=exp_floor,
                        before_ms=SINKHORN_FWD_BEFORE_MS[key])
    report["_sinkhorn_fwd_sweep"] = out


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

def make_pairs(rng, count, lo=200, hi=256):
    """Ragged pairs: cloud 1 is a rigidly moved, noisy subset of cloud 0
    plus fresh points; FPFH-like non-negative 33-d descriptors."""
    pairs = []
    for _ in range(count):
        n0, n1 = rng.integers(lo, hi + 1, size=2)
        kp0 = rng.uniform(-30, 30, size=(n0, 3))
        desc0 = np.abs(rng.normal(size=(n0, 33)))
        shared = int(0.7 * min(n0, n1))
        th = rng.uniform(-0.3, 0.3)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                      [0, 0, 1]])
        kp1 = np.concatenate([kp0[:shared] @ R.T + rng.normal(size=3),
                              rng.uniform(-30, 30, size=(n1 - shared, 3))])
        kp1[:shared] += rng.normal(scale=0.05, size=(shared, 3))
        desc1 = np.concatenate([desc0[:shared] + 0.05 * rng.normal(size=(shared, 33)),
                                np.abs(rng.normal(size=(n1 - shared, 33)))])
        pairs.append(dict(kp0=kp0, desc0=desc0, score0=rng.uniform(10, 30, n0),
                          kp1=kp1, desc1=np.abs(desc1),
                          score1=rng.uniform(10, 30, n1)))
    return pairs


def agreement(outs_a, outs_b):
    same = total = 0
    for a, b in zip(outs_a, outs_b):
        for key in ("matches0", "matches1"):
            same += int((a[key] == b[key]).sum())
            total += a[key].size
    return same / total


def check_outputs(outs, pairs):
    for o, p in zip(outs, pairs):
        n0, n1 = len(p["kp0"]), len(p["kp1"])
        require(o["matches0"].shape == (n0,) and o["matches1"].shape == (n1,),
                "match shapes")
        require(o["matches0"].min() >= -1 and o["matches0"].max() < n1
                and o["matches1"].min() >= -1 and o["matches1"].max() < n0,
                "match indices out of range")
        for key in ("matching_scores0", "matching_scores1"):
            sc = o[key]
            require(bool(np.isfinite(sc).all() and (sc >= 0).all()
                         and (sc <= 1 + 1e-6).all()), f"{key} out of [0, 1]")
        if "T" in o and o["T"] is not None:
            require(bool(np.isfinite(o["T"]).all()), "non-finite pose")


def serving(rng, dev, report, counters):
    import torch
    from mdgat_tpu_torch import Matcher

    matcher = Matcher(seed=0, device=dev, **EXACT)
    plain = Matcher(seed=0, device=dev, use_kernels=False)
    cfg = matcher.cfg
    print(f"model: L={cfg.L} D={cfg.descriptor_dim} heads={cfg.num_heads} "
          f"k={cfg.k} sinkhorn_iterations={cfg.sinkhorn_iterations} "
          f"compute={cfg.compute_dtype} rule={cfg.loss_method}")
    requests = [make_pairs(rng, 64) for _ in range(3)]
    reg_pairs = make_pairs(rng, 64)
    matcher.match_batch(requests[0][:2])            # first use: kernel prep
    torch.cuda.synchronize()

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    outs = [matcher.match_batch(r) for r in requests]
    regs = matcher.register_batch(reg_pairs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.read() for name, c in counters.items()}
    forwards = len(requests) + 1
    print(f"serving: {forwards} forwards of 64 pairs in {wall:.3f} s host "
          f"wall; launches {launches}")
    for name in ("topk_attention", "eval_layer", "gemm", "sinkhorn"):
        report[name]["launches"] = launches[name]
    require(launches["fused_mha_fwd"] == 0 and launches["sinkhorn_bwd"] == 0
            and launches["train_layer_fwd"] == 0,
            "a training kernel ran on the serving path")
    require(launches["eval_layer"] == 36 * forwards,
            f"layer launches {launches['eval_layer']} != 36 per forward")
    require(launches["topk_attention"] == 36 * forwards,
            "attention launches != 36 per forward")
    require(launches["gemm"] == 6 * 36 * forwards, "gemm launches != 216 per forward")
    require(launches["sinkhorn"] == forwards, "sinkhorn launches != 1 per forward")

    for r, o in zip(requests, outs):
        check_outputs(o, r)
    check_outputs(regs, reg_pairs)
    n_pose = sum(o["T"] is not None for o in regs)

    plain_outs = [plain.match_batch(r) for r in requests]
    plain_regs = plain.register_batch(reg_pairs)
    agree = agreement(sum(outs, []) + regs, sum(plain_outs, []) + plain_regs)
    n_matched = sum(int((o["matches0"] >= 0).sum()) for o in sum(outs, []))
    print(f"match agreement kernel vs plain on the card: {agree:.6f} "
          f"(min {MIN_AGREEMENT}); {n_matched} matches0 set; {n_pose} of 64 "
          f"register_batch poses fitted")
    require(agree >= MIN_AGREEMENT, "kernel path disagrees with the plain path")

    cpu = Matcher(seed=0, device="cpu")
    small = make_pairs(rng, 4)
    agree_cpu = agreement(matcher.match_batch(small), cpu.match_batch(small))
    print(f"match agreement kernel path vs CPU path, 4 pairs: {agree_cpu:.6f}")
    require(agree_cpu >= MIN_AGREEMENT, "kernel path disagrees with the CPU path")
    report["_serving"] = dict(forwards=forwards, wall_s=wall,
                              agreement_plain=agree, agreement_cpu=agree_cpu,
                              matches0_set=n_matched, poses=n_pose)
    return matcher, plain, requests[0]


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def timings(rng, dev, report, card, matcher, plain, pairs):
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S

    b, h, n, dh = 64, 4, 256, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    mask = ragged_mask(rng, b, n, 200, dev)
    times = {}
    for kk in (128, 64, 0):
        times[f"attention_k{kk}"] = (
            cuda_ms(lambda: A.topk_attention(q, k, v, mask, kk, dh ** -0.5)),
            cuda_ms(lambda: A.topk_attention_reference(q, k, v, mask, kk, dh ** -0.5)))
    layer = _random_layer(7, dev)
    w = layer.kernel_weights()
    x = torch.from_numpy(rng.normal(size=(b, n, 128)).astype(np.float32)).to(dev)
    for kk in (128, 0):
        times[f"layer_k{kk}"] = (
            cuda_ms(lambda: Lk.fused_layer(x, x, mask, kk, w)),
            cuda_ms(lambda: Lk.fused_layer_reference(x, x, mask, kk, w)))
    x2 = x.reshape(b * n, 128)
    # Calls under 0.1 ms: event times of a host loop move with the host, so
    # kernel and library call are also timed inside a CUDA graph, and the
    # graph times are the ones reported and compared. The library call is
    # the one PyTorch call for the same function, timed here and used
    # nowhere in the port: addmm (cuBLAS) for the GEMM, SDPA for dense
    # unmasked attention. Top-k attention, the whole layer and the Sinkhorn
    # have no such call.
    short = {
        "gemm_q_proj": (lambda: Lk.gemm(x2, w.wq, w.bq),
                        lambda: x2 @ w.wq + w.bq,
                        lambda: torch.addmm(w.bq, x2, w.wq)),
        "attention_dense_unmasked": (
            lambda: A.topk_attention(q, k, v, None, 0, dh ** -0.5),
            lambda: A.topk_attention_reference(q, k, v, None, 0, dh ** -0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))}
    library, by_events = {}, {}
    for key, (kern_fn, plain_fn, lib_fn) in short.items():
        by_events[key] = tuple(cuda_ms(fn) for fn in (kern_fn, plain_fn, lib_fn))
        with torch.no_grad():
            times[key] = (graph_ms(kern_fn), graph_ms(plain_fn))
            library[key] = graph_ms(lib_fn)
    u = torch.relu(torch.from_numpy(rng.normal(size=(b * n, 256)).astype(np.float32)).to(dev))
    times["gemm_mlp2_residual"] = (
        cuda_ms(lambda: Lk.gemm(u, w.w2, w.b2, res=x2)),
        cuda_ms(lambda: x2 + (u @ w.w2 + w.b2)))
    scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
    times["sinkhorn_64x256x256"] = (
        cuda_ms(lambda: S.log_optimal_transport_kernel(scores, 1.0, 20, mask, mask)),
        cuda_ms(lambda: S.log_optimal_transport_reference(scores, 1.0, 20, mask, mask)))
    big = torch.from_numpy(rng.normal(size=(8, 1024, 1024)).astype(np.float32)).to(dev)
    times["sinkhorn_8x1024x1024"] = (
        cuda_ms(lambda: S.log_optimal_transport_kernel(big, 1.0, 20), reps=5),
        cuda_ms(lambda: S.log_optimal_transport_reference(big, 1.0, 20), reps=5))

    # whole forward on one prepared batch (device only), then the whole
    # match_batch call (host padding, copies, forward, results); in turns
    # plain / kernel / kernel / plain
    batch, _ = matcher.prepare_batch(pairs)
    fwd = {"kernel": [], "plain": [], "kernel_call": [], "plain_call": []}
    for label, m in (("plain", plain), ("kernel", matcher),
                     ("kernel", matcher), ("plain", plain)):
        with torch.inference_mode():
            fwd[label].append(cuda_ms(lambda: m.model(batch), reps=5, warmup=1))
        fwd[label + "_call"].append(
            cuda_ms(lambda: m.match_batch(pairs), reps=3, warmup=1))
    times["forward_64_pairs"] = (min(fwd["kernel"]), min(fwd["plain"]))
    times["match_batch_64_pairs"] = (min(fwd["kernel_call"]),
                                     min(fwd["plain_call"]))

    # the same forward with a bfloat16 GNN (scores and transport in f32)
    from mdgat_tpu_torch import Matcher
    bf = {flag: Matcher(seed=0, device=dev, compute_dtype="bfloat16",
                        use_kernels=flag, **EXACT) for flag in (True, False)}
    with torch.inference_mode():
        times["forward_64_pairs_bf16"] = tuple(
            cuda_ms(lambda: bf[flag].model(batch), reps=5, warmup=1)
            for flag in (True, False))
    agree = agreement(bf[True].match_batch(pairs), bf[False].match_batch(pairs))
    print(f"bf16 forward: match agreement kernel vs plain {agree:.6f} "
          f"(both bf16; the plain path also rounds every product to bf16)")
    report["_serving"]["agreement_plain_bf16"] = agree

    print(f"times on {card} (CUDA events, ms per call; kernel / plain):")
    for key, (t_k, t_p) in times.items():
        if key in library:
            ev = by_events[key]
            verdict = ("no slower than" if t_k <= library[key] else
                       f"{t_k / library[key]:.2f}x")
            print(f"  {key}, in a CUDA graph: {t_k:.4f} / {t_p:.4f} / library "
                  f"call {library[key]:.4f} (kernel {verdict} the library "
                  f"call); by events {ev[0]:.4f} / {ev[1]:.4f} / {ev[2]:.4f}")
        else:
            print(f"  {key}: {t_k:.4f} / {t_p:.4f}")

    # bounds at the timed shapes (b=64, h=4, n=m=256, dh=32, D=128, f32),
    # counting what this run's mask needs: scores against valid keys only,
    # the entries the mask and k keep, projections of valid keys only
    d, kk = h * dh, 128
    rows = b * n
    keys = mask.sum().item()                        # valid keys of the batch
    kept = torch.clamp(mask.sum(1), max=kk).sum().item() * h * n
    attn_flops = 2.0 * h * n * dh * keys + 2.0 * kept * dh
    attn_bytes = 4 * 4.0 * b * h * n * dh + b * n + 4.0 * b * h * n
    gemm_flops, gemm_bytes = 2.0 * rows * d * d, 4.0 * (2 * rows * d + d * d + d)
    layer_flops = (2 * gemm_flops + 2 * 2.0 * keys * d * d + attn_flops
                   + 2.0 * rows * 2 * d * (2 * d + d))
    layer_bytes = 2 * 4.0 * rows * d + b * n + 4.0 * (4 * d * d + 4 * d * d
                                                     + 2 * d * d + 7 * d)
    valid = (mask.sum(1).float() ** 2).sum().item()
    sk_bytes, sk_flops = 2 * 4.0 * b * n * n, 20 * 2 * 5.0 * valid
    for name, key, nbytes, flops in (
            ("topk_attention", "attention_k128", attn_bytes, attn_flops),
            ("eval_layer", "layer_k128", layer_bytes, layer_flops),
            ("gemm", "gemm_q_proj", gemm_bytes, gemm_flops),
            ("sinkhorn", "sinkhorn_64x256x256", sk_bytes, sk_flops)):
        ms, by = bound(nbytes, flops)
        report[name].update(ms=times[key][0], plain_ms=times[key][1],
                            bound_ms=ms, bound_by=by,
                            library_ms=library.get(key))
    dense_flops = 4.0 * b * h * n * n * dh
    # the wide Sinkhorn shape runs unmasked: Z in, the plan out; five
    # operations per entry and half-iteration
    big_n = float(big.numel())
    report["_bounds_serving"] = dict(
        attention_dense_unmasked=bound(attn_bytes - b * n, dense_flops),
        sinkhorn_8x1024x1024=bound(2 * 4.0 * big_n, 20 * 2 * 5.0 * big_n))
    for key, (ms, by) in report["_bounds_serving"].items():
        print(f"  bound {key}: {ms:.4f} ms ({by})")
    report["_library_ms"] = library
    report["_short_calls_by_events_ms"] = {
        key: dict(kernel=ev[0], plain=ev[1], library=ev[2])
        for key, ev in by_events.items()}
    report["_times_ms"] = {k: {"kernel": a, "plain": p}
                           for k, (a, p) in times.items()}


def graph_times(rng, dev, card):
    """Graph times at shapes beside the table's: the attention kernel at
    k = 128 / 64 / dense under the ragged mask and dense unmasked against
    SDPA, at the serving (N=M=256) and the train shape (512); the GEMM at
    the train step's row count and in its two-operand ReLU mode, against
    ``torch.addmm``."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    out = {}
    print(f"more times on {card} (ms in a CUDA graph):")
    with torch.no_grad():
        for n in (256, 512):
            b, h, dh = 64, 4, 32
            q, k, v = t(b, h, n, dh), t(b, h, n, dh), t(b, h, n, dh)
            mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
            for kk, mk in ((128, mask), (64, mask), (0, mask), (0, None)):
                key = (f"attention_{b}x{h}x{n}x{n}x{dh}_k{kk}"
                       f"{'' if mk is not None else '_unmasked'}")
                out[key] = graph_ms(
                    lambda: A.topk_attention(q, k, v, mk, kk, dh ** -0.5))
            out[f"sdpa_{b}x{h}x{n}x{n}x{dh}"] = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        for r, k1, k2, c in ((32768, 128, 0, 128), (16384, 128, 128, 256)):
            a1, a2, w, bias = t(r, k1), (t(r, k2) if k2 else None), t(k1 + k2, c), t(c)
            a = a1 if a2 is None else torch.cat([a1, a2], 1)
            name = f"{r}x{k1 + k2}x{c}{'_two_operand_relu' if k2 else ''}"
            out[f"gemm_{name}"] = graph_ms(
                lambda: Lk.gemm(a1, w, bias, a2=a2, relu=bool(k2)))
            out[f"addmm_{name}"] = graph_ms(lambda: torch.addmm(bias, a, w))
    for key, ms in out.items():
        print(f"  {key}: {ms:.4f}")
    return out


def profile(matcher, pairs, card):
    """torch.profiler over three kernel-path forwards: device time by
    kernel and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    batch, _ = matcher.prepare_batch(pairs)
    with torch.inference_mode():
        matcher.model(batch)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                matcher.model(batch)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"profile on {card}: 3 forwards, window {window_ms:.3f} ms host, "
          f"device kernel time {device_ms:.3f} ms, busy share "
          f"{device_ms / window_ms:.3f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    return dict(forwards=3, window_ms=window_ms, device_ms=device_ms,
                kernels=[dict(name=e.key[:120], count=e.count,
                              ms=e.self_device_time_total / 1e3) for e in top])


# ---------------------------------------------------------------------------
# phase 6: parity of the training kernels
# ---------------------------------------------------------------------------

def _random_attn(seed, dev, d, heads):
    """Blocked weights of a seeded MultiHeadedAttention, as leaf tensors."""
    import torch
    from mdgat_tpu_torch.models.gnn import MultiHeadedAttention
    from mdgat_tpu_torch.ops.cuda.mha import blocked_weights
    attn = MultiHeadedAttention(d, dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    for conv in list(attn.proj) + [attn.merge]:
        conv.reset_parameters(g)
    with torch.no_grad():
        return [w.to(dev) for w in blocked_weights(attn, heads)]


def _rel_err(a, b):
    """max|a - b| over max(1, max|b|)."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()


def frozen_selection_gap(x, source, kv_mask, topk, h, wq, bq, wk, bk, wv, bv,
                         wm, bm, exact=True) -> float:
    """Largest difference between the attention output of the forward
    kernel and the one the backward's rows kernel rebuilds from ``thr`` and
    ``lse``, over every row, near ties included. The two agree to rounding
    (about 1e-6) exactly when the backward keeps the entries the forward
    kept; one flipped entry moves a row by that entry's probability."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda.layer import gemm
    b, n, d = x.shape
    m = source.shape[1]
    f32 = torch.float32
    with torch.no_grad():
        q = gemm(x, wq, bq, out_dtype=f32, out_heads=h, rows_per_batch=n)
        k = gemm(source, wk, bk, out_dtype=f32, out_heads=h, rows_per_batch=m)
        v = gemm(source, wv, bv, out_dtype=f32, out_heads=h, rows_per_batch=m)
        o, thr, lse = A.topk_attention(
            q, k, v, kv_mask, int(topk or 0), 1.0, return_lse=True,
            exact=exact, fine_iters=A.resolution(x.dtype, exact))
        o_again = M._attention_backward(q, k, v, torch.zeros_like(q), kv_mask,
                                        thr, lse)[0]
    return (o.permute(0, 2, 1, 3).reshape(b * n, d) - o_again).abs().max().item()


def mha_case(rng, dev, b, n, m, d, heads, k, selfattn, seed, exact=True):
    """One fused-MHA comparison, kernel against twin under autograd on the
    card: (worst error of out/thr/lse, worst gradient error, selection gap,
    near-tie rows left out, rows). ``exact=False``: both sides select with
    the fast arm, and the rows left out are those whose kept set rests on
    rounding (:func:`fast_tie_rows`)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import mha as M

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    w = _random_attn(seed, dev, d, heads)
    x = t(b, n, d)
    src = x if selfattn else t(b, m, d)
    m = src.shape[1]
    mask = ragged_mask(rng, b, m, int(0.78 * m), dev)

    # near ties, from the twin's scores: the rows the two sides may select
    # differently; their cotangent is zero, so they reach no gradient
    with torch.no_grad():
        q = (x @ w[0] + w[1]).reshape(b, n, heads, -1).transpose(1, 2)
        kk = (src @ w[2] + w[3]).reshape(b, m, heads, -1).transpose(1, 2)
        s = q @ kk.transpose(-1, -2)
        valid = mask[:, None, None, :].expand(s.shape)
        if exact:
            tie = near_tie_rows(s, valid, k or 0).any(1)        # [B, N]
        else:
            _, thr_k, _ = M.fused_mha_forward(x, src, mask, k, heads, *w,
                                              exact=False)
            _, thr_t, _ = M.fused_mha_reference(
                x, src, mask, k, heads, *w, return_residuals=True,
                exact=False)
            tie = fast_tie_rows(s, valid, thr_k, thr_t).any(1)
            del thr_k, thr_t
        del q, kk, s, valid
    g = t(b, n, d) * (~tie)[:, :, None]

    def run(fn, **kw):
        leaves = [x.clone().requires_grad_()]
        if not selfattn:
            leaves.append(src.clone().requires_grad_())
        ws = [p.clone().requires_grad_() for p in w]
        out = fn(leaves[0], leaves[-1], mask, k, heads, *ws, exact=exact, **kw)
        grads = torch.autograd.grad(out, leaves + ws, g)
        return out.detach(), grads

    out, grads = run(M.fused_mha)
    _, grads2 = run(M.fused_mha)
    out_ref, grads_ref = run(M.fused_mha_reference)
    out_f, thr, lse = M.fused_mha_forward(x, src, mask, k, heads, *w,
                                          exact=exact)
    with torch.no_grad():
        _, thr_ref, lse_ref = M.fused_mha_reference(x, src, mask, k, heads, *w,
                                                    return_residuals=True,
                                                    exact=exact)
    gap = frozen_selection_gap(x, src, mask, k, heads, *w, exact=exact)
    torch.cuda.synchronize()
    keep = ~tie
    fwd_err = max((out - out_ref).abs().amax(-1)[keep].max().item(),
                  (out_f - out).abs().max().item(),
                  (thr - thr_ref).abs()[..., 0].amax(1)[keep].max().item(),
                  (lse - lse_ref).abs()[..., 0].amax(1)[keep].max().item())
    grad_err = max(_rel_err(a, r) for a, r in zip(grads, grads_ref))
    same_bits = all(torch.equal(a, c) for a, c in zip(grads, grads2))
    require(same_bits, "fused-MHA backward differs from run to run")
    require(all(torch.isfinite(a).all().item() for a in grads),
            "fused-MHA backward: non-finite gradient")
    return fwd_err, grad_err, gap, int(tie.sum()), tie.numel()


def check_gemm_modes(rng, dev, report, card):
    """The GEMM modes the fused-MHA backward adds: W read transposed, no
    bias, and the transposed-A split-K product with its column sums."""
    import torch
    from mdgat_tpu_torch.ops.cuda import layer as Lk

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    worst = 0.0
    # the train step's two shapes (x^T dq; x^T dh1 with dh1 [R, 2D]), a
    # ragged row count, and guarded loads (K1, C not multiples of four)
    for r, k1, c in ((64 * 512, 128, 128), (64 * 512, 128, 256),
                     (64 * 512 + 1, 128, 128), (1000, 45, 70), (513, 128, 64)):
        a, b2 = t(r, k1), t(r, c)
        dw, db = Lk.gemm_tn(a, b2)
        dw2, db2 = Lk.gemm_tn(a, b2)
        require(torch.equal(dw, dw2) and torch.equal(db, db2),
                "gemm_tn differs from run to run")
        err = max(_rel_err(dw, a.t() @ b2), _rel_err(db, b2.sum(0)))
        rows, splits = Lk.tn_plan(r, k1, c)
        print(f"gemm_tn {k1}x{r}x{c} ({splits} splits of {rows} rows): max rel "
              f"err of a^T b and column sums {err:.3e} (tol "
              f"{TOL['mha_grad']:g}); bit-equal over two runs")
        require(err <= TOL["mha_grad"], "gemm_tn disagrees")
        worst = max(worst, err)
    report["gemm_tn"]["max_abs_err"] = worst
    a1, a2, w = t(111, 45), t(111, 13), t(70, 58)
    y = Lk.gemm(a1, w, None, a2=a2, w_trans=True)
    err = (y - torch.cat([a1, a2], 1) @ w.t()).abs().max().item()
    print(f"gemm 111x58x70 two A, W transposed, no bias: max err {err:.3e} "
          f"tol {TOL['gemm_f32']:g}")
    require(err <= TOL["gemm_f32"], "transposed-W gemm disagrees")

    # Every mode at aligned and odd shapes: K or C not a multiple of four
    # (the guarded element loads), fewer rows than one tile, the head-split
    # read and write together with bf16.
    bf16 = torch.bfloat16
    modes = [  # name, R, K1, K2, C, dtype in, dtype out, kwargs
        ("K1 45 K2 13 C 70", 111, 45, 13, 70, None, None, dict(relu=True, res=True)),
        ("K 130 C 66", 17, 130, 0, 66, None, None, dict(res=True)),
        ("K 128 C 126", 300, 128, 0, 126, None, None, {}),
        ("R 5", 5, 128, 0, 128, None, None, dict(relu=True)),
        ("W^T K 45+13 C 70", 111, 45, 13, 70, None, None, dict(w_trans=True)),
        ("W^T K 96+32 C 136 residual", 140, 96, 32, 136, None, None,
         dict(w_trans=True, res=True)),
        ("W^T head-split out", 120, 64, 0, 64, None, None,
         dict(w_trans=True, out_heads=2, rows_per_batch=40)),
        ("head-split in and out, bf16", 90, 64, 32, 64, bf16, bf16,
         dict(a1_heads=4, out_heads=4, rows_per_batch=30, relu=True, res=True)),
        ("head-split in, Dh 6, bf16 in", 90, 24, 0, 33, bf16, None,
         dict(a1_heads=4, rows_per_batch=30)),
        ("aligned 1000x128x128 head-split out", 1000, 128, 0, 128, None, None,
         dict(out_heads=4, rows_per_batch=250))]
    for name, r, k1, k2, c, dt_in, dt_out, kw in modes:
        kw = dict(kw)
        wt = kw.get("w_trans", False)
        heads_in, heads_out = kw.get("a1_heads", 0), kw.get("out_heads", 0)
        rpb = kw.get("rows_per_batch", 0)
        a1 = t(r, k1).to(dt_in or torch.float32)
        a2 = t(r, k2) if k2 else None
        w = t(c, k1 + k2) if wt else t(k1 + k2, c)
        bias = None if wt else t(c)
        ref = torch.cat([a1.float()] + ([a2] if k2 else []), 1) @ (w.t() if wt else w)
        if bias is not None:
            ref = ref + bias
        if kw.get("relu"):
            ref = torch.relu(ref)
        res = None
        if kw.pop("res", False):
            res = t(r, c).to(dt_out or a1.dtype)
            ref = res.float() + ref
            kw["res"] = (res.reshape(r // rpb, rpb, heads_out, -1).transpose(1, 2)
                         .contiguous() if heads_out else res)
        a1_in = (a1.reshape(r // rpb, rpb, heads_in, -1).transpose(1, 2).contiguous()
                 if heads_in else a1)
        y = Lk.gemm(a1_in, w, bias, a2=a2, out_dtype=dt_out, **kw)
        if heads_out:
            y = y.transpose(1, 2).reshape(r, c)
        out_bf16 = (dt_out or a1.dtype) == bf16
        err = ((y.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
        tol = TOL["gemm_bf16_rel" if out_bf16 else "gemm_f32"]
        print(f"gemm mode {name} ({r}x{k1 + k2}x{c}): max rel err {err:.3e} tol "
              f"{tol:g}")
        require(err <= tol, f"gemm {name} disagrees")

    # The forward's projection and its recomputation in the backward: the
    # two calls ops/cuda/mha.py makes, on the same x, wq, bq, must give the
    # same bits (the backward tests s >= thr on scores formed from them),
    # on the vector path (aligned) and on the guarded one (a view at an odd
    # offset): one FMA chain over k per output on both.
    for bsz, n, d, heads in ((64, 512, 128, 4), (3, 37, 32, 4)):
        x, wq, bq = t(bsz, n, d), t(d, d), t(d)
        q_fwd = Lk.gemm(x, wq, bq, out_dtype=torch.float32, out_heads=heads,
                        rows_per_batch=n)                 # _project_attend
        q_bwd = Lk.gemm(x, wq, bq, out_dtype=torch.float32, out_heads=heads,
                        rows_per_batch=n)                 # _mha_backward_launches
        odd = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
        q_odd = Lk.gemm(odd, wq, bq, out_dtype=torch.float32, out_heads=heads,
                        rows_per_batch=n)
        require(torch.equal(q_fwd, q_bwd) and torch.equal(q_fwd, q_odd),
                "the backward's q differs from the forward's")
        print(f"gemm q projection {bsz}x{n}x{d}: forward call and backward "
              f"recomputation bit-equal, vector and guarded loads bit-equal")

    # W^T mode at the train shapes: dq @ wq^T and cat(dk, dv) @ cat(wk, wv)^T
    for name, k1, k2 in (("gemm_wt", 128, 0), ("gemm_wt_cat", 128, 128)):
        r, c = 64 * 512, 128
        a1, a2, w = t(r, k1), (t(r, k2) if k2 else None), t(c, k1 + k2)
        a = a1 if a2 is None else torch.cat([a1, a2], 1)
        y = Lk.gemm(a1, w, None, a2=a2, w_trans=True)
        err = (y - a @ w.t()).abs().max().item()
        require(err <= TOL["gemm_f32"], f"{name} disagrees")
        with torch.no_grad():
            ms = graph_ms(lambda: Lk.gemm(a1, w, None, a2=a2, w_trans=True))
            lib = graph_ms(lambda: torch.matmul(a, w.t()))
        bms, by = bound(4.0 * (r * (k1 + k2) + r * c + c * (k1 + k2)),
                        2.0 * r * (k1 + k2) * c)
        print(f"{name} {r}x{k1 + k2}x{c} W^T, in a CUDA graph: {ms:.4f} ms / "
              f"torch.matmul(a, w.t()) {lib:.4f} / bound {bms:.4f} ({by}); "
              f"max err {err:.3e}")
        if name == "gemm_wt":
            # the plain twin of this mode is the same matmul
            report["gemm_wt"].update(ms=ms, plain_ms=lib, bound_ms=bms,
                                     bound_by=by, library_ms=lib,
                                     max_abs_err=err)
        report.setdefault("_gemm_wt", {})[name] = dict(ms=ms, library_ms=lib,
                                                       bound_ms=bms)
    # the A^T GEMM at the train step's two shapes, in CUDA graphs: the
    # kernel (its plan, then other row splits), its plain twin and
    # torch.matmul(a.t(), b), the one library call for the product
    tn = {}
    for c in (128, 256):
        r, k1 = 64 * 512, 128
        a, b2 = t(r, k1), t(r, c)
        rows, splits = Lk.tn_plan(r, k1, c)
        with torch.no_grad():
            ms = graph_ms(lambda: Lk.gemm_tn(a, b2))
            plain = graph_ms(lambda: Lk.gemm_tn_reference(a, b2))
            lib = graph_ms(lambda: torch.matmul(a.t(), b2))
            sweep = {n: graph_ms(lambda: Lk._gemm_tn_launch(a, b2, n, -(-r // n)))
                     for n in (64, 128, 256, 512, 1024)}
        bms, by = bound(4.0 * (r * (k1 + c) + k1 * c + c), 2.0 * r * k1 * c)
        verdict = ("no slower than" if ms <= lib else f"{ms / lib:.2f}x")
        print(f"gemm_tn {k1}x{r}x{c} on {card}, in a CUDA graph: {ms:.4f} ms "
              f"({splits} splits of {rows} rows) / plain {plain:.4f} / "
              f"torch.matmul(a.t(), b) {lib:.4f} (kernel {verdict} the "
              f"library call) / bound {bms:.4f} ({by}); rows a split: "
              + ", ".join(f"{n} ({-(-r // n)} splits) {v:.4f}"
                          for n, v in sweep.items()))
        tn[f"{k1}x{r}x{c}"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, plan=[rows, splits],
                                   rows_per_split_ms=sweep)
        if c == 128:
            report["gemm_tn"].update(ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=lib)
    report["_gemm_tn"] = tn


def check_fused_mha(rng, dev, report):
    cases = [  # b, n, m, d, heads, k, self-attention
        (64, 512, 512, 128, 4, 128, True), (64, 512, 512, 128, 4, 64, True),
        (64, 512, 512, 128, 4, None, False), (64, 512, 512, 128, 4, 128, False),
        (3, 37, 45, 32, 4, 8, False), (2, 70, 300, 64, 2, 16, False),
        (2, 33, 50, 256, 4, None, False), (3, 40, 40, 64, 4, 8, True),
        (2, 100, 700, 128, 4, 64, False)]
    worst_f = worst_g = 0.0
    for i, (b, n, m, d, heads, k, selfattn) in enumerate(cases):
        f, g, gap, ties, rows = mha_case(rng, dev, b, n, m, d, heads, k,
                                         selfattn, 20 + i)
        name = (f"fused_mha b{b} n{n} m{m} d{d} h{heads} k{k} "
                f"{'self' if selfattn else 'cross'}")
        print(f"{name}: out/thr/lse max err {f:.3e} (tol {TOL['mha_out']:g}), "
              f"ten gradients max rel err {g:.3e} (tol {TOL['mha_grad']:g}), "
              f"forward vs rebuilt attention output {gap:.3e} "
              f"(tol {TOL['mha_selection_gap']:g}); backward bit-equal over "
              f"two runs; near-tie rows left out {ties} of {rows}")
        require(f <= TOL["mha_out"], f"{name}: forward disagrees")
        require(g <= TOL["mha_grad"], f"{name}: backward disagrees")
        require(gap <= TOL["mha_selection_gap"],
                f"{name}: the backward's selection differs from the forward's")
        if i < 4:
            worst_f, worst_g = max(worst_f, f), max(worst_g, g)
    report["fused_mha_fwd"]["max_abs_err"] = worst_f
    report["fused_mha_bwd"]["max_abs_err"] = worst_g


# profiler windows a name needed in kernel_ms_by_name, by name, this run
PROFILER_WINDOWS: dict = {}
PROFILER_MAX_WINDOWS = 3


def kernel_ms_by_name(fn, names, reps: int = 5):
    """Device ms a launch of each kernel whose name contains one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn`` (after one
    call outside the window): ``{name: (ms a launch, launches)}``. A window
    in which the profiler recorded no launch of a name (it happens now and
    then after the kernel ran) is taken again, up to PROFILER_MAX_WINDOWS
    windows, the card synchronised before each, as
    ``tools/torch_step_times.py`` does; the windows each name needed are
    printed and kept in PROFILER_WINDOWS."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    out, needed = {}, {}
    for window in range(1, PROFILER_MAX_WINDOWS + 1):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        for name in names:
            if name in out:
                continue
            hits = [e for e in events if name in e.key]
            count = sum(e.count for e in hits)
            if count:
                total = sum(e.self_device_time_total for e in hits) / 1e3
                out[name], needed[name] = (total / count, count), window
        if len(out) == len(names):
            break
    print("profiler windows needed: " + ", ".join(
        f"{name} {needed.get(name, 'none of ' + str(PROFILER_MAX_WINDOWS))}"
        for name in names))
    for name in names:
        require(name in out, f"the profiler saw no {name} launch in "
                             f"{PROFILER_MAX_WINDOWS} windows")
        PROFILER_WINDOWS.setdefault(name, []).append(needed[name])
    return out


def attention_backward_bounds(mask, b, h, n, m, dh, k):
    """(rows kernel, keys kernel) bounds, each (ms, by), at [B, H, N, Dh]
    queries and [B, H, M, Dh] keys, counting what this mask and k need:
    scores over the valid keys (to find the kept entries), and o, dp, dq
    (rows) or dp, dk, dv (keys) over the kept entries only."""
    import torch
    keys = mask.sum().item()
    kept = (torch.clamp(mask.sum(1), max=k).sum().item() if k else keys) * h * n
    flops = 2.0 * h * n * dh * keys + 3 * 2.0 * kept * dh
    q_side, k_side = 4.0 * b * h * n * dh, 4.0 * b * h * m * dh
    rows_in = 2 * q_side + 2 * k_side + 2 * 4.0 * b * h * n + b * m
    rows_bytes = rows_in + 2 * q_side + 4.0 * b * h * n      # o, dq; delta
    keys_bytes = rows_in + 4.0 * b * h * n + 2 * k_side      # delta in; dk, dv
    return bound(rows_bytes, flops), bound(keys_bytes, flops)


# the previous designs' times, printed beside this run's (this script on one
# H100 80GB HBM3 at 700 W): the keys kernel, profiler ms a launch at 64 x 4 x
# 512 x 512 x 32 for k = 128, 64, dense (a warp per 8 keys, one pair a
# lane); the Sinkhorn replay backward, ms by events at 64 x 512 x 512, 20
# iterations (one block per pair)
KEYS_KERNEL_BEFORE_MS = {128: 1.5571, 64: 1.5664, 0: 1.5637}
SINKHORN_BWD_BEFORE_MS = 12.8760


def check_attention_backward(rng, dev, report, card):
    """The two attention-backward kernels at the train shape 64 x 4 x 512 x
    512 x 32 (k = 128, 64, dense; ragged keys) and at 8 x 4 x 1024 x 1024 x
    32 (k = 128): o, dq, dk, dv against the twin (thr and lse each side from
    its own forward; near-tie rows get a zero cotangent and their o is left
    out), bit-equal over two runs; at the train shape each kernel's device ms
    a launch from torch.profiler beside its bound, and the keys kernel under
    both of its key tilings (64 keys x 64 rows, 128 keys x 32 rows)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import mha as M

    h, dh = 4, 32
    names = ("mha_bwd_rows_kernel", "mha_bwd_keys_kernel")
    out = {}

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def case(b, n, kk, q, k, v, do, mask):
        with torch.no_grad():
            _, thr, lse = A.topk_attention(q, k, v, mask, kk, 1.0, return_lse=True)
            _, thr_r, lse_r = A.topk_attention_reference(q, k, v, mask, kk, 1.0,
                                                         return_lse=True)
            s = q @ k.transpose(-1, -2)
            tie = near_tie_rows(s, mask[:, None, None, :].expand(s.shape), kk)
            del s
            dz = do * (~tie)[..., None]
            got = M._attention_backward(q, k, v, dz, mask, thr, lse)
            again = M._attention_backward(q, k, v, dz, mask, thr, lse)
            ref = M.attention_backward_reference(q, k, v, dz, mask, thr_r, lse_r)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                "the attention backward differs from run to run")
        keep = (~tie).permute(0, 2, 1).reshape(b * n, h)[..., None]
        o_err = ((got[0] - ref[0]).reshape(b * n, h, dh).abs() * keep).max().item()
        errs = [_rel_err(x, y) for x, y in zip(got[1:], ref[1:])]
        require(all(torch.isfinite(x).all().item() for x in got),
                "attention backward: non-finite output")
        require(o_err <= TOL["mha_out"] and max(errs) <= TOL["mha_grad"],
                f"attention backward {b}x{h}x{n}x{n}x{dh} k{kk} disagrees "
                f"with its twin")
        verdict = (f"o max err {o_err:.3e} (tol {TOL['mha_out']:g}, "
                   f"{int(tie.sum())} near-tie rows of {tie.numel()} left "
                   f"out), dq / dk / dv max rel err "
                   + " / ".join(f"{e:.3e}" for e in errs)
                   + f" (tol {TOL['mha_grad']:g}); bit-equal over two runs")
        return (dz, thr, lse, thr_r, lse_r), o_err, errs, verdict

    b, n = 64, 512
    # the score scale folded into q, as the model folds it into wq
    q, k, v, do = t(b, h, n, dh) * dh ** -0.5, t(b, h, n, dh), t(b, h, n, dh), t(b, h, n, dh)
    mask = ragged_mask(rng, b, n, 400, dev)
    print(f"attention backward {b}x{h}x{n}x{n}x{dh} on {card}:")
    for kk in (128, 64, 0):
        (dz, thr, lse, thr_r, lse_r), o_err, errs, verdict = case(
            b, n, kk, q, k, v, do, mask)
        with torch.no_grad():
            ms = kernel_ms_by_name(
                lambda: M._attention_backward(q, k, v, dz, mask, thr, lse), names)
            tiles = {kt: kernel_ms_by_name(
                lambda: M._attention_backward(q, k, v, dz, mask, thr, lse,
                                              key_tile=kt), names[1:])[names[1]][0]
                     for kt in (64, 128)}
            plain = cuda_ms(lambda: M.attention_backward_reference(
                q, k, v, dz, mask, thr_r, lse_r), reps=5, warmup=1)
        (rb, rby), (kb, kby) = attention_backward_bounds(mask, b, h, n, n, dh, kk)
        print(f"  k{kk}: rows kernel {ms[names[0]][0]:.4f} ms a launch (bound "
              f"{rb:.4f}, {rby}), keys kernel {ms[names[1]][0]:.4f} (before "
              f"{KEYS_KERNEL_BEFORE_MS[kk]:.4f}; bound {kb:.4f}, {kby}; key "
              f"tiles: 64 keys x 64 rows {tiles[64]:.4f}, 128 keys x 32 rows "
              f"{tiles[128]:.4f}); twin {plain:.4f}; " + verdict)
        out[f"k{kk}"] = dict(rows_ms=ms[names[0]][0], keys_ms=ms[names[1]][0],
                             keys_ms_by_tile=tiles, rows_bound_ms=rb,
                             keys_bound_ms=kb, plain_ms=plain, o_err=o_err,
                             grad_errs=errs)
        if kk == 128:
            report["mha_bwd_rows"].update(
                ms=ms[names[0]][0], plain_ms=plain, bound_ms=rb, bound_by=rby,
                library_ms=None, max_abs_err=max(o_err, errs[0]))
            report["mha_bwd_keys"].update(
                ms=ms[names[1]][0], plain_ms=plain, bound_ms=kb, bound_by=kby,
                library_ms=None, max_abs_err=max(errs[1:]))
    del q, k, v, do, dz
    b, n, kk = 8, 1024, 128
    q, k, v, do = t(b, h, n, dh) * dh ** -0.5, t(b, h, n, dh), t(b, h, n, dh), t(b, h, n, dh)
    mask = ragged_mask(rng, b, n, 800, dev)
    _, o_err, errs, verdict = case(b, n, kk, q, k, v, do, mask)
    print(f"attention backward {b}x{h}x{n}x{n}x{dh} k{kk}: " + verdict)
    out[f"{b}x{n}_k{kk}"] = dict(o_err=o_err, grad_errs=errs)
    report["_attention_backward"] = out


def sinkhorn_bwd_case(rng, dev, b, n, m, iters=20):
    """(dZ error relative to max(1, max|dZ_ref|), dalpha relative error)
    of the kernel entry against the plain transport under autograd, with
    cotangents that are zero on padding; the four outputs of that forward
    are held to the forward's tolerance on the way."""
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    scores = t(b, n, m)
    rm = ragged_mask(rng, b, n, int(0.78 * n), dev)
    cm = ragged_mask(rng, b, m, int(0.78 * m), dev)
    cot = (t(b, n, m) * (rm[:, :, None] & cm[:, None, :]), t(b, m) * cm,
           t(b, n) * rm, t(b))

    def run(fn):
        sc = scores.clone().requires_grad_()
        alpha = torch.tensor(0.7, device=dev, requires_grad=True)
        ot = fn(sc, alpha, iters, rm, cm)
        return ot, torch.autograd.grad(list(ot), [sc, alpha], list(cot))

    ot, (dz, da) = run(S.log_optimal_transport_kernel)
    ref, (dz_ref, da_ref) = run(S.log_optimal_transport_reference)
    torch.cuda.synchronize()
    vb = rm[:, :, None] & cm[:, None, :]
    fwd_err = max((ot.dense - ref.dense).abs()[vb].max().item(),
                  (ot.bin_row - ref.bin_row).abs()[cm].max().item(),
                  (ot.bin_col - ref.bin_col).abs()[rm].max().item(),
                  (ot.corner - ref.corner).abs().max().item())
    require(fwd_err <= TOL["sinkhorn_f32"],
            f"sinkhorn {b}x{n}x{m}: the forward under autograd disagrees "
            f"({fwd_err:.3e})")
    require(torch.isfinite(dz).all().item() and torch.isfinite(da).item(),
            "sinkhorn backward: non-finite gradient")
    require(not dz[~vb].any().item(),
            "sinkhorn backward: gradient on padding")
    return _rel_err(dz, dz_ref), abs((da - da_ref).item()) / max(1.0, abs(da_ref.item()))


def check_sinkhorn_bwd(rng, dev, report, card):
    """The Sinkhorn replay backward against its twin at the train shape, the
    stretch shape, odd shapes and 100 iterations (the reference model's
    default, at M = 512 and 1024); then its time at 64 x 512 x 512 and 8 x
    1024 x 1024 (20 iterations, one launch by events) under the launch's
    plan and under each cluster size, bit-equal from run to run."""
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    worst = 0.0
    for i, (b, n, m, iters) in enumerate((
            (64, 512, 512, 20), (8, 1024, 1024, 20), (3, 37, 45, 20),
            (2, 100, 300, 20), (2, 50, 1000, 20), (2, 300, 200, 20),
            (4, 512, 512, 100), (2, 1024, 1024, 100))):
        ez, ea = sinkhorn_bwd_case(rng, dev, b, n, m, iters)
        print(f"sinkhorn_bwd {b}x{n}x{m} {iters} it: dZ rel err {ez:.3e}, "
              f"dalpha rel err {ea:.3e} (tol {TOL['sinkhorn_bwd']:g})")
        require(max(ez, ea) <= TOL["sinkhorn_bwd"],
                f"sinkhorn_bwd {b}x{n}x{m} {iters} it disagrees")
        if i == 0:
            worst = max(ez, ea)
    report["sinkhorn_bwd"]["max_abs_err"] = worst

    sweep = {}
    for b, n in ((64, 512), (8, 1024)):
        scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
        mask = ragged_mask(rng, b, n, n * 25 // 32, dev)
        scalars, lmu, lnu = S._prep(scores, torch.tensor(1.0, device=dev), mask, mask)
        cot = [torch.from_numpy(rng.normal(size=x).astype(np.float32)).to(dev)
               for x in ((b, n, n), (b, n), (b, n), (b,))]
        times = {}
        for g in (0, 2, 4, 8, 16):
            run = lambda: S._backward(scores, scalars, lmu, lnu, cot, 20, g)
            first, again = run(), run()
            torch.cuda.synchronize()
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"sinkhorn_bwd {b}x{n}x{n} with {g or 'planned'} CTAs a "
                    f"pair differs from run to run")
            times[g] = cuda_ms(run, reps=5, warmup=1)
        sweep[f"{b}x{n}x{n}"] = times
        print(f"sinkhorn_bwd {b}x{n}x{n} 20 it on {card}, one launch by "
              f"events: {times[0]:.4f} ms under the plan"
              + (f" (before {SINKHORN_BWD_BEFORE_MS:.4f})" if n == 512 else "")
              + "; CTAs a pair: "
              + ", ".join(f"{g} {times[g]:.4f}" for g in (2, 4, 8, 16)))
    report["_sinkhorn_bwd_sweep"] = sweep


def train_layer_case(rng, dev, b, n, m, d, heads, k, selfattn, seed, dt,
                     row_mask=None, exact=True):
    """One whole-layer comparison, kernels against twin on the card, with
    ragged key and row masks (``row_mask`` [b, n] in place of the drawn
    one): (worst forward error, worst error of bwd1's six outputs, worst of
    the non-zero gradients, worst of those that are zero in exact
    arithmetic: the four bias gradients bk, bv, bm, b1, or bk alone when
    no row is valid, selection gap, rows left out, rows). ``exact=False``:
    both sides select with the fast arm, and the rows whose kept set rests
    on rounding are left out (:func:`fast_tie_rows`)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dt)

    layer = _random_layer(seed, dev, d, heads)
    with torch.no_grad():
        w = [p.clone() for p in T.train_layer_weights(layer)]
    x = t(b, n, d)
    src = x if selfattn else t(b, m, d)
    m = src.shape[1]
    kv_mask = ragged_mask(rng, b, m, int(0.78 * m), dev)
    if row_mask is None:
        row_mask = (kv_mask if selfattn
                    else ragged_mask(rng, b, n, int(0.78 * n), dev))

    (y, mean, var, h1, thr, lse, ssum,
     ssq) = T.fused_train_layer_forward(x, src, kv_mask, row_mask, k, heads, *w,
                                        exact=exact)
    with torch.no_grad():
        ref = T.fused_train_layer_reference(x, src, kv_mask, row_mask, k, heads,
                                            *w, return_residuals=True,
                                            exact=exact)
        y_r, mean_r, var_r, h1_r, thr_r, lse_r, ssum_r, ssq_r = ref
        # Rows left out of the row-wise comparisons, and given a zero
        # cotangent: near ties at the k-th score (the two sides may select
        # differently), and rows with a BatchNorm output within 1e-5 of zero
        # (the backward's ReLU mask is `bn > 0` on a value the two sides
        # round differently; with dh2 = 0 in the row the mask is moot).
        # Padded rows keep their non-zero cotangent.
        q = (x.float() @ w[0] + w[1]).reshape(b, n, heads, -1).transpose(1, 2)
        kk = (src.float() @ w[2] + w[3]).reshape(b, m, heads, -1).transpose(1, 2)
        s = q @ kk.transpose(-1, -2)
        valid = kv_mask[:, None, None, :].expand(s.shape)
        out = (near_tie_rows(s, valid, k or 0) if exact
               else fast_tie_rows(s, valid, thr, thr_r)).any(1)
        del q, kk, s, valid
        if dt == torch.float32:
            inv = torch.rsqrt(var_r + 1e-5)
            bn = (h1_r - mean_r) * inv * w[12] + w[13]
            out |= (bn.abs() < 1e-5).any(-1)
            del bn
    keep = ~out
    g = t(b, n, d) * keep[:, :, None]
    fwd_err = max(_rel_err(y.float()[keep], y_r.float()[keep]),
                  _rel_err(h1.float()[keep], h1_r.float()[keep]),
                  (thr - thr_r).abs()[..., 0].amax(1)[keep].max().item(),
                  (lse - lse_r).abs()[..., 0].amax(1)[keep].max().item(),
                  (mean - mean_r).abs().max().item(),
                  (var - var_r).abs().max().item(),
                  _rel_err(ssum, ssum_r), _rel_err(ssq, ssq_r))

    # bwd1 alone, both sides on the kernels' h1 and statistics
    vec4 = torch.stack([mean, torch.rsqrt(var + 1e-5), w[12], w[13]])
    sums, dw2, db2 = T._tl_bwd1(g, h1.reshape(b * n, 2 * d).contiguous(),
                                w[10], vec4)
    sg, sgh, dw2_r, db2_r, dsc, dbi = T.bn_backward_sums_reference(
        g, h1, w[10], mean, var, w[12], w[13])
    bwd1_err = max(_rel_err(a, r) for a, r in zip(
        (sums[0], sums[1], dw2, db2, sums[2], sums[3]),
        (sg, sgh, dw2_r, db2_r, dsc, dbi)))

    def run(fn):
        leaves = [x.clone().requires_grad_()]
        if not selfattn:
            leaves.append(src.clone().requires_grad_())
        ws = [p.clone().requires_grad_() for p in w]
        out_y = fn(leaves[0], leaves[-1], kv_mask, row_mask, k, heads, *ws,
                   exact=exact)[0]
        return out_y.detach(), torch.autograd.grad(out_y, leaves + ws, g)

    y2, grads = run(T.fused_train_layer)
    _, grads2 = run(T.fused_train_layer)
    _, grads_ref = run(T.fused_train_layer_reference)
    gap = frozen_selection_gap(x, src, kv_mask, k, heads, *w[:8], exact=exact)
    torch.cuda.synchronize()
    require(torch.equal(y2, y), "train layer: forward differs under autograd")
    require(all(torch.equal(a, c) for a, c in zip(grads, grads2)),
            "train-layer backward differs from run to run")
    require(all(torch.isfinite(a).all().item() for a in grads),
            "train-layer backward: non-finite gradient")
    first_w = 1 if selfattn else 2
    zero = [first_w + i for i in (3, 5, 7, 9)]            # bk, bv, bm, b1
    if not bool(row_mask.any()):
        # no valid row: the batch mean is 0, not the rows' mean, so the
        # gradients of bv, bm and b1 are not zero (bk's still is): held
        # relative, as the other gradients are
        zero = zero[:1]
    grad_err = max(_rel_err(a.float(), r.float()) for i, (a, r) in
                   enumerate(zip(grads, grads_ref)) if i not in zero)
    zero_err = max((grads[i] - grads_ref[i]).abs().max().item() for i in zero)
    return (fwd_err, bwd1_err, grad_err, zero_err, gap, int(out.sum()),
            out.numel())


def check_train_layer(rng, dev, report):
    import torch
    cases = [  # b, n, m, d, heads, k, self-attention
        (64, 512, 512, 128, 4, 128, True), (64, 512, 512, 128, 4, 64, False),
        (64, 512, 512, 128, 4, None, True), (64, 512, 512, 128, 4, None, False),
        (3, 37, 45, 32, 4, 8, False), (2, 70, 300, 64, 2, 16, False),
        (3, 40, 40, 64, 4, 8, True), (8, 256, 256, 128, 4, 64, False)]
    worst = [0.0, 0.0, 0.0]
    for i, (b, n, m, d, heads, k, selfattn) in enumerate(cases):
        # the last case in bfloat16: x, source, h1, g and y are bf16, every
        # internal f32 on both sides
        bf16 = i == len(cases) - 1
        f, b1, g, z, gap, left, rows = train_layer_case(
            rng, dev, b, n, m, d, heads, k, selfattn, 40 + i,
            torch.bfloat16 if bf16 else torch.float32)
        name = (f"train_layer b{b} n{n} m{m} d{d} h{heads} k{k} "
                f"{'self' if selfattn else 'cross'}{' bf16' if bf16 else ''}")
        tol_out = TOL["train_layer_out_bf16" if bf16 else "train_layer_out"]
        tol_grad = TOL["train_layer_grad_bf16" if bf16 else "train_layer_grad"]
        print(f"{name}: y/h1/thr/lse/mean/var/ssum/ssq max err {f:.3e} (tol "
              f"{tol_out:g}), Sg/Sgh/dw2/db2/dscale/dbias max "
              f"rel err {b1:.3e}, dx, dsrc and ten parameter gradients max "
              f"rel err {g:.3e} (tol {tol_grad:g}), the four "
              f"bias gradients that are zero in exact arithmetic max abs err "
              f"{z:.3e} ("
              f"{'not compared' if bf16 else TOL['train_layer_zero_grad']}), "
              f"forward vs "
              f"rebuilt attention output {gap:.3e} (tol "
              f"{TOL['mha_selection_gap']:g}); backward bit-equal over two "
              f"runs; near-tie and near-zero-BN rows left out {left} of {rows}")
        require(f <= tol_out, f"{name}: forward disagrees")
        require(b1 <= TOL["train_layer_grad"], f"{name}: bwd1 sums disagree")
        require(g <= tol_grad and (bf16 or z <= TOL["train_layer_zero_grad"]),
                f"{name}: backward disagrees")
        require(gap <= TOL["mha_selection_gap"],
                f"{name}: the backward's selection differs from the forward's")
        if i < 4:
            worst = [max(a, c) for a, c in zip(worst, (f, b1, g))]
    report["train_layer_fwd1"]["max_abs_err"] = worst[0]
    report["train_layer_fwd2"]["max_abs_err"] = worst[0]
    report["train_layer_bwd1"]["max_abs_err"] = worst[1]
    report["train_layer_bwd2"]["max_abs_err"] = worst[2]


# the previous design's ms a launch of tl_dh2_kernel at R = 32768, D = 128,
# f32 (64x64 tiles of 4x4 a thread; profiled train step, this script on one
# H100 80GB HBM3 at 700 W): the sums instantiation, the dh1 instantiation
DH2_BEFORE_MS = {"sums": 5.64 / 36, "dh1": 6.19 / 36}


def dh2_operands(rng, dev, b, n, d, dt):
    """g, h1 in ``dt`` and the f32 vectors of the two dh2 launches at R = b
    * n rows: h1 is drawn so that no BatchNorm output lies within 1e-3 of
    zero after the rounding to ``dt`` (there the ReLU mask is a coin toss
    between the kernel's fmaf and the twin's two roundings)."""
    import torch
    from mdgat_tpu_torch.ops.mlp import BN_EPS
    r, c = b * n, 2 * d

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    mean, var = t(c) * 0.3, t(c).abs() + 0.5
    scale, bias = t(c).abs() * 0.5 + 0.5, t(c) * 0.2
    inv = torch.rsqrt(var + BN_EPS)
    h1 = t(r, c).to(dt)
    bn = (h1.double() - mean.double()) * inv.double() * scale.double() + bias.double()
    away = ((0.5 - bias) / scale / inv + mean).expand(r, c).to(dt)
    h1 = torch.where(bn.abs() < 1e-3, away, h1).contiguous()
    g = t(r, d).to(dt).contiguous()
    w2 = t(c, d) * d ** -0.5
    vec4 = torch.stack([mean, inv, scale, bias])
    vec6 = torch.cat([vec4, t(2, c) * 0.1])
    rowmask = ragged_mask(rng, b, n, int(0.78 * n), dev).reshape(-1).to(torch.uint8)
    return g, h1, w2, vec4, vec6, rowmask


def check_dh2(rng, dev, report, card):
    """The two instantiations of ``tl_dh2_kernel`` (``bn_backward_sums``,
    ``dh1_kernel``) against their plain twins at the train shape (R =
    32768, D = 128) in f32, at an odd row count and at D = 32 / 96 (the
    chunked form), and in bfloat16 at the train shape, each bit-equal over
    two runs; then each one's device ms a launch from torch.profiler at the
    train shape beside its bound, its twin and ``torch.matmul(g, w2.t())``
    in a CUDA graph (the product only: no PyTorch call forms the
    epilogue)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    cases = [(64, 512, 128, torch.float32), (3, 333, 128, torch.float32),
             (2, 100, 32, torch.float32), (2, 70, 96, torch.float32),
             (64, 512, 128, torch.bfloat16)]
    worst = {"sums": 0.0, "dh1": 0.0}
    for b, n, d, dt in cases:
        g, h1, w2, vec4, vec6, rowmask = dh2_operands(rng, dev, b, n, d, dt)
        got = [T.bn_backward_sums(g, h1, w2, vec4),
               T.dh1_kernel(g, h1, w2, vec6, rowmask)]
        again = [T.bn_backward_sums(g, h1, w2, vec4),
                 T.dh1_kernel(g, h1, w2, vec6, rowmask)]
        ref = [T.bn_backward_sums_plain(g, h1, w2, vec4),
               T.dh1_reference(g, h1, w2, vec6, rowmask)]
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"dh2 kernels {b}x{n} D={d} {dt} differ from run to run")
        errs = [_rel_err(x, y) for x, y in zip(got, ref)]
        name = f"tl_dh2_kernel {b}x{n} D={d} {str(dt).split('.')[-1]}"
        print(f"{name}: sums / dh1 max rel err {errs[0]:.3e} / {errs[1]:.3e} "
              f"(tol {TOL['train_layer_grad']:g}); bit-equal over two runs")
        require(max(errs) <= TOL["train_layer_grad"], f"{name} disagrees")
        if d == 128 and dt == torch.float32 and n == 512:
            worst = dict(sums=errs[0], dh1=errs[1])

    b, n, d = 64, 512, 128
    r, c = b * n, 2 * d
    g, h1, w2, vec4, vec6, rowmask = dh2_operands(rng, dev, b, n, d, torch.float32)
    ms = {"sums": kernel_ms_by_name(lambda: T.bn_backward_sums(g, h1, w2, vec4),
                                    ["tl_dh2_kernel", "partial_reduce_kernel"], reps=10),
          "dh1": kernel_ms_by_name(lambda: T.dh1_kernel(g, h1, w2, vec6, rowmask),
                                   ["tl_dh2_kernel"], reps=10)}
    plain = {"sums": cuda_ms(lambda: T.bn_backward_sums_plain(g, h1, w2, vec4)),
             "dh1": cuda_ms(lambda: T.dh1_reference(g, h1, w2, vec6, rowmask))}
    with torch.no_grad():
        library = graph_ms(lambda: torch.matmul(g, w2.t()))
    flops = 2.0 * r * c * d
    operands = 4.0 * (r * d + r * c + c * d)
    bounds = {"sums": bound(operands + 4.0 * 4 * c + 4.0 * 4 * c, flops),
              "dh1": bound(operands + 4.0 * 6 * c + r + 4.0 * r * c, flops)}
    for key, entry in (("sums", "tl_dh2_sums"), ("dh1", "tl_dh2_dh1")):
        k_ms = ms[key]["tl_dh2_kernel"][0]
        bms, by = bounds[key]
        extra = (f", its reduce partial_reduce_kernel "
                 f"{ms[key]['partial_reduce_kernel'][0]:.4f}" if key == "sums" else "")
        print(f"tl_dh2_kernel {key} on {card}, {b}x{n} D={d} f32: {k_ms:.4f} ms a "
              f"launch (profiler; before {DH2_BEFORE_MS[key]:.4f}, "
              f"{DH2_BEFORE_MS[key] / k_ms:.2f}x){extra}; bound {bms:.4f} ({by}); "
              f"twin {plain[key]:.4f}; torch.matmul(g, w2.t()) in a graph "
              f"{library:.4f} (the product only)")
        report[entry].update(ms=k_ms, plain_ms=plain[key], bound_ms=bms,
                             bound_by=by, library_ms=library,
                             max_abs_err=worst[key])
    report["_dh2"] = dict(ms={k: {n2: list(v) for n2, v in m.items()}
                              for k, m in ms.items()},
                          plain_ms=plain, library_ms_product_only=library,
                          before_ms=DH2_BEFORE_MS)


# the previous design's ms a launch of tl_h1_kernel and tl_dw2_kernel at R =
# 32768, D = 128, f32 (64x64 tiles of 4x4 a thread; profiler, this script on
# one H100 80GB HBM3 at 700 W)
H1_DW2_BEFORE_MS = {"h1": 0.2045, "dw2": 0.1250}


def off_by_one(a):
    """``a``'s values in a contiguous view that starts one element past an
    allocation's start: off the 16-byte boundary the kernels' vector loads
    need."""
    import torch
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    buf[1:] = a.reshape(-1)
    return buf[1:].view(a.shape)


def h1_operands(rng, dev, b, n, d, dt):
    """x in ``dt``, the f32 message, w1, b1 and a ragged row mask of
    ``h1_stats`` at R = b * n rows."""
    import torch
    r, c = b * n, 2 * d

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    x, msg = t(r, d).to(dt), t(r, d)
    w1, b1 = t(c, c) * c ** -0.5, t(c) * 0.1
    rowmask = ragged_mask(rng, b, n, int(0.78 * n), dev).reshape(-1).to(torch.uint8)
    return x, msg, w1, b1, rowmask


def check_h1_dw2(rng, dev, report, card):
    """``tl_h1_kernel`` (``h1_stats``: h1 and the masked sums) and
    ``tl_dw2_kernel`` (``dw2_db2``: dw2 and db2) against their plain twins
    at the train shape (R = 32768, D = 128) in f32 and bfloat16, at an odd
    row count with and without a row mask, at D = 32 / 96 and with
    unaligned operands (the general forms), each bit-equal over two runs;
    then each one's device ms a launch from torch.profiler at the train
    shape beside its previous design's, its bound, its twin and the library
    call for its product alone in a CUDA graph."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # b, n, d, dtype, row mask, unaligned
        (64, 512, 128, f32, True, False), (3, 333, 128, f32, False, False),
        (2, 100, 32, f32, True, False), (2, 70, 96, f32, True, False),
        (3, 333, 128, f32, True, True), (64, 512, 128, bf16, True, False)]
    worst = {"h1": 0.0, "dw2": 0.0}
    for b, n, d, dt, masked, unaligned in cases:
        x, msg, w1, b1, rowmask = h1_operands(rng, dev, b, n, d, dt)
        rowmask = rowmask if masked else None
        g, h1, _, vec4, _, _ = dh2_operands(rng, dev, b, n, d, dt)
        if unaligned:
            x, msg, g = off_by_one(x), off_by_one(msg), off_by_one(g)

        def run():
            return [*T.h1_stats(x, msg, w1, b1, rowmask), *T.dw2_db2(g, h1, vec4)]
        got, again = run(), run()
        ref = [*T.h1_stats_reference(x, msg, w1, b1, rowmask),
               *T.dw2_db2_reference(g, h1, vec4)]
        torch.cuda.synchronize()
        name = (f"tl_h1 / tl_dw2 {b}x{n} D={d} {str(dt).split('.')[-1]}"
                f"{'' if masked else ' no row mask'}{' unaligned' if unaligned else ''}")
        require(all(torch.equal(a, c) for a, c in zip(got, again)),
                f"{name}: differ from run to run")
        errs = [_rel_err(a.float(), c.float()) for a, c in zip(got, ref)]
        # a bf16 h1 is rounded once on each side from f32 sums in other
        # orders: one element may round the other way (train_layer_out_bf16)
        h1_tol = TOL["train_layer_out_bf16" if dt == bf16 else "train_layer_grad"]
        print(f"{name}: h1 / sums / dw2 / db2 max rel err "
              + " / ".join(f"{e:.3e}" for e in errs)
              + f" (tol {h1_tol:g} / {TOL['train_layer_grad']:g}); bit-equal over two runs")
        require(errs[0] <= h1_tol and max(errs[1:]) <= TOL["train_layer_grad"],
                f"{name} disagrees")
        if d == 128 and n == 512 and dt == f32:
            worst = dict(h1=max(errs[:2]), dw2=max(errs[2:]))

    b, n, d = 64, 512, 128
    r, c = b * n, 2 * d
    x, msg, w1, b1, rowmask = h1_operands(rng, dev, b, n, d, f32)
    g, h1, _, vec4, _, _ = dh2_operands(rng, dev, b, n, d, f32)
    ms = {"h1": kernel_ms_by_name(lambda: T.h1_stats(x, msg, w1, b1, rowmask),
                                  ["tl_h1_kernel", "partial_reduce_kernel"], reps=10),
          "dw2": kernel_ms_by_name(lambda: T.dw2_db2(g, h1, vec4),
                                   ["tl_dw2_kernel", "partial_reduce_kernel"], reps=10)}
    plain = {"h1": cuda_ms(lambda: T.h1_stats_reference(x, msg, w1, b1, rowmask)),
             "dw2": cuda_ms(lambda: T.dw2_db2_reference(g, h1, vec4))}
    xm = torch.cat([x, msg], 1)
    u = torch.relu((h1 - vec4[0]) * vec4[1] * vec4[2] + vec4[3])
    with torch.no_grad():
        library = {"h1": graph_ms(lambda: torch.addmm(b1, xm, w1)),
                   "dw2": graph_ms(lambda: torch.matmul(u.t(), g))}
    # operands in once, results out once: x, msg, w1, b1, the mask; h1, the
    # sums / h1, g, vec4; dw2, db2
    bounds = {"h1": bound(4.0 * (2 * r * d + c * c + c + r * c + 2 * c) + r,
                          2.0 * r * c * c),
              "dw2": bound(4.0 * (r * c + r * d + 4 * c + (c + 1) * d),
                           2.0 * r * c * d)}
    products = {"h1": "torch.addmm(b1, cat(x, msg), w1)",
                "dw2": "torch.matmul(u.t(), g)"}
    for key in ("h1", "dw2"):
        k_ms = ms[key][f"tl_{key}_kernel"][0]
        bms, by = bounds[key]
        print(f"tl_{key}_kernel on {card}, {b}x{n} D={d} f32: {k_ms:.4f} ms a "
              f"launch (profiler; before {H1_DW2_BEFORE_MS[key]:.4f}, "
              f"{H1_DW2_BEFORE_MS[key] / k_ms:.2f}x), its reduce "
              f"partial_reduce_kernel {ms[key]['partial_reduce_kernel'][0]:.4f}; "
              f"bound {bms:.4f} ({by}); twin {plain[key]:.4f}; {products[key]} "
              f"in a graph {library[key]:.4f} (the product only)")
        report[f"tl_{key}"].update(ms=k_ms, plain_ms=plain[key], bound_ms=bms,
                                   bound_by=by, library_ms=library[key],
                                   max_abs_err=worst[key])
    report["_h1_dw2"] = dict(ms={k: {n2: list(v) for n2, v in m.items()}
                                 for k, m in ms.items()},
                             plain_ms=plain, library_ms_product_only=library,
                             before_ms=H1_DW2_BEFORE_MS)


def fwd2_operands(rng, dev, b, n, d, dt):
    """x, h1 in ``dt`` and the f32 a, c, w2, b2 of ``bn_relu_conv2`` at R =
    b * n rows: h1 and the affine from ``dh2_operands`` (no BatchNorm output
    within 1e-3 of zero, where the ReLU is a coin toss between the kernel's
    fmaf and the twin's two roundings)."""
    import torch
    r, c = b * n, 2 * d

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    _, h1, _, vec4, _, _ = dh2_operands(rng, dev, b, n, d, dt)
    a = vec4[2] * vec4[1]
    return (t(b, n, d).to(dt), h1, a, vec4[3] - vec4[0] * a, t(c, d) * c ** -0.5,
            t(d) * 0.1)


def check_fwd2(rng, dev, report):
    """``tl_fwd2_kernel`` (``bn_relu_conv2``) against its plain twin
    ``bn_relu_conv2_reference`` at the train shape (R = 32768, D = 128) in
    f32 and bfloat16, at an odd row count, at D = 32 / 96 and with unaligned
    operands (the general form ``tl_fwd2_tiled_kernel``), each bit-equal
    over two runs. Its times are ``train_layer_kernel_rows``'."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # b, n, d, dtype, unaligned
        (64, 512, 128, f32, False), (3, 333, 128, f32, False),
        (2, 100, 32, f32, False), (2, 70, 96, f32, False),
        (3, 333, 128, f32, True), (64, 512, 128, bf16, False),
        (3, 333, 128, bf16, False)]
    worst = 0.0
    for b, n, d, dt, unaligned in cases:
        x, h1, a, c, w2, b2 = fwd2_operands(rng, dev, b, n, d, dt)
        if unaligned:
            x, h1 = off_by_one(x), off_by_one(h1)
        y, again = (T.bn_relu_conv2(x, h1, a, c, w2, b2) for _ in range(2))
        ref = T.bn_relu_conv2_reference(x, h1, a, c, w2, b2)
        torch.cuda.synchronize()
        name = (f"tl_fwd2 {b}x{n} D={d} {str(dt).split('.')[-1]}"
                f"{' unaligned' if unaligned else ''}")
        require(torch.equal(y, again), f"{name}: differs from run to run")
        require(y.shape == x.shape and y.dtype == dt, f"{name}: shape or dtype")
        err = _rel_err(y.float(), ref.float())
        # bf16: y is rounded to bf16 once on each side from f32 sums in
        # other orders (train_layer_out_bf16)
        tol = TOL["train_layer_out_bf16" if dt == bf16 else "train_layer_out"]
        print(f"{name}: y max rel err {err:.3e} (tol {tol:g}); bit-equal over "
              f"two runs")
        require(err <= tol, f"{name} disagrees")
        if (b, n, d, dt) == (64, 512, 128, f32):
            worst = err
    report["tl_fwd2"]["max_abs_err"] = worst


# the previous design's ms a launch of tl_fwd2_kernel at R = 32768, D = 128
# (64x64 tiles of 4x4 a thread; profiler, this script on one H100 80GB HBM3
# at 700 W), f32 and bfloat16 I/O
FWD2_BEFORE_MS = {"float32": 0.1025, "bfloat16": 0.0918}


def train_layer_kernel_rows(rng, dev, report, card):
    """Each kernel of ``csrc/train_layer.cu`` alone at the train shape (R =
    32768, D = 128), with f32 and with bfloat16 I/O (x, h1, g, y; msg, the
    weights and every internal f32): device ms a launch from torch.profiler,
    its bound (operands in once, results out once; f32 FMA), and at f32 the
    one PyTorch call for its product in a CUDA graph (the product only: none
    forms the epilogues; none computes the bf16-I/O function);
    ``tl_fwd2_kernel`` beside its previous design's time and, in f32, its
    twin's."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    b, n, d = 64, 512, 128
    r, c = b * n, 2 * d

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    x32, msg, g32 = t(r, d), t(r, d), t(r, d)
    w1, b1, w2, b2 = t(c, c) * c ** -0.5, t(c), t(c, d) * c ** -0.5, t(d)
    rowmask = ragged_mask(rng, b, n, 400, dev).reshape(-1).to(torch.uint8)
    a, cc = t(c).abs(), t(c)
    out = {}
    for dt, e in ((torch.float32, 4.0), (torch.bfloat16, 2.0)):
        x, g = x32.to(dt), g32.to(dt)
        h1, sums = T.h1_stats(x, msg, w1, b1, rowmask)
        vec4 = torch.stack([sums[0] / r, t(c).abs() + 0.5, a, cc])
        xm = torch.cat([x32, msg], 1)
        u = torch.relu(h1.float() * a + cc)
        rows = {
            "tl_h1_kernel": (lambda: T.h1_stats(x, msg, w1, b1, rowmask),
                             lambda: torch.addmm(b1, xm, w1),
                             e * (r * d + r * c) + 4.0 * (r * d + c * c + 3 * c) + r,
                             2.0 * r * c * c),
            "tl_fwd2_kernel": (lambda: T.bn_relu_conv2(x, h1, a, cc, w2, b2),
                               lambda: torch.addmm(b2, u, w2),
                               e * (2 * r * d + r * c) + 4.0 * (c * d + 2 * c + d),
                               2.0 * r * c * d),
            "tl_dw2_kernel": (lambda: T.dw2_db2(g, h1, vec4),
                              lambda: torch.matmul(u.t(), g32),
                              e * (r * c + r * d) + 4.0 * (4 * c + (c + 1) * d),
                              2.0 * r * c * d)}
        label = str(dt).split(".")[-1]
        for name, (fn, lib_fn, nbytes, flops) in rows.items():
            k_ms = kernel_ms_by_name(fn, [name], reps=10)[name][0]
            lib = None
            if dt == torch.float32:
                with torch.no_grad():
                    lib = graph_ms(lib_fn)
            bms, by = bound(nbytes, flops)
            lib_text = (f"library call in a graph {lib:.4f} (the product only)"
                        if lib is not None else "no library call")
            before = ""
            if name == "tl_fwd2_kernel":
                was = FWD2_BEFORE_MS[label]
                before = f" (before {was:.4f}, {was / k_ms:.2f}x)"
            print(f"{name} on {card}, {b}x{n} D={d} {label} I/O: {k_ms:.4f} ms "
                  f"a launch (profiler){before}; bound {bms:.4f} ({by}); {lib_text}")
            out[f"{name} {label}"] = dict(ms=k_ms, bound_ms=bms, bound_by=by,
                                          library_ms=lib)
            if name == "tl_fwd2_kernel" and dt == torch.float32:
                plain = cuda_ms(lambda: T.bn_relu_conv2_reference(x, h1, a, cc,
                                                                  w2, b2))
                print(f"tl_fwd2_kernel twin bn_relu_conv2_reference: {plain:.4f} ms")
                report["tl_fwd2"].update(ms=k_ms, plain_ms=plain, bound_ms=bms,
                                         bound_by=by, library_ms=lib)
        del h1, u, xm
    report["_train_layer_kernels"] = out


def gap_case(rng, dev, b, n, m):
    """Inputs of the gap-loss kernels on the card: scores, ragged row and
    column masks with the last pair's cloud 0 empty, ground truth with
    dustbin anchors (-1) in the mix, -1 on padded anchors, and positives
    that fall into masked columns and rows left as they come."""
    import torch

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    rm = ragged_mask(rng, b, n, int(0.78 * n), dev)
    cm = ragged_mask(rng, b, m, int(0.78 * m), dev)
    rm[b - 1] = False                                 # a cloud without a point
    gt0 = torch.from_numpy(rng.integers(-1, m, (b, n)).astype(np.int32)).to(dev)
    gt1 = torch.from_numpy(rng.integers(-1, n, (b, m)).astype(np.int32)).to(dev)
    gt0 = torch.where(rm, gt0, -1)
    gt1 = torch.where(cm, gt1, -1)
    return t(b, n, m), t(b, m), t(b, n), gt0, gt1, rm, cm, t(b, n), t(b, m)


# the previous design's times of the gap-loss forward (gap_fwd_kernel and
# gap_fwd_reduce_kernel: two launches and a partials scratch), in a CUDA
# graph, this script on one H100 80GB HBM3 at 700 W
GAP_FWD_BEFORE_MS = {"64x512x512": 0.1141, "8x1024x1024": 0.0614}
# ... and of the backward (gap_bwd_kernel on a grid of 32-row tiles, each
# staging the whole column side), in a CUDA graph, the same card
GAP_BWD_BEFORE_MS = {"64x512x512": 0.1027, "8x1024x1024": 0.0785}
GAP_CLUSTERS = (1, 2, 4, 8, 16)


def device_launches(fn, reps: int):
    """{kernel name: launches} on the device over ``reps`` calls of ``fn``
    under torch.profiler (after one call outside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):               # a window may come back without events
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if seen:
            break
    return seen


def gap_parity(rng, dev, b, n, m, gamma=0.5):
    """Kernels #11 and #12 at b x n x m against their formula twins (S0 /
    S1, the forward's counts exactly, dd / dbin_row / dbin_col bit for bit
    at random cotangents), with ragged masks and without, and the [B] loss
    and its gradients against ``ops/losses.gap_loss`` under autograd; two
    runs bit-equal. Returns (S0 / S1 error, cotangent error, the case's
    tensors)."""
    import torch
    from mdgat_tpu_torch.ops import losses as L
    from mdgat_tpu_torch.ops.cuda import gap_loss as G
    from mdgat_tpu_torch.ops.transport import OTScores
    case = gap_case(rng, dev, b, n, m)
    dense, br, bc, gt0, gt1, rm, cm, ds0, ds1 = case
    name = f"gap_loss {b}x{n}x{m}"
    worst_f = worst_b = 0.0
    for masks in ((rm, cm), (None, None)):
        args = (dense, br, bc, gt0, gt1, *masks, gamma)
        leaves = [t.clone().requires_grad_() for t in (dense, br, bc)]

        def run():
            s = G.fused_gap_margins(*leaves, *args[3:])
            return s, torch.autograd.grad(list(s), leaves, [ds0, ds1])

        (s0, s1), grads = run()
        (s0b, s1b), grads2 = run()
        counts = G._margins_forward(*args)[2:]
        with torch.no_grad():
            r0, r1 = G.fused_gap_margins_reference(*args)
            counts_ref = G.fused_gap_counts_reference(*args)
            grads_ref = G.fused_gap_margins_backward_reference(*args, ds0, ds1)
        torch.cuda.synchronize()
        require(torch.equal(s0, s0b) and torch.equal(s1, s1b)
                and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                f"{name}: two runs differ")
        require(all(torch.isfinite(a).all().item()
                    for a in (s0, s1, *grads)), f"{name}: non-finite")
        # elementwise, relative to max(1, |twin|): anchors whose
        # positive is masked carry sums of the order of M * 1e30
        f_err = max(((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
                    for a, r in ((s0, r0), (s1, r1)))
        b_err = max(_rel_err(a, r) for a, r in zip(grads, grads_ref))
        b_equal = all(torch.equal(a, r) for a, r in zip(grads, grads_ref))
        counts_equal = all(torch.equal(a, c) for a, c in zip(counts, counts_ref))
        tag = "masked" if masks[0] is not None else "unmasked"
        print(f"{name} {tag} (plan {G.gap_plan(b, n, m)}): S0/S1 max rel "
              f"err {f_err:.3e} (tol "
              f"{TOL['gap_margins']:g}), counts equal to the twin's "
              f"{counts_equal}, dd/dbin_row/dbin_col at random cotangents "
              f"bit-equal to the twin's {b_equal} (max rel err {b_err:.3e}); "
              f"forward and backward bit-equal over two runs")
        require(f_err <= TOL["gap_margins"], f"{name} {tag}: forward disagrees")
        require(counts_equal, f"{name} {tag}: the forward's counts disagree")
        require(b_equal, f"{name} {tag}: the backward is not its twin's bits")
        worst_f, worst_b = max(worst_f, f_err), max(worst_b, b_err)

    # the whole loss against ops/losses.gap_loss under autograd
    def loss_and_grads(fn):
        lv = [t.clone().requires_grad_() for t in (dense, br, bc)]
        ot = OTScores(*lv, torch.zeros(b, device=dev))
        loss = fn(ot, gt0.long(), gt1.long(), gamma, rm, cm)
        return loss.detach(), torch.autograd.grad(loss.sum(), lv)

    loss, lg = loss_and_grads(G.gap_loss_kernel)
    loss_ref, lg_ref = loss_and_grads(L.gap_loss)
    torch.cuda.synchronize()
    l_err = ((loss - loss_ref).abs() / loss_ref.abs().clamp_min(1.0)).max().item()
    g_err = max((a - r).abs().max().item() for a, r in zip(lg, lg_ref))
    print(f"{name} against gap_loss under autograd: loss [B] max rel err "
          f"{l_err:.3e} (tol {TOL['gap_loss']:g}), d dense / d bin_row / "
          f"d bin_col max abs err {g_err:.3e} (tol {TOL['gap_loss_grad']:g})")
    require(torch.isfinite(loss).all().item(), f"{name}: non-finite loss")
    require(l_err <= TOL["gap_loss"] and g_err <= TOL["gap_loss_grad"],
            f"{name}: disagrees with gap_loss under autograd")
    return worst_f, worst_b, case


def check_gap_loss(rng, dev, report, card):
    """Kernels #11 and #12 against their formula twins on the card (S0 / S1,
    the forward's counts exactly, dd / dbin_row / dbin_col bit for bit) and
    against ``ops/losses.gap_loss`` under autograd, at the training shape,
    the wide shapes (8 and 2 pairs of 1024 x 1024, 2 of 1500 x 1500), an odd
    one and pairs of one row or one column, where the plans change; two runs
    bit-equal; the forward one launch a call; times with their bounds at
    the training shape and 8 x 1024 x 1024, each kernel under its plan and
    each cluster size beside the clusters the card holds at once, and
    beside its previous design's time."""
    import torch
    from mdgat_tpu_torch.ops import losses as L
    from mdgat_tpu_torch.ops.cuda import gap_loss as G
    from mdgat_tpu_torch.ops.transport import OTScores

    gamma = 0.5
    worst_f = worst_b = 0.0
    times = {}
    for b, n, m in ((64, 512, 512), (8, 1024, 1024), (3, 200, 231),
                    (2, 1024, 1024), (2, 1500, 1500), (4, 1, 1), (3, 1, 300),
                    (3, 300, 1)):
        f_err, b_err, case = gap_parity(rng, dev, b, n, m, gamma)
        dense, br, bc, gt0, gt1, rm, cm, ds0, ds1 = case
        name = f"gap_loss {b}x{n}x{m}"
        if b == 64:
            worst_f, worst_b = max(worst_f, f_err), max(worst_b, b_err)
        if (b, n) not in ((64, 512), (8, 1024)):
            continue
        args = (dense, br, bc, gt0, gt1, rm, cm, gamma)
        # the forward is one launch a call: the one kernel the device runs
        # is gap_fwd_kernel, at most once a call (the profiler may miss an
        # event at the start of its window)
        seen = device_launches(lambda: G._margins_forward(*args), reps=5)
        require(0 < sum(seen.values()) <= 5
                and all("gap_fwd_kernel" in k for k in seen),
                f"{name}: the forward's device launches over five calls: {seen}")
        print(f"{name}: the forward's device kernels over five calls {seen}")
        # times: the forward launch and the backward launch, and their
        # twins, each captured in a CUDA graph (a call lasts about 0.1 ms: in
        # a host loop, and more so under autograd's own host work, the card
        # would idle between launches); the plain loss under autograd beside
        # them, by events
        cnt = G._margins_forward(*args)[2:]
        lv = [t.clone().requires_grad_() for t in (dense, br, bc)]
        ot = OTScores(*lv, torch.zeros(b, device=dev))
        gt0l, gt1l = gt0.long(), gt1.long()
        plain_loss = L.gap_loss(ot, gt0l, gt1l, gamma, rm, cm).sum()
        with torch.no_grad():
            fwd = (graph_ms(lambda: G._margins_forward(*args)),
                   graph_ms(lambda: G.fused_gap_margins_reference(*args)))
            bwd = (graph_ms(lambda: G._margins_backward(*args, *cnt, ds0, ds1)),
                   graph_ms(lambda: G.fused_gap_margins_backward_reference(
                       *args, ds0, ds1)))
            sweep = {g: (graph_ms(lambda: G._margins_forward(*args, cluster=g)),
                         G.active_clusters(m, g)) for g in GAP_CLUSTERS}
            bwd_sweep = {f"G={g}": (graph_ms(lambda: G._margins_backward(
                *args, *cnt, ds0, ds1, cluster=g)),
                G.active_clusters(m, g, backward=True)) for g in GAP_CLUSTERS}
            sweep = {f"G={g}": v for g, v in sweep.items()}
        auto_f = cuda_ms(lambda: L.gap_loss(ot, gt0l, gt1l, gamma, rm, cm), 10)
        auto_b = cuda_ms(lambda: torch.autograd.grad(plain_loss, lv,
                                                     retain_graph=True), 10)
        del plain_loss
        slab = 4.0 * b * n * m
        vec = 4.0 * b * (n + m)                  # one f32 or int32 vector pair
        vec_in = 2 * vec + b * (n + m)           # bins, ground truth, masks
        # forward: the block and the vectors in, S0 / S1 out; backward: the
        # same and ds0 / ds1 in, dd, dbin_row and dbin_col out
        bounds = (bound(slab + vec_in + vec, 8.0 * b * n * m),
                  bound(2 * slab + vec_in + 2 * vec, 8.0 * b * n * m))
        shape = f"{b}x{n}x{m}"
        was, was_b = GAP_FWD_BEFORE_MS[shape], GAP_BWD_BEFORE_MS[shape]
        times[f"gap_loss_fwd_{shape}"] = fwd
        times[f"gap_loss_bwd_{shape}"] = bwd
        print(f"gap-loss times on {card}, {shape} (ms, CUDA graphs): forward "
              f"kernel {fwd[0]:.4f} (plan {G.gap_plan(b, n, m)}; before "
              f"{was:.4f}, {was / fwd[0]:.2f}x) / twin {fwd[1]:.4f} / bound "
              f"{bounds[0][0]:.4f} ({bounds[0][1]}); backward kernel "
              f"{bwd[0]:.4f} (before "
              f"{was_b:.4f}, {was_b / bwd[0]:.2f}x) / twin {bwd[1]:.4f} / bound "
              f"{bounds[1][0]:.4f} ({bounds[1][1]}); ops/losses.gap_loss under "
              f"autograd forward {auto_f:.4f}, backward {auto_b:.4f}")
        for label, sw in (("forward", sweep), ("backward", bwd_sweep)):
            print(f"gap-loss {label} sweep on {card}, {shape}: "
                  + ", ".join(f"{g} {ms:.4f} ms ({act} clusters at once)"
                              for g, (ms, act) in sw.items()))
        report.setdefault("_gap_loss", {})[shape] = dict(
            fwd_ms=fwd[0], fwd_twin_ms=fwd[1], fwd_bound_ms=bounds[0][0],
            fwd_before_ms=was, fwd_plan=list(G.gap_plan(b, n, m)),
            fwd_sweep={str(g): list(v) for g, v in sweep.items()},
            bwd_ms=bwd[0], bwd_twin_ms=bwd[1], bwd_bound_ms=bounds[1][0],
            bwd_before_ms=was_b,
            bwd_sweep={str(g): list(v) for g, v in bwd_sweep.items()},
            gap_loss_autograd_fwd_ms=auto_f, gap_loss_autograd_bwd_ms=auto_b)
        if b == 64:
            for key, t, (ms, by) in (("gap_loss_fwd", fwd, bounds[0]),
                                     ("gap_loss_bwd", bwd, bounds[1])):
                report[key].update(ms=t[0], plain_ms=t[1], bound_ms=ms,
                                   bound_by=by, library_ms=None)
    report["gap_loss_fwd"]["max_abs_err"] = worst_f
    report["gap_loss_bwd"]["max_abs_err"] = worst_b
    report["_times_ms"].update({k: {"kernel": a, "plain": p}
                                for k, (a, p) in times.items()})


# ---------------------------------------------------------------------------
# phase 7: the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3


def train_batch(seed, count, n_points, dev):
    import torch
    from mdgat_tpu_torch.data.pipeline import (collate_pairs, model_inputs,
                                               prepare_batch)
    from mdgat_tpu_torch.data.synthetic import SyntheticDataset
    data = SyntheticDataset(n_pairs=count, n_points=n_points, seed=seed)
    host = collate_pairs(data.pairs, max_keypoints=n_points)
    return host, model_inputs(prepare_batch(host, 0.5, False, dev))


def run_steps(state, batch, steps):
    import torch
    from mdgat_tpu_torch.train import make_train_step
    step = make_train_step()
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def training(dev, report, counters):
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.data.pipeline import model_inputs, prepare_batch
    from mdgat_tpu_torch.train import create_train_state

    cfg = train_defaults(**EXACT)
    print(f"train config: L={cfg.L} D={cfg.descriptor_dim} heads={cfg.num_heads} "
          f"k={cfg.k} sinkhorn_iterations={cfg.sinkhorn_iterations} "
          f"loss={cfg.loss_method} lr={cfg.learning_rate} batch={cfg.batch_size} "
          f"max_keypoints={cfg.max_keypoints} compute={cfg.compute_dtype} "
          f"train_layer={cfg.train_layer}")
    host, batch = train_batch(1, cfg.batch_size, cfg.max_keypoints, dev)
    n_gt = int((batch["gt_matches0"] >= 0).sum())
    require(batch["keypoints0"].shape == (64, 512, 3) and n_gt > 64 * 200,
            "training batch shape or ground truth")

    def arm(label, arm_cfg, per_step):
        """TRAIN_STEPS steps from seeded weights with the counters zeroed
        just before and read just after; every counter in ``per_step`` must
        read exactly that many launches per step."""
        state = create_train_state(arm_cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        metrics = run_steps(state, batch, TRAIN_STEPS)
        wall = time.perf_counter() - t0
        launches = {name: c.read() for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"training, {label}: {TRAIN_STEPS} steps of 64 pairs x 512 "
              f"keypoints in {wall:.3f} s host wall ({n_gt} ground-truth "
              f"matches0), peak memory {peak / 2**30:.3f} GiB; launches "
              f"{launches}")
        for name, want in per_step.items():
            require(launches[name] == want * TRAIN_STEPS,
                    f"{label}: {name} {launches[name]} launches in "
                    f"{TRAIN_STEPS} steps, not {want} per step")
        for p in state.model.parameters():
            require(torch.isfinite(p).all().item(),
                    f"{label}: non-finite parameter")
        return state, metrics, launches, peak, wall

    tl_names = ("train_layer_fwd1", "train_layer_fwd2", "train_layer_bwd1",
                "train_layer_bwd1_dw2", "train_layer_bwd2")
    # the default route: the whole-layer train kernels
    state, kern, launches, peak_tl, wall = arm(
        "whole-layer train kernels", cfg,
        {"train_layer_fwd": 36, "train_layer_bwd": 36, "fused_mha_fwd": 0,
         "fused_mha_bwd": 0, "sinkhorn": 1, "sinkhorn_bwd": 1, "eval_layer": 0,
         "mha_bwd": 36, "gemm_tn": 216, **{name: 36 for name in tl_names}})
    for name in tl_names[:3] + tl_names[4:] + ("sinkhorn_bwd", "gemm_wt",
                                               "gemm_tn"):
        report[name]["launches"] = launches[name]
    for name in ("mha_bwd_rows", "mha_bwd_keys"):
        report[name]["launches"] = launches["mha_bwd"]
    report["tl_h1"]["launches"] = launches["train_layer_fwd1"]
    report["tl_fwd2"]["launches"] = launches["train_layer_fwd2"]
    report["tl_dw2"]["launches"] = launches["train_layer_bwd1_dw2"]
    report["tl_dh2_sums"]["launches"] = launches["train_layer_bwd1"]
    report["tl_dh2_dh1"]["launches"] = launches["train_layer_bwd2"]
    report["sinkhorn"]["train_launches"] = launches["sinkhorn"]
    print(f"per step: train-layer forward "
          f"{launches['train_layer_fwd'] // TRAIN_STEPS} / backward "
          f"{launches['train_layer_bwd'] // TRAIN_STEPS} / fused_mha forward "
          f"{launches['fused_mha_fwd']} / backward {launches['fused_mha_bwd']}"
          f" / sinkhorn forward {launches['sinkhorn'] // TRAIN_STEPS} / "
          f"backward {launches['sinkhorn_bwd'] // TRAIN_STEPS}; inside them "
          f"{launches['gemm'] // TRAIN_STEPS} GEMM (of them "
          f"{launches['gemm_wt'] // TRAIN_STEPS} W^T), "
          f"{launches['gemm_tn'] // TRAIN_STEPS} transposed GEMM, "
          f"{launches['topk_attention'] // TRAIN_STEPS} attention and "
          f"{launches['mha_bwd'] // TRAIN_STEPS} attention-backward (rows + "
          f"keys kernel) launches")

    # train_layer=False: fused-MHA kernel pair, plain MLP and BatchNorm
    mha_state, mha_m, mha_launches, peak_mha, _ = arm(
        "fused-MHA route (train_layer=False)", cfg.replace(train_layer=False),
        {"fused_mha_fwd": 36, "fused_mha_bwd": 36, "sinkhorn": 1,
         "sinkhorn_bwd": 1, "eval_layer": 0, "train_layer_fwd": 0,
         "train_layer_bwd": 0, "mha_bwd": 36, "gemm_tn": 144})
    for name in ("fused_mha_fwd", "fused_mha_bwd"):
        report[name]["launches"] = mha_launches[name]

    plain_state, plain, _, peak_plain, _ = arm(
        "plain path (use_kernels=False)", cfg.replace(use_kernels=False),
        {name: 0 for name in counters})

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    for label, got in (("train-layer", kern), ("fused-MHA", mha_m)):
        for i, ((lk, gk), (lp, gp)) in enumerate(zip(got, plain)):
            print(f"  {label} step {i + 1}: loss {lk:.6f} (plain {lp:.6f}), "
                  f"grad_norm {gk:.6f} (plain {gp:.6f})")
            require(np.isfinite([lk, gk]).all(), "non-finite loss or grad_norm")
            require(rel(lk, lp) <= TOL["train_loss_rel"],
                    f"{label} step {i + 1}: loss disagrees with the plain path")
            require(rel(gk, gp) <= TOL["train_grad_norm_rel"],
                    f"{label} step {i + 1}: grad_norm disagrees with the "
                    f"plain path")
        require(got[-1][0] < got[0][0], f"{label}: the loss did not fall")

    # four of the pairs: the card's train-layer kernels against the CPU,
    # where the same route takes the kernels' plain twin
    small = {k: v[:4] for k, v in host.items()}
    on_card = run_steps(create_train_state(cfg, device=dev, seed=0),
                        model_inputs(prepare_batch(small, 0.5, False, dev)), 2)
    on_cpu = run_steps(create_train_state(cfg, device="cpu", seed=0),
                       model_inputs(prepare_batch(small, 0.5, False, "cpu")), 2)
    for i, ((lk, gk), (lc, gc)) in enumerate(zip(on_card, on_cpu)):
        print(f"  4 pairs, step {i + 1}: loss {lk:.6f} (CPU {lc:.6f}), "
              f"grad_norm {gk:.6f} (CPU {gc:.6f})")
        require(rel(lk, lc) <= TOL["train_loss_rel"]
                and rel(gk, gc) <= TOL["train_grad_norm_rel"],
                f"4 pairs, step {i + 1}: the card disagrees with the CPU")
    report["_training"] = dict(
        steps=TRAIN_STEPS, wall_s=wall, launches=launches,
        launches_fused_mha_route=mha_launches, train_layer=kern,
        fused_mha=mha_m, plain=plain, card_4_pairs=on_card,
        cpu_4_pairs=on_cpu, peak_bytes_train_layer=peak_tl,
        peak_bytes_fused_mha=peak_mha, peak_bytes_plain=peak_plain)
    return state, mha_state, plain_state, batch


def profile_train(state, batch, card, report):
    """torch.profiler over one training step on the whole-layer train
    kernels: device time by kernel and the device's busy share of the
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from mdgat_tpu_torch.train import make_train_step
    step = make_train_step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    require(device_ms > 0, "the profiler saw no device time in a train step")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=30)
    with open(os.path.join(OUT_DIR, "profile.txt"), "a") as f:
        f.write(f"\none training step, whole-layer train kernels\n{table}\n")
    print(f"profile on {card}: 1 training step, window {window_ms:.3f} ms "
          f"host, device kernel time {device_ms:.3f} ms, busy share "
          f"{device_ms / window_ms:.3f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    # the kernels the last redesigns touched, each summed over its
    # instantiations: device ms in the step, launches, ms a launch
    by_kernel = {}
    for name in ("mha_bwd_rows_kernel", "mha_bwd_keys_kernel",
                 "gemm_tn_kernel", "tn_reduce_kernel", "sinkhorn_bwd_kernel",
                 "sinkhorn_kernel", "tl_h1_kernel", "tl_fwd2_kernel",
                 "tl_dh2_kernel", "tl_dw2_kernel", "partial_reduce_kernel"):
        hits = [e for e in events if name in e.key]
        # tl_dh2_kernel: its two instantiations apart (sums: <T, true>)
        groups = ([(f"{name} sums", [e for e in hits if "true" in e.key]),
                   (f"{name} dh1", [e for e in hits if "true" not in e.key])]
                  if name == "tl_dh2_kernel" else [(name, hits)])
        require(sum(e.count for e in hits) > 0, f"the profiled step ran no {name}")
        for label, grp in groups:
            ms = sum(e.self_device_time_total for e in grp) / 1e3
            count = sum(e.count for e in grp)
            by_kernel[label] = dict(ms=ms, launches=count,
                                    ms_a_launch=ms / max(count, 1))
            print(f"  {label}: {ms:.3f} ms in the step, {count} launches, "
                  f"{ms / max(count, 1):.4f} ms a launch ({100 * ms / device_ms:.1f}% "
                  f"of the step's device time)")
    report["_train_profile"] = dict(
        window_ms=window_ms, device_ms=device_ms, by_kernel=by_kernel,
        kernels=[dict(name=e.key[:120], count=e.count,
                      ms=e.self_device_time_total / 1e3) for e in top])


def train_layer_timings(rng, dev, report, x, g, mask, k, h):
    """Times of the four whole-layer train kernels (each the launches that
    stand for one TPU kernel) and of the whole layer forward and backward
    at the training shapes, self-attention with the key mask as the row
    mask, against plain PyTorch on the same operands; and their bounds."""
    import torch
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda import train_layer as T

    b, n, d = x.shape
    r = b * n
    layer = _random_layer(9, dev, d, h)
    with torch.no_grad():
        w = [p.clone() for p in T.train_layer_weights(layer)]
    attn, (w1, b1, w2, b2, scale, bias) = w[:8], w[8:]
    rowm = mask[:, :, None].float()
    with torch.no_grad():
        h1, thr, lse, sums = T._tl_fwd1(x, x, mask, mask, k, h, *attn, w1, b1)
        y, mean, var, cnt = T._tl_forward(x, x, mask, mask, k, h, *w)[:4]
    inv = torch.rsqrt(var + 1e-5)
    a, c = scale * inv, bias - mean * scale * inv
    vec4 = torch.stack([mean, inv, scale, bias])
    bwd_sums = T._tl_bwd1(g, h1, w2, vec4)[0]
    vec6 = torch.cat([vec4, bwd_sums[:2] / cnt])
    x2, g2, h1b = x.reshape(r, d), g.reshape(r, d), h1.reshape(b, n, 2 * d)

    def fwd1_plain():
        msg = M.fused_mha_reference(x, x, mask, k, h, *attn)
        h1p = x @ w1[:d] + msg @ w1[d:] + b1
        h1m = h1p * rowm
        return h1p, h1m.sum((0, 1)), (h1m * h1p).sum((0, 1))

    def fwd2_plain():
        return x + (torch.relu(h1b * a + c) @ w2 + b2)

    # the attention part of bwd2's plain version: autograd over a retained
    # graph of the fused-MHA twin, as the fused-MHA backward is timed
    xr = x.clone().requires_grad_()
    ar = [p.clone().requires_grad_() for p in attn]
    msg_graph = M.fused_mha_reference(xr, xr, mask, k, h, *ar)
    msg_plain = msg_graph.detach().reshape(r, d)

    def bwd2_plain():
        hhat = (h1 - mean) * inv
        big_g = (g2 @ w2.t()) * (hhat * scale + bias > 0) * scale
        dh1 = inv * (big_g - (vec6[4] + hhat * vec6[5]) * rowm.reshape(r, 1))
        dmsg, dx_mlp = dh1 @ w1[d:].t(), dh1 @ w1[:d].t()
        dw1 = torch.cat([x2, msg_plain], 1).t() @ dh1
        grads = torch.autograd.grad(msg_graph, [xr] + ar, dmsg.reshape(b, n, d),
                                    retain_graph=True)
        return g2 + dx_mlp + grads[0].reshape(r, d), dw1, dh1.sum(0), grads

    lr = [p.clone().requires_grad_() for p in [x] + w]
    y_graph = T.fused_train_layer_reference(lr[0], lr[0], mask, mask, k, h,
                                            *lr[1:])[0]
    times = {
        "train_layer_fwd1": abba_ms(
            lambda: T._tl_fwd1(x, x, mask, mask, k, h, *attn, w1, b1),
            fwd1_plain, 10),
        "train_layer_fwd2": abba_ms(
            lambda: T.bn_relu_conv2(x, h1, a, c, w2, b2), fwd2_plain, 10),
        "train_layer_bwd1": abba_ms(
            lambda: T._tl_bwd1(g, h1, w2, vec4),
            lambda: T.bn_backward_sums_reference(g, h1b, w2, mean, var, scale,
                                                 bias), 10),
        "train_layer_bwd2": abba_ms(
            lambda: T._tl_bwd2(x, x, mask, mask, thr, lse, h1, g, vec6, h,
                               *attn, w1, w2), bwd2_plain, 5),
        "train_layer_forward": abba_ms(
            lambda: T.fused_train_layer_forward(x, x, mask, mask, k, h, *w),
            lambda: T.fused_train_layer_reference(x, x, mask, mask, k, h, *w),
            10),
        "train_layer_backward": abba_ms(
            lambda: T._tl_backward(x, x, mask, mask, thr, lse, h1, mean, var,
                                   cnt, g, h, *attn, w1, w2, scale, bias),
            lambda: torch.autograd.grad(y_graph, lr, g, retain_graph=True), 5),
    }
    del y_graph, msg_graph

    # the whole-layer backward alone at k = 128 and dense, by events and in a
    # CUDA graph (no host work between its 27 launches)
    for kk in (k, None):
        with torch.no_grad():
            (_, mean_k, var_k, cnt_k, h1_k, thr_k,
             lse_k) = T._tl_forward(x, x, mask, mask, kk, h, *w)[:7]

            def bwd():
                return T._tl_backward(x, x, mask, mask, thr_k, lse_k, h1_k,
                                      mean_k, var_k, cnt_k, g, h, *attn, w1,
                                      w2, scale, bias)
            ev, gr = cuda_ms(bwd, reps=10), graph_ms(bwd, reps=5, replays=3)
        print(f"whole-layer backward k{kk or 0}: {ev:.4f} ms by events, "
              f"{gr:.4f} ms in a CUDA graph")
        report.setdefault("_train_layer_backward_ms", {})[f"k{kk or 0}"] = dict(
            events=ev, graph=gr)

    # bounds, counting what this run's masks need (see train_timings): the
    # fused-MHA bounds plus the MLP products, which run over every row
    keys = mask.sum().item()
    kept = torch.clamp(mask.sum(1), max=k).sum().item() * h * n
    dh = d // h
    proj_q, proj_k = 2.0 * r * d * d, 2.0 * keys * d * d
    score = 2.0 * h * n * dh * keys
    act, hid = 4.0 * r * d, 4.0 * r * 2 * d
    wa, wmlp = 4.0 * 4 * (d * d + d), 4.0 * (4 * d * d + 2 * d * d + 7 * d)
    res = 2 * 4.0 * b * h * n                                   # thr and lse
    mlp = 2.0 * r * d * 2 * d             # one [R, D] x [D, 2D] product
    bounds = {
        # x, weights and masks in; h1, thr, lse and the sums out
        "train_layer_fwd1": (act + wa + wmlp + 2 * b * n + hid + res,
                             2 * proj_q + 2 * proj_k + score
                             + 2.0 * kept * dh + 2 * mlp),
        "train_layer_fwd2": (2 * act + hid + wmlp, mlp),
        # g, h1 in; dh2 and dw2
        "train_layer_bwd1": (act + hid + wmlp, 2 * mlp),
        # x, g, h1, thr, lse in; dx, dsrc and the weight gradients out;
        # dh2 again, dmsg, dx_mlp, dw1x, dw1m, the message again
        "train_layer_bwd2": (4 * act + hid + res + 2 * b * n + 2 * (wa + wmlp),
                             5 * proj_q + 6 * proj_k + score
                             + 5 * 2.0 * kept * dh + 5 * mlp + proj_q),
    }
    for name, (nbytes, flops) in bounds.items():
        ms, by = bound(nbytes, flops)
        report[name].update(ms=times[name][0], plain_ms=times[name][1],
                            bound_ms=ms, bound_by=by, library_ms=None)
    return times


def train_timings(rng, dev, report, card, state, mha_state, plain_state, batch):
    """Times of the training kernels at the training shapes and of the
    whole step (whole-layer train kernels / the same with the gap-loss
    kernels / fused-MHA route / plain, in turns), with each kernel's
    bound."""
    import torch
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    from mdgat_tpu_torch.train import make_train_step

    b, n, d, h, dh, k = 64, 512, 128, 4, 32, 128

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    w = _random_attn(3, dev, d, h)
    x, g = t(b, n, d), t(b, n, d)
    mask = ragged_mask(rng, b, n, 400, dev)
    times = {}
    for kk in (k, None):
        tag = f"k{kk or 0}"
        times[f"fused_mha_fwd_{tag}"] = abba_ms(
            lambda: M.fused_mha_forward(x, x, mask, kk, h, *w),
            lambda: M.fused_mha_reference(x, x, mask, kk, h, *w), 10)
        # backward alone: the kernel launches on saved residuals; the twin's
        # autograd walk over a retained graph
        _, thr, lse = M.fused_mha_forward(x, x, mask, kk, h, *w)
        xr = x.clone().requires_grad_()
        wr = [p.clone().requires_grad_() for p in w]
        out_ref = M.fused_mha_reference(xr, xr, mask, kk, h, *wr)
        times[f"fused_mha_bwd_{tag}"] = abba_ms(
            lambda: M._mha_backward(x, x, mask, thr, lse, g, h, *w[:7]),
            lambda: torch.autograd.grad(out_ref, [xr] + wr, g,
                                        retain_graph=True), 5)
        del out_ref

    scores = t(b, n, n)
    cot = [t(b, n, n), t(b, n), t(b, n), t(b)]
    graphs = {}
    for name, fn in (("kernel", S.log_optimal_transport_kernel),
                     ("plain", S.log_optimal_transport_reference)):
        sc = scores.clone().requires_grad_()
        alpha = torch.tensor(1.0, device=dev, requires_grad=True)
        graphs[name] = (list(fn(sc, alpha, 20, mask, mask)), [sc, alpha])
    times["sinkhorn_bwd_64x512x512"] = abba_ms(
        lambda: torch.autograd.grad(*graphs["kernel"], cot, retain_graph=True),
        lambda: torch.autograd.grad(*graphs["plain"], cot, retain_graph=True), 3)
    del graphs
    times["sinkhorn_fwd_64x512x512"] = abba_ms(
        lambda: S.log_optimal_transport_kernel(scores, 1.0, 20, mask, mask),
        lambda: S.log_optimal_transport_reference(scores, 1.0, 20, mask, mask), 3)

    times.update(train_layer_timings(rng, dev, report, x, g, mask, k, h))

    # a fourth arm: the default route with the gap loss on its kernels
    from mdgat_tpu_torch.train import create_train_state
    loss_state = create_train_state(
        state.model.config.replace(loss_kernel=True), device=dev, seed=0)
    step = make_train_step()
    t_tl, t_loss, t_mha, t_plain = turns_ms(
        [lambda: step(state, batch), lambda: step(loss_state, batch),
         lambda: step(mha_state, batch), lambda: step(plain_state, batch)], 2)
    times["train_step_64x512"] = (t_tl, t_plain)
    times["train_step_64x512_loss_kernel"] = (t_loss, t_plain)
    times["train_step_64x512_fused_mha_route"] = (t_mha, t_plain)

    print(f"training times on {card} (CUDA events, ms per call; kernel / plain):")
    for key, (t_k, t_p) in times.items():
        print(f"  {key}: {t_k:.4f} / {t_p:.4f}")
    print(f"train step, four arms in turns: whole-layer train kernels "
          f"{t_tl:.4f} ms, the same with loss_kernel=True {t_loss:.4f} ms, "
          f"fused-MHA route {t_mha:.4f} ms, plain {t_plain:.4f} ms")
    prof = report["_train_profile"]
    print(f"train step, default route: {t_tl:.4f} ms by events; the profiled "
          f"step had {prof['device_ms']:.3f} ms of device time in a "
          f"{prof['window_ms']:.3f} ms window, busy share "
          f"{prof['device_ms'] / prof['window_ms']:.3f}: "
          f"{'the device' if prof['device_ms'] / prof['window_ms'] > 0.9 else 'the host'}"
          f" sets the pace")
    report["_times_ms"].update({key: {"kernel": a, "plain": p}
                                for key, (a, p) in times.items()})

    # bounds at the timed shapes, counting what this run's mask needs:
    # scores against valid keys only, the (row, key) entries the mask and k
    # keep, and key-side products (k, v, dsrc, dwk, dwv) over valid keys
    # only. The timed calls are self-attention: x is read once.
    keys = mask.sum().item()
    kept = torch.clamp(mask.sum(1), max=k).sum().item() * h * n
    proj_q, proj_k = 2.0 * b * n * d * d, 2.0 * keys * d * d
    score = 2.0 * h * n * dh * keys
    act = 4.0 * b * n * d
    # forward: x in, out out; weights, mask; thr and lse out
    fwd_bytes = 2 * act + 4 * 4 * (d * d + d) + b * n + 2 * 4 * b * h * n
    # q and merge; k and v; scores; e @ v
    fwd_flops = 2 * proj_q + 2 * proj_k + score + 2.0 * kept * dh
    # backward: x, g, thr, lse in; dx, dsrc and the weight gradients out
    bwd_bytes = 4 * act + 2 * 4 * 4 * (d * d + d) + b * n + 2 * 4 * b * h * n
    # q, do, dx, dwq, dwm; k, v, the two halves of dsrc, dwk, dwv; scores;
    # o, dp, dq, dk, dv over kept entries
    bwd_flops = 5 * proj_q + 6 * proj_k + score + 5 * 2.0 * kept * dh
    slab = 4.0 * b * n * n
    valid = (mask.sum(1).float() ** 2).sum().item()
    sk_fwd_flops = 20 * 2 * 5.0 * valid
    sk_bwd_flops = sk_fwd_flops + 20 * 14.0 * valid
    for name, key, nbytes, flops in (
            ("fused_mha_fwd", "fused_mha_fwd_k128", fwd_bytes, fwd_flops),
            ("fused_mha_bwd", "fused_mha_bwd_k128", bwd_bytes, bwd_flops),
            ("sinkhorn_bwd", "sinkhorn_bwd_64x512x512", 3 * slab, sk_bwd_flops)):
        ms, by = bound(nbytes, flops)
        report[name].update(ms=times[key][0], plain_ms=times[key][1],
                            bound_ms=ms, bound_by=by, library_ms=None)
    report["_bounds_train"] = dict(
        sinkhorn_fwd_64x512x512=bound(2 * slab, sk_fwd_flops))


# ---------------------------------------------------------------------------
# phase 8: the training entry point over a KITTI-layout dataset
# ---------------------------------------------------------------------------

CLI_EPOCHS, CLI_STEPS = 2, 3


def native_loader_parity(root, kp_dir):
    """The native loader builds on this machine, and the first batches of
    the train split through it equal the numpy path's, bit for bit."""
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.data.pipeline import SparseDataset
    from mdgat_tpu_torch.native import native_available
    require(native_available(), "the native loader did not build (g++)")
    ds = SparseDataset(train_defaults(
        train_path=root, keypoints_path=kp_dir, memory_is_enough=False,
        txt_path=os.path.join(root, "preprocess-random-full")), "train")
    t0 = time.perf_counter()
    fast = [b for b, _ in zip(ds.batches(64, shuffle=True, seed=1), range(2))]
    t1 = time.perf_counter()
    slow = [b for b, _ in zip(ds.batches(64, shuffle=True, seed=1,
                                         use_native=False), range(2))]
    t2 = time.perf_counter()
    for a, b in zip(fast, slow):
        require(sorted(a) == sorted(b) and all(
            a[k] == b[k] if k == "sequence" else np.array_equal(a[k], b[k])
            and a[k].dtype == b[k].dtype for k in b),
            "native loader: a batch differs from the numpy path's")
    print(f"native loader: 2 train batches of 64 pairs x 512 keypoints equal "
          f"to the numpy path's bit for bit; host time {1e3 * (t1 - t0) / 2:.1f} "
          f"ms a batch (numpy path {1e3 * (t2 - t1) / 2:.1f} ms)")


def train_cli(dev, report, counters, card):
    """``train_torch.main`` on the card at full width, over a synthetic
    KITTI-layout dataset written here: launch counts per train and
    validation step with ``--loss_kernel true``, falling epoch loss,
    checkpoints that read back, and the same run with ``--loss_kernel
    false``; the loop's wall time per step beside the bare step's."""
    import contextlib
    import shutil
    import torch
    import train_torch
    from mdgat_tpu_torch.core.checkpoint import load_train_checkpoint
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    from mdgat_tpu_torch.native import NativeLoader
    from mdgat_tpu_torch.train import create_train_state

    root = os.path.join(OUT_DIR, "kitti_synthetic")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    # 64 pairs per sequence: seq 9 fills one validation batch
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                                   frames_per_seq=12, pairs_per_seq=64,
                                   n_points=512, seed=0)
    print(f"train_cli: synthetic KITTI-layout dataset under "
          f"chip_smoke_out/kitti_synthetic in {time.perf_counter() - t0:.1f} s")

    def run(loss_kernel: bool):
        out = os.path.join(OUT_DIR, f"checkpoint_loss_kernel_{loss_kernel}")
        shutil.rmtree(out, ignore_errors=True)
        # the disk path: the keypoint files of every batch through the
        # native loader's threads
        argv = ["--train_path", root, "--keypoints_path", kp_dir,
                "--txt_path", os.path.join(root, "preprocess-random-full"),
                "--model_out_path", out, "--device", str(dev),
                "--batch_size", "64", "--max_keypoints", "512",
                "--epoch", str(CLI_EPOCHS), "--steps_per_epoch", str(CLI_STEPS),
                "--seed", "0", "--loss_kernel", str(loss_kernel).lower(),
                "--memory_is_enough", "false", *EXACT_ARGV]
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        native = NativeLoader.batches_loaded
        with contextlib.chdir(OUT_DIR):              # ./logs lands here
            summary = train_torch.main(argv)
        torch.cuda.synchronize()
        summary["native_batches"] = NativeLoader.batches_loaded - native
        return summary, {name: c.read() for name, c in counters.items()}

    native_loader_parity(root, kp_dir)
    summary, launches = run(True)
    require(summary["native_batches"] > 0,
            "train_cli: no batch came through the native loader")
    print(f"train_cli: {summary['native_batches']} batches read by the "
          f"native loader (train, validation and the prefetch thread's "
          f"look-ahead)")
    n_train = sum(summary["steps"])
    n_val = CLI_EPOCHS * max(1, CLI_STEPS // 4)
    print(f"train_cli, --loss_kernel true: {n_train} train steps and {n_val} "
          f"validation steps of 64 pairs x 512 keypoints; launches {launches}")
    require(summary["steps"] == [CLI_STEPS] * CLI_EPOCHS, "train_cli: steps")
    want = {"train_layer_fwd": 36 * n_train, "train_layer_bwd": 36 * n_train,
            "sinkhorn": n_train + n_val, "sinkhorn_bwd": n_train,
            "gap_loss_fwd": n_train + n_val, "gap_loss_bwd": n_train,
            "eval_layer": 36 * n_val, "fused_mha_fwd": 0, "fused_mha_bwd": 0,
            "mha_bwd": 36 * n_train, "gemm_tn": 216 * n_train}
    for name, count in want.items():
        require(launches[name] == count,
                f"train_cli: {name} {launches[name]} launches, not {count} "
                f"(per train step 36 / 36 whole-layer, 1 / 1 Sinkhorn, 1 / 1 "
                f"gap loss; per validation step 36 eval layers, 1, 1)")
    report["gap_loss_fwd"]["launches"] = launches["gap_loss_fwd"]
    report["gap_loss_bwd"]["launches"] = launches["gap_loss_bwd"]

    losses, vals = summary["epoch_loss"], summary["val_loss"]
    print(f"train_cli: epoch_loss {losses}, val_loss {vals}")
    require(np.isfinite(losses + vals).all(), "train_cli: non-finite loss")
    require(losses[1] < losses[0], "train_cli: the epoch loss did not fall")
    require(len(summary["checkpoints"]) == CLI_EPOCHS
            and all(os.path.isfile(f) for f in summary["checkpoints"]),
            "train_cli: a checkpoint is missing")
    final = summary["state"].model.state_dict()
    for i, path in enumerate(summary["checkpoints"]):
        back = create_train_state(train_defaults(), device=dev, seed=1)
        meta = load_train_checkpoint(path, back)
        require(meta["epoch"] == i + 1 and meta["lr_schedule"] == 1e-4
                and abs(meta["loss"] - vals[i]) < 1e-12,
                f"train_cli: checkpoint fields of epoch {i + 1}")
        if i == CLI_EPOCHS - 1:
            for key, v in back.model.state_dict().items():
                require(torch.equal(v, final[key]),
                        f"train_cli: {key} differs after save and load")
            require(back.step == n_train, "train_cli: optimizer steps")
    print(f"train_cli: {CLI_EPOCHS} checkpoints read back, the last one equal "
          f"to the final parameters entry by entry "
          f"({os.path.basename(summary['checkpoints'][-1])})")
    del final, back
    summary.pop("state")

    plain, plain_launches = run(False)
    plain.pop("state")
    require(plain_launches["gap_loss_fwd"] == 0
            and plain_launches["gap_loss_bwd"] == 0
            and plain_launches["train_layer_fwd"] == 36 * n_train
            and plain_launches["sinkhorn_bwd"] == n_train,
            "train_cli: launches with --loss_kernel false")
    for a, b2 in zip(losses + vals, plain["epoch_loss"] + plain["val_loss"]):
        require(abs(a - b2) <= TOL["train_loss_rel"] * abs(b2),
                f"train_cli: --loss_kernel true {a} vs false {b2}")
    print(f"train_cli, --loss_kernel false: epoch_loss {plain['epoch_loss']}, "
          f"val_loss {plain['val_loss']} (within {TOL['train_loss_rel']:g} "
          f"relative); no gap-loss launch")

    bare = report["_times_ms"]["train_step_64x512"]["kernel"]
    for label, sm in (("true", summary), ("false", plain)):
        per_step = [1e3 * t / n for t, n in zip(sm["train_loop_s"], sm["steps"])]
        tm = sm["timer"]
        print(f"train_cli on {card}, --loss_kernel {label}: loop wall per "
              f"step, synchronised at the epoch end, "
              f"{' / '.join(f'{x:.2f}' for x in per_step)} ms (epochs 1 / 2) "
              f"against the bare make_train_step {bare:.2f} ms; host "
              f"prepare {1e3 * tm['prepare']['mean']:.2f} ms mean, step "
              f"enqueue {1e3 * tm['train_step']['mean']:.2f} ms mean")
        sm["loop_ms_per_step"] = per_step
    report["_train_cli"] = dict(loss_kernel=summary, plain_loss=plain,
                                launches=launches, bare_step_ms=bare)


# ---------------------------------------------------------------------------
# phase 9: the eval entry points over a KITTI-layout dataset
# ---------------------------------------------------------------------------

# 200 test pairs in batches of 64: three full batches and a tail of 8, which
# the pipeline pads to 64 and trims again
EVAL_PAIRS, EVAL_BATCH = 200, 64


def matching_checkpoint(path: str) -> str:
    """A ``.pth`` of the flagship model that matches the synthetic data
    without training: seeded weights, then the descriptor encoder passes
    the normalised FPFH descriptor through (identity into its first 33
    channels, centred by its last conv), the keypoint encoder's and each
    GNN layer's last conv scaled down, and the final projection about 18 x
    identity, so that corresponding keypoints score high. The same recipe
    as ``tests/test_torch_eval_cli.py``'s checkpoint."""
    import torch
    from mdgat_tpu_torch.core.config import test_defaults
    from mdgat_tpu_torch.models.mdgat import MDGAT
    model = MDGAT(test_defaults())
    model.reset_parameters(0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    eye = torch.eye(33)
    for key in ("kenc.encoder.9.weight", "kenc.encoder.9.bias"):
        sd[key] *= 0.03
    for i in range(len(model.gnn.layers)):
        sd[f"gnn.layers.{i}.mlp.3.weight"] *= 0.1
    for pos in (0, 3, 6):
        w = torch.zeros_like(sd[f"denc.encoder.{pos}.weight"])
        w[:33, :33, 0] = eye - (1.0 / 33 if pos == 6 else 0.0)
        sd[f"denc.encoder.{pos}.weight"] = w
        sd[f"denc.encoder.{pos}.bias"].zero_()
    sd["final_proj.weight"] *= 0.01
    sd["final_proj.weight"][:33, :33, 0] += 18.0 * eye
    torch.save(sd, path)
    return path


def eval_cli(dev, report, counters, card):
    """``test_torch.main`` and ``test_registration_metric_torch.main`` on the
    card at full width (the flagship model, batch 64, the test preset's 256
    keypoints) with the checkpoint the train_cli phase saved, each with
    ``--use_kernels true`` then ``false``, and ``test_torch.main --net
    superglue`` the same way: launch counts per eval batch, match agreement
    between the two runs, identical per-pair lines where the matches are
    equal, every superglue layer dense; pairs/s beside the bare forward."""
    import contextlib
    import io
    import shutil
    import torch
    import test_registration_metric_torch
    import test_torch
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    from mdgat_tpu_torch.models import gnn

    ckpt = report["_train_cli"]["loss_kernel"]["checkpoints"][-1]
    matching = matching_checkpoint(os.path.join(OUT_DIR, "matching.pth"))
    root = os.path.join(OUT_DIR, "kitti_eval")
    shutil.rmtree(root, ignore_errors=True)
    kp_dir = write_synthetic_kitti(root, seqs=(10,), frames_per_seq=12,
                                   pairs_per_seq=EVAL_PAIRS, n_points=512,
                                   seed=0)
    # --ensure_kpts_num true: every cloud cut to the preset's 256 keypoints
    base = ["--train_path", root, "--keypoints_path", kp_dir,
            "--txt_path", os.path.join(root, "preprocess-random-full"),
            "--device", str(dev),
            "--batch_size", str(EVAL_BATCH), "--ensure_kpts_num", "true",
            "--seed", "0"]
    n_batches = -(-EVAL_PAIRS // EVAL_BATCH)
    ks = []                       # the top-k of every layer call (0: dense)
    layer = gnn.fused_layer

    def spy(x, src, kv_mask, topk, w, exact=True):
        ks.append(int(topk or 0))
        return layer(x, src, kv_mask, topk, w)

    def run(label, main, extra):
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        ks.clear()
        buf = io.StringIO()
        gnn.fused_layer = spy
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                result = main(base + extra)
            torch.cuda.synchronize()
        finally:
            gnn.fused_layer = layer
        wall = time.perf_counter() - t0
        launches = {name: c.read() for name, c in counters.items()}
        out = buf.getvalue()
        with open(os.path.join(OUT_DIR, f"eval_cli_{label}.log"), "w") as f:
            f.write(out)
        tail = [line for line in out.splitlines()
                if not (line.startswith("idx") or line == "registration fail")]
        for line in tail:
            print(f"eval_cli {label}: {line}")
        require(result["n_pairs"] == EVAL_PAIRS
                and result["n_batches"] == n_batches,
                f"eval_cli {label}: {result['n_pairs']} pairs in "
                f"{result['n_batches']} batches")
        return dict(result=result, launches=launches, wall_s=wall,
                    ks=sorted(set(ks)))

    def check_pair(label, kern, plain, want_ks, min_matches):
        per = {"eval_layer": 36, "gemm": 216, "topk_attention": 36,
               "sinkhorn": 1}
        for name, launches in kern["launches"].items():
            want = per.get(name, 0) * n_batches
            require(launches == want,
                    f"eval_cli {label}: {name} {launches} launches, not "
                    f"{want} (per eval batch 36 layers, 216 GEMM, 36 "
                    f"attention, 1 Sinkhorn, no other kernel)")
        require(not any(plain["launches"].values()),
                f"eval_cli {label}: the plain run launched a kernel")
        require(kern["ks"] == want_ks,
                f"eval_cli {label}: layer top-k {kern['ks']}, not {want_ks}")
        same = total = equal_pairs = 0
        for a, b in zip(kern["result"]["pairs"], plain["result"]["pairs"]):
            require(a["idx"] == b["idx"], f"eval_cli {label}: pair order")
            same += int((a["matches0"] == b["matches0"]).sum())
            total += a["matches0"].size
            if np.array_equal(a["matches0"], b["matches0"]):
                equal_pairs += 1
                require(a["line"] == b["line"],
                        f"eval_cli {label}: idx{a['idx']} prints "
                        f"{a['line']!r} and {b['line']!r} on equal matches")
        agree = same / total
        n_set = sum(int((p["matches0"] >= 0).sum())
                    for p in kern["result"]["pairs"])
        print(f"eval_cli {label}: match agreement kernel vs plain {agree:.6f} "
              f"(min {MIN_AGREEMENT}) over {total} valid slots, {n_set} "
              f"matches0 set; {equal_pairs} of {EVAL_PAIRS} pairs with equal "
              f"matches print identical lines; launches per batch "
              f"{ {k: v // n_batches for k, v in kern['launches'].items() if v} }")
        require(agree >= MIN_AGREEMENT,
                f"eval_cli {label}: kernel run disagrees with the plain run")
        require(n_set >= min_matches * total,
                f"eval_cli {label}: {n_set} matches set, fewer than "
                f"{min_matches:g} of the valid slots")
        return agree

    out = {}
    # the trained checkpoint (6 steps: it matches next to nothing at the
    # 0.2 threshold), then the matching one, whose pairs pass and fail the
    # pose gate: the agreement and the per-pair lines are then tested on
    # real matches
    trained, fitted = ["--resume_model", ckpt], ["--resume_model", matching]
    cases = (("test", test_torch.main, trained, [0, 64, 128], 0.0),
             ("registration", test_registration_metric_torch.main, trained,
              [0, 64, 128], 0.0),
             ("test_superglue", test_torch.main,
              trained + ["--net", "superglue"], [0], 0.0),
             ("test_matching", test_torch.main, fitted, [0, 64, 128], 0.1),
             ("registration_matching", test_registration_metric_torch.main,
              fitted, [0, 64, 128], 0.1))
    bare = report["_times_ms"]["forward_64_pairs"]["kernel"]
    for label, main, extra, want_ks, min_matches in cases:
        kern = run(f"{label}_kernels", main,
                   extra + ["--use_kernels", "true", *EXACT_ARGV])
        plain = run(f"{label}_plain", main, extra + ["--use_kernels", "false"])
        agree = check_pair(label, kern, plain, want_ks, min_matches)
        if label == "test_matching":
            statuses = {}
            for p in kern["result"]["pairs"]:
                statuses[p["status"]] = statuses.get(p["status"], 0) + 1
            print(f"eval_cli {label}: statuses {statuses}")
            require(statuses.get("ok", 0) > 0,
                    f"eval_cli {label}: no pair passed the pose gate")
        if label == "registration_matching":
            require(kern["result"]["summary"]["RR"] > 0,
                    f"eval_cli {label}: registration recall 0")
        for arm, r in (("kernels", kern), ("plain", plain)):
            res = r["result"]
            steady = ((res["seconds"] - res["first_batch_s"])
                      / (res["n_batches"] - 1))
            print(f"eval_cli on {card}, {label} --use_kernels "
                  f"{arm == 'kernels'}: {EVAL_PAIRS / r['wall_s']:.1f} pairs/s "
                  f"by wall clock ({r['wall_s']:.3f} s for {EVAL_PAIRS} pairs "
                  f"in {res['n_batches']} batches of {EVAL_BATCH} x 256 "
                  f"keypoints), {1e3 * steady:.2f} ms a batch after the "
                  f"first; bare kernel forward {bare:.2f} ms a batch of 64 "
                  f"(serving phase, CUDA events)")
        out[label] = {arm: dict(launches=r["launches"], wall_s=r["wall_s"],
                                pairs_per_s=EVAL_PAIRS / r["wall_s"],
                                seconds=r["result"]["seconds"],
                                first_batch_s=r["result"]["first_batch_s"],
                                summary=r["result"]["summary"], ks=r["ks"])
                      for arm, r in (("kernels", kern), ("plain", plain))}
        out[label]["agreement"] = agree
    out["bare_forward_ms"] = bare

    # torch.profiler over one more kernel run: the card's busy share of
    # the CLI's pipeline loop (the profiler adds host time of its own)
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        r = run("test_matching_profiled", test_torch.main,
                fitted + ["--use_kernels", "true", *EXACT_ARGV])
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    loop_ms = 1e3 * r["result"]["seconds"]
    print(f"eval_cli profile on {card}: test_torch.main, matching "
          f"checkpoint, kernels: {EVAL_PAIRS} pairs, pipeline loop "
          f"{loop_ms:.3f} ms (whole call {1e3 * r['wall_s']:.3f} ms), device "
          f"kernel time {device_ms:.3f} ms ({device_ms / n_batches:.3f} a "
          f"batch), busy share of the loop {device_ms / loop_ms:.3f}")
    out["profile"] = dict(loop_ms=loop_ms, wall_ms=1e3 * r["wall_s"],
                          device_ms=device_ms,
                          busy_share=device_ms / loop_ms)
    report["_eval_cli"] = out


# ---------------------------------------------------------------------------
# phase 10: data-parallel training and multi-process eval, two ranks
# ---------------------------------------------------------------------------

# Two ranks over gloo, both on the card's one device: NCCL refuses two ranks
# on one device, gloo stages CUDA tensors through the host. This checks the
# cross-rank semantics on the card (statistics between the kernels, the
# gradient average, the row split, the eval merge), not NCCL and not scaling.
DP_WORLD, DP_STEPS, DP_EVAL_PAIRS, DP_SEED = 2, 3, 256, 20
# one plain BatchNorm call forward (count and sum, then squared deviations)
# and backward: two all-reduces each; one whole-layer call: one each way
DP_BN_REDUCTIONS = 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_flags(rank: int, port: int, world: int = DP_WORLD, seq: int = 1):
    return ["--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
            str(world), "--process_id", str(rank), "--dist_backend", "gloo",
            "--seq_parallel", str(seq)]


def start_ranks(job, label, argv=(), world: int = DP_WORLD, seq: int = 1):
    """``job`` as ``world`` rank processes of this script
    (``--rank-worker``), ``world / seq`` data rows of ``seq`` members, each
    writing ``chip_smoke_out/dp_<label>_rank<r>.{log,pt}``."""
    port = free_port()
    procs = []
    for r in range(world):
        log = open(os.path.join(OUT_DIR, f"dp_{label}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", job,
             label, str(r), str(port), str(world), str(seq), *argv],
            stdout=log, stderr=subprocess.STDOUT), log))
    return label, procs


def finish_ranks(handle, timeout: float = 600.0):
    """Wait for every rank; as soon as one fails, stop the others (they would
    wait in a collective) and fail the smoke. Each rank's result."""
    import torch
    label, procs = handle
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [p for p, _ in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        require(p.returncode == 0,
                f"data_parallel {label}: rank {r} exited {p.returncode} "
                f"(chip_smoke_out/dp_{label}_rank{r}.log)")
    return [torch.load(os.path.join(OUT_DIR, f"dp_{label}_rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def dp_batch(i, dev, rows=None, seq_block=None, n_points=512):
    """Global batch ``i`` of the phase (64 pairs x ``n_points`` keypoints,
    seeded), or the rows ``rows`` of it, prepared on ``dev`` (the ground
    truth on the whole clouds), then seq member ``s``'s block of ``S`` of
    the keypoints with ``seq_block`` ``(s, S)``."""
    from mdgat_tpu_torch.data.pipeline import (collate_pairs, model_inputs,
                                               prepare_batch)
    from mdgat_tpu_torch.data.synthetic import SyntheticDataset
    from mdgat_tpu_torch.parallel import shard_batch
    host = collate_pairs(SyntheticDataset(n_pairs=64, n_points=n_points,
                                          seed=DP_SEED + i).pairs,
                         max_keypoints=n_points)
    if rows is not None:
        host = shard_batch(host, rows)
    return shard_batch(model_inputs(prepare_batch(host, 0.5, False, dev)),
                       seq_block=seq_block)


def dp_steps(dev, group=None, steps=DP_STEPS, train_layer=True):
    """``steps`` steps of the flagship model (on the fused-MHA route with
    ``train_layer`` False) from seeded weights on the phase's global
    batches (this rank's rows of them with ``group``, and its keypoint
    block under a seq axis), the counters zeroed just before each step and
    read just after: per step (loss, grad_norm, ms by the host clock to the
    synchronised end, kernel launches, collectives), and the final
    state."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.parallel import (collective_counts,
                                          process_batch_rows, replicate)
    from mdgat_tpu_torch.train import create_train_state, make_train_step
    cfg = train_defaults(train_layer=train_layer, **EXACT)
    state = create_train_state(cfg, device=dev, seed=0)
    rows, block = None, None
    if group is not None:
        replicate(state.model, group)
        rows = process_batch_rows(cfg.batch_size, group.seq)
        if group.seq > 1:
            block = (group.seq_index, group.seq)
    step = make_train_step(group)
    counters = make_counters()
    out = []
    for i in range(steps):
        batch = dp_batch(i, dev, rows, block)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        collective_counts.clear()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        out.append(dict(loss=loss, grad_norm=gn,
                        ms=1e3 * (time.perf_counter() - t0),
                        launches=read_counts(counters),
                        collectives=dict(collective_counts)))
    return out, state


def timed_collectives(state, group, dev):
    """One more step with every all-reduce and all-gather timed by the host
    clock, the card synchronised before and after each: (step ms, ms in the
    all-reduces, their count, ms in the gathers, their count); a gather's
    backward is an all-reduce."""
    import torch
    import torch.distributed as dist
    from mdgat_tpu_torch.parallel import process_batch_rows
    from mdgat_tpu_torch.train import make_train_step
    block = (group.seq_index, group.seq) if group.seq > 1 else None
    batch = dp_batch(0, dev, process_batch_rows(64, group.seq), block)
    spent = {"all_reduce": [], "all_gather": []}
    untimed = {name: getattr(dist, name) for name in spent}

    def timer(name):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = untimed[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return work
        return timed

    torch.cuda.synchronize()
    for name in spent:
        setattr(dist, name, timer(name))
    try:
        t0 = time.perf_counter()
        make_train_step(group)(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        for name, fn in untimed.items():
            setattr(dist, name, fn)
    red, gat = spent["all_reduce"], spent["all_gather"]
    return 1e3 * step_s, 1e3 * sum(red), len(red), 1e3 * sum(gat), len(gat)


def rank_worker(argv) -> int:
    """One rank of the data_parallel and seq_parallel phases, one of
    ``world`` ranks in rows of ``seq``: ``job`` is ``step`` or ``step_mha``
    (the training step, default or fused-MHA route, on this rank's rows and
    keypoint block, as many steps as the next argument says), ``seq_eval`` (the eval forward on its keypoint block),
    or ``train`` / ``test`` / ``registration`` (that entry point's ``main``
    with the three multi-process flags, ``--seq_parallel`` and
    ``--dist_backend gloo``). Writes its result to
    ``chip_smoke_out/dp_<label>_rank<r>.pt``."""
    import contextlib
    import torch
    job, label, rank, port = argv[0], argv[1], int(argv[2]), int(argv[3])
    world, seq = int(argv[4]), int(argv[5])
    rest = list(argv[6:]) + dp_flags(rank, port, world, seq)
    if job in ("step", "step_mha", "seq_eval"):
        from mdgat_tpu_torch.parallel import (data_parallel_group,
                                              initialize_distributed,
                                              rank_device)
        initialize_distributed(f"127.0.0.1:{port}", world, rank, "gloo")
        dev = rank_device("cuda")
        torch.cuda.set_device(dev)
        group = data_parallel_group(dev, seq)
    if job == "seq_eval":
        result = seq_eval_rank(dev, group)
    elif job == "step_mha":
        steps, _ = dp_steps(dev, group, int(argv[6]), train_layer=False)
        result = dict(device=str(dev), steps=steps)
    elif job == "step":
        steps, state = dp_steps(dev, group, int(argv[6]))
        result = dict(device=str(dev), steps=steps,
                      state={k: v.to("cpu", copy=True) for k, v in
                             state.model.state_dict().items()})
        result.update(zip(("timed_step_ms", "collective_ms", "n_collectives",
                           "gather_ms", "n_gathers"),
                          timed_collectives(state, group, dev)))
    else:
        import test_registration_metric_torch
        import test_torch
        import train_torch
        main = {"train": train_torch.main, "test": test_torch.main,
                "registration": test_registration_metric_torch.main}[job]
        cwd = os.path.join(OUT_DIR, f"dp_{label}_rank{rank}")
        os.makedirs(cwd, exist_ok=True)
        with contextlib.chdir(cwd):             # ./logs of a train rank
            res = main(rest)
        if job == "train":
            result = {k: res[k] for k in ("checkpoints", "epoch_loss",
                                          "val_loss", "steps")}
        else:
            result = dict(summary=res["summary"], pairs=[
                dict(idx=p["idx"], line=p["line"], matches0=p["matches0"])
                for p in res["pairs"]])
    torch.save(result, os.path.join(OUT_DIR, f"dp_{label}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def aggregate_lines(text: str):
    keys = ("average repeatibility", "baned_data", "repeatibility,")
    return [ln for ln in text.splitlines()
            if ln.startswith(keys) or " || " in ln]


def dp_training(dev, card, counters):
    """The two-rank step against the one-process step on the same global
    batches from the same seeded weights."""
    import torch
    from mdgat_tpu_torch.models.mdgat import MDGAT
    from mdgat_tpu_torch.core.config import train_defaults
    # the one-process steps first, so that neither side's times include the
    # other's work on the card
    one, state = dp_steps(dev)
    one_state = {k: v.to("cpu", copy=True)
                 for k, v in state.model.state_dict().items()}
    del state
    ranks = finish_ranks(start_ranks("step", "step", [str(DP_STEPS)]))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    model = MDGAT(train_defaults())
    bn_calls = 2 * sum(type(m).__name__ == "BatchNorm"
                       for enc in (model.kenc, model.denc)
                       for m in enc.modules())
    layer_calls = 2 * len(model.gnn.layers)
    want_coll = {"bn": DP_BN_REDUCTIONS * bn_calls,
                 "bn_backward": DP_BN_REDUCTIONS * bn_calls,
                 "layer_bn": layer_calls, "layer_bn_backward": layer_calls,
                 "gradients": 1, "loss": 1}
    for i, o in enumerate(one):
        require(o["launches"]["train_layer_fwd"] == 36
                and o["launches"]["train_layer_bwd"] == 36
                and o["launches"]["sinkhorn"] == 1
                and o["launches"]["sinkhorn_bwd"] == 1,
                f"data_parallel: one-process step {i + 1} launches "
                f"{o['launches']}")
        for r, rk in enumerate(ranks):
            s = rk["steps"][i]
            print(f"data_parallel step {i + 1}, rank {r} of 2 (32 pairs x 512 "
                  f"keypoints, {rk['device']}): loss {s['loss']:.6f} (one "
                  f"process, 64 pairs: {o['loss']:.6f}, rel "
                  f"{rel(s['loss'], o['loss']):.2e}), grad_norm "
                  f"{s['grad_norm']:.6f} ({o['grad_norm']:.6f}, rel "
                  f"{rel(s['grad_norm'], o['grad_norm']):.2e})")
            require(np.isfinite([s["loss"], s["grad_norm"]]).all(),
                    "data_parallel: non-finite loss")
            require(rel(s["loss"], o["loss"]) <= TOL["train_loss_rel"]
                    and rel(s["grad_norm"], o["grad_norm"])
                    <= TOL["train_grad_norm_rel"],
                    f"data_parallel step {i + 1}, rank {r}: the two-rank "
                    f"step disagrees with the one-process step")
            require(s["launches"] == o["launches"],
                    f"data_parallel step {i + 1}, rank {r}: launches "
                    f"{s['launches']}, one process {o['launches']}")
            require(s["collectives"] == want_coll,
                    f"data_parallel step {i + 1}, rank {r}: collectives "
                    f"{s['collectives']}, not {want_coll}")
        require(ranks[0]["steps"][i]["loss"] == ranks[1]["steps"][i]["loss"]
                and ranks[0]["steps"][i]["grad_norm"]
                == ranks[1]["steps"][i]["grad_norm"],
                f"data_parallel step {i + 1}: the ranks' metrics differ")
    a, b = ranks[0]["state"], ranks[1]["state"]
    require(sorted(a) == sorted(b) == sorted(one_state),
            "data_parallel: state keys")
    for key in a:
        require(torch.equal(a[key], b[key]),
                f"data_parallel: {key} differs between the ranks after "
                f"{DP_STEPS} steps")
    gap = max(float((a[k].double() - one_state[k].double()).abs().max())
              for k in a if a[k].is_floating_point())
    print(f"data_parallel: after {DP_STEPS} steps every parameter and running "
          f"statistic ({len(a)} tensors) torch.equal across the 2 ranks; "
          f"largest gap to the one-process state {gap:.3e}")
    print(f"data_parallel: per step and rank {one[0]['launches']['train_layer_fwd']} "
          f"+ {one[0]['launches']['train_layer_bwd']} whole-layer, "
          f"{one[0]['launches']['gemm']} GEMM, {one[0]['launches']['gemm_tn']} "
          f"A^T, {one[0]['launches']['sinkhorn']} + "
          f"{one[0]['launches']['sinkhorn_bwd']} Sinkhorn launches (equal to "
          f"the one-process step's); collectives {want_coll}")
    step_ms = lambda steps: " / ".join(f"{s['ms']:.2f}" for s in steps)
    for r, rk in enumerate(ranks):
        print(f"data_parallel times on {card}, two ranks sharing one card; "
              f"not a scaling figure: rank {r} step ms {step_ms(rk['steps'])} "
              f"(32 pairs each), one process {step_ms(one)} (64 pairs); a "
              f"fourth step {rk['timed_step_ms']:.2f} ms, of it "
              f"{rk['collective_ms']:.2f} ms in the {rk['n_collectives']} "
              f"all-reduces (gloo, through the host; synchronised before and "
              f"after each)")
    return dict(one_process=one,
                ranks=[{k: v for k, v in rk.items() if k != "state"}
                       for rk in ranks],
                collectives=want_coll, max_state_gap=gap), one_state


def dp_train_cli(dev, report):
    """``train_torch.py`` as two ranks, 1 epoch x 3 steps of 64 pairs on the
    train_cli phase's tree: rank 0 alone writes the checkpoint, it loads,
    and the epoch's losses are those of the train_cli phase's first epoch
    (the same batches, one process, ``--loss_kernel false``)."""
    from mdgat_tpu_torch.core.checkpoint import load_train_checkpoint
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state
    import shutil
    root = os.path.join(OUT_DIR, "kitti_synthetic")
    for r in range(DP_WORLD):
        shutil.rmtree(os.path.join(OUT_DIR, f"dp_train_rank{r}"),
                      ignore_errors=True)
    argv = ["--train_path", root, "--keypoints_path",
            os.path.join(root, "keypoints", "synthetic"), "--txt_path",
            os.path.join(root, "preprocess-random-full"),
            "--batch_size", "64", "--max_keypoints", "512", "--epoch", "1",
            "--steps_per_epoch", str(CLI_STEPS), "--seed", "0",
            "--model_out_path", "ck", *EXACT_ARGV]
    t0 = time.perf_counter()
    ranks = finish_ranks(start_ranks("train", "train", argv))
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    require(len(r0["checkpoints"]) == 1 and not r1["checkpoints"],
            f"data_parallel train: checkpoints {r0['checkpoints']} / "
            f"{r1['checkpoints']}")
    require(not os.path.exists(os.path.join(OUT_DIR, "dp_train_rank1", "ck")),
            "data_parallel train: rank 1 wrote a checkpoint directory")
    path = os.path.join(OUT_DIR, "dp_train_rank0", r0["checkpoints"][0])
    meta = load_train_checkpoint(path, create_train_state(
        train_defaults(), device=dev, seed=1))
    require(meta["epoch"] == 1, "data_parallel train: checkpoint fields")
    require(r0["epoch_loss"] == r1["epoch_loss"]
            and r0["val_loss"] == r1["val_loss"] and r0["steps"] == [CLI_STEPS],
            "data_parallel train: the ranks log different losses")
    plain = report["_train_cli"]["plain_loss"]
    want = (plain["epoch_loss"][0], plain["val_loss"][0])
    got = (r0["epoch_loss"][0], r0["val_loss"][0])
    print(f"data_parallel train: train_torch.py as 2 ranks, {CLI_STEPS} steps "
          f"of 64 pairs in {wall:.1f} s wall (start-up included): epoch_loss "
          f"{got[0]:.6f}, val_loss {got[1]:.6f} on both ranks (one process, "
          f"train_cli phase epoch 1: {want[0]:.6f}, {want[1]:.6f}); rank 0 "
          f"alone wrote {os.path.basename(path)}, which loads")
    for g, w in zip(got, want):
        require(np.isfinite(g) and abs(g - w) <= TOL["train_loss_rel"] * abs(w),
                "data_parallel train: the two-rank run disagrees with the "
                "one-process run")
    return dict(epoch_loss=got[0], val_loss=got[1], one_process=want,
                wall_s=wall)


def dp_eval_argv():
    """The eval CLIs' flags of the data_parallel and seq_parallel phases
    (the tree is written by dp_eval_clis)."""
    root = os.path.join(OUT_DIR, "kitti_dp_eval")
    return ["--train_path", root, "--keypoints_path",
            os.path.join(root, "keypoints", "synthetic"), "--txt_path",
            os.path.join(root, "preprocess-random-full"), "--batch_size", "64",
            "--ensure_kpts_num", "true", "--seed", "0", "--resume_model",
            os.path.join(OUT_DIR, "matching.pth"), *EXACT_ARGV]


def dp_eval_clis(dev, report):
    """``test_torch.py`` and ``test_registration_metric_torch.py`` as two
    ranks each (four processes at once) over 256 pairs in batches of 64,
    every cloud cut to 256 keypoints: each rank's batches are the
    one-process run's batches 1-2 or 3-4, so every pair's matches are
    bit-equal, and rank 0's aggregate lines equal the one-process run's.
    Returns the phase's record and the one-process runs (aggregate lines
    and pairs), which the seq_parallel phase is held against."""
    import contextlib
    import io
    import shutil
    import test_registration_metric_torch
    import test_torch
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    root = os.path.join(OUT_DIR, "kitti_dp_eval")
    shutil.rmtree(root, ignore_errors=True)
    write_synthetic_kitti(root, seqs=(10,), frames_per_seq=12,
                          pairs_per_seq=DP_EVAL_PAIRS, n_points=512, seed=0)
    argv = dp_eval_argv()
    t0 = time.perf_counter()
    ones = {}
    handles = {job: start_ranks(job, job, argv)
               for job in ("test", "registration")}
    out = {}
    for job, main in (("test", test_torch.main),
                      ("registration", test_registration_metric_torch.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            one = main(argv + ["--device", str(dev)])
        ranks = finish_ranks(handles[job])
        logs = []
        for r in range(DP_WORLD):
            with open(os.path.join(OUT_DIR, f"dp_{job}_rank{r}.log")) as f:
                logs.append(f.read())
        want = aggregate_lines(buf.getvalue())
        require(want and aggregate_lines(logs[0]) == want,
                f"data_parallel {job}: rank 0's aggregate lines "
                f"{aggregate_lines(logs[0])} differ from one process's {want}")
        require(not aggregate_lines(logs[1]),
                f"data_parallel {job}: rank 1 printed aggregate lines")
        require(ranks[1]["summary"] is None,
                f"data_parallel {job}: rank 1 returned a summary")
        pairs = ranks[0]["pairs"] + ranks[1]["pairs"]
        require(len(pairs) == len(one["pairs"]) == DP_EVAL_PAIRS
                and [len(r["pairs"]) for r in ranks] == [128, 128],
                f"data_parallel {job}: pair counts")
        for a, b in zip(pairs, one["pairs"]):
            require(a["idx"] == b["idx"] and a["line"] == b["line"]
                    and np.array_equal(a["matches0"], b["matches0"]),
                    f"data_parallel {job}: pair idx{b['idx']} differs from "
                    f"the one-process run")
        for line in want:
            print(f"data_parallel {job}, rank 0 of 2 = one process: {line}")
        out[job] = dict(aggregates=want)
        ones[job] = (want, one["pairs"])
    wall = time.perf_counter() - t0
    print(f"data_parallel eval: both CLIs as 2 ranks over {DP_EVAL_PAIRS} "
          f"pairs (128 a rank, 2 batches of 64 x 256 keypoints): every "
          f"pair's matches0 and line bit-equal to one process, rank 0's "
          f"aggregate lines equal, rank 1's none; {wall:.1f} s wall for the "
          f"four rank processes and the two one-process runs")
    out["wall_s"] = wall
    return out, ones


def data_parallel(dev, report, counters, card):
    """Phase 10: data-parallel training and multi-process eval as two ranks
    sharing the card (gloo)."""
    t0 = time.perf_counter()
    print("data_parallel: 2 ranks over gloo on the card's one device (NCCL "
          "refuses two ranks on one device); checks the cross-rank "
          "semantics, not NCCL and not scaling")
    training, one_state = dp_training(dev, card, counters)
    out = dict(training=training)
    out["train_cli"] = dp_train_cli(dev, report)
    out["eval_clis"], eval_ones = dp_eval_clis(dev, report)
    out["wall_s"] = time.perf_counter() - t0
    print(f"data_parallel phase on {card}: {out['wall_s']:.1f} s wall")
    report["_data_parallel"] = out
    return dict(steps=training["one_process"], state=one_state,
                eval=eval_ones)


# ---------------------------------------------------------------------------
# phase 11: context parallelism (the seq axis)
# ---------------------------------------------------------------------------

# ranks of one data row split each pair's keypoints; gloo on the one device,
# as in the data_parallel phase
SEQ, SEQ_EVAL_POINTS = 2, 256


def seq_kernel_checks(rng, dev):
    """The whole-layer train kernels against their twin at a seq member's
    shape: 64 x 256 query rows against a 512-key cloud, ragged keys and
    rows, first with half the batch's query blocks all padding (a seq
    member holding the padded tail of short clouds), then with every one."""
    import torch
    half = ragged_mask(rng, 64, 256, 64, dev)
    half[::2] = False
    for label, rows in (("half the blocks", half),
                        ("every block", torch.zeros_like(half))):
        f, b1, g, z, gap, left, nrows = train_layer_case(
            rng, dev, 64, 256, 512, 128, 4, 128, False, 70, torch.float32,
            row_mask=rows)
        name = f"seq_parallel train layer 64 x 256 x 512, k 128, {label} padding"
        print(f"{name}: forward max err {f:.3e} (tol "
              f"{TOL['train_layer_out']:g}), bwd1 sums {b1:.3e}, gradients "
              f"{g:.3e} (tol {TOL['train_layer_grad']:g}), zero-bias "
              f"gradients {z:.3e} (tol {TOL['train_layer_zero_grad']:g}), "
              f"selection gap {gap:.3e}; rows left out {left} of {nrows}")
        require(f <= TOL["train_layer_out"], f"{name}: forward disagrees")
        require(b1 <= TOL["train_layer_grad"] and g <= TOL["train_layer_grad"]
                and z <= TOL["train_layer_zero_grad"],
                f"{name}: backward disagrees")
        require(gap <= TOL["mha_selection_gap"], f"{name}: selection")


def seq_collectives(model):
    """The collectives of one seq training step on each rank."""
    bn_calls = 2 * sum(type(m).__name__ == "BatchNorm"
                       for enc in (model.kenc, model.denc)
                       for m in enc.modules())
    layers = len(model.gnn.layers)
    return {"bn": DP_BN_REDUCTIONS * bn_calls,
            "bn_backward": DP_BN_REDUCTIONS * bn_calls,
            "layer_bn": 2 * layers, "layer_bn_backward": 2 * layers,
            "gradients": 1, "loss": 1, "input_gather": 1,
            "kv_gather": layers, "kv_gather_backward": layers,
            "tail_gather": 1, "tail_gather_backward": 1}


def seq_training(dev, card, one_process):
    """The flagship step as 1 x 2 ranks (three steps) and as 2 x 2 ranks
    (one step) against the one-process steps of the data_parallel phase,
    on the same global batches from the same seeded weights."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.models.mdgat import MDGAT
    one, one_state = one_process["steps"], one_process["state"]
    want = seq_collectives(MDGAT(train_defaults()))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    out = {}
    for world, steps in ((SEQ, DP_STEPS), (2 * SEQ, 1)):
        layout = f"{world // SEQ}x{SEQ}"
        t0 = time.perf_counter()
        ranks = finish_ranks(start_ranks("step", f"seq_step_{layout}",
                                         [str(steps)], world=world, seq=SEQ))
        wall = time.perf_counter() - t0
        rows = 64 // (world // SEQ)
        for i in range(steps):
            o = one[i]
            for r, rk in enumerate(ranks):
                st = rk["steps"][i]
                print(f"seq_parallel {layout} step {i + 1}, rank {r} ({rows} "
                      f"pairs x {512 // SEQ} of 512 keypoints): loss "
                      f"{st['loss']:.6f} (one process {o['loss']:.6f}, rel "
                      f"{rel(st['loss'], o['loss']):.2e}), grad_norm "
                      f"{st['grad_norm']:.6f} ({o['grad_norm']:.6f}, rel "
                      f"{rel(st['grad_norm'], o['grad_norm']):.2e})")
                require(np.isfinite([st["loss"], st["grad_norm"]]).all(),
                        "seq_parallel: non-finite loss")
                require(rel(st["loss"], o["loss"]) <= TOL["train_loss_rel"]
                        and rel(st["grad_norm"], o["grad_norm"])
                        <= TOL["train_grad_norm_rel"],
                        f"seq_parallel {layout} step {i + 1}, rank {r}: the "
                        "seq step disagrees with the one-process step")
                require(st["launches"] == o["launches"],
                        f"seq_parallel {layout} step {i + 1}, rank {r}: "
                        f"launches {st['launches']}, one process "
                        f"{o['launches']}")
                require(st["collectives"] == want,
                        f"seq_parallel {layout} step {i + 1}, rank {r}: "
                        f"collectives {st['collectives']}, not {want}")
                require((st["loss"], st["grad_norm"]) ==
                        (ranks[0]["steps"][i]["loss"],
                         ranks[0]["steps"][i]["grad_norm"]),
                        f"seq_parallel {layout}: the ranks' metrics differ")
        a = ranks[0]["state"]
        for rk in ranks[1:]:
            for key in a:
                require(torch.equal(a[key], rk["state"][key]),
                        f"seq_parallel {layout}: {key} differs between ranks")
        gap = None
        if steps == DP_STEPS:
            gap = max(float((a[k].double() - one_state[k].double()).abs().max())
                      for k in a if a[k].is_floating_point())
        print(f"seq_parallel {layout}: every parameter and running statistic "
              f"torch.equal across the {world} ranks after {steps} step(s)"
              + ("" if gap is None else
                 f"; largest gap to the one-process state {gap:.3e}")
              + f"; per step and rank the one-process launches, collectives "
              f"{want}")
        for r, rk in enumerate(ranks):
            ms = " / ".join(f"{x['ms']:.2f}" for x in rk["steps"])
            one_ms = " / ".join(f"{x['ms']:.2f}" for x in one)
            print(f"seq_parallel times on {card}, {world} ranks sharing one "
                  f"card, not a scaling figure: {layout} rank {r} step ms "
                  f"{ms} (one process, 64 pairs x 512: {one_ms}); a timed "
                  f"step "
                  f"{rk['timed_step_ms']:.2f} ms, of it {rk['gather_ms']:.2f} "
                  f"ms in {rk['n_gathers']} gathers and "
                  f"{rk['collective_ms']:.2f} ms in {rk['n_collectives']} "
                  f"all-reduces (gloo through the host, synchronised before "
                  f"and after each)")
        out[layout] = dict(ranks=[{k: v for k, v in rk.items()
                                   if k != "state"} for rk in ranks],
                           max_state_gap=gap, wall_s=wall)
    out["collectives"] = want
    out["fused_mha_1x2"] = seq_mha_step(dev, card, want)
    return out


def seq_mha_step(dev, card, want):
    """One step of the fused-MHA route (``train_layer=False``: the
    attention kernel pair, the MLP and BatchNorm plain) as 1 x 2 seq ranks
    against the same step in this process."""
    one, _ = dp_steps(dev, steps=1, train_layer=False)
    ranks = finish_ranks(start_ranks("step_mha", "seq_step_mha", ["1"],
                                     world=SEQ, seq=SEQ))
    o = one[0]
    layer_bn = want["layer_bn"]
    want = {k: v for k, v in want.items() if not k.startswith("layer_bn")}
    for k in ("bn", "bn_backward"):       # the layers' BatchNorms are plain
        want[k] += DP_BN_REDUCTIONS * layer_bn
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    for r, rk in enumerate(ranks):
        st = rk["steps"][0]
        print(f"seq_parallel 1x2 fused-MHA route, rank {r}: loss "
              f"{st['loss']:.6f} (one process {o['loss']:.6f}, rel "
              f"{rel(st['loss'], o['loss']):.2e}), grad_norm "
              f"{st['grad_norm']:.6f} ({o['grad_norm']:.6f}, rel "
              f"{rel(st['grad_norm'], o['grad_norm']):.2e}); "
              f"{st['launches']['fused_mha_fwd']} + "
              f"{st['launches']['fused_mha_bwd']} fused-MHA launches; step "
              f"{st['ms']:.2f} ms on {card} (one process {o['ms']:.2f})")
        require(rel(st["loss"], o["loss"]) <= TOL["train_loss_rel"]
                and rel(st["grad_norm"], o["grad_norm"])
                <= TOL["train_grad_norm_rel"],
                f"seq_parallel fused-MHA route, rank {r}: disagrees with one "
                "process")
        require(st["launches"] == o["launches"]
                and st["launches"]["fused_mha_fwd"] == 36,
                f"seq_parallel fused-MHA route, rank {r}: launches "
                f"{st['launches']}, one process {o['launches']}")
        require(st["collectives"] == want,
                f"seq_parallel fused-MHA route, rank {r}: collectives "
                f"{st['collectives']}, not {want}")
    return dict(ranks=[rk["steps"] for rk in ranks], one_process=one,
                collectives=want)


def seq_eval_model(dev):
    from mdgat_tpu_torch.core.config import test_defaults
    from mdgat_tpu_torch.eval.runner import eval_model
    model, source = eval_model(test_defaults(resume_model=os.path.join(
        OUT_DIR, "matching.pth"), **EXACT), dev)
    require(source == "pth", "seq_parallel: matching.pth is missing")
    return model


def seq_eval_rank(dev, group):
    """One rank of the seq eval check: the eval forward on this member's
    keypoint block of the seeded 64 x 256 batch; the whole-cloud outputs,
    the launches and the collectives of the forward."""
    import torch
    from mdgat_tpu_torch.parallel import collective_counts
    from mdgat_tpu_torch.train import make_eval_step
    model = seq_eval_model(dev)
    batch = dp_batch(0, dev, None, (group.seq_index, group.seq),
                     SEQ_EVAL_POINTS)
    step = make_eval_step(model, group.seq_group)
    step(batch)                                  # weights prepared
    torch.cuda.synchronize()
    counters = make_counters()
    for c in counters.values():
        c.reset()
    collective_counts.clear()
    out = step(batch)
    torch.cuda.synchronize()
    return dict(out={k: out[k].cpu() for k in (
        "matches0", "matches1", "matching_scores0", "matching_scores1")},
        launches=read_counts(counters), collectives=dict(collective_counts))


def seq_eval(dev, counters):
    """The eval forward at 64 x 256 as two seq ranks against one process."""
    import torch
    from mdgat_tpu_torch.train import make_eval_step
    handle = start_ranks("seq_eval", "seq_eval", world=SEQ, seq=SEQ)
    model = seq_eval_model(dev)
    batch = dp_batch(0, dev, n_points=SEQ_EVAL_POINTS)
    make_eval_step(model)(batch)
    for c in counters.values():
        c.reset()
    one = make_eval_step(model)(batch)
    torch.cuda.synchronize()
    one_launches = read_counts(counters)
    one = {k: v.cpu() for k, v in one.items()}
    ranks = finish_ranks(handle)
    out = {}
    for r, rk in enumerate(ranks):
        got = rk["out"]
        agree = float((got["matches0"] == one["matches0"]).float().mean())
        same = got["matches0"] == one["matches0"]
        gap = float((got["matching_scores0"] - one["matching_scores0"])
                    .abs()[same].max())
        bit = all(torch.equal(got[k], one[k]) for k in got)
        print(f"seq_parallel eval 64 x {SEQ_EVAL_POINTS}, rank {r} of {SEQ} "
              f"({SEQ_EVAL_POINTS // SEQ} query rows a cloud): matches0 "
              f"agreement {agree:.6f} with one process (min {MIN_AGREEMENT}),"
              f" matching_scores0 max gap {gap:.3e} where they agree (tol "
              f"1e-05); outputs bit-equal: {bit}; launches {rk['launches']}, "
              f"collectives {rk['collectives']}")
        require(agree >= MIN_AGREEMENT and gap <= 1e-5,
                f"seq_parallel eval rank {r}: disagrees with one process")
        require(rk["launches"] == one_launches,
                f"seq_parallel eval rank {r}: launches {rk['launches']}, one "
                f"process {one_launches}")
        require(rk["collectives"] == {"input_gather": 1, "kv_gather": 18,
                                      "tail_gather": 1},
                f"seq_parallel eval rank {r}: collectives {rk['collectives']}")
        out[f"rank{r}"] = dict(agreement=agree, score_gap=gap, bit_equal=bit)
    return out


def seq_clis(report, eval_ones):
    """The three entry points with ``--seq_parallel 2`` as two ranks:
    ``train_torch.py`` (1 epoch x 3 steps of 64 pairs, each rank 256 of the
    512 keypoints) against the train_cli phase's first epoch, the eval CLIs
    against the data_parallel phase's one-process runs: rank 0 prints their
    aggregate lines and every pair's line, rank 1 neither."""
    import shutil
    root = os.path.join(OUT_DIR, "kitti_synthetic")
    for r in range(SEQ):
        shutil.rmtree(os.path.join(OUT_DIR, f"dp_seq_train_rank{r}"),
                      ignore_errors=True)
    train_argv = ["--train_path", root, "--keypoints_path",
                  os.path.join(root, "keypoints", "synthetic"), "--txt_path",
                  os.path.join(root, "preprocess-random-full"),
                  "--batch_size", "64", "--max_keypoints", "512", "--epoch",
                  "1", "--steps_per_epoch", str(CLI_STEPS), "--seed", "0",
                  "--memory_is_enough", "false", "--model_out_path", "ck",
                  *EXACT_ARGV]
    t0 = time.perf_counter()
    handles = {"train": start_ranks("train", "seq_train", train_argv,
                                    world=SEQ, seq=SEQ)}
    for job in ("test", "registration"):
        handles[job] = start_ranks(job, f"seq_{job}", dp_eval_argv(),
                                   world=SEQ, seq=SEQ)
    r0, r1 = finish_ranks(handles["train"])
    require(len(r0["checkpoints"]) == 1 and not r1["checkpoints"],
            f"seq_parallel train: checkpoints {r0['checkpoints']} / "
            f"{r1['checkpoints']}")
    plain = report["_train_cli"]["plain_loss"]
    want = (plain["epoch_loss"][0], plain["val_loss"][0])
    got = (r0["epoch_loss"][0], r0["val_loss"][0])
    require(r0["epoch_loss"] == r1["epoch_loss"]
            and r0["val_loss"] == r1["val_loss"],
            "seq_parallel train: the ranks log different losses")
    print(f"seq_parallel train: train_torch.py --seq_parallel 2 as 2 ranks, "
          f"{CLI_STEPS} steps of 64 pairs x 256 of 512 keypoints a rank: "
          f"epoch_loss {got[0]:.6f}, val_loss {got[1]:.6f} (one process, "
          f"train_cli phase epoch 1: {want[0]:.6f}, {want[1]:.6f}); rank 0 "
          f"alone wrote the checkpoint")
    for g, w in zip(got, want):
        require(np.isfinite(g) and abs(g - w) <= TOL["train_loss_rel"] * abs(w),
                "seq_parallel train: the seq run disagrees with one process")
    out = dict(train=dict(epoch_loss=got[0], val_loss=got[1],
                          one_process=want))
    for job in ("test", "registration"):
        ranks = finish_ranks(handles[job])
        logs = []
        for r in range(SEQ):
            with open(os.path.join(OUT_DIR, f"dp_seq_{job}_rank{r}.log")) as f:
                logs.append(f.read())
        want_lines, one_pairs = eval_ones[job]
        require(aggregate_lines(logs[0]) == want_lines,
                f"seq_parallel {job}: rank 0's aggregate lines "
                f"{aggregate_lines(logs[0])} differ from one process's")
        require(not aggregate_lines(logs[1]) and ranks[1]["summary"] is None
                and not ranks[1]["pairs"],
                f"seq_parallel {job}: rank 1 recorded pairs or aggregates")
        pairs = ranks[0]["pairs"]
        require(len(pairs) == len(one_pairs) == DP_EVAL_PAIRS,
                f"seq_parallel {job}: {len(pairs)} pairs")
        agree = np.mean([np.array_equal(a["matches0"], b["matches0"])
                         for a, b in zip(pairs, one_pairs)])
        lines = sum(a["line"] == b["line"] for a, b in zip(pairs, one_pairs))
        require(all(a["idx"] == b["idx"] for a, b in zip(pairs, one_pairs)),
                f"seq_parallel {job}: pair order")
        require(all(a["line"] == b["line"] for a, b in zip(pairs, one_pairs)
                    if np.array_equal(a["matches0"], b["matches0"])),
                f"seq_parallel {job}: equal matches, different lines")
        require(agree >= MIN_AGREEMENT,
                f"seq_parallel {job}: {agree:.4f} of the pairs match")
        for line in want_lines:
            print(f"seq_parallel {job}, rank 0 of 2 = one process: {line}")
        print(f"seq_parallel {job}: rank 0 recorded all {len(pairs)} pairs "
              f"({agree:.4f} of them with matches0 bit-equal to one process, "
              f"{lines} equal lines), rank 1 none")
        out[job] = dict(pair_agreement=float(agree), equal_lines=int(lines))
    out["wall_s"] = time.perf_counter() - t0
    return out


def seq_parallel(rng, dev, report, card, one_process):
    """Phase 11: context parallelism, ranks of one data row splitting each
    pair's keypoints, sharing the card over gloo."""
    t0 = time.perf_counter()
    print(f"seq_parallel: rows of {SEQ} ranks split each pair's keypoints "
          "(gloo on the card's one device); checks the seq semantics, not "
          "NCCL and not scaling")
    seq_kernel_checks(rng, dev)
    out = dict(training=seq_training(dev, card, one_process))
    out["eval"] = seq_eval(dev, make_counters())
    out["clis"] = seq_clis(report, one_process["eval"])
    out["wall_s"] = time.perf_counter() - t0
    print(f"seq_parallel phase on {card}: {out['wall_s']:.1f} s wall")
    report["_seq_parallel"] = out


# ---------------------------------------------------------------------------
# phase 12: wide clouds (more than 1024 keypoints)
# ---------------------------------------------------------------------------

# key / column counts of the wide arms' parity checks
WIDE_KEYS = (1025, 1500, 4096)


def wide_attention(rng, dev):
    """The attention forward's wide arm against its twin at 1025, 1500 and
    4096 keys (the slab in shared memory) and 6000 / 8192 (in the global
    scratch), ragged masks, k = 128, 64 and dense, lse on: o, thr, lse
    within the attention tolerances off near ties, two runs bit-equal; exact
    scores (integer q and k, a power-of-two scale) with thr equal to the
    twin's bit for bit; an all-masked entry; head sizes 8 to 64 and one
    bfloat16 case. Returns the worst f32 o error."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    worst = 0.0
    cases = [(2, 4, m if m < 4096 else 1000, m, 32, k, "")
             for m in WIDE_KEYS for k in (128, 64, 0)]
    cases += [(1, 2, 40, 8192, 32, 128, ""), (1, 2, 24, 6000, 64, 0, ""),
              (2, 2, 100, 2000, 8, 16, ""), (2, 2, 300, 1500, 32, 64, "bf16"),
              (2, 2, 300, 1500, 16, 64, "ties"), (2, 2, 200, 4096, 16, 128, "ties"),
              (3, 2, 100, 1500, 32, 64, "all-masked entry")]
    for b, h, n, m, dh, k, kind in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32

        def t(*shape):
            x = rng.normal(size=shape)
            if kind == "ties":
                x = np.clip(np.round(x), -2, 2)
            return torch.from_numpy(x.astype(np.float32)).to(dev, dt)
        q, kk, v = t(b, h, n, dh), t(b, h, m, dh), t(b, h, m, dh)
        mask = ragged_mask(rng, b, m, int(0.78 * m), dev)
        if kind == "all-masked entry":
            mask[b - 1] = False
        scale = dh ** -0.5
        o, thr, lse = A.topk_attention(q, kk, v, mask, k, scale, return_lse=True)
        o2, thr2, lse2 = A.topk_attention(q, kk, v, mask, k, scale, return_lse=True)
        o_ref, thr_ref, lse_ref = A.topk_attention_reference(
            q, kk, v, mask, k, scale, return_lse=True)
        torch.cuda.synchronize()
        name = (f"wide attention {b}x{h}x{n}x{m} dh{dh} k{k}"
                f"{' ' + kind if kind else ''} (slab "
                f"{'global' if A.slab_floats(b, h, n, m, dh) else 'on chip'})")
        require(torch.equal(o, o2) and torch.equal(thr, thr2)
                and torch.equal(lse, lse2), f"{name}: two runs differ")
        require(torch.isfinite(o.float()).all().item(), f"{name}: non-finite")
        s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * scale
        valid = mask[:, None, None, :].expand(s.shape)
        if kind == "ties":
            require(torch.equal(thr, thr_ref), f"{name}: thr differs from the k-th value")
            keep = torch.ones(s.shape[:-1], dtype=torch.bool, device=dev)
        else:
            keep = ~(near_tie_rows(s, valid, k) & (valid.sum(-1) > k))
        del s, valid
        if kind == "all-masked entry":
            require(not o[b - 1].any().item() and (lse[b - 1] == -1e30).all().item()
                    and (thr[b - 1] == (1e30 if k else -1e30)).all().item(),
                    f"{name}: all-masked rows")
        err = (o.float() - o_ref.float()).abs().amax(-1)[keep].max().item()
        terr = (thr - thr_ref).abs()[..., 0][keep].max().item()
        lerr = ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0))[..., 0][keep].max().item()
        tol = TOL["attention_f32" if dt == torch.float32 else "attention_bf16"]
        print(f"{name}: max|o-o_ref| {err:.3e} max|thr-thr_ref| {terr:.3e} lse "
              f"rel {lerr:.3e} (tol {tol:g}, thr and lse "
              f"{TOL['attention_f32']:g}); rows left out "
              f"{int((~keep).sum())} of {keep.numel()}; bit-equal over two runs")
        require(err <= tol and terr <= TOL["attention_f32"]
                and lerr <= TOL["attention_f32"], f"{name} disagrees")
        if dt == torch.float32:
            worst = max(worst, err)
    return worst


def wide_attention_backward(rng, dev):
    """The attention backward (rows kernel's wide arm, keys kernel) against
    its twin at 1025, 1500, 4096 keys and 8192 (the rows kernel's slab in
    the global scratch), k = 128 / 64 / dense: o, dq, dk, dv, bit-equal
    over two runs; then the fused-MHA forward and backward under autograd at
    2 x 1500 (self) and 1025 queries x 1500 keys (cross), k = 128, with the
    attention output the backward's rows kernel rebuilds from thr and lse
    held to the forward's on every row (no entry flips). Returns the worst
    (o error, gradient error)."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import mha as M
    h, dh = 4, 32
    worst_o = worst_g = 0.0

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    for b, n, m, kk in [(2, m, m, k) for m in (1025, 1500) for k in (128, 64, 0)] + [
            (2, 1000, 4096, 128), (2, 1000, 4096, 0), (1, 64, 8192, 64)]:
        q, k, v, do = t(b, h, n, dh) * dh ** -0.5, t(b, h, m, dh), t(b, h, m, dh), t(b, h, n, dh)
        mask = ragged_mask(rng, b, m, int(0.78 * m), dev)
        with torch.no_grad():
            _, thr, lse = A.topk_attention(q, k, v, mask, kk, 1.0, return_lse=True)
            _, thr_r, lse_r = A.topk_attention_reference(q, k, v, mask, kk, 1.0,
                                                         return_lse=True)
            s = q @ k.transpose(-1, -2)
            tie = near_tie_rows(s, mask[:, None, None, :].expand(s.shape), kk)
            del s
            dz = do * (~tie)[..., None]
            got = M._attention_backward(q, k, v, dz, mask, thr, lse)
            again = M._attention_backward(q, k, v, dz, mask, thr, lse)
            ref = M.attention_backward_reference(q, k, v, dz, mask, thr_r, lse_r)
        torch.cuda.synchronize()
        name = (f"wide attention backward {b}x{h}x{n}x{m}x{dh} k{kk} (rows slab "
                f"{'global' if A.slab_floats(b, h, n, m, dh, 2) else 'on chip'})")
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{name}: two runs differ")
        require(all(torch.isfinite(x).all().item() for x in got), f"{name}: non-finite")
        keep = (~tie).permute(0, 2, 1).reshape(b * n, h)[..., None]
        o_err = ((got[0] - ref[0]).reshape(b * n, h, dh).abs() * keep).max().item()
        errs = [_rel_err(x, y) for x, y in zip(got[1:], ref[1:])]
        print(f"{name}: o max err {o_err:.3e}, dq / dk / dv max rel err "
              + " / ".join(f"{e:.3e}" for e in errs)
              + f" (tol {TOL['mha_out']:g} / {TOL['mha_grad']:g}; "
              f"{int(tie.sum())} near-tie rows of {tie.numel()} left out); "
              f"bit-equal over two runs")
        require(o_err <= TOL["mha_out"] and max(errs) <= TOL["mha_grad"],
                f"{name} disagrees with its twin")
        worst_o, worst_g = max(worst_o, o_err), max(worst_g, max(errs))
    for b, n, m, selfattn in ((2, 1500, 1500, True), (2, 1025, 1500, False)):
        fwd_err, grad_err, gap, ties, rows = mha_case(
            rng, dev, b, n, m, 128, 4, 128, selfattn, seed=31)
        print(f"wide fused MHA {b}x{n}x{m} k128 {'self' if selfattn else 'cross'}: "
              f"out/thr/lse max err {fwd_err:.3e} (tol {TOL['mha_out']:g}), "
              f"gradients max rel err {grad_err:.3e} (tol {TOL['mha_grad']:g}), "
              f"forward vs rebuilt attention output {gap:.3e} (tol "
              f"{TOL['mha_selection_gap']:g}); {ties} near-tie rows of {rows} "
              f"left out; backward bit-equal over two runs")
        require(fwd_err <= TOL["mha_out"] and grad_err <= TOL["mha_grad"],
                f"wide fused MHA {b}x{n}x{m} disagrees with its twin")
        require(gap <= TOL["mha_selection_gap"],
                f"wide fused MHA {b}x{n}x{m}: the backward kept other entries")
        worst_g = max(worst_g, grad_err)
    return worst_o, worst_g


def wide_sinkhorn(rng, dev):
    """The Sinkhorn forward's and backward's wide arms against their twin
    at 2 x 1025 x 1025, 2 x 1500 x 1500 and 2 x 1000 x 4096, ragged, 20
    iterations (and 100 at 1500; none at 1100), bit-equal over two runs
    each; the backward
    also under a cluster size the plan does not take. Returns the worst
    forward error, dZ error."""
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    worst_f = worst_b = 0.0
    for b, n, m, iters in ((2, 1025, 1025, 20), (2, 1500, 1500, 20),
                           (2, 1000, 4096, 20), (2, 1500, 1500, 100),
                           (2, 1100, 1100, 0)):
        scores = torch.from_numpy(rng.normal(size=(b, n, m)).astype(np.float32)).to(dev)
        rm = ragged_mask(rng, b, n, int(0.78 * n), dev)
        cm = ragged_mask(rng, b, m, int(0.78 * m), dev)
        ref = S.log_optimal_transport_reference(scores, 1.0, iters, rm, cm)
        scalars, lmu, lnu = S._prep(scores, torch.tensor(1.0, device=dev), rm, cm)
        first = S._forward(scores, scalars, lmu, lnu, iters)
        again = S._forward(scores, scalars, lmu, lnu, iters)
        torch.cuda.synchronize()
        name = f"wide sinkhorn {b}x{n}x{m} {iters} it (plan {S.sinkhorn_plan(b, n, m)})"
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                f"{name}: the forward differs from run to run")
        errs, pad_ok = _sinkhorn_errs(first, ref, rm, cm)
        require(pad_ok, f"{name}: padding leaked")
        # the backward, by launch, twice, under its plan and another cluster
        cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
               for shape in ((b, n, m), (b, m), (b, n), (b,))]
        dzs = [S._backward(scores, scalars, lmu, lnu, cot, iters, g)
               for g in (0, 0, 4)]
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(dzs[0], dzs[1])),
                f"{name}: the backward differs from run to run")
        g_err = _rel_err(dzs[2][0], dzs[0][0])
        require(g_err <= TOL["sinkhorn_bwd"],
                f"{name}: the backward at 4 CTAs a pair disagrees ({g_err:.3e})")
        dz_err, da_err = sinkhorn_bwd_case(rng, dev, b, n, m, iters)
        print(f"{name}: forward max err dense/bin_row/bin_col/corner "
              + " ".join(f"{e:.3e}" for e in errs)
              + f" (tol {TOL['sinkhorn_f32']:g}); backward (plan "
              f"{S.bwd_plan(b, n, m)[0]} CTAs a pair) dZ rel err {dz_err:.3e}, "
              f"dalpha rel err {da_err:.3e} (tol {TOL['sinkhorn_bwd']:g}), at 4 "
              f"CTAs a pair {g_err:.3e} from the plan's; each bit-equal over "
              f"two runs")
        require(max(errs) <= TOL["sinkhorn_f32"], f"{name}: the forward disagrees")
        require(dz_err <= TOL["sinkhorn_bwd"] and da_err <= TOL["sinkhorn_bwd"],
                f"{name}: the backward disagrees")
        worst_f, worst_b = max(worst_f, max(errs)), max(worst_b, dz_err, da_err)
    return worst_f, worst_b


def wide_times(rng, dev, card):
    """Each wide arm's time at 2 pairs x 1500 x 1500 (attention at 4 heads
    x 32, k = 128, ragged), beside its plain twin and its bound: ms by
    events (the attention backward a call of both kernels; the Sinkhorn 20
    iterations), the gap-loss kernels in CUDA graphs."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import gap_loss as G
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    b, h, n, dh, kk = 2, 4, 1500, 32, 128
    out = {}

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    q, k, v, do = t(b, h, n, dh) * dh ** -0.5, t(b, h, n, dh), t(b, h, n, dh), t(b, h, n, dh)
    mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
    with torch.no_grad():
        _, thr, lse = A.topk_attention(q, k, v, mask, kk, 1.0, return_lse=True)
        fwd = abba_ms(lambda: A.topk_attention(q, k, v, mask, kk, 1.0),
                      lambda: A.topk_attention_reference(q, k, v, mask, kk, 1.0), 10)
        bwd = abba_ms(lambda: M._attention_backward(q, k, v, do, mask, thr, lse),
                      lambda: M.attention_backward_reference(q, k, v, do, mask, thr, lse), 5)
    keys = mask.sum().item()
    kept = torch.clamp(mask.sum(1), max=kk).sum().item() * h * n
    out["attention_fwd"] = (*fwd, *bound(4 * 4.0 * b * h * n * dh + b * n + 8.0 * b * h * n,
                                         2.0 * h * n * dh * keys + 2.0 * kept * dh))
    (rb, rby), (kb, kby) = attention_backward_bounds(mask, b, h, n, n, dh, kk)
    out["attention_bwd"] = (*bwd, rb + kb, rby)
    scores = t(b, n, n)
    scalars, lmu, lnu = S._prep(scores, torch.tensor(1.0, device=dev), mask, mask)
    cot = [t(b, n, n), t(b, n), t(b, n), t(b)]
    sfwd = abba_ms(lambda: S._forward(scores, scalars, lmu, lnu, 20),
                   lambda: S.log_optimal_transport_reference(scores, 1.0, 20, mask, mask), 5)
    sbwd = cuda_ms(lambda: S._backward(scores, scalars, lmu, lnu, cot, 20), 5, 1)
    valid = (mask.sum(1).float() ** 2).sum().item()
    out["sinkhorn_fwd"] = (*sfwd, *bound(2 * 4.0 * b * n * n, 20 * 2 * 5.0 * valid))
    out["sinkhorn_bwd"] = (sbwd, None, *bound(4 * 4.0 * b * n * n, 20 * 4 * 5.0 * valid))
    dense, br, bc, gt0, gt1, rm, cm, ds0, ds1 = gap_case(rng, dev, b, n, n)
    args = (dense, br, bc, gt0, gt1, rm, cm, 0.5)
    with torch.no_grad():
        cnt = G._margins_forward(*args)[2:]
        gf = (graph_ms(lambda: G._margins_forward(*args)),
              graph_ms(lambda: G.fused_gap_margins_reference(*args)))
        gb = (graph_ms(lambda: G._margins_backward(*args, *cnt, ds0, ds1)),
              graph_ms(lambda: G.fused_gap_margins_backward_reference(*args, ds0, ds1)))
    slab, vec = 4.0 * b * n * n, 4.0 * b * 2 * n
    vec_in = 2 * vec + b * 2 * n
    out["gap_fwd"] = (*gf, *bound(slab + vec_in + vec, 8.0 * b * n * n))
    out["gap_bwd"] = (*gb, *bound(2 * slab + vec_in + 2 * vec, 8.0 * b * n * n))
    print(f"wide arms at {b} x {n} x {n} on {card} (ms: kernel / twin / bound): "
          + "; ".join(f"{key} {ms:.4f} / "
                      + (f"{pl:.4f}" if pl is not None else "-")
                      + f" / {bd:.4f} ({by})"
                      for key, (ms, pl, bd, by) in out.items()))
    return {key: dict(ms=ms, plain_ms=pl, bound_ms=bd, bound_by=by)
            for key, (ms, pl, bd, by) in out.items()}


def wide_serving(rng, dev, counters):
    """``Matcher(device="cuda").match`` on the flagship model (seeded
    weights) on two pairs of 1025 and two of 1500 keypoints (buckets 1152
    and 1536), counters zeroed just before and read just after (36 eval
    layers and 1 Sinkhorn a forward), against the same Matcher with
    ``use_kernels=False`` on the card: match agreement, and the matching
    scores where both sides match alike."""
    import torch
    from mdgat_tpu_torch import Matcher
    matcher = Matcher(seed=0, device=dev, **EXACT)
    plain = Matcher(seed=0, device=dev, use_kernels=False)
    pairs = make_pairs(rng, 2, 1025, 1025) + make_pairs(rng, 2, 1500, 1500)

    def run(m):
        return [m.match(p["kp0"], p["desc0"], p["kp1"], p["desc1"], p["score0"],
                        p["score1"]) for p in pairs]

    for c in counters.values():
        c.reset()
    outs = run(matcher)
    torch.cuda.synchronize()
    launches = {name: c.read() for name, c in counters.items()}
    forwards = len(pairs)
    require(launches["eval_layer"] == 36 * forwards
            and launches["topk_attention"] == 36 * forwards
            and launches["sinkhorn"] == forwards,
            f"wide serving: launches {launches}, not 36 layers and 1 Sinkhorn "
            f"a forward")
    check_outputs(outs, pairs)
    ref = run(plain)
    agree = agreement(outs, ref)
    score_err = max(float(np.abs(o[key] - r[key])[o[m] == r[m]].max(initial=0.0))
                    for o, r in zip(outs, ref)
                    for key, m in (("matching_scores0", "matches0"),
                                   ("matching_scores1", "matches1")))
    n_matched = sum(int((o["matches0"] >= 0).sum()) for o in outs)
    print(f"wide serving: Matcher.match on 2 pairs of 1025 and 2 of 1500 "
          f"keypoints: launches eval layer {launches['eval_layer']}, attention "
          f"{launches['topk_attention']}, Sinkhorn {launches['sinkhorn']}; "
          f"agreement with use_kernels=False {agree:.6f} (min "
          f"{MIN_AGREEMENT}); {n_matched} matches0 set; matching-score max "
          f"err where the matches agree {score_err:.3e} (tol 1e-3)")
    require(agree >= MIN_AGREEMENT, "wide serving: kernels disagree with the plain route")
    require(score_err <= 1e-3, "wide serving: matching scores disagree")
    return dict(agreement=agree, score_err=score_err, launches=launches)


def wide_training(dev, counters):
    """One training step at 2 pairs x 1500 keypoints from ``train_batch`` on
    the default whole-layer route (counters zeroed just before and read
    just after: 36 whole-layer forwards and backwards, 36 attention
    backwards, 1 + 1 Sinkhorn), against the plain route: loss and grad_norm
    within the training tolerances."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state
    cfg = train_defaults(**EXACT)
    _, batch = train_batch(5, 2, 1500, dev)
    require(batch["keypoints0"].shape == (2, 1500, 3), "wide training batch shape")
    state = create_train_state(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    (loss, gn), = run_steps(state, batch, 1)
    launches = {name: c.read() for name, c in counters.items()}
    want = {"train_layer_fwd": 36, "train_layer_bwd": 36, "mha_bwd": 36,
            "sinkhorn": 1, "sinkhorn_bwd": 1, "fused_mha_fwd": 0}
    require(all(launches[k] == v for k, v in want.items()),
            f"wide training: launches {launches}, want {want}")
    (loss_p, gn_p), = run_steps(
        create_train_state(cfg.replace(use_kernels=False), device=dev, seed=0),
        batch, 1)
    rel = lambda a, r: abs(a - r) / max(abs(r), 1e-12)
    print(f"wide training: one step of 2 pairs x 1500 keypoints, default "
          f"route: loss {loss:.6f} (plain {loss_p:.6f}, rel {rel(loss, loss_p):.2e}, "
          f"tol {TOL['train_loss_rel']:g}), grad_norm {gn:.6f} (plain "
          f"{gn_p:.6f}, rel {rel(gn, gn_p):.2e}, tol "
          f"{TOL['train_grad_norm_rel']:g}); launches {launches}")
    require(np.isfinite([loss, gn]).all(), "wide training: non-finite loss")
    require(rel(loss, loss_p) <= TOL["train_loss_rel"]
            and rel(gn, gn_p) <= TOL["train_grad_norm_rel"],
            "wide training: the kernels disagree with the plain route")
    return dict(loss=loss, grad_norm=gn, plain_loss=loss_p,
                plain_grad_norm=gn_p, launches=launches)


def wide_clouds(rng, dev, report, counters, card):
    """Phase 9: every wide arm against its twin, bit-equal from run to run,
    with its time; the serving and training paths at 1025 and 1500
    keypoints through the entry points a user calls."""
    import torch
    out = dict(attention_err=wide_attention(rng, dev))
    out["attention_bwd_err"] = wide_attention_backward(rng, dev)
    torch.cuda.empty_cache()
    out["sinkhorn_err"] = wide_sinkhorn(rng, dev)
    out["gap_err"] = [gap_parity(rng, dev, b, n, m)[:2]
                      for b, n, m in ((2, 1025, 1025), (2, 1500, 1500),
                                      (2, 1000, 4096), (1, 20000, 64))]
    out["times"] = wide_times(rng, dev, card)
    torch.cuda.empty_cache()
    out["serving"] = wide_serving(rng, dev, counters)
    torch.cuda.empty_cache()
    out["training"] = wide_training(dev, counters)
    report["_wide_clouds"] = out


# ---------------------------------------------------------------------------
# phase 13: the learned-descriptor modes and the FPFH variants
# ---------------------------------------------------------------------------

# the raw clouds' size in the KITTI files (kitti_randomsample_16384_n8)
CLOUD_POINTS = 16384
# the learned-descriptor train batch the card holds with the multi-scale
# encoder's 128-sample grouping (64 pairs would keep ~40-50 GB of BN
# activations for the backward): cut from the train preset's 64
MSG_TRAIN_PAIRS = 16
DESC_TRAIN_STEPS = 3
# the launches of one eval forward (and of a validation step, with the
# gap-loss forward under loss_kernel); every other counter reads 0
EVAL_LAUNCHES = {"eval_layer": 36, "gemm": 216, "topk_attention": 36,
                 "sinkhorn": 1}


def fpfh_step_launches(report):
    """Every counter's launches in one default-route FPFH train step, from
    the training phase's arm (three steps), with ``loss_kernel``'s gap-loss
    pair added: what a learned-descriptor step must launch too."""
    total = report["_training"]["launches"]
    require(all(v % TRAIN_STEPS == 0 for v in total.values()),
            f"training launches {total} not a multiple of {TRAIN_STEPS}")
    per = {k: v // TRAIN_STEPS for k, v in total.items()}
    per.update(gap_loss_fwd=1, gap_loss_bwd=1)
    return per


def with_clouds(host, batch, seed, dev, points=CLOUD_POINTS):
    """``batch`` with raw clouds ``cloud0`` / ``cloud1`` [B, points, 8]
    around each side's keypoints, in that side's frame: every point a
    keypoint picked at random plus N(0, 1 m) on each axis, then five N(0, 1)
    channels (the files' layout: xyz and five more)."""
    import torch
    rng = np.random.default_rng(seed)
    out = dict(batch)
    for side in "01":
        kp = host["keypoints" + side]
        b, n, _ = kp.shape
        pick = rng.integers(0, n, size=(b, points))
        xyz = (np.take_along_axis(kp, pick[..., None], axis=1)
               + rng.normal(size=(b, points, 3)))
        cloud = np.concatenate([xyz, rng.normal(size=(b, points, 5))], axis=-1)
        out["cloud" + side] = torch.from_numpy(cloud.astype(np.float32)).to(dev)
    return out


def read_counts(counters):
    return {name: c.read() for name, c in counters.items()}


def require_launches(label, launches, per, times):
    """Every counter at ``per[name] * times`` (0 where ``per`` has none)."""
    for name, got in launches.items():
        want = per.get(name, 0) * times
        require(got == want, f"{label}: {name} {got} launches, not {want} "
                             f"({per} x {times}, every other kernel 0)")


def timed_step(state, batch):
    """One ``make_train_step`` step: (loss, grad_norm, host ms to the
    read-back, peak bytes of the step)."""
    import torch
    from mdgat_tpu_torch.train import make_train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m = make_train_step()(state, batch)
    loss, gn = m["loss"].item(), m["grad_norm"].item()
    return loss, gn, (time.perf_counter() - t0) * 1e3, \
        torch.cuda.max_memory_allocated()


def compare_step(label, kern, plain):
    rel = lambda a, r: abs(a - r) / max(abs(r), 1e-12)
    (lk, gk), (lp, gp) = kern[:2], plain[:2]
    print(f"  {label}: loss {lk:.6f} (plain {lp:.6f}, rel {rel(lk, lp):.2e}), "
          f"grad_norm {gk:.6f} (plain {gp:.6f}, rel {rel(gk, gp):.2e}); "
          f"{kern[2]:.2f} / {plain[2]:.2f} ms, peak {kern[3] / 2**30:.3f} / "
          f"{plain[3] / 2**30:.3f} GiB (kernels / plain)")
    require(np.isfinite([lk, gk]).all(), f"{label}: non-finite loss")
    require(rel(lk, lp) <= TOL["train_loss_rel"]
            and rel(gk, gp) <= TOL["train_grad_norm_rel"],
            f"{label}: the kernels disagree with the plain route")


def pointnet_training(dev, counters, card, per_step):
    """The single-scale encoder at the train shape, 64 pairs x 512 keypoints
    x 16384 cloud points, ``train_step`` 3: three steps on the kernel route
    (the default, with ``loss_kernel``) and on the plain route, in turns,
    counters zeroed just before and read just after."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state
    cfg = train_defaults(descriptor="pointnet", loss_kernel=True, **EXACT)
    host, batch = train_batch(11, cfg.batch_size, cfg.max_keypoints, dev)
    batch = with_clouds(host, batch, 12, dev)
    kern = create_train_state(cfg, device=dev, seed=0)
    plain = create_train_state(cfg.replace(use_kernels=False,
                                           loss_kernel=False),
                               device=dev, seed=0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    k_steps, p_steps = [], []
    for i in range(DESC_TRAIN_STEPS):
        k_steps.append(timed_step(kern, batch))
        p_steps.append(timed_step(plain, batch))
    launches = read_counts(counters)
    require_launches("pointnet training", launches, per_step,
                     DESC_TRAIN_STEPS)
    print(f"descriptors, pointnet (SSG) training on {card}: "
          f"{DESC_TRAIN_STEPS} steps of 64 pairs x 512 keypoints x "
          f"{CLOUD_POINTS} cloud points a route, in turns; launches "
          f"{launches}")
    for i, (k, p) in enumerate(zip(k_steps, p_steps)):
        compare_step(f"pointnet step {i + 1}", k, p)
    require(k_steps[-1][0] < k_steps[0][0], "pointnet: the loss did not fall")
    med = lambda steps: float(np.median([s[2] for s in steps]))
    out = dict(launches=launches, kernel=k_steps, plain=p_steps,
               kernel_ms=med(k_steps), plain_ms=med(p_steps),
               peak_bytes=max(s[3] for s in k_steps),
               plain_peak_bytes=max(s[3] for s in p_steps))
    print(f"descriptors, pointnet training on {card}: median step "
          f"{out['kernel_ms']:.2f} ms (plain {out['plain_ms']:.2f}), peak "
          f"{out['peak_bytes']} bytes (plain {out['plain_peak_bytes']})")
    return out


def staged_training(dev, counters, card, per_step):
    """The multi-scale encoder's staged training, 16 pairs x 512 keypoints x
    16384 cloud points: ``train_step`` 1, 2 and 3, one step each from
    seeded weights on the kernel route and on the plain route, counters
    zeroed just before and read just after each kernel step (step 1: no GNN,
    so no layer launch, and the Sinkhorn and gap-loss pairs). Step 1 leaves
    the GNN and ``final_proj`` without a gradient, step 2 the encoder. Each
    route then takes a second step, timed warm (the first includes its
    state's first-use work)."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state
    host, batch = train_batch(13, MSG_TRAIN_PAIRS, 512, dev)
    batch = with_clouds(host, batch, 14, dev)
    out = {}
    for train_step in (1, 2, 3):
        cfg = train_defaults(descriptor="pointnetmsg", train_step=train_step,
                             loss_kernel=True, **EXACT)
        kern = create_train_state(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        k = timed_step(kern, batch)
        launches = read_counts(counters)
        per = (per_step if train_step > 1 else
               {"sinkhorn": 1, "sinkhorn_bwd": 1, "gap_loss_fwd": 1,
                "gap_loss_bwd": 1})
        require_launches(f"pointnetmsg train_step {train_step}", launches,
                         per, 1)
        grads = {name: p.grad is not None
                 for name, p in kern.model.named_parameters()}
        has = lambda prefix: [v for n, v in grads.items()
                              if n.startswith(prefix)]
        want_enc, want_gnn = {1: (True, False), 2: (False, True),
                              3: (True, True)}[train_step]
        require(all(v == want_enc for v in has("penc."))
                and all(v == want_gnn for v in has("gnn.") + has("final_proj.")),
                f"pointnetmsg train_step {train_step}: gradient pattern")
        for name, p in kern.model.named_parameters():
            if p.grad is not None:
                require(torch.isfinite(p.grad).all().item(),
                        f"pointnetmsg train_step {train_step}: {name}")
        k_warm = timed_step(kern, batch)
        del kern
        plain = create_train_state(cfg.replace(use_kernels=False,
                                               loss_kernel=False),
                                   device=dev, seed=0)
        p = timed_step(plain, batch)
        p_warm = timed_step(plain, batch)
        del plain
        print(f"descriptors, pointnetmsg train_step {train_step} on {card}: "
              f"{MSG_TRAIN_PAIRS} pairs x 512 x {CLOUD_POINTS}; launches "
              f"{launches}; gradients: encoder {want_enc}, GNN {want_gnn}")
        compare_step(f"pointnetmsg train_step {train_step}", k, p)
        compare_step(f"pointnetmsg train_step {train_step}, second step",
                     k_warm, p_warm)
        out[train_step] = dict(launches=launches, kernel=k, plain=p,
                               kernel_warm=k_warm, plain_warm=p_warm)
        torch.cuda.empty_cache()
    return out


def device_ms(fn, reps=3, top=0):
    """Device time of ``fn`` over ``reps`` calls by torch.profiler, ms a
    call; with ``top`` also the ``top`` longest kernels as (ms a call,
    launches a call, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if not top:
        return total
    events.sort(key=lambda e: -e.self_device_time_total)
    return total, [(e.self_device_time_total / 1e3 / reps, e.count / reps,
                    e.key[:80]) for e in events[:top]]


def eval_agreement(label, model, plain, batch, counters, card, encoder=False):
    """One eval forward of ``model`` (kernels) with the counters zeroed
    just before and read just after (36 / 216 / 36 / 1), agreement with
    ``plain`` over the valid slots and the largest difference of their
    transports as probabilities, forward ms by events; with ``encoder`` the
    profiler's device ms of the encoder beside the whole forward's."""
    import torch
    from mdgat_tpu_torch.models.mdgat import torch_dtype
    with torch.inference_mode():
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        got = model(batch, return_full_scores=True)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        require_launches(f"{label} eval forward", launches, EVAL_LAUNCHES, 1)
        ref = plain(batch, return_full_scores=True)
        valid = torch.cat([batch["mask0"], batch["mask1"]], dim=1)
        same = torch.cat([got["matches0"] == ref["matches0"],
                          got["matches1"] == ref["matches1"]], dim=1)
        agree = float(same[valid].float().mean())
        n_matched = int((got["matches0"] >= 0).sum())
        prob_err = float((got["scores"].exp() - ref["scores"].exp()).abs()
                         .max())
        ms, plain_ms = abba_ms(lambda: model(batch), lambda: plain(batch), 5)
        out = dict(launches=launches, agreement=agree, matches0_set=n_matched,
                   transport_prob_err=prob_err, ms=ms, plain_ms=plain_ms)
        if encoder:
            dt = torch_dtype(model.config.compute_dtype)
            enc = lambda: [model.encode(batch, s, dt) for s in "01"]
            out["device_ms"] = device_ms(lambda: model(batch))
            out["encoder_device_ms"], out["encoder_kernels"] = device_ms(
                enc, top=8)
            out["encoder_ms"] = cuda_ms(enc, reps=5, warmup=1)
    split = ""
    if encoder:
        split = (f"; device {out['device_ms']:.3f} ms a forward, the encoder "
                 f"{out['encoder_device_ms']:.3f} ms of it (share "
                 f"{out['encoder_device_ms'] / out['device_ms']:.3f}; "
                 f"{out['encoder_ms']:.3f} ms by events)")
    print(f"descriptors, {label} eval forward on {card}: 64 pairs x 256 "
          f"keypoints, {ms:.3f} ms by events (plain {plain_ms:.3f}); "
          f"agreement {agree:.6f} (min {MIN_AGREEMENT}), {n_matched} "
          f"matches0 set, transport max err {prob_err:.3e} as probabilities "
          f"(tol {TOL['transport_prob']:g}); launches {launches}{split}")
    for ms_call, count, name in out.get("encoder_kernels", ()):
        print(f"  encoder: {ms_call:8.3f} ms {count:5.0f} x  {name}")
    require(agree >= MIN_AGREEMENT, f"{label}: kernels disagree with plain")
    require(prob_err <= TOL["transport_prob"],
            f"{label}: the transports disagree")
    return out


def descriptor_eval(dev, counters, card):
    """Eval forwards at the serving shape, 64 pairs x 256 keypoints, of the
    multi-scale learned descriptors (16384-point clouds) and of FPFH_only
    and FPFH_gloabal, kernels against ``use_kernels=False``. The models are
    seeded and untrained, so the dustbin wins most rows and the agreement
    of the matches says little: the transports are held to each other as
    well."""
    from mdgat_tpu_torch.core.config import test_defaults
    from mdgat_tpu_torch.models.factory import build_model
    host, batch = train_batch(15, 64, 256, dev)
    out = {}
    for descriptor in ("pointnetmsg", "FPFH_only", "FPFH_gloabal"):
        cfg = test_defaults(descriptor=descriptor, **EXACT)
        models = []
        for use_kernels in (True, False):
            m = build_model(cfg.replace(use_kernels=use_kernels))
            m.reset_parameters(0)
            models.append(m.to(dev).eval())
        pointnet = descriptor == "pointnetmsg"
        b = with_clouds(host, batch, 16, dev) if pointnet else batch
        out[descriptor] = eval_agreement(descriptor, *models, b, counters,
                                         card, encoder=pointnet)
    return out


def descriptor_clis(dev, counters, card, per_step):
    """The three entry points with ``--descriptor pointnetmsg``: a synthetic
    KITTI-layout tree written as ``--synthetic true`` writes it for that
    mode (clouds of 4 x 512 points), with 64 pairs a sequence;
    ``train_torch.main`` for 2 epochs x 2 steps of ``MSG_TRAIN_PAIRS`` pairs
    (``--loss_kernel true``; the 128-sample grouping does not shrink with
    the cloud), then ``test_torch.main`` and ``test_registration_metric_torch
    .main`` on its last checkpoint over the 64 test pairs in one batch;
    counters zeroed just before and read just after each; pairs/s by wall
    clock."""
    import contextlib
    import io
    import shutil
    import torch
    import test_registration_metric_torch
    import test_torch
    import train_torch
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    root = os.path.join(OUT_DIR, "kitti_pointnetmsg")
    shutil.rmtree(root, ignore_errors=True)
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                                   frames_per_seq=12, pairs_per_seq=64,
                                   n_points=512, seed=0, cloud_points=4 * 512)
    data = ["--synthetic", "true", "--train_path", root, "--keypoints_path",
            kp_dir, "--txt_path", os.path.join(root, "preprocess-random-full"),
            "--device", str(dev), "--descriptor", "pointnetmsg", "--seed",
            "0", *EXACT_ARGV]

    def run(main, argv):
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.chdir(OUT_DIR):
            result = main(data + argv)
        torch.cuda.synchronize()
        return result, read_counts(counters), time.perf_counter() - t0, \
            buf.getvalue()

    steps, epochs = 2, 2
    out_dir = os.path.join(OUT_DIR, "checkpoint_pointnetmsg")
    shutil.rmtree(out_dir, ignore_errors=True)
    summary, launches, wall, _ = run(train_torch.main, [
        "--batch_size", str(MSG_TRAIN_PAIRS), "--max_keypoints", "512",
        "--epoch", str(epochs), "--steps_per_epoch", str(steps),
        "--loss_kernel", "true", "--model_out_path", out_dir])
    n_train, n_val = steps * epochs, epochs
    val_step = dict(EVAL_LAUNCHES, gap_loss_fwd=1)
    require_launches("descriptor train_cli", launches, {
        k: per_step.get(k, 0) * n_train + val_step.get(k, 0) * n_val
        for k in launches}, 1)
    losses = summary["epoch_loss"] + summary["val_loss"]
    require(summary["steps"] == [steps] * epochs and np.isfinite(losses).all(),
            f"descriptor train_cli: steps {summary['steps']}, losses {losses}")
    ckpt = summary["checkpoints"][-1]
    require("/train_step3/" in ckpt, f"descriptor train_cli: run dir {ckpt}")
    print(f"descriptors, train_torch.main --descriptor pointnetmsg on {card}: "
          f"{n_train} steps of {MSG_TRAIN_PAIRS} pairs x 512 keypoints x 2048 "
          f"cloud points and {n_val} validation steps in {wall:.2f} s wall "
          f"({MSG_TRAIN_PAIRS * n_train / wall:.1f} train pairs/s); epoch_loss "
          f"{summary['epoch_loss']}, val_loss {summary['val_loss']}; "
          f"launches {launches}")
    out = dict(train=dict(steps=n_train, val_steps=n_val, wall_s=wall,
                          epoch_loss=summary["epoch_loss"],
                          val_loss=summary["val_loss"], launches=launches))
    for name, main in (("test_torch", test_torch.main),
                       ("test_registration_metric_torch",
                        test_registration_metric_torch.main)):
        result, launches, wall, text = run(main, [
            "--resume_model", ckpt, "--batch_size", "64",
            "--ensure_kpts_num", "true"])
        with open(os.path.join(OUT_DIR, f"descriptors_{name}.log"), "w") as f:
            f.write(text)
        require(result["n_pairs"] == 64 and result["n_batches"] == 1,
                f"descriptor {name}: {result['n_pairs']} pairs in "
                f"{result['n_batches']} batches")
        require_launches(f"descriptor {name}", launches, EVAL_LAUNCHES, 1)
        tail = [ln for ln in text.splitlines()
                if not (ln.startswith("idx") or ln == "registration fail")]
        print(f"descriptors, {name}.main --descriptor pointnetmsg on {card}: "
              f"64 pairs in {wall:.2f} s wall ({64 / wall:.1f} pairs/s); "
              f"launches {launches}; " + " | ".join(tail))
        out[name] = dict(wall_s=wall, pairs_per_s=64 / wall,
                         launches=launches)
    return out


def descriptors(dev, report, counters, card):
    """Phase 13: the learned-descriptor modes and the FPFH variants on
    their entry points, at the published widths."""
    import torch
    t0 = time.perf_counter()
    per_step = fpfh_step_launches(report)
    out = dict(pointnet_training=pointnet_training(dev, counters, card,
                                                   per_step))
    gc.collect()
    torch.cuda.empty_cache()
    out["staged_training"] = staged_training(dev, counters, card, per_step)
    gc.collect()
    torch.cuda.empty_cache()
    out["eval"] = descriptor_eval(dev, counters, card)
    torch.cuda.empty_cache()
    out["entry_points"] = descriptor_clis(dev, counters, card, per_step)
    out["wall_s"] = time.perf_counter() - t0
    print(f"descriptors phase on {card}: {out['wall_s']:.1f} s wall")
    report["_descriptors"] = out


# ---------------------------------------------------------------------------
# phase 14: the fast top-k arm, the default of the kernel routes
# ---------------------------------------------------------------------------

def fma_f32(a, b, c):
    """``fmaf(a, b, c)`` of float32 tensors, bit for bit: the product is
    exact in float64 and the sum is rounded there, then to float32. That
    double rounding errs only where the float64 sum lies halfway between two
    float32 values while the exact sum does not; the sum's rounding error
    (TwoSum) says which way the exact sum lies."""
    import torch
    p, c = a.double() * b.double(), c.double()
    r = p + c
    bp = r - p
    err = (p - (r - bp)) + (c - bp)
    f = r.float()
    inf = torch.full_like(f, float("inf"))
    other = torch.where(f.double() > r, torch.nextafter(f, -inf),
                        torch.nextafter(f, inf))
    half = (f.double() != r) & ((f.double() + other.double()) * 0.5 == r)
    toward = torch.where(err > 0, torch.maximum(f, other),
                         torch.minimum(f, other))
    return torch.where(half & (err != 0), toward, f)


def kernel_scores(q, k, scale):
    """The attention kernel's own scores ``[B, H, N, M]`` float32: one fmaf
    chain over the head dim, d ascending from 0 (``score_dot`` of
    ``csrc/common.cuh``, phase A of ``csrc/attention.cu``), then times
    ``scale``."""
    import torch
    q, k = q.float(), k.float()
    acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32,
                      device=q.device)
    for d in range(q.shape[-1]):
        acc = fma_f32(q[..., d, None], k[..., None, :, d], acc)
    return acc * scale


def fast_tie_rows(s, valid, thr_a, thr_b):
    """[..., N] bool: rows where the fast arm's kept set rests on rounding:
    the valid scores ``s`` kept under the two thresholds differ, or one of
    them lies within TIE_GAP of either threshold. Where two sides sum the
    scores in other orders a midpoint count can tip, and the two brackets
    part."""
    import torch
    sv = torch.where(valid, s, torch.full_like(s, -1e30))
    differ = ((sv >= thr_a) != (sv >= thr_b)).any(-1)
    near = (((sv - thr_a).abs() < TIE_GAP) | ((sv - thr_b).abs() < TIE_GAP))
    return differ | near.any(-1)


class AttentionCalls:
    """Within the block, every call of the attention kernel's wrapper is
    recorded with its inputs and outputs; the wrapper's launch count goes
    on counting."""

    def __enter__(self):
        from mdgat_tpu_torch.ops.cuda import attention as A
        self.module, self.real, self.calls = A, A.topk_attention, []
        real, calls = self.real, self.calls

        def spy(q, k, v, kv_mask, topk, scale, return_lse=False, exact=True,
                fine_iters=None):
            out = real(q, k, v, kv_mask, topk, scale, return_lse, exact,
                       fine_iters)
            calls.append(dict(q=q, k=k, v=v, mask=kv_mask, topk=topk,
                              scale=scale, exact=exact, out=out,
                              fine=A.resolution(q.dtype, exact, fine_iters)))
            return out

        spy.launches = real.launches
        A.topk_attention = spy
        return self

    def __exit__(self, *exc):
        self.real.launches = self.module.topk_attention.launches
        self.module.topk_attention = self.real
        return False


def check_fast_call(name, call, want_fine, tol):
    """One fast-arm launch of the attention kernel against the twin on the
    kernel's own scores: the resolution it ran at, thr bit-equal to
    ``fast_threshold``'s, the output and lse within ``tol``. Returns the
    output error."""
    import torch
    from mdgat_tpu_torch.ops.attention import attention_core, fast_threshold
    q, k, v, mask, topk = call["q"], call["k"], call["v"], call["mask"], call["topk"]
    require(not call["exact"] and call["fine"] == want_fine,
            f"{name}: the kernel ran exact={call['exact']} at resolution "
            f"{call['fine']}, not the fast arm at {want_fine}")
    o, thr = call["out"][:2]
    with torch.no_grad():
        s = kernel_scores(q, k, call["scale"])
        valid = (torch.ones_like(s, dtype=torch.bool) if mask is None
                 else mask[:, None, None, :].expand(s.shape))
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        thr_twin = fast_threshold(s, valid, topk, want_fine)
        o_twin, _, lse_twin = attention_core(s, v.float(), mask, topk,
                                             return_lse=True,
                                             fine_iters=want_fine)
    torch.cuda.synchronize()
    same = torch.equal(thr, thr_twin)
    err = (o.float() - o_twin).abs().max().item()
    lerr = 0.0
    if len(call["out"]) == 3:
        lse = call["out"][2]
        lerr = ((lse - lse_twin).abs() / lse_twin.abs().clamp_min(1.0)).max().item()
    extra = (thr_twin.expand(s.shape) <= s).sum(-1) - torch.clamp(
        valid.sum(-1), max=topk)
    print(f"{name}: fast arm at {want_fine} binary passes; thr "
          f"{'bit-equal to' if same else 'DIFFERS from'} the twin's on the "
          f"kernel's own scores; max|o-o_twin| {err:.3e} lse rel {lerr:.3e} "
          f"tol {tol:g}; keys kept beyond k a row: mean "
          f"{extra.float().mean().item():.3f}, max {int(extra.max())}")
    require(same, f"{name}: the fast arm's thr differs from the twin's")
    require(torch.isfinite(o.float()).all().item(), f"{name}: non-finite")
    require(err <= tol and lerr <= TOL["attention_f32"], f"{name} disagrees")
    return err


def fast_attention_checks(rng, dev, report):
    """Each call site of the fast arm against the twin on the card, at f32
    and bf16 inputs: the attention kernel alone (#1; the serving shape at k
    = 128 and 64, the boundaries of the ternary and the register arms, the
    wide arm at 2 x 4 x 1500 x 1500), the eval layer (#2), the fused-MHA
    forward (#4) and the whole-layer train forward (#6), each launch's
    resolution keyed on the dtype of its caller's input."""
    import torch
    from mdgat_tpu_torch.ops.attention import fast_iters
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import lightglue as LG
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    f32, bf16 = torch.float32, torch.bfloat16

    def t(*shape, dt=f32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dt)

    worst = 0.0
    cases = [(64, 4, 256, 256, kk, dt) for kk in (128, 64) for dt in (f32, bf16)]
    cases += [(2, 2, 64, m, 64, f32) for m in (512, 513, 1024, 1025)]
    cases += [(2, 2, 50, 120, 119, f32), (2, 4, 1500, 1500, 128, f32),
              (2, 4, 1500, 1500, 128, bf16)]
    for b, h, n, m, kk, dt in cases:
        q, k, v = t(b, h, n, 32, dt=dt), t(b, h, m, 32, dt=dt), t(b, h, m, 32, dt=dt)
        mask = ragged_mask(rng, b, m, int(0.78 * m), dev)
        with AttentionCalls() as spy:
            A.topk_attention(q, k, v, mask, kk, 32 ** -0.5, exact=False)
        name = f"fast attention {b}x{h}x{n}x{m} k{kk} {str(dt)[6:]}"
        err = check_fast_call(name, spy.calls[0], fast_iters(dt),
                              TOL["attention_f32" if dt == f32 else "attention_bf16"])
        if dt == f32 and m == 256:
            worst = max(worst, err)
    report["topk_attention_fast"]["max_abs_err"] = worst

    layer = _random_layer(7, dev)
    w = layer.kernel_weights()
    mask = ragged_mask(rng, 64, 256, 200, dev)
    for dt in (f32, bf16):
        x, src = t(64, 256, 128, dt=dt), t(64, 256, 128, dt=dt)
        for kk in (128, 64):
            with AttentionCalls() as spy:
                y = Lk.fused_layer(x, src, mask, kk, w, exact=False)
            require(torch.isfinite(y.float()).all().item(), "fast layer: non-finite")
            check_fast_call(f"fast eval layer 64x256x128 k{kk} {str(dt)[6:]}",
                            spy.calls[0], fast_iters(dt), TOL["attention_f32"])
    wa = _random_attn(21, dev, 128, 4)
    tl = _random_layer(41, dev, 128, 4)
    with torch.no_grad():
        wt = [p.clone() for p in T.train_layer_weights(tl)]
    mask = ragged_mask(rng, 64, 512, 400, dev)
    for dt in (f32, bf16):
        x = t(64, 512, 128, dt=dt)
        with AttentionCalls() as spy:
            M.fused_mha_forward(x, x, mask, 128, 4, *wa, exact=False)
            T.fused_train_layer_forward(x, x, mask, mask, 128, 4, *wt,
                                        exact=False)
        for label, call in zip(("fused-MHA forward", "train-layer fwd1"),
                               spy.calls):
            check_fast_call(f"fast {label} 64x512x128 k128 {str(dt)[6:]}",
                            call, fast_iters(dt), TOL["attention_f32"])


def fast_kernel_times(rng, dev, report, card):
    """The attention kernel's two arms, in turns, by events and in a CUDA
    graph, at the serving shape (k = 128, 64) and the train shape (k =
    128), f32 as the routes give it; its twin's fast arm by events; the
    bound of the fast arm's work at the serving shape, k = 128."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    out = {}
    for n, kk in ((256, 128), (256, 64), (512, 128)):
        b, h, dh = 64, 4, 32
        q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh))
                                    .astype(np.float32)).to(dev) for _ in range(3))
        mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
        arms = [lambda: A.topk_attention(q, k, v, mask, kk, dh ** -0.5),
                lambda: A.topk_attention(q, k, v, mask, kk, dh ** -0.5,
                                         exact=False)]
        ev = turns_ms(arms, reps=20)
        graph = [[], []]
        with torch.no_grad():
            for i in (0, 1, 1, 0):
                graph[i].append(graph_ms(arms[i]))
        twin = cuda_ms(lambda: A.topk_attention_reference(
            q, k, v, mask, kk, dh ** -0.5, exact=False), reps=5)
        key = f"{b}x{h}x{n}x{n}x{dh}_k{kk}"
        out[key] = dict(exact_events=ev[0], fast_events=ev[1],
                        exact_graph=min(graph[0]), fast_graph=min(graph[1]),
                        twin_fast_events=twin)
        print(f"attention arms on {card}, {key} (ms a launch; exact / fast): "
              f"events {ev[0]:.4f} / {ev[1]:.4f}, CUDA graph "
              f"{min(graph[0]):.4f} / {min(graph[1]):.4f}; the fast twin "
              f"{twin:.4f} by events")
        if (n, kk) == (256, 128):
            with torch.no_grad():
                _, thr = arms[1]()
                s = kernel_scores(q, k, dh ** -0.5)
                valid = mask[:, None, None, :].expand(s.shape)
                kept = ((s >= thr) & valid).sum().item()
            keys = mask.sum().item()
            flops = 2.0 * h * n * dh * keys + 2.0 * kept * dh
            nbytes = 4 * 4.0 * b * h * n * dh + b * n + 4.0 * b * h * n
            ms, by = bound(nbytes, flops)
            report["topk_attention_fast"].update(
                ms=ev[1], plain_ms=twin, bound_ms=ms, bound_by=by,
                library_ms=None)
            out[key].update(bound_ms=ms, bound_by=by, kept=kept)
    report["_fast_topk_times_ms"] = out


def fast_serving(rng, dev, report, counters, card):
    """The default serving forward (the fast arm) behind ``Matcher``: three
    ``match_batch`` calls of 64 pairs, the counters zeroed just before and
    read just after: the exact route's 36 / 216 / 36 / 1 a forward; then the
    forward's time beside the exact arm's."""
    import torch
    from mdgat_tpu_torch import Matcher
    matcher = Matcher(seed=0, device=dev)
    require(matcher.cfg.exact_topk is False, "the default is not the fast arm")
    requests = [make_pairs(rng, 64) for _ in range(3)]
    matcher.match_batch(requests[0][:2])
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    outs = [matcher.match_batch(r) for r in requests]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    want = {name: 0 for name in counters}
    want.update(topk_attention=36 * 3, eval_layer=36 * 3, gemm=216 * 3,
                sinkhorn=3)
    print(f"fast_topk serving: 3 default forwards of 64 pairs; launches "
          f"{launches}")
    require(launches == want, f"fast_topk serving: launches {launches}, "
            f"not {want}")
    for r, o in zip(requests, outs):
        check_outputs(o, r)
    report["topk_attention_fast"]["launches"] = launches["topk_attention"]
    # the whole forward on one prepared batch, the exact arm and the fast
    # one in turns (exact, fast, fast, exact)
    exact = Matcher(seed=0, device=dev, **EXACT)
    batch, _ = matcher.prepare_batch(requests[0])
    with torch.inference_mode():
        ms = turns_ms([lambda: exact.model(batch), lambda: matcher.model(batch)],
                      reps=5)
    print(f"fast_topk serving on {card}: forward of 64 pairs {ms[1]:.3f} ms "
          f"(exact arm {ms[0]:.3f}) by events")
    report["_fast_topk_serving_ms"] = dict(exact=ms[0], fast=ms[1])


def fast_training(dev, report, counters):
    """Three default training steps (whole-layer kernels, the fast arm) on
    the training phase's batch: the exact route's launches, loss and
    grad-norm relative differences against it printed."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state
    cfg = train_defaults()
    _, batch = train_batch(1, cfg.batch_size, cfg.max_keypoints, dev)
    state = create_train_state(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    metrics = run_steps(state, batch, TRAIN_STEPS)
    launches = read_counts(counters)
    exact = report["_training"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    for i, ((lf, gf), (le, ge)) in enumerate(zip(metrics, exact["train_layer"])):
        print(f"fast_topk training step {i + 1}: loss {lf:.6f} (exact arm "
              f"{le:.6f}, rel {rel(lf, le):.2e}), grad_norm {gf:.6f} ({ge:.6f}, "
              f"rel {rel(gf, ge):.2e})")
        require(np.isfinite([lf, gf]).all(), "fast_topk training: non-finite")
    require(launches == exact["launches"],
            f"fast_topk training: launches {launches}, the exact route's "
            f"{exact['launches']}")
    require(metrics[-1][0] < metrics[0][0], "fast_topk training: the loss "
            "did not fall")
    for p in state.model.parameters():
        require(torch.isfinite(p).all().item(),
                "fast_topk training: non-finite parameter")
    report["_fast_topk_training"] = dict(steps=metrics, launches=launches)


# The JAX package's measured score-noise floors, match slots flipped by the
# score computation alone (its exact kernel against XLA's top_k on the same
# inputs, 256 pairs, 65536 slots; mdgat_tpu/ops/pallas/attention.py:38-77),
# as a share of the slots: the noise its fast arm was chosen to sit under.
JAX_FLOOR_RATE = {"bfloat16": 129 / 65536, "float32": 52 / 65536}


def fast_agreement(report):
    """``tools/torch_topk_agreement.py`` at 4 batches of 64 pairs, f32 and
    bf16, with the seeded weights and with the eval_cli phase's matching
    checkpoint (a model whose matches are mostly right). The JAX package's
    rule: the fast arm's flips against the exact
    arm sit at or under the score-noise floor, the exact arm's flips
    against the plain route on the same pairs. Where the port's floor is
    below the JAX package's own (at f32 the port's exact kernel and plain
    route agree on every slot), the fast arm is held to the JAX package's
    floor as a share of the slots instead; the rule's verdict on the port's
    floor is printed either way. At most 0.5% of the slots in any case."""
    from tools.torch_topk_agreement import describe, measure
    rows = []
    for checkpoint in (None, os.path.join(OUT_DIR, "matching.pth")):
        rows += measure(("float32", "bfloat16"), (0,), batches=4, batch=64,
                        checkpoint=checkpoint)
    for row in rows:
        floor = row["flips_exact_plain"]
        jax_floor = JAX_FLOOR_RATE[row["dtype"]] * row["slots"]
        row["floor_rule_port"] = row["flips_fast_exact"] <= floor
        row["jax_floor_flips"] = jax_floor
        print(f"fast_topk agreement, {describe(row)}; the floor rule on the "
              f"port's floor: {'holds' if row['floor_rule_port'] else 'FAILS'}"
              f" ({row['flips_fast_exact']} flips, floor {floor}); the JAX "
              f"package's floor at this dtype: {jax_floor:.1f} flips")
        require(row["flips_fast_exact"] <= max(floor, jax_floor)
                and row["flips_fast_exact"] <= 0.005 * row["slots"],
                f"fast_topk agreement, {row['dtype']}, {row['weights']}: the "
                f"fast arm flips "
                f"{row['flips_fast_exact']} slots, above the floor {floor} "
                f"(the JAX package's {jax_floor:.1f}) or 0.5% of "
                f"{row['slots']}")
    report["_fast_topk_agreement"] = rows


def fast_topk(rng, dev, report, counters, card):
    """The kernel routes' default selection, the fast arm (phase 14)."""
    import torch
    t0 = time.perf_counter()
    fast_attention_checks(rng, dev, report)
    torch.cuda.empty_cache()
    f, g, gap, ties, rows = mha_case(rng, dev, 64, 512, 512, 128, 4, 128,
                                     True, 20, exact=False)
    print(f"fast fused_mha b64 n512 k128 self: out/thr/lse max err {f:.3e}, "
          f"ten gradients max rel err {g:.3e}, forward vs rebuilt attention "
          f"output {gap:.3e}; backward bit-equal over two runs; rows whose "
          f"kept set rests on rounding left out {ties} of {rows}")
    require(f <= TOL["mha_out"] and g <= TOL["mha_grad"]
            and gap <= TOL["mha_selection_gap"],
            "fast fused_mha: kernels disagree with the twin")
    torch.cuda.empty_cache()
    f, b1, g, z, gap, left, rows = train_layer_case(
        rng, dev, 64, 512, 512, 128, 4, 128, False, 40, torch.float32,
        exact=False)
    print(f"fast train_layer b64 n512 k128 cross: forward max err {f:.3e}, "
          f"bwd1 {b1:.3e}, gradients {g:.3e}, zero bias gradients {z:.3e}, "
          f"forward vs rebuilt attention output {gap:.3e}; backward "
          f"bit-equal over two runs; rows left out {left} of {rows}")
    require(f <= TOL["train_layer_out"] and b1 <= TOL["train_layer_grad"]
            and g <= TOL["train_layer_grad"]
            and z <= TOL["train_layer_zero_grad"]
            and gap <= TOL["mha_selection_gap"],
            "fast train_layer: kernels disagree with the twin")
    torch.cuda.empty_cache()
    fast_kernel_times(rng, dev, report, card)
    torch.cuda.empty_cache()
    fast_serving(rng, dev, report, counters, card)
    torch.cuda.empty_cache()
    fast_training(dev, report, counters)
    torch.cuda.empty_cache()
    fast_agreement(report)
    print(f"fast_topk phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: one process over a grid of replicas
# ---------------------------------------------------------------------------

MESH_GRIDS = ((2, 1), (1, 2), (2, 2))


def mesh_call(label, matcher, pairs, want, counters):
    """One ``match_batch`` of a grid Matcher, counters zeroed just before
    and read just after: outputs equal to ``want`` (one device's), N * M
    forwards' launches, the gathers of a seq axis."""
    import torch
    from mdgat_tpu_torch.parallel import collective_counts
    n, m = matcher.cfg.data_parallel, matcher.cfg.seq_parallel
    cells = n * m
    for c in counters.values():
        c.reset()
    collective_counts.clear()
    got = matcher.match_batch(pairs)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    gathers = dict(collective_counts)
    need = {name: 0 for name in counters}
    need.update(topk_attention=36 * cells, eval_layer=36 * cells,
                gemm=216 * cells, sinkhorn=cells)
    need_gathers = ({} if m == 1 else dict(
        input_gather=cells, kv_gather=18 * cells, tail_gather=cells))
    ran = {k: v for k, v in launches.items() if v}
    print(f"matcher_mesh {label}, {len(pairs)} pairs: launches {ran}; "
          f"gathers {gathers}")
    require(launches == need, f"matcher_mesh {label}: launches {launches}, "
            f"not {need}")
    require(gathers == need_gathers, f"matcher_mesh {label}: gathers "
            f"{gathers}, not {need_gathers}")
    check_outputs(got, pairs)
    require(len(got) == len(want), f"matcher_mesh {label}: pair count")
    flips = sum(int((g[k] != w[k]).sum()) for g, w in zip(got, want)
                for k in ("matches0", "matches1"))
    gap = max(float(np.abs(g[k] - w[k]).max()) for g, w in zip(got, want)
              for k in ("matching_scores0", "matching_scores1"))
    require(flips == 0 and gap == 0.0, f"matcher_mesh {label}: outputs "
            f"differ from one device's ({flips} matches, scores by {gap})")
    return ran


def mesh_failure(matcher):
    """A seq member that raises after the GNN (at its tail gather the other
    member waits): the call raises that exception, far inside the
    barrier's timeout, and no grid thread is left."""
    import threading
    from mdgat_tpu_torch.parallel.local import GATHER_TIMEOUT_S
    proj = matcher._step.replicas[0][1].final_proj

    def fail(*args):
        raise RuntimeError("planted member failure")
    proj.forward = fail
    t0 = time.perf_counter()
    try:
        matcher.match_batch(make_pairs(np.random.default_rng(5), 8))
        raised = None
    except RuntimeError as e:
        raised = e
    seconds = time.perf_counter() - t0
    del proj.forward
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("mdgat-eval")]
    print(f"matcher_mesh failing member: raised {raised!r} after "
          f"{seconds:.3f} s (barrier timeout {GATHER_TIMEOUT_S} s); grid "
          f"threads left {left}")
    require(raised is not None and "planted" in str(raised),
            "matcher_mesh: a failing member did not fail the call")
    require(seconds < GATHER_TIMEOUT_S / 10 and not left,
            "matcher_mesh: a failing member held the call or left threads")
    return seconds


def data_rows_in_turn(matcher, pairs):
    """A data-only grid's forwards enqueued in turn from this thread, no
    grid thread: what the grid's threads replace (timed beside them)."""
    import torch
    from mdgat_tpu_torch.ops.cuda.sinkhorn import plan_as
    from mdgat_tpu_torch.parallel import shard_batch
    from mdgat_tpu_torch.parallel.smap import upload
    batch, _ = matcher._host_batch(pairs, True)
    replicas = [row[0] for row in matcher._step.replicas]
    rows = len(pairs) // len(replicas)
    with torch.inference_mode(), plan_as(len(pairs)):
        outs = [r(upload(shard_batch(batch, rows=slice(d * rows,
                                                       (d + 1) * rows)),
                         matcher.devices[d], normalize=True))
                for d, r in enumerate(replicas)]
        return [{k: v.cpu() for k, v in o.items()} for o in outs]


def matcher_mesh(rng, dev, report, counters, card):
    """One process over a grid of replicas (phase 15)."""
    import torch
    from mdgat_tpu_torch import Matcher
    t0 = time.perf_counter()
    single = Matcher(seed=0, device=dev)
    requests = [make_pairs(rng, 64), make_pairs(rng, 63)]
    want = [single.match_batch(r) for r in requests]
    grids = {f"{n}x{m}": Matcher(seed=0, device=dev, data_parallel=n,
                                 seq_parallel=m, devices=[dev] * (n * m))
             for n, m in MESH_GRIDS}
    if torch.cuda.device_count() > 1:
        grids["2x1 on two cards"] = Matcher(
            seed=0, device=dev, data_parallel=2,
            devices=["cuda:0", "cuda:1"])
    result = {}
    for label, matcher in grids.items():
        matcher.match_batch(requests[0][:2])    # first use: kernel weights
        torch.cuda.synchronize()
        result[label] = [mesh_call(label, matcher, r, w, counters)
                         for r, w in zip(requests, want)]
    failure_s = mesh_failure(grids["2x2"])
    mesh_call("2x2 after the failure", grids["2x2"], requests[0], want[0],
              counters)
    labels = ["1x1"] + list(grids) + ["2x1 in turn from one thread"]
    fns = [lambda: single.match_batch(requests[0])] + [
        (lambda m: lambda: m.match_batch(requests[0]))(m)
        for m in grids.values()] + [
        lambda: data_rows_in_turn(grids["2x1"], requests[0])]
    ms = turns_ms(fns, reps=3)
    print(f"matcher_mesh on {card}: match_batch of 64 pairs by events, in "
          f"turns: " + ", ".join(f"{lab} {t:.3f} ms"
                                 for lab, t in zip(labels, ms)))
    seconds = time.perf_counter() - t0
    print(f"matcher_mesh phase: {seconds:.1f} s")
    report["_matcher_mesh"] = dict(
        launches=result, match_batch_ms=dict(zip(labels, ms)),
        failure_s=failure_s, phase_s=seconds)


# ---------------------------------------------------------------------------
# phase 16: CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_STEPS = 3


def busy(fn, reps: int):
    """(host window ms, device ms) of ``reps`` calls of ``fn`` by
    torch.profiler, a call each."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / reps
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return window, device / 1e3 / reps


def busy_line(label, window, device):
    share = f"{device / window:.3f}" if device > 0 else "not measured"
    dev = f"{device:.3f} ms" if device > 0 else "not measured"
    return (f"{label}: window {window:.3f} ms a call, device {dev}, busy "
            f"share {share}")


def states_equal(label, a, b):
    """Every parameter, gradient, buffer and Adam moment of two train
    states ``torch.equal``."""
    import torch
    for (name, pa), pb in zip(a.model.named_parameters(),
                              b.model.parameters()):
        require(torch.equal(pa, pb), f"{label}: parameter {name} differs")
        require(torch.equal(pa.grad, pb.grad),
                f"{label}: gradient of {name} differs")
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            require(torch.equal(sa[k], sb[k]),
                    f"{label}: Adam's {k} of {name} differs")
    for (name, ba), bb in zip(a.model.named_buffers(), b.model.buffers()):
        require(torch.equal(ba, bb), f"{label}: buffer {name} differs")


def graph_train(dev, counters, card, label, timed=True, profiled=True,
                **over):
    """Three train steps of ``train_defaults(**over)`` eager and through
    the graph cache from one seed on three batches: metrics and state
    ``torch.equal``, the captured arm's launches one eager step's at its
    warm-up and at its capture and none at its replay; with ``timed``
    then step ms in turns and peak bytes, with ``profiled`` also device ms
    and busy share. Returns the two states, a batch and the numbers."""
    import torch
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state, make_train_step
    cfg = train_defaults(**over)
    batches = [train_batch(seed, cfg.batch_size, cfg.max_keypoints, dev)[1]
               for seed in (1, 2, 3)]
    eager = create_train_state(cfg.replace(cuda_graphs=False), device=dev,
                               seed=0)
    graph = create_train_state(cfg, device=dev, seed=0)
    step = make_train_step()
    label = f"cuda_graphs train, {label}"
    per_step = None
    peak = {}
    for i, batch in enumerate(batches):
        got = {}
        for arm, state in (("eager", eager), ("graph", graph)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.reset()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            peak[arm] = max(peak.get(arm, 0),
                            torch.cuda.max_memory_allocated() - base)
            got[arm] = (m, read_counts(counters))
        (me, le), (mg, lg) = got["eager"], got["graph"]
        per_step = per_step or le
        want = {k: 0 for k in le} if i == 2 else le
        print(f"{label} step {i + 1} ({['warm-up', 'capture', 'replay'][i]}):"
              f" loss {me['loss'].item():.6f} / {mg['loss'].item():.6f}, "
              f"grad_norm {me['grad_norm'].item():.6f} / "
              f"{mg['grad_norm'].item():.6f}; graph arm's launches "
              f"{ {k: v for k, v in lg.items() if v} }")
        require(le == per_step, f"{label}: eager launches changed")
        require(lg == want, f"{label} step {i + 1}: graph arm launched "
                f"{lg}, not {want}")
        for k in ("loss", "grad_norm"):
            require(torch.equal(me[k], mg[k]),
                    f"{label} step {i + 1}: {k} differs from the eager step")
    cache = graph.graphs
    require((cache.warm_ups, cache.captures, cache.replays)
            == (1, 1, GRAPH_STEPS - 1),
            f"{label}: cache {cache.warm_ups} / {cache.captures} / "
            f"{cache.replays}")
    states_equal(label, eager, graph)
    print(f"{label}: {GRAPH_STEPS} steps bit-equal (loss, grad_norm, every "
          f"parameter, gradient, BN buffer and Adam moment); per eager "
          f"step and at capture {sum(per_step.values())} counted launches, "
          f"at replay none")
    batch = batches[0]
    if not timed:
        return eager, graph, batch, dict(launches_per_step=per_step)
    ms = turns_ms([lambda: step(eager, batch), lambda: step(graph, batch)],
                  reps=3)
    windows = {arm: busy(lambda s=s: step(s, batch), 1) if profiled
               else (0.0, 0.0)
               for arm, s in (("eager", eager), ("graph", graph))}
    print(f"{label} on {card}: step {ms[0]:.3f} ms eager, {ms[1]:.3f} ms "
          f"replayed by events in turns; peak bytes above the states "
          f"{peak['eager']} eager, {peak['graph']} graph")
    for arm, (w, d) in windows.items():
        if profiled:
            print("  " + busy_line(f"{arm} step", w, d))
    return eager, graph, batch, dict(
        launches_per_step=per_step, step_ms=dict(eager=ms[0], graph=ms[1]),
        window_ms={a: w for a, (w, _) in windows.items()},
        device_ms={a: d for a, (_, d) in windows.items()}, peak_bytes=peak)


def graph_validation(graph, eager, batch, counters):
    """The captured eval step across captured train replays: after the
    weights moved, its loss and matches equal an eager eval step's on the
    same model (the eval layers fold their weights inside the graph), and
    the eager arm's."""
    import torch
    from mdgat_tpu_torch.train import make_eval_step, make_train_step
    from mdgat_tpu_torch.utils import graphs
    ev = make_eval_step(graph.model)
    ev(batch)
    ev(batch)                                  # captured
    step = make_train_step()
    step(graph, batch)                         # replays move the weights
    step(eager, batch)
    got = ev(batch)
    with graphs.disabled():
        want = ev(batch)
    other = make_eval_step(eager.model)(batch)
    cache = ev.graphs
    require((cache.warm_ups, cache.captures, cache.replays) == (1, 1, 2),
            "cuda_graphs validation: the eval step did not replay")
    for k in ("loss", "matches0", "matches1", "matching_scores0"):
        require(torch.equal(got[k], want[k]) and torch.equal(got[k], other[k]),
                f"cuda_graphs validation after updates: {k} differs from "
                f"the eager eval step")
    print(f"cuda_graphs validation after {GRAPH_STEPS + 1} updates: replayed "
          f"eval loss {got['loss'].mean().item():.6f} equals the eager eval "
          f"step's on the same and on the eager arm's weights")


def graph_serving(rng, dev, counters, card):
    """``Matcher`` with graphs against ``cuda_graphs=False``, one device
    and a 2 x 1 grid on the card: 64 and 63 pairs, three times each,
    ``np.array_equal``; launches at warm-up and capture, none at replay;
    match_batch and forward ms in turns, busy shares."""
    import torch
    from mdgat_tpu_torch import Matcher
    requests = [make_pairs(rng, 64), make_pairs(rng, 63)]
    one = dict(eager=Matcher(seed=0, device=dev, cuda_graphs=False),
               graph=Matcher(seed=0, device=dev))
    grid = dict(eager=Matcher(seed=0, device=dev, data_parallel=2,
                              devices=[dev, dev], cuda_graphs=False),
                graph=Matcher(seed=0, device=dev, data_parallel=2,
                              devices=[dev, dev]))
    per = {"topk_attention": 36, "eval_layer": 36, "gemm": 216,
           "sinkhorn": 1}
    for label, arms, cells in (("1x1", one, 1), ("2x1", grid, 2)):
        for rep in range(3):
            for r, req in enumerate(requests):
                want = one["eager"].match_batch(req)
                for c in counters.values():
                    c.reset()
                got = arms["graph"].match_batch(req)
                torch.cuda.synchronize()
                launches = read_counts(counters)
                need = {k: (per.get(k, 0) * cells if rep < 2 else 0)
                        for k in launches}
                require(launches == need, f"cuda_graphs serving {label}, "
                        f"{len(req)} pairs, call {rep + 1}: launches "
                        f"{launches}, not {need}")
                if label == "2x1":
                    grid_eager = arms["eager"].match_batch(req)
                    check_outputs(grid_eager, req)
                for g, w in zip(got, want):
                    for key in g:
                        require(np.array_equal(g[key], w[key]),
                                f"cuda_graphs serving {label}, {len(req)} "
                                f"pairs, call {rep + 1}: {key} differs from "
                                "one eager device's")
        caches = arms["graph"]._step.graphs
        require(all((c.warm_ups, c.captures, c.replays) == (2, 2, 4)
                    for c in caches),
                f"cuda_graphs serving {label}: caches "
                f"{[(c.warm_ups, c.captures, c.replays) for c in caches]}")
    print("cuda_graphs serving: 1x1 and 2x1 (cells sharing the card) "
          "np.array_equal to one eager device on 64 and 63 pairs, three "
          "calls each; launches at warm-up and capture, none at replay")
    fns = [lambda m=m: m.match_batch(requests[0])
           for m in (one["eager"], one["graph"], grid["eager"], grid["graph"])]
    ms = turns_ms(fns, reps=5)
    batch = one["graph"].prepare_batch(requests[0])[0]
    fwd = turns_ms([lambda: one["eager"]._step(batch),
                    lambda: one["graph"]._step(batch)], reps=10)
    out = dict(match_batch_ms=dict(zip(
        ("1x1 eager", "1x1 graph", "2x1 eager", "2x1 graph"), ms)),
        forward_ms=dict(eager=fwd[0], graph=fwd[1]))
    print(f"cuda_graphs serving on {card}, 64 pairs by events in turns: "
          f"match_batch 1x1 {ms[0]:.3f} ms eager / {ms[1]:.3f} ms graph, 2x1 "
          f"{ms[2]:.3f} / {ms[3]:.3f} ms; forward {fwd[0]:.3f} ms eager / "
          f"{fwd[1]:.3f} ms graph")
    for arm in ("eager", "graph"):
        w, d = busy(lambda m=one[arm]: m._step(batch), 5)
        out[f"forward_{arm}"] = dict(window_ms=w, device_ms=d)
        print("  " + busy_line(f"forward, {arm}", w, d))
        w, d = busy(lambda m=one[arm]: m.match_batch(requests[0]), 5)
        out[f"match_batch_{arm}"] = dict(window_ms=w, device_ms=d)
        print("  " + busy_line(f"match_batch, {arm}", w, d))
    return out


def graph_clis(dev, counters, card):
    """``train_torch.main`` (2 epochs x 3 steps) and the two eval CLIs
    (200 pairs in batches of 64) with graphs and eagerly: the same losses
    and per-pair results, graphs captured once and replayed, ms a step and
    ms a batch after the first."""
    import contextlib
    import io
    import shutil
    import torch
    import test_registration_metric_torch
    import test_torch
    import train_torch
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    from mdgat_tpu_torch.utils import graphs

    def tree(name, **kw):
        """The train_cli / eval_cli phase's tree (written here under
        ``--only cuda_graphs``): its root and its keypoint directory."""
        root = os.path.join(OUT_DIR, name)
        if not os.path.isdir(root):
            return root, write_synthetic_kitti(root, n_points=512, seed=0,
                                               frames_per_seq=12, **kw)
        return root, os.path.join(root, "keypoints", "synthetic")

    root, kp_dir = tree("kitti_synthetic", seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                        pairs_per_seq=64)
    eval_root, eval_kp = tree("kitti_eval", seqs=(10,),
                              pairs_per_seq=EVAL_PAIRS)
    matching = matching_checkpoint(os.path.join(OUT_DIR, "matching.pth"))

    def run(main, argv, eager):
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            if eager:
                stack.enter_context(graphs.disabled())
            stack.enter_context(contextlib.redirect_stdout(buf))
            stack.enter_context(contextlib.chdir(OUT_DIR))
            result = main(argv)
        torch.cuda.synchronize()
        return result, read_counts(counters)

    out = {}
    train_argv = lambda arm: [
        "--train_path", root, "--keypoints_path", kp_dir,
        "--txt_path", os.path.join(root, "preprocess-random-full"),
        "--model_out_path", os.path.join(OUT_DIR, f"checkpoint_graphs_{arm}"),
        "--device", str(dev), "--batch_size", "64", "--max_keypoints", "512",
        "--epoch", str(CLI_EPOCHS), "--steps_per_epoch", str(CLI_STEPS),
        "--seed", "0"]
    runs = {}
    for arm in ("eager", "graph", "graph", "eager"):
        shutil.rmtree(os.path.join(OUT_DIR, f"checkpoint_graphs_{arm}"),
                      ignore_errors=True)
        summary, launches = run(train_torch.main, train_argv(arm),
                                arm == "eager")
        runs.setdefault(arm, []).append((summary, launches))
    (se, le), (sg, lg) = runs["eager"][0], runs["graph"][0]
    n_train = CLI_EPOCHS * CLI_STEPS
    require(se["epoch_loss"] == sg["epoch_loss"]
            and se["val_loss"] == sg["val_loss"],
            f"cuda_graphs train_torch: losses {sg['epoch_loss']} / "
            f"{sg['val_loss']} with graphs, {se['epoch_loss']} / "
            f"{se['val_loss']} eager")
    cache = sg["state"].graphs
    require((cache.warm_ups, cache.captures, cache.replays)
            == (1, 1, n_train - 1),
            "cuda_graphs train_torch: the train step was not replayed")
    require(lg["train_layer_fwd"] == 2 * 36 and le["train_layer_fwd"]
            == n_train * 36, f"cuda_graphs train_torch: whole-layer "
            f"launches {lg['train_layer_fwd']} with graphs (warm-up and "
            f"capture), {le['train_layer_fwd']} eager")
    loop = {}
    for arm in ("eager", "graph"):
        loop[arm] = [min(1e3 * s["train_loop_s"][e] / s["steps"][e]
                         for s, _ in runs[arm]) for e in range(CLI_EPOCHS)]
    print(f"cuda_graphs train_torch on {card}: equal epoch and validation "
          f"losses {sg['epoch_loss']} / {sg['val_loss']}; loop ms a step "
          f"(epochs 1 / 2, better of two runs) eager "
          f"{' / '.join(f'{x:.2f}' for x in loop['eager'])}, graph "
          f"{' / '.join(f'{x:.2f}' for x in loop['graph'])}")
    out["train_torch_ms_per_step"] = loop
    base = ["--train_path", eval_root, "--keypoints_path", eval_kp,
            "--txt_path", os.path.join(eval_root, "preprocess-random-full"),
            "--device", str(dev), "--batch_size", str(EVAL_BATCH),
            "--ensure_kpts_num", "true", "--seed", "0",
            "--resume_model", matching]
    n_batches = -(-EVAL_PAIRS // EVAL_BATCH)
    for label, main in (("test", test_torch.main),
                        ("registration", test_registration_metric_torch.main)):
        got = {}
        for arm in ("eager", "graph", "graph", "eager"):
            result, launches = run(main, base, arm == "eager")
            steady = (1e3 * (result["seconds"] - result["first_batch_s"])
                      / (result["n_batches"] - 1))
            prev = got.get(arm)
            got[arm] = (result, launches,
                        min(steady, prev[2]) if prev else steady)
        (re_, le_, me), (rg, lg_, mg) = got["eager"], got["graph"]
        for a, b in zip(re_["pairs"], rg["pairs"]):
            require(a["idx"] == b["idx"] and a["line"] == b["line"]
                    and np.array_equal(a["matches0"], b["matches0"]),
                    f"cuda_graphs {label} CLI: pair {a['idx']} differs")
        require(lg_["eval_layer"] == 36 * 2 and le_["eval_layer"]
                == 36 * n_batches, f"cuda_graphs {label} CLI: layer launches "
                f"{lg_['eval_layer']} with graphs, {le_['eval_layer']} eager")
        print(f"cuda_graphs {label} CLI on {card}: {EVAL_PAIRS} pairs equal "
              f"with graphs and eagerly; ms a batch of 64 after the first "
              f"(better of two runs) eager {me:.2f}, graph {mg:.2f}")
        out[f"{label}_cli_ms_per_batch"] = dict(eager=me, graph=mg)
    return out


def cuda_graphs_phase(rng, dev, report, counters, card):
    """The train step, the eval forward, ``Matcher`` and the CLIs captured
    as CUDA graphs, against the same eagerly (phase 16)."""
    import torch
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t
        return out

    eager, graph, batch, train = part("train f32", graph_train, dev,
                                      counters, card, "f32")
    part("validation", graph_validation, graph, eager, batch, counters)
    del eager, graph, batch
    bf16 = part("train bf16", graph_train, dev, counters, card, "bf16",
                profiled=False, compute_dtype="bfloat16")[3]
    # the other kernels of the slice inside a graph: the gap-loss pair
    # (#11, #12) and the fused-MHA pair (#4, #5) on the exact arm
    for label, over in (("loss_kernel", dict(loss_kernel=True)),
                        ("fused-MHA route, exact arm",
                         dict(train_layer=False, exact_topk=True))):
        part(label, graph_train, dev, counters, card, label, timed=False,
             **over)
    serving_out = part("serving", graph_serving, rng, dev, counters, card)
    clis = part("CLIs", graph_clis, dev, counters, card)
    seconds = time.perf_counter() - t0
    print(f"cuda_graphs phase: {seconds:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    report["_cuda_graphs"] = dict(train_f32=train, train_bf16=bf16,
                                  serving=serving_out, clis=clis,
                                  phase_s=seconds, parts_s=parts)


# ---------------------------------------------------------------------------
# phase 17: LightGlue's kernels and its serving path
# ---------------------------------------------------------------------------
# the serving cell's bucket (lightglue-match-b16n2048): 16 pairs, 4 heads of
# 64, 2048 rows on side 0 and 1900 on side 1, 75-100% of each valid
LG_B, LG_H, LG_N, LG_M, LG_DH = 16, 4, 2048, 1900, 64
LG_CELL = "lightglue-match-b16n2048"
LG_SRC = "mdgat_tpu_torch/csrc/lightglue.cu"


def _lg_rel(a, b):
    """(largest absolute error, the same relative to the largest entry of
    ``b``) of ``a`` against ``b`` (float64)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def lg_kernels(dev, report):
    """Each LightGlue kernel against its float64 twin on the same float32
    inputs at the cell's shapes, bit-equal from run to run, then timed by
    CUDA events beside its plain twin, the one PyTorch call that computes
    the same function (SDPA, ``F.layer_norm`` + ``F.gelu``; f32, TF32 off;
    used nowhere in the port) and its bound, counted as the benchmark
    counts it (``bench_gpu/architectures/lightglue.py``)."""
    import torch
    import torch.nn.functional as F
    from bench_gpu.architectures import lightglue as work
    from mdgat_tpu_torch.ops.cuda import lightglue as lgk
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, n, m, dh = LG_B, LG_H, LG_N, LG_M, LG_DH
    d = h * dh
    n0 = torch.randint(n * 3 // 4, n + 1, (b,), generator=g, device=dev)
    n1 = torch.randint(m * 3 // 4, m + 1, (b,), generator=g, device=dev)
    n0[0], n1[0] = n, m                             # one full pair
    mask0 = torch.arange(n, device=dev)[None] < n0[:, None]
    mask1 = torch.arange(m, device=dev)[None] < n1[:, None]
    v0, v1 = n0.double().cpu().numpy(), n1.double().cpu().numpy()

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def times(kernel, plain, library=None, reps=10):
        """(kernel, plain twin, library) ms a call; kernel and library in
        turns."""
        if library is None:
            k, lib = cuda_ms(kernel, reps), None
        else:
            k, lib = turns_ms([kernel, library], reps)
        return k, cuda_ms(plain, reps=2, warmup=1), lib

    out = {}
    # (a) self-attention: q, k, v as the Wqkv product writes them
    qkv = rnd(b, 3 * h, n, dh, scale=2.0)
    ang = rnd(b, n, dh // 2, scale=2.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = lgk.self_attention(qkv, cos, sin, mask0)
    require(torch.equal(got, lgk.self_attention(qkv, cos, sin, mask0)),
            "lg_self_attention differs from run to run")
    want = lgk.self_attention_reference(qkv.double(), cos.double(),
                                        sin.double(), mask0)
    err, rel = _lg_rel(got, want)
    q, k = (lgk._rotate(t, cos, sin).contiguous()
            for t in (qkv[:, :h], qkv[:, h:2 * h]))
    v = qkv[:, 2 * h:].contiguous()
    keys = mask0[:, None, None, :]

    def sdpa_self():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=keys)
    lib_err = _lg_rel(sdpa_self(), want)[1]
    ms = times(lambda: lgk.self_attention(qkv, cos, sin, mask0),
               lambda: lgk.self_attention_reference(qkv, cos, sin, mask0),
               sdpa_self)
    out["lg_self_attention"] = dict(
        rel_err=rel, max_abs_err=err, library_rel_err=lib_err, ms=ms,
        bound=bound(*work._self_call(v0, d, dh)))
    require(rel <= TOL["lg_attention"], f"lg_self_attention disagrees: {rel}")
    del qkv, got, want, q, k, v

    # (b) two-way cross-attention: qk heads, then v heads, of each cloud
    qkv0 = rnd(b, 2 * h, n, dh, scale=2.0)
    qkv1 = rnd(b, 2 * h, m, dh, scale=2.0)
    a0, a1 = lgk.cross_attention(qkv0, qkv1, mask0, mask1)
    again = lgk.cross_attention(qkv0, qkv1, mask0, mask1)
    require(torch.equal(a0, again[0]) and torch.equal(a1, again[1]),
            "lg_cross_attention differs from run to run")
    w0, w1 = lgk.cross_attention_reference(qkv0.double(), qkv1.double(),
                                           mask0, mask1)
    (e0, r0), (e1, r1) = _lg_rel(a0, w0), _lg_rel(a1, w1)
    qk0, v0t = qkv0[:, :h].contiguous(), qkv0[:, h:].contiguous()
    qk1, v1t = qkv1[:, :h].contiguous(), qkv1[:, h:].contiguous()

    def sdpa_cross():               # upstream's flash path: sim twice
        return (F.scaled_dot_product_attention(
                    qk0, qk1, v1t, attn_mask=mask1[:, None, None, :]),
                F.scaled_dot_product_attention(
                    qk1, qk0, v0t, attn_mask=mask0[:, None, None, :]))
    lib = sdpa_cross()
    lib_err = max(_lg_rel(lib[0], w0)[1], _lg_rel(lib[1], w1)[1])
    ms = times(lambda: lgk.cross_attention(qkv0, qkv1, mask0, mask1),
               lambda: lgk.cross_attention_reference(qkv0, qkv1, mask0,
                                                     mask1), sdpa_cross)
    out["lg_cross_attention"] = dict(
        rel_err=max(r0, r1), rel_err_m0=r0, rel_err_m1=r1,
        max_abs_err=max(e0, e1), library_rel_err=lib_err, ms=ms,
        bound=bound(*work._cross_call(v0, v1, d)))
    require(max(r0, r1) <= TOL["lg_attention"],
            f"lg_cross_attention disagrees: m0 {r0}, m1 {r1}")
    del qkv0, qkv1, a0, a1, again, w0, w1, lib, qk0, qk1, v0t, v1t

    # (c) LayerNorm + GELU over the valid rows of one FFN (C = 2D)
    rows = int(n0.sum())
    x = rnd(rows, 2 * d, scale=3.0) + 1.0
    lw, lb = rnd(2 * d) * 0.1 + 1.0, rnd(2 * d) * 0.1
    got = lgk.layer_norm_gelu(x, lw, lb, 1e-5)
    require(torch.equal(got, lgk.layer_norm_gelu(x, lw, lb, 1e-5)),
            "lg_ln_gelu differs from run to run")
    want = lgk.layer_norm_gelu_reference(x.double(), lw.double(),
                                         lb.double(), 1e-5)
    err, rel = _lg_rel(got, want)

    def library_ln():               # the twin is this very call
        return F.gelu(F.layer_norm(x, (2 * d,), lw, lb, 1e-5))
    lib_err = _lg_rel(library_ln(), want)[1]
    k_ms, lib_ms = turns_ms([lambda: lgk.layer_norm_gelu(x, lw, lb, 1e-5),
                             library_ln], 20)
    out["lg_ln_gelu"] = dict(
        rel_err=rel, max_abs_err=err, library_rel_err=lib_err,
        ms=(k_ms, lib_ms, lib_ms),
        bound=bound(4.0 * (2 * rows * 2 * d + 2 * 2 * d), 0.0))
    require(rel <= TOL["lg_ln_gelu"], f"lg_ln_gelu disagrees: {rel}")
    del x, got, want

    # (d) assignment and decision over final projections whose first 70%
    # of rows pair up, read as the benchmark reads the program's answers
    md0 = rnd(b, n, d + lgk.ASSIGN_PAD, scale=0.6)
    md1 = rnd(b, m, d + lgk.ASSIGN_PAD, scale=0.6)
    kk = min(n, m) * 7 // 10
    md1[:, :kk, :d] = md0[:, :kk, :d] + 0.1 * rnd(b, kk, d)
    got = lgk.assign(md0, md1, mask0, mask1, d, 0.1)
    again = lgk.assign(md0, md1, mask0, mask1, d, 0.1)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            "lg_assign differs from run to run")
    twin = lgk.assign_reference(md0.double(), md1.double(), mask0, mask1, d,
                                0.1, return_block=True)
    readings = work.match_readings({"match_threshold": 0.1}, got,
                                   (mask0, mask1), (twin[4],))
    agree = [float(((x == y) | ~mk).float().mean())
             for x, y, mk in ((got[0], twin[0], mask0),
                              (got[1], twin[1], mask1))]
    share = float(((got[0] >= 0) & mask0).sum() / mask0.sum())
    ms = times(lambda: lgk.assign(md0, md1, mask0, mask1, d, 0.1),
               lambda: lgk.assign_reference(md0, md1, mask0, mask1, d, 0.1))
    out["lg_assign"] = dict(
        readings=readings, matches_agree=agree, matched_share=share,
        max_abs_err=readings["score_err"], ms=ms,
        bound=bound(*work._assign_call(v0, v1, d)))
    require(readings["match_gap"] <= TOL["lg_match_gap"]
            and readings["score_err"] <= TOL["lg_score"]
            and readings["decide_gap"] <= TOL["lg_decide"],
            f"lg_assign disagrees with its twin: {readings}")
    require(0.3 < share < 0.9, f"lg_assign matched {share:.3f} of the rows "
                               "(the planted 70% expected)")
    del md0, md1, got, again, twin

    for name, r in out.items():
        kms, pms, lms = r["ms"]
        (bms, by) = r["bound"]
        print(f"  {name}: {kms:.4f} ms ({100 * bms / kms:.1f}% of its bound "
              f"{bms:.4f} ms, {by}), twin {pms:.4f} ms, library "
              f"{'-' if lms is None else f'{lms:.4f}'} ms; error "
              f"{r['max_abs_err']:.3g}")
        report[name] = dict(route="cuda", source=LG_SRC, replaces=None,
                            launches=0, max_abs_err=r["max_abs_err"],
                            ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                            library_ms=lms)
    return out


def lg_serving(dev, counters):
    """``Matcher(net="lightglue")`` on the benchmark's seeded weights at the
    cell's traffic: one eager call with every counter zeroed just before
    (each kernel's launches a forward, every other kernel none), then the
    captured route at the 2048 bucket (one warm-up, one capture, replays
    launching nothing, answers equal to the eager call's), the plain route
    (matches agree), and ms a call of each."""
    import torch
    from bench_gpu.harness import common, traffic, weights
    from mdgat_tpu_torch import Matcher
    conf = common.config("lightglue-fpfh")
    arch = common.architecture(conf)
    fields = arch.program_fields(conf)
    seed = 3100007920
    state = weights.make_weights(conf, seed, dev, arch)
    pools = traffic.pool_pairs(common.workload(LG_CELL)["traffic"], seed)[:2]

    def make(**kw):
        mt = Matcher(device=dev, seed=0, **fields, **kw)
        mt.model.load_state_dict(state, strict=True)
        return mt
    layers = conf["model"]["L"]
    per = {"lg_self_attention": 2 * layers, "lg_cross_attention": layers,
           "lg_ln_gelu": 4 * layers, "lg_assign": 1,
           "gemm": 16 * layers + 4}
    eager = make(cuda_graphs=False)
    for c in counters.values():
        c.reset()
    first = eager.match_batch(pools[0])
    torch.cuda.synchronize()
    launches = read_counts(counters)
    require_launches("lightglue eager forward", launches, per, 1)
    captured = make()
    got = [captured.match_batch(pools[i % 2]) for i in range(2)]
    for c in counters.values():
        c.reset()
    got += [captured.match_batch(pools[i % 2]) for i in range(2)]
    torch.cuda.synchronize()
    require_launches("lightglue replays", read_counts(counters), per, 0)
    cap = captured._step.graphs[0]
    require((cap.warm_ups, cap.captures, cap.replays) == (1, 1, 3),
            f"lightglue graph at 2048: {(cap.warm_ups, cap.captures, cap.replays)}"
            " (warm-ups, captures, replays), not (1, 1, 3)")
    keys = ("matches0", "matches1", "matching_scores0", "matching_scores1")
    require(all(np.array_equal(x[k], y[k]) for x, y in zip(first, got[2])
                for k in keys), "lightglue replay differs from the eager call")
    plain = make(use_kernels=False)
    ref = plain.match_batch(pools[0])
    agree = float(np.mean([np.mean(x["matches0"] == y["matches0"])
                           for x, y in zip(first, ref)]))
    require(agree >= MIN_AGREEMENT, f"lightglue kernel route agrees with "
                                    f"the plain route on {agree:.5f}")
    out = dict(launches=launches, graph=(cap.warm_ups, cap.captures,
                                         cap.replays),
               kernel_vs_plain_agree=agree,
               matched_share=float(np.mean([np.mean(x["matches0"] >= 0)
                                            for x in first])))
    for name, mt in (("captured", captured), ("eager", eager),
                     ("plain", plain)):
        mt.match_batch(pools[1])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(3):
            mt.match_batch(pools[i % 2])
        out[name + "_ms_a_call"] = 1e3 * (time.perf_counter() - t) / 3
    print(f"  lightglue Matcher: launches {launches}, graph {out['graph']}, "
          f"agree {agree:.5f}, ms a call captured "
          f"{out['captured_ms_a_call']:.1f} / eager {out['eager_ms_a_call']:.1f}"
          f" / plain {out['plain_ms_a_call']:.1f}")
    return out


def lightglue_phase(dev, report, counters, card):
    """Phase 17: LightGlue's kernels at the serving cell's shapes, then its
    serving path. ``python3 chip_smoke.py --only lightglue`` runs this
    phase alone, writes ``chip_smoke_out/lightglue.json`` and prints no
    result line."""
    import torch
    print(f"phase 17: LightGlue ({card})")
    kern = lg_kernels(dev, report)
    torch.cuda.empty_cache()
    serving = lg_serving(dev, counters)
    for name in kern:
        report[name]["launches"] = serving["launches"][name]
    report["_lightglue"] = dict(kernels=kern, serving=serving)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "lightglue.json"), "w") as f:
        json.dump(dict(card=card, kernels=kern, serving=serving), f, indent=1)
    torch.cuda.empty_cache()


def make_counters():
    """Every kernel wrapper's launch count, by name."""
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import gap_loss as G
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import lightglue as LG
    from mdgat_tpu_torch.ops.cuda import mha as M
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    return {
        "topk_attention": Counter(A.topk_attention),
        "eval_layer": Counter(Lk.fused_layer), "gemm": Counter(Lk.gemm),
        "gemm_wt": Counter(Lk.gemm, "wt_launches"),
        "sinkhorn": Counter(S.log_optimal_transport_kernel),
        "fused_mha_fwd": Counter(M.fused_mha, "forward_launches"),
        "fused_mha_bwd": Counter(M.fused_mha, "backward_launches"),
        "sinkhorn_bwd": Counter(S.log_optimal_transport_kernel,
                                "backward_launches"),
        "gemm_tn": Counter(Lk.gemm_tn),
        "mha_bwd": Counter(M._attention_backward),
        "train_layer_fwd": Counter(T.fused_train_layer, "forward_launches"),
        "train_layer_bwd": Counter(T.fused_train_layer, "backward_launches"),
        "train_layer_fwd1": Counter(T.h1_stats),
        "train_layer_fwd2": Counter(T.bn_relu_conv2),
        "train_layer_bwd1": Counter(T.bn_backward_sums),
        "train_layer_bwd1_dw2": Counter(T.dw2_db2),
        "train_layer_bwd2": Counter(T.dh1_kernel),
        "gap_loss_fwd": Counter(G.fused_gap_margins, "forward_launches"),
        "gap_loss_bwd": Counter(G.fused_gap_margins, "backward_launches"),
        "lg_self_attention": Counter(LG.self_attention),
        "lg_cross_attention": Counter(LG.cross_attention),
        "lg_ln_gelu": Counter(LG.layer_norm_gelu),
        "lg_assign": Counter(LG.assign)}


def earlier_phases(rng, dev, report, counters, card):
    """Phases 3 to 15, in order."""
    import torch
    check_attention(rng, dev, report)
    check_attention_edges(rng, dev)
    check_layer(rng, dev, report)
    check_sinkhorn(rng, dev, report)
    sinkhorn_fwd_sweep(rng, dev, report, card)
    check_ragged(rng, dev)
    matcher, plain, pairs = serving(rng, dev, report, counters)
    timings(rng, dev, report, card, matcher, plain, pairs)
    report["_graph_times_ms"] = graph_times(rng, dev, card)
    report["_serving_profile"] = profile(matcher, pairs, card)
    del matcher, plain
    torch.cuda.empty_cache()
    check_gemm_modes(rng, dev, report, card)
    check_fused_mha(rng, dev, report)
    check_attention_backward(rng, dev, report, card)
    check_sinkhorn_bwd(rng, dev, report, card)
    check_train_layer(rng, dev, report)
    check_dh2(rng, dev, report, card)
    check_h1_dw2(rng, dev, report, card)
    check_fwd2(rng, dev, report)
    train_layer_kernel_rows(rng, dev, report, card)
    check_gap_loss(rng, dev, report, card)
    gc.collect()                     # the earlier phases' garbage, before
                                     # the arms' peak memory is read
    torch.cuda.empty_cache()
    state, mha_state, plain_state, batch = training(dev, report, counters)
    profile_train(state, batch, card, report)
    train_timings(rng, dev, report, card, state, mha_state, plain_state, batch)
    del state, mha_state, plain_state, batch
    torch.cuda.empty_cache()
    train_cli(dev, report, counters, card)
    torch.cuda.empty_cache()
    eval_cli(dev, report, counters, card)
    torch.cuda.empty_cache()
    one_process = data_parallel(dev, report, counters, card)
    torch.cuda.empty_cache()
    seq_parallel(rng, dev, report, card, one_process)
    del one_process
    torch.cuda.empty_cache()
    wide_clouds(rng, dev, report, counters, card)
    torch.cuda.empty_cache()
    descriptors(dev, report, counters, card)
    torch.cuda.empty_cache()
    fast_topk(rng, dev, report, counters, card)
    torch.cuda.empty_cache()
    matcher_mesh(rng, dev, report, counters, card)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    from mdgat_tpu_torch.ops.cuda._build import library
    from mdgat_tpu_torch.utils import graphs

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)                      # as nvidia-smi prints it
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    lib = library()
    print(f"build: {lib.path.name} nvcc {lib.build_seconds:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(lib.ptxas_log)
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", lib.ptxas_log)]
    spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                          lib.ptxas_log)]
    print(f"ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
          f"registers a thread, {sum(s > 0 for s in spills)} with spill "
          f"stores (at most {max(spills, default=0)} bytes); full report in "
          f"chip_smoke_out/ptxas.log")

    counters = make_counters()
    tl_src = "mdgat_tpu_torch/csrc/train_layer.cu"
    tl_line = {"fwd1": 1329, "fwd2": 1410, "bwd1": 1425, "bwd2": 1477}
    gap_src = "mdgat_tpu_torch/csrc/gap_loss.cu"
    report = {
        "gap_loss_fwd": dict(route="cuda", source=gap_src,
                             replaces="mdgat_tpu/ops/pallas/loss.py:76"),
        "gap_loss_bwd": dict(route="cuda", source=gap_src,
                             replaces="mdgat_tpu/ops/pallas/loss.py:107"),
        **{f"train_layer_{name}": dict(
            route="cuda", source=tl_src,
            replaces=f"mdgat_tpu/ops/pallas/attention.py:{line}")
           for name, line in tl_line.items()},
        # the first conv of _tl_fwd1_kernel; dw2 and db2 of _tl_bwd1_kernel
        "tl_h1": dict(route="cuda", source=tl_src,
                      replaces="mdgat_tpu/ops/pallas/attention.py:1329"),
        "tl_dw2": dict(route="cuda", source=tl_src,
                       replaces="mdgat_tpu/ops/pallas/attention.py:1425"),
        # the BN affine + ReLU + second conv + residual of _tl_fwd2_kernel
        "tl_fwd2": dict(route="cuda", source=tl_src,
                        replaces="mdgat_tpu/ops/pallas/attention.py:1410"),
        # the dh2 product of _tl_bwd1_kernel and of _tl_bwd2_kernel
        "tl_dh2_sums": dict(route="cuda", source=tl_src,
                            replaces="mdgat_tpu/ops/pallas/attention.py:1462"),
        "tl_dh2_dh1": dict(route="cuda", source=tl_src,
                           replaces="mdgat_tpu/ops/pallas/attention.py:1535"),
        "fused_mha_fwd": dict(route="cuda",
                              source="mdgat_tpu_torch/csrc/attention.cu",
                              replaces="mdgat_tpu/ops/pallas/attention.py:933"),
        "fused_mha_bwd": dict(route="cuda",
                              source="mdgat_tpu_torch/csrc/mha_bwd.cu",
                              replaces="mdgat_tpu/ops/pallas/attention.py:995"),
        "mha_bwd_rows": dict(route="cuda",
                             source="mdgat_tpu_torch/csrc/mha_bwd.cu",
                             replaces="mdgat_tpu/ops/pallas/attention.py:995"),
        "mha_bwd_keys": dict(route="cuda",
                             source="mdgat_tpu_torch/csrc/mha_bwd.cu",
                             replaces="mdgat_tpu/ops/pallas/attention.py:995"),
        "gemm_tn": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                        replaces="mdgat_tpu/ops/pallas/attention.py:995"),
        "gemm_wt": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                        replaces="mdgat_tpu/ops/pallas/attention.py:995"),
        "sinkhorn_bwd": dict(route="cuda",
                             source="mdgat_tpu_torch/csrc/sinkhorn_bwd.cu",
                             replaces="mdgat_tpu/ops/pallas/sinkhorn.py:281"),
        "topk_attention": dict(route="cuda", source="mdgat_tpu_torch/csrc/attention.cu",
                               replaces="mdgat_tpu/ops/pallas/attention.py:524"),
        # the same kernel with its fast arm: _stacked_prob's value bisection
        "topk_attention_fast": dict(
            route="cuda", source="mdgat_tpu_torch/csrc/attention.cu",
            replaces="mdgat_tpu/ops/pallas/attention.py:435"),
        "eval_layer": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                           replaces="mdgat_tpu/ops/pallas/attention.py:577"),
        "gemm": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                     replaces="mdgat_tpu/ops/pallas/attention.py:577"),
        "sinkhorn": dict(route="cuda", source="mdgat_tpu_torch/csrc/sinkhorn.cu",
                         replaces="mdgat_tpu/ops/pallas/sinkhorn.py:55"),
    }
    rng = np.random.default_rng(0)
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] else None
    require(only in (None, "cuda_graphs", "lightglue") and len(sys.argv) in
            (1, 3), "usage: chip_smoke.py [--only cuda_graphs|lightglue]")
    # the phases before cuda_graphs count launches per call and time eager
    # calls: every step and forward in them runs eagerly
    with graphs.disabled():
        if only is None:
            earlier_phases(rng, dev, report, counters, card)
    if only in (None, "cuda_graphs"):
        cuda_graphs_phase(rng, dev, report, counters, card)
    if only in (None, "lightglue"):
        lightglue_phase(dev, report, counters, card)
    if only:
        return 0

    kernels = [dict(name=name, **{k: report[name][k] for k in
                                  ("route", "source", "replaces", "launches",
                                   "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")})
               for name in report if not name.startswith("_")]
    for kern in kernels:
        require(kern["launches"] > 0, f"{kern['name']}: never launched")
    retried = {n: w for n, w in PROFILER_WINDOWS.items() if max(w) > 1}
    print(f"profiler windows: {sum(map(len, PROFILER_WINDOWS.values()))} "
          f"reads of {len(PROFILER_WINDOWS)} kernel names, "
          f"{sum(x > 1 for w in PROFILER_WINDOWS.values() for x in w)} of "
          f"them needed more than one window {retried}")
    report["_profiler_windows"] = PROFILER_WINDOWS
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       cuda=torch.version.cuda, report=report), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        # the ranks belong to phases 10 and 11: eager, as in this process
        from mdgat_tpu_torch.utils.graphs import disabled
        with disabled():
            sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
