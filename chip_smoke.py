#!/usr/bin/env python3
"""Drive the PyTorch port (tss_dprnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):
1. set-up: the card's name and power limit, torch and CUDA versions, and
   the nvcc builds of the kernels from csrc/, started together (with
   ptxas's register and spill report, and a summary of every instantiation
   of the serving scan, its cell-state mode named apart, and of the
   bf16-operand product (fp32 and bf16 C));
2. kernel vs plain: bilstm2_forward(_masked) against its plain PyTorch
   version on the card, unmasked at the intra-chunk shape and masked at the
   inter-chunk shape of a batch of 8 x 10 s, in fp32 and bf16 (the serving
   route: the input product of csrc/products.cu, then the serving cluster
   scan of csrc/bilstm2_serve.cu, in 3xTF32 or its bf16 mode; its tile plan
   per stream type and the P buffer printed; both bit for bit on a second
   call and direction 1 exactly 0 past each row's length): fp32 max abs
   error <= 1e-4; bf16 >= 40 dB SNR against the fp32 plain version, and >=
   BF16_SNR_DB and within BF16_ATOL of the bf16 plain version, timed beside
   the plain version and cuDNN's LSTM on the same weights (on a
   PackedSequence in masked mode);
3. the main path: InferencerSpe.run over 12 requests with the flagship
   DPRNN-Spe-TasNet at full width and depth (random weights from a seed);
   the kernel must have been launched 12 times per batch (6 blocks x an
   intra and an inter scan), each after its input product (12 product
   launches per batch), every SI-SDR finite;
4. card vs CPU on one 2 s request (>= 50 dB SNR, fp32) and the request
   bucketed with a longer one against the request run alone;
5. training kernels vs plain: the residual forward (the input product of
   csrc/products.cu, then the cluster scan of csrc/bilstm2_resid.cu) and the
   backward (the cluster scan of csrc/bilstm2_bwd.cu, then the products)
   against their plain versions at the training batch's scan shapes (5 x 3
   s: intra R=970 T=250, inter R=1250 T=194) and masked at phase 2's inter
   shape (fp32; max abs error <= 1e-4 on the outputs and all seven residual
   streams, dx within 1e-4, dW and db within DW_REL_TOL of max |ref|, both
   bit for bit the same on a second call), timed beside the plain versions
   and cuDNN's LSTM forward, backward and both (TF32 off, on a PackedSequence
   in masked mode); and each of the training pair's four products on its own
   at the two unmasked shapes (3xTF32 on the tensor cores), against
   torch.matmul in fp32 (within DW_REL_TOL of max |ref|; the error against a
   float64 product reported beside torch.matmul's), timed beside it and,
   for reference only, beside torch.matmul in TF32;
6. the training path: TrainerSpe.run for 2 epochs at full flagship width and
   depth on in-memory crops from a seed (12 residual-forward and 12 backward
   launches per train step, 12 inference launches per eval step, finite
   losses, 2_last and a *_best written); the best checkpoint served through
   InferencerSpe; 10 steps on one repeated batch lower the loss (steady-state
   ms/step printed); one step card vs CPU at 1 x 1 s (loss within 1e-4
   relative, concatenated gradients >= 40 dB SNR).

7. stacked-direction kernels vs plain: lstm_forward (fp32 and bf16: per
   direction the input product of csrc/products.cu, then the serving cluster
   scan of csrc/bilstm2_serve.cu), lstm_forward_with_cs (the input
   products, then the serving scan's cell-state mode: bit for bit on a second
   call, its h bit for bit lstm_forward's), lstm_forward_resid (the input
   products, then the training
   forward's cluster scan of csrc/bilstm2_resid.cu; its four streams, the
   saved gate pre-activations among them) and lstm_backward (the cluster scan
   of csrc/lstm_bwd.cu, which reads those pre-activations, then the
   products, from the resid route's streams) against their plain versions
   at D = 1 and the inter-chunk shapes of BSS serving (8 x 10 s: R=2000
   T=642) and training (5 x 3 s: R=1250 T=194), plus a small D = 2 case with
   different inputs per direction and a wide one (same tolerances as phases
   2 and 5; the fp32 forwards and the backward bit for bit the same on a
   second call; the cluster scans' tile plans printed), timed beside the
   plain versions and a unidirectional cuDNN LSTM (TF32 off);
8. BSS serving: Inferencer.run with DPRNN-TasNet at the width and depth of
   configs/train_bss.yaml and ``bidirectional: false`` over 12 two-speaker
   mixtures (6 bilstm2_forward + 6 lstm_forward launches per batch and no
   other kernel; a bucketed row equals the request alone; card vs CPU >= 50
   dB), then ``bidirectional: true`` at 2 repeats (2 unmasked + 2 masked
   bilstm2 launches per batch, card vs CPU >= 50 dB);
9. BSS training: Trainer.run with ``bidirectional: false`` for 2 epochs (per
   train step 6 bilstm2_forward_resid + 6 bilstm2_backward + 6
   lstm_forward_resid + 6 lstm_backward launches, with 54 product and 12
   column-sum launches, per eval step 6 + 6
   inference launches), the best checkpoint served through the BSS
   Inferencer, 10 steps on one batch (ms/step), one step card vs CPU;
10. the opt-in and test-only kernels vs plain, all on the serving route (the
   input product of csrc/products.cu, then the serving scan; bf16 x through
   the bf16-operand product): the dense mode of the fused kernel (the scan's
   outputs side by side into a scratch, then its two SplitDense products in
   csrc/products.cu, a bf16 output for bf16 streams), the shared-input mode
   of _lstm_kernel (bilstm_fused: the pair's outputs side by side), and the
   batch-major and manual-DMA kernels' entries (bilstm2_forward_bm;
   bilstm_v2, lstm_scan_v2, dtype 2 for the manual-DMA kernel's bf16
   rounding), at the intra-chunk shape of 8 x 10 s (lstm_scan_v2 at D = 1
   R=2000 T=642) and a ragged case each, fp32 and bf16 (tolerances as in
   phase 2; bf16 55 dB for the manual-DMA kernel's rounding), the route's fp32
   outputs bit for bit the default route's (bilstm_fused's bf16 outputs bit
   for bit the batch-major entry's), one fp32 and one bf16 call launching the
   entry twice and one product of each kind (the dense mode three); timed
   beside the plain versions, the bound and cuDNN (for the dense mode cuDNN
   plus two cuBLAS half-products), the bf16 input product alone with its
   TFLOP/s and share of the call (and the dense mode's two output products
   alone, both lanes); the bf16 product on its own at the pair's shape
   against its plain version and float64 (BF16_PRODUCT_REL_TOL), timed beside
   its bound and an fp32 torch.addmm;
11. the opt-in paths: InferencerSpe.run over phase 3's requests with
   TSS_FUSED_DENSE=1 (6 bilstm2_dense_forward + 6 masked launches per batch,
   each dense call with its input and two output products, and no other
   kernel) and with TSS_BM=1 (6 bilstm2_forward_bm + 6 masked, each after its
   input product), each against the switch-off forward on a bucketed batch
   (>= 60 dB); both switches in the bf16 lane (6 + 6 a batch, the intra
   scans' products the bf16-operand kernel's) against the fp32 lane (>=
   LANE_SNR_DB) and beside the default bf16 lane; a
   TrainerSpe run of one epoch with TSS_FUSED_DENSE=1 (12 residual-forward +
   12 backward launches per train step, 12 dense launches per eval step) and
   one train step against the switch-off step (loss within 1e-5 relative,
   gradients >= 60 dB). The environment is restored afterwards;
12. widths the kernels do not take natively: the verify skill's tiny TSS and
   causal BSS models (feature 12, hidden 10; the wrappers zero-pad to
   multiples of 16), one bucketed batch served and one train step each, card
   vs CPU (>= 50 dB; loss within 1e-4 relative, gradients >= 40 dB), through
   the expected kernels only;
13. the shipped entry points ([cli]): a synthetic LibriMix corpus (20 train
   and 10 eval mixtures of 3-5 s, 12 test mixtures of 2-10 s, written with
   the port's data/wav.py), its manifests frozen by cli.generate_manifests
   from YAML read by the port's reader; cli.train on configs/train_tss.yaml
   (full flagship width) for 2 epochs with in-range eval mixtures
   (``logs.metadata.ids`` CLI_IDS; the shipped ids reach 2899, past the
   synthetic eval split) and no other override of the logs section (12
   residual-forward + 12 backward launches per train step, 12 inference
   launches per eval step and per eval mixture after each new best
   checkpoint, finite epoch losses, 2_last and a *_best, the reporter's
   'train', 'eval' and 'inference_spe' lines); cli.test on
   configs/test_tss.yaml as shipped (metrics si_sdr, stoi, pesq) with that
   checkpoint, on the host lane, with --device-metrics and with
   --device-pesq (6 unmasked + 6 masked launches per batch, each after its
   input product, and no other kernel; final_metrics.json with the six
   keys, finite; the estimate copied to the host and the metric pool
   started only for a host metric), the host lane's rows against a direct
   InferencerSpe.run with the metric pool off (CLI_ROW_TOL) and, on the 3
   shortest mixtures, against the port's CPU run (CPU_ROW_TOL), the device
   lanes' rows against the host lane's (LANE_TOL); the wall times of the
   test CLI with si_sdr alone and with each lane (each device lane twice:
   its first run pays its one-time set-up), and the share the metrics add; cli.test --mode bss on configs/test_bss.yaml as shipped, with a
   seeded DPRNN-TasNet, on the host lane and with --device-pesq (6 + 6
   launches per batch, finite metrics, the device rows against the host
   rows at LANE_TOL);
14. the other families ([families]), fp32 at full width: DPRNN-Spe-TasNet
   with each fusion of FUSIONS, InferencerSpe.run over phase 3's requests
   with exactly the 'att' path's launches (6 + 6 per batch, each after its
   input product), card vs CPU on a bucketed batch (>= 50 dB) and one
   TrainerSpe train step card vs CPU (12 + 12 launches and their products;
   loss within 1e-4 relative, gradients >= 40 dB); DPRNN-TasNet
   (bidirectional) with each cell of CELLS, which launches no kernel: a
   served batch and a train step card vs CPU at the same bars, a batch of 4
   and a 5 x 3 s train step timed on the card; and the device metric lane
   alone, stoi_batch and pesq_batch on 8 ragged rows of 10 s at most
   stacked over their mixtures (16 rows), ms per batch on the card beside
   the host lane's ms for the same rows, the card within LANE_TOL of the
   host;
15. the last two families ([ira-rawnet]), fp32 at full width:
   DPRNN-Spe-IRA-TasNet at the flagship's widths (IRA) and
   DPRNN-RawNet-TasNet at its defaults (RawNet3 C 1024, scale 8, E 256) over
   the flagship core. Each is served over phase 3's requests (IRA: 12
   unmasked + 12 masked launches per batch, 9 + 9 with share_blocks=3;
   RawNet, through InferencerRawNet on 16 kHz references: 6 + 6; each after
   its input product, and no other kernel), its serving rate timed on
   chip_profile.py's batch of 8 beside the flagship's, card vs CPU on a
   bucketed batch (>= 50 dB)
   and a bucketed row against the request alone; one train step card vs
   CPU at 1 x 1 s (loss within 1e-4 relative, gradients >= 40 dB; an IRA
   step checkpoints pass 1, whose 6 blocks run their residual forwards again
   in the backward: 36 residual forwards and 24 backwards); a 5 x 3 s train
   step timed with its peak memory (IRA with pass 1 checkpointed and not:
   the same loss bit for bit, gradients within 1e-6 of their max). Then
   cli.train on configs/train_tss.yaml for one epoch with each family
   (--mode tss_spe with model.target=dprnn_spe_ira_tasnet, --mode tss_rawnet
   with model.target=dprnn_rawnet_tasnet and model.embeddings_size=256) on
   phase 13's corpus with its eval mixtures, and cli.test on
   configs/test_tss.yaml's metrics with each checkpoint (finite
   final_metrics.json, the launches per batch); a share_blocks=3
   checkpoint refused by cli.test under share_blocks=0.

16. variable-length training and the trainer's other knobs ([varlen]), fp32
   at full flagship width: a synthetic corpus of whole utterances (20 train
   and 10 eval mixtures of 2-8 s, phase 13's writer) with manifests frozen
   with ``segment: null``; cli.train for one epoch with
   ``data.variable_length=true data.max_segment=5 data.n_buckets=4`` and
   in-range eval mixtures, on configs/train_tss.yaml (--mode tss_spe; per
   train step 6 + 6 residual forwards, unmasked and masked, and 6 + 6 fused
   backwards, with their 60 products and 12 column sums, and no
   lstm_forward_with_cs), configs/train_bss.yaml with the causal inter scan
   (--mode bss) and --mode tss_rawnet, ms per step by bucket and the run's
   peak memory, a checkpoint each; one 2 x 1 s variable-length TSS step card
   vs CPU (loss within 1e-4 relative, gradients >= 40 dB); the same step with
   other garbage past the lengths (loss and every gradient within 1e-6 of
   their size); accum_steps=5 against 1 at 5 x 3 s (BSS: loss 1e-4, gradients
   40 dB; TSS: BatchNorm's running statistics those of the last micro-batch
   alone); lstm_save_every=10 against 1 on the largest bucket (12
   lstm_forward_with_cs launches, each after its two input products, and no
   training pair; loss 1e-4, gradients 40 dB); schedule_masks on a 5 x 3 s step (value neutral within 1e-4, the
   unmasked pair's launches); each of these steps timed as a second step
   of its trainer, with the peak memory of both; and the masked
   residual forward and backward at the largest bucket's inter shape and the
   want_cs forward at D = 2 over its intra shape against their plain
   versions (1e-4; dW and db DW_REL_TOL; want_cs bit for bit on a second
   call, its h bit for bit lstm_forward's, its tile plan and waves printed),
   timed beside them, the bound and cuDNN.

17. the bf16 lane ([bf16], ``model.dtype: bfloat16``) at full flagship width:
   (a) the bf16 streams of the four training modes (the residual forward
   of the fused pair at the training batch's intra and inter shapes and
   masked at phase 2's inter shape, its backward on the kernel's own saved
   streams, and the causal scan's residual forward and backward at D = 1)
   against their plain versions: outputs and the saved h, c, tanh(c)
   within BF16_ATOL (of max(1, |ref|) for c) at BF16_SNR_DB, dx within
   BF16_ATOL, dx, dW and db at BF16_GRAD_SNR_DB, bit for bit on a second
   call, timed beside the plain versions, the bound (bf16 peak) and cuDNN's
   LSTM in bf16 (training mode); the serving modes' rows come from phases 2
   and 7; (b) the flagship served in both lanes on the same weights at
   batch 8 and 32 (chip_profile.py's and bench_serve.py's rows), the bf16
   lane >= LANE_SNR_DB against the fp32 lane, 6 + 6 bf16 serving scans per
   batch, each after its input product (12 products), and no other kernel;
   (c) the same at batch 8 for the causal and the
   bidirectional DPRNN-TasNet, the 'add' fusion, IRA and RawNet; (d) a 5 x 3
   s train step in both lanes for TSS, causal BSS, IRA and RawNet (ms of the
   second step, peak memory, the bf16 launches per step: one more dx
   product per fused backward, db from the scan's partial sums), and one 2 x
   1 s bf16 TSS step card vs CPU (loss within BF16_STEP_LOSS_REL, gradients
   >= BF16_STEP_GRAD_SNR_DB); (e) cli.train on configs/train_tss.yaml with
   ``--set model.dtype=bfloat16`` for one epoch on phase 13's corpus and
   cli.test with its checkpoint, and phase 13's fp32 checkpoint through
   cli.test in both lanes, the mean SI-SDR gap printed; (f) the
   variable-length cli.train run of phase 16 (--mode tss_spe) again with
   ``model.dtype=bfloat16``, on phase 16's corpus: per train step 6 + 6 bf16
   residual forwards and fused backwards, unmasked and masked (the masked
   training modes' launches in the kernels line), ms per step by bucket
   beside phase 16's fp32 run; (g) accum_steps=5 on a 5 x 3 s bf16 step, as
   phase 16 holds the fp32 lane: causal BSS against accum_steps=1 (loss
   within BF16_STEP_LOSS_REL, gradients >= BF16_STEP_GRAD_SNR_DB); TSS,
   BatchNorm's running statistics those of the last micro-batch alone
   (within 1e-6); (h) lstm_save_every=10 in the bf16 lane: the bf16 want_cs
   mode (the bf16-operand input products, then the serving scan's
   cell-state mode) against its plain version at D = 2 over the 5 x 3 s
   step's intra shape (h within BF16_ATOL at BF16_SNR_DB, the fp32 cell
   state within CS_FREE_RTOL of max(1, |ref|), and within CS_STEP_RTOL per
   step from the kernel's own h and c; bit for bit on a second call, its h
   bit for bit bf16 lstm_forward_resid's), timed beside the plain version
   and the bound; a 5 x 3 s TSS step with lstm_save_every=10 in both lanes
   (12 lstm_forward_with_cs launches, each after its two input products, and
   no other kernel; ms of the second step and peak memory), and the bf16
   step card vs CPU (loss within BF16_STEP_LOSS_REL, gradients >=
   BF16_STEP_GRAD_SNR_DB).

18. the serving tools ([serve-tools]), fp32 at full width: first the scans
   at the shapes below that phase 2 does not hold (60 s full length intra
   R=3842 T=250 and inter R=250 T=3842, the windowed batch R=2568 T=250 and
   R=1000 T=642, the batch-1 bucket R=642 T=250 and masked R=250 T=642),
   each against its plain version at phase 2's bars in both lanes; (a) cli.separate
   on a synthetic 60 s 8 kHz WAV from the seed, with the flagship (4 s
   reference, phase 3's weights) and the BSS model of configs/test_bss.yaml
   (bidirectional, as shipped; seeded weights), each full length (12
   bilstm2_forward launches, each after its input product) and with
   ``--window-secs 10 --batch 4`` (11 windows, 3 forwards: 36 + 36), and no
   other kernel; the files' rate, length and finite values; wall s and
   audio-s per s; an input of one window or less, windowed with a hop of a
   window, bit for bit the forward on the zero-padded window; card vs CPU
   through the CLI on 3 s with 1 s windows for bss, tss_spe and tss_rawnet
   (an 8 kHz reference, resampled to 16 kHz), >= 50 dB; (b) cli.export_model
   on the flagship at --secs 10 --batch 8 (buckets 1 and 8 x 10 s), bf16 (the
   default) and fp32, each artifact loaded in a fresh process that imports
   the export module alone (no model code) and called on 3 requests of 4-10
   s and on 1 (the buckets picked: 8 and 1), each call 6 + 6 serving scans
   and 12 input products and no other kernel, against the eager masked
   forward on the same padding (fp32 >= 60 dB, its max |err| and whether it
   is bit for bit; bf16 >= LANE_SNR_DB against fp32 eager); the export s per
   bucket, the artifact's bytes; the call's wall ms beside the eager
   forward's through the same host path (ServingModel.call's padding and
   copies), the program's and the eager forward's device ms alone, and one
   call of each under torch.profiler (the card's busy ms and idle share,
   the host's launches, copies, synchronizations and value reads);
   (c) cli.results_table over phase 13's final_metrics.json files, each row
   as the file holds it.

19. the time-major lane ([time-major], ``TSS_TM``) at full flagship width:
   (a) the five time-major entries (bilstm2_forward_tm, _masked_tm at the
   serving shapes of phase 2; bilstm2_forward_resid_tm at the training
   batch's intra and inter shapes, _resid_masked_tm at phase 2's inter
   shape, and bilstm2_backward_tm at all three), fp32 and bf16, each
   against its plain version at phase 2's / 5's bars (fp32) or phase 17's
   (bf16), and against the batch-major route on the transposed input: the
   outputs, the seven saved streams and dx bit for bit, dW and db within
   DW_REL_TOL (the products sum the row-steps in the other order); timed
   beside the batch-major route in turns, the plain version (the checking
   call), the bound and cuDNN's LSTM on time-major input
   (``batch_first=False``; training mode for the training entries);
   (b) the flagship through InferencerSpe.run over 8 requests (one batch)
   under TSS_TM=1 and 0 in both lanes (6 + 6 time-major serving scans per
   batch, each after its input product, and no other kernel), one batch of 8
   x 10 s in each: fp32 time-major against fp32 batch-major >=
   TM_LAYOUT_SNR_DB, bf16 time-major against the fp32 lane >= LANE_SNR_DB,
   bf16 time-major against bf16 batch-major reported; the forward's rate in
   both layouts in turns, fp32 at batch 8 and bf16 at 8 and 32 (the bf16
   default's decision, ops/rnn.SERVE_BF16_TIME_MAJOR); (c) a 5 x 3 s TSS
   train step with lengths (the inter scans masked) under TSS_TM=1 against
   TSS_TM=0, fp32 and bf16 (6 + 6 time-major residual forwards and 12
   time-major backwards, with their products; loss within 1e-4 relative,
   gradients >= TM_GRAD_SNR_DB); (d) one 8 x 10 s fp32 bucket exported
   with TSS_TM=1 (6 + 6 time-major operator nodes), saved, loaded and called
   on 3 requests, bit for bit the eager forward on the same padding.
   Phase 1 reports the scans' registers by layout (the batch-major ones
   against BATCH_MAJOR_REGISTERS) and fails on any spill.
20. data parallelism ([scaling], ``parallel``) on phase 13's corpus, each
   run under ``python -m torch.distributed.run --standalone`` over this
   script's ``--ddp-child`` (which runs the CLI and writes its launches,
   counted from 0 in that process): (a) cli.train on configs/train_tss.yaml
   as phase 13 runs it, at world size 1 on NCCL, so through
   DistributedDataParallel: its launches equal phase 13's, its checkpoint's
   parameter moves against phase 13's >= DDP_MOVE_SNR_DB (not bit for bit:
   cuDNN's convolution weight gradients vary from run to run), its ms/step
   printed beside phase 13's; in the same process a 5 x 3 s step through DDP
   and without, in turns, its gradients through DDP bit for bit the model's
   own under cudnn.deterministic, and the gradients two passes differ in
   under cuDNN's defaults; (b) cli.test --data-parallel 1 under the launcher
   (phase 13's si_sdr run: 12 serving scans per batch with their products),
   its rows against phase 13's; (c) two processes on the one card through
   gloo (NCCL takes one process per card): DDP_STEPS flagship TSS steps at
   global batch DDP_BATCH (each process 12 + 12 training kernels a step),
   both processes' parameters bit for bit equal, against one process over
   the same batches (losses within DDP_LOSS_REL, first-step gradients >=
   DDP_GRAD_SNR_DB, parameter moves >= DDP_MOVE_SNR_DB), then cli.test
   --data-parallel 2: proc0/ and proc1/ partition the utterances, the merged
   rows against phase 13's; (d) in the same launch, the two processes as a
   1 x 2 data x model mesh (``parallel.make_mesh(model=2)``): DDP_STEPS
   flagship TSS steps at global batch DDP_BATCH, each process holding its
   slice of the 111 sharded parameters and stepping the whole batch on the
   gathered weights (12 + 12 training kernels a step each), the whole
   states bit for bit equal, against (c)'s one process (losses within
   DDP_LOSS_REL, first-step gradients >= DDP_GRAD_SNR_DB, moves >=
   DDP_MOVE_SNR_DB). Phase 17 leaves phase 13's corpus and best checkpoint
   for it; it removes them.

Every serving count includes the input products: each
bilstm2_forward(_masked) launch runs one products_gemm launch first, and each
lstm_forward launch one per direction (one on every path: the causal inter
scan has D = 1), each bilstm2_forward_bm launch one and each
bilstm2_dense_forward launch three (its input product and two output
products), in both lanes (``with_products``), and the phases check those
counts too.

The script adopts the processes its children leave behind (a subreaper);
after each phase it names any process still running below it, and at its
end, also after a failure, it stops every one of them ([cleanup]).

The line before the last is {"kernels": [...]} with the kernels' numbers;
the last line is {"ok": true, "device": {...}}. Files go to
chiprun_out/chip_smoke/ under the checkout (summary.json holds every
number).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# the flagship DPRNN-Spe-TasNet, 'att' fusion (FLAGSHIP of the JAX package)
FLAGSHIP = dict(
    input_size=64, feature_size=128, hidden_size=128, chunk_length=250,
    kernel_size=2, hop_length=125, n_repeats=6, bidirectional=True,
    norm_type="ln", activation_type="sigmoid", dropout=0,
    O=128, P=256, embeddings_size=128, num_spks=251, fusion_type="att",
)
# DPRNN-TasNet as configs/train_bss.yaml:18-30 has it, with the causal
# (unidirectional) inter-chunk scan
BSS = dict(
    input_size=64, feature_size=128, hidden_size=128, chunk_length=250,
    kernel_size=2, hop_length=125, n_repeats=6, bidirectional=False,
    norm_type="ln", activation_type="sigmoid", dropout=0,
)
# the verify skill's tiny drive models (feature 12, hidden 10): widths the
# kernels take only through their wrappers' zero padding to multiples of 16
TINY_BSS = dict(
    input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
    hop_length=20, n_repeats=1, bidirectional=False, norm_type="ln",
    activation_type="sigmoid", dropout=0,
)
TINY_SPE = dict(TINY_BSS, bidirectional=True, O=8, P=12, embeddings_size=8, num_spks=251,
                fusion_type="att")
SAMPLE_RATE = 8000
SEED = 0
# published H100 SXM peaks: dense TF32 and bf16 on the tensor cores, HBM3.
# fp32-accurate work needs at least three TF32 products per fp32 one (3xTF32,
# as csrc/products.cu runs its products), so every fp32 row is bounded by
# PEAK_TF32 / 3 = 165 TFLOP/s: the least time the card can take for it. (The
# fp32 FMA pipe's 67 TFLOP/s is a looser floor that a kernel off the tensor
# cores cannot beat.)
PEAK_TF32 = 495e12
PEAK_FP32 = PEAK_TF32 / 3
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# bf16 kernel vs bf16 plain version. The two sum a gate in different orders,
# so a rounded h may differ by a bf16 ulp (2^-8 for |h| in [0.5, 1)): the
# kernel is 1 ulp off at most and about 80 dB SNR on an H100, where a kernel
# that fed h back unrounded was also 1 ulp off but about 60 dB. The SNR bound
# is the one that holds the rounding.
BF16_ATOL = 2.0 ** -7
# the bf16 want_cs mode's fp32 cell state against its plain version, relative
# to max(1, |ref|): free-running (the two bf16 h sequences part where one
# rounds the other way), and per step from the kernel's own h and c
# (ops/lstm.lstm_cs_step_reference). A store rounded to bf16 reads up to 2^-9.
CS_FREE_RTOL = 1e-3
CS_STEP_RTOL = 1e-4
BF16_SNR_DB = 70.0
# The manual-DMA kernel's entries (the serving scan's dtype 2) round as the
# TPU source does in bf16: the gates, each operation of the activations, i *
# g, tanh(c) and h, six roundings per unit and step where the other kernels
# round once, so a gate summed in another order flips many more roundings. Its plain version
# against the same rounding with fp64 gate sums reads 62.44 dB at R=2000
# T=642 and 65.14 dB at R=5136 T=250 (scripts/port/v2_bf16_floor.py, CPU);
# two fp32 orders drift about 3 dB further. The h-only rounding of
# lstm_reference scores 45.15 dB against it (measured again in phase 10).
V2_BF16_SNR_DB = 55.0
# The bf16-operand input product against float64, relative to max |ref|: its
# fp32 accumulation truncates, but a K = 128 chain of 8 mma stays within a
# few fp32 ulps; 2^-16 is 256 times below half a bf16 ulp, where the gates
# that read it are rounded (or h is).
BF16_PRODUCT_REL_TOL = 2.0 ** -16
# the fp32 serving route of bilstm2_forward(_masked): the input product, then
# the serving cluster scan
SERVE_SOURCE = "tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu"
SERVE_WITH = "tss_dprnn_tpu_torch/csrc/products.cu"
# the JAX package's opt-in scan switches, as ops/rnn.py reads them
SWITCHES = ("TSS_FUSED_DENSE", "TSS_BM")
# the training batch of the reference's config (configs/train_tss.yaml):
# 5 crops of 3 s
TRAIN_BATCH = 5
TRAIN_SECONDS = 3
# backward kernel vs plain version, dW and db: each entry is an fp32 sum over
# R * T ~ 2.4e5 row-steps (up to 6.4e5 masked), which the kernel cuts into
# fixed partials and the plain version hands to cuBLAS in its own order.
# Rounding grows about as sqrt(terms) * 2^-24 of the terms' scale, about 1e-5
# of max|ref| here; a tile or split left out would be off by ~1/30 of it.
DW_REL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def become_subreaper() -> None:
    """Adopt this process's orphaned descendants (``prctl``'s
    PR_SET_CHILD_SUBREAPER on this process alone): a process that a child
    leaves behind, even in a session of its own (torch.distributed.run starts
    its launcher and workers so), stays below this one, where
    :func:`stop_descendants` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def _descendants() -> dict:
    """pid -> (state, command line) of every process below this one, read
    from /proc."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:  # it ended meanwhile
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        children.setdefault(int(ppid), []).append((int(name), state))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid, state in children.get(todo.pop(), []):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                cmd = ""
            found[pid] = (state, cmd)
            todo.append(pid)
    return found


def note_running(tag: str) -> None:
    """Name, under the phase ``tag``, each process still running below this
    one when the phase is done (:func:`stop_descendants` stops them at the
    end)."""
    for pid, (state, cmd) in sorted(_descendants().items()):
        if state != "Z":
            log(f"[{tag}] still running after the phase: {pid} {cmd}")


def _reap() -> None:
    """Collect every ended child of this process."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(grace_s: float = 10.0) -> list:
    """Stop every process still running below this one: SIGTERM, then
    SIGKILL after ``grace_s``; collect them. Returns "pid command line" of
    each one found running."""
    import signal

    _reap()
    live = {pid: cmd for pid, (state, cmd) in _descendants().items() if state != "Z"}
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in _descendants():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + (grace_s if sig == signal.SIGTERM else 30.0)
        while time.monotonic() < deadline:
            _reap()
            if not _descendants():
                break
            time.sleep(0.05)
        if not _descendants():
            break
    left = _descendants()
    if left:
        raise RuntimeError(f"processes below this one outlived SIGKILL: {left}")
    return [f"{pid} {cmd}" for pid, cmd in sorted(live.items())]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host wall time of ``fn`` over ``reps`` calls after one warm-up,
    each run to its end on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def call_profile(fn) -> dict:
    """One warm call of ``fn`` under ``torch.profiler``: its wall ms there,
    the card's busy ms (the device events' own time, summed; one stream, so
    none overlap) and idle share, the device events, the host's kernel
    launches and copies, its waits on the card (stream, device and event
    synchronizations, the last one ours) and its reads of a device value
    (``aten::_local_scalar_dense``). ``{"error": ...}`` where the profiler
    fails, and busy ms None where it sees no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = list(prof.events())
    except Exception as e:  # noqa: BLE001 - the profiler is untried on the card's machine
        return {"error": f"{type(e).__name__}: {e}"}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 if device else None

    def count(*names):
        return sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in names)

    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1 - busy / wall),
            "device_events": len(device),
            "launches": count("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                              "cuLaunchKernelEx"),
            "copies": count("cudaMemcpyAsync", "cudaMemcpy"),
            "syncs": count("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaEventSynchronize"),
            "host_reads": count("aten::_local_scalar_dense")}


def snr_db(got, want) -> float:
    got, want = got.double(), want.double()
    return float(10 * math.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-300)))


def bound_dense(rows_steps: int, R: int, T: int, F: int, H: int, Fo: int, itemsize: int,
                peak: float):
    """The dense mode's least time: the scan's FLOPs plus 2 H Fo per row-step
    and direction for the product, over the named peak; or x read once, both
    Fo-wide outputs written once and the weights (W, b, wo) read once, over
    the HBM rate."""
    flops = 2 * rows_steps * (2 * (F + H) * 4 * H + 2 * H * Fo)
    nbytes = ((rows_steps * F + 2 * R * T * Fo) * itemsize
              + 2 * ((F + H + 1) * 4 * H + H * Fo) * 4)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def all_launches():
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from tss_dprnn_tpu_torch.ops import bilstm2, lstm

    return {e.__name__: e.launches for e in (*bilstm2.ENTRIES, *lstm.ENTRIES)}


def product_launches():
    """The product and column-sum kernels' launch counts (csrc/products.cu),
    launched inside the training entries."""
    from tss_dprnn_tpu_torch.ops import bilstm2

    return bilstm2.product_launch_counts()


def reset_launches() -> None:
    from tss_dprnn_tpu_torch.ops import bilstm2, lstm

    bilstm2.reset_launch_counts()
    lstm.reset_launch_counts()


def expect_launches(got, per_step, steps: int, what: str) -> None:
    """``got`` must be ``steps`` times ``per_step`` for the wrappers named
    there and 0 for every other wrapper."""
    want = {name: steps * per_step.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: expected {per_step} per step over {steps} steps and no "
                             f"other kernel, counted {got}")


# the bf16 training modes' products per call (csrc/products.cu): the
# forward's bf16-operand input product; the backward's dx per direction
# (bf16-operand, bf16 output), dW_ih and dW_hh per direction (column layout)
# and db's column sum; the stack's paths run D = 1
BF16_TRAIN_PRODUCTS = {
    "bilstm2_forward_resid": {"products_gemm_bf16": 1},
    "bilstm2_forward_resid_masked": {"products_gemm_bf16": 1},
    "lstm_forward_resid": {"products_gemm_bf16": 1},
    "bilstm2_backward": {"products_gemm_bf16": 2, "products_gemm_bf16_col": 3,
                         "products_colsum": 1},
    "bilstm2_backward_masked": {"products_gemm_bf16": 2, "products_gemm_bf16_col": 3,
                                "products_colsum": 1},
    "lstm_backward": {"products_gemm_bf16": 1, "products_gemm_bf16_col": 2, "products_colsum": 1},
    # the time-major lane's (phase 19): the same launches
    "bilstm2_forward_resid_tm": {"products_gemm_bf16": 1},
    "bilstm2_forward_resid_masked_tm": {"products_gemm_bf16": 1},
    "bilstm2_backward_tm": {"products_gemm_bf16": 2, "products_gemm_bf16_col": 3,
                            "products_colsum": 1},
}


def save_every_launches(calls: int, bf16: bool = False):
    """An lstm_save_every step's launches: ``calls`` lstm_forward_with_cs
    launches over the TSS model's two-direction scans, each after one input
    product per direction (3xTF32, or the bf16-operand product in the bf16
    lane), and no other kernel."""
    return {"lstm_forward_with_cs": calls,
            "products_gemm_bf16" if bf16 else "products_gemm": 2 * calls}


def with_products(per_step, bf16: bool = False):
    """``per_step`` launches of the kernel wrappers, plus the input product
    that each serving scan (fp32 or bf16) launches first: one per bilstm2
    scan, and one per direction of an lstm_forward scan, whose paths all run
    D = 1; a dense-mode call adds its two output products. The batch-major
    and dense entries' products are the 3xTF32 kernel's in fp32 and, in the
    bf16 lane (``bf16``), the bf16-operand kernel's. In the bf16 lane the
    training modes' products too (BF16_TRAIN_PRODUCTS); fp32 training
    products are given in ``per_step``."""
    n = sum(per_step.get(k, 0) for k in ("bilstm2_forward", "bilstm2_forward_masked",
                                         "lstm_forward", "bilstm2_forward_tm",
                                         "bilstm2_forward_masked_tm"))
    own = per_step.get("bilstm2_forward_bm", 0) + 3 * per_step.get("bilstm2_dense_forward", 0)
    out = dict(per_step, products_gemm=per_step.get("products_gemm", 0) + n + (0 if bf16 else own))
    if bf16 and own:
        out["products_gemm_bf16"] = per_step.get("products_gemm_bf16", 0) + own
    if bf16:
        for entry, products in BF16_TRAIN_PRODUCTS.items():
            for kernel, k in products.items():
                out[kernel] = out.get(kernel, 0) + k * per_step.get(entry, 0)
    return out


def bound(rows_steps: int, R: int, T: int, F: int, H: int, itemsize: int, peak: float):
    """Least time for the work: the FLOPs the data needs (both directions over
    ``rows_steps`` row-steps) over the named peak, or each input read once
    (the row-steps' x, the fp32 weights and biases) and both outputs written
    once over the HBM rate."""
    flops = 2 * rows_steps * 2 * (F + H) * 4 * H
    nbytes = rows_steps * F * itemsize + 2 * R * T * H * itemsize + 2 * (F + H + 1) * 4 * H * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cudnn_lstm(torch, w_ih2, b2, w_hh2, dtype, batch_first=True):
    """torch.nn.LSTM (cuDNN) holding the kernel's weights: the library
    yardstick, timed here and never called by the port (``batch_first``
    False: time-major input, cuDNN's own layout)."""
    D, F, H = w_ih2.shape[0], w_ih2.shape[1], w_hh2.shape[1]
    lstm = torch.nn.LSTM(F, H, batch_first=batch_first, bidirectional=D == 2).to(w_ih2.device)
    with torch.no_grad():
        for d, sfx in zip(range(D), ("", "_reverse")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih2[d].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh2[d].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b2[d])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def serving_shapes(torch, g, dev):
    """The fused scans of a batch of 8 x 10 s (ragged utterances of 5-10 s,
    lengths drawn from ``g``): mode -> (R, T, lens)."""
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    B, L = 8, 10 * SAMPLE_RATE - 1            # 8 x 10 s, encoder frames
    S = (L + K) // hop + 1
    # chunk counts of ragged utterances (5-10 s), one per batch row, over K rows
    secs = torch.rand(B, generator=g) * 5 + 5
    utt_chunks = ((secs * SAMPLE_RATE).long() - 1 + K) // hop + 1
    return {
        "unmasked": (B * S, K, None),                                   # intra scan
        "masked": (B * K, S, utt_chunks.repeat_interleave(K).int().to(dev)),  # inter scan
    }


def phase_kernel(torch, dev):
    """Phase 2: the kernel against its plain version at the main path's shapes."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2
    from tss_dprnn_tpu_torch.ops.bilstm2 import (
        bilstm2_forward, bilstm2_forward_masked, bilstm2_reference)

    F = H = 128
    g = torch.Generator(device="cpu").manual_seed(SEED)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    shapes = serving_shapes(torch, g, dev)
    entries = []
    for mode, (R, T, lens) in shapes.items():
        x = torch.randn(R, T, F, generator=g).to(dev)
        rows_steps = R * T if lens is None else int(lens.sum())
        valid = None if lens is None else torch.arange(T, device=dev)[None, :] < lens[:, None]

        def run(xx, kernel=True):
            if not kernel:
                return bilstm2_reference(xx, w_ih2, b2, w_hh2, lens)
            if lens is None:
                return bilstm2_forward(xx, w_ih2, b2, w_hh2)
            return bilstm2_forward_masked(xx, lens, w_ih2, b2, w_hh2)

        if lens is None:
            def library(lstm, xx):
                return lstm(xx)[0]
        else:  # cuDNN's variable-length LSTM: direction 1 starts at x[len - 1]
            lens_cpu = lens.cpu()
            pack = torch.nn.utils.rnn.pack_padded_sequence

            def library(lstm, xx):
                return lstm(pack(xx, lens_cpu, batch_first=True, enforce_sorted=False))[0]

        def region(out):  # out0 is compared on t < len only
            o0, o1 = out
            o0 = o0.float() if valid is None else o0.float()[valid]
            return torch.cat([o0.flatten(), o1.float().flatten()])

        ref32 = region(run(x, kernel=False))
        out32 = run(x)
        got32 = region(out32)
        torch.cuda.synchronize()
        err32 = float((got32 - ref32).abs().max())
        bitwise = bool(torch.equal(region(run(x)), got32))  # no float atomics: a run repeats
        plan = B2._plan("serve", R, H, x.device)
        max_clusters = B2._max_clusters("serve", H, x.device.index, plan.height, torch.float32)
        p_bytes = R * T * 2 * 4 * H * 4  # the fp32 route's P buffer
        log(f"[kernel] {mode} fp32 route: input product ({SERVE_WITH}) + serving scan "
            f"({SERVE_SOURCE}), {plan.height}-row tiles, {plan.clusters} clusters of 2 CTAs, "
            f"{-(-plan.clusters // max_clusters)} waves of {max_clusters}; P buffer "
            f"{p_bytes} bytes ({p_bytes / 1e9:.2f} GB); second call bit for bit: {bitwise}")
        if not bitwise:
            raise AssertionError(f"bilstm2 {mode} fp32: a second call differs from the first")
        xb = x.bfloat16()
        out16 = run(xb)
        got16 = region(out16)
        bitwise16 = bool(torch.equal(region(run(xb)), got16))
        # direction 1 holds its zero state past each row's length: exactly 0 there
        held_zero = valid is None or all(bool((o[1][~valid] == 0).all()) for o in (out32, out16))
        del out32, out16
        snr16 = snr_db(got16, ref32)
        ref16 = region(run(xb, kernel=False))
        plain16_err = float((got16 - ref16).abs().max())
        plain16_snr = snr_db(got16, ref16)
        plan16 = B2._plan("serve", R, H, x.device, dtype=torch.bfloat16)
        clusters16 = {h: B2._max_clusters("serve", H, x.device.index, h, torch.bfloat16)
                      for h in B2.SERVE_HEIGHTS}
        waves16 = -(-plan16.clusters // clusters16[plan16.height])
        log(f"[kernel] {mode} bf16 route: input product + the serving scan's bf16 mode, "
            f"{plan16.height}-row tiles, {plan16.clusters} clusters, {waves16} waves (the card "
            f"runs {clusters16} clusters by tile height); second call bit for bit: {bitwise16}; "
            f"direction 1 exactly 0 past the lengths (both lanes): {held_zero}")
        if not (bitwise16 and held_zero):
            raise AssertionError(f"bilstm2 {mode}: bf16 second call bit for bit {bitwise16}, "
                                 f"direction 1 zero past the lengths {held_zero}")
        log(f"[kernel] {mode} R={R} T={T}: fp32 max|err|={err32:.3e}  bf16 SNR={snr16:.2f} dB "
            f"(bf16 kernel vs bf16 plain max|err|={plain16_err:.3e}, SNR {plain16_snr:.2f} dB)")
        if not err32 <= 1e-4:
            raise AssertionError(f"bilstm2 {mode} fp32 disagrees with its plain version: {err32}")
        if not snr16 >= 40.0:
            raise AssertionError(f"bilstm2 {mode} bf16 SNR {snr16:.2f} dB < 40 dB")
        if not (plain16_err <= BF16_ATOL and plain16_snr >= BF16_SNR_DB):
            raise AssertionError(f"bilstm2 {mode} bf16 disagrees with its bf16 plain version: "
                                 f"max|err| {plain16_err} (<= {BF16_ATOL}), "
                                 f"SNR {plain16_snr:.2f} dB (>= {BF16_SNR_DB})")

        # cuDNN's LSTM computes the same function: the yardstick
        lstms = {dt: cudnn_lstm(torch, w_ih2, b2, w_hh2, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        with torch.no_grad():
            out = library(lstms[torch.float32], x)
            if lens is not None:
                out = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True,
                                                             total_length=T)[0]
            library_err = float((region(out.split(H, dim=-1)) - ref32).abs().max())
        log(f"[kernel] {mode} cuDNN fp32 vs plain max|err|={library_err:.3e}")
        entry = {"name": "bilstm2_forward" if lens is None else "bilstm2_forward_masked",
                 "mode": mode, "dtype": "float32", "route": "cuda", "source": SERVE_SOURCE,
                 "with": SERVE_WITH, "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:698",
                 "shape": {"R": R, "T": T, "F": F, "H": H},
                 "tile_plan": dict(plan._asdict(), max_clusters=max_clusters,
                                   waves=-(-plan.clusters // max_clusters)),
                 "p_buffer_bytes": p_bytes, "bitwise_repeat": bitwise,
                 "max_abs_err": err32, "library_max_abs_err": library_err}
        for dt, key, peak, size in ((torch.float32, None, PEAK_FP32, 4),
                                    (torch.bfloat16, "bf16", PEAK_BF16, 2)):
            xx = x.to(dt)
            ms = time_ms(lambda: run(xx), 5)
            plain_ms = time_ms(lambda: run(xx, kernel=False), 2)
            with torch.no_grad():
                library_ms = time_ms(lambda: library(lstms[dt], xx), 3)
            bound_ms, bound_by = bound(rows_steps, R, T, F, H, size, peak)
            nums = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms}
            if key is None:
                entry.update(nums)
            else:
                entry[key] = dict(nums, source=SERVE_SOURCE, snr_db=snr16,
                                  plain_max_abs_err=plain16_err, plain_snr_db=plain16_snr,
                                  bitwise_repeat=bitwise16,
                                  tile_plan=dict(plan16._asdict(), max_clusters=clusters16,
                                                 waves=waves16))
            log(f"[kernel] {mode} {dt}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"cuDNN {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        entries.append(entry)
        del x, xb, lstms
        torch.cuda.empty_cache()
    return entries


def train_shapes():
    """Scan shapes of one training batch: 5 crops of 3 s (24,000 samples,
    23,999 encoder frames, S chunks), intra R = 5 S rows x T = K, inter
    R = 5 K rows x T = S."""
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    L = TRAIN_SECONDS * SAMPLE_RATE - 1
    S = (L + K) // hop + 1
    return {"intra": (TRAIN_BATCH * S, K), "inter": (TRAIN_BATCH * K, S)}


def bound_resid(rows_steps: int, R: int, T: int, F: int, H: int):
    """The residual forward's least time: the inference forward's FLOPs and
    bytes (fp32) plus its three H-wide fp32 streams per direction and the
    gate pre-activations (4H per direction) written."""
    flops = 2 * rows_steps * 2 * (F + H) * 4 * H
    nbytes = (rows_steps * F + 8 * R * T * H + 8 * R * T * H) * 4 + 2 * (F + H + 1) * 4 * H * 4
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_backward(rows_steps: int, R: int, T: int, F: int, H: int):
    """The backward's least time: 2 x 2 (F + H) 4H FLOP per row-step and
    direction over the row-steps the data needs (dh = dpre @ W_hh^T and
    dW_hh = h_prev^T dpre over the H-wide half, dx = dpre @ W_ih^T and
    dW_ih = x^T dpre over the F-wide half; the forward saved the gate
    pre-activations, so none is recomputed, as in cuDNN), or x, the six
    residual streams, both cotangents and the saved pre-activations (8H per
    row-step) read once, the weights read once, and dx, dW and db written
    once, over the HBM rate (fp32)."""
    flops = 2 * rows_steps * 2 * 2 * (F + H) * 4 * H
    nbytes = ((rows_steps * (F + 16 * H) + R * T * F) * 4
              + 2 * 2 * (F + H + 1) * 4 * H * 4)
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_products(torch, x, resid, w):
    """The training pair's four products (csrc/products.cu, 3xTF32 on the
    tensor cores) on their own at one scan shape, each against torch.matmul
    in fp32 (TF32 off: the plain version, and the library call) within
    DW_REL_TOL of max |ref|, with its error against a float64 product
    reported beside that of torch.matmul, bit for bit the same on a second
    call, timed beside torch.matmul in fp32 (the yardstick) and, for
    reference only, torch.matmul in TF32 (one pass, about 10 mantissa bits).
    The inputs are the forward's: x, h_prev of direction 0 and the saved
    pre-activations standing in for dpre."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    w_ih2, b2, w_hh2 = w
    R, T, F = x.shape
    H = w_hh2.shape[1]
    G, M = 4 * H, R * T
    lib = B2._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    pre, hp0 = resid[6], resid[0]
    x2, pre2, hp2 = x.reshape(M, F), pre.reshape(M, 2 * G), hp0.reshape(M, H)
    w_cat = w_ih2.transpose(0, 1).reshape(F, 2 * G).contiguous()
    w_ih_t = w_ih2.transpose(1, 2).reshape(2 * G, F).contiguous()
    bias = b2.reshape(-1)
    out_p = torch.empty(M, 2 * G, device=x.device)
    out_dx = torch.empty(M, F, device=x.device)

    def into(out, *args, **kw):
        B2._gemm(lib, stream, *args, out=out, **kw)
        return out

    # name: (kernel, plain, M, N, K, launches per training pair)
    cases = {
        "input": (lambda: into(out_p, False, [(x, 0, F, w_cat, 0, 2 * G, F)], M, 2 * G,
                               ldc=2 * G, bias=bias),
                  lambda: torch.addmm(bias, x2, w_cat), M, 2 * G, F, 1),
        "dx": (lambda: into(out_dx, False, [(pre, 0, 2 * G, w_ih_t, 0, F, 2 * G)], M, F, ldc=F),
               lambda: pre2 @ w_ih_t, M, F, 2 * G, 1),
        "dw_ih": (lambda: B2._gemm(lib, stream, True, [(x, 0, F, pre, 0, 2 * G, M)], F, 2 * G),
                  lambda: x2.T @ pre2, F, 2 * G, M, 1),
        "dw_hh": (lambda: B2._gemm(lib, stream, True, [(hp0, 0, H, pre, 0, 2 * G, M)], H, G),
                  lambda: hp2.T @ pre2[:, :G], H, G, M, 2),
    }
    # the same products of the same fp32 inputs in float64
    x64, pre64, hp64 = x2.double(), pre2.double(), hp2.double()
    exact = {"input": lambda: torch.addmm(bias.double(), x64, w_cat.double()),
             "dx": lambda: pre64 @ w_ih_t.double(),
             "dw_ih": lambda: x64.T @ pre64,
             "dw_hh": lambda: hp64.T @ pre64[:, :G]}
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the yardstick is torch.matmul in fp32: TF32 must be off")
    out = {}
    for name, (kernel, plain, m, n, k, per_pair) in cases.items():
        got = kernel().clone()
        again = kernel()
        want = plain()
        ref64 = exact[name]()
        torch.cuda.synchronize()
        scale = float(ref64.abs().max())
        rel = float((got - want).abs().max()) / float(want.abs().max())
        rel64 = float((got.double() - ref64).abs().max()) / scale
        library_rel64 = float((want.double() - ref64).abs().max()) / scale
        repeat = torch.equal(got, again)
        del got, again, want, ref64
        flops = 2 * m * n * k
        t_ops, t_bytes = flops / PEAK_FP32, (m * k + k * n + m * n) * 4 / PEAK_BYTES
        ms, plain_ms = time_ms(kernel, 5), time_ms(plain, 5)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_ms = time_ms(plain, 5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[name] = {"M": m, "N": n, "K": k, "launches_per_pair": per_pair, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": plain_ms, "tf32_matmul_ms": tf32_ms,
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "tflops": flops / ms / 1e9, "library_tflops": flops / plain_ms / 1e9,
                     "rel_err": rel, "rel_err_float64": rel64,
                     "library_rel_err_float64": library_rel64, "bitwise_repeat": repeat}
        log(f"[train-kernels] product {name} M={m} N={n} K={k}: {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; torch.matmul fp32 {plain_ms:.3f} ms, "
            f"{flops / plain_ms / 1e9:.1f} TFLOP/s; TF32 for reference {tf32_ms:.3f} ms; bound "
            f"{out[name]['bound_ms']:.3f}), max|err|/max|ref| {rel:.3e} vs torch.matmul, "
            f"{rel64:.3e} vs float64 (torch.matmul fp32 {library_rel64:.3e}), repeats bit for "
            f"bit: {repeat}")
        if not (rel <= DW_REL_TOL and repeat):
            raise AssertionError(f"product {name} disagrees with torch.matmul or does not "
                                 f"repeat: {rel}, {repeat}")
    del out_p, out_dx, x64, pre64, hp64
    return out


def phase_backward_kernels(torch, dev):
    """Phase 5: the residual forward and the backward against their plain
    versions at the training shapes (and masked at phase 2's inter shape),
    timed beside the plain versions and cuDNN's LSTM forward and backward."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    F = H = 128
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    w = (w_ih2, b2, w_hh2)
    # masked: the chunk counts of 8 ragged utterances of 5-10 s, over K rows each
    S10 = (10 * SAMPLE_RATE - 1 + K) // hop + 1
    secs = torch.rand(8, generator=g) * 5 + 5
    lens = ((((secs * SAMPLE_RATE).long() - 1 + K) // hop + 1).repeat_interleave(K)
            .int().to(dev))
    cases = [(name, R, T, None) for name, (R, T) in train_shapes().items()]
    cases.append(("masked", 8 * K, S10, lens))
    results = {}
    for name, R, T, ln in cases:
        x = torch.randn(R, T, F, generator=g).to(dev)
        g0, g1 = (torch.randn(R, T, H, generator=g).to(dev) for _ in range(2))
        valid = (torch.ones(R, T, dtype=torch.bool, device=dev) if ln is None
                 else torch.arange(T, device=dev)[None, :] < ln[:, None])
        if ln is not None:  # out0 past a row's length is unspecified: consumers mask it
            g0 = g0 * valid[..., None]
        rows_steps = R * T if ln is None else int(ln.sum())
        tiles = {which: B2._plan(which, R, H, x.device)._asdict() for which in ("resid", "bwd")}
        for which, plan in tiles.items():
            plan["max_clusters"] = B2._max_clusters(which, H, x.device.index, plan["height"],
                                                    torch.float32)

        def fwd(kernel=True, x=x, ln=ln):
            if not kernel:
                return B2.bilstm2_resid_reference(x, *w, ln)
            if ln is None:
                return B2.bilstm2_forward_resid(x, *w)
            return B2.bilstm2_forward_resid_masked(x, ln, *w)

        def bwd(resid, kernel=True, x=x, ln=ln, g0=g0, g1=g1):
            if not kernel:
                return B2.bilstm2_backward_reference(x, resid, g0, g1, *w, ln)
            if ln is None:
                return B2.bilstm2_backward(x, resid, g0, g1, *w)
            return B2.bilstm2_backward_masked(x, resid, g0, g1, *w, ln)

        # residual forward: outputs and the seven streams on the contract's region
        (o0, o1), resid = fwd()
        (a0, a1), again = fwd()
        torch.cuda.synchronize()
        fwd_repeat = all(torch.equal(a, b) for a, b in zip((o0, o1, *resid), (a0, a1, *again)))
        del a0, a1, again
        (p0, p1), presid = fwd(kernel=False)
        fwd_err = max(float((o1 - p1).abs().max()), float((o0 - p0)[valid].abs().max()),
                      *(float((a - b)[valid].abs().max()) for a, b in zip(resid, presid)))
        del o0, o1, presid
        # backward, both from the kernel's residual streams
        got = bwd(resid)
        again = bwd(resid)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = bwd(resid, kernel=False)
        dx_err = float((got[0] - want[0]).abs().max())
        dw_err = max(float((a - b).abs().max()) for a, b in zip(got[1:], want[1:]))
        dw_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                     for a, b in zip(got[1:], want[1:]))
        dw_snr = min(snr_db(a, b) for a, b in zip(got[1:], want[1:]))
        del got, want
        products = check_products(torch, x, resid, w) if ln is None else None
        log(f"[train-kernels] {name} R={R} T={T}: resid fwd max|err|={fwd_err:.3e} (repeats bit "
            f"for bit: {fwd_repeat}); backward dx max|err|={dx_err:.3e}, dW/db max|err|="
            f"{dw_err:.3e}, /max|ref|={dw_rel:.3e} (SNR >= {dw_snr:.1f} dB), repeats bit for "
            f"bit: {repeat}; tile plan {tiles}")
        if not (fwd_err <= 1e-4 and fwd_repeat):
            raise AssertionError(f"resid forward {name} disagrees with its plain version or does "
                                 f"not repeat: {fwd_err}, {fwd_repeat}")
        if not (dx_err <= 1e-4 and dw_rel <= DW_REL_TOL and repeat):
            raise AssertionError(f"backward {name} disagrees with its plain version or does not "
                                 f"repeat: dx {dx_err}, dW/db {dw_rel}, repeat {repeat}")

        # cuDNN's LSTM on the same weights, TF32 off, training mode: the yardstick
        lstm = cudnn_lstm(torch, w_ih2, b2, w_hh2, torch.float32)
        xr = x.detach().clone().requires_grad_()
        params = [xr, *lstm.parameters()]
        cot = torch.cat([g0, g1], dim=-1)
        pack = torch.nn.utils.rnn.pack_padded_sequence
        unpack = torch.nn.utils.rnn.pad_packed_sequence

        lens_cpu = None if ln is None else ln.cpu()

        def library_fwd():
            if ln is None:
                return lstm(xr)[0]
            packed = pack(xr, lens_cpu, batch_first=True, enforce_sorted=False)
            return unpack(lstm(packed)[0], batch_first=True, total_length=T)[0]

        out = library_fwd()
        lib_err = max(float((out.detach()[..., H:] - p1).abs().max()),
                      float((out.detach()[..., :H] - p0)[valid].abs().max()))
        del p0, p1

        def library_bwd():
            torch.autograd.grad(out, params, cot, retain_graph=True)

        def library_step():
            torch.autograd.grad(library_fwd(), params, cot)

        nums = {}
        nums["fwd_ms"] = time_ms(fwd, 5)
        nums["fwd_plain_ms"] = time_ms(lambda: fwd(kernel=False), 1)
        nums["bwd_ms"] = time_ms(lambda: bwd(resid), 5)
        nums["bwd_plain_ms"] = time_ms(lambda: bwd(resid, kernel=False), 1)
        nums["cudnn_fwd_ms"] = time_ms(library_fwd, 3)
        nums["cudnn_bwd_ms"] = time_ms(library_bwd, 3)
        nums["cudnn_fwd_bwd_ms"] = time_ms(library_step, 3)
        nums["fwd_bound_ms"], nums["fwd_bound_by"] = bound_resid(rows_steps, R, T, F, H)
        nums["bwd_bound_ms"], nums["bwd_bound_by"] = bound_backward(rows_steps, R, T, F, H)
        log(f"[train-kernels] {name}: resid fwd {nums['fwd_ms']:.3f} ms (plain "
            f"{nums['fwd_plain_ms']:.1f}, bound {nums['fwd_bound_ms']:.3f}); backward "
            f"{nums['bwd_ms']:.3f} ms (plain {nums['bwd_plain_ms']:.1f}, bound "
            f"{nums['bwd_bound_ms']:.3f}); cuDNN fwd {nums['cudnn_fwd_ms']:.3f}, bwd "
            f"{nums['cudnn_bwd_ms']:.3f}, fwd+bwd {nums['cudnn_fwd_bwd_ms']:.3f} ms "
            f"(cuDNN vs plain out1 max|err| {lib_err:.3e})")
        results[name] = dict(nums, R=R, T=T, rows_steps=rows_steps, resid_max_abs_err=fwd_err,
                             dx_max_abs_err=dx_err, dw_max_abs_err=dw_err, dw_rel_err=dw_rel,
                             dw_snr_db=dw_snr, fwd_bitwise_repeat=fwd_repeat,
                             bitwise_repeat=repeat, library_max_abs_err=lib_err,
                             tile_plan=tiles, products=products)
        del x, g0, g1, resid, lstm, xr, params, out, cot
        torch.cuda.empty_cache()
    return results


def train_kernel_entries(results, launches):
    """The kernels line's entries for the training kernels: the intra shape's
    numbers at the top level, the inter and masked shapes nested."""
    def numbers(r, which):
        key = "fwd" if which == "resid" else "bwd"
        return {"ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r[f"{key}_bound_ms"], "bound_by": r[f"{key}_bound_by"],
                "library_ms": r["cudnn_fwd_ms"] if key == "fwd" else r["cudnn_bwd_ms"],
                "cudnn_fwd_bwd_ms": r["cudnn_fwd_bwd_ms"],
                "max_abs_err": (r["resid_max_abs_err"] if key == "fwd" else
                                max(r["dx_max_abs_err"], r["dw_max_abs_err"])),
                "shape": {"R": r["R"], "T": r["T"], "F": 128, "H": 128}}

    entries = []
    for which, name, source, replaces in (
            ("resid", "bilstm2_forward_resid", "tss_dprnn_tpu_torch/csrc/bilstm2_resid.cu",
             "tss_dprnn_tpu/ops/pallas_lstm.py:698"),
            ("backward", "bilstm2_backward", "tss_dprnn_tpu_torch/csrc/bilstm2_bwd.cu",
             "tss_dprnn_tpu/ops/pallas_lstm.py:1224")):
        e = {"name": name, "mode": f"{which}, intra", "dtype": "float32", "route": "cuda",
             "source": source, "replaces": replaces,
             "with": "tss_dprnn_tpu_torch/csrc/products.cu",
             "cluster": "2 CTAs, W_hh resident in shared memory",
             "tile_plan": {s: results[s]["tile_plan"] for s in ("intra", "inter", "masked")},
             "launches": launches[name],
             **numbers(results["intra"], which),
             "inter": numbers(results["inter"], which),
             "masked": dict(numbers(results["masked"], which), name=f"{name}_masked",
                            launches=0)}
        if which == "backward":
            for shape in ("intra", "inter", "masked"):
                sub = e if shape == "intra" else e[shape]
                sub["dw_rel_err"] = results[shape]["dw_rel_err"]
                sub["dx_max_abs_err"] = results[shape]["dx_max_abs_err"]
            e["bitwise_repeat"] = all(results[s]["bitwise_repeat"] for s in results)
        else:
            e["bitwise_repeat"] = all(results[s]["fwd_bitwise_repeat"] for s in results)
        entries.append(e)

    def product_numbers(shape):
        prods = results[shape]["products"]
        total = {k: sum(p[k] * p["launches_per_pair"] for p in prods.values())
                 for k in ("ms", "plain_ms", "library_ms", "tf32_matmul_ms", "bound_ms")}
        return dict(total, bound_by="operations" if all(
            p["bound_by"] == "operations" for p in prods.values()) else "bytes",
                    max_abs_err=None, max_rel_err=max(p["rel_err"] for p in prods.values()),
                    max_rel_err_float64=max(p["rel_err_float64"] for p in prods.values()),
                    products=prods)

    intra = product_numbers("intra")
    intra["max_abs_err"] = intra.pop("max_rel_err")  # relative to max |ref|, as DW_REL_TOL
    entries.append({
        "name": "products_gemm", "mode": "the training pair's 5 products per scan, intra "
        "(input 1, dx 1, dW_ih 1, dW_hh 2; ms summed), 3xTF32 on the tensor cores",
        "dtype": "float32", "route": "cuda",
        "source": "tss_dprnn_tpu_torch/csrc/products.cu",
        "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:1224",
        "launches": launches["products_gemm"], **intra,
        "max_abs_err_is": "max |err| / max |ref| (torch.matmul on the same inputs)",
        "inter": product_numbers("inter"),
        "bitwise_repeat": all(p["bitwise_repeat"] for s in ("intra", "inter")
                              for p in results[s]["products"].values())})
    return entries


def bound_stack(kind: str, D: int, R: int, T: int, F: int, H: int, itemsize: int = 4,
                peak: float = PEAK_FP32):
    """Least time of a stacked-direction scan (``kind``: "forward",
    "with_cs", "resid" or "backward"): 2 (F + H) 4H FLOP per row-step and
    direction forward and twice that backward (the forward saved the gate
    pre-activations, so none is recomputed) over the named peak, or the bytes
    over the HBM rate: each direction's x read and h written once, the extra
    fp32 streams written (c for with_cs; h_prev, c_prev, tanh(c) and the 4H
    pre-activations for resid), the weights read; backward x, the three
    H-wide streams, the pre-activations and the cotangent read, dx, dW and db
    written."""
    steps = D * R * T
    weights = D * (F + H + 1) * 4 * H * 4
    if kind == "backward":
        flops = 2 * steps * 2 * (F + H) * 4 * H
        nbytes = steps * (2 * F + 8 * H) * 4 + 2 * weights
    else:
        flops = steps * 2 * (F + H) * 4 * H
        extra = {"forward": 0, "with_cs": 1, "resid": 7}[kind]
        nbytes = steps * ((F + H) * itemsize + extra * H * 4) + weights
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def scan_plan(which: str, D: int, R: int, H: int, device, dtype):
    """A stacked scan's tile plan on the card (ops/bilstm2._plan: ``which``
    "serve" for the h-only and cell-state modes, "resid" or "serve_resid"
    for the training forward), with the card's clusters at its height and
    the waves its D directions' clusters take."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    plan = B2._plan(which, R, H, device, dirs=D, dtype=dtype)._asdict()
    plan["max_clusters"] = B2._max_clusters(which, H, device.index, plan["height"], dtype)
    plan["waves"] = -(-plan["tiles"] * D // plan["max_clusters"])
    return plan


def bss_shapes():
    """The unidirectional inter-chunk scan's (D, R, T) in BSS serving (8 x
    10 s) and training (5 x 3 s); a small two-direction case, R not a
    multiple of 8, T not a multiple of 5; and a wide one (the intra-chunk
    shape of 8 x 10 s as two stacked directions), whose clusters outnumber the
    card's SMs several times."""
    K, hop = BSS["chunk_length"], BSS["hop_length"]
    S10 = (10 * SAMPLE_RATE - 1 + K) // hop + 1
    return {"serving": (1, 8 * K, S10), "training": (1,) + train_shapes()["inter"],
            "small_d2": (2, 203, 33), "wide_d2": (2, 8 * S10, K)}


def phase_lstm_kernels(torch, dev):
    """Phase 7: the stacked-direction kernels against their plain versions,
    timed beside them and a unidirectional cuDNN LSTM."""
    from tss_dprnn_tpu_torch.ops import lstm as L

    F = H = 128
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    k = H ** -0.5
    results = {}
    for name, (D, R, T) in bss_shapes().items():
        w_ih, w_hh, b = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                         for s in ((D, F, 4 * H), (D, H, 4 * H), (D, 4 * H)))
        w = (w_ih, b, w_hh)
        x = torch.randn(D, R, T, F, generator=g).to(dev)
        cot = torch.randn(D, R, T, H, generator=g).to(dev)
        xb = x.bfloat16()
        # the routes' cluster scans: one 2-CTA cluster per direction and row
        # tile (the cell-state mode's plan is the h-only serving scan's)
        plans = {key: scan_plan(which, D, R, H, x.device, dt)
                 for key, which, dt in (("serve", "serve", torch.float32),
                                        ("with_cs", "serve", torch.float32),
                                        ("resid", "resid", torch.float32),
                                        ("serve_bf16", "serve", torch.bfloat16))}

        # the three forward modes and the bf16 streams; the fp32 routes twice
        ref = L.lstm_reference(x, *w)
        got_h = L.lstm_forward(x, *w)
        err = {"forward": float((got_h - ref).abs().max())}
        repeat_fwd = bool(torch.equal(got_h, L.lstm_forward(x, *w)))
        # want_cs: the h-only route's product and arithmetic, so its h is
        # lstm_forward's bit for bit
        cs_h, got_cs = L.lstm_forward_with_cs(x, *w)
        again_h, again_cs = L.lstm_forward_with_cs(x, *w)
        torch.cuda.synchronize()
        repeat_cs = bool(torch.equal(cs_h, again_h) and torch.equal(got_cs, again_cs))
        cs_is_forward = bool(torch.equal(cs_h, got_h))
        del again_h, again_cs
        ref_cs = L.lstm_cs_reference(x, *w)[1]
        err["with_cs"] = max(float((cs_h - ref).abs().max()),
                             float((got_cs - ref_cs).abs().max()))
        del cs_h, got_cs, ref_cs
        got_h, resid = L.lstm_forward_resid(x, *w)
        ref_resid = L.lstm_resid_reference(x, *w)[1]
        err["resid"] = max(float((got_h - ref).abs().max()),
                           *(float((a - r).abs().max()) for a, r in zip(resid, ref_resid)))
        err["pre"] = float((resid[3] - ref_resid[3]).abs().max())  # the saved gates
        del ref_resid
        again_h, again = L.lstm_forward_resid(x, *w)
        torch.cuda.synchronize()
        repeat_resid = all(torch.equal(a, r) for a, r in zip((got_h, *resid), (again_h, *again)))
        del got_h, again_h, again
        got16 = L.lstm_forward(xb, *w)
        repeat_bf16 = bool(torch.equal(got16, L.lstm_forward(xb, *w)))
        got16 = got16.float()
        ref16 = L.lstm_reference(xb, *w).float()
        snr16, plain16_snr = snr_db(got16, ref), snr_db(got16, ref16)
        plain16_err = float((got16 - ref16).abs().max())
        del got16, ref16
        # the backward from the kernel's residual streams, twice
        got = L.lstm_backward(x, resid, cot, *w)
        again = L.lstm_backward(x, resid, cot, *w)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, r) for a, r in zip(got, again))
        del again
        want = L.lstm_backward_reference(x, resid, cot, *w)
        dx_err = float((got[0] - want[0]).abs().max())
        dw_err = max(float((a - r).abs().max()) for a, r in zip(got[1:], want[1:]))
        dw_rels = {n: float((a - r).abs().max()) / float(r.abs().max())
                   for n, a, r in zip(("dw_ih", "db", "dw_hh"), got[1:], want[1:])}
        dw_rel = max(dw_rels.values())
        del got, want
        backward_plan = L.plan_backward(D, R, H, x.device)._asdict()
        log(f"[lstm-kernels] {name} D={D} R={R} T={T}: fp32 forward = {D} input product(s) + "
            f"serving scan, tile plan {plans['serve']}; resid = {D} input product(s) + training "
            f"scan, tile plan {plans['resid']}; bf16 forward = the same with the serving "
            f"scan's bf16 mode, tile plan {plans['serve_bf16']}; with_cs = {D} input "
            f"product(s) + the serving scan's cell-state mode, tile plan {plans['with_cs']}; "
            f"backward tile plan {backward_plan}")
        log(f"[lstm-kernels] {name}: max|err| forward {err['forward']:.3e} (repeats bit for bit: "
            f"{repeat_fwd}), with_cs {err['with_cs']:.3e} (repeats bit for bit: {repeat_cs}; h "
            f"bit for bit lstm_forward's: {cs_is_forward}), resid {err['resid']:.3e} (pre "
            f"{err['pre']:.3e}; repeats bit for bit: {repeat_resid}); bf16 SNR "
            f"{snr16:.2f} dB (vs bf16 plain max|err| {plain16_err:.3e}, SNR {plain16_snr:.2f} "
            f"dB; repeats bit for bit: {repeat_bf16}); backward from the resid route's streams "
            f"dx {dx_err:.3e}, dW/db {dw_err:.3e}, /max|ref| {dw_rels}, repeats bit for bit: "
            f"{repeat}")
        if not max(err.values()) <= 1e-4:
            raise AssertionError(f"lstm {name} fp32 disagrees with its plain version: {err}")
        if not (repeat_fwd and repeat_cs and repeat_resid and repeat_bf16):
            raise AssertionError(f"lstm {name}: a second call differs from the first (fp32 "
                                 f"forward {repeat_fwd}, with_cs {repeat_cs}, resid "
                                 f"{repeat_resid}, bf16 forward {repeat_bf16})")
        if not cs_is_forward:
            raise AssertionError(f"lstm {name}: want_cs's h is not lstm_forward's bit for bit")
        if not (snr16 >= 40.0 and plain16_err <= BF16_ATOL and plain16_snr >= BF16_SNR_DB):
            raise AssertionError(f"lstm {name} bf16: SNR {snr16:.2f} dB vs fp32 (>= 40), "
                                 f"max|err| {plain16_err} (<= {BF16_ATOL}) and SNR "
                                 f"{plain16_snr:.2f} dB (>= {BF16_SNR_DB}) vs bf16 plain")
        if not (dx_err <= 1e-4 and dw_rel <= DW_REL_TOL and repeat):
            raise AssertionError(f"lstm backward {name} disagrees with its plain version or does "
                                 f"not repeat: dx {dx_err}, dW/db {dw_rel}, repeat {repeat}")

        # cuDNN's LSTM on the same weights, TF32 off: inference forward,
        # training forward, backward by autograd.grad
        lstms = {dt: cudnn_lstm(torch, w_ih, b, w_hh, dt) for dt in (torch.float32, torch.bfloat16)}
        lstm = lstms[torch.float32]

        nums = {"D": D, "R": R, "T": T, "tile_plan": plans,
                "backward_tile_plan": backward_plan,
                "max_abs_err": err, "bf16_snr_db": snr16, "bf16_plain_max_abs_err": plain16_err,
                "bf16_plain_snr_db": plain16_snr, "dx_max_abs_err": dx_err,
                "dw_max_abs_err": dw_err, "dw_rel_err": dw_rel, "bitwise_repeat": repeat,
                "forward_bitwise_repeat": repeat_fwd, "resid_bitwise_repeat": repeat_resid,
                "bf16_bitwise_repeat": repeat_bf16, "with_cs_bitwise_repeat": repeat_cs,
                "with_cs_h_is_forward": cs_is_forward}
        if D == 1:
            xr = x[0].detach().clone().requires_grad_()
            params = [xr, *lstm.parameters()]
            with torch.no_grad():
                lib_err = float((lstm(x[0])[0] - ref[0]).abs().max())
                nums["cudnn_ms"] = time_ms(lambda: lstm(x[0]), 3)
                nums["cudnn_bf16_ms"] = time_ms(lambda: lstms[torch.bfloat16](xb[0]), 3)
            out = lstm(xr)[0]
            nums["cudnn_train_fwd_ms"] = time_ms(lambda: lstm(xr), 3)
            nums["cudnn_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(out, params, cot[0], retain_graph=True), 3)
            nums["cudnn_fwd_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(lstm(xr)[0], params, cot[0]), 3)
            nums["library_max_abs_err"] = lib_err
            del out, xr, params
        del lstms, lstm, ref
        for kind, fn, plain in (
                ("forward", lambda: L.lstm_forward(x, *w), lambda: L.lstm_reference(x, *w)),
                ("bf16", lambda: L.lstm_forward(xb, *w), lambda: L.lstm_reference(xb, *w)),
                ("with_cs", lambda: L.lstm_forward_with_cs(x, *w),
                 lambda: L.lstm_cs_reference(x, *w)),
                ("resid", lambda: L.lstm_forward_resid(x, *w),
                 lambda: L.lstm_resid_reference(x, *w)),
                ("backward", lambda: L.lstm_backward(x, resid, cot, *w),
                 lambda: L.lstm_backward_reference(x, resid, cot, *w))):
            nums[f"{kind}_ms"] = time_ms(fn, 5)
            nums[f"{kind}_plain_ms"] = time_ms(plain, 1)
            if kind == "bf16":
                nums["bf16_bound_ms"], nums["bf16_bound_by"] = bound_stack(
                    "forward", D, R, T, F, H, 2, PEAK_BF16)
            else:
                nums[f"{kind}_bound_ms"], nums[f"{kind}_bound_by"] = bound_stack(kind, D, R, T, F, H)
        log(f"[lstm-kernels] {name}: forward {nums['forward_ms']:.3f} ms (plain "
            f"{nums['forward_plain_ms']:.1f}, bound {nums['forward_bound_ms']:.3f}; bf16 "
            f"{nums['bf16_ms']:.3f}), with_cs {nums['with_cs_ms']:.3f}, resid "
            f"{nums['resid_ms']:.3f} (plain {nums['resid_plain_ms']:.1f}, bound "
            f"{nums['resid_bound_ms']:.3f}), backward {nums['backward_ms']:.3f} (plain "
            f"{nums['backward_plain_ms']:.1f}, bound {nums['backward_bound_ms']:.3f})")
        if D == 1:
            log(f"[lstm-kernels] {name}: cuDNN forward {nums['cudnn_ms']:.3f} ms (bf16 "
                f"{nums['cudnn_bf16_ms']:.3f}), training forward {nums['cudnn_train_fwd_ms']:.3f}, "
                f"backward {nums['cudnn_bwd_ms']:.3f}, fwd+bwd {nums['cudnn_fwd_bwd_ms']:.3f} "
                f"(cuDNN vs plain max|err| {nums['library_max_abs_err']:.3e})")
        results[name] = nums
        del x, xb, cot, resid
        torch.cuda.empty_cache()
    return results


def lstm_kernel_entries(results, launches):
    """The kernels line's entries for the stacked-direction kernels: each
    at the shape its main path gives it (lstm_forward: BSS serving; the
    training kernels: BSS training), the other shapes and modes nested."""
    def numbers(r, kind, library):
        out = {"ms": r[f"{kind}_ms"], "plain_ms": r[f"{kind}_plain_ms"],
               "bound_ms": r[f"{kind}_bound_ms"], "bound_by": r[f"{kind}_bound_by"],
               "library_ms": r.get(library),
               "shape": {"D": r["D"], "R": r["R"], "T": r["T"], "F": 128, "H": 128}}
        if kind != "backward":  # the forward cluster scans
            out["tile_plan"] = r["tile_plan"][{"forward": "serve", "resid": "resid",
                                               "bf16": "serve_bf16"}.get(kind, kind)]
            out["bitwise_repeat"] = r[f"{kind}_bitwise_repeat"]
        if kind == "with_cs":
            out.update(source="tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu (mode 4)",
                       h_is_lstm_forward=r["with_cs_h_is_forward"])
        if kind == "backward":
            out.update(max_abs_err=max(r["dx_max_abs_err"], r["dw_max_abs_err"]),
                       dx_max_abs_err=r["dx_max_abs_err"], dw_rel_err=r["dw_rel_err"],
                       cudnn_fwd_bwd_ms=r.get("cudnn_fwd_bwd_ms"))
        elif kind == "bf16":
            out.update(snr_db=r["bf16_snr_db"], plain_max_abs_err=r["bf16_plain_max_abs_err"],
                       plain_snr_db=r["bf16_plain_snr_db"])
        else:
            out["max_abs_err"] = r["max_abs_err"][kind]
        return out

    serving, training, small, wide = (results[k] for k in ("serving", "training", "small_d2",
                                                           "wide_d2"))
    base = {"dtype": "float32", "route": "cuda"}
    products = {"with": "tss_dprnn_tpu_torch/csrc/products.cu (the input product, one launch "
                        "per direction)",
                "cluster": "2 CTAs, W_hh resident in shared memory",
                "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:57"}
    return [
        dict(base, name="lstm_forward", mode="h only, BSS serving inter scan",
             source="tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu", **products,
             launches=launches["lstm_forward"], **numbers(serving, "forward", "cudnn_ms"),
             bf16=numbers(serving, "bf16", "cudnn_bf16_ms"),
             with_cs=dict(numbers(serving, "with_cs", "cudnn_train_fwd_ms"),
                          name="lstm_forward_with_cs", launches=0),
             training_shape=numbers(training, "forward", "cudnn_ms"),
             small_d2=numbers(small, "forward", None), wide_d2=numbers(wide, "forward", None)),
        dict(base, name="lstm_forward_resid", mode="resid, BSS training inter scan",
             source="tss_dprnn_tpu_torch/csrc/bilstm2_resid.cu", **products,
             launches=launches["lstm_forward_resid"],
             **numbers(training, "resid", "cudnn_train_fwd_ms"),
             serving_shape=numbers(serving, "resid", "cudnn_train_fwd_ms"),
             small_d2=numbers(small, "resid", None), wide_d2=numbers(wide, "resid", None)),
        dict(base, name="lstm_backward", mode="BSS training inter scan",
             source="tss_dprnn_tpu_torch/csrc/lstm_bwd.cu",
             replaces="tss_dprnn_tpu/ops/pallas_lstm.py:498",
             **{"with": "tss_dprnn_tpu_torch/csrc/cluster_scan.cuh and products.cu"},
             cluster="2 CTAs, W_hh^T resident in shared memory; the saved gates read",
             tile_plan={k: results[k]["backward_tile_plan"] for k in results},
             launches=launches["lstm_backward"], **numbers(training, "backward", "cudnn_bwd_ms"),
             serving_shape=numbers(serving, "backward", "cudnn_bwd_ms"),
             small_d2=numbers(small, "backward", None), wide_d2=numbers(wide, "backward", None),
             bitwise_repeat=all(r["bitwise_repeat"] for r in results.values())),
    ]


class Requests:
    """In-memory requests: ds[i] -> (mix, target, reference, spk_idx)."""

    def __init__(self, seed: int, n: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        secs = list(rng.uniform(2, 6, n - 1)) + [10.0]
        self.items = []
        for s in secs:
            target = 0.1 * rng.standard_normal(int(s * SAMPLE_RATE)).astype(np.float32)
            mix = target + 0.1 * rng.standard_normal(target.shape).astype(np.float32)
            ref = 0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE)).astype(np.float32)
            self.items.append((mix, target, ref, int(rng.integers(0, 251))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


def phase_main_path(torch, dev, ckpt):
    """Phase 3: InferencerSpe.run at full flagship width over 12 requests."""
    from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.ops import bilstm2

    ds = Requests(SEED, 12)
    batch_size, n_buckets = 4, 2
    n_batches = len(BucketedEvalLoader(ds, batch_size, make_collate_spe_eval(), ds.lengths(),
                                       n_buckets=n_buckets))
    savedir = os.path.join(OUT_DIR, "metrics")
    config = {"checkpoint_path": ckpt, "test_savedir": savedir, "metrics": ["si_sdr"],
              "data": {"sample_rate": SAMPLE_RATE}}
    inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), config, device=dev)
    bilstm2.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"unmasked": bilstm2.bilstm2_forward.launches,
                "masked": bilstm2.bilstm2_forward_masked.launches}
    products = bilstm2.product_launch_counts()
    audio_s = sum(ds.lengths()) / SAMPLE_RATE
    log(f"[main] {len(ds)} requests, {n_batches} batches, {audio_s:.2f} audio-s in {wall:.3f} s "
        f"= {audio_s / wall:.2f} audio-s/s (first run, includes warm-up); launches {launches}, "
        f"products {products}; final {final}")
    n = FLAGSHIP["n_repeats"]  # an intra and an inter scan per block
    if launches != {"unmasked": n * n_batches, "masked": n * n_batches}:
        raise AssertionError(f"expected {2 * n} launches per batch over {n_batches} batches: "
                             f"{launches}")
    # each fp32 serving scan runs its input product first
    expect_launches(products, {"products_gemm": 2 * n}, n_batches, "main path's products")
    launches["products_gemm"] = products["products_gemm"]
    with open(os.path.join(savedir, "all_metrics.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    si = [float(r.split(",")[1]) for r in rows]
    if len(si) != len(ds) or not all(math.isfinite(v) for v in si):
        raise AssertionError(f"non-finite or missing si_sdr rows: {si}")
    if not os.path.exists(os.path.join(savedir, "final_metrics.json")):
        raise AssertionError("final_metrics.json was not written")
    return inf, launches, audio_s / wall


def phase_card_vs_cpu(torch, inf_gpu, ckpt):
    """Phase 4: card vs CPU on one 2 s request; bucketed vs alone on the card."""
    import numpy as np

    from tss_dprnn_tpu_torch.data.loader import make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    rng = np.random.default_rng(SEED + 1)
    n, n_long = 2 * SAMPLE_RATE, 3 * SAMPLE_RATE
    items = [(0.1 * rng.standard_normal(m).astype(np.float32),) * 2
             + (0.1 * rng.standard_normal(r).astype(np.float32), 0)
             for m, r in ((n, 3 * SAMPLE_RATE), (n_long, 2 * SAMPLE_RATE + 777))]
    collate = make_collate_spe_eval()

    def batch_of(its, T):
        b = collate(its, T)
        b["lengths"] = np.array([len(it[0]) for it in its], np.int32)
        return b

    inf_cpu = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), {"checkpoint_path": ckpt,
                                                         "metrics": ["si_sdr"]}, device="cpu")

    def alone(inf):  # the request at its exact shape, no lengths
        mix, _, ref, _ = items[0]
        ref_len = torch.tensor([float(len(ref))], device=inf.device)
        return inf.model(torch.from_numpy(mix).to(inf.device)[None],
                         torch.from_numpy(ref).to(inf.device)[None], ref_len)[0].cpu()

    with torch.inference_mode():
        est_gpu = alone(inf_gpu)
        est_cpu = alone(inf_cpu)
        bucketed = inf_gpu.forward(batch_of(items, n_long)).cpu()
    s_cpu = snr_db(est_gpu[0], est_cpu[0])
    s_bucket = snr_db(bucketed[0, :n], est_gpu[0])
    err_bucket = float((bucketed[0, :n] - est_gpu[0]).abs().max())
    log(f"[check] card vs CPU: {s_cpu:.2f} dB SNR; bucketed vs alone: {s_bucket:.2f} dB SNR, "
        f"max|err|={err_bucket:.3e}")
    if not s_cpu >= 50.0:
        raise AssertionError(f"card vs CPU SNR {s_cpu:.2f} dB < 50 dB")
    if not torch.allclose(bucketed[0, :n], est_gpu[0], atol=2e-4, rtol=1e-4):
        raise AssertionError(f"bucketed row differs from the request alone: {err_bucket}")


class Crops:
    """In-memory training items from a seed: ds[i] -> (mix, target,
    reference, spk_idx), fixed crops of ``seconds`` and references of 2-5 s."""

    def __init__(self, seed: int, n: int, seconds: float = TRAIN_SECONDS):
        import numpy as np

        rng = np.random.default_rng(seed)
        n_s = int(seconds * SAMPLE_RATE)
        self.items = []
        for _ in range(n):
            target = 0.1 * rng.standard_normal(n_s).astype(np.float32)
            mix = target + 0.1 * rng.standard_normal(n_s).astype(np.float32)
            ref = 0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE))
            self.items.append((mix, target, ref.astype(np.float32), int(rng.integers(0, 251))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


class Mixtures:
    """In-memory two-speaker mixtures from a seed: ds[i] -> (mix [T], sources
    [2, T]). With ``seconds`` fixed crops of that length; without, requests of
    2-6 s and one of 10 s."""

    def __init__(self, seed: int, n: int, seconds: float = None):
        import numpy as np

        rng = np.random.default_rng(seed)
        secs = [seconds] * n if seconds else list(rng.uniform(2, 6, n - 1)) + [10.0]
        self.items = []
        for sec in secs:
            sources = 0.1 * rng.standard_normal((2, int(sec * SAMPLE_RATE))).astype(np.float32)
            self.items.append((sources.sum(0), sources))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


# the reference's training config (configs/train_tss.yaml), with a fresh
# checkpoint directory; lstm_backend is accepted and ignored by the port
TRAIN_CONFIG = {"optimizer": {"lr": 5e-4, "weight_decay": 1e-5}, "clip_norm": 5,
                "ce_gamma": 0.5, "print_freq": 5, "n_checkpoints": 1000,
                "lr_scheduler": {"patience": 2, "factor": 0.5}, "lstm_backend": "pallas",
                "save_optimizer": True}
# ... and the BSS one (configs/train_bss.yaml)
BSS_TRAIN_CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-5}, "clip_norm": 5,
                    "print_freq": 5, "n_checkpoints": 1000,
                    "lr_scheduler": {"patience": 2, "factor": 0.5}, "lstm_backend": "pallas",
                    "save_optimizer": True}


def training_family(name: str):
    """What phase_training drives for a model family: the model, its trainer,
    inferencer, collate and dataset, and the kernel launches a step makes."""
    from tss_dprnn_tpu_torch import inference, training
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet

    n = FLAGSHIP["n_repeats"]  # an intra and an inter scan per block
    if name == "tss":
        return dict(tag="train", model=lambda: DPRNNSpeTasNet(**FLAGSHIP), seed=SEED + 6,
                    trainer=training.TrainerSpe, inferencer=inference.InferencerSpe,
                    collate=loader.collate_spe, crops=Crops, config=TRAIN_CONFIG,
                    per_train_step={"bilstm2_forward_resid": 2 * n, "bilstm2_backward": 2 * n},
                    per_eval_step={"bilstm2_forward": 2 * n},
                    # 1 input product per residual forward, dx + dW_ih + 2 dW_hh per backward
                    products_per_train_step={"products_gemm": 2 * n * 5,
                                             "products_colsum": 2 * n})
    n = BSS["n_repeats"]  # a fused bidirectional intra and a one-direction inter scan per block
    return dict(tag="bss-train", model=lambda: DPRNNTasNet(**BSS), seed=SEED + 26,
                trainer=training.Trainer, inferencer=inference.Inferencer,
                collate=loader.collate_bss, crops=Mixtures, config=BSS_TRAIN_CONFIG,
                per_train_step={"bilstm2_forward_resid": n, "bilstm2_backward": n,
                                "lstm_forward_resid": n, "lstm_backward": n},
                per_eval_step={"bilstm2_forward": n, "lstm_forward": n},
                # the fused pair's 5, lstm_forward_resid's input product and
                # lstm_backward's dx + dW_ih + dW_hh at D = 1
                products_per_train_step={"products_gemm": n * 5 + n * 1 + n * 3,
                                         "products_colsum": 2 * n})


def phase_training(torch, dev, fam):
    """Phases 6 and 9: the family's ``Trainer.run`` at full width and depth,
    then the best checkpoint served, 10 steps on one batch, and one step card
    vs CPU."""
    import shutil

    from tss_dprnn_tpu_torch.data.loader import TrainLoader
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    tag, seed, collate = fam["tag"], fam["seed"], fam["collate"]
    ckpt_dir = os.path.join(OUT_DIR, f"{tag}_ckpt")
    unused_dir = os.path.join(OUT_DIR, f"{tag}_ckpt_unused")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    start = init_weights_(fam["model"](), torch.Generator().manual_seed(seed)).state_dict()

    def trainer(device, directory):
        model = fam["model"]()
        model.load_state_dict(start, strict=True)
        return fam["trainer"](model, dict(fam["config"], new_checkpoints_path=directory),
                              device=device)

    # -- the main path: 2 epochs of 4 train steps and 2 eval steps
    tr = trainer(dev, ckpt_dir)
    train_loader = TrainLoader(fam["crops"](seed, 20, TRAIN_SECONDS), TRAIN_BATCH, collate,
                               seed=SEED, prefetch=2)
    eval_loader = TrainLoader(fam["crops"](seed + 1, 10, TRAIN_SECONDS), TRAIN_BATCH, collate,
                              shuffle=False, prefetch=0)
    epoch_losses = []
    for mode in ("train", "eval"):
        def recorded(loader, fn=getattr(tr, mode), mode=mode):
            loss = fn(loader)
            epoch_losses.append((mode, loss))
            return loss
        setattr(tr, mode, recorded)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(train_loader, eval_loader, n_epochs=2, early_stop=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    products = product_launches()
    n_train, n_eval = 2 * len(train_loader), 2 * len(eval_loader)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] {fam['trainer'].__name__}.run: {n_train} train + {n_eval} eval steps of "
        f"{TRAIN_BATCH} x {TRAIN_SECONDS} s in {wall:.2f} s (first run, includes warm-up); epoch "
        f"losses {epoch_losses}; launches {launches}; peak memory {peak_gb:.2f} GB")
    per_run = {k: n_train * fam["per_train_step"].get(k, 0) + n_eval * fam["per_eval_step"].get(k, 0)
               for k in launches}
    expect_launches(launches, per_run, 1, f"{tag} run of {n_train} train and {n_eval} eval steps "
                    f"({fam['per_train_step']} per train step, {fam['per_eval_step']} per eval "
                    "step)")
    per_run = {k: n_train * fam["products_per_train_step"].get(k, 0)
               + n_eval * with_products(fam["per_eval_step"]).get(k, 0) for k in products}
    expect_launches(products, per_run, 1, f"{tag} run's products ({n_train} train and "
                    f"{n_eval} eval steps)")
    launches.update(products)
    if len(epoch_losses) != 4 or not all(math.isfinite(v) for _, v in epoch_losses):
        raise AssertionError(f"non-finite or missing epoch losses: {epoch_losses}")
    files = sorted(os.listdir(ckpt_dir))
    best = [f for f in files if f.endswith("_best")]
    if "2_last" not in files or not best:
        raise AssertionError(f"expected 2_last and a *_best checkpoint, found {files}")

    # -- the best checkpoint serves a request
    config = {"checkpoint_path": os.path.join(ckpt_dir, best[-1]), "metrics": ["si_sdr"],
              "test_savedir": os.path.join(OUT_DIR, f"{tag}_metrics")}
    inf = fam["inferencer"](fam["model"](), config, device=dev)
    served = inf.run(fam["crops"](seed + 3, 1, 4), batch_size=1, n_buckets=1)
    log(f"[{tag}] {best[-1]} served through {fam['inferencer'].__name__}: {served}")
    if not all(math.isfinite(v) for v in served.values()):
        raise AssertionError(f"the trained checkpoint served non-finite metrics: {served}")
    del inf

    # -- 10 steps on one repeated batch; steps 3-10 are the steady state
    batch = collate(fam["crops"](seed + 4, TRAIN_BATCH, TRAIN_SECONDS).items)
    losses = []
    reset_launches()
    for step in range(10):
        if step == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.train_step(batch)[0])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / 8 * 1e3
    losses = [float(v) for v in losses]
    repeated = dict(all_launches(), **product_launches())
    log(f"[{tag}] 10 steps on one batch: losses {[round(v, 4) for v in losses]}; steady state "
        f"{ms_step:.2f} ms/step at {TRAIN_BATCH} x {TRAIN_SECONDS} s")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"10 steps on one batch did not lower the loss: {losses}")
    expect_launches(repeated, dict(fam["per_train_step"], **fam["products_per_train_step"]), 10,
                    f"{tag} 10 train steps")
    del tr

    # -- one step from the same weights, card vs CPU, at full width on 1 x 1 s
    one = collate(fam["crops"](seed + 5, 1, 1).items)
    results = {}
    for device in (dev, "cpu"):
        t = trainer(device, unused_dir)
        t.model.train()
        loss, _ = t._forward_loss(t._to_device(one), train=True)
        loss.backward()
        results[str(device)] = (loss.item(), {k: p.grad.detach().cpu()
                                              for k, p in t.model.named_parameters()})
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results[str(dev)], results["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    cat = [torch.cat([g[k].flatten() for k in sorted(g)]) for g in (g_gpu, g_cpu)]
    grad_snr = snr_db(*cat)
    worst = min((snr_db(g_gpu[k], g_cpu[k]), k) for k in g_cpu if g_cpu[k].abs().max() > 0)
    log(f"[{tag}] one step card vs CPU (1 x 1 s): loss {loss_gpu:.6f} vs {loss_cpu:.6f} "
        f"(rel {rel:.2e}); concatenated gradients {grad_snr:.2f} dB SNR; lowest tensor "
        f"{worst[0]:.2f} dB ({worst[1]})")
    if not (rel <= 1e-4 and grad_snr >= 40.0):
        raise AssertionError(f"card vs CPU train step: loss rel {rel}, gradient SNR {grad_snr}")
    # the checkpoints hold Adam's moments (~30 MB each): checked, then removed
    # so that chiprun_out/ stays small
    shutil.rmtree(ckpt_dir)
    shutil.rmtree(unused_dir, ignore_errors=True)
    return {"launches": launches, "checkpoints": files, "n_train_steps": n_train, "n_eval_steps": n_eval,
            "run_wall_s": wall, "ms_per_step": ms_step, "peak_memory_gb": peak_gb,
            "losses_10_steps": losses, "card_vs_cpu_grad_snr_db": grad_snr,
            "card_vs_cpu_loss_rel": rel}


def phase_bss_serving(torch, dev, cfg, tag, per_batch):
    """Phase 8: the BSS ``Inferencer.run`` over 12 mixtures with the DPRNN-
    TasNet of ``cfg``, ``per_batch`` kernel launches per batch and no other;
    then one 2 s request card vs CPU, and bucketed with a longer one against
    the request alone."""
    import numpy as np

    from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, collate_bss_eval
    from tss_dprnn_tpu_torch.inference import Inferencer
    from tss_dprnn_tpu_torch.models import DPRNNTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    ckpt = os.path.join(OUT_DIR, f"{tag}_random.pt")
    torch.save(init_weights_(DPRNNTasNet(**cfg),
                             torch.Generator().manual_seed(SEED + 8)).state_dict(), ckpt)
    ds = Mixtures(SEED + 8, 12)
    batch_size, n_buckets = 4, 2
    n_batches = len(BucketedEvalLoader(ds, batch_size, collate_bss_eval, ds.lengths(),
                                       n_buckets=n_buckets))
    savedir = os.path.join(OUT_DIR, f"{tag}_metrics")
    inf = Inferencer(DPRNNTasNet(**cfg), {"checkpoint_path": ckpt, "test_savedir": savedir,
                                          "metrics": ["si_sdr"]}, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(all_launches(), **product_launches())
    audio_s = sum(ds.lengths()) / SAMPLE_RATE
    log(f"[{tag}] {len(ds)} mixtures, {n_batches} batches, {audio_s:.2f} audio-s in {wall:.3f} s "
        f"= {audio_s / wall:.2f} audio-s/s (first run, includes warm-up); launches "
        f"{ {k: v for k, v in launches.items() if v} }; final {final}")
    expect_launches(launches, with_products(per_batch), n_batches, f"{tag} serving")
    with open(os.path.join(savedir, "all_metrics.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    si = [float(r.split(",")[1]) for r in rows]
    if len(si) != len(ds) or not all(math.isfinite(v) for v in si):
        raise AssertionError(f"non-finite or missing si_sdr rows: {si}")
    if not os.path.exists(os.path.join(savedir, "final_metrics.json")):
        raise AssertionError("final_metrics.json was not written")

    # one 2 s request: card vs CPU at its exact shape, and bucketed with a 3 s one
    rng = np.random.default_rng(SEED + 9)
    n, n_long = 2 * SAMPLE_RATE, 3 * SAMPLE_RATE
    mixes = [0.1 * rng.standard_normal(m).astype(np.float32) for m in (n, n_long)]
    batch = collate_bss_eval([(m, np.stack([m, m])) for m in mixes], n_long)
    batch["lengths"] = np.array([n, n_long], np.int32)
    inf_cpu = Inferencer(DPRNNTasNet(**cfg), {"checkpoint_path": ckpt, "metrics": ["si_sdr"]},
                         device="cpu")
    with torch.inference_mode():
        est_gpu, est_cpu = (i.model(torch.from_numpy(mixes[0]).to(i.device)[None])[0].cpu()
                            for i in (inf, inf_cpu))
        bucketed = inf.forward(batch)[0, :, :n].cpu()
    s_cpu = snr_db(est_gpu, est_cpu)
    err_bucket = float((bucketed - est_gpu).abs().max())
    log(f"[{tag}] card vs CPU: {s_cpu:.2f} dB SNR; bucketed vs alone: "
        f"{snr_db(bucketed, est_gpu):.2f} dB SNR, max|err|={err_bucket:.3e}")
    if not s_cpu >= 50.0:
        raise AssertionError(f"{tag}: card vs CPU SNR {s_cpu:.2f} dB < 50 dB")
    if not torch.allclose(bucketed, est_gpu, atol=2e-4, rtol=1e-4):
        raise AssertionError(f"{tag}: bucketed row differs from the request alone: {err_bucket}")
    return {"launches": launches, "n_batches": n_batches, "audio_s_per_s": audio_s / wall,
            "final": final, "card_vs_cpu_snr_db": s_cpu, "bucketed_max_abs_err": err_bucket}


def bound_gemm_bf16(M: int, N: int, K: int):
    """The bf16-operand product's least time: 2 M N K FLOP over the bf16
    peak, or x and W (bf16) and the bias read once and P (fp32) written once
    over the HBM rate."""
    t_ops = 2 * M * N * K / PEAK_BF16
    t_bytes = (2 * (M * K + K * N) + 4 * N + 4 * M * N) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_optin_kernels(torch, dev):
    """Phase 10: the opt-in and test-only kernels against their plain
    versions, at the shapes of 8 x 10 s and a ragged one each, timed beside
    the plain versions, their bounds and cuDNN. Every entry runs the serving
    route: in fp32 bit for bit the default route's outputs where it computes
    the same function, in bf16 through the bf16-operand product, which is
    held and timed on its own too (the dense mode's output products alone as
    well). Returns (entries, the bf16 product's entry)."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2
    from tss_dprnn_tpu_torch.ops import lstm as L

    F = H = Fo = 128
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    S10 = (10 * SAMPLE_RATE - 1 + K) // hop + 1
    g = torch.Generator(device="cpu").manual_seed(SEED + 10)
    k = H ** -0.5

    def uniform(*shape):
        return (torch.rand(*shape, generator=g) * 2 * k - k).to(dev)

    w_ih2, w_hh2, b2 = uniform(2, F, 4 * H), uniform(2, H, 4 * H), uniform(2, 4 * H)
    wo2 = uniform(2, H, Fo)
    w1 = (w_ih2[:1], w_hh2[:1], b2[:1])  # one direction, JAX argument order
    lstms = {dt: cudnn_lstm(torch, w_ih2, b2, w_hh2, dt) for dt in (torch.float32, torch.bfloat16)}
    lstms1 = {dt: cudnn_lstm(torch, w1[0], w1[2], w1[1], dt)
              for dt in (torch.float32, torch.bfloat16)}

    def dense_library(dt, x):  # cuDNN bidirectional, then the two cuBLAS half-products
        out = lstms[dt](x)[0]
        wo = wo2.to(dt)
        return out[..., :H] @ wo[0], out[..., H:] @ wo[1]

    route = f"{SERVE_WITH} + {SERVE_SOURCE}"
    # name -> (wrapper, plain version, library call, source, replaces, bound,
    # input layout, the default route's call (fp32 bit for bit) or None,
    # product launches per call, the batch-major route's call (bf16 bit for
    # bit) or None)
    kernels = {
        "bilstm2_dense_forward": (
            lambda x: B2.bilstm2_dense_forward(x, w_ih2, b2, w_hh2, wo2),
            lambda x: B2.bilstm2_dense_reference(x, w_ih2, b2, w_hh2, wo2),
            dense_library, route, "pallas_lstm.py:698 (dense mode, :969)",
            lambda R, T, size, peak: bound_dense(R * T, R, T, F, H, Fo, size, peak), "rtf", None,
            3, None),
        "bilstm2_forward_bm": (
            lambda x: B2.bilstm2_forward_bm(x, w_ih2, b2, w_hh2),
            lambda x: B2.bilstm2_bm_reference(x, w_ih2, b2, w_hh2),
            lambda dt, x: lstms[dt](x)[0].split(H, dim=-1), route, "pallas_lstm.py:1088",
            lambda R, T, size, peak: bound(R * T, R, T, F, H, size, peak), "rtf",
            lambda x: B2.bilstm2_forward(x, w_ih2, b2, w_hh2), 1, None),
        "bilstm_fused": (
            lambda x: L.bilstm_fused(x, w_ih2, w_hh2, b2),
            lambda x: L.bilstm_fused_reference(x, w_ih2, w_hh2, b2),
            lambda dt, x: lstms[dt](x)[0], route, "pallas_lstm.py:57 (reverse_dir1, :171)",
            lambda R, T, size, peak: bound(R * T, R, T, F, H, size, peak), "rtf",
            lambda x: torch.cat(B2.bilstm2_forward(x, w_ih2, b2, w_hh2), dim=-1), 1,
            lambda x: torch.cat(B2.bilstm2_forward_bm(x, w_ih2, b2, w_hh2), dim=-1)),
        "bilstm_v2": (
            lambda x: L.bilstm_v2(x, w_ih2, w_hh2, b2),
            lambda x: L.bilstm_v2_reference(x, w_ih2, w_hh2, b2),
            lambda dt, x: lstms[dt](x)[0], route, "pallas_lstm.py:275 (via :402)",
            lambda R, T, size, peak: bound(R * T, R, T, F, H, size, peak), "rtf",
            lambda x: torch.cat(B2.bilstm2_forward(x, w_ih2, b2, w_hh2), dim=-1), 1, None),
        "lstm_scan_v2": (
            lambda x: L.lstm_scan_v2(x, *w1),
            lambda x: L.lstm_v2_reference(x, *w1),
            lambda dt, x: lstms1[dt](x[0])[0], route, "pallas_lstm.py:275 (via :418)",
            lambda R, T, size, peak: bound_stack("forward", 1, R, T, F, H, size, peak), "drtf",
            lambda x: L.lstm_forward(x, w1[0], w1[2], w1[1]), 1, None),
    }
    shapes = {"bilstm2_dense_forward": (8 * S10, K), "bilstm2_forward_bm": (8 * S10, K),
              "bilstm_fused": (8 * S10, K), "bilstm_v2": (8 * S10, K),
              "lstm_scan_v2": (8 * K, S10)}
    ragged = (203, 33)  # R not a multiple of any tile, T of no block of steps
    entries = []

    def flat(out):
        return torch.cat([o.float().flatten() for o in (out if isinstance(out, tuple)
                                                        else (out,))])

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a if isinstance(a, tuple) else (a,),
                                                      b if isinstance(b, tuple) else (b,)))

    for name, (fn, plain, library, source, replaces, least, layout, default, products,
               default16) in kernels.items():
        def make(R, T):
            x = torch.randn(R, T, F, generator=g).to(dev)
            return x[None] if layout == "drtf" else x

        R, T = shapes[name]
        x = make(R, T)
        xb = x.bfloat16()
        xr = make(*ragged)
        xrb = xr.bfloat16()
        # the launches of one fp32 and one bf16 call of the public entry
        reset_launches()
        got32, got16 = fn(x), fn(xb)
        torch.cuda.synchronize()
        per_call = {k2: v for k2, v in dict(all_launches(), **product_launches()).items() if v}
        want_calls = {name: 2, "products_gemm": products, "products_gemm_bf16": products}
        log(f"[optin-kernels] {name}: one fp32 and one bf16 call launched {per_call}")
        if per_call != want_calls:
            raise AssertionError(f"{name}: one fp32 and one bf16 call should launch {want_calls}, "
                                 f"counted {per_call}")
        # the batch-major route's own launches, bf16: the same outputs bit for bit
        bitwise16 = None if default16 is None else (same(got16, default16(xb))
                                                    and same(fn(xrb), default16(xrb)))
        ref32 = flat(plain(x))
        err32 = float((flat(got32) - ref32).abs().max())
        ref16 = flat(plain(xb))
        got16 = flat(got16)
        snr16, plain16_snr = snr_db(got16, ref32), snr_db(got16, ref16)
        plain16_err = float((got16 - ref16).abs().max())
        with torch.no_grad():
            library_err = float((flat(library(torch.float32, x)) - ref32).abs().max())
        ragged_err = float((flat(fn(xr)) - flat(plain(xr))).abs().max())
        got16r, ref16r = flat(fn(xrb)), flat(plain(xrb))
        ragged16_err = float((got16r - ref16r).abs().max())
        ragged16_snr = snr_db(got16r, ref16r)
        # the default route's own launches, fp32: the same outputs bit for bit
        bitwise = None if default is None else (same(got32, default(x))
                                                and same(fn(xr), default(xr)))
        torch.cuda.synchronize()
        log(f"[optin-kernels] {name} R={R} T={T}: fp32 max|err|={err32:.3e} (ragged R={ragged[0]} "
            f"T={ragged[1]}: {ragged_err:.3e}); bf16 SNR {snr16:.2f} dB, vs bf16 plain max|err|="
            f"{plain16_err:.3e} SNR {plain16_snr:.2f} dB (ragged {ragged16_err:.3e}, "
            f"{ragged16_snr:.2f} dB); library vs plain {library_err:.3e}"
            + ("" if bitwise is None else f"; fp32 bit for bit the default route's: {bitwise}")
            + ("" if bitwise16 is None else f"; bf16 bit for bit the batch-major route's: "
               f"{bitwise16}"))
        if not max(err32, ragged_err) <= 1e-4:
            raise AssertionError(f"{name} fp32 disagrees with its plain version: {err32}, "
                                 f"ragged {ragged_err}")
        if bitwise is False:
            raise AssertionError(f"{name} fp32 differs from the default route's outputs")
        if bitwise16 is False:
            raise AssertionError(f"{name} bf16 differs from the batch-major route's outputs")
        snr_bar = V2_BF16_SNR_DB if name.endswith("v2") else BF16_SNR_DB
        if name.endswith("v2"):  # what the bar must tell apart: the h-only rounding
            h_only = flat(L.bilstm_fused_reference(xb, w_ih2, w_hh2, b2) if layout == "rtf"
                          else L.lstm_reference(xb, w1[0], w1[2], w1[1]))
            wrong_rounding_snr = snr_db(h_only, ref16)
            log(f"[optin-kernels] {name}: the h-only bf16 rounding vs the v2 plain version "
                f"{wrong_rounding_snr:.2f} dB (bar {snr_bar} dB)")
            del h_only
        if not (max(plain16_err, ragged16_err) <= BF16_ATOL
                and min(plain16_snr, ragged16_snr) >= snr_bar):
            raise AssertionError(f"{name} bf16 disagrees with its bf16 plain version: max|err| "
                                 f"{plain16_err} / ragged {ragged16_err} (<= {BF16_ATOL}), SNR "
                                 f"{plain16_snr:.2f} / ragged {ragged16_snr:.2f} dB "
                                 f"(>= {snr_bar})")
        entry = {"name": name, "dtype": "float32", "route": "cuda", "source": source,
                 "replaces": f"tss_dprnn_tpu/ops/pallas_lstm.py:{replaces.split(':', 1)[1]}",
                 "shape": {"D": 1, "R": R, "T": T, "F": F, "H": H} if layout == "drtf"
                 else {"R": R, "T": T, "F": F, "H": H},
                 "max_abs_err": err32, "ragged": {"R": ragged[0], "T": ragged[1],
                                                  "max_abs_err": ragged_err,
                                                  "bf16_max_abs_err": ragged16_err,
                                                  "bf16_snr_db": ragged16_snr},
                 "launches_per_fp32_and_bf16_call": per_call,
                 "library_max_abs_err": library_err,
                 "library": ("cuDNN bidirectional LSTM + two cuBLAS half-products"
                             if name == "bilstm2_dense_forward" else
                             "cuDNN LSTM, " + ("unidirectional" if layout == "drtf"
                                               else "bidirectional"))}
        if bitwise is not None:
            entry["fp32_bit_for_bit_default_route"] = bitwise
        if bitwise16 is not None:
            entry["bf16_bit_for_bit_batch_major_route"] = bitwise16
        if name == "bilstm2_dense_forward":
            entry["shape"]["Fo"] = Fo
        for dt, key, peak, size in ((torch.float32, None, PEAK_FP32, 4),
                                    (torch.bfloat16, "bf16", PEAK_BF16, 2)):
            xx = x.to(dt)
            ms = time_ms(lambda: fn(xx), 5)
            plain_ms = time_ms(lambda: plain(xx), 1)
            with torch.no_grad():
                library_ms = time_ms(lambda: library(dt, xx), 3)
            bound_ms, bound_by = least(R, T, size, peak)
            nums = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms}
            if key is None:
                entry.update(nums)
            else:
                entry[key] = dict(nums, snr_db=snr16, plain_max_abs_err=plain16_err,
                                  plain_snr_db=plain16_snr, plain_snr_bar_db=snr_bar)
                if name.endswith("v2"):
                    entry[key]["h_only_rounding_snr_db"] = wrong_rounding_snr
            log(f"[optin-kernels] {name} {dt}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"library {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        if products:  # the bf16-operand input product alone, and its share of a bf16 call
            N = (4 if layout == "drtf" else 8) * H
            w_cat = (w1[0][0] if layout == "drtf"
                     else w_ih2.transpose(0, 1).reshape(F, N)).bfloat16().contiguous()
            bias = (b2[0] if layout == "drtf" else b2.flatten()).contiguous()
            pre = torch.empty(R * T, N, device=dev)
            lib = B2._library_products()
            stream = torch.cuda.current_stream().cuda_stream
            x2 = xb.reshape(R * T, F)
            p_ms = time_ms(lambda: B2._gemm_bf16(lib, stream, x2, 0, w_cat, R * T, N, bias, pre, 0,
                                                 N), 5)
            entry["bf16"]["product"] = {"ms": p_ms, "tflops": 2 * R * T * N * F / p_ms / 1e9,
                                        "share_of_call": p_ms / entry["bf16"]["ms"]}
            log(f"[optin-kernels] {name} bf16 product alone (M={R * T} N={N} K={F}): {p_ms:.3f} "
                f"ms, {2 * R * T * N * F / p_ms / 1e9:.1f} TFLOP/s, "
                f"{100 * p_ms / entry['bf16']['ms']:.1f} % of the bf16 call")
            del pre
        if name == "bilstm2_dense_forward":  # the two output products alone, both lanes
            _dense_output_products(torch, dev, g, entry, R * T, H, wo2)
        entries.append(entry)
        del x, xb, xr, xrb, got32, got16, ref32, ref16
        torch.cuda.empty_cache()
    # lstm_scan, the JAX entry's argument order over lstm_forward's kernel
    xr = torch.randn(2, *ragged, F, generator=g).to(dev)
    scan_err = float((L.lstm_scan(xr, w_ih2, w_hh2, b2)
                      - L.lstm_reference(xr, w_ih2, b2, w_hh2)).abs().max())
    log(f"[optin-kernels] lstm_scan D=2 R={ragged[0]} T={ragged[1]}: max|err|={scan_err:.3e}")
    if not scan_err <= 1e-4:
        raise AssertionError(f"lstm_scan disagrees with its plain version: {scan_err}")
    del lstms, lstms1
    torch.cuda.empty_cache()
    return entries, _bf16_product_entry(torch, dev, g, shapes["bilstm2_forward_bm"], F, H)


def _dense_output_products(torch, dev, g, entry, M, H, wo2):
    """The dense mode's two SplitDense products alone (y_d = h_d @ wo2[d] over
    M row-steps, h_d read from a [M, 2H] scratch as the route reads it), per
    lane: their ms, TFLOP/s and share of the entry's call, into ``entry``."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    Fo = wo2.shape[-1]
    h = torch.rand(M, 2 * H, generator=g).to(dev) * 2 - 1
    lib = B2._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    for key, dt in ((None, torch.float32), ("bf16", torch.bfloat16)):
        hh, wo = h.to(dt), wo2.to(dt).contiguous()
        ys = [torch.empty(M, Fo, dtype=dt, device=dev) for _ in range(2)]

        def run():
            for d, y in enumerate(ys):
                if dt == torch.bfloat16:
                    B2._gemm_bf16(lib, stream, hh, d * H, wo[d], M, Fo, None, y, 0, Fo, lda=2 * H)
                else:
                    B2._gemm(lib, stream, False, [(hh, d * H, 2 * H, wo, d * H * Fo, Fo, H)], M, Fo,
                             out=y, ldc=Fo)

        ms = time_ms(run, 5)
        nums = {"ms": ms, "tflops": 2 * 2 * M * H * Fo / ms / 1e9}
        sub = entry if key is None else entry[key]
        nums["share_of_call"] = ms / sub["ms"]
        sub["output_products"] = nums
        log(f"[optin-kernels] bilstm2_dense_forward {dt} output products alone (2 x M={M} N={Fo} "
            f"K={H}): {ms:.3f} ms, {nums['tflops']:.1f} TFLOP/s, "
            f"{100 * nums['share_of_call']:.1f} % of the call")
        del hh, ys
    del h
    torch.cuda.empty_cache()


def _bf16_product_entry(torch, dev, g, shape, F, H):
    """The bf16-operand product (csrc/products.cu, products_gemm_bf16) at the
    batch-major pair's shape: against its plain version and float64 (beside
    torch.matmul fp32's error against float64), timed beside the plain
    version, the bound and one fp32 torch.addmm of the upcast operands."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    R, T = shape
    M, N, K = R * T, 8 * H, F
    k = H ** -0.5
    x = torch.randn(M, K, generator=g).bfloat16().to(dev)
    w = ((torch.rand(K, N, generator=g) * 2 - 1) * k).bfloat16().to(dev)
    bias = ((torch.rand(N, generator=g) * 2 - 1) * k).to(dev)
    out = torch.empty(M, N, device=dev)
    lib = B2._library_products()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        B2._gemm_bf16(lib, stream, x, 0, w, M, N, bias, out, 0, N)

    run()
    plain = B2.gemm_bf16_reference(x, w, bias)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    rows = slice(0, 65536)  # float64 on a slice: the full product would take 1.3 GB x 2
    ref64 = x[rows].double() @ w.double() + bias.double()
    scale = float(ref64.abs().max())
    err64 = float((out[rows].double() - ref64).abs().max()) / scale
    torch_err64 = float((plain[rows].double() - ref64).abs().max()) / scale
    del plain, ref64
    xf, wf = x.float(), w.float()
    ms = time_ms(run, 10)
    plain_ms = time_ms(lambda: B2.gemm_bf16_reference(x, w, bias), 3)
    library_ms = time_ms(lambda: torch.addmm(bias, xf, wf), 5)
    bound_ms, bound_by = bound_gemm_bf16(M, N, K)
    log(f"[optin-kernels] products_gemm_bf16 M={M} N={N} K={K}: max|err| vs plain {err:.3e}; "
        f"vs float64 {err64:.3e} of max|ref| (torch.matmul fp32 {torch_err64:.3e}); "
        f"{ms:.3f} ms ({2 * M * N * K / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"torch.addmm fp32 {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    if not (err64 <= BF16_PRODUCT_REL_TOL and err <= 1e-4):
        raise AssertionError(f"the bf16 product is {err64:.3e} of max|ref| off float64 (bar "
                             f"{BF16_PRODUCT_REL_TOL:.3e}), {err:.3e} off its plain version")
    del out, xf, wf
    torch.cuda.empty_cache()
    return {"name": "products_gemm_bf16", "route": "cuda",
            "source": "tss_dprnn_tpu_torch/csrc/products.cu",
            "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:1088 (x @ W_ih of the bf16 streams; "
                        "with :275 the same in lstm_scan_v2 and bilstm_v2)",
            "shape": {"M": M, "N": N, "K": K}, "max_abs_err": err, "rel_err_float64": err64,
            "torch_fp32_rel_err_float64": torch_err64, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library": "torch.addmm fp32 on the upcast operands (TF32 off)",
            "tflops": 2 * M * N * K / ms / 1e9}


def phase_tiny_widths(torch, dev):
    """Phase 12: the tiny drive models (F = 12, H = 10; TSS and causal BSS),
    each with one bucketed batch served and one train step, card against
    CPU: every wrapper zero-pads to the kernels' widths and cuts the pad off
    again, so the card must agree with the plain versions at the model's own
    widths (forward >= 50 dB; loss within 1e-4 relative, gradients >= 40 dB),
    through the expected kernels and no other."""
    from tss_dprnn_tpu_torch import inference, training
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    families = {
        "tss": dict(model=lambda: DPRNNSpeTasNet(**TINY_SPE), inferencer=inference.InferencerSpe,
                    trainer=training.TrainerSpe, config=TRAIN_CONFIG,
                    requests=lambda: Requests(SEED + 12, 4),
                    collate_eval=loader.make_collate_spe_eval(), collate=loader.collate_spe,
                    crops=Crops, serve={"bilstm2_forward": 1, "bilstm2_forward_masked": 1},
                    step={"bilstm2_forward_resid": 2, "bilstm2_backward": 2},
                    products={"products_gemm": 10, "products_colsum": 2}),
        "bss": dict(model=lambda: DPRNNTasNet(**TINY_BSS), inferencer=inference.Inferencer,
                    trainer=training.Trainer, config=BSS_TRAIN_CONFIG,
                    requests=lambda: Mixtures(SEED + 12, 4),
                    collate_eval=loader.collate_bss_eval, collate=loader.collate_bss,
                    crops=Mixtures, serve={"bilstm2_forward": 1, "lstm_forward": 1},
                    step={"bilstm2_forward_resid": 1, "bilstm2_backward": 1,
                          "lstm_forward_resid": 1, "lstm_backward": 1},
                    products={"products_gemm": 9, "products_colsum": 2}),
    }
    results = {}
    for tag, fam in families.items():
        start = init_weights_(fam["model"](), torch.Generator().manual_seed(SEED + 12))
        ckpt = os.path.join(OUT_DIR, f"tiny_{tag}.pt")
        torch.save(start.state_dict(), ckpt)
        ds = fam["requests"]()
        batch = next(iter(loader.BucketedEvalLoader(ds, 2, fam["collate_eval"], ds.lengths(),
                                                    n_buckets=2)))
        outs = {}
        for device in (dev, "cpu"):
            inf = fam["inferencer"](fam["model"](), {"checkpoint_path": ckpt,
                                                     "metrics": ["si_sdr"]}, device=device)
            reset_launches()
            with torch.inference_mode():
                outs[str(device)] = inf.forward(batch).cpu()
            if device == dev:
                torch.cuda.synchronize()
                served = dict(all_launches(), **product_launches())
        expect_launches(served, with_products(fam["serve"]), 1, f"tiny {tag} served batch")
        serve_snr = snr_db(outs[str(dev)], outs["cpu"])

        one = fam["collate"](fam["crops"](SEED + 13, 2, 1).items)
        steps = {}
        for device in (dev, "cpu"):
            model = fam["model"]()
            model.load_state_dict(start.state_dict(), strict=True)
            t = fam["trainer"](model, dict(fam["config"], new_checkpoints_path=os.path.join(
                OUT_DIR, "tiny_ckpt_unused")), device=device)
            t.model.train()
            reset_launches()
            loss, _ = t._forward_loss(t._to_device(one), train=True)
            loss.backward()
            if device == dev:
                torch.cuda.synchronize()
                stepped = dict(all_launches(), **product_launches())
            steps[str(device)] = (loss.item(), {k: p.grad.detach().cpu()
                                                for k, p in t.model.named_parameters()})
        expect_launches(stepped, dict(fam["step"], **fam["products"]), 1,
                        f"tiny {tag} train step")
        (loss_gpu, g_gpu), (loss_cpu, g_cpu) = steps[str(dev)], steps["cpu"]
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        grad_snr = snr_db(*(torch.cat([g[k].flatten() for k in sorted(g)]) for g in (g_gpu, g_cpu)))
        log(f"[tiny] {tag} F={TINY_BSS['feature_size']} H={TINY_BSS['hidden_size']}: served "
            f"batch card vs CPU {serve_snr:.2f} dB SNR (launches "
            f"{ {k: v for k, v in served.items() if v} }); train step loss {loss_gpu:.6f} vs "
            f"{loss_cpu:.6f} (rel {rel:.2e}), gradients {grad_snr:.2f} dB SNR (launches "
            f"{ {k: v for k, v in stepped.items() if v} })")
        if not (serve_snr >= 50.0 and rel <= 1e-4 and grad_snr >= 40.0):
            raise AssertionError(f"tiny {tag} card vs CPU: served {serve_snr:.2f} dB, loss rel "
                                 f"{rel}, gradients {grad_snr:.2f} dB")
        results[tag] = {"served_launches": served, "step_launches": stepped,
                        "serve_snr_db": serve_snr, "step_loss_rel": rel,
                        "step_grad_snr_db": grad_snr}
    import shutil

    shutil.rmtree(os.path.join(OUT_DIR, "tiny_ckpt_unused"), ignore_errors=True)
    return results


# ------------------------------------------------------------------ phase 13

# the synthetic LibriMix corpus of the [cli] phase: (mixtures, seconds) per split
CLI_SPLITS = {"train": (20, (3.0, 5.0)), "eval": (10, (3.0, 5.0)), "test": (12, (2.0, 10.0))}
CLI_SPEAKERS = 8
# every column of the CLI's all_metrics.csv against a direct InferencerSpe.run
# on the card (the same forward: SI-SDR in dB as the issue states, the host
# metrics as in the CPU tests), and the host metrics of the card against the
# port's CPU run of the same checkpoint (STOI, PESQ in MOS)
CLI_ROW_TOL = {"si_sdr": 1e-4, "stoi": 1e-6, "pesq": 1e-4}
# measured on the H100 (3 rows): STOI 3.2e-8, PESQ 1.8e-8
CPU_ROW_TOL = {"stoi": 1e-6, "pesq": 1e-4}
CLI_CPU_ROWS = 3  # the shortest test mixtures, run again on the CPU
# the device metric lane (fp32 on the card) against the host lane (float64)
# of the same checkpoint: the JAX package's bars, (max |delta|, median |delta|)
# (tests/test_stoi_jax.py, tests/test_pesq_jax.py)
LANE_TOL = {"stoi": (2e-3, 5e-4), "pesq": (0.05, 0.02)}
# the demo mixtures of cli.train: in range of the synthetic eval split (the
# shipped ids reach 2899)
CLI_IDS = [0, 3, 7]


def write_corpus(root: str, split: str, n: int, secs, seed: int) -> str:
    """A LibriMix-style split under ``root/split``: ``mix_clean/``, ``s1/``,
    ``s2/`` WAVs named ``<spk>-<chap>-<utt>_<spk>-<chap>-<utt>.wav`` (written
    with the port's ``data/wav.write``) and its metadata CSV; returns the
    CSV's path. Sources are harmonic tones under a syllable-rate envelope
    plus a little noise, from ``seed``."""
    import csv

    import numpy as np

    from tss_dprnn_tpu_torch.data import wav

    rng = np.random.default_rng(seed)
    base = os.path.join(root, split)
    dirs = ("mix_clean", "s1", "s2")
    for d in dirs:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rows, utt = [], {}
    for i in range(n):
        T = int(SAMPLE_RATE * rng.uniform(*secs))
        t = np.arange(T) / SAMPLE_RATE
        ids, srcs = [], []
        for j, spk in enumerate(rng.choice(CLI_SPEAKERS, size=2, replace=False) + 100):
            utt[spk] = utt.get(spk, 0) + 1
            ids.append(f"{spk}-{(j + 1) * 100 + i}-{utt[spk]:04d}")
            f0 = rng.uniform(100, 300)
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t + j)
            s = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
                    for k in range(1, 6))
            srcs.append((0.15 * env * s + 0.02 * rng.standard_normal(T)).astype(np.float32))
        stem = "_".join(ids)
        paths = [os.path.join(base, d, stem + ".wav") for d in dirs]
        for p, x in zip(paths, (srcs[0] + srcs[1], *srcs)):
            wav.write(p, x, SAMPLE_RATE)
        rows.append([stem, *paths, T])
    csv_path = os.path.join(base, f"mixture_{split}_mix_clean.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mixture_ID", "mixture_path", "source_1_path", "source_2_path", "length"])
        w.writerows(rows)
    return csv_path


class recorded_training:
    """Patches ``Trainer.train_step``, ``Trainer.eval_step``,
    ``Trainer._log_epoch`` and ``Trainer._mixtures_inference`` while it is
    entered, so that a run the CLI builds reports each train step's time
    (between two synchronisations of the card) and batch width, its eval
    steps, each epoch's loss and each pass over the eval mixtures; and records
    every line the port's loggers write meanwhile."""

    def __init__(self, torch):
        from tss_dprnn_tpu_torch.training.trainer import Trainer

        self.torch, self.cls = torch, Trainer
        self.step_ms, self.widths, self.epochs, self.mixture_passes = [], [], [], 0
        self.eval_steps = 0
        self.lines = log_lines()

    def __enter__(self):
        torch, step, log_epoch = self.torch, self.cls.train_step, self.cls._log_epoch
        mixtures, eval_step = self.cls._mixtures_inference, self.cls.eval_step
        self._saved = (step, log_epoch, mixtures, eval_step)
        self.lines.__enter__()

        def train_step(trainer, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(trainer, batch)
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.widths.append(int(batch["mix"].shape[-1]))
            return out

        def counted_eval_step(trainer, batch):
            self.eval_steps += 1
            return eval_step(trainer, batch)

        def _log_epoch(trainer, total_loss, num_steps, start, mode):
            loss = log_epoch(trainer, total_loss, num_steps, start, mode)
            self.epochs.append((mode, loss))
            return loss

        def _mixtures_inference(trainer):
            self.mixture_passes += 1
            return mixtures(trainer)

        self.cls.train_step, self.cls._log_epoch = train_step, _log_epoch
        self.cls._mixtures_inference, self.cls.eval_step = _mixtures_inference, counted_eval_step
        return self

    def __exit__(self, *exc):
        (self.cls.train_step, self.cls._log_epoch, self.cls._mixtures_inference,
         self.cls.eval_step) = self._saved
        self.lines.__exit__(*exc)


class log_lines:
    """Records the messages of the port's loggers while it is entered."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(handler, record):
                self.messages.append(record.getMessage())

        self.messages, self.handler = [], Handler()

    def __enter__(self):
        import logging

        logging.getLogger("tss_dprnn_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("tss_dprnn_tpu_torch").removeHandler(self.handler)


def _csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def _rows_within(got, want, tol, what):
    """Worst |got - want| per column over rows matched by ``index``; raises
    when a column exceeds its bar in ``tol``."""
    worst = {}
    for g, w in zip(got, want):
        if g["index"] != w["index"]:
            raise AssertionError(f"{what}: row order differs: {g['index']} vs {w['index']}")
        for metric, bar in tol.items():
            for key in (metric, "input_" + metric):
                err = abs(float(g[key]) - float(w[key]))
                worst[key] = max(worst.get(key, 0.0), err)
                if not err <= bar:
                    raise AssertionError(f"{what}: row {g['index']} {key} {g[key]} vs {w[key]} "
                                         f"(bar {bar})")
    return worst


def _lane_within(got, want, what):
    """The device lane's rows against the host lane's at LANE_TOL (each
    metric and its input); returns the worst and the median |delta|."""
    import statistics

    out = {}
    for metric, (bar, median_bar) in LANE_TOL.items():
        errs = []
        for g, w in zip(got, want):
            if g["index"] != w["index"]:
                raise AssertionError(f"{what}: row order differs: {g['index']} vs {w['index']}")
            errs += [abs(float(g[k]) - float(w[k])) for k in (metric, "input_" + metric)]
        worst, median = max(errs), statistics.median(errs)
        out[metric] = {"max": worst, "median": median}
        if not (worst <= bar and median <= median_bar):
            raise AssertionError(f"{what}: {metric} off the host lane by {worst} (median "
                                 f"{median}; bars {bar}, {median_bar})")
    return out


def phase_cli(torch, dev):
    """Phase 13: the shipped entry points on a synthetic LibriMix corpus:
    cli.generate_manifests, cli.train on configs/train_tss.yaml (2 epochs at
    full flagship width, with in-range eval mixtures for the reporter),
    cli.test on configs/test_tss.yaml with the metric triple on the host,
    with --device-metrics and with --device-pesq, and on configs/test_bss.yaml
    on the host and with --device-pesq, each checked for its kernel launches
    and against a direct run, the host lane or the CPU, as the module
    docstring says."""
    from tss_dprnn_tpu_torch.inference.inferencer import host_counts

    import shutil

    from tss_dprnn_tpu_torch.cli import generate_manifests, test as test_cli, train as train_cli
    from tss_dprnn_tpu_torch.data.librimix import Librimix, LibrimixSpe
    from tss_dprnn_tpu_torch.data.loader import (BucketedEvalLoader, collate_bss_eval,
                                                 make_collate_spe_eval)
    from tss_dprnn_tpu_torch.data.manifest import load_manifest
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models.registry import build_model
    from tss_dprnn_tpu_torch.utils.config import load_config, model_config
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    root = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(root, ignore_errors=True)
    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    cfg_dir = os.path.join(HERE, "configs")
    results = {}

    # -- 1-2: the corpus, and its manifests frozen through the CLI
    t0 = time.perf_counter()
    csvs = {split: write_corpus(os.path.join(root, "corpus"), split, count, secs, SEED + 30 + k)
            for k, (split, (count, secs)) in enumerate(CLI_SPLITS.items())}
    manifests = {split: os.path.join(root, "manifests", f"{split}.json") for split in csvs}
    gen_yaml = os.path.join(root, "generate_manifests.yaml")
    with open(gen_yaml, "w") as f:
        f.write("# the verify flow's step 2, read by the port's YAML reader\n"
                "dataset_type: librimix_spe\nsample_rate: 8000\nn_src: 2\nsegment: 3\nseed: 0\n"
                + "".join(f"{s}_path: {csvs[s]}\n{s}_out: {manifests[s]}\n" for s in csvs))
    generate_manifests.main(["--config", gen_yaml])
    entries = {s: load_manifest(p)["entries"] for s, p in manifests.items()}
    log(f"[cli] corpus and manifests in {time.perf_counter() - t0:.2f} s: "
        f"{ {s: len(e) for s, e in entries.items()} } mixtures")
    if [len(entries[s]) for s in CLI_SPLITS] != [c for c, _ in CLI_SPLITS.values()]:
        raise AssertionError(f"manifests lost mixtures: { {s: len(e) for s, e in entries.items()} }")

    # -- 3: cli.train on configs/train_tss.yaml, 2 epochs
    ckpt_dir = os.path.join(root, "chkpts")
    train_argv = ["--config", os.path.join(cfg_dir, "train_tss.yaml"), "--mode", "tss_spe",
                  "--set", f"data.use_generated_train={manifests['train']}",
                  f"data.use_generated_eval={manifests['eval']}", "epochs=2",
                  f"logs.metadata.ids=[{', '.join(map(str, CLI_IDS))}]",
                  f"new_checkpoints_path={ckpt_dir}", *device_args]
    train_cfg = load_config(train_argv[1])
    batch, n = train_cfg["data"]["batch_size"], train_cfg["model"]["n_repeats"]
    n_train = 2 * (len(entries["train"]) // batch)
    n_eval = 2 * (len(entries["eval"]) // batch)
    reset_launches()
    with recorded_training(torch) as rec:
        t0 = time.perf_counter()
        train_cli.main(train_argv)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
    launches = dict(all_launches(), **product_launches())
    files = sorted(os.listdir(ckpt_dir))
    steady = sorted(rec.step_ms[1:])
    ms_step = steady[len(steady) // 2]
    n_mix = rec.mixture_passes * len(CLI_IDS)  # one unmasked forward per eval mixture
    log(f"[cli] cli.train (configs/train_tss.yaml, 2 epochs, logs.metadata.ids {CLI_IDS}): "
        f"{n_train} train + {n_eval} eval steps of {batch} x 3 s and {rec.mixture_passes} passes "
        f"over the eval mixtures in {train_wall:.2f} s; train steps "
        f"{[round(v, 2) for v in rec.step_ms]} ms (median after the first {ms_step:.2f} ms); "
        f"epoch losses {rec.epochs}; checkpoints {files}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    per_train = {"bilstm2_forward_resid": 2 * n, "bilstm2_backward": 2 * n,
                 "products_gemm": 2 * n * 5, "products_colsum": 2 * n}
    per_eval = with_products({"bilstm2_forward": 2 * n})
    expect_launches(launches, {k: n_train * per_train.get(k, 0)
                               + (n_eval + n_mix) * per_eval.get(k, 0) for k in launches}, 1,
                    f"cli.train ({n_train} train steps of {per_train}, {n_eval} eval steps and "
                    f"{n_mix} eval mixtures of {per_eval})")
    if len(rec.step_ms) != n_train or len(rec.epochs) != 4 or \
            not all(math.isfinite(v) for _, v in rec.epochs):
        raise AssertionError(f"cli.train: {len(rec.step_ms)} train steps, epoch losses "
                             f"{rec.epochs}")
    # the reporter's lines: each epoch's train and eval loss, each pass over
    # the eval mixtures (after every new best checkpoint, the first included)
    reported = {kind: sum(m.startswith(f"[{kind}] ") for m in rec.lines.messages)
                for kind in ("train", "eval", "inference_spe")}
    passes = sum(f"[inference_spe] {len(CLI_IDS)} demo mixtures at step" in m
                 for m in rec.lines.messages)
    log(f"[cli] the reporter's lines: {reported}")
    if reported != {"train": 2, "eval": 2, "inference_spe": rec.mixture_passes} or \
            not 1 <= passes == rec.mixture_passes:
        raise AssertionError(f"cli.train's reporter logged {reported} ({passes} passes over "
                             f"{len(CLI_IDS)} mixtures; {rec.mixture_passes} counted)")
    best = [f for f in files if f.endswith("_best")]
    if "2_last" not in files or not best:
        raise AssertionError(f"cli.train wrote {files}: expected 2_last and a *_best")
    best = os.path.join(ckpt_dir, "2_best" if "2_best" in files else best[-1])
    results["train"] = {"wall_s": train_wall, "n_train_steps": n_train, "n_eval_steps": n_eval,
                        "step_ms": rec.step_ms, "ms_per_step": ms_step, "epochs": rec.epochs,
                        "checkpoints": files, "launches": launches, "eval_mixture_ids": CLI_IDS,
                        "eval_mixture_passes": rec.mixture_passes, "reported": reported}

    # -- 4: cli.test on configs/test_tss.yaml as shipped, then si_sdr alone
    test_yaml = os.path.join(cfg_dir, "test_tss.yaml")
    test_sets = [f"data.use_generated_test={manifests['test']}", f"checkpoint_path={best}"]
    test_set = LibrimixSpe(manifest_path=manifests["test"])
    eval_batch, n_buckets = 4, 2
    n_batches = len(BucketedEvalLoader(test_set, eval_batch, make_collate_spe_eval(),
                                       test_set.lengths(), n_buckets=n_buckets))
    n = load_config(test_yaml)["model"]["n_repeats"]
    per_batch = with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n})
    runs = {}
    # each device lane runs twice: its first run pays the lane's one-time
    # set-up (cuFFT plans per bucket length, lazily loaded kernels); its
    # second is the wall a warm process sees
    for tag, sets, flags, reps in (("si_sdr", ["metrics=[si_sdr]"], [], 1), ("triple", [], [], 1),
                                   ("device_metrics", [], ["--device-metrics"], 2),
                                   ("device_pesq", [], ["--device-pesq"], 2)):
        savedir = os.path.join(root, f"metrics_{tag}")
        argv = ["--config", test_yaml, "--mode", "tss_spe", "--batch-size", str(eval_batch),
                "--n-buckets", str(n_buckets), "--set", *test_sets,
                f"test_savedir={savedir}", *sets, *flags, *device_args]
        walls = []
        for _ in range(reps):
            reset_launches()
            counted = dict(host_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = test_cli.main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = dict(all_launches(), **product_launches())
            moved = {k: host_counts[k] - counted[k] for k in counted}
            log(f"[cli] cli.test (configs/test_tss.yaml, {tag}): {len(test_set)} mixtures, "
                f"{n_batches} batches in {walls[-1]:.3f} s; final {final}; estimates to the "
                f"host and metric pools {moved}; launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            expect_launches(launches, per_batch, n_batches, f"cli.test {tag}")
            # the estimate crosses only for a host metric, and the pool starts only then
            want_moved = {"si_sdr": (0, 0), "triple": (n_batches, 1),
                          "device_metrics": (n_batches, 1), "device_pesq": (0, 0)}[tag]
            if (moved["estimates"], moved["pools"]) != want_moved:
                raise AssertionError(f"cli.test {tag}: {moved} estimates to the host and pools, "
                                     f"expected {want_moved}")
        runs[tag] = {"wall_s": walls[-1], "walls_s": walls, "final": final,
                     "launches": launches, "host_counts": moved,
                     "rows": _csv_rows(os.path.join(savedir, "all_metrics.csv"))}
    with open(os.path.join(root, "metrics_triple", "final_metrics.json")) as f:
        saved = json.load(f)
    keys = {f"{m}{s}" for m in ("si_sdr", "stoi", "pesq") for s in ("", "_imp")}
    if set(saved) != keys or not all(v is not None and math.isfinite(v) for v in saved.values()):
        raise AssertionError(f"final_metrics.json: {saved}")

    # the same dataset and checkpoint through InferencerSpe.run, the pool off
    test_cfg = load_config(test_yaml, test_sets + [f"test_savedir={os.path.join(root, 'direct')}"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # from the model's construction on, as the CLI's wall
    inf = InferencerSpe(build_model(model_config(test_cfg)), test_cfg, device=dev)
    inf.run(test_set, batch_size=eval_batch, n_buckets=n_buckets, overlap_metrics=False)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    expect_launches(dict(all_launches(), **product_launches()), per_batch, n_batches,
                    "direct InferencerSpe.run")
    direct_rows = _csv_rows(os.path.join(root, "direct", "all_metrics.csv"))
    worst_direct = _rows_within(runs["triple"]["rows"], direct_rows, CLI_ROW_TOL,
                                "cli.test vs InferencerSpe.run")
    del inf

    # the port's CPU run of the same checkpoint on the shortest mixtures
    m = load_manifest(manifests["test"])
    order = sorted(range(len(m["entries"])), key=lambda i: m["entries"][i]["length"])
    order = order[:CLI_CPU_ROWS]
    cpu_cfg = dict(test_cfg, test_savedir=os.path.join(root, "cpu"))
    t0 = time.perf_counter()
    InferencerSpe(build_model(model_config(cpu_cfg)), cpu_cfg, device="cpu").run(
        LibrimixSpe(manifest=dict(m, entries=[m["entries"][i] for i in order])),
        batch_size=CLI_CPU_ROWS, n_buckets=1)
    cpu_wall = time.perf_counter() - t0
    cpu_rows = _csv_rows(os.path.join(root, "cpu", "all_metrics.csv"))
    for r in cpu_rows:
        r["index"] = str(order[int(r["index"])])
    card_rows = {r["index"]: r for r in runs["triple"]["rows"]}
    worst_cpu = _rows_within([card_rows[r["index"]] for r in cpu_rows], cpu_rows, CPU_ROW_TOL,
                             "card vs CPU host metrics")
    lanes = {tag: _lane_within(runs[tag]["rows"], runs["triple"]["rows"], f"cli.test {tag}")
             for tag in ("device_metrics", "device_pesq")}
    walls = {"si_sdr": runs["si_sdr"]["wall_s"], "triple_pool": runs["triple"]["wall_s"],
             "triple_serial": serial_wall, "device_metrics": runs["device_metrics"]["wall_s"],
             "device_pesq": runs["device_pesq"]["wall_s"],
             "device_metrics_first": runs["device_metrics"]["walls_s"][0],
             "device_pesq_first": runs["device_pesq"]["walls_s"][0]}
    share = {k: (walls[k] - walls["si_sdr"]) / walls[k] for k in walls if k != "si_sdr"}
    log(f"[cli] test CLI wall: si_sdr alone {walls['si_sdr']:.3f} s, the triple with the pool "
        f"{walls['triple_pool']:.3f} s (host metrics {100 * share['triple_pool']:.1f} %), "
        f"serial (direct run) {walls['triple_serial']:.3f} s (host metrics "
        f"{100 * share['triple_serial']:.1f} %), --device-metrics {walls['device_metrics']:.3f} s "
        f"(metrics {100 * share['device_metrics']:.1f} %; first run "
        f"{walls['device_metrics_first']:.3f} s), --device-pesq {walls['device_pesq']:.3f} s "
        f"(metrics {100 * share['device_pesq']:.1f} %; first run "
        f"{walls['device_pesq_first']:.3f} s); rows vs the "
        f"direct run, worst {worst_direct}; card vs CPU on {CLI_CPU_ROWS} mixtures "
        f"({cpu_wall:.1f} s on the CPU), worst {worst_cpu}; the device lanes against the host "
        f"lane {lanes}")
    results["test_tss"] = {"n_mixtures": len(test_set), "n_batches": n_batches,
                           "audio_s": sum(test_set.lengths()) / SAMPLE_RATE, "walls_s": walls,
                           "metric_share": share, "final": runs["triple"]["final"],
                           "final_device_pesq": runs["device_pesq"]["final"],
                           "launches": runs["triple"]["launches"],
                           "host_counts": {k: runs[k]["host_counts"] for k in runs},
                           "worst_vs_direct": worst_direct, "worst_card_vs_cpu": worst_cpu,
                           "device_lanes_vs_host": lanes, "cpu_rows": order}

    # -- 5: cli.test --mode bss on configs/test_bss.yaml as shipped, on the CSV
    bss_yaml = os.path.join(cfg_dir, "test_bss.yaml")
    bss_cfg = load_config(bss_yaml)
    ckpt = os.path.join(root, "bss_random.pt")
    torch.save(init_weights_(build_model(model_config(bss_cfg)),
                             torch.Generator().manual_seed(SEED + 31)).state_dict(), ckpt)
    bss_set = Librimix(csv_path=csvs["test"], segment=None)
    n_bss = len(BucketedEvalLoader(bss_set, eval_batch, collate_bss_eval, bss_set.lengths(),
                                   n_buckets=n_buckets))
    nb = bss_cfg["model"]["n_repeats"]
    bss = {}
    for tag, flags in (("host", []), ("device_pesq", ["--device-pesq"])):
        savedir = os.path.join(root, f"metrics_bss_{tag}")
        reset_launches()
        counted = dict(host_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = test_cli.main(["--config", bss_yaml, "--mode", "bss", "--batch-size",
                               str(eval_batch), "--n-buckets", str(n_buckets), "--set",
                               f"data.test_path={csvs['test']}", f"checkpoint_path={ckpt}",
                               f"test_savedir={savedir}", *flags, *device_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(all_launches(), **product_launches())
        moved = {k: host_counts[k] - counted[k] for k in counted}
        log(f"[cli] cli.test --mode bss (configs/test_bss.yaml, {tag}): {len(bss_set)} mixtures, "
            f"{n_bss} batches in {wall:.3f} s; final {final}; estimates to the host and metric "
            f"pools {moved}; launches { {k: v for k, v in launches.items() if v} }")
        expect_launches(launches, with_products({"bilstm2_forward": nb,
                                                 "bilstm2_forward_masked": nb}),
                        n_bss, f"cli.test --mode bss {tag}")
        if (moved["estimates"], moved["pools"]) != ((n_bss, 1) if tag == "host" else (0, 0)):
            raise AssertionError(f"cli.test --mode bss {tag}: {moved} estimates to the host and "
                                 "pools")
        rows = _csv_rows(os.path.join(savedir, "all_metrics.csv"))
        if len(rows) != len(bss_set) or set(final) != keys or \
                not all(v is not None and math.isfinite(v) for v in final.values()):
            raise AssertionError(f"cli.test --mode bss {tag}: {len(rows)} rows, final {final}")
        bss[tag] = {"wall_s": wall, "n_batches": n_bss, "final": final, "launches": launches,
                    "host_counts": moved, "rows": rows}
    lane = _lane_within(bss["device_pesq"]["rows"], bss["host"]["rows"],
                        "cli.test --mode bss --device-pesq")
    log(f"[cli] cli.test --mode bss: host lane {bss['host']['wall_s']:.3f} s, --device-pesq "
        f"{bss['device_pesq']['wall_s']:.3f} s; the device lane against the host lane {lane}")
    for v in bss.values():
        del v["rows"]
    results["test_bss"] = dict(bss, device_pesq_vs_host=lane)
    # the checkpoints (~90 MB): checked, then removed so that chiprun_out/
    # stays small, but the best one, which phases 17 and 20 read;
    # phases 15, 17 and 20 read the corpus, and phase 20 removes it
    kept = os.path.join(root, "phase13_best", os.path.basename(best))
    os.makedirs(os.path.dirname(kept), exist_ok=True)
    shutil.move(best, kept)
    shutil.rmtree(os.path.join(root, "chkpts"))
    os.remove(ckpt)
    results["manifests"] = manifests
    results["best_checkpoint"] = kept
    return results


def with_env(name, value):
    """Set (or with ``value`` None, clear) an environment variable; returns
    a function that restores it."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value

    def restore():
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
    return restore


def phase_optin_paths(torch, dev, ckpt):
    """Phase 11: InferencerSpe.run under each switch, and a TrainerSpe run
    and one train step under TSS_FUSED_DENSE=1; the switches are restored
    afterwards, whatever happens."""
    restores = [with_env(name, None) for name in SWITCHES]
    try:
        return _optin_paths(torch, dev, ckpt)
    finally:
        for restore in restores:
            restore()


def _optin_paths(torch, dev, ckpt):
    import numpy as np

    from tss_dprnn_tpu_torch.data.loader import (BucketedEvalLoader, TrainLoader, collate_spe,
                                                 make_collate_spe_eval)
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    n = FLAGSHIP["n_repeats"]
    results = {}
    # -- serving: InferencerSpe.run over phase 3's requests under each switch
    ds = Requests(SEED, 12)
    batch_size, n_buckets = 4, 2
    collate = make_collate_spe_eval()
    loader = BucketedEvalLoader(ds, batch_size, collate, ds.lengths(), n_buckets=n_buckets)
    n_batches = len(loader)
    batch = next(iter(loader))  # a bucketed batch with lengths
    audio_s = sum(ds.lengths()) / SAMPLE_RATE
    outs = {}
    for switch, kernel in ((None, None), ("TSS_FUSED_DENSE", "bilstm2_dense_forward"),
                           ("TSS_BM", "bilstm2_forward_bm")):
        restore = with_env(switch, "1") if switch else (lambda: None)
        try:
            savedir = os.path.join(OUT_DIR, f"metrics_{switch or 'default'}")
            inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP),
                                {"checkpoint_path": ckpt, "test_savedir": savedir,
                                 "metrics": ["si_sdr"], "data": {"sample_rate": SAMPLE_RATE}},
                                device=dev)
            with torch.inference_mode():
                outs[switch] = inf.forward(batch).cpu()
            if switch is None:
                continue
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(all_launches(), **product_launches())
        finally:
            restore()
        s = snr_db(outs[switch], outs[None])
        log(f"[optin] {switch}=1: InferencerSpe.run {len(ds)} requests, {n_batches} batches in "
            f"{wall:.3f} s = {audio_s / wall:.2f} audio-s/s; launches "
            f"{ {k: v for k, v in launches.items() if v} }; final {final}; bucketed batch vs "
            f"switch off {s:.2f} dB SNR")
        expect_launches(launches, with_products({kernel: n, "bilstm2_forward_masked": n}),
                        n_batches, f"{switch}=1 serving")
        with open(os.path.join(savedir, "all_metrics.csv")) as f:
            si = [float(r.split(",")[1]) for r in f.read().strip().splitlines()[1:]]
        if len(si) != len(ds) or not all(math.isfinite(v) for v in si):
            raise AssertionError(f"{switch}=1: non-finite or missing si_sdr rows: {si}")
        if not s >= 60.0:
            raise AssertionError(f"{switch}=1 output vs switch off {s:.2f} dB < 60 dB")
        results[switch] = {"launches": launches, "n_batches": n_batches, "audio_s_per_s":
                           audio_s / wall, "final": final, "vs_switch_off_snr_db": s}
        del inf
    torch.cuda.empty_cache()

    # -- the bf16 lane (model.dtype bfloat16) under each switch: its intra
    # scans through the batch-major or the dense entry, each on the
    # bf16-operand products, against the fp32 lane (switch off) and the
    # default bf16 lane on the same bucketed batch
    lengths = torch.from_numpy(batch["lengths"])
    lanes, runs = {}, {}
    for switch, kernel in ((None, None), ("TSS_BM", "bilstm2_forward_bm"),
                           ("TSS_FUSED_DENSE", "bilstm2_dense_forward")):
        restore = with_env(switch, "1") if switch else (lambda: None)
        try:
            savedir = os.path.join(OUT_DIR, f"metrics_bf16_{switch or 'default'}")
            inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP, dtype=torch.bfloat16),
                                {"checkpoint_path": ckpt, "test_savedir": savedir,
                                 "metrics": ["si_sdr"], "data": {"sample_rate": SAMPLE_RATE}},
                                device=dev)
            with torch.inference_mode():
                lanes[switch] = inf.forward(batch).float().cpu()
            if switch is None:
                continue
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
            torch.cuda.synchronize()
            runs[switch] = (kernel, time.perf_counter() - t0, final,
                            dict(all_launches(), **product_launches()))
        finally:
            restore()
        del inf
    for switch, (kernel, wall, final, launches) in runs.items():
        vs_fp32 = _valid_snr(torch, lanes[switch], outs[None], lengths)
        vs_bf16 = _valid_snr(torch, lanes[switch], lanes[None], lengths)
        log(f"[optin] {switch}=1 bf16 lane: InferencerSpe.run {len(ds)} requests, {n_batches} "
            f"batches in {wall:.3f} s = {audio_s / wall:.2f} audio-s/s; launches "
            f"{ {k: v for k, v in launches.items() if v} }; final {final}; bucketed batch vs the "
            f"fp32 lane {vs_fp32:.2f} dB, vs the default bf16 lane {vs_bf16:.2f} dB SNR")
        expect_launches(launches, with_products({kernel: n, "bilstm2_forward_masked": n},
                                                bf16=True), n_batches, f"{switch}=1 bf16 serving")
        if not (vs_fp32 >= LANE_SNR_DB and torch.isfinite(lanes[switch]).all()):
            raise AssertionError(f"{switch}=1 bf16 lane vs the fp32 lane {vs_fp32:.2f} dB < "
                                 f"{LANE_SNR_DB}")
        results[f"{switch}_bf16"] = {"launches": launches, "n_batches": n_batches,
                                     "audio_s_per_s": audio_s / wall, "final": final,
                                     "vs_fp32_lane_snr_db": vs_fp32,
                                     "vs_default_bf16_lane_snr_db": vs_bf16}
    torch.cuda.empty_cache()

    # -- training: one epoch under TSS_FUSED_DENSE=1, then one step on and off
    import shutil

    seed = SEED + 11
    start = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(seed)).state_dict()
    ckpt_dir = os.path.join(OUT_DIR, "optin_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(device=dev, directory=ckpt_dir):
        model = DPRNNSpeTasNet(**FLAGSHIP)
        model.load_state_dict(start, strict=True)
        return TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=directory), device=device)

    restore = with_env("TSS_FUSED_DENSE", "1")
    try:
        tr = trainer()
        train_loader = TrainLoader(Crops(seed, 2 * TRAIN_BATCH), TRAIN_BATCH, collate_spe,
                                   seed=SEED, prefetch=0)
        eval_loader = TrainLoader(Crops(seed + 1, TRAIN_BATCH), TRAIN_BATCH, collate_spe,
                                  shuffle=False, prefetch=0)
        reset_launches()
        tr.run(train_loader, eval_loader, n_epochs=1, early_stop=10)
        torch.cuda.synchronize()
        launches = all_launches()
        del tr
    finally:
        restore()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_train, n_eval = len(train_loader), len(eval_loader)
    per_run = {"bilstm2_forward_resid": 2 * n * n_train, "bilstm2_backward": 2 * n * n_train,
               "bilstm2_dense_forward": 2 * n * n_eval}
    log(f"[optin] TSS_FUSED_DENSE=1: TrainerSpe.run, {n_train} train + {n_eval} eval steps; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    expect_launches(launches, per_run, 1, f"TSS_FUSED_DENSE=1 training ({2 * n} residual + "
                    f"{2 * n} backward per train step, {2 * n} dense per eval step)")
    one = collate_spe(Crops(seed + 2, TRAIN_BATCH).items)
    steps = {}
    for switch in (None, "TSS_FUSED_DENSE"):
        restore = with_env(switch, "1") if switch else (lambda: None)
        try:
            t = trainer(directory=os.path.join(OUT_DIR, "optin_ckpt_unused"))
            t.model.train()
            reset_launches()
            loss, _ = t._forward_loss(t._to_device(one), train=True)
            loss.backward()
            torch.cuda.synchronize()
            steps[switch] = (loss.item(), {k: p.grad.detach().cpu()
                                           for k, p in t.model.named_parameters()},
                             {k: v for k, v in all_launches().items() if v})
            del t
        finally:
            restore()
    shutil.rmtree(os.path.join(OUT_DIR, "optin_ckpt_unused"), ignore_errors=True)
    (loss_on, g_on, l_on), (loss_off, g_off, l_off) = steps["TSS_FUSED_DENSE"], steps[None]
    rel = abs(loss_on - loss_off) / abs(loss_off)
    grad_snr = snr_db(*(torch.cat([g[k].flatten() for k in sorted(g)]) for g in (g_on, g_off)))
    log(f"[optin] one train step TSS_FUSED_DENSE=1 vs off: loss {loss_on:.7f} vs {loss_off:.7f} "
        f"(rel {rel:.2e}), gradients {grad_snr:.2f} dB SNR; launches {l_on} vs {l_off}")
    if l_on != l_off:
        raise AssertionError(f"a train step launched other kernels with the switch: {l_on} vs {l_off}")
    if not (rel <= 1e-5 and grad_snr >= 60.0):
        raise AssertionError(f"TSS_FUSED_DENSE=1 train step vs off: loss rel {rel}, gradient SNR "
                             f"{grad_snr}")
    results["training"] = {"launches": launches, "n_train_steps": n_train, "n_eval_steps": n_eval,
                           "step_loss_rel": rel, "step_grad_snr_db": grad_snr}
    return results


# ------------------------------------------------------------------ phase 14

# the fusions of configs/train_tss.yaml:36 besides 'att', and the cells
FUSIONS = ("add", "cat", "mul", "film")
CELLS = ("GRU", "RNN")
# the device metric lane alone: 8 rows of 10 s at most, ragged, the last one
# too short to score (0.2 s)
LANE_SECONDS = (10.0, 9.3, 8.0, 7.1, 6.0, 5.2, 4.0, 0.2)


class ShortRequests(Requests):
    """Two TSS requests of 1 s and 1.6 s, for card against CPU runs of the
    full-width models."""

    def __init__(self, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.items = []
        for s in (1.0, 1.6):
            target = 0.1 * rng.standard_normal(int(s * SAMPLE_RATE)).astype(np.float32)
            mix = target + 0.1 * rng.standard_normal(target.shape).astype(np.float32)
            ref = 0.1 * rng.standard_normal(int(1.5 * SAMPLE_RATE)).astype(np.float32)
            self.items.append((mix, target, ref, int(rng.integers(0, 251))))


def _valid_snr(torch, got, want, lengths):
    """SNR over every row's valid samples ([B, ..., T] outputs)."""
    cut = [(g[..., :n].flatten(), w[..., :n].flatten())
           for g, w, n in zip(got, want, lengths.tolist())]
    return snr_db(torch.cat([g for g, _ in cut]), torch.cat([w for _, w in cut]))


def _step_card_vs_cpu(torch, dev, make_model, start, trainer_cls, config, batch):
    """One train step from the same weights on the card and on the CPU, under
    the trainer's scan settings (``lstm_save_every``): (loss rel, concatenated
    gradients' SNR, the card's launches, its ms)."""
    steps = {}
    for device in (dev, "cpu"):
        model = make_model()
        model.load_state_dict(start, strict=True)
        t = trainer_cls(model, dict(config, new_checkpoints_path=os.path.join(
            OUT_DIR, "families_ckpt_unused")), device=device)
        t.model.train()
        reset_launches()
        t0 = time.perf_counter()
        on_device = t._to_device(batch)
        with t._scans(train=True):
            loss, _ = t._forward_loss(on_device, train=True)
            loss.backward()
        if device == dev:
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(all_launches(), **product_launches())
        steps[str(device)] = (loss.item(), {k: p.grad.detach().cpu()
                                            for k, p in t.model.named_parameters()
                                            if p.grad is not None})
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = steps[str(dev)], steps["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_snr = snr_db(*(torch.cat([g[k].flatten() for k in sorted(g)]) for g in (g_gpu, g_cpu)))
    return rel, grad_snr, launches, ms


def phase_families(torch, dev):
    """Phase 14: the other fusions and cells at full width, fp32, and the
    device metric lane alone, as the module docstring says."""
    import numpy as np

    from tss_dprnn_tpu_torch import inference, training
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
    from tss_dprnn_tpu_torch.ops import metrics as metrics_mod
    from tss_dprnn_tpu_torch.ops.pesq_device import pesq_batch
    from tss_dprnn_tpu_torch.ops.stoi import stoi_batch
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    results = {}
    n = FLAGSHIP["n_repeats"]
    ds = Requests(SEED, 12)  # phase 3's requests
    batch_size, n_buckets = 4, 2
    n_batches = len(loader.BucketedEvalLoader(ds, batch_size, loader.make_collate_spe_eval(),
                                              ds.lengths(), n_buckets=n_buckets))
    short = ShortRequests(SEED + 40)
    short_batch = next(iter(loader.BucketedEvalLoader(short, 2, loader.make_collate_spe_eval(),
                                                      short.lengths(), n_buckets=1)))
    one = loader.collate_spe(Crops(SEED + 42, 1, 1).items)
    # the 'att' path's launches: phase 3 per serving batch, phase 6 per train step
    per_batch = with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n})
    per_step = {"bilstm2_forward_resid": 2 * n, "bilstm2_backward": 2 * n,
                "products_gemm": 2 * n * 5, "products_colsum": 2 * n}
    for fusion in FUSIONS:
        cfg = dict(FLAGSHIP, fusion_type=fusion)
        start = init_weights_(DPRNNSpeTasNet(**cfg), torch.Generator().manual_seed(SEED + 41))
        ckpt = os.path.join(OUT_DIR, f"family_{fusion}.pt")
        torch.save(start.state_dict(), ckpt)
        config = {"checkpoint_path": ckpt, "metrics": ["si_sdr"],
                  "test_savedir": os.path.join(OUT_DIR, f"family_{fusion}_metrics"),
                  "data": {"sample_rate": SAMPLE_RATE}}
        inf = inference.InferencerSpe(DPRNNSpeTasNet(**cfg), config, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = dict(all_launches(), **product_launches())
        expect_launches(served, per_batch, n_batches, f"'{fusion}' InferencerSpe.run")
        if not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"'{fusion}' served non-finite metrics: {final}")
        inf_cpu = inference.InferencerSpe(DPRNNSpeTasNet(**cfg), config, device="cpu")
        with torch.inference_mode():
            card = inf.forward(short_batch).cpu()
            cpu = inf_cpu.forward(short_batch)
        serve_snr = _valid_snr(torch, card, cpu, short_batch["lengths"])
        del inf, inf_cpu
        rel, grad_snr, stepped, step_ms = _step_card_vs_cpu(
            torch, dev, lambda: DPRNNSpeTasNet(**cfg), start.state_dict(), training.TrainerSpe,
            TRAIN_CONFIG, one)
        expect_launches(stepped, per_step, 1, f"'{fusion}' train step")
        log(f"[families] fusion '{fusion}': InferencerSpe.run over {len(ds)} requests, "
            f"{n_batches} batches in {wall:.3f} s (launches "
            f"{ {k: v for k, v in served.items() if v} }); card vs CPU {serve_snr:.2f} dB on a "
            f"bucketed batch; train step (1 x 1 s) loss rel {rel:.2e}, gradients "
            f"{grad_snr:.2f} dB")
        if not (serve_snr >= 50.0 and rel <= 1e-4 and grad_snr >= 40.0):
            raise AssertionError(f"'{fusion}' card vs CPU: served {serve_snr:.2f} dB, loss rel "
                                 f"{rel}, gradients {grad_snr:.2f} dB")
        results[fusion] = {"serve_wall_s": wall, "serve_launches": served, "final": final,
                           "serve_snr_db": serve_snr, "step_loss_rel": rel,
                           "step_grad_snr_db": grad_snr, "step_launches": stepped}
        os.remove(ckpt)

    mixtures = Mixtures(SEED + 43, 4)  # 2-6 s and one of 10 s
    full = next(iter(loader.BucketedEvalLoader(mixtures, 4, loader.collate_bss_eval,
                                               mixtures.lengths(), n_buckets=1)))
    pair = next(iter(loader.BucketedEvalLoader(Mixtures(SEED + 44, 2, 1.3), 2,
                                               loader.collate_bss_eval, [10400, 10400],
                                               n_buckets=1)))
    crops = loader.collate_bss(Mixtures(SEED + 45, 1, 1.0).items)
    big = loader.collate_bss(Mixtures(SEED + 46, TRAIN_BATCH, TRAIN_SECONDS).items)
    for cell in CELLS:
        cfg = dict(BSS, bidirectional=True, rnn_type=cell)
        start = init_weights_(DPRNNTasNet(**cfg), torch.Generator().manual_seed(SEED + 47))
        ckpt = os.path.join(OUT_DIR, f"family_{cell}.pt")
        torch.save(start.state_dict(), ckpt)
        config = {"checkpoint_path": ckpt, "metrics": ["si_sdr"]}
        outs, serve_ms = {}, None
        for device in (dev, "cpu"):
            inf = inference.Inferencer(DPRNNTasNet(**cfg), config, device=device)
            reset_launches()
            with torch.inference_mode():
                outs[str(device)] = inf.forward(pair).cpu()
                if device == dev:  # a full batch of 4 mixtures up to 10 s, timed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    est = inf.forward(full)
                    torch.cuda.synchronize()
                    serve_ms = (time.perf_counter() - t0) * 1e3
                    served = dict(all_launches(), **product_launches())
                    if not torch.isfinite(est).all():
                        raise AssertionError(f"{cell}: non-finite served batch")
            del inf
        expect_launches(served, {}, 1, f"{cell} serving")
        serve_snr = _valid_snr(torch, outs[str(dev)], outs["cpu"], pair["lengths"])
        rel, grad_snr, stepped, _ = _step_card_vs_cpu(
            torch, dev, lambda: DPRNNTasNet(**cfg), start.state_dict(), training.Trainer,
            BSS_TRAIN_CONFIG, crops)
        expect_launches(stepped, {}, 1, f"{cell} train step")
        # a train step at the shipped batch (5 x 3 s) on the card alone, timed
        model = DPRNNTasNet(**cfg)
        model.load_state_dict(start.state_dict(), strict=True)
        t = training.Trainer(model, dict(BSS_TRAIN_CONFIG, new_checkpoints_path=os.path.join(
            OUT_DIR, "families_ckpt_unused")), device=dev)
        torch.cuda.reset_peak_memory_stats()
        t.train_step(big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(t.train_step(big)[0])
        step_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del t, model
        torch.cuda.empty_cache()
        audio_s = float(full["lengths"].sum()) / SAMPLE_RATE
        log(f"[families] rnn_type {cell} (DPRNN-TasNet, bidirectional, full width): card vs CPU "
            f"{serve_snr:.2f} dB on a bucketed batch; a batch of 4 ({audio_s:.2f} audio-s) in "
            f"{serve_ms:.1f} ms; train step (1 x 1 s) loss rel {rel:.2e}, gradients "
            f"{grad_snr:.2f} dB; {TRAIN_BATCH} x {TRAIN_SECONDS} s step {step_ms:.1f} ms (loss "
            f"{loss:.4f}, peak {peak_gb:.2f} GB); no kernel launched")
        if not (serve_snr >= 50.0 and rel <= 1e-4 and grad_snr >= 40.0 and math.isfinite(loss)):
            raise AssertionError(f"{cell} card vs CPU: served {serve_snr:.2f} dB, loss rel {rel}, "
                                 f"gradients {grad_snr:.2f} dB, step loss {loss}")
        results[cell] = {"serve_snr_db": serve_snr, "serve_ms": serve_ms, "serve_audio_s": audio_s,
                         "step_loss_rel": rel, "step_grad_snr_db": grad_snr,
                         "step_ms_5x3s": step_ms, "step_peak_gb": peak_gb}
        os.remove(ckpt)

    # -- the device metric lane alone: 8 ragged rows, estimate over mixture
    rng = np.random.default_rng(SEED + 48)
    T = int(max(LANE_SECONDS) * SAMPLE_RATE)
    lens = np.array([int(s * SAMPLE_RATE) for s in LANE_SECONDS], np.int32)
    clean, est, mix = (np.zeros((len(lens), T), np.float32) for _ in range(3))
    for b, m in enumerate(lens):
        t = np.arange(m) / SAMPLE_RATE
        f0 = rng.uniform(100, 250)
        x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k for k in range(1, 5))
        clean[b, :m] = 0.3 * x * np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 3) * t), 0, None)
        est[b, :m] = clean[b, :m] + 0.02 * rng.standard_normal(m)
        mix[b, :m] = clean[b, :m] + 0.2 * rng.standard_normal(m)
    # the lane's stacked call: the estimate's rows over the mixture's
    args = [torch.from_numpy(a).to(dev) for a in (np.concatenate([clean, clean]),
                                                    np.concatenate([est, mix]),
                                                    np.concatenate([lens, lens]))]
    lane = {"stoi": lambda: stoi_batch(*args, SAMPLE_RATE),
            "pesq": lambda: pesq_batch(*args, SAMPLE_RATE, "nb")}
    host_fns = {"stoi": lambda c, d: metrics_mod.stoi(c, d, SAMPLE_RATE),
                "pesq": lambda c, d: metrics_mod.pesq_score(c, d, SAMPLE_RATE)}
    deg = np.concatenate([est, mix])
    lens2 = np.concatenate([lens, lens])
    metric_lane = {}
    for name in ("stoi", "pesq"):
        ms = time_ms(lane[name], 5)
        card = lane[name]().cpu().numpy()
        t0 = time.perf_counter()
        host = np.array([np.nan if v is None else v for v in (
            host_fns[name](np.concatenate([clean, clean])[b, :m], deg[b, :m])
            for b, m in enumerate(lens2))], np.float64)
        host_ms = (time.perf_counter() - t0) * 1e3
        ok = ~np.isnan(host)
        if not np.array_equal(np.isnan(card), np.isnan(host)):
            raise AssertionError(f"{name}: NaN rows differ, card {card}, host {host}")
        err = np.abs(card[ok] - host[ok])
        bar, median_bar = LANE_TOL[name]
        log(f"[families] device metric lane, {name}: {2 * len(lens)} rows ({len(lens)} x "
            f"{max(LANE_SECONDS)} s at most, stacked) {ms:.2f} ms per batch on the card against "
            f"{host_ms:.1f} ms on "
            f"the host (float64, serial); |card - host| max {err.max():.2e}, median "
            f"{float(np.median(err)):.2e}")
        if not (err.max() <= bar and np.median(err) <= median_bar):
            raise AssertionError(f"{name} on the card off the host by {err}")
        metric_lane[name] = {"ms": ms, "host_ms": host_ms, "max_abs_err_vs_host": float(err.max()),
                             "median_abs_err_vs_host": float(np.median(err)),
                             "rows": 2 * len(lens)}
    results["metric_lane"] = metric_lane
    import shutil

    shutil.rmtree(os.path.join(OUT_DIR, "families_ckpt_unused"), ignore_errors=True)
    return results


# the last two families at full width: DPRNN-Spe-IRA-TasNet at the flagship's
# widths, and DPRNN-RawNet-TasNet at its defaults (RawNet3 C 1024, scale 8,
# sinc stride 10, 16 kHz references, E 256) over the flagship core
IRA = dict(FLAGSHIP)
RAWNET = dict(FLAGSHIP, embeddings_size=256)


def serving_batch8(torch, collate, n: int = 8):
    """chip_profile.py's serving batch: 8 ragged requests of up to 10 s
    from SEED (or ``n``: bench_serve's 32), collated by ``collate``, with its
    audio-seconds."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    T = 10 * SAMPLE_RATE
    lengths = [T] + [int(n) for n in rng.integers(T // 2, T + 1, n - 1)]
    items = [(0.1 * rng.standard_normal(n).astype(np.float32),) * 2
             + (0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE))
                .astype(np.float32), 0) for n in lengths]
    batch = collate(items, T)
    batch["lengths"] = np.asarray(lengths, np.int32)
    return batch, sum(lengths) / SAMPLE_RATE


def ira_rawnet_family(name: str):
    """What phase 15 drives for a model: its constructor, inferencer,
    trainer, collates and the kernel launches it makes (n blocks of an
    intra and an inter scan per pass). An IRA train step checkpoints its 6
    pass-1 blocks: each runs its two residual forwards again in the
    backward."""
    import functools

    from tss_dprnn_tpu_torch import inference, training
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNRawNetTasNet, DPRNNSpeIRATasNet

    n = FLAGSHIP["n_repeats"]
    if name.startswith("ira"):
        k = 3 if name == "ira_share3" else 0
        blocks = 2 * n - k  # pass 1 and pass 2's blocks k..n-1
        resid = {"bilstm2_forward_resid": 2 * blocks + 2 * n, "bilstm2_backward": 2 * blocks}
        return dict(model=lambda **kw: DPRNNSpeIRATasNet(**IRA, share_blocks=k, **kw),
                    inferencer=inference.InferencerSpe, trainer=training.TrainerSpe,
                    collate=loader.collate_spe, eval_collate=loader.make_collate_spe_eval(),
                    per_batch=with_products({"bilstm2_forward": blocks,
                                             "bilstm2_forward_masked": blocks}),
                    per_eval_step=with_products({"bilstm2_forward": 2 * blocks}),
                    per_step=dict(resid, products_gemm=resid["bilstm2_forward_resid"]
                                  + 4 * resid["bilstm2_backward"],
                                  products_colsum=resid["bilstm2_backward"]),
                    per_step_no_remat={"bilstm2_forward_resid": 2 * blocks,
                                       "bilstm2_backward": 2 * blocks,
                                       "products_gemm": 2 * blocks * 5,
                                       "products_colsum": 2 * blocks},
                    target="dprnn_spe_ira_tasnet", mode="tss_spe", sets=[])
    return dict(model=lambda **kw: DPRNNRawNetTasNet(**RAWNET, **kw),
                inferencer=inference.InferencerRawNet, trainer=training.TrainerRawNet,
                collate=functools.partial(loader.collate_spe, resample_ref_to=16000),
                eval_collate=loader.make_collate_spe_eval(16000, SAMPLE_RATE),
                per_batch=with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n}),
                per_eval_step=with_products({"bilstm2_forward": 2 * n}),
                per_step={"bilstm2_forward_resid": 2 * n, "bilstm2_backward": 2 * n,
                          "products_gemm": 2 * n * 5, "products_colsum": 2 * n},
                target="dprnn_rawnet_tasnet", mode="tss_rawnet",
                sets=["model.embeddings_size=256"])


def _alone(torch, inf, item, resample_to):
    """The request at its exact shape, no lengths: its estimate on the CPU."""
    import numpy as np

    from tss_dprnn_tpu_torch.data.resample import resample

    mix, _, ref, _ = item
    if resample_to:
        ref = resample(ref, SAMPLE_RATE, resample_to)
    ref = torch.from_numpy(np.ascontiguousarray(ref)).to(inf.device)[None]
    ref_len = torch.tensor([float(ref.shape[1])], device=inf.device)
    return inf.model(torch.from_numpy(mix).to(inf.device)[None], ref, ref_len)[0].cpu()


def _timed_step(torch, dev, fam, start, batch, **kw):
    """A 5 x 3 s train step on the card from ``start``: the first step's
    loss, gradients (on the host) and launches, the second step's ms, and
    the peak memory over both."""
    model = fam["model"](**kw)
    model.load_state_dict(start, strict=True)
    t = fam["trainer"](model, dict(TRAIN_CONFIG, new_checkpoints_path=os.path.join(
        OUT_DIR, "ira_rawnet_ckpt_unused")), device=dev)
    t.model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, _ = t._forward_loss(t._to_device(batch), train=True)
    loss.backward()
    launches = dict(all_launches(), **product_launches())
    grads = torch.cat([p.grad.detach().flatten() for _, p in sorted(t.model.named_parameters())
                       if p.grad is not None]).cpu()
    loss = loss.detach().cpu()
    t.optimizer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_loss = float(t.train_step(batch)[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del t, model
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads, "launches": launches, "ms": ms, "peak_gb": peak_gb,
            "second_step_loss": step_loss}


def phase_ira_rawnet(torch, dev, smi, manifests):
    """Phase 15: DPRNN-Spe-IRA-TasNet and DPRNN-RawNet-TasNet at full width,
    fp32, served and trained directly and through the CLIs, as the module
    docstring says."""
    import shutil

    import numpy as np

    from tss_dprnn_tpu_torch.cli import test as test_cli, train as train_cli
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.data.librimix import LibrimixSpe
    from tss_dprnn_tpu_torch.utils.config import load_config
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    results = {}
    ds = Requests(SEED, 12)  # phase 3's requests
    batch_size, n_buckets = 4, 2
    n_batches = len(loader.BucketedEvalLoader(ds, batch_size, loader.make_collate_spe_eval(),
                                              ds.lengths(), n_buckets=n_buckets))
    short = ShortRequests(SEED + 40)
    # the flagship on the same batch of 8, the yardstick of this run
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    ckpt = os.path.join(OUT_DIR, "flagship_batch8.pt")
    torch.save(init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(SEED))
               .state_dict(), ckpt)
    inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), {"checkpoint_path": ckpt}, device=dev)
    batch8, audio8 = serving_batch8(torch, loader.make_collate_spe_eval())
    with torch.inference_mode():
        inf.forward(batch8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            inf.forward(batch8)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / 3
    del inf
    os.remove(ckpt)
    results["flagship"] = {"batch8_forward_ms": fwd_s * 1e3,
                           "audio_s_per_s_batch8": audio8 / fwd_s}
    log(f"[ira-rawnet] flagship: batch of 8 ({audio8:.2f} audio-s) {fwd_s * 1e3:.1f} ms = "
        f"{audio8 / fwd_s:.2f} audio-s/s on {smi}")
    for name in ("ira", "ira_share3", "rawnet"):
        fam = ira_rawnet_family(name)
        start = init_weights_(fam["model"](), torch.Generator().manual_seed(SEED + 50))
        start = start.state_dict()
        ckpt = os.path.join(OUT_DIR, f"{name}.pt")
        torch.save(start, ckpt)
        config = {"checkpoint_path": ckpt, "metrics": ["si_sdr"],
                  "test_savedir": os.path.join(OUT_DIR, f"{name}_metrics"),
                  "data": {"sample_rate": SAMPLE_RATE}}
        res = {}
        # -- served over phase 3's requests, then the batch of 8 timed
        inf = fam["inferencer"](fam["model"](), config, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = dict(all_launches(), **product_launches())
        expect_launches(served, fam["per_batch"], n_batches, f"{name} {type(inf).__name__}.run")
        if not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"{name} served non-finite metrics: {final}")
        batch8, audio8 = serving_batch8(torch, fam["eval_collate"])
        with torch.inference_mode():
            inf.forward(batch8)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                est = inf.forward(batch8)
            torch.cuda.synchronize()
            fwd_s = (time.perf_counter() - t0) / 3
            serve_peak = torch.cuda.max_memory_allocated() / 1e9
            if not torch.isfinite(est).all():
                raise AssertionError(f"{name}: non-finite estimates at batch 8")
        res.update(serve_wall_s=wall, serve_launches=served, final=final,
                   batch8_audio_s=audio8, batch8_forward_ms=fwd_s * 1e3,
                   audio_s_per_s_batch8=audio8 / fwd_s, serve_peak_gb=serve_peak)
        # -- card vs CPU on a bucketed batch, and a bucketed row vs the request alone
        short_batch = fam["eval_collate"](short.items, max(short.lengths()))
        short_batch["lengths"] = np.asarray(short.lengths(), np.int32)
        inf_cpu = fam["inferencer"](fam["model"](), config, device="cpu")
        resample_to = getattr(inf, "resample_ref_to", None)
        with torch.inference_mode():
            card = inf.forward(short_batch).cpu()
            cpu = inf_cpu.forward(short_batch)
            alone = _alone(torch, inf, short.items[0], resample_to)
        serve_snr = _valid_snr(torch, card, cpu, short_batch["lengths"])
        n0 = short.lengths()[0]
        err_bucket = float((card[0, :n0] - alone).abs().max())
        del inf, inf_cpu
        torch.cuda.empty_cache()
        log(f"[ira-rawnet] {name}: {fam['inferencer'].__name__}.run over {len(ds)} requests, "
            f"{n_batches} batches in {wall:.3f} s (launches "
            f"{ {k: v for k, v in served.items() if v} }); batch of 8 ({audio8:.2f} audio-s) "
            f"{fwd_s * 1e3:.1f} ms = {audio8 / fwd_s:.2f} audio-s/s, peak {serve_peak:.2f} GB "
            f"on {smi}; card vs CPU {serve_snr:.2f} dB on a bucketed batch; bucketed row vs "
            f"alone max|err| {err_bucket:.3e}")
        if not serve_snr >= 50.0:
            raise AssertionError(f"{name} card vs CPU {serve_snr:.2f} dB < 50 dB")
        if not torch.allclose(card[0, :n0], alone, atol=2e-4, rtol=1e-4):
            raise AssertionError(f"{name}: bucketed row differs from the request alone: "
                                 f"{err_bucket}")
        res.update(serve_snr_db=serve_snr, bucketed_vs_alone_max_err=err_bucket)
        if name == "ira_share3":  # serving only: its training is IRA's with fewer blocks
            results[name] = res
            os.remove(ckpt)
            continue
        # -- one train step card vs CPU at 1 x 1 s
        one = fam["collate"](Crops(SEED + 42, 1, 1).items)
        rel, grad_snr, stepped, _ = _step_card_vs_cpu(
            torch, dev, fam["model"], start, fam["trainer"], TRAIN_CONFIG, one)
        expect_launches(stepped, fam["per_step"], 1, f"{name} train step")
        log(f"[ira-rawnet] {name}: train step (1 x 1 s) card vs CPU loss rel {rel:.2e}, "
            f"gradients {grad_snr:.2f} dB")
        if not (rel <= 1e-4 and grad_snr >= 40.0):
            raise AssertionError(f"{name} card vs CPU train step: loss rel {rel}, gradients "
                                 f"{grad_snr:.2f} dB")
        res.update(step_loss_rel=rel, step_grad_snr_db=grad_snr, step_launches=stepped)
        # -- 5 x 3 s steps timed (IRA with and without checkpointing pass 1)
        big = fam["collate"](Crops(SEED + 51, TRAIN_BATCH, TRAIN_SECONDS).items)
        runs = {"default": _timed_step(torch, dev, fam, start, big)}
        if name == "ira":
            runs["pass1_remat_0"] = _timed_step(torch, dev, fam, start, big, pass1_remat=0)
            expect_launches(runs["pass1_remat_0"]["launches"], fam["per_step_no_remat"], 1,
                            "ira 5 x 3 s step, pass 1 not checkpointed")
        expect_launches(runs["default"]["launches"], fam["per_step"], 1,
                        f"{name} 5 x 3 s step")
        for tag, r in runs.items():
            log(f"[ira-rawnet] {name} {tag}: {TRAIN_BATCH} x {TRAIN_SECONDS} s train step "
                f"{r['ms']:.1f} ms, peak {r['peak_gb']:.2f} GB on {smi}; loss "
                f"{float(r['loss']):.6f}; launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }")
            if not (math.isfinite(float(r["loss"])) and math.isfinite(r["second_step_loss"])):
                raise AssertionError(f"{name} {tag}: non-finite loss")
        if name == "ira":
            a, b = runs["default"], runs["pass1_remat_0"]
            g_err = float((a["grads"] - b["grads"]).abs().max() / b["grads"].abs().max())
            log(f"[ira-rawnet] ira with vs without pass-1 checkpointing: losses "
                f"{float(a['loss'])!r} / {float(b['loss'])!r}, gradients max|diff| "
                f"{g_err:.3e} of max|grad|")
            if not (torch.equal(a["loss"], b["loss"]) and g_err <= 1e-6):
                raise AssertionError(f"ira pass1_remat None vs 0: loss {a['loss']} vs "
                                     f"{b['loss']}, gradients {g_err}")
            res["remat_grad_max_rel_diff"] = g_err
        res["steps_5x3s"] = {tag: {k: v for k, v in r.items() if k not in ("grads", "loss")}
                             | {"loss": float(r["loss"])} for tag, r in runs.items()}
        results[name] = res
        os.remove(ckpt)

    # -- a share_blocks=3 checkpoint refused under share_blocks=0
    fam = ira_rawnet_family("ira_share3")
    model = init_weights_(fam["model"](), torch.Generator().manual_seed(SEED + 52))
    tr = fam["trainer"](model, dict(TRAIN_CONFIG, new_checkpoints_path=os.path.join(
        OUT_DIR, "ira_share3_ckpt")), device=dev)
    share3 = tr._save_checkpoint(best=False)
    del tr, model

    # -- both through the CLIs on phase 13's corpus
    root = os.path.join(OUT_DIR, "cli")
    test_yaml = os.path.join(HERE, "configs", "test_tss.yaml")
    test_set = LibrimixSpe(manifest_path=manifests["test"])
    eval_batch = 4
    n_test = len(loader.BucketedEvalLoader(test_set, eval_batch, loader.make_collate_spe_eval(),
                                           test_set.lengths(), n_buckets=n_buckets))
    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    cli = {}
    for name in ("ira", "rawnet"):
        fam = ira_rawnet_family(name)
        ckpt_dir = os.path.join(root, f"{name}_chkpts")
        argv = ["--config", os.path.join(HERE, "configs", "train_tss.yaml"), "--mode",
                fam["mode"], "--set", f"data.use_generated_train={manifests['train']}",
                f"data.use_generated_eval={manifests['eval']}", "epochs=1",
                f"logs.metadata.ids=[{', '.join(map(str, CLI_IDS))}]",
                f"model.target={fam['target']}", *fam["sets"],
                f"new_checkpoints_path={ckpt_dir}", *device_args]
        batch = load_config(argv[1])["data"]["batch_size"]
        n_train = len(LibrimixSpe(manifest_path=manifests["train"])) // batch
        n_eval = len(LibrimixSpe(manifest_path=manifests["eval"])) // batch
        reset_launches()
        with recorded_training(torch) as rec:
            t0 = time.perf_counter()
            train_cli.main(argv)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
        launches = dict(all_launches(), **product_launches())
        n_mix = rec.mixture_passes * len(CLI_IDS)
        expect_launches(launches, {k: n_train * fam["per_step"].get(k, 0)
                                   + (n_eval + n_mix) * fam["per_eval_step"].get(k, 0)
                                   for k in launches}, 1,
                        f"{name} cli.train ({n_train} train steps, {n_eval} eval steps, "
                        f"{n_mix} eval mixtures)")
        files = sorted(os.listdir(ckpt_dir))
        if "1_best" not in files or len(rec.epochs) != 2 or \
                not all(math.isfinite(v) for _, v in rec.epochs) or rec.mixture_passes != 1:
            raise AssertionError(f"{name} cli.train: {files}, epochs {rec.epochs}, "
                                 f"{rec.mixture_passes} passes over the eval mixtures")
        steady = sorted(rec.step_ms[1:])
        savedir = os.path.join(root, f"metrics_{name}")
        reset_launches()
        t0 = time.perf_counter()
        final = test_cli.main(["--config", test_yaml, "--mode", fam["mode"], "--batch-size",
                               str(eval_batch), "--n-buckets", str(n_buckets), "--set",
                               f"data.use_generated_test={manifests['test']}",
                               f"checkpoint_path={os.path.join(ckpt_dir, '1_best')}",
                               f"model.target={fam['target']}", *fam["sets"],
                               f"test_savedir={savedir}", *device_args])
        torch.cuda.synchronize()
        test_wall = time.perf_counter() - t0
        tested = dict(all_launches(), **product_launches())
        expect_launches(tested, fam["per_batch"], n_test, f"{name} cli.test")
        with open(os.path.join(savedir, "final_metrics.json")) as f:
            saved = json.load(f)
        keys = {f"{m}{s}" for m in ("si_sdr", "stoi", "pesq") for s in ("", "_imp")}
        if set(saved) != keys or not all(v is not None and math.isfinite(v)
                                         for v in saved.values()):
            raise AssertionError(f"{name} cli.test final_metrics.json: {saved}")
        log(f"[ira-rawnet] {name} cli.train (configs/train_tss.yaml, --mode {fam['mode']}, "
            f"model.target={fam['target']}, 1 epoch): {n_train} train + {n_eval} eval steps "
            f"and {rec.mixture_passes} pass over {len(CLI_IDS)} eval mixtures in "
            f"{train_wall:.2f} s, train steps {[round(v, 1) for v in rec.step_ms]} ms; "
            f"epoch losses {rec.epochs}; cli.test (configs/test_tss.yaml, si_sdr stoi pesq) "
            f"{len(test_set)} mixtures in {n_test} batches, {test_wall:.3f} s: {final}")
        cli[name] = {"train_wall_s": train_wall, "step_ms": rec.step_ms,
                     "ms_per_step": steady[len(steady) // 2], "epochs": rec.epochs,
                     "train_launches": launches, "test_wall_s": test_wall, "final": final,
                     "test_launches": tested}
        shutil.rmtree(ckpt_dir)
    # the share_blocks=3 checkpoint through cli.test with the default share_blocks=0
    try:
        test_cli.main(["--config", test_yaml, "--mode", "tss_spe", "--set",
                       f"data.use_generated_test={manifests['test']}",
                       f"checkpoint_path={share3}", "model.target=dprnn_spe_ira_tasnet",
                       f"test_savedir={os.path.join(root, 'metrics_share3')}", *device_args])
    except ValueError as exc:
        if "share_blocks=3" not in str(exc):
            raise
        log(f"[ira-rawnet] a share_blocks=3 checkpoint under share_blocks=0: refused ({exc})")
        cli["share_blocks_refused"] = str(exc)
    else:
        raise AssertionError("cli.test loaded a share_blocks=3 checkpoint under share_blocks=0")
    results["cli"] = cli
    # the rest: checked, then removed so that chiprun_out/ stays small (phases
    # 17 and 20 read the corpus, and phase 20 removes it)
    for path in (os.path.dirname(share3),
                 os.path.join(OUT_DIR, "ira_rawnet_ckpt_unused"),
                 os.path.join(OUT_DIR, "families_ckpt_unused")):
        shutil.rmtree(path, ignore_errors=True)
    return results


# variable-length training (phase 16): a corpus of whole utterances, rows
# capped at VARLEN_MAX_SEGMENT s (5 x 5 s is the largest bucket: the masked
# residual forward saves pre and six streams per scan, ~56 GB scaled from the
# 5 x 3 s step's 33.76 GB), cut into VARLEN_BUCKETS length buckets
VARLEN_SPLITS = {"train": (20, (2.0, 8.0)), "eval": (10, (2.0, 8.0))}
VARLEN_MAX_SEGMENT = 5
VARLEN_BUCKETS = 4
VARLEN_IDS = [0, 3]
SAVE_EVERY = 10
# the training configs without clipping or decay, so that .grad after a
# train step is the backward's own (phase 16's gradient comparisons)
RAW_GRADS = {"clip_norm": 0, "optimizer": {"lr": 5e-4, "weight_decay": 0.0}}


def varlen_launches(mode: str, n: int, bf16: bool = False):
    """Per train step, eval step and eval mixture of a variable-length run:
    the TSS families' intra scans through the unmasked training pair and
    their inter scans through the masked one; the causal BSS model's intra
    pair unmasked and its one-direction inter scans, which take no lengths.
    ``bf16``: the TSS families in the bf16 lane, whose training modes take
    the bf16 products (BF16_TRAIN_PRODUCTS)."""
    if bf16:
        if mode == "bss":
            raise ValueError("the bf16 variable-length run is the TSS families'")
        return (with_products({"bilstm2_forward_resid": n, "bilstm2_forward_resid_masked": n,
                               "bilstm2_backward": n, "bilstm2_backward_masked": n}, bf16=True),
                with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n}),
                with_products({"bilstm2_forward": 2 * n}))
    if mode == "bss":
        train = {"bilstm2_forward_resid": n, "bilstm2_backward": n, "lstm_forward_resid": n,
                 "lstm_backward": n, "products_gemm": n * 5 + n * 1 + n * 3,
                 "products_colsum": 2 * n}
        serve = with_products({"bilstm2_forward": n, "lstm_forward": n})
        return train, serve, serve
    train = {"bilstm2_forward_resid": n, "bilstm2_forward_resid_masked": n,
             "bilstm2_backward": n, "bilstm2_backward_masked": n, "products_gemm": 2 * n * 5,
             "products_colsum": 2 * n}
    return (train, with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n}),
            with_products({"bilstm2_forward": 2 * n}))


def _grad_snr(torch, got, want):
    return snr_db(*(torch.cat([g[k].flatten() for k in sorted(want)]) for g in (got, want)))


def _whole_step(torch, dev, make_model, start, trainer_cls, config, batch):
    """One whole train_step on the card from ``start``: its loss, launches,
    gradients and BatchNorm buffers (on the host; ``config`` without
    clipping or decay leaves .grad as the backward made it); then the ms of
    a second step (the first pays the trainer's set-up) and the peak GB of
    both."""
    model = make_model()
    model.load_state_dict(start, strict=True)
    t = trainer_cls(model, dict(config, new_checkpoints_path=os.path.join(
        OUT_DIR, "varlen_ckpt_unused")), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = float(t.train_step(batch)[0])
    out = {"loss": loss, "launches": dict(all_launches(), **product_launches()),
           "grads": {k: p.grad.detach().cpu() for k, p in t.model.named_parameters()
                     if p.grad is not None},
           "buffers": {k: v.to("cpu", copy=True) for k, v in t.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_step(batch)
    torch.cuda.synchronize()
    out.update(ms=(time.perf_counter() - t0) * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del t, model
    torch.cuda.empty_cache()
    return out


def _numbers(step):
    """A step's record: loss, ms, peak GB and the kernels it launched."""
    return dict({k: step[k] for k in ("loss", "ms", "peak_gb")},
                launches={k: v for k, v in step["launches"].items() if v})


def _varlen_kernels(torch, dev, bucket_T, lengths):
    """Phase 16 (g): the masked training pair at the largest bucket's inter
    shape (R = 5 K rows over its S chunks, each row's chunk count from the
    bucket's lengths) and the want_cs forward at D = 2 over its intra shape
    (R = 5 S, T = K), against their plain versions, timed beside them, the
    bound and cuDNN (the pair; two directions on their own inputs are no
    single cuDNN call)."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2, lstm as L

    F = H = 128
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    S = (bucket_T - 1 + K) // hop + 1
    chunks = (lengths.long() - 1 + K) // hop + 1
    g = torch.Generator(device="cpu").manual_seed(SEED + 60)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    w = (w_ih2, b2, w_hh2)
    R, T = len(lengths) * K, S
    lens = chunks.repeat_interleave(K).int().to(dev)
    x = torch.randn(R, T, F, generator=g).to(dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    g0, g1 = (torch.randn(R, T, H, generator=g).to(dev) for _ in range(2))
    g0 = g0 * valid[..., None]  # out0 past a row's length is unspecified: consumers mask it
    rows_steps = int(lens.sum())
    (o0, o1), resid = B2.bilstm2_forward_resid_masked(x, lens, *w)
    (p0, p1), presid = B2.bilstm2_resid_reference(x, *w, lens)
    fwd_err = max(float((o1 - p1).abs().max()), float((o0 - p0)[valid].abs().max()),
                  *(float((a - b)[valid].abs().max()) for a, b in zip(resid, presid)))
    got = B2.bilstm2_backward_masked(x, resid, g0, g1, *w, lens)
    want = B2.bilstm2_backward_reference(x, resid, g0, g1, *w, lens)
    dx_err = float((got[0] - want[0]).abs().max())
    dw_err = max(float((a - b).abs().max()) for a, b in zip(got[1:], want[1:]))
    dw_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(got[1:], want[1:]))
    del presid, got, want
    if not (fwd_err <= 1e-4 and dx_err <= 1e-4 and dw_rel <= DW_REL_TOL):
        raise AssertionError(f"varlen masked pair at R={R} T={T}: resid {fwd_err}, dx {dx_err}, "
                             f"dW/db {dw_rel}")
    lstm = cudnn_lstm(torch, w_ih2, b2, w_hh2, torch.float32)
    xr = x.detach().clone().requires_grad_()
    params = [xr, *lstm.parameters()]
    pack, unpack = torch.nn.utils.rnn.pack_padded_sequence, torch.nn.utils.rnn.pad_packed_sequence
    lens_cpu = lens.cpu()

    def library_fwd():
        packed = pack(xr, lens_cpu, batch_first=True, enforce_sorted=False)
        return unpack(lstm(packed)[0], batch_first=True, total_length=T)[0]

    out = library_fwd()
    cot = torch.cat([g0, g1], dim=-1)
    masked = {
        "fwd_ms": time_ms(lambda: B2.bilstm2_forward_resid_masked(x, lens, *w), 5),
        "fwd_plain_ms": time_ms(lambda: B2.bilstm2_resid_reference(x, *w, lens), 1),
        "bwd_ms": time_ms(lambda: B2.bilstm2_backward_masked(x, resid, g0, g1, *w, lens), 5),
        "bwd_plain_ms": time_ms(lambda: B2.bilstm2_backward_reference(x, resid, g0, g1, *w,
                                                                      lens), 1),
        "cudnn_fwd_ms": time_ms(library_fwd, 3),
        "cudnn_bwd_ms": time_ms(lambda: torch.autograd.grad(out, params, cot,
                                                            retain_graph=True), 3)}
    masked["fwd_bound_ms"], masked["fwd_bound_by"] = bound_resid(rows_steps, R, T, F, H)
    masked["bwd_bound_ms"], masked["bwd_bound_by"] = bound_backward(rows_steps, R, T, F, H)
    masked.update(R=R, T=T, rows_steps=rows_steps, resid_max_abs_err=fwd_err,
                  dx_max_abs_err=dx_err, dw_max_abs_err=dw_err, dw_rel_err=dw_rel)
    del x, g0, g1, resid, lstm, xr, params, out, cot, o0, o1, p0, p1
    torch.cuda.empty_cache()

    D, Rc = 2, len(lengths) * S
    xs = torch.randn(D, Rc, K, F, generator=g).to(dev)
    h, cs = L.lstm_forward_with_cs(xs, *w)
    h2, cs2 = L.lstm_forward_with_cs(xs, *w)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(h, h2) and torch.equal(cs, cs2))
    is_forward = bool(torch.equal(h, L.lstm_forward(xs, *w)))  # the same product and arithmetic
    del h2, cs2
    ph, pcs = L.lstm_cs_reference(xs, *w)
    cs_err = max(float((h - ph).abs().max()), float((cs - pcs).abs().max()))
    if not (cs_err <= 1e-4 and repeat and is_forward):
        raise AssertionError(f"lstm_forward_with_cs at D=2 R={Rc} T={K}: max|err| {cs_err}, "
                             f"repeats bit for bit {repeat}, h bit for bit lstm_forward's "
                             f"{is_forward}")
    with_cs = {"ms": time_ms(lambda: L.lstm_forward_with_cs(xs, *w), 5),
               "plain_ms": time_ms(lambda: L.lstm_cs_reference(xs, *w), 1),
               "D": D, "R": Rc, "T": K, "max_abs_err": cs_err, "bitwise_repeat": repeat,
               "h_is_lstm_forward": is_forward,
               "tile_plan": scan_plan("serve", D, Rc, H, xs.device, torch.float32)}
    with_cs["bound_ms"], with_cs["bound_by"] = bound_stack("with_cs", D, Rc, K, F, H)
    del xs, h, cs, ph, pcs
    torch.cuda.empty_cache()
    log(f"[varlen] masked pair at the largest bucket's inter shape R={R} T={T} "
        f"({rows_steps} row-steps): resid fwd {masked['fwd_ms']:.3f} ms (plain "
        f"{masked['fwd_plain_ms']:.1f}, bound {masked['fwd_bound_ms']:.3f}, cuDNN "
        f"{masked['cudnn_fwd_ms']:.3f}; max|err| {fwd_err:.3e}); backward "
        f"{masked['bwd_ms']:.3f} ms (plain {masked['bwd_plain_ms']:.1f}, bound "
        f"{masked['bwd_bound_ms']:.3f}, cuDNN {masked['cudnn_bwd_ms']:.3f}; dx max|err| "
        f"{dx_err:.3e}, dW/db /max|ref| {dw_rel:.3e}); want_cs D=2 R={Rc} T={K} "
        f"{with_cs['ms']:.3f} ms (plain {with_cs['plain_ms']:.1f}, bound "
        f"{with_cs['bound_ms']:.3f}; max|err| {cs_err:.3e}, repeats bit for bit, h bit for bit "
        f"lstm_forward's; input products + the serving scan's cell-state mode, tile plan "
        f"{with_cs['tile_plan']})")
    return {"masked": masked, "with_cs": with_cs}


def _varlen_cli(torch, dev, root, manifests, mode, config, extra, bf16=False):
    """One epoch of ``cli.train --mode mode`` with data.variable_length on
    phase 16's corpus (``extra``: more --set items), its launches held to
    varlen_launches per train step, eval step and eval mixture: its wall,
    train ms per step by bucket width, peak GB, epochs and launches."""
    import shutil

    from tss_dprnn_tpu_torch.cli import train as train_cli

    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    lane = " bf16" if bf16 else ""
    ckpt_dir = os.path.join(root, f"chkpts_{mode}{lane.strip()}")
    argv = ["--config", os.path.join(HERE, "configs", config), "--mode", mode, "--set",
            f"data.use_generated_train={manifests['train']}",
            f"data.use_generated_eval={manifests['eval']}", "epochs=1",
            "data.variable_length=true", f"data.max_segment={VARLEN_MAX_SEGMENT}",
            f"data.n_buckets={VARLEN_BUCKETS}",
            f"logs.metadata.ids=[{', '.join(map(str, VARLEN_IDS))}]",
            f"new_checkpoints_path={ckpt_dir}", *extra, *device_args]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_training(torch) as rec:
        t0 = time.perf_counter()
        train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counted = dict(all_launches(), **product_launches())
    launches = {k: v for k, v in counted.items() if v}
    per_train, per_eval, per_mix = varlen_launches(mode, FLAGSHIP["n_repeats"], bf16)
    n_train, n_mix = len(rec.step_ms), rec.mixture_passes * len(VARLEN_IDS)
    want = {k: n_train * per_train.get(k, 0) + rec.eval_steps * per_eval.get(k, 0)
            + n_mix * per_mix.get(k, 0) for k in {*per_train, *per_eval, *per_mix}}
    expect_launches(counted, want, 1,
                    f"cli.train --mode {mode}{lane} variable-length ({n_train} train steps of "
                    f"{per_train}, {rec.eval_steps} eval steps of {per_eval}, {n_mix} eval "
                    f"mixtures of {per_mix})")
    files = sorted(os.listdir(ckpt_dir))
    by_bucket = {}
    for width, ms in zip(rec.widths, rec.step_ms):
        by_bucket.setdefault(width, []).append(round(ms, 2))
    log(f"[{'bf16' if bf16 else 'varlen'}] cli.train --mode {mode}{lane} ({config}, "
        f"variable_length, max_segment {VARLEN_MAX_SEGMENT} s, {VARLEN_BUCKETS} buckets): "
        f"{n_train} train + {rec.eval_steps} eval steps in {wall:.2f} s; train ms per step by "
        f"bucket width {dict(sorted(by_bucket.items()))} (the first step of the run pays "
        f"set-up); peak {peak_gb:.2f} GB (the largest bucket's step); epoch losses "
        f"{rec.epochs}; checkpoints {files}; launches {launches}; per train step {per_train}")
    if not n_train or "1_last" not in files or len(rec.epochs) != 2 or \
            not all(math.isfinite(v) for _, v in rec.epochs):
        raise AssertionError(f"cli.train --mode {mode}{lane}: {n_train} steps, {files}, "
                             f"{rec.epochs}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"wall_s": wall, "step_ms": rec.step_ms, "widths": rec.widths,
            "ms_by_bucket": by_bucket, "peak_gb": peak_gb, "n_eval_steps": rec.eval_steps,
            "epochs": rec.epochs, "checkpoints": files, "launches": launches,
            "per_train_step": per_train}


def phase_varlen(torch, dev, smi):
    """Phase 16: variable-length training and the trainer's other knobs at
    full flagship width, fp32, as the module docstring says."""
    import shutil

    import numpy as np

    from tss_dprnn_tpu_torch.cli import generate_manifests
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.data.librimix import LibrimixSpe
    from tss_dprnn_tpu_torch.data.manifest import load_manifest
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
    from tss_dprnn_tpu_torch.training import Trainer, TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    root = os.path.join(OUT_DIR, "varlen")
    shutil.rmtree(root, ignore_errors=True)
    n = FLAGSHIP["n_repeats"]
    results = {}

    # -- (a) the corpus, its manifests frozen with segment: null, and cli.train
    csvs = {split: write_corpus(os.path.join(root, "corpus"), split, count, secs, SEED + 60 + k)
            for k, (split, (count, secs)) in enumerate(VARLEN_SPLITS.items())}
    manifests = {split: os.path.join(root, "manifests", f"{split}.json") for split in csvs}
    gen_yaml = os.path.join(root, "generate_manifests.yaml")
    with open(gen_yaml, "w") as f:
        f.write("dataset_type: librimix_spe\nsample_rate: 8000\nn_src: 2\nsegment: null\n"
                "seed: 0\n" + "".join(f"{s}_path: {csvs[s]}\n{s}_out: {manifests[s]}\n"
                                      for s in csvs))
    generate_manifests.main(["--config", gen_yaml])
    lengths = {s: [e["length"] for e in load_manifest(p)["entries"]]
               for s, p in manifests.items()}
    log(f"[varlen] corpus of whole utterances, {[len(v) for v in lengths.values()]} mixtures "
        f"of {min(min(v) for v in lengths.values()) / SAMPLE_RATE:.2f}-"
        f"{max(max(v) for v in lengths.values()) / SAMPLE_RATE:.2f} s, manifests with segment "
        f"null")
    runs = (("tss_spe", "train_tss.yaml", []), ("bss", "train_bss.yaml",
                                                ["model.bidirectional=false"]),
            ("tss_rawnet", "train_tss.yaml", ["model.target=dprnn_rawnet_tasnet",
                                              "model.embeddings_size=256"]))
    for mode, config, extra in runs:
        results[f"cli_{mode}"] = _varlen_cli(torch, dev, root, manifests, mode, config, extra)

    # the largest bucket's batch, as cli.train builds it for tss_spe
    train_set = LibrimixSpe(manifest_path=manifests["train"])
    eval_set = LibrimixSpe(manifest_path=manifests["eval"])
    rmax = max(max(train_set.ref_lengths()), max(eval_set.ref_lengths()))
    collate = loader.make_collate_spe_eval(ref_pad_to=-(-rmax // 2000) * 2000)
    largest = loader.VarLenTrainLoader(train_set, TRAIN_BATCH, collate, train_set.lengths(),
                                       n_buckets=VARLEN_BUCKETS,
                                       max_len=VARLEN_MAX_SEGMENT * SAMPLE_RATE).peek()
    tss = lambda: DPRNNSpeTasNet(**FLAGSHIP)  # noqa: E731
    start = init_weights_(tss(), torch.Generator().manual_seed(SEED + 61)).state_dict()
    config = dict(TRAIN_CONFIG, **RAW_GRADS)

    # -- (b) card vs CPU: 2 rows at 1 s, lengths 8000 and 5300
    crops = Crops(SEED + 62, 2, 1.0)
    small = loader.make_collate_spe_eval(ref_pad_to=16000)(crops.items, SAMPLE_RATE)
    small["lengths"] = np.array([8000, 5300], np.int32)
    past = np.arange(SAMPLE_RATE)[None, :] >= small["lengths"][:, None]
    clean = dict(small, mix=np.where(past, 0, small["mix"]).astype(np.float32),
                 target=np.where(past, 0, small["target"]).astype(np.float32))
    rel, gsnr, launches_b, ms_b = _step_card_vs_cpu(torch, dev, tss, start, TrainerSpe,
                                                    TRAIN_CONFIG, clean)
    log(f"[varlen] one 2 x 1 s variable-length TSS step (lengths 8000, 5300) card vs CPU: loss "
        f"rel {rel:.3e}, gradients {gsnr:.2f} dB; launches "
        f"{ {k: v for k, v in launches_b.items() if v} }")
    per_train = varlen_launches("tss_spe", n)[0]
    expect_launches(launches_b, per_train, 1, "a variable-length TSS step")
    if not (rel <= 1e-4 and gsnr >= 40):
        raise AssertionError(f"varlen step card vs CPU: loss rel {rel}, gradients {gsnr} dB")
    results["card_vs_cpu"] = {"loss_rel": rel, "grad_snr_db": gsnr, "ms": ms_b}

    # -- (c) padding: other garbage past the lengths, the same step
    rng = np.random.default_rng(SEED + 63)
    noisy = dict(clean, **{k: np.where(past, 37 * rng.standard_normal(past.shape), clean[k])
                           .astype(np.float32) for k in ("mix", "target")})
    a, b = (_whole_step(torch, dev, tss, start, TrainerSpe, config, bt) for bt in (clean, noisy))
    loss_diff = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    grad_diff = max(float((a["grads"][k] - b["grads"][k]).abs().max())
                    / float(a["grads"][k].abs().max()) for k in a["grads"])
    log(f"[varlen] garbage past the lengths: loss moved {loss_diff:.3e} of itself, gradients "
        f"at most {grad_diff:.3e} of their tensor's max")
    if not (loss_diff <= 1e-6 and grad_diff <= 1e-6):
        raise AssertionError(f"padding moved the step: loss {loss_diff}, gradients {grad_diff}")
    results["padding"] = {"loss_rel": loss_diff, "grad_rel": grad_diff}

    # -- (d) accum_steps=5 at 5 x 3 s, BSS and TSS
    bss = lambda: DPRNNTasNet(**BSS)  # noqa: E731
    bss_start = init_weights_(bss(), torch.Generator().manual_seed(SEED + 64)).state_dict()
    bss_batch = loader.collate_bss(Mixtures(SEED + 65, TRAIN_BATCH, TRAIN_SECONDS).items)
    bss_config = dict(BSS_TRAIN_CONFIG, **RAW_GRADS)
    one, five = (_whole_step(torch, dev, bss, bss_start, Trainer, dict(bss_config, accum_steps=k),
                             bss_batch) for k in (1, 5))
    rel, gsnr = abs(five["loss"] - one["loss"]) / abs(one["loss"]), _grad_snr(
        torch, five["grads"], one["grads"])
    log(f"[varlen] BSS 5 x 3 s, accum_steps 5 against 1: loss rel {rel:.3e}, gradients "
        f"{gsnr:.2f} dB; {five['ms']:.1f} ms / {five['peak_gb']:.2f} GB against "
        f"{one['ms']:.1f} ms / {one['peak_gb']:.2f} GB")
    if not (rel <= 1e-4 and gsnr >= 40):
        raise AssertionError(f"BSS accum_steps: loss rel {rel}, gradients {gsnr} dB")
    results["accum_bss"] = {"loss_rel": rel, "grad_snr_db": gsnr, "accum_1": _numbers(one),
                            "accum_5": _numbers(five)}
    tss_batch = loader.collate_spe(Crops(SEED + 66, TRAIN_BATCH, TRAIN_SECONDS).items)
    one, five = (_whole_step(torch, dev, tss, start, TrainerSpe, dict(config, accum_steps=k),
                             tss_batch) for k in (1, 5))
    last = _whole_step(torch, dev, tss, start, TrainerSpe, config,
                       {k: v[-1:] for k, v in tss_batch.items()})
    stats_err = max(float((five["buffers"][k].double() - last["buffers"][k].double())
                          .abs().max()) for k in last["buffers"])
    log(f"[varlen] TSS 5 x 3 s, accum_steps 5: BatchNorm statistics against one step on the "
        f"last row alone max|delta| {stats_err:.3e}; {five['ms']:.1f} ms / "
        f"{five['peak_gb']:.2f} GB against accum_steps 1 {one['ms']:.1f} ms / "
        f"{one['peak_gb']:.2f} GB")
    if not stats_err <= 1e-6:
        raise AssertionError(f"TSS accum_steps: running statistics off by {stats_err}")
    results["accum_tss"] = {"running_stats_max_abs_delta": stats_err, "accum_1": _numbers(one),
                            "accum_5": _numbers(five)}

    # -- (e) lstm_save_every=10 on the largest bucket
    one, ten = (_whole_step(torch, dev, tss, start, TrainerSpe,
                            dict(config, lstm_save_every=q), largest) for q in (1, SAVE_EVERY))
    rel, gsnr = abs(ten["loss"] - one["loss"]) / abs(one["loss"]), _grad_snr(
        torch, ten["grads"], one["grads"])
    log(f"[varlen] largest bucket {TRAIN_BATCH} x {largest['mix'].shape[1]} samples (lengths "
        f"{largest['lengths'].tolist()}): lstm_save_every {SAVE_EVERY} against 1: loss rel "
        f"{rel:.3e}, gradients {gsnr:.2f} dB; {ten['ms']:.1f} ms / {ten['peak_gb']:.2f} GB "
        f"(launches {_numbers(ten)['launches']}) against {one['ms']:.1f} ms / "
        f"{one['peak_gb']:.2f} GB (launches {_numbers(one)['launches']})")
    expect_launches(ten["launches"], save_every_launches(2 * n), 1,
                    f"a lstm_save_every={SAVE_EVERY} step")
    expect_launches(one["launches"], per_train, 1, "the largest bucket's step")
    if not (rel <= 1e-4 and gsnr >= 40):
        raise AssertionError(f"lstm_save_every: loss rel {rel}, gradients {gsnr} dB")
    results["save_every"] = {"loss_rel": rel, "grad_snr_db": gsnr, "width": largest[
        "mix"].shape[1], "lengths": largest["lengths"].tolist(), "save_every_1": _numbers(one),
        f"save_every_{SAVE_EVERY}": _numbers(ten)}

    # -- (f) schedule_masks on a 5 x 3 s step
    on, off = (_whole_step(torch, dev, tss, start, TrainerSpe, dict(config, schedule_masks=v),
                           tss_batch) for v in (True, False))
    rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    log(f"[varlen] schedule_masks on a 5 x 3 s TSS step: {on['ms']:.1f} ms against "
        f"{off['ms']:.1f} ms off; loss rel {rel:.3e}; launches {_numbers(on)['launches']}")
    expect_launches(on["launches"], training_family("tss")["per_train_step"] | training_family(
        "tss")["products_per_train_step"], 1, "a schedule_masks step")
    if not rel <= 1e-4:
        raise AssertionError(f"schedule_masks moved the loss by {rel}")
    results["schedule_masks"] = {"loss_rel": rel, "on": _numbers(on), "off": _numbers(off)}

    # -- (g) the kernels against their plain versions at this path's shapes
    results["kernels"] = _varlen_kernels(torch, dev, largest["mix"].shape[1],
                                         torch.from_numpy(largest["lengths"]))
    # the corpus stays for phase 17's bf16 variable-length run, which removes it
    results["manifests"] = manifests
    return results


def varlen_kernel_entries(results):
    """The kernels line's entries for the modes that variable-length training
    and lstm_save_every launch, at phase 16's shapes; their launches are the
    tss_spe cli.train run's and the lstm_save_every step's."""
    m, cs = results["kernels"]["masked"], results["kernels"]["with_cs"]
    cli = results["cli_tss_spe"]["launches"]
    base = {"dtype": "float32", "route": "cuda"}
    shape = {"R": m["R"], "T": m["T"], "F": 128, "H": 128}
    return [
        dict(base, name="bilstm2_forward_resid_masked",
             mode="masked residual forward, the largest bucket's inter scan",
             source="tss_dprnn_tpu_torch/csrc/bilstm2_resid.cu",
             **{"with": "tss_dprnn_tpu_torch/csrc/products.cu"},
             replaces="tss_dprnn_tpu/ops/pallas_lstm.py:698",
             launches=cli.get("bilstm2_forward_resid_masked", 0),
             max_abs_err=m["resid_max_abs_err"], ms=m["fwd_ms"], plain_ms=m["fwd_plain_ms"],
             bound_ms=m["fwd_bound_ms"], bound_by=m["fwd_bound_by"],
             library_ms=m["cudnn_fwd_ms"], shape=shape, rows_steps=m["rows_steps"]),
        dict(base, name="bilstm2_backward_masked",
             mode="masked fused backward, the largest bucket's inter scan",
             source="tss_dprnn_tpu_torch/csrc/bilstm2_bwd.cu",
             **{"with": "tss_dprnn_tpu_torch/csrc/cluster_scan.cuh and products.cu"},
             replaces="tss_dprnn_tpu/ops/pallas_lstm.py:1224",
             launches=cli.get("bilstm2_backward_masked", 0),
             max_abs_err=max(m["dx_max_abs_err"], m["dw_max_abs_err"]),
             dw_rel_err=m["dw_rel_err"], ms=m["bwd_ms"], plain_ms=m["bwd_plain_ms"],
             bound_ms=m["bwd_bound_ms"], bound_by=m["bwd_bound_by"],
             library_ms=m["cudnn_bwd_ms"], shape=shape, rows_steps=m["rows_steps"]),
        dict(base, name="lstm_forward_with_cs",
             mode=f"want_cs, D=2 over the largest bucket's intra shape (lstm_save_every "
                  f"{SAVE_EVERY})",
             source="tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu (mode 4)",
             **{"with": "tss_dprnn_tpu_torch/csrc/products.cu (the input product, one launch "
                        "per direction)"},
             replaces="tss_dprnn_tpu/ops/pallas_lstm.py:57",
             launches=results["save_every"][f"save_every_{SAVE_EVERY}"]["launches"].get(
                 "lstm_forward_with_cs", 0),
             launches_are="per lstm_save_every step (0 in the cli.train runs)",
             max_abs_err=cs["max_abs_err"], ms=cs["ms"], plain_ms=cs["plain_ms"],
             bound_ms=cs["bound_ms"], bound_by=cs["bound_by"], library_ms=None,
             tile_plan=cs["tile_plan"], bitwise_repeat=cs["bitwise_repeat"],
             h_is_lstm_forward=cs["h_is_lstm_forward"],
             library="no single cuDNN call: two directions on their own inputs",
             shape={"D": cs["D"], "R": cs["R"], "T": cs["T"], "F": 128, "H": 128}),
    ]


# the bf16 lane (phase 17): the bf16 model against the fp32 model on the same
# weights, >= 44 dB on the rows' valid region (PARITY.md:184, the JAX lane's
# bar for its bf16 lane against its fp32 graph)
LANE_SNR_DB = 44.0
# bf16 backward kernel vs its plain version: dx, dW and db SNR. The bf16 mode
# rounds dpre to bf16 before its products (as the TPU kernel does), so a gate
# summed in another order can round a dpre to its neighbour; that moves dW by
# more than DW_REL_TOL allows at small shapes. Over 12 seeds at the CPU tests'
# shapes the port's plain backward reads at least 64.6 dB (dx) and 70.2 dB
# (dW) against the TPU kernel's in interpret mode, the backward without that
# rounding at most 52.7 and 56.7 dB (scripts/port/bf16_grad_floor.py, CPU);
# the bar sits between them.
BF16_GRAD_SNR_DB = 60.0
# card vs CPU for a bf16 train step (2 x 1 s): both are the bf16 lane, but
# each rounding the card takes in another order moves what follows by a bf16
# ulp, so the bar is the bf16 lane's, not the fp32 lane's 40 dB
BF16_STEP_GRAD_SNR_DB = 30.0
BF16_STEP_LOSS_REL = 1e-3


def _bf16_streams_close(torch, name, got, want, valid=None):
    """(max |err|, SNR) of a bf16 output or saved stream against its plain
    version on ``valid`` ([R, T] or None); the error of c is taken relative to
    max(1, |ref|) (its ulp grows past 1). Raises past BF16_ATOL or
    BF16_SNR_DB."""
    got, want = got.float(), want.float()
    if valid is not None:
        got, want = got[valid], want[valid]
    scale = want.abs().clamp_min(1.0) if name.startswith("cp") else 1.0
    err = float(((got - want).abs() / scale).max()) if got.numel() else 0.0
    snr = snr_db(got, want)
    if not (err <= BF16_ATOL and snr >= BF16_SNR_DB):
        raise AssertionError(f"bf16 {name} disagrees with its plain version: max|err| {err} "
                             f"(<= {BF16_ATOL}), SNR {snr:.2f} dB (>= {BF16_SNR_DB})")
    return err, snr


def _bf16_grads_close(torch, got, want):
    """dx within BF16_ATOL, every gradient at BF16_GRAD_SNR_DB: (dx max
    |err|, the smallest SNR)."""
    dx_err = float((got[0].float() - want[0].float()).abs().max())
    snrs = [snr_db(a.float(), b.float()) for a, b in zip(got, want)]
    if not (dx_err <= BF16_ATOL and min(snrs) >= BF16_GRAD_SNR_DB):
        raise AssertionError(f"bf16 backward disagrees with its plain version: dx max|err| "
                             f"{dx_err} (<= {BF16_ATOL}), SNR dx/dW_ih/db/dW_hh {snrs} "
                             f"(>= {BF16_GRAD_SNR_DB} dB)")
    return dx_err, min(snrs)


def bound_bf16_training(kind: str, dirs: int, rows_steps: int, R: int, T: int, F: int, H: int):
    """Least time of a bf16 training mode: 2 (F + H) 4H FLOP per row-step
    and direction forward, twice that backward, over the bf16 peak; or the
    bytes of the function itself: forward, x (bf16) read once and per
    direction the output and the three saved streams written (bf16);
    backward, x, the three saved streams and the cotangent per direction
    read and dx written (bf16), dW and db written; the weights read (fp32).
    The port's own saved gate pre-activations (fp32) are left out: the TPU
    function saves no gates and its backward recomputes them."""
    weights = dirs * (F + H + 1) * 4 * H * 4
    steps = dirs * rows_steps
    if kind == "backward":
        flops = 2 * steps * 2 * (F + H) * 4 * H
        nbytes = (rows_steps * F + dirs * R * T * 4 * H + R * T * F) * 2 + 2 * weights
    else:
        flops = steps * 2 * (F + H) * 4 * H
        nbytes = (rows_steps * F + dirs * R * T * 4 * H) * 2 + weights
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bf16_training_kernels(torch, dev):
    """Phase 17 (a): the four bf16 training modes against their plain
    versions at the training shapes (5 x 3 s; the pair masked at phase 2's
    inter shape, ragged), bit for bit on a second call, timed beside the
    plain versions, the bound and cuDNN's LSTM in bf16 (training mode). Each
    call's launches are its wrapper's one and its bf16 products
    (BF16_TRAIN_PRODUCTS), and no other kernel."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2
    from tss_dprnn_tpu_torch.ops import lstm as L

    F = H = 128
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    g = torch.Generator(device="cpu").manual_seed(SEED + 17)
    k = H ** -0.5
    bf = torch.bfloat16
    S10 = (10 * SAMPLE_RATE - 1 + K) // hop + 1
    secs = torch.rand(8, generator=g) * 5 + 5
    lens = ((((secs * SAMPLE_RATE).long() - 1 + K) // hop + 1).repeat_interleave(K)
            .int().to(dev))
    shapes = train_shapes()
    cases = [("pair", name, 2, R, T, None) for name, (R, T) in shapes.items()]
    cases.append(("pair", "masked", 2, 8 * K, S10, lens))
    cases.append(("stack", "inter", 1, *shapes["inter"], None))
    results = {}
    for kind, name, D, R, T, ln in cases:
        # the lane's weights: fp32 parameters cast to bf16 (the bias summed in bf16)
        w = [((torch.rand(*s, generator=g) * 2 * k - k)).to(dev).to(bf)
             for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
        shape = (R, T) if kind == "pair" else (1, R, T)
        x = torch.randn(*shape, F, generator=g).to(dev).to(bf)
        cots = [torch.randn(*shape, H, generator=g).to(dev).to(bf) for _ in range(D)]
        valid = (torch.ones(R, T, dtype=torch.bool, device=dev) if ln is None
                 else torch.arange(T, device=dev)[None, :] < ln[:, None])
        if ln is not None:  # out0 past a row's length is unspecified: consumers mask it
            cots[0] = cots[0] * valid[..., None]
        rows_steps = R * T if ln is None else int(ln.sum())

        if kind == "pair":
            def fwd(kernel=True, x=x, ln=ln, w=w):
                if not kernel:
                    return B2.bilstm2_resid_reference(x, *w, ln)
                if ln is None:
                    return B2.bilstm2_forward_resid(x, *w)
                return B2.bilstm2_forward_resid_masked(x, ln, *w)

            def bwd(resid, kernel=True, x=x, ln=ln, w=w, cots=cots):
                if not kernel:
                    return B2.bilstm2_backward_reference(x, resid, *cots, *w, ln)
                if ln is None:
                    return B2.bilstm2_backward(x, resid, *cots, *w)
                return B2.bilstm2_backward_masked(x, resid, *cots, *w, ln)
            names = ("hp0", "cp0", "tc0", "hp1", "cp1", "tc1")
        else:
            def fwd(kernel=True, x=x, w=w):
                return (L.lstm_forward_resid if kernel else L.lstm_resid_reference)(x, *w)

            def bwd(resid, kernel=True, x=x, w=w, cots=cots):
                run = L.lstm_backward if kernel else L.lstm_backward_reference
                return run(x, resid, cots[0], *w)
            names = ("hp", "cp", "tc")
        masked = "_masked" if ln is not None else ""
        fname, bname = ((f"bilstm2_forward_resid{masked}", f"bilstm2_backward{masked}")
                        if kind == "pair" else ("lstm_forward_resid", "lstm_backward"))

        reset_launches()
        out, resid = fwd()
        torch.cuda.synchronize()
        expect_launches(dict(all_launches(), **product_launches()),
                        with_products({fname: 1}, bf16=True), 1, f"bf16 {kind} {name} forward")
        out2, again = fwd()
        torch.cuda.synchronize()
        outs = out if kind == "pair" else (out,)
        fwd_repeat = all(torch.equal(a, b) for a, b in zip(
            (*outs, *resid), (*(out2 if kind == "pair" else (out2,)), *again)))
        del out2, again
        pout, presid = fwd(kernel=False)
        pouts = pout if kind == "pair" else (pout,)
        vmask = None if kind == "stack" else valid
        errs, snrs = [], []
        for i, (a, b) in enumerate(zip(outs, pouts)):  # out1 of the pair everywhere
            e, sn = _bf16_streams_close(torch, f"out{i}", a, b, vmask if i == 0 else None)
            errs.append(e), snrs.append(sn)
        for nm, a, b in zip(names, resid, presid):
            e, sn = _bf16_streams_close(torch, nm, a, b, vmask)
            errs.append(e), snrs.append(sn)
        pre_snr = snr_db(resid[-1][valid] if kind == "pair" else resid[-1],
                         presid[-1][valid] if kind == "pair" else presid[-1])
        del pout, pouts, presid
        reset_launches()
        got = bwd(resid)
        torch.cuda.synchronize()
        expect_launches(dict(all_launches(), **product_launches()),
                        with_products({bname: 1}, bf16=True), 1, f"bf16 {kind} {name} backward")
        again = bwd(resid)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = bwd(resid, kernel=False)
        dx_err, grad_snr = _bf16_grads_close(torch, got, want)
        dw_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                     for a, b in zip(got[1:], want[1:]))
        del got, want
        if not (fwd_repeat and repeat):
            raise AssertionError(f"bf16 {kind} {name}: a second call differs (forward "
                                 f"{fwd_repeat}, backward {repeat})")

        # cuDNN's LSTM in bf16 on the same weights, training mode: the yardstick
        lstm = cudnn_lstm(torch, *(t.float() for t in w), torch.bfloat16)
        xr = (x if kind == "pair" else x[0]).detach().clone().requires_grad_()
        params = [xr, *lstm.parameters()]
        cot = torch.cat([c if kind == "pair" else c[0] for c in cots], dim=-1)
        lens_cpu = None if ln is None else ln.cpu()
        pack = torch.nn.utils.rnn.pack_padded_sequence
        unpack = torch.nn.utils.rnn.pad_packed_sequence

        def library_fwd():
            if ln is None:
                return lstm(xr)[0]
            packed = pack(xr, lens_cpu, batch_first=True, enforce_sorted=False)
            return unpack(lstm(packed)[0], batch_first=True, total_length=T)[0]

        lib_out = library_fwd()

        def library_bwd():
            torch.autograd.grad(lib_out, params, cot, retain_graph=True)

        nums = {"fwd_ms": time_ms(fwd, 5), "fwd_plain_ms": time_ms(lambda: fwd(kernel=False), 1),
                "bwd_ms": time_ms(lambda: bwd(resid), 5),
                "bwd_plain_ms": time_ms(lambda: bwd(resid, kernel=False), 1),
                "cudnn_fwd_ms": time_ms(library_fwd, 3), "cudnn_bwd_ms": time_ms(library_bwd, 3)}
        nums["fwd_bound_ms"], nums["fwd_bound_by"] = bound_bf16_training(
            "forward", D, rows_steps, R, T, F, H)
        nums["bwd_bound_ms"], nums["bwd_bound_by"] = bound_bf16_training(
            "backward", D, rows_steps, R, T, F, H)
        key = f"{kind}_{name}"
        results[key] = dict(nums, kind=kind, shape=name, D=D, R=R, T=T, rows_steps=rows_steps,
                            fwd_max_abs_err=max(errs), fwd_min_snr_db=min(snrs),
                            pre_snr_db=pre_snr, dx_max_abs_err=dx_err, grad_min_snr_db=grad_snr,
                            dw_rel_err=dw_rel, fwd_bitwise_repeat=fwd_repeat,
                            bitwise_repeat=repeat)
        log(f"[bf16] {key} D={D} R={R} T={T}: resid fwd {nums['fwd_ms']:.3f} ms (plain "
            f"{nums['fwd_plain_ms']:.1f}, bound {nums['fwd_bound_ms']:.3f}, cuDNN bf16 "
            f"{nums['cudnn_fwd_ms']:.3f}), streams max|err| {max(errs):.3e} SNR >= "
            f"{min(snrs):.1f} dB, pre {pre_snr:.1f} dB; backward {nums['bwd_ms']:.3f} ms (plain "
            f"{nums['bwd_plain_ms']:.1f}, bound {nums['bwd_bound_ms']:.3f}, cuDNN bf16 "
            f"{nums['cudnn_bwd_ms']:.3f}), dx max|err| {dx_err:.3e}, gradients SNR >= "
            f"{grad_snr:.1f} dB, dW/db max|err|/max|ref| {dw_rel:.2e}; repeats bit for bit")
        del x, cots, resid, lstm, xr, params, cot, lib_out
        torch.cuda.empty_cache()
    return results


# The column-layout bf16 product (dW = x^T dpre over every row-step) against
# float64, relative to max |ref|: a reduction over 1.3 M row-steps in fp32
# fixed splits (each 32-deep k-tile into a fresh partial, the partials and
# splits added in round-to-nearest) drifts as sqrt(terms) fp32 ulps of the
# partial sums; 2^-14 sits 32 times below half a bf16 ulp and 1,000 times
# below the 60 dB gradient bar.
BF16_COL_PRODUCT_REL_TOL = 2.0 ** -14


def _bf16_col_product_entry(torch, dev):
    """Phase 17 (a): the column-layout bf16-operand product (csrc/products.cu,
    products_gemm_bf16_col) at the masked bf16 backward's dW_ih = x^T dpre
    (8 x 10 s: K = 1.284 M row-steps, M = F = 128, N = 8H = 1024) against its
    plain version (its fixed splits in fp32) and float64 on 128 columns
    (beside torch.matmul fp32's error there), timed beside the plain
    version, the bound and one fp32 torch.mm of the upcast operands."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    g = torch.Generator(device="cpu").manual_seed(SEED + 18)
    K_chunks = FLAGSHIP["chunk_length"]
    K = 8 * K_chunks * ((10 * SAMPLE_RATE - 1 + K_chunks) // FLAGSHIP["hop_length"] + 1)
    M, N = 128, 1024
    a = torch.randn(K, M, generator=g).bfloat16().to(dev)
    b = (torch.randn(K, N, generator=g) * 0.05).bfloat16().to(dev)
    lib = B2._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    before = B2.product_launch_counts()["products_gemm_bf16_col"]
    out = B2._gemm_bf16_col(lib, stream, a, 0, M, b, 0, N, K, M, N)
    again = B2._gemm_bf16_col(lib, stream, a, 0, M, b, 0, N, K, M, N)
    plain = B2.gemm_bf16_col_reference(a, b)
    torch.cuda.synchronize()
    if B2.product_launch_counts()["products_gemm_bf16_col"] != before + 2:
        raise AssertionError("the column-layout bf16 product did not count its launches")
    err = float((out - plain).abs().max())
    cols = slice(0, 128)  # float64 on 128 columns: all of b would take 10.5 GB
    ref64 = a.double().T @ b[:, cols].double()
    scale = float(ref64.abs().max())
    err64 = float((out[:, cols].double() - ref64).abs().max()) / scale
    torch_err64 = float((a.float().T @ b[:, cols].float()).double().sub(ref64).abs().max()) / scale
    del ref64
    af, bf = a.float(), b.float()
    splits, kps = B2.split_plan(M, N, K)
    ms = time_ms(lambda: B2._gemm_bf16_col(lib, stream, a, 0, M, b, 0, N, K, M, N), 10)
    plain_ms = time_ms(lambda: B2.gemm_bf16_col_reference(a, b), 3)
    library_ms = time_ms(lambda: torch.mm(af.T, bf), 5)
    t_ops = 2 * M * N * K / PEAK_BF16
    t_bytes = (2 * K * (M + N) + 4 * M * N) / PEAK_BYTES
    bound_ms, bound_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    repeat = torch.equal(out, again)
    log(f"[bf16] products_gemm_bf16_col K={K} M={M} N={N} ({splits} splits of {kps}): max|err| "
        f"vs plain {err:.3e}; vs float64 {err64:.3e} of max|ref| (torch.matmul fp32 "
        f"{torch_err64:.3e}); {ms:.3f} ms ({2 * M * N * K / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, torch.mm fp32 {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}); repeats bit for bit {repeat}")
    if not (err64 <= BF16_COL_PRODUCT_REL_TOL and repeat):
        raise AssertionError(f"the column-layout bf16 product is {err64:.3e} of max|ref| off "
                             f"float64 (bar {BF16_COL_PRODUCT_REL_TOL:.3e}), bit for bit on a "
                             f"second call: {repeat}")
    del a, b, af, bf, out, again, plain
    torch.cuda.empty_cache()
    return {"name": "products_gemm_bf16_col", "route": "cuda",
            "source": "tss_dprnn_tpu_torch/csrc/products.cu",
            "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:1304-1309 (dW_ih += x_t^T dpre_s, "
                        "dW_hh += h_prev^T dpre_s of _bilstm2_bwd_kernel's bf16 mode; the same "
                        "in _lstm_bwd_kernel :498)",
            "shape": {"M": M, "N": N, "K": K, "splits": splits, "kps": kps},
            "max_abs_err": err, "rel_err_float64": err64, "torch_fp32_rel_err_float64":
            torch_err64, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "torch.mm fp32 on the upcast operands (TF32 off)",
            "tflops": 2 * M * N * K / ms / 1e9, "bitwise_repeat": repeat}


def _bf16_batch(torch, target, n):
    """A ragged serving batch of ``n`` rows of up to 10 s for ``target``'s
    inferencer, with its audio-seconds (serving_batch8's rows)."""
    import numpy as np

    from tss_dprnn_tpu_torch.data import loader

    if target == "dprnn_tasnet":
        def collate(items, T):
            return loader.collate_bss_eval([(m, np.stack([t, t])) for m, t, _, _ in items], T)
        return serving_batch8(torch, collate, n)
    if target == "dprnn_rawnet_tasnet":
        return serving_batch8(torch, loader.make_collate_spe_eval(16000, SAMPLE_RATE), n)
    return serving_batch8(torch, loader.make_collate_spe_eval(), n)


def phase_bf16(torch, dev, smi, cli_state, varlen_state):
    """Phase 17: the bf16 lane at full flagship width, as the module
    docstring says: (a) the bf16 training modes against their plain
    versions; (b) the flagship served in both lanes at batch 8 and 32; (c)
    every family served in both lanes at batch 8; (d) 5 x 3 s train steps in
    both lanes and a 2 x 1 s bf16 step card vs CPU; (e) the CLIs with
    model.dtype=bfloat16 on phase 13's corpus and checkpoint; (f)
    variable-length bf16 training through cli.train on phase 16's corpus;
    (g) accum_steps in the bf16 lane."""
    import functools
    import shutil

    from tss_dprnn_tpu_torch import inference, training
    from tss_dprnn_tpu_torch.cli import test as test_cli, train as train_cli
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.data.librimix import LibrimixSpe
    from tss_dprnn_tpu_torch.models import (DPRNNRawNetTasNet, DPRNNSpeIRATasNet, DPRNNSpeTasNet,
                                            DPRNNTasNet)
    from tss_dprnn_tpu_torch.utils.config import load_config
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    bf = torch.bfloat16
    n = FLAGSHIP["n_repeats"]
    results = {"kernels": _bf16_training_kernels(torch, dev),
               "col_product": _bf16_col_product_entry(torch, dev)}

    # -- (b), (c): each family served in both lanes on the same weights
    families = {
        "flagship": ("dprnn_spe_tasnet", lambda **kw: DPRNNSpeTasNet(**FLAGSHIP, **kw),
                     inference.InferencerSpe, {"bilstm2_forward": n, "bilstm2_forward_masked": n}),
        "spe_add": ("dprnn_spe_tasnet",
                    lambda **kw: DPRNNSpeTasNet(**dict(FLAGSHIP, fusion_type="add"), **kw),
                    inference.InferencerSpe, {"bilstm2_forward": n, "bilstm2_forward_masked": n}),
        "bss_causal": ("dprnn_tasnet", lambda **kw: DPRNNTasNet(**BSS, **kw),
                       inference.Inferencer, {"bilstm2_forward": n, "lstm_forward": n}),
        "bss_bidirectional": ("dprnn_tasnet",
                              lambda **kw: DPRNNTasNet(**dict(BSS, bidirectional=True), **kw),
                              inference.Inferencer,
                              {"bilstm2_forward": n, "bilstm2_forward_masked": n}),
        "ira": ("dprnn_spe_ira_tasnet", lambda **kw: DPRNNSpeIRATasNet(**IRA, **kw),
                inference.InferencerSpe,
                {"bilstm2_forward": 2 * n, "bilstm2_forward_masked": 2 * n}),
        "rawnet": ("dprnn_rawnet_tasnet", lambda **kw: DPRNNRawNetTasNet(**RAWNET, **kw),
                   inference.InferencerRawNet,
                   {"bilstm2_forward": n, "bilstm2_forward_masked": n}),
    }
    served = {}
    for fam, (target, make, inf_cls, per_batch) in families.items():
        ckpt = os.path.join(OUT_DIR, f"bf16_{fam}.pt")
        torch.save(init_weights_(make(), torch.Generator().manual_seed(SEED + 70)).state_dict(),
                   ckpt)
        config = {"checkpoint_path": ckpt, "metrics": ["si_sdr"],
                  "data": {"sample_rate": SAMPLE_RATE}}
        infs = {"fp32": inf_cls(make(), config, device=dev),
                "bf16": inf_cls(make(dtype=bf), config, device=dev)}
        res = {}
        for size in ((8, 32) if fam == "flagship" else (8,)):
            batch, audio = _bf16_batch(torch, target, size)
            est, rate, launches = {}, {}, {}
            for lane, inf in infs.items():
                with torch.inference_mode():
                    reset_launches()
                    est[lane] = inf.forward(batch).float()
                    launches[lane] = dict(all_launches(), **product_launches())
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        inf.forward(batch)
                    torch.cuda.synchronize()
                    rate[lane] = audio / ((time.perf_counter() - t0) / 3)
                    res[f"peak_gb_{lane}_batch{size}"] = torch.cuda.max_memory_allocated() / 1e9
            expect_launches(launches["bf16"], with_products(per_batch), 1,
                            f"{fam} bf16 batch of {size}")
            expect_launches(launches["fp32"], with_products(per_batch), 1,
                            f"{fam} fp32 batch of {size}")
            lengths = torch.from_numpy(batch["lengths"])
            snr = _valid_snr(torch, est["bf16"].cpu(), est["fp32"].cpu(), lengths)
            if not (snr >= LANE_SNR_DB and torch.isfinite(est["bf16"]).all()):
                raise AssertionError(f"{fam} bf16 lane vs fp32 lane {snr:.2f} dB < {LANE_SNR_DB}")
            res.update({f"snr_db_batch{size}": snr, f"launches_bf16_batch{size}": launches["bf16"],
                        f"audio_s_per_s_bf16_batch{size}": rate["bf16"],
                        f"audio_s_per_s_fp32_batch{size}": rate["fp32"],
                        f"audio_s_batch{size}": audio})
            log(f"[bf16] {fam} batch of {size} ({audio:.2f} audio-s): bf16 {rate['bf16']:.2f} "
                f"audio-s/s against fp32 {rate['fp32']:.2f} on {smi}; bf16 vs fp32 lane "
                f"{snr:.2f} dB; bf16 launches {({k: v for k, v in launches['bf16'].items() if v})}")
            del batch, est
        served[fam] = res
        del infs
        os.remove(ckpt)
        torch.cuda.empty_cache()
    results["serving"] = served

    # -- (d): 5 x 3 s train steps in both lanes, and a 2 x 1 s bf16 step card vs CPU
    tss_step = with_products({"bilstm2_forward_resid": 2 * n, "bilstm2_backward": 2 * n},
                             bf16=True)
    steps_fams = {
        "tss": (dict(model=lambda **kw: DPRNNSpeTasNet(**FLAGSHIP, **kw),
                     trainer=training.TrainerSpe), loader.collate_spe, Crops, tss_step),
        "bss_causal": (dict(model=lambda **kw: DPRNNTasNet(**BSS, **kw), trainer=training.Trainer),
                       loader.collate_bss, Mixtures,
                       with_products({"bilstm2_forward_resid": n, "bilstm2_backward": n,
                                      "lstm_forward_resid": n, "lstm_backward": n}, bf16=True)),
        "ira": (dict(model=lambda **kw: DPRNNSpeIRATasNet(**IRA, **kw),
                     trainer=training.TrainerSpe), loader.collate_spe, Crops,
                with_products({"bilstm2_forward_resid": 6 * n, "bilstm2_backward": 4 * n},
                              bf16=True)),
        "rawnet": (dict(model=lambda **kw: DPRNNRawNetTasNet(**RAWNET, **kw),
                        trainer=training.TrainerRawNet),
                   functools.partial(loader.collate_spe, resample_ref_to=16000), Crops, tss_step),
    }
    steps = {}
    for fam, (spec, collate, crops, per_step) in steps_fams.items():
        start = init_weights_(spec["model"](), torch.Generator().manual_seed(SEED + 71))
        start = start.state_dict()
        batch = collate(crops(SEED + 72, TRAIN_BATCH, TRAIN_SECONDS).items)
        runs = {"fp32": _timed_step(torch, dev, spec, start, batch),
                "bf16": _timed_step(torch, dev, spec, start, batch, dtype=bf)}
        expect_launches(runs["bf16"]["launches"], per_step, 1, f"{fam} bf16 5 x 3 s step")
        grad_snr = snr_db(runs["bf16"]["grads"], runs["fp32"]["grads"])
        if not all(math.isfinite(float(r["loss"])) and math.isfinite(r["second_step_loss"])
                   for r in runs.values()):
            raise AssertionError(f"{fam}: non-finite loss in a 5 x 3 s step")
        steps[fam] = {lane: {"ms": r["ms"], "peak_gb": r["peak_gb"], "loss": float(r["loss"]),
                             "launches": r["launches"]} for lane, r in runs.items()}
        steps[fam]["bf16_vs_fp32_grad_snr_db"] = grad_snr
        log(f"[bf16] {fam} {TRAIN_BATCH} x {TRAIN_SECONDS} s train step: bf16 "
            f"{runs['bf16']['ms']:.1f} ms, {runs['bf16']['peak_gb']:.2f} GB against fp32 "
            f"{runs['fp32']['ms']:.1f} ms, {runs['fp32']['peak_gb']:.2f} GB on {smi}; losses "
            f"{float(runs['bf16']['loss']):.6f} / {float(runs['fp32']['loss']):.6f}, gradients "
            f"bf16 vs fp32 {grad_snr:.2f} dB; bf16 launches "
            f"{({k: v for k, v in runs['bf16']['launches'].items() if v})}")
        del runs
        torch.cuda.empty_cache()
    spec, collate, crops, per_step = steps_fams["tss"]
    start = init_weights_(spec["model"](), torch.Generator().manual_seed(SEED + 73)).state_dict()
    rel, grad_snr, stepped, _ = _step_card_vs_cpu(
        torch, dev, lambda: spec["model"](dtype=bf), start, spec["trainer"], TRAIN_CONFIG,
        collate(Crops(SEED + 74, 2, 1).items))
    expect_launches(stepped, per_step, 1, "bf16 2 x 1 s step")
    log(f"[bf16] tss bf16 train step (2 x 1 s) card vs CPU: loss rel {rel:.2e}, gradients "
        f"{grad_snr:.2f} dB")
    if not (rel <= BF16_STEP_LOSS_REL and grad_snr >= BF16_STEP_GRAD_SNR_DB):
        raise AssertionError(f"bf16 card vs CPU train step: loss rel {rel}, gradients "
                             f"{grad_snr:.2f} dB")
    steps["card_vs_cpu_2x1s"] = {"loss_rel": rel, "grad_snr_db": grad_snr}
    results["steps"] = steps

    # -- (e): the CLIs on phase 13's corpus and checkpoint
    manifests, fp32_ckpt = cli_state["manifests"], cli_state["best_checkpoint"]
    root = os.path.join(OUT_DIR, "cli")
    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    test_yaml = os.path.join(HERE, "configs", "test_tss.yaml")
    ckpt_dir = os.path.join(root, "bf16_chkpts")
    argv = ["--config", os.path.join(HERE, "configs", "train_tss.yaml"), "--mode", "tss_spe",
            "--set", f"data.use_generated_train={manifests['train']}",
            f"data.use_generated_eval={manifests['eval']}", "epochs=1",
            f"logs.metadata.ids=[{', '.join(map(str, CLI_IDS))}]", "model.dtype=bfloat16",
            f"new_checkpoints_path={ckpt_dir}", *device_args]
    batch = load_config(argv[1])["data"]["batch_size"]
    n_train = len(LibrimixSpe(manifest_path=manifests["train"])) // batch
    n_eval = len(LibrimixSpe(manifest_path=manifests["eval"])) // batch
    reset_launches()
    with recorded_training(torch) as rec:
        t0 = time.perf_counter()
        train_cli.main(argv)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
    launches = dict(all_launches(), **product_launches())
    n_mix = rec.mixture_passes * len(CLI_IDS)
    per_eval = with_products({"bilstm2_forward": 2 * n})
    expect_launches(launches, {k: n_train * tss_step.get(k, 0) + (n_eval + n_mix) *
                               per_eval.get(k, 0) for k in launches}, 1,
                    f"bf16 cli.train ({n_train} train steps, {n_eval} eval steps, {n_mix} eval "
                    f"mixtures)")
    files = sorted(os.listdir(ckpt_dir))
    if "1_best" not in files or not all(math.isfinite(v) for _, v in rec.epochs):
        raise AssertionError(f"bf16 cli.train: {files}, epochs {rec.epochs}")
    test_set = LibrimixSpe(manifest_path=manifests["test"])
    eval_batch, n_buckets = 4, 2
    n_test = len(loader.BucketedEvalLoader(test_set, eval_batch, loader.make_collate_spe_eval(),
                                           test_set.lengths(), n_buckets=n_buckets))

    def run_test(ckpt, tag, *sets):
        savedir = os.path.join(root, f"metrics_bf16_{tag}")
        reset_launches()
        t0 = time.perf_counter()
        final = test_cli.main(["--config", test_yaml, "--mode", "tss_spe", "--batch-size",
                               str(eval_batch), "--n-buckets", str(n_buckets), "--set",
                               f"data.use_generated_test={manifests['test']}",
                               f"checkpoint_path={ckpt}", f"test_savedir={savedir}", *sets,
                               *device_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tested = dict(all_launches(), **product_launches())
        if not all(v is not None and math.isfinite(v) for v in final.values()):
            raise AssertionError(f"bf16 cli.test {tag}: {final}")
        rows = _csv_rows(os.path.join(savedir, "all_metrics.csv"))
        return final, wall, tested, [float(r["si_sdr"]) for r in rows]

    bf16_lane = with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n})
    trained = run_test(os.path.join(ckpt_dir, "1_best"), "trained", "model.dtype=bfloat16")
    expect_launches(trained[2], bf16_lane, n_test, "bf16 cli.test")
    lanes = {"fp32": run_test(fp32_ckpt, "fp32", "metrics=[si_sdr]"),
             "bf16": run_test(fp32_ckpt, "phase13_bf16", "metrics=[si_sdr]",
                              "model.dtype=bfloat16")}
    expect_launches(lanes["bf16"][2], bf16_lane, n_test, "bf16 cli.test on the fp32 checkpoint")
    gap = [b - a for a, b in zip(lanes["fp32"][3], lanes["bf16"][3])]
    mean_gap = sum(gap) / len(gap)
    log(f"[bf16] cli.train --set model.dtype=bfloat16 (configs/train_tss.yaml, 1 epoch): "
        f"{n_train} train + {n_eval} eval steps in {train_wall:.2f} s, train steps "
        f"{[round(v, 1) for v in rec.step_ms]} ms, epoch losses {rec.epochs}; cli.test with it "
        f"(configs/test_tss.yaml) {trained[1]:.3f} s: {trained[0]}; phase 13's fp32 checkpoint "
        f"through cli.test: fp32 lane mean SI-SDR {lanes['fp32'][0]['si_sdr']:.4f} dB "
        f"({lanes['fp32'][1]:.3f} s), bf16 lane {lanes['bf16'][0]['si_sdr']:.4f} dB "
        f"({lanes['bf16'][1]:.3f} s), mean gap {mean_gap:+.5f} dB, worst row "
        f"{max(map(abs, gap)):.5f} dB")
    results["cli"] = {"train_wall_s": train_wall, "step_ms": rec.step_ms, "epochs": rec.epochs,
                      "train_launches": launches, "test_trained": trained[0],
                      "test_trained_wall_s": trained[1],
                      "fp32_checkpoint": {lane: {"final": v[0], "wall_s": v[1]}
                                          for lane, v in lanes.items()},
                      "si_sdr_mean_gap_db": mean_gap, "si_sdr_worst_row_gap_db":
                          max(map(abs, gap))}
    # phase 13's corpus and checkpoint stay for phase 20, which removes them
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # -- (f): variable-length bf16 training through cli.train on phase 16's
    # corpus: the masked bf16 training modes' path
    fp32_run = varlen_state["cli_tss_spe"]
    varlen_root = os.path.join(OUT_DIR, "varlen")
    run = _varlen_cli(torch, dev, varlen_root, varlen_state["manifests"], "tss_spe",
                      "train_tss.yaml", ["model.dtype=bfloat16"], bf16=True)
    log(f"[bf16] variable-length cli.train, train ms per step by bucket width: bf16 "
        f"{dict(sorted(run['ms_by_bucket'].items()))}, peak {run['peak_gb']:.2f} GB against fp32 "
        f"(phase 16) {dict(sorted(fp32_run['ms_by_bucket'].items()))}, peak "
        f"{fp32_run['peak_gb']:.2f} GB on {smi}")
    results["varlen_cli"] = run
    shutil.rmtree(os.path.join(varlen_root, "corpus"), ignore_errors=True)

    # -- (g): accum_steps 5 against 1 on a 5 x 3 s bf16 step, as phase 16 (d)
    # holds the fp32 lane: causal BSS, the loss and the gradients; TSS, whose
    # speaker encoder's BatchNorm normalises each micro-batch by its own
    # statistics (so its loss moves, in either lane), BatchNorm ending with
    # the last micro-batch's update alone
    accum = {}
    for fam, cfg in (("bss_causal", dict(BSS_TRAIN_CONFIG, **RAW_GRADS)),
                     ("tss", dict(TRAIN_CONFIG, **RAW_GRADS))):
        spec, collate, crops, per_step = steps_fams[fam]
        start = init_weights_(spec["model"](), torch.Generator().manual_seed(SEED + 75))
        start = start.state_dict()
        batch = collate(crops(SEED + 76, TRAIN_BATCH, TRAIN_SECONDS).items)
        make = functools.partial(spec["model"], dtype=bf)
        five = _whole_step(torch, dev, make, start, spec["trainer"], dict(cfg, accum_steps=5),
                           batch)
        expect_launches(five["launches"], per_step, 5, f"{fam} bf16 accum_steps 5 step")
        if fam == "tss":
            last = _whole_step(torch, dev, make, start, spec["trainer"], cfg,
                               {k: v[-1:] for k, v in batch.items()})
            err = max(float((five["buffers"][k].double() - last["buffers"][k].double())
                            .abs().max()) for k in last["buffers"])
            res = {"running_stats_max_abs_delta": err, "accum_5": _numbers(five)}
            what = (f"BatchNorm statistics against one step on the last row alone max|delta| "
                    f"{err:.3e}")
            ok = err <= 1e-6
        else:
            one = _whole_step(torch, dev, make, start, spec["trainer"], cfg, batch)
            rel = abs(five["loss"] - one["loss"]) / abs(one["loss"])
            gsnr = _grad_snr(torch, five["grads"], one["grads"])
            res = {"loss_rel": rel, "grad_snr_db": gsnr, "accum_1": _numbers(one),
                   "accum_5": _numbers(five)}
            what = (f"against accum_steps 1: loss rel {rel:.3e}, gradients {gsnr:.2f} dB; "
                    f"accum_steps 1 {one['ms']:.1f} ms / {one['peak_gb']:.2f} GB")
            ok = rel <= BF16_STEP_LOSS_REL and gsnr >= BF16_STEP_GRAD_SNR_DB
        log(f"[bf16] {fam} {TRAIN_BATCH} x {TRAIN_SECONDS} s bf16, accum_steps 5: {what}; "
            f"accum_steps 5 {five['ms']:.1f} ms / {five['peak_gb']:.2f} GB on {smi}")
        if not ok:
            raise AssertionError(f"{fam} bf16 accum_steps: {res}")
        accum[fam] = res
    results["accum"] = accum
    results["save_every"] = _bf16_save_every(torch, dev, smi, steps_fams["tss"],
                                             varlen_state["save_every"])
    return results


def _bf16_save_every(torch, dev, smi, tss, fp32_row):
    """Phase 17 (h): lstm_save_every=SAVE_EVERY in the bf16 lane: the bf16
    want_cs mode against its plain version at D = 2 over the 5 x 3 s step's
    intra shape, timed beside it and the bound; a 5 x 3 s TSS step in both
    lanes (ms of the second step, peak GB) beside phase 16's fp32 row
    (``fp32_row``, the largest variable-length bucket); the bf16 step card vs
    CPU."""
    import functools

    from tss_dprnn_tpu_torch.ops import lstm as L
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    F = H = 128
    D, (R, T) = 2, train_shapes()["intra"]
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 77)
    k = H ** -0.5
    w = [((torch.rand(*s, generator=g) * 2 * k - k)).to(dev).to(bf)
         for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
    x = torch.randn(D, R, T, F, generator=g).to(dev).to(bf)
    h, cs = L.lstm_forward_with_cs(x, *w)
    h2, cs2 = L.lstm_forward_with_cs(x, *w)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(h, h2) and torch.equal(cs, cs2))
    # the bf16 want_resid route's product and arithmetic: the same h
    is_resid = bool(torch.equal(h, L.lstm_forward_resid(x, *w)[0]))
    del h2, cs2
    ph, pcs = L.lstm_cs_reference(x, *w)
    h_err, h_snr = _bf16_streams_close(torch, "h", h, ph)

    def rel(got, want):
        return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())

    cs_err, step_err = rel(cs, pcs), rel(cs, L.lstm_cs_step_reference(x, *w, h, cs))
    if not (cs_err <= CS_FREE_RTOL and step_err <= CS_STEP_RTOL and repeat and is_resid
            and h.dtype == bf and cs.dtype == torch.float32):
        raise AssertionError(f"bf16 want_cs at D={D} R={R} T={T}: cell state max|err| {cs_err} "
                             f"(<= {CS_FREE_RTOL} of max(1, |ref|)), per step {step_err} "
                             f"(<= {CS_STEP_RTOL}), repeats bit for bit {repeat}, h bit for bit "
                             f"lstm_forward_resid's {is_resid}, types {h.dtype} {cs.dtype}")
    del h, cs, ph, pcs
    kernel = {"D": D, "R": R, "T": T, "max_abs_err": h_err, "snr_db": h_snr,
              "cs_max_rel_err": cs_err, "cs_step_max_rel_err": step_err, "bitwise_repeat": repeat,
              "h_is_lstm_forward_resid": is_resid,
              "tile_plan": scan_plan("serve", D, R, H, x.device, bf),
              "ms": time_ms(lambda: L.lstm_forward_with_cs(x, *w), 5),
              "plain_ms": time_ms(lambda: L.lstm_cs_reference(x, *w), 1)}
    kernel["bound_ms"], kernel["bound_by"] = bound_stack("with_cs", D, R, T, F, H, 2, PEAK_BF16)
    del x
    torch.cuda.empty_cache()
    log(f"[bf16] want_cs bf16 D={D} R={R} T={T} ({D} bf16-operand input products + the serving "
        f"scan's cell-state mode, tile plan {kernel['tile_plan']}): {kernel['ms']:.3f} ms (plain "
        f"{kernel['plain_ms']:.1f}, bound {kernel['bound_ms']:.3f} ({kernel['bound_by']})); h "
        f"max|err| {h_err:.3e} SNR {h_snr:.2f} dB, c max|err|/max(1,|ref|) {cs_err:.3e} "
        f"(per step from its own state {step_err:.3e}); repeats bit for bit, h bit for bit "
        f"lstm_forward_resid's")

    spec, collate, crops, _ = tss
    start = init_weights_(spec["model"](), torch.Generator().manual_seed(SEED + 78)).state_dict()
    batch = collate(crops(SEED + 79, TRAIN_BATCH, TRAIN_SECONDS).items)
    config = dict(TRAIN_CONFIG, lstm_save_every=SAVE_EVERY)
    calls = 2 * FLAGSHIP["n_repeats"]
    steps = {}
    for lane, kw in (("fp32", {}), ("bf16", {"dtype": bf})):
        run = _whole_step(torch, dev, functools.partial(spec["model"], **kw), start,
                          spec["trainer"], config, batch)
        expect_launches(run["launches"], save_every_launches(calls, bf16=lane == "bf16"), 1,
                        f"a {lane} lstm_save_every={SAVE_EVERY} 5 x 3 s step")
        steps[lane] = _numbers(run)
    rel, gsnr, launches, _ = _step_card_vs_cpu(torch, dev, lambda: spec["model"](dtype=bf),
                                               start, spec["trainer"], config, batch)
    expect_launches(launches, save_every_launches(calls, bf16=True), 1,
                    "the bf16 lstm_save_every step card vs CPU")
    big = fp32_row[f"save_every_{SAVE_EVERY}"]
    log(f"[bf16] TSS {TRAIN_BATCH} x {TRAIN_SECONDS} s, lstm_save_every {SAVE_EVERY}: bf16 "
        f"{steps['bf16']['ms']:.1f} ms / {steps['bf16']['peak_gb']:.2f} GB against fp32 "
        f"{steps['fp32']['ms']:.1f} ms / {steps['fp32']['peak_gb']:.2f} GB (phase 16's fp32 row, "
        f"{TRAIN_BATCH} x {fp32_row['width']} samples: {big['ms']:.1f} ms / "
        f"{big['peak_gb']:.2f} GB) on {smi}; bf16 card vs CPU: loss rel {rel:.3e}, gradients "
        f"{gsnr:.2f} dB; launches {steps['bf16']['launches']}")
    if not (rel <= BF16_STEP_LOSS_REL and gsnr >= BF16_STEP_GRAD_SNR_DB):
        raise AssertionError(f"bf16 lstm_save_every step card vs CPU: loss rel {rel}, gradients "
                             f"{gsnr:.2f} dB")
    return {"kernel": kernel, "steps_5x3s": steps, "card_vs_cpu": {"loss_rel": rel,
                                                                    "grad_snr_db": gsnr}}


def bf16_kernel_entries(entries, bf16, launches):
    """The kernels line's rows for the bf16 modes that the bf16 lane runs:
    the serving scans' numbers from phases 2 and 7 (this run), the training
    modes' from phase 17 (a), the want_cs mode's from phase 17 (h); launches
    from the bf16 lane's runs (``launches``: per served batch of 8, each scan
    after its input product, per 5 x 3 s train step, the masked training
    modes' over phase 17's variable-length cli.train run, and per
    lstm_save_every step)."""
    out = []
    by = {(e["name"], e.get("mode")): e for e in entries}
    serve = {"route": "cuda", "source": SERVE_SOURCE, "dtype": "bfloat16",
             "with": f"{SERVE_WITH} (the input product, x upcast exactly; one launch per "
                     f"direction of an lstm_forward scan)",
             "cluster": "2 CTAs, W_hh resident in shared memory in bf16; bf16 mma.sync"}
    for name, mode in (("bilstm2_forward", "unmasked"), ("bilstm2_forward_masked", "masked")):
        sub = by[(name, mode)]["bf16"]
        out.append({"name": name, "mode": f"bf16 streams, {mode} (serving)", **serve,
                    "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:698",
                    "launches": launches["serve"].get(name, 0),
                    "max_abs_err": sub["plain_max_abs_err"],
                    **{k: sub[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "snr_db", "plain_snr_db",
                                           "tile_plan", "bitwise_repeat")},
                    "shape": by[(name, mode)]["shape"]})
    lf = next(e for e in entries if e["name"] == "lstm_forward")
    out.append({"name": "lstm_forward", "mode": "bf16 streams, h only, D=1 (causal BSS serving)",
                **serve, "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:57",
                "launches": launches["bss_serve"].get("lstm_forward", 0),
                "max_abs_err": lf["bf16"]["plain_max_abs_err"],
                **{k: lf["bf16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "shape", "snr_db", "plain_snr_db",
                                              "tile_plan", "bitwise_repeat")}})
    cs = bf16["save_every"]["kernel"]
    out.append({"name": "lstm_forward_with_cs",
                "mode": f"bf16 streams, want_cs, D=2 over the 5 x 3 s step's intra shape "
                        f"(lstm_save_every {SAVE_EVERY})",
                "dtype": "bfloat16", "route": "cuda",
                "source": "tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu (mode 4)",
                "with": "tss_dprnn_tpu_torch/csrc/products.cu (the bf16-operand input product, "
                        "one launch per direction)",
                "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:57",
                "launches": launches["save_every"].get("lstm_forward_with_cs", 0),
                "launches_are": "per bf16 lstm_save_every step (5 x 3 s TSS)",
                "library_ms": None,
                "library": "no single cuDNN call: two directions on their own inputs",
                **{key: cs[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "max_abs_err", "snr_db", "cs_max_rel_err",
                                            "bitwise_repeat", "h_is_lstm_forward_resid",
                                            "tile_plan")},
                "shape": {"D": cs["D"], "R": cs["R"], "T": cs["T"], "F": 128, "H": 128}})
    k = bf16["kernels"]

    def numbers(r, which):
        key = "fwd" if which == "forward" else "bwd"
        return {"ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r[f"{key}_bound_ms"], "bound_by": r[f"{key}_bound_by"],
                "library_ms": r[f"cudnn_{key}_ms"],
                "max_abs_err": r["fwd_max_abs_err"] if key == "fwd" else r["dx_max_abs_err"],
                "snr_db": r["fwd_min_snr_db"] if key == "fwd" else r["grad_min_snr_db"],
                "shape": {"D": r["D"], "R": r["R"], "T": r["T"], "F": 128, "H": 128}}

    withs = {"forward": "tss_dprnn_tpu_torch/csrc/products.cu (the bf16-operand input "
                        "product on x as it is)",
             "backward": "tss_dprnn_tpu_torch/csrc/products.cu (dx per direction bf16-operand "
                         "with a bf16 output; dW_ih, dW_hh column-layout bf16 split-K; db's "
                         "column sum)"}
    for name, which, source, replaces, kind, step in (
            ("bilstm2_forward_resid", "forward",
             "tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu (mode 3)",
             "tss_dprnn_tpu/ops/pallas_lstm.py:698", "pair", "tss"),
            ("bilstm2_backward", "backward",
             "tss_dprnn_tpu_torch/csrc/bilstm2_bwd.cu (scan in cluster_scan.cuh, bf16 mma.sync)",
             "tss_dprnn_tpu/ops/pallas_lstm.py:1224", "pair", "tss"),
            ("lstm_forward_resid", "forward",
             "tss_dprnn_tpu_torch/csrc/bilstm2_serve.cu (mode 3)",
             "tss_dprnn_tpu/ops/pallas_lstm.py:57", "stack", "bss_causal"),
            ("lstm_backward", "backward",
             "tss_dprnn_tpu_torch/csrc/lstm_bwd.cu (scan in cluster_scan.cuh, bf16 mma.sync)",
             "tss_dprnn_tpu/ops/pallas_lstm.py:498", "stack", "bss_causal")):
        first = f"{kind}_intra" if kind == "pair" else "stack_inter"
        e = {"name": name, "mode": f"bf16 streams, {which} (training)", "dtype": "bfloat16",
             "route": "cuda", "source": source, "replaces": replaces, "with": withs[which],
             "launches": launches[step].get(name, 0), **numbers(k[first], which)}
        if kind == "pair":
            e["inter"] = numbers(k["pair_inter"], which)
            e["masked"] = dict(numbers(k["pair_masked"], which), name=f"{name}_masked",
                               launches=launches["varlen"].get(f"{name}_masked", 0))
        if which == "backward":
            e["dw_rel_err"] = max(r["dw_rel_err"] for r in k.values() if r["kind"] == kind)
        e["bitwise_repeat"] = all(r["bitwise_repeat"] and r["fwd_bitwise_repeat"]
                                  for r in k.values())
        out.append(e)
    col = dict(bf16["col_product"], path="the bf16 training backward's dW_ih and dW_hh (5 x 3 s "
               "TSS step)", launches=launches["tss"].get("products_gemm_bf16_col", 0),
               launches_bss_causal=launches["bss_causal"].get("products_gemm_bf16_col", 0))
    out.append(col)
    return out


# phase 18: the serving tools. A synthetic WAV of SEPARATE_SECONDS at 8 kHz
# through cli.separate, full length and in windows of SEPARATE_WINDOW_S (hop
# half a window) SEPARATE_BATCH to a forward; card vs CPU on CHECK_SECONDS
# with windows of CHECK_WINDOW_S; the flagship's artifact at EXPORT_BATCH x
# EXPORT_SECS (and batch 1) called on EXPORT_REQUESTS requests of 4-10 s.
SEPARATE_SECONDS = 60
SEPARATE_WINDOW_S = 10
SEPARATE_BATCH = 4
SEPARATE_REF_S = 4
CHECK_SECONDS = 3
CHECK_WINDOW_S = 1
EXPORT_SECS = 10
EXPORT_BATCH = 8
EXPORT_REQUESTS = 3
SEPARATE_CARD_VS_CPU_DB = 50.0
ARTIFACT_FP32_SNR_DB = 60.0

# calls of an artifact, and of the eager forward beside it, timed each
CALL_REPS = 5

# what a fresh process runs to call an artifact: it imports the export
# module alone (no model code), calls the artifact on the requests in
# argv[2], and writes the outputs, the picked buckets, the launches of each
# call, and on the card its wall ms (call_ms: padding, copies and the
# program), the program's device ms on the inputs call() gives it, and one
# profiled call (call_profile), to argv[3]; argv[4] is CALL_REPS
_ARTIFACT_CALLER = r"""
import json, sys, time
import numpy as np
import torch
from tss_dprnn_tpu_torch.inference import export

def counts():
    out = {e.__name__: e.launches for e in (*export.bilstm2.ENTRIES, *export.lstm.ENTRIES)}
    out.update(export.bilstm2.product_launch_counts())
    return out

def reset():
    export.bilstm2.reset_launch_counts()
    export.lstm.reset_launch_counts()

def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()

CALL_REPS = int(sys.argv[4])
t0 = time.perf_counter()
sep = export.load_artifact(sys.argv[1])
load_s = time.perf_counter() - t0
req = np.load(sys.argv[2])
result, arrays = {"load_s": load_s, "calls": {}}, {}
for tag, rows in (("many", slice(None)), ("one", slice(0, 1))):
    args = (req["mix"][rows], req["aux"][rows], req["aux_len"][rows])
    lengths = req["lengths"][rows]
    bucket = sep._pick(*args[0].shape)
    program, seen = sep._fns[bucket], []
    sep._fns[bucket] = lambda *a: seen.append(a) or program(*a)  # the inputs call() gives it
    reset()
    out = sep.call(*args, lengths=lengths)
    sync()
    launches = counts()
    sep._fns[bucket] = program
    arrays[tag] = out
    entry = {"bucket": list(bucket), "launches": launches, "shape": list(out.shape)}
    if torch.cuda.is_available():
        from chip_smoke import call_profile, time_ms, wall_ms

        def run_program():
            with torch.inference_mode():
                return program(*seen[0])

        entry.update(ms=wall_ms(lambda: sep.call(*args, lengths=lengths), CALL_REPS),
                     program_ms=time_ms(run_program, CALL_REPS),
                     profile=call_profile(lambda: sep.call(*args, lengths=lengths)))
    result["calls"][tag] = entry
result["model_code_imported"] = sorted(m for m in sys.modules
                                       if m.startswith("tss_dprnn_tpu_torch.models"))
result["device"] = str(sep.device)
np.savez(sys.argv[3] + ".npz", **arrays)
with open(sys.argv[3] + ".json", "w") as f:
    json.dump(result, f)
"""


def _eager_serving(model, shapes, dev):
    """A ServingModel whose buckets ``shapes`` run ``model``'s eager masked
    forward: ServingModel.call's padding, copies and crop around it."""
    from tss_dprnn_tpu_torch.inference.export import ServingModel

    served = ServingModel({}, {"spe": True, "aux_factor": 1}, dev)
    served.buckets = dict.fromkeys(shapes)
    served._fns = dict.fromkeys(shapes, lambda *a: model(*a[:-1], lengths=a[-1])[0])
    return served


def _separate_run(torch, argv):
    """One cli.separate run: (wall s, every wrapper's launches)."""
    from tss_dprnn_tpu_torch.cli import separate as separate_cli

    reset_launches()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    separate_cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(all_launches(), **product_launches())


def _read_outputs(paths, n_samples):
    """The written WAVs, checked for rate, length and finite values."""
    import numpy as np

    from tss_dprnn_tpu_torch.data import wav

    out = []
    for p in paths:
        data, rate = wav.read(p)
        if rate != SAMPLE_RATE or data.shape != (n_samples,) or not np.isfinite(data).all():
            raise AssertionError(f"{p}: rate {rate}, shape {data.shape}, expected "
                                 f"({n_samples},) at {SAMPLE_RATE} Hz, finite")
        out.append(data)
    return np.stack(out)


def _windows(n_samples: int, window: int, batch: int):
    """The windowed separator's forwards for an input of n_samples."""
    hop = window // 2
    n_win = 1 if n_samples <= window else len(range(0, n_samples - window, hop)) + 1
    return -(-n_win // batch)


def _ms(v) -> str:
    """A device time for the log, or "not measured" (a CPU rehearsal)."""
    return "not measured" if v is None else f"{v:.2f} ms"


def _hold_serve_tools_shapes(torch, dev):
    """The scan shapes phase 18 brings that phase 2 does not hold (the 60 s
    full-length forward, a windowed batch, the artifact's batch-1 bucket):
    each entry on the card against its plain version on the same seeded
    inputs, at phase 2's bars (fp32 max |err| <= 1e-4; bf16 >= 40 dB against
    the fp32 plain version and within BF16_ATOL and BF16_SNR_DB of the bf16
    one). out0 is compared on t < len only where there are lengths."""
    from tss_dprnn_tpu_torch.ops.bilstm2 import (
        bilstm2_forward, bilstm2_forward_masked, bilstm2_reference)

    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    F, H = FLAGSHIP["feature_size"], FLAGSHIP["hidden_size"]

    def chunks(samples):  # encoder frames (samples - 1) -> chunks of K, hop apart
        return (samples - 1 + K) // hop + 1

    g = torch.Generator(device="cpu").manual_seed(SEED + 184)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    S60 = chunks(SEPARATE_SECONDS * SAMPLE_RATE)
    Sw, Se = chunks(SEPARATE_WINDOW_S * SAMPLE_RATE), chunks(EXPORT_SECS * SAMPLE_RATE)
    # one request of 4-10 s in the batch-1 bucket: its chunk count on each of K rows
    utt = chunks(int((float(torch.rand(1, generator=g)) * 0.6 + 0.4) * EXPORT_SECS
                     * SAMPLE_RATE))
    shapes = [
        ("separate full length intra", S60, K, None),
        ("separate full length inter", K, S60, None),
        ("separate windowed intra", SEPARATE_BATCH * Sw, K, None),
        ("separate windowed inter", SEPARATE_BATCH * K, Sw, None),
        ("artifact batch 1 intra", Se, K, None),
        ("artifact batch 1 inter", K, Se, torch.full((K,), utt, dtype=torch.int32, device=dev)),
    ]
    held = []
    for what, R, T, lens in shapes:
        x = torch.randn(R, T, F, generator=g).to(dev)
        valid = None if lens is None else torch.arange(T, device=dev)[None, :] < lens[:, None]

        def run(xx, kernel=True):
            if not kernel:
                return bilstm2_reference(xx, w_ih2, b2, w_hh2, lens)
            if lens is None:
                return bilstm2_forward(xx, w_ih2, b2, w_hh2)
            return bilstm2_forward_masked(xx, lens, w_ih2, b2, w_hh2)

        def region(out):
            o0, o1 = out
            o0 = o0.float() if valid is None else o0.float()[valid]
            return torch.cat([o0.flatten(), o1.float().flatten()])

        ref32 = region(run(x, kernel=False))
        err32 = float((region(run(x)) - ref32).abs().max())
        xb = x.bfloat16()
        got16 = region(run(xb))
        ref16 = region(run(xb, kernel=False))
        row = {"what": what, "entry": "bilstm2_forward" if lens is None
               else "bilstm2_forward_masked", "R": R, "T": T, "max_abs_err": err32,
               "bf16_snr_db": snr_db(got16, ref32),
               "bf16_plain_max_abs_err": float((got16 - ref16).abs().max()),
               "bf16_plain_snr_db": snr_db(got16, ref16)}
        log(f"[serve-tools] {what} {row['entry']} R={R} T={T}: fp32 max|err|={err32:.3e}, "
            f"bf16 SNR {row['bf16_snr_db']:.2f} dB (bf16 plain max|err|="
            f"{row['bf16_plain_max_abs_err']:.3e}, {row['bf16_plain_snr_db']:.2f} dB)")
        if not (err32 <= 1e-4 and row["bf16_snr_db"] >= 40.0
                and row["bf16_plain_max_abs_err"] <= BF16_ATOL
                and row["bf16_plain_snr_db"] >= BF16_SNR_DB):
            raise AssertionError(f"{what}: the kernel disagrees with its plain version: {row}")
        held.append(row)
        del x, xb, ref32, got16, ref16
        torch.cuda.empty_cache()
    return held


def phase_serve_tools(torch, dev, smi, ckpt):
    """Phase 18: cli.separate, cli.export_model and cli.results_table, as the
    module docstring says."""
    import contextlib
    import glob
    import io
    import shutil

    import numpy as np

    from tss_dprnn_tpu_torch.cli import export_model, results_table
    from tss_dprnn_tpu_torch.data import wav
    from tss_dprnn_tpu_torch.inference import export
    from tss_dprnn_tpu_torch.inference.long_audio import bss_windowed, spe_windowed
    from tss_dprnn_tpu_torch.models import DPRNNRawNetTasNet, DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.models.registry import build_model
    from tss_dprnn_tpu_torch.utils.checkpoint import load_model
    from tss_dprnn_tpu_torch.utils.config import load_config, model_config
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    root = os.path.join(OUT_DIR, "serve_tools")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    cfg_dir = os.path.join(HERE, "configs")
    results = {"card": smi}
    if torch.device(dev).type == "cuda":
        results["kernels_at_new_shapes"] = _hold_serve_tools_shapes(torch, dev)

    # -- (a) cli.separate
    rng = np.random.default_rng(SEED + 180)
    n = SEPARATE_SECONDS * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    # two amplitude-modulated noise voices, as a two-speaker mixture
    voices = [0.1 * rng.standard_normal(n) * (0.6 + 0.4 * np.sin(2 * np.pi * f * t))
              for f in (0.7, 1.3)]
    mix = (voices[0] + voices[1]).astype(np.float32)
    ref = (0.1 * rng.standard_normal(SEPARATE_REF_S * SAMPLE_RATE)).astype(np.float32)
    mix_path, ref_path = os.path.join(root, "mix.wav"), os.path.join(root, "ref.wav")
    wav.write(mix_path, mix, SAMPLE_RATE)
    wav.write(ref_path, ref, SAMPLE_RATE)
    mix = wav.read(mix_path)[0]  # as the CLI reads it back
    bss_cfg = load_config(os.path.join(cfg_dir, "test_bss.yaml"))
    ckpts = {"tss_spe": ckpt, "bss": os.path.join(root, "bss_random.pt"),
             "tss_rawnet": os.path.join(root, "rawnet_random.pt")}
    torch.save(init_weights_(build_model(model_config(bss_cfg)),
                             torch.Generator().manual_seed(SEED + 181)).state_dict(), ckpts["bss"])
    torch.save(init_weights_(DPRNNRawNetTasNet(**RAWNET),
                             torch.Generator().manual_seed(SEED + 182)).state_dict(),
               ckpts["tss_rawnet"])
    cli_models = {
        "tss_spe": ("test_tss.yaml", []),
        "bss": ("test_bss.yaml", []),
        "tss_rawnet": ("test_tss.yaml", ["model.target=dprnn_rawnet_tasnet",
                                         "model.embeddings_size=256"]),
    }

    def argv(mode, src, out, extra=()):
        cfg, sets = cli_models[mode]
        a = ["--config", os.path.join(cfg_dir, cfg), "--mode", mode, "--mix", src, "--out", out,
             "--set", f"checkpoint_path={ckpts[mode]}", *sets]
        return a + (["--ref", ref_path] if mode != "bss" else []) + list(extra)

    def outputs(mode, out):
        base = os.path.splitext(out)[0]
        return [f"{base}_s1.wav", f"{base}_s2.wav"] if mode == "bss" else [out]

    sep = {}
    blocks = FLAGSHIP["n_repeats"]
    for mode in ("tss_spe", "bss"):
        runs = {}
        n_blocks = bss_cfg["model"]["n_repeats"] if mode == "bss" else blocks
        for tag, extra in (("full", []), ("windowed", ["--window-secs", str(SEPARATE_WINDOW_S),
                                                        "--batch", str(SEPARATE_BATCH)])):
            out = os.path.join(root, f"{mode}_{tag}.wav")
            # twice: the first run of a shape pays its one-time set-up
            walls = []
            for _ in range(2):
                wall, launches = _separate_run(torch, argv(mode, mix_path, out,
                                                           extra + device_args))
                walls.append(wall)
            forwards = 1 if tag == "full" else _windows(n, SEPARATE_WINDOW_S * SAMPLE_RATE,
                                                        SEPARATE_BATCH)
            # unmasked: every scan of a forward, intra and inter, is bilstm2_forward
            expect_launches(launches, with_products({"bilstm2_forward": 2 * n_blocks}), forwards,
                            f"cli.separate {mode} {tag}")
            est = _read_outputs(outputs(mode, out), n)
            runs[tag] = {"wall_s": wall, "first_wall_s": walls[0],
                         "audio_s_per_s": SEPARATE_SECONDS / wall, "forwards": forwards,
                         "launches": {k: v for k, v in launches.items() if v},
                         "peak": float(np.abs(est).max())}
            log(f"[serve-tools] cli.separate --mode {mode} {tag} ({SEPARATE_SECONDS} s): "
                f"{wall:.3f} s wall ({walls[0]:.3f} s the first run), "
                f"{SEPARATE_SECONDS / wall:.2f} audio-s/s, {forwards} forward(s), launches "
                f"{runs[tag]['launches']} each run, on {smi}")
        sep[mode] = runs

    # an input of one window or less, windowed with a hop of one window
    # (weight 1), is the forward on the zero-padded window, bit for bit
    W = SEPARATE_WINDOW_S * SAMPLE_RATE
    one = {}
    for mode in ("tss_spe", "bss"):
        model = (DPRNNSpeTasNet(**FLAGSHIP) if mode == "tss_spe"
                 else build_model(model_config(bss_cfg)))
        load_model(ckpts[mode], model)
        for T in (W, W - W // 7):
            if mode == "tss_spe":
                got = spe_windowed(model, ref, window=W, hop=W, batch_size=1, device=dev)(mix[:T])
            else:
                got = bss_windowed(model, window=W, hop=W, batch_size=1, device=dev)(mix[:T])
            x = torch.zeros(1, W, device=dev)
            x[0, :T] = torch.from_numpy(mix[:T])
            with torch.inference_mode():
                if mode == "tss_spe":
                    want = model(x, torch.from_numpy(ref)[None].to(dev),
                                 torch.tensor([float(len(ref))], device=dev))[0]
                else:
                    want = model(x)[0]
            want = np.atleast_2d(want.float().cpu().numpy())[:, :T]
            same = bool(np.array_equal(got, want))
            one[f"{mode}_{T}"] = {"bit_for_bit": same,
                                  "max_abs_err": float(np.abs(got - want).max())}
            if not same:
                raise AssertionError(f"{mode}: an input of {T} samples in one window of {W} is "
                                     f"not the forward on the padded window: {one}")
        del model
    log(f"[serve-tools] one window or less, windowed: bit for bit the forward on the padded "
        f"window {one}")

    # card vs CPU through the CLI, on CHECK_SECONDS of the mixture with an
    # 8 kHz reference (resampled to 16 kHz for RawNet)
    short = os.path.join(root, "mix_short.wav")
    wav.write(short, mix[:CHECK_SECONDS * SAMPLE_RATE], SAMPLE_RATE)
    check = {}
    for mode in ("bss", "tss_spe", "tss_rawnet"):
        got = {}
        for where, extra in (("card", device_args), ("cpu", ["--device", "cpu"])):
            out = os.path.join(root, f"check_{mode}_{where}.wav")
            wall, _ = _separate_run(torch, argv(mode, short, out, [
                "--window-secs", str(CHECK_WINDOW_S), *extra]))
            got[where] = (_read_outputs(outputs(mode, out), CHECK_SECONDS * SAMPLE_RATE), wall)
        db = snr_db(torch.from_numpy(got["card"][0]), torch.from_numpy(got["cpu"][0]))
        check[mode] = {"snr_db": db, "card_wall_s": got["card"][1], "cpu_wall_s": got["cpu"][1]}
        if not db >= SEPARATE_CARD_VS_CPU_DB:
            raise AssertionError(f"cli.separate --mode {mode}: card vs CPU {db:.2f} dB < "
                                 f"{SEPARATE_CARD_VS_CPU_DB}")
    log(f"[serve-tools] cli.separate card vs CPU ({CHECK_SECONDS} s, {CHECK_WINDOW_S} s "
        f"windows): " + ", ".join(f"{m} {c['snr_db']:.2f} dB" for m, c in check.items()))
    results["separate"] = dict(sep, one_window=one, card_vs_cpu=check)

    # -- (b) cli.export_model on the flagship: the artifact in a fresh process
    req_rng = np.random.default_rng(SEED + 183)
    lens = (req_rng.uniform(0.4, 1.0, EXPORT_REQUESTS) * EXPORT_SECS
            * SAMPLE_RATE).astype(np.int32)
    t_max = int(lens.max())
    starts = req_rng.integers(0, n - t_max, EXPORT_REQUESTS)
    req_mix = np.zeros((EXPORT_REQUESTS, t_max), np.float32)
    for r, (s0, k) in enumerate(zip(starts, lens)):
        req_mix[r, :k] = mix[s0:s0 + k]
    req = {"mix": req_mix, "aux": np.stack([ref] * EXPORT_REQUESTS),
           "aux_len": np.full(EXPORT_REQUESTS, float(len(ref)), np.float32), "lengths": lens}
    req_path = os.path.join(root, "requests.npz")
    np.savez(req_path, **req)
    T = EXPORT_SECS * SAMPLE_RATE
    on_card = torch.device(dev).type == "cuda"
    eager = {}
    for dtype in ("fp32", "bf16"):  # the eager forward on the padding ServingModel.call gives
        model = DPRNNSpeTasNet(**FLAGSHIP, dtype=None if dtype == "fp32" else torch.bfloat16)
        load_model(ckpt, model)
        model.to(dev).eval()
        # ServingModel.call's host path (padding, copies, crop) around the
        # eager forward in place of an exported program
        served = _eager_serving(model, [(EXPORT_BATCH, T), (1, T)], dev)
        eager[dtype] = {}
        for tag, b in (("many", EXPORT_REQUESTS), ("one", 1)):
            args = (req["mix"][:b], req["aux"][:b], req["aux_len"][:b])
            program = served._fns[served._pick(b, t_max)]
            seen = []
            served._fns[served._pick(b, t_max)] = lambda *a: seen.append(a) or program(*a)
            out = served.call(*args, lengths=lens[:b])
            served._fns[served._pick(b, t_max)] = program
            timing = {}
            if on_card:
                def forward():
                    with torch.inference_mode():
                        return program(*seen[0])

                timing = {"ms": time_ms(forward, CALL_REPS),
                          "call_ms": wall_ms(lambda: served.call(*args, lengths=lens[:b]),
                                             CALL_REPS),
                          "call_profile": call_profile(
                              lambda: served.call(*args, lengths=lens[:b]))}
            eager[dtype][tag] = (out, timing)
        del model, served
    artifacts = {}
    for dtype in ("bf16", "fp32"):
        path = os.path.join(root, f"flagship_{dtype}.tssx")
        timed = []
        real = export.export_separation

        def timed_export(*a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            timed.append(time.perf_counter() - t0)
            return out

        export.export_separation = timed_export
        try:
            t0 = time.perf_counter()
            export_model.main(["--config", os.path.join(cfg_dir, "test_tss.yaml"), "--mode",
                               "tss_spe", "--set", f"checkpoint_path={ckpt}", "--out", path,
                               "--secs", str(EXPORT_SECS), "--batch", str(EXPORT_BATCH),
                               "--dtype", dtype, *device_args])
            wall = time.perf_counter() - t0
        finally:
            export.export_separation = real
        base = os.path.join(root, f"called_{dtype}")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", _ARTIFACT_CALLER, path, req_path, base,
                        str(CALL_REPS)],
                       check=True, cwd=HERE, timeout=600,
                       env=dict(os.environ, PYTHONPATH=HERE + os.pathsep
                                + os.environ.get("PYTHONPATH", "")))
        proc_s = time.perf_counter() - t0
        with open(base + ".json") as f:
            called = json.load(f)
        outs = np.load(base + ".npz")
        if called["model_code_imported"]:
            raise AssertionError(f"the artifact's process imported {called['model_code_imported']}")
        info = {"export_s_per_bucket": timed, "export_cli_wall_s": wall,
                "bytes": os.path.getsize(path), "process_s": proc_s, "load_s": called["load_s"],
                "calls": {}}
        for tag, b in (("many", EXPORT_REQUESTS), ("one", 1)):
            c = called["calls"][tag]
            want_bucket = [EXPORT_BATCH if b > 1 else 1, T]
            if c["bucket"] != want_bucket:
                raise AssertionError(f"{dtype} artifact, {b} request(s): bucket {c['bucket']}, "
                                     f"expected {want_bucket}")
            expect_launches(c["launches"], with_products({"bilstm2_forward": blocks,
                                                          "bilstm2_forward_masked": blocks}), 1,
                            f"{dtype} artifact call ({b} request(s))")
            got = outs[tag]
            ref_out = eager["fp32"][tag][0]
            err = float(np.abs(got - eager[dtype][tag][0]).max())
            db = _valid_snr(torch, torch.from_numpy(got), torch.from_numpy(ref_out),
                            torch.from_numpy(lens[:b]))
            timing = eager[dtype][tag][1]
            entry = {"bucket": c["bucket"], "launches": {k: v for k, v in c["launches"].items()
                                                         if v},
                     "call_ms": c.get("ms"), "program_ms": c.get("program_ms"),
                     "call_profile": c.get("profile"), "eager_ms": timing.get("ms"),
                     "eager_call_ms": timing.get("call_ms"),
                     "eager_call_profile": timing.get("call_profile"),
                     "max_abs_err_vs_eager_same_lane": err,
                     "bit_for_bit_vs_eager_same_lane": err == 0.0,
                     "snr_db_vs_fp32_eager": db}
            bar = ARTIFACT_FP32_SNR_DB if dtype == "fp32" else LANE_SNR_DB
            if not db >= bar:
                raise AssertionError(f"{dtype} artifact, {b} request(s): {db:.2f} dB against the "
                                     f"fp32 eager forward < {bar}")
            info["calls"][tag] = entry
        artifacts[dtype] = info
        log(f"[serve-tools] cli.export_model --dtype {dtype}: export "
            f"{', '.join(f'{s:.2f}' for s in timed)} s per bucket, {info['bytes']} bytes; in a "
            f"fresh process: load {called['load_s']:.2f} s, "
            + "; ".join(f"{tag} request(s) bucket {e['bucket']} call {_ms(e['call_ms'])} "
                        f"(eager through the same host path {_ms(e['eager_call_ms'])}), "
                        f"program {_ms(e['program_ms'])} (eager forward {_ms(e['eager_ms'])}), "
                        f"{e['snr_db_vs_fp32_eager']:.2f} dB vs fp32 eager, max |err| vs "
                        f"eager {e['max_abs_err_vs_eager_same_lane']:.3g}; one call profiled: "
                        f"artifact {e['call_profile']}, eager {e['eager_call_profile']}"
                        for tag, e in info["calls"].items())
            + f" on {smi}")
        os.remove(path)
    results["export"] = artifacts

    # -- (c) cli.results_table over phase 13's final_metrics.json files
    paths = sorted(glob.glob(os.path.join(OUT_DIR, "cli", "**", "final_metrics*.json"),
                             recursive=True))
    if not paths:
        raise AssertionError("no final_metrics.json of phase 13 to render")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results_table.main(paths)
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 2 + len(paths) or lines[0] != "| model | SI-SDR | SI-SDRi | PESQ | STOI |":
        raise AssertionError(f"results_table: {lines}")
    for p, line in zip(paths, lines[2:]):
        with open(p) as f:
            m = json.load(f)
        want = "| " + results_table._label(p) + " | " + " | ".join(
            "—" if m.get(c) is None else f"{m[c]:.2f}" if "stoi" not in c else f"{m[c]:.3f}"
            for c in ("si_sdr", "si_sdr_imp", "pesq", "stoi")) + " |"
        if line != want:
            raise AssertionError(f"results_table row {line!r}, expected {want!r}")
    log("[serve-tools] cli.results_table over phase 13's final_metrics.json:\n"
        + "\n".join(lines))
    results["results_table"] = lines
    shutil.rmtree(root)  # WAVs, checkpoints and outputs: every number is in the results
    return results


# the time-major entries' routes (phase 19): (source, with), per stream type
TM_ROUTES = {
    "serve": {"float32": (SERVE_SOURCE, SERVE_WITH), "bfloat16": (SERVE_SOURCE, SERVE_WITH)},
    "resid": {"float32": ("tss_dprnn_tpu_torch/csrc/bilstm2_resid.cu", SERVE_WITH),
              "bfloat16": (SERVE_SOURCE + " (mode 3)", SERVE_WITH + " (bf16-operand)")},
    "backward": {"float32": ("tss_dprnn_tpu_torch/csrc/bilstm2_bwd.cu", SERVE_WITH),
                 "bfloat16": ("tss_dprnn_tpu_torch/csrc/bilstm2_bwd.cu (bf16 mode)",
                              SERVE_WITH + " (bf16-operand, column layout)")},
}
# fp32 time-major against fp32 batch-major, end to end: the scans are the same
# bit for bit; only the norms' sums run in the other order
TM_LAYOUT_SNR_DB = 80.0
# a train step under TSS_TM=1 against TSS_TM=0: the gradients' bar
TM_GRAD_SNR_DB = 60.0


@contextlib.contextmanager
def env_set(name, value):
    """``with_env`` as a context."""
    restore = with_env(name, value)
    try:
        yield
    finally:
        restore()


def in_turns(fns, reps: int):
    """Device ms of each of two callables, timed in turns A, B, B, A (each
    ``reps`` calls after a warm-up) and averaged: {name: ms}."""
    (a, fa), (b, fb) = fns.items()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[name].append(time_ms(fn, reps))
    return {k: sum(v) / len(v) for k, v in out.items()}


def once_ms(torch, fn):
    """fn() once, with the device ms it took (the plain versions are timed
    by the call that checks the kernel against them)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _tm_kernels(torch, dev):
    """Phase 19 (a): the five time-major entries against their plain
    versions and, bit for bit, against the batch-major route on the
    transposed input, at the flagship's shapes in both stream types; timed
    beside the batch-major route (in turns), the plain version, the bound
    and cuDNN's LSTM on time-major input (batch_first=False)."""
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    F = H = 128
    g = torch.Generator(device="cpu").manual_seed(SEED + 190)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    w = (w_ih2, b2, w_hh2)
    serve = serving_shapes(torch, g, dev)
    train = train_shapes()
    cases = [("serve", "unmasked", *serve["unmasked"]), ("serve", "masked", *serve["masked"]),
             ("train", "intra", *train["intra"], None), ("train", "inter", *train["inter"], None),
             ("train", "masked", *serve["masked"])]
    bm = lambda t: t.transpose(0, 1).contiguous()  # noqa: E731
    lstms = {dt: cudnn_lstm(torch, w_ih2, b2, w_hh2, dt, batch_first=False)
             for dt in (torch.float32, torch.bfloat16)}
    pack = torch.nn.utils.rnn.pack_padded_sequence
    unpack = torch.nn.utils.rnn.pad_packed_sequence
    entries = []
    for kind, mode, R, T, lens in cases:
        masked = lens is not None
        rows_steps = R * T if lens is None else int(lens.sum())
        valid = (torch.ones(T, R, dtype=torch.bool, device=dev) if lens is None
                 else torch.arange(T, device=dev)[:, None] < lens[None, :])  # [T, R]
        x32 = torch.randn(T, R, F, generator=g).to(dev)
        cot32 = [torch.randn(T, R, H, generator=g).to(dev) for _ in range(2)]
        cot32[0] = cot32[0] * valid[..., None]  # out0 past a row's length is unspecified
        lens_cpu = None if lens is None else lens.cpu()
        rows = {}
        for dt, size, peak in ((torch.float32, 4, PEAK_FP32), (torch.bfloat16, 2, PEAK_BF16)):
            x, xb = x32.to(dt), bm(x32.to(dt))
            g0, g1 = (c.to(dt) for c in cot32)
            lstm = lstms[dt]
            xr = x.detach().clone().requires_grad_()
            params = [xr, *lstm.parameters()]

            def library_fwd(xx=xr):
                if lens is None:
                    return lstm(xx)[0]
                return unpack(lstm(pack(xx, lens_cpu, enforce_sorted=False))[0],
                              total_length=T)[0]

            if kind == "serve":
                def tm(xx=x):
                    return (B2.bilstm2_forward_masked_tm(xx, lens, *w) if masked
                            else B2.bilstm2_forward_tm(xx, *w))

                def bmr(xx=xb):
                    return (B2.bilstm2_forward_masked(xx, lens, *w) if masked
                            else B2.bilstm2_forward(xx, *w))

                got, want_bm = tm(), bmr()
                bitwise = all(torch.equal(bm(a), b) for a, b in zip(got, want_bm))
                plain, plain_ms = once_ms(torch, lambda: B2.bilstm2_tm_reference(x, *w, lens))
                pairs = [("out0", got[0], plain[0]), ("out1", got[1], plain[1])]
                grads_pairs = []
                del want_bm
                with torch.no_grad():
                    ms = in_turns({"tm": tm, "bm": bmr}, 5)
                    library_ms = time_ms(lambda: library_fwd(x), 3)
                bound_ms, bound_by = bound(rows_steps, R, T, F, H, size, peak)
                names = ["bilstm2_forward_masked_tm" if masked else "bilstm2_forward_tm"]
                nums = {names[0]: dict(ms=ms["tm"], batch_major_ms=ms["bm"], plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)}
            else:
                def tm_fwd(xx=x):
                    return (B2.bilstm2_forward_resid_masked_tm(xx, lens, *w) if masked
                            else B2.bilstm2_forward_resid_tm(xx, *w))

                def bm_fwd(xx=xb):
                    return (B2.bilstm2_forward_resid_masked(xx, lens, *w) if masked
                            else B2.bilstm2_forward_resid(xx, *w))

                (o0, o1), resid = tm_fwd()
                (p0, p1), presid = bm_fwd()
                bitwise = all(torch.equal(bm(a), b)
                              for a, b in zip((o0, o1, *resid), (p0, p1, *presid)))
                del p0, p1

                def tm_bwd():
                    return B2.bilstm2_backward_tm(x, resid, g0, g1, *w, lens)

                def bm_bwd():
                    return (B2.bilstm2_backward_masked(xb, presid, bm(g0), bm(g1), *w, lens)
                            if masked else B2.bilstm2_backward(xb, presid, bm(g0), bm(g1), *w))

                grads, grads_bm = tm_bwd(), bm_bwd()
                bitwise = bitwise and torch.equal(bm(grads[0]), grads_bm[0])
                dw_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                             for a, b in zip(grads[1:], grads_bm[1:]))
                del grads_bm
                plain_f, plain_f_ms = once_ms(
                    torch, lambda: B2.bilstm2_resid_tm_reference(x, *w, lens))
                (q0, q1), qresid = plain_f
                plain_b, plain_b_ms = once_ms(
                    torch, lambda: B2.bilstm2_backward_tm_reference(x, resid, g0, g1, *w, lens))
                pairs = [("out0", o0, q0), ("out1", o1, q1)] + [
                    (n, a, b) for n, a, b in zip(("hp0", "cp0", "tc0", "hp1", "cp1", "tc1"),
                                                  resid, qresid)]
                if dt == torch.float32:
                    pairs.append(("pre", resid[6], qresid[6]))
                grads_pairs = list(zip(grads, plain_b))
                del presid, qresid
                with torch.no_grad():
                    fwd_ms = in_turns({"tm": tm_fwd, "bm": bm_fwd}, 3)
                    fwd_lib = time_ms(lambda: library_fwd(x), 3)
                _, presid_t = bm_fwd()
                bwd_ms = in_turns({"tm": tm_bwd, "bm": lambda: (
                    B2.bilstm2_backward_masked(xb, presid_t, bm(g0), bm(g1), *w, lens) if masked
                    else B2.bilstm2_backward(xb, presid_t, bm(g0), bm(g1), *w))}, 3)
                del presid_t
                out = library_fwd()
                cot = torch.cat([g0, g1], dim=-1)
                bwd_lib = time_ms(lambda: torch.autograd.grad(out, params, cot, retain_graph=True),
                                  3)
                del out
                if dt == torch.float32:
                    fb = bound_resid(rows_steps, R, T, F, H)
                    bb = bound_backward(rows_steps, R, T, F, H)
                else:
                    fb = bound_bf16_training("forward", 2, rows_steps, R, T, F, H)
                    bb = bound_bf16_training("backward", 2, rows_steps, R, T, F, H)
                fname = ("bilstm2_forward_resid_masked_tm" if masked
                         else "bilstm2_forward_resid_tm")
                names = [fname, "bilstm2_backward_tm"]
                nums = {fname: dict(ms=fwd_ms["tm"], batch_major_ms=fwd_ms["bm"],
                                    plain_ms=plain_f_ms, library_ms=fwd_lib, bound_ms=fb[0],
                                    bound_by=fb[1]),
                        "bilstm2_backward_tm": dict(ms=bwd_ms["tm"], batch_major_ms=bwd_ms["bm"],
                                                    plain_ms=plain_b_ms, library_ms=bwd_lib,
                                                    bound_ms=bb[0], bound_by=bb[1],
                                                    dw_db_rel_to_batch_major=dw_rel)}
                if not dw_rel <= DW_REL_TOL:
                    raise AssertionError(f"time-major backward {mode} {dt}: dW/db {dw_rel} of "
                                         f"max from the batch-major route's")
            # against the plain version, with phase 2's / 5's (fp32) or phase 17's (bf16) bars
            errs = {}
            for name, a, b in pairs:
                live = valid if name != "out1" else slice(None)
                if dt == torch.float32:
                    errs[name] = float((a[live] - b[live]).abs().max())
                    if not errs[name] <= 1e-4:
                        raise AssertionError(f"time-major {kind} {mode} fp32 {name} disagrees "
                                             f"with its plain version: {errs[name]}")
                else:
                    errs[name] = _bf16_streams_close(torch, name, a, b,
                                                     None if name == "out1" else valid)[0]
            if grads_pairs:
                if dt == torch.float32:
                    dx_err = float((grads_pairs[0][0] - grads_pairs[0][1]).abs().max())
                    rel = max(float((a - b).abs().max()) / float(b.abs().max())
                              for a, b in grads_pairs[1:])
                    if not (dx_err <= 1e-4 and rel <= DW_REL_TOL):
                        raise AssertionError(f"time-major backward {mode} fp32 disagrees with "
                                             f"its plain version: dx {dx_err}, dW/db {rel}")
                    errs["dx"], errs["dw_db_rel"] = dx_err, rel
                else:
                    errs["dx"], errs["grad_snr_db"] = _bf16_grads_close(
                        torch, [a for a, _ in grads_pairs], [b for _, b in grads_pairs])
            if not bitwise:
                raise AssertionError(f"time-major {kind} {mode} {dt}: not bit for bit the "
                                     "batch-major route on the transposed input")
            max_err = max(v for n, v in errs.items() if n not in ("grad_snr_db", "dw_db_rel"))
            log(f"[time-major] {kind} {mode} R={R} T={T} {dt}: bit for bit the batch-major "
                f"route (outputs, streams, dx): {bitwise}; vs plain {errs}; " + "; ".join(
                    f"{n} {v['ms']:.3f} ms (batch-major {v['batch_major_ms']:.3f}, plain "
                    f"{v['plain_ms']:.1f}, cuDNN {v['library_ms']:.3f}, bound "
                    f"{v['bound_ms']:.3f} {v['bound_by']})" for n, v in nums.items()))
            for name in names:
                route = TM_ROUTES["serve" if kind == "serve" else
                                  "backward" if name == "bilstm2_backward_tm" else "resid"]
                src, with_ = route["float32" if dt == torch.float32 else "bfloat16"]
                row = dict(nums[name], source=src, max_abs_err=max_err, bitwise_batch_major=bitwise,
                           errors=errs)
                if dt == torch.float32:
                    replaces = ("tss_dprnn_tpu/ops/pallas_lstm.py:1224 (via :1366)"
                                if name == "bilstm2_backward_tm" else
                                "tss_dprnn_tpu/ops/pallas_lstm.py:698 (via "
                                + {"bilstm2_forward_tm": ":1028",
                                   "bilstm2_forward_masked_tm": ":1039",
                                   "bilstm2_forward_resid_tm": ":1213",
                                   "bilstm2_forward_resid_masked_tm": ":1056"}[name] + ")")
                    rows[name] = dict(row, name=name, mode=mode, dtype="float32", route="cuda",
                                      source=src, **{"with": with_}, replaces=replaces,
                                      layout="time-major", shape={"R": R, "T": T, "F": F, "H": H})
                else:
                    rows[name]["bf16"] = dict(row, **{"with": with_})
            del x, xb, g0, g1, xr, params
            torch.cuda.empty_cache()
        entries += rows.values()
        del x32, cot32
        torch.cuda.empty_cache()
    del lstms
    return entries


def _tm_serving(torch, dev, smi, ckpt):
    """Phase 19 (b): the flagship served through InferencerSpe.run in both
    layouts and both lanes (TSS_TM=1 / 0), with the launches of each run;
    the forward of one batch of 8 x 10 s in each, against the fp32
    batch-major lane; the bf16 lane's rate at batch 8 and 32 in both
    layouts, in turns."""
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    n = FLAGSHIP["n_repeats"]
    config = {"checkpoint_path": ckpt, "metrics": ["si_sdr"], "data": {"sample_rate": SAMPLE_RATE},
              "test_savedir": os.path.join(OUT_DIR, "time_major_metrics")}
    ds = Requests(SEED + 191, 8)  # 7 requests of 2-6 s and one of 10 s: one batch
    out, est, layouts = {}, {}, {"tm": "1", "bm": "0"}
    for lane, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP, dtype=dtype), config, device=dev)
        batch, audio = _bf16_batch(torch, "dprnn_spe_tasnet", 8)
        for tag, env in layouts.items():
            with env_set("TSS_TM", env):
                inf.run(ds, batch_size=8, n_buckets=1)  # warm
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inf.run(ds, batch_size=8, n_buckets=1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(all_launches(), **product_launches())
                with torch.inference_mode():
                    est[lane, tag] = inf.forward(batch).float().cpu()
            per_batch = ({"bilstm2_forward_tm": n, "bilstm2_forward_masked_tm": n} if tag == "tm"
                         else {"bilstm2_forward": n, "bilstm2_forward_masked": n})
            expect_launches(launches, with_products(per_batch), 1,
                            f"InferencerSpe.run {lane} {tag} (one batch)")
            out[f"{lane}_{tag}"] = {"run_audio_s_per_s": sum(ds.lengths()) / SAMPLE_RATE / wall,
                                    "launches": {k: v for k, v in launches.items() if v}}
        # the forward's rate in both layouts, in turns: the bf16 lane at
        # batch 8 and 32 (the default's decision), the fp32 lane at 8
        for size in ((8, 32) if lane == "bf16" else (8,)):
            b, a = (batch, audio) if size == 8 else _bf16_batch(torch, "dprnn_spe_tasnet", size)

            def fwd(env, b=b):
                def run():
                    with env_set("TSS_TM", env), torch.inference_mode():
                        inf.forward(b)
                return run

            ms = in_turns({tag: fwd(env) for tag, env in layouts.items()}, 3)
            out[f"{lane}_batch{size}"] = dict(
                {f"audio_s_per_s_{t}": a / (v / 1e3) for t, v in ms.items()}, audio_s=a, ms=ms)
            log(f"[time-major] {lane} flagship batch of {size} ({a:.2f} audio-s) in turns: "
                f"time-major {a / ms['tm'] * 1e3:.2f} against batch-major "
                f"{a / ms['bm'] * 1e3:.2f} audio-s/s on {smi}")
            del b
        del inf
        torch.cuda.empty_cache()
    lengths = torch.from_numpy(batch["lengths"])
    ref = est["fp32", "bm"]
    snrs = {"fp32_tm_vs_fp32_bm": _valid_snr(torch, est["fp32", "tm"], ref, lengths),
            "bf16_tm_vs_fp32_bm": _valid_snr(torch, est["bf16", "tm"], ref, lengths),
            "bf16_bm_vs_fp32_bm": _valid_snr(torch, est["bf16", "bm"], ref, lengths),
            "bf16_tm_vs_bf16_bm": _valid_snr(torch, est["bf16", "tm"], est["bf16", "bm"],
                                             lengths)}
    out["snr_db"] = snrs
    log(f"[time-major] flagship 8 x 10 s: {snrs}; InferencerSpe.run audio-s/s "
        f"{ {k: round(v['run_audio_s_per_s'], 2) for k, v in out.items() if 'run_audio_s_per_s' in v} }"
        f" on {smi}")
    if not (snrs["fp32_tm_vs_fp32_bm"] >= TM_LAYOUT_SNR_DB
            and snrs["bf16_tm_vs_fp32_bm"] >= LANE_SNR_DB):
        raise AssertionError(f"time-major serving: {snrs} (fp32 >= {TM_LAYOUT_SNR_DB} dB, bf16 "
                             f">= {LANE_SNR_DB} dB against the fp32 batch-major lane)")
    return out


def _tm_steps(torch, dev):
    """Phase 19 (c): one 5 x 3 s TSS train step under TSS_TM=1 against
    TSS_TM=0, fp32 and bf16, on rows of 3 s and shorter (so the inter scans
    run masked: every training entry of the lane): loss within 1e-4
    relative, gradients >= TM_GRAD_SNR_DB, the time-major training entries'
    launches, ms of a second step."""
    import numpy as np

    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    n = FLAGSHIP["n_repeats"]
    T = TRAIN_SECONDS * SAMPLE_RATE
    batch = loader.make_collate_spe_eval(ref_pad_to=5 * SAMPLE_RATE)(
        Crops(SEED + 192, TRAIN_BATCH, TRAIN_SECONDS).items, T)
    batch["lengths"] = np.array([T, 21000, 17500, T, 12345], np.int32)
    past = np.arange(T)[None, :] >= batch["lengths"][:, None]
    for key in ("mix", "target"):
        batch[key] = np.where(past, 0, batch[key]).astype(np.float32)
    start = init_weights_(DPRNNSpeTasNet(**FLAGSHIP),
                          torch.Generator().manual_seed(SEED + 193)).state_dict()
    config = dict(TRAIN_CONFIG, **RAW_GRADS)
    out = {}
    for lane, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        steps = {}
        for tag, env in (("bm", "0"), ("tm", "1")):
            with env_set("TSS_TM", env):
                steps[tag] = _whole_step(torch, dev, lambda: DPRNNSpeTasNet(**FLAGSHIP, dtype=dtype),
                                         start, TrainerSpe, config, batch)
        tm, bm_ = steps["tm"], steps["bm"]
        rel = abs(tm["loss"] - bm_["loss"]) / abs(bm_["loss"])
        gsnr = _grad_snr(torch, tm["grads"], bm_["grads"])
        pair = {"bilstm2_forward_resid_tm": n, "bilstm2_forward_resid_masked_tm": n,
                "bilstm2_backward_tm": 2 * n}
        want = (with_products(pair, bf16=True) if dtype is not None
                else dict(pair, products_gemm=2 * n * 5, products_colsum=2 * n))
        expect_launches(tm["launches"], want, 1, f"a {lane} TSS step under TSS_TM=1")
        log(f"[time-major] 5 x 3 s TSS step {lane}: TSS_TM=1 {tm['ms']:.1f} ms / "
            f"{tm['peak_gb']:.2f} GB against TSS_TM=0 {bm_['ms']:.1f} ms / {bm_['peak_gb']:.2f} "
            f"GB; loss rel {rel:.3e}, gradients {gsnr:.2f} dB")
        if not (rel <= 1e-4 and gsnr >= TM_GRAD_SNR_DB):
            raise AssertionError(f"time-major {lane} step against batch-major: loss rel {rel}, "
                                 f"gradients {gsnr} dB (>= {TM_GRAD_SNR_DB})")
        out[lane] = {"tm": _numbers(tm), "bm": _numbers(bm_), "loss_rel": rel, "grad_snr_db": gsnr}
    return out


def _tm_export(torch, dev, ckpt):
    """Phase 19 (d): one bucket (8 x 10 s, fp32) exported with TSS_TM=1: 6 +
    6 time-major operator nodes; saved, loaded and called on 3 requests,
    bit for bit the eager time-major forward on the same padding."""
    import numpy as np

    from tss_dprnn_tpu_torch.inference import export
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.checkpoint import load_model

    n = FLAGSHIP["n_repeats"]
    T = EXPORT_SECS * SAMPLE_RATE
    model = DPRNNSpeTasNet(**FLAGSHIP)
    load_model(ckpt, model)
    model = model.to(dev).eval()
    path = os.path.join(OUT_DIR, "time_major.tssx")
    with env_set("TSS_TM", "1"):
        t0 = time.perf_counter()
        exp = export.export_separation(model, EXPORT_BATCH, T)
        export_s = time.perf_counter() - t0
        calls = [str(node.target) for node in exp.graph.nodes if node.op == "call_function"
                 and "tss_dprnn_tpu_torch" in str(node.target)]
        want_calls = ["tss_dprnn_tpu_torch.bilstm2_forward_tm.default",
                      "tss_dprnn_tpu_torch.bilstm2_forward_masked_tm.default"] * n
        if calls != want_calls:
            raise AssertionError(f"the time-major export's operator nodes: {calls}")
        export.save_artifact(path, [exp], {"spe": True, "aux_factor": 1,
                                           "device": torch.device(dev).type,
                                           "sample_rate": SAMPLE_RATE})
        sep = export.load_artifact(path)
        rng = np.random.default_rng(SEED + 194)
        lengths = np.array([T, 61 * T // 80, T // 2 + 123], np.int32)
        mix = (0.1 * rng.standard_normal((3, T))).astype(np.float32)
        aux = (0.1 * rng.standard_normal((3, 3 * T // 8))).astype(np.float32)
        aux_len = np.array([3 * T // 8, 3 * T // 10, T // 5], np.float32)
        reset_launches()
        got = sep.call(mix, aux, aux_len, lengths=lengths)
        launches = dict(all_launches(), **product_launches())
        expect_launches(launches, with_products({"bilstm2_forward_tm": n,
                                                 "bilstm2_forward_masked_tm": n}), 1,
                        "the time-major artifact's call")
        pad = EXPORT_BATCH - 3
        args = [np.pad(mix, ((0, pad), (0, 0))),
                np.pad(aux, ((0, pad), (0, T - aux.shape[1]))),
                np.append(aux_len, [float(T)] * pad).astype(np.float32),
                np.append(lengths, [T] * pad).astype(np.int32)]
        with torch.inference_mode():
            t = [torch.from_numpy(a).to(dev) for a in args]
            want = model(*t[:3], lengths=t[3])[0].float().cpu().numpy()[:3]
    os.remove(path)
    want = want[:, None] if got.ndim == 3 else want
    bitwise = bool(np.array_equal(got, want[..., :got.shape[-1]]))
    log(f"[time-major] fp32 artifact of one {EXPORT_BATCH} x {EXPORT_SECS} s bucket exported "
        f"with TSS_TM=1 in {export_s:.2f} s: {len(calls)} time-major operator nodes; its call "
        f"bit for bit the eager time-major forward: {bitwise}")
    if not bitwise:
        raise AssertionError("the time-major artifact's call differs from the eager forward")
    return {"export_s": export_s, "nodes": len(calls), "bitwise_eager": bitwise,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_time_major(torch, dev, smi, ckpt):
    """Phase 19: the time-major lane, as the module docstring says."""
    results = {"card": smi, "kernels": _tm_kernels(torch, dev)}
    results["serving"] = _tm_serving(torch, dev, smi, ckpt)
    results["steps"] = _tm_steps(torch, dev)
    results["export"] = _tm_export(torch, dev, ckpt)
    return results


# data parallelism (phase 20): torch.distributed.run over the CLIs and the
# trainer. NCCL takes one process per card, so on one card world size 1 runs
# on NCCL and two processes share the card through gloo (CUDA tensors)
DDP_CHILD = os.path.abspath(__file__)  # the script torch.distributed.run starts
DDP_STEPS = 3
DDP_BATCH = 4  # (c)'s global batch: 2 crops of 3 s per process
# (c): two processes against one over the same global batches. The losses
# (the processes' mean) within this of one process's; the first step's
# gradients (averaged by DDP, clipped) at DDP_GRAD_SNR_DB of one process's:
# fp32 sums over halves of the batch and the all-reduce's order; the
# parameters' moves over DDP_STEPS Adam steps at DDP_MOVE_SNR_DB (Adam moves
# an element by ~lr whatever its gradient's size, so an element whose
# gradient is rounding noise around 0 may move the other way)
DDP_LOSS_REL = 1e-5
DDP_GRAD_SNR_DB = 60.0
DDP_MOVE_SNR_DB = 30.0
DDP_TIMEOUT = 600


def _torchrun(nproc: int, jobs, out: str, argvs, gloo: bool = False):
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc``
    over this script's ``--ddp-child``, which runs ``jobs`` in turn, each on
    its arguments in ``argvs``; its output to ``out``. Returns each
    process's results by job and the wall seconds. Raises with the output's
    tail when it fails; on a timeout stops the launcher, which stops its
    processes."""
    import signal

    tag = "+".join(jobs)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), DDP_CHILD, "--ddp-child", tag, out] + (["--gloo"] if gloo else []) + \
        [a for argv in argvs for a in ("--", *argv)]
    path = os.path.join(out, f"{tag}_{nproc}.log")
    # every process is on this host: gloo on the loopback device (the address
    # the host name resolves to may not carry gloo's pairs)
    env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    t0 = time.perf_counter()
    with open(path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=HERE, env=env,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DDP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.terminate()  # the launcher passes SIGTERM on to its processes
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(path) as f:
            raise AssertionError(f"torch.distributed.run ({nproc} x {tag}) exited {rc}:\n"
                                 f"{f.read()[-6000:]}")
    results = []
    for rank in range(nproc):
        with open(os.path.join(out, f"{tag}_rank{rank}of{nproc}.json")) as f:
            results.append(json.load(f))
    return results, wall


def _ddp_steps(torch, dev, out, model_axis: int = 1):
    """DDP_STEPS flagship TSS train steps over global batches of DDP_BATCH
    crops (this process's rows of each, in a process group; with
    ``model_axis`` > 1 under ``make_mesh(model=model_axis)``, each process
    on its data index's rows): the state after them and the first step's
    gradients, whole, to ``out``; each step's ms and loss, and under the
    mesh the elements this process holds of the sharded parameters."""
    from tss_dprnn_tpu_torch import parallel
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    mesh = parallel.make_mesh(model=model_axis) if model_axis > 1 else None
    shares = {} if mesh is None else dict(process_index=mesh.data_index,
                                          process_count=mesh.data)
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(SEED + 60))
    trainer = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=os.path.join(
        out, "unused_chkpts")), device=dev, mesh=mesh)
    batches = loader.TrainLoader(Crops(SEED + 61, DDP_BATCH * DDP_STEPS), DDP_BATCH,
                                 loader.collate_spe, seed=SEED, prefetch=0, **shares)
    ms, losses, grads = [], [], None
    for _, batch in zip(range(DDP_STEPS), batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        if grads is None:
            grads = {k: p.grad for k, p in trainer.model.named_parameters()}
            if trainer.shards is not None:
                grads.update(trainer.shards.gather(grads))
            grads = {k: g.detach().cpu().clone() for k, g in grads.items()}
    state = {k: v.detach().cpu() for k, v in trainer.full_state_dict().items()}
    path = os.path.join(out, f"{'mesh' if mesh else 'steps'}_rank{parallel.process_index()}"
                             f"of{parallel.process_count()}.pt")
    torch.save({"state": state, "grads": grads}, path)
    result = {"ms": ms, "losses": losses, "path": path, "ddp": trainer.ddp is not None}
    if trainer.shards is not None:
        held, whole = trainer.shards.sharded_numel
        result["sharded"] = {"mesh": mesh.shape, "tensors": len(trainer.shards.slots),
                             "held": held, "whole": whole,
                             "parameters": sum(p.numel() for p in trainer.model.parameters())}
    return result


def _ddp_exact(torch):
    """In a process group of one (NCCL): a flagship 5 x 3 s train step
    through DDP and through the model alone, in turns (ms each); one
    forward and backward through each with cuDNN deterministic (are the
    gradients equal bit for bit?); and two through the model alone with
    cuDNN's defaults (the gradients that differ, and by how much)."""
    from tss_dprnn_tpu_torch import parallel
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    parallel.initialize_distributed()
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(SEED + 62))
    trainer = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=os.path.join(
        OUT_DIR, "scaling", "unused_chkpts")), device=resolve_device())
    ddp = trainer.ddp
    crops = Crops(SEED + 63, TRAIN_BATCH)
    batch = loader.collate_spe([crops[i] for i in range(TRAIN_BATCH)])

    def step(through):
        trainer.ddp = ddp if through else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def grads(through):
        trainer.ddp = ddp if through else None
        trainer.model.train()
        trainer.optimizer.zero_grad()
        with trainer._scans(train=True):
            loss, _ = trainer._forward_loss(trainer._to_device(batch), train=True)
            loss.backward()
        return {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}

    for through in (True, False, True, False):  # warm-up
        step(through)
    ms = {True: [], False: []}
    for _ in range(2):
        for through in (True, False, False, True):
            ms[through].append(step(through))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        via_ddp, alone = grads(True), grads(False)
    finally:
        torch.backends.cudnn.deterministic = saved
    first, second = grads(False), grads(False)
    trainer.ddp = ddp
    parallel.leave_group()
    return {"ms_ddp": ms[True], "ms_plain": ms[False],
            "grads_bitwise": all(torch.equal(via_ddp[k], v) for k, v in alone.items()),
            "repeat_differing": {k: float((first[k] - v).abs().max())
                                 for k, v in second.items() if not torch.equal(first[k], v)},
            "n_grads": len(first)}


def ddp_child(argv) -> int:
    """One process that phase 20's torch.distributed.run starts: ``JOBS OUT
    [--gloo] -- ARGS [-- ARGS ...]``, one ARGS per job of the comma-separated
    JOBS. With ``--gloo`` it joins the group through gloo on the card first
    (two processes on one card); then, in turn, ``train`` runs cli.train
    ARGS, ``test`` cli.test ARGS, ``exact`` the checks of :func:`_ddp_exact`
    (no ARGS), ``steps`` the flagship steps of (c) on the device ARGS names,
    ``mesh`` those steps under a mesh of the processes as one model group.
    Each job's launches, counted from 0 at its start, and
    what it saw go to OUT/JOBS_rank<r>of<W>.json."""
    import torch

    sys.path.insert(0, HERE)
    from tss_dprnn_tpu_torch import parallel

    tag, out, rest = argv[0], argv[1], argv[2:]
    gloo = rest[:1] == ["--gloo"]
    groups = []
    for a in rest[int(gloo):]:
        if a == "--":
            groups.append([])
        else:
            groups[-1].append(a)
    jobs = tag.split("+")
    if len(groups) != len(jobs):
        raise ValueError(f"{len(jobs)} jobs, {len(groups)} argument lists")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if gloo:
        parallel.initialize_distributed(backend="gloo", device="cuda")
    results = {}
    for job, args in zip(jobs, groups):
        reset_launches()
        t0 = time.perf_counter()
        if job == "train":
            from tss_dprnn_tpu_torch.cli import train as train_cli

            with recorded_training(torch) as rec:
                train_cli.main(args)
            ddp = [m for m in rec.lines.messages if m.startswith("DistributedDataParallel over")]
            result = {"step_ms": rec.step_ms, "epochs": rec.epochs,
                      "eval_steps": rec.eval_steps, "mixture_passes": rec.mixture_passes,
                      "ddp": bool(ddp), "ddp_line": ddp}
        elif job == "test":
            from tss_dprnn_tpu_torch.cli import test as test_cli

            result = {"final": test_cli.main(args)}
        elif job == "steps":
            result = _ddp_steps(torch, args[0], out)
        elif job == "mesh":
            result = _ddp_steps(torch, args[0], out, model_axis=world)
        elif job == "exact":
            result = _ddp_exact(torch)
        else:
            raise ValueError(f"unknown job {job!r}")
        torch.cuda.synchronize()
        results[job] = dict(result, wall_s=time.perf_counter() - t0,
                            launches=dict(all_launches(), **product_launches()))
    with open(os.path.join(out, f"{tag}_rank{rank}of{world}.json"), "w") as f:
        json.dump(dict(results, rank=rank, world=world), f)
    if gloo:
        parallel.leave_group()
    return 0


def _move_snr_db(torch, got, want, start):
    """The SNR of one run's parameter moves (after - ``start``) against
    another's, over every float tensor."""
    keys = [k for k, v in want.items() if v.is_floating_point()]
    moved = torch.cat([(want[k] - start[k]).flatten().double() for k in keys])
    err = torch.cat([(got[k] - want[k]).flatten().double() for k in keys])
    return float(10 * math.log10(moved.pow(2).sum() / err.pow(2).sum().clamp_min(1e-300)))


def _mesh_steps(torch, smi, runs, alone, ref, start, per_step):
    """Phase 20 (d): the two processes' steps as a 1 x 2 mesh against (c)'s
    one process (``alone``, its state and gradients ``ref``, the weights
    before ``start``): each process's launches one process's, its slices of
    the sharded parameters, the whole states bit for bit equal, the losses,
    first-step gradients and moves at (c)'s bars."""
    parts = [torch.load(r["path"], weights_only=True) for r in runs]
    same = all(torch.equal(parts[0]["state"][k], parts[1]["state"][k])
               for k in parts[0]["state"])
    if not same or any(r["ddp"] for r in runs):
        raise AssertionError(f"1 x 2 mesh: whole states equal {same}, DDP "
                             f"{[r['ddp'] for r in runs]}")
    for r in runs:
        expect_launches(r["launches"], per_step, DDP_STEPS, "flagship steps under a 1 x 2 mesh")
    sharded = [r["sharded"] for r in runs]
    losses = runs[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, alone["losses"]))
    grad_snr = snr_db(torch.cat([parts[0]["grads"][k].flatten() for k in ref["grads"]]),
                      torch.cat([g.flatten() for g in ref["grads"].values()]))
    move_snr = _move_snr_db(torch, parts[0]["state"], ref["state"], start)
    launches = [{k: v for k, v in r["launches"].items() if v} for r in runs]
    log(f"[scaling] (d) {DDP_STEPS} flagship TSS steps at global batch {DDP_BATCH} under a "
        f"1 x 2 data x model mesh, two processes on one card (gloo; {runs[0]['wall_s']:.1f} s "
        f"in process 0, trainer and weights included): each process holds "
        f"{[s['held'] for s in sharded]} of the {sharded[0]['whole']} elements of "
        f"{sharded[0]['tensors']} sharded parameters ({sharded[0]['parameters']} elements held "
        f"in all by process 0); ms per step (process 0) {[round(v, 1) for v in runs[0]['ms']]} "
        f"against one process's {[round(v, 1) for v in alone['ms']]} on {smi}; the whole "
        f"states bit for bit equal; against one process: losses {losses} / {alone['losses']} "
        f"(max rel {loss_rel:.2e}), first-step gradients {grad_snr:.2f} dB, parameter moves "
        f"{move_snr:.2f} dB; launches by process {launches}")
    if not (loss_rel <= DDP_LOSS_REL and grad_snr >= DDP_GRAD_SNR_DB
            and move_snr >= DDP_MOVE_SNR_DB):
        raise AssertionError(f"1 x 2 mesh against one process: loss rel {loss_rel}, gradients "
                             f"{grad_snr:.2f} dB, moves {move_snr:.2f} dB")
    for r in runs:
        os.remove(r["path"])
    return {"wall_s": [r["wall_s"] for r in runs], "ms": [r["ms"] for r in runs],
            "ms_one_process": alone["ms"], "sharded": sharded, "losses": losses,
            "losses_one_process": alone["losses"], "loss_rel": loss_rel,
            "grad_snr_db": grad_snr, "move_snr_db": move_snr, "launches": launches}


def phase_scaling(torch, dev, smi, cli_state):
    """Phase 20: data parallelism, as the module docstring says."""
    import shutil

    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.models.registry import build_model
    from tss_dprnn_tpu_torch.utils.config import load_config, model_config
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    root = os.path.join(OUT_DIR, "scaling")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cli_root = os.path.join(OUT_DIR, "cli")
    manifests, best = cli_state["manifests"], cli_state["best_checkpoint"]
    device_args = [] if torch.device(dev).type == "cuda" else ["--device", str(dev)]
    card = ["--device", "cuda:0"] if torch.device(dev).type == "cuda" else device_args
    results = {"card": smi}
    torch.cuda.empty_cache()

    def train_argv(ckpt_dir):  # phase 13's cli.train
        return ["--config", os.path.join(HERE, "configs", "train_tss.yaml"), "--mode",
                "tss_spe", "--set", f"data.use_generated_train={manifests['train']}",
                f"data.use_generated_eval={manifests['eval']}", "epochs=2",
                f"logs.metadata.ids=[{', '.join(map(str, CLI_IDS))}]",
                f"new_checkpoints_path={ckpt_dir}", *device_args]

    def test_argv(savedir, world, extra):  # phase 13's si_sdr cli.test
        return ["--config", os.path.join(HERE, "configs", "test_tss.yaml"), "--mode",
                "tss_spe", "--batch-size", "4", "--n-buckets", "2", "--data-parallel",
                str(world), "--set", f"data.use_generated_test={manifests['test']}",
                f"checkpoint_path={best}", f"test_savedir={savedir}", "metrics=[si_sdr]",
                *extra]

    # -- (a) and (b): cli.train, then cli.test --data-parallel 1, under the
    # launcher at world size 1 (NCCL), then the checks of _ddp_exact
    name, plain = os.path.basename(best), cli_state["train"]
    ckpt_dir = os.path.join(root, "chkpts")
    (one,), wall = _torchrun(1, ["train", "test", "exact"], root,
                             [train_argv(ckpt_dir),
                              test_argv(os.path.join(root, "eval_1"), 1, device_args), []])
    ddp, exact = one["train"], one["exact"]
    expect_launches(ddp["launches"], plain["launches"], 1, "cli.train with phase 13's launches")
    if not ddp["ddp"] or len(ddp["epochs"]) != 4 or \
            not all(math.isfinite(v) for _, v in ddp["epochs"]):
        raise AssertionError(f"cli.train: DDP {ddp['ddp']}, epochs {ddp['epochs']}")
    if name not in os.listdir(ckpt_dir):
        raise AssertionError(f"cli.train wrote {sorted(os.listdir(ckpt_dir))}, phase 13 kept "
                             f"{name}")
    steady = sorted(ddp["step_ms"][1:])
    ms_step = steady[len(steady) // 2]
    got = torch.load(os.path.join(ckpt_dir, name), map_location="cpu", weights_only=True)["model"]
    want = torch.load(best, map_location="cpu", weights_only=True)["model"]
    shutil.rmtree(ckpt_dir)
    train_cfg = load_config(train_argv("")[1])  # cli.train's weights, from the config's seed
    start = init_weights_(build_model(model_config(train_cfg)), torch.Generator().manual_seed(
        int(train_cfg.get("seed", 0)))).state_dict()
    held = {"bitwise": all(torch.equal(got[k], v) for k, v in want.items()),
            "max_diff": max(float((got[k].double() - v.double()).abs().max())
                            for k, v in want.items()),
            "move_snr_db": _move_snr_db(torch, got, want, start)}
    med = {k: sorted(exact[k])[len(exact[k]) // 2] for k in ("ms_ddp", "ms_plain")}
    log(f"[scaling] (a) cli.train under torch.distributed.run --nproc_per_node 1 "
        f"({ddp['ddp_line']}; {ddp['wall_s']:.1f} s in the process): train steps "
        f"{[round(v, 2) for v in ddp['step_ms']]} ms, median after the first {ms_step:.2f} ms "
        f"against phase 13's {plain['ms_per_step']:.2f} on {smi}; epoch losses "
        f"{ddp['epochs']} (phase 13: {plain['epochs']}); its {name} against phase 13's: "
        f"{held}; launches as phase 13's "
        f"{ {k: v for k, v in ddp['launches'].items() if v} }")
    log(f"[scaling] (a) in the same process: a 5 x 3 s train step through DDP "
        f"{[round(v, 2) for v in exact['ms_ddp']]} ms (median {med['ms_ddp']:.2f}) against the "
        f"model alone {[round(v, 2) for v in exact['ms_plain']]} (median {med['ms_plain']:.2f}) "
        f"in turns on {smi}; its gradients through DDP with cuDNN deterministic "
        f"{'bit for bit' if exact['grads_bitwise'] else 'NOT equal to'} the model's own; with "
        f"cuDNN's defaults two passes from the same weights differ in "
        f"{len(exact['repeat_differing'])} of {exact['n_grads']} gradients "
        f"{exact['repeat_differing']} (so two training runs differ, as the checkpoints do)")
    if not exact["grads_bitwise"] or held["move_snr_db"] < DDP_MOVE_SNR_DB:
        raise AssertionError(f"world size 1 against one process: gradients through DDP equal "
                             f"{exact['grads_bitwise']}, checkpoint {held}")
    results["train_world1"] = {
        "launch_wall_s": wall, "wall_s": ddp["wall_s"], "step_ms": ddp["step_ms"],
        "ms_per_step": ms_step, "plain_ms_per_step": plain["ms_per_step"],
        "ddp_line": ddp["ddp_line"], "epochs": ddp["epochs"], "checkpoint": name,
        "held": held, "launches": ddp["launches"], "in_turns": dict(exact, medians=med)}

    n = FLAGSHIP["n_repeats"]
    per_batch = with_products({"bilstm2_forward": n, "bilstm2_forward_masked": n})
    n_batches = cli_state["test_tss"]["n_batches"]
    want_rows = _csv_rows(os.path.join(cli_root, "metrics_si_sdr", "all_metrics.csv"))
    ev = one["test"]
    expect_launches(ev["launches"], per_batch, n_batches, "cli.test --data-parallel 1")
    rows = _csv_rows(os.path.join(root, "eval_1", "all_metrics.csv"))
    worst = _rows_within(rows, want_rows, {"si_sdr": CLI_ROW_TOL["si_sdr"]},
                         "cli.test --data-parallel 1 against phase 13")
    log(f"[scaling] (b) cli.test --data-parallel 1 under the launcher ({ev['wall_s']:.2f} s in "
        f"the process; the launch of (a) and (b) {wall:.1f} s): {len(rows)} rows, against "
        f"phase 13's {'bit for bit' if rows == want_rows else f'worst {worst}'}; final "
        f"{ev['final']}; launches { {k: v for k, v in ev['launches'].items() if v} }")
    results["test_world1"] = {"wall_s": ev["wall_s"], "final": ev["final"],
                              "rows_bitwise": rows == want_rows, "worst": worst,
                              "launches": ev["launches"]}

    # -- (c) two processes on the one card through gloo (NCCL takes one process
    # per card): flagship steps against one process, then cli.test --data-parallel 2;
    # (d) the same steps with the two processes as a 1 x 2 mesh
    savedir = os.path.join(root, "eval_2")
    pair, wall = _torchrun(2, ["steps", "test", "mesh"], root,
                           [[card[1]], test_argv(savedir, 2, card), [card[1]]], gloo=True)
    steps = [p["steps"] for p in pair]
    parts = [torch.load(r["path"], weights_only=True) for r in steps]
    same = all(torch.equal(parts[0]["state"][k], parts[1]["state"][k])
               for k in parts[0]["state"])
    if not (same and all(r["ddp"] for r in steps)):
        raise AssertionError(f"two processes on one card: parameters equal {same}, DDP "
                             f"{[r['ddp'] for r in steps]}")
    alone = _ddp_steps(torch, dev, root)
    ref = torch.load(alone["path"], weights_only=True)
    start = init_weights_(DPRNNSpeTasNet(**FLAGSHIP),
                          torch.Generator().manual_seed(SEED + 60)).state_dict()
    losses = [(a + b) / 2 for a, b in zip(steps[0]["losses"], steps[1]["losses"])]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, alone["losses"]))
    grad_snr = snr_db(torch.cat([parts[0]["grads"][k].flatten() for k in ref["grads"]]),
                      torch.cat([g.flatten() for g in ref["grads"].values()]))
    move_snr = _move_snr_db(torch, parts[0]["state"], ref["state"], start)
    max_diff = max(float((parts[0]["state"][k].double() - v.double()).abs().max())
                   for k, v in ref["state"].items() if v.is_floating_point())
    fam = training_family("tss")
    per_step = dict(fam["per_train_step"], **fam["products_per_train_step"])
    for r in steps:  # each process runs the whole model on its rows
        expect_launches(r["launches"], per_step, DDP_STEPS, "flagship steps of one process")
    launches = [{k: v for k, v in r["launches"].items() if v} for r in steps]
    log(f"[scaling] (c) {DDP_STEPS} flagship TSS steps at global batch {DDP_BATCH}, two "
        f"processes on one card (gloo; the launch, with cli.test below, {wall:.1f} s): ms per "
        f"step (process 0) {[round(v, 1) for v in steps[0]['ms']]} against one process's "
        f"{[round(v, 1) for v in alone['ms']]} on {smi}; the processes' parameters bit for "
        f"bit equal; against one process: losses {losses} / {alone['losses']} (max rel "
        f"{loss_rel:.2e}), first-step gradients {grad_snr:.2f} dB, parameter moves "
        f"{move_snr:.2f} dB, max |param diff| {max_diff:.3e}; launches by process {launches}")
    if not (loss_rel <= DDP_LOSS_REL and grad_snr >= DDP_GRAD_SNR_DB
            and move_snr >= DDP_MOVE_SNR_DB):
        raise AssertionError(f"two processes against one: loss rel {loss_rel}, gradients "
                             f"{grad_snr:.2f} dB, moves {move_snr:.2f} dB")
    results["steps_two_processes"] = {
        "launch_wall_s": wall, "ms": [r["ms"] for r in steps], "ms_one_process": alone["ms"],
        "losses": losses, "losses_one_process": alone["losses"], "loss_rel": loss_rel,
        "grad_snr_db": grad_snr, "move_snr_db": move_snr, "max_param_diff": max_diff,
        "launches": launches}
    results["steps_mesh"] = _mesh_steps(torch, smi, [p["mesh"] for p in pair], alone, ref,
                                        start, per_step)
    for path in [r["path"] for r in steps] + [alone["path"]]:
        os.remove(path)

    evs = [p["test"] for p in pair]
    launches = {k: evs[0]["launches"][k] + evs[1]["launches"][k] for k in evs[0]["launches"]}
    expect_launches(launches, per_batch, n_batches, "cli.test --data-parallel 2 (both)")
    rows = _csv_rows(os.path.join(savedir, "all_metrics.csv"))
    split = [sorted(int(r["index"]) for r in
                    _csv_rows(os.path.join(savedir, f"proc{i}", "all_metrics.csv")))
             for i in range(2)]
    if sorted(split[0] + split[1]) != [int(r["index"]) for r in want_rows] or \
            set(split[0]) & set(split[1]) or evs[0]["final"] != evs[1]["final"]:
        raise AssertionError(f"cli.test --data-parallel 2: proc0 {split[0]}, proc1 {split[1]}, "
                             f"finals {evs[0]['final']} / {evs[1]['final']}")
    worst = _rows_within(rows, want_rows, {"si_sdr": CLI_ROW_TOL["si_sdr"]},
                         "cli.test --data-parallel 2 against phase 13")
    log(f"[scaling] (c) cli.test --data-parallel 2, two processes on one card (gloo; "
        f"{max(e['wall_s'] for e in evs):.2f} s in the processes): proc0 {len(split[0])} rows, "
        f"proc1 {len(split[1])}; merged against phase 13's "
        f"{'bit for bit' if rows == want_rows else f'worst {worst}'}; final {evs[0]['final']}; "
        f"launches by process {[{k: v for k, v in e['launches'].items() if v} for e in evs]}")
    results["test_two_processes"] = {"wall_s": [e["wall_s"] for e in evs],
                                     "rows": [len(s) for s in split],
                                     "rows_bitwise": rows == want_rows, "worst": worst,
                                     "final": evs[0]["final"], "launches": launches}
    # phase 13's corpus and checkpoint were kept for this phase
    for path in (root, os.path.join(cli_root, "corpus"), os.path.dirname(best)):
        shutil.rmtree(path, ignore_errors=True)
    return results

def time_major_entries(tm):
    """The kernels line's rows of phase 19, with the launches of its
    time-major runs: the serving entries' from InferencerSpe.run under
    TSS_TM=1 (one batch, fp32 and bf16), the training entries' from the 5 x
    3 s step under TSS_TM=1."""
    serve, steps = tm["serving"], tm["steps"]
    for e in tm["kernels"]:
        name = e["name"]
        if name in ("bilstm2_forward_tm", "bilstm2_forward_masked_tm"):
            e["path"] = "InferencerSpe.run under TSS_TM=1, one batch of 8 (phase 19)"
            e["launches"] = serve["fp32_tm"]["launches"].get(name, 0)
            e["bf16"]["launches"] = serve["bf16_tm"]["launches"].get(name, 0)
        else:
            e["path"] = "a 5 x 3 s TSS train step under TSS_TM=1 (phase 19)"
            e["launches"] = steps["fp32"]["tm"]["launches"].get(name, 0)
            e["bf16"]["launches"] = steps["bf16"]["tm"]["launches"].get(name, 0)
        if not (e["launches"] and e["bf16"]["launches"]):
            raise AssertionError(f"{name} ({e['mode']}) was not launched on its path: "
                                 f"{e['launches']}, bf16 {e['bf16']['launches']}")
    return tm["kernels"]


def serve_tools_launches(serve):
    """The serving kernels' launches in phase 18, for the kernels line."""
    sep, exp = serve["separate"], serve["export"]
    out = {}
    for name in ("bilstm2_forward", "bilstm2_forward_masked", "products_gemm"):
        out[name] = {f"cli_separate_{m}_{tag}_{SEPARATE_SECONDS}s": sep[m][tag]["launches"].get(
                         name, 0) for m in ("tss_spe", "bss") for tag in ("full", "windowed")}
        out[name].update({f"artifact_call_{d}_{tag}": exp[d]["calls"][tag]["launches"].get(
                              name, 0) for d in exp for tag in ("many", "one")})
    return out


def ptxas_report(logs, kernels):
    """ptxas's registers and spills of each compiled entry whose mangled name
    holds one of ``kernels``, from nvcc's -Xptxas -v output by library."""
    import re

    out, entry = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1) if any(k in m.group(1) for k in kernels) else None
                if entry:
                    out[entry] = {"registers": None, "spill_stores": None, "spill_loads": None}
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[entry]["spill_stores"], out[entry]["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[entry]["registers"] = int(m.group(1))
    return out


def serve_scan_modes(ptxas):
    """The serving scan's instantiations in ptxas's report, by stream type,
    tile rows, mode and layout (the template arguments S, MT, kMode and kTM
    of the mangled name): {"fp32 16 rows mode 4": {registers, spills}, ...,
    "bf16 32 rows mode 3 time-major": ...}."""
    import re

    out = {}
    for entry, rep in ptxas.items():
        m = re.search(r"serve_scan_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E", entry)
        if m:
            dtype = "fp32" if m.group(1) == "f" else "bf16"
            tm = " time-major" if m.group(4) == "1" else ""
            out[f"{dtype} {16 * int(m.group(2))} rows mode {m.group(3)}{tm}"] = rep
    return dict(sorted(out.items()))


# the batch-major scans' registers before the layout parameter (ROADMAP.md
# section 2): serve_scan_kernel by "dtype rows mode", the training scans'
# ranges over their tile heights
BATCH_MAJOR_REGISTERS = {
    "serve": {"fp32 16 rows mode 0": 121, "fp32 32 rows mode 0": 121,
              "bf16 16 rows mode 0": 83, "bf16 32 rows mode 0": 86,
              "bf16 16 rows mode 3": 96, "bf16 32 rows mode 3": 96,
              "fp32 16 rows mode 4": 124, "fp32 32 rows mode 4": 124,
              "bf16 16 rows mode 4": 85, "bf16 32 rows mode 4": 88},
    "bwd bf16": (115, 229), "bwd fp32": (117, 255), "resid": (80, 223)}


def layout_registers(ptxas):
    """The scans' registers by layout, and whether the batch-major ones are
    BATCH_MAJOR_REGISTERS' (none spills): the layout parameter's hazard."""
    import re

    modes = serve_scan_modes(ptxas)
    ranges = {}
    for entry, rep in ptxas.items():
        m = (re.search(r"bwd_scan_kernelILi\d+E(f|13__nv_bfloat16)Lb([01])E", entry)
             or re.search(r"resid_scan_kernelILi\d+ELb([01])E", entry))
        if not m:
            continue
        key = (("bwd fp32" if m.group(1) == "f" else "bwd bf16") if "bwd" in entry else "resid")
        key += " time-major" if m.groups()[-1] == "1" else ""
        lo, hi = ranges.get(key, (999, 0))
        ranges[key] = (min(lo, rep["registers"]), max(hi, rep["registers"]))
    want = BATCH_MAJOR_REGISTERS
    same = (all(modes.get(k, {}).get("registers") == v for k, v in want["serve"].items())
            and all(tuple(ranges.get(k, ())) == tuple(want[k]) for k in ("bwd bf16", "bwd fp32",
                                                                          "resid")))
    spills = [e for e, r in ptxas.items() if r["spill_stores"] or r["spill_loads"]]
    return {"serve_scan": {k: v["registers"] for k, v in modes.items()},
            "training_scans": ranges, "batch_major_unchanged": same, "spills": spills}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.ops import _build
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    log(f"[setup] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libraries = ("bilstm2_serve", "bilstm2_resid", "bilstm2_bwd", "products", "lstm_bwd")
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, started together
        list(pool.map(_build.load_library, libraries))
    log(f"[setup] {' and '.join(libraries)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libraries:
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[setup] ptxas {name}: {line.strip()}")
    ptxas = ptxas_report(_build.build_logs, ("serve_scan_kernel", "bf16_gemm_kernel",
                                             "bwd_scan_kernel", "resid_scan_kernel"))
    for kernel, rep in ptxas.items():
        log(f"[setup] ptxas {kernel}: {rep['registers']} registers, {rep['spill_stores']} B spill "
            f"stores, {rep['spill_loads']} B spill loads")
    for key, rep in serve_scan_modes(ptxas).items():
        if key.endswith("mode 4"):  # the cell-state forward
            log(f"[setup] ptxas serve_scan_kernel {key} (want_cs): {rep['registers']} registers, "
                f"{rep['spill_stores']} B spill stores, {rep['spill_loads']} B spill loads")
    layouts = layout_registers(ptxas)
    log(f"[setup] scans' registers by layout: serving {layouts['serve_scan']}; training "
        f"{layouts['training_scans']}; the batch-major ones as before the layout parameter: "
        f"{layouts['batch_major_unchanged']}; spills: {layouts['spills'] or 'none'}")
    if layouts["spills"]:
        raise AssertionError(f"ptxas reports spills: {layouts['spills']}")

    t0 = time.perf_counter()
    entries = phase_kernel(torch, dev)
    log(f"[kernel] phase done in {time.perf_counter() - t0:.1f} s")
    note_running("kernel")

    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "flagship_random.pt")
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), ckpt)
    t0 = time.perf_counter()
    inf, launches, rate = phase_main_path(torch, dev, ckpt)
    log(f"[main] phase done in {time.perf_counter() - t0:.1f} s; "
        f"{rate:.2f} audio-s/s on {smi}")
    note_running("main")
    for e in entries:
        e["launches"] = launches[e["mode"]]

    t0 = time.perf_counter()
    phase_card_vs_cpu(torch, inf, ckpt)
    log(f"[check] phase done in {time.perf_counter() - t0:.1f} s")
    note_running("check")
    del inf
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_kernels = phase_backward_kernels(torch, dev)
    log(f"[train-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    note_running("train-kernels")

    t0 = time.perf_counter()
    train = phase_training(torch, dev, training_family("tss"))
    log(f"[train] phase done in {time.perf_counter() - t0:.1f} s; "
        f"{train['ms_per_step']:.2f} ms/step on {smi}")
    note_running("train")
    entries[0]["launches_per_training_run"] = train["launches"]["bilstm2_forward"]  # eval steps
    entries += train_kernel_entries(train_kernels, train["launches"])
    for e in entries:  # the fp32 serving scans' input products, on the main path
        if e["name"] == "products_gemm":
            e["launches_main_path"] = launches["products_gemm"]

    t0 = time.perf_counter()
    lstm_kernels = phase_lstm_kernels(torch, dev)
    log(f"[lstm-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    note_running("lstm-kernels")

    t0 = time.perf_counter()
    n = BSS["n_repeats"]
    bss_serve = phase_bss_serving(torch, dev, BSS, "bss", {"bilstm2_forward": n, "lstm_forward": n})
    bss_serve_bi = phase_bss_serving(torch, dev, dict(BSS, bidirectional=True, n_repeats=2),
                                     "bss-bidirectional",
                                     {"bilstm2_forward": 2, "bilstm2_forward_masked": 2})
    log(f"[bss] phase done in {time.perf_counter() - t0:.1f} s; "
        f"{bss_serve['audio_s_per_s']:.2f} audio-s/s on {smi}")
    note_running("bss")

    t0 = time.perf_counter()
    bss_train = phase_training(torch, dev, training_family("bss"))
    log(f"[bss-train] phase done in {time.perf_counter() - t0:.1f} s; "
        f"{bss_train['ms_per_step']:.2f} ms/step on {smi}")
    note_running("bss-train")
    entries += lstm_kernel_entries(lstm_kernels, {**bss_train["launches"],
                                                  "lstm_forward": bss_serve["launches"]["lstm_forward"]})
    for e in entries:  # the BSS paths launch the fused bidirectional kernels too
        if e["name"] in bss_train["launches"]:
            e["launches_bss"] = {"serving": bss_serve["launches"].get(e["name"], 0)
                                 + bss_serve_bi["launches"].get(e["name"], 0),
                                 "training": bss_train["launches"][e["name"]]}

    t0 = time.perf_counter()
    optin_kernels, bf16_product = phase_optin_kernels(torch, dev)
    log(f"[optin-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    note_running("optin-kernels")
    t0 = time.perf_counter()
    optin = phase_optin_paths(torch, dev, ckpt)
    log(f"[optin] phase done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("optin")
    paths = {"bilstm2_dense_forward": ("TSS_FUSED_DENSE=1 serving (6 intra scans per batch)",
                                       optin["TSS_FUSED_DENSE"]["launches"]),
             "bilstm2_forward_bm": ("TSS_BM=1 serving (6 intra scans per batch)",
                                    optin["TSS_BM"]["launches"])}
    for e in optin_kernels:
        if e["name"] in paths:
            e["path"], launches = paths[e["name"]]
            e["launches"] = launches[e["name"]]
        else:  # on no model path: phase 10's own call of the public entry
            e["path"] = ("a test-only entry of the JAX package, on no model path: one fp32 and "
                         "one bf16 call of the public entry (phase 10)")
            e["launches"] = e["launches_per_fp32_and_bf16_call"][e["name"]]
        if e["name"] == "bilstm2_dense_forward":
            e["launches_per_training_run"] = optin["training"]["launches"][e["name"]]
        for switch, kernel in (("TSS_BM", "bilstm2_forward_bm"),
                               ("TSS_FUSED_DENSE", "bilstm2_dense_forward")):
            if e["name"] == kernel:  # the bf16 lane's run under the switch
                e["launches_bf16_lane"] = optin[f"{switch}_bf16"]["launches"][kernel]
    bf16_product["path"] = "TSS_BM=1 serving in the bf16 lane (6 intra scans per batch)"
    bf16_product["launches"] = optin["TSS_BM_bf16"]["launches"]["products_gemm_bf16"]
    bf16_product["launches_tss_fused_dense_bf16_lane"] = (
        optin["TSS_FUSED_DENSE_bf16"]["launches"]["products_gemm_bf16"])
    entries += optin_kernels + [bf16_product]
    t0 = time.perf_counter()
    tiny = phase_tiny_widths(torch, dev)
    log(f"[tiny] phase done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("tiny")
    for e in entries:  # the dense Function's training steps run the residual and backward kernels
        if e["name"] in ("bilstm2_forward_resid", "bilstm2_backward"):
            e["launches_tss_fused_dense_training"] = optin["training"]["launches"][e["name"]]
    t0 = time.perf_counter()
    cli = phase_cli(torch, dev)
    log(f"[cli] phase done in {time.perf_counter() - t0:.1f} s; train CLI "
        f"{cli['train']['ms_per_step']:.2f} ms/step, test CLI "
        f"{cli['test_tss']['walls_s']['triple_pool']:.3f} s on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("cli")
    t0 = time.perf_counter()
    families = phase_families(torch, dev)
    log(f"[families] phase done in {time.perf_counter() - t0:.1f} s; device metric lane "
        f"STOI {families['metric_lane']['stoi']['ms']:.2f} ms, PESQ "
        f"{families['metric_lane']['pesq']['ms']:.2f} ms per batch on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("families")
    t0 = time.perf_counter()
    ira_rawnet = phase_ira_rawnet(torch, dev, smi, cli["manifests"])
    log(f"[ira-rawnet] phase done in {time.perf_counter() - t0:.1f} s; serving at batch 8: "
        f"flagship {ira_rawnet['flagship']['audio_s_per_s_batch8']:.2f}, "
        f"IRA {ira_rawnet['ira']['audio_s_per_s_batch8']:.2f}, IRA share_blocks=3 "
        f"{ira_rawnet['ira_share3']['audio_s_per_s_batch8']:.2f}, RawNet "
        f"{ira_rawnet['rawnet']['audio_s_per_s_batch8']:.2f} audio-s/s on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("ira-rawnet")
    for e in entries:  # the two families run the serving and the training pair
        name = e["name"]
        if name in ("bilstm2_forward", "bilstm2_forward_masked", "bilstm2_forward_resid",
                    "bilstm2_backward"):
            e["launches_ira_rawnet"] = {
                fam: {"serving_run": r["serve_launches"].get(name, 0),
                      "train_step_5x3s": {tag: st["launches"].get(name, 0)
                                          for tag, st in r.get("steps_5x3s", {}).items()}}
                for fam, r in ira_rawnet.items() if fam not in ("cli", "flagship")}
    t0 = time.perf_counter()
    varlen = phase_varlen(torch, dev, smi)
    tss_cli = varlen["cli_tss_spe"]
    log(f"[varlen] phase done in {time.perf_counter() - t0:.1f} s; cli.train variable-length "
        f"train ms by bucket width {tss_cli['ms_by_bucket']}, peak {tss_cli['peak_gb']:.2f} GB; "
        f"lstm_save_every {SAVE_EVERY} on the largest bucket "
        f"{varlen['save_every'][f'save_every_{SAVE_EVERY}']['ms']:.1f} ms / "
        f"{varlen['save_every'][f'save_every_{SAVE_EVERY}']['peak_gb']:.2f} GB against "
        f"{varlen['save_every']['save_every_1']['ms']:.1f} ms / "
        f"{varlen['save_every']['save_every_1']['peak_gb']:.2f} GB on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("varlen")
    new_entries = varlen_kernel_entries(varlen)
    by_name = {e["name"]: e for e in new_entries}
    for e in entries:  # the nested rows of these modes are now on a path too
        for key in ("masked", "with_cs"):
            sub = e.get(key)
            if isinstance(sub, dict) and sub.get("name") in by_name:
                sub["launches"] = by_name[sub["name"]]["launches"]
    entries += new_entries
    t0 = time.perf_counter()
    bf16 = phase_bf16(torch, dev, smi, cli, varlen)
    flag, steps = bf16["serving"]["flagship"], bf16["steps"]
    log(f"[bf16] phase done in {time.perf_counter() - t0:.1f} s; flagship served at batch 8: "
        f"bf16 {flag['audio_s_per_s_bf16_batch8']:.2f} against fp32 "
        f"{flag['audio_s_per_s_fp32_batch8']:.2f} audio-s/s (batch 32: "
        f"{flag['audio_s_per_s_bf16_batch32']:.2f} against "
        f"{flag['audio_s_per_s_fp32_batch32']:.2f}), {flag['snr_db_batch8']:.2f} dB against the "
        f"fp32 lane; 5 x 3 s TSS step bf16 {steps['tss']['bf16']['ms']:.1f} ms / "
        f"{steps['tss']['bf16']['peak_gb']:.2f} GB against fp32 {steps['tss']['fp32']['ms']:.1f} "
        f"ms / {steps['tss']['fp32']['peak_gb']:.2f} GB on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("bf16")
    entries += bf16_kernel_entries(entries, bf16, {
        "serve": flag["launches_bf16_batch8"],
        "bss_serve": bf16["serving"]["bss_causal"]["launches_bf16_batch8"],
        "tss": steps["tss"]["bf16"]["launches"],
        "bss_causal": steps["bss_causal"]["bf16"]["launches"],
        "varlen": bf16["varlen_cli"]["launches"],
        "save_every": bf16["save_every"]["steps_5x3s"]["bf16"]["launches"]})
    t0 = time.perf_counter()
    serve = phase_serve_tools(torch, dev, smi, ckpt)
    sep, art = serve["separate"], serve["export"]
    log(f"[serve-tools] phase done in {time.perf_counter() - t0:.1f} s; cli.separate "
        f"{SEPARATE_SECONDS} s flagship full length {sep['tss_spe']['full']['audio_s_per_s']:.2f}"
        f", windowed {sep['tss_spe']['windowed']['audio_s_per_s']:.2f} audio-s/s; the fp32 "
        f"artifact's call at {EXPORT_BATCH} x {EXPORT_SECS} s "
        f"{art['fp32']['calls']['many']['call_ms']:.2f} ms (the eager forward through the same "
        f"host path {art['fp32']['calls']['many']['eager_call_ms']:.2f}) on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("serve-tools")
    launches = serve_tools_launches(serve)
    for e in entries:  # the first (fp32) row of each kernel the serving tools run
        if e["name"] in launches and "launches_serve_tools" not in e:
            e["launches_serve_tools"] = launches.pop(e["name"])
    t0 = time.perf_counter()
    tm = phase_time_major(torch, dev, smi, ckpt)
    tms = tm["serving"]
    log(f"[time-major] phase done in {time.perf_counter() - t0:.1f} s; bf16 flagship in turns: "
        f"batch 8 time-major {tms['bf16_batch8']['audio_s_per_s_tm']:.2f} against batch-major "
        f"{tms['bf16_batch8']['audio_s_per_s_bm']:.2f}, batch 32 "
        f"{tms['bf16_batch32']['audio_s_per_s_tm']:.2f} against "
        f"{tms['bf16_batch32']['audio_s_per_s_bm']:.2f} audio-s/s on {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    note_running("time-major")
    entries += time_major_entries(tm)
    t0 = time.perf_counter()
    scaling = phase_scaling(torch, dev, smi, cli)
    one, two = scaling["train_world1"], scaling["steps_two_processes"]
    mesh = scaling["steps_mesh"]
    turns = one["in_turns"]["medians"]
    log(f"[scaling] phase done in {time.perf_counter() - t0:.1f} s; a train step through "
        f"DistributedDataParallel at world size 1 (NCCL) {turns['ms_ddp']:.2f} ms against "
        f"{turns['ms_plain']:.2f} without (in turns), checkpoint against phase 13's "
        f"{one['held']}; two "
        f"processes on one card (gloo) against one: parameter moves {two['move_snr_db']:.2f} "
        f"dB; as a 1 x 2 mesh ({max(mesh['wall_s']):.1f} s): moves {mesh['move_snr_db']:.2f} "
        f"dB on {smi}; total {time.perf_counter() - t_start:.1f} s")
    note_running("scaling")
    for e in entries:  # the kernels cli.train and cli.test ran under the launcher
        got = {f"cli_{tag}_world1": run["launches"].get(e["name"], 0)
               for tag, run in (("train", one), ("test", scaling["test_world1"]))}
        if any(got.values()):
            e["launches_scaling"] = got
    # nothing this script started may outlive it; a process still running
    # here is named, then stopped
    stopped = stop_descendants()
    log(f"[cleanup] processes still running below this one at its end: {len(stopped)}"
        + "".join(f"\n[cleanup] stopped {p}" for p in stopped))
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump({"card": smi, "stopped_at_end": stopped, "ptxas": ptxas,
                   "serve_scan_modes": serve_scan_modes(ptxas), "scan_layouts": layouts, "time_major": tm, "scaling": scaling,
                   "kernels": entries, "training": train, "lstm_kernels": lstm_kernels,
                   "bss_serving": bss_serve, "bss_serving_bidirectional": bss_serve_bi,
                   "bss_training": bss_train, "optin": optin, "tiny_widths": tiny, "cli": cli,
                   "families": families, "ira_rawnet": ira_rawnet, "varlen": varlen,
                   "bf16": bf16, "serve_tools": serve}, f, indent=1)

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-child"]:  # a process of phase 20's torch.distributed.run
        sys.exit(ddp_child(sys.argv[2:]))
    become_subreaper()
    try:
        rc = main()
    finally:  # after a failure too: stop what a phase left running
        for p in stop_descendants():
            print(f"chip_smoke: stopped {p}", file=sys.stderr)
    sys.exit(rc)
