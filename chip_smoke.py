#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each raises on failure, so the exit code is 0 only if all pass):

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles ``kindergarten_vq_vae_torch/csrc/*.cu`` into
   ``kindergarten_vq_vae_torch/build/`` (first use);
2b. the layer GEMM (wgmma + TMA) at every product of the batch-2048 step
   (forward, data gradient and weight gradient, each with its epilogue) and
   the forward at the bucket-256 serving rows, against its plain version,
   with its time, TFLOP/s and share of the bf16 peak beside ``torch.matmul``
   in bf16 at the same shape; one weight gradient twice, bit for bit;
2c. the LayerNorm and column-sum kernels (``csrc/layernorm.cu``) alone at the
   batch-2048 shapes (24,576 rows x 768; column sums 768 / 1,536 / 2,304
   wide), in turns with their plain versions: the residual + LayerNorm
   (dropout 0.1), the LayerNorm backward with a bf16 and an f32 upstream,
   the bias column sums, each with its time, byte bound and share, the plain
   time and its library yardstick (the add plus ``F.layer_norm``;
   ``aten.native_layer_norm_backward`` on the f32 pre-LN rows, with no keep
   mask and no da; ``src.sum(0, dtype=torch.float32)``); the GELU-gradient
   GEMM with b1 summed in its epilogue (``colsum=True``) against the plain
   f32 du's column sums, its time and TFLOP/s beside the form that writes
   the f32 du (``out2=True``); dgamma / dbeta / dbias, the column sums and
   b1 twice, bit for bit;
3. kernels vs plain, serving: the layer forward and the VQ kernel against
   their plain PyTorch versions on the card at the shapes of a bucket-256
   bert-base forward (256 sentences x 12 tokens), with padded masks, and each
   one's time beside the plain one's, its bound and, for the layer, the time
   of ``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` on the
   same weights; the VQ kernel (#5) timed alone (its raw launch in a CUDA
   graph, beside the plain raw forward and straight-through expression) and
   through its wrapper (``assemble`` included, beside ``vector_quantize``),
   each with its share of the byte bound, and its sums the same bits in two
   launches; the codebook gradient (``csrc/vq_bwd.cu``, row 5+,
   ``phase_codebook_grad``) at the step's 24,576 rows x 768 with 9 and 37
   codes: kernel and plain ``index_add_`` each within ``CB_REL`` of an f64
   sum, two launches the same bits, an unpicked code exactly 0, its time
   (CUDA graph) beside the plain version's, its byte bound and
   ``index_put_(accumulate=True)``;
4. kernels vs plain, training: the layer forward in training mode (dropout
   0.1 / 0.1, residuals kept), the layer backward, the attention backward
   (self and cross) and the three CE kernels (#6, #7, #8) at the shapes of
   the batch-2048 bert-base training step, with ``nn.TransformerEncoderLayer``
   / ``DecoderLayer`` in train mode (dropout 0), the autograd backward of
   ``F.scaled_dot_product_attention`` and, for #8, that of
   ``F.cross_entropy(reduction="none")`` as yardsticks (for #7 the two calls
   ``F.cross_entropy(reduction='none')`` + ``torch.argmax(x, 1)``, printed
   only), #8 also on logits views at every element offset of a 16-byte
   chunk (its output at the logits' phase), the VQ kernel timed as in
   phase 3 at the step's 24,576 rows, and
   layers whose weights make
   every keep mask visible (self and cross heads, the three hidden sites,
   forward and backward; held to the plain masks); ``fused_ce_loss`` (#6
   forward, #8 backward) driven once through its autograd;
4a. the attention forward inside #1 alone (the layer forward's
   ``kvq_attention_fwd``) vs plain at the batch-2048 shapes (self causal,
   self with a padded mask, cross with op ids from 13; dropout 0.1) and at
   the bucket-256 serving shape, every keep bit held to the plain mask, with
   its bound and ``F.scaled_dot_product_attention`` beside it;
4b. fused head + CE kernels vs plain: #9 and #10, store and flash, at the
   step's head shapes (24,576 rows x 768 x 30,522, bf16) and at ragged rows
   with an odd vocabulary; the table gradient (the GEMM's TN split-K
   product); each one's time, TFLOP/s and share of the bf16 peak beside the
   plain one's time, its bound and its library yardstick (cuBLAS + PyTorch
   calls computing the same function, named as printed);
5. AMSGrad (kernel #14) vs its plain version over the whole bert-base
   Shelgon3-VQ parameter list: 3 steps with weight decay, a milestone, a
   frozen subset left out and the gradient-less pooler, held bit for bit;
   its time beside the plain single-pass version's, the per-leaf update's,
   its bound and ``torch.optim.Adam(fused=True, amsgrad=True)`` on the same
   leaves (a same-bytes yardstick only: it maxes the raw second moment);
   then the same over the whole parameter list of phase 14's Bagon with the
   GPT-2-small decoder, as its step updates it (the tied ``wte`` of 50,257
   rows, the bare ``wpe``, the blocks' cross-attention leaves);
6. serving slice: a full-width bert-base Shelgon3-VQ run (12 + 12 layers,
   H 768, vocab 30522, 9 codes, bf16) with seeded weights, written as a
   flat-npy checkpoint and served over HTTP through the kernels; launch
   counts are checked, and one bucket-256 forward of the kernel path and of
   the plain path is held against an f32 forward of the same weights;
7. serving timing: median bucket-256 forward, kernel path and plain path;
8. training slice: the same model trained for 8 steps at batch 2048 x 12
   (dropout 0.1 / 0.1, AMSGrad lr 1e-4) on one fixed batch through the
   kernels: launch counts per step (kernel #14 once, the plain update never),
   finite and falling loss, median step time, sentences/s and peak memory;
   then 4 steps each with ``fused_head_ce`` "store" and "flash" from the
   same weights and dropout (#9, #10 and the table gradient once a step, #7
   and #8 never), the first step's loss held to the default path's; the
   three routes' step medians and peak memory side by side;
9. gradients at batch 256: the kernel path's, the plain bf16 path's and the
   two fused-head kernel paths' gradients, each held against an f32 plain
   step on the same weights, dropout and batch;
10. training entry point: a small corpus generated into a temporary
   directory, then ``python -m kindergarten_vq_vae_torch.cli shelgon3`` (in
   process) trains the same full-width model at batch 2048 for 2 epochs, runs
   val and test, writes ``run_conf.json``, one best-val slot and
   ``history.json``; the launch counts of its train, val and test steps are
   checked, and the run directory is served through ``Reconstructor``; then
   a 1-epoch run with ``--set fused_head_ce='store'`` the same way (#9 once
   a step and an eval batch, #10 once a step), served through the logits
   path;
11. the per-module trunk (``fused_layer="off"``): the SDPA kernels #11 / #12
   (self-attention from qkv views, causal, padded masks; cross-attention
   from kv views; dropout 0.1) and #13 against their plain versions at the
   batch-2048 shapes, #11 at the bucket-256 serving shape, every attention
   keep bit held to the plain mask, their times beside the plain versions',
   their byte bounds and ``F.scaled_dot_product_attention``, and
   ``fused_mha`` once through its autograd; 4 training steps at batch 2048
   (36 SDPA forwards and backwards a step, no layer kernel, the plain SDPA
   refused) beside the default route's step, its batch-256 gradients
   against an f32 per-module step, a ``fused_layer="off"`` run served
   through ``Reconstructor`` (36 SDPA forwards a forward) and timed beside
   the fused route, ``output_attentions`` at bucket 8, and a 1-epoch
   ``--set fused_layer='off'`` CLI run, served;
12. the research path (``kindergarten_vq_vae_torch/train/flagship.py`` and
   ``analyses/``) on the same cut corpus, bert-base, bf16, batch 256: the
   flagship pipeline's stages 1-4 as functions, one epoch each at
   ``--lim-batches 0.1 --dec-perturb 0.5`` (each stage's wall time, its
   steady-state sentences/s, its stats and its launches; stage 2's
   diagnostics and whether each gate would fire); stage 2's k-means held,
   Lloyd step by Lloyd step, against an f64 host Lloyd from the card's own
   centroids on the downloaded ``z_flat`` and the same initial rows, its
   chained steps equal to the ``.npy`` bit for bit; stage 3's codebook
   before its first step equal to that ``.npy``; on the stage-3 run
   (``analyses.common.load_run``) the disentanglement tables equal to those
   built from ``Reconstructor.codes`` on the same sentences, the sentence
   latents against ``Reconstructor.encode``, the attention maps' rows summing
   to 1 and the cross maps apart from the self maps; Bagon arithmetic with
   group A = group B on the stage-1 run (Δ = 0, shifted ids = base ids); and
   ``scripts/eval_run_torch.py`` on the stage-3 run (finite stats over the
   whole test split);
13. the other variants (``VARIANTS``: Shelgon, Shelgon2 with
   ``mask_pct_train=0.1``, Shelgon3-Gumbel) at the same width: each one's
   batch-256 gradients through the kernels held against an f32 plain step
   as in phase 9, its first batch-2048 step's loss against the plain
   route's from the same weights and generator seed, 4 steps through the
   kernels (24 #1, 24 #2, 24 + 12 #3 / #4, one #7, #8 and #14 a step, no
   #5) with the median beside phase 8's Shelgon3-VQ step; Shelgon with both
   masks None (the layers' null-mask branch) against all-ones masks; a
   1-epoch ``python -m kindergarten_vq_vae_torch.cli shelgon2`` run on the
   cut corpus (its label columns on the device), served through
   ``Reconstructor`` (``reconstruct``, ``encode``); and
   ``latent_traversals_shelgon`` on the Shelgon model;
14. the GPT-2 decoder (``GPT2_MODELS``: Bagon and Shelgon3-VQ with a
   GPT-2-small decoder, 12 blocks at H 768, the published vocabulary of
   50,257): #7 and #8 at the step's (24,576, 50,257) logits against their
   plain versions (rows at all eight 16-byte phases),
   timed in turns with their bounds and library calls; each model's
   batch-256 gradients against an f32 plain step as in phase 9, its first
   batch-2048 step's loss against the plain route's, 4 steps through the
   kernels (12 #1, 12 #2 with 12 #3, one #7, #8 and #14 a step, #5 under
   Shelgon3-VQ, no #4: the GPT-2 blocks are plain PyTorch, as they are XLA
   in JAX) with the median and peak memory; a 1-epoch ``python -m
   kindergarten_vq_vae_torch.cli bagon --set decoder_model_name='gpt2'``
   run on the cut corpus (its BPE trained from the corpus), served through
   ``Reconstructor``;
15. f32 (``phase_f32``; JAX's parity dtype): each f32 instance alone at the
   batch-2048 step's shapes against its f32 plain version, timed in turns
   with it, with its bound (bytes or operations: the layer GEMM's and #1 /
   #2's at the 3xTF32 rate, their f32 FMA bound printed beside; the others'
   at the f32 FMA rate) and its library call: the layer GEMM
   at every product in each layout (``torch.matmul`` at "highest"), the
   residual + LayerNorm, its backward and the column sums, the attention
   forward (self causal, self padded, cross) and backward (self, cross),
   #1 and #2 encoder and decoder, every keep mask, #7 / #8 (and #6) at
   30,522 and 50,257 with rows at every 16-byte phase; the f32 bert-base
   Shelgon3-VQ step at batch 2048 (24 #1, 24 #2, 24 + 12 #3 / #4, one #7,
   #8, #5 and #14 a step, every one an f32 instance, no plain version),
   its median and peak memory; an f32 CLI run trained, evaluated,
   checkpointed and served through ``Reconstructor``, its reconstruction
   ids and codes against the plain route's, and taken by
   ``analyses.common.load_run`` and ``codebook_init``'s encoder; the batch-256 loss and
   gradients of the kernel route against the plain route's; Bagon with the
   GPT-2 decoder at a cut depth, the same, and one batch-2048 step;
15b. the f32 routes (``phase_f32_routes``): #9 and #10 (store, flash) and
   the table gradient in f32 at the step's head shapes (24,576 rows x 768 x
   30,522) against their f32 plain versions (flash = store bit for bit),
   and #11 / #12 (keep masks exact) and #13 (a fully masked sentence, and
   its autograd) in f32 as phase 11 runs them in bf16, each timed in turns
   with its plain version, with its bound (the GEMM's at the 3xTF32 rate,
   the f32 FMA bound printed beside; the attention's f32 FMA operations or
   bytes) and library call (the cuBLAS f32 head +
   ``F.cross_entropy`` + argmax and its autograd backward,
   ``torch.matmul(g.T, x)``, ``F.scaled_dot_product_attention`` in f32);
   4 f32 steps each with ``fused_head_ce`` store and flash (#9, #10 and the
   table gradient once a step, #7 / #8 never; the first loss held to the
   default f32 route's) and with ``fused_layer="off"`` (36 #11 and #12 a
   step, no layer kernel; the first loss held to the plain per-module
   route's), their medians and peak memory; each route's batch-256 loss and
   gradients against the f32 plain route's; a 1-epoch f32 CLI run with
   ``--set fused_head_ce='store'`` and one with ``--set fused_layer='off'``,
   each served through ``Reconstructor`` against the plain route;
16. serving export and the last single-device modules (``phase_export``):
   the serving slice's bert-base Shelgon3-VQ run exported at bucket 256
   (``serve/export.py``: ``torch.export`` with the kernels as the custom ops
   ``kvq::layer_fwd``, ``kvq::vq_fwd`` and ``kvq::sdpa_fwd``, the parameters
   a call argument) on the default route in bf16, on the per-module route
   (``fused_layer="off"``) and in f32: no launch in the export; the artifact
   served over HTTP through ``http_server --artifact`` answering
   ``/reconstruct`` and ``/codes`` exactly as the live kernel path does;
   one artifact forward's launches (24 #1 and one #5, or 36 #11 and one #5;
   no plain version) and its ids and codes equal to the live forward's bit
   for bit; the ``.pt2`` size and the live and artifact bucket-256 medians in
   turns beside ``utils/profiling.benchmark_fn``'s means; the bf16 run's
   reference ``.pth`` bundle (``ckpt/export_torch.py``) converted back and
   equal to the model's parameters bit for bit, and its key count; on phase
   14's Shelgon3-VQ with the GPT-2-small decoder, the sentence latents and
   the disentanglement through the kernels on the cut corpus, and the
   refusals of the three arithmetic modes and of the attention maps before
   any launch;
17. multi-device (``phase_mesh``; ``kindergarten_vq_vae_torch/parallel/``):
   (a) one rank over NCCL (a world of this process, one NCCL all-reduce
   checked): the bert-base Shelgon3-VQ at batch 2048 x 12, bf16, dropout
   0.1, 3 steps unmeshed twice and on the meshes ``(1,)`` ``("dp",)`` and
   ``(1, 1)`` ``("dp", "tp")`` (the mesh path's head: "auto" is "store"
   under a mesh) against the first unmeshed run with
   ``fused_head_ce="store"`` from the same weights and generator seed, all
   under PyTorch's default algorithms (the codebook gradient is summed in a
   fixed order by ``csrc/vq_bwd.cu``): the losses and the parameters after
   3 steps the first unmeshed run's bits (at world 1 every collective is the
   identity and the seed fold adds 0), #1, #2, #5, the codebook gradient,
   #9, #10, the table gradient and #14 launched in each run, the step
   medians side by side; (b) two ranks sharing the card over gloo
   (``parallel.dryrun.launch``, ``_mesh_gloo_worker``, default
   algorithms), full bert-base width and depth, the logits
   route (#7 / #8), global batch 512, dropout 0: the mesh ``(2,)`` for 2
   steps in bf16 and one in f32; the first step's bf16 gradients the bits
   of a witness: each rank runs its 256 rows alone through the unmeshed
   step (normalised by its own rows, so its gradient is twice its share,
   exactly), the two witnesses are summed in f32 as the gradient all-reduce
   sums the shares and halved; a control (one rank's witness left out)
   must not give those bits; the first loss within ``MESH_LOSS_REL`` of
   rank 0's one-process step on the whole batch (f32: ``F32_LOSS_REL``),
   the f32 gradients within ``F32_GRAD`` of each leaf's largest of the
   one-process f32 step's; then the tp mesh ``(1, 2)`` for ``MESH_STEPS``
   steps: its losses and its parameters after the steps the one-process
   steps' bits (the tp ranks' gradients are the same, so the
   reduce-scatter's mean is exact), and every replicated leaf (no tp rank
   shards it; each rank updates its own copy) the same bits on both ranks;
   #1, #2, #5, the codebook gradient, #7, #8 and #14 launched on each rank
   in each run; each step's time and the collectives' times (gloo's
   gradient all-reduce, the stats' all-reduce, tp all-gather and
   reduce-scatter, each bracketed by device syncs) and their share of the
   step; the phase's wall time;
18. the data path (``phase_data``): the C++ corpus packer
   (``kindergarten_vq_vae_torch/csrc/corpus_tokenizer.cpp``, built with g++
   at first use) taken, bit for bit with the Python path on the engine's
   corpus; ``python -m kindergarten_vq_vae_torch.data.prepare --generate``
   in a subprocess (the whole corpus, 241,920 sentences); a one-epoch CLI
   run with ``--set mmap=True`` (memory-mapped columns, lazy splits) and one
   without: the same history losses bit for bit; the engine's train
   ``sentences_per_sec`` (batches double-buffered) against the bare step's
   on the same corpus and the bare step's host synchronisations
   (``scripts/ab_engine.py``'s in-tree half); the phase's wall time;
19. the parity twin (``phase_twin``): ``scripts/parity_harness_torch.py``
   ``train_ours``, the port's f32 Bagon at the harness's size, 2 epochs on
   the card through the kernels (plain versions refused; #1, #2, #7, #8 and
   #14 launched as counted) and on the CPU: the card's val token accuracy
   no more than ``TWIN_GAP`` below the CPU's; both and their wall times;
20. the configurations past the one-pass kernels (``phase_long``): the VQ's
   general path (#5: the distances' products on the 3xTF32 GEMM, an exact
   screen and recheck of the codes that may be the minimum in f32 sums, the
   per-code sums over the rows grouped by code) at 24,576 rows x 768 x 512
   codes and x 1,280 x 1,024 codes and on an adversarial codebook (a shell
   far from the origin, duplicates across tiles) against its plain version
   (codes equal but at f32 near ties, judged in f64; z_q, counts, sum_z and
   the loss held to its own codes; the screen's products within kappa / 2 of
   the f64 product, the rows that recheck more than one code; sum_z the
   plain grouped sum's bits; two launches the same bits), timed with its
   3xTF32 bound (the row's ``bound_ms``), the f32 FMA bound beside it and
   the yardstick torch.matmul + argmin;
   the codebook gradient (5+) over the grouped rows at 512 and 1,024 codes,
   against an f64 sum and the plain grouped sum's bits, two launches the same
   bits, timed alone and from the forward's grouping beside
   ``index_put_(accumulate=True)``; the attention past 32 tokens
   (``csrc/attention_long.cu``) in bf16 and f32 through the layer's
   attention forward and backward, #11 / #12 and #13 at 64 tokens x 256
   sentences (self causal padded, cross over padded keys, dropout 0.1),
   timed in turns with the plain versions, with the bound and
   ``F.scaled_dot_product_attention`` (backend pinned: flash in bf16,
   memory-efficient in f32), and at 512 tokens, two launches the same bits
   at each shape, the keep masks exact at 64 tokens; then bert-base
   Shelgon3-VQ training steps through the default route, dropout on, every
   plain version of the route
   refused: at ``vq_n_e`` 512 (batch 2048 x 12), at 64 tokens (batch 256,
   bf16) and at 64 tokens in f32 (batch 64), each step's launches as
   counted (#1, #2, #5, 5+, #7, #8, #14);
21. every hidden width and head size the JAX package runs (``phase_wide``):
   the LayerNorm kernels' rows past 1,024 columns (``csrc/layernorm.cu``'s
   block-a-row kernels) alone at 3,072 and 24,576 rows x 1,032, 1,280,
   1,600, 4,096 and 8,200 columns, the residual + LayerNorm (x bf16 and f32)
   and the backward (gy bf16 and f32 over bf16 rows, f32 rows), dropout 0.1,
   against their plain versions (every keep bit of da the plain mask's, the
   sums the same bits twice), timed in turns with them, with the byte bound,
   ``F.layer_norm`` after the add and ``aten.native_layer_norm_backward``;
   the attention past head_dim 128 (``csrc/attention_long.cu``'s 128-column
   chunks) at head_dim 136, 192, 256, 384 and 768 x 12, 33, 64 and 512
   tokens, bf16 and f32, through every entry (self causal padded, cross over
   padded keys, #13 with a fully masked sentence; dropout 0.1) against the
   plain versions, the backward's bits twice, the layer's attention timed in
   turns with the plain version beside the bound and
   ``F.scaled_dot_product_attention`` (flash in bf16 up to head_dim 256,
   memory-efficient otherwise), every entry at head_dim 192 x (2048, 12);
   then training steps through the default route, dropout on, every plain
   version refused, every launch counted with its wide share: the
   Shelgon3-VQ with a GPT-2 decoder at gpt2-large's published widths (n_embd
   1,280, 20 heads, 36 blocks, n_inner 5,120, vocabulary 50,257) and the
   BERT encoder at that width and depth (36 fused layers on the wide
   LayerNorm), bf16 at batch 256 x 12; its BERT-decoder twin, 4 + 4 layers,
   bf16 at batch 256 and f32 at batch 64; bert-base with 4 heads (head_dim
   192) in bf16 at batch 2048 x 12 and 256 x 64 tokens and in f32 at batch
   64 x 12.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = 256
SEQ = 12
WORDS = ("i you he she we they it eat eats buy buys fix fixes paint paints see sees like likes "
         "want wants the a an this that my your apple mango fence car house door window book "
         "red big small old new green blue quickly slowly today now will not is are was were "
         "do does did have has had and or but").split()

# kernel-vs-plain tolerances. Layer: the output is a bf16 LayerNorm output of
# O(1) magnitude (|y| up to ~8, where one bf16 ulp is 3.1e-2); kernel and
# plain share every rounding point and differ only in f32 summation order and
# exp/tanh ulps, which flip an occasional bf16 rounding -> max abs 6e-2
# (two ulps at the top of the range), mean abs 2e-3. VQ: the gather, the
# argmin over identical expansions and the counts are exact; f32 sums in
# another order -> rel 1e-5.
LAYER_MAX_ABS, LAYER_MEAN_ABS = 6e-2, 2e-3
VQ_REL = 1e-5
# the codebook gradient (kernel and plain index_add_) against an f64 sum of
# the same f32 terms, relative to the largest sum of the terms' magnitudes:
# f32 sums of up to 24,576 terms in another order
CB_REL = 1e-5
# whole slice: after 24 bf16 layers the two bf16 paths sit about one bf16
# ulp apart on average (rounding flips compound: 6.8e-3 mean abs on the
# encoder output, measured on an H100 80GB HBM3 at 700 W), so they are not
# held to each other but each to an f32 forward of the same weights: the
# kernel path may be no more than 25% further from it than the plain bf16
# path, and may pick no more than 1% more codes that differ from the f32 codes.
PATH_SLACK, CODE_SLACK = 1.25, 0.01
# training kernels vs plain, on the same inputs: every residual and every
# gradient within 2e-2 of its leaf's largest magnitude (shared rounding
# points; an f32 sum in another order flips an occasional bf16 rounding of
# an intermediate, one ulp is 0.4%); CE ids exact, NLL within 1e-4 absolute
# (values ~15, f32 sums in another order), dlogits within 1e-2 of the
# largest (one bf16 ulp).
TRAIN_REL, CE_NLL_ABS, CE_GRAD_REL = 2e-2, 1e-4, 1e-2
# fused head + CE (#9, #10) vs plain. The kernel's logits come from the wgmma
# GEMM, the plain ones from cuBLAS: f32 sums in another order, so a bf16 logit
# may sit one ulp away at each of its two roundings (x @ E^T, then + b), at
# most 2 ulps at the top of the range. The kernel's NLL / lse / ids are held
# to the plain CE over its own logits (CE_NLL_ABS, ids exact); against the
# plain version the NLL moves by at most 2 dl (dl = the largest logit
# difference: lse and the target logit each by dl), and the ids must agree
# wherever the plain top-2 logits are more than 2 dl apart, and on at least
# HEAD_IDS_SHARE of all rows. Flash equals store bit for bit (the same code
# computes each tile). The backward on the same logits: g within one bf16
# ulp of its largest (CE_GRAD_REL), dx within TRAIN_REL of its largest,
# dbias (f32 sums in another order) within HEAD_DBIAS_REL; the table
# gradient (bf16 products summed in f32 in another order) within
# HEAD_DTABLE_REL. The first fused-head training step's loss within
# HEAD_LOSS_REL of the default path's on the same weights and dropout.
HEAD_IDS_SHARE, HEAD_DBIAS_REL, HEAD_DTABLE_REL, HEAD_LOSS_REL = 0.99, 1e-3, 1e-4, 1e-3
HEAD_MODES, FUSED_STEPS = ("store", "flash"), 4
# the bias before each hidden site of the mask-visible layer: large enough
# that VISIBLE_BIAS / (1 - 0.1) - mean stays above the O(1) LayerNorm input
# it is added to in every row
VISIBLE_BIAS = 1000.0
TRAIN_BATCH, GRAD_BATCH, TRAIN_STEPS, VOCAB = 2048, 256, 8, 30522
# the H100 SXM's published peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
# AMSGrad phase: steps, and the ops per element of its formula (5 multiplies,
# 4 adds, 2 divisions, a square root and a max: 13)
ADAM_STEPS, ADAM_OPS = 3, 13
# engine phase: corpus cut (8 verbs and 8 objects per pool: 36,864 clean
# sentences), train batches per epoch kept by lim_batches_train_pct
ENGINE_CUT, ENGINE_EPOCHS, ENGINE_TRAIN_PCT = dict(num_verbs=8, num_objects=8), 2, 0.3
# f32 phase: the kernels' f32 instances (f32 is JAX's parity dtype) against
# their f32 plain versions. A forward output within F32_FWD of its largest
# magnitude, a gradient within F32_GRAD (f32 sums in another order; the
# GEMM's 3xTF32 products sit within a few 1e-7 of f32 ones), the CE NLL
# within F32_NLL_REL relative; an f32 step of the kernel route against the
# plain route's from the same weights and dropout: the loss within
# F32_LOSS_REL relative, the gradients within F32_GRAD global rel L2; a
# served run's reconstruction ids and codes equal to the plain route's on
# F32_SERVE_SAME of the tokens (an argmax near tie may go either way).
# PEAK_TF32: the TF32 tensor cores' dense peak. An f32-accurate product on
# the tensor cores costs three TF32 products (3xTF32; a six-product bf16
# split gives the same 165 TFLOP/s), so PEAK_3XTF32 bounds every f32 GEMM
# product (the layer's, #9, #10 and the table gradient); the f32 FMA bound
# (PEAK_F32) is printed beside it; the f32 layer forward and backward (#1,
# #2), whose products are most of their operations, take it too, and so do
# the f32 attention's products (3xTF32 on mma.sync), though bytes bound
# them.
F32_FWD, F32_GRAD, F32_NLL_REL, F32_LOSS_REL, F32_SERVE_SAME = 2e-5, 1e-4, 1e-5, 1e-5, 0.999
PEAK_TF32, F32_STEPS, F32_GPT2_LAYERS = 494.7e12, 4, 2
PEAK_3XTF32 = PEAK_TF32 / 3
# multi-device phase: steps of the one-rank NCCL meshes at TRAIN_BATCH; the
# two gloo ranks' global batch and steps; their first loss held to the
# one-process step's within MESH_LOSS_REL (bf16 CE over the whole batch in
# another row split)
MESH_STEPS, MESH_BATCH, MESH_GLOO_STEPS = 3, 512, 2
MESH_LOSS_REL = 1e-3
# twin phase: epochs of the parity harness's Bagon, and how far below the
# CPU's val token accuracy the card's may sit (the harness's own bar)
TWIN_EPOCHS, TWIN_GAP = 2, 0.02
# long phase: the general paths past the one-pass kernels' limits. The VQ
# (#5) at LONG_CODES and 1,024 codes (D 768 and 1,280), and on an
# adversarial codebook, and the codebook gradient (5+) over the grouped
# rows, at the step's 24,576 rows; the attention past
# 32 tokens (csrc/attention_long.cu) at LONG_SEQ tokens x LONG_BATCH
# sentences, the 64-token step's shape, timed, and at 512 tokens; the
# training steps at vq_n_e LONG_CODES (batch 2048 x 12) and at LONG_SEQ
# tokens (batch LONG_BATCH; in f32 at LONG_F32_BATCH), LONG_STEPS each
LONG_CODES, LONG_SEQ, LONG_BATCH, LONG_F32_BATCH, LONG_STEPS = 512, 64, 256, 64, 4
# wide phase: the hidden widths and head sizes past the first kernels'
# limits. The LayerNorm kernels alone at WIDE_LN_ROWS x WIDE_LN_WIDTHS (the
# kernels line's rows at WIDE_LN_TABLE, the gpt2-large step's 3,072 rows);
# the attention at WIDE_HEADS x WIDE_SEQS ((tokens, sentences); the line's
# rows at WIDE_ATTN_TABLE, the head_dim-192 step's shape, and WIDE_ATTN_LONG,
# the same heads at 512 tokens, #11-#13's rows there); the training
# steps, WIDE_STEPS each, at batch WIDE_BATCH (f32: WIDE_F32_BATCH) at the
# widths of GPT2_LARGE: Hugging Face's gpt2-large config (n_embd 1,280,
# n_head 20, n_layer 36, n_inner 5,120; its vocabulary GPT2_VOCAB and 1,024
# positions are the GPT-2 decoder's own), the encoder and VQ at that width
WIDE_LN_ROWS, WIDE_LN_WIDTHS, WIDE_LN_TABLE = (3072, 24576), (1032, 1280, 1600, 4096, 8200), (
    3072, 1280)
WIDE_HEADS, WIDE_ATTN_TABLE, WIDE_ATTN_LONG = (136, 192, 256, 384, 768), (192, 12), (192, 512)
WIDE_SEQS = ((12, 2048), (33, 256), (64, 256), (512, 16))
WIDE_BATCH, WIDE_F32_BATCH, WIDE_STEPS = 256, 64, 4
GPT2_LARGE = dict(hidden_size=1280, num_heads=20, num_layers=36, intermediate_size=5120,
                  vq_e_dim=1280)
MESH_KERNELS = ("layer_fwd", "layer_bwd", "vq", "codebook_grad", "head_ce_fwd", "head_ce_bwd",
                "table_grad", "adam")
MESH_GLOO_KERNELS = ("layer_fwd", "layer_bwd", "vq", "codebook_grad", "ce_fwd_ids", "ce_bwd",
                     "adam")


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _require_checkout_and_card():
    if not os.path.isdir(os.path.join(ROOT, "kindergarten_vq_vae_torch")):
        sys.exit("chip_smoke.py runs from a checkout of the repository "
                 "(kindergarten_vq_vae_torch/ not found beside it)")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)


def _time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls.
    Python's cyclic collector is paused meanwhile: a collection over this
    process's heap stalls the host for milliseconds, which the device's
    clock would count against a call of ~0.05 ms."""
    import gc

    import torch

    gc.disable()
    try:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / iters


def _paired_ms(kernel_fn, plain_fn, iters: int = 50) -> tuple[float, float]:
    """Both versions in turns (plain, kernel, kernel, plain); means of each pair."""
    p1, k1 = _time_ms(plain_fn, iters), _time_ms(kernel_fn, iters)
    k2, p2 = _time_ms(kernel_fn, iters), _time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph and
    the graph replayed between CUDA events, so no host time falls between
    the kernels (where a call's host work outlasts its kernels, events around
    many calls time the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, reps) / calls


def _paired_graph_ms(kernel_fn, plain_fn, iters: int = 10) -> tuple[float, float]:
    """``_paired_ms`` with the kernel timed as a CUDA graph (``_graph_ms``):
    for calls whose host work outlasts their kernels."""
    p1, k1 = _time_ms(plain_fn, iters), _graph_ms(kernel_fn)
    k2, p2 = _graph_ms(kernel_fn), _time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its count goes under."""
    from kindergarten_vq_vae_torch.ops.adam import amsgrad_update
    from kindergarten_vq_vae_torch.ops.attention import mha_forward
    from kindergarten_vq_vae_torch.ops.ce import ce_bwd, ce_fwd, ce_fwd_ids
    from kindergarten_vq_vae_torch.ops.gemm import gemm
    from kindergarten_vq_vae_torch.ops.head_ce import head_ce_bwd, head_ce_fwd, table_grad
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_forward,
        column_sums,
        fused_bert_layer,
        layer_backward,
        layernorm_backward,
        residual_layernorm,
    )
    from kindergarten_vq_vae_torch.ops.sdpa import sdpa_backward, sdpa_forward
    from kindergarten_vq_vae_torch.ops.vq import codebook_grad
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    return {"layer_fwd": fused_bert_layer, "layer_bwd": layer_backward,
            "attn_fwd": attention_forward, "attn_bwd": attention_backward,
            "vq": vector_quantize_kernel, "codebook_grad": codebook_grad,
            "ce_fwd_ids": ce_fwd_ids, "ce_fwd": ce_fwd, "ce_bwd": ce_bwd,
            "head_ce_fwd": head_ce_fwd, "head_ce_bwd": head_ce_bwd, "table_grad": table_grad,
            "adam": amsgrad_update,
            "sdpa_fwd": sdpa_forward, "sdpa_bwd": sdpa_backward, "mha": mha_forward,
            "gemm": gemm, "ln_fwd": residual_layernorm, "ln_bwd": layernorm_backward,
            "colsum": column_sums}


# wrappers whose launches are split into self- and cross-attention
_SPLIT = ("attn_fwd", "attn_bwd", "sdpa_fwd", "sdpa_bwd")


def _counters() -> dict:
    """Every wrapper's launch count; the attention kernels' split into self
    and cross, the layer forwards that kept residuals (training) apart, and
    the layer GEMM's launches inside layer forwards (``gemm_in_fwd``, a share
    of ``gemm``)."""
    w = _wrappers()
    counts = {k: fn.launches for k, fn in w.items()}
    for k in _SPLIT:
        cross = w[k].cross_launches
        counts.update({f"{k}_self": counts.pop(k) - cross, f"{k}_cross": cross})
    counts["layer_fwd_resid"] = w["layer_fwd"].residual_launches
    counts["gemm_in_fwd"] = w["gemm"].forward_launches
    counts.update({f"{k}_f32": w[k].f32_launches for k in F32_KERNELS})
    counts.update({f"{k}_wide": w[k].wide_launches for k in WIDE_KERNELS})
    return counts


def _reset_counters() -> None:
    w = _wrappers()
    for fn in w.values():
        fn.launches = 0
    for k in _SPLIT:
        w[k].cross_launches = 0
    w["layer_fwd"].residual_launches = 0
    w["gemm"].forward_launches = 0
    for k in F32_KERNELS:
        w[k].f32_launches = 0
    for k in WIDE_KERNELS:
        w[k].wide_launches = 0


# wrappers with an f32 instance: ``_counters`` adds each one's f32 share as
# ``<name>_f32``
F32_KERNELS = ("layer_fwd", "layer_bwd", "attn_fwd", "attn_bwd", "ce_fwd_ids", "ce_fwd",
               "ce_bwd", "gemm", "ln_fwd", "ln_bwd", "colsum", "head_ce_fwd", "head_ce_bwd",
               "table_grad", "sdpa_fwd", "sdpa_bwd", "mha")


# wrappers whose kernels have a wide path: the LayerNorm's rows past 1,024
# (a block a row) and the attention's heads past 128 columns (the long
# path's chunks); ``_counters`` adds each one's wide share as ``<name>_wide``
WIDE_KERNELS = ("ln_fwd", "ln_bwd", "attn_fwd", "attn_bwd", "sdpa_fwd", "sdpa_bwd", "mha")


def _as_wide(want: dict, rows: bool, heads: bool) -> dict:
    """Expected counts of a run whose LayerNorm rows (``rows``) or heads
    (``heads``) take the wide paths: ``want`` with those launches counted
    again as wide ones."""
    out = dict(want)
    for k, on in (("ln_fwd", rows), ("ln_bwd", rows), ("attn_fwd", heads), ("attn_bwd", heads),
                  ("sdpa_fwd", heads), ("sdpa_bwd", heads), ("mha", heads)):
        out[f"{k}_wide"] = (want[f"{k}_self"] + want[f"{k}_cross"] if k in _SPLIT
                            else want[k]) if on else 0
    return out


def _as_f32(want: dict) -> dict:
    """Expected counts of an f32 run: ``want`` with every launch of a kernel
    that has an f32 instance counted again as an f32 one."""
    out = dict(want)
    for k in F32_KERNELS:
        out[f"{k}_f32"] = (want[f"{k}_self"] + want[f"{k}_cross"] if k in _SPLIT
                           else want[k])
    return out


def _inside_layers(forwards: int, backwards: int = 0, encoder_forwards: int = 0,
                   encoder_backwards: int = 0, layers: int = 12) -> dict:
    """The launches of the layer GEMM, of the attention forward and of the
    LayerNorm and column-sum kernels made inside the layer kernels in that
    many model forwards (``layers`` encoder and as many decoder layers),
    backwards and encoder-only forwards and backwards, as counted: a
    residual + LayerNorm after each
    projection into the residual stream (2 an encoder layer, 3 a decoder
    layer), a LayerNorm backward for each, and the column sums of bqkv (and
    of a decoder's bq and bkv; b1 comes from a GEMM's epilogue)."""
    from kindergarten_vq_vae_torch.ops.layer import LayerGeom, layer_gemms

    geom = dict(num_heads=12, head_dim=64, intermediate=3072, eps=1e-12, gelu_exact=True)
    enc = layer_gemms(LayerGeom(causal=False, has_cross=False, **geom))
    dec = layer_gemms(LayerGeom(causal=True, has_cross=True, **geom))
    L = layers
    fwd = L * (forwards * (enc[0] + dec[0]) + encoder_forwards * enc[0])
    bwd = L * (backwards * (enc[1] + dec[1]) + encoder_backwards * enc[1])
    return {"gemm": fwd + bwd, "gemm_in_fwd": fwd,
            "attn_fwd_self": L * (2 * forwards + encoder_forwards),
            "attn_fwd_cross": L * forwards,
            "ln_fwd": L * (5 * forwards + 2 * encoder_forwards),
            "ln_bwd": L * (5 * backwards + 2 * encoder_backwards),
            "colsum": L * (4 * backwards + encoder_backwards)}


def _nbytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (nested in tuples and lists)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += _nbytes(*o)
    return total


def _bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time in ms for the work: the larger of its bytes over the
    card's memory rate and its operations over ``peak``, and which it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer_flops(b: int, s: int, decoder: bool, H: int = 768, F: int = 3072,
                 nh: int = 12) -> float:
    """Matrix-product FLOPs of one post-LN BERT layer forward (self attention,
    the cross attention of a decoder over ``s`` encoder positions, the MLP)."""
    M, hd = b * s, H // nh
    f = 2 * M * H * 3 * H + 2 * M * H * H + 4 * M * H * F + 4 * b * nh * s * s * hd
    if decoder:
        f += 2 * M * H * H + 4 * M * H * H + 2 * M * H * H + 4 * b * nh * s * s * hd
    return f


def phase_device() -> tuple[str, str]:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {name}")
    print(f"nvidia-smi name,power.limit: {smi}")
    return name, smi


def phase_build() -> None:
    from kindergarten_vq_vae_torch import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.LIB_PATH})")
    entry = spill = ""  # ptxas -v: each kernel's name, spills, then registers
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"  {entry[-72:]}: {line.split(':', 1)[-1].strip()}; {spill}")


def _layer_case(decoder: bool, g, batch: int = BUCKET, rate: float = 0.0, dtype=None):
    import torch

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS, LayerGeom

    dev = torch.device("cuda")
    H, NH, F = 768, 12, 3072
    geom = LayerGeom(num_heads=NH, head_dim=H // NH, intermediate=F, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=rate, hid_rate=rate)
    dtype = dtype or torch.bfloat16
    x = torch.randn(batch, SEQ, H, device=dev, generator=g).to(dtype)
    enc = torch.randn(batch, SEQ, H, device=dev, generator=g).to(dtype) if decoder else None
    lens = torch.randint(1, SEQ + 1, (batch,), device=dev, generator=g)
    smask = (torch.arange(SEQ, device=dev)[None] < lens[:, None]).to(torch.int32)
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        r = torch.randn(shapes[n], device=dev, generator=g)
        ws.append((0.02 * r).to(dtype) if n.startswith("w") else 1.0 + 0.1 * r if n.startswith("g")
                  else 0.02 * r)
    return geom, x, enc, smask, ws


# the layer's products at the bert-base width: (name, in, out, the forward's
# epilogue, the data gradient's epilogue); the decoder's wkv runs over the
# encoder's rows (as many: s_k = 12)
LAYER_PRODUCTS = (("wqkv", 768, 2304, "bf16", "add_bf16"), ("wo", 768, 768, "f32", "bf16"),
                  ("w1", 768, 3072, "gelu_erf", "add_f32"), ("w2", 3072, 768, "f32", "dgelu_erf"),
                  ("wq", 768, 768, "bf16", "add_f32"), ("wco", 768, 768, "f32", "bf16"),
                  ("wkv", 768, 1536, "bf16", "f32"))
# the layer GEMM vs its plain version on the card: an f32 output within
# GEMM_REL of the largest magnitude of the plain version's (f32 sums of up to
# 3,072 products in another order, tanhf ulps in the GELU epilogues); a bf16
# output within half a bf16 ulp of the plain version's f32 value before its
# rounding, plus the same GEMM_REL
GEMM_REL = 1e-4


def _gemm_excess(got, want) -> float:
    """How far ``got`` lies outside its bar around the f32 value ``want``
    (GEMM_REL; plus half a bf16 ulp for a bf16 output): <= 0 passes."""
    import torch

    tol = GEMM_REL * want.abs().max().item() + torch.zeros_like(want)
    if got.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 8)
    return ((got.float() - want).abs() - tol).max().item()


def phase_layer_gemms(names: tuple[str, str]) -> dict:
    """The layer GEMM (``ops/gemm.py``) at every product of the batch-2048
    step (24,576 rows: forward NN, data gradient NT, weight gradient TN, each
    with the step's epilogue) and the forward at the bucket-256 serving rows
    (3,072): held against ``gemm_reference`` (f32 ``torch.matmul``, TF32 off),
    timed beside it, its TFLOP/s and share of the bf16 peak, and
    ``torch.matmul`` in bf16 at the same shape as the yardstick; one weight
    gradient run twice must give the same bits."""
    import torch

    from kindergarten_vq_vae_torch.ops.gemm import (
        gelu,
        gelu_grad,
        gemm,
        gemm_plan,
        gemm_reference,
        sm_count,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    res = {k: {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [], "library_ms": [],
               "flops": 0.0} for k in ("fwd", "grad")}
    sms = sm_count(torch.device("cuda"))
    for rows in (TRAIN_BATCH * SEQ, BUCKET * SEQ):
        for name, k_in, k_out, fwd_epi, dgrad_epi in LAYER_PRODUCTS:
            x = torch.randn(rows, k_in, device="cuda", generator=g).bfloat16()
            w = (torch.randn(k_in, k_out, device="cuda", generator=g) / k_in ** 0.5).bfloat16()
            bias = 0.02 * torch.randn(k_out, device="cuda", generator=g)
            dy = (0.1 * torch.randn(rows, k_out, device="cuda", generator=g)).bfloat16()
            aux = None
            if dgrad_epi.startswith("add"):
                aux = torch.randn(rows, k_in, device="cuda", generator=g)
            elif dgrad_epi.startswith("dgelu"):
                aux = (2.0 * torch.randn(rows, k_in, device="cuda", generator=g)).bfloat16()
            cases = [("fwd", "NN", (x, w), dict(epi=fwd_epi, bias=bias), lambda: x @ w,
                      (rows, k_out, k_in))]
            if rows == TRAIN_BATCH * SEQ:
                cases += [("dgrad", "NT", (dy, w), dict(b_t=True, epi=dgrad_epi, aux=aux),
                           lambda: dy @ w.t(), (rows, k_in, k_out)),
                          ("wgrad", "TN", (x, dy), dict(a_t=True, epi="bf16"),
                           lambda: x.t() @ dy, (k_in, k_out, rows))]
            for kind, layout, ops, kw, lib, (M, N, K) in cases:
                two = kw["epi"].startswith(("gelu", "dgelu"))
                got = gemm(*ops, **kw, out2=two)
                torch.cuda.synchronize()
                got = got if two else (got,)
                acc = gemm_reference(*ops, a_t=kw.get("a_t", False), b_t=kw.get("b_t", False),
                                     bias=kw.get("bias"))
                epi = kw["epi"]
                if epi.startswith("gelu"):
                    want = (gelu(acc, True), acc)
                elif epi.startswith("add"):
                    want = (acc + aux,)
                elif epi.startswith("dgelu"):
                    want = (acc * gelu_grad(aux.float(), True),) * 2
                else:
                    want = (acc,)
                excess = max(_gemm_excess(a, b) for a, b in zip(got, want))
                err = max((a.float() - b).abs().max().item() for a, b in zip(got, want))
                if not all(_finite(a) for a in got) or excess > 0:
                    _fail(f"layer GEMM {name} {kind} ({M}, {N}, {K}) {epi} disagrees with its "
                          f"plain version (excess {excess:.3e})")
                k_ms, p_ms = _paired_ms(lambda: gemm(*ops, **kw, out2=two),
                                        lambda: gemm_reference(*ops, **kw, out2=two), 10)
                lib_ms = _time_ms(lib, 10)
                flops = 2.0 * M * N * K
                bound = _bound(flops, _nbytes(ops, kw.get("bias"), kw.get("aux"), got),
                               PEAK_BF16)
                plan = gemm_plan(M, N, K, kind == "wgrad", sms, epi)
                tf = flops / k_ms / 1e9
                line = (f"layer GEMM {name:4s} {kind:5s} {layout} ({M},{N},{K}) {epi:9s} tile "
                        f"{plan.tile_n} splits {plan.splits}: {k_ms:.4f} ms, {tf:.1f} TFLOP/s "
                        f"({tf / (PEAK_BF16 / 1e12):.3f} of peak), torch.matmul bf16 "
                        f"{lib_ms:.4f} ms ({k_ms / lib_ms:.3f}x), plain {p_ms:.4f} ms, bound "
                        f"{bound[0]:.4f} ms, max abs {err:.3e}")
                print(line)
                if rows == TRAIN_BATCH * SEQ:
                    r = res["fwd" if kind == "fwd" else "grad"]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["ms"].append(k_ms)
                    r["plain_ms"].append(p_ms)
                    r["bound"].append(bound)
                    r["library_ms"].append(lib_ms)
                    r["flops"] += flops
                del got, acc, want
            if rows == TRAIN_BATCH * SEQ and name == "wo":
                one = gemm(x, dy, a_t=True, epi="bf16")
                two_ = gemm(x, dy, a_t=True, epi="bf16")
                torch.cuda.synchronize()
                same = torch.equal(one, two_)
                print(f"layer GEMM weight gradient ({k_in},{k_out}) over {rows} rows, twice: "
                      f"bit for bit equal {same}")
                if not same:
                    _fail("the layer GEMM's weight gradient differs from run to run")
            del x, w, bias, dy, aux
    torch.cuda.empty_cache()
    out = {}
    for k, r in res.items():
        out[k] = {"max_abs_err": r["max_abs_err"], "ms": statistics.mean(r["ms"]),
                  "plain_ms": statistics.mean(r["plain_ms"]), "bound": r["bound"],
                  "library_ms": statistics.mean(r["library_ms"]),
                  "library": "torch.matmul, bf16, at each shape"}
        print(f"layer GEMM {k} at {TRAIN_BATCH * SEQ} rows: {len(r['ms'])} shapes, sum "
              f"{sum(r['ms']):.3f} ms ({r['flops'] / sum(r['ms']) / 1e9:.1f} TFLOP/s), "
              f"torch.matmul {sum(r['library_ms']):.3f} ms ({names[0]}; nvidia-smi: {names[1]})")
    return out


# LayerNorm kernels vs plain (phase 2c; the bars of tests/test_torch_cuda.py):
# bf16 outputs at the GEMM's bar around the plain f32 value (_gemm_excess:
# means summed in another order move the f32 value by ~1e-7 and flip an
# occasional rounding), f32 rows (rsqrt, dr) within LN_REL of their largest
# magnitude; column sums over 24,576 rows within COLSUM_REL of theirs (f32
# sums in another order; for b1 also the GEMM's GEMM_REL).
LN_REL, COLSUM_REL = 1e-5, 1e-4


def phase_layernorm(names: tuple[str, str]) -> dict:
    """The LayerNorm and column-sum kernels of ``csrc/layernorm.cu`` alone
    at the batch-2048 step's shapes, each held against its plain version and
    timed in turns with it, beside its byte bound and library yardstick; the
    GELU-gradient GEMM with b1 in its epilogue; the sums twice, bit for bit."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.dropout import OP_MLP_OUT, hidden_keep
    from kindergarten_vq_vae_torch.ops.gemm import gelu_grad, gemm, gemm_reference
    from kindergarten_vq_vae_torch.ops.layer import (
        column_sums,
        column_sums_reference,
        layernorm_backward,
        layernorm_backward_reference,
        residual_layernorm,
        residual_layernorm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    M, H, F_, rate, eps, seed, dev = TRAIN_BATCH * SEQ, 768, 3072, 0.1, 1e-12, 1234, "cuda"
    gamma = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
    beta = 0.1 * torch.randn(H, device=dev, generator=g)
    keep = hidden_keep(seed, OP_MLP_OUT, M, H, rate, dev)
    res = {}

    def report(key, what, err, k_ms, p_ms, bound, lib_ms, lib):
        print(f"{what}: {k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, share "
              f"{bound[0] / k_ms:.3f}), plain {p_ms:.4f} ms, {lib} {lib_ms:.4f} ms, max abs "
              f"{err:.3e} ({names[0]}; nvidia-smi: {names[1]})")
        r = res.setdefault(key, {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [],
                                 "library_ms": [], "library": lib})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound", bound), ("library_ms", lib_ms)):
            r[k].append(v)

    # residual + LayerNorm: x bf16, a f32 (a projection's output), dropout 0.1
    x = torch.randn(M, H, device=dev, generator=g).bfloat16()
    a = 0.5 * torch.randn(M, H, device=dev, generator=g) + 0.2
    out, inv = residual_layernorm(x, a, gamma, beta, eps, seed, OP_MLP_OUT, rate)
    torch.cuda.synchronize()
    r = x.float() + a * keep
    mu = r.mean(-1, keepdim=True)
    want_inv = torch.rsqrt(torch.clamp((r * r).mean(-1, keepdim=True) - mu * mu, min=0.0) + eps)
    want = (r - mu) * want_inv * gamma + beta
    excess = max(_gemm_excess(out, want), _rel_max(inv, want_inv[:, 0]) - LN_REL)
    if not _finite(out) or excess > 0:
        _fail(f"residual_layernorm disagrees with its plain version (excess {excess:.3e})")
    k_ms, p_ms = _paired_ms(
        lambda: residual_layernorm(x, a, gamma, beta, eps, seed, OP_MLP_OUT, rate),
        lambda: residual_layernorm_reference(x, a, gamma, beta, eps,
                                             hidden_keep(seed, OP_MLP_OUT, M, H, rate, dev)), 20)
    lib_ms = _time_ms(lambda: F.layer_norm(x.float() + a, (H,), gamma, beta, eps), 20)
    report("ln_fwd", f"residual_layernorm ({M},{H}) dropout {rate}",
           (out.float() - want).abs().max().item(), k_ms, p_ms,
           _bound(0.0, _nbytes(x, a, gamma, beta, out, inv), PEAK_F32), lib_ms,
           "x + a then F.layer_norm (f32, no dropout)")
    del x, a, out, inv, r, want

    # LayerNorm backward, with a bf16 upstream (a layer's output gradient) and
    # an f32 one (dxm, dx1)
    v = torch.randn(M, H, device=dev, generator=g).bfloat16()
    inv = 0.5 + 1.5 * torch.rand(M, device=dev, generator=g)
    rows = torch.randn(M, H, device=dev, generator=g)  # f32 pre-LN rows for the yardstick
    mean_r = rows.mean(-1, keepdim=True)
    rstd_r = torch.rsqrt(rows.var(-1, unbiased=False, keepdim=True) + eps)
    for gy_dtype in (torch.bfloat16, torch.float32):
        gy = torch.randn(M, H, device=dev, generator=g).to(gy_dtype)
        got = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
        torch.cuda.synchronize()
        want = layernorm_backward_reference(gy, v, inv, gamma, beta, keep)
        excess = max(_rel_max(got[0], want[0]) - LN_REL, _gemm_excess(got[1], want[1]),
                     *(_rel_max(a_, b_) - COLSUM_REL for a_, b_ in zip(got[2:], want[2:])))
        again = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got[2:], again[2:]))
        if not all(_finite(t) for t in got) or excess > 0 or not same:
            _fail(f"layernorm_backward ({gy_dtype}) disagrees with its plain version (excess "
                  f"{excess:.3e}) or its sums differ from run to run ({same})")
        err = max((a_.float() - b_).abs().max().item() for a_, b_ in zip(got, want))
        k_ms, p_ms = _paired_ms(
            lambda: layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate),
            lambda: layernorm_backward_reference(gy, v, inv, gamma, beta,
                                                 hidden_keep(seed, OP_MLP_OUT, M, H, rate, dev)),
            20)
        gy32 = gy.float()
        lib_ms = _time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            gy32, rows, (H,), mean_r, rstd_r, gamma, beta, (True, True, True)), 20)
        report("ln_bwd", f"layernorm_backward ({M},{H}) gy {str(gy_dtype)[6:]}, dropout {rate}, "
               f"sums bit for bit twice {same}", err, k_ms, p_ms,
               _bound(0.0, _nbytes(gy, v, inv, gamma, beta, got), PEAK_F32), lib_ms,
               "aten.native_layer_norm_backward (f32 rows; no keep mask, no da)")
        del gy, got, want, again, gy32
    del v, inv, rows

    # the bias column sums of the bf16 gradients: bq (768), bkv (1,536), bqkv (2,304)
    for N in (768, 1536, 2304):
        src = torch.randn(M, N, device=dev, generator=g).bfloat16()
        got = column_sums(src)
        torch.cuda.synchronize()
        want = column_sums_reference(src)
        same = torch.equal(got, column_sums(src))
        if not _finite(got) or _rel_max(got, want) > COLSUM_REL or not same:
            _fail(f"column_sums ({M},{N}) disagrees with its plain version or differs from run "
                  "to run")
        k_ms, p_ms = _paired_ms(lambda: column_sums(src), lambda: column_sums_reference(src), 20)
        lib_ms = _time_ms(lambda: src.sum(0, dtype=torch.float32), 20)
        report("colsum", f"column_sums ({M},{N}), bit for bit twice {same}",
               (got - want).abs().max().item(), k_ms, p_ms,
               _bound(0.0, _nbytes(src, got), PEAK_F32), lib_ms, "src.sum(0, dtype=torch.float32)")
        del src, got, want

    # the GELU-gradient GEMM: du = (dy @ w2^T) * gelu'(u) in bf16, b1 in its epilogue
    dy = (0.1 * torch.randn(M, H, device=dev, generator=g)).bfloat16()
    w2 = (torch.randn(F_, H, device=dev, generator=g) / H ** 0.5).bfloat16()
    u = (2.0 * torch.randn(M, F_, device=dev, generator=g)).bfloat16()
    kw = dict(b_t=True, epi="dgelu_erf", aux=u)
    du, b1 = gemm(dy, w2, **kw, colsum=True)
    torch.cuda.synchronize()
    du_f32 = gemm_reference(dy, w2, b_t=True) * gelu_grad(u.float(), True)
    rel = _rel_max(b1, du_f32.sum(0))
    same = torch.equal(b1, gemm(dy, w2, **kw, colsum=True)[1])
    excess = _gemm_excess(du, du_f32)
    if excess > 0 or rel > COLSUM_REL or not same:
        _fail(f"the GELU-gradient GEMM's b1 disagrees with the plain f32 du's column sums "
              f"(rel {rel:.3e}, du excess {excess:.3e}) or differs from run to run ({same})")
    new_ms = _time_ms(lambda: gemm(dy, w2, **kw, colsum=True), 10)
    out2_ms = _time_ms(lambda: gemm(dy, w2, **kw, out2=True), 10)
    flops = 2.0 * M * F_ * H
    print(f"GELU-gradient GEMM ({M},{F_},{H}) with b1 in its epilogue: {new_ms:.4f} ms "
          f"({flops / new_ms / 1e9:.1f} TFLOP/s), b1 rel {rel:.3e} of its largest, bit for bit "
          f"twice {same}; writing the f32 du instead (out2=True): {out2_ms:.4f} ms "
          f"({flops / out2_ms / 1e9:.1f} TFLOP/s) ({names[0]}; nvidia-smi: {names[1]})")
    del dy, w2, u, du, b1, du_f32
    torch.cuda.empty_cache()
    return {key: {"max_abs_err": r["max_abs_err"], "ms": statistics.mean(r["ms"]),
                  "plain_ms": statistics.mean(r["plain_ms"]), "bound": r["bound"],
                  "library_ms": statistics.mean(r["library_ms"]), "library": r["library"]}
            for key, r in res.items()}


def phase_kernels() -> dict:
    import torch

    from kindergarten_vq_vae_torch.ops.layer import bert_layer_reference, fused_bert_layer
    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED)
    res = {"layer": {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [],
                     "library_ms": []}, "vq": {}}
    with torch.inference_mode():
        for decoder in (False, True):
            geom, x, enc, smask, ws = _layer_case(decoder, g)
            out = fused_bert_layer(geom, x, enc, smask, None, ws)
            torch.cuda.synchronize()
            ref = bert_layer_reference(geom, x, enc, smask, None, ws)
            lib_fn = _library_layer(decoder, x, enc, smask, ws)
            lib_err = (lib_fn().float() - ref.float()).abs().max().item()
            err = (out.float() - ref.float()).abs()
            mx, mean = err.max().item(), err.mean().item()
            what = "decoder (causal + cross)" if decoder else "encoder"
            print(f"layer {what} ({BUCKET},{SEQ},768) bf16: max abs {mx:.4e} (tol {LAYER_MAX_ABS}), "
                  f"mean abs {mean:.4e} (tol {LAYER_MEAN_ABS}), finite {bool(torch.isfinite(out).all())}")
            if not (torch.isfinite(out).all() and mx <= LAYER_MAX_ABS and mean <= LAYER_MEAN_ABS):
                _fail(f"layer kernel disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(lambda: fused_bert_layer(geom, x, enc, smask, None, ws),
                                    lambda: bert_layer_reference(geom, x, enc, smask, None, ws))
            lib_ms = _time_ms(lib_fn)
            bound = _bound(_layer_flops(BUCKET, SEQ, decoder), _nbytes(x, enc, smask, ws, out),
                           PEAK_BF16)
            print(f"layer {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), nn.Transformer{'Decoder' if decoder else 'Encoder'}"
                  f"Layer {lib_ms:.4f} ms (max abs {lib_err:.3e} from the plain version)")
            res["layer"]["max_abs_err"] = max(res["layer"]["max_abs_err"], mx)
            res["layer"]["ms"].append(k_ms)
            res["layer"]["plain_ms"].append(p_ms)
            res["layer"]["bound"].append(bound)
            res["layer"]["library_ms"].append(lib_ms)

        n_e, d = 9, 768
        z = torch.randn(BUCKET, SEQ, d, device="cuda", generator=g)
        e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
        centers = 361.0 + 1e-3 * torch.randn(n_e, d, device="cuda", generator=g, dtype=torch.float64)
        assign = torch.randint(0, n_e, (BUCKET * SEQ,), device="cuda", generator=g)
        z_far = (centers[assign] + 2e-4 * torch.randn(BUCKET * SEQ, d, device="cuda", generator=g,
                                                      dtype=torch.float64)).float().reshape(z.shape)
        max_err = 0.0  # over the kernel's float outputs at the serving shape (random case)
        for case, (zz, ee) in (("random", (z, e)), ("far from origin", (z_far, centers.float()))):
            k = vector_quantize_kernel(zz, ee, 0.69)
            torch.cuda.synchronize()
            p = vector_quantize(zz, ee, 0.69)
            exact = (torch.equal(k.indices, p.indices) and torch.equal(k.z_q, p.z_q)
                     and torch.equal(k.counts, p.counts))
            rel = {f: (abs(getattr(k, f) - getattr(p, f)).max() / abs(getattr(p, f)).max()).item()
                   for f in ("loss", "perplexity", "sum_z")}
            if case == "random":
                max_err = max((getattr(k, f) - getattr(p, f)).abs().max().item()
                              for f in ("z_q", "sum_z", "loss", "perplexity"))
            print(f"vq {case} ({BUCKET * SEQ},{d})x{n_e} f32: idx/z_q/counts exact {exact}, "
                  f"rel err loss {rel['loss']:.2e} perplexity {rel['perplexity']:.2e} "
                  f"sum_z {rel['sum_z']:.2e} (tol {VQ_REL})")
            if not exact or max(rel.values()) > VQ_REL:
                _fail(f"VQ kernel disagrees with its plain version ({case})")
        if not torch.equal(vector_quantize_kernel(z_far, centers.float(), 0.69).indices.reshape(-1),
                           assign):
            _fail("VQ kernel misses the true assignments far from the origin")
        res["vq"] = {"max_abs_err": max_err, **_vq_times(z, e, "serving")}
    layer = res["layer"]
    res["layer"] = {"max_abs_err": layer["max_abs_err"], "ms": statistics.mean(layer["ms"]),
                    "plain_ms": statistics.mean(layer["plain_ms"]), "bound": layer["bound"],
                    "library_ms": statistics.mean(layer["library_ms"])}
    return res


def _vq_times(z, e, what: str, general: bool = False) -> dict:
    """#5 at ``z``'s rows: the raw launch alone (the kernel's z_q is the
    straight-through value), its device time from a CUDA graph, in turns with
    the plain raw forward and the same expression; then the wrapper
    (``assemble`` included) in turns with the plain version, CUDA events
    around many calls (what a caller waits, host included); each beside the
    bound (``_vq_bound``; ``general``: the general path's) and its share of
    it; sum_z and diff the same bits in two launches."""
    import torch

    from kindergarten_vq_vae_torch.ops.vq import _core, vector_quantize, vq_raw
    from kindergarten_vq_vae_torch.ops.vq_kernel import _launch_packed, vector_quantize_kernel

    z_flat = z.reshape(-1, z.shape[-1])
    a, b = _launch_packed(z_flat, e), _launch_packed(z_flat, e)
    if not torch.equal(a[2], b[2]):
        _fail(f"VQ kernel: sum_z, counts or diff differ between two launches ({what})")
    p1 = _time_ms(lambda: _core(z_flat, e, vq_raw), 20)
    k1 = _graph_ms(lambda: _launch_packed(z_flat, e))
    k2 = _graph_ms(lambda: _launch_packed(z_flat, e))
    p2 = _time_ms(lambda: _core(z_flat, e, vq_raw), 20)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    w_ms, pw_ms = _paired_ms(lambda: vector_quantize_kernel(z, e, 0.69),
                             lambda: vector_quantize(z, e, 0.69))
    bound = _vq_bound(z, e, vector_quantize_kernel(z, e, 0.69), general)
    print(f"vq {what} ({z_flat.shape[0]},{z_flat.shape[1]})x{e.shape[0]}: kernel alone "
          f"{k_ms:.4f} ms (CUDA graph; {bound[0] / k_ms:.0%} of the {bound[1]} bound "
          f"{bound[0]:.4f} ms), plain raw + straight-through {p_ms:.4f} ms; wrapper with "
          f"assemble {w_ms:.4f} ms a call ({bound[0] / w_ms:.0%} of the bound), plain "
          f"vector_quantize {pw_ms:.4f} ms a call")
    return {"ms": k_ms, "plain_ms": p_ms, "wrapper_ms": w_ms, "plain_wrapper_ms": pw_ms,
            "bound": [bound]}


def phase_codebook_grad(names: tuple[str, str]) -> dict:
    """Phase 3's codebook gradient (``ops/vq.py`` ``codebook_grad``,
    ``csrc/vq_bwd.cu``) at the step's 24,576 rows x 768 with 9 codes and
    with 37 (``_codebook_grad_case``). The kernel line takes the step's 9
    codes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    res = {}
    for n_e in (37, 9):
        res = _codebook_grad_case(names, g, TRAIN_BATCH * SEQ, 768, n_e)
    return res


def _codebook_grad_case(names: tuple[str, str], g, rows: int, d: int, n_e: int) -> dict:
    """The codebook gradient at (rows, d) x n_e, its codes from #5 on the
    same rows: against an f64 sum of the same f32 terms and against its
    plain version (``index_add_``), each within ``CB_REL`` of the largest
    sum of the terms' magnitudes; the bits of the plain grouped sum (the
    kernels' fixed order, ``grouped_sum_reference``); two launches the same
    bits; a code no row picks exactly 0; its device time (a CUDA graph of its
    launches) in turns with the plain version's, its byte bound and the
    library call ``index_put_(accumulate=True)`` on the same terms
    (PyTorch's sort-based deterministic route); past the one-pass VQ kernel
    also from the grouping the VQ forward leaves (the training step's route),
    the same bits, and its time."""
    import torch

    from kindergarten_vq_vae_torch.ops.vq import (
        codebook_grad,
        codebook_grad_reference,
        grouped_order,
        grouped_sum_reference,
    )
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel, vq_plan

    z = torch.randn(rows, d, device="cuda", generator=g)
    e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
    e[n_e - 1] += 50.0  # far from every row: no row picks it
    with torch.no_grad():
        idx = vector_quantize_kernel(z.view(1, rows, d), e, 0.25).indices.view(-1)
    gd2 = torch.tensor(1.25 / z.numel(), device="cuda")
    got, again = codebook_grad(z, idx, e, gd2), codebook_grad(z, idx, e, gd2)
    torch.cuda.synchronize()
    plain = codebook_grad_reference(z, idx, e, gd2)
    terms = gd2 * 2.0 * (e[idx] - z)
    exact = torch.zeros(e.shape, dtype=torch.float64, device="cuda").index_add_(
        0, idx, terms.double())
    scale = torch.zeros_like(exact).index_add_(0, idx, terms.double().abs()).max()
    err = ((got.double() - exact).abs().max() / scale).item()
    plain_err = ((plain.double() - exact).abs().max() / scale).item()
    same, zero = torch.equal(got, again), bool((got[n_e - 1] == 0).all())
    used = int((torch.bincount(idx, minlength=n_e) > 0).sum())
    rpb, slots = grouped_order(rows, d, n_e, d % 4 == 0)
    bits = torch.equal(got, grouped_sum_reference(terms, idx, n_e, rpb, slots))
    print(f"codebook gradient ({rows},{d})x{n_e} f32 ({used} codes picked): kernel {err:.3e} "
          f"and plain index_add_ {plain_err:.3e} from the f64 sum, of the largest sum of "
          f"|terms| (tol {CB_REL}); two launches the same bits {same}; the unpicked code "
          f"exactly 0 {zero}; the plain grouped sum's bits {bits} ({rpb} rows a row block, "
          f"{slots} slots)")
    if not (same and zero and bits and err <= CB_REL and plain_err <= CB_REL):
        _fail(f"the codebook-gradient kernel disagrees with its plain version ({n_e} codes)")
    handed = None
    if vq_plan(rows, d, n_e)[0] == 0:  # the VQ forward's general path leaves its grouping
        from kindergarten_vq_vae_torch.ops.vq_kernel import _launch_packed

        group = _launch_packed(z, e)[3]
        if group.numel() == 0 or not torch.equal(codebook_grad(z, idx, e, gd2, group), got):
            _fail(f"the codebook gradient from the forward's grouping differs ({n_e} codes)")
        handed = _graph_ms(lambda: codebook_grad(z, idx, e, gd2, group))
    p1 = _time_ms(lambda: codebook_grad_reference(z, idx, e, gd2), 20)
    k1 = _graph_ms(lambda: codebook_grad(z, idx, e, gd2))
    k2 = _graph_ms(lambda: codebook_grad(z, idx, e, gd2))
    p2 = _time_ms(lambda: codebook_grad_reference(z, idx, e, gd2), 20)
    lib = _time_ms(lambda: torch.zeros_like(e).index_put_(
        (idx,), gd2 * 2.0 * (e[idx] - z), accumulate=True), 20)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    bound = _bound(3 * rows * d, _nbytes(z, idx, got), PEAK_F32)
    also = ("" if handed is None else
            f"; from the forward's grouping {handed:.4f} ms ({bound[0] / handed:.0%})")
    print(f"row 5+ codebook gradient ({rows},{d})x{n_e}: kernel {k_ms:.4f} ms (CUDA graph; "
          f"{bound[0] / k_ms:.0%} of the {bound[1]} bound {bound[0]:.4f} ms){also}, plain "
          f"index_add_ {p_ms:.4f} ms, index_put_(accumulate=True) {lib:.4f} ms "
          f"({names[0]}; nvidia-smi: {names[1]})")
    res = {"max_abs_err": (got - plain).abs().max().item(), "ms": k_ms, "plain_ms": p_ms,
           "bound": [bound], "library_ms": lib, "handed_ms": handed,
           "library": "torch.zeros_like(e).index_put_((idx,), g * 2 * (e[idx] - z), "
                      "accumulate=True)"}
    del z, e, idx, got, again, plain, terms, exact
    torch.cuda.empty_cache()
    return res


def _vq_general_case(names: tuple[str, str], g, rows: int, d: int, n_e: int) -> dict:
    """#5's general path (a codebook or a width past the one-pass kernel) at
    (rows, d) x n_e against the plain version: the codes equal but at f32
    near ties (the two nearest codes closer in f64 than 4 f32 ulps of the
    row's distances, where two summation orders may pick either), where the
    kernel picks one of the tied codes; z_q exactly z + (e[k] - z) of its
    codes, the counts exactly their histogram, sum_z and the loss within
    VQ_REL of the plain sums over its codes; then ``_vq_times`` (two
    launches the same bits, the times and the bound)."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel, vq_plan

    if vq_plan(rows, d, n_e)[0] != 0:
        _fail(f"VQ ({rows},{d})x{n_e}: expected the general path")
    z = torch.randn(1, rows, d, device="cuda", generator=g)
    e = (torch.rand(n_e, d, device="cuda", generator=g) * 2 - 1) / n_e
    with torch.no_grad():
        k = vector_quantize_kernel(z, e, 0.25)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.25)
    idx, z2 = k.indices.view(-1), z.view(-1, d)
    z64, e64 = z2.double(), e.double()
    c = e64.mean(0)
    zc, ec = z64 - c, e64 - c
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    tol = 4 * 2.0**-23 * ((zc * zc).sum(1) + (ec * ec).sum(1).max())
    best = dist.min(1).values
    near = dist.topk(2, 1, largest=False).values[:, 1] - best <= tol
    picked = bool((dist.gather(1, idx.view(-1, 1))[:, 0] - best <= tol).all())
    differ = idx != p.indices.view(-1)
    sums = F.one_hot(idx, n_e).float().T @ z2
    zq_ok = torch.equal(k.z_q.view(-1, d), z2 + (e[idx] - z2))
    counts_ok = torch.equal(k.counts, torch.bincount(idx, minlength=n_e).float())
    sum_err = _rel_max(k.sum_z, sums)
    loss_err = _rel_max(k.loss, ((e[idx] - z2) ** 2).sum() * 1.25 / z2.numel())
    used = int((k.counts > 0).sum())
    print(f"vq general path ({rows},{d})x{n_e} ({used} codes picked): {int(differ.sum())} codes "
          f"differ from the plain version's, {int(near.sum())} f32 near ties, every code one of "
          f"the nearest within the tie bar {picked}; z_q exact {zq_ok}, counts exact "
          f"{counts_ok}; sum_z max rel {sum_err:.3e}, loss rel {loss_err:.3e} (tol {VQ_REL})")
    if (not picked or bool((differ & ~near).any()) or not zq_ok or not counts_ok
            or sum_err > VQ_REL or loss_err > VQ_REL):
        _fail(f"the VQ general path disagrees with its plain version ({n_e} codes, D {d})")
    err = (k.sum_z - sums).abs().max().item()
    del dist, zc, ec, z64, e64, sums, k, p
    screen = _vq_screen_check(z.view(-1, d), e, f"{n_e} codes x {d}")
    times = _vq_times(z, e, f"general path, {n_e} codes", general=True)
    fma = 2 * rows * n_e * d / PEAK_F32 * 1e3
    zc32 = z.view(-1, d) - e.mean(0)
    ec32 = e - e.mean(0)
    lib = _time_ms(lambda: ((zc32 * zc32).sum(1, keepdim=True) + (ec32 * ec32).sum(1)
                            - 2.0 * torch.matmul(zc32, ec32.T)).argmin(1), 10)
    print(f"  the f32 FMA bound of the products {fma:.4f} ms ({fma / times['ms']:.0%} of it); "
          f"yardstick torch.matmul(zc, ec.T) in f32 ('highest') + the expansion's argmin "
          f"{lib:.4f} ms ({names[0]}; nvidia-smi: {names[1]})")
    del z, e, zc32, ec32
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound": times["bound"], "library_ms": None, "fma_bound_ms": fma,
            "matmul_argmin_ms": lib, **screen}


def _kernel_centre(e):
    """The general path's centre c: the codes summed in code order, then
    divided by n_e (``csrc/vq_fwd.cu`` ``vq_centre_kernel``, the same bits)."""
    import torch

    c = torch.zeros(e.shape[1], device=e.device)
    for k in range(e.shape[0]):
        c += e[k]
    return c / e.shape[0]


def _vq_screen_check(z2, e, what: str) -> dict:
    """The general path's screen (``vq_general_screen``) on (rows, D) ``z2``:
    its tensor-core products against the f64 product of the same f32
    operands (the kernel's own centre), as a share of ||z - c|| ||e_k - c||,
    held below kappa / 2 (the screen's margin is 2 kappa); the share of rows
    that rechecked more than one code and those that rechecked every code;
    sum_z the plain grouped sum's bits (``grouped_sum_reference``, the order
    of the kernel before the grouping); two launches the same bits."""
    import torch

    from kindergarten_vq_vae_torch.ops.vq import grouped_order, grouped_sum_reference
    from kindergarten_vq_vae_torch.ops.vq_kernel import vq_general_screen, vq_screen_kappa

    rows, d = z2.shape
    n_e = e.shape[0]
    _, idx, stats, cross, rechecked = vq_general_screen(z2, e)
    _, idx2, stats2, _, _ = vq_general_screen(z2, e)
    torch.cuda.synchronize()
    same = torch.equal(idx, idx2) and torch.equal(stats, stats2)
    c = _kernel_centre(e)
    x, y = (z2 - c).double(), (e - c).double()
    err = ((cross.double() - x @ y.T).abs()
           / (x.norm(dim=1, keepdim=True) * y.norm(dim=1))).max().item()
    del x, y, cross
    kappa = vq_screen_kappa(d)
    more = (rechecked > 1).float().mean().item()
    every = int((rechecked == n_e).sum())
    rpb, slots = grouped_order(rows, d, n_e, d % 4 == 0)
    bits = torch.equal(stats[:n_e * d].view(n_e, d),
                       grouped_sum_reference(z2, idx, n_e, rpb, slots))
    print(f"  screen ({what}): max |cross' - cross| / (|z - c| |e - c|) {err:.3e} (kappa "
          f"{kappa:.3e}; held below kappa / 2); rows rechecking more than one code {more:.4f}, "
          f"mean {rechecked.float().mean().item():.3f}, every code {every}; sum_z the plain "
          f"grouped sum's bits {bits} ({rpb} rows a row block, {slots} slots); two launches the "
          f"same bits {same}")
    if not (same and bits and err <= kappa / 2):
        _fail(f"the VQ general path's screen or grouped sums disagree ({what})")
    return {"screen_err": err, "kappa": kappa, "rechecked_more": more, "rechecked_every": every}


def _vq_adversarial_case(names: tuple[str, str], g, rows: int) -> dict:
    """The general path on a codebook far from the origin (512 codes x 768
    on a shell of norm 27.6, ~0.06 apart, the trained encoder the JAX
    kernel's comment measured) with duplicate codes across its 128-code
    tiles (2 = 5 = 200, 130 = 300 = 511, 128 = 129), the rows near random
    codes: the duplicates' rows take the lowest copy, the codes are the
    plain version's but at f32 near ties (where they are one of the tied
    codes), and the screen's checks (``_vq_screen_check``)."""
    import torch

    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel

    d, n_e = 768, LONG_CODES
    base = torch.randn(d, device="cuda", generator=g)
    base *= 27.6 / base.norm()
    e = base + 0.06 / 2**0.5 * torch.randn(n_e, d, device="cuda", generator=g) / d**0.5
    for a, b in ((5, 2), (200, 2), (300, 130), (511, 130), (129, 128)):
        e[a] = e[b]
    pick = torch.randint(0, n_e, (rows,), device="cuda", generator=g)
    z = e[pick] + 0.02 / d**0.5 * torch.randn(rows, d, device="cuda", generator=g)
    with torch.no_grad():
        k = vector_quantize_kernel(z.view(1, rows, d), e, 0.25)
        torch.cuda.synchronize()
        p = vector_quantize(z.view(1, rows, d), e, 0.25)
    idx = k.indices.view(-1)
    copies = bool(torch.isin(idx, torch.tensor([5, 200, 300, 511, 129], device="cuda")).any())
    z64, e64 = z.double(), e.double()
    c = e64.mean(0)
    zc, ec = z64 - c, e64 - c
    dist = (zc * zc).sum(1, keepdim=True) + (ec * ec).sum(1) - 2.0 * (zc @ ec.T)
    tol = 4 * 2.0**-23 * ((zc * zc).sum(1) + (ec * ec).sum(1).max())
    best = dist.min(1).values
    near = dist.topk(2, 1, largest=False).values[:, 1] - best <= tol
    picked = bool((dist.gather(1, idx.view(-1, 1))[:, 0] - best <= tol).all())
    differ = idx != p.indices.view(-1)
    del z64, e64, zc, ec, dist
    print(f"vq general path, adversarial ({rows},{d})x{n_e} (a shell of norm 27.6, codes ~0.06 "
          f"apart, duplicates across tiles): a later copy picked {copies}; {int(differ.sum())} "
          f"codes differ from the plain version's, {int(near.sum())} f32 near ties, every code "
          f"one of the nearest within the tie bar {picked} ({names[0]})")
    if copies or not picked or bool((differ & ~near).any()):
        _fail("the VQ general path disagrees with its plain version on the adversarial case")
    res = _vq_screen_check(z, e, "adversarial")
    del z, e
    torch.cuda.empty_cache()
    return res


def _vq_bound(z, e, out, general: bool = False) -> tuple[float, str]:
    """Reads z and the codebook, writes z_q, the codes, the counts and the
    per-code sums; one product (2 operations) per (row, code, dim) for the
    distances: on the f32 FMA units, as the one-pass kernel of
    ``csrc/vq_fwd.cu`` does them, or (``general``) at the 3xTF32 tensor
    cores' rate (three TF32 products each, PEAK_3XTF32), as its general
    path does."""
    rows, d = z.numel() // z.shape[-1], z.shape[-1]
    return _bound(2 * rows * e.shape[0] * d,
                  _nbytes(z, e, out.z_q, out.indices, out.counts, out.sum_z),
                  PEAK_3XTF32 if general else PEAK_F32)


def _library_layer(decoder: bool, x, enc, smask, ws, train: bool = False):
    """``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` (post-LN,
    exact GELU, eps 1e-12, x's dtype) on the weights of a layer case; returns its
    call in eval mode, or with ``train`` (dropout 0: it has no hash dropout)
    its forward under autograd and a call of the autograd backward of one
    such forward given an output gradient (dx, denc, every weight). Timed as
    the library yardstick only: the port never calls it."""
    import torch
    from torch import nn

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS

    W = dict(zip(DEC_WEIGHTS if decoder else ENC_WEIGHTS, ws))
    cls = nn.TransformerDecoderLayer if decoder else nn.TransformerEncoderLayer
    mod = cls(d_model=768, nhead=12, dim_feedforward=3072, dropout=0.0, activation="gelu",
              layer_norm_eps=1e-12, batch_first=True, norm_first=False, device="cuda",
              dtype=x.dtype).train(train)

    with torch.no_grad():
        mod.self_attn.in_proj_weight.copy_(W["wqkv"].t())
        mod.self_attn.in_proj_bias.copy_(W["bqkv"])
        mod.self_attn.out_proj.weight.copy_(W["wo"].t())
        mod.self_attn.out_proj.bias.copy_(W["bo"])
        mod.linear1.weight.copy_(W["w1"].t())
        mod.linear1.bias.copy_(W["b1"])
        mod.linear2.weight.copy_(W["w2"].t())
        mod.linear2.bias.copy_(W["b2"])
        last = mod.norm3 if decoder else mod.norm2
        for norm, gname, bname in ((mod.norm1, "g1", "be1"), (last, "g3", "be3")):
            norm.weight.copy_(W[gname])
            norm.bias.copy_(W[bname])
        if decoder:
            mod.multihead_attn.in_proj_weight.copy_(torch.cat([W["wq"], W["wkv"]], 1).t())
            mod.multihead_attn.in_proj_bias.copy_(torch.cat([W["bq"], W["bkv"]]))
            mod.multihead_attn.out_proj.weight.copy_(W["wco"].t())
            mod.multihead_attn.out_proj.bias.copy_(W["bco"])
            mod.norm2.weight.copy_(W["g2"])
            mod.norm2.bias.copy_(W["be2"])
    pad = smask == 0
    causal = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").triu(1)

    def call(x, enc):
        if not decoder:
            return mod(x, src_key_padding_mask=pad)
        return mod(x, enc, tgt_mask=causal, tgt_key_padding_mask=pad, tgt_is_causal=True)

    if not train:
        return lambda: call(x, enc)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, enc) if t is not None]
        out = call(*leaves, *([None] if enc is None else []))
    gy = torch.randn_like(out)
    params = list(mod.parameters())

    def fwd():
        with torch.enable_grad():
            return call(*leaves, *([None] if enc is None else []))

    def bwd():
        with torch.enable_grad():
            return torch.autograd.grad(out, leaves + params, gy, retain_graph=True)

    return fwd, bwd


def _ulps(a, b) -> int:
    """Largest distance in units of the last place between two f32 tensors."""
    import torch

    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)  # sign-magnitude to a monotone line
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def phase_adam(names: tuple[str, str], decoder: str = "bert") -> dict:
    """Kernel #14 against its plain version over the parameter list of the
    bert-base Shelgon3-VQ, or with ``decoder="gpt2"`` of the Bagon with the
    GPT-2-small decoder of phase 14, whole, as its step updates it (395
    leaves, 244 of them GPT-2's: the tied ``wte`` of 50,257 rows, the bare
    ``wpe``, the blocks' cross-attention)."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.ops.adam import amsgrad_update
    from kindergarten_vq_vae_torch.train.optim import Adam, FusedAdam

    base = _gpt2_cfg(model_name="bagon") if decoder == "gpt2" else _train_cfg()
    cfg = dataclasses.replace(base, weight_decay=0.01, lr_scheduler="MultiStepLR",
                              milestones=(2,), gamma=0.5)
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    # over bert-base, a frozen subset (the encoder's embeddings) stays out of
    # the table, as a model_mode mask leaves it, and must come out untouched
    # (no stray write past a leaf); over GPT-2 the table is the step's, every
    # leaf; the pooler gets no gradient, as in the step
    prefix = ("encoder.embeddings.",) if decoder == "bert" else ()
    leaves = [(n, p) for n, p in named if not n.startswith(prefix)]
    frozen = {n: p.clone() for n, p in named if n.startswith(prefix)}
    start = [p.clone() for _, p in leaves]
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    grads = [[None if n.startswith("encoder.pooler.")
              else 1e-3 * torch.randn(p.shape, device="cuda", generator=g) for n, p in leaves]
             for _ in range(ADAM_STEPS)]
    pk = [p for _, p in leaves]  # the model's own tensors, updated in place
    pp = [p.clone() for p in start]
    opt_k, opt_p = FusedAdam(cfg, "kernel"), FusedAdam(cfg, "plain")
    st_k, st_p = opt_k.init(pk), opt_p.init(pp)
    _reset_counters()
    for step in range(ADAM_STEPS):
        opt_k.update(pk, grads[step], st_k)
        opt_p.update(pp, grads[step], st_p)
    torch.cuda.synchronize()
    launches = amsgrad_update.launches
    worst, max_abs = 0, 0.0
    for what, a, b in (("p", pk, pp), ("mu", st_k.mu, st_p.mu), ("nu", st_k.nu, st_p.nu),
                       ("nu_max", st_k.nu_max, st_p.nu_max)):
        for (n, _), x, y in zip(leaves, a, b):
            if not torch.equal(x, y):
                worst = max(worst, _ulps(x, y))
                max_abs = max(max_abs, (x - y).abs().max().item())
                print(f"  amsgrad {what} {n}: {_ulps(x, y)} ulps apart")
    # every leaf moved, but a zero leaf without gradient (the pooler's bias:
    # g + wd * p is 0, so its moments and its step stay 0, as in optax)
    moved = all(not torch.equal(x, p) for x, p, gr in zip(pk, start, grads[0])
                if gr is not None or bool(p.any()))
    n_leaves, n_el = len(leaves), sum(p.numel() for _, p in leaves)
    print(f"amsgrad, {decoder} decoder ({n_leaves} leaves, {n_el} elements, "
          f"{sum(t.numel() for t in frozen.values())}"
          f" frozen left out, pooler without gradient) x {ADAM_STEPS} steps, wd 0.01, milestone 2: "
          f"launches {launches}, kernel vs plain max {worst} ulps (tol 0), every leaf moved {moved}")
    if launches != ADAM_STEPS or worst != 0 or not moved:
        _fail(f"the AMSGrad kernel disagrees with its plain version ({decoder} decoder)")
    if any(not torch.equal(p, frozen[n]) for n, p in named if n in frozen):
        _fail("a frozen leaf moved")

    k_ms, p_ms = _paired_ms(lambda: opt_k.update(pk, grads[0], st_k),
                            lambda: opt_p.update(pp, grads[0], st_p), 10)
    per_leaf_ms = _time_ms(lambda: Adam(cfg).update(pp, grads[0], st_p), 10)
    nbytes = sum(p.numel() * (36 if gr is not None else 32) for p, gr in zip(pk, grads[0]))
    bound = _bound(ADAM_OPS * n_el, nbytes, PEAK_F32)
    del st_p, pp
    torch.cuda.empty_cache()
    yard = [torch.nn.Parameter(p.clone()) for p in pk]
    for y, gr in zip(yard, grads[0]):
        y.grad = gr
    torch_adam = torch.optim.Adam(yard, lr=cfg.lr, weight_decay=cfg.weight_decay, amsgrad=True,
                                  fused=True)
    yard_ms = _time_ms(torch_adam.step, 10)
    print(f"amsgrad, {decoder} decoder: kernel {k_ms:.4f} ms, plain single-pass {p_ms:.4f} ms, "
          f"per-leaf update (fused_update='off') {per_leaf_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}, {nbytes} B); torch.optim.Adam(fused=True, amsgrad=True) on the same leaves "
          f"{yard_ms:.4f} ms (same-bytes yardstick only: another function) "
          f"({names[0]}; nvidia-smi: {names[1]})")
    del model, named, leaves, start, grads, pk, st_k, yard, torch_adam
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
            "per_leaf_ms": per_leaf_ms, "yardstick_ms": yard_ms, "leaves": n_leaves,
            "elements": n_el}


def _sentences(n: int, rng) -> list[str]:
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(1, SEQ - 2))) for _ in range(n)]


def _write_run(root: str, fused_layer: str = "auto", dtype: str = "bfloat16") -> str:
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.ckpt.bridge import params_to_jax
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, write_checkpoint
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer
    from kindergarten_vq_vae_torch.models import build_model, init_weights

    data_dir, run = os.path.join(root, "data"), os.path.join(root, "run")
    os.makedirs(data_dir)
    os.makedirs(run)
    cfg = RunConfig(model_name="shelgon3", vocab_size=30522, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072, compute_dtype=dtype, vq_n_e=9,
                    vq_e_dim=768, data_dir=data_dir, tokenized_sentence_max_length=SEQ,
                    fused_layer=fused_layer)
    with open(os.path.join(run, "run_conf.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    WordTokenizer(WORDS).save(os.path.join(data_dir, cfg.tokenizer_file))
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    write_checkpoint(os.path.join(run, best_ckpt_name("shelgon3", "loss_recon", "val")),
                     params_to_jax(model))
    return run


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=300) as resp:
        return json.loads(resp.read())


def _post(port: int, path: str, sentences: list[str]):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps({"sentences": sentences}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _check_results(results, sentences, rec):
    ids, mask = rec.tokenizer.encode_batch(sentences, SEQ)
    if [r["input"] for r in results] != sentences:
        _fail("/reconstruct returned other inputs than it was sent")
    for r, m in zip(results, mask):
        if not (0.0 <= r["token_acc"] <= 1.0 and isinstance(r["reconstruction"], str)
                and len(r["codes"]) == int(m.sum()) and all(0 <= c < 9 for c in r["codes"])):
            _fail(f"/reconstruct result malformed: {r}")


def _compare_paths(rec, ids, mask) -> dict:
    """Kernel path and plain path (both in the run's bf16) against an f32
    forward of the same weights through the plain path."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model

    f32 = build_model(dataclasses.replace(rec.cfg, compute_dtype="float32"), device="cuda").eval()
    f32.load_state_dict(rec.model.state_dict())
    valid = mask.bool()
    with torch.inference_mode():
        ref = f32(ids, mask, reference=True)
        outs = {"kernel": rec.model(ids, mask), "plain": rec.model(ids, mask, reference=True)}
    torch.cuda.synchronize()
    ref_logits = ref["logits"].float()
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 0.05) & valid
    stats = {"logits_finite": bool(torch.isfinite(outs["kernel"]["logits"]).all()),
             "logits_shape": list(outs["kernel"]["logits"].shape)}
    for path, out in outs.items():
        enc_err = (out["encoder_last_hidden_state"].float() - ref["encoder_last_hidden_state"]).abs()
        logit_err = (out["logits"].float() - ref_logits).abs()
        codes = out["min_encoding_indices"][..., 0] == ref["min_encoding_indices"][..., 0]
        ids_ok = out["logits"].float().argmax(-1) == ref_logits.argmax(-1)
        stats[path] = {
            "encoder_max_abs": enc_err.max().item(), "encoder_mean_abs": enc_err.mean().item(),
            "logits_max_abs": logit_err.max().item(), "logits_mean_abs": logit_err.mean().item(),
            "code_agreement": codes[valid].float().mean().item(),
            "recon_id_agreement": ids_ok[clear].float().mean().item(),
        }
    k, p = outs["kernel"], outs["plain"]
    stats["kernel_vs_plain_code_agreement"] = (
        (k["min_encoding_indices"] == p["min_encoding_indices"])[..., 0][valid].float().mean().item())
    del f32
    torch.cuda.empty_cache()
    return stats


def phase_slice(names: tuple[str, str]) -> dict:
    import random

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.serve.http_server import serve_http
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    rng = random.Random(SEED)
    with tempfile.TemporaryDirectory(prefix="kvq_chip_smoke_") as root:
        t0 = time.perf_counter()
        run = _write_run(root)
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        print(f"slice: bert-base shelgon3-VQ run written and loaded in "
              f"{time.perf_counter() - t0:.1f} s, buckets {rec.buckets}")

    server = serve_http(rec, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        few, many = _sentences(3, rng), _sentences(20, rng)
        _reset_counters()
        health = _get(port, "/health")
        recon_few = _post(port, "/reconstruct", few)["results"]
        recon_many = _post(port, "/reconstruct", many)["results"]
        codes = _post(port, "/codes", few)["codes"]
        latents = np.asarray(_post(port, "/encode", few)["latents"])
        counts = _counters()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        _fail("HTTP server thread did not stop")

    if health != {"status": "ok", "model": "shelgon3"}:
        _fail(f"/health answered {health}")
    _check_results(recon_few, few, rec)
    _check_results(recon_many, many, rec)
    if [len(c) for c in codes] != [len(r["codes"]) for r in recon_few]:
        _fail("/codes disagrees with /reconstruct on code counts")
    if latents.shape != (3, 768) or not np.isfinite(latents).all():
        _fail(f"/encode returned latents of shape {latents.shape}")
    # three full forwards (two /reconstruct, one /codes): 24 layers + 1 VQ
    # each; /encode runs the 12 encoder layers once; no training kernel
    want = {k: 0 for k in counts}
    want.update(layer_fwd=3 * 24 + 12, vq=3, **_inside_layers(3, encoder_forwards=1))
    print(f"slice: HTTP /health /reconstruct(3) /reconstruct(20) /codes(3) /encode(3) ok; "
          f"launches {counts} (expected {want})")
    if counts != want:
        _fail("the serving path did not go through the kernels as expected")
    launches = {"layer": counts["layer_fwd"], "vq": counts["vq"]}

    # one bucket-256 forward: kernel path and plain path, both bf16, each held
    # against an f32 forward of the same weights (plain path, TF32 off)
    sents = _sentences(BUCKET, rng)
    ids_np, mask_np = rec.tokenizer.encode_batch(sents, SEQ)
    ids = torch.from_numpy(ids_np).cuda()
    mask = torch.from_numpy(mask_np).cuda()
    stats = _compare_paths(rec, ids, mask)
    print(f"slice bucket-{BUCKET} forward vs an f32 forward: {json.dumps(stats)}")
    if not stats["logits_finite"] or stats["logits_shape"] != [BUCKET, SEQ, 30522]:
        _fail("bucket-256 forward: logits not finite or misshapen")
    for what in ("encoder_mean_abs", "logits_mean_abs"):
        if stats["kernel"][what] > PATH_SLACK * stats["plain"][what]:
            _fail(f"kernel path is further from the f32 forward than the plain path ({what})")
    if stats["kernel"]["code_agreement"] < stats["plain"]["code_agreement"] - CODE_SLACK:
        _fail("kernel path picks other codes than the f32 forward more often than the plain path")
    if min(stats["kernel"]["recon_id_agreement"], stats["plain"]["recon_id_agreement"]) < 0.999:
        _fail("reconstruction ids disagree with the f32 forward where its top-2 gap is clear")

    # median bucket-256 forward, both paths in turns
    times = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for _ in range(2):
            rec.forward(ids, mask)
            rec.forward(ids, mask, reference=True)
        for i in range(10):
            order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
            for path in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec.forward(ids, mask, reference=path == "plain")
                torch.cuda.synchronize()
                times[path].append((time.perf_counter() - t0) * 1e3)
    med = {path: statistics.median(v) for path, v in times.items()}
    for path in ("kernel", "plain"):
        print(f"bucket-{BUCKET} x seq {SEQ} forward, {path} path: median {med[path]:.3f} ms "
              f"over {len(times[path])} ({names[0]}; nvidia-smi: {names[1]})")
    return {"launches": launches, "forward_ms": med}


def _median_forwards(recs: dict, ids, mask, rounds: int = 10) -> dict:
    """Median bucket forward of each reconstructor's kernel path, in turns."""
    import torch

    times = {k: [] for k in recs}
    with torch.inference_mode():
        for rec in recs.values():
            for _ in range(2):
                rec.forward(ids, mask)
        for i in range(rounds):
            for k in (list(recs) if i % 2 == 0 else list(recs)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs[k].forward(ids, mask)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_serve_per_module(names: tuple[str, str]) -> dict:
    """A ``fused_layer="off"`` run of the serving slice's seeded weights served through
    ``Reconstructor``: 36 SDPA forwards (24 self, 12 cross) and one VQ per
    forward, no layer launch; one bucket-256 forward held to the f32 forward
    (``PATH_SLACK``, ``CODE_SLACK``) and timed beside the fused route's. Then
    ``output_attentions`` on the fused route's model: one bucket-8 forward
    gives 12 layers of (8, 12, S, S) self- and cross-attention probabilities
    (rows summing to 1, the causal upper triangle 0) through the einsum route,
    the encoder's 12 layer launches and no SDPA launch."""
    import random

    import torch

    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    rng = random.Random(SEED + 1)
    with tempfile.TemporaryDirectory(prefix="kvq_chip_smoke_") as root:
        rec = Reconstructor(_write_run(os.path.join(root, "off"), "off"), device="cuda")
        rec_fused = Reconstructor(_write_run(os.path.join(root, "auto")), device="cuda")
    if rec.model.encoder.cfg.fused_layer or rec.model.decoder.bert.cfg.fused_layer:
        _fail("a fused_layer='off' run was built with the fused trunk")
    few = _sentences(3, rng)
    _reset_counters()
    results = rec.reconstruct(few)
    codes = rec.codes(few)
    counts = _counters()
    want = {k: 0 for k in counts}
    want.update(sdpa_fwd_self=48, sdpa_fwd_cross=24, vq=2)  # two forwards
    print(f"serving a fused_layer='off' run: reconstruct(3) + codes(3), launches {counts} "
          f"(expected {want})")
    _check_results(results, few, rec)
    if counts != want or [r["codes"] for r in results] != codes:
        _fail("the per-module serving path did not go through the SDPA kernels as expected")

    ids_np, mask_np = rec.tokenizer.encode_batch(_sentences(BUCKET, rng), SEQ)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    stats = _compare_paths(rec, ids, mask)
    print(f"per-module bucket-{BUCKET} forward vs an f32 per-module forward: {json.dumps(stats)}")
    if not stats["logits_finite"] or stats["logits_shape"] != [BUCKET, SEQ, VOCAB]:
        _fail("per-module bucket-256 forward: logits not finite or misshapen")
    for what in ("encoder_mean_abs", "logits_mean_abs"):
        if stats["kernel"][what] > PATH_SLACK * stats["plain"][what]:
            _fail(f"per-module kernel path is further from the f32 forward than its plain path "
                  f"({what})")
    if stats["kernel"]["code_agreement"] < stats["plain"]["code_agreement"] - CODE_SLACK:
        _fail("per-module kernel path picks other codes than the f32 forward more often than the "
              "plain path")
    if min(stats["kernel"]["recon_id_agreement"], stats["plain"]["recon_id_agreement"]) < 0.999:
        _fail("per-module reconstruction ids disagree with the f32 forward where its top-2 gap "
              "is clear")
    med = _median_forwards({"fused": rec_fused, "per-module": rec}, ids, mask)
    print(f"bucket-{BUCKET} x seq {SEQ} forward, kernel paths in turns: fused layers "
          f"{med['fused']:.3f} ms, per-module trunk {med['per-module']:.3f} ms ({names[0]}; "
          f"nvidia-smi: {names[1]})")

    ids8, mask8 = ids[:8].contiguous(), mask[:8].contiguous()
    _reset_counters()
    with torch.inference_mode():
        out = rec_fused.model(ids8, mask8, output_attentions=True)
    torch.cuda.synchronize()
    counts = _counters()
    want = {k: 0 for k in counts}
    want.update(layer_fwd=12, vq=1, **_inside_layers(0, encoder_forwards=1))
    tril = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").tril()
    ok = counts == want
    for key in ("decoder_attentions", "decoder_cross_attentions"):
        probs = out[key]
        ok &= len(probs) == 12 and all(p.shape == (8, 12, SEQ, SEQ) for p in probs)
        ok &= all((p.float().sum(-1) - 1.0).abs().max().item() <= 1e-2 for p in probs)
        if key == "decoder_attentions":
            ok &= all(bool((p[..., ~tril] == 0).all()) for p in probs)
    print(f"output_attentions at bucket 8: {len(out['decoder_attentions'])} self and "
          f"{len(out['decoder_cross_attentions'])} cross layers of "
          f"{tuple(out['decoder_attentions'][0].shape)}, launches {counts} (expected {want}); "
          f"ok {ok}")
    if not ok:
        _fail("output_attentions did not return the decoder's probabilities as expected")
    del rec, rec_fused, out
    torch.cuda.empty_cache()
    return {"forward_ms": med}


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _leaf_errors(got, want) -> float:
    """Largest :func:`_rel_max` over paired outputs (pairs of None skipped);
    inf if an output is not finite."""
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    if not all(_finite(a) for a, _ in pairs):
        return float("inf")
    return max(_rel_max(a, b) for a, b in pairs)


def _visible_layer(decoder: bool, batch: int, dtype=None):
    """A bert-base layer (dropout 0.1 / 0.1) whose outputs show its keep masks.
    q = k = 0 gives every key the same probability and v is the one-hot of the
    key position (x, and enc for cross-attention), so a context entry is
    p * keep per (query, key, head). Every other weight is 0 and the biases
    before the hidden sites (bo, bco, b2) are VISIBLE_BIAS, so each residual
    sum is VISIBLE_BIAS * keep plus an O(1) term, and its LayerNorm output is
    positive exactly where the site keeps."""
    import torch

    from kindergarten_vq_vae_torch.ops.layer import DEC_WEIGHTS, ENC_WEIGHTS, LayerGeom

    H, hd = 768, 64
    geom = LayerGeom(num_heads=12, head_dim=hd, intermediate=3072, causal=decoder,
                     has_cross=decoder, eps=1e-12, gelu_exact=True, attn_rate=0.1, hid_rate=0.1)
    onehot = torch.zeros(batch, SEQ, H, device="cuda")
    for h in range(12):
        onehot[:, torch.arange(SEQ), h * hd + torch.arange(SEQ)] = 1.0
    dtype = dtype or torch.bfloat16
    onehot = onehot.to(dtype)
    shapes, ws = geom.weight_shapes(), []
    for n in DEC_WEIGHTS if decoder else ENC_WEIGHTS:
        w = torch.zeros(shapes[n], device="cuda")
        if n in ("wqkv", "wkv"):  # v = the layer's input
            w[:, -H:] = torch.eye(H, device="cuda")
        if n.startswith("g"):
            w += 1.0
        if n in ("bo", "bco", "b2"):
            w += VISIBLE_BIAS
        ws.append(w.to(dtype) if n.startswith("w") else w)
    return geom, onehot, (onehot if decoder else None), ws


def _check_keep_masks(seed: int, dtype=None) -> None:
    """Every keep mask of the training kernels (bf16, or ``dtype``'s
    instances), held to the plain mask.

    Forward, batch 2048: the self-attention heads (op ids 0..11, causal in the
    decoder) through ctx, the cross-attention heads (``cross_op(12) + h``)
    through ctx2, and the hidden sites 1000 / 1001 / 1002 through x1, x2 and
    out, each equal to the plain mask. Backward, batch 256 (3072 rows): with
    ctx and ctx2 = [I; 0] and m = I as residuals, the weight gradients of wo,
    wco and w2 are the masked row gradients of the three hidden sites (rows
    0..767, 0..767, 0..3071); each is exactly 0 where the plain mask drops,
    and nonzero where it keeps unless the plain gradient there is below 1e-4
    of its largest."""
    import torch

    from kindergarten_vq_vae_torch.ops.dropout import (
        OP_ATTN_OUT,
        OP_CROSS_OUT,
        OP_MLP_OUT,
        attention_keep,
        cross_op,
        hidden_keep,
    )
    from kindergarten_vq_vae_torch.ops.layer import (
        DEC_WEIGHTS,
        layer_backward,
        layer_backward_reference,
        layer_forward,
        residual_names,
    )

    rows, kept = TRAIN_BATCH * SEQ, []
    tril = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").tril()
    for decoder in (False, True):
        geom, x, enc, ws = _visible_layer(decoder, TRAIN_BATCH, dtype)
        with torch.no_grad():
            out, resid = layer_forward(geom, x, enc, None, None, ws, seed)
        R = dict(zip(residual_names(geom), resid), out=out)
        heads = (("ctx", 0),) + ((("ctx2", cross_op(12)),) if decoder else ())
        for name, op0 in heads:
            ctx = R[name].view(TRAIN_BATCH, SEQ, 12, 64)[..., :SEQ]
            for h in range(12):
                keep = attention_keep(seed, op0 + h, TRAIN_BATCH, SEQ, SEQ, 0.1, "cuda") > 0
                if decoder and name == "ctx":
                    keep &= tril
                if not torch.equal(ctx[:, :, h] > 0, keep):
                    _fail(f"keep mask of {name} head {h} (op {op0 + h}) differs from the plain "
                          f"mask ({'decoder' if decoder else 'encoder'})")
                kept.append(keep[:, tril].float().mean().item() if decoder and name == "ctx"
                            else keep.float().mean().item())
        sites = (("x1", OP_ATTN_OUT),) + ((("x2", OP_CROSS_OUT),) if decoder else ()) + (
            ("out", OP_MLP_OUT),)
        for name, op in sites:
            keep = hidden_keep(seed, op, rows, 768, 0.1, "cuda") > 0
            if not torch.equal(R[name].reshape(rows, 768) > 0, keep):
                _fail(f"hidden keep mask {op} differs from the plain mask through {name} "
                      f"({'decoder' if decoder else 'encoder'})")
            kept.append(keep.float().mean().item())
        del out, resid, R

    geom, x, enc, ws = _visible_layer(True, BUCKET, dtype)
    M = BUCKET * SEQ
    with torch.no_grad():
        out, resid = layer_forward(geom, x, enc, None, None, ws, seed)
    names, resid = residual_names(geom), list(resid)
    for n, width in (("ctx", 768), ("ctx2", 768), ("m", 3072)):
        resid[names.index(n)] = torch.eye(M, width, dtype=x.dtype, device="cuda")
    gy = (0.1 * torch.randn(x.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED))).to(x.dtype)
    args = (geom, x, enc, None, None, ws, seed, tuple(resid), out, gy)
    got = dict(zip(DEC_WEIGHTS, layer_backward(*args)[2]))
    want = dict(zip(DEC_WEIGHTS, layer_backward_reference(*args)[2]))
    for wname, op in (("wo", OP_ATTN_OUT), ("wco", OP_CROSS_OUT), ("w2", OP_MLP_OUT)):
        g, w = got[wname].float(), want[wname].float()
        keep = hidden_keep(seed, op, g.shape[0], 768, 0.1, "cuda") > 0
        lost = (g == 0) & keep & (w.abs() > 1e-4 * w.abs().max())
        if bool((g[~keep] != 0).any()) or bool(lost.any()) or bool((w[~keep] != 0).any()):
            _fail(f"hidden keep mask {op} of the backward differs from the plain mask "
                  f"(d{wname}: {int((g[~keep] != 0).sum())} dropped entries nonzero, "
                  f"{int(lost.sum())} kept entries zero)")
    print(f"keep masks ({x.dtype}) equal to the plain masks: forward at batch {TRAIN_BATCH} "
          f"(self heads "
          f"0..11, cross heads {cross_op(12)}..{cross_op(12) + 11}, hidden sites 1000/1001/1002 "
          f"through x1/x2/out), backward at batch {BUCKET} (sites 1000/1001/1002 through "
          f"dwo/dwco/dw2); kept shares {min(kept):.4f}..{max(kept):.4f} (rate 0.1)")
    del out, resid, got, want


def _ce_case(g, rows: int, vocab: int, dtype=None):
    """(rows, vocab) bf16 (or ``dtype``) logits of std 3 with ties far apart,
    side by side and an all-equal row (rows 0-2), and uniform int32 targets."""
    import torch

    logits = (3.0 * torch.randn(rows, vocab, device="cuda", generator=g)).to(
        dtype or torch.bfloat16)
    logits[0, [5, 9000, vocab - 522]] = 40.0
    logits[1, [7, 8]] = 40.0
    logits[2] = 0.5
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=g, dtype=torch.int32)
    return logits, t


def _ce_bwd_at_phases(logits, t, grad_tol: float) -> float:
    """#8 on 256 rows of ``logits`` copied into views at every element offset
    of a 16-byte chunk (8 bf16 or 4 f32), so each row phase starts the first
    row, with targets at -1 and V and a row of scale 0: the output at the
    logits' 16-byte phase and within ``grad_tol`` of its largest magnitude
    of the plain version's at each. Fails the run otherwise; returns the
    largest relative difference."""
    import torch

    from kindergarten_vq_vae_torch.ops.ce import (
        ce_bwd,
        ce_bwd_reference,
        ce_fwd_ids_reference,
        target_logits,
    )

    rows, vocab = 256, logits.shape[1]
    tt = t[:rows].clone()
    tt[3], tt[4] = -1, vocab
    scale = torch.full((rows,), 1.0 / rows, device="cuda")
    scale[5] = 0.0
    worst = 0.0
    for offset in range(16 // logits.element_size()):
        buf = torch.empty(offset + rows * vocab, dtype=logits.dtype, device="cuda")
        x = buf[offset:].view(rows, vocab)
        x.copy_(logits[:rows])
        lse = ce_fwd_ids_reference(x, tt)[0] + target_logits(x, tt)
        got = ce_bwd(x, tt, lse, scale)
        torch.cuda.synchronize()
        rel = _rel_max(got, ce_bwd_reference(x, tt, lse, scale))
        worst = max(worst, rel)
        if (rel > grad_tol or got.data_ptr() % 16 != x.data_ptr() % 16
                or bool((got[5] != 0).any())):
            _fail(f"CE backward kernel disagrees with its plain version on a logits view at "
                  f"element offset {offset}, vocabulary {vocab} {logits.dtype}: max rel {rel:.3e} "
                  f"(tol {grad_tol}), output phase {got.data_ptr() % 16} against the logits' "
                  f"{x.data_ptr() % 16}")
        del buf, x, lse, got
    print(f"ce bwd ({rows},{vocab}) {logits.dtype} at element offsets 0-"
          f"{16 // logits.element_size() - 1}: max rel {worst:.3e} (tol {grad_tol}), output at "
          f"the logits' 16-byte phase, the zero-scale row 0")
    return worst


def _ce_ids_and_grad(logits, t) -> tuple[dict, dict, object]:
    """#7 and #8 on ``logits`` against their plain versions (ids exact, NLL
    within CE_NLL_ABS, the gradient within CE_GRAD_REL of its largest; f32
    logits: NLL within F32_NLL_REL relative, the gradient within F32_GRAD;
    #8 also at every row phase, :func:`_ce_bwd_at_phases`), each timed in
    turns with its plain version, with its bound and library yardstick:
    (#7's row, #8's row, #7's NLL)."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.ce import (
        ce_bwd,
        ce_bwd_reference,
        ce_fwd_ids,
        ce_fwd_ids_reference,
    )

    rows, vocab = logits.shape
    f32 = logits.dtype == torch.float32
    nll_tol, grad_tol = (F32_NLL_REL, F32_GRAD) if f32 else (CE_NLL_ABS, CE_GRAD_REL)
    dt = "f32" if f32 else "bf16"
    with torch.no_grad():
        nll, ids = ce_fwd_ids(logits, t)
        torch.cuda.synchronize()
        nll_p, ids_p = ce_fwd_ids_reference(logits, t)
        nll_err = (nll - nll_p).abs().max().item()
        nll_off = ((nll - nll_p).abs() / nll_p.abs()).max().item() if f32 else nll_err
        ids_ok = torch.equal(ids, ids_p) and ids[:3].tolist() == [5, 7, 0]
        print(f"ce fwd ({rows},{vocab}) {dt}: ids exact {ids_ok}, nll max abs {nll_err:.3e}, "
              f"{'max rel ' + format(nll_off, '.3e') + ' ' if f32 else ''}(tol {nll_tol})")
        if not ids_ok or nll_off > nll_tol:
            _fail(f"CE forward kernel disagrees with its plain version at vocabulary {vocab}")
        k_ms, p_ms = _paired_ms(lambda: ce_fwd_ids(logits, t),
                                lambda: ce_fwd_ids_reference(logits, t), 10)
        # max, subtract, exp, add per logit
        bound = _bound(4 * rows * vocab, _nbytes(logits, t, nll, ids), PEAK_F32)
        two_ms = _time_ms(lambda: (F.cross_entropy(logits, t.long(), reduction="none"),
                                   torch.argmax(logits, 1)), 10)
        fwd = {"max_abs_err": nll_err, "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound],
               "two_call_ms": two_ms}
        print(f"ce fwd ids ({rows},{vocab}): kernel {k_ms:.4f} ms ({bound[0] / k_ms:.0%} of the "
              f"{bound[1]} bound {bound[0]:.4f} ms), plain {p_ms:.4f} ms; two-call yardstick "
              f"F.cross_entropy(reduction='none') + torch.argmax(x, 1) {two_ms:.4f} ms")
        lse = nll_p + logits.float().gather(1, t.long()[:, None])[:, 0]
        scale = torch.full((rows,), 1.0 / rows, device="cuda")
        got = ce_bwd(logits, t, lse, scale)
        torch.cuda.synchronize()
        want = ce_bwd_reference(logits, t, lse, scale)
        rel = _rel_max(got, want)
        print(f"ce bwd ({rows},{vocab}) {dt}: max rel {rel:.3e} (tol {grad_tol})")
        if rel > grad_tol or got.data_ptr() % 16 != logits.data_ptr() % 16:
            _fail(f"CE backward kernel disagrees with its plain version at vocabulary {vocab}")
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        _ce_bwd_at_phases(logits, t, grad_tol)
        k_ms, p_ms = _paired_ms(lambda: ce_bwd(logits, t, lse, scale),
                                lambda: ce_bwd_reference(logits, t, lse, scale), 10)
        # subtract, exp, one-hot subtract, scale, round per logit; bytes: the
        # logits read and the gradient written once, plus the per-row vectors
        bound = _bound(5 * rows * vocab, 2 * _nbytes(logits) + _nbytes(t, lse, scale), PEAK_F32)
    # the same function in one PyTorch call: the autograd backward of
    # F.cross_entropy(reduction="none") fed scale as its output gradient
    with torch.enable_grad():
        lib_in = logits.detach().requires_grad_()
        lib_nll = F.cross_entropy(lib_in, t.long(), reduction="none")
        lib_ms = _time_ms(lambda: torch.autograd.grad(lib_nll, lib_in, scale.to(lib_nll.dtype),
                                                      retain_graph=True), 10)
    del lib_in, lib_nll
    bwd = {"max_abs_err": err, "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound],
           "library_ms": lib_ms, "library": "autograd backward of F.cross_entropy(reduction='none')"}
    print(f"ce bwd ({rows},{vocab}): kernel {k_ms:.4f} ms ({bound[0] / k_ms:.0%} of the "
          f"{bound[1]} bound {bound[0]:.4f} ms), plain {p_ms:.4f} ms, autograd backward of "
          f"F.cross_entropy(reduction='none') {lib_ms:.4f} ms")
    return fwd, bwd, nll


def phase_train_kernels() -> dict:
    """Each training kernel against its plain version at the shapes of the
    batch-2048 bert-base step, and its time beside the plain one's."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.ce import ce_fwd, ce_fwd_reference, fused_ce_loss
    from kindergarten_vq_vae_torch.ops.dropout import cross_op
    from kindergarten_vq_vae_torch.ops.vq import vector_quantize
    from kindergarten_vq_vae_torch.ops.vq_kernel import vector_quantize_kernel
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_backward_reference,
        layer_backward,
        layer_backward_reference,
        layer_forward,
        layer_forward_reference,
        residual_names,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    res = {k: {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [], "library_ms": []}
           for k in ("layer_fwd", "layer_bwd", "attn_bwd_self", "attn_bwd_cross")}
    layer_lib = "nn.Transformer{Encoder,Decoder}Layer, train mode, dropout 0 (no hash dropout)"
    res["layer_fwd"]["library"] = layer_lib + ": forward under autograd"
    res["layer_bwd"]["library"] = layer_lib + ": its autograd backward"
    sdpa_lib = ("autograd backward of F.scaled_dot_product_attention (rate 0, head transposes; "
                "no hash dropout)")
    res["attn_bwd_self"]["library"] = res["attn_bwd_cross"]["library"] = sdpa_lib

    def note(key, err, k_ms, p_ms, bound):
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], err)
        res[key]["ms"].append(k_ms)
        res[key]["plain_ms"].append(p_ms)
        res[key]["bound"].append(bound)
        print(f"{key} {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")

    rows = TRAIN_BATCH * SEQ
    for decoder in (False, True):
        what = "decoder" if decoder else "encoder"
        geom, x, enc, smask, ws = _layer_case(decoder, g, TRAIN_BATCH, rate=0.1)
        seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
        with torch.no_grad():
            out, resid = layer_forward(geom, x, enc, smask, None, ws, seed)
            torch.cuda.synchronize()
            out_p, res_p = layer_forward_reference(geom, x, enc, smask, None, ws, seed)
            err = (out.float() - out_p.float()).abs()
            rel = _leaf_errors(resid, res_p)
            print(f"train layer fwd {what} ({TRAIN_BATCH},{SEQ},768) bf16 dropout 0.1/0.1: out "
                  f"max abs {err.max().item():.4e} mean abs {err.mean().item():.4e}, residuals "
                  f"{residual_names(geom)} max rel {rel:.3e} (tol {TRAIN_REL})")
            if not (_finite(out) and err.max() <= LAYER_MAX_ABS
                    and err.mean() <= LAYER_MEAN_ABS and rel <= TRAIN_REL):
                _fail(f"training layer forward disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(
                lambda: layer_forward(geom, x, enc, smask, None, ws, seed),
                lambda: layer_forward_reference(geom, x, enc, smask, None, ws, seed), 10)
            fwd_flops = _layer_flops(TRAIN_BATCH, SEQ, decoder)
            note("layer_fwd", err.max().item(), k_ms, p_ms,
                 _bound(fwd_flops, _nbytes(x, enc, smask, ws, out, resid), PEAK_BF16))

            gy = (0.1 * torch.randn(x.shape, device="cuda", generator=g)).bfloat16()
            enc_dtype = torch.float32 if decoder else None  # z_q feeds the decoder in f32
            args = (geom, x, enc, smask, None, ws, seed, res_p, out_p, gy, enc_dtype)
            got = layer_backward(*args)
            torch.cuda.synchronize()
            want = layer_backward_reference(*args)
            flat_got, flat_want = (got[0], got[1], *got[2]), (want[0], want[1], *want[2])
            rel = _leaf_errors(flat_got, flat_want)
            abs_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(flat_got, flat_want) if b is not None)
            print(f"train layer bwd {what}: dx, denc and {len(got[2])} weight gradients, max rel "
                  f"{rel:.3e} (tol {TRAIN_REL})")
            if rel > TRAIN_REL or (decoder and got[1].dtype != torch.float32):
                _fail(f"layer backward disagrees with its plain version ({what})")
            k_ms, p_ms = _paired_ms(lambda: layer_backward(*args),
                                    lambda: layer_backward_reference(*args), 10)
            # each product of the forward twice (the input's and the weight's gradient)
            note("layer_bwd", abs_err, k_ms, p_ms,
                 _bound(2 * fwd_flops, _nbytes(args[:-1], flat_got), PEAK_BF16))
            lib_fwd, lib_bwd = _library_layer(decoder, x, enc, smask, ws, train=True)
            res["layer_fwd"]["library_ms"].append(_time_ms(lib_fwd, 10))
            res["layer_bwd"]["library_ms"].append(_time_ms(lib_bwd, 10))
            print(f"{layer_lib} {what}: forward {res['layer_fwd']['library_ms'][-1]:.4f} ms, "
                  f"backward {res['layer_bwd']['library_ms'][-1]:.4f} ms")
            del lib_fwd, lib_bwd

            # the attention backward at the shapes the layer backward gives it
            names = residual_names(geom)
            if decoder:
                a_args = (resid[names.index("qc")].view(TRAIN_BATCH, SEQ, 768),
                          resid[names.index("kvc")].view(TRAIN_BATCH, SEQ, 1536), None,
                          gy, 12, False, seed, cross_op(12), 0.1)
            else:
                a_args = (resid[names.index("qkv")].view(TRAIN_BATCH, SEQ, 2304), None, smask,
                          gy, 12, False, seed, 0, 0.1)
            key = "attn_bwd_cross" if decoder else "attn_bwd_self"
            got = attention_backward(*a_args)
            torch.cuda.synchronize()
            want = attention_backward_reference(*a_args)
            got, want = (got, want) if decoder else ((got,), (want,))
            rel = _leaf_errors(got, want)
            print(f"{key}: max rel {rel:.3e} (tol {TRAIN_REL})")
            if rel > TRAIN_REL:
                _fail(f"attention backward disagrees with its plain version ({key})")
            k_ms, p_ms = _paired_ms(lambda: attention_backward(*a_args),
                                    lambda: attention_backward_reference(*a_args), 10)
            # five products per head: scores again, dV, dP, dQ, dK
            note(key, max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
                 k_ms, p_ms, _bound(10 * TRAIN_BATCH * 12 * SEQ * SEQ * 64,
                                    _nbytes(a_args, got), PEAK_BF16))
            if decoder:
                q, (k, v), amask = a_args[0], a_args[1].split(768, -1), None
            else:
                (q, k, v), amask = a_args[0].split(768, -1), smask
            _, lib_bwd = _library_sdpa(q, k, v, amask, False)
            res[key]["library_ms"].append(_time_ms(lib_bwd, 10))
            print(f"{key}: {sdpa_lib} {res[key]['library_ms'][-1]:.4f} ms")
            del lib_bwd
        del out, resid, out_p, res_p, got, want

    _check_keep_masks(seed)

    # the VQ at the step's rows: the encoder output of 2048 x 12 tokens
    z = torch.randn(TRAIN_BATCH, SEQ, 768, device="cuda", generator=g)
    e = (torch.rand(9, 768, device="cuda", generator=g) * 2 - 1) / 9
    with torch.no_grad():
        k = vector_quantize_kernel(z, e, 0.69)
        torch.cuda.synchronize()
        p = vector_quantize(z, e, 0.69)
        exact = all(torch.equal(getattr(k, f), getattr(p, f)) for f in ("indices", "z_q", "counts"))
        rel = max(_rel_max(getattr(k, f), getattr(p, f)) for f in ("loss", "perplexity", "sum_z"))
        print(f"vq ({rows},768)x9 f32: idx/z_q/counts exact {exact}, max rel {rel:.2e} "
              f"(tol {VQ_REL})")
        if not exact or rel > VQ_REL:
            _fail("VQ kernel disagrees with its plain version at the training rows")
        times = _vq_times(z, e, "training")
        res["vq"] = {"max_abs_err": max((getattr(k, f) - getattr(p, f)).abs().max().item()
                                        for f in ("z_q", "sum_z", "loss", "perplexity")),
                     **{key: [v] if key != "bound" else v for key, v in times.items()}}
    del z, k, p

    # streaming CE at the step's logits shape, with ties inside and across blocks
    logits, t = _ce_case(g, rows, VOCAB)
    res["ce_fwd_ids"], res["ce_bwd"], nll = _ce_ids_and_grad(logits, t)
    with torch.no_grad():
        # #6: the NLL alone; one PyTorch call computes the same function
        nll6 = ce_fwd(logits, t)
        torch.cuda.synchronize()
        err6 = (nll6 - ce_fwd_reference(logits, t)).abs().max().item()
        same = torch.equal(nll6, nll)
        lib_ce = F.cross_entropy(logits, t.long(), reduction="none")
        print(f"ce fwd (#6) ({rows},{VOCAB}) bf16: nll max abs {err6:.3e} (tol {CE_NLL_ABS}), "
              f"equal to #7's {same}; F.cross_entropy max abs "
              f"{(lib_ce.float() - nll).abs().max().item():.3e} (bf16 out)")
        if err6 > CE_NLL_ABS or not same:
            _fail("CE forward kernel #6 disagrees with its plain version")
        k_ms, p_ms = _paired_ms(lambda: ce_fwd(logits, t), lambda: ce_fwd_reference(logits, t), 10)
        lib_ms = _time_ms(lambda: F.cross_entropy(logits, t.long(), reduction="none"), 10)
        bound = _bound(4 * rows * VOCAB, _nbytes(logits, t, nll6), PEAK_F32)
        res["ce_fwd"] = {"max_abs_err": err6, "ms": [k_ms], "plain_ms": [p_ms], "bound": [bound],
                         "library_ms": lib_ms,
                         "library": "F.cross_entropy(reduction='none')"}
        print(f"ce fwd (#6): kernel {k_ms:.4f} ms ({bound[0] / k_ms:.0%} of the {bound[1]} bound "
              f"{bound[0]:.4f} ms), plain {p_ms:.4f} ms, F.cross_entropy(reduction='none') "
              f"{lib_ms:.4f} ms")

    # fused_ce_loss through its autograd: #6 forward, #8 backward (no model path
    # calls it, in the JAX package or here: this run is its path)
    x3 = logits.view(TRAIN_BATCH, SEQ, VOCAB).detach().requires_grad_()
    valid = torch.ones(TRAIN_BATCH, device="cuda")
    _reset_counters()
    loss = fused_ce_loss(x3, t.view(TRAIN_BATCH, SEQ), valid)
    loss.backward()
    torch.cuda.synchronize()
    ce_loss_counts = _counters()
    want_counts = {k: 0 for k in ce_loss_counts}
    want_counts.update(ce_fwd=1, ce_bwd=1)
    print(f"fused_ce_loss at ({TRAIN_BATCH},{SEQ},{VOCAB}): loss {loss.item():.4f}, launches "
          f"{ce_loss_counts}")
    if ce_loss_counts != want_counts or not _finite(x3.grad):
        _fail(f"fused_ce_loss did not run #6 and #8 once each: {ce_loss_counts}")
    del logits, x3, loss
    torch.cuda.empty_cache()
    out = {k: {"max_abs_err": v["max_abs_err"], "ms": statistics.mean(v["ms"]),
               "plain_ms": statistics.mean(v["plain_ms"]), "bound": v["bound"],
               "library_ms": (statistics.mean(v["library_ms"]) if isinstance(v.get("library_ms"),
                                                                            list)
                              else v.get("library_ms")),
               "library": v.get("library")}
           for k, v in res.items()}
    out["ce_loss_launches"] = ce_loss_counts
    return out


def phase_attention_fwd(names: tuple[str, str]) -> dict:
    """The attention forward inside #1 alone (``kvq_attention_fwd``, the call
    the layer forward makes) against its plain version: at the batch-2048
    training shapes (self-attention causal and with a padded mask, both from
    a packed qkv; cross-attention from q and a packed kv, op ids from
    num_heads + 1; dropout 0.1) and at the bucket-256 serving shape (rate 0);
    every keep bit held to the plain mask; its time beside the plain
    version's, its byte bound and ``F.scaled_dot_product_attention``."""
    import torch

    from kindergarten_vq_vae_torch.ops.dropout import attention_keep, cross_op
    from kindergarten_vq_vae_torch.ops.layer import attention_forward, attention_forward_reference

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
    lib_name = "F.scaled_dot_product_attention (rate 0, head transposes)"
    res = {k: {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [], "library_ms": [],
               "library": lib_name} for k in ("self", "cross", "serving")}
    H = 768
    for key, cross, causal, masked, rate, batch in (
            ("self", False, True, False, 0.1, TRAIN_BATCH),
            ("self", False, False, True, 0.1, TRAIN_BATCH),
            ("cross", True, False, False, 0.1, TRAIN_BATCH),
            ("serving", False, False, True, 0.0, BUCKET)):
        if cross:
            packed = torch.randn(batch, SEQ, H, device="cuda", generator=g).bfloat16()
            kv = torch.randn(batch, SEQ, 2 * H, device="cuda", generator=g).bfloat16()
            q, (k, v) = packed, kv.split(H, -1)
        else:
            packed = torch.randn(batch, SEQ, 3 * H, device="cuda", generator=g).bfloat16()
            kv, (q, k, v) = None, packed.split(H, -1)
        mask = _padded_mask(g, batch) if masked else None
        args = (packed, kv, mask, 12, causal, seed, cross_op(12) if cross else 0, rate)
        with torch.no_grad():
            out = attention_forward(*args)
            torch.cuda.synchronize()
            want = attention_forward_reference(*args)
            err = _rel_max(out, want)
            what = (f"attention forward in #1, {key} ({batch},{SEQ},768) bf16, "
                    f"{'causal, ' if causal else ''}{'padded mask' if masked else 'no mask'}, "
                    f"dropout {rate}")
            print(f"{what}: max rel {err:.3e} (tol {TRAIN_REL})")
            if not (_finite(out) and err <= TRAIN_REL):
                _fail(f"{what}: the kernel disagrees with its plain version")
            kf, pf = _paired_ms(lambda: attention_forward(*args),
                                lambda: attention_forward_reference(*args), 20)
            lf = _time_ms(_library_sdpa(q, k, v, mask, causal)[0], 20)
        bf = _bound(4 * batch * 12 * SEQ * SEQ * 64, _nbytes(q, k, v, mask, out), PEAK_BF16)
        r = res[key]
        r["max_abs_err"] = max(r["max_abs_err"], (out.float() - want.float()).abs().max().item())
        r["ms"].append(kf)
        r["plain_ms"].append(pf)
        r["bound"].append(bf)
        r["library_ms"].append(lf)
        print(f"{what}: kernel {kf:.4f} ms, plain {pf:.4f} ms, bound {bf[0]:.4f} ms ({bf[1]}), "
              f"{lib_name} {lf:.4f} ms ({names[0]}; nvidia-smi: {names[1]})")
        del packed, kv, q, k, v, out, want

    # every keep bit visible: q = k = 0 makes p uniform over the keys, v the
    # one-hot of the key position in each head, so the context shows p * keep
    # per (query, key, head), for the self (op ids h) and cross (13 + h) heads
    hd, B = 64, TRAIN_BATCH
    tril = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").tril()
    onehot = torch.zeros(B, SEQ, H, device="cuda")
    for h in range(12):
        onehot[:, torch.arange(SEQ), h * hd + torch.arange(SEQ)] = 1.0
    onehot = onehot.bfloat16()
    zero = torch.zeros_like(onehot)
    kept = []
    with torch.no_grad():
        for cross, causal in ((False, True), (False, False), (True, False)):
            op = cross_op(12) if cross else 0
            if cross:
                ctx = attention_forward(zero, torch.cat([zero, onehot], -1), None, 12, False,
                                        seed, op, 0.1)
            else:
                ctx = attention_forward(torch.cat([zero, zero, onehot], -1), None, None, 12,
                                        causal, seed, op, 0.1)
            ctx = ctx.view(B, SEQ, 12, hd)[..., :SEQ]
            for h in range(12):
                keep = attention_keep(seed, op + h, B, SEQ, SEQ, 0.1, "cuda") > 0
                if causal:
                    keep &= tril
                if not torch.equal(ctx[:, :, h] > 0, keep):
                    _fail(f"attention forward in #1: keep mask of head {h} differs from the "
                          f"plain mask ({'cross' if cross else 'self'}, causal {causal})")
                kept.append(keep.sum().item() / (B * (int(tril.sum()) if causal else SEQ * SEQ)))
    print(f"attention forward in #1: keep masks equal to the plain masks at batch {B} (self "
          f"causal and full, cross with op ids 13..24); kept shares {min(kept):.4f}.."
          f"{max(kept):.4f} (rate 0.1)")
    del onehot, zero, ctx
    torch.cuda.empty_cache()
    return {k: {**v, "ms": statistics.mean(v["ms"]), "plain_ms": statistics.mean(v["plain_ms"]),
                "library_ms": statistics.mean(v["library_ms"])} for k, v in res.items()}


def _head_case(g, rows: int, vocab: int):
    """Operands of the fused head + CE at the bert-base width: x ~ N(0, 1) and
    a 0.05-scale table give logits of std ~1.4, as a trained head's spread."""
    import torch

    x = torch.randn(rows, 768, device="cuda", generator=g).bfloat16()
    table = (0.05 * torch.randn(vocab, 768, device="cuda", generator=g)).bfloat16()
    bias = 0.1 * torch.randn(vocab, device="cuda", generator=g)
    t = torch.randint(0, vocab, (rows,), device="cuda", generator=g, dtype=torch.int32)
    return x, table, bias, t


def phase_head_kernels(names: tuple[str, str]) -> dict:
    """#9 and #10 (store and flash) against their plain versions at the step's
    head shapes and at ragged rows with an odd vocabulary, the table
    gradient's GEMM, and their times."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.ce import ce_bwd, ce_fwd_ids_reference, target_logits
    from kindergarten_vq_vae_torch.ops.head_ce import (
        head_ce_bwd,
        head_ce_bwd_reference,
        head_ce_fwd,
        head_ce_fwd_reference,
        table_grad,
        table_grad_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    res = {}
    for case, rows, vocab in (("step", TRAIN_BATCH * SEQ, VOCAB), ("ragged", 1037, VOCAB - 1)):
        x, table, bias, t = _head_case(g, rows, vocab)
        scale = torch.rand(rows, device="cuda", generator=g) / rows
        with torch.no_grad():
            fwd = {m: head_ce_fwd(x, table, bias, t, m) for m in HEAD_MODES}
            torch.cuda.synchronize()
            nll, lse, ids, logits = fwd["store"]
            flash_same = all(torch.equal(a, b) for a, b in zip(fwd["store"][:3], fwd["flash"][:3]))
            nll_p, _, ids_p, logits_p = head_ce_fwd_reference(x, table, bias, t, "store")
            dl = (logits.float() - logits_p.float()).abs().max().item()
            ulp_top = 2.0 ** (math.floor(math.log2(logits_p.float().abs().max().item())) - 7)
            nll_own, ids_own = ce_fwd_ids_reference(logits, t)
            lse_own = nll_own + target_logits(logits, t)
            own_err = max((nll - nll_own).abs().max().item(), (lse - lse_own).abs().max().item())
            top2 = logits_p.float().topk(2, dim=1).values
            clear = top2[:, 0] - top2[:, 1] > 2 * dl
            ids_clear = torch.equal(ids[clear], ids_p[clear])
            ids_share = (ids == ids_p).float().mean().item()
            nll_err = (nll - nll_p).abs().max().item()
            ids_own_ok = torch.equal(ids, ids_own)
            del top2, logits_p, nll_own, ids_own
            print(f"head_ce_fwd {case} ({rows},768)x{vocab} bf16: logits max abs {dl:.3e} "
                  f"(tol {2 * ulp_top:.3e}: 2 bf16 ulps at the top), nll/lse vs the plain CE over "
                  f"its own logits {own_err:.3e} (tol {CE_NLL_ABS}), ids equal to it "
                  f"{ids_own_ok}; vs plain: nll "
                  f"{nll_err:.3e} (tol 2 dl), ids equal where the top-2 gap > 2 dl "
                  f"({int(clear.sum())} of {rows} rows) {ids_clear}, in all {ids_share:.5f} "
                  f"(tol {HEAD_IDS_SHARE}); flash = store bit for bit {flash_same}")
            if not (dl <= 2 * ulp_top and own_err <= CE_NLL_ABS and nll_err <= 2 * dl + CE_NLL_ABS
                    and ids_clear and ids_share >= HEAD_IDS_SHARE and flash_same and ids_own_ok):
                _fail(f"fused head + CE forward disagrees with its plain version ({case})")

            bwd = {m: head_ce_bwd(logits if m == "store" else x, table, bias, t, lse, scale, m)
                   for m in HEAD_MODES}
            torch.cuda.synchronize()
            gk, dxk, dbk = bwd["store"]
            bflash_same = all(torch.equal(a, b) for a, b in zip(bwd["store"], bwd["flash"]))
            gp, dxp, dbp = head_ce_bwd_reference(logits, table, bias, t, lse, scale, "store")
            ld = gk.stride(0)
            pad_zero = bool((gk.as_strided((rows, ld), (ld, 1))[:, vocab:] == 0).all())
            errs = {"g": _rel_max(gk, gp), "dx": _rel_max(dxk, dxp), "dbias": _rel_max(dbk, dbp)}
            bwd_abs = max((a.float() - b.float()).abs().max().item()
                          for a, b in ((gk, gp), (dxk, dxp), (dbk, dbp)))
            del gp, dxp
            dt = table_grad(gk, x)
            torch.cuda.synchronize()
            errs["d_table"] = _rel_max(dt, table_grad_reference(gk, x))
            print(f"head_ce_bwd {case}: rel to the largest, g {errs['g']:.3e} (tol "
                  f"{CE_GRAD_REL}), dx {errs['dx']:.3e} (tol {TRAIN_REL}), dbias "
                  f"{errs['dbias']:.3e} (tol {HEAD_DBIAS_REL}), d_table {errs['d_table']:.3e} "
                  f"(tol {HEAD_DTABLE_REL}); flash = store bit for bit {bflash_same}; g's row "
                  f"{ld} wide, pad columns 0 {pad_zero}")
            if not (errs["g"] <= CE_GRAD_REL and errs["dx"] <= TRAIN_REL
                    and errs["dbias"] <= HEAD_DBIAS_REL and errs["d_table"] <= HEAD_DTABLE_REL
                    and bflash_same and pad_zero and dbk.dtype == torch.float32
                    and dt.dtype == torch.float32):
                _fail(f"fused head + CE backward disagrees with its plain version ({case})")
            if case != "step":
                continue

            # times at the step's shapes; bounds: the GEMMs' operations at the bf16
            # peak against each input read and each output written once
            flops = 2 * rows * vocab * 768
            bias_c = bias.bfloat16()

            def lib_fwd():
                lg = torch.matmul(x, table.t()) + bias_c
                return F.cross_entropy(lg, t.long(), reduction="none"), lg.argmax(1)

            logits_c = logits.contiguous()  # #8 reads unpadded rows

            def lib_bwd():
                gg = ce_bwd(logits_c, t, lse, scale)
                return torch.matmul(gg, table), gg.sum(0, dtype=torch.float32)

            def rate(ms, f=flops):  # TFLOP/s and share of the bf16 peak
                return f"{f / ms / 1e9:.1f} TFLOP/s ({f / ms / 1e9 / (PEAK_BF16 / 1e12):.1%})"

            lib_fwd_ms, lib_bwd_ms = _time_ms(lib_fwd, 10), _time_ms(lib_bwd, 10)
            for m in HEAD_MODES:
                saved = logits if m == "store" else x
                k_ms, p_ms = _paired_ms(lambda m=m: head_ce_fwd(x, table, bias, t, m),
                                        lambda m=m: head_ce_fwd_reference(x, table, bias, t, m), 10)
                bound = _bound(flops, _nbytes(x, table, bias, t, fwd[m]), PEAK_BF16)
                res[f"fwd_{m}"] = {
                    "max_abs_err": max(own_err, nll_err), "ms": k_ms, "plain_ms": p_ms,
                    "bound": [bound], "library_ms": lib_fwd_ms,
                    "library": "cuBLAS head GEMM (torch.matmul) + bias + F.cross_entropy + argmax"}
                print(f"head_ce_fwd {m}: kernel {k_ms:.4f} ms, {rate(k_ms)}, plain {p_ms:.4f} "
                      f"ms, bound {bound[0]:.4f} ms ({bound[1]}), cuBLAS head GEMM + "
                      f"F.cross_entropy + argmax {lib_fwd_ms:.4f} ms, {rate(lib_fwd_ms)}")
                k_ms, p_ms = _paired_ms(
                    lambda m=m, saved=saved: head_ce_bwd(saved, table, bias, t, lse, scale, m),
                    lambda m=m, saved=saved: head_ce_bwd_reference(saved, table, bias, t, lse,
                                                                   scale, m), 10)
                bound = _bound(flops * (2 if m == "flash" else 1),
                               _nbytes(saved, table, bias, t, lse, scale, bwd[m]), PEAK_BF16)
                res[f"bwd_{m}"] = {
                    "max_abs_err": bwd_abs, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                    "library_ms": lib_bwd_ms,
                    "library": "#8 + cuBLAS dgrad GEMM (torch.matmul) + column sum"}
                bwd_flops = flops * (2 if m == "flash" else 1)
                print(f"head_ce_bwd {m}: kernel {k_ms:.4f} ms, {rate(k_ms, bwd_flops)}, plain "
                      f"{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), #8 + cuBLAS dgrad "
                      f"GEMM + column sum {lib_bwd_ms:.4f} ms, {rate(lib_bwd_ms)}")
            k_ms, p_ms = _paired_ms(lambda: table_grad(gk, x), lambda: table_grad_reference(gk, x),
                                    10)
            wgrad_ms = _time_ms(lambda: torch.matmul(gk.t(), x), 10)
            bound = _bound(flops, _nbytes(gk, x, dt), PEAK_BF16)
            res["d_table"] = {"ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                              "library_ms": wgrad_ms}
            del logits_c
            print(f"d_table (the GEMM's TN split-K product, f32 out): {k_ms:.4f} ms, "
                  f"{rate(k_ms)}, plain (f32 torch.matmul) {p_ms:.4f} ms, bound {bound[0]:.4f} "
                  f"ms ({bound[1]}), cuBLAS wgrad torch.matmul(g.T, x) (bf16 out) "
                  f"{wgrad_ms:.4f} ms, {rate(wgrad_ms)} ({names[0]}; nvidia-smi: {names[1]})")
        del fwd, bwd, logits, gk, dxk, dbk, dt, x, table
        torch.cuda.empty_cache()
    return res


def _sdpa_case(g, batch: int, cross: bool, masked: bool, dtype=None):
    """q, k, v at the bert-base width as the per-module trunk hands them
    over, in ``dtype`` (bf16 when None): split views of a packed qkv (self)
    or of q and a packed kv (cross); a padded key mask or None."""
    import torch

    H, dtype = 768, dtype or torch.bfloat16
    if cross:
        q = torch.randn(batch, SEQ, H, device="cuda", generator=g).to(dtype)
        k, v = torch.randn(batch, SEQ, 2 * H, device="cuda", generator=g).to(dtype).split(H, -1)
    else:
        q, k, v = torch.randn(batch, SEQ, 3 * H, device="cuda", generator=g).to(dtype).split(H, -1)
    return q, k, v, _padded_mask(g, batch) if masked else None


def _padded_mask(g, batch: int):
    """A (batch, SEQ) int32 key mask of random lengths 1..SEQ."""
    import torch

    lens = torch.randint(1, SEQ + 1, (batch,), device="cuda", generator=g)
    return (torch.arange(SEQ, device="cuda")[None] < lens[:, None]).to(torch.int32)


def _library_sdpa(q, k, v, mask, causal: bool, pin: bool = False, nh: int = 12):
    """``F.scaled_dot_product_attention`` at rate 0 on the same inputs (``nh``
    heads), with the head transposes: its forward call, and the call of its
    autograd backward given g (a yardstick only: the port never calls it).
    ``pin``: its backend pinned with ``torch.nn.attention.sdpa_kernel``, flash
    in bf16 up to head_dim 256 (which takes no mask: ``is_causal`` alone, the
    padded keys unmasked) and memory-efficient otherwise (with the mask), and
    a third value, the backend's name; else PyTorch picks its own kernel."""
    import contextlib

    import torch
    import torch.nn.functional as F

    b, s, H = q.shape
    heads = [t.reshape(b, t.shape[1], nh, H // nh).transpose(1, 2) for t in (q, k, v)]
    flash = pin and q.dtype == torch.bfloat16 and H // nh <= 256
    attn = None
    if not flash and (mask is not None or causal):
        attn = torch.ones(b, 1, s, k.shape[1], dtype=torch.bool, device="cuda")
        if mask is not None:
            attn = attn & (mask[:, None, None, :] > 0)
        if causal:
            attn = attn & torch.ones(s, k.shape[1], dtype=torch.bool, device="cuda").tril()
    kw = {"is_causal": causal} if flash else {"attn_mask": attn}
    backend, pinned = None, contextlib.nullcontext
    if pin:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        backend = SDPBackend.FLASH_ATTENTION if flash else SDPBackend.EFFICIENT_ATTENTION
        pinned = lambda: sdpa_kernel([backend])  # noqa: E731

    def fwd():
        with pinned():
            out = F.scaled_dot_product_attention(*heads, **kw)
        return out.transpose(1, 2).reshape(b, s, H)

    with torch.enable_grad(), pinned():
        leaves = [t.detach().contiguous().requires_grad_() for t in heads]
        out = F.scaled_dot_product_attention(*leaves, **kw)
    gh = torch.randn_like(out)

    def bwd():
        with torch.enable_grad(), pinned():
            return torch.autograd.grad(out, leaves, gh, retain_graph=True)

    if not pin:
        return fwd, bwd
    notes = [n for n, on in (("is_causal", flash and causal),
                             ("keys unmasked", flash and mask is not None)) if on]
    return fwd, bwd, ", ".join([backend.name, *notes])


def phase_sdpa_kernels(names: tuple[str, str], dtype=None) -> dict:
    """#11 and #12 (self from qkv views, causal, padded masks; cross from kv
    views; dropout 0.1) and #13 against their plain versions at the
    batch-2048 training shapes, #11 at the bucket-256 serving shape (rate 0),
    the keep masks exact, and their times beside the plain versions', their
    byte bounds and ``F.scaled_dot_product_attention``. ``dtype`` f32: their
    f32 instances against the f32 plain versions (F32_FWD, F32_GRAD), the
    bounds at the f32 rate, the yardstick in f32; bf16 when None."""
    import torch

    from kindergarten_vq_vae_torch.ops.attention import fused_mha, mha_forward, mha_reference
    from kindergarten_vq_vae_torch.ops.dropout import attention_keep
    from kindergarten_vq_vae_torch.ops.sdpa import (
        sdpa_backward,
        sdpa_backward_reference,
        sdpa_forward,
        sdpa_forward_reference,
    )

    f32 = dtype == torch.float32
    dtype = dtype or torch.bfloat16
    tag, peak = ("f32", PEAK_3XTF32) if f32 else ("bf16", PEAK_BF16)
    fwd_tol, bwd_tol = (F32_FWD, F32_GRAD) if f32 else (TRAIN_REL, TRAIN_REL)
    g = torch.Generator(device="cuda").manual_seed(SEED + (13 if f32 else 5))
    seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
    res = {}
    products = TRAIN_BATCH * 12 * SEQ * SEQ * 64  # multiply-adds of one S x S x hd product a head
    lib_name = f"F.scaled_dot_product_attention, {tag} (rate 0, head transposes)"
    for kind, cross, causal in (("self", False, True), ("cross", True, False)):
        q, k, v, mask = _sdpa_case(g, TRAIN_BATCH, cross, not cross, dtype)
        gr = torch.randn(TRAIN_BATCH, SEQ, 768, device="cuda", generator=g).to(dtype)
        args = (q, k, v, mask, seed)
        kw = dict(num_heads=12, causal=causal, rate=0.1)
        with torch.no_grad():
            out = sdpa_forward(*args, cross=cross, **kw)
            grads = sdpa_backward(*args, gr, cross=cross, **kw)
            torch.cuda.synchronize()
            want_f = sdpa_forward_reference(*args, **kw)
            want_b = sdpa_backward_reference(*args, gr, **kw)
            f_err, b_err = _rel_max(out, want_f), _leaf_errors(grads, want_b)
            print(f"sdpa {kind} ({TRAIN_BATCH},{SEQ},768) {tag}, {'causal, ' if causal else ''}"
                  f"{'padded mask' if mask is not None else 'no mask'}, dropout 0.1: forward "
                  f"max rel {f_err:.3e} (tol {fwd_tol}), dq/dk/dv max rel {b_err:.3e} (tol "
                  f"{bwd_tol})")
            if not (_finite(out) and out.dtype == dtype and f_err <= fwd_tol
                    and b_err <= bwd_tol):
                _fail(f"SDPA kernels disagree with their plain versions ({kind}, {tag})")
            lib_fwd, lib_bwd = _library_sdpa(q, k, v, mask, causal)
            kf, pf = _paired_ms(lambda: sdpa_forward(*args, cross=cross, **kw),
                                lambda: sdpa_forward_reference(*args, **kw), 20)
            kb, pb = _paired_ms(lambda: sdpa_backward(*args, gr, cross=cross, **kw),
                                lambda: sdpa_backward_reference(*args, gr, **kw), 20)
            lf = _time_ms(lib_fwd, 20)
        lb = _time_ms(lib_bwd, 20)
        bf = _bound(4 * products, _nbytes(q, k, v, mask, out), peak)
        bb = _bound(10 * products, _nbytes(q, k, v, mask, gr, grads), peak)
        res[f"fwd_{kind}"] = {"max_abs_err": (out.float() - want_f.float()).abs().max().item(),
                              "ms": kf, "plain_ms": pf, "bound": [bf], "library_ms": lf,
                              "library": lib_name}
        res[f"bwd_{kind}"] = {"max_abs_err": max((a.float() - b.float()).abs().max().item()
                                                 for a, b in zip(grads, want_b)),
                              "ms": kb, "plain_ms": pb, "bound": [bb], "library_ms": lb,
                              "library": "autograd backward of " + lib_name}
        print(f"sdpa_forward {tag} {kind}: kernel {kf:.4f} ms, plain {pf:.4f} ms, bound {bf[0]:.4f} ms "
              f"({bf[1]}, {bf[0] / kf:.1%} of it), {lib_name} {lf:.4f} ms; sdpa_backward {kind}: "
              f"kernel {kb:.4f} ms, plain {pb:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}, "
              f"{bb[0] / kb:.1%} of it), its autograd backward {lb:.4f} ms ({names[0]}; "
              f"nvidia-smi: {names[1]})")
        del q, k, v, gr, out, grads, want_f, want_b, lib_fwd, lib_bwd

    # every keep bit visible: q = k = 0 makes p uniform over the valid keys, v
    # (and g) the one-hot of the key (query) position in each head, so the
    # context shows p * keep per (query, key, head) and dv its transpose
    hd, B = 64, TRAIN_BATCH
    tril = torch.ones(SEQ, SEQ, dtype=torch.bool, device="cuda").tril()
    onehot = torch.zeros(B, SEQ, 768, device="cuda")
    for h in range(12):
        onehot[:, torch.arange(SEQ), h * hd + torch.arange(SEQ)] = 1.0
    onehot = onehot.to(dtype)
    zero = torch.zeros_like(onehot)
    kept = []
    with torch.no_grad():
        for causal in (True, False):
            ctx = sdpa_forward(zero, zero, onehot, None, seed, 12, causal, 0.1)
            dv = sdpa_backward(zero, zero, onehot, None, seed, onehot, 12, causal, 0.1)[2]
            ctx = ctx.view(B, SEQ, 12, hd)[..., :SEQ]
            dv = dv.view(B, SEQ, 12, hd)[..., :SEQ]
            for h in range(12):
                keep = attention_keep(seed, h, B, SEQ, SEQ, 0.1, "cuda") > 0
                if causal:
                    keep &= tril
                if not (torch.equal(ctx[:, :, h] > 0, keep)
                        and torch.equal(dv[:, :, h].transpose(1, 2) > 0, keep)):
                    _fail(f"SDPA keep mask of head {h} differs from the plain mask "
                          f"({'causal' if causal else 'full'})")
                visible = B * (int(tril.sum()) if causal else SEQ * SEQ)
                kept.append(keep.sum().item() / visible)
    print(f"sdpa {tag} keep masks equal to the plain masks at batch {B} (heads 0..11, causal and "
          f"full, forward through ctx and backward through dv); kept shares "
          f"{min(kept):.4f}..{max(kept):.4f} (rate 0.1)")
    del onehot, zero

    # #11 at the bucket-256 serving shape, rate 0 (an encoder layer's self-attention)
    q, k, v, mask = _sdpa_case(g, BUCKET, False, True, dtype)
    with torch.no_grad():
        out = sdpa_forward(q, k, v, mask, None, 12)
        torch.cuda.synchronize()
        err = _rel_max(out, sdpa_forward_reference(q, k, v, mask, None, 12))
        kf, pf = _paired_ms(lambda: sdpa_forward(q, k, v, mask, None, 12),
                            lambda: sdpa_forward_reference(q, k, v, mask, None, 12))
        lf = _time_ms(_library_sdpa(q, k, v, mask, False)[0])
    bf = _bound(4 * BUCKET * 12 * SEQ * SEQ * 64, _nbytes(q, k, v, mask, out), peak)
    print(f"sdpa_forward {tag} serving ({BUCKET},{SEQ},768), rate 0: max rel {err:.3e} "
          f"(tol {fwd_tol}); "
          f"kernel {kf:.4f} ms, plain {pf:.4f} ms, bound {bf[0]:.4f} ms ({bf[1]}), {lib_name} "
          f"{lf:.4f} ms")
    if err > fwd_tol:
        _fail(f"SDPA forward kernel disagrees with its plain version at the serving shape ({tag})")
    res["fwd_serving"] = {"ms": kf, "plain_ms": pf, "bound": [bf], "library_ms": lf}

    # #13 at the training shapes (no caller in either package: this is its path),
    # sentence 3 fully masked (uniform over every key)
    q, k, v, mask = _sdpa_case(g, TRAIN_BATCH, False, True, dtype)
    mask[3] = 0
    with torch.no_grad():
        out = mha_forward(q, k, v, mask, 12)
        torch.cuda.synchronize()
        want = mha_reference(q, k, v, mask, 12)
        err = _rel_max(out, want)
        kf, pf = _paired_ms(lambda: mha_forward(q, k, v, mask, 12),
                            lambda: mha_reference(q, k, v, mask, 12), 20)
        lf = _time_ms(_library_sdpa(q, k, v, mask, False)[0], 20)
    bf = _bound(4 * products, _nbytes(q, k, v, mask, out), peak)
    print(f"mha_forward (#13) ({TRAIN_BATCH},{SEQ},768) {tag}, padded mask, a fully masked "
          f"sentence: max rel {err:.3e} (tol {fwd_tol}); kernel {kf:.4f} ms, plain {pf:.4f} ms, "
          f"bound {bf[0]:.4f} ms ({bf[1]}, {bf[0] / kf:.1%} of it), {lib_name} {lf:.4f} ms")
    if not _finite(out) or out.dtype != dtype or err > fwd_tol:
        _fail(f"MHA kernel #13 disagrees with its plain version ({tag})")
    res["mha"] = {"max_abs_err": (out.float() - want.float()).abs().max().item(), "ms": kf,
                  "plain_ms": pf, "bound": [bf], "library_ms": lf, "library": lib_name}
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    _reset_counters()
    fused_mha(*leaves, mask, 12).float().sum().backward()
    torch.cuda.synchronize()
    counts = _counters()
    want_counts = {c: 0 for c in counts}
    want_counts["mha"] = 1
    if f32:
        want_counts = _as_f32(want_counts)
    print(f"fused_mha {tag} through its autograd at ({TRAIN_BATCH},{SEQ},768): launches {counts}")
    if counts != want_counts or not all(_finite(t.grad) for t in leaves):
        _fail(f"fused_mha did not run #13 ({tag}) once with finite gradients: {counts}")
    res["mha_launches"] = counts["mha"]
    del q, k, v, out, want, leaves
    torch.cuda.empty_cache()
    return res


def _long_attention(names: tuple[str, str], g, dtype) -> dict:
    """The attention past 32 tokens (csrc/attention_long.cu; ``dtype`` bf16
    or f32) through every entry: the layer's attention forward and backward
    (#1a, #3 / #4), #11 / #12 and #13, against their plain versions, at
    LONG_SEQ tokens x LONG_BATCH sentences (self causal with a padded mask,
    cross over padded keys; dropout 0.1), timed in turns with the plain
    versions, beside the bound and ``F.scaled_dot_product_attention`` with
    its backend pinned (flash in bf16, memory-efficient in f32); at 512
    tokens (self) and 33 queries over 512 keys (cross), 8 sentences, held
    only; at each shape two launches of the forward and the backward give
    the same bits; the keep masks exact at LONG_SEQ through the layer's forward (the
    context) and backward (dv); #11 / #12 and #13 once through their
    autograd (their launch counts)."""
    import torch

    from kindergarten_vq_vae_torch.ops.attention import fused_mha, mha_forward, mha_reference
    from kindergarten_vq_vae_torch.ops.dropout import attention_keep, cross_op
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_backward_reference,
        attention_forward,
        attention_forward_reference,
    )
    from kindergarten_vq_vae_torch.ops.sdpa import (
        fused_sdpa,
        sdpa_backward,
        sdpa_backward_reference,
        sdpa_forward,
        sdpa_forward_reference,
    )

    f32 = dtype == torch.float32
    tag, peak = ("f32", PEAK_3XTF32) if f32 else ("bf16", PEAK_BF16)
    fwd_tol, bwd_tol = (F32_FWD, F32_GRAD) if f32 else (TRAIN_REL, TRAIN_REL)
    seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
    H, NH, hd = 768, 12, 64
    res = {}

    def repeats(what, call):
        """Two launches of ``call`` give the same bits (fixed-order sums)."""
        a, b = call(), call()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            _fail(f"long attention ({tag}): two launches of {what} differ")

    def held(what, got, want, tol):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(_rel_max(a, b) for a, b in zip(got, want))
        ok = all(_finite(a) and a.dtype == dtype and a.shape == b.shape
                 for a, b in zip(got, want))
        print(f"  {what}: max rel {err:.3e} (tol {tol})")
        if not ok or err > tol:
            _fail(f"long attention ({tag}): {what} disagrees with its plain version")
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    for batch, sq, sk, cross in ((LONG_BATCH, LONG_SEQ, LONG_SEQ, False),
                                 (LONG_BATCH, LONG_SEQ, LONG_SEQ, True),
                                 (8, 512, 512, False), (8, 33, 512, True)):
        kind, causal = ("cross", False) if cross else ("self", True)
        op = cross_op(NH) if cross else 0
        if cross:
            packed = torch.randn(batch, sq, H, device="cuda", generator=g).to(dtype)
            kv = torch.randn(batch, sk, 2 * H, device="cuda", generator=g).to(dtype)
            q, (k, v) = packed, kv.split(H, -1)
        else:
            packed, kv = torch.randn(batch, sq, 3 * H, device="cuda", generator=g).to(dtype), None
            q, k, v = packed.split(H, -1)
        lens = torch.randint(1, sk + 1, (batch,), device="cuda", generator=g)
        mask = (torch.arange(sk, device="cuda")[None] < lens[:, None]).to(torch.int32)
        gr = torch.randn(batch, sq, H, device="cuda", generator=g).to(dtype)
        la = (packed, kv, mask, NH, causal, seed, op, 0.1)
        lb = (packed, kv, mask, gr, NH, causal, seed, op, 0.1)
        sa, skw = (q, k, v, mask, seed), dict(num_heads=NH, causal=causal, rate=0.1)
        print(f"long attention {tag} {kind} ({batch},{sq},768) over {sk} keys, "
              f"{'causal, ' if causal else ''}padded keys, dropout 0.1:")
        with torch.no_grad():
            errs = {
                "fwd": held("attention_forward (#1a)", attention_forward(*la),
                            attention_forward_reference(*la), fwd_tol),
                "bwd": held("attention_backward (#3 / #4)", attention_backward(*lb),
                            attention_backward_reference(*lb), bwd_tol),
                "sdpa_fwd": held("sdpa_forward (#11)", sdpa_forward(*sa, cross=cross, **skw),
                                 sdpa_forward_reference(*sa, **skw), fwd_tol),
                "sdpa_bwd": held("sdpa_backward (#12)",
                                 sdpa_backward(*sa, gr, cross=cross, **skw),
                                 sdpa_backward_reference(*sa, gr, **skw), bwd_tol)}
            if not cross:
                errs["mha"] = held("mha_forward (#13)", mha_forward(q, k, v, mask, NH, causal),
                                   mha_reference(q, k, v, mask, NH, causal), fwd_tol)
            repeats("attention_forward", lambda: attention_forward(*la))
            repeats("attention_backward", lambda: attention_backward(*lb))
            repeats("sdpa_backward", lambda: sdpa_backward(*sa, gr, cross=cross, **skw))
        print("  two launches of attention_forward, attention_backward and sdpa_backward: "
              "the same bits")
        if batch == LONG_BATCH:
            products = batch * NH * sq * sk * hd
            lib_fwd, lib_bwd, backend = _library_sdpa(q, k, v, mask, causal, pin=True)
            lib_name = (f"F.scaled_dot_product_attention, {tag}, backend {backend} (rate 0, "
                        f"head transposes)")
            with torch.no_grad():
                lf = _time_ms(lib_fwd, 10)
                timed = {
                    "fwd": _paired_ms(lambda: attention_forward(*la),
                                      lambda: attention_forward_reference(*la), 10),
                    "bwd": _paired_ms(lambda: attention_backward(*lb),
                                      lambda: attention_backward_reference(*lb), 10),
                    "sdpa_fwd": _paired_ms(lambda: sdpa_forward(*sa, cross=cross, **skw),
                                           lambda: sdpa_forward_reference(*sa, **skw), 10),
                    "sdpa_bwd": _paired_ms(lambda: sdpa_backward(*sa, gr, cross=cross, **skw),
                                           lambda: sdpa_backward_reference(*sa, gr, **skw), 10)}
                if not cross:
                    timed["mha"] = _paired_ms(lambda: mha_forward(q, k, v, mask, NH, causal),
                                              lambda: mha_reference(q, k, v, mask, NH, causal), 10)
            lb_ms = _time_ms(lib_bwd, 10)
            # bytes: q, k, v and the mask read, the context written (gr's
            # shape); the backward also reads g and writes dq, dk, dv
            bf = _bound(4 * products, _nbytes(q, k, v, mask, gr), peak)
            bb = _bound(10 * products, _nbytes(q, k, v, mask, gr, q, k, v), peak)
            for key, (k_ms, p_ms) in timed.items():
                b_ = bb if key.endswith("bwd") else bf
                res[f"{key}_{kind}"] = {
                    "max_abs_err": errs[key], "ms": k_ms, "plain_ms": p_ms, "bound": [b_],
                    "library_ms": lb_ms if key.endswith("bwd") else lf,
                    "library": ("autograd backward of " if key.endswith("bwd") else "") + lib_name}
                print(f"  {key} {tag} {kind}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{b_[0]:.4f} ms ({b_[1]}, {b_[0] / k_ms:.1%} of it), "
                      f"{'its autograd backward ' if key.endswith('bwd') else lib_name + ' '}"
                      f"{lb_ms if key.endswith('bwd') else lf:.4f} ms ({names[0]}; nvidia-smi: "
                      f"{names[1]})")
            del lib_fwd, lib_bwd
        del packed, kv, q, k, v, gr

    # every keep bit visible at LONG_SEQ tokens: q = k = 0, v and g one-hot in
    # the key / query position of each head (LONG_SEQ <= head_dim)
    B, S = 16, LONG_SEQ
    onehot = torch.zeros(B, S, H, device="cuda")
    for h in range(NH):
        onehot[:, torch.arange(S), h * hd + torch.arange(S)] = 1.0
    onehot = onehot.to(dtype)
    zero = torch.zeros_like(onehot)
    with torch.no_grad():
        for cross in (False, True):
            if cross:
                packed, kv, op = zero, torch.cat([zero, onehot], -1), cross_op(NH)
            else:
                packed, kv, op = torch.cat([zero, zero, onehot], -1), None, 0
            ctx = attention_forward(packed, kv, None, NH, False, seed, op, 0.1)
            grads = attention_backward(packed, kv, None, onehot, NH, False, seed, op, 0.1)
            dv = (grads[1][..., H:] if cross else grads[..., 2 * H:]).view(B, S, NH, hd)[..., :S]
            ctx = ctx.view(B, S, NH, hd)[..., :S]
            for h in range(NH):
                keep = attention_keep(seed, op + h, B, S, S, 0.1, "cuda") > 0
                if not (torch.equal(ctx[:, :, h] > 0, keep)
                        and torch.equal(dv[:, :, h].transpose(1, 2) > 0, keep)):
                    _fail(f"long attention ({tag}): keep mask of head {h} differs from the "
                          f"plain mask ({'cross' if cross else 'self'})")
    print(f"long attention {tag}: keep masks equal to the plain masks at {S} tokens (self op ids "
          f"0..11, cross 13..24; the context and dv)")
    del onehot, zero, ctx, grads, dv

    # #11 / #12 (self causal, then cross) and #13 through their autograd at
    # LONG_SEQ: their launches
    leaves = [torch.randn(8, LONG_SEQ, H, device="cuda", generator=g).to(dtype).requires_grad_()
              for _ in range(3)]
    _reset_counters()
    fused_sdpa(*leaves, None, seed, NH, True, 0.1).float().sum().backward()
    fused_sdpa(*leaves, None, seed, NH, False, 0.1, cross=True).float().sum().backward()
    fused_mha(*leaves, None, NH, True).float().sum().backward()
    torch.cuda.synchronize()
    counts = _counters()
    sdpa_keys = [f"sdpa_{d}_{kind}" for d in ("fwd", "bwd") for kind in ("self", "cross")]
    res["sdpa_launches"] = {k_: counts[k_] for k_ in sdpa_keys}
    res["mha_launches"] = counts["mha"]
    print(f"long attention {tag}: fused_sdpa (self, cross) and fused_mha through their "
          f"autograd at (8,{LONG_SEQ},768): launches {res['sdpa_launches']}, mha "
          f"{res['mha_launches']}")
    if res["sdpa_launches"] != dict.fromkeys(sdpa_keys, 1) or counts["mha"] != 1:
        _fail(f"long attention ({tag}): the autograd runs did not launch the kernels once")
    del leaves
    torch.cuda.empty_cache()
    return res


def phase_long(names: tuple[str, str]) -> dict:
    """The configurations past the one-pass kernels (phase 20): the VQ's
    general path (#5) at LONG_CODES codes x 768 and 1,024 x 1,280 and on an
    adversarial codebook, the codebook gradient over the grouped rows (5+)
    at LONG_CODES and 1,024 codes, the
    long attention in bf16 and f32 (``_long_attention``); then the bert-base
    Shelgon3-VQ training steps through the default ("auto") route, dropout
    on: at vq_n_e LONG_CODES (batch 2048 x 12) and at LONG_SEQ tokens (batch
    LONG_BATCH, bf16; batch LONG_F32_BATCH, f32), each with every launch
    count of the step (#1, #2, #5, 5+ and #7 among them) and every plain
    version of the route refused."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    rows = TRAIN_BATCH * SEQ
    res = {"vq": _vq_general_case(names, g, rows, 768, LONG_CODES)}
    res["vq_1024"] = _vq_general_case(names, g, rows, 1280, 1024)
    res["vq_adversarial"] = _vq_adversarial_case(names, g, rows)
    res["codebook_grad"] = _codebook_grad_case(names, g, rows, 768, LONG_CODES)
    res["codebook_grad_1024"] = _codebook_grad_case(names, g, rows, 1280, 1024)
    res["attn"] = _long_attention(names, g, torch.bfloat16)
    res["attn_f32"] = _long_attention(names, g, torch.float32)
    res["train_codes"] = phase_train(names, steps=LONG_STEPS, over={"vq_n_e": LONG_CODES})
    res["train_seq"] = phase_train(names, steps=LONG_STEPS, batch=LONG_BATCH, seq=LONG_SEQ)
    res["train_seq_f32"] = phase_train(names, steps=LONG_STEPS, batch=LONG_F32_BATCH,
                                       seq=LONG_SEQ, dtype="float32")
    return res


def _wide_layernorm(names: tuple[str, str], g) -> dict:
    """The LayerNorm kernels' rows past 1,024 columns (``csrc/layernorm.cu``'s
    block-a-row kernels) alone at WIDE_LN_ROWS x WIDE_LN_WIDTHS: the residual
    + LayerNorm (x bf16 or f32) and the backward (v bf16 with gy bf16 or f32;
    v and gy f32), dropout 0.1, each held to its plain version at phase 2c's
    bars, every keep bit of da equal to the plain mask's, the backward's sums
    the same bits in two launches; each timed in turns with its plain
    version, beside its byte bound and library call; at 3,072 rows, where a
    call's host work outlasts its kernels, the kernel and the library call
    as CUDA graphs (``_graph_ms``). Returns the rows of the kernels line:
    (3,072, 1,280), the gpt2-large step's rows."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.dropout import OP_MLP_OUT, hidden_keep
    from kindergarten_vq_vae_torch.ops.layer import (
        layernorm_backward,
        layernorm_backward_reference,
        residual_layernorm,
        residual_layernorm_reference,
    )

    rate, eps, seed, dev = 0.1, 1e-12, 4321, "cuda"
    res = {}
    for M in WIDE_LN_ROWS:
        for N in WIDE_LN_WIDTHS:
            iters = 10 if M * N <= 2**23 else 3
            paired, lib_timer = ((_paired_graph_ms, lambda fn, _: _graph_ms(fn)) if M <= 4096
                                 else (_paired_ms, _time_ms))
            how = ", kernel and library as CUDA graphs" if M <= 4096 else ""
            gamma = 1.0 + 0.1 * torch.randn(N, device=dev, generator=g)
            gamma[N - 5] = 0.0  # a dead column: yhat 0, no dgamma
            beta = 0.1 * torch.randn(N, device=dev, generator=g)
            keep = hidden_keep(seed, OP_MLP_OUT, M, N, rate, dev)
            a = 0.5 * torch.randn(M, N, device=dev, generator=g) + 0.2
            for dtype in (torch.bfloat16, torch.float32):
                tag = "bf16" if dtype == torch.bfloat16 else "f32"
                x = torch.randn(M, N, device=dev, generator=g).to(dtype)
                out, inv = residual_layernorm(x, a, gamma, beta, eps, seed, OP_MLP_OUT, rate)
                torch.cuda.synchronize()
                want_out, want_inv = residual_layernorm_reference(x, a, gamma, beta, eps, keep)
                r = x.float() + a * keep
                mu = r.mean(-1, keepdim=True)
                f32_out = (r - mu) * want_inv[:, None] * gamma + beta
                excess = max(_gemm_excess(out, f32_out), _rel_max(inv, want_inv) - LN_REL)
                if not _finite(out) or excess > 0:
                    _fail(f"wide residual_layernorm ({M},{N}) {tag} disagrees with its plain "
                          f"version (excess {excess:.3e})")
                k_ms, p_ms = paired(
                    lambda: residual_layernorm(x, a, gamma, beta, eps, seed, OP_MLP_OUT, rate),
                    lambda: residual_layernorm_reference(
                        x, a, gamma, beta, eps, hidden_keep(seed, OP_MLP_OUT, M, N, rate, dev)),
                    iters)
                lib_ms = lib_timer(lambda: F.layer_norm(x.float() + a, (N,), gamma, beta, eps),
                                   iters)
                bound = _bound(0.0, _nbytes(x, a, gamma, beta, out, inv), PEAK_F32)
                err = (out.float() - want_out.float()).abs().max().item()
                print(f"wide residual_layernorm ({M},{N}) x {tag}, dropout {rate}{how}: "
                      f"{k_ms:.4f} ms, "
                      f"bound {bound[0]:.4f} ms ({bound[1]}, {bound[0] / k_ms:.1%} of it), plain "
                      f"{p_ms:.4f} ms, x + a then F.layer_norm {lib_ms:.4f} ms, max abs {err:.3e}"
                      f" ({names[0]}; nvidia-smi: {names[1]})")
                if (M, N) == WIDE_LN_TABLE:
                    res[f"ln_fwd_{tag}"] = {
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                        "library_ms": lib_ms, "library": "x + a then F.layer_norm (no dropout)"}
                del x, out, inv, want_out, want_inv, r, f32_out
            v16 = torch.randn(M, N, device=dev, generator=g).bfloat16()
            inv = 0.5 + 1.5 * torch.rand(M, device=dev, generator=g)
            rows = torch.randn(M, N, device=dev, generator=g)  # f32 pre-LN rows, the yardstick's
            mean_r = rows.mean(-1, keepdim=True)
            rstd_r = torch.rsqrt(rows.var(-1, unbiased=False, keepdim=True) + eps)
            for tag, v, gy_dtype in (("gy bf16", v16, torch.bfloat16),
                                     ("gy f32", v16, torch.float32),
                                     ("f32", v16.float(), torch.float32)):
                gy = torch.randn(M, N, device=dev, generator=g).to(gy_dtype)
                got = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
                torch.cuda.synchronize()
                want = layernorm_backward_reference(gy, v, inv, gamma, beta, keep)
                excess = max(_rel_max(got[0], want[0]) - LN_REL, _gemm_excess(got[1], want[1]),
                             *(_rel_max(a_, b_) - COLSUM_REL for a_, b_ in zip(got[2:], want[2:])))
                kept = torch.equal(got[1] != 0, keep != 0)  # dr is never 0 on these rows
                again = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
                same = all(torch.equal(a_, b_) for a_, b_ in zip(got[2:], again[2:]))
                if not all(_finite(t) for t in got) or excess > 0 or not same or not kept \
                        or got[2][N - 5].item() != 0.0:
                    _fail(f"wide layernorm_backward ({M},{N}) {tag} disagrees with its plain "
                          f"version (excess {excess:.3e}, keep bits {kept}) or its sums differ "
                          f"from run to run ({same})")
                err = max((a_.float() - b_.float()).abs().max().item() for a_, b_ in zip(got, want))
                k_ms, p_ms = paired(
                    lambda: layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate),
                    lambda: layernorm_backward_reference(
                        gy, v, inv, gamma, beta, hidden_keep(seed, OP_MLP_OUT, M, N, rate, dev)),
                    iters)
                gy32 = gy.float()
                lib_ms = lib_timer(lambda: torch.ops.aten.native_layer_norm_backward(
                    gy32, rows, (N,), mean_r, rstd_r, gamma, beta, (True, True, True)), iters)
                bound = _bound(0.0, _nbytes(gy, v, inv, gamma, beta, got), PEAK_F32)
                print(f"wide layernorm_backward ({M},{N}) v {str(v.dtype)[6:]}, {tag}, dropout "
                      f"{rate}{how}: {k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
                      f"{bound[0] / k_ms:.1%} of it), plain {p_ms:.4f} ms, "
                      f"aten.native_layer_norm_backward {lib_ms:.4f} ms, max abs {err:.3e}, keep "
                      f"bits exact, sums bit for bit twice ({names[0]}; nvidia-smi: {names[1]})")
                if (M, N) == WIDE_LN_TABLE:
                    res[f"ln_bwd_{tag.replace(' ', '_')}"] = {
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                        "library_ms": lib_ms,
                        "library": "aten.native_layer_norm_backward (f32 rows; no keep mask, "
                                   "no da)"}
                del gy, got, want, again, gy32
            del v16, inv, rows, mean_r, rstd_r, a, keep
            torch.cuda.empty_cache()
    return res


def _wide_attention(names: tuple[str, str], g, dtype) -> dict:
    """The attention past head_dim 128 (``csrc/attention_long.cu``'s
    128-column chunks; ``dtype`` bf16 or f32) through every entry at
    WIDE_HEADS x WIDE_SEQS (768 // head_dim heads, at least one): the layer's
    forward and backward (#1a, #3 / #4) self causal with a padded mask and
    cross over padded keys, #11 / #12 (the same), #13 causal with a padded
    mask and a fully masked sentence (its rows uniform over every key);
    dropout 0.1; each held to its plain version, the backward's two launches
    the same bits; the layer's self forward and backward timed in turns with
    their plain versions at every shape, beside the bound and
    ``F.scaled_dot_product_attention`` (flash in bf16 up to head_dim 256,
    memory-efficient otherwise), and every entry so at WIDE_ATTN_TABLE, the
    head_dim-192 step's shape, and at WIDE_ATTN_LONG (512 tokens); then #11 /
    #12 (self, cross) and #13 once through their autograd at both (their
    launches; with the times, the rows of the kernels line)."""
    import torch

    from kindergarten_vq_vae_torch.ops.attention import fused_mha, mha_forward, mha_reference
    from kindergarten_vq_vae_torch.ops.dropout import cross_op
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_backward_reference,
        attention_forward,
        attention_forward_reference,
    )
    from kindergarten_vq_vae_torch.ops.sdpa import (
        fused_sdpa,
        sdpa_backward,
        sdpa_backward_reference,
        sdpa_forward,
        sdpa_forward_reference,
    )

    f32 = dtype == torch.float32
    tag, peak = ("f32", PEAK_3XTF32) if f32 else ("bf16", PEAK_BF16)
    fwd_tol, bwd_tol = (F32_FWD, F32_GRAD) if f32 else (TRAIN_REL, TRAIN_REL)
    seed = int(torch.randint(-2**31, 2**31 - 1, (1,), generator=g, device="cuda"))
    res = {}

    def held(what, got, want, tol):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(_rel_max(a, b) for a, b in zip(got, want))
        if err > tol or not all(_finite(a) and a.dtype == dtype and a.shape == b.shape
                                for a, b in zip(got, want)):
            _fail(f"wide attention ({tag}): {what} disagrees with its plain version "
                  f"(max rel {err:.3e}, tol {tol})")
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    for hd in WIDE_HEADS:
        NH = max(1, 768 // hd)
        H = NH * hd
        for S, B in WIDE_SEQS:
            sfx = {WIDE_ATTN_TABLE: "", WIDE_ATTN_LONG: "_512"}.get((hd, S))
            table = sfx is not None
            line = []
            for cross in (False, True):
                kind, causal = ("cross", False) if cross else ("self", True)
                op = cross_op(NH) if cross else 0
                if cross:
                    packed = torch.randn(B, S, H, device="cuda", generator=g).to(dtype)
                    kv = torch.randn(B, S, 2 * H, device="cuda", generator=g).to(dtype)
                    q, (k, v) = packed, kv.split(H, -1)
                else:
                    packed = torch.randn(B, S, 3 * H, device="cuda", generator=g).to(dtype)
                    kv = None
                    q, k, v = packed.split(H, -1)
                lens = torch.randint(1, S + 1, (B,), device="cuda", generator=g)
                mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).to(torch.int32)
                mask[1] = 0  # a fully masked sentence
                gr = torch.randn(B, S, H, device="cuda", generator=g).to(dtype)
                la = (packed, kv, mask, NH, causal, seed, op, 0.1)
                lb = (packed, kv, mask, gr, NH, causal, seed, op, 0.1)
                sa, skw = (q, k, v, mask, seed), dict(num_heads=NH, causal=causal, rate=0.1)
                with torch.no_grad():
                    errs = {
                        "fwd": held(f"attention_forward {kind} hd {hd} at {S}",
                                    attention_forward(*la), attention_forward_reference(*la),
                                    fwd_tol),
                        "bwd": held(f"attention_backward {kind} hd {hd} at {S}",
                                    attention_backward(*lb), attention_backward_reference(*lb),
                                    bwd_tol),
                        "sdpa_fwd": held(f"sdpa_forward {kind} hd {hd} at {S}",
                                         sdpa_forward(*sa, cross=cross, **skw),
                                         sdpa_forward_reference(*sa, **skw), fwd_tol),
                        "sdpa_bwd": held(f"sdpa_backward {kind} hd {hd} at {S}",
                                         sdpa_backward(*sa, gr, cross=cross, **skw),
                                         sdpa_backward_reference(*sa, gr, **skw), bwd_tol)}
                    if not cross:
                        out = mha_forward(q, k, v, mask, NH, causal)
                        errs["mha"] = held(f"mha_forward hd {hd} at {S}", out,
                                           mha_reference(q, k, v, mask, NH, causal), fwd_tol)
                        uniform = _rel_max(out[1], v[1].float().mean(0).expand(S, H))
                        if uniform > fwd_tol:
                            _fail(f"wide attention ({tag}): #13's fully masked sentence is not "
                                  f"uniform over its keys (hd {hd} at {S}: {uniform:.3e})")
                    one, two = attention_backward(*lb), attention_backward(*lb)
                    one, two = (one, two) if cross else ((one,), (two,))
                    if not all(torch.equal(x, y) for x, y in zip(one, two)):
                        _fail(f"wide attention ({tag}): two launches of attention_backward "
                              f"{kind} hd {hd} at {S} differ")
                    del one, two
                timed = ("fwd", "bwd") if not cross or table else ()
                if table:
                    timed += ("sdpa_fwd", "sdpa_bwd") + (() if cross else ("mha",))
                if timed:
                    iters = 10 if table else 3
                    calls = {
                        "fwd": (lambda: attention_forward(*la),
                                lambda: attention_forward_reference(*la)),
                        "bwd": (lambda: attention_backward(*lb),
                                lambda: attention_backward_reference(*lb)),
                        "sdpa_fwd": (lambda: sdpa_forward(*sa, cross=cross, **skw),
                                     lambda: sdpa_forward_reference(*sa, **skw)),
                        "sdpa_bwd": (lambda: sdpa_backward(*sa, gr, cross=cross, **skw),
                                     lambda: sdpa_backward_reference(*sa, gr, **skw)),
                        "mha": (lambda: mha_forward(q, k, v, mask, NH, causal),
                                lambda: mha_reference(q, k, v, mask, NH, causal))}
                    lib_fwd, lib_bwd, backend = _library_sdpa(q, k, v, mask, causal, pin=True,
                                                              nh=NH)
                    products = B * NH * S * S * hd
                    bf = _bound(4 * products, _nbytes(q, k, v, mask, gr), peak)
                    bb = _bound(10 * products, _nbytes(q, k, v, mask, gr, q, k, v), peak)
                    with torch.no_grad():
                        lf = _time_ms(lib_fwd, iters)
                        ms = {key: _paired_ms(*calls[key], iters) for key in timed}
                    lb_ms = _time_ms(lib_bwd, iters)
                    for key, (k_ms, p_ms) in ms.items():
                        bwd = key.endswith("bwd")
                        b_ = bb if bwd else bf
                        line.append(f"{key} {kind} {k_ms:.4f} ms (plain {p_ms:.4f}, bound "
                                    f"{b_[0]:.4f} {b_[1]}, {b_[0] / k_ms:.1%})")
                        if table:
                            res[f"{key}_{kind}{sfx}"] = {
                                "max_abs_err": errs[key], "ms": k_ms, "plain_ms": p_ms,
                                "bound": [b_], "library_ms": lb_ms if bwd else lf,
                                "library": ("autograd backward of " if bwd else "")
                                + f"F.scaled_dot_product_attention, {tag}, backend {backend} "
                                  "(rate 0, head transposes)"}
                    line.append(f"SDPA {backend} {kind} fwd {lf:.4f} / bwd {lb_ms:.4f} ms")
                    del lib_fwd, lib_bwd
                del packed, kv, q, k, v, gr, mask
            print(f"wide attention {tag} hd {hd} x {NH} heads, ({B},{S}) self causal padded / "
                  f"cross over padded keys, dropout 0.1: every entry held, backward bits twice; "
                  + "; ".join(line) + f" ({names[0]}; nvidia-smi: {names[1]})")
            torch.cuda.empty_cache()

    # #11 / #12 (self causal, then cross) and #13 through their autograd at
    # the table's head_dim, at 12 and at 512 tokens: their launches, each a
    # wide one
    for (hd, S), B, sfx in ((WIDE_ATTN_TABLE, 8, ""), (WIDE_ATTN_LONG, 2, "_512")):
        NH = 768 // hd
        leaves = [torch.randn(B, S, NH * hd, device="cuda", generator=g).to(dtype)
                  .requires_grad_() for _ in range(3)]
        _reset_counters()
        fused_sdpa(*leaves, None, seed, NH, True, 0.1).float().sum().backward()
        fused_sdpa(*leaves, None, seed, NH, False, 0.1, cross=True).float().sum().backward()
        fused_mha(*leaves, None, NH, True).float().sum().backward()
        torch.cuda.synchronize()
        counts = _counters()
        sdpa_keys = [f"sdpa_{d}_{kind}" for d in ("fwd", "bwd") for kind in ("self", "cross")]
        res[f"sdpa_launches{sfx}"] = {k_: counts[k_] for k_ in sdpa_keys}
        res[f"mha_launches{sfx}"] = counts["mha"]
        wide = {k_: counts[f"{k_}_wide"] for k_ in ("sdpa_fwd", "sdpa_bwd", "mha")}
        print(f"wide attention {tag}: fused_sdpa (self, cross) and fused_mha through their "
              f"autograd at ({B},{S},{NH * hd}), head_dim {hd}: launches "
              f"{res[f'sdpa_launches{sfx}']}, mha {counts['mha']}, wide {wide}")
        if res[f"sdpa_launches{sfx}"] != dict.fromkeys(sdpa_keys, 1) or counts["mha"] != 1 \
                or wide != {"sdpa_fwd": 2, "sdpa_bwd": 2, "mha": 1}:
            _fail(f"wide attention ({tag}): the autograd runs at {S} tokens did not launch the "
                  "wide kernels once")
        del leaves
        torch.cuda.empty_cache()
    return res


def phase_wide(names: tuple[str, str]) -> dict:
    """Every hidden width and head size the JAX package runs (phase 21): the
    wide LayerNorm kernels and the wide-head attention alone
    (``_wide_layernorm``, ``_wide_attention`` in bf16 and f32); then the
    training steps through the default ("auto") route, dropout 0.1 / 0.1,
    seeded weights, WIDE_STEPS steps each, every plain version of the route
    refused and every launch counted (the wide shares among them): the
    Shelgon3-VQ with the GPT-2 decoder at gpt2-large's published widths and
    the BERT encoder at the same width and depth (bf16, batch WIDE_BATCH x
    12); the BERT-decoder twin at those widths, 4 + 4 layers (bf16 at batch
    WIDE_BATCH, f32 at WIDE_F32_BATCH); bert-base with 4 heads (head_dim
    192): bf16 at batch 2048 x 12, bf16 at WIDE_BATCH x 64 tokens, f32 at
    WIDE_F32_BATCH x 12."""
    import torch

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    res = {"ln": _wide_layernorm(names, g)}
    res["attn"] = _wide_attention(names, g, torch.bfloat16)
    res["attn_f32"] = _wide_attention(names, g, torch.float32)
    t1 = time.perf_counter()
    large = dict(GPT2_LARGE, decoder_model_name="gpt2", decoder_vocab_size=GPT2_VOCAB)
    res["train_large"] = phase_train(names, steps=WIDE_STEPS, batch=WIDE_BATCH, over=large)
    twin = dict(GPT2_LARGE, num_layers=4)
    res["train_twin"] = phase_train(names, steps=WIDE_STEPS, batch=WIDE_BATCH, over=twin)
    res["train_twin_f32"] = phase_train(names, steps=WIDE_STEPS, batch=WIDE_F32_BATCH,
                                        dtype="float32", over=twin)
    heads = {"num_heads": 4}
    res["train_hd"] = phase_train(names, steps=WIDE_STEPS, over=heads)
    res["train_hd_seq"] = phase_train(names, steps=WIDE_STEPS, batch=WIDE_BATCH, seq=LONG_SEQ,
                                      over=heads)
    res["train_hd_f32"] = phase_train(names, steps=WIDE_STEPS, batch=WIDE_F32_BATCH,
                                      dtype="float32", over=heads)
    t2 = time.perf_counter()
    print(f"wide: kernels alone {t1 - t0:.1f} s, steps {t2 - t1:.1f} s; step medians: "
          + ", ".join(f"{k} {res[k]['median_ms']:.2f} ms ({res[k]['peak_gib']:.2f} GiB)"
                      for k in res if k.startswith("train"))
          + f" ({names[0]}; nvidia-smi: {names[1]})")
    return res


def _train_cfg():
    from kindergarten_vq_vae_torch.config import RunConfig

    # the JAX engine's defaults: dropout 0.1 / 0.1, AMSGrad lr 1e-4, streaming CE
    return RunConfig(model_name="shelgon3", vocab_size=VOCAB, hidden_size=768, num_layers=12,
                     num_heads=12, intermediate_size=3072, compute_dtype="bfloat16", vq_n_e=9,
                     vq_e_dim=768, tokenized_sentence_max_length=SEQ)


def _train_batch(batch: int, seq: int = SEQ) -> dict:
    """bench.py's batch: uniform ids in [1, vocab), no padding, from the seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(1, VOCAB, (batch, seq))).cuda()
    return {"input_ids": ids, "attention_mask": torch.ones_like(ids, dtype=torch.int32),
            "n_valid": batch}


class _plain_refused:
    """Within the block, the plain versions of the update (the single-pass
    one of ``ops/adam.py`` and the per-leaf ``train/optim.Adam``), of the
    SDPA kernels, of the layer's LayerNorm and column-sum kernels and of the
    codebook gradient raise: on the card the step's update is kernel #14
    alone, the per-module trunk's attention #11 / #12 alone, the fused
    layers' LayerNorms those of ``csrc/layernorm.cu`` and the codebook's
    gradient ``csrc/vq_bwd.cu``'s. With ``default_route`` (every training
    step, the f32 runs), also those of the layer GEMM, the layer forward and backward, the
    attention, the CE and the fused head + CE."""

    def __init__(self, default_route: bool = False):
        self.default_route = default_route

    def _targets(self):
        from kindergarten_vq_vae_torch.ops import adam, ce, gemm, head_ce, layer, sdpa, vq
        from kindergarten_vq_vae_torch.train import optim

        route = ((gemm, "gemm_reference"), (layer, "layer_forward_reference"),
                 (layer, "layer_backward_reference"), (layer, "bert_layer_reference"),
                 (layer, "attention_forward_reference"), (layer, "attention_backward_reference"),
                 (ce, "ce_fwd_ids_reference"), (ce, "ce_fwd_reference"),
                 (ce, "ce_bwd_reference"), (head_ce, "head_ce_fwd_reference"),
                 (head_ce, "head_ce_bwd_reference"), (head_ce, "table_grad_reference"),
                 ) if self.default_route else ()
        return ((optim, "adam_update_reference"), (adam, "adam_update_reference"),
                (optim.Adam, "update"), (sdpa, "sdpa_forward_reference"),
                (sdpa, "sdpa_backward_reference"), (layer, "residual_layernorm_reference"),
                (layer, "layernorm_backward_reference"), (layer, "column_sums_reference"),
                (vq, "codebook_grad_reference"), *route)

    def __enter__(self):
        def refuse(*args, **kwargs):
            _fail("a plain version ran on a kernel path")

        self.saved = [(obj, name, getattr(obj, name)) for obj, name in self._targets()]
        for obj, name, _ in self.saved:
            setattr(obj, name, refuse)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def phase_train(names: tuple[str, str], head_ce: str = "auto", steps: int = TRAIN_STEPS,
                fused_layer: str = "auto", dtype: str = "bfloat16", batch: int = TRAIN_BATCH,
                seq: int = SEQ, over: dict | None = None) -> dict:
    """The training slice (``head_ce``: its ``fused_head_ce``; ``fused_layer``
    "off": the per-module trunk; ``dtype`` its compute dtype, "float32" the
    f32 instances; ``batch`` sentences of ``seq`` tokens; ``over``: other
    run-config fields), with every plain version of the route refused;
    returns the kernels' launch counts over its steps and its losses."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(_train_cfg(), fused_head_ce=head_ce, fused_layer=fused_layer,
                              compute_dtype=dtype, tokenized_sentence_max_length=seq,
                              **(over or {}))
    fused, f32 = head_ce in HEAD_MODES, dtype == "float32"
    gpt2, L = "gpt" in cfg.decoder_model_name, cfg.num_layers
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda", fused_head=fused)
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    sents, batch = batch, _gpt2_batch(batch, seq) if gpt2 else _train_batch(batch, seq)
    n_params = sum(p.numel() for p in model.parameters())
    # per step (L layers each side): 2 L layer forwards (keeping residuals) and
    # backwards, with 2 L self- and L cross-attention backwards inside them, or
    # on the per-module trunk 2 L self- and L cross-attention SDPA forwards and
    # backwards (with the GPT-2 decoder, plain PyTorch as XLA in JAX, the
    # encoder's L alone); one VQ; the CE forward and backward (#7, #8) or, with
    # the fused head, #9, #10 and the table gradient; one AMSGrad update over
    # every leaf
    per_step = {k: 0 for k in _counters()}
    per_step.update(vq=1, codebook_grad=1, adam=1)
    if fused_layer == "off":
        per_step.update(sdpa_fwd_self=2 * L, sdpa_fwd_cross=L, sdpa_bwd_self=2 * L,
                        sdpa_bwd_cross=L)
    elif gpt2:
        per_step.update(layer_fwd=L, layer_fwd_resid=L, layer_bwd=L, attn_bwd_self=L,
                        **_inside_layers(0, encoder_forwards=1, encoder_backwards=1, layers=L))
    else:
        per_step.update(layer_fwd=2 * L, layer_fwd_resid=2 * L, layer_bwd=2 * L,
                        attn_bwd_self=2 * L, attn_bwd_cross=L, **_inside_layers(1, 1, layers=L))
    per_step.update({"head_ce_fwd": 1, "head_ce_bwd": 1, "table_grad": 1} if fused
                    else {"ce_fwd_ids": 1, "ce_bwd": 1})
    per_step = _as_wide(per_step, cfg.hidden_size > 1024,
                        cfg.hidden_size // cfg.num_heads > 128)
    if f32:
        per_step = _as_f32(per_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with _plain_refused(default_route=True):
        _reset_counters()
        for i in range(steps):
            before = _counters()
            t0 = time.perf_counter()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = _counters()
            delta = {k: after[k] - before[k] for k in after}
            if delta != per_step:
                _fail(f"train step {i} ({head_ce}, fused_layer {fused_layer}) launched {delta}, "
                      f"expected {per_step}")
            losses.append({k: float(aux[k]) for k in ("loss_full", "loss_recon", "loss_vq",
                                                       "metric_perp", "metric_acc")})
        counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    what = (f"fused_head_ce {head_ce!r}, fused_layer {fused_layer!r}, {dtype}"
            + "".join(f", {k} {v}" for k, v in (over or {}).items()))
    width = (f"H {cfg.hidden_size}, {cfg.num_heads} heads of {cfg.hidden_size // cfg.num_heads}, "
             f"{L} + {L} layers, {'GPT-2' if gpt2 else 'BERT'} decoder")
    print(f"train slice ({what}): shelgon3-VQ ({width}), {n_params} parameters, "
          f"batch {sents} x {seq}, dropout 0.1/0.1, AMSGrad lr 1e-4, {steps} steps; "
          f"launches per step {per_step}, total {counts}")
    for i, (loss, dt) in enumerate(zip(losses, times)):
        print(f"  step {i}: {json.dumps(loss)} {dt * 1e3:.1f} ms")
    full = [loss["loss_full"] for loss in losses]
    if not all(math.isfinite(v) for v in full) or full[-1] >= full[0]:
        _fail(f"train loss not finite or not falling: {full}")
    if state.step != steps:
        _fail(f"train state counted {state.step} steps")
    print(f"train step ({what}, batch {sents} x {seq}): median {med * 1e3:.1f} ms over steps "
          f"1-{steps - 1}, {sents / med:.1f} sentences/s, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({names[0]}; nvidia-smi: {names[1]})")
    del state, model, step, aux
    torch.cuda.empty_cache()
    return {"counts": counts, "losses": losses, "median_ms": med * 1e3, "peak_gib": peak / 2**30}


def phase_grads() -> None:
    """Batch-256 gradients of the kernel path, of the plain bf16 path and of
    the fused-head kernel paths (store, flash), each against an f32 plain
    step (logits path) of the same weights, dropout seeds and batch; then the
    per-module trunk's (``fused_layer`` "off") kernel path and plain bf16
    path against an f32 plain per-module step under the same generator seed
    (its hidden and embedding dropout masks come from the generator)."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.variants import make_loss_fn

    cfg = _train_cfg()
    batch = _train_batch(GRAD_BATCH)
    model = build_model(cfg, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))

    def copy(fused_head=False, **changes):
        m = build_model(dataclasses.replace(cfg, **changes), device="cuda", fused_head=fused_head)
        m.load_state_dict(model.state_dict())
        return m

    def grads(m, reference, head_ce="auto"):
        for p in m.parameters():
            p.grad = None
        loss, _ = make_loss_fn(dataclasses.replace(cfg, fused_head_ce=head_ce), "train",
                               reference=reference)(
            m, batch, torch.Generator(device="cuda").manual_seed(SEED + 2), False)
        loss.backward()
        return {n: p.grad.float() for n, p in m.named_parameters() if p.grad is not None}

    def compare(ref, paths, plain, kernel_paths):
        stats = {}
        for path, m, reference, head_ce in paths:
            got = grads(m, reference, head_ce)
            if got.keys() != ref.keys():
                _fail(f"{path} path: gradients reach other leaves than the f32 step")
            num = sum(((got[n] - ref[n]) ** 2).sum().item() for n in ref)
            den = sum((ref[n] ** 2).sum().item() for n in ref)
            leaf = {n: ((got[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref
                    if ref[n].norm() > 0}
            worst = max(leaf, key=leaf.get)
            finite = all(_finite(v) for v in got.values())
            stats[path] = {"global_rel_l2": (num / den) ** 0.5, "worst_leaf_rel_l2": leaf[worst],
                           "worst_leaf": worst, "finite": finite}
        print(f"gradients at batch {GRAD_BATCH} vs an f32 plain step ({len(ref)} leaves): "
              f"{json.dumps(stats)}")
        for path in kernel_paths:
            for what in ("global_rel_l2", "worst_leaf_rel_l2"):
                if not stats[path]["finite"] or stats[path][what] > PATH_SLACK * stats[plain][what]:
                    _fail(f"{path} path: gradients further from f32 than the plain bf16 path "
                          f"({what})")

    fused = copy(fused_head=True)
    compare(grads(copy(compute_dtype="float32"), True),
            (("kernel", model, False, "auto"), ("plain", model, True, "auto"),
             ("kernel, fused head store", fused, False, "store"),
             ("kernel, fused head flash", fused, False, "flash")),
            "plain", ("kernel", "kernel, fused head store", "kernel, fused head flash"))
    del fused
    per_module = copy(fused_layer="off")
    compare(grads(copy(fused_layer="off", compute_dtype="float32"), True),
            (("per-module kernel", per_module, False, "auto"),
             ("per-module plain", per_module, True, "auto")),
            "per-module plain", ("per-module kernel",))
    del model, per_module
    torch.cuda.empty_cache()


def phase_engine(names: tuple[str, str], head_ce: str = "auto",
                 epochs: int = ENGINE_EPOCHS, fused_layer: str = "auto",
                 dtype: str = "bfloat16") -> dict:
    """The training entry point: the CLI on a generated corpus (``--set
    fused_head_ce`` when ``head_ce`` is not "auto", ``--set fused_layer``
    when ``fused_layer`` is not, ``--set compute_dtype`` when ``dtype`` is
    not "bfloat16"), its run directory, its launch counts, and the run
    directory served (through the logits path, on the run's trunk); an f32
    run's served outputs are also held to the plain route's."""
    import numpy as np
    import torch

    from kindergarten_vq_vae_torch import cli
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, read_checkpoint
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    with tempfile.TemporaryDirectory(prefix="kvq_chip_engine_") as root:
        data_dir, runs_dir = os.path.join(root, "data"), os.path.join(root, "runs")
        t0 = time.perf_counter()
        generate_dsentences(data_dir, **ENGINE_CUT)
        n = len(prepare_all(data_dir, max_length=SEQ)["sentences_clean"])
        t_data = time.perf_counter() - t0
        # the JAX package's defaults are the full-width bf16 Shelgon3-VQ run
        # (dropout 0.1 / 0.1, AMSGrad lr 1e-4, fused_update "auto")
        sets = {"n_epochs": epochs, "batch_size": TRAIN_BATCH, "data_dir": data_dir,
                "runs_dir": runs_dir, "tokenized_sentence_max_length": SEQ,
                "lim_batches_train_pct": ENGINE_TRAIN_PCT, "ckpt_every_n_epochs": 0,
                "ckpt_slots": ("loss_recon:val",), "seed": SEED}
        if head_ce != "auto":
            sets["fused_head_ce"] = head_ce
        if fused_layer != "auto":
            sets["fused_layer"] = fused_layer
        f32 = dtype == "float32"
        if f32:
            sets["compute_dtype"] = dtype
        argv = ["shelgon3", "--device", "cuda"]
        for k, v in sets.items():
            argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
        n_train, n_val = int(n * 0.6), int(n * 0.2)
        steps = epochs * int(n_train // TRAIN_BATCH * ENGINE_TRAIN_PCT)
        evals = epochs * -(-n_val // TRAIN_BATCH) + -(-(n - n_train - n_val) // TRAIN_BATCH)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _plain_refused(default_route=f32):
            _reset_counters()
            t0 = time.perf_counter()
            engine = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counters()
            if f32 and (torch.get_float32_matmul_precision() != "highest"
                        or torch.backends.cuda.matmul.allow_tf32):
                _fail("the f32 run's PyTorch matrix products are not full f32")
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: 0 for k in counts}
        want.update(vq=steps + evals, codebook_grad=steps, adam=steps)
        if fused_layer == "off":
            want.update(sdpa_fwd_self=24 * (steps + evals), sdpa_fwd_cross=12 * (steps + evals),
                        sdpa_bwd_self=24 * steps, sdpa_bwd_cross=12 * steps)
        else:
            want.update(layer_fwd=24 * (steps + evals), layer_fwd_resid=24 * steps,
                        layer_bwd=24 * steps, attn_bwd_self=24 * steps,
                        attn_bwd_cross=12 * steps, **_inside_layers(steps + evals, steps))
        if head_ce in HEAD_MODES:
            want.update(head_ce_fwd=steps + evals, head_ce_bwd=steps, table_grad=steps)
        else:
            want.update(ce_fwd_ids=steps + evals, ce_bwd=steps)
        if f32:
            want = _as_f32(want)
        print(f"engine: python -m kindergarten_vq_vae_torch.cli {' '.join(argv)}: {wall:.1f} s "
              f"(corpus of {n} sentences made in {t_data:.1f} s); {steps} train steps, {evals} "
              f"eval batches; max_memory_allocated {peak:.2f} GiB; launches {counts} (expected "
              f"{want})")
        if counts != want:
            _fail("the training entry point did not go through the kernels as expected")

        run = engine.run_path
        with open(os.path.join(run, "run_conf.json")) as f:
            conf = json.load(f)
        with open(os.path.join(run, "history.json")) as f:
            history = json.load(f)
        slot = os.path.join(run, best_ckpt_name("shelgon3", "loss_recon", "val"))
        tree = read_checkpoint(slot)
        files = sorted(os.listdir(run))
        print(f"engine run directory {os.path.basename(run)}: {files}")
        if not (conf["model_name"] == "shelgon3" and conf["hidden_size"] == 768
                and conf["num_layers"] == 12 and conf["vocab_size"] == VOCAB
                and conf["batch_size"] == TRAIN_BATCH and conf["run_id"] == os.path.basename(run)
                and conf["fused_head_ce"] == head_ce and conf["fused_layer"] == fused_layer
                and conf["compute_dtype"] == dtype):
            _fail(f"run_conf.json does not describe the run: {conf}")
        if tree["vector_quantizer"]["codebook"].shape != (9, 768):
            _fail("the best-val slot does not hold the model")
        if [sorted(h) for h in history] != ([["epoch", "train", "val"]] * epochs
                                            + [["epoch", "test"]]):
            _fail(f"history.json has other entries than the run's stages: {history}")
        stats = [h[stage] for h in history for stage in ("train", "val", "test") if stage in h]
        keys = ("loss_recon", "loss_vq", "loss_full", "metric_acc", "metric_perp")
        if not all(math.isfinite(st[k]) for st in stats for k in keys):
            _fail("the run's stats are not finite")
        if history[-1]["test"]["n_els"] != n - n_train - n_val:
            _fail("the test stage did not cover the test split")
        for h in history:
            for stage, st in h.items():
                if stage != "epoch":
                    print(f"  epoch {h['epoch']} {stage}: loss_recon {st['loss_recon']:.4f} "
                          f"loss_vq {st['loss_vq']:.4f} acc {st['metric_acc']:.2f}% perp "
                          f"{st['metric_perp']:.3f}, {st['sentences_per_sec']:.1f} sentences/s "
                          f"(steady state), stage wall {st['stage_wall_s']:.2f} s over "
                          f"{st['n_els']} sentences")

        rng = np.random.default_rng(SEED)
        sentences = [engine.splits["test"].sentences[i] for i in rng.choice(n - n_train - n_val, 5)]
        bucket = engine.splits["test"].sentences[:BUCKET]
        del engine
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        _reset_counters()
        recon = rec.reconstruct(sentences)
        codes = rec.codes(sentences)
        served = _counters()
        want_served = {k: 0 for k in served}
        want_served["vq"] = 2  # two forwards: /reconstruct and /codes
        want_served.update(dict(sdpa_fwd_self=48, sdpa_fwd_cross=24) if fused_layer == "off"
                           else dict(layer_fwd=48, **_inside_layers(2)))
        if f32:
            want_served = _as_f32(want_served)
        if ([r["input"] for r in recon] != sentences or [r["codes"] for r in recon] != codes
                or not all(0.0 <= r["token_acc"] <= 1.0 and all(0 <= c < 9 for c in r["codes"])
                           for r in recon)
                or served != want_served or rec.model.decoder.mlm_head.cfg.fused_head):
            _fail(f"serving the trained run failed: {recon} {served}")
        what = f"fused_head_ce {head_ce!r}, fused_layer {fused_layer!r}, {dtype}"
        print(f"engine run ({what}) served through Reconstructor (logits path, launches "
              f"{served}): {recon[0]}")
        if f32:  # the served forward against the plain route's, at bucket 256
            ids, mask = (torch.from_numpy(a).cuda()
                         for a in rec.tokenizer.encode_batch(bucket, SEQ))
            with torch.no_grad():
                got, want = rec.forward(ids, mask), rec.forward(ids, mask, reference=True)
            same = [(a == b).float().mean().item() for a, b in zip(got, want)]
            print(f"engine run ({what}) served at bucket {BUCKET}: reconstruction ids and codes "
                  f"equal to the plain route's on {same[0]:.5f} / {same[1]:.5f} of the tokens "
                  f"(bar {F32_SERVE_SAME})")
            if min(same) < F32_SERVE_SAME:
                _fail("the f32 run served through the kernels disagrees with the plain route")
            # the research path's entry points take the f32 run on the card
            from kindergarten_vq_vae_torch.analyses.common import load_run
            from kindergarten_vq_vae_torch.train import codebook_init

            cfg_r, model_r = load_run(run, device="cuda")
            ids_np, mask_np = (t.cpu().numpy() for t in (ids, mask))
            with torch.no_grad():
                logits = model_r(ids, mask, is_training=False,
                                 generator=torch.Generator(device="cuda").manual_seed(0))["logits"]
            _reset_counters()
            z = codebook_init.encode_rows(codebook_init.bagon_encoder(cfg_r, device="cuda"),
                                          ids_np, mask_np)
            torch.cuda.synchronize()
            enc_counts = _counters()
            print(f"f32 run through analyses.common.load_run: argmax equal to the served ids "
                  f"{torch.equal(logits.argmax(-1), got[0])}; codebook_init.encode_rows over "
                  f"{len(bucket)} sentences: {tuple(z.shape)} {z.dtype}, launches "
                  f"{ {k: v for k, v in enc_counts.items() if v} }")
            encoder = "sdpa_fwd_self" if fused_layer == "off" else "layer_fwd"
            if not (torch.equal(logits.argmax(-1), got[0]) and z.dtype == torch.float32
                    and _finite(z) and enc_counts[encoder] == 12
                    and enc_counts == _as_f32(enc_counts)):
                _fail("load_run or the codebook init's encoder failed on the f32 run")
            del model_r, logits, z
        train = [h["train"] for h in history if "train" in h]
        print(f"engine ({what}): train "
              f"{statistics.mean(t['sentences_per_sec'] for t in train):.1f} "
              f"sentences/s (steady state, mean of {len(train)} epochs), stage wall times "
              f"{[round(st['stage_wall_s'], 3) for st in stats]} s ({names[0]}; nvidia-smi: "
              f"{names[1]})")
    del rec
    torch.cuda.empty_cache()
    return {**counts, "peak_gib": peak} if f32 else counts


# research path: the flagship pipeline's --lim-batches (train / val / test
# batches kept per epoch), its --dec-perturb, and the k-means step checks:
# a row's card assignment is held to the f64 one where the f64 margin
# between its two nearest centroids exceeds KMEANS_TIE times
# (|zc| + max |c - mean|)^2 (a bound on the bf16 error of the card's
# distances: ~6 roundings of 2^-8 each, on either of two distances), and
# each card centroid to the f64 mean of the rows the card assigned it within
# KMEANS_REL of its largest element (sums, counts and quotient each rounded
# to bf16: 3 x 2^-9), at the Lloyd steps KMEANS_HOST_STEPS (each host step
# reads the 1.6 GB of f64 rows twice). Latents vs Reconstructor.encode
# within one bf16 ulp at 1 (the pooler's tanh range). An attention map's
# rows sum to 1 within 2^-8: each bf16 probability is rounded by at most
# 2^-8 of itself, so a row of them sums to 1 within 2^-8 (measured 1.25e-3
# on an H100 80GB HBM3 at 700 W, over 1,024 sentences).
RESEARCH_LIM, RESEARCH_PERTURB = 0.1, 0.5
KMEANS_TIE, KMEANS_REL, KMEANS_HOST_STEPS = 12 * 2.0 ** -8, 2.0 ** -6, (0, 1, 24)
LATENT_ABS, ATTN_ROW_ABS = 2.0 ** -7, 2.0 ** -8


def _run_counts(counts: dict, steps: int, evals: int, vq: bool) -> dict:
    """The launches of ``steps`` training steps and ``evals`` eval batches of
    the default route (fused layers, logits path, AMSGrad #14)."""
    want = {k: 0 for k in counts}
    want.update(layer_fwd=24 * (steps + evals), layer_fwd_resid=24 * steps, layer_bwd=24 * steps,
                attn_bwd_self=24 * steps, attn_bwd_cross=12 * steps,
                **_inside_layers(steps + evals, steps), ce_fwd_ids=steps + evals, ce_bwd=steps,
                adam=steps, vq=(steps + evals) if vq else 0, codebook_grad=steps if vq else 0)
    return want


def _expect(what: str, counts: dict, want: dict) -> None:
    print(f"  {what}: launches {counts}")
    if counts != want:
        _fail(f"{what} did not go through the kernels as expected: {counts}, expected {want}")


def _kmeans_against_host(z, init_idx, cb_file) -> None:
    """The card's k-means on ``z`` (bf16, on the card) from ``init_idx``,
    Lloyd step by Lloyd step (``ops.vq.lloyd_step``), the steps
    ``KMEANS_HOST_STEPS`` held against the same step in f64 on the host from
    the card's centroids; the 25 chained steps give the stage's ``.npy`` bit
    for bit."""
    import numpy as np

    from kindergarten_vq_vae_torch.ops.vq import lloyd_step

    t0 = time.perf_counter()
    z64 = z.float().cpu().numpy().astype(np.float64)
    mean64 = z64.mean(0)
    zc64 = z64 - mean64
    zsq = (zc64 * zc64).sum(1)
    rows, n_e = len(z64), len(init_idx)
    gmean = z.mean(0, keepdim=True)
    zc = z - gmean
    cent = z[init_idx.to(z.device)]
    shares, worst = [], 0.0
    for it in range(25):
        new, assign = lloyd_step(z, zc, gmean, cent)
        if it not in KMEANS_HOST_STEPS:
            cent = new
            continue
        c64 = cent.double().cpu().numpy()
        cc64 = c64 - mean64
        d = zsq[:, None] + (cc64 * cc64).sum(1) - 2.0 * zc64 @ cc64.T
        two = np.sort(d, 1)[:, :2]
        bound = KMEANS_TIE * (np.sqrt(zsq) + np.sqrt((cc64 * cc64).sum(1)).max()) ** 2
        far = two[:, 1] - two[:, 0] > bound
        a = assign.cpu().numpy()
        if (a[far] != d.argmin(1)[far]).any():
            _fail(f"k-means step {it}: {(a[far] != d.argmin(1)[far]).sum()} card assignments "
                  "differ from the f64 ones outside the near-tie band")
        onehot = np.zeros((rows, n_e))
        onehot[np.arange(rows), a] = 1.0
        counts = onehot.sum(0)
        host = np.where(counts[:, None] > 0, onehot.T @ z64 / np.maximum(counts, 1.0)[:, None], c64)
        err = (np.abs(new.double().cpu().numpy() - host).max(1) / np.abs(host).max(1)).max()
        worst = max(worst, float(err))
        if err > KMEANS_REL:
            _fail(f"k-means step {it}: a centroid differs from the f64 mean by {err:.3e} of its "
                  f"largest element (tol {KMEANS_REL:.3e})")
        shares.append(float(far.mean()))
        cent = new
    same = np.array_equal(cent.float().cpu().numpy(), cb_file)
    print(f"  k-means vs f64 host Lloyd, {rows} rows x {z.shape[1]} bf16, {n_e} codes, 25 steps, "
          f"steps {KMEANS_HOST_STEPS} on the host: assignments equal on "
          f"{min(shares):.4f}-{max(shares):.4f} of the rows a step (the "
          f"rest within the bf16 near-tie band), centroids within {worst:.3e} of their largest "
          f"element (tol {KMEANS_REL:.3e}); chained steps equal the stage's .npy bit for bit "
          f"{same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        _fail("the card's k-means is not the codebook stage 2 wrote")


def phase_research(names: tuple[str, str]) -> dict:
    """The research path at bert-base width on the cut corpus: the flagship
    pipeline's stages 1-4 as functions (one epoch each, batch 256), the
    k-means against an f64 host Lloyd, stage 3's starting codebook, the
    analyses on the stage-3 and stage-1 runs and ``scripts/eval_run_torch.py``;
    every step's launches checked. Returns the stages' wall times and rates."""
    import importlib.util

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.analyses import arithmetic, cross_attention, disentanglement
    from kindergarten_vq_vae_torch.analyses import latent_space
    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name
    from kindergarten_vq_vae_torch.data.dataset import BatchIterator
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.ops.vq import kmeans_init_indices
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
    from kindergarten_vq_vae_torch.train import codebook_init, flagship
    from kindergarten_vq_vae_torch.train.engine import Engine
    from kindergarten_vq_vae_torch.train.run import load_data

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kvq_chip_research_") as root:
        data_dir, runs = os.path.join(root, "data"), os.path.join(root, "runs")
        generate_dsentences(data_dir, **ENGINE_CUT)
        prepare_all(data_dir, max_length=SEQ)
        args = flagship.build_parser().parse_args(
            ["--bagon-epochs", "1", "--vq-epochs", "1", "--stage4-epochs", "1",
             "--lim-batches", str(RESEARCH_LIM), "--dec-perturb", str(RESEARCH_PERTURB),
             "--runs-dir", runs, "--data-dir", data_dir])
        cfg = flagship.base_cfg(args, "shelgon3", 1)
        splits, tok = load_data(cfg)
        n = {k: len(v) for k, v in splits.items()}
        b = args.batch

        def batches(split, drop_last=False):
            return len(BatchIterator(splits[split], b, drop_last=drop_last,
                                     lim_batches_pct=RESEARCH_LIM))

        steps, val, test = batches("train", True), batches("val"), batches("test")
        print(f"research path: bert-base, bf16, batch {b}, --lim-batches {RESEARCH_LIM}, "
              f"--dec-perturb {RESEARCH_PERTURB}, corpus {sum(n.values())} sentences {n}; "
              f"{steps} train steps, {val} val and {test} test batches a stage")
        summary: dict = {}

        def stage(fn, *fn_args):
            torch.cuda.empty_cache()
            _reset_counters()
            t0 = time.perf_counter()
            res = fn(*fn_args)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, _counters()

        def train_report(what, run_dir, wall):
            with open(os.path.join(run_dir, "history.json")) as f:
                hist = json.load(f)
            tr = hist[0]["train"]
            last = hist[-1]["test" if "test" in hist[-1] else "val"]
            keys = [k for k in ("loss_recon", "loss_vq", "metric_acc", "metric_perp") if k in last]
            if not all(math.isfinite(last[k]) for k in keys):
                _fail(f"{what}: stats not finite: {last}")
            print(f"  {what}: wall {wall:.3f} s, train {tr['sentences_per_sec']:.1f} sentences/s "
                  f"(steady state, {tr['n_els']} sentences), last eval "
                  f"{json.dumps({k: last[k] for k in keys})}")
            out[what] = {"wall_s": wall, "train_sentences_per_sec": tr["sentences_per_sec"]}

        with _plain_refused():
            # 1. stages 1-4 as functions
            bagon_dir, wall, counts = stage(flagship.stage1, args, summary)
            _expect("stage 1 (Bagon)", counts, _run_counts(counts, steps, val, vq=False))
            train_report("stage 1 (Bagon)", bagon_dir, wall)

            diag, wall, counts = stage(flagship.stage2, args, bagon_dir, summary)
            sweeps = -(-n["train"] // 2048)
            want = {k: 0 for k in counts}
            want.update(layer_fwd=12 * sweeps, **_inside_layers(0, encoder_forwards=sweeps))
            # 2. stage 2's launches: one encoder forward a batch of 2048 in the sweep
            _expect("stage 2 (k-means codebook init)", counts, want)
            print(f"  stage 2: wall {wall:.3f} s ({n['train'] / wall:.1f} sentences/s over the "
                  f"stage, {n['train']} train sentences, {sweeps} encoder batches of 2048); "
                  f"diagnostics {json.dumps(diag)}; separation gate (< 0.1, exit 3) fires "
                  f"{diag['separation_ratio'] < flagship.SEPARATION_FLOOR}, amplitude gate "
                  f"(< 2^-7, exit 4) fires {diag['amplitude_ratio'] < flagship.AMPLITUDE_FLOOR}")
            out["stage 2 (k-means codebook init)"] = {"wall_s": wall, "diagnostics": diag}
            cb_path = summary["codebook_init"]["path"]
            cb_file = np.load(cb_path)
            bagon_ckpt = os.path.join(bagon_dir, best_ckpt_name("bagon", "loss_recon", "val"))
            encoder = codebook_init.bagon_encoder(cfg, bagon_ckpt, device="cuda")
            z = codebook_init.encode_rows(encoder, splits["train"].input_ids,
                                          splits["train"].attention_mask)
            del encoder
            _kmeans_against_host(z, kmeans_init_indices(len(z), cfg.vq_n_e,
                                                         torch.Generator().manual_seed(0)),
                                 cb_file)
            del z

            # 3. stage 3 starts from the .npy: its model's codebook before the first step
            first = {}
            fit = Engine.fit

            def fit_recording(self, *a, **k):
                first.setdefault("codebook",
                                 self.model.vector_quantizer.codebook.detach().cpu().numpy().copy())
                return fit(self, *a, **k)

            Engine.fit = fit_recording
            try:
                vq_dir, wall, counts = stage(flagship.stage3, args, bagon_dir, summary)
            finally:
                Engine.fit = fit
            _expect("stage 3 (Shelgon3-VQ vq-ft)", counts, _run_counts(counts, steps, val, vq=True))
            train_report("stage 3 (Shelgon3-VQ vq-ft)", vq_dir, wall)
            print(f"  stage 3's codebook before its first step equals {cb_path} bit for bit: "
                  f"{np.array_equal(first.get('codebook'), cb_file)}")
            if not np.array_equal(first.get("codebook"), cb_file):
                _fail("stage 3 did not start from the codebook stage 2 wrote")

            _, wall, counts = stage(flagship.stage4, args, vq_dir, summary)
            _expect("stage 4 (decoder adaptation)", counts,
                    _run_counts(counts, steps, val + test, vq=True))
            train_report("stage 4 (decoder adaptation)", summary["shelgon3_stage4"]["run_dir"],
                         wall)

            # 4. disentanglement on the stage-3 run, its codes those of Reconstructor
            run_cfg, model = load_run(vq_dir, device="cuda")
            res_dir = os.path.join(root, "disentanglement")
            (seen, hist, code_words_got, metrics), wall, counts = stage(
                disentanglement.unsupervised_vq_disentanglement, run_cfg, model, splits, tok,
                res_dir)
            per = {k: min(len(v), max(1, int(-(-len(v) // 512) * 0.1)) * 512)
                   for k, v in splits.items()}
            fwd = sum(-(-r // 512) for r in per.values())
            want = {k: 0 for k in counts}
            want.update(layer_fwd=24 * fwd, vq=fwd, **_inside_layers(fwd))
            _expect(f"disentanglement ({per} rows, {fwd} forwards of 512)", counts, want)
            rec = Reconstructor(vq_dir, device="cuda")
            woi = {w: [] for w in disentanglement.WORDS_OF_INTEREST}
            code_words, populated, cols = {k: set() for k in range(run_cfg.vq_n_e)}, set(), []
            for split, rows in per.items():
                ds = splits[split]
                sents, ids = ds.sentences[:rows], ds.input_ids[:rows]
                if not np.array_equal(rec._tokenize(sents)[0], ids):
                    _fail("Reconstructor tokenizes the corpus into other ids")
                codes = np.zeros(ids.shape, np.int64)  # padding positions: masked out below
                for i, c in enumerate(rec.codes(sents)):
                    codes[i, :len(c)] = c
                disentanglement.tabulate_word_codes(codes, ids, sents, tok, woi, code_words,
                                                    populated)
                cols.append((codes, ds.attention_mask[:rows], ds.labels[:rows]))
            want = (sorted(populated),
                    {w: {k: v.count(k) for k in range(run_cfg.vq_n_e)} for w, v in woi.items()},
                    {k: sorted(v) for k, v in code_words.items()},
                    disentanglement.factor_code_metrics(
                        *(np.concatenate(c) for c in zip(*cols)), run_cfg.vq_n_e))
            same = ((seen, hist, code_words_got, metrics) == want
                    and sorted(os.listdir(res_dir)) == sorted(
                        ["dSentences_vq_vector_populated.txt", "dSentences_vq_factor_metrics.json",
                         "dSentences_words_of_interest_histograms.json",
                         "dSentences_vq_words_distrib.json"]))
            print(f"  disentanglement: {wall:.3f} s, populated codes {seen}, factor nmi "
                  f"{ {k: round(v['nmi'], 4) for k, v in metrics.items()} }; tables equal to "
                  f"those of Reconstructor.codes on the same sentences {same}")
            if not same:
                _fail("the disentanglement's codes are not Reconstructor.codes'")

            # 5. sentence latents vs Reconstructor.encode
            test_split = splits["test"]
            m = min(1024, len(test_split))
            lat, wall, counts = stage(latent_space.compute_sentence_latents, model,
                                      test_split.input_ids[:m], test_split.attention_mask[:m])
            want = {k: 0 for k in counts}
            fwd = -(-m // 512)
            want.update(layer_fwd=12 * fwd, **_inside_layers(0, encoder_forwards=fwd))
            _expect(f"sentence latents ({m} test sentences)", counts, want)
            enc = rec.encode(test_split.sentences[:m])
            err = float(np.abs(lat - enc).max())
            print(f"  sentence latents {lat.shape} vs Reconstructor.encode: max abs {err:.3e} "
                  f"(tol {LATENT_ABS:.3e}), {wall:.3f} s")
            if lat.shape != enc.shape or not np.isfinite(lat).all() or err > LATENT_ABS:
                _fail("compute_sentence_latents does not match Reconstructor.encode")

            # 6. cross- and self-attention maps
            maps, wall, counts = stage(cross_attention.extract_cross_attention,
                                       model, test_split.input_ids[:m],
                                       test_split.attention_mask[:m])
            fwd = -(-m // 256)
            want = {k: 0 for k in counts}
            want.update(layer_fwd=12 * fwd, vq=fwd, **_inside_layers(0, encoder_forwards=fwd))
            _expect(f"attention maps ({m} test sentences, {fwd} batches of 256)", counts, want)
            rows_err = max(float(np.abs(maps[k].sum(-1) - 1.0).max()) for k in maps)
            differ = float(np.abs(maps["cross_attns"] - maps["self_attns"]).max())
            print(f"  attention maps {maps['cross_attns'].shape}: finite "
                  f"{all(np.isfinite(v).all() for v in maps.values())}, rows sum to 1 within "
                  f"{rows_err:.3e} (tol {ATTN_ROW_ABS}), cross vs self differ by up to "
                  f"{differ:.3f}, {wall:.3f} s")
            shaped = all(v.shape == (12, 12, SEQ, SEQ) and np.isfinite(v).all()
                         for v in maps.values())
            if not shaped or rows_err > ATTN_ROW_ABS or differ == 0.0:
                _fail("the attention maps are not finite probabilities, or cross equals self")
            del model, rec
            torch.cuda.empty_cache()

            # 7. Bagon arithmetic with group A = group B: delta 0, shifted = base ids
            _, bagon = load_run(bagon_dir, device="cuda")
            group, _ = arithmetic._factor_groups(splits["train"], "verb_tense", "present", "past",
                                                 64)
            targets, _ = arithmetic._factor_groups(splits["val"], "verb_tense", "past", "present",
                                                   64)
            ar, wall, counts = stage(arithmetic.latent_arithmetic_bagon, bagon,
                                     group, group, targets, tok)
            want = {k: 0 for k in counts}
            want.update(layer_fwd=60, **_inside_layers(2, encoder_forwards=1))
            _expect("Bagon arithmetic (3 encoder, 2 decoder forwards)", counts, want)
            zero = not ar["delta"].any()
            same = np.array_equal(ar["shifted_recon_ids"], ar["base_recon_ids"])
            print(f"  Bagon arithmetic, A = B: delta zero {zero}, shifted ids = base ids {same}; "
                  f"{ar['base_recon'][0]!r}")
            if not (zero and same):
                _fail("latent arithmetic with A = B moved the latents or the reconstructions")
            del bagon
            torch.cuda.empty_cache()

            # 8. scripts/eval_run_torch.py on the stage-3 run
            spec = importlib.util.spec_from_file_location(
                "eval_run_torch", os.path.join(ROOT, "scripts", "eval_run_torch.py"))
            eval_run = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(eval_run)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):  # its JSON line, indented below
                stats, wall, counts = stage(eval_run.main, [vq_dir])
            evals = -(-n["test"] // b)
            want = {k: 0 for k in counts}
            want.update(layer_fwd=24 * evals, vq=evals, ce_fwd_ids=evals,
                        **_inside_layers(evals))
            _expect(f"eval_run_torch.py ({evals} test batches)", counts, want)
            if stats["n_els"] != n["test"] or not all(math.isfinite(v) for v in stats.values()):
                _fail(f"eval_run_torch.py: {stats}")
            print(f"  eval_run_torch.py on the stage-3 run: {wall:.3f} s, printed "
                  f"{printed.getvalue().strip()}")
    print(f"research path: {time.perf_counter() - t_phase:.1f} s; stages ({names[0]}; "
          f"nvidia-smi: {names[1]}): {json.dumps(out)}")
    return out


# phase 13, the other variants at bert-base width (12 + 12 layers, bf16,
# dropout 0.1 / 0.1): the config changes from the Shelgon3-VQ cell, and the
# training steps each takes at batch 2048 (the first held to the plain route)
VARIANTS = (("shelgon", {"model_name": "shelgon"}),
            ("shelgon2", {"model_name": "shelgon2", "mask_pct_train": 0.1}),
            ("shelgon3-gumbel", {"model_name": "shelgon3", "vq_mode": "GumbelQuantizer"}))
VARIANT_STEPS = 4


def _variant_batch(batch: int) -> dict:
    """``_train_batch`` with seeded 5- and 8-factor labels and their one-hots."""
    import numpy as np
    import torch

    out = _train_batch(batch)
    rng = np.random.default_rng(SEED + 1)
    for k, n in (("labels", 5), ("labels8", 8)):
        out[k] = torch.from_numpy(rng.integers(0, 3, (batch, n))).cuda()
        out[k.replace("labels", "one_hot")] = torch.nn.functional.one_hot(out[k], 3)
    return out


def _variant_grads(cfg, model, batch) -> dict:
    """Loss and gradients of the kernel route, the plain bf16 route and an
    f32 plain route on ``model``'s weights, the same batch and generator
    seed; the kernel route's gradients no further from the f32 ones than
    ``PATH_SLACK`` times the plain route's (phase 9's bar), leaf by leaf
    where the f32 gradient is more than rounding noise."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model
    from kindergarten_vq_vae_torch.train.variants import make_loss_fn

    def run(m, c, reference):
        for p in m.parameters():
            p.grad = None
        loss, _ = make_loss_fn(c, "train", reference=reference)(
            m, batch, torch.Generator(device="cuda").manual_seed(SEED + 2), False)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()
                             if p.grad is not None}

    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    f32 = build_model(f32_cfg, device="cuda")
    f32.load_state_dict(model.state_dict())
    _, ref = run(f32, f32_cfg, True)
    del f32
    # a leaf whose f32 gradient is rounding noise (Shelgon's proj_in_conv_bias:
    # its exact gradient is 0) has no relative error to speak of
    noise = 1e-6 * max(g.abs().max().item() for g in ref.values())
    out = {}
    for path, reference in (("plain", True), ("kernel", False)):
        loss, got = run(model, cfg, reference)
        if got.keys() != ref.keys():
            _fail(f"{cfg.model_name} {path} route: gradients reach other leaves than f32")
        num = sum(((got[n] - ref[n]) ** 2).sum().item() for n in ref)
        den = sum((ref[n] ** 2).sum().item() for n in ref)
        leaf = {n: ((got[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref
                if ref[n].abs().max() > noise}
        out[path] = {"loss": loss, "global_rel_l2": (num / den) ** 0.5,
                     "worst_leaf_rel_l2": max(leaf.values()),
                     "finite": all(_finite(v) for v in got.values())}
    for what in ("global_rel_l2", "worst_leaf_rel_l2"):
        if (not out["kernel"]["finite"]
                or out["kernel"][what] > PATH_SLACK * out["plain"][what]):
            _fail(f"{cfg.model_name}: kernel-route gradients further from f32 than the plain "
                  f"bf16 route's ({what}): {out}")
    for p in model.parameters():
        p.grad = None
    return out


def phase_variants(names: tuple[str, str], vq_step_ms: float) -> dict:
    """Shelgon, Shelgon2 and Shelgon3-Gumbel at bert-base width: batch-256
    gradients of the kernel route against the plain and f32 routes; the first
    batch-2048 step's loss against the plain route's from the same weights and
    generator seed; VARIANT_STEPS steps with their launches and median; Shelgon
    with both masks None against all-ones masks; a Shelgon2 CLI run on the cut
    corpus served through ``Reconstructor``; ``latent_traversals_shelgon``."""
    import dataclasses

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch import cli
    from kindergarten_vq_vae_torch.analyses.traversals import latent_traversals_shelgon
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
    from kindergarten_vq_vae_torch.train.variants import STAT_KEYS, make_loss_fn

    t_phase = time.perf_counter()
    out, shelgon = {}, None
    big, small = _variant_batch(TRAIN_BATCH), _variant_batch(GRAD_BATCH)
    for name, over in VARIANTS:
        cfg = dataclasses.replace(_train_cfg(), **over)
        torch.cuda.empty_cache()
        model = init_weights(build_model(cfg, device="cuda"),
                             torch.Generator(device="cuda").manual_seed(SEED))
        grads = _variant_grads(cfg, model, small)
        with torch.no_grad():  # the first step's draws: a generator seeded as the step's
            plain_loss = make_loss_fn(cfg, "train", reference=True)(
                model, big, torch.Generator(device="cuda").manual_seed(SEED), False)[0].item()
        state = init_train_state(cfg, model)
        step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
        losses, times = [], []
        torch.cuda.synchronize()
        with _plain_refused():
            _reset_counters()
            for _ in range(VARIANT_STEPS):
                t0 = time.perf_counter()
                state, aux = step(state, big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append({k: float(aux[k]) for k in STAT_KEYS[cfg.model_name]})
            counts = _counters()
        _expect(f"{name}: {VARIANT_STEPS} train steps", counts,
                _run_counts(counts, VARIANT_STEPS, 0, vq=False))
        med = statistics.median(times[1:])
        first, full = losses[0]["loss_full"], [loss["loss_full"] for loss in losses]
        rel = abs(first - plain_loss) / abs(plain_loss)
        print(f"variant {name}: batch {TRAIN_BATCH} x {SEQ}, {VARIANT_STEPS} steps, median "
              f"{med * 1e3:.2f} ms ({TRAIN_BATCH / med:.1f} sentences/s) vs Shelgon3-VQ "
              f"{vq_step_ms:.2f} ms ({names[0]}; nvidia-smi: {names[1]}); launches a step "
              f"{ {k: v // VARIANT_STEPS for k, v in counts.items() if v} }; first-step loss "
              f"{first:.6f}, plain route {plain_loss:.6f}, rel {rel:.2e} (tol {HEAD_LOSS_REL}); "
              f"batch-{GRAD_BATCH} gradients vs f32 {json.dumps(grads)}")
        for i, (loss, dt) in enumerate(zip(losses, times)):
            print(f"  step {i}: {json.dumps(loss)} {dt * 1e3:.1f} ms")
        if rel > HEAD_LOSS_REL:
            _fail(f"{name}: the first step's loss is not the plain route's")
        if not all(math.isfinite(v) for loss in losses for v in loss.values()) \
                or full[-1] >= full[0]:
            _fail(f"{name}: train loss not finite or not falling: {full}")
        out[name] = {"median_ms": med * 1e3, "first_loss_rel": rel, "grads": grads,
                     "launches_per_step": {k: v // VARIANT_STEPS for k, v in counts.items()}}
        del state, step, aux
        if name == "shelgon":
            shelgon = model
        del model
        torch.cuda.empty_cache()

    # Shelgon with both masks None (use_mask_* off) against the all-ones masks
    cfg = dataclasses.replace(_train_cfg(), model_name="shelgon")
    res = {}
    for what, c in (("all-ones masks", cfg),
                    ("masks None", dataclasses.replace(cfg, use_mask_encoder=False,
                                                       use_mask_decoder=False))):
        for p in shelgon.parameters():
            p.grad = None
        with _plain_refused():
            _reset_counters()
            loss, _ = make_loss_fn(c, "train")(
                shelgon, small, torch.Generator(device="cuda").manual_seed(SEED + 3), False)
            loss.backward()
            torch.cuda.synchronize()
            counts = _counters()
        _expect(f"shelgon step, {what}", counts,
                _run_counts(counts, 1, 0, vq=False) | {"adam": 0})
        res[what] = (loss.item(), {n: p.grad.float() for n, p in shelgon.named_parameters()
                                   if p.grad is not None})
    (l1, g1), (l0, g0) = res["all-ones masks"], res["masks None"]
    num = sum(((g0[n] - g1[n]) ** 2).sum().item() for n in g1)
    den = sum((g1[n] ** 2).sum().item() for n in g1)
    rel, grel = abs(l0 - l1) / abs(l1), (num / den) ** 0.5
    print(f"shelgon, batch {GRAD_BATCH}, masks None vs all-ones: loss {l0:.6f} vs {l1:.6f} "
          f"(rel {rel:.2e}, tol {HEAD_LOSS_REL}), gradients global rel L2 {grel:.3e} "
          f"(tol {TRAIN_REL})")
    if g0.keys() != g1.keys() or rel > HEAD_LOSS_REL or grel > TRAIN_REL:
        _fail("Shelgon with null masks does not agree with all-ones masks")
    del res, g0, g1
    for p in shelgon.parameters():
        p.grad = None

    # latent traversal on the Shelgon model: every class set to label 2
    ids, mask = big["input_ids"][:8].cpu().numpy(), big["attention_mask"][:8].cpu().numpy()
    override = np.zeros((cfg.num_latent_classes, cfg.num_labels_per_class), np.float32)
    override[:, 2] = 1.0
    _reset_counters()
    trav = latent_traversals_shelgon(shelgon.eval(), ids, mask, override)
    counts = _counters()
    _expect("latent_traversals_shelgon (2 forwards)", counts,
            {k: 0 for k in counts} | {"layer_fwd": 48, **_inside_layers(2)})
    sums = np.abs(trav["original_latent_classes"].sum(-1) - 1.0).max()
    print(f"latent_traversals_shelgon on 8 sentences: ids {trav['traversed_recon_ids'].shape}, "
          f"latent classes {trav['original_latent_classes'].shape} sum to 1 within {sums:.2e}, "
          f"{int((trav['traversed_recon_ids'] != trav['original_recon_ids']).sum())} tokens "
          f"changed by the traversal")
    if trav["traversed_recon_ids"].shape != (8, SEQ) or sums > 1e-5:
        _fail("latent_traversals_shelgon gave no reconstructions or no class probabilities")
    del shelgon
    torch.cuda.empty_cache()

    # a Shelgon2 CLI run on the cut corpus, served through Reconstructor
    with tempfile.TemporaryDirectory(prefix="kvq_chip_variants_") as root:
        data_dir, runs_dir = os.path.join(root, "data"), os.path.join(root, "runs")
        generate_dsentences(data_dir, **ENGINE_CUT)
        n = len(prepare_all(data_dir, max_length=SEQ)["sentences_clean"])
        sets = {"n_epochs": 1, "batch_size": TRAIN_BATCH, "data_dir": data_dir,
                "runs_dir": runs_dir, "tokenized_sentence_max_length": SEQ,
                "lim_batches_train_pct": ENGINE_TRAIN_PCT, "ckpt_every_n_epochs": 0,
                "ckpt_slots": ("loss_recon:val",), "seed": SEED, "mask_pct_train": 0.1}
        argv = ["shelgon2", "--device", "cuda"]
        for k, v in sets.items():
            argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
        n_train, n_val = int(n * 0.6), int(n * 0.2)
        steps = int(n_train // TRAIN_BATCH * ENGINE_TRAIN_PCT)
        evals = -(-n_val // TRAIN_BATCH) + -(-(n - n_train - n_val) // TRAIN_BATCH)
        with _plain_refused():
            _reset_counters()
            t0 = time.perf_counter()
            engine = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counters()
        _expect(f"shelgon2 CLI ({steps} train steps, {evals} eval batches)", counts,
                _run_counts(counts, steps, evals, vq=False))
        with open(os.path.join(engine.run_path, "history.json")) as f:
            history = json.load(f)
        stats = [h[st] for h in history for st in ("train", "val", "test") if st in h]
        if not all(math.isfinite(st[k]) for st in stats for k in STAT_KEYS["shelgon2"]):
            _fail(f"the shelgon2 CLI run's stats are not finite: {history}")
        print(f"shelgon2 CLI: {' '.join(argv[:3])} ...: {wall:.1f} s, {steps} train steps, "
              f"{evals} eval batches; train {history[0]['train']['sentences_per_sec']:.1f} "
              f"sentences/s; test " + json.dumps({k: round(history[-1]["test"][k], 4)
                                                 for k in STAT_KEYS["shelgon2"]}))
        rng = np.random.default_rng(SEED)
        test_split = engine.splits["test"]
        sentences = [test_split.sentences[i] for i in rng.choice(len(test_split), 5)]
        run = engine.run_path
        del engine
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        _reset_counters()
        recon = rec.reconstruct(sentences)
        latents = rec.encode(sentences)
        served = _counters()
        want = {k: 0 for k in served} | {"layer_fwd": 36,
                                         **_inside_layers(1, encoder_forwards=1)}
        _expect("shelgon2 served (/reconstruct, /encode)", served, want)
        if ([r["input"] for r in recon] != sentences or "codes" in recon[0]
                or not all(0.0 <= r["token_acc"] <= 1.0 for r in recon)
                or latents.shape != (5, 768) or not np.isfinite(latents).all()):
            _fail(f"serving the shelgon2 run failed: {recon}")
        print(f"shelgon2 run served through Reconstructor: {recon[0]}; latents {latents.shape}")
        del rec
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"variants: {out['wall_s']:.1f} s; step medians at batch {TRAIN_BATCH} " + ", ".join(
        f"{k} {v['median_ms']:.2f} ms" for k, v in out.items() if isinstance(v, dict))
        + f", shelgon3-VQ {vq_step_ms:.2f} ms ({names[0]}; nvidia-smi: {names[1]})")
    return out


# phase 14, the GPT-2 decoder: a bert-base encoder with a GPT-2-small decoder
# (12 blocks, H 768, 12 heads, the published vocabulary of 50,257), bf16,
# dropout 0.1 / 0.1, batch 2048; the models that take it, and the steps each
# takes (the first held to the plain route)
GPT2_VOCAB, GPT2_STEPS = 50257, 4
GPT2_MODELS = (("bagon-gpt2", {"model_name": "bagon"}),
               ("shelgon3-vq-gpt2", {"model_name": "shelgon3"}))


def _gpt2_cfg(**over):
    import dataclasses

    return dataclasses.replace(_train_cfg(), decoder_model_name="gpt2",
                               decoder_vocab_size=GPT2_VOCAB, **over)


def _gpt2_batch(batch: int, seq: int = SEQ) -> dict:
    """``_train_batch`` with seeded decoder ids in [1, 50,257) (the BPE side
    of the dual tokenization, which the GPT-2 decoder reads)."""
    import numpy as np
    import torch

    out = _train_batch(batch, seq)
    rng = np.random.default_rng(SEED + 4)
    out["dec_input_ids"] = torch.from_numpy(rng.integers(1, GPT2_VOCAB, (batch, seq))).cuda()
    out["dec_attention_mask"] = out["attention_mask"]
    return out


def _gpt2_counts(counts: dict, steps: int, evals: int, vq: bool) -> dict:
    """The launches of ``steps`` training steps and ``evals`` eval batches of a
    GPT-2-decoder model: the 12 encoder layers through #1 / #2 (with #3), the
    CE through #7 / #8, the update #14, the VQ #5 under Shelgon3-VQ; the
    decoder blocks are plain PyTorch, as they are XLA in JAX (no #4)."""
    want = {k: 0 for k in counts}
    want.update(layer_fwd=12 * (steps + evals), layer_fwd_resid=12 * steps,
                layer_bwd=12 * steps, attn_bwd_self=12 * steps,
                **_inside_layers(0, encoder_forwards=steps + evals, encoder_backwards=steps),
                ce_fwd_ids=steps + evals, ce_bwd=steps, adam=steps,
                vq=(steps + evals) if vq else 0, codebook_grad=steps if vq else 0)
    return want


def phase_gpt2(names: tuple[str, str], vq_step_ms: float) -> dict:
    """The GPT-2 decoder at full width: #7 and #8 at (24,576, 50,257) against
    their plain versions, timed; for Bagon and Shelgon3-VQ with it, batch-256
    gradients of the kernel route against the plain and f32 routes, the first
    batch-2048 step's loss against the plain route's, GPT2_STEPS steps with
    their launches, median and peak memory; a ``bagon`` CLI run with
    ``decoder_model_name='gpt2'`` on the cut corpus (the BPE trained from it),
    served through ``Reconstructor``."""
    import numpy as np
    import torch

    from kindergarten_vq_vae_torch import cli
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.nn.gpt2 import GPT2LMHeadModel
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step
    from kindergarten_vq_vae_torch.train.variants import STAT_KEYS, make_loss_fn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    logits, t = _ce_case(g, TRAIN_BATCH * SEQ, GPT2_VOCAB)
    # the kernels line takes one time a row, as phase 4's rows give it
    out = {"ce": {k: {**v, "ms": statistics.mean(v["ms"]),
                      "plain_ms": statistics.mean(v["plain_ms"])}
                  for k, v in zip(("ce_fwd_ids", "ce_bwd"), _ce_ids_and_grad(logits, t)[:2])}}
    del logits, t
    torch.cuda.empty_cache()

    big, small = _gpt2_batch(TRAIN_BATCH), _gpt2_batch(GRAD_BATCH)
    for name, over in GPT2_MODELS:
        cfg = _gpt2_cfg(**over)
        vq = cfg.model_name == "shelgon3"
        model = init_weights(build_model(cfg, device="cuda"),
                             torch.Generator(device="cuda").manual_seed(SEED))
        if not isinstance(model.decoder, GPT2LMHeadModel):
            _fail(f"{name}: the decoder is not GPT-2's")
        n_params = sum(p.numel() for p in model.parameters())
        grads = _variant_grads(cfg, model, small)
        with torch.no_grad():  # the first step's draws: a generator seeded as the step's
            plain_loss = make_loss_fn(cfg, "train", reference=True)(
                model, big, torch.Generator(device="cuda").manual_seed(SEED), False)[0].item()
        state = init_train_state(cfg, model)
        step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _plain_refused():
            _reset_counters()
            for _ in range(GPT2_STEPS):
                t0 = time.perf_counter()
                state, aux = step(state, big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append({k: float(aux[k]) for k in STAT_KEYS[cfg.model_name]})
            counts = _counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _expect(f"{name}: {GPT2_STEPS} train steps", counts,
                _gpt2_counts(counts, GPT2_STEPS, 0, vq=vq))
        med = statistics.median(times[1:])
        first, full = losses[0]["loss_full"], [loss["loss_full"] for loss in losses]
        rel = abs(first - plain_loss) / abs(plain_loss)
        print(f"gpt2 {name}: {n_params} parameters, batch {TRAIN_BATCH} x {SEQ}, decoder "
              f"vocabulary {GPT2_VOCAB}, {GPT2_STEPS} steps, median {med * 1e3:.2f} ms "
              f"({TRAIN_BATCH / med:.1f} sentences/s), max_memory_allocated {peak:.2f} GiB vs "
              f"the BERT-decoder Shelgon3-VQ {vq_step_ms:.2f} ms ({names[0]}; nvidia-smi: "
              f"{names[1]}); launches a step "
              f"{ {k: v // GPT2_STEPS for k, v in counts.items() if v} }; first-step loss "
              f"{first:.6f}, plain route {plain_loss:.6f}, rel {rel:.2e} (tol {HEAD_LOSS_REL}); "
              f"batch-{GRAD_BATCH} gradients vs f32 {json.dumps(grads)}")
        for i, (loss, dt) in enumerate(zip(losses, times)):
            print(f"  step {i}: {json.dumps(loss)} {dt * 1e3:.1f} ms")
        if rel > HEAD_LOSS_REL:
            _fail(f"{name}: the first step's loss is not the plain route's")
        if not all(math.isfinite(v) for loss in losses for v in loss.values()) \
                or full[-1] >= full[0]:
            _fail(f"{name}: train loss not finite or not falling: {full}")
        out[name] = {"median_ms": med * 1e3, "peak_gib": peak, "first_loss_rel": rel,
                     "grads": grads, "counts": counts, "n_params": n_params}
        del state, step, aux, model
        torch.cuda.empty_cache()

    # a GPT-2 Bagon CLI run on the cut corpus: the BPE trained from the corpus
    # and saved beside it, a few steps, val and test, served
    with tempfile.TemporaryDirectory(prefix="kvq_chip_gpt2_") as root:
        data_dir, runs_dir = os.path.join(root, "data"), os.path.join(root, "runs")
        generate_dsentences(data_dir, **ENGINE_CUT)
        n = len(prepare_all(data_dir, max_length=SEQ)["sentences_clean"])
        sets = {"n_epochs": 1, "batch_size": TRAIN_BATCH, "data_dir": data_dir,
                "runs_dir": runs_dir, "tokenized_sentence_max_length": SEQ,
                "lim_batches_train_pct": ENGINE_TRAIN_PCT, "ckpt_every_n_epochs": 0,
                "ckpt_slots": ("loss_recon:val",), "seed": SEED, "decoder_model_name": "gpt2",
                "decoder_vocab_size": GPT2_VOCAB}
        argv = ["bagon", "--device", "cuda"]
        for k, v in sets.items():
            argv += ["--set", f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"]
        n_train, n_val = int(n * 0.6), int(n * 0.2)
        steps = int(n_train // TRAIN_BATCH * ENGINE_TRAIN_PCT)
        evals = -(-n_val // TRAIN_BATCH) + -(-(n - n_train - n_val) // TRAIN_BATCH)
        with _plain_refused():
            _reset_counters()
            t0 = time.perf_counter()
            engine = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counters()
        _expect(f"bagon gpt2 CLI ({steps} train steps, {evals} eval batches)", counts,
                _gpt2_counts(counts, steps, evals, vq=False))
        with open(os.path.join(data_dir, "gpt2_vocab.json")) as f:
            bpe_vocab = len(json.load(f))
        with open(os.path.join(engine.run_path, "history.json")) as f:
            history = json.load(f)
        stats = [h[st] for h in history for st in ("train", "val", "test") if st in h]
        if not all(math.isfinite(st[k]) for st in stats for k in STAT_KEYS["bagon"]) \
                or not 257 <= bpe_vocab <= GPT2_VOCAB:
            _fail(f"the gpt2 CLI run's stats are not finite or its BPE is amiss: {history}")
        print(f"bagon gpt2 CLI: {' '.join(argv[:3])} ...: {wall:.1f} s (the BPE trained from "
              f"the corpus: {bpe_vocab} entries), {steps} train steps, {evals} eval batches; "
              f"train {history[0]['train']['sentences_per_sec']:.1f} sentences/s; test "
              + json.dumps({k: round(history[-1]["test"][k], 4) for k in STAT_KEYS["bagon"]}))
        rng = np.random.default_rng(SEED)
        test_split = engine.splits["test"]
        sentences = [test_split.sentences[i] for i in rng.choice(len(test_split), 5)]
        run = engine.run_path
        del engine
        torch.cuda.empty_cache()
        rec = Reconstructor(run, device="cuda")
        _reset_counters()
        recon = rec.reconstruct(sentences)
        served = _counters()
        want = {k: 0 for k in served} | {"layer_fwd": 12,
                                         **_inside_layers(0, encoder_forwards=1)}
        _expect("bagon gpt2 served (/reconstruct)", served, want)
        if ([r["input"] for r in recon] != sentences
                or not all(0.0 <= r["token_acc"] <= 1.0 for r in recon)):
            _fail(f"serving the gpt2 run failed: {recon}")
        print(f"bagon gpt2 run served through Reconstructor: {recon[0]}")
        del rec
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"gpt2: {out['wall_s']:.1f} s; step medians at batch {TRAIN_BATCH} " + ", ".join(
        f"{k} {out[k]['median_ms']:.2f} ms ({out[k]['peak_gib']:.2f} GiB)"
        for k, _ in GPT2_MODELS) + f", BERT-decoder shelgon3-VQ {vq_step_ms:.2f} ms "
        f"({names[0]}; nvidia-smi: {names[1]})")
    return out


def phase_f32(names: tuple[str, str]) -> dict:
    """The f32 instances of the default route's kernels: (a) each alone at
    the batch-2048 step's shapes against its f32 plain version, timed in
    turns with it, with its bound and library call (the layer GEMM at every
    product in each layout, the LayerNorm trio, the attention forward and
    backward, #1 and #2 encoder and decoder, the keep masks, #7 / #8 at
    30,522 and 50,257 with #6); (b) the f32 bert-base Shelgon3-VQ step at
    batch 2048 (launches, median, peak memory) and an f32 CLI run, trained,
    evaluated, checkpointed and (d) served against the plain route; (c) the
    batch-256 loss and gradients of the kernel route against the plain
    route's; (e) one Bagon-GPT-2 step at a cut depth against the plain route."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.ops.ce import ce_fwd, ce_fwd_reference, fused_ce_loss
    from kindergarten_vq_vae_torch.ops.dropout import OP_MLP_OUT, cross_op, hidden_keep
    from kindergarten_vq_vae_torch.ops.gemm import gemm, gemm_f32_plan, gemm_reference, sm_count
    from kindergarten_vq_vae_torch.ops.layer import (
        attention_backward,
        attention_backward_reference,
        attention_forward,
        attention_forward_reference,
        column_sums,
        column_sums_reference,
        layer_backward,
        layer_backward_reference,
        layer_forward,
        layer_forward_reference,
        layernorm_backward,
        layernorm_backward_reference,
        residual_layernorm,
        residual_layernorm_reference,
    )
    from kindergarten_vq_vae_torch.train.step import make_train_step, init_train_state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    f32, rows, H, dev = torch.float32, TRAIN_BATCH * SEQ, 768, "cuda"
    res = {}

    def note(key, what, err, k_ms, p_ms, bound, lib_ms, lib, extra=""):
        print(f"f32 {what}: {k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, share "
              f"{bound[0] / k_ms:.3f}), plain {p_ms:.4f} ms, {lib} {lib_ms:.4f} ms, max abs "
              f"{err:.3e}{extra} ({names[0]}; nvidia-smi: {names[1]})")
        r = res.setdefault(key, {"max_abs_err": 0.0, "ms": [], "plain_ms": [], "bound": [],
                                 "library_ms": [], "library": lib})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound", bound), ("library_ms", lib_ms)):
            r[k].append(v)

    def held(what, got, want, tol):
        rel = max(_rel_max(a, b) for a, b in zip(got, want))
        if not all(_finite(a) and a.dtype == b.dtype for a, b in zip(got, want)) or rel > tol:
            _fail(f"f32 {what}: the kernel disagrees with its f32 plain version (rel {rel:.3e}, "
                  f"tol {tol})")
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)), rel

    # (a) the layer GEMM at every product of the step, each layout
    sms = sm_count(torch.device(dev))
    to_f32 = {"bf16": "f32", "add_bf16": "add_f32"}  # the f32 instance's epilogues
    for name, k_in, k_out, fwd_epi, dgrad_epi in LAYER_PRODUCTS:
        x = torch.randn(rows, k_in, device=dev, generator=g)
        w = torch.randn(k_in, k_out, device=dev, generator=g) / k_in ** 0.5
        bias = 0.02 * torch.randn(k_out, device=dev, generator=g)
        dy = 0.1 * torch.randn(rows, k_out, device=dev, generator=g)
        de = to_f32.get(dgrad_epi, dgrad_epi)
        aux = (2.0 if de.startswith("dgelu") else 1.0) * torch.randn(rows, k_in, device=dev,
                                                                       generator=g)
        for kind, ops, kw, lib, (M, N, K) in (
                ("fwd", (x, w), dict(epi=to_f32.get(fwd_epi, fwd_epi), bias=bias),
                 lambda: x @ w, (rows, k_out, k_in)),
                ("dgrad", (dy, w), dict(b_t=True, epi=de, aux=aux if de != "f32" else None),
                 lambda: dy @ w.t(), (rows, k_in, k_out)),
                ("wgrad", (x, dy), dict(a_t=True, epi="f32"), lambda: x.t() @ dy,
                 (k_in, k_out, rows))):
            two = kw["epi"].startswith(("gelu", "dgelu"))
            got = gemm(*ops, **kw, out2=two)
            torch.cuda.synchronize()
            want = gemm_reference(*ops, **kw, out2=two)
            got, want = (got, want) if two else ((got,), (want,))
            tol = F32_FWD if kind == "fwd" else F32_GRAD
            err, rel = held(f"layer GEMM {name} {kind}", got, want, tol)
            k_ms, p_ms = _paired_ms(lambda: gemm(*ops, **kw, out2=two),
                                    lambda: gemm_reference(*ops, **kw, out2=two), 5)
            flops = 2.0 * M * N * K
            plan = gemm_f32_plan(M, N, K, sms) if kind == "wgrad" else None
            note("gemm_fwd" if kind == "fwd" else "gemm_grad",
                 f"layer GEMM {name:4s} {kind:5s} ({M},{N},{K}) {kw['epi']}"
                 + (f" splits {plan.splits}" if plan else ""), err, k_ms, p_ms,
                 _bound(flops, _nbytes(ops, kw.get("bias"), kw.get("aux"), got), PEAK_3XTF32),
                 _time_ms(lib, 5), "torch.matmul (f32, 'highest')",
                 f", {flops / k_ms / 1e9:.1f} TFLOP/s, rel {rel:.2e} (tol {tol}), f32 FMA "
                 f"bound {flops / PEAK_F32 * 1e3:.4f} ms")
            del got, want
        if name == "wo":
            same = torch.equal(gemm(x, dy, a_t=True), gemm(x, dy, a_t=True))
            print(f"f32 layer GEMM weight gradient ({k_in},{k_out}) over {rows} rows, twice: bit "
                  f"for bit equal {same}")
            if not same:
                _fail("the f32 layer GEMM's weight gradient differs from run to run")
        del x, w, bias, dy, aux
    torch.cuda.empty_cache()

    # the LayerNorm trio on f32 rows, dropout 0.1
    eps, seed, rate = 1e-12, 4321, 0.1
    gamma = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
    beta = 0.1 * torch.randn(H, device=dev, generator=g)
    keep = hidden_keep(seed, OP_MLP_OUT, rows, H, rate, dev)
    x = torch.randn(rows, H, device=dev, generator=g)
    a = 0.5 * torch.randn(rows, H, device=dev, generator=g) + 0.2
    ln_args = (x, a, gamma, beta, eps, seed, OP_MLP_OUT, rate)
    got = residual_layernorm(*ln_args)
    torch.cuda.synchronize()
    want = residual_layernorm_reference(x, a, gamma, beta, eps, keep)
    err, _ = held("residual_layernorm", got, want, F32_FWD)
    k_ms, p_ms = _paired_ms(lambda: residual_layernorm(*ln_args), lambda: (
        residual_layernorm_reference(x, a, gamma, beta, eps,
                                     hidden_keep(seed, OP_MLP_OUT, rows, H, rate, dev))), 20)
    note("ln_fwd", f"residual_layernorm ({rows},{H}) dropout {rate}", err, k_ms, p_ms,
         _bound(0.0, _nbytes(x, a, gamma, beta, got), PEAK_F32),
         _time_ms(lambda: F.layer_norm(x + a, (H,), gamma, beta, eps), 20),
         "x + a then F.layer_norm (no dropout)")
    v, inv = got
    gy = torch.randn(rows, H, device=dev, generator=g)
    got = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
    torch.cuda.synchronize()
    want = layernorm_backward_reference(gy, v, inv, gamma, beta, keep)
    err, _ = held("layernorm_backward", got, want, F32_GRAD)
    again = layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate)
    if not all(torch.equal(p_, q_) for p_, q_ in zip(got[2:], again[2:])):
        _fail("the f32 LayerNorm backward's sums differ from run to run")
    k_ms, p_ms = _paired_ms(
        lambda: layernorm_backward(gy, v, inv, gamma, beta, seed, OP_MLP_OUT, rate),
        lambda: layernorm_backward_reference(gy, v, inv, gamma, beta,
                                             hidden_keep(seed, OP_MLP_OUT, rows, H, rate, dev)),
        20)
    mean_r, rstd_r = x.mean(-1, keepdim=True), inv[:, None]
    note("ln_bwd", f"layernorm_backward ({rows},{H}) dropout {rate}, sums bit for bit twice",
         err, k_ms, p_ms, _bound(0.0, _nbytes(gy, v, inv, gamma, beta, got), PEAK_F32),
         _time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
             gy, x, (H,), mean_r, rstd_r, gamma, beta, (True, True, True)), 20),
         "aten.native_layer_norm_backward (no keep mask, no da)")
    del x, a, v, inv, gy, got, want, again
    for N in (768, 1536, 2304):
        src = torch.randn(rows, N, device=dev, generator=g)
        got = column_sums(src)
        torch.cuda.synchronize()
        err, _ = held(f"column_sums ({N})", (got,), (column_sums_reference(src),), F32_GRAD)
        if not torch.equal(got, column_sums(src)):
            _fail("the f32 column sums differ from run to run")
        k_ms, p_ms = _paired_ms(lambda: column_sums(src), lambda: column_sums_reference(src), 20)
        note("colsum", f"column_sums ({rows},{N}), bit for bit twice", err, k_ms, p_ms,
             _bound(0.0, _nbytes(src, got), PEAK_F32), _time_ms(lambda: src.sum(0), 20),
             "src.sum(0)")
        del src, got

    # the attention forward and backward (3xTF32 mma.sync, a warp a head),
    # dropout 0.1, each with its share of its byte bound
    lib_name = "F.scaled_dot_product_attention, f32 (rate 0, head transposes)"

    def byte_share(k_ms, *objs):
        t = _nbytes(*objs) / HBM_BYTES_PER_S * 1e3
        return f", byte bound {t:.4f} ms, {t / k_ms:.1%} of it"

    for key, cross, causal, masked in (("self", False, True, False), ("self", False, False, True),
                                       ("cross", True, False, False)):
        packed = torch.randn(TRAIN_BATCH, SEQ, (1 if cross else 3) * H, device=dev, generator=g)
        kv = torch.randn(TRAIN_BATCH, SEQ, 2 * H, device=dev, generator=g) if cross else None
        q, k, v = (packed, *kv.split(H, -1)) if cross else packed.split(H, -1)
        mask = _padded_mask(g, TRAIN_BATCH) if masked else None
        args = (packed, kv, mask, 12, causal, seed, cross_op(12) if cross else 0, rate)
        what = (f"attention forward in #1, {key} ({TRAIN_BATCH},{SEQ},{H}), "
                f"{'causal, ' if causal else ''}{'padded mask, ' if masked else ''}dropout {rate}")
        with torch.no_grad():
            got = attention_forward(*args)
            torch.cuda.synchronize()
            err, rel = held(what, (got,), (attention_forward_reference(*args),), F32_FWD)
            k_ms, p_ms = _paired_ms(lambda: attention_forward(*args),
                                    lambda: attention_forward_reference(*args), 10)
            lib_fwd, lib_bwd = _library_sdpa(q, k, v, mask, causal)
            note(f"attn_fwd_{key}", what, err, k_ms, p_ms,
                 _bound(4 * TRAIN_BATCH * 12 * SEQ * SEQ * 64, _nbytes(q, k, v, mask, got),
                        PEAK_3XTF32), _time_ms(lib_fwd, 10), lib_name,
                 f", rel {rel:.2e}" + byte_share(k_ms, q, k, v, mask, got))
            if not causal:  # the backward at the layer's shapes: self padded, cross
                gctx = torch.randn(TRAIN_BATCH, SEQ, H, device=dev, generator=g)
                b_args = args[:3] + (gctx,) + args[3:]
                got = attention_backward(*b_args)
                torch.cuda.synchronize()
                want = attention_backward_reference(*b_args)
                got, want = (got, want) if cross else ((got,), (want,))
                err, rel = held(f"attention backward, {key}", got, want, F32_GRAD)
                k_ms, p_ms = _paired_ms(lambda: attention_backward(*b_args),
                                        lambda: attention_backward_reference(*b_args), 10)
                note(f"attn_bwd_{key}", f"attention backward, {key} ({TRAIN_BATCH},{SEQ},{H}), "
                     f"dropout {rate}", err, k_ms, p_ms,
                     _bound(10 * TRAIN_BATCH * 12 * SEQ * SEQ * 64, _nbytes(b_args[:4], got),
                            PEAK_3XTF32), _time_ms(lib_bwd, 10), "autograd backward of " + lib_name,
                     f", rel {rel:.2e}" + byte_share(k_ms, b_args[:4], got))
        del packed, kv, q, k, v, got
    torch.cuda.empty_cache()

    # #1 and #2, encoder and decoder, training mode, dropout 0.1 / 0.1
    layer_lib = "nn.Transformer{Encoder,Decoder}Layer, f32, train mode, dropout 0"
    for decoder in (False, True):
        what = "decoder" if decoder else "encoder"
        geom, x, enc, smask, ws = _layer_case(decoder, g, TRAIN_BATCH, 0.1, f32)
        with torch.no_grad():
            out, resid = layer_forward(geom, x, enc, smask, None, ws, seed)
            torch.cuda.synchronize()
            out_p, res_p = layer_forward_reference(geom, x, enc, smask, None, ws, seed)
            err, rel = held(f"layer forward {what}", (out, *resid), (out_p, *res_p), F32_FWD)
            k_ms, p_ms = _paired_ms(lambda: layer_forward(geom, x, enc, smask, None, ws, seed),
                                    lambda: layer_forward_reference(geom, x, enc, smask, None,
                                                                    ws, seed), 3)
            flops = _layer_flops(TRAIN_BATCH, SEQ, decoder)
            lib_fwd, lib_bwd = _library_layer(decoder, x, enc, smask, ws, train=True)
            note("layer_fwd", f"layer forward (#1) {what} ({TRAIN_BATCH},{SEQ},{H}), residuals",
                 err, k_ms, p_ms,
                 _bound(flops, _nbytes(x, enc, smask, ws, out, resid), PEAK_3XTF32),
                 _time_ms(lib_fwd, 3), layer_lib + ": forward under autograd",
                 f", rel {rel:.2e}, f32 FMA bound {flops / PEAK_F32 * 1e3:.4f} ms")
            gy = 0.1 * torch.randn(x.shape, device=dev, generator=g)
            b_args = (geom, x, enc, smask, None, ws, seed, res_p, out_p, gy,
                      f32 if decoder else None)
            got = layer_backward(*b_args)
            torch.cuda.synchronize()
            want = layer_backward_reference(*b_args)
            flat = [t for t in (got[0], got[1], *got[2]) if t is not None]
            err, rel = held(f"layer backward {what}", flat,
                            [t for t in (want[0], want[1], *want[2]) if t is not None], F32_GRAD)
            k_ms, p_ms = _paired_ms(lambda: layer_backward(*b_args),
                                    lambda: layer_backward_reference(*b_args), 3)
            note("layer_bwd", f"layer backward (#2) {what}", err, k_ms, p_ms,
                 _bound(2 * flops, _nbytes(b_args[:-1], flat), PEAK_3XTF32),
                 _time_ms(lib_bwd, 3), layer_lib + ": its autograd backward",
                 f", rel {rel:.2e}, f32 FMA bound {2 * flops / PEAK_F32 * 1e3:.4f} ms")
        del geom, x, enc, smask, ws, out, resid, out_p, res_p, got, want, flat, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    _check_keep_masks(seed, f32)
    torch.cuda.empty_cache()

    # #7 / #8 (and #6) at 30,522 and GPT-2's 50,257, rows at every 16-byte phase
    for vocab, suffix in ((VOCAB, ""), (GPT2_VOCAB, "_gpt2")):
        logits, t = _ce_case(g, rows, vocab, f32)
        phases = len({logits[r].data_ptr() % 16 for r in range(8)})
        fwd, bwd, nll = _ce_ids_and_grad(logits, t)
        res[f"ce_fwd_ids{suffix}"] = {**fwd, "library_ms": fwd.pop("two_call_ms"),
                                      "library": "F.cross_entropy(reduction='none') + "
                                                 "torch.argmax(x, 1)"}
        res[f"ce_bwd{suffix}"] = bwd
        print(f"f32 CE at ({rows},{vocab}): rows at {phases} 16-byte phases")
        if not suffix:  # #6, the same template without the argmax
            with torch.no_grad():
                nll6 = ce_fwd(logits, t)
                torch.cuda.synchronize()
                same = torch.equal(nll6, nll)
                err = (nll6 - ce_fwd_reference(logits, t)).abs().max().item()
                k_ms, p_ms = _paired_ms(lambda: ce_fwd(logits, t),
                                        lambda: ce_fwd_reference(logits, t), 10)
                note("ce_fwd", f"ce_fwd (#6) ({rows},{vocab})", err, k_ms, p_ms,
                     _bound(4 * rows * vocab, _nbytes(logits, t, nll6), PEAK_F32),
                     _time_ms(lambda: F.cross_entropy(logits, t.long(), reduction="none"), 10),
                     "F.cross_entropy(reduction='none')")
            x3 = logits.view(TRAIN_BATCH, SEQ, vocab).detach().requires_grad_()
            _reset_counters()
            fused_ce_loss(x3, t.view(TRAIN_BATCH, SEQ), torch.ones(TRAIN_BATCH, device=dev)
                          ).backward()
            torch.cuda.synchronize()
            counts = _counters()
            want_counts = _as_f32({k: 0 for k in counts} | {"ce_fwd": 1, "ce_bwd": 1})
            print(f"f32 #6: NLL equal to #7's {same}; fused_ce_loss launches {counts}")
            if not same or counts != want_counts:
                _fail("f32 #6 differs from #7's NLL or fused_ce_loss skipped its f32 kernels")
            res["ce_loss_launches"] = counts
            del x3, nll6
        del logits, t, nll
        torch.cuda.empty_cache()

    # (b) the f32 step at batch 2048, then the f32 CLI run, (d) served
    tr = phase_train(names, steps=F32_STEPS, dtype="float32")
    eng = phase_engine(names, epochs=1, dtype="float32")

    # (c) batch-256 loss and gradients, kernel route against plain route, f32
    cfg = dataclasses.replace(_train_cfg(), compute_dtype="float32")
    seeded = torch.Generator(device=dev).manual_seed(SEED)
    model = init_weights(build_model(cfg, device=dev), seeded)
    small = _train_batch(GRAD_BATCH)

    def default_route(c):  # the fused layers and the logits path's CE
        return c["layer_fwd"] > 0 and c["ce_fwd_ids"] == 1

    grads = _f32_route_vs_plain(f"Shelgon3-VQ at batch {GRAD_BATCH}", model, cfg, small,
                                default_route)
    del model
    torch.cuda.empty_cache()

    # (e) Bagon with the GPT-2 decoder, full width at a cut depth, one step
    cfg = _gpt2_cfg(model_name="bagon", compute_dtype="float32", num_layers=F32_GPT2_LAYERS)
    model = init_weights(build_model(cfg, device=dev), seeded.manual_seed(SEED))
    gpt2 = _f32_route_vs_plain(f"Bagon-GPT-2 ({F32_GPT2_LAYERS} + {F32_GPT2_LAYERS} layers, "
                               f"vocabulary {GPT2_VOCAB}) at batch {GRAD_BATCH}", model, cfg,
                               _gpt2_batch(GRAD_BATCH), default_route)
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, dev, torch.Generator(device=dev).manual_seed(SEED))
    with _plain_refused(default_route=True):
        t0 = time.perf_counter()
        state, aux = step(state, _gpt2_batch(TRAIN_BATCH))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if not math.isfinite(float(aux["loss_full"])):
        _fail("the f32 Bagon-GPT-2 step's loss is not finite")
    print(f"f32 Bagon-GPT-2 step at batch {TRAIN_BATCH} (first, with its set-up): {dt * 1e3:.1f} "
          f"ms, loss {float(aux['loss_full']):.5f}")
    del model, state, step, aux
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_phase
    print(f"f32: {wall:.1f} s; step median {tr['median_ms']:.2f} ms "
          f"({TRAIN_BATCH * 1e3 / tr['median_ms']:.1f} sentences/s), max_memory_allocated "
          f"{tr['peak_gib']:.2f} GiB (CLI run {eng['peak_gib']:.2f} GiB) ({names[0]}; nvidia-smi: "
          f"{names[1]})")
    def mean(v):
        return statistics.mean(v) if isinstance(v, list) else v

    out = {k: {**v, **{f: mean(v[f]) for f in ("ms", "plain_ms", "library_ms")}}
           for k, v in res.items() if k != "ce_loss_launches"}
    return {**out, "train": tr, "engine": eng, "grads": grads, "gpt2": gpt2,
            "ce_loss_launches": res["ce_loss_launches"], "wall_s": wall}


def _f32_route_vs_plain(what: str, m, c, batch, ok) -> dict:
    """One f32 loss and backward of ``m`` (config ``c``) through the kernels'
    f32 instances against the plain route's (``reference=True``), from the
    same weights and generator seed: the loss within F32_LOSS_REL relative,
    the gradients within F32_GRAD global relative L2, every launch an f32
    instance's, no plain version on the kernel route, and ``ok(counts)``."""
    import torch

    from kindergarten_vq_vae_torch.train.variants import make_loss_fn

    def loss_and_grads(reference):
        for p_ in m.parameters():
            p_.grad = None
        loss, _ = make_loss_fn(c, "train", reference=reference)(
            m, batch, torch.Generator(device="cuda").manual_seed(SEED + 2), False)
        loss.backward()
        return loss.item(), {n_: p_.grad.clone() for n_, p_ in m.named_parameters()
                             if p_.grad is not None}

    lp, ref = loss_and_grads(True)
    with _plain_refused(default_route=True):
        _reset_counters()
        lk, got = loss_and_grads(False)
        torch.cuda.synchronize()
        counts = _counters()
    glob = (sum(((got[n_] - ref[n_]) ** 2).sum().item() for n_ in ref)
            / sum((ref[n_] ** 2).sum().item() for n_ in ref)) ** 0.5
    loss_rel = abs(lk - lp) / abs(lp)
    only_f32 = counts == _as_f32(counts)  # every launch an f32 instance's
    print(f"f32 {what}: loss {lk:.7f}, plain route {lp:.7f}, rel {loss_rel:.3e} (tol "
          f"{F32_LOSS_REL}); gradients global rel L2 {glob:.3e} (tol {F32_GRAD}) over "
          f"{len(ref)} leaves; launches { {k: v for k, v in counts.items() if v} }")
    if (got.keys() != ref.keys() or not all(_finite(t_) for t_ in got.values())
            or loss_rel > F32_LOSS_REL or glob > F32_GRAD or not only_f32 or not ok(counts)):
        _fail(f"f32 {what}: the kernel route disagrees with the plain route or ran other "
              "than the f32 instances")
    return {"loss_rel": loss_rel, "grad_global_rel_l2": glob, "counts": counts}


def phase_f32_head(names: tuple[str, str]) -> dict:
    """#9 and #10 (store and flash) and the table gradient in f32 at the
    step's head shapes (24,576 rows x 768 x 30,522) against their f32 plain
    versions, timed in turns with them, with their bounds (3xTF32
    operations; the f32 FMA bound printed beside) and library calls."""
    import torch
    import torch.nn.functional as F

    from kindergarten_vq_vae_torch.ops.head_ce import (
        head_ce_bwd,
        head_ce_bwd_reference,
        head_ce_fwd,
        head_ce_fwd_reference,
        table_grad,
        table_grad_reference,
    )

    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rows, H, V, dev = TRAIN_BATCH * SEQ, 768, VOCAB, "cuda"
    x = torch.randn(rows, H, device=dev, generator=g)
    table = 0.05 * torch.randn(V, H, device=dev, generator=g)
    bias = 0.1 * torch.randn(V, device=dev, generator=g)
    t = torch.randint(0, V, (rows,), device=dev, generator=g, dtype=torch.int32)
    scale = torch.rand(rows, device=dev, generator=g) / rows
    flops = 2.0 * rows * V * H
    res = {}
    with torch.no_grad():
        fwd = {m: head_ce_fwd(x, table, bias, t, m) for m in HEAD_MODES}
        torch.cuda.synchronize()
        nll, lse, ids, logits = fwd["store"]
        flash_same = all(torch.equal(a, b) for a, b in zip(fwd["store"][:3], fwd["flash"][:3]))
        nll_p, lse_p, ids_p, logits_p = head_ce_fwd_reference(x, table, bias, t, "store")
        l_rel, dl = _rel_max(logits, logits_p), (logits - logits_p).abs().max().item()
        nll_rel = max(_rel_max(nll, nll_p), _rel_max(lse, lse_p))
        fwd_abs = max((nll - nll_p).abs().max().item(), (lse - lse_p).abs().max().item())
        top2 = logits_p.topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * dl
        ids_clear, ids_share = torch.equal(ids[clear], ids_p[clear]), (ids == ids_p).float().mean()
        ld = logits.stride(0)
        pad_zero = bool((logits.as_strided((rows, ld), (ld, 1))[:, V:] == 0).all())
        del top2, logits_p
        print(f"head_ce_fwd f32 ({rows},{H})x{V}: logits max rel {l_rel:.3e} (tol {F32_FWD}), "
              f"nll / lse max rel {nll_rel:.3e} (tol {F32_NLL_REL}), ids equal where the plain "
              f"top-2 gap > 2 dl ({int(clear.sum())} of {rows} rows) {ids_clear}, in all "
              f"{ids_share.item():.6f}; flash = store bit for bit {flash_same}; logits' rows {ld} "
              f"wide, pad columns 0 {pad_zero}")
        if not (l_rel <= F32_FWD and nll_rel <= F32_NLL_REL and ids_clear and flash_same
                and pad_zero and logits.dtype == torch.float32):
            _fail("the f32 fused head + CE forward disagrees with its f32 plain version")

        bwd = {m: head_ce_bwd(logits if m == "store" else x, table, bias, t, lse, scale, m)
               for m in HEAD_MODES}
        torch.cuda.synchronize()
        gk, dxk, dbk = bwd["store"]
        bflash_same = all(torch.equal(a, b) for a, b in zip(bwd["store"], bwd["flash"]))
        gp, dxp, dbp = head_ce_bwd_reference(logits, table, bias, t, lse, scale, "store")
        errs = {"g": _rel_max(gk, gp), "dx": _rel_max(dxk, dxp), "dbias": _rel_max(dbk, dbp)}
        bwd_abs = max((a - b).abs().max().item() for a, b in ((gk, gp), (dxk, dxp), (dbk, dbp)))
        del gp, dxp
        ldg = gk.stride(0)
        pad_zero = bool((gk.as_strided((rows, ldg), (ldg, 1))[:, V:] == 0).all())
        dt = table_grad(gk, x)
        torch.cuda.synchronize()
        dtp = table_grad_reference(gk, x)
        errs["d_table"], dt_abs = _rel_max(dt, dtp), (dt - dtp).abs().max().item()
        del dtp
        print(f"head_ce_bwd f32: rel to the largest, " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {F32_GRAD}); flash = store bit "
            f"for bit (g, dx, dbias) {bflash_same}; g's rows {ldg} wide, pad columns 0 {pad_zero}")
        if not (max(errs.values()) <= F32_GRAD and bflash_same and pad_zero
                and all(a.dtype == torch.float32 for a in (gk, dxk, dbk, dt))):
            _fail("the f32 fused head + CE backward or the table gradient disagrees with its f32 "
                  "plain version")

        def lib_fwd():
            lg = torch.matmul(x, table.t()) + bias
            return F.cross_entropy(lg, t.long(), reduction="none"), lg.argmax(1)

        lib_fwd_ms = _time_ms(lib_fwd, 3)
    with torch.enable_grad():  # the library backward: autograd of the same calls
        xl, bl = x.detach().requires_grad_(), bias.detach().requires_grad_()
        loss_l = (F.cross_entropy(torch.matmul(xl, table.t()) + bl, t.long(), reduction="none")
                  * scale).sum()
        lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(loss_l, (xl, bl), retain_graph=True), 3)
        del loss_l, xl, bl
    torch.cuda.empty_cache()

    def rate(ms, f=flops):
        return f"{f / ms / 1e9:.1f} TFLOP/s"

    fma = flops / PEAK_F32 * 1e3  # the f32 FMA units' bound of one product
    lib_f = "cuBLAS f32 head GEMM (torch.matmul, 'highest') + bias + F.cross_entropy + argmax"
    with torch.no_grad():
        for m in HEAD_MODES:
            saved = logits if m == "store" else x
            k_ms, p_ms = _paired_ms(lambda m=m: head_ce_fwd(x, table, bias, t, m),
                                    lambda m=m: head_ce_fwd_reference(x, table, bias, t, m), 3)
            bound = _bound(flops, _nbytes(x, table, bias, t, fwd[m]), PEAK_3XTF32)
            res[f"fwd_{m}"] = {"max_abs_err": fwd_abs, "ms": k_ms, "plain_ms": p_ms,
                               "bound": [bound], "library_ms": lib_fwd_ms, "library": lib_f}
            print(f"head_ce_fwd f32 {m}: kernel {k_ms:.4f} ms, {rate(k_ms)}, plain {p_ms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]}; f32 FMA bound {fma:.4f} ms), {lib_f} "
                  f"{lib_fwd_ms:.4f} ms ({names[0]}; nvidia-smi: {names[1]})")
            n_prod = 2 if m == "flash" else 1
            k_ms, p_ms = _paired_ms(
                lambda m=m, saved=saved: head_ce_bwd(saved, table, bias, t, lse, scale, m),
                lambda m=m, saved=saved: head_ce_bwd_reference(saved, table, bias, t, lse, scale,
                                                               m), 3)
            bound = _bound(n_prod * flops, _nbytes(saved, table, bias, t, lse, scale, bwd[m]),
                           PEAK_3XTF32)
            res[f"bwd_{m}"] = {"max_abs_err": bwd_abs, "ms": k_ms, "plain_ms": p_ms,
                               "bound": [bound], "library_ms": lib_bwd_ms,
                               "library": "autograd backward (x, bias) of " + lib_f}
            print(f"head_ce_bwd f32 {m}: kernel {k_ms:.4f} ms, {rate(k_ms, n_prod * flops)}, "
                  f"plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; f32 FMA bound "
                  f"{n_prod * fma:.4f} ms), its autograd backward {lib_bwd_ms:.4f} ms")
        k_ms, p_ms = _paired_ms(lambda: table_grad(gk, x), lambda: table_grad_reference(gk, x), 3)
        lib_ms = _time_ms(lambda: torch.matmul(gk.t(), x), 3)
        bound = _bound(flops, _nbytes(gk, x, dt), PEAK_3XTF32)
        res["d_table"] = {"max_abs_err": dt_abs, "ms": k_ms, "plain_ms": p_ms, "bound": [bound],
                          "library_ms": lib_ms,
                          "library": "torch.matmul(g.T, x), f32 'highest'"}
        print(f"table_grad f32 (the f32 GEMM's TN split-K product): {k_ms:.4f} ms, {rate(k_ms)}, "
              f"plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; f32 FMA bound "
              f"{fma:.4f} ms), torch.matmul(g.T, x) f32 {lib_ms:.4f} ms ({names[0]}; "
              f"nvidia-smi: {names[1]})")
    del fwd, bwd, logits, gk, dxk, dbk, dt, x, table
    torch.cuda.empty_cache()
    return res


def phase_f32_routes(names: tuple[str, str], f32: dict) -> dict:
    """The f32 routes that the fused head's and the per-module trunk's f32
    instances open (phase 15b): (a) those kernels alone (phase_f32_head,
    and phase_sdpa_kernels in f32: #11 / #12 with their keep masks, #13 and
    its autograd); (b) F32_STEPS f32 steps each on the store, flash and
    per-module routes from the default f32 step's weights and generator
    seed (``f32``: phase_f32's result), the fused head's first loss held to
    the default route's and the per-module trunk's to its plain route's
    (its hidden dropout masks come from the generator, not the layers'
    hash); (c) each route's batch-256 loss and gradients against the f32
    plain route's; (d) a 1-epoch f32 CLI run with ``fused_head_ce='store'``
    and one with ``fused_layer='off'``, each served against the plain route."""
    import dataclasses

    import torch

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.variants import make_loss_fn

    t_phase = time.perf_counter()
    res = {"head": phase_f32_head(names), "sdpa": phase_sdpa_kernels(names, torch.float32)}

    # (b) the routes' f32 steps at batch 2048
    cfg_off = dataclasses.replace(_train_cfg(), compute_dtype="float32", fused_layer="off")
    model = init_weights(build_model(cfg_off, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # the first step's draws: a generator seeded as the step's
        plain_off = make_loss_fn(cfg_off, "train", reference=True)(
            model, _train_batch(TRAIN_BATCH), torch.Generator(device="cuda").manual_seed(SEED),
            False)[0].item()
    del model
    torch.cuda.empty_cache()
    want = {"store": f32["train"]["losses"][0]["loss_full"], "off": plain_off}
    want["flash"] = want["store"]
    tr = {}
    for route, kw in (("store", dict(head_ce="store")), ("flash", dict(head_ce="flash")),
                      ("off", dict(fused_layer="off"))):
        tr[route] = phase_train(names, steps=F32_STEPS, dtype="float32", **kw)
        first = tr[route]["losses"][0]["loss_full"]
        rel = abs(first - want[route]) / abs(want[route])
        print(f"f32 route {route}: first-step loss {first:.7f}, "
              f"{'plain per-module route' if route == 'off' else 'default f32 route'} "
              f"{want[route]:.7f}, rel {rel:.3e} (tol {F32_LOSS_REL})")
        if rel > F32_LOSS_REL:
            _fail(f"the f32 {route} route's first step is not the loss it should be")
    print(f"f32 train step by route, batch {TRAIN_BATCH}: default median "
          f"{f32['train']['median_ms']:.2f} ms, max_memory_allocated "
          f"{f32['train']['peak_gib']:.2f} GiB; " + "; ".join(
              f"{r} median {tr[r]['median_ms']:.2f} ms, max_memory_allocated "
              f"{tr[r]['peak_gib']:.2f} GiB" for r in tr) + f" ({names[0]}; nvidia-smi: "
          f"{names[1]})")

    # (c) batch-256 loss and gradients against the plain route's
    small = _train_batch(GRAD_BATCH)
    grads = {}
    for route, over, fused_head, ok in (
            ("store", dict(fused_head_ce="store"), True,
             lambda c: c["head_ce_fwd"] == c["head_ce_bwd"] == c["table_grad"] == 1
             and c["ce_fwd_ids"] == 0 and c["layer_fwd"] > 0),
            ("flash", dict(fused_head_ce="flash"), True,
             lambda c: c["head_ce_fwd"] == c["head_ce_bwd"] == c["table_grad"] == 1
             and c["ce_fwd_ids"] == 0 and c["layer_fwd"] > 0),
            ("off", dict(fused_layer="off"), False,
             lambda c: c["sdpa_fwd_self"] == c["sdpa_bwd_self"] == 24
             and c["sdpa_fwd_cross"] == c["sdpa_bwd_cross"] == 12 and c["layer_fwd"] == 0)):
        cfg = dataclasses.replace(_train_cfg(), compute_dtype="float32", **over)
        model = init_weights(build_model(cfg, device="cuda", fused_head=fused_head),
                             torch.Generator(device="cuda").manual_seed(SEED))
        grads[route] = _f32_route_vs_plain(f"Shelgon3-VQ, route {route}, at batch {GRAD_BATCH}",
                                           model, cfg, small, ok)
        del model
        torch.cuda.empty_cache()

    # (d) the CLI runs, served
    eng = {"store": phase_engine(names, "store", 1, dtype="float32"),
           "off": phase_engine(names, epochs=1, fused_layer="off", dtype="float32")}
    wall = time.perf_counter() - t_phase
    print(f"f32 routes: {wall:.1f} s ({names[0]}; nvidia-smi: {names[1]})")
    return {**res, "train": tr, "grads": grads, "engine": eng, "wall_s": wall}


# phase 16, serving export, the reference bundle and the GPT-2 analyses: the
# serving slice's run exported at bucket 256 on each route (name, fused_layer,
# compute dtype), served through ``http_server --artifact`` and held to the
# live kernel path bit for bit; the timing rounds of the live and the
# artifact forward, in turns
EXPORT_CASES = (("bf16", "auto", "bfloat16"), ("per-module", "off", "bfloat16"),
                ("f32", "auto", "float32"))
EXPORT_ROUNDS = 10


def _served_launches(fused_layer: str, dtype: str) -> dict:
    """The launches of one Shelgon3-VQ serving forward on a route."""
    want = ({"sdpa_fwd_self": 24, "sdpa_fwd_cross": 12, "vq": 1} if fused_layer == "off"
            else {"layer_fwd": 24, "vq": 1, **_inside_layers(1)})
    counts = {k: 0 for k in _counters()} | want
    return _as_f32(counts) if dtype == "float32" else counts


def _export_case(names, root: str, case: str, fused_layer: str, dtype: str, rng) -> dict:
    """One route of phase 16 (a)-(c): export, serve over HTTP, hold to the
    live path, count one artifact forward's launches, time both in turns."""
    import torch

    from kindergarten_vq_vae_torch.serve import http_server
    from kindergarten_vq_vae_torch.serve.export import export_reconstructor
    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor
    from kindergarten_vq_vae_torch.utils.profiling import benchmark_fn

    run = _write_run(os.path.join(root, case), fused_layer, dtype)
    live = Reconstructor(run, batch_buckets=(BUCKET,), device="cuda")  # pads as the artifact
    art = os.path.join(root, case, "art")
    _reset_counters()
    t0 = time.perf_counter()
    art, meta = export_reconstructor(run, bucket=BUCKET, out_path=art)
    export_s = time.perf_counter() - t0
    if any(_counters().values()):
        _fail(f"export ({case}): the trace launched a kernel: {_counters()}")
    size = os.path.getsize(art + ".pt2")
    param_bytes = sum(t.numel() * t.element_size() for t in live.model.state_dict().values())
    if size * 10 > param_bytes:
        _fail(f"export ({case}): the .pt2 ({size} bytes) is no graph alone: the parameters "
              f"take {param_bytes}")
    t0 = time.perf_counter()
    server = http_server.make_server([run, "--artifact", art, "--port", "0", "--device", "cuda"])
    load_s = time.perf_counter() - t0
    rec = server.reconstructor
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    few, many = _sentences(3, rng), _sentences(BUCKET + 44, rng)
    try:
        got = {"few": _post(port, "/reconstruct", few)["results"],
               "many": _post(port, "/reconstruct", many)["results"],
               "codes": _post(port, "/codes", few)["codes"]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        _fail("HTTP server thread did not stop")
    want = {"few": live.reconstruct(few), "many": live.reconstruct(many),
            "codes": live.codes(few)}
    if got != want or rec.buckets != (BUCKET,) or meta["device"] != "cuda":
        _fail(f"export ({case}): the artifact served over HTTP is not the live kernel path")

    ids_np, mask_np = live.tokenizer.encode_batch(_sentences(BUCKET, rng), SEQ)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    with torch.inference_mode(), _plain_refused(default_route=True):
        want_t = live.forward(ids, mask)
        torch.cuda.synchronize()
        _reset_counters()
        got_t = rec.forward(ids, mask)
        torch.cuda.synchronize()
        counts = _counters()
    _expect(f"export ({case}): one artifact forward", counts, _served_launches(fused_layer, dtype))
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got_t, want_t)):
        _fail(f"export ({case}): the artifact's ids or codes are not the live forward's")
    med = _median_forwards({"live": live, "artifact": rec}, ids, mask, EXPORT_ROUNDS)
    with torch.inference_mode():
        bench = {k: benchmark_fn(r.forward, (ids, mask), n_steps=20, warmup=2)["mean_s"] * 1e3
                 for k, r in (("live", live), ("artifact", rec))}
    print(f"export ({case}): {meta['model_name']} {meta['compute_dtype']} fused_layer="
          f"{fused_layer}, bucket {BUCKET}: exported in {export_s:.1f} s, .pt2 {size} bytes "
          f"({size / 2**20:.2f} MiB), loaded and served over HTTP in {load_s:.1f} s; "
          f"/reconstruct(3), /reconstruct({len(many)}), /codes(3) equal to the live kernel path; "
          f"one bucket-{BUCKET} forward's launches {counts}; medians in turns: live "
          f"{med['live']:.3f} ms, artifact {med['artifact']:.3f} ms; benchmark_fn means (20 "
          f"calls, one sync): live {bench['live']:.3f} ms, artifact {bench['artifact']:.3f} ms "
          f"({names[0]}; nvidia-smi: {names[1]})")
    del live, rec, server
    torch.cuda.empty_cache()
    return {"pt2_bytes": size, "export_s": export_s, "forward_ms": med,
            "benchmark_fn_ms": bench, "launches": counts, "run": run}


def _bundle_check(names, run: str) -> int:
    """(d) the reference bundle of a run, converted back by ``nn/convert_hf.py``,
    equal to the model's parameters bit for bit; returns its key count."""
    import torch

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.ckpt.export_torch import (
        export_reference_bundle,
        save_reference_bundle,
    )
    from kindergarten_vq_vae_torch.nn.convert_hf import (
        convert_decoder_state_dict,
        convert_encoder_state_dict,
    )

    cfg, model = load_run(run, device="cuda")
    bundle = export_reference_bundle(cfg, model)
    back = {"encoder": convert_encoder_state_dict(bundle["encoder_state_dict"],
                                                  model.encoder.cfg),
            "decoder": convert_decoder_state_dict(bundle["decoder_state_dict"],
                                                  model.decoder.bert.cfg)}
    ok = True
    for part, sd in back.items():
        own = getattr(model, part).state_dict()
        ok &= sd.keys() == own.keys() and all(
            torch.equal(sd[k], own[k].cpu()) for k in own)
    msd = bundle["model_state_dict"]
    ok &= torch.equal(torch.from_numpy(msd["vector_quantizer.embedding.weight"]),
                      model.vector_quantizer.codebook.detach().cpu())
    for part in ("encoder", "decoder"):
        sd = bundle[f"{part}_state_dict"]
        ok &= all(msd[f"{part}.{k}"] is v for k, v in sd.items())
    path = os.path.join(os.path.dirname(run), "bundle.pth")
    save_reference_bundle(bundle, path)
    n = sum(len(sd) for sd in bundle.values())
    print(f"export (d): the reference bundle of the bf16 run: {n} tensors "
          f"({len(msd)} in model_state_dict), {os.path.getsize(path)} bytes; converted back, "
          f"every tensor equal to the model's parameter bit for bit: {ok} ({names[0]}; "
          f"nvidia-smi: {names[1]})")
    if not ok:
        _fail("the reference bundle does not hold the model's parameters")
    del model
    return n


def _gpt2_analyses(names) -> dict:
    """(e) phase 14's Shelgon3-VQ with the GPT-2 decoder: the sentence latents
    and the disentanglement through the kernels on the cut corpus, and the
    four refusals (arithmetic modes, attention maps) before any launch."""
    import dataclasses

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.analyses import arithmetic, cross_attention
    from kindergarten_vq_vae_torch.analyses.disentanglement import unsupervised_vq_disentanglement
    from kindergarten_vq_vae_torch.analyses.latent_space import compute_sentence_latents
    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.run import load_data

    cfg = _gpt2_cfg(model_name="shelgon3")
    model = init_weights(build_model(cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(SEED)).eval()
    out = {}
    with tempfile.TemporaryDirectory(prefix="kvq_chip_gpt2_analyses_") as root:
        data_dir = os.path.join(root, "data")
        generate_dsentences(data_dir, **ENGINE_CUT)
        prepare_all(data_dir, max_length=SEQ)
        # the encoder's WordPiece splits (the analyses read no decoder ids)
        splits, tok = load_data(dataclasses.replace(
            cfg, data_dir=data_dir, decoder_model_name=RunConfig().decoder_model_name))
        test = splits["test"]
        m = min(1024, len(test))
        ids, mask = test.input_ids[:m], test.attention_mask[:m]
        with _plain_refused(default_route=True):
            _reset_counters()
            t0 = time.perf_counter()
            lat = compute_sentence_latents(model, ids, mask, batch_size=256)
            wall = time.perf_counter() - t0
            counts = _counters()
        fwd = -(-m // 256)
        want = {k: 0 for k in counts} | {"layer_fwd": 12 * fwd,
                                         **_inside_layers(0, encoder_forwards=fwd)}
        _expect(f"gpt2 analyses: sentence latents ({m} sentences)", counts, want)
        with torch.inference_mode():
            first = model.encoder(torch.from_numpy(ids[:256]).cuda(),
                                  torch.from_numpy(mask[:256]).cuda())["pooler_output"]
        same = np.array_equal(lat[:256], first.float().cpu().numpy())
        if lat.shape != (m, 768) or not np.isfinite(lat).all() or not same:
            _fail("gpt2 analyses: the sentence latents are not the encoder's pooler outputs")
        out["latents_s"] = wall

        with _plain_refused(default_route=True):
            _reset_counters()
            t0 = time.perf_counter()
            seen, hist, code_words, metrics = unsupervised_vq_disentanglement(
                cfg, model, splits, tok, results_dir=os.path.join(root, "dis"),
                batch_size=512)
            wall = time.perf_counter() - t0
            counts = _counters()
        fwd = sum(max(1, int(-(-len(v) // 512) * 0.1)) for v in splits.values())
        want = {k: 0 for k in counts} | {"layer_fwd": 12 * fwd, "vq": fwd,
                                         **_inside_layers(0, encoder_forwards=fwd)}
        _expect(f"gpt2 analyses: disentanglement ({fwd} forwards of 512)", counts, want)
        if not seen or not all(math.isfinite(v["nmi"]) for v in metrics.values()):
            _fail(f"gpt2 analyses: disentanglement gave no codes or no metrics: {seen}")
        out["disentanglement_s"] = wall

        group = {"input_ids": ids[:8], "attention_mask": mask[:8]}
        refused = []
        _reset_counters()
        for what, fn in (("bagon", arithmetic.latent_arithmetic_bagon),
                         ("conditioning", arithmetic.latent_arithmetic_shelgon_conditioning),
                         ("sentence", arithmetic.latent_arithmetic_shelgon_sentence)):
            try:
                fn(model, group, group, group, tok)
            except ValueError as e:
                refused.append(what if "GPT-2 decoder" in str(e) else f"{what}: {e}")
        try:
            cross_attention.extract_cross_attention(model, ids[:8], mask[:8])
        except ValueError as e:
            refused.append("attention maps" if "GPT-2 decoder" in str(e) else str(e))
        counts = {k: v for k, v in _counters().items() if v}
        if refused != ["bagon", "conditioning", "sentence", "attention maps"] or counts:
            _fail(f"gpt2 analyses: the refusals are amiss: {refused}, launches {counts}")
    print(f"export (e) gpt2 analyses on shelgon3-VQ with the GPT-2-small decoder: latents "
          f"{lat.shape} in {out['latents_s']:.2f} s (the first batch the encoder's pooler "
          f"outputs bit for bit), disentanglement in {out['disentanglement_s']:.2f} s, populated "
          f"codes {seen}, factor nmi { {k: round(v['nmi'], 4) for k, v in metrics.items()} }; "
          f"refused before any launch: {refused} ({names[0]}; nvidia-smi: {names[1]})")
    del model
    torch.cuda.empty_cache()
    return out


def phase_export(names: tuple[str, str]) -> dict:
    """Phase 16: (a)-(c) serving export on each route of ``EXPORT_CASES``,
    (d) the reference bundle, (e) the GPT-2 analyses; (f) the timings of
    ``utils/profiling.benchmark_fn`` beside the medians."""
    import random

    t_phase = time.perf_counter()
    rng = random.Random(SEED + 16)
    out = {}
    with tempfile.TemporaryDirectory(prefix="kvq_chip_export_") as root:
        for case, fused_layer, dtype in EXPORT_CASES:
            out[case] = _export_case(names, root, case, fused_layer, dtype, rng)
        out["bundle_keys"] = _bundle_check(names, out["bf16"]["run"])
    out["gpt2"] = _gpt2_analyses(names)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"export: {out['wall_s']:.1f} s; .pt2 sizes "
          + ", ".join(f"{c} {out[c]['pt2_bytes']} bytes" for c, _, _ in EXPORT_CASES)
          + "; bucket-256 medians live / artifact "
          + ", ".join(f"{c} {out[c]['forward_ms']['live']:.3f} / "
                      f"{out[c]['forward_ms']['artifact']:.3f} ms" for c, _, _ in EXPORT_CASES)
          + f" ({names[0]}; nvidia-smi: {names[1]})")
    return out


def _mesh_one_rank(names: tuple[str, str]) -> dict:
    """Phase 17 (a): one NCCL rank, under PyTorch's default algorithms: the
    unmeshed step run twice from the same weights, batch and seeds, and the
    meshes (1,) and (1, 1), each against the first unmeshed run, bit for
    bit. Every run is made and printed before any check fails."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.parallel.mesh import free_port, init_distributed, make_mesh
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, backend="nccl", device="cuda",
                     timeout=300.0)
    out, ref, faults = {}, None, []
    try:
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        if dist.get_backend() != "nccl" or float(one) != 1.0:
            _fail(f"the NCCL world of one: backend {dist.get_backend()}, all-reduce {one}")
        batch = _train_batch(TRAIN_BATCH)
        for what, shape, axes in (("unmeshed", None, None), ("unmeshed again", None, None),
                                  ("(1,)", (1,), ("dp",)), ("(1, 1)", (1, 1), ("dp", "tp"))):
            mesh = make_mesh(shape, axes, "cuda") if shape else None
            cfg = dataclasses.replace(_train_cfg(), fused_head_ce="auto" if mesh else "store")
            torch.cuda.empty_cache()
            model = build_model(cfg, device="cuda", fused_head=True)
            init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
            state = init_train_state(cfg, model, mesh)
            step = make_train_step(cfg, "cuda", torch.Generator(device="cuda").manual_seed(SEED),
                                   mesh=mesh)
            losses, times = [], []
            with _plain_refused():
                _reset_counters()
                for _ in range(MESH_STEPS):
                    t0 = time.perf_counter()
                    state, aux = step(state, batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(aux["loss_full"]))
                counts = _counters()
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            del state, model, step, aux
            missing = [k for k in MESH_KERNELS if counts[k] == 0]
            if missing:
                faults.append(f"mesh {what}: no launch of {missing} ({counts})")
            med = statistics.median(times[1:]) * 1e3
            run = {"losses": losses, "median_ms": med,
                   "launches": {k: counts[k] for k in MESH_KERNELS}}
            if ref is None:
                ref = (losses, params)
            differing = {n: (params[n] - ref[1][n]).abs().max().item() for n in params
                         if not torch.equal(params[n], ref[1][n])}
            run["differing_leaves"] = sorted(differing)
            out[what] = run
            print(f"mesh {what} (one NCCL rank): bert-base shelgon3-VQ, batch {TRAIN_BATCH} x "
                  f"{SEQ}, bf16, dropout 0.1, the store head, {MESH_STEPS} steps, default "
                  f"algorithms: losses {losses} (the first unmeshed run's bits: "
                  f"{losses == ref[0]}), leaves not its bits after the steps (max abs "
                  f"difference) {dict(list(differing.items())[:8])} ({len(differing)} of "
                  f"{len(params)}), median step {med:.2f} ms, launches {run['launches']} "
                  f"({names[0]}; nvidia-smi: {names[1]})")
            if losses != ref[0] or differing:
                faults.append(f"mesh {what} is off the unmeshed step's bits")
            del params
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    if faults:
        _fail("; ".join(faults))
    return out


def _mesh_gloo_worker() -> None:
    """One of phase 17 (b)'s two gloo ranks on the one card; prints its JSON
    result as its last line."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.parallel.mesh import (
        init_distributed,
        local_device,
        make_mesh,
        shard_batch,
    )
    from kindergarten_vq_vae_torch.train.step import init_train_state, make_train_step

    rank, _ = init_distributed(backend="gloo", device="cuda", timeout=300.0)
    dev = local_device("cuda")
    torch.cuda.set_device(dev)
    base = dataclasses.replace(_train_cfg(), fused_head_ce="off")  # the logits route: #7 / #8
    batch = _train_batch(MESH_BATCH)
    half = MESH_BATCH // 2

    def run(shape, axes, steps, dtype="bfloat16", rows=None):
        """``(results, first step's gradients, parameters after the steps)``;
        ``rows``: the rows of the global batch an unmeshed run takes alone;
        ``results["replicated"]``: the leaves no tp rank shards."""
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        mesh = make_mesh(shape, axes, dev) if shape else None
        model = build_model(cfg, device=dev)
        init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
        state = init_train_state(cfg, model, mesh)
        step = make_train_step(cfg, dev, torch.Generator(device=dev).manual_seed(SEED),
                               deterministic=True, mesh=mesh)
        if mesh is not None:
            local = shard_batch(mesh, batch)
        elif rows is not None:
            local = {k: v[rows] for k, v in batch.items() if k != "n_valid"}
            local["n_valid"] = rows.stop - rows.start
        else:
            local = batch
        res = {"losses": [], "ms": [], "comm_ms": []}
        grads = None
        with _plain_refused(default_route=dtype == "float32"):
            _reset_counters()
            for i in range(steps):
                if mesh is not None:
                    mesh.timed = True
                    mesh.comm_ms.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, aux = step(state, local)
                torch.cuda.synchronize()
                res["ms"].append((time.perf_counter() - t0) * 1e3)
                res["comm_ms"].append(dict(mesh.comm_ms) if mesh else {})
                res["losses"].append(float(aux["loss_full"]))
                if i == 0:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}
            counts = _counters()
        res["launches"] = {k: counts[k] for k in MESH_GLOO_KERNELS}
        res["replicated"] = [n for n, _ in model.named_parameters()
                             if not (state.shards and n in state.shards)]
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        del state, model, step
        torch.cuda.empty_cache()
        return res, grads, params

    def worst(got: dict, want: dict) -> tuple[float, list]:
        rel = sorted(((_rel_max(got[n], g), n) for n, g in want.items()), reverse=True)
        return statistics.median(r for r, _ in rel), [[n, r] for r, n in rel[:4]]

    out = {"rank": rank}
    out["dp"], dp_grads, _ = run((2,), ("dp",), MESH_GLOO_STEPS)
    # the witness: this rank's rows alone through the unmeshed step (its loss
    # over its own rows: twice its share of the global mean, exactly), summed
    # with the other rank's in f32 as the gradient all-reduce sums the shares,
    # then halved; the control leaves the other rank's out
    witness_run, own, _ = run(None, None, 1, rows=slice(rank * half, (rank + 1) * half))
    out["witness_ms"] = witness_run["ms"][0]
    leaves = sorted(own)
    flat = torch.cat([own[n].float().reshape(-1) for n in leaves])
    dist.all_reduce(flat)
    flat.mul_(0.5)
    out["witness_same_leaves"] = sorted(dp_grads) == leaves
    out["witness_differing"], out["control_equal"], off = [], [], 0
    for n in leaves:
        w = flat[off:off + own[n].numel()].view(own[n].shape).to(own[n].dtype)
        off += own[n].numel()
        if not torch.equal(dp_grads[n], w):
            out["witness_differing"].append([n, _rel_max(dp_grads[n], w)])
        if torch.equal(dp_grads[n], own[n] * 0.5):
            out["control_equal"].append(n)
    out["n_leaves"] = len(leaves)
    del own, flat
    out["dp_f32"], dp32_grads, _ = run((2,), ("dp",), 1, "float32")
    if rank == 0:
        ref, _, ref_params = run(None, None, MESH_STEPS)
        f32, f32_grads, _ = run(None, None, 1, "float32")
        out["one_process"] = {"losses": ref["losses"], "ms": ref["ms"]}
        out["one_process_f32"] = {"losses": f32["losses"], "ms": f32["ms"]}
        out["same_leaves"] = sorted(dp32_grads) == sorted(f32_grads)
        out["f32_grad_rel_median"], out["f32_grad_rel_worst"] = worst(dp32_grads, f32_grads)
        del f32_grads
    del dp_grads, dp32_grads
    dist.barrier()
    out["tp"], _, tp_params = run((1, 2), ("dp", "tp"), MESH_STEPS)
    if rank == 0:
        out["one_process_losses"] = ref["losses"]
        out["tp_differing_leaves"] = [n for n in tp_params if not torch.equal(tp_params[n],
                                                                              ref_params[n])]
    # every replicated leaf's bits on both tp ranks: rank 0's copy sent to rank 1,
    # which compares it with its own
    out["tp_ranks_differing"] = []
    for n in out["tp"]["replicated"]:
        mine = tp_params[n].cpu()
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        if not torch.equal(mine, theirs):
            out["tp_ranks_differing"].append([n, (mine - theirs).abs().max().item()])
    out["n_replicated"] = len(out["tp"].pop("replicated"))
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))


def phase_mesh(names: tuple[str, str]) -> dict:
    """Phase 17: the multi-device path on the one card."""
    import torch

    from kindergarten_vq_vae_torch.parallel.dryrun import launch

    t_phase = time.perf_counter()
    one = _mesh_one_rank(names)
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as c; "
            "c._mesh_gloo_worker()")
    t0 = time.perf_counter()
    outs = launch(2, ["-c", code], timeout=900.0)
    wall = time.perf_counter() - t0
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    r0 = ranks[0]
    ref_loss, dp_loss = r0["one_process"]["losses"][0], r0["dp"]["losses"][0]
    loss_rel = abs(dp_loss - ref_loss) / abs(ref_loss)
    for r in ranks:
        for mesh in ("dp", "dp_f32", "tp"):
            missing = [k for k in MESH_GLOO_KERNELS if r[mesh]["launches"][k] == 0]
            if missing:
                _fail(f"gloo rank {r['rank']}, mesh {mesh}: no launch of {missing}")
            if not all(math.isfinite(v) for v in r[mesh]["losses"]):
                _fail(f"gloo rank {r['rank']}, mesh {mesh}: losses {r[mesh]['losses']}")
    for r in ranks:
        for mesh, shape in (("dp", "(2,)"), ("dp_f32", "(2,) f32"), ("tp", "(1, 2)")):
            for i, (ms, comm) in enumerate(zip(r[mesh]["ms"], r[mesh]["comm_ms"])):
                share = sum(comm.values()) / ms
                print(f"mesh {shape} over gloo, rank {r['rank']} step {i}: "
                      f"{ms:.1f} ms, loss {r[mesh]['losses'][i]:.6f}, collectives "
                      f"{json.dumps({k: round(v, 3) for k, v in comm.items()})} ms "
                      f"({share:.1%} of the step), launches {r[mesh]['launches']} "
                      f"({names[0]}; nvidia-smi: {names[1]})")
        print(f"mesh (2,) over gloo, rank {r['rank']}: bf16 first-step gradients against the "
              f"witness (its 256 rows alone, {r['witness_ms']:.1f} ms, summed with the other "
              f"rank's and halved): {r['n_leaves'] - len(r['witness_differing'])} of "
              f"{r['n_leaves']} leaves the same bits, differing {r['witness_differing'][:6]}; "
              f"the control (the other rank's witness left out) gives the bits of "
              f"{len(r['control_equal'])} leaves {r['control_equal'][:6]} "
              f"({names[0]}; nvidia-smi: {names[1]})")
    f32_rel = abs(r0["dp_f32"]["losses"][0] - r0["one_process_f32"]["losses"][0]) / abs(
        r0["one_process_f32"]["losses"][0])
    print(f"mesh (2,) over gloo: first loss {dp_loss:.6f} vs one process {ref_loss:.6f} "
          f"(rel {loss_rel:.3e}, tol {MESH_LOSS_REL}); f32: {r0['dp_f32']['losses'][0]:.6f} vs "
          f"{r0['one_process_f32']['losses'][0]:.6f} (rel {f32_rel:.3e}, tol {F32_LOSS_REL}); "
          f"f32 gradients against the one-process f32 step's, rel of each leaf's largest: median "
          f"{r0['f32_grad_rel_median']:.3e}, worst {r0['f32_grad_rel_worst']} (tol {F32_GRAD}); "
          f"one-process step {r0['one_process']['ms'][0]:.1f} ms (f32 "
          f"{r0['one_process_f32']['ms'][0]:.1f}); mesh (1, 2), {MESH_STEPS} steps, default "
          f"algorithms: losses {r0['tp']['losses']} (the one-process step's "
          f"{r0['one_process_losses']}), leaves not the one-process step's bits after the "
          f"steps {r0['tp_differing_leaves']}; replicated leaves whose bits differ between the "
          f"two tp ranks (max abs difference): {ranks[1]['tp_ranks_differing']} of "
          f"{ranks[1]['n_replicated']}; two-rank launch {wall:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s ({names[0]}; nvidia-smi: {names[1]})")
    for r in ranks:
        if not r["witness_same_leaves"] or r["witness_differing"]:
            _fail(f"gloo rank {r['rank']}: the mesh's bf16 gradients are not the witness's bits")
        if len(r["control_equal"]) == r["n_leaves"]:
            _fail(f"gloo rank {r['rank']}: the control gives the witness's bits")
    if (loss_rel > MESH_LOSS_REL or f32_rel > F32_LOSS_REL or not r0["same_leaves"]
            or r0["f32_grad_rel_worst"][0][1] > F32_GRAD):
        _fail("the two-rank mesh step is off the one-process step")
    if r0["tp"]["losses"] != r0["one_process_losses"] or r0["tp_differing_leaves"]:
        _fail("the tp mesh steps are off the one-process steps")
    if any(r["tp_ranks_differing"] for r in ranks):
        _fail("the tp ranks hold replicated leaves with different bits")
    torch.cuda.empty_cache()
    return {"one_rank": one, "gloo": ranks}


def _script(name: str):
    """``scripts/<name>.py`` of this checkout, imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_data(names: tuple[str, str]) -> dict:
    """Phase 18: the data path on the card's machine. The C++ packer
    (``data/native.py``, built with g++ into ``kindergarten_vq_vae_torch/build/``
    at first use) taken, its ids and mask the Python path's bits on the
    engine's corpus; ``python -m kindergarten_vq_vae_torch.data.prepare
    --generate`` in a subprocess (the whole corpus); ``scripts/ab_engine.py``'s
    in-tree half on the engine's corpus: a CLI run, one epoch of 10 train
    steps and its val stage, its steady-state ``sentences_per_sec`` (its
    batches double-buffered: ``_prefetch``) against the bare step's on the
    same corpus, and the bare step's host synchronisations; then the same
    run with ``--set mmap=True`` (the columns memory-mapped, the splits
    lazy): the same history losses, bit for bit."""
    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.data import native
    from kindergarten_vq_vae_torch.data.dataset import _LazyRows
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import prepare_all, tokenize_corpus

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kvq_chip_data_") as root:
        data_dir = os.path.join(root, "data")
        generate_dsentences(data_dir, **ENGINE_CUT)
        art = prepare_all(data_dir, max_length=SEQ)
        sents, tok = art["sentences_clean"], art["tokenizer"]
        t0 = time.perf_counter()
        packed = native.tokenize_corpus_native(sents, tok, SEQ)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = tokenize_corpus(sents, tok, SEQ, use_native=False)
        t_python = time.perf_counter() - t0
        same = packed is not None and all(np.array_equal(a, b) for a, b in zip(packed, plain))
        print(f"data: the C++ packer taken {native.available()} ({native.LIB_PATH}), "
              f"{len(sents)} sentences in {t_native * 1e3:.1f} ms against the Python path's "
              f"{t_python * 1e3:.1f} ms, the same ids and mask {same}")
        if not (native.available() and same):
            _fail("the C++ packer is not taken or is off the Python path's bits")

        full = os.path.join(root, "full")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "kindergarten_vq_vae_torch.data.prepare",
                              "--generate", "--raw-dir", full, "--max-length", str(SEQ)],
                             cwd=ROOT, capture_output=True, text=True)
        t_prep = time.perf_counter() - t0
        line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
        print(f"data: python -m kindergarten_vq_vae_torch.data.prepare --generate: rc "
              f"{out.returncode}, {t_prep:.1f} s: {line!r}")
        ids = np.load(os.path.join(full, "dSentences_input_ids.npy"), mmap_mode="r")
        if (out.returncode != 0 or line != f"prepared 241920 unique sentences, vocab 262, "
                                             f"max_length {SEQ}" or ids.shape != (241920, SEQ)):
            _fail(f"the prepare entry point failed: {out.stderr[-2000:]}")
        del ids

        ab = _script("ab_engine")
        torch.cuda.empty_cache()
        res = ab.worker(ROOT, data_dir, 6)
        torch.cuda.empty_cache()
        engine, history = ab.cli_run(data_dir, os.path.join(root, "runs_mmap"), mmap=True)
        lazy = isinstance(engine.splits["train"].input_ids, _LazyRows)
        del engine

        def losses(h):
            return [{stage: {k: v for k, v in e[stage].items()
                             if k not in ("sentences_per_sec", "stage_wall_s")}
                     for stage in ("train", "val")} for e in h]

        same = losses(history) == losses(res["history"])
        print(f"data: the engine (batches double-buffered) at "
              f"{res['engine_sentences_per_sec']:.1f} train sentences/s against the bare step's {res['bare_sentences_per_sec']:.1f} on "
              f"the same corpus ({res['engine_over_bare']:.4f}); host synchronisations in two bare "
              f"steps {res['syncs_in_two_steps']} at {res['sync_calls']}; a run with mmap=True "
              f"(train split lazy {lazy}): history losses the mmap-off run's bits {same} (train "
              f"{history[0]['train']['loss_full']:.6f}, val {history[0]['val']['loss_full']:.6f}), "
              f"{history[0]['train']['sentences_per_sec']:.1f} sentences/s; phase "
              f"{time.perf_counter() - t_phase:.1f} s ({names[0]}; nvidia-smi: {names[1]})")
        if not (lazy and same):
            _fail("the mmap run is not lazy or its history differs from the in-memory run's")
    torch.cuda.empty_cache()
    return {k: v for k, v in res.items() if k != "history"}


def phase_twin(names: tuple[str, str]) -> dict:
    """Phase 19: ``scripts/parity_harness_torch.py``'s ``train_ours`` (the
    port's f32 Bagon, hidden 128, 2 + 2 layers, batch 64, 2 epochs on the
    harness's corpus) on the card through the kernels (the plain versions
    refused; #1, #2, #7, #8 and #14 launched, their f32 instances) and on
    the CPU: the card's val token accuracy no more than ``TWIN_GAP`` below
    the CPU's (other dropout draws and f32 sums in other orders)."""
    import torch

    h = _script("parity_harness_torch")
    train, val, vocab = h._data()
    out = {}
    with _plain_refused(default_route=True):
        _reset_counters()
        t0 = time.perf_counter()
        out["cuda"] = h.train_ours(train, val, vocab, TWIN_EPOCHS, "cuda")
        torch.cuda.synchronize()
        wall_cuda = time.perf_counter() - t0
        counts = _counters()
    t0 = time.perf_counter()
    out["cpu"] = h.train_ours(train, val, vocab, TWIN_EPOCHS, "cpu")
    wall_cpu = time.perf_counter() - t0
    steps, evals = TWIN_EPOCHS * (len(train) // h.BATCH), len(val) // h.BATCH
    launched = {k: counts[k] for k in ("layer_fwd_f32", "layer_bwd_f32", "ce_fwd_ids_f32",
                                       "ce_bwd_f32", "adam")}
    print(f"twin (scripts/parity_harness_torch.py train_ours, f32 Bagon H {h.HIDDEN}, "
          f"{h.LAYERS} + {h.LAYERS} layers, vocabulary {vocab}, {steps} steps of {h.BATCH}, "
          f"{evals} val batches): val token accuracy on the card {out['cuda']:.4f} in "
          f"{wall_cuda:.1f} s, on the CPU {out['cpu']:.4f} in {wall_cpu:.1f} s (gap "
          f"{out['cuda'] - out['cpu']:+.4f}, tol -{TWIN_GAP}); launches {launched} "
          f"({names[0]}; nvidia-smi: {names[1]})")
    want = {"layer_fwd_f32": 2 * h.LAYERS * (steps + evals), "layer_bwd_f32": 2 * h.LAYERS * steps,
            "ce_fwd_ids_f32": steps + evals, "ce_bwd_f32": steps, "adam": steps}
    if launched != want:
        _fail(f"the twin did not go through the kernels as expected: {launched}, expected {want}")
    if out["cuda"] < out["cpu"] - TWIN_GAP:
        _fail("the twin on the card is below the CPU's accuracy")
    return {**out, "wall_cuda_s": wall_cuda, "wall_cpu_s": wall_cpu}


def main() -> None:
    _require_checkout_and_card()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False

    names = phase_device()
    phase_build()
    lg = phase_layer_gemms(names)
    ln = phase_layernorm(names)
    kern = phase_kernels()
    cbg = phase_codebook_grad(names)
    tk = phase_train_kernels()
    af = phase_attention_fwd(names)
    hk = phase_head_kernels(names)
    adam = phase_adam(names)
    adam_g2 = phase_adam(names, "gpt2")
    sl = phase_slice(names)
    tr = {"auto": phase_train(names)}
    for mode in HEAD_MODES:
        tr[mode] = phase_train(names, mode, FUSED_STEPS)
        first, want = tr[mode]["losses"][0]["loss_full"], tr["auto"]["losses"][0]["loss_full"]
        rel = abs(first - want) / abs(want)
        print(f"fused head {mode}: first-step loss {first:.6f}, default path {want:.6f}, rel "
              f"{rel:.2e} (tol {HEAD_LOSS_REL}); step {tr[mode]['median_ms']:.1f} ms vs "
              f"{tr['auto']['median_ms']:.1f} ms, peak {tr[mode]['peak_gib']:.2f} GiB vs "
              f"{tr['auto']['peak_gib']:.2f} GiB ({names[0]}; nvidia-smi: {names[1]})")
        if rel > HEAD_LOSS_REL:
            _fail(f"the fused head ({mode}) changes the first step's loss")
    print("train step by fused_head_ce route, batch 2048: " + "; ".join(
        f"{m} median {tr[m]['median_ms']:.2f} ms, max_memory_allocated {tr[m]['peak_gib']:.2f} GiB"
        for m in ("auto", *HEAD_MODES)) + f" ({names[0]}; nvidia-smi: {names[1]})")
    phase_grads()
    eng = phase_engine(names)
    eng_store = phase_engine(names, "store", 1)
    sk = phase_sdpa_kernels(names)
    tr["off"] = phase_train(names, steps=FUSED_STEPS, fused_layer="off")
    print(f"per-module trunk (fused_layer 'off'): step {tr['off']['median_ms']:.1f} ms "
          f"({TRAIN_BATCH * 1e3 / tr['off']['median_ms']:.1f} sentences/s) vs "
          f"{tr['auto']['median_ms']:.1f} ms ({TRAIN_BATCH * 1e3 / tr['auto']['median_ms']:.1f} "
          f"sentences/s) on the fused layers, peak {tr['off']['peak_gib']:.2f} GiB vs "
          f"{tr['auto']['peak_gib']:.2f} GiB, first-step loss "
          f"{tr['off']['losses'][0]['loss_full']:.6f} "
          f"vs {tr['auto']['losses'][0]['loss_full']:.6f} ({names[0]}; nvidia-smi: {names[1]})")
    serve_off = phase_serve_per_module(names)
    eng_off = phase_engine(names, epochs=1, fused_layer="off")
    phase_research(names)
    phase_variants(names, tr["auto"]["median_ms"])
    g2 = phase_gpt2(names, tr["auto"]["median_ms"])
    f32 = phase_f32(names)
    f32r = phase_f32_routes(names, f32)
    phase_export(names)
    phase_mesh(names)
    phase_data(names)
    phase_twin(names)
    lo = phase_long(names)
    wd = phase_wide(names)
    n = tr["auto"]["counts"]
    n32 = f32["train"]["counts"]
    off = tr["off"]["counts"]
    src, tpu = "kindergarten_vq_vae_torch/csrc/", "kindergarten_vq_vae_tpu/ops/"

    def row(name, source, replaces, launches, m):
        bound_ms = statistics.mean(b[0] for b in m["bound"])
        bound_by = {b[1] for b in m["bound"]}
        return {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
                "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
                "library_ms": m.get("library_ms"), "library": m.get("library")}

    # serving rows: per call at bucket 256, the mean of one encoder-geometry and
    # one decoder-geometry layer, launches from the HTTP run; the layer GEMM's
    # rows: the mean call over the step's products at batch 2048 (forward; data
    # and weight gradients), launches from the training slice's run; training rows: at
    # batch 2048, launches from the training slice's run (the fused head's from
    # its own mode's run, #6's from the fused_ce_loss run, #11 / #12's from the
    # per-module trunk's run, #13's from its own autograd run); amsgrad_update:
    # over the whole parameter list, launches from the training entry point's run
    table = {"kernels": [
        row("fused_bert_layer", "layer_fwd.cu", "layer_pallas.py:489", sl["launches"]["layer"],
            kern["layer"]),
        row("vector_quantize_kernel", "vq_fwd.cu", "vq_pallas.py:41", sl["launches"]["vq"],
            kern["vq"]),
        row("layer_forward (training mode)", "layer_fwd.cu", "layer_pallas.py:489",
            n["layer_fwd"], tk["layer_fwd"]),
        row("layer_backward", "layer_bwd.cu", "layer_pallas.py:552", n["layer_bwd"],
            tk["layer_bwd"]),
        *[row(f"attention_forward in layer_forward ({kind})", "attention.cuh",
              "layer_pallas.py:244", n[f"attn_fwd_{kind}"], af[kind]) for kind in ("self", "cross")],
        row("attention_backward (self)", "layer_bwd.cu", "layer_pallas.py:696",
            n["attn_bwd_self"], tk["attn_bwd_self"]),
        row("attention_backward (cross)", "layer_bwd.cu", "layer_pallas.py:712",
            n["attn_bwd_cross"], tk["attn_bwd_cross"]),
        row("vector_quantize_kernel (training)", "vq_fwd.cu", "vq_pallas.py:41", n["vq"],
            tk["vq"]),
        row("codebook_grad", "vq_bwd.cu", "vq_pallas.py:178", n["codebook_grad"], cbg),
        row("ce_fwd", "ce.cu", "ce_pallas.py:34", tk["ce_loss_launches"]["ce_fwd"], tk["ce_fwd"]),
        row("ce_fwd_ids", "ce.cu", "ce_pallas.py:63", n["ce_fwd_ids"], tk["ce_fwd_ids"]),
        row("ce_bwd", "ce.cu", "ce_pallas.py:104", n["ce_bwd"], tk["ce_bwd"]),
        *[row(f"head_ce_fwd ({m})", "head_ce.cu", "head_ce_pallas.py:67",
              tr[m]["counts"]["head_ce_fwd"], hk[f"fwd_{m}"]) for m in HEAD_MODES],
        *[row(f"head_ce_bwd ({m})", "head_ce.cu", "head_ce_pallas.py:179",
              tr[m]["counts"]["head_ce_bwd"], hk[f"bwd_{m}"]) for m in HEAD_MODES],
        row("amsgrad_update", "adam.cu", "adam_pallas.py:46", eng["adam"], adam),
        *[row(f"sdpa_forward ({kind})", "sdpa.cu", "sdpa_pallas.py:103", off[f"sdpa_fwd_{kind}"],
              sk[f"fwd_{kind}"]) for kind in ("self", "cross")],
        *[row(f"sdpa_backward ({kind})", "sdpa.cu", "sdpa_pallas.py:142", off[f"sdpa_bwd_{kind}"],
              sk[f"bwd_{kind}"]) for kind in ("self", "cross")],
        row("mha_forward", "sdpa.cu", "attention_pallas.py:65", sk["mha_launches"], sk["mha"]),
        row("layer GEMM, forward products (in layer_forward)", "gemm_sm90.cuh",
            "layer_pallas.py:489", n["gemm_in_fwd"], lg["fwd"]),
        row("layer GEMM, gradient products (in layer_backward)", "gemm_sm90.cuh",
            "layer_pallas.py:552", n["gemm"] - n["gemm_in_fwd"], lg["grad"]),
        row("residual_layernorm", "layernorm.cu", "layer_pallas.py:489", n["ln_fwd"], ln["ln_fwd"]),
        row("layernorm_backward", "layernorm.cu", "layer_pallas.py:552", n["ln_bwd"],
            ln["ln_bwd"]),
        row("column_sums", "layernorm.cu", "layer_pallas.py:552", n["colsum"], ln["colsum"]),
        *[row(f"{k} (GPT-2 decoder, vocabulary {GPT2_VOCAB})", "ce.cu", f"ce_pallas.py:{line}",
              g2["bagon-gpt2"]["counts"][k], g2["ce"][k])
          for k, line in (("ce_fwd_ids", 63), ("ce_bwd", 104))],
        row("amsgrad_update (GPT-2 decoder's parameter list)", "adam.cu", "adam_pallas.py:46",
            g2["bagon-gpt2"]["counts"]["adam"], adam_g2),
        # the f32 instances: launches from the f32 step's run (F32_STEPS steps),
        # #6's from its fused_ce_loss run, the GPT-2 vocabulary's from the
        # Bagon-GPT-2 kernel-route loss
        row("layer GEMM f32, forward products (in layer_forward)", "gemm_f32.cu",
            "layer_pallas.py:489", n32["gemm_in_fwd"], f32["gemm_fwd"]),
        row("layer GEMM f32, gradient products (in layer_backward)", "gemm_f32.cu",
            "layer_pallas.py:552", n32["gemm_f32"] - n32["gemm_in_fwd"], f32["gemm_grad"]),
        row("layer_forward f32 (training mode)", "layer_fwd.cu", "layer_pallas.py:489",
            n32["layer_fwd_f32"], f32["layer_fwd"]),
        row("layer_backward f32", "layer_bwd.cu", "layer_pallas.py:552", n32["layer_bwd_f32"],
            f32["layer_bwd"]),
        *[row(f"attention_forward f32 in layer_forward ({kind})", "attention_f32.cuh",
              "layer_pallas.py:244", n32[f"attn_fwd_{kind}"], f32[f"attn_fwd_{kind}"])
          for kind in ("self", "cross")],
        row("attention_backward f32 (self)", "attention_f32.cuh", "layer_pallas.py:696",
            n32["attn_bwd_self"], f32["attn_bwd_self"]),
        row("attention_backward f32 (cross)", "attention_f32.cuh", "layer_pallas.py:712",
            n32["attn_bwd_cross"], f32["attn_bwd_cross"]),
        row("residual_layernorm f32", "layernorm.cu", "layer_pallas.py:489", n32["ln_fwd_f32"],
            f32["ln_fwd"]),
        row("layernorm_backward f32", "layernorm.cu", "layer_pallas.py:552", n32["ln_bwd_f32"],
            f32["ln_bwd"]),
        row("column_sums f32", "layernorm.cu", "layer_pallas.py:552", n32["colsum_f32"],
            f32["colsum"]),
        row("ce_fwd f32", "ce.cu", "ce_pallas.py:34", f32["ce_loss_launches"]["ce_fwd_f32"],
            f32["ce_fwd"]),
        row("ce_fwd_ids f32", "ce.cu", "ce_pallas.py:63", n32["ce_fwd_ids_f32"],
            f32["ce_fwd_ids"]),
        row("ce_bwd f32", "ce.cu", "ce_pallas.py:104", n32["ce_bwd_f32"], f32["ce_bwd"]),
        *[row(f"{k} f32 (GPT-2 decoder, vocabulary {GPT2_VOCAB})", "ce.cu",
              f"ce_pallas.py:{line}", f32["gpt2"]["counts"][f"{k}_f32"], f32[f"{k}_gpt2"])
          for k, line in (("ce_fwd_ids", 63), ("ce_bwd", 104))],
        # the f32 routes: launches from each route's f32 step run (F32_STEPS
        # steps), #13's from its own autograd run
        *[row(f"head_ce_fwd f32 ({m})", "gemm_f32.cu", "head_ce_pallas.py:67",
              f32r["train"][m]["counts"]["head_ce_fwd_f32"], f32r["head"][f"fwd_{m}"])
          for m in HEAD_MODES],
        *[row(f"head_ce_bwd f32 ({m})", "head_ce.cu" if m == "store" else "gemm_f32.cu",
              "head_ce_pallas.py:179", f32r["train"][m]["counts"]["head_ce_bwd_f32"],
              f32r["head"][f"bwd_{m}"]) for m in HEAD_MODES],
        row("table_grad f32", "gemm_f32.cu", "head_ce_pallas.py:365",
            f32r["train"]["store"]["counts"]["table_grad_f32"], f32r["head"]["d_table"]),
        *[row(f"sdpa_forward f32 ({kind})", "attention_f32.cuh", "sdpa_pallas.py:103",
              f32r["train"]["off"]["counts"][f"sdpa_fwd_{kind}"], f32r["sdpa"][f"fwd_{kind}"])
          for kind in ("self", "cross")],
        *[row(f"sdpa_backward f32 ({kind})", "attention_f32.cuh", "sdpa_pallas.py:142",
              f32r["train"]["off"]["counts"][f"sdpa_bwd_{kind}"], f32r["sdpa"][f"bwd_{kind}"])
          for kind in ("self", "cross")],
        row("mha_forward f32", "attention_f32.cuh", "attention_pallas.py:65",
            f32r["sdpa"]["mha_launches"], f32r["sdpa"]["mha"]),
        # the general paths (phase 20): the VQ's and the codebook gradient's
        # launches from the vq_n_e 512 step's run, the layer attention's from
        # the 64-token steps' runs (bf16, f32), #11 / #12 / #13's from their
        # own autograd runs at 64 tokens
        row(f"vector_quantize_kernel (general path: 3xTF32 screen on gemm_f32_kernel, "
            f"vq_pick_kernel recheck, vq_grouped_sum_kernel sums; {LONG_CODES} codes, training)",
            "vq_fwd.cu", "vq_pallas.py:41", lo["train_codes"]["counts"]["vq"], lo["vq"]),
        row(f"codebook_grad (grouped sums: vq_group_scatter_kernel, vq_grouped_sum_kernel; "
            f"{LONG_CODES} codes)", "vq_bwd.cu", "vq_pallas.py:178",
            lo["train_codes"]["counts"]["codebook_grad"], lo["codebook_grad"]),
        *[row(f"attention_forward{f} in layer_forward, {LONG_SEQ} tokens ({kind})",
              "attention_long.cu", "layer_pallas.py:244",
              lo[tr_key]["counts"][f"attn_fwd_{kind}"], lo[a_key][f"fwd_{kind}"])
          for f, tr_key, a_key in (("", "train_seq", "attn"), (" f32", "train_seq_f32", "attn_f32"))
          for kind in ("self", "cross")],
        *[row(f"attention_backward{f}, {LONG_SEQ} tokens ({kind})", "attention_long.cu",
              f"layer_pallas.py:{line}", lo[tr_key]["counts"][f"attn_bwd_{kind}"],
              lo[a_key][f"bwd_{kind}"])
          for f, tr_key, a_key in (("", "train_seq", "attn"), (" f32", "train_seq_f32", "attn_f32"))
          for kind, line in (("self", 696), ("cross", 712))],
        *[row(f"sdpa_{d}{f}, {LONG_SEQ} tokens ({kind})", "attention_long.cu",
              f"sdpa_pallas.py:{line}", lo[a_key]["sdpa_launches"][f"sdpa_{d}_{kind}"],
              lo[a_key][f"sdpa_{d}_{kind}"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))
          for d, line in (("fwd", 103), ("bwd", 142)) for kind in ("self", "cross")],
        *[row(f"mha_forward{f}, {LONG_SEQ} tokens", "attention_long.cu",
              "attention_pallas.py:65", lo[a_key]["mha_launches"], lo[a_key]["mha_self"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))],
        # the wide paths (phase 21): the LayerNorm's rows past 1,024 at (3,072,
        # 1,280), launches from the gpt2-large step's run (bf16) and its
        # BERT-decoder twin's (f32); the attention's heads past 128 at head_dim
        # 192 x (2048, 12), launches from the head_dim-192 steps' runs (bf16,
        # f32), #11 / #12 / #13's from their own autograd runs
        *[row(f"residual_layernorm{f}, rows of {WIDE_LN_TABLE[1]} (a block a row)",
              "layernorm.cu", "layer_pallas.py:164", wd[t_key]["counts"]["ln_fwd_wide"],
              wd["ln"][f"ln_fwd_{d}"])
          for f, d, t_key in (("", "bf16", "train_large"), (" f32", "f32", "train_twin_f32"))],
        *[row(f"layernorm_backward{f}, rows of {WIDE_LN_TABLE[1]} (a block a row)",
              "layernorm.cu", "layer_pallas.py:175", wd[t_key]["counts"]["ln_bwd_wide"],
              wd["ln"][f"ln_bwd_{d}"])
          for f, d, t_key in ((" (gy bf16)", "gy_bf16", "train_large"),
                              (" (gy f32)", "gy_f32", "train_large"),
                              (" f32", "f32", "train_twin_f32"))],
        *[row(f"attention_forward{f} in layer_forward, head_dim {WIDE_ATTN_TABLE[0]} ({kind})",
              "attention_long.cu", "layer_pallas.py:244",
              wd[t_key]["counts"][f"attn_fwd_{kind}"], wd[a_key][f"fwd_{kind}"])
          for f, t_key, a_key in (("", "train_hd", "attn"), (" f32", "train_hd_f32", "attn_f32"))
          for kind in ("self", "cross")],
        *[row(f"attention_backward{f}, head_dim {WIDE_ATTN_TABLE[0]} ({kind})",
              "attention_long.cu", f"layer_pallas.py:{line}",
              wd[t_key]["counts"][f"attn_bwd_{kind}"], wd[a_key][f"bwd_{kind}"])
          for f, t_key, a_key in (("", "train_hd", "attn"), (" f32", "train_hd_f32", "attn_f32"))
          for kind, line in (("self", 696), ("cross", 712))],
        *[row(f"sdpa_{d}{f}, head_dim {WIDE_ATTN_TABLE[0]} ({kind})", "attention_long.cu",
              f"sdpa_pallas.py:{line}", wd[a_key]["sdpa_launches"][f"sdpa_{d}_{kind}"],
              wd[a_key][f"sdpa_{d}_{kind}"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))
          for d, line in (("fwd", 103), ("bwd", 142)) for kind in ("self", "cross")],
        *[row(f"mha_forward{f}, head_dim {WIDE_ATTN_TABLE[0]}", "attention_long.cu",
              "attention_pallas.py:65", wd[a_key]["mha_launches"], wd[a_key]["mha_self"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))],
        # the same heads at 512 tokens (WIDE_ATTN_LONG): #11 / #12 / #13, their
        # launches from their own autograd runs there
        *[row(f"sdpa_{d}{f}, head_dim {WIDE_ATTN_LONG[0]}, {WIDE_ATTN_LONG[1]} tokens ({kind})",
              "attention_long.cu", f"sdpa_pallas.py:{line}",
              wd[a_key]["sdpa_launches_512"][f"sdpa_{d}_{kind}"], wd[a_key][f"sdpa_{d}_{kind}_512"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))
          for d, line in (("fwd", 103), ("bwd", 142)) for kind in ("self", "cross")],
        *[row(f"mha_forward{f}, head_dim {WIDE_ATTN_LONG[0]}, {WIDE_ATTN_LONG[1]} tokens",
              "attention_long.cu", "attention_pallas.py:65", wd[a_key]["mha_launches_512"],
              wd[a_key]["mha_self_512"])
          for f, a_key in (("", "attn"), (" f32", "attn_f32"))],
    ]}
    print(f"engine launches, default run {eng}, store run {eng_store}, per-module run {eng_off}; "
          f"serving forward ms {serve_off['forward_ms']}")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
