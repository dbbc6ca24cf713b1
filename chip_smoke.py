#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chambers_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. In order, it:

1. prints the card's name and power limit;
2. builds the two CUDA libraries (``warp`` with ``--fmad=false``,
   ``flash_attention`` with FMAs, from its three sources and their header)
   from ``chambers_tpu_torch/ops/csrc`` with nvcc, both at once;
3. holds kernel K2 (the separable warp) bit-equal to its plain PyTorch
   version at ``[32, 224, 224, 3]``;
4. holds kernel K1 (the fused RandAugment round) bit-equal to its plain
   version with all five op classes, at magnitudes 10 and 9 and with
   per-image factors;
5. holds RandAugment(2, 10)'s two compositions (fused over K1, masked over
   K2) bit-equal on the same draws;
6. drives the main path — per-image RandAugment(2, 10) into ViT-B/16 in
   bf16 with bf16 scores, batch 32 at 224 px, random seeded weights, three
   timed runs of 20 steps — and
   the masked-composition path, each with the launch counters set to 0
   just before and read just after; checks the logits against float32
   references, times the steps with CUDA events and profiles three steps;
7. times K1, K2, their plain versions, their wrapper calls and a device
   ``copy_`` of the same image bytes at the main path's shapes;
8. holds the flash attention kernels K3a (forward), K3b (dK/dV) and K3c
   (dQ) against their plain versions, through ``flash_attention`` and its
   backward as the paths call them, at the train step's three uses
   (``[16, 8, 512, 64]`` bf16 with a ragged key mask, causal and not),
   ViT-B/16's shape, DeiT-B/16's 198 x 198 with no mask, cross lengths
   130 x 260 and 260 x 130 with the diagonal at the end, 63 x 65, 257 x
   257 and 70 x 150 with key masks, one
   key, one query against 300 keys, and a batch item with no valid key, in
   bf16 (the tensor-core kernels) and in float32 (the FMA ones), and the
   edges of K3b's short kernel (causal 120 x 250 and 200 x 136, one query
   against 200 keys, 193 x 193, 198 x 198 in float16), and the narrow
   kernels' edges at head sizes 8, 16 and 32 in bf16 and float16 (one key,
   one query against 300 keys, 198 x 198, causal cross lengths both ways,
   a batch item with no valid key); two
   launches of each kernel must give the same bits, the profiler must show
   the short tensor-core forward for bf16 at 96 tokens, the whole-tile one
   at 300, the narrow one for float16 at h 32 and the FMA one for float32,
   and the
   two matrix products the bf16 backward is built from are held alone
   against ``torch.matmul``;
9. drives the second main path — the padded ``Seq2SeqTransformer`` train
   step with ``attention_impl="flash"`` at full width (vocabulary 1024,
   width 512, 8 heads, 4 + 4 layers, bf16, batch 16, lengths 512, 20-30%
   ragged padding, AdamW): first step's loss and logits against the dense
   attention path, 2 warm-up steps and three timed runs of 5 steps with
   the launch counters set to 0 just before and read just after, and a
   profile of two steps;
10. runs a ViT-B/16-wide, 2-layer ``VisionTransformer`` on the flash kernel
    against the dense path in float32;
11. times K3a-c at ``[128, 512, 64]`` bf16 beside their plain versions and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
    and their float32 instances (the FMA kernels) once;
12. (a) serves ``bench.py``'s config 1 through int8 PTQ: ViT-B/16 in bf16
    with bf16 scores, seed 0, the normalization folded and then
    ``quantize_model``, behind RandAugment(2, 10), batch 32 at 224 px,
    three timed runs of 20 steps in turns with the same bf16 model; checks
    the int8 logits against the bf16 ones (relative L2 under 0.05, the JAX
    package's envelope), every int8 product, quantize pass and QuantDense
    layer of a float32 int8 model on the card bit-equal to the CPU's on the
    card's own operands, and profiles both with device time by kind
    (quantize passes, ``_int_mm``, attention core, other);
13. (b) drives AutoAugment into ViT-L/16 at 384 px, batch 128, 24 layers,
    in bf16 with bf16 scores and then in int8: the fused (K1) and masked
    (K2) compositions bit-equal at ``[128, 384, 384, 3]``, logits of 8
    images at the phase-6 gate of a float32 reference, 2 warm-up steps and
    three timed runs of 5 steps, peak memory, profiles;
14. (c) holds K1 and K2 bit-equal to their plain versions at ``[128, 384,
    384, 3]``, pad 48, on both stages of a real AutoAugment draw (K1 on
    the stage's classes and with every image a WARP, K2 on the stage's
    matrices), then times K1 (on a stage's class mix) and K2 there, 56.6
    MB each way, against their bytes bound and a device ``copy_``;
15. (d) holds ``quantization.int_mm`` exact against the int32 product at
    every int8 shape of the two paths, in both weight layouts, and times
    it against the int8 bound and a bf16 ``torch.matmul``;
16. decodes 128 tokens for the 16 sources of phase 9 on the same model in
    eval mode (bf16, flash) through the decode cache, greedy, beam (4,
    EOS 2, length penalty 0.6) and sampled (T 0.8, top-k 50, top-p 0.9):
    a cached greedy call launches K3a 4 + 8 x 128 times (the encoder once,
    4 self and 4 cross steps a token, tallied by shape); in float32 (the
    FMA kernels) cached greedy and beam tokens equal full recompute over 16
    steps; the first cached step's bf16 logits follow the full-length
    decoder's at position 0; each mode's ms per decoded token, tokens/s,
    device time a step by kind, launches a step and peak memory;
17. holds K3a at one query row to its plain version at the cached step's
    two shapes (q ``[128, 1, 64]`` against k/v ``[128, 512, 64]`` with the
    ragged source mask, and ``[128, 128, 64]`` half written) and times it
    against its bound and SDPA with the same mask;
18. runs ``bench.py``'s config 4, uncut: the ViT-S/16 embedder in bf16
    with bf16 scores, batch 256 of seeded float32 224 px images, labels
    ``arange(256) % 64``, ``MultiSimilarityLoss`` on ``l2_normalize(z)``
    and the port's ``AdamW(weight_decay=1e-4, learning_rate=1e-3,
    decay_exclude=["bias", "norm"])``: the decayed parameters equal the
    JAX package's (listed as data), the first loss is finite and within 5%
    of the same step in float32, one AdamW update of every parameter
    equals a float64 recomputation to 1e-6; ms/step, img/s, device time by
    kind, busy share and peak memory;
19. runs ``bench.py``'s config 5, uncut: DETR (6 + 6 layers, width 256,
    8 heads, MLP 2048, 100 queries, 91 classes) in bf16 at batch 8 of 224
    px images with 20 target slots drawn from ``RandomState(0)`` in
    ``bench.py``'s order, ``deterministic=True``, the loss summed over the
    6 decoder layers and the port's ``AdamW(weight_decay=1e-4,
    learning_rate=1e-4, decay_exclude=["bias", "norm"])``, each step
    adding ``1e-4 * i`` to the input, in the three matcher modes of
    ``BENCH_DETR_MATCHER``: the ε-auction on the card, a Hungarian
    assignment computed once outside the timed steps, and scipy's
    Hungarian matcher on every step. Checks the decayed parameters against
    the JAX package's (listed as data), the first loss against the same
    step in float32 (within 5%), and on one step's ``[48, 20, 100]`` costs
    the card's auction against its CPU run (equal), its columns (distinct)
    and its totals (within ``n·eps`` of scipy's optimum); for each mode
    ms/step, img/s, device time by phase (matcher, forward and loss,
    backward, optimizer), launches, busy share, the auction's iterations
    on the step's costs and peak memory;
20. runs the DeiT recipe's train step at DeiT-B/16's widths (patch 16,
    width 768, 12 layers, 12 heads, MLP 3072, 1000 classes) in bf16,
    batch 128 of seeded uint8 224 px images, labels ``arange(128) %
    1000``, whole-batch RandAugment(2, 9) (drawn on a host generator) and
    the 'tf' normalization, the port's ``AdamW(weight_decay=0.05,
    decay_exclude=["bias", "norm", "cls", "dist"])`` under
    ``LinearWarmup(CosineDecay(5e-4), 2)``, in two modes whose timed runs
    take turns: ``recipe`` (``mixup_or_cutmix`` of MixUp(0.8) and
    CutMix(1.0) with label smoothing 0.1, a ViT on dense attention with
    bf16 scores, categorical cross-entropy on the soft labels) and
    ``distilled`` (a ``DistilledVisionTransformer`` on the flash kernels,
    K3a-c 12 times a step each at ``[1536, 198, 64]``, hard distillation
    from a frozen bf16 ViT-B/16, top-1 and top-5 accuracies streamed on
    the card). Checks the augmentation on the card against its CPU run
    (each of the 16 ops forced, bilinear Rotate and Shear bit for bit,
    ``mixup_or_cutmix`` within 1e-6 in both branches), the decayed sets
    against the JAX package's (listed as data), each first loss against
    float32 (within 5%), the distilled flash step against dense attention
    (loss within 1e-2, gradients at cosine >= 0.99), K3a-c's launches and
    the streamed accuracies against a CPU recomputation; for each mode
    ms/step, img/s, device time by phase (augmentation, teacher, forward
    and loss, backward, optimizer), the attention core's device time,
    launches, busy share and peak memory. K3a runs
    ``flash_fwd_short_kernel`` and K3b ``flash_bwd_dkv_short_kernel``
    there, their 12 launches a step each counted by kernel over the timed
    steps. Then times K3a-c at ``[1536, 198, 64]`` bf16 with no mask beside
    their bounds and ``F.scaled_dot_product_attention``, and K3a and K3b at
    phase 25 (c)'s served ``[384, 197, 64]``;
21. (a) serves uint8 ``[64, 224, 224, 3]`` from a seed in bf16, each
    model behind its own ``preprocess_input``, through ResNeXt-50 (top,
    softmax over 1000 classes), SE-ResNeXt-50 (top) and BN-Inception
    (``with_pooling(..., "avg")``, the 1024-d descriptor), seeded random
    weights: each float32 model on the card against the same weights on
    the CPU (4 images; softmax within 1e-5, the descriptor within 1e-4 of
    its largest magnitude), bf16 features against float32 (cosine >=
    0.98); the models' timed runs in turns, ms/batch, img/s, device time
    by kind (convolution, BatchNorm, pooling, GEMM, other elementwise),
    launches, busy share, peak memory and the bf16 bound from the counted
    operations. (b) runs the train step of
    ``examples/train_cnn_classifier.py`` at full width: SE-ResNet-50, 224
    px, 1000 classes, batch 64, bf16, BatchNorm in train mode, the
    example's cross-entropy over softmax outputs and ``SGDW(1e-4,
    LinearWarmup(0.01, 5), momentum 0.9, decay_exclude=["bias",
    "scale"])``: the decayed set (the conv and dense kernels), the first
    loss against float32 (5%), one float32 step at batch 8 on the card
    against the CPU (loss within 1e-5 relative, the running statistics
    within 1e-4), the statistics moving; ms/step, img/s, device time by
    phase, launches, busy share and peak memory;
22. runs the mixture-of-experts paths. (a) ``tools/bench_moe.py``'s cell:
    the ViT-S/16 (patch 16, width 384, 12 layers, 6 heads, MLP 1536,
    dropout 0, no head, CLS pooling) in bf16 at batch 32 of seeded 224 px
    inputs, dense and with every second MLP routed over 8 experts, top-1
    and top-2: the forward and the train step (mean squared features plus
    ``moe_aux_loss``, ``p -= 1e-3·g``), each variant's runs in turns, with
    parameters, ms/step, img/s, the ratio to dense, launches, busy share,
    peak memory and device time by routed stage (router and top-k,
    building dispatch and combine, the dispatch product, the experts, the
    combine product); a float32 top-2 ``MoEMLP`` at these widths on
    ``[6304, 384]`` against its CPU run (routing equal but on near-ties,
    outputs within 1e-5), the pooled float32 top-2 features against the
    CPU's (cosine >= 0.999), the top-2 step with ``remat`` against without
    (loss and gradients within 1e-6 relative, less peak memory), and the
    int8 top-2 model: its expert products and banks bit-equal to the CPU's
    on the card's own operands, its forward timed beside bf16's. (b) the
    GShard setting on phase 9's train step: every second layer of both
    stacks routed, top-2 of 8, on the flash kernels (K3a-c 12 launches
    each a step), masked cross-entropy plus the aux loss, the port's
    AdamW(1e-4, weight decay 1e-4): the first loss against dense
    attention (1%), 2 warm-ups, three timed runs of 5 steps, a profile
    by phase and routed stage, and greedy decoding of 16 tokens by full
    recompute in float32, its tokens equal to the CPU's;
23. drives the training harness through the user's entry points. (a)
    phase 9's seq2seq step through ``Trainer.fit``: the first 3 losses
    against phase 9's hand-written step on the same batches and init
    (``torch.optim.AdamW``, constant rate, ``spe=1``, no EMA); K3a-c 12
    launches each a step under ``fit``, counted from 0 just before and
    read just after; the harness's config (the port's AdamW under
    ``LinearWarmup(1e-4, 4)``, EMA 0.999, a streamed token accuracy,
    validation on 1 batch, ``ExperimentCallback``) at
    ``steps_per_execution=4`` bit-equal to ``1``; SIGTERM mid-epoch, the
    checkpoint restored into a fresh Trainer and resumed with
    ``initial_epoch``/``skip_batches``, bit-equal to the uninterrupted run;
    the CSV and event files read back; ms/step and tokens/s of ``spe`` 1
    and 4 and the hand-written step in turns, launches, busy share, peak
    memory, checkpoint size and save and restore seconds. (b) ``bench.py``'s
    config 4 through ``Model(vit).compile/fit`` on uint8 host batches of
    256: the first 3 losses against phase 18's hand-written step, ms/step
    at N = 1 and 4 against it in turns, the share of the host -> device
    copy the prefetcher hides, ``evaluate`` and ``predict``. (c) LoRA
    rank 8 on ViT-B/16 b32 bf16, 3 steps: the backbone bit-equal to its
    start, the adapters and head moved, the optimizer state the adapters'
    and head's only, ``merge_lora``'s forward against the adapted one;
    ms/step and peak memory against a full fine-tune in turns;
24. drives the host data pipeline (``chambers_tpu_torch.data``) into
    config 4's step through ``Trainer.fit``, as
    ``examples/train_metric_learning.py`` does: the ViT-S/16 embedder in
    bf16, ``apply_fn`` = per-image RandAugment(2, 9) on the card (K1, two
    launches a step) -> 'tf' normalization -> the ViT -> ``l2_normalize``,
    the MS loss and the port's AdamW under ``LinearWarmup``. 1024 seeded
    uint8 224 px images of 64 classes go through ``dataset_to_tfrecord``
    (154 MB, the native CRC32C built with g++) and come back through
    ``tfrecord_to_dataset`` -> ``shuffle(1024, seed=42)`` -> ``repeat``
    -> ``batch(256)`` -> ``prefetch``. Checks the round trip bit for bit,
    the seed's stream twice the same bytes, each epoch's batches every
    image once, the first loss of ``fit`` from the file bit-equal to the
    same step fed the same batch from memory, K1's launches under
    ``fit``; times the pipeline alone through ``device_prefetch``, ``fit``
    from the file against the same batches from memory in turns, with the
    busy share, launches a step and the share of the pipeline's work
    hidden. The image-folder leg (a P×K JPEG folder through the native
    decoder) needs libjpeg's headers and library, which the H100 machine
    lacks (PERF.md §4), and is not in the script;
25. serves and scales out (``scale_out_path``, in ``build/phase25``). (a)
    ``bench.py``'s config-1 ViT-B/16 (bf16, bf16 scores, the normalization
    folded, seed 0, dense attention) exported with a dynamic batch
    (``serving.export_serving_artifact``), the file's size and the export
    time, and reloaded by a fresh interpreter that imports only torch and
    numpy: its logits at batches 1, 4 and 32 against the eager module's
    (bit-equal expected, held to 2% of the logit range); (b)
    ``HTTPModelServer(batch_size=32, max_delay_ms=5)`` on the reloaded
    artifact: 256 single-image ``.npy`` requests from 64 client threads,
    then 8 JSON ones, every row against the eager model's, ``/stats``
    counting 264; requests/s and client-side p50/p90/p99 of each round,
    batches, padded rows and the artifact's device time a batch beside
    phase 6's model-only time; (c) the same weights on the flash kernels
    exported through the K3a operator (12 in the program) and served by
    ``BatchedServer``: 12 ``flash_fwd_short_kernel`` launches a batch (the
    counters and the profiler) and that kernel's device time a batch, its
    logits against the eager flash model
    and the dense one. Then, after ``init_distributed`` over NCCL at world
    size 1: (d) phase 9's step through ``Trainer(mesh=create_mesh({"data":
    1, "model": 1}), param_sharding_rules=SEQ2SEQ_TENSOR_PARALLEL_RULES)``
    against the meshless ``fit`` (first 3 losses; ms/step in turns,
    kernels, launches, busy share; K3a-c 12 a step); (e)
    ``context_parallel_attention`` at ``[16, 8, 512, 64]`` bf16 forward
    and backward bit-equal to ``flash_attention``, K3a-c once each; (f) an
    FSDP step on phase 9's model, an EP step on phase 22's MoE ViT-S/16
    top-2 of 8 and ``pipeline_apply`` (S = 1, M = 4) over 4 layers against
    their meshless runs, and ``distributed_recall_at_k`` on config 4's 256
    embeddings against ``utils.ranking``;
26. runs the flash kernels at head sizes other than 64 (``head_sizes_path``),
    phase 9's width 512 over 16 heads (h 32: K3a, K3b and K3c on their
    narrow kernels at 32, every launch of the flash step held to have run
    them by the counters by kernel, and every K3a launch to have run at its
    model's own head size, none padded), over 4 (h 128) and over 2 (h 256):
    (a)
    K3a-c through
    ``flash_attention`` and its backward at ``[256, 512, 32]``, ``[64,
    512, 128]`` and ``[32, 512, 256]`` bf16 with the ragged key mask,
    causal and not, at h 128 and 256 in float32 and at h 256 in float16,
    held to their plain versions with phase 8's tolerances and timed at
    phase 11's tokens and FLOPs against their bounds and SDPA;
    K3a at one query row at h 128 (``[64, 1, 128]`` against ``[64, 512,
    128]``) held and timed as in phase 17; (b) phase 9's padded train step
    at 16 and 4 heads, flash against dense attention on the same init: the
    first loss and logits, the timed steps in turns, K3a-c 12 launches each
    a flash step by the counters, ms/step, kernels, launches and busy
    share; (c) greedy decoding of 16 tokens at h 128: in bf16 the K3a
    launches by shape and the share of tokens equal to the dense path's,
    in float32 (the FMA kernels) tokens equal to it; (d) one step of phase
    9's model with ``global_clipnorm`` a quarter of its gradient norm under
    ``Trainer(mesh={data: 1, model: 1})`` bit-equal to the meshless step;
27. runs K3a-c in float16 (``float16_path``): (a) held to their plain
    versions on phase 26's path shapes at h 32, 64 and 128 in float16, and
    timed at phase 11's ``[128, 512, 64]`` against float16 SDPA and the
    bound, beside phase 11's bf16 times; (b) phase 9's train step in
    float16 (``use_mixed_precision("float16")`` activations, AdamW as in
    phase 9, no loss scaling, as the JAX package has none): its first loss
    against float32's on the same init (within 5%), its ms/step in turns
    with the bf16 step, K3a-c 12 launches each a step by the counters, set
    to 0 just before the timed steps and read just after;
28. runs the flash kernels at head sizes above 256 (``wide_heads_path``),
    on the cluster tensor-core kernels of K3a, K3b and K3c (K3a's one block
    a cluster up to h 512) and, in float32, the ``_cols`` FMA kernels: (a)
    K3a-c through
    ``flash_attention`` and its backward at
    ``[16, 512, 512]`` (phase 9's width over one head) with the ragged key
    mask, causal and not, in bf16, float16 and float32, held to their
    plain versions with phase 8's tolerances and timed in bf16 and float16
    at phase 11's tokens against their bounds and SDPA, whose backend the
    profiler names; (b) K3a-c held at h 288 (padded to 320), 384, 1024,
    1088 and 1216 (K3a a cluster of three blocks) on small shapes (cross
    lengths under the causal mask, rows and
    a batch item with no valid key, a scattered key mask) in the three
    types; (c) phase 9's padded train step over one head of 512, flash
    against dense attention on the same init (first loss within 2e-4 of
    dense's, logits, the timed steps in turns, K3a-c 12 launches each a
    step by the counters, every K3a launch of the step and of (d)'s bf16
    decode on the kernel the dispatch names); (d) greedy decoding of 16
    tokens at h 512 (float32 tokens equal dense's) and K3a at one query
    row, ``[16, 1, 512]`` against ``[16, 512, 512]``, held and timed as in
    phase 17; (e) K3a-c at ``[16, 512, h]`` for h 288, 384, 512, 1024 and
    1088: K3a held to its plain version there, each one's time, TFLOP/s,
    share of its bound, registers and launch shape (shared memory, cluster
    size, clusters the card holds at once); (f) K3a above h 1152 on the
    cluster kernel, at ``[16, 1, 512, 1216]`` (a cluster of three blocks):
    held to its plain version, driven once through ``flash_attention`` and
    its backward with the counters at 0 just before and read just after
    (its one K3a launch on ``flash_fwd_cluster_kernel``), and timed as
    phase 26 times K3a, against SDPA;
29. prints a ``trainer`` JSON line (phase 23, with its parts' seconds), a
    ``data_pipeline`` JSON line (phase 24), a ``serving_and_scale_out`` JSON
    line (phase 25), a ``head_sizes`` JSON line (phase 26), a ``float16``
    JSON line (phase 27), a ``wide_heads`` JSON line (phase 28), a ``paths``
    JSON line (the
    three DETR modes, the two DeiT modes, the CNN rows and phase 22's
    among its rows) and an ``int_mm`` JSON line, one ``kernels`` JSON line
    with all five kernels (K1 and K2 with their 384 px shape as
    ``shape_384``, K3a-c with phase 20's shape as ``shape_198``, K3a's
    short kernel as a row of its own after K3a's and K3b's after K3b's
    (phase 20's launches, the time at 198 and, as ``shape_served``, at
    ``[384, 197, 64]``, registers and shared memory), phase
    22's launches as ``launches_gshard``, phase 23's timed fit's as
    ``launches_trainer`` and K1's in phase 24's fit calls as
    ``launches_data_pipeline``, phase 25's as ``launches_served_flash``,
    ``launches_trainer_mesh`` and ``launches_context_parallel``, K3a-c at
    h 32, 128 and 256 as ``shape_h32``, ``shape_h128`` and ``shape_h256``
    with their registers and spills, in float16 at ``[128, 512, 64]`` as
    ``float16``, at h 512 as ``shape_h512`` with their registers, spills
    and launch shapes, K3a and K3c at h 1216 as ``shape_h1216``, K3a at one
    query row at h 128 and 512 as ``decode_h128`` and ``decode_h512``,
    K3a's two decode shapes as rows of their own after it, and a row of its
    own for each kernel that runs only at h 32, 128, 256 or above 256: the
    narrow K3a-c, K3b's producer kernel (h 128, and its ``shape_h256``) and
    the cluster kernels of K3a, K3b and K3c, each with its launches on
    phase 26's or 28's path (K3a's and K3c's cluster kernels' rows also
    hold their ``shape_h1216``), the card line,
    and last
    ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line. It
imports nothing of JAX or of ``chambers_tpu``.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

BATCH, SIZE = 32, 224
WARMUP, STEPS, REPEATS, MASKED_STEPS = 3, 20, 3, 5
FILL, PAD = 128, 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# the seq2seq train step, as the JAX package's tools/bench_seq2seq_flash.py
S2S = dict(vocab=1024, t=512, batch=16, dim=512, heads=8, layers=4)
S2S_WARMUP, S2S_STEPS, S2S_REPEATS = 2, 5, 3
CARD = ""
# registers and spilled bytes of each kernel, from the build's ptxas report
PTXAS = {}
# what K3a-c move and compute at a [bn, t, h] shape, by kernel: the [bn, t,
# h] operands read or written at every row (besides the kept rows of k and
# v), the float32 row statistics, and the operations of a multiply-add
# pair of one product times the products (K3a reads q and writes o, l, m;
# K3b and K3c read q, do, l, m, di and write dk, dv or dq)
FLASH_WORK = {"fwd": (2, 2, 4), "dkv": (4, 3, 8), "dq": (3, 3, 6)}
# a flash kernel's name in a profiler key, mangled or not
FLASH_KERNEL = (r"(flash_(?:fwd|bwd_dkv|bwd_dq)"
                r"(?:_tc|_short|_cols|_cluster|_narrow|_producer)?"
                r"_kernel)")
# exponents (ex2) an SM's special-function units give a clock: four in each
# of its four partitions (H100)
SFU_EXP2_PER_CLOCK = 16


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(*parts):
    print(*parts, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz(torch, fn, readings_wanted=8, seconds=10.0):
    """The SM clock the card holds while it runs ``fn`` back to back: the
    median of ``nvidia-smi``'s readings every 50 ms, taken until
    ``readings_wanted`` have come (``nvidia-smi`` takes a while to start)
    or ``seconds`` have passed, of those taken while the card drew more
    than 200 W (the busiest reading if none did; None if none came). The
    sampling process is stopped before this returns."""
    import threading

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        t0 = time.perf_counter()
        while (len(lines) < readings_wanted
               and time.perf_counter() - t0 < seconds):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        reader.join(timeout=60)
    readings = []
    for line in lines:
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:  # a reading the card did not give ([N/A])
            continue
        readings.append((mhz, watts))
    busy = sorted(mhz for mhz, watts in readings if watts > 200)
    if busy:
        return busy[len(busy) // 2]
    return max((mhz for mhz, _ in readings), default=None)


def cuda_ms(torch, fn, iters, backlog=False):
    """Mean ms per call of ``fn`` over ``iters`` calls, by CUDA events,
    after a short warm-up. With ``backlog`` the card first spins for ~30 ms
    so that all ``iters`` launches are queued before the first runs: the
    events then time the kernels back to back, not the host's launch
    rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(50_000_000)  # GPU clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def warp_matrices(torch, iops, b, device):
    """Identity, ±30° rotations, ±0.3 shears, ±100 px translations and a
    1000 px translation that fills everything, cycled over the batch."""
    rad = math.radians(30.0)
    kinds = [
        iops.identity_matrices(1, device),
        iops.rotation_matrices(torch.tensor([rad], device=device), SIZE, SIZE),
        iops.rotation_matrices(torch.tensor([-rad], device=device), SIZE,
                               SIZE),
    ]
    for build in (iops.shear_x_matrices, iops.shear_y_matrices):
        kinds += [build(torch.tensor([v], device=device)) for v in (.3, -.3)]
    for build in (iops.translate_x_matrices, iops.translate_y_matrices):
        kinds += [build(torch.tensor([v], device=device)) for v in (100., -100.)]
    kinds.append(iops.translate_x_matrices(torch.tensor([1000.0],
                                                        device=device)))
    return torch.cat([kinds[i % len(kinds)] for i in range(b)])


def read_build_report(path, seconds):
    """Log a built library's nvcc report, kernel by kernel (registers,
    spills, and the fences ptxas injected before a ``wgmma``, warning
    C7519), and keep each kernel's in ``PTXAS``; returns whether it was
    built with ``--fmad=false``."""
    report = path.with_suffix(".log").read_text().splitlines()
    no_fma = "--fmad=false" in report[0]  # the nvcc command line
    log(f"build: {seconds:.1f} s -> {path.name} "
        f"({'--fmad=false' if no_fma else 'FMAs allowed'})")
    kernel = spills = ""
    fences = {}
    for line in report:
        if "(C7519)" in line and "'" in line:
            name = kernel_name(line.split("'")[1])
            fences[name] = fences.get(name, 0) + 1
        if "Compiling entry" in line:
            kernel = kernel_name(line.split("'")[1])
        if "bytes spill" in line:
            spills = line.strip()
        if re.search(r"Used \d+ registers", line):
            log(f"  nvcc {kernel}: {line.split(':')[-1].strip()}; {spills}")
            PTXAS[kernel] = {
                "registers": int(re.search(r"(\d+) registers",
                                           line).group(1)),
                "spill_bytes": sum(int(x) for x in re.findall(
                    r"(\d+) bytes spill", spills))}
    for name, n in fences.items():
        log(f"  nvcc {name}: warpgroup.arrive injected before a wgmma "
            f"{n} times (C7519)")
        PTXAS.setdefault(name, {})["fences_injected"] = n
    return no_fma


def kernel_name(mangled):
    """``_ZN..16flash_fwd_kernelIfLi64EE..`` -> ``flash_fwd_kernel<f32,
    64>``, ``..flash_bwd_dq_tc_kernelI6__halfLi2EE..`` ->
    ``flash_bwd_dq_tc_kernel<f16, 128>`` (two 64-column panels; the
    producer kernels' panels too),
    ``..flash_fwd_cols_kernelIfLi128EE..`` -> ``flash_fwd_cols_kernel<f32>``
    and ``..flash_fwd_cluster_kernelI13__nv_bfloat16EE..`` ->
    ``flash_fwd_cluster_kernel<bf16>`` (the head size at run time),
    ``..warp_kernelILi3EE..`` -> ``warp_kernel<c=3>``; a name it cannot
    read comes back as it is."""
    found = re.search(r"\d{2}([a-z][a-z_]*_kernel)"
                      r"(I(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?)?",
                      mangled)
    if not found:
        return mangled
    name = found.group(1)
    if not found.group(2):
        groups = re.search(r"_kernelILi(\d)EE", mangled)
        if not groups:
            return name
        if name == "warp_kernel":  # templated on the channels
            return f"warp_kernel<c={groups.group(1) if groups.group(1) != '0' else 'any'}>"
        return f"{name}<{64 * int(groups.group(1))}>"
    dtype = ("f32" if found.group(3) == "f" else
             "bf16" if "bfloat" in found.group(3) else "f16")
    if found.group(4) is None or name.endswith("_cols_kernel"):
        return f"{name}<{dtype}>"
    size = int(found.group(4))
    if name.endswith(("_tc_kernel", "_producer_kernel")):  # on the panels
        size *= 64
    return f"{name}<{dtype}, {size}>"


def max_abs_diff(a, b):
    return int((a.int() - b.int()).abs().max())


def ragged_mask(torch, b, t, dev, seed=0):
    """``[b, t]`` bool key mask with 20-30% trailing padding per row."""
    import numpy as np

    rng = np.random.RandomState(seed)
    keep = (t * (0.70 + 0.10 * rng.rand(b))).astype(int)
    return torch.arange(t, device=dev)[None, :] < torch.tensor(
        keep, device=dev)[:, None]


def scattered_mask(torch, b, t, dev, seed):
    """``[b, t]`` bool key mask that drops about 30% of the keys anywhere
    and keeps the first."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand((b, t), device=dev, generator=gen) > 0.3
    keep[:, 0] = True
    return keep


def closeness(got, ref, rtol):
    """``(max |d|, max (|d| - rtol |ref|), ||d|| / ||ref||)`` of two tensors,
    in float32: the largest error, the absolute tolerance that an
    element-wise check at ``rtol`` needs, and the relative rms error."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    norm = float(ref.norm())
    return (float(d.max()), float((d - rtol * ref.abs()).max()),
            float(d.norm()) / norm if norm else float(d.norm()))


def flash_tolerance(torch, dtype, ref, gradient):
    """``(rtol, atol, rms)``: each element is held to ``|d| <= atol + rtol
    |ref|`` and the relative rms error to ``rms``.

    float32: kernel and plain version sum in another order; 2e-5 on outputs
    as the JAX package's tests hold its kernel, gradients 1e-4 of their
    largest value, and 1e-5 rms (a few hundred float32 roundings).

    bf16: rtol is one step of the output type (2^-7 of the value at most):
    the two round the same float32 sum, up to its order, to neighbouring
    values. atol is for the probabilities, which the kernel rounds to bf16
    at the running max and the plain version at the final one: every term
    p v moves by up to 2^-9 of itself on each side, and the weights sum to
    one over values of size ~1, so 2^-8. A gradient takes the same: its
    di = sum(o do) comes from the kernel's own o. Rounding errors are spread
    evenly, so their rms is under half a step: 2^-8 of the reference's rms
    catches a fault in the low bits that no maximum can."""
    if dtype == torch.float32:
        atol = 1e-4 * max(1.0, float(ref.abs().max())) if gradient else 2e-5
        return 0.0, atol, 1e-5
    if dtype == torch.float16:
        # float16's steps are eight times finer: one step 2^-10, each term
        # p v moved by up to its unit roundoff 2^-11 on either side
        return 2.0 ** -10, 2.0 ** -10, 2.0 ** -11
    return 2.0 ** -7, 2.0 ** -8, 2.0 ** -8


def phase8_cases(torch, dev):
    """Phase 8's cases, ``(label, b, n, tq, tk, dtype, causal, mask, layout
    of q, k, v)`` at head size 64, and the mask of its batch item with no
    valid key."""
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, t = S2S["batch"], S2S["heads"], S2S["t"]
    path_mask = ragged_mask(torch, b, t, dev)
    dead = path_mask[:2].clone()
    dead[1] = False
    # (label, b, n, tq, tk, dtype, causal, mask, layout of q, k, v)
    cases = [
        ("path: encoder self / cross, key mask", b, n, t, t, bf16, False,
         path_mask, "permuted"),
        ("path: decoder self, causal + key mask", b, n, t, t, bf16, True,
         path_mask, "stacked"),
        ("ViT-B/16 shape bf16", 2, 12, 197, 197, bf16, False, None, "plain"),
        # DeiT-B/16's 198 tokens (phase 20): the last key tile holds 6 keys
        # of 64, covered by the kernels' bounds, with no key mask
        ("DeiT-B/16 shape 198x198 bf16, no mask", 2, 12, 198, 198, bf16,
         False, None, "permuted"),
        ("ViT shape float32", 2, 3, 197, 197, f32, False, None, "stacked"),
        ("cross lengths 130x260 causal float32", 1, 2, 130, 260, f32, True,
         None, "plain"),
        ("cross lengths 260x130 causal float32, 130 rows with no key", 1, 2,
         260, 130, f32, True, None, "plain"),
        ("batch item with no valid key", 2, n, t, t, bf16, False, dead,
         "permuted"),
        # the same edges for the bf16 backward kernels
        ("cross lengths 130x260 causal bf16", 1, 2, 130, 260, bf16, True,
         None, "plain"),
        ("cross lengths 260x130 causal bf16, 130 rows with no key", 1, 2,
         260, 130, bf16, True, None, "plain"),
        ("63x65 bf16, key mask", 2, 1, 63, 65, bf16, False,
         scattered_mask(torch, 2, 65, dev, 11), "plain"),
        ("257x257 causal bf16, key mask", 2, 5, 257, 257, bf16, True,
         scattered_mask(torch, 2, 257, dev, 12), "stacked"),
        ("70x150 bf16, key mask", 3, 2, 70, 150, bf16, False,
         scattered_mask(torch, 3, 150, dev, 13), "permuted"),
        ("one key bf16", 2, 2, 64, 1, bf16, False, None, "plain"),
        ("one query against 300 keys bf16, key mask", 2, 2, 1, 300, bf16,
         False, scattered_mask(torch, 2, 300, dev, 14), "plain"),
        # the edges of K3b's short kernel (1 to 256 queries over 129 to 256
        # keys): keys past 192 handed to each warpgroup in turn, a last
        # query tile of one row, causal cross lengths, one query row
        ("K3b short: causal 120x250 bf16", 1, 2, 120, 250, bf16, True, None,
         "plain"),
        ("K3b short: causal 200x136 bf16, key mask", 2, 2, 200, 136, bf16,
         True, scattered_mask(torch, 2, 136, dev, 15), "plain"),
        ("K3b short: one query against 200 keys bf16, key mask", 2, 2, 1,
         200, bf16, False, scattered_mask(torch, 2, 200, dev, 16), "plain"),
        ("K3b short: 193x193 bf16, a last query tile of one row", 1, 3, 193,
         193, bf16, False, None, "stacked"),
        ("K3b short: 198x198 float16", 2, 3, 198, 198, torch.float16, False,
         None, "permuted"),
    ]
    return cases, dead


# phase 8's head sizes for the narrow kernels (bf16 and float16 run K3a-c
# at 32, h 8 and 16 padded to it)
NARROW_HEADS = (8, 16, 32)


def narrow_cases(torch, dev, h):
    """Phase 8's cases for the narrow kernels at head size ``h``, in bf16
    and float16: one key, one query row against 300 keys with a key mask,
    DeiT-B/16's 198 tokens, causal cross lengths both ways (130 rows that
    see no key), a batch item with no valid key, and the mask of that
    item."""
    bf16, f16 = torch.bfloat16, torch.float16
    dead = ragged_mask(torch, 2, 200, dev)
    dead[1] = False
    return [
        (f"narrow h {h}: one key", 2, 2, 64, 1, bf16, False, None, "plain"),
        (f"narrow h {h}: one query against 300 keys, key mask", 2, 2, 1,
         300, f16, False, scattered_mask(torch, 2, 300, dev, 14), "plain"),
        (f"narrow h {h}: DeiT-B/16 198x198", 2, 12, 198, 198, bf16, False,
         None, "permuted"),
        (f"narrow h {h}: cross lengths 130x260 causal", 1, 2, 130, 260, f16,
         True, None, "plain"),
        (f"narrow h {h}: cross lengths 260x130 causal, 130 rows with no "
         f"key", 1, 2, 260, 130, bf16, True, None, "plain"),
        (f"narrow h {h}: batch item with no valid key", 2, 2, 200, 200, f16,
         False, dead, "permuted")], dead


def check_flash_kernels(torch, fa, dev, h=64, cases=None, dead=None):
    """Phase 8: K3a-c against their plain versions on the card, through the
    wrapper the paths call: ``flash_attention`` forward and its backward,
    so the operand checks and copies, the fold, the scale's reciprocal and
    the chain of saved tensors (the backward kernels read the forward
    kernel's own o, l, m) are held as well. Returns the max abs errors at
    the train step's shape, by kernel. Phases 26 and 28 pass their own
    ``cases`` at head size ``h`` (and ``dead``, the mask of a case whose
    batch item 1 has no valid key): the direct launches then take operands
    padded to the size the kernels take, as the wrapper pads them."""
    if cases is None:
        cases, dead = phase8_cases(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    path_err = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for label, b_, n_, tq, tk, dtype, causal, mask, layout in cases:
        size = fa.kernel_head_size(h, dtype)

        def rand(tt):
            if layout == "permuted":  # as a projection's einsum may hand over
                return torch.randn((b_, tt, n_, h), device=dev,
                                   generator=gen).to(dtype).permute(0, 2, 1, 3)
            return torch.randn((b_, n_, tt, h), device=dev,
                               generator=gen).to(dtype)

        if layout == "stacked":  # slices of one self-attention projection
            q, v, k = torch.randn((3, b_, n_, tq, h), device=dev,
                                  generator=gen).to(dtype)
        else:
            q, v, k = rand(tq), rand(tk), rand(tk)
        do = rand(tq)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, v, k, causal=causal, kv_mask=mask)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
        again = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
              f"the backward kernels repeat ({label})")

        def fold(x):
            return x.detach().reshape(b_ * n_, x.shape[2], h)

        fq, fk, fv, fdo = fold(q), fold(k), fold(v), fold(do)
        fmask = None if mask is None else mask.float()
        scale = h ** -0.5
        o_p, l_p, m_p = fa.flash_forward_plain(fq, fk, fv, scale, causal,
                                               fmask, n_)
        dq_p, dk_p, dv_p = fa.flash_backward_plain(
            fq, fk, fv, o_p, l_p, m_p, fdo, scale, causal, fmask, n_)
        # the statistics the wrapper saved: the same launch gives them
        # again, to the bit, twice
        padded = tuple(fa.pad_head(x, size) for x in (fq, fk, fv))
        o_again, l, m = fa.launch_forward(*padded, fmask, scale, causal, n_)
        third = fa.launch_forward(*padded, fmask, scale, causal, n_)
        torch.cuda.synchronize()
        check(torch.equal(o_again[..., :h], fold(o))
              and all(torch.equal(a, b) for a, b in zip(third,
                                                        (o_again, l, m))),
              f"the forward kernel repeats ({label})")

        pairs = {"o": (o, o_p), "dq": (dq, dq_p), "dk": (dk, dk_p),
                 "dv": (dv, dv_p)}
        errs, report = {}, []
        for name, (got, ref) in pairs.items():
            got = fold(got)
            check(got.dtype == dtype and tuple(got.shape) == tuple(ref.shape),
                  f"{name} has the inputs' type and shape ({label})")
            rtol, atol, rms_limit = flash_tolerance(torch, dtype, ref,
                                                    name != "o")
            errs[name], needs, rms = closeness(got, ref, rtol)
            check(needs <= atol, f"K3 {name} within atol {atol:.3g} + rtol "
                                 f"{rtol:.3g} per element ({label})")
            if tk == 1 and name in ("dq", "dk"):
                # With one key p = 1 and ds = do . v - di = 0: what is left
                # is the difference of two float32 sums of 64 products of
                # size ~1 taken in two orders, ~1e-6, on either side. A
                # relative error of that says nothing, so both are held to
                # 2e-5 in absolute value instead.
                top = max(float(got.abs().max()), float(ref.abs().max()))
                closeness_note = f"both |x| <= {top:.3g} <= 2e-05"
                check(top <= 2e-5, f"K3 {name} cancels to zero ({label})")
            else:
                closeness_note = f"rms {rms:.3g} <= {rms_limit:.3g}"
                check(rms <= rms_limit, f"K3 {name} rms error ({label})")
            report.append(
                f"{name} {errs[name]:.3g} (over rtol {max(needs, 0.0):.3g} "
                f"<= {atol:.3g}, {closeness_note})")
            check(bool(torch.isfinite(got).all()), f"finite {name} ({label})")
        log(f"K3 vs plain [{label}] [{b_ * n_}, {tq}x{tk}, {h}] "
            f"{str(dtype).split('.')[-1]} {layout}: max |d| "
            + ", ".join(report))
        check(bool(torch.isfinite(l).all()) and bool(torch.isfinite(m).all()),
              f"finite l, m ({label})")
        check(bool(torch.allclose(l, l_p, rtol=1e-4, atol=1e-6))
              and bool(torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)),
              f"saved l, m agree ({label})")
        if dead is not None and mask is dead:
            # batch item 1: rows n_ .. 2 n_ - 1 of l, m
            check(not any(bool(x[1].any()) for x in (o, dq, dk, dv))
                  and not bool(l[n_:].any())
                  and bool((m[n_:] == fa.MASK_VALUE).all()),
                  "a batch item with no valid key gives exact zeros, l = 0 "
                  "and m at the mask value")
        if causal and tq > tk:
            check(not bool(o[:, :, :tq - tk].any())
                  and not bool(dq[:, :, :tq - tk].any())
                  and not bool(l[:, :tq - tk].any())
                  and bool((m[:, :tq - tk] == fa.MASK_VALUE).all()),
                  "rows above the end-aligned diagonal give exact zeros, "
                  "l = 0 and m at the mask value")
        if label.startswith("path"):
            path_err["fwd"] = max(path_err["fwd"], errs["o"])
            path_err["dkv"] = max(path_err["dkv"], errs["dk"], errs["dv"])
            path_err["dq"] = max(path_err["dq"], errs["dq"])
    return path_err


def check_tile_products(torch, fa, dev):
    """The two matrix products of the bf16 backward kernels' tiling alone
    against ``torch.matmul``: ``x yᵀ`` from two tiles in shared memory, and
    its bf16 rounding times ``y`` read along its rows, with the first
    product's accumulator as the register operand. Holds the fragment
    layout, the swizzle and the descriptors apart from the softmax. Sums
    of 64 bf16 products in float32 in another order: 1e-5 of the largest
    value."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((128, 64), device=dev, generator=gen).bfloat16()
    y = torch.randn((64, 64), device=dev, generator=gen).bfloat16()
    nt, tn = fa.tile_products(x, y)
    torch.cuda.synchronize()
    nt_ref = x.float() @ y.float().T
    tn_ref = nt.bfloat16().float() @ y.float()
    for name, got, ref in (("x y^T", nt, nt_ref), ("bf16(x y^T) y", tn,
                                                   tn_ref)):
        d, top = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"tile product {name} vs torch.matmul: max |d| {d:.3g} of "
            f"{top:.3g}")
        check(d <= 1e-5 * top, f"tile product {name} agrees with matmul")


def check_forward_kernel_names(torch, fa, dev):
    """Which kernel each type's forward launches, read from the profiler
    and held to the dispatch's own answer (``fa.forward_kernel``): bf16 at
    96 tokens runs ``flash_fwd_short_kernel`` (a head resident), at 300
    ``flash_fwd_tc_kernel`` (tensor cores, tiles passing), float16 at head
    size 32 ``flash_fwd_narrow_kernel``, float32 ``flash_fwd_kernel``
    (FMAs)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(8)
    wanted = ((torch.bfloat16, 96, 64, "flash_fwd_short_kernel"),
              (torch.bfloat16, 300, 64, "flash_fwd_tc_kernel"),
              (torch.float16, 300, 32, "flash_fwd_narrow_kernel"),
              (torch.float32, 96, 64, "flash_fwd_kernel"))
    for dtype, t, h, want in wanted:
        q, k, v = (torch.randn((4, t, h), device=dev,
                               generator=gen).to(dtype) for _ in range(3))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.launch_forward(q, k, v, None, 0.125, False, 2)
            torch.cuda.synchronize()
        names = {found.group(1) for e in prof.key_averages()
                 if (found := re.search(FLASH_KERNEL, e.key))}
        log(f"profiler: {str(dtype).split('.')[-1]} forward at {t} tokens, "
            f"h {h} runs {sorted(names)}")
        check(names == {want} and fa.forward_kernel(dtype, h, t, t) == want,
              f"{str(dtype).split('.')[-1]} forward at {t} tokens, h {h} runs "
              f"{want}")


def seq2seq_tokens(torch, dev):
    """Source and target tokens with 20-30% ragged trailing padding (id 0),
    as tools/bench_seq2seq_flash.py of the JAX package makes them."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, t, vocab = S2S["batch"], S2S["t"], S2S["vocab"]
    src = rng.randint(1, vocab, (b, t)).astype(np.int64)
    tgt = rng.randint(1, vocab, (b, t)).astype(np.int64)
    for row in range(b):
        keep = int(t * (0.70 + 0.10 * rng.rand()))
        src[row, keep:] = 0
        tgt[row, keep:] = 0
    return torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)


def seq2seq_loss(torch, model, src, tgt):
    """Masked cross-entropy on the next token; padding labels excluded."""
    logits = model([src, tgt], deterministic=True)
    labels = torch.roll(tgt, -1, dims=1)
    mask = (labels != 0).float().flatten()
    ce = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten(), reduction="none")
    return (ce * mask).sum() / mask.sum(), logits


def device_kernels(torch, events):
    """The kernels of a profile's averaged events: its device events less
    the ranges that the host annotates (``record_function``, and PyTorch's
    own ``Optimizer.step#...``), which also appear on the device timeline,
    spanning their kernels and the gaps between them."""
    ranges = {e.key for e in events
              if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in ranges]


def device_time_by_kind(torch, events):
    """Self device time in ms of a profile's kernels, split into the flash
    kernels, matrix products and everything else, with the names of the
    flash kernels that ran under each of their kinds."""
    kinds = {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0,
             "gemm": 0.0, "other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    names = {k: set() for k in kinds}
    for e in device_kernels(torch, events):
        key = e.key.lower()
        kind = next((k for k in kinds if k in key), None)
        if kind is None:
            kind = "gemm" if any(w in key for w in (
                "gemm", "nvjet", "cutlass", "xmma", "cublas")) else "other"
        elif found := re.search(FLASH_KERNEL, key):
            names[kind].add(found.group(1))
        kinds[kind] += e.self_device_time_total / 1e3
        counts[kind] += e.count
    return kinds, counts, names


def seq2seq_path(torch, fa, dev):
    """Phase 9: the padded Seq2SeqTransformer train step on the flash
    kernels at full width. Returns the launch counts of the timed steps."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models import Seq2SeqTransformer

    def build(impl):
        model = Seq2SeqTransformer(
            input_vocab_size=S2S["vocab"], output_vocab_size=S2S["vocab"],
            embed_dim=S2S["dim"], num_heads=S2S["heads"],
            dim_feedforward=4 * S2S["dim"],
            num_encoder_layers=S2S["layers"],
            num_decoder_layers=S2S["layers"], dropout_rate=0.0,
            dtype=torch.bfloat16, attention_impl=impl, device=dev)
        return initializers.init_module(
            model, torch.Generator(device=dev).manual_seed(0)).train()

    model = build("flash")
    dense = build("xla")
    dense.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    src, tgt = seq2seq_tokens(torch, dev)
    vocab = S2S["vocab"]

    def tokens_of(i):
        # varied per step, padding kept
        return torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt

    # first step's loss and logits against the dense attention path: both
    # models are bf16 with float32 softmax statistics and differ in where
    # the probabilities are rounded, so 1e-2 relative on the loss and a
    # cosine of 0.999 over the logits of the real (non-padding) positions
    with torch.no_grad():
        loss_f, logits_f = seq2seq_loss(torch, model, *tokens_of(0))
        loss_d, logits_d = seq2seq_loss(torch, dense, *tokens_of(0))
    real = (tgt != 0)
    a, b = logits_f[real].float().flatten(), logits_d[real].float().flatten()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    rel = abs(float(loss_f) - float(loss_d)) / abs(float(loss_d))
    log(f"seq2seq first step, flash vs dense attention: loss "
        f"{float(loss_f):.5f} vs {float(loss_d):.5f} (rel {rel:.2e}), logits "
        f"cosine {cos:.6f}, max |d| {float((a - b).abs().max()):.4f}")
    check(tuple(logits_f.shape) == (S2S["batch"], S2S["t"], vocab),
          "logits [16, 512, 1024]")
    check(rel <= 1e-2 and cos >= 0.999,
          "flash train step's first loss and logits follow the dense path")
    del dense, logits_f, logits_d

    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4,
                            betas=(0.9, 0.999), eps=1e-8)

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss, _ = seq2seq_loss(torch, model, *tokens_of(i))
        loss.backward()
        opt.step()
        return loss.detach()

    for i in range(S2S_WARMUP):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    losses, runs, host_runs = [], [], []
    for r in range(S2S_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses += [step(S2S_WARMUP + r * S2S_STEPS + i)
                   for i in range(S2S_STEPS)]
        end.record()
        end.synchronize()
        host_runs.append((time.perf_counter() - t0) * 1e3 / S2S_STEPS)
        runs.append(start.elapsed_time(end) / S2S_STEPS)
    launches = dict(fa.flash_attention.launches)
    n_steps = S2S_STEPS * S2S_REPEATS
    ms = sorted(runs)[len(runs) // 2]
    losses = [float(x) for x in losses]
    positions = S2S["batch"] * 2 * S2S["t"]
    real_tokens = int((src != 0).sum() + (tgt != 0).sum())
    log(f"seq2seq train step ({n_params / 1e6:.1f} M parameters, batch "
        f"{S2S['batch']}, {S2S['t']} + {S2S['t']} tokens a row, bf16): median "
        f"of {S2S_REPEATS} runs of {S2S_STEPS} steps {ms:.3f} ms/step (CUDA "
        f"events; runs {', '.join(f'{x:.3f}' for x in runs)}; host clock "
        f"{', '.join(f'{x:.3f}' for x in host_runs)}), "
        f"{positions / (ms / 1e3):.0f} tokens/s with padding, "
        f"{real_tokens / (ms / 1e3):.0f} without, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {CARD}")
    log(f"seq2seq losses: {[round(x, 4) for x in losses]}; launches over "
        f"{n_steps} steps: {launches}")
    per_step = 3 * S2S["layers"]
    check(all(launches[k] == per_step * n_steps for k in launches),
          "K3a, K3b and K3c each launched 12 times per train step")
    check(all(math.isfinite(x) for x in losses), "finite losses")
    check(losses[-1] <= losses[0] * 1.02, "losses falling or flat")

    from torch.profiler import ProfilerActivity, profile

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_prof):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    log(events.table(sort_by="self_device_time_total", row_limit=12))
    kinds, counts, names = device_time_by_kind(torch, events)
    busy = sum(kinds.values()) / n_prof
    log(f"seq2seq profile, device ms per step on {CARD}: " + ", ".join(
        f"{' '.join([k, *sorted(names[k])])} {v / n_prof:.3f} "
        f"({counts[k] // n_prof} launches)" for k, v in kinds.items()))
    check(names["flash_fwd"] == {"flash_fwd_tc_kernel"},
          "the bf16 train step runs the tensor-core forward")
    log(f"seq2seq profile: {busy:.3f} ms of device time per step against "
        f"{ms:.3f} ms/step unprofiled: device busy {100 * busy / ms:.1f}%, "
        f"flash kernels {100 * sum(v for k, v in kinds.items() if 'flash' in k) / n_prof / ms:.1f}% "
        f"of a step, on {CARD}")
    return launches


def vit_on_flash(torch, fa, dev, images):
    """Phase 10: a ViT-B/16-wide VisionTransformer on the flash kernel
    against the dense path, float32, two layers."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    def build(impl):
        return VisionTransformer(16, 768, 2, 12, 3072, attention_impl=impl,
                                 device=dev)

    flash = initializers.init_module(
        build("flash"), torch.Generator(device=dev).manual_seed(2)).eval()
    dense = build("xla").eval()
    dense.load_state_dict(flash.state_dict())
    before = fa.flash_attention.launches["fwd"]
    with torch.inference_mode():
        x = images[:4].float() / 127.5 - 1.0
        got, want = flash(x), dense(x)
    torch.cuda.synchronize()
    count = fa.flash_attention.launches["fwd"] - before
    d = float((got - want).abs().max())
    log(f"ViT (width 768, 12 heads, 2 layers, 197 tokens) float32, flash vs "
        f"dense attention: max |d logit| {d:.3g} of range "
        f"{float(want.max() - want.min()):.3g}; {count} forward launches")
    check(count == 2, "one K3a launch per encoder layer")
    check(d < 1e-3 and bool(torch.isfinite(got).all()),
          "ViT on the flash kernel matches the dense path")


def time_flash_kernels(torch, fa, dev, launches, errors, h=64, heads=None,
                       dtype=None):
    """Phase 11: K3a-c at the train step's shape, [128, 512, 64] bf16 with
    the ragged key mask (encoder self-attention and cross attention: 8 of a
    step's 12 launches of each kernel; the causal use is timed beside it),
    and the float32 instances of K3a-c, which are other kernels, at
    the same shape. Returns the three rows of the ``kernels`` line. Phase
    26 times the same tokens at head size ``h`` over ``heads`` heads: the
    kernels on operands padded to the size they are built at, the plain
    versions, SDPA and the bounds at ``h``. Phase 27 times them in
    ``dtype`` float16 (the same kernels' other instance; SDPA in float16;
    no float32 timing). Bounds and TFLOP/s count the keys the mask keeps
    (the kernels stop at a row's last valid key); ``full_kv_bound_ms``
    counts every key."""
    F = torch.nn.functional
    dtype = dtype or torch.bfloat16
    type_name = str(dtype).split(".")[-1]
    b, n, t = S2S["batch"], heads or S2S["heads"], S2S["t"]
    bn, scale = b * n, h ** -0.5
    size = fa.kernel_head_size(h, dtype)
    mask = ragged_mask(torch, b, t, dev)
    fmask = mask.float()
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand():
        return torch.randn((bn, t, h), device=dev,
                           generator=gen).to(dtype)

    # cycle over sets larger together than the 50 MB L2; the kernels read
    # q, k, v, do padded to the head size they take
    sets, padded = [], []
    for _ in range(3):
        q, k, v, do = rand(), rand(), rand(), rand()
        o, l, m = fa.flash_forward_plain(q, k, v, scale, False, fmask, n)
        sets.append((q, k, v, do, o, l, m, fa.delta(o, do)))
        padded.append(tuple(fa.pad_head(x, size) for x in (q, k, v, do)))
    turn = iter(range(10 ** 9))

    def nxt():
        return sets[next(turn) % len(sets)]

    def nxt_padded():
        return padded[next(turn) % len(sets)]

    def bwd_args(causal):
        i = next(turn) % len(sets)
        q, k, v, do = padded[i]
        _, _, _, _, _, l, m, di = sets[i]
        return (q, k, v, do, l, m, di, fmask, scale, causal, n)

    def plain_bwd():
        q, k, v, do, o, l, m, _ = nxt()
        return fa.flash_backward_plain(q, k, v, o, l, m, do, scale, False,
                                       fmask, n)

    def four(x):
        return x.view(b, n, t, h)

    attn_mask = mask[:, None, None, :]

    def sdpa():
        q, k, v = nxt()[:3]
        return F.scaled_dot_product_attention(four(q), four(k), four(v),
                                              attn_mask=attn_mask)

    q0, k0, v0, do0 = (four(x).clone().requires_grad_(i < 3)
                       for i, x in enumerate(sets[0][:4]))
    out0 = F.scaled_dot_product_attention(q0, k0, v0, attn_mask=attn_mask)

    def sdpa_bwd():
        return torch.autograd.grad(out0, (q0, k0, v0), do0,
                                   retain_graph=True)

    def wrapped():
        q, k, v = (four(x) for x in nxt()[:3])
        return fa.flash_attention(q, v, k, kv_mask=mask)

    float32_ms = dict.fromkeys(("fwd", "dkv", "dq"))
    if dtype == torch.bfloat16:
        # the float32 backward: one set (the inputs alone are 67 MB)
        q32, k32, v32, do32 = (x.float() for x in sets[0][:4])
        o32, l32, m32 = fa.flash_forward_plain(q32, k32, v32, scale, False,
                                               fmask, n)
        di32 = fa.delta(o32, do32)
        size32 = fa.kernel_head_size(h, torch.float32)
        q32, k32, v32, do32 = (fa.pad_head(x, size32)
                               for x in (q32, k32, v32, do32))
        args32 = (q32, k32, v32, do32, l32, m32, di32, fmask, scale, False,
                  n)
        float32_ms = {
            "fwd": cuda_ms(torch, lambda: fa.launch_forward(
                q32, k32, v32, fmask, scale, False, n), 10, backlog=True),
            "dkv": cuda_ms(torch, lambda: fa.launch_backward_dkv(*args32),
                           10, backlog=True),
            "dq": cuda_ms(torch, lambda: fa.launch_backward_dq(*args32), 10,
                          backlog=True)}
        del q32, k32, v32, do32, o32, l32, m32, di32, args32
    source = {"fwd": "flash_attention_fwd.cu", "dkv": "flash_attention_bwd.cu",
              "dq": "flash_attention_bwd.cu"}

    # The bound counts the work this data needs: the kernels stop at a
    # row's last valid key, so only the kept rows of k and v are read and
    # only the kept keys are multiplied (causal: key j by the t - j rows at
    # or after it). full_kv_bound_ms counts every key, as if unmasked.
    elem = 2  # bytes of a bf16 or float16 value
    kept = n * int(mask.sum())               # rows of k and v kept
    row_bytes = bn * t * h * elem            # q, do, o, dq: every row
    kv = 2 * kept * h * elem                 # the kept rows of k and v
    stats = bn * t * 4                       # one float32 row statistic
    pairs = n * t * h * int(mask.sum())      # multiply-adds of one product
    causal_pairs = n * h * int(((t - torch.arange(t, device=dev)) * mask)
                               .sum())
    full_pairs = bn * t * t * h
    plain_fwd_ms = cuda_ms(torch, lambda: fa.flash_forward_plain(
        *nxt()[:3], scale, False, fmask, n), 10)
    plain_bwd_ms = cuda_ms(torch, plain_bwd, 10)
    lib_fwd_ms = cuda_ms(torch, sdpa, 20, backlog=True)
    lib_bwd_ms = cuda_ms(torch, sdpa_bwd, 20, backlog=True)
    wrapper_ms = cuda_ms(torch, wrapped, 20)
    def work(key):  # bytes beyond the kept k and v rows, products
        rows, stat_rows, per_pair = FLASH_WORK[key]
        return rows * row_bytes + stat_rows * stats, per_pair

    # (name, key, launch, bytes beyond the kept k and v rows, products,
    # replaces, plain_ms, library_ms)
    specs = (
        ("flash_fwd", "fwd", lambda c: fa.launch_forward(
            *nxt_padded()[:3], fmask, scale, c, n), *work("fwd"),
         "chambers_tpu/ops/flash_attention.py:190 _flash_forward",
         plain_fwd_ms, lib_fwd_ms),
        ("flash_bwd_dkv", "dkv", lambda c: fa.launch_backward_dkv(
            *bwd_args(c)), *work("dkv"),
         "chambers_tpu/ops/flash_attention.py:387 _flash_backward (dK/dV)",
         plain_bwd_ms, lib_bwd_ms),
        ("flash_bwd_dq", "dq", lambda c: fa.launch_backward_dq(
            *bwd_args(c)), *work("dq"),
         "chambers_tpu/ops/flash_attention.py:418 _flash_backward (dQ)",
         plain_bwd_ms, lib_bwd_ms),
    )
    # the exponent bound: one ex2 a kept score in each of K3a-c, at the
    # SM clock the card holds under K3b
    mhz = sm_clock_mhz(torch, lambda: specs[1][2](False))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = (pairs / h / (SFU_EXP2_PER_CLOCK * sms * mhz * 1e6) * 1e3
              if mhz else None)
    rows = []
    for name, key, bare, other, per_pair, replaces, plain_ms, lib_ms in specs:
        kernel_ms = cuda_ms(torch, lambda: bare(False), 20, backlog=True)
        causal_ms = cuda_ms(torch, lambda: bare(True), 20, backlog=True)
        mask_bytes = b * t * 4
        ops = per_pair * pairs
        bytes_ms = (other + kv + mask_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_OPS_PER_S * 1e3  # float16's peak is the same
        bound_ms = max(bytes_ms, ops_ms)
        causal_bound_ms = max(bytes_ms,
                              per_pair * causal_pairs / BF16_OPS_PER_S * 1e3)
        full_kv_bound_ms = max(
            (other + 2 * row_bytes + mask_bytes) / HBM_BYTES_PER_S,
            per_pair * full_pairs / BF16_OPS_PER_S) * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "chambers_tpu_torch/ops/csrc/" + source[key],
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errors[key], "bit_equal": False,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms if key == "fwd" else None,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "products_bound_ms": ops_ms,
            "exp_bound_ms": exp_ms, "sm_clock_mhz": mhz,
            "library_ms": lib_ms, "causal_ms": causal_ms,
            "causal_bound_ms": causal_bound_ms,
            "full_kv_bound_ms": full_kv_bound_ms,
            "achieved_tflops": ops / (kernel_ms / 1e3) / 1e12,
            "float32_ms": float32_ms[key],
            "note": ("plain_ms and library_ms are the whole backward, dK/dV "
                     "and dQ together" if key != "fwd" else
                     "library_ms is F.scaled_dot_product_attention with the "
                     "same key mask")
                    + f"; bound_ms and achieved_tflops count the {kept} of "
                      f"{bn * t} key rows the mask keeps, full_kv_bound_ms "
                      f"every key",
            "card": CARD,
        })
        log(f"{name} [{bn}, {t}, {h}] {type_name} key mask: kernel "
            f"{kernel_ms * 1e3:.1f} us ({rows[-1]['achieved_tflops']:.1f} "
            f"TFLOP/s), causal {causal_ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({rows[-1]['bound_by']}; bytes "
            f"{bytes_ms * 1e3:.2f}, products {ops_ms * 1e3:.2f}, exponents "
            f"{(exp_ms or 0) * 1e3:.2f} us at {mhz} MHz; causal "
            f"{causal_bound_ms * 1e3:.2f} us; all keys "
            f"{full_kv_bound_ms * 1e3:.2f} us)"
            + (f", float32 operands (the FMA kernel) "
               f"{float32_ms[key] * 1e3:.1f} us" if float32_ms[key] else "")
            + f" on {CARD}")
    log(f"flash_attention wrapper call, forward: {wrapper_ms * 1e3:.1f} us "
        f"on {CARD}")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# 12-15. the int8 serving path and AutoAugment -> ViT-L/16 at 384 px
# ---------------------------------------------------------------------------

# published H100 SXM dense int8 tensor-core rate (data sheet, 700 W)
INT8_OPS_PER_S = 1979e12
L_BATCH, L_SIZE = 128, 384
L_WARMUP, L_STEPS, L_REPEATS = 2, 5, 3
LABELS = ("int8 quantize", "int8 _int_mm", "attention core")


class labelled:
    """Within the block, ``dynamic_quantize``, ``int_mm`` and the attention
    core (scores, softmax, P·V) — or the ``(owner, attribute, label)``
    ``slots`` given — run under ``record_function`` ranges whose device
    time the profiler sums: the split of a step's device time by kind.
    Outside it the package runs unlabelled."""

    def __init__(self, torch, slots=None):
        from chambers_tpu_torch import quantization as tq
        from chambers_tpu_torch.layers import attention

        self.slots = slots or [
            (tq, "dynamic_quantize", LABELS[0]), (tq, "int_mm", LABELS[1]),
            (attention, "scaled_dot_product_attention", LABELS[2])]
        self.record = torch.profiler.record_function

    def __enter__(self):
        self.saved = []
        for module, name, label in self.slots:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with self.record(_label):
                    return _fn(*a, **kw)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def profile_by_kind(torch, step, n):
    """Device ms per step of ``n`` profiled steps, by kind: the labelled
    ranges (quantize passes, ``_int_mm``, the attention core), matrix
    products elsewhere (kernel names) and everything else; and device
    kernel launches per step."""
    from torch.profiler import ProfilerActivity, profile

    with labelled(torch), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cpu_side = torch.autograd.DeviceType.CPU
    # kernels only in the total, and each labelled range's kernels from its
    # host side
    cuda = device_kernels(torch, events)
    total = sum(e.self_device_time_total for e in cuda) / 1e3
    launches = sum(e.count for e in cuda)
    gemm = sum(e.self_device_time_total for e in cuda if any(
        w in e.key.lower() for w in ("gemm", "nvjet", "cutlass", "xmma",
                                     "cublas"))) / 1e3
    ranges = {label: sum(e.device_time_total for e in events
                         if e.key == label and e.device_type == cpu_side)
              / 1e3 for label in LABELS}
    kinds = {k: v / n for k, v in ranges.items()}
    kinds["other"] = (total - sum(ranges.values())) / n
    return {"device_ms": total / n, "by_kind_ms": kinds,
            "gemm_named_ms": gemm / n, "launches": launches / n,
            "table": events.table(sort_by="self_device_time_total",
                                  row_limit=10)}


def timed_runs(torch, wk, step, repeats, steps, warmup):
    """``repeats`` runs of ``steps`` steps after ``warmup``, CUDA events,
    with the launch counters set to 0 just before the runs and read just
    after. Returns (ms per step of each run, launches, last output)."""
    for i in range(warmup):
        step(i)
    torch.cuda.synchronize()
    wk.fused_round.launches = 0
    wk.transform_affine_separable.launches = 0
    runs = []
    for r in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            out = step(r * steps + i)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / steps)
    launches = {"fused_round": wk.fused_round.launches,
                "warp": wk.transform_affine_separable.launches}
    return runs, launches, out


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def cosine(torch, got, want):
    return float(torch.nn.functional.cosine_similarity(
        got.double().flatten(), want.double().flatten(), dim=0))


def check_int8_against_cpu(torch, tq, state_dict, x, dev):
    """A float32 int8 ViT-B/16 on the card against the same model on the
    CPU, on 4 images. Every int8 product and every quantize pass of the
    card's forward is recomputed on the CPU from the card's own operands and
    must give the same bits, and every QuantDense layer (the MLPs and the
    head: products, rescale and bias) must give the same bits on the card's
    own input: the int8 work is exact on both. End to end the two differ by
    more: their float work (LayerNorm, softmax, the attention products)
    rounds in other orders, by ~1e-6, and wherever that moves an activation
    across a rounding boundary its int8 code differs by one, which the next
    layers carry on. That gap is reported beside the float32 model's own
    card-to-CPU gap and held to the int8 envelope, 0.05."""
    from chambers_tpu_torch.models.backbones.vision_transformer import ViTB16

    card = ViTB16(seed=0, device=dev)
    card.load_state_dict(state_dict)
    cpu = ViTB16(seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    float_rel = rel_l2(card(x).cpu(), cpu(x.cpu()))
    tq.quantize_model(card)
    tq.load_quantized_state_dict(
        cpu, {k: v.cpu() for k, v in card.state_dict().items()})

    quantized, products, dense = [], [], []
    plain_quantize, plain_int_mm = tq.dynamic_quantize, tq.int_mm

    def quantize(x, reduce_axes=(-1,)):
        q, s = plain_quantize(x, reduce_axes)
        quantized.append((x.cpu(), reduce_axes, q.cpu(), s.cpu()))
        return q, s

    def int_mm(x_q, w, n):
        acc = plain_int_mm(x_q, w, n)
        products.append((x_q.cpu(), w.cpu(), n, acc.cpu()))
        return acc

    cpu_layers = dict(cpu.named_modules())
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: dense.append((name, i[0].cpu(), o.cpu())))
        for name, m in card.named_modules() if isinstance(m, tq.QuantDense)]
    tq.dynamic_quantize, tq.int_mm = quantize, int_mm
    try:
        got = card(x).cpu()
    finally:
        tq.dynamic_quantize, tq.int_mm = plain_quantize, plain_int_mm
        for h in hooks:
            h.remove()
    for inp, axes, q, s in quantized:
        q2, s2 = tq.dynamic_quantize(inp, axes)
        check(torch.equal(q, q2) and torch.equal(s, s2),
              f"int8 codes and scales on the card equal the CPU's "
              f"({tuple(inp.shape)})")
    for x_q, w, n, acc in products:
        check(torch.equal(acc, tq.int_mm(x_q, w, n)),
              f"_int_mm on the card equals the CPU's ({tuple(x_q.shape)} x "
              f"{tuple(w.shape)})")
    for name, inp, out in dense:
        check(torch.equal(out, cpu_layers[name](inp)),
              f"int8 QuantDense {name} on the card equals the CPU's")
    want = cpu(x.cpu())
    rel = rel_l2(got, want)
    log(f"float32 int8 ViT-B/16, card vs CPU (4 images): {len(quantized)} "
        f"quantize passes, {len(products)} int8 products and {len(dense)} "
        f"QuantDense layers bit-equal on the card's own operands; end to "
        f"end rel L2 {rel:.3g} (max |d| {float((got - want).abs().max()):.3g})"
        f" where the float32 model's is {float_rel:.3g}")
    depth = len(card.encoder.layers)
    check(len(products) == 4 * depth + 1 and len(dense) == 2 * depth + 1,
          "every int8 product of the forward was held")
    check(rel < 0.05, "int8 model on the card within the int8 envelope of "
                      "the CPU's")


def int8_serving_path(torch, wk, dev, aug, rand_images):
    """Phase 12 (a): bench.py's config 1 served through int8 PTQ, in
    bench.py's order (fold the normalization, then quantize), timed in
    turns with the same bf16 model; its logits against the bf16 model's
    (the JAX package's envelope, 0.05) and a float32 int8 model on the card
    against the same model on the CPU (:func:`check_int8_against_cpu`).
    Returns the timed runs and profiles of both."""
    import copy

    from chambers_tpu_torch import quantization as tq
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        ViTB16,
        fold_imagenet_normalization,
    )

    bf16 = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16, seed=0,
                  device=dev)
    bf16.load_state_dict(fold_imagenet_normalization(bf16.state_dict()))
    int8 = tq.quantize_model(copy.deepcopy(bf16))
    pool = [rand_images() for _ in range(STEPS)]
    gen = torch.Generator(device=dev).manual_seed(12)

    def stepper(model):
        def step(i):
            draws = aug.sample(BATCH, (SIZE, SIZE), gen, dev)
            return model(aug.apply(pool[i % len(pool)], draws))
        return step

    results = {}
    with torch.inference_mode():
        for r in range(REPEATS):  # in turns: bf16, int8, bf16, int8, ...
            for name, model in (("bf16", bf16), ("int8", int8)):
                runs, launches, logits = timed_runs(
                    torch, wk, stepper(model), 1, STEPS,
                    WARMUP if r == 0 else 0)
                check(tuple(logits.shape) == (BATCH, 1000)
                      and bool(torch.isfinite(logits).all()),
                      f"finite [32, 1000] logits ({name})")
                res = results.setdefault(name, {"runs": [], "k1": 0})
                res["runs"] += runs
                res["k1"] += launches["fused_round"]
        for name, res in results.items():
            ms = sorted(res["runs"])[len(res["runs"]) // 2]
            res["ms"] = ms
            log(f"int8 path (a), ViT-B/16 {name}: median of {REPEATS} runs "
                f"of {STEPS} steps {ms:.3f} ms/batch, "
                f"{BATCH / (ms / 1e3):.1f} img/s (runs "
                f"{', '.join(f'{x:.3f}' for x in res['runs'])}), batch "
                f"{BATCH}, {SIZE} px, K1 launches {res['k1']} on {CARD}")
        check(results["int8"]["k1"] == 2 * STEPS * REPEATS,
              "K1 launched twice per step on the int8 path")

        draws = aug.sample(BATCH, (SIZE, SIZE), gen, dev)
        x = aug.apply(pool[0], draws)
        augment_ms = cuda_ms(torch, lambda: aug.apply(pool[0], draws), 20)
        for name, model in (("bf16", bf16), ("int8", int8)):
            results[name]["augment_ms"] = augment_ms
            results[name]["forward_ms"] = cuda_ms(torch, lambda: model(x), 20)
            log(f"int8 path (a) breakdown, {name}: RandAugment(2,10) "
                f"{augment_ms:.3f} ms, ViT-B/16 {results[name]['forward_ms']:.3f}"
                f" ms per batch of {BATCH} (CUDA events) on {CARD}")
        rel = rel_l2(int8(x), bf16(x))
        log(f"int8 vs bf16 ViT-B/16 logits (32 images): rel L2 {rel:.4f} "
            f"(the JAX package's envelope 0.05)")
        check(rel < 0.05, "int8 logits within 0.05 of the bf16 model's")

        check_int8_against_cpu(torch, tq, bf16.state_dict(), x[:4], dev)

        for name, model in (("bf16", bf16), ("int8", int8)):
            prof = profile_by_kind(torch, stepper(model), 3)
            results[name]["profile"] = prof
            log(prof["table"])
            log(f"int8 path (a), ViT-B/16 {name} profile: "
                f"{prof['device_ms']:.3f} ms of device time and "
                f"{prof['launches']:.0f} kernel launches a step; by kind "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            prof["by_kind_ms"].items())
                + f" ms (matrix-product kernels by name "
                f"{prof['gemm_named_ms']:.3f} ms) on {CARD}")
    return results


def autoaugment_vitl_path(torch, wk, dev):
    """Phase 13 (b): AutoAugment -> ViT-L/16 at 384 px, batch 128, bf16
    with bf16 scores, then int8, at full depth. The two compositions
    bit-equal at [128, 384, 384, 3]; logits of 8 images at the phase-6
    gate (cosine 0.98) of a float32 reference; timed runs and profiles.
    Returns the results, K1's arguments for both stages of one draw on
    one batch (phase 14) and the launch counts."""
    import copy

    from chambers_tpu_torch import quantization as tq
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        AutoAugment,
    )
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        ViTL16,
        fold_imagenet_normalization,
    )

    gen = torch.Generator(device=dev).manual_seed(13)

    def batch():
        return torch.randint(0, 256, (L_BATCH, L_SIZE, L_SIZE, 3),
                             dtype=torch.uint8, device=dev, generator=gen)

    aug = AutoAugment(elementwise=True)
    masked = AutoAugment(elementwise=True, fused_round_kernel=False)
    pool = [batch() for _ in range(4)]
    draws = aug.sample(L_BATCH, gen, dev)
    a = aug.apply(pool[0], draws)
    torch.cuda.synchronize()
    wk.transform_affine_separable.launches = 0
    b = masked.apply(pool[0], draws)
    torch.cuda.synchronize()
    k2_launches = wk.transform_affine_separable.launches
    check(k2_launches == 2, "K2 launched once per stage (masked)")
    diff = int((a != b).sum())
    log(f"AutoAugment fused (K1) vs masked (K2) at [128, 384, 384, 3]: "
        f"{diff} differing bytes; {int((a != pool[0]).sum())} bytes changed "
        f"by the policy")
    check(diff == 0, "AutoAugment's compositions bit-equal at 384 px")

    augment_ms = cuda_ms(torch, lambda: aug.apply(pool[0], draws), 5)
    shape = dict(input_shape=(L_SIZE, L_SIZE, 3), seed=0, device=dev)
    bf16 = ViTL16(dtype=torch.bfloat16, score_dtype=torch.bfloat16, **shape)
    bf16.load_state_dict(fold_imagenet_normalization(bf16.state_dict()))
    int8 = tq.quantize_model(copy.deepcopy(bf16))
    results = {}
    with torch.inference_mode():
        ref = ViTL16(**shape)
        ref.load_state_dict(bf16.state_dict())
        want = ref(a[:8])
        del ref
        for name, model in (("bf16", bf16), ("int8", int8)):
            got = model(a[:8])
            cos, rel = cosine(torch, got, want), rel_l2(got, want)
            log(f"ViT-L/16 384 px {name} vs float32 (8 images): cosine "
                f"{cos:.5f}, rel L2 {rel:.4f}")
            check(cos >= 0.98 and bool(torch.isfinite(got).all()),
                  f"ViT-L/16 {name} logits follow the float32 ones")

        for name, model in (("bf16", bf16), ("int8", int8)):
            def step(i, model=model):
                d = aug.sample(L_BATCH, gen, dev)
                return model(aug.apply(pool[i % len(pool)], d))

            torch.cuda.reset_peak_memory_stats()
            runs, launches, logits = timed_runs(torch, wk, step, L_REPEATS,
                                                L_STEPS, L_WARMUP)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            forward_ms = cuda_ms(torch, lambda: model(a), 2)
            check(tuple(logits.shape) == (L_BATCH, 1000)
                  and bool(torch.isfinite(logits).all()),
                  f"finite [128, 1000] logits ({name})")
            check(launches["fused_round"] == 2 * L_STEPS * L_REPEATS,
                  "K1 launched once per stage")
            ms = sorted(runs)[len(runs) // 2]
            prof = profile_by_kind(torch, step, 2)
            results[name] = {"ms": ms, "runs": runs, "launches": launches,
                             "peak_gib": peak, "profile": prof,
                             "forward_ms": forward_ms,
                             "augment_ms": augment_ms}
            log(prof["table"])
            log(f"AutoAugment -> ViT-L/16 384 px {name} (b): median of "
                f"{L_REPEATS} runs of {L_STEPS} steps {ms:.3f} ms/batch, "
                f"{L_BATCH / (ms / 1e3):.1f} img/s (runs "
                f"{', '.join(f'{x:.3f}' for x in runs)}); AutoAugment "
                f"{augment_ms:.3f} ms and the model {forward_ms:.3f} ms alone "
                f"(CUDA events); peak memory "
                f"{peak:.2f} GiB, launches {launches}; profile "
                f"{prof['device_ms']:.3f} ms of device time and "
                f"{prof['launches']:.0f} kernel launches a step, by kind "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            prof["by_kind_ms"].items())
                + f" ms (matrix-product kernels by name "
                f"{prof['gemm_named_ms']:.3f} ms) on {CARD}")
    stages = []
    for s, d in enumerate(draws["stages"]):
        op_idx = aug.stage_ops(draws, s)
        mats = aug.stage_matrices(op_idx, d["sign"], L_SIZE, L_SIZE)
        stages.append(aug.fused_stage_args(pool[0], mats, op_idx, d["do"]))
    del bf16, int8, pool
    # K1's count is path (b)'s timed runs; K2 does not run on path (b)
    # (the default composition is K1's), so its count is the masked
    # composition check's above, counted from 0
    launches = {"fused_round": {f"path (b) {n}": r["launches"]["fused_round"]
                                for n, r in results.items()},
                "warp": {"masked composition check": k2_launches}}
    return results, stages, launches


def check_kernels_at_384(torch, wk, stages):
    """K1 and K2 against their plain versions at [128, 384, 384, 3], pad
    48, on both stages of a real AutoAugment draw: K1 on the stage's class
    mix and with every image a WARP, K2 on the stage's matrices. Bit
    equality is required. Returns ``{kernel: (bit_equal, max_abs_err)}``."""
    errors = {"fused_round": 0, "warp": 0}
    for s, stage in enumerate(stages):
        images, mats, pad = stage["images"], stage["transforms"], stage["pad"]
        b, h, w, _ = images.shape
        all_warp = dict(stage, op_class=torch.full_like(stage["op_class"],
                                                        wk.WARP))
        for label, args in (("the stage's classes", stage),
                            ("every image a WARP", all_warp)):
            got = wk.fused_round(**args)
            want = wk.fused_round_plain(images, *wk.fused_round_args(**args))
            diff = int((got != want).sum())
            log(f"K1 vs plain at {list(images.shape)}, pad {pad}, stage {s}, "
                f"{label}: {diff} differing bytes")
            check(diff == 0, "K1 bit-equal to its plain version at 384 px")
            errors["fused_round"] = max(errors["fused_round"],
                                        max_abs_diff(got, want))
        got = wk.transform_affine_separable(images, mats, stage["fill_value"],
                                            pad)
        want = wk.warp_plain(images, *wk._shift_vectors(mats, b, h, w, pad),
                             stage["fill_value"], pad)
        diff = int((got != want).sum())
        log(f"K2 vs plain at {list(images.shape)}, pad {pad}, stage {s}: "
            f"{diff} differing bytes; {int((got != images).sum())} bytes "
            f"moved by the warp")
        check(diff == 0, "K2 bit-equal to its plain version at 384 px")
        errors["warp"] = max(errors["warp"], max_abs_diff(got, want))
        del got, want
    return {k: (True, v) for k, v in errors.items()}


def time_kernels_at_384(torch, wk, dev, stages, launches):
    """Phase 14 (c): K1 and K2 at [128, 384, 384, 3], 56.6 MB each way,
    more than the 50 MB L2: first held bit-equal to their plain versions
    there (:func:`check_kernels_at_384`), then timed, K1 on the class mix
    of a real AutoAugment stage, K2 on its matrices, against the bytes
    bound and a device ``copy_`` of the same bytes. Returns the
    ``shape_384`` entries of the two rows."""
    held = check_kernels_at_384(torch, wk, stages)
    stage = stages[0]
    gen = torch.Generator(device=dev).manual_seed(14)
    cold = [torch.randint(0, 256, (L_BATCH, L_SIZE, L_SIZE, 3),
                          dtype=torch.uint8, device=dev, generator=gen)
            for _ in range(3)]
    turn = iter(range(10 ** 9))

    def nxt():
        return cold[next(turn) % len(cold)]

    kw = {k: v for k, v in stage.items() if k != "images"}
    k1_args = wk.kernel_round_args(cold[0], **kw)
    classes = k1_args[1]
    kinds = {name: int((classes == k).sum()) for name, k in (
        ("warp", wk.WARP), ("color", wk.COLOR), ("passthrough",
                                                  wk.PASSTHROUGH))}
    mats, pad = stage["transforms"], stage["pad"]
    k2_t = wk._device_transforms(mats, L_BATCH, dev)
    out = torch.empty_like(cold[0])
    img_bytes = cold[0].numel()
    flat = torch.empty(img_bytes, dtype=torch.uint8, device=dev)
    copy_ms = cuda_ms(torch, lambda: flat.copy_(nxt().view(-1)), 30,
                      backlog=True)
    per_byte = {"passthrough": 1, "warp": 10, "color": 12}
    pixels = L_SIZE * L_SIZE * 3
    specs = {
        "fused_round": (lambda: wk.launch_fused_round(nxt(), out, *k1_args),
                        2 * img_bytes + 32 * L_BATCH + L_BATCH * (4 + 16 + 4),
                        sum(per_byte[k] * n for k, n in kinds.items())
                        * pixels),
        "warp": (lambda: wk.launch_warp(nxt(), out, k2_t, FILL, pad),
                 2 * img_bytes + 32 * L_BATCH, 10 * img_bytes),
    }
    entries = {}
    for name, (bare, nbytes, ops) in specs.items():
        ms = cuda_ms(torch, bare, 30, backlog=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        entries[name] = {
            "shape": [L_BATCH, L_SIZE, L_SIZE, 3], "ms": ms,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "copy_ms": copy_ms, "launches": launches[name],
            "bit_equal": held[name][0], "max_abs_err": held[name][1],
            "class_mix": kinds if name == "fused_round" else None,
            "pad": pad}
        log(f"{name} at [128, 384, 384, 3]: kernel {ms * 1e3:.2f} us "
            f"({bound / ms:.0%} of the {entries[name]['bound_by']} bound "
            f"{bound * 1e3:.2f} us), copy_ of the images {copy_ms * 1e3:.2f} "
            f"us{'; classes ' + str(kinds) if name == 'fused_round' else ''}"
            f" on {CARD}")
    del cold
    return entries


def int_mm_shapes():
    """(label, m, k, n) of every int8 product of the two int8 paths: the
    tokens of a batch times each projection and MLP weight, and the heads
    at m = 32 and 128."""
    b_m, l_m = BATCH * 197, L_BATCH * 577
    return [("ViT-B/16 b32 qkv", b_m, 768, 2304),
            ("ViT-B/16 b32 proj", b_m, 768, 768),
            ("ViT-B/16 b32 mlp1", b_m, 768, 3072),
            ("ViT-B/16 b32 mlp2", b_m, 3072, 768),
            ("ViT-L/16 b128 qkv", l_m, 1024, 3072),
            ("ViT-L/16 b128 proj", l_m, 1024, 1024),
            ("ViT-L/16 b128 mlp1", l_m, 1024, 4096),
            ("ViT-L/16 b128 mlp2", l_m, 4096, 1024),
            ("ViT-B/16 head m32", 32, 768, 1000),
            ("ViT-B/16 head m128", 128, 768, 1000),
            ("ViT-L/16 head m32", 32, 1024, 1000),
            ("ViT-L/16 head m128", 128, 1024, 1000)]


def time_int_mm(torch, dev):
    """Phase 15 (d): ``quantization.int_mm`` at the int8 paths' shapes in
    both weight layouts, exact against the int32 product (taken in float64,
    where every partial sum is an integer under 2^53), against the int8
    bound and a bf16 ``torch.matmul`` of the same shape (a yardstick)."""
    from chambers_tpu_torch import quantization as tq

    gen = torch.Generator(device=dev).manual_seed(15)
    rows = []
    for label, m, k, n in int_mm_shapes():
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev,
                          generator=gen)
        want = x.double() @ w.double()
        row = {"shape": label, "m": m, "k": k, "n": n}
        # the package's column-major operand ("nk", an [n, k] row-major
        # tensor's transpose) and a row-major one ("kn")
        column_major = tq.gemm_operand(w)
        for layout, operand in (("nk", column_major),
                                ("kn", column_major.contiguous())):
            acc = tq.int_mm(x, operand, n)
            check(torch.equal(acc.double(), want),
                  f"_int_mm exact at {label} ({layout})")
            row[f"ms_{layout}"] = cuda_ms(
                torch, lambda: tq.int_mm(x, operand, n), 20, backlog=True)
        del want
        xb, wb = x.bfloat16(), w.bfloat16()
        row["bf16_matmul_ms"] = cuda_ms(torch, lambda: torch.matmul(xb, wb),
                                        20, backlog=True)
        ops_ms = 2 * m * k * n / INT8_OPS_PER_S * 1e3
        bytes_ms = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        row["bound_ms"] = max(ops_ms, bytes_ms)
        row["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        row["exact"] = True
        rows.append(row)
        best = min(row["ms_nk"], row["ms_kn"])
        log(f"_int_mm {label} [{m} x {k} -> {n}]: exact; nk "
            f"{row['ms_nk'] * 1e3:.1f} us, kn {row['ms_kn'] * 1e3:.1f} us, "
            f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}; best "
            f"at {row['bound_ms'] / best:.0%}), bf16 matmul "
            f"{row['bf16_matmul_ms'] * 1e3:.1f} us on {CARD}")
        del x, w, xb, wb
    return rows


# ---------------------------------------------------------------------------
# 16-18. cached generation on the seq2seq model, K3a at one query row, and
# the metric-learning train step (ViT-S/16 + MS loss + AdamW)
# ---------------------------------------------------------------------------

GEN_LEN = 128              # decode steps of the generation phase
GEN_CHECK_LEN = 16         # steps of the float32 cached/recompute check
# bench.py's config 4: ViT-S/16 embedder, batch 256 at 224 px, 64 classes
ML = dict(batch=256, size=224, classes=64, width=384, depth=12, heads=6,
          mlp=1536, features=128)
ML_WARMUP, ML_STEPS, ML_REPEATS = 2, 5, 3
BETA_1, BETA_2, ADAM_EPS = 0.9, 0.999, 1e-7


def vits16_decayed_paths():
    """The JAX package's paths of the ViT-S/16 embedder's parameters that
    ``decay_exclude=["bias", "norm"]`` leaves to weight decay, listed as
    data (``tests/test_torch_optimizers.py`` holds the list to JAX's
    ``decay_mask``)."""
    per_layer = ["dense1/kernel", "dense2/kernel"] + [
        f"multi_head_attention/{w}_{name}" for w in ("w", "b")
        for name in ("query", "value", "key", "projection")]
    return (["add_cls_token/embeddings", "feature/kernel",
             "patch_embeddings/kernel", "pos_embedding/embeddings"]
            + [f"encoder/layers_{i}/{p}" for i in range(ML["depth"])
               for p in per_layer])


class shape_tally:
    """Within the block, every K3a launch is also tallied by its ``(tq,
    tk)`` (``counts``: which attention a launch served) and by the head
    size it ran at (``widths``: a padded call shows there). It wraps
    ``flash_attention.launch_forward`` and leaves the wrapper's own count
    as it is."""

    def __init__(self, fa):
        self.fa, self.counts, self.widths = fa, {}, {}

    def __enter__(self):
        self.saved = self.fa.launch_forward

        def tallied(q, k, *args, _fn=self.saved):
            key = (q.shape[1], k.shape[1])
            self.counts[key] = self.counts.get(key, 0) + 1
            self.widths[q.shape[2]] = self.widths.get(q.shape[2], 0) + 1
            return _fn(q, k, *args)

        self.fa.launch_forward = tallied
        return self

    def __exit__(self, *exc):
        self.fa.launch_forward = self.saved


def build_seq2seq(torch, dev, dtype, heads=None, impl="flash"):
    """The seq2seq model of phase 9 (seed 0) in eval mode, bf16 or float32,
    on the flash kernels (``impl="xla"``: dense attention), its width over
    ``heads`` heads (phase 9's 8 by default)."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models import Seq2SeqTransformer

    model = Seq2SeqTransformer(
        input_vocab_size=S2S["vocab"], output_vocab_size=S2S["vocab"],
        embed_dim=S2S["dim"], num_heads=heads or S2S["heads"],
        dim_feedforward=4 * S2S["dim"], num_encoder_layers=S2S["layers"],
        num_decoder_layers=S2S["layers"], dropout_rate=0.0, dtype=dtype,
        attention_impl=impl, device=dev)
    return initializers.init_module(
        model, torch.Generator(device=dev).manual_seed(0)).eval()


def generation_path(torch, fa, dev):
    """Phase 16: cached greedy, beam (4, EOS 2, length penalty 0.6) and
    sampled (T 0.8, top-k 50, top-p 0.9) decoding of 128 tokens for 16
    sources of 512 on the bf16 seq2seq model. Checks the K3a launches of a
    cached greedy call, cached against full recompute in float32, and the
    first cached step's bf16 logits against the full-length decoder's.
    Returns the results by mode and the K3a tally by shape."""
    from chambers_tpu_torch.models import (
        beam_search_decode,
        greedy_decode,
        sample_decode,
    )

    model = build_seq2seq(torch, dev, torch.bfloat16)
    src, _ = seq2seq_tokens(torch, dev)
    b, layers = S2S["batch"], S2S["layers"]
    gen = torch.Generator(device=dev)
    modes = {
        "greedy": lambda n: greedy_decode(model, src, max_len=n, bos_id=1),
        "beam": lambda n: beam_search_decode(
            model, src, max_len=n, bos_id=1, beam_size=4, eos_id=2,
            length_penalty=0.6),
        "sample": lambda n: sample_decode(
            model, src, gen.manual_seed(16), max_len=n, bos_id=1,
            temperature=0.8, top_k=50, top_p=0.9),
    }

    # K3a launches of one cached greedy call, by shape
    modes["greedy"](4)
    torch.cuda.synchronize()
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    with shape_tally(fa) as tally:
        out = modes["greedy"](GEN_LEN)
        torch.cuda.synchronize()
    launches = dict(fa.flash_attention.launches)
    want = layers + 2 * layers * GEN_LEN
    log(f"generation: K3a launches of a cached greedy call of {GEN_LEN} "
        f"tokens {launches['fwd']} (want {layers} + 8 x {GEN_LEN} = {want}), "
        f"by (tq, tk) {tally.counts}")
    check(launches["fwd"] == want and launches["dkv"] == 0
          and launches["dq"] == 0,
          "a cached greedy call launches K3a 4 + 8 x max_len times")
    check(tally.counts == {(S2S["t"], S2S["t"]): layers,
                           (1, GEN_LEN): layers * GEN_LEN,
                           (1, S2S["t"]): layers * GEN_LEN},
          "K3a ran the encoder once and 4 self and 4 cross steps a token")
    check(tuple(out.shape) == (b, GEN_LEN) and bool(
        ((out >= 0) & (out < S2S["vocab"])).all()), "greedy tokens [16, 128]")

    # float32 (the FMA kernels): cached decoding equals full recompute
    f32 = build_seq2seq(torch, dev, None)
    for name, decode, kw in (
            ("greedy", greedy_decode, {}),
            ("beam", beam_search_decode, dict(beam_size=4, eos_id=2,
                                              length_penalty=0.6))):
        cached = decode(f32, src, max_len=GEN_CHECK_LEN, bos_id=1,
                        use_cache=True, **kw)
        full = decode(f32, src, max_len=GEN_CHECK_LEN, bos_id=1,
                      use_cache=False, **kw)
        differ = int((cached != full).sum())
        log(f"generation float32 {name}, cached vs full recompute over "
            f"{GEN_CHECK_LEN} steps: {differ} differing tokens of "
            f"{cached.numel()}")
        check(differ == 0, f"float32 cached {name} tokens equal full "
                           "recompute")
    del f32

    # bf16: the first cached step's logits against the full-length
    # decoder's at position 0; the two run the same operations at other
    # shapes (one row against 128), so they round apart by a few bf16
    # steps: cosine 0.999 and max |d| 1/16 of the largest logit
    with torch.no_grad():
        x_enc, mask = model.encode(src, deterministic=True)
        cache = model.init_cache(x_enc, GEN_LEN)
        bos = torch.ones((b, 1), dtype=torch.long, device=dev)
        step0, _ = model.decode_step(bos, 0, x_enc, mask, GEN_LEN, cache)
        buffer = torch.zeros((b, GEN_LEN), dtype=torch.long, device=dev)
        buffer[:, 0] = 1
        full0 = model.decode(buffer, x_enc, mask, deterministic=True)[:, :1]
    got, ref = step0.float().flatten(), full0.float().flatten()
    cos = cosine(torch, got, ref)
    d = float((got - ref).abs().max())
    top = float(ref.abs().max())
    log(f"generation bf16, first cached step vs the full-length decoder at "
        f"position 0: cosine {cos:.6f}, max |d| {d:.4f} of max |logit| "
        f"{top:.4f}")
    check(cos >= 0.999 and d <= top / 16,
          "bf16 first cached step follows the full-length decoder")

    results = {}
    from torch.profiler import ProfilerActivity, profile

    for name, run in modes.items():
        run(GEN_LEN)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs, host = [], []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = run(GEN_LEN)
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            runs.append(start.elapsed_time(end))
        check(tuple(out.shape) == (b, GEN_LEN), f"{name} tokens [16, 128]")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(GEN_LEN)
            torch.cuda.synchronize()
        events = prof.key_averages()
        if name == "greedy":  # which host operations make the launches
            log(events.table(sort_by="count", row_limit=15))
        kinds, counts, names = device_time_by_kind(torch, events)
        ms = min(runs)
        res = {"ms": ms, "runs_ms": runs, "host_ms": host,
               "ms_per_token": ms / GEN_LEN,
               "tokens_s": b * GEN_LEN / (ms / 1e3),
               "device_ms_per_step": {k: v / GEN_LEN
                                      for k, v in kinds.items()},
               "launches_per_step": sum(counts.values()) / GEN_LEN,
               "k3a_per_step": counts["flash_fwd"] / GEN_LEN,
               "busy": sum(kinds.values()) / ms, "peak_gib": peak}
        results[name] = res
        log(f"generation {name}: {ms:.1f} ms for {GEN_LEN} tokens x {b} "
            f"sources (runs {', '.join(f'{x:.1f}' for x in runs)}; host "
            f"clock {', '.join(f'{x:.1f}' for x in host)}), "
            f"{res['ms_per_token']:.3f} ms per decoded token, "
            f"{res['tokens_s']:.0f} tokens/s, peak memory {peak:.2f} GiB; "
            f"device ms a step: " + ", ".join(
                f"{' '.join([k, *sorted(names[k])])} {v:.4f}"
                for k, v in res["device_ms_per_step"].items())
            + f"; {res['launches_per_step']:.1f} kernel launches a step "
            f"({res['k3a_per_step']:.1f} K3a); device busy "
            f"{100 * res['busy']:.1f}% on {CARD}")
        check(names["flash_fwd"] == {"flash_fwd_tc_kernel"},
              f"bf16 {name} decoding runs the tensor-core forward")
    return results, {f"{tq}x{tk}": n for (tq, tk), n in tally.counts.items()}


def time_decode_kernels(torch, fa, dev, tally, h=64, heads=None,
                        kinds=("cross", "self")):
    """Phase 17: K3a at one query row, the cached step's two shapes: q
    ``[128, 1, 64]`` bf16 against k/v ``[128, 512, 64]`` with the ragged
    source mask (cross attention) and against ``[128, 128, 64]`` with a
    validity row half written (self attention, step 64 of 128), each held
    against ``flash_forward_plain`` and timed against its bound and SDPA
    with the same mask. Returns the two rows of the ``kernels`` line.
    Phase 26 takes ``kinds`` at head size ``h`` over ``heads`` heads."""
    F = torch.nn.functional
    b, n = S2S["batch"], heads or S2S["heads"]
    bn, scale = b * n, h ** -0.5
    gen = torch.Generator(device=dev).manual_seed(17)
    half = torch.arange(GEN_LEN, device=dev)[None, :] < GEN_LEN // 2
    cases = (("cross", S2S["t"], ragged_mask(torch, b, S2S["t"], dev)),
             ("self", GEN_LEN, half.expand(b, GEN_LEN)))
    rows = []
    for kind, tk, mask in cases:
        if kind not in kinds:
            continue
        shape = f"[{bn}, 1, {h}] x [{bn}, {tk}, {h}]"
        fmask = mask.float().contiguous()
        # inputs cycled beyond the 50 MB L2, as a decode step finds them
        sets = [tuple(torch.randn((bn, t, h), device=dev, generator=gen)
                      .to(torch.bfloat16) for t in (1, tk, tk))
                for _ in range(max(2, int(64e6 // (2 * bn * tk * h * 2))))]
        turn = iter(range(10 ** 9))

        def nxt():
            return sets[next(turn) % len(sets)]

        q, k, v = sets[0]
        got, l_got, m_got = fa.launch_forward(q, k, v, fmask, scale, False, n)
        want, l_want, m_want = fa.flash_forward_plain(q, k, v, scale, False,
                                                      fmask, n)
        again = fa.launch_forward(q, k, v, fmask, scale, False, n)[0]
        torch.cuda.synchronize()
        rtol, atol, rms = flash_tolerance(torch, torch.bfloat16, want, False)
        err, need, rel = closeness(got, want, rtol)
        log(f"K3a decode {kind} {shape} bf16 vs "
            f"plain: max |d| {err:.3g} (needs atol {need:.3g} <= {atol:.3g} "
            f"at rtol {rtol:.3g}), rel rms {rel:.3g}; l within "
            f"{float((l_got - l_want).abs().max() / l_want.abs().max()):.2g} "
            f"relative; two launches bit-equal "
            f"{bool(torch.equal(got, again))}")
        check(need <= atol and rel <= rms,
              f"K3a at one query row ({kind}) matches its plain version")
        check(torch.equal(got, again), "two K3a launches give the same bits")

        four = (lambda x: x.view(b, n, x.shape[1], h))
        attn_mask = mask[:, None, None, :]
        kernel_ms = cuda_ms(torch, lambda: fa.launch_forward(
            *nxt(), fmask, scale, False, n), 200, backlog=True)
        plain_ms = cuda_ms(torch, lambda: fa.flash_forward_plain(
            *nxt(), scale, False, fmask, n), 20)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            *(four(x) for x in nxt()), attn_mask=attn_mask), 200,
            backlog=True)
        def wrapped():
            q, k, v = (four(x) for x in nxt())
            return fa.flash_attention(q, v, k, kv_mask=mask)

        wrapper_ms = cuda_ms(torch, wrapped, 50)
        valid = int(mask.sum())  # keys this data needs, per head
        nbytes = (bn * h * 2                  # q
                  + 2 * n * valid * h * 2     # the valid rows of k and v
                  + b * tk * 4                # the float32 mask
                  + bn * h * 2 + 2 * bn * 4)  # o, l, m
        ops = 4 * n * valid * h
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_OPS_PER_S * 1e3  # float16's peak is the same
        bound_ms = max(bytes_ms, ops_ms)
        full_kv_ms = 2 * bn * tk * h * 2 / HBM_BYTES_PER_S * 1e3
        launches = tally.get(f"1x{tk}", 0)
        rows.append({
            "name": f"flash_fwd (decode, {kind} attention)", "route": "cuda",
            "source": "chambers_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "replaces": "chambers_tpu/ops/flash_attention.py:190 "
                        "_flash_forward",
            "launches": launches, "max_abs_err": err, "bit_equal": False,
            "ms": kernel_ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "full_kv_bound_ms": full_kv_ms,
            "shape": f"q x k/v {shape} bf16, {valid} of {b * tk} keys "
                     f"valid",
            "note": "launches: the K3a launches of this shape in phase 16's "
                    "cached greedy call; bound_ms counts the valid keys "
                    "only, full_kv_bound_ms all of k and v; library_ms is "
                    "F.scaled_dot_product_attention with the same mask",
            "card": CARD})
        log(f"K3a decode {kind}: kernel {kernel_ms * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({rows[-1]['bound_by']}; all of k and "
            f"v {full_kv_ms * 1e3:.2f} us), SDPA {lib_ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.1f} us, wrapper call {wrapper_ms * 1e3:.1f} us;"
            f" {launches} launches in the greedy call, on {CARD}")
        del sets
    return rows


def metric_learning_path(torch, dev):
    """Phase 18: bench.py's config 4, uncut: the ViT-S/16 embedder (bf16,
    bf16 scores) at batch 256 of seeded float32 224 px images, labels
    ``arange(256) % 64``, ``MultiSimilarityLoss`` on ``l2_normalize(z)``
    and the port's ``AdamW(weight_decay=1e-4, learning_rate=1e-3,
    decay_exclude=["bias", "norm"])``. Checks the decayed set against the
    JAX package's (as data), the first loss against the same step in
    float32 on the card, and one AdamW update of every parameter against a
    float64 recomputation; times and profiles the step."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.normalization import l2_normalize
    from chambers_tpu_torch.losses import MultiSimilarityLoss
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.optimizers import AdamW, jax_path
    import numpy as np

    def build(dtype):
        return VisionTransformer(
            16, ML["width"], ML["depth"], ML["heads"], ML["mlp"],
            dropout_rate=0.0, image_size=(ML["size"], ML["size"]),
            include_top=False, pooling="cls", feature_dim=ML["features"],
            dtype=dtype, score_dtype=dtype, device=dev)

    model = initializers.init_module(
        build(torch.bfloat16),
        torch.Generator(device=dev).manual_seed(0)).train()
    batch = ML["batch"]
    x = torch.rand((batch, ML["size"], ML["size"], 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(18))
    labels = torch.arange(batch, device=dev) % ML["classes"]
    loss_fn = MultiSimilarityLoss()
    opt = AdamW(model.named_parameters(), weight_decay=1e-4,
                learning_rate=1e-3, decay_exclude=["bias", "norm"])
    names = {id(p): name for name, p in model.named_parameters()}
    decayed = {jax_path(names[id(p)]) for g in opt.param_groups
               if g["decay"] for p in g["params"]}
    listed = set(vits16_decayed_paths())
    log(f"metric learning: {len(decayed)} of {len(names)} parameters decay; "
        f"the JAX package's list has {len(listed)}")
    check(decayed == listed, "the decayed parameters are the JAX package's")

    def loss_of(m):
        z = m(x, deterministic=True)
        return loss_fn(labels, l2_normalize(z, axis=-1))

    # the first step's loss against the same step in float32 on the card
    ref = build(None).train()
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss32 = float(loss_of(ref))
    del ref

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model)
        loss.backward()
        opt.step()
        return loss.detach()

    first = float(step())
    rel = abs(first - loss32) / abs(loss32)
    log(f"metric learning first loss: bf16 {first:.5f}, float32 "
        f"{loss32:.5f} (rel {rel:.3g})")
    # bf16 embeddings move each similarity by ~2^-8, and beta = 40 turns
    # that into a few percent of a negative term: 5% of the loss
    check(math.isfinite(first) and rel <= 0.05,
          "first loss finite and within 5% of the float32 step's")

    # one AdamW update of every parameter against float64: the moments,
    # gradients and parameters from before the update, the bias
    # corrections as optax computes them (float32 betas)
    opt.zero_grad(set_to_none=True)
    loss_of(model).backward()
    count = opt.param_groups[0]["count"]
    before = {n: (p.detach().double(), p.grad.double(),
                  opt.state[p]["mu"].double(), opt.state[p]["nu"].double())
              for n, p in model.named_parameters()}
    decays = {names[id(p)]: g["decay"] for g in opt.param_groups
              for p in g["params"]}
    opt.step()
    c1 = float(1 - np.float32(BETA_1) ** np.float32(count + 1))
    c2 = float(1 - np.float32(BETA_2) ** np.float32(count + 1))
    worst = 0.0
    for n, p in model.named_parameters():
        p0, g, mu0, nu = before[n]
        mu = (1 - BETA_1) * g + BETA_1 * mu0
        nu = (1 - BETA_2) * g * g + BETA_2 * nu
        root = torch.sqrt(nu / c2) + ADAM_EPS
        u = -1e-3 * (mu / c1) / root
        if decays[n]:
            u = u - 1e-4 * p0
        want = p0 + u
        # the size of the terms summed: the parameter and the update with
        # its first moment's two terms taken apart (they can cancel)
        terms = torch.maximum(p0.abs(), 1e-3 * ((1 - BETA_1) * g.abs()
                                                + BETA_1 * mu0.abs())
                              / c1 / root)
        worst = max(worst, float(((p.detach().double() - want).abs()
                                  / terms.clamp(min=1e-30)).max()))
    log(f"metric learning: one AdamW update (step {count + 1}) of all "
        f"{len(before)} parameters against float64, largest error "
        f"{worst:.3g} of the size of the terms summed")
    check(worst <= 1e-6, "AdamW's update equals the float64 recomputation "
                         "to 1e-6")

    for _ in range(ML_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, losses = [], []
    for _ in range(ML_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses += [step() for _ in range(ML_STEPS)]
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / ML_STEPS)
    ms = sorted(runs)[len(runs) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), "finite losses")
    prof = profile_train_step(torch, model, opt, loss_of, 2)
    log(prof.pop("table"))
    res = {"ms": ms, "runs": runs, "img_s": batch / (ms / 1e3),
           "profile": prof, "peak_gib": peak,
           "busy": prof["device_ms"] / ms, "losses": losses,
           "first_loss": first, "first_loss_f32": loss32}
    log(f"metric-learning train step (ViT-S/16 b{batch} bf16 + MS loss + "
        f"AdamW): median of {ML_REPEATS} runs of {ML_STEPS} steps "
        f"{ms:.3f} ms/step, {res['img_s']:.1f} img/s (runs "
        f"{', '.join(f'{r:.3f}' for r in runs)}), peak memory {peak:.2f} "
        f"GiB; kernels {prof['device_ms']:.3f} ms a step (busy "
        f"{100 * res['busy']:.1f}%), {prof['launches']:.0f} launches; by "
        f"phase " + ", ".join(f"{k} {v:.3f}" for k, v in
                              prof["by_phase_ms"].items())
        + f" ms; matrix products {prof['gemm_ms']:.3f} ms; the optimizer "
        f"spans {prof['optimizer_span_ms']:.3f} ms of the device timeline "
        f"for {prof['optimizer_launches']:.0f} launches; losses "
        f"{[round(v, 4) for v in losses]} on {CARD}")
    return res


def kernels_under(event):
    """Kernels launched by a profiled host event and its children."""
    return len(event.kernels) + sum(kernels_under(c)
                                    for c in event.cpu_children)


def profile_train_step(torch, model, opt, loss_of, n, inner=()):
    """Device ms a train step over ``n`` profiled steps, by phase: the
    forward with the loss and the optimizer under ``record_function``
    ranges (their kernels, read from the host side), the backward the
    rest; ranges named in ``inner``, which ``loss_of`` opens inside the
    forward, are taken out of it as phases of their own; matrix-product
    kernels by name; launches; and the span of the optimizer's own range
    on the device timeline (its kernels and the gaps between them, which a
    host-bound optimizer leaves); and the profile's averaged events, as
    ``events``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    phases = ("forward and loss", "optimizer")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            with record_function(phases[0]):
                loss = loss_of(model)
            loss.backward()
            with record_function(phases[1]):
                opt.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = device_kernels(torch, events)
    total = sum(e.self_device_time_total for e in cuda) / 1e3 / n
    host = {e.key: e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    by_phase = {p: host[p].device_time_total / 1e3 / n for p in phases}
    for name in inner:  # a range that launched nothing is not recorded
        by_phase[name] = (host[name].device_time_total / 1e3 / n
                          if name in host else 0.0)
        by_phase[phases[0]] -= by_phase[name]
    by_phase["backward"] = total - sum(by_phase.values())
    span = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key.startswith("Optimizer.step")) / 1e3 / n
    return {"device_ms": total, "by_phase_ms": by_phase,
            "gemm_ms": sum(e.self_device_time_total for e in cuda if any(
                w in e.key.lower() for w in (
                    "gemm", "nvjet", "cutlass", "xmma", "cublas")))
            / 1e3 / n,
            "launches": sum(e.count for e in cuda) / n,
            "optimizer_launches": sum(
                kernels_under(e) for e in prof.events()
                if e.name == phases[1]) / n,
            "optimizer_span_ms": span,
            "table": events.table(sort_by="self_device_time_total",
                                  row_limit=12),
            "events": events}


# ---------------------------------------------------------------------------
# 19. the DETR train step (bench.py's config 5) in its three matcher modes
# ---------------------------------------------------------------------------

# bench.py's config 5, uncut: DETR with 6 + 6 layers, width 256, 8 heads,
# MLP 2048 and 100 queries over 91 classes, batch 8 at 224 px, 20 target
# slots; the loss sums the decoder's 6 layers
DETR = dict(batch=8, size=224, classes=91, targets=20, queries=100,
            width=256, heads=8, mlp=2048, layers=6)
DETR_WARMUP, DETR_STEPS, DETR_REPEATS = 2, 5, 3
# BENCH_DETR_MATCHER's modes; "hungarian" is bench.py's "callback"
DETR_MODES = ("auction", "precomputed", "hungarian")
DETR_EPS, DETR_ITERS = 1e-2, 200    # DETRLoss's auction defaults


def detr_decayed_paths():
    """The JAX package's paths of DETR's parameters that
    ``decay_exclude=["bias", "norm"]`` leaves to weight decay, listed as
    data (``tests/test_torch_detection.py`` holds the list to JAX's
    ``decay_mask``)."""
    attention = [f"{w}_{name}" for w in ("w", "b")
                 for name in ("query", "value", "key", "projection")]
    dense = ["dense1/kernel", "dense2/kernel"]
    layers = range(DETR["layers"])
    return (["backbone/kernel", "class_head/kernel", "query_embed"]
            + [f"bbox_head_{i}/kernel" for i in range(3)]
            + [f"encoder/layers_{i}/{p}" for i in layers
               for p in dense + [f"multi_head_attention/{a}"
                                 for a in attention]]
            + [f"decoder/layers_{i}/{p}" for i in layers
               for p in dense + [f"multi_head_attention{k}/{a}"
                                 for k in (1, 2) for a in attention]])


def detr_batch(torch, dev):
    """bench.py's batch, drawn from ``RandomState(0)`` in its order:
    images, labels, boxes, then ``mask = rand < 0.6``."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, t = DETR["batch"], DETR["targets"]
    x = rng.rand(b, DETR["size"], DETR["size"], 3).astype(np.float32)
    labels = rng.randint(0, DETR["classes"], (b, t))
    boxes = rng.rand(b, t, 4).astype(np.float32)
    mask = rng.rand(b, t) < 0.6
    targets = {"labels": labels, "boxes": boxes, "mask": mask}
    return (torch.from_numpy(x).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in targets.items()})


def detr_layer_costs(torch, det, outputs, targets):
    """The matching costs ``[L·b, t, q]`` of every decoder layer's outputs,
    folded as ``DETRLoss``'s one auction over all layers folds them."""
    logits, boxes = outputs["logits"], outputs["boxes"]
    b, n_layers = logits.shape[:2]

    def fold(v):
        return v.transpose(0, 1).reshape((n_layers * b,) + v.shape[2:])

    def tile(v):
        return torch.cat([v] * n_layers, dim=0)

    return det.matching_cost_matrix(
        fold(logits), fold(boxes), tile(targets["labels"]),
        tile(targets["boxes"]), tile(targets["mask"]))


def check_detr_auction(torch, det, cost):
    """On one step's costs: the card's auction equals the plain CPU run of
    the same function on the same costs, every problem's columns are
    distinct and each total lies within ``n·eps`` of scipy's optimum.
    Returns the iterations the loop ran (every problem in lockstep)."""
    import numpy as np

    got = det.auction_assignment(cost, eps=DETR_EPS, max_iters=DETR_ITERS)
    want = det.auction_assignment(cost.cpu(), eps=DETR_EPS,
                                  max_iters=DETR_ITERS)
    same = bool(torch.equal(got.cpu(), want))
    cols = got.cpu().numpy()
    n = cost.shape[1]
    distinct = all(len(set(row)) == n for row in cols)
    _, iterations = det._auction_rows(-cost.to(torch.float32), DETR_EPS,
                                      DETR_ITERS, 1)
    c = cost.cpu().numpy().astype(np.float64)
    best = det._lsa_host(c)
    rows = np.arange(n)
    gaps = [float(ci[rows, a].sum() - ci[rows, o].sum())
            for ci, a, o in zip(c, cols, best)]
    log(f"DETR auction on one step's costs {tuple(cost.shape)}: card equals "
        f"its CPU run: {same}; distinct columns: {distinct}; {iterations} "
        f"iterations (of {DETR_ITERS}); largest gap to scipy's optimum "
        f"{max(gaps):.3g} (bound n·eps = {n * DETR_EPS:.3g}); "
        f"{sum(g > 0 for g in gaps)} of {len(gaps)} problems above it "
        f"by any amount")
    check(same, "the auction on the card equals its CPU run")
    check(distinct, "every problem's columns are distinct")
    check(max(gaps) <= n * DETR_EPS, "each total within n·eps of scipy's")
    return iterations


def detr_path(torch, dev):
    """Phase 19: bench.py's config 5, uncut: the DETR train step in bf16
    (``deterministic=True``, as bench.py's step) with the loss summed over
    the 6 decoder layers and the port's ``AdamW(weight_decay=1e-4,
    learning_rate=1e-4, decay_exclude=["bias", "norm"])``, each step adding
    ``1e-4 * i`` to the input, in the three matcher modes. Checks the
    decayed set against the JAX package's (as data), the first loss
    against the same step in float32 and the auction on one step's costs;
    times and profiles each mode."""
    from torch.profiler import record_function

    from chambers_tpu_torch.losses import detection as det
    from chambers_tpu_torch.models.detection import build_detr
    from chambers_tpu_torch.optimizers import AdamW, jax_path

    x, targets = detr_batch(torch, dev)

    def build(dtype):
        return build_detr(
            num_classes=DETR["classes"],
            input_shape=(DETR["size"], DETR["size"], 3),
            num_queries=DETR["queries"], embed_dim=DETR["width"],
            num_heads=DETR["heads"], ff_dim=DETR["mlp"],
            num_encoder_layers=DETR["layers"],
            num_decoder_layers=DETR["layers"], aux_loss=True, dtype=dtype,
            seed=0, device=dev).train()

    def optimizer(model):
        return AdamW(model.named_parameters(), weight_decay=1e-4,
                     learning_rate=1e-4, decay_exclude=["bias", "norm"])

    model = build(torch.bfloat16)
    opt = optimizer(model)
    names = {id(p): name for name, p in model.named_parameters()}
    decayed = {jax_path(names[id(p)]) for g in opt.param_groups
               if g["decay"] for p in g["params"]}
    listed = set(detr_decayed_paths())
    log(f"DETR: {len(decayed)} of {len(names)} parameters decay; the JAX "
        f"package's list has {len(listed)}")
    check(decayed == listed, "DETR's decayed parameters are the JAX "
                             "package's")

    # the first step's loss against the same step in float32 on the card,
    # each matched by its own auction
    auction_loss = det.DETRLoss(DETR["classes"], matcher="auction")
    ref = build(None)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss32 = float(auction_loss(ref(x, deterministic=True), targets))
    del ref

    # each mode trains its own model from the same weights; the timed runs
    # go in turns, so that the host's speed, which sets a step's time,
    # weighs on every mode alike
    modes = {}
    for mode in DETR_MODES:
        if mode != DETR_MODES[0]:
            model = build(torch.bfloat16)
            opt = optimizer(model)
        loss_fn = det.DETRLoss(
            DETR["classes"],
            matcher="auction" if mode == "auction" else "hungarian")
        precomputed = None
        if mode == "precomputed":
            with torch.no_grad():
                precomputed = loss_fn.match(model(x, deterministic=True),
                                            targets)
        modes[mode] = (model, opt, loss_fn, precomputed)

    def step(mode, i):
        model, opt, loss_fn, precomputed = modes[mode]
        opt.zero_grad(set_to_none=True)
        out = model(x + 1e-4 * i, deterministic=True)
        loss = loss_fn(out, targets, assignment=precomputed)
        loss.backward()
        opt.step()
        return loss.detach()

    first = {mode: float(step(mode, 0)) for mode in DETR_MODES}
    rel = abs(first["auction"] - loss32) / abs(loss32)
    log(f"DETR first loss: bf16 {first['auction']:.5f}, float32 "
        f"{loss32:.5f} (rel {rel:.3g})")
    check(math.isfinite(first["auction"]) and rel <= 0.05,
          "DETR's first loss finite and within 5% of the float32 step's")
    for mode in DETR_MODES:
        for i in range(1, DETR_WARMUP):
            step(mode, i)
    torch.cuda.synchronize()
    runs = {mode: [] for mode in DETR_MODES}
    losses = {mode: [] for mode in DETR_MODES}
    peak = dict.fromkeys(DETR_MODES, 0.0)
    for _ in range(DETR_REPEATS):
        for mode in DETR_MODES:
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses[mode] += [step(mode, i) for i in range(DETR_STEPS)]
            end.record()
            end.synchronize()
            runs[mode].append(start.elapsed_time(end) / DETR_STEPS)
            peak[mode] = max(peak[mode],
                             torch.cuda.max_memory_allocated() / 2 ** 30)

    results = {}
    for mode in DETR_MODES:
        model, opt, loss_fn, precomputed = modes[mode]
        ms = sorted(runs[mode])[len(runs[mode]) // 2]
        mode_losses = [float(v) for v in losses[mode]]
        check(all(math.isfinite(v) for v in mode_losses),
              f"DETR {mode}: finite losses")

        # the profiled step runs the same work with the matcher taken out
        # of the loss call, under a range of its own
        def loss_of(m, mode=mode, loss_fn=loss_fn, precomputed=precomputed):
            out = m(x, deterministic=True)
            with record_function("matcher"):
                if mode == "auction":
                    assignment = loss_fn._auction_all_layers(
                        out["logits"], out["boxes"], targets)
                elif mode == "hungarian":
                    assignment = loss_fn.match(out, targets)
                else:
                    assignment = precomputed
            return loss_fn(out, targets, assignment=assignment)

        prof = profile_train_step(torch, model, opt, loss_of, 2,
                                  inner=("matcher",))
        log(prof.pop("table"))
        with torch.no_grad():
            out = model(x, deterministic=True)
            cost = detr_layer_costs(torch, det, out, targets)
            # the matcher's wall time alone: the host's clock around one
            # call that ends in a synchronize, median of 5
            matcher_ms = 0.0
            if mode != "precomputed":
                matcher = (
                    (lambda: loss_fn._auction_all_layers(
                        out["logits"], out["boxes"], targets))
                    if mode == "auction" else
                    (lambda: loss_fn.match(out, targets)))
                walls = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    matcher()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                matcher_ms = sorted(walls)[2]
        if mode == "auction":
            iterations = check_detr_auction(torch, det, cost)
        else:
            _, iterations = det._auction_rows(-cost, DETR_EPS, DETR_ITERS, 1)
        res = {"ms": ms, "runs": runs[mode],
               "img_s": DETR["batch"] / (ms / 1e3), "profile": prof,
               "peak_gib": peak[mode], "busy": prof["device_ms"] / ms,
               "auction_iterations": iterations, "matcher_ms": matcher_ms,
               "losses": mode_losses, "first_loss": first[mode]}
        if mode == "auction":
            res["first_loss_f32"] = loss32
        results[mode] = res
        log(f"DETR train step (config 5, b{DETR['batch']} bf16, matcher="
            f"{mode}): median of {DETR_REPEATS} runs of {DETR_STEPS} steps "
            f"(in turns with the other modes) {ms:.3f} ms/step, "
            f"{res['img_s']:.1f} img/s (runs "
            f"{', '.join(f'{r:.3f}' for r in runs[mode])}), peak memory "
            f"{peak[mode]:.2f} GiB; kernels {prof['device_ms']:.3f} ms a "
            f"step (busy {100 * res['busy']:.1f}%), {prof['launches']:.0f} "
            f"launches; by phase " + ", ".join(
                f"{k} {v:.3f}" for k, v in prof["by_phase_ms"].items())
            + f" ms; the matcher takes {matcher_ms:.3f} ms of wall time "
            f"alone; the optimizer spans {prof['optimizer_span_ms']:.3f} ms "
            f"of the device timeline; the auction runs {iterations} "
            f"iterations on this step's costs; losses "
            f"{[round(v, 4) for v in mode_losses]} on {CARD}")
    del modes
    return results


# ---------------------------------------------------------------------------
# 20. the DeiT-B/16 recipe's train step: recipe (MixUp/CutMix, ViT, soft
# cross-entropy) and distilled (DeiT on the flash kernels, hard
# distillation from a frozen ViT-B/16)
# ---------------------------------------------------------------------------

# DeiT-B/16 at DeiT's per-card batch (1024 over 8 cards), 1000 classes
DEIT = dict(batch=128, size=224, classes=1000, patch=16, width=768,
            depth=12, heads=12, mlp=3072)
DEIT_TOKENS = (DEIT["size"] // DEIT["patch"]) ** 2 + 2  # + cls and dist
DEIT_WARMUP, DEIT_STEPS, DEIT_REPEATS = 2, 3, 3
DEIT_DECAY_EXCLUDE = ["bias", "norm", "cls", "dist"]
DEIT_MODES = ("recipe", "distilled")


def deit_decayed_paths():
    """The JAX package's paths of the ViT-B/16 (``recipe``) and DeiT-B/16
    (``distilled``) parameters that the recipe's ``decay_exclude=["bias",
    "norm", "cls", "dist"]`` leaves to weight decay, listed as data; one
    list for both, since ``dist`` excludes the distillation token and the
    ``predictions_dist`` head alike (``tests/test_torch_deit.py`` holds it
    to JAX's ``decay_mask`` on both models)."""
    per_layer = ["dense1/kernel", "dense2/kernel"] + [
        f"multi_head_attention/{w}_{name}" for w in ("w", "b")
        for name in ("query", "value", "key", "projection")]
    return (["patch_embeddings/kernel", "pos_embedding/embeddings",
             "predictions/kernel"]
            + [f"encoder/layers_{i}/{p}" for i in range(DEIT["depth"])
               for p in per_layer])


def deit_teacher(torch, dev):
    """The distilled mode's frozen teacher: the port's ViT-B/16 preset in
    bf16 with bf16 scores, seeded (seed 2), in eval mode, without
    gradients."""
    from chambers_tpu_torch.models.backbones.vision_transformer import ViTB16

    teacher = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16,
                     seed=2, device=dev)
    return teacher.requires_grad_(False)


def check_deit_augmentation(torch, dev, images, labels, aug, norm, mixup,
                            cutmix):
    """Phase 20's augmentation on the card against its CPU run on the same
    draws: whole-batch RandAugment(2, 9) with each of the 16 ops forced
    once (16 images) and two drawn rounds at the whole batch, bit for bit;
    bilinear Rotate (``RandomRotation``), ShearX and ShearY, bit for bit
    (their matrices built on the host in both runs); and
    ``mixup_or_cutmix`` after the 'tf' normalization in both branches,
    within 1e-6."""
    from chambers_tpu_torch.augmentations import (
        RandomRotation,
        ShearX,
        ShearY,
        mixup_or_cutmix,
    )
    from chambers_tpu_torch.augmentations.image_augmentations import (
        to_device,
    )

    host = torch.Generator().manual_seed(200)
    size = (DEIT["size"], DEIT["size"])
    n_few = min(16, images.shape[0])
    few, few_cpu = images[:n_few], images[:n_few].cpu()
    template = aug.sample(n_few, size, host, "cpu")[0]
    changed = []
    for op in range(16):
        d = dict(template, idx=op)
        got = aug.apply(few, [to_device(d, dev)]).cpu()
        want = aug.apply(few_cpu, [d])
        check(torch.equal(got, want),
              f"whole-batch RandAugment op {aug.OP_NAMES[op]} on the card "
              "equals its CPU run")
        changed.append(int((want != few_cpu).sum()))
    log(f"phase 20: whole-batch RandAugment(2, 9), each of the 16 ops forced "
        f"on {n_few} images: card == CPU bit for bit; bytes each op changed: "
        + ", ".join(f"{n} {c}" for n, c in zip(aug.OP_NAMES, changed)))
    draws = aug.sample(DEIT["batch"], size, host, "cpu")
    augmented = aug.apply(images, to_device(draws, dev))
    augmented_cpu = aug.apply(images.cpu(), draws)
    check(torch.equal(augmented.cpu(), augmented_cpu),
          "whole-batch RandAugment(2, 9) at the whole batch, card == CPU")
    log(f"phase 20: two drawn rounds (ops {[d['idx'] for d in draws]}) at "
        f"{list(images.shape)}: card == CPU bit for bit")
    for op in (RandomRotation(0.1), ShearX(0.27, interpolation="bilinear",
                                          fill_value=128),
               ShearY(0.27, interpolation="bilinear", fill_value=128)):
        d = op.sample(n_few, size, host, "cpu")
        got = op.apply(few, d).cpu()
        want = op.apply(few_cpu, d)
        check(torch.equal(got, want), f"bilinear {type(op).__name__} on "
                                      "the card equals its CPU run")
    log("phase 20: bilinear RandomRotation(0.1), ShearX and ShearY on the "
        "card equal their CPU runs bit for bit")
    x = norm(augmented)
    check(torch.equal(x.cpu(), norm(augmented_cpu)),
          "'tf' normalization on the card equals its CPU run")
    for use_cutmix in (False, True):
        op = cutmix if use_cutmix else mixup
        mix = {"use_cutmix": use_cutmix,
               "draws": op.sample(DEIT["batch"], size, host, "cpu")}
        gx, gy = mixup_or_cutmix(x, labels, mixup=mixup, cutmix=cutmix,
                                 draws=mix)
        wx, wy = mixup_or_cutmix(x.cpu(), labels.cpu(), mixup=mixup,
                                 cutmix=cutmix, draws=mix)
        err = max(float((gx.cpu() - wx).abs().max()),
                  float((gy.cpu() - wy).abs().max()))
        log(f"phase 20: {'CutMix' if use_cutmix else 'MixUp'} on the card "
            f"against the CPU: max |d| {err:.3g} (draws {mix['draws']})")
        check(err <= 1e-6, "mixup_or_cutmix on the card within 1e-6 of the "
                           "CPU")


def check_streamed_accuracy(torch, accs, logits, labels):
    """The accuracies streamed on the card against a recomputation on the
    CPU from the same logits: the label's rank among the scores, ties to
    the lower index, as ``lax.top_k``."""
    import numpy as np

    scores = torch.cat(logits).cpu().double().numpy()
    lab = labels.cpu().numpy()
    lab = np.tile(lab, len(logits))
    own = scores[np.arange(len(lab)), lab][:, None]
    index = np.arange(scores.shape[1])[None, :]
    rank = ((scores > own).sum(1)
            + ((scores == own) & (index < lab[:, None])).sum(1))
    want = {"top1": float((rank < 1).mean()), "top5": float((rank < 5).mean())}
    got = {k: m.result() for k, m in accs.items()}
    log(f"phase 20 distilled: streamed accuracies on the card {got}, CPU "
        f"recomputation from the same {len(lab)} logit rows {want}")
    for k in got:
        check(abs(got[k] - want[k]) <= 1e-6,
              f"streamed {k} accuracy equals the CPU recomputation")
    return got


def deit_path(torch, fa, dev):
    """Phase 20: the DeiT recipe's train step at DeiT-B/16's widths (patch
    16, width 768, 12 layers, 12 heads, MLP 3072, 1000 classes), bf16,
    batch 128 of seeded uint8 224 px images, labels ``arange(128) %
    1000``, seeded weights; whole-batch RandAugment(2, 9) and the 'tf'
    normalization; the port's AdamW(weight_decay=0.05, decay_exclude=
    ["bias", "norm", "cls", "dist"]) under LinearWarmup(CosineDecay(5e-4),
    2). Two modes: ``recipe`` (mixup_or_cutmix, ViT on dense attention
    with bf16 scores, categorical cross-entropy on the soft labels) and
    ``distilled`` (DeiT on the flash kernels, hard distillation from a
    frozen bf16 ViT-B/16, streamed accuracies). Checks the augmentation on
    the card against the CPU, the decayed sets, each first loss against
    float32, the flash step against dense attention, K3a-c's launches and
    the streamed accuracies; times both modes in turns and profiles
    them."""
    from torch.profiler import record_function

    from chambers_tpu_torch import initializers, metrics
    from chambers_tpu_torch.augmentations import (
        CutMix,
        ImageNetNormalization,
        MixUp,
        RandAugment,
        mixup_or_cutmix,
        sample_mixup_or_cutmix,
    )
    from chambers_tpu_torch.losses import (
        CategoricalCrossentropy,
        DistillationLoss,
    )
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        DistilledVisionTransformer,
        VisionTransformer,
    )
    from chambers_tpu_torch.optimizers import AdamW, jax_path
    from chambers_tpu_torch.schedules import CosineDecay, LinearWarmup

    bf16 = torch.bfloat16
    b, size, classes = DEIT["batch"], DEIT["size"], DEIT["classes"]
    gen = torch.Generator(device=dev).manual_seed(20)
    host = torch.Generator().manual_seed(20)
    pool = [torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                          device=dev, generator=gen) for _ in range(2)]
    labels = torch.arange(b, device=dev) % classes
    aug, norm = RandAugment(2, 9), ImageNetNormalization("tf")
    mixup = MixUp(0.8, classes, label_smoothing=0.1)
    cutmix = CutMix(1.0, classes, label_smoothing=0.1)
    check_deit_augmentation(torch, dev, pool[0], labels, aug, norm, mixup,
                            cutmix)

    widths = [DEIT[k] for k in ("patch", "width", "depth", "heads", "mlp")]

    def build(mode, dtype, impl="flash"):
        kw = dict(dropout_rate=0.0, image_size=(size, size),
                  classes=classes, dtype=dtype, device=dev)
        if mode == "recipe":
            return VisionTransformer(*widths, attention_impl="xla",
                                     score_dtype=dtype, **kw)
        return DistilledVisionTransformer(*widths, pooling="cls",
                                          attention_impl=impl, **kw)

    models, opts = {}, {}
    listed = set(deit_decayed_paths())
    for seed, mode in enumerate(DEIT_MODES):
        model = initializers.init_module(
            build(mode, bf16),
            torch.Generator(device=dev).manual_seed(seed)).train()
        opts[mode] = AdamW(
            model.named_parameters(), weight_decay=0.05,
            learning_rate=LinearWarmup(CosineDecay(5e-4, decay_steps=100),
                                       warmup_steps=2),
            decay_exclude=DEIT_DECAY_EXCLUDE)
        models[mode] = model
        names = {id(p): n for n, p in model.named_parameters()}
        decayed = {jax_path(names[id(p)]) for g in opts[mode].param_groups
                   if g["decay"] for p in g["params"]}
        log(f"phase 20 {mode}: {len(decayed)} of {len(names)} parameters "
            f"decay; the JAX package's list has {len(listed)}")
        check(decayed == listed,
              f"{mode}: the decayed parameters are the JAX package's")
    teacher = deit_teacher(torch, dev)
    cce = CategoricalCrossentropy(from_logits=True)
    distill = DistillationLoss("hard")
    accs = {"top1": metrics.SparseCategoricalAccuracy(device=dev),
            "top5": metrics.SparseTopKCategoricalAccuracy(5, device=dev)}
    cls_logits = []

    def batch_of(mode, i):
        """One batch's inputs and targets: augmentation drawn on the host
        generator; for ``recipe`` mixed, for ``distilled`` with the frozen
        teacher's logits."""
        with record_function("augmentation"):
            draws = aug.sample(b, (size, size), host, dev)
            x = norm(aug.apply(pool[i % len(pool)], draws))
            if mode == "recipe":
                mix = sample_mixup_or_cutmix(
                    b, (size, size), host, mixup=mixup, cutmix=cutmix,
                    switch_prob=0.5, device=dev)
                return mixup_or_cutmix(x, labels, mixup=mixup,
                                       cutmix=cutmix, draws=mix)
        with record_function("teacher"), torch.no_grad():
            return x, (labels, teacher(x))

    def loss_on(mode, model, batch, stream=False):
        x, y = batch
        if mode == "recipe":
            return cce(y, model(x, deterministic=True))
        out = model(x, deterministic=True)
        if stream:
            cls = out[0].detach()
            cls_logits.append(cls)
            for m in accs.values():
                m.update_state(labels, cls)
        return distill(y, out)

    def step(mode, i, stream=False):
        model, opt = models[mode], opts[mode]
        opt.zero_grad(set_to_none=True)
        loss = loss_on(mode, model, batch_of(mode, i), stream)
        loss.backward()
        opt.step()
        return loss.detach()

    # the first step of each mode: its loss against the same step in
    # float32; in distilled, the flash step against dense attention
    first, first32, flash_vs_dense = {}, {}, {}
    for mode in DEIT_MODES:
        model, opt = models[mode], opts[mode]
        batch = batch_of(mode, 0)
        opt.zero_grad(set_to_none=True)
        loss = loss_on(mode, model, batch)
        loss.backward()
        first[mode] = float(loss.detach())
        ref = build(mode, None).train()
        ref.load_state_dict(model.state_dict())
        with torch.no_grad():
            first32[mode] = float(loss_on(mode, ref, batch))
        del ref
        rel = abs(first[mode] - first32[mode]) / abs(first32[mode])
        log(f"phase 20 {mode}: first loss bf16 {first[mode]:.5f}, float32 "
            f"{first32[mode]:.5f} (rel {rel:.3g})")
        check(math.isfinite(first[mode]) and rel <= 0.05,
              f"{mode}: first loss finite and within 5% of float32's")
        if mode == "distilled":
            dense = build(mode, bf16, impl="xla").train()
            dense.load_state_dict(model.state_dict())
            dense_loss = loss_on(mode, dense, batch)
            dense_loss.backward()
            grads = dict(model.named_parameters())
            flat = torch.cat([p.grad.double().flatten()
                              for p in grads.values()])
            flat_dense = torch.cat([p.grad.double().flatten()
                                    for p in dense.parameters()])
            # the key projection's bias has an exact gradient of 0
            # (softmax does not see a shift of all of a row's scores): its
            # rounding noise has no direction to agree on
            worst = min(float(torch.nn.functional.cosine_similarity(
                g.grad.double().flatten(), d.grad.double().flatten(), dim=0))
                for (name, g), d in zip(grads.items(), dense.parameters())
                if not name.endswith("b_key"))
            flash_vs_dense = {
                "loss_rel": abs(first[mode] - float(dense_loss.detach()))
                / abs(float(dense_loss.detach())),
                "grad_cosine": float(torch.nn.functional.cosine_similarity(
                    flat, flat_dense, dim=0)),
                "worst_parameter_cosine": worst}
            del dense, flat, flat_dense
            log(f"phase 20 distilled: first step on flash against dense "
                f"attention (float32 scores): loss rel "
                f"{flash_vs_dense['loss_rel']:.3g}, gradient cosine "
                f"{flash_vs_dense['grad_cosine']:.6f} (worst parameter but "
                f"the key biases {worst:.6f})")
            check(flash_vs_dense["loss_rel"] <= 1e-2,
                  "distilled: flash loss within 1e-2 of dense attention")
            check(flash_vs_dense["grad_cosine"] >= 0.99,
                  "distilled: flash gradients at cosine >= 0.99 to dense")
        opt.step()
    torch.cuda.synchronize()

    # the timed runs, the two modes in turns, the flash counters set to 0
    # just before them and read just after
    for mode in DEIT_MODES:
        for i in range(DEIT_WARMUP):
            step(mode, 1 + i)
    torch.cuda.synchronize()
    zero_flash(fa)
    runs = {mode: [] for mode in DEIT_MODES}
    losses = {mode: [] for mode in DEIT_MODES}
    for r in range(DEIT_REPEATS):
        for mode in DEIT_MODES:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(DEIT_STEPS):
                losses[mode].append(step(mode, 10 + r * DEIT_STEPS + i,
                                         stream=mode == "distilled"))
            end.record()
            end.synchronize()
            runs[mode].append(start.elapsed_time(end) / DEIT_STEPS)
    launches = dict(fa.flash_attention.launches)
    by_kernel = dict(fa.flash_attention.forward_launches)
    dkv_by_kernel = dict(fa.flash_attention.backward_launches)
    timed = DEIT_STEPS * DEIT_REPEATS
    log(f"phase 20: flash launches over {timed} distilled and {timed} recipe "
        f"steps: {launches}, K3a by kernel {by_kernel}, K3b by kernel "
        f"{dkv_by_kernel}")
    check(all(launches[k] == DEIT["depth"] * timed for k in launches),
          "K3a, K3b and K3c launch 12 times a distilled step")
    check(by_kernel["flash_fwd_short_kernel"] == DEIT["depth"] * timed,
          "K3a runs the short kernel 12 times a distilled step")
    check(dkv_by_kernel["flash_bwd_dkv_short_kernel"] == DEIT["depth"] * timed,
          "K3b runs the short kernel 12 times a distilled step")
    streamed = check_streamed_accuracy(torch, accs, cls_logits, labels)

    results = {}
    for mode in DEIT_MODES:
        model, opt = models[mode], opts[mode]
        ms = sorted(runs[mode])[len(runs[mode]) // 2]
        mode_losses = [float(v) for v in losses[mode]]
        check(all(math.isfinite(v) for v in mode_losses),
              f"{mode}: finite losses")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(mode, 50)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        inner = ("augmentation",) + (("teacher",) if mode == "distilled"
                                     else ())
        with labelled(torch):
            prof = profile_train_step(
                torch, model, opt,
                lambda m, mode=mode: loss_on(mode, m, batch_of(mode, 60)),
                2, inner=inner)
        events = prof.pop("events")
        log(prof.pop("table"))
        kinds, counts, _ = device_time_by_kind(torch, events)
        on_host = {e.key: e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU}
        dense_fwd = (on_host[LABELS[2]].device_time_total / 1e3 / 2
                     if LABELS[2] in on_host else 0.0)
        dense_bwd = sum(
            e.device_time_total for e in on_host.values()
            if e.key.startswith("autograd::engine::evaluate_function")
            and e.key.endswith(("BmmBackward0", "SoftmaxBackward0"))) / 1e3 / 2
        flash_ms = {k: kinds[k] / 2 for k in ("flash_fwd", "flash_bwd_dkv",
                                               "flash_bwd_dq")}
        if mode == "recipe":
            core = {"dense forward (scores, softmax, P.V)": dense_fwd,
                    "dense backward (bmm, softmax)": dense_bwd}
        else:  # the labelled range holds K3a and the teacher's dense core
            core = {"K3a": flash_ms["flash_fwd"],
                    "K3b": flash_ms["flash_bwd_dkv"],
                    "K3c": flash_ms["flash_bwd_dq"],
                    "teacher's dense forward": dense_fwd
                    - flash_ms["flash_fwd"]}
        res = {"ms": ms, "runs": runs[mode], "img_s": b / (ms / 1e3),
               "profile": prof, "busy": prof["device_ms"] / ms,
               "peak_gib": peak, "attention_core_ms": core,
               "losses": mode_losses, "first_loss": first[mode],
               "first_loss_f32": first32[mode],
               "flash_launches_per_step": {
                   k: counts[k] / 2 for k in ("flash_fwd", "flash_bwd_dkv",
                                               "flash_bwd_dq")}}
        if mode == "distilled":
            res["flash_vs_dense"] = flash_vs_dense
            res["streamed_accuracy"] = streamed
            res["flash_launches_timed"] = launches
            res["forward_launches_timed"] = by_kernel
            res["backward_launches_timed"] = dkv_by_kernel
            res["timed_steps"] = timed
        results[mode] = res
        log(f"phase 20 {mode} (DeiT-B/16 widths, b{b} bf16): median of "
            f"{DEIT_REPEATS} runs of {DEIT_STEPS} steps (in turns with the "
            f"other mode) {ms:.3f} ms/step, {res['img_s']:.1f} img/s (runs "
            f"{', '.join(f'{r:.3f}' for r in runs[mode])}), peak memory "
            f"{peak:.2f} GiB (both modes' models resident); kernels "
            f"{prof['device_ms']:.3f} ms a step (busy "
            f"{100 * res['busy']:.1f}%), {prof['launches']:.0f} launches; "
            f"by phase " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     prof["by_phase_ms"].items())
            + "; attention core " + ", ".join(
                f"{k} {v:.3f}" for k, v in core.items())
            + f" ms; matrix products {prof['gemm_ms']:.3f} ms; the "
            f"optimizer spans {prof['optimizer_span_ms']:.3f} ms of the "
            f"device timeline; losses {[round(v, 4) for v in mode_losses]} "
            f"on {CARD}")
    del models, opts, teacher, pool
    torch.cuda.synchronize()
    return results


def time_flash_kernels_at_198(torch, fa, dev, launches, steps):
    """K3a-c at phase 20's shape, ``[128 * 12, 198, 64]`` bf16 with no key
    mask, one launch at a time behind a queued backlog, inputs cycled
    beyond the 50 MB L2, beside their plain versions, their bounds and
    ``F.scaled_dot_product_attention`` with the same operands (forward and
    its whole backward, a yardstick the port never calls); each names the
    kernel that ran (K3a's and K3b's short kernels, a head's operands
    resident in shared memory). Returns each kernel's numbers by row name,
    for the rows' ``shape_198``, and K3a and K3b alone at phase 25 (c)'s
    served ``[32 * 12, 197, 64]`` as ``"served"`` and ``"served_dkv"``."""
    F = torch.nn.functional
    b, n, t, h = DEIT["batch"], DEIT["heads"], DEIT_TOKENS, 64
    bn, scale = b * n, h ** -0.5
    gen = torch.Generator(device=dev).manual_seed(21)
    kernel = fa.forward_kernel(torch.bfloat16, h, t, t)
    check(kernel == "flash_fwd_short_kernel",
          f"K3a at [{bn}, {t}, {h}] bf16 takes the short kernel ({kernel})")
    kernels = {"fwd": kernel,
               "dkv": fa.backward_kernel(torch.bfloat16, h, t, t),
               "dq": fa.launch_shape("dq", torch.bfloat16, h, t,
                                     t)["kernel_name"]}
    check(kernels["dkv"] == "flash_bwd_dkv_short_kernel",
          f"K3b at [{bn}, {t}, {h}] bf16 takes the short kernel "
          f"({kernels['dkv']})")

    def rand():
        return torch.randn((bn, t, h), device=dev,
                           generator=gen).to(torch.bfloat16)

    sets = []  # 3 sets of 195 MB together
    for _ in range(3):
        q, k, v, do = rand(), rand(), rand(), rand()
        o, l, m = fa.launch_forward(q, k, v, None, scale, False, n)
        sets.append((q, k, v, do, o, l, m, fa.delta(o, do)))
    # the kernels against their plain versions at this shape, once
    q, k, v, do, o, l, m, di = sets[0]
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, False, None, n)
    grads = (fa.launch_backward_dq(q, k, v, do, l, m, di, None, scale,
                                   False, n),
             *fa.launch_backward_dkv(q, k, v, do, l, m, di, None, scale,
                                     False, n))
    grads_p = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale,
                                      False, None, n)
    errors = {}
    for key, got, ref in (("fwd", o, o_p), ("dq", grads[0], grads_p[0]),
                          ("dkv", grads[1], grads_p[1]),
                          ("dkv", grads[2], grads_p[2])):
        rtol, atol, rms_limit = flash_tolerance(torch, torch.bfloat16, ref,
                                                key != "fwd")
        err, needs, rms = closeness(got, ref, rtol)
        check(needs <= atol and rms <= rms_limit,
              f"K3 {key} at [{bn}, {t}, {h}] within its tolerance")
        errors[key] = max(errors.get(key, 0.0), err)
    turn = iter(range(10 ** 9))

    def nxt():
        return sets[next(turn) % len(sets)]

    def four(x):
        return x.view(b, n, t, h)

    def sdpa():
        q, k, v = nxt()[:3]
        return F.scaled_dot_product_attention(four(q), four(k), four(v))

    q0, k0, v0, do0 = (four(x).clone().requires_grad_(i < 3)
                       for i, x in enumerate(sets[0][:4]))
    out0 = F.scaled_dot_product_attention(q0, k0, v0)

    def sdpa_bwd():
        return torch.autograd.grad(out0, (q0, k0, v0), do0,
                                   retain_graph=True)

    def bwd_args():
        q, k, v, do, _, l, m, di = nxt()
        return (q, k, v, do, l, m, di, None, scale, False, n)

    def plain_bwd():
        q, k, v, do, o, l, m, _ = nxt()
        return fa.flash_backward_plain(q, k, v, o, l, m, do, scale, False,
                                       None, n)

    elem = 2
    qkv = 3 * bn * t * h * elem
    stats = bn * t * 4
    pairs = bn * t * t * h
    lib_fwd_ms = cuda_ms(torch, sdpa, 20, backlog=True)
    lib_bwd_ms = cuda_ms(torch, sdpa_bwd, 20, backlog=True)
    plain_fwd_ms = cuda_ms(torch, lambda: fa.flash_forward_plain(
        *nxt()[:3], scale, False, None, n), 5)
    plain_bwd_ms = cuda_ms(torch, plain_bwd, 5)
    specs = (
        ("flash_fwd", "fwd", lambda: fa.launch_forward(
            *nxt()[:3], None, scale, False, n),
         qkv + bn * t * h * elem + 2 * stats, 4 * pairs, plain_fwd_ms,
         lib_fwd_ms),
        ("flash_bwd_dkv", "dkv", lambda: fa.launch_backward_dkv(*bwd_args()),
         qkv + bn * t * h * elem + 3 * stats + 2 * bn * t * h * elem,
         8 * pairs, plain_bwd_ms, lib_bwd_ms),
        ("flash_bwd_dq", "dq", lambda: fa.launch_backward_dq(*bwd_args()),
         qkv + bn * t * h * elem + 3 * stats + bn * t * h * elem, 6 * pairs,
         plain_bwd_ms, lib_bwd_ms),
    )
    out = {}
    for name, key, bare, nbytes, ops, plain_ms, lib_ms in specs:
        kernel_ms = cuda_ms(torch, bare, 20, backlog=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_OPS_PER_S * 1e3  # float16's peak is the same
        bound_ms = max(bytes_ms, ops_ms)
        out[name] = {
            "shape": [bn, t, h], "dtype": "bf16", "key_mask": None,
            "kernel": kernels[key],
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "achieved_tflops": ops / (kernel_ms / 1e3) / 1e12,
            "max_abs_err": errors[key], "launches": launches[key],
            "launches_per_step": launches[key] / steps,
            "note": ("library_ms is F.scaled_dot_product_attention's "
                     "forward with the same operands" if key == "fwd" else
                     "plain_ms and library_ms are the whole backward, "
                     "dK/dV and dQ together"),
            "card": CARD}
        log(f"{name} [{bn}, {t}, {h}] bf16 no mask: kernel "
            f"{kernel_ms * 1e3:.1f} us ({out[name]['achieved_tflops']:.1f} "
            f"TFLOP/s, {bound_ms / kernel_ms:.0%} of the bound), plain "
            f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({out[name]['bound_by']}; bytes "
            f"{bytes_ms * 1e3:.2f}, operations {ops_ms * 1e3:.2f}); "
            f"{launches[key]} launches in phase 20's {steps} timed distilled "
            f"steps, kernel {kernels[key]}, on {CARD}")
    del sets, q0, k0, v0, do0, out0
    out["served"] = time_served_forward(torch, fa, dev)
    out["served_dkv"] = time_served_backward(torch, fa, dev)
    torch.cuda.synchronize()
    return out


def time_served_forward(torch, fa, dev):
    """K3a at the served flash ViT-B/16's shape (phase 25 (c): a batch of
    32, 12 heads, 197 tokens, bf16, no mask), ``[384, 197, 64]``: held to
    its plain version, and timed as ``time_flash_kernels_at_198`` times it,
    beside its plain version, its bound and SDPA."""
    F = torch.nn.functional
    b, n, t, h = SERVE["batch"], DEIT["heads"], SIZE ** 2 // 256 + 1, 64
    bn, scale = b * n, h ** -0.5
    gen = torch.Generator(device=dev).manual_seed(25)
    kernel = fa.forward_kernel(torch.bfloat16, h, t, t)
    sets = [tuple(torch.randn((bn, t, h), device=dev, generator=gen)
                  .bfloat16() for _ in range(3))
            for _ in range(6)]  # 6 x 29 MB: beyond the L2
    o, l, m = fa.launch_forward(*sets[0], None, scale, False, n)
    o_p, l_p, m_p = fa.flash_forward_plain(*sets[0], scale, False, None, n)
    rtol, atol, rms_limit = flash_tolerance(torch, torch.bfloat16, o_p,
                                            False)
    err, needs, rms = closeness(o, o_p, rtol)
    check(needs <= atol and rms <= rms_limit
          and bool(torch.allclose(l, l_p, rtol=1e-4, atol=1e-6))
          and bool(torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)),
          f"K3a at [{bn}, {t}, {h}] within its tolerance")
    turn = iter(range(10 ** 9))

    def nxt():
        return sets[next(turn) % len(sets)]

    def sdpa():
        return F.scaled_dot_product_attention(
            *(x.view(b, n, t, h) for x in nxt()))

    nbytes = 4 * bn * t * h * 2 + 2 * bn * t * 4  # q, k, v, o; l, m
    ops = 4 * bn * t * t * h
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    kernel_ms = cuda_ms(torch, lambda: fa.launch_forward(
        *nxt(), None, scale, False, n), 20, backlog=True)
    out = {"shape": [bn, t, h], "dtype": "bf16", "key_mask": None,
           "kernel": kernel, "ms": kernel_ms,
           "plain_ms": cuda_ms(torch, lambda: fa.flash_forward_plain(
               *nxt(), scale, False, None, n), 5),
           "library_ms": cuda_ms(torch, sdpa, 20, backlog=True),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "achieved_tflops": ops / (kernel_ms / 1e3) / 1e12,
           "max_abs_err": err,
           "launch_shape": fa.launch_shape("fwd", torch.bfloat16, h, t, t),
           "note": "library_ms is F.scaled_dot_product_attention's forward "
                   "with the same operands",
           "card": CARD}
    log(f"flash_fwd [{bn}, {t}, {h}] bf16 no mask (the served flash "
        f"ViT-B/16's batch): kernel {kernel} {kernel_ms * 1e3:.1f} us "
        f"({out['achieved_tflops']:.1f} TFLOP/s, "
        f"{out['bound_ms'] / kernel_ms:.0%} of the bound), plain "
        f"{out['plain_ms'] * 1e3:.1f} us, library "
        f"{out['library_ms'] * 1e3:.1f} us, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); "
        f"{out['launch_shape']}; on {CARD}")
    return out


def time_served_backward(torch, fa, dev):
    """K3b at the served flash ViT-B/16's shape, ``[384, 197, 64]`` bf16 with
    no mask (a yardstick: serving runs no backward; a ViT trained at batch
    32 gives K3b this shape): held to the plain backward, and timed as
    ``time_flash_kernels_at_198`` times it, beside the plain backward, its
    bound and SDPA's whole backward on the same operands."""
    F = torch.nn.functional
    b, n, t, h = SERVE["batch"], DEIT["heads"], SIZE ** 2 // 256 + 1, 64
    bn, scale = b * n, h ** -0.5
    gen = torch.Generator(device=dev).manual_seed(26)
    kernel = fa.backward_kernel(torch.bfloat16, h, t, t)
    check(kernel == "flash_bwd_dkv_short_kernel",
          f"K3b at [{bn}, {t}, {h}] bf16 takes the short kernel ({kernel})")
    sets = []  # 6 x 39 MB: beyond the L2
    for _ in range(6):
        q, k, v, do = (torch.randn((bn, t, h), device=dev, generator=gen)
                       .bfloat16() for _ in range(4))
        o, l, m = fa.launch_forward(q, k, v, None, scale, False, n)
        sets.append((q, k, v, do, o, l, m, fa.delta(o, do)))
    q, k, v, do, o, l, m, di = sets[0]
    dk, dv = fa.launch_backward_dkv(q, k, v, do, l, m, di, None, scale,
                                    False, n)
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, False, None, n)
    _, dk_p, dv_p = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do,
                                            scale, False, None, n)
    err = 0.0
    for got, ref in ((dk, dk_p), (dv, dv_p)):
        rtol, atol, rms_limit = flash_tolerance(torch, torch.bfloat16, ref,
                                                True)
        e, needs, rms = closeness(got, ref, rtol)
        check(needs <= atol and rms <= rms_limit,
              f"K3b at [{bn}, {t}, {h}] within its tolerance")
        err = max(err, e)
    turn = iter(range(10 ** 9))

    def nxt():
        return sets[next(turn) % len(sets)]

    def four(x):
        return x.view(b, n, t, h)

    graphs = []  # SDPA's forward of each set, for its backward
    for q, k, v, do, *_ in sets:
        leaves = [four(x).detach().requires_grad_() for x in (q, k, v)]
        graphs.append((F.scaled_dot_product_attention(*leaves), leaves,
                       four(do)))
    which = iter(range(10 ** 9))

    def sdpa_bwd():
        out, leaves, grad = graphs[next(which) % len(graphs)]
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    def bare():
        q, k, v, do, _, l, m, di = nxt()
        return fa.launch_backward_dkv(q, k, v, do, l, m, di, None, scale,
                                      False, n)

    def plain():
        q, k, v, do, o, l, m, _ = nxt()
        return fa.flash_backward_plain(q, k, v, o, l, m, do, scale, False,
                                       None, n)

    # q, k, v, do read; dk, dv written; l, m, di read
    nbytes = 6 * bn * t * h * 2 + 3 * bn * t * 4
    ops = 8 * bn * t * t * h
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    kernel_ms = cuda_ms(torch, bare, 20, backlog=True)
    out = {"shape": [bn, t, h], "dtype": "bf16", "key_mask": None,
           "kernel": kernel, "ms": kernel_ms,
           "plain_ms": cuda_ms(torch, plain, 5),
           "library_ms": cuda_ms(torch, sdpa_bwd, 20, backlog=True),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "achieved_tflops": ops / (kernel_ms / 1e3) / 1e12,
           "max_abs_err": err,
           "launch_shape": fa.launch_shape("dkv", torch.bfloat16, h, t, t),
           "note": "plain_ms and library_ms are the whole backward, dK/dV "
                   "and dQ together",
           "card": CARD}
    log(f"flash_bwd_dkv [{bn}, {t}, {h}] bf16 no mask (the served flash "
        f"ViT-B/16's shape): kernel {kernel} {kernel_ms * 1e3:.1f} us "
        f"({out['achieved_tflops']:.1f} TFLOP/s, "
        f"{out['bound_ms'] / kernel_ms:.0%} of the bound), plain "
        f"{out['plain_ms'] * 1e3:.1f} us, SDPA's backward "
        f"{out['library_ms'] * 1e3:.1f} us, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); "
        f"{out['launch_shape']}; on {CARD}")
    del sets, graphs
    return out


# ---------------------------------------------------------------------------
# 21. the CNN backbones: serving ResNeXt-50, SE-ResNeXt-50 and BN-Inception,
# and the SE-ResNet-50 train step of examples/train_cnn_classifier.py
# ---------------------------------------------------------------------------

CNN = dict(batch=64, size=224, classes=1000, check_images=4, cosine_images=8,
           step_check_batch=8)
CNN_WARMUP, CNN_STEPS, CNN_REPEATS = 2, 5, 3
CNN_MODELS = ("resnext50", "seresnext50", "bninception")
CNN_KINDS = ("convolution", "batchnorm", "pooling", "gemm")


def cnn_slots(torch):
    """:class:`labelled`'s slots for the CNNs: ``Conv.forward`` (the
    weight's cast and layout included), ``BatchNorm.forward``, the pools
    with their padding (``F.pad``, ``F.max_pool2d``, ``F.avg_pool2d``) and
    ``QuantDense.forward`` (the head's GEMM); the rest is the other
    elementwise work (ReLU, residual adds, the SE gates, means, softmax,
    the input's normalization)."""
    from chambers_tpu_torch.layers import convolution
    from chambers_tpu_torch.quantization import QuantDense

    F = torch.nn.functional
    return [(convolution.Conv, "forward", CNN_KINDS[0]),
            (convolution.BatchNorm, "forward", CNN_KINDS[1]),
            (F, "pad", CNN_KINDS[2]), (F, "max_pool2d", CNN_KINDS[2]),
            (F, "avg_pool2d", CNN_KINDS[2]),
            (QuantDense, "forward", CNN_KINDS[3])]


def cnn_profile(torch, step, n):
    """Device ms a call of ``step`` over ``n`` profiled calls, by kind
    (:func:`cnn_slots`), kernel launches a call and the table."""
    return profile_kinds(torch, lambda i: step(), n, cnn_slots(torch),
                         "other elementwise")


def profile_kinds(torch, step, n, slots, other):
    """Device ms a call of ``step(i)`` over ``n`` profiled calls, by the
    kinds that ``slots`` label (:class:`labelled`) and the rest as
    ``other`` (a ``forward`` kind holds others and is not taken from the
    rest); kernel launches a call and the table."""
    from torch.profiler import ProfilerActivity, profile

    kinds = list(dict.fromkeys(label for _, _, label in slots))
    with labelled(torch, slots), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = device_kernels(torch, events)
    total = sum(e.self_device_time_total for e in cuda) / 1e3 / n
    host = {e.key: e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    by_kind = {k: host[k].device_time_total / 1e3 / n if k in host else 0.0
               for k in kinds}
    by_kind[other] = total - sum(v for k, v in by_kind.items()
                                 if k != "forward")
    return {"device_ms": total, "by_kind_ms": by_kind,
            "launches": sum(e.count for e in cuda) / n,
            "table": events.table(sort_by="self_device_time_total",
                                  row_limit=10)}


def cnn_flops(torch, model, x):
    """Operations of one forward on ``x``: 2 x the multiply-adds of every
    convolution and dense layer, from their weights' and outputs' shapes
    (counted with forward hooks)."""
    from chambers_tpu_torch.layers.convolution import Conv
    from chambers_tpu_torch.quantization import QuantDense

    total = [0]

    def count(module, args, out):
        k = module.kernel
        per_output = k.shape[:-1].numel()  # kh kw in/groups, or in
        total[0] += 2 * out.numel() * per_output

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, QuantDense))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def cnn_builders(torch):
    """name -> (builder(dtype, device, **kw) -> model in eval mode, the
    model's preprocess_input)."""
    from chambers_tpu_torch.models.backbones import (
        BNInception,
        ResNeXt50,
        SEResNeXt50,
    )
    from chambers_tpu_torch.models.backbones import inception, resnext, senet

    return {
        "resnext50": (lambda dtype, device, **kw: ResNeXt50(
            dtype=dtype, device=device, **kw), resnext.preprocess_input),
        "seresnext50": (lambda dtype, device, **kw: SEResNeXt50(
            dtype=dtype, device=device, **kw), senet.preprocess_input),
        "bninception": (lambda dtype, device, **kw: BNInception(
            pooling="avg", dtype=dtype, device=device),
            inception.preprocess_input),
    }


def check_cnn_serving(torch, dev, name, model, build, pre, images):
    """The float32 model on the card against the same weights on the CPU
    (4 images: softmax within 1e-5, BN-Inception's descriptor within 1e-4
    of its largest magnitude), and bf16 features against float32 ones
    (cosine >= 0.98 on 8 images: ResNeXt-50 without its top, pooled;
    SE-ResNeXt-50's feature map; BN-Inception's descriptor)."""
    x = pre(images[:CNN["check_images"]])
    cpu = build(None, "cpu")
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(x).cpu()
        want = cpu(x.cpu())
    err = float((got - want).abs().max())
    limit = 1e-5 if name != "bninception" else 1e-4 * float(
        want.abs().max())
    log(f"phase 21 {name}: float32 on the card against the CPU, "
        f"{tuple(got.shape)}: max |d| {err:.3g} (limit {limit:.3g})")
    check(bool(torch.isfinite(got).all()) and err <= limit,
          f"{name}: float32 output on the card equals the CPU's")
    del cpu

    state = model.state_dict()
    top_free = {k: v for k, v in state.items()
                if not k.startswith("QuantDense_0.")}
    feats = {}
    for dtype in (None, torch.bfloat16):
        if name == "resnext50":
            m = build(dtype, dev, include_top=False, pooling="avg")
        elif name == "seresnext50":
            m = build(dtype, dev, include_top=False)
        else:
            m = build(dtype, dev)
        m.load_state_dict(top_free)
        with torch.no_grad():
            feats[dtype] = m(pre(images[:CNN["cosine_images"]]))
        del m
    cos = cosine(torch, feats[torch.bfloat16], feats[None])
    log(f"phase 21 {name}: bf16 features {tuple(feats[None].shape)} against "
        f"float32: cosine {cos:.6f}")
    check(cos >= 0.98, f"{name}: bf16 features follow the float32 ones")
    return {"card_vs_cpu_max_abs": err, "bf16_cosine": cos}


def cnn_serving_path(torch, dev):
    """Phase 21 (a): ResNeXt-50 (top, softmax over 1000 classes),
    SE-ResNeXt-50 (top) and BN-Inception (no top, ``with_pooling(...,
    "avg")``, the 1024-d descriptor) serving uint8 ``[64, 224, 224, 3]``
    from a seed in bf16, each behind its own ``preprocess_input``: checks,
    then the models' timed runs in turns (CUDA events), a profile each,
    peak memory."""
    b, size = CNN["batch"], CNN["size"]
    images = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(21))
    builders = cnn_builders(torch)
    checks, models = {}, {}
    for name, (build, pre) in builders.items():
        model = build(None, dev)
        checks[name] = check_cnn_serving(torch, dev, name, model, build, pre,
                                         images)
        models[name] = build(torch.bfloat16, dev)
        models[name].load_state_dict(model.state_dict())
        del model

    def step(name):
        return models[name](builders[name][1](images))

    flops = {}
    with torch.no_grad():
        for name in CNN_MODELS:
            flops[name] = cnn_flops(torch, models[name],
                                    builders[name][1](images[:1]))
            for _ in range(CNN_WARMUP):
                out = step(name)
            check(bool(torch.isfinite(out).all()), f"{name}: finite output")
        torch.cuda.synchronize()
        runs = {name: [] for name in CNN_MODELS}
        for _ in range(CNN_REPEATS):
            for name in CNN_MODELS:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CNN_STEPS):
                    out = step(name)
                end.record()
                end.synchronize()
                runs[name].append(start.elapsed_time(end) / CNN_STEPS)
        results = {}
        for name in CNN_MODELS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = step(name)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            shape = tuple(out.shape)
            check(shape == ((b, 1000) if name != "bninception"
                            else (b, 1024)), f"{name}: output shape")
            prof = cnn_profile(torch, lambda name=name: step(name), 3)
            log(prof.pop("table"))
            ms = sorted(runs[name])[len(runs[name]) // 2]
            # the bound: the operations at the bf16 rate against the bytes
            # (the uint8 images read, bf16 weights read once, the output)
            ops = flops[name] * b
            nbytes = (images.numel() + 2 * sum(
                p.numel() for p in models[name].parameters())
                + 4 * out.numel())
            bound_ms = max(ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
                           ) * 1e3
            res = {"ms": ms, "runs": runs[name], "img_s": b / (ms / 1e3),
                   "profile": prof, "busy": prof["device_ms"] / ms,
                   "peak_gib": peak, "gflop_per_image": flops[name] / 1e9,
                   "bound_ms": bound_ms, "output_shape": shape,
                   **checks[name]}
            results[name] = res
            log(f"phase 21 {name} (b{b} {size} px bf16): median of "
                f"{CNN_REPEATS} runs of {CNN_STEPS} batches (in turns) "
                f"{ms:.3f} ms/batch, {res['img_s']:.1f} img/s (runs "
                f"{', '.join(f'{r:.3f}' for r in runs[name])}); "
                f"{flops[name] / 1e9:.2f} GFLOP an image, bound "
                f"{bound_ms:.3f} ms a batch; kernels {prof['device_ms']:.3f} "
                f"ms a batch (busy {100 * res['busy']:.1f}%), "
                f"{prof['launches']:.0f} launches; by kind " + ", ".join(
                    f"{k} {v:.3f}" for k, v in prof["by_kind_ms"].items())
                + f" ms; peak memory {peak:.2f} GiB on {CARD}")
    del models, images
    torch.cuda.synchronize()
    return results


def cnn_cross_entropy(torch, y_true, y_pred):
    """One-hot cross-entropy over softmax outputs
    (examples/train_cnn_classifier.py:34-36)."""
    return -torch.mean(torch.sum(y_true * torch.log(y_pred + 1e-8), dim=-1))


def cnn_train_step_path(torch, dev):
    """Phase 21 (b): the train step of examples/train_cnn_classifier.py at
    full width: SE-ResNet-50 at 224 px, 1000 classes, batch 64 of seeded
    uint8 images behind 'torch'-mode normalization, one-hot labels
    ``arange(64) % 1000``, bf16, BatchNorm in train mode
    (``deterministic=False``), ``SGDW(weight_decay=1e-4,
    learning_rate=LinearWarmup(0.01, warmup_steps=5), momentum=0.9,
    decay_exclude=["bias", "scale"])``. Checks the decayed set (the conv
    and dense kernels), the first bf16 loss against float32, one float32
    step at batch 8 on the card against the CPU (loss within 1e-5
    relative, every running mean and variance within 1e-4 of its largest
    magnitude) and that the running statistics move; times and profiles
    the step."""
    from chambers_tpu_torch.models.backbones import SEResNet50
    from chambers_tpu_torch.models.backbones.senet import preprocess_input
    from chambers_tpu_torch.optimizers import SGDW
    from chambers_tpu_torch.schedules import LinearWarmup

    b, size, classes = CNN["batch"], CNN["size"], CNN["classes"]
    gen = torch.Generator(device=dev).manual_seed(211)
    x = preprocess_input(torch.randint(0, 256, (b, size, size, 3),
                                       dtype=torch.uint8, device=dev,
                                       generator=gen))
    y = torch.nn.functional.one_hot(torch.arange(b, device=dev) % classes,
                                    classes).float()

    def make(dtype, device):
        return SEResNet50(dtype=dtype, device=device, seed=0).train()

    def sgdw(model):
        return SGDW(model.named_parameters(), weight_decay=1e-4,
                    learning_rate=LinearWarmup(0.01, warmup_steps=5),
                    momentum=0.9, decay_exclude=["bias", "scale"])

    def loss_of(m, xs=x, ys=y):
        return cnn_cross_entropy(torch, ys, m(xs, deterministic=False))

    # one float32 step at batch 8, the card against the CPU
    n = CNN["step_check_batch"]
    f32 = {"card": make(None, dev), "cpu": make(None, "cpu")}
    f32["cpu"].load_state_dict(f32["card"].state_dict())
    step_loss = {}
    for where, m in f32.items():
        opt = sgdw(m)
        device = next(m.parameters()).device
        opt.zero_grad(set_to_none=True)
        loss = loss_of(m, x[:n].to(device), y[:n].to(device))
        loss.backward()
        opt.step()
        step_loss[where] = float(loss.detach())
    step_rel = (abs(step_loss["card"] - step_loss["cpu"])
                / abs(step_loss["cpu"]))
    stats = {k: v for k, v in f32["cpu"].state_dict().items()
             if k.endswith((".mean", ".var"))}
    card_state = f32["card"].state_dict()
    worst = max(float((card_state[k].cpu() - v).abs().max()
                      / v.abs().max().clamp(min=1e-30))
                for k, v in stats.items())
    log(f"phase 21 SE-ResNet-50 float32 step at b{n}, card against CPU: "
        f"loss {step_loss['card']:.6f} vs {step_loss['cpu']:.6f} (rel "
        f"{step_rel:.3g}); {len(stats)} running statistics, worst "
        f"{worst:.3g} of their largest magnitude")
    check(step_rel <= 1e-5,
          "float32 step: loss on the card equals the CPU's")
    check(worst <= 1e-4, "float32 step: running statistics on the card "
                         "equal the CPU's")
    del f32

    model = make(torch.bfloat16, dev)
    opt = sgdw(model)
    names = {id(p): name for name, p in model.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["decay"]
               for p in g["params"]}
    kernels = {name for name in names.values() if name.endswith(".kernel")}
    log(f"phase 21 SE-ResNet-50: {len(decayed)} of {len(names)} parameters "
        f"decay, {len(kernels)} conv and dense kernels")
    check(decayed == kernels and all(
        k.endswith(("Conv_0.kernel", "Conv_1.kernel", "QuantDense_0.kernel"))
        for k in kernels), "the decayed set is the conv and dense kernels")

    ref = make(None, dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss32 = float(loss_of(ref))
    del ref
    before = model._ConvBN_0.BatchNorm_0.mean.clone()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model)
        loss.backward()
        opt.step()
        return loss.detach()

    first = float(step())
    rel = abs(first - loss32) / abs(loss32)
    log(f"phase 21 SE-ResNet-50: first loss bf16 {first:.5f}, float32 "
        f"{loss32:.5f} (rel {rel:.3g})")
    check(math.isfinite(first) and rel <= 0.05,
          "first loss finite and within 5% of float32's")
    for _ in range(CNN_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, losses = [], []
    for _ in range(CNN_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses += [step() for _ in range(CNN_STEPS)]
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / CNN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), "finite losses")
    moved = float((model._ConvBN_0.BatchNorm_0.mean - before).abs().max())
    check(moved > 0, "the running statistics move")
    ms = sorted(runs)[len(runs) // 2]
    ops = 3 * cnn_flops(torch, model.eval(), x[:1]) * b  # forward + 2x back
    model.train()
    prof = profile_train_step(torch, model, opt, loss_of, 2)
    log(prof.pop("table"))
    prof.pop("events")
    res = {"ms": ms, "runs": runs, "img_s": b / (ms / 1e3), "profile": prof,
           "busy": prof["device_ms"] / ms, "peak_gib": peak,
           "first_loss": first, "first_loss_f32": loss32, "losses": losses,
           "stats_moved": moved, "f32_step_card_vs_cpu": {
               "loss_rel": step_rel, "stats_worst_rel": worst},
           "bound_ms": ops / BF16_OPS_PER_S * 1e3}
    log(f"phase 21 SE-ResNet-50 train step (b{b} {size} px bf16, SGDW): "
        f"median of {CNN_REPEATS} runs of {CNN_STEPS} steps {ms:.3f} "
        f"ms/step, {res['img_s']:.1f} img/s (runs "
        f"{', '.join(f'{r:.3f}' for r in runs)}), bound "
        f"{res['bound_ms']:.3f} ms; peak memory {peak:.2f} GiB; kernels "
        f"{prof['device_ms']:.3f} ms a step (busy {100 * res['busy']:.1f}%),"
        f" {prof['launches']:.0f} launches; by phase " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["by_phase_ms"].items())
        + f" ms; matrix products {prof['gemm_ms']:.3f} ms; the optimizer "
        f"spans {prof['optimizer_span_ms']:.3f} ms of the device timeline "
        f"for {prof['optimizer_launches']:.0f} launches; running mean moved "
        f"{moved:.3g}; losses {[round(v, 4) for v in losses]} on {CARD}")
    del model, opt, x
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# 22. mixture-of-experts: the MoE ViT-S/16 of tools/bench_moe.py (dense,
# top-1 and top-2 over 8 experts), and the GShard seq2seq train step on the
# flash kernels
# ---------------------------------------------------------------------------

# tools/bench_moe.py's cell: ViT-S/16 at 224 px, batch 32, bf16, no head
MOE = dict(batch=32, size=224, patch=16, width=384, layers=12, heads=6,
           mlp=1536, experts=8, check_images=4)
MOE_WARMUP, MOE_STEPS, MOE_REPEATS = 2, 10, 3
MOE_VARIANTS = {
    "dense": {},
    "moe_top1_e8": dict(moe_every_n=2, moe_n_experts=8),
    "moe_top2_e8": dict(moe_every_n=2, moe_n_experts=8,
                        moe_n_selected_experts=2)}
MOE_KINDS = ("router and top-k", "dispatch/combine build",
             "dispatch product", "experts", "combine product")
MOE_OUTSIDE = "outside the routed stages"
# the GShard setting on phase 9's model: every second layer of both
# stacks routed, top-2 of 8 experts
GSHARD = dict(moe_every_n=2, moe_n_experts=8, moe_n_selected_experts=2)
GSHARD_DECODE = 16


def moe_slots(torch, forward_of=()):
    """:class:`labelled`'s slots for a routed model: the five stages of
    every ``MoEMLP`` forward (router and top-k, building dispatch and
    combine, the dispatch product, the experts' MLPs, the combine
    product), and the ``forward`` of each class in ``forward_of`` as a
    range of its own, which holds the five."""
    from chambers_tpu_torch.layers.moe import MoEMLP

    stages = ("route", "dispatch_and_combine", "enqueue", "experts",
              "dequeue")
    return ([(MoEMLP, name, kind) for name, kind in zip(stages, MOE_KINDS)]
            + [(cls, "forward", "forward") for cls in forward_of])


def run_in_turns(torch, steps, warmup, repeats, n):
    """``name -> step(i)``: ``warmup`` calls of each, then ``repeats``
    rounds in which each name's ``n`` calls are timed with CUDA events,
    the names in turns. Returns ``name -> [ms a call of each run]``."""
    for step in steps.values():
        for i in range(warmup):
            step(i)
    torch.cuda.synchronize()
    runs = {name: [] for name in steps}
    for r in range(repeats):
        for name, step in steps.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                step(r * n + i)
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end) / n)
    return runs


def median(runs):
    return sorted(runs)[len(runs) // 2]


def moe_vit(torch, dev, dtype, remat=False, **moe):
    """tools/bench_moe.py's model, seed 0, in train mode."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    model = VisionTransformer(
        MOE["patch"], MOE["width"], MOE["layers"], MOE["heads"], MOE["mlp"],
        dropout_rate=0.0, image_size=(MOE["size"], MOE["size"]),
        include_top=False, pooling="cls", dtype=dtype, remat=remat,
        device=dev, **moe)
    return initializers.init_module(
        model, torch.Generator(device=dev).manual_seed(0))


def moe_vit_loss(torch, model, x):
    """tools/bench_moe.py's training objective: mean of the squared
    features plus every routed layer's aux loss."""
    from chambers_tpu_torch.layers.moe import moe_aux_loss

    return model(x).float().pow(2).mean() + moe_aux_loss(model)


def check_moe_mlp_on_card(torch, dev, x):
    """A float32 top-2 ``MoEMLP`` at the ViT-S/16 widths on the card
    against its CPU run on the same weights and the ``[6304, 384]``
    tokens: the routing equal except on tokens whose top-k margin (the
    smallest gap between the sorted probabilities down to the (k+1)-th)
    is under 1e-5, the output within 1e-5 on every token whose kept
    experts are the same on both."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.moe import MoEMLP

    kw = dict(n_selected_experts=2)
    cpu = initializers.init_module(
        MoEMLP(MOE["width"], MOE["mlp"], MOE["experts"], device="cpu", **kw),
        torch.Generator().manual_seed(22))
    card = MoEMLP(MOE["width"], MOE["mlp"], MOE["experts"], device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    xc = x.cpu()
    routed = {}
    with torch.no_grad():
        for name, m, inp in (("cpu", cpu, xc), ("card", card, x)):
            y = m(inp).cpu()
            _, probs, gates, experts = m.route(inp[None])
            dispatch, _, _ = m.dispatch_and_combine(
                gates, experts, m.capacity(inp.shape[0]), torch.float32)
            routed[name] = (y, probs[0].cpu(), experts[0].cpu(),
                            dispatch[0].sum(-1).cpu())
    y_cpu, probs, e_cpu, kept_cpu = routed["cpu"]
    y_card, _, e_card, kept_card = routed["card"]
    k = kw["n_selected_experts"]
    p = probs.sort(dim=-1, descending=True).values[:, :k + 1]
    margin = (p[:, :-1] - p[:, 1:]).min(dim=-1).values
    flipped = (e_cpu != e_card).any(-1)
    near = margin < 1e-5
    same = (kept_cpu == kept_card).all(-1)
    err = float((y_card - y_cpu).abs()[same].max())
    log(f"phase 22 MoEMLP float32 [{x.shape[0]}, {x.shape[1]}] top-{k} of "
        f"{MOE['experts']}, card vs CPU: {int(flipped.sum())} tokens routed "
        f"apart, {int(near.sum())} tokens with a top-k margin under 1e-5, "
        f"{int((~same).sum())} with other kept experts; max |d| over the "
        f"other {int(same.sum())} tokens {err:.3g}")
    check(bool((flipped <= near).all()),
          "card and CPU route apart only on near-ties")
    check(err <= 1e-5, "MoEMLP on the card within 1e-5 of the CPU")
    return {"tokens": x.shape[0], "routed_apart": int(flipped.sum()),
            "near_ties": int(near.sum()), "max_abs_err": err}


def check_moe_int8_on_card(torch, tq, state_dict, x):
    """The float32 int8 top-2 model on the card against the same model on
    the CPU, on ``x``: every int8 product (the experts' ``int_mm`` calls,
    the attention projections and MLPs of the dense layers) and every
    expert bank's int8 output (the quantize pass, the products, the
    rescale and the bias) recomputed on the CPU from the card's own
    operands must give the same bits."""
    from chambers_tpu_torch.layers.moe import MoEMLP

    card, cpu = (
        moe_vit(torch, d, None, **MOE_VARIANTS["moe_top2_e8"]).eval()
        for d in (x.device, "cpu"))
    card.load_state_dict(state_dict)
    cpu.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    tq.quantize_model(card)
    tq.load_quantized_state_dict(
        cpu, {k: v.cpu() for k, v in card.state_dict().items()})
    names = {id(m): name for name, m in card.named_modules()}
    cpu_modules = dict(cpu.named_modules())
    products, banks = [], []
    plain_int_mm, plain_bank = tq.int_mm, MoEMLP.bank

    def int_mm(x_q, w, n):
        acc = plain_int_mm(x_q, w, n)
        products.append((x_q.cpu(), w.cpu(), n, acc.cpu()))
        return acc

    def bank(self, h, name, dtype):
        out = plain_bank(self, h, name, dtype)
        banks.append((names[id(self)], h.cpu(), name, dtype, out.cpu()))
        return out

    tq.int_mm, MoEMLP.bank = int_mm, bank
    try:
        with torch.no_grad():
            got = card(x).cpu()
    finally:
        tq.int_mm, MoEMLP.bank = plain_int_mm, plain_bank
    for x_q, w, n, acc in products:
        check(torch.equal(acc, tq.int_mm(x_q, w, n)),
              f"_int_mm on the card equals the CPU's ({tuple(x_q.shape)} x "
              f"{tuple(w.shape)})")
    with torch.no_grad():
        for name, h, which, dtype, out in banks:
            check(torch.equal(out, cpu_modules[name].bank(h, which, dtype)),
                  f"int8 expert bank {name}.{which} on the card equals the "
                  f"CPU's")
        want = cpu(x.cpu())
    expert_products = sum(MOE["experts"] for _ in banks)
    log(f"phase 22 int8 top-2 ViT-S/16 float32, card vs CPU ({x.shape[0]} "
        f"images): {len(products)} int8 products ({expert_products} of them "
        f"the experts') and {len(banks)} expert banks' outputs bit-equal on "
        f"the card's own operands; end to end rel L2 {rel_l2(got, want):.3g}")
    routed = sum(isinstance(m, MoEMLP) for m in card.modules())
    check(len(banks) == 2 * routed, "every expert bank was held")
    return {"int8_products": len(products), "expert_banks": len(banks),
            "bit_equal": True, "end_to_end_rel_l2": rel_l2(got, want)}


def moe_vit_path(torch, dev):
    """Phase 22 (a): tools/bench_moe.py's cell on the card. The dense,
    top-1 and top-2 ViT-S/16 (bf16, batch 32 at 224 px, every second MLP
    routed over 8 experts): the forward and the train step (mean squared
    features plus the aux loss, ``p -= 1e-3·g``), each timed in turns,
    profiled by kind; a float32 ``MoEMLP`` and the whole float32 top-2
    model against the CPU; ``remat`` against none on the top-2 step; the
    int8 top-2 model's expert products bit-equal to the CPU's and its
    forward timed beside bf16's."""
    from chambers_tpu_torch import quantization as tq
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    b, size = MOE["batch"], MOE["size"]
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((b, size, size, 3), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    eps = 0.01 * torch.randn((MOE_STEPS, b, size, size, 3), device=dev,
                             generator=gen, dtype=torch.bfloat16)
    models = {name: moe_vit(torch, dev, torch.bfloat16, **moe).train()
              for name, moe in MOE_VARIANTS.items()}
    params = {name: list(m.parameters()) for name, m in models.items()}
    n_params = {name: sum(p.numel() for p in ps)
                for name, ps in params.items()}

    def forward(name):
        def step(i):
            with torch.no_grad():
                return models[name](x + eps[i % MOE_STEPS])
        return step

    def train(name):
        def step(i):
            m, ps = models[name], params[name]
            loss = moe_vit_loss(torch, m, x + eps[i % MOE_STEPS])
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                torch._foreach_add_(ps, grads, alpha=-1e-3)
            return loss.detach()
        return step

    # the checks against the CPU, on the seeded weights
    tokens = torch.nn.functional.layer_norm(
        torch.randn((b * (1 + (size // MOE["patch"]) ** 2), MOE["width"]),
                    device=dev, generator=gen), (MOE["width"],))
    mlp_check = check_moe_mlp_on_card(torch, dev, tokens)
    top2 = {k: v.detach().float() for k, v in
            models["moe_top2_e8"].state_dict().items()}
    images = x[:MOE["check_images"]].float()
    f32 = []
    for d in (dev, torch.device("cpu")):
        m = moe_vit(torch, d, None, **MOE_VARIANTS["moe_top2_e8"]).eval()
        m.load_state_dict({k: v.to(d) for k, v in top2.items()})
        with torch.no_grad():
            f32.append(m(images.to(d)).cpu())
    cos = cosine(torch, *f32)
    log(f"phase 22 top-2 ViT-S/16 float32 pooled features, card vs CPU "
        f"({MOE['check_images']} images): cosine {cos:.7f}, rel L2 "
        f"{rel_l2(*f32):.3g}")
    check(cos >= 0.999, "the float32 top-2 model on the card follows the "
                        "CPU's")
    int8_check = check_moe_int8_on_card(torch, tq, top2, images)

    # remat against none: the top-2 step's first loss and gradients, and
    # the memory each holds at its peak
    remat_run = {}
    for remat in (False, True):
        m = moe_vit(torch, dev, torch.bfloat16, remat=remat,
                    **MOE_VARIANTS["moe_top2_e8"]).train()
        m.load_state_dict(models["moe_top2_e8"].state_dict())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = moe_vit_loss(torch, m, x)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        remat_run[remat] = (loss.item(), [g.float() for g in grads],
                            (torch.cuda.max_memory_allocated() - base)
                            / 2 ** 30)
        del m, loss, grads
    (l0, g0, m0), (l1, g1, m1) = remat_run[False], remat_run[True]
    grad_rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                   for a, b in zip(g1, g0))
    loss_rel = abs(l1 - l0) / abs(l0)
    log(f"phase 22 top-2 step, remat against none: loss {l1:.6f} vs "
        f"{l0:.6f} (rel {loss_rel:.3g}), largest relative gradient "
        f"difference {grad_rel:.3g}; peak memory above the resident models "
        f"{m1:.2f} GiB with remat, {m0:.2f} GiB without, on {CARD}")
    check(loss_rel <= 1e-6 and grad_rel <= 1e-6,
          "remat gives the step's loss and gradients")
    check(m1 < m0, "remat holds less memory at its peak")
    del g0, g1, remat_run

    # the timed runs: forward, then the train step, the variants in turns
    results = {name: {"params": n_params[name]} for name in MOE_VARIANTS}
    for mode, make in (("forward", forward), ("train", train)):
        runs = run_in_turns(torch, {n: make(n) for n in MOE_VARIANTS},
                            MOE_WARMUP, MOE_REPEATS, MOE_STEPS)
        for name in MOE_VARIANTS:
            step = make(name)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(0)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            prof = profile_kinds(
                torch, step, 2, moe_slots(torch, (VisionTransformer,)),
                MOE_OUTSIDE)
            if name != "dense" and mode == "forward":
                log(prof["table"])
            ms = median(runs[name])
            results[name][mode] = {
                "ms": ms, "runs": runs[name], "img_s": b / (ms / 1e3),
                "peak_gib": peak, "device_ms": prof["device_ms"],
                "by_kind_ms": prof["by_kind_ms"],
                "launches": prof["launches"],
                "busy": prof["device_ms"] / ms}
        dense_ms = results["dense"][mode]["ms"]
        for name in MOE_VARIANTS:
            r = results[name][mode]
            r["vs_dense"] = r["ms"] / dense_ms
            kinds = r["by_kind_ms"]
            log(f"phase 22 {name} {mode} (ViT-S/16 b{b} {size} px bf16, "
                f"{n_params[name] / 1e6:.1f} M parameters): median of "
                f"{MOE_REPEATS} runs of {MOE_STEPS} steps {r['ms']:.3f} "
                f"ms/step (runs {', '.join(f'{v:.3f}' for v in r['runs'])}),"
                f" {r['img_s']:.1f} img/s, {r['vs_dense']:.3f}x dense; "
                f"{r['launches']:.0f} launches a step, device "
                f"{r['device_ms']:.3f} ms (busy {100 * r['busy']:.1f}%), "
                f"peak {r['peak_gib']:.2f} GiB above the resident models; "
                f"device ms by kind: forward {kinds['forward']:.3f} (" +
                ", ".join(f"{k} {kinds[k]:.3f}" for k in MOE_KINDS) +
                f"), {MOE_OUTSIDE} {kinds[MOE_OUTSIDE]:.3f}, on {CARD}")

    # the int8 top-2 forward beside bf16, in turns
    int8 = moe_vit(torch, dev, torch.bfloat16,
                   **MOE_VARIANTS["moe_top2_e8"]).eval()
    int8.load_state_dict(models["moe_top2_e8"].state_dict())
    tq.quantize_model(int8)
    bf16 = models["moe_top2_e8"].eval()

    def serve(m):
        def step(i):
            with torch.no_grad():
                return m(x + eps[i % MOE_STEPS])
        return step

    runs = run_in_turns(torch, {"bf16": serve(bf16), "int8": serve(int8)},
                        MOE_WARMUP, MOE_REPEATS, MOE_STEPS)
    int8_ms = {k: median(v) for k, v in runs.items()}
    log(f"phase 22 top-2 forward, int8 (quantize_model) against bf16: "
        f"{int8_ms['int8']:.3f} against {int8_ms['bf16']:.3f} ms/step "
        f"(runs int8 {', '.join(f'{v:.3f}' for v in runs['int8'])}; bf16 "
        f"{', '.join(f'{v:.3f}' for v in runs['bf16'])}), on {CARD}")
    results["moe_top2_e8"]["int8_forward"] = {
        "ms": int8_ms["int8"], "runs": runs["int8"],
        "bf16_ms": int8_ms["bf16"], **int8_check}
    results["checks"] = {"moe_mlp_float32": mlp_check,
                         "top2_float32_cosine": cos,
                         "remat": {"loss_rel": loss_rel,
                                   "grad_rel": grad_rel,
                                   "peak_gib": m1, "peak_gib_plain": m0}}
    del models, int8, bf16, x, eps
    return results


def gshard_path(torch, fa, dev):
    """Phase 22 (b): the GShard setting on phase 9's train step: the padded
    Seq2SeqTransformer at full width on the flash kernels with every second
    layer of both stacks routed, top-2 of 8 experts, masked cross-entropy
    plus the aux loss and the port's AdamW(1e-4, weight decay 1e-4). The
    first loss against dense attention on the same weights, K3a-c counted
    over the timed steps (12 launches each a step), a profile by phase and
    by routed stage, and greedy decoding of 16 tokens by full recompute in
    float32 on the card, its tokens equal to the CPU's."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.moe import MoEMLP, moe_aux_loss
    from chambers_tpu_torch.models import Seq2SeqTransformer, greedy_decode
    from chambers_tpu_torch.optimizers import AdamW

    def build(impl, dtype=torch.bfloat16, device=dev):
        model = Seq2SeqTransformer(
            input_vocab_size=S2S["vocab"], output_vocab_size=S2S["vocab"],
            embed_dim=S2S["dim"], num_heads=S2S["heads"],
            dim_feedforward=4 * S2S["dim"],
            num_encoder_layers=S2S["layers"],
            num_decoder_layers=S2S["layers"], dropout_rate=0.0,
            dtype=dtype, attention_impl=impl, device=device, **GSHARD)
        return initializers.init_module(
            model, torch.Generator(device=device).manual_seed(0)).train()

    model = build("flash")
    routed = [n for n, m in model.named_modules() if isinstance(m, MoEMLP)]
    check(len(routed) == 4, "2 routed encoder and 2 routed decoder layers")
    dense = build("xla")
    dense.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    src, tgt = seq2seq_tokens(torch, dev)
    vocab = S2S["vocab"]

    def tokens_of(i):
        return torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt

    def loss_of(m, i=0):
        loss, _ = seq2seq_loss(torch, m, *tokens_of(i))
        return loss + moe_aux_loss(m)

    with torch.no_grad():
        first_f, first_d = float(loss_of(model)), float(loss_of(dense))
    rel = abs(first_f - first_d) / abs(first_d)
    log(f"phase 22 GShard seq2seq first step, flash vs dense attention: "
        f"loss {first_f:.5f} vs {first_d:.5f} (rel {rel:.2e})")
    check(rel <= 1e-2, "the routed flash step's first loss follows dense "
                       "attention's")
    del dense

    opt = AdamW(model.named_parameters(), weight_decay=1e-4,
                learning_rate=1e-4)

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, i)
        loss.backward()
        opt.step()
        return loss.detach()

    for i in range(S2S_WARMUP):
        step(i)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    losses, runs = [], []
    for r in range(S2S_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses += [step(S2S_WARMUP + r * S2S_STEPS + i)
                   for i in range(S2S_STEPS)]
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / S2S_STEPS)
    launches = dict(fa.flash_attention.launches)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    n_steps = S2S_STEPS * S2S_REPEATS
    ms = median(runs)
    losses = [float(v) for v in losses]
    positions = S2S["batch"] * 2 * S2S["t"]
    per_step = 3 * S2S["layers"]
    check(all(launches[k] == per_step * n_steps for k in launches),
          "K3a, K3b and K3c each launched 12 times a routed train step")
    check(all(math.isfinite(v) for v in losses), "finite losses")
    with labelled(torch, moe_slots(torch)):
        prof = profile_train_step(torch, model, opt, loss_of, 2)
    log(prof["table"])
    host = {e.key: e for e in prof["events"]
            if e.device_type == torch.autograd.DeviceType.CPU}
    kinds = {k: host[k].device_time_total / 1e3 / 2 if k in host else 0.0
             for k in MOE_KINDS}
    log(f"phase 22 GShard seq2seq train step ({n_params / 1e6:.1f} M "
        f"parameters, top-2 of {GSHARD['moe_n_experts']} experts every "
        f"second layer, batch {S2S['batch']}, {S2S['t']} + {S2S['t']} tokens"
        f" a row, bf16, flash): median of {S2S_REPEATS} runs of {S2S_STEPS} "
        f"steps {ms:.3f} ms/step (runs {', '.join(f'{v:.3f}' for v in runs)}"
        f"), {positions / (ms / 1e3):.0f} tokens/s with padding; launches "
        f"over {n_steps} steps {launches}; {prof['launches']:.0f} kernel "
        f"launches a step, device {prof['device_ms']:.3f} ms (busy "
        f"{100 * prof['device_ms'] / ms:.1f}%): " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["by_phase_ms"].items())
        + "; the routed stages' forward: " + ", ".join(
            f"{k} {v:.3f}" for k, v in kinds.items())
        + f"; peak {peak:.2f} GiB above the model and optimizer state, on "
        f"{CARD}")
    log(f"phase 22 GShard losses: {[round(v, 4) for v in losses]}")

    # greedy decoding by full recompute, float32, card against CPU
    state = {k: v.float() for k, v in model.state_dict().items()}
    decoded, seconds = [], []
    for d in (dev, torch.device("cpu")):
        m = build("flash", None, d).eval()
        m.load_state_dict({k: v.to(d) for k, v in state.items()})
        t0 = time.perf_counter()
        decoded.append(greedy_decode(m, src.to(d), max_len=GSHARD_DECODE,
                                     bos_id=1).cpu())
        seconds.append(time.perf_counter() - t0)
        del m
    same = torch.equal(*decoded)
    log(f"phase 22 GShard greedy decode of {GSHARD_DECODE} tokens x "
        f"{src.shape[0]} sources by full recompute, float32 (on the card "
        f"the FMA flash kernels, on the CPU their plain versions): card "
        f"{seconds[0]:.2f} s, CPU {seconds[1]:.2f} s; tokens equal: {same};"
        f" first row {decoded[0][0].tolist()}")
    check(same, "the card's greedy tokens equal the CPU's")
    return {"ms_per_step": ms, "runs_ms": runs,
            "tokens_s": positions / (ms / 1e3),
            "device_ms": prof["device_ms"],
            "device_ms_by_phase": prof["by_phase_ms"],
            "routed_forward_ms_by_kind": kinds,
            "launches_per_step": prof["launches"],
            "flash_launches_per_step": {k: v / n_steps
                                        for k, v in launches.items()},
            "busy": prof["device_ms"] / ms, "peak_gib": peak,
            "first_loss": first_f, "first_loss_dense": first_d,
            "greedy_tokens_equal": same}, launches


def moe_path(torch, fa, dev):
    """Phase 22: (a) and (b), with its own wall time."""
    t0 = time.perf_counter()
    vit = moe_vit_path(torch, dev)
    torch.cuda.empty_cache()
    gshard, launches = gshard_path(torch, fa, dev)
    torch.cuda.empty_cache()
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return vit, gshard, launches


# ---------------------------------------------------------------------------
# 23. the training harness on the card: phase 9's seq2seq step through
# Trainer.fit (a), config 4 through the Keras facade (b), LoRA on ViT-B/16
# (c)
# ---------------------------------------------------------------------------

# depths, cut to make room for phase 26 (they were 6 training and 2
# validation batches, 8 timed steps a fit call, 8 host batches, 5 LoRA
# steps)
FIT = dict(batches=5, epochs=2, val=1, window=4)   # (a): 10 steps a run
FIT_TIMED, FIT_REPEATS = 4, 3                       # steps a timed fit call
KERAS_BATCHES = 4                                    # (b): host batches
LORA = dict(batch=32, steps=3, rank=8, classes=1000)


def s2s_batches(torch, n, offset=0):
    """Phase 9's batches as ``((src, tgt_in), labels)`` host elements:
    ``tokens_of(i)``'s varied sources, the next-token labels."""
    src, tgt = seq2seq_tokens(torch, torch.device("cpu"))
    vocab = S2S["vocab"]
    labels = torch.roll(tgt, -1, dims=1)
    return [((torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt),
             labels) for i in range(offset, offset + n)]


def masked_ce(torch):
    """Phase 9's loss as a ``loss(y_true, y_pred)``: masked cross-entropy
    on the next token, padding labels excluded (the same ops as
    ``seq2seq_loss``)."""
    def loss(labels, logits):
        mask = (labels != 0).float().flatten()
        ce = torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), labels.flatten(), reduction="none")
        return (ce * mask).sum() / mask.sum()
    return loss


class TokenAccuracy:
    """A streaming metric (state on the card): next-token accuracy over the
    non-padding labels."""

    name = "token_accuracy"

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def init(self):
        zero = self.torch.zeros((), device=self.dev)
        return {"hits": zero, "count": zero.clone()}

    def update(self, state, labels, logits):
        mask = labels != 0
        hits = ((logits.argmax(-1) == labels) & mask).sum()
        return {"hits": state["hits"] + hits,
                "count": state["count"] + mask.sum()}

    def compute(self, state):
        return state["hits"] / state["count"]


class LossTape:
    """Wraps a loss and keeps every step's value on the card (train steps
    only: evaluation runs under ``no_grad``)."""

    def __init__(self, torch, loss):
        self.torch, self.loss, self.values = torch, loss, []

    def __call__(self, y_true, y_pred):
        value = self.loss(y_true, y_pred)
        if self.torch.is_grad_enabled():
            self.values.append(value.detach())
        return value

    def floats(self):
        return [float(v) for v in self.values]


def same_bits(torch, a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


def optimizer_moments(opt):
    """``{index: tensor}`` of every tensor in the optimizer's state."""
    out = {}
    for i, (_, state) in enumerate(sorted(
            opt.state_dict()["state"].items())):
        for key, value in state.items():
            if hasattr(value, "shape"):
                out[f"{i}.{key}"] = value
    return out


def fit_profile(torch, run, steps):
    """Kernels, device ms and launches a step over one profiled call of
    ``run`` (which takes ``steps`` train steps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = device_kernels(torch, events)
    return {"device_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3 / steps,
            "launches": sum(e.count for e in kernels) / steps,
            "table": events.table(sort_by="self_device_time_total",
                                  row_limit=10)}


def trainer_seq2seq_path(torch, fa, dev, workdir):
    """Phase 23 (a): phase 9's seq2seq train step (nothing cut, flash)
    through ``Trainer.fit``. Checks: with a constant rate, ``spe=1`` and no
    EMA, the first 3 losses against phase 9's hand-written step on the same
    batches and init (``torch.optim.AdamW``); K3a-c launched 12 times each
    a step under ``fit``; the harness's config (the port's AdamW under
    ``LinearWarmup(1e-4, 4)``, EMA 0.999, a streaming token accuracy,
    validation on 2 batches, ``ExperimentCallback``) with
    ``steps_per_execution=4`` bit-equal to ``1``; SIGTERM mid-epoch, the
    checkpoint restored into a fresh Trainer and ``fit(initial_epoch,
    skip_batches)`` bit-equal to the uninterrupted run; the CSV and event
    files. Times ``spe`` 1 and 4 against phase 9's step in turns."""
    import signal
    from functools import partial

    from chambers_tpu_torch.callbacks import Callback, ExperimentCallback
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.schedules import LinearWarmup
    from chambers_tpu_torch.training import Trainer
    from chambers_tpu_torch.training.checkpoint import PreemptionCheckpoint
    from chambers_tpu_torch.utils.tensorboard import read_events

    def build():
        model = build_seq2seq(torch, dev, torch.bfloat16)
        return model.train()

    loss = masked_ce(torch)
    per_step = 3 * S2S["layers"]

    # the hand-written step of phase 9 and the Trainer on the same batches
    data = s2s_batches(torch, 3)
    hand = build()
    opt = torch.optim.AdamW(hand.parameters(), lr=1e-4, weight_decay=1e-4,
                            betas=(0.9, 0.999), eps=1e-8)
    hand_losses = []
    for (src, tgt), labels in data:
        opt.zero_grad(set_to_none=True)
        value = loss(labels.to(dev), hand([src.to(dev), tgt.to(dev)],
                                          deterministic=True))
        value.backward()
        opt.step()
        hand_losses.append(float(value.detach()))
    del hand, opt
    module = build()
    tape = LossTape(torch, loss)
    trainer = Trainer(module, tape, torch.optim.AdamW(
        module.parameters(), lr=1e-4, weight_decay=1e-4, betas=(0.9, 0.999),
        eps=1e-8))
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    trainer.fit(data, epochs=1, verbose=False)
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention.launches)
    fit_losses = tape.floats()
    bit_equal = fit_losses == hand_losses
    gap = max(abs(a - b) / abs(b) for a, b in zip(fit_losses, hand_losses))
    log(f"phase 23 (a): Trainer.fit's first losses {fit_losses} against "
        f"phase 9's hand-written step {hand_losses}: "
        f"{'bit-equal' if bit_equal else f'largest gap {gap:.3g}'}; flash "
        f"launches over 3 steps {launches}")
    check(gap <= 2 ** -7, "Trainer.fit's losses follow the hand-written "
                          "step (bit-equal expected, bf16 rtol 2^-7)")
    check(all(v == per_step * 3 for v in launches.values()),
          "K3a, K3b and K3c launched 12 times each a step under Trainer.fit")
    del module, trainer

    # the harness's config at spe 1 and 4, and the preemption run
    train = s2s_batches(torch, FIT["batches"])
    val = s2s_batches(torch, FIT["val"], offset=100)

    def harness(spe):
        module = build()
        tape = LossTape(torch, loss)
        trainer = Trainer(
            module, tape, partial(AdamW, weight_decay=1e-4,
                                  learning_rate=LinearWarmup(
                                      1e-4, warmup_steps=4)),
            metrics={"token_accuracy": TokenAccuracy(torch, dev)},
            ema_decay=0.999, steps_per_execution=spe)
        return module, trainer, tape

    runs = {}
    for spe in (1, FIT["window"]):
        module, trainer, tape = harness(spe)
        exp = ExperimentCallback(os.path.join(workdir, f"exp_spe{spe}"))
        for key in fa.flash_attention.launches:
            fa.flash_attention.launches[key] = 0
        history = trainer.fit(train, epochs=FIT["epochs"],
                              validation_data=val, callbacks=[exp],
                              verbose=False)
        torch.cuda.synchronize()
        runs[spe] = dict(module=module, trainer=trainer, history=history,
                         losses=tape.floats(), exp=exp,
                         launches=dict(fa.flash_attention.launches))
    one, four = runs[1], runs[FIT["window"]]
    n_steps = FIT["batches"] * FIT["epochs"]
    state_of = (lambda r: (r["trainer"].state.params, r["trainer"].ema_variables,
                           optimizer_moments(r["trainer"].optimizer)))
    equal = [same_bits(torch, a, b)
             for a, b in zip(state_of(one), state_of(four))]
    log(f"phase 23 (a): spe=1 and spe={FIT['window']} over {n_steps} steps: "
        f"losses {'equal' if one['losses'] == four['losses'] else 'differ'} "
        f"({[round(v, 5) for v in four['losses']]}); parameters, EMA, "
        f"moments bit-equal {equal}; epoch logs {four['history']}; flash "
        f"launches {four['launches']}")
    check(one["losses"] == four["losses"] and all(equal)
          and one["history"] == four["history"],
          "steps_per_execution=4 bit-equal to 1")
    # validation runs K3a alone: 12 launches a batch
    val_fwd = per_step * FIT["val"] * FIT["epochs"]
    check(four["launches"] == {"fwd": per_step * n_steps + val_fwd,
                               "dkv": per_step * n_steps,
                               "dq": per_step * n_steps},
          "K3a-c 12 launches each a step under the windowed fit, and K3a "
          "12 a validation batch")

    # the experiment directory: CSV and event files, read back
    exp = four["exp"]
    csv_path = os.path.join(exp.log_dir, "epoch_results.txt")
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    tags = {}
    for sub in ("train", "validation"):
        for name in os.listdir(os.path.join(exp.log_dir, sub)):
            for event in read_events(os.path.join(exp.log_dir, sub, name)):
                for v in event.get("values", []):
                    tags.setdefault(sub, set()).add(v["tag"])
    ckpts = sorted(os.listdir(exp.checkpoint_dir))
    log(f"phase 23 (a): ExperimentCallback wrote {len(rows) - 1} CSV rows "
        f"({rows[0]}), event tags {tags}, checkpoints {ckpts}, export "
        f"{sorted(os.listdir(exp.export_dir))}")
    check(len(rows) == FIT["epochs"] + 1 and "epoch_loss" in tags["train"]
          and "epoch_loss" in tags["validation"] and "init.msgpack" in ckpts,
          "the CSV log and the event files exist and read back")

    # preemption: SIGTERM at the end of the second epoch's first window
    # (step 9), a fresh Trainer restored from the checkpoint, resumed
    class Sigterm(Callback):
        def __init__(self):
            self.epoch = 0

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, batch, logs=None):
            if self.epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    ckpt_dir = os.path.join(workdir, "preempt")
    module, trainer, _ = harness(FIT["window"])
    preempt = PreemptionCheckpoint(ckpt_dir, trainer, max_to_keep=1)
    trainer.fit(train, epochs=FIT["epochs"], validation_data=val,
                callbacks=[Sigterm(), preempt], verbose=False)
    check(preempt.preempted and trainer.step < n_steps,
          "SIGTERM stopped the run at a window boundary")
    stopped = trainer.step
    path = os.path.join(ckpt_dir, f"{stopped}.pt")
    ckpt_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    preempt.manager.save(stopped, trainer.state.as_dict(), force=True)
    save_s = time.perf_counter() - t0
    del module, trainer
    module, trainer, _ = harness(FIT["window"])
    t0 = time.perf_counter()
    restored = PreemptionCheckpoint(ckpt_dir, trainer).restore_into(trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored and trainer.step == stopped, "the checkpoint restored")
    trainer.fit(train, epochs=FIT["epochs"], validation_data=val,
                initial_epoch=stopped // FIT["batches"],
                skip_batches=stopped % FIT["batches"], verbose=False)
    resumed = [same_bits(torch, a, b)
               for a, b in zip(state_of(dict(trainer=trainer)),
                               state_of(four))]
    log(f"phase 23 (a): SIGTERM at step {stopped}, checkpoint "
        f"{ckpt_bytes / 2 ** 20:.1f} MiB, save {save_s:.3f} s, restore "
        f"{restore_s:.3f} s; resumed to step {trainer.step}: parameters, "
        f"EMA, moments bit-equal to the uninterrupted run {resumed}")
    check(trainer.step == n_steps and all(resumed),
          "preemption and resume bit-equal to the uninterrupted run")
    del module, trainer, runs, one, four

    # timing: spe 1 and 4 against phase 9's hand-written step, in turns
    timed = s2s_batches(torch, FIT_TIMED, offset=200)
    dev_timed = [((s.to(dev), t.to(dev)), y.to(dev)) for (s, t), y in timed]
    hand = build()
    opt = torch.optim.AdamW(hand.parameters(), lr=1e-4, weight_decay=1e-4,
                            betas=(0.9, 0.999), eps=1e-8)

    def hand_steps(_):
        for (src, tgt), labels in dev_timed:
            opt.zero_grad(set_to_none=True)
            loss(labels, hand([src, tgt], deterministic=True)).backward()
            opt.step()

    trainers = {spe: harness(spe)[1] for spe in (1, FIT["window"])}
    steps = {"phase 9 step": hand_steps}
    for spe, t in trainers.items():
        steps[f"fit spe={spe}"] = (
            lambda _, t=t: t.fit(timed, epochs=1, verbose=False))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = run_in_turns(torch, steps, 1, FIT_REPEATS, 1)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ms = {k: median(v) / FIT_TIMED for k, v in runs.items()}
    tokens = S2S["batch"] * 2 * S2S["t"]
    profiles = {k: fit_profile(torch, lambda k=k: steps[k](0), FIT_TIMED)
                for k in steps}
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    steps[f"fit spe={FIT['window']}"](0)
    torch.cuda.synchronize()
    timed_launches = dict(fa.flash_attention.launches)
    check(all(v == per_step * FIT_TIMED for v in timed_launches.values()),
          "K3a-c 12 launches each a step in the timed fit")
    out = {"losses_vs_phase9": {"fit": fit_losses, "hand": hand_losses,
                                "bit_equal": bit_equal, "max_rel_gap": gap},
           "spe_bit_equal": True, "resume_bit_equal": True,
           "preempted_at_step": stopped, "checkpoint_mib":
           ckpt_bytes / 2 ** 20, "checkpoint_save_s": save_s,
           "checkpoint_restore_s": restore_s,
           "flash_launches_per_step": {k: v / FIT_TIMED for k, v in
                                       timed_launches.items()},
           "flash_launches": launches, "peak_gib_above_models": peak,
           "ms_per_step": ms, "runs_ms": {k: [r / FIT_TIMED for r in v]
                                          for k, v in runs.items()},
           "tokens_s": {k: tokens / (v / 1e3) for k, v in ms.items()},
           "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
           "launches_per_step": {k: p["launches"]
                                 for k, p in profiles.items()},
           "busy": {k: profiles[k]["device_ms"] / ms[k] for k in ms}}
    log(profiles[f"fit spe={FIT['window']}"]["table"])
    log(f"phase 23 (a) seq2seq (b16, 512 + 512 bf16, flash) median of "
        f"{FIT_REPEATS} runs of {FIT_TIMED} steps, in turns: " + "; ".join(
            f"{k} {ms[k]:.3f} ms/step ({out['tokens_s'][k]:.0f} tokens/s, "
            f"runs {', '.join(f'{r:.3f}' for r in out['runs_ms'][k])}), "
            f"kernels {out['device_ms'][k]:.3f} ms, busy "
            f"{100 * out['busy'][k]:.1f}%, {out['launches_per_step'][k]:.0f}"
            f" launches" for k in ms)
        + f"; peak {peak:.2f} GiB above the resident models on {CARD}")
    return out, timed_launches


def keras_metric_learning_path(torch, dev):
    """Phase 23 (b): ``bench.py``'s config 4 (``tools/bench_trainer_fit.py``'s
    setup, uncut) through the Keras facade: the ViT-S/16 embedder in bf16,
    batches of 256 host-resident uint8 images, P×K labels ``arange(256) %
    64``, the MS loss on ``l2_normalize``d features and the port's AdamW,
    ``Model(vit).compile(...)`` and array-form ``fit`` at
    ``steps_per_execution`` 1 and 4, then ``evaluate`` and ``predict``.
    Checks the first 3 losses against phase 18's hand-written step on the
    same batches; times fit at N = 1 and 4 against the hand-written step
    (device-resident batches) in turns, and the same Trainer fed
    device-resident batches, to read the share of the host -> device copy
    that the prefetcher hides."""
    from functools import partial

    import numpy as np

    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.normalization import l2_normalize
    from chambers_tpu_torch.losses import MultiSimilarityLoss
    from chambers_tpu_torch.models import Model
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.optimizers import AdamW

    b = ML["batch"]

    def build():
        vit = VisionTransformer(
            16, ML["width"], ML["depth"], ML["heads"], ML["mlp"],
            dropout_rate=0.0, image_size=(ML["size"], ML["size"]),
            include_top=False, pooling="cls", feature_dim=ML["features"],
            dtype=torch.bfloat16, score_dtype=torch.bfloat16, device=dev)
        return initializers.init_module(
            vit, torch.Generator(device=dev).manual_seed(0)).train()

    ms_loss = MultiSimilarityLoss()

    def loss(y_true, y_pred):
        return ms_loss(y_true, l2_normalize(y_pred, axis=-1))

    optimizer = partial(AdamW, weight_decay=1e-4, learning_rate=1e-3,
                        decay_exclude=["bias", "norm"])
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (KERAS_BATCHES * b, ML["size"], ML["size"], 3),
                    np.uint8)
    y = np.tile(np.arange(b) % ML["classes"], KERAS_BATCHES)

    # phase 18's hand-written step on the same first 3 batches
    hand = build()
    opt = optimizer(list(hand.named_parameters()))
    hand_losses = []
    for i in range(3):
        xb = torch.from_numpy(x[i * b:(i + 1) * b]).to(dev)
        yb = torch.from_numpy(y[i * b:(i + 1) * b]).to(dev)
        opt.zero_grad(set_to_none=True)
        value = loss(yb, hand(xb, deterministic=True))
        value.backward()
        opt.step()
        hand_losses.append(float(value.detach()))
    tape = LossTape(torch, loss)
    model = Model(build()).compile(optimizer=optimizer, loss=tape,
                                   steps_per_execution=1)
    model.fit(x[:3 * b], y[:3 * b], batch_size=b, shuffle=False,
              verbose=False)
    fit_losses = tape.floats()
    gap = max(abs(a - c) / abs(c) for a, c in zip(fit_losses, hand_losses))
    log(f"phase 23 (b): Model.fit's first losses {fit_losses} against phase "
        f"18's hand-written step {hand_losses}: "
        f"{'bit-equal' if fit_losses == hand_losses else f'gap {gap:.3g}'}")
    check(gap <= 2 ** -7, "Model.fit's losses follow the hand-written step "
                          "(bit-equal expected, bf16 rtol 2^-7)")
    evaluated = model.evaluate(x[:2 * b], y[:2 * b], batch_size=b,
                               verbose=False)
    feats = model.predict(x[:b], batch_size=b)
    check(np.isfinite(evaluated) and feats.shape == (b, ML["features"])
          and np.isfinite(feats).all(), "evaluate and predict")
    del hand, opt

    # timing in turns: the hand-written step on device-resident batches,
    # fit at N = 1 and 4 from the host, and fit at N = 4 fed
    # device-resident batches
    n = KERAS_BATCHES
    dev_x = torch.from_numpy(x[:n * b]).to(dev)
    dev_y = torch.from_numpy(y[:n * b]).to(dev)
    hand = build()
    opt = optimizer(list(hand.named_parameters()))

    def hand_steps(_):
        for i in range(n):
            opt.zero_grad(set_to_none=True)
            loss(dev_y[i * b:(i + 1) * b],
                 hand(dev_x[i * b:(i + 1) * b], deterministic=True)).backward()
            opt.step()

    models = {spe: Model(build()).compile(optimizer=optimizer, loss=loss,
                                          steps_per_execution=spe)
              for spe in (1, 4)}
    resident = [(dev_x[i * b:(i + 1) * b], dev_y[i * b:(i + 1) * b])
                for i in range(n)]
    steps = {"phase 18 step": hand_steps}
    for spe, m in models.items():
        steps[f"fit spe={spe}"] = (lambda _, m=m: m.fit(
            x, y, batch_size=b, shuffle=False, verbose=False))
    steps["fit spe=4, device-resident"] = (
        lambda _: models[4].trainer.fit(resident, epochs=1, verbose=False))
    runs = run_in_turns(torch, steps, 1, FIT_REPEATS, 1)
    ms = {k: median(v) / n for k, v in runs.items()}
    # what a host-fed step does that a device-resident one does not: the
    # host's batch preparation (the array form's gather, pinning), timed
    # on the host clock, and the copy to the card, timed with CUDA events
    from chambers_tpu_torch.models.model import _ArrayBatcher
    from chambers_tpu_torch.data.loader import _host_tensor

    t0 = time.perf_counter()
    pinned = [_host_tensor(xb).pin_memory() for xb, _ in _ArrayBatcher(
        [x, y], b)]
    prep_ms = (time.perf_counter() - t0) * 1e3 / n
    copy_ms = cuda_ms(torch, lambda: pinned[0].to(dev, non_blocking=True),
                      10)
    visible = ms["fit spe=4"] - ms["fit spe=4, device-resident"]
    hidden = 1.0 - visible / (prep_ms + copy_ms)
    del pinned
    profiles = {k: fit_profile(torch, lambda k=k: steps[k](0), n)
                for k in ("phase 18 step", "fit spe=4")}
    out = {"first_losses": {"fit": fit_losses, "hand": hand_losses,
                            "bit_equal": fit_losses == hand_losses},
           "ms_per_step": ms, "runs_ms": {k: [r / n for r in v]
                                          for k, v in runs.items()},
           "img_s": {k: b / (v / 1e3) for k, v in ms.items()},
           "h2d_copy_ms_per_batch": copy_ms,
           "host_batch_prep_ms": prep_ms,
           "host_fed_over_resident_ms": visible,
           "prep_and_copy_share_hidden": hidden,
           "harness_ms_over_phase18": {
               k: ms[k] - ms["phase 18 step"] for k in ms},
           "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
           "launches_per_step": {k: p["launches"]
                                 for k, p in profiles.items()},
           "evaluate_loss": float(evaluated)}
    log(f"phase 23 (b) config 4 (ViT-S/16 b{b} bf16, uint8 host batches) "
        f"median of {FIT_REPEATS} runs of {n} steps, in turns: " + "; ".join(
            f"{k} {v:.3f} ms/step ({out['img_s'][k]:.1f} img/s)"
            for k, v in ms.items())
        + f"; a batch's host preparation (gather, pinning) {prep_ms:.3f} "
        f"ms and copy to the card {copy_ms:.3f} ms, against {visible:.3f} ms "
        f"a step more than device-resident batches: {100 * hidden:.1f}% of "
        f"them hidden; kernels a step {out['device_ms']} ms, "
        f"launches {out['launches_per_step']} on {CARD}")
    return out


def lora_vitb16_path(torch, dev):
    """Phase 23 (c): ``examples/finetune_lora.py``'s recipe at ViT-B/16's
    widths: rank-8 adapters on every Dense/MHA projection,
    ``trainable=[lora.TRAINABLE, "predictions"]``, bf16, batch 32 at 224
    px, 5 steps. Checks the frozen backbone bit-equal to its start, the
    adapters and head moved, ``merge_lora``'s forward against the adapted
    one (cosine >= 0.9999), and the optimizer state holding the adapters
    and the head only; times it against a full fine-tune in turns."""
    from functools import partial

    import numpy as np

    from chambers_tpu_torch.losses import SparseCategoricalCrossentropy
    from chambers_tpu_torch.models import Model
    from chambers_tpu_torch.models.backbones.vision_transformer import ViTB16
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.training import Trainer, lora

    def build():
        return ViTB16(dtype=torch.bfloat16, dropout_rate=0.0, seed=0,
                      device=dev)

    rng = np.random.RandomState(23)
    b = LORA["batch"]
    data = [(rng.rand(b, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(0, LORA["classes"], b))
            for _ in range(LORA["steps"])]
    loss = SparseCategoricalCrossentropy(from_logits=True)
    optimizer = partial(AdamW, weight_decay=1e-4, learning_rate=1e-3)

    vit = build()
    start = {k: v.clone() for k, v in vit.state_dict().items()}
    lora.apply_to_model(vit, LORA["rank"],
                        torch.Generator(device=dev).manual_seed(1))
    trainer = Trainer(Model(vit), loss, optimizer,
                      trainable=[lora.TRAINABLE, "predictions"])
    n_adapters = sum(p.numel() for n, p in vit.named_parameters()
                     if "_lora_" in n)
    trainer.fit(data, epochs=1, verbose=False)
    after = vit.state_dict()
    frozen_equal = all(torch.equal(after[k], v) for k, v in start.items()
                       if not k.startswith("predictions"))
    head_moved = not torch.equal(after["predictions.kernel"],
                                 start["predictions.kernel"])
    b_moved = sum(int(after[k].abs().sum() > 0) for k in after
                  if k.endswith("_lora_b"))
    n_b = sum(1 for k in after if k.endswith("_lora_b"))
    state_bytes = sum(t.numel() * t.element_size()
                      for s in trainer.optimizer.state.values()
                      for t in s.values() if hasattr(t, "numel"))
    trained = sum(p.numel() for p in vit.parameters() if p.requires_grad)
    x = torch.from_numpy(data[0][0]).to(dev)
    vit.eval()
    base = build()
    base.load_state_dict(lora.merge_lora(vit.state_dict()))
    with torch.no_grad():
        adapted = vit(x).float().flatten()
        merged = base(x).float().flatten()
    cos = float(torch.nn.functional.cosine_similarity(adapted, merged, dim=0))
    log(f"phase 23 (c) LoRA rank {LORA['rank']} on ViT-B/16: {n_b} adapter "
        f"pairs ({n_adapters} values); backbone bit-equal to its start "
        f"{frozen_equal}; head moved {head_moved}; {b_moved} of {n_b} B "
        f"factors moved; optimizer state {state_bytes / 2 ** 20:.2f} MiB for "
        f"{trained} trained values (AdamW's two moments: "
        f"{8 * trained / 2 ** 20:.2f} MiB); merged forward against the "
        f"adapted one: cosine {cos:.7f}, max |d| "
        f"{float((adapted - merged).abs().max()):.3g}")
    check(frozen_equal and head_moved and b_moved == n_b,
          "the backbone stays bit-equal; the adapters and the head move")
    check(state_bytes == 8 * trained,
          "the optimizer state holds the adapters and the head only")
    check(cos >= 0.9999, "merge_lora's forward equals the adapted forward")
    del base

    # LoRA against a full fine-tune of the same model, in turns
    full = build()
    full_trainer = Trainer(Model(full), loss, optimizer)
    vit.train()
    steps = {"lora": lambda _: trainer.fit(data, epochs=1, verbose=False),
             "full fine-tune": lambda _: full_trainer.fit(
                 data, epochs=1, verbose=False)}
    peaks = {}
    for name, step in steps.items():
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        step(0)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base_bytes) \
            / 2 ** 30
    runs = run_in_turns(torch, steps, 0, FIT_REPEATS, 1)
    ms = {k: median(v) / LORA["steps"] for k, v in runs.items()}
    profiles = {k: fit_profile(torch, lambda k=k: steps[k](0),
                               LORA["steps"]) for k in steps}
    full_bytes = sum(t.numel() * t.element_size()
                     for s in full_trainer.optimizer.state.values()
                     for t in s.values() if hasattr(t, "numel"))
    out = {"ms_per_step": ms, "runs_ms": {k: [r / LORA["steps"] for r in v]
                                          for k, v in runs.items()},
           "img_s": {k: b / (v / 1e3) for k, v in ms.items()},
           "peak_gib_above_resident": peaks,
           "optimizer_state_mib": {"lora": state_bytes / 2 ** 20,
                                   "full fine-tune": full_bytes / 2 ** 20},
           "adapter_values": n_adapters, "merge_cosine": cos,
           "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
           "launches_per_step": {k: p["launches"]
                                 for k, p in profiles.items()},
           "busy": {k: profiles[k]["device_ms"] / ms[k] for k in ms}}
    log(f"phase 23 (c) ViT-B/16 b{b} bf16, median of {FIT_REPEATS} runs of "
        f"{LORA['steps']} steps in turns: " + "; ".join(
            f"{k} {v:.3f} ms/step, kernels {out['device_ms'][k]:.3f} ms "
            f"(busy {100 * out['busy'][k]:.1f}%, "
            f"{out['launches_per_step'][k]:.0f} launches), peak "
            f"{peaks[k]:.2f} GiB above the resident state, optimizer state "
            f"{out['optimizer_state_mib'][k]:.1f} MiB"
            for k, v in ms.items()) + f" on {CARD}")
    return out


def harness_path(torch, fa, dev):
    """Phase 23: (a), (b) and (c) in a scratch directory of the checkout,
    removed afterwards."""
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase23")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    seconds, clock = {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds[part] = round(now - clock[0], 1)
        clock[0] = now

    try:
        seq2seq, launches = trainer_seq2seq_path(torch, fa, dev, workdir)
        lap("a")
        keras = keras_metric_learning_path(torch, dev)
        lap("b")
        lora_run = lora_vitb16_path(torch, dev)
        lap("c")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"seq2seq_fit": seq2seq, "keras_config4": keras,
            "lora_vitb16": lora_run, "seconds": seconds}, launches


# ---------------------------------------------------------------------------
# 24. the host data pipeline: config 4's step through Trainer.fit fed from a
# TFRecord file, as examples/train_metric_learning.py feeds it from files
# ---------------------------------------------------------------------------

# 64 classes x 16 seeded 224 px images (154 MB of records), batches of 256
# (an epoch of the file is 4 batches); a fit call runs a warm-up epoch of
# 4 steps and two timed ones
DATA = dict(images=1024, classes=64, batch=256, epoch_steps=4,
            timed_epochs=2, repeats=3, pipeline_batches=8)


def epoch_clock(torch):
    """A callback that synchronizes the card at every epoch's end and
    keeps the host clock there in ``ends``: epoch ``e``'s steps took
    ``ends[e] - ends[e - 1]``."""
    from chambers_tpu_torch.callbacks import Callback

    class EpochClock(Callback):
        def __init__(self):
            self.ends = []

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())

    return EpochClock()


def config4_trainer(torch, dev, loss_wrapper=None):
    """``examples/train_metric_learning.py``'s Trainer at config 4's widths:
    the ViT-S/16 embedder (bf16, bf16 scores, seeded init), ``apply_fn`` =
    per-image RandAugment(2, 9) on the card (K1, one launch a round) ->
    ``ImageNetNormalization("tf")`` -> the ViT -> ``l2_normalize``, the MS
    loss, the port's AdamW(1e-4, decay_exclude=["bias", "norm",
    "embeddings"]) under ``LinearWarmup(3e-4, 50)``."""
    from functools import partial

    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        RandAugment,
    )
    from chambers_tpu_torch.augmentations.image_augmentations import (
        ImageNetNormalization,
    )
    from chambers_tpu_torch.layers.normalization import l2_normalize
    from chambers_tpu_torch.losses import MultiSimilarityLoss
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.schedules import LinearWarmup
    from chambers_tpu_torch.training import Trainer

    vit = initializers.init_module(VisionTransformer(
        16, ML["width"], ML["depth"], ML["heads"], ML["mlp"],
        dropout_rate=0.0, image_size=(ML["size"], ML["size"]),
        include_top=False, pooling="cls", feature_dim=ML["features"],
        dtype=torch.bfloat16, score_dtype=torch.bfloat16, device=dev),
        torch.Generator(device=dev).manual_seed(0))
    augment = RandAugment(2, 9, elementwise=True)
    normalize = ImageNetNormalization("tf")

    def apply_fn(module, x, deterministic, generator):
        if not deterministic:
            x = augment.apply(x, augment.sample(
                x.shape[0], tuple(x.shape[1:3]), generator, x.device))
        return l2_normalize(module(normalize(x), deterministic=deterministic,
                                   generator=generator), axis=-1)

    loss = MultiSimilarityLoss()
    return Trainer(vit, loss if loss_wrapper is None else loss_wrapper(loss),
                   partial(AdamW, weight_decay=1e-4,
                           decay_exclude=["bias", "norm", "embeddings"],
                           learning_rate=LinearWarmup(3e-4, 50)),
                   apply_fn=apply_fn, seed=0)


def data_pipeline_path(torch, wk, dev):
    """Phase 24: 1024 seeded uint8 224 px images of 64 classes through
    ``dataset_to_tfrecord`` into a file, back through
    ``tfrecord_to_dataset`` -> ``shuffle(1024, seed=42)`` -> ``repeat`` ->
    ``batch(256)`` -> ``prefetch``, into config 4's ``Trainer.fit``.
    Checks: the round trip bit for bit; a second iteration with the seed
    the same bytes; each epoch's four batches every image once; the first
    loss of ``fit`` from the file bit-equal to the same step fed the same
    batch from memory with the same generator state; K1 two launches a
    step under ``fit``. Measures the pipeline alone through
    ``device_prefetch``, ``fit`` from the file against the same batches
    from memory in turns, the busy share and launches a step, and the
    share of the pipeline's host work and copy hidden behind the step."""
    import shutil

    import numpy as np

    from chambers_tpu_torch.data import (
        Dataset,
        dataset_to_tfrecord,
        device_prefetch,
        native,
        native_crc,
        tfrecord_to_dataset,
    )

    n, b = DATA["images"], DATA["batch"]
    spe, timed = DATA["epoch_steps"], DATA["timed_epochs"]
    steps = spe * timed  # timed steps a fit call
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase24")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        rng = np.random.RandomState(0)
        images = rng.randint(0, 256, (n, ML["size"], ML["size"], 3), np.uint8)
        labels = np.repeat(np.arange(DATA["classes"]),
                           n // DATA["classes"]).astype(np.int64)
        path = os.path.join(workdir, "config4.tfrecord")
        check(native_crc.available(), "the native CRC32C builds with g++")
        t0 = time.perf_counter()
        count = dataset_to_tfrecord(
            Dataset.from_tensor_slices((images, labels)), path)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = list(tfrecord_to_dataset(path))
        read_s = time.perf_counter() - t0
        check(count == len(back) == n and all(
            x.dtype == np.uint8 and np.array_equal(x, images[i])
            and int(y) == labels[i] for i, (x, y) in enumerate(back)),
            "the TFRecord round trip gives the arrays back bit for bit")
        del back
        log(f"phase 24: {n} images through dataset_to_tfrecord, "
            f"{size / 1e6:.1f} MB written in {write_s:.2f} s and read back "
            f"bit for bit in {read_s:.2f} s ({n / read_s:.0f} records/s); "
            f"native CRC32C built, native JPEG decoder "
            f"{'built' if native.available() else 'not buildable here'}; "
            f"os.cpu_count() {os.cpu_count()}")

        def pipeline():
            return (tfrecord_to_dataset(path).shuffle(n, seed=42).repeat()
                    .batch(b, drop_remainder=True).prefetch())

        # the seed's stream: the same bytes twice; an epoch (4 batches)
        # holds every image once. The first batches are also the memory
        # runs' data below.
        per_epoch = n // b
        first, second = (
            [batch for _, batch in zip(range(per_epoch + 1), pipeline())]
            for _ in range(2))
        check(all(np.array_equal(x1, x2) and np.array_equal(y1, y2)
                  for (x1, y1), (x2, y2) in zip(first, second)),
              "a second iteration with the same seed gives the same bytes")
        del second
        epoch = first[:per_epoch]
        fingerprints = [np.sort(np.ascontiguousarray(
            x.reshape(len(x), -1)[:, :16]).view(np.uint64).ravel()) for x in (
                np.concatenate([x for x, _ in epoch]), images)]
        counts = np.bincount(np.concatenate([y for _, y in epoch]),
                             minlength=DATA["classes"])
        check(np.array_equal(*fingerprints)
              and counts.tolist() == [n // DATA["classes"]] * DATA["classes"],
              "an epoch's batches hold every image once")

        # the pipeline alone through device_prefetch: the first batch
        # (the shuffle buffer's fill, 1024 records), then steady batches
        m = DATA["pipeline_batches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = device_prefetch(pipeline(), size=2)
        next(it)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(m):
            placed = next(it)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3 / m
        check(placed[0].is_cuda and tuple(placed[0].shape) == (
            b, ML["size"], ML["size"], 3), "device_prefetch places [256, "
                                           "224, 224, 3] uint8 on the card")
        del it, placed
        pinned = torch.from_numpy(first[0][0]).pin_memory()
        copy_ms = cuda_ms(torch, lambda: pinned.to(dev, non_blocking=True),
                          10)
        del pinned
        log(f"phase 24 pipeline alone (TFRecord -> shuffle -> batch "
            f"{b} -> prefetch -> device_prefetch): first batch "
            f"{first_s:.3f} s, then {pipe_ms:.3f} ms a batch "
            f"({b / (pipe_ms / 1e3):.0f} img/s) over {m} batches; the "
            f"batch's copy alone {copy_ms:.3f} ms; threads: one prefetch "
            f"producer, no decode (the records are raw uint8), "
            f"os.cpu_count() {os.cpu_count()}, on {CARD}")

        # the first loss from the file against the same batch from memory
        tapes = []

        def taped(loss):
            tape = LossTape(torch, loss)
            tapes.append(tape)
            return tape

        from_file = config4_trainer(torch, dev, taped)
        from_memory = config4_trainer(torch, dev, taped)
        from_file.fit(pipeline(), epochs=1, steps_per_epoch=1,
                      verbose=False)
        from_memory.fit(first[:1], epochs=1, verbose=False)
        losses = [t.floats()[0] for t in tapes]
        log(f"phase 24: the first loss of fit from the file {losses[0]!r}, "
            f"from memory {losses[1]!r}")
        check(losses[0] == losses[1] and math.isfinite(losses[0]),
              "fit's first loss from the file is bit-equal to the same "
              "step fed the same batch from memory")

        # fit from the file against the same batches from memory (an epoch
        # of the file), in turns: each call an untimed epoch (the shuffle
        # buffer's fill, the prefetch queue's) and `timed` timed ones
        memory = first[:per_epoch]
        runs = {"files": [], "memory": []}
        fit_launches = []
        for _ in range(DATA["repeats"]):
            for mode, trainer, data in (("files", from_file, None),
                                        ("memory", from_memory, memory)):
                clock = epoch_clock(torch)
                torch.cuda.synchronize()
                wk.fused_round.launches = 0
                trainer.fit(pipeline() if data is None else data,
                            epochs=1 + timed, steps_per_epoch=spe,
                            callbacks=[clock], verbose=False)
                if mode == "files":
                    fit_launches.append(wk.fused_round.launches)
                runs[mode].append((clock.ends[timed] - clock.ends[0]) * 1e3
                                  / steps)
        log(f"phase 24 K1 launches in each files fit call of "
            f"{steps + spe} steps: {fit_launches}")
        check(fit_launches == [2 * (steps + spe)] * DATA["repeats"],
              "K1 launched twice a step under fit from the file")
        ms = {k: median(v) for k, v in runs.items()}
        profile = fit_profile(torch, lambda: from_file.fit(
            pipeline(), epochs=1, steps_per_epoch=spe, verbose=False), spe)
        visible = ms["files"] - ms["memory"]
        hidden = 1.0 - visible / pipe_ms
        out = {"records": n, "file_mb": size / 1e6, "write_s": write_s,
               "read_s": read_s, "first_batch_s": first_s,
               "pipeline_ms_per_batch": pipe_ms,
               "pipeline_img_s": b / (pipe_ms / 1e3),
               "copy_ms_per_batch": copy_ms, "cpu_count": os.cpu_count(),
               "producer_threads": 1, "decode_threads": 0,
               "first_loss": {"files": losses[0], "memory": losses[1],
                              "bit_equal": losses[0] == losses[1]},
               "ms_per_step": ms, "runs_ms": runs,
               "img_s": {k: b / (v / 1e3) for k, v in ms.items()},
               "files_over_memory_ms": visible,
               "pipeline_share_hidden": hidden,
               "device_ms_per_step": profile["device_ms"],
               "busy": profile["device_ms"] / ms["files"],
               "launches_per_step": profile["launches"],
               "k1_launches_per_fit": fit_launches}
        log(profile["table"])
        log(f"phase 24 config 4 through Trainer.fit (ViT-S/16 b{b} bf16, "
            f"RandAugment(2, 9) on the card), median of "
            f"{DATA['repeats']} runs of {steps} steps in turns: from the "
            f"TFRecord file {ms['files']:.3f} ms/step "
            f"({out['img_s']['files']:.1f} img/s; runs {runs['files']}), "
            f"the same batches from memory {ms['memory']:.3f} ms/step "
            f"({out['img_s']['memory']:.1f} img/s; runs {runs['memory']}); "
            f"{visible:.3f} ms a step more from the file against the "
            f"pipeline's {pipe_ms:.3f} ms a batch: {100 * hidden:.1f}% "
            f"hidden; kernels {profile['device_ms']:.3f} ms a step (busy "
            f"{100 * out['busy']:.1f}%), {profile['launches']:.0f} launches "
            f"a step, on {CARD}")
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# 25. serving and scale-out: ViT-B/16 exported and served (torch.export, the
# batched HTTP server), a flash ViT exported through the K3a operator, and
# the parallel paths at world size 1 over NCCL
# ---------------------------------------------------------------------------

SERVE = dict(batch=32, requests=256, json_requests=8, clients=64,
             max_delay_ms=5, reload_batches=(1, 4, 32))
PP = dict(layers=4, batch=16, t=128, microbatches=4)
BF16_LOGIT_BOUND = 0.02         # of the logit range: the port's bf16 bound


def logit_gap(torch, got, want):
    """``(max |d|, share bit-equal, bound)`` of bf16 logits against a
    reference: the bound is 2% of the reference's range."""
    got, want = got.float().cpu(), want.float().cpu()
    return (float((got - want).abs().max()),
            float((got == want).float().mean()),
            BF16_LOGIT_BOUND * float(want.max() - want.min()))


def flash_counts(fa):
    return dict(fa.flash_attention.launches)


def kernel_counts(fa):
    """K3a-c's launches by the kernel that ran, one dict a kernel family."""
    return {"fwd": dict(fa.flash_attention.forward_launches),
            "dkv": dict(fa.flash_attention.backward_launches),
            "dq": dict(fa.flash_attention.dq_launches)}


def zero_flash(fa):
    for counts in (fa.flash_attention.launches,
                   fa.flash_attention.forward_launches,
                   fa.flash_attention.backward_launches,
                   fa.flash_attention.dq_launches):
        for key in counts:
            counts[key] = 0


def http_requests(port, images, binary, clients):
    """One single-image request for each of ``images``, ``.npy`` bodies
    when ``binary`` else JSON, from ``clients`` threads: the rows, each
    request's latency on the client (s) and the wall seconds."""
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def post(i):
        x = images[i:i + 1]
        if binary:
            buf = io.BytesIO()
            np.save(buf, x)
            body, kind = buf.getvalue(), "application/octet-stream"
        else:
            body = json.dumps({"instances": x.tolist()}).encode()
            kind = "application/json"
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/vit:predict", data=body,
            headers={"Content-Type": kind}, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(request, timeout=120) as response:
            check(response.status == 200, "the server answered 200")
            payload = response.read()
        seconds = time.perf_counter() - t0
        if binary:
            return np.load(io.BytesIO(payload))[0], seconds
        return (np.asarray(json.loads(payload)["predictions"][0],
                           np.float32), seconds)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        out = list(pool.map(post, range(len(images))))
    wall = time.perf_counter() - t0
    return np.stack([r for r, _ in out]), [s for _, s in out], wall


def nearest_rank(values, q):
    values = sorted(values)
    return values[min(max(math.ceil(q * len(values)) - 1, 0),
                      len(values) - 1)]


def call_profile(torch, fn, calls):
    """Kernels, device ms and launches a call over ``calls`` profiled
    calls of ``fn``."""
    return fit_profile(torch, lambda: [fn() for _ in range(calls)], calls)


def flash_kernels_of(torch, fa, fn, calls=3):
    """``calls`` calls of ``fn`` in one profile: the launch counts of each
    (the counters, zeroed just before the call) and the names of the flash
    kernels the profiler saw. The profiler names the kernels only: it can
    drop a kernel's record, so its counts are not held (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda.synchronize()
            zero_flash(fa)
            fn()
            torch.cuda.synchronize()
            counts.append(flash_counts(fa))
    names = set()
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(FLASH_KERNEL, event.name)
            if m:
                names.add(m.group(1))
    return counts, sorted(names)


def serving_path(torch, fa, dev, workdir, vit_ms):
    """Phase 25 (a)-(c): bench.py's config-1 ViT-B/16 exported with a
    dynamic batch and reloaded in a fresh interpreter that imports only
    torch and numpy; served by ``HTTPModelServer``; the same weights on the
    flash kernels exported through the K3a operator and served by
    ``BatchedServer``."""
    import numpy as np

    from chambers_tpu_torch.models.backbones.vision_transformer import (
        ViTB16,
        fold_imagenet_normalization,
    )
    from chambers_tpu_torch.serving import (
        BatchedServer,
        HTTPModelServer,
        export_serving_artifact,
        load_serving_artifact,
    )

    b = SERVE["batch"]
    model = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16, seed=0,
                   device=dev)
    model.load_state_dict(fold_imagenet_normalization(model.state_dict()))
    model.eval()
    n_images = SERVE["requests"] + SERVE["json_requests"]
    images = torch.rand((n_images, SIZE, SIZE, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(25))
    with torch.inference_mode():
        eager = torch.cat([model(images[i:i + b]) for i in
                           range(0, n_images, b)]).float().cpu()
    host_images = images.cpu().numpy()
    out = {}

    # (a) export with a dynamic batch, reload in a fresh interpreter
    path = os.path.join(workdir, "vitb16.pt2")
    t0 = time.perf_counter()
    nbytes = export_serving_artifact(model, path, (SIZE, SIZE, 3))
    export_s = time.perf_counter() - t0
    xfile = os.path.join(workdir, "x.npy")
    outfile = os.path.join(workdir, "out.npz")
    np.save(xfile, host_images[:max(SERVE["reload_batches"])])
    script = (
        "import sys, time, numpy as np, torch\n"
        "t0 = time.perf_counter()\n"
        f"program = torch.export.load({path!r}).module()\n"
        "load_s = time.perf_counter() - t0\n"
        f"x = torch.from_numpy(np.load({xfile!r})).cuda()\n"
        "outs = {}\n"
        "with torch.inference_mode():\n"
        f"    for b in {SERVE['reload_batches']!r}:\n"
        "        outs[str(b)] = program(x[:b]).float().cpu().numpy()\n"
        "bad = [m for m in sys.modules if m.startswith('chambers')]\n"
        "assert not bad, bad\n"
        f"np.savez({outfile!r}, load_s=load_s, **outs)\n")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", script], check=True, timeout=600)
    reload_s = time.perf_counter() - t0
    reloaded = np.load(outfile)
    gaps = {}
    for bsz in SERVE["reload_batches"]:
        with torch.inference_mode():
            want = model(images[:bsz])
        gap, equal, bound = logit_gap(
            torch, torch.from_numpy(reloaded[str(bsz)]), want)
        gaps[bsz] = {"max_abs": gap, "bit_equal_share": equal,
                     "bound": bound}
        check(gap <= bound, f"the reloaded artifact's logits at batch {bsz} "
                            "within 2% of the logit range of the eager ones")
    log(f"phase 25 (a): ViT-B/16 bf16 exported in {export_s:.1f} s, "
        f"{nbytes / 2 ** 20:.1f} MiB; a fresh interpreter (torch and numpy "
        f"only) loaded it in {float(reloaded['load_s']):.2f} s and served "
        f"batches {SERVE['reload_batches']} ({reload_s:.1f} s with its "
        f"start): " + ", ".join(
            f"b{k} max |d| {v['max_abs']:.3g} (bound {v['bound']:.3g}), "
            f"{100 * v['bit_equal_share']:.1f}% bit-equal"
            for k, v in gaps.items()) + f" on {CARD}")
    out["export"] = {"seconds": export_s, "mib": nbytes / 2 ** 20,
                     "reload_subprocess_s": reload_s,
                     "load_s": float(reloaded["load_s"]), "reload": gaps}

    # (b) the HTTP server on the reloaded artifact
    serve = load_serving_artifact(path)
    check(serve.device.type == "cuda", "the artifact serves on the card")
    x32 = images[:b]
    profiled = call_profile(torch, lambda: serve(x32), 3)
    n_bin = SERVE["requests"]
    rounds = {}
    with HTTPModelServer(serve, batch_size=b, port=0,
                         max_delay_ms=SERVE["max_delay_ms"],
                         dtype=np.float32) as server:
        for kind, binary, part, clients in (
                ("npy", True, host_images[:n_bin], SERVE["clients"]),
                ("json", False, host_images[n_bin:],
                 SERVE["json_requests"])):
            before = dict(server.stats)
            rows, latencies, wall = http_requests(server.port, part, binary,
                                                  clients)
            rounds[kind] = {
                "requests": len(part), "clients": clients, "wall_s": wall,
                "requests_s": len(part) / wall,
                "latency_ms": {f"p{q}": 1e3 * nearest_rank(latencies,
                                                             q / 100)
                               for q in (50, 90, 99)},
                "batches": server.stats["batches"] - before["batches"],
                "padded_rows": (server.stats["padded_rows"]
                                - before["padded_rows"]),
                "rows": rows}
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    rows = np.concatenate([rounds[k].pop("rows") for k in ("npy", "json")])
    gap, equal, bound = logit_gap(torch, torch.from_numpy(rows), eager)
    check(gap <= bound, "every served prediction within 2% of the logit "
                        "range of the eager model's row")
    check(stats["requests"] == n_images, "/stats counts every request")
    out["http"] = {
        "rounds": rounds, "stats": stats,
        "max_abs_vs_eager": gap, "bit_equal_share": equal, "bound": bound,
        "device_ms_a_batch": profiled["device_ms"],
        "launches_a_batch": profiled["launches"],
        "model_only_ms_phase6": vit_ms}
    log(f"phase 25 (b): HTTPModelServer(batch {b}, max_delay_ms "
        f"{SERVE['max_delay_ms']}) on the reloaded artifact: " + "; ".join(
            f"{r['requests']} single-image {k} requests from {r['clients']} "
            f"clients {r['requests_s']:.1f} requests/s, latency p50 "
            f"{r['latency_ms']['p50']:.1f} / p90 {r['latency_ms']['p90']:.1f}"
            f" / p99 {r['latency_ms']['p99']:.1f} ms, {r['batches']} batches,"
            f" {r['padded_rows']} padded rows" for k, r in rounds.items())
        + f"; /stats {stats['requests']} requests; max |d| against the "
        f"eager rows {gap:.3g} (bound {bound:.3g}, {100 * equal:.1f}% "
        f"bit-equal); the artifact's device time {profiled['device_ms']:.3f}"
        f" ms a batch of {b} ({profiled['launches']:.0f} launches) against "
        f"phase 6's model-only {vit_ms:.3f} ms on {CARD}")

    # (c) the same weights on the flash kernels, exported through K3a
    flash = ViTB16(dtype=torch.bfloat16, attention_impl="flash", seed=0,
                   device=dev)
    flash.load_state_dict(model.state_dict())
    flash.eval()
    flash_path = os.path.join(workdir, "vitb16_flash.pt2")
    t0 = time.perf_counter()
    flash_bytes = export_serving_artifact(flash, flash_path, (SIZE, SIZE, 3))
    flash_export_s = time.perf_counter() - t0
    program = torch.export.load(flash_path)
    operators = sum("chambers_tpu_torch.flash_fwd" in str(n.target)
                    for n in program.graph.nodes
                    if n.op == "call_function")
    check(operators == 12, "the exported flash ViT calls the K3a operator "
                           "once a layer")
    serve_flash = load_serving_artifact(flash_path)
    with torch.inference_mode():
        want = flash(x32)
    zero_flash(fa)
    with BatchedServer(serve_flash, batch_size=b,
                       max_delay_ms=SERVE["max_delay_ms"]) as server:
        served = np.stack([f.result(timeout=120) for f in
                           server.submit_many(host_images[:b])])
        served_stats = dict(server.stats)
    torch.cuda.synchronize()
    served_launches = flash_counts(fa)
    served_short = fa.flash_attention.forward_launches[
        "flash_fwd_short_kernel"]
    check(served_stats["batches"] == 1
          and served_launches == {"fwd": 12, "dkv": 0, "dq": 0}
          and served_short == 12,
          "K3a 12 launches for the one served batch, on the short kernel")
    profiled_flash = call_profile(torch, lambda: serve_flash(x32), 3)
    readings, kernel_names = flash_kernels_of(torch, fa,
                                              lambda: serve_flash(x32))
    log(f"phase 25 (c): 3 profiled served batches: launches {readings}, "
        f"the profiler's flash kernels {kernel_names}")
    check(all(r == {"fwd": 12, "dkv": 0, "dq": 0} for r in readings),
          "K3a 12 launches in each profiled served batch")
    check(kernel_names == ["flash_fwd_short_kernel"],
          "the profiler names flash_fwd_short_kernel as the served kernel")
    # the served K3a kernel's own device time a batch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            serve_flash(x32)
        torch.cuda.synchronize()
    k3a_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if "flash_fwd_short_kernel" in e.key) / 1e3 / 3
    gap, equal, bound = logit_gap(torch, torch.from_numpy(served), want)
    check(gap <= bound, "the served flash logits follow the eager flash "
                        "model's")
    dense_gap = float((torch.from_numpy(served) - eager[:b]).abs().max())
    out["flash"] = {
        "export_s": flash_export_s, "mib": flash_bytes / 2 ** 20,
        "operators": operators, "launches_a_batch": served_launches,
        "profiled_launches": readings, "profiled_kernels": kernel_names,
        "max_abs_vs_eager_flash": gap, "bit_equal_share": equal,
        "bound": bound, "max_abs_vs_dense": dense_gap,
        "device_ms_a_batch": profiled_flash["device_ms"],
        "launches_per_batch": profiled_flash["launches"],
        "k3a_kernel": kernel_names[0], "k3a_launches_a_batch": served_short,
        "k3a_device_ms_a_batch": k3a_ms}
    log(f"phase 25 (c): flash ViT-B/16 exported in {flash_export_s:.1f} s "
        f"({operators} K3a operators in the program); served one batch "
        f"through BatchedServer: K3a launches {served_launches}, "
        f"{served_short} of them {kernel_names[0]}, {k3a_ms:.3f} ms of "
        f"device time a batch; {kernel_names} in the profile; against the "
        f"eager flash "
        f"model max |d| {gap:.3g} ({100 * equal:.1f}% bit-equal, bound "
        f"{bound:.3g}), against the dense model {dense_gap:.3g}; "
        f"{profiled_flash['device_ms']:.3f} ms of device time a batch "
        f"against the dense artifact's {profiled['device_ms']:.3f} on {CARD}")
    return out, served_launches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_path(torch, fa, dev):
    """Phase 25 (d)-(f) at world size 1 over NCCL: phase 9's seq2seq step
    through ``Trainer(mesh=, param_sharding_rules=)`` against the meshless
    fit, context-parallel attention against ``flash_attention``, an FSDP
    step, an EP step on phase 22's MoE ViT-S/16 top-2 and ``pipeline_apply``
    (S = 1, M = 4) against their meshless runs, and
    ``distributed_recall_at_k`` on config 4's embeddings against
    ``utils.ranking``."""
    import torch.distributed as dist

    from chambers_tpu_torch.layers.normalization import l2_normalize
    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        context_parallel_attention,
        create_mesh,
        distributed_recall_at_k,
        fsdp_rules,
        init_distributed,
        moe_expert_parallel_rules,
        pipeline_apply,
        shard_params,
        stack_pipeline_stages,
    )
    from chambers_tpu_torch.parallel.distributed import data_parallel
    from chambers_tpu_torch.training import Trainer
    from chambers_tpu_torch.utils.ranking import (
        recall_at_k,
        score_matrix_to_binary_ranking,
    )

    info = init_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    check(dist.get_backend() == "nccl" and info["process_count"] == 1,
          "init_distributed started NCCL at world size 1")
    out = {"init": info}
    loss = masked_ce(torch)
    per_step = 3 * S2S["layers"]

    def seq2seq_trainer(mesh, rules):
        module = build_seq2seq(torch, dev, torch.bfloat16).train()
        tape = LossTape(torch, loss)
        trainer = Trainer(module, tape, torch.optim.AdamW(
            module.parameters(), lr=1e-4, weight_decay=1e-4,
            betas=(0.9, 0.999), eps=1e-8), mesh=mesh,
            param_sharding_rules=rules)
        return module, trainer, tape

    # (d) phase 9's step under a {data: 1, model: 1} mesh
    mesh = create_mesh({"data": 1, "model": 1})
    data = s2s_batches(torch, 3)
    losses, launches = {}, {}
    for key, m, rules in (("meshless", None, None),
                          ("mesh", mesh, SEQ2SEQ_TENSOR_PARALLEL_RULES)):
        module, trainer, tape = seq2seq_trainer(m, rules)
        zero_flash(fa)
        trainer.fit(data, epochs=1, verbose=False)
        torch.cuda.synchronize()
        losses[key], launches[key] = tape.floats(), flash_counts(fa)
        if key == "mesh":
            # Trainer(mesh=) gathers every rank's outputs and computes the
            # loss on the whole batch (the pair losses and the DETR matcher
            # need every row): its bytes a step against the gradients'
            # all-reduce, at 8 data ranks (one 8-card host), the same batch
            (src0, tgt0), _ = data[0]
            with torch.no_grad():
                logits = module([src0.to(dev), tgt0.to(dev)],
                                deterministic=True)
            ranks = 8
            out_bytes = logits.numel() * logits.element_size()
            grad_bytes = sum(p.numel() * p.element_size()
                             for p in module.parameters())
            traffic = {
                "data_ranks": ranks, "output_bytes": out_bytes,
                "gather_bytes_a_rank": out_bytes * (ranks - 1) / ranks,
                "gradient_allreduce_bytes_a_rank":
                    2 * grad_bytes * (ranks - 1) / ranks}
            del logits
        del module, trainer
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                  losses["meshless"]))
    check(gap <= 2 ** -7, "the mesh fit's first losses follow the "
                          "meshless fit's")
    check(all(v == per_step * 3 for v in launches["mesh"].values()),
          "K3a-c 12 launches each a step under Trainer(mesh=)")
    timed = s2s_batches(torch, FIT_TIMED, offset=200)
    trainers = {"meshless": seq2seq_trainer(None, None)[1],
                "mesh": seq2seq_trainer(
                    mesh, SEQ2SEQ_TENSOR_PARALLEL_RULES)[1]}
    steps = {k: (lambda _, t=t: t.fit(timed, epochs=1, verbose=False))
             for k, t in trainers.items()}
    runs = run_in_turns(torch, steps, 1, FIT_REPEATS, 1)
    ms = {k: median(v) / FIT_TIMED for k, v in runs.items()}
    profiles = {k: fit_profile(torch, lambda k=k: steps[k](0), FIT_TIMED)
                for k in steps}
    zero_flash(fa)
    steps["mesh"](0)
    torch.cuda.synchronize()
    timed_launches = flash_counts(fa)
    check(all(v == per_step * FIT_TIMED for v in timed_launches.values()),
          "K3a-c 12 launches each a step in the timed mesh fit")
    out["trainer_mesh"] = {
        "losses": losses, "bit_equal": losses["mesh"] == losses["meshless"],
        "max_rel_gap": gap, "ms_per_step": ms, "traffic": traffic,
        "runs_ms": {k: [r / FIT_TIMED for r in v] for k, v in runs.items()},
        "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
        "launches_per_step": {k: p["launches"] for k, p in profiles.items()},
        "busy": {k: profiles[k]["device_ms"] / ms[k] for k in ms},
        "flash_launches_per_step": {k: v / FIT_TIMED
                                    for k, v in timed_launches.items()}}
    log(f"phase 25 (d): phase 9's step through Trainer(mesh={{data: 1, "
        f"model: 1}}, SEQ2SEQ_TENSOR_PARALLEL_RULES) over NCCL: first losses "
        f"{losses['mesh']} against the meshless fit's {losses['meshless']}"
        f" ({'bit-equal' if out['trainer_mesh']['bit_equal'] else f'gap {gap:.3g}'}"
        f"); median of {FIT_REPEATS} fits of {FIT_TIMED} steps in turns: "
        + "; ".join(f"{k} {ms[k]:.3f} ms/step, kernels "
                    f"{profiles[k]['device_ms']:.3f} ms, busy "
                    f"{100 * profiles[k]['device_ms'] / ms[k]:.1f}%, "
                    f"{profiles[k]['launches']:.0f} launches" for k in ms)
        + f" on {CARD}; at {ranks} data ranks a rank would receive "
        f"{traffic['gather_bytes_a_rank'] / 2 ** 20:.1f} MiB of gathered "
        f"outputs a step ({out_bytes / 2 ** 20:.1f} MiB of logits) against "
        f"{traffic['gradient_allreduce_bytes_a_rank'] / 2 ** 20:.1f} MiB of "
        f"the gradients' ring all-reduce")
    del trainers, steps

    # (e) context-parallel attention at [16, 8, 512, 64] bf16
    g = torch.Generator(device=dev).manual_seed(26)
    shape = (S2S["batch"], S2S["heads"], S2S["t"], 64)
    q, k, v = (torch.randn(shape, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    do = torch.randn(shape, device=dev, generator=g, dtype=torch.bfloat16)
    cp_mesh = create_mesh({"data": 1})

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fn(qq, vv, kk)
        o.backward(do)
        return o, qq.grad, kk.grad, vv.grad

    want = run(lambda a, b_, c: fa.flash_attention(a, b_, c))
    zero_flash(fa)
    got = run(lambda a, b_, c: context_parallel_attention(
        a, b_, c, mesh=cp_mesh))
    torch.cuda.synchronize()
    cp_launches = flash_counts(fa)
    cp_equal = [bool(torch.equal(a, b_)) for a, b_ in zip(got, want)]
    check(all(cp_equal), "context-parallel attention bit-equal to "
                         "flash_attention at world size 1 (output, dq, dk, "
                         "dv)")
    check(cp_launches == {"fwd": 1, "dkv": 1, "dq": 1},
          "K3a-c launched once each by context-parallel attention")
    out["context_parallel"] = {"shape": list(shape), "bit_equal": cp_equal,
                               "launches": cp_launches}
    log(f"phase 25 (e): context_parallel_attention at {list(shape)} bf16, "
        f"forward and backward: output and dq/dk/dv bit-equal to "
        f"flash_attention {cp_equal}; launches {cp_launches}")

    # (f) FSDP, EP and PP steps, and the distributed recall
    def step_loss(model, forward):
        model.zero_grad(set_to_none=True)
        value = forward(model)
        value.backward()
        grad = torch.cat([p.grad.float().flatten() for p in model.parameters()
                          if p.grad is not None])
        return float(value.detach()), grad

    src, tgt = seq2seq_tokens(torch, dev)
    labels = torch.roll(tgt, -1, dims=1)
    s2s_loss = lambda m: loss(labels, m([src, tgt], deterministic=True))
    ref = step_loss(build_seq2seq(torch, dev, torch.bfloat16).train(),
                    s2s_loss)
    fsdp_mesh = create_mesh({"data": 1})
    placed = build_seq2seq(torch, dev, torch.bfloat16).train()
    rules = fsdp_rules(placed, fsdp_mesh)
    shard_params(placed, fsdp_mesh, rules)
    with data_parallel(placed, fsdp_mesh):
        fsdp = step_loss(placed, s2s_loss)
    sharded = sum(1 for _, spec in rules if len(spec))
    fsdp_rel = rel_l2(fsdp[1], ref[1])
    check(fsdp[0] == ref[0] and fsdp_rel <= 1e-2,
          "the FSDP step's loss equals the meshless step's, its gradients "
          "within 1e-2 relative L2 (bit-equal expected; the embedding's "
          "backward accumulates in any order)")
    x = torch.randn((MOE["batch"], MOE["size"], MOE["size"], 3), device=dev,
                    generator=g)
    ep_ref = step_loss(moe_vit(torch, dev, torch.bfloat16,
                               **MOE_VARIANTS["moe_top2_e8"]),
                       lambda m: moe_vit_loss(torch, m, x))
    ep_mesh = create_mesh({"data": 1, "expert": 1})
    routed = shard_params(moe_vit(torch, dev, torch.bfloat16,
                                  **MOE_VARIANTS["moe_top2_e8"]),
                          ep_mesh, moe_expert_parallel_rules("expert"))
    with data_parallel(routed, ep_mesh):
        ep = step_loss(routed, lambda m: moe_vit_loss(torch, m, x))
    ep_rel = rel_l2(ep[1], ep_ref[1])
    check(ep[0] == ep_ref[0] and ep_rel <= 1e-2,
          "the EP step's loss equals the meshless step's, its gradients "
          "within 1e-2 relative L2 (bit-equal expected)")
    layers = [initializers.init_module(EncoderLayer(
        S2S["dim"], S2S["heads"], 4 * S2S["dim"], attention_dropout_rate=0.0,
        dense_dropout_rate=0.0, pre_norm=True, dtype=torch.bfloat16,
        device=dev), torch.Generator(device=dev).manual_seed(i))
        for i in range(PP["layers"])]
    h = torch.randn((PP["batch"], PP["t"], S2S["dim"]), device=dev,
                    generator=g)
    seq = h
    with torch.no_grad():
        for layer in layers:
            seq = layer(seq, deterministic=True)
    from torch.func import functional_call

    stacked = stack_pipeline_stages([stack_pipeline_stages(
        [dict(layer.named_parameters()) for layer in layers])])

    def stage_fn(params, a):
        for i in range(PP["layers"]):
            a = functional_call(layers[0], {n: p[i] for n, p in
                                            params.items()},
                                (a,), {"deterministic": True})
        return a

    with torch.no_grad():
        piped = pipeline_apply(stage_fn, stacked, h, mesh=create_mesh(
            {"pipe": 1}), axis="pipe", n_microbatches=PP["microbatches"])
    pp_gap = float((piped.float() - seq.float()).abs().max())
    check(pp_gap <= BF16_LOGIT_BOUND * float(seq.float().abs().max()),
          "pipeline_apply (S = 1, M = 4) follows the sequential layers")
    vits = config4_embedder(torch, dev)
    images = torch.rand((ML["batch"], ML["size"], ML["size"], 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(18))
    with torch.inference_mode():
        z = l2_normalize(vits(images).float(), axis=-1)
    y = torch.arange(ML["batch"], device=dev) % ML["classes"]
    recalls = {}
    ranking = score_matrix_to_binary_ranking(z @ z.T, y, y,
                                             remove_top1=True)
    for kk in (1, 5):
        got_r = float(distributed_recall_at_k(z, z, y, y, k=kk,
                                              mesh=fsdp_mesh,
                                              remove_top1=True))
        want_r = float(recall_at_k(ranking, kk))
        recalls[kk] = (got_r, want_r)
        check(abs(got_r - want_r) <= 1e-6, f"distributed recall@{kk} equals "
                                           "utils.ranking's")
    out["forms"] = {"fsdp": {"loss": fsdp[0], "loss_meshless": ref[0],
                             "grad_rel_l2": fsdp_rel,
                             "sharded_rules": sharded},
                    "ep": {"loss": ep[0], "loss_meshless": ep_ref[0],
                           "grad_rel_l2": ep_rel},
                    "pp": {"max_abs_vs_sequential": pp_gap},
                    "recall": {str(k): v for k, v in recalls.items()}}
    log(f"phase 25 (f): FSDP step on phase 9's model ({sharded} parameters "
        f"under a data spec) loss {fsdp[0]:.6f}, meshless {ref[0]:.6f}, "
        f"gradients rel L2 {fsdp_rel:.3g}; EP step on the MoE ViT-S/16 "
        f"top-2 of 8 loss {ep[0]:.6f}, meshless {ep_ref[0]:.6f}, gradients "
        f"rel L2 {ep_rel:.3g}; "
        f"pipeline_apply (S = 1, M = {PP['microbatches']}) over "
        f"{PP['layers']} layers max |d| {pp_gap:.3g} against the layers in "
        f"sequence; recall@1/@5 on config 4's 256 embeddings "
        f"{recalls} (distributed, utils.ranking)")
    dist.destroy_process_group()
    return out, timed_launches, cp_launches


def config4_embedder(torch, dev):
    """Config 4's ViT-S/16 embedder (bf16, bf16 scores, seed 0), eval."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    model = VisionTransformer(
        16, ML["width"], ML["depth"], ML["heads"], ML["mlp"],
        dropout_rate=0.0, image_size=(ML["size"], ML["size"]),
        include_top=False, pooling="cls", feature_dim=ML["features"],
        dtype=torch.bfloat16, score_dtype=torch.bfloat16, device=dev)
    return initializers.init_module(
        model, torch.Generator(device=dev).manual_seed(0)).eval()


def scale_out_path(torch, fa, dev, vit_ms):
    """Phase 25: (a)-(c) then (d)-(f), in a scratch directory of the
    checkout, removed afterwards."""
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase25")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    try:
        serving, served_launches = serving_path(torch, fa, dev, workdir,
                                                vit_ms)
        torch.cuda.empty_cache()
        mesh, mesh_launches, cp_launches = mesh_path(torch, fa, dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"phase 25: {seconds:.1f} s")
    return ({"serving": serving, "mesh": mesh, "seconds": seconds},
            {"launches_served_flash": served_launches,
             "launches_trainer_mesh": mesh_launches,
             "launches_context_parallel": cp_launches})


# ---------------------------------------------------------------------------
# 26. head sizes other than 64
# ---------------------------------------------------------------------------

# phase 9's width 512 over 16 heads (h 32: K3a-c on their narrow
# kernels), over 4 (h 128) and over 2 (h 256): phase 11's tokens and FLOPs,
# and phase 9's step, at the other head sizes
HEADS = {32: 16, 128: 4, 256: 2}
HEADS_STEPS, HEADS_REPEATS, HEADS_PROFILED = 2, 3, 2
HEADS_DECODE = 16          # tokens greedy (c) decodes
FLASH_KEYS = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
              "flash_bwd_dq": "dq"}


def head_size_cases(torch, dev, h, heads, dtype=None):
    """Phase 26 (a)'s cases for ``check_flash_kernels`` at head size ``h``:
    phase 8's two path cases at ``[16, heads, 512, h]`` in ``dtype`` (bf16
    unless given; phase 27 passes float16) with the ragged key mask; with
    bf16, at 128 and 256 the float32 kernels too, and at 256 the float16
    instances on the two path shapes."""
    dtype = dtype or torch.bfloat16
    b, t = S2S["batch"], S2S["t"]
    mask = ragged_mask(torch, b, t, dev)
    cases = [
        (f"path: encoder self / cross, key mask, h {h}", b, heads, t, t,
         dtype, False, mask, "permuted"),
        (f"path: decoder self, causal + key mask, h {h}", b, heads, t, t,
         dtype, True, mask, "stacked")]
    if dtype == torch.bfloat16 and h == 256:
        cases += [
            (f"float16, key mask, h {h}", b, heads, t, t, torch.float16,
             False, mask, "permuted"),
            (f"float16, causal + key mask, h {h}", b, heads, t, t,
             torch.float16, True, mask, "stacked")]
    if dtype == torch.bfloat16 and h >= 128:
        cases.append((f"float32, key mask, h {h}", b, heads, t, t,
                      torch.float32, False, mask, "plain"))
    return cases


def seq2seq_at_heads(torch, fa, dev, heads_of=None, decode_h=128,
                     phase=26):
    """Phase 26 (b), (c): phase 9's padded train step at each head count of
    ``heads_of`` (``HEADS`` unless given: head count by head size), flash
    against dense attention on the same init (the first loss and logits;
    the timed steps in turns; K3a-c launches by the counters, 12 each a
    flash step); then greedy decoding of ``HEADS_DECODE`` tokens at head
    size ``decode_h``, on flash and dense: in bf16, the K3a launches by
    shape and the share of equal tokens, and in float32 (the FMA kernels),
    whose tokens must equal the dense path's. Phase 28 runs it at h 512
    under its own ``phase`` label."""
    heads_of = heads_of or HEADS
    from chambers_tpu_torch.models import greedy_decode

    zero_flash(fa)  # the counters count this path alone from here

    src, tgt = seq2seq_tokens(torch, dev)
    vocab, per_step = S2S["vocab"], 3 * S2S["layers"]

    def tokens_of(i):
        return torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt

    out, steps, tallies, models = {}, {}, {}, {}
    for h, heads in heads_of.items():
        flash = build_seq2seq(torch, dev, torch.bfloat16, heads).train()
        dense = build_seq2seq(torch, dev, torch.bfloat16, heads,
                              "xla").train()
        dense.load_state_dict(flash.state_dict())
        models[h] = (flash, dense)
        with torch.no_grad():
            loss_f, logits_f = seq2seq_loss(torch, flash, *tokens_of(0))
            loss_d, logits_d = seq2seq_loss(torch, dense, *tokens_of(0))
        real = tgt != 0
        a = logits_f[real].float().flatten()
        b = logits_d[real].float().flatten()
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        rel = abs(float(loss_f) - float(loss_d)) / abs(float(loss_d))
        log(f"phase {phase} (b) h {h} ({heads} heads): first step, flash vs "
            f"dense: loss {float(loss_f):.5f} vs {float(loss_d):.5f} (rel "
            f"{rel:.2e}), logits cosine {cos:.6f}")
        check(rel <= 1e-2 and cos >= 0.999,
              f"h {h}: the flash step's first loss and logits follow the "
              f"dense path")
        check(phase != 28 or rel <= 2e-4,
              f"h {h}: the first loss within 2e-4 of the dense path's")
        out[f"h{h}"] = {"heads": heads, "first_loss": float(loss_f),
                        "first_loss_dense": float(loss_d),
                        "first_loss_rel_gap": rel, "logits_cosine": cos}
        del logits_f, logits_d
        for impl, model in (("flash", flash), ("dense", dense)):
            opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                    weight_decay=1e-4, betas=(0.9, 0.999),
                                    eps=1e-8)
            tally = tallies[f"{impl} h{h}"] = dict.fromkeys(
                ("fwd", "dkv", "dq", "steps"), 0)
            tally["by_kernel"] = {"fwd": {}, "dkv": {}, "dq": {}}

            def step(i, model=model, opt=opt, tally=tally):
                before, kernels = flash_counts(fa), kernel_counts(fa)
                opt.zero_grad(set_to_none=True)
                loss, _ = seq2seq_loss(torch, model, *tokens_of(i))
                loss.backward()
                opt.step()
                after = flash_counts(fa)
                for key in before:
                    tally[key] += after[key] - before[key]
                for key, counts in kernel_counts(fa).items():
                    for name, n in counts.items():
                        if n != kernels[key][name]:
                            tally["by_kernel"][key][name] = (
                                tally["by_kernel"][key].get(name, 0) + n
                                - kernels[key][name])
                tally["steps"] += 1

            steps[f"{impl} h{h}"] = step
    with shape_tally(fa) as widths:
        runs = run_in_turns(torch, steps, 1, HEADS_REPEATS, HEADS_STEPS)
        for name, tally in tallies.items():
            want = per_step * tally["steps"] if name.startswith("flash") else 0
            check(all(tally[k] == want for k in ("fwd", "dkv", "dq")),
                  f"{name}: K3a-c each launched 12 times a flash step "
                  f"(counters {tally})")
        profiles = {name: fit_profile(torch, lambda step=step: [
            step(i) for i in range(HEADS_PROFILED)], HEADS_PROFILED)
            for name, step in steps.items()}
    # every K3a launch of a flash step ran at its model's own head size:
    # none was padded
    check(widths.widths == {h: tallies[f"flash h{h}"]["fwd"]
                            for h in heads_of},
          f"the flash steps' K3a launches by head size {widths.widths} are "
          f"their models' own, unpadded")
    for name in steps:
        ms = median(runs[name])
        h = name.split(" h")[1]
        row = out[f"h{h}"].setdefault(name.split()[0], {})
        row.update({
            "ms_per_step": ms, "runs_ms": runs[name],
            "tokens_s": S2S["batch"] * 2 * S2S["t"] / (ms / 1e3),
            "device_ms": profiles[name]["device_ms"],
            "launches_per_step": profiles[name]["launches"],
            "busy": profiles[name]["device_ms"] / ms,
            "flash_launches": {k: tallies[name][k] for k in
                               ("fwd", "dkv", "dq")},
            "launches_by_kernel": tallies[name]["by_kernel"],
            "k3a_launches_by_head_size": (
                {h: widths.widths.get(int(h), 0)}
                if name.startswith("flash") else {}),
            "steps_counted": tallies[name]["steps"]})
        log(f"phase {phase} (b) {name} (b16, 512 + 512 bf16, AdamW): median "
            f"of {HEADS_REPEATS} runs of {HEADS_STEPS} steps in turns "
            f"{ms:.3f} ms/step (runs "
            f"{', '.join(f'{r:.3f}' for r in runs[name])}), kernels "
            f"{row['device_ms']:.3f} ms, busy {100 * row['busy']:.1f}%, "
            f"{row['launches_per_step']:.0f} launches a step, flash "
            f"launches {row['flash_launches']} over "
            f"{row['steps_counted']} steps, on {CARD}")
    del steps, profiles

    # (c) greedy decoding at decode_h
    flash, dense = (m.eval() for m in models[decode_h])
    before = kernel_counts(fa)["fwd"]
    with torch.no_grad(), shape_tally(fa) as tally:
        got = greedy_decode(flash, src, max_len=HEADS_DECODE, bos_id=1)
    by_kernel = {name: n - before[name]
                 for name, n in kernel_counts(fa)["fwd"].items()
                 if n != before[name]}
    with torch.no_grad():
        want = greedy_decode(dense, src, max_len=HEADS_DECODE, bos_id=1)
    bf16_equal = float((got == want).float().mean())
    del models, flash, dense
    f32 = build_seq2seq(torch, dev, torch.float32, heads_of[decode_h])
    f32_dense = build_seq2seq(torch, dev, torch.float32, heads_of[decode_h],
                              "xla")
    f32_dense.load_state_dict(f32.state_dict())
    before = flash_counts(fa)["fwd"]
    with torch.no_grad():
        got32 = greedy_decode(f32, src, max_len=HEADS_DECODE, bos_id=1)
        launches32 = flash_counts(fa)["fwd"] - before
        want32 = greedy_decode(f32_dense, src, max_len=HEADS_DECODE,
                               bos_id=1)
    torch.cuda.synchronize()
    tokens_equal = bool(torch.equal(got32, want32))
    decode = {"tokens": HEADS_DECODE, "sources": int(src.shape[0]),
              "bf16_k3a_launches_by_shape": {
                  f"{tq}x{tk}": c for (tq, tk), c in tally.counts.items()},
              "bf16_k3a_launches_by_kernel": by_kernel,
              "bf16_tokens_equal_share": bf16_equal,
              "float32_tokens_equal": tokens_equal,
              "float32_k3a_launches": launches32}
    log(f"phase {phase} (c) greedy decoding of {HEADS_DECODE} tokens x "
        f"{src.shape[0]} sources at h {decode_h}: bf16 flash K3a launches by "
        f"(tq, tk) {decode['bf16_k3a_launches_by_shape']}, "
        f"{100 * bf16_equal:.1f}% of its tokens equal the dense path's; "
        f"float32 (the FMA kernels, {launches32} K3a launches) tokens "
        f"{'equal' if tokens_equal else 'differ from'} the dense path's")
    check(tokens_equal, f"float32 greedy tokens at h {decode_h} on flash "
                        f"equal the dense path's")
    check(tally.counts.get((1, S2S["t"]), 0) > 0,
          f"the cached steps ran K3a at one query row at h {decode_h}")
    return out, decode


def clipped_step_under_mesh(torch, dev):
    """Phase 26 (d): one step of phase 9's model through ``Trainer`` with
    the port's AdamW under ``global_clipnorm`` a quarter of the step's
    gradient norm, without a mesh and under ``Trainer(mesh={data: 1,
    model: 1}, SEQ2SEQ_TENSOR_PARALLEL_RULES)``: at world size 1 the
    norms' collectives have no group, so parameters and moments must be
    the meshless step's bits."""
    from functools import partial

    import torch.distributed as dist

    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        create_mesh,
    )
    from chambers_tpu_torch.training import Trainer

    loss = masked_ce(torch)
    data = s2s_batches(torch, 1)
    (src, tgt), labels = data[0]
    probe = build_seq2seq(torch, dev, torch.bfloat16).train()
    loss(labels.to(dev), probe([src.to(dev), tgt.to(dev)],
                               deterministic=True)).backward()
    norm = float(torch.sqrt(sum((p.grad.float() ** 2).sum()
                                for p in probe.parameters())))
    del probe
    limit = norm / 4
    mesh = create_mesh({"data": 1, "model": 1})
    states = {}
    for key, m, rules in (("meshless", None, None),
                          ("mesh", mesh, SEQ2SEQ_TENSOR_PARALLEL_RULES)):
        module = build_seq2seq(torch, dev, torch.bfloat16).train()
        trainer = Trainer(module, loss, partial(
            AdamW, weight_decay=1e-4, learning_rate=1e-4,
            global_clipnorm=limit), mesh=m, param_sharding_rules=rules)
        trainer.fit(data, epochs=1, verbose=False)
        torch.cuda.synchronize()
        states[key] = (dict(trainer.state.params),
                       optimizer_moments(trainer.optimizer))
        del module, trainer
    equal = [same_bits(torch, a, b)
             for a, b in zip(states["mesh"], states["meshless"])]
    dist.destroy_process_group()
    log(f"phase 26 (d): one step of phase 9's model with global_clipnorm "
        f"{limit:.4g} (the step's gradient norm {norm:.4g}), Trainer(mesh="
        f"{{data: 1, model: 1}}) against the meshless Trainer: parameters "
        f"and moments bit-equal {equal}")
    check(all(equal), "the clipped step under a mesh of one is the "
                      "meshless step's bits")
    return {"gradient_norm": norm, "global_clipnorm": limit,
            "bit_equal": True}


def head_sizes_path(torch, fa, dev, rows):
    """Phase 26: (a) K3a-c at h 32, 128 and 256 held to their plain
    versions (``check_flash_kernels`` on ``head_size_cases``) and timed at
    phase 11's tokens (``time_flash_kernels``), K3a at one query row at h
    128 (``time_decode_kernels``); (b), (c) ``seq2seq_at_heads``; (d)
    ``clipped_step_under_mesh``. Adds ``shape_h32``, ``shape_h128`` and
    ``shape_h256`` to the K3a-c rows of the ``kernels`` line and
    ``decode_h128`` to K3a's; returns the phase's JSON object."""
    t0 = time.perf_counter()
    steps, decode = seq2seq_at_heads(torch, fa, dev)
    out = {"seq2seq": steps, "decode": decode}
    bf16, t = torch.bfloat16, S2S["t"]
    for h, heads in HEADS.items():
        errors = check_flash_kernels(torch, fa, dev, h,
                                     head_size_cases(torch, dev, h, heads))
        flash = steps[f"h{h}"]["flash"]
        timed = time_flash_kernels(torch, fa, dev, flash["flash_launches"],
                                   errors, h, heads)
        size = fa.kernel_head_size(h, bf16)
        size32 = fa.kernel_head_size(h, torch.float32)
        # the kernel each of K3a-c runs at this head size, and the launches
        # of the flash step by kernel: every one on it
        ran = {"fwd": fa.forward_kernel(bf16, size, t, t),
               "dkv": fa.backward_kernel(bf16, size, t, t),
               "dq": fa.dq_kernel(bf16, size)}
        for key, kernel in ran.items():
            check(flash["launches_by_kernel"][key] == {
                kernel: flash["flash_launches"][key]},
                f"h {h}: the flash step's {key} launches all ran {kernel} "
                f"({flash['launches_by_kernel'][key]})")
        for row in rows:
            key = FLASH_KEYS.get(row["name"])
            got = next((r for r in timed if r["name"] == row["name"]), None)
            if key is None or got is None:
                continue
            # the narrow kernels are templated on the type alone, the
            # whole-tile and producer ones on the panels too
            ptxas = (f"{ran[key]}<{{}}, {size}>"
                     if ran[key].endswith(("_tc_kernel", "_producer_kernel"))
                     else f"{ran[key]}<{{}}>")
            row[f"shape_h{h}"] = {
                "shape": f"[{S2S['batch'] * heads}, {S2S['t']}, {h}] bf16, "
                         f"ragged key mask",
                "kernel_head_size": size,
                "kernel_name": ran[key],
                "launch_shape": fa.launch_shape(key, bf16, size, t, t),
                **{k: got[k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms",
                    "wrapper_ms", "bound_ms", "bound_by", "library_ms",
                    "causal_ms", "causal_bound_ms", "full_kv_bound_ms",
                    "achieved_tflops", "float32_ms", "bytes_bound_ms",
                    "products_bound_ms", "exp_bound_ms", "sm_clock_mhz")},
                "launches_by_kernel": flash["launches_by_kernel"][key],
                "launches_over_steps": flash["steps_counted"],
                "ptxas": PTXAS.get(ptxas.format("bf16")),
                "ptxas_float16": PTXAS.get(ptxas.format("f16")),
                "ptxas_float32": PTXAS.get(
                    f"{row['name']}_cols_kernel<f32>" if size32 >= 256 else
                    f"{row['name']}_kernel<f32, {size32}>")}
    decode_rows = time_decode_kernels(
        torch, fa, dev, {f"1x{S2S['t']}": decode[
            "bf16_k3a_launches_by_shape"].get(f"1x{S2S['t']}", 0)},
        128, HEADS[128], ("cross",))
    for row in rows:
        if row["name"] == "flash_fwd":
            row["decode_h128"] = {k: decode_rows[0][k] for k in (
                "shape", "launches", "max_abs_err", "ms", "plain_ms",
                "wrapper_ms", "bound_ms", "bound_by", "library_ms")}
    out["clipped_mesh_step"] = clipped_step_under_mesh(torch, dev)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 26: {out['seconds']} s")
    return out


# phase 27: the float16 checks at phase 26's head sizes and phase 11's 64,
# and the float16 step's timed steps a run and runs in turns with bf16
F16_HEADS = {32: 16, 64: 8, 128: 4}
F16_STEPS, F16_REPEATS, F16_PROFILED = 3, 3, 2


def float16_path(torch, fa, dev, rows):
    """Phase 27: (a) K3a-c in float16 held to their plain versions
    (``check_flash_kernels`` on ``head_size_cases`` in float16) at h 32, 64
    and 128, and timed at ``[128, 512, 64]`` (``time_flash_kernels`` in
    float16); (b) phase 9's step in float16 against float32's first loss,
    in turns with the bf16 step, K3a-c launches a step by the counters.
    Adds ``float16`` to the K3a-c rows of the ``kernels`` line; returns the
    phase's JSON object."""
    from chambers_tpu_torch.utils.generic import use_mixed_precision

    t0 = time.perf_counter()
    f16 = use_mixed_precision("float16")
    check(f16 == torch.float16, "the float16 policy gives float16")
    out = {"max_abs_err": {}}
    errors = {}
    for h, heads in F16_HEADS.items():
        errors[h] = check_flash_kernels(torch, fa, dev, h, head_size_cases(
            torch, dev, h, heads, f16))
        out["max_abs_err"][f"h{h}"] = errors[h]

    # (b) phase 9's step in float16, against float32's first loss and in
    # turns with bf16
    src, tgt = seq2seq_tokens(torch, dev)
    vocab, per_step = S2S["vocab"], 3 * S2S["layers"]

    def tokens_of(i):
        return torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt

    models = {"float16": build_seq2seq(torch, dev, f16).train(),
              "bf16": build_seq2seq(torch, dev, torch.bfloat16).train()}
    first = {}
    with torch.no_grad():
        for name, model in models.items():
            first[name] = float(seq2seq_loss(torch, model, *tokens_of(0))[0])
        f32 = build_seq2seq(torch, dev, torch.float32).train()
        first["float32"] = float(seq2seq_loss(torch, f32, *tokens_of(0))[0])
        del f32
    rel = abs(first["float16"] - first["float32"]) / abs(first["float32"])
    log(f"phase 27 (b) first loss: float16 {first['float16']:.5f}, bf16 "
        f"{first['bf16']:.5f}, float32 {first['float32']:.5f} (float16 rel "
        f"{rel:.2e})")
    check(math.isfinite(first["float16"]) and rel <= 0.05,
          "the float16 step's first loss within 5% of float32's")
    steps, tallies, losses = {}, {}, {}
    for name, model in models.items():
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4, betas=(0.9, 0.999),
                                eps=1e-8)
        tally = tallies[name] = dict.fromkeys(("fwd", "dkv", "dq", "steps"),
                                              0)
        seen = losses[name] = []

        def step(i, model=model, opt=opt, tally=tally, seen=seen):
            before = flash_counts(fa)
            opt.zero_grad(set_to_none=True)
            loss, _ = seq2seq_loss(torch, model, *tokens_of(i))
            loss.backward()
            opt.step()
            after = flash_counts(fa)
            for key in before:
                tally[key] += after[key] - before[key]
            tally["steps"] += 1
            seen.append(loss.detach())

        steps[name] = step
    for step in steps.values():  # warm-up, outside the counted run
        step(0)
    for tally in tallies.values():
        tally.update(dict.fromkeys(tally, 0))
    zero_flash(fa)
    runs = run_in_turns(torch, steps, 0, F16_REPEATS, F16_STEPS)
    counted = flash_counts(fa)
    n_steps = sum(t["steps"] for t in tallies.values())
    check(all(counted[k] == per_step * n_steps for k in counted),
          f"K3a-c each launched 12 times a step over the timed run "
          f"({counted} in {n_steps} steps)")
    for name, tally in tallies.items():
        check(all(tally[k] == per_step * tally["steps"]
                  for k in ("fwd", "dkv", "dq")),
              f"{name}: K3a-c each launched 12 times a step ({tally})")
    values = [float(x) for x in losses["float16"]]
    check(all(math.isfinite(x) for x in values), "finite float16 losses")
    profile = fit_profile(torch, lambda: [
        steps["float16"](i) for i in range(F16_PROFILED)], F16_PROFILED)
    ms = {name: median(r) for name, r in runs.items()}
    out["step"] = {
        "first_loss": first, "first_loss_rel_gap_float32": rel,
        "ms_per_step": ms, "runs_ms": runs,
        "tokens_s": {name: S2S["batch"] * 2 * S2S["t"] / (v / 1e3)
                     for name, v in ms.items()},
        "flash_launches": {name: {k: t[k] for k in ("fwd", "dkv", "dq")}
                           for name, t in tallies.items()},
        "steps_counted": {name: t["steps"] for name, t in tallies.items()},
        "float16_losses": values,
        "float16_device_ms": profile["device_ms"],
        "float16_launches_per_step": profile["launches"],
        "float16_busy": profile["device_ms"] / ms["float16"]}
    log(f"phase 27 (b) phase 9's step (b16, 512 + 512, AdamW, no loss "
        f"scaling): float16 {ms['float16']:.3f} ms/step (runs "
        f"{', '.join(f'{r:.3f}' for r in runs['float16'])}), bf16 "
        f"{ms['bf16']:.3f} (runs {', '.join(f'{r:.3f}' for r in runs['bf16'])})"
        f" in turns; float16 kernels {profile['device_ms']:.3f} ms, "
        f"{profile['launches']:.0f} launches a step, busy "
        f"{100 * out['step']['float16_busy']:.1f}%; flash launches "
        f"{out['step']['flash_launches']} over "
        f"{out['step']['steps_counted']} steps; float16 losses "
        f"{[round(x, 4) for x in values]}, on {CARD}")
    del models, steps

    # (a) the times at phase 11's shape, in float16
    timed = time_flash_kernels(
        torch, fa, dev, {k: tallies["float16"][k] for k in ("fwd", "dkv",
                                                             "dq")},
        errors[64], 64, S2S["heads"], f16)
    for row in rows:
        key = FLASH_KEYS.get(row["name"])
        got = next((r for r in timed if r["name"] == row["name"]), None)
        if key is None or got is None:
            continue
        row["float16"] = {
            "shape": f"[{S2S['batch'] * S2S['heads']}, {S2S['t']}, 64] "
                     f"float16, ragged key mask",
            **{k: got[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "wrapper_ms",
                "bound_ms", "bound_by", "library_ms", "causal_ms",
                "causal_bound_ms", "full_kv_bound_ms", "achieved_tflops")},
            "bf16_ms": row["ms"], "bf16_causal_ms": row["causal_ms"],
            "launches_over_steps": tallies["float16"]["steps"],
            "ptxas": PTXAS.get(f"{row['name']}_tc_kernel<f16, 64>"),
            "note": "library_ms is F.scaled_dot_product_attention in "
                    "float16 with the same key mask; bf16_ms is phase 11's "
                    "bf16 kernel in the same call"}
        log(f"{row['name']} float16 against bf16 at [128, 512, 64]: "
            f"{got['ms'] * 1e3:.1f} against {row['ms'] * 1e3:.1f} us, SDPA "
            f"float16 {got['library_ms'] * 1e3:.1f} us, bound "
            f"{got['bound_ms'] * 1e3:.2f} us, on {CARD}")
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 27: {out['seconds']} s")
    return out


# phase 28: head sizes above 256 (the cluster kernels of K3a, K3b and
# K3c); phase 9's width over one head, small shapes at the other
# sizes, and phase 9's tokens over one head timed at each
WIDE = {512: 1}
# 1216: K3a a cluster of three blocks
WIDE_SMALL = (288, 384, 1024, 1088, 1216)
CLUSTERED = {1216: 1}


def wide_small_cases(torch, dev, h, dtype):
    """Phase 28 (b)'s small cases at head size ``h`` in ``dtype``: cross
    lengths under the causal mask (130 rows with no key among them), a
    scattered key mask, and a batch item with no valid key; and that
    item's mask."""
    dead = ragged_mask(torch, 2, 200, dev)
    dead[1] = False
    return [
        (f"cross lengths 130x260 causal, h {h}", 1, 2, 130, 260, dtype,
         True, None, "plain"),
        (f"cross lengths 260x130 causal, 130 rows with no key, h {h}", 1,
         2, 260, 130, dtype, True, None, "plain"),
        (f"70x150 key mask, h {h}", 3, 2, 70, 150, dtype, False,
         scattered_mask(torch, 3, 150, dev, 13), "permuted"),
        (f"batch item with no valid key, h {h}", 2, 2, 200, 200, dtype,
         False, dead, "stacked")], dead


def sdpa_backend(torch, dev, h, heads, dtype):
    """The backend ``F.scaled_dot_product_attention`` picks at ``[16, heads,
    512, h]`` in ``dtype`` with the ragged key mask: PyTorch's own choice,
    ``torch._fused_sdp_choice`` (flash_attention, efficient_attention,
    cudnn_attention or math)."""
    from torch.nn.attention import SDPBackend

    b, t = S2S["batch"], S2S["t"]
    mask = ragged_mask(torch, b, t, dev)[:, None, None, :]
    q, k, v = (torch.empty((b, heads, t, h), device=dev, dtype=dtype)
               .requires_grad_() for _ in range(3))
    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0,
                                              False)).name.lower()


# phase 28 (e)'s head sizes
WIDE_TIMED = (288, 384, 512, 1024, 1088)


def time_wide_kernels(torch, fa, dev, h):
    """Phase 28 (e): K3a-c at ``[16, 512, h]`` bf16 with the ragged key
    mask (phase 9's tokens over one head) at a head size above 256: each
    kernel's time (CUDA events over 20 launches behind a backlog, cycled
    over three input sets beyond the L2) against its bound, counted as
    ``time_flash_kernels`` counts it (the kept keys, the true head size,
    ``FLASH_WORK``), the TFLOP/s that gives, its registers from the build's
    report and its launch shape (shared memory, cluster size and, for
    K3b's cluster kernel, how many clusters the card holds at once, which
    must be at least one)."""
    b, t = S2S["batch"], S2S["t"]
    size, scale = fa.kernel_head_size(h, torch.bfloat16), h ** -0.5
    mask = ragged_mask(torch, b, t, dev)
    fmask = mask.float()
    gen = torch.Generator(device=dev).manual_seed(28)
    sets, plain = [], []
    for _ in range(3):
        q, k, v, do = (torch.randn((b, t, h), device=dev, generator=gen)
                       .bfloat16() for _ in range(4))
        o, l, m = fa.flash_forward_plain(q, k, v, scale, False, fmask, 1)
        plain.append((o, l, m))
        sets.append((*(fa.pad_head(x, size) for x in (q, k, v, do)), l, m,
                     fa.delta(o, do)))
    # K3a held to its plain version on the timed inputs, at phase 8's
    # tolerances
    o_k, l_k, m_k = fa.launch_forward(*sets[0][:3], fmask, scale, False, 1)
    o_p, l_p, m_p = plain[0]
    rtol, atol, rms_limit = flash_tolerance(torch, torch.bfloat16, o_p, False)
    fwd_err, needs, rms = closeness(o_k[..., :h], o_p, rtol)
    check(needs <= atol and rms <= rms_limit
          and bool(torch.allclose(l_k, l_p, rtol=1e-4, atol=1e-6))
          and bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-5)),
          f"h {h}: K3a at [{b}, {t}, {h}] bf16 within phase 8's tolerances "
          f"of its plain version (max |d| {fwd_err:.3g}, rms {rms:.3g})")
    del plain, o_k, l_k, m_k
    turn = iter(range(10 ** 9))

    def launch(key):
        q, k, v, do, l, m, di = sets[next(turn) % len(sets)]
        if key == "fwd":
            return fa.launch_forward(q, k, v, fmask, scale, False, 1)
        args = (q, k, v, do, l, m, di, fmask, scale, False, 1)
        return (fa.launch_backward_dkv(*args) if key == "dkv"
                else fa.launch_backward_dq(*args))

    kept = int(mask.sum())
    out = {"shape": f"[{b}, {t}, {h}] bf16, ragged key mask",
           "kernel_head_size": size, "fwd_max_abs_err": fwd_err}
    for name, key in FLASH_KEYS.items():
        ms = cuda_ms(torch, lambda: launch(key), 20, backlog=True)
        rows, stat_rows, per_pair = FLASH_WORK[key]
        ops = per_pair * t * h * kept
        moved = ((rows * b * t + 2 * kept) * h * 2 + stat_rows * b * t * 4
                 + b * t * 4)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_OPS_PER_S * 1e3
        shape = fa.launch_shape(key, torch.bfloat16, size, t, t)
        kernel = shape["kernel_name"]
        if shape["cluster"] > 1:
            check(shape["max_active_clusters"] > 0,
                  f"h {h}: the card holds a cluster of {name} ({shape})")
        out[name] = {
            "kernel": kernel, "ms": ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": max(bytes_ms, ops_ms) / ms,
            "achieved_tflops": ops / (ms / 1e3) / 1e12,
            "ptxas": PTXAS.get(f"{kernel}<bf16>"),
            "launch_shape": shape}
        log(f"phase 28 (e) {name} [{b}, {t}, {h}] bf16 key mask: "
            f"{ms * 1e3:.1f} us, {out[name]['achieved_tflops']:.1f} TFLOP/s, "
            f"{100 * out[name]['share_of_bound']:.1f}% of its bound "
            f"({out[name]['bound_ms'] * 1e3:.2f} us, "
            f"{out[name]['bound_by']}); ptxas {out[name]['ptxas']}; {shape}; "
            f"on {CARD}")
    return out


def wide_heads_path(torch, fa, dev, rows):
    """Phase 28: head sizes above 256, on the cluster kernels of K3a (one
    block a cluster up to h 512), K3b and K3c (float32 on the ``_cols``
    kernels). (a) K3a-c through
    ``flash_attention`` and its backward at ``[16, 512, 512]`` (phase 9's width over one head) with the
    ragged key mask, causal and not, in bf16, float16 and float32, held to
    their plain versions with phase 8's tolerances and timed in bf16 and
    float16 at phase 11's tokens and FLOPs against their bounds and SDPA
    (whose backend is named); (b) K3a-c held at h 288 (padded to 320),
    384, 1024 and 1088 on small shapes in the three types; (c), (d)
    ``seq2seq_at_heads`` at one head of 512: the train step against dense,
    K3a-c 12 launches each a step, and greedy decoding of 16 tokens, K3a
    at one query row (``[16, 1, 512]`` against ``[16, 512, 512]``) held and
    timed as in phase 17; (e) ``time_wide_kernels`` at each of
    ``WIDE_TIMED``. Adds ``shape_h512`` to the K3a-c rows of the
    ``kernels`` line and ``decode_h512`` to K3a's; returns the phase's
    JSON object."""
    t0 = time.perf_counter()
    (h, heads), = WIDE.items()
    steps, decode = seq2seq_at_heads(torch, fa, dev, WIDE, h, 28)
    out = {"seq2seq": steps, "decode": decode, "max_abs_err": {}}
    types = (torch.bfloat16, torch.float16, torch.float32)
    errors = {}
    for dtype in types:
        name = str(dtype).split(".")[-1]
        errors[dtype] = check_flash_kernels(
            torch, fa, dev, h, head_size_cases(torch, dev, h, heads,
                                               dtype)[:2])
        out["max_abs_err"][f"h{h} {name}"] = errors[dtype]
        for small in WIDE_SMALL:
            cases, dead = wide_small_cases(torch, dev, small, dtype)
            check_flash_kernels(torch, fa, dev, small, cases, dead)
    out["small_sizes_held"] = {
        "head_sizes": list(WIDE_SMALL),
        "kernel_head_sizes": [fa.kernel_head_size(x, torch.bfloat16)
                              for x in WIDE_SMALL],
        "types": [str(d).split(".")[-1] for d in types]}
    flash = steps[f"h{h}"]["flash"]
    # K3a's launches by kernel, in the step and in the decode: every one
    # on the kernel the dispatch names at this head size
    t = S2S["t"]
    step_kernel = fa.forward_kernel(torch.bfloat16, h, t, t)
    decode_kernel = fa.forward_kernel(torch.bfloat16, h, 1, t)
    check(flash["launches_by_kernel"]["fwd"] == {
        step_kernel: flash["flash_launches"]["fwd"]},
        f"h {h}: the step's K3a launches all ran {step_kernel} "
        f"({flash['launches_by_kernel']['fwd']})")
    for key, kernel in (("dkv", fa.backward_kernel(torch.bfloat16, h, t, t)),
                        ("dq", fa.dq_kernel(torch.bfloat16, h))):
        check(flash["launches_by_kernel"][key] == {
            kernel: flash["flash_launches"][key]},
            f"h {h}: the step's {key} launches all ran {kernel} "
            f"({flash['launches_by_kernel'][key]})")
    check(set(decode["bf16_k3a_launches_by_kernel"]) == {decode_kernel}
          and sum(decode["bf16_k3a_launches_by_kernel"].values())
          == sum(decode["bf16_k3a_launches_by_shape"].values()),
          f"h {h}: the decode's K3a launches all ran {decode_kernel} "
          f"({decode['bf16_k3a_launches_by_kernel']})")
    timed = time_flash_kernels(torch, fa, dev, flash["flash_launches"],
                               errors[torch.bfloat16], h, heads)
    timed16 = time_flash_kernels(torch, fa, dev, flash["flash_launches"],
                                 errors[torch.float16], h, heads,
                                 torch.float16)
    backend = sdpa_backend(torch, dev, h, heads, torch.bfloat16)
    out["sdpa_backend"] = {"bf16": backend}
    log(f"phase 28: SDPA at [{S2S['batch']}, {heads}, {S2S['t']}, {h}] bf16 "
        f"with the key mask picks the {backend} backend")
    for row in rows:
        key = FLASH_KEYS.get(row["name"])
        got = next((r for r in timed if r["name"] == row["name"]), None)
        got16 = next((r for r in timed16 if r["name"] == row["name"]), None)
        if key is None or got is None:
            continue
        shape = fa.launch_shape(key, torch.bfloat16, h, t, t)
        kernel = shape["kernel_name"]
        row[f"shape_h{h}"] = {
            "shape": f"[{S2S['batch'] * heads}, {S2S['t']}, {h}] bf16, "
                     f"ragged key mask",
            "kernel_head_size": fa.kernel_head_size(h, torch.bfloat16),
            "kernel_name": kernel,
            **{k: got[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "wrapper_ms",
                "bound_ms", "bound_by", "library_ms", "causal_ms",
                "causal_bound_ms", "full_kv_bound_ms", "achieved_tflops",
                "float32_ms")},
            "library_backend": backend,
            "launches_over_steps": flash["steps_counted"],
            "float16": {k: got16[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "causal_ms",
                "achieved_tflops")},
            "float32_max_abs_err": errors[torch.float32][key],
            "ptxas": PTXAS.get(f"{kernel}<bf16>"),
            "ptxas_float16": PTXAS.get(f"{kernel}<f16>"),
            "ptxas_float32": PTXAS.get(f"{row['name']}_cols_kernel<f32>"),
            "launch_shape": shape,
            "launch_shape_float32": fa.launch_shape(key, torch.float32, h,
                                                    S2S["t"], S2S["t"]),
            "note": "library_ms is F.scaled_dot_product_attention with the "
                    "same key mask, on the backend named; the bound counts "
                    "the function's work on the kept keys at the true head "
                    "size"}
        log(f"{row['name']} h {h}: {got['ms'] * 1e3:.1f} us bf16, "
            f"{got16['ms'] * 1e3:.1f} us float16, bound "
            f"{got['bound_ms'] * 1e3:.2f} us, SDPA ({backend}) "
            f"{got['library_ms'] * 1e3:.1f} us; registers "
            f"{row[f'shape_h{h}']['ptxas']}, "
            f"{row[f'shape_h{h}']['launch_shape']}, on {CARD}")
    decode_rows = time_decode_kernels(
        torch, fa, dev, {f"1x{S2S['t']}": decode[
            "bf16_k3a_launches_by_shape"].get(f"1x{S2S['t']}", 0)},
        h, heads, ("cross",))
    for row in rows:
        if row["name"] == "flash_fwd":
            row[f"decode_h{h}"] = {k: decode_rows[0][k] for k in (
                "shape", "launches", "max_abs_err", "ms", "plain_ms",
                "wrapper_ms", "bound_ms", "bound_by", "library_ms")}
    out["sizes"] = {f"h{x}": time_wide_kernels(torch, fa, dev, x)
                    for x in WIDE_TIMED}
    out["clustered"] = clustered_forward_path(torch, fa, dev, rows)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 28: {out['seconds']} s")
    return out


def clustered_forward_path(torch, fa, dev, rows):
    """Phase 28 (f): K3a and K3c above h 1152, where a block no longer
    holds a row tile's O or dQ, on their cluster kernels (clusters of three
    blocks, 7 + 6 + 6 panels), at ``CLUSTERED``'s one head over phase
    9's tokens (``[16, 1, 512, 1216]`` bf16, the ragged key mask): phase 28
    (a)'s two path cases held to the plain versions; one
    ``flash_attention`` call and its backward with the counters at 0 just
    before and read just after, its K3a launch on
    ``flash_fwd_cluster_kernel`` and its K3c launch on
    ``flash_bwd_dq_cluster_kernel`` as ``launch_shape`` names them, in
    clusters the card can place; then K3a-c timed there as phase 26 times
    them, against SDPA with the same mask. Adds ``shape_h1216`` to K3a's
    and K3c's rows of the ``kernels`` line."""
    (h, heads), = CLUSTERED.items()
    b, t = S2S["batch"], S2S["t"]
    errors = check_flash_kernels(
        torch, fa, dev, h, head_size_cases(torch, dev, h, heads)[:2])
    shapes = {key: fa.launch_shape(key, torch.bfloat16, h, t, t)
              for key in ("fwd", "dq")}
    kernels = {key: shape["kernel_name"] for key, shape in shapes.items()}
    for key, want, blocks in (("fwd", "flash_fwd_cluster_kernel", 3),
                              ("dq", "flash_bwd_dq_cluster_kernel", 3)):
        check(kernels[key] == want and shapes[key]["cluster"] == blocks
              and shapes[key]["max_active_clusters"] > 0,
              f"h {h}: the dispatch names {want} in clusters of {blocks} "
              f"blocks the card can place ({shapes[key]})")
    mask = ragged_mask(torch, b, t, dev)
    gen = torch.Generator(device=dev).manual_seed(281)
    q, k, v, do = (torch.randn((b, heads, t, h), device=dev, generator=gen)
                   .bfloat16().requires_grad_(i < 3) for i in range(4))
    torch.cuda.synchronize()
    zero_flash(fa)  # the counters count this call alone from here
    o = fa.flash_attention(q, v, k, kv_mask=mask)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention.launches)
    by_kernel = kernel_counts(fa)
    check(all(by_kernel[key].get(kernels[key], 0) == launches[key] == 1
              for key in kernels)
          and all(bool(torch.isfinite(x).all()) for x in (o, *grads)),
          f"h {h}: the call's K3a and K3c launches ran {kernels} "
          f"({by_kernel}), finite outputs")
    del q, k, v, do, o, grads
    timed = time_flash_kernels(torch, fa, dev, launches, errors, h, heads)
    out = {"launches": launches, "launches_by_kernel": by_kernel,
           "max_abs_err": errors, "kernels": kernels}
    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq")):
        got = next(r for r in timed if r["name"] == name)
        entry = {
            "shape": f"[{b * heads}, {t}, {h}] bf16, ragged key mask",
            "kernel_head_size": fa.kernel_head_size(h, torch.bfloat16),
            "kernel_name": kernels[key],
            **{x: got[x] for x in (
                "launches", "max_abs_err", "ms", "plain_ms", "wrapper_ms",
                "bound_ms", "bound_by", "exp_bound_ms", "library_ms",
                "causal_ms", "causal_bound_ms", "achieved_tflops",
                "float32_ms")},
            "launches_by_kernel": by_kernel,
            "ptxas": PTXAS.get(f"{kernels[key]}<bf16>"),
            "ptxas_float16": PTXAS.get(f"{kernels[key]}<f16>"),
            "launch_shape": shapes[key],
            "note": "launches: one flash_attention call and its backward; "
                    "library_ms is F.scaled_dot_product_attention with the "
                    "same key mask (its whole backward beside K3c); the "
                    "bound counts the function's work on the kept keys at "
                    "the true head size"}
        for row in rows:
            if row["name"] == name:
                row[f"shape_h{h}"] = entry
        out[f"{key}_ms"] = got["ms"]
        log(f"phase 28 (f) {name} h {h} on {kernels[key]}: "
            f"{got['ms'] * 1e3:.1f} us, causal {got['causal_ms'] * 1e3:.1f}, "
            f"plain {got['plain_ms'] * 1e3:.1f}, SDPA "
            f"{got['library_ms'] * 1e3:.1f}, bound "
            f"{got['bound_ms'] * 1e3:.2f} us; ptxas {entry['ptxas']}; "
            f"{shapes[key]}; on {CARD}")
    return out


def rows_of_head_sizes(rows):
    """A row of its own for each kernel that a K3a-c row's ``shape_h32``,
    ``shape_h128``, ``shape_h256``, ``shape_h512`` or ``shape_h1216`` names
    (``kernel_name``) other than the family's whole-tile kernel (whose
    numbers the family's row holds): the narrow kernels at h 32, K3b's
    producer kernel at h 128, the cluster kernels of K3a, K3b and K3c above
    256, with the first such shape's launches on its path (phase 26 (b) or
    28 (c)), its errors and times, and each later shape that names the
    same kernel (K3b's producer kernel at h 256, phase 26 (b); K3a's and
    K3c's cluster kernels at h 1216, phase 28 (f)) as a sub-dict of its
    row; the head size's sub-dict stays in the family's row too."""
    names = {row["name"] for row in rows}
    extra = {}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "wrapper_ms", "causal_ms",
            "achieved_tflops", "ptxas", "launch_shape", "shape")
    for row in rows:
        for key in ("shape_h32", "shape_h128", "shape_h256", "shape_h512",
                    "shape_h1216"):
            got = row.get(key)
            kernel = got.get("kernel_name") if got else None
            if (kernel is None or kernel in names
                    or kernel.endswith("_tc_kernel")):
                continue
            if kernel in extra:
                extra[kernel][key] = {k: got.get(k) for k in keys}
                continue
            extra[kernel] = {
                "name": kernel, "route": "cuda",
                "source": row["source"], "replaces": row["replaces"],
                **{k: got.get(k) for k in keys},
                "bound_us": got["bound_ms"] * 1e3, "bit_equal": False,
                "head_size": int(key[len("shape_h"):]),
                "note": f"{row['name']}'s kernel at {key[len('shape_'):]}; "
                        f"the row {row['name']} holds the same numbers under "
                        f"{key}",
                "card": CARD}
    return list(extra.values())


def main():
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    phase_seconds, clock = {}, [time.perf_counter()]

    def lap(phases):
        """The seconds since the last lap, under ``phases``: what each
        group of phases costs of the run's time limit."""
        now = time.perf_counter()
        phase_seconds[phases] = round(now - clock[0], 1)
        clock[0] = now

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        RandAugment,
    )
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        ViTB16,
        VisionTransformer,
        fold_imagenet_normalization,
    )
    from chambers_tpu_torch.ops import _build
    from chambers_tpu_torch.ops import flash_attention as fa
    from chambers_tpu_torch.ops import image_ops as iops
    from chambers_tpu_torch.ops import warp_kernels as wk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. the card
    CARD = card_line()
    log(f"card: {CARD} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    # 2. build
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(library):
        t0 = time.perf_counter()
        return _build.build(*library), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as jobs:  # one nvcc each, started together
        built = list(jobs.map(timed_build, (wk.LIBRARY, fa.LIBRARY)))
    log(f"build: {time.perf_counter() - t0:.1f} s for both libraries")
    no_fma = [read_build_report(path, seconds) for path, seconds in built]
    check(no_fma == [True, False], "warp is built with --fmad=false, "
                                   "flash_attention with FMAs")

    def rand_images(n=BATCH):
        return torch.randint(0, 256, (n, SIZE, SIZE, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    results = {}

    # 3. K2 against its plain version
    imgs = rand_images()
    mats = warp_matrices(torch, iops, BATCH, dev)
    got = wk.transform_affine_separable(imgs, mats, FILL, PAD)
    n1, n2, n3 = wk._shift_vectors(mats, BATCH, SIZE, SIZE, PAD)
    want = wk.warp_plain(imgs, n1, n2, n3, FILL, PAD)
    torch.cuda.synchronize()
    k2_diff = int((got != want).sum())
    log(f"K2 vs plain: {k2_diff} differing bytes of {got.numel()}")
    check(k2_diff == 0, "K2 bit-equal to its plain version")
    check(bool((got[11] == FILL).all()), "1000 px translation fills all")
    results["warp"] = {"max_abs_err": max_abs_diff(got, want),
                       "bit_equal": True}

    # 4. K1 against its plain version: all five classes
    op_class = torch.arange(BATCH, device=dev, dtype=torch.int32) % 5
    cy = torch.randint(0, SIZE, (BATCH,), device=dev, generator=gen)
    cx = torch.randint(0, SIZE, (BATCH,), device=dev, generator=gen)
    per_image = torch.rand(BATCH, device=dev, generator=gen) * 1.8 + 0.1
    k1_err = 0
    for label, fc, fs in (("magnitude 10", 1.9, 1.9),
                          ("magnitude 9", 1.72, 1.72),
                          ("per-image", per_image, per_image.flip(0))):
        kw = dict(fill_value=FILL, pad=PAD, color_factor=fc, sharp_factor=fs,
                  cut_half=40, cut_fill=FILL)
        got = wk.fused_round(imgs, mats, op_class, cy, cx, **kw)
        want = wk.fused_round_plain(
            imgs, *wk.fused_round_args(imgs, mats, op_class, cy, cx, **kw))
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        log(f"K1 vs plain ({label}): {diff} differing bytes")
        check(diff == 0, f"K1 bit-equal to its plain version ({label})")
        k1_err = max(k1_err, max_abs_diff(got, want))
    results["fused_round"] = {"max_abs_err": k1_err, "bit_equal": True}

    # 5. the two compositions of RandAugment on the same draws
    for magnitude in (10, 9):
        fused = RandAugment(2, magnitude, elementwise=True)
        masked = RandAugment(2, magnitude, elementwise=True,
                             fused_round_kernel=False)
        draws = fused.sample(BATCH, (SIZE, SIZE), gen, dev)
        a, b = fused.apply(imgs, draws), masked.apply(imgs, draws)
        torch.cuda.synchronize()
        diff = int((a != b).sum())
        log(f"RandAugment(2,{magnitude}) fused vs masked: {diff} differing "
            f"bytes; {int((a != imgs).sum())} bytes changed by the policy")
        check(diff == 0, "fused and masked compositions bit-equal")

    # 6. the main path: RandAugment(2, 10) -> ViT-B/16 bf16
    model = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16, seed=0,
                   device=dev)
    model.load_state_dict(fold_imagenet_normalization(model.state_dict()))
    aug = RandAugment(2, 10, elementwise=True)
    masked_aug = RandAugment(2, 10, elementwise=True,
                             fused_round_kernel=False)
    pool = [rand_images() for _ in range(STEPS)]

    def step(i, policy=aug):
        draws = policy.sample(BATCH, (SIZE, SIZE), gen, dev)
        return model(policy.apply(pool[i % len(pool)], draws))

    with torch.inference_mode():
        for i in range(WARMUP):
            step(i)
        torch.cuda.synchronize()
        wk.fused_round.launches = 0
        wk.transform_affine_separable.launches = 0
        runs = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for i in range(STEPS):
                logits = step(i)
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
            runs.append(start.elapsed_time(end) / STEPS)
            check(tuple(logits.shape) == (BATCH, 1000), "logits [32, 1000]")
            check(bool(torch.isfinite(logits).all()), "finite logits")
            log(f"main path: {BATCH / (runs[-1] / 1e3):.1f} img/s, "
                f"{runs[-1]:.3f} ms/batch (CUDA events over {STEPS} steps; "
                f"host clock {host_ms:.3f} ms/batch), batch {BATCH}, {SIZE} "
                f"px on {CARD}")
        launches = {"fused_round": wk.fused_round.launches,
                    "warp": wk.transform_affine_separable.launches}
        log(f"main path launches: {launches}")
        check(launches["fused_round"] == 2 * STEPS * REPEATS,
              "K1 launched twice per step on the main path")
        ms = sorted(runs)[len(runs) // 2]
        log(f"main path median of {REPEATS}: {BATCH / (ms / 1e3):.1f} img/s, "
            f"{ms:.3f} ms/batch (spread {min(runs):.3f}-{max(runs):.3f}) on "
            f"{CARD}")

        # the masked composition path, which runs K2
        wk.fused_round.launches = 0
        wk.transform_affine_separable.launches = 0
        for i in range(MASKED_STEPS):
            masked_logits = step(i, masked_aug)
        torch.cuda.synchronize()
        masked_launches = {"fused_round": wk.fused_round.launches,
                           "warp": wk.transform_affine_separable.launches}
        log(f"masked path launches: {masked_launches}")
        check(masked_launches["warp"] == 2 * MASKED_STEPS
              and masked_launches["fused_round"] == 0,
              "K2 launched twice per step on the masked path")
        check(bool(torch.isfinite(masked_logits).all()), "finite logits")

        # where a step's time goes: augmentation alone, model alone
        draws = aug.sample(BATCH, (SIZE, SIZE), gen, dev)
        aug_ms = cuda_ms(torch, lambda: aug.apply(pool[0], draws), 20)
        x_aug = aug.apply(pool[0], draws)
        vit_ms = cuda_ms(torch, lambda: model(x_aug), 20)
        log(f"breakdown: RandAugment(2,10) {aug_ms:.3f} ms, ViT-B/16 bf16 "
            f"{vit_ms:.3f} ms per batch of {BATCH} on {CARD}")

        # reference on a small input: a 2-layer ViT in float32 on the card
        # against the same weights on the CPU, the path the CPU tests hold
        # to the JAX package; BASELINE.md's logit gate, 1e-3
        tiny = dict(image_size=(32, 32), classes=10)
        tiny_cpu = initializers.init_module(
            VisionTransformer(16, 48, 2, 3, 96, device="cpu", **tiny),
            torch.Generator().manual_seed(1)).eval()
        tiny_gpu = VisionTransformer(16, 48, 2, 3, 96, device=dev,
                                     **tiny).eval()
        tiny_gpu.load_state_dict(tiny_cpu.state_dict())
        x_small = x_aug[:4, :32, :32].contiguous()
        d_tiny = float((tiny_gpu(x_small).cpu()
                        - tiny_cpu(x_small.cpu())).abs().max())
        log(f"tiny ViT f32, card vs CPU: max |d logit| {d_tiny:.3g}")
        check(d_tiny < 1e-3, "tiny ViT on the card matches the CPU path")

        # ViT-B/16 bf16 against the same weights in float32
        ref = ViTB16(seed=0, device=dev)
        ref.load_state_dict(model.state_dict())
        f32_scores = ViTB16(dtype=torch.bfloat16, seed=0, device=dev)
        f32_scores.load_state_dict(model.state_dict())
        want = ref(x_aug[:8]).flatten()
        for label, m in (("bf16, bf16 scores", model),
                         ("bf16, f32 scores", f32_scores)):
            got = m(x_aug[:8]).flatten()
            rel = float((got - want).norm() / want.norm())
            cos = float(torch.nn.functional.cosine_similarity(got, want,
                                                              dim=0))
            span = float(want.max() - want.min())
            log(f"ViT-B/16 {label} vs f32: rel L2 {rel:.4f}, cosine "
                f"{cos:.5f}, max |d| {float((got - want).abs().max()):.4f} "
                f"of range {span:.4f}")
            check(cos >= 0.98, f"{label} logits follow the f32 ones")
        del ref, f32_scores

    # device time by kernel over 3 main-path steps (the profiler's own
    # host cost inflates the wall time here; the device time is what to
    # read, against the unprofiled ms/batch above)
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(events.table(sort_by="self_device_time_total", row_limit=15))
    for e in events:
        name = next((k for k in ("fused_round_kernel", "warp_kernel")
                     if k in e.key), None)
        if name and e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"profile: {name} {e.count} launches, "
                f"{e.self_device_time_total / e.count:.1f} us each on the "
                f"main path's data, on {CARD}")
    busy = busy_ms / 3
    log(f"profile: {busy:.3f} ms of device time per step against {ms:.3f} "
        f"ms/batch unprofiled: device busy {100 * busy / ms:.1f}% on {CARD}")

    # 7. kernel and plain-version times at the main path's shapes: the
    # bare launch, the plain version, and the whole wrapper call (shift
    # vectors and argument checks included), cycling over inputs larger
    # than the 50 MB L2 so each launch reads from device memory
    cold = [rand_images() for _ in range(16)]  # 77 MB
    turn = iter(range(10 ** 9))

    def nxt():
        return cold[next(turn) % len(cold)]

    d0 = draws[0]
    round_kw = aug.fused_round_args(
        cold[0], aug.round_matrices(d0["idx"], d0["sign"], SIZE, SIZE),
        d0["idx"], d0["cy"], d0["cx"])
    del round_kw["images"]
    k1_args = wk.kernel_round_args(cold[0], **round_kw)
    plain_args = wk.fused_round_args(cold[0], **round_kw)
    k2_transforms = wk._device_transforms(mats, BATCH, dev)
    out = torch.empty_like(cold[0])
    classes = k1_args[1]
    kinds = {name: int((classes == k).sum()) for name, k in (
        ("warp", wk.WARP), ("color", wk.COLOR), ("sharpness", wk.SHARPNESS),
        ("cutout", wk.CUTOUT), ("passthrough", wk.PASSTHROUGH))}
    log(f"timed round's op classes: {kinds}")

    img_bytes = BATCH * SIZE * SIZE * 3
    transform_bytes = 4 * 8 * BATCH
    # per-image values the kernel reads: int32 op class, int64 centres, and
    # a factor only where it is a [b] tensor (scalars on the main path)
    scalar_bytes = BATCH * (4 + 8 + 8) + sum(
        4 * BATCH for factor, _ in k1_args[4:6] if factor is not None)
    # operations per output byte, by class (integer and float32 ALU work):
    # passthrough 1, warp ~10 index ops, color ~12, sharpness ~20, cutout ~6
    per_byte = {"passthrough": 1, "warp": 10, "color": 12, "sharpness": 20,
                "cutout": 6}
    k1_ops = sum(per_byte[k] * n for k, n in kinds.items()) * SIZE * SIZE * 3
    # the floor a kernel that reads and writes each byte once reaches on
    # this card: a device copy_ of the same bytes, on the same cold inputs
    flat = torch.empty(img_bytes, dtype=torch.uint8, device=dev)
    copy_ms = cuda_ms(torch, lambda: flat.copy_(nxt().view(-1)), 50,
                      backlog=True)
    cases = (
        ("fused_round",
         lambda: wk.launch_fused_round(nxt(), out, *k1_args),
         lambda: wk.fused_round_plain(nxt(), *plain_args),
         lambda: wk.fused_round(nxt(), **round_kw),
         2 * img_bytes + transform_bytes + scalar_bytes, k1_ops,
         "chambers_tpu/ops/warp_pallas.py:317 fused_round_pallas",
         launches["fused_round"], wk.launch_shape(cold[0], True)),
        ("warp",
         lambda: wk.launch_warp(nxt(), out, k2_transforms, FILL, PAD),
         lambda: wk.warp_plain(nxt(), n1, n2, n3, FILL, PAD),
         lambda: wk.transform_affine_separable(nxt(), mats, FILL, PAD),
         2 * img_bytes + transform_bytes, 10 * img_bytes,
         "chambers_tpu/ops/warp_pallas.py:144 "
         "transform_affine_separable_pallas",
         masked_launches["warp"], wk.launch_shape(cold[0], False)),
    )
    rows = []
    for (name, bare, plain, wrapped, nbytes, ops, replaces, count,
         shape) in cases:
        kernel_ms = cuda_ms(torch, bare, 50, backlog=True)
        plain_ms = cuda_ms(torch, plain, 10)
        wrapper_ms = cuda_ms(torch, wrapped, 20)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append({
            "name": name, "route": "cuda",
            "source": "chambers_tpu_torch/ops/csrc/warp.cu",
            "replaces": replaces, "launches": count,
            "max_abs_err": results[name]["max_abs_err"],
            "bit_equal": results[name]["bit_equal"],
            "ms": kernel_ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "copy_ms": copy_ms,
            "cluster_size": 1, "rows_per_block": shape["rows"],
            "threads_per_block": shape["threads"],
            "smem_per_block": shape["smem_bytes"],
            "note": "copy_ms is a device copy_ of the images' bytes, the "
                    "floor of a kernel that reads and writes each once; it "
                    "computes another function, so it is no library_ms",
            "card": CARD,
        })
        log(f"{name}: kernel {kernel_ms * 1e3:.2f} us ({bound_ms / kernel_ms:.0%}"
            f" of the bound), wrapper call {wrapper_ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
            f"({rows[-1]['bound_by']}), copy_ of the images "
            f"{copy_ms * 1e3:.2f} us; {shape['rows']} rows, "
            f"{shape['threads']} threads and {shape['smem_bytes']} bytes of "
            f"shared memory a block, no cluster, on {CARD}")
    torch.cuda.synchronize()
    del cold, pool, model

    lap("build, 1-7")
    # 8-11. flash attention: kernels against plain versions, the seq2seq
    # train step, a ViT on the kernel, kernel times
    flash_errors = check_flash_kernels(torch, fa, dev)
    for h in NARROW_HEADS:
        check_flash_kernels(torch, fa, dev, h, *narrow_cases(torch, dev, h))
    check_tile_products(torch, fa, dev)
    check_forward_kernel_names(torch, fa, dev)
    flash_launches = seq2seq_path(torch, fa, dev)
    vit_on_flash(torch, fa, dev, imgs)
    rows += time_flash_kernels(torch, fa, dev, flash_launches, flash_errors)

    lap("8-11")
    # 12-15. the int8 serving path (a), AutoAugment -> ViT-L/16 at 384 px
    # (b), K1 and K2 at that shape (c), _int_mm at the paths' shapes (d)
    int8_path = int8_serving_path(torch, wk, dev, aug, rand_images)
    vitl_path, stages, l_launches = autoaugment_vitl_path(torch, wk, dev)
    at_384 = time_kernels_at_384(torch, wk, dev, stages, l_launches)
    for row in rows:
        if row["name"] in at_384:
            row["shape_384"] = at_384[row["name"]]
    int_mm_rows = time_int_mm(torch, dev)

    lap("12-15")
    # 16-18. cached generation, K3a at one query row, the metric-learning
    # train step
    decode, tally = generation_path(torch, fa, dev)
    decode_rows = time_decode_kernels(torch, fa, dev, tally)
    k3a = next(i for i, row in enumerate(rows) if row["name"] == "flash_fwd")
    rows[k3a + 1:k3a + 1] = decode_rows
    metric = metric_learning_path(torch, dev)

    lap("16-18")
    # 19. the DETR train step (bench.py's config 5) in its three matcher
    # modes
    detr = detr_path(torch, dev)

    lap("19")
    # 20. the DeiT-B/16 recipe's train step in its two modes, and K3a-c
    # at its shape
    deit = deit_path(torch, fa, dev)
    at_198 = time_flash_kernels_at_198(
        torch, fa, dev, deit["distilled"]["flash_launches_timed"],
        deit["distilled"]["timed_steps"])
    served_198 = at_198.pop("served")
    served_dkv = at_198.pop("served_dkv")
    for row in rows:
        if row["name"] in at_198:
            row["shape_198"] = at_198[row["name"]]
    # K3a's short kernel, a row of its own: phase 20's distilled step is
    # its path (its launches counted over the timed steps), timed at that
    # shape and at the served ViT-B/16's
    short = at_198["flash_fwd"]
    rows.insert(next(i for i, row in enumerate(rows)
                     if row["name"] == "flash_bwd_dkv"), {
        "name": "flash_fwd_short_kernel", "route": "cuda",
        "source": "chambers_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "chambers_tpu/ops/flash_attention.py:190 _flash_forward",
        "launches": deit["distilled"]["forward_launches_timed"][
            "flash_fwd_short_kernel"],
        "launches_per_step": deit["distilled"]["forward_launches_timed"][
            "flash_fwd_short_kernel"] / deit["distilled"]["timed_steps"],
        "max_abs_err": short["max_abs_err"], "bit_equal": False,
        "ms": short["ms"], "plain_ms": short["plain_ms"],
        "bound_ms": short["bound_ms"], "bound_us": short["bound_ms"] * 1e3,
        "bound_by": short["bound_by"], "library_ms": short["library_ms"],
        "achieved_tflops": short["achieved_tflops"],
        "shape": short["shape"], "dtype": "bf16", "key_mask": None,
        "shape_served": served_198,
        "ptxas": PTXAS.get("flash_fwd_short_kernel<bf16>"),
        "ptxas_float16": PTXAS.get("flash_fwd_short_kernel<f16>"),
        "launch_shape": fa.launch_shape("fwd", torch.bfloat16, 64,
                                        DEIT_TOKENS, DEIT_TOKENS),
        "note": "K3a at head size 64 when a head's 64 to 256 queries and "
                "1 to 256 keys fit in shared memory whole; library_ms is "
                "F.scaled_dot_product_attention's forward with the same "
                "operands",
        "card": CARD})
    # K3b's short kernel, a row of its own after K3b's: phase 20's distilled
    # step is its path too
    short_dkv = at_198["flash_bwd_dkv"]
    dkv_timed = deit["distilled"]["backward_launches_timed"][
        "flash_bwd_dkv_short_kernel"]
    rows.insert(next(i for i, row in enumerate(rows)
                     if row["name"] == "flash_bwd_dq"), {
        "name": "flash_bwd_dkv_short_kernel", "route": "cuda",
        "source": "chambers_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "chambers_tpu/ops/flash_attention.py:387 "
                    "_flash_backward (dK/dV)",
        "launches": dkv_timed,
        "launches_per_step": dkv_timed / deit["distilled"]["timed_steps"],
        "max_abs_err": short_dkv["max_abs_err"], "bit_equal": False,
        "ms": short_dkv["ms"], "plain_ms": short_dkv["plain_ms"],
        "bound_ms": short_dkv["bound_ms"],
        "bound_us": short_dkv["bound_ms"] * 1e3,
        "bound_by": short_dkv["bound_by"],
        "library_ms": short_dkv["library_ms"],
        "achieved_tflops": short_dkv["achieved_tflops"],
        "shape": short_dkv["shape"], "dtype": "bf16", "key_mask": None,
        "shape_198": short_dkv, "shape_served": served_dkv,
        "ptxas": PTXAS.get("flash_bwd_dkv_short_kernel<bf16>"),
        "ptxas_float16": PTXAS.get("flash_bwd_dkv_short_kernel<f16>"),
        "launch_shape": fa.launch_shape("dkv", torch.bfloat16, 64,
                                        DEIT_TOKENS, DEIT_TOKENS),
        "note": "K3b at head size 64 when a head's 1 to 256 queries and 129 "
                "to 256 keys fit in shared memory whole; plain_ms and "
                "library_ms are the whole backward, dK/dV and dQ together "
                "(SDPA's backward with the same operands)",
        "card": CARD})

    lap("20")
    # 21. the CNN backbones: serving (a) and the SE-ResNet-50 train step (b)
    cnn_serving = cnn_serving_path(torch, dev)
    cnn_step = cnn_train_step_path(torch, dev)

    lap("21")
    # 22. mixture of experts: the MoE ViT-S/16 (a) and the GShard seq2seq
    # step on the flash kernels (b)
    moe_vit_results, gshard, gshard_launches = moe_path(torch, fa, dev)
    for row in rows:
        key = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
               "flash_bwd_dq": "dq"}.get(row["name"])
        if key:
            row["launches_gshard"] = gshard_launches[key]
    paths = {
        f"{cfg} {name}": {"ms_per_batch": r["ms"], "runs_ms": r["runs"],
                          "img_s": batch / (r["ms"] / 1e3),
                          "device_ms": r["profile"]["device_ms"],
                          "device_ms_by_kind": r["profile"]["by_kind_ms"],
                          "launches_per_step": r["profile"]["launches"],
                          "forward_ms": r["forward_ms"],
                          "augment_ms": r["augment_ms"],
                          "peak_gib": r.get("peak_gib")}
        for cfg, batch, results in (
            ("randaugment_vitb16_224 (a)", BATCH, int8_path),
            ("autoaugment_vitl16_384 (b)", L_BATCH, vitl_path))
        for name, r in results.items()}
    paths["seq2seq generation (16 x 512 sources, 128 tokens, bf16)"] = decode
    paths["metric learning (ViT-S/16 b256 bf16, MS loss, AdamW)"] = {
        "ms_per_step": metric["ms"], "runs_ms": metric["runs"],
        "img_s": metric["img_s"], "device_ms": metric["profile"]["device_ms"],
        "device_ms_by_phase": metric["profile"]["by_phase_ms"],
        "gemm_ms": metric["profile"]["gemm_ms"],
        "optimizer_span_ms": metric["profile"]["optimizer_span_ms"],
        "launches_per_step": metric["profile"]["launches"],
        "busy": metric["busy"], "peak_gib": metric["peak_gib"],
        "first_loss": metric["first_loss"],
        "first_loss_float32": metric["first_loss_f32"]}
    for mode, r in detr.items():
        paths[f"detr (config 5, b{DETR['batch']} 224 px bf16, AdamW, "
              f"matcher={mode})"] = {
            "ms_per_step": r["ms"], "runs_ms": r["runs"],
            "img_s": r["img_s"], "device_ms": r["profile"]["device_ms"],
            "device_ms_by_phase": r["profile"]["by_phase_ms"],
            "gemm_ms": r["profile"]["gemm_ms"],
            "launches_per_step": r["profile"]["launches"],
            "busy": r["busy"], "peak_gib": r["peak_gib"],
            "optimizer_span_ms": r["profile"]["optimizer_span_ms"],
            "matcher_wall_ms": r["matcher_ms"],
            "auction_iterations": r["auction_iterations"],
            "first_loss": r["first_loss"],
            "first_loss_float32": r.get("first_loss_f32")}
    for mode, r in deit.items():
        paths[f"deit-b/16 {mode} (b{DEIT['batch']} 224 px bf16, "
              f"RandAugment(2, 9), AdamW)"] = {
            "ms_per_step": r["ms"], "runs_ms": r["runs"],
            "img_s": r["img_s"], "device_ms": r["profile"]["device_ms"],
            "device_ms_by_phase": r["profile"]["by_phase_ms"],
            "attention_core_ms": r["attention_core_ms"],
            "gemm_ms": r["profile"]["gemm_ms"],
            "launches_per_step": r["profile"]["launches"],
            "flash_launches_per_step": r["flash_launches_per_step"],
            "busy": r["busy"], "peak_gib": r["peak_gib"],
            "optimizer_span_ms": r["profile"]["optimizer_span_ms"],
            "first_loss": r["first_loss"],
            "first_loss_float32": r["first_loss_f32"],
            **({"flash_vs_dense": r["flash_vs_dense"],
                "streamed_accuracy": r["streamed_accuracy"]}
               if mode == "distilled" else {})}
    for name, r in cnn_serving.items():
        paths[f"cnn serving {name} (b{CNN['batch']} 224 px bf16)"] = {
            "ms_per_batch": r["ms"], "runs_ms": r["runs"],
            "img_s": r["img_s"], "device_ms": r["profile"]["device_ms"],
            "device_ms_by_kind": r["profile"]["by_kind_ms"],
            "launches_per_step": r["profile"]["launches"],
            "busy": r["busy"], "peak_gib": r["peak_gib"],
            "gflop_per_image": r["gflop_per_image"],
            "bound_ms": r["bound_ms"],
            "card_vs_cpu_max_abs": r["card_vs_cpu_max_abs"],
            "bf16_cosine": r["bf16_cosine"]}
    paths[f"se-resnet-50 train step (b{CNN['batch']} 224 px bf16, SGDW)"] = {
        "ms_per_step": cnn_step["ms"], "runs_ms": cnn_step["runs"],
        "img_s": cnn_step["img_s"],
        "device_ms": cnn_step["profile"]["device_ms"],
        "device_ms_by_phase": cnn_step["profile"]["by_phase_ms"],
        "gemm_ms": cnn_step["profile"]["gemm_ms"],
        "launches_per_step": cnn_step["profile"]["launches"],
        "optimizer_span_ms": cnn_step["profile"]["optimizer_span_ms"],
        "busy": cnn_step["busy"], "peak_gib": cnn_step["peak_gib"],
        "bound_ms": cnn_step["bound_ms"],
        "first_loss": cnn_step["first_loss"],
        "first_loss_float32": cnn_step["first_loss_f32"],
        "f32_step_card_vs_cpu": cnn_step["f32_step_card_vs_cpu"]}
    for name in MOE_VARIANTS:
        for mode in ("forward", "train"):
            r = moe_vit_results[name][mode]
            paths[f"moe vit-s/16 {name} {mode} (b{MOE['batch']} 224 px "
                  f"bf16)"] = {
                "ms_per_step": r["ms"], "runs_ms": r["runs"],
                "img_s": r["img_s"], "vs_dense": r["vs_dense"],
                "params": moe_vit_results[name]["params"],
                "device_ms": r["device_ms"],
                "device_ms_by_kind": r["by_kind_ms"],
                "launches_per_step": r["launches"], "busy": r["busy"],
                "peak_gib": r["peak_gib"]}
    paths["moe vit-s/16 moe_top2_e8 int8 forward"] = moe_vit_results[
        "moe_top2_e8"]["int8_forward"]
    paths["moe vit-s/16 checks"] = moe_vit_results["checks"]
    paths["gshard seq2seq train step (top-2 of 8, b16 512 + 512 bf16, "
          "flash, AdamW)"] = gshard

    lap("22")
    # 23. the training harness: phase 9's step through Trainer.fit (a),
    # config 4 through the Keras facade (b), LoRA on ViT-B/16 (c)
    harness, harness_launches = harness_path(torch, fa, dev)
    for row in rows:
        key = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
               "flash_bwd_dq": "dq"}.get(row["name"])
        if key:
            row["launches_trainer"] = harness_launches[key]
    log(json.dumps({"trainer": harness, "card": CARD}))

    lap("23")
    # 24. the host data pipeline: config 4's step through Trainer.fit from
    # a TFRecord file
    data_run = data_pipeline_path(torch, wk, dev)
    for row in rows:
        if row["name"] == "fused_round":
            row["launches_data_pipeline"] = data_run["k1_launches_per_fit"]
    log(json.dumps({"data_pipeline": data_run, "card": CARD}))

    lap("24")
    # 25. serving and scale-out: ViT-B/16 exported, reloaded and served
    # over HTTP, a flash ViT through the K3a operator, the parallel paths
    # at world size 1 over NCCL
    scale_out, scale_launches = scale_out_path(torch, fa, dev, vit_ms)
    for row in rows:
        key = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
               "flash_bwd_dq": "dq"}.get(row["name"])
        if key:
            for name, counts in scale_launches.items():
                row[name] = counts[key]
        if row["name"] == "flash_fwd_short_kernel":
            row["launches_served_flash"] = scale_out["serving"]["flash"][
                "k3a_launches_a_batch"]
    log(json.dumps({"serving_and_scale_out": scale_out, "card": CARD}))
    lap("25")
    # 26. head sizes 32 (K3a-c on the narrow kernels), 128 and 256: K3a-c
    # alone, phase 9's step at 16, 4 and 2 heads, greedy decoding at 128, a
    # clipped step under a mesh
    heads = head_sizes_path(torch, fa, dev, rows)
    log(json.dumps({"head_sizes": heads, "card": CARD}))
    lap("26")
    # 27. float16: K3a-c at h 32, 64 and 128 and phase 9's step
    float16 = float16_path(torch, fa, dev, rows)
    log(json.dumps({"float16": float16, "card": CARD}))
    lap("27")
    # 28. head sizes above 256: K3a-c at h 288, 384, 512, 1024 and 1088,
    # phase 9's step over one head of 512, greedy decoding at 512, K3a's
    # clusters of three blocks at 1216
    wide = wide_heads_path(torch, fa, dev, rows)
    log(json.dumps({"wide_heads": wide, "card": CARD}))
    lap("28")
    log(json.dumps({"paths": paths, "card": CARD}))
    log(json.dumps({"int_mm": int_mm_rows, "card": CARD}))
    log(json.dumps({"seconds_by_phase": phase_seconds,
                    "seconds": round(sum(phase_seconds.values()), 1)}))

    rows += rows_of_head_sizes(rows)
    log(json.dumps({"kernels": rows}))
    log(CARD)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
