#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``mxnet_tpu_torch``) on one
NVIDIA card.  Run from the repo root: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. build   — compile the port's kernels (CUDA C++, sm_90a) from
             ``mxnet_tpu_torch/csrc`` into ``build/``, one nvcc per
             source, all started together;
2. kernel  — hold the paged-attention kernel (K4) against its plain
             PyTorch version on the card at the test shapes and at the
             Llama-3-8B serving shapes (k1 in {1, 5}; f32, bf16 and int8
             pages; a null page and a lane with no pages), and where the
             host splits a lane's context over blocks (contexts of 1 to
             1,500 tokens, a null page mid-table, k1 = 5, and a chunk
             that is not split); check that two split runs are bitwise
             equal and that a combine built to drop one split fails the
             check; then time it at the 8-lane decode shape beside its
             byte bound, the plain version and one
             ``scaled_dot_product_attention`` call (a yardstick only);
3. flash   — count the HGMMA instructions of K1's, K2's and K3's wgmma
             kernels in the built library (cuobjdump) and check that no
             HMMA (mma.sync) is left; hold the
             flash-attention kernels (K1 out and lse, K2 dq, K3 dk and dv)
             against their plain versions on the card (the CPU test
             shapes, ragged T, causal Tq != Tkv, D 8..128, f32 and bf16 on
             the tensor-core and, through misaligned buffers, the
             CUDA-core kernels, bf16 at the wgmma kernels' tile edges, K2
             with misaligned lse and delta, and the Llama-3-8B train
             shape), show that
             the bf16 check fails planted one-tile faults, check that two
             backward runs are bitwise equal and that a T = 8192 forward +
             backward allocates far less than one (T, T) score matrix per
             head, then time each kernel at the train shape beside its
             bound, its plain version and
             ``scaled_dot_product_attention`` (a yardstick only); then
             the same check and timing (queued behind a sleep) at
             BERT-base's shape: B*H 384, T 128, D 64, non-causal;
3b. optimizer — hold the port's multi-tensor optimizer kernels (O1
             multi_adamw in its class and op forms, O2 multi_sgd plain,
             momentum, Nesterov and preloaded, O3 multi_sum_sq with its
             all-finite flag) against their plain versions on the card:
             f32, bf16 and f16, mixed gradient and state dtypes, f32
             masters, ragged sizes, misaligned views, channels-last
             weights and a list longer than one table (f32 within 2 ulp;
             bf16 and f16 equal in 99.9% of elements and within 1 ulp;
             O3 within 1e-6 of an f64 host sum, its flag exact with an
             inf or a nan planted); show that a build whose tables skip
             their last tensor fails those checks; then time O1 over the
             8-layer Llama parameter list in bf16, O2 over ResNet-50's
             weights under amp and O3 over the Llama gradients beside
             their byte bounds, their plain versions and
             ``torch._fused_adamw_``, ``torch._fused_sgd_`` and
             ``torch._foreach_norm`` (yardsticks only);
4. serve   — a main path: ``LlamaServer.from_parts(TorchRunner, arena)``
             at Llama-3-8B's full width and depth in bf16 (random weights
             made on the card from a seed) answers 12 greedy requests,
             after two warm-up requests per prefill bucket, twice: every
             step eager (``graphs=False``), then each step signature a
             captured CUDA graph (the default); every request must
             complete with finite logits, the arena must be quiescent
             after, K4's launch count (replays included) must cover every
             layer of every decode step, greedy tokens must be identical
             in both runs, and the profiled graphed decode step must have
             run K4's attention kernel once per layer at least;
5. parity  — same widths, 2 layers, f32 with TF32 off: paged greedy
             tokens must equal greedy by recompute (the port's own
             prefill over prompt + tokens so far), and a port bundle
             round trip (save → ``LlamaServer(path)`` → generate) must
             serve the same tokens as the server it was saved from;
6. fleet   — a main path: two Llama-3-8B replicas (the serve phase's
             geometry, each with its own weights and arena) behind a
             ``FleetRouter`` answer 16 greedy requests at once, each step a
             captured CUDA graph; every request completes, both replicas
             serve and capture, the router's counters agree, the fleet /
             alone tokens/s ratio is logged, K4 covers every layer of every decode step of both,
             and the fleet's HTTP front (generate, healthz, metrics, the
             fleet trace) answers; then, at the parity phase's geometry,
             greedy tokens through two replicas equal one server's and a
             replica killed on its forward path is survived by a retry;
             at the bundle geometry a rolling deploy with requests in
             flight drops nothing and converges to one ``bundle_sha``, and
             ``python -m mxnet_tpu_torch.serve --fleet 2`` serves and
             exits 0 on SIGTERM;
7. train   — first, full width, 2 layers, f32, TF32 off: the graphed
             ``JitTrainStep`` (one captured CUDA graph a step) against
             the eager one, 5 adamw steps with ``set_learning_rate``
             between steps 3 and 4 and then ``step_n(4)`` against four
             ``step()`` calls: losses and weights bitwise equal; then a
             main path: ``JitTrainStep`` with ``adamw`` trains
             Llama-3-8B at full width, 8 of its 32 layers, weights Xavier
             from a seeded generator and cast to bf16, on a fixed batch
             of 2 x 2048 random tokens, every step eager, then graphed
             (one capture, replays); every loss must be finite, the
             last below the first, and K1, K2 and K3 must each have
             launched at least once per layer per step, O1 once a step;
             then 4 graphed steps with ``clip_global_norm`` 1.0, whose
             norm O3 takes; the profiles give the update's kernel ms;
8. train parity — full width, 1 layer, vocab 2048, f32 with TF32 off:
             one step's loss and every gradient, and the losses of 3
             adamw steps, on the card's kernel path must agree with the
             port's plain path on the host's CPU;
9. hybridize — ``HybridBlock.hybridize()`` as captured CUDA graphs:
             f32, 2 layers at full width, TF32 off: the hybridized forward
             (eager, then captured and replayed) within 1e-5 of the eager
             one, and 3 ``gluon.Trainer`` steps under
             ``autograd.record()`` through the hybridized block (a
             forward graph and a backward graph) with gradients and
             weights bitwise equal to eager; then two main paths at bf16,
             8 layers at full width: forward under ``no_grad`` at 1 x 128
             and 2 x 2048 tokens, eager against hybridized, with K1
             launched once per layer per forward (replays included), and
             Trainer steps under ``record()`` at 2 x 2048 tokens, eager
             against hybridized, with K1, K2 and K3 launched once per
             layer per step and the update (O1) once a step;
10. rtc    — K5, ``mx.rtc.CudaModule``: user CUDA C++ compiled by NVRTC
             and launched on NDArrays: scale_add equal to x*2 + y, the
             SwiGLU forward and backward kernels (bf16, f32 arithmetic)
             within 1 bf16 ulp of their plain versions at Llama-3-8B's MLP
             shape (4096 x 14336), a planted fault (a block that writes
             nothing) caught, a compile error raising with NVRTC's log,
             then each kernel timed beside its byte bound, its plain
             version and torch's eager ``F.silu(a) * b``;
11. imperative — a main path: MXNet-style training steps of one
             Llama-3-8B MLP block at full width, bf16, written on ``mx.nd``
             with ``ctx=mx.gpu()`` (``autograd.record()``, a SwiGLU
             ``autograd.Function`` launching the rtc kernels,
             ``backward()``, in-place SGD), bulked (the engine's default:
             each segment a captured CUDA graph, or a forward and backward
             pair where it is recorded), after 3 bulked steps are shown
             bitwise equal to 3 under ``bulk(0)``, then eager; every loss
             finite and the last below the first, each rtc kernel
             launched once per step (the kernels' own counts: an engine
             hook would turn bulking off); then the dispatch rate,
             bulked and eager, and a check that the engine enqueues
             without waiting;
12. imperative parity — the same step in f32 with TF32 off at width
             256 / 512: the card (rtc kernels) against the host
             (``PallasKernel`` bodies over the plain SwiGLU);
13. resnet — ResNet-50 v1, the repo's headline workload (no Pallas
             kernel lies on its path: convolutions run through cuDNN).
             First, f32 with TF32 off at 224 x 224, batch 2: the card
             (channels-last) against the host (NCHW) from the same
             weights, within 1e-3: train- and predict-mode logits, the
             loss, three gradients and the running statistics after
             the step; then ``resnet18_v1`` at 64 x 64, batch 8, f32,
             deterministic cuDNN: the graphed ``JitTrainStep`` (3 sgd
             steps, an lr change, ``step_n(4)``), the hybridized forward
             (predict and train mode) and 3 ``gluon.Trainer`` steps under
             ``record()`` through the graph pair, each bitwise equal to
             eager, running statistics included; then a main path:
             ResNet-50 v1 at 224 x 224, 1000 classes, ``amp`` bf16, sgd
             0.1 with momentum 0.9 through ``JitTrainStep`` on seeded
             random images, batch 256 (and 384 where it fits), every step
             eager, then graphed, then a ``step_n(10)`` window; losses
             finite and falling, O2 launched for every step's update;
             images/s, step ms, MFU from the
             convolutions' and dense layer's shapes, peak memory, the
             profiled step's idle share and top kernels, and the
             BatchNorms and the SGD update each timed alone; then the
             trained net's ``no_grad`` inference at batch 32 and 256,
             eager against hybridized;
14. bert   — BERT-base, the second headline workload.  First, its
             width at 2 layers, f32 with TF32 off, batch 2 x 128: the
             card (K1-K3) against the host (the plain versions) from the
             same weights: the outputs and the MLM loss within 1e-4, three
             gradients (the tied word embedding's among them) within
             1e-3; then ``bert_small`` in f32: the graphed
             ``JitTrainStep`` (3 adam steps, an lr change, ``step_n(3)``),
             the hybridized forward and 3 ``gluon.Trainer`` steps under
             ``record()`` through the graph pair, each bitwise equal to
             eager, and two more backward passes through the pair giving
             one pass's gradients; then a main path: BERT-base (12 x 768,
             vocab 30,522) under ``amp`` bf16, adam 1e-4, through
             ``JitTrainStep`` over ``bench.py``'s MLM wrapper on a fixed
             batch of 32 x 128 random tokens, every step eager, then
             graphed, then a ``step_n(10)`` window: losses finite and
             falling, K1, K2 and K3 launched 12 times a step and O1 once;
             samples/s, step ms, MFU from the shapes, peak memory, the
             profiled step's idle share and top kernels; then the trained
             net's ``no_grad`` inference at 32 x 128, eager against
             hybridized;
15. gluon  — Gluon's parameter layer, data and metrics.  First, at
             ``bert_small`` in f32: ``grad_req="add"`` through the graph
             pair (two half batches give the full batch's gradients within
             1e-4; ``zero_grad()`` clears them), a ``"null"`` change after
             a capture (bitwise equal to eager, a new capture), and a
             graphed ``JitTrainStep`` over a net whose pair holds
             ``AccumulateGrad`` nodes (bitwise equal to the eager step);
             then a main path: BERT-base under ``amp`` bf16 trained as a
             user's script: a name-scoped MLM ``HybridBlock``,
             ``DataLoader`` (2 workers) over 384 seeded sequences,
             ``as_in_context``, ``record()``, ``backward()``,
             ``clip_global_norm`` (O3), ``Trainer(net.collect_params(),
             "adamw")`` with ``wd_mult`` 0 on gamma, beta and bias (O1),
             ``mx.metric`` ``Loss`` and ``Perplexity``; two epochs eager,
             two hybridized: epoch losses finite and falling, K1-K3 12
             launches a step, O1 one, O3 the same every step; samples/s,
             step ms, idle share and top kernels beside the ``bert``
             phase's ``JitTrainStep``; then the ``wd_mult`` tensors
             bitwise equal to O1's plain version with ``wd`` 0,
             ``word_embed.weight`` unchanged and left out of O1 under
             ``grad_req="null"``, and ``save_parameters`` /
             ``load_parameters`` into a fresh net giving bitwise equal
             logits;
15b. np    — ``mx.np`` and ``mx.npx``.  First, ``mx.np`` functions
             on the card against the port on the host, TF32 off:
             elementwise, indexing and integer results bitwise,
             transcendental ones within 1e-6 of the largest value,
             reductions within 1e-5; a hybridized block called with
             ``mx.np`` arrays after NDArrays keeps each call's class and
             replays the NDArray call's graph (no second capture);
             ``unique``, ``nonzero``, ``bincount`` and ``delete`` inside
             a captured call raise ``MXNetError``; then a main path:
             BERT-base under ``amp`` bf16 pre-trained as a numpy-mode
             Gluon script (``mx.npx.set_np()``, ``mx.np`` batches of 32
             x 128, ``npx.pick`` over ``npx.log_softmax`` masked to a mean
             loss, ``backward()``, ``clip_global_norm`` (O3),
             ``Trainer(..., "adamw").step(1)`` (O1), an ``mx.np``
             accuracy), 12 steps eager and 12 hybridized, each step
             alternated with the gluon phase's NDArray script on a
             second net from the same seed: every output an
             ``mx.np.ndarray``, each mode's first logits bitwise equal to
             the NDArray script's at the same weights, the first losses
             within 1e-6 of plain torch's reduction of those logits, the
             loss falling, K1-K3 12 launches a step of either script
             (counted from 0 before these steps); step ms p50 (min, max)
             of both scripts, samples/s, MFU, idle share, kernels by kind
             and the loss part's host time; then the ``mx.np`` dispatch
             rate beside ``mx.nd``'s, bulked and eager;
16. vision — the other vision families and saved signatures.  First,
             each family's representative (AlexNet, VGG-16, SqueezeNet
             1.1, DenseNet-121, Inception-v3, MobileNet v1 and v2) at
             full width, batch 2, f32 with TF32 off: the card's
             (channels-last) predict-mode logits against the host's
             (NCHW) from the same weights, each held to the host's f64
             run (within 1e-3, or 3x the host f32 run's own error); a
             hybridized DenseNet-121 bitwise equal to eager; then each
             one's ``no_grad`` inference at batch 32 under ``amp`` bf16,
             eager against hybridized; then a main path: Inception-v3 at
             299 x 299, batch 128, ``amp`` bf16, sgd 0.1 momentum 0.9
             through ``JitTrainStep`` on seeded images, eager, graphed
             and ``step_n(10)``: losses finite and falling, O2 launched
             for every step's update; images/s (beside ``BASELINE.md``'s
             V100 figure), step ms, MFU, own peak memory, the p50 step's
             idle share and kernels by kind; then three fresh processes
             (``python3 chip_smoke.py vision-child export|load|plain
             <dir>``): the hybridized Inception-v3 at batch 32, a causal
             bf16 Llama (K1) and the graphed Inception-v3 step through
             ``hybridize(aot=)``, ``.params``, ``save_executable`` and
             ``save_states``, each loaded path bitwise equal to the
             exporter's with no capture at call time, ``load_executable``
             stepping on nothing, the loader's NVRTC compile of the K5
             kernels a cache hit; the time to the first output and the
             first replay with the bundles against the plain process's;
17. gan    — DCGAN at the upstream example's widths (nz 100, ngf = ndf
             = 64, 64 x 64 x 3; generator of ``Conv2DTranspose`` layers,
             discriminator of ``Conv2D``, BatchNorm and LeakyReLU 0.2),
             built with the port's ``gluon.nn`` and trained as a user's
             script: two ``gluon.Trainer``s (adam 2e-4, beta1 0.5, O1),
             one D step and one G step an iteration under ``record()``,
             ``SigmoidBinaryCrossEntropyLoss``, ``fake.detach()``, the
             noise from ``mx.nd.random.normal`` on the card, the example's
             bright-square images made on the card from a seed.  First,
             at batch 32, f32, TF32 off: one iteration on the card
             against the host's f32 and f64 runs from the same weights,
             noise and images (losses, then every weight after both
             Trainer steps); then ``mx.random.seed(7)`` and 3 hybridized
             iterations twice, bitwise equal; then the main path at batch
             128: eager, then hybridized, 5 warm-up and 20 timed
             iterations each: p50 ms, images/s, MFU from the shapes,
             idle share, peak memory, kernels by kind with the transposed
             convolutions timed alone, each net's replays and busy calls,
             O1 launched for every Trainer step, every loss finite; then
             one amp bf16 iteration whose transposed convolutions must
             run in bf16;
18. ops    — the op tail: every op the slice registers (but the
             samplers) at small shapes on the card against the port on
             the host, TF32 off: ordering, indexing and integer results
             bitwise (ties and ``Embedding``'s out-of-range ids
             included), f32 arithmetic within 1e-5 of the largest value,
             ``_linalg_*`` within 1e-4; 2^22 draws of every sampler with
             mean and variance within 5 standard errors and, where
             continuous, the KS statistic under its critical value at
             alpha 1e-6; seeded draws repeated bitwise; a hybridized
             ``Dropout`` drawing new masks at each replay and the same
             sequence after reseeding; then every op of ``ops/contrib.py``,
             ``ops/vision.py`` and ``ops/misc.py`` the same way (NMS,
             matching, anchors and ROI max pooling bitwise; MultiBoxTarget's
             masks and classes and MultiBoxDetection's classes, scores and
             kept rows bitwise, their boxes within 1e-5);
             ``nd.contrib.flash_attention`` and ``nd.contrib.paged_attention``
             on CUDA arrays launching K1 (K2, K3 in the backward) and K4,
             held against their plain versions; a ``CustomOp`` and a
             ``while_loop`` under ``record()`` with a backward against the
             host; ``boolean_mask``, ``cond`` and a recorded ``while_loop``
             inside a captured call raising ``MXNetError``;
19. ssd    — the JAX package's detection example
             (``examples/detection/train_ssd.py``) in the port, written as
             the example writes it (``hybrid_forward`` blocks, ``F.contrib``
             ops): first O4 (``csrc/box_nms.cu``) against its plain version,
             keep masks bit for bit (random, repeated boxes, one box
             repeated, IoU exactly at the threshold, more than one 64-box
             word kept); then ``SSDNet`` at full width (ResNet-18's
             ``features[:6]``, 20 classes) at 300 x 300, batch 2, f32, TF32
             off: 3 graphed ``JitTrainStep`` adam steps on the card against
             the host's f32 and f64 runs (losses, held as the gan phase
             holds DCGAN); then the main path at batch 32 (7,220 anchors,
             labels (32, 8, 5)) on seeded images made on the card:
             ``JitTrainStep(SSDTrainLoss(net), None, "adam")`` graphed (the
             whole step, ``MultiBoxTarget`` included, one capture), the same
             steps eagerly under ``record()`` with a ``gluon.Trainer``, and
             through the hybridized loss block: p50 step ms, images/s, MFU,
             idle share, own peak memory, kernels by kind; O1 every step;
             then one inference batch through ``MultiBoxPrior``, softmax and
             ``MultiBoxDetection(nms_threshold=0.45)`` (O4): its detections
             against the host's on the same inputs, the decode timed with
             O4 and with the plain version (outputs bitwise equal), and O4
             alone beside its plain version and its bound;
20. quant  — int8 quantization: first O5 (``int8_gemm``) and O6
             (``int8_conv``, ``csrc/int8_ops.cu``) against their plain
             versions, bitwise in both epilogues, at every distinct
             convolution of ResNet-50 v1 at batch 2 (the 7 x 7 stem
             among them), N 1,000, K, M and N tails, groups 2, depthwise,
             stride 2 with padding, dilation 2, misaligned views and
             BERT-base's FFN; a build whose K loop drops its last tile
             must fail every case; the registered ops' NCHW form and
             ``_contrib_quantize``/``_contrib_dequantize`` against the
             host; then the main path: ResNet-50 v1 at 224 x 224,
             f32, hybridized and captured, then calibrated through
             ``contrib.quantization.quantize_net_v2`` (naive, and entropy
             on a fresh copy) over 2 x 32 seeded images: 53
             ``QuantizedConv2D`` and one ``QuantizedDense``, thresholds
             equal to an eager calibration's (R10), each entropy
             threshold bitwise equal to ``_get_optimal_threshold`` on the
             host over the same inputs; int8 inference eager and
             hybridized at batch 32 and 256 beside the f32 net (TF32
             off): hybridized logits bitwise equal to eager and unlike the
             f32 net's, O6 launched 53 times and O5 once a forward
             (replays included; counted from 0 just before these runs and
             read just after, the side runs apart); at batch 2 each int8
             layer of the main path's net bitwise equal to the host's fed
             the card's input, and with exact-identity BatchNorms the
             card's logits within 1e-3 of the host's plain int8 run;
             then O6 over the 53 convolutions at batch 256 and O5 at the output layer and BERT-base's FFN,
             queued behind a sleep, beside their bounds, their plain
             versions, cuDNN's bf16 convolutions and ``torch._int_mm``,
             and the activation quantize timed alone;
21. sparse — sparse storage (``nd.sparse``) and its two kernels, O7
             ``csr_dot`` and O8 ``rsp_lazy_update``
             (``csrc/sparse_ops.cu``).  Path A, matrix factorization:
             ``examples/recommenders/train_mf.py``'s MFNet (two
             ``Embedding(sparse_grad=True)`` tables, factor 128) at
             MovieLens-10M's id ranges (71,569 users, 65,135 movies), a
             pool of 4 x 8,192 ratings from a seeded rank-6 truth, 20
             eager ``Trainer("adagrad", lr 1.0)`` steps: the loss falls
             by half, each gradient is row-sparse with the batch's
             distinct ids as rows, O8 launches twice a step (counted
             from 0 just before these steps), rows no id touched keep
             their bytes; then 3 steps through O8 against 3 through its
             plain version from the same weights (within 1e-5 of the
             largest weight); path B, sparse linear classification:
             ``examples/sparse/linear_classification.py``'s loop at
             Avazu's width (1,000,001 features, 22 nonzeros a row,
             Zipf-skewed ids) on a seeded libsvm file of 65,536 examples
             read by ``LibSVMIter`` into CSR batches of 8,192, 3 epochs:
             the log loss falls, O7 launches once forward and once
             transposed a batch, the first epoch's predictions agree
             with O7's plain version within 1e-5; each path's profiled
             step (wall, kernels busy, idle share); then O7 in both
             modes at path B's batch (within 1e-5 of the largest value)
             and O8's four routes (SGD, SGD with momentum, Adam, AdaGrad)
             at path A's rows (within 1e-6 of the largest value; an
             empty gradient a no-op), each queued behind a sleep beside
             its bound, its plain version and a library yardstick
             (``torch.sparse.mm``, ``torch.optim``'s sparse steps).

Each phase logs the card's SM clock and its maximum when it starts.
The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit from nvidia-smi, and before that a
``{"kernels": [...]}`` line.  Exits non-zero without that line when CUDA
is unavailable or any phase fails.
"""
import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same sheet

LLAMA3_8B = dict(num_layers=32, units=4096, hidden_size=14336,
                 num_heads=32, num_kv_heads=8, head_dim=128,
                 vocab_size=128256, rope_base=500000.0, eps=1e-6)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls queued behind a
    sleep kernel (CUDA events around the calls only), so that a call
    whose host enqueue outlasts its kernels is timed by its kernels and
    not by the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3   # at most this
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    ms_per_mcycle = start.elapsed_time(end)
    # the sleep outlasts the host's enqueue of every call twice over
    torch.cuda._sleep(int(2e6 * enqueue_ms / ms_per_mcycle) + 1_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: the kernel against its plain version ------------------------

def make_case(rng, dev, b, k1, h, kv, d, s_page, pages, maxp, q_dtype,
              page_dtype, positions, tables):
    import torch

    q = torch.from_numpy(rng.standard_normal((b, k1, h, d))
                         .astype(np.float32)).to(dev, q_dtype)
    if page_dtype == torch.int8:
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, size=(pages, s_page, kv, d)).astype(np.int8)).to(dev)
            for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(
            0.005, 0.02, size=pages).astype(np.float32)).to(dev)
            for _ in range(2))
    else:
        kp, vp = (torch.empty((pages, s_page, kv, d), dtype=page_dtype,
                              device=dev).normal_() for _ in range(2))
        scales = ()
    tbl = torch.zeros((b, maxp), dtype=torch.int32)
    for i, row in enumerate(tables):
        tbl[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32)
    return (q, kp, vp, tbl.to(dev), pos.to(dev)) + scales


def kernel_checks(pa, dev):
    """Kernel vs plain version at the test and Llama-3-8B shapes."""
    import torch

    rng = np.random.default_rng(0)
    # (label, b, k1, h, kv, d, s_page, pages, maxp, positions, tables)
    shapes = []
    # rows of whole 16-byte vectors (D 16 and 128, any page size) take
    # the cp.async ring; rows that are not (D 20 in bf16 or int8) the
    # scalar loads
    for k1 in (1, 5):
        shapes.append(("test", 3, k1, 4, 2, 16, 4, 12, 4, [5, 9, 0],
                       [[1, 2, 0, 3], [4, 5, 6], []]))
        shapes.append(("llama3-8b", 4, k1, 32, 8, 128, 16, 48, 16,
                       [100, 170, 0, 31],
                       [[1, 2, 3, 0, 4, 5, 6, 7],
                        list(range(8, 20)), [], [20, 21, 22]]))
        shapes.append(("pages/12", 3, k1, 32, 8, 128, 12, 40, 20,
                       [100, 170, 0],
                       [[1, 2, 3, 0, 4, 5, 6, 7, 8, 9],
                        list(range(10, 25)), []]))
        shapes.append(("D=20", 3, k1, 4, 2, 20, 4, 12, 4, [5, 9, 0],
                       [[1, 2, 0, 3], [4, 5, 6], []]))
    combos = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16), (torch.float32, torch.int8),
              (torch.bfloat16, torch.int8)]
    for label, b, k1, h, kv, d, s_page, pages, maxp, pos, tbls in shapes:
        for q_dt, p_dt in combos:
            args = make_case(rng, dev, b, k1, h, kv, d, s_page, pages, maxp,
                             q_dt, p_dt, pos, tbls)
            got = pa.paged_attention(*args)
            want = pa._paged_ref(*args, scale=1.0 / math.sqrt(d))
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail("kernel output not finite (%s %s/%s k1=%d)"
                     % (label, q_dt, p_dt, k1))
            if got[2].abs().max().item() != 0:
                fail("lane with no pages did not return 0 (%s)" % label)
            err = (got.float() - want.float()).abs().max().item()
            if q_dt == torch.float32:
                tol = "atol 1e-5 + rtol 1e-4"
                ok = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
            else:
                tol = "atol 2e-2"
                ok = err <= 2e-2
            log("kernel check %-9s k1=%d q=%-8s pages=%-8s max_abs_err=%.3g "
                "(%s) %s" % (label, k1, str(q_dt)[6:], str(p_dt)[6:], err,
                             tol, "ok" if ok else "FAIL"))
            if not ok:
                fail("kernel disagrees with its plain version")


def paged_reading(got, want, q_dtype):
    """The K4 check's reading, <= 1 to pass: f32 queries
    |err| / (1e-5 + 1e-4 |want|) elementwise (sums in another order),
    bf16 queries the largest |err| over 2e-2."""
    import torch

    err = (got.float() - want.float()).abs()
    if q_dtype == torch.float32:
        return (err / (1e-5 + 1e-4 * want.float().abs())).max().item()
    return err.max().item() / 2e-2


def split_cases():
    """(label, b, k1, pages, maxp, positions, tables, q dtype, page dtype)
    of the K4 checks where a lane's context is split over blocks, at
    Llama-3-8B widths (32/8 heads, D 128, pages of 16): contexts of 1, 31,
    32, 33 and 1,500 tokens (the short ones see fewer steps than there
    are splits, so some splits see nothing), a null page in the middle of
    the long lane's table, an all-null lane; k1 = 5; and a chunk-sized
    k1 = 128 whose grid fills the card unsplit (n_split = 1)."""
    import torch

    long_tbl = list(range(1, 95))
    long_tbl[40] = 0                       # a null page mid-table
    lanes = ([0, 30, 31, 32, 1499, 77],
             [[95], [96, 97], [98, 99], [100, 101, 102], long_tbl, []])
    out = []
    for q_dt, p_dt in ((torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.float32),
                       (torch.float32, torch.int8)):
        out.append(("ctx 1..1500", 6, 1, 104, 96) + lanes + (q_dt, p_dt))
    out.append(("k1=5", 6, 5, 104, 96, [0, 26, 27, 28, 1495, 77],
                lanes[1], torch.float32, torch.bfloat16))
    out.append(("chunk k1=128", 3, 128, 104, 96, [0, 200, 1371],
                [[1], list(range(2, 22)), long_tbl], torch.float32,
                torch.bfloat16))
    return out


def split_checks(pa, dev):
    """K4 against its plain version where the host splits a lane's
    context over blocks; two runs bitwise equal; returns [(name, (args,
    want, q dtype))] of the 'ctx 1..1500' cases with f32 and with bf16
    queries (the serve path's), for the planted fault."""
    import torch

    rng = np.random.default_rng(2)
    h, kv, d, s_page = 32, 8, 128, 16
    sms = pa.sm_count(dev.index)
    keep = []
    for (label, b, k1, pages, maxp, pos, tbls, q_dt, p_dt) in split_cases():
        args = make_case(rng, dev, b, k1, h, kv, d, s_page, pages, maxp,
                         q_dt, p_dt, pos, tbls)
        splits = pa.n_split(b, k1, h, kv, s_page, maxp, sms)
        combines = pa.paged_attention.combine_launches
        got = pa.paged_attention(*args)
        combined = pa.paged_attention.combine_launches - combines
        want = pa._paged_ref(*args, scale=d ** -0.5)
        torch.cuda.synchronize()
        reading = paged_reading(got, want, q_dt)
        ok = reading <= 1 and torch.isfinite(got).all().item()
        log("kernel split %-12s n_split=%d (combine launched %d) q=%-8s "
            "pages=%-8s reading %.3f %s"
            % (label, splits, combined, str(q_dt)[6:], str(p_dt)[6:],
               reading, "ok" if ok else "FAIL"))
        if not ok:
            fail("the split kernel disagrees with its plain version")
        if (splits > 1) != (label != "chunk k1=128") or \
                combined != (splits > 1):
            fail("n_split %d and %d combine launches for %s" % (
                splits, combined, label))
        if any(len(t) == 0 for t in tbls) and \
                got[[len(t) == 0 for t in tbls].index(True)].abs().max() != 0:
            fail("a lane with no pages did not return 0 (%s)" % label)
        if label == "ctx 1..1500" and p_dt == torch.bfloat16:
            keep.append(("%s q=%s" % (label, str(q_dt)[6:]),
                         (args, want, q_dt)))
    args = keep[0][1][0]
    runs = [pa.paged_attention(*args) for _ in range(2)]
    if not torch.equal(*runs):
        fail("two split K4 runs differ")
    log("kernel split: two runs bitwise equal")
    return keep


def planted_split_fault(pa, lib_path, keep):
    """A combine that leaves split 1 out (built with MXTT_DROP_SPLIT=1)
    must fail the check; returns its reading."""
    import ctypes

    import torch
    from mxnet_tpu_torch.ops import _build

    args, want, q_dt = keep
    lib = ctypes.CDLL(lib_path)
    pa._bind(lib)
    sound = _build._libs.get(pa._SOURCE)
    _build._libs[pa._SOURCE] = lib
    try:
        got = pa.paged_attention(*args)
        torch.cuda.synchronize()
    finally:
        _build._libs[pa._SOURCE] = sound
    return paged_reading(got, want, q_dt)


def launch_split(pa, sets, n=50):
    """Host enqueue time per wrapper call (no sync inside the window) and
    the kernel's device time per launch from torch.profiler, to tell a
    host-bound launch loop from a slow kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        pa.paged_attention(*sets[i % len(sets)])
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            pa.paged_attention(*sets[i % len(sets)])
        torch.cuda.synchronize()
    dev_us = {k: sum(e.device_time_total for e in prof.key_averages()
                     if k in e.key)
              for k in ("paged_attention", "paged_combine")}
    if not dev_us["paged_attention"]:
        fail("the profiler saw no paged_attention kernel")
    return host_us, {k: us / n / 1e3 for k, us in dev_us.items()}


def kernel_timing(pa, dev):
    """Kernel, plain version and SDPA at the Llama-3-8B decode shape: 8
    lanes at 1,024 tokens of context, bf16 pages, f32 queries (the
    dtypes the bf16 step functions hand the kernel), the main path's
    block-table width.  Four page sets rotate so no launch finds the
    previous one's pages in L2."""
    import torch
    import torch.nn.functional as F

    b, k1, h, kv, d, s_page = 8, 1, 32, 8, 128, 16
    ctx, maxp, pages, n_rot = 1024, 256, 2049, 4
    per_lane = ctx // s_page
    rng = np.random.default_rng(1)
    sets = []
    for _ in range(n_rot):
        perm = rng.permutation(np.arange(1, pages))[:b * per_lane]
        tables = [perm[i * per_lane:(i + 1) * per_lane].tolist()
                  for i in range(b)]
        sets.append(make_case(rng, dev, b, k1, h, kv, d, s_page, pages,
                              maxp, torch.float32, torch.bfloat16,
                              [ctx - 1] * b, tables))
    scale = 1.0 / math.sqrt(d)
    err = 0.0
    for args in sets:
        got = pa.paged_attention(*args)
        want = pa._paged_ref(*args, scale=scale)
        err = max(err, (got - want).abs().max().item())
    # SDPA over each set's gathered context: (B, KV, ctx, D) bf16
    gathered = []
    for q, kp, vp, tbl, pos in sets:
        idx = tbl[:, :per_lane].long()
        kc = kp[idx].reshape(b, ctx, kv, d).transpose(1, 2).contiguous()
        vc = vp[idx].reshape(b, ctx, kv, d).transpose(1, 2).contiguous()
        gathered.append((q.to(torch.bfloat16).transpose(1, 2).contiguous(),
                         kc, vc))
    try:
        F.scaled_dot_product_attention(*gathered[0], enable_gqa=True)

        def sdpa(i):
            return F.scaled_dot_product_attention(*gathered[i % n_rot],
                                                  enable_gqa=True)
    except TypeError:        # a torch without enable_gqa: repeat heads
        gathered = [(qq, kc.repeat_interleave(h // kv, 1),
                     vc.repeat_interleave(h // kv, 1))
                    for qq, kc, vc in gathered]

        def sdpa(i):
            return F.scaled_dot_product_attention(*gathered[i % n_rot])
    lib_out = sdpa(0).transpose(1, 2).float()
    lib_err = (lib_out - pa.paged_attention(*sets[0])).abs().max().item()
    # the kernels of one call take less than its host enqueue: time them
    # queued behind a sleep, and the back-to-back rate beside
    ms = queued_ms(lambda i: pa.paged_attention(*sets[i % n_rot]), 200)
    rate_ms = cuda_ms(lambda i: pa.paged_attention(*sets[i % n_rot]), 200)
    host_us, device_ms = launch_split(pa, sets)
    splits = pa.n_split(b, k1, h, kv, s_page, maxp, pa.sm_count(dev.index))
    log("kernel timing: n_split %d (%d blocks: %d lanes x %d kv heads x 1 "
        "row tile x %d, on %d SMs); host enqueue %.1f us per call; profiler "
        "device time per call %.4f ms attention + %.4f ms combine; %.4f ms "
        "per call back to back (the host's launch rate when above the "
        "kernels')"
        % (splits, b * kv * splits, b, kv, splits, pa.sm_count(dev.index),
           host_us, device_ms["paged_attention"], device_ms["paged_combine"],
           rate_ms))
    plain_ms = cuda_ms(lambda i: pa._paged_ref(*sets[i % n_rot],
                                               scale=scale), 20)
    library_ms = queued_ms(sdpa, 200)
    # bound: each input read once, each output written once — the live
    # K/V rows (pages up to each lane's position), q, table, positions,
    # out — against the bf16 rate for the two products
    kv_bytes = 2 * b * ctx * kv * d * 2
    io_bytes = 2 * b * k1 * h * d * 4 + b * maxp * 4 + b * 4
    n_bytes = kv_bytes + io_bytes
    flops = 4 * b * k1 * h * ctx * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log("kernel timing decode B=8 ctx=1024 H=32 KV=8 D=128 bf16 pages: "
        "kernel %.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.4f ms "
        "(%d bytes at 3.35 TB/s; %d flops) -> %.1f%% of bound; "
        "max_abs_err %.3g, sdpa vs kernel %.3g"
        % (ms, plain_ms, library_ms, bound_ms, n_bytes, flops,
           100.0 * bound_ms / ms, err, lib_err))
    if err > 1e-4:
        fail("kernel disagrees with its plain version at the decode shape")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


# -- phase 3: the flash-attention kernels against their plain versions ----

TRAIN_B, TRAIN_T, TRAIN_LAYERS = 2, 2048, 8


def flash_case(rng, dev, bh, t_q, t_kv, d, dtype, misalign=False):
    """q, k (x0.5), v and dO, standard normal from ``rng``.  ``misalign``
    starts each buffer 2 bytes past a 16-byte boundary (contiguous all
    the same), which keeps bf16 at head dims 64 and 128 off the
    tensor-core kernels: they need aligned buffers."""
    import torch

    def make(t, s):
        x = torch.from_numpy((rng.standard_normal((bh, t, d)) * s)
                             .astype(np.float32)).to(dev, dtype)
        if not misalign:
            return x
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        return buf[1:].view(x.shape).copy_(x)

    return make(t_q, 0.5), make(t_kv, 0.5), make(t_kv, 1.0), make(t_q, 1.0)


# bf16 tolerance, per head and per tile of TILE_ROWS rows of each output
# (the rows a kernel block owns): the tile's L2 error at most BF16_L2 of
# the tile's L2 norm, and its largest error at most BF16_MAX of its
# largest value, each plus a floor of 1e-3 of the tensor's mean tile
# (for tiles that are all but zero).  Outputs are rounded to bf16 (2^-9
# relative) and the tensor-core products round p and ds to bf16 as well.
TILE_ROWS, BF16_L2, BF16_MAX = 64, 1e-2, 2 ** -5


def tile_reading(g, w):
    """The bf16 check's readings for one output, each <= 1 to pass: the
    worst tile's L2 error and its worst largest error, each against its
    tolerance."""
    import torch

    bh, t, d = w.shape
    pad = -t % TILE_ROWS
    e, x = ((torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
             .reshape(bh, -1, TILE_ROWS * d)) for a in (g - w.float(), w))
    n_tiles = e.shape[0] * e.shape[1]
    l2_floor = 1e-3 * x.norm() / n_tiles ** 0.5
    max_floor = 1e-3 * x.abs().amax(-1).mean()
    l2 = e.norm(dim=-1) / (BF16_L2 * x.norm(dim=-1) + l2_floor)
    mx = e.abs().amax(-1) / (BF16_MAX * x.abs().amax(-1) + max_floor)
    return l2.max().item(), mx.max().item()


def flash_compare(fa, args, scale, causal):
    """Run K1, K2 and K3 and their plain versions on ``args``.  Returns
    ``{tensor: (reading, max_abs_err)}`` for out, lse, dq, dk and dv (a
    reading <= 1 passes), the kernels' outputs and the plain versions'
    (in that order), and the bf16 readings' parts.  f32 and lse:
    |err| <= 2e-4 + 2e-4 |want| elementwise (sums in another order);
    bf16 outputs: ``tile_reading``, except dq and dk where every row sees
    one key (Tkv = 1, or causal with Tq = 1): they are 0 exactly, and the
    kernel's must stay below 2^-10 of the largest dv."""
    import torch

    q, k, v, do = args
    t_q, t_kv = q.shape[1], k.shape[1]
    # every row sees exactly one key: p = 1 there, so ds, dq and dk are 0
    # and both sides hold only rounding noise, which a per-tile reading
    # would compare with itself
    one_key = t_kv == 1 or (causal and t_q == 1)
    out, lse = fa._fwd_kernel(q, k, v, scale, causal)
    out_r, lse_r = fa._flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    got = (out, lse) + fa._bwd_kernels(q, k, v, do, lse, delta, scale,
                                       causal)
    want = (out_r, lse_r) + fa._flash_bwd_ref(q, k, v, do, lse, delta,
                                              scale, causal)
    torch.cuda.synchronize()
    res, parts = {}, {}
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)):
            fail("%s: the kernel's finite entries differ from its plain "
                 "version's" % name)
        e = (g.float() - w.float())[fin].abs()
        err = e.max().item() if e.numel() else 0.0
        if g.dtype == torch.bfloat16 and one_key and name in ("dq", "dk"):
            # the kernel's gradient must stay below 2^-10 of the largest dv
            bound = 2 ** -10 * want[4].float().abs().max().item()
            res[name] = (g.float().abs().max().item() / bound, err)
        elif g.dtype == torch.bfloat16:
            parts[name] = tile_reading(g, w)
            res[name] = (max(parts[name]), err)
        else:
            res[name] = ((e / (2e-4 + 2e-4 * w.float()[fin].abs())).max()
                         .item() if e.numel() else 0.0, err)
    return res, got, want, parts


def kernel_errors(res):
    """Each kernel's own max_abs_err: K1 out and lse, K2 dq, K3 dk, dv."""
    return {"K1": max(res["out"][1], res["lse"][1]), "K2": res["dq"][1],
            "K3": max(res["dk"][1], res["dv"][1])}


def planted_faults(args, got, want, scale):
    """The bf16 check must see a fault confined to one tile of one head:
    a K3 block that wrote nothing, and one loop step (a tile of 64 keys or
    queries) left out of K1's, K2's or K3's sum, planted in head 0 at
    rows 1024..1087 of the train-shape outputs, and held against the
    plain versions.  Returns the readings."""
    import torch

    q, k, v, do = (x[0].float() for x in args)
    out, lse, dq, dk, dv = got
    tile = slice(1024, 1024 + TILE_ROWS)
    s = (q @ k.T) * scale
    s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1),
                      float("-inf"))
    p = torch.exp(s - lse[0][:, None])
    ds = p * (do @ v.T - (do * out[0].float()).sum(-1)[:, None])
    faults = {
        "K3 block dropped (dk)": ("dk", lambda x: x[tile].zero_()),
        "K3 block dropped (dv)": ("dv", lambda x: x[tile].zero_()),
        "K1 key step dropped (out)": ("out", lambda x: x.sub_(
            p[:, tile] @ v[tile])),
        "K2 key step dropped (dq)": ("dq", lambda x: x.sub_(
            scale * ds[:, tile] @ k[tile])),
        "K3 query step dropped (dk)": ("dk", lambda x: x.sub_(
            scale * ds[tile].T @ q[tile])),
        "K3 query step dropped (dv)": ("dv", lambda x: x.sub_(
            p[tile].T @ do[tile])),
    }
    names = ("out", "lse", "dq", "dk", "dv")
    readings = {}
    for label, (name, plant) in faults.items():
        sound = got[names.index(name)]
        bad = sound.clone()
        h0 = bad[0].float()
        plant(h0)
        bad[0] = h0.to(bad.dtype)
        readings[label] = max(tile_reading(bad, want[names.index(name)]))
    return readings


# the wgmma kernels' tile edges: K1 owns 128 query rows a block (64 per
# consumer warpgroup) and streams 128 keys a step; K3 owns 128 keys and
# streams 64 queries a step
EDGE_T = (1, 63, 65, 127, 128, 129, 255, 257)
EDGE_CROSS = ((129, 300), (300, 129), (1, 128), (128, 1))


def edge_shapes():
    """(bh, t_q, t_kv, d, causal) of the tile-edge checks, bf16 at head
    dims 64 and 128: T in EDGE_T causal and not, the causal cross lengths
    EDGE_CROSS, and B*H = 4096 at T = 64."""
    out = []
    for d in (64, 128):
        out += [(3, t, t, d, c) for t in EDGE_T for c in (False, True)]
        out += [(3, tq, tk, d, True) for tq, tk in EDGE_CROSS]
        out += [(4096, 64, 64, d, c) for c in (False, True)]
    return out


def edge_checks(fa, dev, rng):
    """K1/K2/K3 in bf16 against the plain versions at the tile edges."""
    import torch

    for bh, t_q, t_kv, d, causal in edge_shapes():
        args = flash_case(rng, dev, bh, t_q, t_kv, d, torch.bfloat16)
        res = flash_compare(fa, args, d ** -0.5, causal)[0]
        worst = max(r for r, _ in res.values())
        log("flash edge  BH=%d Tq=%d Tkv=%d D=%d causal=%d (reading) %s %s"
            % (bh, t_q, t_kv, d, causal,
               " ".join("%s %.2f" % (n, r) for n, (r, _) in res.items()),
               "ok" if worst <= 1 else "FAIL"))
        if worst > 1:
            fail("flash kernels disagree with their plain versions at a "
                 "tile edge")


def sass_counts(lib, opcode):
    """{kernel: number of ``opcode`` instructions in its SASS} for every
    kernel of the built library ``lib``, read with cuobjdump."""
    import re

    from mxnet_tpu_torch.ops import _build

    tool = os.path.join(_build.cuda_home(), "bin", "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                           "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    word = re.compile(r"\b%s\b" % opcode)
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and word.search(line):
            counts[fn] += 1
    return counts


def hgmma_counts(lib):
    """{kernel: number of HGMMA (wgmma) instructions in its SASS}."""
    return sass_counts(lib, "HGMMA")


# the wgmma kernels of K1, K2 and K3, by their mangled names' stems
WGMMA_KERNELS = {"fwd": "flash_fwd_wgmma_kernel",
                 "dq": "flash_bwd_dq_wgmma_kernel",
                 "dkv": "flash_bwd_dkv_wgmma_kernel"}


def check_hgmma(fa):
    """K1, K2 and K3's bf16 kernels must run on wgmma: print each kernel's
    HGMMA count, fail if one of the six (three kernels at head dims 64
    and 128) has none, and fail if any HMMA (mma.sync) instruction is
    left in the library."""
    lib = fa.build()
    counts = hgmma_counts(lib)
    wg = {fn: n for fn, n in counts.items() if "wgmma_kernel" in fn}
    for fn, n in sorted(wg.items()):
        log("flash sass: %d HGMMA in %s" % (n, fn))
    kinds = {kind + str(hd) for kind, stem in WGMMA_KERNELS.items()
             for hd in (64, 128) for fn in wg
             if stem + "ILi%dE" % hd in fn and wg[fn] > 0}
    if kinds != {kind + str(hd) for kind in WGMMA_KERNELS
                 for hd in (64, 128)}:
        fail("the wgmma kernels of K1, K2 and K3 are missing or have no "
             "HGMMA instruction: %s" % wg)
    hmma = {fn: n for fn, n in sass_counts(lib, "HMMA").items() if n}
    log("flash sass: %d HMMA (mma.sync) instructions in the library"
        % sum(hmma.values()))
    if hmma:
        fail("mma.sync (HMMA) is left in the flash library: %s" % hmma)


def misaligned_rows_check(fa, dev, rng):
    """K2 with lse and delta 4 bytes off a 16-byte boundary (q, k, v, dO
    and dq aligned) takes the CUDA-core kernel, and must agree with the
    plain version as the wgmma kernel does."""
    import torch

    bh, t, d, scale = 3, 200, 128, 128 ** -0.5
    q, k, v, do = flash_case(rng, dev, bh, t, t, d, torch.bfloat16)
    out, lse = fa._fwd_kernel(q, k, v, scale, True)
    delta = (do.float() * out.float()).sum(-1)
    want = fa._flash_bwd_ref(q, k, v, do, lse, delta, scale, True)[0]

    def off(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        return buf[1:].view(x.shape).copy_(x)

    readings = {}
    for label, rows in (("aligned (wgmma)", (lse, delta)),
                        ("lse, delta misaligned (CUDA cores)",
                         (off(lse), off(delta)))):
        dq = torch.empty_like(q)
        fa._run("mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, *rows, dq,
                bh, t, t, d, scale, 1, 1)
        torch.cuda.synchronize()
        readings[label] = max(tile_reading(dq, want))
    log("flash check: K2 dq at BH=3 T=200 D=128 causal bf16, %s (reading "
        "<= 1)" % ", ".join("%s %.2f" % kv for kv in readings.items()))
    if max(readings.values()) > 1:
        fail("K2 disagrees with its plain version when lse and delta are "
             "misaligned")


def flash_checks(fa, dev):
    """K1/K2/K3 against the plain versions over the shapes the CPU tests
    use, ragged and cross-length cases, and the Llama-3-8B train shape."""
    import torch

    check_hgmma(fa)
    rng = np.random.default_rng(0)
    # (label, bh, t_q, t_kv, d, causal)
    shapes = [("test", 2, 32, 32, 16, False), ("test", 2, 64, 64, 32, True),
              ("test", 2, 64, 64, 8, True), ("test", 2, 128, 128, 64, False),
              ("ragged", 3, 100, 100, 64, True),
              ("ragged", 3, 7, 7, 8, False),
              ("tq<tkv", 3, 64, 200, 32, True),
              ("tq>tkv", 3, 200, 64, 16, True),
              ("tq<tkv", 3, 64, 200, 64, True),
              ("tq>tkv", 3, 200, 70, 128, True),
              ("d128", 4, 300, 300, 128, True)]
    # bf16 at head dims 64 and 128 runs on the wgmma kernels when the
    # buffers are 16-byte aligned; misaligned, on the CUDA-core ones
    for dtype, misalign in ((torch.float32, False), (torch.bfloat16, False),
                            (torch.bfloat16, True)):
        for label, bh, t_q, t_kv, d, causal in shapes:
            if misalign and d not in (64, 128):
                continue
            args = flash_case(rng, dev, bh, t_q, t_kv, d, dtype, misalign)
            res = flash_compare(fa, args, d ** -0.5, causal)[0]
            worst = max(r for r, _ in res.values())
            log("flash check %-7s BH=%d Tq=%d Tkv=%d D=%d causal=%d %-8s "
                "%s %s (reading, max_abs_err) %s"
                % (label, bh, t_q, t_kv, d, causal, str(dtype)[6:],
                   "tensor cores" if dtype == torch.bfloat16 and
                   d in (64, 128) and not misalign else "CUDA cores  ",
                   " ".join("%s %.2f %.3g" % (n, r, e)
                            for n, (r, e) in res.items()),
                   "ok" if worst <= 1 else "FAIL"))
            if worst > 1:
                fail("flash kernels disagree with their plain versions")
    edge_checks(fa, dev, rng)
    misaligned_rows_check(fa, dev, rng)
    args = flash_case(rng, dev, TRAIN_B * 32, TRAIN_T, TRAIN_T, 128,
                      torch.bfloat16)
    res, got, want, parts = flash_compare(fa, args, 128 ** -0.5, True)
    worst = max(r for r, _ in res.values())
    log("flash check train   B*H=64 T=2048 D=128 causal bf16 (reading, "
        "max_abs_err): %s %s; bf16 readings' parts (tile L2, tile max): %s"
        % (" ".join("%s %.2f %.3g" % (n, r, e) for n, (r, e) in res.items()),
           "ok" if worst <= 1 else "FAIL",
           " ".join("%s %.3f %.3f" % ((n,) + pr) for n, pr in parts.items())))
    if worst > 1:
        fail("flash kernels disagree with their plain versions at the "
             "train shape")
    planted = planted_faults(args, got, want, 128 ** -0.5)
    log("flash check: planted faults read %s (each must be > 1)"
        % ", ".join("%s %.2f" % kv for kv in planted.items()))
    if min(planted.values()) <= 1:
        fail("the bf16 check passes a planted fault")

    # two backward runs are bitwise equal (no atomics)
    q, k, v, do = args
    out, lse = got[:2]
    delta = (do.float() * out.float()).sum(-1)
    runs = [fa._bwd_kernels(q, k, v, do, lse, delta, 128 ** -0.5, True)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("two backward runs differ")
    log("flash check: two backward runs at the train shape are bitwise "
        "equal")

    # no (T, T) buffer: the growth of the peak over a forward + backward
    del args, q, k, v, do, out, lse, delta, runs, got, want
    torch.cuda.empty_cache()
    bh, t, d = 32, 8192, 128
    q, k, v, do = flash_case(rng, dev, bh, t, t, d, torch.bfloat16)
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    one_tt = bh * t * t * 4
    log("flash check: forward + backward at B*H=32 T=8192 D=128 bf16 grew "
        "the peak by %.3f GiB; one f32 (T, T) score matrix per head is "
        "%.1f GiB" % (grown / 2 ** 30, one_tt / 2 ** 30))
    if grown >= 2 ** 30:
        fail("flash attention allocated %d bytes at T=8192" % grown)
    del q, k, v, do
    torch.cuda.empty_cache()


def flash_timing(fa, dev, b=TRAIN_B, h=32, t=TRAIN_T, d=128, causal=True,
                 timer=None, label="B=2 H=32 T=2048 D=128 causal bf16"):
    """K1, K2 and K3 at a bf16 shape, by default the Llama-3-8B train
    shape (B=2, H=32, T=2048, D=128, causal), beside their bounds, the
    plain versions and ``scaled_dot_product_attention`` (forward;
    backward for K2 + K3, timed together).  ``timer`` (default
    ``cuda_ms``: back-to-back calls) times every call but the plain
    versions'."""
    import torch
    import torch.nn.functional as F

    timer = timer or cuda_ms
    bh, scale = b * h, d ** -0.5
    rng = np.random.default_rng(3)
    q, k, v, do = flash_case(rng, dev, bh, t, t, d, torch.bfloat16)
    out, lse = fa._fwd_kernel(q, k, v, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    err = kernel_errors(flash_compare(fa, (q, k, v, do), scale, causal)[0])
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    c = int(causal)
    ms = {"K1": timer(lambda i: fa._fwd_kernel(q, k, v, scale, causal), 20),
          "K2": timer(lambda i: fa._run(
              "mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, lse, delta,
              dq, bh, t, t, d, scale, c, 1), 20),
          "K3": timer(lambda i: fa._run(
              "mxtt_flash_bwd_dkv", "dkv_launches", q, k, v, do, lse, delta,
              dk, dv, bh, t, t, d, scale, c, 1), 20)}
    plain_fwd = cuda_ms(lambda i: fa._flash_fwd_ref(q, k, v, scale, causal),
                        3, warmup=1)
    plain_bwd = cuda_ms(lambda i: fa._flash_bwd_ref(
        q, k, v, do, lse, delta, scale, causal), 3, warmup=1)
    q4, k4, v4 = (x.reshape(b, h, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = timer(lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 20)
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = do.reshape(b, h, t, d)
    lib_bwd = timer(lambda i: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True), 20)
    lib_err = (lib_out.detach().reshape(bh, t, d).float()
               - out.float()).abs().max().item()
    # bound: the products' operations on the unmasked (row, col) pairs at
    # the bf16 tensor-core rate, or each input read once and each output
    # written once at the HBM rate, whichever is longer
    pairs = bh * t * (t + 1) // 2 if causal else bh * t * t
    tile = bh * t * d * 2                       # one bf16 (BH, T, D)
    rows = bh * t * 4                           # one f32 (BH, T)
    work = {"K1": (2, 4 * tile + rows), "K2": (3, 5 * tile + 2 * rows),
            "K3": (4, 6 * tile + 2 * rows)}
    plain = {"K1": plain_fwd, "K2": plain_bwd, "K3": plain_bwd}
    library = {"K1": lib_fwd, "K2": lib_bwd, "K3": lib_bwd}
    rows_out = {}
    for name in ("K1", "K2", "K3"):
        products, n_bytes = work[name]
        flops = products * 2 * pairs * d
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        rows_out[name] = {
            "ms": ms[name], "plain_ms": plain[name],
            "library_ms": library[name], "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err[name]}
        log("flash timing %s %s: kernel %.4f ms, plain %.4f ms, sdpa %.4f "
            "ms, bound %.4f ms (%d flops, %d bytes) -> %.1f%% of bound; "
            "max_abs_err %.3g"
            % (name, label, ms[name], plain[name], library[name], bound,
               flops, n_bytes, 100.0 * bound / ms[name], err[name]))
    log("flash timing: sdpa forward vs K1 max_abs_err %.3g; K2 and K3 share "
        "one plain_ms and one library_ms: the plain backward and the sdpa "
        "backward compute dq, dk and dv together" % lib_err)
    return rows_out


BERT_FLASH = dict(b=32, h=12, t=128, d=64)   # BERT-base's train shape


def flash_bert_shape(fa, dev):
    """K1, K2 and K3 at BERT-base's train shape (B=32, H=12, T=128,
    D=64, non-causal, bf16: one 128-row tile a head, on the wgmma
    kernels): held against their plain versions with the per-tile bf16
    reading, then timed queued behind a sleep beside their bounds, the
    plain versions and non-causal ``scaled_dot_product_attention``.
    Returns each kernel's readings as ``bert_*`` fields."""
    import torch

    b, h, t, d = (BERT_FLASH[k] for k in "bhtd")
    rng = np.random.default_rng(11)
    args = flash_case(rng, dev, b * h, t, t, d, torch.bfloat16)
    res, _, _, parts = flash_compare(fa, args, d ** -0.5, False)
    worst = max(r for r, _ in res.values())
    log("flash check bert    B*H=%d T=%d D=%d non-causal bf16 (reading, "
        "max_abs_err): %s %s; bf16 readings' parts (tile L2, tile max): %s"
        % (b * h, t, d,
           " ".join("%s %.2f %.3g" % (n, r, e) for n, (r, e) in res.items()),
           "ok" if worst <= 1 else "FAIL",
           " ".join("%s %.3f %.3f" % ((n,) + pr) for n, pr in parts.items())))
    if worst > 1:
        fail("flash kernels disagree with their plain versions at BERT's "
             "shape")
    del args
    rows = flash_timing(fa, dev, b, h, t, d, False, timer=queued_ms,
                        label="B=%d H=%d T=%d D=%d non-causal bf16 (BERT, "
                              "queued)" % (b, h, t, d))
    return {name: {"bert_" + k: v for k, v in row.items()}
            for name, row in rows.items()}


# -- phase 4: the serve main path -----------------------------------

def timed_runner(serve, weights, arena, profile_step=True, graphs=True):
    """A TorchRunner that checks every logits row is finite and records
    the wall time of each call (the runner syncs on its numpy logits).
    With ``profile_step`` it profiles one decode step; pass False where
    several runners share the process (one profiler at a time).
    ``graphs`` is the runner's own switch (captured CUDA graphs, or every
    step eager)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Runner(serve.TorchRunner):
        PROFILE_STEP = 20     # a decode step at full batch, mid-run

        def __init__(self):
            super().__init__(weights, arena, graphs=graphs)
            self.times = {"prefill": [], "decode": []}
            self.step_profile = None

        def _timed(self, kind, fn, *args):
            if kind == "decode" and profile_step and \
                    self.step_profile is None and \
                    len(self.times["decode"]) == self.PROFILE_STEP:
                # profiled, and kept out of the step times it lengthens
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fn(*args)
                self.step_profile = (time.perf_counter() - t0,
                                     prof.key_averages(), prof.events())
            else:
                t0 = time.perf_counter()
                out = fn(*args)
                self.times[kind].append(time.perf_counter() - t0)
            if not np.isfinite(out).all():
                fail("non-finite logits from %s" % kind)
            return out

        def prefill(self, *args):
            return self._timed("prefill", super().prefill, *args)

        def decode(self, *args):
            return self._timed("decode", super().decode, *args)

    return Runner()


def kernel_busy_ms(events):
    """The union of the card's kernel intervals in a profile, in ms:
    kernels that overlap (K4's combine, a programmatic dependent launch,
    starts before its attention grid ends) count once, and copies not at
    all."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def step_profile_reading(step_profile, step):
    """Device time by kernel in one profiled decode step: busy ms (the
    union of kernel intervals), summed kernel ms, copy ms, kernel
    launches, K4's attention kernel launches and K4's ms (attention with
    its combine), and the top kernels and copies."""
    if step_profile is None:
        fail("the run had fewer than %d decode steps to profile" % step)
    wall, averages, events = step_profile
    rows = [(e.self_device_time_total, e.count, e.key) for e in averages]
    rows = [r for r in rows if r[0] > 0]
    copies = [r for r in rows if r[2].startswith(("Memcpy", "Memset"))]
    return {"wall_ms": wall * 1e3,
            "busy_ms": kernel_busy_ms(events),
            "summed_ms": sum(r[0] for r in rows if r not in copies) / 1e3,
            "copy_ms": sum(r[0] for r in copies) / 1e3,
            "kernels": sum(r[1] for r in rows if r not in copies),
            "k4_attention": sum(r[1] for r in rows
                                if "paged_attention_kernel" in r[2]),
            "k4_ms": sum(r[0] for r in rows if "paged_attention" in r[2]
                         or "paged_combine" in r[2]) / 1e3,
            "top": sorted(rows, reverse=True)[:6]}


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def warm_prompts(g, rng):
    """Two prompts per prefill bucket, so that a graphed runner has
    captured every step it serves before the timed requests."""
    lo = 0
    out = []
    for b in g.prefill_buckets:
        out += [rng.integers(0, g.vocab_size, size=(lo + b) // 2 + 1)
                .tolist() for _ in range(2)]
        lo = b
    return out


def serve_run(serve, pa, weights, arena, g, graphs, prompts, new):
    """The 12 requests through a server over ``arena`` (reset first),
    after two warm-up requests per prefill bucket; K4's counts are set to
    0 before the warm-up and read after the requests."""
    import torch

    arena.reset()
    runner = timed_runner(serve, weights, arena, graphs=graphs)
    srv = serve.LlamaServer.from_parts(runner, arena)
    pa.paged_attention.launches = 0
    pa.paged_attention.combine_launches = 0
    srv.start()
    t0 = time.perf_counter()
    for p in warm_prompts(g, np.random.default_rng(3)):
        srv.generate(p, max_new_tokens=2, timeout=600)
    warm_s = time.perf_counter() - t0
    runner.times = {"prefill": [], "decode": []}
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    outs = [r.result(timeout=900) for r in reqs]
    wall = time.perf_counter() - t0
    srv.stop()
    launches = pa.paged_attention.launches
    combines = pa.paged_attention.combine_launches
    steps = srv.stats()["decode_steps"]
    arena.assert_quiescent()
    if any(r.error is not None for r in reqs) or \
            any(len(o) != new for o in outs):
        fail("a request did not complete: %s"
             % [str(r.error) for r in reqs if r.error is not None])
    if launches < g.num_layers * steps or steps == 0:
        fail("paged-attention kernel launched %d times over %d decode "
             "steps of %d layers" % (launches, steps, g.num_layers))
    prof = step_profile_reading(runner.step_profile, runner.PROFILE_STEP)
    dec = runner.times["decode"]
    res = {"graphs": graphs, "outs": outs, "launches": launches,
           "combines": combines, "steps": steps, "wall_s": wall,
           "warm_s": warm_s, "tokens_s": sum(map(len, outs)) / wall,
           "ttft": p50([r.ttft for r in reqs]),
           "ttft_max": max(r.ttft for r in reqs),
           "prefill": p50(runner.times["prefill"]), "decode": p50(dec),
           "decode_min": min(dec), "decode_max": max(dec), "prof": prof,
           "graph": runner.graph_stats(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["idle"] = 1 - prof["busy_ms"] / (1e3 * res["decode"])
    del srv, runner
    return res


def log_serve_run(r, g):
    mode = "graphs on" if r["graphs"] else "graphs off"
    prof = r["prof"]
    log("serve [%s]: %d decode steps (warm-up included), %d K4 launches "
        "(%d layers x steps = %d), %d with a combine; warm-up %.2f s"
        % (mode, r["steps"], r["launches"], g.num_layers,
           g.num_layers * r["steps"], r["combines"], r["warm_s"]))
    log("serve [%s]: decode ms/step p50 %.3f (min %.3f max %.3f), TTFT p50 "
        "%.4f s (max %.4f s), prefill call p50 %.4f s, %.1f tokens/s over "
        "%.2f s wall, peak device memory %.2f GB"
        % (mode, 1e3 * r["decode"], 1e3 * r["decode_min"],
           1e3 * r["decode_max"], r["ttft"], r["ttft_max"], r["prefill"],
           r["tokens_s"], r["wall_s"], r["peak_gb"]))
    log("serve [%s]: decode step profiled: wall %.3f ms (profiler on), "
        "kernels busy %.3f ms (union; summed %.3f ms), copies %.3f ms, "
        "idle %.1f%% of the p50 step, %d kernel launches, K4 attention "
        "kernel x%d, K4 with its combine %.3f ms (summed)"
        % (mode, prof["wall_ms"], prof["busy_ms"], prof["summed_ms"],
           prof["copy_ms"], 100 * r["idle"], prof["kernels"],
           prof["k4_attention"], prof["k4_ms"]))
    for us, count, key in prof["top"]:
        log("serve [%s]:   %8.3f ms  x%-4d %s"
            % (mode, us / 1e3, count, key[:90]))
    st = r["graph"]
    if r["graphs"]:
        log("serve [graphs on]: %d graphs, %d captures in %.3f s, %d replays "
            "at %.1f us host time each outside the replay, graph pool "
            "%.1f MB" % (st["graphs"], st["captures"], st["capture_s"],
                         st["replays"],
                         1e6 * st["host_s"] / max(st["replays"], 1),
                         st["pool_bytes"] / 1e6))


def serve_main_path(serve, pa, dev):
    """The 12 requests at full Llama-3-8B size, first with every step
    eager, then with each step signature a captured CUDA graph; greedy
    tokens must be identical.  Returns K4's launches over both runs."""
    import torch

    g = serve.KVGeometry(page_size=16, num_pages=2049, max_batch=8,
                         max_pages_per_seq=256,
                         prefill_buckets=(128, 512, 2048),
                         dtype="bfloat16", paged_kernel="auto", **LLAMA3_8B)
    t0 = time.perf_counter()
    weights = serve.init_weights(g, seed=0, std=0.02, device=dev)
    arena = serve.PagedKVArena(g, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [weights[0], weights[2]]
                   + [w for lw in weights[1] for w in lw.values()]
                   + ([] if weights[3] is None else [weights[3]]))
    log("serve: Llama-3-8B geometry, %d layers, %.2f G params bf16, "
        "KV arena %.2f GB (%s), set-up %.1f s"
        % (g.num_layers, n_params / 1e9,
           sum(t.numel() * t.element_size() for t in arena.buffers()) / 1e9,
           g.describe(), time.perf_counter() - t0))
    rng = np.random.default_rng(7)
    n_req, new = 12, 32
    lens = [32, 1500] + rng.integers(32, 1501, size=n_req - 2).tolist()
    prompts = [rng.integers(0, g.vocab_size, size=n).tolist() for n in lens]
    log("serve: %d requests, prompts %d..%d tokens, %d new each; n_split %d "
        "at the decode shape" % (n_req, min(lens), max(lens), new,
                                 pa.n_split(g.max_batch, 1, g.num_heads,
                                            g.num_kv_heads, g.page_size,
                                            g.max_pages_per_seq,
                                            pa.sm_count(dev.index))))
    # the profiler's first use sets up its tracer (seconds on the
    # card); take it here, outside both timed runs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize()
    runs = []
    for graphs in (False, True):
        runs.append(serve_run(serve, pa, weights, arena, g, graphs, prompts,
                              new))
        log_serve_run(runs[-1], g)
    off, on = runs
    same = sum(a == b for a, b in zip(off["outs"], on["outs"]))
    log("serve: greedy tokens equal with graphs on and off in %d of %d "
        "requests; graphs on / off: decode ms/step p50 %.3f / %.3f, TTFT "
        "p50 %.4f / %.4f s, %.1f / %.1f tokens/s, idle %.1f%% / %.1f%%"
        % (same, n_req, 1e3 * on["decode"], 1e3 * off["decode"], on["ttft"],
           off["ttft"], on["tokens_s"], off["tokens_s"], 100 * on["idle"],
           100 * off["idle"]))
    if same != n_req:
        fail("greedy tokens differ between graphed and eager serving")
    if on["prof"]["k4_attention"] < g.num_layers:
        fail("the profiled graphed decode step ran K4's attention kernel %d "
             "times, fewer than its %d layers"
             % (on["prof"]["k4_attention"], g.num_layers))
    if on["graph"]["captures"] == 0 or on["graph"]["replays"] == 0:
        fail("the graphed runner captured %d and replayed %d graphs"
             % (on["graph"]["captures"], on["graph"]["replays"]))
    del weights, arena
    return off["launches"] + on["launches"]


# -- phase 5: f32 parity and the bundle round trip ------------------------

def recompute_greedy(serve, g, weights, prompt, n, dev):
    """Greedy by recompute: the port's prefill over prompt + tokens so
    far, one full pass per generated token, on a scratch arena."""
    import torch

    arena = serve.PagedKVArena(g, device=dev)
    fns = {b: serve.build_prefill_fn(weights, g, b)
           for b in g.prefill_buckets}
    seq = list(prompt)
    for _ in range(n):
        bucket = min(b for b in g.prefill_buckets if b >= len(seq))
        pages = arena.alloc(arena.pages_needed(bucket), "recompute")
        tokens = torch.zeros(bucket, dtype=torch.int32)
        tokens[:len(seq)] = torch.tensor(seq, dtype=torch.int32)
        row = torch.from_numpy(arena.block_row(pages)).to(dev)
        with torch.no_grad():
            logits = fns[bucket](*arena.buffers(), tokens.to(dev),
                                 len(seq), row)[-1]
        seq.append(int(logits.argmax().item()))
        arena.free(pages, "recompute")
    return seq[len(prompt):]


def parity(serve, dev):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(LLAMA3_8B, num_layers=2)
    g = serve.KVGeometry(page_size=16, num_pages=257, max_batch=4,
                         max_pages_per_seq=64, prefill_buckets=(128, 512),
                         dtype="float32", paged_kernel="auto", **cfg)
    weights = serve.init_weights(g, seed=1, std=0.02, device=dev)
    arena = serve.PagedKVArena(g, device=dev)
    srv = serve.LlamaServer.from_parts(serve.TorchRunner(weights, arena),
                                       arena)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, g.vocab_size, size=n).tolist()
               for n in (5, 60, 300)]
    n = 8
    with srv:
        reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
        paged = [r.result(timeout=600) for r in reqs]
    arena.assert_quiescent()
    for p, got in zip(prompts, paged):
        want = recompute_greedy(serve, g, weights, p, n, dev)
        log("parity: prompt %d tokens: paged %s recompute %s"
            % (len(p), got, want))
        if got != want:
            fail("f32 paged greedy differs from greedy by recompute")
    del srv, weights, arena

    # port bundle round trip at a small geometry
    small = serve.KVGeometry(num_layers=2, num_heads=4, num_kv_heads=2,
                             head_dim=16, units=64, hidden_size=128,
                             vocab_size=512, page_size=8, num_pages=64,
                             max_pages_per_seq=8, max_batch=4,
                             prefill_buckets=(16, 32))
    w = serve.init_weights(small, seed=2, std=0.5, device=dev)
    raw = (w[0].cpu().numpy(),
           [{k: v.cpu().numpy() for k, v in lw.items()} for lw in w[1]],
           w[2].cpu().numpy(), None if w[3] is None else w[3].cpu().numpy())
    arena = serve.PagedKVArena(small, device=dev)
    with serve.LlamaServer.from_parts(serve.TorchRunner(w, arena),
                                      arena) as srv:
        want = srv.generate([3, 1, 4, 1, 5], max_new_tokens=8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, "small.npz")
        serve.save_serving_bundle(path, raw, small)
        with serve.LlamaServer(path) as srv2:
            got = srv2.generate([3, 1, 4, 1, 5], max_new_tokens=8)
            if srv2.arena.device.type != "cuda":
                fail("LlamaServer(path) did not default to the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("parity: bundle round trip tokens %s (direct %s)" % (got, want))
    if got != want:
        fail("bundle round trip served different tokens")


# -- phase 6: the fleet tier ----------------------------------------------

FLEET_REQUESTS = 16


def counter_sum(snap, family, **match):
    """The sum of a snapshot family's series whose labels include
    ``match``."""
    return sum(s.get("value", 0)
               for s in snap.get(family, {}).get("series", [])
               if all(s["labels"].get(k) == v for k, v in match.items()))


def http_json(url, doc=None, timeout=300):
    """GET ``url`` (or POST ``doc`` as JSON) and decode the JSON answer;
    an answer that is not JSON comes back as text."""
    import urllib.request

    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read().decode()
    try:
        return json.loads(body)
    except ValueError:
        return body


def stop_fleet(router, servers):
    """Router first (a stopped replica is never waited on), then each
    replica drained and stopped, its arena quiescent."""
    router.stop()
    for srv in servers:
        srv.drain(timeout=300)
        srv.stop()
        srv.arena.assert_quiescent()


def fleet_results(futs, timeout=900):
    """Wait on every fleet future from a thread of its own, so each
    resolves (and stamps its router time) as soon as its replica is
    done; returns the token lists, failing on any error."""
    import threading

    outs, errs = [None] * len(futs), []

    def wait(i):
        try:
            outs[i] = futs[i].result(timeout=timeout)
        except Exception as e:  # noqa: BLE001 — reported below, fatal
            errs.append("%s: %s" % (type(e).__name__, e))

    threads = [threading.Thread(target=wait, args=(i,), daemon=True)
               for i in range(len(futs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 60)
    if errs or any(t.is_alive() for t in threads):
        fail("fleet requests failed: %s" % (errs or "a waiter hung"))
    return outs


def router_overhead(router, fut):
    """The router's wall time for one request minus its replica's own
    (submit to finish, on the same monotonic clock)."""
    tr = router.trace(fut.trace_id)
    if tr is None or tr.get("replica_trace") is None:
        fail("no fleet trace for %s" % fut.trace_id)
    ev = {e["event"]: e["t"] for e in tr["replica_trace"]["events"]}
    return tr["fleet"]["total_s"] - (ev["finish"] - ev["submit"])


def fleet_full_width(serve, pa, dev):
    """Two Llama-3-8B replicas (bf16, the serve phase's geometry), each
    with its own weights and arena, behind a FleetRouter with its
    prober running: 16 greedy requests at once, then the fleet's HTTP
    front.  Both serve loops launch on the default stream, so their
    steps serialise on the card: a replica's decode ms/step is not one
    replica's alone."""
    import torch
    from mxnet_tpu_torch import telemetry

    torch.cuda.synchronize()
    log("fleet: %.2f GB allocated before the replicas"
        % (torch.cuda.memory_allocated() / 1e9))
    torch.cuda.reset_peak_memory_stats()
    g = serve.KVGeometry(page_size=16, num_pages=2049, max_batch=8,
                         max_pages_per_seq=256,
                         prefill_buckets=(128, 512, 2048),
                         dtype="bfloat16", paged_kernel="auto", **LLAMA3_8B)
    t0 = time.perf_counter()
    servers, runners = [], []
    for _ in range(2):
        weights = serve.init_weights(g, seed=0, std=0.02, device=dev)
        arena = serve.PagedKVArena(g, device=dev)
        runners.append(timed_runner(serve, weights, arena,
                                    profile_step=False))
        servers.append(serve.LlamaServer.from_parts(runners[-1], arena))
    del weights, arena
    for srv in servers:            # both loops up before the first submit
        srv.start()
    for srv in servers:            # and each warm before they meet
        srv.generate([1, 2, 3], max_new_tokens=2, timeout=600)
    torch.cuda.synchronize()
    log("fleet: 2 replicas of Llama-3-8B (%s), set-up and warm-up %.1f s, "
        "%.2f GB allocated" % (g.describe(), time.perf_counter() - t0,
                               torch.cuda.memory_allocated() / 1e9))
    router = serve.FleetRouter([serve.LocalReplica(s, name="r%d" % i)
                                for i, s in enumerate(servers)]).start()
    ok0 = counter_sum(telemetry.snapshot(), "mxnet_fleet_requests_total",
                      status="ok")
    rng = np.random.default_rng(7)
    new = 32
    lens = [32, 1500] + rng.integers(32, 1501,
                                     size=FLEET_REQUESTS - 2).tolist()
    prompts = [rng.integers(0, g.vocab_size, size=n).tolist() for n in lens]
    t0 = time.perf_counter()
    futs = [router.submit(p, max_new_tokens=new, timeout=900)
            for p in prompts]
    outs = fleet_results(futs)
    wall = time.perf_counter() - t0
    if any(len(o) != new for o in outs):
        fail("a fleet request did not return %d tokens" % new)
    served = {f.replica for f in futs}
    if served != {"r0", "r1"}:
        fail("the router used only replicas %s" % sorted(served))
    router.probe_all(metrics=True)
    ok = counter_sum(router.fleet_metrics_snapshot(),
                     "mxnet_fleet_requests_total", status="ok") - ok0
    if ok != FLEET_REQUESTS:
        fail("mxnet_fleet_requests_total counts %d ok requests, not %d"
             % (ok, FLEET_REQUESTS))
    steps = sum(s.stats()["decode_steps"] for s in servers)
    launches = pa.paged_attention.launches
    if launches < g.num_layers * steps or steps == 0:
        fail("paged-attention kernel launched %d times over %d decode "
             "steps of %d layers on the two replicas"
             % (launches, steps, g.num_layers))
    over = sorted(router_overhead(router, f) for f in futs)
    ttft = sorted(f.ttft for f in futs)
    per = ["%s %d requests, %d decode steps, decode ms/step p50 %.3f"
           % ("r%d" % i, sum(f.replica == "r%d" % i for f in futs),
              srv.stats()["decode_steps"],
              1e3 * sorted(r.times["decode"])[len(r.times["decode"]) // 2])
           for i, (srv, r) in enumerate(zip(servers, runners))]
    log("fleet: %d/%d requests done on 2 replicas, prompts %d..%d tokens, "
        "%d new each; %s; %d K4 launches (%d layers x %d steps = %d)"
        % (len(outs), FLEET_REQUESTS, min(lens), max(lens), new,
           "; ".join(per), launches, g.num_layers, steps,
           g.num_layers * steps))
    log("fleet: %.1f tokens/s over %.2f s wall, TTFT p50 %.4f s (max "
        "%.4f s), router overhead per request p50 %.3f ms (min %.3f max "
        "%.3f), peak device memory %.2f GB (decode ms/step counts both "
        "replicas' steps: they share the card's default stream)"
        % (sum(map(len, outs)) / wall, wall, ttft[len(ttft) // 2], ttft[-1],
           1e3 * over[len(over) // 2], 1e3 * over[0], 1e3 * over[-1],
           torch.cuda.max_memory_allocated() / 1e9))

    # the fleet's HTTP front at full width
    host, port = router.serve_http(port=0)
    base = "http://%s:%d" % (host, port)
    out = http_json(base + "/v1/generate",
                    {"prompt": prompts[0], "max_new_tokens": 8})
    if len(out.get("tokens", ())) != 8 or not out.get("trace_id"):
        fail("fleet POST /v1/generate answered %s" % out)
    hz = http_json(base + "/healthz")
    if sorted(hz["replicas"]) != ["r0", "r1"] or hz["replicas_healthy"] != 2:
        fail("fleet /healthz shows %s" % hz["replicas"])
    router.probe_all(metrics=True)
    text = http_json(base + "/metrics")
    if 'replica="r0"' not in text or 'replica="r1"' not in text:
        fail("fleet /metrics carries no series of both replicas")
    tr = http_json(base + "/v1/trace/" + out["trace_id"])
    keys = list(tr)
    if tr["fleet"]["status"] != "ok" or \
            tr["replica_trace"]["trace_id"] != out["trace_id"] or \
            tr["replica_trace"]["status"] != "completed" or \
            keys.index("fleet") > keys.index("replica_trace"):
        fail("fleet /v1/trace is not the routing breakdown ahead of the "
             "replica's trace: %s" % json.dumps(tr)[:400])
    log("fleet: HTTP front on %s: generate (replica %s, %d attempt(s)), "
        "healthz, metrics and trace %s checked"
        % (base, out["replica"], len(tr["fleet"]["attempts"]),
           out["trace_id"]))

    # the same requests through one replica alone, for its figures
    router.stop()
    mark = len(runners[0].times["decode"])
    t0 = time.perf_counter()
    reqs = [servers[0].submit(p, max_new_tokens=new) for p in prompts]
    alone = [r.result(timeout=900) for r in reqs]
    wall1 = time.perf_counter() - t0
    dec = sorted(runners[0].times["decode"][mark:])
    ttft1 = sorted(r.ttft for r in reqs)
    log("fleet: one replica alone, the same %d requests: %.1f tokens/s over "
        "%.2f s wall, TTFT p50 %.4f s (max %.4f s), decode ms/step p50 %.3f "
        "over %d steps; %d of %d token lists equal the fleet's"
        % (len(reqs), sum(map(len, alone)) / wall1, wall1,
           ttft1[len(ttft1) // 2], ttft1[-1], 1e3 * dec[len(dec) // 2],
           len(dec), sum(a == b for a, b in zip(alone, outs)), len(outs)))
    log("fleet: fleet / alone tokens/s %.2f"
        % (sum(map(len, outs)) / wall / (sum(map(len, alone)) / wall1)))
    for i, r in enumerate(runners):
        st = r.graph_stats()
        log("fleet: r%d %d graphs, %d captures in %.3f s, %d replays, graph "
            "pool %.1f MB" % (i, st["graphs"], st["captures"],
                              st["capture_s"], st["replays"],
                              st["pool_bytes"] / 1e6))
        if st["captures"] == 0 or st["replays"] == 0:
            fail("fleet replica r%d captured %d and replayed %d graphs"
                 % (i, st["captures"], st["replays"]))
    stop_fleet(router, servers)
    return launches


def fleet_small(serve, dev):
    """At the parity phase's geometry (2 layers at full width, f32, TF32
    off): greedy tokens through a 2-replica router equal one server's,
    a replica killed on its forward path is survived by a retry, the
    command line's fleet serves and drains on SIGTERM, and a rolling
    deploy of a port bundle drops nothing while a backlog waits on both
    replicas."""
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.testing import faults

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = serve.KVGeometry(page_size=16, num_pages=257, max_batch=4,
                         max_pages_per_seq=64, prefill_buckets=(128, 512),
                         dtype="float32", paged_kernel="auto",
                         **dict(LLAMA3_8B, num_layers=2))
    weights = serve.init_weights(g, seed=1, std=0.02, device=dev)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, g.vocab_size, size=n).tolist()
               for n in (5, 60, 300)]
    n = 8

    def server():
        arena = serve.PagedKVArena(g, device=dev)
        return serve.LlamaServer.from_parts(
            serve.TorchRunner(weights, arena), arena)

    with server() as srv:
        reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
        want = [r.result(timeout=600) for r in reqs]
    srv.arena.assert_quiescent()
    servers = [server().start() for _ in range(2)]
    router = serve.FleetRouter([serve.LocalReplica(s, name="r%d" % i)
                                for i, s in enumerate(servers)]).start()
    got = fleet_results([router.submit(p, max_new_tokens=n, timeout=600)
                         for p in prompts])
    log("fleet parity: 2 replicas %s, one server %s" % (got, want))
    if got != want:
        fail("f32 greedy through the router differs from one server's")

    retries0 = counter_sum(telemetry.snapshot(), "mxnet_fleet_retries_total")
    plan = faults.install(faults.FaultPlan(seed=0, rules=[
        {"site": "replica_kill", "action": "kill_loop",
         "match": {"replica": "r0"}, "times": 1}]))
    try:
        done = 0
        for i in range(12):       # sequential: r0 is picked within a few
            p = prompts[i % len(prompts)]
            if router.generate(p, max_new_tokens=n, timeout=600) \
                    != want[i % len(prompts)]:
                fail("a request under replica_kill returned other tokens")
            done += 1
            if plan.events and done >= 4:
                break
    finally:
        faults.uninstall()
    retries = counter_sum(telemetry.snapshot(),
                          "mxnet_fleet_retries_total") - retries0
    log("fleet chaos: replica_kill on r0 fired %d time(s); %d/%d greedy "
        "requests completed with the same tokens; %d retries; r0 healthy "
        "%s" % (len(plan.events), done, done, retries,
                servers[0].healthy()))
    if not plan.events or retries <= 0:
        fail("replica_kill never fired or no request was retried")
    stop_fleet(router, servers)
    del servers, router, weights

    # the command line and a rolling deploy, over a port bundle
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        fleet_deploy_and_cli(serve, dev, g, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_bundle(serve, g, weights, path):
    """Write ``weights`` (on the card) as a port bundle at geometry
    ``g``; returns the seconds it took."""
    t0 = time.perf_counter()
    raw = (weights[0].cpu().numpy(),
           [{k: v.cpu().numpy() for k, v in lw.items()}
            for lw in weights[1]],
           weights[2].cpu().numpy(),
           None if weights[3] is None else weights[3].cpu().numpy())
    serve.save_serving_bundle(path, raw, g)
    return time.perf_counter() - t0


def fleet_cli(path, prompt, n, want):
    """``python -m mxnet_tpu_torch.serve --bundle path --fleet 2``: its
    banner, one POST answered with ``want``, exit 0 within the drain
    timeout after SIGTERM, and no kernel library rebuilt.  Returns the
    seconds from start to banner."""
    import threading

    before = sorted(os.listdir(os.path.join(REPO, "build")))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "mxnet_tpu_torch.serve",
         "--bundle", path, "--fleet", "2", "--port", "0",
         "--drain-timeout", "30"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        banner = []
        reader = threading.Thread(
            target=lambda: banner.append(proc.stdout.readline()),
            daemon=True)
        t0 = time.perf_counter()
        reader.start()
        reader.join(300)
        if not banner or "serving fleet n=2" not in banner[0]:
            fail("the CLI printed no fleet banner: %r" % banner)
        url = banner[0].split(" on ")[1].split()[0]
        t_up = time.perf_counter() - t0
        out = http_json(url + "/v1/generate",
                        {"prompt": prompt, "max_new_tokens": n})
        if out.get("tokens") != want:
            fail("the CLI's fleet served %s, not %s"
                 % (out.get("tokens"), want))
        proc.send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        rc = proc.wait(timeout=90)
        t_down = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log("fleet cli: %s up in %.1f s, served %d tokens equal to one "
        "server's, exit %d %.1f s after SIGTERM"
        % (banner[0].split("  [")[0].strip(), t_up, len(out["tokens"]), rc,
           t_down))
    if rc != 0 or t_down > 30:
        fail("the CLI exited %d %.1f s after SIGTERM (drain timeout "
             "30 s)" % (rc, t_down))
    if sorted(os.listdir(os.path.join(REPO, "build"))) != before:
        fail("the CLI rebuilt kernel libraries in build/")
    return t_up


def fleet_deploy_and_cli(serve, dev, g, tmp):
    """Weights A and B at geometry ``g`` (seeds 2 and 3), B saved as a
    port bundle.  The command line's fleet over B, drained by SIGTERM;
    its start-up (two loads of B) times one load.  Then two replicas on
    A take a backlog through the router, sized from that load time and
    one replica's request rate so that it outlasts both reloads, and
    ``rolling_deploy`` swaps B in: nothing is dropped, both replicas
    report one ``bundle_sha``, and queued requests on each replica cross
    its swap onto B's weights."""
    import torch

    n = 32
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, g.vocab_size, size=int(k)).tolist()
               for k in rng.integers(4, 64, size=8)]
    weights = [serve.init_weights(g, seed=seed, std=0.02, device=dev)
               for seed in (2, 3)]

    def server(w, queue_depth=None):
        arena = serve.PagedKVArena(g, device=dev)
        return serve.LlamaServer.from_parts(
            serve.TorchRunner(w, arena), arena, queue_depth=queue_depth)

    want, rates = [], []
    for w in weights:
        with server(w) as srv:
            t0 = time.perf_counter()
            reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
            want.append([r.result(timeout=600) for r in reqs])
            rates.append(len(prompts) / (time.perf_counter() - t0))
        srv.arena.assert_quiescent()
    if any(a == b for a, b in zip(*want)):
        fail("weights A and B give some prompt the same greedy tokens")
    path = os.path.join(tmp, "fleet_b.npz")
    free = shutil.disk_usage(tmp).free
    t_save = save_bundle(serve, g, weights.pop(), path)
    torch.cuda.empty_cache()
    log("fleet deploy: bundle B (%s) of %.2f GB saved in %.1f s (%.1f GB "
        "free in %s before)" % (g.dtype, os.path.getsize(path) / 1e9,
                                t_save, free / 1e9, tmp))
    t_up = fleet_cli(path, prompts[0], n, want[1][0])

    # each replica's backlog outlasts the first replica's reload and the
    # second's load (one load is under t_up / 2), with the time the first
    # replica serves before its reload starts on top: sized to t_up / 2
    # + 5 s the second replica's crossing shrank from 127 to 8 requests
    # over four H100 runs, and one run drained it before its swap
    per = int(min(1500, max(16, math.ceil(max(rates) * (t_up + 5)))))
    servers = [server(weights[0], queue_depth=2 * per + 16).start()
               for _ in range(2)]
    router = serve.FleetRouter([serve.LocalReplica(s, name="r%d" % i)
                                for i, s in enumerate(servers)]).start()
    backlog = [i % len(prompts) for i in range(2 * per)]
    t0 = time.perf_counter()
    futs = [router.submit(prompts[i], max_new_tokens=n, timeout=900)
            for i in backlog]
    report = router.rolling_deploy(path, timeout=600)
    t_deploy = time.perf_counter() - t0
    outs = [f.result(timeout=900) for f in futs]
    t_all = time.perf_counter() - t0
    shas = {st["bundle_sha"] for st in router.healthz()["replicas"]
            .values()}
    after = router.generate(prompts[0], max_new_tokens=n, timeout=600)
    served = {}
    for f, i, o in zip(futs, backlog, outs):
        kind = "A" if o == want[0][i] else "B" if o == want[1][i] \
            else "other"
        served.setdefault(f.replica, {}).setdefault(kind, 0)
        served[f.replica][kind] += 1
    log("fleet deploy: %s requests/s per replica alone; a backlog of %d "
        "requests (%d new tokens each) through the router; rolling_deploy "
        "returned in %.1f s, the backlog done in %.1f s: converged %s, "
        "dropped %d, bundle_sha %s; served per replica on weights A/B %s"
        % (["%.1f" % r for r in rates], len(futs), n, t_deploy, t_all,
           report["converged"], report["dropped"], sorted(shas),
           json.dumps(served, sort_keys=True)))
    if not report["converged"] or report["dropped"] or len(shas) != 1 \
            or None in shas:
        fail("rolling deploy did not converge with nothing dropped")
    if any("other" in v for v in served.values()) or after != want[1][0]:
        fail("a request during or after the deploy served other tokens")
    if sorted(served) != ["r0", "r1"] or \
            any(not v.get("B") for v in served.values()):
        fail("no queued request crossed a replica's swap onto the new "
             "weights on both replicas: %s" % served)
    stop_fleet(router, servers)


def fleet_phase(serve, pa, dev):
    """The two-replica fleet at full width is this phase's main path:
    K4's count is read right after it, before the check runs at the
    parity geometry."""
    pa.paged_attention.launches = 0
    pa.paged_attention.combine_launches = 0
    launches = fleet_full_width(serve, pa, dev)
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    fleet_small(serve, dev)
    return launches


# -- phase 7: the train main path -----------------------------------------

def lm_wrapper(gluon, vocab):
    """The JAX bench's LM wrapper: logits flattened to (B*T, V)."""
    class LM(gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, toks):
            return self.inner(toks).reshape(-1, vocab)

    return LM


def log_train_profile(events, wall):
    rows = [(e.self_device_time_total, e.count, e.key) for e in events]
    rows = [r for r in rows if r[0] > 0]
    busy_us = sum(r[0] for r in rows)
    flash_us = sum(r[0] for r in rows if "flash_" in r[2])
    log("train: profiled step: wall %.3f ms, device busy %.3f ms (%.1f%%), "
        "%d kernel launches, flash kernels %.3f ms (%.1f%% of busy)"
        % (wall * 1e3, busy_us / 1e3, 100 * busy_us / 1e3 / (wall * 1e3),
           sum(r[1] for r in rows), flash_us / 1e3,
           100 * flash_us / max(busy_us, 1e-9)))
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log("train:   %9.3f ms  x%-5d %s" % (us / 1e3, count, key[:90]))
    log("train: the update's own kernels (O1, O3) %.3f ms"
        % update_kernel_ms(events))
    return busy_us / 1e3


def profiled_step(fn):
    """Wall ms and the kernels' busy ms (union of intervals) of one
    profiled call of ``fn``, with the profiler's key averages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, kernel_busy_ms(prof.events()), prof.key_averages()


def timed_steps(fn, n_warm, n_timed):
    """Wall seconds of ``n_timed`` synchronised calls after ``n_warm``,
    and every call's result."""
    import torch

    times, outs = [], []
    for i in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        if i >= n_warm:
            times.append(time.perf_counter() - t0)
    return sorted(times), outs


def train_main_path(fa, dev):
    """Llama-3-8B width, 8 layers, bf16, adamw through ``JitTrainStep``:
    every step eager (``graphs=False``), then the same step object with
    its step a captured CUDA graph (the default)."""
    import torch

    from mxnet_tpu_torch import gluon, initializer, parallel
    from mxnet_tpu_torch.gluon.model_zoo import llama

    start_profiler(dev)
    cfg = dict(LLAMA3_8B, num_layers=TRAIN_LAYERS)
    vocab = cfg.pop("vocab_size")
    cfg.pop("head_dim")
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = llama.LlamaModel(vocab, device=dev, **cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    net.initialize(initializer.Xavier(), generator=gen)
    net.cast("bfloat16")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    matmul_params = sum(p.numel() for n, p in net.named_parameters()
                        if p.dim() == 2 and n != "embed.weight")
    tokens = TRAIN_B * TRAIN_T
    # forward + backward = 3 x the forward's two products over the
    # unmasked (row, col) pairs of every head
    attn_flops = 3 * TRAIN_LAYERS * 4 * (TRAIN_T * (TRAIN_T + 1) // 2) \
        * cfg["units"] * TRAIN_B
    step_flops = 6 * matmul_params * tokens + attn_flops
    log("train: Llama-3-8B width, %d layers, %.3f G params bf16 (%.3f G in "
        "matmuls), B=%d T=%d, set-up %.1f s"
        % (TRAIN_LAYERS, n_params / 1e9, matmul_params / 1e9, TRAIN_B,
           TRAIN_T, time.perf_counter() - t0))
    step = parallel.JitTrainStep(lm_wrapper(gluon, vocab)(net),
                                 gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw", {"learning_rate": 1e-4},
                                 graphs=False)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, vocab, (TRAIN_B, TRAIN_T)).astype(np.int32)
    labels = rng.randint(0, vocab, TRAIN_B * TRAIN_T).astype(np.float32)
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    for name in ("fwd_launches", "dq_launches", "dkv_launches"):
        setattr(fa.flash_attention, name, 0)
    reset_opt_counts(oo)
    losses, rows = [], {}
    n_warm, n_timed = 2, 8
    for mode in ("eager", "graphed"):
        step.graphs = mode == "graphed"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(lambda: step.step(toks, labels), n_warm,
                                  n_timed)
        losses += [x.item() for x in outs]
        out, wall, busy, averages = profiled_step(
            lambda: step.step(toks, labels))
        losses.append(out.item())
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated(), step.stats())
    steps = len(losses)
    # clip_global_norm 1.0 on the same step: a new graph whose update
    # takes its norm from O3 (one eager step, then captured)
    step._clip_global_norm = 1.0
    clip_times, clip_outs = timed_steps(lambda: step.step(toks, labels), 1,
                                        3)
    clip_losses = [x.item() for x in clip_outs]
    launches = {name: getattr(fa.flash_attention, name)
                for name in ("fwd_launches", "dq_launches", "dkv_launches")}
    launches.update(opt_counts(oo))
    log("train: with clip_global_norm 1.0, graphed: losses %s, step ms p50 "
        "%.3f; optimizer launches over the %d steps: %s"
        % (["%.4f" % x for x in clip_losses],
           1e3 * clip_times[len(clip_times) // 2], steps + len(clip_losses),
           {k: launches[k] for k in ("O1", "O2", "O3")}))
    if not all(math.isfinite(x) for x in clip_losses):
        fail("a clipped train loss is not finite")
    if launches["O1"] < steps + len(clip_losses) or launches["O3"] < 1:
        fail("the train steps launched O1 %d and O3 %d times"
             % (launches["O1"], launches["O3"]))
    log("train: losses %s" % ["%.4f" % x for x in losses])
    if not all(math.isfinite(x) for x in losses):
        fail("a train loss is not finite")
    if not losses[-1] < losses[0]:
        fail("the loss did not fall on the fixed batch")
    flash = {n: launches[n] for n in ("fwd_launches", "dq_launches",
                                      "dkv_launches")}
    for name, n in flash.items():
        if n < TRAIN_LAYERS * steps:
            fail("flash %s = %d over %d steps of %d layers"
                 % (name, n, steps, TRAIN_LAYERS))
    log("train: %d steps (%d eager, %d graphed), flash launches %s (%d "
        "layers x steps = %d)" % (steps, steps // 2, steps // 2, flash,
                                  TRAIN_LAYERS, TRAIN_LAYERS * steps))
    st = rows["graphed"][5]
    if st["captures"] != 1 or st["replays"] != n_warm + n_timed:
        fail("the graphed train step did not capture once and replay "
             "(%s)" % st)
    for mode, (times, wall, busy, averages, peak, st) in rows.items():
        p50 = times[len(times) // 2]
        log("train: %s step ms p50 %.3f (min %.3f max %.3f over %d timed "
            "steps), %.1f tokens/s, %.1f%% MFU (%.4g model FLOP a step at "
            "989 TFLOP/s bf16), peak device memory %.2f GB (%.2f GB held "
            "before the phase)"
            % (mode, 1e3 * p50, 1e3 * times[0], 1e3 * times[-1],
               len(times), tokens / p50, 100 * step_flops / p50 / BF16_FLOPS,
               step_flops, peak / 1e9, held / 1e9))
        log("train: %s profiled step: wall %.3f ms, kernels busy %.3f ms "
            "(union of intervals), idle %.1f%%"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3))))
        if mode == "graphed":
            log("train: graphed: %d capture in %.3f s, %d replays, %.1f us "
                "host time a replay outside it, graph pool %.1f MB"
                % (st["captures"], st["capture_s"], st["replays"],
                   1e6 * st["host_s"] / max(st["replays"], 1),
                   st["pool_bytes"] / 1e6))
        log_train_profile(averages, wall)
    e50, g50 = (rows[m][0][n_timed // 2] for m in ("eager", "graphed"))
    log("train: graphed / eager step p50 %.3f / %.3f ms (%.3fx)"
        % (1e3 * g50, 1e3 * e50, e50 / g50))
    del step, net
    return launches


def train_graph_check(dev):
    """Full width, 2 layers, vocab 2048, f32 with TF32 off, B=1 T=256:
    ``JitTrainStep`` graphed against eager on the card, 5 steps with
    ``set_learning_rate`` between steps 3 and 4, then ``step_n(4)``
    against four ``step()`` calls: losses and weights bitwise equal;
    without a clip (the update one O1 launch) and with
    ``clip_global_norm`` 1.0 (its norm from O3)."""
    for clip in (None, 1.0):
        train_graph_pair(dev, clip)


def train_graph_pair(dev, clip):
    import torch

    from mxnet_tpu_torch import gluon, initializer, parallel
    from mxnet_tpu_torch.gluon.model_zoo import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(LLAMA3_8B, num_layers=2)
    del cfg["vocab_size"], cfg["head_dim"]
    vocab = 2048
    rng = np.random.RandomState(4)
    toks = rng.randint(0, vocab, (1, 256)).astype(np.int32)
    labels = rng.randint(0, vocab, (1, 256)).astype(np.float32)
    runs = []
    for graphs in (False, True):
        net = llama.LlamaModel(vocab, device=dev, **cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        net.initialize(initializer.Xavier(), generator=gen)
        step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                     "adamw", {"learning_rate": 1e-4,
                                               "wd": 0.01}, graphs=graphs,
                                     clip_global_norm=clip)
        losses = []
        for i in range(5):
            if i == 3:
                step._opt.set_learning_rate(3e-4)
            losses.append(step.step(toks, labels).clone())
        if graphs:
            losses.append(step.step_n(4, toks, labels).clone())
        else:
            losses.append([step.step(toks, labels)
                           for _ in range(4)][-1].clone())
        runs.append((losses, [p.detach().clone() for p in net.parameters()],
                     step.stats() if graphs else None))
        del step, net
        gc.collect()
        torch.cuda.empty_cache()
    (e_loss, e_w, _), (g_loss, g_w, st) = runs
    same_loss = all(torch.equal(a, b) for a, b in zip(e_loss, g_loss))
    same_w = all(torch.equal(a, b) for a, b in zip(e_w, g_w))
    log("train graphs: f32, 2 layers at full width, clip_global_norm %s, 5 "
        "adamw steps (lr 1e-4, then 3e-4 from step 4) and step_n(4): losses "
        "eager %s graphed %s; losses %s, weights %s; graphed %d capture, %d "
        "replays"
        % (clip, ["%.6f" % x.item() for x in e_loss],
           ["%.6f" % x.item() for x in g_loss],
           "bitwise equal" if same_loss else "DIFFER",
           "bitwise equal" if same_w else "DIFFER",
           st["captures"], st["replays"]))
    if not (same_loss and same_w):
        fail("the graphed JitTrainStep is not bitwise equal to the eager one")
    if (st["captures"], st["replays"]) != (1, 8):
        fail("the graphed JitTrainStep did not capture once and replay 8 "
             "times")


# -- phase 8: the kernel path against the plain path ----------------------

def train_parity(dev):
    """Full width, 1 layer, vocab 2048, f32, TF32 off, B=1, T=256: the
    card's kernel path against the port's plain path on the host."""
    import torch

    from mxnet_tpu_torch import gluon, initializer, parallel
    from mxnet_tpu_torch.gluon.model_zoo import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(LLAMA3_8B, num_layers=1)
    del cfg["vocab_size"], cfg["head_dim"]
    vocab = 2048
    host = llama.LlamaModel(vocab, device="cpu", **cfg)
    gen = torch.Generator()
    gen.manual_seed(1)
    host.initialize(initializer.Xavier(), generator=gen)
    card = llama.LlamaModel(vocab, device=dev, **cfg)
    card.load_state_dict(host.state_dict())
    rng = np.random.RandomState(2)
    toks = rng.randint(0, vocab, (1, 256)).astype(np.int32)
    labels = rng.randint(0, vocab, (1, 256)).astype(np.float32)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    for net in (card, host):
        where = next(net.parameters()).device
        x, y = (torch.from_numpy(a).to(where) for a in (toks, labels))
        loss = loss_fn(net(x), y).mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        res.append((loss.item(), [g.cpu() for g in grads]))
    (l_card, g_card), (l_host, g_host) = res
    worst = max(((a - b).abs().max() / (b.abs().max() + 1e-12)).item()
                for a, b in zip(g_card, g_host))
    log("train parity: loss card %.6f host %.6f; worst gradient error %.3g "
        "of the gradient's max (tolerance 1e-3)" % (l_card, l_host, worst))
    if abs(l_card - l_host) > 1e-4 * abs(l_host) or worst > 1e-3:
        fail("the card's train step disagrees with the plain path")
    traj = []
    for net in (card, host):
        step = parallel.JitTrainStep(net, loss_fn, "adamw",
                                     {"learning_rate": 1e-4})
        traj.append([step.step(toks, labels).item() for _ in range(3)])
    log("train parity: 3 adamw steps, losses card %s host %s" % tuple(traj))
    if max(abs(a - b) for a, b in zip(*traj)) > 1e-3:
        fail("the card's adamw trajectory disagrees with the plain path")



# -- phase 9: hybridize() as captured CUDA graphs --------------------------

HYBRID_SHAPES = ((1, 128), (2, 2048))


def timed_forward(net, x, n):
    """Wall ms of ``n`` forwards under ``no_grad``, each synchronised."""
    import torch

    times = []
    with torch.no_grad():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return times, out


def hybrid_flash_checks(fa, dev, heads, d):
    """K1 (and K2, K3) against the plain versions at the attention
    shapes the main path below gives K1: B*H = batch x heads, causal,
    bf16, for each of HYBRID_SHAPES."""
    import torch

    rng = np.random.default_rng(6)
    for b, t in HYBRID_SHAPES:
        args = flash_case(rng, dev, b * heads, t, t, d, torch.bfloat16)
        res = flash_compare(fa, args, d ** -0.5, True)[0]
        worst = max(r for r, _ in res.values())
        log("hybridize: flash check at the %d x %d forward's shape, B*H=%d "
            "T=%d D=%d causal bf16 (reading, max_abs_err): %s %s"
            % (b, t, b * heads, t, d,
               " ".join("%s %.2f %.3g" % (n, r, e)
                        for n, (r, e) in res.items()),
               "ok" if worst <= 1 else "FAIL"))
        if worst > 1:
            fail("flash kernels disagree with their plain versions at the "
                 "hybridized forward's %d x %d shape" % (b, t))


def hybridize_phase(fa, dev):
    """``HybridBlock.hybridize()`` on the card: (1) f32, 2 layers at full
    width, TF32 off: three hybridized calls (eager, captured and
    replayed, replayed) against the eager forward, within 1e-5 of its
    largest logit; (2) the main path: bf16, the train phase's 8 layers at
    full width, forward under ``no_grad`` at 1 x 128 and 2 x 2048 tokens,
    eager against hybridized (wall p50 of synchronised calls), after
    K1 is held against its plain version at (2)'s attention shapes.
    K1's launches are counted over (2)."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(LLAMA3_8B)
    vocab = cfg.pop("vocab_size")
    cfg.pop("head_dim")

    def model(layers, seed):
        net = llama.LlamaModel(vocab, device=dev,
                               **dict(cfg, num_layers=layers))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        net.initialize(initializer.Xavier(), generator=gen)
        return net

    rng = np.random.default_rng(5)
    net = model(2, 1)
    x = torch.from_numpy(rng.integers(0, vocab, (1, 128))).to(dev)
    with torch.no_grad():
        want = net(x)
        net.hybridize()
        got = [net(x) for _ in range(3)]
    (cc,) = net._graphs.calls.values()
    errs = [float((o - want).abs().max() / want.abs().max()) for o in got]
    log("hybridize: f32, 2 layers at full width, 1 x 128 tokens: calls 1-3 "
        "(eager, captured + replayed, replayed) against eager: max error "
        "%s of the largest logit (tolerance 1e-5); %d capture(s), %d "
        "replays" % (["%.3g" % e for e in errs], cc.captures, cc.replays))
    if (cc.calls, cc.captures, cc.replays) != (3, 1, 2):
        fail("the hybridized block did not capture once and replay twice")
    if max(errs) > 1e-5:
        fail("the hybridized f32 forward disagrees with the eager one")
    del net, want, got, cc
    gc.collect()
    torch.cuda.empty_cache()

    from mxnet_tpu_torch import gluon

    hybridize_recorded_check(gluon, dev, vocab, cfg)
    hybrid_flash_checks(fa, dev, cfg["num_heads"], LLAMA3_8B["head_dim"])
    net = model(TRAIN_LAYERS, 0)
    net.cast("bfloat16")
    for name in ("fwd_launches", "dq_launches", "dkv_launches"):
        setattr(fa.flash_attention, name, 0)
    rows = []
    calls = 0
    for b, t in HYBRID_SHAPES:
        x = torch.from_numpy(rng.integers(0, vocab, (b, t))).to(dev)
        n = 20 if t <= 128 else 10
        eager, want = timed_forward(net, x, n + 2)
        net.hybridize()
        first, _ = timed_forward(net, x, 2)     # eager, then the capture
        hyb, got = timed_forward(net, x, n)
        (cc,) = net._graphs.calls.values()
        st = (cc.capture_s, net._graphs.stats()["pool_bytes"],
              1e6 * cc.host_s / max(cc.replays, 1))
        calls += n + 2 + 2 + n
        net.hybridize(False)
        err = float((got.float() - want.float()).abs().max())
        rows.append((b, t, p50(eager[2:]), p50(hyb), first, st, err,
                     torch.equal(got, want)))
        if not torch.isfinite(got).all() or \
                err > 1e-2 * float(want.float().abs().max()):
            fail("hybridized bf16 forward at %d x %d disagrees with eager "
                 "(max abs error %.3g)" % (b, t, err))
        del want, got
    launches = {name: getattr(fa.flash_attention, name)
                for name in ("fwd_launches", "dq_launches", "dkv_launches")}
    for b, t, e_ms, h_ms, first, st, err, same in rows:
        log("hybridize: bf16, %d layers at full width, %d x %d tokens, "
            "no_grad forward: eager p50 %.3f ms, hybridized p50 %.3f ms "
            "(%.2fx); first hybridized calls %.1f ms (eager) and %.1f ms "
            "(capture %.3f s + replay); graph pool %.1f MB; %.1f us host "
            "time a replay outside it; outputs %s (max abs error %.3g)"
            % (TRAIN_LAYERS, b, t, e_ms, h_ms, e_ms / h_ms, first[0],
               first[1], st[0], st[1] / 1e6, st[2],
               "bitwise equal" if same else "not bitwise equal", err))
    log("hybridize: K1 launches %d over %d forwards of %d layers"
        % (launches["fwd_launches"], calls, TRAIN_LAYERS))
    if launches["fwd_launches"] < calls * TRAIN_LAYERS:
        fail("K1 launched %d times over %d forwards of %d layers"
             % (launches["fwd_launches"], calls, TRAIN_LAYERS))
    recorded = hybridize_recorded_main(fa, gluon, net, vocab)
    del net
    out = {n: launches[n] + recorded[n] for n in launches}
    out["O1"] = recorded["O1"]
    return out

def trainer_run(net, lm, x, y, lr=1e-4, keep_grads=False):
    """A gluon.Trainer (adamw) over ``net``'s parameters and one step of
    it: ``lm`` under ``autograd.record()``, ``backward()``, ``step(1)``.
    Returns the step, which returns the loss and, with ``keep_grads``,
    copies of the gradients."""
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adamw",
                            {"learning_rate": lr})
    params = list(net.parameters())

    def one():
        with autograd.record():
            loss = loss_fn(lm(x), y).mean()
        loss.backward()
        grads = [p.grad.clone() for p in params] if keep_grads else None
        trainer.step(1)
        return loss.detach(), grads

    return one


def hybridize_recorded_check(gluon, dev, vocab, cfg):
    """f32, 2 layers at full width, TF32 off, 1 x 256 tokens: 3 Trainer
    steps under ``record()`` through the eager block and through the
    hybridized one (eager, captured, replayed): every step's gradients
    and the weights after them bitwise equal."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, vocab, (1, 256))).to(dev)
    y = torch.from_numpy(rng.integers(0, vocab, 256).astype(np.float32)) \
        .to(dev)
    runs = []
    for hybrid in (False, True):
        net = llama.LlamaModel(vocab, device=dev, **dict(cfg, num_layers=2))
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        net.initialize(initializer.Xavier(), generator=gen)
        lm = lm_wrapper(gluon, vocab)(net)
        if hybrid:
            lm.hybridize()
        one = trainer_run(net, lm, x, y, keep_grads=True)
        res = [one() for _ in range(3)]
        runs.append(([r[0] for r in res], [r[1] for r in res],
                     [p.detach().clone() for p in net.parameters()],
                     lm.stats() if hybrid else None))
        del net, lm, one, res
        gc.collect()
        torch.cuda.empty_cache()
    (e_l, e_g, e_w, _), (h_l, h_g, h_w, st) = runs
    same_l = all(torch.equal(a, b) for a, b in zip(e_l, h_l))
    same_g = all(torch.equal(a, b) for ga, gb in zip(e_g, h_g)
                 for a, b in zip(ga, gb))
    same_w = all(torch.equal(a, b) for a, b in zip(e_w, h_w))
    log("hybridize recorded: f32, 2 layers at full width, 1 x 256 tokens, "
        "3 Trainer adamw steps under record(): losses %s; hybridized "
        "against eager: losses %s, gradients of every step %s, weights %s; "
        "%d capture, %d forward and %d backward replays"
        % (["%.6f" % v.item() for v in e_l],
           "bitwise equal" if same_l else "DIFFER",
           "bitwise equal" if same_g else "DIFFER",
           "bitwise equal" if same_w else "DIFFER",
           st["captures"], st["replays"], st["backward_replays"]))
    if not (same_l and same_g and same_w):
        fail("the hybridized recorded step is not bitwise equal to eager")
    if (st["captures"], st["replays"], st["backward_replays"]) != (1, 2, 2):
        fail("the recorded call did not capture once and replay twice")


def hybridize_recorded_main(fa, gluon, net, vocab):
    """The main path of recorded calls: gluon.Trainer (adamw 1e-4) over
    the 8-layer bf16 block under ``record()`` at 2 x 2048 tokens, eager
    against hybridized, 2 warm-up and 8 timed steps each and one
    profiled.  K1 must grow by the layers with every forward, K2 and K3
    with every backward, replays included."""
    import torch

    dev = next(net.parameters()).device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, vocab, (TRAIN_B, TRAIN_T))).to(dev)
    y = torch.from_numpy(rng.integers(0, vocab, TRAIN_B * TRAIN_T)
                         .astype(np.float32)).to(dev)
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    lm = lm_wrapper(gluon, vocab)(net)
    names = ("fwd_launches", "dq_launches", "dkv_launches")
    before = {n: getattr(fa.flash_attention, n) for n in names}
    reset_opt_counts(oo)
    rows = {}
    losses = []
    n_warm, n_timed = 2, 8
    for mode in ("eager", "hybridized"):
        if mode == "hybridized":
            lm.hybridize()
        one = trainer_run(net, lm, x, y)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(lambda: one()[0], n_warm, n_timed)
        losses += [v.item() for v in outs]
        out, wall, busy, averages = profiled_step(lambda: one()[0])
        losses.append(out.item())
        rows[mode] = (times, wall, busy, torch.cuda.max_memory_allocated(),
                      lm.stats() if mode == "hybridized" else None)
        log("hybridize recorded: %s profiled step: the Trainer's update "
            "kernels (O1) %.3f ms" % (mode, update_kernel_ms(averages)))
    launches = {n: getattr(fa.flash_attention, n) - before[n] for n in names}
    launches["O1"] = opt_counts(oo)["O1"]
    steps = 2 * (n_warm + n_timed + 1)
    st = rows["hybridized"][4]
    log("hybridize recorded: bf16, %d layers at full width, %d x %d tokens, "
        "Trainer adamw 1e-4: losses %s" % (TRAIN_LAYERS, TRAIN_B, TRAIN_T,
                                          ["%.4f" % v for v in losses]))
    if not all(math.isfinite(v) for v in losses):
        fail("a recorded hybridize loss is not finite")
    for mode, (times, wall, busy, peak, _) in rows.items():
        log("hybridize recorded: %s step ms p50 %.3f (min %.3f max %.3f "
            "over %d timed steps); profiled step wall %.3f ms, kernels busy "
            "%.3f ms, idle %.1f%%; peak device memory %.2f GB"
            % (mode, 1e3 * p50(times), 1e3 * times[0], 1e3 * times[-1],
               len(times), 1e3 * wall, busy,
               100 * (1 - busy / (1e3 * wall)), peak / 1e9))
    log("hybridize recorded: %d capture in %.3f s, %d forward and %d "
        "backward replays, %.1f us host time a replay outside it, graph "
        "pool %.1f MB, %d busy-signature calls run eagerly"
        % (st["captures"], st["capture_s"], st["replays"],
           st["backward_replays"], 1e6 * st["host_s"] / max(st["replays"], 1),
           st["pool_bytes"] / 1e6, st["busy_calls"]))
    log("hybridize recorded: flash launches over the %d steps: %s (%d "
        "layers x steps = %d)" % (steps, launches, TRAIN_LAYERS,
                                  TRAIN_LAYERS * steps))
    if st["captures"] != 1 or st["replays"] != n_warm + n_timed \
            or st["backward_replays"] != st["replays"]:
        fail("the recorded hybridized step did not capture once and replay "
             "forward and backward (%s)" % st)
    for n in names:
        if launches[n] < TRAIN_LAYERS * steps:
            fail("flash %s = %d over %d recorded steps of %d layers"
                 % (n, launches[n], steps, TRAIN_LAYERS))
    log("hybridize recorded: O1 launches over the %d steps: %d"
        % (steps, launches["O1"]))
    if launches["O1"] < steps:
        fail("the Trainer's adamw launched O1 %d times over %d steps"
             % (launches["O1"], steps))
    e50, h50 = (p50(rows[m][0]) for m in ("eager", "hybridized"))
    log("hybridize recorded: hybridized / eager step p50 %.3f / %.3f ms "
        "(%.3fx)" % (1e3 * h50, 1e3 * e50, e50 / h50))
    lm.hybridize(False)
    return launches


# -- phases 10-12: mx.rtc (K5) and the imperative NDArray path -----------

# The user kernels of the rtc and imperative phases: CUDA C++ that
# ``mx.rtc.CudaModule`` compiles with NVRTC at first use.  The SwiGLU
# kernels are templates (f32 and bf16), named through ``exports``; each
# thread takes 16 bytes of every operand, in f32 arithmetic, and rounds
# once.  ``-DMXTT_SKIP_BLOCK=<b>`` plants a fault: block b writes nothing.
SCALE_ADD_SOURCE = r"""
extern "C" __global__ void scale_add(const float *x, const float *y,
                                     float *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + y[i];
}
"""
SCALE_ADD_SIGNATURE = "const float *x, const float *y, float *out, int n"

SWIGLU_SOURCE = r"""
#include <cuda_bf16.h>

__device__ __forceinline__ float mxtt_f32(float x) { return x; }
__device__ __forceinline__ float mxtt_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T mxtt_from(float x);
template <> __device__ __forceinline__ float mxtt_from<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
mxtt_from<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float mxtt_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h = a * sigmoid(a) * b
template <typename T>
__device__ __forceinline__ void mxtt_fwd1(const T *a, const T *b, T *h,
                                          long long i) {
  float x = mxtt_f32(a[i]), y = mxtt_f32(b[i]);
  h[i] = mxtt_from<T>(x * mxtt_sigmoid(x) * y);
}

// da = dh * b * s * (1 + a (1 - s)),  db = dh * a * s,  s = sigmoid(a)
template <typename T>
__device__ __forceinline__ void mxtt_bwd1(const T *a, const T *b,
                                          const T *dh, T *da, T *db,
                                          long long i) {
  float x = mxtt_f32(a[i]), y = mxtt_f32(b[i]), g = mxtt_f32(dh[i]);
  float s = mxtt_sigmoid(x), gs = g * s;
  da[i] = mxtt_from<T>(gs * y * (1.0f + x * (1.0f - s)));
  db[i] = mxtt_from<T>(gs * x);
}

__device__ __forceinline__ bool mxtt_aligned(const void *p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T>
__global__ void __launch_bounds__(256)
mxtt_swiglu_fwd(const T *__restrict__ a, const T *__restrict__ b,
                T *__restrict__ h, long long n) {
#ifdef MXTT_SKIP_BLOCK
  if (blockIdx.x == MXTT_SKIP_BLOCK) return;
#endif
  constexpr int V = 16 / sizeof(T);
  long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i0 >= n) return;
  if (i0 + V <= n && mxtt_aligned(a) && mxtt_aligned(b) && mxtt_aligned(h)) {
    uint4 ra = *reinterpret_cast<const uint4 *>(a + i0);
    uint4 rb = *reinterpret_cast<const uint4 *>(b + i0);
    uint4 rh;
    const T *va = reinterpret_cast<const T *>(&ra);
    const T *vb = reinterpret_cast<const T *>(&rb);
    T *vh = reinterpret_cast<T *>(&rh);
#pragma unroll
    for (int j = 0; j < V; ++j) mxtt_fwd1(va, vb, vh, j);
    *reinterpret_cast<uint4 *>(h + i0) = rh;
  } else {
    for (long long i = i0; i < n && i < i0 + V; ++i) mxtt_fwd1(a, b, h, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
mxtt_swiglu_bwd(const T *__restrict__ a, const T *__restrict__ b,
                const T *__restrict__ dh, T *__restrict__ da,
                T *__restrict__ db, long long n) {
#ifdef MXTT_SKIP_BLOCK
  if (blockIdx.x == MXTT_SKIP_BLOCK) return;
#endif
  constexpr int V = 16 / sizeof(T);
  long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i0 >= n) return;
  if (i0 + V <= n && mxtt_aligned(a) && mxtt_aligned(b) &&
      mxtt_aligned(dh) && mxtt_aligned(da) && mxtt_aligned(db)) {
    uint4 ra = *reinterpret_cast<const uint4 *>(a + i0);
    uint4 rb = *reinterpret_cast<const uint4 *>(b + i0);
    uint4 rg = *reinterpret_cast<const uint4 *>(dh + i0);
    uint4 rda, rdb;
    T *vda = reinterpret_cast<T *>(&rda), *vdb = reinterpret_cast<T *>(&rdb);
#pragma unroll
    for (int j = 0; j < V; ++j)
      mxtt_bwd1(reinterpret_cast<const T *>(&ra),
                reinterpret_cast<const T *>(&rb),
                reinterpret_cast<const T *>(&rg), vda, vdb, j);
    *reinterpret_cast<uint4 *>(da + i0) = rda;
    *reinterpret_cast<uint4 *>(db + i0) = rdb;
  } else {
    for (long long i = i0; i < n && i < i0 + V; ++i)
      mxtt_bwd1(a, b, dh, da, db, i);
  }
}
"""
SWIGLU_EXPORTS = ("mxtt_swiglu_fwd<float>", "mxtt_swiglu_fwd<__nv_bfloat16>",
                  "mxtt_swiglu_bwd<float>", "mxtt_swiglu_bwd<__nv_bfloat16>")
SWIGLU_THREADS = 256
_C_TYPES = {"torch.float32": "float", "torch.bfloat16": "__nv_bfloat16"}
FP32_FLOPS = 67e12                 # H100 SXM data sheet, outside tensor cores


def swiglu_fwd_ref(a, b):
    """Plain SwiGLU forward on tensors: ``a·σ(a)·b`` in f32, rounded once
    to a's dtype."""
    import torch

    x, y = a.float(), b.float()
    return (x * torch.sigmoid(x) * y).to(a.dtype)


def swiglu_bwd_ref(a, b, dh):
    """Plain SwiGLU backward: ``(dh·b·σ(a)(1 + a(1−σ(a))), dh·a·σ(a))``
    in f32, each rounded once."""
    import torch

    x, y, g = a.float(), b.float(), dh.float()
    s = torch.sigmoid(x)
    gs = g * s
    return (gs * y * (1 + x * (1 - s))).to(a.dtype), (gs * x).to(b.dtype)


def _swiglu_fwd_body(a_ref, b_ref, h_ref):
    h_ref[...] = swiglu_fwd_ref(a_ref[...], b_ref[...])


def _swiglu_bwd_body(a_ref, b_ref, dh_ref, da_ref, db_ref):
    da_ref[...], db_ref[...] = swiglu_bwd_ref(a_ref[...], b_ref[...],
                                              dh_ref[...])


class SwigluKernels:
    """SwiGLU forward and backward as user kernels of ``mx.rtc``: on a
    gpu context the CUDA kernels of ``SWIGLU_SOURCE`` (one NVRTC compile,
    f32 and bf16), on the host ``PallasKernel`` bodies over the plain
    versions.  ``options`` go to NVRTC."""

    def __init__(self, mx, options=()):
        self.mx = mx
        self.options = tuple(options)
        self.module = None
        self._kernels = {}

    def kernel(self, which, dtype):
        """The ``CudaKernel`` for ``which`` ("fwd" or "bwd") and a torch
        dtype (float32 or bfloat16)."""
        key = (which, str(dtype))
        k = self._kernels.get(key)
        if k is None:
            if self.module is None:
                self.module = self.mx.rtc.CudaModule(
                    SWIGLU_SOURCE, options=self.options,
                    exports=SWIGLU_EXPORTS)
            t = _C_TYPES[str(dtype)]
            sig = ("const {t} *a, const {t} *b, {t} *h, long long n"
                   if which == "fwd" else
                   "const {t} *a, const {t} *b, const {t} *dh, {t} *da, "
                   "{t} *db, long long n").format(t=t)
            k = self.module.get_kernel("mxtt_swiglu_%s<%s>" % (which, t),
                                       sig)
            self._kernels[key] = k
        return k

    @staticmethod
    def grid(a):
        per_block = SWIGLU_THREADS * (16 // a.data().element_size())
        return (-(-a.size // per_block), 1, 1)

    def _launch(self, which, arrays, outs):
        a = arrays[0]
        self.kernel(which, a.data().dtype).launch(
            list(arrays) + list(outs) + [a.size], a.context, self.grid(a),
            (SWIGLU_THREADS, 1, 1))
        return outs

    def _new(self, a):
        return self.mx.nd.empty(a.shape, ctx=a.context, dtype=a.data().dtype)

    def fwd(self, a, b, out=None):
        if a.context.device_type == "gpu":
            return self._launch("fwd", (a, b),
                                [out if out is not None else self._new(a)])[0]
        rtc = self.mx.rtc
        spec = rtc.ShapeDtypeStruct(a.shape, a.data().dtype)
        return rtc.PallasKernel(_swiglu_fwd_body, out_shape=spec,
                                name="swiglu_fwd")(a, b)

    def bwd(self, a, b, dh, out=None):
        if a.context.device_type == "gpu":
            return self._launch("bwd", (a, b, dh), out if out is not None
                                else [self._new(a), self._new(b)])
        rtc = self.mx.rtc
        spec = rtc.ShapeDtypeStruct(a.shape, a.data().dtype)
        return rtc.PallasKernel(_swiglu_bwd_body, out_shape=(spec, spec),
                                name="swiglu_bwd")(a, b, dh)


def swiglu_function(mx, kernels):
    """An ``mx.autograd.Function`` class for ``h = a·σ(a)·b`` whose
    forward and backward launch ``kernels.fwd`` and ``kernels.bwd``."""

    class SwiGLU(mx.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return kernels.fwd(a, b)

        def backward(self, dh):
            a, b = self.saved_tensors
            return tuple(kernels.bwd(a, b, dh))

    return SwiGLU


def mlp_step(mx, params, x, target, swiglu, lr):
    """One MXNet-style training step of a Llama MLP block, written as user
    code on ``mx.nd``: ``y = (SwiGLU(x·Wg, x·Wu))·Wd``, a mean-square loss
    against ``target`` (f32), ``backward`` and an in-place SGD update.
    ``swiglu(a, b)`` applies the SwiGLU Function.  Works with either
    package.  Returns the loss NDArray (before the update)."""
    nd, autograd = mx.nd, mx.autograd
    wg, wu, wd = params
    with autograd.record():
        a = nd.dot(x, wg)
        b = nd.dot(x, wu)
        h = swiglu(a, b)
        y = nd.dot(h, wd)
        diff = y.astype("float32") - target
        loss = (diff * diff).mean()
    loss.backward()
    for w in params:
        w -= lr * w.grad
    return loss


def mlp_numpy(units, hidden, tokens, seed):
    """Seeded numpy inputs of ``mlp_step``: Wg, Wu, Wd (std 1/sqrt(fan-in)),
    x and target (standard normal)."""
    rng = np.random.default_rng(seed)

    def rand(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return ([rand((units, hidden), units ** -0.5),
             rand((units, hidden), units ** -0.5),
             rand((hidden, units), hidden ** -0.5)],
            rand((tokens, units), 1.0), rand((tokens, units), 1.0))


def mlp_arrays(mx, arrays, ctx=None):
    """``mlp_numpy``'s arrays as NDArrays of ``mx`` (weights marked)."""
    weights, x, target = arrays
    params = [mx.nd.array(w, ctx=ctx) for w in weights]
    for w in params:
        w.attach_grad()
    return params, mx.nd.array(x, ctx=ctx), mx.nd.array(target, ctx=ctx)


def bf16_ulps(got, want):
    """Per-element distance in bf16 ulps between two bf16 tensors."""
    import torch

    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(got) - ordered(want)).abs()


def _ulp_reading(got, want):
    u = bf16_ulps(got, want)
    return (u.max().item(), int((u > 1).sum().item()),
            (got.float() - want.float()).abs().max().item())


IMP_TOKENS = TRAIN_B * TRAIN_T      # 2 x 2048 tokens, the train batch
IMP_LR = 100.0


def rtc_checks(mx, dev):
    """K5 on the card: (a) scale_add exact, (b) the SwiGLU kernels within
    1 bf16 ulp of their plain versions at Llama-3-8B's MLP shape, a
    planted fault caught, (c) a compile error raising with NVRTC's log.
    Returns the SwiGLU kernels and operands for the timing."""
    import torch

    from mxnet_tpu_torch.ops import _nvrtc

    rtc, nd, ctx = mx.rtc, mx.nd, mx.gpu(0)
    t0 = time.perf_counter()
    mod = rtc.CudaModule(SCALE_ADD_SOURCE)
    log("rtc: NVRTC %d.%d compiled scale_add for sm_90a in %.2f s "
        "(options %s)" % (_nvrtc.version() + (time.perf_counter() - t0,
                                                " ".join(mod.options))))
    k = mod.get_kernel("scale_add", SCALE_ADD_SIGNATURE)
    rs = np.random.RandomState(4)
    x = rs.randn(8, 128).astype(np.float32)
    y = rs.randn(8, 128).astype(np.float32)
    xa, ya = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    out = nd.empty((8, 128), ctx=ctx)
    k.launch([xa, ya, out, x.size], ctx, (4, 1, 1), (256, 1, 1))
    got = out.asnumpy()
    plain = (xa.data() * 2 + ya.data()).cpu().numpy()
    exact = np.array_equal(got, x * 2 + y) and np.array_equal(got, plain)
    log("rtc check (a) scale_add (8, 128) f32: equal to x*2 + y (numpy and "
        "torch on the card): %s" % ("ok" if exact else "FAIL"))
    if not exact:
        fail("scale_add differs from x*2 + y")

    # (b) SwiGLU forward and backward at Llama-3-8B's MLP shape, bf16
    t0 = time.perf_counter()
    kern = SwigluKernels(mx)
    for which in ("fwd", "bwd"):
        for dt in (torch.bfloat16, torch.float32):
            kern.kernel(which, dt)
    log("rtc: NVRTC compiled the SwiGLU templates (%s) in %.2f s"
        % (", ".join(SWIGLU_EXPORTS), time.perf_counter() - t0))
    shape = (IMP_TOKENS, LLAMA3_8B["hidden_size"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    a, b, dh = (torch.randn(shape, generator=gen, device=dev).mul_(s)
                .to(torch.bfloat16) for s in (2.0, 1.0, 0.05))
    A, B, DH = (nd.array(t, ctx=ctx) for t in (a, b, dh))
    h = kern.fwd(A, B)
    da, db = kern.bwd(A, B, DH)
    want = (swiglu_fwd_ref(a, b),) + swiglu_bwd_ref(a, b, dh)
    readings = {}
    for name, g, w in zip(("h", "da", "db"), (h, da, db), want):
        readings[name] = _ulp_reading(g.data(), w)
    log("rtc check (b) SwiGLU (%d, %d) bf16 against the plain versions (f32, "
        "rounded once): %s (max ulps, elements over 1 ulp, max_abs_err)"
        % (shape + (" ".join("%s %d %d %.3g" % ((n,) + r)
                             for n, r in readings.items()),)))
    if any(r[0] > 1 for r in readings.values()):
        fail("a SwiGLU kernel is more than 1 bf16 ulp off its plain version")
    # a planted fault: block 7 of each kernel writes nothing
    bad = SwigluKernels(mx, options=("-DMXTT_SKIP_BLOCK=7",))
    hb = bad.fwd(A, B, out=nd.zeros(shape, ctx=ctx, dtype="bfloat16"))
    dab, dbb = bad.bwd(A, B, DH, out=[nd.zeros(shape, ctx=ctx,
                                                 dtype="bfloat16")
                                        for _ in range(2)])
    planted = {n: _ulp_reading(g.data(), w) for n, g, w in
               zip(("h", "da", "db"), (hb, dab, dbb), want)}
    log("rtc check (b): block 7 planted to write nothing reads %s (max ulps, "
        "elements over 1 ulp: each must fail)"
        % " ".join("%s %d %d" % (n, r[0], r[1]) for n, r in planted.items()))
    if min(r[0] for r in planted.values()) <= 1:
        fail("the 1-ulp check passes a planted fault")

    # (c) a compile error raises with NVRTC's log
    try:
        rtc.CudaModule('extern "C" __global__ void broken(float *x) '
                       '{ x[0] = mxtt_not_declared; }')
    except mx.MXNetError as e:
        msg = str(e)
    else:
        fail("NVRTC compiled a broken source")
    if "mxtt_not_declared" not in msg or "error" not in msg:
        fail("the compile error lacks NVRTC's log: %s" % msg)
    log("rtc check (c) compile error raised MXNetError with NVRTC's log: %s"
        % " | ".join(line.strip() for line in msg.splitlines()[:3]))
    errs = {"fwd": readings["h"][2],
            "bwd": max(readings["da"][2], readings["db"][2])}
    return kern, (a, b, dh), (A, B, DH), errs


def rtc_timing(mx, kern, tensors, arrays, errs):
    """(d) Each SwiGLU kernel at the MLP shape beside its byte bound, its
    plain version and torch's eager ``F.silu(a) * b`` (forward) and that
    expression's autograd backward; and the host cost of one launch."""
    import torch
    import torch.nn.functional as F

    a, b, dh = tensors
    A, B, DH = arrays
    ctx, n = A.context, a.numel()
    fwd_k, bwd_k = (kern.kernel(w, torch.bfloat16) for w in ("fwd", "bwd"))
    h = kern._new(A)
    dab = [kern._new(A), kern._new(B)]
    ms = {"fwd": cuda_ms(lambda i: kern.fwd(A, B, out=h), 50),
          "bwd": cuda_ms(lambda i: kern.bwd(A, B, DH, out=dab), 50)}
    plain = {"fwd": cuda_ms(lambda i: swiglu_fwd_ref(a, b), 10),
             "bwd": cuda_ms(lambda i: swiglu_bwd_ref(a, b, dh), 10)}
    la, lb = (t.detach().requires_grad_() for t in (a, b))
    lib_h = F.silu(la) * lb
    library = {"fwd": cuda_ms(lambda i: F.silu(a) * b, 50),
               "bwd": cuda_ms(lambda i: torch.autograd.grad(
                   lib_h, (la, lb), dh, retain_graph=True), 50)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fwd_k.launch([A, B, h, n], ctx, kern.grid(A), (SWIGLU_THREADS, 1, 1))
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    # bound: each operand read once, each output written once (bf16), or
    # the f32 arithmetic at the CUDA-core rate, whichever is longer
    work = {"fwd": (3 * n * 2, 7 * n), "bwd": (5 * n * 2, 13 * n)}
    rows = {}
    for w in ("fwd", "bwd"):
        n_bytes, flops = work[w]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        rows[w] = {"ms": ms[w], "plain_ms": plain[w],
                   "library_ms": library[w], "bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "max_abs_err": errs[w]}
        log("rtc timing (d) SwiGLU %s (%d, %d) bf16: kernel %.4f ms, plain "
            "%.4f ms, torch eager %.4f ms, bound %.4f ms (%d bytes at 3.35 "
            "TB/s) -> %.1f%% of bound" % (
                w, IMP_TOKENS, LLAMA3_8B["hidden_size"], ms[w], plain[w],
                library[w], bound, n_bytes, 100.0 * bound / ms[w]))
    log("rtc timing (d): host enqueue %.1f us per CudaKernel.launch (engine "
        "push, argument checks, cuLaunchKernel)" % host_us)
    return rows


def rtc_phase(mx, dev):
    kern, tensors, arrays, errs = rtc_checks(mx, dev)
    return rtc_timing(mx, kern, tensors, arrays, errs)


def dispatch_rate(mx, ctx, record, chain_len=20, n_iters=30, windows=5,
                  ones=None):
    """Imperative ops/s through a ``chain_len``-op elementwise chain on a
    (64, 64) array (the JAX package's ``bench.py`` ``_dispatch_rate``):
    plain, or under ``record()`` with ``backward()``; the median of
    ``windows`` windows.  Host-bound by design.  ``ones`` makes the array
    (``mx.nd.ones`` unless given: ``mx.np.ones`` for the np phase)."""
    nd, autograd = mx.nd, mx.autograd
    x = (ones or nd.ones)((64, 64), ctx=ctx)
    if record:
        x.attach_grad()

    def run_iter():
        if record:
            with autograd.record():
                a = x
                for i in range(chain_len):
                    a = (a + 1.0) if i % 2 else (a * 1.0009765625)
                loss = a.sum()
            loss.backward()
            x.grad.wait_to_read()
        else:
            a = x
            for i in range(chain_len):
                a = (a + 1.0) if i % 2 else (a * 1.0009765625)
            a.wait_to_read()

    for _ in range(3):
        run_iter()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            run_iter()
        rates.append(chain_len * n_iters / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def imperative_main_path(mx, dev):
    """A main path: MXNet-style training steps of one Llama-3-8B MLP block
    at full width (4096 / 14336, bf16 weights from a seeded card
    generator) on a 2 x 2048-token batch, written on ``mx.nd`` with
    ``ctx=mx.gpu()``; SwiGLU is an ``autograd.Function`` whose forward and
    backward launch the rtc kernels.  The steps run bulked (the engine's
    default: segments replayed as CUDA graphs), then under ``bulk(0)``
    (every op eager), after a check that 3 bulked steps are bitwise
    equal to 3 eager ones.  Then the engine's dispatch rate, bulked and
    eager, and its asynchrony."""
    import torch

    ctx = mx.gpu(0)
    eng = mx.engine.Engine.get()
    units, hidden = LLAMA3_8B["units"], LLAMA3_8B["hidden_size"]
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, std, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).mul_(std) \
            .to(dtype)

    init = [rand((units, hidden), units ** -0.5),
            rand((units, hidden), units ** -0.5),
            rand((hidden, units), hidden ** -0.5)]
    x = mx.nd.array(rand((IMP_TOKENS, units), 1.0), ctx=ctx)
    target = mx.nd.array(rand((IMP_TOKENS, units), 1.0, torch.float32),
                         ctx=ctx)
    kern = SwigluKernels(mx)
    kernels = [kern.kernel(w, torch.bfloat16) for w in ("fwd", "bwd")]
    SwiGLU = swiglu_function(mx, kern)
    names = [k.name for k in kernels]

    def fresh():
        params = [mx.nd.array(w, ctx=ctx) for w in init]
        for w in params:
            w.attach_grad()
        return params

    def step(params):
        return mlp_step(mx, params, x, target,
                        lambda a, b: SwiGLU()(a, b), IMP_LR)

    # (1) bulked against eager, bitwise, from the same weights
    res = []
    for on in (False, True):
        params = fresh()
        got = []
        with bulking(mx, on):
            for _ in range(3):
                loss = step(params)
                got.append((loss.data().clone(),
                            [w.grad.data().clone() for w in params]))
        res.append((got, [w.data().clone() for w in params]))
    (e_steps, e_w), (b_steps, b_w) = res
    same = all(torch.equal(a[0], b[0]) and all(
        torch.equal(g, h) for g, h in zip(a[1], b[1]))
        for a, b in zip(e_steps, b_steps)) \
        and all(torch.equal(a, b) for a, b in zip(e_w, b_w))
    log("imperative: 3 steps bulked against 3 under bulk(0): losses, "
        "gradients and weights %s" % ("bitwise equal" if same else "DIFFER"))
    if not same:
        fail("bulked imperative steps are not bitwise equal to eager ones")
    del res, e_steps, b_steps, e_w, b_w

    # (2) the main path: bulked (the default) steps, counted by the rtc
    # kernels' own counters (an op hook would turn bulking off)
    start_profiler(dev)
    rows = {}
    n_warm, n_timed = 2, 5
    for mode in ("bulked", "eager"):
        params = fresh()
        for k in kernels:
            k.launches = 0
        seg0 = eng.stats.bulk_segments
        pushes0 = eng.stats.ops_pushed
        st0 = eng.segment_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, per_step = [], []
        with bulking(mx, mode == "bulked"):
            def one():
                before = [k.launches for k in kernels]
                loss = step(params)
                losses.append(float(loss.asscalar()))     # syncs
                per_step.append([k.launches - b
                                 for k, b in zip(kernels, before)])
            times, _ = timed_steps(one, n_warm, n_timed)
            _, wall, busy, averages = profiled_step(one)
        st1 = eng.segment_stats()
        rows[mode] = dict(
            losses=losses, per_step=per_step, times=times, wall=wall,
            busy=busy, averages=averages,
            launches={n: k.launches for n, k in zip(names, kernels)},
            segments=eng.stats.bulk_segments - seg0,
            pushes=eng.stats.ops_pushed - pushes0,
            peak=torch.cuda.max_memory_allocated(),
            replays=st1["graphs"]["replays"] - st0["graphs"]["replays"],
            bwd_replays=st1["graphs"]["backward_replays"]
            - st0["graphs"]["backward_replays"],
            captures=st1["graphs"]["captures"] - st0["graphs"]["captures"],
            hits={t: st1["tiers"][t]["hits"] - st0["tiers"][t]["hits"]
                  for t in st1["tiers"]})
        del params
    main = rows["bulked"]
    losses = main["losses"]
    log("imperative: Llama-3-8B MLP block (%d / %d, bf16), %d tokens, SGD "
        "lr %g; bulked losses %s" % (units, hidden, IMP_TOKENS, IMP_LR,
                                     ["%.5f" % v for v in losses]))
    if not all(math.isfinite(v) for v in losses):
        fail("an imperative loss is not finite")
    if not losses[-1] < losses[0]:
        fail("the imperative loss did not fall")
    for mode, r in rows.items():
        if any(c != [1, 1] for c in r["per_step"]) or \
                any(v != len(r["losses"]) for v in r["launches"].values()):
            fail("the rtc kernels did not launch once per %s step: %s, "
                 "kernel counts %s" % (mode, r["per_step"], r["launches"]))
    if main["replays"] < 1 or main["segments"] < 1:
        fail("the bulked steps replayed no segment graph")
    # model FLOPs: 3 products forward, twice that backward; x is not
    # differentiated, so the step runs 7 of those 9 products
    flops = 3 * 3 * 2 * IMP_TOKENS * units * hidden
    for mode, r in rows.items():
        t = r["times"]
        p = t[len(t) // 2]
        log("imperative: %s step ms p50 %.3f (min %.3f max %.3f over %d "
            "timed steps), %.1f TFLOP/s of model FLOPs (%.1f%% of 989 "
            "bf16); profiled step wall %.3f ms, kernels busy %.3f ms, idle "
            "%.1f%%; %d engine pushes, %d segments flushed (%d captured, "
            "%d forward and %d backward replays, tier hits %s) over %d "
            "steps; peak device memory %.3f GB (%.3f GB held before)"
            % (mode, 1e3 * p, 1e3 * t[0], 1e3 * t[-1], len(t),
               flops / p / 1e12, 100 * flops / p / BF16_FLOPS,
               1e3 * r["wall"], r["busy"], 100 * (1 - r["busy"]
                                                  / (1e3 * r["wall"])),
               r["pushes"], r["segments"], r["captures"], r["replays"],
               r["bwd_replays"], r["hits"], len(r["losses"]),
               r["peak"] / 1e9, held / 1e9))
    rows_k = [(e.self_device_time_total, e.count, e.key)
              for e in main["averages"]]
    rows_k = [r for r in rows_k if r[0] > 0]
    for us, count, key in sorted(rows_k, reverse=True)[:6]:
        log("imperative:   %8.3f ms  x%-3d %s" % (us / 1e3, count, key[:90]))
    launches = main["launches"]
    log("imperative: each rtc kernel once per step (kernel counts %s)"
        % launches)

    for mode in ("bulked", "eager"):
        with bulking(mx, mode == "bulked"):
            s0 = eng.stats.bulk_segments
            plain = dispatch_rate(mx, ctx, record=False)
            recorded = dispatch_rate(mx, ctx, record=True)
            segs = eng.stats.bulk_segments - s0
        log("imperative: dispatch (%s) over a 20-op chain on (64, 64) f32: "
            "%.0f ops/s plain, %.0f ops/s under record() with backward(); "
            "%d segments flushed" % (mode, plain, recorded, segs))
    big = mx.nd.ones((8192, 8192), ctx=ctx)

    def chain():
        a = big
        for i in range(20):
            a = (a + 1.0) if i % 2 else (a * 1.0009765625)
        return a

    chain().wait_to_read()
    mx.waitall()
    t0 = time.perf_counter()
    out = chain()
    t_enqueue = time.perf_counter() - t0
    mx.waitall()
    t_all = time.perf_counter() - t0
    value = float(out[0, 0].asscalar())
    log("imperative: a 20-op chain on (8192, 8192) f32 was deferred and "
        "enqueued in %.3f ms; waitall() (one segment replay) returned after "
        "%.3f ms (value %.6f)" % (1e3 * t_enqueue, 1e3 * t_all, value))
    if not t_enqueue < 0.5 * t_all or not math.isfinite(value):
        fail("the engine is not asynchronous: enqueue %.3f ms of %.3f ms"
             % (1e3 * t_enqueue, 1e3 * t_all))
    return {w: (n, launches[n]) for w, n in zip(("fwd", "bwd"), names)}


def start_profiler(dev):
    """The profiler's first session starts CUPTI, slowly: open one before
    anything is timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev)


def bulking(mx, on):
    """The engine's default (bulking on) or ``bulk(0)`` (every op eager)."""
    return contextlib.nullcontext() if on else mx.engine.bulk(0)


def imperative_parity(mx, dev):
    """The imperative step in f32 with TF32 off at width 256 / 512 and 64
    tokens, once on the card (the rtc kernels) and once on the host
    (PallasKernel bodies over the plain SwiGLU): the loss and every
    gradient and updated weight must agree."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = mlp_numpy(256, 512, 64, seed=3)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        kern = SwigluKernels(mx)
        SwiGLU = swiglu_function(mx, kern)
        params, x, target = mlp_arrays(mx, arrays, ctx)
        loss = mlp_step(mx, params, x, target, lambda a, b: SwiGLU()(a, b),
                        0.5)
        if ctx.device_type == "gpu" and [
                kern.kernel(w, torch.float32).launches
                for w in ("fwd", "bwd")] != [1, 1]:
            fail("the card's f32 step did not launch the rtc kernels")
        res.append((float(loss.asscalar()),
                    [w.grad.asnumpy() for w in params],
                    [w.asnumpy() for w in params]))
    (l_card, g_card, w_card), (l_host, g_host, w_host) = res
    worst_g = max(np.abs(a - b).max() / np.abs(b).max()
                  for a, b in zip(g_card, g_host))
    worst_w = max(np.abs(a - b).max() / np.abs(b).max()
                  for a, b in zip(w_card, w_host))
    log("imperative parity: f32 loss card %.7f host %.7f; worst gradient "
        "error %.3g and worst updated-weight error %.3g of the tensor's max "
        "(tolerance 1e-4)" % (l_card, l_host, worst_g, worst_w))
    if abs(l_card - l_host) > 1e-5 * abs(l_host) or worst_g > 1e-4 or \
            worst_w > 1e-4:
        fail("the card's imperative step disagrees with the host's")


# -- phase 13: ResNet-50, the repo's headline workload ---------------------

RESNET_IMAGE = 224
RESNET_BATCH = 256                # bench.py's is 384 on a v5e: run if it fits
RESNET_BIG_BATCH = 384
RESNET_INFER_BATCHES = (32, 256)  # 32 is bench.py infer's row
RESNET_SMALL = dict(name="resnet18_v1", batch=8, image=64)


@contextlib.contextmanager
def exact_convs(deterministic=True):
    """f32 convolutions and products in IEEE f32 (TF32 off) and
    deterministic cuDNN algorithms without autotuning, for the checks
    that compare bits or hold the card to the host; with
    ``deterministic=False``, cuDNN autotuned, for the timed runs."""
    import torch

    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = deterministic
    b.cudnn.benchmark = not deterministic
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def resnet_net(dev, name, seed, **kw):
    """``vision.get_model(name)`` on ``dev``, Xavier from a seeded
    generator: the deferred shapes are filled from the same generator at
    the first forward, so two nets from one seed are equal."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, device=dev, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net.initialize(initializer.Xavier(), generator=gen)
    return net


def resnet_shapes(net, x):
    """One predict-mode forward under ``no_grad`` on ``x``: the deferred
    shapes are made and filled (the running statistics stay as they
    are).  Returns the model FLOP of one train step on ``x`` (2 x the
    multiply-adds of every convolution and dense layer, from their
    shapes in this forward, x 3: the backward takes twice the forward's)
    and the (shape, axis) of every BatchNorm's input."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    macs, bns, hooks = [0], [], []

    def numel(out):      # a tensor, or an NDArray where one came in
        return out.numel() if isinstance(out, torch.Tensor) else out.size

    def conv(m, inp, out):
        macs[0] += numel(out) * math.prod(m.weight.shape[1:])

    def dense(m, inp, out):
        macs[0] += numel(out) * m.weight.shape[1]

    def bn(m, inp, out):
        bns.append((tuple(inp[0].shape), m._axis))

    for m in net.modules():
        hook = conv if isinstance(m, _Conv) else dense \
            if isinstance(m, nn.Dense) else bn \
            if isinstance(m, nn.BatchNorm) else None
        if hook is not None:
            hooks.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad(), autograd.predict_mode():
            net(x)
    finally:
        for h in hooks:
            h.detach()
    return 3 * 2 * macs[0], bns


def resnet_parity(dev):
    """ResNet-50 v1 at 224 x 224, batch 2, f32, TF32 off: the card
    (channels-last, cuDNN) against the host (NCHW) from the same
    weights: train-mode logits and loss, the gradients of the stem
    convolution, one bottleneck's BatchNorm gamma and the output layer,
    the running statistics after that step, and predict-mode logits.
    Each is held to the host's f64 run of the same step: the card's
    error within 1e-3 of the largest value, or within 3x the host f32
    run's own error where that is larger (at batch 2 the BatchNorms'
    backward cancels heavily, and the deep gradients of any f32 run
    are off by a few percent)."""
    import torch

    from mxnet_tpu_torch import autograd, gluon

    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, 2).astype(np.float32)
    host = resnet_net("cpu", "resnet50_v1", 1)
    resnet_shapes(host, torch.from_numpy(x))
    card = resnet_net(dev, "resnet50_v1", 1)
    resnet_shapes(card, torch.from_numpy(x).to(dev))
    card.load_state_dict(host.state_dict())
    wide = resnet_net("cpu", "resnet50_v1", 1)
    resnet_shapes(wide, torch.from_numpy(x))
    wide.load_state_dict(host.state_dict())
    wide.double()
    names = ("features.0.weight", "features.5.0.body.1.gamma",
             "output.weight")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    with exact_convs():
        for net in (card, host, wide):
            where = next(net.parameters()).device
            xt = torch.from_numpy(x).to(where, next(net.parameters()).dtype)
            params = net._collect_params_with_prefix()
            with autograd.record():
                out = net(xt)
                loss = loss_fn(out, torch.from_numpy(y).to(where)).mean()
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            with torch.no_grad():
                pred = net(xt)
            stats = torch.cat([t.reshape(-1) for k, t in params.items()
                               if "running" in k])
            res.append([t.detach().double().cpu()
                        for t in (out, loss, *grads, stats, pred)])
    labels = ("train logits", "loss") + tuple("grad " + n for n in names) \
        + ("running statistics after the step", "predict logits")
    ok = True
    for label, c, h, w in zip(labels, *res):
        scale = w.abs().max().item() + 1e-30
        e_card = (c - w).abs().max().item() / scale
        e_host = (h - w).abs().max().item() / scale
        bound = max(1e-3, 3 * e_host)
        ok &= e_card <= bound
        log("resnet parity: %s: card %.3g, host f32 %.3g of the largest "
            "value (%.4g) from the host's f64 run (bound %.3g) %s"
            % (label, e_card, e_host, scale, bound,
               "ok" if e_card <= bound else "FAIL"))
    log("resnet parity: ResNet-50 v1, 224 x 224, batch 2, f32, TF32 off, "
        "card %s against host %s: %s" % (card._layout, host._layout,
                                         "ok" if ok else "FAIL"))
    if not ok:
        fail("the card's ResNet-50 disagrees with the host's")


def _resnet_batch(dev, batch, image, seed, dtype=None):
    """Seeded images in [0, 1) and labels, as bench.py makes them."""
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(batch, 3, image, image)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, batch).astype(np.float32)) \
        .to(dev)
    return (x if dtype is None else x.to(dtype)), y


def _state(net):
    """Copies of a net's weights and running statistics, by name."""
    return {k: t.detach().clone()
            for k, t in net._collect_params_with_prefix().items()}


def _same(a, b):
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def resnet_train_step_check(dev, name, batch, image):
    """f32, TF32 off, deterministic cuDNN: ``JitTrainStep`` (sgd 0.1,
    momentum 0.9) graphed against ``graphs=False``: 3 steps with the
    learning rate changed before the third, then ``step_n(4)`` against
    four ``step()`` calls: losses, weights and running statistics
    bitwise equal, one capture and 6 replays."""
    import torch

    from mxnet_tpu_torch import gluon, parallel

    x, y = _resnet_batch(dev, batch, image, 2)
    runs = []
    with exact_convs():
        for graphs in (False, True):
            net = resnet_net(dev, name, 2)
            step = parallel.JitTrainStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, graphs=graphs)
            losses = []
            for i in range(3):
                if i == 2:
                    step._opt.set_learning_rate(0.05)
                losses.append(step.step(x, y).clone())
            losses.append(step.step_n(4, x, y).clone())
            runs.append((losses, _state(net), step.stats()))
            del step, net
    (e_loss, e_w, _), (g_loss, g_w, st) = runs
    same_loss = all(torch.equal(a, b) for a, b in zip(e_loss, g_loss))
    same_w = _same(e_w, g_w)
    log("resnet graphs: %s %d x %d, batch %d, f32: JitTrainStep sgd "
        "momentum, 3 steps (lr 0.1, then 0.05) and step_n(4): losses %s; "
        "graphed against eager: losses %s, weights and running statistics "
        "%s; %d capture, %d replays"
        % (name, image, image, batch, ["%.5f" % v.item() for v in e_loss],
           "bitwise equal" if same_loss else "DIFFER",
           "bitwise equal" if same_w else "DIFFER", st["captures"],
           st["replays"]))
    if not (same_loss and same_w):
        fail("the graphed ResNet JitTrainStep is not bitwise equal to eager")
    if (st["captures"], st["replays"]) != (1, 6):
        fail("the graphed ResNet step did not capture once and replay 6 "
             "times")


def resnet_hybrid_forward_check(dev, name, batch, image):
    """f32, TF32 off, deterministic cuDNN: the hybridized forward
    (eager, captured, replayed) against eager, bitwise: under
    ``no_grad`` in predict mode, and in train mode, where each call
    writes the running statistics (3 calls: the statistics after them
    bitwise equal too)."""
    import torch

    from mxnet_tpu_torch import autograd

    x, _ = _resnet_batch(dev, batch, image, 3)
    with exact_convs():
        outs = []
        for hybrid in (False, True):
            net = resnet_net(dev, name, 3)
            resnet_shapes(net, x)
            if hybrid:
                net.hybridize()
            with torch.no_grad():
                pred = [net(x).clone() for _ in range(3)]
                with autograd.train_mode():
                    train = [net(x).clone() for _ in range(3)]
            outs.append((pred, train, _state(net),
                         net.stats() if hybrid else None))
            del net
    (e_p, e_t, e_w, _), (h_p, h_t, h_w, st) = outs
    same = all(torch.equal(a, b) for a, b in zip(e_p + e_t, h_p + h_t))
    same_w = _same(e_w, h_w)
    log("resnet graphs: %s, batch %d, f32: hybridized no_grad forward, 3 "
        "predict-mode and 3 train-mode calls: outputs %s, running "
        "statistics %s; %d captures, %d replays"
        % (name, batch, "bitwise equal" if same else "DIFFER",
           "bitwise equal" if same_w else "DIFFER", st["captures"],
           st["replays"]))
    if not (same and same_w):
        fail("the hybridized ResNet forward is not bitwise equal to eager")
    if (st["captures"], st["replays"]) != (2, 4):
        fail("the hybridized forward did not capture once a mode")


def resnet_recorded_trainer_check(dev, name, batch, image):
    """f32, TF32 off, deterministic cuDNN: 3 ``gluon.Trainer`` steps
    (sgd 0.1, momentum 0.9) under ``record()`` through the hybridized
    net's graph pair (BatchNorm writing its running statistics inside
    the forward graph) against eager: losses, weights and running
    statistics bitwise equal; one capture, 2 forward and 2 backward
    replays."""
    import torch

    from mxnet_tpu_torch import autograd, gluon

    x, y = _resnet_batch(dev, batch, image, 4)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    with exact_convs():
        for hybrid in (False, True):
            net = resnet_net(dev, name, 4)
            resnet_shapes(net, x)
            if hybrid:
                net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
            losses = []
            for _ in range(3):
                with autograd.record():
                    loss = loss_fn(net(x), y).sum()
                loss.backward()
                trainer.step(batch)
                losses.append(loss.detach().clone())
            runs.append((losses, _state(net),
                         net.stats() if hybrid else None))
            del net, trainer
    (e_l, e_w, _), (h_l, h_w, st) = runs
    same_l = all(torch.equal(a, b) for a, b in zip(e_l, h_l))
    same_w = _same(e_w, h_w)
    moved = not torch.equal(
        e_w["features.1.running_var"],
        torch.ones_like(e_w["features.1.running_var"]))
    log("resnet graphs: %s, batch %d, f32: 3 Trainer sgd steps under "
        "record() through the graph pair: losses %s; hybridized against "
        "eager: losses %s, weights and running statistics %s (statistics "
        "moved: %s); %d capture, %d forward and %d backward replays"
        % (name, batch, ["%.4f" % v.item() for v in e_l],
           "bitwise equal" if same_l else "DIFFER",
           "bitwise equal" if same_w else "DIFFER", moved, st["captures"],
           st["replays"], st["backward_replays"]))
    if not (same_l and same_w and moved):
        fail("the recorded hybridized ResNet step is not bitwise equal to "
             "eager")
    if (st["captures"], st["replays"], st["backward_replays"]) != (1, 2, 2):
        fail("the recorded ResNet call did not capture once and replay "
             "twice")


def kernel_rows(averages, top=12):
    """Device ms, launches and name of each kernel in a profile, largest
    first, with the convolutions' share (cuDNN's and CUTLASS's kernels
    by name)."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in averages if e.self_device_time_total > 0),
                  reverse=True)
    rows = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    conv = sum(r[0] for r in rows if any(
        s in r[2].lower() for s in ("conv", "cudnn", "xmma", "implicit",
                                    "sm90_", "cutlass", "nhwc", "dgrad",
                                    "wgrad")))
    return rows[:top], conv, sum(r[0] for r in rows)


def resnet_layer_times(dev, bn_shapes, net, dtype):
    """The layers the step cannot show apart, each alone on the card:
    every BatchNorm of the net forward and backward in train mode at its
    input shape (kernel busy ms, one profiled pass after a warm-up), and
    the SGD-momentum update of every weight with a device learning rate
    as ``JitTrainStep`` runs it."""
    import torch

    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.ops import nn as nn_ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ins = []
    for shape, axis in bn_shapes:
        c = shape[axis]
        ins.append((torch.randn(shape, device=dev, generator=gen)
                    .to(dtype).contiguous(), axis,
                    torch.ones(c, device=dev, requires_grad=True),
                    torch.zeros(c, device=dev, requires_grad=True),
                    torch.zeros(c, device=dev), torch.ones(c, device=dev)))
    ins = [(x.requires_grad_(), *rest) for x, *rest in ins]

    def bn_pass():
        for x, axis, g, b, mm, mv in ins:
            out, _, _ = nn_ops._batch_norm(x, g, b, mm, mv, eps=1e-5,
                                           fix_gamma=False, axis=axis,
                                           _mode="train")
            torch.autograd.grad(out, (x, g, b), torch.ones_like(out))

    bn_pass()
    _, bn_wall, bn_busy, _ = profiled_step(bn_pass)
    elements = sum(math.prod(s) for s, _ in bn_shapes)
    del ins
    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    params = [p.detach().clone() for p in net.parameters()
              if p.requires_grad]
    grads = [torch.empty_like(p).copy_(torch.randn(p.shape, device=dev,
                                                   generator=gen))
             for p in params]
    states = [opt.create_state(i, p.detach()) for i, p in enumerate(params)]
    lr = torch.full((), 0.1, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def update():
        opt._step_multi(params, grads, states, lr, [0.0] * len(params),
                        count)

    update()
    _, sgd_wall, sgd_busy, sgd_avg = profiled_step(update)
    n = sum(p.numel() for p in params)
    log("resnet layers: %d BatchNorms forward + backward alone (%.4g G "
        "activation elements, %s): kernels busy %.3f ms (wall %.3f ms)"
        % (len(bn_shapes), elements / 1e9, dtype, bn_busy, bn_wall * 1e3))
    log("resnet layers: the SGD-momentum update alone (%d weights, %.4g M "
        "elements, device lr; O2, one launch a dtype): kernels busy %.3f ms "
        "(wall %.3f ms); top %s"
        % (len(params), n / 1e6, sgd_busy, sgd_wall * 1e3,
           ["%.3f ms x%d %s" % r for r in kernel_rows(sgd_avg, 3)[0]]))
    return bn_busy, sgd_busy


def resnet_train_run(dev, batch, keep_net=False):
    """ResNet-50 v1 at 224 x 224, 1000 classes, amp bf16, sgd lr 0.1,
    momentum 0.9, through ``JitTrainStep`` on seeded random images and
    labels: every step eager (``graphs=False``), then graphed, 2 warm-up,
    8 timed and 1 profiled step each, then one ``step_n(10)`` window."""
    import torch

    from mxnet_tpu_torch import amp, gluon, parallel
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = resnet_net(dev, "resnet50_v1", 0)
    amp.convert_hybrid_block(net)
    x, y = _resnet_batch(dev, batch, RESNET_IMAGE, 0, torch.bfloat16)
    step_flops, bn_shapes = resnet_shapes(net, x)
    n_params = sum(p.numel() for p in net.parameters())
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, graphs=False)
    log("resnet train: ResNet-50 v1, %.4g M parameters (bf16, BatchNorm "
        "f32), %s, batch %d at %d x %d, %.4g TFLOP a step (3 x 2 x the "
        "conv and dense multiply-adds), set-up %.1f s; cudnn.benchmark %s, "
        "cudnn.allow_tf32 %s, matmul.allow_tf32 %s"
        % (n_params / 1e6, net._layout, batch, RESNET_IMAGE, RESNET_IMAGE,
           step_flops / 1e12, time.perf_counter() - t0,
           torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))
    losses, rows = [], {}
    n_warm, n_timed = 2, 8
    reset_opt_counts(oo)
    for mode in ("eager", "graphed"):
        step.graphs = mode == "graphed"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(lambda: step.step(x, y), n_warm, n_timed)
        losses += [o.item() for o in outs]
        out, wall, busy, averages = profiled_step(lambda: step.step(x, y))
        losses.append(out.item())
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated(), step.stats())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last = step.step_n(10, x, y)
    torch.cuda.synchronize()
    window = time.perf_counter() - t1
    losses.append(last.item())
    o2 = opt_counts(oo)["O2"]
    n_steps = 2 * (n_warm + n_timed + 1) + 10
    log("resnet train: batch %d: O2 launched %d times over %d steps"
        % (batch, o2, n_steps))
    if o2 < n_steps:
        fail("the ResNet-50 SGD update launched O2 %d times over %d steps"
             % (o2, n_steps))
    log("resnet train: batch %d losses %s" % (batch, ["%.4f" % v
                                                      for v in losses]))
    if not all(math.isfinite(v) for v in losses):
        fail("a ResNet-50 train loss is not finite")
    # At lr 0.1 and momentum 0.9 the loss on one batch of random labels
    # falls over the first steps, then swings (between about 5 and 11
    # from step 14 to 32), identically eager, graphed or through the
    # plain SGD update (tools/torch_resnet_trajectory.py): the check
    # reads the early descent, where the last step lands is only logged.
    log("resnet train: batch %d loss at step 4 %.4f, at the last step "
        "%.4f, against %.4f at the first"
        % (batch, losses[3], losses[-1], losses[0]))
    if not losses[3] < 0.9 * losses[0]:
        fail("the ResNet-50 loss did not fall over the first steps on the "
             "fixed batch")
    st = step.stats()
    if st["captures"] != 1 or st["replays"] != n_warm + n_timed + 10:
        fail("the graphed ResNet-50 step did not capture once and replay "
             "(%s)" % st)
    result = {"batch": batch, "O2": o2}
    for mode, (times, wall, busy, averages, peak, st) in rows.items():
        p50_s = times[len(times) // 2]
        top, conv_ms, kern_ms = kernel_rows(averages)
        log("resnet train: batch %d %s step ms p50 %.3f (min %.3f max %.3f "
            "over %d timed steps), %.1f images/s, %.1f%% MFU (%.4g model "
            "FLOP a step at 989 TFLOP/s bf16), peak device memory %.2f GB "
            "(%.2f GB held before the run)"
            % (batch, mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), batch / p50_s,
               100 * step_flops / p50_s / BF16_FLOPS, step_flops,
               peak / 1e9, held / 1e9))
        log("resnet train: batch %d %s profiled step: wall %.3f ms, kernels "
            "busy %.3f ms (union of intervals), idle %.1f%%; kernels summed "
            "%.3f ms, convolution kernels %.3f ms (%.1f%%)"
            % (batch, mode, wall * 1e3, busy,
               100 * (1 - busy / (wall * 1e3)), kern_ms, conv_ms,
               100 * conv_ms / max(kern_ms, 1e-9)))
        for ms, n, key in top:
            log("resnet train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        log("resnet train: batch %d %s profiled step: the SGD update's "
            "kernels (O2) %.3f ms" % (batch, mode,
                                      update_kernel_ms(averages)))
        result[mode] = dict(p50_ms=1e3 * p50_s, images_s=batch / p50_s,
                            peak_gb=(peak - held) / 1e9)
        if mode == "graphed":
            log("resnet train: batch %d graphed: %d capture in %.3f s, %d "
                "replays, %.1f us host time a replay outside it, graph pool "
                "%.1f MB" % (batch, st["captures"], st["capture_s"],
                             st["replays"],
                             1e6 * st["host_s"] / max(st["replays"], 1),
                             st["pool_bytes"] / 1e6))
    log("resnet train: batch %d step_n(10): %.3f s, %.1f images/s, %.3f ms "
        "a step" % (batch, window, 10 * batch / window, 100 * window))
    result["step_n_images_s"] = 10 * batch / window
    del step
    gc.collect()
    torch.cuda.empty_cache()
    if keep_net:
        result["bn_ms"], result["sgd_ms"] = resnet_layer_times(
            dev, bn_shapes, net, torch.bfloat16)
        return result, net
    return result, None


def resnet_infer(net, dev):
    """``no_grad`` predict-mode forward of the trained bf16 net, eager
    against hybridized (eager first call, capture, replays), at each of
    RESNET_INFER_BATCHES: wall p50 of 10 synchronised calls after 3."""
    import torch

    for batch in RESNET_INFER_BATCHES:
        x, _ = _resnet_batch(dev, batch, RESNET_IMAGE, 6, torch.bfloat16)
        net.hybridize(False)
        eager, want = timed_forward(net, x, 13)
        net.hybridize()
        hyb, got = timed_forward(net, x, 13)
        eager, hyb = sorted(eager[3:]), sorted(hyb[3:])
        if not bool(torch.isfinite(got.float()).all()):
            fail("non-finite ResNet-50 logits")
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        st = net.stats()
        log("resnet infer: batch %d, bf16, no_grad: eager ms p50 %.3f (min "
            "%.3f max %.3f), %.1f images/s; hybridized ms p50 %.3f (min "
            "%.3f max %.3f), %.1f images/s; logits %s (%.3g of the largest);"
            " %d capture, %d replays"
            % (batch, eager[len(eager) // 2], eager[0], eager[-1],
               1e3 * batch / eager[len(eager) // 2], hyb[len(hyb) // 2],
               hyb[0], hyb[-1], 1e3 * batch / hyb[len(hyb) // 2],
               "bitwise equal" if err == 0 else "differ", err,
               st["captures"], st["replays"]))
        if err > 1e-2:
            fail("the hybridized ResNet-50 forward disagrees with eager")
    net.hybridize(False)


def resnet_phase(dev):
    """f32 card-against-host checks at ResNet-50's full size, the
    graphed-against-eager checks at RESNET_SMALL, then the main path:
    ResNet-50 v1 trained through ``JitTrainStep`` under amp bf16 at
    batch 256 (and 384 where it fits), and its hybridized inference."""
    import torch

    from mxnet_tpu_torch import amp

    start_profiler(dev)
    resnet_parity(dev)
    small = RESNET_SMALL
    for check in (resnet_train_step_check, resnet_hybrid_forward_check,
                  resnet_recorded_trainer_check):
        check(dev, small["name"], small["batch"], small["image"])
    gc.collect()
    torch.cuda.empty_cache()
    # the timed run: autotuned cuDNN, no TF32 (its convolutions are bf16)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    amp.init("bfloat16")
    try:
        first, net = resnet_train_run(dev, RESNET_BATCH, keep_net=True)
        o2 = first["O2"]
        total = torch.cuda.get_device_properties(dev).total_memory
        need = first["graphed"]["peak_gb"] * 1e9 \
            * RESNET_BIG_BATCH / RESNET_BATCH + torch.cuda.memory_allocated()
        if need < 0.9 * total:
            o2 += resnet_train_run(dev, RESNET_BIG_BATCH)[0]["O2"]
        else:
            log("resnet train: batch %d not run: it would need about %.1f "
                "GB of the card's %.1f" % (RESNET_BIG_BATCH, need / 1e9,
                                           total / 1e9))
        resnet_infer(net, dev)
    finally:
        amp.turn_off()
        torch.backends.cudnn.benchmark = False
    return o2


# -- phase 14: bert, the second headline workload --------------------------

BERT_B, BERT_T = 32, 128          # bench.py's BERT batch (_run_bert)
BERT_VOCAB = 30522
BERT_BASE = dict(units=768, hidden_size=3072, num_layers=12, num_heads=12)
BERT_SMALL_VOCAB = 1000


def bert_net(dev, seed, vocab=None, small=False, **kw):
    """``bert_base`` (or ``bert_small``) on ``dev``, vocab ``BERT_VOCAB``
    unless given, Xavier from a seeded generator."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import bert

    make = bert.bert_small if small else bert.bert_base
    net = make(vocab_size=vocab or BERT_VOCAB, device=dev, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net.initialize(initializer.Xavier(), generator=gen)
    return net


def mlm_wrapper(gluon, vocab):
    """``bench.py``'s MLM wrapper: the tied head's logits flattened to
    (B*T, V)."""
    class MLM(gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, toks):
            return self.inner(toks)[2].reshape(-1, vocab)

    return MLM


def bert_batch(dev, batch, t, vocab, seed):
    """Seeded random tokens, token types and MLM labels (one a token)."""
    import torch

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (batch, t)).astype(np.int32)
    types = rng.randint(0, 2, (batch, t)).astype(np.int32)
    labels = rng.randint(0, vocab, batch * t).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (toks, types, labels))


def bert_parity(dev):
    """``bert_base``'s width (768 units, 12 heads, FFN 3072, vocab
    30,522), 2 layers, f32 with TF32 off, batch 2 x 128 with token
    types: the card (K1-K3 on their f32 path) against the host's CPU
    (the plain versions) from the same weights.  ``seq``, ``pooled``,
    ``logits`` and the MLM loss within 1e-4 of each one's largest
    magnitude; the gradients of ``word_embed.weight`` (tied: the
    embedding's and the head's contributions), one layer's
    ``attn.qkv.weight`` and ``ln1.gamma`` within 1e-3 of theirs."""
    import torch

    from mxnet_tpu_torch import autograd, gluon

    host = bert_net("cpu", 1, num_layers=2)
    card = bert_net(dev, 1, num_layers=2)
    card.load_state_dict(host.state_dict())
    toks, types, labels = bert_batch("cpu", 2, BERT_T, BERT_VOCAB, 1)
    names = ("word_embed.weight", "encoder.layers.0.attn.qkv.weight",
             "encoder.layers.0.ln1.gamma")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    with exact_convs():
        for net in (card, host):
            where = next(net.parameters()).device
            params = dict(net.named_parameters())
            with autograd.record():
                seq, pooled, logits = net(toks.to(where), types.to(where))
                loss = loss_fn(logits.reshape(-1, BERT_VOCAB),
                               labels.to(where)).mean()
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            res.append([t.detach().double().cpu()
                        for t in (seq, pooled, logits, loss, *grads)])
    what = ("seq", "pooled", "logits", "MLM loss") \
        + tuple("grad " + n for n in names)
    ok = True
    for i, (label, c, h) in enumerate(zip(what, *res)):
        scale = h.abs().max().item() + 1e-30
        err = (c - h).abs().max().item() / scale
        bound = 1e-4 if i < 4 else 1e-3
        ok &= err <= bound
        log("bert parity: %s: card against host %.3g of the largest value "
            "(%.4g), bound %.0e %s" % (label, err, scale, bound,
                                       "ok" if err <= bound else "FAIL"))
    if not ok:
        fail("the card's BERT disagrees with the host's")


def _bert_losses_equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def bert_train_step_check(dev):
    """``bert_small`` (vocab 1000), f32 with TF32 off, batch 4 x 32:
    ``JitTrainStep`` with adam (1e-3) over the MLM wrapper, graphed
    against ``graphs=False``: 3 steps with the learning rate changed
    before the third, then ``step_n(3)``: losses and weights bitwise
    equal, one capture and 5 replays."""
    from mxnet_tpu_torch import gluon, parallel

    toks, _, labels = bert_batch(dev, 4, 32, BERT_SMALL_VOCAB, 2)
    runs = []
    with exact_convs():
        for graphs in (False, True):
            net = bert_net(dev, 2, BERT_SMALL_VOCAB, small=True)
            step = parallel.JitTrainStep(
                mlm_wrapper(gluon, BERT_SMALL_VOCAB)(net),
                gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": 1e-3}, graphs=graphs)
            losses = []
            for i in range(3):
                if i == 2:
                    step._opt.set_learning_rate(5e-4)
                losses.append(step.step(toks, labels).clone())
            losses.append(step.step_n(3, toks, labels).clone())
            runs.append((losses, _state(net), step.stats()))
            del step, net
    (e_loss, e_w, _), (g_loss, g_w, st) = runs
    same_loss, same_w = _bert_losses_equal(e_loss, g_loss), _same(e_w, g_w)
    log("bert graphs: bert_small, f32, batch 4 x 32: JitTrainStep adam, 3 "
        "steps (lr 1e-3, then 5e-4) and step_n(3): losses %s; graphed "
        "against eager: losses %s, weights %s; %d capture, %d replays"
        % (["%.5f" % v.item() for v in e_loss],
           "bitwise equal" if same_loss else "DIFFER",
           "bitwise equal" if same_w else "DIFFER", st["captures"],
           st["replays"]))
    if not (same_loss and same_w):
        fail("the graphed BERT JitTrainStep is not bitwise equal to eager")
    if (st["captures"], st["replays"]) != (1, 5):
        fail("the graphed BERT step did not capture once and replay 5 "
             "times")


def bert_hybrid_checks(dev):
    """``bert_small`` (vocab 1000), f32 with TF32 off, batch 4 x 32 with
    token types, hybridized against eager, bitwise: the ``no_grad``
    forward (``seq``, ``pooled``, ``logits``; 3 calls), then 3
    ``gluon.Trainer`` adam steps under ``record()`` through the graph
    pair (losses and weights; the tied ``word_embed.weight`` takes both
    contributions in the backward graph), then the ``grad_req="write"``
    rule through the pair: two more recorded forward and backward
    passes leave one pass's gradients, equal to the eager net's."""
    import torch

    from mxnet_tpu_torch import autograd, gluon

    toks, types, labels = bert_batch(dev, 4, 32, BERT_SMALL_VOCAB, 3)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    with exact_convs():
        for hybrid in (False, True):
            net = bert_net(dev, 3, BERT_SMALL_VOCAB, small=True)
            if hybrid:
                net.hybridize()
            with torch.no_grad():
                fwd = [o.clone() for _ in range(3)
                       for o in net(toks, types)]
            trainer = gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-3})

            def loss_of():
                with autograd.record():
                    logits = net(toks, types)[2]
                    loss = loss_fn(logits.reshape(-1, BERT_SMALL_VOCAB),
                                   labels).mean()
                loss.backward()
                return loss.detach().clone()

            losses = []
            for _ in range(3):
                losses.append(loss_of())
                # the pooler is off the MLM loss's path
                trainer.step(1, ignore_stale_grad=True)
            grads = []
            for _ in range(2):
                loss_of()
                grads.append({k: p.grad.clone()
                              for k, p in net.named_parameters()
                              if p.grad is not None})
            runs.append((fwd, losses, _state(net), grads,
                         net.stats() if hybrid else None))
            del net, trainer
    (e_f, e_l, e_w, e_g, _), (h_f, h_l, h_w, h_g, st) = runs
    same_f = _bert_losses_equal(e_f, h_f)
    same_l, same_w = _bert_losses_equal(e_l, h_l), _same(e_w, h_w)
    write = all(_same(g[0], g[1]) for g in (e_g, h_g))
    # the pair's backward graph gives the pooler (off the loss's path) a
    # zero gradient where eager autograd gives none, as the JAX
    # package's cached vjp and its imperative autograd differ
    extra = set(h_g[0]) - set(e_g[0])
    same_g = _same(e_g[0], {k: h_g[0][k] for k in e_g[0]}) and all(
        not h_g[0][k].any() for k in extra)
    log("bert graphs: bert_small, f32, batch 4 x 32: hybridized no_grad "
        "forward (seq, pooled, logits; 3 calls) %s; 3 Trainer adam steps "
        "under record() through the graph pair: losses %s, hybridized "
        "against eager: losses %s, weights %s; two more backward passes "
        "give one pass's gradients: eager %s, hybridized %s, hybridized "
        "against eager %s (%s zero through the pair, none eager); %d "
        "captures, %d replays, %d backward replays"
        % ("bitwise equal" if same_f else "DIFFER",
           ["%.5f" % v.item() for v in e_l],
           "bitwise equal" if same_l else "DIFFER",
           "bitwise equal" if same_w else "DIFFER",
           _same(e_g[0], e_g[1]), _same(h_g[0], h_g[1]),
           "bitwise equal" if same_g else "DIFFER", sorted(extra),
           st["captures"], st["replays"], st["backward_replays"]))
    if not (same_f and same_l and same_w and write and same_g):
        fail("the hybridized BERT is not bitwise equal to eager, or a "
             "second backward added to the gradients")
    # the no_grad call: 1 capture, 2 replays; the recorded one: 5 calls,
    # 1 capture, 4 forward and 4 backward replays
    if (st["captures"], st["replays"], st["backward_replays"]) != (2, 6, 4):
        fail("the hybridized BERT did not capture once a signature (%s)"
             % st)


def bert_train_run(dev):
    """BERT-base (12 layers x 768 units, 12 heads, FFN 3072, vocab
    30,522) under amp bf16, adam 1e-4, through ``JitTrainStep`` over
    ``bench.py``'s MLM wrapper on a fixed batch of 32 x 128 seeded random
    tokens and labels: every step eager (``graphs=False``), then graphed
    (2 warm-up, 8 timed and 1 profiled step each), then one
    ``step_n(10)`` window.  Returns the kernels' launch counts over
    those steps and the trained net."""
    import torch

    from mxnet_tpu_torch import amp, gluon, parallel
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = bert_net(dev, 0)
    amp.convert_hybrid_block(net)
    toks, _, labels = bert_batch(dev, BERT_B, BERT_T, BERT_VOCAB, 0)
    layers, units = BERT_BASE["num_layers"], BERT_BASE["units"]
    n_params = sum(p.numel() for p in net.parameters())
    layer_w = sum(p.numel() for n, p in net.named_parameters()
                  if n.startswith("encoder.") and p.dim() == 2)
    head_w = net.word_embed.weight.numel()
    tokens = BERT_B * BERT_T
    # forward + backward = 3 x the forward's two products (q k^T, p v)
    # over every (row, col) pair of every head
    attn_flops = 3 * layers * 4 * BERT_B * BERT_T * BERT_T * units
    step_flops = 6 * tokens * (layer_w + head_w) + attn_flops
    step = parallel.JitTrainStep(
        mlm_wrapper(gluon, BERT_VOCAB)(net),
        gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-4}, graphs=False)
    log("bert train: BERT-base, %d layers x %d units, vocab %d, %.4g M "
        "parameters (bf16; %.4g M in the layers' products, %.4g M in the "
        "tied head), batch %d x %d, %.4g TFLOP a step (6 x tokens x product "
        "weights + %.4g GFLOP of attention), set-up %.1f s"
        % (layers, units, BERT_VOCAB, n_params / 1e6, layer_w / 1e6,
           head_w / 1e6, BERT_B, BERT_T, step_flops / 1e12, attn_flops / 1e9,
           time.perf_counter() - t0))
    counters = ("fwd_launches", "dq_launches", "dkv_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    reset_opt_counts(oo)
    losses, rows = [], {}
    n_warm, n_timed = 2, 8
    for mode in ("eager", "graphed"):
        step.graphs = mode == "graphed"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(lambda: step.step(toks, labels), n_warm,
                                  n_timed)
        losses += [o.item() for o in outs]
        out, wall, busy, averages = profiled_step(
            lambda: step.step(toks, labels))
        losses.append(out.item())
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated(), step.stats())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last = step.step_n(10, toks, labels)
    torch.cuda.synchronize()
    window = time.perf_counter() - t1
    losses.append(last.item())
    launches = {name: getattr(fa.flash_attention, name) for name in counters}
    launches.update(opt_counts(oo))
    n_steps = 2 * (n_warm + n_timed + 1) + 10
    log("bert train: launches over %d steps: %s (K1-K3 must be %d each, "
        "O1 %d)" % (n_steps, launches, layers * n_steps, n_steps))
    for name in counters:
        if launches[name] != layers * n_steps:
            fail("BERT's %s = %d over %d steps of %d layers"
                 % (name, launches[name], n_steps, layers))
    if launches["O1"] != n_steps:
        fail("BERT's adam update launched O1 %d times over %d steps"
             % (launches["O1"], n_steps))
    log("bert train: losses %s" % ["%.4f" % v for v in losses])
    if not all(math.isfinite(v) for v in losses):
        fail("a BERT train loss is not finite")
    # adam 1e-4 on one batch of random labels: the loss falls steadily,
    # from 10.35 to 7.91 over the 32 steps in the first run on the card;
    # the check leaves room for another process's rounding
    log("bert train: loss at the last step %.4f against %.4f at the first "
        "(must be below 90%% of it)" % (losses[-1], losses[0]))
    if not losses[-1] < 0.9 * losses[0]:
        fail("the BERT loss did not fall on the fixed batch")
    st = step.stats()
    if st["captures"] != 1 or st["replays"] != n_warm + n_timed + 10:
        fail("the graphed BERT step did not capture once and replay (%s)"
             % st)
    for mode, (times, wall, busy, averages, peak, st) in rows.items():
        p50_s = times[len(times) // 2]
        top, _, kern_ms = kernel_rows(averages)
        log("bert train: %s step ms p50 %.3f (min %.3f max %.3f over %d "
            "timed steps), %.1f samples/s, %.1f%% MFU (%.4g model FLOP a "
            "step at 989 TFLOP/s bf16), peak device memory %.2f GB (%.2f GB "
            "held before the run)"
            % (mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), BERT_B / p50_s,
               100 * step_flops / p50_s / BF16_FLOPS, step_flops,
               peak / 1e9, held / 1e9))
        log("bert train: %s profiled step: wall %.3f ms (the profiler's "
            "own cost included), kernels busy %.3f ms (union of intervals): "
            "idle %.1f%% of the profiled step, %.1f%% of the p50 step; "
            "kernels summed %.3f ms: %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (1e3 * p50_s)), kern_ms,
               ", ".join("%s %.3f" % kv
                         for kv in kernel_kinds(averages).items())))
        for ms, n, key in top:
            log("bert train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        if mode == "graphed":
            log("bert train: graphed: %d capture in %.3f s, %d replays, %.1f "
                "us host time a replay outside it, graph pool %.1f MB"
                % (st["captures"], st["capture_s"], st["replays"],
                   1e6 * st["host_s"] / max(st["replays"], 1),
                   st["pool_bytes"] / 1e6))
    e50, g50 = (rows[m][0][n_timed // 2] for m in ("eager", "graphed"))
    BERT_JIT_MS.update(eager=1e3 * e50, graphed=1e3 * g50)
    log("bert train: step_n(10): %.3f s, %.1f samples/s, %.3f ms a step; "
        "graphed / eager step p50 %.3f / %.3f ms (%.3fx)"
        % (window, 10 * BERT_B / window, 100 * window, 1e3 * g50, 1e3 * e50,
           e50 / g50))
    o1_err = bert_adam_check(oo, dev, step)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, o1_err, net


def bert_adam_check(oo, dev, step):
    """O1 against its plain version on BERT-base's own list, after the
    main path's launches were read: identical copies of the trained amp
    bf16 weights and adam moments, with seeded gradients in the
    weights' dtype, updated with the main path's adam (class form, its
    learning rate, decays, rescale, clipping and a count of 33).  Each
    of weights and moments is held to ``opt_within`` per dtype; fails on
    a miss.  Returns the worst abs error."""
    import torch

    opt, idx = step._opt, step._train_idx
    ws = [step._params[i].detach() for i in idx]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    grads = [torch.randn(w.shape, generator=gen, device=dev).mul_(2)
             .to(w.dtype) for w in ws]
    states = [step._opt_state[i] for i in idx]
    kw = dict(lr=torch.full((), opt.learning_rate, dtype=torch.float32,
                            device=dev),
              t=torch.full((), 33, dtype=torch.int32, device=dev),
              beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
              rescale_grad=float(opt.rescale_grad),
              clip_gradient=opt._clip(), fold_wd=True)
    mults = [opt._mult(opt.lr_mult, i) for i in idx]
    wds = [opt._get_wd(i) for i in idx]
    copies = []
    for fn in (oo.multi_adamw, oo._multi_adamw_ref):
        w, m, v = ([x.clone() for x in xs] for xs in
                   (ws, [st[0] for st in states], [st[1] for st in states]))
        fn(w, grads, m, v, mults, wds, **kw)
        copies.append((w, m, v))
    err = main_shape_check(
        "O1 over BERT-base's amp list (%d tensors, %.4g M elements, %s; "
        "adam, lr %g, wd %s, rescale %g)"
        % (len(ws), sum(w.numel() for w in ws) / 1e6,
           sorted({str(w.dtype).replace("torch.", "") for w in ws}),
           opt.learning_rate, sorted(set(wds)), opt.rescale_grad),
        dict(zip(("w", "m", "v"), zip(*copies))))
    del copies, grads
    return err


def write_rule_cost(net, phase="bert"):
    """Host us of one outermost block call's ``grad_req="write"`` rule
    over the net's parameters (``block.write_grads``, with a graph holding
    the armed nodes, as in an eager Trainer step), of its node lookup
    alone (through a view), and of the same lookup through
    ``torch.autograd.graph.get_gradient_edge``: median and least of 50
    rounds after 5."""
    import torch
    from torch.autograd.graph import get_gradient_edge

    from mxnet_tpu_torch.gluon import block

    params = [p for p in net.parameters() if p.requires_grad]
    x = torch.zeros((1, 8), dtype=torch.int64, device=params[0].device)
    with torch.enable_grad():
        out = net(x)

        def lookup():
            for p in params:
                p.view_as(p).grad_fn.next_functions[0][0]

        def edge():
            for p in params:
                get_gradient_edge(p).node

        fns = {"write_grads": lambda: block.write_grads(params),
               "lookup": lookup, "edge": edge}
        ts = {name: [] for name in fns}
        # rounds of one call each, so that drift in the host's load
        # falls on all three alike
        for _ in range(55):
            for name, fn in fns.items():
                t0 = time.perf_counter()
                fn()
                ts[name].append(time.perf_counter() - t0)
    del out
    us = {name: (1e6 * sorted(t[5:])[25], 1e6 * min(t[5:]))
          for name, t in ts.items()}
    log("%s write rule: host us per outermost block call over %d "
        "parameters, median (min) of 50: %.1f (%.1f) us (write_grads, "
        "nodes armed); its node lookup through a view %.1f (%.1f) us; the "
        "same lookup through get_gradient_edge %.1f (%.1f) us"
        % (phase, len(params), *us["write_grads"], *us["lookup"],
           *us["edge"]))


BERT_KINDS = (("flash (K1-K3)", ("flash_",)), ("adam (O1)", ("multi_adamw",)),
              ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_")),
              ("softmax and loss", ("softmax", "gather", "scatter")),
              ("norms", ("layer_norm", "gammabeta")),
              ("copies", ("copy",)),
              ("reductions", ("reduce_kernel",)),
              ("elementwise", ("elementwise",)))


def kernel_kinds(averages, kinds=BERT_KINDS):
    """Device ms of a profile's kernels by kind, each kernel counted in
    the first kind whose pattern its name holds (``kinds``; the rest
    under "other")."""
    out = {name: 0.0 for name, _ in kinds}
    out["other"] = 0.0
    for e in averages:
        if e.self_device_time_total <= 0:
            continue
        key = e.key.lower()
        kind = next((name for name, pats in kinds
                     if any(p in key for p in pats)), "other")
        out[kind] += e.self_device_time_total / 1e3
    return out


def bert_infer(net, dev):
    """The trained bf16 net's ``no_grad`` forward at 32 x 128, eager
    against hybridized (eager first call, capture, replays): wall p50 of
    10 synchronised calls after 3, samples/s, and the logits equal."""
    import torch

    toks, _, _ = bert_batch(dev, BERT_B, BERT_T, BERT_VOCAB, 6)
    net.hybridize(False)
    eager, want = timed_forward(net, toks, 13)
    net.hybridize()
    hyb, got = timed_forward(net, toks, 13)
    eager, hyb = sorted(eager[3:]), sorted(hyb[3:])
    if not all(bool(torch.isfinite(o.float()).all()) for o in got):
        fail("non-finite BERT outputs")
    err = max(((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item() for g, w in zip(got, want))
    st = net.stats()
    log("bert infer: batch %d x %d, bf16, no_grad: eager ms p50 %.3f (min "
        "%.3f max %.3f), %.1f samples/s; hybridized ms p50 %.3f (min %.3f "
        "max %.3f), %.1f samples/s; seq, pooled and logits %s (%.3g of the "
        "largest); %d capture, %d replays"
        % (BERT_B, BERT_T, eager[len(eager) // 2], eager[0], eager[-1],
           1e3 * BERT_B / eager[len(eager) // 2], hyb[len(hyb) // 2], hyb[0],
           hyb[-1], 1e3 * BERT_B / hyb[len(hyb) // 2],
           "bitwise equal" if err == 0 else "differ", err, st["captures"],
           st["replays"]))
    if err != 0:
        fail("the hybridized BERT forward differs from eager")
    net.hybridize(False)


def bert_phase(dev):
    """The f32 card-against-host check at BERT-base's width, the
    graphed-against-eager checks at ``bert_small``, then the main path:
    BERT-base trained through ``JitTrainStep`` under amp bf16 at 32 x
    128, and its hybridized inference."""
    import torch

    from mxnet_tpu_torch import amp

    start_profiler(dev)
    bert_parity(dev)
    bert_train_step_check(dev)
    bert_hybrid_checks(dev)
    gc.collect()
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    try:
        launches, o1_err, net = bert_train_run(dev)
        write_rule_cost(net)
        bert_infer(net, dev)
    finally:
        amp.turn_off()
    return launches, o1_err


# -- phase 15: Gluon's parameter layer, data and metrics -------------------

GLUON_SAMPLES = 384        # 12 steps of BERT_B an epoch
GLUON_MASK_ID = 3          # examples/bert/pretrain_mlm.py's mask token
BERT_JIT_MS = {}           # the bert phase's JitTrainStep p50 ms by mode


def mlm_samples(n, t, vocab, seed):
    """``n`` sequences of ``t`` tokens with ``pretrain_mlm.py``'s
    learnable rule (``examples/bert/pretrain_mlm.py:31-41``) at
    ``vocab``: a sixth of the positions masked, each one's label the
    previous token + 1; the other positions' label 0."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(8, vocab, (n, t)).astype(np.int32)
    labels = np.zeros((n, t), np.float32)
    masked = toks.copy()
    for b in range(n):
        pos = rs.choice(np.arange(1, t), t // 6, replace=False)
        labels[b, pos] = (toks[b, pos - 1] + 1) % vocab
        masked[b, pos] = GLUON_MASK_ID
    return masked, labels


def script_mlm(gluon, bert):
    """The MLM wrapper a user writes: a ``HybridBlock`` that builds BERT
    in its name scope and gives the tied head's logits as (B*T, V)."""
    class MLMNet(gluon.HybridBlock):
        def __init__(self, vocab, device, small=False, **kwargs):
            super().__init__(**kwargs)
            self._vocab = vocab
            make = bert.bert_small if small else bert.bert_base
            with self.name_scope():
                self.bert = make(vocab_size=vocab, device=device)

        def forward(self, toks):
            return self.bert(toks)[2].reshape(-1, self._vocab)

    return MLMNet


def gluon_net(dev, seed, vocab=None, small=False):
    """The script's net on ``dev``, Xavier from a seeded generator; the
    pooler and the token-type embedding, which the MLM loss over tokens
    alone does not reach, take no gradient (``grad_req="null"``)."""
    import torch

    from mxnet_tpu_torch import gluon, initializer
    from mxnet_tpu_torch.gluon.model_zoo import bert

    net = script_mlm(gluon, bert)(vocab or BERT_VOCAB, dev, small=small)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net.initialize(initializer.Xavier(), generator=gen)
    for unused in (net.bert.pooler, net.bert.type_embed):
        unused.collect_params().setattr("grad_req", "null")
    return net


def gluon_add_check(dev):
    """``grad_req="add"`` through the graph pair at ``bert_small``, f32
    with TF32 off: two half batches (8 x 32 split in two) accumulated
    through the hybridized net's replays give the full batch's
    gradients (summed losses) within 1e-4 of each one's largest
    magnitude, taken eagerly with ``"write"``; ``zero_grad()`` then
    leaves zeros.  Returns the worst error."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    toks, labels = mlm_samples(8, 32, BERT_SMALL_VOCAB, 5)
    x = mx.nd.array(toks, ctx=mx.gpu(0))
    y = mx.nd.array(labels.reshape(-1), ctx=mx.gpu(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with exact_convs():
        net = gluon_net(dev, 5, BERT_SMALL_VOCAB, small=True)
        params = {k: p for k, p in net.collect_params().items()
                  if p.grad_req != "null"}

        def backward(rows):
            with autograd.record():
                loss = loss_fn(net(x[rows]), y[rows.start * 32:
                                                rows.stop * 32]).sum()
            loss.backward()

        backward(slice(0, 8))
        want = {k: p.grad().asnumpy() for k, p in params.items()}
        net.hybridize()
        for p in params.values():
            p.grad_req = "add"
        for _ in range(2):          # the eager first call, the capture
            backward(slice(0, 4))
            net.zero_grad()
        backward(slice(0, 4))
        backward(slice(4, 8))
        err = max(np.abs(p.grad().asnumpy() - want[k]).max()
                  / max(np.abs(want[k]).max(), 1e-30)
                  for k, p in params.items())
        net.zero_grad()
        cleared = all(not p._tensor.grad.any() for p in params.values())
        st = net.stats()
    log("gluon add: bert_small, f32, %d parameters with grad_req 'add': "
        "two half batches through the graph pair (%d captures, %d "
        "backward replays) against the full batch eagerly: %.3g of the "
        "largest gradient (bound 1e-4); zero_grad() leaves zeros: %s"
        % (len(params), st["captures"], st["backward_replays"], err,
           cleared))
    if not (err <= 1e-4 and cleared and st["backward_replays"] >= 2):
        fail("grad_req 'add' through the graph pair does not accumulate "
             "the full batch's gradients, or zero_grad() left some")
    return err


def gluon_null_change_check(dev):
    """A ``grad_req="null"`` change after a capture, ``bert_small``, f32
    with TF32 off: 3 recorded backward passes (eager, capture, replay),
    then one layer's FFN weight set to ``"null"`` and 2 more; the
    hybridized net's gradients bitwise equal to the eager net's at each
    pass, the frozen weight's ``None`` in both, and a second capture for
    the new gradient signature."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    toks, labels = mlm_samples(4, 32, BERT_SMALL_VOCAB, 6)
    x = mx.nd.array(toks, ctx=mx.gpu(0))
    y = mx.nd.array(labels.reshape(-1), ctx=mx.gpu(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    with exact_convs():
        for hybrid in (False, True):
            net = gluon_net(dev, 6, BERT_SMALL_VOCAB, small=True)
            if hybrid:
                net.hybridize()
            frozen = net.bert.encoder.layers[0].ffn.fc1.collect_params()
            passes = []
            for i in range(5):
                if i == 3:
                    frozen.setattr("grad_req", "null")
                with autograd.record():
                    loss = loss_fn(net(x), y).mean()
                loss.backward()
                passes.append({k: None if t.grad is None else
                               t.grad.clone() for k, t in
                               net._collect_params_with_prefix().items()
                               if t.requires_grad or t.grad is not None
                               or k.startswith("bert.encoder.layers.0."
                                               "ffn.fc1.")})
            runs.append((passes, net.stats() if hybrid else None))
    (eager, _), (hyb, st) = runs
    frozen_none = all(p[k] is None for p in (eager[-1], hyb[-1])
                      for k in p if ".ffn.fc1." in k
                      and k.startswith("bert.encoder.layers.0."))
    same = all(a.keys() == b.keys() and all(
        (a[k] is None and b[k] is None) or (
            a[k] is not None and b[k] is not None
            and torch.equal(a[k], b[k])) for k in a)
        for a, b in zip(eager, hyb))
    log("gluon null: a grad_req 'null' change after a capture: 5 recorded "
        "passes (the change before the 4th), hybridized against eager "
        "gradients %s; the frozen weight's gradient None: %s; %d "
        "captures, %d backward replays"
        % ("bitwise equal" if same else "DIFFER", frozen_none,
           st["captures"], st["backward_replays"]))
    if not (same and frozen_none and st["captures"] == 2):
        fail("a grad_req 'null' change after a capture replayed the old "
             "backward graph, or the hybridized gradients differ")


def held_nodes_jit_check(dev):
    """The case ROADMAP §3 left untested: a graphed ``JitTrainStep``
    captured over a net whose hybridized graph pair still holds the
    parameters' ``AccumulateGrad`` nodes (3 Trainer adamw steps under
    ``record()`` through the pair, the net left hybridized), then 3
    ``JitTrainStep`` adam steps and ``step_n(2)``: losses and weights
    bitwise equal to the same run with an eager ``JitTrainStep``.
    ``bert_small``, f32, TF32 off."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, parallel

    toks, labels = mlm_samples(4, 32, BERT_SMALL_VOCAB, 7)
    x = mx.nd.array(toks, ctx=mx.gpu(0))
    y = mx.nd.array(labels.reshape(-1), ctx=mx.gpu(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    with exact_convs():
        for graphs in (False, True):
            net = gluon_net(dev, 7, BERT_SMALL_VOCAB, small=True)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), "adamw",
                                    {"learning_rate": 1e-3})
            for _ in range(3):
                with autograd.record():
                    loss = loss_fn(net(x), y).mean()
                loss.backward()
                trainer.step(1)
            held = net.stats()
            step = parallel.JitTrainStep(net, loss_fn, "adam",
                                         {"learning_rate": 1e-3},
                                         graphs=graphs)
            losses = [step.step(x._data, y._data).clone() for _ in range(3)]
            losses.append(step.step_n(2, x._data, y._data).clone())
            runs.append((losses, _state(net), held, step.stats()))
            del step, trainer, net
    (e_l, e_w, _, _), (g_l, g_w, held, st) = runs
    same = _bert_losses_equal(e_l, g_l) and _same(e_w, g_w)
    log("gluon held nodes: a graphed JitTrainStep over a net whose pair "
        "holds AccumulateGrad nodes (%d pair captures, %d backward "
        "replays before it): %d step captures, %d replays; losses %s, "
        "against the eager step's: losses and weights %s"
        % (held["captures"], held["backward_replays"], st["captures"],
           st["replays"], ["%.5f" % v.item() for v in g_l],
           "bitwise equal" if same else "DIFFER"))
    if not same:
        fail("a graphed JitTrainStep over a net whose pair holds "
             "AccumulateGrad nodes differs from the eager step")


@contextlib.contextmanager
def _o1_spied(oo, calls):
    """O1's wrapper wrapped: each call's inputs are cloned into
    ``calls`` before it runs (the optimizer calls
    ``optimizer_ops.multi_adamw`` by attribute, and the wrapper counts
    its launches on whatever that name holds: they are handed back)."""
    orig = oo.multi_adamw

    def spy(weights, grads, means, variances, lrs, wds, **kw):
        calls.append(dict(
            live=(weights, means, variances),
            before=tuple([t.clone() for t in ts] for ts in
                         (weights, grads, means, variances)),
            lrs=list(lrs), wds=list(wds),
            kw={k: v.clone() if hasattr(v, "clone") else v
                for k, v in kw.items()}))
        return orig(weights, grads, means, variances, lrs, wds, **kw)

    spy.launches = 0
    oo.multi_adamw = spy
    try:
        yield
    finally:
        oo.multi_adamw = orig
        orig.launches += spy.launches


def gluon_wd_and_null_checks(oo, net, nowd, step_fn, batch):
    """One more step of the trained net with O1's inputs cloned: every
    ``wd_mult=0`` tensor (``nowd``) was given O1 with ``wd`` 0, and its
    weight and moments after the step are bitwise equal to what O1's
    plain version gives with ``wd`` 0 on the copies (with the run's
    ``wd`` 0.01 the plain version moves that many of their elements:
    logged, to show what the check can see in bf16).  Then
    ``word_embed.weight`` set to ``grad_req="null"`` for one step: the
    tensor is bitwise unchanged and O1's list leaves it out."""
    import torch

    calls = []
    with _o1_spied(oo, calls):
        step_fn(*batch)
    if len(calls) != 1:
        fail("one Trainer step called O1 %d times" % len(calls))
    c = calls[0]
    ws = c["live"][0]
    ptrs = {p._tensor.data_ptr() for p in nowd}
    idx = [i for i, w in enumerate(ws) if w.data_ptr() in ptrs]
    wds = {c["wds"][i] for i in idx}
    plain = ([t[i].clone() for i in idx] for t in c["before"])
    w0, g0, m0, v0 = plain
    oo._multi_adamw_ref(w0, g0, m0, v0, [c["lrs"][i] for i in idx],
                        [0.0] * len(idx), **c["kw"])
    live = [[t[i] for i in idx] for t in c["live"]]
    same = all(torch.equal(a, b) for a, b in zip(
        live[0] + live[1] + live[2], w0 + m0 + v0))
    w1, g1, m1, v1 = ([t[i].clone() for i in idx] for t in c["before"])
    oo._multi_adamw_ref(w1, g1, m1, v1, [c["lrs"][i] for i in idx],
                        [0.01] * len(idx), **c["kw"])
    moved = sum(int((a != b).sum()) for a, b in zip(w1, w0))
    log("gluon wd_mult: %d tensors with wd_mult 0 (%d elements, %s) of %d "
        "in O1's list, given wd %s: weights and moments %s O1's plain "
        "version with wd 0 on copies; the plain version with wd 0.01 "
        "would move %d of their weights' elements"
        % (len(idx), sum(w.numel() for w in w0),
           sorted({str(w.dtype).replace("torch.", "") for w in w0}),
           len(ws), sorted(wds), "bitwise equal to" if same else
           "DIFFER from", moved))
    if len(idx) != len(nowd) or wds != {0.0} or not same:
        fail("a wd_mult=0 tensor did not reach O1 with wd 0, or O1 "
             "differs from its plain version there")
    emb = net.bert.word_embed.collect_params()
    (param,) = emb.values()
    before = param._tensor.detach().clone()
    param.grad_req = "null"
    calls.clear()
    try:
        with _o1_spied(oo, calls):
            step_fn(*batch)
    finally:
        param.grad_req = "write"
    left_out = all(w.data_ptr() != param._tensor.data_ptr()
                   for call in calls for w in call["live"][0])
    unchanged = torch.equal(param._tensor.detach(), before)
    log("gluon null: word_embed.weight with grad_req 'null' through one "
        "step: bitwise unchanged %s, left out of O1's list (%d tensors) "
        "%s" % (unchanged, len(calls[0]["live"][0]) if calls else 0,
                left_out))
    if not (unchanged and left_out):
        fail("a grad_req 'null' parameter changed or reached O1")


def gluon_save_load(net, dev, tmp):
    """``save_parameters`` of the trained bf16 net and
    ``load_parameters`` into a fresh BERT-base under amp: ``no_grad``
    logits bitwise equal; ``nd.load`` of the file gives every entry as
    f32 under the net's structural names (the JAX package's).  Returns
    the file's bytes and the save and load seconds."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd

    path = os.path.join(tmp, "bert_base.params")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.save_parameters(path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    fresh = gluon_net(dev, 1)
    amp.convert_hybrid_block(fresh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_parameters(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    toks, _ = mlm_samples(BERT_B, BERT_T, BERT_VOCAB, 9)
    x = mx.nd.array(toks, ctx=mx.gpu(0))
    net.hybridize(False)
    with torch.no_grad(), autograd.predict_mode():
        want, got = net(x).asnumpy(), fresh(x).asnumpy()
    same = np.array_equal(want, got) and np.isfinite(got).all()
    entries = mx.nd.load(path, ctx=mx.cpu())
    named = list(entries) == list(net._collect_params_with_prefix())
    f32 = all(a.dtype == np.float32 for a in entries.values())
    log("gluon save/load: %s, %.1f MB, %d entries, all f32 %s, names the "
        "net's structural names %s; save %.3f s, load %.3f s; the loaded "
        "net's no_grad logits (%d x %d) %s the saved net's"
        % (os.path.basename(path), size / 1e6, len(entries), f32, named,
           save_s, load_s, *got.shape,
           "bitwise equal to" if same else "DIFFER from"))
    del fresh, entries
    if not (same and f32 and named):
        fail("the loaded BERT-base differs from the saved one, or the "
             "file's entries are not f32 under the structural names")
    return size, save_s, load_s


def gluon_train_run(dev):
    """The main path: BERT-base (12 x 768, 12 heads, vocab 30,522) under
    amp bf16 trained as a user's Gluon script.  ``DataLoader`` over an
    ``ArrayDataset`` of 384 seeded sequences (``mlm_samples``), batch
    32 x 128, shuffled, ``num_workers=2``; each batch
    ``as_in_context(mx.gpu(0))``; the forward and
    ``SoftmaxCrossEntropyLoss`` under ``autograd.record()``,
    ``loss.backward()``, ``gluon.utils.clip_global_norm`` 1.0 over the
    trainable gradients (O3), ``gluon.Trainer(net.collect_params(),
    "adamw", lr 1e-4, wd 0.01).step(32)`` (O1) with ``wd_mult`` 0 on
    every gamma, beta and bias, and ``mx.metric.Loss`` and
    ``Perplexity`` updated each step.  Two epochs eagerly, then two
    hybridized (one step a mode profiled).  Returns the kernels' launch
    counts, the trained net, the script's step and a batch."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mx.gpu(0)
    net = gluon_net(dev, 0)
    mx.amp.convert_hybrid_block(net)
    params = net.collect_params()
    nowd = net.collect_params(".*gamma|.*beta|.*bias")
    nowd.setattr("wd_mult", 0.0)
    trainable = [p for p in params.values() if p.grad_req != "null"]
    trainer = gluon.Trainer(params, "adamw",
                            {"learning_rate": 1e-4, "wd": 0.01})
    toks, labels = mlm_samples(GLUON_SAMPLES, BERT_T, BERT_VOCAB, 0)
    np.random.seed(0)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(toks, labels), batch_size=BERT_B,
        shuffle=True, last_batch="discard", num_workers=2)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_metric, ppl = mx.metric.Loss(), mx.metric.Perplexity(None)
    nowd_train = [p for p in nowd.values() if p.grad_req != "null"]
    log("gluon train: BERT-base as a Gluon script, %d parameters (%d "
        "trainable, %d with wd_mult 0), %d samples of %d tokens, %d steps "
        "an epoch, set-up %.1f s"
        % (len(params), len(trainable), len(nowd_train), GLUON_SAMPLES,
           BERT_T, len(loader), time.perf_counter() - t0))
    host = {"copy": [], "metric": [], "loader": [], "sync": []}

    def step(data, label):
        t1 = time.perf_counter()
        data, label = data.as_in_context(ctx), label.as_in_context(ctx)
        host["copy"].append(time.perf_counter() - t1)
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label.reshape((-1,)))
        loss.backward()
        gluon.utils.clip_global_norm(
            [p.grad() for p in params.values() if p.grad_req != "null"], 1.0)
        trainer.step(BERT_B)
        t1 = time.perf_counter()
        loss_metric.update(None, loss)
        ppl.update([label.reshape((-1,))], [out.softmax()])
        host["metric"].append(time.perf_counter() - t1)

    counters = ("fwd_launches", "dq_launches", "dkv_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    reset_opt_counts(oo)
    rows, epochs, n_steps, batch = {}, [], 0, None
    for mode in ("eager", "hybridized"):
        if mode == "hybridized":
            net.hybridize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, prof = [], None
        for epoch in range(2):
            loss_metric.reset()
            ppl.reset()
            it = iter(loader)
            for i in range(len(loader)):
                t1 = time.perf_counter()
                data, label = next(it)
                host["loader"].append(time.perf_counter() - t1)
                batch = (data, label)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if epoch == 1 and i == 6:
                    prof = profiled_step(lambda: step(data, label))
                else:
                    step(data, label)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t1)
                n_steps += 1
            t1 = time.perf_counter()
            (_, mean_loss), (_, perplexity) = loss_metric.get(), ppl.get()
            host["sync"].append(time.perf_counter() - t1)
            epochs.append((mode, mean_loss, perplexity))
            log("gluon train: %s epoch %d: mean loss %.4f, perplexity %.2f"
                % (mode, epoch, mean_loss, perplexity))
        rows[mode] = (sorted(times), prof, torch.cuda.max_memory_allocated(),
                      net.stats() if mode == "hybridized" else None)
    launches = {name: getattr(fa.flash_attention, name) for name in counters}
    launches.update(opt_counts(oo))
    layers = BERT_BASE["num_layers"]
    log("gluon train: launches over %d steps: %s (K1-K3 must be %d each, "
        "O1 %d, O3 the same every step)"
        % (n_steps, launches, layers * n_steps, n_steps))
    for name in counters:
        if launches[name] != layers * n_steps:
            fail("the Gluon script's %s = %d over %d steps of %d layers"
                 % (name, launches[name], n_steps, layers))
    if launches["O1"] != n_steps:
        fail("the Gluon script's adamw update launched O1 %d times over %d "
             "steps" % (launches["O1"], n_steps))
    if not launches["O3"] or launches["O3"] % n_steps:
        fail("clip_global_norm launched O3 %d times over %d steps"
             % (launches["O3"], n_steps))
    means = [m for _, m, _ in epochs]
    if not all(math.isfinite(m) for _, m, p in epochs):
        fail("a Gluon script epoch's loss is not finite")
    log("gluon train: epoch mean losses %s; the last %.4f against the "
        "first %.4f (must be below it)"
        % (["%.4f" % m for m in means], means[-1], means[0]))
    if not means[-1] < means[0]:
        fail("the Gluon script's loss did not fall")
    for mode, (times, (_, wall, busy, averages), peak, st) in rows.items():
        p50_s = times[len(times) // 2]
        top, _, kern_ms = kernel_rows(averages)
        jit = BERT_JIT_MS.get("eager" if mode == "eager" else "graphed")
        log("gluon train: %s Trainer step ms p50 %.3f (min %.3f max %.3f "
            "over %d timed steps), %.1f samples/s; the bert phase's %s "
            "JitTrainStep p50 %s ms; peak device memory %.2f GB"
            % (mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), BERT_B / p50_s,
               "eager" if mode == "eager" else "graphed",
               "%.3f" % jit if jit else "not run", peak / 1e9))
        log("gluon train: %s profiled step: wall %.3f ms, kernels busy "
            "%.3f ms (union of intervals): idle %.1f%% of the profiled "
            "step, %.1f%% of the p50 step; kernels summed %.3f ms: %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (1e3 * p50_s)), kern_ms,
               ", ".join("%s %.3f" % kv
                         for kv in kernel_kinds(averages).items())))
        for ms, n, key in top:
            log("gluon train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        if st is not None:
            log("gluon train: hybridized: %d captures, %d replays, %d "
                "backward replays, %d busy calls, pool %.1f MB"
                % (st["captures"], st["replays"], st["backward_replays"],
                   st["busy_calls"], st["pool_bytes"] / 1e6))

    def us(xs):
        xs = sorted(xs)
        return 1e6 * xs[len(xs) // 2], 1e6 * xs[-1]

    log("gluon train: host us median (max): DataLoader next() %.1f (%.1f) "
        "a batch; as_in_context of a batch %.1f (%.1f); the metrics' "
        "update %.1f (%.1f) a step; the metrics' one pull (get()) %.1f "
        "(%.1f) an epoch"
        % (*us(host["loader"]), *us(host["copy"]), *us(host["metric"]),
           *us(host["sync"])))
    return launches, net, nowd_train, step, batch


def gluon_phase(dev):
    """The checks at ``bert_small`` (``grad_req`` "add" through the
    graph pair, a "null" change after a capture, the held-node case),
    then the main path (``gluon_train_run``) under amp bf16, with the
    ``wd_mult`` and ``"null"`` checks on its net, its save and load, and
    the write rule's host cost."""
    import torch

    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    start_profiler(dev)
    gluon_add_check(dev)
    gluon_null_change_check(dev)
    held_nodes_jit_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    tmp = tempfile.mkdtemp(prefix="gluon_smoke_")
    try:
        launches, net, nowd, step, batch = gluon_train_run(dev)
        gluon_wd_and_null_checks(oo, net, nowd, step, batch)
        gluon_save_load(net, dev, tmp)
        write_rule_cost(net.bert, "gluon")
    finally:
        amp.turn_off()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 21: mx.np and mx.npx -----------------------------------------------

NP_STEPS = 12              # steps a mode of each script
NP_IGNORE = -1             # a label id the samples never hold


def np_card_cases():
    """``(label, fn, kind)``: ``fn(np, x, y, i)`` on (64, 48) f32 ``x``
    and ``y`` and an int32 ``i`` of ``mx.np`` arrays; ``kind`` is
    "exact" (bitwise), "ulp" (within 1e-6 of the largest value: the
    card's and the host's transcendental functions round differently) or
    "reduce" (within 1e-5 of the largest value: another summation
    order)."""
    return [
        ("add", lambda np, x, y, i: np.add(x, y), "exact"),
        ("subtract", lambda np, x, y, i: x - y, "exact"),
        ("multiply", lambda np, x, y, i: np.multiply(x, 2.5), "exact"),
        ("true_divide", lambda np, x, y, i: x / y, "exact"),
        ("int / 2", lambda np, x, y, i: i / 2, "exact"),
        ("maximum", lambda np, x, y, i: np.maximum(x, y), "exact"),
        ("negative, absolute", lambda np, x, y, i: np.absolute(-x),
         "exact"),
        ("floor, rint", lambda np, x, y, i: np.floor(x * 7) + np.rint(y),
         "exact"),
        ("sqrt, square", lambda np, x, y, i: np.sqrt(np.square(x)),
         "exact"),
        ("comparisons", lambda np, x, y, i: np.logical_and(x > y, x != 0),
         "exact"),
        ("where", lambda np, x, y, i: np.where(x > 0, x, y), "exact"),
        ("clip", lambda np, x, y, i: np.clip(x, -0.5, 0.5), "exact"),
        ("mod, fmod", lambda np, x, y, i: (np.mod(x, 0.7),
                                           np.fmod(y, 0.3)), "ulp"),
        ("copysign", lambda np, x, y, i: np.copysign(x, y), "exact"),
        ("transpose, flip, roll", lambda np, x, y, i: np.roll(
            np.flip(x.T, 0), 3, 1), "exact"),
        ("concatenate, stack", lambda np, x, y, i: np.stack(
            [np.concatenate([x, y]), np.concatenate([y, x])]), "exact"),
        ("tril, diag", lambda np, x, y, i: (np.tril(x), np.diag(x),
                                            np.diag(x[0])), "exact"),
        ("sort, argsort", lambda np, x, y, i: (np.sort(x, axis=1),
                                               np.argsort(x, axis=1)),
         "exact"),
        ("argmax, argmin", lambda np, x, y, i: (np.argmax(x, axis=0),
                                                np.argmin(x)), "exact"),
        ("int sum, cumsum", lambda np, x, y, i: (np.sum(i, axis=0),
                                                 np.cumsum(i, axis=1)),
         "exact"),
        ("take, one_hot", lambda np, x, y, i: (np.take(
            x, np.abs(i[0]) % 64, axis=0), np.one_hot(np.abs(i[0]) % 5, 5)),
         "exact"),
        ("searchsorted, digitize", lambda np, x, y, i: (np.searchsorted(
            np.sort(x.reshape(-1)), y.reshape(-1)), np.digitize(
            x, np.array([-1.0, 0.0, 1.0], ctx=x.context))), "exact"),
        ("histogram", lambda np, x, y, i: np.histogram(x, bins=7,
                                                       range=(-2.0, 2.0)),
         "exact"),
        ("isnan, nan_to_num", lambda np, x, y, i: np.nan_to_num(
            np.log(x)), "ulp"),
        ("exp, log1p, tanh", lambda np, x, y, i: np.exp(x) + np.log1p(
            np.abs(y)) + np.tanh(x), "ulp"),
        ("sin, arctan2, hypot", lambda np, x, y, i: np.sin(x)
         + np.arctan2(x, y) + np.hypot(x, y), "ulp"),
        ("power, sigmoid", lambda np, x, y, i: np.power(np.abs(x), 1.7)
         + np.sigmoid(y), "ulp"),
        ("sum, mean", lambda np, x, y, i: (np.sum(x, axis=0), np.mean(
            np.abs(y)), np.abs(x).sum()), "reduce"),
        ("std, var", lambda np, x, y, i: (np.std(x, axis=1),
                                          np.var(y, ddof=1)), "reduce"),
        ("prod, max, ptp", lambda np, x, y, i: (np.prod(
            1 + 0.01 * x, axis=0), np.max(x, axis=1), np.ptp(y)),
         "reduce"),
        ("dot, matmul, einsum", lambda np, x, y, i: (np.dot(x, y.T),
                                                     x.T @ y,
                                                     np.einsum(
                                                         "ij,ij->i", x, y)),
         "reduce"),
        ("median, percentile", lambda np, x, y, i: (np.median(x, axis=0),
                                                    np.percentile(y, 30.0)),
         "reduce"),
        ("nanmean, nanstd", lambda np, x, y, i: (np.nanmean(
            np.log(x)), np.nanstd(np.log(y), axis=0)), "reduce"),
        ("cov, corrcoef", lambda np, x, y, i: (np.cov(x[:8]),
                                               np.corrcoef(y[:8])),
         "reduce"),
        ("linalg", lambda np, x, y, i: (np.linalg.norm(x),
                                        np.linalg.inv(
                                            x[:48] + 10 * np.eye(
                                                48, ctx=x.context))),
         "reduce"),
    ]


def np_inputs(mx, ctx, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((64, 48)).astype(np.float32)
    y = rs.standard_normal((64, 48)).astype(np.float32)
    i = rs.randint(-50, 50, (64, 48)).astype(np.int32)
    return [mx.np.array(a, ctx=ctx) for a in (x, y, i)]


def np_card_checks(mx, dev, cases=None):
    """Every case of ``np_card_cases`` (or ``cases``) on the card against
    the port on the host, TF32 off: the results ``mx.np`` arrays of the
    host's dtypes and shapes, within each case's kind.  Returns the worst
    reading of each kind and whether every case held."""
    import torch

    cases = cases or np_card_cases()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"exact": 0.0, "ulp": 0.0, "reduce": 0.0}
    ok = True
    try:
        host = np_inputs(mx, mx.cpu())
        card = np_inputs(mx, mx.gpu(0))
        for label, fn, kind in cases:
            want = fn(mx.np, *host)
            got = fn(mx.np, *card)
            want = list(want) if isinstance(want, (tuple, list)) else [want]
            got = list(got) if isinstance(got, (tuple, list)) else [got]
            err, good = 0.0, len(got) == len(want)
            for g, w in zip(got, want):
                good &= type(g) is mx.np.ndarray and g.dtype == w.dtype \
                    and g.shape == w.shape and g.context == mx.gpu(0)
                gn, wn = g.asnumpy(), w.asnumpy()
                if kind == "exact":
                    same = np.array_equal(
                        gn, wn, equal_nan=gn.dtype.kind == "f")
                    err = max(err, 0.0 if same else float("inf"))
                else:
                    gn, wn = gn.astype(np.float64), wn.astype(np.float64)
                    scale = max(np.abs(np.nan_to_num(wn)).max(), 1e-30)
                    e = float(np.nanmax(np.abs(gn - wn)) / scale) \
                        if gn.size else 0.0
                    good &= np.array_equal(np.isnan(gn), np.isnan(wn))
                    err = max(err, e)
            limit = {"exact": 0.0, "ulp": 1e-6, "reduce": 1e-5}[kind]
            good &= err <= limit
            worst[kind] = max(worst[kind], err)
            ok &= bool(good)
            if not good:
                log("np ops: %s on the card against the host: %.3g (%s, "
                    "limit %.3g) FAIL" % (label, err, kind, limit))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log("np ops: %d cases on the card against the host, TF32 off: "
        "elementwise and indexing bitwise (worst %.3g), transcendental "
        "within %.3g of the largest value (limit 1e-6), reductions within "
        "%.3g (limit 1e-5): %s"
        % (len(cases), worst["exact"], worst["ulp"],
           worst["reduce"], "ok" if ok else "FAIL"))
    return worst, ok


def np_graph_class_check(mx, dev):
    """A hybridized block called with ``mx.np`` arrays after the same
    call with NDArrays: ``mx.np`` out, NDArrays out, one capture between
    them (the np call replays the NDArray call's graph), bitwise equal
    outputs (``no_grad``: a recorded call's pair stays busy while its
    outputs live).  Returns whether it held."""
    import torch

    from mxnet_tpu_torch import gluon

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = gluon.nn.Dense(16, in_units=32)

        def forward(self, x):
            return self.fc(x).tanh() * 2

    net = Net()
    net.initialize(device=dev)
    net.hybridize()
    x = np.random.RandomState(3).standard_normal((8, 32)).astype(np.float32)
    with torch.no_grad():
        outs_nd = [net(mx.nd.array(x, ctx=mx.gpu(0))) for _ in range(2)]
        st0 = net.stats()
        outs_np = [net(mx.np.array(x, ctx=mx.gpu(0))) for _ in range(2)]
        st1 = net.stats()
    ok = all(type(o) is mx.nd.NDArray for o in outs_nd) \
        and all(type(o) is mx.np.ndarray for o in outs_np) \
        and st0["captures"] == st1["captures"] == 1 \
        and st1["replays"] == st0["replays"] + 2 \
        and all(np.array_equal(o.asnumpy(), outs_nd[0].asnumpy())
                for o in outs_np)
    log("np graph: a hybridized block: NDArray calls %s, np calls %s; "
        "captures %d then %d, replays %d then %d; outputs %s: %s"
        % (type(outs_nd[0]).__name__, type(outs_np[0]).__module__ + "."
           + type(outs_np[0]).__name__, st0["captures"], st1["captures"],
           st0["replays"], st1["replays"],
           "bitwise equal" if ok else "checked", "ok" if ok else "FAIL"))
    return ok


def np_capture_refusals(mx, dev):
    """``unique``, ``nonzero``, ``bincount`` and ``delete`` inside a
    hybridized block's captured call raise ``MXNetError`` naming the op;
    the card takes further work after each.  Returns whether all held."""
    import torch

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.base import MXNetError

    cases = [("unique", lambda np, x: np.unique(x)),
             ("nonzero", lambda np, x: np.nonzero(x > 0)[0]),
             ("bincount", lambda np, x: np.bincount(
                 x.astype("int32").reshape(-1))),
             ("delete", lambda np, x: np.delete(x, [1]))]
    ok = True
    for label, fn in cases:
        class Net(gluon.HybridBlock):
            def forward(self, x, fn=fn):
                return fn(mx.np, x) * 1.0

        net = Net()
        net.hybridize()
        x = mx.np.array(np.arange(8, dtype=np.float32).reshape(2, 4) % 3,
                        ctx=mx.gpu(0))
        raised = None
        for _ in range(3):
            try:
                net(x)
            except MXNetError as e:
                raised = e
                break
        torch.cuda.synchronize()
        usable = bool((torch.randint(0, 5, (8,), device=dev) < 5).all())
        good = raised is not None and usable
        ok &= good
        log("np graph: %s inside a captured call: %s; the card usable "
            "after %s %s" % (label, ("MXNetError: %s" % str(raised)
                                     .splitlines()[0][:80])
                             if raised is not None else "NOTHING RAISED",
                             usable, "ok" if good else "FAIL"))
    return ok


def np_script_step(mx, net, trainer, toks, labels, clip):
    """One step of the numpy-mode script (``mx.npx.set_np()`` is on):
    logits, the masked mean NLL through ``npx.pick``/``npx.log_softmax``
    under ``record()``, ``backward()``, ``clip_global_norm``,
    ``trainer.step(1)``, and the accuracy outside ``record()``.  Returns
    every array it touched and the host seconds of the loss part and of
    the accuracy."""
    with mx.autograd.record():
        logits = net(toks)
        t0 = time.perf_counter()
        mask = (labels != NP_IGNORE).astype("float32")
        nll = -mx.npx.pick(mx.npx.log_softmax(logits), labels.reshape(-1))
        loss = (nll * mask.reshape(-1)).sum() / mask.sum()
        host = time.perf_counter() - t0
    loss.backward()
    clip()
    trainer.step(1)
    t0 = time.perf_counter()
    acc = (logits.argmax(axis=-1) == labels.reshape(-1)).mean()
    host = (host, time.perf_counter() - t0)
    return (toks, labels, logits, mask, nll, loss, acc), host


def np_nd_step(mx, net, trainer, loss_fn, toks, labels, clip):
    """The gluon phase's NDArray script's step on one batch; returns its
    logits and the loss part's host seconds."""
    with mx.autograd.record():
        out = net(toks)
        t0 = time.perf_counter()
        loss = loss_fn(out, labels.reshape((-1,)))
        host = time.perf_counter() - t0
    loss.backward()
    clip()
    trainer.step(BERT_B)
    return out, host


def np_loss_reference(logits, labels):
    """The script's loss in plain torch on the same logits (f32, as the
    port's log_softmax under amp computes it)."""
    import torch

    lt = logits.data().detach().float()
    y = labels.data().reshape(-1)
    lsm = torch.log_softmax(lt, -1)
    nll = -torch.take_along_dim(lsm, y.long()[:, None], 1)[:, 0]
    mask = (y != NP_IGNORE).float()
    return ((nll * mask).sum() / mask.sum()).item()


def np_train_run(dev, smi):
    """The main path: BERT-base under amp bf16 pre-trained as a
    numpy-mode Gluon script (``mx.npx.set_np()``, ``mx.np`` batches,
    ``npx.pick``/``npx.log_softmax``, an ``mx.np`` loss and accuracy),
    12 steps eager then 12 hybridized, each step alternated with the
    gluon phase's NDArray script on a second net from the same seed;
    returns the launch counts over both scripts' steps and the
    readings.  ``smi`` is the card's name and power limit."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    ctx = mx.gpu(0)
    nets, trainers, clips = [], [], []
    for _ in range(2):
        net = gluon_net(dev, 0)
        mx.amp.convert_hybrid_block(net)
        params = net.collect_params()
        net.collect_params(".*gamma|.*beta|.*bias").setattr("wd_mult", 0.0)
        trainers.append(gluon.Trainer(params, "adamw", {
            "learning_rate": 1e-4, "wd": 0.01}))
        grads = [p for p in params.values() if p.grad_req != "null"]
        clips.append((lambda g: lambda: gluon.utils.clip_global_norm(
            [p.grad() for p in g], 1.0))(grads))
        nets.append(net)
    net_np, net_nd = nets
    toks, labels = mlm_samples(NP_STEPS * BERT_B, BERT_T, BERT_VOCAB, 1)
    batches = [(toks[i * BERT_B:(i + 1) * BERT_B],
                labels[i * BERT_B:(i + 1) * BERT_B])
               for i in range(NP_STEPS)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    layers, units = BERT_BASE["num_layers"], BERT_BASE["units"]
    inner = net_np.bert
    layer_w = sum(p.numel() for n, p in inner.named_parameters()
                  if n.startswith("encoder.") and p.dim() == 2)
    head_w = inner.word_embed.weight.numel()
    tokens = BERT_B * BERT_T
    step_flops = 6 * tokens * (layer_w + head_w) \
        + 3 * layers * 4 * BERT_B * BERT_T * BERT_T * units
    counters = ("fwd_launches", "dq_launches", "dkv_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    reset_opt_counts(oo)
    np_only = dict.fromkeys(counters, 0)
    rows, losses, classes_ok = {}, {"eager": [], "hybridized": []}, True
    loss_errs, host = [], {"np": [], "acc": [], "nd": []}
    mx.npx.set_np()
    try:
        for mode in ("eager", "hybridized"):
            if mode == "hybridized":
                for a, b in zip(net_np.parameters(), net_nd.parameters()):
                    b.data.copy_(a.data)
                for a, b in zip(net_np.buffers(), net_nd.buffers()):
                    b.copy_(a)
                for net in nets:
                    net.hybridize()
            gc.collect()
            torch.cuda.empty_cache()
            t_np, t_nd, prof, prof_nd, first = [], [], None, None, None
            for i, (bt, bl) in enumerate(batches):
                before = {n: getattr(fa.flash_attention, n)
                          for n in counters}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = mx.np.array(bt, ctx=ctx)
                y = mx.np.array(bl, ctx=ctx)

                def np_step():
                    return np_script_step(mx, net_np, trainers[0], x, y,
                                          clips[0])
                if i == NP_STEPS // 2:
                    (outs, h), wall, busy, averages = profiled_step(np_step)
                    prof = (wall, busy, averages)
                else:
                    outs, h = np_step()
                    torch.cuda.synchronize()
                    if i:
                        t_np.append(time.perf_counter() - t0)
                host["np"].append(h[0])
                host["acc"].append(h[1])
                for n in counters:
                    np_only[n] += getattr(fa.flash_attention, n) - before[n]
                classes_ok &= all(type(o) is mx.np.ndarray for o in outs)
                losses[mode].append(outs[5].item())
                if i == 0:
                    loss_errs.append(abs(outs[5].item() - np_loss_reference(
                        outs[2], outs[1])) / abs(outs[5].item()))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nx = mx.nd.array(bt, ctx=ctx)
                ny = mx.nd.array(bl, ctx=ctx)

                def nd_step():
                    return np_nd_step(mx, net_nd, trainers[1], loss_fn, nx,
                                      ny, clips[1])
                if i == NP_STEPS // 2:
                    (out_nd, h), wall, busy, averages = profiled_step(
                        nd_step)
                    prof_nd = (wall, busy, averages)
                else:
                    out_nd, h = nd_step()
                    torch.cuda.synchronize()
                    if i:
                        t_nd.append(time.perf_counter() - t0)
                host["nd"].append(h)
                if i == 0:
                    first = (outs[2].detach(), out_nd.detach())
                # nothing keeps a step's graph: a held AccumulateGrad node
                # breaks the next backward capture (C14b, ROADMAP.md §1)
                del outs, out_nd
            same = torch.equal(first[0].data(), first[1].data())
            rows[mode] = (sorted(t_np), sorted(t_nd), prof, same,
                          nets[0].stats() if mode == "hybridized" else None,
                          prof_nd)
    finally:
        mx.npx.reset_np()
    launches = {n: getattr(fa.flash_attention, n) for n in counters}
    launches.update(opt_counts(oo))
    n_steps = 2 * 2 * NP_STEPS
    log("np train: BERT-base (12 x 768, vocab %d) under amp bf16 as a "
        "numpy-mode script, %d steps a mode of it and of the NDArray "
        "script alternately; launches over both scripts' %d steps: %s "
        "(K1-K3 must be %d each, O1 %d); the np script's alone: %s (must "
        "be %d each)" % (BERT_VOCAB, NP_STEPS, n_steps, launches,
                         layers * n_steps, n_steps, np_only,
                         layers * n_steps // 2))
    for n in counters:
        if launches[n] != layers * n_steps \
                or np_only[n] != layers * n_steps // 2:
            fail("the np phase's %s = %d (np script %d) over %d steps of %d "
                 "layers" % (n, launches[n], np_only[n], n_steps, layers))
    if launches["O1"] != n_steps:
        fail("the np phase's adamw updates launched O1 %d times over %d "
             "steps" % (launches["O1"], n_steps))
    if not classes_ok:
        fail("an output of the numpy-mode script is not an mx.np.ndarray")
    for mode, (_, _, _, same, _, _) in rows.items():
        log("np train: %s first step's logits against the NDArray script's "
            "at the same weights and batch: %s"
            % (mode, "bitwise equal" if same else "DIFFER"))
        if not same:
            fail("the numpy-mode script's %s logits differ from the NDArray "
                 "script's" % mode)
    log("np train: first-step loss against the same reduction in plain "
        "torch on its logits: %s relative (limit 1e-6)"
        % ["%.3g" % e for e in loss_errs])
    if not all(e <= 1e-6 for e in loss_errs):
        fail("the numpy-mode loss differs from plain torch's")
    means = [sum(v) / len(v) for v in losses.values()]
    log("np train: losses eager %s, hybridized %s; mean %.4f then %.4f "
        "(must fall)" % (["%.3f" % v for v in losses["eager"]],
                         ["%.3f" % v for v in losses["hybridized"]],
                         means[0], means[1]))
    if not all(math.isfinite(v) for vs in losses.values() for v in vs) \
            or not means[1] < means[0]:
        fail("the numpy-mode script's loss did not fall")
    readings = {}
    for mode, (t_np, t_nd, (wall, busy, averages), _, st, nd_prof) \
            in rows.items():
        p50_np, p50_nd = t_np[len(t_np) // 2], t_nd[len(t_nd) // 2]
        readings[mode] = (1e3 * p50_np, 1e3 * p50_nd)
        top, _, kern_ms = kernel_rows(averages)
        log("np train: %s step ms p50 %.3f (min %.3f max %.3f over %d "
            "steps), %.1f samples/s, %.1f%% MFU (%.4g FLOP a step at 989 "
            "TFLOP/s bf16); the NDArray script alternated: p50 %.3f (min "
            "%.3f max %.3f); np / NDArray %.3fx; on %s"
            % (mode, 1e3 * p50_np, 1e3 * t_np[0], 1e3 * t_np[-1], len(t_np),
               BERT_B / p50_np, 100 * step_flops / p50_np / BF16_FLOPS,
               step_flops, 1e3 * p50_nd, 1e3 * t_nd[0], 1e3 * t_nd[-1],
               p50_np / p50_nd, smi))
        log("np train: %s profiled np step: wall %.3f ms, kernels busy %.3f "
            "ms: idle %.1f%% of the profiled step, %.1f%% of the p50 step; "
            "kernels summed %.3f ms: %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (1e3 * p50_np)), kern_ms,
               ", ".join("%s %.3f" % kv
                         for kv in kernel_kinds(averages).items())))
        for ms, n, key in top[:6]:
            log("np train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        wall, busy, averages = nd_prof
        log("np train: %s profiled NDArray step: wall %.3f ms, kernels busy "
            "%.3f ms, idle %.1f%% of its p50 step; kernels summed %.3f ms: %s"
            % (mode, wall * 1e3, busy,
               100 * max(0.0, 1 - busy / (1e3 * p50_nd)),
               kernel_rows(averages)[2],
               ", ".join("%s %.3f" % kv
                         for kv in kernel_kinds(averages).items())))
        if st is not None:
            log("np train: hybridized: %d captures, %d replays, %d backward "
                "replays, %d busy calls" % (st["captures"], st["replays"],
                                            st["backward_replays"],
                                            st["busy_calls"]))

    def us(xs):
        xs = sorted(xs)
        return 1e6 * xs[len(xs) // 2], 1e6 * xs[-1]

    log("np train: host us median (max) of the loss's ops under record(): "
        "np script (!=, astype, log_softmax, pick, -, *, sum, /) %.1f "
        "(%.1f); NDArray script (SoftmaxCrossEntropyLoss) %.1f (%.1f); the "
        "np script's accuracy (argmax, ==, mean) %.1f (%.1f)"
        % (*us(host["np"]), *us(host["nd"]), *us(host["acc"])))
    return launches, readings


def np_dispatch_rates(mx, ctx, smi):
    """``dispatch_rate`` (the imperative phase's 20-op chain on (64, 64))
    over ``mx.np`` arrays and, in the same process, ``mx.nd`` arrays, in
    turns (np, nd, nd, np) after one untimed run of each, bulked (the
    engine's default) and eager (``bulk(0)``), plain and under
    ``record()``; ``smi`` is the card's name and power limit."""
    rates = {}
    for mode in ("bulked", "eager"):
        with bulking(mx, mode == "bulked"):
            for ones in (mx.np.ones, None):
                dispatch_rate(mx, ctx, False, ones=ones, windows=1)
                dispatch_rate(mx, ctx, True, ones=ones, windows=1)
            for cls, ones in (("np", mx.np.ones), ("nd", None),
                              ("nd", None), ("np", mx.np.ones)):
                rates.setdefault((mode, cls), []).append((
                    dispatch_rate(mx, ctx, False, ones=ones),
                    dispatch_rate(mx, ctx, True, ones=ones)))
    for mode in ("bulked", "eager"):
        (p_np, r_np), (p_nd, r_nd) = (
            [sum(r[k] for r in rates[(mode, cls)]) / 2 for k in (0, 1)]
            for cls in ("np", "nd"))
        log("np dispatch (%s), a 20-op chain on (64, 64) f32, np, nd, nd, "
            "np in turns: mx.np %s ops/s plain (mean %.2f us an op), %s under "
            "record() with backward(); mx.nd %s plain (%.2f us), %s "
            "recorded; np / nd %.3f plain, %.3f recorded; on %s"
            % (mode, ["%.0f" % r[0] for r in rates[(mode, "np")]],
               1e6 / p_np, ["%.0f" % r[1] for r in rates[(mode, "np")]],
               ["%.0f" % r[0] for r in rates[(mode, "nd")]], 1e6 / p_nd,
               ["%.0f" % r[1] for r in rates[(mode, "nd")]], p_np / p_nd,
               r_np / r_nd, smi))
    return rates


def np_phase(dev):
    """The np ops on the card against the host, the class through a
    hybridized block's graph, the host reads refused under a capture,
    then the main path (``np_train_run``) under amp bf16 and the np
    dispatch rate beside ``mx.nd``'s."""
    import torch

    import mxnet_tpu_torch as mx

    start_profiler(dev)
    smi = nvidia_smi_line()
    _, ok = np_card_checks(mx, dev)
    ok &= np_graph_class_check(mx, dev)
    ok &= np_capture_refusals(mx, dev)
    if not ok:
        fail("an np check failed on the card")
    gc.collect()
    torch.cuda.empty_cache()
    mx.amp.init("bfloat16")
    try:
        launches, _ = np_train_run(dev, smi)
    finally:
        mx.amp.turn_off()
    np_dispatch_rates(mx, mx.gpu(0), smi)
    return launches


# -- phase 14: the optimizer kernels O1-O3 ---------------------------------

OPT_SIZES = (1, 7, 8191, 8192, 8193, 100003, 3 * 8192 + 5)
OPT_LONG = 1100            # tensors: more than one table of every kernel
OPT_CL_SHAPES = ((64, 32, 3, 3), (256, 64, 1, 1), (3, 5, 7, 7))
OPT_KERNELS = ("multi_adamw_kernel", "multi_sgd_kernel", "sum_sq_")


def opt_counts(oo):
    return {"O1": oo.multi_adamw.launches, "O2": oo.multi_sgd.launches,
            "O3": oo.multi_sum_sq.launches}


def reset_opt_counts(oo):
    oo.multi_adamw.launches = oo.multi_sgd.launches = 0
    oo.multi_sum_sq.launches = 0


def update_kernel_ms(averages):
    """Device ms of the optimizer kernels (O1-O3) in a profile."""
    return sum(e.self_device_time_total for e in averages
               if any(k in e.key for k in OPT_KERNELS)) / 1e3


def ulps(got, want):
    """Per-element distance in ulps between two tensors of one float
    dtype (f32, bf16 or f16)."""
    import torch

    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    top = (1 << (8 * got.element_size() - 1)) - 1

    def ordered(t):
        b = t.contiguous().view(bits).to(torch.int64)
        return torch.where(b < 0, -(b & top), b)

    return (ordered(got) - ordered(want)).abs()


def opt_reading(gots, wants, piece=1 << 26):
    """(largest ulp distance, share of elements equal, largest abs error)
    over lists of tensors of one dtype, read ``piece`` elements at a time
    (the train lists hold tensors of 525 M elements)."""
    import torch

    dev = gots[0].device if gots else "cpu"
    most = torch.zeros((), dtype=torch.int64, device=dev)
    equal = torch.zeros((), dtype=torch.int64, device=dev)
    err = torch.zeros((), dtype=torch.float32, device=dev)
    total = 0
    for g, w in zip(gots, wants):
        g, w = g.reshape(-1), w.reshape(-1)
        for i in range(0, g.numel(), piece):
            a, b = g[i:i + piece], w[i:i + piece]
            u = ulps(a, b)
            most = torch.maximum(most, u.max())
            equal += (u == 0).sum()
            err = torch.maximum(err, (a.float() - b.float()).abs().max())
            total += u.numel()
    if not total:
        return 0, 1.0, 0.0
    return most.item(), equal.item() / total, err.item()


def opt_within(reading, dtype):
    """f32 within 2 ulps; bf16 and f16 equal in at least 99.9% of
    elements and within one ulp for the rest."""
    import torch

    most, equal, _ = reading
    if dtype == torch.float32:
        return most <= 2
    return equal >= 0.999 and most <= 1


def opt_buffers(dev, sizes, dtype, seed, kind, misalign=False,
                layout=None):
    """Tensors of ``sizes`` (element counts, or shapes with ``layout``
    "cl" for channels-last 4-D), values from a seeded generator on
    ``dev``: ``kind`` "w" normal, "g" 2x normal, "m" 0.1x normal, "v"
    positive.  ``misalign`` puts each tensor one element into a larger
    buffer, off every 16-byte boundary."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = []
    for s in sizes:
        shape = (s,) if isinstance(s, int) else tuple(s)
        n = math.prod(shape)
        x = torch.randn(n + 1, generator=gen, device=dev)
        if kind == "g":
            x = x * 2
        elif kind == "m":
            x = x * 0.1
        elif kind == "v":
            x = x.abs() * 0.01 + 1e-4
        x = x.to(dtype)
        t = x[1:] if misalign else x[:n].clone()
        t = t.view(shape)
        if layout == "cl":
            t = t.contiguous(memory_format=torch.channels_last)
        out.append(t)
    return out


def opt_case(dev, spec, seed):
    """The tensors of one O1/O2 case, made twice from ``seed`` (the same
    values and memory layout for the kernel and the plain version)."""
    import torch

    sizes = spec.get("sizes", OPT_SIZES)
    kw = dict(misalign=spec.get("misalign", False),
              layout=spec.get("layout"))
    w_dt, g_dt, s_dt = spec["dtypes"]
    mp = spec.get("mp", False)
    case = {"w": opt_buffers(dev, sizes, w_dt, seed, "w", **kw),
            "g": opt_buffers(dev, sizes, g_dt, seed + 1, "g", **kw),
            "m": opt_buffers(dev, sizes, s_dt, seed + 2, "m", **kw),
            "v": opt_buffers(dev, sizes, s_dt, seed + 3, "v", **kw)}
    if mp:
        case["w32"] = [w.float().add_(1e-3) for w in case["w"]]
    n = len(sizes)
    case["lrs"] = [1.0 if i % 3 else 0.5 for i in range(n)]
    case["wds"] = [0.0 if i % 2 else 0.01 for i in range(n)]
    case["etas"] = [1.0 if i % 2 else 0.5 for i in range(n)]
    case["lr"] = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    case["t"] = torch.full((), 3, dtype=torch.int32, device=dev)
    case["rescale"] = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    return case


def run_adamw(oo, c, fn, form):
    """O1 (``fn`` the wrapper or the plain version) on case ``c``:
    ``form`` "adamw"/"adam" (class forms: device lr and count) or "op"
    (the op form: rates, etas, a device rescale)."""
    common = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, clip_gradient=1.0,
                  weights32=c.get("w32"))
    if form == "op":
        fn(c["w"], c["g"], c["m"], c["v"], [1e-3 * x for x in c["lrs"]],
           c["wds"], etas=c["etas"], rescale_grad=c["rescale"], **common)
    else:
        fn(c["w"], c["g"], c["m"], c["v"], c["lrs"], c["wds"], lr=c["lr"],
           t=c["t"], rescale_grad=0.5, fold_wd=form == "adam", **common)
    return c["w"], c["m"], c["v"], c.get("w32")


def run_sgd(oo, c, fn, form):
    """O2 on case ``c``: ``form`` "plain", "momentum", "nesterov" (class
    forms: a device lr with per-tensor factors) or "preloaded" (device
    arrays of rates and decays)."""
    import torch

    kind = {"plain": oo.SGD_PLAIN, "momentum": oo.SGD_MOMENTUM,
            "nesterov": oo.SGD_NESTEROV, "preloaded": oo.SGD_MOMENTUM}[form]
    moms = None if kind == oo.SGD_PLAIN else c["m"]
    common = dict(momentum=0.9, kind=kind, rescale_grad=0.5,
                  clip_gradient=1.0, weights32=c.get("w32"))
    if form == "preloaded":
        dev = c["w"][0].device
        fn(c["w"], c["g"], moms, None, None,
           dev_lrs=torch.tensor([0.1 * x for x in c["lrs"]],
                                dtype=torch.float32, device=dev),
           dev_wds=torch.tensor(c["wds"], dtype=torch.float32, device=dev),
           **common)
    else:
        fn(c["w"], c["g"], moms, c["lrs"], c["wds"], lr=c["lr"] * 100,
           **common)
    return c["w"], (c["m"] if moms is not None else None), None, \
        c.get("w32")


def opt_compare(oo, dev, spec, seed, runner, fn_kernel, fn_plain, form):
    """One case through the kernel and the plain version: per output
    (weights, states, masters) its reading and whether it is within the
    tolerance; returns (ok, worst abs error, readings)."""
    a, b = opt_case(dev, spec, seed), opt_case(dev, spec, seed)
    got = runner(oo, a, fn_kernel, form)
    want = runner(oo, b, fn_plain, form)
    ok, err, readings = True, 0.0, {}
    for name, g, w in zip(("w", "m", "v", "w32"), got, want):
        if g is None:
            continue
        r = opt_reading(g, w)
        readings[name] = r
        ok = ok and opt_within(r, g[0].dtype)
        err = max(err, r[2])
    return ok, err, readings


def opt_specs():
    import torch

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    return [
        ("f32", dict(dtypes=(f32, f32, f32))),
        ("bf16", dict(dtypes=(bf16, bf16, bf16))),
        ("f16", dict(dtypes=(f16, f16, f16))),
        ("bf16 w, f32 g", dict(dtypes=(bf16, f32, bf16))),
        ("bf16 w, f32 state", dict(dtypes=(bf16, bf16, f32))),
        ("bf16 mp", dict(dtypes=(bf16, bf16, f32), mp=True)),
        ("f16 mp", dict(dtypes=(f16, f16, f32), mp=True)),
        ("bf16 misaligned", dict(dtypes=(bf16, bf16, bf16), misalign=True)),
        ("f32 misaligned", dict(dtypes=(f32, f32, f32), misalign=True)),
        ("bf16 channels-last", dict(dtypes=(bf16, bf16, bf16),
                                    sizes=OPT_CL_SHAPES, layout="cl")),
        ("bf16 long list", dict(dtypes=(bf16, bf16, bf16),
                                sizes=tuple(17 + 37 * i
                                            for i in range(OPT_LONG)))),
    ]


def sum_sq_lists(dev):
    """O3's check lists: (name, tensors)."""
    import torch

    lists = []
    for name, spec in opt_specs():
        w_dt, g_dt, _ = spec["dtypes"]
        kw = dict(misalign=spec.get("misalign", False),
                  layout=spec.get("layout"))
        sizes = spec.get("sizes", OPT_SIZES)
        lists.append((name, opt_buffers(dev, sizes, w_dt, 5, "g", **kw)
                      + opt_buffers(dev, sizes[:3], g_dt, 6, "w", **kw)))
    mixed = opt_buffers(dev, OPT_SIZES, torch.float32, 7, "g") \
        + opt_buffers(dev, OPT_SIZES, torch.bfloat16, 8, "g") \
        + opt_buffers(dev, OPT_SIZES, torch.float16, 9, "g") \
        + [torch.zeros(0, device=dev)]
    lists.append(("mixed dtypes and an empty tensor", mixed))
    return lists


def sum_sq_check(oo, arrays, plant=None):
    """O3 against an f64 host sum (within 1e-6 relative) and its flag
    against the host's (exact), optionally with a non-finite value
    planted in the middle tensor.  Returns (ok, worst relative error)."""
    import torch

    if plant is not None and arrays:
        mid = arrays[len(arrays) // 2]
        if mid.numel():     # dense memory, in any dim order
            flat = torch.as_strided(mid, (mid.numel(),), (1,),
                                    mid.storage_offset())
            flat[mid.numel() // 2] = plant
    sums, flag = oo.multi_sum_sq(arrays)
    host = [a.detach().cpu().double() for a in arrays]
    want = torch.tensor([h.square().sum().item() for h in host],
                        dtype=torch.float64)
    want_flag = 1.0 if all(bool(torch.isfinite(h).all()) for h in host) \
        else 0.0
    got = sums.cpu().double()
    fin = torch.isfinite(want)
    rel = ((got[fin] - want[fin]).abs() / want[fin].clamp(min=1e-30))
    worst = rel.max().item() if rel.numel() else 0.0
    return (worst <= 1e-6 and float(flag[0]) == want_flag), worst


@contextlib.contextmanager
def planted_optimizer_library(oo, path):
    """``oo``'s kernels taken from the library at ``path`` (built with a
    planted fault) inside the block."""
    import ctypes

    from mxnet_tpu_torch.ops import _build

    good = oo._load()
    lib = ctypes.CDLL(path)
    oo._bind(lib)
    _build._libs[oo._SOURCE] = lib
    try:
        yield
    finally:
        _build._libs[oo._SOURCE] = good


def optimizer_checks(oo, dev, planted_path=None):
    """O1-O3 against their plain versions on the card over every dtype
    set, ragged sizes, a misaligned view, channels-last weights and a
    list longer than one table, then the planted fault (a table that
    skips its last tensor) caught by the same checks."""
    worst = {"O1": 0.0, "O2": 0.0, "O3": 0.0}
    failed = []
    seed = 100
    for name, spec in opt_specs():
        forms = [("O1", run_adamw, oo.multi_adamw, oo._multi_adamw_ref, f)
                 for f in ("adamw", "adam", "op")]
        forms += [("O2", run_sgd, oo.multi_sgd, oo._multi_sgd_ref, f)
                  for f in ("plain", "momentum", "nesterov", "preloaded")]
        for kern, runner, fk, fp, form in forms:
            seed += 10
            ok, err, readings = opt_compare(oo, dev, spec, seed, runner, fk,
                                            fp, form)
            worst[kern] = max(worst[kern], err)
            if not ok:
                failed.append("%s %s %s %s" % (kern, form, name, readings))
    for plant in (None, float("inf"), float("nan")):
        for name, arrays in sum_sq_lists(dev):
            ok, rel = sum_sq_check(oo, arrays, plant)
            worst["O3"] = max(worst["O3"], rel)
            if not ok:
                failed.append("O3 %s plant %s: relative error %.3g"
                              % (name, plant, rel))
    log("optimizer checks: O1 (3 forms) and O2 (4 forms) over %d cases "
        "each (f32, bf16, f16, mixed grad and state dtypes, mp masters, "
        "misaligned views, channels-last, %d tensors), O3 over %d lists "
        "with nothing, an inf and a nan planted; worst abs error O1 %.3g, "
        "O2 %.3g; O3 worst relative error %.3g against an f64 host sum"
        % (len(opt_specs()), OPT_LONG, len(sum_sq_lists(dev)), worst["O1"],
           worst["O2"], worst["O3"]))
    if failed:
        fail("optimizer kernels disagree with their plain versions: %s"
             % "; ".join(failed[:6]))
    if planted_path is None:
        return
    import torch

    spec = dict(opt_specs())["bf16"]
    with planted_optimizer_library(oo, planted_path):
        caught = {
            "O1": not opt_compare(oo, dev, spec, 7, run_adamw,
                                  oo.multi_adamw, oo._multi_adamw_ref,
                                  "adamw")[0],
            "O2": not opt_compare(oo, dev, spec, 7, run_sgd, oo.multi_sgd,
                                  oo._multi_sgd_ref, "momentum")[0],
            "O3": not sum_sq_check(oo, opt_buffers(
                dev, OPT_SIZES, torch.float32, 77, "g"))[0]}
    log("optimizer checks: a table that skips its last tensor is caught: "
        "%s" % caught)
    if not all(caught.values()):
        fail("the optimizer check passes a table that skips its last "
             "tensor: %s" % caught)


def llama_param_shapes(layers):
    """The parameter shapes of Llama-3-8B's geometry at ``layers`` layers
    (the train phase's model): embedding, per layer two norms and the
    seven projections, the final norm and the head."""
    c = LLAMA3_8B
    u, h, v = c["units"], c["hidden_size"], c["vocab_size"]
    kv = c["num_kv_heads"] * c["head_dim"]
    shapes = [(v, u)]
    for _ in range(layers):
        shapes += [(u,), (u, u), (kv, u), (kv, u), (u, u), (u,), (h, u),
                   (h, u), (u, h)]
    return shapes + [(u,), (v, u)]


def timed_update(fn, iters, warmup=1):
    """Device ms of one call of ``fn``, the calls queued behind a sleep so
    that a host enqueue slower than the kernels (a list of hundreds of
    small tensors) is not what is timed."""
    return queued_ms(lambda i: fn(), iters, warmup=warmup)


def host_us(fn, iters=20):
    """Host µs to enqueue one call of ``fn`` (the wrapper's checks and
    table building), after a synchronize, without waiting for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def library_ms(name, timer):
    """``timer(torch.<name>)``: a library call's time as a yardstick, or
    None (logged) where this torch lacks it or refuses the inputs."""
    import torch

    fn = getattr(torch, name, None)
    if fn is None:
        log("optimizer timing: torch.%s is not in torch %s"
            % (name, torch.__version__))
        return None
    try:
        return timer(fn)
    except RuntimeError as e:
        log("optimizer timing: torch.%s refused the inputs: %s" % (name, e))
        return None


def main_shape_check(what, outputs, dtypes_of=None):
    """Kernel results against plain-version results computed on identical
    copies at a train path's own shapes: ``outputs`` maps a name to (the
    kernel's tensors, the plain version's).  Each name is read per dtype
    and held to ``opt_within``; fails on a miss.  Returns the worst abs
    error."""
    err, failed, lines = 0.0, [], []
    for name, (got, want) in outputs.items():
        by_dtype = {}
        for g, w in zip(got, want):
            by_dtype.setdefault(g.dtype, ([], []))
            by_dtype[g.dtype][0].append(g)
            by_dtype[g.dtype][1].append(w)
        for dtype, (gs, ws) in by_dtype.items():
            r = opt_reading(gs, ws)
            err = max(err, r[2])
            lines.append("%s %s: %d ulp most, %.6f equal, abs %.3g"
                         % (name, str(dtype).replace("torch.", ""), *r))
            if not opt_within(r, dtype):
                failed.append(lines[-1])
    log("optimizer check at the train shapes: %s: %s"
        % (what, "; ".join(lines)))
    if failed:
        fail("optimizer kernel disagrees with its plain version at the "
             "train shapes (%s): %s" % (what, "; ".join(failed)))
    return err


def sum_sq_main_check(oo, arrays):
    """O3 against its plain version (an f64 sum rounded to f32) on the
    train path's gradients: sums within 1e-6 relative, flags equal and
    1.0; then a nan planted in the last tensor must clear the kernel's
    flag (the value is put back).  Returns the worst abs error."""
    sums, flag = oo.multi_sum_sq(arrays)
    want, want_flag = oo._multi_sum_sq_ref(arrays)
    diff = (sums.double() - want.double()).abs()
    rel = (diff / want.double().abs().clamp(min=1e-30)).max().item()
    err = diff.max().item()
    last = arrays[-1].view(-1)
    keep = last[-1].clone()
    last[-1] = float("nan")
    planted = float(oo.multi_sum_sq(arrays)[1][0])
    last[-1] = keep
    log("optimizer check at the train shapes: O3 over the Llama gradients "
        "(%d tensors): worst relative error %.3g, abs %.6g against the "
        "plain version; flag %s (plain %s); with a nan planted %s"
        % (len(arrays), rel, err, float(flag[0]), float(want_flag[0]),
           planted))
    if not (rel <= 1e-6 and float(flag[0]) == float(want_flag[0]) == 1.0
            and planted == 0.0):
        fail("O3 disagrees with its plain version at the train shapes: "
             "relative error %.3g, flag %s against %s, planted nan flag %s"
             % (rel, float(flag[0]), float(want_flag[0]), planted))
    return err


def optimizer_timing(oo, dev):
    """Each kernel at its train shapes: first held against its plain
    version on identical copies of the lists (the kernels line's
    ``max_abs_err``), then timed beside its byte bound, its plain version
    and the library yardstick: O1 over the 8-layer Llama list in bf16
    (class form, device lr and count), O2 (momentum) over ResNet-50's
    weights under amp bf16, O3 over the Llama gradients."""
    import torch

    from mxnet_tpu_torch import amp

    smi = nvidia_smi_line()
    out = {}
    shapes = llama_param_shapes(TRAIN_LAYERS)
    bf16 = torch.bfloat16
    w, g, m, v = (opt_buffers(dev, shapes, bf16, s, k)
                  for s, k in ((1, "w"), (2, "g"), (3, "m"), (4, "v")))
    n = sum(x.numel() for x in w)
    lr = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    t = torch.full((), 5, dtype=torch.int32, device=dev)
    ones = [1.0] * len(w)
    zeros = [0.0] * len(w)

    def o1(fn, ws, ms, vs):
        return lambda: fn(ws, g, ms, vs, ones, zeros, lr=lr, t=t)

    copies = [[x.clone() for x in xs] for xs in (w, m, v)]
    o1(oo.multi_adamw, w, m, v)()
    o1(oo._multi_adamw_ref, *copies)()
    o1_err = main_shape_check(
        "O1 over the %d-layer Llama list (%d tensors)"
        % (TRAIN_LAYERS, len(w)),
        dict(zip(("w", "m", "v"), zip((w, m, v), copies))))
    del copies
    gc.collect()
    torch.cuda.empty_cache()
    ms = timed_update(o1(oo.multi_adamw, w, m, v), 10)
    plain = timed_update(o1(oo._multi_adamw_ref, w, m, v), 2)
    steps = [torch.full((), 4.0, device=dev) for _ in w]
    lib = library_ms("_fused_adamw_", lambda f: timed_update(lambda: f(
        w, g, m, v, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), 10))
    nbytes = 14 * n
    out["O1"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                     bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                     bound_by="bytes", max_abs_err=o1_err)
    log("optimizer timing: O1 multi_adamw over the %d-layer Llama list "
        "(%d tensors, %.4g G bf16 elements, 14 B an element): %.4f ms, "
        "bound %.4f ms (bytes, %.1f%%), plain %.4f ms, torch._fused_adamw_ "
        "%s ms (a different function over the same bytes: its eps comes "
        "after the bias-corrected sqrt) | %s"
        % (TRAIN_LAYERS, len(w), n / 1e9, ms, out["O1"]["bound_ms"],
           100 * out["O1"]["bound_ms"] / ms, plain,
           "%.4f" % lib if lib is not None else "n/a (not in this torch)",
           smi))
    del w, m, v
    gc.collect()
    torch.cuda.empty_cache()
    o3_err = sum_sq_main_check(oo, g)
    sums_ms = timed_update(lambda: oo.multi_sum_sq(g), 10)
    sums_plain = timed_update(lambda: oo._multi_sum_sq_ref(g), 2)
    norm_ms = library_ms("_foreach_norm",
                         lambda f: timed_update(lambda: f(g), 10))
    nbytes = 2 * n
    out["O3"] = dict(ms=sums_ms, plain_ms=sums_plain, library_ms=norm_ms,
                     bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                     bound_by="bytes", max_abs_err=o3_err)
    log("optimizer timing: O3 multi_sum_sq over the Llama gradients (%.4g "
        "G bf16 elements): %.4f ms, bound %.4f ms (bytes, %.1f%%), plain "
        "%.4f ms, torch._foreach_norm %s ms (norms only, no finite flag)"
        % (n / 1e9, sums_ms, out["O3"]["bound_ms"],
           100 * out["O3"]["bound_ms"] / sums_ms, sums_plain,
           "%.4f" % norm_ms if norm_ms is not None else "n/a"))
    del g
    gc.collect()
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    try:
        net = resnet_net(dev, "resnet50_v1", 0)
        amp.convert_hybrid_block(net)
        x, _ = _resnet_batch(dev, 1, RESNET_IMAGE, 0, torch.bfloat16)
        resnet_shapes(net, x)
        ps = [p.detach() for p in net.parameters() if p.requires_grad]
    finally:
        amp.turn_off()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    # gradients and momenta with their weights' strides (channels-last
    # convolutions)
    grads = [torch.empty_like(p).copy_(
        torch.randn(p.shape, generator=gen, device=dev)) for p in ps]
    moms = [torch.empty_like(p).copy_(
        0.01 * torch.randn(p.shape, generator=gen, device=dev)) for p in ps]
    lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
    mults = [1.0] * len(ps)

    def o2(fn, ws, ms):
        return lambda: fn(ws, grads, ms, mults, [0.0] * len(ws), lr=lr,
                          momentum=0.9, kind=oo.SGD_MOMENTUM)

    copies = [[x.clone() for x in xs] for xs in (ps, moms)]
    o2(oo.multi_sgd, ps, moms)()
    o2(oo._multi_sgd_ref, *copies)()
    o2_err = main_shape_check(
        "O2 (momentum) over ResNet-50's %d amp weights in one call" % len(ps),
        dict(zip(("w", "mom"), zip((ps, moms), copies))))
    del copies
    ms = timed_update(o2(oo.multi_sgd, ps, moms), 20, warmup=3)
    enqueue = host_us(o2(oo.multi_sgd, ps, moms))
    plain = timed_update(o2(oo._multi_sgd_ref, ps, moms), 3)
    by_dtype = {}
    for i, p in enumerate(ps):
        by_dtype.setdefault(p.dtype, []).append(i)

    def lib_sgd(fused):
        def run():
            for idx in by_dtype.values():
                fused([ps[i] for i in idx], [grads[i] for i in idx],
                      [moms[i] for i in idx], weight_decay=0.0,
                      momentum=0.9, lr=0.1, dampening=0.0, nesterov=False,
                      maximize=False, is_first_step=False)
        return timed_update(run, 20, warmup=3)

    lib = library_ms("_fused_sgd_", lib_sgd)
    nbytes = sum(5 * p.numel() * p.element_size() for p in ps)
    out["O2"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                     bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                     bound_by="bytes", max_abs_err=o2_err)
    log("optimizer timing: O2 multi_sgd (momentum) over ResNet-50's %d "
        "weights (%.4g M elements, %s; 5 accesses an element): %.4f ms, "
        "bound %.4f ms (bytes, %.1f%%), plain %.4f ms, torch._fused_sgd_ "
        "%s ms (one call a dtype); the wrapper's host enqueue %.1f us a "
        "call" % (len(ps), sum(p.numel() for p in ps) / 1e6,
                  sorted({str(p.dtype) for p in ps}), ms,
                  out["O2"]["bound_ms"], 100 * out["O2"]["bound_ms"] / ms,
                  plain, "%.4f" % lib if lib is not None else "n/a",
                  enqueue))
    return out


def optimizer_phase(oo, dev, planted_path):
    optimizer_checks(oo, dev, planted_path)
    return optimizer_timing(oo, dev)


# -- phase 16: vision, the other families and saved signatures -------------

VISION_NETS = (("alexnet", 224), ("vgg16", 224), ("squeezenet1.1", 224),
               ("densenet121", 224), ("inceptionv3", 299),
               ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224))
VISION_INFER_BATCH = 32          # BASELINE.md's inference row
INCEPTION_IMAGE, INCEPTION_BATCH = 299, 128
# BASELINE.md (perf.md:243-254): Inception-v3 training on one V100 at
# batch 128, MXNet 1.2: a yardstick from another card, not this one
INCEPTION_V100_IMAGES_S = 253.68
AOT_INCEPTION_BATCH = 32
AOT_LLAMA = dict(vocab=1000, units=1024, hidden_size=2816, num_layers=2,
                 num_heads=8, num_kv_heads=8, tokens=(2, 256))
VISION_KINDS = (("pooling", ("pool",)),
                ("convolutions", ("conv", "cudnn", "xmma", "implicit",
                                  "nhwc", "dgrad", "wgrad", "winograd")),
                ("sgd (O2)", ("multi_sgd",)),
                ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_")),
                ("concat and copies", ("cat", "copy")),
                ("reductions", ("reduce_kernel",)),
                ("elementwise", ("elementwise",)))


def vision_net(dev, name, seed, he=False, **kw):
    """``vision.get_model(name)`` on ``dev`` with its deferred shapes,
    filled from a seeded generator at the first forward: Xavier, or
    with ``he`` the gaussian fan-in rule of magnitude 2, which keeps a
    deep ReLU net's activations near 1 (Xavier's mean of fan-in and
    fan-out shrinks them at every depthwise convolution: MobileNet's
    logits come out near 1e-19); a layer's own initializer first."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, device=dev, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net.initialize(initializer.Xavier("gaussian", "in", 2) if he
                   else initializer.Xavier(), generator=gen)
    return net


def vision_parity(dev):
    """Each family's representative at full width, batch 2, f32, TF32
    off, deterministic cuDNN: the card's predict-mode logits
    (channels-last) against the host's (NCHW) from the same weights
    (``load_jax_params`` permutes AlexNet's and VGG's flattened columns
    across the layouts), each held to the host's f64 run: within 1e-3 of
    the largest logit, or 3x the host f32 run's own error where that is
    larger (R6)."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import vision

    ok = True
    for i, (name, image) in enumerate(VISION_NETS):
        rng = np.random.RandomState(10 + i)
        x = rng.rand(2, 3, image, image).astype(np.float32)
        host = vision_net("cpu", name, 20 + i, he=True)
        resnet_shapes(host, torch.from_numpy(x))
        params = {k: t.detach().numpy()
                  for k, t in host._collect_params_with_prefix().items()}
        card = vision.load_jax_params(vision.get_model(name, device=dev),
                                      params, layout=host._layout)
        wide = vision.load_jax_params(vision.get_model(name, device="cpu"),
                                      params, layout=host._layout).double()
        outs = []
        with exact_convs(), torch.no_grad():
            for net in (card, host, wide):
                p = next(net.parameters())
                outs.append(net(torch.from_numpy(x).to(p.device, p.dtype))
                            .double().cpu())
        c, h, w = outs
        scale = w.abs().max().item() + 1e-30
        e_card = (c - w).abs().max().item() / scale
        e_host = (h - w).abs().max().item() / scale
        bound = max(1e-3, 3 * e_host)
        good = e_card <= bound and bool(torch.isfinite(c).all())
        ok &= good
        log("vision parity: %s at %d x %d, batch 2, f32: card (%s) %.3g, "
            "host f32 (%s) %.3g of the largest logit (%.4g) from the host's "
            "f64 run (bound %.3g) %s"
            % (name, image, image, card._layout, e_card, host._layout,
               e_host, scale, bound, "ok" if good else "FAIL"))
        del host, card, wide, outs
        gc.collect()
        torch.cuda.empty_cache()
    if not ok:
        fail("a vision family's card logits disagree with the host's")


def densenet_hybrid_check(dev):
    """f32, TF32 off, deterministic cuDNN: a hybridized DenseNet-121
    (channel concats kept channels-last) at batch 2: eager, captured and
    replayed calls in predict and train mode, bitwise equal to the
    eager net's, running statistics included."""
    import torch

    from mxnet_tpu_torch import autograd

    x, _ = _resnet_batch(dev, 2, 224, 8)
    outs = []
    with exact_convs():
        for hybrid in (False, True):
            net = vision_net(dev, "densenet121", 8)
            resnet_shapes(net, x)
            if hybrid:
                net.hybridize()
            with torch.no_grad():
                pred = [net(x).clone() for _ in range(3)]
                with autograd.train_mode():
                    train = [net(x).clone() for _ in range(3)]
            outs.append((pred + train, _state(net),
                         net.stats() if hybrid else None))
            del net
    (e_o, e_w, _), (h_o, h_w, st) = outs
    same = all(torch.equal(a, b) for a, b in zip(e_o, h_o)) \
        and _same(e_w, h_w)
    log("vision graphs: densenet121, batch 2, f32: 3 predict-mode and 3 "
        "train-mode hybridized calls against eager: outputs and running "
        "statistics %s; %d captures, %d replays"
        % ("bitwise equal" if same else "DIFFER", st["captures"],
           st["replays"]))
    if not same or (st["captures"], st["replays"]) != (2, 4):
        fail("the hybridized DenseNet is not bitwise equal to eager")


def vision_infer(dev):
    """Each representative at batch 32 under amp bf16 (seeded Xavier
    weights): the ``no_grad`` predict-mode forward, eager against
    hybridized (wall p50 of 10 synchronised calls after 3 each, images/s),
    the hybridized logits within 1e-2 of eager's largest."""
    import torch

    from mxnet_tpu_torch import amp

    rows = {}
    for i, (name, image) in enumerate(VISION_NETS):
        net = vision_net(dev, name, 30 + i, he=True)
        amp.convert_hybrid_block(net)
        x, _ = _resnet_batch(dev, VISION_INFER_BATCH, image, 40 + i,
                             torch.bfloat16)
        resnet_shapes(net, x)
        eager, want = timed_forward(net, x, 13)
        net.hybridize()
        hyb, got = timed_forward(net, x, 13)
        eager, hyb = sorted(eager[3:]), sorted(hyb[3:])
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        st = net.stats()
        b = VISION_INFER_BATCH
        log("vision infer: %s, batch %d at %d x %d, bf16, no_grad: eager ms "
            "p50 %.3f (min %.3f max %.3f), %.1f images/s; hybridized ms p50 "
            "%.3f (min %.3f max %.3f), %.1f images/s; logits %s (%.3g of "
            "the largest); %d capture, %d replays"
            % (name, b, image, image, p50(eager), eager[0], eager[-1],
               1e3 * b / p50(eager), p50(hyb), hyb[0], hyb[-1],
               1e3 * b / p50(hyb), "bitwise equal" if err == 0 else "differ",
               err, st["captures"], st["replays"]))
        if not bool(torch.isfinite(got.float()).all()) or err > 1e-2:
            fail("the hybridized %s forward disagrees with eager" % name)
        rows[name] = (p50(eager), p50(hyb))
        del net, want, got
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def inception_train_run(dev):
    """Inception-v3 at 299 x 299, 1000 classes, amp bf16, sgd lr 0.1,
    momentum 0.9, through ``JitTrainStep`` on seeded random images (as
    ``bench.py`` makes them): every step eager, then graphed (2 warm-up,
    8 timed and 1 profiled step each), then one ``step_n(10)`` window.
    Returns O2's launches."""
    import torch

    from mxnet_tpu_torch import amp, gluon, parallel
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    batch, image = INCEPTION_BATCH, INCEPTION_IMAGE
    t0 = time.perf_counter()
    net = vision_net(dev, "inceptionv3", 0)
    amp.convert_hybrid_block(net)
    x, y = _resnet_batch(dev, batch, image, 0, torch.bfloat16)
    step_flops, _ = resnet_shapes(net, x)
    n_params = sum(p.numel() for p in net.parameters())
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, graphs=False)
    log("inception train: Inception-v3, %.4g M parameters (bf16, BatchNorm "
        "f32), %s, batch %d at %d x %d, %.4g TFLOP a step (3 x 2 x the conv "
        "and dense multiply-adds), set-up %.1f s; cudnn.benchmark %s"
        % (n_params / 1e6, net._layout, batch, image, image,
           step_flops / 1e12, time.perf_counter() - t0,
           torch.backends.cudnn.benchmark))
    losses, rows = [], {}
    n_warm, n_timed = 2, 8
    reset_opt_counts(oo)
    for mode in ("eager", "graphed"):
        step.graphs = mode == "graphed"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(lambda: step.step(x, y), n_warm, n_timed)
        losses += [o.item() for o in outs]
        out, wall, busy, averages = profiled_step(lambda: step.step(x, y))
        losses.append(out.item())
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated(), step.stats())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last = step.step_n(10, x, y)
    torch.cuda.synchronize()
    window = time.perf_counter() - t1
    losses.append(last.item())
    o2 = opt_counts(oo)["O2"]
    n_steps = 2 * (n_warm + n_timed + 1) + 10
    log("inception train: O2 launched %d times over %d steps" % (o2, n_steps))
    if o2 < n_steps:
        fail("the Inception-v3 SGD update launched O2 %d times over %d "
             "steps" % (o2, n_steps))
    log("inception train: losses %s" % ["%.4f" % v for v in losses])
    if not all(math.isfinite(v) for v in losses):
        fail("an Inception-v3 train loss is not finite")
    log("inception train: loss at step 4 %.4f, at the last step %.4f, "
        "against %.4f at the first" % (losses[3], losses[-1], losses[0]))
    if not losses[3] < 0.9 * losses[0]:
        fail("the Inception-v3 loss did not fall over the first steps on "
             "the fixed batch")
    st = step.stats()
    if st["captures"] != 1 or st["replays"] != n_warm + n_timed + 10:
        fail("the graphed Inception-v3 step did not capture once and "
             "replay (%s)" % st)
    for mode, (times, wall, busy, averages, peak, st) in rows.items():
        p50_s = times[len(times) // 2]
        top, _, kern_ms = kernel_rows(averages)
        log("inception train: %s step ms p50 %.3f (min %.3f max %.3f over %d "
            "timed steps), %.1f images/s (a V100's, BASELINE.md: %.2f), "
            "%.1f%% MFU (%.4g model FLOP a step at 989 TFLOP/s bf16), own "
            "peak device memory %.2f GB"
            % (mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), batch / p50_s, INCEPTION_V100_IMAGES_S,
               100 * step_flops / p50_s / BF16_FLOPS, step_flops,
               (peak - held) / 1e9))
        log("inception train: %s profiled step: wall %.3f ms (the "
            "profiler's own cost in it), kernels busy %.3f ms (union of "
            "intervals): idle %.1f%% of the profiled step, %.1f%% of the "
            "p50 step; kernels summed %.3f ms; by kind %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (p50_s * 1e3)), kern_ms,
               ", ".join("%s %.3f" % kv for kv in kernel_kinds(
                   averages, VISION_KINDS).items())))
        for ms, n, key in top:
            log("inception train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        if mode == "graphed":
            log("inception train: graphed: %d capture in %.3f s, %d replays, "
                "%.1f us host time a replay outside it, graph pool %.1f MB"
                % (st["captures"], st["capture_s"], st["replays"],
                   1e6 * st["host_s"] / max(st["replays"], 1),
                   st["pool_bytes"] / 1e6))
    log("inception train: step_n(10): %.3f s, %.1f images/s, %.3f ms a step"
        % (window, 10 * batch / window, 100 * window))
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    return o2


# What fresh processes do with saved signatures (``vision-child``): the
# exporting process saves the weights and the bundles; the loading
# process reads both; the plain process reads the weights only and runs
# as a process without a bundle does (eager first call, then the
# capture), the yardstick of what a bundle saves.

def _synced_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _aot_block(net, x, role, tmp, name, before_call=lambda: None):
    """``net``'s forward on ``x`` under ``no_grad``, hybridized: the
    exporter (fresh weights) saves ``.params``, the bundle and its second
    call's output; the loader reads both and hybridizes with ``aot=``
    (``before_call`` runs just before its first call); the plain process
    reads the weights and hybridizes without."""
    import torch

    from mxnet_tpu_torch import compile_cache

    path = os.path.join(tmp, name + ".aot")
    params = os.path.join(tmp, name + ".params")
    res = {}
    with torch.no_grad():
        if role == "load":
            net.load_parameters(params)
            loads = compile_cache.stats()["aot_loads"]
            _, res["prepare_ms"] = _synced_ms(lambda: net.hybridize(
                aot=path))
            res["aot_loads"] = compile_cache.stats()["aot_loads"] - loads
            res["captures_before"] = net.stats()["captures"]
            before_call()
            out, res["first_ms"] = _synced_ms(lambda: net(x))
            res["captures_after"] = net.stats()["captures"]
            res["replays"] = net.stats()["replays"]
        else:
            if role == "plain":
                net.load_parameters(params)
            net.hybridize(aot=path if role == "export" else None)
            first, res["first_ms"] = _synced_ms(lambda: net(x))
            out, res["second_ms"] = _synced_ms(lambda: net(x))
            res["first_equals_second"] = torch.equal(first, out)
        if role == "export":
            res["entries"] = len(compile_cache.load_bundle(path)["entries"])
            net.save_parameters(params)
            torch.save(out.cpu(), os.path.join(tmp, name + "_out.pt"))
        else:
            res["equal"] = torch.equal(out.cpu(), torch.load(
                os.path.join(tmp, name + "_out.pt")))
    res["finite"] = bool(torch.isfinite(out.float()).all())
    return res


def aot_llama(dev, role, tmp):
    """A small bf16 causal Llama (D 128: K1's wgmma path), hybridized;
    the loader's first call replays K1 once a layer."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import llama
    from mxnet_tpu_torch.ops import flash_attention as fa

    cfg = dict(AOT_LLAMA)
    vocab, shape = cfg.pop("vocab"), cfg.pop("tokens")
    net = llama.LlamaModel(vocab, device=dev, **cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(70)
    net.initialize(initializer.Xavier(), generator=gen)
    net.cast("bfloat16")
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, vocab, shape)).to(dev)
    def reset():
        fa.flash_attention.fwd_launches = 0

    reset()
    res = _aot_block(net, toks, role, tmp, "llama", reset)
    res["k1_launches"] = fa.flash_attention.fwd_launches
    return res


def aot_inception_hybrid(dev, role, tmp):
    """Hybridized Inception-v3 at batch 32, amp bf16 (the exporter's
    deferred parameters are filled at its first call)."""
    import torch

    from mxnet_tpu_torch import amp

    net = vision_net(dev, "inceptionv3", 50)
    amp.convert_hybrid_block(net)
    x, _ = _resnet_batch(dev, AOT_INCEPTION_BATCH, INCEPTION_IMAGE, 7,
                         torch.bfloat16)
    return _aot_block(net, x, role, tmp, "inception")


def aot_inception_step(dev, role, tmp):
    """The graphed Inception-v3 ``JitTrainStep`` (batch 128, amp bf16,
    sgd 0.1 momentum 0.9).  The exporter: a first step (eager), then
    ``save_executable``, ``save_states`` and ``save_parameters`` (the
    running statistics), then a second (capture and replay).  The
    loader: the parameters, ``load_executable`` (nothing stepped on:
    weights, running statistics, momentum and count unchanged),
    ``load_states``, and its first step, a replay, equal to the
    exporter's second: the loss and every weight bitwise.  The plain
    process: the parameters, then two steps (eager, then the capture).
    Dropout draws from a generator seeded just before the compared
    step."""
    import torch

    from mxnet_tpu_torch import amp, compile_cache, gluon, parallel

    net = vision_net(dev, "inceptionv3", 60)
    amp.convert_hybrid_block(net)
    x, y = _resnet_batch(dev, INCEPTION_BATCH, INCEPTION_IMAGE, 0,
                         torch.bfloat16)
    step = parallel.JitTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    names = {k: os.path.join(tmp, "step" + k) for k in
             (".aot", ".states", ".params", "_out.pt")}
    if role != "export":
        net.load_parameters(names[".params"])
    resnet_shapes(net, x)
    res = {}
    if role == "load":
        before = [t.clone() for t in net.state_dict().values()]
        loads = compile_cache.stats()["aot_loads"]
        _, res["prepare_ms"] = _synced_ms(lambda: step.load_executable(
            names[".aot"], x, y))
        res["aot_loads"] = compile_cache.stats()["aot_loads"] - loads
        res["not_stepped"] = all(torch.equal(a, b) for a, b in zip(
            before, net.state_dict().values())) \
            and int(step._count) == 0 and step._t == 0 \
            and not any(bool(s.any()) for s in step._opt_state
                        if s is not None)
        step.load_states(names[".states"])
        res["captures_before"] = step.stats()["captures"]
        torch.manual_seed(11)
        loss, res["first_ms"] = _synced_ms(lambda: step.step(x, y))
        res["captures_after"] = step.stats()["captures"]
        res["replays"] = step.stats()["replays"]
        ref = torch.load(names["_out.pt"])
        res["equal"] = torch.equal(loss.cpu(), ref["loss"]) and all(
            torch.equal(p.detach().cpu(), w)
            for p, w in zip(step._params, ref["weights"]))
    else:
        _, res["first_ms"] = _synced_ms(lambda: step.step(x, y))
        if role == "export":
            step.save_executable(names[".aot"])
            step.save_states(names[".states"])
            net.save_parameters(names[".params"])
        torch.manual_seed(11)
        loss, res["second_ms"] = _synced_ms(lambda: step.step(x, y))
        if role == "export":
            torch.save({"loss": loss.cpu(),
                        "weights": [p.detach().cpu() for p in step._params]},
                       names["_out.pt"])
    res["loss"] = float(loss)
    return res


def aot_nvrtc(role, tmp):
    """NVRTC's compile of the SwiGLU user kernels (K5: both templates in
    f32 and bf16) into a cache directory the exporter starts empty and
    the loader reads.  Run last: the nvcc libraries are loaded by then."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache

    compile_cache.configure({"MXNET_COMPILE_CACHE":
                             os.path.join(tmp, "nvrtc")})
    before = compile_cache.stats()
    t0 = time.perf_counter()
    kern = SwigluKernels(mx)
    for which in ("fwd", "bwd"):
        for dt in (torch.float32, torch.bfloat16):
            kern.kernel(which, dt)
    ms = 1e3 * (time.perf_counter() - t0)
    after = compile_cache.stats()
    return {"ms": ms, "cached": kern.module.cached,
            "hits": after["hits"] - before["hits"],
            "writes": after["writes"] - before["writes"]}


def vision_child(role, tmp):
    """One fresh process of the round trips (``role`` export, load or
    plain): CUDA, cuBLAS and cuDNN set up first, then the Llama, the
    hybridized Inception-v3 and its graphed step under deterministic
    cuDNN, then NVRTC (export and load); prints one ``VISION_CHILD
    {...}`` line."""
    import torch

    from mxnet_tpu_torch import amp

    dev = torch.device("cuda", 0)
    a = torch.randn(256, 256, device=dev)
    c = torch.nn.functional.conv2d(torch.randn(1, 3, 16, 16, device=dev),
                                   torch.randn(8, 3, 3, 3, device=dev))
    float((a @ a).sum() + c.sum())
    out = {}
    with exact_convs():
        out["llama"] = aot_llama(dev, role, tmp)
        amp.init("bfloat16")
        try:
            out["hybrid"] = aot_inception_hybrid(dev, role, tmp)
            gc.collect()
            torch.cuda.empty_cache()
            out["step"] = aot_inception_step(dev, role, tmp)
        finally:
            amp.turn_off()
    if role != "plain":
        out["nvrtc"] = aot_nvrtc(role, tmp)
    print("VISION_CHILD " + json.dumps(out), flush=True)
    return 0


def vision_round_trips(dev):
    """The saved signatures through fresh processes on the card: the
    exporting process, the loading one and the plain one
    (``vision_child``); each loaded path is bitwise equal to the
    exporter's with no capture at call time, ``load_executable`` steps
    on nothing, and the loader's NVRTC compile of the K5 kernels is a
    cache hit.  Logs what a bundle saves: the time to the first output,
    and to the first replayed one, of the loading process against the
    plain one's."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="vision_aot_")
    res = {}
    try:
        for role in ("export", "load", "plain"):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable,
                                os.path.join(REPO, "chip_smoke.py"),
                                "vision-child", role, tmp], cwd=REPO,
                               capture_output=True, text=True, timeout=900)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("VISION_CHILD ")]
            if r.returncode != 0 or not lines:
                fail("the %s process of the round trips failed (exit %d): "
                     "%s" % (role, r.returncode, r.stderr[-3000:]))
            res[role] = json.loads(lines[-1][len("VISION_CHILD "):])
            log("vision aot: %s process: %.1f s wall, %s"
                % (role, time.perf_counter() - t0, json.dumps(res[role])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, plain = res["load"], res["plain"]
    ok = True
    for path in ("llama", "hybrid", "step"):
        g = got[path]
        good = g["equal"] and g["captures_after"] == g["captures_before"] \
            and g["aot_loads"] >= 1 and g["replays"] >= 1
        ok &= good
        log("vision aot: %s: the loaded process's first call a replay "
            "(captures %d before it, %d after, %d replays, %d signatures "
            "loaded), %s to the exporter's"
            % (path, g["captures_before"], g["captures_after"],
               g["replays"], g["aot_loads"],
               "bitwise equal" if g["equal"] else "NOT EQUAL"))
    k1 = got["llama"]["k1_launches"]
    ok &= got["step"]["not_stepped"]
    ok &= k1 == AOT_LLAMA["num_layers"]
    log("vision aot: the loaded Llama's first call replayed K1 %d times "
        "(%d layers); load_executable stepped on nothing: %s"
        % (k1, AOT_LLAMA["num_layers"], got["step"]["not_stepped"]))
    for path, what in (
            ("hybrid", "hybridized Inception-v3, batch %d, bf16"
             % AOT_INCEPTION_BATCH),
            ("llama", "hybridized Llama (%d layers, %d x %d tokens, bf16)"
             % ((AOT_LLAMA["num_layers"],) + AOT_LLAMA["tokens"])),
            ("step", "graphed Inception-v3 step, batch %d, bf16"
             % INCEPTION_BATCH)):
        p, g = plain[path], got[path]
        log("vision aot: %s: without a bundle the first output after %.1f "
            "ms (eager) and the first replay %.1f ms later (capture + "
            "replay): %.1f ms; with it the load takes %.1f ms (warm-up and "
            "capture) and the first output, a replay, %.1f ms: %.1f ms, "
            "%.1f ms sooner to the first replay, %.1f ms later to the "
            "first output"
            % (what, p["first_ms"], p["second_ms"],
               p["first_ms"] + p["second_ms"], g["prepare_ms"],
               g["first_ms"], g["prepare_ms"] + g["first_ms"],
               p["first_ms"] + p["second_ms"] - g["prepare_ms"]
               - g["first_ms"],
               g["prepare_ms"] + g["first_ms"] - p["first_ms"]))
    cold, warm = res["export"]["nvrtc"], got["nvrtc"]
    ok &= warm["cached"] and warm["hits"] >= 1 and not cold["cached"] \
        and cold["writes"] >= 1
    log("vision aot: NVRTC, the SwiGLU user kernels (K5): cold %.1f ms (%d "
        "written), warm %.1f ms in the second process (%d hits, from the "
        "cache: %s)" % (cold["ms"], cold["writes"], warm["ms"],
                        warm["hits"], warm["cached"]))
    if not ok:
        fail("a saved-signature round trip failed on the card")


def vision_phase(dev):
    """The card-against-host check of each family, the hybridized
    DenseNet against eager, then under amp bf16 the families' inference
    timing and the main path (Inception-v3 trained through
    ``JitTrainStep``), then the round trips through fresh processes.
    Returns O2's launches."""
    import torch

    from mxnet_tpu_torch import amp

    start_profiler(dev)
    vision_parity(dev)
    densenet_hybrid_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    amp.init("bfloat16")
    try:
        vision_infer(dev)
        o2 = inception_train_run(dev)
    finally:
        amp.turn_off()
        torch.backends.cudnn.benchmark = False
    vision_round_trips(dev)
    return o2


# -- phase 17: DCGAN at full width -----------------------------------------

# Apache MXNet's example/gluon/dc_gan/dcgan.py: nz 100, ngf = ndf = 64,
# 64 x 64 x 3 images; Radford, Metz and Chintala 2016 (arXiv:1511.06434,
# section 4): batch 128, Adam 2e-4 with beta1 0.5, weights from N(0, 0.02)
GAN = dict(nz=100, ngf=64, ndf=64, nc=3, image=64, batch=128, lr=2e-4,
           beta1=0.5, sigma=0.02, seed=0)
GAN_PARITY_BATCH = 32
GAN_KINDS = (("convolutions", ("conv", "cudnn", "xmma", "implicit",
                               "dgrad", "wgrad", "winograd", "sm90_",
                               "cutlass", "nchw", "nhwc")),
             ("adam (O1)", ("multi_adamw",)),
             ("batch-norm statistics", ("reduce_kernel",)),
             ("copies", ("copy", "cat")),
             ("elementwise", ("elementwise",)))


def dcgan_nets(dev, g=GAN):
    """The upstream DCGAN generator and discriminator on the port's
    ``gluon.nn``, as a user's script builds them (deferred input widths,
    channel-first)."""
    from mxnet_tpu_torch.gluon import nn

    ngf, ndf = g["ngf"], g["ndf"]
    gen = nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        for i, (c, s, p) in enumerate(((ngf * 8, 1, 0), (ngf * 4, 2, 1),
                                       (ngf * 2, 2, 1), (ngf, 2, 1))):
            gen.add(nn.Conv2DTranspose(c, 4, s, p, use_bias=False,
                                       device=dev),
                    nn.BatchNorm(device=dev), nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(g["nc"], 4, 2, 1, use_bias=False,
                                   device=dev),
                nn.Activation("tanh"))
    disc = nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        for i, c in enumerate((ndf, ndf * 2, ndf * 4, ndf * 8)):
            disc.add(nn.Conv2D(c, 4, 2, 1, use_bias=False, device=dev))
            if i:
                disc.add(nn.BatchNorm(device=dev))
            disc.add(nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(1, 4, 1, 0, use_bias=False, device=dev),
                 nn.Flatten())
    return gen, disc


def gan_real(dev, n, seed, g=GAN):
    """The example's bright-square images (``train_dcgan.py:33-41``)
    scaled to 64 x 64 x 3, made on ``dev`` from ``seed``: -1 everywhere
    but one axis-aligned square of 1 whose side is 16 to 32 pixels."""
    import torch

    size = g["image"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.randint(16, 33, (n, 1, 1), generator=gen, device=dev)
    x0 = (torch.rand((n, 1, 1), generator=gen, device=dev)
          * (size - w + 1)).long()
    y0 = (torch.rand((n, 1, 1), generator=gen, device=dev)
          * (size - w + 1)).long()
    r = torch.arange(size, device=dev)
    rows = (r.view(1, -1, 1) >= y0) & (r.view(1, -1, 1) < y0 + w)
    cols = (r.view(1, 1, -1) >= x0) & (r.view(1, 1, -1) < x0 + w)
    img = torch.where(rows & cols, 1.0, -1.0)
    return img.unsqueeze(1).expand(n, g["nc"], size, size).contiguous()


class AdamF64:
    """Adam over a net's trainable tensors in f64, the port's formula
    (``g = grad / batch``; ``m`` and ``v`` from zero; ``w -= lr *
    sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``): the f64
    reference run's Trainer, where O1 and its plain version take f32,
    bf16 and f16 weights only."""

    def __init__(self, net, lr, beta1, beta2=0.999, eps=1e-8):
        import torch

        self.params = [p for p in net.parameters() if p.requires_grad]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.lr, self.b1, self.b2, self.eps, self.t = lr, beta1, beta2, \
            eps, 0

    def step(self, batch):
        import torch

        self.t += 1
        a = self.lr * math.sqrt(1 - self.b2 ** self.t) / (1 - self.b1
                                                           ** self.t)
        with torch.no_grad():
            for p, m, v in zip(self.params, self.m, self.v):
                g = p.grad / batch
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                p.sub_(a * m / (v.sqrt() + self.eps))


class GanScript:
    """The training loop of a user's DCGAN script on the port: two
    hybridizable nets, two ``gluon.Trainer``s (adam), one D step and
    one G step an iteration, ``SigmoidBinaryCrossEntropyLoss``, the
    noise from ``mx.nd.random.normal`` on the context."""

    def __init__(self, mx, ctx, gen, disc, batch, g=GAN):
        from mxnet_tpu_torch import gluon

        self.mx, self.ctx, self.gen, self.disc = mx, ctx, gen, disc
        self.batch, self.nz = batch, g["nz"]
        self.loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        opts = {"learning_rate": g["lr"], "beta1": g["beta1"]}
        self.d_tr = gluon.Trainer(disc.collect_params(), "adam", opts)
        self.g_tr = gluon.Trainer(gen.collect_params(), "adam", opts)
        self.ones = mx.nd.ones((batch,), ctx=ctx)
        self.zeros = mx.nd.zeros((batch,), ctx=ctx)

    def noise(self):
        return self.mx.nd.random.normal(0, 1, shape=(self.batch, self.nz,
                                                     1, 1), ctx=self.ctx)

    def iteration(self, real, noise=None, tick=lambda part: None):
        """One D step (real to 1, the detached fake to 0) and one G step
        (the fake to 1); returns the two losses as NDArrays.  ``tick``
        is called with each part's name as it ends."""
        autograd = self.mx.autograd
        noise = self.noise() if noise is None else noise
        loss_fn, disc, gen = self.loss_fn, self.disc, self.gen
        with autograd.record():
            out_r = disc(real).reshape((-1,))
            fake = gen(noise)
            out_f = disc(fake.detach()).reshape((-1,))
            errd = (loss_fn(out_r, self.ones)
                    + loss_fn(out_f, self.zeros)).mean()
        tick("D forward")
        errd.backward()
        tick("D backward")
        self.d_tr.step(self.batch)
        tick("D update")
        with autograd.record():
            out = disc(gen(noise)).reshape((-1,))
            errg = loss_fn(out, self.ones).mean()
        tick("G forward")
        errg.backward()
        tick("G backward")
        self.g_tr.step(self.batch)
        tick("G update")
        return errd, errg


def gan_weights(nets):
    """Every parameter and running statistic of ``nets``, detached, by
    name."""
    out = {}
    for tag, net in zip("GD", nets):
        for k, t in net._collect_params_with_prefix().items():
            out["%s.%s" % (tag, k)] = t.detach()
    return out


def gan_macs(gen, disc, noise, real):
    """Multiply-adds of one forward of each net at these inputs (every
    convolution and transposed convolution, from its shapes), and the
    generator's transposed convolutions with their input shapes; the
    nets are called eagerly here, before any ``hybridize()``."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv, _ConvTranspose

    macs = {"G": 0, "D": 0, "deconvs": []}
    hooks = []

    def counter(tag):
        def hook(m, inp, out):
            x = inp[0]
            if isinstance(m, _ConvTranspose):
                macs[tag] += x.numel() * math.prod(m.weight.shape[1:])
                macs["deconvs"].append((m, tuple(x.shape)))
            else:
                macs[tag] += out.numel() * math.prod(m.weight.shape[1:])
        return hook

    for tag, net in (("G", gen), ("D", disc)):
        for m in net.modules():
            if isinstance(m, _Conv):
                hooks.append(m.register_forward_hook(counter(tag)))
    try:
        with torch.no_grad(), autograd.predict_mode():
            gen(noise)
            disc(real)
    finally:
        for h in hooks:
            h.detach()
    return macs


def gan_iteration_flops(macs):
    """Model FLOP of one iteration: 2 x the multiply-adds of the passes
    it runs.  The D step runs D forward twice (real, fake) and backward
    twice, G forward once; the G step G forward, D forward and backward,
    G backward; a backward counts twice its forward (input and weight
    gradients): 4 G forwards and 9 D forwards in all."""
    return 2 * (4 * macs["G"] + 9 * macs["D"])


def gan_init(nets, sigma, generator=None):
    import mxnet_tpu_torch as mx

    for net in nets:
        net.initialize(mx.init.Normal(sigma), generator=generator)


def gan_parity(mx, dev):
    """Full width at batch ``GAN_PARITY_BATCH``, f32, TF32 off,
    deterministic cuDNN: one D-and-G iteration on the card against the
    same iteration of the port on the host in f32 and in f64, from the
    same weights, noise and images: the two losses, then every weight
    and running statistic after both Trainer steps.  The card's error
    (of the largest value, from the f64 run) must be within 1e-3, or 3x
    the host f32 run's own error where that is larger.  A weight's
    check allows the Adam coordinates whose gradient is so near zero
    that an f32 rounding flips its sign (that weight then moves 2 x lr
    the other way): at most 1e-5 of the elements, each within 2.5 x
    lr."""
    import torch

    b = GAN_PARITY_BATCH
    base = dcgan_nets("cpu")
    gen_t = torch.Generator()
    gen_t.manual_seed(GAN["seed"] + 1)
    noise = torch.randn((b, GAN["nz"], 1, 1), generator=gen_t)
    real = gan_real("cpu", b, GAN["seed"] + 2)
    gan_init(base, GAN["sigma"], gen_t)
    gan_macs(*base, noise, real)            # make the deferred shapes
    state = [net.state_dict() for net in base]
    runs = {}
    with exact_convs():
        for tag, where, dtype in (("card", dev, torch.float32),
                                  ("host f32", "cpu", torch.float32),
                                  ("host f64", "cpu", torch.float64)):
            nets = dcgan_nets(where)
            gan_init(nets, GAN["sigma"])
            gan_macs(*nets, noise.to(where), real.to(where))
            for net, st in zip(nets, state):
                net.load_state_dict(st)
                if dtype == torch.float64:
                    net.double()
            ctx = mx.gpu(0) if where != "cpu" else mx.cpu()
            script = GanScript(mx, ctx, *nets, b)
            if dtype == torch.float64:
                script.g_tr = AdamF64(nets[0], GAN["lr"], GAN["beta1"])
                script.d_tr = AdamF64(nets[1], GAN["lr"], GAN["beta1"])
            t0 = time.perf_counter()
            errd, errg = script.iteration(
                mx.nd.array(real.to(dtype).numpy(), ctx=ctx, dtype=dtype),
                mx.nd.array(noise.to(dtype).numpy(), ctx=ctx, dtype=dtype))
            losses = torch.tensor([float(errd.asscalar()),
                                   float(errg.asscalar())], dtype=torch.float64)
            runs[tag] = (losses, {k: v.double().cpu() for k, v in
                                  gan_weights(nets).items()})
            log("gan parity: %s iteration %.2f s, losses D %.6f G %.6f"
                % (tag, time.perf_counter() - t0, losses[0], losses[1]))
    (cl, cw), (hl, hw), (wl, ww) = runs["card"], runs["host f32"], \
        runs["host f64"]
    scale = wl.abs().max().item()
    e_card = (cl - wl).abs().max().item() / scale
    e_host = (hl - wl).abs().max().item() / scale
    bound = max(1e-3, 3 * e_host)
    ok = e_card <= bound
    log("gan parity: losses: card %.3g, host f32 %.3g of the largest (%.4g) "
        "from the host's f64 run (bound %.3g) %s"
        % (e_card, e_host, scale, bound, "ok" if ok else "FAIL"))
    lr = GAN["lr"]
    worst, flips, n_all = (0.0, 0.0, "", 0.0), 0, 0
    for k in ww:
        w = ww[k]
        s = w.abs().max().item() + 1e-30
        dc = (cw[k] - w).abs()
        dh = (hw[k] - w).abs()
        tensor_bound = max(1e-3, 3 * dh.max().item() / s)
        off = dc / s > tensor_bound
        flips += int(off.sum())
        n_all += w.numel()
        if bool(off.any()) and dc[off].max().item() > 2.5 * lr:
            ok = False
            log("gan parity: %s: %d elements off by up to %.3g (more than "
                "2.5 x lr) FAIL" % (k, int(off.sum()), dc[off].max().item()))
        e = (dc[~off].max().item() if bool((~off).any()) else 0.0) / s
        if e > worst[0]:
            worst = (e, dh.max().item() / s, k, tensor_bound)
    ok &= flips <= 1e-5 * n_all
    log("gan parity: %d weights and statistics (%d elements) after both "
        "Trainer steps: worst card error %.3g of its tensor's largest "
        "value (%s; host f32 %.3g, bound %.3g), %d elements past the bound "
        "(Adam sign flips, each within 2.5 x lr; at most %d allowed) %s"
        % (len(ww), n_all, worst[0], worst[2], worst[1], worst[3], flips,
           int(1e-5 * n_all), "ok" if ok else "FAIL"))
    if not ok:
        fail("the card's DCGAN iteration disagrees with the host's")


def gan_repro(mx, dev):
    """``mx.random.seed(7)``, initialize and train 3 hybridized
    iterations at full width (noise from ``nd.random.normal`` on the
    card), twice, with deterministic cuDNN: every weight and running
    statistic bitwise equal."""
    import torch

    ctx = mx.gpu(0)
    results = []
    real = mx.nd.array(gan_real(dev, GAN["batch"], GAN["seed"]), ctx=ctx)
    with exact_convs():
        for _ in range(2):
            mx.random.seed(7)
            nets = dcgan_nets(dev)
            gan_init(nets, GAN["sigma"])
            for net in nets:
                net.hybridize()
            script = GanScript(mx, ctx, *nets, GAN["batch"])
            losses = [[float(l.asscalar()) for l in script.iteration(real)]
                      for _ in range(3)]
            results.append((losses, gan_weights(nets)))
            del nets, script
    (la, wa), (lb, wb) = results
    same = la == lb and all(torch.equal(wa[k], wb[k]) for k in wa)
    log("gan repro: mx.random.seed(7), 3 hybridized iterations twice: "
        "losses %s; weights and statistics %s"
        % (la, "bitwise equal" if same else "DIFFER"))
    if not same:
        fail("two seeded DCGAN runs differ")


def gan_deconv_alone(deconvs):
    """The generator's transposed convolutions (``(layer, input shape)``
    from ``gan_macs``), each alone at its shape in the iteration (CUDA
    events, 20 runs): forward ms and backward ms (data and weight
    gradients), summed over the layers."""
    import torch

    from mxnet_tpu_torch.ops import nn as ops_nn

    fwd = bwd = 0.0
    for m, shape in deconvs:
        w = m.weight.detach().clone().requires_grad_()
        x = torch.randn(shape, device=w.device, requires_grad=True)
        kw = dict(m._kwargs)

        def run(i):
            return ops_nn._deconvolution(x, w, None, **kw)

        head = torch.randn_like(run(0))
        ms = cuda_ms(run, 20)
        fwd += ms
        bwd += cuda_ms(lambda i: torch.autograd.grad(run(i), (x, w), head),
                       20) - ms
    return fwd, bwd


@contextlib.contextmanager
def torch_defaults():
    """PyTorch's own defaults for the convolutions and products (cuDNN
    may use TF32, the f32 GEMMs do not; no autotuning, nothing forced
    deterministic), whatever an earlier phase set: what a user's f32
    script runs with."""
    import torch

    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = False, True
    b.cudnn.deterministic, b.cudnn.benchmark = False, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def gan_timed(mx, dev):
    """The main path: full width, batch 128, f32 (torch's defaults:
    cuDNN's convolutions may use TF32), as a user's script:
    eager, then both nets hybridized, 5 warm-up and 20 timed iterations
    each (one more profiled): p50 iteration ms (min, max), images/s,
    MFU from the shapes against 989 TFLOP/s, the idle share of the p50
    iteration, peak memory, kernels by kind with the transposed
    convolutions timed alone, and each net's replays and busy calls.
    Returns O1's launches."""
    import torch

    from mxnet_tpu_torch.ops import optimizer_ops as oo

    ctx = mx.gpu(0)
    b = GAN["batch"]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    mx.random.seed(GAN["seed"])
    nets = dcgan_nets(dev)
    gan_init(nets, GAN["sigma"])
    real_t = gan_real(dev, b, GAN["seed"])
    macs = gan_macs(*nets, torch.randn(b, GAN["nz"], 1, 1, device=dev),
                    real_t)
    flops = gan_iteration_flops(macs)
    n_params = [sum(p.numel() for p in net.parameters()) for net in nets]
    log("gan train: DCGAN at 64 x 64 x 3, nz %d, ngf = ndf = %d: G %.4g M "
        "and D %.4g M parameters, f32, batch %d, adam %.0e beta1 %.1f; "
        "one forward G %.4g and D %.4g GMAC, %.4g TFLOP an iteration "
        "(4 G and 9 D forwards' worth)"
        % (GAN["nz"], GAN["ngf"], n_params[0] / 1e6, n_params[1] / 1e6, b,
           GAN["lr"], GAN["beta1"], macs["G"] / 1e9, macs["D"] / 1e9,
           flops / 1e12))
    real = mx.nd.array(real_t, ctx=ctx)
    script = GanScript(mx, ctx, *nets, b)

    def iteration():
        # the losses without their graphs: an eager iteration's graph
        # still held holds the parameters' AccumulateGrad nodes, made on
        # the default stream, and the first capture after it fails
        # (cudaErrorStreamCaptureImplicit; ROADMAP §1)
        return tuple(t.detach() for t in script.iteration(real))

    reset_opt_counts(oo)
    rows, parts = {}, {}
    losses = []
    n_warm, n_timed = 5, 20
    for mode in ("eager", "hybridized"):
        if mode == "hybridized":
            for net in nets:
                net.hybridize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(iteration, n_warm, n_timed)
        if mode == "eager":
            extra = gan_class_cost(nets, script, real, iteration)
        parts[mode] = gan_parts(script, real)
        losses += [(float(d.asscalar()), float(g.asscalar()))
                   for d, g in outs]
        out, wall, busy, averages = profiled_step(iteration)
        losses.append(tuple(float(t.asscalar()) for t in out))
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated(),
                      [net.stats() for net in nets])
    o1 = opt_counts(oo)["O1"]
    n_iters = 2 * (n_warm + n_timed + 1 + 7) + extra
    log("gan train: O1 launched %d times over %d iterations (two Trainers)"
        % (o1, n_iters))
    if o1 < 2 * n_iters:
        fail("the DCGAN Adam updates launched O1 %d times over %d "
             "iterations" % (o1, n_iters))
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail("a DCGAN loss is not finite")
    log("gan train: losses (D, G) first %s, last %s"
        % (["%.4f" % v for v in losses[0]], ["%.4f" % v for v in losses[-1]]))
    fwd_ms, bwd_ms = gan_deconv_alone(macs["deconvs"])
    for mode, (times, wall, busy, averages, peak, stats) in rows.items():
        p50_s = times[len(times) // 2]
        top, _, kern_ms = kernel_rows(averages)
        log("gan train: %s iteration ms p50 %.3f (min %.3f max %.3f over %d "
            "timed), %.1f images/s, %.2f%% MFU (%.4g model FLOP at 989 "
            "TFLOP/s), own peak device memory %.3f GB"
            % (mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), b / p50_s, 100 * flops / p50_s / BF16_FLOPS, flops,
               (peak - held) / 1e9))
        log("gan train: %s profiled iteration: wall %.3f ms (the profiler's "
            "own cost in it), kernels busy %.3f ms: idle %.1f%% of the "
            "profiled iteration, %.1f%% of the p50 iteration; kernels "
            "summed %.3f ms; by kind %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (p50_s * 1e3)), kern_ms,
               ", ".join("%s %.3f" % kv for kv in kernel_kinds(
                   averages, GAN_KINDS).items())))
        for ms, n, key in top[:8]:
            log("gan train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
        log("gan train: %s parts of an iteration (ms, synchronised at each "
            "end, median of 7): %s" % (mode, ", ".join(
                "%s %.3f" % kv for kv in parts[mode].items())))
        for tag, st in zip(("gen", "disc"), stats):
            log("gan train: %s %s: %d captures, %d replays, %d backward "
                "replays, %d busy calls run eagerly"
                % (mode, tag, st["captures"], st["replays"],
                   st.get("backward_replays", 0), st["busy_calls"]))
    log("gan train: the generator's 5 transposed convolutions alone at the "
        "iteration's shapes: forward %.3f ms, backward %.3f ms; an "
        "iteration runs the forward twice and the backward once: %.3f ms"
        % (fwd_ms, bwd_ms, 2 * fwd_ms + bwd_ms))
    del script, nets
    gc.collect()
    torch.cuda.empty_cache()
    return o1


def gan_class_cost(nets, script, real, iteration, n=15):
    """The host cost of the classes that make a block's tensors work as
    their handles (``GluonParameter``/``GluonBuffer``: ``.data`` and
    ``.grad`` are Python properties): the eager iteration's p50 ms and
    the two Trainers' steps (the parts' medians) with the nets' tensors
    in those classes and re-classed to torch's own, in eight runs
    alternated (gluon, plain, plain, gluon, twice), and the host us of
    reading every parameter's ``.grad`` once in each.  Returns the
    iterations it ran."""
    import torch

    from mxnet_tpu_torch.gluon import parameter as gp

    iteration()                 # every deferred parameter materialized
    tensors = [t for net in nets
               for t in list(net.parameters()) + list(net.buffers())]
    classes = [type(t) for t in tensors]
    plain = {gp.GluonParameter: torch.nn.Parameter,
             gp.GluonBuffer: torch.Tensor}
    params = [t for net in nets for t in net.parameters()]
    rows = {"gluon": [], "plain": []}
    pooled = {"gluon": [], "plain": []}
    order = ("gluon", "plain", "plain", "gluon") * 2
    try:
        for kind in order:
            for t, c in zip(tensors, classes):
                t.__class__ = plain.get(c, c) if kind == "plain" else c
            times, _ = timed_steps(iteration, 2, n)
            pooled[kind] += times
            part = gan_parts(script, real, n=5)
            t0 = time.perf_counter()
            for _ in range(100):
                for p in params:
                    _ = p.grad
            read_us = 1e6 * (time.perf_counter() - t0) / 100
            rows[kind].append((1e3 * times[len(times) // 2],
                               part["D update"] + part["G update"], read_us))
    finally:
        for t, c in zip(tensors, classes):
            t.__class__ = c
    for kind, got in rows.items():
        every = sorted(pooled[kind])
        log("gan train: F8's classes, eager, tensors %s: iteration ms p50 "
            "%.3f over its %d runs' %d iterations (each run's: %s), both "
            "updates ms %s, every .grad read once %s us (%d parameters)"
            % ("as GluonParameter/GluonBuffer" if kind == "gluon"
               else "re-classed to torch's", 1e3 * every[len(every) // 2],
               len(got), len(every), *(
                   " / ".join("%.3f" % r[i] for r in got) for i in range(3)),
               len(params)))
    return 1 + len(order) * (2 + n + 5)


def gan_parts(script, real, n=7):
    """Wall ms of each part of an iteration, the card synchronised at
    each part's end (so a part's host and device time both count):
    ``{part: median ms}`` over ``n`` iterations."""
    import torch

    rows = {}

    def tick(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.setdefault(part, []).append(now - last[0])
        last[0] = now

    for _ in range(n):
        torch.cuda.synchronize()
        last = [time.perf_counter()]
        script.iteration(real, tick=tick)
    return {k: 1e3 * sorted(v)[len(v) // 2] for k, v in rows.items()}


def gan_amp(mx, dev):
    """One iteration under ``amp.init("bfloat16")`` at full width: the
    generator's transposed convolutions must run in bf16 (a forward hook
    reads each one's output dtype) and the losses must be finite."""
    import torch

    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.nn.conv_layers import _ConvTranspose

    ctx = mx.gpu(0)
    mx.random.seed(GAN["seed"])
    nets = dcgan_nets(dev)
    gan_init(nets, GAN["sigma"])
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in nets[0].modules() if isinstance(m, _ConvTranspose)]
    script = GanScript(mx, ctx, *nets, GAN["batch"])
    real = mx.nd.array(gan_real(dev, GAN["batch"], GAN["seed"]), ctx=ctx)
    amp.init("bfloat16")
    try:
        errd, errg = script.iteration(real)
        losses = (float(errd.asscalar()), float(errg.asscalar()))
    finally:
        amp.turn_off()
        for h in hooks:
            h.detach()
    ok = seen and all(d == torch.bfloat16 for d in seen) \
        and all(math.isfinite(v) for v in losses)
    log("gan amp: bf16 iteration: %d Deconvolution calls in %s; losses D "
        "%.4f G %.4f %s" % (len(seen), sorted({str(d) for d in seen}),
                            losses[0], losses[1], "ok" if ok else "FAIL"))
    if not ok:
        fail("under amp the generator's Deconvolution did not run in bf16")


def gan_phase(mx, dev):
    """DCGAN's parity, reproducibility, timed main path and amp
    iteration.  Returns O1's launches on the main path."""
    start_profiler(dev)
    gan_parity(mx, dev)
    gan_repro(mx, dev)
    with torch_defaults():
        o1 = gan_timed(mx, dev)
        gan_amp(mx, dev)
    return o1


# -- phase 18: the op tail on the card -------------------------------------

# Each sampler of ops/random_ops.py with the scipy distribution its draws
# follow: (label, op, attrs, scipy name, its arguments, continuous).
SAMPLERS = (
    ("uniform", "_random_uniform", dict(low=-1.0, high=3.0), "uniform",
     dict(loc=-1.0, scale=4.0), True),
    ("normal", "_random_normal", dict(loc=0.5, scale=2.0), "norm",
     dict(loc=0.5, scale=2.0), True),
    ("gamma", "_random_gamma", dict(alpha=2.5, beta=1.5), "gamma",
     dict(a=2.5, scale=1.5), True),
    ("gamma a<1", "_random_gamma", dict(alpha=0.5, beta=1.0), "gamma",
     dict(a=0.5), True),
    ("exponential", "_random_exponential", dict(lam=2.0), "expon",
     dict(scale=0.5), True),
    ("gumbel", "_random_gumbel", dict(loc=1.0, scale=2.0), "gumbel_r",
     dict(loc=1.0, scale=2.0), True),
    ("poisson", "_random_poisson", dict(lam=4.0), "poisson",
     dict(mu=4.0), False),
    ("negative_binomial", "_random_negative_binomial", dict(k=3, p=0.4),
     "nbinom", dict(n=3, p=0.4), False),
    ("randint", "_random_randint", dict(low=-3, high=7), "randint",
     dict(low=-3, high=7), False),
    ("bernoulli", "_random_bernoulli", dict(prob=0.3), "bernoulli",
     dict(p=0.3), False),
)
# the _sample_* ops: parameter rows, each with its own distribution
SAMPLE_ROWS = (
    ("sample_uniform", "_sample_uniform", ([-1.0, 2.0], [3.0, 2.5]),
     "uniform", lambda lo, hi: dict(loc=lo, scale=hi - lo), True),
    ("sample_normal", "_sample_normal", ([0.0, -2.0], [1.0, 0.5]), "norm",
     lambda mu, sigma: dict(loc=mu, scale=sigma), True),
    ("sample_gamma", "_sample_gamma", ([2.5, 0.7], [1.5, 2.0]), "gamma",
     lambda a, b: dict(a=a, scale=b), True),
)
MULTINOMIAL_P = (0.1, 0.2, 0.3, 0.4)
KS_ALPHA = 1e-6


def op_tail_cases():
    """Every op of this slice but the samplers, at small shapes:
    ``(label, op, numpy inputs, attrs, kind)``, where ``kind`` says how
    the card's result is held to the host's: ``exact`` (bitwise, NaN
    where NaN: ordering, indexing and integer results, ties included),
    ``f32`` (within 1e-5 of the largest value), ``linalg`` (1e-4) or
    ``recon`` (a factorization whose signs are free: its product within
    1e-4)."""
    rs = np.random.RandomState(0)

    def f(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    def pos(*shape, lo=0.2, hi=2.0):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def spd(n, batch=()):
        a = f(*(batch + (n, n)))
        return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(
            np.float32)

    low = (np.tril(f(5, 5)) + 4 * np.eye(5)).astype(np.float32)
    ties = np.array([[3, 1, 3, 2, 1, 3, 0, 3], [0, 0, 5, 5, 0, 2, 5, 0],
                     [7, 7, 7, 7, 7, 7, 7, 7]], np.float32)
    counts = np.array([[0, 1, 3], [2, 5, 0]], np.float32)
    qkv = f(6, 2, 3 * 4 * 8)
    cases = [
        ("Embedding F3", "Embedding",
         [np.array([0, -1, 3, -4, 1.7], np.float32),
          np.ones((3, 2), np.float32)], {}, "exact"),
        ("Embedding", "Embedding", [rs.randint(-40, 40, (4, 6)).astype(
            np.float32), f(32, 16)], {}, "exact"),
        ("FullyConnected", "FullyConnected", [f(8, 3, 4), f(16, 12), f(16)],
         {"num_hidden": 16}, "f32"),
        ("Deconvolution", "Deconvolution", [f(2, 8, 5, 5), f(8, 4, 4, 4)],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 4}, "f32"),
        ("Deconvolution adj>=stride", "Deconvolution",
         [f(2, 4, 5, 6), f(4, 3, 3, 3), f(3)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (3, 2),
          "num_filter": 3, "no_bias": False}, "f32"),
        ("Deconvolution target_shape", "Deconvolution",
         [f(2, 4, 5, 6), f(4, 3, 3, 3)],
         {"kernel": (3, 3), "stride": (2, 1), "target_shape": (16, 11),
          "num_filter": 3}, "f32"),
        ("Deconvolution groups dilate", "Deconvolution",
         [f(1, 6, 5, 5), f(6, 2, 3, 3)],
         {"kernel": (3, 3), "dilate": (2, 3), "pad": (2, 1), "num_group": 3,
          "num_filter": 6}, "f32"),
        ("L2Normalization", "L2Normalization", [f(2, 3, 4, 5)],
         {"mode": "channel"}, "f32"),
        ("RMSNorm", "RMSNorm", [f(4, 16), pos(16)], {}, "f32"),
        ("softmin", "softmin", [f(4, 9)], {}, "f32"),
        ("SoftmaxActivation", "SoftmaxActivation", [f(2, 3, 4)],
         {"mode": "channel"}, "f32"),
        ("SoftmaxOutput", "SoftmaxOutput", [f(6, 5), np.array(
            [0, 4, 1, 2, 3, 1], np.float32)], {}, "f32"),
        ("smooth_l1", "smooth_l1", [f(5, 6)], {"scalar": 2.0}, "f32"),
        ("softmax_cross_entropy", "softmax_cross_entropy",
         [f(6, 5), np.array([0, 4, 1, 2, 3, 1], np.float32)], {}, "f32"),
        ("selfatt_qk", "_contrib_interleaved_matmul_selfatt_qk", [qkv],
         {"heads": 4}, "f32"),
        ("selfatt_valatt", "_contrib_interleaved_matmul_selfatt_valatt",
         [qkv, f(8, 6, 6)], {"heads": 4}, "f32"),
        ("arange_like", "_contrib_arange_like", [f(3, 4)],
         {"start": 2.0, "step": 0.5}, "exact"),
        ("div_sqrt_dim", "_contrib_div_sqrt_dim", [f(3, 16)], {}, "f32"),
        ("UpSampling", "UpSampling", [f(2, 3, 4, 5)], {"scale": 2},
         "exact"),
        ("BilinearSampler", "BilinearSampler",
         [f(2, 3, 5, 6), rs.uniform(-1.2, 1.2, (2, 2, 4, 3)).astype(
             np.float32)], {}, "f32"),
        ("shape_array", "shape_array", [f(3, 4, 5)], {}, "exact"),
        ("size_array", "size_array", [f(3, 4, 5)], {}, "exact"),
        ("make_loss", "make_loss", [f(3, 4)], {}, "exact"),
        ("amp_cast", "amp_cast", [f(3, 4)], {"dtype": "bfloat16"}, "exact"),
        ("amp_multicast", "amp_multicast",
         [f(3).astype(np.float16), f(3)], {"num_outputs": 2}, "exact"),
        ("gather_nd", "gather_nd", [f(4, 5, 3), np.array(
            [[0, 3, -1, 9], [4, 0, 1, -2]], np.float32)], {}, "exact"),
        ("scatter_nd", "scatter_nd", [f(4, 3), np.array(
            [[0, 2, -1, 7], [1, 0, 2, 2]], np.int32)], {"shape": (3, 3, 3)},
         "exact"),
        ("_scatter_set_nd", "_scatter_set_nd", [f(3, 4), f(2), np.array(
            [[0, 2], [3, 1]], np.int32)], {"shape": (3, 4)}, "exact"),
        ("boolean_mask_fill", "boolean_mask_fill",
         [f(4, 3), np.array([1, 0, 0, 1], np.float32)], {"value": -2.0},
         "exact"),
        ("one_hot", "one_hot", [np.array([0, 2, 7, -1], np.float32)],
         {"depth": 4}, "exact"),
        ("sort ties", "sort", [ties], {"is_ascend": False}, "exact"),
        ("argsort ties", "argsort", [ties], {"axis": 0, "is_ascend": False},
         "exact"),
        ("argsort ties asc", "argsort", [ties], {}, "exact"),
        ("topk ties", "topk", [ties], {"k": 3, "ret_typ": "both"}, "exact"),
        ("topk ties asc", "topk", [ties], {"k": 2, "is_ascend": True,
                                          "axis": 0}, "exact"),
        ("diag", "diag", [f(3, 4, 2)], {"k": 1}, "exact"),
        ("einsum", "_npi_einsum", [f(3, 4), f(4, 5)],
         {"subscripts": "ij,jk->ik"}, "f32"),
        ("khatri_rao", "khatri_rao", [f(3, 4), f(2, 4)], {}, "f32"),
        ("SequenceMask", "SequenceMask", [f(5, 3, 2), np.array(
            [2, 5, 1], np.float32)], {"use_sequence_length": True},
         "exact"),
        ("SequenceLast", "SequenceLast", [f(3, 5, 2), np.array(
            [2, 5, 1], np.float32)], {"use_sequence_length": True,
                                      "axis": 1}, "exact"),
        ("SequenceReverse", "SequenceReverse", [f(5, 3, 2), np.array(
            [2, 5, 1], np.float32)], {"use_sequence_length": True},
         "exact"),
        ("_linalg_gemm2", "_linalg_gemm2", [f(2, 3, 4), f(2, 5, 4)],
         {"transpose_b": True, "alpha": 0.5}, "linalg"),
        ("_linalg_gemm", "_linalg_gemm", [f(3, 4), f(4, 2), f(3, 2)],
         {"beta": 0.5}, "linalg"),
        ("_linalg_syrk", "_linalg_syrk", [f(3, 4)], {}, "linalg"),
        ("_linalg_potrf", "_linalg_potrf", [spd(5)], {}, "linalg"),
        ("_linalg_trsm", "_linalg_trsm", [low, f(5, 3)], {}, "linalg"),
        ("_linalg_trsm right", "_linalg_trsm", [low, f(3, 5)],
         {"rightside": True, "transpose": True}, "linalg"),
        ("_linalg_sumlogdiag", "_linalg_sumlogdiag", [spd(4, (2,))], {},
         "linalg"),
        ("_linalg_extractdiag", "_linalg_extractdiag", [f(2, 4, 4)],
         {"offset": 1}, "exact"),
        ("_linalg_makediag", "_linalg_makediag", [f(2, 4)], {}, "exact"),
        ("_linalg_svd", "_linalg_svd", [f(2, 5, 3)], {}, "recon"),
        ("_linalg_inverse", "_linalg_inverse", [spd(5)], {}, "linalg"),
        ("_linalg_det", "_linalg_det", [spd(3, (2,))], {}, "linalg"),
        ("_linalg_extracttrian", "_linalg_extracttrian", [f(2, 4, 4)],
         {"offset": 1}, "exact"),
        ("_linalg_maketrian", "_linalg_maketrian", [f(2, 10)], {},
         "exact"),
        ("_linalg_gelqf", "_linalg_gelqf", [f(3, 5)], {}, "recon"),
        ("_linalg_potri", "_linalg_potri", [low], {}, "linalg"),
        ("_linalg_slogdet", "_linalg_slogdet", [spd(3, (2,))], {},
         "linalg"),
        ("_linalg_syevd", "_linalg_syevd", [spd(5)], {}, "recon"),
        ("_linalg_trmm", "_linalg_trmm", [f(4, 4), f(4, 3)],
         {"alpha": 1.5}, "linalg"),
    ]
    pdf = [("_random_pdf_uniform", [pos(2, 3, lo=0.4, hi=0.6),
                                    pos(2, lo=0.0, hi=0.3),
                                    pos(2, lo=0.7, hi=1.0)]),
           ("_random_pdf_normal", [pos(2, 3), f(2), pos(2)]),
           ("_random_pdf_gamma", [pos(2, 3), pos(2), pos(2)]),
           ("_random_pdf_exponential", [pos(2, 3), pos(2)]),
           ("_random_pdf_poisson", [counts, pos(2)]),
           ("_random_pdf_negative_binomial", [counts, pos(2),
                                              pos(2, lo=0.2, hi=0.8)]),
           ("_random_pdf_generalized_negative_binomial",
            [counts, pos(2), pos(2)]),
           ("_random_pdf_dirichlet", [
               (lambda x: x / x.sum(-1, keepdims=True))(pos(2, 3, 4)),
               pos(2, 4)])]
    cases += [(name, name, ins, {"is_log": True}, "f32")
              for name, ins in pdf]
    return cases


def contrib_tail_cases():
    """Every op of ``ops/contrib.py``, ``ops/vision.py`` and
    ``ops/misc.py`` (the slice after the op tail), at small shapes, as
    ``op_tail_cases`` gives them; two more kinds: ``targets`` (the first
    output within 1e-5, the others bitwise: MultiBoxTarget's regression
    targets take a log, its masks and classes are the matching) and
    ``dets`` (classes, scores and kept rows bitwise, boxes within
    1e-5)."""
    rs = np.random.RandomState(1)

    def f(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    def boxes(n, scale=1.0):
        xy = rs.uniform(0, 0.7 * scale, (n, 2))
        wh = rs.uniform(0.02 * scale, 0.3 * scale, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    def dets(b, n):
        cid = rs.randint(0, 3, (b, n, 1)).astype(np.float32)
        score = rs.uniform(0, 1, (b, n, 1)).astype(np.float32)
        return np.concatenate([cid, score, np.stack(
            [boxes(n) for _ in range(b)])], 2)

    def rois(n, batch, size):
        b = rs.randint(0, batch, (n, 1))
        xy = rs.uniform(0, size * 0.6, (n, 2))
        wh = rs.uniform(1, size * 0.4, (n, 2))
        return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)

    tied = dets(2, 300)
    tied[:, :, 1] = np.round(tied[:, :, 1] * 4) / 4
    tied[0, 10:20] = tied[0, 9]
    anchors = np.concatenate([boxes(6 * 6 * 5)])[None]
    labels = np.full((3, 4, 5), -1, np.float32)
    for i, n in enumerate((2, 4, 1)):
        for j in range(n):
            xy = rs.uniform(0, 0.6, 2)
            labels[i, j] = [rs.randint(0, 3), *xy,
                            *(xy + rs.uniform(0.1, 0.4, 2))]
    pred = f(3, 4, anchors.shape[1])
    pred[:, 1:, ::7] = 0.75
    logits = f(2, 4, anchors.shape[1])
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    kv = f(7, 2, 2 * 2 * 4)
    lda, st = rs.uniform(0.5, 1.5, (3, 2)), rs.uniform(0, 1, (3, 2))
    lags = rs.uniform(0.1, 1.0, (3, 6))
    hawkes = [a.astype(np.float32) for a in (
        lda, rs.uniform(0.1, 0.5, 2), rs.uniform(0.5, 2.0, 2), st, lags,
        rs.randint(0, 2, (3, 6)), np.array([6, 3, 0]), lags.sum(1) + 1)]
    img = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    return [
        ("box_iou", "_contrib_box_iou", [boxes(40), boxes(30)], {}, "f32"),
        ("box_nms", "_contrib_box_nms", [dets(2, 500)],
         {"overlap_thresh": 0.4}, "exact"),
        ("box_nms ties", "_contrib_box_nms", [tied],
         {"overlap_thresh": 0.3, "valid_thresh": 0.2}, "exact"),
        ("box_nms center", "_contrib_box_nms", [dets(1, 200)],
         {"in_format": "center"}, "exact"),
        ("fft", "_contrib_fft", [f(3, 64)], {}, "f32"),
        ("ifft", "_contrib_ifft", [f(3, 64)], {}, "f32"),
        ("index_copy", "_contrib_index_copy",
         [f(6, 3), np.array([4, 0, -1], np.float32), f(3, 3)], {}, "exact"),
        ("index_array", "_contrib_index_array", [f(2, 3, 4)],
         {"axes": (0, 2)}, "exact"),
        ("getnnz", "_contrib_getnnz", [np.where(f(5, 6) > 0.3, 1.0, 0.0)
                                       .astype(np.float32)], {"axis": 1},
         "exact"),
        ("gradientmultiplier", "_contrib_gradientmultiplier", [f(3, 4)],
         {"scalar": 2.0}, "exact"),
        ("quantize", "_contrib_quantize",
         [f(4, 5) * 3, np.array([-3.0], np.float32),
          np.array([2.5], np.float32)], {"out_type": "int8"}, "exact"),
        ("dequantize", "_contrib_dequantize",
         [rs.randint(0, 256, (4, 5)).astype(np.uint8),
          np.array([-3.0], np.float32), np.array([2.5], np.float32)], {},
         "f32"),
        ("count_sketch", "_contrib_count_sketch",
         [f(3, 10), rs.randint(0, 6, (1, 10)).astype(np.float32),
          np.sign(f(1, 10))], {"out_dim": 6}, "f32"),
        ("encdec_qk", "_contrib_interleaved_matmul_encdec_qk",
         [f(5, 2, 8), kv], {"heads": 2}, "f32"),
        ("encdec_valatt", "_contrib_interleaved_matmul_encdec_valatt",
         [kv, f(4, 5, 7)], {"heads": 2}, "f32"),
        ("hawkesll", "_contrib_hawkesll", hawkes, {}, "f32"),
        ("boolean_mask", "_contrib_boolean_mask",
         [f(6, 3), np.array([1, 0, 1, 1, 0, 0.5], np.float32)], {}, "exact"),
        ("ROIPooling", "ROIPooling", [f(2, 3, 12, 10), rois(5, 2, 10)],
         {"pooled_size": (3, 2), "spatial_scale": 0.8}, "exact"),
        ("ROIAlign", "_contrib_ROIAlign", [f(2, 8, 9, 11), rois(4, 2, 9)],
         {"pooled_size": (2, 2), "sample_ratio": 3}, "f32"),
        ("PSROIPooling", "_contrib_PSROIPooling",
         [f(2, 18, 10, 10), rois(4, 2, 9)],
         {"output_dim": 2, "pooled_size": 3}, "f32"),
        ("DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
         [f(2, 8, 9, 9), rois(3, 2, 8)],
         {"output_dim": 2, "group_size": 2, "pooled_size": 2,
          "no_trans": True}, "f32"),
        ("RROIAlign", "_contrib_RROIAlign",
         [f(2, 3, 10, 10), np.concatenate(
             [rs.randint(0, 2, (4, 1)), rs.uniform(3, 7, (4, 2)),
              rs.uniform(2, 5, (4, 2)), rs.uniform(-90, 90, (4, 1))],
             1).astype(np.float32)], {"pooled_size": (2, 3)}, "f32"),
        ("DeformableConvolution", "_contrib_DeformableConvolution",
         [f(2, 4, 7, 7), f(2, 36, 5, 5) * 0.7, f(6, 2, 3, 3), f(6)],
         {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
          "num_deformable_group": 2}, "f32"),
        ("MultiBoxPrior", "_contrib_MultiBoxPrior",
         [np.zeros((1, 3, 38, 38), np.float32)],
         {"sizes": SSD_SIZES, "ratios": SSD_RATIOS, "clip": True}, "exact"),
        ("MultiBoxTarget", "_contrib_MultiBoxTarget",
         [anchors, labels, pred], {"negative_mining_ratio": 3.0},
         "targets"),
        ("MultiBoxDetection", "_contrib_MultiBoxDetection",
         [prob, (f(2, anchors.shape[1] * 4) * 0.2).astype(np.float32),
          anchors], {"nms_threshold": 0.45, "threshold": 0.2}, "dets"),
        ("box_encode", "_contrib_box_encode",
         [rs.uniform(0, 1, (2, 6)).astype(np.float32),
          rs.randint(-1, 3, (2, 6)).astype(np.float32),
          np.stack([boxes(6), boxes(6)]), np.stack([boxes(3), boxes(3)])],
         {}, "f32"),
        ("box_decode", "_contrib_box_decode",
         [f(2, 6, 4) * 0.3, boxes(6)], {"clip": 0.25}, "f32"),
        ("bipartite_matching", "_contrib_bipartite_matching",
         [rs.uniform(0, 1, (2, 5, 4)).astype(np.float32)],
         {"threshold": 0.1}, "exact"),
        ("Proposal", "_contrib_Proposal",
         [rs.uniform(0, 1, (2, 12, 4, 5)).astype(np.float32),
          f(2, 24, 4, 5) * 0.2,
          np.array([[64, 80, 1.0], [60, 70, 0.8]], np.float32)],
         {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 12,
          "threshold": 0.6, "rpn_min_size": 4, "scales": (2, 4)}, "f32"),
        ("mrcnn_mask_target", "_contrib_mrcnn_mask_target",
         [np.stack([boxes(4, 12), boxes(4, 12)]),
          (rs.uniform(0, 1, (2, 3, 12, 12)) > 0.5).astype(np.float32),
          rs.randint(0, 3, (2, 4)).astype(np.float32),
          rs.randint(0, 3, (2, 4)).astype(np.float32)],
         {"num_classes": 3, "mask_size": (5, 4)}, "f32"),
        ("SyncBatchNorm", "_contrib_SyncBatchNorm",
         [f(4, 3, 5, 5), rs.uniform(0.5, 1.5, 3).astype(np.float32), f(3),
          f(3) * 0.1, rs.uniform(0.5, 2, 3).astype(np.float32)],
         {"_mode": "train", "fix_gamma": False}, "f32"),
        ("SparseEmbedding", "_contrib_SparseEmbedding",
         [np.array([[0, 3], [2, 1]], np.float32), f(4, 5)], {}, "exact"),
        ("add_n", "add_n", [f(3, 4), f(3, 4), f(3, 4)], {}, "exact"),
        ("hard_sigmoid", "hard_sigmoid", [f(4, 5)], {}, "f32"),
        ("moments", "moments", [f(3, 4, 5)], {"axes": (0, 2)}, "f32"),
        ("_square_sum", "_square_sum", [f(3, 4)], {"axis": 1}, "f32"),
        ("_hypot_scalar", "_hypot_scalar", [f(3, 4)], {"scalar": 1.5},
         "f32"),
        ("batch_take", "batch_take",
         [f(4, 5), np.array([0, 4, 2, 1], np.float32)], {}, "exact"),
        ("_unravel_index", "_unravel_index",
         [np.array([[0, 7, 23], [11, 5, 19]], np.float32)],
         {"shape": (2, 3, 4)}, "exact"),
        ("_ravel_multi_index", "_ravel_multi_index",
         [np.array([[0, 1, 2], [2, 0, 1], [3, 3, 0]], np.float32)],
         {"shape": (2, 3, 4)}, "exact"),
        ("_histogram", "_histogram", [f(500)], {"bin_cnt": 9,
                                               "range": (-2.0, 2.0)}, "f32"),
        ("_sparse_retain", "_sparse_retain",
         [f(6, 3), np.array([4, 0, -1], np.float32)], {}, "exact"),
        ("_slice_assign", "_slice_assign", [f(6, 4), f(3, 2)],
         {"begin": (5, None), "end": (0, None), "step": (-2, 2)}, "exact"),
        ("_slice_assign_scalar", "_slice_assign_scalar", [f(6, 4)],
         {"scalar": 7.0, "begin": (1, 0), "end": (4, 3)}, "exact"),
        ("LinearRegressionOutput", "LinearRegressionOutput",
         [f(4, 3), f(4, 3)], {}, "exact"),
        ("LogisticRegressionOutput", "LogisticRegressionOutput",
         [f(4, 3), f(4, 3)], {}, "f32"),
        ("SVMOutput", "SVMOutput",
         [f(5, 4), np.array([0, 3, 1, 1, 2], np.float32)], {}, "exact"),
        ("MakeLoss", "MakeLoss", [f(4, 3)], {"normalization": "valid"},
         "exact"),
        ("round_ste", "_contrib_round_ste", [f(3, 5) * 3], {}, "exact"),
        ("quadratic", "_contrib_quadratic", [f(3, 5)],
         {"a": 0.5, "b": -1.0, "c": 2.0}, "f32"),
        ("allclose", "_contrib_allclose", [f(3, 5), f(3, 5)],
         {"atol": 5.0}, "exact"),
        ("im2col", "im2col", [f(2, 3, 6, 7)],
         {"kernel": (2, 3), "stride": (2, 1), "dilate": (1, 2),
          "pad": (0, 1)}, "exact"),
        ("col2im", "col2im", [f(2, 27, 42)],
         {"output_size": (6, 7), "kernel": (3, 3), "pad": (1, 1)}, "f32"),
        ("LRN", "LRN", [f(2, 7, 4, 5)], {"nsize": 3}, "f32"),
        ("Crop", "Crop", [f(2, 3, 6, 7)], {"h_w": (3, 3),
                                           "center_crop": True}, "exact"),
        # x / 255: the card multiplies by the reciprocal, an ulp apart
        ("_image_to_tensor", "_image_to_tensor", [img], {}, "f32"),
        ("_image_normalize", "_image_normalize",
         [rs.uniform(0, 1, (3, 6, 5)).astype(np.float32)],
         {"mean": (0.4, 0.5, 0.6), "std": (0.2, 0.25, 0.3)}, "f32"),
        ("_image_crop", "_image_crop", [img],
         {"x": 1, "y": 2, "width": 3, "height": 2}, "exact"),
        ("_image_adjust_lighting", "_image_adjust_lighting", [img],
         {"alpha": (2.0, -1.0, 3.0)}, "exact"),
        ("_image_resize", "_image_resize",
         [rs.uniform(0, 255, (6, 5, 3)).astype(np.float32)],
         {"size": (8, 9)}, "f32"),
        ("GridGenerator", "GridGenerator", [f(2, 6) * 0.5],
         {"target_shape": (4, 6)}, "f32"),
        ("SpatialTransformer", "SpatialTransformer",
         [f(2, 3, 6, 7), (np.array([[1, 0, 0, 0, 1, 0]] * 2) + f(2, 6) * 0.2)
          .astype(np.float32)], {"target_shape": (5, 4)}, "f32"),
        ("BilinearResize2D", "_contrib_BilinearResize2D", [f(2, 3, 6, 7)],
         {"height": 9, "width": 5}, "f32"),
        ("AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
         [f(2, 3, 7, 9)], {"output_size": (3, 2)}, "f32"),
        ("Correlation", "Correlation", [f(2, 3, 8, 9), f(2, 3, 8, 9)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 2}, "f32"),
    ]


def attention_op_checks(mx, dev):
    """``nd.contrib.flash_attention`` and ``nd.contrib.paged_attention``
    on CUDA arrays launch K1 (K2 and K3 in the backward under
    ``record()``) and K4, held against their plain versions on the same
    arrays: K1's output and the gradients within 1e-5 of the largest
    (f32), K4's output within 1e-5."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa

    ctx = mx.gpu(0)
    rng = np.random.default_rng(3)
    q, k, v = (mx.nd.array(rng.standard_normal((2, 4, 100, 64)).astype(
        np.float32), ctx=ctx) for _ in range(3))
    for a in (q, k, v):
        a.attach_grad()
    before = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    with mx.autograd.record():
        out = mx.nd.contrib.flash_attention(q, k, v, causal=True)
    out.backward(mx.nd.ones_like(out))
    after = (fa.flash_attention.fwd_launches, fa.flash_attention.dq_launches,
             fa.flash_attention.dkv_launches)
    qt, kt, vt = (a.data().detach().cpu().requires_grad_() for a in (q, k, v))
    want = fa.flash_attention(qt, kt, vt, causal=True)
    want.backward(torch.ones_like(want))
    errs = [((g.data() if hasattr(g, "data") else g).detach().cpu().double()
             - w.detach().double()).abs().max().item()
            / max(w.detach().abs().max().item(), 1e-30)
            for g, w in ((out, want), (q.grad, qt.grad), (k.grad, kt.grad),
                         (v.grad, vt.grad))]
    launched = all(a > b for a, b in zip(after, before))
    ok = launched and max(errs) <= 1e-5
    log("ops: nd.contrib.flash_attention on the card: K1, K2, K3 launched "
        "%s; out and dq, dk, dv against the plain version %s %s"
        % (tuple(a - b for a, b in zip(after, before)),
           ["%.3g" % e for e in errs], "ok" if ok else "FAIL"))
    b, h, kvh, d, s_page, pages = 3, 8, 2, 64, 16, 12
    qp = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((pages, s_page, kvh, d)).astype(np.float32)
              for _ in range(2))
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.float32)
    pos = np.array([40, 20, 3], np.float32)
    args = [mx.nd.array(a, ctx=ctx) for a in (qp, kp, vp, table, pos)]
    n0 = pa.paged_attention.launches
    got = mx.nd.contrib.paged_attention(*args).data()
    n1 = pa.paged_attention.launches
    want = pa._paged_ref(*(torch.from_numpy(a) for a in (qp, kp, vp)),
                         torch.from_numpy(table).int(),
                         torch.from_numpy(pos).int(), scale=d ** -0.5)
    err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    good = n1 == n0 + 1 and err <= 1e-5
    log("ops: nd.contrib.paged_attention on the card: K4 launched %d, "
        "against the plain version %.3g %s" % (n1 - n0, err,
                                                "ok" if good else "FAIL"))
    return ok and good


def recorded_control_checks(mx, dev):
    """A ``CustomOp`` and a ``while_loop`` under ``record()`` with a
    backward, on the card against the same code on the host: outputs
    and input gradients within 1e-5 of the largest."""
    import torch

    if "smoke_sigmoid" not in mx.operator._CUSTOM_REGISTRY:
        class Sigmoid(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0],
                            1.0 / (1.0 + mx.nd.exp(-in_data[0])))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                y = out_data[0]
                self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

        @mx.operator.register("smoke_sigmoid")
        class SigmoidProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, in_shapes, in_dtypes):
                return Sigmoid()

    def run(ctx):
        rs = np.random.RandomState(4)
        x = mx.nd.array(rs.standard_normal((64, 33)).astype(np.float32),
                        ctx=ctx)
        s = mx.nd.array(rs.standard_normal((33,)).astype(np.float32),
                        ctx=ctx)
        for a in (x, s):
            a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="smoke_sigmoid")
            outs, final = mx.nd.contrib.while_loop(
                lambda i, h: i < 5,
                lambda i, h: (mx.nd.tanh(h * s), [i + 1, h * 0.5 + y[0]]),
                [mx.nd.zeros((1,), ctx=ctx), y[1]], max_iterations=9)
            loss = (outs * outs).sum() + final[1].sum() + y.sum()
        loss.backward()
        return [t.asnumpy() for t in (y, outs, final[1], x.grad, s.grad)]

    with exact_convs():
        card, host = run(mx.gpu(0)), run(mx.cpu())
    errs = [float(np.abs(c - h).max() / max(np.abs(h).max(), 1e-30))
            for c, h in zip(card, host)]
    ok = card[1].shape == (5, 33) and max(errs) <= 1e-5
    log("ops: a CustomOp and a while_loop under record() with a backward: "
        "%d loop rows; outputs and gradients against the host %s %s"
        % (card[1].shape[0], ["%.3g" % e for e in errs],
           "ok" if ok else "FAIL"))
    return ok


def capture_refusal_checks(mx, dev):
    """Under a CUDA graph capture, ``boolean_mask``, a recorded
    ``while_loop`` and ``cond`` (which read the device on the host) raise
    ``MXNetError`` rather than break the capture or replay a stale
    answer; the card stays usable after each."""
    import torch

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.base import MXNetError

    def block(fn, with_param):
        class B(gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                if with_param:
                    with self.name_scope():
                        self.w = self.params.get("w", shape=(4,))

            def hybrid_forward(self, F, x, **params):
                return fn(F, x, *params.values())

        net = B()
        net.initialize(device=dev)
        net.hybridize()
        return net

    cases = [
        ("boolean_mask", False, lambda F, x: F.contrib.boolean_mask(
            x, x[:, 0] > 0)),
        ("cond", False, lambda F, x: F.contrib.cond(
            x.sum() > 0, lambda: x * 2, lambda: x * 3)),
        ("while_loop in record()", True, lambda F, x, w: F.contrib.while_loop(
            lambda i: (i < 3), lambda i: (i * w.sum(), [i + 1]),
            [x[0, :1] * 0], max_iterations=4)[0]),
    ]
    ok = True
    x = torch.ones(4, 4, device=dev)
    for label, with_param, fn in cases:
        net = block(fn, with_param)
        raised = None
        for _ in range(3):
            try:
                if with_param:
                    with mx.autograd.record():
                        out = net(mx.nd.NDArray(x, ctx=mx.gpu(0)))
                    out.backward()
                else:
                    with torch.no_grad():
                        net(x)
            except MXNetError as e:
                raised = e
                break
        torch.cuda.synchronize()
        usable = bool((torch.randint(0, 5, (8,), device=dev) < 5).all())
        good = raised is not None and usable
        ok &= good
        log("ops: %s inside a captured call: %s; the card usable after %s %s"
            % (label, ("MXNetError: %s" % str(raised).splitlines()[0][:90])
               if raised is not None else "NOTHING RAISED", usable,
               "ok" if good else "FAIL"))
    return ok


def _recon(name, outs):
    """The product a sign-free factorization must give back."""
    if name == "_linalg_svd":
        u, s, vt = outs
        return [u @ (s.unsqueeze(-1) * vt), s]
    if name == "_linalg_syevd":
        u, lam = outs
        return [u.transpose(-1, -2) @ (lam.unsqueeze(-1) * u), lam]
    lq, q = outs
    return [lq @ q, q @ q.transpose(-1, -2)]


def op_tail_checks(dev):
    """Each case of ``op_tail_cases`` and ``contrib_tail_cases`` on the
    card against the port on the host (TF32 off): ``[(label, kind, error,
    bound, ok)]``; an ``exact`` case's error is its count of differing
    elements."""
    import torch

    from mxnet_tpu_torch.ops import registry

    rows = []
    with exact_convs():
        for label, op, inputs, attrs, kind in (op_tail_cases()
                                               + contrib_tail_cases()):
            fwd = registry.get(op).forward
            outs = {}
            for where in ("cpu", dev):
                ts = [torch.from_numpy(x).to(where) for x in inputs]
                out = fwd(*ts, **attrs)
                out = list(out) if isinstance(out, (tuple, list)) else [out]
                if kind == "recon":
                    out = _recon(op, out)
                outs[str(where)] = [o.detach().cpu() for o in out]
            host, card = outs["cpu"], outs[str(dev)]
            rule = kind
            if kind in ("targets", "dets"):
                # the matching bitwise (the targets' masks and classes,
                # the detections' classes and scores), the rest as f32
                if kind == "targets":
                    pairs = list(zip(host[1:], card[1:]))
                    host, card = host[:1], card[:1]
                else:
                    pairs = [(host[0][..., :2], card[0][..., :2])]
                if not all(torch.equal(h, c) for h, c in pairs):
                    rows.append((label, kind, math.inf, 1e-5, False))
                    continue
                rule = "f32"
            if rule == "exact":
                err = sum(int((~((h == c) | (h.isnan() & c.isnan()))).sum())
                          if h.is_floating_point() else int((h != c).sum())
                          for h, c in zip(host, card))
                err += sum(h.dtype != c.dtype or h.shape != c.shape
                           for h, c in zip(host, card))
                bound = 0
            else:
                bound = 1e-5 if rule == "f32" else 1e-4
                err = max(((c.double() - h.double()).abs().max()
                           / h.double().abs().max().clamp_min(1e-30)).item()
                          for h, c in zip(host, card))
                err = err if all(h.shape == c.shape and h.dtype == c.dtype
                                 for h, c in zip(host, card)) else math.inf
            rows.append((label, kind, err, bound, err <= bound))
    return rows


def seeded_draws_repeat(mx, dev):
    """After ``mx.random.seed(s)`` the same op sequence on the card gives
    bitwise-equal draws twice, and another seed other draws."""
    import torch

    ctx = mx.context.as_context(dev)

    def run(s):
        mx.random.seed(s)
        return [mx.nd.random.normal(0, 1, shape=(1000,), ctx=ctx).data(),
                mx.nd.random.uniform(-1, 1, shape=(77,), ctx=ctx).data(),
                mx.nd.random.gamma(0.7, 2.0, shape=(500,), ctx=ctx).data(),
                mx.nd.random.poisson(3.0, shape=(300,), ctx=ctx).data(),
                mx.nd.random.randint(0, 9, shape=(64,), ctx=ctx).data(),
                mx.nd.random.multinomial(mx.nd.array(
                    [MULTINOMIAL_P] * 3, ctx=ctx), shape=(40,)).data(),
                mx.nd.random.shuffle(mx.nd.arange(50, ctx=ctx)).data()]
    a, b, c = run(5), run(5), run(6)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    differ = not torch.equal(a[0], c[0])
    return same, differ


def dropout_graph_masks(mx, dev):
    """A hybridized block with ``Dropout`` in train mode: 4 calls (eager,
    capture, replays) after ``mx.random.seed(9)``, twice.  Returns
    whether successive masks differ, whether the two sequences are
    bitwise equal, and the block's stats."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dropout(0.5))
    net.hybridize()
    x = torch.ones(256, 64, device=dev)
    seqs = []
    for _ in range(2):
        mx.random.seed(9)
        with autograd.train_mode():
            seqs.append([net(x).clone() for _ in range(4)])
    a, b = seqs
    differ = all(not torch.equal(a[i], a[i + 1]) for i in range(3))
    same = all(torch.equal(p, q) for p, q in zip(a, b))
    return differ, same, net.stats()


def scalar_division_checks(mx, dev):
    """F13: ``_div_scalar`` and ``_rdiv_scalar`` on the card, and NDArray
    ``/`` with a Python number both ways, against the host's true f32
    division (numpy) of the same values, bitwise.  Returns whether all
    held."""
    import torch

    from mxnet_tpu_torch.ops import registry as reg

    x = np.linspace(0.1, 10, 2000, dtype=np.float32)
    xt = torch.from_numpy(x).to(dev)
    arr = mx.nd.array(x, ctx=mx.gpu(0))
    ok = True
    for scalar in (255.0, 3.0, 0.1):
        c = np.float32(scalar)
        runs = (("_div_scalar", reg.get("_div_scalar").forward(
                    xt, scalar=scalar), x / c),
                ("_rdiv_scalar", reg.get("_rdiv_scalar").forward(
                    xt, scalar=scalar), c / x),
                ("NDArray / scalar", (arr / scalar).asnumpy(), x / c),
                ("scalar / NDArray", (scalar / arr).asnumpy(), c / x))
        for label, got, want in runs:
            got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
            bad = int((got != want).sum())
            ok &= bad == 0
            log("ops: F13 %-17s at %-5g on the card against the host's "
                "true division: %d of %d differ %s"
                % (label, scalar, bad, x.size, "ok" if not bad else "FAIL"))
    return ok


def ops_phase(mx, dev):
    """Every op of the op tail and of the contrib, vision and misc ops on
    the card against the host, every sampler's 2^22 draws against its
    distribution, seeded draws repeated, a hybridized Dropout's masks
    through its replays, the attention ops through ``nd.contrib``, a
    ``CustomOp`` and a ``while_loop`` recorded, the scalar divisions
    (F13), and the host reads refused under a capture."""
    ok = scalar_division_checks(mx, dev)
    for label, kind, err, bound, good in op_tail_checks(dev):
        ok &= good
        log("ops: %-28s %-6s %s %s" % (
            label, kind, ("%d elements differ" % err) if kind == "exact"
            else "%.3g of the largest (bound %.0e)" % (err, bound),
            "ok" if good else "FAIL"))
    t0 = time.perf_counter()
    n = 1 << 22
    for label, r in draw_readings(dev, n, 17).items():
        if label == "shuffle":
            good = r["permutes"] and r["moved"] > 0.99
            log("ops: draws shuffle: %d rows permuted %s, %.4f moved %s"
                % (n, r["permutes"], r["moved"], "ok" if good else "FAIL"))
        else:
            good = draw_ok(r)
            log("ops: draws %-18s n %d: mean %.6g (want %.6g, %+.2f se), var "
                "%.6g (want %.6g, %+.2f se)%s %s"
                % (label, r["n"], r["mean"], r["want_mean"], r["mean_z"],
                   r["var"], r["want_var"], r["var_z"],
                   "" if r["ks"] is None else ", KS %.3g (critical %.3g at "
                   "alpha %.0e)" % (r["ks"], r["ks_crit"], KS_ALPHA),
                   "ok" if good else "FAIL"))
        ok &= good
    log("ops: the draws and their readings took %.1f s"
        % (time.perf_counter() - t0))
    same, differ = seeded_draws_repeat(mx, dev)
    log("ops: seeded draws: two runs after mx.random.seed(5) %s; seed 6 "
        "draws %s" % ("bitwise equal" if same else "DIFFER",
                      "others" if differ else "THE SAME"))
    ok &= same and differ
    differ, same, st = dropout_graph_masks(mx, dev)
    good = differ and same and st["replays"] >= 4
    log("ops: hybridized Dropout: successive masks %s, the sequence after "
        "reseeding %s; %d captures, %d replays %s"
        % ("differ" if differ else "REPEAT",
           "bitwise equal" if same else "DIFFERS", st["captures"],
           st["replays"], "ok" if good else "FAIL"))
    ok &= good
    ok &= attention_op_checks(mx, dev)
    ok &= recorded_control_checks(mx, dev)
    ok &= capture_refusal_checks(mx, dev)
    if not ok:
        fail("an op of the op tail, a sampler or a draw check missed")


def scipy_dist(name, args):
    import scipy.stats

    if name == "categorical":
        p = np.asarray(args["p"], np.float64)
        return scipy.stats.rv_discrete(values=(np.arange(len(p)), p))
    return getattr(scipy.stats, name)(**args)


def draw_reading(values, dist, continuous):
    """The draws' mean and variance, each as standard errors from the
    distribution's (the variance's from its fourth moment), and for a
    continuous distribution the KS statistic beside its critical value
    at ``KS_ALPHA``."""
    import scipy.special
    import scipy.stats

    v = np.asarray(values, np.float64).ravel()
    n = v.size
    m, var, kurt = (float(x) for x in dist.stats(moments="mvk"))
    mu4 = (kurt + 3.0) * var * var
    r = dict(n=n, mean=float(v.mean()), want_mean=m,
             mean_z=float((v.mean() - m) / math.sqrt(var / n)),
             var=float(v.var()), want_var=var,
             var_z=float((v.var() - var) / math.sqrt((mu4 - var * var) / n)),
             ks=None, ks_crit=None)
    if continuous:
        r["ks"] = float(scipy.stats.kstest(v, dist.cdf).statistic)
        r["ks_crit"] = float(scipy.special.kolmogi(KS_ALPHA) / math.sqrt(n))
    return r


def draw_ok(r, z=5.0):
    return abs(r["mean_z"]) <= z and abs(r["var_z"]) <= z and (
        r["ks"] is None or r["ks"] < r["ks_crit"])


def draw_readings(device, n, seed):
    """Every sampler's draws on ``device`` (``n`` values each; the
    ``_sample_*`` ops ``n`` a parameter row, the multinomial ``n``
    indices) with ``mx.random.seed(seed)`` first: ``{label: reading}``.
    The shuffle's reading is whether it permuted its rows."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    mx.random.seed(seed)
    out = {}
    for label, op, attrs, name, args, cont in SAMPLERS:
        (v,), _, _ = registry.invoke_raw(op, (), dict(attrs, shape=(n,),
                                                      ctx=device))
        out[label] = draw_reading(v.cpu().numpy(), scipy_dist(name, args),
                                  cont)
    for label, op, params, name, args_of, cont in SAMPLE_ROWS:
        a, b = (torch.tensor(x, dtype=torch.float32, device=device)
                for x in params)
        (v,), _, _ = registry.invoke_raw(op, (a, b), dict(shape=(n,)))
        v = v.cpu().numpy()
        for i, (pa, pb) in enumerate(zip(*params)):
            out["%s[%d]" % (label, i)] = draw_reading(
                v[i], scipy_dist(name, args_of(pa, pb)), cont)
    probs = torch.tensor(MULTINOMIAL_P, device=device)
    (v,), _, _ = registry.invoke_raw("_sample_multinomial", (probs,),
                                     dict(shape=(n,)))
    out["multinomial"] = draw_reading(
        v.cpu().numpy(), scipy_dist("categorical", dict(p=MULTINOMIAL_P)),
        False)
    rows = torch.arange(n, dtype=torch.float32, device=device)
    (v,), _, _ = registry.invoke_raw("_shuffle", (rows.reshape(-1, 1),))
    v = v.reshape(-1)
    out["shuffle"] = dict(
        n=n, permutes=bool(torch.equal(torch.sort(v).values, rows)),
        moved=float((v != rows).float().mean()))
    return out


# -- phase 19: ssd, the detection example trained and decoded on the card -------

# examples/detection/train_ssd.py's anchors: 5 a cell
SSD_SIZES = (0.3, 0.55, 0.8)
SSD_RATIOS = (1.0, 2.0, 0.5)
SSD_ANCHORS = len(SSD_SIZES) + len(SSD_RATIOS) - 1
SSD = dict(classes=20, image=300, batch=32, objects=8, lr=2e-3)


def ssd_blocks():
    """The JAX package's detection example's two blocks
    (``examples/detection/train_ssd.py:105-198``) written for the port as
    the example writes them: ``hybrid_forward(self, F, ...)`` with
    ``F.contrib.*`` ops.  Returns ``(SSDNet, SSDTrainLoss)``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import layout as layout_mod
    from mxnet_tpu_torch.gluon import nn

    class SSDNet(gluon.HybridBlock):
        """One-scale SSD head on a truncated model-zoo backbone, built
        under the policy layout (channels-last on the card); the input
        contract stays NCHW."""

        def __init__(self, num_classes, num_anchors, backbone="resnet18_v1",
                     cut=6, device=None, **kwargs):
            super().__init__(**kwargs)
            self._layout = layout_mod.preferred_layout(2, device)
            self._channel_last = not self._layout.startswith("NC")
            zoo = gluon.model_zoo.vision.get_model(
                backbone, pretrained=False, device=device)
            with layout_mod.layout_scope(self._layout), self.name_scope():
                self.features = nn.HybridSequential()
                for layer in list(zoo.features)[:cut]:
                    self.features.add(layer)
                self.cls_pred = nn.Conv2D(num_anchors * (num_classes + 1),
                                          kernel_size=3, padding=1,
                                          device=device)
                self.loc_pred = nn.Conv2D(num_anchors * 4, kernel_size=3,
                                          padding=1, device=device)
            self.num_classes = num_classes
            self.num_anchors = num_anchors

        def hybrid_forward(self, F, x):
            if self._channel_last:
                x = F.transpose(x, axes=(0, 2, 3, 1))
            feat = self.features(x)
            cls = self.cls_pred(feat)
            loc = self.loc_pred(feat)
            if not self._channel_last:
                feat = F.transpose(feat, axes=(0, 2, 3, 1))
                cls = F.transpose(cls, axes=(0, 2, 3, 1))
                loc = F.transpose(loc, axes=(0, 2, 3, 1))
            b = x.shape[0]
            cls = F.transpose(F.reshape(cls, shape=(b, -1,
                                                    self.num_classes + 1)),
                              axes=(0, 2, 1))
            loc = F.reshape(loc, shape=(b, -1))
            feat_sh = F.transpose(feat, axes=(0, 3, 1, 2))
            return feat_sh, cls, loc

    class SSDTrainLoss(gluon.HybridBlock):
        """Forward, target assignment and the masked objectives as one
        block: ``JitTrainStep(SSDTrainLoss(net), None, ...)`` captures
        the whole step."""

        def __init__(self, ssd, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.ssd = ssd

        def hybrid_forward(self, F, x, label):
            feat_sh, cls_preds, loc_preds = self.ssd(x)
            anchors = F.contrib.MultiBoxPrior(
                feat_sh, sizes=SSD_SIZES, ratios=SSD_RATIOS, clip=True)
            loc_t, loc_m, cls_t = F.contrib.MultiBoxTarget(
                F.BlockGrad(anchors), label, F.BlockGrad(cls_preds),
                negative_mining_ratio=3.0)
            nc = self.ssd.num_classes
            cp = F.reshape(F.transpose(cls_preds, axes=(0, 2, 1)),
                           shape=(-1, nc + 1))
            ct = F.reshape(cls_t, shape=(-1,))
            valid = F.BlockGrad((ct >= 0).astype("float32"))
            tgt = F.BlockGrad(F.relu(ct))
            logp = F.log_softmax(cp, axis=-1)
            lc = -F.pick(logp, tgt, axis=-1) * valid
            ls = F.smooth_l1(loc_preds * loc_m - loc_t * loc_m, scalar=1.0)
            denom = F.broadcast_maximum(F.reshape(F.sum(valid), shape=(1,)),
                                        F.ones(shape=(1,)))
            return F.sum(lc) / denom + F.mean(F.sum(ls, axis=-1)) / 100.0

    return SSDNet, SSDTrainLoss


def ssd_batch(dev, batch, image, objects, classes, seed):
    """Seeded images (B, 3, H, W) and labels (B, objects, 5) padded with
    -1, made on ``dev``: 1 to ``objects`` boxes an image, each a bright
    rectangle of its class's colour on noise, as the example draws
    them."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    img = u(batch, 3, image, image) * 0.25
    n_obj = (u(batch) * objects).floor().long() + 1          # 1..objects
    cls = (u(batch, objects) * classes).floor()
    x0y0 = u(batch, objects, 2) * 0.6
    wh = 0.1 + u(batch, objects, 2) * 0.3
    boxes = torch.cat([x0y0, (x0y0 + wh).clamp(max=1.0)], dim=2)
    live = torch.arange(objects, device=dev)[None, :] < n_obj[:, None]
    label = torch.where(live[..., None], torch.cat([cls[..., None], boxes], 2),
                        torch.full((batch, objects, 5), -1.0, device=dev))
    pix = (torch.arange(image, device=dev).float() + 0.5) / image
    colour = (cls[..., None] + 1) / (classes + 1)            # (B, O, 1)
    for o in range(objects):
        inside = ((pix[None, :, None] >= boxes[:, o, 1, None, None])
                  & (pix[None, :, None] < boxes[:, o, 3, None, None])
                  & (pix[None, None, :] >= boxes[:, o, 0, None, None])
                  & (pix[None, None, :] < boxes[:, o, 2, None, None])
                  & live[:, o, None, None])                  # (B, H, W)
        paint = torch.stack([colour[:, o], 1 - colour[:, o],
                             0.5 * torch.ones_like(colour[:, o])], 1)
        img = torch.where(inside[:, None], paint[..., None], img)
    return img, label


SSD_PARITY_BATCH = 2
SSD_PARITY_STEPS = 3
SSD_KINDS = (("convolutions", ("conv", "cudnn", "xmma", "implicit", "nhwc",
                               "dgrad", "wgrad", "winograd")),
             ("box_nms (O4)", ("nms_",)),
             ("adam (O1)", ("multi_adamw",)),
             ("sorts", ("sort", "radix")),
             ("pooling", ("pool",)),
             ("reductions", ("reduce_kernel",)),
             ("elementwise", ("elementwise",)))
# the f32 operations of one IoU and its comparison (2 max, 2 min, 2 sub,
# 2 clamps, the product, the union's add and sub, the floor, the divide,
# the compare), per pair the greedy walk must decide
NMS_OPS_A_PAIR = 14
F32_FLOPS = 67e12                  # H100 SXM, outside the tensor cores


def ssd_net(dev, seed, classes=None):
    """The example's ``SSDNet`` on ``dev``: Xavier from a seeded
    generator (the layers' own initializers first), the heads' deferred
    shapes filled at the first forward."""
    import torch

    from mxnet_tpu_torch import initializer

    ssd_net_cls, _ = ssd_blocks()
    net = ssd_net_cls(classes or SSD["classes"], SSD_ANCHORS, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net.initialize(initializer.Xavier(), generator=gen)
    return net


@contextlib.contextmanager
def plain_nms():
    """``box_nms.nms_keep`` replaced by its plain version (on the card
    too), for the yardstick and the bitwise check of the decode."""
    from mxnet_tpu_torch.ops import box_nms

    kernel = box_nms.nms_keep
    box_nms.nms_keep = lambda boxes, valid, t: box_nms.nms_keep_ref(
        boxes, valid, t)
    try:
        yield
    finally:
        box_nms.nms_keep = kernel


def ssd_parity(mx, dev):
    """Full width (ResNet-18's 64 and 128 channels, 20 classes) at 300 x
    300, batch ``SSD_PARITY_BATCH``, f32, TF32 off, deterministic cuDNN:
    ``SSD_PARITY_STEPS`` adam steps of ``JitTrainStep(SSDTrainLoss(net),
    None, "adam")`` on the card (graphed: the second step is the
    capture) against the same steps of the port on the host in f32 (its
    eager step) and in f64 (``record()``, ``backward()`` and
    ``AdamF64``), from the same weights and batch: each step's loss.
    The card's error (of the largest loss, from the f64 run) must be
    within 1e-3, or 3x the host f32 run's own error where that is
    larger, as the gan phase holds DCGAN."""
    import torch

    from mxnet_tpu_torch import autograd

    b, n = SSD_PARITY_BATCH, SSD_PARITY_STEPS
    _, loss_cls = ssd_blocks()
    x, label = ssd_batch("cpu", b, SSD["image"], SSD["objects"],
                         SSD["classes"], 11)
    base = ssd_net("cpu", 1)
    with torch.no_grad(), autograd.predict_mode():
        base(x)                                 # the deferred shapes
    state = base.state_dict()
    runs = {}
    with exact_convs():
        for tag, where, dtype in (("card", dev, torch.float32),
                                  ("host f32", "cpu", torch.float32),
                                  ("host f64", "cpu", torch.float64)):
            net = ssd_net(where, 1)
            with torch.no_grad(), autograd.predict_mode():
                net(x.to(where))
            net.load_state_dict(state)
            blk = loss_cls(net)
            xs, ls = x.to(where, dtype), label.to(where)
            t0 = time.perf_counter()
            with mx.cpu() if where == "cpu" else mx.gpu(0):
                losses = ssd_parity_steps(mx, blk, net, xs, ls, n, dtype)
            runs[tag] = torch.tensor(losses, dtype=torch.float64)
            log("ssd parity: %s, %d steps %.2f s, losses %s"
                % (tag, n, time.perf_counter() - t0,
                   ["%.6f" % v for v in losses]))
    card, host, want = runs["card"], runs["host f32"], runs["host f64"]
    scale = want.abs().max().item()
    e_card = (card - want).abs().max().item() / scale
    e_host = (host - want).abs().max().item() / scale
    bound = max(1e-3, 3 * e_host)
    ok = e_card <= bound and bool(torch.isfinite(card).all())
    log("ssd parity: losses of %d steps: card %.3g, host f32 %.3g of the "
        "largest (%.4g) from the host's f64 run (bound %.3g) %s"
        % (n, e_card, e_host, scale, bound, "ok" if ok else "FAIL"))
    if not ok:
        fail("the card's SSD steps disagree with the host's")


def ssd_parity_steps(mx, blk, net, x, label, n, dtype):
    """``n`` steps' losses: ``JitTrainStep`` (graphed on the card: the
    second step is the capture), or in f64 ``record()``,
    ``backward()`` and ``AdamF64``."""
    import torch

    from mxnet_tpu_torch import autograd, parallel

    losses = []
    if dtype == torch.float64:
        net.double()
        adam = AdamF64(net, SSD["lr"], 0.9)
        xn = mx.nd.array(x, dtype="float64")
        ln = mx.nd.array(label)
        for _ in range(n):
            with autograd.record():
                loss = blk(xn, ln)
            loss.backward()
            adam.step(1)
            losses.append(float(loss.asscalar()))
        return losses
    step = parallel.JitTrainStep(blk, None, "adam",
                                 {"learning_rate": SSD["lr"]})
    for _ in range(n):
        losses.append(float(step.step(x, label).item()))
    if x.is_cuda and step.stats()["captures"] != 1:
        fail("the parity SSD step was not captured on the card (%s)"
             % step.stats())
    return losses


def ssd_decode(mx, net, xn):
    """The example's inference: ``MultiBoxPrior`` over the feature map,
    the class softmax and ``MultiBoxDetection(nms_threshold=0.45)``;
    returns the detections and the detection op's inputs."""
    feat, cls, loc = net(xn)
    anchors = mx.nd.contrib.MultiBoxPrior(feat, sizes=SSD_SIZES,
                                          ratios=SSD_RATIOS, clip=True)
    probs = mx.nd.softmax(cls.transpose((0, 2, 1))).transpose((0, 2, 1))
    dets = mx.nd.contrib.MultiBoxDetection(probs, loc, anchors,
                                           nms_threshold=0.45,
                                           threshold=0.01)
    return dets, (probs, loc, anchors)


def o4_inputs(probs, loc, anchors):
    """What ``MultiBoxDetection`` hands O4: the decoded boxes sorted by
    score (a stable sort of the negated scores) and ``score > 0``."""
    import torch

    from mxnet_tpu_torch.ops.vision import _decode_dets

    dets = _decode_dets(probs.data(), loc.data(), anchors.data(), True, 0.01,
                        (0.1, 0.1, 0.2, 0.2))
    order = torch.sort(-dets[:, :, 1], dim=1, stable=True).indices
    srt = torch.gather(dets, 1, order[..., None].expand(-1, -1, 6))
    return srt[:, :, 2:6].contiguous(), srt[:, :, 1] > 0.0


def o4_bound(keep, n_boxes):
    """O4's least time for this run's data, in ms, and what bounds it:
    the IoUs the greedy walk must compute (each kept box against every
    later box) at the f32 peak, against the bytes (each box and its
    valid flag read once, each keep flag written once) at HBM's rate."""
    import torch

    pos = torch.arange(keep.shape[1], device=keep.device)
    pairs = ((keep.shape[1] - 1 - pos) * keep).sum().item()
    ops_ms = 1e3 * NMS_OPS_A_PAIR * pairs / F32_FLOPS
    bytes_ms = 1e3 * n_boxes * (16 + 1 + 1) / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), pairs


def o4_two_pass_times(coords, valid, keep_ref):
    """The two-pass route's mask pass and scan, each timed alone (CUDA
    events over 20 launches) at the decode's shape; its keep mask held to
    the plain version's."""
    from mxnet_tpu_torch.ops import box_nms

    mask_pass, scan_pass, keep = box_nms.two_pass_passes(coords, valid, 0.45)
    mask_ms = cuda_ms(lambda i: mask_pass(), 20)
    scan_ms = cuda_ms(lambda i: scan_pass(), 20)
    both_ms = cuda_ms(lambda i: (mask_pass(), scan_pass()), 20)
    equal = bool((keep.bool() == keep_ref).all())
    log("ssd o4: the two-pass route at the decode's shape: mask pass %.4f "
        "ms, scan %.4f ms, both %.4f ms; keep mask %s"
        % (mask_ms, scan_ms, both_ms,
           "equal to the plain version's" if equal else "DIFFERS"))
    return {"mask_ms": mask_ms, "scan_ms": scan_ms, "both_ms": both_ms,
            "equal": equal}


def o4_cases():
    """O4's check cases: (label, boxes (B, N, 4), valid (B, N), threshold)
    on the host: random boxes, tied scores with repeated boxes, one box
    repeated (all but one suppressed), pairs whose IoU is exactly the
    threshold, a set past one 64-box word of kept rows, a negative
    threshold (every pair above it: the divide is never skipped), and
    boxes with NaN and infinite corners."""
    import torch

    g = torch.Generator(device="cpu")
    g.manual_seed(5)

    def boxes(b, n):
        xy = torch.rand(b, n, 2, generator=g) * 0.7
        wh = 0.02 + torch.rand(b, n, 2, generator=g) * 0.3
        return torch.cat([xy, xy + wh], 2)

    cases = []
    bx = boxes(4, 3000)
    cases.append(("random 4 x 3000 t 0.5", bx, torch.rand(4, 3000,
                                                          generator=g) > 0.1,
                  0.5))
    rep = boxes(2, 500)
    rep[:, 1::3] = rep[:, 0::3][:, :rep[:, 1::3].shape[1]]
    cases.append(("repeated rows 2 x 500 t 0.45", rep,
                  torch.ones(2, 500, dtype=torch.bool), 0.45))
    one = boxes(1, 1).expand(3, 777, 4).contiguous()
    cases.append(("one box 3 x 777 t 0.1", one,
                  torch.ones(3, 777, dtype=torch.bool), 0.1))
    base = torch.tensor([[0, 0, 2, 1], [0, 0, 2, 2], [0, 0, 1, 1],
                         [0, 0, 4, 1], [0, 0, 2, 1]], dtype=torch.float32)
    thr = torch.cat([base * 2.0 ** -k for k in range(40)])[None]
    cases.append(("IoU exactly 0.5, t 0.5", thr,
                  torch.ones(1, thr.shape[1], dtype=torch.bool), 0.5))
    sparse = boxes(2, 4100) * 0.2 + torch.rand(2, 4100, 1, generator=g) * 0.8
    cases.append(("sparse 2 x 4100 t 0.7", sparse,
                  torch.ones(2, 4100, dtype=torch.bool), 0.7))
    neg = boxes(2, 300)
    cases.append(("negative t -0.25 2 x 300", neg,
                  torch.rand(2, 300, generator=g) > 0.5, -0.25))
    odd = boxes(2, 1000)
    odd[:, 3::17, 0] = float("nan")
    odd[:, 5::23, 2] = float("inf")
    odd[:, 7::29, 1] = -float("inf")
    odd[:, 11::31] = torch.tensor([-float("inf"), -float("inf"),
                                   float("inf"), float("inf")])
    cases.append(("NaN and inf corners 2 x 1000", odd,
                  torch.ones(2, 1000, dtype=torch.bool), 0.3))
    return cases


def o4_checks(dev):
    """O4 against its plain version on the card, keep masks bit for bit,
    on ``o4_cases()`` through both routes (the size rule's cluster route
    and the two-pass route)."""
    import torch

    from mxnet_tpu_torch.ops import box_nms

    ok = True
    for label, bx, valid, t in o4_cases():
        bx, valid = bx.to(dev), valid.to(dev)
        want = box_nms.nms_keep_ref(bx, valid, t)
        for route in ("cluster", "two_pass"):
            got = box_nms._nms_keep(bx, valid, t, route)
            diff = int((got != want).sum())
            good = diff == 0 and got.dtype == torch.bool
            ok &= good
            log("ssd o4: %-30s %-8s kept %d of %d, %d keep flags differ "
                "from the plain version %s"
                % (label, route, int(got.sum()), got.numel(), diff,
                   "ok" if good else "FAIL"))
    if not ok:
        fail("O4's keep mask differs from its plain version's")


def ssd_train_run(mx, dev):
    """The main path at SSD300's input: ``SSDNet`` (ResNet-18's
    ``features[:6]``, 64 and 128 channels, 38 x 38 x 128 map, 5 anchors
    a cell: 7,220 anchors; 20 classes + background, 105 class
    channels), f32 with torch's defaults, batch 32 of seeded images with
    (32, 8, 5) labels, adam: ``JitTrainStep(SSDTrainLoss(net), None,
    "adam")`` graphed (2 warm-up steps, the second the capture of the
    whole step with ``MultiBoxTarget`` in it, 8 timed, 1 profiled); the
    same steps eagerly under ``record()`` with a ``gluon.Trainer`` (2 + 6
    + 1), then through the hybridized loss block (3 + 6 + 1); then one
    inference batch: ``MultiBoxPrior``, softmax, ``MultiBoxDetection``
    (O4).  Returns the counts and O4's readings at the decode's shape."""
    import torch

    from mxnet_tpu_torch import autograd, gluon, parallel
    from mxnet_tpu_torch.ops import box_nms
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    b = SSD["batch"]
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    _, loss_cls = ssd_blocks()
    net = ssd_net(dev, 0)
    x, label = ssd_batch(dev, b, SSD["image"], SSD["objects"],
                         SSD["classes"], 0)
    step_flops, _ = resnet_shapes(net, x)
    with torch.no_grad(), autograd.predict_mode():
        feat, cls, _ = net(x)
    n_anchors = feat.shape[2] * feat.shape[3] * SSD_ANCHORS
    n_params = sum(p.numel() for p in net.parameters())
    log("ssd train: SSDNet on resnet18_v1.features[:6] (%s), %.4g M "
        "parameters, f32; batch %d at %d x %d; feature map %s, %d anchors, "
        "%d class channels; labels %s; %.4g TFLOP a step (3 x 2 x the "
        "convolutions' multiply-adds); set-up %.1f s"
        % (net._layout, n_params / 1e6, b, SSD["image"], SSD["image"],
           tuple(feat.shape[1:]), n_anchors, cls.shape[1] * SSD_ANCHORS,
           tuple(label.shape), step_flops / 1e12, time.perf_counter() - t0))
    side = -(-SSD["image"] // 8)              # the stride-8 map: 38
    if n_anchors != side * side * SSD_ANCHORS \
            or cls.shape[1] != SSD["classes"] + 1:
        fail("the SSD is not at its input's shapes: %d anchors, %d class "
             "channels" % (n_anchors, cls.shape[1] * SSD_ANCHORS))
    blk = loss_cls(net)
    xn, ln = mx.nd.NDArray(x, ctx=ctx), mx.nd.NDArray(label, ctx=ctx)
    rows, losses = {}, {}
    # the main path: every count from 0 here to the decode's end
    reset_opt_counts(oo)
    box_nms.nms_keep.launches = 0

    def record(mode, fn, n_warm, n_timed):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, outs = timed_steps(fn, n_warm, n_timed)
        out, wall, busy, averages = profiled_step(fn)
        losses[mode] = [float(o.item()) for o in outs + [out]]
        rows[mode] = (times, wall, busy, averages,
                      torch.cuda.max_memory_allocated())

    step = parallel.JitTrainStep(blk, None, "adam",
                                 {"learning_rate": SSD["lr"]})
    record("JitTrainStep graphed", lambda: step.step(x, label), 2, 8)
    st = step.stats()
    log("ssd train: JitTrainStep graphed: %d capture in %.3f s (MultiBoxTarget "
        "inside it: no host read), %d replays, graph pool %.1f MB"
        % (st["captures"], st["capture_s"], st["replays"],
           st["pool_bytes"] / 1e6))
    if st["captures"] != 1 or st["replays"] != 10:     # the capture replays
        fail("the SSD train step was not captured once and replayed (%s)"
             % st)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": SSD["lr"]})

    def script_step():
        with autograd.record():
            loss = blk(xn, ln)
        loss.backward()
        trainer.step(1)
        return loss.data().detach()

    record("eager record()", script_step, 2, 6)
    blk.hybridize()
    record("hybridized record()", script_step, 3, 6)
    hst = blk.stats()
    log("ssd train: hybridized: %d captures, %d replays, %d backward "
        "replays, %d busy calls"
        % (hst["captures"], hst["replays"], hst["backward_replays"],
           hst["busy_calls"]))
    if hst["captures"] < 1 or hst["backward_replays"] < 6:
        fail("the hybridized SSD loss did not run as a graph pair (%s)"
             % hst)
    with torch.no_grad(), autograd.predict_mode():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dets, det_in = ssd_decode(mx, net, xn)
        dets_t = dets.data()
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t1) * 1e3
    o1 = opt_counts(oo)["O1"]
    o4 = box_nms.nms_keep.launches
    # -- the main path ends here
    n_steps = sum(len(v) for v in losses.values())
    flat = [v for vs in losses.values() for v in vs]
    log("ssd train: losses: %s" % "; ".join(
        "%s first %.4f last %.4f" % (m, v[0], v[-1])
        for m, v in losses.items()))
    if not all(math.isfinite(v) for v in flat):
        fail("an SSD loss is not finite")
    if not flat[-1] < flat[0]:
        fail("the SSD loss did not fall on the fixed batch (%.4f -> %.4f)"
             % (flat[0], flat[-1]))
    log("ssd train: O1 launched %d times over %d steps, O4 %d times in the "
        "decode" % (o1, n_steps, o4))
    if o1 < n_steps or o4 < 1:
        fail("the SSD main path did not launch O1 once a step (%d for %d) "
             "and O4 in its decode (%d)" % (o1, n_steps, o4))
    for mode, (times, wall, busy, averages, peak) in rows.items():
        p50_s = times[len(times) // 2]
        top, _, kern_ms = kernel_rows(averages)
        log("ssd train: %s step ms p50 %.3f (min %.3f max %.3f over %d "
            "timed), %.1f images/s, %.2f%% MFU (%.4g model FLOP a step at "
            "989 TFLOP/s), own peak device memory %.2f GB"
            % (mode, 1e3 * p50_s, 1e3 * times[0], 1e3 * times[-1],
               len(times), b / p50_s, 100 * step_flops / p50_s / BF16_FLOPS,
               step_flops, (peak - held) / 1e9))
        log("ssd train: %s profiled step: wall %.3f ms, kernels busy %.3f ms:"
            " idle %.1f%% of the profiled step, %.1f%% of the p50 step; "
            "kernels summed %.3f ms; by kind %s"
            % (mode, wall * 1e3, busy, 100 * (1 - busy / (wall * 1e3)),
               100 * max(0.0, 1 - busy / (p50_s * 1e3)), kern_ms,
               ", ".join("%s %.3f" % kv for kv in kernel_kinds(
                   averages, SSD_KINDS).items())))
        for ms, n, key in top[:8]:
            log("ssd train:   %9.3f ms  x%-5d %s" % (ms, n, key[:100]))
    return ssd_decode_readings(mx, dev, dets_t, det_in, infer_ms), o1, o4


def ssd_decode_readings(mx, dev, dets, det_in, infer_ms):
    """The decode's detections checked (shape, finite, classes in range,
    some kept) and held against the host's ``MultiBoxDetection`` on the
    same inputs (classes and kept rows equal, boxes within 1e-5);
    ``MultiBoxDetection`` timed with O4 and with its plain version, the
    two outputs bitwise equal; O4 alone timed at the decode's shape
    beside its plain version and its bound.  Returns O4's ``kernels``
    readings."""
    import torch

    from mxnet_tpu_torch.ops import box_nms

    b, a = SSD["batch"], dets.shape[1]
    side = -(-SSD["image"] // 8)
    kept = dets[:, :, 0] >= 0
    ok = (tuple(dets.shape) == (b, side * side * SSD_ANCHORS, 6)
          and bool(torch.isfinite(
        dets).all()) and bool(((dets[:, :, 0] >= -1)
                               & (dets[:, :, 0] < SSD["classes"])).all())
          and int(kept.sum()) > 0)
    log("ssd decode: detections %s, %d rows kept with a class, the batch's "
        "inference (forward, priors, softmax, detection) %.3f ms %s"
        % (tuple(dets.shape), int(kept.sum()), infer_ms,
           "ok" if ok else "FAIL"))
    probs, loc, anchors = det_in
    host = mx.nd.contrib.MultiBoxDetection(
        *(mx.nd.array(t.data().cpu(), ctx=mx.cpu()) for t in det_in),
        nms_threshold=0.45, threshold=0.01).data()
    card = dets.cpu()
    same_rows = torch.equal(card[..., 0], host[..., 0]) and torch.equal(
        card[..., 1] == -1, host[..., 1] == -1)
    err = (card - host).abs().max().item()
    good = same_rows and err <= 1e-5
    ok &= good
    log("ssd decode: against the host's MultiBoxDetection on the same "
        "inputs: classes and kept rows %s, worst difference %.3g (bound "
        "1e-5) %s" % ("equal" if same_rows else "DIFFER", err,
                      "ok" if good else "FAIL"))

    def detect(_):
        return mx.nd.contrib.MultiBoxDetection(
            probs, loc, anchors, nms_threshold=0.45, threshold=0.01)

    with torch.no_grad():
        det_ms = cuda_ms(detect, 10)
        det_host_us = host_us(lambda: detect(0), 10)
        det_kernels_ms = queued_ms(detect, 10)
        _, det_wall, det_busy, det_avg = profiled_step(lambda: detect(0))
        o4_out = detect(0).data()
        with plain_nms():
            t0 = time.perf_counter()
            plain_out = detect(0).data()
            torch.cuda.synchronize()
            det_plain_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(o4_out, plain_out)
        ok &= same
        log("ssd decode: MultiBoxDetection at (%d, %d) with O4 %.3f ms, with "
            "its plain version %.1f ms (%.0fx); the outputs %s"
            % (b, a, det_ms, det_plain_ms, det_plain_ms / det_ms,
               "bitwise equal" if same else "DIFFER"))
        coords, valid = o4_inputs(probs, loc, anchors)
        ms = cuda_ms(lambda i: box_nms.nms_keep(coords, valid, 0.45), 20)
        top, _, det_summed = kernel_rows(det_avg, top=6)
        o4_seen = sum(r[0] for r in kernel_rows(det_avg, top=10**6)[0]
                      if "nms_" in r[2])
        log("ssd decode: MultiBoxDetection's %.3f ms broken down: host "
            "enqueue %.1f us a call; its kernels queued behind a sleep "
            "%.4f ms, of which O4 alone %.4f ms and the rest %.4f ms; one "
            "profiled call: wall %.3f ms, kernels busy %.4f ms, summed %.4f "
            "ms (O4's kernel %.4f ms of it)"
            % (det_ms, det_host_us, det_kernels_ms, ms,
               det_kernels_ms - ms, 1e3 * det_wall, det_busy, det_summed,
               o4_seen))
        for k_ms, n, key in top:
            log("ssd decode:   %9.4f ms  x%-4d %s" % (k_ms, n, key[:100]))
        keep = box_nms.nms_keep(coords, valid, 0.45)
        t0 = time.perf_counter()
        keep_ref = box_nms.nms_keep_ref(coords, valid, 0.45)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        passes = o4_two_pass_times(coords, valid, keep_ref)
    diff = int((keep != keep_ref).sum())
    ok &= diff == 0 and passes["equal"]
    bound_ms, bound_by, pairs = o4_bound(keep, keep.numel())
    log("ssd o4: at the decode's shape (%d images x %d boxes, %d kept): "
        "O4 %.4f ms on the %s route (the two-pass route %.4f ms), plain "
        "%.1f ms, bound %.4f ms by %s (%d IoUs the walk needs: %.1f%% of "
        "bound), no library call (torch has no NMS without torchvision); "
        "keep flags differing %d %s"
        % (b, a, int(keep.sum()), ms, box_nms.route_for(a),
           passes["both_ms"], plain_ms, bound_ms, bound_by, pairs,
           100 * bound_ms / ms, diff, "ok" if diff == 0 else "FAIL"))
    if not ok:
        fail("the SSD decode or O4 missed a check")
    return {"max_abs_err": float(diff), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: torch has no NMS without torchvision",
            "decode_ms": det_ms, "decode_plain_ms": det_plain_ms,
            "decode_host_us": det_host_us,
            "decode_kernels_ms": det_kernels_ms,
            "nms_route": box_nms.route_for(a),
            "two_pass_ms": passes["both_ms"],
            "mask_pass_ms": passes["mask_ms"], "scan_ms": passes["scan_ms"]}


def ssd_phase(mx, dev):
    """O4's checks, the SSD's parity with the host, then the main path.
    Returns O4's ``kernels`` readings and the main path's O1 and O4
    launches."""
    start_profiler(dev)
    o4_checks(dev)
    ssd_parity(mx, dev)
    with torch_defaults():
        return ssd_train_run(mx, dev)


# -- phase 20: quant, ResNet-50 v1 calibrated and run in int8 --------------

INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
QUANT_SEED = 17
QUANT_CALIB = (2, 32)              # quantize_net_v2's calibration: batches
QUANT_PARITY_BATCH = 2
QUANT_ITERS = 13                   # forwards a mode: 3 warm-up, 10 timed
QUANT_DENOM = float(np.float32(127.0 / 4.1 * (127.0 / 0.23)))
O5_SHAPES = ((256, 2048, 1000), (32, 2048, 1000),
             (4096, 768, 3072))    # M, K, N: the output layer, BERT's FFN
QUANT_SCALES = (32.0, float(np.float32(127.0 / 4.1)))   # f32 mode's
INT8_KINDS = (("O5 + O6 (int8_wgmma_kernel, int8_splitk_reduce, "
               "int8_conv_kernel)", ("int8_wgmma", "int8_splitk",
                                     "int8_conv_kernel")),
              ("quantize's round", ("round",)),
              ("pooling", ("pool",)),
              ("reductions", ("reduce_kernel",)),
              ("copies", ("copy",)),
              ("elementwise", ("elementwise",)))
INT8_MODES = ("s8", "f32")


def quant_images(dev, batch, seed):
    """Seeded images in [0, 1), as bench.py makes them."""
    return _resnet_batch(dev, batch, RESNET_IMAGE, seed)[0]


def quant_conv_shapes(net, x):
    """Every ``nn.Conv2D`` of one ``no_grad`` predict-mode forward of the
    f32 ``net`` on ``x``, in order, as O6 takes it: the input's NHWC
    shape, the weight's OHWI shape, stride, pad, dilate and groups."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops.nn import channel_last

    shapes, hooks = [], []

    def hook(m, args, out):
        shp = tuple(args[0].shape)
        if not channel_last(m._layout):
            shp = (shp[0], shp[2], shp[3], shp[1])
        o, cg, kh, kw = m.weight.shape
        k = m._kwargs
        shapes.append(dict(x=shp, w=(o, kh, kw, cg),
                           stride=tuple(k["stride"]), pad=tuple(k["pad"]),
                           dilate=tuple(k["dilate"]),
                           groups=int(k["num_group"])))

    for m in net.modules():
        if type(m) is nn.Conv2D:
            hooks.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad(), autograd.predict_mode():
            net(x)
    finally:
        for h in hooks:
            h.detach()
    return shapes


def conv_spec(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), groups=1,
              misalign=False, **flags):
    return dict(x=x, w=w, stride=stride, pad=pad, dilate=dilate,
                groups=groups, misalign=misalign, **flags)


def int8_cases(conv_shapes):
    """(label, kind, spec) of O5's and O6's checks, each run in both A
    modes: every distinct convolution of ResNet-50 v1 at batch 2 (the
    stem among them), then the edges: the stem's geometry, groups,
    depthwise, stride 2 with padding, dilation, N, M and K tails,
    misaligned s8 and f32 views, +-inf in the f32 activation, split K at
    M 2 and 32 (O5) and at ResNet-50's last stage at batch 2 (O6), N
    1,000 and BERT's FFN."""
    cases, seen = [], set()
    for s in conv_shapes:
        key = (s["x"][1:], s["w"], s["stride"], s["pad"], s["dilate"],
               s["groups"])
        if key not in seen:
            seen.add(key)
            cases.append(("resnet50 %s * %s s%d p%d" % (
                s["x"], s["w"], s["stride"][0], s["pad"][0]), "conv",
                dict(s, misalign=False)))
    c = conv_spec
    cases += [
        ("stem C 3, stride 2, pad 3", "conv",
         c((2, 30, 30, 3), (64, 7, 7, 3), (2, 2), (3, 3))),
        ("groups 2, C/G 32", "conv", c((2, 14, 14, 64), (128, 3, 3, 32),
                                       pad=(1, 1), groups=2)),
        ("groups 2, C/G 3 (byte path)", "conv",
         c((2, 9, 9, 6), (8, 3, 3, 3), (2, 2), (1, 1), groups=2)),
        ("depthwise 32", "conv", c((2, 15, 15, 32), (32, 3, 3, 1),
                                   pad=(1, 1), groups=32)),
        ("depthwise x2, stride 2", "conv",
         c((2, 8, 8, 16), (32, 3, 3, 1), (2, 2), (1, 1), groups=16)),
        ("stride 2 pad 1", "conv", c((2, 28, 28, 64), (64, 3, 3, 64),
                                     (2, 2), (1, 1))),
        ("dilate 2 pad 2", "conv", c((2, 17, 17, 32), (48, 3, 3, 32),
                                     pad=(2, 2), dilate=(2, 2))),
        ("N tail 70, M tail", "conv", c((3, 11, 13, 48), (70, 1, 1, 48))),
        ("K tail 3 x 3 x 24", "conv", c((2, 9, 9, 24), (40, 3, 3, 24),
                                        pad=(1, 1))),
        ("misaligned x (byte path)", "conv",
         c((2, 14, 14, 64), (64, 3, 3, 64), pad=(1, 1), misalign=True)),
        ("misaligned f32 view", "conv",
         c((2, 14, 14, 64), (96, 3, 3, 64), pad=(1, 1), misalign_f32=True)),
        ("+-inf in the f32 activation", "conv",
         c((2, 12, 12, 32), (64, 3, 3, 32), pad=(1, 1), inf=True)),
        ("split K, last stage at batch 2", "conv",
         c((2, 7, 7, 512), (512, 3, 3, 512), pad=(1, 1))),
        ("fc 2 x 2048 -> 1000 (split K)", "gemm", dict(m=2, k=2048, n=1000)),
        ("fc 32 x 2048 -> 1000 (split K)", "gemm",
         dict(m=32, k=2048, n=1000)),
        ("fc 256 x 2048 -> 1000", "gemm", dict(m=256, k=2048, n=1000)),
        ("K tail 147 (byte path)", "gemm", dict(m=77, k=147, n=45)),
        ("K tail 2064", "gemm", dict(m=130, k=2064, n=200)),
        ("M and N tails", "gemm", dict(m=129, k=64, n=129)),
        ("one row, K 16", "gemm", dict(m=1, k=16, n=1)),
        ("BERT FFN 4096 x 768 -> 3072", "gemm", dict(m=4096, k=768,
                                                    n=3072)),
        ("misaligned a and b (byte path)", "gemm",
         dict(m=33, k=96, n=40, misalign=True)),
        ("misaligned f32 a, +-inf", "gemm",
         dict(m=70, k=256, n=96, misalign_f32=True, inf=True)),
    ]
    return cases


def int8_inputs(dev, kind, spec, seed):
    """Seeded int8 operands (a misaligned view where the case says so),
    an f32 and an s32 bias, and the f32 mode's activation and scale, on
    the card.  The activation is 2 N(0, 1) with a quarter of it at
    ``(j + 0.5) / 32`` (rounding ties at scale 32), a view 4 bytes off
    where ``misalign_f32``, with +-inf in it where ``inf``; the scale
    alternates between 32 and 127 / 4.1 with the seed."""
    import torch

    g = torch.Generator(device="cpu")
    g.manual_seed(seed)

    def s8(shape, misalign):
        t = torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)
        if not misalign:
            return t.to(dev)
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=dev)
        view = buf[1:].view(shape)
        view.copy_(t)
        return view

    mis = spec.get("misalign", False)
    if kind == "conv":
        x, w, o = s8(spec["x"], mis), s8(spec["w"], False), spec["w"][0]
    else:
        x, w = s8((spec["m"], spec["k"]), mis), s8((spec["n"], spec["k"]),
                                                   mis)
        o = spec["n"]
    bias_f = (torch.randn(o, generator=g) * 3).to(dev)
    bias_i = torch.randint(-2 ** 20, 2 ** 20, (o,), dtype=torch.int32,
                           generator=g).to(dev)
    xf = torch.randn(tuple(x.shape), generator=g) * 2
    ties = torch.rand(tuple(x.shape), generator=g) < 0.25
    xf[ties] = (torch.randint(-140, 140, (int(ties.sum()),), generator=g)
                .float() + 0.5) / 32
    if spec.get("inf"):
        flat = xf.view(-1)
        flat[::97] = float("inf")
        flat[5::89] = -float("inf")
    if spec.get("misalign_f32"):
        buf = torch.empty(xf.numel() + 1, device=dev)
        view = buf[1:].view(tuple(xf.shape))
        view.copy_(xf)
        xf = view
    else:
        xf = xf.to(dev)
    return x, w, bias_f, bias_i, xf, QUANT_SCALES[seed % 2]


def int8_run(kind, spec, x, w, bias, denom, plain, scale=None):
    """O6 or O5 (or its plain version) on one case; with ``scale``, ``x``
    is the f32 activation (the f32 mode; its plain version quantizes
    with ``quantize_int8`` first)."""
    from mxnet_tpu_torch.ops import int8_ops as io

    if plain and scale is not None:
        x, scale = io.quantize_int8(x, scale), None
    if kind == "conv":
        fn = io.int8_conv_ref if plain else io.int8_conv
        extra = {} if plain else {"scale": scale}
        return fn(x, w, spec["stride"], spec["pad"], spec["dilate"],
                  spec["groups"], bias=bias, denom=denom, **extra)
    if plain:
        return io.int8_gemm_ref(x, w, bias=bias, denom=denom)
    return io.int8_gemm(x, w, bias=bias, denom=denom, scale=scale)


def int8_variants(x, w, bias_f, bias_i, xf, scale):
    """(label, A, bias, denom, scale) of one case: each A mode (s8, and
    the f32 activation with its scale) in each epilogue (s32 with an s32
    bias; f32 with and without an f32 bias)."""
    out = []
    for mode, a, sc in (("s8", x, None), ("f32", xf, scale)):
        for epi, bias, denom in (("s32", bias_i, None),
                                 ("f32", bias_f, QUANT_DENOM),
                                 ("f32 no bias", None, QUANT_DENOM)):
            out.append(("%s A, %s epilogue" % (mode, epi), a, bias, denom,
                        sc))
    return out


def int8_compare(got, want):
    """(bitwise equal, largest absolute difference)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if not got.numel():
        return True, 0.0
    return (torch.equal(got, want),
            (got.double() - want.double()).abs().max().item())


def int8_checks(dev, conv_shapes):
    """O5 and O6 against their plain versions on the card, bitwise, in
    both A modes and both epilogues (``int8_variants``) on
    ``int8_cases``.  Returns the largest difference."""
    import torch

    ok, worst, runs = True, 0.0, 0
    for i, (label, kind, spec) in enumerate(int8_cases(conv_shapes)):
        x, w, bias_f, bias_i, xf, scale = int8_inputs(dev, kind, spec,
                                                      100 + i)
        bad = []
        for what, a, bias, denom, sc in int8_variants(x, w, bias_f, bias_i,
                                                      xf, scale):
            got = int8_run(kind, spec, a, w, bias, denom, False, sc)
            want = int8_run(kind, spec, a, w, bias, denom, True, sc)
            torch.cuda.synchronize()
            same, err = int8_compare(got, want)
            worst = max(worst, err)
            runs += 1
            if not same:
                bad.append("%s (%.3g)" % (what, err))
        ok &= not bad
        log("quant o5/o6: %-46s %s" % (label, "bitwise equal in both A "
                                       "modes and both epilogues" if not bad
                                       else "DIFFER: %s" % ", ".join(bad)))
    log("quant o5/o6: %d runs (cases x A modes x epilogues)" % runs)
    if not ok:
        fail("O5 or O6 differs from its plain version")
    return worst


@contextlib.contextmanager
def planted_int8_library(path):
    """O5's and O6's kernel taken from the library at ``path`` (built
    with a planted fault) inside the block."""
    import ctypes

    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import int8_ops as io

    good = io._load()
    lib = ctypes.CDLL(path)
    io._bind(lib)
    _build._libs[io._SOURCE] = lib
    try:
        yield
    finally:
        _build._libs[io._SOURCE] = good


def planted_int8_fault(dev, conv_shapes, path):
    """A build whose K loop drops the last tile of every split
    (``MXTT_SKIP_LAST``) must differ from the plain version in every
    case, A mode and epilogue of the checks."""
    import torch

    cases = int8_cases(conv_shapes)
    caught = runs = 0
    missed = []
    with planted_int8_library(path):
        for i, (label, kind, spec) in enumerate(cases):
            x, w, bias_f, bias_i, xf, scale = int8_inputs(dev, kind, spec,
                                                          100 + i)
            for what, a, bias, denom, sc in int8_variants(
                    x, w, bias_f, bias_i, xf, scale):
                got = int8_run(kind, spec, a, w, bias, denom, False, sc)
                want = int8_run(kind, spec, a, w, bias, denom, True, sc)
                torch.cuda.synchronize()
                runs += 1
                if int8_compare(got, want)[0]:
                    missed.append("%s: %s" % (label, what))
                else:
                    caught += 1
    log("quant o5/o6: a build that drops the last K tile of every split "
        "differs from the plain version in %d of %d runs (must be all)%s"
        % (caught, runs, "" if not missed else "; passed: %s"
           % "; ".join(missed[:6])))
    if caught != runs:
        fail("the O5/O6 checks pass a build that drops the last K tile")


def quantized_op_checks(dev):
    """The registered ops' NCHW form on the card (O6 through
    ``_contrib_quantized_conv``, groups 2, stride 2, pad 1, an int8
    bias; O5 through ``_contrib_quantized_fully_connected``, flattened)
    against the same ops on the host: the s32 sums and the ranges
    bitwise.  So are ``_contrib_quantize`` and ``_contrib_dequantize`` at
    a range of 3.5, whose quotients are not the products by their
    reciprocals (both divide truly, as the JAX package does)."""
    import torch

    from mxnet_tpu_torch.ops import registry as reg

    g = torch.Generator(device="cpu")
    g.manual_seed(7)

    def s8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)

    ranges = [torch.tensor(v) for v in (-1.5, 2.0, -0.3, 0.25, -0.02, 0.03)]
    lo, hi = torch.tensor([-1.2]), torch.tensor([2.3])
    grid = torch.linspace(-1.3, 2.4, 40001)
    runs = (("_contrib_quantized_conv",
             [s8(2, 32, 15, 15), s8(48, 16, 3, 3), s8(48)] + ranges,
             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=48,
                  num_group=2)),
            ("_contrib_quantized_fully_connected",
             [s8(3, 5, 40), s8(17, 200), s8(17)] + ranges,
             dict(num_hidden=17)),
            ("_contrib_quantize", [grid, lo, hi], dict(out_type="uint8")),
            ("_contrib_quantize", [grid, lo, hi], dict(out_type="int8")),
            ("_contrib_dequantize", [s8(40001), lo, hi], {}),
            ("_contrib_dequantize",
             [torch.randint(0, 256, (40001,), dtype=torch.uint8,
                            generator=g), lo, hi], {}))
    ok = True
    for name, tensors, attrs in runs:
        fwd = reg.get(name).forward
        host = fwd(*tensors, **attrs)
        card = fwd(*[t.to(dev) for t in tensors], **attrs)
        host = host if isinstance(host, tuple) else (host,)
        card = card if isinstance(card, tuple) else (card,)
        torch.cuda.synchronize()
        same = all(c.dtype == h.dtype and torch.equal(c.cpu(), h)
                   for c, h in zip(card, host))
        ok &= same
        log("quant ops: %s on the card against the host: out %s %s, "
            "ranges %s %s" % (name, tuple(card[0].shape), card[0].dtype,
                              [round(float(r), 6) for r in card[1:]],
                              "bitwise equal" if same else "DIFFER"))
    if not ok:
        fail("a registered quantized op differs between the card and the "
             "host")


def quant_blocks(net):
    """``{path: block}`` of a quantized net's int8 layers."""
    from mxnet_tpu_torch.contrib import quantization as q

    return {name: m for name, m in net.named_modules()
            if isinstance(m, (q.QuantizedConv2D, q.QuantizedDense))}


def quantize_like(host, card):
    """Swap ``host``'s layers for int8 ones at ``card``'s paths and
    thresholds (the same weights give the same int8 weights)."""
    for path, blk in quant_blocks(card).items():
        parent_path, _, name = path.rpartition(".")
        parent = host.get_submodule(parent_path) if parent_path else host
        setattr(parent, name, type(blk)(parent._modules[name],
                                        blk._threshold))
    return host


def int8_agreement(got, want):
    """Relative error of ``got``'s logits against ``want``'s largest,
    top-1 agreement, and the share of images whose ``want`` top-1 class
    is in ``got``'s top 5."""
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    top1 = (got.argmax(1) == want.argmax(1)).float().mean().item()
    top5 = (got.topk(5, 1).indices == want.argmax(1, keepdim=True)) \
        .any(1).float().mean().item()
    return err, top1, top5


def _p50(ms):
    s = sorted(ms[3:])
    return s[len(s) // 2], s[0], s[-1]


def int8_launches(zero=False):
    """O6's and O5's launch counts ({"O6": n, "O5": n}); ``zero`` sets
    them, and the counts by route and mode, to 0 first."""
    from mxnet_tpu_torch.ops import int8_ops as io

    if zero:
        io.zero_counts()
    return {"O6": io.int8_conv.launches, "O5": io.int8_gemm.launches}


def int8_routes():
    """The launches by route and mode: {"O6": {"wgmma_f32": n, ...},
    "O5": {...}}."""
    from mxnet_tpu_torch.ops import int8_ops as io

    return {"O6": io.route_counts(io.int8_conv),
            "O5": io.route_counts(io.int8_gemm)}


def held_launches(what, forwards):
    """The counts since the last zeroing, held at one launch of O6 a
    convolution and of O5 a forward, over ``forwards`` int8 forwards of
    ResNet-50 (replays included), every one on the wgmma route in the f32
    mode (the layers' activation quantized in the kernels' load).
    Returns the counts and the counts by route."""
    got, routes = int8_launches(), int8_routes()
    log("quant launches, %s: O6 %d (want 53 x %d forwards = %d), O5 %d "
        "(want %d); by route and mode: O6 %s, O5 %s"
        % (what, got["O6"], forwards, 53 * forwards, got["O5"], forwards,
           routes["O6"], routes["O5"]))
    if got != {"O6": 53 * forwards, "O5": forwards}:
        fail("O5/O6 were not launched once a layer a forward (%s)" % what)
    if routes["O6"]["wgmma_f32"] != got["O6"] \
            or routes["O5"]["wgmma_f32"] != got["O5"]:
        fail("the int8 layers did not all take the wgmma route in the f32 "
             "mode (%s)" % what)
    return got, routes


def entropy_host_check(dev, ent, naive, calib):
    """Each threshold of the entropy calibration on the card (``ent``,
    calibrated over ``calib``) against ``_get_optimal_threshold`` on the
    host over the same layers' inputs (taken from a second f32 net of the
    same seed, deterministic convolutions): bitwise.  Logs the entropy
    thresholds' ratios to the naive ones (``naive``: path -> block)."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q

    thr = {p: b._threshold for p, b in quant_blocks(ent).items()}
    probe = resnet_net(dev, "resnet50_v1", QUANT_SEED)
    samples = {p: [] for p in thr}

    def keep(path):
        return lambda blk, args: samples[path].append(
            args[0].detach().float().cpu().numpy())

    hooks = [probe.get_submodule(p).register_forward_pre_hook(keep(p))
             for p in thr]
    t0 = time.perf_counter()
    try:
        with exact_convs(), torch.no_grad(), autograd.predict_mode():
            for xb in calib:
                probe(xb)
    finally:
        for h in hooks:
            h.detach()
    del probe
    bad = [p for p in thr
           if q._get_optimal_threshold(samples.pop(p)) != thr[p]]
    ratios = sorted((thr[p] / naive[p]._threshold, p) for p in thr)
    log("quant calibration: entropy thresholds on the card against "
        "_get_optimal_threshold on the host over the same inputs: %d of %d "
        "bitwise equal (%.1f s); entropy / naive threshold: least %.4g "
        "(%s), median %.4g, largest %.4g (%s), %d of %d under 0.5"
        % (len(thr) - len(bad), len(thr), time.perf_counter() - t0,
           ratios[0][0], ratios[0][1], ratios[len(ratios) // 2][0],
           ratios[-1][0], ratios[-1][1],
           sum(r < 0.5 for r, _ in ratios), len(ratios)))
    if bad:
        fail("the card's entropy thresholds differ from the host's at %s"
             % ", ".join(bad[:5]))


def quant_parity(dev, net, net_f):
    """The card against the host's plain int8 run of the same weights
    and thresholds, at batch QUANT_PARITY_BATCH.  The main path's own
    ``net`` is held layer by layer: each int8 layer on the host, fed the
    card's input to that layer, must give the card's int8 activations and
    output bitwise.  Whole nets are held with each BatchNorm an exact
    identity (1e-3 of the largest logit); with the fresh statistics the
    whole-net reading is logged.  Returns the int8 forwards run on the
    card."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.ops import int8_ops as io
    from mxnet_tpu_torch.ops.nn import channel_last

    x = quant_images(dev, QUANT_PARITY_BATCH, 70)
    seen = {}

    def nchw(blk, t, back=False):
        """A convolution's NHWC tensor (the card's layout) as NCHW, or
        with ``back`` an NCHW one in ``blk``'s layout."""
        if not (isinstance(blk, q.QuantizedConv2D)
                and channel_last(blk._layout)):
            return t
        return t.permute(0, 2, 3, 1) if back else t.permute(0, 3, 1, 2)

    def keep(path):
        def hook(blk, args, out):
            qx = io.quantize_int8(args[0], blk._x_scale)
            seen[path] = tuple(nchw(blk, t).cpu() for t in (args[0], qx,
                                                           out))
        return hook

    def host_net(state):
        h = resnet_net("cpu", "resnet50_v1", 1)
        resnet_shapes(h, x.cpu())
        h.load_state_dict(state)
        return quantize_like(h, net)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    hooks = [b.register_forward_hook(keep(p))
             for p, b in quant_blocks(net).items()]
    net.hybridize(False)
    try:
        with torch.no_grad(), autograd.predict_mode():
            card_out = net(x).cpu()
    finally:
        for h in hooks:
            h.detach()
    host = host_net(net_f.state_dict())
    bad, n_act, n_layers = [], 0, len(seen)
    with torch.no_grad(), autograd.predict_mode():
        fresh = rel(card_out, host(x.cpu()))
        for path, blk in quant_blocks(host).items():
            xin, q_card, want = seen.pop(path)
            q_host = io.quantize_int8(xin, blk._x_scale)
            n_act += q_host.numel()
            got = nchw(blk, blk(nchw(blk, xin, back=True)))
            if not (torch.equal(q_host, q_card) and torch.equal(got, want)):
                bad.append(path)
    del host

    state = {k: v.clone() for k, v in net_f.state_dict().items()}
    for k, v in state.items():
        if k.endswith("running_var"):
            v.fill_(float(np.float32(1) - np.float32(1e-5)))
        elif k.endswith(("running_mean", "beta")):
            v.zero_()
        elif k.endswith("gamma"):
            v.fill_(1.0)
    card = resnet_net(dev, "resnet50_v1", 1)
    resnet_shapes(card, x)
    card.load_state_dict(state)
    quantize_like(card, net)
    with torch.no_grad(), autograd.predict_mode():
        ident = rel(card(x).cpu(), host_net(state)(x.cpu()))
    log("quant parity: batch %d, the main path's net layer by layer: %d "
        "of %d int8 layers on the host, fed the card's input, give the "
        "card's int8 activations (%d elements) and outputs bitwise%s; "
        "whole nets, the card's int8 logits against the host's plain int8 "
        "run of the same weights and thresholds: %.3g of the largest logit "
        "with each BatchNorm an exact identity (running variance f32(1 - "
        "eps); bound 1e-3) %s; %.3g with the fresh statistics (logged: "
        "each f32 BatchNorm's one-ulp differences between the card and the "
        "host turn int8 roundings at .5 boundaries, and the flips compound "
        "over 53 layers)"
        % (QUANT_PARITY_BATCH, n_layers - len(bad), n_layers, n_act,
           "" if not bad else " (DIFFERENT at %s)" % ", ".join(bad[:5]),
           ident, "ok" if ident <= 1e-3 else "FAIL", fresh))
    if bad or n_layers != 54:
        fail("an int8 layer of the main path differs between the card and "
             "the host on the same input")
    if not (ident <= 1e-3):
        fail("the card's int8 ResNet-50 disagrees with the host's")
    return 2


def quant_main_path(dev, net_f):
    """ResNet-50 v1 calibrated through ``quantize_net_v2`` while
    hybridized (R10's case), naive and, on a fresh copy, entropy; then
    int8 inference eager and hybridized at RESNET_INFER_BATCHES beside
    the f32 net, and the card against the host's plain int8 run.
    Returns O5's and O6's launches in the int8 inference runs (replays
    included), counted from 0 just before them and read just after."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q

    n_batches, batch = QUANT_CALIB
    calib = [quant_images(dev, batch, 31 + i) for i in range(n_batches)]
    out = {}
    with exact_convs():
        net = resnet_net(dev, "resnet50_v1", QUANT_SEED)
        net.hybridize()
        with torch.no_grad(), autograd.predict_mode():
            for _ in range(3):
                net(calib[0])
        captured = net.stats()["captures"]
        if captured < 1:
            fail("the hybridized ResNet-50 captured no graph before "
                 "quantize_net_v2")
        t0 = time.perf_counter()
        q.quantize_net_v2(net, calib_mode="naive", calib_data=calib)
        torch.cuda.synchronize()
        out["naive_s"] = time.perf_counter() - t0
        eager = resnet_net(dev, "resnet50_v1", QUANT_SEED)
        q.quantize_net_v2(eager, calib_mode="naive", calib_data=calib)
        ent = resnet_net(dev, "resnet50_v1", QUANT_SEED)
        t0 = time.perf_counter()
        q.quantize_net_v2(ent, calib_mode="entropy", calib_data=calib)
        torch.cuda.synchronize()
        out["entropy_s"] = time.perf_counter() - t0
    blocks, eblocks = quant_blocks(net), quant_blocks(eager)
    kinds = [type(b).__name__ for b in blocks.values()]
    n_conv, n_dense = kinds.count("QuantizedConv2D"), \
        kinds.count("QuantizedDense")
    same_thr = blocks.keys() == eblocks.keys() and all(
        blocks[p]._threshold == eblocks[p]._threshold for p in blocks)
    ent_thr = quant_blocks(ent)
    log("quant calibration: %d QuantizedConv2D + %d QuantizedDense; naive "
        "%.2f s over %d x %d images (hybridized, %d graph(s) captured "
        "before), entropy %.2f s on a fresh copy; the hybridized net's "
        "thresholds %s the eager calibration's (first %.5g, output %.5g; "
        "entropy %.5g, %.5g)"
        % (n_conv, n_dense, out["naive_s"], n_batches, batch,
           captured, out["entropy_s"],
           "equal" if same_thr else "DIFFER from",
           blocks["features.0"]._threshold, blocks["output"]._threshold,
           ent_thr["features.0"]._threshold, ent_thr["output"]._threshold))
    if (n_conv, n_dense) != (53, 1):
        fail("quantize_net_v2 swapped %d convolutions and %d dense layers, "
             "not 53 and 1" % (n_conv, n_dense))
    if not same_thr:
        fail("R10: the hybridized net's thresholds differ from an eager "
             "calibration's")
    if out["entropy_s"] > 90:
        log("quant calibration: entropy calibration took over 90 s")
    entropy_host_check(dev, ent, blocks, calib)
    del calib
    gc.collect()
    torch.cuda.empty_cache()

    launches = {"O6": 0, "O5": 0}
    routes = {k: {r: 0 for r in v} for k, v in int8_routes().items()}
    with exact_convs(deterministic=False):
        for b in RESNET_INFER_BATCHES:
            x = quant_images(dev, b, 50 + b)
            net_f.hybridize(False)
            fe, f_out = timed_forward(net_f, x, QUANT_ITERS)
            net_f.hybridize()
            fh, _ = timed_forward(net_f, x, QUANT_ITERS)
            net_f.hybridize(False)
            # the main path: int8 inference, eager then hybridized
            int8_launches(zero=True)
            net.hybridize(False)
            ie, i_out = timed_forward(net, x, QUANT_ITERS)
            net.hybridize()
            ih, h_out = timed_forward(net, x, QUANT_ITERS)
            st = net.stats()
            forwards = 2 * QUANT_ITERS
            if b == RESNET_INFER_BATCHES[-1]:
                _, wall, busy, avg = profiled_step(lambda: net(x))
                forwards += 1
                out["profile"] = (wall * 1e3, busy,
                                  kernel_kinds(avg, INT8_KINDS))
                out["profile_rows"] = kernel_rows(avg, top=10)[0]
                out["quantize_rows"] = quantize_rows(avg)
            got, got_routes = held_launches("int8 inference at batch %d"
                                            % b, forwards)
            launches = {k: launches[k] + got[k] for k in launches}
            for k in routes:
                for r, v in got_routes[k].items():
                    routes[k][r] += v
            if b == RESNET_INFER_BATCHES[0]:
                int8_launches(zero=True)
                with torch.no_grad():
                    e_out, n_out = eager(x), ent(x)
                held_launches("the eager-calibrated and entropy copies at "
                              "batch %d (not the main path)" % b, 2)
                out["entropy"] = int8_agreement(n_out, f_out)
                if not torch.equal(e_out, i_out):
                    fail("R10: the eager-calibrated net's int8 logits "
                         "differ from the hybridized-calibrated net's")
            net.hybridize(False)
            fin = bool(torch.isfinite(h_out).all())
            equal = torch.equal(h_out, i_out)
            stale = torch.equal(h_out, f_out)
            err, top1, top5 = int8_agreement(h_out, f_out)
            log("quant infer: batch %d, no_grad: f32 (TF32 off) eager ms p50 "
                "%.3f (min %.3f max %.3f), hybridized %.3f (%.3f, %.3f); "
                "int8 eager %.3f (%.3f, %.3f), %.1f images/s, hybridized "
                "%.3f (%.3f, %.3f), %.1f images/s; f32 %.1f / %.1f images/s"
                % ((b,) + _p50(fe) + _p50(fh) + _p50(ie)
                   + (1e3 * b / _p50(ie)[0],) + _p50(ih)
                   + (1e3 * b / _p50(ih)[0], 1e3 * b / _p50(fe)[0],
                      1e3 * b / _p50(fh)[0])))
            log("quant infer: batch %d: hybridized int8 logits %s the eager "
                "ones (%d capture(s), %d replays), %s the f32 net's; int8 "
                "against f32: %.4g of the largest logit, top-1 agreement "
                "%.4f, f32 top-1 in the int8 top-5 %.4f"
                % (b, "bitwise equal to" if equal else "DIFFER from",
                   st["captures"], st["replays"],
                   "STALE: equal to" if stale else "differ from", err, top1,
                   top5))
            if not (fin and equal and not stale and st["replays"] > 0):
                fail("int8 inference at batch %d: finite %s, hybridized "
                     "equal to eager %s, differs from f32 %s, replays %d"
                     % (b, fin, equal, not stale, st["replays"]))
            del x, f_out, i_out, h_out
            gc.collect()
            torch.cuda.empty_cache()
    log("quant infer: entropy-calibrated net at batch %d against f32: %.4g "
        "of the largest logit, top-1 %.4f, top-5 %.4f"
        % ((RESNET_INFER_BATCHES[0],) + out["entropy"]))
    log("quant launches, the main path (int8 inference at batches %s): O6 "
        "%d, O5 %d; by route and mode: O6 %s, O5 %s"
        % (list(RESNET_INFER_BATCHES), launches["O6"], launches["O5"],
           routes["O6"], routes["O5"]))

    int8_launches(zero=True)
    held_launches("the parity runs on the card (not the main path)",
                  quant_parity(dev, net, net_f))
    wall, busy, kinds_ms = out["profile"]
    log("quant profile: one hybridized int8 forward at batch %d: wall %.3f "
        "ms, kernels busy %.3f ms; %s"
        % (RESNET_INFER_BATCHES[-1], wall, busy,
           ", ".join("%s %.3f" % kv for kv in kinds_ms.items())))
    for ms, count, key in out["profile_rows"]:
        log("quant profile:   %9.3f ms  x%-4d %s" % (ms, count, key[:90]))
    # the layers' quantize runs in O5's and O6's load: no round pass, and
    # no multiply, cast or clamp kernels beside the ReLUs and adds
    passes = [key for _, _, key in out["quantize_rows"]]
    log("quant profile: separate quantize passes (round, or mul / cast / "
        "clamp to int8) in the int8 forward: %s"
        % (", ".join(passes) if passes else "none"))
    if passes or kinds_ms["quantize's round"] > 0:
        fail("the hybridized int8 forward still runs separate quantize "
             "passes: %s" % ", ".join(passes))
    del net, eager, ent
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def quantize_rows(averages):
    """The profile's kernels that would be a separate activation quantize:
    a round, or an elementwise kernel that writes int8 (torch names its
    dtypes in the kernel's template arguments: ``signed char``)."""
    rows = []
    for e in averages:
        if e.self_device_time_total <= 0:
            continue
        key = e.key.lower()
        if "round" in key or ("elementwise" in key and "signed char" in key):
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    return rows


def int8_bound(ops, nbytes):
    """(least ms, what bounds it) of ``ops`` int8 operations and
    ``nbytes`` bytes on the H100."""
    ops_ms, bytes_ms = 1e3 * ops / INT8_OPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _touched(size, k, stride, pad, dilate, out):
    """How many of an input axis's ``size`` positions a convolution's
    windows read (a strided 1 x 1 reads every ``stride``-th)."""
    return len({i * stride - pad + t * dilate for i in range(out)
                for t in range(k)} & set(range(size)))


def conv_work(s, in_bytes=1):
    """Operations and bytes of one O6 call (f32 output, no bias): each
    input element a window reads, read once at ``in_bytes`` an element (1
    in the s8 mode, 4 in the f32 mode), the weights once, the output
    written once."""
    from mxnet_tpu_torch.ops.int8_ops import conv_out_size

    n, h, w, c = s["x"]
    o, kh, kw, cg = s["w"]
    (sh, sw), (ph, pw), (dh, dw) = s["stride"], s["pad"], s["dilate"]
    p = conv_out_size(h, kh, sh, ph, dh)
    q = conv_out_size(w, kw, sw, pw, dw)
    m = n * p * q
    read = n * _touched(h, kh, sh, ph, dh, p) \
        * _touched(w, kw, sw, pw, dw, q) * c
    return (2 * m * o * kh * kw * cg,
            in_bytes * read + o * kh * kw * cg + 4 * m * o)


def o6_bound(shapes, in_bytes):
    """(bound ms, what bounds most of it, ms of it bound by operations)
    of O6 over ``shapes``."""
    bounds = [int8_bound(*conv_work(s, in_bytes)) for s in shapes]
    total = sum(b[0] for b in bounds)
    by_ops = sum(b[0] for b in bounds if b[1] == "operations")
    return total, "operations" if by_ops >= total / 2 else "bytes", by_ops


def o6_calls(shapes, xs, ws, scale=None):
    """One pass of O6 over ``shapes`` (f32 epilogue, as the net runs
    them); with ``scale`` the inputs are f32 (the f32 mode)."""
    from mxnet_tpu_torch.ops import int8_ops as io

    def run(_):
        for s, x, w in zip(shapes, xs, ws):
            io.int8_conv(x, w, s["stride"], s["pad"], s["dilate"],
                         s["groups"], denom=QUANT_DENOM, scale=scale)
    return run


def quant_kernel_timing(dev, net_f):
    """O6 over ResNet-50's 53 convolutions at batch 256 (f32 epilogue, as
    the net runs them) in the s8 mode and in the f32 mode (the layers'
    activation quantized in the load), and O5 at O5_SHAPES (f32 epilogue
    with bias) in both modes, queued behind a sleep, beside their bounds,
    the s8 mode's plain versions and the yardsticks: cuDNN's bf16
    convolutions at the same shapes, ``torch._int_mm`` (s32 out, no
    epilogue), and the torch quantize of the 53 inputs timed the same
    way."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import int8_ops as io

    with exact_convs():
        shapes = quant_conv_shapes(net_f, quant_images(dev, 256, 60))
    gc.collect()
    torch.cuda.empty_cache()
    xs = [torch.randint(-127, 128, s["x"], dtype=torch.int8, device=dev)
          for s in shapes]
    ws = [torch.randint(-127, 128, s["w"], dtype=torch.int8, device=dev)
          for s in shapes]

    def o6_plain(_):
        for s, x, w in zip(shapes, xs, ws):
            io.int8_conv_ref(x, w, s["stride"], s["pad"], s["dilate"],
                             s["groups"], denom=QUANT_DENOM)

    ms = queued_ms(o6_calls(shapes, xs, ws), 5)
    plain_ms = queued_ms(o6_plain, 1, warmup=1)
    work = [conv_work(s) for s in shapes]
    bound_ms, bound_by, by_ops = o6_bound(shapes, 1)
    xb = [x.to(torch.bfloat16).permute(0, 3, 1, 2) for x in xs]
    wb = [w.to(torch.bfloat16).permute(0, 3, 1, 2) for w in ws]
    del xs

    def cudnn_bf16(_):
        for s, x, w in zip(shapes, xb, wb):
            F.conv2d(x, w, None, s["stride"], s["pad"], s["dilate"],
                     s["groups"])

    with exact_convs(deterministic=False):
        lib_ms = queued_ms(cudnn_bf16, 5)
    del xb, wb
    gc.collect()
    torch.cuda.empty_cache()
    xf = [torch.randn(s["x"], device=dev) for s in shapes]
    quant_ms = queued_ms(lambda _: [io.quantize_int8(x, 25.4) for x in xf],
                         3)
    quant_bytes = sum(5 * x.numel() for x in xf)
    f32_ms = queued_ms(o6_calls(shapes, xf, ws, 25.4), 5)
    f32_bound, f32_by, _ = o6_bound(shapes, 4)
    del xf, ws
    gc.collect()
    torch.cuda.empty_cache()
    o6_t = {"max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "cudnn_bf16_ms": lib_ms,
            "quantize_ms": quant_ms,
            "quantize_bound_ms": 1e3 * quant_bytes / HBM_BYTES_PER_S,
            "f32_mode_ms": f32_ms, "f32_mode_bound_ms": f32_bound,
            "f32_mode_bound_by": f32_by,
            "tops": 1e-9 * sum(wk[0] for wk in work) / ms}
    log("quant o6: the 53 convolutions of ResNet-50 v1 at batch 256 (f32 "
        "out), s8 mode: %.4f ms queued (%.1f TOP/s, %.1f%% of the %.4f ms "
        "bound, %.4f ms of it bound by operations), plain (float64) %.1f "
        "ms; cuDNN's bf16 convolutions at the same shapes %.4f ms (another "
        "function; torch has no int8 convolution)"
        % (ms, o6_t["tops"], 100 * bound_ms / ms, bound_ms, by_ops,
           plain_ms, lib_ms))
    log("quant o6: f32 mode (the activation quantized in the load): %.4f "
        "ms queued, %.1f%% of its %.4f ms bound (4-byte inputs, %s); the "
        "torch quantize of the 53 inputs alone %.4f ms against its %.4f ms "
        "byte bound, so the parent's quantize + O6 came to %.4f ms of "
        "kernels"
        % (f32_ms, 100 * f32_bound / f32_ms, f32_bound, f32_by, quant_ms,
           o6_t["quantize_bound_ms"], quant_ms + ms))
    o5 = []
    for m, k, n in O5_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        af = torch.randn(m, k, device=dev)
        b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        bias = torch.randn(n, device=dev)
        t = queued_ms(lambda _: io.int8_gemm(a, b, bias=bias,
                                             denom=QUANT_DENOM), 50)
        tf = queued_ms(lambda _: io.int8_gemm(af, b, bias=bias,
                                              denom=QUANT_DENOM,
                                              scale=25.4), 50)
        tp = queued_ms(lambda _: io.int8_gemm_ref(a, b, bias=bias,
                                                  denom=QUANT_DENOM), 5)
        try:
            lib = queued_ms(lambda _: torch._int_mm(a, b.t()), 50)
        except RuntimeError as e:
            log("quant o5: torch._int_mm refused (%d, %d, %d): %s"
                % (m, k, n, e))
            lib = None
        bms, bby = int8_bound(2 * m * n * k, m * k + n * k + 4 * m * n
                              + 4 * n)
        fbms, fbby = int8_bound(2 * m * n * k, 4 * m * k + n * k
                                + 4 * m * n + 4 * n)
        o5.append({"max_abs_err": None, "ms": t, "plain_ms": tp,
                   "bound_ms": bms, "bound_by": bby, "library_ms": lib,
                   "f32_mode_ms": tf, "f32_mode_bound_ms": fbms,
                   "shape": [m, k, n]})
        log("quant o5: M %d, K %d, N %d (f32 out, bias): s8 mode %.4f ms "
            "queued (%.1f TOP/s, %.1f%% of the %.4f ms %s bound), f32 mode "
            "%.4f ms (%.1f%% of its %.4f ms %s bound), plain %.4f ms, "
            "torch._int_mm (s32 out) %s ms"
            % (m, k, n, t, 2e-9 * m * n * k / t, 100 * bms / t, bms, bby,
               tf, 100 * fbms / tf, fbms, fbby, tp,
               "%.4f" % lib if lib is not None else "n/a"))
    return o6_t, o5


def quant_phase(dev, planted_path):
    """O5's and O6's checks and planted fault, the registered ops on the
    card, the main path (``quant_main_path``), then the kernels' timing.
    Returns the launches and the ``kernels`` readings."""
    import torch

    start_profiler(dev)
    with exact_convs():
        net_f = resnet_net(dev, "resnet50_v1", QUANT_SEED)
        shapes = quant_conv_shapes(net_f, quant_images(dev, 2, 40))
    if len(shapes) != 53:
        fail("ResNet-50 v1 ran %d convolutions, not 53" % len(shapes))
    worst = int8_checks(dev, shapes)
    planted_int8_fault(dev, shapes, planted_path)
    quantized_op_checks(dev)
    launches = quant_main_path(dev, net_f)
    o6, o5 = quant_kernel_timing(dev, net_f)
    o6["max_abs_err"] = worst
    for r in o5:
        r["max_abs_err"] = worst
    del net_f
    gc.collect()
    torch.cuda.empty_cache()
    return launches, o6, o5


# -- phase 21: sparse storage, O7 and O8 -----------------------------------

SPARSE_SEED = 23
# path A: MovieLens-10M's id ranges (upstream example/sparse/
# matrix_factorization), factor 128; ratings from a seeded rank-6 truth
# as examples/recommenders/train_mf.py makes them, a pool of 4 batches
# of 8,192 ratings trained for 5 epochs
MF = dict(users=71569, movies=65135, factor=128, rank=6, batch=8192,
          batches=4, steps=20, lr=1.0, parity_steps=3)
# path B: Avazu's width (upstream example/sparse/linear_classification),
# 22 nonzeros a row (one a categorical field; this smoke's choice), ids
# Zipf-skewed within each field's range, labels from a hidden weight
LC = dict(features=1000001, fields=22, batch=8192, batches=8, epochs=3,
          lr=2.0, zipf=1.3)
O7_TOL = 1e-5     # of the largest |value|: sums in another order (atomics)
O8_TOL = 1e-6     # of the largest |value|: the same f32 ops, bitwise expected


def sparse_counts(zero=False):
    """O7's launches (forward, transposed) and O8's, set to 0 first when
    ``zero``."""
    from mxnet_tpu_torch.ops import sparse_ops as sops

    if zero:
        sops.csr_dot.launches = sops.csr_dot.transposed_launches = 0
        sops.rsp_lazy_update.launches = 0
    t = sops.csr_dot.transposed_launches
    return sops.csr_dot.launches - t, t, sops.rsp_lazy_update.launches


def mf_pool(m, seed):
    """The rating pool: ``batches`` of (users, movies, ratings), ids as
    f32 as the example's ``nd.array`` batches carry them."""
    rs = np.random.RandomState(seed)
    tu = rs.randn(m["users"], m["rank"]).astype(np.float32)
    tv = rs.randn(m["movies"], m["rank"]).astype(np.float32)
    pool = []
    for _ in range(m["batches"]):
        u = rs.randint(0, m["users"], m["batch"])
        i = rs.randint(0, m["movies"], m["batch"])
        r = (tu[u] * tv[i]).sum(1) / np.sqrt(m["rank"]) \
            + 0.05 * rs.randn(m["batch"])
        pool.append((u.astype(np.float32), i.astype(np.float32),
                     r.astype(np.float32)))
    return pool


def mf_net(mx, dev, m, weights=None):
    """``train_mf.py``'s MFNet on the port: two ``Embedding(sparse_grad=
    True)`` tables, the rows' product summed; Normal(0.1) weights, or
    ``weights`` copied in."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class MFNet(gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.user = nn.Embedding(m["users"], m["factor"],
                                         sparse_grad=True)
                self.item = nn.Embedding(m["movies"], m["factor"],
                                         sparse_grad=True)

        def forward(self, users, items):
            return (self.user(users) * self.item(items)).sum(axis=-1)

    with mx.Context.from_device(dev):
        net = MFNet()
        net.initialize(mx.init.Normal(0.1))
    if weights is not None:
        for t, w in zip((net.user.weight, net.item.weight), weights):
            t.set_data(mx.nd.array(w, ctx=mx.Context.from_device(dev)))
    return net


def mf_trainer(net, lr, plain=False):
    """``gluon.Trainer(..., "adagrad")``; with ``plain`` its lazy update
    takes O8's plain version (the generic route)."""
    from mxnet_tpu_torch import gluon

    trainer = gluon.Trainer(net.collect_params(), "adagrad",
                            {"learning_rate": lr})
    if plain:
        trainer._optimizer._lazy_kernel = lambda state: None
    return trainer


def mf_steps(mx, dev, net, trainer, pool, steps, check=None):
    """``steps`` steps over the pool in order (``L2Loss``, ``backward()``,
    ``trainer.step(batch)``).  Returns the losses and each step's host
    ms, from the batch's copy to the card to the step's end on the card;
    the loss's read and ``check(step, net, users, items)`` run after the
    clock stops (the gradient stays until the next backward)."""
    import torch

    from mxnet_tpu_torch import autograd, gluon

    ctx = mx.Context.from_device(dev)
    loss_fn = gluon.loss.L2Loss()
    losses, ms = [], []
    for s in range(steps):
        u, i, r = pool[s % len(pool)]
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(mx.nd.array(u, ctx=ctx),
                               mx.nd.array(i, ctx=ctx)),
                           mx.nd.array(r, ctx=ctx))
        loss.backward()
        trainer.step(len(r))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.mean().asscalar()))
        if check is not None:
            check(s, net, u, i)
    return losses, ms


def mf_path(mx, dev, smi):
    """Path A, matrix factorization: 20 eager AdaGrad steps at
    MovieLens-10M's id ranges with row-sparse gradients (the counts read
    over these steps alone), then the same 3 steps through O8 and through
    its plain version from one set of weights, and one profiled step."""
    import torch

    m = MF
    pool = mf_pool(m, SPARSE_SEED)
    mx.random.seed(SPARSE_SEED)
    net = mf_net(mx, dev, m)
    w0 = [net.user.weight.detach().clone(), net.item.weight.detach().clone()]
    rows = []

    def check(step, net, u, i):
        for name, layer, ids in (("user", net.user, u),
                                 ("item", net.item, i)):
            g = layer.weight.grad()
            want = np.unique(ids.astype(np.int64)).size
            if g.stype != "row_sparse" or g.indices.shape[0] != want:
                fail("mf: step %d's %s gradient is %s with %s rows, not "
                     "row_sparse with %d" % (step, name, g.stype,
                                             g.indices.shape, want))
            rows.append(want)

    trainer = mf_trainer(net, m["lr"])
    sparse_counts(zero=True)
    losses, ms = mf_steps(mx, dev, net, trainer, pool, m["steps"],
                          check=check)
    _, _, o8 = sparse_counts()
    first = float(np.mean(losses[:m["batches"]]))
    last = float(np.mean(losses[-m["batches"]:]))
    log("sparse mf: %d steps of %d ratings, users %d, movies %d, factor %d:"
        " loss %.6f (first epoch) -> %.6f (last), rows a step %d-%d of "
        "each table, O8 %d launches (2 a step: %d), step ms p50 %.3f "
        "(min %.3f, max %.3f) | %s"
        % (m["steps"], m["batch"], m["users"], m["movies"], m["factor"],
           first, last, min(rows), max(rows), o8, 2 * m["steps"],
           float(np.median(ms[2:])), min(ms[2:]), max(ms[2:]), smi))
    if not all(np.isfinite(losses)) or not last < 0.5 * first:
        fail("mf: the loss did not fall by half (%s)" % losses)
    if o8 != 2 * m["steps"]:
        fail("mf: O8 launched %d times in %d steps, not 2 a step"
             % (o8, m["steps"]))
    touched_u = np.unique(np.concatenate([p[0] for p in pool])
                          .astype(np.int64))
    touched_i = np.unique(np.concatenate([p[1] for p in pool])
                          .astype(np.int64))
    for name, w, w_init, touched in (
            ("user", net.user.weight, w0[0], touched_u),
            ("item", net.item.weight, w0[1], touched_i)):
        keep = torch.ones(w.shape[0], dtype=torch.bool, device=dev)
        keep[torch.from_numpy(touched).to(dev)] = False
        same = bool(torch.equal(w.detach()[keep], w_init[keep]))
        moved = not torch.equal(w.detach()[~keep], w_init[~keep])
        log("sparse mf: %s rows no id touched (%d of %d) keep their bytes: "
            "%s; touched rows moved: %s" % (name, int(keep.sum()),
                                            w.shape[0], same, moved))
        if not same or not moved:
            fail("mf: the lazy update touched rows outside the gradient, "
                 "or none")
    # the same steps through O8 and through its plain version
    start = [w.cpu().numpy() for w in w0]
    got = []
    for plain in (False, True):
        pnet = mf_net(mx, dev, m, weights=start)
        pl, _ = mf_steps(mx, dev, pnet, mf_trainer(pnet, m["lr"], plain),
                         pool, m["parity_steps"])
        got.append((pl, [pnet.user.weight.detach(),
                         pnet.item.weight.detach()]))
    err = max(float((a - b).abs().max()) for a, b in zip(got[0][1],
                                                         got[1][1]))
    scale = max(float(b.abs().max()) for b in got[1][1])
    log("sparse mf: %d steps through O8 against its plain version from one"
        " set of weights: weights max abs err %.3g (largest %.3g, tolerance"
        " 1e-5 of it: compact()'s index_add_ sums in another order), "
        "losses %s / %s" % (m["parity_steps"], err, scale, got[0][0],
                            got[1][0]))
    if not err <= 1e-5 * scale:
        fail("mf: O8's steps disagree with its plain version's")
    # where a step's time goes
    sparse_profile(lambda: mf_steps(mx, dev, net, trainer, pool[:1], 1),
                   "mf", smi)
    return {"O8": o8, "ids": np.unique(pool[0][0].astype(np.int64))}


def sparse_profile(fn, what, smi, n=4):
    """Wall ms, kernels busy ms and idle share of ``n`` profiled calls of
    ``fn`` (a step each), logged with the busiest kernels; a profile that
    holds no kernel event (CUPTI dropped it) is logged as not measured."""
    _, wall, busy, ka = profiled_step(lambda: [fn() for _ in range(n)])
    wall_ms = wall * 1e3 / n
    if busy <= 0:
        log("sparse %s: %d profiled steps: wall %.3f ms a step; kernels "
            "busy not measured (the profile holds no kernel event) | %s"
            % (what, n, wall_ms, smi))
        return
    busy /= n
    log("sparse %s: %d profiled steps: wall %.3f ms a step, kernels busy "
        "%.3f ms, idle %.1f%% | %s" % (what, n, wall_ms, busy,
                                       100 * (1 - busy / wall_ms), smi))
    sparse_top_kernels(ka, what, n)


def sparse_top_kernels(ka, what, steps, n=6):
    rows = sorted((e for e in ka if getattr(e, "device_time_total", 0) > 0),
                  key=lambda e: -e.device_time_total)[:n]
    for e in rows:
        log("sparse %s:   %-60s %8.3f ms a step, %d launches a step" % (
            what, e.key[:60], e.device_time_total / 1e3 / steps,
            e.count // steps))


def lc_write(path, c, seed):
    """The seeded libsvm file of path B: ``batch * batches`` examples, one
    nonzero (1.0) a field, field f's id Zipf-drawn within its own range;
    a label 1 where a hidden weight's sum over the row (plus noise) is
    positive.  Returns the hidden weight."""
    rs = np.random.RandomState(seed)
    n, f, d = c["batch"] * c["batches"], c["fields"], c["features"]
    ids = lc_ids(rs, c)
    hidden = rs.randn(d).astype(np.float32)
    labels = (hidden[ids].sum(1) / np.sqrt(f) + 0.3 * rs.randn(n)) > 0
    with open(path, "w") as out:
        for lab, row in zip(labels, ids):
            out.write("%d %s\n" % (lab, " ".join("%d:1" % j for j in row)))
    return hidden


def lc_ids(rs, c):
    """Path B's ids, ``batch * batches`` rows of ``fields``: field f's id
    Zipf-drawn (``zipf``) within its own range, from ``rs``."""
    n, f = c["batch"] * c["batches"], c["fields"]
    size = c["features"] // f
    ranks = np.minimum(rs.zipf(c["zipf"], size=(n, f)) - 1, size - 1)
    return np.arange(f) * size + ranks


def lc_epoch(mx, it, w, b, dot, lr):
    """One epoch of ``examples/sparse/linear_classification.py``'s loop:
    ``p = sigmoid(dot(x, w) + b)`` on each CSR batch, the log loss, and
    ``w -= lr * dot(x, p - y, transpose_a=True) / B``.  Returns w, b, the
    mean log loss and each batch's predictions."""
    it.reset()
    losses, preds = [], []
    for batch in it:
        x = batch.data[0]
        y = batch.label[0].asnumpy()
        z = dot(x, w, False).asnumpy().reshape(-1) + b
        p = 1.0 / (1.0 + np.exp(-z))
        err = (p - y).astype(np.float32)
        keep = len(y) - batch.pad
        eps = 1e-7
        losses.append(-np.mean(y[:keep] * np.log(p[:keep] + eps)
                               + (1 - y[:keep]) * np.log(1 - p[:keep] + eps)))
        gw = dot(x, mx.nd.array(err.reshape(-1, 1), ctx=w.context), True)
        w -= lr * gw / len(y)
        b -= lr * float(err.mean())
        preds.append(p)
    return w, b, float(np.mean(losses)), preds


def o7_plain(x, rhs, transpose_a):
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import sparse_ops as sops

    return NDArray._wrap(sops.csr_dot_ref(
        x.data_arr._data, x.indptr._data, x.indices._data, rhs._data,
        x.shape, transpose_a), x.context)


def lc_path(mx, dev, smi, tmp):
    """Path B, sparse linear classification at Avazu's width: the seeded
    libsvm file parsed by ``LibSVMIter`` into CSR batches on the card,
    3 epochs (the counts read over them alone), then the first epoch
    again through O7's plain version from the same zero weight, and one
    profiled batch."""
    from mxnet_tpu_torch.io import LibSVMIter
    from mxnet_tpu_torch.ndarray import sparse

    c = LC
    path = os.path.join(tmp, "avazu_width.libsvm")
    t0 = time.perf_counter()
    lc_write(path, c, SPARSE_SEED)
    t1 = time.perf_counter()
    with mx.Context.from_device(dev):
        it = LibSVMIter(data_libsvm=path, data_shape=(c["features"],),
                        batch_size=c["batch"])
    t2 = time.perf_counter()
    log("sparse lc: %d examples x %d features, %d nonzeros a row: file "
        "written in %.1f s, parsed by read_libsvm in %.1f s"
        % (it.num_examples, c["features"], c["fields"], t1 - t0, t2 - t1))
    ctx = mx.Context.from_device(dev)

    def o7(x, rhs, transpose_a):
        return sparse.dot(x, rhs, transpose_a=transpose_a)

    w, b = mx.nd.zeros((c["features"], 1), ctx=ctx), 0.0
    sparse_counts(zero=True)
    losses, first_preds = [], None
    epoch_ms = []
    for e in range(c["epochs"]):
        t0 = time.perf_counter()
        w, b, loss, preds = lc_epoch(mx, it, w, b, o7, c["lr"])
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        first_preds = first_preds or preds
    fwd, tr, _ = sparse_counts()
    n_b = c["batches"] * c["epochs"]
    log("sparse lc: log loss by epoch %s, O7 %d forward and %d transposed "
        "launches (%d each expected), epoch ms %s (%.3f ms a batch) | %s"
        % (["%.6f" % v for v in losses], fwd, tr, n_b,
           ["%.1f" % v for v in epoch_ms],
           epoch_ms[-1] / c["batches"], smi))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("lc: the log loss did not fall (%s)" % losses)
    if fwd != n_b or tr != n_b:
        fail("lc: O7 launched %d forward and %d transposed times, not %d"
             % (fwd, tr, n_b))
    _, _, _, plain_preds = lc_epoch(
        mx, it, mx.nd.zeros((c["features"], 1), ctx=ctx), 0.0, o7_plain,
        c["lr"])
    err = max(float(np.abs(a - p).max()) for a, p in zip(first_preds,
                                                         plain_preds))
    log("sparse lc: first epoch's predictions through O7 against its plain "
        "version: max abs err %.3g (tolerance 1e-5)" % err)
    if not err <= 1e-5:
        fail("lc: O7's predictions disagree with its plain version's")
    it.reset()
    batch = next(it)
    sparse_profile(lambda: lc_one(mx, batch, w, o7, c["lr"]), "lc", smi)
    return {"O7": fwd + tr, "batch": batch}


def lc_one(mx, batch, w, dot, lr):
    x = batch.data[0]
    y = batch.label[0].asnumpy()
    p = 1.0 / (1.0 + np.exp(-dot(x, w, False).asnumpy().reshape(-1)))
    gw = dot(x, mx.nd.array((p - y).astype(np.float32).reshape(-1, 1),
                            ctx=w.context), True)
    return w - lr * gw / len(y), None


def o7_bound(data, indptr, cols, shape, kdim, transpose_a):
    """O7's least time on these operands, in ms, by bytes: the values,
    column indices and indptr once, the rhs rows the product needs (those
    of the distinct columns; all m rows transposed), the output once."""
    nnz, (m, n) = data.shape[0], shape
    need = m if transpose_a else int(cols.unique().numel())
    out = n if transpose_a else m
    nbytes = 4 * nnz + 8 * nnz + 8 * (m + 1) + 4 * kdim * need \
        + 4 * kdim * out
    return 1e3 * nbytes / HBM_BYTES_PER_S


def o7_uniform_batch(dev, c, m, seed):
    """Path B's batch shape with uniform ids: ``fields`` nonzeros (1.0) a
    row, field f's id drawn uniformly within its own range, as CSR
    tensors (values, indptr, columns) on ``dev``."""
    import torch

    f, size = c["fields"], c["features"] // c["fields"]
    rs = np.random.RandomState(seed)
    ids = np.arange(f) * size + rs.randint(0, size, (m, f))
    return (torch.ones(m * f, device=dev),
            torch.arange(0, m * f + 1, f, device=dev),
            torch.from_numpy(ids.reshape(-1)).to(dev))


def o7_case(dev, batch, operands, kdim, mode, smi, g):
    """O7 on one batch in one mode against its plain version (forward:
    also two runs bitwise equal), then timed (queued behind a sleep)
    beside its bound, the plain version and ``torch.sparse.mm`` on a CSR
    tensor (cuSPARSE; a yardstick only); transposed, also the output's
    zero fill alone (``csr_dot`` of a matrix with no rows: the library's
    memset and no kernel) and the scatter as the whole call less it."""
    import torch

    from mxnet_tpu_torch.ops import sparse_ops as sops

    data, indptr, cols, shape, a, at = operands
    m, n = shape
    t = mode == "transposed"
    rhs = torch.randn(m if t else n, kdim, generator=g, device=dev)

    def o7(_):
        return sops.csr_dot(data, indptr, cols, rhs, shape, t)

    got = o7(0)
    want = sops.csr_dot_ref(data, indptr, cols, rhs, shape, t)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = err <= O7_TOL * max(scale, 1.0)
    repeat = t or bool(torch.equal(got, o7(0)))
    del got, want
    ms = queued_ms(o7, 50)
    plain_ms = queued_ms(lambda i: sops.csr_dot_ref(data, indptr, cols, rhs,
                                                    shape, t), 10)
    lib = at if t else a
    library_ms = queued_ms(lambda i: torch.sparse.mm(lib, rhs), 20)
    bound = o7_bound(data, indptr, cols, shape, kdim, t)
    row = {"batch": batch, "mode": mode, "k": kdim, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes", "library_ms": library_ms}
    split = ""
    if t:
        none = (data[:0], indptr[:1], cols[:0], rhs[:0], (0, n))
        row["fill_ms"] = queued_ms(
            lambda i: sops.csr_dot(*none, transpose_a=True), 50)
        row["scatter_ms"] = ms - row["fill_ms"]
        split = "; the zero fill alone %.4f ms, the scatter (the call " \
            "less the fill) %.4f ms" % (row["fill_ms"], row["scatter_ms"])
    else:
        row["bitwise_repeatable"] = repeat
    log("sparse o7 %-10s %-7s %d x %d, %d nonzeros, K %d: max abs err %.3g "
        "(largest %.3g, tolerance %g of it) %s%s; %.4f ms, bound %.4f ms "
        "(bytes, %.1f%%), plain %.4f ms, torch.sparse.mm %.4f ms%s | %s"
        % (mode, batch, m, n, data.shape[0], kdim, err, scale, O7_TOL,
           "ok" if ok else "FAIL", "" if t else
           ", two runs bitwise equal: %s" % repeat, ms, bound,
           100 * bound / ms, plain_ms, library_ms, split, smi))
    if not ok:
        fail("O7 (%s, %s, K %d) disagrees with its plain version"
             % (mode, batch, kdim))
    if not repeat:
        fail("O7's forward (%s, K %d) is not bitwise repeatable"
             % (batch, kdim))
    return row


def o7_checks(dev, batch, smi):
    """O7 in both modes at path B's batch (Zipf ids) and at a batch of the
    same shape with uniform ids, at K 1 and 128 (``o7_case`` each).
    Returns the Zipf batch's K 1 readings by mode, and every row."""
    import torch

    x = batch.data[0]
    g = torch.Generator(device=dev)
    g.manual_seed(SPARSE_SEED)
    batches = {"zipf": (x.data_arr._data, x.indptr._data, x.indices._data),
               "uniform": o7_uniform_batch(dev, LC, x.shape[0],
                                           SPARSE_SEED + 1)}
    rows = []
    for name, (data, indptr, cols) in batches.items():
        a = torch.sparse_csr_tensor(indptr, cols, data, size=x.shape)
        at = a.to_sparse_coo().t().coalesce().to_sparse_csr()
        operands = (data, indptr, cols, tuple(x.shape), a, at)
        for kdim in (1, 128):
            for mode in ("forward", "transposed"):
                rows.append(o7_case(dev, name, operands, kdim, mode, smi, g))
                torch.cuda.empty_cache()
    out = {r["mode"]: r for r in rows if r["batch"] == "zipf"
           and r["k"] == 1}
    zipf_t, uni_t = (next(r["ms"] for r in rows if r["batch"] == b and
                          r["k"] == 1 and r["mode"] == "transposed")
                     for b in ("zipf", "uniform"))
    log("sparse o7: transposed at K 1, Zipf ids %.4f ms against uniform "
        "%.4f ms (%.2fx) | %s" % (zipf_t, uni_t, zipf_t / uni_t, smi))
    out["at"] = rows
    return out


def o8_case(dev, route, n, c, ids, seed):
    """An optimizer of ``route`` and its inputs: a weight (n, c), its
    state, gradient rows at ``ids``, the device scalars, the optimizer's
    step on gathered rows in plain torch (O8's plain version runs it; it
    launches neither O1 nor O2) and O8's keyword arguments."""
    import torch

    from mxnet_tpu_torch import optimizer

    opt = {"sgd": lambda: optimizer.SGD(learning_rate=0.1, wd=1e-4,
                                        clip_gradient=5.0),
           "sgd_mom": lambda: optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                            wd=1e-4),
           "adam": lambda: optimizer.Adam(learning_rate=1e-3, wd=1e-4,
                                          rescale_grad=0.5),
           "adagrad": lambda: optimizer.AdaGrad(learning_rate=1.0)}[route]()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = torch.randn(n, c, generator=g, device=dev)
    state = opt.create_state(0, w)
    for s in (state if isinstance(state, tuple) else (state,)):
        if s is not None:
            s.copy_(torch.rand(n, c, generator=g, device=dev))
    vals = torch.randn(len(ids), c, generator=g, device=dev)
    idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    lr = torch.full((), opt.learning_rate, dtype=torch.float32, device=dev)
    t = torch.full((), 3, dtype=torch.int32, device=dev)
    name, consts = opt._lazy_kernel(state)
    if name != route:
        fail("o8_case: %s takes O8's route %s, not %s"
             % (type(opt).__name__, name, route))

    def step(wr, gr, sr):
        opt._step_multi([wr], [gr], [sr], lr, [opt.wd], t, [1.0],
                        plain=True)

    kw = dict(lr=lr, t=t, wd=opt.wd, rescale=opt.rescale_grad,
              clip=opt._clip(), **consts)
    return opt, w, state, idx, vals, lr, t, step, kw


def _clone_state(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(s.clone() for s in state)
    return state.clone()


def o8_checks(dev, ids, smi):
    """O8's routes at path A's shapes (the user table, the first batch's
    distinct ids) against its plain version, an empty gradient, then each
    timed (queued behind a sleep) beside its bound, the plain version
    and torch's own sparse optimizer step on a coalesced COO gradient
    (``SGD``, ``SparseAdam``, ``Adagrad``: other functions over the same
    bytes, eps placed their way; yardsticks only)."""
    import torch

    from mxnet_tpu_torch.ops import sparse_ops as sops

    from mxnet_tpu_torch.ops import optimizer_ops as oops

    n, c = MF["users"], MF["factor"]
    out = {}
    arrays = {"sgd": 3, "sgd_mom": 5, "adam": 7, "adagrad": 5}
    for k, route in enumerate(("sgd", "sgd_mom", "adam", "adagrad")):
        opt, w, state, idx, vals, lr, t, step, kw = o8_case(
            dev, route, n, c, ids, SPARSE_SEED + k)
        w1, s1 = w.clone(), _clone_state(state)
        w2, s2 = w.clone(), _clone_state(state)
        before = sops.rsp_lazy_update.launches
        sops.rsp_lazy_update(w1, idx, vals, s1, route, step, **kw)
        held = (oops.multi_sgd.launches, oops.multi_adamw.launches)
        sops.rsp_lazy_update_ref(w2, idx, vals, s2, step)
        if (oops.multi_sgd.launches, oops.multi_adamw.launches) != held:
            fail("O8's plain version (%s) launched O1 or O2" % route)
        pairs = [(w1, w2)] + list(zip(sops._leaves(s1), sops._leaves(s2)))
        err = max(float((a - b).abs().max()) for a, b in pairs)
        scale = max(float(b.abs().max()) for _, b in pairs)
        untouched = torch.ones(n, dtype=torch.bool, device=dev)
        untouched[idx] = False
        same = bool(torch.equal(w1[untouched], w[untouched]))
        empty = w.clone()
        sops.rsp_lazy_update(empty, idx[:0], vals[:0],
                             _clone_state(state), route, step, **kw)
        launched = sops.rsp_lazy_update.launches - before
        ok = err <= O8_TOL * scale and same and torch.equal(empty, w) \
            and launched == 1
        ms = queued_ms(lambda i: sops.rsp_lazy_update(
            w1, idx, vals, s1, route, step, **kw), 50)
        plain_ms = queued_ms(lambda i: sops.rsp_lazy_update_ref(
            w2, idx, vals, s2, step), 20)
        p = torch.nn.Parameter(w.clone())
        lib = {"sgd": lambda: torch.optim.SGD([p], lr=0.1),
               "sgd_mom": lambda: torch.optim.SGD([p], lr=0.1, momentum=0.9),
               "adam": lambda: torch.optim.SparseAdam([p], lr=1e-3),
               "adagrad": lambda: torch.optim.Adagrad([p], lr=1.0)}[route]()
        p.grad = torch.sparse_coo_tensor(idx[None], vals, (n, c)).coalesce()
        library_ms = queued_ms(lambda i: lib.step(), 50)
        nbytes = arrays[route] * len(ids) * c * 4 + 8 * len(ids)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        log("sparse o8 %-8s %d of %d rows x %d: max abs err %.3g (largest "
            "%.3g, tolerance %g of it), untouched rows kept %s, U = 0 a "
            "no-op %s, %s; %.4f ms, bound %.4f ms (bytes, %.1f%%), plain "
            "%.4f ms, torch.optim %s %.4f ms | %s"
            % (route, len(ids), n, c, err, scale, O8_TOL, same,
               torch.equal(empty, w), "ok" if ok else "FAIL", ms, bound,
               100 * bound / ms, plain_ms, type(lib).__name__, library_ms,
               smi))
        if not ok:
            fail("O8 (%s) disagrees with its plain version" % route)
        out[route] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": "bytes",
                      "library_ms": library_ms,
                      "library": "torch.optim.%s" % type(lib).__name__}
    return out


def sparse_phase(dev):
    """Path A (MF, O8) and path B (linear classification, O7), then O7's
    and O8's checks and timing.  Returns the launches and the readings."""
    import torch

    import mxnet_tpu_torch as mx

    start_profiler(dev)
    smi = nvidia_smi_line()
    with mx.Context.from_device(dev):
        mf = mf_path(mx, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            lc = lc_path(mx, dev, smi, tmp)
        o7 = o7_checks(dev, lc["batch"], smi)
        o8 = o8_checks(dev, mf["ids"], smi)
    return {"O7": lc["O7"], "O8": mf["O8"]}, o7, o8


def clocks_line():
    """The card's SM clock and its maximum now (nvidia-smi)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    out = r.stdout.strip().splitlines()
    return "clocks.sm, clocks.max.sm: %s" % (out[0] if out else
                                             "not read (%s)" % r.stderr.strip())


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail("nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


PHASES = ("kernel", "flash", "optimizer", "serve", "parity", "fleet",
          "train", "train_parity", "hybridize", "rtc", "imperative",
          "imperative_parity", "resnet", "bert", "gluon", "np", "vision",
          "gan", "ssd", "quant", "ops", "sparse")
# the phases that launch K1-K4 and O1-O8, whose libraries the smoke
# builds first
NVCC_PHASES = {"kernel", "flash", "optimizer", "serve", "parity", "fleet",
               "train", "train_parity", "hybridize", "resnet", "bert",
               "gluon", "np", "vision", "gan", "ssd", "quant", "ops",
               "sparse"}


def kernel_entry(name, source, replaces, launches, timing, extra=None):
    """One kernel's entry of the ``kernels`` line; ``extra`` adds fields
    (K1-K3's readings at BERT's shape, O1's check on BERT-base's list)."""
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
                 "plain_ms": timing["plain_ms"],
                 "bound_ms": timing["bound_ms"],
                 "bound_by": timing["bound_by"],
                 "library_ms": timing["library_ms"]}, **(extra or {}))


def main(argv):
    """``argv[0]``, when given, is a comma-separated subset of PHASES to
    run (for work on one phase); the result lines print only when every
    phase ran."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "smoke needs an NVIDIA card", file=sys.stderr)
        return 2
    if argv and argv[0] == "vision-child":
        return vision_child(*argv[1:3])
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import box_nms
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import int8_ops
    from mxnet_tpu_torch.ops import optimizer_ops as oo
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.ops import sparse_ops

    phases = argv[0].split(",") if argv else list(PHASES)
    if set(phases) - set(PHASES):
        print("chip_smoke: unknown phase in %s (phases: %s)"
              % (phases, ",".join(PHASES)), file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log("card: %s | torch %s, CUDA %s, python %s"
        % (smi, torch.__version__, torch.version.cuda,
           sys.version.split()[0]))
    t_all = time.perf_counter()

    # K4 with split 1 left out of its combine: the planted fault
    drop_split = (pa._SOURCE, ("MXTT_DROP_SPLIT=1",))
    # O1-O3 with each table's last tensor left out: the planted fault
    skip_last = (oo._SOURCE, ("MXTT_SKIP_LAST=1",))
    # O5/O6 with the K loop's last tile left out: the planted fault
    skip_k_tile = (int8_ops._SOURCE, ("MXTT_SKIP_LAST=1",))
    if set(phases) & NVCC_PHASES:
        built = _build.build_all([fa._SOURCE, pa._SOURCE, drop_split,
                                  oo._SOURCE, skip_last, box_nms._SOURCE,
                                  int8_ops._SOURCE, skip_k_tile,
                                  sparse_ops._SOURCE],
                                 verbose=True)
        for lib, seconds in built.values():
            log("build: %s ready after %.1f s"
                % (os.path.relpath(lib, REPO), seconds))

    def timed(name, fn, *args):
        if name in phases:
            log("%s phase: start, %s" % (name, clocks_line()))
        t0 = time.perf_counter()
        out = fn(*args) if name in phases else None
        if name in phases:
            gc.collect()
            torch.cuda.empty_cache()
            log("%s phase: %.1f s" % (name, time.perf_counter() - t0))
        return out

    def kernel_phase():
        kernel_checks(pa, dev)
        keep = split_checks(pa, dev)
        for name, case in keep:
            reading = planted_split_fault(pa, built[drop_split][0], case)
            log("kernel split: a combine that drops split 1 reads %.2f on "
                "%s (must be > 1)" % (reading, name))
            if reading <= 1:
                fail("the K4 check passes a combine that drops a split "
                     "(%s)" % name)
        return kernel_timing(pa, dev)

    def flash_phase():
        flash_checks(fa, dev)
        return flash_timing(fa, dev), flash_bert_shape(fa, dev)

    k4 = timed("kernel", kernel_phase)
    flash = timed("flash", flash_phase)
    opt = timed("optimizer", lambda: optimizer_phase(
        oo, dev, built[skip_last][0]))
    k4_launches = timed("serve", serve_main_path, serve, pa, dev)
    timed("parity", parity, serve, dev)
    fleet_launches = timed("fleet", fleet_phase, serve, pa, dev)
    def train_phase():
        train_graph_check(dev)
        return train_main_path(fa, dev)

    flash_launches = timed("train", train_phase)
    timed("train_parity", train_parity, dev)
    hybrid_launches = timed("hybridize", hybridize_phase, fa, dev)
    k5 = timed("rtc", rtc_phase, mx, dev)
    k5_launches = timed("imperative", imperative_main_path, mx, dev)
    timed("imperative_parity", imperative_parity, mx, dev)
    resnet_o2 = timed("resnet", resnet_phase, dev)
    bert_launches, bert_o1_err = timed("bert", bert_phase, dev) \
        or (None, None)
    gluon_launches = timed("gluon", gluon_phase, dev)
    np_launches = timed("np", np_phase, dev)
    vision_o2 = timed("vision", vision_phase, dev)
    gan_o1 = timed("gan", gan_phase, mx, dev)
    o4, ssd_o1, o4_launches = timed("ssd", ssd_phase, mx, dev) \
        or (None, None, None)
    int8_launches, o6, o5 = timed(
        "quant", lambda: quant_phase(dev, built[skip_k_tile][0])) \
        or (None, None, None)
    timed("ops", ops_phase, mx, dev)
    sparse_launches, o7, o8 = timed("sparse", sparse_phase, dev) \
        or (None, None, None)
    log("total: %.1f s" % (time.perf_counter() - t_all))
    if list(phases) != list(PHASES):
        log("ran phases %s only: no result lines" % ",".join(phases))
        return 0

    src = "mxnet_tpu_torch/csrc/flash_attention.cu"
    opt_src = "mxnet_tpu_torch/csrc/optimizer_ops.cu"
    int8_src = "mxnet_tpu_torch/csrc/int8_ops.cu"
    sparse_src = "mxnet_tpu_torch/csrc/sparse_ops.cu"
    flash, flash_bert = flash
    paths = (flash_launches, hybrid_launches, bert_launches, gluon_launches,
             np_launches)
    print(json.dumps({"kernels": [
        kernel_entry("K1 flash_fwd", src,
                     "mxnet_tpu/ops/pallas_kernels.py:83",
                     sum(p["fwd_launches"] for p in paths), flash["K1"],
                     flash_bert["K1"]),
        kernel_entry("K2 flash_bwd_dq", src,
                     "mxnet_tpu/ops/pallas_kernels.py:166",
                     sum(p["dq_launches"] for p in paths), flash["K2"],
                     flash_bert["K2"]),
        kernel_entry("K3 flash_bwd_dkv", src,
                     "mxnet_tpu/ops/pallas_kernels.py:208",
                     sum(p["dkv_launches"] for p in paths), flash["K3"],
                     flash_bert["K3"]),
        kernel_entry("K4 paged_attention",
                     "mxnet_tpu_torch/csrc/paged_attention.cu",
                     "mxnet_tpu/ops/paged_attention.py:80",
                     k4_launches + fleet_launches, k4)] + [
        kernel_entry("K5 rtc %s (user kernel, NVRTC)" % k5_launches[w][0],
                     "chip_smoke.py", "mxnet_tpu/rtc.py:43",
                     k5_launches[w][1], k5[w])
        for w in ("fwd", "bwd")] + [
        # port-only kernels: no Pallas kernel stands behind them; each is
        # the counterpart of a registered op of the JAX package
        kernel_entry("O1 multi_adamw (port-only)", opt_src,
                     "mxnet_tpu/ops/optimizer_ops.py:479",
                     sum(p["O1"] for p in paths) + gan_o1 + ssd_o1,
                     opt["O1"], {"bert_max_abs_err": bert_o1_err}),
        kernel_entry("O2 multi_sgd (port-only)", opt_src,
                     "mxnet_tpu/ops/optimizer_ops.py:314",
                     resnet_o2 + vision_o2, opt["O2"]),
        kernel_entry("O3 multi_sum_sq (port-only)", opt_src,
                     "mxnet_tpu/ops/optimizer_ops.py:174",
                     flash_launches["O3"] + gluon_launches["O3"]
                     + np_launches["O3"],
                     opt["O3"]),
        kernel_entry("O4 box_nms (port-only)",
                     "mxnet_tpu_torch/csrc/box_nms.cu",
                     "mxnet_tpu/ops/contrib.py:85", o4_launches, o4,
                     {k: o4[k] for k in (
                         "library", "decode_ms", "decode_plain_ms",
                         "nms_route", "two_pass_ms", "mask_pass_ms",
                         "scan_ms")}),
        kernel_entry("O5 int8_gemm (port-only)", int8_src,
                     "mxnet_tpu/ops/quantized_ops.py:88",
                     int8_launches["O5"], o5[0],
                     {"shape_mkn": o5[0]["shape"], "library": "torch._int_mm",
                      "f32_mode_ms": o5[0]["f32_mode_ms"],
                      "f32_mode_bound_ms": o5[0]["f32_mode_bound_ms"],
                      "at": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "library_ms", "f32_mode_ms",
                                                "f32_mode_bound_ms")}
                             for r in o5[1:]]}),
        kernel_entry("O6 int8_conv (port-only)", int8_src,
                     "mxnet_tpu/ops/quantized_ops.py:109",
                     int8_launches["O6"], o6,
                     {k: o6[k] for k in ("cudnn_bf16_ms", "quantize_ms",
                                         "quantize_bound_ms", "f32_mode_ms",
                                         "f32_mode_bound_ms")}),
        kernel_entry("O7 csr_dot (port-only)", sparse_src,
                     "mxnet_tpu/ndarray/sparse.py:408", sparse_launches["O7"],
                     o7["forward"], {"shape": "8192 x 1000001, 22 a row, K 1",
                                     "library": "torch.sparse.mm (cuSPARSE)",
                                     "transposed": o7["transposed"],
                                     "at": o7["at"]}),
        kernel_entry("O8 rsp_lazy_update (port-only)", sparse_src,
                     "mxnet_tpu/optimizer/optimizer.py:170",
                     sparse_launches["O8"], o8["adagrad"],
                     {"optimizer": "adagrad",
                      "library": o8["adagrad"]["library"],
                      "routes": {r: o8[r] for r in ("sgd", "sgd_mom",
                                                    "adam")}})]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
