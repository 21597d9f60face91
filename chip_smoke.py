"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc/`` (one nvcc a
source, started together), holds each against its plain PyTorch version
on the card (forward, and the gradient
the training path takes through it), then drives the full-width
TransformerLM (vocab 32768, dim 768, 12 layers, 12 heads, T up to 1024;
random weights from a seed) down both of the port's paths: served through
``serving.ModelServer``, and trained with ``gluon.Trainer`` and Adam.  Each
path must go through the kernel and agree with the same model on the CPU.
Then it trains ResNet-50 v1 at full width (224 x 224, batch 32, 1000
classes, fp32) through the example's ``fit_gluon`` loop
(``models/image_classification.py``: SGD, momentum 0.9, wd 1e-4) in both
layouts, profiles a step and holds a small copy against the CPU.  That path
launches no hand kernel: the JAX package's convolution, pooling and
BatchNorm are XLA ops, not Pallas kernels, and the port runs them as
PyTorch's (cuDNN) ops.  Both models then train again in bf16, as the JAX
package trains them: the LM cast to bf16 with ``Adam(multi_precision)``,
its attention in the kernel's bf16 path (``lm_bf16_*``), and ResNet-50
through ``fit_gluon --dtype bfloat16`` in both layouts and with
``multi_precision`` (``resnet_bf16_*``), each profiled and held against
the CPU in bf16.  TF32 stays off but in the TF32 controls of the fp32
``*_vs_cpu`` phases.  Then Gluon's parameter model: ``mx.random.seed``
gives the same weights on the card as on the CPU (``seeded_init``, which
are the JAX package's), the LM's forward through
``gluon.block.functional_call`` launches the kernel once a layer and
equals the module call (``lm_functional``), a model trained on the card
round-trips through a ``.params`` file (``params_io``), and bench.py's
headline step (ResNet-50 v1, B = 32, bf16 inside the loss, fp32 aux, SGD
with momentum 0.9 and lr 0.05) runs through ``functional_call`` and
``torch.autograd`` in both layouts (``functional_step``), held against the
Gluon path on the card (``functional_vs_gluon``) and against the CPU in
fp32 (``functional_vs_cpu``).  The ResNet fits run seeded and shuffled.
Then MXNet's compiled half, where a ``CachedOp`` captures a forward into a
CUDA graph per input signature and replays it: the serving registry is
CachedOp-backed (``hybrid_serve``: one capture a signature at warmup, none
under traffic, logits bit-equal to the eager block's), the LM and
ResNet-50 train hybridized with losses and weights bit-equal to eager
(``hybrid_lm_train``, ``hybrid_resnet_train``, ``hybrid_resnet_bf16_train``),
``CompiledTrainStep`` captures ResNet-50's whole bf16 step, update and
device-side accuracy included, one window of batches a graph
(``compiled_step``), and ``models/train_mnist.py``'s LeNet trains through
``mx.sym`` and ``Module.fit``, compiled and eager (``module_fit``).  A
replay calls no kernel wrapper, so a graphed path's launches are its eager
warm-up runs' (counted by the wrapper) plus its replays times the kernels
torch.profiler sees in one replay.  Last, the decode engine
(``serving/decode``) serves a TinyCausalLM at the bench LM's widths token
by token: 64 greedy streams through continuous batching attached to a
ModelServer (``decode_serve``, with one replayed decode step profiled:
no copy of a KV pool), the same traffic in static batches
(``decode_static``), a sampled stream moved between engines mid-stream
(``decode_handoff``), chunked prefill with the prefix cache and
speculative decoding (``decode_prefix_spec``), and a 2-layer copy against
the CPU (``decode_vs_cpu``).  Its attention is plain torch ops, as the
JAX package's is jnp: flash_attention launches 0 times there.  Then the
saved-model phases (``exported_*``), and the serving tier: the full-width
LM behind a ``FleetRouter`` of two ModelServers, one killed under load
and a joining one re-warmed (``fleet_serve``, through the kernel); a
decode fleet drained mid-traffic, its streams handed off
(``fleet_decode``); the disaggregated prefill/decode pair against a
colocated fleet under open-loop arrivals (``disagg``); and a live weight
swap from manifest-committed checkpoints by a ``DeploymentController``
(``deploy``).  Last, the random draws, Dropout and the zoo: 16M draws on
the card bit-equal to the CPU's and numpy's (``rng_bits``); the
word-language-model Transformer at the bench LM's widths trained with
Dropout 0.1, eagerly (``word_lm_train``, ``word_lm_profile``: the
Dropout share of the device time) and hybridized (``word_lm_hybrid``),
and a depth-2 copy against the CPU with bit-equal masks
(``word_lm_vs_cpu``); VGG-16 through ``image_classification.main``
(``vgg16_fit``, ``vgg16_profile``); ``benchmark_score`` for AlexNet,
VGG-16, Inception v3 and ResNet-50 v1 at batch 32 (``zoo_score``); and
ten zoo families on the card against the CPU (``zoo_vs_cpu``).  Then
the optimizers, their state files and crash resume (``optim_resume_*``).
Last, int8 inference: bench.py's int8 ResNet-50 at full width (export,
``load_checkpoint``, ``quantize_model`` with minmax calibration on one
batch of 32, ``simple_bind``, forward) against the same fp32 graph, with
its images/s, device time by kind and peak memory (``int8_resnet50``);
the eight quantized ops card = CPU bit for bit (``quantized_ops_vs_cpu``);
a small quantized ResNet-18 on the card and the CPU (``int8_vs_cpu``);
and ``models/quantize_infer.py`` (``quantize_infer``).  Its int8 products
are cuBLASLt's int8 GEMM (``torch._int_mm``), as the JAX package's are
XLA int8 dots: no hand kernel, and flash_attention launches 0 times there.
Then the input pipeline (``input_phases``): a probe of PIL and
``jpeglib.h`` (without libjpeg the native decode pipeline does not build
and the script says so on a line of its own); ResNet-50 v1 at 224 x 224,
B = 32, fp32 trained from a RecordIO file of 320 seeded images packed by
``recordio.pack_img``, in four ways over one seeded net: a pre-staged
batch, ``train_imagenet.py``'s ``ImageRecordIterator`` read inline, the
same behind ``PrefetchingIter(ctx=card)``, and a ``DataLoader`` with
worker processes and ``prefetch_to_device``, each FEED_EPOCHS epochs in
turn (``feed_resnet50``: median img/s with its spread, overlap, speedup,
decode ms, each step's host ms, the feed's h2d and starved ms, peak
memory, the device's idle share over the e2e epoch from a traced one),
``image_classification.main --data-train``, and
``Module.fit(prefetch_to_device=card)`` on the compiled step over the
native NHWC uint8 pipeline, or the Python one without libjpeg (every batch
in file order, one capture); the device feed on the card
(``feed_card_checks``: staging and a fed SGD step bitwise, 200 fed
batches none overwritten with ``record_stream``, against a control
without it, a CachedOp capture during which the feed thread stages
batches, a CUDA dataset
refused by worker processes, native decode against PIL's); and
``train_mnist.py`` over 60,000 seeded idx images through ``MNISTIter``
and the feed (``mnist_idx``).  No hand kernel runs there either.  Last,
the recurrent models (``rnn_phases``): ``models/lstm_bucketing.py`` at the
upstream example's widths (2 x 200 LSTM, embed 200, vocab 10,000, B = 32,
buckets 10-60) through ``BucketingModule.fit``, over the ``RNN`` op
(``lstm_bucketing``) and over ``LSTMCell``s (``lstm_bucketing_unfused``),
with the step of each bucket, launches a step and peak memory; the ``RNN``
op's four modes and its dropout masks card against CPU, and the first
bucketing updates (``rnn_vs_cpu``); and ``gluon.rnn.LSTM`` eager and
hybridized beside ``torch.nn.LSTM`` on the same weights (``gluon_lstm``).
The reference's RNN is a ``lax.scan`` of jnp ops, not a Pallas kernel:
flash_attention launches 0 times there (``launches_rnn``).  Last, object
detection (``detection_phases``): ``models/ssd.py``'s ``main`` at
VGG-16 / 300 x 300, 20 classes, B = 32 (7,096 anchors), Adam, mining 3:1,
the loss falling over 2 epochs, a detection kept, the mAP before and
after, then timed steps, a forward's breakdown and the NMS scan on a
held-out batch's masks (``ssd_vgg16``); ``models/rcnn.py``'s ``main``
(``rcnn_example``); Faster R-CNN's proposal layer at 600 x 1000 (20,646
boxes, 6,000 into NMS 0.7, 300 out), ``ROIPooling`` and ``ROIAlign``
7 x 7 over its rois, against the CPU (``rcnn_ops_full``); and the 17
detection and spatial ops card against CPU (``detection_ops_vs_cpu``).
The reference's greedy NMS is a ``lax.fori_loop``, not Pallas; here its
scan is the hand-written ``csrc/greedy_nms.cu`` (the ``kernels`` line's
``greedy_nms``: launches on each path, time at the SSD's and Proposal's
sizes, bit-equal to its plain loop on their masks).

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (``nvcc``); imports no JAX and
nothing of the JAX package.  Prints one line per phase, then a JSON line of
per-kernel numbers, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero without
that line.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import random
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# full width of the bench configuration (bench.py _measure_transformer)
VOCAB, DIM, HEADS, DEPTH, MAX_LEN = 32768, 768, 12, 12, 1024
SERVE_LENGTHS = (128, 1024)
LADDER = (1, 2, 4, 8)
FP32_BOUND = 2e-5     # tests/test_pallas.py's bound for the kernel in fp32
BF16_BOUND = 1e-2     # bf16 output rounding (8-bit mantissa) on O(1) values
SERVE_ATOL = SERVE_RTOL = 1e-3   # card vs CPU logits: fp32 sums reordered
ARGMAX_AGREE = 0.99
GRAD_BOUND = 1e-3     # tests/test_pallas.py::test_flash_attention_grad
TRAIN_B, TRAIN_STEPS, TRAIN_LR = 8, 5, 3e-3   # bench.py's batch, Adam's lr
# card vs CPU training at full width, depth cut to 2: (depth, B, T, steps)
VS_CPU = (2, 2, 256, 3)
# step-1 gradients, card vs CPU: the largest per-leaf |a - b| / |b|.  An
# H100 read 4.9e-4 in fp32 (pos.weight; median leaf 8.5e-7) and 4.8e-3
# with TF32 GEMMs (the phase's control)
GRAD_REL_BOUND = 1e-3
# ResNet-50 v1 training at the example's defaults (common.py): batch, image
# side, steps (one warm, the rest timed)
RESNET_B, RESNET_SIZE, RESNET_STEPS = 32, 224, 6
# card vs CPU, the same Xavier weights: (batch, image side, steps).  Its
# last stage normalizes 8 values a channel, and ResNet-50 v1's fp32 step is
# ill-conditioned there: two fp32 CPU implementations' step-1 gradients lie
# up to 3% of a leaf's norm apart (tests/test_torch_resnet.py), and the
# example's lr 0.1 takes the loss from 7.5 to ~120 in one step.  Bounds
# between an H100's fp32 reading and its TF32 control (cuDNN and GEMMs):
# step-1 logits, max abs: 3.5e-4 in fp32, 0.32 with TF32
RESNET_LOGIT_BOUND = 2e-3
# step-1 gradient, worst leaf ||a - b|| / ||b||: 0.023 in fp32, 0.88 TF32
RESNET_GRAD_REL_BOUND = 0.1
# parameters and running stats after 3 steps, the median array's
# ||a - b|| / ||b||: 0.14 in fp32, 0.59 TF32 (the worst array, 2.1 and
# 1.2, does not tell them apart: the steps after the first amplify)
RESNET_AFTER_MEDIAN_BOUND = 0.3
RESNET_VS_CPU = (2, 64, 3)
# bf16 on the card against bf16 on the CPU, the same runs cut as above,
# with two controls: the same run in fp32, and in bf16 from weights one
# bf16 step away from zero (a rounding fault of bf16's own size, biased).
# ResNet-50 v1's bf16 training step from Xavier weights is chaotic at any
# size a CPU can run: rounding the weights and input to bf16 moves its
# step-1 logits by a tenth of their range and its gradients by more than
# their norm, so the training readings and both controls land together
# (an H100 read logits 1.58 apart, the controls 1.60 and 1.87) and no bound
# can sit between them.  The held number is the logits of the starting
# weights in inference mode (running statistics), which bf16 perturbs
# smoothly; bound between the reading and the step control
RESNET_BF16_PREDICT_BOUND = 5e-3
# the LM's step-1 gradients, worst leaf ||a - b|| / ||b||: an H100 read
# 0.0189 (tok.weight); the fp32 control 0.0204, the step control 0.0286
LM_BF16_GRAD_REL_BOUND = 0.024
# the decode engine at the bench LM's widths (serving/decode): the model,
# the engine (table width 41 blocks, 8 x 41 + 1 = 329 blocks a pool), the
# traffic (streams, prompt lengths, new tokens) and the streams held
# against generate_reference
DEC_MODEL = dict(vocab_size=VOCAB, hidden=DIM, num_layers=DEPTH,
                 num_heads=HEADS, max_len=MAX_LEN)
DEC_ENGINE = dict(max_slots=8, block_size=16, max_prompt_len=512,
                  max_new_tokens=128, max_queue=256)
DEC_TRAFFIC = (64, (16, 512), (32, 128))
DEC_FIXED = 8
# chunked prefill + prefix cache + speculation; its traffic: streams, the
# shared prefix's length, suffix lengths, new tokens
DEC_SPEC = dict(prefill_chunk=64, prefix_cache=True, spec_k=3)
DEC_SPEC_TRAFFIC = (32, 256, (1, 256), (32, 128))
DEC_DRAFT_LAYERS = 2
# card vs CPU: layers, greedy streams; logits within this many times the
# CPU fp32 run's own distance from an fp64 run
DEC_VS_CPU = (2, 4)
DEC_FP64_FACTOR = 4.0
# the saved-model phases: the exported ResNet's batch ladder and its
# requests (one at a time, so each is a batch of 1); the exported decode
# model (TinyGluonLM at the bench widths, depth cut), its engine and its
# greedy traffic (streams, prompt lengths, new tokens)
EXP_RESNET_LADDER = (1, 2, 4, 8, 16, 32)
EXP_RESNET_REQUESTS = 8
EXP_DEC_LAYERS = 2
EXP_DEC_ENGINE = dict(max_slots=8, block_size=16, max_prompt_len=128,
                      max_new_tokens=32, max_queue=64)
EXP_DEC_TRAFFIC = (16, (8, 128), (8, 32))
# the serving tier: fleet_serve's replicas, the answers after which one
# of them is killed and the requests sent again after the join;
# fleet_decode's streams (DEC_TRAFFIC's ranges); the
# disaggregated pair's arrivals, prefill chunk, tenant mix and the SLOs of
# tools/serve_bench.py's disagg profile (TTFT, TPOT ms; :1874-1877);
# deploy's arrivals, the arrival at which the controller polls, and its
# traffic's ranges (prompt lengths, new tokens); the sampled streams'
# settings (every 4th stream, each with a seed of its own)
FLEET_REPLICAS = 2
FLEET_KILL_AFTER = 6
FLEET_PROBES = 4
FLEET_DEC_STREAMS = 32
DISAGG_ARRIVALS = 32
DISAGG_CHUNK = 64
DISAGG_TENANTS = {"free": 1, "paid": 3}
DISAGG_SLO_MS = (250.0, 150.0)
DEPLOY_ARRIVALS = 48
DEPLOY_AT = 10
DEPLOY_TRAFFIC = ((16, 256), (16, 64))
SAMPLED = dict(temperature=0.8, top_k=64, top_p=0.95)

# published peaks by card (NVIDIA data sheets, dense): fp32 on CUDA cores,
# TF32 and bf16 on tensor cores in FLOP/s, memory bandwidth in bytes/s
PEAKS = {"H100 PCIe": (51.2e12, 378e12, 756e12, 2.0e12),
         "H100 NVL": (60e12, 417.5e12, 835e12, 3.9e12),
         "H100": (67e12, 495e12, 989e12, 3.35e12)}
TIMED_CALLS = 10   # back-to-back calls between one pair of CUDA events
BQ, BK = 64, 64    # the kernel's query rows a block and keys a K/V tile


def phase(label, **fields):
    print("[%s] %s" % (label, " ".join("%s=%s" % kv for kv in fields.items())),
          flush=True)


def fail(msg):
    print("FAIL: %s" % msg, flush=True)
    sys.exit(1)


# eager results the graphed phases reproduce: phase label -> (losses,
# median step ms, ..., final state by structural name)
REFS = {}


def median_of(step_ms):
    return float(np.median(step_ms[1:]))


def reset_launches(cuda_ops):
    """Set the kernel's launch counts, in all and by dtype, to 0."""
    cuda_ops.flash_attention.launches = 0
    for dtype in cuda_ops.flash_attention.launches_by_dtype:
        cuda_ops.flash_attention.launches_by_dtype[dtype] = 0


def card_peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    fail("no published peaks for card %r" % name)


def time_ms(fn, reps=20, calls=TIMED_CALLS):
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls of ``fn``, divided by ``calls``, after two warm calls.  The calls
    queue behind each other, so the host's time per call (the ctypes
    wrapper's tens of microseconds) does not leave the card idle inside the
    window as it would around a single call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def build_report(_kernels):
    """Phase 1: build the kernels, one nvcc a source started together;
    print ptxas's registers and spills of each kernel instance (and the
    attention kernel's dynamic shared memory), and count the tensor-core
    (HMMA) instructions in the attention library's SASS; fails if there
    are none."""
    t0 = time.time()
    built = _kernels.build_all()   # one nvcc a source, started together
    seconds = round(time.time() - t0, 2)
    phase("build_all", seconds=seconds,
          **{"%s_s" % k: round(v, 2) for k, v in sorted(built.items())})
    nms_report(_kernels)
    instances = ptxas_report(_kernels.build_log())
    if not instances:
        fail("no ptxas report in the build log")
    cuobjdump = str(Path(_kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_kernels.library_path())],
                          capture_output=True, text=True, check=True).stdout
    hmma, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
        elif "HMMA" in line and func is not None:
            hmma[func] = hmma.get(func, 0) + 1
    phase("build", source="mxnet_tpu_torch/csrc/flash_attention.cu",
          seconds=seconds, instances=len(instances),
          hmma=sum(hmma.values()))
    for mangled, info in sorted(instances.items()):
        D = int(re.search(r"Li(\d+)E", mangled).group(1))  # the head dim
        phase("instance", kernel=mangled, registers=info.get("registers"),
              spill_stores=info.get("spill_stores"),
              spill_loads=info.get("spill_loads"),
              # Q, then two stages of K and V, rows D + 4 floats apart
              # (smem_bytes() in the source)
              smem_bytes=(BQ + 4 * BK) * (D + 4) * 4,
              hmma=hmma.get(mangled, 0))
    if not sum(hmma.values()):
        fail("no HMMA instruction in the kernel's SASS: the tensor cores "
             "do not run")


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads}} from ptxas -v."""
    instances, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            instances[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            instances[name].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            instances[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            instances[name]["smem_bytes"] = int(m.group(1))
    return instances


def nms_report(_kernels):
    """The greedy NMS scan's build: each kernel's registers, spills and
    static shared memory from ptxas; fails if the log names no kernel."""
    instances = ptxas_report(_kernels.build_log("greedy_nms"))
    if not instances:
        fail("no ptxas report in the greedy_nms build log")
    phase("build", source="mxnet_tpu_torch/csrc/greedy_nms.cu",
          kernels=len(instances))
    for mangled, info in sorted(instances.items()):
        phase("instance", kernel=mangled, **info)


def check_kernel(cuda_ops, dev):
    """Phase 2: the kernel against its plain version on the card."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # (B, H, T, Tk, D, causal): tests/test_pallas.py shapes and ragged set,
    # decode, every head dim, and the shapes the served path gives it
    cases = [(2, 2, 256, 256, 64, False), (2, 2, 256, 256, 64, True)]
    for c in (False, True):
        for T, Tk in ((200, 200), (130, 130), (100, 100), (160, 224)):
            cases.append((1, 2, T, Tk, 32,
                          "bottom" if c and T != Tk else c))
    cases += [(1, 2, 96, 224, 32, "top"), (1, 2, 96, 224, 32, "bottom"),
              (1, 12, 1, 1024, 64, "bottom")]
    cases += [(1, 2, 100, 100, d, True) for d in (16, 32, 64, 128)]
    # the register-heaviest instance at full length
    cases.append((1, 4, 1024, 1024, 128, True))
    # inputs whose base is 4 but not 16 bytes aligned and whose rows are
    # D + 1 floats apart: the kernel stages them by widening loads, as bf16
    cases += [(2, 2, 256, 256, 64, c, "unaligned") for c in (False, True)]
    worst = 0.0
    for B, H, T, Tk, D, causal, *layout in cases:
        if layout:
            q, k, v = (randn(B, H, n, D + 1)[..., 1:] for n in (T, Tk, Tk))
        else:
            q, k, v = (randn(B, H, T, D), randn(B, H, Tk, D),
                       randn(B, H, Tk, D))
        out = cuda_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = cuda_ops._attention_reference(q, k, v, causal, D ** -0.5)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        if not err < FP32_BOUND:
            fail("kernel fp32 %s err %.3g >= %g"
                 % ((B, H, T, Tk, D, causal, *layout), err, FP32_BOUND))
    phase("kernel_fp32", cases=len(cases), max_abs_err=worst,
          bound=FP32_BOUND)

    # the served path's layout: q/k/v are strided head views of one
    # (B, T, 3C) projection, at every (rung, length) the server runs
    serve_err = 0.0
    for B in LADDER:
        for T in SERVE_LENGTHS:
            qkv = randn(B, T, 3 * DIM)
            q, k, v = (t.view(B, T, HEADS, DIM // HEADS).transpose(1, 2)
                       for t in qkv.split(DIM, dim=-1))
            out = cuda_ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref = cuda_ops._attention_reference(q, k, v, True,
                                                (DIM // HEADS) ** -0.5)
            serve_err = max(serve_err, (out - ref).abs().max().item())
    if not serve_err < FP32_BOUND:
        fail("kernel at served shapes err %.3g >= %g" % (serve_err,
                                                         FP32_BOUND))
    phase("kernel_served_shapes", max_abs_err=serve_err, bound=FP32_BOUND)

    B, H, T, D = 8, HEADS, MAX_LEN, DIM // HEADS
    qb, kb, vb = (randn(B, H, T, D).to(torch.bfloat16) for _ in range(3))
    out = cuda_ops.flash_attention(qb, kb, vb, causal=True)
    torch.cuda.synchronize()
    if out.dtype != torch.bfloat16:
        fail("bf16 kernel returned %s" % out.dtype)
    ref = cuda_ops._attention_reference(qb.float(), kb.float(), vb.float(),
                                        True, D ** -0.5)
    bf16_err = (out.float() - ref).abs().max().item()
    # the bf16 training path's layout: strided head views of one bf16
    # (B, T, 3C) projection
    qkv = randn(B, T, 3 * DIM).to(torch.bfloat16)
    views = [t.view(B, T, H, D).transpose(1, 2)
             for t in qkv.split(DIM, dim=-1)]
    out = cuda_ops.flash_attention(*views, causal=True)
    torch.cuda.synchronize()
    ref = cuda_ops._attention_reference(*(t.float() for t in views), True,
                                        D ** -0.5)
    bf16_err = max(bf16_err, (out.float() - ref).abs().max().item())
    if not bf16_err < BF16_BOUND:
        fail("kernel bf16 err %.3g >= %g" % (bf16_err, BF16_BOUND))
    phase("kernel_bf16", shape=(B, H, T, D), cases=2, max_abs_err=bf16_err,
          bound=BF16_BOUND)

    # time at the full served shape, fp32 causal
    q, k, v = (randn(B, H, T, D) for _ in range(3))
    ms = time_ms(lambda: cuda_ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: cuda_ops._attention_reference(
        q, k, v, True, D ** -0.5))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v, is_causal=True))
    fp32_peak, tf32_peak, bf16_peak, bytes_peak = card_peaks(
        torch.cuda.get_device_name(0))
    pairs = B * H * T * (T + 1) // 2            # visible (query, key) pairs
    flops = 4 * D * pairs                       # q.k and p.v
    cuda_core_ms = flops / fp32_peak * 1e3
    tensor_core_ms = 3 * flops / tf32_peak * 1e3   # three TF32 passes
    bytes_ms = 4 * B * H * T * D * 4 / bytes_peak * 1e3   # q, k, v, o once
    # the least time at fp32 accuracy: the faster of the two routes for the
    # operations, or the bytes if they take longer
    ops_ms = min(cuda_core_ms, tensor_core_ms)
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    phase("kernel_time", shape=(B, H, T, D), calls_per_timing=TIMED_CALLS,
          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          bound_cuda_core_ms=cuda_core_ms,
          bound_tensor_core_ms=tensor_core_ms, bytes_ms=bytes_ms,
          bound_ms=bound_ms, bound_by=bound_by)
    # bf16 at the same shape, the bf16 LM's: the kernel widens its loads to
    # fp32 and runs the split-TF32 path; the bound is bf16's own (q, k, v, o
    # at two bytes, the operations at the bf16 tensor-core peak)
    ms_bf16 = time_ms(lambda: cuda_ops.flash_attention(qb, kb, vb,
                                                       causal=True))
    plain_ms_bf16 = time_ms(lambda: cuda_ops._attention_reference(
        qb, kb, vb, True, D ** -0.5))
    library_ms_bf16 = time_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(qb, kb, vb,
                                                           is_causal=True))
    ops_ms_bf16 = flops / bf16_peak * 1e3
    bytes_ms_bf16 = 4 * B * H * T * D * 2 / bytes_peak * 1e3
    bound_ms_bf16 = max(ops_ms_bf16, bytes_ms_bf16)
    bound_by_bf16 = "operations" if ops_ms_bf16 >= bytes_ms_bf16 \
        else "bytes"
    phase("kernel_time_bf16", shape=(B, H, T, D),
          calls_per_timing=TIMED_CALLS, ms=ms_bf16, plain_ms=plain_ms_bf16,
          library_ms=library_ms_bf16, ops_ms=ops_ms_bf16,
          bytes_ms=bytes_ms_bf16, bound_ms=bound_ms_bf16,
          bound_by=bound_by_bf16)
    return {"max_abs_err": max(worst, serve_err), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_cuda_core_ms": cuda_core_ms,
            "bound_tensor_core_ms": tensor_core_ms, "bytes_ms": bytes_ms,
            "max_abs_err_bf16": bf16_err, "ms_bf16": ms_bf16,
            "plain_ms_bf16": plain_ms_bf16,
            "library_ms_bf16": library_ms_bf16,
            "bound_ms_bf16": bound_ms_bf16, "bound_by_bf16": bound_by_bf16}


def lm_requests():
    """The served LM's traffic: (tokens, positions) pairs, 12 short and 6
    long, interleaved, from a seed."""
    rng = np.random.RandomState(0)
    requests = []
    for i in range(18):
        T = SERVE_LENGTHS[1] if i % 3 == 2 else SERVE_LENGTHS[0]
        requests.append((rng.randint(0, VOCAB, T).astype(np.int32),
                         np.arange(T, dtype=np.int32)))
    return requests


def serve_concurrently(server, name, requests, clients=4):
    """Every request through ``server.predict`` from ``clients`` threads
    at once.  Returns the results in request order and the wall
    seconds."""
    results = [None] * len(requests)

    def client(worker):
        for i in range(worker, len(requests), clients):
            results[i] = server.predict(name, requests[i],
                                        timeout_ms=120000)

    threads = [threading.Thread(target=client, args=(w,))
               for w in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.time() - t0
    if any(t.is_alive() for t in threads):
        fail("%s: client threads did not finish" % name)
    return results, wall


def serve(cuda_ops, dev, card):
    """Phase 3: the full-width LM served through ModelServer on the card."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerLM

    t0 = time.time()
    net = new_lm(dev, DEPTH, 0)
    n_params = sum(p.numel() for p in net.parameters())
    phase("model", params=n_params, build_s=round(time.time() - t0, 2))

    requests = lm_requests()
    server = serving.ModelServer()
    reset_launches(cuda_ops)
    try:
        t0 = time.time()
        model = server.load_model(
            "lm", net, input_shapes=[((T,), (T,)) for T in SERVE_LENGTHS],
            dtype=("int32", "int32"), batch_ladder=list(LADDER),
            linger_ms=20.0, max_queue=64, device=dev)
        warm = model.warmup_report
        phase("warmup", signatures=warm["signatures"],
              seconds=round(time.time() - t0, 2))
        results, wall = serve_concurrently(server, "lm", requests)
        snap = server.stats()["models"]["lm"]
        # one padded batch of short requests (rung 4) straight through the
        # registry's graph, to hold against the eager block below
        short = [r for r in requests if len(r[0]) == SERVE_LENGTHS[0]][:4]
        arrays = [np.stack([r[j] for r in short]) for j in range(2)]
        graphed = model.execute(arrays)[0]
        cache, caps = model.cache_stats(), model.capture_stats()
        eager_launches = cuda_ops.flash_attention.launches
        # a replay calls no wrapper: torch.profiler counts the kernels one
        # replay of each served length launches
        per_replay = {}
        for T in SERVE_LENGTHS:
            batch = [np.zeros((1, T), np.int32)] * 2
            per_replay[T] = replayed_launches(
                lambda: model.execute(batch))[0]
    finally:
        server.stop()
    if cuda_ops.flash_attention.launches != eager_launches:
        fail("serve: a graph replay called the kernel's wrapper")
    # the single server's answers, which fleet_serve's are held to
    REFS["served"] = [r.output for r in results]
    statuses = [r.status for r in results]
    if statuses.count(serving.OK) != len(requests):
        fail("not every request OK: %s" % [(r.status, r.error)
                                          for r in results])
    for (tok, _), r in zip(requests, results):
        if r.output.shape != (len(tok), VOCAB) or \
                not np.isfinite(r.output).all():
            fail("bad logits %s for T=%d" % (r.output.shape, len(tok)))
    batches = warm["signatures"] + snap["batches"] + 1
    if caps["replays"] != batches:
        fail("serve: %d graph replays for %d batches" % (caps["replays"],
                                                         batches))
    # each signature runs eagerly (its warm-up) before its capture, where
    # the wrapper counts; then every batch is one replay of a graph that
    # the profiler saw launch the kernel once a layer
    if eager_launches != DEPTH * caps["eager_runs"]:
        fail("serve: %d eager launches, not %d layers x %d warm-up runs"
             % (eager_launches, DEPTH, caps["eager_runs"]))
    if set(per_replay.values()) != {DEPTH}:
        fail("serve: the profiler saw the kernel %s times in one replay "
             "(by length), not %d" % (per_replay, DEPTH))
    launches = eager_launches + caps["replays"] * per_replay[SERVE_LENGTHS[0]]
    lat = sorted(r.latency_ms for r in results)
    tokens = sum(len(tok) for tok, _ in requests)
    phase("serve", requests=len(requests), ok=statuses.count(serving.OK),
          batches=snap["batches"], avg_batch=snap["avg_batch"],
          launches=launches, p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)), tokens=tokens,
          tokens_per_s=tokens / wall, card='"%s"' % card)

    hybrid_serve(net, dev, warm, cache, caps, arrays, graphed, per_replay)
    profile_batch(net, dev)

    # the same weights on the CPU, where the plain attention runs
    cpu_net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                            max_len=MAX_LEN, device="cpu")
    cpu_net.load_state_dict(net.state_dict())
    del net
    worst, agree = 0.0, 1.0
    for i in (0, 2):   # one short and one long request
        tok, pos = requests[i]
        with torch.inference_mode():
            ref = cpu_net(torch.from_numpy(tok)[None],
                          torch.from_numpy(pos)[None])[0].numpy()
        got = results[i].output
        worst = max(worst, float(np.abs(got - ref).max()))
        if not np.allclose(got, ref, atol=SERVE_ATOL, rtol=SERVE_RTOL):
            fail("served logits of request %d differ from the CPU: max "
                 "abs err %.3g" % (i, float(np.abs(got - ref).max())))
        agree = min(agree, float((got.argmax(-1) == ref.argmax(-1)).mean()))
    if agree < ARGMAX_AGREE:
        fail("argmax agreement %.4f < %.2f" % (agree, ARGMAX_AGREE))
    phase("serve_vs_cpu", max_abs_err=worst, atol=SERVE_ATOL,
          rtol=SERVE_RTOL, argmax_agree=agree)
    return launches


def profile_batch(net, dev, B=4):
    """Where one long served batch's time goes: its forward on the card
    against the host copy of its logits (host clock, each ended by a
    synchronize), and the device time by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    T = MAX_LEN
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randint(0, VOCAB, (B, T), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    with torch.inference_mode():
        net(idx, pos).cpu()   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = net(idx, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits.cpu()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net(idx, pos).cpu()
    # device-side events only (kernels and copies): the host-side ops
    # carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    phase("profile", batch=(B, T), forward_ms=(t1 - t0) * 1e3,
          to_host_ms=(t2 - t1) * 1e3, device_ms=device_ms,
          top_device_ms=json.dumps([[e.key[:60],
                                     e.self_device_time_total / 1e3]
                                    for e in top]))


def kernel_grad(cuda_ops, dev):
    """Phase: the training path's gradient through the kernel.  The loss
    of tests/test_pallas.py::test_flash_attention_grad, sum(o**2), is
    backpropagated through ``flash_attention`` (kernel forward, the plain
    version's gradient backward) and through the plain version alone;
    q/k/v gradients held at GRAD_BOUND.  Then the forward and backward at
    the training shape are timed, beside the library's fused attention."""
    g = torch.Generator(device=dev).manual_seed(2)
    before = cuda_ops.flash_attention.launches
    worst = 0.0
    train_shape = (TRAIN_B, HEADS, MAX_LEN, DIM // HEADS)
    for shape in ((1, 1, 128, 32), train_shape):
        q, k, v = (torch.randn(*shape, generator=g, device=dev,
                               requires_grad=True) for _ in range(3))
        got = torch.autograd.grad(
            (cuda_ops.flash_attention(q, k, v, causal=True) ** 2).sum(),
            (q, k, v))
        want = torch.autograd.grad((cuda_ops._attention_reference(
            q, k, v, True, shape[-1] ** -0.5) ** 2).sum(), (q, k, v))
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        worst = max(worst, err)
        if not err < GRAD_BOUND:
            fail("flash_attention gradient at %s err %.3g >= %g"
                 % (shape, err, GRAD_BOUND))
    # bf16, the bf16 LM's: the backward is the plain version's in bf16, fed
    # the kernel's rounded output (grad of sum(o**2) is 2o), so the
    # gradients agree to bf16's rounding, relative to their largest value
    qb, kb, vb = (torch.randn(*train_shape, generator=g, device=dev)
                  .to(torch.bfloat16).requires_grad_() for _ in range(3))
    got = torch.autograd.grad(
        (cuda_ops.flash_attention(qb, kb, vb, causal=True).float() ** 2)
        .sum(), (qb, kb, vb))
    want = torch.autograd.grad((cuda_ops._attention_reference(
        qb, kb, vb, True, train_shape[-1] ** -0.5).float() ** 2).sum(),
        (qb, kb, vb))
    torch.cuda.synchronize()
    bf16_err = max(((a.float() - b.float()).abs().max()
                    / b.float().abs().max()).item()
                   for a, b in zip(got, want))
    if not bf16_err < BF16_BOUND:
        fail("flash_attention bf16 gradient err %.3g >= %g"
             % (bf16_err, BF16_BOUND))
    launches = cuda_ops.flash_attention.launches - before
    if launches != 3:
        fail("kernel_grad launched the kernel %d times, not 3" % launches)
    # q, k, v are the training shape's from here on
    grad_out = torch.randn(*train_shape, generator=g, device=dev)

    def fwd_bwd(attn):
        return lambda: torch.autograd.grad(attn(q, k, v), (q, k, v),
                                           grad_out)
    fwd_bwd_ms = time_ms(fwd_bwd(lambda q, k, v: cuda_ops.flash_attention(
        q, k, v, causal=True)), reps=5, calls=4)
    library_fwd_bwd_ms = time_ms(fwd_bwd(
        lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)), reps=5, calls=4)
    phase("kernel_grad", cases=2, max_abs_err=worst, bound=GRAD_BOUND,
          bf16_max_rel_err=bf16_err, bf16_bound=BF16_BOUND,
          launches=launches, shape=train_shape, fwd_bwd_ms=fwd_bwd_ms,
          library_fwd_bwd_ms=library_fwd_bwd_ms)
    return {"fwd_bwd_ms": fwd_bwd_ms,
            "library_fwd_bwd_ms": library_fwd_bwd_ms}


def forward_backward(net, ce, x, y, pos):
    """One recorded forward, the Gluon loss (mean over tokens) and its
    backward, as ``models/transformer_lm.py`` ``main`` runs them."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        logits = net(x, pos)
        loss = ce(logits.reshape(-1, logits.shape[-1]), y.reshape(-1)).mean()
    loss.backward()
    return loss


def lm_batches(rng, steps, B, T, dev):
    from mxnet_tpu_torch.models.transformer_lm import pattern_batch

    out = []
    for _ in range(steps):
        x, y = pattern_batch(rng, B, T, VOCAB)
        out.append((torch.from_numpy(x).to(dev),
                    torch.from_numpy(y.astype(np.float32)).to(dev)))
    return out


def new_lm(dev, depth, seed):
    """The LM on ``dev`` with the example's weights for
    ``mx.random.seed(seed)``: Xavier, the deferred layers drawn at a first
    call on one token."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import TransformerLM

    mx.random.seed(seed)
    net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=depth,
                        max_len=MAX_LEN, device=dev)
    net.initialize(mx.init.Xavier())
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        net(one, one)
    return net


def train(cuda_ops, dev, card, bf16=False):
    """Phase: the full-width LM takes TRAIN_STEPS Adam steps through
    ``gluon.Trainer`` on ``pattern_batch`` data; every step's forward must
    launch the kernel once a layer, in the model's dtype and never in the
    other.  With ``bf16`` the model is cast to bf16 and Adam keeps fp32
    master weights (``multi_precision``).  Step time by CUDA events, median
    over the steps after the first."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    net = new_lm(dev, DEPTH, 0)
    if bf16:
        net.cast("bfloat16")
    trainer = gluon.Trainer(net.named_parameters(), "adam",
                            {"learning_rate": TRAIN_LR,
                             "multi_precision": bf16})
    ce = SoftmaxCrossEntropyLoss()
    batches = lm_batches(np.random.RandomState(0), TRAIN_STEPS, TRAIN_B,
                         MAX_LEN, dev)
    pos = torch.arange(MAX_LEN, device=dev,
                       dtype=torch.int32).expand(TRAIN_B, MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    reset_launches(cuda_ops)
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = forward_backward(net, ce, x, y, pos)
        trainer.step(1)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        step_ms.append(start.elapsed_time(end))
    launches = cuda_ops.flash_attention.launches
    by_dtype = dict(cuda_ops.flash_attention.launches_by_dtype)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    label, dtype = ("lm_bf16_train", "bfloat16") if bf16 \
        else ("train", "float32")
    if not bf16:   # what hybrid_lm_train must reproduce bit for bit
        REFS["train"] = (list(losses), median_of(step_ms), {
            n: t.detach().clone() for n, t in net.state_dict().items()})
    if not all(np.isfinite(losses)):
        fail("%s losses not finite: %s" % (label, losses))
    if launches != DEPTH * TRAIN_STEPS or by_dtype[dtype] != launches:
        fail("%s: flash_attention launches %s, not %d layers x %d steps "
             "in %s" % (label, by_dtype, DEPTH, TRAIN_STEPS, dtype))
    if bf16 and not all(p.dtype == torch.bfloat16 for p in net.parameters()):
        fail("lm_bf16_train: a parameter left bf16")
    median_ms = float(np.median(step_ms[1:]))
    phase(label, batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          losses=json.dumps(losses), launches=launches,
          launches_by_dtype=json.dumps(by_dtype),
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          tokens_per_s=TRAIN_B * MAX_LEN / (median_ms / 1e3),
          peak_memory_gb=peak_gb, card='"%s"' % card)
    return launches, (net, trainer, ce, batches[-1], pos), losses


def train_profile(net, trainer, ce, batch, pos, card, label="train_profile"):
    """Phase: where one full-width training step's time goes.  CUDA events
    around its forward (with the loss), backward and update; then the same
    step under torch.profiler: device time by kernel, the plain attention
    backward (the Function's backward, recompute included) and the
    update."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch import autograd

    x, y = batch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with autograd.record():
        loss = ce(net(x, pos).reshape(-1, VOCAB), y.reshape(-1)).mean()
    ev[1].record()
    loss.backward()
    ev[2].record()
    trainer.step(1)
    ev[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward_backward(net, ce, x, y, pos)
        with record_function("trainer.step"):
            trainer.step(1)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    averages = prof.key_averages()
    # device-side kernels and copies; the range's annotation on the device
    # timeline spans its kernels and idle gaps and is left out
    kernels = [e for e in averages
               if e.device_type != cpu and e.key != "trainer.step"]

    def kernel_ms(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / 1e3

    def op_ms(key):   # a host-side op or range: the kernels under it
        return sum(e.device_time_total for e in averages
                   if e.key == key and e.device_type == cpu) / 1e3

    def launched(event):   # (kernel name, us) under a host-side event
        for k in event.kernels:
            yield k.name, k.duration
        for child in event.cpu_children:
            yield from launched(child)

    attn_bwd = [kd for e in prof.events()
                if e.name == "_FlashAttentionBackward"
                for kd in launched(e)]
    attn_bwd_gemm = sum(d for n, d in attn_bwd if "gemm" in n.lower()) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    phase(label, batch=(TRAIN_B, MAX_LEN), forward_ms=fwd_ms,
          backward_ms=bwd_ms, update_ms=upd_ms,
          step_ms=fwd_ms + bwd_ms + upd_ms,
          device_ms=kernel_ms(lambda k: True),
          flash_fwd_ms=kernel_ms(lambda k: "flash_attention_fwd" in k),
          gemm_ms=kernel_ms(lambda k: any(t in k.lower() for t in
                                          ("gemm", "nvjet", "xmma"))),
          attention_backward_ms=op_ms("_FlashAttentionBackward"),
          attention_backward_gemm_ms=attn_bwd_gemm,
          update_device_ms=op_ms("trainer.step"),
          card='"%s"' % card,
          top_device_ms=json.dumps([[e.key[:70], e.count,
                                     e.self_device_time_total / 1e3]
                                    for e in top]))


def leaf_rel_errs(grads, want):
    """|a - b| / |b| for each parameter's gradient, by name."""
    return {n: ((g.cpu() - want[n]).norm() / want[n].norm()).item()
            for n, g in grads.items()}


def train_vs_cpu(cuda_ops, dev):
    """Phase: the same full-width LM, depth cut, trained on the card and
    on the CPU from the same weights and batches: per-step losses and the
    first step's gradients held at SERVE_ATOL/RTOL, and each gradient's
    relative gap at GRAD_REL_BOUND.  A control takes the first step's
    gradients on the card again with TF32 GEMMs: the gap a precision fault
    of that size would leave, printed beside the bound."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    depth, B, T, steps = VS_CPU
    nets = {"card": new_lm(dev, depth, 1)}
    nets["cpu"] = new_lm("cpu", depth, 1)
    nets["cpu"].load_state_dict(nets["card"].state_dict())
    start_weights = {n: w.clone() for n, w in
                     nets["cpu"].state_dict().items()}
    trainers = {k: gluon.Trainer(n.named_parameters(), "adam",
                                 {"learning_rate": TRAIN_LR})
                for k, n in nets.items()}
    ce = SoftmaxCrossEntropyLoss()
    batches = lm_batches(np.random.RandomState(1), steps, B, T, "cpu")
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    before = cuda_ops.flash_attention.launches
    losses, grad_err = [], (0.0, None, None)
    for step, (x, y) in enumerate(batches):
        got = forward_backward(nets["card"], ce, x.to(dev), y.to(dev),
                               pos.to(dev)).item()
        want = forward_backward(nets["cpu"], ce, x, y, pos).item()
        losses.append((got, want))
        if not abs(got - want) <= SERVE_ATOL + SERVE_RTOL * abs(want):
            fail("step %d loss on the card %.6f vs CPU %.6f"
                 % (step, got, want))
        if step == 0:
            cpu_grads = {n: p.grad.clone()
                         for n, p in nets["cpu"].named_parameters()}
            card_grads = dict(nets["card"].named_parameters())
            for name, p in card_grads.items():
                a, b = p.grad.cpu(), cpu_grads[name]
                err = (a - b).abs().max().item()
                if err >= grad_err[0]:
                    grad_err = (err, name, b.abs().max().item())
                if not torch.allclose(a, b, atol=SERVE_ATOL,
                                      rtol=SERVE_RTOL):
                    fail("step 1 gradient of %s differs from the CPU: max "
                         "abs err %.3g" % (name, err))
            rel = leaf_rel_errs({n: p.grad for n, p in card_grads.items()},
                                cpu_grads)
        for t in trainers.values():
            t.step(1)
    launches = cuda_ops.flash_attention.launches - before
    if launches != depth * steps:
        fail("train_vs_cpu launched the kernel %d times, not %d"
             % (launches, depth * steps))
    worst_rel = max(rel, key=rel.get)
    if rel[worst_rel] > GRAD_REL_BOUND:
        fail("step 1 gradient of %s is %.3g away from the CPU's, relative "
             "to its norm; bound %g" % (worst_rel, rel[worst_rel],
                                        GRAD_REL_BOUND))
    cpu_params = dict(nets["cpu"].named_parameters())
    param_err = max((p.detach().cpu() - cpu_params[n].detach()).abs().max()
                    .item() for n, p in nets["card"].named_parameters())
    # the control, after the launches were counted
    control = nets["card"]
    control.load_state_dict(start_weights)
    x, y = batches[0]
    torch.backends.cuda.matmul.allow_tf32 = True
    forward_backward(control, ce, x.to(dev), y.to(dev), pos.to(dev))
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32_rel = leaf_rel_errs({n: p.grad for n, p in
                              control.named_parameters()}, cpu_grads)
    tf32_worst = max(tf32_rel, key=tf32_rel.get)
    phase("train_vs_cpu", depth=depth, batch=(B, T), steps=steps,
          losses=json.dumps(losses), step1_grad_max_abs_err=grad_err[0],
          worst_grad=grad_err[1], its_max_abs_grad=grad_err[2],
          atol=SERVE_ATOL, rtol=SERVE_RTOL,
          step1_grad_max_rel_err=rel[worst_rel], its_leaf=worst_rel,
          median_leaf_rel_err=float(np.median(list(rel.values()))),
          rel_bound=GRAD_REL_BOUND, tf32_control_max_rel_err=tf32_rel[
              tf32_worst], tf32_control_leaf=tf32_worst,
          tf32_control_median_rel_err=float(np.median(list(
              tf32_rel.values()))),
          tf32_control_min_rel_err=min(tf32_rel.values()),
          launches=launches, param_max_abs_diff_after=param_err)


def resnet_args(batch_size):
    """The example's options at their defaults (common.py add_fit_args)."""
    import argparse

    from mxnet_tpu_torch.models import image_classification as ic

    return ic.add_fit_args(argparse.ArgumentParser()).parse_args(
        ["--batch-size", str(batch_size)])


def new_resnet(dev, seed, layout="NCHW"):
    """resnet50_v1 on ``dev`` with the JAX package's weights for
    ``mx.random.seed(seed)``: Xavier, the deferred layers drawn at a first
    call (shapes do not depend on the image size)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.get_model("resnet50_v1", layout=layout, device=dev)
    net.initialize(mx.init.Xavier())
    with torch.no_grad():
        net(torch.zeros((1, 3, 32, 32) if layout == "NCHW"
                        else (1, 32, 32, 3), device=dev))
    return net


def synthetic_batches(args, image_shape, device, n):
    """The first ``n`` batches of the example's synthetic set in the order
    it was drawn, as (data, label) tensors on ``device``."""
    from mxnet_tpu_torch.models import image_classification as ic

    it = ic.get_synthetic_iter(args, image_shape, device)
    (_, X), (_, Y) = it.data[0], it.label[0]
    B = args.batch_size
    return [(X[i * B:(i + 1) * B], Y[i * B:(i + 1) * B]) for i in range(n)]


def resnet_model(dev, card):
    """Phase: resnet50_v1 built on the card and Xavier-initialized."""
    t0 = time.time()
    net = new_resnet(dev, 0)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    params = list(net.parameters())
    trainable = [p for p in params if p.requires_grad]
    arrays = len(net.state_dict())
    if (arrays, len(trainable)) != (299, 193):
        fail("resnet50_v1 has %d arrays, %d trainable; the JAX model has "
             "299 and 193" % (arrays, len(trainable)))
    phase("resnet_model", network="resnet50_v1", arrays=arrays,
          trainable_arrays=len(trainable),
          params=sum(p.numel() for p in params),
          trainable_params=sum(p.numel() for p in trainable),
          buffers=sum(b.numel() for b in net.buffers()), build_s=build_s,
          card='"%s"' % card)


def resnet_fit(dev, card, dtype="float32"):
    """Phase: resnet50_v1 trained through the example's entry point
    (``image_classification.main``, one epoch of the synthetic set) with
    ``--dtype``, from ``mx.random.seed(0)``: the JAX run's weights and
    shuffled batch order.  Returns the trained model."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import image_classification as ic

    label = "resnet_fit" if dtype == "float32" else "resnet_bf16_fit"
    mx.random.seed(0)
    t0 = time.time()
    net = ic.main(["--network", "resnet50_v1", "--batch-size", str(RESNET_B),
                   "--num-epochs", "1", "--dtype", dtype])
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    state = net.state_dict()
    if not all(torch.isfinite(t).all() for t in state.values()):
        fail("%s left non-finite weights" % label)
    if {str(t.dtype) for t in state.values()} != {"torch." + dtype}:
        fail("%s: arrays not all %s" % (label, dtype))
    moved = sum(not torch.equal(b, torch.ones_like(b)) for n, b in
                net.named_buffers() if n.endswith("running_var"))
    if moved != 53:
        fail("%s moved %d of 53 running variances" % (label, moved))
    phase(label, network="resnet50_v1", batch=RESNET_B, dtype=dtype,
          steps=-(-max(10 * RESNET_B, 320) // RESNET_B), seed=0,
          shuffled=True, seconds=fit_s, running_vars_moved=moved,
          card='"%s"' % card)
    return net


def resnet_steps(dev, card, batches, layout, dtype, label,
                 multi_precision=False):
    """Phase ``label``: resnet50_v1 in ``layout``, cast to ``dtype`` as
    ``fit_gluon`` casts it, trained over ``batches`` by its loop
    (``train_step``, each batch's data cast to ``dtype``) with the
    example's SGD, timed by CUDA events: one warm step, the median of the
    rest.  Returns the model, its Trainer and loss."""
    from mxnet_tpu_torch import gluon, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import image_classification as ic

    args = resnet_args(RESNET_B)
    net = new_resnet(dev, 0, layout).cast(dtype)
    trainer = gluon.Trainer(net.named_parameters(), args.optimizer,
                            {"learning_rate": args.lr, "momentum": args.mom,
                             "wd": args.wd,
                             "multi_precision": multi_precision},
                            kvstore=args.kv_store)
    ce, acc = SoftmaxCrossEntropyLoss(), metric.Accuracy()
    stats = [b.clone() for b in net.buffers()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = ic.train_step(net, trainer, ce, acc,
                             x.to(getattr(torch, dtype)), y, RESNET_B)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.float().mean().item())
        step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)):
        fail("%s %s losses not finite: %s" % (label, layout, losses))
    moved = sum(not torch.equal(a, b) for a, b in zip(stats, net.buffers()))
    if moved != len(stats):
        fail("%s %s: %d of %d running statistics moved"
             % (label, layout, moved, len(stats)))
    dtypes = sorted({str(t.dtype) for t in net.state_dict().values()})
    if dtypes != ["torch." + dtype]:
        fail("%s %s: arrays are %s, not %s" % (label, layout, dtypes, dtype))
    median_ms = float(np.median(step_ms[1:]))
    phase(label, layout=layout, network="resnet50_v1", dtype=dtype,
          multi_precision=multi_precision,
          batch=(RESNET_B, 3, RESNET_SIZE, RESNET_SIZE),
          steps=len(batches), losses=json.dumps(losses),
          accuracy=acc.get()[1], step_ms=json.dumps(step_ms),
          median_step_ms=median_ms,
          imgs_per_s=RESNET_B / (median_ms / 1e3),
          peak_memory_gb=peak_gb, running_stats_moved=moved,
          card='"%s"' % card)
    return net, trainer, ce


def resnet_train(dev, card, dtype="float32"):
    """Phases: ``resnet_fit`` (or ``resnet_bf16_fit``; in fp32 then
    ``params_io`` of the fitted model), then RESNET_STEPS steps of the loop
    in each layout (``resnet_train``, ``resnet_bf16_train``).  Returns each
    layout's model state for the profile, by layout."""
    fitted = resnet_fit(dev, card, dtype)
    if dtype == "float32":
        params_io(fitted, card)
    del fitted   # freed before the timed steps and their peak memory
    label = "resnet_train" if dtype == "float32" else "resnet_bf16_train"
    batches = synthetic_batches(resnet_args(RESNET_B),
                                (3, RESNET_SIZE, RESNET_SIZE), dev,
                                RESNET_STEPS)
    states = {}
    for layout in ("NCHW", "NHWC"):
        if layout == "NHWC":
            batches = [(x.permute(0, 2, 3, 1).contiguous(), y)
                       for x, y in batches]
        net, trainer, ce = resnet_steps(dev, card, batches, layout, dtype,
                                        label)
        x, y = batches[-1]
        states[layout] = (net, trainer, ce, (x.to(getattr(torch, dtype)), y))
    return states


def resnet_bf16_mp(dev, card):
    """Phase: the bf16 step with ``multi_precision=True``: SGD keeps fp32
    master weights, and each bf16 weight is its master's cast."""
    batches = synthetic_batches(resnet_args(RESNET_B),
                                (3, RESNET_SIZE, RESNET_SIZE), dev,
                                RESNET_STEPS)
    net, trainer, _ = resnet_steps(dev, card, batches, "NCHW", "bfloat16",
                                   "resnet_bf16_mp", multi_precision=True)
    states = trainer._updater.states
    params = {i: p for i, p in enumerate(trainer._params) if p.requires_grad}
    for i, p in params.items():
        master = states[i][1]
        if master.dtype != torch.float32:
            fail("resnet_bf16_mp: master %d is %s" % (i, master.dtype))
        if not torch.equal(p.detach(), master.to(torch.bfloat16)):
            fail("resnet_bf16_mp: weight %d is not its master's cast" % i)
    phase("resnet_bf16_mp_masters", masters=len(params),
          master_dtype="float32", weights_are_casts=True)


# the profile's categories, by the names of the ranges and ops a kernel
# runs under, outermost first: the forward's ranges are the layers' class
# names, the backward's ops the autograd nodes' names.  The first category
# that one of them matches wins
RESNET_CATEGORIES = (
    ("update", ("trainer.step",)),
    ("dropout", ("dropout",)),
    ("loss", ("loss", "logsoftmax", "gather", "neg", "ones_like")),
    ("convolution", ("conv",)),
    ("batchnorm", ("batchnorm", "batch_norm")),
    ("pooling", ("pool", "mean")),
    ("fc_gemm", ("dense", "addmm", "mmbackward")),
    ("relu_add", ("activation", "relu", "threshold", "aten::add",
                  "addbackward")),
    ("copies", ("copy", "accumulategrad")),
)


def resnet_category(event, kernel_name):
    """The category of a kernel ``event`` launched, and the outermost name
    above it."""
    chain = []
    while event is not None:
        chain.append(event.name)
        event = event.cpu_parent
    if kernel_name.lower().startswith(("memcpy", "memset")):
        return "copies", chain[-1]
    for name in reversed(chain):
        for category, keys in RESNET_CATEGORIES:
            if any(k in name.lower() for k in keys):
                return category, chain[-1]
    return "other", chain[-1]


def layer_ranges(net):
    """Hooks that put each layer's forward in a profiler range named for
    its class (the backward is named by autograd's nodes); returns the
    handles."""
    from torch.profiler import record_function

    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv, _Pooling

    open_ranges = {}

    def enter(module, args):
        open_ranges[id(module)] = record_function(type(module).__name__)
        open_ranges[id(module)].__enter__()

    def leave(module, args, out):
        open_ranges.pop(id(module)).__exit__(None, None, None)

    handles = []
    for m in net.modules():
        if isinstance(m, (_Conv, _Pooling, gnn.BatchNorm, gnn.Dense,
                          gnn.Activation, gnn.Dropout)):
            handles += [m.register_forward_pre_hook(enter),
                        m.register_forward_hook(leave)]
    return handles


# a convolution kernel whose name carries one of these runs on the tensor
# cores (cuDNN names the data types and the MMA shape); the fp32 kernels
# that TF32-off leaves ("f32f32") run on the CUDA cores
TENSOR_CORE_TAGS = ("bf16", "tf32", "f16", "16816", "1688", "hmma", "gmma",
                    "tensorop")


def resnet_profile(net, trainer, ce, batch, card, label="resnet_profile",
                   layout="NCHW"):
    """Phase: where one resnet50_v1 training step's time goes.  CUDA
    events around its forward (with the loss), backward and update, and
    the host's clock around the update's launches; then the same step
    under torch.profiler, its device time by category, and how much of the
    convolutions' time runs in tensor-core kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch import autograd

    x, y = batch

    def step(ev=None):
        if ev:
            ev[0].record()
        with autograd.record():
            out = net(x)
            with record_function("loss"):
                loss = ce(out, y)
        if ev:
            ev[1].record()
        loss.backward(torch.ones_like(loss))
        if ev:
            ev[2].record()
        t0 = time.perf_counter()
        with record_function("trainer.step"):
            trainer.step(RESNET_B)
        host_ms = (time.perf_counter() - t0) * 1e3
        if ev:
            ev[3].record()
        return host_ms

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    update_host_ms = step(ev)
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    handles = layer_ranges(net)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    split, count, names, other = {}, {}, {}, {}
    fold_ms = 0.0   # BatchNorm's second pass for its running statistics
    conv_tc_ms, conv_names = 0.0, {}
    for event in prof.events():
        for k in event.kernels:
            if event.name == "aten::var_mean":
                fold_ms += k.duration / 1e3
            cat, top = resnet_category(event, k.name)
            if cat == "convolution":
                conv_names[k.name] = conv_names.get(k.name, 0.0) \
                    + k.duration / 1e3
                if any(t in k.name.lower() for t in TENSOR_CORE_TAGS):
                    conv_tc_ms += k.duration / 1e3
            split[cat] = split.get(cat, 0.0) + k.duration / 1e3
            count[cat] = count.get(cat, 0) + 1
            names[k.name] = names.get(k.name, 0.0) + k.duration / 1e3
            if cat == "other":
                other[top] = other.get(top, 0.0) + k.duration / 1e3
    device_ms = sum(split.values())
    if not device_ms:
        fail("the profiler saw no device time")
    top = sorted(names.items(), key=lambda kv: kv[1], reverse=True)[:10]
    top_conv = sorted(conv_names.items(), key=lambda kv: kv[1],
                      reverse=True)[:4]
    phase(label, layout=layout, batch=RESNET_B,
          forward_ms=fwd_ms, backward_ms=bwd_ms, update_ms=upd_ms,
          step_ms=fwd_ms + bwd_ms + upd_ms, update_host_ms=update_host_ms,
          update_device_ms=split.get("update", 0.0),
          update_kernels=count.get("update", 0), device_ms=device_ms,
          split_ms=json.dumps(split), kernels=json.dumps(count),
          batchnorm_fold_stats_ms=fold_ms,
          conv_tensor_core_ms=conv_tc_ms,
          conv_tensor_core_share=conv_tc_ms / max(split.get("convolution",
                                                            0.0), 1e-9),
          top_conv_kernels=json.dumps([[n[:90], ms] for n, ms in top_conv]),
          other_ms_by_op=json.dumps(other), card='"%s"' % card,
          top_device_ms=json.dumps([[n[:70], ms] for n, ms in top]))


def without_conv_biases(tensors):
    """``tensors`` but for the convolutions' biases: a BatchNorm follows
    each, so their exact gradient is 0 and they hold rounding noise."""
    return {n: t for n, t in tensors.items()
            if not (n.endswith(".bias") and not n.startswith("output."))}


def resnet_vs_cpu(dev):
    """Phase: resnet50_v1 with the same Xavier weights trained on the card
    and on the CPU: RESNET_VS_CPU's batch and steps of the example's loop
    on the synthetic set.  Holds the step-1 logits, each leaf's step-1
    gradient and the median of the parameters' and running statistics'
    gaps after the last step.  A control runs the same steps on the card with TF32 convolutions
    and GEMMs: the gaps a fault of that size would leave."""
    from mxnet_tpu_torch import gluon, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import image_classification as ic

    B, side, steps = RESNET_VS_CPU
    args = resnet_args(B)
    batches = synthetic_batches(args, (3, side, side), "cpu", steps)
    start = new_resnet("cpu", 1).state_dict()

    def run(device):
        net = new_resnet(device, 1)
        net.load_state_dict(start)
        trainer = gluon.Trainer(net.named_parameters(), "sgd",
                                {"learning_rate": args.lr,
                                 "momentum": args.mom, "wd": args.wd})
        logits = []
        hook = net.register_forward_hook(
            lambda m, i, o: logits.append(o.detach().cpu()))
        losses, grads = [], None
        for x, y in batches:
            loss = ic.train_step(net, trainer, SoftmaxCrossEntropyLoss(),
                                 metric.Accuracy(), x.to(device),
                                 y.to(device), B)
            losses.append(loss.mean().item())
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in net.named_parameters()
                         if p.requires_grad}
        hook.remove()
        return logits[0], losses, grads, {
            n: t.detach().cpu() for n, t in net.state_dict().items()}

    want = run("cpu")
    readings = {}
    for label, tf32 in (("fp32", False), ("tf32_control", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = run(dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        grad_rel = leaf_rel_errs(without_conv_biases(got[2]), want[2])
        after_rel = leaf_rel_errs(without_conv_biases(got[3]), want[3])
        worst_grad = max(grad_rel, key=grad_rel.get)
        worst_after = max(after_rel, key=after_rel.get)
        readings[label] = (
            (got[0] - want[0]).abs().max().item(), grad_rel[worst_grad],
            float(np.median(list(after_rel.values()))))
        phase("resnet_vs_cpu", run=label, batch=(B, 3, side, side),
              steps=steps, losses=json.dumps(list(zip(got[1], want[1]))),
              step1_logits_max_abs_err=readings[label][0],
              its_max_abs_logit=want[0].abs().max().item(),
              step1_grad_max_rel_err=grad_rel[worst_grad],
              its_leaf=worst_grad,
              median_leaf_rel_err=float(np.median(list(grad_rel.values()))),
              after_max_rel_err=after_rel[worst_after],
              after_leaf=worst_after,
              after_median_rel_err=float(np.median(list(
                  after_rel.values()))),
              logit_bound=RESNET_LOGIT_BOUND,
              grad_rel_bound=RESNET_GRAD_REL_BOUND,
              after_median_bound=RESNET_AFTER_MEDIAN_BOUND)
    logit_err, grad_err, after_err = readings["fp32"]
    if not logit_err <= RESNET_LOGIT_BOUND:
        fail("resnet step-1 logits on the card are %.3g from the CPU's; "
             "bound %g" % (logit_err, RESNET_LOGIT_BOUND))
    if not grad_err <= RESNET_GRAD_REL_BOUND:
        fail("resnet step-1 gradient %.3g from the CPU's, relative to its "
             "norm; bound %g" % (grad_err, RESNET_GRAD_REL_BOUND))
    if not after_err <= RESNET_AFTER_MEDIAN_BOUND:
        fail("resnet weights and running stats after %d steps: the median "
             "array %.3g from the CPU's, relative; bound %g"
             % (steps, after_err, RESNET_AFTER_MEDIAN_BOUND))


def one_bf16_step_up(net):
    """Move every parameter of the bf16 ``net`` one bf16 step away from
    zero (its bits plus one): a change the size of bf16's own rounding."""
    with torch.no_grad():
        for p in net.parameters():
            p.copy_((p.view(torch.int16) + 1).view(torch.bfloat16))


def bf16_controls(run, dev):
    """The bf16 card run's two controls: the same run in fp32 (the weights
    and data unrounded), and in bf16 from weights one bf16 step away."""
    return {"fp32_control": run(dev, "float32"),
            "bf16_step_control": run(dev, "bfloat16", step_up=True)}


def resnet_bf16_vs_cpu(dev):
    """Phase: resnet50_v1 from the same Xavier weights cast to bf16, on
    the card and on the CPU: the logits of the starting weights in
    inference mode, held at RESNET_BF16_PREDICT_BOUND between the card's
    bf16 reading and its two controls (``bf16_controls``); then
    RESNET_VS_CPU's batch and steps of the example's loop, each batch cast,
    whose step-1 logits and gradients and the arrays after the last step
    are printed beside the controls' (see RESNET_BF16_PREDICT_BOUND)."""
    from mxnet_tpu_torch import gluon, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import image_classification as ic

    B, side, steps = RESNET_VS_CPU
    args = resnet_args(B)
    batches = synthetic_batches(args, (3, side, side), "cpu", steps)
    start = new_resnet("cpu", 1).state_dict()

    def run(device, dtype, step_up=False):
        net = new_resnet(device, 1)
        net.load_state_dict(start)
        net.cast(dtype)
        if step_up:
            one_bf16_step_up(net)
        cast = getattr(torch, dtype)
        with torch.no_grad():
            predicted = net(batches[0][0].to(device, cast)).float().cpu()
        trainer = gluon.Trainer(net.named_parameters(), "sgd",
                                {"learning_rate": args.lr,
                                 "momentum": args.mom, "wd": args.wd})
        logits = []
        hook = net.register_forward_hook(
            lambda m, i, o: logits.append(o.detach().float().cpu()))
        losses, grads = [], None
        for x, y in batches:
            loss = ic.train_step(net, trainer, SoftmaxCrossEntropyLoss(),
                                 metric.Accuracy(), x.to(device, cast),
                                 y.to(device), B)
            losses.append(loss.float().mean().item())
            if grads is None:
                grads = {n: p.grad.detach().float().cpu()
                         for n, p in net.named_parameters()
                         if p.requires_grad}
        hook.remove()
        return predicted, logits[0], losses, grads, {
            n: t.detach().float().cpu() for n, t in net.state_dict().items()}

    want = run("cpu", "bfloat16")
    runs = {"bf16": run(dev, "bfloat16")}
    runs.update(bf16_controls(run, dev))
    predict_err = {}
    for label, got in runs.items():
        grad_rel = leaf_rel_errs(without_conv_biases(got[3]), want[3])
        after_rel = leaf_rel_errs(without_conv_biases(got[4]), want[4])
        worst_grad = max(grad_rel, key=grad_rel.get)
        predict_err[label] = (got[0] - want[0]).abs().max().item()
        if not all(np.isfinite(got[2])):
            fail("resnet_bf16_vs_cpu %s losses not finite: %s"
                 % (label, got[2]))
        phase("resnet_bf16_vs_cpu", run=label, batch=(B, 3, side, side),
              predict_logits_max_abs_err=predict_err[label],
              its_max_abs_logit=want[0].abs().max().item(),
              predict_bound=RESNET_BF16_PREDICT_BOUND, steps=steps,
              losses=json.dumps(list(zip(got[2], want[2]))),
              step1_logits_max_abs_err=(got[1] - want[1]).abs().max().item(),
              step1_grad_max_rel_err=grad_rel[worst_grad],
              its_leaf=worst_grad,
              median_leaf_rel_err=float(np.median(list(grad_rel.values()))),
              after_median_rel_err=float(np.median(list(
                  after_rel.values()))))
    if not predict_err["bf16"] <= RESNET_BF16_PREDICT_BOUND:
        fail("resnet bf16 inference logits on the card are %.3g from the "
             "CPU's; bound %g" % (predict_err["bf16"],
                                  RESNET_BF16_PREDICT_BOUND))


def lm_bf16_vs_cpu(cuda_ops, dev):
    """Phase: the LM, depth cut to VS_CPU's, cast to bf16 on the card and
    on the CPU from the same weights: step 1's loss and gradients, each
    leaf's relative gap held at LM_BF16_GRAD_REL_BOUND, between the card's
    bf16 reading and two controls (``bf16_controls``).  The card's bf16
    run must launch the kernel once a layer, in bf16."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    depth, B, T, _ = VS_CPU
    start = new_lm("cpu", depth, 1).state_dict()
    x, y = lm_batches(np.random.RandomState(1), 1, B, T, "cpu")[0]
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    ce = SoftmaxCrossEntropyLoss()

    def run(device, dtype, step_up=False):
        # built and loaded (the load fills the deferred shapes): no
        # forward runs before the counted one
        from mxnet_tpu_torch.models import TransformerLM

        net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=depth,
                            max_len=MAX_LEN, device=device)
        net.load_state_dict(start)
        net.cast(dtype)
        if step_up:
            one_bf16_step_up(net)
        loss = forward_backward(net, ce, x.to(device), y.to(device),
                                pos.to(device))
        return loss.item(), {n: p.grad.float().cpu()
                             for n, p in net.named_parameters()}

    want = run("cpu", "bfloat16")
    reset_launches(cuda_ops)
    runs = {"bf16": run(dev, "bfloat16")}
    by_dtype = dict(cuda_ops.flash_attention.launches_by_dtype)
    if by_dtype != {"float32": 0, "bfloat16": depth}:
        fail("lm_bf16_vs_cpu: flash_attention launches %s, not %d in bf16"
             % (by_dtype, depth))
    runs.update(bf16_controls(run, dev))
    readings = {}
    for label, (loss, grads) in runs.items():
        rel = leaf_rel_errs(grads, want[1])
        worst = max(rel, key=rel.get)
        readings[label] = rel[worst]
        phase("lm_bf16_vs_cpu", run=label, depth=depth, batch=(B, T),
              loss=loss, cpu_loss=want[0], step1_grad_max_rel_err=rel[worst],
              its_leaf=worst,
              median_leaf_rel_err=float(np.median(list(rel.values()))),
              rel_bound=LM_BF16_GRAD_REL_BOUND,
              launches_by_dtype=json.dumps(by_dtype))
    if not readings["bf16"] <= LM_BF16_GRAD_REL_BOUND:
        fail("lm bf16 step-1 gradient %.3g from the CPU's, relative to its "
             "norm; bound %g" % (readings["bf16"], LM_BF16_GRAD_REL_BOUND))


# ---------------------------------------------------------------------------
# the imperative API (mx.nd): its ops, and the LM's step written in them

ND_LM_B, ND_LM_T = 2, 256   # nd_ops' LM activations: VS_CPU's batch
# ResNet-50's stage-1 bottleneck: batch, side, channels in and out
ND_RES = (32, 56, 64, 256)


# ftrl_update's z takes (sqrt(n + g^2) - sqrt(n)) / lr * w: a square root
# one ulp (2^-23 below 2) apart between the card's and the CPU's kernels
# moves it by 2^-23 * max|w| / lr (2.38e-6 at the case's |w| <= 2, lr 0.1,
# a chip probe's reading), two roots twice that
FTRL_ATOL = 2 * 2.0 ** -23 * 2.0 / 0.1


def nd_cases():
    """(op, inputs, attrs, differentiable inputs, tolerance) for every
    canonical op of the registry, at one real shape: ResNet-50's stage-1
    bottleneck (B = 32, 56 x 56, 64 and 256 channels, and its 2048 -> 1000
    head), and the LM at the bench widths over VS_CPU's batch.  Inputs are
    numpy arrays from a seed.  Tolerances: FP32_BOUND's rtol for the
    elementwise, shape and update ops; SERVE_ATOL/RTOL for the reductions,
    GEMMs, convolutions and normalizations (fp32 sums reordered); the
    kernel's FP32_BOUND for attention.  Input gradients, sums reordered
    on the card (a broadcast input's, a weight's over the batch), as
    train_vs_cpu holds a leaf: the gap's norm within GRAD_REL_BOUND of the
    gradient's; attention's at GRAD_BOUND."""
    rng = np.random.RandomState(0)

    def f(*shape, low=-2.0, high=2.0):
        return rng.uniform(low, high, shape).astype(np.float32)

    B, S, C, C4 = ND_RES
    Bt, T = ND_LM_B, ND_LM_T
    elem = (FP32_BOUND, 1e-6)
    gemm = (SERVE_RTOL, SERVE_ATOL)
    act, pos = f(Bt, T, DIM), f(Bt, T, DIM, low=0.3, high=2.0)
    row = f(1, 1, DIM, low=0.5, high=1.5)
    img, wide = f(B, C, S, S), f(B, C4, S, S)
    cases = [(n, [act], {}, [0], elem) for n in (
        "abs", "sign", "round", "ceil", "floor", "square", "exp", "tanh",
        "negative", "sigmoid", "relu", "identity", "BlockGrad",
        "make_loss", "zeros_like", "ones_like")]
    cases += [(n, [pos], {}, [0], elem) for n in ("sqrt", "log")]
    cases.append(("Cast", [act], {"dtype": "bfloat16"}, [0], elem))
    for n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_div", "broadcast_power",
              "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
              "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser",
              "broadcast_lesser_equal", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor", "arctan2",
              "ldexp"):
        cases.append((n, [pos, row], {}, [0, 1], elem))
    # a remainder jumps where the quotient is whole: keep the inputs off it
    cases.append(("broadcast_mod", [row * (rng.randint(0, 3, act.shape)
                                            + rng.uniform(0.1, 0.9,
                                                          act.shape)
                                            ).astype(np.float32), row],
                  {}, [0, 1], elem))
    cases.append(("_mod_scalar", [1.5 * (rng.randint(0, 3, act.shape)
                                         + rng.uniform(0.1, 0.9, act.shape)
                                         ).astype(np.float32)],
                  {"scalar": 1.5}, [0], elem))
    for n in ("_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
              "_power_scalar", "_maximum_scalar",
              "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
              "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
              "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar"):
        cases.append((n, [pos], {"scalar": 1.5}, [0], elem))
    qkv = f(Bt, T, 3 * DIM)
    heads = f(Bt, HEADS, T, DIM // HEADS)
    cases += [
        ("Reshape", [qkv[..., :DIM]], {"shape": (0, 0, HEADS, -1)}, [0],
         elem),
        ("Flatten", [f(B, 2048, 1, 1)], {}, [0], elem),
        ("transpose", [heads], {"axes": (0, 2, 1, 3)}, [0], elem),
        ("expand_dims", [act], {"axis": 1}, [0], elem),
        ("SliceChannel", [qkv], {"num_outputs": 3, "axis": -1}, [0], elem),
        ("Concat", [act, act], {"dim": 1}, [0, 1], elem),
        ("stack", [act, act], {"axis": 0}, [0, 1], elem),
        ("Embedding", [rng.randint(0, VOCAB, (Bt, T)).astype(np.int32),
                       f(VOCAB, DIM, low=-0.1, high=0.1)], {}, [1], gemm),
        ("one_hot", [rng.randint(0, 1000, B).astype(np.int32)],
         {"depth": 1000}, [], elem),
        ("dot", [act.reshape(-1, DIM), f(DIM, 3 * DIM, low=-0.1,
                                         high=0.1)], {}, [0, 1], gemm),
        ("batch_dot", [heads.reshape(-1, T, DIM // HEADS),
                       heads.reshape(-1, T, DIM // HEADS)],
         {"transpose_b": True}, [0, 1], gemm),
        # TinyGluonLM's positions: the table cut to a (T, B, H) batch
        ("slice_like", [f(MAX_LEN, DIM), np.ascontiguousarray(
            act.transpose(1, 0, 2))], {"axes": (0,)}, [0], elem),
        ("_zeros", [], {"shape": (Bt, T, DIM)}, [], elem),
        ("_ones", [], {"shape": (B, C4)}, [], elem),
        ("_arange", [], {"start": 0, "stop": MAX_LEN}, [], elem),
    ]
    near_one = f(Bt, T, DIM, low=0.9, high=1.1)   # a product stays finite
    for n in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
        cases.append((n, [near_one if n.endswith("prod") else act],
                       {"axis": -1}, [0], gemm))
    logits = f(Bt * T, VOCAB)
    labels = rng.randint(0, VOCAB, Bt * T).astype(np.float32)
    cases += [
        ("argmax", [logits], {"axis": 1}, [], elem),
        ("pick", [logits, labels], {"axis": 1}, [0], elem),
        ("FullyConnected", [act, f(3 * DIM, DIM, low=-0.05, high=0.05)],
         {"no_bias": True, "flatten": False}, [0, 1], gemm),
        ("FullyConnected", [f(B, 2048), f(1000, 2048, low=-0.05, high=0.05),
                            f(1000)], {}, [0, 1, 2], gemm),
        ("Convolution", [img, f(C4, C, 1, 1, low=-0.2, high=0.2)],
         {"kernel": (1, 1), "no_bias": True}, [0, 1], gemm),
        ("Convolution", [img, f(C, C, 3, 3, low=-0.1, high=0.1)],
         {"kernel": (3, 3), "pad": (1, 1), "no_bias": True}, [0, 1], gemm),
        ("Convolution", [np.ascontiguousarray(img.transpose(0, 2, 3, 1)),
                         f(C, 3, 3, C, low=-0.1, high=0.1), f(C)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "layout": "NHWC"}, [0, 1, 2], gemm),
        ("Pooling", [img], {"kernel": (3, 3), "stride": (2, 2),
                            "pad": (1, 1)}, [0], elem),
        ("Pooling", [wide], {"global_pool": True, "pool_type": "avg",
                             "kernel": (1, 1)}, [0], gemm),
        ("BatchNorm", [wide, f(C4, low=0.5, high=1.5), f(C4), f(C4),
                       f(C4, low=0.5, high=1.5)],
         {"fix_gamma": False, "eps": 1e-5, "_training": True}, [0, 1, 2],
         gemm),
        ("LayerNorm", [act, f(DIM, low=0.5, high=1.5), f(DIM)], {},
         [0, 1, 2], gemm),
        ("Activation", [wide], {"act_type": "relu"}, [0], elem),
        ("LeakyReLU", [act], {"act_type": "gelu"}, [0], elem),
        ("LeakyReLU", [img, f(C, low=0.1, high=0.5)],
         {"act_type": "prelu"}, [0, 1], gemm),
        ("softmax", [logits], {}, [0], gemm),
        ("log_softmax", [logits], {}, [0], gemm),
        ("SoftmaxOutput", [f(B, 1000), rng.randint(0, 1000, B).astype(
            np.float32)], {"normalization": "batch"}, [0], gemm),
        ("softmax_cross_entropy", [logits, labels], {}, [0], gemm),
        ("_contrib_flash_attention", [heads, heads, heads],
         {"causal": True}, [0, 1, 2], (0.0, FP32_BOUND, GRAD_BOUND)),
    ]
    w, g = f(3 * DIM, DIM), f(3 * DIM, DIM)
    s1, s2 = f(3 * DIM, DIM), f(3 * DIM, DIM, low=0, high=1)
    common = {"lr": 0.1, "wd": 1e-4, "rescale_grad": 0.5,
              "clip_gradient": 0.3}
    cases += [
        ("sgd_update", [w, g], common, [], elem),
        ("sgd_mom_update", [w, g, s1], dict(common, momentum=0.9), [], elem),
        ("mp_sgd_update", [w, g, s1], common, [], elem),
        ("mp_sgd_mom_update", [w, g, s1, s2], dict(common, momentum=0.9),
         [], elem),
        ("adam_update", [w, g, s1, s2], dict(common, lr=TRAIN_LR), [],
         elem),
        ("rmsprop_update", [w, g, s2], dict(common, gamma1=0.9), [], elem),
        ("rmspropalex_update", [w, g, s2 + 1.0, 0.1 * s1, s1],
         dict(common, gamma1=0.9, gamma2=0.9), [], elem),
        ("ftrl_update", [w, g, s1, s2], dict(common, lamda1=0.3), [],
         (FP32_BOUND, FTRL_ATOL)),
        ("signsgd_update", [w, g], common, [], elem),
        ("signum_update", [w, g, s1], dict(common, momentum=0.9,
                                          wd_lh=0.01), [], elem),
        ("ftml_update", [w, g, s2 + 0.1, s2, s1], dict(common, t=3), [],
         elem),
        ("_contrib_group_adagrad_update", [w, g, s2[:, :1]], common, [],
         elem),
        ("_sparse_adagrad_update", [w, g, s2], common, [], elem),
        # a DCGAN generator's upsampling layer
        ("Deconvolution", [f(B, 128, 16, 16), f(128, C, 4, 4, low=-0.1,
                                                high=0.1), f(C)],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
          "num_filter": C, "no_bias": False}, [0, 1, 2], gemm),
    ]
    # Dropout at the LM's activations, the zoo's and the losses' ops, and
    # the draws (each run seeded alike on both devices)
    exact = (0.0, 0.0)
    probs = f(Bt, 10, low=0.05, high=1.0)
    ctc_label = rng.randint(0, 39, (8, 20)).astype(np.float32)
    ctc_label[:, 15:] = -1
    cases += [
        ("Dropout", [act], {"p": 0.1, "_training": True}, [0], elem),
        ("InstanceNorm", [img, f(C, low=0.5, high=1.5), f(C)],
         {"eps": 1e-5}, [0, 1, 2], gemm),
        ("Pad", [img], {"mode": "reflect",
                        "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}, [0], elem),
        ("clip", [act], {"a_min": -1.0, "a_max": 1.0}, [0], elem),
        ("where", [np.where(act > 0, 1.0, 0.0).astype(np.float32), act,
                   pos], {}, [1, 2], elem),
        ("reshape_like", [act, f(Bt * T, DIM)], {}, [0], elem),
        ("CTCLoss", [f(100, 8, 40), ctc_label], {"blank_label": "last"},
         [0], gemm),
        ("_random_uniform", [], {"low": -1.0, "high": 1.0,
                                 "shape": (Bt, T, DIM)}, [], exact),
        ("_random_normal", [], {"shape": (Bt, T, DIM)}, [], elem),
        ("_random_exponential", [], {"lam": 2.0, "shape": (Bt, T, DIM)},
         [], elem),
        ("_random_randint", [], {"low": 0, "high": VOCAB,
                                 "shape": (Bt, T)}, [], exact),
        ("_sample_uniform", [f(Bt, low=-1.0, high=0.0), f(Bt, low=1.0)],
         {"shape": (T,)}, [0, 1], elem),
        ("_sample_normal", [f(Bt), f(Bt, low=0.5, high=1.5)],
         {"shape": (T,)}, [0, 1], elem),
        ("_sample_exponential", [f(Bt, low=0.5, high=2.0)],
         {"shape": (T,)}, [0], elem),
        ("_sample_multinomial", [probs / probs.sum(1, keepdims=True)],
         {"shape": (4,), "get_prob": True}, [], elem),
        ("_shuffle", [f(Bt * T, 4)], {}, [], exact),
    ]
    return cases + nd_cases_int8_slice(f, rng)


# outputs unique up to each row's sign: LAPACK (the CPU) and cuSOLVER (the
# card) may choose either; nd_ops compares them with each row's largest
# entry made positive (gelqf's L columns follow its Q rows)
SIGNED_ROWS = ("_linalg_syevd", "_linalg_gelqf")


def unsigned_rows(name, outs):
    """``outs`` of ``name`` with the sign of each eigenvector / Q row (and
    L column) fixed by its largest entry."""
    if name not in SIGNED_ROWS:
        return outs
    rows = outs[0] if name == "_linalg_syevd" else outs[1]
    pick = np.take_along_axis(rows, np.abs(rows).argmax(-1)[..., None], -1)
    sign = np.where(pick < 0, -1.0, 1.0).astype(rows.dtype)
    if name == "_linalg_syevd":
        return [outs[0] * sign, outs[1]]
    return [outs[0] * np.swapaxes(sign, -1, -2), outs[1] * sign]


def nd_cases_int8_slice(f, rng):
    """The registry names of the int8 slice (elementwise, reductions,
    shape and index ops, orderings, linalg, nn, the image and small contrib
    ops, the quantized ops) at the same shapes: the LM's activations, the
    ResNet-50 stage-1 bottleneck and its head, batches of 64 x 64 matrices
    for linalg.  Tolerances as nd_cases'."""
    B, S, C, C4 = ND_RES
    Bt, T = ND_LM_B, ND_LM_T
    D = DIM // HEADS
    elem = (FP32_BOUND, 1e-6)
    gemm = (SERVE_RTOL, SERVE_ATOL)
    exact = (0.0, 0.0)
    act = f(Bt, T, DIM)
    pos = f(Bt, T, DIM, low=0.3, high=2.0)
    unit = f(Bt, T, DIM, low=-0.9, high=0.9)
    away = (rng.uniform(0.3, 2.0, act.shape)
            * rng.choice([-1, 1], act.shape)).astype(np.float32)
    special = act.copy()
    special[0, :8, 0] = [np.nan, np.inf, -np.inf, np.nan, 0, 1, np.inf, -2]
    img, wide = f(B, C, S, S), f(B, C4, S, S)
    heads = f(Bt, HEADS, T, D)
    cases = [(n, [act], {}, [0], elem) for n in (
        "sin", "cos", "arctan", "sinh", "cosh", "arcsinh", "degrees",
        "radians", "erf", "expm1", "softsign", "rint", "fix", "trunc",
        "hard_sigmoid", "smooth_l1", "IdentityAttachKLSparseReg",
        "_contrib_quadratic")]
    cases += [("tan", [f(Bt, T, DIM, low=-1.2, high=1.2)], {}, [0], elem),
              ("arccosh", [f(Bt, T, DIM, low=1.2, high=3.0)], {}, [0], elem)]
    cases += [(n, [unit], {}, [0], elem)
              for n in ("arcsin", "arccos", "arctanh", "erfinv")]
    cases += [(n, [pos], {}, [0], elem)
              for n in ("log10", "log2", "log1p", "rsqrt", "reciprocal")]
    cases += [(n, [away], {}, [0], elem) for n in ("cbrt", "rcbrt")]
    cases += [(n, [f(Bt, T, DIM, low=0.2, high=5.0)], {}, [0], elem)
              for n in ("gamma", "gammaln")]
    cases += [(n, [special], {}, [], exact) for n in ("isnan", "isinf")]
    cases += [("logical_not", [np.round(act)], {}, [0], elem),
              ("add_n", [act, pos, unit], {}, [0, 1, 2], elem),
              ("_square_sum", [act], {"axis": -1}, [0], gemm),
              ("norm", [act], {"axis": -1}, [0], gemm),
              ("argmin", [act], {"axis": -1}, [], elem),
              ("argmax_channel", [wide], {}, [], elem)]
    # shape, index and ordering ops on the LM's activations
    perm = rng.permutation(Bt * T)
    points = np.stack([perm // T, perm % T]).astype(np.float32)
    n_rows = min(100, T)
    rows = np.stack([rng.randint(0, Bt, n_rows),
                     rng.permutation(T)[:n_rows]]).astype(np.float32)
    table = f(1000, DIM)
    ids = rng.randint(-10, 1010, (Bt, T)).astype(np.float32)
    cases += [
        ("SwapAxis", [heads], {"dim1": 1, "dim2": 2}, [0], elem),
        ("squeeze", [f(B, 2048, 1, 1)], {"axis": (2, 3)}, [0], elem),
        ("shape_array", [act], {}, [], exact),
        ("size_array", [act], {}, [], exact),
        ("broadcast_to", [f(1, 1, DIM)], {"shape": (Bt, T, DIM)}, [0],
         gemm),
        ("broadcast_like", [f(1, 1, DIM), act], {}, [0], gemm),
        ("broadcast_axis", [f(Bt, 1, DIM)], {"axis": 1, "size": T}, [0],
         gemm),
        ("slice", [act], {"begin": (None, 200, 0), "end": (None, 10, DIM),
                          "step": (1, -2, 3)}, [0], elem),
        ("slice_axis", [act], {"axis": 1, "begin": 5, "end": 100}, [0],
         elem),
        ("reverse", [act], {"axis": 1}, [0], elem),
        ("repeat", [f(Bt, T, 64)], {"repeats": 2, "axis": 1}, [0], elem),
        ("tile", [f(Bt, 1, DIM)], {"reps": (1, 4, 1)}, [0], gemm),
        ("diag", [f(DIM, DIM)], {"k": 1}, [0], elem),
        ("take", [table, ids], {"mode": "clip"}, [0], gemm),
        ("take", [table, ids], {"mode": "wrap"}, [0], gemm),
        ("batch_take", [f(Bt * T, 1000), ids.reshape(-1)], {}, [0], elem),
        ("gather_nd", [act, points], {}, [0], elem),
        ("scatter_nd", [f(Bt * T, DIM), points], {"shape": (Bt, T, DIM)},
         [0], elem),
        ("_scatter_set_nd", [act, rows, f(n_rows, DIM)], {}, [0, 2],
         elem),
        ("sort", [act], {"axis": -1, "is_ascend": False}, [0], elem),
        ("argsort", [act], {"axis": -1}, [], elem),
        ("topk", [act], {"k": 5, "ret_typ": "both"}, [0], elem),
        ("khatri_rao", [f(64, 32), f(32, 32)], {}, [0, 1], elem),
        ("_full", [], {"shape": (Bt, T, DIM), "value": 0.5}, [], elem),
        ("_eye", [], {"N": DIM, "k": 1}, [], elem),
        ("space_to_depth", [img], {"block_size": 2}, [0], elem),
        ("depth_to_space", [wide], {"block_size": 2}, [0], elem),
        ("ravel_multi_index", [rng.randint(0, S, (2, 1000)).astype(
            np.float32)], {"shape": (S, S)}, [], exact),
        ("unravel_index", [rng.randint(0, S * S, 1000).astype(np.float32)],
         {"shape": (S, S)}, [], exact),
    ]
    # linalg on a batch of 16 matrices of 64 x 64
    n = 64
    a = rng.uniform(-1, 1, (16, n, n)).astype(np.float32)
    spd = (a @ np.swapaxes(a, -1, -2) / n + np.eye(n)).astype(np.float32)
    # eigenvalues 1 apart, so that each eigenvector is well conditioned
    basis = np.linalg.qr(rng.normal(0, 1, (16, n, n)))[0]
    spread = (basis * np.arange(1, n + 1)) @ np.swapaxes(basis, -1, -2)
    spread = ((spread + np.swapaxes(spread, -1, -2)) / 2).astype(np.float32)
    low = np.tril(f(16, n, n, low=-0.1, high=0.1)) + np.eye(
        n, dtype=np.float32)
    near = (np.eye(8) + 0.1 * rng.uniform(-1, 1, (16, 8, 8))).astype(
        np.float32)
    lin = (1e-4, 1e-4)   # tests/test_registry_ops_r6.py
    cases += [
        ("_linalg_gemm", [a, a, a], {"transpose_b": True, "alpha": 0.5},
         [0, 1, 2], gemm),
        ("_linalg_gemm2", [a, a], {"transpose_a": True}, [0, 1], gemm),
        ("_linalg_potrf", [spd], {}, [0], lin),
        ("_linalg_potri", [low], {}, [0], lin),
        ("_linalg_trsm", [low, a], {"rightside": True}, [0, 1], lin),
        ("_linalg_trmm", [low, a], {"transpose": True}, [0, 1], gemm),
        ("_linalg_syrk", [a], {"alpha": 2.0}, [0], gemm),
        ("_linalg_gelqf", [a[:, :32]], {}, [], lin),
        ("_linalg_syevd", [spread], {}, [], lin),
        ("_linalg_sumlogdiag", [spd], {}, [0], lin),
        ("_linalg_extractdiag", [a], {}, [0], elem),
        ("_linalg_makediag", [a[:, 0]], {}, [0], elem),
        ("_linalg_extracttrian", [a], {"offset": -1}, [0], elem),
        ("_linalg_inverse", [near], {}, [0], lin),
        ("_linalg_det", [near], {}, [0], lin),
        ("_linalg_slogdet", [near], {}, [0], lin),
    ]
    # nn, image and contrib ops at the ResNet and LM shapes
    img, wide = img[:8], wide[:8]   # the stage's shapes at 8 images
    t_first = np.ascontiguousarray(act.transpose(1, 0, 2))
    lens = np.array([T, T // 3], np.float32)
    labels = rng.randint(0, 1000, B).astype(np.float32)
    qkv = f(T, Bt, 3 * DIM)
    att = rng.uniform(0, 1, (Bt * HEADS, T, T)).astype(np.float32)
    cases += [
        ("UpSampling", [img], {"scale": 2, "sample_type": "nearest"}, [0],
         elem),
        ("UpSampling", [img, f(C, 1, 4, 4)], {"scale": 2, "num_filter": C,
                                              "sample_type": "bilinear"},
         [0, 1], gemm),
        ("L2Normalization", [img], {}, [0], gemm),
        ("LRN", [img], {"nsize": 5}, [0], gemm),
        ("softmin", [act], {}, [0], gemm),
        ("SoftmaxActivation", [img], {"mode": "channel"}, [0], gemm),
        ("LinearRegressionOutput", [f(B, 1000), f(B, 1000)], {}, [0], elem),
        ("MAERegressionOutput", [f(B, 1000), f(B, 1000)], {}, [0], elem),
        ("LogisticRegressionOutput", [f(B, 1000), f(B, 1000, low=0,
                                                    high=1)], {}, [0], elem),
        ("SequenceMask", [act, lens], {"use_sequence_length": True,
                                       "axis": 1}, [0], elem),
        ("SequenceLast", [act, lens], {"use_sequence_length": True,
                                       "axis": 1}, [0], elem),
        ("SequenceReverse", [t_first, lens],
         {"use_sequence_length": True}, [0], elem),
        ("MakeLoss", [act], {"normalization": "batch"}, [0], elem),
        ("SVMOutput", [f(B, 1000), labels], {}, [0], gemm),
        ("Crop", [img], {"h_w": (28, 28), "center_crop": True}, [0], elem),
        ("_histogram", [act], {"bin_cnt": 100, "range": (-2.0, 2.0)}, [],
         exact),
        ("_image_to_tensor", [rng.randint(0, 256, (B, 224, 224, 3)).astype(
            np.uint8)], {}, [], elem),
        ("_image_normalize", [f(B, 3, 224, 224)],
         {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
         [0], elem),
        ("_contrib_index_copy", [table, rng.permutation(1000)[:100].astype(
            np.float32), f(100, DIM)], {}, [0, 2], elem),
        ("_contrib_AdaptiveAvgPooling2D", [wide], {"output_size": 7}, [0],
         gemm),
        ("_contrib_BilinearResize2D", [img], {"height": 112, "width": 112},
         [0], gemm),
        ("_contrib_count_sketch", [f(B, 2048), rng.randint(
            0, 1000, (1, 2048)).astype(np.float32), rng.choice(
            [-1.0, 1.0], (1, 2048)).astype(np.float32)], {"out_dim": 1000},
         [0], gemm),
        ("_contrib_fft", [f(B, 1024)], {}, [0], gemm),
        ("_contrib_ifft", [f(B, 2048)], {}, [0], gemm),
        ("_contrib_interleaved_matmul_selfatt_qk", [qkv], {"heads": HEADS},
         [0], gemm),
        ("_contrib_interleaved_matmul_selfatt_valatt", [qkv, att],
         {"heads": HEADS}, [0, 1], gemm),
        ("_contrib_div_sqrt_dim", [heads], {}, [0], elem),
    ]
    # the quantized ops (quantized_ops_vs_cpu holds them at more shapes)
    rd = [np.array([v], np.float32) for v in (-2.5, 3.0, -0.7, 0.4)]
    q8 = rng.randint(-127, 128, (B, C, S, S)).astype(np.int8)
    cases += [
        ("_contrib_quantize", [img] + rd[:2], {"out_type": "int8"}, [],
         exact),
        ("_contrib_quantize_v2", [img], {}, [], exact),
        ("_contrib_dequantize", [q8] + rd[:2], {}, [], exact),
        ("_contrib_requantize", [rng.randint(-2 ** 30, 2 ** 30, (B, 1000))
                                 .astype(np.int32)] + rd[:2], {}, [], exact),
        ("_contrib_quantized_conv", [q8, rng.randint(-127, 128, (C4, C, 1, 1))
                                     .astype(np.int8)] + rd,
         {"kernel": (1, 1), "num_filter": C4, "no_bias": True}, [], exact),
        ("_contrib_quantized_fully_connected",
         [rng.randint(-127, 128, (B, 2048)).astype(np.int8),
          rng.randint(-127, 128, (1000, 2048)).astype(np.int8)] + rd,
         {"num_hidden": 1000, "no_bias": True}, [], exact),
        ("_contrib_quantized_flatten", [q8] + rd[:2], {}, [], exact),
        ("_contrib_quantized_pooling", [q8] + rd[:2],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}, [], exact),
    ]
    # the recurrent op at LSTM-PTB's widths (2 x 200, B 32, the word LM's
    # T 35), dropout between the layers in training, and its begin state
    H = LSTM_PTB["num_hidden"]
    blob = 2 * 4 * H * (H + H) + 2 * 2 * 4 * H
    seq = f(35, 32, H, low=-1.0, high=1.0)
    cases += [("RNN", [seq, f(blob, low=-0.07, high=0.07),
                       f(2, 32, H, low=-0.5, high=0.5),
                       f(2, 32, H, low=-0.5, high=0.5)],
               {"state_size": H, "num_layers": 2, "mode": "lstm",
                "state_outputs": True, "p": 0.2, "_training": True},
               [0, 1, 2, 3], gemm),
              ("_rnn_state_like", [seq], {"shape": (2, 0, H),
                                          "ref_axis": 1}, [], exact)]
    return cases


# registered so that they raise, naming themselves: not ported yet
UNPORTED_DRAWS = ("_random_gamma", "_random_poisson",
                  "_random_negative_binomial",
                  "_random_generalized_negative_binomial", "_sample_gamma",
                  "_sample_poisson")


def nd_run(name, inputs, attrs, grads, device, seed):
    """``nd.<name>`` on ``device``, ``mx.random.seed(seed)`` first: its
    outputs and the gradients of the inputs at ``grads`` under head
    gradients drawn from ``seed``, on the CPU.  ``_training`` in ``attrs`` records in training mode.  The call
    runs in ``device``'s scope, where a creator (an op of no input) makes
    its array."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)   # an op that draws takes the same key on each
    arrays = [mx.nd.array(a, ctx=device, dtype=a.dtype) for a in inputs]
    for i in grads:
        arrays[i].attach_grad()
    training = attrs.pop("_training", False)
    with mx.autograd.record(train_mode=training), torch.device(device):
        out = getattr(mx.nd, name)(*arrays, **attrs)
    outs = out if isinstance(out, list) else [out]
    if name == "BatchNorm":
        outs = outs[:1]   # MXNet passes no gradient through its statistics
    rng = np.random.RandomState(seed)
    pairs = [(o, mx.nd.array(rng.normal(0, 1, o.shape).astype(np.float32),
                             ctx=device, dtype=o.dtype))
             for o in outs if o._data.requires_grad]
    if pairs and grads:
        mx.autograd.backward([o for o, _ in pairs], [h for _, h in pairs])
    return ([o.astype("float32").asnumpy() for o in outs],
            [arrays[i].grad.asnumpy() for i in grads])


def nd_ops(dev):
    """Phase: every canonical op of the registry through ``mx.nd`` on the
    card against the same call on the CPU (the port's CPU path), values
    and input gradients under seeded head gradients."""
    from mxnet_tpu_torch.ops.registry import get_op, list_ops

    t0 = time.time()
    worst, worst_rel, seen = {}, {}, set()
    for seed, (name, inputs, attrs, grads, tol) in enumerate(nd_cases()):
        seen.add(get_op(name))
        want = nd_run(name, inputs, dict(attrs), grads, "cpu", seed)
        got = nd_run(name, inputs, dict(attrs), grads, dev, seed)
        for k, (g, w) in enumerate(zip(unsigned_rows(name, got[0]),
                                       unsigned_rows(name, want[0]))):
            if g.shape != w.shape:
                fail("nd_ops %s output %d: shape %s on the card, %s on the "
                     "CPU" % (name, k, g.shape, w.shape))
            finite = np.isfinite(w)
            err = float(np.max(np.abs(g - w)[finite], initial=0.0))
            worst[name] = max(worst.get(name, 0.0), err)
            if not np.allclose(g, w, rtol=tol[0], atol=tol[1],
                               equal_nan=True):
                fail("nd_ops %s output %d: card vs CPU max abs err %.3g "
                     "over rtol %g atol %g" % (name, k, err, *tol[:2]))
        for i, g, w in zip(grads, got[1], want[1]):
            if len(tol) > 2:   # attention: the kernel's gradient bound
                err = float(np.abs(g - w).max())
                ok = err < tol[2]
            else:   # a leaf's relative gap, as train_vs_cpu holds it
                w = w.astype(np.float64)
                err = float(np.linalg.norm(g - w))
                ok = err <= GRAD_REL_BOUND * np.linalg.norm(w) \
                    and np.isfinite(np.linalg.norm(w))
                err /= max(float(np.linalg.norm(w)), 1e-30)
            worst_rel[name] = max(worst_rel.get(name, 0.0), err)
            if not ok:
                fail("nd_ops %s: gradient of input %d, card vs CPU %.3g "
                     "(relative to its norm; bound %g)"
                     % (name, i, err, tol[2] if len(tol) > 2
                        else GRAD_REL_BOUND))
    # the detection ops are held in detection_ops_vs_cpu
    missing = {n for n in list_ops() if get_op(n) not in seen
               and n not in UNPORTED_DRAWS and n not in DETECTION_OPS}
    if missing:
        fail("nd_ops covers no case of %s" % sorted(missing))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    top_grad = sorted(worst_rel.items(), key=lambda kv: -kv[1])[:6]
    phase("nd_ops", ops=len(worst), registered_names=len(list_ops()),
          shapes="resnet50_stage1=%s lm=%s" % (ND_RES, (ND_LM_B, ND_LM_T,
                                                        DIM)),
          worst_abs_err=json.dumps(top),
          worst_grad_rel_err=json.dumps(top_grad),
          grad_rel_bound=GRAD_REL_BOUND,
          seconds=round(time.time() - t0, 2))


def nd_params(net, dev):
    """The Gluon model's parameters as NDArrays on ``dev`` (copies) that
    take gradients, under the same names."""
    import mxnet_tpu_torch as mx

    params = {n: mx.nd.array(p.detach(), ctx=dev)
              for n, p in net.named_parameters()}
    for w in params.values():
        w.attach_grad()
    return params


def nd_batches(batches):
    import mxnet_tpu_torch as mx

    return [(mx.nd.NDArray(x), mx.nd.NDArray(y)) for x, y in batches]


def nd_lm(cuda_ops, dev, card, train_losses):
    """Phase: the full-width LM's training step written in ``mx.nd`` ops
    (``models/transformer_lm_nd.py``: ``nd.FullyConnected``,
    ``nd.LayerNorm``, ``nd._contrib_flash_attention`` ...,
    ``autograd.backward``, ``nd.adam_update``), TRAIN_STEPS Adam steps at
    TRAIN_LR from the weights and batches of the ``train`` phase.  Holds
    step 1's loss and every leaf's gradient to the Gluon path's on the card
    (GRAD_REL_BOUND) and the kernel's launches to one a layer per
    forward; prints the loss curve beside ``train``'s, the median step,
    tokens/s, peak memory, the invokes of a step and the host's time per
    invoke."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import transformer_lm_nd as lm_nd
    from mxnet_tpu_torch.ops import registry

    net = new_lm(dev, DEPTH, 0)
    batches = lm_batches(np.random.RandomState(0), TRAIN_STEPS + 1,
                         TRAIN_B, MAX_LEN, dev)
    pos = torch.arange(MAX_LEN, device=dev,
                       dtype=torch.int32).expand(TRAIN_B, MAX_LEN)
    gluon_loss = forward_backward(net, SoftmaxCrossEntropyLoss(),
                                  *batches[0], pos).item()
    gluon_grads = {n: p.grad.detach().clone()
                   for n, p in net.named_parameters()}
    params = nd_params(net, dev)
    del net
    states = lm_nd.adam_states(mx, params)
    nd_pos = mx.nd.NDArray(pos)
    data = nd_batches(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(cuda_ops)
    losses, step_ms, launches_per_step = [], [], []
    for t, (x, y) in enumerate(data[:TRAIN_STEPS], start=1):
        before = cuda_ops.flash_attention.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = lm_nd.train_step(mx, params, states, t, x, y, nd_pos, HEADS,
                                TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss.asscalar()))
        step_ms.append(start.elapsed_time(end))
        launches_per_step.append(cuda_ops.flash_attention.launches - before)
        if t == 1:
            rel = leaf_rel_errs({n: w.grad._data for n, w in
                                 params.items()},
                                {n: g.cpu() for n, g in gluon_grads.items()})
            del gluon_grads
    launches = cuda_ops.flash_attention.launches
    by_dtype = dict(cuda_ops.flash_attention.launches_by_dtype)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)):
        fail("nd_lm losses not finite: %s" % losses)
    if launches_per_step != [DEPTH] * TRAIN_STEPS \
            or by_dtype["float32"] != launches:
        fail("nd_lm: flash_attention launched %s times a step (%s), not "
             "once a layer (%d) in fp32" % (launches_per_step, by_dtype,
                                           DEPTH))
    if not abs(losses[0] - gluon_loss) <= SERVE_ATOL + SERVE_RTOL * abs(
            gluon_loss):
        fail("nd_lm step-1 loss %.6f, Gluon path %.6f" % (losses[0],
                                                          gluon_loss))
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL_BOUND:
        fail("nd_lm step-1 gradient of %s is %.3g from the Gluon path's, "
             "relative to its norm; bound %g" % (worst, rel[worst],
                                                 GRAD_REL_BOUND))
    # one more step, split and counted: the forward's host time, and the
    # invokes of the forward and of the update (the counting wraps
    # Op.apply outside the timed steps)
    calls = [0]
    apply = registry.Op.apply

    def counted(self, attrs, *tensors):
        calls[0] += 1
        return apply(self, attrs, *tensors)

    x, y = data[TRAIN_STEPS]
    registry.Op.apply = counted
    try:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        with mx.autograd.record():
            out = lm_nd.loss(mx.nd, lm_nd.forward(mx.nd, params, x, nd_pos,
                                                  HEADS), y)
        h1 = time.perf_counter()
        fwd_invokes = calls[0]
        out.backward()
        torch.cuda.synchronize()
        h2 = time.perf_counter()
        for name, w in params.items():
            m, v = states[name]
            mx.nd.adam_update(w, w.grad, m, v, out=w, lr=TRAIN_LR)
        h3 = time.perf_counter()
        torch.cuda.synchronize()
    finally:
        registry.Op.apply = apply
    update_invokes = calls[0] - fwd_invokes
    # the dispatch's own cost: nd's a + b against torch's on small tensors
    a = mx.nd.ones((64,), ctx=dev)
    n = 2000
    for fn in (lambda: a + a, lambda: a._data + a._data):
        fn()
    torch.cuda.synchronize()
    h4 = time.perf_counter()
    for _ in range(n):
        a + a
    h5 = time.perf_counter()
    for _ in range(n):
        a._data + a._data
    h6 = time.perf_counter()
    torch.cuda.synchronize()
    median_ms = float(np.median(step_ms[1:]))
    phase("nd_lm", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          losses=json.dumps(losses), train_losses=json.dumps(train_losses),
          max_loss_gap_to_train=max(abs(a_ - b_) for a_, b_ in
                                    zip(losses, train_losses)),
          gluon_step1_loss=gluon_loss,
          step1_grad_max_rel_err_vs_gluon=rel[worst], its_leaf=worst,
          median_leaf_rel_err=float(np.median(list(rel.values()))),
          rel_bound=GRAD_REL_BOUND, launches=launches,
          launches_per_step=json.dumps(launches_per_step),
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          tokens_per_s=TRAIN_B * MAX_LEN / (median_ms / 1e3),
          peak_memory_gb=peak_gb, forward_invokes=fwd_invokes,
          update_invokes=update_invokes,
          invokes_per_step=fwd_invokes + update_invokes,
          forward_host_ms=(h1 - h0) * 1e3,
          forward_host_us_per_invoke=(h1 - h0) * 1e6 / fwd_invokes,
          backward_ms=(h2 - h1) * 1e3,
          update_host_ms=(h3 - h2) * 1e3,
          update_host_us_per_invoke=(h3 - h2) * 1e6 / update_invokes,
          nd_add_host_us=(h5 - h4) * 1e6 / n,
          torch_add_host_us=(h6 - h5) * 1e6 / n,
          invoke_overhead_us=((h5 - h4) - (h6 - h5)) * 1e6 / n,
          card='"%s"' % card)
    return launches


def nd_lm_vs_cpu(cuda_ops, dev):
    """Phase: the nd-written LM step at VS_CPU's sizes (depth 2, B = 2,
    T = 256) on the card and on the CPU from the same weights and batches:
    per-step losses at SERVE_ATOL/RTOL, step-1 gradients per leaf at
    GRAD_REL_BOUND, one kernel launch a layer a step on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer_lm_nd as lm_nd

    depth, B, T, steps = VS_CPU
    net = new_lm("cpu", depth, 1)
    batches = lm_batches(np.random.RandomState(1), steps, B, T, "cpu")
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    runs = {}
    for label, device in (("cpu", "cpu"), ("card", dev)):
        params = nd_params(net, device)
        states = lm_nd.adam_states(mx, params)
        before = cuda_ops.flash_attention.launches
        losses = []
        for t, (x, y) in enumerate(batches, start=1):
            loss = lm_nd.train_step(
                mx, params, states, t, mx.nd.NDArray(x.to(device)),
                mx.nd.NDArray(y.to(device)), mx.nd.NDArray(pos.to(device)),
                HEADS, TRAIN_LR)
            losses.append(float(loss.asscalar()))
            if t == 1:
                grads = {n: w.grad._data.cpu() for n, w in params.items()}
        runs[label] = (losses, grads,
                       cuda_ops.flash_attention.launches - before)
    (want, want_grads, _), (got, got_grads, launches) = (runs["cpu"],
                                                         runs["card"])
    for step, (g, w) in enumerate(zip(got, want)):
        if not abs(g - w) <= SERVE_ATOL + SERVE_RTOL * abs(w):
            fail("nd_lm_vs_cpu step %d loss on the card %.6f vs CPU %.6f"
                 % (step, g, w))
    if launches != depth * steps:
        fail("nd_lm_vs_cpu launched the kernel %d times, not %d"
             % (launches, depth * steps))
    rel = leaf_rel_errs(got_grads, want_grads)
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_REL_BOUND:
        fail("nd_lm_vs_cpu step-1 gradient of %s is %.3g from the CPU's; "
             "bound %g" % (worst, rel[worst], GRAD_REL_BOUND))
    phase("nd_lm_vs_cpu", depth=depth, batch=(B, T), steps=steps,
          losses=json.dumps(list(zip(got, want))),
          step1_grad_max_rel_err=rel[worst], its_leaf=worst,
          median_leaf_rel_err=float(np.median(list(rel.values()))),
          rel_bound=GRAD_REL_BOUND, launches=launches)


# ---------------------------------------------------------------------------
# Gluon's parameter model: seeded weights, the functional step, files

# bench.py's headline step (:219-246): lr, momentum, classes
FUNCTIONAL_LR, FUNCTIONAL_MOMENTUM, CLASSES = 0.05, 0.9, 1000
FUNCTIONAL_STEPS = 6
# functional_vs_gluon: the step-1 gradients of one loss through the two
# entry points, the same kernels: equal, or within this of a leaf's norm
FUNCTIONAL_GLUON_REL = 1e-5
# the LM's functional_call forward
LM_FUNCTIONAL_B = 4


def seeded_init(dev, card):
    """Phase: ``mx.random.seed(0)``, Xavier and one call give the same
    weights on the card as on the CPU, bit for bit (the keys and the numpy
    draws are made on the host): resnet50_v1 in both layouts and the
    full-width LM.  Prints the seconds of ``initialize`` and of the first
    call that materializes the deferred layers.  Returns the card's LM."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models import TransformerLM

    def build(model, device):
        mx.random.seed(0)
        if model == "lm":
            net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                                max_len=MAX_LEN, device=device)
            inputs = (torch.zeros((1, 1), dtype=torch.int32,
                                  device=device),) * 2
        else:
            net = vision.get_model("resnet50_v1", layout=model, device=device)
            inputs = (torch.zeros((1, 3, 32, 32) if model == "NCHW"
                                  else (1, 32, 32, 3), device=device),)
        t0 = time.perf_counter()
        net.initialize(mx.init.Xavier())
        t1 = time.perf_counter()
        with torch.no_grad():
            net(*inputs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return net, t1 - t0, t2 - t1

    card_lm = None
    for model in ("NCHW", "NHWC", "lm"):
        net, init_s, first_call_s = build(model, dev)
        ref, cpu_init_s, cpu_first_call_s = build(model, "cpu")
        want = ref.state_dict()
        got = net.state_dict()
        if list(got) != list(want):
            fail("seeded_init %s: the card's arrays are not the CPU's" % model)
        differ = [n for n, t in got.items()
                  if not torch.equal(t.cpu(), want[n])]
        if differ:
            fail("seeded_init %s: %d arrays differ from the CPU's, first %s"
                 % (model, len(differ), differ[0]))
        phase("seeded_init", model="resnet50_v1" if model != "lm" else "lm",
              layout=model if model != "lm" else None, seed=0,
              arrays=len(got), params=sum(t.numel() for t in got.values()),
              bitwise_equal_to_cpu=True, initialize_s=init_s,
              first_call_s=first_call_s, cpu_initialize_s=cpu_init_s,
              cpu_first_call_s=cpu_first_call_s, card='"%s"' % card)
        del ref, want
        if model == "lm":
            card_lm = net
    return card_lm


def functional_step_fn(net, dtype):
    """bench.py's step over ``net`` through ``gluon.block.functional_call``:
    the trainable parameters (fp32 leaves) cast to ``dtype`` inside the
    loss, BatchNorm's statistics fp32 aux, ``log_softmax`` and
    ``take_along_dim``, then ``m = 0.9 m + g; p = p - 0.05 m`` (no weight
    decay) on the leaves.  Returns (state, step): ``step(state, x, y)``
    returns the loss, the logits and the gradients (by structural name),
    and moves the state to the new parameters, momenta and aux."""
    from mxnet_tpu_torch.gluon.block import (functional_call, param_values,
                                             split_param_names)

    train_names, aux_names = split_param_names(net)
    values = param_values(net)
    structural = {p.name: k
                  for k, p in net._collect_params_with_prefix().items()}
    state = {"train": {n: values[n].clone().requires_grad_()
                       for n in train_names},
             "aux": {n: values[n].clone() for n in aux_names}}
    state["momenta"] = {n: torch.zeros_like(v)
                        for n, v in state["train"].items()}

    def step(state, x, y):
        train = state["train"]
        p = dict(state["aux"])
        p.update({n: v.to(dtype) for n, v in train.items()})
        outs, new_aux = functional_call(net, p, x.to(dtype), training=True)
        logits = outs[0].float()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.take_along_dim(logp, y[:, None], dim=1).mean()
        grads = torch.autograd.grad(loss, list(train.values()))
        with torch.no_grad():
            moms = list(state["momenta"].values())
            torch._foreach_mul_(moms, FUNCTIONAL_MOMENTUM)
            torch._foreach_add_(moms, grads)
            torch._foreach_add_(list(train.values()), moms,
                                alpha=-FUNCTIONAL_LR)
        state["aux"] = new_aux
        return loss.detach(), logits.detach(), {
            structural[n]: g for n, g in zip(train, grads)}

    return state, step


def bench_batch(B, side, layout, device):
    """bench.py's input: uniform in [-1, 1) and random labels, from
    ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, side, side)).astype(np.float32)
    y = rng.randint(0, CLASSES, B).astype(np.int64)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def functional_step(dev, card):
    """Phase: bench.py's headline step (resnet50_v1, B = 32, 224 x 224,
    1000 classes, bf16 inside the loss) through ``functional_call`` and
    ``torch.autograd``, FUNCTIONAL_STEPS steps in each layout, timed by
    CUDA events: one warm step, the median of the rest."""
    for layout in ("NCHW", "NHWC"):
        net = new_resnet(dev, 0, layout)
        own = {n: t.clone() for n, t in net.state_dict().items()}
        state, step = functional_step_fn(net, torch.bfloat16)
        x, y = bench_batch(RESNET_B, RESNET_SIZE, layout, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        for _ in range(FUNCTIONAL_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _, _ = step(state, x, y)
            end.record()
            torch.cuda.synchronize()
            losses.append(loss.item())
            step_ms.append(start.elapsed_time(end))
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if not all(np.isfinite(losses)):
            fail("functional_step %s losses not finite: %s"
                 % (layout, losses))
        if any(t.dtype != torch.float32 for t in state["aux"].values()):
            fail("functional_step %s: the aux left fp32" % layout)
        if any(not torch.equal(t, own[n])
               for n, t in net.state_dict().items()):
            fail("functional_step %s wrote the block's tensors" % layout)
        median_ms = float(np.median(step_ms[1:]))
        phase("functional_step", layout=layout, network="resnet50_v1",
              batch=(RESNET_B, 3, RESNET_SIZE, RESNET_SIZE),
              compute="bf16 in the loss, fp32 master and aux",
              steps=FUNCTIONAL_STEPS, losses=json.dumps(losses),
              step_ms=json.dumps(step_ms), median_step_ms=median_ms,
              imgs_per_s=RESNET_B / (median_ms / 1e3),
              peak_memory_gb=peak_gb, card='"%s"' % card)
        del net, state


def functional_vs_gluon(dev):
    """Phase: the step-1 gradients of bench.py's loss through
    ``functional_call`` (fp32 leaves cast to bf16 in the loss) against
    ``autograd.record()`` through the block cast to bf16, the same weights
    and batch on the card: equal, or within FUNCTIONAL_GLUON_REL of a
    leaf's norm."""
    from mxnet_tpu_torch import autograd

    net = new_resnet(dev, 0)
    x, y = bench_batch(RESNET_B, RESNET_SIZE, "NCHW", dev)
    state, step = functional_step_fn(net, torch.bfloat16)
    loss_f, _, grads_f = step(state, x, y)
    net.cast("bfloat16")
    with autograd.record():
        logits = net(x.to(torch.bfloat16)).float()
        logp = torch.log_softmax(logits, dim=-1)
        loss_g = -torch.take_along_dim(logp, y[:, None], dim=1).mean()
    loss_g.backward()
    params = dict(net.named_parameters())
    rel, equal = {}, 0
    for n, g in grads_f.items():
        other = params[n].grad.float()
        equal += bool(torch.equal(g, other))
        rel[n] = ((g - other).norm() / other.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    phase("functional_vs_gluon", batch=(RESNET_B, 3, RESNET_SIZE,
                                        RESNET_SIZE),
          loss_functional=loss_f.item(), loss_gluon=loss_g.item(),
          leaves=len(rel), bitwise_equal_leaves=equal,
          max_rel_gap=rel[worst], its_leaf=worst,
          bound=FUNCTIONAL_GLUON_REL)
    if rel[worst] > FUNCTIONAL_GLUON_REL:
        fail("functional_vs_gluon: the gradient of %s is %.3g from the "
             "Gluon path's, relative to its norm" % (worst, rel[worst]))


def functional_vs_cpu(dev):
    """Phase: bench.py's step in fp32 (TF32 off) at RESNET_VS_CPU's batch
    and image size, on the card and on the CPU from the same seeded
    weights: step-1 logits at RESNET_LOGIT_BOUND and each leaf's gradient
    at RESNET_GRAD_REL_BOUND, as ``resnet_vs_cpu`` holds them."""
    B, side, _ = RESNET_VS_CPU
    runs = []
    for device in ("cpu", dev):
        net = new_resnet(device, 1)
        state, step = functional_step_fn(net, torch.float32)
        x, y = bench_batch(B, side, "NCHW", device)
        loss, logits, grads = step(state, x, y)
        runs.append((loss.item(), logits.cpu(),
                     {n: g.cpu() for n, g in grads.items()}))
    want, got = runs
    logit_err = (got[1] - want[1]).abs().max().item()
    rel = leaf_rel_errs(without_conv_biases(got[2]), want[2])
    worst = max(rel, key=rel.get)
    phase("functional_vs_cpu", batch=(B, 3, side, side), dtype="float32",
          loss=got[0], cpu_loss=want[0], step1_logits_max_abs_err=logit_err,
          logit_bound=RESNET_LOGIT_BOUND, step1_grad_max_rel_err=rel[worst],
          its_leaf=worst,
          median_leaf_rel_err=float(np.median(list(rel.values()))),
          grad_rel_bound=RESNET_GRAD_REL_BOUND)
    if not logit_err <= RESNET_LOGIT_BOUND:
        fail("functional_vs_cpu: step-1 logits %.3g from the CPU's; bound "
             "%g" % (logit_err, RESNET_LOGIT_BOUND))
    if not rel[worst] <= RESNET_GRAD_REL_BOUND:
        fail("functional_vs_cpu: the gradient of %s is %.3g from the CPU's, "
             "relative to its norm; bound %g"
             % (worst, rel[worst], RESNET_GRAD_REL_BOUND))


def lm_functional(cuda_ops, dev, net):
    """Phase: the full-width LM's forward through ``functional_call`` at
    B = LM_FUNCTIONAL_B, T = MAX_LEN: its logits equal the module call's,
    and it launches the flash-attention kernel once a layer.  Returns the
    functional forward's launches."""
    from mxnet_tpu_torch.gluon.block import functional_call, param_values

    B, T = LM_FUNCTIONAL_B, MAX_LEN
    g = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randint(0, VOCAB, (B, T), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    values = param_values(net)
    with torch.no_grad():
        want = net(idx, pos)
        reset_launches(cuda_ops)
        outs, aux = functional_call(net, values, idx, pos)
        launches = cuda_ops.flash_attention.launches
    got = outs[0]
    err = (got - want).abs().max().item()
    phase("lm_functional", batch=(B, T), launches=launches, aux=len(aux),
          logits_max_abs_err=err, equal=bool(torch.equal(got, want)))
    if launches != DEPTH:
        fail("lm_functional launched flash_attention %d times, not %d"
             % (launches, DEPTH))
    if not torch.equal(got, want):
        fail("lm_functional: the logits are %.3g from the module call's"
             % err)
    return launches


def params_io(net, card):
    """Phase: ``save_parameters`` of the model trained on the card, loaded
    into a fresh CPU model, bit for bit; and ``nd.save`` of the same
    arrays from the card and from the CPU writes the same bytes."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "resnet50_v1.params")
        t0 = time.perf_counter()
        net.save_parameters(path)
        save_s = time.perf_counter() - t0
        cpu_net = vision.resnet50_v1(classes=net.output.weight.shape[0],
                                     device="cpu")
        t0 = time.perf_counter()
        cpu_net.load_parameters(path)
        load_s = time.perf_counter() - t0
        want = net.state_dict()
        got = cpu_net.state_dict()
        differ = [n for n, t in want.items()
                  if not torch.equal(t.cpu(), got[n])]
        if list(got) != list(want) or differ:
            fail("params_io: %d arrays differ after the round trip, first %s"
                 % (len(differ), differ[:1]))
        arrays = {n: mx.nd.NDArray(t) for n, t in want.items()}
        mx.nd.save(str(Path(tmp) / "card.params"), arrays)
        mx.nd.save(str(Path(tmp) / "cpu.params"),
                   {n: mx.nd.NDArray(t.cpu()) for n, t in want.items()})
        same = (Path(tmp) / "card.params").read_bytes() \
            == (Path(tmp) / "cpu.params").read_bytes()
        size = Path(path).stat().st_size
    if not same:
        fail("params_io: nd.save from the card and from the CPU differ")
    phase("params_io", arrays=len(want), bytes=size, save_s=save_s,
          load_s=load_s, bitwise_equal=True, card_cpu_bytes_equal=same,
          card='"%s"' % card)


# ---------------------------------------------------------------------------
# the compiled half: CachedOp as CUDA-graph capture, hybridize(), the
# compiled train step, mx.sym and Module.fit

COMPILED_STEPS, COMPILED_WINDOW = 6, 2
COMPILED_LR, COMPILED_MOMENTUM = 0.05, 0.9
# one epoch: the compiled step's CachedOp takes a key a call, as the JAX
# package's does, and the eager loop none, so the reshuffle before a
# second epoch would give the two fits different batches
MNIST_B, MNIST_EPOCHS = 64, 1
# a hybridized block against its eager self where the two are not
# bit-reproducible (cuDNN's default algorithms): the JAX package's bound,
# tests/test_gluon.py::test_model_zoo_hybridize_consistency
HYBRID_RTOL, HYBRID_ATOL = 1e-4, 1e-5
# a LeNet checkpoint's predictions, card against CPU (fp32 sums in another
# order; the LM's served logits hold 1e-3 at far greater depth)
MNIST_PREDICT_ATOL = 1e-5


def device_profile(fn):
    """(device ms, {kernel name: launches}) of one call of ``fn()`` under
    torch.profiler: the kernels and copies on the device timeline.  ``fn``
    runs twice, the first call the profiler's warm-up cycle, whose events
    are dropped: as tracing starts, the trace can miss a graph replay's
    first kernel (one run saw 11 of a replay's 12 attention kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    cpu = torch.autograd.DeviceType.CPU
    # the step's own annotation has a device-side twin spanning its
    # kernels: it is not a kernel, and its time would count them twice
    kernels = [e for e in traces[0] if e.device_type != cpu
               and not e.key.startswith("ProfilerStep")]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            {e.key: e.count for e in kernels})


def kernel_count(kernels, tag="flash_attention_fwd"):
    return sum(n for k, n in kernels.items() if tag in k)


def replayed_launches(fn, want=None):
    """(kernel launches, device ms, {kernel: launches}) that torch.profiler
    sees in one call of ``fn``, a graph replay that should launch the
    kernel ``want`` times (default DEPTH, once a layer).  CUPTI can drop a
    kernel at the edge of a trace window (two runs on an H100 each saw 11
    of a replay's 12, once), so a count other than ``want`` is traced
    again, three traces in all; a graph that launches another number
    shows it in every trace, and the caller fails on it."""
    want = DEPTH if want is None else want
    for _ in range(3):
        device_ms, kernels = device_profile(fn)
        seen = kernel_count(kernels)
        if seen == want:
            break
    return seen, device_ms, kernels


def state_diff(a, b):
    """Names of the arrays of two state dicts that are not bit-equal."""
    return [n for n in a if not torch.equal(a[n], b[n])]


def hybrid_serve(net, dev, warm, cache, caps, arrays, graphed, per_replay):
    """Phase: the serving registry's CachedOp.  The warmup captured one
    graph a (length, rung) signature, traffic captured none, a padded
    batch's logits from the graph equal the eager block's bit for bit, and
    torch.profiler saw one replay of each length launch the kernel once a
    layer (``per_replay``)."""
    sigs = len(SERVE_LENGTHS) * len(LADDER)
    if warm["signatures"] != sigs or warm["compiles"] != sigs:
        fail("hybrid_serve: warmup %s, not %d captures" % (warm, sigs))
    if cache["misses"] != warm["cache"]["misses"] or caps["captures"] != sigs:
        fail("hybrid_serve: traffic captured again: %s, %s" % (cache, caps))
    with torch.no_grad():
        eager = net(*(torch.from_numpy(a).to(dev) for a in arrays))
    eager = eager.cpu().numpy()
    if not np.array_equal(graphed, eager):
        fail("hybrid_serve: graphed logits differ from the eager block's: "
             "max abs %.3g" % float(np.abs(graphed - eager).max()))
    phase("hybrid_serve", signatures=warm["signatures"],
          captures=caps["captures"], warmup_compiles=warm["compiles"],
          misses_after_traffic=cache["misses"] - warm["cache"]["misses"],
          hits=cache["hits"], replays=caps["replays"],
          eager_warmup_runs=caps["eager_runs"],
          profiler_kernel_launches_per_replay=json.dumps(per_replay),
          bitwise_batch=arrays[0].shape, bitwise=True)


def hybrid_lm_train(cuda_ops, dev, card):
    """Phase: the full-width LM hybridized, trained as ``train`` trains it
    (the same weights, batches and Adam steps, fp32): one tape node a step
    whose forward and backward replay captured graphs.  Losses and final
    weights must equal the eager ``train`` phase's bit for bit.  Launches
    are the warm-up runs' (counted by the wrapper) and the replays' (the
    kernels torch.profiler sees in one replayed step, which must be 12,
    times the replays)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    want_losses, eager_ms, want = REFS.pop("train")
    net = new_lm(dev, DEPTH, 0)
    net.hybridize()
    trainer = gluon.Trainer(net.named_parameters(), "adam",
                            {"learning_rate": TRAIN_LR})
    ce = SoftmaxCrossEntropyLoss()
    batches = lm_batches(np.random.RandomState(0), TRAIN_STEPS, TRAIN_B,
                         MAX_LEN, dev)
    pos = torch.arange(MAX_LEN, device=dev,
                       dtype=torch.int32).expand(TRAIN_B, MAX_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    reset_launches(cuda_ops)
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = forward_backward(net, ce, x, y, pos)
        trainer.step(1)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        step_ms.append(start.elapsed_time(end))
    eager_launches = cuda_ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    caps = net._cached_op.capture_stats()
    cache = net._cached_op.cache_stats()
    if caps["captures"] != 1 or cache["misses"] != 1 \
            or cache["hits"] != TRAIN_STEPS - 1:
        fail("hybrid_lm_train: not one capture for %d steps: %s %s"
             % (TRAIN_STEPS, caps, cache))
    if eager_launches != DEPTH * caps["eager_runs"]:
        fail("hybrid_lm_train: %d eager launches, not %d layers x %d "
             "warm-up runs" % (eager_launches, DEPTH, caps["eager_runs"]))
    if losses != want_losses:
        fail("hybrid_lm_train: losses %s differ from the eager %s"
             % (losses, want_losses))
    got = net.state_dict()
    differ = state_diff(want, got)
    if differ:
        fail("hybrid_lm_train: %d weights differ from the eager run's, "
             "e.g. %s (max abs %.3g)" % (len(differ), differ[0], float(
                 (want[differ[0]] - got[differ[0]]).abs().max())))
    del want
    x, y = batches[0]
    seen, device_ms, kernels = replayed_launches(
        lambda: forward_backward(net, ce, x, y, pos))
    if seen != DEPTH:
        fail("hybrid_lm_train: the profiler saw the kernel %d times in one "
             "replayed step, not %d" % (seen, DEPTH))
    if cuda_ops.flash_attention.launches != eager_launches:
        fail("hybrid_lm_train: a graph replay called the kernel's wrapper")
    launches = eager_launches + caps["replays"] * seen
    phase("hybrid_lm_train", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          losses=json.dumps(losses), bitwise_losses=True,
          bitwise_weights=len(got), captures=caps["captures"],
          replays=caps["replays"], eager_warmup_runs=caps["eager_runs"],
          launches=launches, profiler_kernel_launches=seen,
          step_ms=json.dumps(step_ms), median_step_ms=median_of(step_ms),
          eager_median_step_ms=eager_ms,
          step_device_ms=device_ms if device_ms else "not measured",
          tokens_per_s=TRAIN_B * MAX_LEN / (median_of(step_ms) / 1e3),
          peak_memory_gb=peak_gb, card='"%s"' % card)
    return launches


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the scope.  An fp32
    ResNet-50 or LeNet step with cuDNN's default choice of convolution
    backward is not bit-reproducible even eagerly (two eager runs of the
    same steps end apart), so the phases that hold a graphed step to its
    eager twin bit for bit run both here."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def state_copy(net):
    return {n: t.detach().clone() for n, t in net.state_dict().items()}


def beyond_hybrid_bound(want, got):
    """Names of the arrays of two state dicts that differ by more than the
    JAX package's hybridize bound (HYBRID_RTOL, HYBRID_ATOL)."""
    return [n for n in want if not torch.allclose(
        got[n].float(), want[n].float(), rtol=HYBRID_RTOL, atol=HYBRID_ATOL)]


def hybrid_resnet_run(dev, args, batches, dtype, hybrid):
    """resnet50_v1 from seed 0, hybridized or not, trained by
    ``train_step`` on ``batches``: (net, trainer, losses, step ms, peak GB,
    state after step 1, final state)."""
    from mxnet_tpu_torch import gluon, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import image_classification as ic

    net = new_resnet(dev, 0).cast(dtype)
    net.hybridize(hybrid)
    trainer = gluon.Trainer(
        net.named_parameters(), args.optimizer,
        {"learning_rate": args.lr, "momentum": args.mom, "wd": args.wd},
        kvstore=args.kv_store)
    ce, acc = SoftmaxCrossEntropyLoss(), metric.Accuracy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, after_one = [], [], None
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = ic.train_step(net, trainer, ce, acc, x, y, RESNET_B)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.float().mean().item())
        step_ms.append(start.elapsed_time(end))
        if after_one is None:
            after_one = state_copy(net)
    return (net, trainer, losses, step_ms,
            torch.cuda.max_memory_allocated(dev) / 1e9, after_one,
            state_copy(net))


def resnet_step_device_ms(net, trainer, batch):
    """Device ms of one more ``train_step``-like step, by torch.profiler."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    ce = SoftmaxCrossEntropyLoss()
    x, y = batch

    def step():
        with autograd.record():
            loss = ce(net(x), y)
        loss.backward(torch.ones_like(loss))
        trainer.step(RESNET_B)

    return device_profile(step)[0]


def hybrid_resnet_train(dev, card, dtype="float32"):
    """Phase: resnet50_v1 hybridized and trained by ``train_step``, from
    the weights and batches ``resnet_train`` (or ``resnet_bf16_train``)
    starts from, NCHW, beside the same eager run (the twin), both with
    cuDNN's deterministic algorithms: losses, weights and BatchNorm's
    running statistics must be bit-equal; one capture.  Then the same pair
    with cuDNN's default algorithms, as ``resnet_train`` and users run it:
    its convolution backward is not bit-reproducible, so the pair is held
    to the JAX package's hybridize bound on step 1's loss and on every
    array after step 1 (the steps after amplify any difference, so the
    later ones are reported, not held), and a second eager run shows how
    many arrays eager runs alone leave apart after step 1.  Step ms of
    each pair and the graphed steps' device time."""
    label = "hybrid_resnet_train" if dtype == "float32" \
        else "hybrid_resnet_bf16_train"
    args = resnet_args(RESNET_B)
    batches = [(x.to(getattr(torch, dtype)), y) for x, y in
               synthetic_batches(args, (3, RESNET_SIZE, RESNET_SIZE), dev,
                                 RESNET_STEPS)]
    with deterministic_cudnn():
        want_losses, eager_ms, eager_gb, _, want = hybrid_resnet_run(
            dev, args, batches, dtype, False)[2:]
        net, trainer, losses, step_ms, peak_gb, _, got = hybrid_resnet_run(
            dev, args, batches, dtype, True)
        caps = net._cached_op.capture_stats()
        cache = net._cached_op.cache_stats()
        if caps["captures"] != 1 or cache["misses"] != 1:
            fail("%s: not one capture: %s %s" % (label, caps, cache))
        if losses != want_losses:
            fail("%s: losses %s differ from the eager twin's %s"
                 % (label, losses, want_losses))
        differ = state_diff(want, got)
        if differ:
            fail("%s: %d of %d arrays differ from the eager twin's, e.g. "
                 "%s (max abs %.3g)" % (
                     label, len(differ), len(got), differ[0],
                     float((want[differ[0]].float()
                            - got[differ[0]].float()).abs().max())))
        n_arrays = len(got)
        del want, got
        device_ms = resnet_step_device_ms(net, trainer, batches[0])
        del net, trainer
    phase(label, layout="NCHW", network="resnet50_v1", dtype=dtype,
          batch=(RESNET_B, 3, RESNET_SIZE, RESNET_SIZE), steps=len(batches),
          cudnn_deterministic=True, losses=json.dumps(losses),
          bitwise_losses=True, bitwise_arrays=n_arrays,
          captures=caps["captures"], replays=caps["replays"],
          step_ms=json.dumps(step_ms), median_step_ms=median_of(step_ms),
          eager_step_ms=json.dumps(eager_ms),
          eager_median_step_ms=median_of(eager_ms),
          step_device_ms=device_ms if device_ms else "not measured",
          imgs_per_s=RESNET_B / (median_of(step_ms) / 1e3),
          peak_memory_gb=peak_gb, eager_peak_memory_gb=eager_gb,
          card='"%s"' % card)

    # cuDNN's default algorithms (cudnn.benchmark stays off), and a second
    # eager run as the control: how far eager runs alone land apart
    (_, _, want_losses, eager_ms, _, want_one,
     want) = hybrid_resnet_run(dev, args, batches, dtype, False)
    control_one = hybrid_resnet_run(dev, args, batches, dtype, False)[5]
    control_differ = len(state_diff(want_one, control_one))
    del control_one
    net, trainer, losses, step_ms, peak_gb, got_one, got = \
        hybrid_resnet_run(dev, args, batches, dtype, True)
    cache = net._cached_op.cache_stats()
    if cache["misses"] != 1:
        fail("%s_default_cudnn: not one capture: %s" % (label, cache))
    if not np.allclose(losses[0], want_losses[0], rtol=HYBRID_RTOL,
                       atol=HYBRID_ATOL):
        fail("%s_default_cudnn: step-1 loss %r, eager %r" % (
            label, losses[0], want_losses[0]))
    beyond = beyond_hybrid_bound(want_one, got_one)
    if beyond:
        fail("%s_default_cudnn: %d arrays beyond rtol %g atol %g after step "
             "1, e.g. %s" % (label, len(beyond), HYBRID_RTOL, HYBRID_ATOL,
                             beyond[0]))
    device_ms = resnet_step_device_ms(net, trainer, batches[0])
    phase(label + "_default_cudnn", layout="NCHW", dtype=dtype,
          cudnn_deterministic=False, rtol=HYBRID_RTOL, atol=HYBRID_ATOL,
          op_not_bitwise='"cuDNN convolution backward (default algorithms)"',
          step1_arrays_beyond_bound=0,
          step1_arrays_not_bitwise=len(state_diff(want_one, got_one)),
          eager_control_step1_arrays_not_bitwise=control_differ,
          final_arrays_not_bitwise=len(state_diff(want, got)),
          final_arrays=len(got), losses=json.dumps(losses),
          eager_losses=json.dumps(want_losses),
          step_ms=json.dumps(step_ms), median_step_ms=median_of(step_ms),
          eager_step_ms=json.dumps(eager_ms),
          eager_median_step_ms=median_of(eager_ms),
          step_device_ms=device_ms if device_ms else "not measured",
          peak_memory_gb=peak_gb, card='"%s"' % card)


def cuda_timed(fn):
    """Milliseconds of ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def compiled_sgd():
    from mxnet_tpu_torch.optimizer import SGD
    return SGD(learning_rate=COMPILED_LR, momentum=COMPILED_MOMENTUM,
               multi_precision=True)


def compiled_eager_loop(dev, batches, ce):
    """``compiled_step``'s eager twin, a ``gluon.Trainer`` loop over the
    same update kernels: (step ms, accuracy, state after step 1, final
    state)."""
    from mxnet_tpu_torch import autograd, gluon, metric

    net = new_resnet(dev, 0).cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), compiled_sgd())
    acc = metric.Accuracy()
    step_ms, after_one = [], None
    for x, y in batches:
        def eager_step():
            with autograd.record():
                out = net(x)
                loss = ce(out, y).mean()
            loss.backward()
            trainer.step(1)
            acc.update([y], [out])
        step_ms.append(cuda_timed(eager_step))
        if after_one is None:
            after_one = state_copy(net)
    return step_ms, acc, after_one, state_copy(net)


def compiled_run(dev, batches, ce, spc):
    """``CompiledTrainStep.from_block`` over ``batches`` in windows of
    ``spc``: (window ms, host fetches in the loop, device accuracy, cache
    and capture stats, peak GB, state after the first window, final
    state)."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.module import CompiledTrainStep

    net = new_resnet(dev, 0).cast("bfloat16")
    dacc = metric.Accuracy()
    cstep = CompiledTrainStep.from_block(
        net, lambda outs, y: ce(outs[0], y).mean(), compiled_sgd(),
        eval_metric=dacc, steps_per_call=spc)
    windows = [batches[i:i + spc] for i in range(0, len(batches), spc)]
    items = {"n": 0}
    item = torch.Tensor.item

    def counted(self):
        items["n"] += 1
        return item(self)

    torch.cuda.reset_peak_memory_stats(dev)
    ms, after_one = [], None
    torch.Tensor.item = counted
    try:
        for w in windows:
            ms.append(cuda_timed(lambda: cstep.run_window(w)))
            if after_one is None:
                after_one = state_copy(net)
    finally:
        torch.Tensor.item = item
    cstep.sync_metric()
    return (ms, items["n"], dacc, cstep.cache_stats(), cstep.capture_stats(),
            torch.cuda.max_memory_allocated(dev) / 1e9, after_one,
            state_copy(net))


def compiled_step(dev, card):
    """Phase: ``CompiledTrainStep.from_block`` on resnet50_v1 in bf16
    (NCHW, B = 32, 224 x 224), SGD with momentum 0.9, lr 0.05 and
    ``multi_precision``, ``Accuracy`` accumulated on the device.  With
    cuDNN's deterministic algorithms, as ``hybrid_resnet_train``:
    COMPILED_STEPS steps one a call, then the same steps in windows of
    COMPILED_WINDOW, each from the same weights and batches as an eager
    loop over the same update kernels (``gluon.Trainer``).  Parameters,
    masters' casts and running statistics must equal the eager loop's bit
    for bit; each window signature is captured once, and the loop fetches
    nothing to the host (``Tensor.item`` is counted).  Then one a call
    again beside the eager loop, both with cuDNN's default algorithms:
    held to the JAX package's hybridize bound after step 1, timed."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    batches = [(x.to(torch.bfloat16), y) for x, y in synthetic_batches(
        resnet_args(RESNET_B), (3, RESNET_SIZE, RESNET_SIZE), dev,
        COMPILED_STEPS)]
    ce = SoftmaxCrossEntropyLoss()

    def check_run(spc, fetches, cache, caps, n_windows, label):
        if cache["misses"] != 1 or caps["captures"] != 1 \
                or cache["hits"] != n_windows - 1:
            fail("%s (steps_per_call=%d): not one capture: %s %s"
                 % (label, spc, cache, caps))
        if fetches:
            fail("%s: %d host fetches inside the loop" % (label, fetches))

    results = {}
    with deterministic_cudnn():
        eager_ms, acc, _, want = compiled_eager_loop(dev, batches, ce)
        for spc in (1, COMPILED_WINDOW):
            ms, fetches, dacc, cache, caps, gb, _, got = compiled_run(
                dev, batches, ce, spc)
            check_run(spc, fetches, cache, caps, len(ms), "compiled_step")
            differ = state_diff(want, got)
            if differ:
                fail("compiled_step (steps_per_call=%d): %d of %d arrays "
                     "differ from the eager loop's, e.g. %s"
                     % (spc, len(differ), len(got), differ[0]))
            if dacc.get() != acc.get():
                fail("compiled_step: device accuracy %s, eager %s"
                     % (dacc.get(), acc.get()))
            results[spc] = (ms, gb, len(got))
    ms1, gb1, n = results[1]
    msw, gbw, _ = results[COMPILED_WINDOW]
    phase("compiled_step", network="resnet50_v1", dtype="bfloat16",
          layout="NCHW", batch=(RESNET_B, 3, RESNET_SIZE, RESNET_SIZE),
          optimizer="sgd mom %.1f lr %.2f multi_precision" % (
              COMPILED_MOMENTUM, COMPILED_LR),
          steps=COMPILED_STEPS, cudnn_deterministic=True, bitwise_arrays=n,
          accuracy=acc.get()[1],
          host_fetches_in_loop=0, eager_step_ms=json.dumps(eager_ms),
          eager_median_step_ms=median_of(eager_ms),
          step_ms=json.dumps(ms1), median_step_ms=median_of(ms1),
          window=COMPILED_WINDOW, window_ms=json.dumps(msw),
          window_median_step_ms=float(np.median(msw[1:])) / COMPILED_WINDOW,
          imgs_per_s=RESNET_B / (median_of(ms1) / 1e3),
          peak_memory_gb=gb1, window_peak_memory_gb=gbw,
          card='"%s"' % card)

    # cuDNN's default algorithms (cudnn.benchmark stays off)
    eager_ms, acc, want_one, want = compiled_eager_loop(dev, batches, ce)
    ms, fetches, dacc, cache, caps, gb, got_one, got = compiled_run(
        dev, batches, ce, 1)
    check_run(1, fetches, cache, caps, len(ms), "compiled_step_default_cudnn")
    beyond = beyond_hybrid_bound(want_one, got_one)
    if beyond:
        fail("compiled_step_default_cudnn: %d arrays beyond rtol %g atol %g "
             "after step 1, e.g. %s" % (len(beyond), HYBRID_RTOL,
                                        HYBRID_ATOL, beyond[0]))
    phase("compiled_step_default_cudnn", dtype="bfloat16", layout="NCHW",
          cudnn_deterministic=False, rtol=HYBRID_RTOL, atol=HYBRID_ATOL,
          op_not_bitwise='"cuDNN convolution backward (default algorithms)"',
          step1_arrays_beyond_bound=0,
          step1_arrays_not_bitwise=len(state_diff(want_one, got_one)),
          final_arrays_not_bitwise=len(state_diff(want, got)),
          final_arrays=len(got), accuracy=dacc.get()[1],
          eager_accuracy=acc.get()[1], host_fetches_in_loop=0,
          step_ms=json.dumps(ms), median_step_ms=median_of(ms),
          eager_step_ms=json.dumps(eager_ms),
          eager_median_step_ms=median_of(eager_ms),
          imgs_per_s=RESNET_B / (median_of(ms) / 1e3), peak_memory_gb=gb,
          card='"%s"' % card)


@deterministic_cudnn()
def module_fit(dev, card):
    """Phase (cuDNN deterministic, as ``hybrid_resnet_train``):
    ``models/train_mnist.py``'s LeNet through ``Module.fit`` on
    the card (B = 64, the example's synthetic set, MNIST_EPOCHS epochs),
    compiled and eager from one seed: parameters bit-equal and ``score``
    equal; the compiled path ran, one capture.  Then ``save_checkpoint``,
    ``Module.load`` and ``predict`` on the card, against ``predict`` of the
    same checkpoint on the CPU."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import train_mnist

    runs = {}
    for compiled in (True, False):
        mx.random.seed(0)
        t0 = time.time()
        mod = train_mnist.main(["--network", "lenet", "--batch-size",
                                str(MNIST_B), "--num-epochs",
                                str(MNIST_EPOCHS), "--compiled",
                                "1" if compiled else "0"])
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        if (mod._compiled_step is not None) != compiled:
            fail("module_fit: compiled=%s took the other path" % compiled)
        args, auxs = mod.get_params()
        runs[compiled] = (mod, {k: v._data.clone() for k, v in args.items()},
                          mod.last_score, fit_s)
    mod, params, score, fit_s = runs[True]
    _, eager_params, eager_score, eager_s = runs[False]
    differ = state_diff(eager_params, params)
    if differ:
        fail("module_fit: compiled and eager parameters differ: %s" % differ)
    if score != eager_score:
        fail("module_fit: score %s, eager %s" % (score, eager_score))
    cache = mod._compiled_step.cache_stats()
    steps = MNIST_EPOCHS * (2048 // MNIST_B)
    if cache["misses"] != 1 or cache["hits"] != steps - 1:
        fail("module_fit: not one capture for %d steps: %s" % (steps, cache))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = tmp + "/lenet"
        mod.save_checkpoint(prefix, MNIST_EPOCHS)
        it = train_mnist.get_mnist_iters(MNIST_B, tmp, ctx=dev,
                                         shuffle=False)[0]
        card_mod = mx.mod.Module.load(prefix, MNIST_EPOCHS, context=dev)
        card_mod.bind(data_shapes=it.provide_data,
                      label_shapes=it.provide_label, for_training=False)
        on_card = card_mod.predict(it).asnumpy()
        it = train_mnist.get_mnist_iters(MNIST_B, tmp, ctx="cpu",
                                         shuffle=False)[0]
        cpu_mod = mx.mod.Module.load(prefix, MNIST_EPOCHS,
                                     context=mx.cpu())
        cpu_mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, for_training=False)
        on_cpu = cpu_mod.predict(it).asnumpy()
    err = float(np.abs(on_card - on_cpu).max())
    if on_card.shape != (2048, 10) or err > MNIST_PREDICT_ATOL:
        fail("module_fit: predict on the card %s vs the CPU: max abs %.3g"
             % (on_card.shape, err))
    phase("module_fit", network="lenet", batch=MNIST_B, epochs=MNIST_EPOCHS,
          cudnn_deterministic=True,
          steps=steps, bitwise_params=len(params), score=score[0][1],
          eager_score=eager_score[0][1], captures=cache["misses"],
          hits=cache["hits"], compiled_fit_s=fit_s, eager_fit_s=eager_s,
          predict_vs_cpu_max_abs=err, atol=MNIST_PREDICT_ATOL,
          card='"%s"' % card)


# ---------------------------------------------------------------------------
# the decode engine (serving/decode): the bench LM's widths as a
# TinyCausalLM, served token by token through continuous batching


def decode_traffic(seed, n, prompt_range, new_range, prefix=()):
    """``n`` greedy requests: prompts of uniform length in ``prompt_range``
    (after ``prefix``), budgets uniform in ``new_range``, from a seed."""
    rng = np.random.RandomState(seed)
    prompts, budgets = [], []
    for _ in range(n):
        length = int(rng.randint(prompt_range[0], prompt_range[1] + 1))
        prompts.append(list(prefix) + rng.randint(0, VOCAB, length).tolist())
        budgets.append(int(rng.randint(new_range[0], new_range[1] + 1)))
    return prompts, budgets


def decode_run(engine, prompts, budgets):
    """Submit every request at once; wait them out.  Returns the streams
    and the wall seconds from the first submit to the last terminal."""
    t0 = time.time()
    streams = [engine.submit(p, max_new_tokens=b, timeout_ms=600000)
               for p, b in zip(prompts, budgets)]
    for s in streams:
        if not s.wait(900):
            fail("%s: a stream never ended" % engine.name)
    wall = time.time() - t0
    bad = [(i, s.status, s.error) for i, s in enumerate(streams)
           if s.status != "OK"]
    if bad:
        fail("%s: streams not OK: %s" % (engine.name, bad[:5]))
    return streams, wall


def decode_checks(engine, label, warm_caps, warm_misses):
    """The steady-state gates: no capture and no signature miss after
    warmup, every KV block back in the pool."""
    caps = engine.capture_stats()
    misses = engine.cache_stats()["misses"]
    if caps["captures"] != warm_caps or misses != warm_misses:
        fail("%s: traffic captured again: %d captures / %d misses after "
             "warmup's %d / %d" % (label, caps["captures"], misses,
                                   warm_caps, warm_misses))
    kv = engine.kv_stats()
    leaked = kv["allocated_total"] - kv["freed_total"]
    if leaked or kv["used"] or kv["reserved"]:
        fail("%s: KV blocks leaked: %s" % (label, kv))
    return caps, kv, leaked


def decode_warmup(engine, label, dev, t0):
    warm = engine.warmup_report
    want = warm["signatures"] if dev.type == "cuda" else 0
    if warm["compiles"] != warm["signatures"] or warm["captures"] != want:
        fail("%s: warmup %s" % (label, warm))
    phase(label + "_warmup", signatures=warm["signatures"],
          captures=warm["captures"], seconds=round(time.time() - t0, 2))
    return engine.capture_stats()["captures"], \
        engine.cache_stats()["misses"]


def stream_numbers(streams, wall):
    from mxnet_tpu_torch.serving.stats import stream_tpot_ms
    ttft = [s.ttft_ms for s in streams]
    tpot = [t for t in (stream_tpot_ms(s.latency_ms, s.ttft_ms,
                                       len(s.tokens())) for s in streams)
            if t is not None]
    tokens = sum(len(s.tokens()) for s in streams)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "tpot_p50_ms": float(np.percentile(tpot, 50))}


def trace_memcpys(prof):
    """(bytes, name) of every device copy in a torch.profiler trace (the
    exported chrome trace carries each copy's size)."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.load(open(path)).get("traceEvents", [])
    finally:
        os.unlink(path)
    return [(int(e.get("args", {}).get("bytes", -1)), e.get("name"))
            for e in events if "memcpy" in str(e.get("cat", "")).lower()]


def decode_step_profile(engine, label, card):
    """torch.profiler over one replayed decode step of the live ops at the
    widest table: its device time, and every copy it made, none of them
    the size of a pool (the pools are written in place)."""
    from torch.profiler import ProfilerActivity, profile

    S, W = engine.max_slots, engine._width_ladder.max_batch
    args = (np.zeros(S, np.int32), np.zeros(S, np.int32),
            np.zeros((S, W), np.int32))

    def step():
        return engine._decode_exec(engine._live, *args).cpu()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages() if e.device_type != cpu]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if kernel_count({e.key: e.count for e in kernels}):
        fail("%s: the decode step launched flash_attention" % label)
    copies = trace_memcpys(prof)
    if not copies or any(b < 0 for b, _ in copies):
        fail("%s: the trace gives no copy sizes: %s" % (label, copies))
    largest = max(copies)
    pool_bytes = engine._live.pools[0].nbytes
    if largest[0] >= pool_bytes:
        fail("%s: a replayed decode step copied %d bytes (%s); a pool is %d"
             % (label, largest[0], largest[1], pool_bytes))
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    phase(label, width_blocks=W, device_ms=device_ms,
          host_ms_per_step=host_ms, kernels=sum(e.count for e in kernels),
          copies=len(copies), largest_copy_bytes=largest[0],
          largest_copy=json.dumps(largest[1]), pool_bytes=pool_bytes,
          top_device_ms=json.dumps([[e.key[:50],
                                     e.self_device_time_total / 1e3]
                                    for e in top]), card='"%s"' % card)
    return device_ms


def decode_serve(cuda_ops, dev, card):
    """Phase: the decode engine at the bench LM's widths, attached to a
    ModelServer: 64 greedy streams submitted at once.  All OK, no capture
    after warmup, no block leaked, no flash_attention launch, and eight
    fixed streams (the longest prompt among them) equal
    ``generate_reference`` token for token."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

    t0 = time.time()
    model = TinyCausalLM(seed=0, device=dev, **DEC_MODEL)
    n_params = sum(t.numel() for t in model.param_dict().values())
    engine = DecodeEngine(model, name="decode", device=dev, **DEC_ENGINE)
    warm_caps, warm_misses = decode_warmup(engine, "decode", dev, t0)
    prompts, budgets = decode_traffic(0, *DEC_TRAFFIC)
    longest = int(np.argmax([len(p) for p in prompts]))
    fixed = sorted(set(range(DEC_FIXED - 1)) | {longest})
    t0 = time.time()
    refs = {i: engine.generate_reference(prompts[i], budgets[i]).tolist()
            for i in fixed}
    ref_s = time.time() - t0
    server = serving.ModelServer()
    server.attach_engine(engine)
    before = server.stats()["engines"]["decode"]
    replays0 = engine.capture_stats()["replays"]
    streams, wall = decode_run(engine, prompts, budgets)
    launches = cuda_ops.flash_attention.launches
    if launches:
        fail("decode_serve launched flash_attention %d times" % launches)
    caps, kv, leaked = decode_checks(engine, "decode_serve", warm_caps,
                                     warm_misses)
    wrong = [i for i in fixed if streams[i].tokens() != refs[i]]
    if wrong:
        i = wrong[0]
        fail("decode_serve: stream %d (prompt %d) differs from its "
             "reference at token %d" % (i, len(prompts[i]), next(
                 j for j, (a, b) in enumerate(zip(streams[i].tokens() + [-1],
                                                  refs[i])) if a != b)))
    snap = server.stats()["engines"]["decode"]
    steps = snap["steps"] - before["steps"]
    numbers = stream_numbers(streams, wall)
    phase("decode_serve", params=n_params, streams=len(streams),
          ok=sum(s.status == "OK" for s in streams), steps=steps,
          avg_live_slots=(snap["avg_live_slots"] * snap["steps"]
                          - before["avg_live_slots"] * before["steps"])
          / max(steps, 1), peak_blocks=kv["peak_used"],
          kv_capacity=kv["num_blocks"], replays=caps["replays"] - replays0,
          captures_after_warmup=caps["captures"] - warm_caps,
          leaked_blocks=leaked, flash_attention_launches=launches,
          reference_streams=len(fixed), references_equal=True,
          longest_prompt=len(prompts[longest]), reference_s=ref_s,
          card='"%s"' % card, **numbers)
    if dev.type == "cuda":
        decode_step_profile(engine, "decode_step_profile", card)
    return model, engine, server, (prompts, budgets, streams, numbers)


def decode_static(cuda_ops, dev, card, model, served):
    """Phase: the same traffic through ``scheduling="static"`` (a batch
    admitted only when the last one finished): the same tokens, and its
    rate beside the continuous engine's."""
    from mxnet_tpu_torch.serving.decode import DecodeEngine

    prompts, budgets, streams, numbers = served
    t0 = time.time()
    engine = DecodeEngine(model, name="decode_static", device=dev,
                          scheduling="static", **DEC_ENGINE)
    warm_caps, warm_misses = decode_warmup(engine, "decode_static", dev, t0)
    got, wall = decode_run(engine, prompts, budgets)
    if cuda_ops.flash_attention.launches:
        fail("decode_static launched flash_attention")
    caps, kv, leaked = decode_checks(engine, "decode_static", warm_caps,
                                     warm_misses)
    diff = [i for i, (a, b) in enumerate(zip(got, streams))
            if a.tokens() != b.tokens()]
    if diff:
        fail("decode_static: %d streams differ from the continuous "
             "engine's, first %d" % (len(diff), diff[0]))
    snap = engine.stats_snapshot()
    mine = stream_numbers(got, wall)
    phase("decode_static", streams=len(got), same_tokens=True,
          steps=snap["steps"], avg_live_slots=snap["avg_live_slots"],
          captures_after_warmup=caps["captures"] - warm_caps,
          leaked_blocks=leaked,
          continuous_tokens_per_s=numbers["tokens_per_s"],
          continuous_over_static=numbers["tokens_per_s"]
          / mine["tokens_per_s"], card='"%s"' % card, **mine)
    return engine


def decode_handoff(a, b, prompt):
    """Phase: a seeded sampled stream exported from one engine mid-stream
    and imported into another finishes as the unmoved stream does."""
    kw = dict(temperature=0.8, top_k=64, top_p=0.95, seed=1234)
    budget = min(64, a.max_new_tokens)
    want = a.generate_reference(prompt, budget, **kw).tolist()
    slow = lambda tok: time.sleep(0.005)  # noqa: E731  paces the worker
    stream = a.submit(prompt, max_new_tokens=budget, timeout_ms=600000,
                      on_token=slow, **kw)
    deadline = time.time() + 120
    while len(stream.tokens()) < budget // 8 and stream.status is None \
            and time.time() < deadline:
        time.sleep(0.001)
    if not a.quiesce(30.0):
        fail("decode_handoff: the engine did not park")
    moved = a.export_streams()
    a.resume()
    if [s for s, _ in moved] != [stream]:
        fail("decode_handoff: exported %d streams" % len(moved))
    snap = moved[0][1]
    stream.set_owner("moved")
    b.import_stream(snap, stream=stream, owner="moved")
    if not stream.wait(600) or stream.status != "OK":
        fail("decode_handoff: stream ended %s" % stream.status)
    if stream.tokens() != want:
        fail("decode_handoff: the moved stream differs from the unmoved "
             "one")
    for eng in (a, b):
        kv = eng.kv_stats()
        if kv["allocated_total"] != kv["freed_total"] or kv["used"]:
            fail("decode_handoff: %s leaked blocks: %s" % (eng.name, kv))
    phase("decode_handoff", prompt=len(prompt), tokens=len(want),
          moved_at=snap["generated"], pages=snap["k"].shape[1],
          page_bytes=snap["k"].nbytes + snap["v"].nbytes,
          sampler_draws=snap["sampling"]["draws"], identical=True)


def decode_prefix_spec(cuda_ops, dev, card, model):
    """Phase: chunked prefill (64-token chunks), the prefix cache and
    speculative decoding (3 draft tokens a round from a 2-layer draft at
    the same widths, seed 1) over 32 streams sharing a 256-token prefix:
    every stream equals ``generate_reference``."""
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

    t0 = time.time()
    draft = TinyCausalLM(seed=1, device=dev, **dict(
        DEC_MODEL, num_layers=DEC_DRAFT_LAYERS))
    engine = DecodeEngine(model, name="decode_spec", device=dev,
                          draft_model=draft, **DEC_ENGINE, **DEC_SPEC)
    warm_caps, warm_misses = decode_warmup(engine, "decode_spec", dev, t0)
    n, prefix_len, suffix, new = DEC_SPEC_TRAFFIC
    prefix = np.random.RandomState(2).randint(0, VOCAB, prefix_len)
    prompts, budgets = decode_traffic(3, n, suffix, new, prefix=prefix)
    t0 = time.time()
    refs = [engine.generate_reference(p, b).tolist()
            for p, b in zip(prompts, budgets)]
    ref_s = time.time() - t0
    streams, wall = decode_run(engine, prompts, budgets)
    if cuda_ops.flash_attention.launches:
        fail("decode_prefix_spec launched flash_attention")
    caps, kv, leaked = decode_checks(engine, "decode_prefix_spec",
                                     warm_caps, warm_misses)
    wrong = [i for i, s in enumerate(streams) if s.tokens() != refs[i]]
    if wrong:
        fail("decode_prefix_spec: %d streams differ from their references,"
             " first %d" % (len(wrong), wrong[0]))
    snap = engine.stats_snapshot()
    if not snap["prefix_hits"]:
        fail("decode_prefix_spec: no prefix hit")
    phase("decode_prefix_spec", streams=n, prefix=prefix_len,
          references_equal=True, reference_s=ref_s,
          prefix_hits=snap["prefix_hits"],
          prefix_blocks_shared=snap["prefix_blocks_shared"],
          cow_forks=snap["cow_forks"], spec_rounds=snap["spec_rounds"],
          spec_proposed=snap["spec_proposed"],
          spec_accepted=snap["spec_accepted"],
          accept_rate=snap["spec_accept_rate"], steps=snap["steps"],
          captures_after_warmup=caps["captures"] - warm_caps,
          leaked_blocks=leaked, card='"%s"' % card,
          **stream_numbers(streams, wall))
    engine.stop()


def decode_fn_inputs(seed, num_blocks):
    """Seeded inputs of the five functions (after params, before pools)."""
    rng = np.random.RandomState(seed)
    S, bs, W = 8, DEC_ENGINE["block_size"], 6
    # each slot its own blocks (1 to W of them), and positions that leave
    # room for propose's and verify's three more tokens: no two slots
    # write one page, so the pages written do not depend on write order
    free = list(rng.permutation(np.arange(1, num_blocks)))
    tables = np.zeros((S, W), np.int32)
    positions = np.zeros(S, np.int32)
    for s in range(S):
        n = 1 + s % W
        tables[s, :n] = [free.pop() for _ in range(n)]
        positions[s] = min(int(rng.randint(0, n * bs)), n * bs - 4)
    i32 = lambda *a: np.asarray(a, np.int32)  # noqa: E731
    toks = np.zeros((1, 64), np.int32)
    toks[0, :40] = rng.randint(0, VOCAB, 40)
    return {
        "prefill_fn": (toks, i32(40), tables[W - 1:W]),
        "decode_fn": (rng.randint(0, VOCAB, S).astype(np.int32), positions,
                      tables),
        "chunk_prefill_fn": (rng.randint(0, VOCAB, (1, 32)).astype(np.int32),
                             i32(16), i32(20), tables[W - 1:W]),
        "verify_fn": (rng.randint(0, VOCAB, (S, 4)).astype(np.int32),
                      positions, rng.randint(0, 5, S).astype(np.int32),
                      tables),
        "propose_fn": (rng.randint(0, VOCAB, S).astype(np.int32), positions,
                       tables),
    }


def decode_vs_cpu(dev):
    """Phase: the decode model cut to 2 layers on the card and on the CPU.
    Each function's logits (propose: its token ids) on the same inputs and
    pools, held at DEC_FP64_FACTOR times the CPU fp32 run's own distance
    from an fp64 run; then four greedy streams, equal on both devices."""
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

    kw = dict(DEC_MODEL, num_layers=DEC_VS_CPU[0])
    models = {"card": TinyCausalLM(seed=3, device=dev, **kw),
              "cpu": TinyCausalLM(seed=3, device="cpu", **kw)}
    p64 = {k: v.double() for k, v in models["cpu"].param_dict().items()}
    nb = 48
    shape = (kw["num_layers"], nb, DEC_ENGINE["block_size"], HEADS,
             DIM // HEADS)
    rng = np.random.RandomState(4)
    kp, vp = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    out = {}
    for fn, args in decode_fn_inputs(5, nb).items():
        extra = (3,) if fn == "propose_fn" else ()
        res = {}
        for key, params, device, dtype in (
                ("card", models["card"].param_dict(), dev, torch.float32),
                ("cpu", models["cpu"].param_dict(), "cpu", torch.float32),
                ("fp64", p64, "cpu", torch.float64)):
            pools = [torch.from_numpy(p).to(device, dtype) for p in (kp, vp)]
            ins = [torch.from_numpy(np.asarray(a)).to(device) for a in args]
            with torch.no_grad():
                got = getattr(models["cpu"], fn)(params, *ins, *pools,
                                                 *extra)[0]
            res[key] = got.cpu().double().numpy()
        if fn == "propose_fn":
            if not np.array_equal(res["card"], res["cpu"]):
                fail("decode_vs_cpu: propose_fn's ids differ card vs CPU")
            out[fn] = {"ids_equal": True}
            continue
        ref = float(np.abs(res["cpu"] - res["fp64"]).max())
        err = float(np.abs(res["card"] - res["cpu"]).max())
        bound = DEC_FP64_FACTOR * ref
        if not err <= bound:
            fail("decode_vs_cpu: %s logits %.3g apart card vs CPU; bound "
                 "%.3g (%g x the CPU's %.3g from fp64)"
                 % (fn, err, bound, DEC_FP64_FACTOR, ref))
        out[fn] = {"max_abs_err": err, "bound": bound, "cpu_vs_fp64": ref,
                   "card_vs_fp64": float(np.abs(res["card"]
                                                - res["fp64"]).max())}
    ecfg = dict(max_slots=4, block_size=DEC_ENGINE["block_size"],
                max_prompt_len=64, max_new_tokens=32)
    prompts, budgets = decode_traffic(6, DEC_VS_CPU[1], (8, 64), (16, 32))
    tokens = {}
    for key in ("card", "cpu"):
        engine = DecodeEngine(models[key], name="vs_" + key, **ecfg)
        try:
            streams, _ = decode_run(engine, prompts, budgets)
            tokens[key] = [s.tokens() for s in streams]
        finally:
            engine.stop()
    if tokens["card"] != tokens["cpu"]:
        fail("decode_vs_cpu: greedy streams differ card vs CPU")
    phase("decode_vs_cpu", layers=kw["num_layers"], functions=json.dumps(out),
          fp64_factor=DEC_FP64_FACTOR, streams=len(prompts),
          streams_equal=True)


def decode_phases(cuda_ops, dev, card):
    """The decode engine's phases; returns flash_attention's launches over
    them, which each phase holds at 0: the decode path (attention in
    plain torch ops, as the JAX package's is jnp) launches no hand
    kernel."""
    reset_launches(cuda_ops)
    model, engine, server, served = decode_serve(cuda_ops, dev, card)
    static = decode_static(cuda_ops, dev, card, model, served)
    prompts = served[0]
    decode_handoff(engine, static, prompts[int(np.argmin(
        [abs(len(p) - 128) for p in prompts]))])
    server.stop()            # stops the attached engine
    static.stop()
    if engine.submit([1]).status != "UNAVAILABLE":
        fail("ModelServer.stop() left its decode engine running")
    del engine, static, server, served
    decode_prefix_spec(cuda_ops, dev, card, model)
    del model
    decode_vs_cpu(dev)
    launches = cuda_ops.flash_attention.launches
    if launches:
        fail("the decode phases launched flash_attention %d times"
             % launches)
    return launches


def beyond_bound(got, want):
    """(max abs difference, whether any element lies beyond the JAX
    hybridize bound)."""
    return (float(np.abs(got - want).max()),
            not np.allclose(got, want, rtol=HYBRID_RTOL, atol=HYBRID_ATOL))


def file_sizes(prefix):
    import os
    return {ext: os.path.getsize(prefix + ext)
            for ext in ("-symbol.json", "-0000.params")}


def exported_serve(cuda_ops, dev, card, workdir):
    """Phase: the full-width LM served from its saved files.  The LM built
    as ``serve`` builds it is traced over ``sym.var("data")`` and
    ``sym.var("pos_idx")``, its graph and ``.params`` written, and
    ``ModelServer.load_exported`` serves ``serve``'s 18 requests on the
    same ladder.  Every answer is OK and within the JAX hybridize bound of
    the native block's for the same request, and torch.profiler sees the
    kernel once a layer in one replay at each length: the imported graph
    runs ``_contrib_flash_attention`` in the hand kernel, inside the
    registry's CUDA graph.  Returns the kernel's launches here."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch import symbol as sym

    net = new_lm(dev, DEPTH, 0)
    prefix = str(workdir / "lm")
    t0 = time.time()
    net(sym.var("data"), sym.var("pos_idx")).save(prefix + "-symbol.json")
    net.collect_params().save(prefix + "-0000.params")
    save_s = time.time() - t0
    requests = lm_requests()
    with torch.inference_mode():
        native = [net(*(torch.from_numpy(a)[None].to(dev) for a in r))[0]
                  .cpu().numpy() for r in requests]
    short = [r for r in requests if len(r[0]) == SERVE_LENGTHS[0]][:4]
    arrays = [np.stack([r[j] for r in short]) for j in range(2)]
    with torch.inference_mode():
        native_batch = net(*(torch.from_numpy(a).to(dev)
                             for a in arrays)).cpu().numpy()
    del net
    server = serving.ModelServer()
    reset_launches(cuda_ops)
    try:
        t0 = time.time()
        model = server.load_exported(
            "lm", prefix, input_names=("data", "pos_idx"),
            input_shapes=[((T,), (T,)) for T in SERVE_LENGTHS],
            dtype=("int32", "int32"), batch_ladder=list(LADDER),
            linger_ms=20.0, max_queue=64, device=dev, warmup=False)
        import_s = time.time() - t0
        t0 = time.time()
        warm = model.warmup()
        warmup_s = time.time() - t0
        results, wall = serve_concurrently(server, "lm", requests)
        snap = server.stats()["models"]["lm"]
        graphed = model.execute(arrays)[0]
        cache, caps = model.cache_stats(), model.capture_stats()
        eager_launches = cuda_ops.flash_attention.launches
        per_replay = {}
        for T in SERVE_LENGTHS:
            batch = [np.zeros((1, T), np.int32)] * 2
            per_replay[T] = replayed_launches(
                lambda: model.execute(batch))[0]
    finally:
        server.stop()
    if cuda_ops.flash_attention.launches != eager_launches:
        fail("exported_serve: a graph replay called the kernel's wrapper")
    bad = [(i, r.status, r.error) for i, r in enumerate(results)
           if r.status != serving.OK]
    if bad:
        fail("exported_serve: requests not OK: %s" % bad)
    worst = 0.0
    for i, (r, want) in enumerate(zip(results, native)):
        if r.output.shape != want.shape or not np.isfinite(r.output).all():
            fail("exported_serve: bad logits %s for request %d"
                 % (r.output.shape, i))
        err, beyond = beyond_bound(r.output, want)
        worst = max(worst, err)
        if beyond:
            fail("exported_serve: request %d's logits lie beyond the "
                 "hybridize bound of the native block's: max abs %.3g"
                 % (i, err))
    batch_err, beyond = beyond_bound(graphed, native_batch)
    if beyond:
        fail("exported_serve: a padded batch lies beyond the bound of the "
             "native block on the same batch: max abs %.3g" % batch_err)
    sigs = len(SERVE_LENGTHS) * len(LADDER)
    if warm["signatures"] != sigs or caps["captures"] != sigs or \
            cache["misses"] != warm["cache"]["misses"]:
        fail("exported_serve: %s captures for %d signatures, %s misses "
             "after warmup's %s" % (caps["captures"], sigs,
                                    cache["misses"], warm["cache"]))
    batches = warm["signatures"] + snap["batches"] + 1
    if caps["replays"] != batches:
        fail("exported_serve: %d graph replays for %d batches"
             % (caps["replays"], batches))
    if eager_launches != DEPTH * caps["eager_runs"]:
        fail("exported_serve: %d eager launches, not %d layers x %d "
             "warm-up runs" % (eager_launches, DEPTH, caps["eager_runs"]))
    if set(per_replay.values()) != {DEPTH}:
        fail("exported_serve: the profiler saw the kernel %s times in one "
             "replay (by length), not %d" % (per_replay, DEPTH))
    launches = eager_launches + caps["replays"] * DEPTH
    lat = sorted(r.latency_ms for r in results)
    tokens = sum(len(tok) for tok, _ in requests)
    phase("exported_serve_files", save_s=save_s, import_s=import_s,
          warmup_s=warmup_s, signatures=warm["signatures"],
          bytes=json.dumps(file_sizes(prefix)), card='"%s"' % card)
    phase("exported_serve", requests=len(requests), ok=len(results),
          batches=snap["batches"], avg_batch=snap["avg_batch"],
          launches=launches, eager_warmup_runs=caps["eager_runs"],
          replays=caps["replays"],
          profiler_kernel_launches_per_replay=json.dumps(per_replay),
          max_abs_err_vs_native=worst, batch_max_abs_err=batch_err,
          batch_bitwise=bool(np.array_equal(graphed, native_batch)),
          rtol=HYBRID_RTOL, atol=HYBRID_ATOL,
          p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)), tokens=tokens,
          tokens_per_s=tokens / wall, card='"%s"' % card)
    return launches


def exported_resnet(cuda_ops, dev, card, workdir):
    """Phase: resnet50_v1 at 224 x 224, NCHW, fp32, ``export``ed and
    served by ``load_exported`` on a ladder up to batch 32: requests one
    at a time and a full batch of 32, each within the hybridize bound of
    the native block on the same batch; no flash_attention launch."""
    from mxnet_tpu_torch import serving

    net = new_resnet(dev, 0)
    prefix = str(workdir / "resnet50_v1")
    t0 = time.time()
    net.export(prefix)
    save_s = time.time() - t0
    rng = np.random.RandomState(5)
    side = RESNET_SIZE
    images = [rng.normal(0, 1, (3, side, side)).astype(np.float32)
              for _ in range(EXP_RESNET_REQUESTS)]
    full = rng.normal(0, 1, (EXP_RESNET_LADDER[-1], 3, side, side)).astype(
        np.float32)
    with torch.inference_mode():
        native = [net(torch.from_numpy(x)[None].to(dev))[0].cpu().numpy()
                  for x in images]
        native_full = net(torch.from_numpy(full).to(dev)).cpu().numpy()
    del net
    reset_launches(cuda_ops)
    server = serving.ModelServer()
    try:
        t0 = time.time()
        model = server.load_exported(
            "resnet50_v1", prefix, input_shapes=[(3, side, side)],
            batch_ladder=list(EXP_RESNET_LADDER), device=dev, warmup=False)
        import_s = time.time() - t0
        t0 = time.time()
        warm = model.warmup()
        warmup_s = time.time() - t0
        t0 = time.time()
        results = [server.predict("resnet50_v1", x, timeout_ms=120000)
                   for x in images]
        wall = time.time() - t0
        graphed = model.execute([full])[0]
        caps = model.capture_stats()
        per_replay = kernel_count(device_profile(
            lambda: model.execute([full[:1]]))[1])
    finally:
        server.stop()
    if cuda_ops.flash_attention.launches or per_replay:
        fail("exported_resnet launched flash_attention")
    bad = [(i, r.status, r.error) for i, r in enumerate(results)
           if r.status != serving.OK]
    if bad:
        fail("exported_resnet: requests not OK: %s" % bad)
    worst = 0.0
    for i, (r, want) in enumerate(zip(results, native)):
        err, beyond = beyond_bound(r.output, want)
        worst = max(worst, err)
        if beyond or r.output.shape != (1000,):
            fail("exported_resnet: request %d beyond the bound of the "
                 "native block: max abs %.3g" % (i, err))
    full_err, beyond = beyond_bound(graphed, native_full)
    if beyond:
        fail("exported_resnet: the batch of %d beyond the bound of the "
             "native block: max abs %.3g" % (len(full), full_err))
    if caps["captures"] != len(EXP_RESNET_LADDER):
        fail("exported_resnet: %d captures for %d rungs"
             % (caps["captures"], len(EXP_RESNET_LADDER)))
    lat = sorted(r.latency_ms for r in results)
    phase("exported_resnet", network="resnet50_v1", image=(3, side, side),
          ladder=list(EXP_RESNET_LADDER), save_s=save_s, import_s=import_s,
          warmup_s=warmup_s, captures=caps["captures"],
          bytes=json.dumps(file_sizes(prefix)), requests=len(results),
          ok=len(results), max_abs_err_vs_native=worst,
          batch=len(full), batch_max_abs_err=full_err,
          batch_bitwise=bool(np.array_equal(graphed, native_full)),
          p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)),
          images_per_s=len(results) / wall, flash_attention_launches=0,
          card='"%s"' % card)


def exported_decode(cuda_ops, dev, card, workdir):
    """Phase: TinyGluonLM at the bench LM's widths (depth cut to
    EXP_DEC_LAYERS), ``export``ed and imported by ``SymbolBlock.imports``,
    served through ``GluonCausalLMAdapter`` and the decode engine: its
    greedy streams are token-identical to the same adapter over the native
    block, with no capture after warmup and no block leaked.  The imported
    graph itself runs too: called twice on one token batch on the card
    (one capture in the block's CachedOp, two replays), its logits lie
    within the hybridize bound of the native block's."""
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    from mxnet_tpu_torch.serving.decode import (DecodeEngine,
                                                GluonCausalLMAdapter,
                                                TinyCausalLM, TinyGluonLM)
    from mxnet_tpu_torch.serving.decode.adapter import copy_reference_weights

    kw = dict(DEC_MODEL, num_layers=EXP_DEC_LAYERS)
    block = TinyGluonLM(device=dev, **kw)
    copy_reference_weights(block, TinyCausalLM(seed=4, device=dev, **kw))
    prefix = str(workdir / "tiny_gluon_lm")
    block.export(prefix)
    t0 = time.time()
    imported = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                   prefix + "-0000.params", ctx=dev)
    import_s = time.time() - t0
    batch = torch.from_numpy(np.random.RandomState(8).randint(
        0, kw["vocab_size"], (4, EXP_DEC_ENGINE["max_prompt_len"]))
        .astype(np.int32)).to(dev)
    with torch.no_grad():
        want = block(batch).cpu().numpy()
        graph_out = [imported(batch).cpu().numpy() for _ in range(2)]
    graph_caps = imported._cached_op.capture_stats()
    if (graph_caps["captures"], graph_caps["replays"]) != (1, 2):
        fail("exported_decode: the imported block's CachedOp made %s "
             "captures and %s replays for two calls of one signature, not "
             "1 and 2" % (graph_caps["captures"], graph_caps["replays"]))
    graph_err = 0.0
    for got in graph_out:
        err, beyond = beyond_bound(got, want)
        graph_err = max(graph_err, err)
        if got.shape != want.shape or beyond:
            fail("exported_decode: the imported graph's logits %s lie "
                 "beyond the hybridize bound of the native block's %s: max "
                 "abs %.3g" % (got.shape, want.shape, err))
    prompts, budgets = decode_traffic(7, *EXP_DEC_TRAFFIC)
    tokens, numbers = {}, {}
    for key, source in (("native", block), ("imported", imported)):
        t0 = time.time()
        engine = DecodeEngine(GluonCausalLMAdapter(source, num_heads=HEADS),
                              name="exported_decode_" + key, device=dev,
                              **EXP_DEC_ENGINE)
        try:
            warm_caps, warm_misses = decode_warmup(
                engine, "exported_decode_" + key, dev, t0)
            streams, wall = decode_run(engine, prompts, budgets)
            decode_checks(engine, "exported_decode_" + key, warm_caps,
                          warm_misses)
        finally:
            engine.stop()
        tokens[key] = [s.tokens() for s in streams]
        numbers[key] = stream_numbers(streams, wall)
    wrong = [i for i, (a, b) in enumerate(zip(tokens["native"],
                                              tokens["imported"])) if a != b]
    if wrong:
        fail("exported_decode: %d streams differ between the native and "
             "the imported block, first %d" % (len(wrong), wrong[0]))
    if cuda_ops.flash_attention.launches:
        fail("exported_decode launched flash_attention")
    phase("exported_decode", layers=EXP_DEC_LAYERS, streams=len(prompts),
          tokens_identical=True, import_s=import_s,
          graph_batch=json.dumps(list(want.shape)),
          graph_max_abs_err_vs_native=graph_err,
          bytes=json.dumps(file_sizes(prefix)),
          native=json.dumps(numbers["native"]),
          imported=json.dumps(numbers["imported"]), card='"%s"' % card)


def exported_phases(cuda_ops, dev, card):
    """The saved-model phases, their files in a temporary directory;
    returns the kernel's launches (``exported_serve``'s)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        launches = exported_serve(cuda_ops, dev, card, Path(tmp))
        exported_resnet(cuda_ops, dev, card, Path(tmp))
        reset_launches(cuda_ops)
        exported_decode(cuda_ops, dev, card, Path(tmp))
    return launches


# ---------------------------------------------------------------------------
# the serving tier (serving/fleet.py, disagg/, traffic.py, deploy.py)
# ---------------------------------------------------------------------------

def sampling_of(i):
    """Every 4th stream seeded-sampled, the others greedy."""
    return dict(SAMPLED, seed=1000 + i) if i % 4 == 3 else {}


ENGINE_IDS = itertools.count()


def named_engines(build):
    """A fleet's engine factory over ``build(name)``: each engine gets a
    name of its own (the fleet's name and a count shared by the whole
    run), so that its ``kv:<name>`` accounting region is its own across
    replicas, tiers and generations."""
    return lambda name: build("%s#%d" % (name, next(ENGINE_IDS)))


def whole_set_pool(n):
    """DEC_ENGINE with a KV pool that holds ``n`` worst-case streams at
    once, as tools/serve_bench.py's fleet-decode, disagg and deploy
    profiles size theirs (:329-333): a survivor, a decode tier or a
    retiring sink then always has the blocks a handoff reserves, and the
    handoff itself is what the phase tests."""
    per_stream = -(-(DEC_ENGINE["max_prompt_len"]
                     + DEC_ENGINE["max_new_tokens"])
                   // DEC_ENGINE["block_size"])
    return dict(DEC_ENGINE, num_blocks=n * per_stream + 1)


def warm_state(engine, dev):
    """(captures, signature misses) of a fleet engine's warmup: every
    signature captured once on the card (none on the CPU)."""
    warm = engine.warmup_report
    want = warm["signatures"] if dev.type == "cuda" else 0
    if warm["compiles"] != warm["signatures"] or warm["captures"] != want:
        fail("%s: warmup %s" % (engine.name, warm))
    return warm["captures"], warm["cache"]["misses"]


def engines_whole(label, engines, warm):
    """No capture after warmup, every KV block back and each engine's
    accounting region empty, for every engine of a phase (``warm``: name
    -> its warm_state)."""
    from mxnet_tpu_torch import memory_accounting

    regions = memory_accounting.memory_counters()
    for eng in engines:
        decode_checks(eng, "%s %s" % (label, eng.name), *warm[eng.name])
        live = regions.get("kv:%s" % eng.name, {}).get("live_bytes", 0)
        if live:
            fail("%s: %s's accounting region holds %d bytes after the "
                 "traffic" % (label, eng.name, live))


def conserved(stats):
    return stats["requests"] == (stats["ok"] + stats["timeouts"]
                                 + stats["errors"] + stats["unavailable"])


def references(engine, prompts, budgets):
    """``generate_reference`` of every request (sampled ones replayed from
    their seeds)."""
    return [engine.generate_reference(p, b, **sampling_of(i)).tolist()
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def fleet_serve(cuda_ops, dev, card):
    """Phase: ``serve``'s LM (seed 0: the same weights) behind a
    FleetRouter of FLEET_REPLICAS ModelServers on ``serve``'s ladder and
    lengths.  Four clients send ``lm_requests()`` through
    ``router.predict``.  After FLEET_KILL_AFTER answers one replica is
    paused until a request waits on it, then killed (``kill_replica``):
    that request fails over.  A replica then joins (``add_replica``) and
    the rebalance re-warms a copy on it while the clients keep going.
    Once the fleet has converged, FLEET_PROBES of the requests go again,
    one at a time, so the round robin reaches the joined copy.  Every
    request OK, the fleet's counts conserved, one death and at least one
    failover, each answer within ``serve``'s bound of the single
    server's, captures only at each copy's warmup (the joining copy's
    included), the joined copy serving, and the kernel in every replayed
    batch.  Returns the kernel's launches here."""
    from mxnet_tpu_torch import serving

    single = REFS.pop("served")
    net = new_lm(dev, DEPTH, 0)
    requests = lm_requests()
    router = serving.FleetRouter(replicas=FLEET_REPLICAS)
    reset_launches(cuda_ops)
    try:
        t0 = time.time()
        router.load_model(
            "lm", net, input_shapes=[((T,), (T,)) for T in SERVE_LENGTHS],
            replicas=FLEET_REPLICAS, dtype=("int32", "int32"),
            batch_ladder=list(LADDER), linger_ms=20.0, max_queue=64,
            device=dev)
        load_s = time.time() - t0
        placed = router.stats()["models"]["lm"]["placement"]
        copies = {rid: router.server(rid)._registry.get("lm")
                  for rid in placed}
        victim = placed[0]
        results = [None] * len(requests)
        spans = [None] * len(requests)
        lock = threading.Lock()
        answered = [0]
        enough = threading.Event()

        def client(worker):
            for i in range(worker, len(requests), 4):
                t = time.time()
                results[i] = router.predict("lm", requests[i],
                                            timeout_ms=120000)
                spans[i] = (t, time.time())
                with lock:
                    answered[0] += 1
                    if answered[0] >= FLEET_KILL_AFTER:
                        enough.set()

        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(4)]
        t0 = time.time()
        for t in threads:
            t.start()
        if not enough.wait(300):
            fail("fleet_serve: %d answers in 300 s" % answered[0])
        # the paused batcher finishes the batch it holds; once every
        # request it admitted and has not answered is in its queue, those
        # requests can only end by the kill
        router.server(victim).pause("lm")
        deadline = time.time() + 120
        while True:
            vs = copies[victim].stats.snapshot()
            waiting = vs["requests"] - (vs["ok"] + vs["timeouts"]
                                        + vs["errors"] + vs["unavailable"])
            if vs["queue_depth"] and waiting == vs["queue_depth"]:
                break
            if time.time() > deadline:
                fail("fleet_serve: no request waited on the paused replica")
            time.sleep(0.001)
        t_kill = time.time()
        router.kill_replica(victim)
        kill_s = time.time() - t_kill
        t_join = time.time()
        joined = router.add_replica()
        join_s = time.time() - t_join
        if not router.wait_converged(timeout_s=120.0):
            fail("fleet_serve: the fleet did not converge after the join")
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            fail("fleet_serve: client threads did not finish")
        wall = max(b for _, b in spans) - t0
        probes = [router.predict("lm", requests[i], timeout_ms=120000)
                  for i in range(FLEET_PROBES)]
        snap = router.stats()
        health = router.health("lm")
        copies[joined] = router.server(joined)._registry.get("lm")
        caps = {rid: m.capture_stats() for rid, m in copies.items()}
        batches = {rid: m.stats.snapshot()["batches"]
                   for rid, m in copies.items()}
        warm = {rid: m.warmup_report["signatures"]
                for rid, m in copies.items()}
        eager_launches = cuda_ops.flash_attention.launches
        per_replay = None
        if dev.type == "cuda":
            batch = [np.zeros((1, SERVE_LENGTHS[0]), np.int32)] * 2
            per_replay = replayed_launches(
                lambda: copies[joined].execute(batch))[0]
    finally:
        router.stop()
    answers = results + probes
    bad = [(i, r.status, r.error) for i, r in enumerate(answers)
           if r is None or r.status != serving.OK]
    if bad:
        fail("fleet_serve: requests not OK: %s" % bad)
    if not conserved(snap):
        fail("fleet_serve: counts not conserved: %s" % snap)
    if snap["replica_deaths"] != 1 or snap["failovers"] < 1:
        fail("fleet_serve: %d deaths and %d failovers, not 1 and >= 1"
             % (snap["replica_deaths"], snap["failovers"]))
    if health != serving.HEALTHY or sorted(
            snap["models"]["lm"]["placement"]) != sorted(
            [r for r in placed if r != victim] + [joined]):
        fail("fleet_serve: the fleet ended %s on %s" % (
            health, snap["models"]["lm"]["placement"]))
    worst = 0.0
    for i, (r, want) in enumerate(zip(answers, single + single)):
        if r.output.shape != want.shape:
            fail("fleet_serve: request %d gave %s, the single server %s"
                 % (i, r.output.shape, want.shape))
        worst = max(worst, float(np.abs(r.output - want).max()))
        if not np.allclose(r.output, want, atol=SERVE_ATOL,
                           rtol=SERVE_RTOL):
            fail("fleet_serve: request %d lies %.3g from the single "
                 "server's answer" % (i, float(np.abs(r.output - want)
                                               .max())))
    if not batches[joined]:
        fail("fleet_serve: the joined copy served no batch")
    want_caps = 1 if dev.type == "cuda" else 0
    for rid, c in caps.items():
        if c["captures"] != want_caps * warm[rid] or \
                c["replays"] != want_caps * (warm[rid] + batches[rid]):
            fail("fleet_serve: replica %s made %d captures and %d replays "
                 "for %d signatures and %d batches" % (
                     rid, c["captures"], c["replays"], warm[rid],
                     batches[rid]))
    launches = eager_launches
    if dev.type == "cuda":
        if eager_launches != DEPTH * sum(c["eager_runs"]
                                         for c in caps.values()):
            fail("fleet_serve: %d eager launches for %d warm-up runs"
                 % (eager_launches, sum(c["eager_runs"]
                                        for c in caps.values())))
        if per_replay != DEPTH:
            fail("fleet_serve: the profiler saw the kernel %s times in one "
                 "replay of the joined copy, not %d" % (per_replay, DEPTH))
        launches += DEPTH * sum(c["replays"] for c in caps.values())
        if not launches:
            fail("fleet_serve launched flash_attention 0 times")
    lat = [r.latency_ms for r in results]
    rewarm = [r.latency_ms for r, (a, b) in zip(results, spans)
              if a < t_join + join_s and b > t_join]
    other = [r.latency_ms for r, (a, b) in zip(results, spans)
             if not (a < t_join + join_s and b > t_join)]
    tokens = sum(len(tok) for tok, _ in requests)
    phase("fleet_serve", replicas=FLEET_REPLICAS, probes=FLEET_PROBES,
          requests=snap["requests"],
          ok=snap["ok"], failovers=snap["failovers"],
          replica_deaths=snap["replica_deaths"],
          rebalances=snap["rebalances"], conserved=True,
          max_abs_err_vs_single=worst, atol=SERVE_ATOL, rtol=SERVE_RTOL,
          captures=json.dumps({r: c["captures"] for r, c in caps.items()}),
          batches=json.dumps(batches), launches=launches, load_s=load_s,
          kill_s=kill_s, join_rewarm_s=join_s,
          p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)),
          during_rewarm_p50_ms=(float(np.median(rewarm)) if rewarm
                                else None),
          during_rewarm_requests=len(rewarm),
          other_p50_ms=float(np.median(other)) if other else None,
          tokens_per_s=tokens / wall, card='"%s"' % card)
    return launches


def fleet_decode(cuda_ops, dev, card):
    """Phase: ``load_decode`` of a TinyCausalLM at the bench LM's widths
    on FLEET_REPLICAS replicas (DEC_ENGINE), FLEET_DEC_STREAMS streams at
    DEC_TRAFFIC's ranges submitted at once (every 4th seeded-sampled), and
    one replica drained once half of them have their first token: its
    live streams hand off to the survivor.  Every stream OK and
    token-identical to ``generate_reference``, handoffs equal to the
    drained engine's exports and > 0, nothing fenced, no capture after
    warmup and no block leaked on either engine, the ledger conserved.
    Returns the streams a second the fleet sustained."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

    reset_launches(cuda_ops)
    t0 = time.time()
    model = TinyCausalLM(seed=0, device=dev, **DEC_MODEL)
    router = serving.FleetRouter(replicas=FLEET_REPLICAS)
    try:
        router.load_decode("lm", named_engines(
            lambda name: DecodeEngine(model, name=name, device=dev,
                                      **whole_set_pool(FLEET_DEC_STREAMS))),
            replicas=FLEET_REPLICAS)
        load_s = time.time() - t0
        placed = router.stats()["decode_models"]["lm"]["placement"]
        engines = {rid: router.engine("lm", rid) for rid in placed}
        warm = {e.name: warm_state(e, dev) for e in engines.values()}
        prompts, budgets = decode_traffic(12, FLEET_DEC_STREAMS,
                                          *DEC_TRAFFIC[1:])
        t0 = time.time()
        streams = [router.submit_stream(
            "lm", p, max_new_tokens=b, timeout_ms=600000, **sampling_of(i))
            for i, (p, b) in enumerate(zip(prompts, budgets))]
        deadline = time.time() + 300
        while sum(1 for s in streams if s.tokens()) < len(streams) // 2:
            if time.time() > deadline:
                fail("fleet_decode: half the streams had no token in 300 s")
            time.sleep(0.001)
        victim = placed[0]
        t_drain = time.time()
        router.drain(victim)
        drain_s = time.time() - t_drain
        for s in streams:
            if not s.wait(900):
                fail("fleet_decode: a stream never ended")
        wall = time.time() - t0
        ledger = router.decode_stats.snapshot()
        exported = engines[victim].stats_snapshot()["handed_off"]
        requests = {rid: e.stats_snapshot()["requests"]
                    for rid, e in engines.items()}
        t0 = time.time()
        ref = DecodeEngine(model, name="fleet_decode_ref", device=dev,
                           warmup=False, **DEC_ENGINE)
        try:
            refs = references(ref, prompts, budgets)
        finally:
            ref.stop()
        ref_s = time.time() - t0
        engines_whole("fleet_decode", engines.values(), warm)
    finally:
        router.stop()
    bad = [(i, s.status, s.error) for i, s in enumerate(streams)
           if s.status != "OK"]
    if bad:
        fail("fleet_decode: streams not OK: %s" % bad[:5])
    wrong = [i for i, (s, r) in enumerate(zip(streams, refs))
             if s.tokens() != r]
    if wrong:
        fail("fleet_decode: %d streams differ from their references, "
             "first %d" % (len(wrong), wrong[0]))
    if not conserved(ledger):
        fail("fleet_decode: the ledger is not conserved: %s" % ledger)
    if ledger["handoffs"] != exported or not exported or ledger["fenced"]:
        fail("fleet_decode: %d handoffs for %d streams exported by the "
             "drained replica, %d fenced" % (ledger["handoffs"], exported,
                                             ledger["fenced"]))
    if cuda_ops.flash_attention.launches:
        fail("fleet_decode launched flash_attention")
    numbers = stream_numbers(streams, wall)
    phase("fleet_decode", replicas=FLEET_REPLICAS, streams=len(streams),
          ok=ledger["ok"], sampled=sum(1 for i in range(len(streams))
                                        if sampling_of(i)),
          tokens_identical=True, handoffs=ledger["handoffs"],
          fenced=ledger["fenced"], requests_by_replica=json.dumps(requests),
          drain_s=drain_s, load_s=load_s, reference_s=ref_s,
          captures_after_warmup=0, leaked_blocks=0, card='"%s"' % card,
          **numbers)
    return len(streams) / wall


def open_loop(submit_stream, arrivals, tenants, prompts, budgets,
              on_submit=None):
    """Fire one stream at each arrival through ``traffic.replay`` (the
    open loop: nothing waits on a stream) and wait them all out.
    Returns the streams, their submit times, the arrivals fired and the
    wall seconds."""
    from mxnet_tpu_torch.serving import traffic

    streams = [None] * len(arrivals)
    submitted = [None] * len(arrivals)

    def submit(i, _t):
        submitted[i] = time.time()
        streams[i] = submit_stream(
            "lm", prompts[i], max_new_tokens=budgets[i], timeout_ms=600000,
            tenant=tenants[i], **sampling_of(i))
        if on_submit is not None:
            on_submit(i)

    t0 = time.time()
    fired = traffic.replay(arrivals, submit)
    for s in streams:
        if s is None or not s.wait(900):
            fail("open loop: a stream was not submitted or never ended")
    return streams, submitted, fired, time.time() - t0


def leg_numbers(streams, wall):
    """Per-leg figures: statuses, TTFT/TPOT p50/p99 over the OK streams,
    and goodput under the disagg profile's SLOs (no limit is held)."""
    from mxnet_tpu_torch.serving.stats import goodput_under_slo

    statuses = {}
    for s in streams:
        statuses[s.status] = statuses.get(s.status, 0) + 1
    good = goodput_under_slo(
        [{"status": s.status, "ttft_ms": s.ttft_ms,
          "latency_ms": s.latency_ms, "tokens": len(s.tokens())}
         for s in streams], slo_ttft_ms=DISAGG_SLO_MS[0],
        slo_tpot_ms=DISAGG_SLO_MS[1])
    return {"statuses": json.dumps(statuses),
            "ttft_p50_ms": good["ttft_ms"]["p50"],
            "ttft_p99_ms": good["ttft_ms"]["p99"],
            "tpot_p50_ms": good["tpot_ms"]["p50"],
            "tpot_p99_ms": good["tpot_ms"]["p99"],
            "goodput": good["good"], "goodput_per_s": good["good"] / wall,
            "tokens_per_s": sum(len(s.tokens()) for s in streams) / wall}


def check_leg(label, arrivals, fired, streams, refs):
    if not (len(arrivals) == fired == sum(1 for s in streams
                                          if s.status is not None)):
        fail("%s: %d arrivals, %d fired, %d terminal" % (
            label, len(arrivals), fired,
            sum(1 for s in streams if s.status is not None)))
    wrong = [i for i, (s, r) in enumerate(zip(streams, refs))
             if s.status == "OK" and s.tokens() != r]
    if wrong:
        fail("%s: %d OK streams differ from their references, first %d"
             % (label, len(wrong), wrong[0]))


def disagg(cuda_ops, dev, card, rate):
    """Phase: the disaggregated pair, a prefill tier of one
    ``prefill_only`` engine (chunks of DISAGG_CHUNK) and a decode tier of
    one engine, at the bench LM's widths, under an open-loop Poisson trace
    of about DISAGG_ARRIVALS arrivals at ``rate`` (half what
    ``fleet_decode`` sustained), tenants drawn from DISAGG_TENANTS, every
    4th stream seeded-sampled; then the same trace through a colocated
    fleet of two full engines.  On both legs: every arrival fired and
    terminal, every OK stream equal to ``generate_reference``, no capture
    after warmup and no block leaked; on the pair, one handoff for each
    stream the prefill tier admitted.  TTFT/TPOT, handoff ms and goodput
    under the disagg profile's SLOs are reported with no limit."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import traffic
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
    from mxnet_tpu_torch.serving.disagg import DisaggRouter

    reset_launches(cuda_ops)
    model = TinyCausalLM(seed=0, device=dev, **DEC_MODEL)
    arrivals = traffic.poisson_trace(rate, DISAGG_ARRIVALS / rate, seed=0)
    kw = dict(whole_set_pool(len(arrivals)), prefill_chunk=DISAGG_CHUNK)
    full = named_engines(lambda name: DecodeEngine(model, name=name,
                                                   device=dev, **kw))
    tenants = traffic.tenant_mix(arrivals, DISAGG_TENANTS, seed=1)
    prompts, budgets = decode_traffic(13, len(arrivals), *DEC_TRAFFIC[1:])
    t0 = time.time()
    ref = DecodeEngine(model, name="disagg_ref", device=dev, warmup=False,
                       prefill_chunk=DISAGG_CHUNK, **DEC_ENGINE)
    try:
        refs = references(ref, prompts, budgets)
    finally:
        ref.stop()
    ref_s = time.time() - t0
    legs = {}

    t0 = time.time()
    pair = DisaggRouter(prefill_replicas=1, decode_replicas=1)
    try:
        pair.load("lm", named_engines(lambda name: DecodeEngine(
            model, name=name, device=dev, prefill_only=True, **kw)), full)
        load_s = time.time() - t0
        engines = [tier.engine("lm", rid) for tier in (pair.prefill,
                                                       pair.decode)
                   for rid in tier.stats()["decode_models"]["lm"][
                       "placement"]]
        warm = {e.name: warm_state(e, dev) for e in engines}
        streams, _, fired, wall = open_loop(pair.submit_stream, arrivals,
                                            tenants, prompts, budgets)
        ledger = pair.prefill.decode_stats.snapshot()
        hand = pair.stats()["disagg"]
        engines_whole("disagg", engines, warm)
    finally:
        pair.stop()
    check_leg("disagg", arrivals, fired, streams, refs)
    if not conserved(ledger):
        fail("disagg: the ledger is not conserved: %s" % ledger)
    if hand["handoffs"] != ledger["requests"] or hand["handoff_failures"]:
        fail("disagg: %d handoffs (%d failed) for %d streams admitted to "
             "prefill" % (hand["handoffs"], hand["handoff_failures"],
                          ledger["requests"]))
    legs["disagg"] = dict(leg_numbers(streams, wall), load_s=load_s,
                          handoffs=hand["handoffs"],
                          handoff_p50_ms=hand["handoff_ms"]["p50"],
                          handoff_p99_ms=hand["handoff_ms"]["p99"])

    t0 = time.time()
    router = serving.FleetRouter(replicas=2)
    try:
        router.load_decode("lm", full, replicas=2)
        load_s = time.time() - t0
        engines = [router.engine("lm", rid) for rid in
                   router.stats()["decode_models"]["lm"]["placement"]]
        warm = {e.name: warm_state(e, dev) for e in engines}
        streams, _, fired, wall = open_loop(router.submit_stream, arrivals,
                                            tenants, prompts, budgets)
        ledger = router.decode_stats.snapshot()
        engines_whole("disagg colocated", engines, warm)
    finally:
        router.stop()
    check_leg("disagg colocated", arrivals, fired, streams, refs)
    if not conserved(ledger) or ledger["handoffs"]:
        fail("disagg colocated: ledger %s" % ledger)
    legs["colocated"] = dict(leg_numbers(streams, wall), load_s=load_s)
    if cuda_ops.flash_attention.launches:
        fail("disagg launched flash_attention")
    phase("disagg", arrivals=len(arrivals), rate_hz=rate,
          tenants=json.dumps({t: tenants.count(t) for t in DISAGG_TENANTS}),
          references_equal=True, reference_s=ref_s,
          slo_ms=json.dumps(DISAGG_SLO_MS),
          disagg=json.dumps(legs["disagg"]),
          colocated=json.dumps(legs["colocated"]), card='"%s"' % card)


def deploy(cuda_ops, dev, card, rate):
    """Phase: a live weight swap.  Generations 1 and 2 of a TinyCausalLM
    at the bench LM's widths (seeds 0 and 1) are written by
    ``model.save_checkpoint`` with the manifest into a temporary prefix
    before any traffic (the 330 MB writes sit outside every timed
    window); a DeploymentController over a 2-replica decode fleet
    (builder: ``TinyCausalLM(params=arg_params)``) boots it with
    ``deploy(1)``.  An open-loop Poisson trace of about DEPLOY_ARRIVALS
    arrivals at ``rate`` runs, and at arrival DEPLOY_AT the controller's
    ``poll()`` finds generation 2 and rolls it across the live fleet;
    four probes follow the swap.  Every arrival and probe OK, the ledger
    conserved, each OK stream equal to exactly one generation's
    reference (none torn, both seen, the probes on generation 2), no
    capture after warmup on the retired and the new engines, no block
    leaked on any engine.  The swap's seconds, captures per replica,
    handoffs and fences, and TTFT p99 inside the swap window against
    outside it, are reported with no limit."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import model as model_io
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import deploy as deploy_io
    from mxnet_tpu_torch.serving import traffic
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM

    reset_launches(cuda_ops)

    def build(srv_name, arg_params, aux_params, generation):
        lm = TinyCausalLM(params=arg_params, device=dev, **DEC_MODEL)
        return DecodeEngine(lm, name="%s#%d" % (srv_name, next(ENGINE_IDS)),
                            generation=generation, device=dev, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "tiny_lm")
        t0 = time.time()
        for epoch, seed in ((1, 0), (2, 1)):
            lm = TinyCausalLM(seed=seed, device="cpu", **DEC_MODEL)
            model_io.save_checkpoint(prefix, epoch, mx.sym.var("data"),
                                     lm.param_dict(), {})
        del lm
        write_s = time.time() - t0
        if model_io.latest_complete_checkpoint(prefix) != 2:
            fail("deploy: the manifest does not name generation 2")
        arrivals = traffic.poisson_trace(rate, DEPLOY_ARRIVALS / rate,
                                         seed=1)
        prompts, budgets = decode_traffic(14, len(arrivals),
                                          *DEPLOY_TRAFFIC)
        kw = whole_set_pool(len(arrivals) + 4)
        t0 = time.time()
        refs = {}
        for epoch in (1, 2):
            _, args, _ = model_io.load_checkpoint(prefix, epoch, ctx=dev)
            ref = DecodeEngine(TinyCausalLM(params=args, device=dev,
                                            **DEC_MODEL),
                               name="deploy_ref%d" % epoch, device=dev,
                               warmup=False, **DEC_ENGINE)
            try:
                refs[epoch] = references(ref, prompts, budgets)
            finally:
                ref.stop()
        del args, ref
        ref_s = time.time() - t0

        t0 = time.time()
        _, args, _ = model_io.load_checkpoint(prefix, 1, ctx=dev)
        boot_lm = TinyCausalLM(params=args, device=dev, **DEC_MODEL)
        router = serving.FleetRouter(replicas=2)
        try:
            router.load_decode("lm", named_engines(
                lambda name: DecodeEngine(boot_lm, name=name, device=dev,
                                          **kw)), replicas=2)
            placed = router.stats()["decode_models"]["lm"]["placement"]
            boot = [router.engine("lm", rid) for rid in placed]
            ctl = deploy_io.DeploymentController(
                router, prefix, engines={"lm": build}, ctx=dev)
            first = ctl.deploy(1)
            if first["status"] != "deployed":
                fail("deploy: booting generation 1 gave %s" % first)
            boot_s = time.time() - t0
            old = [router.engine("lm", rid) for rid in placed]
            warm = {e.name: warm_state(e, dev) for e in boot + old}
            swap = {}
            trigger = threading.Event()

            def swapper():
                if not trigger.wait(600):
                    return
                swap["t0"] = time.time()
                try:
                    swap["report"] = ctl.poll()
                except Exception as exc:
                    swap["error"] = "%s: %s" % (type(exc).__name__, exc)
                swap["t1"] = time.time()

            thread = threading.Thread(target=swapper, daemon=True)
            thread.start()
            streams, submitted, fired, wall = open_loop(
                router.submit_stream, arrivals,
                ["default"] * len(arrivals), prompts, budgets,
                on_submit=lambda i: i + 1 == DEPLOY_AT and trigger.set())
            thread.join(600)
            if "error" in swap or thread.is_alive():
                fail("deploy: the swap failed: %s" % swap.get(
                    "error", "still running"))
            report = swap["report"]
            if report is None or report["status"] != "deployed" \
                    or report["generation"] != 2:
                fail("deploy: the swap reported %s" % report)
            probes = [router.submit_stream("lm", prompts[i],
                                           max_new_tokens=budgets[i],
                                           timeout_ms=600000,
                                           **sampling_of(i))
                      for i in range(4)]
            for s in probes:
                if not s.wait(900):
                    fail("deploy: a probe never ended")
            deadline = time.time() + 10
            while not conserved(router.decode_stats.snapshot()) \
                    and time.time() < deadline:
                time.sleep(0.005)
            ledger = router.decode_stats.snapshot()
            new = [router.engine("lm", rid) for rid in placed]
            warm.update({e.name: warm_state(e, dev) for e in new})
            gens = [e.generation for e in new]
            engines_whole("deploy", boot + old + new, warm)
            deploy_state = router.stats()["deploy"]
        finally:
            router.stop()
    bad = [(i, s.status, s.error) for i, s in enumerate(streams + probes)
           if s.status != "OK"]
    if bad or fired != len(arrivals):
        fail("deploy: %d fired of %d; streams not OK: %s"
             % (fired, len(arrivals), bad[:5]))
    if not conserved(ledger):
        fail("deploy: the ledger is not conserved: %s" % ledger)
    if gens != [2, 2] or deploy_state["generation"] != 2 \
            or deploy_state["retiring"]:
        fail("deploy: the fleet ended on %s (%s)" % (gens, deploy_state))
    seen, torn = {1: 0, 2: 0}, []
    for i, s in enumerate(streams):
        toks = s.tokens()
        hits = [g for g in (1, 2) if toks == refs[g][i]]
        if len(hits) != 1:
            torn.append(i)
        else:
            seen[hits[0]] += 1
    if any(s.tokens() != refs[2][i] for i, s in enumerate(probes)):
        fail("deploy: a probe after the swap differs from generation 2")
    if torn or not seen[1] or seen[2] + len(probes) == 0:
        fail("deploy: streams %s match no single generation; seen %s"
             % (torn[:5], seen))
    t_sw0, t_sw1 = swap["t0"], swap["t1"]
    inside = [s.ttft_ms for s, t in zip(streams, submitted)
              if t_sw0 <= t <= t_sw1]
    outside = [s.ttft_ms for s, t in zip(streams, submitted)
               if not t_sw0 <= t <= t_sw1]
    if cuda_ops.flash_attention.launches:
        fail("deploy launched flash_attention")
    phase("deploy", arrivals=len(arrivals), rate_hz=rate, probes=len(probes),
          generation_1_streams=seen[1], generation_2_streams=seen[2],
          torn=0, conserved=True, write_s=write_s, boot_s=boot_s,
          reference_s=ref_s, swap_s=t_sw1 - t_sw0,
          controller_swap_ms=report["swap_ms"],
          warmup_captures=json.dumps({e.name: e.warmup_report["captures"]
                                      for e in new}),
          handoffs=report["handoffs"], fenced=report["fenced"],
          in_swap_streams=len(inside),
          ttft_p50_in_swap_ms=(float(np.percentile(inside, 50))
                               if inside else None),
          ttft_p99_in_swap_ms=(float(np.percentile(inside, 99))
                               if inside else None),
          ttft_p50_outside_ms=float(np.percentile(outside, 50)),
          ttft_p99_outside_ms=float(np.percentile(outside, 99)),
          captures_after_warmup=0, leaked_blocks=0,
          wall_s=wall, card='"%s"' % card)


def serving_tier_phases(cuda_ops, dev, card):
    """The serving tier's four phases; returns the kernel's launches
    (``fleet_serve``'s: the others serve the decode model, which
    launches none)."""
    launches = fleet_serve(cuda_ops, dev, card)
    rate = fleet_decode(cuda_ops, dev, card) / 2
    disagg(cuda_ops, dev, card, rate)
    deploy(cuda_ops, dev, card, rate)
    return launches


# ---------------------------------------------------------------------------
# random draws, the word-language-model Transformer with dropout, and the
# vision zoo

RNG_N = 1 << 24   # rng_bits: 16M draws
# card vs CPU normal draws, relative: log1p on the two devices (and XLA's
# against torch's, tests/test_torch_random.py) differ by a few ulp
NORMAL_RTOL = 2.0 ** -21
# word_lm_vs_cpu: (depth, B, T) of the copy held against the CPU
WLM_VS_CPU = (2, 2, 256)
# the word LM's Adam lr at the bench widths.  The example's 3e-3 (set for
# dim 64) sends the first batch's loss from 10.43 to 14.45 in 5 steps at
# dim 768, 12 layers (a CPU probe at B = 2, T = 128, five batches); 3e-4
# takes it to 9.92 there.  Five distinct batches of B = 8, T = 1024 do not
# teach the mapping (32768 token pairs): an H100 read the first batch's
# loss 10.42 before and 11.36 (lr 3e-3), 10.52 (3e-4) after, the step
# losses flat at ln 32768.  So the phase trains on one batch, five times
WLM_LR = 3e-4
# word_lm_vs_cpu's step-1 gradients, card vs CPU, worst leaf ||a - b|| /
# ||b||.  An H100 read 1.26e-3 (blocks.1.ln2.beta, median leaf 7.4e-4): the
# kernel's split-TF32 rounding (outputs 1e-6 from the plain version's) tips
# one of the 1,572,864 ReLU units of block 1's ff1 across 0, and one
# unit's share of a 2 x 256 batch's gradient is ~1/sqrt(2 * 256 * 3072).
# The plain attention on the card reads 1.5e-6, and so does the kernel
# without dropout (no unit tipped); the TF32 control reads 2.27e-2 (median
# 1.91e-2).  So train_vs_cpu's 1e-3 sits below one tipped unit here
WLM_GRAD_REL_BOUND = 5e-3
ZOO_SCORE = ("alexnet", "vgg16", "inceptionv3", "resnet50_v1")
ZOO_SCORE_B, ZOO_SCORE_ITERS = 32, 20
# the families of tests/test_gluon.py's zoo test, at its image sides
ZOO_FAMILIES = ("alexnet", "densenet121", "inceptionv3", "mobilenet0.5",
                "mobilenetv2_0.5", "resnet18_v1", "resnet18_v2",
                "squeezenet1.0", "vgg11", "vgg11_bn")
ZOO_VS_CPU_B = 2
# the JAX package's hybridize bound (tests/test_gluon.py)
ZOO_RTOL, ZOO_ATOL = 1e-4, 1e-5
# VGG-16 through the example at batch 32; lr 0.01 (the example's 0.1 takes
# plain VGG-16 from Xavier weights to NaN)
VGG_B, VGG_LR, VGG_STEPS = 32, 0.01, 4


def zoo_side(name):
    """The image side a family runs at (tests/test_gluon.py's zoo test):
    Inception v3 is fixed at 299, AlexNet's and SqueezeNet's stems need
    224."""
    return 299 if "inception" in name else \
        224 if ("alexnet" in name or "squeezenet" in name) else 64


def rng_bits(dev, card):
    """Phase: the draws on the card equal the CPU's and numpy's at 16M
    elements: ``random_bits`` (from a host key and from a device-tensor
    key), ``uniform``, ``bernoulli``, ``randint`` and the shuffle bit for
    bit; ``normal`` within NORMAL_RTOL.  Times a 32-bit draw and a
    Bernoulli mask (CUDA events) beside the time to write the result at
    the card's memory rate."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.ops import random_ops

    key = trandom.prng_key(123)
    shape = (RNG_N,)

    def both(fn):
        card_out = fn(dev).cpu()
        return card_out, fn("cpu")

    got, want = both(lambda d: trandom.random_bits(key, shape, d))
    tensor_key = trandom.random_bits(trandom.key_tensor(key, dev), shape)
    b0, b1 = trandom.threefry2x32(key, np.zeros(RNG_N, np.uint32),
                                  np.arange(RNG_N, dtype=np.uint32))
    np_bits = b0 ^ b1
    if not (torch.equal(got, want) and torch.equal(tensor_key.cpu(), want)
            and np.array_equal(got.numpy().view(np.uint32), np_bits)):
        fail("rng_bits: random_bits on the card differ from the CPU's or "
             "numpy's")
    draws = {
        "uniform": lambda d: random_ops.uniform(key, shape, device=d),
        "bernoulli": lambda d: random_ops.bernoulli(key, 0.9, shape, d),
        "randint": lambda d: random_ops.randint(key, shape, -5, 1000,
                                                device=d),
        "shuffle": lambda d: random_ops.permutation(
            key, torch.arange(RNG_N, dtype=torch.int32, device=d)),
    }
    for name, fn in draws.items():
        got, want = both(fn)
        if not torch.equal(got, want):
            fail("rng_bits: %s on the card differs from the CPU's in %d "
                 "of %d" % (name, int((got != want).sum()), RNG_N))
        if name == "uniform":
            np_uniform = ((np_bits >> 9) | np.uint32(0x3F800000)).view(
                np.float32) - np.float32(1)
            if not np.array_equal(got.numpy(), np_uniform):
                fail("rng_bits: uniform differs from numpy's")
    got, want = both(lambda d: random_ops.normal(key, shape, device=d))
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if rel > NORMAL_RTOL:
        fail("rng_bits: normal on the card is %.3g from the CPU's, relative "
             "(bound %.3g)" % (rel, NORMAL_RTOL))
    dev_key = trandom.key_tensor(key, dev)
    bits_ms = time_ms(lambda: trandom.random_bits(key, shape, dev), reps=5)
    tensor_key_ms = time_ms(lambda: trandom.random_bits(dev_key, shape),
                            reps=5)
    mask_ms = time_ms(lambda: random_ops.bernoulli(key, 0.9, shape, dev),
                      reps=5)
    bw = card_peaks(torch.cuda.get_device_name(0))[3]
    phase("rng_bits", n=RNG_N, bitwise=json.dumps(
        ["random_bits", "tensor_key", "numpy", *draws]),
        normal_max_rel=rel, normal_bound=NORMAL_RTOL,
        random_bits_ms=bits_ms, tensor_key_ms=tensor_key_ms,
        bernoulli_mask_ms=mask_ms, write_bound_ms=4 * RNG_N / bw * 1e3,
        card='"%s"' % card)


def word_lm_config(layers=None):
    """The word-language-model Transformer at the bench LM's widths
    (bench.py:355-377): vocab, dim, heads, hidden 4 x dim, depth, T."""
    return dict(vocab=VOCAB, dim=DIM, heads=HEADS, hidden=4 * DIM,
                layers=DEPTH if layers is None else layers, max_len=MAX_LEN)


def new_word_lm(dev, layers, seed):
    """``models/word_language_model.py``'s TransformerLM on ``dev`` with the
    example's weights for ``mx.random.seed(seed)``: Xavier, the deferred
    layers drawn at a first call on one token (in prediction, where each
    Dropout only takes its key)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.word_language_model import TransformerLM

    mx.random.seed(seed)
    net = TransformerLM(device=dev, **word_lm_config(layers))
    net.initialize(mx.init.Xavier())
    with torch.no_grad():
        net(torch.zeros((1, 1), dtype=torch.int32, device=dev))
    return net


def word_lm_batches(steps, B, T, dev):
    """The example's synthetic rows (the target is the token plus one),
    ``steps`` batches of ``B`` on ``dev``."""
    from mxnet_tpu_torch.models.word_language_model import synthetic_data

    data, target = synthetic_data(VOCAB, T, n=steps * B)
    return [(torch.from_numpy(data[i * B:(i + 1) * B].astype(np.int32)
                              ).to(dev),
             torch.from_numpy(target[i * B:(i + 1) * B].astype(np.float32)
                              ).to(dev)) for i in range(steps)]


def word_lm_step(net, ce, x, y):
    """The example's recorded step: the per-sample loss, backward with a
    head of ones; returns its mean."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        loss = ce(net(x), y)
    loss.backward(torch.ones_like(loss))
    return loss.mean()


def drop_masks(net):
    """Forward hooks recording, on the device, which elements each
    Dropout call zeroed; returns (masks list, hook handles)."""
    from mxnet_tpu_torch.gluon import nn as gnn

    masks, handles = [], []
    for m in net.modules():
        if isinstance(m, gnn.Dropout):
            handles.append(m.register_forward_hook(
                lambda mod, args, out: masks.append(out == 0)))
    return masks, handles


def eval_loss(net, ce, batch):
    """The mean loss of ``batch`` in prediction (no dropout)."""
    with torch.no_grad():
        return ce(net(batch[0]), batch[1]).mean().item()


def word_lm_run(cuda_ops, dev, hybrid):
    """The full-width word LM from seed 0 trained TRAIN_STEPS Adam steps
    (the example's loop, lr WLM_LR) on the example's first batch of
    TRAIN_B x MAX_LEN, hybridized or not; returns
    (net, trainer, ce, batches, losses, step ms, wrapper launches, the
    first Dropout's first mask of each step, the first batch's loss in
    prediction before and after)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    net = new_word_lm(dev, DEPTH, 0)
    ce = SoftmaxCrossEntropyLoss()
    batches = word_lm_batches(1, TRAIN_B, MAX_LEN, dev) * TRAIN_STEPS
    held = [eval_loss(net, ce, batches[0])]
    if hybrid:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": WLM_LR})
    masks, handles = ([], []) if hybrid else drop_masks(net.blocks[0])
    losses, step_ms, firsts = [], [], []
    torch.cuda.synchronize()
    reset_launches(cuda_ops)
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = word_lm_step(net, ce, x, y)
        trainer.step(TRAIN_B)
        end.record()
        torch.cuda.synchronize()
        if masks:
            firsts.append(masks[0])
            masks.clear()
        losses.append(loss.item())
        step_ms.append(start.elapsed_time(end))
    for h in handles:
        h.remove()
    launches = cuda_ops.flash_attention.launches
    if not hybrid:   # the hybridized run's comes after its checks
        held.append(eval_loss(net, ce, batches[0]))
    return (net, trainer, ce, batches, losses, step_ms, launches, firsts,
            held)


def dropout_ranges(net):
    """Hooks that put each Dropout's forward in a profiler range named
    ``Dropout``; returns the handles."""
    from torch.profiler import record_function

    from mxnet_tpu_torch.gluon import nn as gnn

    open_ranges = {}

    def enter(module, args):
        open_ranges[id(module)] = record_function("Dropout")
        open_ranges[id(module)].__enter__()

    def leave(module, args, out):
        open_ranges.pop(id(module)).__exit__(None, None, None)

    handles = []
    for m in net.modules():
        if isinstance(m, gnn.Dropout):
            handles += [m.register_forward_pre_hook(enter),
                        m.register_forward_hook(leave)]
    return handles


def under_range(event, name):
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False


def word_lm_profile(net, trainer, ce, batch, card):
    """Phase: one eager full-width step under torch.profiler: its device
    time, the part its Dropouts' forwards take (the threefry draws in
    torch integer ops, the masks and the scaling) and their kernel
    launches, and the kernel's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x, y = batch
    handles = dropout_ranges(net)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            word_lm_step(net, ce, x, y)
            with record_function("trainer.step"):
                trainer.step(TRAIN_B)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    device_ms = drop_ms = flash_ms = 0.0
    drop_kernels = 0
    for event in prof.events():
        for k in event.kernels:
            device_ms += k.duration / 1e3
            if "flash_attention_fwd" in k.name:
                flash_ms += k.duration / 1e3
            if under_range(event, "Dropout"):
                drop_ms += k.duration / 1e3
                drop_kernels += 1
    if not device_ms:
        fail("word_lm_profile: the profiler saw no device time")
    phase("word_lm_profile", batch=(TRAIN_B, MAX_LEN), device_ms=device_ms,
          dropout_ms=drop_ms, dropout_share=drop_ms / max(device_ms, 1e-9),
          dropout_kernel_launches=drop_kernels,
          dropout_calls=2 * DEPTH, flash_fwd_ms=flash_ms,
          card='"%s"' % card)


def word_lm_train(cuda_ops, dev, card):
    """Phase: the word-language-model Transformer at the bench LM's widths
    (12 layers, dim 768, hidden 3072, vocab 32768) trains TRAIN_STEPS Adam
    steps on one batch of TRAIN_B x MAX_LEN in fp32 with Dropout 0.1: the
    kernel launches once a layer a step, the loss is finite and falls (the
    batch's, in prediction, before and after), and each step's masks
    differ from the last's.  Then the step profiled
    (``word_lm_profile``), and the same training hybridized
    (``word_lm_hybrid``): one capture, replays with fresh masks (the same
    batch twice gives two losses), the kernel 12 times a replay under
    torch.profiler.  Returns the kernel's launches of both runs."""
    (net, trainer, ce, batches, losses, step_ms, launches, masks,
     held) = word_lm_run(cuda_ops, dev, hybrid=False)
    if launches != DEPTH * TRAIN_STEPS:
        fail("word_lm_train: flash_attention launched %d times, not %d "
             "layers x %d steps" % (launches, DEPTH, TRAIN_STEPS))
    if not all(np.isfinite(losses + held)) or not held[1] < held[0]:
        fail("word_lm_train: losses %s, first batch's %s before and after: "
             "not finite and falling" % (losses, held))
    same = [i for i in range(1, len(masks))
            if torch.equal(masks[i], masks[i - 1])]
    if len(masks) != TRAIN_STEPS or same:
        fail("word_lm_train: step masks repeat (%s of %d)"
             % (same, len(masks)))
    kept = float(1 - torch.stack(masks).float().mean())
    median_ms = median_of(step_ms)
    phase("word_lm_train", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          layers=DEPTH, hidden=4 * DIM, dropout=0.1,
          losses=json.dumps(losses), first_batch_loss=json.dumps(held),
          launches=launches, masks_fresh_each_step=True, kept_fraction=kept,
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          tokens_per_s=TRAIN_B * MAX_LEN / (median_ms / 1e3),
          card='"%s"' % card)
    word_lm_profile(net, trainer, ce, batches[-1], card)
    del net, trainer, masks

    (net, trainer, ce, batches, hlosses, hstep_ms, eager_launches, _,
     hheld) = word_lm_run(cuda_ops, dev, hybrid=True)
    caps = net._cached_op.capture_stats()
    cache = net._cached_op.cache_stats()
    if caps["captures"] != 1 or cache["hits"] != TRAIN_STEPS - 1:
        fail("word_lm_hybrid: not one capture for %d steps: %s %s"
             % (TRAIN_STEPS, caps, cache))
    if eager_launches != DEPTH * caps["eager_runs"]:
        fail("word_lm_hybrid: %d wrapper launches, not %d layers x %d "
             "warm-up runs" % (eager_launches, DEPTH, caps["eager_runs"]))
    x, y = batches[0]
    twice = [word_lm_step(net, ce, x, y).item() for _ in range(2)]
    if twice[0] == twice[1]:
        fail("word_lm_hybrid: two replays of one batch drew the same masks")
    seen, device_ms, _ = replayed_launches(
        lambda: word_lm_step(net, ce, x, y))
    if seen != DEPTH:
        fail("word_lm_hybrid: the profiler saw the kernel %d times in one "
             "replayed step, not %d" % (seen, DEPTH))
    if cuda_ops.flash_attention.launches != eager_launches:
        fail("word_lm_hybrid: a graph replay called the kernel's wrapper")
    caps = net._cached_op.capture_stats()
    hybrid_launches = eager_launches + caps["replays"] * seen
    # after the counts: a call in prediction captures a signature of its own
    hheld.append(eval_loss(net, ce, batches[0]))
    if not all(np.isfinite(hlosses + hheld)) or not hheld[1] < hheld[0]:
        fail("word_lm_hybrid: losses %s, first batch's %s before and "
             "after: not finite and falling" % (hlosses, hheld))
    phase("word_lm_hybrid", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          losses=json.dumps(hlosses), first_batch_loss=json.dumps(hheld),
          captures=caps["captures"],
          replays=caps["replays"], eager_warmup_runs=caps["eager_runs"],
          same_batch_losses=json.dumps(twice), fresh_masks=True,
          launches=hybrid_launches, profiler_kernel_launches=seen,
          step_ms=json.dumps(hstep_ms), median_step_ms=median_of(hstep_ms),
          eager_median_step_ms=median_ms,
          step_device_ms=device_ms if device_ms else "not measured",
          card='"%s"' % card)
    return launches + hybrid_launches


def word_lm_vs_cpu(dev):
    """Phase: a depth-2 copy of the word LM from seed 0 on the card and on
    the CPU, one training step on one batch, eagerly and hybridized: the
    weights are equal, the eager step's Dropout masks (every call's) are
    bit-equal, and the loss and every gradient hold at the ``train_vs_cpu``
    bounds (SERVE_ATOL/RTOL, GRAD_REL_BOUND); a hybridized step's masks are
    drawn inside the graph on the card, and its loss and gradients, which
    other masks would move by far more than the bounds, are held the same
    way."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    depth, B, T = WLM_VS_CPU
    cpu = torch.device("cpu")
    for hybrid in (False, True):
        runs = []
        for d in (dev, cpu) + (() if hybrid else (dev,)):
            # the third run, eager only, is the TF32 control on the card
            tf32 = len(runs) == 2
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            net = new_word_lm(d, depth, 0)
            if hybrid:
                net.hybridize()
            (x, y), = word_lm_batches(1, B, T, d)
            masks, handles = ([], []) if hybrid else drop_masks(net)
            loss = word_lm_step(net, SoftmaxCrossEntropyLoss(), x, y)
            for h in handles:
                h.remove()
            runs.append((loss.item(), {
                n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                [m.cpu() for m in masks], {
                    n: t.detach().cpu() for n, t in net.state_dict().items()}))
            del net
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        (loss, grads, masks, state), (closs, cgrads, cmasks, cstate) = \
            runs[:2]
        label = "word_lm_vs_cpu" + ("_hybrid" if hybrid else "")
        control = {}
        if not hybrid:
            rel = leaf_rel_errs(runs[2][1], cgrads)
            worst = max(rel, key=rel.get)
            control = dict(tf32_control_max_rel_err=rel[worst],
                           tf32_control_leaf=worst,
                           tf32_control_median_rel_err=float(
                               np.median(list(rel.values()))))
        if state_diff(state, cstate):
            fail("%s: the card's weights are not the CPU's" % label)
        if len(masks) != len(cmasks) or any(
                not torch.equal(a, b) for a, b in zip(masks, cmasks)):
            fail("%s: Dropout masks differ from the CPU's" % label)
        if not abs(loss - closs) <= SERVE_ATOL + SERVE_RTOL * abs(closs):
            fail("%s: loss %.7g on the card, %.7g on the CPU"
                 % (label, loss, closs))
        rel = leaf_rel_errs(grads, cgrads)
        worst = max(rel, key=rel.get)
        if rel[worst] > WLM_GRAD_REL_BOUND:
            fail("%s: gradient of %s is %.3g from the CPU's (bound %.3g)"
                 % (label, worst, rel[worst], WLM_GRAD_REL_BOUND))
        phase(label, depth=depth, batch=(B, T), loss=loss, cpu_loss=closs,
              masks_bitwise=len(masks) if not hybrid else "in the graph",
              worst_grad_rel=rel[worst], worst_leaf=worst,
              median_grad_rel=float(np.median(list(rel.values()))),
              rel_bound=WLM_GRAD_REL_BOUND, **control)


def vgg16_fit(dev, card):
    """Phase: VGG-16 through the example's entry point
    (``image_classification.main --network vgg16``, one epoch of the
    synthetic set at 224 x 224, batch 32, fp32, SGD), from seed 0; then
    VGG_STEPS more steps timed by CUDA events (step ms, images/s) and one
    profiled by layer kind (``vgg16_profile``, the ``resnet_profile``
    categories, Dropout's forward its own)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import image_classification as ic

    mx.random.seed(0)
    t0 = time.time()
    net = ic.main(["--network", "vgg16", "--batch-size", str(VGG_B),
                   "--num-epochs", "1", "--lr", str(VGG_LR)])
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    if not all(torch.isfinite(t).all() for t in net.state_dict().values()):
        fail("vgg16_fit left non-finite weights")
    args = resnet_args(VGG_B)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": VGG_LR, "momentum": args.mom,
                             "wd": args.wd})
    ce = SoftmaxCrossEntropyLoss()
    batches = synthetic_batches(args, (3, 224, 224), dev, VGG_STEPS)
    step_ms, losses = [], []
    for x, y in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with autograd.record():
            loss = ce(net(x), y)
        loss.backward(torch.ones_like(loss))
        trainer.step(VGG_B)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.mean().item())
        step_ms.append(start.elapsed_time(end))
    if not all(np.isfinite(losses)):
        fail("vgg16_fit: losses %s not finite" % losses)
    median_ms = median_of(step_ms)
    phase("vgg16_fit", network="vgg16", batch=VGG_B, dtype="float32",
          lr=VGG_LR, fit_s=fit_s, losses=json.dumps(losses),
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          img_per_s=VGG_B / (median_ms / 1e3), card='"%s"' % card)
    resnet_profile(net, trainer, ce, batches[-1], card,
                   label="vgg16_profile")


def zoo_score(dev, card):
    """Phase: ``benchmark_score`` for AlexNet, VGG-16, Inception v3 (at
    299) and ResNet-50 v1 at batch 32, fp32: the inference forward through
    ``functional_call`` under one CachedOp, captured at the first call and
    replayed ZOO_SCORE_ITERS times (images/s); no capture after the first
    call, and the graph's logits equal an eager forward's bit for bit
    (cuDNN deterministic)."""
    from mxnet_tpu_torch.gluon.block import functional_call
    from mxnet_tpu_torch.models import benchmark_score as bs

    for name in ZOO_SCORE:
        side = 299 if "inception" in name else 224
        with deterministic_cudnn():
            net, op, params, x = bs.build(name, ZOO_SCORE_B, (3, side, side),
                                          "float32", dev)
            with torch.no_grad():
                graphed = op(params, x).clone()
            first = op.capture_stats()["captures"]
            misses = op.cache_stats()["misses"]
            speed = bs.timed(op, params, x, ZOO_SCORE_ITERS)
            after = op.capture_stats()["captures"] - first
            if after or op.cache_stats()["misses"] != misses:
                fail("zoo_score %s: %d captures after the first call"
                     % (name, after))
            with torch.no_grad():
                eager = functional_call(net, params, x)[0][0]
        if graphed.shape != (ZOO_SCORE_B, 1000) or \
                not torch.isfinite(graphed).all():
            fail("zoo_score %s: logits %s not finite of shape (%d, 1000)"
                 % (name, tuple(graphed.shape), ZOO_SCORE_B))
        if not torch.equal(graphed, eager):
            fail("zoo_score %s: the graph's logits differ from the eager "
                 "forward's by %.3g" % (name, float(
                     (graphed - eager).abs().max())))
        phase("zoo_score", network=name, batch=ZOO_SCORE_B, side=side,
              dtype="float32", img_per_s=speed, captures_first_call=first,
              captures_after=after, replays=op.capture_stats()["replays"],
              graph_vs_eager_bitwise=True, card='"%s"' % card)
        del net, op, params, x, graphed, eager
        torch.cuda.empty_cache()


def zoo_vs_cpu(dev):
    """Phase: every family of tests/test_gluon.py's zoo test at batch 2 and
    its image side, built from seed 0 (Xavier) on the card and on the
    CPU: the weights equal bit for bit, and the inference logits hold at
    the JAX package's hybridize bound (ZOO_RTOL, ZOO_ATOL) with TF32 off
    and cuDNN deterministic."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    worst = {}
    for name in ZOO_FAMILIES:
        side = zoo_side(name)
        x = np.random.RandomState(1).uniform(
            -1, 1, (ZOO_VS_CPU_B, 3, side, side)).astype(np.float32)
        runs = []
        for d in (dev, torch.device("cpu")):
            mx.random.seed(0)
            net = vision.get_model(name, device=d)
            net.initialize(mx.init.Xavier())
            with torch.no_grad(), deterministic_cudnn():
                net(torch.from_numpy(x).to(d))
                logits = net(torch.from_numpy(x).to(d))
            runs.append((logits.cpu(), {n: t.detach().cpu() for n, t in
                                        net.state_dict().items()}))
            del net
        (got, state), (want, cstate) = runs
        differ = state_diff(state, cstate)
        if differ:
            fail("zoo_vs_cpu %s: %d arrays differ from the CPU's, first %s"
                 % (name, len(differ), differ[0]))
        gap = (got - want).abs()
        if not torch.allclose(got, want, rtol=ZOO_RTOL, atol=ZOO_ATOL):
            fail("zoo_vs_cpu %s: logits %.3g from the CPU's (bound rtol "
                 "%g, atol %g)" % (name, float(gap.max()), ZOO_RTOL,
                                   ZOO_ATOL))
        worst[name] = float(gap.max())
    phase("zoo_vs_cpu", families=len(worst), batch=ZOO_VS_CPU_B,
          weights_bitwise=True, max_abs_logit_gap=json.dumps(worst),
          rtol=ZOO_RTOL, atol=ZOO_ATOL)


def random_zoo_phases(cuda_ops, dev, card):
    """The random draws, the word LM with dropout and the vision zoo;
    returns the kernel's launches (the word LM's: the zoo runs none)."""
    rng_bits(dev, card)
    launches = word_lm_train(cuda_ops, dev, card)
    word_lm_vs_cpu(dev)
    reset_launches(cuda_ops)
    vgg16_fit(dev, card)
    zoo_score(dev, card)
    zoo_vs_cpu(dev)
    if cuda_ops.flash_attention.launches:
        fail("the zoo launched flash_attention %d times"
             % cuda_ops.flash_attention.launches)
    return launches


# ---------------------------------------------------------------------------
# the optimizers, optimizer-state files and crash resume

OPT_SHAPE = (VOCAB, DIM)      # the LM embedding's weight
OPT_UPDATES = 3
# learning rate, weight decay, clipping and rescale for every optimizer
OPT_COMMON = {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 0.5,
              "rescale_grad": 1.0 / TRAIN_B}
# name -> (optimizer, its own arguments): the twelve, SGD and Adam, and
# RMSProp's centered form
OPT_CASES = {
    "sgd": ("sgd", {"momentum": 0.9}),
    "nag": ("nag", {"momentum": 0.9}),
    "signum": ("signum", {"wd_lh": 0.01}),
    "ftml": ("ftml", {}),
    "lbsgd": ("lbsgd", {"momentum": 0.9}),
    "dcasgd": ("dcasgd", {"momentum": 0.9}),
    "sgld": ("sgld", {}),
    "adam": ("adam", {}),
    "adagrad": ("adagrad", {}),
    "rmsprop": ("rmsprop", {}),
    "rmsprop_centered": ("rmsprop", {"centered": True}),
    "adadelta": ("adadelta", {}),
    "ftrl": ("ftrl", {}),
    "adamax": ("adamax", {}),
    "nadam": ("nadam", {}),
}
# card against CPU after OPT_UPDATES updates: the JAX package's bound for
# its update ops (tests/test_registry_ops_r5.py:51); a sign taken of a
# momentum within SIGN_TIE of 0 may go either way
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
SIGN_TIE = 1e-6
# lm_optim_resume: the four optimizers, each TRAIN_STEPS steps, saved and
# resumed after RESUME_AT
LM_OPTIMIZERS = {
    "rmsprop_centered": ("rmsprop", {"learning_rate": 1e-4,
                                     "centered": True}),
    "nag": ("nag", {"learning_rate": 0.01, "momentum": 0.9}),
    "ftml": ("ftml", {"learning_rate": 1e-3}),
    "adamax": ("adamax", {"learning_rate": 2e-3, "wd": 1e-4}),
}
# lm_optim_resume shifts every array of the seeded LM by a seeded uniform
# draw this wide: Adamax divides by max(beta2 * u, |g + wd * w|) with no
# epsilon (in MXNet as here), which is 0 where a weight and its gradient
# are (a zero-initialized key bias, whose gradient softmax cancels)
LM_SHIFT = 1e-3
RESUME_AT = 2
RESUME_EPOCHS = 2
# module_resume's kills: (fault site, calls that pass before the crash,
# the epoch the resume finds committed); a checkpoint replaces its symbol,
# params, states and manifest files in that order
RESUME_KILLS = (("checkpoint.replace", 1, None), ("checkpoint.write", 3, None),
                ("checkpoint.replace", 5, 1))
NAG_FIT_B = 32


def optimizer_run(name, weight, grads, dev):
    """OPT_UPDATES updates of ``OPT_CASES[name]`` on copies of ``weight``
    and ``grads`` on ``dev``: (the weight and state leaves, ms an update
    by CUDA events on the card)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.module.compiled_step import _state_leaves

    kind, own = OPT_CASES[name]
    mx.random.seed(7)
    opt = mx.optimizer.create(kind, **dict(OPT_COMMON, **own))
    w = weight.to(dev).clone()
    gs = [g.to(dev) for g in grads]
    state = opt.create_state_multi_precision(0, w)
    ms = []
    for g in gs:
        if dev.type == "cuda":
            ms.append(cuda_timed(
                lambda g=g: opt.update_multi_precision(0, w, g, state)))
        else:
            opt.update_multi_precision(0, w, g, state)
    return [w] + _state_leaves(state), (float(np.median(ms)) if ms
                                        else None)


def optimizers_vs_cpu(dev, card):
    """Phase: each optimizer OPT_UPDATES times on an LM-embedding-sized
    fp32 weight with weight decay, clipping and a gradient rescale, on the
    card and on the CPU from the same arrays and seed (SGLD's noise drawn
    on each from the same key): weight and every state leaf within
    OPT_RTOL/OPT_ATOL.  Prints each update's card ms."""
    rng = np.random.RandomState(0)
    weight = torch.from_numpy(
        rng.normal(0, 0.05, OPT_SHAPE).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(0, 1, OPT_SHAPE).astype(np.float32))
             for _ in range(OPT_UPDATES)]
    report = {}
    for name in OPT_CASES:
        want, _ = optimizer_run(name, weight, grads, torch.device("cpu"))
        got, ms = optimizer_run(name, weight, grads, dev)
        worst, outside = 0.0, 0
        for i, (a, b) in enumerate(zip(got, want)):
            a = a.cpu()
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail("optimizers_vs_cpu %s: leaf %d %s, not finite %s"
                     % (name, i, tuple(a.shape), tuple(b.shape)))
            err = (a - b).abs()
            worst = max(worst, float(err.max()))
            bad = err > OPT_ATOL + OPT_RTOL * b.abs()
            if name == "signum" and i == 0:
                # the weight moves by the sign of the momentum (leaf 1)
                bad &= want[1].abs() > SIGN_TIE
            outside += int(bad.sum())
        if outside:
            fail("optimizers_vs_cpu %s: %d values beyond rtol %g atol %g "
                 "(max abs %.3g)" % (name, outside, OPT_RTOL, OPT_ATOL,
                                     worst))
        report[name] = {"max_abs": worst, "update_ms": ms}
        del got, want
    torch.cuda.empty_cache()
    phase("optimizers_vs_cpu", shape=OPT_SHAPE, updates=OPT_UPDATES,
          optimizers=len(report), rtol=OPT_RTOL, atol=OPT_ATOL,
          results=json.dumps(report), card='"%s"' % card)


def lm_state(net):
    return {n: t.detach().clone() for n, t in net.state_dict().items()}


def load_lm_state(net, state):
    with torch.no_grad():
        for n, t in net.state_dict().items():
            t.copy_(state[n])


def optimizer_state_bytes(trainer):
    from mxnet_tpu_torch.module.compiled_step import _state_leaves

    return sum(t.numel() * t.element_size()
               for s in trainer._updater.states.values()
               for t in _state_leaves(s))


def lm_optim_run(cuda_ops, net, init, fresh, name, batches, pos, tmp):
    """One optimizer of ``lm_optim_resume``: TRAIN_STEPS steps from
    ``init`` with saves after RESUME_AT, then ``fresh`` (zeroed) loads
    both files and takes the remaining steps.  Returns (step ms, losses,
    states' bytes, save s, load s, arrays not bit-equal, kernel launches,
    final state)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    kind, params = LM_OPTIMIZERS[name]
    ce = SoftmaxCrossEntropyLoss()
    load_lm_state(net, init)
    trainer = gluon.Trainer(net.collect_params(), kind, dict(params))
    step_ms, losses = [], []
    launches0 = cuda_ops.flash_attention.launches
    for k, (x, y) in enumerate(batches):
        out = []
        step_ms.append(cuda_timed(lambda: out.append(
            (forward_backward(net, ce, x, y, pos), trainer.step(1)))))
        losses.append(out[0][0].item())
        if k + 1 == RESUME_AT:
            t0 = time.time()
            net.save_parameters(tmp + "/lm.params")
            trainer.save_states(tmp + "/lm.states")
            save_s = time.time() - t0
    state_bytes = optimizer_state_bytes(trainer)
    want = lm_state(net)
    del trainer
    with torch.no_grad():
        for t in fresh.state_dict().values():
            t.zero_()
    t0 = time.time()
    fresh.load_parameters(tmp + "/lm.params")
    trainer = gluon.Trainer(fresh.collect_params(), kind, dict(params))
    trainer.load_states(tmp + "/lm.states")
    load_s = time.time() - t0
    for x, y in batches[RESUME_AT:]:
        forward_backward(fresh, ce, x, y, pos)
        trainer.step(1)
    torch.cuda.synchronize()
    launches = cuda_ops.flash_attention.launches - launches0
    got = lm_state(fresh)
    differ = state_diff(want, got)
    return (step_ms, losses, state_bytes, save_s, load_s, differ, launches,
            want)


def lm_optim_resume(cuda_ops, dev, card):
    """Phase: the full-width LM (seed 0's weights shifted by LM_SHIFT)
    trained TRAIN_STEPS steps through
    ``gluon.Trainer`` with each of LM_OPTIMIZERS, attention in the CUDA
    kernel (once a layer a step); after step RESUME_AT the run saves its
    parameters and optimizer states, and a zeroed LM with a new Trainer
    loads both and trains on to the end: its weights must equal the
    uninterrupted run's bit for bit.  Where they do not, the optimizer runs
    again under ``torch.use_deterministic_algorithms`` (this phase only),
    and the ops torch names as lacking a deterministic kernel are printed.
    Returns the kernel launches."""
    import tempfile
    import warnings

    net = new_lm(dev, DEPTH, 0)
    fresh = new_lm(dev, DEPTH, 1)
    rng = np.random.RandomState(0)
    init = {n: t + torch.from_numpy(rng.uniform(
        -LM_SHIFT, LM_SHIFT, tuple(t.shape)).astype(np.float32)).to(dev)
        for n, t in lm_state(net).items()}
    batches = lm_batches(np.random.RandomState(0), TRAIN_STEPS, TRAIN_B,
                         MAX_LEN, dev)
    pos = torch.arange(MAX_LEN, device=dev,
                       dtype=torch.int32).expand(TRAIN_B, MAX_LEN)
    reset_launches(cuda_ops)
    total, report = 0, {}
    for name in LM_OPTIMIZERS:
        with tempfile.TemporaryDirectory() as tmp:
            run = lm_optim_run(cuda_ops, net, init, fresh, name, batches,
                               pos, tmp)
            needed = None
            if run[5]:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.use_deterministic_algorithms(True, warn_only=True)
                    try:
                        run = lm_optim_run(cuda_ops, net, init, fresh, name,
                                           batches, pos, tmp)
                    finally:
                        torch.use_deterministic_algorithms(False)
                needed = sorted({str(w.message).split(" ")[0]
                                 for w in caught
                                 if "deterministic" in str(w.message)})
        step_ms, losses, state_bytes, save_s, load_s, differ, launches, \
            final = run
        total += launches
        steps = TRAIN_STEPS + TRAIN_STEPS - RESUME_AT
        if launches != DEPTH * steps:
            fail("lm_optim_resume %s: flash_attention launched %d times, "
                 "not %d layers x %d steps" % (name, launches, DEPTH, steps))
        if differ:
            fail("lm_optim_resume %s: the resumed run differs from the "
                 "uninterrupted one in %d arrays (%s), deterministic mode "
                 "%s" % (name, len(differ), differ[:3], needed))
        if not all(np.isfinite(losses)) or not all(
                torch.isfinite(t).all() for t in final.values()):
            fail("lm_optim_resume %s: not finite: %s" % (name, losses))
        if any(torch.equal(init[n], final[n]) for n in init):
            fail("lm_optim_resume %s left arrays untrained" % name)
        report[name] = {"median_step_ms": median_of(step_ms),
                        "losses": losses, "state_bytes": state_bytes,
                        "save_s": save_s, "load_s": load_s,
                        "launches": launches, "deterministic_mode": needed}
        del final
    del net, fresh, init
    torch.cuda.empty_cache()
    phase("lm_optim_resume", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          resume_after=RESUME_AT, launches_optim=total,
          launches_per_step=DEPTH, bitwise=True, results=json.dumps(report),
          card='"%s"' % card)
    return total


def lenet_resume_fit(dev, prefix, resume=False, crash_plan=None):
    """``models/train_mnist.py``'s LeNet through ``Module.fit`` on the
    compiled path, RMSProp, RESUME_EPOCHS epochs of the synthetic set in
    order, checkpointed with optimizer states every epoch; under
    ``crash_plan`` when given, else with ``auto_resume``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.models import train_mnist

    mx.random.seed(0)
    it = train_mnist.get_mnist_iters(MNIST_B, prefix + "-data", ctx=dev,
                                     shuffle=False)[0]
    mod = mx.mod.Module(train_mnist.get_lenet(), context=dev)
    kw = dict(num_epoch=RESUME_EPOCHS, optimizer="rmsprop",
              optimizer_params={"learning_rate": 1e-3, "centered": True},
              initializer=mx.init.Xavier(), compiled=True,
              epoch_end_callback=[mx.callback.module_checkpoint(
                  mod, prefix, save_optimizer_states=True)])
    if crash_plan is not None:
        with faults.plan(crash_plan):
            mod.fit(it, **kw)
    else:
        mod.fit(it, auto_resume=resume, **kw)
    if mod._compiled_step is None:
        fail("module_resume: the compiled step did not run")
    args, _ = mod.get_params()
    return {k: v._data.clone() for k, v in args.items()}


def module_resume(dev, card):
    """Phase (cuDNN deterministic, as ``module_fit``): LeNet trained by
    ``Module.fit`` on the compiled path with RMSProp and
    ``module_checkpoint(save_optimizer_states=True)``; killed at each of
    RESUME_KILLS (the first two are tests/test_compiled_fit.py's, which
    tear the first checkpoint; the third tears the second, after the first
    committed), each then ``fit(auto_resume=True)``: it resumes from the
    epoch the manifest committed, and the parameters equal the
    uninterrupted run's bit for bit."""
    import tempfile

    from mxnet_tpu_torch import faults

    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        t0 = time.time()
        ref = lenet_resume_fit(dev, tmp + "/ref")
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        kills = []
        for n, (site, after, epoch) in enumerate(RESUME_KILLS):
            prefix = "%s/kill%d" % (tmp, n)
            plan = faults.FaultPlan(n).add(site, kind="crash", after=after,
                                           times=1)
            try:
                lenet_resume_fit(dev, prefix, crash_plan=plan)
                fail("module_resume: no crash at %s" % site)
            except faults.SimulatedCrash:
                pass
            from mxnet_tpu_torch.model import latest_complete_checkpoint
            found = latest_complete_checkpoint(prefix)
            t0 = time.time()
            resumed = lenet_resume_fit(dev, prefix, resume=True)
            torch.cuda.synchronize()
            differ = state_diff(ref, resumed)
            if differ or found != epoch:
                fail("module_resume: after a kill at %s#%d the run resumed "
                     "from epoch %s (not %s), parameters apart: %s"
                     % (site, after, found, epoch, differ))
            kills.append({"site": site, "after": after,
                          "resumed_from_epoch": found,
                          "resume_fit_s": time.time() - t0})
    phase("module_resume", network="lenet", batch=MNIST_B,
          epochs=RESUME_EPOCHS, optimizer="rmsprop_centered",
          cudnn_deterministic=True, bitwise_params=len(ref), fit_s=fit_s,
          kills=json.dumps(kills), card='"%s"' % card)


def resnet_nag_fit(dev, card):
    """Phase: resnet50_v1 at 224 x 224, batch NAG_FIT_B, fp32, through
    ``image_classification.main --optimizer nag`` (one epoch of the
    synthetic set): every step timed by CUDA events, img/s from the
    median step after the first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import image_classification as ic

    train_step = ic.train_step
    step_ms, optimizers = [], set()

    def timed_step(net, trainer, *args):
        optimizers.add(type(trainer._optimizer).__name__)
        out = []
        step_ms.append(cuda_timed(lambda: out.append(
            train_step(net, trainer, *args))))
        return out[0]

    mx.random.seed(0)
    ic.train_step = timed_step
    try:
        net = ic.main(["--network", "resnet50_v1", "--batch-size",
                       str(NAG_FIT_B), "--num-epochs", "1", "--optimizer",
                       "nag"])
    finally:
        ic.train_step = train_step
    if optimizers != {"NAG"}:
        fail("resnet_nag_fit trained with %s" % optimizers)
    if not all(torch.isfinite(t).all() for t in net.state_dict().values()):
        fail("resnet_nag_fit left non-finite weights")
    median_ms = median_of(step_ms)
    del net
    torch.cuda.empty_cache()
    phase("resnet_nag_fit", network="resnet50_v1", batch=NAG_FIT_B,
          image=(3, 224, 224), dtype="float32", steps=len(step_ms),
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          img_per_s=NAG_FIT_B / (median_ms / 1e3), card='"%s"' % card)


# (layer, its arguments, input shape): DCGAN-style upsampling layers
CONV_T_CASES = (
    ("Conv1DTranspose", (64, 4), {"strides": 2, "padding": 1},
     (8, 128, 256)),
    ("Conv2DTranspose", (64, 4), {"strides": 2, "padding": 1},
     (8, 128, 32, 32)),
    ("Conv2DTranspose", (64, 3), {"strides": 2, "padding": 1,
                                  "output_padding": 1, "groups": 2},
     (8, 128, 16, 16)),
    ("Conv3DTranspose", (32, 4), {"strides": 2, "padding": 1},
     (2, 64, 8, 16, 16)),
)


def conv_transpose_vs_cpu(dev, card):
    """Phase: the transposed convolutions (the ``Deconvolution`` op,
    cuDNN on the card) forward and backward on the card against the CPU
    from the same weights, inputs and head gradient, at ``nd_ops``' bounds
    for a convolution: the output within SERVE_RTOL/SERVE_ATOL, each
    gradient's gap within GRAD_REL_BOUND of its norm."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    rng = np.random.RandomState(0)
    report = {}
    for i, (layer, args, kw, shape) in enumerate(CONV_T_CASES):
        x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
        head = None
        results = []
        for d in (torch.device("cpu"), dev):
            mx.random.seed(i)
            block = getattr(nn, layer)(*args, in_channels=shape[1],
                                       device=d, **kw)
            block.initialize(mx.init.Xavier())
            xd = x.detach().to(d).requires_grad_()
            y = block(xd)
            if head is None:
                head = torch.from_numpy(rng.normal(
                    0, 1, tuple(y.shape)).astype(np.float32))
            y.backward(head.to(d))
            results.append([y.detach().cpu(), xd.grad.cpu()]
                           + [p.grad.cpu() for p in block.parameters()])
        (want_y, *want_g), (got_y, *got_g) = results
        label = "%s%s" % (layer, shape)
        y_err = float((got_y - want_y).abs().max())
        g_rel = max(float((g - w).norm() / w.norm())
                    for g, w in zip(got_g, want_g))
        report[label] = {"output_max_abs": y_err, "grad_max_rel": g_rel}
        if not torch.allclose(got_y, want_y, rtol=SERVE_RTOL,
                              atol=SERVE_ATOL) or g_rel > GRAD_REL_BOUND:
            fail("conv_transpose_vs_cpu %s: card and CPU apart: %s"
                 % (label, report[label]))
    phase("conv_transpose_vs_cpu", cases=len(report), rtol=SERVE_RTOL,
          atol=SERVE_ATOL, grad_rel_bound=GRAD_REL_BOUND,
          results=json.dumps(report), card='"%s"' % card)


def optim_resume_phases(cuda_ops, dev, card):
    """The optimizers, their state files and crash resume; the transposed
    convolutions.  Returns the kernel's launches (the LM's)."""
    seconds = {}

    def timed(fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[fn.__name__] = time.time() - t0
        return out

    timed(optimizers_vs_cpu, dev, card)
    launches = timed(lm_optim_resume, cuda_ops, dev, card)
    reset_launches(cuda_ops)
    timed(module_resume, dev, card)
    timed(resnet_nag_fit, dev, card)
    timed(conv_transpose_vs_cpu, dev, card)
    phase("optim_resume_seconds", **seconds)
    if cuda_ops.flash_attention.launches:
        fail("the LeNet, ResNet and transposed-conv phases launched "
             "flash_attention %d times" % cuda_ops.flash_attention.launches)
    return launches


# ---------------------------------------------------------------------------
# int8 inference (ops/quantization_ops.py, contrib/quantization.py)
# ---------------------------------------------------------------------------

INT8_B, INT8_SIDE = 32, 224   # bench.py _measure_int8: B = 32, 224 x 224
INT8_AGREE, INT8_GAP = 0.9, 0.35   # tests/test_quantize_graph.py:179-183
# bench.py's batch through the random-weight 1000-class ResNet-50 has fp32
# top-1 margins (median 0.0014) below the int8 path's logit error (about
# 0.003): there the JAX package's int8 arithmetic, run by the port on the
# CPU of an H100 80GB HBM3's host, agrees with fp32 on 27 of 32 images,
# under INT8_AGREE.  The card's agreement is held to that reference's on the same
# batch, one image of slack for the ulp-level threshold differences
INT8_AGREE_SLACK = 1
# dense int8 tensor-core peaks (NVIDIA data sheets), op/s
INT8_PEAKS = {"H100 PCIe": 1513e12, "H100 NVL": 1671e12, "H100": 1979e12}
INT8_REPS = 5


def is_int8_gemm(kernel):
    """An int8 GEMM by its kernel's name: cuBLASLt's sm90 xmma i8 GEMMs,
    CUTLASS's s8 tensor-op GEMMs, the imma ones."""
    k = kernel.lower()
    return "gemm" in k and any(t in k for t in ("i8i32", "_s8", "s8_",
                                                 "imma", "i16832", "i8816"))
INT8_VS_CPU = (16, 32, 10)   # tests/test_quantize_graph.py's resnet18_v1


def int8_peak(name):
    for key, peak in INT8_PEAKS.items():
        if key in name:
            return peak
    fail("no published int8 peak for card %r" % name)


def int8_gemm_ops(qsym, shapes):
    """2 M K N summed over the graph's quantized FC and convolution nodes
    (M the output positions, K the reduction, N the outputs), from the
    shapes shape inference gives each node."""
    from mxnet_tpu_torch.symbol import Group

    nodes = [n for n in qsym._topo_nodes()
             if n.op in ("_contrib_quantized_conv",
                         "_contrib_quantized_fully_connected")]
    probe = Group([type(qsym)([(n, 0)]) for n in nodes])
    in_shapes, outs, _ = probe.infer_shape(**shapes)
    arg_shapes = dict(zip(probe.list_arguments(), in_shapes))
    total = 0
    for n, out in zip(nodes, outs):
        w = arg_shapes[n.inputs[1][0].name]   # (N, K...) filters or rows
        m = int(np.prod(out)) // w[0]          # output positions
        total += 2 * m * int(np.prod(w[1:])) * w[0]
    return total, len(nodes)


def int8_profile(qsym, exe, x):
    """Device ms of one eager forward of the quantized graph by kind: each
    node's op under a ``record_function`` range, the im2cols and the int8
    conversions under ranges of their own, and the int8 GEMMs and the
    min/max reductions by kernel name."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch.executor import graph_function
    from mxnet_tpu_torch.ops import quantization_ops as qo

    fn = graph_function(qsym, exe.arg_names, exe.aux_names, False, x.device)
    args = [exe.arg_dict[n]._data for n in exe.arg_names]
    aux = [exe.aux_dict[n]._data for n in exe.aux_names]
    args[exe.arg_names.index("data")] = x
    ops = {}
    for n in qsym._topo_nodes():
        if n.op is not None and n.op not in ops:
            from mxnet_tpu_torch.ops.registry import get_op
            ops[n.op] = get_op(n.op)
    saved = {name: (op, op.fcompute) for name, op in ops.items()}
    patched = {k: getattr(qo, k) for k in ("im2col", "cast")}

    def ranged(label, f):
        def call(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return call

    try:
        for name, (op, f) in saved.items():
            op.fcompute = ranged("op:" + name, f)
        for k, f in patched.items():
            setattr(qo, k, ranged("fn:" + k, f))
        with torch.no_grad():
            fn(args, aux)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(args, aux)
                torch.cuda.synchronize()
    finally:
        for name, (op, f) in saved.items():
            op.fcompute = f
        for k, f in patched.items():
            setattr(qo, k, f)
    by_range, reduce_ms, gemm_ms, total = {}, 0.0, 0.0, 0.0
    cpu = torch.autograd.DeviceType.CPU
    # a range's kernels, from the host-side events (a range's device-side
    # twin spans its first to its last kernel, gaps included)
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith(("op:", "fn:")):
            by_range[e.name] = by_range.get(e.name, 0.0) \
                + e.device_time_total / 1e3
    for e in prof.key_averages():
        if e.key.startswith(("op:", "fn:", "ProfilerStep")):
            continue
        if e.device_type != cpu:
            ms = e.self_device_time_total / 1e3
            total += ms
            if "reduce_kernel" in e.key:
                reduce_ms += ms
            if is_int8_gemm(e.key):
                gemm_ms += ms
    return total, by_range, reduce_ms, gemm_ms


def int8_resnet50(cuda_ops, dev, card, workdir):
    """Phase: bench.py's int8 path at full width.  resnet50_v1 (1000
    classes, Xavier from mx.random.seed(0)) exported, read back by
    ``model.load_checkpoint``, rewritten by ``quantize_model`` with minmax
    calibration on one seeded batch of 32 x 3 x 224 x 224, bound by
    ``simple_bind(grad_req='null')`` and run forward on the card; the same
    exported fp32 graph through ``simple_bind`` beside it.  Holds the int8
    logits to the JAX package's int8 bounds against the fp32 forward
    (top-1 agreement >= 0.9, largest gap below 0.35 of the largest fp32
    logit; the top-1 agreement no lower than the JAX package's int8
    arithmetic reaches on the same batch, run by the port on the host's
    CPU: see INT8_AGREE_SLACK) and prints images/s over CUDA-event
    windows, calibration seconds, peak memory, the device time by kind,
    the int8 GEMMs' launches and their bound at the card's dense int8
    peak."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.ops import quantization_ops as qo

    net = new_resnet(dev, 0)
    prefix = str(workdir / "r50")
    net.export(prefix)
    del net
    torch.cuda.empty_cache()
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0,
                                                           ctx=dev)
    rng = np.random.RandomState(0)
    shape = (INT8_B, 3, INT8_SIDE, INT8_SIDE)
    x_np = rng.uniform(-1, 1, shape).astype(np.float32)
    calib_np = rng.uniform(-1, 1, shape).astype(np.float32)
    calib = mx.io.NDArrayIter(calib_np, np.zeros(INT8_B, np.float32), INT8_B,
                              ctx=dev)
    qo.int8_gemm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with dev:
        qsym, qargs, qaux = q.quantize_model(sym, arg_params, aux_params,
                                             calib_data=calib,
                                             calib_mode="minmax")
    torch.cuda.synchronize()
    calib_s = time.time() - t0
    calib_gemms = qo.int8_gemm.launches
    exe = qsym.simple_bind(dev, data=shape, grad_req="null")
    exe.copy_params_from(qargs, qaux)
    x = mx.nd.array(x_np, ctx=dev)
    qo.int8_gemm.launches = 0
    got = exe.forward(is_train=False, data=x)[0].asnumpy()
    eager_gemms = qo.int8_gemm.launches
    int8_ms = time_ms(lambda: exe.forward(is_train=False, data=x),
                      reps=INT8_REPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ops, n_nodes = int8_gemm_ops(qsym, {"data": shape})
    # CUPTI can drop a kernel at the edge of a trace (replayed_launches):
    # a count short of the nodes is traced again, three traces in all
    for _ in range(3):
        replay_ms, kernels = device_profile(
            lambda: exe.forward(is_train=False, data=x))
        gemms_a_forward = sum(n for k, n in kernels.items()
                              if is_int8_gemm(k))
        if gemms_a_forward == n_nodes:
            break
    if gemms_a_forward != n_nodes:
        fail("int8_resnet50: %d int8 GEMM kernels in a replayed forward "
             "for %d quantized nodes (GEMM-like kernels: %s)"
             % (gemms_a_forward, n_nodes, {k[:90]: n for k, n in
                                           kernels.items()
                                           if "gemm" in k.lower()}))
    total_ms, by_range, reduce_ms, gemm_ms = int8_profile(qsym, exe, x._data)
    # the wrapper counts the eager runs (the capture's warm-ups and the
    # profile's); a replay launches the graph's GEMMs without calling it
    replays = exe._cops[False].capture_stats()["replays"]
    launches = qo.int8_gemm.launches + replays * gemms_a_forward
    fp_exe = sym.simple_bind(dev, data=shape, grad_req="null")
    fp_exe.copy_params_from(arg_params, aux_params)
    want = fp_exe.forward(is_train=False, data=x)[0].asnumpy()
    fp32_ms = time_ms(lambda: fp_exe.forward(is_train=False, data=x),
                      reps=INT8_REPS)
    if cuda_ops.flash_attention.launches:
        fail("int8_resnet50 launched flash_attention")
    if not (np.isfinite(got).all() and got.shape == (INT8_B, 1000)):
        fail("int8_resnet50: logits not finite or of shape %s" % (
            got.shape,))
    t0 = time.time()
    ref_fp32, ref_int8, ref_th, _ = int8_run(
        "cpu", prefix, x_np, calib_np, codes=False)
    ref_s = time.time() - t0
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    ref_agree = float((ref_int8.argmax(1) == ref_fp32.argmax(1)).mean())
    gap = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))
    srt = np.sort(want, 1)
    margins = srt[:, -1] - srt[:, -2]
    row_err = np.abs(got - want).max(1)
    if gap >= INT8_GAP:
        fail("int8_resnet50: logit gap %.3f of the largest fp32 logit "
             "(bound %.2f)" % (gap, INT8_GAP))
    if agree < min(INT8_AGREE, ref_agree - INT8_AGREE_SLACK / INT8_B):
        fail("int8_resnet50: top-1 agreement %.4f, below %.2f and below "
             "the reference arithmetic's %.4f on the same batch"
             % (agree, INT8_AGREE, ref_agree))
    if not eager_gemms:
        fail("int8_resnet50: the int8 GEMM wrapper launched nothing")
    bound_ms = ops / int8_peak(card) * 1e3
    del exe, fp_exe
    torch.cuda.empty_cache()
    phase("int8_resnet50", network="resnet50_v1", batch=shape,
          calib="minmax", calib_s=round(calib_s, 3),
          quantized_nodes=n_nodes, int8_ms=int8_ms,
          int8_images_per_s=INT8_B / (int8_ms / 1e3),
          fp32_ms=fp32_ms, fp32_images_per_s=INT8_B / (fp32_ms / 1e3),
          top1_agreement=agree, logit_gap=gap,
          cpu_reference_top1_agreement=ref_agree,
          cpu_reference_logit_gap=float(np.abs(ref_int8 - ref_fp32).max()
                                        / (np.abs(ref_fp32).max() + 1e-6)),
          card_vs_cpu_int8_max_abs=float(np.abs(got - ref_int8).max()),
          threshold_max_rel_gap=max(
              abs(th - ref_th[k][i]) / max(abs(ref_th[k][i]), 1e-30)
              for k, pair in calibrated_ranges(qsym).items()
              for i, th in enumerate(pair)),
          fp32_median_top1_margin=float(np.median(margins)),
          rows_margin_below_int8_err=int((margins < row_err).sum()),
          cpu_reference_s=round(ref_s, 2),
          peak_memory_gb=round(peak_gb, 3),
          int8_gemm_launches=launches, int8_gemm_launches_eager=eager_gemms,
          replays=replays, calib_int8_gemms=calib_gemms,
          int8_gemms_a_forward=gemms_a_forward,
          int8_gemm_ops=ops, int8_bound_ms=bound_ms,
          replay_device_ms=replay_ms,
          eager_device_ms=total_ms, eager_int8_gemm_ms=gemm_ms,
          eager_minmax_reduce_ms=reduce_ms,
          eager_ms_by_range=json.dumps(
              {k: round(v, 4) for k, v in sorted(
                  by_range.items(), key=lambda kv: -kv[1])}),
          flash_attention_launches=0, card='"%s"' % card)


def calibrated_ranges(qsym):
    """{quantize_v2 node: (min_calib_range, max_calib_range)}."""
    return {n.name: (n.attrs["min_calib_range"], n.attrs["max_calib_range"])
            for n in qsym._topo_nodes() if n.op == "_contrib_quantize_v2"}


def quantized_ops_vs_cpu(dev):
    """Phase: each of the eight quantized ops on ResNet-50 stage shapes,
    the card against the port's CPU path on the same inputs: bit-equal."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(8)

    def i8(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)

    def rr(*v):
        return [np.array([a], np.float32) for a in v]

    act = rng.normal(0, 1.5, (8, 64, 56, 56)).astype(np.float32)
    x56, img = i8(8, 64, 56, 56), i8(4, 3, 224, 224)
    rd, rw, rb = rr(-2.5, 3.0), rr(-0.7, 0.4), rr(-0.05, 0.06)
    calls = [
        ("_contrib_quantize", [act] + rd, {"out_type": "int8"}),
        ("_contrib_quantize", [act] + rd, {"out_type": "uint8"}),
        ("_contrib_quantize_v2", [act], {}),
        ("_contrib_quantize_v2", [act], {"min_calib_range": -2.0,
                                         "max_calib_range": 2.5}),
        ("_contrib_dequantize", [x56] + rd, {}),
        ("_contrib_dequantize", [x56.astype(np.uint8)] + rd, {}),
        ("_contrib_requantize", [rng.randint(-2 ** 30, 2 ** 30, (32, 2048))
                                 .astype(np.int32)] + rd, {}),
        ("_contrib_quantized_conv", [img, i8(64, 3, 7, 7)] + rd + rw,
         {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
          "num_filter": 64, "no_bias": True}),
        ("_contrib_quantized_conv", [x56, i8(64, 64, 3, 3)] + rd + rw,
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64,
          "no_bias": True}),
        ("_contrib_quantized_conv", [x56, i8(256, 64, 1, 1), i8(256)]
         + rd + rw + rb, {"kernel": (1, 1), "num_filter": 256}),
        ("_contrib_quantized_conv", [x56, i8(128, 64, 1, 1)] + rd + rw,
         {"kernel": (1, 1), "stride": (2, 2), "num_filter": 128,
          "no_bias": True}),
        ("_contrib_quantized_fully_connected",
         [i8(32, 2048, 1, 1), i8(1000, 2048), i8(1000)] + rd + rw + rb,
         {"num_hidden": 1000}),
        ("_contrib_quantized_fully_connected",
         [i8(32, 2048), i8(1000, 2048)] + rd + rw, {"num_hidden": 1000,
                                                    "no_bias": True}),
        ("_contrib_quantized_flatten", [x56] + rd, {}),
        ("_contrib_quantized_pooling", [x56] + rd,
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
        ("_contrib_quantized_pooling", [x56] + rd,
         {"global_pool": True, "kernel": (1, 1), "pool_type": "avg"}),
    ]
    t0 = time.time()
    names = set()
    for name, inputs, attrs in calls:
        outs = {}
        for where in ("cpu", dev):
            out = getattr(mx.nd, name)(*[mx.nd.array(a, ctx=where,
                                                     dtype=a.dtype)
                                         for a in inputs], **attrs)
            outs[str(where)] = [o.asnumpy() for o in (
                out if isinstance(out, list) else [out])]
        for k, (g, w) in enumerate(zip(outs[str(dev)], outs["cpu"])):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                fail("quantized_ops_vs_cpu %s %s output %d: card and CPU "
                     "differ (max abs %.3g)" % (name, attrs, k, float(
                         np.abs(g.astype(np.float64) - w).max())))
        names.add(name)
    if len(names) != 8:
        fail("quantized_ops_vs_cpu covers %d of the 8 ops" % len(names))
    phase("quantized_ops_vs_cpu", ops=len(names), calls=len(calls),
          bitwise=True, shapes="resnet50 stage1 (8,64,56,56), conv0 "
          "(4,3,224,224), head (32,2048)->1000",
          seconds=round(time.time() - t0, 2))


def int8_run(where, prefix, x, calib, codes=True):
    """quantize_model (minmax) of the checkpoint at ``prefix`` on
    ``where`` and its int8 logits on ``x``, with the fp32 logits, the
    thresholds by node and (``codes``) the codes at each quantize_v2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.symbol import Group

    with torch.device(where):
        sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=where)
        fp = sym.simple_bind(where, data=x.shape, grad_req="null")
        fp.copy_params_from(args, aux)
        data = mx.nd.array(x, ctx=where)
        fp32 = fp.forward(is_train=False, data=data)[0].asnumpy()
        it = mx.io.NDArrayIter(calib, np.zeros(len(calib), np.float32),
                               len(calib), ctx=where)
        qsym, qargs, qaux = q.quantize_model(sym, args, aux, calib_data=it,
                                             calib_mode="minmax")
        exe = qsym.simple_bind(where, data=x.shape, grad_req="null")
        exe.copy_params_from(qargs, qaux)
        int8 = exe.forward(is_train=False, data=data)[0].asnumpy()
        thresholds = calibrated_ranges(qsym)
        if not codes:
            return fp32, int8, thresholds, None
        nodes = [n for n in qsym._topo_nodes()
                 if n.op == "_contrib_quantize_v2"]
        probe = Group([type(qsym)([(n, 0)]) for n in nodes])
        pexe = probe.simple_bind(where, data=x.shape, grad_req="null")
        pexe.copy_params_from(qargs, qaux, allow_extra_params=True)
        codes = [o.asnumpy() for o in pexe.forward(is_train=False,
                                                   data=data)]
    return fp32, int8, thresholds, codes


def int8_vs_cpu(dev):
    """Phase: resnet18_v1 at the JAX test's size (10 classes, 16 x 3 x 32
    x 32), seeded, exported, quantized (minmax) and run on the card and on
    the CPU.  The thresholds come from fp32 calibration forwards that
    differ by ulps between the devices: their largest relative gap is
    measured and printed, with the share of equal codes at each
    quantize_v2.  Holds both int8 forwards to the JAX test's bounds
    against the CPU's fp32 forward, and the card's int8 logits closer to
    the CPU's than the CPU's are to fp32."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    B, side, classes = INT8_VS_CPU
    t0 = time.time()
    mx.random.seed(0)
    net = vision.get_model("resnet18_v1", classes=classes, device="cpu")
    net.initialize(mx.init.Xavier())
    with torch.no_grad():
        net(torch.zeros(1, 3, side, side))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, side, side)).astype(np.float32)
    calib = rng.uniform(-1, 1, (B, 3, side, side)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "r18")
        net.export(prefix)
        fp_c, int8_c, th_c, codes_c = int8_run("cpu", prefix, x, calib)
        fp_g, int8_g, th_g, codes_g = int8_run(dev, prefix, x, calib)
    th_gap = max(abs(th_g[k][i] - th_c[k][i]) / max(abs(th_c[k][i]), 1e-30)
                 for k in th_c for i in (0, 1))
    shares = [float((a == b).mean()) for a, b in zip(codes_g, codes_c)]
    scale = np.abs(fp_c).max() + 1e-6
    for label, out in (("card", int8_g), ("cpu", int8_c)):
        agree = float((out.argmax(1) == fp_c.argmax(1)).mean())
        gap = float(np.abs(out - fp_c).max() / scale)
        if agree < INT8_AGREE or gap >= INT8_GAP:
            fail("int8_vs_cpu: the %s's int8 forward beyond the JAX test's "
                 "bounds: agreement %.3f, gap %.3f" % (label, agree, gap))
    card_cpu = float(np.abs(int8_g - int8_c).max())
    cpu_fp = float(np.abs(int8_c - fp_c).max())
    if not card_cpu < cpu_fp:
        fail("int8_vs_cpu: card vs CPU int8 logits %.3g, not below the "
             "CPU's int8 vs fp32 gap %.3g" % (card_cpu, cpu_fp))
    phase("int8_vs_cpu", network="resnet18_v1", batch=(B, 3, side, side),
          classes=classes, fp32_max_abs=float(np.abs(fp_g - fp_c).max()),
          threshold_max_rel_gap=th_gap,
          min_equal_code_share=min(shares),
          mean_equal_code_share=float(np.mean(shares)),
          int8_card_vs_cpu_max_abs=card_cpu,
          int8_cpu_vs_fp32_max_abs=cpu_fp,
          seconds=round(time.time() - t0, 2))


def quantize_infer_phase(cuda_ops, dev):
    """Phase: ``models/quantize_infer.py`` on the card at the example's
    bounds (tests/test_examples_gluon.py:110-112)."""
    from mxnet_tpu_torch.models import quantize_infer
    from mxnet_tpu_torch.ops import quantization_ops as qo

    t0 = time.time()
    qo.int8_gemm.launches = 0
    fp_acc, q_acc, agree = quantize_infer.main(["--device", str(dev)])
    if not (fp_acc > 0.9 and q_acc > fp_acc - 0.1 and agree > 0.9):
        fail("quantize_infer: fp32 %.3f int8 %.3f agreement %.3f beyond "
             "the example's bounds" % (fp_acc, q_acc, agree))
    if not qo.int8_gemm.launches:
        fail("quantize_infer launched no int8 GEMM on the card")
    phase("quantize_infer", fp32_accuracy=fp_acc, int8_accuracy=q_acc,
          top1_agreement=agree, int8_gemm_launches_eager=qo.int8_gemm.
          launches, seconds=round(time.time() - t0, 2))


def int8_phases(cuda_ops, dev, card):
    """int8 inference: bench.py's int8 ResNet-50, the quantized ops and a
    small quantized model against the CPU, and the example.  Returns the
    kernel's launches there (0: the path has no attention)."""
    import tempfile

    seconds = {}

    def timed(fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[fn.__name__] = round(time.time() - t0, 2)
        return out

    reset_launches(cuda_ops)
    with tempfile.TemporaryDirectory() as tmp:
        timed(int8_resnet50, cuda_ops, dev, card, Path(tmp))
    timed(quantized_ops_vs_cpu, dev)
    timed(int8_vs_cpu, dev)
    timed(quantize_infer_phase, cuda_ops, dev)
    phase("int8_seconds", **seconds)
    if cuda_ops.flash_attention.launches:
        fail("the int8 phases launched flash_attention %d times"
             % cuda_ops.flash_attention.launches)
    return cuda_ops.flash_attention.launches


# ---------------------------------------------------------------------------
# the input pipeline (PR 16): RecordIO, the native decode pipeline, the
# Python image iterator, DeviceFeed on a CUDA side stream, MNISTIter


FEED_IMAGES, FEED_SIDE = 320, 256   # the packed .rec: 10 batches of 32
FEED_SHAPE = (3, RESNET_SIZE, RESNET_SIZE)
FEED_CLASSES = 1000
FEED_EPOCHS = 5       # epochs of each way, in turn
FEED_WORKERS = 4      # DataLoader processes beside the step (8 host cores)
NATIVE_MEAN_BOUND = 3.0    # tests/test_recordio.py::test_native_image_pipeline
ALLOC_BATCHES, ALLOC_ELEMS = 200, 1 << 20
ALLOC_SLEEP_CYCLES = 2_000_000    # ~1 ms: the consumer's stream lags
CAPTURE_FED, CAPTURE_WAIT_S = 4, 30.0
MNIST_IDX_N = 60000
MNIST_IDX_RTOL, MNIST_IDX_ATOL = 1e-5, 1e-7   # tests/test_torch_module.py


def input_probe():
    """Phase: what the machine has for images: PIL (JPEG payloads; without
    it ``recordio.pack_img`` writes the JAX package's ``.npy`` payloads),
    and whether ``g++`` finds ``jpeglib.h`` (the native decode pipeline).
    Returns (pil, native)."""
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True)
    jpeg = probe.returncode == 0
    from mxnet_tpu_torch import _native
    t0 = time.time()
    lib = _native.get_lib()
    build_s = round(time.time() - t0, 2)
    native = (lib is not None and hasattr(lib, "mxtpu_pipe_open")
              and pil is not None)
    phase("input_probe", pil=pil, libjpeg=jpeg,
          native_library=_native.library_path() if lib else None,
          native_build_s=build_s,
          payload="jpeg" if pil else "npy (no PIL: the JAX package's "
          "no-PIL format)")
    if not jpeg:
        print("native_pipeline: unavailable (no libjpeg)", flush=True)
    elif not pil:
        print("native_pipeline: unavailable (no PIL: no JPEG payloads to "
              "decode)", flush=True)
    return pil, native


def feed_images(seed=0):
    """FEED_IMAGES seeded FEED_SIDE x FEED_SIDE RGB images: a random
    pattern an eighth of the side, scaled up 8 times, plus pixel noise
    (smooth, as photographs are, so that JPEG sizes and decode times are
    those of real images), and their labels."""
    rng = np.random.RandomState(seed)
    for i in range(FEED_IMAGES):
        coarse = rng.randint(0, 256, (FEED_SIDE // 8, FEED_SIDE // 8, 3))
        img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)
        img = np.clip(img + rng.randint(-12, 13, img.shape), 0, 255)
        yield img.astype(np.uint8), float(rng.randint(0, FEED_CLASSES))


def pack_feed_rec(path):
    """The .rec (and .idx) of ``feed_images`` through the port's
    ``recordio.pack_img``; returns the labels in file order and the
    file's bytes."""
    from mxnet_tpu_torch import recordio

    labels = []
    w = recordio.MXIndexedRecordIO(str(path)[:-4] + ".idx", str(path), "w")
    for i, (img, label) in enumerate(feed_images()):
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0),
                                         img, quality=90))
        labels.append(label)
    w.close()
    return np.array(labels, np.float32), path.stat().st_size


def device_busy(fn):
    """(device busy ms, window ms) of ``fn()`` under torch.profiler: the
    union of the device's kernel, copy and set intervals, and the
    window's host-clock time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type != cpu
                   and not e.key.startswith("ProfilerStep"))
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3, window_ms


def feed_sample(img, label):
    """``train_imagenet.py``'s augmentation of one decoded image, in a
    DataLoader worker: a random crop to FEED_SHAPE and a mirror half the
    time, from Python's ``random`` (``ImageRecordIterator``'s
    ``RandomCropAug`` and ``HorizontalFlipAug``), as a float32 CHW row."""
    from mxnet_tpu_torch import image

    x = image.random_crop(img, FEED_SHAPE[:0:-1])[0].asnumpy()
    if random.random() < 0.5:
        x = x[:, ::-1]
    return (np.ascontiguousarray(x.transpose(2, 0, 1), dtype=np.float32),
            np.float32(label))


def feed_resnet50(dev, card, workdir, native):
    """Phase ``feed_resnet50``: ResNet-50 v1 trained at 224 x 224, B = 32,
    fp32 (TF32 off) from a packed .rec in four ways over one seeded net:
    ``compute`` (one pre-staged batch), ``sync`` (the Python
    ``ImageRecordIterator`` of ``train_imagenet.py``: shuffle, random crop
    and mirror, read inline and copied in the step), ``e2e`` (the same
    iterator behind ``PrefetchingIter(ctx=card)``, as
    ``image_classification --data-train`` reads it) and ``workers`` (a
    ``DataLoader`` of FEED_WORKERS processes); FEED_EPOCHS epochs of each,
    in turn, and one more e2e epoch under torch.profiler for the device's
    busy time; then
    ``image_classification.main --data-train`` itself for one epoch; then
    ``Module.fit(prefetch_to_device=card)`` for one epoch over
    ``NativeImageRecordIter(layout="NHWC")`` of uint8 on the compiled
    step, when the native pipeline built."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, sym
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.image import ImageRecordIterator
    from mxnet_tpu_torch.metric import Accuracy
    from mxnet_tpu_torch.models import image_classification as ic

    t0 = time.time()
    rec = workdir / "feed.rec"
    labels, rec_bytes = pack_feed_rec(rec)
    pack_s = time.time() - t0
    steps = FEED_IMAGES // RESNET_B
    args = resnet_args(RESNET_B)
    args.data_train = str(rec)

    def host_iter():
        return ImageRecordIterator(
            path_imgrec=str(rec), data_shape=FEED_SHAPE,
            batch_size=RESNET_B, shuffle=True, rand_crop=True,
            rand_mirror=True)

    # the host decode alone, batch by batch
    it = host_iter()
    decode_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        it.next()
        decode_ms.append((time.perf_counter() - t) * 1e3)

    net = new_resnet(dev, 0)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": args.lr, "momentum": args.mom,
                       "wd": args.wd})
    ce, metric = SoftmaxCrossEntropyLoss(), Accuracy()

    def step(x, y):
        return ic.train_step(net, trainer, ce, metric, x, y, RESNET_B)

    staged = (torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (RESNET_B,) + FEED_SHAPE).astype(np.float32)).to(dev),
        torch.from_numpy(labels[:RESNET_B]).to(dev))
    for _ in range(2):      # cuDNN's plans and the allocator's pools
        step(*staged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    losses = []
    step_ms = {}

    def timed(way, batches):
        """One epoch of ``batches`` through the step: its seconds; each
        step's host time (the call alone, the wait for its batch left out)
        goes under ``way``."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x, y in batches:
            t1 = time.perf_counter()
            losses.append(step(x, y))
            step_ms.setdefault(way, []).append(
                (time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def inline():
        for b in host_iter():
            yield b.data[0]._data.to(dev), b.label[0]._data.to(dev)

    def fed(it, seen, pairs=False):
        for b in it:
            x, y = (b[0]._data, b[1]._data) if pairs else (
                b.data[0]._data, b.label[0]._data)
            seen.append(y)
            yield x, y

    def check_order(way, seen):
        got = torch.cat(seen).cpu().numpy()
        if len(seen) != steps or not np.array_equal(got, labels):
            fail("feed_resnet50: the %s epoch gave %d batches, labels in "
                 "file order: %s" % (way, len(seen), np.array_equal(
                     got[:len(labels)], labels)))

    def e2e_epoch():
        """One ``image_classification --data-train`` epoch from a new
        iterator (the feed's cold start included, as in every epoch)."""
        it, seen = ic.get_rec_iter(args, FEED_SHAPE, dev), []
        s = timed("e2e", fed(it, seen))
        stats = it.stats()
        it.close()
        check_order("e2e", seen)
        if stats["batches"] != steps:
            fail("feed_resnet50: the feed staged %d batches"
                 % stats["batches"])
        return s, stats

    # the same decode and augmentation in DataLoader worker processes
    loader = gluon.data.DataLoader(
        gluon.data.vision.ImageRecordDataset(str(rec), transform=feed_sample),
        batch_size=RESNET_B, num_workers=FEED_WORKERS,
        prefetch_to_device=dev)
    for _ in loader:        # the first epoch starts the worker processes
        pass
    start_method = loader._pool._ctx.get_start_method()

    def workers_epoch():
        feed, seen = iter(loader), []
        s = timed("workers", fed(((b[0], b[1]) for b in feed), seen,
                                 pairs=True))
        check_order("workers", seen)
        return s, feed.stats()

    # the ways in turn, FEED_EPOCHS rounds, so that a drift of the card's
    # clocks or the host's load falls on all of them alike
    epoch_s = {"compute": [], "sync": [], "e2e": [], "workers": []}
    feed_stats = {"e2e": [], "workers": []}
    for _ in range(FEED_EPOCHS):
        epoch_s["compute"].append(timed("compute", [staged] * steps))
        epoch_s["sync"].append(timed("sync", inline()))
        for way, run in (("e2e", e2e_epoch), ("workers", workers_epoch)):
            s, st = run()
            epoch_s[way].append(s)
            feed_stats[way].append(st)
    loader.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = torch.stack([v.mean() for v in losses]).cpu()
    if not torch.isfinite(loss).all():
        fail("feed_resnet50: a loss is not finite: %s" % loss.tolist())

    # the device's busy time over one more e2e epoch, traced; its idle
    # share is taken against the untraced e2e epochs' median window
    busy_ms, traced_ms = device_busy(e2e_epoch)
    e2e_ms = float(np.median(epoch_s["e2e"])) * 1e3
    idle = 1.0 - busy_ms / e2e_ms
    if busy_ms <= 0 or idle < 0:
        fail("feed_resnet50: the trace counts %.1f ms busy in a %.1f ms "
             "e2e epoch" % (busy_ms, e2e_ms))

    img_s = {k: [FEED_IMAGES / v for v in vs] for k, vs in epoch_s.items()}
    med = {k: float(np.median(v)) for k, v in img_s.items()}

    def spread(way):
        return json.dumps([round(min(img_s[way]), 2),
                           round(max(img_s[way]), 2)])

    def med_stat(way, key):
        return float(np.median([st[key] for st in feed_stats[way]]))
    phase("feed_resnet50", network="resnet50_v1", batch=RESNET_B,
          image=json.dumps(FEED_SHAPE), dtype="float32", steps=steps,
          backend="python", records=FEED_IMAGES, rec_bytes=rec_bytes,
          pack_s=pack_s, epochs_per_way=FEED_EPOCHS,
          compute_imgs_per_s=med["compute"],
          compute_min_max=spread("compute"),
          sync_imgs_per_s=med["sync"], sync_min_max=spread("sync"),
          e2e_imgs_per_s=med["e2e"], e2e_min_max=spread("e2e"),
          overlap=med["e2e"] / med["compute"],
          speedup=med["e2e"] / med["sync"],
          overlap_bar=0.85, speedup_bar=1.5,
          decode_ms_per_batch=float(np.median(decode_ms)),
          decode_ms=json.dumps([round(v, 2) for v in decode_ms]),
          step_host_ms=json.dumps({k: round(float(np.median(v)), 2)
                                   for k, v in step_ms.items()}),
          feed_h2d_ms=med_stat("e2e", "h2d_ms"),
          feed_avg_h2d_ms=med_stat("e2e", "avg_h2d_ms"),
          feed_starved_ms=med_stat("e2e", "starved_ms"),
          feed_peak_depth=max(st["max_queue_depth"]
                              for st in feed_stats["e2e"]),
          workers=FEED_WORKERS, workers_start=start_method,
          workers_imgs_per_s=med["workers"],
          workers_min_max=spread("workers"),
          workers_overlap=med["workers"] / med["compute"],
          workers_speedup=med["workers"] / med["sync"],
          workers_feed_h2d_ms=med_stat("workers", "h2d_ms"),
          workers_feed_starved_ms=med_stat("workers", "starved_ms"),
          peak_memory_gb=peak_gb, e2e_idle_share=idle,
          e2e_device_busy_ms=busy_ms, e2e_window_ms=e2e_ms,
          traced_window_ms=traced_ms,
          traced_epoch_idle_share=1.0 - busy_ms / traced_ms,
          losses_first_last=json.dumps([round(v, 4) for v in
                                        loss[:3].tolist() + loss[-3:].tolist()]),
          batches_in_file_order=True, card='"%s"' % card)
    del net, trainer, staged, losses

    mx.random.seed(0)
    t0 = time.time()
    ic.main(["--network", "resnet50_v1", "--batch-size", str(RESNET_B),
             "--num-epochs", "1", "--data-train", str(rec)])
    torch.cuda.synchronize()
    phase("feed_resnet50_main", data_train=rec.name, backend="python",
          seconds=time.time() - t0, card='"%s"' % card)

    if native:
        from mxnet_tpu_torch.io.native_image_iter import (
            NativeImageRecordIter)

        def module_iter():
            return NativeImageRecordIter(
                path_imgrec=str(rec), data_shape=FEED_SHAPE,
                batch_size=RESNET_B, layout="NHWC")
        backend, layout, dtype = "native", "NHWC", np.uint8
    else:
        print("native_pipeline: unavailable; feed_resnet50_module reads "
              "the python backend", flush=True)

        def module_iter():
            return ImageRecordIterator(path_imgrec=str(rec),
                                       data_shape=FEED_SHAPE,
                                       batch_size=RESNET_B)
        backend, layout, dtype = "python", "NCHW", np.float32

    # every batch, in file order, through the feed
    order = []
    it = module_iter()
    for b in mx.io.DeviceFeed(it, ctx=dev):
        if b.data[0].context != dev or b.data[0].dtype != dtype:
            fail("feed_resnet50: a %s batch is %s on %s"
                 % (backend, b.data[0].dtype, b.data[0].context))
        order.append(b.label[0]._data)
    got = torch.cat(order).cpu().numpy()
    skipped = getattr(it, "skipped", 0)
    if skipped or not np.array_equal(got, labels):
        fail("feed_resnet50: %s batches not all in file order (skipped %d)"
             % (backend, skipped))

    net = new_resnet(dev, 0)
    x = sym.Cast(sym.var("data"), dtype="float32") * (1.0 / 255)
    if layout == "NHWC":
        x = sym.transpose(x, axes=(0, 3, 1, 2))
    out = sym.SoftmaxOutput(net(x), name="softmax")
    params = {k: p.data() for k, p in net.collect_params().items()}
    arg_params = {k: v for k, v in params.items()
                  if k in out.list_arguments()}
    aux_params = {k: v for k, v in params.items()
                  if k in out.list_auxiliary_states()}
    del net
    it = module_iter()
    mod = mx.mod.Module(out, context=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": args.mom,
                              "wd": args.wd},
            arg_params=arg_params, aux_params=aux_params,
            prefetch_to_device=dev)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    cstep = mod._compiled_step
    if cstep is None:
        fail("feed_resnet50: Module.fit did not take the compiled step")
    cache = cstep.cache_stats()
    fed_stats = mod.feed_stats
    if cache["misses"] != 1 or cache["hits"] != steps - 1:
        fail("feed_resnet50: Module.fit captured after warm-up: %s" % cache)
    if fed_stats["batches"] != steps:
        fail("feed_resnet50: Module.fit's feed staged %d batches"
             % fed_stats["batches"])
    it.reset()
    mod.forward(mx.io.stage_batch(it.next(), ctx=dev), is_train=False)
    outs = mod.get_outputs()[0]._data
    args_after, _ = mod.get_params()
    if not torch.isfinite(outs).all() or not all(
            torch.isfinite(v._data).all() for v in args_after.values()):
        fail("feed_resnet50: Module.fit left non-finite outputs or weights")
    phase("feed_resnet50_module", backend=backend, layout=layout,
          dtype=np.dtype(dtype).name, network="resnet50_v1", steps=steps,
          fit_s=fit_s,
          imgs_per_s=FEED_IMAGES / fit_s, captures=cache["misses"],
          hits=cache["hits"], feed_h2d_ms=fed_stats["h2d_ms"],
          feed_starved_ms=fed_stats["starved_ms"],
          feed_peak_depth=fed_stats["max_queue_depth"],
          skipped=skipped, batches_in_file_order=True,
          card='"%s"' % card)


def feed_card_checks(dev, card, workdir, native):
    """Phase ``feed_card_checks``: a staged batch bit-equal to its host
    source; an SGD step on a fed batch bit-equal to the step on a
    pre-staged copy; the allocator check (ALLOC_BATCHES fed batches at
    depth 2, each read by a kernel queued after the next batch landed and
    delayed, none overwritten; the same run without ``record_stream`` as a
    control, not a gate); a CachedOp capture during which the feed thread
    stages CAPTURE_FED batches;
    a dataset of CUDA tensors refused with fork workers; and, with the
    native pipeline, its batches against the Python decoder's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.io import DeviceFeed, device_feed, stage_batch

    rng = np.random.RandomState(2)
    host = (mx.nd.array(rng.randn(32, 3, 64, 64).astype(np.float32),
                        ctx=mx.cpu()),
            torch.from_numpy(rng.randint(0, 10, 32).astype(np.float32)))
    staged = stage_batch(host, ctx=dev)
    if staged[0].context != dev or staged[1].device != dev:
        fail("feed_card_checks: stage_batch left a leaf on the host")
    if not (torch.equal(staged[0]._data.cpu(), host[0]._data)
            and torch.equal(staged[1].cpu(), host[1])):
        fail("feed_card_checks: a staged batch differs from its source")
    fed, = list(DeviceFeed([host], ctx=dev))
    if not torch.equal(fed[0]._data.cpu(), host[0]._data):
        fail("feed_card_checks: a fed batch differs from its source")

    def sgd_step(x, y):
        mx.random.seed(3)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(8, 3, device=dev), gluon.nn.Flatten(),
                gluon.nn.Dense(10, device=dev))
        net.initialize(mx.init.Xavier())
        net(x)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward(torch.ones_like(loss))
        trainer.step(x.shape[0])
        return state_copy(net)

    with deterministic_cudnn():
        a = sgd_step(fed[0]._data, fed[1])
        b = sgd_step(host[0]._data.to(dev), host[1].to(dev))
    differ = state_diff(a, b)
    if differ:
        fail("feed_card_checks: the step on a fed batch differs: %s" % differ)

    def alloc_run(claim):
        saved = device_feed._claim
        if not claim:
            device_feed._claim = lambda item: None
        try:
            src = (torch.full((ALLOC_ELEMS,), float(i))
                   for i in range(ALLOC_BATCHES))
            sums = []
            with DeviceFeed(src, ctx=dev, depth=2) as feed:
                prev = next(feed)
                for cur in feed:
                    # prev is read only after cur has landed, behind a delay
                    torch.cuda._sleep(ALLOC_SLEEP_CYCLES)
                    sums.append(prev.sum())
                    prev = cur
                sums.append(prev.sum())
            got = torch.stack(sums).cpu().numpy()
        finally:
            device_feed._claim = saved
        want = np.arange(ALLOC_BATCHES, dtype=np.float64) * ALLOC_ELEMS
        return int((got != want).sum())
    overwritten = alloc_run(True)
    if overwritten:
        fail("feed_card_checks: %d of %d fed batches were overwritten "
             "before the consumer read them" % (overwritten, ALLOC_BATCHES))
    control = alloc_run(False)

    # a CachedOp capture on this thread while the feed thread copies: the
    # source holds back until the capture has begun, and the Dense layer
    # being captured waits there, its product queued, until the feed has
    # staged CAPTURE_FED more batches (the queue holds them all)
    capturing = threading.Event()
    during = {}

    def gated():
        for i in range(64):
            if i == 1:
                capturing.wait(CAPTURE_WAIT_S)
            yield torch.full((4 << 20,), float(i))
    feed = DeviceFeed(gated(), ctx=dev, depth=64)
    first = next(feed)

    class Gated(gluon.nn.Dense):
        def forward(self, x):
            out = super().forward(x)
            if "staged" not in during and \
                    torch.cuda.is_current_stream_capturing():
                before = feed.stats()["batches"]
                capturing.set()
                deadline = time.time() + CAPTURE_WAIT_S
                while (feed.stats()["batches"] < before + CAPTURE_FED
                       and time.time() < deadline):
                    time.sleep(0.001)
                during["staged"] = feed.stats()["batches"] - before
            return out

    net = Gated(16, in_units=32, device=dev)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    xin = torch.randn(8, 32, device=dev)
    out = net(xin)
    capturing.set()
    rest = [first] + list(feed)
    caps = net._cached_op.capture_stats()
    want_out = net.hybrid_call(xin)
    if not torch.equal(out, want_out) or caps["captures"] != 1:
        fail("feed_card_checks: the capture beside the feed: %s" % caps)
    if during.get("staged", 0) < CAPTURE_FED:
        fail("feed_card_checks: the feed staged %s batches during the "
             "capture, not %d" % (during.get("staged"), CAPTURE_FED))
    vals = torch.stack([t[0] for t in rest]).cpu().numpy()
    if len(rest) != 64 or not np.array_equal(vals, np.arange(64)):
        fail("feed_card_checks: the feed beside the capture lost batches")

    # pin_memory stages into page-locked host memory
    with gluon.data.DataLoader(
            gluon.data.ArrayDataset(host[0].asnumpy(), host[1].numpy()),
            batch_size=8, pin_memory=True) as loader:
        px, py = next(iter(loader))
    if not (px._data.is_pinned() and py._data.is_pinned()) or not \
            torch.equal(px._data, host[0]._data[:8]):
        fail("feed_card_checks: pin_memory batches are not page-locked "
             "copies of the data")

    # CUDA tensors in a dataset: fork workers refused
    held = gluon.data.ArrayDataset(mx.nd.ones((8, 2), ctx=dev),
                                   np.zeros(8, np.float32))
    try:
        gluon.data.DataLoader(held, batch_size=2, num_workers=2)
        fail("feed_card_checks: a CUDA dataset took fork workers")
    except mx.MXNetError:
        pass

    native_fields = {}
    if native:
        from mxnet_tpu_torch import recordio
        from mxnet_tpu_torch.io.native_image_iter import NativeImageRecordIter
        rec = workdir / "feed.rec"
        it = NativeImageRecordIter(path_imgrec=str(rec),
                                   data_shape=(3, FEED_SIDE, FEED_SIDE),
                                   batch_size=RESNET_B)
        batch = it.next().data[0].asnumpy()
        r = recordio.MXRecordIO(str(rec), "r")
        ref = np.stack([recordio.unpack_img(r.read())[1].transpose(2, 0, 1)
                        for _ in range(RESNET_B)]).astype(np.float32)
        r.close()
        mean_gap = float(np.abs(batch.mean(axis=(1, 2, 3))
                                - ref.mean(axis=(1, 2, 3))).max())
        if mean_gap >= NATIVE_MEAN_BOUND:
            fail("feed_card_checks: native and Python decodes differ by "
                 "%.3g in an image's mean" % mean_gap)
        native_fields = dict(native_vs_python_mean_gap=mean_gap,
                             native_vs_python_max_abs=float(
                                 np.abs(batch - ref).max()),
                             mean_bound=NATIVE_MEAN_BOUND)
    phase("feed_card_checks", staged_bitwise=True, fed_step_bitwise=True,
          alloc_batches=ALLOC_BATCHES, alloc_depth=2, overwritten=overwritten,
          control_without_record_stream_overwritten=control,
          capture_beside_feed=caps["captures"],
          staged_during_capture=during["staged"], pin_memory_pinned=True,
          cuda_dataset_refused=True,
          **native_fields, card='"%s"' % card)


def write_mnist_idx(root, n, seed=0):
    """``n`` seeded 28 x 28 digits and labels as MNIST's idx files: each
    class a random template, each image its template plus noise (a set
    LeNet can learn)."""
    import struct

    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 256, (10, 28, 28))
    labels = rng.randint(0, 10, n)
    images = np.clip(0.6 * templates[labels]
                     + rng.randint(0, 102, (n, 28, 28)), 0, 255)
    with open(root / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">HBBIII", 0, 8, 3, n, 28, 28)
                + images.astype(np.uint8).tobytes())
    with open(root / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">HBBI", 0, 8, 1, n)
                + labels.astype(np.uint8).tobytes())


def mnist_idx(dev, card, workdir):
    """Phase ``mnist_idx``: ``models/train_mnist.py --network lenet`` on the
    card over idx files of MNIST_IDX_N seeded images: ``io.MNISTIter`` on
    the host and ``Module.fit(prefetch_to_device=card)``, one epoch; its
    images/s, final training accuracy, captures, and the first batch's
    logits on the card against the CPU."""
    import logging

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import train_mnist

    root = workdir / "mnist"
    root.mkdir()
    write_mnist_idx(root, MNIST_IDX_N)
    epoch_s = []

    class EpochTime(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("Epoch[%d] Time cost"):
                epoch_s.append(record.args[1])
    handler = EpochTime()
    logging.getLogger().addHandler(handler)
    try:
        mx.random.seed(0)
        mod = train_mnist.main(["--network", "lenet", "--num-epochs", "1",
                                "--batch-size", str(MNIST_B),
                                "--data-dir", str(root)])
    finally:
        logging.getLogger().removeHandler(handler)
    steps = -(-MNIST_IDX_N // MNIST_B)
    cache = mod._compiled_step.cache_stats()
    if cache["misses"] != 1 or cache["hits"] != steps - 1:
        fail("mnist_idx: captures after warm-up: %s" % cache)
    if mod.feed_stats["batches"] != steps:
        fail("mnist_idx: the feed staged %d of %d batches"
             % (mod.feed_stats["batches"], steps))
    acc = mod.last_score[0][1]

    arg_params, aux_params = mod.get_params()
    first = mx.io.MNISTIter(
        image=str(root / "train-images-idx3-ubyte"),
        label=str(root / "train-labels-idx1-ubyte"), batch_size=MNIST_B,
        shuffle=False, ctx=mx.cpu()).next()
    outs = {}
    for where in (dev, mx.cpu()):
        for name, symbol, labels in (
                ("probs", mod.symbol, ["softmax_label"]),
                ("logits", mod.symbol.get_internals()["fc2_output"], [])):
            m = mx.mod.Module(symbol, label_names=labels, context=where)
            m.bind(data_shapes=[("data", (MNIST_B, 1, 28, 28))],
                   label_shapes=[(n, (MNIST_B,)) for n in labels],
                   for_training=False)
            m.set_params({k: v.as_in_context(where) for k, v in
                          arg_params.items()},
                         {k: v.as_in_context(where) for k, v in
                          aux_params.items()}, allow_extra=True)
            m.forward(mx.io.DataBatch(
                data=[first.data[0].as_in_context(where)],
                label=[first.label[0].as_in_context(where)][:len(labels)]),
                is_train=False)
            outs[name, str(where)] = m.get_outputs()[0].asnumpy()
    # the module's outputs at tests/test_torch_module.py's bound for one set
    # of weights; the logits beside them, against each row's largest
    probs, cpu_probs = outs["probs", str(dev)], outs["probs", "cpu"]
    err = np.abs(probs - cpu_probs)
    if not np.all(err <= MNIST_IDX_ATOL + MNIST_IDX_RTOL
                  * np.abs(cpu_probs)):
        fail("mnist_idx: outputs on the card vs the CPU: max abs %.3g"
             % err.max())
    logits, cpu_logits = outs["logits", str(dev)], outs["logits", "cpu"]
    logit_err = np.abs(logits - cpu_logits)
    scale = np.abs(cpu_logits).max(axis=1, keepdims=True)
    if not np.all(logit_err <= MNIST_IDX_RTOL * scale):
        fail("mnist_idx: logits on the card vs the CPU: %.3g of the row's "
             "largest" % (logit_err / scale).max())
    phase("mnist_idx", network="lenet", images=MNIST_IDX_N, batch=MNIST_B,
          steps=steps, epoch_s=epoch_s[0] if epoch_s else None,
          imgs_per_s=MNIST_IDX_N / epoch_s[0] if epoch_s else None,
          train_accuracy=acc, captures=cache["misses"], hits=cache["hits"],
          feed_h2d_ms=mod.feed_stats["h2d_ms"],
          feed_starved_ms=mod.feed_stats["starved_ms"],
          outputs_vs_cpu_max_abs=float(err.max()),
          logits_vs_cpu_max_abs=float(logit_err.max()),
          logits_vs_cpu_of_row_max=float((logit_err / scale).max()),
          rtol=MNIST_IDX_RTOL, atol=MNIST_IDX_ATOL, card='"%s"' % card)


def input_phases(cuda_ops, dev, card):
    """The input pipeline: the probe, ``feed_resnet50``,
    ``feed_card_checks`` and ``mnist_idx``.  Returns the kernel's launches
    there (0: no attention on these paths)."""
    import tempfile

    seconds = {}
    reset_launches(cuda_ops)
    pil, native = input_probe()
    with tempfile.TemporaryDirectory() as tmp:
        for fn in (feed_resnet50, feed_card_checks):
            t0 = time.time()
            fn(dev, card, Path(tmp), native)
            seconds[fn.__name__] = round(time.time() - t0, 2)
        t0 = time.time()
        mnist_idx(dev, card, Path(tmp))
        seconds["mnist_idx"] = round(time.time() - t0, 2)
    phase("input_seconds", **seconds)
    if cuda_ops.flash_attention.launches:
        fail("the input phases launched flash_attention %d times"
             % cuda_ops.flash_attention.launches)
    return cuda_ops.flash_attention.launches


# ---------------------------------------------------------------------------
# recurrent models: the bucketed LSTM-PTB language model through
# BucketingModule.fit (fused and unfused), the RNN op on the card against
# the CPU, and Gluon's LSTM eager and hybridized

LSTM_PTB = dict(num_layers=2, num_hidden=200, num_embed=200,
                vocab_size=10000, batch_size=32)
LSTM_BUCKETS = (10, 20, 30, 40, 50, 60)
LSTM_BATCHES_PER_BUCKET = 4
# the example's tokens are uniform at random: the next token cannot be
# predicted, only the 24 batches memorized, which 2 epochs do not show
# (fused: 10,064.9 then 10,363.1 on an H100) and 12 do
LSTM_EPOCHS = 12
RNN_RTOL, RNN_ATOL = 1e-4, 1e-5     # tests/test_rnn.py:129
RNN_VS_CPU = (12, 8, 64, 64)        # T, B, input and hidden width, 2 layers
RNN_WEIGHT = 0.07                   # the blob's scale: FusedRNN's default
RNN_VS_CPU_UPDATES = 3              # Uniform(0.07)
# Adam moves a weight by lr * m / (sqrt(v) + 1e-8): where every rescaled
# gradient of both runs is within ADAM_TIE of 0 but not 0 (a sum that
# cancels), the rounding of the sum, which differs between the card and
# the CPU, sets the step; those elements are counted, not compared
ADAM_TIE = 1e-7
GLUON_LSTM = (35, 32, 200, 2, 0.2)  # T, B, hidden (= input), layers, dropout
GLUON_LSTM_STEPS = 12


def lstm_bucketing_argv(fused):
    w = LSTM_PTB
    return ["--num-layers", str(w["num_layers"]),
            "--num-hidden", str(w["num_hidden"]),
            "--num-embed", str(w["num_embed"]),
            "--vocab-size", str(w["vocab_size"]),
            "--batch-size", str(w["batch_size"]),
            "--buckets", ",".join(str(b) for b in LSTM_BUCKETS),
            "--batches-per-bucket", str(LSTM_BATCHES_PER_BUCKET),
            "--num-epochs", str(LSTM_EPOCHS), "--fused", str(int(fused))]


class StepMarks:
    """A batch-end callback of ``fit``: a CUDA event and the host's clock
    at each batch's end, with the batch's bucket and the number of bound
    buckets.  The span between two marks is one step: the batch's forward,
    backward and update, the metric, and the next batch's fetch and
    ``prepare`` (which binds a bucket's module the first time it comes)."""

    def __init__(self):
        self.marks = []

    def __call__(self, param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((ev, time.perf_counter(),
                           param.locals["data_batch"].bucket_key,
                           len(param.locals["self"]._buckets)))

    def steps(self):
        """{bucket: [(device ms, host ms)]} of the steps after a bucket's
        first (its capture) in which no module was bound."""
        torch.cuda.synchronize()
        seen, out = set(), {}
        for prev, cur in zip(self.marks, self.marks[1:]):
            bucket = cur[2]
            first = bucket not in seen
            seen.add(bucket)
            if first or cur[3] != prev[3]:
                continue
            out.setdefault(bucket, []).append(
                (prev[0].elapsed_time(cur[0]), (cur[1] - prev[1]) * 1e3))
        return out


def lstm_bucketing(dev, card, fused):
    """Phase ``lstm_bucketing`` (the ``RNN`` op, ``FusedRNNCell``) or
    ``lstm_bucketing_unfused`` (``LSTMCell``s): ``models/lstm_bucketing
    .main`` at the upstream example's widths (2 x 200, embed 200, vocab
    10,000, B = 32, buckets 10-60), BucketSeqIter's LSTM_BATCHES_PER_BUCKET
    batches a bucket, LSTM_EPOCHS epochs, Adam at lr 0.01.  One bound
    module a bucket; perplexity must fall.  Per bucket, the median step
    (CUDA events) and tokens/s; one step of the longest bucket profiled
    (kernels launched, device ms) against its host ms; peak memory."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import lstm_bucketing as lb

    label = "lstm_bucketing" if fused else "lstm_bucketing_unfused"
    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    marks = StepMarks()
    t0 = time.time()
    mod = lb.main(lstm_bucketing_argv(fused), batch_end_callback=marks)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    ppl = mod.epoch_perplexity
    if len(mod._buckets) != len(LSTM_BUCKETS):
        fail("%s: %d bound modules for %d buckets" % (
            label, len(mod._buckets), len(LSTM_BUCKETS)))
    if not (np.isfinite(ppl).all() and ppl[-1] < ppl[0]):
        fail("%s: perplexity did not fall: %s" % (label, ppl))
    steps = marks.steps()
    B = LSTM_PTB["batch_size"]
    per_bucket = {}
    for bucket in LSTM_BUCKETS:
        dev_ms = float(np.median([d for d, _ in steps[bucket]]))
        host_ms = float(np.median([h for _, h in steps[bucket]]))
        per_bucket[bucket] = (dev_ms, host_ms, B * bucket / dev_ms * 1e3)
    # one step of the longest bucket, profiled and timed on the host
    it = lb.BucketSeqIter([max(LSTM_BUCKETS)], B, LSTM_PTB["vocab_size"], 1,
                          seed=1, ctx=dev)
    batch = next(iter(it))

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t1) * 1e3
    device_ms, kernels = device_profile(step)
    peak = torch.cuda.max_memory_allocated(dev)
    phase(label, layers=LSTM_PTB["num_layers"],
          hidden=LSTM_PTB["num_hidden"], embed=LSTM_PTB["num_embed"],
          vocab=LSTM_PTB["vocab_size"], batch=B,
          buckets=",".join(str(b) for b in LSTM_BUCKETS),
          batches_per_bucket=LSTM_BATCHES_PER_BUCKET, epochs=LSTM_EPOCHS,
          bound_modules=len(mod._buckets),
          perplexity_first=round(ppl[0], 3), perplexity_last=round(ppl[-1], 3),
          fit_s=round(fit_s, 2), compiled_step=mod._compiled_step is not None,
          **{"step_ms_%d" % b: round(v[0], 3)
             for b, v in per_bucket.items()},
          **{"host_ms_%d" % b: round(v[1], 3)
             for b, v in per_bucket.items()},
          **{"tokens_s_%d" % b: round(v[2], 1)
             for b, v in per_bucket.items()},
          profiled_bucket=max(LSTM_BUCKETS), step_host_ms=round(host_ms, 3),
          step_device_ms=round(device_ms, 3),
          launches_a_step=sum(kernels.values()),
          peak_mem_gib=round(peak / 2 ** 30, 3), card='"%s"' % card)
    return mod


def rnn_op_case(mode, bidirectional, seed):
    T, B, I, H = RNN_VS_CPU
    from mxnet_tpu_torch.ops.nn_ops import RNN_GATES
    g, d = RNN_GATES[mode], 2 if bidirectional else 1
    n, ins = 0, I
    for _ in range(2):
        n += d * (g * H * ins + g * H * H)
        ins = H * d
    n += 2 * 2 * d * g * H
    rng = np.random.RandomState(seed)
    arrays = [rng.uniform(-1, 1, (T, B, I)),
              rng.uniform(-RNN_WEIGHT, RNN_WEIGHT, (n,)),
              rng.uniform(-0.5, 0.5, (2 * d, B, H))]
    if mode == "lstm":
        arrays.append(rng.uniform(-0.5, 0.5, (2 * d, B, H)))
    shapes = [(T, B, d * H)] + [(2 * d, B, H)] * (2 if mode == "lstm" else 1)
    heads = [rng.normal(0, 1, s) for s in shapes]
    return ([a.astype(np.float32) for a in arrays],
            [h.astype(np.float32) for h in heads])


def rnn_op_run(device, arrays, heads, attrs, training, seed):
    """Outputs and input gradients of the ``RNN`` op on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.register import tensor_ops

    mx.random.seed(seed)
    ts = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
    with mx.autograd.train_mode() if training else \
            mx.autograd.predict_mode():
        outs = tensor_ops.RNN(*ts, **attrs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(list(outs), [torch.from_numpy(h).to(device)
                                         for h in heads[:len(outs)]])
    return ([o.detach().cpu().numpy() for o in outs],
            [t.grad.cpu().numpy() for t in ts])


def rnn_errs(got, want, masks=None):
    """The largest |got - want| and the largest excess over the bound
    (<= 0 within it), over the elements ``masks`` keep (default all)."""
    err = excess = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        diff = np.abs(g - w)
        over = diff - RNN_ATOL - RNN_RTOL * np.abs(w)
        if masks is not None:
            diff, over = diff[masks[i]], over[masks[i]]
        if diff.size:
            err = max(err, float(diff.max()))
            excess = max(excess, float(over.max()))
    return err, excess


def largest_grads(mod, seen):
    """Fold the bound bucket's rescaled gradients into ``seen`` (name ->
    the largest |gradient| of each element so far, over both runs)."""
    cur = mod._curr_module
    scale = cur._optimizer.rescale_grad
    group = cur._exec_group
    for name, grads in zip(group.param_names, group.grad_arrays):
        g = grads[0].asnumpy() * scale
        seen[name] = np.maximum(seen.get(name, 0), np.abs(g))


def rnn_vs_cpu(dev):
    """Phase: the ``RNN`` op on the card against the CPU for the four
    modes, each uni- and bidirectional, 2 layers with ``state_outputs``:
    outputs, final states and the gradients of data, parameters and states
    within tests/test_rnn.py's bound; with ``p = 0.5`` in training, the
    inter-layer masks bit-equal (drawn on both from one key) and the
    outputs within the bound; then BucketingModule's first
    RNN_VS_CPU_UPDATES Adam updates of lstm_bucketing at depth 1, card
    against CPU from the same weights and batches, every weight but the
    Adam ties (ADAM_TIE) within the bound."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.models import lstm_bucketing as lb
    from mxnet_tpu_torch.ops.random_ops import bernoulli

    T, B, I, H = RNN_VS_CPU
    worst = {}
    cpu = torch.device("cpu")
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bi in (False, True):
            arrays, heads = rnn_op_case(mode, bi, 3)
            attrs = dict(state_size=H, num_layers=2, bidirectional=bi,
                         mode=mode, state_outputs=True)
            got = rnn_op_run(dev, arrays, heads, attrs, False, 0)
            want = rnn_op_run(cpu, arrays, heads, attrs, False, 0)
            err, excess = rnn_errs(got[0] + got[1], want[0] + want[1])
            if excess > 0:
                fail("rnn_vs_cpu: %s bidirectional=%s: max abs %.3g beyond "
                     "rtol %g / atol %g" % (mode, bi, err, RNN_RTOL,
                                            RNN_ATOL))
            worst["%s%s" % (mode, "_bi" if bi else "")] = err
    # dropout between layers: the masks from one key, then the op
    key = mx_random.split(mx_random.prng_key(7))[1]
    masks = [bernoulli(key, 0.5, (T, B, 2 * H), d).cpu() for d in (dev, cpu)]
    if not torch.equal(*masks):
        fail("rnn_vs_cpu: the p=0.5 masks differ between the card and "
             "the CPU")
    arrays, heads = rnn_op_case("lstm", True, 4)
    attrs = dict(state_size=H, num_layers=2, bidirectional=True,
                 mode="lstm", state_outputs=True, p=0.5)
    got = rnn_op_run(dev, arrays, heads, attrs, True, 5)
    want = rnn_op_run(cpu, arrays, heads, attrs, True, 5)
    drop_err, excess = rnn_errs(got[0] + got[1], want[0] + want[1])
    if excess > 0:
        fail("rnn_vs_cpu: p=0.5 in training: max abs %.3g" % drop_err)
    # BucketingModule: the first updates at depth 1, card against CPU
    w = dict(LSTM_PTB, num_layers=1)
    mods, batches, grads = {}, None, {}
    for where, device in (("card", dev), ("cpu", cpu)):
        mx.random.seed(0)
        with mx.name.NameManager():
            mod = mx.mod.BucketingModule(
                lb.sym_gen_factory(w["num_hidden"], 1, w["num_embed"],
                                   w["vocab_size"]),
                default_bucket_key=max(LSTM_BUCKETS), context=device)
        it = lb.BucketSeqIter(list(LSTM_BUCKETS), w["batch_size"],
                              w["vocab_size"], 1, ctx=device)
        mod.bind(it.provide_data, it.provide_label)
        if where == "card":
            mod.init_params(mx.init.Xavier())
            start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            from mxnet_tpu_torch import convert
            mod.init_params(arg_params=convert.ndarrays_from_numpy(
                start, ctx=cpu), aux_params={})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        keys = []
        for batch in itertools.islice(iter(it), RNN_VS_CPU_UPDATES):
            mod.forward(batch, is_train=True)
            mod.backward()
            largest_grads(mod, grads)
            mod.update()
            keys.append(batch.bucket_key)
        batches = keys if batches is None else batches
        if keys != batches:
            fail("rnn_vs_cpu: the card and CPU iterators differ")
        mods[where] = {k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()}
    names = sorted(start)
    keep = [(grads[k] >= ADAM_TIE) | (grads[k] == 0) for k in names]
    ties = int(sum((~m).sum() for m in keep))
    upd_err, excess = rnn_errs([mods["card"][k] for k in names],
                               [mods["cpu"][k] for k in names], keep)
    if excess > 0:
        fail("rnn_vs_cpu: BucketingModule after %d updates: max abs %.3g"
             % (RNN_VS_CPU_UPDATES, upd_err))
    phase("rnn_vs_cpu", T=T, B=B, input=I, hidden=H, layers=2,
          rtol=RNN_RTOL, atol=RNN_ATOL,
          **{"max_abs_%s" % k: "%.3g" % v for k, v in worst.items()},
          masks_bit_equal=True, dropout_max_abs="%.3g" % drop_err,
          bucketing_updates=RNN_VS_CPU_UPDATES,
          bucketing_buckets=",".join(str(b) for b in batches),
          bucketing_max_abs="%.3g" % upd_err, adam_ties=ties,
          adam_tie=ADAM_TIE, weights=sum(start[k].size for k in names))


def gluon_lstm(dev, card):
    """Phase: ``gluon.rnn.LSTM(200, num_layers=2, dropout=0.2)`` at B 32
    and T 35 with explicit begin states, a training step (forward and
    backward under ``autograd.record``) eager and hybridized: median step
    ms (CUDA events), kernels launched and device ms of one step
    (torch.profiler); the hybridized layer captures once and replays, and
    its graphed output equals the eager forward under the same key.  Then
    ``torch.nn.LSTM`` (cuDNN) forward and backward on the same weights, the
    library's time for the same step, used nowhere in the port: in
    prediction it computes what the layer computes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mx_random

    T, B, H, L, p = GLUON_LSTM
    mx.random.seed(0)
    net = mx.gluon.rnn.LSTM(H, num_layers=L, dropout=p, input_size=H,
                            device=dev)
    net.initialize(mx.init.Xavier(), ctx=dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (T, B, H)).astype(
        np.float32)).to(dev)
    states = [s._data for s in net.begin_state(B, ctx=dev)]

    def step():
        with mx.autograd.record():
            out, new = net(x, states)
            loss = out.sum() + sum(s.sum() for s in new)
        loss.backward()
        return out

    numbers = {}
    for way in ("eager", "hybrid"):
        net.hybridize(way == "hybrid")
        ms = [cuda_timed(step) for _ in range(GLUON_LSTM_STEPS)]
        device_ms, kernels = device_profile(step)
        numbers[way] = (median_of(ms), device_ms, sum(kernels.values()))
    caps = net._cached_op.capture_stats()
    if caps["captures"] != 1 or caps["replays"] < GLUON_LSTM_STEPS:
        fail("gluon_lstm: not one capture replayed: %s" % caps)
    # the graphed forward against the eager one under the same key
    mx.random.seed(11)
    with mx.autograd.record():
        graphed = net(x, states)[0].detach()
    mx.random.seed(11)
    key = mx_random.next_key()
    with mx.autograd.record(), mx_random.key_override(key):
        eager = net.hybrid_call(x, *states)[0].detach()
    if not torch.equal(graphed, eager):
        fail("gluon_lstm: graphed output differs from eager by %.3g"
             % (graphed - eager).abs().max().item())
    # torch.nn.LSTM (cuDNN) on the same weights
    ref = torch.nn.LSTM(H, H, num_layers=L, dropout=p).to(dev)
    params = {k: v.data().asnumpy() for k, v in
              net._collect_params_with_prefix().items()}
    with torch.no_grad():
        for k in range(L):
            for ours, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(ref, "%s_l%d" % (theirs, k)).copy_(
                    torch.from_numpy(params["l%d_%s" % (k, ours)]))
    net.hybridize(False)
    with mx.autograd.predict_mode():
        ours = net(x, states)[0].detach()
    ref.eval()
    with torch.no_grad():
        theirs = ref(x, tuple(states))[0]
    lib_err = (ours - theirs).abs().max().item()
    if lib_err > RNN_ATOL + RNN_RTOL * theirs.abs().max().item():
        fail("gluon_lstm: torch.nn.LSTM in prediction differs by %.3g"
             % lib_err)
    ref.train()

    def lib_step():
        out, (h, c) = ref(x, tuple(states))
        (out.sum() + h.sum() + c.sum()).backward()

    lib_ms = median_of([cuda_timed(lib_step)
                        for _ in range(GLUON_LSTM_STEPS)])
    lib_device_ms, lib_kernels = device_profile(lib_step)
    phase("gluon_lstm", T=T, B=B, hidden=H, layers=L, dropout=p,
          eager_step_ms=round(numbers["eager"][0], 3),
          eager_device_ms=round(numbers["eager"][1], 3),
          eager_launches=numbers["eager"][2],
          hybrid_step_ms=round(numbers["hybrid"][0], 3),
          hybrid_device_ms=round(numbers["hybrid"][1], 3),
          hybrid_launches=numbers["hybrid"][2],
          captures=caps["captures"], replays=caps["replays"],
          graphed_equals_eager=True,
          torch_lstm_step_ms=round(lib_ms, 3),
          torch_lstm_device_ms=round(lib_device_ms, 3),
          torch_lstm_launches=sum(lib_kernels.values()),
          torch_lstm_predict_max_abs="%.3g" % lib_err, card='"%s"' % card)


def rnn_phases(cuda_ops, dev, card):
    """The recurrent models: ``lstm_bucketing``, ``lstm_bucketing_unfused``,
    ``rnn_vs_cpu`` and ``gluon_lstm``.  Returns the kernel's launches there
    (``launches_rnn``; 0: no attention on these paths)."""
    seconds = {}
    reset_launches(cuda_ops)
    for name, fn in (("lstm_bucketing", lambda: lstm_bucketing(dev, card,
                                                                True)),
                     ("lstm_bucketing_unfused",
                      lambda: lstm_bucketing(dev, card, False)),
                     ("rnn_vs_cpu", lambda: rnn_vs_cpu(dev)),
                     ("gluon_lstm", lambda: gluon_lstm(dev, card))):
        t0 = time.time()
        fn()
        seconds[name] = round(time.time() - t0, 2)
    phase("rnn_seconds", **seconds)
    launches = cuda_ops.flash_attention.launches
    phase("launches_rnn", flash_attention=launches)
    if launches:
        fail("the recurrent phases launched flash_attention %d times"
             % launches)
    return launches


# ---------------------------------------------------------------------------
# the detection slice: SSD at VGG-16 / 300 x 300, example/rcnn, Faster
# R-CNN's proposal and ROI ops at its test-time widths, the 17 ops card
# against CPU, and the greedy NMS scan's kernel against its plain loop

SSD_ARGS = dict(num_classes=20, backbone="vgg16", num_scales=3,
                img_size=300, batch_size=32)
SSD_EPOCHS, SSD_ITERS, SSD_EVAL_BATCHES = 2, 10, 2
SSD_ANCHORS = 7096          # 4 x (37^2 + 18^2 + 9^2) at 300 x 300
SSD_TIMED_STEPS = 6
SSD_NMS = 0.45
# Faster R-CNN's test-time RPN (MXNet example/rcnn, VGG-16 conv5_3 at
# stride 16 over a 600 x 1000 image: 37 x 62 after four floor-mode pools)
RCNN_MAP = (512, 37, 62)
RCNN_IM_INFO = (600.0, 1000.0, 1.0)
PROPOSAL_FULL = {"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                 "threshold": 0.7, "rpn_min_size": 16, "feature_stride": 16,
                 "scales": (8.0, 16.0, 32.0), "ratios": (0.5, 1.0, 2.0)}
ROI_FULL = {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}
IOU_TIE = 1e-6        # an IoU this close to the threshold may round apart
ROIS_ATOL = 1e-3      # px: 16 fp32 ulps at 1,000 (exp's last bits, scaled)
ROI_CHUNK = 30        # rois a CPU ROIPooling call takes (~0.4 GB each)
DETECTION_OPS = (
    "ROIPooling", "_contrib_ROIAlign", "_contrib_PSROIPooling",
    "_contrib_DeformablePSROIPooling", "_contrib_DeformableConvolution",
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "_contrib_Proposal",
    "_contrib_MultiProposal", "_contrib_box_iou", "_contrib_box_nms",
    "_contrib_bipartite_matching", "BilinearSampler", "GridGenerator",
    "SpatialTransformer", "Correlation")


def nms_bound(keep):
    """(bound ms, the pack pass's read ms) of the scan that gave ``keep``
    (B, K): the bytes the recurrence must move, each kept candidate j's
    row past j (K - 1 - j bytes of sup: no other row decides a keep),
    init read once and keep written once, over the card's memory rate;
    beside it the strict upper triangle of sup, which this design's pack
    pass reads whole."""
    bytes_peak = card_peaks(torch.cuda.get_device_name(0))[3]
    B, K = keep.shape
    tail = K - 1 - torch.arange(K, device=keep.device)
    need = int((keep * tail).sum()) + 2 * B * K
    return need / bytes_peak * 1e3, B * K * (K - 1) // 2 / bytes_peak * 1e3


def nms_against_plain(nms_ops, sup, init, label, card):
    """The kernel against its plain loop on one mask on the card: keep
    masks bit-equal; both timed (the plain loop's K steps of small ops)."""
    keep = nms_ops.greedy_nms(sup, init)
    want = nms_ops.greedy_nms_reference(sup, init)
    torch.cuda.synchronize()
    mismatches = int((keep != want).sum())
    if mismatches:
        fail("greedy_nms %s: %d keep decisions differ from the plain loop"
             % (label, mismatches))
    B, K = init.shape
    ms = time_ms(lambda: nms_ops.greedy_nms(sup, init), reps=10, calls=4)
    plain_ms = time_ms(lambda: nms_ops.greedy_nms_reference(sup, init),
                       reps=2, calls=1)
    bound_ms, pack_ms = nms_bound(keep)
    numbers = dict(B=B, K=K, kept=int(keep.sum()), candidates=int(init.sum()),
                   suppressing_pairs=int(sup.triu(1).sum()),
                   mismatches=mismatches, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by="bytes",
                   pack_read_ms=pack_ms, chain_steps=K,
                   block_steps=(K + 63) // 64)
    phase("greedy_nms_" + label, **numbers, card='"%s"' % card)
    return numbers


def ssd_argv(dev):
    return ["--backbone", SSD_ARGS["backbone"],
            "--num-classes", str(SSD_ARGS["num_classes"]),
            "--num-scales", str(SSD_ARGS["num_scales"]),
            "--img-size", str(SSD_ARGS["img_size"]),
            "--batch-size", str(SSD_ARGS["batch_size"]),
            "--epochs", str(SSD_EPOCHS), "--iters", str(SSD_ITERS),
            "--eval-batches", str(SSD_EVAL_BATCHES), "--device", str(dev)]


def ssd_vgg16(dev, card, nms_ops):
    """Phase ``ssd_vgg16``: ``models/ssd.py``'s ``main`` with
    ``MultiScaleSSD(20, backbone='vgg16', num_scales=3)`` at 300 x 300,
    B = 32 (PASCAL VOC's classes, the upstream example's data shape and
    batch): Adam at lr 0.002, mining 3:1, SSD_EPOCHS of SSD_ITERS synthetic
    batches, mAP (NMS 0.45, top 100) on SSD_EVAL_BATCHES held-out batches
    before and after.  The kernel's launches are those of this run.  Then
    SSD_TIMED_STEPS steps on staged batches (CUDA events), a forward's
    breakdown, one step profiled, and the scan on a held-out batch's mask
    against its plain loop.  Gates: 7,096 anchors, the last epoch's loss
    below the first, a detection kept after NMS."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import contrib_ops
    from mxnet_tpu_torch.ops.registry import get_op

    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nms_ops.greedy_nms.launches = 0
    t0 = time.time()
    out = ssd.main(ssd_argv(dev))
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = nms_ops.greedy_nms.launches
    peak_main = torch.cuda.max_memory_allocated(dev)
    losses, net = out["epoch_loss"], out["net"]
    if launches < 1:
        fail("ssd_vgg16: greedy_nms launched %d times" % launches)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("ssd_vgg16: the loss did not fall: %s" % losses)
    if out["kept"] < 1:
        fail("ssd_vgg16: NMS kept no detection")

    B, side = SSD_ARGS["batch_size"], SSD_ARGS["img_size"]
    rng = np.random.RandomState(5)
    batches = [ssd.synthetic_batch(rng, B, side, SSD_ARGS["num_classes"])
               for _ in range(SSD_TIMED_STEPS)]
    batches = [(mx.nd.array(x, ctx=dev), mx.nd.array(lab, ctx=dev))
               for x, lab in batches]
    params = {n: p for n, p in net.collect_params().items()
              if not p._deferred_init}
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 0.002})

    def step(x, lab):
        with mx.autograd.record():
            loss = ssd.ssd_loss(*net(x), lab, B)
        loss.backward()
        trainer.step(B)

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = [cuda_timed(lambda: step(*b)) for b in batches]
    peak_step = torch.cuda.max_memory_allocated(dev)
    device_ms, kernels = device_profile(lambda: step(*batches[0]))
    x, lab = batches[-1][0]._data, batches[-1][1]._data
    with torch.no_grad():
        anchors, cls_f, loc_f = net(x)
    if anchors.shape[1] != SSD_ANCHORS:
        fail("ssd_vgg16: %d anchors, want %d" % (anchors.shape[1],
                                                  SSD_ANCHORS))
    target_attrs = {"negative_mining_ratio": 3.0,
                    "negative_mining_thresh": 0.5}
    cls_t = cls_f.transpose(1, 2)
    probs = torch.softmax(cls_t, dim=1)
    det_attrs = {"nms_threshold": SSD_NMS, "threshold": 0.01,
                 "nms_topk": 100}
    cand = contrib_ops.detection_candidates(det_attrs, probs, loc_f, anchors)
    boxes_s, _, cls_s, valid_s = cand
    sup = contrib_ops.nms_mask(boxes_s, cls_s, SSD_NMS)

    def timed(fn):
        with torch.no_grad():
            return time_ms(fn, reps=5, calls=2)

    parts = {
        "trunk_ms": timed(lambda: net._pyramid(x)),
        "forward_ms": timed(lambda: net(x)),
        "multibox_target_ms": timed(lambda: get_op(
            "_contrib_MultiBoxTarget").fcompute(target_attrs, anchors, lab,
                                                cls_t)),
        "multibox_detection_ms": timed(lambda: get_op(
            "_contrib_MultiBoxDetection").fcompute(det_attrs, probs, loc_f,
                                                   anchors)),
        "detection_candidates_ms": timed(
            lambda: contrib_ops.detection_candidates(det_attrs, probs, loc_f,
                                                     anchors)),
        "detection_mask_ms": timed(
            lambda: contrib_ops.nms_mask(boxes_s, cls_s, SSD_NMS)),
    }
    parts["heads_ms"] = parts["forward_ms"] - parts["trunk_ms"]
    med = median_of(step_ms)
    phase("ssd_vgg16", classes=SSD_ARGS["num_classes"], side=side, batch=B,
          anchors=int(anchors.shape[1]), epochs=SSD_EPOCHS, iters=SSD_ITERS,
          epoch_loss=json.dumps([round(v, 4) for v in losses]),
          map_before=round(out["map_before"], 4),
          map_after=round(out["map_after"], 4), kept=out["kept"],
          greedy_nms_launches=launches, main_s=round(main_s, 2),
          peak_mem_main_gib=round(peak_main / 2 ** 30, 3),
          step_ms=round(med, 3), images_s=round(B / med * 1e3, 1),
          step_ms_all=json.dumps([round(v, 2) for v in step_ms]),
          step_device_ms=round(device_ms, 3),
          kernels_a_step=sum(kernels.values()),
          peak_mem_step_gib=round(peak_step / 2 ** 30, 3),
          **{k: round(v, 3) for k, v in parts.items()},
          card='"%s"' % card)
    numbers = nms_against_plain(nms_ops, sup, valid_s, "ssd", card)
    phase("ssd_vgg16_scan", scan_ms=round(numbers["ms"], 4),
          detection_mask_ms=round(parts["detection_mask_ms"], 3),
          multibox_detection_ms=round(parts["multibox_detection_ms"], 3))
    del sup, net, trainer, params, batches
    torch.cuda.empty_cache()
    return launches, numbers


def rcnn_example(dev, card, nms_ops):
    """Phase ``rcnn_example``: ``models/rcnn.py``'s ``main`` at the
    example's widths, 2 epochs.  Gates: the loss falls, main finishes."""
    from mxnet_tpu_torch.models import rcnn

    nms_ops.greedy_nms.launches = 0
    t0 = time.time()
    out = rcnn.main(["--device", str(dev)])
    torch.cuda.synchronize()
    launches = nms_ops.greedy_nms.launches
    losses = out["epoch_loss"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("rcnn_example: the loss did not fall: %s" % losses)
    phase("rcnn_example", epoch_loss=json.dumps([round(v, 4)
                                                 for v in losses]),
          vote_accuracy=out["vote_accuracy"], map_03=round(out["map"], 4),
          greedy_nms_launches=launches, seconds=round(time.time() - t0, 2),
          card='"%s"' % card)
    return launches


def rcnn_ops_full(dev, card, nms_ops):
    """Phase ``rcnn_ops_full``: ``_contrib_Proposal`` at Faster R-CNN's
    test-time widths (1 x 18 x 37 x 62 scores, 9 anchors, 20,646 boxes,
    top 6,000 into NMS 0.7, 300 out, min size 16), then ``ROIPooling`` and
    ``_contrib_ROIAlign`` 7 x 7 at 1/16 over a 1 x 512 x 37 x 62 map with
    its rois.  Held against the CPU's plain path on the same inputs: the
    candidate boxes within ROIS_ATOL; the suppression masks equal but
    where an IoU lies within IOU_TIE of the threshold (counted); the
    card's keeps equal to the plain scan of the card's mask, and to the
    CPU's own keeps where the masks agree; the card's rois within
    ROIS_ATOL of the CPU's boxes selected by the card's keeps; the ROI
    ops on all the rois equal to the CPU's.  Then the scan on the card's
    mask against its plain loop."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import contrib_ops
    from mxnet_tpu_torch.ops.registry import get_op as get

    rng = np.random.RandomState(18)
    C, H, W = RCNN_MAP
    A = len(PROPOSAL_FULL["scales"]) * len(PROPOSAL_FULL["ratios"])
    arrays = [rng.uniform(size=(1, 2 * A, H, W)).astype(np.float32),
              (rng.randn(1, 4 * A, H, W) * 0.2).astype(np.float32),
              np.array([RCNN_IM_INFO], np.float32)]
    feat = np.maximum(rng.randn(1, C, H, W), 0).astype(np.float32)

    def proposal(device):
        score, deltas, info = (mx.nd.array(a, ctx=device) for a in arrays)
        return mx.nd._contrib_Proposal(score, deltas, info, **PROPOSAL_FULL)

    nms_ops.greedy_nms.launches = 0
    rois = proposal(dev)
    fmap = mx.nd.array(feat, ctx=dev)
    pooled = mx.nd.ROIPooling(fmap, rois, **ROI_FULL)
    aligned = mx.nd._contrib_ROIAlign(fmap, rois, **ROI_FULL)
    torch.cuda.synchronize()
    launches = nms_ops.greedy_nms.launches
    if launches < 1:
        fail("rcnn_ops_full: greedy_nms launched %d times" % launches)
    rois_cpu = proposal("cpu")
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    fmap = torch.from_numpy(feat).to(dev)
    times = {
        "proposal_ms": time_ms(lambda: get("_contrib_Proposal").fcompute(
            PROPOSAL_FULL, *tensors), reps=5, calls=2),
        "roi_pooling_ms": time_ms(lambda: get("ROIPooling").fcompute(
            ROI_FULL, fmap, rois._data), reps=5, calls=2),
        "roi_align_ms": time_ms(lambda: get("_contrib_ROIAlign").fcompute(
            ROI_FULL, fmap, rois._data), reps=5, calls=2)}
    # the candidates and the masks, card against CPU
    boxes, _ = contrib_ops.proposal_candidates(PROPOSAL_FULL, *tensors)
    boxes_cpu, scores_cpu = contrib_ops.proposal_candidates(
        PROPOSAL_FULL, *(torch.from_numpy(a) for a in arrays))
    box_err = float((boxes.cpu() - boxes_cpu).abs().max())
    thresh = PROPOSAL_FULL["threshold"]
    sup = contrib_ops.proposal_mask(boxes, thresh)
    sup_cpu = contrib_ops.proposal_mask(boxes_cpu, thresh)
    differ = (sup.cpu() != sup_cpu).nonzero()
    ties = 0
    if len(differ):
        b = boxes_cpu.double()[0]
        j, i = differ[:, 1], differ[:, 2]
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        iw = (torch.minimum(b[j, 2], b[i, 2]) - torch.maximum(
            b[j, 0], b[i, 0]) + 1).clamp_min(0)
        ih = (torch.minimum(b[j, 3], b[i, 3]) - torch.maximum(
            b[j, 1], b[i, 1]) + 1).clamp_min(0)
        iou = iw * ih / (area[j] + area[i] - iw * ih)
        ties = int(((iou - thresh).abs() < IOU_TIE).sum())
        if ties != len(differ):
            fail("rcnn_ops_full: %d mask entries differ card vs CPU, %d of "
                 "them away from the threshold" % (len(differ),
                                                    len(differ) - ties))
    if box_err > ROIS_ATOL:
        fail("rcnn_ops_full: candidate boxes %.3g px from the CPU's (bound "
             "%g)" % (box_err, ROIS_ATOL))
    init = torch.ones(sup.shape[:2], dtype=torch.bool, device=dev)
    keep = nms_ops.greedy_nms(sup, init).cpu()
    # the card's keeps are the scan of the card's mask, wherever the masks
    # differ; they differ from the CPU's own only through a tied entry
    scanned = int((keep != nms_ops.greedy_nms(sup.cpu(), init.cpu())).sum())
    keep_cpu = nms_ops.greedy_nms(sup_cpu, init.cpu())
    keep_diff = int((keep != keep_cpu).sum())
    # the card's rois against the CPU's boxes selected by the card's keeps
    # (the CPU's own rois, when no tie moved a keep)
    want, _ = contrib_ops.proposal_select(PROPOSAL_FULL, boxes_cpu,
                                          scores_cpu, keep)
    rois_err = float((rois._data.cpu() - want).abs().max())
    own_err = float(np.abs(rois.asnumpy() - rois_cpu.asnumpy()).max())
    if (scanned or (keep_diff and not len(differ)) or rois_err > ROIS_ATOL
            or (not keep_diff and own_err > ROIS_ATOL)):
        fail("rcnn_ops_full: card vs CPU keep %d differ from the scan of "
             "the card's mask, %d from the CPU's (%d tied mask entries), "
             "rois %.3g / %.3g px (bound %g)" % (
                 scanned, keep_diff, len(differ), rois_err, own_err,
                 ROIS_ATOL))
    # the ROI ops on the same rois, all of them, ROI_CHUNK at a time on the
    # CPU
    with torch.no_grad():
        rois_host = rois._data.cpu()
        feat_host = torch.from_numpy(feat)
        pool_err = align_err = 0.0
        for lo in range(0, len(rois_host), ROI_CHUNK):
            part = rois_host[lo:lo + ROI_CHUNK]
            pool_err = max(pool_err, float((get("ROIPooling").fcompute(
                ROI_FULL, feat_host, part)
                - pooled._data[lo:lo + ROI_CHUNK].cpu()).abs().max()))
            align_err = max(align_err, float((get(
                "_contrib_ROIAlign").fcompute(ROI_FULL, feat_host, part)
                - aligned._data[lo:lo + ROI_CHUNK].cpu()).abs().max()))
    if not (pool_err <= 1e-5 and align_err <= 1e-5):
        fail("rcnn_ops_full: ROI ops card vs CPU %.3g / %.3g over 1e-5"
             % (pool_err, align_err))
    phase("rcnn_ops_full", boxes=H * W * A,
          pre_nms=PROPOSAL_FULL["rpn_pre_nms_top_n"],
          post_nms=PROPOSAL_FULL["rpn_post_nms_top_n"],
          rois=tuple(rois.shape), pooled=tuple(pooled.shape),
          greedy_nms_launches=launches,
          **{k: round(v, 3) for k, v in times.items()},
          candidate_box_err_px=box_err, rois_err_px=rois_err,
          rois_vs_cpu_own_px=own_err, mask_entries_differ=len(differ),
          iou_ties=ties, keep_differ=keep_diff, keep_vs_scan=scanned, roi_pooling_err=pool_err,
          roi_align_err=align_err, card='"%s"' % card)
    numbers = nms_against_plain(nms_ops, sup, init, "proposal", card)
    return launches, numbers


def detection_cases():
    """(name, inputs, attrs, grads, tol) of each of the 17 names, at
    tests/test_torch_detection_ops.py's shapes and bounds."""
    rng = np.random.RandomState(18)

    def f(*shape, low=-1.0, high=1.0):
        return rng.uniform(low, high, shape).astype(np.float32)

    def boxes(n, min_size=0.05):
        a = rng.uniform(0, 1 - min_size, (n, 2))
        b = np.minimum(a + rng.uniform(min_size, 0.5, (n, 2)), 1)
        return np.concatenate([a, b], axis=1).astype(np.float32)

    def rois(R, N, side):
        b = rng.randint(0, N, (R, 1)).astype(np.float32)
        xy = rng.uniform(-2, side - 3, (R, 2))
        return np.concatenate([b, xy, xy + rng.uniform(1.5, side / 2, (
            R, 2))], axis=1).astype(np.float32)

    nn_tol, exact = (1e-4, 1e-5), (0.0, 0.0)
    anchors = (np.array([[0, 0, 4, 4], [0, 0, 4, 2], [0, 0, 2, 4],
                         [1, 1, 5, 5], [4, 4, 8, 8], [4, 4, 8, 6],
                         [6, 6, 8, 8], [2, 0, 6, 4]], np.float32) / 8)[None]
    probs = rng.uniform(0.05, 1.0, (2, 4, 8)).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    labels = np.full((3, 4, 5), -1.0, np.float32)
    labels[0, :2, 0], labels[0, :2, 1:] = [1, 2], boxes(2, 0.2)
    labels[1, :, 0], labels[1, :, 1:] = [0, 1, 2, 0], boxes(4, 0.2)
    mb_anchors = boxes(12)[None]
    nms_rows = np.concatenate([rng.randint(0, 2, (2, 6, 1)),
                               np.round(rng.uniform(0, 1, (2, 6, 1)), 1),
                               boxes(12).reshape(2, 6, 4)], axis=2)
    cls = rng.uniform(size=(2, 6, 4, 5)).astype(np.float32)
    bbox = (rng.randn(2, 12, 4, 5) * 0.1).astype(np.float32)
    im_info = np.array([[64.0, 80.0, 1.0], [48.0, 64.0, 1.5]], np.float32)
    prop = {"rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
            "threshold": 0.6, "rpn_min_size": 4, "feature_stride": 16,
            "scales": (1.0, 2.0, 4.0), "ratios": (1.0,)}
    data, r = f(2, 3, 8, 9), rois(5, 2, 12)
    ps_data, ps_rois = f(2, 18, 8, 8), rois(4, 2, 14)
    theta = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.1],
                      [1.2, -0.2, 0.1, 0.3, 0.8, 0.0]], np.float32)
    return [
        ("_contrib_MultiBoxPrior", [f(2, 3, 5, 4)],
         {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5)}, [], nn_tol),
        ("_contrib_box_iou", [boxes(4), boxes(3)], {}, [], nn_tol),
        ("_contrib_MultiBoxTarget", [mb_anchors, labels, f(3, 4, 12)],
         {"negative_mining_ratio": 3.0}, [], nn_tol),
        ("_contrib_MultiBoxDetection",
         [probs, np.zeros((2, 32), np.float32), anchors],
         {"nms_threshold": 0.45}, [], nn_tol),
        ("_contrib_box_nms", [nms_rows.astype(np.float32)],
         {"overlap_thresh": 0.5}, [], exact),
        ("ROIPooling", [data, r], {"pooled_size": (2, 3),
                                   "spatial_scale": 0.5}, [0], nn_tol),
        ("_contrib_ROIAlign", [data, r], {"pooled_size": (2, 2),
                                          "spatial_scale": 0.5}, [0, 1],
         nn_tol),
        ("_contrib_PSROIPooling", [ps_data, ps_rois],
         {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3}, [0],
         nn_tol),
        ("_contrib_DeformablePSROIPooling",
         [ps_data, ps_rois, f(4, 4, 2, 2, low=-0.5, high=0.5)],
         {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
          "pooled_size": 3, "part_size": 2, "sample_per_part": 2,
          "trans_std": 0.1}, [0, 2], nn_tol),
        ("_contrib_DeformableConvolution",
         [f(2, 4, 7, 7), f(2, 36, 3, 4, low=-1.5, high=1.5), f(6, 2, 3, 3),
          f(6)], {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                  "dilate": (2, 1), "num_filter": 6, "num_group": 2,
                  "num_deformable_group": 2}, [0, 1, 2, 3], nn_tol),
        ("_contrib_Proposal", [cls, bbox, im_info],
         dict(prop, output_score=True), [], (1e-4, 1e-3)),
        ("_contrib_MultiProposal", [cls, bbox, im_info], prop, [],
         (1e-4, 1e-3)),
        ("_contrib_bipartite_matching", [np.round(f(2, 3, 4, low=0), 1)],
         {"threshold": 0.3}, [], exact),
        ("Correlation", [f(2, 2, 6, 7), f(2, 2, 6, 7)],
         {"kernel_size": 3, "max_displacement": 2, "stride1": 2,
          "stride2": 2, "pad_size": 2, "is_multiply": False}, [0, 1],
         nn_tol),
        ("GridGenerator", [theta], {"transform_type": "affine",
                                    "target_shape": (4, 5)}, [0], nn_tol),
        ("BilinearSampler", [data, f(2, 2, 4, 4, low=-1.2, high=1.2)], {},
         [0, 1], nn_tol),
        ("SpatialTransformer", [data, theta], {"target_shape": (4, 4)},
         [0, 1], nn_tol),
    ]


def detection_ops_vs_cpu(dev):
    """Phase ``detection_ops_vs_cpu``: each of the 17 names through
    ``mx.nd`` on the card against the CPU, values and input gradients
    (seeded head gradients) within the CPU tests' bounds."""
    from mxnet_tpu_torch.ops.registry import get_op

    worst, seen = {}, set()
    for seed, (name, inputs, attrs, grads, tol) in enumerate(
            detection_cases()):
        seen.add(name)
        want = nd_run(name, inputs, dict(attrs), grads, "cpu", seed)
        got = nd_run(name, inputs, dict(attrs), grads, dev, seed)
        for k, (g, w) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
            err = float(np.max(np.abs(g - w), initial=0.0))
            worst[name] = max(worst.get(name, 0.0), err)
            if g.shape != w.shape or not np.allclose(g, w, rtol=tol[0],
                                                     atol=tol[1]):
                fail("detection_ops_vs_cpu %s array %d: card vs CPU max "
                     "abs err %.3g over rtol %g atol %g"
                     % (name, k, err, *tol))
    missing = {get_op(n) for n in DETECTION_OPS} - {get_op(n) for n in seen}
    if missing:
        fail("detection_ops_vs_cpu covers no case of %s" % sorted(
            op.name for op in missing))
    phase("detection_ops_vs_cpu", names=len(seen),
          worst_abs_err=json.dumps(sorted(
              worst.items(), key=lambda kv: -kv[1])[:6]))


def detection_phases(cuda_ops, dev, card):
    """The detection slice: ``ssd_vgg16``, ``rcnn_example``,
    ``rcnn_ops_full`` and ``detection_ops_vs_cpu``.  Returns the scan
    kernel's launches by path and its numbers at the SSD's and Proposal's
    sizes; flash_attention must launch 0 times here
    (``launches_detection``)."""
    from mxnet_tpu_torch.ops import nms_ops

    seconds = {}
    reset_launches(cuda_ops)
    t0 = time.time()
    ssd_launches, ssd_numbers = ssd_vgg16(dev, card, nms_ops)
    seconds["ssd_vgg16"] = round(time.time() - t0, 2)
    t0 = time.time()
    example_launches = rcnn_example(dev, card, nms_ops)
    seconds["rcnn_example"] = round(time.time() - t0, 2)
    t0 = time.time()
    ops_launches, proposal_numbers = rcnn_ops_full(dev, card, nms_ops)
    seconds["rcnn_ops_full"] = round(time.time() - t0, 2)
    t0 = time.time()
    detection_ops_vs_cpu(dev)
    seconds["detection_ops_vs_cpu"] = round(time.time() - t0, 2)
    phase("detection_seconds", **seconds)
    launches = cuda_ops.flash_attention.launches
    phase("launches_detection", flash_attention=launches,
          greedy_nms_ssd=ssd_launches, greedy_nms_rcnn_example=example_launches,
          greedy_nms_rcnn_ops=ops_launches)
    if launches:
        fail("the detection phases launched flash_attention %d times"
             % launches)
    return launches, {
        "launches": ssd_launches + example_launches + ops_launches,
        "launches_ssd": ssd_launches,
        "launches_rcnn_example": example_launches,
        "launches_rcnn_ops": ops_launches,
        "ssd": ssd_numbers, "proposal": proposal_numbers}


def main():
    t0 = time.time()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import cuda_ops

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name='"%s"' % name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          cudnn_benchmark=torch.backends.cudnn.benchmark,
          matmul_allow_bf16_reduced_precision_reduction=torch.backends.cuda.
          matmul.allow_bf16_reduced_precision_reduction)
    print(smi, flush=True)

    build_report(_kernels)

    numbers = check_kernel(cuda_ops, dev)
    numbers.update(kernel_grad(cuda_ops, dev))
    launches_serve = serve(cuda_ops, dev, smi)
    launches_train, state, train_losses = train(cuda_ops, dev, smi)
    train_profile(*state, smi)
    del state
    launches_hybrid = hybrid_lm_train(cuda_ops, dev, smi)
    train_vs_cpu(cuda_ops, dev)
    launches_train_bf16, state, _ = train(cuda_ops, dev, smi, bf16=True)
    train_profile(*state, smi, label="lm_bf16_profile")
    del state
    lm_bf16_vs_cpu(cuda_ops, dev)

    card_lm = seeded_init(dev, smi)
    launches_functional = lm_functional(cuda_ops, dev, card_lm)
    del card_lm

    resnet_model(dev, smi)
    reset_launches(cuda_ops)
    states = resnet_train(dev, smi)
    resnet_profile(*states["NCHW"], smi)
    del states
    hybrid_resnet_train(dev, smi)
    resnet_vs_cpu(dev)
    functional_step(dev, smi)
    compiled_step(dev, smi)
    functional_vs_gluon(dev)
    functional_vs_cpu(dev)
    states = resnet_train(dev, smi, "bfloat16")
    for layout, state in states.items():
        resnet_profile(*state, smi, label="resnet_bf16_profile",
                       layout=layout)
    del states, state
    hybrid_resnet_train(dev, smi, "bfloat16")
    resnet_bf16_mp(dev, smi)
    resnet_bf16_vs_cpu(dev)
    if cuda_ops.flash_attention.launches:
        fail("the ResNet path launched flash_attention %d times"
             % cuda_ops.flash_attention.launches)

    nd_ops(dev)
    launches_nd = nd_lm(cuda_ops, dev, smi, train_losses)
    nd_lm_vs_cpu(cuda_ops, dev)
    reset_launches(cuda_ops)
    module_fit(dev, smi)
    if cuda_ops.flash_attention.launches:
        fail("module_fit launched flash_attention")

    launches_decode = decode_phases(cuda_ops, dev, smi)
    launches_exported = exported_phases(cuda_ops, dev, smi)
    launches_fleet = serving_tier_phases(cuda_ops, dev, smi)
    launches_word_lm = random_zoo_phases(cuda_ops, dev, smi)
    launches_optim = optim_resume_phases(cuda_ops, dev, smi)
    launches_int8 = int8_phases(cuda_ops, dev, smi)
    launches_input = input_phases(cuda_ops, dev, smi)
    launches_rnn = rnn_phases(cuda_ops, dev, smi)
    launches_detection, nms = detection_phases(cuda_ops, dev, smi)

    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
              "replaces": "mxnet_tpu/ops/pallas_ops.py:54",
              "launches": launches_serve + launches_train
              + launches_train_bf16 + launches_nd + launches_functional
              + launches_hybrid + launches_exported + launches_fleet
              + launches_word_lm + launches_optim + launches_int8
              + launches_input + launches_rnn + launches_detection,
              "launches_serve": launches_serve,
              "launches_train": launches_train,
              "launches_hybrid_train": launches_hybrid,
              "launches_train_bf16": launches_train_bf16,
              "launches_nd": launches_nd,
              "launches_functional": launches_functional,
              "launches_decode": launches_decode,
              "launches_exported": launches_exported,
              "launches_fleet": launches_fleet,
              "launches_word_lm": launches_word_lm,
              "launches_optim": launches_optim,
              "launches_int8": launches_int8,
              "launches_input": launches_input,
              "launches_rnn": launches_rnn,
              "launches_detection": launches_detection}
    kernel.update(numbers)
    ssd_nms, prop_nms = nms["ssd"], nms["proposal"]
    scan = {"name": "greedy_nms", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/greedy_nms.cu",
            # no Pallas kernel: the lax.fori_loop NMS scans of
            # _contrib_MultiBoxDetection (:253), _contrib_box_nms (:298)
            # and _contrib_Proposal (:515)
            "replaces": "mxnet_tpu/ops/contrib_ops.py:253",
            "replaces_also": ["mxnet_tpu/ops/contrib_ops.py:298",
                              "mxnet_tpu/ops/contrib_ops.py:515"],
            "launches": nms["launches"],
            "launches_ssd": nms["launches_ssd"],
            "launches_rcnn_example": nms["launches_rcnn_example"],
            "launches_rcnn_ops": nms["launches_rcnn_ops"],
            # keep decisions that differ from the plain loop (bit-equal: 0)
            "max_abs_err": max(ssd_nms["mismatches"],
                               prop_nms["mismatches"]),
            "shape": [ssd_nms["B"], ssd_nms["K"]],
            "ms": ssd_nms["ms"], "plain_ms": ssd_nms["plain_ms"],
            "bound_ms": ssd_nms["bound_ms"], "bound_by": "bytes",
            "pack_read_ms": ssd_nms["pack_read_ms"],
            "library_ms": None,
            "shape_proposal": [prop_nms["B"], prop_nms["K"]],
            "ms_proposal": prop_nms["ms"],
            "plain_ms_proposal": prop_nms["plain_ms"],
            "bound_ms_proposal": prop_nms["bound_ms"]}
    phase("total", seconds=time.time() - t0)
    print(json.dumps({"kernels": [kernel, scan]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
