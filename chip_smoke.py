"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc/``, holds each
against its plain PyTorch version on the card (forward, and the gradient
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

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (``nvcc``); imports no JAX and
nothing of the JAX package.  Prints one line per phase, then a JSON line of
per-kernel numbers, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero without
that line.
"""
from __future__ import annotations

import json
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
    """Phase 1: build the kernel, print ptxas's registers and spills and the
    dynamic shared memory of each instance, and count the tensor-core (HMMA)
    instructions in the library's SASS; fails if there are none."""
    t0 = time.time()
    _kernels.load()
    seconds = round(time.time() - t0, 2)
    instances, name = {}, None
    for line in _kernels.build_log().splitlines():
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


def serve(cuda_ops, dev, card):
    """Phase 3: the full-width LM served through ModelServer on the card."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerLM

    t0 = time.time()
    net = new_lm(dev, DEPTH, 0)
    n_params = sum(p.numel() for p in net.parameters())
    phase("model", params=n_params, build_s=round(time.time() - t0, 2))

    rng = np.random.RandomState(0)
    requests = []   # (tokens, positions): 12 short and 6 long, interleaved
    for i in range(18):
        T = SERVE_LENGTHS[1] if i % 3 == 2 else SERVE_LENGTHS[0]
        requests.append((rng.randint(0, VOCAB, T).astype(np.int32),
                         np.arange(T, dtype=np.int32)))

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
        results = [None] * len(requests)

        def client(worker):
            for i in range(worker, len(requests), 4):
                results[i] = server.predict("lm", requests[i],
                                            timeout_ms=120000)

        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(4)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.time() - t0
        snap = server.stats()["models"]["lm"]
    finally:
        server.stop()
    launches = cuda_ops.flash_attention.launches
    if any(t.is_alive() for t in threads):
        fail("client threads did not finish")
    statuses = [r.status for r in results]
    if statuses.count(serving.OK) != len(requests):
        fail("not every request OK: %s" % [(r.status, r.error)
                                          for r in results])
    for (tok, _), r in zip(requests, results):
        if r.output.shape != (len(tok), VOCAB) or \
                not np.isfinite(r.output).all():
            fail("bad logits %s for T=%d" % (r.output.shape, len(tok)))
    batches = warm["signatures"] + snap["batches"]
    if launches != DEPTH * batches:
        fail("flash_attention launches %d != %d layers x %d batches"
             % (launches, DEPTH, batches))
    lat = sorted(r.latency_ms for r in results)
    tokens = sum(len(tok) for tok, _ in requests)
    phase("serve", requests=len(requests), ok=statuses.count(serving.OK),
          batches=snap["batches"], avg_batch=snap["avg_batch"],
          launches=launches, p50_ms=float(np.percentile(lat, 50)),
          p99_ms=float(np.percentile(lat, 99)), tokens=tokens,
          tokens_per_s=tokens / wall, card='"%s"' % card)

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
                          gnn.Activation)):
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
    ]
    return cases


def nd_run(name, inputs, attrs, grads, device, seed):
    """``nd.<name>`` on ``device``: its outputs and the gradients of the
    inputs at ``grads`` under head gradients drawn from ``seed``, on the
    CPU.  ``_training`` in ``attrs`` records in training mode."""
    import mxnet_tpu_torch as mx

    arrays = [mx.nd.array(a, ctx=device, dtype=a.dtype) for a in inputs]
    for i in grads:
        arrays[i].attach_grad()
    training = attrs.pop("_training", False)
    with mx.autograd.record(train_mode=training):
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
        for k, (g, w) in enumerate(zip(got[0], want[0])):
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
    missing = {n for n in list_ops() if get_op(n) not in seen}
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
    resnet_vs_cpu(dev)
    functional_step(dev, smi)
    functional_vs_gluon(dev)
    functional_vs_cpu(dev)
    states = resnet_train(dev, smi, "bfloat16")
    for layout, state in states.items():
        resnet_profile(*state, smi, label="resnet_bf16_profile",
                       layout=layout)
    del states, state
    resnet_bf16_mp(dev, smi)
    resnet_bf16_vs_cpu(dev)
    if cuda_ops.flash_attention.launches:
        fail("the ResNet path launched flash_attention %d times"
             % cuda_ops.flash_attention.launches)

    nd_ops(dev)
    launches_nd = nd_lm(cuda_ops, dev, smi, train_losses)
    nd_lm_vs_cpu(cuda_ops, dev)

    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
              "replaces": "mxnet_tpu/ops/pallas_ops.py:54",
              "launches": launches_serve + launches_train
              + launches_train_bf16 + launches_nd + launches_functional,
              "launches_serve": launches_serve,
              "launches_train": launches_train,
              "launches_train_bf16": launches_train_bf16,
              "launches_nd": launches_nd,
              "launches_functional": launches_functional}
    kernel.update(numbers)
    phase("total", seconds=time.time() - t0)
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
