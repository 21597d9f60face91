"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc/``, holds each
against its plain PyTorch version on the card (forward, and the gradient
the training path takes through it), then drives the full-width
TransformerLM (vocab 32768, dim 768, 12 layers, 12 heads, T up to 1024;
random weights from a seed) down both of the port's paths: served through
``serving.ModelServer``, and trained with ``gluon.Trainer`` and Adam.  Each
path must go through the kernel and agree with the same model on the CPU.

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

# published peaks by card (NVIDIA data sheets, dense): fp32 on CUDA cores
# and TF32 on tensor cores in FLOP/s, memory bandwidth in bytes/s
PEAKS = {"H100 PCIe": (51.2e12, 378e12, 2.0e12),
         "H100 NVL": (60e12, 417.5e12, 3.9e12),
         "H100": (67e12, 495e12, 3.35e12)}
TIMED_CALLS = 10   # back-to-back calls between one pair of CUDA events
BQ, BK = 64, 64    # the kernel's query rows a block and keys a K/V tile


def phase(label, **fields):
    print("[%s] %s" % (label, " ".join("%s=%s" % kv for kv in fields.items())),
          flush=True)


def fail(msg):
    print("FAIL: %s" % msg, flush=True)
    sys.exit(1)


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
    if not bf16_err < BF16_BOUND:
        fail("kernel bf16 err %.3g >= %g" % (bf16_err, BF16_BOUND))
    phase("kernel_bf16", shape=(B, H, T, D), max_abs_err=bf16_err,
          bound=BF16_BOUND)

    # time at the full served shape, fp32 causal
    q, k, v = (randn(B, H, T, D) for _ in range(3))
    ms = time_ms(lambda: cuda_ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: cuda_ops._attention_reference(
        q, k, v, True, D ** -0.5))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v, is_causal=True))
    fp32_peak, tf32_peak, bytes_peak = card_peaks(
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
    # the other staging path at the same shape: bf16, loads widened by the
    # threads
    ms_bf16 = time_ms(lambda: cuda_ops.flash_attention(qb, kb, vb,
                                                       causal=True))
    phase("kernel_time_staging", shape=(B, H, T, D),
          calls_per_timing=TIMED_CALLS, bf16_ms=ms_bf16)
    phase("kernel_time", shape=(B, H, T, D), calls_per_timing=TIMED_CALLS,
          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          bound_cuda_core_ms=cuda_core_ms,
          bound_tensor_core_ms=tensor_core_ms, bytes_ms=bytes_ms,
          bound_ms=bound_ms, bound_by=bound_by)
    return {"max_abs_err": max(worst, serve_err), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_cuda_core_ms": cuda_core_ms,
            "bound_tensor_core_ms": tensor_core_ms, "bytes_ms": bytes_ms}


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
    cuda_ops.flash_attention.launches = 0
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
    launches = cuda_ops.flash_attention.launches - before
    if launches != 2:
        fail("kernel_grad launched the kernel %d times, not 2" % launches)
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
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.models import TransformerLM

    net = TransformerLM(VOCAB, dim=DIM, heads=HEADS, depth=depth,
                        max_len=MAX_LEN, device=dev)
    return initializer.initialize(
        net, initializer.Xavier(),
        generator=torch.Generator().manual_seed(seed))


def train(cuda_ops, dev, card):
    """Phase: the full-width LM takes TRAIN_STEPS Adam steps through
    ``gluon.Trainer`` on ``pattern_batch`` data; every step's forward must
    launch the kernel once a layer.  Step time by CUDA events, median over
    the steps after the first."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    net = new_lm(dev, DEPTH, 0)
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
    cuda_ops.flash_attention.launches = 0
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
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)):
        fail("training losses not finite: %s" % losses)
    if launches != DEPTH * TRAIN_STEPS:
        fail("flash_attention launches %d != %d layers x %d steps"
             % (launches, DEPTH, TRAIN_STEPS))
    median_ms = float(np.median(step_ms[1:]))
    phase("train", batch=(TRAIN_B, MAX_LEN), steps=TRAIN_STEPS,
          losses=json.dumps(losses), launches=launches,
          step_ms=json.dumps(step_ms), median_step_ms=median_ms,
          tokens_per_s=TRAIN_B * MAX_LEN / (median_ms / 1e3),
          peak_memory_gb=peak_gb, card='"%s"' % card)
    return launches, (net, trainer, ce, batches[-1], pos)


def train_profile(net, trainer, ce, batch, pos, card):
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
    phase("train_profile", batch=(TRAIN_B, MAX_LEN), forward_ms=fwd_ms,
          backward_ms=bwd_ms, update_ms=upd_ms,
          step_ms=fwd_ms + bwd_ms + upd_ms,
          device_ms=kernel_ms(lambda k: True),
          flash_fwd_ms=kernel_ms(lambda k: "flash_attention_fwd" in k),
          gemm_ms=kernel_ms(lambda k: "gemm" in k.lower()),
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


def main():
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
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    print(smi, flush=True)

    build_report(_kernels)

    numbers = check_kernel(cuda_ops, dev)
    numbers.update(kernel_grad(cuda_ops, dev))
    launches_serve = serve(cuda_ops, dev, smi)
    launches_train, state = train(cuda_ops, dev, smi)
    train_profile(*state, smi)
    del state
    train_vs_cpu(cuda_ops, dev)

    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
              "replaces": "mxnet_tpu/ops/pallas_ops.py:54",
              "launches": launches_serve + launches_train,
              "launches_serve": launches_serve,
              "launches_train": launches_train}
    kernel.update(numbers)
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
