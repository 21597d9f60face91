"""Inference throughput of the vision zoo (counterpart of
``example/image-classification/benchmark_score.py``, the source of the
fp32 inference table in ``BASELINE.md``).

:func:`score` builds a zoo network (Xavier weights, one call to fill its
shapes), takes its parameters as values (``param_values``, cast to
``dtype``) and runs its inference forward as a pure function of them,
``functional_call(net, params, x)``, through one ``CachedOp``: on the card
the forward is captured into a CUDA graph at the first call and replayed
after that, as the reference compiles it once under ``jax.jit``.  It
times ``iters`` replays between two synchronizations and returns images
per second.

    python -m mxnet_tpu_torch.models.benchmark_score --networks vgg16 \\
        --batch-sizes 32
    python -m mxnet_tpu_torch.models.benchmark_score --networks alexnet \\
        --batch-sizes 1 --device cpu
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from .. import initializer
from ..base import as_dtype
from ..cached_op import CachedOp
from ..context import resolve_device
from ..gluon.block import functional_call, param_values
from ..gluon.model_zoo import vision

__all__ = ["build", "score", "timed"]


def build(network, batch_size, image_shape=(3, 224, 224), dtype="float32",
          device=None, seed=0):
    """``(net, op, params, x)``: the network ``network`` on ``device``, a
    ``CachedOp`` over its inference forward as a function of ``params``
    (its values in ``dtype``), and a seeded batch ``x``."""
    device = resolve_device(device)
    net = vision.get_model(network, classes=1000, device=device)
    net.initialize(initializer.Xavier())
    with torch.no_grad():
        net(torch.zeros((1,) + tuple(image_shape), device=device))
    tdtype = as_dtype(dtype)
    if tdtype == torch.float16:
        tdtype = torch.bfloat16
    params = param_values(net, tdtype)

    def forward(p, x):
        outs, _ = functional_call(net, p, x, training=False)
        return outs[0]

    op = CachedOp(forward, params)
    x = np.random.RandomState(seed).uniform(
        -1, 1, (batch_size,) + tuple(image_shape)).astype(np.float32)
    x = torch.from_numpy(x).to(device=device, dtype=tdtype)
    return net, op, params, x


def score(network, batch_size, image_shape=(3, 224, 224), dtype="float32",
          iters=20, device=None):
    """Images per second of ``network``'s inference forward at
    ``batch_size``, timed over ``iters`` calls after a first one (the
    capture)."""
    _, op, params, x = build(network, batch_size, image_shape, dtype, device)
    with torch.no_grad():
        op(params, x)
    return timed(op, params, x, iters)


def timed(op, params, x, iters=20):
    """Images per second of ``iters`` calls of ``op(params, x)``, timed
    between two synchronizations of ``x``'s device."""
    with torch.no_grad():
        _sync(x.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            op(params, x)
        _sync(x.device)
    return x.shape[0] * iters / (time.perf_counter() - t0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--networks", type=str, default="resnet50_v1")
    parser.add_argument("--batch-sizes", type=str, default="1,32")
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    speeds = {}
    for net_name in args.networks.split(","):
        for bs in (int(b) for b in args.batch_sizes.split(",")):
            speed = score(net_name, bs, dtype=args.dtype, iters=args.iters,
                          device=args.device)
            speeds[net_name, bs] = speed
            logging.info("network: %s batch: %d dtype: %s images/sec: %.2f",
                         net_name, bs, args.dtype, speed)
    return speeds


if __name__ == "__main__":
    main(sys.argv[1:])
