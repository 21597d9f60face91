"""Train an image classifier (counterpart of
``example/image-classification/common.py``: ``add_fit_args``,
``get_synthetic_iter`` and ``fit_gluon``, :16-91; and of
``train_imagenet.py`` ``main`` run with ``--fused-step 0``).

The Gluon loop: a model-zoo network, Xavier weights, ``gluon.Trainer``
(SGD, momentum 0.9, weight decay 1e-4 by default), ``autograd.record()``,
``SoftmaxCrossEntropyLoss``, ``loss.backward()``, ``trainer.step(batch)``
and ``metric.Accuracy``, on the card by default:

    python -m mxnet_tpu_torch.models.image_classification \\
        --network resnet50_v1 --batch-size 32 --num-epochs 1 \\
        --dtype bfloat16
    python -m mxnet_tpu_torch.models.image_classification --device cpu \\
        --network resnet18_v1 --num-classes 10 --image-shape 3,32,32

The data is the example's synthetic set: max(10 x batch, 320) images drawn
by ``RandomState(0)``, uniform in [-1, 1), with random labels, all float32.
It is made once and kept on the device.  The JAX iterator shuffles it with
the JAX package's own RNG stream, which waits for the port of
``random.py``; this loop takes the batches in order (a last, partial batch
is padded from the start, as ``NDArrayIter``'s default ``pad`` does).

``--dtype bfloat16`` casts the initialized network to bf16 before the
Trainer is built (BatchNorm included: the JAX ``BatchNorm.cast`` keeps
fp32 only for float16) and each batch's data before its forward; the
labels stay fp32.  SGD then updates the bf16 weights directly, with bf16
momentum: the example leaves ``multi_precision`` at False.
Not ported yet: ``--data-train`` (``ImageRecordIter``), the fused step
(``--fused-step 1``), ``net.hybridize()`` (CachedOp) and
``--model-prefix`` (``export``).
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from .. import autograd, initializer
from ..base import as_dtype
from ..context import resolve_device
from ..gluon import Trainer
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo import vision
from ..metric import Accuracy

__all__ = ["add_fit_args", "get_synthetic_iter", "train_step", "fit_gluon",
           "main"]


def add_fit_args(parser):
    """The example's options that :func:`fit_gluon` reads."""
    parser.add_argument("--network", type=str, default="resnet50_v1")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--optimizer", type=str, default="sgd")
    parser.add_argument("--mom", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--kv-store", type=str, default="device",
                        help="device|local (one card; dist is not ported)")
    parser.add_argument("--disp-batches", type=int, default=20)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    return parser


def get_synthetic_iter(args, image_shape=(3, 224, 224), device=None):
    """The example's synthetic set as a list of (data, label) batches on
    ``device``, in order; float32 data of ``image_shape``, float32
    labels."""
    n = max(args.batch_size * 10, 320)
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (n,) + tuple(image_shape)).astype(np.float32)
    Y = rng.randint(0, args.num_classes, n).astype(np.float32)
    device = resolve_device(device)
    X, Y = torch.from_numpy(X).to(device), torch.from_numpy(Y).to(device)
    B = args.batch_size
    batches = []
    for start in range(0, n, B):
        if start + B <= n:
            batches.append((X[start:start + B], Y[start:start + B]))
        else:
            idx = torch.arange(start, start + B, device=device) % n
            batches.append((X[idx], Y[idx]))
    return batches


def train_step(net, trainer, loss_fn, metric, x, y, batch_size):
    """One step of :func:`fit_gluon`'s loop; returns the per-sample loss.
    ``backward`` seeds the per-sample loss with ones, as Gluon's head
    gradient does, and ``step(batch_size)`` scales the update by
    1/batch_size."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward(torch.ones_like(loss))
    trainer.step(batch_size)
    metric.update([y], [out])
    return loss


def fit_gluon(args, net, train_iter):
    """Initialize ``net`` (Xavier, from a seeded generator) and cast it to
    ``args.dtype``, then train it ``args.num_epochs`` epochs over
    ``train_iter``'s (data, label) batches, each batch's data cast to
    ``args.dtype``; logs speed and accuracy every ``args.disp_batches``
    batches and at each epoch's end.  Returns ``net``."""
    initializer.initialize(net, initializer.Xavier(),
                           generator=torch.Generator().manual_seed(0))
    dtype = as_dtype(args.dtype)
    net.cast(dtype)
    trainer = Trainer(net.named_parameters(), args.optimizer,
                      {"learning_rate": args.lr, "momentum": args.mom,
                       "wd": args.wd}, kvstore=args.kv_store)
    loss_fn = SoftmaxCrossEntropyLoss()
    metric = Accuracy()
    for epoch in range(args.num_epochs):
        metric.reset()
        tic = time.time()
        nsamples = 0
        for i, (x, y) in enumerate(train_iter):
            train_step(net, trainer, loss_fn, metric, x.to(dtype), y,
                       args.batch_size)
            nsamples += args.batch_size
            if (i + 1) % args.disp_batches == 0:
                name, acc = metric.get()
                logging.info("Epoch[%d] Batch [%d] Speed: %.2f samples/sec "
                             "%s=%f", epoch, i + 1,
                             nsamples / (time.time() - tic), name, acc)
        name, acc = metric.get()
        logging.info("Epoch[%d] done in %.1fs %s=%f", epoch,
                     time.time() - tic, name, acc)
    return net


def main(argv=None):
    parser = add_fit_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    parser.add_argument("--image-shape", type=str, default="3,224,224")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    net = vision.get_model(args.network, classes=args.num_classes,
                           device=device)
    train_iter = get_synthetic_iter(args, image_shape, device)
    return fit_gluon(args, net, train_iter)


if __name__ == "__main__":
    main(sys.argv[1:])
