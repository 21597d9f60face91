"""Train LeNet or an MLP on MNIST through the Module API (counterpart of
``example/image-classification/train_mnist.py``).

The same symbols (:18-42), ``Module.fit`` with SGD and Xavier,
``callback.Speedometer`` every 50 batches and, with ``--model-prefix``,
``callback.do_checkpoint`` at each epoch's end.  Without staged MNIST files
it trains on the example's synthetic set (2048 uniform images and random
labels from ``RandomState(0)``, shuffled by ``NDArrayIter``); reading staged
MNIST (``io.MNISTIter``) is not ported yet (ROADMAP queue 1 #12).  On the
card by default; ``--device cpu`` trains on the CPU.  ``--compiled``
chooses ``fit``'s path: ``auto`` (default) the compiled train step, ``0``
the eager loop.

    python -m mxnet_tpu_torch.models.train_mnist --network lenet
    python -m mxnet_tpu_torch.models.train_mnist --device cpu --num-epochs 1

Returns the trained module from :func:`main`, with its final training
accuracy (``Module.score``) as ``last_score``.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from .. import callback, init, io, mod as mod_pkg
from .. import symbol as sym
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["get_mlp", "get_lenet", "get_mnist_iters", "main"]


def get_mlp():
    data = sym.Variable("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = sym.FullyConnected(act2, name="fc3", num_hidden=10)
    return sym.SoftmaxOutput(fc3, name="softmax")


def get_lenet():
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, name="conv1", kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, name="conv2", kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, name="fc1", num_hidden=500)
    tanh3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(tanh3, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def get_mnist_iters(batch_size, data_dir, ctx=None, shuffle=True):
    """(train iterator, None): the example's synthetic digits on ``ctx``
    when no MNIST files are staged under ``data_dir``."""
    img = os.path.join(data_dir, "train-images-idx3-ubyte.gz")
    if os.path.exists(img) or os.path.exists(img[:-3]):
        raise MXNetError("reading staged MNIST (io.MNISTIter) is not ported "
                         "yet (ROADMAP queue 1 #12); move %s aside to train "
                         "on the synthetic set" % data_dir)
    logging.warning("MNIST files not staged under %s; using synthetic data",
                    data_dir)
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (2048, 1, 28, 28)).astype(np.float32)
    Y = rng.randint(0, 10, 2048).astype(np.float32)
    return io.NDArrayIter(X, Y, batch_size=batch_size, shuffle=shuffle,
                          ctx=ctx), None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--network", default="mlp", choices=["mlp", "lenet"])
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--data-dir", default=os.path.join(
        os.path.expanduser("~"), ".mxnet", "datasets", "mnist"))
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda:0 by default; 'cpu' trains on the CPU")
    parser.add_argument("--compiled", default="auto",
                        choices=["auto", "0", "1"],
                        help="fit's path: the compiled train step (auto, "
                             "1) or the eager loop (0)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    net = get_mlp() if args.network == "mlp" else get_lenet()
    train, val = get_mnist_iters(args.batch_size, args.data_dir, ctx=device)
    mod = mod_pkg.Module(net, context=device)
    cb = [callback.Speedometer(args.batch_size, 50)]
    epoch_cb = callback.do_checkpoint(args.model_prefix) \
        if args.model_prefix else None
    mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
            kvstore=args.kv_store, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr},
            initializer=init.Xavier(), batch_end_callback=cb,
            epoch_end_callback=epoch_cb,
            compiled=None if args.compiled == "auto"
            else args.compiled == "1")
    train.reset()
    mod.last_score = mod.score(train, "acc")
    print("final train accuracy:", mod.last_score)
    return mod


if __name__ == "__main__":
    main(sys.argv[1:])
