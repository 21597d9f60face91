"""Post-training int8 quantization of a small convnet (counterpart of
``example/quantization/quantize_infer.py``).

The same program: train the example's symbolic convnet on its synthetic
channel-coded classes through the Module API, then rewrite it with
``quantize_model`` (calibrated by ``--calib-mode``), run int8 inference
and print the fp32 and int8 accuracies and their top-1 agreement on
held-out batches.  On the card by default; ``--device cpu`` runs on the
CPU.

    python -m mxnet_tpu_torch.models.quantize_infer
    python -m mxnet_tpu_torch.models.quantize_infer --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import io, mod as mod_pkg
from .. import nd, random
from .. import symbol as sym
from ..context import resolve_device
from ..contrib import quantization as q

__all__ = ["synthetic_batch", "build_net", "evaluate", "main"]

NUM_CLASSES = 4
IMG = 16


def synthetic_batch(rng, n):
    """Class = which quadrant of channel 0 carries the bright square."""
    x = rng.uniform(0, 0.2, (n, 3, IMG, IMG)).astype(np.float32)
    y = rng.randint(0, NUM_CLASSES, n)
    half = IMG // 2
    for i, c in enumerate(y):
        r, col = divmod(int(c), 2)
        x[i, 0, r * half:(r + 1) * half, col * half:(col + 1) * half] += 0.8
    return x, y.astype(np.float32)


def build_net():
    data = sym.var("data")
    h = sym.Convolution(data, num_filter=8, kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1), name="conv1")
    h = sym.Activation(h, act_type="relu")
    h = sym.Convolution(h, num_filter=16, kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1), name="conv2")
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, num_hidden=NUM_CLASSES, name="fc1")
    return sym.SoftmaxOutput(h, name="softmax")


def evaluate(run_fp, run_q, batches):
    """Accuracy of both engines and their top-1 agreement, one forward of
    each a batch."""
    fp_ok = q_ok = same = total = 0
    for x, y in batches:
        fp_pred = run_fp(x).argmax(1)
        q_pred = run_q(x).argmax(1)
        fp_ok += (fp_pred == y).sum()
        q_ok += (q_pred == y).sum()
        same += (fp_pred == q_pred).sum()
        total += len(y)
    return fp_ok / total, q_ok / total, same / total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--calib-mode", default="entropy",
                    choices=["minmax", "entropy", "none"])
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    np.random.seed(0)
    random.seed(0)
    rng = np.random.RandomState(0)
    net = build_net()
    xs, ys = zip(*(synthetic_batch(rng, args.batch_size) for _ in range(24)))
    train_iter = io.NDArrayIter(np.concatenate(xs), np.concatenate(ys),
                                args.batch_size, shuffle=True, ctx=device)
    mod = mod_pkg.Module(net, context=device)
    mod.fit(train_iter, num_epoch=args.epochs,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            eval_metric="acc")
    arg_params, aux_params = mod.get_params()

    held = [synthetic_batch(np.random.RandomState(100 + i), 64)
            for i in range(4)]

    fp_exe = net.simple_bind(device, data=(64, 3, IMG, IMG),
                             grad_req="null")
    fp_exe.copy_params_from(arg_params, aux_params)

    def run_fp(x):
        return fp_exe.forward(is_train=False, data=nd.array(
            x, ctx=device))[0].asnumpy()

    if args.calib_mode == "none":
        calib = None
    else:
        cx, cy = zip(*(synthetic_batch(rng, args.batch_size)
                       for _ in range(args.calib_batches)))
        calib = io.NDArrayIter(np.concatenate(cx), np.concatenate(cy),
                               args.batch_size, ctx=device)
    with device:   # the calibration forward binds on the current context
        qsym, qargs, qaux = q.quantize_model(
            net, arg_params, aux_params, calib_data=calib,
            calib_mode=args.calib_mode)
    q_exe = qsym.simple_bind(device, data=(64, 3, IMG, IMG),
                             grad_req="null")
    q_exe.copy_params_from(qargs, qaux)

    def run_q(x):
        return q_exe.forward(is_train=False, data=nd.array(
            x, ctx=device))[0].asnumpy()

    fp_acc, q_acc, agree = evaluate(run_fp, run_q, held)
    print("fp32 accuracy: %.3f  int8 accuracy: %.3f  top-1 agreement: %.3f"
          % (fp_acc, q_acc, agree))
    return fp_acc, q_acc, agree


if __name__ == "__main__":
    main(sys.argv[1:])
