"""The bucketed LSTM language model (counterpart of
``example/rnn/lstm_bucketing.py``, after MXNet's
``example/rnn/bucketing/lstm_bucketing.py``).

``sym_gen_factory`` builds one symbol a bucket with the legacy ``mx.rnn``
cells: an ``Embedding``, an LSTM stack unrolled over the bucket's length
(``fused=True``: one ``FusedRNNCell``, the ``RNN`` op; ``fused=False``: a
``SequentialRNNCell`` of ``LSTMCell``s, named ``lstm_l{i}_``), a
``FullyConnected`` over the vocabulary and ``SoftmaxOutput``.
``BucketSeqIter`` is the example's synthetic bucketed iterator (random
tokens from ``RandomState(seed)``, the label the sequence shifted by one),
and ``main`` trains through ``BucketingModule.fit`` with Adam at lr 0.01,
``Perplexity(ignore_label=None)`` and Xavier, on the card by default.

The defaults are the example's CPU size; the upstream example's widths
are passed as arguments:

    python -m mxnet_tpu_torch.models.lstm_bucketing --num-layers 2 \\
        --num-hidden 200 --num-embed 200 --vocab-size 10000 \\
        --batch-size 32 --buckets 10,20,30,40,50,60
    python -m mxnet_tpu_torch.models.lstm_bucketing --device cpu

``main`` returns the trained module, with the perplexity at the end of
each epoch in ``epoch_perplexity``.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from .. import initializer as init
from .. import io, metric, rnn
from .. import module as mod_pkg
from .. import ndarray as nd
from .. import symbol as sym
from ..context import resolve_device

__all__ = ["sym_gen_factory", "BucketSeqIter", "main"]


def sym_gen_factory(num_hidden, num_layers, num_embed, vocab_size,
                    fused=True):
    """``sym_gen(seq_len) -> (symbol, ["data"], ["softmax_label"])``."""
    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, name="embed", input_dim=vocab_size,
                              output_dim=num_embed)
        if fused:
            cell = rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                                    mode="lstm", prefix="lstm_")
        else:
            cell = rnn.SequentialRNNCell()
            for i in range(num_layers):
                cell.add(rnn.LSTMCell(num_hidden, prefix="lstm_l%d_" % i))
        outputs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                 merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, name="pred", num_hidden=vocab_size)
        label_flat = sym.Reshape(label, shape=(-1,))
        out = sym.SoftmaxOutput(pred, label_flat, name="softmax")
        return out, ["data"], ["softmax_label"]
    return sym_gen


class BucketSeqIter(io.DataIter):
    """``batches_per_bucket`` batches of random tokens in ``[1, vocab)``
    for each bucket length, shuffled once, the same every epoch; batches
    are made on ``ctx`` (default the current context)."""

    def __init__(self, buckets, batch_size, vocab_size, batches_per_bucket=8,
                 seed=0, ctx=None):
        super().__init__(batch_size)
        self.buckets = buckets
        self.vocab_size = vocab_size
        self._ctx = ctx
        rng = np.random.RandomState(seed)
        self._batches = []
        for b in buckets:
            for _ in range(batches_per_bucket):
                data = rng.randint(1, vocab_size, (batch_size, b))
                label = np.roll(data, -1, axis=1)
                self._batches.append((b, data.astype(np.float32),
                                      label.astype(np.float32)))
        rng.shuffle(self._batches)
        self._idx = 0
        self.default_bucket_key = max(buckets)

    @property
    def provide_data(self):
        return [io.DataDesc("data", (self.batch_size,
                                     self.default_bucket_key))]

    @property
    def provide_label(self):
        return [io.DataDesc("softmax_label",
                            (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._idx = 0

    def next(self):
        if self._idx >= len(self._batches):
            raise StopIteration
        b, data, label = self._batches[self._idx]
        self._idx += 1
        return io.DataBatch(
            data=[nd.array(data, ctx=self._ctx)],
            label=[nd.array(label, ctx=self._ctx)], pad=0, bucket_key=b,
            provide_data=[io.DataDesc("data", (self.batch_size, b))],
            provide_label=[io.DataDesc("softmax_label",
                                       (self.batch_size, b))])


def main(argv=None, batch_end_callback=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-hidden", type=int, default=64)
    parser.add_argument("--num-embed", type=int, default=32)
    parser.add_argument("--num-layers", type=int, default=1)
    parser.add_argument("--vocab-size", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epochs", type=int, default=2)
    parser.add_argument("--buckets", type=str, default="8,16,32")
    parser.add_argument("--batches-per-bucket", type=int, default=8)
    parser.add_argument("--fused", type=int, default=1, choices=[0, 1],
                        help="1: FusedRNNCell (the RNN op); 0: LSTMCells")
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--device", default=None,
                        help="cuda:0 by default; 'cpu' trains on the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    buckets = [int(b) for b in args.buckets.split(",")]
    train = BucketSeqIter(buckets, args.batch_size, args.vocab_size,
                          args.batches_per_bucket, ctx=device)
    model = mod_pkg.BucketingModule(
        sym_gen_factory(args.num_hidden, args.num_layers, args.num_embed,
                        args.vocab_size, fused=bool(args.fused)),
        default_bucket_key=train.default_bucket_key, context=device)
    epoch_perplexity = {}

    def record(param):
        # the running metric at an epoch's last batch is its perplexity
        epoch_perplexity[param.epoch] = param.eval_metric.get()[1]

    callbacks = [record] + ([] if batch_end_callback is None
                            else list(batch_end_callback)
                            if isinstance(batch_end_callback, (list, tuple))
                            else [batch_end_callback])
    model.fit(train, num_epoch=args.num_epochs, kvstore=args.kv_store,
              optimizer="adam", optimizer_params={"learning_rate": 0.01},
              eval_metric=metric.Perplexity(ignore_label=None),
              initializer=init.Xavier(), batch_end_callback=callbacks)
    model.epoch_perplexity = [epoch_perplexity[e]
                              for e in sorted(epoch_perplexity)]
    print("perplexity by epoch:", model.epoch_perplexity)
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
