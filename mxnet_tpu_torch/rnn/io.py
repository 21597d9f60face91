"""Bucketed sentences for the legacy RNN API (counterpart of
``mxnet_tpu/rnn/io.py``): ``encode_sentences`` and
``BucketSentenceIter``, whose epoch order is drawn from
``random.derived_numpy_rng`` as the JAX package's is, so one
``mx.random.seed`` gives both packages the same batches.  Its arrays are
made on the current context, as there.
"""
from __future__ import annotations

import bisect

import numpy as np

from ..io.io import DataIter, DataBatch, DataDesc
from .. import random as _mxrand
from .. import ndarray as nd


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Encode token sentences as int ids, growing the vocab as needed.

    Returns (encoded sentences, vocab).  With an input ``vocab``, unseen
    tokens either map to ``unknown_token`` or are an error.
    """
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if not grow and unknown_token is None:
                    raise AssertionError("Unknown token %s" % token)
                if unknown_token is not None:
                    token = unknown_token
                if token not in vocab:
                    while next_id == invalid_label or next_id in vocab.values():
                        next_id += 1
                    vocab[token] = next_id
                    next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Language-model iterator: buckets by length, label = next token.

    Sentences are padded with ``invalid_label`` up to their bucket length;
    each batch comes from one bucket, so under BucketingModule every bucket
    is one bound module (one captured graph a mode on the card).
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [length for length, count in enumerate(counts)
                       if count >= batch_size]
        buckets = sorted(buckets)

        padded = [[] for _ in buckets]
        discarded = 0
        for sentence in sentences:
            slot = bisect.bisect_left(buckets, len(sentence))
            if slot == len(buckets):
                discarded += 1
                continue
            row = np.full((buckets[slot],), invalid_label, dtype=dtype)
            row[:len(sentence)] = sentence
            padded[slot].append(row)
        if discarded:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % discarded)
        self.buckets = [b for b, rows in zip(buckets, padded) if rows]
        self.data = [np.asarray(rows, dtype=dtype)
                     for rows in padded if rows]

        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must be NT (batch major) or "
                             "TN (time major)" % layout)
        self.default_bucket_key = max(self.buckets)

        def desc(name):
            shape = ((batch_size, self.default_bucket_key)
                     if self.major_axis == 0
                     else (self.default_bucket_key, batch_size))
            return [DataDesc(name=name, shape=shape, layout=self.layout)]

        self.provide_data = desc(data_name)
        self.provide_label = desc(label_name)

        self.idx = [(i, j) for i, rows in enumerate(self.data)
                    for j in range(0, len(rows) - batch_size + 1, batch_size)]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        # one framework-derived stream for BOTH shuffles (bucket visit
        # order and within-bucket rows), so mx.random.seed controls the
        # whole epoch order — neither python's nor numpy's global state
        rng = _mxrand.derived_numpy_rng()
        rng.shuffle(self.idx)
        for rows in self.data:
            rng.shuffle(rows)
        self.nddata = []
        self.ndlabel = []
        for rows in self.data:
            label = np.empty_like(rows)
            label[:, :-1] = rows[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(rows, dtype=self.dtype))
            self.ndlabel.append(nd.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name, shape=label.shape,
                                    layout=self.layout)])
