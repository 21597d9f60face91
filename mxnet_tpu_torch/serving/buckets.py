"""Bucket ladder: the fixed shape menu the server serves from.

Counterpart of ``mxnet_tpu/serving/buckets.py``.  Every model is loaded
with (1) an explicit list of admissible per-request input shapes and (2) a
batch-size ladder (1/2/4/.../max_batch by default).  Requests are only
coalesced with requests of the *same* input shape and the batch dimension
is padded up to the next rung, so steady-state traffic touches exactly
``len(shapes) x len(ladder)`` signatures, all of them run once by warmup.
The JAX package needs the fixed menu to bound XLA compiles; the eager port
keeps it so that batches, warmup and kernel shapes stay the same menu.

Batch-dim padding keeps per-request outputs exact for batch-major models
(rows are independent in inference mode); feature-dim padding would not be —
that is the model's job (masking), so the server never does it.
"""
from __future__ import annotations

__all__ = ["BucketLadder", "shape_key", "normalize_shape_variants"]


class BucketLadder:
    """Sorted batch-size rungs; requests pad up to the smallest fitting rung.

    ``sizes`` overrides the default powers-of-two ladder (the e.g. 1/2/4/8
    sequence capped at ``max_batch``, with max_batch always a rung).
    """

    def __init__(self, max_batch=8, sizes=None):
        if sizes is None:
            sizes, b = [], 1
            while b < int(max_batch):
                sizes.append(b)
                b *= 2
            sizes.append(int(max_batch))
        self.sizes = sorted(set(int(s) for s in sizes))
        if not self.sizes or self.sizes[0] < 1:
            raise ValueError("bucket ladder needs positive sizes, got %r"
                             % (sizes,))
        self.max_batch = self.sizes[-1]

    def bucket(self, n):
        """Smallest rung >= n (callers never exceed max_batch per batch)."""
        for s in self.sizes:
            if s >= n:
                return s
        return self.max_batch

    def __iter__(self):
        return iter(self.sizes)

    def __len__(self):
        return len(self.sizes)

    def __repr__(self):
        return "BucketLadder(%s)" % (self.sizes,)


def shape_key(arrays):
    """Coalescing key of one request: per-input (shape, dtype) tuples."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


def normalize_shape_variants(input_shapes, n_inputs=None):
    """Normalize a user shape list to a list of per-input shape tuples.

    Each variant may be a plain shape tuple (single-input model) or a tuple
    of shape tuples (multi-input).  ``[(16,), (32,)]`` -> ``[((16,),),
    ((32,),)]``.
    """
    variants = []
    for spec in input_shapes:
        spec = tuple(spec)
        if spec and all(isinstance(s, int) for s in spec):
            spec = (spec,)                       # single-input shorthand
        else:
            spec = tuple(tuple(s) for s in spec)
        if n_inputs is not None and len(spec) != n_inputs:
            raise ValueError("shape variant %r has %d inputs, model takes %d"
                             % (spec, len(spec), n_inputs))
        variants.append(spec)
    if not variants:
        raise ValueError("input_shapes must list at least one shape variant")
    return variants
