"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``)
and the ``jax.random`` distributions they draw from.

Each registered op takes its key in ``attrs["_rng_key"]``, threaded by the
dispatch (``ndarray.invoke``, the executor, a ``CachedOp``'s key buffer)
exactly as the JAX package threads it, and computes what the
``jax.random`` function it calls there computes, from the same bits
(``random.random_bits``):

- :func:`uniform` and :func:`bernoulli` (``Dropout``'s mask, ``rrelu``'s
  slopes), :func:`randint` and :func:`permutation` (``shuffle``) are
  bit for bit ``jax.random``'s;
- :func:`normal` is ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``ErfInv``
  polynomial written in torch ops (``torch.erfinv`` is another function),
  :func:`exponential` is ``-log1p(-u)`` and :func:`categorical` the argmax
  of Gumbel noise: these round through torch's ``log``/``log1p``, within a
  few ulp of XLA's.

``_random_uniform``, ``_random_normal``, ``_random_exponential``,
``_random_randint``, ``_sample_uniform``, ``_sample_normal``,
``_sample_exponential``, ``_sample_multinomial`` and ``_shuffle`` are
ported.  The rejection samplers (``_random_gamma``, ``_random_poisson``,
the two negative binomials, ``_sample_gamma``, ``_sample_poisson``) are
registered and raise, naming themselves: their while-loops are not ported
yet.  An op with no array input makes its output on ``attrs["_device"]``
(the executor's graph device, ``meta`` in shape inference), else on the
current context.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..random import device_of, random_bits, split
from .registry import alias, register

__all__ = ["uniform", "bernoulli", "normal", "exponential", "randint",
           "permutation", "categorical"]


# ---------------------------------------------------------------------------
# the distributions (``jax.random``)

_FLOATS = {torch.float32: (32, 23, torch.int32, 0x3F800000),
           torch.float16: (16, 10, torch.int16, 0x3C00),
           torch.bfloat16: (16, 7, torch.int16, 0x3F80)}


def _unit_floats(key, shape, dtype, device):
    """Floats in [0, 1) of ``dtype`` from the mantissa bits, as
    ``jax.random.uniform`` makes them."""
    nbits, nmant, itype, one = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, device)
    if rng_bits != 32:
        bits = bits.bitwise_and_((1 << rng_bits) - 1)
    mant = bits >> (rng_bits - nmant)
    mant.bitwise_and_((1 << nmant) - 1).bitwise_or_(one)
    return mant.to(itype).view(dtype) - 1.0


def _as_dtype_scalar(v, dtype):
    """``v`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(float(v), dtype=dtype))


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None):
    """``jax.random.uniform``: ``max(minval, floats * (maxval - minval) +
    minval)`` in ``dtype``, the multiply-add fused as XLA fuses it."""
    device = device_of(key, device)
    floats = _unit_floats(key, shape, dtype, device)
    lo = _as_dtype_scalar(minval, dtype)
    span = _as_dtype_scalar(_as_dtype_scalar(maxval, dtype) - lo, dtype)
    if span == 1.0 and lo == 0.0:
        return floats
    # XLA fuses the scale and shift into one fused multiply-add; in float64
    # the product is exact, so one rounding to ``dtype`` gives its result
    out = floats.to(torch.float64).mul_(span).add_(lo).to(dtype)
    return out.clamp_min_(lo)


def bernoulli(key, p, shape, device=None):
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a float32
    uniform below ``p``, as a bool tensor."""
    return uniform(key, shape, device=device) < _as_dtype_scalar(
        p, torch.float32)


# XLA's float32 ErfInv (xla/client/lib/math.cc ErfInv32, Giles' single
# precision approximation)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` polynomial, in torch ops."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    one = torch.ones_like(x)

    def coefficient(i):
        return torch.where(lt, one * _ERFINV_LT5[i], one * _ERFINV_GE5[i])

    # Horner's rule with XLA's fused multiply-adds (exact products in
    # float64, one rounding each)
    p = coefficient(0).to(torch.float64)
    w = w.to(torch.float64)
    for i in range(1, len(_ERFINV_LT5)):
        p = p.mul_(w).add_(coefficient(i)).to(torch.float32) \
            .to(torch.float64)
    out = p.to(torch.float32) * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, out)


def normal(key, shape, dtype=torch.float32, device=None):
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``, ``u`` uniform on
    ``(nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, torch.float32, lo, 1.0, device)
    out = _erf_inv(u) * float(np.float32(np.sqrt(2)))
    return out if dtype == torch.float32 else out.to(dtype)


def exponential(key, shape, dtype=torch.float32, device=None):
    """``jax.random.exponential``: ``-log1p(-u)``."""
    u = uniform(key, shape, dtype, device=device)
    return torch.log1p(-u).neg_()


def randint(key, shape, minval, maxval, dtype=torch.int32, device=None):
    """``jax.random.randint`` for an ``int32`` range: two 32-bit draws
    folded into ``[minval, maxval)`` by the multiplier trick (biased as
    there)."""
    device = device_of(key, device)
    lo_i = max(int(minval), -2 ** 31)
    hi_i = min(int(maxval), 2 ** 31 - 1)
    span = 1 if hi_i <= lo_i else (hi_i - lo_i) & 0xFFFFFFFF
    if int(maxval) > 2 ** 31 - 1 and hi_i > lo_i:
        span = (span + 1) & 0xFFFFFFFF
    k = split(key)
    mask = 0xFFFFFFFF
    hi_bits = random_bits(k[0], shape, device).to(torch.int64) & mask
    lo_bits = random_bits(k[1], shape, device).to(torch.int64) & mask
    if span == 0:   # the whole uint32 range: the remainders are the bits
        offset = lo_bits
    else:
        mult = (2 ** 16) % span
        mult = ((mult * mult) & mask) % span   # uint32 product
        offset = ((hi_bits % span) * mult) & mask
        offset = ((offset + lo_bits % span) & mask) % span
    out = (offset + lo_i) & mask
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(dtype)


def _sort_keys(key, n, device):
    """A round's 32-bit sort keys as non-negative ``int64`` (the unsigned
    order)."""
    return random_bits(key, (n,), device).to(torch.int64) & 0xFFFFFFFF


def permutation(key, x):
    """``jax.random.permutation(key, x, axis=0)``: ``x`` shuffled along its
    first axis by ``ceil(3 ln n / ln(2^32 - 1))`` stable sorts over fresh
    32-bit keys; an array of more than one axis is shuffled by a permuted
    ``arange``."""
    device = x.device
    if x.dim() > 1:
        ind = permutation(key, torch.arange(x.shape[0], device=device))
        return x.index_select(0, ind)
    n = x.numel()
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        children = split(key)
        key, sub = children[0], children[1]
        order = torch.sort(_sort_keys(sub, n, device), stable=True).indices
        x = x.index_select(0, order)
    return x


def categorical(key, logits, shape):
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)``: the
    argmax of Gumbel noise ``-log(-log(u))`` plus ``logits``, the noise of
    shape ``shape[:-batch] + logits`` broadcast."""
    shape = tuple(shape)
    batch = tuple(logits.shape[:-1])
    prefix = shape[:len(shape) - len(batch)]
    noise_shape = prefix + shape[len(shape) - len(batch):] \
        + (logits.shape[-1],)
    tiny = float(torch.finfo(logits.dtype).tiny)
    u = uniform(key, noise_shape, logits.dtype, tiny, 1.0, logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits.reshape((1,) * len(prefix)
                                           + tuple(logits.shape)), dim=-1)


# ---------------------------------------------------------------------------
# the registered ops

def _shape_dtype(attrs, default="float32"):
    from ..ndarray.ndarray import torch_dtype
    shape = attrs.get("shape", (1,))
    if isinstance(shape, int):
        shape = (shape,)
    return tuple(int(s) for s in shape), \
        torch_dtype(attrs.get("dtype") or default)


def _draw_device(attrs):
    return resolve_device(attrs.get("_device"))


@register("_random_uniform", needs_rng=True)
def _random_uniform(attrs, *unused):
    shape, dtype = _shape_dtype(attrs)
    return uniform(attrs["_rng_key"], shape, dtype,
                   float(attrs.get("low", 0.0)),
                   float(attrs.get("high", 1.0)), _draw_device(attrs))


@register("_random_normal", needs_rng=True)
def _random_normal(attrs, *unused):
    shape, dtype = _shape_dtype(attrs)
    n = normal(attrs["_rng_key"], shape, dtype, _draw_device(attrs))
    return n * float(attrs.get("scale", 1.0)) + float(attrs.get("loc", 0.0))


@register("_random_exponential", needs_rng=True)
def _random_exponential(attrs, *unused):
    shape, dtype = _shape_dtype(attrs)
    e = exponential(attrs["_rng_key"], shape, dtype, _draw_device(attrs))
    return e / float(attrs.get("lam", 1.0))


@register("_random_randint", needs_rng=True)
def _random_randint(attrs, *unused):
    shape, dtype = _shape_dtype(attrs, "int32")
    return randint(attrs["_rng_key"], shape, int(attrs.get("low", 0)),
                   int(attrs.get("high", 1)), dtype, _draw_device(attrs))


def _sample_shapes(attrs, param):
    shape = tuple(attrs.get("shape", ()))
    return param.shape + shape, param.shape + (1,) * len(shape)


@register("_sample_uniform", needs_rng=True)
def _sample_uniform(attrs, low, high):
    out_shape, bshape = _sample_shapes(attrs, low)
    u = uniform(attrs["_rng_key"], out_shape, device=low.device)
    return low.reshape(bshape) + u * (high - low).reshape(bshape)


@register("_sample_normal", needs_rng=True)
def _sample_normal(attrs, mu, sigma):
    out_shape, bshape = _sample_shapes(attrs, mu)
    n = normal(attrs["_rng_key"], out_shape, device=mu.device)
    return mu.reshape(bshape) + n * sigma.reshape(bshape)


@register("_sample_exponential", needs_rng=True)
def _sample_exponential(attrs, lam):
    out_shape, bshape = _sample_shapes(attrs, lam)
    e = exponential(attrs["_rng_key"], out_shape, device=lam.device)
    return e / lam.reshape(bshape)


@register("_sample_multinomial", needs_rng=True,
          num_outputs=lambda attrs: 2 if attrs.get("get_prob", False) else 1)
def _sample_multinomial(attrs, data):
    """Class indices drawn from the rows of ``data`` (probabilities), as
    ``jax.random.categorical`` over ``log(max(data, 1e-37))``; with
    ``get_prob`` also each draw's log-probability."""
    from ..ndarray.ndarray import torch_dtype
    shape = attrs.get("shape", ())
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape) or (1,)
    n = math.prod(shape)
    logits = torch.log(torch.clamp_min(data, 1e-37))
    key = attrs["_rng_key"]
    if data.dim() == 1:
        idx = categorical(key, logits, (n,)).reshape(shape)
    else:
        idx = categorical(key, logits[:, None, :], (data.shape[0], n))
        idx = idx.reshape((data.shape[0],) + shape)
    out = idx.to(torch_dtype(attrs.get("dtype", "int32")))
    if not attrs.get("get_prob", False):
        return out
    if data.dim() == 1:
        p = logits[idx]
    else:
        p = torch.gather(logits, -1, idx.reshape(data.shape[0], -1)) \
            .reshape(idx.shape)
    return out, p


@register("_shuffle", needs_rng=True)
def _shuffle(attrs, data):
    """``data`` shuffled along its first axis
    (``jax.random.permutation``)."""
    return permutation(attrs["_rng_key"], data)


alias("shuffle", "_shuffle")


def _rejection_sampler(name):
    def fcompute(attrs, *args):
        raise MXNetError("op %s draws by rejection sampling (a while-loop), "
                         "which is not ported yet" % name)
    fcompute.__name__ = name
    register(name, needs_rng=True)(fcompute)


for _name in ("_random_gamma", "_random_poisson",
              "_random_negative_binomial",
              "_random_generalized_negative_binomial", "_sample_gamma",
              "_sample_poisson"):
    _rejection_sampler(_name)
