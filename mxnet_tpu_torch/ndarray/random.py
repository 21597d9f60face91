"""``mx.nd.random`` and ``mx.random``'s samplers (counterpart of
``mxnet_tpu/ndarray/random.py``).

Each takes scalar parameters (one ``_random_*`` op of ``shape``, default
``(1,)``) or NDArrays (one ``_sample_*`` op drawing ``shape`` values per
element of the parameters), and draws from a fresh ``random.next_key()``
through :func:`~.ndarray.invoke`, so ``mx.random.seed(n)`` gives the JAX
package's draws.  The scalar samplers make their array on ``ctx``, else
on the current context.  ``gamma``, ``poisson`` and the negative binomials
call ops that raise: their rejection samplers are not ported yet.
"""
from __future__ import annotations

from ..context import resolve_device
from .ndarray import NDArray, invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def _sample(scalar_op, array_op, params, shape, dtype, ctx, out, attr_names):
    if isinstance(shape, int):
        shape = (shape,)
    if any(isinstance(p, NDArray) for p in params):
        return invoke(array_op, list(params), {"shape": tuple(shape or ())},
                      out=out)
    attrs = dict(zip(attr_names, params))
    attrs["shape"] = tuple(shape or (1,))
    attrs["_device"] = resolve_device(ctx)
    if dtype:
        attrs["dtype"] = dtype
    return invoke(scalar_op, [], attrs, out=out)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    return _sample("_random_uniform", "_sample_uniform", [low, high],
                   shape, dtype, ctx, out, ["low", "high"])


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    return _sample("_random_normal", "_sample_normal", [loc, scale],
                   shape, dtype, ctx, out, ["loc", "scale"])


def randn(*shape, loc=0, scale=1, dtype=None, ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    return _sample("_random_gamma", "_sample_gamma", [alpha, beta],
                   shape, dtype, ctx, out, ["alpha", "beta"])


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    return _sample("_random_exponential", "_sample_exponential",
                   [1.0 / scale], shape, dtype, ctx, out, ["lam"])


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    return _sample("_random_poisson", "_sample_poisson", [lam],
                   shape, dtype, ctx, out, ["lam"])


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kwargs):
    return _sample("_random_negative_binomial", "_sample_negative_binomial",
                   [k, p], shape, dtype, ctx, out, ["k", "p"])


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    return _sample("_random_generalized_negative_binomial",
                   "_sample_generalized_negative_binomial",
                   [mu, alpha], shape, dtype, ctx, out, ["mu", "alpha"])


def multinomial(data, shape=(1,), get_prob=False, out=None, dtype="int32",
                **kwargs):
    return invoke("_sample_multinomial", [data],
                  {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                  out=out)


def shuffle(data, **kwargs):
    return invoke("_shuffle", [data], {})


def randint(low, high, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    return invoke("_random_randint", [],
                  {"low": int(low), "high": int(high),
                   "shape": tuple(shape or (1,)), "dtype": dtype or "int32",
                   "_device": resolve_device(ctx)}, out=out)
