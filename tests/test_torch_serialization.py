"""``.params`` files: ``nd.save``/``nd.load`` and Gluon's
``save_parameters``/``load_parameters`` in mxnet_tpu_torch against the JAX
package's.

- The same arrays give byte-identical files in both packages, in the list
  and the dict form, for float32, float16, int32, int64 (narrowed to int32
  by both, which run without 64-bit arrays) and bfloat16 (written as
  float32 by both).
- Each package loads the other's files, values and dtypes exact.
- The legacy pre-V1 layout (``tests/data/legacy_ndarray.v0``) and a V1
  array load as in the JAX package.
- ``save_parameters`` of a port block loads into a fresh port block and
  into the same block built by the JAX package, bit for bit, filling
  deferred shapes; ``collect_params().save``/``load`` round-trip with
  ``strip_prefix``.
"""
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import serialization as tser

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = tmx.cpu()


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.normal(0, 1, (3, 4)).astype(np.float32),
        "f16": rng.normal(0, 1, (5,)).astype(np.float16),
        "i32": rng.randint(-9, 9, (2, 3, 2)).astype(np.int32),
        "i64": rng.randint(-9, 9, (4,)).astype(np.int64),
        "bf16": rng.normal(0, 1, (2, 3)).astype(np.float32),
    }


def _port(name, a):
    nd = tmx.nd.array(a, ctx=CPU)
    return nd.astype("bfloat16") if name == "bf16" else nd


def _jax(name, a):
    nd = mx.nd.array(a, dtype=a.dtype)
    return nd.astype("bfloat16") if name == "bf16" else nd


@pytest.mark.parametrize("form", ["list", "dict"])
def test_files_are_byte_identical_and_cross_load(form, tmp_path):
    arrays = _arrays()
    tpath, jpath = str(tmp_path / "port.params"), str(tmp_path / "jax.params")
    if form == "dict":
        tmx.nd.save(tpath, {n: _port(n, a) for n, a in arrays.items()})
        mx.nd.save(jpath, {n: _jax(n, a) for n, a in arrays.items()})
    else:
        tmx.nd.save(tpath, [_port(n, a) for n, a in arrays.items()])
        mx.nd.save(jpath, [_jax(n, a) for n, a in arrays.items()])
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    by_port = tmx.nd.load(jpath, ctx=CPU)
    by_jax = mx.nd.load(tpath)
    if form == "list":
        by_port = dict(zip(arrays, by_port))
        by_jax = dict(zip(arrays, by_jax))
    assert list(by_port) == list(by_jax) == list(arrays)
    for n, a in arrays.items():
        want = a.astype(np.int32) if n == "i64" else a
        if n == "bf16":   # bf16 checkpoints as float32
            want = _port(n, a).asnumpy()
        for got in (by_port[n], by_jax[n]):
            assert got.dtype == want.dtype, n
            np.testing.assert_array_equal(got.asnumpy(), want)


def test_serializer_refuses_0d_and_reads_v1_and_legacy():
    with pytest.raises(ValueError, match="0-d"):
        tser.serialize_ndarray(np.zeros((), np.float32))
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    v1 = (struct.pack("<I", tser.NDARRAY_V1_MAGIC)
          + struct.pack("<I2q", 2, 2, 3) + struct.pack("<iii", 1, 0, 0)
          + a.tobytes())
    got, off = tser.deserialize_ndarray(v1, 0)
    assert off == len(v1)
    np.testing.assert_array_equal(got, a)
    legacy = os.path.join(DATA, "legacy_ndarray.v0")
    want = mx.nd.load(legacy)
    got = tmx.nd.load(legacy, ctx=CPU)
    assert type(got) is type(want) and len(got) == len(want)
    items = got.items() if isinstance(got, dict) else enumerate(got)
    for k, v in items:
        assert v.dtype == want[k].dtype
        np.testing.assert_array_equal(v.asnumpy(), want[k].asnumpy())
    with pytest.raises(ValueError, match="magic"):
        tser.load_list(b"\0" * 16)


def _nets():
    """A conv, BatchNorm and dense stack, shapes deferred, in both
    packages."""
    def build(pkg, **kw):
        net = pkg.HybridSequential()
        with net.name_scope():
            net.add(pkg.Conv2D(4, 3, **kw), pkg.BatchNorm(**kw),
                    pkg.Dense(5, **kw))
        return net
    return build(mx.gluon.nn), build(nn, device="cpu")


def test_save_parameters_loads_in_both_packages(tmp_path):
    tmx.random.seed(2)
    _, tnet = _nets()
    tnet.initialize(tmx.init.Xavier())
    x = torch.from_numpy(np.random.RandomState(1).normal(
        0, 1, (2, 3, 6, 6)).astype(np.float32))
    with tmx.autograd.record():   # moves the running statistics
        tnet(x)
    path = str(tmp_path / "net.params")
    tnet.save_parameters(path)
    saved = {k: v.numpy() for k, v in tnet.state_dict().items()}
    assert set(saved) == set(tnet._collect_params_with_prefix())
    fresh = _nets()[1]
    fresh.load_parameters(path, ctx=CPU)
    jnet = _nets()[0]
    jnet.load_parameters(path)
    jarrays = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    for k, a in saved.items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), a)
        np.testing.assert_array_equal(jarrays[k], a)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(x).numpy(), tnet(x).numpy())
    # the legacy form: full Gluon names, the block's prefix stripped
    legacy = str(tmp_path / "legacy.params")
    tnet.collect_params().save(legacy, strip_prefix=tnet.prefix)
    again = _nets()[1]
    again.collect_params().load(legacy, ctx=CPU,
                                restore_prefix=again.prefix)
    for k, t in again.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), saved[k])
    with pytest.raises(AssertionError, match="missing"):
        _nets()[1].load_parameters(str(_save_one(tmp_path)))


def _save_one(tmp_path):
    path = tmp_path / "one.params"
    tmx.nd.save(str(path), {"0.weight": tmx.nd.zeros((4, 3, 3, 3),
                                                       ctx=CPU)})
    return path
