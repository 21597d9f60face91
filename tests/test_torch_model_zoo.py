"""mxnet_tpu_torch's vision model zoo against the JAX package's.

- Every name the JAX package's ``vision.get_model`` takes builds in the
  port, with the same parameter names.
- The families of ``tests/test_gluon.py``'s zoo test, at its batch (1) and
  sizes: seeded (``mx.random.seed``, ``initialize(Xavier())``, one call),
  every array equals the JAX model's bit for bit, and the logits hold at
  the hybridize bound (rtol 1e-4, atol 1e-5).  Xavier, the initializer the
  training and scoring scripts use, keeps the logits near unit scale,
  where that elementwise bound measures the arithmetic (the default
  ``Uniform(0.07)`` gives AlexNet logits of about 70, whose float32
  rounding alone is 1e-4 wide).  The port's hybridized call
  equals its eager one.  The JAX model finishes its deferred parameters
  as its first call would (``_finish_in_forward_order``, with the port's
  shapes) and then runs one hybridized (jitted) call, which compiles in a
  fraction of the time its eager first call takes.
- ``pretrained=<path>`` loads a ``.params`` file; ``pretrained=True``
  raises in both packages.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

FAMILIES = ["alexnet", "densenet121", "inceptionv3", "mobilenet0.5",
            "mobilenetv2_0.5", "resnet18_v1", "resnet18_v2",
            "squeezenet1.0", "vgg11", "vgg11_bn"]
HYBRIDIZE = dict(rtol=1e-4, atol=1e-5)
# ResNet v2 reaches a unit's downsample before its first convolution,
# against their registration order: its JAX model takes its real first call
EAGER_FIRST_CALL = {"resnet18_v2"}


def _size(name):
    return 299 if "inception" in name else \
        224 if ("alexnet" in name or "squeezenet" in name) else 64


def _jax_names():
    with pytest.raises(ValueError) as err:
        jvision.get_model("no-such-model")
    return sorted(re.findall(r"^\t(\S+)$", str(err.value), re.M))


def test_get_model_takes_every_jax_name():
    names = _jax_names()
    assert len(names) == 34
    assert names == sorted(tvision._MODELS)


@pytest.mark.parametrize("name", _jax_names())
def test_every_model_builds_with_the_jax_names(name):
    with mx.name.NameManager():
        want = sorted(jvision.get_model(name, classes=5).collect_params())
    with tmx.name.NameManager():
        net = tvision.get_model(name, classes=5, device="cpu")
    assert sorted(net.collect_params()) == want


def _port(name, x, seed):
    tmx.random.seed(seed)
    with tmx.name.NameManager():
        net = tvision.get_model(name, classes=7, device="cpu")
    net.initialize(tmx.init.Xavier())
    with torch.no_grad():
        eager = net(torch.from_numpy(x))
        net.hybridize()
        hybrid = net(torch.from_numpy(x))
    return net, eager.numpy(), hybrid.numpy()


def _finish_in_forward_order(block, shapes):
    """What the JAX model's first (eager) call does to its parameters and
    key, without compiling it: each layer, in the order the forward
    reaches it (its registration order, in these models), finishes its
    deferred parameters with the port's shapes, and each ``Dropout`` takes
    its key."""
    if isinstance(block, jnn.Dropout):
        mx.random.next_key()
        return
    for p in block._reg_params.values():
        if p._deferred_init:
            p.shape = shapes[p.name]
            p._finish_deferred_init()
    for child in block._children.values():
        _finish_in_forward_order(child, shapes)


def _jax(name, x, seed, shapes):
    mx.random.seed(seed)
    with mx.name.NameManager():
        net = jvision.get_model(name, classes=7)
    net.initialize(mx.init.Xavier())
    if name in EAGER_FIRST_CALL:
        net(mx.nd.array(x))
    else:
        _finish_in_forward_order(net, shapes)
    net.hybridize()
    return net, net(mx.nd.array(x)).asnumpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_seeded_zoo_weights_and_logits_are_the_jax_models(name):
    size = _size(name)
    x = np.random.RandomState(1).uniform(
        -1, 1, (1, 3, size, size)).astype(np.float32)
    tnet, eager, hybrid = _port(name, x, seed=2)
    shapes = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    jnet, want = _jax(name, x, 2, shapes)
    got_arrays = {k: p.data().asnumpy()
                  for k, p in tnet._collect_params_with_prefix().items()}
    want_arrays = {k: p.data().asnumpy()
                   for k, p in jnet._collect_params_with_prefix().items()}
    assert list(got_arrays) == list(want_arrays)
    for k, w in want_arrays.items():
        assert np.array_equal(got_arrays[k], w), k
    assert eager.shape == want.shape == (1, 7)
    np.testing.assert_allclose(eager, want, **HYBRIDIZE)
    assert np.array_equal(hybrid, eager)


def test_pretrained_path_loads_and_true_raises(tmp_path):
    tmx.random.seed(0)
    with tmx.cpu():
        net = tvision.squeezenet1_1(classes=4)
    net.initialize()
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (1, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        want = net(x).numpy()
    path = str(tmp_path / "squeezenet.params")
    net.save_parameters(path)
    loaded = tvision.get_model("squeezenet1.1", classes=4,
                               pretrained=path, device="cpu")
    with torch.no_grad():
        assert np.array_equal(loaded(x).numpy(), want)
    with pytest.raises(NotImplementedError):
        tvision.vgg16(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError):
        jvision.vgg16(pretrained=True)
