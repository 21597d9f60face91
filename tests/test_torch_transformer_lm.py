"""mxnet_tpu_torch TransformerLM against the JAX package's model.

The JAX ``example/gluon/transformer_lm.py`` model is built small (vocab 16,
dim 64, 4 heads, depth 2, max_len 64) with a fixed ``mx.random.seed`` and
Xavier, its weights are carried into the port with ``load_mxnet_params``,
and both run the same seeded tokens.  Bound 1e-4 on logits of order 1:
fp32 sums taken in another order (observed max abs diff ~1e-6 here).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import load_mxnet_params, mxnet_to_torch_name
from mxnet_tpu_torch.models import TransformerLM as TorchLM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402

VOCAB, DIM, HEADS, DEPTH, MAX_LEN = 16, 64, 4, 2, 64
BOUND = 1e-4


def jax_model(seed=7):
    mx.random.seed(seed)
    net = JaxLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN)
    net.initialize(mx.init.Xavier())
    zeros = mx.nd.array(np.zeros((1, 4), np.int32), dtype="int32")
    net(zeros, zeros)   # finish deferred init
    return net


def jax_arrays(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def torch_model(arrays):
    net = TorchLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN,
                  device="cpu")
    return load_mxnet_params(net, arrays)


def tokens(seed, B, T):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, VOCAB, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    return idx, pos


@pytest.mark.parametrize("T", [64, 40])
def test_logits_match_jax_model(T):
    jnet = jax_model()
    tnet = torch_model(jax_arrays(jnet))
    idx, pos = tokens(1, 3, T)
    ref = jnet(mx.nd.array(idx, dtype="int32"),
               mx.nd.array(pos, dtype="int32")).asnumpy()
    with torch.inference_mode():
        out = tnet(torch.from_numpy(idx), torch.from_numpy(pos)).numpy()
    assert out.shape == (3, T, VOCAB) == ref.shape
    assert np.abs(out - ref).max() <= BOUND


def test_every_jax_parameter_has_one_port_parameter():
    arrays = jax_arrays(jax_model())
    tnet = torch_model(arrays)
    mapped = {mxnet_to_torch_name(tnet, n) for n in arrays}
    assert mapped == set(dict(tnet.named_parameters()))
    assert len(mapped) == len(arrays)


def test_any_model_prefix_is_stripped():
    tnet = TorchLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                   max_len=MAX_LEN, device="cpu")
    assert (mxnet_to_torch_name(
        tnet, "transformerlm3_block1_causalselfattention0_dense0_weight")
        == "blocks.1.attn.qkv.weight")
    assert mxnet_to_torch_name(tnet, "transformerlm12_dense0_bias") \
        == "head.bias"
    assert mxnet_to_torch_name(tnet, "resnet0_dense0_bias") is None


def test_converter_names_missing_array():
    arrays = jax_arrays(jax_model())
    name = next(n for n in arrays if n.endswith("block1_layernorm0_gamma"))
    del arrays[name]
    with pytest.raises(MXNetError, match="missing.*block1_layernorm0_gamma"):
        torch_model(arrays)


def test_converter_names_extra_array():
    arrays = jax_arrays(jax_model())
    arrays["transformerlm0_block9_dense0_weight"] = np.zeros((4, 4),
                                                             np.float32)
    with pytest.raises(MXNetError, match="extra array "
                                         "'transformerlm0_block9_dense0"):
        torch_model(arrays)


def test_converter_names_misshaped_array():
    arrays = jax_arrays(jax_model())
    name = next(n for n in arrays if n.endswith("_embedding1_weight"))
    arrays[name] = arrays[name][:8]
    with pytest.raises(MXNetError, match="embedding1_weight.*shape"):
        torch_model(arrays)


def test_seeded_xavier_init_is_reproducible_and_bounded():
    def build(seed):
        net = TorchLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH,
                      max_len=MAX_LEN, device="cpu")
        tmx.random.seed(seed)
        net.initialize(tmx.init.Xavier())
        zeros = torch.zeros((1, 4), dtype=torch.int32)
        with torch.no_grad():
            net(zeros, zeros)   # draws the deferred weights
        return net

    a, b, c = build(0), build(0), build(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("weight"):
            fan_out, fan_in = pa.shape
            limit = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
            assert pa.abs().max() <= limit
            assert not torch.equal(pa, pc), name
        elif name.endswith("gamma"):
            assert torch.equal(pa, torch.ones_like(pa)), name
        else:
            assert torch.equal(pa, torch.zeros_like(pa)), name


def test_model_constructor_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        TorchLM(VOCAB, dim=DIM, heads=HEADS, depth=DEPTH, max_len=MAX_LEN)
