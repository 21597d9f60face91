"""The saved-model path of mxnet_tpu_torch against the JAX package's.

Gluon blocks trace into ``sym.*`` (``hybrid_forward(F, ...)``), so
``HybridBlock.export`` writes a ``-symbol.json`` and a ``.params`` file,
``SymbolBlock.imports`` runs them and ``ModelServer.load_exported`` serves
them.  On the CPU, with inputs from seeded ``numpy.random.RandomState``s
and weights from ``mx.random.seed`` in both packages:

* the same construction writes the same ``-symbol.json`` string in both
  packages (a two-layer ``Dense`` MLP, ``resnet18_v1(classes=7)``,
  ``resnet50_v1``'s graph, ``resnet18_v2(classes=7)``, the example's ``TransformerLM`` traced over
  two variables, ``TinyGluonLM``, and a graph of the creators);
* an export of each package imports into the other's ``SymbolBlock`` and
  computes the exporting package's forward at the hybridize bound
  (rtol 1e-4, atol 1e-5: ``tests/test_gluon.py:292-301``);
* the port's counterparts of
  ``tests/test_serving.py::test_exported_model_serves_and_matches`` (rtol
  1e-5) and ``tests/test_serialization.py::
  test_gluon_export_rebinds_with_aux_states``, and the two-input LM
  served through ``load_exported``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.serving.decode.adapter import TinyGluonLM as JTinyGluonLM
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving.decode.adapter import TinyGluonLM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "gluon"))
from transformer_lm import TransformerLM as JaxLM  # noqa: E402

HYBRID = dict(rtol=1e-4, atol=1e-5)
LM_KW = dict(dim=32, heads=4, depth=2)


def _mlp(mx, nn_mod, **kw):
    net = nn_mod.HybridSequential()
    with net.name_scope():
        net.add(nn_mod.Dense(8, activation="relu", in_units=6, **kw),
                nn_mod.Dense(3, in_units=8, **kw))
    return net


def _creators(mx):
    return (mx.sym.arange(2, 8, 2, repeat=2) + mx.sym.ones((6,))
            + mx.sym.zeros(6))


# name -> (JAX block, port block, trace): each built in a fresh name scope
MODELS = {
    "mlp": (lambda: _mlp(jmx, jmx.gluon.nn),
            lambda: _mlp(tmx, nn, device="cpu"), None),
    "resnet18_v1": (lambda: jvision.resnet18_v1(classes=7),
                    lambda: vision.resnet18_v1(classes=7, device="cpu"),
                    None),
    "resnet50_v1": (jvision.resnet50_v1,
                    lambda: vision.resnet50_v1(device="cpu"), None),
    "resnet18_v2": (lambda: jvision.resnet18_v2(classes=7),
                    lambda: vision.resnet18_v2(classes=7, device="cpu"),
                    None),
    "transformer_lm": (lambda: JaxLM(16, **LM_KW),
                       lambda: tlm.TransformerLM(16, device="cpu", **LM_KW),
                       ("data", "pos_idx")),
    "tiny_gluon_lm": (JTinyGluonLM, lambda: TinyGluonLM(device="cpu"),
                      None),
}


def _trace(net, mx, names):
    return net(*(mx.sym.var(n) for n in names or ("data",)))


@pytest.mark.parametrize("name", sorted(MODELS) + ["creators"])
def test_symbol_json_is_the_jax_packages(name):
    with jmx.name.NameManager(), tmx.name.NameManager():
        if name == "creators":
            want, got = _creators(jmx), _creators(tmx)
        else:
            jbuild, tbuild, names = MODELS[name]
            want = _trace(jbuild(), jmx, names)
            got = _trace(tbuild(), tmx, names)
    assert got.tojson() == want.tojson()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()


def test_creators_compute_as_jax():
    want = _creators(jmx).eval(jmx.cpu())[0].asnumpy()
    with tmx.cpu():
        got = _creators(tmx).eval(tmx.cpu())[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# ---------------------------------------------------------------------------
# exports across the packages

def _inputs(name):
    rng = np.random.RandomState(3)
    if name == "mlp":
        return [rng.normal(0, 1, (2, 6)).astype(np.float32)]
    if name == "resnet18_v1":
        return [rng.normal(0, 1, (2, 3, 32, 32)).astype(np.float32)]
    tokens = rng.randint(0, 16 if name == "transformer_lm" else 48,
                         (2, 8)).astype(np.int32)
    if name == "tiny_gluon_lm":
        return [tokens]
    return [tokens, np.tile(np.arange(8, dtype=np.int32), (2, 1))]


def _seeded(name):
    """Both packages' blocks from one seed, initialized and called once;
    the inputs and both outputs."""
    jbuild, tbuild, _ = MODELS[name]
    jmx.random.seed(5)
    tmx.random.seed(5)
    with jmx.name.NameManager(), tmx.name.NameManager():
        jnet, tnet = jbuild(), tbuild()
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize(tmx.init.Xavier())
    xs = _inputs(name)
    want = jnet(*(jmx.nd.array(x, dtype=x.dtype) for x in xs)).asnumpy()
    with torch.no_grad():
        got = tnet(*(torch.from_numpy(x) for x in xs)).numpy()
    return jnet, tnet, xs, want, got


def _export(net, mx, names, prefix):
    """``export`` for one input; for several, the graph over one var each
    and ``collect_params().save``, the JAX package's route for them."""
    if names is None:
        net.export(prefix)
        return
    _trace(net, mx, names).save(prefix + "-symbol.json")
    net.collect_params().save(prefix + "-0000.params")


@pytest.mark.parametrize("name", ["mlp", "resnet18_v1", "transformer_lm",
                                  "tiny_gluon_lm"])
def test_exports_cross_between_the_packages(name, tmp_path):
    jnet, tnet, xs, jax_out, port_out = _seeded(name)
    np.testing.assert_allclose(port_out, jax_out, **HYBRID)
    names = MODELS[name][2] or ("data",)
    _export(tnet, tmx, MODELS[name][2], str(tmp_path / "port"))
    _export(jnet, jmx, MODELS[name][2], str(tmp_path / "jax"))
    assert open(tmp_path / "port-symbol.json").read() == \
        open(tmp_path / "jax-symbol.json").read()
    # the port's files in the JAX package
    jblock = JSymbolBlock.imports(str(tmp_path / "port-symbol.json"),
                                  list(names),
                                  str(tmp_path / "port-0000.params"))
    got = jblock(*(jmx.nd.array(x, dtype=x.dtype) for x in xs)).asnumpy()
    np.testing.assert_allclose(got, port_out, **HYBRID)
    # the JAX package's files in the port, through the block's own
    # CachedOp: one signature for the two calls
    tblock = SymbolBlock.imports(str(tmp_path / "jax-symbol.json"),
                                 list(names),
                                 str(tmp_path / "jax-0000.params"),
                                 ctx=tmx.cpu())
    assert sorted(tblock.collect_params()) == sorted(
        jblock.collect_params())
    for _ in range(2):
        got = tblock(*(torch.from_numpy(x) for x in xs)).numpy()
        np.testing.assert_allclose(got, jax_out, **HYBRID)
    stats = tblock._cached_op.cache_stats()
    assert (len(stats["signatures"]), stats["misses"], stats["hits"]) == \
        (1, 1, 1)
    # not hybridized, the graph runs op by op with no CachedOp
    tblock.hybridize(False)
    got = tblock(*(torch.from_numpy(x) for x in xs)).numpy()
    np.testing.assert_allclose(got, jax_out, **HYBRID)
    assert tblock._cached_op is None


def test_symbol_block_drops_its_executors_when_a_parameter_moves(tmp_path):
    """The block's CachedOp reads each parameter's live tensor: a storage
    swapped under the same parameter (as ``set_data`` of another dtype
    does) shows in the next call with no new signature (on the card the
    swap drops the captures)."""
    _, tnet, xs, _, port_out = _seeded("mlp")
    tnet.export(str(tmp_path / "m"))
    block = SymbolBlock.imports(str(tmp_path / "m-symbol.json"), "data",
                                str(tmp_path / "m-0000.params"),
                                ctx=tmx.cpu())
    np.testing.assert_array_equal(block(torch.from_numpy(xs[0])).numpy(),
                                  port_out)
    block(torch.zeros(5, 6))
    assert len(block._cached_op.cache_stats()["signatures"]) == 2
    param = block.collect_params()[tnet.prefix + "dense1_weight"]
    param.set_data(torch.zeros(3, 8, dtype=torch.float64))
    out = block(torch.from_numpy(xs[0])).numpy()
    assert block._cached_op.cache_stats()["misses"] == 2
    bias = np.broadcast_to(tnet[1].bias.detach().numpy(), out.shape)
    np.testing.assert_array_equal(out, bias)
    with torch.no_grad():
        param._check_and_get().data = torch.ones(3, 8)
    out = block(torch.from_numpy(xs[0])).numpy()
    assert block._cached_op.cache_stats()["misses"] == 2
    assert not np.array_equal(out, bias)
    with pytest.raises(tmx.MXNetError, match="not initialized"):
        SymbolBlock.imports(str(tmp_path / "m-symbol.json"), "data",
                            ctx=tmx.cpu())(torch.from_numpy(xs[0]))


# ---------------------------------------------------------------------------
# serving and checkpoints

def test_exported_model_serves_and_matches(tmp_path):
    jnet, tnet, _, _, _ = _seeded("mlp")
    prefix = str(tmp_path / "m")
    tnet.export(prefix)
    server = serving.ModelServer()
    server.load_exported("m", prefix, input_shapes=[(6,)], max_batch=2,
                         warmup=True, device="cpu")
    x = np.random.RandomState(3).randn(6).astype(np.float32)
    res = server.predict("m", x, timeout_ms=5000)
    snap = server.stats()["models"]["m"]
    server.stop()
    assert res.status == serving.OK
    want = jnet(jmx.nd.array(x[None])).asnumpy()[0]
    np.testing.assert_allclose(res.output, want, rtol=1e-5, atol=1e-5)
    assert snap["cache"]["recompiles"] == snap["warmup"]["cache"]["misses"]


def test_two_input_lm_serves_through_load_exported(tmp_path):
    """The LM's graph over ``data`` and ``pos_idx``, served with one shape
    and one dtype for each input, answers as the JAX package's server does
    from the JAX package's own files."""
    jnet, tnet, _, _, _ = _seeded("transformer_lm")
    names = MODELS["transformer_lm"][2]
    _export(tnet, tmx, names, str(tmp_path / "port"))
    _export(jnet, jmx, names, str(tmp_path / "jax"))
    kw = dict(input_names=names, input_shapes=[((8,), (8,))],
              dtype=("int32", "int32"), max_batch=2)
    rng = np.random.RandomState(4)
    request = (rng.randint(0, 16, 8).astype(np.int32),
               np.arange(8, dtype=np.int32))
    out = {}
    for key, pkg, extra in (("port", serving, dict(device="cpu")),
                            ("jax", jserving, {})):
        server = pkg.ModelServer()
        server.load_exported("lm", str(tmp_path / key), **kw, **extra)
        res = server.predict("lm", request, timeout_ms=10000)
        server.stop()
        assert res.status == "OK", res
        out[key] = res.output
    assert out["port"].shape == (8, 16)
    np.testing.assert_allclose(out["port"], out["jax"], **HYBRID)


def test_load_checkpoint_keeps_batchnorm_statistics_as_aux(tmp_path):
    """``export`` -> ``model.load_checkpoint`` -> ``simple_bind``: the
    running statistics come back as aux states, and the executor's
    forward matches the block's (``tests/test_serialization.py:113-130``)
    and the JAX block's."""
    jnet, tnet, xs, jax_out, port_out = _seeded("resnet18_v1")
    prefix = str(tmp_path / "r18")
    tnet.export(prefix)
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    assert len(sym.list_auxiliary_states()) == len(aux) == 40
    assert all("running" in n for n in aux)
    exe = sym.simple_bind(tmx.cpu(), data=(2, 3, 32, 32), grad_req="null")
    exe.copy_params_from(arg, aux)
    out = exe.forward(is_train=False, data=xs[0])[0].asnumpy()
    np.testing.assert_allclose(out, port_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, jax_out, **HYBRID)
