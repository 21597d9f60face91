"""mxnet_tpu_torch.symbol and the executor on the CPU.

Each case of tests/test_symbol.py's 14 tests runs through both packages,
and the port's result must equal the JAX package's: argument and output
names, inferred shapes, composition, JSON round trips and files, ``eval``,
``bind`` with gradients, ``simple_bind``, internals and groups,
``AttrScope``, arithmetic, and the legacy-JSON upgrade; one more case
holds that a bound executor reads its arrays as they are at each forward
(the port's graph reads them in place).  Values compare
bitwise where the JAX test pins them exactly and at its
``assert_almost_equal`` default otherwise.  Then the graphs of
``example/image-classification/train_mnist.py`` and a BatchNorm convnet:
the same construction writes the same JSON string in both packages, and
each package loads the other's ``-symbol.json`` and infers the same
shapes.
"""
import json
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "image-classification"))
import train_mnist as jax_mnist  # noqa: E402
from mxnet_tpu_torch.models import train_mnist  # noqa: E402

# mxnet_tpu/test_utils.py assert_almost_equal's defaults
RTOL, ATOL = 1e-5, 1e-20


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=8)
    act = sym.Activation(fc1, name="relu1", act_type="relu")
    return sym.FullyConnected(act, name="fc2", num_hidden=4)


def _np(a):
    return np.asarray(a.asnumpy())


def case_list_arguments(pkg, tmp):
    net = _mlp(pkg.sym)
    return net.list_arguments(), net.list_outputs()


def case_compose(pkg, tmp):
    sym = pkg.sym
    data = sym.Variable("data")
    net1 = sym.FullyConnected(data, name="fc1", num_hidden=10)
    net2 = sym.FullyConnected(sym.Variable("data2"), name="fc2",
                              num_hidden=5)
    return net2(data2=net1, name="composed").list_arguments()


def case_infer_shape(pkg, tmp):
    net = _mlp(pkg.sym)
    arg_shapes, out_shapes, aux_shapes = net.infer_shape(data=(4, 16))
    return dict(zip(net.list_arguments(), arg_shapes)), out_shapes, \
        aux_shapes


def case_infer_shape_conv(pkg, tmp):
    sym = pkg.sym
    data = sym.Variable("data")
    conv = sym.Convolution(data, name="conv", kernel=(3, 3), num_filter=6,
                           pad=(1, 1))
    bn = sym.BatchNorm(conv, name="bn")
    arg_shapes, out_shapes, aux_shapes = bn.infer_shape(data=(2, 3, 8, 8))
    return (dict(zip(bn.list_arguments(), arg_shapes)),
            dict(zip(bn.list_auxiliary_states(), aux_shapes)), out_shapes)


def case_json_roundtrip(pkg, tmp):
    net = _mlp(pkg.sym)
    js = net.tojson()
    parsed = json.loads(js)
    net2 = pkg.sym.load_json(js)
    return (sorted(parsed), net2.list_arguments(),
            net2.infer_shape(data=(2, 16))[1])


def case_save_load_file(pkg, tmp):
    net = _mlp(pkg.sym)
    fname = str(tmp / ("%s-symbol.json" % pkg.__name__))
    net.save(fname)
    return pkg.sym.load(fname).list_outputs()


def case_eval(pkg, tmp):
    sym, nd = pkg.sym, pkg.nd
    c = sym.Variable("a") + sym.Variable("b") * 2
    return _np(c.eval(a=nd.ones((2, 2)), b=nd.ones((2, 2)))[0])


def case_bind_backward(pkg, tmp):
    sym, nd = pkg.sym, pkg.nd
    c = sym.Variable("a") * sym.Variable("b")
    ex = c.bind(pkg.cpu(), {"a": nd.array([1.0, 2.0]),
                            "b": nd.array([3.0, 4.0])},
                args_grad={"a": nd.zeros((2,)), "b": nd.zeros((2,))})
    out = _np(ex.forward(is_train=True)[0])
    ex.backward(nd.ones((2,)))
    return out, _np(ex.grad_dict["a"]), _np(ex.grad_dict["b"])


def case_simple_bind(pkg, tmp):
    ex = _mlp(pkg.sym).simple_bind(ctx=pkg.cpu(), data=(4, 16))
    ex.arg_dict["data"][:] = 1.0
    return ex.arg_dict["fc1_weight"].shape, ex.forward()[0].shape


def case_internals_group(pkg, tmp):
    net = _mlp(pkg.sym)
    internals = net.get_internals()
    fc1_out = internals["fc1_output"]
    grp = pkg.sym.Group([net, fc1_out])
    return internals.list_outputs(), fc1_out.list_outputs(), \
        grp.list_outputs()


def case_attr_scope(pkg, tmp):
    with pkg.AttrScope(ctx_group="dev1"):
        v = pkg.sym.Variable("x")
    return v.attr("ctx_group"), v.tojson()


def case_arith_ops(pkg, tmp):
    a = pkg.sym.Variable("a")
    out = (a * 2 + 1) / 2 - 1
    res = out.eval(a=pkg.nd.array([1.0, 3.0]))
    return _np(res[0]), out.list_arguments()


def case_bound_arrays_read_at_each_forward(pkg, tmp):
    """A bound executor reads its arrays as they are at each forward: new
    data (forward's keywords) and weights (``copy_params_from``) written
    into them show in the outputs, and a training forward folds
    BatchNorm's batch statistics into the aux arrays."""
    sym, nd = pkg.sym, pkg.nd
    rng = np.random.RandomState(2)
    bn = sym.BatchNorm(sym.Variable("data"), name="bn", fix_gamma=False)
    ex = sym.FullyConnected(bn, name="fc", num_hidden=3).simple_bind(
        pkg.cpu(), data=(4, 5))

    def draw(*shape):
        return nd.array(rng.randn(*shape).astype(np.float32))

    ex.copy_params_from({n: draw(*ex.arg_dict[n].shape)
                         for n in sorted(ex.arg_dict)},
                        {"bn_moving_mean": draw(5),
                         "bn_moving_var": nd.ones((5,))})
    outs = [_np(ex.forward(is_train=False)[0]),
            _np(ex.forward(is_train=False, data=draw(4, 5))[0])]
    ex.copy_params_from({"fc_weight": draw(3, 5)})
    outs.append(_np(ex.forward(is_train=True)[0]))
    outs.append(_np(ex.forward(is_train=False)[0]))
    return outs, _np(ex.aux_dict["bn_moving_mean"]), \
        _np(ex.aux_dict["bn_moving_var"])


_LEGACY = {
    "nodes": [
        {"op": "null", "name": "data", "param": {}, "inputs": []},
        {"op": "null", "name": "fc_weight", "param": {"lr_mult": "2.0"},
         "inputs": []},
        {"op": "null", "name": "fc_bias", "param": {}, "inputs": []},
        {"op": "FullyConnected", "name": "fc",
         "param": {"num_hidden": "4", "weight_lr_mult": "0.5"},
         "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "null", "name": "bn_gamma", "param": {}, "inputs": []},
        {"op": "null", "name": "bn_beta", "param": {}, "inputs": []},
        # v0.8: no aux (moving_mean / moving_var) inputs stored
        {"op": "BatchNorm", "name": "bn", "param": {},
         "inputs": [[3, 0], [4, 0], [5, 0]]},
    ],
    "heads": [[6, 0]],
}


def case_legacy_json_upgrade(pkg, tmp):
    s = pkg.sym.load_json(json.dumps(_LEGACY))
    ex = s.simple_bind(pkg.cpu(), data=(2, 8))
    out = ex.forward(is_train=False, data=pkg.nd.ones((2, 8)))
    attrs = {n.name: {k: str(v) for k, v in n.attrs.items()}
             for n in s._topo_nodes()}
    return sorted(ex.aux_dict), out[0].shape, attrs, s.list_arguments()


def case_legacy_json_argmax_axis_upgrade(pkg, tmp):
    legacy = {
        "nodes": [
            {"op": "null", "name": "x", "param": {}, "inputs": []},
            {"op": "argmax", "name": "am", "param": {"axis": "-1"},
             "inputs": [[0, 0]]},
        ],
        "heads": [[1, 0]],
        "attrs": {"mxnet_version": ["int", 900]},
    }
    s = pkg.sym.load_json(json.dumps(legacy))
    ex = s.simple_bind(pkg.cpu(), x=(3, 5))
    x = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    out = ex.forward(is_train=False, x=pkg.nd.array(x))
    return _np(out[0]), s.tojson()


CASES = [case_list_arguments, case_compose, case_infer_shape,
         case_infer_shape_conv, case_json_roundtrip, case_save_load_file,
         case_eval, case_bind_backward, case_simple_bind,
         case_internals_group, case_attr_scope, case_arith_ops,
         case_legacy_json_upgrade, case_legacy_json_argmax_axis_upgrade,
         case_bound_arrays_read_at_each_forward]


def _run(pkg, case, tmp):
    with pkg.name.NameManager():
        if pkg is tmx:
            with tmx.cpu():
                return case(pkg, tmp)
        return case(pkg, tmp)


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_symbol_case_matches_the_jax_package(case, tmp_path):
    _same(_run(tmx, case, tmp_path), _run(mx, case, tmp_path))


def _graphs(pkg, mnist):
    sym = pkg.sym
    data = sym.Variable("data")
    conv = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                           name="conv1")
    bn = sym.BatchNorm(conv, name="bn1", fix_gamma=False)
    net = sym.Activation(bn, act_type="relu")
    net = sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(1, 1))
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=10, name="fc")
    return {"mlp": mnist.get_mlp(), "lenet": mnist.get_lenet(),
            "bn_convnet": sym.SoftmaxOutput(net, name="softmax")}


def _both_graphs():
    with mx.name.NameManager():
        jax_graphs = _graphs(mx, jax_mnist)
    with tmx.name.NameManager():
        graphs = _graphs(tmx, train_mnist)
    return jax_graphs, graphs


@pytest.mark.parametrize("name", ["mlp", "lenet", "bn_convnet"])
def test_the_same_construction_writes_the_same_json(name):
    jax_graphs, graphs = _both_graphs()
    assert graphs[name].tojson() == jax_graphs[name].tojson()


@pytest.mark.parametrize("name", ["mlp", "lenet", "bn_convnet"])
def test_each_package_loads_the_others_symbol_file(name, tmp_path):
    jax_graphs, graphs = _both_graphs()
    shape = {"data": (2, 1, 28, 28) if name != "bn_convnet"
             else (2, 3, 8, 8)}
    jax_file = str(tmp_path / "jax-symbol.json")
    port_file = str(tmp_path / "port-symbol.json")
    jax_graphs[name].save(jax_file)
    graphs[name].save(port_file)
    from_jax = tmx.sym.load(jax_file)
    from_port = mx.sym.load(port_file)
    assert from_jax.tojson() == jax_graphs[name].tojson()
    assert from_port.tojson() == graphs[name].tojson()
    for loaded, ref in ((from_jax, jax_graphs[name]),
                        (from_port, graphs[name])):
        assert loaded.list_arguments() == ref.list_arguments()
        assert loaded.list_auxiliary_states() == ref.list_auxiliary_states()
    assert from_jax.infer_shape(**shape) == \
        from_port.infer_shape(**shape) == \
        jax_graphs[name].infer_shape(**shape)
