"""int8 inference in mxnet_tpu_torch against mxnet_tpu on the CPU.

* The eight quantized ops at ResNet-50 stage widths (cut in batch and
  side), in both input layouts (6 inputs without a bias, 9 with), given
  the same inputs: every output bit-equal to the JAX package's.
* ``contrib.quantization.quantize_model`` on
  tests/test_quantize_graph.py's convnet: the symbol's JSON string-equal,
  the quantized params bit-equal, the minmax and entropy thresholds within
  rtol 1e-5 (the calibration forward is fp32, reordered between the
  packages), and the int8 outputs within
  tests/test_quantize_graph.py's bounds of the JAX package's fp32 ones.
* Quantized symbol and int8 ``.params`` files written by each package
  and read back by the other bit for bit.
* ``resnet18_v1`` (10 classes, 16 x 3 x 32 x 32: the JAX test's size),
  seeded and exported by the port and read by both: each package's int8
  forward within the JAX test's bounds of the JAX fp32 forward
  (top-1 agreement >= 0.9, largest logit gap below 0.35 of the largest
  fp32 logit), and the port's int8 logits closer to the JAX package's int8
  logits than those are to its fp32 ones.  The share of equal int8 codes
  at each ``quantize_v2`` is printed.
* ``models/quantize_infer.py`` at tests/test_examples_gluon.py's bounds.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq

_RNG = np.random.RandomState(150)


def _i8(*shape):
    return _RNG.randint(-127, 128, shape).astype(np.int8)


def _r(*values):
    return [np.array([v], np.float32) for v in values]


def _op_calls():
    """(op, inputs, attrs) at ResNet-50's stage widths: a 3 x 3 conv of 64
    channels, a 1 x 1 conv to 256, conv0's 7 x 7 stride 2 from RGB, and
    the 2048 -> 1000 head; batch 2, sides cut to 8 and 16."""
    act = _RNG.uniform(-3, 3, (2, 64, 8, 8)).astype(np.float32)
    x64, x3 = _i8(2, 64, 8, 8), _i8(2, 3, 16, 16)
    rd, rw, rb = _r(-2.5, 3.0), _r(-0.7, 0.4), _r(-0.05, 0.06)
    conv3 = {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64,
             "no_bias": True}
    return [
        ("_contrib_quantize", [act] + rd, {"out_type": "int8"}),
        ("_contrib_quantize", [act] + rd, {"out_type": "uint8"}),
        ("_contrib_quantize_v2", [act], {}),
        ("_contrib_quantize_v2", [act], {"min_calib_range": -2.0,
                                         "max_calib_range": 2.5}),
        ("_contrib_dequantize", [x64] + rd, {}),
        ("_contrib_dequantize", [x64.astype(np.uint8)] + rd, {}),
        ("_contrib_requantize", [_RNG.randint(-2 ** 30, 2 ** 30, (2, 256))
                                 .astype(np.int32)] + rd, {}),
        ("_contrib_quantized_conv", [x64, _i8(64, 64, 3, 3)] + rd + rw,
         conv3),
        ("_contrib_quantized_conv", [x64, _i8(64, 64, 3, 3), _i8(64)]
         + rd + rw + rb, dict(conv3, no_bias=False, stride=(2, 2))),
        ("_contrib_quantized_conv", [x64, _i8(256, 64, 1, 1)] + rd + rw,
         {"kernel": (1, 1), "num_filter": 256, "no_bias": True}),
        ("_contrib_quantized_conv", [x3, _i8(64, 3, 7, 7)] + rd + rw,
         {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
          "num_filter": 64, "no_bias": True}),
        ("_contrib_quantized_fully_connected", [_i8(2, 2048),
                                                _i8(1000, 2048)] + rd + rw,
         {"num_hidden": 1000, "no_bias": True}),
        ("_contrib_quantized_fully_connected", [_i8(2, 2048, 1, 1),
                                                _i8(1000, 2048),
                                                _i8(1000)] + rd + rw + rb,
         {"num_hidden": 1000}),
        ("_contrib_quantized_flatten", [x64] + rd, {}),
        ("_contrib_quantized_pooling", [x64] + rd,
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
        ("_contrib_quantized_pooling", [x64] + rd,
         {"global_pool": True, "kernel": (1, 1), "pool_type": "avg"}),
    ]


def test_quantized_ops_are_bit_equal_to_jax():
    names = set()
    for name, inputs, attrs in _op_calls():
        names.add(name)
        want = getattr(jmx.nd, name)(*[jmx.nd.array(a, dtype=a.dtype)
                                       for a in inputs], **attrs)
        got = getattr(tmx.nd, name)(*[tmx.nd.array(a, ctx=tmx.cpu(),
                                                   dtype=a.dtype)
                                      for a in inputs], **attrs)
        want = want if isinstance(want, list) else [want]
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            g, w = g.asnumpy(), w.asnumpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (name, attrs)
            np.testing.assert_array_equal(g, w, err_msg="%s %s"
                                          % (name, attrs))
    assert len(names) == 8


def _convnet(mx):
    sym = mx.sym
    data = sym.Variable("data")
    h = sym.Convolution(data, name="conv1", kernel=(3, 3), num_filter=8,
                        pad=(1, 1))
    h = sym.Activation(h, act_type="relu", name="relu1")
    h = sym.Flatten(h, name="flat")
    h = sym.FullyConnected(h, name="fc1", num_hidden=10)
    return sym.softmax(h, name="out", axis=1)


_SHAPES = {"conv1_weight": (8, 3, 3, 3), "conv1_bias": (8,),
           "fc1_weight": (10, 512), "fc1_bias": (10,)}


def _quantized(mx, q, mode, values, calib, x):
    """quantize_model of the convnet in package ``mx`` (a fresh name
    scope), and the int8 forward of ``x``."""
    with mx.name.NameManager(), mx.cpu():
        net = _convnet(mx)
        args = {k: mx.nd.array(v) for k, v in values.items()}
        it = None if mode == "none" else mx.io.NDArrayIter(
            calib, np.zeros(len(calib), np.float32), batch_size=4)
        qsym, qargs, qaux = q.quantize_model(
            net, args, {}, calib_mode=mode, calib_data=it,
            num_calib_examples=None if it is None else len(calib))
        exe = qsym.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
        exe.copy_params_from(qargs, qaux)
        out = exe.forward(is_train=False, data=mx.nd.array(x))[0].asnumpy()
    return qsym, qargs, out


@pytest.mark.parametrize("mode", ["none", "naive", "entropy"])
def test_quantize_model_matches_jax(mode):
    rng = np.random.RandomState(2)
    values = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for k, s in _SHAPES.items()}
    calib = rng.uniform(-1, 1, (16, 3, 8, 8)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
    jsym, jargs, jout = _quantized(jmx, jq, mode, values, calib, x)
    tsym, targs, tout = _quantized(tmx, tq, mode, values, calib, x)
    if mode == "entropy":
        # thresholds from fp32 calibration forwards, within rtol 1e-5: the
        # graphs are equal once each node's thresholds are
        for jn, tn in zip(jsym._topo_nodes(), tsym._topo_nodes()):
            assert jn.name == tn.name and jn.op == tn.op
            for k in ("min_calib_range", "max_calib_range"):
                if k in jn.attrs:
                    np.testing.assert_allclose(tn.attrs[k], jn.attrs[k],
                                               rtol=1e-5)
                    tn.attrs[k] = jn.attrs[k]
    assert tsym.tojson() == jsym.tojson()
    assert sorted(targs) == sorted(jargs)
    for k in jargs:
        got, want = targs[k].asnumpy(), jargs[k].asnumpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the JAX test's bounds against the JAX package's fp32 forward
    want = _fp32_convnet(values, x)
    tol = 0.1 if mode == "naive" else 0.35
    if mode == "none":
        tol = 0.05
    for out in (jout, tout):
        assert np.abs(out - want).max() < tol
        assert (out.argmax(1) == want.argmax(1)).all()
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-6)


def _fp32_convnet(values, x):
    net = _convnet(jmx)
    exe = net.simple_bind(jmx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from({k: jmx.nd.array(v) for k, v in values.items()})
    return exe.forward(is_train=False, data=jmx.nd.array(x))[0].asnumpy()


def test_int8_files_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(3)
    values = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for k, s in _SHAPES.items()}
    x = rng.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    outs = {}
    for tag, mx, q in (("jax", jmx, jq), ("port", tmx, tq)):
        qsym, qargs, outs[tag] = _quantized(mx, q, "none", values, None, x)
        qsym.save(str(tmp_path / ("%s-symbol.json" % tag)))
        mx.nd.save(str(tmp_path / ("%s-0000.params" % tag)),
                   {"arg:" + k: v for k, v in qargs.items()})
    for tag, other in (("jax", "port"), ("port", "jax")):
        assert open(tmp_path / ("%s-symbol.json" % tag)).read() == \
            open(tmp_path / ("%s-symbol.json" % other)).read()
    # each package reads the other's files: the same int8 arrays, and the
    # int8 forward of its own
    for mx, reader_tag, writer in ((jmx, "jax", "port"),
                                   (tmx, "port", "jax")):
        with mx.cpu():
            sym, args, aux = mx.model.load_checkpoint(
                str(tmp_path / writer), 0)
            mine = mx.nd.load(str(tmp_path / ("%s-0000.params"
                                              % reader_tag)))
            for k, v in args.items():
                want = mine["arg:" + k].asnumpy()
                assert v.asnumpy().dtype == want.dtype, k
                np.testing.assert_array_equal(v.asnumpy(), want, err_msg=k)
            exe = sym.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
            exe.copy_params_from(args, aux)
            got = exe.forward(is_train=False,
                              data=mx.nd.array(x))[0].asnumpy()
        np.testing.assert_allclose(got, outs[reader_tag], rtol=0, atol=1e-6)


def _codes(mx, qsym, qargs, qaux, x):
    """The int8 codes of every quantize_v2 node of ``qsym`` on ``x``."""
    nodes = [n for n in qsym._topo_nodes() if n.op == "_contrib_quantize_v2"]
    group = mx.sym.Group([type(qsym)([(n, 0)]) for n in nodes])
    exe = group.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from(qargs, qaux, allow_extra_params=True)
    outs = exe.forward(is_train=False, data=mx.nd.array(x))
    return [n.name for n in nodes], [o.asnumpy() for o in outs]


def test_resnet18_int8_matches_jax(tmp_path):
    import torch
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.RandomState(0)
    # the port's seeded weights are the JAX package's, bit for bit
    # (tests/test_torch_random_init.py); its export is read by both
    tmx.random.seed(0)
    with tmx.name.NameManager():
        net = vision.get_model("resnet18_v1", classes=10, device="cpu")
    net.initialize(tmx.init.Xavier())
    with torch.no_grad():
        net(torch.zeros(1, 3, 32, 32))
    prefix = str(tmp_path / "r18")
    net.export(prefix)
    x = rng.uniform(-1, 1, (16, 3, 32, 32)).astype(np.float32)
    calib = rng.uniform(-1, 1, (16, 3, 32, 32)).astype(np.float32)
    res = {}
    for tag, mx, q in (("jax", jmx, jq), ("port", tmx, tq)):
        with mx.cpu():
            s, args, aux = mx.model.load_checkpoint(prefix, 0)
            if tag == "jax":
                fp_exe = s.simple_bind(mx.cpu(), data=x.shape,
                                       grad_req="null")
                fp_exe.copy_params_from(args, aux)
                res["fp32"] = fp_exe.forward(
                    is_train=False, data=mx.nd.array(x))[0].asnumpy()
            it = mx.io.NDArrayIter(calib, np.zeros(16, np.float32), 16)
            qsym, qargs, qaux = q.quantize_model(s, args, aux,
                                                 calib_data=it,
                                                 calib_mode="minmax")
            exe = qsym.simple_bind(mx.cpu(), data=x.shape, grad_req="null")
            exe.copy_params_from(qargs, qaux)
            res[tag] = exe.forward(is_train=False,
                                   data=mx.nd.array(x))[0].asnumpy()
            res[tag + "_codes"] = _codes(mx, qsym, qargs, qaux, x)
    want = res["fp32"]
    scale = np.abs(want).max() + 1e-6
    for tag in ("jax", "port"):
        agree = (res[tag].argmax(1) == want.argmax(1)).mean()
        gap = np.abs(res[tag] - want).max() / scale
        assert agree >= 0.9 and gap < 0.35, (tag, agree, gap)
    jax_gap = np.abs(res["jax"] - want).max()
    port_gap = np.abs(res["port"] - res["jax"]).max()
    names, jcodes = res["jax_codes"]
    _, tcodes = res["port_codes"]
    shares = {n: float((j == t).mean()) for n, j, t in
              zip(names, jcodes, tcodes)}
    print("int8 logits: port vs jax %.3g, jax int8 vs fp32 %.3g; equal "
          "codes at each quantize_v2: %s" % (port_gap, jax_gap, shares))
    assert port_gap < jax_gap


def test_quantize_infer_example_keeps_accuracy(capsys):
    from mxnet_tpu_torch.models import quantize_infer
    fp_acc, q_acc, agree = quantize_infer.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("fp32 accuracy: ") and "top-1 agreement" in line
    assert fp_acc > 0.9
    assert q_acc > fp_acc - 0.1
    assert agree > 0.9
