"""mxnet_tpu_torch's ``gluon.rnn`` layers and cells and
``gluon.contrib.rnn``'s cells against mxnet_tpu on the CPU.

Both packages build each block under a fresh name manager after one
``mx.random.seed``, so they draw the same weights; inputs come from a
seeded ``numpy.random.RandomState``.  Values and input gradients are held
to ``tests/test_rnn.py``'s rtol 1e-4 / atol 1e-5, with dropout, zoneout
and variational dropout drawing the JAX package's masks under one seed.
A Gluon LSTM model traced to ``mx.sym`` writes the JAX package's graph
JSON string for string.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_rnn.py:129,295-297,378


def _pair(build, seed=1, init="xavier"):
    """``build(package)`` in each package from one seed, initialized."""
    nets = []
    for package in (jmx, tmx):
        package.random.seed(seed)
        with package.name.NameManager():
            if package is tmx:
                with tmx.cpu():
                    net = build(package)
            else:
                net = build(package)
        net.initialize(package.init.Xavier() if init == "xavier" else None,
                       **({"ctx": tmx.cpu()} if package is tmx else {}))
        nets.append(net)
    return nets


def _nd(package, a):
    return package.nd.array(a, **({"ctx": tmx.cpu()} if package is tmx
                                  else {}))


def _grads(net):
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


LAYERS = {
    "lstm_bi_dropout": lambda m: m.gluon.rnn.LSTM(
        6, num_layers=2, dropout=0.4, bidirectional=True),
    "gru_ntc": lambda m: m.gluon.rnn.GRU(6, num_layers=2, layout="NTC"),
    "rnn_tanh": lambda m: m.gluon.rnn.RNN(6, activation="tanh"),
    "rnn_relu_bi": lambda m: m.gluon.rnn.RNN(5, num_layers=2,
                                             bidirectional=True),
}


def _run_layer(package, net, x, with_states, head, seed, hybrid):
    package.random.seed(seed)
    if hybrid:
        net.hybridize()
    xs = _nd(package, x)
    xs.attach_grad()
    batch = x.shape[net._layout.find("N")]
    with package.autograd.record():
        if with_states:
            kw = {"ctx": tmx.cpu()} if package is tmx else {}
            states = net.begin_state(batch, **kw)
            out, new = net(xs, states)
            total = (out * _nd(package, head)).sum() + sum(
                (s * s).sum() for s in new)
        else:
            out = net(xs)
            new = []
            total = (out * _nd(package, head)).sum()
    total.backward()
    return (out.asnumpy(), [s.asnumpy() for s in new], xs.grad.asnumpy(),
            _grads(net))


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rnn_layers_match_jax(name, hybrid):
    """Seeded weights are the JAX layer's bit for bit; outputs, new states
    and the gradients of the input and every weight agree in training,
    eagerly and hybridized (through the CachedOp, without states, as the
    JAX package's CachedOp takes them)."""
    jnet, tnet = _pair(LAYERS[name])
    rng = np.random.RandomState(2)
    layout = tnet._layout
    x = rng.uniform(-1, 1, (5, 3, 4) if layout == "TNC" else (3, 5, 4))
    x = x.astype(np.float32)
    width = tnet._hidden_size * tnet._dir
    head = rng.normal(0, 1, x.shape[:2] + (width,)).astype(np.float32)
    with_states = not hybrid
    want = _run_layer(jmx, jnet, x, with_states, head, 3, hybrid)
    got = _run_layer(tmx, tnet, x, with_states, head, 3, hybrid)
    jp = {k: v.data().asnumpy() for k, v in jnet.collect_params().items()}
    tp = {k: v.data().asnumpy() for k, v in tnet.collect_params().items()}
    assert list(tp) == list(jp)
    _close(got[0], want[0], "output")
    for g, w in zip(got[1], want[1]):
        _close(g, w, "state")
    _close(got[2], want[2], "input grad")
    assert sorted(got[3]) == sorted(want[3])
    for k in want[3]:
        _close(got[3][k], want[3][k], k)


def test_hybridized_layer_with_states_runs_and_equals_eager():
    """A divergence: the port's hybridized layer takes explicit begin
    states (as inputs of its CachedOp) where the JAX package's raises once
    its CachedOp is built (it takes no list).  The result is the eager
    call's."""
    with tmx.cpu():
        tmx.random.seed(0)
        net = tmx.gluon.rnn.LSTM(4, num_layers=2)
        net.initialize()
        x = tmx.nd.array(np.random.RandomState(0).uniform(
            -1, 1, (3, 2, 5)).astype(np.float32))
        states = net.begin_state(2)
        out, new = net(x, states)
        net.hybridize()
        hout, hnew = net(x, states)
    np.testing.assert_array_equal(hout.asnumpy(), out.asnumpy())
    for a, b in zip(hnew, new):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert net._cached_op is not None
    jmx.random.seed(0)
    jnet = jmx.gluon.rnn.LSTM(4, num_layers=2)
    jnet.initialize()
    jnet.hybridize()
    jx, js = jmx.nd.array(x.asnumpy()), jnet.begin_state(2)
    jnet(jx, js)   # eager: the call that settles the deferred shapes
    with pytest.raises(AttributeError):
        jnet(jx, js)


def test_layer_state_shape_and_symbol_checks_as_jax():
    """A wrong state shape raises ValueError; tracing to a Symbol without
    begin states raises ValueError, in both packages."""
    for package in (jmx, tmx):
        with tmx.cpu():
            net = package.gluon.rnn.GRU(4)
            net.initialize()
            x = _nd(package, np.zeros((3, 2, 5), np.float32))
            bad = _nd(package, np.zeros((1, 3, 4), np.float32))
            with pytest.raises(ValueError):
                net(x, [bad])
            with pytest.raises(ValueError):
                net(package.sym.var("data"))


# ---------------------------------------------------------------------------
# cells

def _cells(m, kind):
    r = m.gluon.rnn
    if kind == "lstm":
        return r.LSTMCell(6)
    if kind == "gru":
        return r.GRUCell(6)
    if kind == "rnn":
        return r.RNNCell(6, activation="relu")
    if kind == "stack":
        s = r.SequentialRNNCell()
        with s.name_scope():
            s.add(r.LSTMCell(6))
            s.add(r.DropoutCell(0.3))
            s.add(r.ResidualCell(r.GRUCell(6)))
            s.add(r.ZoneoutCell(r.RNNCell(6), zoneout_outputs=0.3,
                                zoneout_states=0.2))
        return s
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(5), r.GRUCell(5))
    c = m.gluon.contrib.rnn
    if kind == "lstmp":
        return c.LSTMPCell(8, 3)
    if kind == "vardrop":
        return c.VariationalDropoutCell(r.LSTMCell(6), drop_inputs=0.3,
                                        drop_states=0.2, drop_outputs=0.4)
    raise KeyError(kind)


CELLS = ["lstm", "gru", "rnn", "stack", "bidirectional", "lstmp", "vardrop"]


def _unroll(package, cell, x, merge, valid, seed):
    package.random.seed(seed)
    xs = _nd(package, x)
    xs.attach_grad()
    with package.autograd.record():
        outs, states = cell.unroll(
            x.shape[1], xs, layout="NTC", merge_outputs=merge,
            valid_length=None if valid is None else _nd(package, valid))
        merged = outs if merge else package.nd.stack(*outs, axis=1)
        total = (merged * merged).sum() + sum((s * s).sum() for s in states)
    total.backward()
    return (merged.asnumpy(), [s.asnumpy() for s in states],
            xs.grad.asnumpy(), _grads(cell))


@pytest.mark.parametrize("kind", CELLS)
def test_cells_unroll_as_jax(kind):
    """``unroll`` in training, merged (and, for the LSTM and bidirectional
    cells, per step), with ``valid_length`` where the cell takes it:
    outputs, final states and the gradients of the input and every
    weight."""
    jcell, tcell = _pair(lambda m: _cells(m, kind))
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 4, 5)).astype(np.float32)
    valid = np.array([4, 2], np.float32) if kind in ("lstm", "gru") \
        else None
    ways = ((True, 7), (False, 8)) if kind in ("lstm", "bidirectional") \
        else ((True, 7),)
    for merge, seed in ways:
        jcell.reset()
        tcell.reset()
        want = _unroll(jmx, jcell, x, merge, valid, seed)
        got = _unroll(tmx, tcell, x, merge, valid, seed)
        _close(got[0], want[0], "outputs")
        assert len(got[1]) == len(want[1])
        for g, w in zip(got[1], want[1]):
            _close(g, w, "state")
        _close(got[2], want[2], "input grad")
        assert sorted(got[3]) == sorted(want[3])
        for k in want[3]:
            _close(got[3][k], want[3][k], k)
        for c in (jcell, tcell):
            for p in c.collect_params().values():
                p.zero_grad()


def test_cell_step_and_begin_state_as_jax():
    """One step by hand from ``begin_state``, with tensors too."""
    jcell, tcell = _pair(lambda m: m.gluon.rnn.LSTMCell(4))
    x = np.random.RandomState(5).uniform(-1, 1, (3, 2)).astype(np.float32)
    jo, js = jcell(jmx.nd.array(x), jcell.begin_state(batch_size=3))
    with tmx.cpu():
        to, ts = tcell(tmx.nd.array(x), tcell.begin_state(batch_size=3))
        tt, _ = tcell(torch.from_numpy(x), [s._data for s in ts])
    _close(to.asnumpy(), jo.asnumpy())
    assert isinstance(tt, torch.Tensor)
    for g, w in zip(ts, js):
        _close(g.asnumpy(), w.asnumpy())
    with pytest.raises(NotImplementedError):
        tmx.gluon.rnn.BidirectionalCell(tmx.gluon.rnn.LSTMCell(
            2, device="cpu"), tmx.gluon.rnn.LSTMCell(2, device="cpu"))(
            to, ts)


CONV = [("Conv2DLSTMCell", (4, 6, 6), 2), ("Conv2DGRUCell", (4, 6, 6), 1),
        ("Conv1DRNNCell", (3, 8), 1), ("Conv3DLSTMCell", (2, 4, 4, 4), 2)]


@pytest.mark.parametrize("name,shape,nstates", CONV)
def test_conv_rnn_cells_match_jax(name, shape, nstates):
    jcell, tcell = _pair(lambda m: getattr(m.gluon.contrib.rnn, name)(
        input_shape=shape, hidden_channels=3, i2h_kernel=3, h2h_kernel=3,
        i2h_pad=1))
    rng = np.random.RandomState(6)
    xs = [rng.uniform(-1, 1, (2,) + shape).astype(np.float32)
          for _ in range(3)]
    results = []
    for package, cell in ((jmx, jcell), (tmx, tcell)):
        outs, states = cell.unroll(3, [_nd(package, x) for x in xs],
                                   merge_outputs=False)
        assert len(states) == nstates
        results.append([o.asnumpy() for o in outs]
                       + [s.asnumpy() for s in states])
    for g, w in zip(results[1], results[0]):
        assert g.shape == w.shape
        _close(g, w)


# ---------------------------------------------------------------------------
# a Gluon LSTM model: traced to mx.sym, and loaded from the JAX weights

def _lstm_model(m):
    class LSTMModel(m.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = m.gluon.nn.Embedding(20, 6)
                self.lstm = m.gluon.rnn.LSTM(5, num_layers=2, layout="NTC",
                                             input_size=6, dropout=0.2)
                self.out = m.gluon.nn.Dense(20, flatten=False)

        def hybrid_forward(self, F, x):
            e = self.embed(x)
            h = F._rnn_state_like(e, shape=(2, 0, 5), ref_axis=0)
            c = F._rnn_state_like(e, shape=(2, 0, 5), ref_axis=0)
            y, _ = self.lstm(e, [h, c])
            return self.out(y)
    return LSTMModel()


def test_lstm_model_exports_the_jax_packages_json(tmp_path):
    """The model's first call settles its deferred shapes and agrees with
    the JAX model's (in prediction); ``export`` then writes the JAX
    package's graph JSON."""
    jnet, tnet = _pair(_lstm_model)
    x = np.random.RandomState(7).randint(0, 20, (2, 3)).astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tnet(tmx.nd.array(x)).asnumpy()
    _close(got, want)
    jnet.export(str(tmp_path / "jax"))
    tnet.export(str(tmp_path / "port"))
    assert open(tmp_path / "port-symbol.json").read() == \
        open(tmp_path / "jax-symbol.json").read()


@pytest.mark.parametrize("kind", ["layer", "cell"])
def test_convert_loads_the_jax_weights(kind):
    """``convert.load_mxnet_params`` fills a layer's per-layer
    ``l{k}_i2h_weight`` arrays, or a cell's, from the JAX block's."""
    from mxnet_tpu_torch import convert
    build = (lambda m: m.gluon.rnn.GRU(4, num_layers=2, bidirectional=True)) \
        if kind == "layer" else (lambda m: m.gluon.rnn.LSTMCell(4))
    jmx.random.seed(2)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(8).uniform(-1, 1, (3, 2, 5)).astype(
        np.float32)
    if kind == "layer":
        want = jnet(jmx.nd.array(x)).asnumpy()
    else:
        want = jnet.unroll(3, jmx.nd.array(x), layout="TNC",
                           merge_outputs=True)[0].asnumpy()
    arrays = {k: v.data().asnumpy() for k, v in
              jnet.collect_params().items()}
    tmx.random.seed(99)
    with tmx.cpu():
        tnet = build(tmx)
        tnet.initialize()
        convert.load_mxnet_params(tnet, arrays)
        if kind == "layer":
            got = tnet(tmx.nd.array(x)).asnumpy()
        else:
            got = tnet.unroll(3, tmx.nd.array(x), layout="TNC",
                              merge_outputs=True)[0].asnumpy()
    _close(got, want)
