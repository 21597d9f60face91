"""mxnet_tpu_torch's fused ``RNN`` op, ``mx.rnn`` and ``rnn.io`` against
mxnet_tpu on the CPU.

Inputs and weights come from a seeded ``numpy.random.RandomState`` and
reach both packages as the same arrays, and both packages' RNGs are
seeded alike.  The bounds are the JAX package's own:
``tests/test_rnn.py``'s rtol 1e-4 / atol 1e-5 for values and gradients,
and its rtol 1e-6 for the checkpoint round trip.  Dropout between layers
draws the JAX op's masks bit for bit under one seed, so the outputs agree
to the same bound with ``p = 0.5`` in training.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-4, atol=1e-5)       # tests/test_rnn.py:129
CKPT_RTOL = 1e-6                       # tests/test_rnn.py:230
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
T, B, I, H, L = 4, 2, 3, 5, 2


def _blob_size(mode, bidirectional, input_size=I, hidden=H, layers=L):
    g = {"lstm": 4, "gru": 3}.get(mode, 1)
    d = 2 if bidirectional else 1
    total, ins = 0, input_size
    for _ in range(layers):
        total += d * (g * hidden * ins + g * hidden * hidden)
        ins = hidden * d
    return total + 2 * layers * d * g * hidden


def _op_inputs(mode, bidirectional, seed):
    rng = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    ins = [rng.uniform(-1, 1, (T, B, I)),
           rng.uniform(-0.5, 0.5, (_blob_size(mode, bidirectional),)),
           rng.uniform(-0.5, 0.5, (L * d, B, H))]
    if mode == "lstm":
        ins.append(rng.uniform(-0.5, 0.5, (L * d, B, H)))
    return [a.astype(np.float32) for a in ins]


def _run_op(package, inputs, heads, attrs, training, seed):
    """Outputs and input gradients of ``nd.RNN`` under head gradients."""
    package.random.seed(seed)
    kw = {"ctx": tmx.cpu()} if package is tmx else {}
    arrays = [package.nd.array(a, **kw) for a in inputs]
    for a in arrays:
        a.attach_grad()
    with package.autograd.record(train_mode=training):
        outs = package.nd.RNN(*arrays, **attrs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    package.autograd.backward(list(outs), [package.nd.array(h, **kw)
                                           for h in heads])
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrays])


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax_values_and_gradients(mode, bidirectional):
    """Two layers with ``state_outputs``: the output, the final states and
    the gradients of data, parameters and states."""
    attrs = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
                 mode=mode, state_outputs=True)
    inputs = _op_inputs(mode, bidirectional, 7)
    rng = np.random.RandomState(8)
    d = 2 if bidirectional else 1
    shapes = [(T, B, d * H)] + [(L * d, B, H)] * (2 if mode == "lstm" else 1)
    heads = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    want, want_g = _run_op(jmx, inputs, heads, attrs, False, 0)
    got, got_g = _run_op(tmx, inputs, heads, attrs, False, 0)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_dropout_masks_are_the_jax_packages(mode):
    """``p = 0.5`` between layers in training, under one seed: the port
    draws the JAX op's masks, so outputs and gradients agree; a zero in
    the layer below's mask shows as the same zero gradient path."""
    attrs = dict(state_size=H, num_layers=3, mode=mode, p=0.5,
                 state_outputs=False)
    rng = np.random.RandomState(3)
    blob = _blob_size(mode, False, layers=3)
    inputs = [rng.uniform(-1, 1, (T, B, I)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (blob,)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (3, B, H)).astype(np.float32)]
    if mode == "lstm":
        inputs.append(np.zeros((3, B, H), np.float32))
    heads = [rng.normal(0, 1, (T, B, H)).astype(np.float32)]
    want, want_g = _run_op(jmx, inputs, heads, attrs, True, 11)
    got, got_g = _run_op(tmx, inputs, heads, attrs, True, 11)
    for g, w in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(g, w, **TOL)
    # a different seed draws different masks (the draw is live)
    other, _ = _run_op(tmx, inputs, heads, attrs, True, 12)
    assert not np.allclose(other[0], got[0])
    # and in prediction no mask is drawn at all
    pred, _ = _run_op(tmx, inputs, heads, attrs, False, 11)
    plain, _ = _run_op(tmx, inputs, heads, dict(attrs, p=0.0), True, 11)
    np.testing.assert_array_equal(pred[0], plain[0])


def test_rnn_op_output_count_and_missing_state_cell():
    """1, 2 or 3 outputs as the registered rule counts them, and an LSTM
    without ``state_cell`` starts from zeros."""
    from mxnet_tpu.ops.registry import get_op as jget
    from mxnet_tpu_torch.ops.registry import get_op as tget
    for attrs in ({}, {"state_outputs": True},
                  {"state_outputs": True, "mode": "gru"},
                  {"state_outputs": False, "mode": "gru"}):
        assert tget("RNN").n_outputs(attrs) == jget("RNN").n_outputs(attrs)
    x, w, h, c = _op_inputs("lstm", False, 5)
    c[:] = 0
    with tmx.cpu():
        full = tmx.nd.RNN(*[tmx.nd.array(a) for a in (x, w, h, c)],
                          state_size=H, num_layers=L, mode="lstm")
        none = tmx.nd.invoke("RNN", [tmx.nd.array(a) for a in (x, w, h)],
                             {"state_size": H, "num_layers": L,
                              "mode": "lstm"})
    np.testing.assert_array_equal(full.asnumpy(), none.asnumpy())


def test_rnn_state_like_matches_jax():
    ref = np.zeros((3, 7, 2), np.float32)
    want = jmx.nd._rnn_state_like(jmx.nd.array(ref), shape=(2, 0, 5),
                                  ref_axis=1)
    with tmx.cpu():
        got = tmx.nd._rnn_state_like(tmx.nd.array(ref), shape=(2, 0, 5),
                                     ref_axis=1)
    assert got.shape == want.shape == (2, 7, 5)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# ---------------------------------------------------------------------------
# mx.rnn: the symbolic cells

def _bind(package, out, shapes, args):
    exe = out.simple_bind(ctx=package.cpu(), grad_req="write", **shapes)
    for name, arr in exe.arg_dict.items():
        arr[:] = args[name]
    return exe


def _legacy_stack(package, kind):
    r = package.rnn
    if kind == "fused_lstm":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="f_")
    if kind == "fused_bi_gru":
        return r.FusedRNNCell(H, num_layers=2, mode="gru",
                              bidirectional=True, prefix="f_")
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.GRUCell(H, prefix="r_"))
    stack = r.SequentialRNNCell()
    stack.add(r.LSTMCell(H, prefix="a_"))
    stack.add(r.DropoutCell(0.5, prefix="do_"))
    stack.add(r.ResidualCell(r.GRUCell(H, prefix="b_")))
    stack.add(r.RNNCell(H, activation="relu", prefix="c_"))
    return stack


@pytest.mark.parametrize("kind", ["stack", "fused_lstm", "fused_bi_gru",
                                  "bidirectional"])
def test_legacy_cells_match_jax_values_and_gradients(kind):
    """The unrolled graphs of both packages, bound on the same arrays:
    outputs, and the gradients of every argument under seeded heads, in
    training (the DropoutCell's masks drawn under one seed)."""
    rng = np.random.RandomState(21)
    x = rng.uniform(-1, 1, (B, T, I)).astype(np.float32)
    outs, args, heads = {}, None, None
    for package in (jmx, tmx):
        package.random.seed(4)
        with package.name.NameManager():
            cell = _legacy_stack(package, kind)
            out, _ = cell.unroll(T, package.sym.Variable("data"),
                                 merge_outputs=True)
        arg_shapes, out_shapes, _ = out.infer_shape(data=(B, T, I))
        names = out.list_arguments()
        if args is None:
            args = {n: (x if n == "data" else
                        rng.uniform(-0.5, 0.5, s).astype(np.float32))
                    for n, s in zip(names, arg_shapes)}
            heads = rng.normal(0, 1, out_shapes[0]).astype(np.float32)
        exe = _bind(package, out, {"data": (B, T, I)}, args)
        kw = {"ctx": tmx.cpu()} if package is tmx else {}
        y = exe.forward(is_train=True)[0].asnumpy()
        exe.backward([package.nd.array(heads, **kw)])
        outs[package] = (y, {n: g.asnumpy() for n, g in exe.grad_dict.items()
                             if g is not None})
    (want, want_g), (got, got_g) = outs[jmx], outs[tmx]
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(got_g) == sorted(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n], want_g[n], err_msg=n, **TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_fused_cell_equals_its_unfused_stack_in_both_packages(bidirectional):
    """``FusedRNNCell`` against ``unfuse()`` over ``unpack_weights`` and
    the stack's ``pack_weights``, in each package, and the port's outputs
    against the JAX package's."""
    rng = np.random.RandomState(42)
    x = rng.uniform(-1, 1, (B, T, I)).astype(np.float32)
    results = []
    blob = None
    for package in (jmx, tmx):
        with package.name.NameManager():
            fused = package.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                             bidirectional=bidirectional,
                                             prefix="lstm_")
            fo, _ = fused.unroll(T, package.sym.Variable("data"),
                                 merge_outputs=True)
            stack = fused.unfuse()
            uo, _ = stack.unroll(T, package.sym.Variable("data"),
                                 merge_outputs=True)
        n = fo.infer_shape(data=(B, T, I))[0][fo.list_arguments().index(
            "lstm_parameters")][0]
        if blob is None:
            blob = rng.uniform(-0.5, 0.5, (n,)).astype(np.float32)
        fexe = _bind(package, fo, {"data": (B, T, I)},
                     {"data": x, "lstm_parameters": blob})
        kw = {"ctx": tmx.cpu()} if package is tmx else {}
        packed = {"lstm_parameters": package.nd.array(blob, **kw)}
        repacked = stack.pack_weights(fused.unpack_weights(packed))
        args = {k: v.asnumpy() for k, v in repacked.items()}
        args["data"] = x
        uexe = _bind(package, uo, {"data": (B, T, I)}, args)
        f = fexe.forward()[0].asnumpy()
        u = uexe.forward()[0].asnumpy()
        np.testing.assert_allclose(f, u, **TOL)
        results.append(f)
    np.testing.assert_allclose(results[1], results[0], **TOL)


def _pack_case(package, kind):
    kw = {"ctx": tmx.cpu()} if package is tmx else {}
    r = package.rnn
    if kind == "fused_bi_gru":
        cell = r.FusedRNNCell(4, num_layers=2, mode="gru",
                              bidirectional=True, prefix="c_")
        shapes = {"c_parameters": (_blob_size("gru", True, 3, 4),)}
    else:
        g = 4 if kind == "lstm" else 3
        cell = (r.LSTMCell if kind == "lstm" else r.GRUCell)(4, prefix="c_")
        shapes = {"c_i2h_weight": (g * 4, 3), "c_i2h_bias": (g * 4,),
                  "c_h2h_weight": (g * 4, 4), "c_h2h_bias": (g * 4,)}
    rs = np.random.RandomState(9)
    args = {k: package.nd.array(rs.uniform(-1, 1, s).astype(np.float32),
                                **kw) for k, s in sorted(shapes.items())}
    unpacked = cell.unpack_weights(args)
    packed = cell.pack_weights(unpacked)
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in unpacked.items()},
            {k: v.asnumpy() for k, v in packed.items()})


@pytest.mark.parametrize("kind", ["lstm", "gru", "fused_bi_gru"])
def test_pack_and_unpack_weights_match_jax(kind):
    """The per-gate arrays of ``unpack_weights`` are the JAX package's bit
    for bit, and ``pack_weights`` gives back the arrays it started from."""
    args, tu, tp = _pack_case(tmx, kind)
    _, ju, jp = _pack_case(jmx, kind)
    assert sorted(tu) == sorted(ju)
    for k in ju:
        np.testing.assert_array_equal(tu[k], ju[k])
    for k, v in args.items():
        np.testing.assert_array_equal(tp[k], v)
        if kind != "fused_bi_gru":
            np.testing.assert_array_equal(jp[k], v)


def test_fused_pack_weights_fills_the_weights_where_the_jax_package_does_not():
    """A divergence: the JAX package's ``FusedRNNCell.pack_weights``
    writes each weight matrix through a reshaped slice of a fresh NDArray,
    which does not write back, so its blob keeps zeros where the weights go
    and only the biases land.  The port's packs every array: pack is the
    inverse of unpack, as in MXNet."""
    args, _, tp = _pack_case(tmx, "fused_bi_gru")
    _, _, jp = _pack_case(jmx, "fused_bi_gru")
    blob = args["c_parameters"]
    n_bias = 2 * 2 * 2 * 3 * 4
    np.testing.assert_array_equal(tp["c_parameters"], blob)
    np.testing.assert_array_equal(jp["c_parameters"][-n_bias:],
                                  blob[-n_bias:])
    assert not jp["c_parameters"][:-n_bias].any()


def _checkpoint_cell(package, fused):
    with package.name.NameManager():
        cell = package.rnn.FusedRNNCell(4, num_layers=2, prefix="lstm_")
        out, _ = cell.unroll(2, package.sym.Variable("data"),
                             merge_outputs=True)
    return (cell if fused else cell.unfuse()), out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rnn_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A fused cell's checkpoint, saved unpacked by one package, is read by
    the other and packed again for its cells within rtol 1e-6: the port
    reads into a FusedRNNCell, the JAX package into the unfused stack (its
    fused pack keeps zeros, see above)."""
    writer, reader = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    rng = np.random.RandomState(1)
    blob = rng.uniform(-1, 1, (_blob_size("lstm", False, 3, 4),)).astype(
        np.float32)
    prefix = str(tmp_path / "ck")
    kw = {"ctx": tmx.cpu()} if writer is tmx else {}
    cell, out = _checkpoint_cell(writer, True)
    writer.rnn.save_rnn_checkpoint(
        cell, prefix, 1, out, {"lstm_parameters": writer.nd.array(blob, **kw)},
        {})
    rcell, _ = _checkpoint_cell(reader, reader is tmx)
    with tmx.cpu():
        sym, args, aux = reader.rnn.load_rnn_checkpoint(rcell, prefix, 1)
    if reader is tmx:
        np.testing.assert_allclose(args["lstm_parameters"].asnumpy(), blob,
                                   rtol=CKPT_RTOL)
    else:
        cell, _ = _checkpoint_cell(tmx, True)
        want = cell.unfuse().pack_weights(
            cell.unpack_weights({"lstm_parameters": tmx.nd.array(
                blob, ctx=tmx.cpu())}))
        assert sorted(args) == sorted(want)
        for k in want:
            np.testing.assert_allclose(args[k].asnumpy(),
                                       want[k].asnumpy(), rtol=CKPT_RTOL)
    assert sym.list_arguments() == out.list_arguments()
    assert aux == {}


def test_lstm_cell_checkpoint_round_trip(tmp_path):
    """tests/test_rnn.py's round trip through an LSTMCell, in the port."""
    rng = np.random.RandomState(2)
    with tmx.cpu(), tmx.name.NameManager():
        cell = tmx.rnn.LSTMCell(4, prefix="lstm_")
        outputs, _ = cell.unroll(2, tmx.sym.Variable("data"),
                                 merge_outputs=True)
        args = {k: tmx.nd.array(rng.rand(*s)) for k, s in (
            ("lstm_i2h_weight", (16, 3)), ("lstm_i2h_bias", (16,)),
            ("lstm_h2h_weight", (16, 4)), ("lstm_h2h_bias", (16,)))}
        prefix = str(tmp_path / "model")
        tmx.rnn.save_rnn_checkpoint(cell, prefix, 1, outputs, args, {})
        _, a2, _ = tmx.rnn.load_rnn_checkpoint(cell, prefix, 1)
    for k, v in args.items():
        np.testing.assert_allclose(a2[k].asnumpy(), v.asnumpy(),
                                   rtol=CKPT_RTOL)


# ---------------------------------------------------------------------------
# rnn.io

def test_encode_sentences_matches_jax():
    sentences = [["the", "cat", "sat"], ["a", "dog", "ran", "far"],
                 ["the", "dog"], ["a", "cat", "sat"]]
    for kw in ({}, {"start_label": 1}, {"invalid_label": 0,
                                         "start_label": 0}):
        assert tmx.rnn.encode_sentences(sentences, **kw) == \
            jmx.rnn.encode_sentences(sentences, **kw)
    enc, vocab = jmx.rnn.encode_sentences(sentences, start_label=1)
    more = [["the", "bird"]]
    assert tmx.rnn.encode_sentences(more, vocab=dict(vocab),
                                    unknown_token="cat") == \
        jmx.rnn.encode_sentences(more, vocab=dict(vocab),
                                 unknown_token="cat")
    with pytest.raises(AssertionError):
        tmx.rnn.encode_sentences(more, vocab=dict(vocab))


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_gives_the_jax_batches(layout):
    """Under one ``mx.random.seed`` both packages visit the buckets and
    rows in the same order, two epochs running."""
    rng = np.random.RandomState(0)
    data = [list(rng.randint(1, 20, size=n))
            for n in [3, 3, 3, 4, 4, 4, 4, 7, 7, 9] * 2]
    epochs = {}
    for package in (jmx, tmx):
        package.random.seed(5)
        with tmx.cpu():
            it = package.rnn.BucketSentenceIter(data, batch_size=2,
                                                buckets=[4, 8], layout=layout,
                                                invalid_label=0)
            assert it.default_bucket_key == 8
            runs = []
            for _ in range(2):
                runs.append([(b.bucket_key, b.data[0].asnumpy(),
                              b.label[0].asnumpy(), b.provide_data[0].shape)
                             for b in it])
                it.reset()
        epochs[package] = runs
    for jrun, trun in zip(epochs[jmx], epochs[tmx]):
        assert len(jrun) == len(trun) > 0
        for (jk, jd, jl, js), (tk, td, tl, ts) in zip(jrun, trun):
            assert (jk, js) == (tk, ts)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
    first = epochs[tmx][0][0]
    assert first[1].shape == ((2, first[0]) if layout == "NT"
                              else (first[0], 2))
