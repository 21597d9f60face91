"""mxnet_tpu_torch.model's checkpoint manifest against the JAX package's,
on the CPU.

A checkpoint written by the port's ``model.save_checkpoint`` or
``Module.save_checkpoint`` is found by the JAX package's
``latest_complete_checkpoint`` and loads to equal arrays (the witness of
the manifest's port: before it the port wrote no
``prefix-manifest.json`` and the JAX reader found nothing), and the
reverse; the same arrays give byte-equal files, the manifest included; a
torn newest entry is skipped, a legacy prefix needs the
``allow_unverified`` opt-in, and ``prune_checkpoints`` reports what the
JAX package's reports on twin directories; ``util.write_atomic`` leaves
its named debris when a writer is killed, and the prune sweeps it.
"""
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import model as jmodel
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, util
from mxnet_tpu_torch import model as model_io


def _arrays(epoch):
    rng = np.random.RandomState(epoch)
    return {"fc_weight": rng.randn(3, 4).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}


def _save(pkg, prefix, epoch):
    """One checkpoint through ``pkg.model.save_checkpoint``, a symbol and
    the seeded arrays of ``epoch``."""
    with pkg.name.NameManager():
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                     name="fc")
    if pkg is mx:
        with mx.cpu():
            args = {k: mx.nd.array(v) for k, v in _arrays(epoch).items()}
    else:
        args = {k: pkg.nd.array(v) for k, v in _arrays(epoch).items()}
    pkg.model.save_checkpoint(prefix, epoch, net, args, {})


def _port_module(prefix, epoch):
    """A bound, initialized port Module, checkpointed with its optimizer
    states."""
    mx.random.seed(3)
    with mx.name.NameManager():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=4, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 5))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    mod.save_checkpoint(prefix, epoch, save_optimizer_states=True)
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("writer", ["model.save_checkpoint",
                                    "Module.save_checkpoint"])
def test_port_checkpoints_are_found_and_loaded_by_jax(tmp_path, writer):
    prefix = str(tmp_path / "ck")
    if writer == "model.save_checkpoint":
        _save(mx, prefix, 1)
        _save(mx, prefix, 2)
        want = _arrays(2)
        files = {"%s-symbol.json" % prefix, "%s-0002.params" % prefix}
    else:
        want = _port_module(prefix, 2)
        files = {"%s-symbol.json" % prefix, "%s-0002.params" % prefix,
                 "%s-0002.states" % prefix}
    assert jmodel.latest_complete_checkpoint(prefix) == 2
    assert set(jmodel.checkpoint_files(prefix, 2)) == files
    _, args, _ = jmodel.load_checkpoint(prefix, 2)
    assert set(args) == set(want)
    for k, v in want.items():
        assert np.array_equal(args[k].asnumpy(), v), k


def test_jax_checkpoints_are_found_and_loaded_by_the_port(tmp_path):
    prefix = str(tmp_path / "ck")
    _save(jmx, prefix, 1)
    _save(jmx, prefix, 2)
    assert model_io.latest_complete_checkpoint(prefix) == 2
    assert model_io.checkpoint_files(prefix, 1) == \
        jmodel.checkpoint_files(prefix, 1)
    _, args, _ = model_io.load_checkpoint(prefix, 2, ctx="cpu")
    for k, v in _arrays(2).items():
        assert np.array_equal(args[k].asnumpy(), v), k


def _twin_dirs(tmp_path, monkeypatch, work):
    """Run ``work(pkg)`` in a directory of each package's own, from
    inside it (manifest paths are as written: relative here); returns
    both results and both directories' file bytes."""
    out = {}
    for pkg in (mx, jmx):
        d = tmp_path / ("port" if pkg is mx else "jax")
        d.mkdir()
        monkeypatch.chdir(d)
        result = work(pkg)
        out[pkg] = (result, {f: (d / f).read_bytes()
                             for f in sorted(os.listdir(d))})
    return out[mx], out[jmx]


def test_files_and_manifest_are_byte_equal_to_jax(tmp_path, monkeypatch):
    def work(pkg):
        _save(pkg, "ck", 1)
        _save(pkg, "ck", 2)
        return pkg.model.load_manifest("ck")

    (m_man, mine), (j_man, theirs) = _twin_dirs(tmp_path, monkeypatch, work)
    assert sorted(mine) == ["ck-0001.params", "ck-0002.params",
                            "ck-manifest.json", "ck-symbol.json"]
    assert mine == theirs
    assert m_man == j_man and m_man["version"] == 1


def test_torn_entry_legacy_prefix_and_prune_match_jax(tmp_path,
                                                      monkeypatch):
    def work(pkg):
        for epoch in (1, 2, 3, 4, 5):
            _save(pkg, "ck", epoch)
        with open("ck-0005.params", "r+b") as f:   # the newest, torn
            f.seek(10)
            f.write(b"\xff\xff\xff\xff")
        with open("ck-0002.params.tmp-123-456", "wb") as f:
            f.write(b"a killed writer's debris")
        latest = pkg.model.latest_complete_checkpoint("ck")
        report = pkg.model.prune_checkpoints("ck", keep_last=2)
        again = pkg.model.prune_checkpoints("ck", keep_last=0)
        os.remove("ck-manifest.json")
        legacy = (pkg.model.latest_complete_checkpoint("ck"),
                  pkg.model.latest_complete_checkpoint(
                      "ck", allow_unverified=True))
        return latest, report, again, legacy

    (mine, m_files), (theirs, j_files) = _twin_dirs(tmp_path, monkeypatch,
                                                    work)
    assert mine == theirs
    latest, report, again, legacy = mine
    assert latest == 4
    assert report == {"kept": [3, 4], "pruned": [1, 2],
                      "removed_files": ["ck-0001.params", "ck-0002.params"],
                      "removed_tmp": ["ck-0002.params.tmp-123-456"]}
    assert again["kept"] == [4] and again["pruned"] == [3]
    # the torn epoch 5 is newer than the newest complete one: spared.
    # Without the manifest only a parse can judge it, and its torn bytes
    # (the container's reserved field) still parse: the hash sees them
    assert legacy == (None, 5)
    assert m_files == j_files


def test_a_killed_writer_leaves_named_debris(tmp_path):
    path = str(tmp_path / "ck-0001.params")
    plan = faults.FaultPlan(0).add("checkpoint.replace", kind="crash",
                                   times=1)
    with faults.plan(plan):
        with pytest.raises(faults.SimulatedCrash):
            util.write_atomic(path, b"x" * 100)
    debris = [f for f in os.listdir(tmp_path)]
    assert debris == ["ck-0001.params.tmp-%d-%d" % (
        os.getpid(), threading.get_ident())]
    assert not os.path.exists(path)
    assert model_io.prune_checkpoints(str(tmp_path / "ck"))[
        "removed_tmp"] == [str(tmp_path / debris[0])]
    util.write_atomic(path, "done")
    assert os.listdir(tmp_path) == ["ck-0001.params"]
    assert open(path).read() == "done"
