"""mxnet_tpu_torch.io's file and wrapper iterators against mxnet_tpu's on
the CPU.

``MNISTIter`` over seeded idx files gives the JAX package's batches bit for
bit, shuffles included (both seeded with the same ``mx.random.seed``);
``CSVIter``, ``ResizeIter``, ``PrefetchingIter`` (with and without a
``ctx``), ``DataLoaderIter`` and the ``next()`` adapter of ``DataIter``
give the same batches as the JAX package's; a source's error reaches the
consumer after the good batches and an abandoned ``PrefetchingIter`` is
collected with its thread; ``LibSVMIter`` raises, naming ROADMAP queue 1
#9.
"""
import gc
import gzip
import struct
import weakref

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = {"ctx": tmx.cpu()}


def _write_idx(path, array, gz):
    opener = gzip.open if gz else open
    header = struct.pack(">HBB", 0, 8, array.ndim) + b"".join(
        struct.pack(">I", d) for d in array.shape)
    with opener(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist")
    rng = np.random.RandomState(16)
    img = rng.randint(0, 256, (50, 28, 28))
    lbl = rng.randint(0, 10, 50)
    paths = (str(root / "train-images-idx3-ubyte.gz"),
             str(root / "train-labels-idx1-ubyte"))
    _write_idx(paths[0], img, gz=True)
    _write_idx(paths[1], lbl, gz=False)
    return paths, img, lbl


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for (g, gl, gp), (w, wl, wp) in zip(ge, we):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter_matches_the_jax_package(mnist_files, flat, shuffle):
    (image, label), img, lbl = mnist_files
    out = {}
    for pkg, kw in ((mx, {}), (tmx, CPU)):
        pkg.random.seed(7)
        it = pkg.io.MNISTIter(image=image, label=label, batch_size=16,
                              shuffle=shuffle, flat=flat, **kw)
        out[pkg] = _epochs(it)
    _same(out[tmx], out[mx])
    first = out[tmx][0]
    assert first[0][0].shape == ((16, 784) if flat else (16, 1, 28, 28))
    if shuffle:   # a reshuffle at the reset
        assert not np.array_equal(first[0][1], out[tmx][1][0][1])
    else:
        np.testing.assert_array_equal(first[0][1], lbl[:16])
        np.testing.assert_array_equal(first[0][0].reshape(16, 28, 28),
                                      img[:16].astype(np.float32) / 255.0)
    it = tmx.io.MNISTIter(image=image, label=label, batch_size=16, **CPU)
    assert [d.name for d in it.provide_data + it.provide_label] == [
        "data", "softmax_label"]


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_the_jax_package(tmp_path, round_batch):
    rng = np.random.RandomState(3)
    data, label = rng.randn(11, 6), rng.randint(0, 4, 11)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    out = {}
    for pkg, kw in ((mx, {}), (tmx, CPU)):
        it = pkg.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                            data_shape=(2, 3),
                            label_csv=str(tmp_path / "l.csv"), batch_size=4,
                            round_batch=round_batch, **kw)
        out[pkg] = _epochs(it)
    _same(out[tmx], out[mx])
    assert len(out[tmx][0]) == (3 if round_batch else 2)


def _ndarray_iter(pkg, n=10, batch_size=4, **kw):
    rng = np.random.RandomState(4)
    X = rng.randn(n, 3).astype(np.float32)
    Y = np.arange(n, dtype=np.float32)
    extra = CPU if pkg is tmx else {}
    return pkg.io.NDArrayIter(X, Y, batch_size=batch_size, **extra, **kw)


def test_resize_iter_matches_the_jax_package():
    out = {}
    for pkg in (mx, tmx):
        pkg.random.seed(2)
        it = pkg.io.ResizeIter(_ndarray_iter(pkg, shuffle=True), 5)
        out[pkg] = _epochs(it, 3)
        short = pkg.io.ResizeIter(_ndarray_iter(pkg), 2)
        assert len(list(short)) == 2
    _same(out[tmx], out[mx])
    assert [len(e) for e in out[tmx]] == [5, 5, 5]


@pytest.mark.parametrize("with_ctx", [False, True])
def test_prefetching_iter_matches_the_jax_package(with_ctx):
    out = {}
    for pkg in (mx, tmx):
        pkg.random.seed(5)
        kw = {"ctx": pkg.cpu()} if with_ctx else {}
        it = pkg.io.PrefetchingIter(
            [_ndarray_iter(pkg, shuffle=True),
             _ndarray_iter(pkg, batch_size=4)],
            rename_data=[{"data": "a"}, {"data": "b"}], **kw)
        assert [d.name for d in it.provide_data] == ["a", "b"]
        batches = []
        for _ in range(2):
            batches.append([tuple(x.asnumpy() for x in b.data + b.label)
                            + (b.pad,) for b in it])
            it.reset()
        out[pkg] = batches
        it.close()
    assert len(out[tmx][0]) == 3
    for ge, we in zip(out[tmx], out[mx]):
        for g, w in zip(ge, we):
            assert g[-1] == w[-1]
            for a, b in zip(g[:-1], w[:-1]):
                np.testing.assert_array_equal(a, b)


class _Poisoned(tmx.io.DataIter):
    """Two good batches, then an error."""

    def __init__(self):
        super().__init__(batch_size=2)
        self.provide_data = [tmx.io.DataDesc("data", (2, 3))]
        self.provide_label = []
        self._n = 0

    def next(self):
        self._n += 1
        if self._n == 3:
            raise RuntimeError("decode blew up")
        return tmx.io.DataBatch(
            data=[tmx.nd.full((2, 3), self._n, ctx=tmx.cpu())], label=[],
            pad=0)

    def reset(self):
        self._n = 0


def test_prefetching_iter_error_reaches_the_consumer_after_good_batches():
    it = tmx.io.PrefetchingIter(_Poisoned(), ctx=tmx.cpu())
    assert next(it).data[0].asnumpy()[0, 0] == 1
    assert next(it).data[0].asnumpy()[0, 0] == 2
    with pytest.raises(RuntimeError, match="decode blew up"):
        next(it)
    with pytest.raises(RuntimeError, match="decode blew up"):
        next(it)


def test_abandoned_prefetching_iter_is_collected_with_its_thread():
    it = tmx.io.PrefetchingIter(_ndarray_iter(tmx, n=40, batch_size=2),
                                ctx=tmx.cpu())
    it.next()
    thread = it._feed._thread
    ref = weakref.ref(it)
    del it
    gc.collect()
    assert ref() is None
    thread.join(5.0)
    assert not thread.is_alive()


def test_the_next_adapter_serves_the_accessor_protocol():
    """A next()-only iterator through iter_next/getdata/getlabel/getpad,
    as the JAX package's adapter serves it; reset drops the cached
    batch."""
    out = {}
    for pkg, kw in ((mx, {}), (tmx, CPU)):
        it = pkg.io.ResizeIter(_ndarray_iter(pkg), 3)
        inner = _ndarray_iter(pkg)
        csv_like = type("NextOnly", (pkg.io.DataIter,), {
            "next": lambda self: inner.next(),
            "reset": lambda self: inner.reset()})(4)
        seen = []
        while csv_like.iter_next():
            seen.append((csv_like.getdata()[0].asnumpy(),
                         csv_like.getlabel()[0].asnumpy(),
                         csv_like.getpad()))
        csv_like.reset()
        with pytest.raises(RuntimeError):
            csv_like.getdata()
        with pytest.raises(NotImplementedError):
            pkg.io.DataIter(2).iter_next()
        out[pkg] = [seen]
        assert it.iter_next() and it.getpad() == 0
    _same(out[tmx], out[mx])
    assert len(out[tmx][0]) == 3 and out[tmx][0][-1][2] == 2


def test_dataloader_iter_matches_the_jax_package():
    rng = np.random.RandomState(6)
    X = rng.randn(9, 2).astype(np.float32)
    Y = rng.randint(0, 3, 9).astype(np.float32)
    out = {}
    for pkg in (mx, tmx):
        pkg.random.seed(8)
        loader = pkg.gluon.data.DataLoader(
            pkg.gluon.data.ArrayDataset(X, Y), batch_size=4, shuffle=True,
            last_batch="discard")
        out[pkg] = _epochs(pkg.io.DataLoaderIter(loader))
    _same(out[tmx], out[mx])
    assert [len(e) for e in out[tmx]] == [2, 2]


def test_libsvm_iter_waits_for_sparse(tmp_path):
    (tmp_path / "d.libsvm").write_text("1 0:1.5 3:2\n0 1:1\n")
    with pytest.raises(MXNetError, match="#9"):
        tmx.io.LibSVMIter(data_libsvm=str(tmp_path / "d.libsvm"),
                          data_shape=(4,))
