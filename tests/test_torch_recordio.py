"""mxnet_tpu_torch's RecordIO and native IO library against mxnet_tpu's on
the CPU.

Records cross packages byte for byte, plain and indexed, whichever of the
native and the Python reader and writer each uses; ``IRHeader`` packs
equal; the port builds its own copy of the native library under
``build/mxnet_tpu_torch/``; and the native decode pipeline and ``im2rec``
(the same C++ sources, built twice) give the same batches and files in
both packages, corrupt records skipped and file order kept.  Inputs are
seeded ``numpy.random.RandomState`` draws; images are PIL JPEGs.
"""
import io as _io
import os

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import _native as jnative
from mxnet_tpu import recordio as jrio
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import recordio as trio

PACKAGES = {"jax": jrio, "torch": trio}


def _payloads(seed=0, n=9):
    rng = np.random.RandomState(seed)
    # lengths around the 4-byte padding and an empty record
    return [rng.randint(0, 256, size=k).astype(np.uint8).tobytes()
            for k in [0, 1, 3, 4, 5, 17, 64, 255, 1000][:n]]


def _python_only(rec):
    """Switch an open reader to the Python path (seeking its file)."""
    pos = rec.tell()
    rec.close()
    rec._native = None
    rec.handle = open(rec.uri, "rb")
    rec.handle.seek(pos)
    rec.is_open = True
    return rec


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_records_cross_packages_byte_for_byte(tmp_path, writer, reader):
    recs = _payloads()
    paths = {}
    for name, rio in PACKAGES.items():
        paths[name] = str(tmp_path / ("%s.rec" % name))
        w = rio.MXRecordIO(paths[name], "w")
        for r in recs:
            w.write(r)
        w.close()
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    r = PACKAGES[reader].MXRecordIO(paths[writer], "r")
    got = []
    while True:
        buf = r.read()
        if buf is None:
            break
        got.append(buf)
    r.close()
    assert got == recs


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_indexed_records_cross_packages(tmp_path, writer, reader):
    recs = _payloads(1)
    idx, rec = str(tmp_path / "d.idx"), str(tmp_path / "d.rec")
    w = PACKAGES[writer].MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(recs):
        w.write_idx(i * 3, r)
    w.close()
    r = PACKAGES[reader].MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 3 for i in range(len(recs))]
    for i in reversed(range(len(recs))):
        assert r.read_idx(i * 3) == recs[i]
    r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_irheader_packs_equal(label):
    header = (0, label, 7, 11)
    payload = b"\x01\x02payload"
    packed = trio.pack(trio.IRHeader(*header), payload)
    assert packed == jrio.pack(jrio.IRHeader(*header), payload)
    for rio in PACKAGES.values():
        h, s = rio.unpack(packed)
        assert s == payload and h.id == 7 and h.id2 == 11
        np.testing.assert_array_equal(h.label, label)


def test_the_port_builds_its_own_native_library():
    lib = tnative.get_lib()
    assert lib is not None
    path = tnative.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path).endswith(os.path.join("build",
                                                       "mxnet_tpu_torch"))
    assert path != jnative._LIB_PATH
    assert hasattr(lib, "mxtpu_pipe_open") and hasattr(lib, "mxtpu_im2rec")
    assert not [f for f in os.listdir(os.path.dirname(path))
                if ".tmp-" in f]


def test_native_and_python_readers_agree(tmp_path):
    recs = _payloads(2)
    path = str(tmp_path / "n.rec")
    w = trio.MXRecordIO(path, "w")
    assert w._native is not None
    for r in recs:
        w.write(r)
    w.close()
    native = trio.MXRecordIO(path, "r")
    assert native._native is not None
    python = _python_only(trio.MXRecordIO(path, "r"))
    for r in recs:
        assert native.read() == python.read() == r
    assert native.read() is None and python.read() is None


def _pack_jpegs(path, n, seed, corrupt_at=None, size=(30, 26)):
    """n seeded random-pixel JPEGs (labels 0..n-1) written by the port,
    a garbage payload in place of record ``corrupt_at``."""
    rng = np.random.RandomState(seed)
    w = trio.MXRecordIO(path, "w")
    for i in range(n):
        if i == corrupt_at:
            w.write(trio.pack(trio.IRHeader(0, 99.0, i, 0), b"not a jpeg"))
            continue
        img = rng.randint(0, 256, size + (3,)).astype(np.uint8)
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        w.write(trio.pack(trio.IRHeader(0, float(i), i, 0), buf.getvalue()))
    w.close()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_native_pipeline_matches_the_jax_package(tmp_path, layout):
    """Batch by batch: the JAX package's labels alias the iterator's label
    buffer (a CPU ``jnp`` array made from a numpy view), so its batches
    are read before the next one is drawn."""
    path = str(tmp_path / "imgs.rec")
    _pack_jpegs(path, 23, seed=3, corrupt_at=5)
    kw = dict(path_imgrec=path, data_shape=(3, 16, 20), batch_size=4,
              preprocess_threads=3, layout=layout, backend="native")
    jit, it = mx.io.ImageRecordIter(**kw), tmx.io.ImageRecordIter(**kw)
    labels, got = [], []
    for want in jit:
        batch = next(it)
        g, w = batch.data[0].asnumpy(), want.data[0].asnumpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        gl = batch.label[0].asnumpy()
        np.testing.assert_array_equal(gl, want.label[0].asnumpy())
        assert batch.pad == want.pad
        labels += gl[:len(gl) - batch.pad].tolist()
        got.append(batch)
    with pytest.raises(StopIteration):
        next(it)
    assert it.skipped == jit.skipped == 1
    assert len(got) == 6
    # file order, the corrupt record 5 dropped; earlier batches intact
    assert labels == [float(i) for i in range(23) if i != 5]
    assert got[0].label[0].asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got[0].data[0].dtype == (np.uint8 if layout == "NHWC"
                                    else np.float32)


def test_native_pipeline_raises_on_a_truncated_stream(tmp_path):
    path = str(tmp_path / "trunc.rec")
    _pack_jpegs(path, 6, seed=4)
    with open(path, "r+b") as f:
        f.seek(-40, 2)
        f.truncate()
    for pkg in (mx, tmx):
        it = pkg.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                    batch_size=4, backend="native")
        with pytest.raises(pkg.base.MXNetError):
            for _ in it:
                pass


def test_native_im2rec_matches_the_jax_package(tmp_path):
    rng = np.random.RandomState(5)
    (tmp_path / "imgs").mkdir()
    sizes = [(60, 40), (32, 48), (50, 50), (41, 29)]
    for i, (w, h) in enumerate(sizes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "imgs" / ("i%d.jpg" % i),
                                  quality=95)
    lst = tmp_path / "pack.lst"
    lst.write_text("".join("%d\t%f\timgs/i%d.jpg\n" % (i, i * 2.0, i)
                           for i in range(len(sizes))))
    files = {}
    for name, lib in (("jax", jnative.get_lib()),
                      ("torch", tnative.get_lib())):
        rec, idx = tmp_path / (name + ".rec"), tmp_path / (name + ".idx")
        n = lib.mxtpu_im2rec(str(lst).encode(), str(tmp_path).encode(),
                             str(rec).encode(), str(idx).encode(), 24, 90, 2)
        assert n == len(sizes)
        files[name] = (rec.read_bytes(), idx.read_bytes())
    assert files["torch"] == files["jax"]
    r = trio.MXIndexedRecordIO(str(tmp_path / "torch.idx"),
                               str(tmp_path / "torch.rec"), "r")
    for i in range(len(sizes)):
        header, img = trio.unpack_img(r.read_idx(i))
        assert header.id == i and header.label == i * 2.0
        assert min(img.shape[:2]) == 24
    r.close()


def test_a_reader_reopens_in_another_process(tmp_path, monkeypatch):
    """A reader used in a process other than the one that opened it (a
    forked DataLoader worker) opens the file anew instead of sharing the
    parent's offset; a writer there raises."""
    recs = _payloads(3)
    idx, rec = str(tmp_path / "p.idx"), str(tmp_path / "p.rec")
    w = trio.MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    r = trio.MXIndexedRecordIO(idx, rec, "r")
    w = trio.MXRecordIO(str(tmp_path / "other.rec"), "w")
    opened, reopen = [], r.open
    monkeypatch.setattr(r, "open", lambda: opened.append(1) or reopen())
    assert r.read_idx(5) == recs[5] and not opened
    pid = os.getpid()
    monkeypatch.setattr(os, "getpid", lambda: pid + 1)
    assert r.read_idx(2) == recs[2] and r.read_idx(0) == recs[0]
    assert opened == [1] and r.pid == pid + 1
    with pytest.raises(IOError, match="another process"):
        w.write(b"x")
    monkeypatch.undo()
    w.close()
    r.close()
