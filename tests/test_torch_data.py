"""mxnet_tpu_torch's Gluon data API and ``image`` against mxnet_tpu's on
the CPU.

Samplers, datasets and the ``DataLoader`` (``num_workers`` 0, 2 in fork
processes and 2 in threads, every ``last_batch`` mode, shuffled) give the
JAX package's batches bit for bit from the same ``mx.random.seed``; the
loader's pool survives ``close()`` mid-epoch, concurrent epochs and a
worker's exception, a dataset holding CUDA tensors is refused with worker
processes, RecordIO datasets read right in forked workers, and each
worker process runs one intra-op thread.  The vision transforms, the
``image`` functions and augmenters and the detection augmenters agree
under the same ``random.seed`` and ``mx.random.seed``: bitwise for uint8
outputs, rtol 1e-6 for float ones.  ``ImageRecordIterator`` over a small JPEG ``.rec``
and the vision datasets over locally written MNIST idx, CIFAR binary,
RecordIO and image-folder files give the same samples.
"""
import gzip
import io as _io
import os
import random
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

FLOAT = dict(rtol=1e-6, atol=0)
# a wedged fork worker fails its test instead of hanging the run
FORK_TIMEOUT = 60.0


def _same(got, want, tol=FLOAT):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


def _nested(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _nested(x, y)
    else:
        _same(a, b)


# ---------------------------------------------------------------------------
# samplers and datasets

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_the_jax_package(last_batch):
    out = {}
    for pkg in (mx, tmx):
        d = pkg.gluon.data
        pkg.random.seed(1)
        rs = d.RandomSampler(11)
        bs = d.BatchSampler(rs, 4, last_batch)
        out[pkg] = ([list(bs), list(bs), len(bs)],
                    list(d.SequentialSampler(5)),
                    [list(pkg.gluon.contrib.data.IntervalSampler(7, 3, r))
                     for r in (True, False)])
    assert out[tmx] == out[mx]


def test_datasets_match_the_jax_package(tmp_path):
    rng = np.random.RandomState(2)
    X = rng.randn(7, 3).astype(np.float32)
    Y = np.arange(7, dtype=np.float32)
    rec = str(tmp_path / "f.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "f.idx"), rec, "w")
    for i in range(4):
        w.write_idx(i, b"record %d" % i)
    w.close()
    out = {}
    for pkg in (mx, tmx):
        d = pkg.gluon.data
        ds = d.ArrayDataset(X, Y)
        lazy = ds.transform(lambda x, y: (x * 2, y + 1))
        first = ds.transform_first(lambda x: x - 1, lazy=False)
        out[pkg] = [len(ds), [ds[i] for i in range(7)],
                    [lazy[i] for i in range(7)], [first[i] for i in (0, 6)],
                    [s for s in ds.filter(lambda s: s[1] % 2 == 0)._data],
                    len(ds.take(3)), d.SimpleDataset([5, 6])[1],
                    [d.RecordFileDataset(rec)[i] for i in range(4)]]
    g, w = out[tmx], out[mx]
    assert g[0] == w[0] and g[5] == w[5] and g[6] == w[6] and g[7] == w[7]
    for a, b in zip(g[1:5], w[1:5]):
        _nested(a, b)


def _loader_cases():
    for workers, threads in ((0, False), (2, False), (2, True)):
        for last_batch in ("keep", "discard", "rollover"):
            yield workers, threads, last_batch


@pytest.mark.parametrize("workers,threads,last_batch", list(_loader_cases()))
def test_dataloader_matches_the_jax_package(workers, threads, last_batch):
    rng = np.random.RandomState(3)
    X = rng.randn(13, 2, 3).astype(np.float32)
    Y = rng.randint(0, 5, 13).astype(np.int32)
    out = {}
    for pkg, kw in ((mx, {}), (tmx, {"num_workers": workers,
                                     "thread_pool": threads,
                                     "worker_timeout": FORK_TIMEOUT})):
        pkg.random.seed(4)
        with pkg.gluon.data.DataLoader(
                pkg.gluon.data.ArrayDataset(X, Y), batch_size=4,
                shuffle=True, last_batch=last_batch, **kw) as loader:
            out[pkg] = [[(x.asnumpy(), y.asnumpy()) for x, y in loader]
                        for _ in range(2)]
    assert [len(e) for e in out[tmx]] == [len(e) for e in out[mx]]
    _nested(out[tmx], out[mx])
    with tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(X, Y),
                                   batch_size=4) as loader:
        x, _ = next(iter(loader))
    assert x.context == torch.device("cpu")


def _ds(n=40):
    X = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    return tmx.gluon.data.ArrayDataset(X, np.arange(n, dtype=np.float32))


def test_dataloader_pool_survives_close_concurrency_and_errors():
    loader = tmx.gluon.data.DataLoader(_ds(), batch_size=4, num_workers=2,
                                       worker_timeout=FORK_TIMEOUT)
    a, b = iter(loader), iter(loader)
    ra = [y.asnumpy() for _, y in a]
    rb = [y.asnumpy() for _, y in b]
    for r in (ra, rb):
        np.testing.assert_array_equal(np.concatenate(r), np.arange(40))
    it = iter(loader)
    next(it)                 # the rest of the window stays in flight
    loader.close()
    loader.close()
    assert loader._pool is None and not loader._in_flight
    with pytest.raises(RuntimeError, match="closed"):
        iter(loader)


class _Failing:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9:
            raise ValueError("bad sample 9")
        return np.full((2,), i, np.float32)


@pytest.mark.parametrize("threads", [False, True])
def test_a_worker_exception_does_not_strand_the_pool(threads):
    loader = tmx.gluon.data.DataLoader(_Failing(), batch_size=2,
                                       num_workers=2, thread_pool=threads,
                                       worker_timeout=FORK_TIMEOUT)
    for _ in range(2):   # the pool serves a second epoch to the same point
        n = 0
        with pytest.raises(ValueError, match="bad sample 9"):
            for _ in loader:
                n += 1
        assert n == 4
    loader.close()


def _fake_cuda(t):
    """A CPU tensor that reports itself on the card (no CUDA here)."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True
    return torch.Tensor._make_subclass(OnCard, t)


def test_a_dataset_holding_cuda_tensors_is_refused_with_fork_workers():
    held = tmx.gluon.data.SimpleDataset([tmx.nd.NDArray(_fake_cuda(
        torch.zeros(2)))] * 4)
    with pytest.raises(MXNetError, match="worker processes must not touch"):
        tmx.gluon.data.DataLoader(held, batch_size=2, num_workers=2)
    # threads share the parent's CUDA context: allowed
    tmx.gluon.data.DataLoader(held, batch_size=2, num_workers=1,
                              thread_pool=True).close()

    class MakesCuda:        # a dataset whose samples come out on the card
        sample = tmx.nd.NDArray(_fake_cuda(torch.zeros(2)))

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return self.sample
    loader = tmx.gluon.data.DataLoader(MakesCuda(), batch_size=2,
                                       num_workers=1,
                                       worker_timeout=FORK_TIMEOUT)
    with pytest.raises(MXNetError, match="worker processes must not touch"):
        next(iter(loader))
    loader.close()


# ---------------------------------------------------------------------------
# image functions, augmenters and transforms

_IMG = np.random.RandomState(5).randint(0, 256, (20, 26, 3)).astype(np.uint8)


def _run(pkg, seed, fn):
    random.seed(seed)
    pkg.random.seed(seed)
    return fn(pkg, pkg.nd.array(_IMG, dtype="uint8",
                                **({"ctx": tmx.cpu()} if pkg is tmx else {})))


def _augmenters(pkg):
    im = pkg.image
    return {
        "resize": im.ResizeAug(14), "force_resize": im.ForceResizeAug((9, 7)),
        "random_crop": im.RandomCropAug((12, 10)),
        "random_sized_crop": im.RandomSizedCropAug((11, 9), 0.3,
                                                   (0.75, 1.33)),
        "center_crop": im.CenterCropAug((12, 8)),
        "brightness": im.BrightnessJitterAug(0.4),
        "contrast": im.ContrastJitterAug(0.4),
        "saturation": im.SaturationJitterAug(0.4),
        "hue": im.HueJitterAug(0.3),
        "color": im.ColorJitterAug(0.3, 0.3, 0.3),
        "lighting": im.LightingAug(0.1, np.array([55.46, 4.794, 1.148]),
                                   np.eye(3)),
        "normalize": im.ColorNormalizeAug(np.array([120.0, 110.0, 100.0]),
                                          np.array([50.0, 60.0, 70.0])),
        "gray": im.RandomGrayAug(0.9), "flip": im.HorizontalFlipAug(0.9),
        "cast": im.CastAug(),
        "sequential": im.SequentialAug([im.CastAug(),
                                        im.HorizontalFlipAug(1.0)]),
        "create": im.SequentialAug(im.CreateAugmenter(
            (3, 12, 12), resize=16, rand_crop=True, rand_resize=True,
            rand_mirror=True, mean=True, std=True, brightness=0.2,
            contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1,
            rand_gray=0.3)),
    }


@pytest.mark.parametrize("name", sorted(_augmenters(tmx)))
def test_augmenters_match_the_jax_package(name):
    for seed in (0, 1, 2):
        got = _run(tmx, seed, lambda p, x: _augmenters(p)[name](x))
        want = _run(mx, seed, lambda p, x: _augmenters(p)[name](x))
        _same(got, want)


def test_image_functions_match_the_jax_package():
    buf = _io.BytesIO()
    Image.fromarray(_IMG).save(buf, format="PNG")

    def calls(pkg, x):
        im = pkg.image
        return [im.imdecode(buf.getvalue()), im.imdecode(buf.getvalue(), 0),
                im.imresize(x, 13, 9), im.resize_short(x, 10),
                im.fixed_crop(x, 2, 3, 10, 8, size=(5, 4)),
                im.random_crop(x, (9, 9))[0], im.center_crop(x, (30, 8))[0],
                im.random_size_crop(x, (8, 8), (0.2, 0.9), (0.5, 2.0))[0],
                im.color_normalize(x, np.array([1.0, 2.0, 3.0]),
                                   np.array([2.0, 2.0, 4.0])),
                im.scale_down((26, 20), (30, 10))]
    _nested(_run(tmx, 3, calls), _run(mx, 3, calls))


def _transforms(pkg):
    T = pkg.gluon.data.vision.transforms
    return {
        "cast": T.Cast("float32"), "to_tensor": T.ToTensor(),
        "normalize": T.Compose([T.ToTensor(), T.Normalize(
            (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
        "resize": T.Resize((11, 7)), "center_crop": T.CenterCrop(9),
        "resized_crop": T.RandomResizedCrop(10),
        "flip_lr": T.RandomFlipLeftRight(),
        "flip_tb": T.RandomFlipTopBottom(),
        "brightness": T.RandomBrightness(0.3),
        "contrast": T.RandomContrast(0.3),
        "saturation": T.RandomSaturation(0.3), "hue": T.RandomHue(0.2),
        "jitter": T.RandomColorJitter(0.2, 0.2, 0.2),
        "lighting": T.RandomLighting(0.2),
        "compose": T.Compose([T.RandomResizedCrop(12),
                              T.RandomFlipLeftRight(), T.ToTensor(),
                              T.Normalize(0.5, 0.25)]),
    }


@pytest.mark.parametrize("name", sorted(_transforms(tmx)))
def test_vision_transforms_match_the_jax_package(name):
    for seed in (0, 1, 2, 3):
        got = _run(tmx, seed, lambda p, x: _transforms(p)[name](x))
        want = _run(mx, seed, lambda p, x: _transforms(p)[name](x))
        _same(got, want)


def test_detection_augmenters_match_the_jax_package():
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.3, 0.1, 0.9, 0.4]],
                     np.float32)

    def run(pkg, x):
        det = pkg.image.detection
        augs = det.CreateDetAugmenter((3, 20, 26), rand_mirror=True,
                                      mean=[1.0, 2.0, 3.0],
                                      std=[2.0, 2.0, 2.0])
        pick = det.DetRandomSelectAug([det.DetHorizontalFlipAug(1.0),
                                       det.DetBorrowAug(
                                           pkg.image.CastAug())], 0.2)
        outs = []
        for _ in range(4):
            src, lab = x, label
            for aug in augs + [pick]:
                src, lab = aug(src, lab)
            outs += [src, lab]
        return outs
    _nested(_run(tmx, 6, run), _run(mx, 6, run))


def _jpeg_rec(path, n=10, seed=7, side=(22, 18)):
    rng = np.random.RandomState(seed)
    w = tmx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, side + (3,)).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % 4), i, 0), img))
    w.close()


def test_image_record_iterator_matches_the_jax_package(tmp_path):
    path = str(tmp_path / "jpegs.rec")
    _jpeg_rec(path)
    out = {}
    for pkg in (mx, tmx):
        random.seed(9)
        it = pkg.io.ImageRecordIter(
            path_imgrec=path, data_shape=(3, 16, 16), batch_size=4,
            shuffle=True, rand_crop=True, rand_mirror=True, mean_r=120,
            mean_g=115, mean_b=100, std_r=60, std_g=58, std_b=57)
        assert type(it).__name__ == "ImageRecordIterator"
        out[pkg] = []
        for _ in range(2):
            out[pkg] += [(b.data[0], b.label[0], b.pad) for b in it]
            it.reset()
    assert len(out[tmx]) == 6 and out[tmx][2][2] == 2
    for (g, gl, gp), (w, wl, wp) in zip(out[tmx], out[mx]):
        _same(g, w)
        _same(gl, wl)
        assert gp == wp
    assert out[tmx][0][0].context == torch.device("cpu")


def test_record_dataset_reads_right_in_fork_workers(tmp_path):
    """Forked workers share the parent's open RecordIO file: each reopens
    it (MXNet's ``_check_pid``), or their seeks and reads interleave on
    one offset.  The JAX package's loader with no workers is the
    reference."""
    path = str(tmp_path / "jpegs.rec")
    _jpeg_rec(path, n=24)
    out = {}
    for pkg, kw in ((mx, {}), (tmx, {"num_workers": 3,
                                     "worker_timeout": FORK_TIMEOUT})):
        ds = pkg.gluon.data.vision.ImageRecordDataset(path)
        ds[0]                   # the parent reads before the fork
        with pkg.gluon.data.DataLoader(ds, batch_size=4, **kw) as loader:
            out[pkg] = [(x.asnumpy(), y.asnumpy()) for x, y in loader]
    assert len(out[tmx]) == 6
    _nested(out[tmx], out[mx])


class _Threads:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.float32(torch.get_num_threads())


def test_fork_workers_run_one_intra_op_thread():
    """A forked child whose parent ran OpenMP's threads hangs in its first
    parallel op (libgomp is not fork-safe; seen on the H100 machine):
    each worker process runs one intra-op thread."""
    torch.tensor(np.ones(1 << 22, np.uint8)).float().sum()  # parent's pool
    with tmx.gluon.data.DataLoader(_Threads(), batch_size=2, num_workers=2,
                                   worker_timeout=FORK_TIMEOUT) as loader:
        got = np.concatenate([b.asnumpy() for b in loader])
    assert got.tolist() == [1.0] * 4


# ---------------------------------------------------------------------------
# vision datasets from local files

def _idx(path, array):
    header = struct.pack(">HBB", 0, 8, array.ndim) + b"".join(
        struct.pack(">I", d) for d in array.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def test_vision_datasets_read_local_files(tmp_path):
    rng = np.random.RandomState(10)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _idx(str(mnist / "train-images-idx3-ubyte.gz"),
         rng.randint(0, 256, (6, 28, 28)))
    _idx(str(mnist / "train-labels-idx1-ubyte.gz"), rng.randint(0, 10, 6))
    cifar = tmp_path / "cifar" / "cifar-10-batches-bin"
    cifar.mkdir(parents=True)
    for i in range(1, 6):
        rows = np.concatenate([rng.randint(0, 10, (2, 1)),
                               rng.randint(0, 256, (2, 3072))], axis=1)
        (cifar / ("data_batch_%d.bin" % i)).write_bytes(
            rows.astype(np.uint8).tobytes())
    c100 = tmp_path / "c100"
    c100.mkdir()
    rows = np.concatenate([rng.randint(0, 20, (3, 1)),
                           rng.randint(0, 100, (3, 1)),
                           rng.randint(0, 256, (3, 3072))], axis=1)
    (c100 / "train.bin").write_bytes(rows.astype(np.uint8).tobytes())
    rec = str(tmp_path / "imgs.rec")
    _jpeg_rec(rec, n=3)
    folder = tmp_path / "folder"
    for cls in ("cat", "dog"):
        (folder / cls).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.randint(0, 256, (6, 5, 3)).astype(
                np.uint8)).save(folder / cls / ("%d.png" % j))

    def read(pkg):
        v = pkg.gluon.data.vision
        sets = [v.MNIST(root=str(mnist)),
                v.MNIST(root=str(mnist),
                        transform=lambda x, y: (x.astype("float32"), y)),
                v.CIFAR10(root=str(tmp_path / "cifar")),
                v.CIFAR100(root=str(c100), fine_label=True),
                v.ImageRecordDataset(rec), v.ImageFolderDataset(str(folder))]
        return [[len(s)] + [list(s[i]) for i in range(len(s))] for s in sets]
    got, want = read(tmx), read(mx)
    assert [g[0] for g in got] == [w[0] for w in want] == [6, 6, 10, 3, 3, 4]
    for g, w in zip(got, want):
        for gs, ws in zip(g[1:], w[1:]):
            _same(gs[0], ws[0])
            np.testing.assert_array_equal(gs[1], ws[1])
    with pytest.raises(FileNotFoundError):
        tmx.gluon.data.vision.MNIST(root=str(tmp_path / "none"))
    assert os.path.isdir(tmp_path / "none")
