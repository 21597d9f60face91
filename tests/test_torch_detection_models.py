"""The detection models of mxnet_tpu_torch against the JAX package's
examples on the CPU: ``models/ssd.py`` against ``example/ssd/train_ssd.py``
and ``models/rcnn.py`` against ``example/rcnn/train_rcnn.py``, on the tiny
backbone at 64 x 64 (the SSD) and the example's own widths (the RCNN),
B = 2, with the JAX blocks' weights carried across
(``convert.load_mxnet_params``).  Inputs come from seeded numpy.

Bounds are the JAX package's tests': tests/test_vision_ops.py's and
tests/test_contrib_ops.py's rtol 1e-4 / atol 1e-5 (NN) for the forward,
the detections and a step's loss; after one optimizer step the weights at
rtol 1e-4 / atol 1e-5 too; the RCNN step's loss and proposals at the same
bound (its gradients through ROIPooling are held in
tests/test_torch_detection_ops.py).  The mAP metrics are host arithmetic over the
same detections, held at rtol 1e-12.  The ``main`` of each model runs on
the CPU at 1 epoch of 2 iterations and must finish.

A convolution's bias in front of a BatchNorm has a zero gradient in exact
arithmetic (the normalization removes it), so both packages compute
rounding noise of ~1e-9 there, and Adam's first step moves such a bias by
about the learning rate at the sign of that noise.  Those biases are held
by their gradient; every other weight by its value after the step.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_mxnet_params
from mxnet_tpu_torch.models import rcnn as trcnn
from mxnet_tpu_torch.models import ssd as tssd

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example")
sys.path.insert(0, os.path.join(_EXAMPLE, "ssd"))
sys.path.insert(0, os.path.join(_EXAMPLE, "rcnn"))
import train_rcnn as jrcnn  # noqa: E402
import train_ssd as jssd  # noqa: E402

NN = dict(rtol=1e-4, atol=1e-5)
B, SIDE, CLASSES = 2, 64, 3


@pytest.fixture(autouse=True)
def _two_threads():
    """The port's small CPU ops run beside the JAX package's compiler
    threads and the suite's other workers; two intra-op threads keep them
    from crowding either."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _arrays(block):
    """The JAX block's parameters that have values, by name."""
    return {name: p.data().asnumpy() for name, p in
            block.collect_params().items() if not p._deferred_init}


_CALLED = ("trunk", "cls_heads", "loc_heads")   # what the forward runs


def _part(arrays, block):
    """The arrays of ``block``, named after its prefix."""
    n = len(block.prefix)
    return {k[n:]: a for k, a in arrays.items() if k.startswith(block.prefix)}


def _ssd_loss_jax(anchors, cls_f, loc_f, lab, per_dev):
    """example/ssd/train_ssd.py's loss (:228-251)."""
    nd, invoke = jmx.nd, jmx.ndarray.invoke
    loc_t, loc_m, cls_t = invoke(
        "_contrib_MultiBoxTarget",
        [anchors, lab, nd.transpose(cls_f, axes=(0, 2, 1))],
        {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5})
    valid = (cls_t >= 0).astype("float32")
    n_valid = nd.maximum(valid.sum(), nd.array([1.0]))
    logp = nd.log_softmax(cls_f, axis=-1)
    per_anchor = -nd.pick(logp, nd.maximum(cls_t, nd.zeros_like(cls_t)),
                          axis=-1)
    l_cls = (per_anchor * valid).sum() / n_valid
    n_pos = nd.maximum(loc_m.sum() / 4.0, nd.array([1.0]))
    l_loc = invoke("smooth_l1", [loc_f * loc_m - loc_t],
                   {"scalar": 1.0}).sum() / n_pos
    return (l_cls + l_loc) * per_dev


@pytest.fixture(scope="module")
def ssd_pair():
    """The JAX SSD (tiny backbone) and the port's with its weights, a
    batch, and the JAX side's forward, Adam step and detections."""
    jmx.random.seed(7)
    jnet = jssd.MultiScaleSSD(CLASSES)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((B, 3, SIDE, SIDE)))   # the batch's shapes: compiled once
    weights = _arrays(jnet)
    tnet = tssd.MultiScaleSSD(CLASSES, device="cpu")
    tnet.initialize(tmx.init.Xavier())
    for part in _CALLED:
        load_mxnet_params(getattr(tnet, part),
                          _part(weights, getattr(jnet, part)))
    x, lab = jssd.synthetic_batch(np.random.RandomState(3), B, SIDE,
                                  CLASSES)
    fwd = [o.asnumpy() for o in jnet(jmx.nd.array(x))]
    params = {n: p for n, p in jnet.collect_params().items()
              if not p._deferred_init}
    trainer = jmx.gluon.Trainer(params, "adam", {"learning_rate": 0.002})
    with jmx.autograd.record():
        loss = _ssd_loss_jax(*jnet(jmx.nd.array(x)), jmx.nd.array(lab), B)
    jmx.autograd.backward([loss])
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    trainer.step(B)
    probs = jmx.nd.softmax(jmx.nd.array(fwd[1]).transpose((0, 2, 1)),
                           axis=1)
    det = jmx.ndarray.invoke(
        "_contrib_MultiBoxDetection",
        [probs, jmx.nd.array(fwd[2]), jmx.nd.array(fwd[0])],
        {"nms_threshold": 0.45, "threshold": 0.01, "nms_topk": 100})
    return dict(jnet=jnet, tnet=tnet, x=x, lab=lab, fwd=fwd,
                loss=loss.asnumpy(), grads=grads, stepped=_arrays(jnet),
                det=det.asnumpy(), probs=probs.asnumpy())


def test_the_whole_net_names_its_uncalled_extra_blocks_as_missing(
        ssd_pair):
    """The tiny trunk gives all three taps, so neither package calls the
    extra blocks: the JAX net has no value for them, the port's stay
    waiting for their shape, and loading the whole net raises, naming
    them.  The blocks the forward calls are loaded part by part."""
    tnet = tssd.MultiScaleSSD(CLASSES, device="cpu")
    tnet.initialize(tmx.init.Xavier())
    with pytest.raises(tmx.MXNetError, match="missing arrays.*extra_"):
        load_mxnet_params(tnet, _arrays(ssd_pair["jnet"]))
    waiting = [p for n, p in ssd_pair["tnet"].collect_params().items()
               if "extra_" in n and 0 in p.shape]
    assert len(waiting) == 15   # 3 blocks: conv weight, BatchNorm's 4
    assert all(p._deferred_init for p in waiting)


def test_ssd_forward_matches_jax(ssd_pair):
    got = ssd_pair["tnet"](tmx.nd.array(ssd_pair["x"], ctx=tmx.cpu()))
    names = ("anchors", "cls", "loc")
    assert got[0].shape == (1, 4 * (32 * 32 + 16 * 16 + 8 * 8), 4)
    for name, g, w in zip(names, got, ssd_pair["fwd"]):
        np.testing.assert_allclose(g.asnumpy(), w, err_msg=name, **NN)


def test_ssd_adam_step_matches_jax(ssd_pair):
    tnet = ssd_pair["tnet"]
    params = {n: p for n, p in tnet.collect_params().items()
              if not p._deferred_init}
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 0.002})
    with tmx.autograd.record():
        out = tnet(tmx.nd.array(ssd_pair["x"], ctx=tmx.cpu()))
        loss = tssd.ssd_loss(*out, tmx.nd.array(ssd_pair["lab"],
                                                ctx=tmx.cpu()), B)
    loss.backward()
    grads = {p.name: p.grad().asnumpy() for p in params.values()
             if p.grad_req != "null"}
    trainer.step(B)
    np.testing.assert_allclose(loss.asnumpy(), ssd_pair["loss"], **NN)
    assert sorted(grads) == sorted(ssd_pair["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g, ssd_pair["grads"][name],
                                   err_msg="grad " + name, **NN)
    got = {p.name: p.data().asnumpy() for p in params.values()}
    want = ssd_pair["stepped"]
    assert sorted(got) == sorted(want)
    before_bn = {n for n in got if "backbone_conv" in n and
                 n.endswith("bias")}
    assert len(before_bn) == 3
    for name in sorted(set(got) - before_bn):
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **NN)


def test_multibox_detection_and_map_metrics_match_jax(ssd_pair):
    anchors, _, loc = ssd_pair["fwd"]
    det = tmx.ndarray.invoke(
        "_contrib_MultiBoxDetection",
        [tmx.nd.array(ssd_pair["probs"], ctx=tmx.cpu()),
         tmx.nd.array(loc, ctx=tmx.cpu()),
         tmx.nd.array(anchors, ctx=tmx.cpu())],
        {"nms_threshold": 0.45, "threshold": 0.01, "nms_topk": 100})
    np.testing.assert_allclose(det.asnumpy(), ssd_pair["det"], **NN)
    assert (det.asnumpy()[:, :, 0] >= 0).sum() > 0
    for name in ("VOCMApMetric", "VOC07MApMetric"):
        for ovp in (0.5, 0.05):
            ours = getattr(tmx.metric, name)(ovp_thresh=ovp)
            theirs = getattr(jmx.metric, name)(ovp_thresh=ovp)
            ours.update([ssd_pair["lab"]], [det])
            theirs.update([jmx.nd.array(ssd_pair["lab"])],
                          [jmx.nd.array(ssd_pair["det"])])
            assert ours.get()[0] == theirs.get()[0]
            np.testing.assert_allclose(ours.get()[1], theirs.get()[1],
                                       rtol=1e-12, err_msg=name)


def test_map_metrics_match_jax_with_difficult_and_class_names():
    rng = np.random.RandomState(5)
    labels = np.full((2, 3, 6), -1.0, np.float32)
    labels[:, :2, 0] = [[0, 1], [1, 1]]
    labels[:, :2, 1:3] = rng.uniform(0, 0.5, (2, 2, 2))
    labels[:, :2, 3:5] = labels[:, :2, 1:3] + 0.3
    labels[:, :2, 5] = [[0, 1], [0, 0]]
    dets = np.full((2, 4, 6), -1.0, np.float32)
    dets[:, :3, 0] = [[0, 1, 1], [1, 2, 1]]
    dets[:, :3, 1] = rng.uniform(0.2, 1, (2, 3))
    dets[:, :3, 2:4] = labels[:, [0, 1, 1], 1:3] + rng.uniform(
        -0.05, 0.05, (2, 3, 2))
    dets[:, :3, 4:6] = dets[:, :3, 2:4] + 0.3
    for kwargs in ({}, {"use_difficult": True},
                   {"class_names": ["a", "b", "c"]}):
        for name in ("VOCMApMetric", "VOC07MApMetric"):
            ours = getattr(tmx.metric, name)(**kwargs)
            theirs = getattr(jmx.metric, name)(**kwargs)
            ours.update([labels], [dets])
            theirs.update([jmx.nd.array(labels)], [jmx.nd.array(dets)])
            assert ours.get()[0] == theirs.get()[0]
            np.testing.assert_allclose(ours.get()[1], theirs.get()[1],
                                       rtol=1e-12, err_msg=name)


def _rcnn_step_jax(blocks, x, obj, bbt, pos, cls_np, im_info):
    """example/rcnn/train_rcnn.py's step loss (:160-189)."""
    nd, invoke = jmx.nd, jmx.ndarray.invoke
    backbone, rpn, head = blocks
    feat = backbone(x)
    rpn_cls, rpn_bbox = rpn(feat)
    rois = invoke("_contrib_MultiProposal",
                  [nd.softmax(rpn_cls, axis=1), rpn_bbox, im_info],
                  {"rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 4,
                   "feature_stride": 4, "scales": (2.0,), "ratios": (1.0,),
                   "rpn_min_size": 1, "threshold": 0.7})
    pooled = invoke("ROIPooling", [feat, rois],
                    {"pooled_size": (3, 3), "spatial_scale": 0.25})
    logits = head(pooled)
    roi_y = nd.array(np.repeat(cls_np, 4).astype(np.float32))
    l_head = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(logits, roi_y).mean()
    logp = nd.log_softmax(nd.transpose(rpn_cls, axes=(0, 2, 3, 1)),
                          axis=-1)
    l_obj = -nd.pick(logp, obj, axis=-1).mean()
    n_pos = nd.maximum(pos.sum(), nd.array([1.0]))
    l_box = invoke("smooth_l1", [(rpn_bbox - bbt) * pos],
                   {"scalar": 3.0}).sum() / n_pos
    return l_head + l_obj + l_box, rois


def test_rcnn_step_matches_jax():
    jmx.random.seed(11)
    jblocks = (jrcnn.Backbone(), jrcnn.RPN(1), jrcnn.RoiHead(num_classes=2))
    tblocks = trcnn.build("cpu")
    rng = np.random.RandomState(4)
    x, cls_np, boxes = jrcnn.synthetic_batch(rng, B, 32)
    base = trcnn._generate_anchors(4, (1.0,), (2.0,))[0]
    obj, bbt, pos = jrcnn.rpn_targets(boxes, 32, 4, base)
    im_info = np.tile([32.0, 32.0, 1.0], (B, 1)).astype(np.float32)
    for jb in jblocks:
        jb.initialize(jmx.init.Xavier())
    # probes at the step's shapes, so each op compiles once
    jblocks[2](jmx.nd.zeros((B * 4, 16, 3, 3)))
    jblocks[1](jblocks[0](jmx.nd.zeros((B, 3, 32, 32))))
    for jb, tb in zip(jblocks, tblocks):
        load_mxnet_params(tb, _arrays(jb))
    jparams, tparams = {}, {}
    for jb, tb in zip(jblocks, tblocks):
        jparams.update(jb.collect_params())
        tparams.update(tb.collect_params())
    with jmx.autograd.predict_mode():
        jloss, jrois = _rcnn_step_jax(
            jblocks, *(jmx.nd.array(a) for a in (x, obj, bbt, pos[:, None])),
            cls_np, jmx.nd.array(im_info))
    cpu = tmx.cpu()
    with tmx.autograd.record():
        tloss, trois = trcnn.step_loss(
            tblocks, *(tmx.nd.array(a, ctx=cpu)
                       for a in (x, obj, bbt, pos[:, None])),
            cls_np, tmx.nd.array(im_info, ctx=cpu))
    tloss.backward()
    np.testing.assert_allclose(tloss.asnumpy(), jloss.asnumpy(), **NN)
    np.testing.assert_allclose(trois.asnumpy(), jrois.asnumpy(), **NN)
    grads = [p.grad().asnumpy() for p in tparams.values()]
    assert len(grads) == len(jparams) == 14
    assert all(np.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("model,argv", [
    (tssd, ["--epochs", "1", "--iters", "2", "--batch-size", "2",
            "--img-size", "16", "--eval-batches", "1"]),
    (trcnn, ["--epochs", "1", "--iters", "2", "--batch-size", "2"]),
])
def test_main_finishes_on_the_cpu(model, argv):
    out = model.main(argv + ["--device", "cpu"])
    assert len(out["epoch_loss"]) == 1
    assert np.isfinite(out["epoch_loss"][0])
