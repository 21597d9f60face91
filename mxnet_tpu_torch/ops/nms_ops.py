"""Greedy non-maximum suppression on the card.

The JAX package writes greedy NMS as a ``lax.fori_loop`` over the
score-sorted boxes in three ops of ``mxnet_tpu/ops/contrib_ops.py``:
``_contrib_MultiBoxDetection`` (:253), ``_contrib_box_nms`` (:298) and
``_contrib_Proposal`` (:515).  Each builds the suppression relation from
the boxes' IoU (the first two as an A x A ``jnp`` array that XLA fuses,
Proposal inside the loop body) and XLA compiles the loop into one
device-side while loop.  So the port runs the whole of it, the IoU and
the recurrence, in a hand-written CUDA kernel pair,
``csrc/greedy_nms.cu``, built by ``_kernels.py`` at first use: the first
kernel computes the relation of the score-sorted boxes as 64-bit words
(no K x K tensor is made), the second scans the words.  It is not the
port of a Pallas kernel: the reference has none here.

The plain version sits beside it: :func:`suppression_mask` (the ops' IoU
arithmetic in torch ops, as a (B, K, K) bool mask) and
:func:`greedy_nms_reference` (a loop that mirrors the ``fori_loop``
bodies), run together by :func:`greedy_nms_plain`.  A tensor on the CPU
takes it; a tensor on a CUDA device launches the kernels or raises.
There is no fallback from one to the other.  The kernels repeat the
plain version's float operations one for one, each rounded on its own
to the boxes' dtype (float32, float64, float16 or bfloat16, the last two
computed in float32 and rounded after every operation, as torch's ops
are), so both paths make the same keep decisions bit for bit;
:func:`pack_words` turns a mask into the kernels' word layout for the
comparison.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError

__all__ = ["greedy_nms", "greedy_nms_plain", "greedy_nms_reference",
           "suppression_mask", "nms_mask", "proposal_mask", "box_iou_xyxy",
           "pack_words", "MAX_K", "FORMS"]

MAX_K = 65536   # csrc/greedy_nms.cu kMaxK: the removed set in shared memory
FORMS = ("corner", "proposal")
# the boxes' dtypes by their code in csrc/greedy_nms.cu (box_type)
_BOX_TYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)
_launch_lock = threading.Lock()


def _maximum(x, v):
    """``jnp.maximum(x, v)`` for a scalar ``v``: NaN propagates, and ties
    split the gradient in half, as JAX's does (``clamp_min`` passes it
    whole)."""
    return torch.maximum(x, x.new_full((), v))


def box_iou_xyxy(a, b):
    """IoU between (..., 4) corner boxes, broadcasting: the JAX package's
    ``_box_iou_xyxy``, operation for operation.  The ``corner`` form of
    the kernels repeats it with a = row j and b = column i."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    iw = _maximum(ix2 - ix1, 0.0)
    ih = _maximum(iy2 - iy1, 0.0)
    inter = iw * ih
    area_a = (_maximum(a[..., 2] - a[..., 0], 0.0)
              * _maximum(a[..., 3] - a[..., 1], 0.0))
    area_b = (_maximum(b[..., 2] - b[..., 0], 0.0)
              * _maximum(b[..., 3] - b[..., 1], 0.0))
    return inter / _maximum(area_a + area_b - inter, 1e-12)


def nms_mask(boxes, ids, thresh):
    """The ``corner`` suppression relation of score-sorted boxes (B, K, 4)
    with class ids (B, K) or None: ``sup[b, j, i] = iou(j, i) > thresh``
    (and the same id where ids are given), the JAX ops' ``(iou > thresh)
    & same``.  Built a few batch rows at a time (~8 GiB of K x K fp32
    temporaries)."""
    B, K = boxes.shape[:2]
    chunk = max(1, (8 << 30) // max(1, K * K * 4 * 10))
    sup = torch.empty((B, K, K), dtype=torch.bool, device=boxes.device)
    with torch.no_grad():
        for lo in range(0, B, chunk):
            bx = boxes[lo:lo + chunk]
            s = box_iou_xyxy(bx[:, :, None, :], bx[:, None, :, :]) > thresh
            if ids is not None:
                idc = ids[lo:lo + chunk]
                s &= idc[:, :, None] == idc[:, None, :]
            sup[lo:lo + chunk] = s
    return sup


def proposal_mask(boxes, thresh):
    """Proposal's suppression relation over its K1 candidates (B, K1, 4):
    ``sup[b, j, i] = iou(j, i) > thresh`` with the +1-pixel IoU of the
    JAX op's NMS body (its row for j), so ``supp | kill`` is the scan of
    :func:`greedy_nms_reference` from an all-true ``init``."""
    with torch.no_grad():
        area = ((boxes[..., 2] - boxes[..., 0] + 1.0)
                * (boxes[..., 3] - boxes[..., 1] + 1.0))
        a, b = boxes[:, :, None, :], boxes[:, None, :, :]
        ix1 = torch.maximum(a[..., 0], b[..., 0])
        iy1 = torch.maximum(a[..., 1], b[..., 1])
        ix2 = torch.minimum(a[..., 2], b[..., 2])
        iy2 = torch.minimum(a[..., 3], b[..., 3])
        inter = (_maximum(ix2 - ix1 + 1.0, 0.0)
                 * _maximum(iy2 - iy1 + 1.0, 0.0))
        iou = inter / (area[:, :, None] + area[:, None, :] - inter)
        return iou > thresh


def suppression_mask(boxes, ids, thresh, *, form="corner"):
    """``sup`` (B, K, K) bool of one form: :func:`nms_mask` or
    :func:`proposal_mask`."""
    if form == "proposal":
        return proposal_mask(boxes, thresh)
    return nms_mask(boxes, ids, thresh)


def pack_words(sup):
    """A (B, K, K) bool mask in the kernels' word layout: (B, K, ceil(K /
    64)) int64, bit t of word w in row j is column 64 w + t, set only for
    columns i > j.  Packs bytes (8 columns each, little-endian) a few rows
    at a time, so its temporaries stay near 1 GB."""
    B, K = sup.shape[:2]
    W = (K + 63) // 64
    weights = torch.tensor([1 << q for q in range(8)], dtype=torch.uint8,
                           device=sup.device)
    words = torch.empty((B, K, W), dtype=torch.int64, device=sup.device)
    col = torch.arange(W * 64, device=sup.device)
    rows = max(1, (1 << 30) // max(1, B * W * 64))
    with torch.no_grad():
        for lo in range(0, K, rows):
            j = torch.arange(lo, min(K, lo + rows), device=sup.device)
            part = torch.zeros((B, len(j), W * 64), dtype=torch.uint8,
                               device=sup.device)
            part[..., :K] = sup[:, lo:lo + len(j)]
            part &= (col[None, :] > j[:, None]).to(torch.uint8)
            packed = (part.view(B, len(j), W * 8, 8) * weights).sum(
                -1, dtype=torch.uint8)
            words[:, lo:lo + len(j)] = packed.view(torch.int64)
    return words


def greedy_nms_reference(sup, init):
    """The plain scan: ``keep = init``, then for i in order
    ``keep[:, i] &= not any(keep[:, j] & sup[:, j, i] for j < i)``."""
    keep = init.clone()
    for i in range(1, init.shape[1]):
        hit = (sup[:, :i, i] & keep[:, :i]).any(dim=1)
        keep[:, i] &= ~hit
    return keep


def greedy_nms_plain(boxes, ids, init, thresh, *, form="corner"):
    """The plain version of :func:`greedy_nms`: the torch-op mask, then
    the plain scan."""
    return greedy_nms_reference(
        suppression_mask(boxes, ids, thresh, form=form), init)


def _check(boxes, ids, init, form):
    if form not in FORMS:
        raise ValueError("greedy_nms form must be one of %s, got %r"
                         % (FORMS, form))
    if boxes.dim() != 3 or boxes.shape[2] != 4 or init.dim() != 2 or tuple(
            boxes.shape[:2]) != tuple(init.shape):
        raise ValueError("greedy_nms takes boxes (B, K, 4) and init (B, K), "
                         "got %s and %s" % (tuple(boxes.shape),
                                            tuple(init.shape)))
    if ids is not None and tuple(ids.shape) != tuple(init.shape):
        raise ValueError("greedy_nms takes ids (B, K) or None, got %s"
                         % (tuple(ids.shape),))
    if form == "proposal" and ids is not None:
        raise ValueError("greedy_nms's proposal form compares no ids")
    if not boxes.dtype.is_floating_point or init.dtype != torch.bool or (
            ids is not None and (ids.dtype == torch.bool or ids.is_complex())):
        raise TypeError("greedy_nms takes floating boxes, real ids and bool "
                        "init, got %s, %s and %s"
                        % (boxes.dtype, None if ids is None else ids.dtype,
                           init.dtype))
    devices = {t.device for t in (boxes, ids, init) if t is not None}
    if len(devices) > 1:
        raise ValueError("greedy_nms's inputs on different devices: %s"
                         % sorted(str(d) for d in devices))
    if init.shape[1] > MAX_K:
        raise ValueError("greedy_nms takes K <= %d candidates, got %d"
                         % (MAX_K, init.shape[1]))
    return boxes.device.type


def greedy_nms(boxes, ids, init, thresh, *, form="corner"):
    """Greedy NMS over candidates already in score order.

    ``boxes`` (B, K, 4) [x1, y1, x2, y2] and ``ids`` (B, K) class ids, or
    None for no id test, in score order; ``init`` (B, K) bool: the
    candidates that may be kept at all.  Candidate j, if kept, suppresses
    a later i when their IoU is above ``thresh`` (compared in the boxes'
    dtype, as torch compares a tensor with a Python float) and their ids,
    where given, are equal.  ``form`` is ``"corner"`` (MultiBoxDetection,
    box_nms: the JAX package's ``_box_iou_xyxy``) or ``"proposal"``
    (Proposal's +1-pixel IoU, no ids).  Boxes of any floating dtype; ids
    of any real dtype, compared by value.  Returns ``keep`` (B, K) bool with
    ``keep[b, i] = init[b, i] and not any(keep[b, j] and sup[b, j, i] for
    j < i)``.

    CPU tensors run :func:`greedy_nms_plain`, CUDA tensors the kernels
    (K up to :data:`MAX_K`), or it raises; ``meta`` tensors (symbolic
    shape inference) give an empty result of the right shape.
    """
    kind = _check(boxes, ids, init, form)
    if kind == "cpu":
        return greedy_nms_plain(boxes, ids, init, thresh, form=form)
    if kind == "meta":
        return torch.empty_like(init)
    if kind != "cuda":
        raise MXNetError("greedy_nms runs on CUDA or CPU tensors, got "
                         "device %s" % boxes.device)
    keep = _scan_cuda(_words_cuda(boxes, ids, thresh, form), init)
    if not torch.cuda.is_current_stream_capturing():
        with _launch_lock:
            greedy_nms.launches += 1
    return keep


# launches of the kernel pair (words, then scan), one a call
greedy_nms.launches = 0


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, what, B, K):
    if err != 0:
        raise MXNetError("greedy_nms %s kernel launch failed: cudaError %d "
                         "at B %d K %d" % (what, err, B, K))


def _words_cuda(boxes, ids, thresh, form):
    """Launch the words kernel: (B, K, ceil(K / 64)) int64.  The threshold
    goes as a double holding its value in the boxes' dtype (the rounding
    torch applies to a Python float compared with such a tensor); ids go
    as float32 where they are float32, float16 or bfloat16, else as
    float64 (exact widenings, and exact for integers up to 2^53, so ``==``
    is unchanged)."""
    B, K = boxes.shape[:2]
    if boxes.dtype not in _BOX_TYPES:
        raise TypeError("greedy_nms kernel takes boxes of %s, got %s"
                        % (", ".join(str(t) for t in _BOX_TYPES),
                           boxes.dtype))
    if ids is not None and ids.dtype not in (torch.float32, torch.float64):
        ids = ids.float() if ids.dtype in _BOX_TYPES else ids.double()
    if not (boxes.is_contiguous() and (ids is None or ids.is_contiguous())):
        raise ValueError("greedy_nms kernel needs contiguous boxes and ids")
    words = torch.empty((B, K, (K + 63) // 64), dtype=torch.int64,
                        device=boxes.device)
    if B < 1 or K < 1:
        return words
    from .. import _kernels
    lib = _kernels.load("greedy_nms")
    thresh = torch.tensor(thresh, dtype=boxes.dtype).item()
    id_type = 0 if ids is None else 1 + (ids.dtype == torch.float64)
    with torch.cuda.device(boxes.device):
        err = lib.mxt_greedy_nms_words(
            boxes.data_ptr(), None if ids is None else ids.data_ptr(),
            words.data_ptr(), B, K, thresh, FORMS.index(form),
            _BOX_TYPES.index(boxes.dtype), id_type, _stream(boxes))
    _raise_on(err, "words", B, K)
    return words


def _scan_cuda(words, init):
    """Launch the scan kernel over the words: keep (B, K) bool."""
    B, K = init.shape
    if not init.is_contiguous():
        raise ValueError("greedy_nms kernel needs a contiguous init")
    keep = torch.empty((B, K), dtype=torch.bool, device=init.device)
    if B < 1 or K < 1:
        return keep
    from .. import _kernels
    lib = _kernels.load("greedy_nms")
    with torch.cuda.device(init.device):
        err = lib.mxt_greedy_nms_scan(words.data_ptr(), init.data_ptr(),
                                      keep.data_ptr(), B, K, _stream(init))
    _raise_on(err, "scan", B, K)
    return keep
