"""The legacy loss layers, ``Crop``, ``_histogram``, the image ops and the
small contrib ops (counterpart of ``mxnet_tpu/ops/misc_ops.py``):
``MakeLoss`` :25, ``SVMOutput`` :57, ``Crop`` :99, ``_histogram`` :125,
``_image_to_tensor`` :158, ``_image_normalize`` :169,
``_contrib_quadratic`` :183, ``_contrib_index_copy`` :193,
``_contrib_bipartite_matching`` :200, ``_contrib_AdaptiveAvgPooling2D``
:249, ``_contrib_BilinearResize2D`` :279,
``_contrib_DeformablePSROIPooling`` :315 and the alias
``_contrib_MultiProposal`` of ``_contrib_Proposal`` :442.

``MakeLoss`` and ``SVMOutput`` carry gradients that are not their
forward's, in ``torch.autograd.Function``s, as the JAX ops' ``custom_vjp``.
"""
from __future__ import annotations

import numpy as np
import torch

from .contrib_ops import div_const
from .registry import alias, register
from .tensor_ops import _index

__all__ = []


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward replaces the head gradient by
    ``grad_scale`` (over the batch size, or over the count of entries above
    ``valid_thresh``, as ``normalization`` says)."""

    @staticmethod
    def forward(ctx, x, grad_scale, norm, valid_thresh):
        ctx.save_for_backward(x)
        ctx.grad_scale, ctx.norm = grad_scale, norm
        ctx.valid_thresh = valid_thresh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        scale = torch.tensor(ctx.grad_scale, dtype=x.dtype, device=x.device)
        if ctx.norm == "batch":
            scale = scale / x.shape[0]
        elif ctx.norm == "valid":
            n = torch.sum((x > ctx.valid_thresh).to(x.dtype))
            scale = scale / torch.clamp(n, min=1.0)
        return scale.expand(x.shape).clone(), None, None, None


@register("MakeLoss")
def _make_loss(attrs, data):
    return _MakeLoss.apply(data, float(attrs.get("grad_scale", 1.0)),
                           attrs.get("normalization", "null"),
                           float(attrs.get("valid_thresh", 0.0)))


class _SVMOutput(torch.autograd.Function):
    """Identity forward over the scores; the backward ignores the head
    gradient and gives the (squared, or ``use_linear``) hinge gradient
    against the integer label."""

    @staticmethod
    def forward(ctx, x, y, margin, reg, use_linear):
        ctx.save_for_backward(x, y)
        ctx.margin, ctx.reg, ctx.use_linear = margin, reg, use_linear
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        C = x.shape[1]
        onehot = (y.long().unsqueeze(1) == torch.arange(
            C, device=x.device)).to(x.dtype)
        score_y = torch.sum(x * onehot, dim=1, keepdim=True)
        viol = ctx.margin - score_y + x
        viol = torch.where(onehot > 0, torch.zeros_like(viol), viol)
        if ctx.use_linear:
            dx_other = (viol > 0).to(x.dtype)
        else:   # d/dx_j max(0, v)^2 = 2v
            dx_other = torch.where(viol > 0, 2.0 * viol,
                                   torch.zeros_like(viol))
        dx = ctx.reg * (dx_other - onehot * torch.sum(dx_other, dim=1,
                                                      keepdim=True))
        dy = torch.zeros_like(y) if y.is_floating_point() else None
        return dx, dy, None, None, None


@register("SVMOutput")
def _svm_output(attrs, data, label):
    return _SVMOutput.apply(data, label, float(attrs.get("margin", 1.0)),
                            float(attrs.get("regularization_coefficient",
                                            1.0)),
                            bool(attrs.get("use_linear", False)))


@register("Crop")
def _crop(attrs, *inputs):
    """Spatial crop of NCHW data to ``h_w`` or to a second input's H and
    W, at ``offset`` or centred (``center_crop``)."""
    data = inputs[0]
    _, _, H, W = data.shape
    if len(inputs) > 1:
        th, tw = int(inputs[1].shape[2]), int(inputs[1].shape[3])
    else:
        th, tw = (int(v) for v in attrs.get("h_w", (0, 0)))
    if bool(attrs.get("center_crop", False)):
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = (int(v) for v in attrs.get("offset", (0, 0)))
    return data[:, :, oy:oy + th, ox:ox + tw]


def _linspace(lo, hi, n, device):
    """``jnp.linspace(lo, hi, n)`` in float32: lo * (1 - t) + hi * t with
    t = i / (n - 1), the last entry ``hi``.  Computed on the host and
    copied, so that every device bins by the same edges (the card's
    division by a scalar is a product by its reciprocal)."""
    host = dict(dtype=torch.float32, device="cpu")
    t = torch.arange(n, **host) / float(n - 1)
    out = torch.tensor(lo, **host) * (1 - t) + torch.tensor(hi, **host) * t
    out[-1] = hi
    return out.to(device)


@register("_histogram", num_outputs=2)
def _histogram(attrs, data, bins=None):
    """``np.histogram``: ``bin_cnt`` bins over ``range``, or the edges
    given as the second input; (int32 counts, edges).  The last bin holds
    its right edge."""
    flat = data.reshape(-1)
    bin_cnt = attrs.get("bin_cnt")
    if bin_cnt is not None:
        n = int(bin_cnt)
        if attrs.get("range") is None:
            raise ValueError("_histogram with bin_cnt requires an explicit "
                             "range=(min, max)")
        lo, hi = attrs["range"]
        edges = _linspace(float(lo), float(hi), n + 1, data.device)
    else:
        edges = bins
        n = edges.shape[0] - 1
    idx = torch.searchsorted(edges.contiguous(), flat.contiguous(),
                             right=True) - 1
    idx = torch.where(flat == edges[-1], torch.full_like(idx, n - 1), idx)
    valid = (idx >= 0) & (idx < n) & (flat >= edges[0]) & (flat <= edges[-1])
    counts = torch.zeros(n, dtype=torch.int32, device=data.device)
    counts = counts.index_add(0, torch.where(valid, idx, torch.zeros_like(
        idx)), valid.to(torch.int32))
    return counts, edges


@register("_image_to_tensor")
def _image_to_tensor(attrs, data):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(attrs, data):
    """(x - mean) / std per channel of CHW or NCHW data."""
    mean = torch.tensor(attrs.get("mean", (0.0,)), dtype=torch.float32,
                        device=data.device)
    std = torch.tensor(attrs.get("std", (1.0,)), dtype=torch.float32,
                       device=data.device)
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register("_contrib_quadratic")
def _quadratic(attrs, data):
    """a x^2 + b x + c."""
    a = float(attrs.get("a", 0.0))
    b = float(attrs.get("b", 0.0))
    c = float(attrs.get("c", 0.0))
    return a * data * data + b * data + c


@register("_contrib_index_copy")
def _index_copy(attrs, old, index, new):
    """``old`` with its rows at ``index`` replaced by ``new``'s."""
    from .tensor_ops import _scatter
    return _scatter(old, index.reshape(1, -1), new)


def _adaptive_weights(n_in, n_out, dtype, device):
    """(n_out, n_in): output cell i averages inputs
    floor(i n_in / n_out) .. ceil((i + 1) n_in / n_out)."""
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        a = (i * n_in) // n_out
        b = -(-((i + 1) * n_in) // n_out)
        w[i, a:b] = 1.0 / (b - a)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool2d(attrs, data):
    """Average pooling of NCHW data to ``output_size``, as two products
    with the cells' averaging weights (the JAX op's einsums)."""
    out_size = attrs.get("output_size")
    _, _, H, W = data.shape
    if out_size is None:
        oh = ow = 1
    elif isinstance(out_size, (tuple, list)):
        oh, ow = int(out_size[0]), int(out_size[-1])
    else:
        oh = ow = int(out_size)
    wh = _adaptive_weights(H, oh, data.dtype, data.device)
    ww = _adaptive_weights(W, ow, data.dtype, data.device)
    t = torch.einsum("nchw,oh->ncow", data, wh)
    return torch.einsum("ncow,pw->ncop", t, ww)


@register("_contrib_BilinearResize2D")
def _bilinear_resize2d(attrs, data, like=None):
    """Bilinear resize of NCHW data to (``height``, ``width``) (or a
    second input's, or ``scale_*`` times the input's), align-corners:
    output i samples input i (in - 1) / (out - 1)."""
    _, _, H, W = data.shape
    if like is not None:
        oh, ow = int(like.shape[2]), int(like.shape[3])
    else:
        oh = int(attrs.get("height", 0)) or int(
            H * float(attrs.get("scale_height", 1.0)))
        ow = int(attrs.get("width", 0)) or int(
            W * float(attrs.get("scale_width", 1.0)))

    def coords(n_in, n_out):
        if n_out == 1:
            return torch.zeros(1, dtype=torch.float32, device=data.device)
        scale = torch.tensor((n_in - 1.0) / (n_out - 1.0),
                             dtype=torch.float32)
        return torch.arange(n_out, dtype=torch.float32,
                            device=data.device) * scale.to(data.device)

    fy, fx = coords(H, oh), coords(W, ow)
    y0 = torch.floor(fy).long().clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x0 = torch.floor(fx).long().clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    wy = (fy - y0.to(torch.float32))[None, None, :, None]
    wx = (fx - x0.to(torch.float32))[None, None, None, :]
    rows0, rows1 = data[:, :, y0, :], data[:, :, y1, :]
    top = rows0[:, :, :, x0] * (1 - wx) + rows0[:, :, :, x1] * wx
    bot = rows1[:, :, :, x0] * (1 - wx) + rows1[:, :, :, x1] * wx
    return top * (1 - wy) + bot * wy


@register("_contrib_bipartite_matching", num_outputs=2)
def _bipartite_matching(attrs, score):
    """Greedy bipartite matching over the trailing (row, col) score matrix
    (bounding_box.cc BipartiteMatching): edges in stably sorted score order
    (descending unless ``is_ascend``); a row and a column pair up the first
    time both are free and the score passes ``threshold``; ``topk`` caps
    the matches.  Returns (row_marker, col_marker), the partner index or
    -1.  The reference's R * C-step ``fori_loop`` is a Python loop here, of
    about fourteen small ops a step over the whole batch."""
    is_ascend = bool(attrs.get("is_ascend", False))
    threshold = float(attrs["threshold"])
    topk = int(attrs.get("topk", -1))
    *batch, R, C = score.shape
    s = score.reshape(-1, R * C)
    Bf = s.shape[0]
    dev = score.device
    order = torch.argsort(s if is_ascend else -s, dim=1, stable=True)
    limit = topk if topk >= 0 else R * C
    rows = torch.arange(Bf, device=dev)
    row_m = torch.full((Bf, R), -1, dtype=torch.int64, device=dev)
    col_m = torch.full((Bf, C), -1, dtype=torch.int64, device=dev)
    n = torch.zeros(Bf, dtype=torch.int64, device=dev)
    for i in range(R * C):
        e = order[:, i]
        r, c = e // C, e % C
        val = s[rows, e]
        passes = (val <= threshold) if is_ascend else (val >= threshold)
        ok = passes & (row_m[rows, r] < 0) & (col_m[rows, c] < 0) & (
            n < limit)
        row_m[rows, r] = torch.where(ok, c, row_m[rows, r])
        col_m[rows, c] = torch.where(ok, r, col_m[rows, c])
        n += ok.to(torch.int64)
    return (row_m.to(score.dtype).reshape(tuple(batch) + (R,)),
            col_m.to(score.dtype).reshape(tuple(batch) + (C,)))


@register("_contrib_DeformablePSROIPooling", num_outputs=2)
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """Deformable position-sensitive ROI pooling
    (deformable_psroi_pooling.cu): each bin averages ``sample_per_part^2``
    bilinear samples at positions shifted by the learned normalized
    offsets in ``trans`` (times ``trans_std`` and the ROI's extent).
    Returns (output, top_count), the count of in-bounds samples."""
    scale = float(attrs.get("spatial_scale", 1.0))
    out_dim = int(attrs["output_dim"])
    pooled = int(attrs["pooled_size"])
    gs = int(attrs.get("group_size", 0)) or pooled
    part = int(attrs.get("part_size", 0)) or pooled
    sp = int(attrs.get("sample_per_part", 1))
    trans_std = float(attrs.get("trans_std", 0.0))
    no_trans = bool(attrs.get("no_trans", False)) or trans is None
    N, Cc, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    batch_ind = _index(rois[:, 0])
    # roi corners in feature coordinates, 0.5-centred like the CUDA kernel
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    roi_w = torch.maximum(x2 - x1, x2.new_full((), 0.1))
    roi_h = torch.maximum(y2 - y1, y2.new_full((), 0.1))
    bin_w = div_const(roi_w, pooled)
    bin_h = div_const(roi_h, pooled)
    sub_w = div_const(bin_w, sp)
    sub_h = div_const(bin_h, sp)
    ph = torch.arange(pooled, device=dev)
    pw = torch.arange(pooled, device=dev)
    part_h = (ph * part) // pooled
    part_w = (pw * part) // pooled
    if no_trans:
        zeros = torch.zeros((R, pooled, pooled), device=dev)
        ncls = 1
    else:
        ncls = trans.shape[1] // 2
        tx_all = trans[:, 0::2, :, :] * trans_std
        ty_all = trans[:, 1::2, :, :] * trans_std
    cpc = max(out_dim // ncls, 1)
    iy = torch.arange(sp, dtype=torch.float32, device=dev)
    ix = torch.arange(sp, dtype=torch.float32, device=dev)
    img = data[batch_ind]                               # (R, C, H, W)
    flat_img = img.reshape(R, Cc, H * W)
    gh = torch.clamp((ph * gs) // pooled, 0, gs - 1)
    gw = torch.clamp((pw * gs) // pooled, 0, gs - 1)

    def per_class(cls):
        if no_trans:
            txc = tyc = zeros
        else:
            txc = tx_all[:, cls][:, part_h][:, :, part_w]   # (R, P, P)
            tyc = ty_all[:, cls][:, part_h][:, :, part_w]
        wstart = (pw[None, :] * bin_w[:, None] + x1[:, None])[:, None, :] \
            + txc * roi_w[:, None, None]
        hstart = (ph[None, :] * bin_h[:, None] + y1[:, None])[:, :, None] \
            + tyc * roi_h[:, None, None]
        sw = wstart[..., None, None] + ix[None, :][None, None, None] \
            * sub_w[:, None, None, None, None]              # (R,P,P,1,S)
        sh = hstart[..., None, None] + iy[:, None][None, None, None] \
            * sub_h[:, None, None, None, None]              # (R,P,P,S,1)
        sw = sw.expand(sw.shape[:3] + (sp, sp))
        sh = sh.expand(sh.shape[:3] + (sp, sp))
        inb = (sw >= -0.5) & (sw <= W - 0.5) & (sh >= -0.5) & (
            sh <= H - 0.5)
        swc = torch.clamp(sw, 0.0, W - 1.0)
        shc = torch.clamp(sh, 0.0, H - 1.0)
        xx0 = _index(torch.floor(swc))
        yy0 = _index(torch.floor(shc))
        xx1 = torch.clamp(xx0 + 1, max=W - 1)
        yy1 = torch.clamp(yy0 + 1, max=H - 1)
        ax = swc - xx0
        ay = shc - yy0
        cch = (torch.arange(cpc, device=dev)[:, None, None] + cls * cpc) \
            * gs * gs + gh[None, :, None] * gs + gw[None, None, :]

        def sample(yyi, xxi):
            lin = (yyi * W + xxi).reshape(R, 1, -1).expand(R, Cc, -1)
            got = torch.gather(flat_img, 2, lin)
            return got.reshape(R, Cc, pooled, pooled, sp, sp)

        ay_, ax_ = ay[:, None], ax[:, None]
        val = (sample(yy0, xx0) * (1 - ay_) * (1 - ax_)
               + sample(yy0, xx1) * (1 - ay_) * ax_
               + sample(yy1, xx0) * ay_ * (1 - ax_)
               + sample(yy1, xx1) * ay_ * ax_)              # (R,C,P,P,S,S)
        val = torch.where(inb[:, None], val, 0.0)
        cnt = inb.sum(dim=(-1, -2)).to(data.dtype)          # (R, P, P)
        summed = val.sum(dim=(-1, -2))                      # (R, C, P, P)
        picked = summed[torch.arange(R, device=dev)[:, None, None, None],
                        cch[None], ph[None, None, :, None],
                        pw[None, None, None, :]]            # (R, cpc, P, P)
        out = torch.where(cnt[:, None] > 0, picked / torch.clamp(
            cnt[:, None], min=1.0), 0.0)
        return out, cnt[:, None].expand(out.shape)

    outs, counts = zip(*(per_class(cls) for cls in range(ncls)))
    out = torch.cat(outs, dim=1)[:, :out_dim]
    top_count = torch.cat(counts, dim=1)[:, :out_dim].to(data.dtype)
    return out, top_count


alias("_contrib_MultiProposal", "_contrib_Proposal")
