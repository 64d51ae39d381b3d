"""Contrib operators of the SSD detector: MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection and box_nms.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py:25-297`` (reference
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc and bounding_box.cc), plain PyTorch as the JAX ops
are plain jnp.  Every shape follows from the inputs' shapes and the
attributes, the batch is the leading axis of every tensor (where the JAX
ops ``vmap``), and nothing is read back to the host (no ``.item()``, no
``nonzero``, no boolean-mask indexing, constants made on the device by
fills), so each op runs inside a captured CUDA graph such as the fused
fit step's.

- The prior does the JAX op's float32 arithmetic in the same order:
  its anchors are the JAX anchors bit for bit.
- The target's matching is argmax over the full anchor x object IoU
  matrix.  Where two objects claim one anchor, the later object wins, as
  the JAX package's scatter keeps its last writer on the CPU: here a
  ``scatter_reduce`` of the object indices by ``amax``, deterministic on
  the card too (a plain ``scatter_`` with repeated indices is not).
  Hard negatives are ranked by a stable sort, as ``jnp.argsort`` is.
- NMS (detection, ``box_nms``) is serial over the sorted boxes: a loop
  over the ranks, each step one vectorised pass over the batch.

The prior, the target and the detection give no gradient (the
reference's backwards write zeros): they run on detached inputs, so
autograd never walks through their sorts.  ``box_nms`` passes the
gradient of the rows it returns back to their input rows, as the JAX
op's gathers do.  ``ctc_loss`` stays with ROADMAP A.10.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "box_nms"]


def _floats(v):
    return tuple(float(s) for s in (v if isinstance(v, (tuple, list))
                                    else (v,)))


def _const(values, like):
    """A float32 vector of Python floats on ``like``'s device, each
    rounded to float32 once (as ``jnp.asarray(values, float32)``), made
    by fills: a host-to-device copy (which ``t[i] = v`` makes) would stop
    a graph capture."""
    out = torch.empty(len(values), dtype=torch.float32, device=like.device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def _sort_desc(key):
    """Indices sorting each row of ``key`` by decreasing value, ties in
    index order (``jnp.argsort(-key)``, which is stable and takes -0.0
    as 0.0: adding +0.0 makes every zero positive first)."""
    return torch.sort(key + 0.0, dim=-1, descending=True, stable=True)[1]


def _take(t, idx):
    """``t`` (B, N, ...) gathered along axis 1 by ``idx`` (B, K)."""
    shape = idx.shape + t.shape[2:]
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2))
                        .expand(shape))


def _iou(a, g):
    """IoU of every box of ``a`` (..., A, 4) with every box of ``g``
    (..., M, 4), corner format: (..., A, M) (the JAX ``_iou_matrix``'s
    arithmetic in its order)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    gx1, gy1, gx2, gy2 = g.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], gx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], gy1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], gx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], gy2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    a_area = ((ax2 - ax1) * (ay2 - ay1)).clamp_min(0.0)
    g_area = ((gx2 - gx1) * (gy2 - gy1)).clamp_min(0.0)
    union = a_area[..., :, None] + g_area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _serial_nms(sup, valid):
    """``alive`` (B, K): rank ``i`` lives when ``valid[:, i]`` and no
    living rank ``j < i`` suppresses it (``sup[:, i, j]``, already zero
    for ``j >= i``) — the JAX ``fori_loop``, one batched step a rank."""
    alive = torch.zeros_like(valid)
    for i in range(valid.shape[1]):
        alive[:, i] = valid[:, i] & ~(sup[:, i] & alive).any(1)
    return alive


# ----------------------------------------------------------------------
# MultiBoxPrior
# ----------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors for every cell of ``data``'s (H, W) map: (1, H * W *
    A, 4) corners in normalized coordinates, A = len(sizes) +
    len(ratios) - 1 (every size at the first ratio, then the first size
    at the other ratios).  Only ``data``'s shape is read."""
    h, w = data.shape[2], data.shape[3]
    sizes, ratios = _floats(sizes), _floats(ratios)
    step_y = 1.0 / h if steps[0] <= 0 else float(steps[0])
    step_x = 1.0 / w if steps[1] <= 0 else float(steps[1])
    f32, dev = torch.float32, data.device
    cy = (torch.arange(h, dtype=f32, device=dev) + float(offsets[0])) \
        * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + float(offsets[1])) \
        * step_x
    # half widths and heights in Python floats, then float32 once
    half = [(s * r ** 0.5 / 2.0, s / r ** 0.5 / 2.0)
            for s, r in [(s, ratios[0]) for s in sizes]
            + [(sizes[0], r) for r in ratios[1:]]]
    hx = _const([p[0] for p in half], cy)
    hy = _const([p[1] for p in half], cy)
    shape = (h, w, len(half))
    cxe, cye = cx[None, :, None], cy[:, None, None]
    out = torch.stack([(cxe - hx).expand(shape), (cye - hy).expand(shape),
                       (cxe + hx).expand(shape), (cye + hy).expand(shape)],
                      dim=-1)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out.reshape(1, -1, 4)


# ----------------------------------------------------------------------
# MultiBoxTarget
# ----------------------------------------------------------------------
@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3)
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to the objects of ``label`` (B, M, 5) rows [cls,
    xmin, ymin, xmax, ymax], cls -1 a pad row, and encode the offsets
    (``cls_pred`` (B, C, A) ranks the hard negatives).  Returns
    (loc_target (B, A * 4), loc_mask (B, A * 4), cls_target (B, A)):
    class + 1 for a positive, 0 for a negative, ``ignore_label`` for an
    anchor neither matched nor mined.  No gradient."""
    with torch.no_grad():
        return _target(anchor.detach().reshape(-1, 4), label.detach(),
                       cls_pred.detach(), float(overlap_threshold),
                       float(ignore_label), float(negative_mining_ratio),
                       float(negative_mining_thresh),
                       float(minimum_negative_samples), _floats(variances))


def _target(anchors, label, cls_pred, overlap, ignore, ratio, neg_thresh,
            min_neg, variances):
    f32, dev = torch.float32, anchors.device
    A = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    v = _const(variances, anchors)
    gt_cls, gt_boxes = label[..., 0], label[..., 1:5]
    valid = gt_cls >= 0                                     # (B, M)
    iou = torch.where(valid[:, None, :], _iou(anchors, gt_boxes), -1.0)

    # stage 1: each valid object claims its best anchor (pad rows go to
    # an extra column, dropped); the later object wins a shared anchor
    scatter_idx = torch.where(valid, iou.argmax(1), A)      # (B, M)
    claimed = torch.full((B, A + 1), -1, dtype=torch.int64, device=dev)
    claimed.scatter_reduce_(1, scatter_idx, torch.arange(
        M, device=dev).expand(B, M), "amax")
    # stage 2: anchors take their best object above the threshold
    best_gt, best_iou = iou.argmax(2), iou.amax(2)          # (B, A)
    matched = torch.where(claimed[:, :A] >= 0, claimed[:, :A],
                          torch.where(best_iou > overlap, best_gt, -1))
    is_pos = matched >= 0
    mg = matched.clamp(0, M - 1)
    cls_t = torch.where(is_pos, torch.gather(gt_cls, 1, mg) + 1.0, 0.0)

    if ratio > 0:
        # hard negatives: anchors whose best IoU stays below neg_thresh,
        # ranked by predicted non-background confidence (the JAX
        # softmax's arithmetic); the hardest max(ratio * positives,
        # min_neg) are class-0 negatives, the rest ignored
        e = torch.exp(cls_pred - cls_pred.amax(1, keepdim=True))
        neg_conf = 1.0 - e[:, 0] / e.sum(1)
        eligible = ~is_pos & (best_iou < neg_thresh)
        score = torch.where(eligible, neg_conf, float("-inf"))
        k = (is_pos.sum(1).to(f32) * ratio).clamp_min(min_neg)
        rank = torch.empty((B, A), dtype=torch.int64, device=dev).scatter_(
            1, _sort_desc(score), torch.arange(A, device=dev).expand(B, A))
        is_neg = eligible & (rank.to(f32) < k[:, None])
        cls_t = torch.where(is_pos | is_neg, cls_t, ignore)

    # SSD offsets of each positive anchor from its object
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp_min(1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp_min(1e-8)
    g = _take(gt_boxes, mg)                                 # (B, A, 4)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-8)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-8)
    loc_t = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                         torch.log(gw / aw) / v[2],
                         torch.log(gh / ah) / v[3]], dim=-1)
    loc_t = torch.where(is_pos[..., None], loc_t, 0.0)
    loc_m = is_pos[..., None].expand(B, A, 4).to(f32)
    return loc_t.reshape(B, -1), loc_m.reshape(B, -1), cls_t


# ----------------------------------------------------------------------
# MultiBoxDetection
# ----------------------------------------------------------------------
@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode ``loc_pred`` (B, A * 4) at the anchors and suppress
    overlaps of the same class (any class with ``force_suppress``) among
    the top ``nms_topk`` scores (every anchor when -1): (B, A, 6) rows
    [class id, score, xmin, ymin, xmax, ymax] by decreasing score, id -1
    for a suppressed, background or low row and for the rows past
    ``nms_topk``.  No gradient."""
    with torch.no_grad():
        return _detection(cls_prob.detach(), loc_pred.detach(),
                          anchor.detach().reshape(-1, 4), bool(clip),
                          float(threshold), int(background_id),
                          float(nms_threshold), bool(force_suppress),
                          _floats(variances), int(nms_topk))


def _detection(cls_prob, loc_pred, anchors, clip, threshold, background,
               nms_threshold, force, variances, nms_topk):
    A = anchors.shape[0]
    B = cls_prob.shape[0]
    v = _const(variances, anchors)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(B, A, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    # the best class other than the background; ids count the object
    # classes from 0 (channel minus the background slot before it)
    masked = cls_prob.transpose(1, 2).clone()               # (B, A, C)
    masked[..., background].fill_(-1.0)
    chan, score = masked.argmax(-1), masked.amax(-1)
    cls_id = chan - (chan > background).to(chan.dtype)
    keep = score > threshold
    cls_id = torch.where(keep, cls_id, -1)
    score = torch.where(keep, score, 0.0)

    k = min(nms_topk, A) if nms_topk > 0 else A
    order = _sort_desc(score)[:, :k]
    b_s, s_s, c_s = _take(boxes, order), _take(score, order), \
        _take(cls_id, order)
    sup = torch.ones(k, k, dtype=torch.bool, device=anchors.device).tril(-1) \
        & (c_s >= 0)[:, None, :] & (_iou(b_s, b_s) > nms_threshold)
    if not force:
        sup &= c_s[:, :, None] == c_s[:, None, :]
    alive = _serial_nms(sup, c_s >= 0)
    ids = torch.where(alive, c_s.to(torch.float32), -1.0)
    out = torch.cat([ids[..., None], s_s[..., None], b_s], dim=-1)
    if k < A:
        pad = torch.zeros((B, A - k, 6), dtype=out.dtype, device=out.device)
        pad[..., 0].fill_(-1.0)
        out = torch.cat([out, pad], dim=1)
    return out


# ----------------------------------------------------------------------
# box_nms
# ----------------------------------------------------------------------
@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", background_id=-1):
    """Non-maximum suppression over (..., N, K) rows: each batch of N
    rows sorted by decreasing score (rows at or below ``valid_thresh``,
    or of class ``background_id``, last), a row's score set to -1 where
    a higher living row of the same id (any id with ``force_suppress``
    or without ``id_index``) overlaps it above ``overlap_thresh`` or it
    is past ``topk``; boxes (from ``coord_start``) converted between
    ``corner`` and ``center`` formats as asked."""
    if in_format not in ("corner", "center") \
            or out_format not in ("corner", "center"):
        raise MXNetError("box_nms: formats are 'corner' and 'center', got "
                         "%r and %r" % (in_format, out_format))
    shape = data.shape
    rows = data.reshape(-1, shape[-2], shape[-1])
    N, cs, si = shape[-2], int(coord_start), int(score_index)
    with torch.no_grad():
        d = rows.detach()
        score = d[..., si]
        valid = score > valid_thresh
        if id_index >= 0 and background_id >= 0:
            valid &= d[..., id_index] != background_id
        order = _sort_desc(torch.where(valid, score, float("-inf")))
    r_s = _take(rows, order)
    boxes = r_s[..., cs:cs + 4]
    if in_format == "center":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2],
                            dim=-1)
    with torch.no_grad():
        b = boxes.detach()
        s_v = _take(valid, order)
        if topk > 0:
            s_v &= torch.arange(N, device=d.device) < topk
        sup = torch.ones(N, N, dtype=torch.bool, device=d.device).tril(-1) \
            & (_iou(b, b) > overlap_thresh)
        if id_index >= 0 and not force_suppress:
            ids = r_s.detach()[..., id_index]
            sup &= ids[:, :, None] == ids[:, None, :]
        alive = _serial_nms(sup, s_v)
    out = r_s.clone()
    out[..., si] = torch.where(alive, r_s[..., si], -1.0)
    if out_format != in_format:
        if out_format == "corner":
            out[..., cs:cs + 4] = boxes
        else:
            x1, y1, x2, y2 = boxes.unbind(-1)
            out[..., cs:cs + 4] = torch.stack(
                [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    return out.reshape(shape)
