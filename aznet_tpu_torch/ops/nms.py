"""Exact greedy NMS: plain PyTorch version, CUDA dispatch, and top-k.

Counterpart of ``aznet_tpu/ops/nms.py`` (``nms_mask``, ``nms_topk``). The
keep set is exact greedy NMS under the Pallas kernel's contract, which the
CUDA kernel (``ops/cuda/nms_kernel.py``) follows bit for bit:

- order: score descending, ties to the lower index, on a uint32 key that
  folds +-0 and all subnormals into the +0 key (``_intkey_u32`` in
  ``aznet_tpu/ops/pallas/nms_kernel.py``);
- a row is invalid when ``valid`` is false OR its score is -inf (the Pallas
  bitonic path's rule; the reference's fixpoint would keep a ``valid`` row
  whose score is -inf). Invalid rows sort last and are never kept;
- suppression: IoU > thresh against an earlier kept box, ``+offset`` widths,
  IoU 0 where the union is <= 0.

Dispatch (:func:`nms_mask_batched`): a CPU tensor takes the plain version, a
CUDA tensor launches the kernel for every N, or raises. Nothing falls back.
"""

from __future__ import annotations

import torch

from aznet_tpu_torch.ops.cuda import nms_kernel
from aznet_tpu_torch.ops.iou import bbox_overlaps
from aznet_tpu_torch.ops.topk import top_k

# Folded key of a -inf score: the invalid-row sentinel (largest valid key).
KEY_NEG_INF = 0xFF800000


def score_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2**32) whose ascending order is score-descending;
    +-0 and subnormals share the +0 key. Scores must be float32, NaN-free."""
    u = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where((u & 0x7F800000) == 0, torch.zeros_like(u), u)
    sign = u >> 31
    key = u ^ (sign * 0x7FFFFFFF + 0x80000000)
    return 0xFFFFFFFF - key  # uint32 complement: descending score first


def nms_mask_reference(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float, valid: torch.Tensor,
                       offset: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[B, N]`` keep masks in original
    order. Stable sort on the folded key, then the antitone fixpoint
    ``keep <- valid & ~any_j(S[:, j] & keep[j])`` over the strict-lower
    suppression matrix, which converges to exact greedy in at most
    suppression-chain-depth iterations (the reference's ``nms_mask``)."""
    bsz, n = scores.shape
    s = torch.where(valid, scores.float(), torch.full_like(scores, float("-inf"),
                                                           dtype=torch.float32))
    skeys, order = torch.sort(score_keys(s), dim=1, stable=True)
    svalid = skeys != KEY_NEG_INF
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(bsz, n, 4))
    thresh = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).tril(-1)
    supp = earlier & (bbox_overlaps(sboxes, sboxes, offset) > thresh) & svalid[:, None, :]
    keep = svalid
    while True:
        new = svalid & ~(supp & keep[:, None, :]).any(dim=2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter_(1, order, keep)


def nms_mask_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float, valid: torch.Tensor | None = None,
                     offset: float = 1.0) -> torch.Tensor:
    """Keep masks ``[B, N]`` for ``boxes [B, N, 4]``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if boxes.is_cuda:
        boxes = boxes.to(torch.float32).contiguous()
        if boxes.data_ptr() % 16:
            boxes = boxes.clone()
        return nms_kernel.nms_cuda_batched(
            boxes, scores.to(torch.float32).contiguous(), iou_threshold,
            valid.to(torch.bool).contiguous(), offset)
    if boxes.device.type != "cpu":
        raise ValueError(f"no NMS for device {boxes.device}")
    return nms_mask_reference(boxes, scores, iou_threshold, valid.to(torch.bool), offset)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None, offset: float = 1.0) -> torch.Tensor:
    """Exact greedy-NMS keep mask ``[N]`` bool for ``boxes [N, 4]``,
    ``scores [N]``, in the ORIGINAL box order."""
    return nms_mask_batched(boxes[None], scores[None], iou_threshold,
                            None if valid is None else valid[None], offset)[0]


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             k: int, valid: torch.Tensor | None = None, offset: float = 1.0):
    """NMS, then the top ``k`` kept boxes by score (ties to the lower index).
    Returns ``(boxes [k, 4], scores [k], valid [k])``, padded with zeros
    where fewer than ``k`` survive."""
    keep = nms_mask(boxes, scores, iou_threshold, valid=valid, offset=offset)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    kept_scores = torch.where(keep, scores, neg_inf)
    k_eff = min(k, boxes.shape[0])
    top_scores, top_idx = top_k(kept_scores, k_eff)
    out_valid = top_scores > neg_inf
    out_boxes = torch.where(out_valid[:, None], boxes[top_idx], 0.0)
    out_scores = torch.where(out_valid, top_scores, 0.0)
    if k_eff < k:
        pad = k - k_eff
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_boxes, out_scores, out_valid
