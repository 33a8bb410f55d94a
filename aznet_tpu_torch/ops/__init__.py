"""Tensor ops: boxes, IoU, preprocessing, ROI align, NMS, top-k."""
