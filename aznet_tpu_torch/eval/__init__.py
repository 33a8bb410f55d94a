"""Evaluation: proposal recall, VOC AP, COCO AP, and the dataset-level
propose / detect drivers (counterpart of ``aznet_tpu/eval``)."""

from aznet_tpu_torch.eval.recall import proposal_recall, recall_table
from aznet_tpu_torch.eval.voc_eval import voc_ap, voc_eval, eval_detections_on_roidb
from aznet_tpu_torch.eval.coco_eval import coco_eval
