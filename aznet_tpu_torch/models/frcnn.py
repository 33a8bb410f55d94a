"""Fast R-CNN detector: trunk + ROI pooling + classification/box head
(``aznet_tpu/models/frcnn.py``).

The same ``features`` / ``roi_pool_only`` / ``head_forward`` /
``roi_forward`` factoring as ``AZNet``, so proposals from the search are
scored on the same feature map; ``api.share_trunk`` makes the two nets hold
one trunk.
"""

from __future__ import annotations

from aznet_tpu_torch.config import ModelConfig
from aznet_tpu_torch.models.aznet import RoiNet
from aznet_tpu_torch.models.heads import FRCNNHead


class FRCNN(RoiNet):
    """``roi_forward`` returns ``cls_score [R, K]`` (logits) and ``bbox_pred
    [R, 4K]`` for K = ``NUM_CLASSES``."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig()):
        super().__init__(model_cfg)
        self.head = FRCNNHead(self.pooled_dim, model_cfg.NUM_CLASSES, **self.head_kwargs())
