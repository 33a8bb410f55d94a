"""Training (``aznet_tpu/train``): losses, SGD, the AZ and Fast R-CNN train
steps, labels, hard-region mining and the loops (``train.loop``:
``train_az_net``, ``train_frcnn_net``). A train step is eager PyTorch on the
card: forward, backward, one SGD update of the float32 masters."""

from aznet_tpu_torch.train.optim import lr_schedule, make_optimizer
from aznet_tpu_torch.train.train_az import (TrainState, az_loss, make_az_train_state,
                                            make_az_train_step)
from aznet_tpu_torch.train.train_frcnn import (frcnn_loss, make_frcnn_train_state,
                                               make_frcnn_train_step)
