"""Datasets: the imdb base class and factory, PASCAL VOC, COCO, the
synthetic planted-boxes imdb, training minibatches and the multi-process
prefetcher (counterpart of ``aznet_tpu/data``)."""

from aznet_tpu_torch.data.imdb import Imdb, get_imdb, list_imdbs
from aznet_tpu_torch.data.synthetic import SyntheticImdb
