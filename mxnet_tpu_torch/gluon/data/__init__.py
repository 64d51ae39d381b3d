"""Dataset, Sampler and DataLoader (counterpart of
``mxnet_tpu/gluon/data``)."""
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
