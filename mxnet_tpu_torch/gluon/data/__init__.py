"""Gluon's data API (port of `mxnet_tpu/gluon/data/`): datasets,
samplers, DataLoader and `vision`. Datasets and batches live in host
memory; a batch reaches the card through `as_in_context` or the
loader's `device_prefetch`."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler, IntervalSampler)
from .dataloader import (DataLoader, default_batchify_fn,
                         default_mp_batchify_fn, prefetch_to_device)
from . import vision
