"""paddle_tpu_torch.io: Dataset / DataLoader (port of ``paddle_tpu/io``;
reference python/paddle/io/).

``dataset.py`` and ``sampler.py`` are the JAX package's modules
verbatim.  ``DataLoader`` iterates in the calling process (with a
prefetch thread by default) or over forked worker processes that never
touch the card; ``prefetch_to_device`` stages batches on the card ahead
of the step.
"""

from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)
from .device_prefetch import prefetch_to_device  # noqa: F401
from .dataloader import (  # noqa: F401
    DataLoader,
    default_collate_fn,
    get_worker_info,
)
