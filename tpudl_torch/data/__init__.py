"""The port's data layer (tpudl.data): the Parquet converter and its
writers, the dataset helpers and ingesters, the WordPiece and byte-level
BPE tokenizers, the CV augmenter with its native kernel, the device
prefetcher and the synthetic batches. Exports what tpudl.data exports."""

from tpudl_torch.data.augment import BatchAugmenter  # noqa: F401
from tpudl_torch.data.converter import (  # noqa: F401
    Converter,
    make_converter,
    write_parquet,
)
from tpudl_torch.data.prefetch import (  # noqa: F401
    DevicePrefetcher,
    PrefetchAutotuner,
    prefetch_to_device,
)
from tpudl_torch.data.ingest import (  # noqa: F401
    ingest_cifar10,
    ingest_image_folder,
    ingest_sst2_tsv,
)
from tpudl_torch.data.datasets import (  # noqa: F401
    materialize_cifar10_like,
    materialize_imagenet_like,
    materialize_sst2_like,
)
from tpudl_torch.data.synthetic import (  # noqa: F401
    synthetic_classification_batches,
)
