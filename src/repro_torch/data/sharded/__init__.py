"""The sharded data subsystem: the versioned tokenizer artifact, image
augmentation, and the shard-exact resumable loader (port of
``repro/data/sharded``)."""
from repro_torch.data.sharded.artifact import (  # noqa: F401
    build_default_tokenizer,
    load_tokenizer,
    save_tokenizer,
)
from repro_torch.data.sharded.augment import (  # noqa: F401
    ChannelNoise,
    HorizontalFlip,
    RandomCrop,
    apply_ops,
    default_augmentations,
)
from repro_torch.data.sharded.loader import (  # noqa: F401
    HostLayout,
    LoaderState,
    ShardedLoader,
    aug_rng,
    device_put_global,
)
