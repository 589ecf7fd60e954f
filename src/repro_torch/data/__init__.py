"""Data layer of the port: tokenizer, the synthetic image-text world, the
prefetching pipeline and the sharded data subsystem (the committed
tokenizer artifact, augmentation, the resumable loader); numpy, copied
from the reference."""
from repro_torch.data.pipeline import (  # noqa: F401
    Prefetcher,
    contrastive_stream,
    host_rng,
)
from repro_torch.data.synthetic import (  # noqa: F401
    TEMPLATES,
    World,
    caption_corpus,
    classification_prompts,
    contrastive_batch,
    grammar_corpus,
    jft_batch,
    make_world,
    render_captions,
    render_images,
    world_for_tower,
)
from repro_torch.data.sharded import (  # noqa: F401
    HostLayout,
    ShardedLoader,
    default_augmentations,
    load_tokenizer,
)
from repro_torch.data.tokenizer import Tokenizer  # noqa: F401
