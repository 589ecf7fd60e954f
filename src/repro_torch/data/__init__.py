"""Data layer of the port: tokenizer, the committed tokenizer artifact, and
the synthetic image-text world (numpy, copied from the reference)."""
from repro_torch.data.artifact import load_tokenizer  # noqa: F401
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
from repro_torch.data.tokenizer import Tokenizer  # noqa: F401
