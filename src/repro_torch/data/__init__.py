"""Data layer of the port: tokenizer, the committed tokenizer artifact, and
the synthetic image world (numpy, copied from the reference)."""
from repro_torch.data.artifact import load_tokenizer  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    World,
    make_world,
    render_images,
    world_for_tower,
)
from repro_torch.data.tokenizer import Tokenizer  # noqa: F401
