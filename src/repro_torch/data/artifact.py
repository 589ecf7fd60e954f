"""Loading the committed, versioned tokenizer artifact (copy of
``load_tokenizer`` from ``repro/data/sharded/artifact.py``).

``artifacts/tokenizer_<version>.json`` holds the piece inventory and its
sha256; loading verifies the hash, so a hand-edited or truncated file fails
loudly instead of mis-tokenizing.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.data.tokenizer import Tokenizer

FORMAT = "repro-tokenizer"
DEFAULT_VERSION = "v1"

# <repo>/artifacts, three directories above src/repro_torch/data/
ARTIFACTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "artifacts"))


def artifact_path(version: str = DEFAULT_VERSION,
                  directory: Optional[str] = None) -> str:
    """Path of ``tokenizer_<version>.json`` under ``directory`` (default:
    the repo's committed ``artifacts/``)."""
    return os.path.join(directory or ARTIFACTS_DIR,
                        f"tokenizer_{version}.json")


def load_tokenizer(version: str = DEFAULT_VERSION, *,
                   directory: Optional[str] = None,
                   path: Optional[str] = None) -> Tokenizer:
    """Load a versioned artifact (default: the committed v1), verifying
    the stored sha256 and vocab size against the reloaded pieces."""
    path = path or artifact_path(version, directory)
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"no tokenizer artifact at {path}") from None
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} artifact "
                         f"(format={payload.get('format')!r})")
    tok = Tokenizer(payload["pieces"], version=payload["version"])
    if tok.content_hash() != payload["sha256"]:
        raise ValueError(
            f"{path} hash mismatch: artifact says {payload['sha256'][:16]}…"
            f" but pieces hash to {tok.content_hash()[:16]}…")
    if tok.vocab_size != payload["vocab_size"]:
        raise ValueError(f"{path} vocab_size {payload['vocab_size']} != "
                         f"reloaded {tok.vocab_size}")
    return tok
