"""The versioned tokenizer artifact: train once, commit, load by version
(port of ``repro/data/sharded/artifact.py``; the port's one loader of
``artifacts/tokenizer_<version>.json``).

The paper trains its 32K sentencepiece model once and ships it with the
model (§7.1); retraining the vocabulary changes every token id and
silently invalidates any checkpoint or cached class matrix built under the
old one. The repository's tokenizer has the same lifecycle:

  build_default_tokenizer()   — deterministic training on the full caption
                                grammar (``synthetic.grammar_corpus``), so
                                rebuilding gives a byte-identical artifact
  save_tokenizer / load_tokenizer — JSON with the piece inventory and its
                                sha256; loading verifies the hash and
                                refuses a tampered or hand-edited file
  artifacts/tokenizer_v1.json — the committed v1 artifact every launcher,
                                serving path and evaluation loads

The artifact hash (``Tokenizer.content_hash``) is folded into resumable
loader state (``sharded.loader.LoaderState``), so a vocabulary change
stops a resume instead of silently replaying different batches.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.data.synthetic import grammar_corpus
from repro_torch.data.tokenizer import Tokenizer

FORMAT = "repro-tokenizer"
DEFAULT_VERSION = "v1"
DEFAULT_VOCAB = 512   # fits every smoke tower (vocab=min(cfg.vocab, 512))

# <repo>/artifacts, four directories above src/repro_torch/data/sharded/
ARTIFACTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "..",
    "artifacts"))


def artifact_path(version: str = DEFAULT_VERSION,
                  directory: Optional[str] = None) -> str:
    """Path of ``tokenizer_<version>.json`` under ``directory`` (default:
    the repo's committed ``artifacts/``)."""
    return os.path.join(directory or ARTIFACTS_DIR,
                        f"tokenizer_{version}.json")


def build_default_tokenizer(version: str = DEFAULT_VERSION) -> Tokenizer:
    """Train the canonical tokenizer: the full grammar corpus, vocabulary
    512. A pure function of the grammar, so rebuilding cannot drift."""
    tok = Tokenizer.train(grammar_corpus(), vocab_size=DEFAULT_VOCAB)
    tok.version = version
    return tok


def save_tokenizer(tok: Tokenizer, path: str, *,
                   version: Optional[str] = None) -> str:
    """Write ``tok`` (pieces, sha256, version) to ``path`` atomically and
    return the path; the stored hash lets ``load_tokenizer`` verify that the
    file reproduces the tokenizer that wrote it."""
    version = version or tok.version
    payload = {
        "format": FORMAT,
        "version": version,
        "vocab_size": tok.vocab_size,
        "sha256": tok.content_hash(),
        "pieces": tok.pieces,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


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
        raise FileNotFoundError(
            f"no tokenizer artifact at {path}; build it with "
            f"`python scripts/build_tokenizer.py`") from None
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} artifact "
                         f"(format={payload.get('format')!r})")
    tok = Tokenizer(payload["pieces"], version=payload["version"])
    if tok.content_hash() != payload["sha256"]:
        raise ValueError(
            f"{path} hash mismatch: artifact says {payload['sha256'][:16]}…"
            f" but pieces hash to {tok.content_hash()[:16]}… — the file was"
            f" edited or truncated")
    if tok.vocab_size != payload["vocab_size"]:
        raise ValueError(f"{path} vocab_size {payload['vocab_size']} != "
                         f"reloaded {tok.vocab_size}")
    return tok
