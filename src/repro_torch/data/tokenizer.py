"""A small deterministic word-piece-style tokenizer (copy of
``repro/data/tokenizer.py``).

Greedy longest-match piece segmentation over a trained piece list, with
BOS/EOS framing and a 64-token length filter. ``content_hash()`` fingerprints
the piece inventory, so a retrained vocab is detectable wherever the hash
travels (the class-embedding registry key among them).
"""
from __future__ import annotations

import collections
import hashlib
import re
from typing import Iterable, List

import numpy as np

PAD, UNK, BOS, EOS = 0, 1, 2, 3
SPECIALS = ["<pad>", "<unk>", "<bos>", "<eos>"]
_WORD = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class Tokenizer:
    """Greedy longest-match word-piece tokenizer over a trained piece list.

    ``version`` names the artifact the pieces came from ("v1" when loaded
    through ``repro_torch.data.sharded.artifact``, "unversioned"
    otherwise)."""

    def __init__(self, pieces: List[str], version: str = "unversioned"):
        self.pieces = list(SPECIALS) + [p for p in pieces if p not in SPECIALS]
        self.index = {p: i for i, p in enumerate(self.pieces)}
        self.version = version

    @property
    def vocab_size(self) -> int:
        """Number of pieces including the 4 specials."""
        return len(self.pieces)

    def content_hash(self) -> str:
        """sha256 hex over the ordered piece inventory: equal hash means
        identical segmentation of every input."""
        h = hashlib.sha256()
        for p in self.pieces:
            h.update(p.encode())
            h.update(b"\x00")
        return h.hexdigest()

    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int = 32768,
              max_piece_len: int = 8) -> "Tokenizer":
        """Frequency-based piece selection: whole words first, then
        character n-grams of frequent words (deterministic)."""
        counts = collections.Counter()
        for text in corpus:
            for w in _WORD.findall(text.lower()):
                counts[w] += 1
        pieces = collections.Counter()
        for w, c in counts.items():
            pieces[w] += c
            for n in range(2, min(len(w), max_piece_len)):
                for i in range(len(w) - n + 1):
                    pieces[w[i:i + n]] += c // 4
        for ch in "abcdefghijklmnopqrstuvwxyz0123456789":
            pieces[ch] += 1
        top = [p for p, _ in pieces.most_common(vocab_size - len(SPECIALS))]
        return cls(top)

    def _segment(self, word: str) -> List[int]:
        out, i = [], 0
        while i < len(word):
            for j in range(len(word), i, -1):
                piece = word[i:j]
                if piece in self.index:
                    out.append(self.index[piece])
                    i = j
                    break
            else:
                out.append(UNK)
                i += 1
        return out

    def encode(self, text: str, max_len: int = 64, add_special=True):
        """Token ids for ``text`` (lowercased, greedy longest-match pieces),
        truncated to ``max_len``; with ``add_special`` the sequence is
        BOS-prefixed and always EOS-terminated."""
        ids: List[int] = [BOS] if add_special else []
        for w in _WORD.findall(text.lower()):
            ids.extend(self._segment(w))
        if add_special:
            ids.append(EOS)
        if len(ids) > max_len:
            ids = (ids[:max_len - 1] + [EOS]) if add_special \
                else ids[:max_len]
        return ids

    def pad_batch(self, seqs: List[List[int]], max_len: int = 64):
        """Right-pad id lists to ``(len(seqs), max_len)`` int32 plus the
        matching bool validity mask (True = real token)."""
        out = np.full((len(seqs), max_len), PAD, np.int32)
        mask = np.zeros((len(seqs), max_len), np.bool_)
        for i, s in enumerate(seqs):
            s = s[:max_len]
            out[i, :len(s)] = s
            mask[i, :len(s)] = True
        return out, mask
