"""CLIP byte-pair-encoding tokenizer (host-side, pure Python).

The port's own copy of the JAX package's tokenizer; it gives identical ids.

Replaces the reference's HF ``CLIPTokenizer`` download
(modules/openclip/modules.py:100) with an offline-capable implementation
of the same algorithm: byte-to-unicode mapping, per-word BPE merges with
``</w>`` end-of-word markers, lowercasing, and the CLIP text regex.

Vocabulary sources (first found wins):
  1. explicit ``vocab_path``/``merges_path`` arguments
  2. ``$INSV2V_CLIP_VOCAB`` / ``$INSV2V_CLIP_MERGES`` env vars
  3. the HF hub cache, if a clip-vit-large-patch14 snapshot is present

Encoding matches HF semantics used by the reference: sequences are
``<|startoftext|> tokens <|endoftext|>`` truncated to 77 and padded with
the end-of-text id (pad positions remain attended; the text model is
causal, so this is parity-relevant).
"""

from __future__ import annotations

import functools
import glob
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import re

import numpy as np

__all__ = ["ClipTokenizer", "HashTokenizer", "find_clip_vocab", "get_tokenizer"]

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
MAX_LEN = 77

_WORD_PAT_SRC = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


@functools.lru_cache()
def _word_pat():
    """The CLIP word regex needs the ``regex`` package's Unicode classes;
    imported on first BPE use so the hash fallback needs only ``re``."""
    import regex

    return regex.compile(_WORD_PAT_SRC, regex.IGNORECASE)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte <-> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    """BPE tokenizer compatible with HF CLIPTokenizer given the same vocab."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "ClipTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _word_pat().findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LEN) -> np.ndarray:
        """Batch encode to (B, max_length) int32 with sot/eot + eot-padding."""
        out = np.full((len(texts), max_length), self.eot_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.tokenize(t)[: max_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[ch] for ch in text if ch in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


class HashTokenizer:
    """Deterministic fallback when no BPE vocab is available offline.

    NOT CLIP-compatible — maps each whitespace word to a stable id via
    FNV-1a hashing.  Exists so smoke tests and random-weight pipelines run
    in fully offline environments; real editing quality requires the true
    vocab (see ``find_clip_vocab``).
    """

    vocab_size = 49408
    sot_id = 49406
    eot_id = 49407

    def tokenize(self, text: str) -> List[int]:
        ids = []
        for w in _clean(text).split():
            h = 2166136261
            for c in w.encode("utf-8"):
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LEN) -> np.ndarray:
        out = np.full((len(texts), max_length), self.eot_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.tokenize(t)[: max_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out


def find_clip_vocab() -> Optional[Tuple[str, str]]:
    """Locate (vocab.json, merges.txt) from env vars or the HF cache."""
    v, m = os.environ.get("INSV2V_CLIP_VOCAB"), os.environ.get("INSV2V_CLIP_MERGES")
    if v and m and os.path.exists(v) and os.path.exists(m):
        return v, m
    hub = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    for vocab in sorted(
        glob.glob(os.path.join(hub, "hub", "models--openai--clip*", "**", "vocab.json"),
                  recursive=True)
    ):
        merges = os.path.join(os.path.dirname(vocab), "merges.txt")
        if os.path.exists(merges):
            return vocab, merges
    return None


def get_tokenizer():
    """Best available tokenizer: real CLIP BPE if a vocab is found, else
    the hash fallback (with a loud warning)."""
    found = find_clip_vocab()
    if found is not None:
        return ClipTokenizer.from_files(*found)
    import warnings

    warnings.warn(
        "No CLIP BPE vocab found (set INSV2V_CLIP_VOCAB/INSV2V_CLIP_MERGES); "
        "falling back to HashTokenizer — token ids will NOT match CLIP."
    )
    return HashTokenizer()
