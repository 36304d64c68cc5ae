"""Prompt-to-prompt text machinery: word-level caption diff + token-aligned
(key, value) embedding construction.

The port's own copy of ``text/prompt_diff.py`` in the JAX package (numpy
only). Re-implements misc_utils/video_ptp_utils.py:60-96 (difflib word
diff -> Text/Edit/Insert/Delete pieces) and misc_utils/ptp_utils.py:65-124
(token-aligned key/value embeddings: new-prompt tokens whose words map to
old-prompt words take the OLD prompt's embedding as attention KEY, while
VALUES stay the weighted new-prompt embeddings — this is what lets the
new prompt re-use the old prompt's attention geometry).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

__all__ = ["Text", "Edit", "Insert", "Delete", "compute_diff",
           "token_alignment", "build_ptp_key_value"]


@dataclasses.dataclass
class Text:
    text: str
    weight: float = 1.0

    @property
    def old(self):
        return self.text

    @property
    def new(self):
        return self.text


@dataclasses.dataclass
class Edit:
    old: str
    new: str
    weight: float = 1.0


@dataclasses.dataclass
class Insert:
    text: str
    weight: float = 1.0

    @property
    def old(self):
        return ""

    @property
    def new(self):
        return self.text


@dataclasses.dataclass
class Delete:
    text: str
    weight: float = 1.0

    @property
    def old(self):
        return self.text

    @property
    def new(self):
        return ""


Piece = Union[Text, Edit, Insert, Delete]


def compute_diff(old_sentence: str, new_sentence: str) -> List[Piece]:
    """Word-level diff -> pieces; adjacent delete+insert merge to Edit."""
    diff = list(difflib.Differ().compare(old_sentence.split(),
                                         new_sentence.split()))
    result: List[Piece] = []
    i = 0
    while i < len(diff):
        tag = diff[i][0]
        if tag in (" ", "-", "+"):
            words = [diff[i][2:]]
            while i + 1 < len(diff) and diff[i + 1][0] == tag:
                i += 1
                words.append(diff[i][2:])
            text = " ".join(words)
            result.append({" ": Text, "-": Delete, "+": Insert}[tag](text))
        i += 1

    i = 0
    while i < len(result) - 1:
        a, b = result[i], result[i + 1]
        if isinstance(a, Delete) and isinstance(b, Insert):
            result[i: i + 2] = [Edit(old=a.text, new=b.text)]
        elif isinstance(a, Insert) and isinstance(b, Delete):
            result[i: i + 2] = [Edit(old=b.text, new=a.text)]
        else:
            i += 1
    return result


def token_alignment(
    pieces: Sequence[Piece], count_tokens: Callable[[str], int]
) -> Tuple[List[int], List[float]]:
    """Map each NEW-prompt token index to an OLD-prompt token index (or -1)
    with a per-token weight (ptp_utils.py:67-96).

    ``count_tokens(text)`` returns the number of content tokens the
    tokenizer produces for ``text``.
    """
    n_old = 0
    new_to_old: List[int] = []
    weights: List[float] = []
    for piece in pieces:
        old, new = piece.old, piece.new
        n_o = count_tokens(old) if old else 0
        n_n = count_tokens(new) if new else 0
        if n_o == 0 and n_n == 0:
            continue
        if old == new:
            n_old += n_o
            new_to_old.extend(range(n_old - n_o, n_old))
        elif n_o == 0:  # insert
            new_to_old.extend([-1] * n_n)
        elif n_n == 0:  # delete
            n_old += n_o
        else:  # replace: spread new tokens across the old token span
            n_old += n_o
            ids = np.linspace(n_old - n_o, n_old, n_n, endpoint=False).astype(int)
            new_to_old.extend(ids.tolist())
        weights.extend([piece.weight] * n_n)
    return new_to_old, weights


def build_ptp_key_value(
    pieces: Sequence[Piece],
    tokenizer,
    encode_fn: Callable[[np.ndarray], np.ndarray],
    token_offset: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Token-aligned (key, value) context embeddings (ptp_utils.py:98-124).

    Args:
      tokenizer: a ClipTokenizer-like object (``tokenize`` for content
        tokens, ``__call__`` for padded ids).
      encode_fn: ids (1, L) -> embeddings (1, L, D).
      token_offset: position of the first content token in the padded
        sequence (1 for CLIP's <sot> prefix; 0 for raw-token encoders).
    Returns: (key, value), each (1, L, D).
    """
    old_prompt = " ".join(p.old for p in pieces)
    new_prompt = " ".join(p.new for p in pieces)
    old_ids = np.asarray(tokenizer([old_prompt]))
    new_ids = np.asarray(tokenizer([new_prompt]))
    old_emb = np.asarray(encode_fn(old_ids))
    new_emb = np.asarray(encode_fn(new_ids))

    count = lambda text: len(tokenizer.tokenize(text))
    new_to_old, weights = token_alignment(pieces, count)

    key = new_emb.copy()
    value = new_emb.copy()
    L = key.shape[1]
    for i, (j, w) in enumerate(zip(new_to_old, weights)):
        pi = i + token_offset
        pj = j + token_offset
        if pi >= L:
            break
        if 0 <= j and pj < L:
            key[0, pi] = old_emb[0, pj]
        value[0, pi] *= w
    return key, value
