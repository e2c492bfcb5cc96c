"""Prompt attention weighting: ``(word:1.3)``, ``(word)``, ``[word]``.

The port's own copy of ``sonicdiffusionbayeslab_tpu/models/prompt_weighting.py``.
The emphasis syntax parses into per-token weights, the text encoder's
hidden states are scaled token by token, and each sample's states are
rescaled to their original mean.

Grammar (A1111 semantics):
  (text)        weight x 1.1 (nesting multiplies)
  ((text))      weight x 1.21
  [text]        weight x 1/1.1
  (text:1.5)    explicit weight for the span (replaces the 1.1 factor)
  \\( \\) \\[ \\]   literal brackets

A prompt without the syntax parses to one weight-1.0 segment, whose ids
are the plain tokenizer's and whose states the pipeline leaves unscaled.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

ROUND_FACTOR = 1.1
SQUARE_FACTOR = 1.0 / 1.1

_TOKEN_RE = re.compile(
    r"""
    \\\(|\\\)|\\\[|\\\]   # escaped brackets -> literal
    |\(|\[                 # open emphasis
    |:\s*([+-]?[\d.]+)\s*\)   # explicit weight close (A1111 accepts .5)
    |\)|\]                 # plain close
    |[^\\()\[\]:]+         # text run
    |:                     # bare colon (literal)
    |\\                    # trailing backslash (literal)
    """,
    re.VERBOSE,
)


def parse_segments(text: str) -> List[Tuple[str, float]]:
    """[(text, weight)] with adjacent runs of equal weight merged."""
    segments: List[List] = []  # [text, weight]
    round_stack: List[int] = []  # index of the first segment inside each (
    square_stack: List[int] = []

    def scale(start: int, factor: float) -> None:
        for seg in segments[start:]:
            seg[1] *= factor

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        explicit = m.group(1)
        if tok.startswith("\\") and len(tok) == 2:
            segments.append([tok[1], 1.0])
        elif tok == "(":
            round_stack.append(len(segments))
        elif tok == "[":
            square_stack.append(len(segments))
        elif explicit is not None:
            try:
                w_val = float(explicit)
            except ValueError:  # e.g. "1.2.3": literal
                w_val = None
            if round_stack and w_val is not None:
                scale(round_stack.pop(), w_val)
            else:
                # No open paren (a literal ':3)') or a weight that does not
                # parse: the text stays literal and nothing is rescaled.
                segments.append([tok, 1.0])
        elif tok == ")":
            if round_stack:
                scale(round_stack.pop(), ROUND_FACTOR)
            else:
                segments.append([")", 1.0])
        elif tok == "]":
            if square_stack:
                scale(square_stack.pop(), SQUARE_FACTOR)
            else:
                segments.append(["]", 1.0])
        else:
            segments.append([tok, 1.0])
    # An unclosed bracket scales the rest of the prompt.
    for start in round_stack:
        scale(start, ROUND_FACTOR)
    for start in square_stack:
        scale(start, SQUARE_FACTOR)

    merged: List[Tuple[str, float]] = []
    for text_part, w in segments:
        if merged and abs(merged[-1][1] - w) < 1e-9:
            merged[-1] = (merged[-1][0] + text_part, w)
        else:
            merged.append((text_part, w))
    return [(t, w) for t, w in merged if t]


def weighted_ids(tokenizer, text: str) -> Tuple[List[int], List[float]]:
    """Token ids (BOS ... EOS, clipped to the tokenizer's length as the plain
    path clips them) and the weight of each."""
    ids: List[int] = [tokenizer.bos]
    w: List[float] = [1.0]
    for seg_text, seg_w in parse_segments(text):
        seg_ids = tokenizer.encode(seg_text)
        ids.extend(seg_ids)
        w.extend([seg_w] * len(seg_ids))
    limit = tokenizer.max_length - 1
    ids, w = ids[:limit], w[:limit]
    ids.append(tokenizer.eos)
    w.append(1.0)
    return ids, w


def batch_weighted_ids(tokenizer, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (ids [B, T] int32 padded with EOS, weights [B, T] float32)."""
    T = tokenizer.max_length
    out = np.full((len(texts), T), tokenizer.eos, np.int32)
    weights = np.ones((len(texts), T), np.float32)
    for i, t in enumerate(texts):
        ids, w = weighted_ids(tokenizer, t)
        out[i, : len(ids)] = ids
        weights[i, : len(w)] = w
    return out, weights


def apply_prompt_weights(states: torch.Tensor, weights) -> torch.Tensor:
    """states [B, T, C] x weights [B, T] -> the scaled states, each sample
    rescaled to its original mean (A1111's renormalisation)."""
    w = torch.as_tensor(np.asarray(weights), dtype=states.dtype, device=states.device)[:, :, None]
    orig_mean = states.mean(dim=(1, 2), keepdim=True)
    z = states * w
    new_mean = z.mean(dim=(1, 2), keepdim=True)
    safe = torch.where(new_mean.abs() < 1e-8, torch.ones_like(new_mean), new_mean)
    return z * (orig_mean / safe)
