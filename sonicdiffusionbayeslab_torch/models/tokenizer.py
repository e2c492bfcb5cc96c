"""CLIP tokenization: byte-level BPE from local vocab files, or a
deterministic offline stand-in.

The port's own copy of ``sonicdiffusionbayeslab_tpu/models/tokenizer.py``
(``CLIPBPETokenizer``, ``HashTokenizer``, ``load_tokenizer``,
``load_t5_tokenizer``).  Both give fixed-length [B, 77] int32 ids: BOS,
ids, EOS, then EOS padding (SD3's T5 tower takes the hash ids at its own
vocabulary and 256 tokens).
"""

from __future__ import annotations

import functools
import gzip
import json
import re
from pathlib import Path
from typing import List, Sequence

import numpy as np

_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _pad_batch(encoded: List[List[int]], bos: int, eos: int, max_length: int) -> np.ndarray:
    out = np.full((len(encoded), max_length), eos, dtype=np.int32)
    for i, ids in enumerate(encoded):
        ids = [bos] + ids[: max_length - 2] + [eos]
        out[i, : len(ids)] = ids
    return out


class CLIPBPETokenizer:
    """CLIP BPE from local vocab.json + merges.txt(.gz)."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if str(merges_path).endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self._cache: dict = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = []
        for tok in _WORD_RE.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok) if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return _pad_batch([self.encode(t) for t in texts], self.bos, self.eos, self.max_length)


class HashTokenizer:
    """Deterministic offline tokenizer: stable FNV-1a ids per word.  Not
    linguistically meaningful; it lets the whole pipeline run without
    vocab files."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in re.findall(r"\S+", text.lower()):
            h = 2166136261
            for c in w.encode("utf-8"):
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return _pad_batch([self.encode(t) for t in texts], self.bos, self.eos, self.max_length)


def load_tokenizer(local_dir: str | None = None, vocab_size: int = 49408, max_length: int = 77):
    """CLIPBPETokenizer if vocab.json and merges.txt exist under
    ``local_dir``, else HashTokenizer."""
    if local_dir:
        d = Path(local_dir)
        vocab, merges = d / "vocab.json", d / "merges.txt"
        if vocab.exists() and merges.exists():
            return CLIPBPETokenizer(str(vocab), str(merges), max_length)
    return HashTokenizer(vocab_size, max_length)


class T5TokenizerNotPorted(NotImplementedError):
    """A snapshot's T5 ``tokenizer.json`` (a Unigram model read by the
    ``tokenizers`` package in the JAX package) has no reader in the port."""


def load_t5_tokenizer(local_dir: str | None = None, vocab_size: int = 32128,
                      max_length: int = 256):
    """SD3's T5 tokenizer: ``HashTokenizer(vocab_size, max_length)``, as
    the JAX package falls back to without a snapshot.  A ``local_dir`` that
    holds ``tokenizer.json`` raises: hashing a real checkpoint's prompts
    would give ids its embedding never learned."""
    if local_dir and (Path(local_dir) / "tokenizer.json").exists():
        raise T5TokenizerNotPorted(
            f"{Path(local_dir) / 'tokenizer.json'}: the T5 tokenizer.json reader is not ported "
            "yet to the PyTorch package (ROADMAP A4); run SD3 without use_t5, or with a "
            "snapshot that has no tokenizer_3/tokenizer.json")
    return HashTokenizer(vocab_size, max_length)
