"""Tokenization: CLIP's byte-level BPE from local vocab files, T5's
Unigram from a snapshot's ``tokenizer.json``, or a deterministic offline
stand-in.

The port's own copy of ``sonicdiffusionbayeslab_tpu/models/tokenizer.py``
(``CLIPBPETokenizer``, ``HashTokenizer``, ``load_tokenizer``,
``load_t5_tokenizer``).  The CLIP and hash tokenizers give fixed-length
[B, 77] int32 ids: BOS, ids, EOS, then EOS padding.  SD3's T5 tower takes
:class:`T5UnigramTokenizer`'s ids where the snapshot has
``tokenizer_3/tokenizer.json`` (the JAX package reads that file through
the ``tokenizers`` package, which the port does without), else hash ids
at its own vocabulary and 256 tokens.
"""

from __future__ import annotations

import base64
import functools
import gzip
import json
import re
import struct
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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




# ------------------------------------------------------------------ T5
# A pure-Python reader of the ``tokenizer.json`` that ``transformers``'
# SpmConverter writes for T5 (a SentencePiece Unigram model): the
# ``tokenizers`` package's pipeline restated for the components that file
# holds.  Added tokens split the raw text; each other segment is
# normalized (Precompiled, Replace, Strip), pre-tokenized (Metaspace),
# encoded by the Unigram model (Viterbi) and post-processed
# (TemplateProcessing).  A component outside that set raises ValueError.

_RUST_WHITESPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, 0x2028, 0x2029, 0x202F, 0x205F,
     0x3000] + list(range(0x2000, 0x200B)))
_UNK_PENALTY = 10.0  # the tokenizers package's K_UNK_PENALTY


def _strip(s: str, left: bool, right: bool) -> str:
    """``s`` without leading/trailing whitespace as Rust's
    ``char::is_whitespace`` has it (Python's ``str.strip`` differs)."""
    i, j = 0, len(s)
    while left and i < j and ord(s[i]) in _RUST_WHITESPACE:
        i += 1
    while right and j > i and ord(s[j - 1]) in _RUST_WHITESPACE:
        j -= 1
    return s[i:j]


def _ext_pict(cp: int) -> bool:
    """Extended_Pictographic, by the ranges that hold it."""
    return (cp in (0xA9, 0xAE, 0x203C, 0x2049, 0x2122, 0x2139, 0x2328, 0x2388, 0x23CF, 0x24C2,
                   0x25B6, 0x25C0, 0x2B50, 0x2B55, 0x3030, 0x303D, 0x3297, 0x3299)
            or 0x2194 <= cp <= 0x21AA or 0x231A <= cp <= 0x231B or 0x23E9 <= cp <= 0x23FA
            or 0x25AA <= cp <= 0x25AB or 0x25FB <= cp <= 0x25FE or 0x2600 <= cp <= 0x27BF
            or 0x2934 <= cp <= 0x2935 or 0x2B05 <= cp <= 0x2B1C
            or (0x1F000 <= cp <= 0x1FAFF and not 0x1F1E6 <= cp <= 0x1F1FF
                and not 0x1F3FB <= cp <= 0x1F3FF)
            or 0x1FC00 <= cp <= 0x1FFFD)


def _break_class(c: str) -> str:
    """The character's Grapheme_Cluster_Break class (UAX #29), from
    ``unicodedata``'s categories and the ranges of the other classes."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if cp == 0x200C or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F:
        return "Extend"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me", "Mc"):
        return "Extend"
    if cat in ("Cc", "Zl", "Zp", "Cf"):
        return "Control"
    return "EP" if _ext_pict(cp) else "Other"


def graphemes(s: str) -> List[str]:
    """``s`` cut into extended grapheme clusters (UAX #29's rules GB3-GB13
    without Prepend), as ``unicode-segmentation``'s ``graphemes(true)``
    cuts the text the Precompiled normalizer reads."""
    out: List[str] = []
    prev = None
    ri_run = 0  # regional indicators since the last non-RI
    pict = False  # the cluster so far ends in ExtPict Extend* (ZWJ)?
    for c in s:
        k = _break_class(c)
        join = False
        if prev is not None:
            if prev == "CR" and k == "LF":
                join = True
            elif prev in ("Control", "CR", "LF") or k in ("Control", "CR", "LF"):
                join = False
            elif ((prev == "L" and k in ("L", "V", "LV", "LVT"))
                  or (prev in ("LV", "V") and k in ("V", "T"))
                  or (prev in ("LVT", "T") and k == "T")):
                join = True
            elif k in ("Extend", "ZWJ"):
                join = True
            elif prev == "ZWJ" and k == "EP" and pict:
                join = True
            elif prev == "RI" and k == "RI" and ri_run % 2 == 1:
                join = True
        if join:
            out[-1] += c
        else:
            out.append(c)
        ri_run = ri_run + 1 if k == "RI" else 0
        if k == "EP":
            pict = True
        elif not (pict and (k == "Extend" or (k == "ZWJ" and prev != "ZWJ"))):
            pict = False
        prev = k
    return out


class PrecompiledCharsmap:
    """SentencePiece's ``precompiled_charsmap``: a u32 (little-endian)
    byte size of a darts-clone double-array trie, its u32 units, then a
    blob of NUL-terminated replacements that the trie's values index.
    :meth:`normalize` is ``spm_precompiled``'s: grapheme by grapheme, a
    grapheme under 6 bytes whose bytes have a key as a prefix becomes the
    replacement of the shortest such key; else each character is looked up
    alone and kept where it has no key."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("Precompiled: precompiled_charsmap shorter than its header")
        (size,) = struct.unpack_from("<I", blob, 0)
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"Precompiled: trie of {size} bytes in a {len(blob)}-byte charsmap")
        self.units = list(struct.unpack_from(f"<{size // 4}I", blob, 4))
        self.normalized = blob[4 + size:]
        self._memo: Dict[str, Optional[str]] = {}

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _first_value(self, key: bytes) -> Optional[int]:
        """The value of the shortest key that is a prefix of ``key``."""
        units, n = self.units, len(self.units)
        if not n:
            return None
        pos = self._offset(units[0])
        for c in key:
            if c == 0:
                return None
            pos ^= c
            if pos >= n:
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        if chunk in self._memo:
            return self._memo[chunk]
        value = self._first_value(chunk.encode("utf-8"))
        out = None
        if value is not None:
            end = self.normalized.find(b"\0", value)
            out = self.normalized[value:end if end >= 0 else len(self.normalized)].decode("utf-8")
        self._memo[chunk] = out
        return out

    def normalize(self, s: str) -> str:
        out = []
        for g in graphemes(s):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def encode_precompiled_charsmap(mapping: Dict[str, str]) -> bytes:
    """A ``precompiled_charsmap`` holding ``mapping`` (key -> replacement,
    no key empty or holding NUL): a darts-clone double array, each node's
    children at ``base ^ byte`` and its value at ``base``, bases distinct.
    What tests and smoke runs write into a test ``tokenizer.json``."""
    blob, values = bytearray(), {}
    for key in sorted(mapping):
        kb = key.encode("utf-8")
        if not kb or b"\0" in kb:
            raise ValueError(f"charsmap key {key!r}: empty or holding NUL")
        values[kb] = len(blob)
        blob += mapping[key].encode("utf-8") + b"\0"
    trie: dict = {}
    for kb, v in values.items():
        node = trie
        for c in kb:
            node = node.setdefault(c, {})
        node[None] = v
    units: Dict[int, int] = {0: 0}
    bases: set = set()
    nxt = 1
    stack = [(0, trie)]
    while stack:
        pos, node = stack.pop()
        labels = sorted(c for c in node if c is not None)
        need = labels + ([0] if None in node else [])
        base = nxt
        while base in bases or any((base ^ c) in units for c in need):
            base += 1
        bases.add(base)
        if base == nxt:
            nxt += 1
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap too large for unextended offsets")
        units[pos] = units.get(pos, 0) | (offset << 10) | ((1 << 8) if None in node else 0)
        if None in node:
            units[base] = (1 << 31) | node[None]
        for c in labels:
            units[base ^ c] = c
            stack.append((base ^ c, node[c]))
    size = max(b | 0xFF for b in bases) + 1 if bases else 1
    arr = [units.get(i, 0) for i in range(size)]
    return struct.pack(f"<I{size}I", 4 * size, *arr) + bytes(blob)


def _normalizer(spec) -> list:
    """The normalizer steps (callables str -> str) of a ``normalizer``
    entry: null, one of Precompiled / Replace / Strip, or a Sequence of
    them."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for sub in spec["normalizers"] for f in _normalizer(sub)]
    if kind == "Precompiled":
        data = spec.get("precompiled_charsmap")
        if not data:
            raise ValueError("normalizer Precompiled without a precompiled_charsmap")
        return [PrecompiledCharsmap(base64.b64decode(data)).normalize]
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "String" in pat:
            lit = pat["String"]
            return [lambda s: s.replace(lit, content)]
        if "Regex" in pat:
            rx = re.compile(pat["Regex"])
            return [lambda s: rx.sub(lambda _m: content, s)]
        raise ValueError(f"normalizer Replace with pattern {pat!r}")
    if kind == "Strip":
        left, right = bool(spec.get("strip_left")), bool(spec.get("strip_right"))
        return [lambda s: _strip(s, left, right)]
    raise ValueError(f"normalizer {kind!r} is not read (Precompiled, Replace, Strip, Sequence)")


class T5UnigramTokenizer:
    """T5's tokenizer from a ``tokenizer.json``, ids as the JAX package's
    ``_T5FastTokenizer`` gives them: each text's post-processed ids cut at
    ``max_length`` (a long prompt loses its ``</s>``), padded with id 0.

    Reads ``added_tokens`` (literal, not normalized, no strip or
    single-word flags), ``normalizer`` (Precompiled, Replace with a string
    or a regex, Strip; alone or in a Sequence), ``pre_tokenizer``
    (Metaspace: ``prepend_scheme`` always / first / never, or the older
    ``add_prefix_space`` alone, and ``split``), ``model`` (Unigram, no byte
    fallback) and ``post_processor`` (TemplateProcessing's ``single``
    template, or null).  Anything else, and a ``truncation`` or
    ``padding`` the file would apply, raises ValueError naming it."""

    def __init__(self, tokenizer_json: str, max_length: int = 256):
        with open(tokenizer_json, encoding="utf-8") as f:
            spec = json.load(f)
        self.max_length = int(max_length)
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"{tokenizer_json}: {key} {spec[key]!r} is not read")
        self._read_model(spec.get("model") or {})
        self._read_added(spec.get("added_tokens") or [])
        self._normalize = _normalizer(spec.get("normalizer"))
        self._read_metaspace(spec.get("pre_tokenizer"))
        self._read_template(spec.get("post_processor"))

    # ----------------------------------------------------------- reading
    def _read_model(self, m) -> None:
        if m.get("type") != "Unigram":
            raise ValueError(f"model {m.get('type')!r} is not read (Unigram)")
        if m.get("byte_fallback"):
            raise ValueError("model Unigram with byte_fallback is not read")
        vocab = [(str(p), float(s)) for p, s in m["vocab"]]
        if not vocab:
            raise ValueError("model Unigram with an empty vocab")
        self.scores = [s for _, s in vocab]
        self.pieces = {p: i for i, (p, _) in enumerate(vocab)}  # a repeated piece: the last
        self.max_piece = max(len(p) for p, _ in vocab)
        self.unk_id = m.get("unk_id")
        if self.unk_id is not None and not 0 <= int(self.unk_id) < len(vocab):
            raise ValueError(f"model Unigram unk_id {self.unk_id} outside the vocab")
        self.unk_score = min(self.scores) - _UNK_PENALTY

    def _read_added(self, added) -> None:
        self.added: Dict[str, int] = {}
        for tok in added:
            for flag in ("single_word", "lstrip", "rstrip", "normalized"):
                if tok.get(flag):
                    raise ValueError(f"added token {tok['content']!r} with {flag} is not read")
            self.added[tok["content"]] = int(tok["id"])
        alts = sorted(self.added, key=len, reverse=True)  # leftmost, then longest
        self._added_re = re.compile("|".join(map(re.escape, alts))) if alts else None

    def _read_metaspace(self, p) -> None:
        if p is None or p.get("type") != "Metaspace":
            raise ValueError(f"pre_tokenizer {p and p.get('type')!r} is not read (Metaspace)")
        self.replacement = p.get("replacement", "▁")
        scheme = p.get("prepend_scheme", "always")
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"pre_tokenizer Metaspace prepend_scheme {scheme!r}")
        if p.get("add_prefix_space") is False and scheme != "never":  # as tokenizers refuses it
            raise ValueError(f"pre_tokenizer Metaspace add_prefix_space false with "
                             f"prepend_scheme {scheme!r}")
        self.prepend, self.split = scheme, bool(p.get("split", True))

    def _read_template(self, p) -> None:
        self.template: List[Tuple[str, List[int]]] = [("A", [])]
        if p is None:
            return
        if p.get("type") != "TemplateProcessing":
            raise ValueError(f"post_processor {p.get('type')!r} is not read (TemplateProcessing)")
        special = {k: [int(i) for i in v["ids"]] for k, v in p.get("special_tokens", {}).items()}
        self.template = []
        for item in p["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise ValueError(f"post_processor single template item {item!r}")
                self.template.append(("A", []))
            elif "SpecialToken" in item:
                self.template.append(("S", special[item["SpecialToken"]["id"]]))
            else:
                raise ValueError(f"post_processor single template item {item!r}")

    # ----------------------------------------------------------- encoding
    def _unigram(self, s: str) -> List[int]:
        """The Viterbi path's ids (consecutive unknown characters fused into
        one unknown token)."""
        n = len(s)
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        ids = [0] * (n + 1)
        for i in range(n):
            base, single = score[i], False
            for k in range(1, min(self.max_piece, n - i) + 1):
                tid = self.pieces.get(s[i:i + k])
                if tid is None:
                    continue
                cand, j = base + self.scores[tid], i + k
                if start[j] is None or cand > score[j]:
                    score[j], start[j], ids[j] = cand, i, tid
                single = single or k == 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"model Unigram has no unk_id for {s[i]!r}")
                cand = base + self.unk_score
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ids[i + 1] = cand, i, int(self.unk_id)
        pieces: List[str] = []
        unk: List[str] = []
        end = n
        while end > 0:
            st = start[end]
            if self.unk_id is not None and ids[end] == self.unk_id:
                unk.append(s[st:end])
            else:
                if unk:
                    pieces.append("".join(reversed(unk)))
                    unk = []
                pieces.append(s[st:end])
            end = st
        if unk:
            pieces.append("".join(reversed(unk)))
        return [self.pieces.get(p, self.unk_id) for p in reversed(pieces)]

    def _segment(self, s: str, first: bool) -> List[int]:
        for f in self._normalize:
            s = f(s)
        if not s:
            return []
        s = s.replace(" ", self.replacement)
        if not s.startswith(self.replacement) and (
                self.prepend == "always" or (self.prepend == "first" and first)):
            s = self.replacement + s
        words = [w for w in re.split(f"(?={re.escape(self.replacement)})", s) if w] \
            if self.split else [s]
        return [i for w in words for i in self._unigram(w)]

    def encode(self, text: str) -> List[int]:
        """The post-processed ids of one text (not cut, not padded)."""
        ids: List[int] = []
        pos = 0
        matches = self._added_re.finditer(text) if self._added_re is not None else ()
        for m in matches:
            if m.start() > pos:
                ids += self._segment(text[pos:m.start()], pos == 0)
            ids.append(self.added[m.group()])
            pos = m.end()
        if pos < len(text) or not text:
            ids += self._segment(text[pos:], pos == 0)
        out: List[int] = []
        for kind, special in self.template:
            out += ids if kind == "A" else special
        return out

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[: self.max_length]
            out[i, : len(ids)] = ids
        return out


def load_t5_tokenizer(local_dir: str | None = None, vocab_size: int = 32128,
                      max_length: int = 256):
    """SD3's T5 tokenizer: :class:`T5UnigramTokenizer` from ``local_dir``'s
    ``tokenizer.json`` where the file exists (a file it cannot read raises
    ValueError, never falls back), else ``HashTokenizer(vocab_size,
    max_length)``, as the JAX package falls back to without a snapshot."""
    if local_dir:
        tj = Path(local_dir) / "tokenizer.json"
        if tj.exists():
            return T5UnigramTokenizer(str(tj), max_length)
    return HashTokenizer(vocab_size, max_length)
