"""The port's T5 ``tokenizer.json`` reader (``models/tokenizer.py``)
against the JAX package's ``load_t5_tokenizer``, which reads the file
through the ``tokenizers`` package: the same ids for the same prompts on
files in both layouts and all three Metaspace prepend schemes, a hypothesis
property over a small alphabet, the file chip_smoke.py's phase 18 writes
and the ids it pins, and a file it cannot read raising ValueError."""

from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_parity import T5_CHARSMAP, write_t5_tokenizer_json

from sonicdiffusionbayeslab_torch.models import tokenizer as TTok
from sonicdiffusionbayeslab_tpu.models import tokenizer as JTok

MAX_LEN = 24
PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "café éclair, crème brûlée",           # precomposed accents
    "café ｅ́ é",         # combining accents (the shortest-key rule)
    "ＦＵＬＬ ｗｉｄｔｈ ﬁne",               # full-width letters, a ligature
    "  runs   of    spaces  ",
    "tabs\tand\nnewlines　ideographic",
    "unknown 中文 ✓ zz \x07bell",
    "emoji \U0001F600 \U0001F44D\U0001F3FD \U0001F1EB\U0001F1F7 "
    "\U0001F468‍\U0001F469‍\U0001F467",
    "",
    " ",
    "</s>",
    "a</s>b <extra_id_0> c<pad>",
    "a b c d e f g h i j k l m n o p q r s t a b c d e f g h",  # past MAX_LEN
]


def _pair(tmp_path, **kw):
    write_t5_tokenizer_json(tmp_path, **kw)
    return (TTok.load_t5_tokenizer(str(tmp_path), 32128, MAX_LEN),
            JTok.load_t5_tokenizer(str(tmp_path), 32128, MAX_LEN))


@pytest.mark.parametrize("layout", ["spm", "converter"])
@pytest.mark.parametrize("scheme", ["always", "first", "never"])
def test_ids_equal_jax(tmp_path, layout, scheme):
    port, jax_tok = _pair(tmp_path, layout=layout, scheme=scheme)
    assert isinstance(port, TTok.T5UnigramTokenizer)
    got, want = port(PROMPTS), jax_tok(PROMPTS)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(PROMPTS), MAX_LEN)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] != 1  # the long prompt lost its </s>, as in the JAX package


def test_older_layout_add_prefix_space(tmp_path):
    """The Metaspace of tokenizers < 0.14 (``add_prefix_space``, no
    ``prepend_scheme``), which SD3's first snapshots carry; ``false`` there
    contradicts the default scheme, which both readers refuse."""
    path = write_t5_tokenizer_json(tmp_path)
    spec = json.loads(path.read_text())
    for flag in (True, False):
        for key in ("pre_tokenizer", "decoder"):
            spec[key] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": flag}
        path.write_text(json.dumps(spec))
        if flag:
            np.testing.assert_array_equal(
                TTok.load_t5_tokenizer(str(tmp_path), 1, MAX_LEN)(PROMPTS),
                JTok.load_t5_tokenizer(str(tmp_path), 1, MAX_LEN)(PROMPTS))
            continue
        with pytest.raises(ValueError, match="add_prefix_space false"):
            TTok.load_t5_tokenizer(str(tmp_path), 1, MAX_LEN)
        with pytest.raises(Exception, match="add_prefix_space"):
            JTok.load_t5_tokenizer(str(tmp_path), 1, MAX_LEN)


def test_charsmap_writer_round_trip():
    """Every key of the written charsmap reads back as its replacement
    (keys with a shorter key as a prefix give the shorter key's, the
    shortest-match rule)."""
    cm = TTok.PrecompiledCharsmap(TTok.encode_precompiled_charsmap(T5_CHARSMAP))
    for key, value in T5_CHARSMAP.items():
        shorter = [k for k in T5_CHARSMAP if k != key and key.startswith(k)]
        assert cm.transform(key) == (T5_CHARSMAP[min(shorter, key=len)] if shorter else value)
    assert cm.transform("q") is None and cm.normalize("ｅ́x") == "Ex"


_ALPHABET = "abcdeéfＡｅ́ 　中✓\x07\U0001F600</s>"


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(alphabet=_ALPHABET, max_size=30), min_size=1, max_size=3))
def test_property_ids_equal_jax(tmp_path_factory, texts):
    d = tmp_path_factory.getbasetemp() / "t5_prop"
    if not (d / "tokenizer.json").exists():
        write_t5_tokenizer_json(d, layout="converter")
    np.testing.assert_array_equal(TTok.load_t5_tokenizer(str(d), 1, MAX_LEN)(texts),
                                  JTok.load_t5_tokenizer(str(d), 1, MAX_LEN)(texts))


def test_phase18_file_and_pinned_ids(tmp_path):
    """The 32,100-piece file chip_smoke.py writes on the card (with no
    ``tokenizers`` there) gives, through ``tokenizers``, the ids the phase
    pins, and the port's reader gives the same."""
    import chip_smoke
    from tokenizers import Tokenizer

    path = chip_smoke.write_t5_tokenizer(tmp_path)
    ref = [Tokenizer.from_file(str(path)).encode(t).ids for t in chip_smoke.T5_TOK_PROMPTS]
    assert ref == chip_smoke.T5_TOK_IDS
    port = TTok.load_t5_tokenizer(str(tmp_path), 32128, 256)
    assert len(port.scores) == 32100
    assert [port.encode(t) for t in chip_smoke.T5_TOK_PROMPTS] == chip_smoke.T5_TOK_IDS


@pytest.mark.parametrize("edit,match", [
    (lambda s: s.update(model={**s["model"], "type": "BPE"}), "model 'BPE'"),
    (lambda s: s.update(model={**s["model"], "byte_fallback": True}), "byte_fallback"),
    (lambda s: s.update(normalizer={"type": "NFKC"}), "normalizer 'NFKC'"),
    (lambda s: s.update(pre_tokenizer={"type": "Whitespace"}), "pre_tokenizer 'Whitespace'"),
    (lambda s: s.update(post_processor={"type": "BertProcessing"}), "BertProcessing"),
    (lambda s: s.update(truncation={"max_length": 8}), "truncation"),
    (lambda s: s["added_tokens"][0].update(lstrip=True), "lstrip"),
    (lambda s: s.clear(), "model None"),
])
def test_unreadable_file_raises_never_hashes(tmp_path, edit, match):
    path = write_t5_tokenizer_json(tmp_path)
    spec = json.loads(path.read_text())
    edit(spec)
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=match):
        TTok.load_t5_tokenizer(str(tmp_path))


JAX_T5_BENCH_KEYS = {"metric", "fits", "value", "unit", "img_per_hour_e2e",
                     "encode_phase_s_per_batch", "init_s", "batch", "steps"}


@pytest.mark.parametrize("mode", ["staged", "resident"])
def test_t5_bench_twin_prints_the_jax_keys(capsys, mode):
    """The port's twin of t5_bench.py, tiny on the CPU: one JSON line with
    the JAX script's keys (its numbers are no device measurement)."""
    from sonicdiffusionbayeslab_torch import t5_bench

    t5_bench.main([mode, "--tiny", "--device", "cpu", "--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert JAX_T5_BENCH_KEYS <= set(rec) and rec["metric"] == f"t5_{mode}" and rec["fits"]
    assert rec["batch"] == 4 and rec["steps"] == 1 and rec["value"] > 0
