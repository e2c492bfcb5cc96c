"""The port's config loader, YAML reader and ``--set`` parsing against the
JAX package's (which reads YAML with PyYAML's ``safe_load``)."""

from pathlib import Path

import pytest
import yaml

from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch.config import ConfigError, load_config, parse_value, parse_yaml
from sonicdiffusionbayeslab_tpu import cli as jcli
from sonicdiffusionbayeslab_tpu.config import ConfigError as JConfigError
from sonicdiffusionbayeslab_tpu.config import load_config as jload_config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_config_tree_equals_jax(path):
    assert load_config(path).to_dict() == jload_config(path).to_dict()
    assert parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("text", [
    "a: 1.0e-4\nb: 1e-4\nc: -.5\nd: .5\ne: 08\nf: +5\ng: -0\nh: .inf\ni: 0.\n",
    "a: yes\nb: Off\nc: TRUE\nd: ~\ne: null\nf:\ng: ''\nh: \"\"\n",
    "a: it's\nb: 'it''s'\nc: \"x # y\\t\\u00e9\"\nd: int8 # comment\ne: x{y}\n'q k': 3\n",
    "a: [[], [5], [5, 6, 7]]\nb: [1, 2,]\nc: [\"x, y\", 'z', w, 1.5, true, ~]\nd: []\n",
    "# head\na:\n  b:\n    c: 1\n\n  d: [1]   # tail\ne: 2\n",
])
def test_yaml_subset_equals_safe_load(text):
    assert repr(parse_yaml(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 0x10", "a: 010", "a: 1_000", "a: 1:30", "a: 2020-01-01", "a: <<",
    "a: &x 1", "a: *x", "a: !!str 1", "a: |", "a: >", "a: {b: 1}", "a: [a: b]",
    "- 1", "a:\n  - 1", "a: b: c", "a: 1\na: 2", "a: [1, 2", "a: \"x", "---\na: 1",
    "a:\n\tb: 1", "a: x\n  y", "[1]", "a: 1\n  b: 2",
])
def test_yaml_outside_subset_raises_naming_the_line(text):
    with pytest.raises(ConfigError, match=r"<yaml>:\d+: .*outside the YAML subset"):
        parse_yaml(text)


OVERRIDES = [
    {"dataset.max_count": 2, "inference.batch_size": 2},
    {"experiment_params.num_inference_steps": [4], "model.tiny": False},
    {"logger.new_section.deep": "x", "experiment_params.skip_steps": [[2, 3], [5]]},
    {"model.model_name.sub": 1},  # a scalar in mid-path
    {"extra_section.key": 1},  # an unknown section
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_overrides_match_jax(overrides):
    path = REPO / "configs" / "smoke.yaml"
    try:
        want = jload_config(path, overrides).to_dict()
    except JConfigError as e:
        with pytest.raises(ConfigError) as got:
            load_config(path, overrides)
        assert str(got.value) == str(e)
        return
    assert load_config(path, overrides).to_dict() == want


@pytest.mark.parametrize("pairs", [
    ["dataset.max_count=2", "model.tiny=false", "a.b=[4, 8]"],
    ["a=[[2, 3], [5, 6, 7]]", "b=hello world", "c='quoted'", "d=1.0e-4", "e=~", "f=x=y"],
])
def test_parse_sets_matches_jax(pairs):
    assert repr(cli._parse_sets(pairs)) == repr(jcli._parse_sets(pairs))


@pytest.mark.parametrize("pair", ["dataset.max_count=", "dataset.max_count", "=3", "a=  "])
def test_parse_sets_rejects_empty_key_or_value(pair):
    with pytest.raises(SystemExit):
        cli._parse_sets([pair])


def test_parse_value_outside_subset_raises():
    with pytest.raises(ConfigError, match="--set a"):
        parse_value("{b: 1}", "--set a")


def test_bare_config_name_resolves_under_configs(monkeypatch):
    monkeypatch.chdir(REPO)
    assert load_config("smoke.yaml").to_dict() == jload_config("smoke.yaml").to_dict()
    with pytest.raises(FileNotFoundError):
        load_config("no_such_config.yaml")
