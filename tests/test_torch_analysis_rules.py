"""The port's rule registry (``tpu_dist_torch/analysis/rules.py``) against
JAX's: every ID and name, the ``Violation`` fields and their JSON and text,
``describe``; the summaries name no JAX mechanism; and the analysis CLI
module does nothing when it is imported."""

import dataclasses
import importlib
import re

import pytest
import torch.distributed as dist

from tpu_dist.analysis import rules as jax_rules
from tpu_dist_torch.analysis import RULES, Violation, rules


def test_every_rule_id_and_name_is_jaxs():
    assert sorted(RULES) == sorted(jax_rules.RULES)
    for rid, rule in RULES.items():
        assert rule.id == rid == jax_rules.RULES[rid].id
        assert rule.name == jax_rules.RULES[rid].name, rid


@pytest.mark.parametrize("rid", sorted(jax_rules.RULES))
def test_summaries_name_no_jax_mechanism(rid):
    summary = RULES[rid].summary
    assert summary and not re.search(r"jaxpr|\bHLO\b|GSPMD|\bjax\.|shard_map|in_shardings",
                                     summary), summary


def test_violation_fields_and_json_are_jaxs():
    assert ([f.name for f in dataclasses.fields(Violation)]
            == [f.name for f in dataclasses.fields(jax_rules.Violation)])
    args = ("TD117", "<hlo:zero1_sgd>", 0, "unpredicted all-gather")
    kw = dict(col=3, snippet="raw:all-gather:f32[480]  ")
    ours, theirs = Violation(*args, **kw), jax_rules.Violation(*args, **kw)
    assert ours.to_json() == theirs.to_json()
    assert ours.format_text() == theirs.format_text()
    assert ours.baseline_key() == theirs.baseline_key()
    assert Violation(**theirs.to_json()) == ours


@pytest.mark.parametrize("rid", ["TD116", "TD118", "TD121", "TD999"])
def test_describe_reads_the_registry(rid):
    text = rules.describe(rid)
    assert text == rid if rid not in RULES else text.startswith(f"{rid} ({RULES[rid].name}): ")


def test_the_cli_module_does_nothing_when_imported(capsys):
    mod = importlib.import_module("tpu_dist_torch.analysis.__main__")
    assert callable(mod.main) and not dist.is_initialized()
    assert capsys.readouterr() == ("", "")
