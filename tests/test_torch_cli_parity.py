"""The port's command lines held against the JAX package's, entry point by
entry point.

Each of the 11 entry points' parsers is built in both packages without
running the command: ``ArgumentParser.parse_known_args`` is patched to
raise with the parser that was about to parse, and the inventory walks
its actions and subparsers. ``python -m tpu_dist.analysis`` picks its
parser by the first argument (``shard``, ``plan``, ``tune-overlap`` or
none), so each of its four parsers is read.

Every JAX option string, positional and subcommand must be in the port
with the same ``choices``, and the port may add only the options of
:data:`ADDED`, each at the entry points it names. Both tables of
exceptions are tied to ``ROADMAP.md``: every option of :data:`ADDED` is
named in its "Flags the port adds" entry, and every flag of
:data:`REFUSED` (parsed, then refused with ``NotPortedError``) in its "No
port owed" entry. ``TrainConfig``'s fields are JAX's plus ``device``.
"""

import argparse
import dataclasses
import importlib
import os
import re

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.config import TrainConfig as JaxTrainConfig
from tpu_dist_torch.cli import launch
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.train import trainer
from tpu_dist_torch.train.step import NotPortedError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# entry point -> the first arguments that reach each of its parsers
ENTRY_POINTS = {
    "analysis": ((), ("shard",), ("plan",), ("tune-overlap",)),
    "cli.launch": ((),), "cli.train": ((),), "elastic.drill": ((),), "fleet.drill": ((),),
    "fleet.tenancy_drill": ((),), "obs": ((),), "obs.drill": ((),), "serve": ((),),
    "serve.drill": ((),), "serve.replica": ((),),
}

_DRILLS = {"elastic.drill", "fleet.drill", "fleet.tenancy_drill"}

# the options the port adds (ROADMAP.md "Flags the port adds"): option ->
# the entry points that add it
ADDED = {
    "--device": {"analysis", "cli.train", "obs.drill", "serve", "serve.drill",
                 "serve.replica", *_DRILLS},
    "--nprocs": {"analysis"},
    "--shrink_device": _DRILLS,
    "--no-audit": {"analysis"},
    "--kill_epoch": {"fleet.tenancy_drill"},
    "--kill_step": {"fleet.tenancy_drill"},
    "--fused_optimizer": {"fleet.tenancy_drill"},
    "--replica_model": {"fleet.tenancy_drill"},
    "--model": {"serve.replica"},
    "train_args": {"obs.drill"},
}

# JAX's flags the port parses and refuses (ROADMAP.md "No port owed"):
# flag -> the entry point that refuses it
REFUSED = {"--devices_per_proc": "cli.launch", "--compile_cache_dir": "cli.train",
           "--devices": "obs.drill"}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def build_parser(pkg: str, entry: str, first: tuple) -> argparse.ArgumentParser:
    """The parser ``python -m <pkg>.<entry> <first...>`` parses with, built
    by the entry point's own ``main`` and caught before it parses."""
    try:
        mod = importlib.import_module(f"{pkg}.{entry}.__main__")
    except ModuleNotFoundError:
        mod = importlib.import_module(f"{pkg}.{entry}")

    def caught(self, args=None, namespace=None):
        raise _Parsed(self)

    orig = argparse.ArgumentParser.parse_known_args
    argparse.ArgumentParser.parse_known_args = caught
    try:
        mod.main(list(first))
    except _Parsed as got:
        return got.parser
    finally:
        argparse.ArgumentParser.parse_known_args = orig
    raise AssertionError(f"{pkg}.{entry} {first} parsed nothing")


def inventory(parser: argparse.ArgumentParser, path: tuple = ()) -> dict:
    """``{(subcommand, ..., option string or positional): choices}``; a
    subcommand is a key of its own, with ``choices`` ``"subcommand"``."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[(*path, name)] = "subcommand"
                out.update(inventory(sub, (*path, name)))
            continue
        choices = tuple(action.choices) if action.choices is not None else None
        for name in action.option_strings or [action.dest]:
            out[(*path, name)] = choices
    return out


def entry_inventory(pkg: str, entry: str) -> dict:
    out = {}
    for first in ENTRY_POINTS[entry]:
        if first:
            out[first] = "subcommand"
        out.update(inventory(build_parser(pkg, entry, first), first))
    return out


def parity_problems(entry: str, jax_inv: dict, port_inv: dict) -> list:
    """What keeps the port's inventory from JAX's plus :data:`ADDED`."""
    problems = [f"{' '.join(k)}: missing from the port" for k in jax_inv if k not in port_inv]
    problems += [f"{' '.join(k)}: choices {port_inv[k]} in the port, {v} in JAX"
                 for k, v in jax_inv.items() if k in port_inv and port_inv[k] != v]
    added = {k[-1] for k in port_inv if k not in jax_inv}
    allowed = {opt for opt, entries in ADDED.items() if entry in entries}
    problems += [f"{opt}: added by the port, not in ADDED" for opt in sorted(added - allowed)]
    problems += [f"{opt}: in ADDED, not added by the port" for opt in sorted(allowed - added)]
    return problems


@pytest.fixture(scope="module")
def inventories():
    return {entry: (entry_inventory("tpu_dist", entry), entry_inventory("tpu_dist_torch", entry))
            for entry in ENTRY_POINTS}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_the_port_parses_every_jax_flag(inventories, entry):
    jax_inv, port_inv = inventories[entry]
    assert jax_inv, f"{entry}: JAX's parser read empty"
    assert parity_problems(entry, jax_inv, port_inv) == []


def test_the_check_catches_a_removed_flag_and_a_changed_choice(inventories):
    jax_inv, _ = inventories["cli.train"]
    parser = build_parser("tpu_dist_torch", "cli.train", ())  # a copy: built anew
    (lr,) = [a for a in parser._actions if "--lr" in a.option_strings]
    parser._actions.remove(lr)
    (opt,) = [a for a in parser._actions if "--optimizer" in a.option_strings]
    opt.choices = [c for c in opt.choices if c != "lamb"]
    assert parity_problems("cli.train", jax_inv, inventory(parser)) == [
        "--lr: missing from the port",
        f"--optimizer: choices {tuple(opt.choices)} in the port, "
        f"{jax_inv[('--optimizer',)]} in JAX"]
    # and the one JAX lacks
    parser.add_argument("--not_in_jax", action="store_true")
    parser._actions.append(lr)
    opt.choices = list(jax_inv[("--optimizer",)])
    assert parity_problems("cli.train", jax_inv, inventory(parser)) == [
        "--not_in_jax: added by the port, not in ADDED"]


def _roadmap_entry(title: str) -> str:
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    m = re.search(rf"\*\*{re.escape(title)}:\*\*(.*?)(?=\n\*\*|\n#)", text, re.S)
    assert m, f"ROADMAP.md has no **{title}:** entry"
    return m.group(1)


def test_every_exception_is_named_in_the_roadmap():
    added = _roadmap_entry("Flags the port adds")
    assert [opt for opt in ADDED if f"`{opt}`" not in added] == []
    owed = _roadmap_entry("No port owed")
    assert [flag for flag in REFUSED if f"`{flag}`" not in owed] == []


def test_the_refused_flags_cite_no_port_owed(inventories):
    for flag, entry in REFUSED.items():
        assert (flag,) in inventories[entry][1], f"{entry} does not parse {flag}"
    assert launch.UNPORTED["devices_per_proc"][1].startswith('Queue A "No port owed"')
    assert trainer.UNPORTED["compile_cache_dir"][1].startswith('Queue A "No port owed"')
    assert set(launch.UNPORTED) | set(trainer.UNPORTED) == {
        f[2:] for f, e in REFUSED.items() if e in ("cli.launch", "cli.train")}


def test_train_config_is_jaxs_plus_device():
    ours = [f.name for f in dataclasses.fields(TrainConfig)]
    theirs = [f.name for f in dataclasses.fields(JaxTrainConfig)]
    assert sorted(ours) == sorted([*theirs, "device"])


def test_analysis_takes_no_jaxpr_as_no_audit(tmp_path, capsys):
    from tpu_dist_torch.analysis import __main__ as cli  # noqa: PLC0415

    planted = tmp_path / "planted.py"
    planted.write_text("def f(x):\n    print(x)\n")
    outs = []
    for flag in ("--no-audit", "--no-jaxpr"):
        assert cli._default_parser().parse_args([flag]).no_audit
        assert cli.main([str(planted), flag]) == 1  # the lint alone, no process group
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1] and "TD007" in outs[0].out


def test_obs_drill_refuses_devices_as_the_launcher_refuses_devices_per_proc(tmp_path):
    from tpu_dist_torch.obs import drill  # noqa: PLC0415

    assert build_parser("tpu_dist_torch", "obs.drill", ()).parse_args(
        ["--workdir", "w"]).devices is None
    with pytest.raises(NotPortedError) as info:
        drill.main(["--workdir", str(tmp_path), "--device", "cpu", "--devices", "4"])
    assert info.value.flag == "devices"
    assert info.value.queue == launch.UNPORTED["devices_per_proc"][1]
    assert not os.listdir(tmp_path)  # refused before the drill starts anything
