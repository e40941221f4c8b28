"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` holds its sizes; ``gpubench/models/<config>.py``
builds it; ``gpubench/traffic/<traffic>.json`` holds the traffic;
``gpubench/entries/<entry>.py`` drives it; ``gpubench/metrics/<metric>.py``
reads each metric; ``gpubench/limits/<workload>.json`` holds the limits of
``correct``. Modules are loaded from their files, so a name may hold a dot.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from gpubench.check import NUMBERS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PKG = "gpubench"


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` under ``root`` (a checkout's root)."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / PKG

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        data = json.loads((self.pkg / "limits" / f"{workload}.json").read_text())
        limits = {k: v["limit"] for k, v in data.items()}
        if not limits or set(limits) - set(NUMBERS):
            raise ValueError(f"{workload}: limits {sorted(limits)}, numbers {NUMBERS}")
        return limits

    def model(self, config: str):
        return load_module(self.pkg / "models" / f"{config}.py", f"{PKG}.models.{config}")

    def entry(self, name: str):
        return load_module(self.pkg / "entries" / f"{name}.py", f"{PKG}.entries.{name}")

    def reader(self, metric: str):
        return load_module(self.pkg / "metrics" / f"{metric}.py", f"{PKG}.metrics.{metric}")

    def metrics(self, workload: str, per_layer: bool) -> list:
        """The ``end_to_end`` (or ``per_layer``) metrics the cell reports:
        those whose ``workloads`` list it, or that have no such list."""
        key = "per_layer" if per_layer else "end_to_end"
        return [m for m in self.data[key] if workload in m.get("workloads", [workload])]
