"""No module with the top-level name ``jax``, ``jaxlib``, ``flax`` or
``tpu_dist`` is loaded by a run, and the reference loads nothing of
``tpu_dist_torch``: each checked in a fresh interpreter, with the names
compared whole (``tpu_dist_torch`` is not ``tpu_dist``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

from gpubench import run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {here!r}]
from tiny import tiny_root
from gpubench import run
from gpubench.manifest import Manifest
man = Manifest(tiny_root(Path(tempfile.mkdtemp())))
for cell in ("vit_tiny.t_step", "resnet_tiny.t_fused"):
    run.run_cell(man, cell, 3, 0.2, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {here!r}]
from tiny import tiny_root
from gpubench.manifest import Manifest
from gpubench.run import reference_record
man = Manifest(tiny_root(Path(tempfile.mkdtemp())))
for cell in ("vit_tiny.t_step", "resnet_tiny.t_fused"):
    w = man.workload(cell)
    cfg, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    for precision in ("f32", "fp8"):
        reference_record(man.model(w["config"]), man.entry(traffic["entry"]), cfg, traffic, 3,
                         "cpu", precision)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(script: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT), here=str(HERE))],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(HERE))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level_names(RUN)
    assert "tpu_dist_torch" in names  # the run drives the port...
    assert not names & run.FORBIDDEN  # ...and nothing of JAX or the JAX package


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level_names(REFERENCE)
    assert "torch" in names
    assert not names & (run.FORBIDDEN | {"tpu_dist_torch"})


def test_the_look_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_dist_torchlike", sys)
    assert "tpu_dist" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_dist.ops", sys)
    assert run.forbidden_modules() == ["tpu_dist"]
