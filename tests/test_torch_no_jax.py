"""The port stands alone: importing every module of ``tpu_dist_torch`` and
``chip_smoke`` loads neither JAX nor the JAX package, and no source file
of the port names either in an import."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
from torch_ranks import child_env

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "tpu_dist_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)

_PROBE = """
import importlib, json, sys
for name in {modules!r} + ["chip_smoke"]:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist"))))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|tpu_dist)\b|from\s+(jax|jaxlib|tpu_dist)(\.|\s))",
    re.MULTILINE,
)


def test_package_has_the_slice_modules():
    for name in ("tpu_dist_torch.obs.counters", "tpu_dist_torch.obs.spans",
                 "tpu_dist_torch.serve.slo", "tpu_dist_torch.serve.engine",
                 "tpu_dist_torch.ops.flash_attention", "tpu_dist_torch.ops._build",
                 "tpu_dist_torch.nn.attention", "tpu_dist_torch.nn.vit",
                 "tpu_dist_torch.bridge", "tpu_dist_torch.ops.fused_sgd",
                 "tpu_dist_torch.nn.functional", "tpu_dist_torch.train.optim",
                 "tpu_dist_torch.train.state", "tpu_dist_torch.train.step",
                 "tpu_dist_torch.comm.mesh", "tpu_dist_torch.comm.collectives",
                 "tpu_dist_torch.nn.initializers", "tpu_dist_torch.nn.layers",
                 "tpu_dist_torch.nn.resnet", "tpu_dist_torch.data.synthetic",
                 "tpu_dist_torch.data.transforms", "tpu_dist_torch.data.cifar",
                 "tpu_dist_torch.data.sampler", "tpu_dist_torch.data.loader",
                 "tpu_dist_torch.evaluation.validate", "tpu_dist_torch.metrics.meters",
                 "tpu_dist_torch.metrics.logging", "tpu_dist_torch.config.config",
                 "tpu_dist_torch.train.trainer", "tpu_dist_torch.cli.train",
                 "tpu_dist_torch.cli.distributed", "tpu_dist_torch.cli.distributed_mp",
                 "tpu_dist_torch.cli.dataparallel", "tpu_dist_torch.obs.timing",
                 "tpu_dist_torch.obs.fused_sgd_bench", "tpu_dist_torch.resilience.retry",
                 "tpu_dist_torch.resilience.preemption", "tpu_dist_torch.ckpt",
                 "tpu_dist_torch.ckpt.checkpoint", "tpu_dist_torch.metrics.history",
                 "tpu_dist_torch.cli.launch", "tpu_dist_torch.cli.dataparallel_apex",
                 "tpu_dist_torch.cli.distributed_apex",
                 "tpu_dist_torch.cli.distributed_gradient_accumulation",
                 "tpu_dist_torch.train.epoch", "tpu_dist_torch.comm.quantize",
                 "tpu_dist_torch.elastic", "tpu_dist_torch.elastic.errors",
                 "tpu_dist_torch.elastic.remap", "tpu_dist_torch.obs.alerts",
                 "tpu_dist_torch.obs.heartbeat", "tpu_dist_torch.obs.export",
                 "tpu_dist_torch.obs.summarize", "tpu_dist_torch.serve.__main__",
                 "tpu_dist_torch.obs.flight", "tpu_dist_torch.obs.postmortem",
                 "tpu_dist_torch.obs.compare", "tpu_dist_torch.obs.__main__",
                 "tpu_dist_torch.obs.memory", "tpu_dist_torch.obs.goodput",
                 "tpu_dist_torch.serve.supervisor", "tpu_dist_torch.serve.replica",
                 "tpu_dist_torch.serve.drill", "tpu_dist_torch.fleet",
                 "tpu_dist_torch.fleet.scheduler", "tpu_dist_torch.resilience.faults",
                 "tpu_dist_torch.obs.drill", "tpu_dist_torch.data.native",
                 "tpu_dist_torch.elastic.drill", "tpu_dist_torch.elastic.supervisor",
                 "tpu_dist_torch.fleet.capacity", "tpu_dist_torch.fleet.drill",
                 "tpu_dist_torch.obs.hub", "tpu_dist_torch.fleet.tenancy_drill",
                 "tpu_dist_torch.obs.costmodel", "tpu_dist_torch.parallel",
                 "tpu_dist_torch.parallel.tensor", "tpu_dist_torch.parallel.expert",
                 "tpu_dist_torch.nn.vit_moe", "tpu_dist_torch.parallel.pipeline",
                 "tpu_dist_torch.nn.vit_pp", "tpu_dist_torch.parallel.fsdp"):
        assert name in MODULES


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=MODULES)],
        cwd=ROOT, env=child_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _FORBIDDEN.findall(path.read_text())


def test_the_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from tpu_dist.nn import vit", "import tpu_dist.obs", "    import jax"):
        assert _FORBIDDEN.search(line), line
    for line in ("import tpu_dist_torch", "from tpu_dist_torch.nn import vit",
                 "# a comment on jax", "import jaxtyping"):
        assert not _FORBIDDEN.search(line), line
