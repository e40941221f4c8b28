"""A copy of the benchmark's tree in a temporary directory, with two small
cells beside the real ones, for runs on the CPU: ``vit_tiny.t_step`` and
``resnet_tiny.t_fused``, the real configurations and traffic mixes cut
small in a copy and held to the limits of the real cells they stand for."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"vit_tiny.t_step": "vit_b16.i224_b256",
         "resnet_tiny.t_fused": "resnet18_cifar100.fused_b256"}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_root(dst: Path) -> Path:
    """The tree under ``dst``; returns ``dst``."""
    src = REPO / "gpubench"
    shutil.copytree(src, dst / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    man = _json(REPO / "BENCHMARK.json")
    vit = dict(_json(src / "configs/vit_b16.json"), name="vit_tiny", hidden_size=128,
               num_hidden_layers=2, num_attention_heads=2, intermediate_size=512,
               num_classes=10, patch_size=4)
    res = dict(_json(src / "configs/resnet18_cifar100.json"), name="resnet_tiny",
               widths=[16, 32, 64, 128], stage_blocks=[1, 1, 1, 1], num_classes=10)
    res["data"] = dict(res["data"], train_images=512)
    step = dict(_json(src / "traffic/i224_b256.json"), image_size=32, batch=8, reference_rows=4)
    fused = dict(_json(src / "traffic/fused_b256.json"), batch=32, steps_per_call=8,
                 trace_steps=4)
    pkg = dst / "gpubench"
    for name, data in (("configs/vit_tiny", vit), ("configs/resnet_tiny", res),
                       ("traffic/t_step", step), ("traffic/t_fused", fused)):
        (pkg / f"{name}.json").write_text(json.dumps(data))
    shutil.copy(pkg / "models/vit_b16.py", pkg / "models/vit_tiny.py")
    shutil.copy(pkg / "models/resnet18_cifar100.py", pkg / "models/resnet_tiny.py")
    by_name = {c["name"]: c for c in man["configs"]}
    man["configs"] += [dict(by_name["vit_b16"], name="vit_tiny", file="gpubench/configs/vit_tiny.json"),
                       dict(by_name["resnet18_cifar100"], name="resnet_tiny",
                            file="gpubench/configs/resnet_tiny.json")]
    for name, real in CELLS.items():
        cfg, traffic = name.split(".")
        man["workloads"].append({"name": name, "config": cfg, "traffic": traffic, "chips": 1,
                                 "why": f"{real} cut small for the CPU"})
        shutil.copy(pkg / f"limits/{real}.json", pkg / f"limits/{name}.json")
        for m in man["end_to_end"] + man["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dst
