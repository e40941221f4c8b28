"""The port's elastic drill (``python -m tpu_dist_torch.elastic.drill``) on
the CPU: a golden ZeRO-1 ``vit_tiny`` run of 2 gloo ranks on the
``int8_ef`` wire, the same run SIGTERMed at epoch 1 step 1 (exit 75), and
its shrink to 1 rank with ``--resume``; the drill verifies the exit codes,
the ``resume`` record (``resharded``: the residual rows re-laid, dp 2 ->
1) and each epoch's loss against the golden run within ``LOSS_RTOL``, as
the JAX drill does (``tpu_dist/elastic/drill.py``,
``tests/test_elastic.py::test_elastic_drill_cli``, which shrinks 8
emulated devices to 4). An epoch's loss is its last step's, taken before
that step's update, so the other world's rounding draws do not reach it.
A world on CUDA larger than the cards there fails with the count, and
never moves to the CPU.
"""

import json
import os
import subprocess
import sys

from torch_ranks import child_env

from tpu_dist_torch.elastic import drill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_drill_passes_on_cpu_ranks(tmp_path):
    env = child_env(PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.elastic.drill", "--workdir", str(tmp_path),
         "--device", "cpu", "--batch_size", "32", "--devices", "2",
         "--grad_compression", "int8_ef"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert "elastic-drill: PASS" in out
    for phase, rc in (("golden", 0), ("preempt", 75), ("shrink-resume", 0)):
        assert f"phase {phase}: exit {rc}" in out
    rec = json.loads(out.split("elastic-drill: resume record: ", 1)[1].splitlines()[0])
    assert rec["resharded"] is True and (rec["prev_dp"], rec["dp"]) == (2, 1)
    # 2 steps of 32 done before the SIGTERM: the offset, and the epoch re-entered
    assert (rec["epoch"], rec["examples_offset"], rec["restarts"]) == (1, 64, 1)
    assert out.count("(rel ") == 2  # both epochs compared with the golden run


def test_a_world_larger_than_the_cards_fails_with_the_count(tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert drill.main(["--workdir", str(tmp_path), "--device", "cpu",
                       "--shrink_device", "cuda"]) == 1
    assert "1 rank(s) on cuda need 1 card(s), and this machine has 0" in capsys.readouterr().out
    assert not os.listdir(tmp_path)  # refused before any phase ran
