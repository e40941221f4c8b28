"""The port's AST lint (``tpu_dist_torch/analysis/lint.py``): a planted
positive and a negative for each of TD001-TD008 in PyTorch's idioms (JAX's
cases of ``tests/test_analysis.py``, retargeted), the suppressions and the
baseline, JAX's ``(rule, line)`` set on shared sources for the rules whose
tables name no framework, and the port linting clean."""

import json
import os
import textwrap

import pytest
import torch_ranks  # noqa: F401 — one torch thread

from tpu_dist.analysis.lint import lint_source as jax_lint_source
from tpu_dist_torch.analysis import baseline as baseline_lib
from tpu_dist_torch.analysis.lint import lint_paths, lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(snippet: str, path: str = "tpu_dist_torch/fake/mod.py"):
    return lint_source(textwrap.dedent(snippet), path)


def _rules(violations):
    return [v.rule for v in violations]


# -- TD001: host sync in a step context ---------------------------------------


def test_td001_item_in_a_hot_factorys_step():
    vs = _lint(
        """
        def make_train_step(opt):
            def step(state, x):
                return x.sum().item()
            return step
        """
    )
    assert _rules(vs) == ["TD001"]
    assert vs[0].line == 4


@pytest.mark.parametrize("snippet", [
    # a torch.compile'd function, and a helper it calls by name
    """
    import numpy as np
    import torch

    def helper(x):
        return np.asarray(x)

    @torch.compile
    def fwd(x):
        return helper(x) + 1
    """,
    # the body of a CUDA-graph capture
    """
    import torch

    def capture(g, x):
        with torch.cuda.graph(g):
            y = x.cpu()
        return y
    """,
    # a callable handed to checkpoint
    """
    from torch.utils.checkpoint import checkpoint

    def run(x):
        def body(t):
            return float(t.sum())
        return checkpoint(body, x, use_reentrant=False)
    """,
    # an autograd.Function's backward
    """
    import torch

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            torch.cuda.synchronize()
            return g * 2
    """,
])
def test_td001_step_contexts(snippet):
    assert _rules(_lint(snippet)) == ["TD001"]


def test_td001_host_code_not_flagged():
    vs = _lint(
        """
        import numpy as np

        def host_metrics(x):
            return float(np.asarray(x).mean()), x.item(), x.cpu()
        """
    )
    assert vs == []


# -- TD002: unguarded non-rank-0 I/O -----------------------------------------


def test_td002_unguarded_print():
    # every rank duplicates it (TD002) and it bypasses the logging layer (TD007)
    vs = _lint(
        """
        def log_epoch(loss):
            print(f"loss {loss}")
        """
    )
    assert _rules(vs) == ["TD002", "TD007"]


def test_td002_guard_spellings_pass():
    vs = _lint(
        """
        import torch.distributed as dist
        from tpu_dist_torch.comm import collectives
        from tpu_dist_torch.comm.mesh import is_primary

        def a(loss):
            if dist.get_rank() == 0:
                print(loss)

        def b(loss):
            if is_primary():
                print(loss)

        def c(rank, loss):
            if rank != 0:
                return
            print(loss)

        def d(path, rec):
            if collectives.rank() != 0:
                return
            with open(path, "w") as f:
                f.write(rec)
        """
    )
    # every guard spelling satisfies TD002; the guarded prints still carry TD007
    assert _rules(vs) == ["TD007", "TD007", "TD007"]


def test_td002_file_write_and_logger():
    vs = _lint(
        """
        import logging

        def dump(path, logger):
            logging.info("hi")
            logger.warning("hi")
            with open(path, "a") as f:
                f.write("x")
        """
    )
    assert sorted(_rules(vs)) == ["TD002", "TD002", "TD002"]


# -- TD003: an out-of-place state update in a hot step ------------------------


def test_td003_hot_factory_flagged_cold_and_in_place_not():
    vs = _lint(
        """
        import copy

        def make_train_step(opt):
            def step(params, grads, lr):
                for p, g in zip(params, grads):
                    p.data = p - lr * g
                return params

            def snapshot(state):
                return copy.deepcopy(state)
            return step, snapshot

        def make_fused_epoch(opt):
            def step(params, grads, lr):
                for p, g in zip(params, grads):
                    p.add_(g, alpha=-lr)
            return step

        def make_eval_renderer(state):
            def render():
                return state.clone()
            return render
        """
    )
    assert _rules(vs) == ["TD003", "TD003"]
    assert all("make_train_step" in v.message for v in vs)
    assert [v.line for v in vs] == [7, 11]


# -- TD004: version-fragile private torch imports -----------------------------


def test_td004_fragile_import_spellings():
    vs = _lint(
        """
        import torch._C
        from torch._utils import _flatten_dense_tensors
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.distributed.distributed_c10d import _get_default_group
        """
    )
    assert _rules(vs) == ["TD004"] * 4


def test_td004_compat_module_exempt_and_clean_imports():
    src = "from torch.utils._python_dispatch import TorchDispatchMode\n"
    assert _lint(src, "tpu_dist_torch/comm/compat.py") == []
    assert _lint("from tpu_dist_torch.comm.compat import TorchDispatchMode\n"
                 "from torch.distributed.distributed_c10d import ProcessGroup\n"
                 "import torch.utils.checkpoint\n") == []


# -- TD005: capture-time nondeterminism ---------------------------------------


def test_td005_np_random_and_time_in_a_step():
    vs = _lint(
        """
        import time
        import numpy as np

        def make_train_step(opt):
            def step(x):
                noise = np.random.rand(*x.shape)
                t0 = time.time()
                return x + noise + t0
            return step
        """
    )
    assert sorted(_rules(vs)) == ["TD005", "TD005"]


def test_td005_device_generator_and_host_np_random_ok():
    vs = _lint(
        """
        import numpy as np
        import torch

        def make_train_step(gen):
            def step(x):
                return x + torch.randn(x.shape, generator=gen, device=x.device)
            return step

        def host_shuffle(n):
            return np.random.default_rng(0).permutation(n)
        """
    )
    assert vs == []


# -- TD006: silently swallowed exceptions -------------------------------------


def test_td006_silent_pass_and_bare_except_flagged():
    vs = _lint(
        """
        def prune(path):
            try:
                remove(path)
            except OSError:
                pass

        def anything(x):
            try:
                return x()
            except:
                return None
        """
    )
    assert _rules(vs) == ["TD006", "TD006"]
    assert "OSError" in vs[0].message and "bare" in vs[1].message


def test_td006_allowlisted_types_and_handled_bodies_pass():
    vs = _lint(
        """
        import queue

        def probe(q):
            try:
                import optional_dep
            except ImportError:
                pass
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            try:
                (q, (FileNotFoundError, OSError))
            except (FileNotFoundError, TimeoutError):
                pass

        def handled():
            try:
                risky()
            except OSError as e:
                raise RuntimeError("risky failed") from e
        """
    )
    assert vs == []


def test_td006_inline_suppression():
    vs = _lint(
        """
        def prune(path):
            try:
                remove(path)
            except OSError:  # tpu-dist: ignore[TD006] — best-effort prune
                pass
        """
    )
    assert vs == []


# -- TD007: bare print outside the logging layer ------------------------------


def test_td007_allowlist_paths():
    vs = _lint("def f(x):\n    print(x)\n", "tpu_dist_torch/metrics/logging.py")
    assert "TD007" not in _rules(vs)  # (TD002 still applies there)
    assert _lint("def f(x):\n    print(x)\n", "tpu_dist_torch/obs/__main__.py") == []
    vs = _lint(
        """
        import torch.distributed as dist

        def f(x):
            if dist.get_rank() == 0:
                print(x)
        """
    )
    assert _rules(vs) == ["TD007"]


# -- TD008: rank-guarded collective call sites --------------------------------


def test_td008_rank_guarded_collective_flagged():
    vs = _lint(
        """
        import torch.distributed as dist
        from tpu_dist_torch.comm import collectives

        def bad_branch(x, rank):
            if rank == 0:
                dist.all_reduce(x)
            return x

        def bad_early_return(x):
            if dist.get_rank() != 0:
                return x
            collectives.barrier()
            return x

        def bad_wrapper(x, rank):
            if not rank:
                return collectives.all_reduce_(x, kind="metrics")
            return x
        """
    )
    assert _rules(vs) == ["TD008", "TD008", "TD008"]
    assert "all_reduce" in vs[0].message and "deadlock" in vs[0].message


def test_td008_unguarded_and_audited_pass():
    vs = _lint(
        """
        import torch.distributed as dist
        from tpu_dist_torch.metrics.logging import rank0_print

        def good(x, rank):
            dist.all_reduce(x)
            if rank == 0:
                rank0_print(x)
            return x

        def audited(x, rank):
            if rank == 0:
                dist.broadcast(x, 0)  # tpu-dist: ignore[TD008] — single-process tool
            return x
        """
    )
    assert vs == []


# -- suppressions & baseline --------------------------------------------------


def test_inline_and_block_suppressions():
    vs = _lint(
        """
        def a(loss):
            print(loss)  # tpu-dist: ignore[TD002,TD007]

        def b(loss):
            # tpu-dist: ignore[TD002, TD007] — multi-line explanation of why
            # this print is deliberate on every process
            print(loss)

        def c(loss):
            print(loss)  # tpu-dist: ignore[TD001]  (wrong rule: still flagged)
        """
    )
    assert _rules(vs) == ["TD002", "TD007"]
    assert vs[0].line == 11


def test_baseline_filters_and_reports_stale(tmp_path):
    vs = _lint("def a(loss):\n    print(loss)\n")
    assert _rules(vs) == ["TD002", "TD007"]
    entries = [
        {"rule": "TD002", "path": "tpu_dist_torch/fake/mod.py", "snippet": "print(loss)"},
        {"rule": "TD007", "path": "tpu_dist_torch/fake/mod.py", "snippet": "print(loss)"},
        {"rule": "TD002", "path": "tpu_dist_torch/fake/mod.py", "snippet": "print(gone)"},
    ]
    new, stale = baseline_lib.apply(vs, entries)
    assert new == []
    assert [e["snippet"] for e in stale] == ["print(gone)"]
    # the file round trip, multiset: one entry absorbs one finding
    path = str(tmp_path / "baseline.json")
    baseline_lib.write(vs[:1], path)
    assert json.load(open(path))["accepted"] == entries[:1]
    new, stale = baseline_lib.apply(vs + vs[:1], baseline_lib.load(path))
    assert _rules(new) == ["TD007", "TD002"] and stale == []


# -- the rules both packages' tables share: JAX's (rule, line) set ------------

_SHARED = [
    """
    import logging
    import os

    def report(loss, rank, logger, path):
        print(loss)
        if rank == 0:
            print(loss)
            logger.info("saved")
        logging.warning("every rank")
        with open(path, "w") as f:
            f.write("x")
        if rank != 0:
            return
        with open(path, "a") as f:
            f.write("y")
    """,
    """
    def prune(paths):
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass
            try:
                os.remove(p)
            except (FileNotFoundError, ValueError):
                ...
            try:
                os.remove(p)
            except:
                continue
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    """,
    """
    from tpu_dist_torch.comm.collectives import all_gather, barrier, reduce_mean

    def sync(x, rank, process_index):
        if rank == 0:
            barrier()
        y = reduce_mean(x)
        if process_index > 0:
            y = all_gather(y)
        if not rank:
            return y
        return broadcast_from(y)

    def early(x, rank):
        if rank != 0:
            raise SystemExit
        host_allreduce_mean(x)
    """,
]


@pytest.mark.parametrize("snippet", _SHARED)
def test_language_neutral_rules_give_jaxs_findings(snippet):
    src = textwrap.dedent(snippet)
    neutral = {"TD002", "TD006", "TD007", "TD008"}
    ours = {(v.rule, v.line) for v in lint_source(src, "pkg/mod.py") if v.rule in neutral}
    theirs = {(v.rule, v.line) for v in jax_lint_source(src, "pkg/mod.py") if v.rule in neutral}
    assert ours == theirs and ours  # each source has findings to agree on


# -- the port itself ----------------------------------------------------------


def test_port_is_lint_clean():
    vs = lint_paths([os.path.join(REPO, "tpu_dist_torch")], root=REPO)
    assert baseline_lib.load(baseline_lib.DEFAULT_BASELINE) == []  # ships empty
    assert vs == [], "\n".join(v.format_text() for v in vs)
