"""The rule registry of the analysis layer: the port's own copy of
``tpu_dist/analysis/rules.py`` (its ``Rule``, ``RULES``, ``Violation`` and
``describe``), stdlib only.

Every ID, name and :class:`Violation` field is JAX's, so reports and
suppressions read the same in both packages. A summary is retargeted only
where JAX's names a JAX mechanism (the jaxpr, the HLO, ``jax.jit``); the
ID and the name stay.

The second half is the AST lint's configuration (JAX's ``rules.py:368-503``,
read by :mod:`~tpu_dist_torch.analysis.lint`), retargeted to PyTorch's
idioms: a "traced" function becomes a *step context* (a function nested in
a hot step factory, the body of a CUDA-graph capture, a callable handed to
``torch.compile``/``checkpoint``/``torch.func``, the ``forward``/``backward``
of an ``autograd.Function``), the host syncs are torch's, the collectives
``torch.distributed``'s and the port's wrappers', and the fragile imports
torch's private modules. The tables that name no framework (TD002's and
TD007's logger and rank spellings, TD006's allowlist) keep JAX's spellings,
so both lints agree on those rules over the same source.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str


RULES: dict = {
    r.id: r
    for r in [
        Rule(
            "TD001",
            "host-sync-in-traced-fn",
            "host-synchronizing call (.item()/.cpu()/.tolist()/float()/"
            "np.asarray/torch.cuda.synchronize()) inside a train step or a "
            "captured CUDA graph — forces a device round-trip every step",
        ),
        Rule(
            "TD002",
            "unguarded-nonrank0-io",
            "print/log/file-write not guarded by get_rank() == 0 — every "
            "rank duplicates the I/O (reference rank-0 discipline, "
            "tutorials/2 §3)",
        ),
        Rule(
            "TD003",
            "jit-missing-donate",
            "a hot-path step/epoch builder that keeps the old TrainState "
            "alive across the update (a functional copy where the update "
            "must be in place) — doubles peak device memory",
        ),
        Rule(
            "TD004",
            "version-fragile-jax-import",
            "direct import of a private torch API that moved between "
            "releases (torch._C, torch.distributed internals) — must route "
            "through one guarded place",
        ),
        Rule(
            "TD005",
            "nondeterminism-in-traced-fn",
            "np.random/time.time()/stdlib random inside a captured step — "
            "frozen into the CUDA graph at capture, NOT fresh per replay",
        ),
        Rule(
            "TD006",
            "silent-exception-swallow",
            "`except ...: pass` (outside the benign allowlist) or bare "
            "`except:` silently swallows failures — in a multi-process job "
            "this hides the first fault until a collective deadlocks; "
            "re-raise, log, or narrow the type",
        ),
        Rule(
            "TD007",
            "bare-print-outside-logging-layer",
            "bare `print(` outside the metrics/logging allowlist — even "
            "rank-0-guarded prints bypass the one grep-able output layer "
            "(rank0_print / get_logger / ProgressMeter); route through it "
            "or inline-ignore with the audit reason",
        ),
        Rule(
            "TD008",
            "rank-guarded-collective",
            "a collective call site reachable only under rank-/process-"
            "dependent control flow — the guarded ranks enter the "
            "collective, the rest never do, and the job dies as a "
            "cross-host deadlock minutes later; hoist the collective out "
            "of the guard (compute on every rank, act on one)",
        ),
        Rule(
            "TD101",
            "collective-budget-mismatch",
            "the step's collective-call count differs from the parallelism "
            "config's budget — an accidental extra (or missing) cross-rank "
            "reduce in the step",
        ),
        Rule(
            "TD102",
            "unexpected-transfer-op",
            "a host<->device copy inside the train step — host-device "
            "traffic on the hot path",
        ),
        Rule(
            "TD103",
            "bf16-promotion-over-budget",
            "more bf16->f32 casts than the mixed-precision path declares — "
            "an implicit promotion is silently doing f32 math",
        ),
        Rule(
            "TD105",
            "fault-injection-not-noop",
            "the train step's dispatched ops differ between fault injection "
            "OFF and an armed --fault_plan — injection points must be "
            "host-side no-ops that never enter the step "
            "(resilience/faults.py contract)",
        ),
        Rule(
            "TD106",
            "telemetry-not-noop",
            "the train step's dispatched ops differ between telemetry OFF "
            "and armed spans/counters/heartbeat — run telemetry must be "
            "host-side only and add no per-step device work "
            "(tpu_dist_torch.obs contract)",
        ),
        Rule(
            "TD107",
            "device-metrics-cost-leak",
            "the --device_metrics contract broke: flag OFF must leave the "
            "train step's ops identical, flag ON must add zero collectives "
            "and zero transfer ops on the pure-DP path (the health scalars "
            "ride the reduced gradients and the existing single per-step "
            "fetch — obs/device_stats.py)",
        ),
        Rule(
            "TD108",
            "profile-trigger-not-noop",
            "the train step's dispatched ops differ between no profiler and "
            "an armed/capturing triggered profiler — capture control must "
            "stay host-side (arm flags, torch.profiler start/stop around "
            "the unmodified step; obs/profile.py contract)",
        ),
        Rule(
            "TD109",
            "live-export-not-noop",
            "the train step's dispatched ops differ between live telemetry "
            "OFF and an armed OpenMetrics exporter + alert engine "
            "(exposition published, /metrics scraped, threshold rules "
            "fired) — live export and alerting must stay host-side "
            "(obs/export.py + obs/alerts.py contract)",
        ),
        Rule(
            "TD110",
            "xprof-hook-not-noop",
            "the train step's dispatched ops differ between no profiler and "
            "a triggered profiler whose AUTO-ANALYZE hook is armed — across "
            "arm, capture-open, and capture-closed-and-analyzed states "
            "(obs/xprof.py read-back + cost-model calibration must stay "
            "host-side file crunching; obs/profile.py contract)",
        ),
        Rule(
            "TD111",
            "elastic-resume-not-noop",
            "the train step of an elastic-resumed trainer (state restored "
            "from a checkpoint written at a DIFFERENT dp extent and "
            "remapped) differs from a fresh-start trainer at the same new "
            "world size — the remap must be restore-time host work that "
            "reproduces exactly the shapes/dtypes a fresh construction "
            "gets (elastic/remap.py contract)",
        ),
        Rule(
            "TD112",
            "elastic-grow-not-noop",
            "the train step of a GROW-resumed trainer (state restored from "
            "a checkpoint written at a SMALLER dp extent and remapped up "
            "onto more ranks) differs from a fresh-start trainer at the "
            "same larger world size — the scale-up remap must be "
            "restore-time host work that reproduces exactly the "
            "shapes/dtypes a fresh construction gets (the grow mirror of "
            "TD111; elastic/remap.py contract)",
        ),
        Rule(
            "TD113",
            "flight-recorder-not-noop",
            "the train step's dispatched ops differ between crash forensics "
            "OFF and an armed flight recorder + faulthandler (ring slots "
            "written, excepthooks wrapped, span-open listener tapped, "
            "SIGUSR1 all-threads dump registered and fired) — crash "
            "forensics must stay host-side file I/O on the step boundary "
            "(obs/flight.py contract)",
        ),
        Rule(
            "TD114",
            "serving-slo-not-noop",
            "the serving forward's dispatched ops differ between bare "
            "inference and the full serve telemetry/SLO kit armed "
            "(streaming latency histograms observing, queue/occupancy "
            "gauges published, SLO alert engine fired, histogram "
            "exposition rendered and parsed back, span recorder tapped) — "
            "serving observability must stay host-side arithmetic around "
            "the unmodified forward (serve contract)",
        ),
        Rule(
            "TD115",
            "memory-ledger-not-noop",
            "the train step's dispatched ops differ between the memory "
            "ledger OFF and the full memory kit armed (static per-leaf "
            "ledger over a real sharded state, live-tensor census, "
            "allocator stats read, census/allocator reconciliation, mem.* "
            "gauges published, pre-flight feasibility check, out-of-memory "
            "parser exercised) — memory observability must stay host-side "
            "metadata arithmetic (obs/memory.py contract)",
        ),
        Rule(
            "TD116",
            "compiled-collectives-match-predicted",
            "the collectives the step dispatched (c10d ops) disagree with "
            "the collectives it asked for through comm/collectives.py under "
            "the one ring model (elements exact; integer/quantized legs "
            "byte-exact; float legs exact modulo a declared bf16->f32 "
            "widening) — one of the two accountings is lying about what "
            "the step moves (analysis/shardlint.py)",
        ),
        Rule(
            "TD117",
            "unintended-reshard-in-compiled-step",
            "the step dispatched a collective its calls did not predict (a "
            "c10d op outside comm/collectives.py, an unpredicted op kind, "
            "or per-kind wire bytes beyond the prediction) — usually a raw "
            "torch.distributed call gathering state the step expected "
            "resident (analysis/shardlint.py)",
        ),
        Rule(
            "TD118",
            "plan-must-verify",
            "the --auto_shard planner's chosen plan was priced on a "
            "collective inventory that does not match what a fresh "
            "shardlint run of the same family dispatches (per-kind "
            "op/element/byte counts, total wire bytes) — the ranking "
            "rests on a stale or perturbed cost basis; the "
            "--inject-miscost probe must be caught or the detector is "
            "dead (analysis/planner.py)",
        ),
        Rule(
            "TD119",
            "planner-error-tracked",
            "after a profiled run, the predicted-vs-achieved step time "
            "drift (|predicted - achieved| / achieved) must land in "
            "history as planner_error_frac ('plan' records) and gate "
            "through `obs compare` METRIC_DIRECTIONS (lower is better) — "
            "planner drift is a regression like any other "
            "(analysis/planner.py, obs/compare.py)",
        ),
        Rule(
            "TD120",
            "async-ckpt-semantics-preserved",
            "the async sharded checkpoint path (--sharded_ckpt + "
            "--async_ckpt) must leave the train step's ops identical to "
            "synchronous saves AND restore bit-exact to the synchronous "
            "sharded format; the injected EIO and SIGTERM fault probes "
            "must surface through the drain path — an uncaught probe "
            "means the detector is dead (CLI exit 2) (ckpt/checkpoint.py)",
        ),
        Rule(
            "TD121",
            "tuner-knob-schedule-only",
            "an overlap-autotuner knob (pmean_fusion, rs_ag_chunks, "
            "quant_chunk) changed the payload-byte inventory shardlint "
            "pins, or failed to move the collective schedule at all — "
            "knobs must be semantics-preserving schedule transforms by "
            "construction, and a payload drift or a vacuous knob is a "
            "lying search space; the --inject-payload probe must be "
            "caught or the detector is dead (CLI exit 2) "
            "(analysis/overlap.py)",
        ),
        Rule(
            "TD122",
            "tenancy-arbitration-control-plane-only",
            "the train step or the serving forward CHANGED when the "
            "multi-tenant arbitration kit was armed (serve-gauge scrape "
            "through read_signals, kind-aware fleet policy driven to a "
            "genuinely fired SLO preemption, the cooperative SIGTERM flag "
            "raised, load-shedding admission refusing work) — train/serve "
            "co-scheduling must stay host-side control-plane arithmetic "
            "around the unmodified steps, and a probe where the preemption "
            "never fires is vacuous (fleet/scheduler.py, serve/engine.py)",
        ),
        Rule(
            "TD123",
            "pod-telemetry-control-plane-only",
            "the train step or the serving forward CHANGED when the pod "
            "telemetry plane was armed (two-run federated hub scrape "
            "mid-audit, the arbiter fed from the hub snapshot, a "
            "donate→grant pair chained under ONE decision_id propagated "
            "through allocation file → relaunch env → resume record, the "
            "serve-preempt gap charged to preempt_for_serve_s with the "
            "bucket partition exact) — federation and causal tracing must "
            "stay host-side file arithmetic, and a probe that aggregates "
            "zero runs or loses the id mid-chain is vacuous "
            "(obs/hub.py, fleet/scheduler.py)",
        ),
        Rule(
            "TD124",
            "archive-gate-not-vacuous",
            "the longitudinal archive's regression machinery went dead or "
            "device-side: an injected past-band candidate must come back "
            "REGRESSED through the MAD-band gate, an injected improvement "
            "must come back clean, an injected changepoint must be "
            "localized by --blame to the exact archived record, ingest "
            "must be idempotent by fingerprint with stale re-emissions "
            "flagged and excluded from the band — and arming the full "
            "ingest+gate+trend kit must leave the train step's ops "
            "identical (obs/archive.py)",
        ),
        Rule(
            "TD104",
            "quantized-wire-bytes-over-budget",
            "gradient-collective payload bytes of a quantized wire format "
            "exceed the declared ratio of its reference mode (int8 must "
            "stay ≤0.5× bf16 / ≤0.25× f32) — a wire leg silently "
            "decompressed",
        ),
    ]
}


@dataclasses.dataclass
class Violation:
    rule: str
    path: str  # repo-relative file, or "<kind:case>" for a traced step
    line: int
    message: str
    col: int = 0
    snippet: str = ""

    def format_text(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        return f"{loc}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def baseline_key(self) -> tuple:
        """Line numbers drift; baseline entries match on the line's text."""
        return (self.rule, self.path, self.snippet.strip())


def describe(rule_id: str) -> str:
    r = RULES.get(rule_id)
    return f"{r.id} ({r.name}): {r.summary}" if r else rule_id


# --------------------------------------------------------------------------
# Lint configuration (Layer 1 knobs, one place).
# --------------------------------------------------------------------------

# Calls whose callable argument (or decorated function) runs as a step
# context (TD001/TD005 scope): captured into a CUDA graph, compiled, or
# re-run by autograd, where a host read stalls every replay and a host
# value is frozen at capture. Inside a hot factory (HOT_FACTORY_REGEX)
# every nested function is a step context too, and so is the body of a
# ``with torch.cuda.graph(...)`` block.
TRACE_ENTRY_CALLS = {
    "torch.compile",
    "torch.cuda.make_graphed_callables",
    "torch.utils.checkpoint.checkpoint",
    "torch.func.grad",
    "torch.func.grad_and_value",
    "torch.func.vmap",
    "torch.vmap",
}
# ``with <one of these>(...):`` bodies are captured (step context).
GRAPH_CAPTURE_CALLS = {"torch.cuda.graph"}
# ``class F(<one of these>)``: its ``forward``/``backward`` are step contexts.
AUTOGRAD_FUNCTION_BASES = {"torch.autograd.Function"}

# Fully-resolved call targets that force a host sync (TD001).
HOST_SYNC_CALLS = {
    "torch.cuda.synchronize",
    "numpy.asarray",
    "numpy.array",
    "numpy.asanyarray",
    "numpy.ascontiguousarray",
}
# Method names that force a host sync on any receiver when called with no
# arguments (TD001): a tensor's value read back to the host.
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# Builtins that force a sync when applied to a tensor (TD001).
HOST_SYNC_BUILTINS = {"float", "int", "bool"}

# Nondeterministic-at-capture call prefixes (TD005): in a captured graph
# such a call runs once, at capture, and every replay reuses its value.
NONDETERMINISM_PREFIXES = ("numpy.random.", "random.")
NONDETERMINISM_CALLS = {
    "time.time",
    "time.perf_counter",
    "time.monotonic",
    "time.time_ns",
}

# Logger-ish method names for TD002 (receiver name must look like a logger).
LOG_METHODS = {"debug", "info", "warning", "error", "critical", "exception", "log"}
LOGGERISH_NAMES = ("log", "logger")

# Rank-0 guard spellings TD002 recognizes in `if` tests: ``dist.get_rank()``,
# the port's ``collectives.rank()``/``mesh.process_index()``/``is_primary()``,
# and JAX's spellings, which both lints share.
RANK_CALL_SUFFIXES = ("process_index", "is_primary", "get_rank", "rank")
RANK_VAR_NAMES = {"rank", "local_rank", "process_id", "proc_id", "process_index", "pid"}

# The port's one-process benchmark scripts (no JAX counterpart): each runs
# on one card and prints its report, so TD002 and TD007 allow them whole.
BENCH_SCRIPTS = (
    "tpu_dist_torch/obs/fused_sgd_bench.py", "tpu_dist_torch/obs/health_cost.py",
    "tpu_dist_torch/obs/step_breakdown.py",
)

# Modules exempt from TD002 (JAX's list, the port's counterparts): host-side
# tooling that never runs inside a multi-process training job (the analysis
# and obs CLIs, the fleet controller in its single arbiter process, the serve
# CLI and drill in the single serving/operator process).
TD002_EXEMPT_PARTS = (
    "tpu_dist_torch/analysis/", "tpu_dist_torch/obs/__main__.py", "tpu_dist_torch/fleet/",
    "tpu_dist_torch/serve/__main__.py", "tpu_dist_torch/serve/drill.py",
    *BENCH_SCRIPTS,
)

# TD007 allowlist (JAX's list, the port's counterparts): the designated
# output layer (rank0_print/get_logger and the ProgressMeter display sink)
# plus the CLI report modules whose stdout is the product.
TD007_ALLOWED_PARTS = (
    "tpu_dist_torch/metrics/logging.py",
    "tpu_dist_torch/metrics/meters.py",
    "tpu_dist_torch/analysis/",
    "tpu_dist_torch/obs/__main__.py",
    "tpu_dist_torch/serve/__main__.py",
    "tpu_dist_torch/serve/drill.py",
    *BENCH_SCRIPTS,
)

# TD003 scope: step contexts nested in these factory-name patterns are "hot
# path" (``make_train_step``'s ``step``, ``make_step_body``'s ``body``).
HOT_FACTORY_REGEX = r"^(make|build)_.*(step|epoch|train|update)"
# TD003: names of training state whose out-of-place rebinding (``p = p -
# lr * g``, ``p.data = ...``) or whole copy (``.clone()``, ``copy.deepcopy``)
# inside a hot step keeps the old state alive beside the new one. Matched on
# the last name of the target (``state.params`` -> ``params``).
TD003_STATE_NAMES = {
    "state", "params", "param", "p", "weight", "weights", "opt_state", "momentum", "mom",
    "buf", "bufs", "momentum_buffer", "exp_avg", "exp_avg_sq", "ef", "master",
}

# TD008: call targets that are (or transitively drive) a cross-process
# collective, matched on the LAST dotted segment: ``torch.distributed``'s
# calls, the wrappers of ``tpu_dist_torch/comm/collectives.py`` and the
# quantized reduce of ``train/step.py``. Any of these reachable only under a
# rank-dependent ``if`` is the deadlock shape: the guarded ranks enter the
# collective, the rest never do. The JAX-named wrappers the port kept
# (``reduce_mean``, ``broadcast_from``, ``barrier``...) are spelled as in
# JAX's table.
COLLECTIVE_CALLS = {
    # torch.distributed
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "barrier", "monitored_barrier", "all_to_all",
    "all_to_all_single", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "all_gather_object", "broadcast_object_list", "gather_object", "scatter_object_list",
    "send_object_list", "recv_object_list",
    # tpu_dist_torch.comm.collectives
    "all_reduce_", "all_to_all_tiled", "all_gather_flat", "gather_flat", "all_gather_dim",
    "reduce_scatter_dim", "sum_across_ranks", "reduce_sum", "reduce_mean", "broadcast_from",
    "host_allreduce_mean", "broadcast_module", "rotate", "ring_rotate", "stage_handoff",
    "copy_to_tp", "reduce_from_tp", "copy_to_pipe", "reduce_from_pipe",
    # the quantized two-stage reduce (train/step.py)
    "quantized_pmean_flat", "compressed_pmean",
}
# ...except these receivers/modules, where a same-named method is host
# bookkeeping, not a collective. Matched on the resolved dotted prefix.
COLLECTIVE_CALL_NONMODULES = ("threading.", "multiprocessing.", "socket.", "os.",
                              "subprocess.", "numpy.")

# TD006: exception types a `pass`-only handler may swallow without comment —
# probe/cleanup idioms where absence IS the answer (JAX's list). Matched on
# the LAST dotted segment.
TD006_ALLOWED_SILENT = {
    "FileNotFoundError",
    "ImportError",
    "ModuleNotFoundError",
    "StopIteration",
    "Empty",           # queue.Empty poll loops
    "TimeoutExpired",  # subprocess poll-wait loops
    "TimeoutError",
}

# Version-fragile imports (TD004): module -> names that must come from the
# compat module ("*": every name; "_*": every private name). Besides the
# table, any import from a private torch module (a dotted segment with a
# leading underscore: ``torch._C``, ``torch.utils._python_dispatch``) is
# fragile.
FRAGILE_IMPORTS = {
    "torch._C": {"*"},
    "torch._utils": {"*"},
    "torch.utils._python_dispatch": {"*"},
    "torch.distributed.distributed_c10d": {"_*"},
}
FRAGILE_PRIVATE_ROOT = "torch"
# The one module allowed to perform those imports.
COMPAT_MODULE_SUFFIX = "tpu_dist_torch/comm/compat.py"
