"""The rule registry of the analysis layer: the port's own copy of
``tpu_dist/analysis/rules.py`` (its ``Rule``, ``RULES``, ``Violation`` and
``describe``), stdlib only.

Every ID, name and :class:`Violation` field is JAX's, so reports and
suppressions read the same in both packages. A summary is retargeted only
where JAX's names a JAX mechanism (the jaxpr, the HLO, ``jax.jit``); the
ID and the name stay. The AST lint's configuration (the rest of JAX's
module) comes with the lint itself.
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
