"""Device cost and efficiency accounting: a step's FLOPs and bytes, the
card's peak and memory, MFU. The port's counterpart of
``tpu_dist/obs/costmodel.py``.

The chip tables (:data:`CHIP_PEAK_FLOPS`, :data:`CHIP_HBM_BYTES`) hold one
row, the card the port runs on, keyed by the full
``torch.cuda.get_device_name()`` string and matched exactly: another card
(an H100 PCIe, say) or the CPU gives ``None``, never a guess. The peak is
the bf16 dense rate of NVIDIA's H100 SXM5 datasheet, as the JAX table
holds bf16 spec-sheet peaks.

:func:`step_cost` counts one real step while it runs (the trainer's first
dispatch; no extra step is run), the counterpart of XLA's cost analysis
of the compiled step:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` with one change. A
  convolution counts only its valid taps, the (output position, kernel
  tap) pairs whose input index falls inside the unpadded input, as XLA's
  ``HloCostAnalysis`` does: a 3x3 "SAME" convolution over a 4x4 image has
  100 valid taps of 144 (:func:`conv_flops`). The backward's input and
  weight gradients each count the forward's valid taps again. Elementwise
  work counts nothing (XLA counts it, which leaves the port's ResNet-18
  step ~0.6% under XLA's).
* Bytes: the tensor inputs and outputs of every aten op that is not a
  view, summed. The count is taken before any fusion: each op of an
  eager step reads and writes its operands in memory, so it is larger
  than XLA's ``bytes accessed`` of the fused program.
* Kernels the dispatch modes cannot see (the flash attention kernels,
  called through ``ctypes``) book their own formula through
  :func:`count_kernel`, their bodies hidden by :func:`hidden` so that the
  plain twin a CPU tensor takes counts the same as the kernel.

The count is the step's total across ranks, the JAX convention (the SPMD
step's cost analysis is global, and :func:`mfu` divides by ``peak ×
n_devices``): the caller passes its world and the local count is
multiplied by it. Under pipeline parallelism (``pp`` stages) the work a
rank does inside a pipeline stage's schedule (:func:`stage_region`: the
active ticks only) is its own, and is multiplied by the world; the rest
(the embedding, the head, the loss and the update, the same on every stage
of a pipe group) is multiplied by ``world / pp``, counted once a group. The
count is then the unsharded step's.

Ported as they are: :func:`mfu`, :func:`calibration`,
:func:`publish_calibration`, :func:`predicted_step_time`,
:func:`planner_error_frac`, :func:`publish`. :func:`device_memory_stats`
reads ``torch.cuda.memory_stats`` of one card (``None`` on the CPU, as the
JAX function returns there).

Not ported, because the port compiles no XLA program: ``CompileWatcher``
and ``install_compile_listener`` (a retrace is ROADMAP Queue C's
``retrace`` entry; the trainer counts ``compile.events`` and
``compile.seconds`` itself), ``lower_and_compile``,
``clear_compile_cache``, ``_aot_key``, ``memory_analysis_bytes`` and
``memory_analysis_jitted`` (the trainer measures the first step's memory
waterfall with the allocator instead: ``train/trainer.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from tpu_dist_torch.obs import counters as counters_lib

#: Peak dense matmul FLOP/s of one card (bf16), the MFU denominator: NVIDIA's
#: H100 SXM5 datasheet, at the full 700 W.
CHIP_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

#: Device memory of one card: ``torch.cuda.get_device_properties(0).total_memory``
#: as torch 2.11 reads it on an NVIDIA H100 80GB HBM3 (``chip_smoke.py`` phase
#: 14 holds the row to the card's own value). The pre-flight memory check
#: (``obs/memory.py::preflight_check``) prices a config against it.
CHIP_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 85_017_493_504,
}


def device_kind(device=None) -> Optional[str]:
    """The kind of ``device`` (default: the process's current CUDA card):
    ``torch.cuda.get_device_name``'s string for a card, the device type
    (``"cpu"``, a kind no table row has) for any other device; ``None``
    when no device is given and CUDA is not available."""
    import torch  # noqa: PLC0415

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return device.type
    elif not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def _chip_lookup(table: dict, kind: Optional[str]):
    if kind is None:
        kind = device_kind()
    return table.get(kind) if kind is not None else None


def chip_peak_flops(kind: Optional[str] = None) -> Optional[float]:
    """Peak FLOP/s of ``kind`` (default: the process's card); None for any
    other kind, the CPU above all."""
    return _chip_lookup(CHIP_PEAK_FLOPS, kind)


def chip_hbm_bytes(kind: Optional[str] = None) -> Optional[int]:
    """Device memory of ``kind`` (default: the process's card); None for
    any other kind: the memory check then declines to guess rather than
    refuse a run on a made-up budget."""
    return _chip_lookup(CHIP_HBM_BYTES, kind)


# -- one step's FLOPs and bytes ----------------------------------------------------


def _valid_taps(size: int, kernel: int, stride: int, pad: int, dilation: int,
                out: int) -> int:
    """(output position, kernel tap) pairs of one spatial dimension whose
    input index ``o·stride - pad + k·dilation`` lies in ``[0, size)``."""
    return sum(1 for o in range(out) for k in range(kernel)
               if 0 <= o * stride - pad + k * dilation < size)


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation) -> int:
    """FLOPs of a (not transposed) convolution counted over its valid taps,
    as XLA counts them: ``2 · N · C_out · C_in/groups · Π_d valid_d`` with
    ``valid_d`` the (output, tap) pairs of dimension d inside the input.
    ``w_shape`` is ``[C_out, C_in/groups, *kernel]``, so groups need no
    term of their own."""
    n, c_out, c_in_g = x_shape[0], w_shape[0], w_shape[1]
    spatial = len(w_shape) - 2

    def per_dim(v, d):
        v = list(v) if isinstance(v, (list, tuple)) else [v]
        return int(v[d] if len(v) > 1 else v[0])

    taps = 1
    for d in range(spatial):
        taps *= _valid_taps(int(x_shape[2 + d]), int(w_shape[2 + d]), per_dim(stride, d),
                            per_dim(padding, d), per_dim(dilation, d), int(out_shape[2 + d]))
    return 2 * int(n) * int(c_out) * int(c_in_g) * taps


def _conv_formula(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
                  out_shape=None, **kwargs) -> int:
    if transposed:
        from torch.utils import flop_counter  # noqa: PLC0415

        return flop_counter.conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation)


def _conv_backward_formula(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                           transposed, _output_padding, _groups, output_mask, out_shape,
                           **kwargs) -> int:
    """The input gradient and the weight gradient each visit every valid
    tap of the forward once (XLA counts each as the forward)."""
    if transposed:
        from torch.utils import flop_counter  # noqa: PLC0415

        return flop_counter.conv_backward_flop(
            grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation, transposed,
            _output_padding, _groups, output_mask, out_shape)
    fwd = conv_flops(x_shape, w_shape, grad_out_shape, stride, padding, dilation)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _formulas() -> dict:
    """``FlopCounterMode``'s formula table (``torch.utils.flop_counter``:
    FLOPs of an op from its argument and result shapes), with the
    convolutions' valid-tap formulas in place of its dense ones."""
    import torch  # noqa: PLC0415
    from torch.utils import flop_counter  # noqa: PLC0415

    aten = torch.ops.aten
    table = dict(flop_counter.flop_registry)
    for op, formula in ((aten.convolution, _conv_formula), (aten._convolution, _conv_formula),
                        (aten.convolution_backward, _conv_backward_formula)):
        table[op] = flop_counter.shape_wrapper(formula)
    return table


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in an op's arguments or results (tensors,
    and lists, tuples and dicts of them)."""
    import torch  # noqa: PLC0415

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


def _count_mode():
    """One dispatch mode over every aten op of the step: its FLOPs by
    :func:`_formulas` (what ``FlopCounterMode`` counts for the op, with
    the valid-tap convolutions) and, unless the op is a view, the bytes of
    its tensor inputs and outputs. A mode of its own rather than
    ``FlopCounterMode`` beside a byte-counting mode: torch wraps a dispatch
    mode's handler to import ``torch._dynamo`` at its first call (seconds,
    in the first step of every process) unless the mode opts out, and one
    mode passes each op through Python once. Ops that ``FlopCounterMode`` would decompose
    (none on the port's paths) count nothing here."""
    from torch.utils._python_dispatch import TorchDispatchMode  # noqa: PLC0415

    class Count(TorchDispatchMode):
        @classmethod
        def _should_skip_dynamo(cls) -> bool:
            return False

        def __init__(self):
            super().__init__()
            self.formulas = _formulas()
            self.in_stage = False
            # [outside, inside] a pipeline stage's schedule
            self.flops = [0, 0]
            self.nbytes = [0, 0]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = self.formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops[self.in_stage] += formula(*args, **kwargs, out_val=out)
            if not getattr(func, "is_view", False):
                self.nbytes[self.in_stage] += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                                               + _tensor_bytes(out))
            return out

    return Count()


_ACTIVE = None  # the counting mode of the step counted now (one a process)


def count_kernel(flops: int, *tensors) -> None:
    """Book a kernel's FLOPs and the bytes of ``tensors`` (its inputs and
    outputs) to the step being counted; nothing when none is."""
    count = _ACTIVE
    if count is not None:
        count.flops[count.in_stage] += int(flops)
        count.nbytes[count.in_stage] += _tensor_bytes(tensors)


def stage_region(inside: bool) -> None:
    """Mark where a pipeline stage's schedule starts (``inside``) and ends,
    in the forward and again in the backward (``parallel/pipeline.py``
    calls it): the work counted in between is the stage's own, the rest is
    the same on every stage of the pipe group (:func:`step_cost`). Nothing
    when no step is counted."""
    if _ACTIVE is not None:
        _ACTIVE.in_stage = bool(inside)


@contextlib.contextmanager
def hidden():
    """While a step is counted, hide the ops run inside from the count (a
    kernel's plain twin, whose work :func:`count_kernel` books instead);
    nothing otherwise."""
    if _ACTIVE is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes  # noqa: PLC0415

    with _disable_current_modes():
        yield


def step_cost(fn, *args, world: int = 1, pp: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` once while counting its work; returns
    ``(what fn returned, {"flops_per_step", "bytes_per_step"})``, the
    counts multiplied by ``world`` (the step's total across ranks), but
    for the work outside a pipeline stage's schedule, which the ``pp``
    stages of a pipe group share and which is multiplied by ``world /
    pp``. A count that comes to 0 is None, as the JAX function reports a
    missing one."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("step_cost: a step is already being counted")
    mode = _count_mode()
    _ACTIVE = mode
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE = None
    if int(world) % int(pp):
        raise ValueError(f"a world of {world} ranks does not divide over pp={pp}")
    share = int(world) // int(pp)
    flops = mode.flops[0] * share + mode.flops[1] * int(world)
    nbytes = mode.nbytes[0] * share + mode.nbytes[1] * int(world)
    return out, {"flops_per_step": float(flops) if flops > 0 else None,
                 "bytes_per_step": float(nbytes) if nbytes > 0 else None}


# -- efficiency ---------------------------------------------------------------------


def mfu(
    flops_per_step: Optional[float],
    step_seconds: float,
    n_devices: int,
    peak: Optional[float] = None,
) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over aggregate chip peak.
    ``peak`` overrides the per-chip table lookup (tests, exotic parts)."""
    if peak is None:
        peak = chip_peak_flops()
    if flops_per_step is None or peak is None or step_seconds <= 0:
        return None
    return round(flops_per_step / step_seconds / (peak * n_devices), 4)


def device_memory_stats(device=None) -> Optional[dict]:
    """The allocator's counters of one card (default: the current one):
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``), ``bytes_limit``
    (the card's total memory) and ``mem_devices_reporting`` 1. A process
    drives one card, so the JAX function's worst-chip scalars are this
    card's and it has no ``*_min``/skew keys. None on the CPU."""
    import torch  # noqa: PLC0415

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
        "mem_devices_reporting": 1,
    }


def _sig(v: float, digits: int = 4) -> float:
    """Round to significant digits — calibration rates span 1e3..1e15."""
    return float(f"{v:.{digits}g}")


def calibration(
    cost: Optional[dict],
    analysis: Optional[dict],
    *,
    steps: Optional[int] = None,
    n_devices: int = 1,
    peak: Optional[float] = None,
) -> dict:
    """Calibrate the static cost model against a measured capture: divide
    the xprof attribution's measured category seconds into the predicted
    per-step FLOPs/bytes (``step_cost``) and return achieved-rate /
    drift gauges, keyed by their registry names:

    * ``cost.calibration_flops_per_s`` — AGGREGATE achieved FLOP/s over
      the capture's COMPUTE seconds only (matmul/conv + fusion).
    * ``cost.calibration_compute_frac`` — that rate over the AGGREGATE
      chip peak (``peak × n_devices``, :func:`mfu`'s denominator);
      omitted on unknown chips.
    * ``cost.calibration_bytes_per_s`` — aggregate achieved bytes/s:
      the cost model's per-step byte count over measured busy seconds.
    * ``cost.calibration_collective_frac`` / ``_overlap_frac`` — the
      capture's collective share of device busy time and comm/compute
      overlap fraction.
    * ``cost.calibration_steps`` — steps the capture covered.

    ``analysis`` is the compact xprof record; ``steps`` the step count
    the capture covered (rate gauges need it; the fraction gauges work
    without). Returns {} when nothing is computable."""
    out: dict = {}
    if not analysis:
        return out
    cf = analysis.get("collective_frac")
    if isinstance(cf, (int, float)):
        out["cost.calibration_collective_frac"] = cf
    ov = analysis.get("overlap_frac")
    if ov is None and isinstance(analysis.get("overlap"), dict):
        ov = analysis["overlap"].get("overlap_frac")
    if isinstance(ov, (int, float)):
        out["cost.calibration_overlap_frac"] = ov
    busy = analysis.get("device_busy_s")
    cats = analysis.get("categories") or {}
    if not steps or not isinstance(busy, (int, float)) or busy <= 0:
        return out
    out["cost.calibration_steps"] = int(steps)
    n_devices = max(int(n_devices), 1)
    cost = cost or {}
    # measured seconds are summed across the capture's devices, and
    # flops_per_step is the step's aggregate count (the mfu convention)
    compute_s = (
        float(cats.get("matmul_conv", 0.0)) + float(cats.get("fusion_other", 0.0))
    )
    flops = cost.get("flops_per_step")
    if isinstance(flops, (int, float)) and flops > 0 and compute_s > 0:
        achieved = flops / (compute_s / steps / n_devices)
        out["cost.calibration_flops_per_s"] = _sig(achieved)
        if peak is None:
            peak = chip_peak_flops()
        if peak:
            out["cost.calibration_compute_frac"] = round(
                achieved / (peak * n_devices), 4
            )
    byts = cost.get("bytes_per_step")
    if isinstance(byts, (int, float)) and byts > 0:
        out["cost.calibration_bytes_per_s"] = _sig(
            byts / (busy / steps / n_devices)
        )
    return out


def publish_calibration(gauges: dict) -> None:
    """Stamp :func:`calibration`'s gauges into the telemetry registry."""
    for name, v in gauges.items():
        counters_lib.set_gauge(name, v)


def predicted_step_time(
    cost: Optional[dict],
    *,
    wire_bytes: Optional[int] = None,
    n_devices: int = 1,
    gauges: Optional[dict] = None,
    peak: Optional[float] = None,
) -> dict:
    """Static step-time prediction, corrected by the latest measured
    ``cost.calibration_*`` gauges. Compute time is the step's FLOPs over
    the achieved FLOP/s of the last calibrated capture (the chip's peak
    when none exists — ``rate_source`` says which); memory time is the
    byte count over the achieved bytes/s; communication time is the wire
    bytes over the same rate. Compute and memory overlap (``max``);
    communication hides behind compute by the measured ``overlap_frac``.
    Returns ``{}`` when there is nothing to price."""
    gauges = gauges if gauges is not None else counters_lib.snapshot()
    cost = cost or {}
    flops = cost.get("flops_per_step")
    byts = cost.get("bytes_per_step")
    flops_rate = gauges.get("cost.calibration_flops_per_s")
    bytes_rate = gauges.get("cost.calibration_bytes_per_s")
    overlap = gauges.get("cost.calibration_overlap_frac") or 0.0
    source = "calibrated"
    if not isinstance(flops_rate, (int, float)) or flops_rate <= 0:
        if peak is None:
            peak = chip_peak_flops()
        flops_rate = peak * n_devices if peak else None
        source = "spec_peak"
    out: dict = {}
    t_compute = (
        flops / flops_rate
        if isinstance(flops, (int, float)) and flops > 0 and flops_rate
        else None
    )
    t_mem = (
        byts / bytes_rate
        if isinstance(byts, (int, float)) and byts > 0
        and isinstance(bytes_rate, (int, float)) and bytes_rate > 0
        else None
    )
    t_comm = (
        wire_bytes / bytes_rate
        if isinstance(wire_bytes, (int, float)) and wire_bytes > 0
        and isinstance(bytes_rate, (int, float)) and bytes_rate > 0
        else None
    )
    if t_compute is None and t_mem is None:
        return out
    busy = max(t for t in (t_compute, t_mem) if t is not None)
    exposed_comm = (t_comm or 0.0) * (1.0 - min(max(overlap, 0.0), 1.0))
    out = {
        "predicted_step_s": _sig(busy + exposed_comm),
        "compute_s": _sig(t_compute) if t_compute is not None else None,
        "memory_s": _sig(t_mem) if t_mem is not None else None,
        "comm_s": _sig(t_comm) if t_comm is not None else None,
        "overlap_frac_applied": round(float(overlap), 4),
        "rate_source": source,
    }
    return out


def planner_error_frac(
    predicted_s: Optional[float], achieved_s: Optional[float],
) -> Optional[float]:
    """``|predicted - achieved| / achieved`` of one step's time: how far
    the priced step time sits from the measured one (``plan`` records;
    ``obs compare`` gates it, lower is better). None when either side is
    missing or non-positive."""
    if (
        not isinstance(predicted_s, (int, float)) or predicted_s <= 0
        or not isinstance(achieved_s, (int, float)) or achieved_s <= 0
    ):
        return None
    return round(abs(float(predicted_s) - float(achieved_s)) / float(achieved_s), 4)


def publish(cost: Optional[dict]) -> None:
    """Stamp a step-cost dict into the telemetry gauges
    (``device.flops_per_step`` / ``device.bytes_per_step``)."""
    if not cost:
        return
    for key, gauge in (
        ("flops_per_step", "device.flops_per_step"),
        ("bytes_per_step", "device.bytes_per_step"),
    ):
        v = cost.get(key)
        if v is not None:
            counters_lib.set_gauge(gauge, v)
