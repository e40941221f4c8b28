"""The port's capture reader (``tpu_dist_torch/obs/xprof.py``) on
Kineto-shaped Chrome traces, held against the JAX package's
(``tpu_dist/obs/xprof.py``) on the same timings in its own event shape.

Kineto writes the card's activity on the GPU's process (pid = device
index), one thread a CUDA stream, with ``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset`` and ``gpu_user_annotation``; the host's
``cpu_op`` and ``cuda_runtime`` events on the process's own pid. The
traces here are built by hand in that shape: two streams, a
``gpu_user_annotation`` wrapper over a stream's kernels, an NCCL kernel
overlapping a gemm, a host-to-device copy, and the host's events beside.
Held: the classification table, the invariant that the category seconds
sum to ``device_busy_s``, the overlap, the typed errors and partial
reports, the ``obs xprof`` exit codes, and equality with the JAX reader's
numbers. Every time is an exact multiple of a microsecond and the sums are
of a few terms, so equality is to 1e-12 s.
"""

import gzip
import json
import os

import pytest
import torch_ranks  # noqa: F401  (one torch thread in this process)

from tpu_dist.obs import xprof as jax_xprof
from tpu_dist.obs.__main__ import main as jax_obs
from tpu_dist_torch.obs import counters, profile, xprof
from tpu_dist_torch.obs.__main__ import main as obs

GPU_PID, HOST_PID = 0, 4242
COMPUTE, COMM = 7, 13  # CUDA streams


@pytest.fixture(autouse=True)
def _clean():
    counters.reset()
    yield
    counters.reset()


def _meta():
    return [
        {"ph": "M", "pid": GPU_PID, "tid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
        {"ph": "M", "pid": HOST_PID, "tid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": GPU_PID, "tid": COMPUTE, "name": "thread_name",
         "args": {"name": f"stream {COMPUTE}"}},
        {"ph": "M", "pid": GPU_PID, "tid": COMM, "name": "thread_name",
         "args": {"name": f"stream {COMM}"}},
    ]


def _k(name, ts, dur, tid=COMPUTE, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU_PID, "tid": tid, "ts": ts,
            "dur": dur, "args": {"device": 0, "stream": tid}}


def _h(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": HOST_PID, "tid": HOST_PID, "ts": ts,
            "dur": dur}


GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)"
SGD = "void fused_sgd_kernel<4>(FusedSgdTable, float, float, float)"
ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
               "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int, ...)")


def _step_events(t0=1_000_000.0):
    """One training step's worth: the conv and gemm on the compute stream
    under a ``gpu_user_annotation`` ``train_step`` range, the NCCL
    all-reduce on its own stream overlapping the gemm by 40 us, a
    host-to-device copy, a memset, the fused SGD kernel, and the host's
    ``cpu_op``/``cuda_runtime``/annotation events."""
    return [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step", "pid": GPU_PID,
         "tid": COMPUTE, "ts": t0, "dur": 400},
        _k("Memcpy HtoD (Pinned -> Device)", t0, 10, cat="gpu_memcpy"),
        _k("Memset (Device)", t0 + 10, 5, cat="gpu_memset"),
        _k(CONV, t0 + 20, 100),
        _k(GEMM, t0 + 120, 80),
        _k(NCCL, t0 + 160, 60, tid=COMM),
        _k(ELEMENTWISE, t0 + 230, 20),
        _k(SGD, t0 + 260, 30),
        _k("Memcpy DtoH (Device -> Pageable)", t0 + 300, 4, cat="gpu_memcpy"),
        _k("Memcpy DtoD (Device -> Device)", t0 + 310, 6, cat="gpu_memcpy"),
        _h("aten::convolution", t0 - 50, 30),
        _h("cudaLaunchKernel", t0 - 40, 5, cat="cuda_runtime"),
        _h("train_step", t0 - 60, 500, cat="user_annotation"),
    ]


# the same device timings in the JAX reader's shape: one /device:* process,
# its stream threads not named "XLA Ops" (so every thread counts), HLO names
JAX_NAME = {"Memcpy HtoD (Pinned -> Device)": "infeed.1", "Memset (Device)": "fusion.2",
            CONV: "convolution.3", GEMM: "dot.4", NCCL: "all-reduce.5",
            ELEMENTWISE: "add.6", SGD: "fusion.7",
            "Memcpy DtoH (Device -> Pageable)": "outfeed.8",
            "Memcpy DtoD (Device -> Device)": "copy.9"}


def _as_jax(events):
    out = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:GPU:0"}},
           {"ph": "M", "pid": 1, "tid": COMPUTE, "name": "thread_name",
            "args": {"name": "Stream #7"}},
           {"ph": "M", "pid": 1, "tid": COMM, "name": "thread_name",
            "args": {"name": "Stream #13"}}]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in xprof.DEVICE_CATS:
            out.append({"ph": "X", "pid": 1, "tid": e["tid"], "name": JAX_NAME[e["name"]],
                        "ts": e["ts"], "dur": e["dur"]})
    return out


def _write(root, events, name="rank0.trace.json.gz"):
    os.makedirs(root, exist_ok=True)
    path = os.path.join(str(root), name)
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return path


CLASSES = [
    (NCCL, "kernel", "collective", "all-reduce"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", "kernel",
     "collective", "all-gather"),
    ("ncclKernel_ReduceScatter_RING_LL_Sum_float(...)", "kernel", "collective",
     "reduce-scatter"),
    ("ncclDevKernel_Broadcast_RING_LL(...)", "kernel", "collective", "collective-broadcast"),
    ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)", "kernel", "collective",
     "send"),
    (GEMM, "kernel", "matmul_conv", None),
    (CONV, "kernel", "matmul_conv", None),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel",
     "matmul_conv", None),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32_tf32f32_f32_nhwckrsc_nhwc", "kernel",
     "matmul_conv", None),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_16x3_nn_align4>(...)",
     "kernel", "matmul_conv", None),
    ("ampere_sgemm_64x32_sliced1x4_nn", "kernel", "matmul_conv", None),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4<float, float>(...)", "kernel",
     "matmul_conv", None),
    ("void cudnn::detail::implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1>(...)",
     "kernel", "matmul_conv", None),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1>(...)", "kernel",
     "fusion_other", None),
    ("void flash_fwd_mma_kernel<64, __nv_bfloat16>(FlashParams)", "kernel", "matmul_conv",
     None),
    ("void flash_fwd_kernel<64, float>(FlashParams)", "kernel", "matmul_conv", None),
    ("void dkdv_mma_kernel<64, __nv_bfloat16>(BwdParams)", "kernel", "matmul_conv", None),
    ("void dq_mma_kernel<64, __nv_bfloat16>(BwdParams)", "kernel", "matmul_conv", None),
    (SGD, "kernel", "fusion_other", None),
    (ELEMENTWISE, "kernel", "fusion_other", None),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()"
     "() const::{lambda(float)#1}, ...> convert", "kernel", "fusion_other", None),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "infeed_outfeed", None),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", "infeed_outfeed", None),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "fusion_other", None),
    ("Memset (Device)", "gpu_memset", "fusion_other", None),
    ("aten::addmm", "cpu_op", "matmul_conv", None),
    ("aten::convolution_backward", "cpu_op", "matmul_conv", None),
    ("aten::mkldnn_convolution", "cpu_op", "matmul_conv", None),
    ("aten::add_", "cpu_op", "fusion_other", None),
    ("aten::_to_copy", "cpu_op", "fusion_other", None),
    ("c10d::allreduce_", "cpu_op", "collective", "all-reduce"),
    ("c10d::_allgather_base_", "cpu_op", "collective", "all-gather"),
    ("c10d::_reduce_scatter_base_", "cpu_op", "collective", "reduce-scatter"),
]


@pytest.mark.parametrize("name,cat,category,kind", CLASSES,
                         ids=[f"{c[2]}-{i}" for i, c in enumerate(CLASSES)])
def test_the_classification_table(name, cat, category, kind):
    assert xprof.classify(name, cat) == category
    assert xprof.collective_kind(name) == kind
    assert kind is None or kind in jax_xprof.COLLECTIVE_KINDS


def test_the_report_keeps_the_jax_shape_and_categories():
    assert xprof.CATEGORIES == jax_xprof.CATEGORIES
    assert xprof.COLLECTIVE_KINDS == jax_xprof.COLLECTIVE_KINDS
    for cls in ("CaptureError", "EmptyCaptureError", "MalformedTraceError",
                "NoDeviceTrackError"):
        assert getattr(xprof, cls).kind == getattr(jax_xprof, cls).kind
    r = xprof.analyze_events(_meta() + _step_events())
    j = jax_xprof.analyze_events(_as_jax(_step_events()))
    assert set(r) - {"_op_cat"} == set(j)


def test_categories_sum_to_busy_with_the_annotation_never_counted(tmp_path):
    _write(tmp_path, _meta() + _step_events())
    r = xprof.analyze_capture(str(tmp_path))
    us = 1e-6
    # the annotation's 400 us never count; the host's events never count
    assert r["categories"] == pytest.approx({
        "matmul_conv": 180 * us, "collective": 60 * us, "infeed_outfeed": 14 * us,
        "fusion_other": (5 + 20 + 30 + 6) * us, "host": 0.0}, abs=1e-12)
    assert sum(r["categories"].values()) == pytest.approx(r["device_busy_s"], abs=1e-12)
    assert r["device_busy_s"] == pytest.approx(315 * us, abs=1e-12)
    assert r["infeed_stall_s"] == pytest.approx(10 * us, abs=1e-12)
    assert r["collectives"] == {"all-reduce": pytest.approx(60 * us, abs=1e-12)}
    # the NCCL kernel [160, 220) overlaps the gemm [120, 200) by 40 us
    assert r["overlap"]["overlap_frac"] == pytest.approx(40 / 60, abs=1e-4)
    assert r["traces"][0]["op_threads"] == 2
    top = {o["name"]: o for o in r["top_ops"]}
    assert top[SGD]["category"] == "fusion_other" and top[SGD]["count"] == 1


def test_the_same_timings_give_the_jax_readers_numbers(tmp_path):
    steps = []
    for i in range(3):
        steps += _step_events(t0=1_000_000.0 + 1000 * i)
    _write(tmp_path / "port", _meta() + steps)
    ours = xprof.analyze_capture(str(tmp_path / "port"))
    jax_dir = tmp_path / "jax" / "plugins" / "profile" / "run1"
    _write(jax_dir, _as_jax(steps), name="host0.trace.json.gz")
    theirs = jax_xprof.analyze_capture(str(tmp_path / "jax"))
    for key in ("device_busy_s", "infeed_stall_s", "collective_frac"):
        assert ours[key] == pytest.approx(theirs[key], abs=1e-12), key
    assert ours["categories"] == pytest.approx(theirs["categories"], abs=1e-12)
    assert ours["collectives"] == pytest.approx(theirs["collectives"], abs=1e-12)
    assert ours["overlap"] == pytest.approx(theirs["overlap"], abs=1e-12)
    assert [o["self_s"] for o in ours["top_ops"]] == [o["self_s"] for o in theirs["top_ops"]]
    assert xprof.compact(ours).keys() == jax_xprof.compact(theirs).keys()
    assert xprof.summary_line(ours) == jax_xprof.summary_line(theirs)


def test_overlapping_kernels_on_one_stream_count_once(tmp_path):
    """Hopper lets a kernel start before the previous one on its stream
    ends (cuDNN's wgrad kernels do): each kernel is charged its time not
    covered by earlier ones, so busy is the stream's interval union, and
    a kernel inside another's span adds nothing."""
    _write(tmp_path, _meta() + [_k(CONV, 0, 100), _k(CONV, 90, 60), _k(SGD, 140, 30),
                                _k(ELEMENTWISE, 200, 10), _k(SGD, 202, 5)])
    r = xprof.analyze_capture(str(tmp_path))
    us = 1e-6
    assert r["device_busy_s"] == pytest.approx((170 + 10) * us, abs=1e-12)
    assert r["categories"]["matmul_conv"] == pytest.approx(150 * us, abs=1e-12)
    assert r["categories"]["fusion_other"] == pytest.approx(30 * us, abs=1e-12)


def test_serialized_comm_has_zero_overlap_and_no_comm_none(tmp_path):
    _write(tmp_path / "a", _meta() + [_k(NCCL, 0, 100), _k(GEMM, 100, 100)])
    r = xprof.analyze_capture(str(tmp_path / "a"))
    assert r["overlap"]["overlap_frac"] == 0.0
    _write(tmp_path / "b", _meta() + [_k(GEMM, 0, 100)])
    r = xprof.analyze_capture(str(tmp_path / "b"))
    assert r["overlap"]["overlap_frac"] is None and r["collective_frac"] == 0.0


def test_a_cpu_trace_is_read_by_its_aten_and_c10d_operators(tmp_path):
    evs = [
        _h("train_step", 0, 1000, cat="user_annotation"),
        _h("autograd::engine::evaluate_function: AddmmBackward0", 0, 500),
        _h("AddmmBackward0", 0, 500),
        _h("aten::linear", 10, 200),
        _h("aten::addmm", 20, 150),           # nested: the linear keeps 50 of self time
        _h("_SumAcrossRanks", 300, 150),
        _h("c10d::allreduce_", 310, 100),
        _h("aten::add_", 600, 40),
    ]
    _write(tmp_path, evs)
    r = xprof.analyze_capture(str(tmp_path))
    us = 1e-6
    assert r["categories"]["matmul_conv"] == pytest.approx(200 * us, abs=1e-12)
    assert r["categories"]["collective"] == pytest.approx(100 * us, abs=1e-12)
    assert r["categories"]["fusion_other"] == pytest.approx(40 * us, abs=1e-12)
    assert r["overlap"]["overlap_frac"] == 0.0  # one thread: nothing hides the reduce


def test_a_real_cpu_profiler_capture_reads_back(tmp_path):
    import torch  # noqa: PLC0415

    m = torch.nn.Linear(8, 8)
    profile.start_trace(str(tmp_path))
    with profile.annotate_step(0):
        m(torch.randn(4, 8)).sum().backward()
    path = profile.stop_trace()
    assert path == os.path.join(str(tmp_path), "rank0.trace.json.gz")
    assert xprof.find_traces(str(tmp_path)) == jax_xprof.find_traces(str(tmp_path)) == [path]
    r = xprof.analyze_capture(str(tmp_path))
    assert r["device_busy_s"] > 0 and r["categories"]["matmul_conv"] > 0
    assert sum(r["categories"].values()) == pytest.approx(r["device_busy_s"], abs=1e-9)


def test_torn_truncated_and_trackless_files_are_typed_and_partial(tmp_path):
    cap = tmp_path / "cap"
    good = _write(cap, _meta() + _step_events(), name="rank0.trace.json.gz")
    with open(good, "rb") as f:
        blob = f.read()
    with open(cap / "rank1.trace.json.gz", "wb") as f:
        f.write(blob[: len(blob) // 2])                      # truncated gzip
    with gzip.open(cap / "rank2.trace.json.gz", "wt") as f:
        f.write('{"traceEvents": [{"ph": "X", "name": "k"')   # torn JSON
    _write(cap, [_h("cudaLaunchKernel", 0, 5, cat="cuda_runtime")],
           name="rank3.trace.json.gz")                        # no track
    r = xprof.analyze_capture(str(cap))
    assert r["analyzed"] == 1 and r["n_traces"] == 4
    assert r["dropped"] == {"malformed_trace": 2, "no_device_track": 1}
    assert [e["kind"] for e in r["errors"]] == [
        "malformed_trace", "malformed_trace", "no_device_track"]
    for name, err in (("rank1.trace.json.gz", xprof.MalformedTraceError),
                      ("rank2.trace.json.gz", xprof.MalformedTraceError),
                      ("rank3.trace.json.gz", xprof.NoDeviceTrackError)):
        with pytest.raises(err):
            xprof.analyze_trace_file(str(cap / name))
    only_bad = tmp_path / "bad"
    _write(only_bad, [_h("cudaLaunchKernel", 0, 5, cat="cuda_runtime")])
    with pytest.raises(xprof.NoDeviceTrackError):
        xprof.analyze_capture(str(only_bad))
    (tmp_path / "empty").mkdir()
    with pytest.raises(xprof.EmptyCaptureError):
        xprof.analyze_capture(str(tmp_path / "empty"))
    # the in-process hook never raises: it counts
    assert profile.analyze_capture_quietly(str(tmp_path / "empty"))[0] is None
    rec, err = profile.analyze_capture_quietly(str(cap))
    assert err is None and rec["dropped"] == r["dropped"]
    assert counters.get("xprof.analyze_errors") == 1
    assert counters.get("xprof.dropped_traces") == 3 and counters.get("xprof.analyses") == 1


def test_obs_xprof_exit_codes_equal_the_jax_cli(tmp_path, capsys):
    _write(tmp_path / "cap", _meta() + _step_events())
    (tmp_path / "empty").mkdir()
    assert obs(["xprof", str(tmp_path / "cap"), "--format", "json", "--top", "50"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert any(o["name"] == SGD and o["count"] == 1 for o in rep["top_ops"])
    assert obs(["xprof", str(tmp_path / "cap")]) == 0
    text = capsys.readouterr().out
    assert "device busy" in text and "all-reduce" in text
    # one trace file; an empty capture; a missing path
    cases = [xprof.find_traces(str(tmp_path / "cap"))[0], str(tmp_path / "empty"),
             str(tmp_path / "missing")]
    codes = [obs(["xprof", c]) for c in cases]
    capsys.readouterr()
    assert codes == [0, 1, 2]
    # the JAX CLI's codes on the same kinds of input (its own trace shape)
    jax_cap = tmp_path / "jax" / "plugins" / "profile" / "r"
    _write(jax_cap, _as_jax(_step_events()), name="h.trace.json.gz")
    jax_codes = [jax_obs(["xprof", c]) for c in (
        jax_xprof.find_traces(str(tmp_path / "jax"))[0], str(tmp_path / "empty"),
        str(tmp_path / "missing"))]
    capsys.readouterr()
    assert codes == jax_codes
