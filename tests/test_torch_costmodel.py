"""The port's cost model (``tpu_dist_torch/obs/costmodel.py``) held against
the JAX package's (``tpu_dist/obs/costmodel.py``).

* The efficiency arithmetic: ``mfu``, ``calibration``,
  ``predicted_step_time`` and ``planner_error_frac`` give JAX's results bit
  for bit on the same seeded dicts, with the chip's peak given and with
  none (the CPU: both tables have no row for it).
* The chip tables: the card's full name matches its row, any other name
  (an H100 PCIe) and the CPU give None; no allocator stats on the CPU.
* The valid-tap convolution count equals XLA's cost analysis exactly: a
  3x3 "SAME" convolution over 1x4x4x64 counts 819,200 FLOPs (of a dense
  1,179,648), and so do strided, 1x1 and batched cases, forward and the
  input and weight gradients.
* The flash attention's formula equals the count of the plain attention
  chain, forward and backward, at three shapes (one causal, one ragged).
* The full-width ResNet-18 step (CIFAR stem, 100 classes, batch 8) counts
  within 1% of XLA's count of the JAX ResNet-18's gradient, and its bytes
  sit in a pinned band above XLA's (the port counts before fusion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_ranks  # noqa: F401  (one torch thread in this process)
from torch.utils.flop_counter import FlopCounterMode

from tpu_dist.nn.resnet import resnet18 as jax_resnet18
from tpu_dist.obs import costmodel as jax_costmodel
from tpu_dist_torch.nn import resnet
from tpu_dist_torch.nn.attention import full_attention
from tpu_dist_torch.obs import costmodel
from tpu_dist_torch.ops.flash_attention import attention_flops
from tpu_dist_torch.train import optim, state, step

H100 = "NVIDIA H100 80GB HBM3"
PEAK = 989.4e12


def _dicts(seed: int):
    """A step cost, a capture's analysis and calibration gauges, seeded."""
    rng = np.random.default_rng(seed)
    cost = {"flops_per_step": float(rng.uniform(1e9, 1e13)),
            "bytes_per_step": float(rng.uniform(1e8, 1e11))}
    cats = {k: float(rng.uniform(0, 0.05)) for k in
            ("matmul_conv", "fusion_other", "collective", "infeed_outfeed", "other")}
    analysis = {"device_busy_s": sum(cats.values()), "categories": cats,
                "collective_frac": float(rng.uniform(0, 0.3)),
                "overlap": {"overlap_frac": float(rng.uniform(0, 1))}}
    gauges = {"cost.calibration_flops_per_s": float(rng.uniform(1e12, 5e14)),
              "cost.calibration_bytes_per_s": float(rng.uniform(1e11, 3e12)),
              "cost.calibration_overlap_frac": float(rng.uniform(0, 1))}
    return cost, analysis, gauges, int(rng.integers(1, 9)), float(rng.uniform(1e-3, 1.0))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("peak", [PEAK, None], ids=["h100", "no_chip"])
def test_the_efficiency_arithmetic_is_jaxs_bit_for_bit(seed, peak):
    cost, analysis, gauges, n, step_s = _dicts(seed)
    assert (costmodel.mfu(cost["flops_per_step"], step_s, n, peak=peak)
            == jax_costmodel.mfu(cost["flops_per_step"], step_s, n, peak=peak))
    for steps in (None, 3):
        assert (costmodel.calibration(cost, analysis, steps=steps, n_devices=n, peak=peak)
                == jax_costmodel.calibration(cost, analysis, steps=steps, n_devices=n, peak=peak))
    for g in (gauges, {}):
        for wire in (None, 4e8):
            assert (costmodel.predicted_step_time(cost, wire_bytes=wire, n_devices=n, gauges=g,
                                                  peak=peak)
                    == jax_costmodel.predicted_step_time(cost, wire_bytes=wire, n_devices=n,
                                                         gauges=g, peak=peak))
    for pred, got in ((step_s, step_s * 1.3), (None, 1.0), (0.5, 0.0), (2.0, 0.25)):
        assert (costmodel.planner_error_frac(pred, got)
                == jax_costmodel.planner_error_frac(pred, got))
    # on this CPU both packages find no chip: no MFU rather than a made-up one
    assert costmodel.mfu(1e12, 0.1, 1) is None and jax_costmodel.mfu(1e12, 0.1, 1) is None


def test_the_chip_tables_have_one_row_matched_by_the_full_name():
    assert costmodel.chip_peak_flops(H100) == PEAK
    assert costmodel.chip_hbm_bytes(H100) == costmodel.CHIP_HBM_BYTES[H100] > 80 * 10 ** 9
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100", "cpu"):
        assert costmodel.chip_peak_flops(other) is None
        assert costmodel.chip_hbm_bytes(other) is None
    assert costmodel.device_kind("cpu") == "cpu"
    assert costmodel.chip_peak_flops() is None and costmodel.chip_hbm_bytes() is None
    assert costmodel.device_memory_stats("cpu") is None


# (N, H, W, C_in, C_out, kernel, stride, padding): XLA's "SAME" for the first
CONVS = [(1, 4, 4, 64, 64, 3, 1, 1), (1, 8, 8, 16, 32, 3, 2, 1), (1, 8, 8, 16, 32, 1, 2, 0),
         (2, 32, 32, 3, 64, 3, 1, 1), (1, 7, 7, 8, 8, 3, 2, 1)]


def _xla_conv_flops(n, h, w, c, o, k, s, p, grad=None):
    x, wt = jnp.zeros((n, h, w, c)), jnp.zeros((k, k, c, o))
    pad = "SAME" if (s, p) == (1, k // 2) else ((p, p), (p, p))

    def conv(x, wt):
        return jax.lax.conv_general_dilated(x, wt, (s, s), pad,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    fn = conv if grad is None else jax.grad(lambda x, wt: conv(x, wt).sum(), argnums=grad)
    return jax_costmodel.analyze_jitted(jax.jit(fn), x, wt)["flops_per_step"]


@pytest.mark.parametrize("case", CONVS, ids=[str(c) for c in CONVS])
def test_a_convolution_counts_its_valid_taps_as_xla_does(case):
    n, h, w, c, o, k, s, p = case
    x = torch.zeros(n, c, h, w, requires_grad=True)
    wt = torch.zeros(o, c, k, k, requires_grad=True)
    _, fwd = costmodel.step_cost(F.conv2d, x, wt, stride=s, padding=p)
    # an exact count: XLA's HloCostAnalysis over the same convolution
    assert fwd["flops_per_step"] == _xla_conv_flops(*case)
    if case == CONVS[0]:
        assert fwd["flops_per_step"] == 819_200  # of a dense 2·64·64·9·16 = 1,179,648

    def backward():
        F.conv2d(x, wt, stride=s, padding=p).sum().backward()

    _, both = costmodel.step_cost(backward)
    # the forward, then the input and the weight gradient: each of the two
    # gradients counts what XLA counts for it alone
    assert both["flops_per_step"] == (fwd["flops_per_step"] + _xla_conv_flops(*case, grad=0)
                                      + _xla_conv_flops(*case, grad=1))


def test_the_count_is_flop_counter_modes_with_the_valid_tap_convolutions():
    model = resnet.ResNet("basic", (1, 1, 1, 1), 10, widths=(8, 16, 32, 64), device="cpu")
    opt = optim.SGD(momentum=0.9, weight_decay=5e-4)
    st = state.TrainState.create(model, opt)
    train_step = step.make_train_step(opt, sync_bn=False)
    x, y = torch.randn(4, 32, 32, 3), torch.randint(0, 10, (4,))
    mode = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution: costmodel._conv_formula,
        torch.ops.aten.convolution_backward: costmodel._conv_backward_formula})
    with mode:
        train_step(st, x, y, torch.tensor(0.1))
    _, ours = costmodel.step_cost(train_step, st, x, y, torch.tensor(0.1), world=3)
    assert ours["flops_per_step"] == 3 * mode.get_total_flops()  # the step's total over 3 ranks


# (B, S, H, D, causal): a ViT-like shape, a causal one, a ragged S
ATTENTION = [(2, 16, 3, 16, False), (1, 37, 2, 32, True), (2, 196, 4, 64, False)]


@pytest.mark.parametrize("case", ATTENTION, ids=[str(c) for c in ATTENTION])
def test_the_flash_formula_equals_the_plain_chains_count(case):
    b, s, h, d, causal = case
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, requires_grad=True) for _ in range(3))

    def run(impl):
        full_attention(q, k, v, causal=causal, impl=impl).sum().backward()

    plain = FlopCounterMode(display=False)
    with plain:
        run("xla")
    _, flash = costmodel.step_cost(run, "flash")
    _, ours_plain = costmodel.step_cost(run, "xla")
    q3 = torch.zeros(b * h, s, d)
    # forward 4·BH·S·S·D, backward twice that; exact
    assert flash["flops_per_step"] == plain.get_total_flops() == 3 * attention_flops(q3, q3)
    assert ours_plain["flops_per_step"] == flash["flops_per_step"]


def _jax_resnet18_cost(batch):
    md = jax_resnet18(100)
    params, bn = jax.eval_shape(md.init, jax.random.PRNGKey(0))

    def loss(p, s, x, y):
        logits, _ = md.apply(p, s, x, train=True)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1))

    x = jax.ShapeDtypeStruct((batch, 32, 32, 3), jnp.float32)
    y = jax.ShapeDtypeStruct((batch,), jnp.int32)
    return jax_costmodel.analyze_jitted(jax.jit(jax.grad(loss)), params, bn, x, y)


# The port's ResNet-18 step against XLA's count of the JAX gradient. FLOPs:
# the convolutions and the classifier count the same; XLA also counts the
# elementwise work (BN, ReLU, the loss), which FlopCounterMode does not:
# measured 0.9942. Bytes: XLA counts a fused program's operands; the port
# counts each eager op's inputs and outputs, before any fusion (and its
# step holds the SGD update): measured 1.2416 (XLA 231.3 MB an image).
FLOPS_BAND = (0.99, 1.0)
BYTES_BAND = (1.15, 1.35)


def test_the_full_resnet18_step_counts_within_1pct_of_xla():
    batch = 8
    model = resnet.resnet18(num_classes=100, device="cpu", seed=0)
    opt = optim.SGD(momentum=0.9, weight_decay=5e-4)
    st = state.TrainState.create(model, opt)
    train_step = step.make_train_step(opt, sync_bn=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 32, 32, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 100, batch))
    _, ours = costmodel.step_cost(train_step, st, x, y, torch.tensor(0.1))
    theirs = _jax_resnet18_cost(batch)
    flops = ours["flops_per_step"] / theirs["flops_per_step"]
    nbytes = ours["bytes_per_step"] / theirs["bytes_per_step"]
    assert FLOPS_BAND[0] <= flops <= FLOPS_BAND[1], flops
    assert BYTES_BAND[0] <= nbytes <= BYTES_BAND[1], nbytes
    assert round(ours["flops_per_step"] / batch / 1e9, 3) == 2.888
