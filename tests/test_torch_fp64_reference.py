"""The fp64 reference of the fp32 train step's gradient check, on the CPU:
the port's plain path in float64 throughout (``chip_smoke.fp64_reference``),
the limit rule that holds the card's gradients against it
(``chip_smoke.train_step_failures``), and the CLIs' refusal of float64.  A
small flow: sets of 8, 2 coupling layers, hidden 32, 16 sets.  Needs
neither a card nor JAX."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.inference import build_task
from categoricalnf_tpu_torch.ops.numerics import at_least_f32, uniform_noise

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(set_size=8, num_layers=2, hidden_dim=32, batch_size=16,
            encoding_dim=4, num_mixtures=8, seed=3, compute_dtype="float32")
SETS = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


@pytest.fixture(scope="module")
def steps():
    """The fp32 task and its fp64 reference on one state (data-initialised,
    the nets' output layers randomised, as chip_smoke sets up the flagship's
    step), a batch and its noise."""
    task = build_task("set_shuffling", ARGS, device="cpu")
    x = task._gen(np.random.default_rng(5), SETS)
    task.data_init({"x": x}, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        for name, p in task.model.named_parameters():
            if name.endswith("net.out.w"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    ref = cs.fp64_reference(ARGS, task.model.state_dict())
    noise = uniform_noise((SETS, 8, 4),
                          generator=torch.Generator().manual_seed(8))
    return task, ref, x, noise


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def test_at_least_f32():
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int64,
                  torch.bool):
        t = torch.ones(3, dtype=dtype)
        assert at_least_f32(t).dtype == torch.float32
    t = torch.ones(3, dtype=torch.float64)
    assert at_least_f32(t) is t


def test_fp64_step_is_float64_throughout(steps):
    task, ref, x, noise = steps
    grads = cs.step_grads(ref, x, noise.double())
    params = dict(ref.model.named_parameters())
    assert len(params) == len(dict(task.model.named_parameters()))
    assert all(p.dtype == torch.float64 for p in params.values())
    assert all(b.dtype == torch.float64 for b in ref.model.buffers())
    assert all(g is not None and g.dtype == torch.float64
               for g in grads.values())
    loss = ref.loss({"x": x}, 0.7, noise=noise.double())
    assert loss.dtype == torch.float64 and torch.isfinite(loss)
    # the reference holds the fp32 model's state exactly
    for k, v in task.model.state_dict().items():
        assert torch.equal(ref.model.state_dict()[k], v.double()), k


def test_batch_order_moves_fp64_gradients_only_at_fp64_rounding(steps):
    """Reversing the order of the batch's sets moves every fp64 gradient by
    under 1e-12 relative; the fp32 step's move by more than 1e-9 on some
    tensor (the control: no fp32 op hides in the fp64 step)."""
    task, ref, x, noise = steps
    flip = np.ascontiguousarray(x[::-1])
    moved = {}
    for name, model, nz in (("fp64", ref, noise.double()),
                            ("fp32", task, noise)):
        one = cs.step_grads(model, x, nz)
        two = cs.step_grads(model, flip, nz.flip(0))
        moved[name] = max(_rel(two[k], one[k]) for k in one
                          if one[k].abs().max() > 0)
    assert moved["fp64"] < 1e-12
    assert moved["fp32"] > 1e-9


def test_fp64_and_fp32_steps_agree(steps):
    task, ref, x, noise = steps
    exact = cs.step_grads(ref, x, noise.double())
    got = cs.step_grads(task, x, noise)
    errs = [_rel(got[k], exact[k]) for k in exact
            if exact[k].abs().max() > 0]
    assert len(errs) > 20 and max(errs) <= 1e-2


A, B = cs.FP64_REL, cs.KERNELS_VS_PLAIN_CARD


@pytest.mark.parametrize("readings,fails", [
    # (e_cpu, e_plain, e_kern, control): a well-resolved tensor that passes
    ({"w": (1e-5, 5e-5, 1e-4, 2e-3)}, []),
    # (a) at its floor: the kernels 1.1e-3 from the exact gradient
    ({"w": (1e-5, 5e-5, 1.1e-3, 2e-3)}, ["(a) w: kernels", "(b) w"]),
    # (a) raised where fp32 itself cannot resolve the tensor: 2 e_cpu
    ({"bias": (8e-4, 1.2e-3, 1.5e-3, 3e-3)}, []),
    ({"bias": (8e-4, 1.2e-3, 1.7e-3, 3e-3)}, ["(a) bias: kernels"]),
    ({"bias": (8e-4, 1.7e-3, 1.5e-3, 3e-3)}, ["(a) bias: plain path"]),
    # (b) raised to 2 e_plain, and then (c) is not asked
    ({"off": (4e-4, 4e-4, 7e-4, 5e-4)}, []),
    ({"off": (4e-4, 4e-4, 8.1e-4, 5e-4)}, ["(b) off"]),
    # (b) at its floor: the kernels within 3e-4, the control above it
    ({"w": (1e-5, 1e-4, 3.1e-4, 2e-3)}, ["(b) w"]),
    ({"w": (1e-5, 1e-4, 2e-4, 2.5e-4)}, ["(c) w"]),
    # a NaN fails every rule it enters
    ({"w": (1e-5, 1e-4, float("nan"), 2e-3)}, ["(a) w: kernels", "(b) w"]),
    # two tensors: each judged on its own readings
    ({"w": (1e-5, 1e-4, 2e-4, 2e-3), "bias": (1e-3, 1e-3, 1.9e-3, 1e-3)},
     []),
])
def test_train_step_rule_on_made_up_readings(readings, fails):
    got = cs.train_step_failures(readings)
    assert len(got) == len(fails)
    for msg, want in zip(got, fails):
        assert msg.startswith(want), (msg, want)


def test_rule_limits_and_floors():
    assert (A, B) == (1e-3, 3e-4)
    # (a) and (b) take their floors until twice the reading exceeds them
    assert not cs.train_step_failures({"t": (A / 2, B / 2, B, 2 * B)})
    assert cs.train_step_failures({"t": (A / 2, B / 2, B * 1.01, 2 * B)})


# the fp32 pair's rule at sets above 32 (``chip_smoke.f32_pair_failures``)
# on made-up tensors: the output and two gradients on values that bf16
# does not hold exactly, each moved at one element by e (1 + |value|), so
# that its allclose_err is e
FWD, BWD = cs.F32_TRAIN_FWD_TOL, cs.F32_BWD_TOL


def _moved(ref, e):
    out = ref.clone()
    out[7] += e * (1 + ref[7].abs())
    return out.float()


def _pair_failures(e_plain, e_kern, ref=None):
    ref = torch.linspace(1.0, 3.0, 257, dtype=torch.float64) \
        if ref is None else ref
    names = ["y", "dx", "w"]
    got = [_moved(ref, e) for e in e_kern]
    plain = [_moved(ref, e) for e in e_plain]
    return cs.f32_pair_failures(names, got, plain, [ref] * 3)


@pytest.mark.parametrize("e_plain,e_kern,fails", [
    # within the floors: 1e-4 for the output, 2e-4 for a gradient
    ((0, 0, 0), (0.9 * FWD, 0.9 * BWD, 0.9 * BWD), []),
    ((0, 0, 0), (1.5 * FWD, 0, 0), ["y"]),
    ((0, 0, 0), (0, 0, 1.1 * BWD), ["w"]),
    # raised to twice plain fp32's own distance, tensor by tensor
    ((0, 4 * BWD, 0), (0, 7.9 * BWD, 0), []),
    ((0, 4 * BWD, 0), (0, 8.1 * BWD, 0), ["dx"]),
    ((0, 4 * BWD, 0), (0, 0, 1.1 * BWD), ["w"]),
    # a NaN fails
    ((0, 0, 0), (0, float("nan"), 0), ["dx"]),
])
def test_f32_pair_rule_on_made_up_tensors(e_plain, e_kern, fails):
    got, readings = _pair_failures(e_plain, e_kern)
    assert [m.split()[0] for m in got] == fails
    # the bf16-rounded values lie outside every limit but a NaN's
    assert readings["control_over"] == sum(e == e for e in e_kern)


def test_f32_pair_rule_wants_the_control_outside():
    """On values bf16 holds exactly the control reads 0 and the rule
    fails, whatever the kernels read."""
    ref = torch.linspace(1.0, 2.0, 129, dtype=torch.float64)
    got, readings = _pair_failures((0, 0, 0), (0, 0, 0), ref)
    assert readings["control_over"] == 0
    assert len(got) == 1 and "control" in got[0]


def test_cli_refuses_float64():
    from categoricalnf_tpu_torch import serve
    from categoricalnf_tpu_torch.utils.cli import default_parser
    p = default_parser("test")
    assert p.parse_args(["--compute_dtype", "float32"]).compute_dtype \
        == "float32"
    with pytest.raises(SystemExit):
        p.parse_args(["--compute_dtype", "float64"])
    with pytest.raises(SystemExit):
        serve.main(["--run", "no_such_run", "--compute_dtype", "float64"])
