"""The port's step profiler (`neuralnet_tracker_traincode_torch/scripts/
profile_step.py`, counterpart of the JAX package's `scripts/profile_step.py`)
on the CPU at a small size: every section runs and prints the JAX script's
labels with finite positive times, the flagship criterion is the JAX
script's literal one, and the depthwise convolution's shift form is the
convolution within bf16 rounding."""

import ast
import math
import os
import re

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import two_intra_op_threads  # noqa: F401 (autouse)

JAX_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "profile_step.py")

# the labels each section prints, as the JAX script prints them (the layout totals under the port's two layouts)
LABELS = {
    "dwconv": ["dw 65x65x  64 conv : fwd", "dw 65x65x  64 shift: fwd", "dw 5x5x1024 conv : fwd", " grad "],
    "aug": ["aug program:", "intensity stage1:", "intensity noise:"],
    "model": ["model fwd:", "model fwd+bwd:"],
    "step": ["full train_step:", "full train_step_multi (K=8):"],
    "layout": ["layer", "stem 5x5 s2 ", "stem 5x5 s2 pad8", "TOTAL NCHW: fwd", "TOTAL channels_last: fwd"],
}


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("PROF_BATCH", "2")
    monkeypatch.setenv("PROF_REPS", "2")
    monkeypatch.setenv("PROF_LAYOUT_SHAPES", "2")


@pytest.mark.parametrize("section", sorted(LABELS))
def test_section_prints_the_jax_scripts_labels(section, small, capsys):
    from neuralnet_tracker_traincode_torch.scripts import profile_step

    assert profile_step.main([section, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"== {section} (batch 2) ==")
    with open(JAX_SCRIPT) as f:
        jax_source = f.read()
    for label in LABELS[section]:
        assert label in out, (label, out)
    for label in ("full train_step:", "aug program:", "intensity stage1:", "intensity noise:", "model fwd:",
                  "model fwd+bwd:", "TOTAL "):
        assert label in jax_source
    times = [float(v) for v in re.findall(r"(\d+\.\d+) ms", out)]
    assert times and all(math.isfinite(t) and t > 0 for t in times), out


def test_sections_report_their_calls(small):
    from neuralnet_tracker_traincode_torch.scripts import profile_step as P

    dev = torch.device("cpu")
    aug = P.section_aug(dev, 2, 2)
    assert aug["calls"] == {"aug program": 4, "intensity stage1": 4, "intensity noise": 4}
    assert set(aug["times"]) == set(aug["calls"])
    layout = P.section_layout(dev, 2, 2, cap=3)
    assert list(layout["rows"]) == [s[0] for s in P.LAYOUT_SHAPES[:3]]
    rows = [r for name, (r, count) in layout["rows"].items() if "pad8" not in name]
    for lay in ("NCHW", "channels_last"):  # the padded stem is an alternative, not in the totals
        assert layout["totals"][lay] == pytest.approx(tuple(sum(r[lay][i] for r in rows) for i in range(2)))


def _jax_criterion_terms():
    """(name, loss, weight) of every `Criterion(...)` in the JAX script's
    `_trainer`, the loss built by its literal expression in the JAX package."""
    from neuralnet_tracker_traincode_tpu.losses import losses as L, nll as NLL

    with open(JAX_SCRIPT) as f:
        tree = ast.parse(f.read())
    trainer = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_trainer")
    calls = [n for n in ast.walk(trainer) if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "Criterion"]
    return [(ast.literal_eval(c.args[0]), eval(ast.unparse(c.args[1]), {"L": L, "NLL": NLL}),
             ast.literal_eval(c.args[2])) for c in calls]


def _simple_attrs(loss):
    return {k: v for k, v in vars(loss).items() if isinstance(v, (bool, int, float, str, type(None)))}


def test_flagship_criterion_is_the_jax_scripts():
    from neuralnet_tracker_traincode_torch.train.flagship import flagship_criterion

    want = _jax_criterion_terms()
    crit = flagship_criterion()
    weights = crit.weight_matrix(50)
    assert weights.shape == (1, 8) and len(want) == 8
    got = [(term.name, term.f, float(weights[0, j])) for j, term in enumerate(crit.terms)]
    for (name, loss, weight), (jname, jloss, jweight) in zip(got, want):
        assert name == jname and weight == pytest.approx(jweight, rel=1e-7), (name, jname)
        assert type(loss).__name__ == type(jloss).__name__, name
        assert _simple_attrs(loss) == _simple_attrs(jloss), name


def test_dwconv_shift_form_is_the_convolution():
    """At 9^2 x 512 in bf16: forward, and the gradients of the output's sum
    with respect to the input and the weights. Tolerance: 9 x 2^-9 of the
    largest value, the shift form's 9 bf16 roundings of its running sum
    (half an ulp each); the convolution accumulates in f32."""
    from neuralnet_tracker_traincode_torch.scripts.profile_step import conv_dw, shift_dw

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 512, 9, 9).astype(np.float32)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(rng.rand(512, 1, 3, 3).astype(np.float32)).bfloat16().requires_grad_(True)
    results = []
    for f in (conv_dw, shift_dw):
        y = f(x, w)
        results.append((y,) + torch.autograd.grad(y.float().sum(), (x, w)))
    for what, ref, got in zip(("forward", "input gradient", "weight gradient"), *results):
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
        ref, got = ref.detach().float(), got.detach().float()
        assert (got - ref).abs().max() <= 9 * 2**-9 * ref.abs().max(), what
