"""The pose heads as one autograd Function (`kernels/heads.py`), on the CPU.

Its plain forward against the modules op by op (`_heads_per_op`): equal to
1e-6 (it calls the same functions, so in fact bit for bit). Its backward,
derived by hand, by `torch.autograd.gradcheck` in float64 for every input,
both offsets' rows included, at B = 1, 7 and 64 with the rows' ids left out,
repeated, and all 8 rows taken (gradcheck's fast mode above B = 1: its full
mode costs a backward per output value), and against autograd of the modules
op by op in the network, parameter by parameter, with the gradients that are
None left None. Which networks take the Function: the quaternion head with
the point head and the local pose offsets; the 6D head, no point head or no
offsets go op by op. The kernels' slots against the C header's enum.
"""

import os
import re

import pytest
import torch

from neuralnet_tracker_traincode_torch.kernels import heads as H
from neuralnet_tracker_traincode_torch.models import posenet
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

SMALL = dict(enable_point_head=True, config="mobilenetv1", backbone_args={"widen_factor": 0.25})


def _net(uncertainty=True, seed=0, **kw):
    net = NetworkWithPointHead(**dict(SMALL, enable_uncertainty=uncertainty, **kw))
    g = torch.Generator().manual_seed(seed)
    net.init_weights(g)
    with torch.no_grad():  # move every parameter off its init, so that no term is trivially zero
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _ids(B, mode, g):
    if mode == "none":
        return None
    if mode == "repeated":
        return torch.randint(0, 3, (B,), generator=g, dtype=torch.int32)
    return torch.arange(B, dtype=torch.int32) % 8  # "all8": every row taken


def _value(v):
    """The tensor of an output: a rotation's value, or the output itself."""
    return getattr(v, "value", v)


@pytest.mark.parametrize("uncertainty", [True, False])
@pytest.mark.parametrize("ids", ["none", "repeated", "all8"])
def test_plain_forward_equals_the_modules_op_by_op(uncertainty, ids):
    net = _net(uncertainty)
    g = torch.Generator().manual_seed(1)
    B = 9
    feats = torch.randn(B, net.convnet.num_features, generator=g)
    set_id = _ids(B, ids, g)
    fused = net._heads_fused([feats] * 4, set_id)
    per_op = net._heads_per_op([feats] * 4, set_id)
    assert list(fused) == list(per_op)
    for k in per_op:
        a, b = _value(fused[k]), _value(per_op[k])
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, k
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def _inputs(B, ids, dtype=torch.float64, uncertainty=True, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    x = dict(quat=r(B, 4), xy=r(B, 2), size=r(B, 1), box=r(B, 4), shape=r(B, 50), offset=0.3 * r(8, 4),
             offset_kpts=0.3 * r(8, 4), keypts=r(68, 3), keyeigvecs=0.1 * r(50, 68, 3), set_id=_ids(B, ids, g))
    if uncertainty:
        min_diag = torch.tensor([1e-6] * 3 + [0.0] * 3, dtype=dtype)
        x.update(neck_rot=r(B, 7), neck_coord=r(B, 7), min_diag_rot=min_diag, min_diag_coord=min_diag.clone(),
                 hidden_roi=r(5), hidden_pt3d=r(69), hidden_shape=r(51))
    return x


@pytest.mark.parametrize("B,ids", [(1, "none"), (1, "repeated"), (7, "none"), (7, "repeated"), (64, "none"),
                                   (64, "repeated"), (64, "all8")])
def test_hand_derived_backward_passes_gradcheck(B, ids):
    x = _inputs(B, ids, seed=B)
    names = [k for k in H.INPUTS if k in H.REACHES]
    assert {"offset", "offset_kpts", "hidden_roi", "hidden_pt3d", "hidden_shape"} <= set(names)

    def f(*args):
        return tuple(v for v in H.pose_heads(**dict(x, **dict(zip(names, args)))).values() if v is not None)

    args = [x[k].clone().requires_grad_() for k in names]
    assert torch.autograd.gradcheck(f, args, fast_mode=B > 1)


def test_gradcheck_without_the_scales():
    x = _inputs(3, "repeated", uncertainty=False, seed=3)
    names = ["quat", "xy", "size", "box", "shape", "offset", "offset_kpts"]

    def f(*args):
        out = H.pose_heads(**dict(x, **dict(zip(names, args))))
        assert all(out[k] is None for k in H.OUTPUTS[5:])
        return tuple(out[k] for k in H.OUTPUTS[:5])

    assert torch.autograd.gradcheck(f, [x[k].clone().requires_grad_() for k in names], fast_mode=True)


def _param_grads(net, fused, feats, set_id, keys):
    net.zero_grad()
    out = net._heads_fused([feats] * 4, set_id) if fused else net._heads_per_op([feats] * 4, set_id)
    w = torch.Generator().manual_seed(5)
    loss = sum(torch.sum(_value(out[k]) * torch.randn(_value(out[k]).shape, generator=w)) for k in keys)
    loss.backward()
    return {n: p.grad for n, p in net.named_parameters() if not n.startswith("convnet.")}


@pytest.mark.parametrize("keys", [
    ("rot", "unnormalized_quat", "coord", "roi", "pt3d_68", "shapeparam", "pose_scales_tril", "coord_scales",
     "roi_scales", "pt3d_68_scales", "shapeparam_scales"),
    ("rot", "coord", "pose_scales_tril", "coord_scales"),  # no points, box or diagonal scales
    ("pt3d_68",),
])
@pytest.mark.parametrize("ids", ["none", "all8"])
def test_parameter_gradients_equal_autograd_of_the_modules(keys, ids):
    """f32, B = 12: every head parameter's gradient within 1e-5 of its
    largest value, and None exactly where the modules' is None."""
    net = _net(True, seed=2)
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(12, net.convnet.num_features, generator=g)
    set_id = _ids(12, ids, g)
    got = _param_grads(net, True, feats, set_id, keys)
    want = _param_grads(net, False, feats, set_id, keys)
    assert {n for n, v in got.items() if v is None} == {n for n, v in want.items() if v is None}
    assert any(v is None for v in want.values()) == (len(keys) < 11)
    for n, v in want.items():
        if v is not None:
            torch.testing.assert_close(got[n], v, rtol=0, atol=1e-5 * float(v.abs().max()) + 1e-12, msg=n)


@pytest.mark.parametrize("net_args,fused", [
    (dict(), True),
    (dict(enable_uncertainty=False), True),
    (dict(enable_6drot=True), False),
    (dict(enable_point_head=False), False),
    (dict(use_local_pose_offset=False), False),
])
def test_which_networks_call_the_function(monkeypatch, net_args, fused):
    net = NetworkWithPointHead(**dict(SMALL, **dict(dict(enable_uncertainty=True), **net_args)))
    net.init_weights(torch.Generator().manual_seed(0))
    calls = []

    def counted(**inputs):
        calls.append(1)
        return H.pose_heads(**inputs)

    monkeypatch.setattr(posenet, "pose_heads", counted)
    x = torch.rand(2, 129, 129, 1, generator=torch.Generator().manual_seed(0)) - 0.5
    for train in (True, False):
        out = net.train(train)(x, coord_convention_id=torch.tensor([0, 3], dtype=torch.int32))
        assert torch.isfinite(_value(out["rot"])).all()
    assert net.fused_heads == fused and len(calls) == (2 if fused else 0)


def test_the_kernel_wrappers_refuse_cpu_tensors():
    x = _inputs(2, "none", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        H.heads_forward_kernel(x)


def test_slots_follow_the_headers_enum():
    header = os.path.join(os.path.dirname(H.__file__), "csrc", "nntc_kernels.h")
    with open(header) as f:
        body = re.search(r"enum Slot : int \{(.*?)\};", f.read(), re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",") if n.strip()]
    assert names == list(H.SLOTS) + ["count"]
