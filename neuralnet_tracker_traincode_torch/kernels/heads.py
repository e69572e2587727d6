"""The pose heads after their linear layers as one autograd Function
(`csrc/heads.cu`): one kernel forward, one backward.

`NetworkWithPointHead` with the quaternion head, the point head and the
local pose offsets (`models/posenet.py:NetworkWithPointHead.fused_heads`)
calls `pose_heads` on its head linears' f32 outputs. Per sample it computes
what the modules compute op by op: the quaternion from its features
(smoothclip0 of the real part, normalised with eps 1e-6), the two local pose
offsets of the sample's `set_id` row (row 0 without ids), the position and
size, the box, the 50 -> 68 x 3 keypoint blend in full f32 posed by the 2.5D
transform (rotate, scale, add xy) and, with uncertainty, the two triangular
scales and the three diagonal scale vectors (their callers expand them over
the batch).

For CPU tensors forward and backward are plain torch ops: the forward calls
the modules' own functions (`components.offset_pose`, `nll.triangular_scale`,
...), so it equals them bit for bit; the backward is derived by hand below.
For CUDA tensors the Function launches the kernels, or raises.

The two offsets' gradients are sums over the samples that chose each row:
the plain version adds them in sample order (`index_add_`), the kernel in a
fixed tree order with no float atomics, so that the same inputs give the
same bits. A gradient is None where every output it depends on has none.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.models.components import box_from_features, offset_pose, rigid_transformation_25d
from neuralnet_tracker_traincode_torch.models.nll import diagonal_scale, triangular_scale
from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops.mathfn import full_f32_matmul, smoothclip0
from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

NUM_POINTS, NUM_EIGVECS = 68, 50
QUAT_EPS = 1.0e-6  # ops/quaternion.py:normalized
SCALE_EPS = 1.0e-6  # models/nll.py:DiagonalScaleParameter

# The Function's inputs: the head linears' f32 outputs (B, n), the necks' (B, 7),
# the two offsets' parameters (rows, 4), the rows' ids (B,) int32 or None, the
# keypoint buffers, the triangular scales' min_diag (6,), the diagonal scales'
# hidden values (n + 1,). The scales' inputs are all None without uncertainty.
INPUTS = ("quat", "xy", "size", "box", "shape", "neck_rot", "neck_coord", "offset", "offset_kpts", "set_id",
          "keypts", "keyeigvecs", "min_diag_rot", "min_diag_coord", "hidden_roi", "hidden_pt3d", "hidden_shape")
SCALE_INPUTS = ("neck_rot", "neck_coord", "min_diag_rot", "min_diag_coord", "hidden_roi", "hidden_pt3d",
                "hidden_shape")
# Its outputs, by the network's dict keys; the last five None without uncertainty.
OUTPUTS = ("rot", "unnormalized_quat", "coord", "roi", "pt3d_68", "pose_scales_tril", "coord_scales", "roi_scales",
           "pt3d_68_scales", "shapeparam_scales")
# Which outputs each differentiable input reaches.
REACHES = {
    "quat": ("rot", "unnormalized_quat", "coord", "pt3d_68"),
    "xy": ("coord", "pt3d_68"),
    "size": ("coord", "pt3d_68"),
    "box": ("roi",),
    "shape": ("pt3d_68",),
    "neck_rot": ("pose_scales_tril",),
    "neck_coord": ("coord_scales",),
    "offset": ("rot", "coord"),
    "offset_kpts": ("pt3d_68",),
    "hidden_roi": ("roi_scales",),
    "hidden_pt3d": ("pt3d_68_scales",),
    "hidden_shape": ("shapeparam_scales",),
}
# The kernels' tensors by slot, in `csrc/nntc_kernels.h:nntc_heads::Slot`'s order:
# inputs, outputs, the outputs' gradients, the inputs' gradients, the samples'
# shares of the offsets' gradients (B, 8) and the last CTA's ticket.
SLOTS = INPUTS + OUTPUTS + tuple("g_" + k for k in OUTPUTS) + tuple("d_" + k for k in REACHES) + ("partial", "ticket")
PARTIAL_WIDTH = 8


def _select(p: torch.Tensor, set_id: Optional[torch.Tensor]) -> torch.Tensor:
    return p[0:1] if set_id is None else p[set_id.long()]


def _blend(shape, keypts, keyeigvecs):
    """The keypoints (..., 68, 3) of shape parameters (..., 50), in the inputs' dtype."""
    K = keyeigvecs.shape[0]
    local = torch.matmul(shape, keyeigvecs.reshape(K, -1))
    return local.reshape(shape.shape[:-1] + keypts.shape) + keypts


def heads_plain(x: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """The forward in plain torch ops, by the modules' own functions: the
    outputs (OUTPUTS) of the inputs `x` (INPUTS; one left out is None)."""
    with torch.autocast(x["quat"].device.type, enabled=False), full_f32_matmul():
        rots, unnormalized = QuatRepr.from_features(x["quat"])
        coords = torch.cat([x["xy"], smoothclip0(x["size"])], dim=-1)
        rot, coord = offset_pose(rots, coords, _select(x["offset"], x.get("set_id")))
        rot_k, coord_k = offset_pose(rots, coords, _select(x["offset_kpts"], x.get("set_id")))
        local = _blend(x["shape"], x["keypts"], x["keyeigvecs"])
        out = {
            "rot": rot.value, "unnormalized_quat": unnormalized, "coord": coord, "roi": box_from_features(x["box"]),
            "pt3d_68": rigid_transformation_25d(rot_k, coord_k[..., :2], coord_k[..., 2:], local),
        }
        if x.get("neck_rot") is not None:
            out["pose_scales_tril"] = triangular_scale(3, x["neck_rot"], x["min_diag_rot"])
            out["coord_scales"] = triangular_scale(3, x["neck_coord"], x["min_diag_coord"])
            for name, hidden in (("roi_scales", "hidden_roi"), ("pt3d_68_scales", "hidden_pt3d"),
                                 ("shapeparam_scales", "hidden_shape")):
                out[name] = diagonal_scale(x[hidden], SCALE_EPS)
    return out


# ---- the backward, derived by hand ------------------------------------------
# For r = u v (Hamilton), dL/du = dr conj(v) and dL/dv = conj(u) dr. Q.rotate(q, p)
# is the vector part of A conj(q) with A = q (p, 0).


def _dsmoothclip0(x):
    """smoothclip0's derivative as elu's backward takes it: 1 above 0, exp(x) at and below."""
    return torch.where(x > 0, torch.ones_like(x), torch.exp(x))


def _rotate_backward(q, p, d):
    """(dq, dp) of Q.rotate(q, p) given d, its gradient; q (..., 4), p and d (..., 3)."""
    P, dR = F.pad(p, (0, 1)), F.pad(d, (0, 1))
    A = Q.mult(q, P)
    dA = Q.mult(dR, q)
    dq = Q.mult(dA, Q.conjugate(P)) + Q.mult(Q.conjugate(dR), A)
    return dq, Q.mult(Q.conjugate(q), dA)[..., :3]


def _offset_backward(q, coords, psel, d_rot, d_coord):
    """(dq, dcoords, dpsel) of `offset_pose(QuatRepr(q), coords, psel)`,
    every operand (B, ...), given the gradients of its rotation and coords."""
    half = 0.5 * psel[..., 1]
    sn, cs = torch.sin(half), torch.cos(half)
    zero = torch.zeros_like(sn)
    offset_quat = torch.stack([sn, zero, zero, cs], dim=-1)
    offset_scale = smoothclip0(psel[..., 3:])
    scale = coords[..., 2:] * offset_scale
    transl = torch.cat([zero[..., None], psel[..., 1:3]], dim=-1)
    pos = Q.rotate(q, transl)
    d_scale = d_coord[..., 2:] + torch.sum(d_coord[..., :2] * pos[..., :2], dim=-1, keepdim=True)
    dq, d_transl = _rotate_backward(q, transl, F.pad(d_coord[..., :2] * scale, (0, 1)))
    dq = dq + Q.mult(d_rot, Q.conjugate(offset_quat))
    d_o = Q.mult(Q.conjugate(q), d_rot)
    d_angle = d_transl[..., 1] + 0.5 * (d_o[..., 0] * cs - d_o[..., 3] * sn)
    d_hidden = (d_scale * coords[..., 2:] * _dsmoothclip0(psel[..., 3:]))[..., 0]
    d_psel = torch.stack([zero, d_angle, d_transl[..., 2], d_hidden], dim=-1)
    return dq, torch.cat([d_coord[..., :2], d_scale * offset_scale], dim=-1), d_psel


def _rows_backward(p, set_id, d_psel):
    """The gradient of the parameter rows `p`: each sample's share added to its row, in sample order."""
    rows = torch.zeros(d_psel.shape[0], dtype=torch.long, device=p.device) if set_id is None else set_id.long()
    return torch.zeros_like(p).index_add_(0, rows, d_psel)


def _triangular_backward(y, d_m):
    """The gradient of `triangular_scale(3, y, min_diag)` with respect to y (B, 7)."""
    multiplier, x = smoothclip0(y[..., :1]), y[..., 1:]
    z = torch.cat([smoothclip0(x[..., :3]), x[..., 3:]], dim=-1)
    d_z = torch.stack([d_m[..., 0, 0], d_m[..., 1, 1], d_m[..., 2, 2], d_m[..., 1, 0], d_m[..., 2, 0],
                       d_m[..., 2, 1]], dim=-1)
    d_multiplier = torch.sum(d_z * z, dim=-1, keepdim=True)
    d_x = d_z * multiplier
    return torch.cat([d_multiplier * _dsmoothclip0(y[..., :1]), d_x[..., :3] * _dsmoothclip0(x[..., :3]),
                      d_x[..., 3:]], dim=-1)


def _diagonal_backward(h, d_s):
    """The gradient of `diagonal_scale(h, eps)` with respect to h (n + 1,)."""
    multiplier, v = smoothclip0(h[:1]), smoothclip0(h[1:])
    return torch.cat([torch.sum(d_s * v, dim=0, keepdim=True) * _dsmoothclip0(h[:1]),
                      d_s * multiplier * _dsmoothclip0(h[1:])])


def heads_backward_plain(x: Dict[str, Optional[torch.Tensor]],
                         g: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The gradients of the differentiable inputs (REACHES' keys) given
    those of the outputs, `g` (a None gradient counts as zeros)."""
    with torch.autocast(x["quat"].device.type, enabled=False), full_f32_matmul():
        zq, B = x["quat"], x["quat"].shape[0]
        g = {k: (zq.new_zeros(s) if g.get(k) is None else g[k]) for k, s in output_shapes(B).items()}
        u = torch.cat([zq[..., :3], smoothclip0(zq[..., 3:])], dim=-1)
        n = torch.linalg.norm(u, dim=-1, keepdim=True)
        q = u / torch.clamp(n, min=QUAT_EPS)
        coords = torch.cat([x["xy"], smoothclip0(x["size"])], dim=-1)
        psel = _select(x["offset"], x.get("set_id")).expand(B, 4)
        psel_k = _select(x["offset_kpts"], x.get("set_id")).expand(B, 4)

        # the keypoints: pt = rotate(q_k, local) * s + (t, 0)
        q_k, coord_k = offset_pose(QuatRepr(q), coords, psel_k)
        q_k = q_k.value[..., None, :]
        local = _blend(x["shape"], x["keypts"], x["keyeigvecs"])
        d_pt = g["pt3d_68"]
        rotated = Q.rotate(q_k, local)
        d_size_k = torch.sum(d_pt * rotated, dim=(-2, -1))[..., None]
        d_xy_k = torch.sum(d_pt[..., :2], dim=-2)
        d_q_k, d_local = _rotate_backward(q_k, local, d_pt * coord_k[..., None, 2:])
        d_shape = torch.matmul(d_local.reshape(B, -1), x["keyeigvecs"].reshape(NUM_EIGVECS, -1).t())

        dq_k, d_coords, d_psel_k = _offset_backward(q, coords, psel_k, d_q_k.sum(-2),
                                                    torch.cat([d_xy_k, d_size_k], dim=-1))
        dq, d_coords_1, d_psel = _offset_backward(q, coords, psel, g["rot"], g["coord"])
        dq, d_coords = dq + dq_k, d_coords + d_coords_1
        du = torch.where(n >= QUAT_EPS, (dq - q * torch.sum(q * dq, dim=-1, keepdim=True)) / n, dq / QUAT_EPS)
        du = du + g["unnormalized_quat"]
        d_roi = g["roi"]
        d_box = torch.cat([d_roi[..., :2] + d_roi[..., 2:],
                           (d_roi[..., 2:] - d_roi[..., :2]) * _dsmoothclip0(x["box"][..., 2:])], dim=-1)
        d = {
            "quat": torch.cat([du[..., :3], du[..., 3:] * _dsmoothclip0(zq[..., 3:])], dim=-1),
            "xy": d_coords[..., :2],
            "size": d_coords[..., 2:] * _dsmoothclip0(x["size"]),
            "box": d_box,
            "shape": d_shape,
            "offset": _rows_backward(x["offset"], x.get("set_id"), d_psel),
            "offset_kpts": _rows_backward(x["offset_kpts"], x.get("set_id"), d_psel_k),
        }
        if x.get("neck_rot") is not None:
            d["neck_rot"] = _triangular_backward(x["neck_rot"], g["pose_scales_tril"])
            d["neck_coord"] = _triangular_backward(x["neck_coord"], g["coord_scales"])
            d["hidden_roi"] = _diagonal_backward(x["hidden_roi"], g["roi_scales"])
            d["hidden_pt3d"] = _diagonal_backward(x["hidden_pt3d"], g["pt3d_68_scales"])
            d["hidden_shape"] = _diagonal_backward(x["hidden_shape"], g["shapeparam_scales"])
    return d


# ---- the kernels -------------------------------------------------------------


def input_shapes(B: int, rows: int) -> Dict[str, tuple]:
    return {
        "quat": (B, 4), "xy": (B, 2), "size": (B, 1), "box": (B, 4), "shape": (B, NUM_EIGVECS),
        "neck_rot": (B, 7), "neck_coord": (B, 7), "offset": (rows, 4), "offset_kpts": (rows, 4), "set_id": (B,),
        "keypts": (NUM_POINTS, 3), "keyeigvecs": (NUM_EIGVECS, NUM_POINTS, 3), "min_diag_rot": (6,),
        "min_diag_coord": (6,), "hidden_roi": (5,), "hidden_pt3d": (NUM_POINTS + 1,),
        "hidden_shape": (NUM_EIGVECS + 1,),
    }


def output_shapes(B: int) -> Dict[str, tuple]:
    return {
        "rot": (B, 4), "unnormalized_quat": (B, 4), "coord": (B, 3), "roi": (B, 4), "pt3d_68": (B, NUM_POINTS, 3),
        "pose_scales_tril": (B, 3, 3), "coord_scales": (B, 3, 3), "roi_scales": (4,),
        "pt3d_68_scales": (NUM_POINTS,), "shapeparam_scales": (NUM_EIGVECS,),
    }


def checked_inputs(x: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """The inputs made contiguous, the ids int32, and checked on the host (a
    failing check inside the extension's bindings would end the process)."""
    B, rows = x["quat"].shape[0], x["offset"].shape[0]
    if B < 1:
        raise ValueError("the pose heads' kernels need a sample")
    with_scales = x.get("neck_rot") is not None
    shapes = input_shapes(B, rows)
    out = {}
    for k in INPUTS:
        t = x.get(k)
        if t is None:
            if k != "set_id" and (k not in SCALE_INPUTS or with_scales):
                raise ValueError(f"{k} is missing")
            out[k] = None
            continue
        if k in SCALE_INPUTS and not with_scales:
            raise ValueError(f"{k} given without neck_rot: the scales' inputs come all or none")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k} must have shape {shapes[k]}, got {tuple(t.shape)}")
        if k == "set_id" and t.dtype != torch.int32 and not t.is_floating_point():
            t = t.to(torch.int32)
        t = t.contiguous()
        ext.require_cuda_tensor(t, k, torch.int32 if k == "set_id" else torch.float32, len(shapes[k]))
        if t.device != x["quat"].device:
            raise ValueError(f"{k} is on {t.device}, the heads' features on {x['quat'].device}")
        out[k] = t
    return out


ABSENT = torch.empty(0)  # a slot the call leaves empty (the bindings pass a null pointer)


def _launch(tensors: Dict[str, torch.Tensor], rows: int, backward: bool):
    ext.extension().pose_heads([ABSENT if tensors.get(k) is None else tensors[k] for k in SLOTS], rows, backward)
    ext.LAUNCHES["pose_heads_backward" if backward else "pose_heads_forward"] += 1


def heads_forward_kernel(x):
    """(outputs, ticket): the forward kernel's outputs and the backward's ticket, which it zeroes."""
    x = checked_inputs(x)
    B, dev = x["quat"].shape[0], x["quat"].device
    names = OUTPUTS if x["neck_rot"] is not None else OUTPUTS[:5]
    out = {k: torch.empty(s, device=dev) for k, s in output_shapes(B).items() if k in names}
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    _launch(dict(x, **out, ticket=ticket), x["offset"].shape[0], False)
    return out, ticket


def heads_backward_kernel(x, g, ticket):
    """The backward kernel's gradients of the differentiable inputs; `ticket`
    is the forward's (zero, and zero again when the kernel ends)."""
    x = checked_inputs(x)
    B, dev = x["quat"].shape[0], x["quat"].device
    shapes = dict(input_shapes(B, x["offset"].shape[0]), **output_shapes(B))
    tensors = dict(x, ticket=ticket, partial=torch.empty((B, PARTIAL_WIDTH), device=dev))
    for k, v in g.items():
        if v is not None:
            if tuple(v.shape) != shapes[k] or v.dtype != torch.float32 or v.device != dev:
                raise ValueError(f"the gradient of {k} must be f32 {shapes[k]} on {dev}, got {v.dtype} "
                                 f"{tuple(v.shape)} on {v.device}")
            tensors["g_" + k] = v.contiguous()
    d = {k: torch.empty(shapes[k], device=dev) for k in REACHES if x[k] is not None}
    tensors.update({"d_" + k: v for k, v in d.items()})
    _launch(tensors, x["offset"].shape[0], True)
    return d


class PoseHeads(torch.autograd.Function):
    """The heads' Function: inputs in INPUTS' order, outputs in OUTPUTS'."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        x = dict(zip(INPUTS, inputs))
        if x["quat"].device.type == "cpu":
            out = heads_plain(x)
        else:
            out, ctx.ticket = heads_forward_kernel(x)
        return tuple(out.get(k) for k in OUTPUTS)

    @staticmethod
    def backward(ctx, *grads):
        x = dict(zip(INPUTS, ctx.saved_tensors))
        g = dict(zip(OUTPUTS, grads))
        wanted = {k for i, k in enumerate(INPUTS)
                  if ctx.needs_input_grad[i] and any(g[o] is not None for o in REACHES.get(k, ()))}
        if not wanted:
            return (None,) * len(INPUTS)
        if x["quat"].device.type == "cpu":
            d = heads_backward_plain(x, g)
        else:
            d = heads_backward_kernel(x, g, ctx.ticket)
        return tuple(d[k] if k in wanted else None for k in INPUTS)


def pose_heads(**inputs: Optional[torch.Tensor]) -> Dict[str, Optional[torch.Tensor]]:
    """The heads' outputs by name (OUTPUTS) from their inputs by name
    (INPUTS; `set_id` and the scales' inputs may be left out)."""
    unknown = set(inputs) - set(INPUTS)
    if unknown:
        raise TypeError(f"no input {sorted(unknown)} of the pose heads")
    return dict(zip(OUTPUTS, PoseHeads.apply(*(inputs.get(k) for k in INPUTS))))
