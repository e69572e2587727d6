"""The training step in plain float32 PyTorch: augmentation, forward, the
configuration's loss terms, autograd, the global-norm clip and Adam with
parameter groups, and the BatchNorm running statistics. `follow` takes the
initial state dict, a block of K batches and K steps' draws, and returns
what each step reports and the state after the block."""

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import augment as A
from portbench.reference import geometry as G
from portbench.reference import model as M

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
CHIN = [*range(0, 8), *range(9, 17)]
EYE_NOT_CORNERS = [37, 38, 41, 40, 43, 44, 47, 46]
SCALE_MODULES = (M.Neck, M.DiagonalScaleParameter, M.TriangularScale)


def _mvn_log_prob(x, loc, tril):
    d = x - loc
    z = []
    for i in range(x.shape[-1]):
        acc = d[..., i]
        for j in range(i):
            acc = acc - tril[..., i, j] * z[j]
        z.append(acc / tril[..., i, i])
    z = torch.stack(z, dim=-1)
    log_det = torch.sum(torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(z * z, dim=-1) - log_det - x.shape[-1] * _LOG_SQRT_2PI


def _mixed_nll(log_prob, volume: float):
    """-log(0.999 p + 0.001 / volume)."""
    w = torch.from_numpy(np.log(np.asarray([0.999, 0.001], np.float32))).to(log_prob.device)
    stacked = torch.stack([log_prob, torch.full_like(log_prob, -math.log(volume))], dim=-1) + w
    return -torch.logsumexp(stacked, dim=-1)


def _points_weights(chin: float, device):
    w = torch.ones(68)
    w[CHIN] = chin
    w[EYE_NOT_CORNERS] = 0.0
    return w.to(device)


def term(kind: str, args: List, kwargs: Dict, pred, lab):
    """Per-sample values (B,) of one loss term of the configuration."""
    if kind == "QuatPoseNLLLoss":
        rotvec = G.qrotation_delta(pred["rot"], lab["pose"])
        return _mixed_nll(_mvn_log_prob(rotvec, torch.zeros_like(rotvec), pred["pose_scales_tril"]),
                          math.pi**3 * math.pi * 4.0 / 3.0)
    if kind == "CorrelatedCoordPoseNLLLoss":
        return _mixed_nll(_mvn_log_prob(lab["coord"], pred["coord"], pred["coord_scales"]), 4.0)
    if kind == "QuatPoseLoss" and args == ["approx_distance"]:
        return G.qdistance(pred["rot"], lab["pose"])
    if kind == "PoseXYLoss" and args == ["l2"]:
        return torch.mean(torch.square(pred["coord"][..., :2] - lab["coord"][..., :2]), dim=-1)
    if kind == "PoseSizeLoss" and args == ["l2"]:
        return torch.square(pred["coord"][..., 2] - lab["coord"][..., 2])
    if kind == "Points3dLoss" and args == ["l2"]:
        pointwise = torch.sum(torch.square(pred["pt3d_68"] - lab["pt3d_68"]), dim=-1)
        return torch.mean(pointwise * _points_weights(kwargs.get("chin_weight", 1.0), pointwise.device)[None, :], -1)
    if kind == "BoxLoss" and args == ["l2"]:
        return torch.mean(torch.square(pred["roi"] - lab["roi"]), dim=-1)
    if kind == "QuaternionNormalizationSoftConstraint":
        return torch.square(1.0 - torch.linalg.norm(pred["unnormalized_quat"], dim=-1))
    raise ValueError(f"the reference has no loss term {kind}{args}")


def schedule(spec, epoch: int) -> float:
    """The learning-rate multiplier of an epoch: ["exponential_up_then_steps", num_up, gamma, [steps]]."""
    kind, num_up, gamma, steps = spec
    if kind != "exponential_up_then_steps":
        raise ValueError(f"the reference has no schedule {kind}")
    if epoch < num_up:
        return 1.0e-2 * math.exp(-math.log(1.0e-2) * (epoch + 1) / num_up)
    return gamma ** [j for j, s in enumerate([0] + list(steps)) if epoch > s][-1]


class Adam:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    root) with the learning rate of the count before the step and the bias
    corrections 1 - b^count (f32) of the count after it; the NLL scale
    parameters at 0.1x the rate."""

    def __init__(self, net: torch.nn.Module, opt: Dict):
        self.opt = opt
        variance = set()
        for prefix, mod in net.named_modules():
            if isinstance(mod, SCALE_MODULES):
                variance.update(f"{prefix}.{n}" for n, _ in mod.named_parameters())
        self.mult = {n: (0.1 if n in variance else 1.0) for n, _ in net.named_parameters()}
        self.mu = {n: torch.zeros_like(p) for n, p in net.named_parameters()}
        self.nu = {n: torch.zeros_like(p) for n, p in net.named_parameters()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        o = self.opt
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = torch.where(norm < o["grad_clip_norm"], torch.ones_like(norm), o["grad_clip_norm"] / norm)
        steps_per_epoch = max(1, o["samples_per_epoch"] // o["batchsize"])
        epoch = min(self.count // steps_per_epoch, o["epochs"] - 1)
        lr_epoch = o["lr"] * schedule(o["schedule"], epoch)
        c = np.float32(self.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** c)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** c)
        for n, p in params.items():
            g = grads[n] * scale
            self.mu[n].mul_(0.9).add_(g, alpha=0.1)
            self.nu[n].mul_(0.999).addcmul_(g, g, value=1.0 - 0.999)
            upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + 1e-8)
            p.sub_(upd * float(np.float32(lr_epoch * self.mult[n])))
        self.count += 1


def follow(config: Dict, sd0: Dict[str, torch.Tensor], images, labels: Dict[str, torch.Tensor],
           draws: List[A.Draws], precision=None):
    """K steps from `sd0` on images (K, B, H, W, 1) uint8 and labels (K, B, ...),
    with K steps' draws. Returns (metrics (K, 1 + terms): the loss and each
    term's mean, the state dict after the block, Adam's first and second
    moments after it)."""
    device = images.device
    net = M.PoseNetwork(config).to(device)
    net.load_state_dict(sd0)
    net.train()
    opt = Adam(net, config["optimizer"])
    params = dict(net.named_parameters())
    S, aug = config["inputsize"], config["augmentation"]
    terms = config["criterion"]
    M.Precision.dtype = precision
    rows = []
    try:
        for k in range(images.shape[0]):
            lab = {n: v[k] for n, v in labels.items()}
            x, lab = A.augment(images[k], lab, draws[k].to(device), S, aug)
            out = net(x, lab["coord_convention_id"])
            B = x.shape[0]
            vals = [term(t["loss"], t.get("args", []), t.get("kwargs", {}), out, lab) for t in terms]
            loss = sum(torch.sum(v * t["weight"]) for v, t in zip(vals, terms)) / B
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
            opt.step(params, grads)
            rows.append(torch.stack([loss.detach()] + [v.detach().mean() for v in vals]))
    finally:
        M.Precision.dtype = None
    state = {n: v.detach().clone() for n, v in net.state_dict().items()}
    return torch.stack(rows), state, opt.mu, opt.nu
