"""Fit the deformable 68-keypoint head to annotated 2D landmarks, every sample
at once on the card (counterpart of the JAX package's
`scripts/fit_face_model.py`, with its flags).

    python -m neuralnet_tracker_traincode_torch.scripts.fit_face_model data.h5 \\
        [--out-group 2dfit_v3] [--steps 3000] [--lr 0.05] [--prior-weight 0.01] \\
        [--huber-delta 0.05] [--landmarks pt2d_68] [--dry-run] [--device cpu]

For each sample it fits the pose (a quaternion), the 2.5D position and size
and the 50 shape parameters to `pt2d_68` (else `pt3d_68`), starting from
`pseudolabels/quats` where the file has them, and writes them as the group
`--out-group` (quats, coords, pt3d_68, shapeparams as f16), which large-pose
synthesis reads.

All N samples are one Adam optimisation of N x 57 parameters in roi-normalised
coordinates, run on `--device` (default `cuda`), then moved back to the image
frame. The loss is a sum of per-sample terms (a Huber distance of the
projected keypoints to the landmarks, the GMM shape prior, a soft unit-norm
constraint on the quaternion) and Adam works element by element, so each
sample's trajectory is independent of the others.

`fit_face_model` fits arrays in memory and needs no h5py; `main` reads and
writes the HDF5 file (h5py is imported there only).
"""

import argparse
import sys

import numpy as np

# optax.adam's constants
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Fit the deformable face model to 2D landmarks")
    parser.add_argument("filename", help="dataset .h5 with /pt2d_68 (or pt3d_68) and /rois")
    parser.add_argument("--out-group", default="2dfit_v3")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--prior-weight", type=float, default=0.01)
    parser.add_argument("--huber-delta", type=float, default=0.05, help="in roi-size units")
    parser.add_argument("--landmarks", default=None,
                        help="landmark dataset path inside the file (default: pt2d_68, else pt3d_68)")
    parser.add_argument("--dry-run", action="store_true", help="fit but do not write")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def step_tables(lr: float, steps: int) -> np.ndarray:
    """(3, steps) f32: per step count t = 0 .. steps - 1, the learning rate of
    `optax.cosine_decay_schedule(lr, steps)` at t, and Adam's bias corrections
    1 - b1 ** (t + 1) and 1 - b2 ** (t + 1), in f32 as optax computes them."""
    f = np.float32
    t = np.arange(steps, dtype=f)
    lr_t = f(lr) * (f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / f(steps))))
    return np.stack([lr_t, f(1.0) - f(ADAM_B1) ** (t + f(1.0)), f(1.0) - f(ADAM_B2) ** (t + f(1.0))]).astype(f)


def fit_face_model(pt2d, rois, init_quats=None, *, steps=3000, lr=0.05, prior_weight=0.01, huber_delta=0.05,
                   device="cuda", log=print, cuda_graph=True) -> dict:
    """Fit pose, position, size and shape of every sample to its landmarks.

    pt2d (N, 68, >=2) landmarks and rois (N, 4) boxes (x0, y0, x1, y1) in the
    image frame; init_quats (N, 4), the starting pose (default: identity).
    Returns numpy arrays: `quats` (N, 4) with positive real part, `coords`
    (N, 3) and `pt3d_68` (N, 68, 3) in the image frame, `shapeparams`
    (N, 50), `residual` (N,) the mean keypoint distance in roi units, and
    `losses` (L, 2) the logged (step, loss per sample) pairs.

    On the card a step (forward, backward, Adam) is one replay of a CUDA
    graph, bit-equal to the eager step (`cuda_graph=False`), which the CPU
    runs; the step reads its learning rate and bias corrections from
    `step_tables` on the device, indexed by a step counter there.
    """
    import torch

    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.models.components import (
        DeformableHeadKeypoints,
        GaussianMixture,
        PosedDeformableHead,
    )
    from neuralnet_tracker_traincode_torch.ops import quaternion as Q
    from neuralnet_tracker_traincode_torch.ops.mathfn import full_f32_matmul
    from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

    dev = resolve_device(device)
    pt2d = np.asarray(pt2d, np.float32)[..., :2]
    rois = np.asarray(rois, np.float32)
    N = len(pt2d)
    if pt2d.shape != (N, 68, 2) or rois.shape != (N, 4):
        raise ValueError(f"landmarks {pt2d.shape} and rois {rois.shape}: expected (N, 68, 2) and (N, 4)")
    # the roi-normalised frame, in f32
    center = 0.5 * (rois[:, :2] + rois[:, 2:])
    halfsize = np.maximum(0.5 * np.max(rois[:, 2:] - rois[:, :2], axis=-1), 1e-3)
    target = (pt2d - center[:, None, :]) / halfsize[:, None, None]

    head = PosedDeformableHead(DeformableHeadKeypoints()).to(dev)
    gmm = GaussianMixture.from_npz()  # the port's copy of the JAX package's shapeparams_gmm.h5
    if init_quats is None:
        init_quats = np.tile(np.asarray([0.0, 0, 0, 1], np.float32), (N, 1))
    # one leaf of (N, 57): quat (4), xy (2), size (1, before the softplus), shape (50)
    theta0 = np.concatenate([np.asarray(init_quats, np.float32), np.zeros((N, 2), np.float32),
                             np.full((N, 1), 0.5, np.float32), np.zeros((N, 50), np.float32)], axis=-1)
    theta = torch.from_numpy(theta0).to(dev).requires_grad_(True)
    target_t = torch.from_numpy(target).to(dev)
    d = huber_delta

    def unpack(p):
        q = p[:, 0:4]
        quats = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-6)
        size = torch.logaddexp(p[:, 6:7], torch.zeros_like(p[:, 6:7]))  # jax.nn.softplus
        return quats, torch.cat([p[:, 4:6], size], dim=-1), p[:, 7:57]

    def loss_fn(p):
        quats, coord, shape = unpack(p)
        pts = head(coord, QuatRepr(quats), shape)  # (N, 68, 3)
        r = pts[..., :2] - target_t
        a = torch.abs(r)
        err = torch.where(a < d, 0.5 * r * r / d, a - 0.5 * d)
        data_term = torch.sum(torch.mean(err, dim=(1, 2)))
        prior = -prior_weight * torch.sum(gmm(shape)) / 68.0
        quatreg = 1e-3 * torch.sum(torch.square(torch.linalg.norm(p[:, 0:4], dim=-1) - 1.0))
        return data_term + prior + quatreg

    # optax.adam(optax.cosine_decay_schedule(lr, steps)): the learning rate of the count before the
    # increment, the bias corrections of the one after it
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    tables = torch.from_numpy(step_tables(lr, steps)).to(dev)
    count = torch.zeros(1, dtype=torch.long, device=dev)
    last_loss = torch.zeros((), device=dev)

    def step():
        loss = loss_fn(theta)
        (g,) = torch.autograd.grad(loss, theta)
        with torch.no_grad():
            lr_t, bc1, bc2 = tables.index_select(1, count).unbind(0)
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            theta.sub_(u * lr_t)  # optax: p + u * (-lr), the same to the bit
            count.add_(1)
            last_loss.copy_(loss)

    history = []
    with full_f32_matmul():  # the forward and the backward, as the JAX package's Precision.HIGHEST
        if dev.type == "cuda" and cuda_graph and steps > 0:
            step = _captured(torch, step, [theta, mu, nu, count, last_loss])
        for i in range(steps):
            step()
            if i % max(1, steps // 10) == 0 or i == steps - 1:
                history.append((i, float(last_loss) / N))
                log(f"  step {i}: loss {history[-1][1]:.5f} /sample")

        with torch.no_grad():
            quats, coord, shape = unpack(theta)
            quats = Q.positivereal(quats)
            pts = head(coord, QuatRepr(quats), shape).cpu().numpy()
            quats, coord, shape = quats.cpu().numpy(), coord.cpu().numpy(), shape.cpu().numpy()

    # back to the image frame: a scale and a shift, so the rotation stays
    coord_img = np.concatenate([coord[:, :2] * halfsize[:, None] + center, coord[:, 2:] * halfsize[:, None]], axis=-1)
    pts_img = pts * halfsize[:, None, None]
    pts_img[..., :2] += center[:, None, :]
    resid = np.linalg.norm(pts[..., :2] - target, axis=-1).mean(axis=-1)
    log(f"mean residual {resid.mean():.4f} (roi units); p90 {np.percentile(resid, 90):.4f}")
    return dict(quats=quats, coords=coord_img, pt3d_68=pts_img, shapeparams=shape, residual=resid,
                losses=np.asarray(history, np.float64).reshape(-1, 2))


def _captured(torch, step, state):
    """`step` as the replay of a CUDA graph of one call: three warm-up calls on
    a side stream (autograd's and the constants' first allocations), the
    tensors of `state` put back, then the capture."""
    saved = [t.detach().clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, v in zip(state, saved):
            t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import h5py

    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    with h5py.File(args.filename, "r") as f:
        lmk_name = args.landmarks or ("pt2d_68" if "pt2d_68" in f else "pt3d_68")
        pt2d = np.asarray(f[lmk_name][...], np.float32)[..., :2]
        rois = np.asarray(f["rois"][...], np.float32)
        init_quats = None
        if "pseudolabels" in f and "quats" in f["pseudolabels"]:
            init_quats = np.asarray(f["pseudolabels/quats"][...], np.float32)
    print(f"Fitting {len(pt2d)} samples from {args.filename}:{lmk_name}")
    fit = fit_face_model(pt2d, rois, init_quats, steps=args.steps, lr=args.lr, prior_weight=args.prior_weight,
                         huber_delta=args.huber_delta, device=args.device)
    if args.dry_run:
        print("Dry run: not writing.")
        return 0

    with h5py.File(args.filename, "a") as f:
        if args.out_group in f:
            del f[args.out_group]
        g = f.create_group(args.out_group)
        create_pose_dataset(g, C.quat, data=fit["quats"].astype(np.float32))
        create_pose_dataset(g, C.xys, data=fit["coords"].astype(np.float32))
        create_pose_dataset(g, C.points, name="pt3d_68", data=fit["pt3d_68"].astype(np.float32))
        create_pose_dataset(g, C.general, name="shapeparams", dtype=np.float16,
                            data=fit["shapeparams"].astype(np.float16))
    print(f"Wrote {args.out_group} group into {args.filename}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
