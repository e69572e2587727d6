"""Fit a fallback 68-keypoint deformable face model from a labelled pose file
(counterpart of the JAX package's `scripts/make_bfm_fallback.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.make_bfm_fallback --source labels.h5 \\
        [--out bfm_keypoints_subset.npz]

The real `bfm_noneck_v3.pkl` cannot be redistributed. This tool rebuilds an
approximate keypoint model from any pose file with quats, coords, pt3d_68
and shapeparams:

    1. un-pose each sample's landmarks: L_i = R_i^-1 ((pt_i - [t_i, 0]) / s_i);
    2. fit L_i ~= keypts + sum_k p_ik W_k per coordinate, the minimal-norm
       least squares over the centred shape parameters (N < 1 + K is allowed).

The result reproduces the file's landmarks closely; it is not the BFM. The
default `--out` is the port's packaged artifact. Host only: f64 numpy,
scipy and h5py (imported inside the functions), no device; numpy's `lstsq`
gives the minimal-norm solution that `torch.linalg.lstsq` on CUDA does not.
"""

import argparse
import sys

import numpy as np


def fit_fallback(h5path: str, num_shape=40, num_expr=10):
    """(keypts (68, 3), w_shp (num_shape, 68, 3), w_exp (num_expr, 68, 3)), f32."""
    import h5py
    from scipy.spatial.transform import Rotation

    with h5py.File(h5path, "r") as f:
        quats = f["quats"][...].astype(np.float64)
        coords = f["coords"][...].astype(np.float64)
        pts = f["pt3d_68"][...].astype(np.float64)
        params = f["shapeparams"][...].astype(np.float64)
    N = quats.shape[0]
    K = num_shape + num_expr
    assert params.shape == (N, K)

    # un-pose: the inverse of rigid_transformation_25d (rotate, scale all axes, add the 2D offset)
    local = np.empty_like(pts)
    for i in range(N):
        v = pts[i].copy()
        v[:, :2] -= coords[i, :2]
        v /= coords[i, 2]
        local[i] = Rotation.from_quat(quats[i]).inv().apply(v)

    pbar = params.mean(axis=0)
    X = np.concatenate([np.ones((N, 1)), params - pbar], axis=1)  # (N, 1+K)
    Y = local.reshape(N, -1)  # (N, 204)
    W_full, *_ = np.linalg.lstsq(X, Y, rcond=None)  # minimal-norm (N < 1+K)
    keypts = (W_full[0] - (W_full[1:].T @ pbar).T).reshape(68, 3)
    W = W_full[1:].reshape(K, 68, 3)

    recon = keypts[None] + np.einsum("nk,kpd->npd", params, W)
    err = np.linalg.norm(recon - local, axis=-1).mean(axis=-1)
    print(f"fallback fit: mean unposed reconstruction error {err.mean():.2e} "
          f"(max {err.max():.2e}) over {N} samples")
    return keypts.astype(np.float32), W[:num_shape].astype(np.float32), W[num_shape:].astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    from neuralnet_tracker_traincode_torch.facemodel.bfm import SUBSET_ARTIFACT

    parser = argparse.ArgumentParser(description="Fit a fallback 68-keypoint deformable face model")
    parser.add_argument("--source", required=True, help="Labelled pose HDF5")
    parser.add_argument("--out", default=SUBSET_ARTIFACT)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    keypts, w_shp, w_exp = fit_fallback(args.source)
    np.savez_compressed(args.out, keypts=keypts, w_shp=w_shp, w_exp=w_exp, source="fitted_fallback")
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
