"""Model components: 2.5D rigid transform, deformable keypoints, the pose
heads' box and local pose offset, the soft-argmax of the localizer, Pascal
kernel, and the diagonal gaussian mixture of the shape prior.

Counterpart of the JAX package's `models/components.py`.
"""

import os

import numpy as np
import torch
from torch import nn

from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
from neuralnet_tracker_traincode_torch.ops.mathfn import full_f32_matmul, matmul_hp, smoothclip0
from neuralnet_tracker_traincode_torch.ops.rotrepr import RotationRepr


def rigid_transformation_25d(r: RotationRepr, t: torch.Tensor, s: torch.Tensor, points: torch.Tensor):
    """2.5D rigid transform: rotate, scale (all axes), translate in xy only.

    r: rotation, batch shape (...,); t: (..., 2); s: (..., 1); points (..., N, 3).
    """
    tmp = r.rotate_points(points)
    tmp = tmp * s[..., None, :]
    xy = tmp[..., :2] + t[..., None, :]
    return torch.cat([xy, tmp[..., 2:]], dim=-1)


def box_from_features(z: torch.Tensor) -> torch.Tensor:
    """The box head's (..., 4) features -> (x0, y0, x1, y1): centre z[:2],
    half sizes smoothclip0(z[2:])."""
    boxsize = smoothclip0(z[..., 2:])
    boxcenter = z[..., :2]
    return torch.cat([boxcenter - boxsize, boxcenter + boxsize], dim=-1)


def offset_pose(quats: RotationRepr, coords: torch.Tensor, psel: torch.Tensor):
    """A learned local -> global pose offset applied to (rotation, coords
    (..., 3) of x, y, size); psel (..., 4) is the offset's parameter row.
    As in the reference, psel[..., 1] is both the x-rotation angle and part
    of the translation (psel[..., 1:3]); psel[..., 3] is the scale before
    smoothclip0. Returns the rotation times the offset's, and the position
    moved by the rotated translation times the new size."""
    offset_quat = type(quats).make_rotate_x(psel[..., 1])
    offset_transl = torch.cat([torch.zeros_like(psel[..., :1]), psel[..., 1:3]], dim=-1)
    offset_scale = smoothclip0(psel[..., 3])
    scale = coords[..., 2:] * offset_scale[..., None]
    pred_quat = quats.mult(offset_quat)
    pos_corr = quats.rotate_points(offset_transl[..., None, :])[..., 0, :]
    screen_pos = pos_corr[..., :2] * scale + coords[..., :2]
    return pred_quat, torch.cat([screen_pos, scale], dim=-1)


class DeformableHeadKeypoints(nn.Module):
    """Linear blend-shape keypoint model over the BFM 68-keypoint subset.

    Buffers `keypts` (68, 3) and `keyeigvecs` (50, 68, 3), as the reference
    state dict names them.
    """

    def __init__(self, num_shape=40, num_expr=10):
        super().__init__()
        self.num_eigvecs = num_shape + num_expr
        full = BFMModel(num_shape, num_expr)
        self.register_buffer("keypts", torch.from_numpy(full.keypts.copy()))
        self.register_buffer("keyeigvecs", torch.from_numpy(full.scaled_bases.copy()))

    def forward(self, shapeparams: torch.Tensor) -> torch.Tensor:
        """(..., 50) -> (..., 68, 3), in f32 whatever the autocast policy."""
        K = self.keyeigvecs.shape[0]
        local = matmul_hp(shapeparams, self.keyeigvecs.reshape(K, -1))
        return local.reshape(shapeparams.shape[:-1] + (68, 3)) + self.keypts


class PosedDeformableHead(nn.Module):
    """The deformable keypoints posed by `rigid_transformation_25d`:
    `forward(coord (..., 3), rots, params (..., 50)) -> (..., 68, 3)`, with
    coord = (x, y, size) in the image frame. Full f32 whatever autocast and
    TF32 are set to: the keypoint blend (and a `Mat33Repr` rotation) go
    through `matmul_hp` with TF32 off (its backward runs where autograd is
    called: `scripts/fit_face_model.py` keeps TF32 off for the whole fit)."""

    def __init__(self, deformable_head: DeformableHeadKeypoints):
        super().__init__()
        self.deformable_head = deformable_head

    def forward(self, coord: torch.Tensor, rots: RotationRepr, params: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            local = self.deformable_head(params)
            coord = coord.float()
            return rigid_transformation_25d(rots, coord[..., :2], coord[..., 2:], local)


def center_of_mass(x: torch.Tensor, half_size):
    """Spatial soft-argmax over (B, H, W) f32 probability maps, domain
    [-1, 1] * half_size: ((B, 2) mean, (2, H, W) grid of x and y)."""
    B, H, W = x.shape
    px = torch.linspace(-1.0, 1.0, W, device=x.device)[None, :]
    py = torch.linspace(-1.0, 1.0, H, device=x.device)[:, None]
    p = torch.stack([px.expand(H, W), py.expand(H, W)])
    mean = half_size * torch.sum(x[:, None, :, :] * p[None, ...], dim=(2, 3))
    return mean, p


def center_of_mass_and_std(x: torch.Tensor, half_size, eps: float = 1.0e-4):
    """The soft-argmax mean and the standard deviation about it, (B, 2) each."""
    mean, p = center_of_mass(x, half_size)
    diff = p[None, ...] - mean[..., None, None]
    std = torch.sqrt(torch.sum(x[:, None, :, :] * diff * diff, dim=(2, 3)) + eps)
    return mean, std


def pascal_kernel_2d(kernel_size: int) -> np.ndarray:
    """Normalized 2D binomial (Pascal) kernel for anti-aliased downsampling."""
    row = np.asarray([1.0])
    for _ in range(kernel_size - 1):
        row = np.convolve(row, [1.0, 1.0])
    k = np.outer(row, row)
    return (k / k.sum()).astype(np.float32)


SHAPEPARAMS_GMM_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "facemodel", "assets", "shapeparams_gmm.npz"
)


def _require_diag(covariance_type: str, path: str):
    if covariance_type != "diag":
        raise ValueError(f"{path}: covariance_type {covariance_type!r}, only 'diag' is supported")


class GaussianMixture:
    """Diagonal-covariance gaussian mixture log-likelihood.

    The constants are computed once as the JAX package computes them: the
    inverse scales and the normalisation in f64 numpy, then cast to f32 where
    the JAX package's f32 arithmetic meets them (log of the f32 inverse
    scales, summed in f32). The shape prior's file is carried as npz
    (`facemodel/assets/shapeparams_gmm.npz`: `weights` and `means` f4, `cov`
    f8, `covariance_type` "diag"), converted from the JAX package's
    `shapeparams_gmm.h5` array for array; `from_hdf5` reads the h5 file where
    h5py is installed.
    """

    def __init__(self, weights, means, cov):
        weights, means, cov = np.asarray(weights), np.asarray(means), np.asarray(cov)
        assert weights.shape == means.shape[:1] == cov.shape[:1]
        assert means.shape == cov.shape
        self.weights, self.means, self.cov = weights, means, cov
        scales_inv = torch.from_numpy(1.0 / np.sqrt(cov)).float()
        self._means = torch.from_numpy(means).float()
        self._scales_inv = scales_inv
        self._weight_term = torch.from_numpy(np.log(weights)).float()
        norm_constant = np.float32(0.5 * means.shape[-1] * np.log(2 * np.pi))
        self._normalization_term = torch.sum(torch.log(scales_inv), dim=-1) - float(norm_constant)
        self._by_device = {}

    @property
    def n_components(self) -> int:
        return self.weights.shape[0]

    @staticmethod
    def from_npz(path: str = SHAPEPARAMS_GMM_NPZ) -> "GaussianMixture":
        with np.load(path, allow_pickle=False) as f:
            _require_diag(str(f["covariance_type"]), path)
            return GaussianMixture(weights=f["weights"], means=f["means"], cov=f["cov"])

    @staticmethod
    def from_hdf5(f) -> "GaussianMixture":
        import h5py

        if isinstance(f, str):
            with h5py.File(f, "r") as file:
                return GaussianMixture.from_hdf5(file)
        _require_diag(f.attrs["covariance_type"], f.file.filename)
        return GaussianMixture(weights=f["weights"][...], means=f["means"][...], cov=f["cov"][...])

    @staticmethod
    def from_sklearn(gmm) -> "GaussianMixture":
        """From a fitted `sklearn.mixture.GaussianMixture` of diagonal covariance."""
        return GaussianMixture(weights=gmm.weights_, means=gmm.means_, cov=gmm.covariances_)

    def save_to_hdf5(self, f, group_name=None):
        """Write the JAX package's layout (`weights`, `means`, `cov` as held,
        attribute `covariance_type` "diag") into the h5py file or group `f`,
        or into a new group `group_name` of it; returns the group."""
        g = f.create_group(group_name) if group_name is not None else f
        g.create_dataset("weights", data=np.asarray(self.weights))
        g.create_dataset("means", data=np.asarray(self.means))
        g.create_dataset("cov", data=np.asarray(self.cov))
        g.attrs["covariance_type"] = "diag"
        return g

    def save_to_npz(self, path: str) -> str:
        """Write the port's asset layout, which `from_npz` reads: `weights`
        and `means` f4, `cov` f8, `covariance_type` "diag"."""
        np.savez(
            path,
            weights=np.asarray(self.weights, np.float32),
            means=np.asarray(self.means, np.float32),
            cov=np.asarray(self.cov, np.float64),
            covariance_type="diag",
        )
        return path

    def _constants(self, device: torch.device):
        if device not in self._by_device:
            self._by_device[device] = tuple(
                t.to(device) for t in (self._means, self._scales_inv, self._weight_term, self._normalization_term)
            )
        return self._by_device[device]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Log-likelihood, x shape (..., D), in f32."""
        means, scales_inv, weight_term, normalization_term = self._constants(x.device)
        delta = x.float()[..., None, :] - means
        exponential_term = -0.5 * torch.sum(torch.square(delta * scales_inv), dim=-1)
        return torch.logsumexp(weight_term + exponential_term + normalization_term, dim=-1)
