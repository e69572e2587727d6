"""The face-model tools' card paths: the fit's CUDA graph and the rasterizer
on the card.

Marked `cuda`: it needs an NVIDIA GPU and skips without one. On the machine
with the card:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_face_tools_cuda.py`.

`scripts/fit_face_model.py:fit_face_model` runs a step as one replay of a
CUDA graph on the card: bit-equal to the eager steps there, and within
1e-5 of the CPU's fit (another order of the sums). `vis3d.rasterize_mesh` on
the card covers the CPU's pixels exactly, with the CPU's depth (the same f32
operations) and colours within 1 gray level (the normals' f64 sums run in
any order on the card).
"""

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch import vis3d
from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, PosedDeformableHead
from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr
from neuralnet_tracker_traincode_torch.scripts.fit_face_model import fit_face_model

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fit's CUDA graph, the rasterizer on the card)")
    return torch.device("cuda")


def faces(n=96, seed=3):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    quats = Rotation.from_euler("XYZ", rng.uniform(-35, 35, (n, 3)), degrees=True).as_quat().astype(np.float32)
    coord = np.concatenate([rng.uniform(100, 140, (n, 2)), rng.uniform(40, 60, (n, 1))], -1).astype(np.float32)
    with torch.no_grad():
        pts = PosedDeformableHead(DeformableHeadKeypoints())(
            torch.from_numpy(coord), QuatRepr(torch.from_numpy(quats)),
            torch.from_numpy((rng.randn(n, 50) * 0.3).astype(np.float32))).numpy()
    pt2d = pts[..., :2] + rng.randn(n, 68, 2).astype(np.float32) * 0.2
    return pt2d, np.concatenate([pt2d.min(axis=1), pt2d.max(axis=1)], axis=-1)


def test_the_fit_graph_is_the_eager_fit(card):
    pt2d, rois = faces()
    quiet = dict(steps=40, device=card, log=lambda line: None)
    graph = fit_face_model(pt2d, rois, **quiet)
    eager = fit_face_model(pt2d, rois, cuda_graph=False, **quiet)
    for k in graph:
        np.testing.assert_array_equal(graph[k], eager[k], err_msg=k)
    cpu = fit_face_model(pt2d, rois, steps=40, device="cpu", log=lambda line: None)
    for k in ("quats", "shapeparams", "residual"):
        np.testing.assert_allclose(graph[k], cpu[k], rtol=0, atol=1e-5, err_msg=k)


def test_the_rasterizer_on_the_card_is_the_cpus(card):
    rng = np.random.RandomState(0)
    F = 3000
    xy = rng.uniform(-8, 136, (F, 1, 2)) + rng.uniform(-9, 9, (F, 3, 2))
    verts = np.concatenate([xy, rng.uniform(-20, 20, (F, 3, 1))], -1).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * F).reshape(F, 3)
    color, depth = (a.cpu().numpy() for a in vis3d.rasterize_mesh(torch.from_numpy(verts).to(card), tris, (96, 128)))
    ccpu, dcpu = (a.numpy() for a in vis3d.rasterize_mesh(verts, tris, (96, 128), device="cpu"))
    np.testing.assert_array_equal(color.any(-1), ccpu.any(-1))
    np.testing.assert_array_equal(depth, dcpu)
    assert np.abs(color.astype(int) - ccpu.astype(int)).max() <= 1
