"""The port's mesh rasterizer and `FaceRender` (`vis3d.py`) against the JAX
package's, on the CPU.

Tolerances: coverage (a pixel is covered where its colour is not black)
equal; depth within 1e-5; colours within 1 gray level (the port takes n . l
as three products summed in order, numpy's matrix-vector product rounds in
its own order, so an interpolated intensity can land one level apart after
the truncation to uint8). The normals and the depth test are bit-equal on
the CPU: the f64 sums run in `np.add.at`'s order, and on equal z the least
triangle index wins, as the JAX package's stable sort keeps it.
"""

import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_tpu import vis3d as J
from neuralnet_tracker_traincode_torch import vis3d as T
from torch_port_helpers import BFM_VERTICES, two_intra_op_threads, write_synthetic_bfm_pickle  # noqa: F401

CPU = torch.device("cpu")


def render(*args, **kwargs):
    color, depth = T.rasterize_mesh(*args, device=CPU, **kwargs)
    assert color.device == CPU and color.dtype == torch.uint8 and depth.dtype == torch.float32
    return color.numpy(), depth.numpy()


def assert_like_jax(ours, ref):
    (c, d), (jc, jd) = ours, ref
    assert c.shape == jc.shape and d.shape == jd.shape
    np.testing.assert_array_equal(c.any(-1), jc.any(-1))
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    assert np.abs(c.astype(int) - jc.astype(int)).max() <= 1


def single_triangle():
    return np.array([[2.0, 2.0, 1.0], [30.0, 2.0, 5.0], [2.0, 30.0, 5.0]], np.float32), np.array([[0, 1, 2]]), (32, 32)


def two_planes():
    def tri_at(z, flip):
        t = np.array([[-40.0, -40.0, z], [90.0, -40.0, z], [-40.0, 90.0, z]], np.float32)
        return t if not flip else t[::-1]

    return np.concatenate([tri_at(4.0, False), tri_at(1.0, True)]), np.array([[0, 1, 2], [3, 4, 5]]), (16, 16)


def tent():
    verts = np.array([[0.0, 0.0, 2.0], [16.0, 0.0, 0.0], [32.0, 0.0, 2.0],
                      [0.0, 32.0, 2.0], [16.0, 32.0, 0.0], [32.0, 32.0, 2.0]], np.float32)
    return verts, np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]]), (32, 32)


def random_mesh_with_ties(seed=20261017, F=2000, size=96):
    """Small triangles scattered over (and past) a size^2 image; every other
    triangle is flat at one of three depths, so flat triangles that overlap
    tie exactly in z; some are degenerate (a repeated corner)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-8, size + 8, (F, 1, 2))
    xy = centers + rng.uniform(-9, 9, (F, 3, 2))
    z = rng.uniform(-20, 20, (F, 3))
    flat = np.arange(F) % 2 == 0
    z[flat] = rng.randint(-1, 2, (flat.sum(), 1)).astype(np.float64)
    verts = np.concatenate([xy, z[..., None]], -1).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * F).reshape(F, 3)
    tris[::97, 2] = tris[::97, 1]
    return verts, tris, (size, size)


MESHES = {"single_triangle": single_triangle, "two_planes": two_planes, "tent": tent,
          "random_with_ties": random_mesh_with_ties}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rasterize_mesh_is_the_jax_one(name):
    verts, tris, shape = MESHES[name]()
    assert_like_jax(render(verts, tris, shape), J.rasterize_mesh(verts, tris, shape))


def test_the_random_mesh_ties_and_the_tie_rule():
    verts, tris, (H, W) = random_mesh_with_ties()
    v, t = torch.from_numpy(verts), torch.from_numpy(tris)
    pix, z, tri, _ = T.rasterize_fragments(v, t, torch.ones(len(v)), H, W)
    win, ties = T.depth_test(pix, z, tri, H * W)
    assert ties > 100  # the case is there
    # the winner of every pixel, by a loop over the fragments: least z, then least triangle
    best = {}
    for p, zz, tt in zip(pix.tolist(), z.tolist(), tri.tolist()):
        if p not in best or (zz, tt) < best[p]:
            best[p] = (zz, tt)
    won = {p: tt for p, tt in zip(pix[win].tolist(), tri[win].tolist())}
    assert won == {p: tt for p, (zz, tt) in best.items()}
    _, jd = J.rasterize_mesh(verts, tris, (H, W))
    np.testing.assert_array_equal(render(verts, tris, (H, W))[1], jd)


@pytest.mark.parametrize("tile_pixels", [37, 997, 1 << 14])
def test_tiles_change_no_pixel(tile_pixels):
    """A tile may end inside a triangle's box: tiles hold candidate pixels, not triangles."""
    verts, tris, shape = random_mesh_with_ties(F=100)
    c, d = render(verts, tris, shape)
    ct, dt = render(verts, tris, shape, tile_pixels=tile_pixels)
    np.testing.assert_array_equal(c, ct)
    np.testing.assert_array_equal(d, dt)


def test_vertex_normals_are_the_jax_ones():
    verts, tris, _ = random_mesh_with_ties(F=500)
    ours = T.estimate_vertex_normals(torch.from_numpy(verts), torch.from_numpy(tris))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), J.estimate_vertex_normals(verts, tris))


def test_empty_inputs():
    c, d = render(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), (8, 8))
    assert not c.any() and not d.any()
    c, d = render(np.array([[0, 0, 1], [5, 5, 1], [10, 10, 1]], np.float32), np.array([[0, 1, 2]]), (8, 8))
    assert not c.any() and not d.any()  # degenerate: no area


# the analytic cases of tests/test_vis3d.py on the port


def test_single_triangle_coverage_and_depth():
    color, depth = render(*single_triangle())
    assert color.shape == (32, 32, 3) and depth.shape == (32, 32)
    inside = depth > 0
    assert inside[5, 5] and not inside[31, 31]
    cov_colors = color[inside]
    assert (cov_colors == cov_colors[0]).all()
    assert cov_colors[0].any()
    assert depth[2, 2] < depth[2, 28] <= 5.0 + 1e-3
    assert abs(depth[2, 2] - 1.0) < 0.5


def test_depth_test_smaller_z_wins():
    color, depth = render(*two_planes(), base_color=(100, 150, 200))
    assert np.allclose(depth, 1.0, atol=1e-5)
    assert (color > 0).all()


def test_vertex_normals_flat_square():
    verts = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=torch.float32)
    n = T.estimate_vertex_normals(verts, torch.tensor([[0, 1, 2], [0, 2, 3]])).numpy()
    assert n.shape == (4, 3)
    assert np.allclose(np.abs(n[:, 2]), 1.0, atol=1e-6)
    assert np.allclose(n[:, :2], 0.0, atol=1e-6)


def test_shading_varies_with_surface_orientation():
    verts, tris, shape = tent()
    color, depth = render(verts, tris, shape, light_dir=(1.0, 0.0, -1.0))
    assert depth[16, 4] > 0 and depth[16, 28] > 0
    assert color[16, 4].astype(int).sum() != color[16, 28].astype(int).sum()
    assert_like_jax((color, depth), J.rasterize_mesh(verts, tris, shape, light_dir=(1.0, 0.0, -1.0)))


class _StubHead:
    """The full model's mesh surface, as tests/test_vis3d.py stubs it (a tetrahedron)."""

    scaled_vertices = np.array([[0.0, -1.0, -0.5], [-1.0, 0.8, 0.0], [1.0, 0.8, 0.0], [0.0, 0.2, 0.9]], np.float32)
    scaled_bases = np.zeros((50, 4, 3), np.float32)
    scaled_tri = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)


class _DeformingStubHead(_StubHead):
    scaled_bases = np.random.RandomState(3).normal(scale=0.05, size=(50, 4, 3)).astype(np.float32)


POSES = [((32.0, 32.0), 20.0, ("y", 20)), ((8.0, 8.0), 6.0, ("y", 20)), ((30.5, 28.25), 24.0, ("xyz", (10, -35, 5)))]


@pytest.mark.parametrize("stub", [_StubHead, _DeformingStubHead])
@pytest.mark.parametrize("pose", range(len(POSES)))
def test_facerender_is_the_jax_one(monkeypatch, stub, pose):
    monkeypatch.setattr(J, "_require_full_mesh", lambda: stub())
    monkeypatch.setattr(T, "_require_full_mesh", lambda: stub())
    xy, scale, (axes, angles) = POSES[pose]
    rot = Rotation.from_euler(axes, angles, degrees=True)
    shapeparams = np.random.RandomState(pose).normal(size=50)
    ours, ref = T.FaceRender(backend="software", device=CPU), J.FaceRender(backend="software")
    for r in (ours, ref):
        r.set(xy=xy, scale=scale, rot=rot, shapeparams=shapeparams, image_shape=(64, 64))
    color, depth = ours.render()
    assert isinstance(color, np.ndarray) and isinstance(depth, np.ndarray)
    assert_like_jax((color, depth), ref.render())


def test_facerender_software_end_to_end(monkeypatch):
    monkeypatch.setattr(T, "_require_full_mesh", lambda: _StubHead())
    r = T.FaceRender(backend="software", device=CPU)
    rot = Rotation.from_euler("y", 20, degrees=True)
    r.set(xy=(32.0, 32.0), scale=20.0, rot=rot, shapeparams=np.zeros(50), image_shape=(64, 64))
    color, depth = r.render()
    assert color.shape == (64, 64, 3) and depth.shape == (64, 64)
    cover = (depth != 0).mean()
    assert 0.05 < cover < 0.9
    assert (color[depth != 0] > 0).any()
    r.set(xy=(8.0, 8.0), scale=6.0, rot=rot, shapeparams=np.zeros(50), image_shape=(64, 64))
    assert (r.render()[1] != 0).mean() < cover


def test_pyrender_backend_gating(monkeypatch):
    monkeypatch.setattr(T, "_require_full_mesh", lambda: _StubHead())
    monkeypatch.setitem(sys.modules, "pyrender", None)  # any import of pyrender now raises
    with pytest.raises(ImportError):
        T.FaceRender(backend="pyrender", device=CPU)
    r = T.FaceRender(backend="auto", device=CPU)  # falls back to the rasterizer
    assert r._pyrender is None and r.scene is None


def test_bfm_path_gating(tmp_path, monkeypatch):
    """As tests/test_bfm_gated.py:test_vis3d_gating holds the JAX one."""
    monkeypatch.delenv("BFM_PATH", raising=False)
    with pytest.raises(RuntimeError, match="BFM_PATH"):
        T._require_full_mesh()
    with pytest.raises(RuntimeError, match="BFM_PATH"):
        T.FaceRender(backend="software", device=CPU)
    monkeypatch.setenv("BFM_PATH", write_synthetic_bfm_pickle(tmp_path / "bfm_noneck_v3.pkl"))
    assert T._require_full_mesh().vertexcount == BFM_VERTICES
    render = T.FaceRender(backend="software", device=CPU)
    with pytest.raises(AssertionError, match="tri.pkl"):  # the triangles are another file, not shipped
        render.set((0.0, 0.0), 1.0, Rotation.identity(), np.zeros(50), (32, 32))


class _Axis:
    def scatter(self, x, y, z, s):
        self.points = np.stack([x, y, z], -1)


def test_plot_posed_keypoints_3d_is_the_jax_one():
    coord, quat = np.array([10.0, -4.0, 3.0]), Rotation.from_euler("xyz", (20, -30, 5), degrees=True).as_quat()
    shape = np.random.RandomState(0).normal(size=50).astype(np.float32)
    for sp in (None, shape):
        ax, jax_ax = _Axis(), _Axis()
        pts = T.plot_posed_keypoints_3d(ax, coord, quat, sp)
        ref = J.plot_posed_keypoints_3d(jax_ax, coord, quat, sp)
        assert pts.shape == (68, 3)
        np.testing.assert_array_equal(ax.points, pts)
        np.testing.assert_allclose(pts, ref, rtol=0, atol=1e-5)
