"""3D face-mesh rendering (counterpart of the JAX package's `vis3d.py`).

`rasterize_mesh` is a z-buffer rasterizer with Gouraud shading on tensors,
on the card by default; `FaceRender` poses the full BFM mesh (`$BFM_PATH`
names the 3DDFA pickle, which is not distributable) and renders it with it,
or with pyrender where that is installed and asked for. The scatter of the
posed 68 keypoints (`plot_posed_keypoints_3d`) draws into an axis the caller
makes.

Conventions, as in the JAX package: x right, y down, z into the image;
nearer surfaces have smaller z. An empty pixel is black with depth 0.
"""

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device

# candidate pixels (bounding-box pixels of the triangles) one tile of `rasterize_mesh` holds at once
TILE_PIXELS = 1 << 21


def _require_full_mesh():
    from neuralnet_tracker_traincode_torch.facemodel.bfm import full_model_from_env

    model = full_model_from_env()
    if model is None:
        raise RuntimeError("FaceRender needs the full BFM mesh; point $BFM_PATH at bfm_noneck_v3.pkl")
    return model


def estimate_vertex_normals(vertices: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Area-weighted mean vertex normals, (V, 3) f32 unit vectors on the
    vertices' device: each face's cross-product normal is summed onto its
    three vertices in f64 (corners 0, 1, 2 in turn, as the JAX package's
    `np.add.at`), then normalised and cast to f32. On the CPU the sums run in
    the JAX package's order; on CUDA the atomic adds run in any order."""
    v = vertices.double()
    t = tris.long()
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    (e1x, e1y, e1z), (e2x, e2y, e2z) = (b - a).unbind(-1), (c - a).unbind(-1)
    fn = torch.stack([e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, e1x * e2y - e1y * e2x], dim=-1)
    vn = torch.zeros_like(v)
    for k in range(3):
        vn.index_add_(0, t[:, k], fn)
    x, y, z = vn.unbind(-1)
    norm = torch.sqrt(x * x + y * y + z * z)[:, None]
    return (vn / torch.clamp(norm, min=1e-12)).float()


def rasterize_fragments(v: torch.Tensor, t: torch.Tensor, intensity: torch.Tensor, H: int, W: int,
                        tile_pixels: int = TILE_PIXELS):
    """Every fragment of the triangles `t` (F, 3) over the f32 vertices `v`
    (V, 3) on an H x W image: (pixel index y * W + x, interpolated z,
    triangle index, interpolated intensity), each (n,).

    A pixel's centre (x + 0.5, y + 0.5) is covered when its three
    barycentric weights are >= 0, computed in f32 in the JAX package's order
    of operations, so the same pixels are covered. The candidate pixels are
    each triangle's own bounding box, clipped to the image, laid end to end;
    tiles hold `tile_pixels` candidates at most, however large a triangle.
    """
    dev = v.device
    none = (torch.zeros(0, dtype=torch.long, device=dev), torch.zeros(0, device=dev),
            torch.zeros(0, dtype=torch.long, device=dev), torch.zeros(0, device=dev))
    p = v[t]  # (F, 3 corners, 3)
    (ax, bx, cx), (ay, by, cy) = p[..., 0].unbind(-1), p[..., 1].unbind(-1)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    keep = torch.nonzero(torch.abs(area) > 1e-12).squeeze(1)  # a degenerate triangle covers nothing
    if len(keep) == 0:
        return none
    p, ax, bx, cx, ay, by, cy = (a[keep] for a in (p, ax, bx, cx, ay, by, cy))
    inv = 1.0 / area[keep]
    x0 = torch.clamp(torch.floor(p[..., 0].amin(1)), 0, W - 1).long()
    y0 = torch.clamp(torch.floor(p[..., 1].amin(1)), 0, H - 1).long()
    x1 = torch.clamp(torch.ceil(p[..., 0].amax(1)), 0, W - 1).long()
    y1 = torch.clamp(torch.ceil(p[..., 1].amax(1)), 0, H - 1).long()
    bw = x1 - x0 + 1
    ends = torch.cumsum(bw * (y1 - y0 + 1), 0)
    starts = ends - bw * (y1 - y0 + 1)
    zs, its = p[..., 2], intensity[t[keep]]  # (F, 3) each
    out = []
    total = int(ends[-1])
    for lo in range(0, total, tile_pixels):
        idx = torch.arange(lo, min(lo + tile_pixels, total), device=dev)
        f = torch.searchsorted(ends, idx, right=True)
        local = idx - starts[f]
        gx = x0[f] + local % bw[f]
        gy = y0[f] + torch.div(local, bw[f], rounding_mode="floor")
        px = gx.float() + 0.5
        py = gy.float() + 0.5
        w0 = ((bx[f] - px) * (cy[f] - py) - (by[f] - py) * (cx[f] - px)) * inv[f]
        w1 = ((cx[f] - px) * (ay[f] - py) - (cy[f] - py) * (ax[f] - px)) * inv[f]
        w2 = 1.0 - w0 - w1
        sel = torch.nonzero((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)).squeeze(1)
        if len(sel) == 0:
            continue
        f, w0, w1, w2 = f[sel], w0[sel], w1[sel], w2[sel]
        z, it = zs[f], its[f]
        # the JAX package's einsum over the corners sums in this order
        out.append((gy[sel] * W + gx[sel], (w0 * z[:, 0] + w1 * z[:, 1]) + w2 * z[:, 2], keep[f],
                    (w0 * it[:, 0] + w1 * it[:, 1]) + w2 * it[:, 2]))
    return tuple(torch.cat(a) for a in zip(*out)) if out else none


def depth_test(pix: torch.Tensor, z: torch.Tensor, tri: torch.Tensor, npix: int):
    """The winning fragment of each covered pixel: the least z, and among
    fragments at that z the least triangle index (the JAX package's stable
    sort by (pixel, z) keeps that one). Returns (mask over the fragments,
    number of pixels where more than one fragment holds the least z)."""
    zmin = torch.full((npix,), float("inf"), device=z.device).scatter_reduce_(0, pix, z, "amin")
    at = z == zmin[pix]
    tmin = torch.full((npix,), torch.iinfo(torch.long).max, device=z.device).scatter_reduce_(
        0, pix[at], tri[at], "amin")
    ties = int(torch.count_nonzero(torch.bincount(pix[at], minlength=npix) > 1))
    return at & (tri == tmin[pix]), ties


def rasterize_mesh(
    vertices,  # (V, 3) image space: x right, y down, z = depth
    tris,  # (F, 3) vertex indices
    image_shape,  # (H, W)
    light_dir=(0.3, -0.25, -1.0),  # toward the scene; -z = from the viewer
    ambient: float = 0.35,
    diffuse: float = 0.65,
    base_color=(140, 160, 210),
    tile_pixels: int = TILE_PIXELS,
    device: DeviceLike = None,
):
    """Z-buffer rasterizer with Gouraud shading: `(color, depth)` tensors on
    `device` (default: the vertices' device if they are a tensor, else
    CUDA), color (H, W, 3) uint8, black where empty, depth (H, W) f32, 0
    where empty, else the nearest fragment's interpolated z. Shading is
    double-sided: ambient + diffuse * |n . l| per vertex, clipped to [0, 1],
    interpolated, times `base_color`, truncated to uint8.
    """
    if device is None and torch.is_tensor(vertices):
        device = vertices.device
    dev = resolve_device(device)
    H, W = int(image_shape[0]), int(image_shape[1])
    v = torch.as_tensor(vertices).to(dev, torch.float32)
    t = torch.as_tensor(tris).to(dev, torch.long).reshape(-1, 3)
    color = torch.zeros((H, W, 3), dtype=torch.uint8, device=dev)
    depth = torch.zeros((H, W), dtype=torch.float32, device=dev)
    if len(t) == 0 or len(v) == 0:
        return color, depth

    vn = estimate_vertex_normals(v, t)
    l = np.asarray(light_dir, np.float32)
    l = l / np.linalg.norm(l)
    lx, ly, lz = (float(c) for c in l)
    intensity = torch.clamp(ambient + diffuse * torch.abs((vn[:, 0] * lx + vn[:, 1] * ly) + vn[:, 2] * lz), 0.0, 1.0)
    pix, z, tri, it = rasterize_fragments(v, t, intensity, H, W, tile_pixels)
    if len(pix) == 0:
        return color, depth
    win, _ = depth_test(pix, z, tri, H * W)
    base = torch.tensor(base_color, dtype=torch.float32, device=dev)
    color.view(-1, 3)[pix[win]] = torch.clamp(it[win, None] * base, 0, 255).to(torch.uint8)
    depth.view(-1)[pix[win]] = z[win]
    return color, depth


class FaceRender:
    """Render the posed full BFM mesh over an image of a given size.

    backend="auto" uses pyrender where it imports and `rasterize_mesh` on
    `device` (default CUDA) otherwise; "software" or "pyrender" force one
    (the latter raises where pyrender is missing). `render()` returns numpy
    arrays (color, depth), as pyrender does.
    """

    def __init__(self, backend: str = "auto", device: DeviceLike = None):
        assert backend in ("auto", "software", "pyrender")
        self._pyrender = None
        if backend in ("auto", "pyrender"):
            try:
                import pyrender

                self._pyrender = pyrender
            except ImportError:
                if backend == "pyrender":
                    raise
        self.model = _require_full_mesh()
        # the pyrender path poses the mesh on the host; the software path on the device it renders on
        self.device = torch.device("cpu") if self._pyrender is not None else resolve_device(device)
        self._vertices = torch.as_tensor(self.model.scaled_vertices).to(self.device)
        self._bases = torch.as_tensor(self.model.scaled_bases).to(self.device)
        self._tri = None
        self._mesh_node = None
        self._renderer = None
        self.scene = None
        if self._pyrender is not None:
            pyrender = self._pyrender
            self.scene = pyrender.Scene(ambient_light=[0.3, 0.3, 0.3], bg_color=[0.0, 0.0, 0.0, 0.0])
            self.camera_node = self.scene.add(pyrender.OrthographicCamera(xmag=1.0, ymag=1.0, znear=0.1, zfar=10000.0))
            self.scene.add(pyrender.DirectionalLight(color=np.ones(3), intensity=3.0))

    def _posed_vertices(self, xy, scale, rot, shapeparams) -> torch.Tensor:
        """(V, 3): the mesh deformed by `shapeparams`, rotated by the scipy
        `Rotation` `rot`, scaled and moved by `xy`; f64 as the JAX package's
        numpy and scipy compute it (the deformation in the shape parameters'
        precision)."""
        dtype = torch.float64 if np.result_type(np.asarray(shapeparams), np.float32) == np.float64 else torch.float32
        sp = torch.as_tensor(np.asarray(shapeparams)).to(self.device, dtype)
        verts = (self._vertices.to(dtype) + torch.einsum("k,kvd->vd", sp, self._bases.to(dtype))).double()
        rmat = torch.as_tensor(rot.as_matrix(), dtype=torch.float64, device=self.device)
        out = (verts @ rmat.T) * float(scale)
        out[:, :2] += torch.as_tensor(np.asarray(xy, np.float64), device=self.device)
        return out

    def set(self, xy, scale, rot, shapeparams, image_shape):
        """Update the mesh pose; image_shape = (H, W)."""
        verts = self._posed_vertices(xy, scale, rot, shapeparams)
        tri = self.model.scaled_tri
        self._image_shape = image_shape
        if self._pyrender is None:
            if self._tri is None:
                self._tri = torch.as_tensor(np.asarray(tri, np.int64), device=self.device)
            self._verts = verts
            return
        pyrender = self._pyrender
        import trimesh

        mesh = trimesh.Trimesh(vertices=verts.numpy(), faces=tri, process=False)
        if self._mesh_node is not None:
            self.scene.remove_node(self._mesh_node)
        self._mesh_node = self.scene.add(pyrender.Mesh.from_trimesh(mesh, smooth=True))
        h, w = image_shape
        cam = self.camera_node.camera
        cam.xmag = w * 0.5
        cam.ymag = h * 0.5
        pose = np.eye(4)
        pose[:3, 3] = [w * 0.5, h * 0.5, 1000.0]
        pose[:3, :3] = np.diag([1.0, -1.0, -1.0])  # flip y and z into the image convention
        self.scene.set_pose(self.camera_node, pose)

    def render(self):
        """(color (H, W, 3) uint8, depth (H, W) f32) as numpy arrays."""
        h, w = self._image_shape
        if self._pyrender is None:
            color, depth = rasterize_mesh(self._verts, self._tri, (h, w), device=self.device)
            return color.cpu().numpy(), depth.cpu().numpy()
        if self._renderer is None:
            self._renderer = self._pyrender.OffscreenRenderer(w, h)
        return self._renderer.render(self.scene)


def plot_posed_keypoints_3d(ax, coord, pose_quat, shapeparams=None):
    """3D scatter of the posed 68-keypoint model into the matplotlib 3D axis
    `ax` (made by the caller); computed on the CPU. Returns the (68, 3) points."""
    from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, PosedDeformableHead
    from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

    head = PosedDeformableHead(DeformableHeadKeypoints())
    if shapeparams is None:
        shapeparams = np.zeros((50,), np.float32)
    with torch.no_grad():
        pts = head(
            torch.as_tensor(np.asarray(coord, np.float32))[None],
            QuatRepr(torch.as_tensor(np.asarray(pose_quat, np.float32))[None]),
            torch.as_tensor(np.asarray(shapeparams, np.float32))[None],
        )[0].numpy()
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4.0)
    return pts
